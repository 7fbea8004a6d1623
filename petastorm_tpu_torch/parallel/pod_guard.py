"""Pod-safe input iteration: every rank finishes together or not at all
(counterpart of ``petastorm_tpu/parallel/pod_guard.py``).

If one rank's input pipeline dies while the others enter the next step's
collectives, the job hangs until its timeout. The guard makes every rank
vote "I have a batch" in one ``all_reduce(MIN)`` of an int over the whole
default group, and ends iteration on every rank at the first checked step
where any rank cannot go on (an exception or the end of its data). Uneven
shard tails get the same treatment, which makes ``last_batch='drop'``
safe across ranks with unequal row counts.

The vote is a blocking collective (the decision changes host control
flow). ``consensus_interval=k`` votes every k-th step; a failing rank
always joins one last vote, which is its peers' next scheduled one, so the
rounds stay aligned. With collectives in the training step, k > 1 lets
peers run steps the failed rank can no longer join, which deadlocks: the
constructor refuses that combination unless ``step_has_collectives=False``.
"""

import logging

import torch
import torch.distributed as dist

from petastorm_tpu_torch.errors import PetastormTorchError

logger = logging.getLogger(__name__)


class PodAbortError(PetastormTorchError):
    """Raised on every rank when any rank's input pipeline failed."""


def _vote_device():
    """NCCL reduces device tensors only, gloo host ones."""
    if dist.get_backend() == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


def global_all(local_ok, mesh=None):
    """True iff every rank of the default group reports ``local_ok``: one
    ``all_reduce(MIN)``. The vote always spans the whole group (a job trains
    with all of its ranks); ``mesh`` is accepted for symmetry with the
    loader's API. Without a group (one process) it is ``bool(local_ok)``."""
    del mesh
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return bool(local_ok)
    flag = torch.tensor([1 if local_ok else 0], dtype=torch.int32, device=_vote_device())
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.item())


class PodSafeIterator(object):
    """Wraps a batch iterator with a per-step vote of every rank.

    :param iterator: this rank's batch source (e.g. a ``TorchLoader``).
    :param mesh: the training mesh (the vote covers the whole group).
    :param on_abort: ``'raise'`` (default) raises :class:`PodAbortError`
        on every healthy rank when a peer failed; ``'stop'`` ends
        iteration quietly.
    :param consensus_interval: vote every k-th step (see the module
        docstring).
    :param step_has_collectives: whether the training step has cross-rank
        collectives; True (the default) with ``consensus_interval > 1``
        raises at construction.
    """

    def __init__(self, iterator, mesh=None, on_abort='raise', consensus_interval=1,
                 step_has_collectives=True):
        if on_abort not in ('raise', 'stop'):
            raise ValueError("on_abort must be 'raise' or 'stop'")
        if consensus_interval < 1:
            raise ValueError('consensus_interval must be >= 1')
        if consensus_interval > 1 and step_has_collectives:
            raise ValueError(
                'consensus_interval={} with step_has_collectives=True: peers would run up to {} '
                'steps whose collectives a failed rank can no longer join, which deadlocks '
                'the job. Keep consensus_interval=1 for training loops with collectives, or '
                'pass step_has_collectives=False if the step really has none.'.format(
                    consensus_interval, consensus_interval - 1))
        self._it = iter(iterator)
        self._mesh = mesh
        self._on_abort = on_abort
        self._interval = int(consensus_interval)
        self._step = 0
        self._done = False

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        batch, local_ok, local_exc = None, True, None
        try:
            batch = next(self._it)
        except StopIteration:
            local_ok = False
        except Exception as e:  # noqa: BLE001 - any input failure joins the vote
            local_ok = False
            local_exc = e
            logger.exception('Input pipeline failed on this rank; propagating the abort')
        self._step += 1
        if local_ok and self._step % self._interval:
            return batch        # an off-cycle healthy step skips the vote
        peers_ok = global_all(local_ok, self._mesh)
        if local_ok and peers_ok:
            return batch
        # The vote informs the peers; this rank's own state decides its exit.
        self._done = True
        if local_exc is not None:
            raise local_exc
        if not local_ok:
            raise StopIteration
        if self._on_abort == 'raise':
            raise PodAbortError('A peer rank ended input mid-epoch (failure or uneven shard); '
                                'aborting consistently on this rank')
        raise StopIteration
