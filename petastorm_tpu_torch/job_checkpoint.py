"""Whole-job checkpoints: model, optimizer and input pipeline in one artifact.

Counterpart of ``petastorm_tpu/job_checkpoint.py`` on
``torch.distributed.checkpoint`` (DCP) instead of orbax. A
:class:`JobCheckpointer` saves a :class:`~petastorm_tpu_torch.models.train.
TrainState` (its model's parameters and buffers, BatchNorm statistics
included, its optimizer's state with the momentum buffers, and ``step``)
together with the loader's ``state_dict()`` and JSON metadata, under one
step directory; :meth:`JobCheckpointer.restore` returns both, so a
preempted job resumes with the exact parameters and the exact row position.

* The model and optimizer go through DCP's ``get_state_dict`` /
  ``set_state_dict`` on both sides. A plain ``optimizer.state_dict()``
  restored into a fresh optimizer would load no momentum buffer: they are
  created lazily, so the fresh target has no key for them.
* The loader state is one string entry (JSON, or base64 pickle when it is
  not JSON-safe, as a shuffling-buffer snapshot is), so its shape need not
  be known before the load.
* A save is atomic: DCP writes into a temporary directory, a finished
  marker is written last, and the directory is renamed to the step's. A
  step directory without its marker is invisible to :meth:`latest_step`
  and :meth:`restore`.
* ``async_save=True`` copies the state to host memory on the caller's
  thread (so training may go on changing it) and writes in the background;
  :meth:`wait` (or ``close``) makes every save durable and raises a
  background failure.
* Retention (``max_to_keep``) and ``save_interval_steps`` work as orbax's
  do: a ``save`` off the interval, or at a step not past the latest, is a
  no-op returning False.

A restore loads in place: into a fresh ``TrainState`` (a resumed job), or
into the one a :class:`~petastorm_tpu_torch.models.train.ScanStep` was
captured on, whose graph then replays from the restored values (every
tensor keeps its address). A step captured on another state refuses the
restored one: build a new step.

Sharded (a ``TrainState`` on a mesh, every rank calling ``save`` and
``restore`` alike): the split parameters and their momentum buffers are
viewed as ``DTensor``s of their global shape
(:func:`~petastorm_tpu_torch.parallel.tensor_parallel.to_dtensors`), so
``dcp.save`` over the process group writes each rank's shards (a whole
tensor once), as orbax writes ``NamedSharding`` leaves
(``petastorm_tpu/job_checkpoint.py:120-126``). Each rank's loader state
goes into a file of its own in the same step directory, and rank 0 writes
the marker and renames the directory once every rank has written. A
restore onto the same mesh loads each rank's shards in place, bit for bit;
a restore onto one rank (a state without a mesh, the model whole)
reshards every tensor to its global value and returns every rank's loader
state in ``loader_states``. ``async_save`` is single-process only.
"""

import base64
import concurrent.futures
import json
import os
import pickle
import shutil
import time
import uuid

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint.state_dict import get_state_dict, set_state_dict

FINISHED_MARKER = '_CHECKPOINT_FINISHED'
_TMP_PREFIX = '.tmp-'
_PICKLED_KEY = '__pst_pickled_b64__'
_LOADER_FILE = 'loader-rank{}.json'


class JobCheckpoint(object):
    """What :meth:`JobCheckpointer.restore` returns."""

    def __init__(self, step, state, loader_state, extra, loader_states=None):
        self.step = step
        self.state = state
        #: This rank's loader state (None when the restoring world differs
        #: from the saving one).
        self.loader_state = loader_state
        #: Every saving rank's loader state, by rank.
        self.loader_states = loader_states if loader_states is not None else [loader_state]
        self.extra = extra

    def __repr__(self):
        return 'JobCheckpoint(step={}, loader_state={}, extra={})'.format(
            self.step, 'yes' if self.loader_state else 'no', self.extra)


class JobCheckpointer(object):
    """Save and restore (training state, loader position, metadata) by step.

    :param directory: the checkpoint root (a local path).
    :param max_to_keep: finished steps kept; older ones are deleted
        (``None`` keeps all).
    :param async_save: write in the background (see the module docstring).
    :param save_interval_steps: ``save()`` off the interval is a no-op, so
        a training loop may call it every step.
    """

    def __init__(self, directory, max_to_keep=3, async_save=False, save_interval_steps=1):
        if save_interval_steps < 1:
            raise ValueError('save_interval_steps must be >= 1, got {}'.format(
                save_interval_steps))
        self.directory = os.path.abspath(str(directory))
        os.makedirs(self.directory, exist_ok=True)
        self._max_to_keep = max_to_keep
        self._interval = int(save_interval_steps)
        self._async = bool(async_save)
        self._executor = (concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix='pstt-checkpoint') if self._async else None)
        self._pending = []
        self._last_step = self.latest_step()
        self._closed = False

    # -- save --------------------------------------------------------------

    def save(self, step, state, loader=None, extra=None, force=False):
        """Checkpoint ``state`` (a ``TrainState``) at ``step``.

        :param loader: a ``TorchLoader`` or ``Reader`` (anything with
            ``state_dict()``) or a state already taken; it is taken here,
            at the same point as the parameters, under ``async_save`` too.
        :param extra: JSON-safe metadata.
        :param force: save off the interval.
        :returns: True if a save was made.
        """
        if self._closed:
            raise RuntimeError('save() on a closed JobCheckpointer')
        step = int(step)
        if not force and ((self._last_step is not None and self._last_step >= step)
                          or step % self._interval):
            return False
        if os.path.exists(os.path.join(self._step_dir(step), FINISHED_MARKER)):
            raise FileExistsError('step {} is already saved in {}'.format(step, self.directory))
        sharded = _sharded(state)
        if sharded and self._async:
            raise ValueError('async_save is single-process only; save a mesh state with '
                             'async_save=False')
        model_sd, optim_sd = _state_dicts(state)
        loader_json = json.dumps(_encode_loader_state(_capture_loader_state(loader)))
        payload = {'model': model_sd, 'optim': optim_sd, 'step': int(state.step),
                   'loader': '' if sharded else loader_json,
                   'extra': json.dumps(extra if extra is not None else {})}
        self._last_step = step if self._last_step is None else max(self._last_step, step)
        if self._async:
            self._reap()
            payload = _to_host(payload)
            self._pending.append(self._executor.submit(self._write, step, payload))
        else:
            self._write(step, payload, loader_json if sharded else None)
        return True

    def _write(self, step, payload, rank_loader=None):
        """Write ``payload`` as the step; ``rank_loader`` (a sharded save) is
        this rank's loader state, written beside it."""
        tmp = os.path.join(self.directory, '{}{}-{}'.format(_TMP_PREFIX, step, uuid.uuid4().hex))
        group = rank_loader is not None
        if group:
            names = [tmp]
            dist.broadcast_object_list(names, src=0)     # one directory for every rank
            tmp = names[0]
        try:
            dcp.save(payload, checkpoint_id=tmp, no_dist=_no_dist())
            if group:
                with open(os.path.join(tmp, _LOADER_FILE.format(dist.get_rank())), 'w') as f:
                    f.write(rank_loader)
                dist.barrier()
            if not group or dist.get_rank() == 0:
                with open(os.path.join(tmp, FINISHED_MARKER), 'w') as f:
                    # A sharded save's loader states are one file a rank.
                    json.dump({'step': step, 'time': time.time(),
                               'loader_ranks': dist.get_world_size() if group else 0}, f)
                    f.flush()
                    os.fsync(f.fileno())
                final = self._step_dir(step)
                if os.path.isdir(final):
                    shutil.rmtree(final)     # a torn directory of this step: no marker
                os.replace(tmp, final)
                self._apply_retention()
        except BaseException:
            if not group or dist.get_rank() == 0:
                shutil.rmtree(tmp, ignore_errors=True)
            raise
        finally:
            if group:
                dist.barrier()

    def _apply_retention(self):
        if self._max_to_keep is None:
            return
        for step in self.all_steps()[:-self._max_to_keep or None]:
            shutil.rmtree(self._step_dir(step), ignore_errors=True)

    def _reap(self):
        """Raise the failure of a finished background save."""
        done = [f for f in self._pending if f.done()]
        self._pending = [f for f in self._pending if not f.done()]
        for future in done:
            future.result()

    # -- restore -----------------------------------------------------------

    def _step_dir(self, step):
        return os.path.join(self.directory, str(int(step)))

    def all_steps(self):
        """Finished steps, oldest first."""
        steps = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.exists(
                    os.path.join(self.directory, name, FINISHED_MARKER)):
                steps.append(int(name))
        return sorted(steps)

    def latest_step(self):
        """The newest finished step, or None."""
        steps = self.all_steps()
        return steps[-1] if steps else None

    def step_nbytes(self, step):
        """Bytes on disk of a finished step."""
        root = self._step_dir(step)
        return sum(os.path.getsize(os.path.join(path, name))
                   for path, _, names in os.walk(root) for name in names)

    def restore(self, state_template, step=None):
        """Restore into ``state_template`` (a fresh ``TrainState`` of the same
        model and optimizer, on the device to restore to) in place.

        :param step: a finished step (default: the latest).
        :returns: :class:`JobCheckpoint`, or None if there is no such step.
        """
        steps = self.all_steps()
        if step is None:
            if not steps:
                return None
            step = steps[-1]
        elif int(step) not in steps:
            return None
        root = self._step_dir(step)
        model_sd, optim_sd = get_state_dict(state_template.model, state_template.optimizer)
        wrapped_model, wrapped_optim = _state_dicts(state_template, (model_sd, optim_sd))
        payload = {'model': wrapped_model, 'optim': wrapped_optim, 'step': 0, 'loader': '',
                   'extra': ''}
        dcp.load(payload, checkpoint_id=root, no_dist=_no_dist())
        # The DTensor views were loaded in place: the local tensors hold it.
        set_state_dict(state_template.model, state_template.optimizer,
                       model_state_dict=model_sd,
                       optim_state_dict=dict(optim_sd,
                                             param_groups=payload['optim']['param_groups']))
        state_template.step = int(payload['step'])
        with open(os.path.join(root, FINISHED_MARKER)) as f:
            world = json.load(f).get('loader_ranks', 0)
        if world:
            loader_states = []
            for rank in range(world):
                with open(os.path.join(root, _LOADER_FILE.format(rank))) as f:
                    loader_states.append(_decode_loader_state(json.loads(f.read())) or None)
            here, rank = (1, 0) if _no_dist() else (dist.get_world_size(), dist.get_rank())
            loader_state = loader_states[rank] if here == world else None
        else:
            loader_state = _decode_loader_state(json.loads(payload['loader'])) or None
            loader_states = [loader_state]
        return JobCheckpoint(step=int(step), state=state_template, loader_state=loader_state,
                             extra=json.loads(payload['extra']) or {},
                             loader_states=loader_states)

    # -- lifecycle ---------------------------------------------------------

    def wait(self):
        """Block until every background save is durable; raise the first
        failure."""
        pending, self._pending = self._pending, []
        for future in pending:
            future.result()

    def close(self):
        if self._closed:
            return
        try:
            self.wait()
        finally:
            self._closed = True
            if self._executor is not None:
                self._executor.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False


def _sharded(state):
    """A state on a mesh saves shard by shard, through the process group."""
    return getattr(state, 'mesh', None) is not None and not _no_dist()


def _state_dicts(state, dicts=None):
    """DCP's model and optimizer state dicts of ``state`` (or ``dicts``),
    with the split parameters and their optimizer state viewed as
    ``DTensor``s on a mesh state."""
    model_sd, optim_sd = dicts or get_state_dict(state.model, state.optimizer)
    placements = getattr(state, 'placements', None)
    if getattr(state, 'mesh', None) is None or not placements:
        return model_sd, optim_sd
    from petastorm_tpu_torch.parallel.tensor_parallel import to_dtensors
    model_sd = to_dtensors(model_sd, state.mesh, placements)
    optim_sd = dict(optim_sd)
    optim_sd['state'] = {
        fqn: to_dtensors(entry, state.mesh, {k: placements[fqn] for k in entry
                                             if fqn in placements and torch.is_tensor(entry[k])
                                             and entry[k].dim() > 0})
        for fqn, entry in optim_sd['state'].items()}
    return model_sd, optim_sd


def _no_dist():
    """One process saves and loads the whole state unless a process group
    is up."""
    return not (dist.is_available() and dist.is_initialized())


def _to_host(obj):
    """A copy of a state dict whose tensors are on the host, detached from
    the live parameters and buffers."""
    if torch.is_tensor(obj):
        return obj.detach().to('cpu', copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _pickle_to_json(loader_state):
    return {_PICKLED_KEY: base64.b64encode(pickle.dumps(loader_state, protocol=5))
            .decode('ascii')}


def _encode_loader_state(loader_state):
    """JSON as it is when it round-trips unchanged through JSON, else
    base64 pickle inside the same JSON entry (``petastorm_tpu/
    job_checkpoint.py:171-203``)."""
    if loader_state is None:
        return {}
    try:
        if json.loads(json.dumps(loader_state)) == loader_state:
            return loader_state
    except (TypeError, ValueError):
        pass
    return _pickle_to_json(loader_state)


def _decode_loader_state(entry):
    if isinstance(entry, dict) and _PICKLED_KEY in entry:
        # Only bytes this checkpointer wrote: the entry of its own artifact.
        return pickle.loads(base64.b64decode(entry[_PICKLED_KEY]))
    return entry


def _capture_loader_state(loader):
    if loader is None or isinstance(loader, dict):
        return loader
    state_dict = getattr(loader, 'state_dict', None)
    if state_dict is None:
        raise TypeError('loader must expose state_dict() or be a dict, got {}'.format(
            type(loader).__name__))
    return state_dict()
