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
* ``async_save=True`` saves through ``dcp.async_save``: the state is
  staged on the caller's thread into one host slab (pinned when CUDA is
  available, and kept for the next save), so training may go on changing
  it, and written in the background, the marker and the rename after it.
  One save is in flight at a time: a save first waits for the one before,
  as orbax's manager does. :meth:`wait` (or ``close``) makes every save
  durable and raises a background failure. ``save_seconds`` holds the
  seconds the latest ``save`` call took on the caller's thread.
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
state in ``loader_states``. An async sharded save (orbax's background save
of ``NamedSharding`` leaves, ``petastorm_tpu/job_checkpoint.py:50-69``)
coordinates its background writes over a gloo group of its own, made at its
first save, so they never interleave with the training's collectives (and
an NCCL job gets the CPU backend ``dcp.async_save`` needs). Saves, restores
and save seconds are ``pst_checkpoint_saves_total``,
``pst_checkpoint_restore_total`` and ``pst_checkpoint_save_seconds``
(``petastorm_tpu/job_checkpoint.py:74-82``).
"""

import base64
import concurrent.futures
import copy
import json
import os
import pickle
import shutil
import time
import uuid

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp

from petastorm_tpu_torch import metrics
from torch.distributed.checkpoint.staging import AsyncStager
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
        self._stager = None           # the async saves' host slab
        self._group = None            # the async sharded saves' gloo group
        self._last_step = self.latest_step()
        self._closed = False
        #: Seconds the latest ``save`` call held the caller's thread.
        self.save_seconds = None
        self._m_saves = metrics.counter(
            'pst_checkpoint_saves_total',
            'Job checkpoints actually saved (interval skips excluded)')
        self._m_restores = metrics.counter(
            'pst_checkpoint_restore_total',
            'Job checkpoints restored')
        self._m_save_seconds = metrics.histogram(
            'pst_checkpoint_save_seconds',
            'JobCheckpointer.save latency (dispatch only under async_save)')

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
        t0 = time.perf_counter()
        step = int(step)
        if not force and ((self._last_step is not None and self._last_step >= step)
                          or step % self._interval):
            return False
        if os.path.exists(os.path.join(self._step_dir(step), FINISHED_MARKER)):
            raise FileExistsError('step {} is already saved in {}'.format(step, self.directory))
        sharded = _sharded(state)
        model_sd, optim_sd = _state_dicts(state)
        loader_json = json.dumps(_encode_loader_state(_capture_loader_state(loader)))
        payload = {'model': model_sd, 'optim': optim_sd, 'step': int(state.step),
                   'loader': '' if sharded else loader_json,
                   'extra': json.dumps(extra if extra is not None else {})}
        self._last_step = step if self._last_step is None else max(self._last_step, step)
        tmp = os.path.join(self.directory, '{}{}-{}'.format(_TMP_PREFIX, step, uuid.uuid4().hex))
        if sharded:
            names = [tmp]
            dist.broadcast_object_list(names, src=0)     # one directory for every rank
            tmp = names[0]
        rank_loader = loader_json if sharded else None
        if self._async:
            self.wait()       # the slab and the group serve one save at a time
            group = self._async_group() if sharded else None
            if self._stager is None:
                self._stager = _HostStager()
            upload = dcp.async_save(payload, checkpoint_id=tmp, process_group=group,
                                    async_stager=self._stager, no_dist=_no_dist())
            self._pending.append(self._executor.submit(
                self._finish_async, step, tmp, upload, rank_loader, group))
        else:
            try:
                dcp.save(payload, checkpoint_id=tmp, no_dist=_no_dist())
            except BaseException:
                if not sharded or dist.get_rank() == 0:
                    shutil.rmtree(tmp, ignore_errors=True)
                raise
            self._commit(step, tmp, rank_loader)
        self.save_seconds = time.perf_counter() - t0
        self._m_saves.inc()
        self._m_save_seconds.observe(self.save_seconds)
        return True

    def _async_group(self):
        """The gloo group of the async sharded saves (every rank makes it
        at its first save, as every rank saves alike)."""
        if self._group is None:
            self._group = dist.new_group(backend='gloo')
        return self._group

    def _finish_async(self, step, tmp, upload, rank_loader, group):
        """The background half of an async save: the upload, then the
        commit."""
        try:
            upload.result()
        except BaseException:
            if rank_loader is None or dist.get_rank() == 0:
                shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._commit(step, tmp, rank_loader, group)

    def _commit(self, step, tmp, rank_loader=None, group=None):
        """Make the written ``tmp`` the step: ``rank_loader`` (a sharded
        save) is this rank's loader state, written beside the shards; rank
        0 writes the marker and renames once every rank has written."""
        sharded = rank_loader is not None
        try:
            if sharded:
                with open(os.path.join(tmp, _LOADER_FILE.format(dist.get_rank())), 'w') as f:
                    f.write(rank_loader)
                dist.barrier(group=group)
            if not sharded or dist.get_rank() == 0:
                with open(os.path.join(tmp, FINISHED_MARKER), 'w') as f:
                    # A sharded save's loader states are one file a rank.
                    json.dump({'step': step, 'time': time.time(),
                               'loader_ranks': dist.get_world_size() if sharded else 0}, f)
                    f.flush()
                    os.fsync(f.fileno())
                final = self._step_dir(step)
                if os.path.isdir(final):
                    shutil.rmtree(final)     # a torn directory of this step: no marker
                os.replace(tmp, final)
                self._apply_retention()
        except BaseException:
            if not sharded or dist.get_rank() == 0:
                shutil.rmtree(tmp, ignore_errors=True)
            raise
        finally:
            if sharded:
                dist.barrier(group=group)

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
        self._m_restores.inc()
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
            self._stager = None       # frees the slab
            if self._group is not None:
                dist.destroy_process_group(self._group)
                self._group = None

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


class _HostStager(AsyncStager):
    """Stages a state dict for ``dcp.async_save`` on the caller's thread:
    every plain tensor copied into one host slab, pinned when CUDA is
    available (one allocation, kept for the next save: a pageable copy, or
    a pinned allocation a tensor, holds the thread far longer), by
    non-blocking copies and one synchronize. A ``DTensor`` (a mesh state's
    split entries) is cloned where it lies, so its placement stays and the
    next steps do not change what is written; other leaves are
    deep-copied."""

    _synchronize_after_execute = False
    _ALIGN = 64

    def __init__(self):
        self._pin = torch.cuda.is_available()
        self._slab = None

    def stage(self, state_dict):
        tensors = []
        _collect_tensors(state_dict, tensors)
        sizes = [-(-t.nbytes // self._ALIGN) * self._ALIGN for t in tensors]
        if self._slab is None or self._slab.numel() < sum(sizes):
            self._slab = torch.empty(sum(sizes), dtype=torch.uint8, pin_memory=self._pin)
        copies, offset = {}, 0
        for t, size in zip(tensors, sizes):
            view = self._slab[offset:offset + t.nbytes].view(t.dtype).view(t.shape)
            view.copy_(t.detach(), non_blocking=self._pin and t.is_cuda)
            copies[id(t)] = view
            offset += size
        staged = _rebuild(state_dict, copies)
        if self._pin:
            torch.cuda.synchronize()
        return staged

    def synchronize_staging(self):
        """Staging is done when :meth:`stage` returns."""

    def close(self):
        """Keeps the slab for the next save (``dcp.async_save`` may close a
        stager after each upload); the checkpointer drops the stager."""


def _collect_tensors(obj, out):
    """The plain tensors of a state dict, in order (``DTensor``s aside)."""
    from torch.distributed.tensor import DTensor
    if isinstance(obj, DTensor):
        return
    if torch.is_tensor(obj):
        out.append(obj)
    elif type(obj) is dict:
        for v in obj.values():
            _collect_tensors(v, out)
    elif type(obj) in (list, tuple):
        for v in obj:
            _collect_tensors(v, out)


def _rebuild(obj, copies):
    """``obj`` with each plain tensor replaced by its staged copy."""
    from torch.distributed.tensor import DTensor
    if isinstance(obj, DTensor):
        return obj.detach().clone()
    if torch.is_tensor(obj):
        return copies[id(obj)]
    if type(obj) is dict:
        return {k: _rebuild(v, copies) for k, v in obj.items()}
    if type(obj) in (list, tuple):
        return type(obj)(_rebuild(v, copies) for v in obj)
    return copy.deepcopy(obj)

def _pickle_to_json(loader_state):
    return {_PICKLED_KEY: base64.b64encode(pickle.dumps(loader_state, protocol=5))
            .decode('ascii')}


def _encode_loader_state(loader_state):
    """JSON as it is when it round-trips unchanged through JSON, else
    base64 pickle inside the same JSON entry (``petastorm_tpu/
    job_checkpoint.py:171-203``)."""
    if loader_state is None:
        return {}
    if (isinstance(loader_state, dict) and 'server_states' in loader_state
            and ('pending' in loader_state or 'consumers' in loader_state)):
        # The data service's states (a sole consumer's state_dict or
        # checkpoint_shared_stream's) hold the drained numpy chunks: pickle,
        # with no JSON probe over megabytes of them
        # (``petastorm_tpu/job_checkpoint.py:181-189``).
        return _pickle_to_json(loader_state)
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
