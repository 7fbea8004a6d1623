"""``TorchLoader``: fixed-size device batches off a reader.

Counterpart of ``petastorm_tpu/jax_loader.py`` (``JaxLoader`` at ``:705``,
the shape policies at ``:60-101``, the per-row ``iter_numpy_batches`` at
``:173``, the block fast path ``_iter_block_batches`` at ``:431`` and the
dtype table at ``:106-136``), single device.

Path of a batch on CUDA: the reader's rows (``make_reader``) or decoded
row-group blocks (``make_tensor_reader``) are cut into ``batch_size`` rows
and collated into a recycled pinned host arena (assemble thread); the
dispatch thread issues ``dst.copy_(pinned_src, non_blocking=True)`` on a
dedicated CUDA stream and records an event behind the copies; the consumer
stream ``wait_event``s before it hands the batch out, and
``record_stream`` keeps the caching allocator from reusing the memory while
the consumer's kernels still read it. The arena is recycled only after its
event completed. With ``prefetch=0`` there are no staging threads: the
consumer's own thread collates and issues the copies, and an arena goes
back to the pool only once its copy's event completed (a fence, not a
synchronous copy: the copy still overlaps the consumer's next step).

dtype table (the JAX package narrows 64-bit types; torch keeps them):
bool, uint8, int8, int16, int32, int64, float16, float32 and float64 keep
their type; uint16 widens to int32 and uint32 to int64 (values preserved);
datetime64 becomes int64 nanoseconds; uint64, strings and objects cannot
batch and are dropped with a warning (``strict_fields=True`` raises).
"""

import queue
import threading
import time
import warnings
from collections import deque, namedtuple

import numpy as np
import torch

from petastorm_tpu_torch import membudget
from petastorm_tpu_torch.device import resolve_device
from petastorm_tpu_torch.lineage import LineageTracker, lineage_enabled, resolve_ledger_dir
from petastorm_tpu_torch.parallel.mesh import (Sharding, axis_names, axis_size,
                                               batch_sharding, device_shard_plan, has_axis,
                                               local_device)
from petastorm_tpu_torch.shuffling_buffer import build_shuffling_buffer
from petastorm_tpu_torch.staging import (ArenaPool, DevicePutMeter, MeteredReader, OverlapMeter,
                                         StagingEngine)

_WIDEN = {np.dtype('uint16'): np.dtype('int32'), np.dtype('uint32'): np.dtype('int64')}
_KEEP = frozenset(np.dtype(t) for t in ('bool', 'uint8', 'int8', 'int16', 'int32', 'int64',
                                        'float16', 'float32', 'float64'))
_LAST_BATCH = ('drop', 'pad', 'partial')


# --------------------------------------------------------------------------
# shape policies
# --------------------------------------------------------------------------

class ShapePolicy(object):
    """How to give a ragged field a static shape."""

    def apply(self, array):
        raise NotImplementedError


class PadTo(ShapePolicy):
    """Pad (and clip) every sample to ``target_shape`` with ``fill_value``."""

    def __init__(self, target_shape, fill_value=0):
        self.target_shape = tuple(target_shape)
        self.fill_value = fill_value

    def apply(self, array):
        array = np.asarray(array)
        if array.shape == self.target_shape:
            return array
        out = np.full(self.target_shape, self.fill_value, dtype=array.dtype)
        slices = tuple(slice(0, min(a, t)) for a, t in zip(array.shape, self.target_shape))
        out[slices] = array[slices]
        return out


class CropTo(ShapePolicy):
    """Center-crop every sample to ``target_shape`` (must fit)."""

    def __init__(self, target_shape):
        self.target_shape = tuple(target_shape)

    def apply(self, array):
        array = np.asarray(array)
        if array.shape == self.target_shape:
            return array
        starts = [(a - t) // 2 for a, t in zip(array.shape, self.target_shape)]
        if any(s < 0 for s in starts):
            raise ValueError('CropTo{}: sample shape {} too small'.format(
                self.target_shape, array.shape))
        return array[tuple(slice(s, s + t) for s, t in zip(starts, self.target_shape))]


# --------------------------------------------------------------------------
# dtypes
# --------------------------------------------------------------------------

def sanitize_dtype(np_dtype):
    """The numpy dtype a field batches as on torch, or None if it cannot."""
    np_dtype = np.dtype(np_dtype)
    if np_dtype.kind == 'M':
        return np.dtype('int64')
    if np_dtype in _KEEP:
        return np_dtype
    return _WIDEN.get(np_dtype)


def _sanitize_array(array):
    array = np.asarray(array)
    target = sanitize_dtype(array.dtype)
    if target is None:
        return None
    if array.dtype.kind == 'M':
        array = array.astype('datetime64[ns]').view(np.int64)
    return np.ascontiguousarray(array.astype(target, copy=False))


def _batchable(probe, name, shape_policies):
    """True if a sample (a row's value, or a block) can become a tensor,
    possibly through its field's shape policy."""
    if probe is None:
        return False
    kind = np.asarray(probe).dtype
    if kind.kind in ('O', 'U', 'S'):
        return name in shape_policies
    return sanitize_dtype(kind) is not None


def _select_fields(names, dropped, strict_fields):
    if dropped:
        if strict_fields:
            raise ValueError(
                'torch loader cannot batch fields: {} (nullable-declared or non-tensor). '
                'Narrow schema_fields or pass strict_fields=False to drop them with a '
                'warning.'.format(sorted(dropped)))
        warnings.warn('torch loader dropping non-tensor fields: {}'.format(sorted(dropped)))
    if not names:
        raise ValueError('No batchable fields left (all dropped: {})'.format(sorted(dropped)))
    return names


def _stack_column(values, name, shape_policies, out=None):
    """Rows of one field -> a sanitized ``[n, ...]`` array, stacked straight
    into ``out`` (an arena buffer) when the rows already have its dtype and
    shape."""
    if any(v is None for v in values):
        raise ValueError('Field {!r} contains None (nullable) values; fill or drop them '
                         'before batching'.format(name))
    policy = shape_policies.get(name)
    rows = [np.asarray(policy.apply(v) if policy is not None else v) for v in values]
    if (out is not None and len(rows) == out.shape[0]
            and all(r.dtype == out.dtype and r.shape == out.shape[1:] for r in rows)):
        np.stack(rows, out=out)
        return out
    try:
        stacked = np.stack(rows)
    except ValueError as e:
        raise ValueError(
            'Field {!r} has ragged shapes and no shape policy; pass '
            "shape_policies={{'{}': PadTo(...)}} or CropTo(...): {}".format(name, name, e)) from e
    sanitized = _sanitize_array(stacked)
    if sanitized is None:
        raise ValueError('Field {!r} dtype {} cannot batch on torch'.format(name, stacked.dtype))
    return sanitized


# --------------------------------------------------------------------------
# host batch assembly
# --------------------------------------------------------------------------

def iter_numpy_batches(reader, batch_size, shape_policies=None, shuffling_queue_capacity=0,
                       min_after_dequeue=None, seed=None, last_batch='drop', strict_fields=False,
                       batch_buffers=None, views_ok=True):
    """Yield dicts of numpy arrays with leading dim ``batch_size``.

    Works over row readers (``make_reader``) and tensor readers
    (``make_tensor_reader``). ``last_batch``: ``'drop'`` | ``'pad'``
    (repeat the last row into a full batch) | ``'partial'`` (yield it
    short). ``shuffling_queue_capacity > 0`` draws rows through a
    :class:`~petastorm_tpu_torch.shuffling_buffer.RandomShufflingBuffer`
    seeded with ``seed`` (floor ``min_after_dequeue``, default 4/5 of the
    capacity). ``strict_fields=True`` raises instead of warn-and-drop when a
    selected field cannot batch. ``batch_buffers``: a callable ``spec ->
    dict of arrays or None`` (``spec``: ``{name: (shape, dtype)}``) giving
    preallocated output buffers (the staging engine's arenas), which rows
    are stacked into in place; ``views_ok=False`` also collates batches that
    would be views of a chunk into those buffers.
    """
    for batch, _ in _iter_batches(reader, batch_size, shape_policies, shuffling_queue_capacity,
                                  min_after_dequeue, seed, last_batch, strict_fields,
                                  batch_buffers, views_ok):
        yield batch


def _iter_batches(reader, batch_size, shape_policies=None, shuffling_queue_capacity=0,
                  min_after_dequeue=None, seed=None, last_batch='drop', strict_fields=False,
                  batch_buffers=None, views_ok=True, lineage=None, shuffler=None,
                  commit_rows=None):
    """:func:`iter_numpy_batches`, each batch paired with its count of
    source rows (a padded batch holds fewer than it has). ``lineage`` (a
    :class:`~petastorm_tpu_torch.lineage.LineageCollector`) gets each
    chunk's segment and each emitted batch, digested here on the assembled
    host batch; a shuffling buffer makes its records inexact. ``shuffler``:
    a prebuilt (possibly restored) shuffling buffer to use instead of one
    built from ``shuffling_queue_capacity``; ``commit_rows(rows)`` then
    adds each chunk's rows to it (the loader's checkpoint-atomic add)."""
    if last_batch not in _LAST_BATCH:
        raise ValueError('last_batch must be drop|pad|partial, got {!r}'.format(last_batch))
    shape_policies = dict(shape_policies or {})
    if shuffler is None and shuffling_queue_capacity and shuffling_queue_capacity > 0:
        shuffler = build_shuffling_buffer(shuffling_queue_capacity, min_after_dequeue, seed)
    if shuffler is not None and lineage is not None:
        lineage.mark_inexact()     # the buffer breaks the chunk -> batch FIFO
    batched = getattr(reader, 'batched_output', False)
    if batched and shuffler is None:
        yield from _iter_block_batches(reader, batch_size, shape_policies, last_batch,
                                       strict_fields, batch_buffers, views_ok, lineage)
        return

    schema = getattr(reader, 'schema', None)
    field_names = None
    columns = {}
    count = 0
    batch_spec = None         # learned from the first emitted batch (the arena hookup)
    arenas_effective = True   # until a whole batch proves un-stackable into its arena

    def select(sample):
        names, dropped = [], []
        for name in sample._fields:
            value = getattr(sample, name)
            if batched:
                column = np.asarray(value)
                value = column[0] if (column.dtype.kind == 'O' and len(column)) else column
            # A row reader's Unischema is authoritative: a nullable field
            # cannot batch even while its values happen to be present.
            nullable = (not batched and schema is not None and name in schema.fields
                        and schema.fields[name].nullable)
            (names if not nullable and _batchable(value, name, shape_policies)
             else dropped).append(name)
        names = _select_fields(names, dropped, strict_fields)
        if shuffler is not None:
            # Rides the checkpoint: a resumed reader may yield no sample.
            shuffler.field_names = list(names)
        return names

    def add(row):
        nonlocal count
        for name, value in zip(field_names, row):
            columns.setdefault(name, []).append(value)
        count += 1

    def emit(final=False):
        nonlocal columns, count, batch_spec, arenas_effective
        while count >= batch_size:
            out_bufs = (batch_buffers(batch_spec)
                        if batch_buffers is not None and batch_spec and arenas_effective
                        else None)
            batch = {}
            for name in field_names:
                buf = out_bufs.get(name) if out_bufs is not None else None
                batch[name] = _stack_column(columns[name][:batch_size], name, shape_policies,
                                            out=buf)
                columns[name] = columns[name][batch_size:]
            count -= batch_size
            if batch_spec is None:
                batch_spec = {name: (arr.shape, arr.dtype) for name, arr in batch.items()}
            elif out_bufs is not None:
                # Rows that always need a conversion never stack into the
                # arena: stop claiming one per batch.
                arenas_effective = any(batch[name] is out_bufs[name] for name in field_names)
            if lineage is not None:
                lineage.on_batch(batch_size, batch=batch)
            yield batch, batch_size
        if final and count:
            if last_batch != 'drop':
                batch = {}
                for name in field_names:
                    col = columns[name]
                    if last_batch == 'pad':
                        col = col + [col[-1]] * (batch_size - len(col))
                    batch[name] = _stack_column(col, name, shape_policies)
                if lineage is not None:
                    lineage.on_batch(count, batch=batch,
                                     padded=batch_size - count if last_batch == 'pad' else 0)
                yield batch, count
            columns, count = {}, 0

    for sample in reader:
        if field_names is None:
            field_names = select(sample)
        if batched:
            rows = list(zip(*(getattr(sample, name) for name in field_names)))
        else:
            rows = [tuple(getattr(sample, name) for name in field_names)]
        if lineage is not None:
            lineage.on_chunk(getattr(reader, 'last_chunk_lineage', None), len(rows))
        if shuffler is not None:
            if commit_rows is not None:
                commit_rows(rows)
            else:
                shuffler.add_many(rows)
            while shuffler.can_retrieve():
                add(shuffler.retrieve())
                if count >= batch_size:
                    yield from emit()
        else:
            for row in rows:
                add(row)
            yield from emit()
    if shuffler is not None:
        shuffler.finish()
        if field_names is None and shuffler.can_retrieve():
            # Every remaining row was buffered at the checkpoint: the
            # snapshot carries the field order.
            field_names = shuffler.field_names
            if field_names is None:
                raise ValueError('the restored shuffling buffer holds rows but carries no '
                                 'field names, and the reader yielded no sample')
        while shuffler.can_retrieve():
            add(shuffler.retrieve())
    if field_names is not None:
        yield from emit(final=True)


def _iter_block_batches(reader, batch_size, shape_policies, last_batch, strict_fields,
                        batch_buffers, views_ok, lineage=None):
    """The block path of :func:`iter_numpy_batches`: fixed-size batches cut
    from a tensor reader's column blocks, with no per-row Python. A batch
    inside one chunk is a leading-dim view when ``views_ok`` and
    the chunk's blocks are writable; otherwise (and always for read-only
    blocks, which a cache shares across epochs) rows are collated into
    ``batch_buffers(spec)`` (a recycled arena) or a fresh buffer. Yields
    ``(batch, source rows)``."""
    field_names = None
    chunks = []   # dicts name -> sanitized block, oldest first
    have = 0

    def select(sample):
        names, dropped = [], []
        for name in sample._fields:
            column = np.asarray(getattr(sample, name))
            probe = column[0] if (column.dtype.kind == 'O' and len(column)) else column
            (names if _batchable(probe, name, shape_policies) else dropped).append(name)
        return _select_fields(names, dropped, strict_fields)

    def densify(name, block):
        """Apply the field's shape policy row by row (object columns of
        ragged rows become dense)."""
        block = np.asarray(block)
        policy = shape_policies.get(name)
        if policy is None:
            return block
        return _stack_column(list(block), name, shape_policies)

    def out_buffers(n, head):
        spec = {name: ((n,) + head[name].shape[1:], head[name].dtype) for name in field_names}
        out = batch_buffers(spec) if batch_buffers is not None else None
        if out is None:
            out = {name: np.empty(shape, dtype) for name, (shape, dtype) in spec.items()}
        return out

    def take(n):
        nonlocal have
        head = chunks[0]
        rows = len(head[field_names[0]])
        have -= n
        if rows >= n and views_ok and all(head[name].flags.writeable for name in field_names):
            if rows == n:
                chunks.pop(0)
            else:
                chunks[0] = {name: head[name][n:] for name in field_names}
            return {name: head[name][:n] for name in field_names}
        out = out_buffers(n, head)
        pos = 0
        while pos < n:
            head = chunks[0]
            k = min(len(head[field_names[0]]), n - pos)
            for name in field_names:
                np.copyto(out[name][pos:pos + k], head[name][:k])
            if k == len(head[field_names[0]]):
                chunks.pop(0)
            else:
                chunks[0] = {name: head[name][k:] for name in field_names}
            pos += k
        return out

    for sample in reader:
        if field_names is None:
            field_names = select(sample)
        chunk = {}
        for name in field_names:
            block = _sanitize_array(densify(name, getattr(sample, name)))
            if block is None:
                raise ValueError('Field {!r} cannot batch on torch'.format(name))
            chunk[name] = block
        chunks.append(chunk)
        have += len(chunk[field_names[0]])
        if lineage is not None:
            lineage.on_chunk(getattr(reader, 'last_chunk_lineage', None),
                             len(chunk[field_names[0]]))
        while have >= batch_size:
            batch = take(batch_size)
            if lineage is not None:
                lineage.on_batch(batch_size, batch=batch)
            yield batch, batch_size

    if have and last_batch == 'partial':
        source_rows = have
        batch = take(have)
        if lineage is not None:
            lineage.on_batch(source_rows, batch=batch)
        yield batch, source_rows
    elif have and last_batch == 'pad':
        # Never in place: the tail may be a cache-shared (read-only) block.
        out = out_buffers(batch_size, chunks[0])
        pos = 0
        for head in chunks:
            k = len(head[field_names[0]])
            for name in field_names:
                np.copyto(out[name][pos:pos + k], head[name])
            pos += k
        for name in field_names:
            out[name][pos:] = out[name][pos - 1]
        if lineage is not None:
            lineage.on_batch(have, batch=out, padded=batch_size - have)
        yield out, have


# --------------------------------------------------------------------------
# device staging
# --------------------------------------------------------------------------

class _Staged(object):
    """Device tensors of one batch, its source rows, and the events
    recorded around its copies."""

    __slots__ = ('tensors', 'rows', 'event', 'start', 'nbytes')

    def __init__(self, tensors, rows, event=None, start=None, nbytes=0):
        self.tensors = tensors
        self.rows = rows
        self.event = event
        self.start = start
        self.nbytes = nbytes


_END = object()


class TorchLoader(object):
    """Iterates namedtuples (``TorchBatch``, fields sorted by name) of
    device tensors off a reader.

    :param reader: a ``make_reader`` or ``make_tensor_reader`` Reader; the
        loader takes the per-row or the block path by its
        ``batched_output``. The loader does not own it: stop the reader
        yourself.
    :param batch_size: rows per batch.
    :param device: ``'cuda'`` (the default without a mesh; raises without a
        GPU) or ``'cpu'``; with a mesh the default is the mesh's device.
    :param prefetch: staged batches kept ahead of the consumer. ``>= 1``
        runs the staging engine's assemble and dispatch threads; ``0`` runs
        none: the consumer's thread collates and issues the copy inline.
    :param shape_policies: dict field -> :class:`ShapePolicy` for ragged
        fields.
    :param last_batch: ``'drop'`` | ``'pad'`` | ``'partial'``.
    :param shuffling_queue_capacity: rows of the row-level shuffling buffer
        (0 = none); ``min_after_dequeue`` its floor, ``seed`` its draws.
    :param strict_fields: raise instead of dropping a field that cannot batch.
    :param echo: deliver each staged batch ``echo`` times (data echoing).
        ``stats['batches']`` counts the deliveries, ``stats['rows']`` each
        source row once.
    :param inflight: staged batches whose copies may be in flight before
        the oldest is waited on (the window that lets the collate of batch
        N+1 overlap the copy of batch N).
    :param arena_depth: host arenas in the pool (default
        ``max(2, prefetch) + inflight + 2``); an exhausted pool briefly
        holds the assembler back, then grows.
    :param lineage: batch provenance (:mod:`~petastorm_tpu_torch.lineage`):
        ``True`` arms it (the ledger in ``PSTT_LINEAGE_DIR`` or a fresh
        temporary directory), a string is the ledger's directory, a
        :class:`~petastorm_tpu_torch.lineage.LineageTracker` is adopted as
        it is (its owner closes it), ``None`` defers to
        ``PSTT_LINEAGE_DIR``, ``False`` disarms. Each delivered batch's
        record is ``last_provenance``; counters ride ``stats['lineage']``.
    :param resume_state: the ``state_dict()`` this loader's reader was
        resumed from (``make_tensor_reader(..., resume_state=state)``):
        its ``shuffling_buffer`` snapshot refills the shuffling buffer.
    :param mesh: a ``DeviceMesh`` (:func:`~petastorm_tpu_torch.parallel.
        mesh.make_mesh`): ``batch_size`` is then the *global* batch, as in
        the JAX loader, and this rank delivers its tile of it on its own
        device, ``[batch_size / dp, ...]`` with ``dp`` the size of
        ``batch_axis``. Read this rank's data shard
        (:func:`~petastorm_tpu_torch.reader.make_pod_reader`). ``device``
        defaults to the mesh's.
    :param sharding: a :class:`~petastorm_tpu_torch.parallel.mesh.Sharding`
        for every field, or a dict field -> ``Sharding`` (the rest take
        ``batch_sharding(mesh, batch_axis)``); a sequence-sharded field
        (``sequence_sharding``) arrives as ``[B/dp, T/sp, ...]``. Ranks that
        share a data shard (peers on another axis) must see the same rows in
        the same order, so on a mesh with peers the reader must be
        ``deterministic=True``.
    :param batch_axis: the mesh axis (or axes) the batch is split over.
        A field split on the batch dim alone is copied as this rank's tile
        (counted in ``stats['shards_put']``); a field split on another dim
        too is copied as this rank's rows and cut on the device.

    Host memory: the loader registers its pools with the governor
    (:mod:`~petastorm_tpu_torch.membudget`, ``petastorm_tpu/jax_loader.py:
    1265-1344``): ``arena-pool`` (the advisory rung unpins new arenas),
    ``prefetch-queue`` (host bytes of queued batches that live outside the
    arenas) and ``shuffling-buffer`` (the degrade rung halves it, for a
    reader that is not deterministic). It arms the governor when
    ``PSTT_HOST_MEM_BUDGET`` is set, and a breach raises
    :class:`~petastorm_tpu_torch.errors.HostMemoryExceededError` from
    ``next``.

    Resume (``state_dict()``): without a shuffling buffer a tensor reader's
    rows count as consumed when their batch is delivered, through
    prefetch, ``inflight``, ``prefetch=0``, ``echo`` (each source row once)
    and ``superbatches(k)`` (when the whole group is yielded), so a
    checkpoint taken between batches resumes with no row lost or repeated.
    With a shuffling buffer, the buffered and drawn-but-undelivered rows
    ride the state. A per-row reader counts a row when it leaves the reader.
    """

    def __init__(self, reader, batch_size, device=None, prefetch=2, shape_policies=None,
                 last_batch='drop', shuffling_queue_capacity=0, min_after_dequeue=None,
                 seed=None, strict_fields=False, echo=1, inflight=2, arena_depth=None,
                 lineage=None, resume_state=None, mesh=None, sharding=None, batch_axis='data'):
        if batch_size < 1:
            raise ValueError('batch_size must be >= 1, got {}'.format(batch_size))
        if prefetch < 0:
            raise ValueError('prefetch must be >= 0, got {}'.format(prefetch))
        if echo < 1:
            raise ValueError('echo must be >= 1, got {}'.format(echo))
        if inflight < 1:
            raise ValueError('inflight must be >= 1, got {}'.format(inflight))
        if last_batch not in _LAST_BATCH:
            raise ValueError('last_batch must be drop|pad|partial, got {!r}'.format(last_batch))
        membudget.validate_env_budget()
        self._init_mesh(reader, mesh, sharding, batch_axis, batch_size, last_batch)
        if device is None:
            device = local_device(self._mesh) if self._mesh is not None else 'cuda'
        self.device = resolve_device(device)
        self._reader = reader
        self._batch_size = int(batch_size) // self._dp
        batch_size = self._batch_size
        self._cuda = self.device.type == 'cuda'
        self._init_resume(reader, shuffling_queue_capacity, min_after_dequeue, seed,
                          resume_state)
        self._init_lineage(reader, lineage, batch_size, last_batch, shape_policies,
                           shuffling_queue_capacity)
        self._prefetch = int(prefetch)
        self._inflight = int(inflight)
        self._echo = int(echo)
        self._echo_left = 0
        self._echo_item = None
        self._stop = threading.Event()
        self._h2d_stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._closed = False
        self._exhausted = False
        self._stats_lock = threading.Lock()
        self._reset_counters()
        # Arenas: those behind queued batches, in-flight copies, and the two
        # being filled and consumed.
        self._arena_depth = (int(arena_depth) if arena_depth is not None
                             else max(2, self._prefetch) + self._inflight + 2)
        self._pool = ArenaPool(self._arena_depth, self._stop, pinned=self._cuda)
        if self._echo > 1:
            self._pool.ensure_depth(self._arena_depth + 1)   # the echoed batch's arena
        self._meter = OverlapMeter()
        self._metered = MeteredReader(reader, self._meter) if self._prefetch else None
        # Copying device (CUDA): every batch goes through a pinned arena.
        # Aliasing device (CPU): views of the reader's blocks are cheapest,
        # except of read-only (cached) blocks, which are copied.
        self._host_iter = _iter_batches(
            self._metered or reader, batch_size, shape_policies, shuffling_queue_capacity,
            min_after_dequeue, seed, last_batch, strict_fields,
            batch_buffers=self._pool.get_buffers, views_ok=not self._cuda,
            lineage=self._lineage.collector if self._lineage is not None else None,
            shuffler=self._shuffler,
            commit_rows=self._commit_rows if self._shuffler is not None else None)
        self._engine = self._queue = None
        self._inline = deque()    # prefetch=0: (staged, arena) whose copies may be in flight
        if self._prefetch:
            self._queue = queue.Queue(maxsize=self._prefetch)
            self._engine = StagingEngine(
                self._host_iter, self._stage, self._queue, self._stop, _END, self._pool,
                ready_fn=self._wait_copied, holds_mode=not self._cuda,
                inflight=self._inflight, meter=self._meter).start()
        #: A DeviceDatasetCache over this loader attaches itself here.
        self._device_cache = None
        self._register_memory_pools(reader)

    def _init_mesh(self, reader, mesh, sharding, batch_axis, batch_size, last_batch):
        """The mesh, the per-field shardings and this rank's share of the
        batch (``petastorm_tpu/jax_loader.py:906-922``)."""
        self._mesh = mesh
        self._dp = 1
        self._shardings = None
        self._put_meter = None
        if mesh is None and sharding is None:
            return
        if mesh is None:
            mesh = (sharding if isinstance(sharding, Sharding)
                    else next(iter(sharding.values()))).mesh
        self._mesh = mesh
        if last_batch == 'partial':
            raise ValueError("last_batch='partial' breaks fixed global shapes on a mesh; "
                             "use 'drop' or 'pad'")
        if not has_axis(mesh, batch_axis):
            raise ValueError('batch_axis {!r} is not an axis of the mesh {}'.format(
                batch_axis, mesh.mesh_dim_names))
        self._dp = axis_size(mesh, batch_axis)
        peers = axis_size(mesh, tuple(a for a in mesh.mesh_dim_names
                                      if a not in axis_names(batch_axis)))
        if peers > 1 and getattr(reader, 'deterministic', False) is not True:
            raise ValueError(
                'the {} ranks of this rank\'s data shard (its tensor, sequence, expert or '
                'pipeline peers) must read its rows in one order; build the reader with '
                'deterministic=True'.format(peers))
        if batch_size % self._dp:
            raise ValueError('the global batch_size {} does not divide over {} = {} ranks'
                             .format(batch_size, batch_axis, self._dp))
        default = batch_sharding(mesh, batch_axis)
        if sharding is None:
            sharding = {}
        if isinstance(sharding, Sharding):
            sharding, default = {}, sharding
        batch_spec = batch_sharding(mesh, batch_axis).spec[0]
        for name, field_sharding in list(sharding.items()) + [('*', default)]:
            lead = field_sharding.axis_of(0)
            lead = (lead,) if isinstance(lead, str) else tuple(lead or ())
            if lead != batch_spec:
                raise ValueError('the sharding of field {!r} splits the batch over {}, the '
                                 'loader over batch_axis={!r}'.format(name, lead, batch_axis))
        self._shardings = (dict(sharding), default)
        self._cuts = {}
        self._put_meter = DevicePutMeter()

    def _field_cut(self, name, local_shape):
        """``(per_device, cut)`` for one field: whether its copy is this
        rank's tile as it stands, and the slices of the non-batch dims
        to take on the device (None: none). Computed once a field and shape."""
        key = (name, local_shape)
        if key not in self._cuts:
            per_field, default = self._shardings
            sharding = per_field.get(name, default)
            global_shape = (local_shape[0] * self._dp,) + tuple(local_shape[1:])
            cut = None
            if any(d > 0 for d, _ in sharding.shard_dims()):
                cut = (slice(None),) + sharding.index(global_shape)[1:]
            plan = device_shard_plan(sharding, local_shape, self._dp)
            self._cuts[key] = (plan is not None, cut)
        return self._cuts[key]

    def _register_memory_pools(self, reader):
        governor = membudget.get_governor()
        self._breach_error = None
        self._loose_batch_nbytes = 0   # host bytes of the latest batch outside an arena
        pool = self._pool
        self._pinned_before_advisory = False

        def arena_advisory(active):
            if active:
                self._pinned_before_advisory = pool.pinned
                pool.set_pinned(False)
            elif self._pinned_before_advisory:
                pool.set_pinned(True)

        def prefetch_queue_nbytes():
            # Arena-backed batches are the arena pool's; on CUDA a queued
            # batch holds device memory only.
            if self._queue is None or self._cuda:
                return 0
            return self._queue.qsize() * self._loose_batch_nbytes

        self._mem_handles = [
            governor.register_pool('arena-pool', lambda: pool.nbytes,
                                   advisory_fn=arena_advisory),
            governor.register_pool('prefetch-queue', prefetch_queue_nbytes)]
        if self._shuffler is not None:
            shuffler = self._shuffler
            # Halving the buffer changes the draws: only a reader that says
            # it is not deterministic gets the hook.
            degrade = (shuffler.shrink_capacity
                       if getattr(reader, 'deterministic', None) is False else None)
            self._mem_handles.append(governor.register_pool(
                'shuffling-buffer', lambda: shuffler.nbytes, degrade_fn=degrade))
        self._mem_breach_sink = governor.add_breach_sink(self._deliver_breach)
        self._mem_armed = membudget.maybe_arm_from_env()

    def _deliver_breach(self, error):
        """The governor's breach sink: ``next`` raises ``error``."""
        self._breach_error = error

    def _init_resume(self, reader, shuffling_queue_capacity, min_after_dequeue, seed,
                     resume_state):
        """Checkpoint accounting (``petastorm_tpu/jax_loader.py:925-977``)."""
        # Without a row-level shuffle rows are consumed in delivery order, so
        # a tensor reader's accounting waits for delivery (rows in prefetch
        # at a checkpoint re-deliver on resume).
        self._row_granular = False
        self._defer_rows_consumed = False   # superbatches(): group accounting
        self._pending_fresh_rows = 0
        self._ckpt_lock = threading.Lock()
        self._buffer_entry_ckpt = False
        self._shuffler = None
        snapshot = (resume_state or {}).get('shuffling_buffer')
        if shuffling_queue_capacity and shuffling_queue_capacity > 0:
            # The loader owns its buffer, so state_dict() can snapshot it.
            self._shuffler = build_shuffling_buffer(shuffling_queue_capacity, min_after_dequeue,
                                                    seed)
            if snapshot:
                self._shuffler.restore(snapshot)
            self._shuffler.track_pending()
            # The reader's cursor advances when a chunk's rows land in the
            # buffer, under the same lock as the snapshot.
            if hasattr(reader, 'enable_row_granular_checkpoint'):
                self._buffer_entry_ckpt = reader.enable_row_granular_checkpoint()
        elif snapshot and snapshot.get('rows'):
            raise ValueError(
                'resume_state carries a shuffling-buffer snapshot of {} row(s) but the loader '
                'was rebuilt without shuffling_queue_capacity; those rows would be lost: resume '
                'with the capacity the checkpoint was taken under'.format(len(snapshot['rows'])))
        elif hasattr(reader, 'enable_row_granular_checkpoint'):
            self._row_granular = reader.enable_row_granular_checkpoint()

    def _init_lineage(self, reader, lineage, batch_size, last_batch, shape_policies,
                      shuffling_queue_capacity):
        """Batch provenance (``petastorm_tpu/jax_loader.py:1038-1064``)."""
        self._lineage = None
        self._lineage_owned = False
        self._last_provenance = None
        if isinstance(lineage, LineageTracker):
            self._lineage = lineage
        elif lineage_enabled(lineage):
            ctx_fn = getattr(reader, 'lineage_context', None)
            ctx = ctx_fn() if ctx_fn is not None else {'mode': None}
            ctx.update(batch_size=int(batch_size), last_batch=last_batch,
                       shape_policies=sorted(shape_policies) if shape_policies else None,
                       shuffling_queue_capacity=int(shuffling_queue_capacity or 0))
            self._lineage = LineageTracker(
                ctx, ledger_dir=resolve_ledger_dir(lineage if isinstance(lineage, str) else None),
                state_fn=getattr(reader, 'lineage_state', None))
            self._lineage_owned = True

    def _commit_rows(self, rows):
        """One chunk's rows into the shuffling buffer and the reader's cursor
        past them, as one step against ``state_dict()``."""
        with self._ckpt_lock:
            self._shuffler.add_many(rows)
            if self._buffer_entry_ckpt:
                self._reader.rows_consumed(len(rows))

    def _account_delivery(self):
        """A fresh batch reached the consumer: its rows are consumed."""
        if self._row_granular:
            if self._defer_rows_consumed:
                self._pending_fresh_rows += self._batch_size
            else:
                self._reader.rows_consumed(self._batch_size)
        elif self._shuffler is not None:
            self._shuffler.mark_delivered(self._batch_size)

    def state_dict(self):
        """The position to resume from, taken between batches: the reader's
        ``state_dict()``, plus ``shuffling_buffer`` (its rows and generator
        state; pickle-safe, not JSON-safe) with a shuffling buffer. Rebuild
        with ``make_*_reader(..., resume_state=state)`` and
        ``TorchLoader(..., resume_state=state)``."""
        if self._shuffler is not None:
            with self._ckpt_lock:
                state = dict(self._reader.state_dict())
                state['shuffling_buffer'] = self._shuffler.state_dict()
            return state
        return self._reader.state_dict()

    @property
    def last_provenance(self):
        """The provenance record of the latest delivered batch (None when
        lineage is not armed)."""
        return self._last_provenance

    @property
    def lineage_tracker(self):
        """The loader's :class:`~petastorm_tpu_torch.lineage.LineageTracker`,
        or None."""
        return self._lineage

    def _reset_counters(self):
        with self._stats_lock:
            self._batches = 0
            self._rows = 0
            self._wait_s = 0.0
            self._first_get_t = None
            self._stage_s = 0.0
            self._h2d_bytes = 0
            self._h2d_s = 0.0

    # -- staging -------------------------------------------------------------

    def _stage(self, item, arena):
        batch, rows = item
        t0 = time.perf_counter()
        # The copy source is the arena's pinned tensor where the field was
        # collated into it; else the array itself (a view, or rows that
        # needed a conversion). On the CPU every batch gets tensors of its
        # own: their lifetime is the hold that returns the arena.
        sources = {name: (arena.tensors[name]
                          if self._cuda and arena is not None and arr is arena.buffers.get(name)
                          else torch.from_numpy(arr))
                   for name, arr in batch.items()}
        cuts = {}
        if self._shardings is not None:
            for name, src in sources.items():
                per_device, cuts[name] = self._field_cut(name, tuple(src.shape))
                if per_device:
                    self._put_meter.issued()
        if not self._cuda:
            self._loose_batch_nbytes = sum(
                arr.nbytes for name, arr in batch.items()
                if arena is None or arr is not arena.buffers.get(name))
            tensors = {name: src if cuts.get(name) is None else src[cuts[name]].contiguous()
                       for name, src in sources.items()}
            staged = _Staged(tensors, rows, nbytes=sum(t.nbytes for t in tensors.values()))
            if self._put_meter is not None:
                self._put_meter.completed(self.device, time.perf_counter() - t0, staged.nbytes)
        else:
            with torch.cuda.stream(self._h2d_stream):
                start = torch.cuda.Event(enable_timing=True)
                start.record(self._h2d_stream)
                tensors = {}
                for name, src in sources.items():
                    dst = torch.empty(src.shape, dtype=src.dtype, device=self.device)
                    dst.copy_(src, non_blocking=True)
                    if cuts.get(name) is not None:
                        dst = dst[cuts[name]].contiguous()
                    tensors[name] = dst
                event = torch.cuda.Event(enable_timing=True)
                event.record(self._h2d_stream)
            staged = _Staged(tensors, rows, event, start, sum(t.nbytes for t in tensors.values()))
        with self._stats_lock:
            self._stage_s += time.perf_counter() - t0
        return staged

    def _wait_copied(self, staged):
        """Block until the batch's copies landed; account the H2D time."""
        if staged.event is not None:
            staged.event.synchronize()
            seconds = staged.start.elapsed_time(staged.event) / 1e3
            with self._stats_lock:
                self._h2d_s += seconds
                self._h2d_bytes += staged.nbytes
            if self._put_meter is not None:
                self._put_meter.completed(self.device, seconds, staged.nbytes)

    def _stage_inline(self):
        """``prefetch=0``: the next batch collated and its copies issued on
        this thread. Its arena joins the in-flight window and goes back to
        the pool once its copy's event completed (waited on past
        ``inflight``); on the CPU the staged tensors hold it instead."""
        while self._inline and (self._inline[0][0].event is None
                                or self._inline[0][0].event.query()):
            staged, arena = self._inline.popleft()
            self._wait_copied(staged)
            arena.retire()
        try:
            item = next(self._host_iter)
        except StopIteration:
            return _END
        arena = self._pool.claim_pending()
        staged = self._stage(item, arena)
        if arena is not None:
            if not self._cuda:
                for value in staged.tensors.values():
                    arena.add_hold(value)
            self._inline.append((staged, arena))
            while len(self._inline) > self._inflight:
                old, old_arena = self._inline.popleft()
                self._wait_copied(old)
                old_arena.retire()
        return staged

    def _deliver(self, staged, fresh):
        tensors = staged.tensors
        if self._cuda:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(staged.event)
            for t in tensors.values():
                t.record_stream(consumer)
        names = tuple(sorted(tensors))
        self._batches += 1
        if fresh:
            self._rows += staged.rows
            if self._lineage is not None:
                self._last_provenance = self._lineage.deliver()
            self._account_delivery()
        return _batch_type(names)(**tensors)

    # -- iteration -----------------------------------------------------------

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed:
            raise RuntimeError('Trying to iterate a closed TorchLoader')
        if self._exhausted:
            raise StopIteration
        if self._breach_error is not None:
            self._exhausted = True
            raise self._breach_error
        t0 = time.perf_counter()
        if self._first_get_t is None:
            self._first_get_t = t0
        fresh = self._echo_left == 0
        if not fresh:
            self._echo_left -= 1
            item = self._echo_item
        elif self._engine is None:
            try:
                item = self._stage_inline()
            except Exception as e:  # noqa: BLE001 - raised below, as the staged path does
                item = e
        else:
            item = self._get_staged()
        self._wait_s += time.perf_counter() - t0
        if item is _END:
            self._exhausted = True
            self._echo_item = None
            raise StopIteration
        if isinstance(item, Exception):
            self._exhausted = True
            raise item
        if fresh and self._echo > 1:
            self._echo_item, self._echo_left = item, self._echo - 1
        return self._deliver(item, fresh)

    def _get_staged(self):
        """The next staged batch, or a memory breach delivered meanwhile."""
        while True:
            try:
                return self._queue.get(timeout=0.05)
            except queue.Empty:
                if self._breach_error is not None:
                    return self._breach_error

    def hold_batches(self, n):
        """Say that the consumer keeps up to ``n`` delivered batches alive
        at once. On the CPU a delivered batch may hold its host arena, so
        the arena pool is deepened to cover them (else each batch past the
        pool's depth waits for the pool to grow); on CUDA an arena is free
        once its copy landed, and nothing changes."""
        if not self._cuda:
            self._pool.ensure_depth(self._arena_depth + n + (self._echo > 1))

    def superbatches(self, k):
        """Yield batches of ``k * batch_size`` rows: ``k`` consecutive
        batches concatenated on the device (``torch.cat`` on the consumer
        stream), for :func:`~petastorm_tpu_torch.models.train.make_scan_train_step`
        with ``microbatches=k``. Copies stay at the batch's size. A last
        group of fewer than ``k`` batches is dropped, so every superbatch
        has one shape. ``k <= 1`` yields the batches as they are.

        Checkpoint accounting happens per yielded group: a dropped partial
        group's rows are not counted consumed and re-deliver on resume.

        The JAX package concatenates through ``replica_safe_concat`` only to
        step around a replica-sum bug of its SPMD lowering; ``torch.cat``
        has no such bug.
        """
        if k <= 1:
            yield from self
            return
        self.hold_batches(k)
        while True:
            parts = []
            try:
                for _ in range(k):
                    self._defer_rows_consumed = True
                    try:
                        parts.append(next(self))
                    finally:
                        self._defer_rows_consumed = False
            except StopIteration:
                return
            if self._pending_fresh_rows:
                self._reader.rows_consumed(self._pending_fresh_rows)
                self._pending_fresh_rows = 0
            batch = type(parts[0])(*(torch.cat(columns) for columns in zip(*parts)))
            del parts          # the parts (and on the CPU their arenas) go before the yield
            yield batch

    def reset_stats(self):
        """Zero the counters: call after warm-up, so that ``stats`` covers
        the steady state only."""
        self._reset_counters()
        if self._engine is not None:
            self._engine.reset_stats()
        self._pool.reset_stats()
        if self._put_meter is not None:
            self._put_meter.reset()
        if self._metered is not None:
            self._metered.reader_wait_s = 0.0

    @property
    def stats(self):
        """Delivered ``batches`` (echoes included) and source ``rows``;
        ``wait_s`` blocked in ``next`` and ``input_stall_frac`` (over the
        wall time since the first fetch); ``stage_dispatch_s`` issuing
        copies; ``h2d_bytes``/``h2d_s`` of the completed copies; the
        staging engine's ``assemble_s``, ``dispatch_s``, ``overlap_s``,
        ``overlap_frac``, ``ready_wait_s`` (``prefetch >= 1``); the arena
        pool's ``arena_alloc``, ``arena_reuse``, ``arena_wait_s``;
        ``reader_wait_s``; the reader's ``worker_stage_timings``;
        ``lineage`` (records, dropped, pending, ring, ledger path and lag)
        when armed; ``chunk_store`` (the reader's store's counters) with a
        chunk store; ``device_cache`` with a ``DeviceDatasetCache`` over the
        loader; ``mem`` (the governor's stats) while the governor is
        armed; on a mesh ``n_devices`` (1: a rank copies to its own
        device), ``shards_put`` and, by device,
        ``device_put_s`` and ``device_put_bytes``."""
        elapsed = (time.perf_counter() - self._first_get_t
                   if self._first_get_t is not None else 0.0)
        with self._stats_lock:
            out = {'batches': self._batches, 'rows': self._rows, 'wait_s': self._wait_s,
                   'input_stall_frac': self._wait_s / elapsed if elapsed else 0.0,
                   'stage_dispatch_s': self._stage_s, 'h2d_bytes': self._h2d_bytes,
                   'h2d_s': self._h2d_s}
        if self._engine is not None:
            out.update(self._engine.stats())
        out.update(self._pool.stats())
        if self._put_meter is not None:
            out.update(self._put_meter.stats([self.device]))
        if self._metered is not None:
            out['reader_wait_s'] = self._metered.reader_wait_s
        timings = getattr(self._reader, 'stage_timings', None)
        if timings is not None:
            out['worker_stage_timings'] = timings
        if self._lineage is not None:
            out['lineage'] = self._lineage.stats()
        store = getattr(self._reader, 'chunk_store', None)
        if store is not None:
            out['chunk_store'] = store.stats()
        if self._device_cache is not None:
            out['device_cache'] = self._device_cache.stats()
        governor = membudget.get_governor()
        if governor.armed:
            out['mem'] = governor.stats()
        return out

    def close(self):
        """Stop and join the staging threads, and close an owned lineage
        ledger (an adopted one is flushed) (idempotent)."""
        if self._closed:
            return
        self._closed = True
        governor = membudget.get_governor()
        for handle in self._mem_handles:
            handle.close()
        governor.remove_breach_sink(self._mem_breach_sink)
        if self._mem_armed:
            self._mem_armed = False
            governor.release()
        self._stop.set()
        self._echo_item = None
        while self._inline:
            staged, arena = self._inline.popleft()
            self._wait_copied(staged)
            arena.retire()
        leaked = []
        if self._engine is not None:
            while True:   # unblock a dispatch thread parked on a full queue
                try:
                    self._queue.get_nowait()
                except queue.Empty:
                    break
            leaked = self._engine.stop()
        if self._lineage is not None:
            if self._lineage_owned:
                self._lineage.close()
            else:
                self._lineage.flush()
        if leaked:
            raise RuntimeError('staging threads did not stop: {}'.format(leaked))

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False


def make_torch_loader(reader, batch_size, **kwargs):
    """``TorchLoader(reader, batch_size, **kwargs)`` (counterpart of
    ``make_jax_loader``, ``petastorm_tpu/jax_loader.py:2315``)."""
    return TorchLoader(reader, batch_size, **kwargs)


_BATCH_TYPES = {}


def _batch_type(names):
    if names not in _BATCH_TYPES:
        _BATCH_TYPES[names] = namedtuple('TorchBatch', names)
    return _BATCH_TYPES[names]
