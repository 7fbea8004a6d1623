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

Decode at the staging step (``petastorm_tpu/jax_loader.py:143-159, 838-908,
1745-1782``): a reader built with ``make_tensor_reader(raw_image_fields=...)``
delivers its image fields encoded. They ride batching as object columns of
bytes (reference slices, never collated into an arena) and the thread that
issues the batch's copies decodes them, by a hook registered with
:func:`register_device_decode` when there is one, else by one native batched
call a field, straight into the batch's pinned arena where the shapes allow.
``TorchLoader(on_device_augment=fn)`` then applies ``fn`` to each staged
device batch on the copy stream, before the batch's ready event is recorded.

Instruments (``petastorm_tpu/jax_loader.py:1069-1079``): each delivered
batch bumps ``pst_loader_batches_total`` and observes its blocked time in
``pst_batch_wait_seconds``; the staging step adds its host bytes to
``pst_staged_bytes_total``, and passes the ``device-put-delay`` fault site
first (``:1785-1786``). The staging engine and arena pool have theirs
(:mod:`~petastorm_tpu_torch.staging`).

Health and tracing (``petastorm_tpu/jax_loader.py:856-872, 1005-1037,
1210-1263, 1893-1910, 2174-2178``): ``tracer=`` records the ``stage`` span
(the copy issue, inside the engine's ``dispatch`` span), the engine's
``assemble`` span and the consumer's ``wait`` span; every span is host
time, and a ``stage`` span on the card covers the issue of asynchronous
copies, not the copies. ``watchdog=``/``stall_timeout_s=`` arm one
:class:`~petastorm_tpu_torch.health.HealthMonitor` for the whole pipeline:
the ``consumer`` heartbeat and probe, the reader's stages
(``Reader.attach_health``), the engine's ``assemble`` and ``dispatch``
heartbeats and ``staging`` probe, the ``arena-pool`` and ``memory``
probes; the watchdog starts once every stage registered. A hard stall is
delivered into the staging queue, so ``next`` raises the diagnosed
:class:`~petastorm_tpu_torch.errors.PipelineStallError`;
``stats['watchdog']`` holds the counts, the last diagnosis and the beats.

Autotune (``petastorm_tpu/jax_loader.py:1346-1483``): ``autotune=`` arms
one :class:`~petastorm_tpu_torch.autotune.AutoTuner` for the pipeline,
classified by :func:`~petastorm_tpu_torch.autotune.classify_loader`, over
the loader's knobs (with staging threads: ``prefetch``, ``inflight``,
``arena_depth``, ``arena_pinned``) and the reader's, which the loader
adopts (``Reader.adopt_autotune``, stopping the reader's own tuner). It
pauses while the watchdog has a stall episode open, biases every knob down
while the memory governor is at advisory or worse, and throttles a chunk
store's writer while it blames the pipeline; ``stats['autotune']`` holds
its log and trajectory. The JAX loader's ``device_inflight`` and
``device_stream_min_mb`` knobs turn its per-device stager, which the port
does not have: it runs one process a GPU, whose batch is one copy.

dtype table (the JAX package narrows 64-bit types; torch keeps them):
bool, uint8, int8, int16, int32, int64, float16, float32 and float64 keep
their type; uint16 widens to int32 and uint32 to int64 (values preserved);
datetime64 becomes int64 nanoseconds; uint64, strings and objects cannot
batch and are dropped with a warning (``strict_fields=True`` raises).
"""

import logging
import queue
import threading
import time
import warnings
from collections import deque

import numpy as np
import torch

from petastorm_tpu_torch import autotune as autotune_mod
from petastorm_tpu_torch import membudget, metrics
from petastorm_tpu_torch.device import resolve_device
from petastorm_tpu_torch.faults import maybe_inject
from petastorm_tpu_torch.health import PipelineSupervisor
from petastorm_tpu_torch.lineage import LineageTracker, lineage_enabled, resolve_ledger_dir
from petastorm_tpu_torch.parallel.mesh import (Sharding, axis_names, axis_size,
                                               batch_sharding, device_shard_plan, has_axis,
                                               local_device)
from petastorm_tpu_torch.shuffling_buffer import build_shuffling_buffer
from petastorm_tpu_torch.staging import (ArenaPool, DevicePutMeter, MeteredReader, OverlapMeter,
                                         StagingEngine)
from petastorm_tpu_torch.trace import NullTracer
from petastorm_tpu_torch.utils import cached_namedtuple

logger = logging.getLogger(__name__)

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
# the staging-step decode hook
# --------------------------------------------------------------------------

#: A registered image decode op (:func:`register_device_decode`), or None:
#: the staging step then decodes on the host with the native batched codec.
_DEVICE_DECODE_HOOK = None


def register_device_decode(fn):
    """Register ``fn(encoded_column, shape, dtype) -> [N, *shape] tensor`` as
    the staging step's image decode (``encoded_column``: an object ndarray
    of JPEG/PNG bytes; the result a tensor on the loader's device, or a host
    array or tensor, which is then copied like any field). A call that
    raises is logged and counted (``stats['stage_decode_hook_failures']``)
    and that batch is decoded on the host. ``None`` clears it. Returns the
    hook registered before. The port registers none: the JAX package ships
    no such op either (``petastorm_tpu/jax_loader.py:143-159``)."""
    global _DEVICE_DECODE_HOOK
    previous, _DEVICE_DECODE_HOOK = _DEVICE_DECODE_HOOK, fn
    return previous


def _raw_field_shapes(reader):
    """``{name: field shape}`` of the image fields ``reader`` ships encoded."""
    names = tuple(getattr(reader, 'raw_image_fields', ()) or ())
    return {name: tuple(reader.schema.fields[name].shape) for name in names}


# --------------------------------------------------------------------------
# host batch assembly
# --------------------------------------------------------------------------

def iter_numpy_batches(reader, batch_size, shape_policies=None, shuffling_queue_capacity=0,
                       min_after_dequeue=None, seed=None, last_batch='drop', strict_fields=False,
                       batch_buffers=None, views_ok=True, raw_fields=None):
    """Yield dicts of numpy arrays with leading dim ``batch_size``.

    Works over row readers (``make_reader``), tensor readers
    (``make_tensor_reader``) and batch readers (``make_batch_reader``: a
    list column's ``[rows, L]`` blocks batch as any block; an object column
    of ragged or null rows needs a shape policy, or raises). ``last_batch``: ``'drop'`` | ``'pad'``
    (repeat the last row into a full batch) | ``'partial'`` (yield it
    short). ``shuffling_queue_capacity > 0`` draws rows through a
    :class:`~petastorm_tpu_torch.shuffling_buffer.RandomShufflingBuffer`
    seeded with ``seed`` (floor ``min_after_dequeue``, default 4/5 of the
    capacity). ``strict_fields=True`` raises instead of warn-and-drop when a
    selected field cannot batch. ``batch_buffers``: a callable ``spec ->
    dict of arrays or None`` (``spec``: ``{name: (shape, dtype)}``) giving
    preallocated output buffers (the staging engine's arenas), which rows
    are stacked into in place; ``views_ok=False`` also collates batches that
    would be views of a chunk into those buffers. ``raw_fields``: ``{name:
    shape}`` of encoded image columns to pass through as object columns
    (default: the reader's ``raw_image_fields``); their batches stay
    encoded.
    """
    if raw_fields is None:
        raw_fields = _raw_field_shapes(reader)
    for batch, _ in _iter_batches(reader, batch_size, shape_policies, shuffling_queue_capacity,
                                  min_after_dequeue, seed, last_batch, strict_fields,
                                  batch_buffers, views_ok, raw_fields=raw_fields):
        yield batch


def _iter_batches(reader, batch_size, shape_policies=None, shuffling_queue_capacity=0,
                  min_after_dequeue=None, seed=None, last_batch='drop', strict_fields=False,
                  batch_buffers=None, views_ok=True, lineage=None, shuffler=None,
                  commit_rows=None, raw_fields=None):
    """:func:`iter_numpy_batches`, each batch paired with its count of
    source rows (a padded batch holds fewer than it has). ``lineage`` (a
    :class:`~petastorm_tpu_torch.lineage.LineageCollector`) gets each
    chunk's segment and each emitted batch, digested here on the assembled
    host batch; a shuffling buffer makes its records inexact. ``shuffler``:
    a prebuilt (possibly restored) shuffling buffer to use instead of one
    built from ``shuffling_queue_capacity``; ``commit_rows(rows)`` then
    adds each chunk's rows to it (the loader's checkpoint-atomic add).
    ``raw_fields``: ``{name: shape}`` of encoded image columns (block path
    only)."""
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
                                       strict_fields, batch_buffers, views_ok, lineage,
                                       raw_fields or {})
        return
    if raw_fields:
        raise ValueError(
            'raw image fields {} require the block fast path: a row-level shuffling buffer '
            '(shuffling_queue_capacity) re-rows encoded byte columns the staging-step decode '
            'cannot follow — shuffle with shuffle_row_groups/shuffle_rows_in_chunk '
            'instead'.format(sorted(raw_fields)))

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
                        batch_buffers, views_ok, lineage=None, raw_fields=None):
    """The block path of :func:`iter_numpy_batches`: fixed-size batches cut
    from a tensor reader's column blocks, with no per-row Python. A batch
    inside one chunk is a leading-dim view when ``views_ok`` and
    the chunk's blocks are writable; otherwise (and always for read-only
    blocks, which a cache shares across epochs) rows are collated into
    ``batch_buffers(spec)`` (a recycled arena) or a fresh buffer. Yields
    ``(batch, source rows)``.

    ``raw_fields`` (``{name: shape}``): encoded image columns, which pass
    through as object columns (slices of references, never sanitized or
    collated into an arena). The arena spec reserves a ``uint8`` buffer of
    each one's decoded shape, which the staging step decodes into."""
    raw_fields = dict(raw_fields or {})
    overlap = set(raw_fields) & set(shape_policies)
    if overlap:
        raise ValueError('shape policies on raw image fields {} are impossible: the column '
                         'holds encoded bytes until the staging-step decode'.format(
                             sorted(overlap)))
    field_names = None
    chunks = []   # dicts name -> sanitized block, oldest first
    have = 0

    def select(sample):
        names, dropped = [], []
        for name in sample._fields:
            if name in raw_fields:
                names.append(name)
                continue
            column = np.asarray(getattr(sample, name))
            probe = column[0] if (column.dtype.kind == 'O' and len(column)) else column
            # A field with a shape policy is kept even when its first row is
            # None: densify then refuses the None, as the JAX loader does.
            keep = ((probe is None and name in shape_policies)
                    or _batchable(probe, name, shape_policies))
            (names if keep else dropped).append(name)
        return _select_fields(names, dropped, strict_fields)

    def densify(name, block):
        """Apply the field's shape policy row by row, and stack an object
        column of per-row arrays (a batch reader's ragged or nullable list
        column) into a block: a ``None`` row or ragged rows without a
        policy raise, as in ``petastorm_tpu/jax_loader.py:469-490``."""
        block = np.asarray(block)
        if name not in shape_policies and block.dtype.kind != 'O':
            return block
        return _stack_column(list(block), name, shape_policies)

    def out_buffers(n, head):
        spec = {name: ((n,) + (raw_fields[name] if name in raw_fields else head[name].shape[1:]),
                       np.dtype(np.uint8) if name in raw_fields else head[name].dtype)
                for name in field_names}
        out = batch_buffers(spec) if batch_buffers is not None else None
        if out is None:
            out = {name: np.empty(shape, dtype) for name, (shape, dtype) in spec.items()
                   if name not in raw_fields}
        else:
            out = dict(out)     # the raw fields' arena buffers stay reserved for the decode
        for name in raw_fields:
            if name in field_names:
                out[name] = np.empty(n, dtype=object)
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
            if name in raw_fields:
                chunk[name] = np.asarray(getattr(sample, name))
                continue
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
    :param on_device_augment: the staging-step path
        (``petastorm_tpu/jax_loader.py:838-850``): a callable
        ``dict of tensors -> dict of tensors`` applied to every staged
        batch on the device (on the copy stream, before the batch is ready),
        or ``True`` for the staging-step decode without an augment. With a
        reader of ``raw_image_fields`` the thread that stages a batch
        decodes its encoded images: through the hook of
        :func:`register_device_decode` when one is registered, else by one
        native batched call a field with the whole decode-thread budget
        (when the raw fields are every image field of the reader, so its
        workers decode none) or a fair share of it. The raw fields need the
        block path: a shuffling buffer or a shape policy on one raises.
        ``stats['stage_decode_s']`` sums the decode's seconds.
    :param tracer: a :class:`~petastorm_tpu_torch.trace.Tracer` for the
        ``assemble``, ``dispatch``, ``stage`` and ``wait`` spans (host time)
        and the staging counters.
    :param watchdog: ``True`` arms the pipeline's health watchdog, ``False``
        keeps it off, ``None`` defers to ``PSTT_WATCHDOG`` (off by default).
    :param stall_timeout_s: the stages' stall deadline in seconds (a number,
        or a dict stage -> seconds with an optional ``'default'``); a stall
        past twice its deadline raises ``PipelineStallError`` from ``next``
        (a consumer that stops draining is only recorded).
    :param autotune: ``True`` or an :class:`~petastorm_tpu_torch.autotune.
        AutotuneConfig` arms the pipeline's autotuner (see the module
        docstring), ``False`` keeps it off, ``None`` defers to
        ``PSTT_AUTOTUNE`` (off by default).

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
                 lineage=None, resume_state=None, mesh=None, sharding=None, batch_axis='data',
                 on_device_augment=None, tracer=None, watchdog=None, stall_timeout_s=None,
                 autotune=None):
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
        self._init_staging_decode(reader, shuffling_queue_capacity, on_device_augment)
        self._init_resume(reader, shuffling_queue_capacity, min_after_dequeue, seed,
                          resume_state)
        self._init_lineage(reader, lineage, batch_size, last_batch, shape_policies,
                           shuffling_queue_capacity)
        self._prefetch = int(prefetch)
        # The staging queue's live bound (the autotuner's prefetch knob).
        self._prefetch_target = max(1, self._prefetch)
        self._inflight = int(inflight)
        self._echo = int(echo)
        self._echo_left = 0
        self._echo_item = None
        self._stop = threading.Event()
        self._h2d_stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._closed = False
        self._exhausted = False
        self._tracer = tracer if tracer is not None else NullTracer()
        self._stats_lock = threading.Lock()
        self._reset_counters()
        self._m_batches = metrics.counter(
            'pst_loader_batches_total', 'Device batches delivered to the '
            'training loop (echoed re-deliveries included)')
        self._m_batch_wait = metrics.histogram(
            'pst_batch_wait_seconds', 'Consumer-side blocked time per '
            'fetch (the input-stall signal; includes the end-of-stream '
            'fetch)')
        self._m_staged_bytes = metrics.counter(
            'pst_staged_bytes_total', 'Host bytes handed to device staging')
        # Arenas: those behind queued batches, in-flight copies, and the two
        # being filled and consumed.
        self._arena_depth = (int(arena_depth) if arena_depth is not None
                             else max(2, self._prefetch) + self._inflight + 2)
        self._queue = queue.Queue(maxsize=self._prefetch) if self._prefetch else None
        self._init_health(reader, watchdog, stall_timeout_s)
        registry = self._health.registry if self._health is not None else None
        hb_assemble = registry.register('assemble') if registry is not None else None
        self._pool = ArenaPool(self._arena_depth, self._stop, pinned=self._cuda,
                               tracer=self._tracer, heartbeat=hb_assemble)
        if registry is not None:
            registry.register_probe('arena-pool', self._pool.stats)
        if self._echo > 1:
            self._pool.ensure_depth(self._arena_depth + 1)   # the echoed batch's arena
        self._meter = OverlapMeter()
        self._metered = (MeteredReader(reader, self._meter, heartbeat=hb_assemble)
                         if self._prefetch else None)
        # Copying device (CUDA): every batch goes through a pinned arena.
        # Aliasing device (CPU): views of the reader's blocks are cheapest,
        # except of read-only (cached) blocks, which are copied.
        self._host_iter = _iter_batches(
            self._metered or reader, batch_size, shape_policies, shuffling_queue_capacity,
            min_after_dequeue, seed, last_batch, strict_fields,
            batch_buffers=self._pool.get_buffers, views_ok=not self._cuda,
            lineage=self._lineage.collector if self._lineage is not None else None,
            shuffler=self._shuffler,
            commit_rows=self._commit_rows if self._shuffler is not None else None,
            raw_fields={name: tuple(field.shape) for name, field in self._raw_specs.items()})
        self._engine = None
        self._inline = deque()    # prefetch=0: (staged, arena) whose copies may be in flight
        if self._prefetch:
            self._engine = StagingEngine(
                self._host_iter, self._stage, self._queue, self._stop, _END, self._pool,
                ready_fn=self._wait_copied, holds_mode=not self._cuda,
                inflight=self._inflight, meter=self._meter, tracer=self._tracer,
                health=registry).start()
        # The watchdog starts once every stage registered its heartbeat.
        self._supervisor.start_health()
        #: A DeviceDatasetCache over this loader attaches itself here.
        self._device_cache = None
        self._register_memory_pools(reader)
        self._init_autotune(reader, autotune)

    def _init_autotune(self, reader, autotune):
        """One controller for the pipeline (``petastorm_tpu/jax_loader.py:
        1346-1423``): the loader's knobs and the reader's, adopted."""
        self._reader_telemetry = None
        self._arena_knob = None

        def build_knobs(config):
            knobs = {}
            if self._engine is not None:
                engine, pool = self._engine, self._pool
                knobs['prefetch'] = autotune_mod.Knob(
                    'prefetch', lambda: self._prefetch_target, self.set_prefetch,
                    lo=config.min_prefetch, hi=config.max_prefetch)
                knobs['inflight'] = autotune_mod.Knob(
                    'inflight', lambda: engine.inflight_window, engine.set_inflight,
                    lo=config.min_inflight, hi=config.max_inflight)
                self._arena_knob = knobs['arena_depth'] = autotune_mod.Knob(
                    'arena_depth', lambda: pool.depth, pool.set_depth,
                    lo=max(config.min_arena_depth, pool.floor),
                    hi=max(config.max_arena_depth, pool.floor))
                # Host memory cannot be pinned without CUDA, so on the CPU
                # the knob stays at 0. On the card it stays at 1: a copy
                # from an unpinned arena is synchronous and queues behind
                # the graph replay, so the consumer-bound shrink that every
                # graph capture triggers cost phase 26 of chip_smoke.py up
                # to a third of its rate (PERF.md §6). The memory governor's
                # advisory rung still unpins the arenas under pressure.
                knobs['arena_pinned'] = autotune_mod.Knob(
                    'arena_pinned', lambda: int(pool.pinned),
                    lambda v: pool.set_pinned(bool(v)), lo=1 if self._cuda else 0,
                    hi=1 if self._cuda else 0)
            adopt = getattr(reader, 'adopt_autotune', None)
            if adopt is not None:
                reader_knobs, self._reader_telemetry = adopt(config)
                knobs.update(reader_knobs)
            return knobs

        watchdog_active = None
        if self._health is not None:
            watchdog = self._health.watchdog
            watchdog_active = lambda: watchdog.episode_active  # noqa: E731
        listeners = []
        store = getattr(reader, 'chunk_store', None)
        if store is not None:
            listeners.append(autotune_mod.writer_throttle_listener(store))
        self._autotuner = self._supervisor.arm_autotune(
            autotune, build_knobs, self._autotune_telemetry, autotune_mod.classify_loader,
            watchdog_active_fn=watchdog_active,
            memory_state_fn=membudget.get_governor().pressure_level, tracer=self._tracer,
            listeners=listeners)

    def set_prefetch(self, n):
        """Retarget the staging queue's bound while the loader runs (the
        autotuner's ``prefetch`` knob): a raise wakes a dispatch thread
        blocked on the full queue; a cut takes effect as the consumer drains
        (no staged batch is dropped). Without staging threads there is no
        queue and nothing changes."""
        n = max(1, int(n))
        self._prefetch_target = n
        if self._queue is not None:
            with self._queue.mutex:
                self._queue.maxsize = n
                self._queue.not_full.notify_all()

    def _autotune_telemetry(self):
        """The inputs of :func:`~petastorm_tpu_torch.autotune.classify_loader`
        (``petastorm_tpu/jax_loader.py:1447-1483``): delivered batches and
        the consumer's wait (counters), the staging queue's depth and
        capacity, the waits on the reader, on an arena and on a copy
        (counters; with ``prefetch=0`` the inline split of the consumer's
        own staging; a copy from pageable memory counts as a wait on the
        copy), and the reader's gauges. Under :meth:`superbatches` also the
        delivered count and the time at the end of the last take
        (``take_batches``, ``take_t``)."""
        out = {'batches': self._batches, 'wait_s': self._wait_s,
               'queue_depth': self._queue.qsize() if self._queue is not None else 0,
               'queue_capacity': self._prefetch_target,
               'arena_wait_s': self._pool.wait_seconds}
        if self._engine is not None:
            out['reader_wait_s'] = self._metered.reader_wait_s
            # A copy from pageable memory waits inside the issue, not at the
            # event the engine waits on: both are the wait on the transfer.
            out['ready_wait_s'] = self._engine.ready_wait_seconds + self._pageable_copy_s
        else:
            out['reader_wait_s'] = self._inline_reader_s
            out['ready_wait_s'] = self._inline_dispatch_s
        take = self._take
        if take is not None:
            out['take_batches'], out['take_t'] = take
        if self._reader_telemetry is not None:
            reader_out = self._reader_telemetry()
            # The rate the guard judges is the loader's delivered batches.
            reader_out.pop('batches', None)
            out.update(reader_out)
        return out

    def _init_health(self, reader, watchdog, stall_timeout_s):
        """The pipeline's health monitor, armed with its start deferred: the
        consumer's heartbeat and probe, the reader's stages and the memory
        probe are registered here, the staging stages after."""
        self._supervisor = PipelineSupervisor()
        self._hb_consumer = None
        self._stall_error = None

        def attach_stages(registry):
            self._hb_consumer = registry.register('consumer')
            registry.register_probe('consumer', lambda: {
                'queue_depth': self._queue.qsize() if self._queue is not None else 0,
                'queue_capacity': self._prefetch_target, 'exhausted': self._exhausted})
            attach = getattr(reader, 'attach_health', None)
            if attach is not None:
                attach(registry)
            registry.register_probe('memory', membudget.get_governor().probe)

        self._health = self._supervisor.arm_health(watchdog, stall_timeout_s, self._deliver_stall,
                                                   tracer=self._tracer, attach_fn=attach_stages,
                                                   start=False)

    def _deliver_stall(self, error):
        """The watchdog's hard-stall sink (its thread): the error rides the
        staging queue, where the consumer waits; a full queue (a consumer
        that stopped draining) gives up its oldest batch for it. With
        ``prefetch=0`` it is raised at the next ``next``."""
        self._stall_error = error
        if self._queue is None:
            return
        for _ in range(2):
            try:
                self._queue.put_nowait(error)
                return
            except queue.Full:
                try:
                    self._queue.get_nowait()
                except queue.Empty:
                    pass
        logger.error('could not deliver PipelineStallError into the staging queue; it will '
                     'surface on the next __next__ call')

    def _init_staging_decode(self, reader, shuffling_queue_capacity, on_device_augment):
        """The raw image fields the staging step decodes and the augment it
        applies (``petastorm_tpu/jax_loader.py:880-908``)."""
        from petastorm_tpu_torch.codecs import CompressedImageCodec
        raw_fields = tuple(getattr(reader, 'raw_image_fields', ()) or ())
        self._raw_specs = {}
        self._staging_owns_budget = False
        if raw_fields:
            if shuffling_queue_capacity:
                raise ValueError(
                    'raw image fields {} require the block fast path; a row-level shuffling '
                    'buffer cannot carry encoded byte columns — shuffle with '
                    'shuffle_row_groups/shuffle_rows_in_chunk instead'.format(sorted(raw_fields)))
            self._raw_specs = {name: reader.schema.fields[name] for name in raw_fields}
            image_fields = {n for n, f in reader.schema.fields.items()
                            if isinstance(f.resolved_codec(), CompressedImageCodec)}
            # Every image field raw: the workers decode none, and the staging
            # thread may take the whole budget.
            self._staging_owns_budget = set(raw_fields) >= image_fields
        self._augment_fn = on_device_augment if callable(on_device_augment) else None

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
            # The end of the consumer's last take of a superbatch: the
            # delivered count and the time (the autotuner's guard on takes).
            self._take = None
            self._rows = 0
            self._wait_s = 0.0
            self._first_get_t = None
            self._stage_s = 0.0
            self._h2d_bytes = 0
            self._h2d_s = 0.0
            self._stage_decode_s = 0.0
            self._stage_decode_threads = None
            self._hook_failures = 0
            # prefetch=0: the consumer's own reader pull and copy issue.
            self._inline_reader_s = 0.0
            self._inline_dispatch_s = 0.0
            # Seconds the copies from pageable memory held the staging thread.
            self._pageable_copy_s = 0.0

    # -- staging -------------------------------------------------------------

    def _decode_raw_columns(self, batch, arena):
        """The staging-step decode (``petastorm_tpu/jax_loader.py:1745-
        1782``): each encoded column through the registered hook, or else by
        one native batched call into the arena's buffer for the field (a
        fresh block when the batch has none of its shape)."""
        from petastorm_tpu_torch import decode_budget
        from petastorm_tpu_torch.codecs import decode_image_batch_into
        budget = decode_budget.get_budget()
        decode_threads = budget.total if self._staging_owns_budget else budget.share()
        self._stage_decode_threads = decode_threads
        out = dict(batch)
        t0 = time.perf_counter()
        for name, field in self._raw_specs.items():
            column = out.get(name)
            if column is None or getattr(column, 'dtype', None) != np.dtype(object):
                continue      # already dense (a cache tier held decoded blocks)
            hook = _DEVICE_DECODE_HOOK
            if hook is not None:
                try:
                    out[name] = hook(column, tuple(field.shape), np.dtype(field.numpy_dtype))
                    continue
                except Exception:  # noqa: BLE001 - counted, and the batch decodes on the host
                    logger.warning('the registered decode hook failed for field %r; decoding '
                                   'this batch on the host', name, exc_info=True)
                    with self._stats_lock:
                        self._hook_failures += 1
            shape = (len(column),) + tuple(field.shape)
            block = arena.buffers.get(name) if arena is not None else None
            if block is None or block.shape != shape or block.dtype != field.numpy_dtype:
                block = np.empty(shape, dtype=field.numpy_dtype)
            decode_image_batch_into(field, block, lambda i, _c=column: _c[i],
                                    decode_threads=decode_threads)
            out[name] = block
        with self._stats_lock:
            self._stage_decode_s += time.perf_counter() - t0
        return out

    def _source(self, arr, arena, name):
        """The copy source of one field: the arena's pinned tensor where the
        field lies in it, a tensor as it is, else a tensor over the array."""
        if torch.is_tensor(arr):
            return arr
        if self._cuda and arena is not None and arena.owns(name, arr):
            return arena.tensors[name]
        return torch.from_numpy(arr)

    def _stage(self, item, arena):
        maybe_inject('device-put-delay')
        with self._tracer.span('stage', 'device'):
            return self._stage_traced(item, arena)

    def _stage_traced(self, item, arena):
        batch, rows = item
        t0 = time.perf_counter()
        if self._raw_specs:
            batch = self._decode_raw_columns(batch, arena)
        # The copy source is the arena's pinned tensor where the field was
        # collated into it; else the array itself (a view, or rows that
        # needed a conversion). On the CPU every batch gets tensors of its
        # own: their lifetime is the hold that returns the arena.
        sources = {name: self._source(arr, arena, name) for name, arr in batch.items()}
        cuts = {}
        if self._shardings is not None:
            for name, src in sources.items():
                per_device, cuts[name] = self._field_cut(name, tuple(src.shape))
                if per_device:
                    self._put_meter.issued()
        if not self._cuda:
            self._loose_batch_nbytes = sum(
                arr.nbytes for name, arr in batch.items()
                if arena is None or not arena.owns(name, arr))
            tensors = {name: src if cuts.get(name) is None else src[cuts[name]].contiguous()
                       for name, src in sources.items()}
            if self._augment_fn is not None:
                tensors = dict(self._augment_fn(tensors))
            staged = _Staged(tensors, rows, nbytes=sum(t.nbytes for t in tensors.values()))
            if self._put_meter is not None:
                self._put_meter.completed(self.device, time.perf_counter() - t0, staged.nbytes)
        else:
            if any(src.device.type == 'cuda' for src in sources.values()):
                # A decode hook's output: the copies follow its kernels.
                self._h2d_stream.wait_stream(torch.cuda.current_stream(self.device))
            pinned = {} if arena is None or not arena.pinned else arena.tensors
            with torch.cuda.stream(self._h2d_stream):
                start = torch.cuda.Event(enable_timing=True)
                start.record(self._h2d_stream)
                tensors = {}
                for name, src in sources.items():
                    if src.device == self.device:
                        dst = src
                    elif src is pinned.get(name):
                        dst = torch.empty(src.shape, dtype=src.dtype, device=self.device)
                        dst.copy_(src, non_blocking=True)
                    else:
                        # From pageable memory the copy runs before the call
                        # returns: the wait on the transfer that a pinned
                        # source spends at its event.
                        dst = torch.empty(src.shape, dtype=src.dtype, device=self.device)
                        t_copy = time.perf_counter()
                        dst.copy_(src, non_blocking=True)
                        self._pageable_copy_s += time.perf_counter() - t_copy
                    if cuts.get(name) is not None:
                        dst = dst[cuts[name]].contiguous()
                    tensors[name] = dst
                if self._augment_fn is not None:
                    tensors = dict(self._augment_fn(tensors))
                event = torch.cuda.Event(enable_timing=True)
                event.record(self._h2d_stream)
            staged = _Staged(tensors, rows, event, start, sum(t.nbytes for t in tensors.values()))
        with self._stats_lock:
            self._stage_s += time.perf_counter() - t0
        self._m_staged_bytes.inc(staged.nbytes)
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
        hb = self._hb_consumer
        if hb is not None:
            hb.beat('reader-wait')
        t0 = time.perf_counter()
        try:
            with self._tracer.span('assemble', 'host'):
                item = next(self._host_iter)
        except StopIteration:
            return _END
        t1 = time.perf_counter()
        self._inline_reader_s += t1 - t0
        arena = self._pool.claim_pending()
        if hb is not None:
            hb.beat('device_put')
        staged = self._stage(item, arena)
        self._inline_dispatch_s += time.perf_counter() - t1
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
        self._m_batches.inc()
        if fresh:
            self._rows += staged.rows
            if self._lineage is not None:
                self._last_provenance = self._lineage.deliver()
            self._account_delivery()
        if self._hb_consumer is not None:
            # Stale in 'delivered': the training loop took the batch and has
            # not come back (consumer-not-draining, never escalated).
            self._hb_consumer.beat('delivered')
        # A delivered batch is recovery: a hard stall diagnosed meanwhile
        # must not end a pipeline that came back.
        self._stall_error = None
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
        if self._stall_error is not None and self._queue is None:
            # Inline staging: the watchdog's diagnosis surfaces here.
            self._exhausted = True
            error, self._stall_error = self._stall_error, None
            raise error
        if self._hb_consumer is not None:
            self._hb_consumer.beat('queue-wait')
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
            with self._tracer.span('wait', 'consumer'):
                item = self._get_staged()
        waited = time.perf_counter() - t0
        self._wait_s += waited
        self._m_batch_wait.observe(waited)
        if item is _END:
            self._exhausted = True
            self._echo_item = None
            if self._hb_consumer is not None:
                self._hb_consumer.beat('idle')    # exhausted, not stalled
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
            knob = self._arena_knob
            if knob is not None:
                # The tuner's floor follows the pool's.
                knob.lo = max(knob.lo, self._pool.floor)
                knob.hi = max(knob.hi, knob.lo)

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
            self._take = (self._batches, time.monotonic())
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
        copies, ``pageable_copy_s`` of it in copies from pageable memory
        (unpinned arenas: such a copy completes before its call returns);
        ``h2d_bytes``/``h2d_s`` of the completed copies; the
        staging engine's ``assemble_s``, ``dispatch_s``, ``overlap_s``,
        ``overlap_frac``, ``ready_wait_s`` (``prefetch >= 1``); the arena
        pool's ``arena_alloc``, ``arena_reuse``, ``arena_wait_s``;
        ``reader_wait_s``; the reader's ``worker_stage_timings``;
        ``stage_decode_s`` (seconds of the staging-step decode),
        ``stage_decode_threads`` (the C++ or OpenCV threads of its latest
        call) and ``stage_decode_hook_failures`` (batches a registered decode hook
        failed, decoded on the host instead); ``decoder`` (the reader's
        :attr:`~petastorm_tpu_torch.reader.Reader.decoder`);
        ``lineage`` (records, dropped, pending, ring, ledger path and lag)
        when armed; ``chunk_store`` (the reader's store's counters) with a
        chunk store; ``device_cache`` with a ``DeviceDatasetCache`` over the
        loader; ``mem`` (the governor's stats) while the governor is
        armed; on a mesh ``n_devices`` (1: a rank copies to its own
        device), ``shards_put`` and, by device,
        ``device_put_s`` and ``device_put_bytes``; ``watchdog`` (stall episodes,
        soft recoveries, hard stalls, the last diagnosis without its stacks,
        ``alive``, the flight dumps and the beat table) when armed;
        ``autotune`` (the tuner's ``stats()``: ticks, paused ticks, reverts,
        mem-shrinks, the last class, the knobs, the decision log and the
        trajectory) when armed."""
        elapsed = (time.perf_counter() - self._first_get_t
                   if self._first_get_t is not None else 0.0)
        with self._stats_lock:
            out = {'batches': self._batches, 'rows': self._rows, 'wait_s': self._wait_s,
                   'input_stall_frac': self._wait_s / elapsed if elapsed else 0.0,
                   'stage_dispatch_s': self._stage_s, 'h2d_bytes': self._h2d_bytes,
                   'h2d_s': self._h2d_s, 'stage_decode_s': self._stage_decode_s,
                   'stage_decode_threads': self._stage_decode_threads,
                   'stage_decode_hook_failures': self._hook_failures,
                   'pageable_copy_s': self._pageable_copy_s}
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
        decoder = getattr(self._reader, 'decoder', None)
        if decoder is not None:
            out['decoder'] = decoder
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
        if self._health is not None:
            out['watchdog'] = self._health.stats()
        if self._autotuner is not None:
            out['autotune'] = self._autotuner.stats()
        return out

    def close(self):
        """Stop and join the staging threads, and close an owned lineage
        ledger (an adopted one is flushed) (idempotent)."""
        if self._closed:
            return
        self._closed = True
        # The tuner and the watchdog first: one would resize stages being
        # stopped, the other read their deliberate quiet as a stall.
        # ``_health`` and ``_autotuner`` stay referenced for ``stats``.
        self._supervisor.stop()
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
    return cached_namedtuple(_BATCH_TYPES, 'TorchBatch', names)
