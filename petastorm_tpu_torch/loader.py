"""``TorchLoader``: fixed-size device batches off a tensor reader.

Counterpart of ``petastorm_tpu/jax_loader.py`` (``JaxLoader`` at ``:705``,
the block fast path ``_iter_block_batches`` at ``:431`` and the dtype table
at ``:106-136``), single device.

Path of a batch on CUDA: the reader's decoded row-group blocks are cut into
``batch_size`` rows and collated into a recycled pinned host arena (assemble
thread); the dispatch thread issues ``dst.copy_(pinned_src,
non_blocking=True)`` on a dedicated CUDA stream and records an event behind
the copies; the consumer stream ``wait_event``s before it hands the batch
out, and ``record_stream`` keeps the caching allocator from reusing the
memory while the consumer's kernels still read it. The arena is recycled
only after its event completed.

dtype table (the JAX package narrows 64-bit types; torch keeps them):
bool, uint8, int8, int16, int32, int64, float16, float32 and float64 keep
their type; uint16 widens to int32 and uint32 to int64 (values preserved);
datetime64 becomes int64 nanoseconds; uint64, strings and objects cannot
batch and are dropped with a warning. A last partial batch is dropped.
"""

import queue
import threading
import time
import warnings
from collections import namedtuple

import numpy as np
import torch

from petastorm_tpu_torch.device import resolve_device
from petastorm_tpu_torch.staging import INFLIGHT, ArenaPool, StagingEngine

_WIDEN = {np.dtype('uint16'): np.dtype('int32'), np.dtype('uint32'): np.dtype('int64')}
_KEEP = frozenset(np.dtype(t) for t in ('bool', 'uint8', 'int8', 'int16', 'int32', 'int64',
                                        'float16', 'float32', 'float64'))


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


def iter_block_batches(reader, batch_size, batch_buffers=None, views_ok=True):
    """Fixed-size batches (dicts of numpy arrays) cut from column blocks.

    A batch inside one chunk is a leading-dim view when ``views_ok`` and
    the chunk's blocks are writable; otherwise (and always for read-only
    blocks, which a cache shares across epochs) rows are collated into
    ``batch_buffers(spec)`` (a recycled arena) or a fresh buffer. A last
    partial batch is dropped.
    """
    field_names = None
    chunks = []   # dicts name -> sanitized block, oldest first
    have = 0

    def select(sample):
        names, dropped = [], []
        for name in sample._fields:
            (names if sanitize_dtype(np.asarray(getattr(sample, name)).dtype) is not None
             else dropped).append(name)
        if dropped:
            warnings.warn('torch loader dropping non-tensor fields: {}'.format(sorted(dropped)))
        if not names:
            raise ValueError('No batchable fields left (all dropped: {})'.format(sorted(dropped)))
        return names

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
        spec = {name: ((n,) + head[name].shape[1:], head[name].dtype) for name in field_names}
        out = batch_buffers(spec) if batch_buffers is not None else None
        if out is None:
            out = {name: np.empty(shape, dtype) for name, (shape, dtype) in spec.items()}
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
        chunks.append({name: _sanitize_array(getattr(sample, name)) for name in field_names})
        have += len(chunks[-1][field_names[0]])
        while have >= batch_size:
            yield take(batch_size)


class _Staged(object):
    """Device tensors of one batch plus the event recorded behind their copies."""

    __slots__ = ('tensors', 'event', 'start', 'nbytes')

    def __init__(self, tensors, event=None, start=None, nbytes=0):
        self.tensors = tensors
        self.event = event
        self.start = start
        self.nbytes = nbytes


_END = object()


class TorchLoader(object):
    """Iterates namedtuples (``TorchBatch``, fields sorted by name) of
    device tensors off a tensor reader.

    :param reader: a ``make_tensor_reader`` Reader. The loader does not own
        it: stop the reader yourself.
    :param batch_size: rows per batch.
    :param device: ``'cuda'`` (default; raises without a GPU) or ``'cpu'``.
    :param prefetch: staged batches kept ahead of the consumer (>= 1); the
        staging engine's assemble and dispatch threads fill them.
    """

    def __init__(self, reader, batch_size, device='cuda', prefetch=2):
        if batch_size < 1:
            raise ValueError('batch_size must be >= 1, got {}'.format(batch_size))
        if prefetch < 1:
            raise ValueError('prefetch must be >= 1, got {}'.format(prefetch))
        self.device = resolve_device(device)
        self._cuda = self.device.type == 'cuda'
        self._prefetch = int(prefetch)
        self._stop = threading.Event()
        self._h2d_stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._closed = False
        self._exhausted = False
        self.stats = {'batches': 0, 'rows': 0, 'wait_s': 0.0, 'h2d_bytes': 0, 'h2d_s': 0.0}
        # Arenas: those behind queued batches, in-flight copies, and the two
        # being filled and consumed.
        self._arena_depth = max(2, self._prefetch) + INFLIGHT + 2
        self._pool = ArenaPool(self._arena_depth, self._stop, pinned=self._cuda)
        # Copying device (CUDA): every batch goes through a pinned arena.
        # Aliasing device (CPU): views of the reader's blocks are cheapest,
        # except of read-only (cached) blocks, which are copied.
        self._host_iter = iter_block_batches(reader, batch_size, batch_buffers=self._pool.get_buffers,
                                             views_ok=not self._cuda)
        self._queue = queue.Queue(maxsize=self._prefetch)
        self._engine = StagingEngine(
            self._host_iter, self._stage, self._queue, self._stop, _END, self._pool,
            ready_fn=self._wait_copied, holds_mode=not self._cuda).start()

    # -- staging -------------------------------------------------------------

    def _stage(self, batch, arena):
        sources = {name: (arena.tensors[name] if arena is not None else torch.from_numpy(arr))
                   for name, arr in batch.items()}
        if not self._cuda:
            return _Staged(sources)
        with torch.cuda.stream(self._h2d_stream):
            start = torch.cuda.Event(enable_timing=True)
            start.record(self._h2d_stream)
            tensors = {}
            for name, src in sources.items():
                dst = torch.empty(src.shape, dtype=src.dtype, device=self.device)
                dst.copy_(src, non_blocking=True)
                tensors[name] = dst
            event = torch.cuda.Event(enable_timing=True)
            event.record(self._h2d_stream)
        return _Staged(tensors, event, start, sum(t.nbytes for t in tensors.values()))

    def _wait_copied(self, staged):
        """Block until the batch's copies landed; account the H2D time."""
        if staged.event is not None:
            staged.event.synchronize()
            self.stats['h2d_s'] += staged.start.elapsed_time(staged.event) / 1e3
            self.stats['h2d_bytes'] += staged.nbytes

    def _deliver(self, staged):
        tensors = staged.tensors
        if self._cuda:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(staged.event)
            for t in tensors.values():
                t.record_stream(consumer)
        names = tuple(sorted(tensors))
        self.stats['batches'] += 1
        self.stats['rows'] += len(tensors[names[0]])
        return _batch_type(names)(**tensors)

    # -- iteration -----------------------------------------------------------

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed:
            raise RuntimeError('Trying to iterate a closed TorchLoader')
        if self._exhausted:
            raise StopIteration
        t0 = time.perf_counter()
        item = self._queue.get()
        self.stats['wait_s'] += time.perf_counter() - t0
        if item is _END:
            self._exhausted = True
            raise StopIteration
        if isinstance(item, Exception):
            self._exhausted = True
            raise item
        return self._deliver(item)

    def hold_batches(self, n):
        """Say that the consumer keeps up to ``n`` delivered batches alive
        at once. On the CPU a delivered batch may hold its host arena, so
        the arena pool is deepened to cover them (else each batch past the
        pool's depth waits for the pool to grow); on CUDA an arena is free
        once its copy landed, and nothing changes."""
        if not self._cuda:
            self._pool.ensure_depth(self._arena_depth + n)

    def superbatches(self, k):
        """Yield batches of ``k * batch_size`` rows: ``k`` consecutive
        batches concatenated on the device (``torch.cat`` on the consumer
        stream), for :func:`~petastorm_tpu_torch.models.train.make_scan_train_step`
        with ``microbatches=k``. Copies stay at the batch's size. A last
        group of fewer than ``k`` batches is dropped, so every superbatch
        has one shape. ``k <= 1`` yields the batches as they are.

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
                    parts.append(next(self))
            except StopIteration:
                return
            batch = type(parts[0])(*(torch.cat(columns) for columns in zip(*parts)))
            del parts          # the parts (and on the CPU their arenas) go before the yield
            yield batch

    def close(self):
        """Stop and join the staging threads (idempotent)."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        while True:   # unblock a dispatch thread parked on a full queue
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        leaked = self._engine.stop()
        if leaked:
            raise RuntimeError('staging threads did not stop: {}'.format(leaked))

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False


_BATCH_TYPES = {}


def _batch_type(names):
    if names not in _BATCH_TYPES:
        _BATCH_TYPES[names] = namedtuple('TorchBatch', names)
    return _BATCH_TYPES[names]
