"""Host staging: recycled (pinned) batch arenas and the assemble/dispatch
engine that overlaps batch collate with host-to-device copies.

Counterpart of ``petastorm_tpu/staging.py:149-600`` (``HostArena``,
``ArenaPool``), ``:600-745`` (``OverlapMeter``, ``MeteredReader``) and
``:1156-`` (``StagingEngine``), trimmed: no sharded layouts, sanitizer,
health beats, metrics or autotune hooks.

On CUDA an arena's buffers are ``torch.empty(..., pin_memory=True)``
tensors, viewed as numpy for the collate; the dispatch stage copies them
to the card with ``non_blocking=True`` and an arena is recycled only after
the CUDA event recorded behind its copy completed (the JAX package's
``block_until_ready`` contract, ``staging.py:1171-1173``). On the CPU the
staged tensors alias the arena (``torch.from_numpy``), so an arena returns
to the pool only once the consumer dropped every such tensor
(``holds_mode``, the GC-hold rule of ``staging.py:88``).
"""

import queue
import threading
import time
import weakref
from collections import deque
from contextlib import contextmanager

import numpy as np
import torch

THREAD_PREFIX = 'pstt-staging-'
_GROW_TIMEOUT_S = 0.5


def torch_dtype(np_dtype):
    """The torch dtype that shares ``np_dtype``'s memory layout."""
    return torch.from_numpy(np.empty(0, dtype=np_dtype)).dtype


class HostArena(object):
    """One batch's worth of recyclable per-field host buffers.

    ``buffers`` are numpy views (the collate target); ``tensors`` are the
    torch tensors over the same memory (the copy source).
    """

    def __init__(self, pool, spec, pinned):
        self.tensors, self.buffers = {}, {}
        for name, (shape, dtype) in spec.items():
            if pinned:
                t = torch.empty(shape, dtype=torch_dtype(dtype), pin_memory=True)
                self.buffers[name] = t.numpy()
            else:
                self.buffers[name] = np.empty(shape, dtype)
                t = torch.from_numpy(self.buffers[name])
            self.tensors[name] = t
        self._pool = pool
        self._lock = threading.Lock()
        self._holds = 0
        self._retired = False
        self._reclaimed = False

    def add_hold(self, obj):
        """Keep the arena out of the free list until ``obj`` is collected."""
        with self._lock:
            self._holds += 1
        weakref.finalize(obj, self._drop_hold)

    def _drop_hold(self):
        with self._lock:
            self._holds -= 1
            ready = self._retired and self._holds == 0 and not self._reclaimed
            if ready:
                self._retired = False
                self._reclaimed = True
        if ready:
            self._pool._reclaim(self)

    def retire(self):
        """The transfer is done: back to the pool once no holds remain.
        Idempotent."""
        with self._lock:
            if self._reclaimed:
                return
            if self._holds:
                self._retired = True
                return
            self._reclaimed = True
        self._pool._reclaim(self)


class ArenaPool(object):
    """Bounded pool of :class:`HostArena`. ``get_buffers`` blocks (stop-
    aware) while every arena is out and grows past ``depth`` after
    ``_GROW_TIMEOUT_S`` rather than deadlocking a consumer that holds many
    batches. Specs other than the pool's first get ``None``: the caller
    then allocates plainly."""

    def __init__(self, depth, stop_event, pinned):
        if depth < 1:
            raise ValueError('ArenaPool depth must be >= 1, got {}'.format(depth))
        self._depth = depth
        self._stop = stop_event
        self._pinned = pinned
        self._cond = threading.Condition()
        self._free = []
        self._spec = None
        self._allocated = 0
        self._pending = None
        self._alloc = 0       # arenas allocated (the window's count)
        self._reuse = 0       # requests served from the free list
        self._wait_s = 0.0    # seconds a request waited for a free arena

    def get_buffers(self, spec):
        with self._cond:
            if self._spec is None:
                self._spec = dict(spec)
            elif spec != self._spec:
                return None
            waited = 0.0
            while True:
                if self._stop.is_set():
                    return None
                if self._free:
                    arena = self._free.pop()
                    arena._reclaimed = False
                    self._reuse += 1
                    break
                if self._allocated < self._depth or waited >= _GROW_TIMEOUT_S:
                    arena = HostArena(self, self._spec, self._pinned)
                    self._allocated += 1
                    self._alloc += 1
                    self._depth = max(self._depth, self._allocated)
                    break
                t0 = time.perf_counter()
                self._cond.wait(timeout=min(max(_GROW_TIMEOUT_S - waited, 0.005), 0.25))
                waited += time.perf_counter() - t0
            self._wait_s += waited
            self._pending = arena
            return arena.buffers

    @property
    def nbytes(self):
        """Bytes of every allocated arena, free or out (the memory
        governor's ``arena-pool`` pool; staged and in-flight batches live in
        them, so this covers the staging window too)."""
        with self._cond:
            if self._spec is None:
                return 0
            per_arena = sum(int(np.prod(shape)) * np.dtype(dtype).itemsize
                            for shape, dtype in self._spec.values())
            return self._allocated * per_arena

    def set_pinned(self, enabled):
        """Pin (or not) the arenas allocated from now on; existing arenas
        keep their memory. The governor's advisory rung unpins: pinned
        pages are the ones the kernel cannot reclaim. A copy from an
        unpinned arena is synchronous to the host, and the arena is still
        recycled only after its event."""
        with self._cond:
            self._pinned = bool(enabled)

    @property
    def pinned(self):
        with self._cond:
            return self._pinned

    def ensure_depth(self, depth):
        """Keep at least ``depth`` arenas before a request waits."""
        with self._cond:
            self._depth = max(self._depth, depth)
            self._cond.notify_all()

    def claim_pending(self):
        """The arena of the latest ``get_buffers`` call (or None)."""
        with self._cond:
            arena, self._pending = self._pending, None
            return arena

    def _reclaim(self, arena):
        with self._cond:
            if len(self._free) < self._depth:
                self._free.append(arena)
            else:
                self._allocated -= 1
            self._cond.notify_all()

    def wake(self):
        with self._cond:
            self._cond.notify_all()

    def stats(self):
        """``arena_alloc`` (should stay flat after warm-up), ``arena_reuse``
        (climbs), ``arena_wait_s`` (assembler backpressure) and the depth."""
        with self._cond:
            return {'arena_alloc': self._alloc, 'arena_reuse': self._reuse,
                    'arena_wait_s': self._wait_s, 'arena_depth': self._depth,
                    'arena_allocated': self._allocated, 'arena_pinned': self._pinned}

    def reset_stats(self):
        with self._cond:
            self._alloc = self._reuse = 0
            self._wait_s = 0.0


class DevicePutMeter(object):
    """Per-device accounting of a mesh loader's tile copies (the counters
    of ``petastorm_tpu/staging.py``'s ``DeviceStager``): ``shards_put``
    copies, and per device the seconds and bytes of the completed ones.
    One process drives one device, so a rank reports one entry."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        with self._lock:
            self.shards_put = 0
            self._seconds = {}
            self._bytes = {}

    def issued(self):
        with self._lock:
            self.shards_put += 1

    def completed(self, device, seconds, nbytes):
        key = str(device)
        with self._lock:
            self._seconds[key] = self._seconds.get(key, 0.0) + seconds
            self._bytes[key] = self._bytes.get(key, 0) + nbytes

    def stats(self, devices):
        with self._lock:
            return {'n_devices': len(devices), 'shards_put': self.shards_put,
                    'device_put_s': {str(d): self._seconds.get(str(d), 0.0) for d in devices},
                    'device_put_bytes': {str(d): self._bytes.get(str(d), 0) for d in devices}}


class OverlapMeter(object):
    """Wall-clock co-activity of named stages (assemble vs dispatch):
    ``overlap_frac`` is the seconds both ran at once over the smaller
    stage's busy seconds. ``reset()`` starts a new window; lifetime totals
    survive it (``stats(total=True)``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._active = 0
        self._mark = None
        self._busy = {}
        self._overlap_s = 0.0
        self._base_busy = {}
        self._base_overlap = 0.0
        self._live = {}       # token -> (stage, t0) of the spans open now

    def _transition(self, delta):
        now = time.perf_counter()
        if self._active >= 2 and self._mark is not None:
            self._overlap_s += now - self._mark
        self._active += delta
        self._mark = now
        return now

    def _snapshot(self, now):
        busy = dict(self._busy)
        for name, t0 in self._live.values():
            busy[name] = busy.get(name, 0.0) + (now - t0)
        overlap = self._overlap_s
        if self._active >= 2 and self._mark is not None:
            overlap += now - self._mark
        return busy, overlap

    @contextmanager
    def track(self, name):
        token = object()
        with self._lock:
            t0 = self._transition(+1)
            self._live[token] = (name, t0)
        try:
            yield
        finally:
            with self._lock:
                t1 = self._transition(-1)
                self._live.pop(token, None)
                self._busy[name] = self._busy.get(name, 0.0) + (t1 - t0)

    @contextmanager
    def pause(self, name):
        """Suspend ``name`` inside its ``track`` span while it merely waits
        (a reader pull): the wait counts neither as busy nor as overlap."""
        with self._lock:
            t0 = self._transition(-1)
        try:
            yield
        finally:
            with self._lock:
                t1 = self._transition(+1)
                self._busy[name] = self._busy.get(name, 0.0) - (t1 - t0)

    def stats(self, total=False):
        with self._lock:
            busy, overlap = self._snapshot(time.perf_counter())
            if not total:
                busy = {k: v - self._base_busy.get(k, 0.0) for k, v in busy.items()}
                overlap -= self._base_overlap
        floor = min(busy.values()) if len(busy) >= 2 else 0.0
        return {'busy_s': busy, 'overlap_s': overlap,
                'overlap_frac': min(1.0, overlap / floor) if floor > 1e-9 else 0.0}

    def reset(self):
        with self._lock:
            self._base_busy, self._base_overlap = self._snapshot(time.perf_counter())


class MeteredReader(object):
    """Iteration proxy that reports the time blocked in the reader as
    *paused* assemble time, so ``assemble_s`` and the overlap cover collate
    work only; ``reader_wait_s`` sums the blocked seconds."""

    def __init__(self, reader, meter, stage='assemble'):
        self._reader = reader
        self._meter = meter
        self._stage = stage
        self.reader_wait_s = 0.0

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        try:
            with self._meter.pause(self._stage):
                return next(self._reader)
        finally:
            self.reader_wait_s += time.perf_counter() - t0

    def __getattr__(self, name):
        return getattr(self._reader, name)


class _StageError(object):
    def __init__(self, exc):
        self.exc = exc


_DONE = object()


class StagingEngine(object):
    """Assemble and dispatch threads feeding a bounded consumer queue.

    :param host_iter: iterator of host batch dicts, collated into ``pool``
        arenas.
    :param stage_fn: ``(batch, arena) -> staged``: issues the asynchronous
        device copies.
    :param out_queue: receives staged batches in order, then
        ``end_sentinel`` (or the exception that ended the pipeline).
    :param ready_fn: ``staged -> None``, blocks until its copies completed;
        called before the arena behind it is recycled.
    :param holds_mode: staged tensors alias arena memory: an arena is
        recycled only once the consumer dropped them.
    :param inflight: staged batches whose copies may be in flight before
        the dispatch thread blocks on the oldest (>= 1).
    :param meter: the :class:`OverlapMeter` the assemble and dispatch
        stages are tracked on (a ``MeteredReader`` under ``host_iter``
        pauses the same meter).
    """

    def __init__(self, host_iter, stage_fn, out_queue, stop_event, end_sentinel,
                 pool, ready_fn=None, holds_mode=False, inflight=2, meter=None):
        if inflight < 1:
            raise ValueError('inflight must be >= 1, got {}'.format(inflight))
        self._host_iter = host_iter
        self._stage_fn = stage_fn
        self._out = out_queue
        self._stop = stop_event
        self._end = end_sentinel
        self._pool = pool
        self._ready_fn = ready_fn or (lambda staged: None)
        self._holds_mode = holds_mode
        self._inflight = int(inflight)
        self.meter = meter if meter is not None else OverlapMeter()
        self._stats_lock = threading.Lock()
        self._ready_wait_s = 0.0
        self._stage_q = queue.Queue(maxsize=2)
        self._threads = [
            threading.Thread(target=self._assemble_loop, daemon=True,
                             name=THREAD_PREFIX + 'assemble'),
            threading.Thread(target=self._dispatch_loop, daemon=True,
                             name=THREAD_PREFIX + 'dispatch'),
        ]

    def start(self):
        for t in self._threads:
            t.start()
        return self

    def _put(self, q, obj):
        """Stop-aware bounded put; False when the pipeline is stopping."""
        while not self._stop.is_set():
            try:
                q.put(obj, timeout=0.1)
                return True
            except queue.Full:
                continue
        try:
            q.put_nowait(obj)
            return True
        except queue.Full:
            return False

    def _get(self):
        while not self._stop.is_set():
            try:
                return self._stage_q.get(timeout=0.1)
            except queue.Empty:
                continue
        return None

    def _assemble_loop(self):
        try:
            while not self._stop.is_set():
                try:
                    with self.meter.track('assemble'):
                        batch = next(self._host_iter)
                except StopIteration:
                    break
                arena = self._pool.claim_pending()
                if not self._put(self._stage_q, (batch, arena)):
                    if arena is not None:
                        arena.retire()
                    return
        except Exception as e:  # noqa: BLE001 - delivered to the consumer
            arena = self._pool.claim_pending()
            if arena is not None:
                arena.retire()
            self._put(self._stage_q, _StageError(e))
            return
        self._put(self._stage_q, _DONE)

    def _retire(self, staged, arena, wait):
        if wait and not self._stop.is_set():
            t0 = time.perf_counter()
            self._ready_fn(staged)
            with self._stats_lock:
                self._ready_wait_s += time.perf_counter() - t0
        arena.retire()

    def _dispatch_loop(self):
        inflight = deque()
        arena = None
        try:
            while True:
                item = self._get()
                if item is None:
                    return
                if item is _DONE or isinstance(item, _StageError):
                    while inflight:
                        self._retire(*inflight.popleft(), wait=True)
                    self._put(self._out, self._end if item is _DONE else item.exc)
                    return
                batch, arena = item
                with self.meter.track('dispatch'):
                    staged = self._stage_fn(batch, arena)
                if arena is not None:
                    if self._holds_mode:
                        for value in staged.tensors.values():
                            arena.add_hold(value)
                    inflight.append((staged, arena))
                    arena = None
                del batch
                if not self._put(self._out, staged):
                    return
                del staged
                while len(inflight) > self._inflight:
                    self._retire(*inflight.popleft(), wait=True)
        except Exception as e:  # noqa: BLE001 - delivered to the consumer
            self._put(self._out, e)
            self._stop.set()
        finally:
            if arena is not None:
                arena.retire()
            while inflight:
                self._retire(*inflight.popleft(), wait=False)

    def stats(self):
        """Per-stage busy seconds, their overlap, and the seconds the
        dispatch thread waited on the oldest copy (``ready_wait_s``)."""
        m = self.meter.stats()
        with self._stats_lock:
            ready_wait = self._ready_wait_s
        return {'assemble_s': m['busy_s'].get('assemble', 0.0),
                'dispatch_s': m['busy_s'].get('dispatch', 0.0),
                'overlap_s': m['overlap_s'], 'overlap_frac': m['overlap_frac'],
                'overlap_frac_total': self.meter.stats(total=True)['overlap_frac'],
                'ready_wait_s': ready_wait}

    def reset_stats(self):
        self.meter.reset()
        with self._stats_lock:
            self._ready_wait_s = 0.0

    def stop(self, join_timeout_s=10):
        """Idempotent: set stop, unblock and join both threads. The caller
        drains ``out_queue``. Returns the names of threads still alive."""
        self._stop.set()
        self._pool.wake()
        for t in self._threads:
            t.join(timeout=join_timeout_s)
        while True:
            try:
                item = self._stage_q.get_nowait()
            except queue.Empty:
                break
            if isinstance(item, tuple) and item[1] is not None:
                item[1].retire()
        return [t.name for t in self._threads if t.is_alive()]
