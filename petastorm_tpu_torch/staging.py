"""Host staging: recycled (pinned) batch arenas and the assemble/dispatch
engine that overlaps batch collate with host-to-device copies.

Counterpart of ``petastorm_tpu/staging.py:149-600`` (``HostArena``,
``ArenaPool``), ``:600-745`` (``OverlapMeter``, ``MeteredReader``) and
``:1156-`` (``StagingEngine``), trimmed: no sharded layouts. The
autotuner's hooks are the JAX package's (``:531-570, 1466-1484``):
:meth:`ArenaPool.set_depth` and :attr:`ArenaPool.depth`, :attr:`ArenaPool.wait_seconds`, :meth:`StagingEngine.set_inflight`,
:attr:`StagingEngine.inflight_window` and
:attr:`StagingEngine.ready_wait_seconds`. The instruments are the JAX package's:
``pst_assemble_seconds`` and ``pst_dispatch_seconds`` (one observation a
batch), ``pst_arena_wait_seconds`` (a request that waited for an arena),
``pst_arena_pinned_bytes`` (pinned arenas alive) and, for a mesh loader's
per-device copies, ``pst_device_put_seconds{device}``.

On CUDA an arena's buffers are ``torch.empty(..., pin_memory=True)``
tensors, viewed as numpy for the collate; the dispatch stage copies them
to the card with ``non_blocking=True`` and an arena is recycled only after
the CUDA event recorded behind its copy completed (the JAX package's
``block_until_ready`` contract, ``staging.py:1171-1173``). On the CPU the
staged tensors alias the arena (``torch.from_numpy``), so an arena returns
to the pool only once the consumer dropped every such tensor
(``holds_mode``, the GC-hold rule of ``staging.py:88``).

The sanitizer (``PSTT_SANITIZE``, :mod:`petastorm_tpu_torch.analysis.sanitize`;
JAX ``staging.py:221-245``): the collate gets borrow-tagged numpy views of
an arena's buffers, and a reclaim bumps the arena's ``view_epoch`` and
poisons its buffers (0xCB), so a view kept past its batch raises
``StaleViewError`` at its next touch. A reclaim poisons only an arena
whose copy has settled: its event completed, or no copy was issued; the
stop path, which retires without waiting, bumps the epoch only. The torch
tensors over an arena are not guarded: on the card they are the copy
source, read by the copy alone; on the CPU a staged tensor holds its arena
(``holds_mode``), so the arena cannot be reclaimed under a live tensor.
The seeded ``arena-stale-view`` and ``lock-order-invert`` sites (JAX
``staging.py:1348-1362, 1404-1411``) fire in :class:`StagingEngine`.

Health and tracing (``petastorm_tpu/staging.py:1221-1233, 1287-1430``): with
a :class:`~petastorm_tpu_torch.health.HeartbeatRegistry` the engine beats
an ``assemble`` heartbeat (``'collate'``, ``'reader-wait'`` through the
:class:`MeteredReader`, ``'arena-wait'`` through the :class:`ArenaPool`,
``'stageq-put'``) and a ``dispatch`` one (``'stageq-get'``, ``'device_put'``
before the stage function, so before the loader's ``device-put-delay``
site and its copy issue, ``'ready-wait'`` before it waits on a copy's
event, ``'out-put'``), ``'idle'`` when a thread ends, and registers its
``stats`` as the ``staging`` probe. With a tracer it records the
``assemble`` and ``dispatch`` spans (host time: a dispatch span covers the
issue of the copies, not the copies) and the ``staging_inflight`` and
``arena_pool_free`` counters. A thread that outlives ``stop``'s join is
recorded in ``stats()['leaked_threads']``, traced as a
``staging-leaked-thread:<name>`` instant and logged with every stack.
"""

import logging
import queue
import threading
import time
import weakref
from collections import deque
from contextlib import contextmanager

import numpy as np
import torch

from petastorm_tpu_torch import faults, metrics
from petastorm_tpu_torch.analysis import sanitize
from petastorm_tpu_torch.trace import NullTracer

logger = logging.getLogger(__name__)

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
        self.pinned = pinned
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
        self._settled = True
        #: The recycle generation: bumped at every reclaim, the borrow tag
        #: of the views :meth:`borrowed_buffers` hands out.
        self.view_epoch = 0
        self._lent = self.buffers

    def borrow(self, array):
        """Borrow-tag ``array`` (a buffer or a view of one) against the
        current epoch; the array itself unless the sanitizer is armed."""
        return sanitize.guard_view(array, self)

    def borrowed_buffers(self):
        """The buffers as the collate gets them: borrow-tagged views when
        the sanitizer is armed, else the buffers themselves."""
        if sanitize.sanitize_active():
            self._lent = {name: sanitize.guard_view(buf, self)
                          for name, buf in self.buffers.items()}
        else:
            self._lent = self.buffers
        return self._lent

    def owns(self, name, array):
        """True when ``array`` is this arena's buffer ``name``, as is or as
        lent to the collate."""
        return array is self.buffers.get(name) or array is self._lent.get(name)

    def _on_reclaim(self):
        """The buffers rejoin the free list: every view still out is stale.
        Bump the epoch always; poison (sanitizer only) once the copy out of
        the buffers has settled, never under an in-flight copy."""
        self.view_epoch += 1
        if self._settled:
            sanitize.poison(self.buffers.values())

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

    def retire(self, settled=True):
        """The transfer is done: back to the pool once no holds remain.
        ``settled=False``: a copy out of the buffers may still be in flight
        (the stop path), so the reclaim must not poison them. Idempotent."""
        with self._lock:
            if self._reclaimed:
                return
            self._settled = settled
            if self._holds:
                self._retired = True
                return
            self._reclaimed = True
        self._pool._reclaim(self)


class ArenaPool(object):
    """Bounded pool of :class:`HostArena`. ``get_buffers`` blocks (stop-
    aware) while every arena is out and grows past ``depth`` after
    ``_GROW_TIMEOUT_S`` rather than deadlocking a consumer that holds many
    batches; such arenas are kept apart from the depth (``arena_grown``),
    so :meth:`set_depth` (the autotuner's knob) is never undone behind its
    back and :attr:`depth` reads what it set. Specs other than the pool's
    first get ``None``: the caller then allocates plainly. ``heartbeat``
    (the assemble stage's) reads ``'arena-wait'`` while a request waits;
    ``tracer`` gets the ``arena_pool_free`` counter."""

    def __init__(self, depth, stop_event, pinned, tracer=None, heartbeat=None):
        if depth < 1:
            raise ValueError('ArenaPool depth must be >= 1, got {}'.format(depth))
        self._depth = depth
        self._floor = 1       # the depth ensure_depth asked for: set_depth keeps it
        self._grown = 0       # arenas allocated past the depth by the grow timeout
        self._stop = stop_event
        self._pinned = pinned
        self._tracer = tracer if tracer is not None else NullTracer()
        self._heartbeat = heartbeat
        self._cond = threading.Condition()
        self._free = []
        self._spec = None
        self._allocated = 0
        self._pending = None
        self._alloc = 0       # arenas allocated (the window's count)
        self._reuse = 0       # requests served from the free list
        self._wait_s = 0.0    # seconds a request waited for a free arena
        self._m_wait = metrics.histogram(
            'pst_arena_wait_seconds',
            'Assembler blocked time per arena acquisition (backpressure)')
        self._m_pinned = metrics.gauge(
            'pst_arena_pinned_bytes',
            'Host bytes in live pinned (page-aligned/mlocked) arena slabs '
            'across all pools (inc/dec per slab lifetime)')

    def get_buffers(self, spec):
        with self._cond:
            if self._spec is None:
                self._spec = dict(spec)
            elif spec != self._spec:
                return None
            waited = 0.0
            waiting_hb = False
            arena = None
            while True:
                if self._stop.is_set():
                    return None
                if self._free:
                    arena = self._free.pop()
                    arena._reclaimed = False
                    self._reuse += 1
                    break
                if self._allocated < self._depth + self._grown or waited >= _GROW_TIMEOUT_S:
                    # Counted now, allocated below without the lock: a pinned
                    # allocation takes milliseconds, and the watchdog's probe
                    # and the governor read the pool under this lock.
                    self._allocated += 1
                    self._alloc += 1
                    self._grown = max(self._grown, self._allocated - self._depth)
                    break
                if self._heartbeat is not None and not waiting_hb:
                    # One beat on entry, then the age accrues: a wedged pool
                    # reads as a stale 'arena-wait'.
                    self._heartbeat.beat('arena-wait')
                    waiting_hb = True
                t0 = time.perf_counter()
                self._cond.wait(timeout=min(max(_GROW_TIMEOUT_S - waited, 0.005), 0.25))
                waited += time.perf_counter() - t0
            if waiting_hb:
                self._heartbeat.beat('collate')
            self._wait_s += waited
            if waited:
                self._m_wait.observe(waited)
            pinned = self._pinned
        if arena is None:
            try:
                arena = HostArena(self, self._spec, pinned)
            except BaseException:
                with self._cond:
                    self._allocated -= 1
                    self._cond.notify_all()
                raise
            if pinned:
                nbytes = sum(t.nbytes for t in arena.tensors.values())
                self._m_pinned.inc(nbytes)
                weakref.finalize(arena, self._m_pinned.dec, nbytes)
        with self._cond:
            self._pending = arena
            self._tracer.counter('arena_pool_free', len(self._free), 'staging')
        return arena.borrowed_buffers()

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
        """Keep at least ``depth`` arenas before a request waits, from now
        on: :meth:`set_depth` never goes below it."""
        with self._cond:
            self._floor = max(self._floor, depth)
            if depth > self._depth:
                # Arenas grown past the old depth now count in the new one.
                self._grown = max(0, self._grown - (depth - self._depth))
                self._depth = depth
            self._cond.notify_all()

    def set_depth(self, depth):
        """Retarget the depth while the pool runs (the autotuner's
        ``arena_depth`` knob), at least :attr:`floor`; arenas grown past the
        old depth are forgotten. A deeper pool wakes a waiting request to
        allocate; a shallower one drops free arenas past the depth now and
        the rest as they come back, never one whose copy is in flight."""
        with self._cond:
            depth = max(1, int(depth), self._floor)
            self._depth = depth
            self._grown = 0
            while len(self._free) > depth:
                self._free.pop()
                self._allocated -= 1
            self._cond.notify_all()

    @property
    def depth(self):
        with self._cond:
            return self._depth

    @property
    def floor(self):
        """The least depth :meth:`set_depth` takes (:meth:`ensure_depth`'s)."""
        with self._cond:
            return self._floor

    @property
    def wait_seconds(self):
        """Seconds requests waited for a free arena (the autotuner's
        arena-bound signal)."""
        with self._cond:
            return self._wait_s

    def claim_pending(self):
        """The arena of the latest ``get_buffers`` call (or None)."""
        with self._cond:
            arena, self._pending = self._pending, None
            return arena

    def _reclaim(self, arena):
        arena._on_reclaim()
        with self._cond:
            if len(self._free) < self._depth + self._grown:
                self._free.append(arena)
            else:
                self._allocated -= 1
            self._cond.notify_all()
            self._tracer.counter('arena_pool_free', len(self._free), 'staging')

    def wake(self):
        with self._cond:
            self._cond.notify_all()

    def stats(self):
        """``arena_alloc`` (should stay flat after warm-up), ``arena_reuse``
        (climbs), ``arena_wait_s`` (assembler backpressure), the depth and
        the arenas grown past it."""
        with self._cond:
            return {'arena_alloc': self._alloc, 'arena_reuse': self._reuse,
                    'arena_wait_s': self._wait_s, 'arena_depth': self._depth,
                    'arena_grown': self._grown, 'arena_allocated': self._allocated,
                    'arena_pinned': self._pinned}

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
        self._m_put = metrics.histogram(
            'pst_device_put_seconds',
            'Per-device shard device_put latency (issue time; window '
            'fences are reported separately)', labelnames=('device',))
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
        self._m_put.labels(key).observe(seconds)
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
    work only; ``reader_wait_s`` sums the blocked seconds. ``heartbeat``
    (the assemble stage's) reads ``'reader-wait'`` during a pull and
    ``'collate'`` after it."""

    def __init__(self, reader, meter, stage='assemble', heartbeat=None):
        self._reader = reader
        self._meter = meter
        self._stage = stage
        self._hb = heartbeat
        self.reader_wait_s = 0.0

    def __iter__(self):
        return self

    def __next__(self):
        hb = self._hb
        if hb is not None:
            hb.beat('reader-wait')
        t0 = time.perf_counter()
        try:
            with self._meter.pause(self._stage):
                return next(self._reader)
        finally:
            self.reader_wait_s += time.perf_counter() - t0
            if hb is not None:
                hb.beat('collate')

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
    :param tracer: records the ``assemble``/``dispatch`` spans and the
        ``staging_inflight`` counter.
    :param health: a :class:`~petastorm_tpu_torch.health.HeartbeatRegistry`:
        the ``assemble`` and ``dispatch`` heartbeats and the ``staging``
        probe are registered there.
    """

    def __init__(self, host_iter, stage_fn, out_queue, stop_event, end_sentinel,
                 pool, ready_fn=None, holds_mode=False, inflight=2, meter=None, tracer=None,
                 health=None):
        if inflight < 1:
            raise ValueError('inflight must be >= 1, got {}'.format(inflight))
        self._tracer = tracer if tracer is not None else NullTracer()
        self._leaked_threads = []
        self._hb_assemble = self._hb_dispatch = None
        if health is not None:
            self._hb_assemble = health.register('assemble')
            self._hb_dispatch = health.register('dispatch')
            health.register_probe('staging', self.stats)
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
        self._m_assemble = metrics.histogram(
            'pst_assemble_seconds', 'Host-batch collate latency per batch')
        self._m_dispatch = metrics.histogram(
            'pst_dispatch_seconds', 'Device staging dispatch latency per '
            'batch (put issue time, not transfer completion)')
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
        hb = self._hb_assemble
        try:
            self._assemble_body(hb)
        finally:
            if hb is not None:
                hb.beat('idle')     # done, stopped or failed: quiet is no stall

    def _assemble_body(self, hb):
        try:
            while not self._stop.is_set():
                if hb is not None:
                    hb.beat('collate')
                try:
                    t0 = time.perf_counter()
                    with self.meter.track('assemble'), self._tracer.span('assemble', 'host'):
                        batch = next(self._host_iter)
                    self._m_assemble.observe(time.perf_counter() - t0)
                except StopIteration:
                    break
                arena = self._pool.claim_pending()
                if hb is not None:
                    hb.beat('stageq-put')
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
        settled = wait and not self._stop.is_set()
        if settled:
            if self._hb_dispatch is not None:
                self._hb_dispatch.beat('ready-wait')
            t0 = time.perf_counter()
            self._ready_fn(staged)
            with self._stats_lock:
                self._ready_wait_s += time.perf_counter() - t0
        # Seeded use-after-reclaim (fault site 'arena-stale-view'): a
        # borrow-tagged view kept across the retire and touched after.
        # Armed, the touch raises StaleViewError; unarmed it reads recycled
        # bytes silently. In holds mode the reclaim waits for the
        # consumer's tensors, so the proof drives the engine without it.
        stale_probe = None
        if faults.faults_active() and faults.get_injector().should_fire('arena-stale-view'):
            stale_probe = arena.borrow(next(iter(arena.buffers.values())))
        arena.retire(settled=settled)
        if stale_probe is not None:
            stale_probe.sum()

    def _dispatch_loop(self):
        hb = self._hb_dispatch
        try:
            self._dispatch_body(hb)
        finally:
            if hb is not None:
                hb.beat('idle')

    def _dispatch_body(self, hb):
        inflight = deque()
        arena = None
        try:
            while True:
                if hb is not None:
                    hb.beat('stageq-get')
                item = self._get()
                if item is None:
                    return
                if item is _DONE or isinstance(item, _StageError):
                    while inflight:
                        self._retire(*inflight.popleft(), wait=True)
                    self._put(self._out, self._end if item is _DONE else item.exc)
                    return
                batch, arena = item
                if hb is not None:
                    hb.beat('device_put')
                # Seeded lock-order inversion (fault site 'lock-order-invert'):
                # armed, the recorder raises before blocking and the
                # violation reaches the consumer like any pipeline error.
                sanitize.maybe_inject_lock_inversion()
                t0 = time.perf_counter()
                with self.meter.track('dispatch'), self._tracer.span('dispatch', 'device'):
                    staged = self._stage_fn(batch, arena)
                self._m_dispatch.observe(time.perf_counter() - t0)
                if arena is not None:
                    if self._holds_mode:
                        for value in staged.tensors.values():
                            arena.add_hold(value)
                    inflight.append((staged, arena))
                    arena = None
                    self._tracer.counter('staging_inflight', len(inflight), 'staging')
                del batch
                if hb is not None:
                    hb.beat('out-put')
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
                arena.retire(settled=False)   # its copy may have been issued
            while inflight:
                self._retire(*inflight.popleft(), wait=False)

    def stats(self):
        """Per-stage busy seconds, their overlap, the seconds the dispatch
        thread waited on the oldest copy (``ready_wait_s``) and the threads
        a ``stop`` left alive (``leaked_threads``). Reads counters only, so
        the watchdog's ``staging`` probe never waits on the card."""
        m = self.meter.stats()
        with self._stats_lock:
            ready_wait = self._ready_wait_s
            leaked = list(self._leaked_threads)
        return {'assemble_s': m['busy_s'].get('assemble', 0.0),
                'dispatch_s': m['busy_s'].get('dispatch', 0.0),
                'overlap_s': m['overlap_s'], 'overlap_frac': m['overlap_frac'],
                'overlap_frac_total': self.meter.stats(total=True)['overlap_frac'],
                'ready_wait_s': ready_wait, 'leaked_threads': leaked}

    def reset_stats(self):
        self.meter.reset()
        with self._stats_lock:
            self._ready_wait_s = 0.0

    def set_inflight(self, n):
        """Retarget the copy window while the engine runs (the autotuner's
        ``inflight`` knob): the dispatch loop reads it each batch, so a wider
        window takes effect at the next batch and a narrower one drains by
        waiting on the oldest copies."""
        self._inflight = max(1, int(n))

    @property
    def inflight_window(self):
        return self._inflight

    @property
    def ready_wait_seconds(self):
        """Seconds the dispatch thread waited on the oldest copy (the
        autotuner's dispatch-bound signal)."""
        with self._stats_lock:
            return self._ready_wait_s

    def stop(self, join_timeout_s=10):
        """Idempotent: set stop, unblock and join both threads. The caller
        drains ``out_queue``. Returns the names of the threads this call
        left alive (a copy hung on a wedged card), which are also recorded
        in ``stats()['leaked_threads']``, traced and logged with every
        thread's stack."""
        self._stop.set()
        self._pool.wake()
        for t in self._threads:
            t.join(timeout=join_timeout_s)
        leaked = [t.name for t in self._threads if t.is_alive()]
        if leaked:
            from petastorm_tpu_torch.health import dump_all_stacks
            with self._stats_lock:
                self._leaked_threads.extend(n for n in leaked if n not in self._leaked_threads)
            for name in leaked:
                self._tracer.instant('staging-leaked-thread:{}'.format(name), cat='watchdog')
            logger.warning('StagingEngine.stop: thread(s) %s still alive after %.1fs join. Thread '
                           'stacks:\n%s', leaked, join_timeout_s, dump_all_stacks())
        while True:
            try:
                item = self._stage_q.get_nowait()
            except queue.Empty:
                break
            if isinstance(item, tuple) and item[1] is not None:
                item[1].retire()
        return leaked
