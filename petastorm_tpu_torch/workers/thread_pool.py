"""In-process thread pool with a ventilator feed and a bounded results queue.

Counterpart of ``petastorm_tpu/workers/thread_pool.py:36-461``.
:meth:`ThreadPool.resize` grows or shrinks the live pool (the autotuner's
``workers`` knob, ``:176-250``): a grow spawns threads (cancelling pending
retires first) and widens the ventilation queue; a shrink posts retire
requests that workers honour between items, so no item is lost or run
twice; retired threads are reaped at ``join()``. Either re-divides the
pool's ``decode_share`` of the decode-thread budget. ``profiling_enabled``
runs each worker thread under ``cProfile`` and prints the threads' summed
profile at ``join()`` (``:40-85, 415-434``; the benchmark's
``profile_threads``).
``results_watermark`` arms the ventilator's backpressure: while that many results wait undelivered, no
new item is fed (the memory governor's shed rung sets it).
``results_nbytes()`` is the governor's ``results-queue`` pool, and
``inject_consumer_error`` hands an error (a memory breach, a watchdog's
stall) to a consumer waiting in ``get_results()``: it raises while no result
is there, and a result that arrives first clears it (the pipeline
recovered). ``health_heartbeat`` (set by ``Reader.attach_health``) beats
``'poll'`` on each pass of the consumer's wait (``:350-351``). End of data is the results queue empty AND
every ventilated item processed AND the ventilator completed. A worker's
exception stops the pool and re-raises in the consumer, unless the worker
turned it into a :class:`~petastorm_tpu_torch.workers.RowGroupQuarantined`
record (a reader with an ``error_budget``): that counts as the item's
processed ack and goes to ``quarantine_sink``. ``get_results(timeout=)``
raises ``TimeoutWaitingForResultError`` naming the live and dead workers
and the items in flight. Every published result passes the
``queue-stall`` fault site. Results are dicts
and pass through unchanged, each chunk's ``key``, ``det`` tag and
``lineage`` included; with a resequencer set (deterministic mode)
``get_results()`` releases them in ventilation order.
"""

import cProfile
import pstats
import queue
import threading
import time

from petastorm_tpu_torch.determinism import ResequencedReads
from petastorm_tpu_torch.faults import maybe_inject
from petastorm_tpu_torch.membudget import approx_nbytes, get_governor
from petastorm_tpu_torch.workers import (EmptyResultError, RowGroupQuarantined,
                                         TimeoutWaitingForResultError,
                                         VentilatedItemProcessedMessage, deliver_quarantine,
                                         quarantine_record_for)

THREAD_PREFIX = 'pstt-pool-worker-'
_POLL_S = 0.01
#: Ventilation-queue room over the worker count after a resize (the reader
#: keeps the ventilator's cap at workers + 2).
_RESIZE_VENT_SLACK = 4


class _WorkerThread(threading.Thread):
    def __init__(self, pool, worker):
        super().__init__(daemon=True, name=THREAD_PREFIX + str(worker.worker_id))
        self._pool = pool
        self._worker = worker
        self.profile = None

    def run(self):
        pool = self._pool
        if pool._profiling_enabled:
            self.profile = cProfile.Profile()
            try:
                self.profile.enable()
            except ValueError:      # another profiler holds this thread
                self.profile = None
        try:
            while not pool._stop_event.is_set():
                # Between items only: a worker that took an item finishes it.
                if pool._should_retire(self):
                    return
                try:
                    args, kwargs = pool._ventilator_queue.get(timeout=_POLL_S)
                except queue.Empty:
                    continue
                try:
                    self._worker.process(*args, **kwargs)
                    pool._put_result(VentilatedItemProcessedMessage())
                except _Stopping:
                    return
                except Exception as e:  # noqa: BLE001 - surfaces in the consumer
                    record = quarantine_record_for(self._worker, e, args, kwargs)
                    try:
                        pool._put_result(record if record is not None else e)
                    except _Stopping:
                        return
        finally:
            if self.profile is not None:
                self.profile.disable()
            self._worker.shutdown()


class _Stopping(Exception):
    pass


class ThreadPool(ResequencedReads):
    def __init__(self, workers_count, results_queue_size=50, profiling_enabled=False):
        if workers_count < 1:
            raise ValueError('workers_count must be >= 1, got {}'.format(workers_count))
        self._workers_count = workers_count
        self._profiling_enabled = profiling_enabled
        self._results_queue = queue.Queue(maxsize=results_queue_size)
        self._ventilator_queue = None
        self._stop_event = threading.Event()
        self._threads = []
        self._retired = []
        self._ventilator = None
        self._unprocessed = 0
        self._count_lock = threading.Lock()
        # A resize's target may differ from len(_threads) while retire
        # requests are pending.
        self._resize_lock = threading.Lock()
        self._retire_requests = 0
        self._next_worker_id = workers_count
        self._worker_class = None
        self._worker_args = None
        #: Undelivered results at which the ventilator holds; None = unarmed.
        self.results_watermark = None
        #: Moving average of one published result's bytes, kept while the
        #: governor is armed (the ``results-queue`` pool is depth x this).
        self.result_nbytes_ema = 0.0
        self._injected_error = None
        #: Set by a reader with an ``error_budget``: receives each
        #: ``RowGroupQuarantined`` record and raises past the budget.
        self.quarantine_sink = None
        #: The consumer's health heartbeat, or None.
        self.health_heartbeat = None
        #: The reader's ``decode_budget.PoolShare``, or None: a resize
        #: re-divides it, so every worker's next decode takes the new share.
        self.decode_share = None

    @property
    def workers_count(self):
        return self._workers_count

    @property
    def results_qsize(self):
        return self._results_queue.qsize()

    @property
    def results_capacity(self):
        return self._results_queue.maxsize

    @property
    def diagnostics(self):
        """Queue depths, items in flight and live worker threads."""
        with self._count_lock:
            in_flight = self._unprocessed
        return {'output_queue_size': self._results_queue.qsize(),
                'ventilation_queue_size': (self._ventilator_queue.qsize()
                                           if self._ventilator_queue is not None else 0),
                'ventilated_unprocessed': in_flight,
                'workers_count': self._workers_count,
                'live_worker_threads': self._live_threads(),
                'results_watermark': self.results_watermark}

    def results_nbytes(self):
        """Estimated decoded bytes waiting in the results queue."""
        return int(self.results_qsize * self.result_nbytes_ema)

    def _results_backpressure(self):
        watermark = self.results_watermark
        if watermark is None:
            return None
        return self._results_queue.qsize() >= watermark

    def inject_consumer_error(self, exc):
        """Raise ``exc`` in the consumer's ``get_results()`` (it polls).
        Unlike a worker's exception it stops nothing: the caller owns the
        teardown."""
        self._injected_error = exc

    def _live_threads(self):
        with self._count_lock:
            return sum(1 for t in self._threads if t.is_alive())

    def start(self, worker_class, worker_args, ventilator):
        if self._threads:
            raise RuntimeError('ThreadPool already started')
        # The ventilator caps unprocessed items at its window, so the queue
        # never legitimately holds more (a resize widens both).
        self._ventilator_queue = queue.Queue(maxsize=max(1, ventilator._max_in_flight))
        self._worker_class = worker_class
        self._worker_args = worker_args
        for worker_id in range(self._workers_count):
            self._spawn_worker(worker_id)
        self._ventilator = ventilator
        ventilator._ventilate_fn = self.ventilate
        ventilator.backpressure_fn = self._results_backpressure
        ventilator.start()

    def _spawn_worker(self, worker_id):
        thread = _WorkerThread(self, self._worker_class(worker_id, self._put_result,
                                                        self._worker_args))
        with self._count_lock:
            self._threads.append(thread)
        thread.start()

    def resize(self, n):
        """Grow or shrink the live pool to ``n`` workers; returns the new
        target. A grow spawns workers at once, after cancelling pending
        retires, and widens the ventilation queue to ``n + 4`` under its
        mutex (a queue still sized for the old pool would hold the feeder
        to the old width). A shrink posts ``old - n`` retire requests, each
        taken by one worker between items. Raises ``ValueError`` for
        ``n < 1`` and ``RuntimeError`` before ``start``."""
        n = int(n)
        if n < 1:
            raise ValueError('workers_count must be >= 1, got {}'.format(n))
        with self._resize_lock:
            if self._worker_class is None:
                raise RuntimeError('ThreadPool.resize() requires a started pool')
            if self._stop_event.is_set():
                return self._workers_count
            with self._count_lock:
                delta = n - self._workers_count
                if delta == 0:
                    return n
                self._workers_count = n
                if delta < 0:
                    self._retire_requests -= delta
                    spawn = 0
                else:
                    cancelled = min(self._retire_requests, delta)
                    self._retire_requests -= cancelled
                    spawn = delta - cancelled
                worker_id = self._next_worker_id
                self._next_worker_id += spawn
            for i in range(spawn):
                self._spawn_worker(worker_id + i)
            if delta > 0:
                vent_queue = self._ventilator_queue
                with vent_queue.mutex:
                    if n + _RESIZE_VENT_SLACK > vent_queue.maxsize:
                        vent_queue.maxsize = n + _RESIZE_VENT_SLACK
                        vent_queue.not_full.notify_all()
            if self.decode_share is not None:
                self.decode_share.resize(n)
            return n

    def _should_retire(self, thread):
        """Claim one pending retire request for ``thread`` (a worker, between
        items); the thread moves to the retired list, which ``join`` reaps."""
        if self._retire_requests <= 0:     # unlocked fast path, every poll
            return False
        with self._count_lock:
            if self._retire_requests <= 0:
                return False
            self._retire_requests -= 1
            self._threads.remove(thread)
            self._retired.append(thread)
            return True

    def ventilate(self, *args, **kwargs):
        with self._count_lock:
            self._unprocessed += 1
        while True:
            if self._stop_event.is_set():
                with self._count_lock:
                    self._unprocessed -= 1
                return
            try:
                self._ventilator_queue.put((args, kwargs), timeout=_POLL_S)
                return
            except queue.Full:
                continue

    def _put_result(self, data):
        """Stop-aware bounded put: never blocks forever on a departed consumer."""
        maybe_inject('queue-stall')
        if isinstance(data, dict) and get_governor().armed:
            self.result_nbytes_ema += 0.25 * (approx_nbytes(data) - self.result_nbytes_ema)
        while True:
            if self._stop_event.is_set():
                raise _Stopping()
            try:
                self._results_queue.put(data, timeout=_POLL_S)
                return
            except queue.Full:
                continue

    def _next_result(self, timeout=None):
        deadline = time.monotonic() + timeout if timeout is not None else None
        while True:
            error = self._injected_error
            if error is not None and self._results_queue.empty():
                self._injected_error = None
                raise error
            heartbeat = self.health_heartbeat
            if heartbeat is not None:
                heartbeat.beat('poll')
            try:
                result = self._results_queue.get(timeout=_POLL_S)
            except queue.Empty:
                if self._all_done():
                    raise EmptyResultError()
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutWaitingForResultError(self._timeout_details(timeout))
                continue
            if isinstance(result, (VentilatedItemProcessedMessage, RowGroupQuarantined)):
                with self._count_lock:
                    self._unprocessed -= 1
                self._ventilator.processed_item()
                if isinstance(result, RowGroupQuarantined):
                    # Skipped, not retried; the sink holds the budget.
                    try:
                        deliver_quarantine(self, result)
                    except Exception:
                        self.stop()
                        self.join()
                        raise
                continue
            if isinstance(result, Exception):
                self.stop()
                self.join()
                raise result
            self._injected_error = None     # results flow again: recovered
            return result

    def _timeout_details(self, timeout):
        with self._count_lock:
            threads = list(self._threads)
        alive = [t.name for t in threads if t.is_alive()]
        dead = [t.name for t in threads if not t.is_alive()]
        with self._count_lock:
            in_flight = self._unprocessed
        return ('No results for {}s. Workers alive: {}; dead: {}. Items in flight: {}. '
                'Respawns used: 0/0 (threads are not respawned).'.format(timeout, alive, dead,
                                                                          in_flight))

    def _all_done(self):
        # Observe `completed` first: after it is set no more ventilation can
        # happen, so the counter and queue reads below cannot miss an item.
        if self._ventilator is None or not self._ventilator.completed():
            return False
        with self._count_lock:
            nothing_in_flight = self._unprocessed == 0
        return nothing_in_flight and self._results_queue.empty() and self._ventilator_queue.empty()

    def stop(self):
        if self._ventilator is not None:
            self._ventilator.stop()
        self._stop_event.set()

    def join(self):
        # Under the resize lock: a grow racing stop() has spawned its
        # workers before the snapshot, so they are reaped too.
        with self._resize_lock:
            with self._count_lock:
                threads = self._threads + self._retired
        for thread in threads:
            thread.join()
        if self._profiling_enabled:
            # A worker that got no item has an empty profile, which
            # pstats refuses.
            profiles = [t.profile for t in threads
                        if t.profile is not None and t.profile.getstats()]
            if profiles:
                pstats.Stats(*profiles).sort_stats('cumulative').print_stats(30)
        with self._count_lock:
            self._threads = []
            self._retired = []
