"""In-process thread pool with a ventilator feed and a bounded results queue.

Counterpart of ``petastorm_tpu/workers/thread_pool.py:36-461`` at a fixed
size (no resize, quarantine or profiling). ``results_watermark`` arms the
ventilator's backpressure: while that many results wait undelivered, no
new item is fed (the memory governor's shed rung sets it).
``results_nbytes()`` is the governor's ``results-queue`` pool, and
``inject_consumer_error`` hands an error (a memory breach) to a consumer
waiting in ``get_results()``. End of data is the results queue empty AND
every ventilated item processed AND the ventilator completed. A worker's
exception stops the pool and re-raises in the consumer. Results are dicts
and pass through unchanged, each chunk's ``key``, ``det`` tag and
``lineage`` included; with a resequencer set (deterministic mode)
``get_results()`` releases them in ventilation order.
"""

import queue
import threading

from petastorm_tpu_torch.determinism import ResequencedReads
from petastorm_tpu_torch.membudget import approx_nbytes, get_governor
from petastorm_tpu_torch.workers import EmptyResultError, VentilatedItemProcessedMessage

THREAD_PREFIX = 'pstt-pool-worker-'
_POLL_S = 0.01


class _WorkerThread(threading.Thread):
    def __init__(self, pool, worker):
        super().__init__(daemon=True, name='{}{}'.format(THREAD_PREFIX, worker.worker_id))
        self._pool = pool
        self._worker = worker

    def run(self):
        pool = self._pool
        try:
            while not pool._stop_event.is_set():
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
                    try:
                        pool._put_result(e)
                    except _Stopping:
                        return
        finally:
            self._worker.shutdown()


class _Stopping(Exception):
    pass


class ThreadPool(ResequencedReads):
    def __init__(self, workers_count, results_queue_size=50):
        if workers_count < 1:
            raise ValueError('workers_count must be >= 1, got {}'.format(workers_count))
        self._workers_count = workers_count
        self._results_queue = queue.Queue(maxsize=results_queue_size)
        self._ventilator_queue = None
        self._stop_event = threading.Event()
        self._threads = []
        self._ventilator = None
        self._unprocessed = 0
        self._count_lock = threading.Lock()
        #: Undelivered results at which the ventilator holds; None = unarmed.
        self.results_watermark = None
        #: Moving average of one published result's bytes, kept while the
        #: governor is armed (the ``results-queue`` pool is depth x this).
        self.result_nbytes_ema = 0.0
        self._injected_error = None

    @property
    def workers_count(self):
        return self._workers_count

    @property
    def results_qsize(self):
        return self._results_queue.qsize()

    @property
    def results_capacity(self):
        return self._results_queue.maxsize

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

    def start(self, worker_class, worker_args, ventilator):
        if self._threads:
            raise RuntimeError('ThreadPool already started')
        # The ventilator caps unprocessed items at its window, so the queue
        # never legitimately holds more.
        self._ventilator_queue = queue.Queue(maxsize=max(1, ventilator._max_in_flight))
        for worker_id in range(self._workers_count):
            thread = _WorkerThread(self, worker_class(worker_id, self._put_result, worker_args))
            self._threads.append(thread)
            thread.start()
        self._ventilator = ventilator
        ventilator._ventilate_fn = self.ventilate
        ventilator.backpressure_fn = self._results_backpressure
        ventilator.start()

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

    def _next_result(self):
        while True:
            error = self._injected_error
            if error is not None:
                self._injected_error = None
                raise error
            try:
                result = self._results_queue.get(timeout=_POLL_S)
            except queue.Empty:
                if self._all_done():
                    raise EmptyResultError()
                continue
            if isinstance(result, VentilatedItemProcessedMessage):
                with self._count_lock:
                    self._unprocessed -= 1
                self._ventilator.processed_item()
                continue
            if isinstance(result, Exception):
                self.stop()
                self.join()
                raise result
            return result

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
        for thread in self._threads:
            thread.join()
        self._threads = []
