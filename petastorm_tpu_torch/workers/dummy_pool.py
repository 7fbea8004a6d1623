"""Single-threaded synchronous pool: the work happens on the consumer's
thread inside ``get_results()`` (counterpart of
``petastorm_tpu/workers/dummy_pool.py``, without quarantine). For
debugging, deterministic tests and profiles of the whole path in one
thread. Items run in ventilation order, so a resequencer set on it
(deterministic mode) only checks the order."""

from collections import deque

from petastorm_tpu_torch.determinism import ResequencedReads
from petastorm_tpu_torch.workers import EmptyResultError


class DummyPool(ResequencedReads):
    workers_count = 1

    def __init__(self):
        self._results = deque()
        self._ventilated = deque()
        self._worker = None
        self._ventilator = None
        self._stopped = False

    def start(self, worker_class, worker_args, ventilator):
        if self._worker is not None:
            raise RuntimeError('DummyPool already started')
        self._worker = worker_class(0, self._results.append, worker_args)
        self._ventilator = ventilator
        ventilator._ventilate_fn = self.ventilate
        ventilator.start(threaded=False)

    def ventilate(self, *args, **kwargs):
        self._ventilated.append((args, kwargs))

    def _next_result(self):
        """The next result; a worker's exception raises here."""
        while not self._results:
            if self._stopped or (not self._ventilated and not self._ventilator.pump()):
                raise EmptyResultError()
            args, kwargs = self._ventilated.popleft()
            self._worker.process(*args, **kwargs)
            self._ventilator.processed_item()
        return self._results.popleft()

    def stop(self):
        if not self._stopped:
            self._stopped = True
            if self._ventilator is not None:
                self._ventilator.stop()
            if self._worker is not None:
                self._worker.shutdown()

    def join(self):
        pass
