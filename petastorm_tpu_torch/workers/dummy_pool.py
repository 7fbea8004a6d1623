"""Single-threaded synchronous pool: the work happens on the consumer's
thread inside ``get_results()`` (counterpart of
``petastorm_tpu/workers/dummy_pool.py``). A worker's exception raises in
the consumer, or, turned into a quarantine record (a reader with an
``error_budget``), goes to ``quarantine_sink``. For
debugging, deterministic tests and profiles of the whole path in one
thread. Items run in ventilation order, so a resequencer set on it
(deterministic mode) only checks the order."""

from collections import deque

from petastorm_tpu_torch.determinism import ResequencedReads
from petastorm_tpu_torch.workers import (EmptyResultError, deliver_quarantine,
                                         quarantine_record_for)


class DummyPool(ResequencedReads):
    workers_count = 1

    def __init__(self):
        self._results = deque()
        self._ventilated = deque()
        self._worker = None
        self._ventilator = None
        self._stopped = False
        #: Set by a reader with an ``error_budget``.
        self.quarantine_sink = None

    def start(self, worker_class, worker_args, ventilator):
        if self._worker is not None:
            raise RuntimeError('DummyPool already started')
        self._worker = worker_class(0, self._results.append, worker_args)
        self._ventilator = ventilator
        ventilator._ventilate_fn = self.ventilate
        ventilator.start(threaded=False)

    def ventilate(self, *args, **kwargs):
        self._ventilated.append((args, kwargs))

    def _next_result(self, timeout=None):
        """The next result; a worker's exception raises here. ``timeout``
        is moot: the work runs on this thread."""
        while not self._results:
            if self._stopped or (not self._ventilated and not self._ventilator.pump()):
                raise EmptyResultError()
            args, kwargs = self._ventilated.popleft()
            try:
                self._worker.process(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 - raised below unless quarantined
                record = quarantine_record_for(self._worker, e, args, kwargs)
                if record is None:
                    raise
                self._ventilator.processed_item()
                deliver_quarantine(self, record)
                continue
            self._ventilator.processed_item()
        return self._results.popleft()

    @property
    def diagnostics(self):
        return {'output_queue_size': len(self._results),
                'ventilation_queue_size': len(self._ventilated)}

    def stop(self):
        if not self._stopped:
            self._stopped = True
            if self._ventilator is not None:
                self._ventilator.stop()
            if self._worker is not None:
                self._worker.shutdown()

    def join(self):
        pass
