"""Supervision of the out-of-process pools' workers (counterpart of
``petastorm_tpu/workers/supervision.py:43-310``).

The zmq and shm-ring pools dispatch each ventilated item round-robin to one
worker's channel. When a worker process dies mid-epoch the pool notices on
its next poll, respawns it within a restart budget and re-ventilates
exactly the items that were in flight on it; past the budget it raises
:class:`~petastorm_tpu_torch.errors.WorkerLostError`.

:class:`InFlightRegistry` is the transport-free half: each item gets a
sequence number, each slot remembers its items, and a respawn's duplicates
are dropped. A worker publishes its data *then* its item-processed ack, so
a kill between the two leaves the parent with data of an item it must
still re-ventilate, whose replay publishes the same data again. Every
publish carries ``(seq, chunk_index)``; a pair already delivered is dropped
on re-arrival, and an ack of a seq already acked is ignored. A seq's
delivery record is forgotten at its first ack unless a respawn requeued it,
so memory stays bounded by the restart budget times the items in flight.
"""

import logging
import pickle
import threading
import time
from collections import OrderedDict

from petastorm_tpu_torch.determinism import ResequencedReads
from petastorm_tpu_torch.workers import (EmptyResultError, RowGroupQuarantined,
                                         TimeoutWaitingForResultError,
                                         VentilatedItemProcessedMessage)

logger = logging.getLogger(__name__)

#: Liveness poll throttle inside ``get_results``.
HEALTH_CHECK_INTERVAL_S = 0.25
#: Worker respawns a pool tolerates over its lifetime.
DEFAULT_MAX_WORKER_RESTARTS = 2
#: Seconds a pool waits for its workers' start-up messages.
STARTUP_TIMEOUT_S = 120


class WorkerStarted(object):
    """Control message: worker ``worker_id`` built its worker and waits for
    items."""

    def __init__(self, worker_id):
        self.worker_id = worker_id


class WorkerError(object):
    """Control message: an item raised an error no quarantine takes; the
    consumer stops the pool and raises ``exception``."""

    def __init__(self, exception, traceback_str):
        try:
            pickle.dumps(exception)
        except Exception:  # noqa: BLE001 - any exception that will not pickle
            exception = RuntimeError('{}: {}'.format(type(exception).__name__, exception))
        self.exception = exception
        self.traceback_str = traceback_str


class InFlightRegistry(object):
    """Sequence numbers and each slot's items in flight. ``assign`` runs on
    the ventilator's thread and the rest on the consumer's, so every
    mutation holds one lock."""

    def __init__(self, slots):
        self._lock = threading.Lock()
        self._inflight = [OrderedDict() for _ in range(slots)]
        self._seq_slot = {}
        self._next_seq = 0
        self._rr = 0
        self._delivered = {}   # seq -> delivered chunk indices
        self._maybe_dup = set()

    def assign(self, item):
        """A new item -> ``(seq, slot)``, round-robin."""
        with self._lock:
            seq = self._next_seq
            self._next_seq += 1
            slot = self._rr % len(self._inflight)
            self._rr += 1
            self._inflight[slot][seq] = item
            self._seq_slot[seq] = slot
            return seq, slot

    def requeue(self, seq, item):
        """Dispatch a dead worker's item again -> its new slot. The seq
        stays, so a late copy of its first run's data is a duplicate."""
        with self._lock:
            self._maybe_dup.add(seq)
            slot = self._rr % len(self._inflight)
            self._rr += 1
            self._inflight[slot][seq] = item
            self._seq_slot[seq] = slot
            return slot

    def ack(self, seq):
        """Item-processed ack of ``seq``; False for the stale ack of an item
        already acked (a replay), which must not count again."""
        with self._lock:
            slot = self._seq_slot.pop(seq, None)
            if slot is None:
                self._maybe_dup.discard(seq)
                self._delivered.pop(seq, None)
                return False
            self._inflight[slot].pop(seq, None)
            if seq not in self._maybe_dup:
                self._delivered.pop(seq, None)
            return True

    def mark_delivered(self, seq, chunk_index):
        """About to hand chunk ``chunk_index`` of item ``seq`` over: False
        when exactly that chunk was delivered already (drop it). An
        untagged publish (``seq`` None) always passes."""
        if seq is None:
            return True
        with self._lock:
            chunks = self._delivered.setdefault(seq, set())
            if chunk_index in chunks:
                return False
            chunks.add(chunk_index)
            return True

    def take_slot_items(self, slot):
        """A dead worker's ``(seq, item)`` pairs, removed from its slot."""
        with self._lock:
            items = list(self._inflight[slot].items())
            self._inflight[slot].clear()
            for seq, _ in items:
                self._seq_slot.pop(seq, None)
            return items

    def in_flight_count(self):
        with self._lock:
            return sum(len(d) for d in self._inflight)

    def describe(self):
        """``{slot: [item, ...]}`` (at most 4 a slot) for error messages."""
        with self._lock:
            return {slot: [self.describe_item(item) for item in list(items.values())[:4]]
                    for slot, items in enumerate(self._inflight) if items}

    @staticmethod
    def describe_item(item):
        args, kwargs = item
        if isinstance(kwargs, dict) and 'piece_index' in kwargs:
            return 'piece_index={}'.format(kwargs['piece_index'])
        return repr(args)[:60]


def format_worker_status(processes):
    """``[(slot, pid, exit code or 'alive'), ...]`` for error messages."""
    status = []
    for slot, process in enumerate(processes):
        if process is None:
            status.append((slot, None, 'never-started'))
            continue
        code = process.poll()
        status.append((slot, process.pid, 'alive' if code is None else code))
    return status


class SupervisedPoolMixin(ResequencedReads):
    """The transport-free half of the process pools, shared by the zmq and
    shm pools: ventilation into per-worker queues, the consumer's loop
    (``_next_result``, which :class:`ResequencedReads` resequences in
    deterministic mode), the start-up barrier, and supervision. The pool
    provides its transport:

    * ``_poll_message(timeout_ms)``: the next complete message from any
      worker, ``('control', obj)`` or ``('data', seq, chunk_index,
      frames)``, or None; messages rescued off a dead worker come first;
    * ``_flush_pending()``: send queued work (the consumer's thread owns
      the channels, so a respawn can swap them);
    * ``_rescue_dead_worker_output(slot)``: take in the complete messages
      the dead worker sent, acks processed at once (:meth:`_absorb_ack`);
    * ``_spawn_worker(slot)``: the slot's process, its channel built;
    * ``_respawn_worker_transport(slot)``: a fresh channel and process;
    * ``transport``, ``stop()`` and ``join()``.

    ``_pool_kind`` labels messages.
    """

    _pool_kind = 'Worker'

    def _init_supervision(self, workers_count, serializer, max_worker_restarts):
        if workers_count < 1:
            raise ValueError('workers_count must be >= 1, got {}'.format(workers_count))
        from petastorm_tpu_torch.workers.serializers import PickleSerializer
        self._workers_count = workers_count
        self._serializer = serializer or PickleSerializer()
        self._max_worker_restarts = max_worker_restarts
        self._restarts = 0
        self._last_health_check = 0.0
        self._processes = []
        self._pending_sends = []
        self._send_lock = threading.Lock()
        self._worker_class = None
        self._worker_args = None
        self._ventilator = None
        self._ventilated_unprocessed = 0
        self._count_lock = threading.Lock()
        self._stopped = False
        self._registry = None
        self._injected_error = None
        #: Seconds from the first spawn to the last worker's start-up message.
        self.startup_s = None
        #: Set by a reader with an ``error_budget``: receives each
        #: ``RowGroupQuarantined`` record and raises past the budget.
        self.quarantine_sink = None
        #: The consumer's health heartbeat (``Reader.attach_health``), beaten
        #: ``'poll'`` on each pass of the wait and ``'deliver'`` on each result.
        self.health_heartbeat = None

    @property
    def workers_count(self):
        return self._workers_count

    # -- the consumer's side ------------------------------------------------

    def _start_workers(self, worker_class, worker_args, ventilator):
        """Spawn the workers, wait for each one's start-up message, then
        start ``ventilator``. A worker args pickle failure raises here."""
        if self._processes:
            raise RuntimeError('{} pool already started'.format(self._pool_kind))
        from petastorm_tpu_torch.workers.exec_in_new_process import dumps
        self._worker_class = worker_class
        self._worker_args = worker_args
        self._registry = InFlightRegistry(self._workers_count)
        try:
            if ventilator is not None and ventilator._items:
                # An item the pickler cannot carry fails here, not on the
                # ventilator's thread.
                dumps((0, (), ventilator._items[0]))
            t0 = time.monotonic()
            for worker_id in range(self._workers_count):
                self._pending_sends.append([])
                self._processes.append(self._spawn_worker(worker_id))
            self._await_started(t0)
        except BaseException:
            self.stop()
            self.join()
            raise
        self.startup_s = time.monotonic() - t0
        self._ventilator = ventilator
        if ventilator is not None:
            ventilator._ventilate_fn = self.ventilate
            ventilator.start()

    def _await_started(self, t0):
        started = set()
        while len(started) < self._workers_count:
            if time.monotonic() > t0 + STARTUP_TIMEOUT_S:
                raise RuntimeError('Timed out waiting for {} worker processes to start ({} '
                                   'started)'.format(self._workers_count, len(started)))
            message = self._poll_message(timeout_ms=100)
            if message is None:
                self._check_worker_health(force=True)
            elif message[0] == 'control' and isinstance(message[1], WorkerStarted):
                started.add(message[1].worker_id)
            elif message[0] == 'control':
                self._on_control(message[1])

    def ventilate(self, *args, **kwargs):
        from petastorm_tpu_torch.workers.exec_in_new_process import dumps
        with self._count_lock:
            self._ventilated_unprocessed += 1
        seq, slot = self._registry.assign((args, kwargs))
        # No channel write here: this is the ventilator's thread, and the
        # consumer's thread flushes the queue on every poll.
        self._enqueue_work(slot, dumps((seq, args, kwargs)))

    def _enqueue_work(self, slot, payload):
        with self._send_lock:
            self._pending_sends[slot].append(payload)

    def _next_pending(self, slot):
        with self._send_lock:
            pending = self._pending_sends[slot]
            return pending[0] if pending else None

    def _pop_pending(self, slot):
        with self._send_lock:
            self._pending_sends[slot].pop(0)

    def inject_consumer_error(self, exc):
        """Raise ``exc`` in the consumer's wait while no result arrives (a
        memory breach, a watchdog's stall); a result clears it."""
        self._injected_error = exc

    def _next_result(self, timeout=None):
        deadline = time.monotonic() + timeout if timeout is not None else None
        while True:
            heartbeat = self.health_heartbeat
            if heartbeat is not None:
                heartbeat.beat('poll')
            self._flush_pending()
            self._check_worker_health()
            message = self._poll_message(timeout_ms=50)
            if message is not None:
                if message[0] == 'control':
                    self._on_control(message[1])
                    continue
                _, seq, chunk_index, frames = message
                if not self._registry.mark_delivered(seq, chunk_index):
                    logger.warning('Dropping duplicate data for seq %s chunk %s (respawn '
                                   'replay)', seq, chunk_index)
                    continue
                if heartbeat is not None:
                    heartbeat.beat('deliver')
                self._injected_error = None
                return self._serializer.deserialize(frames)
            error = self._injected_error
            if error is not None:
                self._injected_error = None
                raise error
            if self._all_done():
                raise EmptyResultError()
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutWaitingForResultError(self._timeout_details(timeout))

    def _absorb_ack(self, control):
        """Process an ack or a quarantine record; False for anything else."""
        if isinstance(control, VentilatedItemProcessedMessage):
            self._on_item_processed(control.seq)
            return True
        if isinstance(control, RowGroupQuarantined):
            # A quarantine counts as the item's ack.
            if self._on_item_processed(control.seq):
                self._handle_quarantine(control)
            return True
        return False

    def _on_control(self, control):
        if isinstance(control, WorkerStarted) or self._absorb_ack(control):
            return
        if isinstance(control, WorkerError):
            self.stop()
            self.join()
            logger.error('Worker traceback:\n%s', control.traceback_str)
            raise control.exception
        raise RuntimeError('Unexpected control message: {!r}'.format(control))

    def _all_done(self):
        # Observe `completed` first: after it no more ventilation happens.
        if self._ventilator is not None and not self._ventilator.completed():
            return False
        with self._count_lock:
            return self._ventilated_unprocessed == 0

    @property
    def diagnostics(self):
        with self._count_lock:
            unprocessed = self._ventilated_unprocessed
        diag = {'ventilated_unprocessed': unprocessed, 'workers_count': self._workers_count,
                'transport': self.transport, 'worker_startup_s': self.startup_s}
        diag.update(self._supervision_diagnostics())
        return diag

    # -- supervision ---------------------------------------------------------

    def _discard_pending_work(self, slot):
        with self._send_lock:
            self._pending_sends[slot] = []

    def _on_item_processed(self, seq):
        """Ack bookkeeping; False for a stale duplicate ack."""
        if seq is not None and not self._registry.ack(seq):
            logger.warning('Ignoring duplicate item-processed ack for seq %s', seq)
            return False
        with self._count_lock:
            self._ventilated_unprocessed -= 1
        if self._ventilator is not None:
            self._ventilator.processed_item()
        return True

    def _handle_quarantine(self, record):
        from petastorm_tpu_torch.workers import deliver_quarantine
        try:
            deliver_quarantine(self, record)
        except Exception:
            self.stop()
            self.join()
            raise

    def dead_workers(self):
        """Slots whose process has exited and is not respawned yet (the
        health probe's ``dead_workers``)."""
        return [slot for slot, p in enumerate(self._processes)
                if p is not None and p.poll() is not None]

    def worker_pids(self):
        return [p.pid for p in self._processes if p is not None]

    def _check_worker_health(self, force=False):
        """Respawn dead workers within the budget and re-ventilate their
        items; past it raise ``WorkerLostError``."""
        if self._stopped or not self._processes:
            return
        now = time.monotonic()
        if not force and now - self._last_health_check < HEALTH_CHECK_INTERVAL_S:
            return
        self._last_health_check = now
        for slot, process in enumerate(self._processes):
            if process is not None and process.poll() is not None:
                self._handle_dead_worker(slot, process.returncode)

    def _handle_dead_worker(self, slot, exitcode):
        from petastorm_tpu_torch import metrics
        from petastorm_tpu_torch.errors import WorkerLostError
        from petastorm_tpu_torch.trace import get_global_tracer

        get_global_tracer().instant('worker-lost:{}'.format(slot), cat='fault')
        metrics.counter('pst_worker_deaths_total', 'Pool worker processes found dead').inc()
        self._rescue_dead_worker_output(slot)
        # Discard the slot's unsent work BEFORE taking its in-flight items:
        # an item the ventilator assigns to this slot meanwhile is then either
        # enqueued after the discard (and flushes to the replacement) or taken
        # below and requeued. The other order could drop it and hang the
        # epoch; a double send is absorbed by the (seq, chunk) dedup.
        self._discard_pending_work(slot)
        self._restarts += 1
        stranded = self._registry.take_slot_items(slot)
        if self._restarts > self._max_worker_restarts:
            details = ('{} {} (pid {}) exited with code {} and the restart budget ({}) is '
                       'exhausted. Worker status: {}. Stranded in-flight items: {}.'.format(
                           self._pool_kind, slot, self._processes[slot].pid, exitcode,
                           self._max_worker_restarts, format_worker_status(self._processes),
                           [self._registry.describe_item(item) for _, item in stranded[:6]]))
            self.stop()
            raise WorkerLostError(details)
        logger.warning('%s %d exited with code %s mid-epoch; respawning (%d/%d restarts '
                       'used), re-ventilating %d in-flight item(s)', self._pool_kind, slot,
                       exitcode, self._restarts, self._max_worker_restarts, len(stranded))
        metrics.counter('pst_worker_respawns_total',
                        'Dead pool workers respawned within budget').inc()
        self._respawn_worker_transport(slot)
        from petastorm_tpu_torch.workers.exec_in_new_process import dumps
        for seq, item in stranded:
            new_slot = self._registry.requeue(seq, item)
            self._enqueue_work(new_slot, dumps((seq,) + item))

    def _timeout_details(self, timeout):
        status = format_worker_status(self._processes)
        alive = [(slot, pid) for slot, pid, state in status if state == 'alive']
        dead = [(slot, pid, state) for slot, pid, state in status if state != 'alive']
        return ('No results for {}s. Workers alive: {}; dead: {}. Items in flight: {} '
                '(per-worker sample: {}). Respawns used: {}/{}.'.format(
                    timeout, alive, dead, self._registry.in_flight_count(),
                    self._registry.describe(), self._restarts, self._max_worker_restarts))

    def _supervision_diagnostics(self):
        diag = {'worker_respawns': self._restarts,
                'max_worker_restarts': self._max_worker_restarts,
                'dead_workers': self.dead_workers()}
        if self._registry is not None:
            diag['items_in_flight'] = self._registry.in_flight_count()
        return diag
