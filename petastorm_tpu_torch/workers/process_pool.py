"""The worker pool of processes over zmq sockets, ``'process-zmq'``
(counterpart of ``petastorm_tpu/workers/process_pool.py:67-475``).

Each worker is a new interpreter (:mod:`~petastorm_tpu_torch.workers.
exec_in_new_process`, never a fork) with its own PUSH socket from the
consumer (so the pool knows which items a dead worker held), the shared
PUB control socket (the ``FINISHED`` broadcast) and the shared PULL results
socket, all bound by ``bind_to_random_port('tcp://127.0.0.1')``: no fixed
port to clash with another test or job. A result is a multipart message
``[header, frame, ...]``: the pickled header says control or data, and a
data header carries the item's ``(seq, chunk index)``; the frames are the
serializer's, sent and received without a copy. The consumer's loop, the
start-up barrier and supervision are :class:`~petastorm_tpu_torch.workers.
supervision.SupervisedPoolMixin`'s. ``pyzmq`` is imported when a pool
starts, so the port imports without it.

The worker side, shared with the shm pool: :func:`run_worker_item` passes
the ``worker-kill`` fault site before each item, then processes, acks or
quarantines it; :func:`start_worker_process` installs the worker's
sidecar tracer under ``PSTT_TRACE_DIR`` and its orphan watch, a daemon
thread ``pstt-orphan-watch`` that ends the process once its parent is gone
(``os.getppid()`` changes; the JAX package asks ``psutil``, which the port
does not need).
"""

import logging
import os
import pickle
import threading
import time

from petastorm_tpu_torch.workers import VentilatedItemProcessedMessage, quarantine_record_for
from petastorm_tpu_torch.workers.exec_in_new_process import exec_in_new_process
from petastorm_tpu_torch.workers.supervision import (DEFAULT_MAX_WORKER_RESTARTS,
                                                     SupervisedPoolMixin, WorkerError,
                                                     WorkerStarted)

logger = logging.getLogger(__name__)

_CONTROL_FINISHED = b'FINISHED'
_SOCKET_LINGER_MS = 1000
_JOIN_REBROADCAST_INTERVAL_S = 0.2
_JOIN_TIMEOUT_S = 30
ORPHAN_WATCH_THREAD = 'pstt-orphan-watch'


def zmq_available():
    try:
        import zmq  # noqa: F401
    except ImportError:
        return False
    return True


class ProcessPool(SupervisedPoolMixin):
    """:param results_queue_size: the results socket's receive high-water
        mark, in messages.
    :param serializer: a :mod:`~petastorm_tpu_torch.workers.serializers`
        instance (default pickle, buffers out of band).
    :param max_worker_restarts: respawns tolerated over the pool's life
        before a further death raises ``WorkerLostError``."""

    _pool_kind = 'Worker'
    transport = 'zmq'

    def __init__(self, workers_count, results_queue_size=50, serializer=None,
                 max_worker_restarts=DEFAULT_MAX_WORKER_RESTARTS):
        self._init_supervision(workers_count, serializer, max_worker_restarts)
        self._results_queue_size = results_queue_size
        self._context = None
        self._worker_sockets = []
        self._control_sender = None
        self._results_receiver = None
        self._control_port = None
        self._results_port = None
        # Messages taken off the results socket while rescuing a dead
        # worker's output; served first.
        self._rescued = []

    def start(self, worker_class, worker_args=None, ventilator=None):
        import zmq
        self._context = zmq.Context()
        self._control_sender = self._context.socket(zmq.PUB)
        self._control_port = self._control_sender.bind_to_random_port('tcp://127.0.0.1')
        self._results_receiver = self._context.socket(zmq.PULL)
        self._results_receiver.set(zmq.RCVHWM, self._results_queue_size)
        self._results_port = self._results_receiver.bind_to_random_port('tcp://127.0.0.1')
        self._start_workers(worker_class, worker_args, ventilator)

    def _spawn_worker(self, worker_id):
        import zmq
        sock = self._context.socket(zmq.PUSH)
        port = sock.bind_to_random_port('tcp://127.0.0.1')
        if worker_id < len(self._worker_sockets):
            self._worker_sockets[worker_id] = sock
        else:
            self._worker_sockets.append(sock)
        return exec_in_new_process(_worker_bootstrap, self._worker_class, worker_id,
                                   self._worker_args, port, self._control_port,
                                   self._results_port, type(self._serializer), os.getpid())

    def _flush_pending(self):
        import zmq
        for slot, sock in enumerate(self._worker_sockets):
            while True:
                payload = self._next_pending(slot)
                if payload is None:
                    break
                try:
                    sock.send(payload, flags=zmq.DONTWAIT)
                except zmq.Again:
                    break       # not connected yet, or at the high-water mark
                self._pop_pending(slot)

    def _poll_message(self, timeout_ms):
        if self._rescued:
            return self._rescued.pop(0)
        if not self._results_receiver.poll(timeout_ms):
            return None
        return _parse_message(self._results_receiver.recv_multipart(copy=False))

    def _rescue_dead_worker_output(self, slot):
        """Drain the results socket before re-ventilating the dead worker's
        items: acks it managed to send must land first, or a completed (or
        quarantined) item would run again. Data, errors and start-up
        messages are kept, in order, for the consumer. The drain is bounded
        in time and count; a straggler past it is still caught by the
        (seq, chunk) dedup."""
        drain_deadline = time.monotonic() + 0.25
        max_stash = len(self._rescued) + 2 * self._results_queue_size
        while (time.monotonic() < drain_deadline and len(self._rescued) < max_stash
               and self._results_receiver.poll(25)):
            message = _parse_message(self._results_receiver.recv_multipart(copy=False))
            if message[0] == 'control' and self._absorb_ack(message[1]):
                continue
            self._rescued.append(message)

    def _respawn_worker_transport(self, slot):
        # The old socket may hold undelivered work; every such item is in
        # flight and about to be requeued, so the socket goes as it is.
        self._worker_sockets[slot].close(linger=0)
        self._processes[slot] = self._spawn_worker(slot)

    def stop(self):
        if self._ventilator is not None:
            self._ventilator.stop()
        self._stopped = True
        if self._control_sender is not None and not self._control_sender.closed:
            self._control_sender.send(_CONTROL_FINISHED)

    def join(self):
        """Rebroadcast ``FINISHED`` until every worker exits (a slow joiner
        misses the first), draining results so none blocks on a full
        socket; a worker still alive after 30 s is killed."""
        if not self._stopped:
            self.stop()
        deadline = time.monotonic() + _JOIN_TIMEOUT_S
        while any(p.poll() is None for p in self._processes):
            if time.monotonic() > deadline:
                for p in self._processes:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
                break
            self._control_sender.send(_CONTROL_FINISHED)
            while self._results_receiver.poll(0):
                self._results_receiver.recv_multipart()
            time.sleep(_JOIN_REBROADCAST_INTERVAL_S)
        for sock in [self._control_sender, self._results_receiver] + self._worker_sockets:
            if sock is not None:
                sock.close(linger=0)
        if self._context is not None:
            self._context.term()
            self._context = None
        self._processes = []
        self._worker_sockets = []
        self._pending_sends = []
        self._rescued = []


def _parse_message(parts):
    header = pickle.loads(parts[0].buffer)
    if isinstance(header, tuple) and header and header[0] == 'data':
        return ('data', header[1], header[2], [part.buffer for part in parts[1:]])
    return ('control', header)


def run_worker_item(worker, seq, args, kwargs, send_control):
    """Process one item in a worker process: the ``worker-kill`` site, then
    the item, then its ack; a failure the reader quarantines becomes its
    record, any other a :class:`WorkerError`."""
    import traceback

    from petastorm_tpu_torch.faults import maybe_inject

    maybe_inject('worker-kill')
    try:
        worker.process(*args, **kwargs)
    except Exception as e:  # noqa: BLE001 - reported to the consumer
        record = quarantine_record_for(worker, e, args, kwargs)
        if record is None:
            send_control(WorkerError(e, traceback.format_exc()))
            return
        record.seq = seq
        logger.warning('Worker %s quarantining item %s: %s', worker.worker_id, record.item,
                       record.error)
        send_control(record)
        return
    send_control(VentilatedItemProcessedMessage(worker.worker_id, seq))


def start_worker_process(worker_id, parent_pid):
    """A worker process's start-up: the card hidden (whatever the worker
    imports later can open no CUDA context), the orphan watch, and the
    sidecar tracer when ``PSTT_TRACE_DIR`` is set (returned, to close at
    exit; else None)."""
    from petastorm_tpu_torch.trace import install_worker_tracer

    os.environ['CUDA_VISIBLE_DEVICES'] = ''

    def watch():
        while True:
            if os.getppid() != parent_pid:
                os._exit(1)
            time.sleep(1)

    threading.Thread(target=watch, daemon=True, name=ORPHAN_WATCH_THREAD).start()
    return install_worker_tracer(role='worker-{}'.format(worker_id))


def make_worker(worker_class, worker_id, publish, worker_args, send_control):
    """The worker object, or None after reporting its constructor's error."""
    import traceback
    try:
        return worker_class(worker_id, publish, worker_args)
    except Exception as e:  # noqa: BLE001 - reported to the consumer
        send_control(WorkerError(e, traceback.format_exc()))
        return None


def _worker_bootstrap(worker_class, worker_id, worker_args, ventilator_port, control_port,
                      results_port, serializer_type, parent_pid):
    """Entry point of a zmq worker process."""
    import zmq

    from petastorm_tpu_torch.faults import maybe_inject

    serializer = serializer_type()
    context = zmq.Context()
    work_receiver = context.socket(zmq.PULL)
    work_receiver.connect('tcp://127.0.0.1:{}'.format(ventilator_port))
    control_receiver = context.socket(zmq.SUB)
    control_receiver.connect('tcp://127.0.0.1:{}'.format(control_port))
    control_receiver.setsockopt(zmq.SUBSCRIBE, b'')
    results_sender = context.socket(zmq.PUSH)
    results_sender.connect('tcp://127.0.0.1:{}'.format(results_port))
    tracer = start_worker_process(worker_id, parent_pid)
    current = [None, 0]     # the item's seq, the next chunk index

    def publish(data):
        maybe_inject('queue-stall')
        header = pickle.dumps(('data', current[0], current[1]))
        current[1] += 1
        results_sender.send_multipart([header] + serializer.serialize(data), copy=False)

    def send_control(obj):
        results_sender.send(pickle.dumps(obj))

    worker = make_worker(worker_class, worker_id, publish, worker_args, send_control)
    if worker is None:
        return
    send_control(WorkerStarted(worker_id))
    poller = zmq.Poller()
    poller.register(work_receiver, zmq.POLLIN)
    poller.register(control_receiver, zmq.POLLIN)
    from petastorm_tpu_torch.workers.exec_in_new_process import loads
    try:
        while True:
            socks = dict(poller.poll())
            if socks.get(control_receiver) == zmq.POLLIN \
                    and control_receiver.recv() == _CONTROL_FINISHED:
                break
            if socks.get(work_receiver) == zmq.POLLIN:
                seq, args, kwargs = loads(work_receiver.recv())
                current[0], current[1] = seq, 0
                run_worker_item(worker, seq, args, kwargs, send_control)
                current[0] = None
    finally:
        worker.shutdown()
        if tracer is not None:
            tracer.close()
        for sock in (work_receiver, control_receiver, results_sender):
            sock.close(linger=_SOCKET_LINGER_MS)
        context.term()
