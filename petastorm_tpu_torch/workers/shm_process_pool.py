"""The worker pool of processes over shared-memory rings, ``'process-shm'``
(counterpart of ``petastorm_tpu/workers/shm_process_pool.py:74-499``).

The protocol and the consumer's side are :class:`~petastorm_tpu_torch.
workers.process_pool.ProcessPool`'s; each worker's channels are two mmapped
single-producer single-consumer rings (:mod:`~petastorm_tpu_torch.native.
shm_ring`): no socket and no system call on the steady path.

Channels of worker i, generation g (bumped on every respawn):

- work ring ``/pstt_<pid>_<uid>_<i>_g<g>_in``, parent to worker: pickled
  ``(seq, args, kwargs)``;
- result ring ``/pstt_<pid>_<uid>_<i>_g<g>_out``, worker to parent, a tag
  byte then its payload:

  - ``C``: a pickled control message (started, processed, quarantine,
    error);
  - ``S``: the header of a data payload, little-endian int64s: the item's
    seq (-1 when untagged), the chunk index, the number of frames and each
    frame's length;
  - ``P`` and ``D``: the frames' bytes, in pieces of at most half the ring
    less a page (a decoded 256-row ImageNet row-group, 38.5 MB, exceeds half
    of a 64 MB ring); ``D`` is the last piece. Pieces of one payload are
    contiguous in their ring, so the consumer copies each into one buffer
    that the payload's arrays then view, and needs no size limit.

``FINISHED`` is the flag word set on both rings: a worker blocked writing
into a full ring aborts with ``RingClosed``, so shutdown cannot deadlock.
On a worker's death its result ring is drained before it is replaced:
complete messages the dead worker wrote survive (its acks are processed
at once), so delivery stays exactly-once. Ring bytes are reserved when a
ring is made: a ring the shm mount cannot hold raises ``OSError`` naming the
mount's free bytes, in the constructor.
"""

import logging
import os
import pickle
import struct
import time
import uuid
from collections import deque

import numpy as np

from petastorm_tpu_torch.workers.exec_in_new_process import exec_in_new_process
from petastorm_tpu_torch.workers.process_pool import (make_worker, run_worker_item,
                                                      start_worker_process)
from petastorm_tpu_torch.workers.supervision import (DEFAULT_MAX_WORKER_RESTARTS,
                                                     SupervisedPoolMixin, WorkerStarted)

logger = logging.getLogger(__name__)

_FLAG_FINISHED = 1
_TAG_CONTROL = ord('C')
_TAG_HEADER = ord('S')
_TAG_PIECE = ord('P')
_TAG_LAST = ord('D')
_WORK_RING_BYTES = 1 << 20          # pickled work items are small
DEFAULT_RESULT_RING_BYTES = 64 << 20
_JOIN_TIMEOUT_S = 30


def shm_transport_available():
    from petastorm_tpu_torch.native import shm_ring
    return shm_ring.available()


def _ring_names(base, worker_id, generation):
    prefix = '{}_{}_g{}'.format(base, worker_id, generation)
    return prefix + '_in', prefix + '_out'


class _Assembly(object):
    """A data payload being read off one result ring."""

    __slots__ = ('seq', 'chunk_index', 'lengths', 'buffer', 'offset')

    def __init__(self, header):
        seq, self.chunk_index, n = struct.unpack_from('<qqq', header)
        self.seq = None if seq < 0 else seq
        self.lengths = struct.unpack_from('<{}q'.format(n), header, 24)
        self.buffer = np.empty(sum(self.lengths), dtype=np.uint8)
        self.offset = 0

    def frames(self):
        view = memoryview(self.buffer)
        out, start = [], 0
        for length in self.lengths:
            out.append(view[start:start + length])
            start += length
        return out


class ShmProcessPool(SupervisedPoolMixin):
    """:param result_ring_bytes: each worker's result ring (reserved in
        the shm mount when the pool starts); payloads of any size stream
        through it in pieces.
    :param max_worker_restarts: respawns tolerated over the pool's life
        before a further death raises ``WorkerLostError``."""

    _pool_kind = 'Shm worker'
    transport = 'shm_ring'

    def __init__(self, workers_count, results_queue_size=50, serializer=None,
                 result_ring_bytes=DEFAULT_RESULT_RING_BYTES,
                 max_worker_restarts=DEFAULT_MAX_WORKER_RESTARTS):
        del results_queue_size  # bounded by the ring's bytes, not a count
        self._init_supervision(workers_count, serializer, max_worker_restarts)
        self.result_ring_bytes = int(result_ring_bytes)
        self._base = None
        self._generations = []
        self._work_rings = []
        self._result_rings = []
        self._poll_cursor = 0
        self._assembly = {}        # slot -> _Assembly being read
        self._rescued = deque()    # messages taken off dead workers' rings

    def start(self, worker_class, worker_args=None, ventilator=None):
        from petastorm_tpu_torch.native.shm_ring import SEGMENT_PREFIX
        self._base = '/{}{}_{}'.format(SEGMENT_PREFIX, os.getpid(), uuid.uuid4().hex[:8])
        self._generations = [0] * self._workers_count
        try:
            for worker_id in range(self._workers_count):
                self._make_rings(worker_id)
        except Exception:
            self._close_rings()
            raise
        self._start_workers(worker_class, worker_args, ventilator)

    def _make_rings(self, slot):
        from petastorm_tpu_torch.native.shm_ring import ShmRing
        in_name, out_name = _ring_names(self._base, slot, self._generations[slot])
        rings = (ShmRing.create(in_name, _WORK_RING_BYTES),)
        try:
            rings += (ShmRing.create(out_name, self.result_ring_bytes),)
        except Exception:
            rings[0].close()
            raise
        if slot < len(self._work_rings):
            self._work_rings[slot], self._result_rings[slot] = rings
        else:
            self._work_rings.append(rings[0])
            self._result_rings.append(rings[1])

    def _spawn_worker(self, worker_id):
        in_name, out_name = _ring_names(self._base, worker_id, self._generations[worker_id])
        return exec_in_new_process(_shm_worker_bootstrap, self._worker_class, worker_id,
                                   self._worker_args, in_name, out_name,
                                   type(self._serializer), os.getpid())

    def _flush_pending(self):
        from petastorm_tpu_torch.native.shm_ring import RingClosed, RingTimeout
        for slot, ring in enumerate(self._work_rings):
            while True:
                payload = self._next_pending(slot)
                if payload is None:
                    break
                try:
                    ring.write(payload, timeout_ms=0)
                except (RingTimeout, RingClosed):
                    break       # full, or tearing down: the next poll retries
                self._pop_pending(slot)

    def _read_ring_once(self, slot):
        """One message off ``slot``'s result ring: None (nothing complete
        yet), ``('again',)`` (took a header or a piece), or a message of
        ``_poll_message``'s form."""
        from petastorm_tpu_torch.native.shm_ring import RingClosed
        ring = self._result_rings[slot]
        try:
            head = ring.peek()
        except RingClosed:
            return None
        if head is None:
            return None
        tag, length = head
        if tag == _TAG_HEADER:
            self._assembly[slot] = _Assembly(bytes(ring.read(skip=1)))
            return ('again',)
        if tag in (_TAG_PIECE, _TAG_LAST):
            asm = self._assembly[slot]
            asm.offset += ring.pop_into(asm.buffer[asm.offset:asm.offset + length - 1], skip=1)
            if tag == _TAG_PIECE:
                return ('again',)
            del self._assembly[slot]
            if asm.offset != len(asm.buffer):
                raise RuntimeError('shm ring payload of {} bytes ended at {}'.format(
                    len(asm.buffer), asm.offset))
            return ('data', asm.seq, asm.chunk_index, asm.frames())
        if tag == _TAG_CONTROL:
            return ('control', pickle.loads(ring.read(skip=1)))
        raise RuntimeError('Unexpected shm ring tag {!r}'.format(chr(tag)))

    def _poll_message(self, timeout_ms):
        if self._rescued:
            return self._rescued.popleft()
        deadline = time.monotonic() + timeout_ms / 1000.0
        while True:
            for _ in range(self._workers_count):
                slot = self._poll_cursor % self._workers_count
                # Advance before reading, so one busy ring does not hold the
                # sweep while the others' bounded rings stall their workers.
                self._poll_cursor += 1
                while True:
                    message = self._read_ring_once(slot)
                    if message is None or message[0] != 'again':
                        break
                if message is not None:
                    return message
            if time.monotonic() >= deadline:
                return None
            time.sleep(0.001)

    def _rescue_dead_worker_output(self, slot):
        """Drain the dead worker's result ring before it is discarded:
        complete messages survive (a torn trailing write is invisible to a
        read), acks are processed at once so their items are not re-run."""
        while True:
            message = self._read_ring_once(slot)
            if message is None:
                break
            if message[0] == 'again' or (message[0] == 'control'
                                         and self._absorb_ack(message[1])):
                continue
            self._rescued.append(message)
        self._assembly.pop(slot, None)

    def _respawn_worker_transport(self, slot):
        self._work_rings[slot].close()
        self._result_rings[slot].close()
        self._generations[slot] += 1
        self._make_rings(slot)
        self._processes[slot] = self._spawn_worker(slot)

    def stop(self):
        if self._ventilator is not None:
            self._ventilator.stop()
        self._stopped = True
        # FINISHED on both rings: aborts any blocked worker write.
        for ring in self._work_rings + self._result_rings:
            ring.set_flags(_FLAG_FINISHED)

    def join(self):
        if not self._stopped:
            self.stop()
        deadline = time.monotonic() + _JOIN_TIMEOUT_S
        while time.monotonic() < deadline and any(p.poll() is None for p in self._processes):
            time.sleep(0.05)
        for process in self._processes:
            if process.poll() is None:
                process.kill()
                process.wait()
        self._close_rings()
        self._processes = []
        self._pending_sends = []
        self._assembly = {}
        self._rescued = deque()

    def _close_rings(self):
        for ring in self._work_rings + self._result_rings:
            ring.close()
        self._work_rings = []
        self._result_rings = []


def _shm_worker_bootstrap(worker_class, worker_id, worker_args, in_name, out_name,
                          serializer_type, parent_pid):
    """Entry point of a shm worker process."""
    from petastorm_tpu_torch.faults import maybe_inject
    from petastorm_tpu_torch.native.shm_ring import RingClosed, ShmRing
    from petastorm_tpu_torch.workers.exec_in_new_process import loads

    serializer = serializer_type()
    work_ring = ShmRing.open(in_name)
    result_ring = ShmRing.open(out_name)
    tracer = start_worker_process(worker_id, parent_pid)
    # Pieces stay under half the ring, less a page for framing.
    piece_limit = max(4096, result_ring.capacity // 2 - 4096)
    current = [None, 0]     # the item's seq, the next chunk index

    def send_control(obj):
        result_ring.write(pickle.dumps(obj), tag=b'C')

    def publish(data):
        maybe_inject('queue-stall')
        frames = [memoryview(f).cast('B') for f in serializer.serialize(data)]
        seq = -1 if current[0] is None else current[0]
        lengths = [f.nbytes for f in frames]
        result_ring.write(struct.pack('<qqq{}q'.format(len(frames)), seq, current[1],
                                      len(frames), *lengths), tag=b'S')
        current[1] += 1
        pieces = [f[start:start + piece_limit] for f in frames
                  for start in range(0, f.nbytes, piece_limit)]
        for i, piece in enumerate(pieces):
            result_ring.write(piece, tag=b'D' if i == len(pieces) - 1 else b'P')

    worker = make_worker(worker_class, worker_id, publish, worker_args, send_control)
    if worker is None:
        return
    send_control(WorkerStarted(worker_id))
    try:
        while not work_ring.get_flags() & _FLAG_FINISHED:
            item = work_ring.read(timeout_ms=100)
            if item is None:
                continue
            seq, args, kwargs = loads(item)
            current[0], current[1] = seq, 0
            run_worker_item(worker, seq, args, kwargs, send_control)
            current[0] = None
    except RingClosed:
        pass
    finally:
        worker.shutdown()
        if tracer is not None:
            tracer.close()
        work_ring.close()
        result_ring.close()
