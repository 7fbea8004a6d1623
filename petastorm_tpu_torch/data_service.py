"""The data service: decode on CPU hosts, train on the GPU host
(counterpart of ``petastorm_tpu/data_service.py``).

A trainer whose host has too few cores for its decode can only buy more
local cores while the reader runs in its process. This module moves the
reader into a server process (on the same host or another) and streams its
decoded chunks over zmq:

* :class:`DataServer` owns a batched reader (``make_tensor_reader``, or
  ``make_batch_reader`` for plain stores; per-row readers are refused) and
  republishes its chunks on a **PUSH** socket, which fair-queues them over
  the connected consumers (dynamic sharding: a slow trainer takes fewer
  chunks). A **PUB** control socket carries lease heartbeats and the
  end-of-data broadcast (with the server's served-chunk count); a **REP**
  rpc socket answers attach, checkpoint, stats, drain and metrics requests.
* :class:`RemoteReader` is the trainer's side: it pulls from one or many
  servers and offers the reader surface
  :class:`~petastorm_tpu_torch.loader.TorchLoader` consumes
  (``batched_output``, namedtuple chunks, ``stop``/``join``, the
  row-granular checkpoint protocol, ``attach_health``), plus
  :meth:`RemoteReader.state_dict` for a checkpoint across the service.

Semantics against an in-process reader:

* Sharding is by pull order, so shard servers, not trainers.
* The end of a stream is exact by default: a sole consumer checks its
  received total against the servers' advertised counts and raises on a
  shortfall. Several consumers on one stream pass ``shared_stream=True``
  and end on a silence window; :func:`checkpoint_shared_stream` and
  :func:`verify_shared_stream_complete` restore exactness for them.
* :meth:`RemoteReader.state_dict` pauses each server at a chunk boundary,
  drains the chunks in flight into the state and snapshots each server
  reader's ``state_dict``; restart servers with
  ``serve_dataset(..., resume_state=state['server_states'][i])`` and the
  trainer with ``RemoteReader(..., resume_state=state)``: no row is
  delivered twice and none is lost.
* Every chunk leads with a meta frame ``(server_id, seq)``; consumers drop
  duplicates, which makes the replay of a restarted server exact. A server
  built with ``snapshot_path=`` snapshots itself (reader position, identity
  and a ring of its latest chunk frames); ``serve_dataset(...,
  snapshot_resume=path)`` restarts it under its original identity after a
  SIGKILL.
* The payload's transport is negotiated per consumer session
  (:mod:`~petastorm_tpu_torch.fleet.wire`): a shm segment ring for a
  co-located sole consumer, Arrow IPC otherwise, pickle protocol 5 for a
  consumer that never negotiates. Received blocks are **read-only** views
  (over zmq frames, an Arrow buffer or the shm segment): the loader copies
  them into its arenas and never writes into them.

The frames, rpc shapes and heartbeats are the JAX package's byte for byte:
a port consumer reads a JAX server's stream and the reverse. Environment
variables take the port's prefix (``PSTT_LEASE_S``, ``PSTT_RECONNECT_S``,
``PSTT_FLEET_JOB``, ``PSTT_WIRE``, ``PSTT_WIRE_SEGMENT_MB``); threads are
named ``pstt-data-service-*``. ``tcp://`` endpoints derive the control and
rpc sockets at the data port + 1 and + 2, as in the JAX package; an
``ipc://<path>`` endpoint derives ``ipc://<path>.1`` and ``ipc://<path>.2``
(the JAX package needs them passed), which takes no TCP port. This module
imports no torch.

**Trust boundary**: chunk headers, rpc requests and replies, and resume
snapshots are **pickle**; unpickling bytes from an attacker runs their code.
Run the sockets on a trusted network (loopback, ``ipc://`` or a private
fabric). With a shared ``auth_key`` every control message, rpc body and
chunk carries a keyed BLAKE2b MAC checked before anything is unpickled; the
key authenticates, it does not encrypt.
"""

import logging
import os
import pickle
import struct
import threading
import time

from petastorm_tpu_torch.fleet import control_plane
from petastorm_tpu_torch.fleet import wire as wire_mod
from petastorm_tpu_torch.utils import cached_namedtuple

logger = logging.getLogger(__name__)

_CTRL_END = b'PST_END'
_CTRL_ERR = b'PST_ERR'
# Lease heartbeat on the control PUB socket: ``PST_HB`` + packed
# (server_id, lease_s, state code) + the server's rpc endpoint (utf-8)
# [+ fleet announce tail]. A consumer that has seen one heartbeat and
# then none for ``lease_s`` treats the lease as EXPIRED — the fleet's
# dead-server signal, replacing per-tick rpc liveness probes (a dead
# server cannot renew; a merely slow one still heartbeats from its
# control thread). The wire constants, announce codec, admission
# ledger, and drain state machine are the shared control plane in
# petastorm_tpu_torch.fleet.control_plane — this module composes it; the
# aliases keep the wire spellings importable from here.
_CTRL_HB = control_plane.CTRL_HB
_HB_STRUCT = control_plane.HB_STRUCT
_STATE_CODES = control_plane.STATE_CODES
_STATE_NAMES = control_plane.STATE_NAMES
_SERVER_ID_LEN = 16
_COUNT_STRUCT = struct.Struct('<Q')
_META_STRUCT = struct.Struct('<16sQ')   # (server_id, chunk seq)
_MAC_LEN = control_plane.MAC_LEN

#: Server lease duration (seconds): heartbeats go out every third of it,
#: consumers declare a server dead one full lease after its last
#: heartbeat. Override per server via ``DataServer(lease_s=)``.
ENV_LEASE = control_plane.ENV_LEASE
DEFAULT_LEASE_S = control_plane.DEFAULT_LEASE_S
#: Sole-consumer reconnect window (seconds): after a server's lease
#: expires, how long the consumer keeps polling for a replacement (a
#: restarted or cursor-resumed server) before raising. 0 disables
#: reconnect-with-resume (lease expiry then raises immediately).
ENV_RECONNECT = 'PSTT_RECONNECT_S'
DEFAULT_RECONNECT_S = 60.0

_env_float = control_plane.env_float
#: After a liveness probe finds an endpoint unreachable (whole rpc retry
#: budget unanswered), further probes report it dead from memory for this
#: long instead of re-paying the budget — a watchdog sweeping every tick
#: must stay bounded even on sole-consumer streams where no failover
#: permanently retires the endpoint.
_PROBE_DEAD_BACKOFF_S = 30.0
#: A control-thread rpc polls for its reply in slices of this many ms,
#: checking between them whether the reader was stopped.
_CONTROL_POLL_MS = 50
_MISSING = object()


class RpcUnanswered(Exception):
    """One REQ/REP attempt produced no reply within its window. Retried
    through the reader's rpc retry policy; only a server that misses the
    whole budget is treated as dead (a single dropped REP is just slow)."""


# Keyed, length-framed chunk/heartbeat MAC — the shared control plane
# owns the implementation (same framing, same digest size) so the data
# plane and the fleet registry verify identical bytes.
_mac = control_plane.mac
_mac_ok = control_plane.mac_ok


def _dump_frames(cols):
    """dict of numpy blocks -> [header, buf0, buf1, ...] zmq frames.

    Protocol-5 out-of-band pickling: the header holds the dict structure
    and array metadata; each column's bytes ride in their own frame,
    never copied into an intermediate blob.
    """
    buffers = []
    header = pickle.dumps(cols, protocol=5, buffer_callback=buffers.append)
    return [header] + [b.raw() for b in buffers]


def _load_frames(frames):
    """Inverse of :func:`_dump_frames` over received zmq frames (zero-copy:
    arrays alias the frame memory and are read-only)."""
    head = frames[0]
    head = head.buffer if hasattr(head, 'buffer') else head
    bufs = [f.buffer if hasattr(f, 'buffer') else f for f in frames[1:]]
    return pickle.loads(head, buffers=bufs)


def _check_batched(reader):
    if not getattr(reader, 'batched_output', False):
        # RemoteReader presents the stream as batched chunks; a per-row
        # reader would ship one tiny pickle per ROW and the trainer-side
        # TorchLoader would mis-treat scalars as columns.
        raise ValueError(
            'DataServer requires a batched reader (make_tensor_reader / '
            'make_batch_reader); got a per-row reader. Per-row decode '
            'belongs on the trainer for row-granular pipelines.')


class DataServer(object):
    """Serve a Reader's output stream to remote trainers.

    :param reader: a batched petastorm_tpu Reader — ``make_tensor_reader``
        (recommended: decoded columnar chunks amortize serialization) or
        ``make_batch_reader``. Per-row readers raise ``ValueError``.
    :param bind: zmq endpoint for data, e.g. ``'tcp://*:5555'``.
    :param control_bind: endpoint for the end-of-data broadcast (default:
        data port + 1 when ``bind`` is tcp with an explicit port).
    :param rpc_bind: endpoint for the checkpoint/stats REP socket
        (default: data port + 2).
    :param sndhwm: per-consumer high-water mark (chunks buffered in zmq
        before the server blocks — the service's backpressure).
    :param auth_key: optional shared secret (bytes). When set, control
        broadcasts, rpc traffic, and whole chunks (meta, header, and
        payload buffers) carry a keyed-BLAKE2b mac, verified BEFORE
        unpickling (see the module trust-boundary note). Consumers must
        pass the same key.
    :param snapshot_path: when set, the server self-snapshots to this
        path (atomically) every ``snapshot_every`` chunks: reader
        position + identity + a replay ring of recent chunk frames, so
        an UNPLANNED death (SIGKILL) can be recovered via
        ``snapshot_resume`` with no lost rows. The ring keeps the last
        ``sndhwm + 4`` chunks' frames alive in memory — size chunks
        accordingly. **Requires a chunk-deterministic reader config**:
        seq-based dedupe assumes a resumed reader re-produces the same
        chunks in the same order past the snapshot point, so use
        ``workers_count=1`` (a ventilated multi-worker pool completes
        row groups in nondeterministic order; a replayed seq could then
        carry different rows than the original and be wrongly deduped).
        Replayed chunks are deduped per consumer by
        ``(server_id, seq)``; with SEVERAL shared-stream consumers a
        replayed chunk can land on a different consumer than the
        original did, so a crash can duplicate rows across consumers
        within the ring window (a sole consumer sees exactly-once).
    :param snapshot_every: snapshot cadence in chunks (default 16).
    :param replay_ring_chunks: replay-ring depth (default ``sndhwm + 4``,
        sized for ONE consumer). zmq PUSH queues up to ``sndhwm`` chunks
        per consumer pipe, so with N consumers a SIGKILL can strand up to
        ``N * sndhwm`` sent-but-undelivered chunks — pass at least that
        plus slack or recovery can lose the oldest of them.
    :param snapshot_resume: a loaded snapshot dict (see
        :func:`load_server_snapshot`) — restores the server's identity
        and served-count, and queues the ring for re-send. The READER
        must separately be built from the snapshot's ``reader_state``
        (``serve_dataset(snapshot_resume=path)`` wires both).
    :param bind_retry_policy: a custom
        :class:`petastorm_tpu_torch.retry.RetryPolicy` for the wildcard-bind
        retry loop (derived control/rpc ports may clash with unrelated
        sockets); defaults to a short jittered-backoff policy retrying
        only ``zmq.ZMQError``.
    :param lineage: ship each chunk's provenance segment on the wire
        (``petastorm_tpu_torch.lineage``; default True). Set False while any
        consumer predates the sidecar — an old trainer crashes unpacking
        the reserved ``__pst_lineage__`` key.
    """

    def __init__(self, reader, bind, control_bind=None, rpc_bind=None,
                 sndhwm=4, auth_key=None, snapshot_path=None,
                 snapshot_every=16, snapshot_resume=None,
                 replay_ring_chunks=None, bind_retry_policy=None,
                 lineage=True, lease_s=None, max_consumers=None,
                 reader_builder=None, job_id=None, tenants=None,
                 wire=None):
        import zmq

        if (reader is None) == (reader_builder is None):
            raise ValueError('pass exactly one of reader / reader_builder '
                             '(reader_builder defers the reader build until '
                             'the first consumer attaches with its resume '
                             'cursor — see serve_dataset(await_cursor=True))')
        if reader is not None:
            _check_batched(reader)
        self._reader = reader
        self._reader_builder = reader_builder
        # The provenance sidecar adds a reserved '__pst_lineage__' key to
        # every wire payload; consumers older than it crash unpacking the
        # chunk (underscore namedtuple field), so a mixed-version fleet
        # disables it server-side until every trainer is upgraded.
        self._lineage_enabled = bool(lineage)
        self._zmq = zmq
        from petastorm_tpu_torch import metrics as metrics_mod
        self._m_served = metrics_mod.counter(
            'pst_data_service_chunks_served_total',
            'Chunks this data-service server pushed to consumers')
        self._context = zmq.Context.instance()
        # A wildcard data bind derives control = port+1 and rpc = port+2,
        # and either derived port may already be taken by an unrelated
        # socket — retry on a fresh wildcard port rather than flaking.
        # Explicit ports get exactly one attempt (the caller chose them).
        # The loop itself is the shared retry.RetryPolicy (short jittered
        # backoff so two servers racing for the same derived ports don't
        # re-collide in lockstep); only zmq bind errors are retryable —
        # _bind_once re-raises anything else untouched.
        wildcard = bind.rstrip().endswith(':*')
        derives_ports = control_bind is None or rpc_bind is None
        attempts = 16 if wildcard and derives_ports else 1

        def _bind_once():
            self._data_sock = self._context.socket(zmq.PUSH)
            self._ctrl_sock = None
            self._rpc_sock = None
            try:
                self._data_sock.setsockopt(zmq.SNDHWM, sndhwm)
                self._data_sock.bind(bind)
                # Resolve wildcard ports ('tcp://127.0.0.1:*') to the
                # actual bind.
                actual = self._data_sock.getsockopt(zmq.LAST_ENDPOINT).decode()
                ctrl_endpoint = (control_bind if control_bind is not None
                                 else _next_port_endpoint(actual))
                self._ctrl_sock = self._context.socket(zmq.PUB)
                self._ctrl_sock.bind(ctrl_endpoint)
                rpc_endpoint = (rpc_bind if rpc_bind is not None
                                else _next_port_endpoint(actual, 2))
                self._rpc_sock = self._context.socket(zmq.REP)
                self._rpc_sock.bind(rpc_endpoint)
                return actual
            except Exception:
                # Close whatever bound so the ports don't stay held by the
                # shared zmq context.
                for sock in (self._data_sock, self._ctrl_sock, self._rpc_sock):
                    if sock is not None:
                        sock.close(linger=0)
                raise

        if bind_retry_policy is None:
            from petastorm_tpu_torch.retry import RetryPolicy
            bind_retry_policy = RetryPolicy(
                max_attempts=attempts, base_delay_s=0.01, max_delay_s=0.25,
                retry_exceptions=(zmq.ZMQError,))
        actual = bind_retry_policy.call(_bind_once,
                                        retry_call_name='data-service-bind')
        self.data_endpoint = _connectable(actual)
        self.control_endpoint = _connectable(
            self._ctrl_sock.getsockopt(zmq.LAST_ENDPOINT).decode())
        self.rpc_endpoint = _connectable(
            self._rpc_sock.getsockopt(zmq.LAST_ENDPOINT).decode())
        self._thread = None
        self._rpc_thread = None
        self._stop = threading.Event()
        self._serving_done = threading.Event()
        # Wakes the control loop out of its heartbeat sleep the moment
        # the serve thread posts the END marker — consumers otherwise
        # learn the stream ended only at the next heartbeat tick (up to
        # 250ms), a fixed tail every epoch pays.
        self._ctrl_wake = threading.Event()
        # Checkpoint pause handshake: the (single) rpc thread sets _pause
        # and bumps _pause_gen; the serve loop parks at its next chunk
        # boundary and acknowledges by copying the generation into
        # _paused_gen. Generations only grow, so a stale acknowledgement
        # from an earlier pause cycle can never satisfy a newer
        # pause_state (a bare parked/not-parked flag could — the clear is
        # not atomic with the loop's boundary check).
        self._pause = threading.Event()
        self._pause_gen = 0
        self._paused_gen = 0
        self._served_chunks = 0
        self._last_snapshot = (None, None)      # (sent, monotonic time)
        self._auth_key = auth_key
        self._snapshot_path = snapshot_path
        self._snapshot_every = max(1, int(snapshot_every))
        # Replay ring: the raw frames of the most recent chunks. A SIGKILL
        # loses at most the zmq userland send queue (TCP-buffered bytes of
        # a dead process still get flushed by the kernel) — and PUSH
        # queues up to ``sndhwm`` PER consumer pipe, so the default depth
        # covers one consumer; topologies with N consumers must pass
        # ``replay_ring_chunks >= N * sndhwm + slack`` for the recovery
        # to stay lossless.
        from collections import deque
        if replay_ring_chunks is None:
            replay_ring_chunks = sndhwm + 4
        # maxlen=0 when snapshots are off: the ring pins chunk frames in
        # memory and only ever feeds _write_snapshot — no reason to retain
        # hundreds of MB of frames for a disabled feature.
        self._ring = deque(
            maxlen=replay_ring_chunks if snapshot_path is not None else 0)
        self._replay = []
        import uuid
        # END messages carry the server's identity: a client connected to N
        # servers must see N DISTINCT ends (one server repeats its broadcast
        # for slow joiners and must not count N times). A snapshot resume
        # KEEPS the identity: consumers' dedupe sets and end accounting then
        # span the crash.
        if snapshot_resume is not None:
            self._server_id = snapshot_resume['server_id']
            self._served_chunks = snapshot_resume['sent']
            self._replay = [(seq, [memoryview(f) for f in frames])
                            for seq, frames in snapshot_resume['ring']]
            # Re-seed the ring too: the next snapshot (written at serve
            # start) must keep covering these chunks, or a SECOND crash
            # before the ring refills would lose what the first one
            # nearly did.
            self._ring.extend(self._replay)
        else:
            self._server_id = uuid.uuid4().bytes
        # -- negotiated data-plane wire (fleet.wire) ---------------------
        # Transport tier per consumer session: shm segment rings for a
        # co-located sole consumer, Arrow IPC for remote ones, legacy
        # pickle for mixed-version fleets. Snapshot mode pins the fleet
        # to pickle — the replay ring stores raw frames and re-sends
        # them untagged, and a replayed shm descriptor would point into
        # regions freed (or unlinked) across the crash.
        # A SIGKILLed predecessor cannot unlink its segments; collect
        # them before creating our own (boot-id + pid liveness).
        wire_mod.sweep_stale_segments()
        self._wire = wire_mod.ServerWire(
            self._server_id,
            allow_shm=snapshot_path is None,
            force=wire_mod.TRANSPORT_PICKLE if snapshot_path is not None
            else wire)
        # -- fleet control plane: lease, drain, admission, flow control --
        # Composed from petastorm_tpu_torch.fleet.control_plane — the shared
        # implementation the lookup tier runs too.
        self._lease_s = control_plane.resolve_lease_s(lease_s)
        self._max_consumers = (None if max_consumers is None
                               else int(max_consumers))
        # Fleet membership announce (job id + capacity) riding the
        # heartbeat tail; None = not a fleet member, tail absent.
        self._job_id = control_plane.resolve_job_id(job_id)
        # Tenant isolation (petastorm_tpu_torch.fleet.tenancy.TenantLedger):
        # attaches carry a 'tenant' and are admitted against per-tenant
        # quotas before the server-wide checks. None = single-tenant.
        self._tenants = tenants
        self._m_rejected = metrics_mod.counter(
            'pst_consumers_rejected_total',
            'Consumer attach requests a data-service server refused',
            labelnames=('reason',))
        # Memory governor (petastorm_tpu_torch.membudget): the snapshot/replay
        # ring pins whole serialized chunk frames in host memory — it
        # registers for byte accounting, and the ladder's *shed* rung
        # makes this server refuse NEW consumers with the typed admission
        # refusal below (existing consumers keep draining: shedding load
        # must not break streams that are already moving bytes OUT).
        from petastorm_tpu_torch import membudget
        self._mem_shed = False
        self._mem_handle = membudget.register_pool(
            'snapshot-ring', self._ring_nbytes, shed_fn=self._set_mem_shed)
        # Admission ledger (shared control plane): consumer_id -> entry
        # with a 3-lease expiry (the client control thread re-attaches
        # every lease), so a crashed consumer frees its admission slot
        # without a detach. The ledger's lock doubles as the flow-control
        # lock: admit + credit math must be one atomic decision.
        self._admission = control_plane.AdmissionLedger(self._lease_s)
        self._admission_lock = self._admission.lock
        # Aggregate credit pool (credit-based flow control): None until a
        # consumer attaches with a credit grant; afterwards the serve loop
        # sends only while credit remains, so total outstanding chunks are
        # bounded by what consumers granted instead of N * sndhwm. An
        # attach WITHOUT credits while armed disarms the gate permanently
        # (a credit-blind consumer would otherwise starve behind it).
        self._credit = None
        self._credit_disabled = False
        # Drain state machine (shared control plane): serving -> draining
        # (stop admitting, finish the in-flight chunk, emit the final
        # cursor) -> drained. The events are bound locally so the serve
        # loop's between-chunk checks stay one attribute read.
        self._drain_state = control_plane.DrainState()
        self._draining = self._drain_state.draining
        self._drained = self._drain_state.drained
        self._final_cursor = None
        # End-of-stream marker handed to the control thread, which owns
        # the PUB socket once start() ran (heartbeats and END broadcasts
        # must not race the serve thread on one zmq socket).
        self._end_marker = None
        self._ctrl_thread = None
        # Deferred build (reader_builder): set by the first attach rpc.
        self._cursor_evt = threading.Event()
        self._resume_cursor = None
        self._cursor_applied = False

    def serve_forever(self):
        """Blocking serve loop: pull batches off the reader, push to
        whichever trainer asks first; broadcast END when the reader ends
        (or an error marker if it failed — trainers re-raise, they must
        never mistake a half-served dataset for a clean epoch). A
        ``drain()`` (rpc or SIGTERM via ``serve_cli``) exits the loop at
        the next chunk boundary: admission already refuses new consumers,
        the in-flight chunk completes, the final stream cursor is
        captured, and a clean END (exact served count) goes out — a
        graceful drain loses zero chunks."""
        from petastorm_tpu_torch import faults
        err_body = None
        abandoned_tail = False
        try:
            if self._reader is None:
                # Deferred build (reader_builder / await_cursor): the
                # first consumer attach carries its resume cursor (or
                # None) — the control-plane handoff that makes a
                # replacement server continue a dead peer's deterministic
                # stream bit-identically.
                while not self._cursor_evt.wait(0.05):
                    if self._stop.is_set():
                        return
                    if self._draining.is_set():
                        break
                if not self._cursor_evt.is_set():
                    raise RuntimeError('server drained before any consumer '
                                       'attached a resume cursor')
                self._reader = self._reader_builder(self._resume_cursor)
                _check_batched(self._reader)
                self._cursor_applied = self._resume_cursor is not None
                if self._stop.is_set():
                    # stop() raced the build and saw reader=None: it could
                    # not stop the pool itself, so tear it down here.
                    self._reader.stop()
                    self._reader.join()
                    return
            # iter() inside the guard: an __iter__ failure must take the
            # same error-broadcast path as a mid-stream one — an escaped
            # exception here would kill the thread with no END/ERR and a
            # sole consumer would poll forever.
            rows = iter(self._reader)
            # Crash recovery: before the initial snapshot exists, a restart
            # cannot recover identity — write one at chunk 0 so every
            # restart-from-snapshot has the original server_id.
            if self._snapshot_path is not None:
                self._write_snapshot()
            # Re-send the resumed ring first (already counted in the
            # served total — consumers drop the ones they already have).
            for seq, frames in self._replay:
                if not self._send_chunk(seq, frames, count=False):
                    break
            self._replay = []
            while not self._stop.is_set():
                if self._draining.is_set():
                    # Chunk boundary: the in-flight chunk completed (or
                    # never started); stop reading, declare a clean end.
                    break
                if self._pause.is_set():
                    # Chunk boundary: _served_chunks is final and the
                    # reader's state_dict covers exactly the sent chunks.
                    self._paused_gen = self._pause_gen
                    time.sleep(0.005)
                    continue
                # Fleet drills: die at a chunk boundary (preempted decode
                # host) / serve slowly (sick-but-alive host).
                faults.maybe_inject('server-kill')
                self._wait_for_credit()
                if self._stop.is_set() or self._draining.is_set():
                    continue
                try:
                    sample = next(rows)
                except StopIteration:
                    break
                faults.maybe_inject('server-slow')
                payload = {name: getattr(sample, name)
                           for name in sample._fields}
                # Batch provenance across the wire (petastorm_tpu_torch.lineage):
                # the chunk's segment rides a reserved key next to the
                # column blocks (tiny next to MB payloads; the consumer
                # pops it before the columns reach the loader).
                # The deterministic-mode tag (seq/epoch/pos of the server
                # reader's ventilation) rides the SAME reserved key as the
                # provenance segment — no new wire-compat surface, the
                # existing `lineage=False` fleet gate covers both. Either
                # half may be present alone: a deterministic reader with
                # provenance capture off still ships its stream cursor.
                if self._lineage_enabled:
                    chunk_lineage = getattr(self._reader,
                                            'last_chunk_lineage', None)
                    chunk_det = getattr(self._reader, 'last_chunk_det', None)
                    if chunk_lineage is not None or chunk_det is not None:
                        sidecar = {'endpoint': self.data_endpoint}
                        if chunk_lineage is not None:
                            sidecar['seg'] = chunk_lineage
                        if chunk_det is not None:
                            sidecar['det'] = chunk_det
                        payload['__pst_lineage__'] = sidecar
                seq = self._served_chunks
                # The wire tier of THIS chunk: the best tier every
                # currently-admitted session can decode (the tier is a
                # session property on the admission entries; the PUSH
                # socket fair-queues, so per-chunk tags — not per-
                # consumer formats — keep a mixed/renegotiating fleet
                # decodable mid-stream).
                with self._admission_lock:
                    tiers = list(control_plane.session_transports_locked(
                        self._admission).values())
                transport = self._wire.effective_transport(tiers)
                tag, frames = self._wire.encode(
                    seq, payload, transport, _dump_frames)
                self._ring.append((seq, frames))
                if not self._send_chunk(seq, frames, count=True, tag=tag):
                    # Stopped (or idle-drained) mid-HWM-retry: the reader
                    # has advanced past this chunk but `sent` has not — a
                    # snapshot or final cursor here would be one chunk
                    # ahead of its count and a resume would reuse this seq
                    # for DIFFERENT rows (consumers would dedupe them
                    # away). Don't snapshot; exit.
                    abandoned_tail = not self._stop.is_set()
                    break
                if (self._snapshot_path is not None
                        and self._served_chunks % self._snapshot_every == 0):
                    self._write_snapshot()
        except Exception as e:  # noqa: BLE001 - forwarded to trainers
            logger.exception('data server reader failed')
            err_body = repr(e).encode('utf-8', 'replace')[:512]
        finally:
            if self._stop.is_set() and err_body is None:
                return      # stopped mid-serve: no end-of-data to declare
            if err_body is None:
                marker = (_CTRL_END + self._server_id
                          + _COUNT_STRUCT.pack(self._served_chunks))
                if self._snapshot_path is not None and not abandoned_tail:
                    # Final snapshot: a restart after a clean end re-serves
                    # nothing and re-advertises the full count.
                    try:
                        self._write_snapshot()
                    except Exception:   # noqa: BLE001 - end still broadcast
                        logger.exception('final server snapshot failed')
                # The final stream cursor: what a drained server hands the
                # orchestrator (drain rpc reply / stats) so its stream can
                # be continued elsewhere exactly where it stopped.
                state_fn = getattr(self._reader, 'state_dict', None)
                if state_fn is not None and not abandoned_tail:
                    try:
                        self._final_cursor = state_fn()
                    except Exception:   # noqa: BLE001 - cursor is advisory
                        logger.exception('final cursor capture failed')
            else:
                marker = _CTRL_ERR + self._server_id + err_body
            if self._auth_key is not None:
                marker += _mac(self._auth_key, marker)
            logger.info('data server done: %d chunks served', self._served_chunks)
            if self._draining.is_set() and err_body is None:
                self._drained.set()
            # Hand the marker to the control thread (it owns the PUB
            # socket once start() ran: heartbeats and END broadcasts must
            # not race on one zmq socket) and declare the stream done.
            self._end_marker = marker
            self._serving_done.set()
            self._ctrl_wake.set()
            if self._ctrl_thread is None:
                # Direct serve_forever() call (no start(), so no control
                # thread): broadcast inline until stopped. PUB drops
                # messages for slow-JOINING subscribers, so a client that
                # dials in after the data ended still learns the stream
                # is over.
                while not self._stop.is_set():
                    self._ctrl_sock.send(marker)
                    # A checkpoint can still be requested after the stream
                    # ended (e.g. end-of-epoch state); keep honoring pause.
                    if self._pause.is_set():
                        self._paused_gen = self._pause_gen
                    time.sleep(0.05)

    def _wait_for_credit(self):
        """Credit-based flow control: park (off the reader) until granted
        credit remains. Bounds total outstanding chunks by what the
        attached consumers granted — the PUSH fan-out's N*sndhwm memory
        ceiling becomes an explicit, consumer-controlled budget."""
        while not self._stop.is_set() and not self._draining.is_set():
            with self._admission_lock:
                if (self._credit is None or self._credit_disabled
                        or self._credit > 0):
                    return
            time.sleep(0.02)

    def _send_chunk(self, seq, frames, count, tag=None):
        """HWM-respecting send of ``[meta, header, buf...]``; returns False
        only when stopped mid-retry. The meta frame carries (server_id,
        seq) — plus, for non-legacy wire tiers, a one-byte transport tag
        (legacy pickle chunks stay byte-identical to the pre-wire format
        so old consumers keep decoding them) — and, under ``auth_key``, a
        mac over the meta prefix, the header, and every payload buffer,
        so consumers authenticate the whole chunk before decoding."""
        meta = _META_STRUCT.pack(self._server_id, seq)
        if tag is not None:
            meta += tag
        if self._auth_key is not None:
            # MAC the WHOLE chunk (meta prefix + header + every payload
            # buffer): header-only coverage would let a peer replay a
            # valid (meta, header) pair over substituted buffer bytes and
            # feed corrupted tensors past verification. Costs one keyed-
            # BLAKE2b pass over the payload (~GB/s) when auth is armed.
            meta += _mac(self._auth_key, meta, *frames)
        parts = [meta] + frames
        while not self._stop.is_set():
            try:
                self._data_sock.send_multipart(
                    parts, flags=self._zmq.NOBLOCK, copy=False)
                if count:
                    self._served_chunks += 1
                    self._m_served.inc()
                    with self._admission_lock:
                        if self._credit is not None \
                                and not self._credit_disabled:
                            self._credit -= 1
                return True
            except self._zmq.Again:
                if self._draining.is_set() and self._admission.count() == 0:
                    # Draining with NO admitted consumer: nobody can take
                    # this chunk and nobody can lose it — abandon the
                    # parked send so an idle worker's drain-first release
                    # completes (the autoscaler's scale-down and the
                    # worker CLI's SIGTERM path both rely on this)
                    # instead of wedging in the HWM retry forever.
                    return False
                # All consumers at HWM (or none connected yet): wake the
                # moment one can take the chunk.
                self._data_sock.poll(50, self._zmq.POLLOUT)
        return False

    def _write_snapshot(self):
        """Atomically persist {identity, served count, reader position,
        replay ring} — the serve thread is between chunks here, so the
        reader state corresponds exactly to ``sent``."""
        state_fn = getattr(self._reader, 'state_dict', None)
        snapshot = {
            'server_id': self._server_id,
            'sent': self._served_chunks,
            'reader_state': state_fn() if state_fn is not None else None,
            'ring': [(seq, [bytes(f) for f in frames])
                     for seq, frames in self._ring],
        }
        tmp = '{}.tmp.{}'.format(self._snapshot_path, os.getpid())
        with open(tmp, 'wb') as f:
            pickle.dump(snapshot, f, protocol=5)
        os.replace(tmp, self._snapshot_path)
        self._last_snapshot = (self._served_chunks, time.monotonic())

    @property
    def state(self):
        """Drain state machine position: ``'awaiting-cursor'`` (deferred
        build, no consumer yet), ``'serving'``, ``'draining'``, or
        ``'drained'``."""
        return self._drain_state.state(
            serving='awaiting-cursor' if self._reader is None
            else 'serving')

    def drain(self, timeout_s=None):
        """Graceful drain: stop admitting consumers, finish the in-flight
        chunk, capture the final stream cursor, broadcast a clean END
        (exact served count — consumers verify zero chunks were lost),
        and let the serve loop exit. Returns True once fully drained
        (``timeout_s=None`` waits indefinitely). A server parked in an
        HWM send retry with ADMITTED consumers waits for one to take the
        chunk; parked with none admitted it abandons the unsent (and
        uncounted) chunk — an idle fleet worker must drain promptly, and
        with no admitted consumer there is nobody to lose it. Draining a
        server that already ENDed cleanly reports drained — idempotent
        for orchestrators."""
        self._draining.set()
        done = self._serving_done.wait(timeout_s)
        if done and (self._end_marker or b'').startswith(_CTRL_END):
            self._drained.set()
        return done and self._drained.is_set()

    @property
    def final_cursor(self):
        """The serving reader's last ``state_dict()`` captured at clean
        end / drain — the handoff a replacement server resumes from."""
        return self._final_cursor

    def _release_consumer_locked(self, cid):
        """Drop a consumer from the admission ledger (caller holds
        _admission_lock) and refund its initial credit grant — a crashed
        consumer must not permanently shrink the flow-control window
        (the refund is approximate: chunks it had in flight are not
        attributable under PUSH fair-queuing, so the bound loosens by at
        most its unflushed grants rather than tightening forever)."""
        entry = self._admission.release_locked(cid)
        if entry is None:
            return
        self._refund_entry_locked(cid, entry)

    def _refund_entry_locked(self, cid, entry):
        """Post-release accounting for one ledger entry: refund its
        credit grant, free its tenant slot, and tear down its wire
        session (close + unlink any shm segment ring — a crashed
        consumer's unacked regions must not pin ring space forever; the
        remaining sessions' common tier is recomputed per chunk, so the
        send path downgrades on its own)."""
        self._wire.release_consumer(cid)
        credits = entry.get('credits') or 0
        if self._credit is not None and not self._credit_disabled:
            self._credit += credits
            if not any(e.get('credits')
                       for e in self._admission.entries_locked().values()):
                # No credit-granting consumer remains: disarm so a stale
                # deficit can't wedge the serve loop; the next credit
                # attach re-bases the pool from scratch.
                self._credit = None
        if self._tenants is not None and entry.get('tenant') is not None:
            self._tenants.release(entry['tenant'], cid,
                                  credits=entry.get('credits') or 0)

    def _prune_consumers_locked(self, now):
        for cid, entry in self._admission.prune_locked(now):
            self._refund_entry_locked(cid, entry)
            logger.warning('data server %s: consumer %s admission lease '
                           'expired (no renew in %.0fs)',
                           self.data_endpoint, cid,
                           self._admission.expiry_leases * self._lease_s)

    def _control_loop(self):
        """Owns the control PUB socket (after start()): lease heartbeats
        every ``lease_s / 3``, END/ERR broadcast once the stream is done
        (repeating, for slow joiners), admission-ledger pruning, and
        post-end checkpoint-pause acknowledgement."""
        hb_interval = control_plane.heartbeat_interval(self._lease_s)
        try:
            rpc_ep = self.rpc_endpoint
        except Exception:   # noqa: BLE001 - heartbeat must still go out
            rpc_ep = ''
        next_hb = 0.0
        while not self._stop.is_set():
            now = time.monotonic()
            if now >= next_hb:
                msg = control_plane.pack_heartbeat(
                    self._server_id, self._lease_s, self.state, rpc_ep,
                    announce=self._announce_payload(),
                    auth_key=self._auth_key)
                self._ctrl_sock.send(msg)
                with self._admission_lock:
                    self._prune_consumers_locked(now)
                next_hb = now + hb_interval
            marker = self._end_marker
            if marker is not None:
                self._ctrl_sock.send(marker)
                # A checkpoint can still be requested after the stream
                # ended (end-of-epoch state); the serve thread is gone,
                # so acknowledge the pause boundary here — trivially true
                # between chunks that will never come.
                if self._pause.is_set():
                    self._paused_gen = self._pause_gen
            self._ctrl_wake.clear()
            if self._stop.is_set():
                break   # clear() must not eat stop()'s wake-up
            if self._end_marker is None:
                # Sleep until the next heartbeat is due — or until the
                # serve thread posts END (_ctrl_wake), so the last-chunk
                # -> END latency is a socket send, not a heartbeat tick.
                self._ctrl_wake.wait(min(hb_interval, 0.25))
            else:
                self._stop.wait(0.05)

    def _announce_payload(self):
        """Fleet-membership announce riding the heartbeat tail: job id +
        capacity (+ data endpoint, so the registry can hand a joiner a
        complete connect spec). None when not a fleet member — the wire
        then stays byte-identical to the pre-fleet format."""
        if self._job_id is None:
            return None
        return {'job': self._job_id,
                'capacity': self._max_consumers,
                'data': self.data_endpoint,
                'sent': self._served_chunks}

    def _rpc_loop(self):
        """Answer checkpoint/stats requests (REP socket, one at a time)."""
        from petastorm_tpu_torch import faults
        zmq = self._zmq
        while not self._stop.is_set():
            if not self._rpc_sock.poll(100):
                continue
            try:
                raw = self._rpc_sock.recv()
            except zmq.ZMQError:
                return
            if faults.get_injector().should_fire('rpc-blackhole'):
                # Partitioned control plane: swallow the request. REP
                # requires send-before-next-recv, so reset the socket's
                # state machine by re-binding it (only this thread touches
                # the rpc socket while running).
                logger.warning('fault injection: rpc-blackhole dropping '
                               'request without reply')
                endpoint = self._rpc_sock.getsockopt(
                    zmq.LAST_ENDPOINT).decode()
                self._rpc_sock.close(linger=0)
                self._rpc_sock = self._context.socket(zmq.REP)
                # close(linger=0) releases the port asynchronously on the
                # io thread: retry the rebind briefly.
                for attempt in range(200):
                    try:
                        self._rpc_sock.bind(endpoint)
                        break
                    except zmq.ZMQError:
                        if attempt == 199:
                            raise
                        time.sleep(0.02)
                continue
            if self._auth_key is not None:
                # Authenticate BEFORE unpickling: an unauthenticated
                # request gets an explicit (non-pickle-derived) refusal.
                if (len(raw) < _MAC_LEN or
                        not _mac_ok(self._auth_key, raw[-_MAC_LEN:],
                                    raw[:-_MAC_LEN])):
                    reply = pickle.dumps({'error': 'unauthenticated rpc '
                                          'request refused'}, protocol=5)
                    self._rpc_sock.send(
                        reply + _mac(self._auth_key, reply))
                    continue
                raw = raw[:-_MAC_LEN]
            try:
                # Unpickling is inside the guarded region: stray bytes on
                # the port (scanner, protocol mismatch) must produce an
                # error REPLY — REP requires a send before the next recv,
                # and an escaped exception would kill this thread and
                # silently disable checkpointing for the server's lifetime.
                reply = self._handle_rpc(pickle.loads(raw))
                # Serialize inside the guard too: a reply embedding an
                # unpicklable user object (e.g. a schema holding a lambda
                # codec) must degrade to an error reply, not kill the
                # thread mid-REP-cycle.
                payload = pickle.dumps(reply, protocol=5)
            except Exception as e:  # noqa: BLE001 - reply, don't die
                logger.exception('data server rpc failed')
                payload = pickle.dumps({'error': repr(e)}, protocol=5)
            if self._auth_key is not None:
                payload += _mac(self._auth_key, payload)
            self._rpc_sock.send(payload)

    def _handle_rpc(self, request):
        cmd = request.get('cmd')
        if cmd == 'attach':
            # Admission control (the control-plane half of the consumer
            # handshake): a server past its capacity knob or draining
            # refuses with a TYPED reason instead of silently feeding or
            # starving the consumer. Re-attach of a known consumer is a
            # lease renew. The first attach may carry a deterministic
            # resume cursor — a reader_builder server builds its reader
            # from it (reconnect-with-resume handoff).
            consumer = request.get('consumer') or 'anonymous'
            tenant = request.get('tenant')
            now = time.monotonic()
            with self._admission_lock:
                self._prune_consumers_locked(now)
                state = self.state
                known = self._admission.known_locked(consumer)
                if state in ('draining', 'drained') and not known:
                    self._m_rejected.labels('draining').inc()
                    return control_plane.refusal(
                        self._server_id, state, state,
                        sent=self._served_chunks)
                if (self._max_consumers is not None and not known
                        and self._admission.count_locked()
                        >= self._max_consumers):
                    self._m_rejected.labels('overloaded').inc()
                    return control_plane.refusal(
                        self._server_id,
                        control_plane.REFUSED_OVERLOADED, state,
                        max_consumers=self._max_consumers)
                if self._mem_shed and not known:
                    # Memory-governor shed rung: same typed 'overloaded'
                    # refusal consumers already failover/back off on, with
                    # the reason naming the pressure for operators.
                    self._m_rejected.labels('memory-pressure').inc()
                    return control_plane.refusal(
                        self._server_id,
                        control_plane.REFUSED_OVERLOADED, state,
                        reason=control_plane.REASON_MEMORY_PRESSURE)
                credits = int(request.get('credits') or 0)
                if self._tenants is not None and not known:
                    # Tenant isolation: quota checks scoped to THIS
                    # tenant — a noisy neighbor's exhaustion refuses
                    # its own attaches, never another tenant's. The
                    # credit grant is clamped to the tenant's partition
                    # of the flow-control window.
                    tenant_refusal = self._tenants.admit(
                        tenant, consumer, server_id=self._server_id,
                        state=state)
                    if tenant_refusal is not None:
                        self._m_rejected.labels(
                            tenant_refusal.get('reason')
                            or 'overloaded').inc()
                        return tenant_refusal
                    credits = self._tenants.clamp_credits(tenant, credits)
                if known:
                    entry = self._admission.renew_locked(consumer, now)
                else:
                    entry = self._admission.admit_locked(consumer, now,
                                                         credits=credits,
                                                         tenant=tenant)
                    if credits and not self._credit_disabled:
                        self._credit = (self._credit or 0) + credits
                # Wire-tier negotiation (fleet.wire): the transport is a
                # property of the consumer session, recorded on its
                # admission entry — the serve loop reads the session
                # tiers to pick each chunk's common tier. Renewals
                # renegotiate: a second consumer joining demotes a
                # sole-consumer shm grant on the next lease beat.
                caps = request.get('wire')
                wire_grant = self._wire.negotiate(
                    consumer, caps, self._admission.count_locked() == 1)
                entry['wire'] = wire_grant['transport']
                # The aggregate gate is sound only while EVERY admitted
                # consumer grants credits: a credit-blind consumer's pulls
                # consume credit nobody grants back, so a mixed ledger —
                # in either attach order — disarms the gate rather than
                # wedge the fleet.
                entries = self._admission.entries_locked()
                if (self._credit is not None and not self._credit_disabled
                        and any(not e.get('credits')
                                for e in entries.values())):
                    self._credit_disabled = True
                    logger.warning('credit-blind consumer present beside '
                                   'flow-controlled ones; credit gate '
                                   'disarmed')
            resume = None
            cursor = request.get('resume_cursor')
            if cursor is not None and self._reader_builder is not None \
                    and not self._cursor_evt.is_set():
                self._resume_cursor = cursor
                resume = 'cursor'
            if self._reader_builder is not None:
                self._cursor_evt.set()
            reply = {'server_id': self._server_id, 'state': self.state,
                     'lease_s': self._lease_s, 'sent': self._served_chunks,
                     'resume': resume, 'tenant': tenant,
                     'credits': credits}
            if caps is not None:
                # Only negotiating consumers get the wire reply — its
                # absence is how a new client detects a pre-wire server
                # (and treats the endpoint as pickle).
                reply['wire'] = wire_grant
            return reply
        if cmd == 'detach':
            with self._admission_lock:
                self._release_consumer_locked(request.get('consumer'))
            return {'ok': True}
        if cmd == 'wire_ack':
            # Batched shm-region releases from the consumer's control
            # loop (the flow-control analogue for ring space): each seq's
            # region is marked free, the ring tail advances over the
            # oldest contiguous freed run, and the serve loop's next shm
            # placement finds room again.
            self._wire.ack(request.get('consumer'),
                           request.get('seqs') or ())
            return {'ok': True}
        if cmd == 'credit':
            with self._admission_lock:
                if self._credit is not None and not self._credit_disabled:
                    self._credit += int(request.get('n', 0))
                avail = self._credit
            return {'ok': True, 'credit': avail}
        if cmd == 'drain':
            # Graceful drain over rpc: park admission, let the serve loop
            # finish its in-flight chunk and END cleanly, reply with the
            # final cursor so the orchestrator can hand the stream to a
            # replacement.
            timeout_s = float(request.get('timeout_s', 30.0))
            drained = self.drain(timeout_s)
            return {'server_id': self._server_id, 'state': self.state,
                    'drained': bool(drained),
                    'sent': self._served_chunks,
                    'cursor': self._final_cursor if drained else None}
        if cmd in ('pause_state', 'schema', 'lineage_ctx') \
                and self._reader is None:
            # Deferred-build server with no consumer attached yet: these
            # commands need a reader. A typed error reply (instead of
            # {'schema': None} or a pickled AttributeError) lets callers
            # distinguish "not ready yet — attach/retry" from "broken".
            return {'error': 'server is awaiting a resume cursor (no '
                             'reader built yet) — attach first',
                    'retry': True, 'state': self.state}
        if cmd == 'pause_state':
            # Park the serve loop at a chunk boundary, then snapshot: the
            # reader's consumption state then matches _served_chunks
            # exactly (chunks are counted consumed when they leave the
            # reader, and the loop is provably between chunks).
            self._pause.set()
            self._pause_gen += 1    # single rpc thread: no increment race
            my_gen = self._pause_gen
            deadline = time.monotonic() + 30
            while self._paused_gen < my_gen:
                if self._stop.is_set():
                    # Server shutting down mid-checkpoint: the serve loop
                    # exits without parking; don't hold the rpc thread (a
                    # stuck join would leak all three sockets).
                    self._pause.clear()
                    raise RuntimeError('server stopped during checkpoint')
                if time.monotonic() >= deadline:
                    self._pause.clear()
                    raise RuntimeError('serve loop did not reach a chunk '
                                       'boundary within 30s')
                time.sleep(0.01)
            state_fn = getattr(self._reader, 'state_dict', None)
            state = state_fn() if state_fn is not None else None
            return {'server_id': self._server_id,
                    'sent': self._served_chunks,
                    'state': state}
        if cmd == 'resume':
            # A later pause_state bumps the generation, so this cycle's
            # acknowledgement can never satisfy it — no flag to reset.
            self._pause.clear()
            return {'ok': True}
        if cmd == 'stats':
            # snapshot_lag/age let an orchestrator confirm crash-recovery
            # readiness (a stale snapshot means a wide replay window).
            snap_sent, snap_at = self._last_snapshot
            with self._admission_lock:
                n_consumers = self._admission.count_locked()
                credit = self._credit if not self._credit_disabled else None
                wire_sessions = control_plane.session_transports_locked(
                    self._admission)
            return {'server_id': self._server_id,
                    'wire': wire_sessions,
                    'wire_segments': self._wire.segments(),
                    'sent': self._served_chunks,
                    'done': self._serving_done.is_set(),
                    'state': self.state,
                    'job': self._job_id,
                    'lease_s': self._lease_s,
                    'consumers': n_consumers,
                    'max_consumers': self._max_consumers,
                    'credit': credit,
                    'final_cursor': self._final_cursor,
                    'snapshot_lag_chunks': (
                        self._served_chunks - snap_sent
                        if snap_sent is not None else None),
                    'snapshot_age_s': (
                        round(time.monotonic() - snap_at, 3)
                        if snap_at is not None else None)}
        if cmd == 'schema':
            # Lets trainer-side framework adapters (pytorch.DataLoader,
            # tf_utils.make_petastorm_dataset) see the stream's schema
            # without a store connection of their own.
            return {'schema': getattr(self._reader, 'transformed_schema', None),
                    'ngram': getattr(self._reader, 'ngram', None)}
        if cmd == 'lineage_ctx':
            # The serving reader's provenance context (petastorm_tpu_torch.
            # lineage): what a trainer-side ledger needs so its records of
            # remote batches stay replayable against the source dataset.
            ctx_fn = getattr(self._reader, 'lineage_context', None)
            return {'server_id': self._server_id,
                    'ctx': ctx_fn() if ctx_fn is not None else None}
        if cmd == 'fleet':
            # Membership announce over rpc — the same payload the
            # heartbeat tail carries, for orchestrators (and the fleet
            # status CLI) that poll instead of subscribing to PUB.
            reply = {'server_id': self._server_id, 'state': self.state,
                     'job': self._job_id, 'rpc': self.rpc_endpoint,
                     'capacity': self._max_consumers,
                     'consumers': self._admission.count(),
                     'sent': self._served_chunks}
            if self._tenants is not None:
                reply['tenants'] = self._tenants.snapshot()
            return reply
        if cmd == 'metrics':
            # This server process's full metrics-registry snapshot
            # (petastorm_tpu_torch.metrics — JSON-safe, so the pickle reply is
            # portable): the service-level telemetry the tf.data-service
            # papers make the autoscaling prerequisite. RemoteReader's
            # fleet_metrics() sums these across the fleet.
            from petastorm_tpu_torch import metrics as metrics_mod
            return {'server_id': self._server_id,
                    'sent': self._served_chunks,
                    # registry_id: co-located servers share one process
                    # registry; fleet_metrics dedupes replies on it so a
                    # process's counters fold into the aggregate exactly
                    # once. A uuid, not the pid — pids collide across
                    # hosts/containers (pid 1 is near-universal there).
                    'registry_id': metrics_mod.REGISTRY_INSTANCE_ID,
                    'metrics': metrics_mod.get_registry().collect()}
        raise ValueError('unknown rpc command {!r}'.format(cmd))

    def start(self):
        """Serve on a background thread (returns immediately)."""
        if self._thread is not None:
            raise RuntimeError('server already started')
        self._thread = threading.Thread(target=self.serve_forever, daemon=True,
                                        name='pstt-data-service-serve')
        # Control thread first: it owns the PUB socket (lease heartbeats,
        # END broadcast), and consumers should see a lease from process
        # start — before the possibly-slow first decode.
        self._ctrl_thread = threading.Thread(target=self._control_loop,
                                             daemon=True,
                                             name='pstt-data-service-lease')
        self._ctrl_thread.start()
        self._thread.start()
        self._rpc_thread = threading.Thread(target=self._rpc_loop, daemon=True,
                                            name='pstt-data-service-rpc')
        self._rpc_thread.start()
        return self

    @property
    def served_chunks(self):
        return self._served_chunks

    def wait(self, timeout=None):
        """Block until the stream is fully served (end protocol complete).
        Returns True once done, False on timeout — serving continues."""
        return self._serving_done.wait(timeout)

    def _ring_nbytes(self):
        """Serialized chunk bytes pinned by the snapshot/replay ring — the
        memory governor's ``snapshot-ring`` accounting hook. Iterates a
        copy; a rare mutate-during-copy race raises and the governor
        falls back to the previous sample."""
        return sum(sum(len(frame) for frame in frames)
                   for _, frames in list(self._ring))

    def _set_mem_shed(self, active):
        self._mem_shed = bool(active)

    def stop(self):
        self._mem_handle.close()
        # Close + unlink the wire segment rings (and the wire-shm
        # governor pool). Crash paths never reach this — that's what the
        # start-time stale-segment sweep is for.
        self._wire.close()
        self._stop.set()
        self._ctrl_wake.set()   # control loop may be mid-heartbeat sleep
        # Stop the reader FIRST: it unblocks a serve thread parked inside
        # the reader's __next__. zmq sockets are not thread-safe, so they
        # may only be closed once the serve/rpc/control threads have
        # provably exited. (reader may be None: a deferred-build server
        # drained/stopped before any consumer attached.)
        if self._reader is not None:
            self._reader.stop()
            self._reader.join()
        threads_done = True
        for thread in (self._thread, self._rpc_thread, self._ctrl_thread):
            if thread is not None:
                thread.join(timeout=10)
                threads_done = threads_done and not thread.is_alive()
        if threads_done:
            self._data_sock.close(linger=0)
            self._ctrl_sock.close(linger=0)
            self._rpc_sock.close(linger=0)
        else:
            logger.warning('serve/rpc thread still running after stop(); '
                           'leaking zmq sockets rather than closing them '
                           'from another thread')

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.stop()
        return False


def load_server_snapshot(path):
    """Load a server self-snapshot written via ``snapshot_path=``.

    **Pickle — trusted storage only** (module trust-boundary note).
    Returns the snapshot dict: ``server_id``, ``sent``, ``reader_state``
    (pass to the reader factory as ``resume_state``), ``ring``.
    """
    with open(path, 'rb') as f:
        return pickle.load(f)


def serve_dataset(dataset_url, bind, reader_factory=None, start=True,
                  sndhwm=4, auth_key=None, snapshot_path=None,
                  snapshot_every=16, snapshot_resume=None,
                  replay_ring_chunks=None, lineage=True, lease_s=None,
                  max_consumers=None, await_cursor=False, job_id=None,
                  tenants=None, wire=None, **reader_kwargs):
    """Convenience: build a tensor reader over ``dataset_url`` and serve it.

    Returns the started :class:`DataServer` (context-manage it). Extra
    kwargs go to :func:`~petastorm_tpu_torch.reader.make_tensor_reader` (or to
    ``reader_factory`` if given — use ``make_batch_reader`` for plain
    stores); pass ``resume_state=`` to continue a checkpointed server from
    its recorded position.

    Crash recovery: ``snapshot_path`` arms periodic self-snapshots;
    ``snapshot_resume`` (a path, or a dict from
    :func:`load_server_snapshot`) restarts a killed server from its last
    snapshot — reader position, identity, and replay ring all restored
    (``resume_state`` must not also be given; the snapshot carries it).
    Recovery's seq-based dedupe requires the reader to re-produce chunks
    deterministically after resume: pass ``workers_count=1`` when arming
    ``snapshot_path`` (see :class:`DataServer`).

    Fleet fault tolerance: ``lease_s`` tunes the server's control-plane
    lease heartbeat (``PSTT_LEASE_S`` default), ``max_consumers``
    arms admission control (extra consumers get a typed refusal), and
    ``await_cursor=True`` defers the reader build until the first consumer
    attaches — a REPLACEMENT server for a dead deterministic peer then
    builds its reader from the consumer's shipped
    :class:`~petastorm_tpu_torch.determinism.DeterministicCursor` frontier and
    continues the stream bit-identically (the consumer's reader config
    kwargs here must match the dead server's).
    """
    from petastorm_tpu_torch.reader import make_tensor_reader

    if isinstance(snapshot_resume, str):
        snapshot_resume = load_server_snapshot(snapshot_resume)
    if snapshot_resume is not None:
        if 'resume_state' in reader_kwargs:
            raise ValueError('pass either snapshot_resume or resume_state, '
                             'not both — the snapshot embeds the reader state')
        if await_cursor:
            raise ValueError('pass either snapshot_resume or await_cursor: '
                             'the snapshot already fixes the resume point')
        reader_kwargs['resume_state'] = snapshot_resume['reader_state']
    factory = reader_factory or make_tensor_reader
    server_kwargs = dict(sndhwm=sndhwm, auth_key=auth_key,
                         snapshot_path=snapshot_path,
                         snapshot_every=snapshot_every,
                         snapshot_resume=snapshot_resume,
                         replay_ring_chunks=replay_ring_chunks,
                         lineage=lineage, lease_s=lease_s,
                         max_consumers=max_consumers, job_id=job_id,
                         tenants=tenants, wire=wire)
    if await_cursor:
        def _builder(resume_state=None):
            kwargs = dict(reader_kwargs)
            if resume_state is not None:
                kwargs['resume_state'] = resume_state
            return factory(dataset_url, **kwargs)

        server = DataServer(None, bind, reader_builder=_builder,
                            **server_kwargs)
        return server.start() if start else server
    reader = factory(dataset_url, **reader_kwargs)
    try:
        server = DataServer(reader, bind, **server_kwargs)
    except Exception:
        # e.g. bind: address already in use — don't leak the started pool.
        reader.stop()
        reader.join()
        raise
    return server.start() if start else server


class _SeqTracker(object):
    """Per-server received-seq set: a contiguous watermark plus a sparse
    overflow. A sole consumer receives gaplessly, so it collapses to the
    bare watermark (O(1)); a shared-stream consumer's gaps are the chunks
    its peers took, so its sparse set grows with chunks received — ~100
    bytes/chunk of accounting on an endless (``num_epochs=None``) shared
    stream. Epoch-bounded streams reset with the reader; services running
    unbounded shared streams for days should rotate consumers (or accept
    the linear growth — 1M chunks is ~100 MB)."""

    __slots__ = ('watermark', 'extras')

    def __init__(self):
        self.watermark = 0      # every seq < watermark has been received
        self.extras = set()     # received seqs >= watermark

    def add(self, seq):
        """Record ``seq``; False when it was already received (duplicate —
        e.g. a restarted server replaying its ring)."""
        if seq < self.watermark or seq in self.extras:
            return False
        self.extras.add(seq)
        while self.watermark in self.extras:
            self.extras.discard(self.watermark)
            self.watermark += 1
        return True

    @property
    def count(self):
        return self.watermark + len(self.extras)


class RemoteReader(object):
    """Trainer-side consumer of one or more :class:`DataServer` streams.

    **Several consumers on the same servers?** Every one of them must be
    constructed with ``shared_stream=True`` — the default (False) assumes
    a sole consumer and RAISES at end-of-epoch when its received count
    falls short of the servers' advertised totals (with peers it always
    will: they took the difference). Shared-stream checkpointing goes
    through :func:`checkpoint_shared_stream`, not :meth:`state_dict`.

    Implements the Reader surface :class:`~petastorm_tpu_torch.loader.
    TorchLoader` needs: iterate namedtuples of column blocks
    (``batched_output=True``), ``stop``/``join``, ``diagnostics`` — plus
    :meth:`state_dict` for cross-boundary checkpointing. Chunks arriving
    twice (a crashed server replaying its snapshot ring) are detected by
    their ``(server_id, seq)`` meta frame and dropped silently
    (``diagnostics['duplicate_chunks']``).

    :param endpoints: data endpoint(s), e.g. ``'tcp://host:5555'`` or a
        list — PULL fair-queues across all connected servers.
    :param control_endpoints: matching END-broadcast endpoint(s); default
        derives data port + 1 for each endpoint.
    :param rpc_endpoints: matching checkpoint-rpc endpoint(s); default
        data port + 2.
    :param rcvhwm: chunks buffered locally before backpressuring servers.
    :param poll_timeout_s: receive poll granularity.
    :param shared_stream: set True when several RemoteReaders consume the
        SAME servers (dynamic sharding) — per-consumer chunk counts are
        then unknowable, so end-of-stream falls back to an
        ``end_grace_s`` silence window after all servers declared END.
        The default (False — a sole consumer) verifies its received
        total against the servers' advertised counts and raises on a
        shortfall rather than truncating the epoch silently.
    :param end_grace_s: how long to wait for advertised-but-undelivered
        tail chunks after all servers ended before declaring the stream
        lost (sole consumer) or finished (``shared_stream=True``).
    :param resume_state: a :meth:`state_dict` snapshot (or one consumer's
        entry from :func:`checkpoint_shared_stream`) — re-delivers the
        chunks that were in flight at checkpoint time before pulling
        from the (restarted) servers.
    :param auth_key: shared secret matching the servers' ``auth_key`` —
        chunk headers, control broadcasts, and rpc replies are then
        authenticated before unpickling (module trust-boundary note).
    :param rpc_retry_policy: a custom
        :class:`petastorm_tpu_torch.retry.RetryPolicy` for one-shot rpc calls
        (schema fetch, resume, liveness probes). Default: 3 attempts with
        short jittered backoff — one dropped REP must not mark a healthy
        server dead; only a server that misses the whole budget counts as
        unreachable.
    :param wire: force a data-plane transport tier (``'shm'``,
        ``'arrow-ipc'``, ``'pickle'``; default: negotiate the best the
        server grants — shm for a co-located sole consumer, Arrow IPC
        otherwise, pickle against pre-wire servers). See
        :mod:`petastorm_tpu_torch.fleet.wire` and ``PSTT_WIRE``.
    """

    batched_output = True
    #: The service rejects NGram readers at the server (per-row), so the
    #: stream is always plain batched columns — adapters check this.
    ngram = None

    def __init__(self, endpoints, control_endpoints=None, rpc_endpoints=None,
                 rcvhwm=4, poll_timeout_s=0.1, shared_stream=False,
                 end_grace_s=5.0, resume_state=None, auth_key=None,
                 rpc_retry_policy=None, admission=True, flow_control=None,
                 reconnect_s=None, consumer_id=None, tenant=None, wire=None):
        import zmq

        if isinstance(endpoints, str):
            endpoints = [endpoints]
        if control_endpoints is None:
            control_endpoints = [_next_port_endpoint(e) for e in endpoints]
        elif isinstance(control_endpoints, str):
            control_endpoints = [control_endpoints]
        if rpc_endpoints is None:
            rpc_endpoints = [_next_port_endpoint(e, 2) for e in endpoints]
        elif isinstance(rpc_endpoints, str):
            rpc_endpoints = [rpc_endpoints]
        self._zmq = zmq
        self._context = zmq.Context.instance()
        self._data_sock = self._context.socket(zmq.PULL)
        self._data_sock.setsockopt(zmq.RCVHWM, rcvhwm)
        for endpoint in endpoints:
            self._data_sock.connect(endpoint)
        self._ctrl_sock = self._context.socket(zmq.SUB)
        self._ctrl_sock.setsockopt(zmq.SUBSCRIBE, b'')
        self._n_servers = len(endpoints)
        for endpoint in control_endpoints:
            self._ctrl_sock.connect(endpoint)
        # One poller over data+control: __next__ wakes on whichever speaks
        # first instead of alternating timed polls (poll latency was
        # costing ~2x throughput on fast local streams).
        self._poller = zmq.Poller()
        self._poller.register(self._data_sock, zmq.POLLIN)
        self._poller.register(self._ctrl_sock, zmq.POLLIN)
        self._rpc_endpoints = list(rpc_endpoints)
        self._poll_ms = int(poll_timeout_s * 1000)
        self._shared_stream = shared_stream
        self._end_grace_s = end_grace_s
        self._ended_server_ids = set()
        self._advertised = {}           # server_id -> served-chunk count
        self._server_errors = {}
        self._stopped = False
        self._ctl_wake = threading.Event()    # set by stop(): the control loop's sleep ends
        self._nt_cache = {}
        self._last_lineage = None   # provenance of the latest chunk
        self._last_det = None       # deterministic-mode tag of the latest chunk
        self._chunks = 0        # unique chunks received (dupes excluded)
        self._auth_key = auth_key
        self._seen = {}         # server_id -> _SeqTracker (under _acct_lock)
        self._last_recv = {}    # server_id -> monotonic time of last chunk
        self._dup_chunks = 0
        self._bad_auth_frames = 0
        self._first_bad_auth_t = None
        if rpc_retry_policy is None:
            from petastorm_tpu_torch.retry import RetryPolicy
            rpc_retry_policy = RetryPolicy(
                max_attempts=3, base_delay_s=0.05, max_delay_s=0.5,
                retry_exceptions=(RpcUnanswered,))
        self._rpc_retry_policy = rpc_retry_policy
        # Health supervision state (attach_health): rpc-probed liveness,
        # endpoint -> server_id mapping learned from 'stats' replies, and
        # servers failed over (shared-stream mode) after a probe declared
        # them dead.
        self._hb_recv = None
        self._endpoint_sids = {}
        self._failed_endpoints = set()
        self._probe_dead_until = {}     # endpoint -> monotonic backoff expiry
        # Thread-safety of stop() vs an iterating pump thread: sockets are
        # only touched under _sock_lock; stop() sets _stopped and closes
        # the sockets itself ONLY if it can take the lock without blocking
        # (nobody mid-__next__); otherwise the iterating thread observes
        # _stopped at its next poll tick and closes them.
        self._sock_lock = threading.Lock()
        self._closed = False
        from collections import deque
        # Chunk accounting shared between the iterating (pump) thread and
        # the trainer thread calling state_dict()/rows_consumed():
        #   _pending  — received, not yet delivered by __next__
        #   _unacked  — delivered, not yet attributed via rows_consumed()
        #               (tracked only in row-granular mode; _unacked_offset
        #               is how many rows of the FRONT chunk are consumed)
        # All three only move under _acct_lock.
        self._acct_lock = threading.Lock()
        self._pending = deque()
        self._unacked = deque()
        self._unacked_offset = 0
        self._row_granular = False
        self._schema = None     # lazily fetched over rpc (transformed_schema)
        if resume_state is not None:
            for cols in resume_state['pending']:
                self._pending.append(dict(cols))
        self.last_row_consumed = False
        # -- fleet control plane (leases, admission, reconnect) ----------
        from petastorm_tpu_torch import metrics as metrics_mod
        import uuid as uuid_mod
        self._data_endpoints = list(endpoints)
        self._consumer_id = consumer_id or uuid_mod.uuid4().hex[:12]
        # Tenant identity rides every attach: multi-tenant servers admit
        # and account this consumer against that tenant's quotas.
        self._tenant = tenant
        self._flow_control = int(flow_control) if flow_control else None
        self._reconnect_s = (float(reconnect_s) if reconnect_s is not None
                             else _env_float(ENV_RECONNECT,
                                             DEFAULT_RECONNECT_S))
        self._m_lease_exp = metrics_mod.counter(
            'pst_server_lease_expiries_total',
            'Data-service server leases that expired client-side')
        self._m_reconnects = metrics_mod.counter(
            'pst_reconnects_total',
            'Consumer re-attaches after a server lease expiry, by outcome',
            labelnames=('outcome',))
        self._m_hedged = metrics_mod.counter(
            'pst_hedged_rpcs_total',
            'Metadata rpcs where a hedge to another server was issued')
        # All of the following move under _acct_lock (written by the pump
        # thread's control drain, the client control thread, and probes):
        self._lease = {}            # sid -> {deadline, lease_s, state, rpc}
        self._lease_expired = set()  # sids whose expiry was already counted
        self._sid_rpc = {}          # sid -> rpc endpoint (from heartbeats)
        self._det_frontier = {}     # sid -> (epoch, pos) of last recv chunk
        self._credit_owed = {}      # sid -> received chunks not yet granted
        self._admission_refused = {}  # rpc endpoint -> refusal reason
        self._draining_eps = set()  # rpc endpoints heartbeating 'draining'
        self._reconnect_deadline = {}  # rpc ep -> give-up time (sole mode)
        self._reconnect_announce = set()  # rpc eps owed a reconnect metric
        # -- negotiated data-plane wire (fleet.wire) ---------------------
        # Capabilities advertised on every attach (same-host fingerprint,
        # shm/arrow support — truncated by a forced tier); the server's
        # grant per endpoint lands in _endpoint_wire (under _acct_lock).
        # A pre-wire server's attach reply has no 'wire' key: recorded as
        # the pickle tier, which its untagged frames already are.
        self._wire_caps = wire_mod.client_capabilities(force=wire)
        self._endpoint_wire = {}    # rpc ep -> grant dict from attach
        self._rings_known = {}      # sid -> its shm rings not yet retired, oldest first
        self._wire_client = None    # lazily built on the first shm chunk
        self._wire_decode_errors = 0    # CRC/segment failures (chunk dropped)
        self._breakers = {}         # rpc endpoint -> retry.CircuitBreaker
        self._breaker_threshold = 3     # whole-budget misses before open
        self._breaker_reset_s = 15.0    # open -> half-open cooldown
        self._attach_state = {ep: {'status': 'new', 'next_try': 0.0,
                                   'last_renew': 0.0, 'lease_s': None}
                              for ep in self._rpc_endpoints}
        self._last_ctrl_drain = 0.0
        self._ctl_thread = None
        if admission:
            # Client control thread: attach/renew admission leases, ship
            # the deterministic resume cursor to replacement servers, and
            # replenish flow-control credits — all on fresh REQ sockets,
            # never the pump thread's data/control sockets.
            self._ctl_thread = threading.Thread(
                target=self._client_control_loop, daemon=True,
                name='pstt-data-service-client')
            self._ctl_thread.start()

    def __iter__(self):
        return self

    def _drain_control(self):
        zmq = self._zmq
        try:
            while True:
                msg = self._ctrl_sock.recv(flags=zmq.NOBLOCK)
                if self._auth_key is not None:
                    if (len(msg) < _MAC_LEN or
                            not _mac_ok(self._auth_key, msg[-_MAC_LEN:],
                                        msg[:-_MAC_LEN])):
                        self._bad_auth_frames += 1
                        continue
                    msg = msg[:-_MAC_LEN]
                if msg.startswith(_CTRL_HB):
                    self._note_heartbeat(msg[len(_CTRL_HB):])
                elif msg.startswith(_CTRL_ERR):
                    body = msg[len(_CTRL_ERR):]
                    sid = body[:_SERVER_ID_LEN]
                    self._server_errors[sid] = body[_SERVER_ID_LEN:].decode(
                        'utf-8', 'replace')
                    self._ended_server_ids.add(sid)
                elif msg.startswith(_CTRL_END):
                    body = msg[len(_CTRL_END):]
                    sid = body[:_SERVER_ID_LEN]
                    self._ended_server_ids.add(sid)
                    count_bytes = body[_SERVER_ID_LEN:]
                    if len(count_bytes) >= _COUNT_STRUCT.size:
                        self._advertised[sid] = _COUNT_STRUCT.unpack_from(
                            count_bytes)[0]
        except zmq.Again:
            pass

    def _note_heartbeat(self, body):
        """A server lease heartbeat arrived on the control socket: renew
        its lease, learn the sid -> rpc endpoint mapping, and clear any
        reconnect wait on that endpoint (a fresh lease IS the replacement
        being alive)."""
        if len(body) < _HB_STRUCT.size:
            return
        sid, lease_s, state_code = _HB_STRUCT.unpack_from(body)
        # The tail is rpc endpoint [+ '\n' + fleet announce JSON]; the
        # reader only needs the endpoint — the announce is the fleet
        # registry's concern (petastorm_tpu_torch.fleet.registry).
        rpc_ep, _announce = control_plane.split_hb_tail(
            body[_HB_STRUCT.size:])
        state = _STATE_NAMES.get(state_code, 'serving')
        now = time.monotonic()
        with self._acct_lock:
            self._lease[sid] = {'deadline': now + max(float(lease_s), 0.5),
                                'lease_s': float(lease_s), 'state': state,
                                'rpc': rpc_ep}
            self._lease_expired.discard(sid)
            if rpc_ep:
                self._sid_rpc[sid] = rpc_ep
                self._endpoint_sids[rpc_ep] = sid
                self._reconnect_deadline.pop(rpc_ep, None)
                if state in ('draining', 'drained'):
                    self._draining_eps.add(rpc_ep)
                else:
                    self._draining_eps.discard(rpc_ep)

    def _check_leases(self):
        """Lease expiry is the fleet's dead-server signal: a shared-stream
        consumer fails the expired server over immediately (no rpc probe
        round-trips), a sole consumer opens its reconnect window — and
        raises once a replacement misses it too."""
        now = time.monotonic()
        expired = []
        with self._acct_lock:
            for sid, info in self._lease.items():
                if (sid in self._ended_server_ids
                        or sid in self._lease_expired):
                    continue
                if now > info['deadline']:
                    self._lease_expired.add(sid)
                    expired.append((sid, dict(info)))
            overdue = sorted(ep for ep, t in self._reconnect_deadline.items()
                             if now > t)
        for sid, info in expired:
            self._m_lease_exp.inc()
            ep = info.get('rpc')
            logger.warning(
                'data-service server %s (lease %.1fs, rpc %s) missed its '
                'lease — declaring it dead', sid.hex(), info['lease_s'], ep)
            if self._shared_stream:
                if ep is not None:
                    self._mark_failed([ep])
            elif ep is not None:
                if self._reconnect_s > 0:
                    with self._acct_lock:
                        self._reconnect_deadline.setdefault(
                            ep, now + self._reconnect_s)
                        self._reconnect_announce.add(ep)
                else:
                    self._stopped = True
                    with self._sock_lock:
                        self._close_sockets()
                    raise RuntimeError(
                        'data-service server {} lease expired and '
                        'reconnect is disabled (reconnect_s=0) — restart '
                        'the server or arm {}'.format(ep, ENV_RECONNECT))
        if overdue:
            self._m_reconnects.labels('failed').inc()
            self._stopped = True
            with self._sock_lock:
                self._close_sockets()
            raise RuntimeError(
                'data-service server(s) {} lease-expired and no '
                'replacement appeared within the {}s reconnect window: '
                'restart the server on the same endpoint (snapshot_resume) '
                'or raise reconnect_s'.format(overdue, self._reconnect_s))

    def _enforce_admission(self):
        """Admission refusals recorded by the control thread surface here,
        on the consuming thread: every server refusing = a typed
        ``ServerOverloaded`` (``reason`` = overloaded/draining); a subset
        refusing = this consumer DISCONNECTS those servers' data sockets
        (fair-queued PUSH would otherwise keep handing it chunks meant
        for the admitted consumers — e.g. an exact drain's tail) and, on
        a shared stream, treats them as failed over."""
        with self._acct_lock:
            refused = dict(self._admission_refused)
        if not refused:
            return
        if len(refused) >= self._n_servers:
            from petastorm_tpu_torch.errors import ServerOverloaded
            self._stopped = True
            with self._sock_lock:
                self._close_sockets()
            reason = ('overloaded' if 'overloaded' in refused.values()
                      else sorted(refused.values())[0])
            raise ServerOverloaded(
                'every data-service server refused this consumer '
                '(admission control): {} — scale the decode tier, retire '
                'a consumer, or wait out the drain'.format(refused),
                endpoint=sorted(refused)[0], reason=reason)
        self._exclude_refused(sorted(refused))
        if self._shared_stream:
            self._mark_failed(sorted(refused))

    def _exclude_refused(self, endpoints):
        """Stop PULLing from servers that refused this consumer: without
        the disconnect, zmq keeps fair-queuing chunks to the refused
        socket and they are stolen from the admitted consumers. (A
        bounded window of chunks received before the refusal landed may
        already be lost to the stream — strict exclusivity needs
        ``flow_control`` or a quiesced fleet during drains.)"""
        to_drop = []
        with self._acct_lock:
            for endpoint in endpoints:
                st = self._attach_state.get(endpoint)
                if st is None or st['status'] == 'excluded':
                    continue
                st['status'] = 'excluded'
                try:
                    idx = self._rpc_endpoints.index(endpoint)
                except ValueError:
                    continue
                if idx < len(self._data_endpoints):
                    to_drop.append(self._data_endpoints[idx])
        if to_drop:
            with self._sock_lock:
                if not self._closed:
                    for data_endpoint in to_drop:
                        try:
                            self._data_sock.disconnect(data_endpoint)
                        except self._zmq.ZMQError:
                            pass    # already gone / never connected

    def _note_det(self, sid, cols):
        """Record the deterministic frontier of a RECEIVED chunk (caller
        holds _acct_lock): the position a replacement server must resume
        from is one past the last chunk this consumer received."""
        info = cols.get('__pst_lineage__')
        det = info.get('det') if isinstance(info, dict) else None
        if not isinstance(det, dict) or det.get('pos') is None:
            return
        frontier = (int(det.get('epoch', 1)), int(det['pos']))
        if frontier > self._det_frontier.get(sid, (0, -1)):
            self._det_frontier[sid] = frontier

    def det_cursor(self, endpoint=None):
        """The deterministic resume cursor of this consumer's stream from
        ``endpoint`` (rpc endpoint; default: across all servers — the
        sole-server case). ``None`` when no deterministic chunk tags have
        been seen (non-deterministic server, or nothing received yet).

        This is the frontier shipped to a replacement server
        (``attach`` rpc / ``serve_dataset(await_cursor=True)``): a server
        resuming from it re-serves exactly the chunks this consumer has
        NOT received, so the reconnected stream is bit-identical to an
        uninterrupted one."""
        from petastorm_tpu_torch import determinism
        with self._acct_lock:
            if endpoint is None:
                frontiers = list(self._det_frontier.values())
            else:
                frontiers = [f for sid, f in self._det_frontier.items()
                             if self._sid_rpc.get(sid) == endpoint]
                if not frontiers and len(self._rpc_endpoints) == 1:
                    # Sole server whose sid -> endpoint mapping was never
                    # learned (no heartbeat support): every frontier is it.
                    frontiers = list(self._det_frontier.values())
        if not frontiers:
            return None
        epoch, pos = max(frontiers)
        return determinism.det_tag_cursor({'epoch': epoch, 'pos': pos})

    def reconnect(self, endpoint=None, cursor=_MISSING):
        """Synchronously re-attach to a restarted/replacement server on
        ``endpoint`` (rpc endpoint; default: the sole server), shipping
        the deterministic frontier (:meth:`det_cursor`) unless ``cursor``
        overrides it (pass ``None`` to ship nothing). Clears the
        endpoint's failed/expired control state so accounting spans the
        crash; returns the attach reply (``None`` if the server did not
        answer). The background control thread does the same
        automatically — this method exists for orchestrators that want
        the handoff to happen *now* and to see the reply."""
        if endpoint is None:
            if len(self._rpc_endpoints) != 1:
                raise ValueError('several servers: name the rpc endpoint '
                                 'to reconnect')
            endpoint = self._rpc_endpoints[0]
        if cursor is _MISSING:
            cursor = self.det_cursor(endpoint)
        with self._acct_lock:
            self._failed_endpoints.discard(endpoint)
            self._admission_refused.pop(endpoint, None)
            self._reconnect_announce.add(endpoint)
            st = self._attach_state.setdefault(
                endpoint, {'status': 'new', 'next_try': 0.0,
                           'last_renew': 0.0, 'lease_s': None})
            was_excluded = st['status'] == 'excluded'
            st['status'] = 'new'
            st['next_try'] = 0.0
            self._breakers.pop(endpoint, None)
            data_endpoint = None
            if was_excluded:
                try:
                    idx = self._rpc_endpoints.index(endpoint)
                    data_endpoint = self._data_endpoints[idx]
                except (ValueError, IndexError):
                    pass
        self._probe_dead_until.pop(endpoint, None)
        if data_endpoint is not None:
            # A refusal-excluded endpoint disconnected its data socket;
            # an explicit reconnect re-dials it.
            with self._sock_lock:
                if not self._closed:
                    self._data_sock.connect(data_endpoint)
        return self._do_attach(endpoint, cursor=cursor)

    def _close_sockets(self):
        if not self._closed:
            self._closed = True
            if self._hb_recv is not None:
                self._hb_recv.beat('idle')   # stream over: quiet != stalled
            self._data_sock.close(linger=0)
            self._ctrl_sock.close(linger=0)
            if self._wire_client is not None:
                # Unmap the shm segments (tolerates live trainer views —
                # those keep their pages until collected; the server
                # unlinks the files regardless).
                self._wire_client.close()

    def _recv_chunk_nowait(self):
        """One data chunk as ``(server_id, seq, cols)``, or None. Caller
        holds _sock_lock and must dedupe+count+retain under _acct_lock in
        one step via :meth:`_track` (the snapshot logic treats ``_chunks
        == sent`` as "every counted chunk is in _unacked/_pending or
        consumed"). Frames failing authentication or with a malformed
        meta frame are dropped without touching pickle.

        The meta frame's length discriminates the wire tier: exactly
        ``(server_id, seq)`` [+ mac] is a legacy pickle-p5 chunk; one
        extra byte between them is the transport tag (Arrow IPC or shm
        descriptor — :mod:`petastorm_tpu_torch.fleet.wire`). Tiers can change
        per chunk mid-stream (renegotiation, per-chunk server-side
        fallback), so the tag is authoritative over the attach grant."""
        while not self._closed:
            try:
                frames = self._data_sock.recv_multipart(
                    flags=self._zmq.NOBLOCK, copy=False)
            except self._zmq.Again:
                return None
            want = _META_STRUCT.size + (_MAC_LEN if self._auth_key is not None
                                        else 0)
            if len(frames) < 2:
                # A stray single-frame message (port reused by an alien
                # process, spoofed traffic) must be dropped, not crash
                # the pump thread with an IndexError below.
                self._bad_auth_frames += 1
                continue
            meta = frames[0]
            meta = bytes(meta.buffer if hasattr(meta, 'buffer') else meta)
            if len(meta) == want:
                tag = None
            elif len(meta) == want + 1:
                tag = meta[_META_STRUCT.size:_META_STRUCT.size + 1]
            else:
                self._bad_auth_frames += 1
                continue
            if self._auth_key is not None:
                bufs = [f.buffer if hasattr(f, 'buffer') else f
                        for f in frames[1:]]
                # The mac covers the whole meta prefix INCLUDING the tag
                # byte: a peer must not be able to re-tag a valid chunk
                # and steer the decoder onto a different (attacker-shaped)
                # payload interpretation.
                if not _mac_ok(self._auth_key, meta[-_MAC_LEN:],
                               meta[:-_MAC_LEN], *bufs):
                    self._bad_auth_frames += 1
                    continue
            sid, seq = _META_STRUCT.unpack_from(meta)
            if tag is None:
                cols = _load_frames(frames[1:])
            else:
                cols = self._decode_tagged(tag, frames[1:])
                if cols is None:
                    # Decode failure counted; replay and the end's
                    # accounting catch a genuinely lost chunk.
                    continue
            self._retire_passed(sid, cols)
            return sid, seq, cols
        return None

    def _wire(self):
        """The shm tier's client, made at its first use (by the pump or the
        control thread)."""
        with self._acct_lock:
            if self._wire_client is None:
                self._wire_client = wire_mod.WireClient()
            return self._wire_client

    def _retire_passed(self, sid, cols):
        """Retire the rings of server ``sid`` older than the one a chunk
        arrived on. The server frees a consumer's ring before it makes the
        next (an admission expiry, then a re-attach), and its stream is in
        order, so no descriptor of an older ring can follow. A chunk of
        another tier proves nothing: a consumer that lags may still have
        an older ring's descriptors queued behind it."""
        region = next((v._pst_wire_region for v in cols.values()
                       if hasattr(v, '_pst_wire_region')), None)
        if region is None:
            return
        with self._acct_lock:
            known = self._rings_known.setdefault(sid, [])
            if region.segment not in known:
                known.append(region.segment)
            passed = known[:known.index(region.segment)]
            del known[:len(passed)]
        for name in passed:
            self._wire_client.retire_segment(name)

    def _decode_tagged(self, tag, frames):
        """Decode a non-legacy chunk (Arrow IPC bytes, or a shm ring
        descriptor mapped into zero-copy views). ``None`` = undecodable —
        the chunk is DROPPED, not fatal: a descriptor can legitimately
        outlive its segment across a server crash (frames queued in zmq
        while the restart unlinked the ring), and the restarted server's
        replay ring redelivers; a sole consumer's exact end-of-stream
        accounting catches any chunk nothing redelivered. Corruption
        (CRC mismatch) takes the same path — counted, never delivered."""
        try:
            payload = frames[0]     # tagged chunks: one payload frame
            payload = (payload.buffer if hasattr(payload, 'buffer')
                       else payload)
            if tag == wire_mod.TAG_ARROW:
                return wire_mod.decode_arrow(payload)
            if tag == wire_mod.TAG_SHM:
                return self._wire().decode_chunk(payload)
            logger.warning('unknown wire transport tag %r — dropping chunk '
                           '(mixed-version fleet newer than this consumer?)',
                           tag)
        except Exception:  # noqa: BLE001 - drop + count, never kill the pump
            logger.warning('wire chunk decode failed (tag %r) — dropping',
                           tag, exc_info=True)
        with self._acct_lock:
            self._wire_decode_errors += 1
        return None

    def _track(self, sid, seq):
        """Count a received chunk (caller holds _acct_lock); False for a
        duplicate (replayed by a restarted server) — drop, don't count."""
        if self._hb_recv is not None:
            self._hb_recv.beat('recv')
        self._last_recv[sid] = time.monotonic()
        tracker = self._seen.get(sid)
        if tracker is None:
            tracker = self._seen[sid] = _SeqTracker()
        if not tracker.add(seq):
            self._dup_chunks += 1
            return False
        self._chunks += 1
        if self._flow_control:
            # Credit-based flow control: every received chunk owes the
            # serving fleet a credit grant back (flushed in batches by
            # the control thread).
            self._credit_owed[sid] = self._credit_owed.get(sid, 0) + 1
        return True

    def _drain_one_into_pending(self):
        """Receive one chunk into the undelivered backlog; False if none
        was waiting. Shared by the checkpoint drain paths."""
        with self._sock_lock:
            received = self._recv_chunk_nowait()
        if received is None:
            return False
        sid, seq, cols = received
        with self._acct_lock:
            if self._track(sid, seq):
                self._note_det(sid, cols)
                self._pending.append(cols)
        return True

    def _to_namedtuple(self, cols):
        names = tuple(sorted(cols))
        nt = cached_namedtuple(self._nt_cache, 'RemoteChunk', names)
        return nt(**{n: cols[n] for n in names})

    def _deliver(self, cols):
        """Chunk is leaving the reader: retain it for row-granular
        checkpoint accounting (caller holds _acct_lock or is pre-start)."""
        info = cols.pop('__pst_lineage__', None)
        if info is not None:
            # Trainer-side provenance: keep the server-side segment (path,
            # row-group, worker, upstream tier) but re-tier it as 'remote'
            # — that IS this trainer's serving tier; the decode-side tier
            # survives as remote_tier for audits.
            if info.get('seg') is not None:
                segment = dict(info['seg'])
                segment['remote_tier'] = segment.get('tier')
                segment['tier'] = 'remote'
                segment['endpoint'] = info.get('endpoint')
                self._last_lineage = segment
            else:
                # det-only sidecar (provenance capture off server-side):
                # no segment to re-tier.
                self._last_lineage = None
            self._last_det = info.get('det')
        else:
            self._last_lineage = None
            self._last_det = None
        if self._row_granular:
            first = next(iter(cols.values()))
            self._unacked.append((cols, len(first)))
        return self._to_namedtuple(cols)

    @property
    def last_chunk_lineage(self):
        """Provenance segment of the most recently delivered chunk
        (``petastorm_tpu_torch.lineage``), tier ``'remote'`` with the serving
        endpoint and the server-side tier under ``remote_tier``."""
        return self._last_lineage

    @property
    def last_chunk_det(self):
        """Deterministic-mode tag of the most recently delivered chunk —
        the serving reader's ventilation ``{'seq', 'epoch', 'pos'}``,
        carried across the wire inside the lineage sidecar. A sole
        consumer of one deterministic server receives chunks already in
        seq order (the server's resequenced stream is FIFO over zmq);
        multi-server shared streams interleave and are NOT order-
        deterministic."""
        return getattr(self, '_last_det', None)

    def lineage_context(self):
        """Provenance context for a trainer-side ledger: the first
        answering server's own reader context (dataset url, schema hash,
        seed — what replay needs) wrapped with the service endpoints.
        Falls back to a minimal non-replayable context when no server
        answers the ``lineage_ctx`` rpc."""
        ctx = None
        try:
            # Any server can answer: hedge instead of walking endpoints
            # serially (a slow first server used to cost its whole
            # timeout before the next was even asked).
            reply = self._hedged_rpc({'cmd': 'lineage_ctx'})
        except Exception:  # noqa: BLE001 - context is best-effort
            reply = None
        if reply is not None and reply.get('ctx'):
            ctx = dict(reply['ctx'])
        if ctx is None:
            ctx = {'mode': None}
        ctx['remote'] = True
        ctx['rpc_endpoints'] = list(self._rpc_endpoints)
        return ctx

    # -- row-granular checkpoint protocol (TorchLoader probes by hasattr) --

    def enable_row_granular_checkpoint(self):
        """Defer checkpoint accounting to :meth:`rows_consumed` calls — the
        same contract as the local batched readers (``reader.py``): rows a
        downstream loader has prefetched but not yet delivered re-deliver
        on resume instead of being counted consumed."""
        self._row_granular = True
        return True

    def rows_consumed(self, n):
        """Retire ``n`` delivered rows, FIFO across chunk boundaries. May
        over-report on a padded final batch; draining empty is correct
        (the pads duplicate rows already attributed)."""
        with self._acct_lock:
            self._unacked_offset += n
            while self._unacked:
                head_rows = self._unacked[0][1]
                if self._unacked_offset < head_rows:
                    break
                self._unacked_offset -= head_rows
                self._unacked.popleft()
            if not self._unacked:
                self._unacked_offset = 0

    def __next__(self):
        if self._stopped:
            # Checked before the pending fast path: a stop() must end the
            # stream immediately, not after the resumed/drained backlog.
            with self._sock_lock:
                self._close_sockets()
            raise StopIteration
        # Admission refusals end the stream BEFORE the backlog fast path:
        # a refused consumer must not consume chunks it stole from the
        # admitted ones.
        self._enforce_admission()
        with self._acct_lock:
            if self._pending:
                return self._deliver(self._pending.popleft())
        end_deadline = None
        while True:
            # A busy stream (or a paused consumer) must not starve the
            # control plane: END broadcasts and lease heartbeats ride the
            # control socket, and an endless data torrent used to defer
            # their processing to the first empty poll. Drain control at
            # most every 50ms — and ALWAYS before judging leases, so a
            # consumer pause longer than lease_s (a compile, an eval)
            # processes the queued renewals instead of spuriously
            # declaring the whole fleet dead.
            now = time.monotonic()
            if now - self._last_ctrl_drain > 0.05:
                self._last_ctrl_drain = now
                with self._sock_lock:
                    if not (self._stopped or self._closed):
                        self._drain_control()
            # Control-plane upkeep runs outside the socket lock: lease
            # expiry may raise (or fail servers over), admission refusals
            # raise typed errors.
            self._check_leases()
            self._enforce_admission()
            with self._sock_lock:
                if self._stopped or self._closed:
                    self._close_sockets()
                    raise StopIteration
                received = self._recv_chunk_nowait()
                if received is not None:
                    sid, seq, cols = received
                    with self._acct_lock:
                        if self._track(sid, seq):
                            self._note_det(sid, cols)
                            return self._deliver(cols)
                    continue    # duplicate (server ring replay): drop
                # No data pending: check for END/ERR broadcasts, re-poll.
                self._drain_control()
                if (self._bad_auth_frames >= 3 and self._chunks == 0
                        and not self._ended_server_ids
                        and not self._advertised):
                    # Nothing has EVER authenticated and bad frames keep
                    # arriving: an auth_key mismatch (keyed consumer vs
                    # keyless server drops even the END broadcast, so the
                    # grace path below can never start). Give the true
                    # server one grace window to produce a valid frame —
                    # stray alien traffic on a reused port must not kill a
                    # slow-starting stream — then fail loudly.
                    if self._first_bad_auth_t is None:
                        self._first_bad_auth_t = time.monotonic()
                    elif (time.monotonic() - self._first_bad_auth_t
                          > self._end_grace_s):
                        self._close_sockets()
                        self._stopped = True
                        raise RuntimeError(
                            '{} frame(s) failed authentication and none '
                            'ever succeeded — auth_key mismatch between '
                            'this consumer and the server(s) (a keyless '
                            'server cannot satisfy a keyed consumer).'
                            .format(self._bad_auth_frames))
                if self._servers_accounted() >= self._n_servers:
                    if self._server_errors:
                        # Error end: deliver loudly as soon as everything
                        # ended — counts are meaningless mid-failure.
                        self._close_sockets()
                        self._stopped = True
                        raise RuntimeError(
                            'data server(s) failed mid-stream: {}'.format(
                                sorted(self._server_errors.values())))
                    expected = sum(self._advertised.values())
                    if (not self._shared_stream
                            and len(self._advertised) >= self._n_servers
                            and self._chunks >= expected):
                        # Exact end: every advertised chunk arrived.
                        self.last_row_consumed = True
                        self._close_sockets()
                        raise StopIteration
                    # Advertised chunks still in flight (or shared
                    # stream): give the tail a bounded grace window.
                    if end_deadline is None:
                        end_deadline = time.monotonic() + self._end_grace_s
                    if time.monotonic() >= end_deadline:
                        self._close_sockets()
                        if (self._shared_stream
                                or len(self._advertised)
                                < len(self._ended_server_ids)):
                            # Shared streams can't account per-consumer;
                            # a count-less END (older server) leaves no
                            # total to verify — grace-window end for both.
                            self.last_row_consumed = True
                            raise StopIteration
                        self._stopped = True
                        hint = ('' if not self._bad_auth_frames else
                                ' NOTE: {} frame(s) failed authentication '
                                '— auth_key mismatch with the server is '
                                'the likely cause.'.format(
                                    self._bad_auth_frames))
                        raise RuntimeError(
                            'stream ended with {} of {} advertised chunks '
                            'delivered after {}s grace — tail chunks were '
                            'lost (half-served dataset). If several '
                            'consumers share this stream, construct '
                            'RemoteReader(shared_stream=True).{}'.format(
                                self._chunks, expected, self._end_grace_s,
                                hint))
                    self._poller.poll(min(self._poll_ms, 50))
                    continue
                self._poller.poll(self._poll_ms)
            # Lock released between polls so stop() can cut in.

    def state_dict(self):
        """Checkpoint across the service boundary (sole consumer only).

        Pauses every server at a chunk boundary (rpc ``pause_state``),
        drains the chunks that were already in flight, snapshots each
        server Reader's ``state_dict``, resumes the servers, and returns::

            {'server_states': [st, ...],   # per rpc endpoint, in order
             'pending': [cols, ...]}       # drained, not-yet-delivered

        Restart servers with ``resume_state=state['server_states'][i]``
        and the trainer with ``RemoteReader(..., resume_state=state)``:
        rows delivered before the checkpoint are never re-delivered; rows
        after it (including the drained ``pending`` chunks) are delivered
        exactly once by the resumed pair. Picklable, not JSON-safe.
        """
        if self._shared_stream:
            raise RuntimeError('state_dict() requires a sole consumer '
                               '(shared_stream=True streams cannot '
                               'attribute in-flight chunks); use '
                               'checkpoint_shared_stream(readers)')
        paused = []     # endpoints that were ASKED to pause (a server whose
        #                 reply timed out client-side may still park later —
        #                 it must be resumed too, not only confirmed ones)
        try:
            replies = _pause_servers(self, self._rpc_endpoints,
                                     self._drain_one_into_pending, paused)
            states = [r['state'] for r in replies]
            total_sent = sum(r['sent'] for r in replies)
            # Every server is now parked; drain until all sent chunks are
            # here (they are at most HWM-deep in zmq queues). The final
            # check and the snapshot share one _acct_lock acquisition:
            # count-and-retain is atomic on every path, so "counts match"
            # proves every counted chunk is consumed, unacked, or pending.
            deadline = time.monotonic() + max(self._end_grace_s, 10.0)
            pending_snapshot = None
            while pending_snapshot is None:
                with self._acct_lock:
                    if self._chunks >= total_sent:
                        pending_snapshot = self._pending_snapshot_locked()
                        continue
                if self._drain_one_into_pending():
                    continue
                if self._closed:
                    raise RuntimeError(
                        'reader stopped/ended during state_dict with '
                        'only {} of {} sent chunks received'.format(
                            self._chunks, total_sent))
                if time.monotonic() >= deadline:
                    raise RuntimeError(
                        'only {} of {} sent chunks drained — another '
                        'consumer on this stream?'.format(
                            self._chunks, total_sent))
                with self._sock_lock:
                    if not self._closed:
                        self._data_sock.poll(50)
            state = {'server_states': states,
                     'pending': pending_snapshot}
            _resume_servers(self, self._rpc_endpoints)
            paused = []     # all resumed cleanly
            return state
        finally:
            _best_effort_resume(self, paused)

    def _pending_snapshot_locked(self):
        """The checkpoint replay set in delivery order (caller holds
        _acct_lock): rows delivered to the loader but not yet attributed
        via rows_consumed (prefetch-queue rows; the front chunk may be
        partially consumed — keep only its tail), then the received-but-
        undelivered backlog."""
        snapshot = []
        offset = self._unacked_offset
        for cols, _nrows in self._unacked:
            if offset:
                snapshot.append({k: v[offset:] for k, v in cols.items()})
                offset = 0
            else:
                snapshot.append(dict(cols))
        snapshot.extend(dict(c) for c in self._pending)
        return snapshot

    def _unique_received(self):
        """Per-server unique received-chunk counts (for checkpoint
        aggregation across shared-stream consumers)."""
        with self._acct_lock:
            return {sid: t.count for sid, t in self._seen.items()}

    def _received_seqs(self):
        """Per-server (watermark, extras) received-seq sets — the raw
        material for TRUE cross-consumer unions (a summed count would
        double-count a chunk a crashed server's ring replay landed on a
        different consumer than the original)."""
        with self._acct_lock:
            return {sid: (t.watermark, frozenset(t.extras))
                    for sid, t in self._seen.items()}

    def _rpc_dumps(self, request):
        payload = pickle.dumps(request, protocol=5)
        if self._auth_key is not None:
            payload += _mac(self._auth_key, payload)
        return payload

    def _rpc_loads(self, raw):
        """Parse one rpc reply; EVERY malformed frame — failed mac,
        truncated/garbled pickle, stray bytes from an alien process on a
        reused port — surfaces as the same typed ``RuntimeError`` refusal
        instead of whatever the decoder tripped over (``EOFError``,
        ``UnpicklingError``, a struct ``ValueError``...). Callers key
        retry/breaker behavior on the exception type, so a malformed
        reply must look like a refusal, not an internal bug."""
        if self._auth_key is not None:
            if (len(raw) < _MAC_LEN or
                    not _mac_ok(self._auth_key, raw[-_MAC_LEN:],
                                raw[:-_MAC_LEN])):
                raise RuntimeError('unauthenticated rpc reply refused')
            raw = raw[:-_MAC_LEN]
        try:
            return pickle.loads(raw)
        except Exception as e:  # noqa: BLE001 - typed refusal for them all
            raise RuntimeError('malformed rpc reply refused ({}: {})'.format(
                type(e).__name__, e))

    def _rpc_attempt(self, endpoint, request, timeout_ms, control=False):
        """One REQ/REP round-trip on a fresh socket (REQ state machines
        cannot be reused after a lost reply); RpcUnanswered on timeout.
        ``control``: a control-thread rpc, which gives up as soon as the
        reader is stopped (its owner's ``join`` must not wait out a slow
        server's reply and the retries after it)."""
        zmq = self._zmq
        sock = self._context.socket(zmq.REQ)
        sock.setsockopt(zmq.LINGER, 0)
        try:
            sock.connect(endpoint)
            sock.send(self._rpc_dumps(request))
            deadline = time.monotonic() + timeout_ms / 1000.0
            while True:
                left_ms = max(0, int((deadline - time.monotonic()) * 1000))
                if sock.poll(min(left_ms, _CONTROL_POLL_MS) if control else left_ms):
                    break
                if left_ms == 0 or (control and self._stopped):
                    raise RpcUnanswered('{} gave no reply within {}ms'.format(
                        endpoint, timeout_ms))
            return self._rpc_loads(sock.recv())
        finally:
            sock.close(linger=0)

    def _breaker(self, endpoint):
        """Per-endpoint circuit breaker over the rpc plane: a blackholed
        server (swallows requests, answers nothing) costs the whole retry
        budget exactly ``failure_threshold`` times, then calls
        short-circuit to None until the half-open probe succeeds."""
        from petastorm_tpu_torch.retry import CircuitBreaker
        with self._acct_lock:
            breaker = self._breakers.get(endpoint)
            if breaker is None:
                breaker = self._breakers[endpoint] = CircuitBreaker(
                    failure_threshold=self._breaker_threshold,
                    reset_timeout_s=self._breaker_reset_s)
            return breaker

    def _one_shot_rpc(self, endpoint, request, timeout_ms=10000, control=False):
        """One logical rpc under the retry policy and the endpoint's
        circuit breaker: a dropped REP gets a fresh-socket retry (small
        jittered budget) instead of immediately branding the server dead;
        a server that misses whole budgets repeatedly opens the circuit
        and further calls return ``None`` instantly instead of hanging
        the caller on a blackholed endpoint. ``None`` = unreachable.
        ``control``: see :meth:`_rpc_attempt`; no retry once stopped."""
        breaker = self._breaker(endpoint)
        if not breaker.allow():
            return None
        if control and self._stopped:
            return None
        extra = {'control': True} if control else {}
        try:
            reply = self._rpc_retry_policy.call(
                self._rpc_attempt, endpoint, request, timeout_ms,
                retry_call_name='data-service-rpc', **extra)
        except RpcUnanswered:
            breaker.record_failure()
            return None
        except Exception:
            breaker.record_failure()
            raise
        breaker.record_success()
        return reply

    def _hedged_rpc(self, request, timeout_ms=10000, hedge_after_ms=300):
        """Server-agnostic metadata rpc (schema, lineage context) with
        hedging: ask the first reachable server, and when it stays silent
        past ``hedge_after_ms`` also ask the next — first valid reply
        wins. A slow-but-alive server (``server-slow`` fault) then costs
        one hedge delay, not its full slowness; open-circuit endpoints
        are skipped. ``None`` when nobody answered in time."""
        zmq = self._zmq
        from petastorm_tpu_torch.retry import CircuitBreaker
        candidates = [ep for ep in self._rpc_endpoints
                      if self._breaker(ep).state != CircuitBreaker.OPEN]
        if not candidates:
            candidates = list(self._rpc_endpoints)  # all open: probe anyway
        payload = self._rpc_dumps(request)
        deadline = time.monotonic() + timeout_ms / 1000.0
        poller = zmq.Poller()
        socks = {}
        pending = list(candidates)
        hedges = 0
        error_reply = None
        try:
            while True:
                now = time.monotonic()
                if now >= deadline:
                    break
                if pending:
                    endpoint = pending.pop(0)
                    sock = self._context.socket(zmq.REQ)
                    sock.setsockopt(zmq.LINGER, 0)
                    sock.connect(endpoint)
                    sock.send(payload)
                    poller.register(sock, zmq.POLLIN)
                    socks[sock] = endpoint
                    hedges += 1
                    if hedges > 1:
                        self._m_hedged.inc()
                elif not socks:
                    break   # everyone answered an error / garbled reply
                wait_ms = (deadline - now) * 1000.0
                if pending:
                    wait_ms = min(wait_ms, hedge_after_ms)
                for sock, _ in poller.poll(max(int(wait_ms), 1)):
                    try:
                        reply = self._rpc_loads(sock.recv())
                    except Exception:  # noqa: BLE001 - bad reply: next hedge
                        self._breaker(socks[sock]).record_failure()
                        poller.unregister(sock)
                        sock.close(linger=0)
                        del socks[sock]
                        continue
                    self._breaker(socks[sock]).record_success()
                    if isinstance(reply, dict) and 'error' in reply:
                        # A refusal (e.g. a legacy server's unknown-rpc
                        # reply) is breaker-success — the server is alive —
                        # but NOT a win: keep waiting on the other hedges
                        # for a real answer, and only surface the first
                        # refusal if nobody produces one.
                        error_reply = error_reply or reply
                        poller.unregister(sock)
                        sock.close(linger=0)
                        del socks[sock]
                        continue
                    return reply
            for endpoint in socks.values():
                # Everyone we asked sat on the request for the whole
                # timeout: that is breaker-visible failure evidence.
                self._breaker(endpoint).record_failure()
            return error_reply
        finally:
            for sock in socks:
                sock.close(linger=0)

    # -- client control plane (attach / renew / credits) -----------------

    def _client_control_loop(self):
        """Background control-plane pump: attach to every server (admission
        handshake, shipping the deterministic resume cursor where one is
        known — the reconnect-with-resume handoff), renew the admission
        lease each server lease period, and flush flow-control credit
        grants. Uses only fresh REQ sockets — never the pump thread's."""
        while not (self._stopped or self._closed):
            now = time.monotonic()
            for endpoint in self._rpc_endpoints:
                with self._acct_lock:
                    st = self._attach_state.get(endpoint)
                    if st is None:
                        continue
                    status = st['status']
                    if status in ('legacy', 'excluded'):
                        continue
                    if status == 'attached':
                        renew_every = st['lease_s'] or DEFAULT_LEASE_S
                        due = now - st['last_renew'] >= renew_every
                    else:
                        due = now >= st['next_try']
                if due:
                    self._do_attach(endpoint)
                if self._stopped or self._closed:
                    break
            self._flush_credits()
            self._flush_wire_acks()
            self._ctl_wake.wait(0.25)
        # Best-effort detach: free the admission slot promptly instead of
        # letting it age out of the server's ledger.
        if self._stopped:
            for endpoint, st in list(self._attach_state.items()):
                if st['status'] == 'attached':
                    try:
                        self._rpc_attempt(endpoint,
                                          {'cmd': 'detach',
                                           'consumer': self._consumer_id},
                                          timeout_ms=300)
                    except Exception:  # noqa: BLE001 - it ages out anyway
                        pass

    def _do_attach(self, endpoint, cursor=_MISSING):
        """One attach/renew round-trip to ``endpoint``; returns the reply
        (None when unreachable) and updates the attach ledger."""
        if cursor is _MISSING:
            cursor = self.det_cursor(endpoint)
        request = {'cmd': 'attach', 'consumer': self._consumer_id,
                   'wire': self._wire_caps}
        if self._tenant is not None:
            request['tenant'] = self._tenant
        if self._flow_control:
            request['credits'] = self._flow_control
        if cursor is not None:
            request['resume_cursor'] = cursor
        try:
            reply = self._one_shot_rpc(endpoint, request, timeout_ms=2000, control=True)
        except Exception:  # noqa: BLE001 - control plane is best-effort
            reply = None
        now = time.monotonic()
        outcome = None
        replaced_segment = granted_segment = None
        with self._acct_lock:
            st = self._attach_state.setdefault(
                endpoint, {'status': 'new', 'next_try': 0.0,
                           'last_renew': 0.0, 'lease_s': None})
            if reply is None:
                st['status'] = 'unreachable'
                st['next_try'] = now + 1.0
            elif reply.get('refused'):
                reason = reply['refused']
                if st['status'] != 'excluded':
                    st['status'] = 'refused-{}'.format(reason)
                # Recorded for _enforce_admission on the consuming thread:
                # overload raises / excludes; a draining refusal also
                # excludes (a never-admitted consumer must not steal the
                # drain's tail from the admitted ones).
                self._admission_refused[endpoint] = reason
                if reason != 'overloaded':
                    self._draining_eps.add(endpoint)
                st['next_try'] = now + 5.0
            elif 'error' in reply:
                # Pre-lease server: no attach rpc. Nothing to renew, ever.
                st['status'] = 'legacy'
            else:
                st['status'] = 'attached'
                st['last_renew'] = now
                st['lease_s'] = reply.get('lease_s')
                # Wire grant for this session (renegotiated every renew:
                # a second consumer attaching demotes shm to arrow on the
                # next lease beat). No 'wire' key = pre-wire server.
                previous = (self._endpoint_wire.get(endpoint) or {}).get('segment')
                self._endpoint_wire[endpoint] = (
                    reply.get('wire')
                    or {'transport': wire_mod.TRANSPORT_PICKLE})
                granted_segment = self._endpoint_wire[endpoint].get('segment')
                if previous and previous != granted_segment:
                    # A new session's ring in place of an expired one: the
                    # server freed the old ring, so its map only holds memory.
                    replaced_segment = previous
                self._admission_refused.pop(endpoint, None)
                sid = reply.get('server_id')
                if sid is not None:
                    self._endpoint_sids[endpoint] = sid
                    self._sid_rpc[sid] = endpoint
                    known = self._rings_known.setdefault(sid, [])
                    if granted_segment is not None and granted_segment not in known:
                        known.append(granted_segment)
                was_announced = endpoint in self._reconnect_announce
                self._reconnect_announce.discard(endpoint)
                if reply.get('resume') == 'cursor':
                    # A server accepted our shipped cursor: that IS a
                    # cursor-handoff reconnect, whether or not the lease
                    # expiry registered first (a fast replacement can
                    # beat the expiry check).
                    outcome = 'resumed'
                elif was_announced:
                    outcome = 'redelivered'
        if granted_segment is not None and granted_segment != previous:
            # Map a new ring at once: the server frees it when this
            # consumer's admission expires, and the descriptors it already
            # sent on it must still decode from the map after that.
            self._wire().can_map(granted_segment)
        if replaced_segment is not None and sid is None and self._wire_client is not None:
            # A server that names no id: its old ring is retired now. Else
            # descriptors of it may still sit in the data socket, and the
            # pump retires it once a chunk of a later ring arrives.
            self._wire_client.retire_segment(replaced_segment)
        if outcome is not None:
            # Reconnect accounting: 'resumed' = the replacement built its
            # stream from our cursor (bit-identical continuation);
            # 'redelivered' = snapshot-ring / from-scratch replay with
            # seq/det dedupe (at-least-once made exactly-once).
            self._m_reconnects.labels(outcome).inc()
            logger.info('reconnected to data-service server %s (%s)',
                        endpoint, outcome)
        return reply

    def _flush_credits(self):
        """Grant the servers back the credits of chunks received since the
        last flush (batched at half the initial window)."""
        if not self._flow_control:
            return
        threshold = max(1, self._flow_control // 2)
        with self._acct_lock:
            grants = {sid: n for sid, n in self._credit_owed.items()
                      if n >= threshold}
            endpoints = {sid: self._sid_rpc.get(sid) for sid in grants}
            for sid in grants:
                self._credit_owed[sid] = 0
        for sid, n in grants.items():
            endpoint = endpoints[sid]
            if endpoint is None:
                continue    # no mapping: server predates the control plane
            delivered = False
            try:
                delivered = self._one_shot_rpc(
                    endpoint, {'cmd': 'credit', 'n': n},
                    timeout_ms=1500, control=True) is not None
            except Exception:  # noqa: BLE001 - restored below
                logger.debug('credit grant to %s failed', endpoint,
                             exc_info=True)
            if not delivered:
                # Put the grant back for the next flush: a dropped credit
                # rpc must not permanently shrink the server's window
                # into a both-sides-healthy wedge. (A reply lost AFTER
                # the server applied it re-grants later — the bound
                # loosens by one batch rather than tightening forever.)
                with self._acct_lock:
                    self._credit_owed[sid] = self._credit_owed.get(sid, 0) + n

    def _flush_wire_acks(self):
        """Release consumed shm-tier chunks back to their servers' rings:
        drain the seqs whose views were finalized since the last tick and
        batch them into one ``wire_ack`` rpc per endpoint. Segment ->
        endpoint routing comes from the attach grants; acks for a segment
        no grant names anymore (the server restarted under a new identity
        and its ring died with it) are dropped — idempotent, like the
        server side (``ServerWire.ack`` frees already-freed regions as a
        no-op)."""
        wc = self._wire_client
        if wc is None:
            return
        acks = wc.drain_acks()
        if not acks:
            return
        with self._acct_lock:
            seg_ep = {g['segment']: ep
                      for ep, g in self._endpoint_wire.items()
                      if g.get('segment')}
        for segment, seqs in acks.items():
            endpoint = seg_ep.get(segment)
            if endpoint is None:
                continue
            delivered = False
            try:
                delivered = self._one_shot_rpc(
                    endpoint, {'cmd': 'wire_ack',
                               'consumer': self._consumer_id, 'seqs': seqs},
                    timeout_ms=1500, control=True) is not None
            except Exception:  # noqa: BLE001 - requeued below
                logger.debug('wire ack flush to %s failed', endpoint,
                             exc_info=True)
            if not delivered:
                # A dropped ack must not pin ring regions on a healthy
                # server (the ring would fill and every chunk would fall
                # back to arrow): requeue for the next tick.
                wc.requeue_acks(segment, seqs)

    # -- health supervision (petastorm_tpu_torch.health) -----------------------

    def attach_health(self, registry):
        """Register the receive loop with a
        :class:`~petastorm_tpu_torch.health.HeartbeatRegistry` (called by a
        wrapping ``TorchLoader``, or directly): the heartbeat is beaten per
        received chunk, the probe reports per-server silence ages and rpc
        liveness, and the soft recovery fails a shared stream over to the
        surviving servers when a probe finds one dead."""
        from petastorm_tpu_torch import health as health_mod
        self._hb_recv = registry.register('remote-recv')
        self._hb_recv.beat('poll')
        registry.register_probe('remote-recv', self._health_probe)

        def failover(diagnosis):
            # The diagnosing probe already paid for the rpc round-trips;
            # reuse its verdict instead of probing all servers again.
            dead = (diagnosis.get('probes', {}).get('remote-recv', {})
                    .get('dead_endpoints'))
            if dead is not None:
                return self._mark_failed(dead)
            return self.failover_dead_servers()

        registry.register_recovery(health_mod.REMOTE_SERVER_DEAD, failover)

    def probe_servers(self, timeout_ms=500):
        """rpc liveness of every server not already failed over:
        ``(alive, dead)`` where ``alive`` maps rpc endpoint -> its
        ``stats`` reply and ``dead`` lists the endpoints whose whole retry
        budget went unanswered. Also learns the endpoint -> server_id
        mapping used by failover. Endpoints already in
        ``diagnostics['failed_over_servers']`` are skipped — re-paying the
        full retry budget for a known-dead server on every watchdog tick
        would stall the supervisor itself."""
        alive, dead = {}, []
        now = time.monotonic()
        with self._acct_lock:
            already_failed = set(self._failed_endpoints)
            # Lease-informed liveness: a server with a fresh lease is
            # alive (no rpc round-trip), one whose lease expired is dead
            # — the heartbeat replaces the per-tick rpc probe wherever a
            # server ever heartbeat. The latest incarnation per endpoint
            # wins (a restarted server renews under a new sid).
            lease_by_ep = {}
            for sid, info in self._lease.items():
                ep = info.get('rpc')
                if ep is None:
                    continue
                prev = lease_by_ep.get(ep)
                if prev is None or info['deadline'] > prev['deadline']:
                    lease_by_ep[ep] = dict(info, sid=sid)
        for endpoint in self._rpc_endpoints:
            if endpoint in already_failed:
                continue
            lease = lease_by_ep.get(endpoint)
            if lease is not None and now <= lease['deadline']:
                # Fresh lease: alive with zero rpc round-trips.
                alive[endpoint] = {'server_id': lease['sid'],
                                   'state': lease['state'],
                                   'lease': 'fresh'}
                with self._acct_lock:
                    self._endpoint_sids[endpoint] = lease['sid']
                continue
            # Expired (or absent) lease: fall back to the rpc probe.
            # Lease deadlines are stamped when the CONSUMER thread drains
            # the control socket, so a probe sweeping from the watchdog
            # thread while the consumer is paused would otherwise brand a
            # healthy, answering server dead off a stale client-side view.
            if self._probe_dead_until.get(endpoint, 0) > now:
                dead.append(endpoint)   # recently probed dead: don't re-pay
                continue
            reply = self._one_shot_rpc(endpoint, {'cmd': 'stats'},
                                       timeout_ms=timeout_ms)
            if reply is None or 'error' in reply:
                self._probe_dead_until[endpoint] = now + _PROBE_DEAD_BACKOFF_S
                dead.append(endpoint)
            else:
                self._probe_dead_until.pop(endpoint, None)
                alive[endpoint] = reply
                if reply.get('server_id') is not None:
                    with self._acct_lock:   # _servers_accounted iterates this
                        self._endpoint_sids[endpoint] = reply['server_id']
        return alive, dead

    def fleet_metrics(self, timeout_ms=2000):
        """Fleet-wide metrics: ask every data-service server for its
        registry snapshot (the ``metrics`` RPC) and fold the replies into
        one aggregate (counters/histograms sum per name+labels — see
        :func:`petastorm_tpu_torch.metrics.aggregate_snapshots`). This is the
        service-level signal an autoscaler consumes: the
        decode fleet's bottleneck classes, chunk-store hit rates, and
        retry/respawn counts in one scrape, no per-server plumbing.

        Returns ``{'servers': {rpc_endpoint: snapshot}, 'aggregate':
        merged_snapshot, 'unreachable': [endpoints]}``; the caller decides
        whether missing servers invalidate the sample. The local
        consumer's own registry is NOT folded in (scrape it directly) —
        the aggregate describes the remote decode tier. Servers
        co-located in one PROCESS share a registry; their replies carry
        the process's registry uuid and the aggregate folds each process
        in exactly once (summing identical snapshots would double every
        counter)."""
        from petastorm_tpu_torch import metrics as metrics_mod
        snap = metrics_mod.scrape_fleet_metrics(
            self._rpc_endpoints,
            lambda ep: self._one_shot_rpc(ep, {'cmd': 'metrics'},
                                          timeout_ms=timeout_ms))
        # Per-endpoint wire tier mix (from the attach grants): a mixed-
        # version fleet shows e.g. {'…:5555': 'shm', '…:6555': 'pickle'}
        # — the operator's signal that some servers predate the
        # negotiated wire (or refused shm) and are paying serialization.
        with self._acct_lock:
            snap['wire'] = {
                ep: (grant or {}).get('transport',
                                      wire_mod.TRANSPORT_PICKLE)
                for ep, grant in self._endpoint_wire.items()}
        return snap

    def _health_probe(self):
        """Watchdog probe: runs only while SOME stage looks stalled (any
        classification, not just remote ones), never on the hot path — so
        the rpc round-trips are acceptable, and already-failed-over
        endpoints are excluded to keep each sweep bounded."""
        diag = self.diagnostics
        _alive, dead = self.probe_servers()
        with self._acct_lock:
            draining = sorted(self._draining_eps)
            refused = dict(self._admission_refused)
        return {'server_last_chunk_age_s': diag['server_last_chunk_age_s'],
                'servers_ended': diag['servers_ended'],
                'failed_over': diag['failed_over_servers'],
                'dead_endpoints': dead,
                # Drain/admission states feed the watchdog's
                # server-draining / server-overloaded classifications: a
                # quiet receive loop with a draining (or refusing) server
                # is an operator event, not a mystery stall.
                'draining_endpoints': draining,
                'refused_endpoints': refused}

    def failover_dead_servers(self, timeout_ms=500):
        """Shared-stream soft recovery: mark rpc-dead servers as ended so
        the surviving servers keep feeding and end-of-stream accounting
        completes (grace window) instead of waiting forever on a corpse.
        Sole-consumer streams refuse — their exact end accounting would
        silently truncate the epoch; they surface the death via the stall
        diagnosis / end-of-stream error instead. Returns True when a
        server was failed over."""
        if not self._shared_stream:
            return False
        _alive, dead = self.probe_servers(timeout_ms=timeout_ms)
        return self._mark_failed(dead)

    def _mark_failed(self, dead_endpoints):
        if not self._shared_stream:
            return False
        acted = False
        for endpoint in dead_endpoints:
            with self._acct_lock:   # watchdog thread vs pump-thread readers
                if endpoint in self._failed_endpoints:
                    continue
                self._failed_endpoints.add(endpoint)
                sid = self._endpoint_sids.get(endpoint)
                if sid is not None:
                    self._ended_server_ids.add(sid)
                survivors = self._n_servers - len(self._failed_endpoints)
            acted = True
            logger.warning(
                'data-service server %s unreachable over rpc (whole retry '
                'budget unanswered); failing the shared stream over to %d '
                'surviving server(s)', endpoint, survivors)
        return acted

    def _servers_accounted(self):
        """END-declared servers plus failed-over servers whose identity was
        never learned (they died before answering any rpc, so no sid could
        be added to the ended set). An unknown-dead endpoint may actually
        BE one of the cleanly-ended servers (a server whose process exits
        after END also stops answering rpc), so unknown-dead endpoints only
        count beyond the ENDed sids that no probed endpoint accounts for —
        otherwise a dead-after-END server would be double-counted and end a
        shared stream while a healthy peer is still feeding."""
        with self._acct_lock:
            known_sids = set(self._endpoint_sids.values())
            unmatched_ends = len(self._ended_server_ids - known_sids)
            unknown_dead = sum(1 for e in self._failed_endpoints
                               if self._endpoint_sids.get(e) is None)
            return (len(self._ended_server_ids)
                    + max(0, unknown_dead - unmatched_ends))

    @property
    def transformed_schema(self):
        """The stream's Unischema, fetched once from the first server's rpc
        socket — what lets ``pytorch.DataLoader`` and
        ``tf_utils.make_petastorm_dataset`` consume a RemoteReader exactly
        like a local Reader (they build their namedtuple/tf types from it)."""
        if self._schema is None:
            endpoint = self._rpc_endpoints[0]
            # Hedged: the schema is server-agnostic metadata, so a slow
            # first server costs one hedge delay, not its full slowness.
            # A typed not-ready refusal (an awaiting-cursor replacement
            # whose reader is still building) is retried, not fatal.
            deadline = time.monotonic() + 30.0
            while True:
                reply = self._hedged_rpc({'cmd': 'schema'})
                if (isinstance(reply, dict) and reply.get('retry')
                        and time.monotonic() < deadline):
                    time.sleep(0.25)
                    continue
                break
            if reply is None:
                raise RuntimeError(
                    'server {} did not answer the schema request — is it '
                    'running a build without the schema rpc?'.format(endpoint))
            if reply.get('ngram') is not None:
                # The class-level `ngram = None` relies on the server
                # rejecting per-row/ngram readers; if that invariant ever
                # weakens, fail loudly instead of letting the adapters
                # mis-handle a windowed stream.
                raise RuntimeError('server {} streams an NGram reader; the '
                                   'service adapters do not support windowed '
                                   'rows'.format(endpoint))
            if reply.get('schema') is None:
                raise RuntimeError('server {} exposes no transformed_schema '
                                   '({})'.format(endpoint,
                                                 reply.get('error', 'None')))
            self._schema = reply['schema']
        return self._schema

    @property
    def diagnostics(self):
        now = time.monotonic()
        with self._acct_lock:
            # Cleanly-ended servers are excluded: their age would climb
            # forever and trip any 'age > N means dead' monitor — the
            # exact confusion this metric exists to resolve.
            ages = {sid.hex(): round(now - t, 3)
                    for sid, t in self._last_recv.items()
                    if sid not in self._ended_server_ids}
            failed_over = sorted(self._failed_endpoints)
            leases = {sid.hex(): {'remaining_s': round(info['deadline']
                                                       - now, 3),
                                  'state': info['state'],
                                  'expired': sid in self._lease_expired}
                      for sid, info in self._lease.items()
                      if sid not in self._ended_server_ids}
            attach = {ep: st['status']
                      for ep, st in self._attach_state.items()}
            circuit = {ep: b.state for ep, b in self._breakers.items()}
            reconnect_pending = sorted(self._reconnect_deadline)
            wire_tiers = {ep: (g or {}).get('transport')
                          for ep, g in self._endpoint_wire.items()}
            wire_decode_errors = self._wire_decode_errors
            credits_owed = sum(self._credit_owed.values())
        return {'remote_chunks': self._chunks,
                'servers': self._n_servers,
                'servers_ended': len(self._ended_server_ids),
                'pending_chunks': len(self._pending),
                'duplicate_chunks': self._dup_chunks,
                'bad_auth_frames': self._bad_auth_frames,
                # Servers a lease expiry / watchdog liveness probe
                # declared dead and failed over (shared-stream mode only;
                # see failover_dead_servers).
                'failed_over_servers': failed_over,
                # Control-plane view: per-server lease freshness, this
                # consumer's admission status per endpoint, rpc circuit-
                # breaker states, endpoints awaiting a replacement.
                'leases': leases,
                'attach': attach,
                'circuit_breakers': circuit,
                'reconnect_pending': reconnect_pending,
                # Negotiated data-plane tier per endpoint and chunks
                # dropped undecodable (CRC mismatch, a descriptor that
                # outlived its segment across a server restart).
                'wire': wire_tiers,
                'wire_decode_errors': wire_decode_errors,
                # Chunks received and not yet granted back to their
                # servers as credit (flow control; 0 without it).
                'credits_owed': credits_owed,
                # Seconds since each server's last chunk: a server gone
                # silent (SIGKILL, network partition) shows a growing age
                # here long before the end-of-epoch accounting notices.
                'server_last_chunk_age_s': ages}

    def stop(self):
        # May be called from any thread while another is blocked in
        # __next__ (TorchLoader's pump): never close sockets under a user —
        # mark stopped, and close only if no one is mid-iteration
        # (otherwise the iterating thread closes at its next poll tick,
        # which is at most poll_timeout_s away).
        self._stopped = True
        self._ctl_wake.set()
        if self._sock_lock.acquire(blocking=False):
            try:
                self._close_sockets()
            finally:
                self._sock_lock.release()

    def join(self):
        # By the time callers join() the iterating thread is done
        # (TorchLoader joins its pump first); finish the close if stop()
        # could not.
        with self._sock_lock:
            self._close_sockets()
        if self._ctl_thread is not None and self._ctl_thread.is_alive():
            self._ctl_thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.stop()
        self.join()
        return False


def _pause_servers(reader, endpoints, drain_once, paused, timeout_s=30.0):
    """Send ``pause_state`` to every server in turn, calling
    ``drain_once()`` while waiting for each reply — the serve loop may be
    parked in an HWM send retry that must complete before it can reach
    the pause boundary. Appends each endpoint to ``paused`` BEFORE
    sending (a server whose reply times out client-side may still park
    later and must be resumed too). Returns the reply dicts. Shared by
    :meth:`RemoteReader.state_dict` and :func:`checkpoint_shared_stream`
    — one copy of a subtle pause protocol, not two drifting ones."""
    zmq = reader._zmq
    replies = []
    for endpoint in endpoints:
        sock = reader._context.socket(zmq.REQ)
        sock.setsockopt(zmq.LINGER, 0)
        try:
            sock.connect(endpoint)
            paused.append(endpoint)
            sock.send(reader._rpc_dumps({'cmd': 'pause_state'}))
            deadline = time.monotonic() + timeout_s
            while not sock.poll(20):
                if not drain_once() and time.monotonic() >= deadline:
                    raise RuntimeError(
                        'server {} did not answer pause_state within '
                        '{}s'.format(endpoint, timeout_s))
            reply = reader._rpc_loads(sock.recv())
        finally:
            sock.close(linger=0)
        if 'error' in reply:
            raise RuntimeError('server {} checkpoint failed: {}'.format(
                endpoint, reply['error']))
        replies.append(reply)
    return replies


def _resume_servers(reader, endpoints):
    for endpoint in endpoints:
        if reader._one_shot_rpc(endpoint, {'cmd': 'resume'}) is None:
            raise RuntimeError('server {} did not acknowledge '
                               'resume'.format(endpoint))


def _best_effort_resume(reader, endpoints):
    """A failure after some servers paused must not leave them parked
    forever (the stream would hang, not error)."""
    for endpoint in endpoints:
        try:
            reader._one_shot_rpc(endpoint, {'cmd': 'resume'},
                                 timeout_ms=5000)
        except Exception:   # noqa: BLE001 - already failing
            logger.exception('could not un-pause server %s after failed '
                             'checkpoint', endpoint)


def _union_received_counts(readers):
    """Exact per-server count of DISTINCT chunks received across all
    ``readers``: reader i holds every seq below its watermark plus its
    extras, so the union is ``[0, max_watermark) ∪ {extras >= max_w}``
    (extras below another reader's watermark are already covered).
    Duplicates that landed on different consumers collapse, unlike a sum
    of per-reader counts."""
    per_sid = {}
    for r in readers:
        for sid, (w, extras) in r._received_seqs().items():
            pw, pex = per_sid.get(sid, (0, set()))
            per_sid[sid] = (max(pw, w), pex | set(extras))
    return {sid: w + sum(1 for e in extras if e >= w)
            for sid, (w, extras) in per_sid.items()}


def checkpoint_shared_stream(readers, timeout_s=60.0):
    """Coordinated mid-epoch checkpoint for SEVERAL RemoteReaders sharing
    the same servers (``shared_stream=True``) — the topology where
    per-consumer :meth:`RemoteReader.state_dict` is impossible (chunk
    attribution is dynamic, so no single consumer can verify it drained
    its share).

    Protocol — the only precondition is that no trainer CONSUMES batches
    while this runs (a row delivered downstream mid-checkpoint would also
    appear in the snapshot's replay set and arrive twice after resume).
    Background prefetch pumps (``TorchLoader`` staging threads) may stay
    live: receive, drain, and snapshot all share the reader's accounting
    locks, and rows a pump moves from the backlog into its prefetch queue
    remain in the replay set either way
    (``test_shared_stream_checkpoint_through_loaders`` pins this).
    The steps:

    1. pause every server once at a chunk boundary (rpc ``pause_state``),
       collecting its reader state, identity, and sent count;
    2. drain ALL consumers until, for every server, the union of the
       consumers' received seq sets covers its sent count — per-consumer
       counts are unknowable, but each chunk goes to exactly one
       consumer, so the union is exact;
    3. snapshot each consumer's replay set (prefetched-but-unattributed
       rows + undelivered backlog);
    4. resume the servers.

    Returns ``{'server_states': [...], 'consumers': [{'pending': [...]},
    ...]}``: restart server ``i`` with
    ``serve_dataset(resume_state=state['server_states'][i])`` and
    consumer ``j`` with ``RemoteReader(...,
    resume_state=state['consumers'][j], shared_stream=True)`` — the union
    of rows delivered across consumers is exactly-once
    (``tests/test_data_service.py::test_shared_stream_checkpoint``).

    Works in-process as given. Across trainer hosts, run the same
    protocol with each host draining its own reader and a coordinator
    union-merging the per-server received-seq sets
    (``reader._received_seqs()``; a SUM of counts would be fooled by a
    crash-replay chunk landing on two different consumers) over the
    job's control fabric — chunk-to-consumer attribution itself needs no
    exchange.
    """
    if not readers:
        raise ValueError('checkpoint_shared_stream needs at least one reader')
    first = readers[0]
    endpoints = first._rpc_endpoints
    for r in readers[1:]:
        if r._rpc_endpoints != endpoints:
            raise ValueError('all readers must consume the same servers '
                             '(rpc endpoints differ)')
    paused = []
    try:
        def drain_all():
            # Drain EVERY reader while waiting: the serve loop may be
            # parked in an HWM send retry against any consumer (list
            # comprehension: no short-circuit, all readers progress).
            return any([r._drain_one_into_pending() for r in readers])

        replies = _pause_servers(first, endpoints, drain_all, paused)
        states = [r['state'] for r in replies]
        sids = [r['server_id'] for r in replies]
        sents = [r['sent'] for r in replies]
        deadline = time.monotonic() + timeout_s
        while True:
            # Drain until dry BEFORE paying for a union: the union walks
            # every tracker's full extras set (it grows with chunks
            # received on a shared stream), so it must run once per
            # round, not once per drained chunk.
            while drain_all():
                pass
            counts = _union_received_counts(readers)
            if all(counts.get(sid, 0) >= sent
                   for sid, sent in zip(sids, sents)):
                break
            if time.monotonic() >= deadline:
                short = {e: sent - counts.get(sid, 0)
                         for e, sid, sent in zip(endpoints, sids, sents)
                         if counts.get(sid, 0) < sent}
                raise RuntimeError(
                    'shared-stream checkpoint: sent chunks never '
                    'arrived at any consumer (per-server shortfall: '
                    '{}) — a consumer outside `readers` on this '
                    'stream?'.format(short))
            time.sleep(0.02)
        consumers = []
        for r in readers:
            with r._acct_lock:
                consumers.append({'pending': r._pending_snapshot_locked()})
        state = {'server_states': states, 'consumers': consumers}
        _resume_servers(first, endpoints)
        paused = []
        return state
    finally:
        _best_effort_resume(first, paused)


def verify_shared_stream_complete(readers):
    """Exact end-of-stream accounting for shared streams — restores, at
    the job level, the guarantee each shared consumer individually gives
    up (its own end is a grace-window heuristic): after every consumer's
    iteration finished, assert the union of received chunks covers every
    server's advertised total. Raises ``RuntimeError`` on a shortfall
    (lost tail chunks) or on a server that never advertised; returns
    ``{'received': total, 'advertised': total, 'duplicates': n}``.

    Across hosts, union-merge ``reader._received_seqs()`` and each
    reader's advertised map the same way over the job's control fabric.
    """
    counts = _union_received_counts(readers)
    advertised = {}
    dups = 0
    for r in readers:
        for sid, adv in r._advertised.items():
            advertised[sid] = max(advertised.get(sid, 0), adv)
        dups += r._dup_chunks
    # Cross-consumer duplicates (a crashed server's replay landing on a
    # different consumer) show up as sum-of-counts exceeding the union.
    uniq = [r._unique_received() for r in readers]
    dups += sum(sum(u.get(sid, 0) for u in uniq) - n
                for sid, n in counts.items())
    unadvertised = [sid for sid in counts if sid not in advertised]
    if unadvertised:
        raise RuntimeError('{} server(s) never advertised an end count — '
                           'stream incomplete or killed server not yet '
                           'restarted'.format(len(unadvertised)))
    short = {sid: adv - counts.get(sid, 0)
             for sid, adv in advertised.items() if counts.get(sid, 0) < adv}
    if short:
        raise RuntimeError(
            'shared stream incomplete: {} advertised chunk(s) were never '
            'received by any consumer'.format(sum(short.values())))
    return {'received': sum(counts.values()),
            'advertised': sum(advertised.values()),
            'duplicates': dups}


def _next_port_endpoint(endpoint, offset=1):
    """The control (``offset`` 1) or rpc (2) endpoint of a data endpoint: a
    tcp endpoint's port + ``offset``; an ipc endpoint's path with
    ``.<offset>`` appended."""
    if endpoint.startswith('ipc://') and len(endpoint) > len('ipc://'):
        return '{}.{}'.format(endpoint, offset)
    if not endpoint.startswith('tcp://') or ':' not in endpoint[6:]:
        raise ValueError('control endpoint must be given explicitly for '
                         'portless tcp or non-tcp, non-ipc endpoint {!r}'.format(endpoint))
    host, port = endpoint[6:].rsplit(':', 1)
    return 'tcp://{}:{}'.format(host, int(port) + offset)


def _connectable(bound_endpoint):
    """A bound endpoint as something clients can dial.

    Loopback binds pass through unchanged. A wildcard bind
    (``tcp://*:5555`` / ``tcp://0.0.0.0:5555``) has no dialable address,
    so advertise this host's name — correct from other hosts, and
    resolvable locally too. Callers that know a better route (VIP, LB)
    should dial that instead of ``data_endpoint``.
    """
    for wildcard in ('tcp://*:', 'tcp://0.0.0.0:'):
        if bound_endpoint.startswith(wildcard):
            import socket
            port = bound_endpoint[len(wildcard):]
            host = socket.gethostname()
            try:
                socket.gethostbyname(host)
            except OSError:
                # Containers without a DNS/hosts entry for their own
                # hostname: an unresolvable advertisement would break even
                # same-host clients — fall back to loopback (cross-host
                # callers must then dial an explicit address).
                host = '127.0.0.1'
            return 'tcp://{}:{}'.format(host, port)
    return bound_endpoint
