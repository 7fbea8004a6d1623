"""LookupServer: the lookup tier's zmq service plane (counterpart of
``petastorm_tpu/serving/server.py``).

``lookup``/``query`` verbs on a ROUTER socket, served inline on one thread
by default (a warm point read is one engine call between two socket
events) or by ``rpc_workers`` inproc REP workers behind it, under the
shared control plane (:mod:`~petastorm_tpu_torch.fleet.control_plane`):

* **lease heartbeats** (``PST_LHB`` + JSON: server id, name, lease, drain
  state, rpc endpoint, the fleet announce and the partition map) on a PUB
  socket every third of the lease;
* **admission**: a consumer ledger with a 3-lease expiry; past
  ``max_consumers``, or under the memory governor's *shed* rung, new
  consumers get the typed ``overloaded`` refusal; under the shed rung a
  fleet member also sheds the partitions it is not primary for;
* **graceful drain** (:meth:`drain` or the ``drain`` verb): every later
  read gets the typed ``draining``/``drained`` refusal, in-flight requests
  finish, and a fleet member first reassigns its key range;
* **fleet membership**: :meth:`init_fleet`, :meth:`adopt_partition_map`,
  the ``pmap``/``pmap_update`` verbs, and :meth:`join_fleet`, whose warm
  join fills this server's ``DecodedChunkStore`` from a peer's chunks over
  the ``chunk`` verb;
* **metrics**: ``pst_lookup_requests_total{verb,outcome}``,
  ``pst_lookup_latency_seconds{verb}`` and, in the engine,
  ``pst_lookup_cache_hits_total{tier}``;
* **fault sites**: ``server-slow``, ``rpc-blackhole``, ``partition-lost``
  (keyed ``p<partition>``, so it fires on every replica alike) and
  ``hb-flap``.

The verbs and their replies, the heartbeats and the metric names are the
JAX package's. Threads are ``pstt-lookup-rpc``, ``pstt-lookup-lease`` and
``pstt-lookup-worker-<i>``. A ``tcp://`` bind derives the heartbeat
endpoint at the rpc port + 1, as the JAX package does; an ``ipc://<path>``
bind derives ``ipc://<path>.1``, as the port's ``DataServer`` does.
Requests and replies are pickle: run the sockets on a trusted network.
"""

import json
import logging
import pickle
import threading
import time
import uuid

from petastorm_tpu_torch.fleet import control_plane

logger = logging.getLogger(__name__)

#: Control-plane heartbeat prefix (PUB broadcasts, JSON body) — the
#: shared control plane's JSON dialect; the fleet registry parses both
#: this and the data plane's binary ``PST_HB``.
CTRL_HB = control_plane.CTRL_HB_JSON

DEFAULT_LEASE_S = control_plane.DEFAULT_LEASE_S


def _one_shot(context, endpoint, request, timeout_ms):
    """Fleet-internal rpc: one REQ round trip, fresh socket, hard
    deadline. Used where a server talks to a PEER (map push, warm-join
    chunk pulls) — peers are not clients, so none of the client-side
    breaker/hedge state applies. Raises ``RpcUnanswered`` on silence."""
    import zmq

    from petastorm_tpu_torch.data_service import RpcUnanswered
    sock = context.socket(zmq.REQ)
    sock.setsockopt(zmq.LINGER, 0)
    try:
        sock.connect(endpoint)
        sock.send(pickle.dumps(request, protocol=5))
        if not sock.poll(int(timeout_ms)):
            raise RpcUnanswered('{} gave no reply within {}ms'.format(
                endpoint, timeout_ms))
        return pickle.loads(sock.recv())
    finally:
        sock.close(linger=0)


class LookupServer(object):
    """Serve a :class:`~petastorm_tpu_torch.serving.engine.LookupEngine` over zmq.

    :param engine: the shared local request path (thread-safe).
    :param bind: rpc endpoint, e.g. ``'tcp://127.0.0.1:*'``. Clients
        dial :attr:`rpc_endpoint`.
    :param control_bind: lease-heartbeat PUB endpoint (default: rpc
        port + 1 for tcp binds, ``<path>.1`` for ipc binds).
    :param lease_s: lease duration (default ``PSTT_LEASE_S`` or 10);
        heartbeats go out every third of it.
    :param max_consumers: admission capacity; ``None`` = unlimited.
    :param rpc_workers: concurrent request handlers. The default (1)
        serves the ROUTER inline on one thread — the LOWEST-latency
        configuration (no inproc hop, no extra thread handoff per
        request; a warm point read is one engine call between two socket
        events). Raise it when many clients run heavy ``query`` scans
        concurrently — point reads then ride the engine's coalescing.
    :param gc_freeze: on :meth:`start`, freeze the baseline object graph
        out of the cyclic collector (``gc.freeze()``). A gen-2 pass over
        a big warm process pauses every thread ~10ms — the exact tail
        the warm-read SLO forbids — while the serving path's own garbage
        is acyclic and dies by refcount. The collector stays ENABLED;
        only startup state stops being re-walked.
    """

    def __init__(self, engine, bind, control_bind=None, lease_s=None,
                 max_consumers=None, rpc_workers=1, gc_freeze=True,
                 server_name=None, job_id=None):
        import zmq

        from petastorm_tpu_torch import membudget
        from petastorm_tpu_torch import metrics as metrics_mod
        from petastorm_tpu_torch.data_service import (_connectable,
                                                _next_port_endpoint)

        self._engine = engine
        self._zmq = zmq
        self._context = zmq.Context.instance()
        self._server_id = uuid.uuid4().hex
        #: Fleet identity: the name placement assigns partitions to.
        #: Operator-chosen for durable fleets; defaults to a fresh one.
        self.server_name = server_name or 'ls-{}'.format(
            self._server_id[:8])
        self._pmap = None
        self._lease_s = control_plane.resolve_lease_s(lease_s)
        self._max_consumers = (None if max_consumers is None
                               else int(max_consumers))
        # Fleet-registry announce: heartbeats carry job + capacity when
        # this server is a declared member of a preprocessing fleet.
        self._job_id = control_plane.resolve_job_id(job_id)
        self._rpc_workers = max(1, int(rpc_workers))
        self._gc_freeze = bool(gc_freeze)
        self._gc_frozen = False

        self._frontend = self._context.socket(zmq.ROUTER)
        self._ctrl_sock = None
        self._backend = None
        try:
            self._frontend.bind(bind)
            actual = self._frontend.getsockopt(zmq.LAST_ENDPOINT).decode()
            ctrl_endpoint = (control_bind if control_bind is not None
                             else _next_port_endpoint(actual))
            self._ctrl_sock = self._context.socket(zmq.PUB)
            self._ctrl_sock.bind(ctrl_endpoint)
            if self._rpc_workers > 1:
                # Worker fan-out: one DEALER bound inproc; each worker
                # thread connects a REP. inproc requires bind-before-
                # connect, so the backend binds here, before any worker
                # thread starts. (rpc_workers=1 serves the ROUTER inline
                # — no backend at all.)
                self._backend = self._context.socket(zmq.DEALER)
                self._inproc = 'inproc://pstt-lookup-{}'.format(
                    self._server_id)
                self._backend.bind(self._inproc)
        except Exception:
            for sock in (self._frontend, self._ctrl_sock, self._backend):
                if sock is not None:
                    sock.close(linger=0)
            raise
        self.rpc_endpoint = _connectable(actual)
        self.control_endpoint = _connectable(
            self._ctrl_sock.getsockopt(zmq.LAST_ENDPOINT).decode())

        self._m_requests = metrics_mod.counter(
            'pst_lookup_requests_total',
            'Lookup-tier rpc requests, by verb and outcome',
            labelnames=('verb', 'outcome'))
        self._m_latency = metrics_mod.histogram(
            'pst_lookup_latency_seconds',
            'Lookup-tier request service latency, by verb',
            labelnames=('verb',))
        self._m_rejected = metrics_mod.counter(
            'pst_consumers_rejected_total',
            'Consumer attach requests a data-service server refused',
            labelnames=('reason',))
        self._m_map_version = metrics_mod.gauge(
            'pst_partition_map_version',
            'Partition-map version this actor currently holds',
            labelnames=('actor',))
        self._m_reassign = metrics_mod.counter(
            'pst_partition_reassignments_total',
            'Partition-map recomputations this server initiated, '
            'by reason',
            labelnames=('reason',))

        # The admission ledger's lock doubles as this server's one lock
        # (consumers, in-flight requests and the map change together).
        self._admission = control_plane.AdmissionLedger(self._lease_s)
        self._lock = self._admission.lock
        self._drain_state = control_plane.DrainState()
        self._draining = self._drain_state.draining
        self._drained = self._drain_state.drained
        self._stop = threading.Event()
        self._inflight = 0             # requests inside worker handlers
        self._response_bytes = 0       # serialized replies not yet sent
        self.requests_served = 0

        # Memory-governor wiring: response bytes in flight are accounted,
        # and the *shed* rung flips this server to typed memory-pressure
        # refusals for new consumers (existing ones keep reading — load
        # shedding must not break clients mid-conversation).
        self._mem_shed = False
        self._mem_handle = membudget.register_pool(
            'lookup-responses', self._response_nbytes,
            shed_fn=self._set_mem_shed)

        self._threads = []

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        if self._threads:
            raise RuntimeError('server already started')
        if self._gc_freeze:
            import gc
            gc.collect()
            gc.freeze()
            self._gc_frozen = True
        rpc_target = (self._serve_inline if self._backend is None
                      else self._proxy_loop)
        self._threads = [
            threading.Thread(target=rpc_target, daemon=True,
                             name='pstt-lookup-rpc'),
            threading.Thread(target=self._control_loop, daemon=True,
                             name='pstt-lookup-lease'),
        ]
        if self._backend is not None:
            self._threads += [
                threading.Thread(target=self._worker_loop, args=(i,),
                                 daemon=True,
                                 name='pstt-lookup-worker-{}'.format(i))
                for i in range(self._rpc_workers)]
        for thread in self._threads:
            thread.start()
        return self

    def stop(self):
        if self._gc_frozen:
            # Unpin the start()-time heap snapshot: a process that keeps
            # running after the server stops (a trainer serving between
            # epochs, a test session) must get cyclic collection of that
            # state back, or stop/start cycles grow memory monotonically.
            import gc
            gc.unfreeze()
            self._gc_frozen = False
        self._mem_handle.close()
        self._stop.set()
        joined = True
        for thread in self._threads:
            thread.join(timeout=10)
            joined = joined and not thread.is_alive()
        if joined:
            self._frontend.close(linger=0)
            if self._backend is not None:
                self._backend.close(linger=0)
            self._ctrl_sock.close(linger=0)
        else:  # pragma: no cover - requires a wedged handler
            logger.warning('lookup rpc thread still running after stop(); '
                           'leaking zmq sockets rather than closing them '
                           'from another thread')
        self._threads = []

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.stop()

    # -- drain state machine ----------------------------------------------

    @property
    def state(self):
        return self._drain_state.state()

    def drain(self, timeout_s=30.0, _inflight_floor=0):
        """Stop admitting, refuse further reads with the typed
        ``draining`` reply, wait for in-flight requests to finish, and
        report drained. Idempotent. When this server is a fleet member,
        draining FIRST reassigns its key range: placement is recomputed
        without it (version + 1), adopted locally (the remaining
        heartbeats advertise the new map) and pushed to the surviving
        peers — clients converge and route around the drain while
        in-flight requests finish. ``_inflight_floor`` is the ``drain``
        rpc handler's own request, which is in-flight by definition and
        must not wait on itself."""
        if self._drain_state.request():
            self._reassign_on_drain()
        deadline = time.monotonic() + (timeout_s
                                       if timeout_s is not None else 30.0)
        while time.monotonic() < deadline:
            with self._lock:
                if self._inflight <= _inflight_floor:
                    self._drained.set()
                    return True
            time.sleep(0.01)
        return self._drained.is_set()

    # -- fleet membership --------------------------------------------------

    @property
    def partition_map(self):
        with self._lock:
            return self._pmap

    def init_fleet(self, n_partitions=None, replication=2):
        """Bootstrap a one-member fleet: this server owns every
        partition of a fresh map (version 1). Further replicas
        :meth:`join_fleet` against it."""
        from petastorm_tpu_torch.serving import placement
        pmap = placement.build_partition_map(
            {self.server_name: {'rpc': self.rpc_endpoint,
                                'control': self.control_endpoint}},
            n_partitions=(placement.DEFAULT_PARTITIONS
                          if n_partitions is None else n_partitions),
            replication=replication)
        self.adopt_partition_map(pmap)
        return pmap

    def adopt_partition_map(self, pmap, reason=None):
        """Converge on ``pmap`` (a :class:`PartitionMap` or its wire
        dict) when its version is newer than the held one. Returns True
        when adopted. ``reason`` marks a reassignment THIS server
        initiated (``pst_partition_reassignments_total{reason}``)."""
        from petastorm_tpu_torch.serving.placement import PartitionMap
        if not isinstance(pmap, PartitionMap):
            pmap = PartitionMap.from_wire(pmap)
        with self._lock:
            if self._pmap is not None \
                    and pmap.version <= self._pmap.version:
                return False
            self._pmap = pmap
        self._m_map_version.labels(self.server_name).set(pmap.version)
        if reason is not None:
            self._m_reassign.labels(reason).inc()
        logger.info('lookup server %s adopted partition map v%d '
                    '(members: %s)', self.server_name, pmap.version,
                    sorted(pmap.members))
        return True

    def _push_map_to_peers(self, pmap, timeout_ms=1000):
        """Best-effort ``pmap_update`` to every other member — the
        heartbeat stream converges everyone anyway; the push just makes
        reassignment visible within an rpc round trip instead of a
        heartbeat interval."""
        pushed = 0
        for name, info in sorted(pmap.members.items()):
            if name == self.server_name or not info.get('rpc'):
                continue
            try:
                _one_shot(self._context, info['rpc'],
                          {'cmd': 'pmap_update', 'pmap': pmap.to_wire(),
                           'consumer': 'fleet-{}'.format(self.server_name)},
                          timeout_ms)
                pushed += 1
            except Exception as e:  # noqa: BLE001 - heartbeats converge it
                logger.warning('map push to %s (%s) failed: %r', name,
                               info['rpc'], e)
        return pushed

    def _reassign_on_drain(self):
        from petastorm_tpu_torch.serving import placement
        with self._lock:
            pmap = self._pmap
        if pmap is None or self.server_name not in pmap.members \
                or len(pmap.members) <= 1:
            return
        new_map = placement.remove_member(pmap, self.server_name)
        self.adopt_partition_map(new_map, reason='drain')
        self._push_map_to_peers(new_map)

    def join_fleet(self, peer_endpoint, warm=True, timeout_ms=5000):
        """Join the fleet a peer serves: fetch its map, recompute with
        this server as a member (version + 1), adopt, push to every
        peer — and when ``warm`` (and the engine's hot tier is a
        ``DecodedChunkStore``), pre-fill the owned key range's chunks
        from the peer over the ``chunk`` verb instead of cold-decoding,
        then flush the store so the fills are durable before the first
        client read lands. Returns a summary dict."""
        from petastorm_tpu_torch.serving import placement
        from petastorm_tpu_torch.serving.placement import PartitionMap
        reply = _one_shot(self._context, peer_endpoint,
                          {'cmd': 'pmap',
                           'consumer': 'fleet-{}'.format(self.server_name)},
                          timeout_ms)
        wire = reply.get('pmap') if isinstance(reply, dict) else None
        if wire is None:
            raise ValueError('peer {} holds no partition map — '
                             'init_fleet() it first'.format(peer_endpoint))
        new_map = placement.add_member(PartitionMap.from_wire(wire),
                                       self.server_name,
                                       rpc=self.rpc_endpoint,
                                       control=self.control_endpoint)
        self.adopt_partition_map(new_map, reason='join')
        self._push_map_to_peers(new_map)
        summary = {'version': new_map.version,
                   'partitions': new_map.partitions_of(self.server_name),
                   'warmed_chunks': 0, 'warm_skipped': 0, 'warm_failed': 0}
        if warm:
            summary.update(self._warm_from_peer(peer_endpoint, new_map,
                                                timeout_ms))
        return summary

    def _warm_from_peer(self, peer_endpoint, pmap, timeout_ms):
        """The cache-warming protocol, joining side: for every owned
        piece not already in the hot tier, pull the peer's packed chunk
        and persist it under the shared ``tensor_chunk_key``. Blob bytes
        in flight ride the memory governor like every other pool."""
        from petastorm_tpu_torch import membudget
        engine = self._engine
        if not callable(getattr(engine, 'warm_fill', None)) \
                or not callable(getattr(engine, 'has_cached', None)):
            return {}
        owned = pmap.partitions_of(self.server_name)
        pieces = engine.pieces_for_partitions(pmap, owned)
        warmed = skipped = failed = 0
        inflight = [0]
        with membudget.transient_pool('lookup-warm',
                                      lambda: inflight[0]):
            for piece_index in pieces:
                if engine.has_cached(piece_index):
                    skipped += 1
                    continue
                try:
                    reply = _one_shot(
                        self._context, peer_endpoint,
                        {'cmd': 'chunk', 'piece': piece_index,
                         'consumer': 'warm-{}'.format(self.server_name)},
                        timeout_ms)
                    blob = (reply.get('chunk')
                            if isinstance(reply, dict) else None)
                    if not blob:
                        raise ValueError('peer sent no chunk: {!r}'
                                         .format(reply))
                    inflight[0] = len(blob)
                    if not engine.warm_fill(piece_index, blob):
                        failed += 1
                    else:
                        warmed += 1
                except Exception as e:  # noqa: BLE001 - warm is best-effort
                    # A piece that fails to warm is NOT an error for the
                    # join: it cold-decodes on first read like any miss.
                    logger.warning('warm-join: piece %d pull from %s '
                                   'failed: %r', piece_index,
                                   peer_endpoint, e)
                    failed += 1
                finally:
                    inflight[0] = 0
        engine.flush(timeout_s=30.0)
        return {'warmed_chunks': warmed, 'warm_skipped': skipped,
                'warm_failed': failed}

    # -- membudget hooks ---------------------------------------------------

    def _response_nbytes(self):
        with self._lock:
            return self._response_bytes

    def _set_mem_shed(self, active):
        self._mem_shed = bool(active)

    # -- control plane -----------------------------------------------------

    def _control_loop(self):
        """Owns the PUB socket: lease heartbeats every ``lease_s / 3``
        plus admission-ledger pruning (3 leases without a renew frees a
        crashed consumer's slot)."""
        from petastorm_tpu_torch import faults
        hb_interval = control_plane.heartbeat_interval(self._lease_s)
        while not self._stop.is_set():
            with self._lock:
                pmap = self._pmap
            hb = {'server_id': self._server_id,
                  'name': self.server_name,
                  'lease_s': self._lease_s,
                  'state': self.state,
                  'rpc': self.rpc_endpoint}
            if self._job_id is not None:
                # Fleet announce (same payload the data plane rides on
                # its binary heartbeat tail): membership for the
                # registry, capacity for the autoscaler.
                hb['job'] = self._job_id
                hb['capacity'] = self._max_consumers
            if pmap is not None:
                hb['pmap'] = pmap.to_wire()
            body = json.dumps(hb).encode('utf-8')
            if faults.get_injector().should_fire('hb-flap'):
                logger.warning('fault injection: hb-flap suppressing '
                               'lease heartbeat of %s', self.server_name)
            else:
                self._ctrl_sock.send(CTRL_HB + body)
            now = time.monotonic()
            with self._lock:
                for cid, _entry in self._admission.prune_locked(now):
                    logger.warning('lookup server %s: consumer %s admission '
                                   'lease expired', self.rpc_endpoint, cid)
            self._stop.wait(hb_interval)

    # -- rpc plane ---------------------------------------------------------

    def _proxy_loop(self):
        """The ROUTER <-> inproc DEALER shuttle. Poll-driven so stop()
        can interrupt it; messages route the moment they arrive."""
        zmq = self._zmq
        poller = zmq.Poller()
        poller.register(self._frontend, zmq.POLLIN)
        poller.register(self._backend, zmq.POLLIN)
        while not self._stop.is_set():
            events = dict(poller.poll(100))
            if self._frontend in events:
                self._backend.send_multipart(
                    self._frontend.recv_multipart())
            if self._backend in events:
                self._frontend.send_multipart(
                    self._backend.recv_multipart())

    def _serve_request(self, raw):
        """Decode one request, answer it through the engine under the
        admission/drain rules, time it. Returns the serialized reply, or
        ``None`` when the ``rpc-blackhole`` fault swallowed the request
        (the caller resets its transport state accordingly)."""
        from petastorm_tpu_torch import faults
        if faults.get_injector().should_fire('rpc-blackhole'):
            logger.warning('fault injection: rpc-blackhole dropping '
                           'lookup request without reply')
            return None
        with self._lock:
            self._inflight += 1
        t0 = time.perf_counter()
        verb = 'unknown'
        try:
            try:
                request = pickle.loads(raw)
                verb = str(request.get('cmd') or 'unknown')
                partition = (request.get('partition')
                             if isinstance(request, dict) else None)
                if partition is not None and faults.get_injector() \
                        .should_fire('partition-lost',
                                     key='p{}'.format(partition)):
                    # The "whole key range went dark" drill: every
                    # replica swallows this partition's requests (the
                    # keyed selection fires identically fleet-wide), so
                    # the client must surface a typed failure for the
                    # lost range, never a truncated result.
                    logger.warning('fault injection: partition-lost '
                                   'dropping partition %s request',
                                   partition)
                    return None
                reply = self._handle(request)
            except Exception as e:  # noqa: BLE001 - reply, don't die
                logger.exception('lookup rpc failed')
                reply = {'error': repr(e)}
            outcome = ('refused' if isinstance(reply, dict)
                       and 'refused' in reply
                       else 'error' if isinstance(reply, dict)
                       and 'error' in reply else 'ok')
            self._m_requests.labels(verb, outcome).inc()
            self._m_latency.labels(verb).observe(time.perf_counter() - t0)
            faults.maybe_inject('server-slow')
            try:
                payload = pickle.dumps(reply, protocol=5)
            except Exception as e:  # noqa: BLE001 - degrade typed
                payload = pickle.dumps({'error': repr(e)}, protocol=5)
            with self._lock:
                self.requests_served += 1
            return payload
        finally:
            with self._lock:
                self._inflight -= 1

    def _serve_inline(self):
        """rpc_workers=1: handle requests ON the ROUTER thread. One
        thread, no inproc hop — each warm read is recv, engine call,
        send. A blackholed request is simply not replied to (ROUTER has
        no REP state machine to reset)."""
        while not self._stop.is_set():
            if not self._frontend.poll(100):
                continue
            frames = self._frontend.recv_multipart()
            payload = self._serve_request(frames[-1])
            if payload is None:
                continue
            with self._lock:
                self._response_bytes += len(payload)
            try:
                self._frontend.send_multipart(frames[:-1] + [payload])
            finally:
                with self._lock:
                    self._response_bytes -= len(payload)

    def _worker_loop(self, worker_id):
        """One inproc REP handler behind the proxy (rpc_workers > 1)."""
        zmq = self._zmq
        sock = self._context.socket(zmq.REP)
        sock.connect(self._inproc)
        try:
            while not self._stop.is_set():
                if not sock.poll(100):
                    continue
                raw = sock.recv()
                payload = self._serve_request(raw)
                if payload is None:
                    # Swallowed by the blackhole drill: REP requires
                    # send-before-recv — reset the state machine with a
                    # fresh socket (inproc reconnect is cheap).
                    sock.close(linger=0)
                    sock = self._context.socket(zmq.REP)
                    sock.connect(self._inproc)
                    continue
                with self._lock:
                    self._response_bytes += len(payload)
                try:
                    sock.send(payload)
                finally:
                    with self._lock:
                        self._response_bytes -= len(payload)
        finally:
            sock.close(linger=0)

    def _admit(self, request):
        """Admission/drain gate for one request; a dict = typed refusal
        reply, ``None`` = admitted (and the consumer's lease renewed)."""
        consumer = request.get('consumer') or 'anonymous'
        now = time.monotonic()
        with self._lock:
            known = self._admission.known_locked(consumer)
            state = self.state
            if state in ('draining', 'drained'):
                # Unlike the data plane (which finishes feeding admitted
                # streams), a drained lookup tier refuses EVERY read: each
                # request is standalone, and the typed reply is what makes
                # the client fail over instead of waiting out a corpse.
                self._m_rejected.labels('draining').inc()
                return control_plane.refusal(self._server_id, state, state)
            if not known:
                if self._max_consumers is not None \
                        and self._admission.count_locked() \
                        >= self._max_consumers:
                    self._m_rejected.labels('overloaded').inc()
                    return control_plane.refusal(
                        self._server_id,
                        control_plane.REFUSED_OVERLOADED, state,
                        max_consumers=self._max_consumers)
                if self._mem_shed:
                    self._m_rejected.labels('memory-pressure').inc()
                    return control_plane.refusal(
                        self._server_id,
                        control_plane.REFUSED_OVERLOADED, state,
                        reason=control_plane.REASON_MEMORY_PRESSURE)
            partition = request.get('partition')
            if self._mem_shed and partition is not None \
                    and self._pmap is not None \
                    and not self._pmap.is_primary(self.server_name,
                                                  partition):
                # Governor-shed, partition-aware: under the shed rung a
                # replica keeps serving the partitions it is PRIMARY for
                # (its working set — the reads only it can serve warmest)
                # and sheds secondary-partition traffic back to each
                # partition's own primary via the typed refusal. Known
                # consumers included: shedding must move load, not just
                # refuse strangers.
                self._m_rejected.labels('memory-pressure').inc()
                return control_plane.refusal(
                    self._server_id,
                    control_plane.REFUSED_OVERLOADED, state,
                    reason=control_plane.REASON_MEMORY_PRESSURE,
                    partition=partition)
            if known:
                entry = self._admission.renew_locked(consumer, now)
            else:
                entry = self._admission.admit_locked(consumer, now)
            # Transport tier as a session property (shared vocabulary
            # with the data plane's negotiated wire): lookup replies ride
            # the rpc plane itself, so every session is the pickle tier —
            # recorded anyway so fleet tooling reads ONE ledger shape
            # across data servers and lookup servers.
            entry.setdefault('wire', control_plane.DEFAULT_TRANSPORT)
        return None

    def _handle(self, request):
        cmd = request.get('cmd')
        if cmd == 'attach':
            refusal = self._admit(request)
            if refusal is not None:
                return refusal
            return {'server_id': self._server_id,
                    'name': self.server_name, 'state': self.state,
                    'lease_s': self._lease_s}
        if cmd == 'detach':
            with self._lock:
                self._admission.release_locked(request.get('consumer'))
            return {'ok': True}
        if cmd == 'lookup':
            refusal = self._admit(request)
            if refusal is not None:
                return refusal
            rows = self._engine.lookup(request.get('keys') or (),
                                       fields=request.get('fields'))
            return {'server_id': self._server_id, 'rows': rows}
        if cmd == 'query':
            refusal = self._admit(request)
            if refusal is not None:
                return refusal
            pieces = request.get('pieces')
            pieces_mod = request.get('pieces_mod')
            if pieces_mod is not None:
                # Scatter-gather's modular cover: [pid, n_partitions]
                # names this server's disjoint share of the row groups.
                pid, n_partitions = (int(pieces_mod[0]),
                                     int(pieces_mod[1]))
                pieces = range(pid, self._engine.piece_count,
                               n_partitions)
            rows = self._engine.query(
                request['predicate'],
                selector=request.get('selector'),
                limit=request.get('limit'),
                fields=request.get('fields'),
                pieces=pieces,
                with_locations=bool(request.get('with_locations')))
            return {'server_id': self._server_id, 'rows': rows}
        if cmd == 'pmap':
            with self._lock:
                pmap = self._pmap
            return {'server_id': self._server_id,
                    'name': self.server_name,
                    'pmap': None if pmap is None else pmap.to_wire()}
        if cmd == 'pmap_update':
            adopted = self.adopt_partition_map(request['pmap'])
            with self._lock:
                version = (None if self._pmap is None
                           else self._pmap.version)
            return {'server_id': self._server_id, 'adopted': adopted,
                    'version': version}
        if cmd == 'chunk':
            # Warm-join export: serve one piece's packed chunk to a
            # joining peer. Deliberately NOT behind _admit — a draining
            # replica is exactly who a reassigned partition's new owner
            # evacuates the cache from, and peers are not consumers.
            blob = self._engine.packed_chunk(int(request['piece']))
            return {'server_id': self._server_id,
                    'name': self.server_name,
                    'chunk': blob}
        if cmd == 'drain':
            drained = self.drain(float(request.get('timeout_s', 30.0)),
                                 _inflight_floor=1)
            return {'server_id': self._server_id, 'state': self.state,
                    'drained': bool(drained)}
        if cmd == 'stats':
            with self._lock:
                n_consumers = self._admission.count_locked()
                served = self.requests_served
                pmap = self._pmap
                wire_sessions = control_plane.session_transports_locked(
                    self._admission)
            return {'server_id': self._server_id,
                    'name': self.server_name, 'state': self.state,
                    'lease_s': self._lease_s,
                    'consumers': n_consumers,
                    'wire': wire_sessions,
                    'max_consumers': self._max_consumers,
                    'requests_served': served,
                    'partition_map_version': (None if pmap is None
                                              else pmap.version),
                    'engine': self._engine.stats()}
        if cmd == 'metrics':
            from petastorm_tpu_torch import metrics as metrics_mod
            return {'server_id': self._server_id,
                    'registry_id': metrics_mod.REGISTRY_INSTANCE_ID,
                    'metrics': metrics_mod.get_registry().collect()}
        if cmd == 'schema':
            return {'schema': self._engine.schema,
                    'index': self._engine.index.name,
                    'index_field': self._engine.index.field}
        raise ValueError('unknown rpc command {!r}'.format(cmd))
