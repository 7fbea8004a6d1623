"""LookupClient: fleet-aware point reads with failover, breakers and
hedging (counterpart of ``petastorm_tpu/serving/client.py``).

The consumer half of the lookup tier's control plane
(:mod:`~petastorm_tpu_torch.serving.server`):

* **typed-refusal failover**: a ``{'refused': 'draining'|'overloaded'}``
  reply counts as a breaker success, and the read moves to the next
  endpoint at once; when every endpoint refuses,
  :class:`~petastorm_tpu_torch.errors.ServerOverloaded` carries the reason;
* **per-endpoint circuit breakers**
  (:class:`~petastorm_tpu_torch.retry.BreakerSet`): a blackholed server
  costs the rpc timeout ``breaker_threshold`` times, then is skipped until
  its half-open probe heals;
* **hedged reads**: past ``hedge_after_ms`` of silence the read also goes
  to the next healthy endpoint; the first valid reply wins
  (``pst_lookup_hedges_total``);
* **lease awareness**: the servers' heartbeats, drained between requests,
  send draining or silent endpoints to the back of the candidates;
* **partition routing**: with a
  :class:`~petastorm_tpu_torch.serving.placement.PartitionMap` a key routes
  to its partition's ranked replicas, and every other fleet endpoint forms
  the failover tail, so a read is never silently dropped;
* **scatter-gather**: a multi-key lookup sends one request a partition on
  short-lived ``pstt-fleet-scatter-<partition>`` threads; a query sends
  each partition its modular share of the row-groups and merges the
  replies into single-engine order before the global ``limit``; a
  partition that no endpoint answers raises
  (:class:`~petastorm_tpu_torch.data_service.RpcUnanswered` or
  ``ServerOverloaded``), never a short result;
* **bounded endpoint state**: heartbeat and server-id entries of endpoints
  that left the fleet expire one lease after their last update.

Requests and replies are the JAX package's, so a client of either
package reads from a server of either.
"""

import logging
import pickle
import threading
import time
import uuid

logger = logging.getLogger(__name__)

_REFUSAL_REASONS = ('draining', 'drained', 'overloaded')


class LookupClient(object):
    """Point reads against one or more :class:`LookupServer` endpoints
    serving the SAME dataset (replicas — hedging and failover assume any
    endpoint can answer any read).

    :param endpoints: rpc endpoint list (``tcp://host:port``).
    :param control_endpoints: matching heartbeat endpoints (optional;
        enables lease-aware endpoint ordering).
    :param timeout_ms: whole-request deadline (scatter-gather runs its
        per-partition requests concurrently, each under this same
        deadline — the per-partition deadline).
    :param hedge_after_ms: silence before the next endpoint is hedged.
    :param consumer_id: admission identity (default: a fresh uuid).
    :param partition_map: optional
        :class:`~petastorm_tpu_torch.serving.placement.PartitionMap` (or its
        wire dict) to route by immediately; newer versions learned from
        heartbeats or ``pmap`` replies supersede it.
    """

    def __init__(self, endpoints, control_endpoints=None, timeout_ms=5000,
                 hedge_after_ms=300, consumer_id=None,
                 breaker_threshold=3, breaker_reset_s=15.0,
                 partition_map=None):
        import zmq

        from petastorm_tpu_torch.retry import BreakerSet
        self._zmq = zmq
        self._context = zmq.Context.instance()
        self._endpoints = list(endpoints)
        if not self._endpoints:
            raise ValueError('LookupClient needs at least one endpoint')
        self._timeout_ms = int(timeout_ms)
        self._hedge_after_ms = int(hedge_after_ms)
        self._consumer_id = consumer_id or 'lookup-{}'.format(
            uuid.uuid4().hex[:12])
        self._lock = threading.Lock()
        self._breakers = BreakerSet(failure_threshold=breaker_threshold,
                                    reset_timeout_s=breaker_reset_s)
        # Persistent per-endpoint REQ sockets: a fresh TCP + ZMTP handshake costs several ms —
        # more than a warm point read itself — so sockets that completed
        # a clean round trip are cached and reused. A socket whose
        # request timed out, got a garbled reply, or was abandoned by a
        # winning hedge is CLOSED instead (a REQ state machine cannot
        # take a new request while one is outstanding).
        self._socks = {}
        from petastorm_tpu_torch import metrics as metrics_mod
        self._m_hedges = metrics_mod.counter(
            'pst_lookup_hedges_total',
            'Lookup requests where a hedge was sent to another endpoint')
        self._m_map_updates = metrics_mod.counter(
            'pst_partition_map_updates_total',
            'Partition-map versions this process\'s lookup clients '
            'adopted')
        self._m_part_retries = metrics_mod.counter(
            'pst_partition_retries_total',
            'Partition-routed reads retried on a sibling replica '
            '(failover past the ranked head, or a hedge that fired)')
        self.hedges = 0
        self.scatters = 0
        self.partition_retries = 0
        self._closed = False
        # Lease watching: SUB to every control endpoint; heartbeats drain
        # non-blocking at each request. Keyed by the DIALED rpc endpoint:
        # {endpoint: (state, lease_s, at)}. A heartbeat advertises the
        # server's own view of its rpc address, which can differ from the
        # address the client dialed (wildcard binds resolve to a
        # hostname; the operator dialed an IP) — `_server_ids` maps the
        # heartbeat's server_id to the dialed endpoint, learned from rpc
        # replies (every reply carries `server_id`), so the ranking
        # always looks heartbeats up under the key it ranks by.
        self._hb = {}
        self._server_ids = {}        # server_id -> (endpoint, noted_at)
        self._sub = None
        self._sub_endpoints = set()
        if control_endpoints:
            self._ensure_sub()
            for ctrl_ep in control_endpoints:
                self._sub.connect(ctrl_ep)
                self._sub_endpoints.add(ctrl_ep)
        self._pmap = None
        if partition_map is not None:
            self._adopt_pmap(partition_map)

    # -- endpoint health ---------------------------------------------------

    def _breaker(self, endpoint):
        return self._breakers.get(endpoint)

    def _socket_for(self, endpoint):
        """A ready REQ socket for ``endpoint`` — the cached one (idle,
        clean) or a fresh connect."""
        zmq = self._zmq
        with self._lock:
            sock = self._socks.pop(endpoint, None)
        if sock is None:
            sock = self._context.socket(zmq.REQ)
            sock.setsockopt(zmq.LINGER, 0)
            sock.connect(endpoint)
        return sock

    def _release_socket(self, endpoint, sock):
        """Return a socket whose round trip completed cleanly."""
        with self._lock:
            if self._closed or endpoint in self._socks:
                pass
            else:
                self._socks[endpoint] = sock
                return
        sock.close(linger=0)

    def breaker_state(self, endpoint):
        return self._breaker(endpoint).state

    def _note_server_id(self, endpoint, reply):
        """Bind a reply's server identity to the endpoint we dialed —
        what lets heartbeats (which advertise the server's OWN address
        view) resolve back to the dialed key the ranking uses."""
        sid = reply.get('server_id') if isinstance(reply, dict) else None
        if sid is not None:
            self._server_ids[sid] = (endpoint, time.monotonic())

    def _ensure_sub(self):
        if self._sub is None:
            self._sub = self._context.socket(self._zmq.SUB)
            self._sub.setsockopt(self._zmq.SUBSCRIBE, b'')

    # -- partition map -----------------------------------------------------

    @property
    def partition_map(self):
        return self._pmap

    def _adopt_pmap(self, pmap):
        """Converge on a newer map version; subscribing to any member
        control endpoints not yet watched (a joining replica's
        heartbeats start mattering the moment the map names it)."""
        from petastorm_tpu_torch.serving.placement import PartitionMap
        if not isinstance(pmap, PartitionMap):
            pmap = PartitionMap.from_wire(pmap)
        if self._pmap is not None and pmap.version <= self._pmap.version:
            return False
        self._pmap = pmap
        self._m_map_updates.inc()
        ctrl_eps = [info.get('control')
                    for info in pmap.members.values() if info.get('control')]
        if ctrl_eps:
            self._ensure_sub()
            for ctrl_ep in ctrl_eps:
                if ctrl_ep not in self._sub_endpoints:
                    self._sub.connect(ctrl_ep)
                    self._sub_endpoints.add(ctrl_ep)
        return True

    def refresh_partition_map(self):
        """Pull the fleet's current map over the ``pmap`` verb (the
        deterministic bootstrap — heartbeats converge eventually, this
        converges now). Returns the held map (possibly None when no
        server carries one)."""
        reply = self._request({'cmd': 'pmap'}, hedge=False)
        wire = reply.get('pmap') if isinstance(reply, dict) else None
        if wire is not None:
            self._adopt_pmap(wire)
        return self._pmap

    def _endpoints_all(self):
        """Declared endpoints plus every map member's rpc endpoint —
        the live candidate set."""
        endpoints = list(self._endpoints)
        if self._pmap is not None:
            for info in self._pmap.members.values():
                rpc = info.get('rpc')
                if rpc and rpc not in endpoints:
                    endpoints.append(rpc)
        return endpoints

    def _prune_endpoint_state(self):
        """Bound `_hb`/`_server_ids` against fleet churn: an endpoint no
        longer in the candidate set keeps its entries for one lease
        window (it may be mid-rejoin), then they expire."""
        now = time.monotonic()
        live = set(self._endpoints_all())
        for endpoint, (_, lease_s, at) in list(self._hb.items()):
            if endpoint not in live and now - at > lease_s:
                del self._hb[endpoint]
        for sid, (endpoint, at) in list(self._server_ids.items()):
            if endpoint in live:
                continue
            lease_s = self._hb.get(endpoint, (None, 10.0, 0.0))[1]
            if now - at > lease_s:
                del self._server_ids[sid]

    def _drain_heartbeats(self):
        """Non-blocking: fold every queued lease heartbeat into the
        per-endpoint view — and adopt any newer partition map riding in
        a heartbeat body. (SUB sockets are owned by the caller thread —
        the client is documented single-caller like RemoteReader; the
        scatter worker threads never touch the SUB.)"""
        if self._sub is None:
            self._prune_endpoint_state()
            return
        from petastorm_tpu_torch.serving.server import CTRL_HB
        import json
        zmq = self._zmq
        while True:
            try:
                raw = self._sub.recv(zmq.NOBLOCK)
            except zmq.Again:
                break
            except zmq.ZMQError:
                break
            if not raw.startswith(CTRL_HB):
                continue
            try:
                body = json.loads(raw[len(CTRL_HB):].decode('utf-8'))
            except ValueError:
                continue
            pmap_wire = body.get('pmap')
            if pmap_wire is not None:
                try:
                    self._adopt_pmap(pmap_wire)
                except ValueError:
                    logger.warning('ignoring malformed partition map in '
                                   'heartbeat from %r',
                                   body.get('server_id'))
            # Resolve the heartbeat to the DIALED endpoint the ranking
            # keys by: via the server-id binding learned from replies,
            # else the advertised rpc address when it happens to be one
            # we dial (declared or learned from the map).
            bound = self._server_ids.get(body.get('server_id'))
            endpoint = bound[0] if bound is not None else None
            if endpoint is None:
                rpc = body.get('rpc')
                endpoint = rpc if rpc in self._endpoints_all() else None
            if endpoint is not None:
                self._hb[endpoint] = (body.get('state'),
                                      float(body.get('lease_s') or 10.0),
                                      time.monotonic())
        self._prune_endpoint_state()

    def _candidates(self, partition=None):
        """Endpoints to try, healthiest first: breaker-open endpoints
        last, then lease-draining/expired ones, then everything else in
        declared order. With a routed ``partition``, that partition's
        replicas (placement order, health-sorted stably) head the list
        and every other fleet endpoint forms the failover tail — any
        replica can serve any key, so a partition whose owners all died
        still gets answered rather than silently dropped."""
        from petastorm_tpu_torch.retry import CircuitBreaker
        self._drain_heartbeats()
        now = time.monotonic()

        def rank(endpoint):
            score = 0
            if self._breaker(endpoint).state == CircuitBreaker.OPEN:
                score += 4
            hb = self._hb.get(endpoint)
            if hb is not None:
                state, lease_s, at = hb
                if state in ('draining', 'drained'):
                    score += 2
                if now - at > lease_s:
                    # Heartbeats stopped for a whole lease: presumed dead
                    # without paying an rpc timeout to find out.
                    score += 3
            return score
        ranked = sorted(self._endpoints_all(), key=rank)
        if partition is None or self._pmap is None:
            return ranked
        head = [endpoint
                for endpoint in self._pmap.endpoints(partition)
                if endpoint in set(ranked)]
        head.sort(key=rank)   # stable: replica rank breaks health ties
        return head + [e for e in ranked if e not in set(head)]

    # -- the request core --------------------------------------------------

    def _request(self, request, hedge=True, candidates=None,
                 partition=None):
        """One logical request with failover + hedging. Returns the first
        non-refusal reply; raises ``ServerOverloaded`` when every
        endpoint refused, ``RpcUnanswered`` when nobody answered.
        ``candidates`` overrides the endpoint ordering (scatter workers
        get theirs precomputed on the caller thread — they must not
        touch the single-owner SUB socket); ``partition`` marks a
        partition-routed read so sibling-replica retries are counted."""
        from petastorm_tpu_torch.data_service import RpcUnanswered
        from petastorm_tpu_torch.errors import ServerOverloaded
        zmq = self._zmq
        if self._closed:
            raise RuntimeError('LookupClient is closed')
        request = dict(request, consumer=self._consumer_id)
        payload = pickle.dumps(request, protocol=5)
        if candidates is None:
            candidates = self._candidates(partition=partition)
        deadline = time.monotonic() + self._timeout_ms / 1000.0
        poller = zmq.Poller()
        socks = {}
        pending = list(candidates)
        refusal = None
        sent = 0
        try:
            while True:
                now = time.monotonic()
                if now >= deadline:
                    break
                if pending and (hedge or not socks):
                    endpoint = pending.pop(0)
                    if not self._breaker(endpoint).allow():
                        # Open circuit: skip instantly (the allow() call
                        # is also what grants the half-open heal probe
                        # once the reset timeout elapses).
                        continue
                    # A genuine hedge = sending while another endpoint
                    # still has this request outstanding. A sequential
                    # failover (prior endpoint already answered a typed
                    # refusal, nothing in flight) is NOT one — counting
                    # it would inflate the hedge SLO metric on every
                    # read of a rolling drain.
                    is_hedge = bool(socks)
                    sock = self._socket_for(endpoint)
                    sock.send(payload)
                    sent += 1
                    if partition is not None and sent > 1:
                        # Any send past the ranked head — refusal
                        # failover or a hedge — is a sibling-replica
                        # retry of this partition's read.
                        self._m_part_retries.inc()
                        with self._lock:
                            self.partition_retries += 1
                    poller.register(sock, zmq.POLLIN)
                    socks[sock] = endpoint
                    if is_hedge:
                        self._m_hedges.inc()
                        with self._lock:
                            self.hedges += 1
                elif not socks:
                    break            # everyone answered a refusal/error
                wait_ms = (deadline - now) * 1000.0
                if pending and hedge:
                    wait_ms = min(wait_ms, self._hedge_after_ms)
                for sock, _ in poller.poll(max(int(wait_ms), 1)):
                    endpoint = socks[sock]
                    try:
                        reply = pickle.loads(sock.recv())
                    except Exception:  # noqa: BLE001 - garbled: next hedge
                        self._breaker(endpoint).record_failure()
                        poller.unregister(sock)
                        sock.close(linger=0)
                        del socks[sock]
                        continue
                    self._breaker(endpoint).record_success()
                    self._note_server_id(endpoint, reply)
                    poller.unregister(sock)
                    del socks[sock]
                    self._release_socket(endpoint, sock)
                    if isinstance(reply, dict) and 'refused' in reply:
                        # Typed admission refusal: the server is healthy
                        # but not taking us — remember why, fail over NOW
                        # (don't wait out the hedge delay).
                        refusal = (endpoint, reply)
                        self._hb[endpoint] = (
                            reply.get('state') or reply.get('refused'),
                            self._hb.get(endpoint, (None, 10.0, 0))[1],
                            time.monotonic())
                        continue
                    if isinstance(reply, dict) and 'error' in reply:
                        raise RuntimeError(
                            'lookup rpc failed on {}: {}'.format(
                                endpoint, reply['error']))
                    return reply
                if not socks and not pending:
                    break
            for endpoint in socks.values():
                # Sat on the request for the whole budget: breaker-visible.
                self._breaker(endpoint).record_failure()
            if refusal is not None:
                endpoint, reply = refusal
                raise ServerOverloaded(
                    'every lookup endpoint refused this consumer '
                    '(last: {} said {!r})'.format(endpoint,
                                                  reply.get('refused')),
                    endpoint=endpoint,
                    reason=reply.get('reason') or reply.get('refused'))
            raise RpcUnanswered(
                'no lookup endpoint answered within {}ms (tried {})'.format(
                    self._timeout_ms, candidates))
        finally:
            for sock in socks:
                sock.close(linger=0)

    def _scatter(self, jobs):
        """Fan ``[(partition, request)]`` out, one request per
        partition, each under the full request deadline (the
        per-partition deadline — partitions run concurrently). Candidate
        lists are computed HERE, on the calling thread (the SUB socket
        is single-owner); the short-lived scatter workers only run
        ``_request``, whose shared state (breakers, socket cache,
        counters) is lock-guarded. Partial failure is loud: when any
        partition exhausts its replicas AND the failover tail, the first
        error is raised — a scatter never returns a silently truncated
        result set."""
        plans = [(pid, request, self._candidates(partition=pid))
                 for pid, request in jobs]
        with self._lock:
            self.scatters += 1
        if len(plans) == 1:
            pid, request, candidates = plans[0]
            return {pid: self._request(request, candidates=candidates,
                                       partition=pid)}
        replies, errors = {}, {}

        def serve_one(pid, request, candidates):
            try:
                replies[pid] = self._request(request,
                                             candidates=candidates,
                                             partition=pid)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errors[pid] = e

        threads = [threading.Thread(
            target=serve_one, args=plan, daemon=True,
            name='pstt-fleet-scatter-{}'.format(plan[0]))
            for plan in plans]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join()
        if errors:
            raise errors[sorted(errors)[0]]
        return replies

    # -- public verbs ------------------------------------------------------

    def lookup(self, keys, fields=None):
        """Point reads: per key, the list of matching rows
        (``{field: numpy value}`` dicts; empty list = absent key).
        With a partition map, keys group by partition and scatter to
        each partition's ranked replicas; duplicate keys in one request
        are fetched once and answered at every position."""
        keys = list(keys)
        fields = list(fields) if fields else None
        pmap = self._pmap
        if pmap is None or not keys:
            reply = self._request({'cmd': 'lookup', 'keys': keys,
                                   'fields': fields})
            return reply['rows']
        groups = {}        # partition -> unique keys, first-seen order
        for key in keys:
            bucket = groups.setdefault(pmap.partition_of_key(key), [])
            if not any(str(key) == str(seen) for seen in bucket):
                bucket.append(key)
        replies = self._scatter(
            [(pid, {'cmd': 'lookup', 'keys': bucket, 'fields': fields,
                    'partition': pid})
             for pid, bucket in sorted(groups.items())])
        rows_by_key = {}
        for pid, bucket in groups.items():
            for key, rows in zip(bucket, replies[pid]['rows']):
                rows_by_key[str(key)] = rows
        return [rows_by_key[str(key)] for key in keys]

    def lookup_one(self, key, fields=None):
        """The single row for ``key``, or ``None`` when absent; raises
        on a key matching several rows (use :meth:`lookup`)."""
        rows = self.lookup([key], fields=fields)[0]
        if len(rows) > 1:
            raise ValueError('key {!r} matches {} rows'.format(
                key, len(rows)))
        return rows[0] if rows else None

    def query(self, predicate, selector=None, limit=None, fields=None):
        """Server-side predicate scan (``predicates.in_lambda`` etc.,
        with optional ``selectors`` row-group pruning). The predicate and
        selector must be picklable — module-level functions, not bare
        lambdas.

        With a partition map, the scan scatters: each partition serves
        its disjoint modular share of the row groups (tagged with row
        locations), and the gather merges every partial back into
        single-engine dataset order before applying ``limit`` ACROSS
        partitions — each partition's own ``limit``-cut is a superset of
        its contribution to the global cut, so the merge is exact, and
        an empty partition simply contributes nothing."""
        fields = list(fields) if fields else None
        base = {'cmd': 'query', 'predicate': predicate,
                'selector': selector, 'limit': limit, 'fields': fields}
        pmap = self._pmap
        if pmap is None:
            return self._request(base)['rows']
        replies = self._scatter(
            [(pid, dict(base, partition=pid,
                        pieces_mod=[pid, pmap.n_partitions],
                        with_locations=True))
             for pid in range(pmap.n_partitions)])
        tagged = []
        for pid in sorted(replies):
            tagged.extend(replies[pid]['rows'])
        tagged.sort(key=lambda item: (item['piece'], item['offset']))
        if limit is not None:
            tagged = tagged[:max(int(limit), 0)]
        return [item['row'] for item in tagged]

    def attach(self):
        """Explicit admission handshake (reads attach implicitly)."""
        return self._request({'cmd': 'attach'}, hedge=False)

    def stats(self):
        return self._request({'cmd': 'stats'})

    def schema(self):
        return self._request({'cmd': 'schema'})['schema']

    def routing_table(self):
        """The client's current fleet view, JSON-safe: map version,
        per-partition replica ranking with each replica's breaker state
        and lease freshness. Empty partitions dict when no map is
        known."""
        self._drain_heartbeats()
        pmap = self._pmap
        if pmap is None:
            return {'version': None, 'n_partitions': None,
                    'replication': None, 'members': {}, 'partitions': {}}
        now = time.monotonic()
        partitions = {}
        for pid in range(pmap.n_partitions):
            entries = []
            for rank, name in enumerate(pmap.replicas(pid)):
                endpoint = (pmap.members.get(name) or {}).get('rpc')
                hb = self._hb.get(endpoint)
                entries.append({
                    'rank': rank, 'name': name, 'endpoint': endpoint,
                    'breaker': self._breaker(endpoint).state
                    if endpoint else None,
                    'hb_state': hb[0] if hb else None,
                    'lease_fresh': (now - hb[2] <= hb[1])
                    if hb else None})
            partitions[str(pid)] = entries
        return {'version': pmap.version,
                'n_partitions': pmap.n_partitions,
                'replication': pmap.replication,
                'members': {name: dict(info)
                            for name, info in pmap.members.items()},
                'partitions': partitions}

    def scatter_stats(self):
        """Counters for the scatter-gather path of THIS client."""
        with self._lock:
            return {'scatters': self.scatters,
                    'partition_retries': self.partition_retries,
                    'hedges': self.hedges}

    def fleet_metrics(self, timeout_ms=2000):
        """Per-server metrics snapshots + the summed fleet aggregate —
        the same shape as ``RemoteReader.fleet_metrics()`` (deduped on
        the process registry id so co-located servers fold once)."""
        from petastorm_tpu_torch import metrics as metrics_mod
        return metrics_mod.scrape_fleet_metrics(
            self._endpoints_all(),
            lambda ep: self._request_one(ep, {'cmd': 'metrics'},
                                         timeout_ms),
            server_value='reply', unreachable_detail=True)

    def _request_one(self, endpoint, request, timeout_ms):
        """Single-endpoint rpc (no failover) under the breaker."""
        from petastorm_tpu_torch.data_service import RpcUnanswered
        zmq = self._zmq
        breaker = self._breaker(endpoint)
        if not breaker.allow():
            raise RpcUnanswered('{} circuit open'.format(endpoint))
        sock = self._socket_for(endpoint)
        clean = False
        try:
            sock.send(pickle.dumps(dict(request,
                                        consumer=self._consumer_id),
                                   protocol=5))
            if not sock.poll(timeout_ms):
                breaker.record_failure()
                raise RpcUnanswered('{} gave no reply within {}ms'.format(
                    endpoint, timeout_ms))
            reply = pickle.loads(sock.recv())
            breaker.record_success()
            self._note_server_id(endpoint, reply)
            clean = True
            return reply
        finally:
            if clean:
                self._release_socket(endpoint, sock)
            else:
                sock.close(linger=0)

    def close(self):
        self._closed = True
        with self._lock:
            cached, self._socks = dict(self._socks), {}
        for sock in cached.values():
            sock.close(linger=0)
        if self._sub is not None:
            self._sub.close(linger=0)
            self._sub = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
