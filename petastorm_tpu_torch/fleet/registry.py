"""Fleet membership registry (counterpart of
``petastorm_tpu/fleet/registry.py``): per-job worker sets built from the
heartbeat stream, soft state only, rebuilt from the next heartbeat round
after a restart.

Every control-plane heartbeat (either dialect: the data plane's binary
``PST_HB`` or the lookup tier's ``PST_LHB`` JSON) carries the member's id,
lease, state and rpc endpoint, and a fleet member's carries a job id and
capacity announce (:func:`~petastorm_tpu_torch.fleet.control_plane.
pack_heartbeat`). The registry folds each beat into a per-job table:

* **join** = the first heartbeat seen (the autoscaler counts a spawned
  worker only once the registry does);
* **leave** = drain observed (state ``drained``) or 3-lease silence;
* a restarted registry reconverges within one heartbeat interval a member.

The ``registry-blackhole`` fault site drops every heartbeat at ingest:
members age out, while drains still complete, since drain completion is
an exchange between the orchestrator and the worker. Metrics:
``pst_fleet_members{job}``, ``pst_fleet_joins_total{job}`` and
``pst_fleet_leaves_total{job,reason}``. The watch thread is
``pstt-fleet-registry``. Heartbeats of the JAX package's servers fold in
alike: the wire is one.
"""

import logging
import threading
import time

from petastorm_tpu_torch.fleet import control_plane

logger = logging.getLogger(__name__)


class FleetRegistry(object):
    """Track per-job fleet membership from heartbeats.

    Socket-free by default: feed parsed heartbeats via
    :meth:`note_heartbeat` (unit tests, in-process fleets), or call
    :meth:`watch` to subscribe a background thread to workers' control
    PUB endpoints.

    :param default_job: job bucket for heartbeats without an announce
        (a bare pre-fleet server); ``None`` ignores them.
    :param auth_key: shared fleet key — binary heartbeats are then
        authenticated before being believed (unauthenticated beats are
        dropped exactly like the consumer side drops them).
    :param fault_injector: a :class:`~petastorm_tpu_torch.faults.
        FaultInjector` whose ``registry-blackhole`` this registry alone
        obeys (the port's own; settable as the attribute of that name);
        ``None`` reads ``PSTT_FAULTS``.
    """

    def __init__(self, default_job=None, auth_key=None, fault_injector=None):
        from petastorm_tpu_torch import metrics as metrics_mod
        self._lock = threading.Lock()
        self._jobs = {}     # job -> {member key -> record dict}
        self._default_job = default_job
        self._auth_key = auth_key
        self.fault_injector = fault_injector
        self._sub_endpoints = []
        self._thread = None
        self._stop = threading.Event()
        self._context = None
        self._m_members = metrics_mod.gauge(
            'pst_fleet_members',
            'Live (non-drained, lease-current) workers the fleet '
            'registry tracks, by job', labelnames=('job',))
        self._m_joins = metrics_mod.counter(
            'pst_fleet_joins_total',
            'Workers whose first heartbeat reached the fleet registry, '
            'by job', labelnames=('job',))
        self._m_leaves = metrics_mod.counter(
            'pst_fleet_leaves_total',
            'Workers that left the fleet registry, by job and reason '
            '(drained/expired)', labelnames=('job', 'reason'))

    # -- ingest ------------------------------------------------------------

    def note_heartbeat(self, hb, now=None):
        """Fold one parsed heartbeat (the :func:`control_plane.
        parse_heartbeat` shape) into membership. Returns the member
        record, or None when the beat was dropped (no job, blackholed,
        unparseable)."""
        from petastorm_tpu_torch import faults
        if hb is None:
            return None
        injector = self.fault_injector or faults.get_injector()
        if injector.should_fire('registry-blackhole'):
            logger.warning('fault injection: registry-blackhole dropping '
                           'heartbeat of %s', hb.get('server_id'))
            return None
        announce = hb.get('announce') or {}
        job = announce.get('job') or self._default_job
        if job is None:
            return None
        now = time.monotonic() if now is None else now
        key = hb.get('name') or hb.get('server_id')
        if key is None:
            return None
        with self._lock:
            members = self._jobs.setdefault(job, {})
            record = members.get(key)
            if record is None:
                record = {'job': job, 'key': key,
                          'server_id': hb.get('server_id'),
                          'joined': now}
                members[key] = record
                self._m_joins.labels(job).inc()
                logger.info('fleet registry: %s joined job %r (rpc %s)',
                            key, job, hb.get('rpc'))
            record.update({
                'state': hb.get('state') or 'serving',
                'lease_s': float(hb.get('lease_s')
                                 or control_plane.DEFAULT_LEASE_S),
                'rpc': hb.get('rpc') or record.get('rpc'),
                'capacity': announce.get('capacity',
                                         record.get('capacity')),
                'data': announce.get('data', record.get('data')),
                'last_seen': now,
            })
            self._expire_locked(job, now)
            return dict(record)

    def ingest(self, msg, now=None):
        """Raw PUB traffic in, membership out: parse either heartbeat
        dialect and fold it (non-heartbeat frames — END/ERR markers —
        are ignored)."""
        return self.note_heartbeat(
            control_plane.parse_heartbeat(msg, auth_key=self._auth_key),
            now=now)

    def _expire_locked(self, job, now):
        members = self._jobs.get(job, {})
        for key in list(members):
            record = members[key]
            expiry = (control_plane.EXPIRY_LEASES
                      * record.get('lease_s',
                                   control_plane.DEFAULT_LEASE_S))
            if record.get('state') == 'drained':
                # A drained member left ON PURPOSE: drop it immediately
                # — drain-first scale-down must not hold its slot for
                # three leases.
                members.pop(key)
                self._m_leaves.labels(job, 'drained').inc()
                logger.info('fleet registry: %s left job %r (drained)',
                            key, job)
            elif now - record['last_seen'] > expiry:
                members.pop(key)
                self._m_leaves.labels(job, 'expired').inc()
                logger.warning('fleet registry: %s left job %r (lease '
                               'expired, silent %.1fs)', key, job,
                               now - record['last_seen'])
        self._m_members.labels(job).set(
            sum(1 for r in members.values()
                if r.get('state') != 'drained'))

    def expire(self, now=None):
        """Sweep every job's expired/drained members (the watch thread
        does this per beat; pollers call it before reading)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            for job in list(self._jobs):
                self._expire_locked(job, now)

    # -- queries -----------------------------------------------------------

    def jobs(self):
        with self._lock:
            return sorted(j for j, m in self._jobs.items() if m)

    def members(self, job, states=None):
        """Member records for ``job`` (copies), optionally filtered to
        the given states ('serving', 'draining', ...)."""
        self.expire()
        with self._lock:
            records = [dict(r) for r in self._jobs.get(job, {}).values()]
        if states is not None:
            records = [r for r in records if r.get('state') in states]
        return sorted(records, key=lambda r: r['joined'])

    def worker_count(self, job):
        """Members that count toward the job's size: serving (or still
        warming) — draining/drained workers are already on their way
        out and must not suppress a needed scale-up."""
        return len(self.members(job, states=('serving',
                                             'awaiting-cursor')))

    def pick_warm_peer(self, job, exclude=()):
        """A healthy member a joining worker warms its chunk store from:
        the longest-serving one (warmest cache) that is neither draining
        nor the joiner itself."""
        for record in self.members(job, states=('serving',)):
            if record['key'] not in exclude:
                return record
        return None

    def wait_for_member(self, job, key=None, min_count=1, timeout_s=10.0):
        """Block until ``job`` has ``min_count`` live members (or the
        given member key appears). The autoscaler's scale-up barrier:
        a launched worker counts only once its first heartbeat lands."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if key is not None:
                if any(r['key'] == key for r in self.members(job)):
                    return True
            elif self.worker_count(job) >= min_count:
                return True
            time.sleep(0.05)
        return False

    def snapshot(self):
        """JSON-safe membership dump (the fleet status CLI's payload)."""
        self.expire()
        with self._lock:
            return {job: {key: {k: v for k, v in record.items()
                                if k != 'joined'}
                          for key, record in members.items()}
                    for job, members in self._jobs.items() if members}

    # -- the watch thread --------------------------------------------------

    def watch(self, control_endpoints):
        """Subscribe to workers' control PUB endpoints on a background
        thread ('pstt-fleet-registry'). Idempotent per endpoint; call
        again with new endpoints as the fleet grows."""
        import zmq
        with self._lock:
            fresh = [ep for ep in control_endpoints
                     if ep not in self._sub_endpoints]
            self._sub_endpoints.extend(fresh)
        if self._thread is None:
            self._context = zmq.Context.instance()
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._watch_loop, daemon=True,
                name='pstt-fleet-registry')
            self._thread.start()
        return self

    def _watch_loop(self):
        import zmq
        sock = self._context.socket(zmq.SUB)
        # Both dialects; END/ERR markers are filtered out by prefix.
        sock.setsockopt(zmq.SUBSCRIBE, control_plane.CTRL_HB)
        sock.setsockopt(zmq.SUBSCRIBE, control_plane.CTRL_HB_JSON)
        connected = []
        try:
            while not self._stop.is_set():
                with self._lock:
                    fresh = [ep for ep in self._sub_endpoints
                             if ep not in connected]
                for ep in fresh:
                    try:
                        sock.connect(ep)
                        connected.append(ep)
                    except Exception:  # noqa: BLE001 - endpoint went away
                        logger.warning('fleet registry: cannot subscribe '
                                       'to %s', ep, exc_info=True)
                        connected.append(ep)   # don't retry a bad spec
                if not sock.poll(100):
                    self.expire()
                    continue
                try:
                    self.ingest(sock.recv(flags=zmq.NOBLOCK))
                except zmq.Again:
                    continue
        finally:
            sock.close(linger=0)

    def stop(self):
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.stop()
