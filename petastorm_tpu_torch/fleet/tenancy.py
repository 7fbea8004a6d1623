"""Tenant isolation for shared fleet workers (counterpart of
``petastorm_tpu/fleet/tenancy.py``): per-tenant slices of the admission
capacity, of the credit window and of the host-memory budget, and the
per-tenant SLO metrics.

A :class:`TenantLedger` plugs into
:class:`~petastorm_tpu_torch.data_service.DataServer` (``tenants=``);
consumers carry a ``tenant`` on attach (``RemoteReader(tenant=...)``) and
every quota is scoped to that tenant alone:

* ``max_consumers`` a tenant: a tenant at its cap is refused while the
  other tenants' attaches land;
* ``credits`` a tenant: the initial credit grant is clamped to what is
  left of the tenant's partition of the flow-control window;
* ``mem_budget`` a tenant: bytes charged to the tenant count against its
  own sub-pool; the total rides the process
  :mod:`~petastorm_tpu_torch.membudget` governor, whose *shed* rung sheds
  the heaviest tenant first.

Refusals are the fleet's typed vocabulary: ``refused='overloaded'`` with
``reason='tenant-over-budget'``
(:data:`~petastorm_tpu_torch.fleet.control_plane.REASON_TENANT_OVER_BUDGET`),
counted in ``pst_fleet_tenant_refusals_total{tenant,reason}``; the other
series are ``pst_fleet_tenant_{consumers,credits,mem_bytes}`` and
``pst_fleet_tenant_attaches_total``. The wire of ``DataServer`` and
``RemoteReader`` does not change.
"""

import logging
import threading

from petastorm_tpu_torch.fleet import control_plane

logger = logging.getLogger(__name__)


class TenantQuota(object):
    """Per-tenant caps; ``None`` anywhere = uncapped.

    :param credits: this tenant's partition of the credit window
        (total initial grants outstanding across its consumers).
    :param max_consumers: concurrent admitted consumers.
    :param mem_budget: bytes (int, or a '512m'-style string fed to
        :func:`petastorm_tpu_torch.membudget.parse_bytes`).
    """

    def __init__(self, credits=None, max_consumers=None, mem_budget=None):
        from petastorm_tpu_torch import membudget
        self.credits = None if credits is None else int(credits)
        self.max_consumers = (None if max_consumers is None
                              else int(max_consumers))
        if isinstance(mem_budget, str):
            mem_budget = membudget.parse_bytes(mem_budget)
        self.mem_budget = None if mem_budget is None else int(mem_budget)

    @classmethod
    def coerce(cls, value):
        if value is None or isinstance(value, cls):
            return value or cls()
        if isinstance(value, dict):
            return cls(**value)
        raise TypeError('tenant quota must be a TenantQuota or kwargs '
                        'dict, got {!r}'.format(type(value).__name__))


class TenantLedger(object):
    """Book per-tenant consumers, credits, and bytes for one server.

    :param quotas: ``{tenant: TenantQuota | kwargs dict}``.
    :param default_quota: quota for tenants not in ``quotas`` (default:
        uncapped — unknown tenants share like before tenancy existed).
    :param membudget_pool: register the aggregate byte account with the
        process memory governor under this pool name (None disables).
    """

    def __init__(self, quotas=None, default_quota=None,
                 membudget_pool='fleet-tenants'):
        from petastorm_tpu_torch import metrics as metrics_mod
        self._lock = threading.Lock()
        self._quotas = {t: TenantQuota.coerce(q)
                        for t, q in (quotas or {}).items()}
        self._default_quota = TenantQuota.coerce(default_quota)
        self._state = {}    # tenant -> {consumers, credits, bytes, shed}
        self._mem_handle = None
        self._m_consumers = metrics_mod.gauge(
            'pst_fleet_tenant_consumers',
            'Consumers currently admitted per tenant',
            labelnames=('tenant',))
        self._m_credits = metrics_mod.gauge(
            'pst_fleet_tenant_credits',
            'Initial flow-control credits outstanding per tenant',
            labelnames=('tenant',))
        self._m_bytes = metrics_mod.gauge(
            'pst_fleet_tenant_mem_bytes',
            'Bytes currently charged to each tenant sub-pool',
            labelnames=('tenant',))
        self._m_attaches = metrics_mod.counter(
            'pst_fleet_tenant_attaches_total',
            'Consumer attaches admitted per tenant',
            labelnames=('tenant',))
        self._m_refusals = metrics_mod.counter(
            'pst_fleet_tenant_refusals_total',
            'Typed refusals issued per tenant, by reason',
            labelnames=('tenant', 'reason'))
        if membudget_pool:
            from petastorm_tpu_torch import membudget
            self._mem_handle = membudget.register_pool(
                membudget_pool, self._total_nbytes,
                shed_fn=self._set_mem_shed)

    # -- internals ---------------------------------------------------------

    def _tenant_key(self, tenant):
        return 'default' if tenant is None else str(tenant)

    def _state_locked(self, key):
        state = self._state.get(key)
        if state is None:
            state = {'consumers': set(), 'credits': 0, 'bytes': 0,
                     'shed': False}
            self._state[key] = state
        return state

    def quota(self, tenant):
        return self._quotas.get(self._tenant_key(tenant),
                                self._default_quota)

    def _total_nbytes(self):
        with self._lock:
            return sum(s['bytes'] for s in self._state.values())

    def _set_mem_shed(self, active):
        """Memory-governor shed hook: shed the heaviest tenant FIRST —
        its pressure, its consumers — instead of refusing everyone."""
        with self._lock:
            if not active:
                for state in self._state.values():
                    state['shed'] = False
                return
            heaviest = max(self._state.items(),
                           key=lambda kv: kv[1]['bytes'],
                           default=(None, None))[0]
            if heaviest is not None:
                self._state[heaviest]['shed'] = True
                logger.warning('tenant %r shed under the memory '
                               'governor (heaviest sub-pool)', heaviest)

    # -- the server-side hooks ----------------------------------------------

    def admit(self, tenant, consumer, server_id=None, state='serving'):
        """Admission check for a NEW consumer of ``tenant``: None =
        admitted (and booked); a dict = the typed refusal to reply."""
        key = self._tenant_key(tenant)
        quota = self.quota(tenant)
        with self._lock:
            tstate = self._state_locked(key)
            if quota.max_consumers is not None \
                    and len(tstate['consumers']) >= quota.max_consumers:
                self._m_refusals.labels(
                    key, control_plane.REASON_TENANT_OVER_BUDGET).inc()
                return control_plane.refusal(
                    server_id, control_plane.REFUSED_OVERLOADED, state,
                    reason=control_plane.REASON_TENANT_OVER_BUDGET,
                    tenant=key, max_consumers=quota.max_consumers)
            over_mem = (quota.mem_budget is not None
                        and tstate['bytes'] >= quota.mem_budget)
            if tstate['shed'] or over_mem:
                self._m_refusals.labels(
                    key, control_plane.REASON_TENANT_OVER_BUDGET).inc()
                return control_plane.refusal(
                    server_id, control_plane.REFUSED_OVERLOADED, state,
                    reason=control_plane.REASON_TENANT_OVER_BUDGET,
                    tenant=key)
            tstate['consumers'].add(consumer)
            self._m_attaches.labels(key).inc()
            self._m_consumers.labels(key).set(len(tstate['consumers']))
        return None

    def clamp_credits(self, tenant, requested):
        """Clamp an initial credit grant to the tenant's remaining
        partition of the flow-control window (and book what was
        granted). Uncapped tenants pass through untouched."""
        key = self._tenant_key(tenant)
        quota = self.quota(tenant)
        requested = int(requested or 0)
        with self._lock:
            tstate = self._state_locked(key)
            if quota.credits is None:
                granted = requested
            else:
                granted = max(0, min(requested,
                                     quota.credits - tstate['credits']))
            tstate['credits'] += granted
            self._m_credits.labels(key).set(tstate['credits'])
        return granted

    def release(self, tenant, consumer, credits=0):
        """Undo one consumer's booking (detach, admission-lease expiry,
        or server-side prune)."""
        key = self._tenant_key(tenant)
        with self._lock:
            tstate = self._state_locked(key)
            tstate['consumers'].discard(consumer)
            tstate['credits'] = max(0, tstate['credits'] - int(credits))
            self._m_consumers.labels(key).set(len(tstate['consumers']))
            self._m_credits.labels(key).set(tstate['credits'])

    def charge(self, tenant, nbytes):
        """Account bytes to the tenant's sub-pool (planes that can
        attribute memory per request — e.g. response buffers)."""
        key = self._tenant_key(tenant)
        with self._lock:
            tstate = self._state_locked(key)
            tstate['bytes'] += int(nbytes)
            self._m_bytes.labels(key).set(tstate['bytes'])

    def discharge(self, tenant, nbytes):
        key = self._tenant_key(tenant)
        with self._lock:
            tstate = self._state_locked(key)
            tstate['bytes'] = max(0, tstate['bytes'] - int(nbytes))
            self._m_bytes.labels(key).set(tstate['bytes'])

    # -- observability -------------------------------------------------------

    def snapshot(self):
        """JSON-safe per-tenant SLO snapshot (the `fleet` rpc verb and
        the status CLI serve this)."""
        with self._lock:
            out = {}
            for key, tstate in self._state.items():
                quota = self._quotas.get(key, self._default_quota)
                out[key] = {'consumers': len(tstate['consumers']),
                            'credits': tstate['credits'],
                            'bytes': tstate['bytes'],
                            'shed': tstate['shed'],
                            'quota': {'credits': quota.credits,
                                      'max_consumers': quota.max_consumers,
                                      'mem_budget': quota.mem_budget}}
            return out

    def close(self):
        """Release the membudget registration (server teardown)."""
        handle, self._mem_handle = self._mem_handle, None
        if handle is not None:
            handle.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
