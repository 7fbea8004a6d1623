"""The port's preprocessing fleet (``fleet/registry.py``, ``fleet/tenancy.py``,
``fleet/autoscaler.py`` and ``tools/fleet.py``), mirroring the registry,
tenancy, autoscaler and CLI tests of ``tests/test_fleet_preproc.py`` and
held against the JAX package:

* the registry folds the heartbeats of port and JAX servers alike, data
  servers (binary dialect) and lookup servers (JSON dialect);
* ``TenantLedger`` and ``FleetAutoscaler`` decide as the JAX package's on
  the same scripted calls and telemetry, with fake launchers;
* ``ScalePolicy`` reads ``PSTT_FLEET_*`` with the JAX package's grammar;
* the fleet CLI's ``--status`` line equals the JAX CLI's, endpoints and
  ids masked; a spawned worker imports no torch and hides the card;
* the ``fleet-worker-kill``, ``registry-blackhole`` and ``scale-race``
  sites fire;
* the reference's chaos drill, once: a two-tenant fleet scaled 1 -> 3 ->
  1 under load, one spawn SIGKILLed and a drain under a registry
  blackhole, zero chunks lost and the deterministic tenant's ledger equal
  to an unscaled run's (``tools.replay --diff-ledgers`` exit 0).

Every endpoint that a test may bind again is ``ipc://`` under its
``tmp_path``.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from petastorm_tpu import data_service as jds
from petastorm_tpu import make_tensor_reader as jax_make_tensor_reader
from petastorm_tpu.fleet import autoscaler as jas
from petastorm_tpu.fleet import registry as jreg
from petastorm_tpu.fleet import tenancy as jten
from petastorm_tpu_torch import NdarrayCodec, ScalarCodec, Unischema, UnischemaField, faults
from petastorm_tpu_torch import metrics as metrics_mod
from petastorm_tpu_torch import write_dataset
from petastorm_tpu_torch.data_service import RemoteReader, serve_dataset
from petastorm_tpu_torch.errors import ServerOverloaded
from petastorm_tpu_torch.fleet.autoscaler import (FleetAutoscaler, ScalePolicy,
                                                  SubprocessLauncher, WorkerLauncher)
from petastorm_tpu_torch.fleet.registry import FleetRegistry
from petastorm_tpu_torch.fleet.tenancy import TenantLedger
from torch_service_helpers import endpoints, ipc, ipc_dir

pytestmark = pytest.mark.fleet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 512
ROWS_PER_GROUP = 16
DET_KW = dict(num_epochs=1, seed=7, workers_count=2, shuffle_row_groups=True,
              reader_pool_type='thread', deterministic=True)


@pytest.fixture(scope='module')
def fleet_dataset(tmp_path_factory):
    schema = Unischema('Preproc', [
        UnischemaField('vec', np.float32, (1024,), NdarrayCodec(), False),
        UnischemaField('id', np.int64, (), ScalarCodec(np.int64), False),
    ])
    rng = np.random.default_rng(13)
    url = 'file://' + str(tmp_path_factory.mktemp('preproc') / 'store')
    write_dataset(url, schema, ({'vec': rng.standard_normal(1024).astype(np.float32), 'id': i}
                                for i in range(ROWS)), rows_per_row_group=ROWS_PER_GROUP)
    return url


@pytest.fixture
def sock(tmp_path):
    path = ipc_dir(tmp_path)
    yield path
    if os.path.islink(path):
        os.unlink(path)


@pytest.fixture(autouse=True)
def _no_fleet_thread_survives():
    yield
    deadline = time.monotonic() + 3.0
    while True:
        left = [t.name for t in threading.enumerate()
                if t.is_alive() and t.name.startswith(('pstt-fleet', 'pstt-lookup'))]
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    assert not left, 'threads survived the test: {}'.format(left)


def _hb(server_id, job=None, state='serving', lease_s=1.0, rpc=None, name=None, capacity=None):
    announce = None
    if job is not None:
        announce = {'job': job}
        if capacity is not None:
            announce['capacity'] = capacity
    return {'server_id': server_id, 'lease_s': lease_s, 'state': state, 'rpc': rpc,
            'name': name, 'announce': announce}


def _env(faults_spec=None):
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(filter(None, [REPO, env.get('PYTHONPATH')]))
    env['JAX_PLATFORMS'] = 'cpu'
    env.pop(faults.ENV_VAR, None)
    env.pop('PETASTORM_TPU_FAULTS', None)
    if faults_spec:
        env[faults.ENV_VAR] = faults_spec
    return env


# -- the registry ------------------------------------------------------------------------------------

def test_registry_join_drain_leave_and_expiry():
    t0 = time.monotonic()
    reg = FleetRegistry()
    reg.note_heartbeat(_hb('w1', job='j'), now=t0)
    reg.note_heartbeat(_hb('w2', job='j', capacity=4), now=t0 + 0.5)
    assert reg.jobs() == ['j'] and reg.worker_count('j') == 2
    assert [m['key'] for m in reg.members('j')] == ['w1', 'w2']
    assert reg.members('j')[1]['capacity'] == 4
    assert reg.note_heartbeat(_hb('w3'), now=t0 + 0.6) is None
    assert FleetRegistry(default_job='dflt').note_heartbeat(_hb('w3'), now=t0)['job'] == 'dflt'
    reg.note_heartbeat(_hb('w2', job='j', state='drained'), now=t0 + 1.0)
    assert [m['key'] for m in reg.members('j')] == ['w1']
    reg.expire(now=t0 + 4.7)
    assert reg.members('j') == []
    reborn = FleetRegistry()
    reborn.note_heartbeat(_hb('w1', job='j'), now=t0 + 5.0)
    assert reborn.worker_count('j') == 1


def test_registry_warm_peer_and_worker_count_states():
    t0 = time.monotonic()
    reg = FleetRegistry()
    reg.note_heartbeat(_hb('old', job='j', lease_s=60.0), now=t0)
    reg.note_heartbeat(_hb('mid', job='j', lease_s=60.0), now=t0 + 0.1)
    reg.note_heartbeat(_hb('new', job='j', lease_s=60.0, state='awaiting-cursor'), now=t0 + 0.2)
    assert reg.worker_count('j') == 3
    reg.note_heartbeat(_hb('mid', job='j', lease_s=60.0, state='draining'), now=t0 + 0.3)
    assert reg.worker_count('j') == 2
    assert reg.pick_warm_peer('j')['key'] == 'old'
    assert reg.pick_warm_peer('j', exclude=('old',)) is None


def test_registry_blackhole_drops_heartbeats(monkeypatch):
    t0 = time.monotonic()
    reg = FleetRegistry()
    reg.note_heartbeat(_hb('w1', job='j'), now=t0)
    monkeypatch.setenv(faults.ENV_VAR, 'registry-blackhole')
    assert reg.note_heartbeat(_hb('w1', job='j'), now=t0 + 1.0) is None
    assert reg.note_heartbeat(_hb('w9', job='j'), now=t0 + 1.0) is None
    assert reg.worker_count('j') == 1
    reg.expire(now=t0 + 4.0)
    assert reg.members('j') == []
    monkeypatch.delenv(faults.ENV_VAR)
    reg.note_heartbeat(_hb('w1', job='j'), now=t0 + 5.0)
    assert reg.worker_count('j') == 1


def test_a_registry_obeys_its_own_blackhole_alone(monkeypatch):
    """``fault_injector=``: one registry blackholed while the process's
    ``PSTT_FAULTS`` and a second registry are left as they were."""
    monkeypatch.delenv(faults.ENV_VAR, raising=False)
    t0 = time.monotonic()
    blind, other = FleetRegistry(), FleetRegistry()
    blind.fault_injector = faults.FaultInjector.from_string('registry-blackhole')
    assert blind.note_heartbeat(_hb('w1', job='j'), now=t0) is None
    assert other.note_heartbeat(_hb('w1', job='j'), now=t0)['key'] == 'w1'
    assert faults.ENV_VAR not in os.environ and not faults.faults_active()
    blind.fault_injector = None
    assert blind.note_heartbeat(_hb('w1', job='j'), now=t0 + 1.0)['key'] == 'w1'


def test_registry_decisions_equal_jax_on_scripted_beats():
    """The same beats, in the same order, on one synthetic clock: equal
    replies and member tables at every step."""
    rng = np.random.default_rng(19)
    port, ref = FleetRegistry(default_job='d'), jreg.FleetRegistry(default_job='d')
    t = 0.0
    for _ in range(200):
        t += float(rng.choice([0.1, 0.5, 1.5, 4.0]))
        key = 'w{}'.format(int(rng.integers(0, 6)))
        job = [None, 'a', 'b'][int(rng.integers(0, 3))]
        state = ['serving', 'serving', 'draining', 'drained', 'awaiting-cursor'][
            int(rng.integers(0, 5))]
        hb = _hb(key, job=job, state=state, lease_s=float(rng.choice([0.5, 1.0, 2.0])),
                 rpc='ipc:///x/' + key, capacity=int(rng.integers(0, 4)))
        got, want = port.note_heartbeat(dict(hb), now=t), ref.note_heartbeat(dict(hb), now=t)
        assert got == want
        port.expire(now=t + 0.2)
        ref.expire(now=t + 0.2)
        assert port._jobs == ref._jobs


def test_registry_folds_port_and_jax_heartbeats_alike(fleet_dataset, tmp_path, sock):
    """A port and a JAX data server (the binary dialect with the announce
    tail) and a port and a JAX lookup server (the JSON dialect), all of one
    job: both packages' registries list the four members under the same
    keys, and a drain leaves at once."""
    from petastorm_tpu import serving as jsv
    from petastorm_tpu.etl.rowgroup_indexers import SingleFieldRowIndexer
    from petastorm_tpu.etl.rowgroup_indexing import build_rowgroup_index
    from petastorm_tpu_torch.serving import LookupEngine, LookupServer

    build_rowgroup_index(fleet_dataset, [SingleFieldRowIndexer('id_row_ix', 'id')])
    kw = dict(DET_KW, num_epochs=None)
    port_ds = serve_dataset(fleet_dataset, ipc(sock, 'pds'), lease_s=0.5, job_id='mixed', **kw)
    jax_ep = ipc(sock, 'jds')
    jax_ctrl, jax_rpc = endpoints(jax_ep)
    jax_ds = jds.DataServer(jax_make_tensor_reader(fleet_dataset, **kw), jax_ep,
                            control_bind=jax_ctrl, rpc_bind=jax_rpc, lease_s=0.5,
                            job_id='mixed').start()
    engines = [LookupEngine(fleet_dataset, index_name='id_row_ix'),
               jsv.LookupEngine(fleet_dataset, index_name='id_row_ix')]
    port_ls = LookupServer(engines[0], ipc(sock, 'pls'), lease_s=0.5, job_id='mixed',
                           server_name='port-lookup').start()
    jls_ep = ipc(sock, 'jls')
    jax_ls = jsv.LookupServer(engines[1], jls_ep, control_bind=jls_ep + '.1', lease_s=0.5,
                              job_id='mixed', server_name='jax-lookup').start()
    controls = [port_ds.control_endpoint, jax_ds.control_endpoint, port_ls.control_endpoint,
                jax_ls.control_endpoint]
    want_keys = {port_ds._server_id.hex(), jax_ds._server_id.hex(), 'port-lookup',
                 'jax-lookup'}
    try:
        with FleetRegistry() as reg:
            ref = jreg.FleetRegistry()
            try:
                reg.watch(controls)
                ref.watch(controls)
                for registry in (reg, ref):
                    assert registry.wait_for_member('mixed', min_count=4, timeout_s=20.0)
                got = {m['key']: m['rpc'] for m in reg.members('mixed')}
                assert set(got) == want_keys
                assert got == {m['key']: m['rpc'] for m in ref.members('mixed')}
                assert got['port-lookup'] == port_ls.rpc_endpoint
                assert got[jax_ds._server_id.hex()] == jax_rpc
                port_ls.drain()
                deadline = time.monotonic() + 10
                while 'port-lookup' in {m['key'] for m in reg.members('mixed')}:
                    assert time.monotonic() < deadline, 'the drained member never left'
                    time.sleep(0.05)
            finally:
                ref.stop()
    finally:
        port_ls.stop()
        jax_ls.stop()
        for eng in engines:
            eng.close()
        port_ds.stop()
        jax_ds.stop()


def test_registry_watches_live_server_heartbeats(fleet_dataset, sock):
    kwargs = dict(DET_KW, num_epochs=None)
    with serve_dataset(fleet_dataset, ipc(sock, 'live'), lease_s=0.5, job_id='live-job',
                       **kwargs) as server:
        with FleetRegistry() as reg:
            reg.watch([server.control_endpoint])
            assert reg.wait_for_member('live-job', timeout_s=20.0)
            (member,) = reg.members('live-job')
            assert member['key'] == server._server_id.hex()
            assert member['rpc'] == server.rpc_endpoint
            assert member['state'] in ('serving', 'awaiting-cursor')
            with RemoteReader(server.data_endpoint, shared_stream=True,
                              end_grace_s=1.0) as remote:
                assert np.asarray(next(remote).id).size > 0
            assert server.drain(timeout_s=10.0)
            deadline = time.monotonic() + 15
            while reg.worker_count('live-job') > 0:
                assert time.monotonic() < deadline, 'drained worker never left membership'
                time.sleep(0.05)
            assert 'pstt-fleet-registry' in {t.name for t in threading.enumerate()}
    assert 'pstt-fleet-registry' not in {t.name for t in threading.enumerate()}


# -- tenant isolation --------------------------------------------------------------------------------

def test_tenant_caps_isolate_noisy_from_quiet():
    refusals = metrics_mod.counter('pst_fleet_tenant_refusals_total', '',
                                   labelnames=('tenant', 'reason'))
    noisy_before = refusals.labels('noisy', 'tenant-over-budget').value
    with TenantLedger(quotas={'noisy': {'max_consumers': 1}}, membudget_pool=None) as ledger:
        assert ledger.admit('noisy', 'n1') is None
        refusal = ledger.admit('noisy', 'n2')
        assert refusal['refused'] == 'overloaded'
        assert refusal['reason'] == 'tenant-over-budget'
        assert ledger.admit('quiet', 'q1') is None
        assert ledger.admit('quiet', 'q2') is None
        ledger.release('noisy', 'n1')
        assert ledger.admit('noisy', 'n3') is None
    assert refusals.labels('noisy', 'tenant-over-budget').value == noisy_before + 1


def test_tenant_credit_partition_clamps_initial_grants():
    with TenantLedger(quotas={'a': {'credits': 6}}, membudget_pool=None) as ledger:
        assert ledger.clamp_credits('a', 4) == 4
        assert ledger.clamp_credits('a', 4) == 2
        assert ledger.clamp_credits('a', 4) == 0
        assert ledger.clamp_credits('b', 64) == 64
        ledger.release('a', 'c1', credits=4)
        assert ledger.clamp_credits('a', 4) == 4
        snap = ledger.snapshot()
        assert snap['a']['credits'] == 6 and snap['a']['quota']['credits'] == 6


def test_tenant_mem_budget_sheds_heaviest_first():
    with TenantLedger(quotas={'heavy': {'mem_budget': '1k'}, 'light': {'mem_budget': 4096}},
                      membudget_pool=None) as ledger:
        ledger.charge('heavy', 2048)
        ledger.charge('light', 128)
        assert ledger.admit('heavy', 'h1')['reason'] == 'tenant-over-budget'
        assert ledger.admit('light', 'l1') is None
        ledger._set_mem_shed(True)
        snap = ledger.snapshot()
        assert snap['heavy']['shed'] and not snap['light']['shed']
        assert ledger.admit('light', 'l2') is None
        ledger._set_mem_shed(False)
        ledger.discharge('heavy', 2048)
        assert ledger.admit('heavy', 'h2') is None


def test_tenant_ledger_decisions_equal_jax():
    """One scripted sequence of admits, grants, releases, charges and shed
    flips through both packages' ledgers: equal replies and snapshots."""
    quotas = {'noisy': {'max_consumers': 2, 'credits': 10}, 'heavy': {'mem_budget': '2k'},
              'capped': {'credits': 3, 'max_consumers': 1}}
    port = TenantLedger(quotas=quotas, default_quota={'credits': 5}, membudget_pool=None)
    ref = jten.TenantLedger(quotas=quotas, default_quota={'credits': 5}, membudget_pool=None)
    rng = np.random.default_rng(23)
    tenants = ['noisy', 'heavy', 'capped', 'other', None]
    try:
        for step in range(300):
            tenant = tenants[int(rng.integers(0, len(tenants)))]
            consumer = 'c{}'.format(int(rng.integers(0, 5)))
            op = int(rng.integers(0, 6))
            if op == 0:
                got = port.admit(tenant, consumer, server_id='sid', state='serving')
                want = ref.admit(tenant, consumer, server_id='sid', state='serving')
            elif op == 1:
                n = int(rng.integers(0, 9))
                got, want = port.clamp_credits(tenant, n), ref.clamp_credits(tenant, n)
            elif op == 2:
                n = int(rng.integers(0, 4))
                got = port.release(tenant, consumer, credits=n)
                want = ref.release(tenant, consumer, credits=n)
            elif op == 3:
                n = int(rng.integers(0, 1500))
                got, want = port.charge(tenant, n), ref.charge(tenant, n)
            elif op == 4:
                n = int(rng.integers(0, 1500))
                got, want = port.discharge(tenant, n), ref.discharge(tenant, n)
            else:
                flag = bool(rng.integers(0, 2))
                got, want = port._set_mem_shed(flag), ref._set_mem_shed(flag)
            assert got == want, step
            assert port.snapshot() == ref.snapshot(), step
    finally:
        port.close()
        ref.close()


def test_server_enforces_tenant_quota_end_to_end(fleet_dataset, sock):
    tenants = TenantLedger(quotas={'noisy': {'max_consumers': 1}}, membudget_pool=None)
    kwargs = dict(DET_KW, num_epochs=None)
    with serve_dataset(fleet_dataset, ipc(sock, 'q'), tenants=tenants, job_id='tenant-job',
                       **kwargs) as server:
        with RemoteReader(server.data_endpoint, shared_stream=True, end_grace_s=1.0,
                          tenant='noisy') as admitted:
            deadline = time.monotonic() + 30
            while admitted.diagnostics['attach'].get(admitted._rpc_endpoints[0]) != 'attached':
                assert time.monotonic() < deadline, 'attach never landed'
                time.sleep(0.05)
            second = RemoteReader(server.data_endpoint, tenant='noisy')
            with pytest.raises(ServerOverloaded) as exc_info:
                deadline = time.monotonic() + 30
                while time.monotonic() < deadline:
                    next(second)
                raise AssertionError('tenant refusal never surfaced')
            assert exc_info.value.reason == 'overloaded'
            second.join()
            with RemoteReader(server.data_endpoint, shared_stream=True, end_grace_s=1.0,
                              tenant='quiet') as quiet:
                next(quiet)
            reply = admitted._one_shot_rpc(admitted._rpc_endpoints[0], {'cmd': 'fleet'})
            assert reply['job'] == 'tenant-job'
            assert reply['tenants']['noisy']['consumers'] >= 1
    tenants.close()


# -- the autoscaler -------------------------------------------------------------------------------

class _FakeLauncher(WorkerLauncher):
    """In-process launcher: workers are registry records; ``join=False``
    is a spawn that dies before its first heartbeat."""

    def __init__(self, registry, job, join=True):
        self.registry, self.job, self.join = registry, job, join
        self.launched, self.drained, self.terminated = [], [], []

    def launch(self, index):
        key = 'fw{}'.format(index)
        self.launched.append(key)
        if self.join:
            self.registry.note_heartbeat(_hb(key, job=self.job, lease_s=60.0))
        return {'key': key}

    def drain(self, handle, timeout_s):
        self.drained.append(handle['key'])
        self.registry.note_heartbeat(_hb(handle['key'], job=self.job, state='drained'))
        return True

    def terminate(self, handle):
        self.terminated.append(handle['key'])

    def alive(self, handle):
        return handle['key'] not in self.terminated


def _bottleneck(cls, pipeline='p0'):
    return {'pst_autotune_bottleneck': {
        'type': 'gauge', 'samples': [{'labels': {'pipeline': pipeline, 'class': cls},
                                      'value': 1}]}}


def _served(total):
    return {'pst_data_service_chunks_served_total': {
        'type': 'counter', 'samples': [{'labels': {}, 'value': total}]}}


def test_autoscaler_min_floor_then_hysteresis_up():
    reg = FleetRegistry()
    launcher = _FakeLauncher(reg, 'j')
    box = {'agg': _bottleneck('balanced')}
    scaler = FleetAutoscaler('j', reg, launcher, metrics_fn=lambda: {'aggregate': box['agg']},
                             policy=ScalePolicy(min_workers=1, max_workers=3, hysteresis=2,
                                                cooldown_ticks=1, spawn_grace_s=2.0))
    decision = scaler.tick(now=0.0)
    assert decision['action'] == 'up' and decision['ok'] and reg.worker_count('j') == 1
    box['agg'] = dict(_bottleneck('input-bound'), **_served(0))
    assert scaler.tick(now=1.0) is None
    decision = scaler.tick(now=2.0)
    assert decision['action'] == 'up' and reg.worker_count('j') == 2
    assert scaler.tick(now=3.0) is None
    decision = scaler.tick(now=4.0)
    assert decision['action'] == 'up' and reg.worker_count('j') == 3
    for now in (5.0, 6.0, 7.0):
        assert scaler.tick(now=now) is None
    assert reg.worker_count('j') == 3


def test_autoscaler_drains_newest_and_reverts_on_rate_collapse():
    reg = FleetRegistry()
    launcher = _FakeLauncher(reg, 'j')
    box = {'agg': dict(_bottleneck('consumer-bound'), **_served(0))}
    scaler = FleetAutoscaler('j', reg, launcher, metrics_fn=lambda: {'aggregate': box['agg']},
                             policy=ScalePolicy(min_workers=1, max_workers=3, hysteresis=2,
                                                cooldown_ticks=1, throughput_tolerance=0.5,
                                                spawn_grace_s=2.0))
    assert scaler.scale_to(2) == 2 and launcher.launched == ['fw1', 'fw2']
    assert scaler.tick(now=0.0) is None
    box['agg'] = dict(_bottleneck('consumer-bound'), **_served(100))
    decision = scaler.tick(now=10.0)
    assert decision['action'] == 'down' and decision['ok']
    assert launcher.drained == ['fw2'] and launcher.terminated == ['fw2']
    assert [m['key'] for m in reg.members('j')] == ['fw1']
    box['agg'] = dict(_bottleneck('consumer-bound'), **_served(110))
    decision = scaler.tick(now=20.0)
    assert decision['action'] == 'revert-up' and decision['ok']
    assert reg.worker_count('j') == 2 and launcher.launched == ['fw1', 'fw2', 'fw3']


def test_live_workers_reaps_the_dead_launched():
    reg = FleetRegistry()
    launcher = _FakeLauncher(reg, 'j')
    scaler = FleetAutoscaler('j', reg, launcher, policy=ScalePolicy(
        min_workers=1, max_workers=3, spawn_grace_s=2.0))
    assert scaler.scale_to(3) == 3 and scaler.live_workers() == 3
    launcher.terminated.append('fw2')   # died outside the loop's control
    assert scaler.live_workers() == 2 and launcher.terminated == ['fw2', 'fw2']
    assert reg.worker_count('j') == 3, 'the registry ages it out on its own'


def test_autoscaler_reaps_spawn_that_never_joins():
    actions = metrics_mod.counter('pst_fleet_scale_actions_total', '',
                                  labelnames=('job', 'action'))
    failed_before = actions.labels('jx', 'up-failed').value
    reg = FleetRegistry()
    launcher = _FakeLauncher(reg, 'jx', join=False)
    scaler = FleetAutoscaler('jx', reg, launcher, metrics_fn=None,
                             policy=ScalePolicy(min_workers=1, max_workers=2,
                                                spawn_grace_s=0.2))
    decision = scaler.tick(now=0.0)
    assert decision['action'] == 'up' and decision['ok'] is False
    assert launcher.terminated == launcher.launched
    assert reg.worker_count('jx') == 0
    assert actions.labels('jx', 'up-failed').value == failed_before + 1


def _scripted_autoscaler(mod_as, mod_reg):
    """Both packages' autoscalers over one scripted telemetry: a floor
    deficit, input-bound streaks to the ceiling, a consumer-bound drain, a
    collapse that reverts it, a reaped spawn and imperative steering."""
    reg = mod_reg.FleetRegistry()
    launcher = _FakeLauncher(reg, 'j')

    class Launcher(mod_as.WorkerLauncher):
        def launch(self, index):
            handle = launcher.launch(index)
            if index == 6:       # one spawn never joins
                reg._jobs['j'].pop(handle['key'], None)
            return handle

        def drain(self, handle, timeout_s):
            return launcher.drain(handle, timeout_s)

        def terminate(self, handle):
            launcher.terminate(handle)

        def alive(self, handle):
            return launcher.alive(handle)

    script = ([('balanced', 0)] + [('input-bound', 0)] * 6
              + [('consumer-bound', 10), ('consumer-bound', 20), ('consumer-bound', 20)]
              + [('consumer-bound', 20 + 10 * i) for i in range(1, 6)]
              + [('consumer-bound', 70), ('reader-starved', 70), ('reader-starved', 80),
                 ('reader-starved', 90), ('dispatch-bound', 95), (None, 95),
                 ('input-bound', 96), ('input-bound', 97), ('balanced', 99)])
    box = {}
    scaler = mod_as.FleetAutoscaler(
        'j', reg, Launcher(), metrics_fn=lambda: box['fleet'],
        policy=mod_as.ScalePolicy(min_workers=1, max_workers=3, hysteresis=2,
                                  cooldown_ticks=1, throughput_tolerance=0.3,
                                  spawn_grace_s=0.05))
    out = []
    for tick, (cls, served) in enumerate(script):
        agg = _served(served)
        if cls is not None:
            agg.update(_bottleneck(cls))
        box['fleet'] = {'aggregate': agg}
        out.append(scaler.tick(now=float(tick)))
    out.append(scaler.scale_to(1))
    out.append(sorted(m['key'] for m in reg.members('j')))
    return out, list(scaler.decisions), launcher.launched, launcher.drained


def test_autoscaler_decisions_equal_jax():
    got = _scripted_autoscaler(sys.modules[FleetAutoscaler.__module__],
                               sys.modules[FleetRegistry.__module__])
    want = _scripted_autoscaler(jas, jreg)
    assert got == want
    actions = [d['action'] for d in got[1]]
    assert {'up', 'down', 'revert-up'} <= set(actions)
    assert any(not d['ok'] for d in got[1]), 'the reaped spawn is a failed action'


@pytest.mark.parametrize('raw', [('2', '7', '0.5'), ('', '', ''), ('x', ' 3 ', '-1'),
                                 ('5', '2', 'fast'), ('0', '0', '0.25')])
def test_scale_policy_reads_fleet_env_as_jax(monkeypatch, raw):
    for prefix in ('PSTT', 'PETASTORM_TPU'):
        for name, value in zip(('MIN_WORKERS', 'MAX_WORKERS', 'INTERVAL_S'), raw):
            monkeypatch.setenv('{}_FLEET_{}'.format(prefix, name), value)
    assert vars(ScalePolicy()) == vars(jas.ScalePolicy())
    assert vars(ScalePolicy(min_workers=4, max_workers=1)) == \
        vars(jas.ScalePolicy(min_workers=4, max_workers=1))
    if raw[0] == '2':
        policy = ScalePolicy()
        assert (policy.min_workers, policy.max_workers, policy.interval_s) == (2, 7, 0.5)


@pytest.mark.chaos
def test_scale_race_delays_the_act(monkeypatch):
    reg = FleetRegistry()
    scaler = FleetAutoscaler('race', reg, _FakeLauncher(reg, 'race'), metrics_fn=None,
                             policy=ScalePolicy(min_workers=1, max_workers=2,
                                                spawn_grace_s=1.0))
    monkeypatch.setenv(faults.ENV_VAR, 'scale-race:delay=0.4:max=1')
    t0 = time.perf_counter()
    assert scaler.tick(now=0.0)['ok']
    assert time.perf_counter() - t0 >= 0.35
    t0 = time.perf_counter()
    assert scaler._act('up', reg.worker_count('race'))['ok']
    assert time.perf_counter() - t0 < 0.35, 'max=1: the site fires once'


# -- mixed-fleet admission failover ----------------------------------------------------------------

def test_mixed_fleet_failover_lands_on_healthy_without_stealing(fleet_dataset, sock):
    draining = serve_dataset(fleet_dataset, ipc(sock, 'draining'), **DET_KW)
    over_cap = serve_dataset(fleet_dataset, ipc(sock, 'overcap'), await_cursor=True,
                             max_consumers=0, **DET_KW)
    healthy = serve_dataset(fleet_dataset, ipc(sock, 'healthy'), **DET_KW)
    try:
        assert draining.drain(timeout_s=10.0)
        remote = RemoteReader([draining.data_endpoint, over_cap.data_endpoint,
                               healthy.data_endpoint], shared_stream=True, end_grace_s=2.0)
        with remote:
            ids = [np.asarray(chunk.id).tolist() for chunk in remote]
        assert sorted(i for chunk in ids for i in chunk) == list(range(ROWS))
        attach = remote.diagnostics['attach']
        assert [attach[ep] for ep in remote._rpc_endpoints] == ['excluded', 'excluded',
                                                                'attached']
        assert draining.served_chunks == 0 and over_cap.served_chunks == 0
    finally:
        for server in (draining, over_cap, healthy):
            server.stop()


# -- the fleet CLI -----------------------------------------------------------------------------------

def _fleet_cli_argv(url, job, bind):
    return [sys.executable, '-m', 'petastorm_tpu_torch.tools.fleet', '--worker', url, '--job', job,
            '--bind', bind, '--epochs', '0', '--lease-s', '0.5', '--workers', '1',
            '--drain-grace', '0.5']


def _maps(pid):
    with open('/proc/{}/maps'.format(pid)) as f:
        return f.read()


@pytest.mark.processpool
def test_fleet_worker_cli_announces_joins_and_drains_on_sigterm(fleet_dataset, sock):
    proc = subprocess.Popen(_fleet_cli_argv(fleet_dataset, 'cli-job', ipc(sock, 'w')),
                            stdout=subprocess.PIPE, text=True, env=_env())
    try:
        line = proc.stdout.readline()
        assert line, 'fleet worker died before announcing itself'
        announce = json.loads(line)
        assert announce['job'] == 'cli-job'
        assert announce['control_endpoint'] == ipc(sock, 'w') + '.1'
        assert announce['rpc_endpoint'] == ipc(sock, 'w') + '.2'
        with FleetRegistry() as reg:
            reg.watch([announce['control_endpoint']])
            assert reg.wait_for_member('cli-job', key=announce['server_id'], timeout_s=30.0)
        # The worker serves without torch (nor a CUDA driver) in its process.
        maps = _maps(proc.pid)
        assert 'libtorch' not in maps and 'libcuda' not in maps
        status = {}
        for package in ('petastorm_tpu_torch', 'petastorm_tpu'):
            out = subprocess.run([sys.executable, '-m', package + '.tools.fleet', '--status',
                                  '--rpc', announce['rpc_endpoint']],
                                 capture_output=True, text=True, timeout=120, env=_env())
            assert out.returncode == 0, out.stderr
            status[package] = json.loads(out.stdout.strip())
        got = status['petastorm_tpu_torch']
        assert got['unreachable'] == []
        member = got['members'][announce['rpc_endpoint']]
        assert member['job'] == 'cli-job' and member['server_id'] == announce['server_id']
        assert 'tenant_slo' in got

        def masked(doc):
            doc = json.loads(json.dumps(doc))
            for m in doc['members'].values():
                m.pop('sent', None)
            return doc
        assert masked(got) == masked(status['petastorm_tpu'])
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        final = json.loads(proc.stdout.read().strip().splitlines()[-1])
        assert final['state'] == 'drained'
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        proc.stdout.close()


def test_fleet_status_reports_an_unreachable_endpoint(sock):
    from petastorm_tpu_torch.tools import fleet as fleet_cli
    import contextlib
    import io
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fleet_cli.main(['--status', '--rpc', ipc(sock, 'nobody'), '--timeout-s', '0.3'])
    assert rc == 1
    doc = json.loads(out.getvalue().strip())
    assert doc['members'] == {} and doc['unreachable'] == [ipc(sock, 'nobody')]


def test_the_worker_hides_the_card_before_it_imports_the_service(monkeypatch):
    from petastorm_tpu_torch import data_service
    from petastorm_tpu_torch.tools import fleet as fleet_cli
    seen = {}

    class Stop(Exception):
        pass

    def fake_serve(*args, **kwargs):
        seen['visible'] = os.environ.get('CUDA_VISIBLE_DEVICES')
        raise Stop()

    monkeypatch.setenv('CUDA_VISIBLE_DEVICES', '0')
    monkeypatch.setattr(data_service, 'serve_dataset', fake_serve)
    handlers = {sig: signal.getsignal(sig) for sig in (signal.SIGINT, signal.SIGTERM)}
    try:
        with pytest.raises(Stop):
            fleet_cli.main(['--worker', 'file:///nowhere', '--job', 'j'])
    finally:
        for sig, handler in handlers.items():
            signal.signal(sig, handler)
    assert seen == {'visible': ''}


@pytest.mark.chaos
@pytest.mark.processpool
def test_fleet_worker_kill_fires_after_the_announce(fleet_dataset, sock, tmp_path):
    """``fleet-worker-kill``: a spawn SIGKILLs itself right after its
    announce line; the autoscaler reaps it as a failed scale-up."""
    reg = FleetRegistry()
    token = str(tmp_path / 'kill.token')
    launcher = SubprocessLauncher(
        lambda index: _fleet_cli_argv(fleet_dataset, 'kill-job', ipc(sock, 'k{}'.format(index))),
        announce_timeout_s=60.0, env=_env('fleet-worker-kill:token={}'.format(token)))
    scaler = FleetAutoscaler('kill-job', reg, launcher, metrics_fn=None,
                             policy=ScalePolicy(min_workers=1, max_workers=1,
                                                spawn_grace_s=3.0))
    try:
        decision = scaler.tick(now=0.0)
        assert decision['action'] == 'up' and decision['ok'] is False
        assert os.path.exists(token)
        assert scaler._handles == {}
    finally:
        reg.stop()


# -- chaos acceptance: 1 -> 3 -> 1 under two tenants, zero loss ----------------------------------

class _WatchingLauncher(SubprocessLauncher):
    """Points the registry at each spawn's control endpoint and books the
    drains a worker acknowledged."""

    def __init__(self, argv_fn, registry, **kwargs):
        super(_WatchingLauncher, self).__init__(argv_fn, **kwargs)
        self._registry = registry
        self.drained_ok = []

    def launch(self, index):
        handle = super(_WatchingLauncher, self).launch(index)
        self._registry.watch([handle['info']['control_endpoint']])
        return handle

    def drain(self, handle, timeout_s):
        ok = super(_WatchingLauncher, self).drain(handle, timeout_s)
        if ok:
            self.drained_ok.append(handle['key'])
        return ok


def _ledger_run(remote, ledger_dir):
    from petastorm_tpu_torch import TorchLoader
    os.makedirs(str(ledger_dir), exist_ok=True)
    rows = 0
    with TorchLoader(remote, ROWS_PER_GROUP, device='cpu', last_batch='drop', prefetch=2,
                     autotune=False, lineage=str(ledger_dir)) as loader:
        for batch in loader:
            rows += int(batch.id.shape[0])
    return rows


@pytest.mark.chaos
@pytest.mark.processpool
@pytest.mark.lineage
def test_chaos_two_tenant_fleet_scales_1_3_1_zero_loss(fleet_dataset, tmp_path, sock,
                                                       monkeypatch):
    from petastorm_tpu_torch.tools import replay as replay_cli

    refusals = metrics_mod.counter('pst_fleet_tenant_refusals_total', '',
                                   labelnames=('tenant', 'reason'))
    det_refused_before = refusals.labels('det', 'tenant-over-budget').value
    with serve_dataset(fleet_dataset, ipc(sock, 'ref'), **DET_KW) as ref_server:
        with RemoteReader(ref_server.data_endpoint, tenant='det') as ref_remote:
            assert _ledger_run(ref_remote, tmp_path / 'ref') == ROWS

    det_tenants = TenantLedger(quotas={'det': {}}, membudget_pool=None)
    noisy_tenants = TenantLedger(quotas={'noisy': {'max_consumers': 1}}, membudget_pool=None)
    worker0 = serve_dataset(fleet_dataset, ipc(sock, 'w0'), job_id='chaos',
                            tenants=det_tenants, **DET_KW)
    worker1 = serve_dataset(fleet_dataset, ipc(sock, 'w1'), tenants=noisy_tenants, **DET_KW)
    registry = FleetRegistry()
    registry.watch([worker0.control_endpoint])
    kill_token = str(tmp_path / 'kill-one-spawn.token')
    launcher = _WatchingLauncher(
        lambda index: _fleet_cli_argv(fleet_dataset, 'chaos', ipc(sock, 's{}'.format(index))),
        registry, announce_timeout_s=60.0,
        env=_env('fleet-worker-kill:token={}'.format(kill_token)))
    scaler = FleetAutoscaler('chaos', registry, launcher, metrics_fn=None,
                             policy=ScalePolicy(min_workers=1, max_workers=3,
                                                spawn_grace_s=10.0, drain_timeout_s=60.0))
    consumed = {}

    def _consume_det():
        with RemoteReader(worker0.data_endpoint, tenant='det') as remote:
            consumed['det'] = _ledger_run(remote, tmp_path / 'fleet')

    det_thread = threading.Thread(target=_consume_det, name='det-tenant-consumer')
    try:
        assert registry.wait_for_member('chaos', min_count=1, timeout_s=20.0)
        det_thread.start()
        deadline = time.monotonic() + 180
        while True:
            scaler._reap_dead()
            count = registry.worker_count('chaos')
            with scaler._lock:
                live_handles = len(scaler._handles)
            if count == 3 and live_handles == 2:
                break
            assert time.monotonic() < deadline, (count, live_handles)
            if count < 3:
                scaler._act('up', count, detail='chaos scale-up')
            else:
                time.sleep(0.2)
        assert os.path.exists(kill_token), 'fleet-worker-kill never fired'
        monkeypatch.setenv(faults.ENV_VAR, 'registry-blackhole')
        decision = scaler._act('down', observed=registry.worker_count('chaos'))
        assert decision['ok'], decision
        assert len(launcher.drained_ok) == 1
        monkeypatch.delenv(faults.ENV_VAR)
        deadline = time.monotonic() + 60
        while registry.worker_count('chaos') != 2:
            assert time.monotonic() < deadline, registry.worker_count('chaos')
            time.sleep(0.1)
        scaler.drain_all()
        assert len(launcher.drained_ok) == 2
        deadline = time.monotonic() + 60
        while registry.worker_count('chaos') != 1:
            assert time.monotonic() < deadline, 'fleet never shrank back to 1'
            time.sleep(0.1)
        assert [m['key'] for m in registry.members('chaos')] == [worker0._server_id.hex()]
        noisy_before = refusals.labels('noisy', 'tenant-over-budget').value
        with RemoteReader(worker1.data_endpoint, tenant='noisy') as noisy:
            assert sum(int(np.asarray(chunk.id).size) for chunk in noisy) == ROWS
            refused = RemoteReader(worker1.data_endpoint, tenant='noisy')
            with pytest.raises(ServerOverloaded):
                deadline = time.monotonic() + 30
                while time.monotonic() < deadline:
                    next(refused)
                raise AssertionError('noisy refusal never surfaced')
            refused.join()
        assert refusals.labels('noisy', 'tenant-over-budget').value > noisy_before
        assert worker1.served_chunks == ROWS // ROWS_PER_GROUP
        det_thread.join(timeout=120)
        assert not det_thread.is_alive(), 'det tenant consumer wedged'
        assert consumed['det'] == ROWS
        assert worker0.served_chunks == ROWS // ROWS_PER_GROUP
        assert refusals.labels('det', 'tenant-over-budget').value == det_refused_before
    finally:
        monkeypatch.delenv(faults.ENV_VAR, raising=False)
        if det_thread.ident is not None:
            det_thread.join(timeout=10)
        scaler.stop()
        scaler.drain_all()
        registry.stop()
        worker0.stop()
        worker1.stop()
        det_tenants.close()
        noisy_tenants.close()
    assert replay_cli.main(['--diff-ledgers', str(tmp_path / 'ref'),
                            str(tmp_path / 'fleet')]) == 0


# -- the bench: phase 29's runner at a small size on the CPU ------------------------------------------

class _StandInScan(object):
    """A scan step's surface with no model: call 1 eager, call 2 captures
    and replays, later calls replay; 10 ms a call."""

    def __init__(self):
        self.graph, self.calls, self.replays = None, 0, 0

    def __call__(self, state, images, labels):
        import torch
        time.sleep(0.01)
        self.calls += 1
        if self.calls >= 2:
            self.replays += 1
        return {'loss': torch.ones(()), 'last_loss': torch.ones(())}


@pytest.mark.chaos
@pytest.mark.processpool
def test_fleet_scale_runner_glue_on_the_cpu(tmp_path, monkeypatch):
    """``bench.run_fleet_scale`` (phase 29 of ``chip_smoke.py``) on the CPU
    at 128 rows of 32x32 images, with the scan step replaced by a stand-in:
    the real fleet workers, registry, autoscaler, dance, drain, noisy
    tenant, reference run and ledger diff, and every check of the phase."""
    from petastorm_tpu_torch import bench
    from petastorm_tpu_torch import models as models_mod
    monkeypatch.setattr(bench, 'ROWS', 128)
    monkeypatch.setattr(bench, 'ROWS_PER_GROUP', 16)
    monkeypatch.setattr(bench, 'BATCH', 8)
    monkeypatch.setattr(bench, 'SCAN_K', 2)
    monkeypatch.setattr(bench, 'SCAN_PREFETCH', 2)
    monkeypatch.setattr(bench, 'require_scan_launches', lambda *args: None)
    monkeypatch.setattr(models_mod, 'make_scan_train_step',
                        lambda k, preprocess=None: _StandInScan())
    workdir = ipc_dir(tmp_path)
    url = bench.write_imagenet_store(os.path.join(str(tmp_path), 'imagenet'), rows=128, size=32)
    line = bench.run_fleet_scale(url, 'cpu', 'cpu', None, os.path.join(workdir, 'fleet'),
                                 remote_rate=1000.0, workers=2)
    assert line['failures'] == [], line['failures']
    assert line['kill_fired'] and len(line['drains_acknowledged']) == 2
    assert line['det']['served_chunks'] == line['det']['delivered_chunks'] > 0
    assert line['noisy'] == {'rows': 128, 'served_chunks': 8,
                             'second_consumer_refused': 'overloaded'}
    assert line['diff_ledgers_rc'] == 0 and line['det']['ledger_batches'] > 0
    assert line['start']['replays'] >= 1 and line['end']['replays'] < line['replays']
    assert sum(s['joined_after_s'] is not None for s in line['spawns']) >= 2
    assert line['refusals']['end'].get('noisy', 0) >= 1
