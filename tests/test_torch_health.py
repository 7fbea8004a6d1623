"""Pipeline health of the port against the JAX package's
(``tests/test_chaos.py:525-935, 1026-1100``): the stall vocabulary,
``classify_stall`` over a seeded grid of beat tables and probe snapshots
(the memory overlay, ``pipeline-waiting`` and every label included),
``Watchdog.check(now=)`` on a synthetic clock (episodes, soft recoveries,
escalation at ``escalation x deadline``, none for the soft-only labels,
the counters), ``PSTT_WATCHDOG``'s grammar, and each fault-driven
classification that needs no process pool, through both packages' readers
and loaders (the port's on ``device='cpu'``) on one store and one spec.
Labels, stages and counts are compared exactly; where a thread must see a
stall, the test waits for it with a deadline."""

import queue
import threading
import time

import numpy as np
import pytest

from petastorm_tpu import faults as jax_faults
from petastorm_tpu import health as jax_health
from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu import make_tensor_reader as jax_make_tensor_reader
from petastorm_tpu import metrics as jax_metrics
from petastorm_tpu.errors import PipelineStallError as JaxPipelineStallError
from petastorm_tpu.jax_loader import JaxLoader
from petastorm_tpu_torch import (ScalarCodec, TorchLoader, Unischema, UnischemaField, faults,
                                 health, make_reader, make_tensor_reader, metrics, write_dataset)
from petastorm_tpu_torch.errors import PipelineStallError

ROWS, PER_GROUP = 100, 10


@pytest.fixture(scope='module')
def url(tmp_path_factory):
    schema = Unischema('HealthSchema', [UnischemaField('id', np.int64, (), ScalarCodec(np.int64),
                                                       False)])
    url = 'file://' + str(tmp_path_factory.mktemp('health') / 'ds')
    write_dataset(url, schema, [{'id': i} for i in range(ROWS)], rows_per_row_group=PER_GROUP)
    return url


@pytest.fixture
def registries():
    """Fresh metrics registries in both packages."""
    previous = (metrics.set_registry(metrics.MetricsRegistry()),
                jax_metrics.set_registry(jax_metrics.MetricsRegistry()))
    try:
        yield metrics.get_registry(), jax_metrics.get_registry()
    finally:
        metrics.set_registry(previous[0])
        jax_metrics.set_registry(previous[1])


# -- the vocabulary and classify_stall ------------------------------------------

LABELS = ('READER_STARVED', 'WORKER_POOL_DEAD', 'ASSEMBLE_STUCK', 'DISPATCH_HUNG',
          'CONSUMER_NOT_DRAINING', 'ARENA_POOL_WEDGED', 'REMOTE_SERVER_DEAD', 'SERVER_DRAINING',
          'SERVER_OVERLOADED', 'RESEQUENCER_STALLED', 'MEMORY_PRESSURE', 'PIPELINE_WAITING')


def test_vocabulary_is_the_jax_packages():
    for name in LABELS:
        assert getattr(health, name) == getattr(jax_health, name)
    assert health.SOFT_ONLY == jax_health.SOFT_ONLY
    assert health._WAITING_STATES == jax_health._WAITING_STATES
    assert health._MEM_REINTERPRETED == jax_health._MEM_REINTERPRETED
    assert health._MEM_DEGRADED_STATES == jax_health._MEM_DEGRADED_STATES
    assert health.DEFAULT_STALL_TIMEOUT_S == jax_health.DEFAULT_STALL_TIMEOUT_S
    assert health.DEFAULT_ESCALATION_FACTOR == jax_health.DEFAULT_ESCALATION_FACTOR
    assert health.ENV_VAR == 'PSTT_WATCHDOG' != jax_health.ENV_VAR


STAGES = ('ventilator', 'reader-handoff', 'worker-pool', 'assemble', 'dispatch', 'consumer',
          'remote-recv', 'decoder')
STATES = ('idle', 'collate', 'reader-wait', 'arena-wait', 'stageq-put', 'stageq-get',
          'device_put', 'ready-wait', 'out-put', 'queue-wait', 'delivered', 'poll', 'handoff',
          'ventilating', 'backpressure', 'recv')
MEM_STATES = ('ok', 'advisory', 'degrade', 'shed', 'breach')


def _grid_case(rng):
    """A random beat table and probe snapshot."""
    beats = {}
    for stage in STAGES:
        if rng.random() < 0.45:
            timeout = None if rng.random() < 0.1 else float(rng.choice([0.2, 1.0, 5.0]))
            beats[stage] = {'age_s': round(float(rng.uniform(0, 8)), 3),
                            'state': str(rng.choice(STATES)), 'beats': int(rng.integers(0, 9)),
                            'stall_timeout_s': timeout}
    probes = {}
    if rng.random() < 0.15:
        probes['worker-pool'] = {'dead_workers': [int(x) for x in rng.integers(0, 4, 2)]}
    if rng.random() < 0.3:
        probes['resequencer'] = {'buffered': int(rng.integers(0, 3)),
                                 'waiting_s': float(rng.choice([0.0, 1.5])),
                                 'expected_seq': int(rng.integers(0, 50))}
    if rng.random() < 0.5:
        probes['consumer'] = {'queue_depth': int(rng.integers(0, 4))}
    if rng.random() < 0.4:
        remote = {'dead_endpoints': ['tcp://h:1'] if rng.random() < 0.3 else []}
        if rng.random() < 0.4:
            remote['draining_endpoints'] = ['tcp://h:3']
        if rng.random() < 0.4:
            remote['refused_endpoints'] = {'tcp://h:4': 'overloaded'}
        probes['remote-recv'] = remote
    if rng.random() < 0.6:
        probes['memory'] = {'armed': bool(rng.random() < 0.8),
                            'state': str(rng.choice(MEM_STATES)),
                            'accounted_bytes': int(rng.integers(0, 10**6)),
                            'budget_bytes': 10**6, 'frac': round(float(rng.random()), 4)}
    return beats, probes


def test_classify_stall_equals_the_jax_packages_over_a_grid():
    rng = np.random.default_rng(15)
    seen = set()
    for _ in range(3000):
        beats, probes = _grid_case(rng)
        ours = health.classify_stall(beats, probes)
        theirs = jax_health.classify_stall(beats, probes)
        if ours[0] == health.WORKER_POOL_DEAD:
            # The port's sentence names its own respawn rule; the dead list
            # is the same.
            assert ours[:2] == theirs[:2]
            assert str(probes['worker-pool']['dead_workers']) in ours[2]
        else:
            assert ours == theirs, (beats, probes)
        seen.add(ours[0])
    labels = {getattr(health, name) for name in LABELS}
    assert labels <= seen, labels - seen
    assert any(label.endswith('-stalled') and label != health.RESEQUENCER_STALLED
               for label in seen)


def _beat(age, state, timeout=0.1):
    return {'age_s': age, 'state': state, 'beats': 1, 'stall_timeout_s': timeout}


@pytest.mark.parametrize('beats,probes,label', [
    ({'assemble': _beat(1.0, 'arena-wait')}, {}, 'arena-pool-wedged'),
    ({'assemble': _beat(1.0, 'reader-wait')}, {}, 'reader-starved'),
    ({'assemble': _beat(1.0, 'collate')}, {}, 'assemble-stuck'),
    ({'dispatch': _beat(1.0, 'device_put')}, {}, 'dispatch-hung'),
    ({'dispatch': _beat(1.0, 'ready-wait')}, {}, 'dispatch-hung'),
    ({'dispatch': _beat(1.0, 'out-put')}, {}, 'consumer-not-draining'),
    ({'consumer': _beat(1.0, 'delivered')}, {'consumer': {'queue_depth': 2}},
     'consumer-not-draining'),
    ({'consumer': _beat(1.0, 'device_put')}, {}, 'dispatch-hung'),
    ({'consumer': _beat(1.0, 'reader-wait')}, {}, 'reader-starved'),
    ({'reader-handoff': _beat(1.0, 'poll')}, {'worker-pool': {'dead_workers': [1]}},
     'worker-pool-dead'),
    ({'remote-recv': _beat(1.0, 'recv')}, {'remote-recv': {'dead_endpoints': ['tcp://h:1']}},
     'remote-server-dead'),
    ({'dispatch': _beat(1.0, 'stageq-get'), 'consumer': _beat(1.0, 'queue-wait')}, {},
     'pipeline-waiting'),
    ({'remote-recv': _beat(9.0, 'idle'), 'consumer': _beat(1.0, 'delivered')}, {},
     'consumer-not-draining'),
    ({'reader-handoff': _beat(1.0, 'handoff')}, {'resequencer': {'buffered': 2, 'waiting_s': 1.0,
                                                                  'expected_seq': 7}},
     'resequencer-stalled'),
    ({'assemble': _beat(1.0, 'reader-wait')},
     {'memory': {'armed': True, 'state': 'shed', 'accounted_bytes': 9, 'budget_bytes': 10,
                 'frac': 0.9}}, 'memory-pressure'),
    ({'dispatch': _beat(1.0, 'device_put')},
     {'memory': {'armed': True, 'state': 'breach', 'accounted_bytes': 11, 'budget_bytes': 10,
                 'frac': 1.1}}, 'dispatch-hung'),
    ({'decoder': _beat(1.0, 'busy')}, {}, 'decoder-stalled'),
])
def test_classify_stall_table(beats, probes, label):
    assert health.classify_stall(beats, probes)[0] == label
    assert jax_health.classify_stall(beats, probes)[0] == label


# -- the watchdog on a synthetic clock -------------------------------------------

def _drive_watchdog(mod, script, escalation=2.0):
    """Drive ``mod``'s Watchdog through ``script``: (now, {stage: (last_beat,
    state)}) steps on one clock; returns each check's (classification, stage)
    or None, the watchdog's stats and the recovery calls."""
    registry = mod.HeartbeatRegistry({'default': 1.0, 'consumer': 2.0})
    beats = {name: registry.register(name) for name in ('assemble', 'dispatch', 'consumer')}
    calls = []
    registry.register_recovery(mod.READER_STARVED, lambda d: calls.append(d['stage']) or True)
    registry.register_recovery(mod.CONSUMER_NOT_DRAINING, lambda d: False)
    delivered = []
    dog = mod.Watchdog(registry, on_hard_stall=delivered.append, escalation=escalation)
    out = []
    for now, updates in script:
        for name, (last_beat, state) in updates.items():
            beats[name].last_beat = last_beat
            beats[name].state = state
        diagnosis = dog.check(now=now)
        out.append(None if diagnosis is None else (diagnosis['classification'],
                                                   diagnosis['stage']))
    stats = dog.stats()
    stats.pop('last_stall')
    return out, stats, calls, [type(e).__name__ for e in delivered]


WATCHDOG_SCRIPT = [
    (100.0, {'assemble': (100.0, 'collate'), 'dispatch': (100.0, 'stageq-get'),
             'consumer': (100.0, 'queue-wait')}),
    (100.5, {}),
    (101.2, {}),                                               # assemble stale: stuck
    (101.5, {}),
    (103.2, {}),                                               # past 2 x 1 s: hard
    (103.5, {}),                                               # fired once
    (104.0, {'assemble': (104.0, 'reader-wait')}),             # fresh beat: episode over
    (105.1, {}),                                               # reader-starved, recovered
    (107.2, {}),                                               # hard again
    (107.3, {'assemble': (107.3, 'stageq-put'), 'dispatch': (107.3, 'out-put'),
             'consumer': (107.3, 'delivered')}),
    (109.4, {}),                                               # consumer: soft only
    (115.0, {}),                                               # never escalates
    (116.0, {'consumer': (116.0, 'queue-wait'), 'dispatch': (116.0, 'stageq-get'),
             'assemble': (116.0, 'collate')}),
    (116.5, {}),
]


@pytest.mark.parametrize('escalation', [2.0, 1.0, 3.5])
def test_watchdog_check_on_a_synthetic_clock_equals_the_jax_packages(registries, escalation):
    ours = _drive_watchdog(health, WATCHDOG_SCRIPT, escalation)
    theirs = _drive_watchdog(jax_health, WATCHDOG_SCRIPT, escalation)
    assert ours == theirs
    checks, stats, calls, delivered = ours
    assert checks[2] == ('assemble-stuck', 'assemble')
    assert ('consumer-not-draining', 'dispatch') in checks
    assert stats['stalls_detected'] == sum(1 for c in checks if c is not None) - \
        stats['hard_stalls']
    assert all(name == 'PipelineStallError' for name in delivered)
    assert len(delivered) == stats['hard_stalls']
    # The stalls end within 3 s: at 3.5 x the deadline none escalates.
    assert (stats['hard_stalls'] >= 1) == (escalation <= 2.0)
    assert calls and set(calls) == {'assemble'}
    port_reg, jax_reg = registries
    for metric in ('pst_watchdog_stalls_total', 'pst_watchdog_soft_recoveries_total',
                   'pst_watchdog_hard_stalls_total'):
        assert port_reg.collect()[metric] == jax_reg.collect()[metric], metric


def test_escalation_comes_at_escalation_times_the_deadline(registries):
    script = [(10.0, {'assemble': (10.0, 'collate')}), (11.01, {}), (12.5, {}), (13.0, {}),
              (13.02, {})]
    for mod in (health, jax_health):
        checks, stats, _, delivered = _drive_watchdog(mod, script)
        # Detected at 11.01; 2 x 1 s later (13.01) it is hard, not at 12.5 or 13.0.
        assert checks == [None, ('assemble-stuck', 'assemble'), None, None,
                          ('assemble-stuck', 'assemble')]
        assert stats['hard_stalls'] == 1 and delivered == ['PipelineStallError']


# -- PSTT_WATCHDOG --------------------------------------------------------------

@pytest.mark.parametrize('value', [None, '', '0', '1', 'true', 'TRUE', 'off', 'no', 'false',
                                   'yes', ' 30 ', '2.5', '-1', '0.0', 'abc', 'nan', 'inf'])
def test_watchdog_variable_parses_as_the_jax_packages(monkeypatch, value):
    results = []
    for mod in (health, jax_health):
        if value is None:
            monkeypatch.delenv(mod.ENV_VAR, raising=False)
        else:
            monkeypatch.setenv(mod.ENV_VAR, value)
        results.append((mod.watchdog_enabled(), mod.watchdog_enabled(True),
                        mod.watchdog_enabled(False), mod.env_stall_timeout(),
                        mod.HeartbeatRegistry().timeout_for('any'),
                        mod.HeartbeatRegistry(4.0).timeout_for('any')))
    assert repr(results[0]) == repr(results[1])


# -- fault-driven classifications through the readers and loaders ---------------

def _set_faults(monkeypatch, mod, spec):
    if spec is None:
        monkeypatch.delenv(mod.ENV_VAR, raising=False)
    else:
        monkeypatch.setenv(mod.ENV_VAR, spec)


def _loader(package, url, batch_size=10, workers_count=2, reader=None, **kwargs):
    if package == 'port':
        reader = reader or make_tensor_reader(url, reader_pool_type='thread',
                                              workers_count=workers_count, num_epochs=1,
                                              shuffle_row_groups=False)
        return reader, TorchLoader(reader, batch_size, device='cpu', **kwargs)
    reader = reader or jax_make_tensor_reader(url, reader_pool_type='thread',
                                              workers_count=workers_count, num_epochs=1,
                                              shuffle_row_groups=False)
    return reader, JaxLoader(reader, batch_size, **kwargs)


def _close(package, reader, loader):
    if package == 'port':
        loader.close()
    else:
        loader.stop()
    reader.stop()
    reader.join()


def _epoch_watchdog(package, url, monkeypatch, spec, **kwargs):
    """One epoch under ``spec``: (batches, the watchdog's stats)."""
    _set_faults(monkeypatch, faults if package == 'port' else jax_faults, spec)
    reader, loader = _loader(package, url, **kwargs)
    try:
        batches = sum(1 for _ in loader)
        stats = loader.stats['watchdog']
    finally:
        _close(package, reader, loader)
    return batches, stats


@pytest.mark.timeout(60)
def test_quiet_on_a_healthy_pipeline(url, monkeypatch):
    for package in ('port', 'jax'):
        batches, stats = _epoch_watchdog(package, url, monkeypatch, None, watchdog=True,
                                         stall_timeout_s=10.0)
        assert batches == ROWS // 10
        assert stats['stalls_detected'] == 0 and stats['hard_stalls'] == 0
    assert {'ventilator', 'reader-handoff', 'worker-pool', 'assemble', 'dispatch',
            'consumer'} <= set(stats['beats'])


@pytest.mark.timeout(60)
@pytest.mark.parametrize('spec', ['fs-read-delay:delay=0.9:max=1', 'queue-stall:delay=0.9:max=1'])
def test_slow_reads_classify_reader_starved_alike(url, monkeypatch, spec):
    """A slow read or a worker that holds its result starves the loader:
    reader-starved at the assemble stage, soft (the epoch completes)."""
    seen = {}
    for package in ('port', 'jax'):
        batches, stats = _epoch_watchdog(package, url, monkeypatch, spec, workers_count=1,
                                         watchdog=True, stall_timeout_s=0.4)
        assert batches == ROWS // 10
        assert stats['stalls_detected'] >= 1 and stats['hard_stalls'] == 0
        seen[package] = (stats['last_stall']['classification'], stats['last_stall']['stage'])
    assert seen['port'] == seen['jax'] == ('reader-starved', 'assemble')


@pytest.mark.timeout(60)
def test_a_hung_copy_escalates_to_dispatch_hung_alike(url, monkeypatch, registries):
    seen = {}
    for package, error_type in (('port', PipelineStallError), ('jax', JaxPipelineStallError)):
        _set_faults(monkeypatch, faults if package == 'port' else jax_faults,
                    'device-put-delay:delay=1.5:max=1')
        reader, loader = _loader(package, url, watchdog=True, stall_timeout_s=0.3)
        t0 = time.monotonic()
        try:
            with pytest.raises(error_type) as raised:
                for _ in loader:
                    pass
            elapsed = time.monotonic() - t0
            stats = loader.stats['watchdog']
        finally:
            _set_faults(monkeypatch, faults if package == 'port' else jax_faults, None)
            _close(package, reader, loader)
        diagnosis = raised.value.diagnosis
        assert 'dispatch-hung' in str(raised.value) and 'Thread' in str(raised.value)
        assert elapsed < 5.0
        seen[package] = (diagnosis['classification'], diagnosis['stage'], stats['hard_stalls'],
                         sorted(diagnosis))
    assert seen['port'] == seen['jax']
    assert seen['port'][:3] == ('dispatch-hung', 'dispatch', 1)
    port_reg, jax_reg = registries
    assert port_reg.collect()['pst_watchdog_hard_stalls_total'] == \
        jax_reg.collect()['pst_watchdog_hard_stalls_total']


class _SlowPolicy(object):
    """A shape policy whose first call wedges the collate."""

    def __init__(self, sleep_s):
        self._sleep_s = sleep_s
        self._fired = False

    def apply(self, value):
        if not self._fired:
            self._fired = True
            time.sleep(self._sleep_s)
        return np.asarray(value)


@pytest.mark.timeout(60)
def test_a_wedged_collate_classifies_assemble_stuck_alike(url):
    seen = {}
    for package, factory in (('port', make_reader), ('jax', jax_make_reader)):
        reader = factory(url, reader_pool_type='thread', workers_count=2, num_epochs=1,
                         shuffle_row_groups=False)
        _, loader = _loader(package, url, reader=reader, shape_policies={'id': _SlowPolicy(0.9)},
                            watchdog=True, stall_timeout_s=0.4)
        try:
            batches = sum(1 for _ in loader)
            stats = loader.stats['watchdog']
        finally:
            _close(package, reader, loader)
        assert batches == ROWS // 10 and stats['hard_stalls'] == 0
        seen[package] = (stats['last_stall']['classification'], stats['last_stall']['stage'])
    assert seen['port'] == seen['jax'] == ('assemble-stuck', 'assemble')


def _wait_for(predicate, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return False


@pytest.mark.timeout(60)
def test_a_consumer_that_walks_away_is_never_escalated_alike(url):
    seen = {}
    for package in ('port', 'jax'):
        reader, loader = _loader(package, url, batch_size=5, prefetch=2, watchdog=True,
                                 stall_timeout_s=0.3)
        try:
            it = iter(loader)
            next(it)
            assert _wait_for(lambda: loader.stats['watchdog']['last_stall'] is not None)
            stats = loader.stats['watchdog']
            seen[package] = (stats['last_stall']['classification'], stats['hard_stalls'])
            remaining = sum(1 for _ in it)
        finally:
            _close(package, reader, loader)
        assert remaining == ROWS // 5 - 1
        assert loader.stats['watchdog']['hard_stalls'] == 0
    assert seen['port'] == seen['jax'] == ('consumer-not-draining', 0)


@pytest.mark.timeout(30)
def test_a_pinned_arena_pool_classifies_arena_pool_wedged():
    from petastorm_tpu.staging import ArenaPool as JaxArenaPool
    from petastorm_tpu_torch.staging import ArenaPool

    seen = {}
    for package, mod, make_pool in (
            ('port', health, lambda stop, hb: ArenaPool(1, stop, pinned=False, heartbeat=hb)),
            ('jax', jax_health, lambda stop, hb: JaxArenaPool(1, stop_event=stop,
                                                               grow_timeout_s=30.0,
                                                               heartbeat=hb))):
        registry = mod.HeartbeatRegistry(0.2)
        heartbeat = registry.register('assemble')
        stop = threading.Event()
        pool = make_pool(stop, heartbeat)
        spec = {'x': ((4,), np.dtype('float32'))}
        assert pool.get_buffers(spec) is not None
        arena = pool.claim_pending()
        got = []
        waiter = threading.Thread(target=lambda: got.append(pool.get_buffers(spec)), daemon=True)
        waiter.start()
        assert _wait_for(lambda: heartbeat.state == 'arena-wait')
        now = heartbeat.last_beat + 0.3
        seen[package] = mod.classify_stall(registry.beat_table(now=now),
                                           registry.probe_snapshot())[:2]
        arena.retire()
        waiter.join(timeout=5)
        assert not waiter.is_alive() and got and got[0] is not None
        stop.set()
        pool.wake()
    assert seen['port'] == seen['jax'] == ('arena-pool-wedged', 'assemble')


@pytest.mark.timeout(60)
def test_a_reader_alone_raises_its_diagnosed_stall_alike(url, monkeypatch):
    seen = {}
    for package, factory, error_type in (('port', make_tensor_reader, PipelineStallError),
                                         ('jax', jax_make_tensor_reader, JaxPipelineStallError)):
        _set_faults(monkeypatch, faults if package == 'port' else jax_faults,
                    'queue-stall:delay=1.3:max=1')
        with factory(url, reader_pool_type='thread', workers_count=1, num_epochs=1,
                     shuffle_row_groups=False, watchdog=True, stall_timeout_s=0.2) as reader:
            t0 = time.monotonic()
            with pytest.raises(error_type) as raised:
                next(iter(reader))
            assert time.monotonic() - t0 < 3.0
            assert 'Thread' in str(raised.value)
            seen[package] = (raised.value.diagnosis['classification'],
                             raised.value.diagnosis['stage'])
        _set_faults(monkeypatch, faults if package == 'port' else jax_faults, None)
    assert seen['port'] == seen['jax'] == ('reader-starved', 'reader-handoff')


@pytest.mark.timeout(60)
def test_a_recovered_stall_does_not_kill_the_reader_alike(url, monkeypatch):
    for package, factory, error_type in (('port', make_tensor_reader, PipelineStallError),
                                         ('jax', jax_make_tensor_reader, JaxPipelineStallError)):
        _set_faults(monkeypatch, faults if package == 'port' else jax_faults,
                    'queue-stall:delay=1.2:max=1')
        rows = 0
        with factory(url, reader_pool_type='thread', workers_count=1, num_epochs=1,
                     shuffle_row_groups=False, watchdog=True, stall_timeout_s=0.2) as reader:
            it = iter(reader)
            while True:
                try:
                    chunk = next(it)
                except StopIteration:
                    break
                except error_type:
                    continue
                rows += len(chunk.id)
        _set_faults(monkeypatch, faults if package == 'port' else jax_faults, None)
        assert rows == ROWS, package


@pytest.mark.timeout(60)
def test_the_variable_arms_a_readers_watchdog_alike(url, monkeypatch):
    for mod, factory in ((health, make_reader), (jax_health, jax_make_reader)):
        monkeypatch.setenv(mod.ENV_VAR, '0')
        with factory(url, reader_pool_type='dummy', num_epochs=1,
                     shuffle_row_groups=False) as reader:
            assert 'watchdog' not in reader.diagnostics()
        monkeypatch.setenv(mod.ENV_VAR, '30')
        with factory(url, reader_pool_type='dummy', num_epochs=1,
                     shuffle_row_groups=False) as reader:
            assert reader.diagnostics()['watchdog']['stalls_detected'] == 0
            assert reader._health.registry.timeout_for('anything') == 30.0
        monkeypatch.delenv(mod.ENV_VAR)


@pytest.mark.timeout(60)
def test_reader_diagnostics_watchdog_has_the_jax_packages_keys(url):
    keys = {}
    for package, factory in (('port', make_tensor_reader), ('jax', jax_make_tensor_reader)):
        with factory(url, reader_pool_type='thread', workers_count=2, num_epochs=1,
                     shuffle_row_groups=False, deterministic=True, watchdog=True,
                     stall_timeout_s=10) as reader:
            sum(1 for _ in reader)
            section = reader.diagnostics()['watchdog']
            keys[package] = (set(section), set(section['beats']))
    assert keys['jax'][0] <= keys['port'][0]
    assert keys['port'][0] - keys['jax'][0] == {'alive'}
    assert keys['port'][1] == keys['jax'][1] == {'ventilator', 'reader-handoff', 'worker-pool'}


@pytest.mark.timeout(30)
def test_staging_stop_records_a_leaked_thread():
    from petastorm_tpu_torch.staging import ArenaPool, StagingEngine
    from petastorm_tpu_torch.trace import Tracer

    release = threading.Event()
    entered = threading.Event()

    def stage_fn(batch, arena):
        entered.set()
        release.wait(10)        # a copy that ignores stop
        return batch

    tracer = Tracer()
    stop = threading.Event()
    registry = health.HeartbeatRegistry(5.0)
    engine = StagingEngine(iter([{'x': np.zeros(4)}]), stage_fn, queue.Queue(maxsize=2), stop,
                           object(), ArenaPool(2, stop, pinned=False), tracer=tracer,
                           health=registry).start()
    try:
        assert entered.wait(5)
        assert registry.beat_table()['dispatch']['state'] == 'device_put'
        assert 'staging' in registry.probe_snapshot()
        leaked = engine.stop(join_timeout_s=0.2)
        assert leaked == ['pstt-staging-dispatch']
        assert engine.stats()['leaked_threads'] == ['pstt-staging-dispatch']
        assert any(e['name'] == 'staging-leaked-thread:pstt-staging-dispatch'
                   for e in tracer.events)
    finally:
        release.set()
        for thread in engine._threads:
            thread.join(timeout=5)
    assert registry.beat_table()['dispatch']['state'] == 'idle'


@pytest.mark.timeout(120)
def test_health_cell_glue_on_the_cpu(tmp_path, monkeypatch):
    """``bench.run_imagenet_health`` (phase 24 of ``chip_smoke.py``) at a
    small size on the CPU: the training scan replaced by the same reader and
    loader (its hooks called as the scan calls them) and the step by a
    stand-in; every check of the cell runs, the replay tool and the injected
    stall included."""
    import torch
    from petastorm_tpu_torch import CompressedImageCodec, bench, make_pod_reader
    from petastorm_tpu_torch import models as models_mod

    schema = Unischema('HealthCell', [
        UnischemaField('image', np.uint8, (16, 16, 3), CompressedImageCodec('png'), False),
        UnischemaField('label', np.int64, (), ScalarCodec(np.int64), False)])
    rng = np.random.default_rng(24)
    store = 'file://' + str(tmp_path / 'images')
    write_dataset(store, schema, ({'image': rng.integers(0, 256, (16, 16, 3), dtype=np.uint8),
                                   'label': i} for i in range(64)), rows_per_row_group=8)

    def scan(url, device, train, state, warmup, calls, kernels, workers=4, loader_kwargs=None,
             hooks=None, **_):
        reader = make_pod_reader(url, pod_shard=(0, 1), schema_fields=['image', 'label'],
                                 reader_pool_type='thread', workers_count=workers,
                                 shuffle_row_groups=True, seed=0, num_epochs=None,
                                 cache_type='memory')
        with reader:
            with TorchLoader(reader, bench.BATCH, device='cpu', prefetch=bench.SCAN_PREFETCH,
                             **(loader_kwargs or {})) as loader:
                groups = loader.superbatches(bench.SCAN_K)
                for _ in range(warmup + calls):
                    next(groups)
                hooks('timed', loader, reader)
                for _ in range(calls):
                    next(groups)
                hooks('close', loader, reader)
        return {'img_per_s': 1.0}, ({}, {}, {'normalize_kernel': 0}, 0)

    monkeypatch.setattr(bench, 'stream_classifier_scan', scan)
    monkeypatch.setattr(bench, 'require_scan_launches', lambda *args: None)
    monkeypatch.setattr(models_mod, 'make_scan_train_step',
                        lambda k, preprocess=None: lambda state, x, y: {'loss': torch.ones(())})
    monkeypatch.setattr(bench, 'ROWS', 64)
    monkeypatch.setattr(bench, 'BATCH', 4)
    monkeypatch.setattr(bench, 'SCAN_K', 2)
    monkeypatch.setattr(bench, 'SCAN_PREFETCH', 2)
    monkeypatch.setattr(bench, 'HEALTH_FAULT_DELAY_S', 1.5)
    monkeypatch.delenv(faults.ENV_VAR, raising=False)
    line = bench.run_imagenet_health(store, torch.device('cpu'), 'cpu', None,
                                     str(tmp_path / 'work'), warmup=1, calls=6, workers=2)
    assert line['phase'] == 'imagenet_health'
    assert line['healthy']['watchdog']['stalls_detected'] == 0
    assert set(bench.HEALTH_SPANS) <= set(line['healthy']['spans'])
    assert line['healthy']['replayed'] == {'8': True, '20': True}
    stall = line['injected_stall']
    assert stall['classification'] == 'dispatch-hung' and stall['fault_to_error_s'] < 5
    assert sorted(stall['flight_dump']['files']) == sorted(bench.HEALTH_DUMP_FILES)
    assert not faults.get_injector().active_sites


def test_a_refused_deadline_leaves_no_thread(url):
    before = {t.ident for t in threading.enumerate()}
    with pytest.raises(ValueError):
        make_tensor_reader(url, workers_count=2, watchdog=True, stall_timeout_s='soon')
    assert _wait_for(lambda: not [t.name for t in threading.enumerate()
                                  if t.ident not in before and t.name.startswith('pstt-')])
