"""The port's host memory governor against the JAX package's on the CPU:
one scripted sequence of pool bytes walks both ladders tick for tick, and
the counterparts of ``tests/test_membudget.py`` that need no fault site,
metrics or autotuner: budget resolution, the ladder's rungs, the pools'
hooks, the sampler's refcounted lifecycle, and the readers and loaders
registering their pools, with a breach raised by ``next(loader)``.
"""

import threading
import time

import numpy as np
import pytest

from petastorm_tpu_torch import (NdarrayCodec, ScalarCodec, TorchLoader, Unischema,
                                 UnischemaField, make_reader, make_tensor_reader, membudget,
                                 write_dataset)
from petastorm_tpu_torch.cache import MemoryCache
from petastorm_tpu_torch.errors import HostMemoryExceededError
from petastorm_tpu_torch.lineage import LineageTracker, _digest_array
from petastorm_tpu_torch.membudget import (STATE_ADVISORY, STATE_BREACH, STATE_DEGRADE,
                                           STATE_OK, STATE_SHED, GovernorConfig, MemoryGovernor,
                                           approx_nbytes, cgroup_memory_limit, parse_bytes,
                                           resolve_budget)
from petastorm_tpu_torch.shuffling_buffer import RandomShufflingBuffer
from petastorm_tpu_torch.staging import ArenaPool

pytestmark = pytest.mark.membudget

ROWS, PER_GROUP = 40, 5


@pytest.fixture(scope='module')
def url(tmp_path_factory):
    schema = Unischema('MemSchema', [
        UnischemaField('id', np.int32, (), ScalarCodec(np.int32)),
        UnischemaField('vec', np.float32, (4,), NdarrayCodec()),
    ])
    rng = np.random.default_rng(2)
    url = 'file://' + str(tmp_path_factory.mktemp('mem') / 'store')
    write_dataset(url, schema, ({'id': i, 'vec': rng.normal(size=4).astype(np.float32)}
                                for i in range(ROWS)), rows_per_row_group=PER_GROUP)
    return url


@pytest.fixture
def governor(monkeypatch, tmp_path):
    """A fresh process-wide governor (1 MB budget, armed without its
    sampler so that the test drives ``check()``); the previous one comes
    back afterwards. A breach's flight dump lands under ``tmp_path``."""
    monkeypatch.delenv(membudget.ENV_VAR, raising=False)
    monkeypatch.setenv('PSTT_FLIGHT_RECORDER', str(tmp_path / 'flight'))
    gov = MemoryGovernor(budget=1_000_000, config=GovernorConfig())
    previous = membudget.set_governor(gov)
    gov._arm_count += 1
    try:
        yield gov
    finally:
        while gov._arm_count > 0:
            gov.release()
        membudget.set_governor(previous)


def _sampler_threads():
    return [t for t in threading.enumerate() if t.name == membudget.THREAD_NAME and t.is_alive()]


# -- the ladder against the JAX governor --------------------------------------

#: Bytes of pools a and b at each tick (budget 1000), and the tick at which
#: pool c (50 bytes, all hooks) registers in the middle of an episode (it
#: joins the advisory toggle at registration).
_SCRIPT = [(0, 0), (400, 350), (500, 360), (500, 360), (600, 330), (700, 400), (700, 400),
           (500, 200), (900, 200), (300, 250), (100, 0), (0, 0)]
_JOIN_TICK, _C_BYTES = 8, 50


def _walk(governor_cls, config_cls):
    gov = governor_cls(budget=1000, config=config_cls())
    gov._arm_count += 1
    events = []
    held = {'a': 0, 'b': 0}

    def hooks(name):
        return dict(degrade_fn=lambda: events.append(('degrade', name)) or True,
                    degrade_release_fn=lambda: events.append(('release', name)),
                    shed_fn=lambda active: events.append(('shed', name, active)),
                    advisory_fn=lambda active: events.append(('advisory', name, active)))

    gov.add_breach_sink(lambda e: events.append(('breach', [dict(r) for r in e.ranking],
                                                 e.accounted, e.budget)))
    gov.register_pool('a', lambda: held['a'], **hooks('a'))
    gov.register_pool('b', lambda: held['b'], **hooks('b'))
    ticks = []
    for tick, (a, b) in enumerate(_SCRIPT):
        held.update(a=a, b=b)
        if tick == _JOIN_TICK:
            gov.register_pool('c', lambda: _C_BYTES, **hooks('c'))
        state = gov.check(now=float(tick))
        ticks.append((state, list(events), gov.probe()['pools']))
        del events[:]
    stats = gov.stats()
    gov.release()
    return ticks, stats


def test_governor_walks_the_jax_ladder_tick_for_tick(tmp_path, monkeypatch):
    from petastorm_tpu import membudget as jax_membudget
    monkeypatch.setenv('PETASTORM_TPU_FLIGHT_RECORDER', str(tmp_path))
    monkeypatch.setenv('PSTT_FLIGHT_RECORDER', str(tmp_path))
    ours, our_stats = _walk(MemoryGovernor, GovernorConfig)
    theirs, their_stats = _walk(jax_membudget.MemoryGovernor, jax_membudget.GovernorConfig)
    assert ours == theirs
    states = [t[0] for t in ours]
    assert states == [STATE_OK, STATE_ADVISORY, STATE_DEGRADE, STATE_DEGRADE, STATE_SHED,
                      STATE_BREACH, STATE_BREACH, STATE_ADVISORY, STATE_BREACH, STATE_OK,
                      STATE_OK, STATE_OK]
    assert ('advisory', 'c', True) in ours[_JOIN_TICK][1]
    breaches = [e for t in ours for e in t[1] if e[0] == 'breach']
    assert len(breaches) == 2 and breaches[0][1][0] == {'pool': 'a', 'nbytes': 700}
    for key in ('degrade_actions', 'breaches', 'peak_state', 'peak_frac', 'state'):
        assert our_stats[key] == their_stats[key], key
    assert [t['state'] for t in our_stats['transitions']] == \
        [t['state'] for t in their_stats['transitions']]


# -- budget resolution --------------------------------------------------------

@pytest.mark.parametrize('text,expected', [
    ('1024', 1024), ('4k', 4096), ('2m', 2 << 20), ('3G', 3 << 30), ('1t', 1 << 40),
    ('1.5g', int(1.5 * (1 << 30))), ('', None), ('auto', None)])
def test_parse_bytes_equals_jax(text, expected):
    from petastorm_tpu.membudget import parse_bytes as jax_parse_bytes
    assert parse_bytes(text) == expected == jax_parse_bytes(text)


@pytest.mark.parametrize('text', ['lots', '-5m', '2gb'])
def test_parse_bytes_rejects_garbage(text):
    with pytest.raises(ValueError):
        parse_bytes(text)


def test_cgroup_limit_v2_and_v1(tmp_path):
    (tmp_path / 'memory.max').write_text('536870912\n')
    assert cgroup_memory_limit(str(tmp_path)) == 536870912
    (tmp_path / 'memory.max').write_text('max\n')
    v1 = tmp_path / 'memory'
    v1.mkdir()
    (v1 / 'memory.limit_in_bytes').write_text('268435456\n')
    assert cgroup_memory_limit(str(tmp_path)) == 268435456
    (v1 / 'memory.limit_in_bytes').write_text(str(1 << 62))
    assert cgroup_memory_limit(str(tmp_path)) is None


def test_resolve_budget_env_auto_and_meminfo(tmp_path, monkeypatch):
    monkeypatch.setenv(membudget.ENV_VAR, '512m')
    assert resolve_budget() == (512 << 20, 'env')
    assert resolve_budget(explicit='1m') == (1 << 20, 'explicit')
    (tmp_path / 'memory.max').write_text(str(1 << 30))
    monkeypatch.setenv(membudget.ENV_VAR, 'auto')
    headroom = max(membudget.MIN_HEADROOM_BYTES, int((1 << 30) * membudget.DEFAULT_HEADROOM_FRAC))
    assert resolve_budget(cgroup_root=str(tmp_path)) == ((1 << 30) - headroom, 'cgroup')
    meminfo = tmp_path / 'meminfo'
    meminfo.write_text('MemTotal:        8388608 kB\nMemFree: 1 kB\n')
    assert resolve_budget(cgroup_root=str(tmp_path / 'none'), meminfo_path=str(meminfo)) == \
        (int(8388608 * 1024 * membudget.DEFAULT_HOST_FRAC), 'meminfo')
    monkeypatch.delenv(membudget.ENV_VAR)
    assert resolve_budget() == (None, None)


def test_approx_nbytes_equals_jax():
    from petastorm_tpu.membudget import approx_nbytes as jax_approx_nbytes
    arr = np.zeros(1000, np.float32)
    values = [arr, {'a': arr, 'b': arr}, [arr] * 1000, b'xyz', 'text', (1, 2.0), None,
              {'key': [{'row': np.arange(5)}] * 20}]
    assert [approx_nbytes(v) for v in values] == [jax_approx_nbytes(v) for v in values]


# -- the ladder's hooks ------------------------------------------------------

def test_degrade_runs_every_tick_while_the_rung_holds(governor):
    calls = []
    governor.register_pool('p', lambda: 900_000, degrade_fn=lambda: calls.append(1) or True)
    for _ in range(3):
        governor.check()
    assert len(calls) == 3 and governor.stats()['degrade_actions'] == {'degrade:p': 3}


def test_handle_close_unregisters(governor):
    handle = governor.register_pool('gone', lambda: 999_999_999)
    assert governor.check() == STATE_BREACH
    handle.close()
    handle.close()
    assert governor.check() == STATE_OK
    assert 'gone' not in governor.probe()['pools']


def test_failing_nbytes_fn_reuses_its_last_sample(governor):
    state = {'fail': False}

    def nbytes():
        if state['fail']:
            raise RuntimeError('pool died')
        return 800_000

    governor.register_pool('flaky', nbytes)
    governor.check()
    state['fail'] = True
    assert governor.check() == STATE_ADVISORY


def test_unarmed_governor_reports_ok(monkeypatch):
    gov = MemoryGovernor(budget=1000)
    gov.register_pool('p', lambda: 10 ** 12)
    assert gov.check() == STATE_OK and gov.pressure_level() == 0


def test_last_release_resets_the_ladder_and_its_toggles(governor):
    events = []
    governor.register_pool('p', lambda: 950_000, degrade_fn=lambda: True,
                           degrade_release_fn=lambda: events.append('release'),
                           shed_fn=lambda a: events.append(('shed', a)),
                           advisory_fn=lambda a: events.append(('advisory', a)))
    assert governor.check() == STATE_SHED
    governor.release()
    assert governor.probe()['state'] == STATE_OK and not governor.probe()['armed']
    assert ('shed', False) in events and ('advisory', False) in events and 'release' in events
    assert governor.stats()['transitions'][-1]['reason'] == 'disarmed'


def test_arm_release_lifecycle(monkeypatch):
    gov = MemoryGovernor(config=GovernorConfig(interval_s=0.02))
    previous = membudget.set_governor(gov)
    try:
        monkeypatch.setenv(membudget.ENV_VAR, '64m')
        assert membudget.maybe_arm_from_env() and membudget.maybe_arm_from_env()
        assert gov.armed and gov.budget == 64 << 20 and _sampler_threads()
        gov.release()
        assert _sampler_threads()
        gov.release()
        deadline = time.monotonic() + 5
        while _sampler_threads() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not _sampler_threads()
        monkeypatch.delenv(membudget.ENV_VAR)
        assert membudget.maybe_arm_from_env() is False and not gov.armed
    finally:
        while gov._arm_count > 0:
            gov.release()
        membudget.set_governor(previous)


def test_malformed_env_budget_fails_before_any_thread_starts(url, monkeypatch):
    monkeypatch.setenv(membudget.ENV_VAR, '2gb')
    before = {t.name for t in threading.enumerate()}
    with pytest.raises(ValueError):
        make_tensor_reader(url, workers_count=2)
    with pytest.raises(ValueError):
        make_reader(url, workers_count=2)
    with pytest.raises(ValueError):
        membudget.maybe_arm_from_env()
    assert {t.name for t in threading.enumerate()} <= before


def test_transient_pool_closes_on_the_way_out(governor):
    with pytest.raises(RuntimeError):
        with membudget.transient_pool('phase', lambda: 900_000):
            assert governor.check() == STATE_DEGRADE
            raise RuntimeError('aborted phase')
    assert governor.check() == STATE_OK


# -- the pools -----------------------------------------------------------------

def test_memory_cache_evict_halves_then_empties():
    cache = MemoryCache()
    for i in range(8):
        cache.get(i, lambda: np.zeros(1000, np.uint8))
    assert cache.nbytes == 8000
    assert cache.evict() >= 4000 and cache.nbytes <= 4000
    while cache.nbytes:
        cache.evict()
    assert cache.get(0, lambda: np.zeros(1000, np.uint8)).nbytes == 1000


def test_shuffling_buffer_shrink_equals_jax():
    from petastorm_tpu.shuffling_buffer import RandomShufflingBuffer as JaxBuffer
    rows = [np.zeros(100, np.uint8) for _ in range(20)]
    ours, theirs = (cls(100, min_after_retrieve=10, seed=0) for cls in (RandomShufflingBuffer,
                                                                       JaxBuffer))
    trace = []
    for buf in (ours, theirs):
        buf.add_many(list(rows))
        steps = [buf.nbytes, buf.shrink_capacity(), buf.capacity, buf._min_after_retrieve]
        while buf.can_retrieve():
            buf.retrieve()
        while buf.shrink_capacity():
            pass
        steps += [buf.size, buf.capacity, buf._min_after_retrieve, buf.shrink_capacity()]
        trace.append(steps)
    assert trace[0] == trace[1]
    assert trace[0][:4] == [2000, True, 50, 5] and trace[0][4:] == [5, 5, 1, False]


def test_shrink_capacity_never_undercuts_the_current_fill():
    buf = RandomShufflingBuffer(100, min_after_retrieve=80, seed=0, extra_capacity=10)
    buf.add_many([np.zeros(8, np.uint8)] * 90)
    assert buf.shrink_capacity() is True and buf.capacity == 90
    buf.add_many([np.zeros(8, np.uint8)] * 5)
    while buf.can_retrieve():
        buf.retrieve()
    assert buf.shrink_capacity() is True and buf.capacity < 90


def test_arena_pool_bytes_and_pin_toggle():
    pool = ArenaPool(2, threading.Event(), pinned=False)
    assert pool.nbytes == 0
    spec = {'x': ((4, 3), np.dtype(np.float32)), 'y': ((4,), np.dtype(np.int64))}
    pool.get_buffers(spec)
    pool.claim_pending()
    pool.get_buffers(spec)
    assert pool.nbytes == 2 * (48 + 32)
    pool.set_pinned(True)
    assert pool.pinned and pool.stats()['arena_pinned']
    pool.set_pinned(False)
    assert not pool.pinned


def test_lineage_pressure_shedding_counts_drops(tmp_path):
    tracker = LineageTracker({'mode': 'test'}, ledger_dir=str(tmp_path))
    try:
        collector = tracker.collector
        for piece in range(3):
            if piece == 1:
                assert tracker.set_pressure_shedding(True) is True
                assert tracker.set_pressure_shedding(True) is False
            if piece == 2:
                tracker.set_pressure_shedding(False)
            collector.on_chunk({'piece_index': piece, 'row_start': 0, 'row_stop': 4}, 4)
            collector.on_batch(4)
            assert tracker.deliver() is not None
        assert tracker.flush()
        stats = tracker.stats()
        assert stats['records'] == 3 and stats['pressure_dropped'] == 1 and stats['dropped'] == 1
        assert tracker.queued_nbytes() == 0
    finally:
        tracker.close()


# -- the reader and the loader -------------------------------------------------

def _names(gov):
    return sorted(h.name for h in gov._pools)


def test_reader_and_loader_register_their_pools_and_arm(url, tmp_path, monkeypatch):
    gov = MemoryGovernor(config=GovernorConfig(interval_s=0.05))
    previous = membudget.set_governor(gov)
    try:
        monkeypatch.setenv(membudget.ENV_VAR, '1g')
        with make_tensor_reader(url, workers_count=1, num_epochs=1, cache_type='memory',
                                shuffle_row_groups=False) as reader:
            assert gov.armed and _names(gov) == ['memory-cache', 'results-queue']
            with TorchLoader(reader, 4, device='cpu', shuffling_queue_capacity=16,
                             lineage=str(tmp_path / 'ledger')) as loader:
                assert _names(gov) == ['arena-pool', 'lineage-queue', 'memory-cache',
                                       'prefetch-queue', 'results-queue', 'shuffling-buffer']
                shuffler = [h for h in gov._pools if h.name == 'shuffling-buffer'][0]
                assert shuffler.degrade_fn is not None   # the reader is not deterministic
                assert sum(len(b.id) for b in loader) == ROWS
                gov.check()
                pools = gov.probe()['pools']
                assert pools['memory-cache'] > 0 and pools['arena-pool'] > 0
                assert loader.stats['mem']['armed']
        assert gov._arm_count == 0 and _names(gov) == []
        with make_tensor_reader(url, workers_count=2, num_epochs=1, deterministic=True,
                                cache_type='chunk-store',
                                cache_location=str(tmp_path / 'store')) as reader:
            assert _names(gov) == ['chunk-store', 'resequencer', 'results-queue']
            with TorchLoader(reader, 4, device='cpu', shuffling_queue_capacity=16) as loader:
                shuffler = [h for h in gov._pools if h.name == 'shuffling-buffer'][0]
                assert shuffler.degrade_fn is None      # it would change the draws
                list(loader)
                assert loader.stats['chunk_store']['misses'] == ROWS // PER_GROUP
        deadline = time.monotonic() + 5
        while _sampler_threads() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert gov._arm_count == 0 and not _sampler_threads()
    finally:
        while gov._arm_count > 0:
            gov.release()
        membudget.set_governor(previous)


@pytest.mark.parametrize('prefetch', [0, 2])
def test_breach_raises_from_next_loader(url, governor, prefetch):
    with make_tensor_reader(url, workers_count=1, num_epochs=None) as reader:
        with TorchLoader(reader, 4, device='cpu', prefetch=prefetch) as loader:
            next(loader)
            ballast = governor.register_pool('ballast', lambda: 2_000_000)
            assert governor.check() == STATE_BREACH
            with pytest.raises(HostMemoryExceededError) as raised:
                for _ in range(1000):
                    next(loader)
            assert raised.value.ranking[0]['pool'] == 'ballast'
            ballast.close()


def test_breach_raises_from_next_reader(url, governor):
    with make_tensor_reader(url, workers_count=1, num_epochs=None) as reader:
        next(reader)
        ballast = governor.register_pool('ballast', lambda: 2_000_000)
        governor.check()
        with pytest.raises(HostMemoryExceededError):
            for _ in range(1000):
                next(reader)
        ballast.close()


def test_shed_rung_paces_ventilation_and_keeps_the_stream(url, governor):
    def stream():
        with make_tensor_reader(url, workers_count=3, num_epochs=1, deterministic=True,
                                seed=3) as reader:
            return [_digest_array(np.asarray(c.id)) for c in reader]

    reference = stream()
    ballast = governor.register_pool('ballast', lambda: 930_000)
    with make_tensor_reader(url, workers_count=3, num_epochs=1, deterministic=True,
                            seed=3) as reader:
        pool = reader._pool
        assert governor.check() == STATE_SHED
        tight = pool.results_watermark
        assert tight == max(2, pool.results_capacity // 8)
        reader._shed_ventilation(True)          # a second fire changes nothing
        assert pool.results_watermark == tight
        pressured = [_digest_array(np.asarray(c.id)) for c in reader]
        ballast.close()
        assert governor.check() == STATE_OK
        assert pool.results_watermark is None   # the value before the episode
    assert pressured == reference


def test_degrade_rung_empties_the_memory_cache_and_sheds_lineage(url, governor, tmp_path):
    with make_tensor_reader(url, workers_count=1, num_epochs=2, cache_type='memory',
                            shuffle_row_groups=False) as reader:
        with TorchLoader(reader, 4, device='cpu', lineage=str(tmp_path / 'l')) as loader:
            ids = [int(i) for b in loader for i in b.id]
            tracker = loader.lineage_tracker
            assert reader.cache.nbytes > 0
            ballast = governor.register_pool('ballast', lambda: 880_000)
            assert governor.check() == STATE_DEGRADE
            for _ in range(8):
                governor.check()
            assert reader.cache.nbytes == 0
            assert tracker._pressure_shed
            ballast.close()
            governor.check()
            assert not tracker._pressure_shed
    assert sorted(ids) == sorted(list(range(ROWS)) * 2)
    actions = governor.stats()['degrade_actions']
    assert actions['degrade:memory-cache'] >= 1 and actions['degrade:lineage-queue'] >= 1
