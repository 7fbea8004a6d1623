"""The port's autotuner (``petastorm_tpu_torch.autotune``) and the knobs it
turns, against the JAX package's on the same inputs.

Parity: ``autotune_enabled``, ``env_interval``, ``resolve_config`` and
``AutotuneConfig`` over a table of values; ``classify_loader`` and
``classify_reader`` over seeded grids; both packages' ``AutoTuner`` driven
by the same simulated pipeline (``tests/test_autotune.py:133-175``) on a
synthetic clock give equal decision logs and trajectories in every scenario
of ``tests/test_autotune.py`` and the memory bias of
``tests/test_membudget.py:385``; ``stop()`` retires the gauges
(``tests/test_metrics.py:83-100``).

The knobs (after ``tests/test_autotune.py:363-784``,
``tests/test_decode_fastpath.py:272``, ``tests/test_chaos.py:1104`` and
``tests/test_chunk_store.py:720-750``): ``ThreadPool.resize`` under load,
``set_max_in_flight``, the reader's and the loader's knob sets, adoption,
starvation under a fault, the watchdog beside the tuner, the governor's
advisory rung, the chunk store's writer throttle, and a deterministic
stream that a tuner resizes mid-epoch, digest-equal to an untuned one and
to the JAX package's.
"""

import os
import random
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from petastorm_tpu import autotune as jat
from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu import make_tensor_reader as jax_make_tensor_reader
from petastorm_tpu.workers import EmptyResultError as JaxEmptyResultError
from petastorm_tpu.workers import WorkerBase as JaxWorkerBase
from petastorm_tpu.workers.thread_pool import ThreadPool as JaxThreadPool
from petastorm_tpu.workers.ventilator import ConcurrentVentilator as JaxVentilator
from petastorm_tpu_torch import (CompressedImageCodec, NdarrayCodec, ScalarCodec, TorchLoader,
                                 Unischema, UnischemaField, decode_budget, faults, make_batch_reader,
                                 make_reader, make_tensor_reader, membudget, metrics,
                                 write_dataset)
from petastorm_tpu_torch import autotune as pat
from petastorm_tpu_torch.lineage import _digest_array
from petastorm_tpu_torch.workers import EmptyResultError, WorkerBase
from petastorm_tpu_torch.workers import ventilator as ventilator_mod
from petastorm_tpu_torch.workers.thread_pool import ThreadPool
from petastorm_tpu_torch.workers.ventilator import ConcurrentVentilator

pytestmark = pytest.mark.autotune

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, PER_GROUP = 60, 10
# Quick pacing for tuners on real pipelines: a tick every 20 ms, one-tick
# hysteresis, no cooldown.
FAST = dict(interval_s=0.02, hysteresis=1, cooldown=0)


@pytest.fixture(autouse=True)
def _no_tuner_left():
    """Fails a test that leaves a ``pstt-autotune`` thread alive."""
    yield
    deadline = time.monotonic() + 2.0
    while True:
        alive = [t.name for t in threading.enumerate()
                 if t.name.startswith(pat.THREAD_NAME) and t.is_alive()]
        if not alive or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    assert not alive, 'autotune thread(s) left alive: {}'.format(alive)


@pytest.fixture(scope='module')
def url(tmp_path_factory):
    """PNG images (a decode share), ids and a small matrix; 6 row-groups."""
    schema = Unischema('TuneSchema', [
        UnischemaField('id', np.int64, (), ScalarCodec(np.int64), False),
        UnischemaField('image', np.uint8, (16, 16, 3), CompressedImageCodec('png'), False),
        UnischemaField('matrix', np.float32, (4, 5), NdarrayCodec(), False)])
    rng = np.random.default_rng(11)
    url = 'file://' + str(tmp_path_factory.mktemp('tune') / 'ds')
    write_dataset(url, schema, ({'id': i, 'image': rng.integers(0, 256, (16, 16, 3), np.uint8),
                                 'matrix': rng.random((4, 5), dtype=np.float32)}
                                for i in range(ROWS)), rows_per_row_group=PER_GROUP)
    return url


@pytest.fixture
def budgets():
    """A decode-thread budget of 8 in each package; the old ones come back."""
    from petastorm_tpu import decode_budget as jax_budget
    previous = (decode_budget.set_budget(decode_budget.DecodeThreadBudget(total=8)),
                jax_budget.set_budget(jax_budget.DecodeThreadBudget(total=8)))
    try:
        yield decode_budget.get_budget(), jax_budget.get_budget()
    finally:
        decode_budget.set_budget(previous[0])
        jax_budget.set_budget(previous[1])


# -- the switch and the config ------------------------------------------------

ENV_VALUES = ['', '0', 'off', 'OFF', 'false', 'no', '1', 'true', 'yes', 'on', '0.25', '2',
              '2.5', '1.0', '-1', '0.0', 'abc', ' 0.5 ']


@pytest.mark.parametrize('raw', ENV_VALUES)
def test_switch_and_interval_equal_jax(monkeypatch, raw):
    monkeypatch.setenv(jat.ENV_VAR, raw)
    monkeypatch.setenv(pat.ENV_VAR, raw)
    assert pat.autotune_enabled() == jat.autotune_enabled()
    assert pat.env_interval() == jat.env_interval()
    assert vars(pat.resolve_config()) == vars(jat.resolve_config())
    for explicit in (True, False):
        assert pat.autotune_enabled(explicit) == jat.autotune_enabled(explicit) == explicit
    assert pat.autotune_enabled(pat.AutotuneConfig()) is True
    config = pat.AutotuneConfig(interval_s=3.0)
    assert pat.resolve_config(config) is config


CONFIGS = [{}, {'interval_s': 0.25}, {'min_workers': 0, 'max_workers': 2},
           {'hysteresis': 0, 'cooldown': -3}, {'min_prefetch': 5, 'max_prefetch': 2},
           {'max_workers': 100}, {'min_arena_depth': 0, 'max_arena_depth': 1},
           {'min_watermark': 1}, {'min_decode_threads': 3, 'max_decode_threads': 1},
           {'min_device_stream_mb': -1, 'max_device_inflight': 0},
           {'throughput_tolerance': 1.0, 'log_size': 4},
           {'starve_frac': 0.2, 'signal_frac': 0.1, 'min_inflight': 3},
           {'interval_s': 0}, {'interval_s': -1}]


@pytest.mark.parametrize('kwargs', CONFIGS, ids=[str(i) for i in range(len(CONFIGS))])
def test_config_equals_jax(kwargs):
    try:
        want = vars(jat.AutotuneConfig(**kwargs))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            pat.AutotuneConfig(**kwargs)
        assert str(got.value) == str(e)
        return
    assert vars(pat.AutotuneConfig(**kwargs)) == want


# -- classification -----------------------------------------------------------

def _loader_case(rng):
    dt = float(rng.choice([0.02, 0.25, 0.5, 1.0, 2.0]))

    def wait():
        return 0.0 if rng.random() < 0.3 else float(rng.random() * dt)

    deltas = {k: wait() for k in ('wait_s', 'reader_wait_s', 'arena_wait_s', 'ready_wait_s')
              if rng.random() < 0.9}
    capacity = int(rng.integers(0, 9)) if rng.random() < 0.9 else None
    gauges = {'queue_capacity': capacity, 'queue_depth': int(rng.integers(0, (capacity or 1) + 1))}
    config = {'starve_frac': float(rng.choice([0.05, 0.1, 0.3])),
              'signal_frac': float(rng.choice([0.05, 0.02, 0.2]))}
    return deltas, gauges, dt, config


def _reader_case(rng):
    capacity = int(rng.choice([0, 1, 8, 50])) if rng.random() < 0.95 else None
    gauges = {'results_queue_capacity': capacity,
              'results_queue_depth': int(rng.integers(0, (capacity or 4) + 1)),
              'ventilated_unprocessed': int(rng.integers(0, 4))}
    return {}, gauges, 1.0, {}


@pytest.mark.parametrize('which, case, classes', [
    ('classify_loader', _loader_case, {pat.READER_STARVED, pat.ARENA_BOUND, pat.DISPATCH_BOUND,
                                       pat.CONSUMER_BOUND, pat.INPUT_BOUND, pat.BALANCED}),
    ('classify_reader', _reader_case, {pat.READER_STARVED, pat.CONSUMER_BOUND, pat.BALANCED})])
def test_classification_equals_jax_over_a_grid(which, case, classes):
    rng = np.random.default_rng(17)
    seen = set()
    for _ in range(2500):
        deltas, gauges, dt, config = case(rng)
        got = getattr(pat, which)(deltas, gauges, dt, pat.AutotuneConfig(**config))
        want = getattr(jat, which)(deltas, gauges, dt, jat.AutotuneConfig(**config))
        assert got == want, (deltas, gauges, dt, config)
        seen.add(got[0])
    assert seen == classes


# -- the control loop on a simulated pipeline ---------------------------------

class SimPipeline(object):
    """``tests/test_autotune.py:133-175``: a decode tier of ``workers *
    per_worker`` batches/s feeding a consumer that wants ``demand``."""

    def __init__(self, per_worker=2.0, demand=9.0, workers=1):
        self.per_worker = per_worker
        self.demand = demand
        self.workers = workers
        self.t = 0.0
        self.batches = 0.0
        self.wait_s = 0.0
        self.reader_wait_s = 0.0
        self.ready_wait_s = 0.0
        self.fill = 0.0

    def advance(self, dt=1.0):
        capacity = self.workers * self.per_worker
        self.batches += min(capacity, self.demand) * dt
        if capacity < self.demand:
            starved = 1.0 - capacity / self.demand
            self.wait_s += starved * dt
            self.reader_wait_s += starved * dt
            self.fill = 0.0
        else:
            self.fill = 1.0
        self.t += dt

    def telemetry(self):
        return {'batches': self.batches, 'wait_s': self.wait_s,
                'reader_wait_s': self.reader_wait_s, 'ready_wait_s': self.ready_wait_s,
                'queue_depth': self.fill * 4, 'queue_capacity': 4}

    def workers_knob(self, mod, lo=1, hi=16):
        return mod.Knob('workers', lambda: self.workers,
                        lambda n: setattr(self, 'workers', n), lo=lo, hi=hi)


def _box_knob(mod, name, box, lo, hi):
    return mod.Knob(name, lambda: box['value'], lambda n: box.__setitem__('value', n), lo, hi)


def _run(sim, tuner, ticks):
    for _ in range(ticks):
        sim.advance(1.0)
        tuner.tick(now=sim.t)


def _converge(mod):
    sim = SimPipeline(per_worker=2.0, demand=9.0, workers=1)
    tuner = mod.AutoTuner(sim.telemetry, {'workers': sim.workers_knob(mod)},
                          config=mod.AutotuneConfig(hysteresis=2, cooldown=1))
    _run(sim, tuner, 40)
    before = sim.batches
    _run(sim, tuner, 10)
    return tuner, {'steady_rate': (sim.batches - before) / 10.0, 'workers': sim.workers}


def _clamps(mod):
    sim = SimPipeline(per_worker=0.1, demand=100.0, workers=1)
    tuner = mod.AutoTuner(sim.telemetry, {'workers': sim.workers_knob(mod, lo=1, hi=3)},
                          config=mod.AutotuneConfig(hysteresis=1, cooldown=0,
                                                    throughput_tolerance=1.0))
    _run(sim, tuner, 30)
    return tuner, {'workers': sim.workers}


def _shift(mod):
    sim = SimPipeline(per_worker=2.0, demand=9.0, workers=1)
    inflight = {'value': 2}
    phase = {'dispatch': False}

    def telemetry():
        out = sim.telemetry()
        if phase['dispatch']:
            out['ready_wait_s'] = out.pop('reader_wait_s')
        return out

    tuner = mod.AutoTuner(telemetry, {'workers': sim.workers_knob(mod),
                                      'inflight': _box_knob(mod, 'inflight', inflight, 1, 8)},
                          config=mod.AutotuneConfig(hysteresis=2, cooldown=1,
                                                    throughput_tolerance=1.0))
    _run(sim, tuner, 20)
    workers_before_shift = sim.workers
    phase['dispatch'] = True
    _run(sim, tuner, 20)
    return tuner, {'workers': workers_before_shift, 'inflight': inflight['value']}


def _consumer_bound(mod):
    sim = SimPipeline(per_worker=5.0, demand=1.0, workers=8)
    watermark = {'value': 50}
    tuner = mod.AutoTuner(sim.telemetry, {
        'workers': sim.workers_knob(mod),
        'results_watermark': _box_knob(mod, 'results_watermark', watermark, 4, 50)},
        config=mod.AutotuneConfig(hysteresis=2, cooldown=1, throughput_tolerance=1.0))
    _run(sim, tuner, 30)
    return tuner, {'workers': sim.workers, 'watermark': watermark['value']}


def _above_range(mod):
    sim = SimPipeline(per_worker=5.0, demand=1.0, workers=16)
    tuner = mod.AutoTuner(sim.telemetry, {'workers': sim.workers_knob(mod, lo=1, hi=8)},
                          config=mod.AutotuneConfig(hysteresis=1, cooldown=0,
                                                    throughput_tolerance=1.0))
    _run(sim, tuner, 2)
    return tuner, {'workers': sim.workers}


def _revert(mod):
    state = {'workers': 1}
    clock = {'t': 0.0, 'batches': 0.0, 'wait': 0.0}

    def telemetry():
        # The rate collapses when workers leave 1 while starvation keeps
        # tempting the tuner to grow.
        clock['batches'] += 10.0 if state['workers'] == 1 else 2.0
        clock['wait'] += 0.5
        return {'batches': clock['batches'], 'wait_s': clock['wait'],
                'reader_wait_s': clock['wait'], 'queue_depth': 0, 'queue_capacity': 4}

    tuner = mod.AutoTuner(telemetry, {'workers': mod.Knob(
        'workers', lambda: state['workers'], lambda n: state.__setitem__('workers', n), 1, 8)},
        config=mod.AutotuneConfig(hysteresis=1, cooldown=1, throughput_tolerance=0.15))
    for _ in range(12):
        clock['t'] += 1.0
        tuner.tick(now=clock['t'])
    return tuner, {'workers': state['workers']}


def _watchdog_pause(mod):
    sim = SimPipeline(per_worker=0.5, demand=10.0, workers=1)
    active = {'value': True}
    tuner = mod.AutoTuner(sim.telemetry, {'workers': sim.workers_knob(mod)},
                          config=mod.AutotuneConfig(hysteresis=1, cooldown=0),
                          watchdog_active_fn=lambda: active['value'])
    _run(sim, tuner, 10)
    paused_workers = sim.workers
    active['value'] = False
    _run(sim, tuner, 10)
    return tuner, {'paused_workers': paused_workers, 'workers': sim.workers}


def _counter_reset(mod):
    sim = SimPipeline(per_worker=2.0, demand=9.0, workers=1)
    tuner = mod.AutoTuner(sim.telemetry, {'workers': sim.workers_knob(mod)},
                          config=mod.AutotuneConfig(hysteresis=1, cooldown=1,
                                                    throughput_tolerance=0.15))
    _run(sim, tuner, 2)
    pending = tuner._pending is not None
    sim.batches = sim.wait_s = sim.reader_wait_s = 0.0
    sim.advance(1.0)
    discarded = tuner.tick(now=sim.t)
    return tuner, {'pending': pending, 'discarded': discarded, 'workers': sim.workers}


def _mem_shrink(mod):
    # test_membudget.py:385's knobs, and a starved pipeline whose grows the
    # pressure must hold back.
    sim = SimPipeline(per_worker=0.5, demand=10.0, workers=4)
    prefetch = {'value': 6}
    level = {'n': 0}
    tuner = mod.AutoTuner(sim.telemetry, {'prefetch': _box_knob(mod, 'prefetch', prefetch, 1, 8),
                                          'workers': sim.workers_knob(mod, 1, 8)},
                          config=mod.AutotuneConfig(hysteresis=1, cooldown=0),
                          memory_state_fn=lambda: level['n'])
    _run(sim, tuner, 1)
    level['n'] = 1
    _run(sim, tuner, 12)
    floored = (prefetch['value'], sim.workers)
    during = [d['action'] for d in tuner.stats()['decisions']]
    level['n'] = 0
    _run(sim, tuner, 4)
    return tuner, {'floored': floored, 'during': during, 'workers': sim.workers}


SCENARIOS = {
    'converge': (_converge, lambda s, x: x['steady_rate'] >= 0.85 * 9.0 and any(
        d['class'] == pat.READER_STARVED for d in s['decisions'])),
    'clamps': (_clamps, lambda s, x: x['workers'] == 3
               and all(1 <= p['workers'] <= 3 for p in s['trajectory'])),
    'mid_run_shift': (_shift, lambda s, x: x['workers'] > 1 and x['inflight'] > 2
                      and {pat.READER_STARVED, pat.DISPATCH_BOUND}
                      <= {d['class'] for d in s['decisions']}),
    'consumer_bound_shrink': (_consumer_bound, lambda s, x: x['workers'] < 8
                              and x['watermark'] < 50 and any(
                                  d['action'] == 'shrink' for d in s['decisions'])),
    'shrink_from_above_range': (_above_range, lambda s, x: x['workers'] == 15),
    'revert_on_a_drop': (_revert, lambda s, x: s['reverts'] >= 1 and x['workers'] == 1),
    'watchdog_pause': (_watchdog_pause, lambda s, x: x['paused_workers'] == 1
                       and s['paused_ticks'] == 10 and x['workers'] > 1),
    'counter_reset': (_counter_reset, lambda s, x: x['pending'] and x['discarded'] is None
                      and s['reverts'] == 0 and x['workers'] == 2),
    'mem_shrink_bias': (_mem_shrink, lambda s, x: x['floored'] == (1, 1) and s['mem_shrinks'] >= 2
                        and set(x['during']) == {'mem-shrink'} and x['workers'] > 1),
}


@pytest.mark.parametrize('name', sorted(SCENARIOS))
def test_tuner_equals_jax_on_a_simulated_pipeline(name):
    scenario, holds = SCENARIOS[name]
    port_tuner, port_extra = scenario(pat)
    jax_tuner, jax_extra = scenario(jat)
    got, want = port_tuner.stats(), jax_tuner.stats()
    assert got == want
    assert port_extra == jax_extra
    assert holds(got, port_extra), (got, port_extra)


class BurstPipeline(object):
    """A consumer that takes its batches in bursts of ``burst`` (a scan
    trainer's superbatch), as many a second as ``per_worker`` workers
    supply, up to ``demand``: phase 26's telemetry on a synthetic clock.
    The reader's starvation accrues evenly; the batches land per burst.
    ``rates=(one, more)`` sets the supply instead: ``one`` with one worker,
    ``more`` with more. ``takes`` adds the loader's take marks
    (``take_batches``, ``take_t``: the count and the exact time at the end
    of the last burst), as ``TorchLoader.superbatches`` reports them."""

    def __init__(self, per_worker=4.0, demand=32.0, burst=8, workers=1, rates=None, takes=True):
        self.per_worker, self.demand, self.burst = per_worker, demand, burst
        self.workers, self.rates, self.takes = workers, rates, takes
        self.t = 0.0
        self.supplied = 0.0
        self.batches = 0.0
        self.wait_s = 0.0
        self.take_t = None

    def rate(self):
        if self.rates is not None:
            return self.rates[0] if self.workers == 1 else self.rates[1]
        return min(self.workers * self.per_worker, self.demand)

    def advance(self, dt):
        rate = self.rate()
        before = self.supplied
        self.supplied += rate * dt
        batches = self.burst * (self.supplied // self.burst)
        if batches > self.batches:
            self.take_t = self.t + (batches - before) / rate
            self.batches = batches
        self.wait_s += (1.0 - rate / self.demand) * dt
        self.t += dt

    def telemetry(self):
        out = {'batches': self.batches, 'wait_s': self.wait_s, 'reader_wait_s': self.wait_s,
               'ready_wait_s': 0.0, 'queue_depth': 0, 'queue_capacity': 4}
        if self.takes and self.take_t is not None:
            out.update(take_batches=self.batches, take_t=self.take_t)
        return out

    def workers_knob(self, mod):
        return mod.Knob('workers', lambda: self.workers,
                        lambda n: setattr(self, 'workers', n), lo=1, hi=8)


def _burst_run(mod, seconds=40.0, **kwargs):
    sim = BurstPipeline(**kwargs)
    tuner = mod.AutoTuner(sim.telemetry, {'workers': sim.workers_knob(mod)},
                          config=mod.AutotuneConfig(interval_s=0.25))
    for _ in range(int(seconds / 0.25)):
        sim.advance(0.25)
        tuner.tick(now=sim.t)
    return tuner.stats(), sim.workers


def test_the_tuner_equals_jax_on_bursty_telemetry():
    """Phase 26's telemetry: a consumer that takes 8 batches a burst, read
    on 0.25 s ticks, at a supply that no grow cuts. Counted on ticks alone
    (no take marks), the port's tuner decides as the JAX package's, the
    reverts the bursts' noise trips included. With the take marks the port
    judges on takes and keeps every grow over 40 s, while the JAX package's
    one-tick guard reverts: a difference by design (ROADMAP section C)."""
    got, got_workers = _burst_run(pat, takes=False)
    want, want_workers = _burst_run(jat, takes=False)
    assert got == want and got_workers == want_workers
    assert want['reverts'] > 0, 'the bursts must trip the one-tick guard'
    got, got_workers = _burst_run(pat)
    want, want_workers = _burst_run(jat)
    assert got['reverts'] == 0, got['decisions']
    assert got_workers == 8
    assert [d['action'] for d in got['decisions']] == ['grow'] * 7
    assert want['reverts'] > 0 and want_workers < 8


def test_a_grow_that_cuts_a_bursty_supply_is_reverted():
    """Bursts of 8 at 24 batches/s with one worker and 16.8 (30% less) with
    two: on takes the port reverts every grow past one worker; the JAX
    package's one-tick guard lets the first stand."""
    got, _ = _burst_run(pat, rates=(24.0, 16.8))
    actions = [d['action'] for d in got['decisions']]
    assert actions[:20] == ['grow', 'revert'] * 10, actions
    assert max(p['workers'] for p in got['trajectory']) == 2
    reverts = [d for d in got['decisions'] if d['action'] == 'revert']
    assert all(d['basis'] == 'takes' and d['rate'] < 0.85 * 24.0 for d in reverts)
    want, want_workers = _burst_run(jat, rates=(24.0, 16.8))
    assert want_workers > 1


def test_the_take_verdict_waits_for_a_take():
    """A grow judged on takes waits for a take a settling window after it;
    with none for ``TAKE_VERDICT_WAIT_WINDOWS`` windows, the delivered count
    since the action judges it (here none: the grow is reverted)."""
    state = {'workers': 1, 'batches': 0, 'take_t': None, 'wait_s': 0.0}

    def telemetry():
        return {'batches': state['batches'], 'wait_s': state['wait_s'],
                'reader_wait_s': state['wait_s'], 'queue_depth': 0, 'queue_capacity': 4,
                'take_batches': state['batches'], 'take_t': state['take_t']}

    config = pat.AutotuneConfig(interval_s=0.25, hysteresis=1, cooldown=2)
    tuner = pat.AutoTuner(telemetry, {'workers': pat.Knob(
        'workers', lambda: state['workers'], lambda n: state.__setitem__('workers', n), 1, 8)},
        config=config)

    def tick(t, take=False, starved=True):
        if starved:
            state['wait_s'] += 0.25       # the consumer waited the whole tick
        if take:
            state['batches'] += 8
            state['take_t'] = t
        return tuner.tick(now=t)

    for i in range(8):                    # fed: takes of 8 every 0.25 s, 32 batches/s
        assert tick(0.25 * i, take=True, starved=False) is None
    grow = tick(2.0, take=True)
    assert grow['action'] == 'grow' and state['workers'] == 2
    assert tuner._pending['base_rate'] == pytest.approx(32.0)
    windows = pat.TAKE_VERDICT_WAIT_WINDOWS * 2   # ticks (a window is 2 ticks)
    for i in range(1, windows):
        assert tick(2.0 + 0.25 * i) is None
    assert state['workers'] == 2, 'judged before the wait ran out'
    decision = tick(2.0 + 0.25 * windows)
    assert decision['action'] == 'revert' and state['workers'] == 1
    assert decision['rate'] == 0.0 and decision['basis'] == 'takes'


@pytest.mark.parametrize('label', [pat.READER_STARVED, pat.INPUT_BOUND, pat.DISPATCH_BOUND,
                                   pat.ARENA_BOUND, pat.CONSUMER_BOUND, pat.BALANCED])
def test_can_grow_says_whether_a_tick_of_the_class_would_grow(label):
    """``can_grow`` is True exactly when a tick of the class grows a knob:
    knobs below their clamps, then at them (phase 26 settles only on a
    class with nothing left to grow)."""
    boxes = {name: {'value': 1} for name in ('workers', 'decode_threads', 'results_watermark',
                                             'arena_pinned', 'inflight', 'prefetch',
                                             'arena_depth')}

    def tuner():
        return pat.AutoTuner(lambda: {}, {name: _box_knob(pat, name, box, 1, 4)
                                          for name, box in boxes.items()})

    grows = tuner()._grow(label) != []
    assert tuner().can_grow(label) is grows
    assert grows is (label not in (pat.CONSUMER_BOUND, pat.BALANCED))
    for box in boxes.values():
        box['value'] = 4
    probe = tuner()
    assert probe.can_grow(label) is False and probe._grow(label) == []
    probe.last_class = label
    assert probe.can_grow() is False


def test_the_loader_reports_its_takes(url):
    """Under ``superbatches(k)`` the loader's telemetry carries the count and
    the time at the end of the last take; iterated batch by batch, none."""
    with make_tensor_reader(url, schema_fields=['id', 'matrix'], workers_count=1, num_epochs=1,
                            shuffle_row_groups=False, autotune=False) as reader:
        with TorchLoader(reader, 5, device='cpu', autotune=False) as loader:
            next(iter(loader))
            assert 'take_t' not in loader._autotune_telemetry()
            before = time.monotonic()
            groups = loader.superbatches(3)
            next(groups)
            out = loader._autotune_telemetry()
            assert out['take_batches'] == 4 and before <= out['take_t'] <= time.monotonic()
            next(groups)
            assert loader._autotune_telemetry()['take_batches'] == 7
            loader.reset_stats()
            assert 'take_t' not in loader._autotune_telemetry()


def test_stop_retires_the_gauges_and_leaves_other_pipelines():
    registry = metrics.MetricsRegistry()
    previous = metrics.set_registry(registry)
    try:
        state = {'x': 2}

        def tuner():
            return pat.AutoTuner(lambda: {'batches': 0, 'wait_s': 0.0},
                                 {'workers': pat.Knob('workers', lambda: state['x'],
                                                      lambda n: state.update(x=n), 1, 8)},
                                 pat.AutotuneConfig(interval_s=60))

        a, b = tuner(), tuner()
        for t in (a, b):
            t.tick(now=0.0)
            t.tick(now=1.0)
        snap = registry.collect()
        pipelines = {s['labels']['pipeline'] for s in snap['pst_autotune_bottleneck']['samples']
                     if s['value'] == 1}
        assert pipelines == {a.pipeline_label, b.pipeline_label}
        assert pat.active_bottleneck_classes(snap) == {a.pipeline_label: pat.BALANCED,
                                                       b.pipeline_label: pat.BALANCED}
        a.stop()
        snap = registry.collect()
        assert {s['labels']['pipeline'] for s in snap['pst_autotune_bottleneck']['samples']} == \
            {b.pipeline_label}
        assert {s['labels']['pipeline'] for s in snap['pst_autotune_knob']['samples']} == \
            {b.pipeline_label}
        b.stop()
        snap = registry.collect()
        assert snap['pst_autotune_bottleneck']['samples'] == []
        assert snap['pst_autotune_knob']['samples'] == []
    finally:
        metrics.set_registry(previous)


def test_writer_throttle_listener_equals_jax():
    class Store(object):
        throttled = None

        def set_writer_throttled(self, value):
            self.throttled = value

    stores = Store(), Store()
    listeners = pat.writer_throttle_listener(stores[0]), jat.writer_throttle_listener(stores[1])
    assert pat.WRITER_THROTTLE_CLASSES == jat.WRITER_THROTTLE_CLASSES
    for label in (pat.DISPATCH_BOUND, pat.BALANCED, pat.READER_STARVED, pat.CONSUMER_BOUND,
                  pat.INPUT_BOUND, pat.ARENA_BOUND):
        for listener in listeners:
            listener(label, 'x')
        assert stores[0].throttled is stores[1].throttled is (label in pat.WRITER_THROTTLE_CLASSES)


def test_autotune_imports_no_torch():
    code = ('import sys; import petastorm_tpu_torch.autotune; '
            'assert "torch" not in sys.modules, sorted(m for m in sys.modules if "torch" in m)')
    subprocess.run([sys.executable, '-c', code], check=True, cwd=REPO,
                   env=dict(os.environ, PYTHONPATH=REPO))


# -- the thread pool's resize and the ventilator's cap ------------------------

class EchoWorker(WorkerBase):
    def process(self, value):
        self.publish_func({'value': value * 2})


class JaxEchoWorker(JaxWorkerBase):
    def process(self, value):
        self.publish_func([value * 2])


def _items(n):
    return [{'value': i} for i in range(n)]


def _drain(pool, on_result=None):
    results = []
    try:
        while True:
            result = pool.get_results()
            results.append(result['value'] if isinstance(result, dict) else result)
            if on_result is not None:
                on_result(len(results))
    except EmptyResultError:
        pass
    return results


def test_resize_refuses_zero_and_an_unstarted_pool():
    for pool in (ThreadPool(2), JaxThreadPool(2)):
        with pytest.raises(ValueError):
            pool.resize(0)
        with pytest.raises(RuntimeError, match='started'):
            pool.resize(4)


def test_resize_grows_and_shrinks_exactly_once_under_load():
    pool = ThreadPool(2)
    pool.start(EchoWorker, None, ConcurrentVentilator(None, _items(300),
                                                      max_ventilation_queue_size=20))

    def resize(n):
        if n == 61:
            assert pool.resize(6) == 6
            assert pool.diagnostics['live_worker_threads'] == 6
        if n == 181:
            assert pool.resize(1) == 1

    results = _drain(pool, resize)
    threads = pool._threads + pool._retired
    pool.stop()
    pool.join()
    assert not any(t.is_alive() for t in threads)
    assert len(threads) == 6 and pool.workers_count == 1
    jax_pool = JaxThreadPool(2)
    jax_pool.start(JaxEchoWorker, None, JaxVentilator(None, _items(300), iterations=1,
                                                      max_ventilation_queue_size=20))
    jax_results = []
    try:
        while True:
            jax_results.extend(jax_pool.get_results())
            if len(jax_results) == 61:
                jax_pool.resize(6)
            if len(jax_results) == 181:
                jax_pool.resize(1)
    except JaxEmptyResultError:
        pass
    jax_pool.stop()
    jax_pool.join()
    # Exactly once: every item processed once, none lost to a retiring
    # worker or repeated by a spawned one.
    assert sorted(results) == sorted(jax_results) == [i * 2 for i in range(300)]


def test_a_shrink_retires_live_threads_between_items():
    pool = ThreadPool(4)
    pool.start(EchoWorker, None, ConcurrentVentilator(None, _items(10), iterations=None,
                                                      max_ventilation_queue_size=4))
    pool.get_results()
    pool.resize(1)
    deadline = time.monotonic() + 5
    while pool.diagnostics['live_worker_threads'] != 1 and time.monotonic() < deadline:
        pool.get_results()
    assert pool.diagnostics['live_worker_threads'] == 1
    assert len(pool._retired) == 3
    pool.resize(3)          # spawns two, no retire pending
    assert pool.diagnostics['live_worker_threads'] == 3
    pool.stop()
    pool.join()
    assert pool._threads == [] and pool._retired == []


def test_a_grow_cancels_pending_retires_first():
    gate = threading.Event()

    class Held(WorkerBase):
        def process(self, value):
            gate.wait(10)
            self.publish_func({'value': value})

    pool = ThreadPool(4)
    pool.start(Held, None, ConcurrentVentilator(None, _items(8), max_ventilation_queue_size=8))
    pool.resize(1)          # three retires pending: every worker holds an item
    assert pool._retire_requests == 3
    pool.resize(3)          # cancels two of them, spawns none
    assert pool._retire_requests == 1 and pool._next_worker_id == 4
    gate.set()
    assert sorted(_drain(pool)) == list(range(8))
    pool.stop()
    pool.join()


def test_concurrent_resizes_are_safe():
    """Two threads resize at random while the pool runs, with a short
    switch interval: every item is still processed exactly once."""
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        pool = ThreadPool(2)
        pool.start(EchoWorker, None, ConcurrentVentilator(None, _items(400),
                                                          max_ventilation_queue_size=30))
        stop = threading.Event()

        def churn(seed):
            rng = random.Random(seed)
            while not stop.is_set():
                pool.resize(rng.randint(1, 6))
                time.sleep(0.002)

        churners = [threading.Thread(target=churn, args=(s,)) for s in (1, 2)]
        for t in churners:
            t.start()
        try:
            results = _drain(pool)
        finally:
            stop.set()
            for t in churners:
                t.join(timeout=10)
        # Idle workers take the pending retires; then the live threads are
        # the target exactly (a lost update to either count breaks it).
        deadline = time.monotonic() + 5
        while pool._retire_requests and time.monotonic() < deadline:
            time.sleep(0.01)
        live, target = len(pool._threads), pool.workers_count
        pool.stop()
        pool.join()
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in churners)
    assert sorted(results) == [i * 2 for i in range(400)]
    assert live == target


def test_a_grow_widens_the_ventilation_queue():
    """The queue is sized to the ventilator's cap at start (3 here); a grow
    to 2 workers widens it to 2 + 4 under its mutex, so a raised cap of 10
    holds 2 items in the workers and 6 queued (and one in the feeder's put)
    instead of stalling at 3 queued."""
    gate = threading.Event()

    class Held(WorkerBase):
        def process(self, value):
            gate.wait(10)
            self.publish_func({'value': value})

    ventilator = ConcurrentVentilator(None, _items(20), max_ventilation_queue_size=3)
    pool = ThreadPool(1)
    pool.start(Held, None, ventilator)
    assert pool._ventilator_queue.maxsize == 3
    pool.resize(2)
    ventilator.set_max_in_flight(10)
    assert pool._ventilator_queue.maxsize == 6
    deadline = time.monotonic() + 5
    while pool.diagnostics['ventilation_queue_size'] < 6 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert pool.diagnostics['ventilation_queue_size'] == 6
    assert pool.diagnostics['ventilated_unprocessed'] >= 8
    gate.set()
    assert sorted(_drain(pool)) == list(range(20))
    pool.stop()
    pool.join()


def test_set_max_in_flight_wakes_a_parked_feeder(monkeypatch):
    # A 30 s poll: only the wake-up can move the feeder within the test.
    monkeypatch.setattr(ventilator_mod, '_POLL_S', 30.0)
    fed, jax_fed = [], []
    port = ConcurrentVentilator(lambda **item: fed.append(item['value']), _items(6),
                                max_ventilation_queue_size=1)
    jax = JaxVentilator(lambda **item: jax_fed.append(item['value']), _items(6), iterations=1,
                        max_ventilation_queue_size=1, ventilation_interval=30.0)
    port.start()
    jax.start()
    try:
        deadline = time.monotonic() + 5
        while (len(fed), len(jax_fed)) != (1, 1) and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.1)
        assert (fed, jax_fed) == ([0], [0])          # parked at the cap
        port.set_max_in_flight(4)
        jax.set_max_in_flight(4)
        deadline = time.monotonic() + 5
        while (len(fed), len(jax_fed)) != (4, 4) and time.monotonic() < deadline:
            time.sleep(0.01)
        assert fed == jax_fed == [0, 1, 2, 3]
        assert port._max_in_flight == 4
    finally:
        port.stop()
        jax.stop()


# -- the reader's knobs --------------------------------------------------------

def test_workers_knob_rescales_the_decode_share(url, budgets):
    budget, jax_budget = budgets
    config = (pat.AutotuneConfig(max_workers=8), jat.AutotuneConfig(max_workers=8))
    with make_tensor_reader(url, workers_count=1, shuffle_row_groups=False) as reader, \
            jax_make_tensor_reader(url, workers_count=1, shuffle_row_groups=False) as jax_reader:
        knobs = reader._autotune_knobs(config[0])
        jax_knobs = jax_reader._autotune_knobs(config[1])
        assert budget.share() == jax_budget.share() == 8
        knobs['workers'].set(4)
        jax_knobs['workers'].set(4)
        assert reader._pool.workers_count == jax_reader._workers_pool.workers_count == 4
        assert budget.share() == jax_budget.share() == 2
        assert reader._ventilator._max_in_flight == \
            jax_reader._ventilator._max_ventilation_queue_size == 6
        assert reader.decoder['decode_threads'] == 2
        assert len(list(reader)) == len(list(jax_reader)) == ROWS // PER_GROUP


def test_decode_threads_knob_grows_first_when_input_bound(url, budgets):
    budget, jax_budget = budgets
    stats = []
    for mod, factory, bud in ((pat, make_tensor_reader, budget),
                              (jat, jax_make_tensor_reader, jax_budget)):
        with factory(url, workers_count=2, shuffle_row_groups=False) as reader:
            config = mod.AutotuneConfig(hysteresis=1, cooldown=0)
            knobs, _ = reader.adopt_autotune(config)
            tuner = mod.AutoTuner(telemetry_fn=lambda: {'batches': 0}, knobs=knobs,
                                  config=config,
                                  classify_fn=lambda *a: (mod.INPUT_BOUND, 'forced'))
            tuner.tick(now=0.0)
            decision = tuner.tick(now=1.0)
            assert decision['changes'] == [('decode_threads', 8, 10)] and bud.total == 10
            stats.append(tuner.stats())
            list(reader)
    assert stats[0] == stats[1]
    assert all('decode_threads' in point for point in stats[0]['trajectory'])


def test_the_watermark_knob_disarms_at_capacity(url):
    with make_tensor_reader(url, schema_fields=['id'], workers_count=1) as reader:
        knob = reader._autotune_knobs(pat.AutotuneConfig())['results_watermark']
        pool = reader._pool
        capacity = pool.results_capacity
        assert knob.get() == capacity and pool.results_watermark is None
        assert (knob.lo, knob.hi) == (4, capacity)
        knob.set(8)
        assert pool.results_watermark == 8
        knob.set(capacity)
        assert pool.results_watermark is None
        list(reader)


def test_the_shed_rung_restores_only_its_own_watermark(url):
    with make_tensor_reader(url, schema_fields=['id'], workers_count=1) as reader:
        pool = reader._pool
        knob = reader._autotune_knobs(pat.AutotuneConfig())['results_watermark']
        reader._shed_ventilation(True)
        tight = pool.results_watermark
        reader._shed_ventilation(False)
        assert pool.results_watermark is None           # ours: restored
        reader._shed_ventilation(True)
        knob.set(tight + 8)                             # the tuner's mem-shrink wrote it
        reader._shed_ventilation(False)
        assert pool.results_watermark == tight + 8      # not ours: kept
        list(reader)


READER_CASES = [
    ('tensor-thread', make_tensor_reader, jax_make_tensor_reader, {}),
    ('tensor-ids', make_tensor_reader, jax_make_tensor_reader, {'schema_fields': ['id']}),
    ('tensor-dummy', make_tensor_reader, jax_make_tensor_reader, {'reader_pool_type': 'dummy'}),
    ('tensor-process', make_tensor_reader, jax_make_tensor_reader,
     {'reader_pool_type': 'process', 'workers_count': 1}),
    ('row-thread', make_reader, jax_make_reader, {}),
    ('row-dummy', make_reader, jax_make_reader, {'reader_pool_type': 'dummy'}),
]


@pytest.mark.parametrize('name, factory, jax_factory, kwargs', READER_CASES,
                         ids=[c[0] for c in READER_CASES])
def test_each_readers_knob_set_equals_jax(url, budgets, name, factory, jax_factory, kwargs):
    """Same knobs and clamps; a process or dummy pool cannot resize and
    exposes none, so a reader of one arms no tuner."""
    kwargs = dict({'workers_count': 2, 'num_epochs': 1}, **kwargs)
    with factory(url, autotune=pat.AutotuneConfig(interval_s=60), **kwargs) as reader, \
            jax_factory(url, autotune=jat.AutotuneConfig(interval_s=60), **kwargs) as jax_reader:
        knobs = reader._autotune_knobs(pat.AutotuneConfig())
        jax_knobs = jax_reader._autotune_knobs(jat.AutotuneConfig())
        assert {n: (k.lo, k.hi, k.get()) for n, k in knobs.items()} == \
            {n: (k.lo, k.hi, k.get()) for n, k in jax_knobs.items()}
        assert (reader._autotuner is None) == (jax_reader._autotuner is None) == (not knobs)
        if knobs:
            assert 'autotune' in reader.diagnostics()
        assert len(list(reader)) == len(list(jax_reader))


def test_the_thread_clamps_follow_the_decoder(url, monkeypatch):
    """With the native codec the ``workers`` and ``decode_threads`` knobs
    take the JAX clamps (4x and 2x the cores); where OpenCV or PIL decodes,
    each holding the GIL between images, both stop at the host's cores. A
    reader that decodes no image keeps the JAX clamp."""
    from petastorm_tpu_torch import codecs
    from petastorm_tpu_torch.reader import host_cores
    config = pat.AutotuneConfig()
    cores = host_cores()

    def clamps(reader):
        knobs = reader._autotune_knobs(config)
        return {name: knobs[name].hi for name in ('workers', 'decode_threads') if name in knobs}

    with make_tensor_reader(url, workers_count=1) as reader:
        assert reader.decoder['image'] == 'native'
        assert clamps(reader) == {'workers': config.max_workers,
                                  'decode_threads': config.max_decode_threads}
        list(reader)
    monkeypatch.setattr(codecs, '_native_image', lambda: None)
    with make_tensor_reader(url, workers_count=1) as reader, \
            make_tensor_reader(url, schema_fields=['id'], workers_count=1) as ids:
        assert clamps(reader) == {'workers': min(config.max_workers, cores),
                                  'decode_threads': min(config.max_decode_threads, cores)}
        assert clamps(ids) == {'workers': config.max_workers}
        assert len(list(reader)) == len(list(ids)) == ROWS // PER_GROUP


def test_the_batch_reader_is_tuned_as_the_jax_package_tunes_it(tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq
    from petastorm_tpu import make_batch_reader as jax_make_batch_reader
    pq.write_table(pa.table({'id': list(range(40))}), str(tmp_path / 'p.parquet'),
                   row_group_size=8)
    store = 'file://' + str(tmp_path)
    with make_batch_reader(store, workers_count=2, autotune=pat.AutotuneConfig(**FAST)) as reader, \
            jax_make_batch_reader(store, workers_count=2,
                                  autotune=jat.AutotuneConfig(**FAST)) as jax_reader:
        assert sorted(reader._autotuner.knobs) == sorted(jax_reader._autotuner.knobs) == \
            ['results_watermark', 'workers']
        assert sum(len(c.id) for c in reader) == sum(len(c.id) for c in jax_reader) == 40


def test_pstt_autotune_arms_a_reader(url, monkeypatch):
    monkeypatch.setenv(pat.ENV_VAR, '0.05')
    with make_tensor_reader(url, workers_count=1) as reader:
        assert reader._autotuner.config.interval_s == 0.05
        assert reader._autotuner.alive
    with make_tensor_reader(url, workers_count=1, autotune=False) as reader:
        assert reader._autotuner is None and 'autotune' not in reader.diagnostics()


def test_a_reader_alone_tunes_itself(url):
    with make_tensor_reader(url, workers_count=1, num_epochs=3, schema_fields=['id', 'matrix'],
                            shuffle_row_groups=False,
                            autotune=pat.AutotuneConfig(**FAST)) as reader:
        rows = 0
        for chunk in reader:
            rows += len(chunk.id)
            time.sleep(0.005)
        at = reader.diagnostics()['autotune']
    assert rows == 3 * ROWS
    # No image field in the view: no decode share, so no decode_threads knob.
    assert set(at['knobs']) == {'workers', 'results_watermark'}
    assert at['ticks'] >= 1


# -- the loader ---------------------------------------------------------------

def test_the_loaders_knob_set_equals_jaxs_single_device_set(url):
    from petastorm_tpu.jax_loader import JaxLoader
    sets = {}
    for prefetch in (0, 2):
        with make_tensor_reader(url, workers_count=1) as reader, \
                jax_make_tensor_reader(url, workers_count=1) as jax_reader:
            with TorchLoader(reader, 8, device='cpu', prefetch=prefetch,
                             autotune=pat.AutotuneConfig(interval_s=60)) as loader, \
                    JaxLoader(jax_reader, 8, prefetch=prefetch,
                              autotune=jat.AutotuneConfig(interval_s=60)) as jax_loader:
                knobs = {n: (k.lo, k.hi) for n, k in loader._autotuner.knobs.items()}
                jax_knobs = {n: (k.lo, k.hi) for n, k in jax_loader._autotuner.knobs.items()}
                # The host cannot pin memory without CUDA: the port's
                # arena_pinned stays at 0 on the CPU.
                if 'arena_pinned' in knobs:
                    assert knobs.pop('arena_pinned') == (0, 0)
                    assert jax_knobs.pop('arena_pinned') == (0, 1)
                assert knobs == jax_knobs
                sets[prefetch] = set(loader._autotuner.knobs)
    assert sets[0] == {'workers', 'decode_threads', 'results_watermark'}
    assert sets[2] == sets[0] | {'prefetch', 'inflight', 'arena_depth', 'arena_pinned'}


def test_the_per_device_knobs_are_absent_by_design(url):
    """``device_inflight`` and ``device_stream_min_mb`` turn the JAX
    loader's per-device stager: one copy stream and window a device of a
    mesh, which exists only where one process drives several devices. The
    port runs one process a GPU, whose batch goes to its one device in one
    copy, so it has no stager and neither knob, on a mesh or not."""
    from petastorm_tpu.jax_loader import JaxLoader
    from petastorm_tpu.parallel import make_mesh
    with jax_make_tensor_reader(url, workers_count=1, schema_fields=['id', 'matrix']) as jax_reader:
        with JaxLoader(jax_reader, 16, mesh=make_mesh({'data': 8}),
                       autotune=jat.AutotuneConfig(interval_s=60)) as jax_loader:
            assert 'device_inflight' in jax_loader._autotuner.knobs
            assert jax_loader._stager is not None
    with make_tensor_reader(url, workers_count=1) as reader:
        with TorchLoader(reader, 16, device='cpu', autotune=pat.AutotuneConfig(interval_s=60)) \
                as loader:
            assert not {'device_inflight', 'device_stream_min_mb'} & set(loader._autotuner.knobs)
            assert not hasattr(loader, '_stager')
    assert 'device_inflight' in dict(pat._GROW_ACTIONS[pat.DISPATCH_BOUND])


def test_the_loader_adopts_the_readers_controller(url):
    with make_tensor_reader(url, workers_count=1, autotune=pat.AutotuneConfig(**FAST)) as reader:
        own = reader._autotuner
        assert own is not None and own.alive
        with TorchLoader(reader, 8, device='cpu', autotune=pat.AutotuneConfig(**FAST)) as loader:
            assert reader._autotuner is None and not own.alive
            assert loader._autotuner is not None and 'workers' in loader._autotuner.knobs
            batches = sum(1 for _ in loader)
            stats = loader.stats
    assert batches == ROWS // 8
    assert stats['autotune']['ticks'] >= 0 and 'autotune' not in reader.diagnostics()


def test_the_loaders_knobs_turn_its_stages(url):
    with make_tensor_reader(url, workers_count=1, num_epochs=None) as reader:
        with TorchLoader(reader, 8, device='cpu', prefetch=1, inflight=1, arena_depth=2,
                         autotune=pat.AutotuneConfig(interval_s=60)) as loader:
            knobs = loader._autotuner.knobs
            next(loader)
            knobs['prefetch'].set(3)
            assert loader._queue.maxsize == 3 and knobs['prefetch'].get() == 3
            knobs['inflight'].set(4)
            assert loader._engine.inflight_window == 4
            knobs['arena_depth'].set(6)
            assert loader._pool.depth == 6
            knobs['arena_depth'].set(3)
            assert loader._pool.depth == 3
            for _ in range(6):
                next(loader)
            telemetry = loader._autotune_telemetry()
            assert telemetry['batches'] == 7 and telemetry['queue_capacity'] == 3
            assert {'reader_wait_s', 'arena_wait_s', 'ready_wait_s', 'results_queue_depth',
                    'ventilated_unprocessed'} <= set(telemetry)


def test_a_timed_out_grow_does_not_undo_the_tuners_depth():
    """An exhausted pool grows past its depth after ``_GROW_TIMEOUT_S``; the
    arenas so grown are kept apart, so the knob reads what it set and a
    shrink below them is honoured. The depth never goes below what
    ``ensure_depth`` asked for."""
    from petastorm_tpu_torch.staging import ArenaPool
    pool = ArenaPool(2, threading.Event(), pinned=False)
    spec = {'x': ((4,), np.dtype('float32'))}
    arenas = []
    for _ in range(3):               # the third waits out the grow timeout
        pool.get_buffers(spec)
        arenas.append(pool.claim_pending())
    assert pool.depth == 2 and pool.stats()['arena_grown'] == 1
    for arena in arenas:
        arena.retire()
    assert pool.stats()['arena_allocated'] == 3      # the grown arena is kept free
    pool.set_depth(1)
    assert pool.depth == 1 and pool.stats()['arena_allocated'] == 1
    pool.ensure_depth(4)
    pool.set_depth(2)
    assert pool.depth == pool.floor == 4
    assert pool.wait_seconds > 0.4


def test_inline_staging_carries_the_stage_split(url):
    """``prefetch=0``: the consumer's own reader pull and copy issue ride the
    telemetry, so a slow tick does not read as input-bound."""
    with make_tensor_reader(url, schema_fields=['id', 'matrix'], workers_count=1,
                            num_epochs=2, shuffle_row_groups=False) as reader:
        with TorchLoader(reader, 8, device='cpu', prefetch=0,
                         autotune=pat.AutotuneConfig(**FAST)) as loader:
            for _ in loader:
                time.sleep(0.003)
            telemetry = loader._autotune_telemetry()
            knobs = set(loader._autotuner.knobs)
    assert telemetry['reader_wait_s'] > 0 and telemetry['ready_wait_s'] > 0
    assert 'prefetch' not in knobs and 'inflight' not in knobs and 'workers' in knobs


@pytest.mark.chaos
def test_fs_read_delay_starvation_grows_workers(url, monkeypatch):
    """``tests/test_chaos.py``'s starvation: a 30 ms read delay starves a
    one-worker reader, and the loader's tuner grows ``workers``, in both
    packages."""
    from petastorm_tpu import faults as jax_faults
    from petastorm_tpu.jax_loader import JaxLoader
    monkeypatch.setenv(faults.ENV_VAR, 'fs-read-delay:delay=0.03')
    monkeypatch.setenv(jax_faults.ENV_VAR, 'fs-read-delay:delay=0.03')
    grown = []
    for mod, factory, make_loader in (
            (pat, make_tensor_reader,
             lambda r, c: TorchLoader(r, 8, device='cpu', prefetch=1, autotune=c)),
            (jat, jax_make_tensor_reader, lambda r, c: JaxLoader(r, 8, prefetch=1, autotune=c))):
        config = mod.AutotuneConfig(throughput_tolerance=1.0, **FAST)
        with factory(url, schema_fields=['id', 'matrix'], workers_count=1, num_epochs=6,
                     shuffle_row_groups=False) as reader:
            with make_loader(reader, config) as loader:
                for _ in loader:
                    pass
                at = loader.stats['autotune']
        assert any(d['action'] == 'grow' and d['class'] in (mod.READER_STARVED, mod.INPUT_BOUND)
                   for d in at['decisions']), at['decisions']
        grown.append(at['knobs']['workers'])
    assert min(grown) > 1


def test_the_watchdog_and_the_tuner_coexist(url):
    with make_tensor_reader(url, workers_count=2, num_epochs=2) as reader:
        with TorchLoader(reader, 8, device='cpu', watchdog=True, stall_timeout_s=30,
                         autotune=pat.AutotuneConfig(**FAST)) as loader:
            dog = loader._health.watchdog
            assert loader._autotuner._watchdog_active_fn() is dog.episode_active is False
            for _ in loader:
                time.sleep(0.002)
            stats = loader.stats
            tuner, supervisor = loader._autotuner, loader._supervisor
        assert not tuner.alive and supervisor.autotuner is None and not dog.alive
    assert stats['watchdog']['hard_stalls'] == 0 and stats['autotune']['paused_ticks'] == 0


@pytest.fixture
def governor(monkeypatch, tmp_path):
    """A fresh governor (1 MB budget) armed without its sampler."""
    monkeypatch.delenv(membudget.ENV_VAR, raising=False)
    monkeypatch.setenv('PSTT_FLIGHT_RECORDER', str(tmp_path / 'flight'))
    gov = membudget.MemoryGovernor(budget=1_000_000, config=membudget.GovernorConfig())
    previous = membudget.set_governor(gov)
    gov._arm_count += 1
    try:
        yield gov
    finally:
        while gov._arm_count > 0:
            gov.release()
        membudget.set_governor(previous)


def test_an_advisory_governor_shrinks_and_never_grows(url, governor, monkeypatch):
    """A starved pipeline (one worker, a read delay) under a ballast that
    holds the ladder at advisory: the tuner takes ``mem-shrink`` steps and
    no ``grow`` until the ballast goes."""
    monkeypatch.setenv(faults.ENV_VAR, 'fs-read-delay:delay=0.03')
    ballast = {'bytes': 750_000}
    handle = governor.register_pool('ballast', lambda: ballast['bytes'])
    try:
        governor.check()
        assert governor.pressure_level() == 1
        with make_tensor_reader(url, schema_fields=['id', 'matrix'], workers_count=3,
                                num_epochs=None) as reader:
            with TorchLoader(reader, 8, device='cpu', prefetch=4, inflight=3,
                             autotune=pat.AutotuneConfig(**FAST)) as loader:
                start = dict(loader._autotuner.stats()['knobs'])
                deadline = time.monotonic() + 20
                while time.monotonic() < deadline:
                    next(loader)
                    at = loader._autotuner.stats()
                    if at['mem_shrinks'] >= 2:
                        break
                under_pressure = loader._autotuner.stats()
                ballast['bytes'] = 0
                governor.check()
                assert governor.pressure_level() == 0
                deadline = time.monotonic() + 20
                while time.monotonic() < deadline:
                    next(loader)
                    if any(d['action'] == 'grow' for d in loader._autotuner.stats()['decisions']):
                        break
                after = loader._autotuner.stats()
    finally:
        handle.close()
    assert under_pressure['mem_shrinks'] >= 2
    assert all(d['action'] in ('mem-shrink', 'paused') for d in under_pressure['decisions'])
    knobs = under_pressure['knobs']
    assert knobs['workers'] < start['workers'] and knobs['prefetch'] < start['prefetch']
    assert any(d['action'] == 'grow' for d in after['decisions'])


def test_the_listener_throttles_the_chunk_stores_writer(url, tmp_path):
    with make_tensor_reader(url, workers_count=1, cache_type='chunk-store',
                            cache_location=str(tmp_path / 'store'),
                            autotune=pat.AutotuneConfig(interval_s=60)) as reader:
        tuner, store = reader._autotuner, reader.chunk_store
        label = {'value': pat.READER_STARVED}
        tuner._classify_fn = lambda *args: (label['value'], 'forced')
        tuner.tick(now=0.0)
        assert store.writer_throttled is False       # the baseline tick classifies nothing
        tuner.tick(now=1.0)
        assert store.writer_throttled is True
        label['value'] = pat.BALANCED
        tuner.tick(now=2.0)
        assert store.writer_throttled is False
        with TorchLoader(reader, 8, device='cpu', autotune=pat.AutotuneConfig(interval_s=60)) \
                as loader:
            tuner = loader._autotuner
            tuner._classify_fn = lambda *args: (pat.DISPATCH_BOUND, 'forced')
            tuner.tick(now=0.0)
            tuner.tick(now=1.0)
            assert store.writer_throttled is True
            assert sum(1 for _ in loader) == ROWS // 8


# -- determinism across a resize ----------------------------------------------

DET = dict(schema_fields=['id', 'image', 'matrix'], deterministic=True, seed=7, num_epochs=2,
           workers_count=2)


def _chunk_digests(reader, during=None):
    out = []
    with reader:
        for i, chunk in enumerate(reader):
            out.append({k: _digest_array(v) for k, v in chunk._asdict().items()})
            if during is not None:
                during(i, reader)
    return out


def test_a_deterministic_stream_resized_mid_epoch_equals_an_untuned_one_and_jaxs(url, budgets):
    """The tuner grows ``workers`` twice and shrinks it twice within the
    first epoch (its classification scripted, its ticks driven by hand);
    the stream is digest-equal to an untuned reader's and to the JAX
    package's."""
    script = {1: pat.READER_STARVED, 2: pat.READER_STARVED, 4: pat.CONSUMER_BOUND,
              5: pat.CONSUMER_BOUND}
    seen = []

    def during(i, reader):
        tuner = reader._autotuner
        if i == 0:
            tuner.tick(now=0.0)          # the baseline sample
        if i in script:
            tuner._classify_fn = lambda *args, label=script[i]: (label, 'scripted')
            tuner.tick(now=float(i))
            seen.append(reader._pool.workers_count)

    config = pat.AutotuneConfig(interval_s=3600, hysteresis=1, cooldown=0,
                                throughput_tolerance=1.0)
    tuned = _chunk_digests(make_tensor_reader(url, autotune=config, **DET), during)
    untuned = _chunk_digests(make_tensor_reader(url, autotune=False, **DET))
    jax_stream = _chunk_digests(jax_make_tensor_reader(url, **DET))
    assert seen == [3, 4, 3, 2]
    assert len(tuned) == 2 * ROWS // PER_GROUP
    assert tuned == untuned == jax_stream


# -- phase 26 of chip_smoke.py on the CPU ---------------------------------------

def test_autotune_cell_glue_on_the_cpu(tmp_path, monkeypatch):
    """``bench.run_imagenet_autotune`` (phase 26 of ``chip_smoke.py``) at a
    small size on the CPU: the scan window and the timed calls replaced by
    host versions over the same reader and loader, the step by a stand-in
    that takes 20 ms, the tick by 0.1 s, and, so that the host's load cannot
    move the outcome, the classification scripted (six ``reader-starved``
    ticks, then ``balanced``) and the throughput guard off. Every check of
    the cell runs on the real knobs: the grows from one worker, the ratio,
    the finite losses, nothing left after close, and (b)'s mem-shrink
    without a grow at advisory."""
    import torch
    from petastorm_tpu_torch import bench
    from petastorm_tpu_torch import models as models_mod

    schema = Unischema('AutotuneCell', [
        UnischemaField('image', np.uint8, (16, 16, 3), CompressedImageCodec('png'), False),
        UnischemaField('label', np.int64, (), ScalarCodec(np.int64), False)])
    rng = np.random.default_rng(26)
    store = 'file://' + str(tmp_path / 'images')
    write_dataset(store, schema, ({'image': rng.integers(0, 256, (16, 16, 3), dtype=np.uint8),
                                   'label': i % 10} for i in range(256)), rows_per_row_group=32)

    def step(state, x, y):
        time.sleep(0.02)
        return {'loss': torch.ones(()), 'last_loss': torch.ones(())}

    def scan_window(train, state, next_inputs, warmup, calls, kernels, profile=True, until=None):
        metrics_ = [train(state, *next_inputs()) for _ in range(warmup)]
        while until is not None and not until():
            metrics_.append(train(state, *next_inputs()))
        metrics_ += [train(state, *next_inputs()) for _ in range(calls)]
        return metrics_, {}, {}, {'normalize_kernel': 0}, None, 0

    def time_scan_calls(train, state, next_inputs, calls):
        out, wait_s, t0 = [], 0.0, time.perf_counter()
        for _ in range(calls):
            t1 = time.perf_counter()
            inputs = next_inputs()
            wait_s += time.perf_counter() - t1
            out.append(train(state, *inputs))
        return time.perf_counter() - t0, wait_s, 20.0, out

    classified = []

    def scripted(deltas, gauges, dt, config):
        classified.append(dt)
        return (pat.READER_STARVED if len(classified) <= 6 else pat.BALANCED), 'scripted'

    class Config(pat.AutotuneConfig):
        def __init__(self, **kwargs):
            super().__init__(throughput_tolerance=1.0, **kwargs)

    monkeypatch.setattr(pat, 'classify_loader', scripted)
    monkeypatch.setattr(pat, 'AutotuneConfig', Config)
    monkeypatch.setattr(bench, 'scan_window', scan_window)
    monkeypatch.setattr(bench, 'time_scan_calls', time_scan_calls)
    monkeypatch.setattr(bench, 'require_scan_launches', lambda *args: None)
    monkeypatch.setattr(bench, 'graph_launches',
                        lambda train, kernels, replays: dict.fromkeys(kernels, 0))
    monkeypatch.setattr(models_mod, 'make_scan_train_step', lambda k, preprocess=None: step)
    for name in ('reset_peak_memory_stats', 'empty_cache'):
        monkeypatch.setattr(torch.cuda, name, lambda *args, **kwargs: None)
    monkeypatch.setattr(torch.cuda, 'max_memory_allocated', lambda *args: 0)
    monkeypatch.setattr(bench, 'BATCH', 8)
    monkeypatch.setattr(bench, 'SCAN_K', 2)
    monkeypatch.setattr(bench, 'AUTOTUNE_INTERVAL_S', 0.1)
    monkeypatch.setattr(bench, 'AUTOTUNE_CONVERGE_S', 20.0)
    monkeypatch.setattr(bench, 'AUTOTUNE_MEM_CALLS', 20)
    budget = decode_budget.get_budget()
    line = bench.run_imagenet_autotune(store, torch.device('cpu'), 'cpu', None, decode_rate=1.0,
                                       warmup=2, calls=3)
    assert decode_budget.get_budget() is budget
    a, b = line['convergence'], line['memory_bias']
    assert line['phase'] == 'imagenet_autotune' and a['final_knobs']['workers'] == 3
    assert a['start_knobs']['workers'] == 1 and a['start_knobs']['decode_threads'] == 1
    assert a['decisions_by_action'] == {'grow': 2} and a['seconds_to_last_grow'] > 0
    assert [w for _, w, _ in a['workers_decode_threads']] == [1, 2, 3]
    assert a['left_after_close'] == {'threads': [], 'gauges': []}
    assert a['settle_s'] <= a['window_s']
    assert a['settled_on'] == 'ticks' and a['knobs_at_window']['workers'] == 3
    assert a['reverts_after_last_grow'] == 0 and a['changes_after_settle'] == []
    assert b['mem_shrinks'] >= 1 and set(b['decisions_by_action']) == {'mem-shrink'}
    assert b['pressure_level'] == 1 and b['mem_state'] == 'advisory'
