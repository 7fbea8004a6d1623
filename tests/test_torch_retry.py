"""Retry policy and circuit breakers: the port's ``retry`` module against the
JAX package's on the same seeds, schedules and clocks (the cases of
``tests/test_chaos.py:301-460, 886-916``)."""

import random

import fsspec
import pytest

from petastorm_tpu import faults as jax_faults
from petastorm_tpu import retry as jax_retry
from petastorm_tpu.fs import RetryingFilesystemWrapper as JaxRetryingFs
from petastorm_tpu.hdfs import HANamenodeFilesystem as JaxHA
from petastorm_tpu_torch import faults, retry
from petastorm_tpu_torch.fs import RetryingFilesystemWrapper
from petastorm_tpu_torch.hdfs import HANamenodeFilesystem

PACKAGES = {'jax': (jax_retry, jax_faults, JaxRetryingFs, JaxHA),
            'port': (retry, faults, RetryingFilesystemWrapper, HANamenodeFilesystem)}


@pytest.mark.parametrize('seed', [0, 1, 7, 12345])
@pytest.mark.parametrize('jitter', ['full', 'none'])
def test_seeded_delays_equal_the_jax_packages(seed, jitter):
    delays = {}
    for name, (mod, _, _, _) in PACKAGES.items():
        policy = mod.RetryPolicy(max_attempts=8, base_delay_s=0.1, max_delay_s=1.5,
                                 jitter=jitter, rng=random.Random(seed), sleep=lambda s: None)
        delays[name] = [policy.compute_delay(a) for a in range(7)]
    assert delays['port'] == delays['jax']
    for attempt, delay in enumerate(delays['port']):
        assert 0.0 <= delay <= min(1.5, 0.1 * 2 ** attempt)


def _run_policy(mod, outcomes, **kwargs):
    """A call that fails with ``outcomes`` in turn, under a seeded policy:
    (result or exception type, hook events, sleeps)."""
    events, sleeps, state = [], [], {'i': 0}

    def flaky():
        outcome = outcomes[min(state['i'], len(outcomes) - 1)]
        state['i'] += 1
        if isinstance(outcome, BaseException):
            raise outcome
        return outcome

    policy = mod.RetryPolicy(rng=random.Random(3), sleep=sleeps.append,
                             on_retry=lambda n, a, e, d: events.append((n, a, type(e), d)),
                             **kwargs)
    try:
        result = policy.call(flaky, retry_call_name='unit')
    except Exception as e:  # noqa: BLE001 - the outcome compared
        result = type(e).__name__
    return result, events, sleeps, state['i']


@pytest.mark.parametrize('case', [
    ([IOError('a'), OSError('b'), 'ok'], {'max_attempts': 4}),
    ([IOError('a')] * 5, {'max_attempts': 3}),
    ([ValueError('not transient'), 'ok'], {'max_attempts': 5}),
    ([IOError('a')] * 100, {'max_attempts': 100, 'base_delay_s': 50.0, 'jitter': 'none',
                            'deadline_s': 0.5}),
    (['ok'], {'max_attempts': 1}),
], ids=['recovers', 'exhausted', 'not-retried', 'deadline', 'first-try'])
def test_policy_calls_equal_the_jax_packages(case):
    outcomes, kwargs = case
    port = _run_policy(retry, outcomes, **kwargs)
    jax = _run_policy(jax_retry, outcomes, **kwargs)
    assert port == jax
    if kwargs.get('deadline_s'):
        assert port[0] == 'RetryDeadlineExceeded'


def test_policy_refuses_what_the_jax_package_refuses():
    for mod in (retry, jax_retry):
        with pytest.raises(ValueError):
            mod.RetryPolicy(max_attempts=0)
        with pytest.raises(ValueError):
            mod.RetryPolicy(jitter='half')
        with pytest.raises(ValueError):
            mod.CircuitBreaker(failure_threshold=0)


def test_retry_counters_and_metric_accumulate(monkeypatch):
    from petastorm_tpu_torch import metrics
    monkeypatch.setattr(retry, '_retry_counters', {})
    registry = metrics.MetricsRegistry()
    previous = metrics.set_registry(registry)
    try:
        assert _run_policy(retry, [IOError('a'), IOError('b'), 'ok'], max_attempts=3)[0] == 'ok'
    finally:
        metrics.set_registry(previous)
    assert retry.retry_counters()['unit'] == 2
    sample = registry.collect()['pst_retries_total']['samples']
    assert sample == [{'labels': {'op': 'unit'}, 'value': 2}]
    retry.reset_retry_counters()
    assert retry.retry_counters() == {}


def _breaker_trace(mod):
    clock = [0.0]
    breaker = mod.CircuitBreaker(failure_threshold=2, reset_timeout_s=10.0,
                                 clock=lambda: clock[0])
    trace = [breaker.state, breaker.allow()]
    breaker.record_failure()
    trace.append(breaker.state)
    breaker.record_success()
    breaker.record_failure()
    trace.append(breaker.state)
    breaker.record_failure()
    trace += [breaker.state, breaker.allow()]
    with pytest.raises(mod.CircuitOpenError):
        breaker.call(lambda: 'nope')
    clock[0] = 10.5
    trace += [breaker.state, breaker.allow(), breaker.allow()]
    breaker.record_failure()
    trace += [breaker.state, breaker.opens]
    clock[0] = 21.0
    trace.append(breaker.allow())
    breaker.record_success()
    trace += [breaker.state, breaker.allow(), breaker.call(lambda: 42)]
    with pytest.raises(RuntimeError):
        breaker.call(lambda: (_ for _ in ()).throw(RuntimeError('x')))
    trace.append(breaker.state)
    return trace


def test_breaker_transitions_equal_the_jax_packages():
    trace = _breaker_trace(retry)
    assert trace == _breaker_trace(jax_retry)
    assert trace[:9] == ['closed', True, 'closed', 'closed', 'open', False, 'half-open', True,
                         False]


def test_breaker_set_equals_the_jax_packages():
    out = {}
    for name, (mod, _, _, _) in PACKAGES.items():
        clock = [0.0]
        breakers = mod.BreakerSet(failure_threshold=1, reset_timeout_s=5.0,
                                  clock=lambda: clock[0])
        breakers.get('a').record_failure()
        breakers.get('b').record_success()
        seen = [sorted(breakers.keys()), breakers.states(), breakers.open_count(),
                'a' in breakers, len(breakers)]
        clock[0] = 6.0
        seen.append(breakers.states())
        breakers.discard('a')
        seen += ['a' in breakers, len(breakers)]
        out[name] = seen
    assert out['port'] == out['jax']
    assert out['port'][1] == {'a': 'open', 'b': 'closed'}


@pytest.mark.parametrize('package', ['jax', 'port'])
def test_fs_retry_backs_off_with_jitter_under_injection(tmp_path, monkeypatch, package):
    mod, fault_mod, wrapper, _ = PACKAGES[package]
    (tmp_path / 'probe.txt').write_text('x')
    monkeypatch.setenv(fault_mod.ENV_VAR, 'fs-read-error:max=2')
    events, sleeps = [], []
    policy = mod.RetryPolicy(max_attempts=4, base_delay_s=0.05, max_delay_s=0.2,
                             rng=random.Random(5),
                             on_retry=lambda name, attempt, exc, delay:
                             events.append((name, attempt, delay)),
                             sleep=sleeps.append)
    fs = wrapper(fsspec.filesystem('file'), retry_policy=policy)
    assert fs.exists(str(tmp_path / 'probe.txt'))
    assert [(name, attempt) for name, attempt, _ in events] == [('exists', 0), ('exists', 1)]
    assert sleeps == [delay for _, _, delay in events]


def test_fs_retry_schedules_equal_across_packages(tmp_path, monkeypatch):
    """The same spec and seed give the same retry schedule in both wrappers."""
    (tmp_path / 'probe.txt').write_text('x')
    schedules = {}
    for name, (mod, fault_mod, wrapper, _) in PACKAGES.items():
        monkeypatch.setenv(fault_mod.ENV_VAR, 'fs-read-error:max=3')
        events = []
        policy = mod.RetryPolicy(max_attempts=5, base_delay_s=0.05, max_delay_s=0.4,
                                 rng=random.Random(9), sleep=lambda s: None,
                                 on_retry=lambda n, a, e, d: events.append((n, a, d)))
        fs = wrapper(fsspec.filesystem('file'), retry_policy=policy)
        assert fs.exists(str(tmp_path / 'probe.txt'))
        schedules[name] = events
        monkeypatch.delenv(fault_mod.ENV_VAR)
    assert schedules['port'] == schedules['jax'] and len(schedules['port']) == 3


def test_hdfs_failover_backs_off_through_retry_policy():
    from test_torch_hdfs import _MockConnector

    class RecordingHA(HANamenodeFilesystem):
        def __init__(self, *args, **kwargs):
            self.retry_events = []
            super(RecordingHA, self).__init__(*args, **kwargs)

        def _failover_policy(self, on_retry):
            policy = super(RecordingHA, self)._failover_policy(on_retry)
            inner = policy.on_retry

            def recording_hook(name, attempt, exc, delay):
                self.retry_events.append((name, attempt, delay))
                inner(name, attempt, exc, delay)

            policy.on_retry = recording_hook
            policy._sleep = lambda s: None
            return policy

    fs = RecordingHA(_MockConnector(fail_calls_by_nn={'nn1:8020': 1}), ['nn1:8020', 'nn2:8020'])
    assert fs.ls('/d') == ['nn2:8020:/d']
    assert [(name, attempt) for name, attempt, _ in fs.retry_events] == [('hdfs:ls', 0)]
    for _, attempt, delay in fs.retry_events:
        assert 0.0 <= delay <= min(RecordingHA.FAILOVER_MAX_DELAY_S,
                                   RecordingHA.FAILOVER_BASE_DELAY_S * 2 ** attempt)
