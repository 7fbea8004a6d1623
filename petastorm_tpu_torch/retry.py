"""Retry policy: capped exponential backoff with full jitter, a deadline,
and circuit breakers (counterpart of ``petastorm_tpu/retry.py``).

:class:`RetryPolicy` sleeps ``uniform(0, min(cap, base * 2**attempt))``
before each retry (full jitter: hosts that saw the same transient error do
not retry in lockstep), up to ``max_attempts`` and within ``deadline_s``.
The retrying filesystem wrapper (:mod:`~petastorm_tpu_torch.fs`) and HDFS
namenode failover (:mod:`~petastorm_tpu_torch.hdfs`) both delegate to it.
:class:`CircuitBreaker` and :class:`BreakerSet` refuse calls to an endpoint
that failed its whole retry budget ``failure_threshold`` times in a row,
until a cooldown admits one probe. With an injected ``sleep``, ``rng`` and
``clock`` the delays and transitions are the JAX package's for the same
seed.

Every retry bumps ``pst_retries_total{op}`` and a process counter
(:func:`retry_counters`).
"""

import logging
import random
import threading
import time

logger = logging.getLogger(__name__)

_counters_lock = threading.Lock()
_retry_counters = {}


def _count_retry(name):
    with _counters_lock:
        _retry_counters[name] = _retry_counters.get(name, 0) + 1
    from petastorm_tpu_torch import metrics
    metrics.counter('pst_retries_total',
                    'Retried operations, by retry-loop name',
                    labelnames=('op',)).labels(name).inc()


def retry_counters():
    """Snapshot of ``{loop_name: retries_this_process}``."""
    with _counters_lock:
        return dict(_retry_counters)


def reset_retry_counters():
    with _counters_lock:
        _retry_counters.clear()


class RetryDeadlineExceeded(Exception):
    """The overall ``deadline_s`` elapsed before the call succeeded.

    Carries the last underlying exception as ``__cause__``.
    """


class RetryPolicy(object):
    """Capped exponential backoff with full jitter.

    The policy object is stateless across calls (safe to share between
    threads and reuse for many calls); per-call state lives on the stack.

    :param max_attempts: total attempts, including the first (>= 1).
    :param base_delay_s: backoff base; the attempt-``k`` retry sleeps
        ``uniform(0, min(max_delay_s, base_delay_s * 2**k))`` (full jitter).
    :param max_delay_s: hard cap on any single sleep.
    :param deadline_s: overall wall-clock budget across all attempts; when
        the next sleep would cross it the call fails with
        :class:`RetryDeadlineExceeded` (chaining the last error).
    :param jitter: ``'full'`` (default) or ``'none'`` (deterministic sleeps —
        only for tests; production jitter prevents synchronized retry storms).
    :param retry_exceptions: exception classes that are retried; anything
        else propagates immediately.
    :param on_retry: ``f(name, attempt, exception, delay_s)`` called before
        each sleep (attempt is 0-based). Used by tests and metrics.
    :param sleep: injectable sleep function (tests).
    :param rng: injectable ``random.Random`` (tests); defaults to a private
        seeded-from-os instance so concurrent policies don't share state.
    """

    def __init__(self, max_attempts=3, base_delay_s=0.1, max_delay_s=5.0,
                 deadline_s=None, jitter='full',
                 retry_exceptions=(IOError, OSError), on_retry=None,
                 sleep=time.sleep, rng=None):
        if max_attempts < 1:
            raise ValueError('max_attempts must be >= 1, got {}'.format(max_attempts))
        if jitter not in ('full', 'none'):
            raise ValueError("jitter must be 'full' or 'none', got {!r}".format(jitter))
        self.max_attempts = int(max_attempts)
        self.base_delay_s = float(base_delay_s)
        self.max_delay_s = float(max_delay_s)
        self.deadline_s = deadline_s
        self.jitter = jitter
        self.retry_exceptions = tuple(retry_exceptions)
        self.on_retry = on_retry
        self._sleep = sleep
        self._rng = rng or random.Random()

    def compute_delay(self, attempt):
        """Sleep seconds before retry number ``attempt`` (0-based). Never
        exceeds ``max_delay_s``."""
        cap = min(self.max_delay_s, self.base_delay_s * (2 ** attempt))
        if cap <= 0:
            return 0.0
        if self.jitter == 'full':
            return self._rng.uniform(0, cap)
        return cap

    def call(self, fn, *args, **kwargs):
        """Run ``fn(*args, **kwargs)`` under this policy.

        Keyword-only extras (consumed, not forwarded; prefixed so they can
        never collide with the wrapped function's own kwargs):

        * ``retry_call_name`` — label for logs/counters/hooks (default: fn
          name);
        * ``retry_call_hook`` — per-call override of the instance
          ``on_retry`` hook.

        Raises the last underlying exception once attempts are exhausted, or
        :class:`RetryDeadlineExceeded` when the deadline cuts retries short.
        """
        name = kwargs.pop('retry_call_name', None) or getattr(fn, '__name__', 'call')
        on_retry = kwargs.pop('retry_call_hook', None) or self.on_retry
        start = time.monotonic()
        attempt = 0
        while True:
            try:
                return fn(*args, **kwargs)
            except self.retry_exceptions as e:
                if attempt + 1 >= self.max_attempts:
                    raise
                delay = self.compute_delay(attempt)
                if self.deadline_s is not None:
                    elapsed = time.monotonic() - start
                    if elapsed + delay > self.deadline_s:
                        raise RetryDeadlineExceeded(
                            '{}: retry deadline of {}s exhausted after {} '
                            'attempts'.format(name, self.deadline_s,
                                              attempt + 1)) from e
                _count_retry(name)
                if on_retry is not None:
                    on_retry(name, attempt, e, delay)
                logger.warning('%s failed (%s); retry %d/%d in %.3fs',
                               name, e, attempt + 1, self.max_attempts - 1,
                               delay)
                if delay:
                    self._sleep(delay)
                attempt += 1

    def wrap(self, fn, name=None):
        """``fn`` -> retried ``fn`` (same signature)."""
        def wrapped(*args, **kwargs):
            kwargs['retry_call_name'] = name or getattr(fn, '__name__', 'call')
            return self.call(fn, *args, **kwargs)
        return wrapped


class CircuitOpenError(Exception):
    """The circuit is open: the protected endpoint failed its whole retry
    budget ``failure_threshold`` consecutive times recently, so calls are
    refused instantly instead of re-paying the budget against a blackholed
    peer. Carries nothing — the caller already has the endpoint."""


class CircuitBreaker(object):
    """Client-side circuit breaker layered on :class:`RetryPolicy`.

    The retry policy absorbs *transient* failures (a dropped reply, a
    slow reply); the breaker handles *persistent* ones (a blackholed or
    partitioned endpoint that swallows every request). Without it, every
    probe of a dead endpoint pays the whole retry budget — a watchdog
    sweeping each tick, or a consumer hedging metadata rpcs, stalls on
    the corpse instead of routing around it.

    States (the standard three):

    * ``closed`` — calls flow; ``failure_threshold`` CONSECUTIVE recorded
      failures open the circuit (a single success resets the count).
    * ``open`` — :meth:`allow` is False and :meth:`call` raises
      :class:`CircuitOpenError` without touching the endpoint, until
      ``reset_timeout_s`` has passed.
    * ``half-open`` — after the cooldown ONE probe call is admitted; its
      success closes the circuit, its failure re-opens it (and restarts
      the cooldown).

    Thread-safe: state transitions happen under a lock; the protected
    call itself runs outside it. One breaker guards one endpoint — keep
    a dict keyed by endpoint for a fleet.
    """

    CLOSED, OPEN, HALF_OPEN = 'closed', 'open', 'half-open'

    def __init__(self, failure_threshold=3, reset_timeout_s=30.0,
                 clock=time.monotonic):
        if failure_threshold < 1:
            raise ValueError('failure_threshold must be >= 1, got {}'.format(
                failure_threshold))
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout_s = float(reset_timeout_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._failures = 0
        self._state = self.CLOSED
        self._opened_at = None
        self._probe_out = False     # a half-open probe is in flight
        self.opens = 0              # episodes, for diagnostics

    @property
    def state(self):
        with self._lock:
            return self._state_locked()

    def _state_locked(self):
        if (self._state == self.OPEN
                and self._clock() - self._opened_at >= self.reset_timeout_s):
            self._state = self.HALF_OPEN
            self._probe_out = False
        return self._state

    def allow(self):
        """True when a call may proceed now. In half-open state only ONE
        caller gets True until its outcome is recorded — concurrent
        probes would hammer a barely-recovered endpoint."""
        with self._lock:
            state = self._state_locked()
            if state == self.CLOSED:
                return True
            if state == self.HALF_OPEN and not self._probe_out:
                self._probe_out = True
                return True
            return False

    def record_success(self):
        with self._lock:
            self._failures = 0
            self._state = self.CLOSED
            self._probe_out = False

    def record_failure(self):
        with self._lock:
            state = self._state_locked()
            self._failures += 1
            if state == self.HALF_OPEN or \
                    self._failures >= self.failure_threshold:
                if self._state != self.OPEN:
                    self.opens += 1
                self._state = self.OPEN
                self._opened_at = self._clock()
                self._probe_out = False

    def call(self, fn, *args, **kwargs):
        """Run ``fn`` through the breaker: :class:`CircuitOpenError` when
        open; success/failure of the call recorded. Any exception counts
        as a failure and propagates."""
        if not self.allow():
            raise CircuitOpenError()
        try:
            result = fn(*args, **kwargs)
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return result


class BreakerSet(object):
    """A keyed family of :class:`CircuitBreaker` with one construction
    policy — the fleet-client pattern (one breaker per endpoint, or per
    ``(partition, endpoint)``) without every caller re-growing the same
    lock + dict-of-breakers boilerplate. Breakers are created lazily on
    first :meth:`get` and never expire: the key space is the candidate
    set, which the owner bounds (a lookup client prunes endpoints that
    leave the partition map).

    Thread-safe: the dict is lock-guarded; the breakers themselves are
    already thread-safe.
    """

    def __init__(self, failure_threshold=3, reset_timeout_s=30.0,
                 clock=time.monotonic):
        self._failure_threshold = int(failure_threshold)
        self._reset_timeout_s = float(reset_timeout_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._breakers = {}

    def get(self, key):
        """The breaker guarding ``key`` (created closed on first use)."""
        with self._lock:
            breaker = self._breakers.get(key)
            if breaker is None:
                breaker = self._breakers[key] = CircuitBreaker(
                    failure_threshold=self._failure_threshold,
                    reset_timeout_s=self._reset_timeout_s,
                    clock=self._clock)
            return breaker

    def discard(self, key):
        """Drop ``key``'s breaker (the endpoint left the fleet)."""
        with self._lock:
            self._breakers.pop(key, None)

    def keys(self):
        with self._lock:
            return list(self._breakers)

    def states(self):
        """``{key: state}`` snapshot for routing tables/diagnostics."""
        with self._lock:
            items = list(self._breakers.items())
        return {key: breaker.state for key, breaker in items}

    def open_count(self):
        return sum(1 for state in self.states().values()
                   if state == CircuitBreaker.OPEN)

    def __contains__(self, key):
        with self._lock:
            return key in self._breakers

    def __len__(self):
        with self._lock:
            return len(self._breakers)
