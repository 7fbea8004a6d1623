"""Process-wide native decode-thread budget, fair-shared across pool workers
(counterpart of ``petastorm_tpu/decode_budget.py``).

The native image codec (``native/src/image_codec.cc``) fans each batched
decode call across its own C++ threads. :class:`DecodeThreadBudget` says how
many:

* the **total** comes from ``PSTT_DECODE_THREADS`` (default: the host's
  cores);
* every in-process worker pool **registers** its worker count
  (:meth:`DecodeThreadBudget.register_pool` -> :class:`PoolShare`) and
  releases it when its reader stops; :meth:`PoolShare.resize` re-divides on
  a live resize (``ThreadPool.resize``, the autotuner's ``workers`` knob),
  and :meth:`DecodeThreadBudget.set_total` (its ``decode_threads`` knob)
  retargets the total;
* each decode call asks :meth:`DecodeThreadBudget.share` for the *current*
  per-worker share, ``max(1, total // registered workers)``, so concurrent
  workers never oversubscribe the host. A decode with nothing registered
  (the loader's staging-step decode, a standalone call) gets the whole
  budget.
"""

import os
import threading

ENV_VAR = 'PSTT_DECODE_THREADS'


def default_total():
    """The process's decode-thread budget: ``PSTT_DECODE_THREADS`` when set
    (a positive integer), else the host's core count."""
    raw = os.environ.get(ENV_VAR, '').strip()
    if raw:
        try:
            value = int(raw)
        except ValueError:
            raise ValueError(
                '{} must be a positive integer, got {!r}'.format(ENV_VAR, raw))
        if value <= 0:
            raise ValueError(
                '{} must be a positive integer, got {!r}'.format(ENV_VAR, raw))
        return value
    return os.cpu_count() or 4


class PoolShare(object):
    """One registered worker pool's stake in the process budget.

    Handed out by :meth:`DecodeThreadBudget.register_pool`; the owner
    calls :meth:`resize` on live pool resizes and :meth:`release` at
    teardown (idempotent — a released share stops counting toward the
    fair-share divisor)."""

    def __init__(self, budget, key):
        self._budget = budget
        self._key = key

    def resize(self, workers):
        self._budget._resize(self._key, workers)

    def release(self):
        self._budget._release(self._key)

    @property
    def share(self):
        """This pool's current per-worker thread allotment."""
        return self._budget.share()


class DecodeThreadBudget(object):
    """Fair-share accountant over the process's native decode threads."""

    def __init__(self, total=None):
        self._lock = threading.Lock()
        self._total = int(total) if total else default_total()
        self._pools = {}          # key -> workers
        self._next_key = 0

    @property
    def total(self):
        return self._total

    def set_total(self, n):
        """Retarget the process-wide budget at runtime (the autotuner's
        ``decode_threads`` knob). Takes effect on the next decode
        call of every sharing worker: the C++ threads live for one call."""
        n = int(n)
        if n < 1:
            raise ValueError('decode thread budget must be >= 1, got {}'.format(n))
        self._total = n

    def register_pool(self, workers):
        """Add ``workers`` concurrent decode clients to the fair-share
        divisor; returns the :class:`PoolShare` handle that re-divides on
        resize and unregisters on release."""
        with self._lock:
            key = self._next_key
            self._next_key += 1
            self._pools[key] = max(1, int(workers))
        return PoolShare(self, key)

    def _resize(self, key, workers):
        with self._lock:
            if key in self._pools:
                self._pools[key] = max(1, int(workers))

    def _release(self, key):
        with self._lock:
            self._pools.pop(key, None)

    def sharers(self):
        """Total registered concurrent decode clients (0 when no pool is
        registered)."""
        with self._lock:
            return sum(self._pools.values())

    def share(self):
        """The per-worker fair share right now: ``total`` split across
        every registered worker, floor 1. With nothing registered (a
        standalone decode, the transcode tool, the loader's staging-step
        decode) the caller is presumed alone and gets the whole budget."""
        workers = self.sharers()
        return max(1, self._total // workers) if workers else self._total


_budget = None
_budget_lock = threading.Lock()


def get_budget():
    """The process-wide budget (total resolved from the environment on
    first use)."""
    global _budget
    if _budget is None:
        with _budget_lock:
            if _budget is None:
                _budget = DecodeThreadBudget()
    return _budget


def set_budget(budget):
    """Install ``budget`` as the process's (a test's own, for isolation).
    Returns the previous budget."""
    global _budget
    with _budget_lock:
        previous, _budget = _budget, budget
    return previous


#: The package-level export name (``petastorm_tpu_torch.get_decode_budget``).
get_decode_budget = get_budget
