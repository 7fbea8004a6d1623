"""Decoded row-group caches (counterpart of ``petastorm_tpu/cache.py:26-169``).

``MemoryCache`` keeps decoded chunks in RAM, so an epoch after the first
skips the Parquet read and the decode. The disk and chunk-store tiers of
the JAX package are not ported yet.
"""

import sys
import threading
from collections import OrderedDict


def approx_nbytes(value):
    """The byte estimate of a cached value, as ``petastorm_tpu/membudget.py:220``
    makes it for the values cached here: a dict of arrays (each key's
    ``sys.getsizeof`` plus each array's ``nbytes``), a list of row dicts,
    an array, or ``None``."""
    if value is None:
        return 0
    if isinstance(value, dict):
        return sum(sys.getsizeof(k) + approx_nbytes(v) for k, v in value.items())
    if isinstance(value, (list, tuple)):
        return sys.getsizeof(value) + sum(approx_nbytes(v) for v in value)
    nbytes = getattr(value, 'nbytes', None)
    return int(nbytes) if nbytes is not None else sys.getsizeof(value)


class CacheBase(object):
    def get(self, key, fill_cache_func):
        """The cached value of ``key``; on a miss, ``fill_cache_func()``'s
        result, stored."""
        raise NotImplementedError

    def cleanup(self):
        pass


class NullCache(CacheBase):
    """No cache: every ``get`` calls the fill function."""

    #: Serving tier in provenance records: every get is a fresh decode.
    lineage_tier = 'decode'

    def get(self, key, fill_cache_func):
        return fill_cache_func()


class MemoryCache(CacheBase):
    """In-RAM LRU cache with an approximate byte cap.

    Values are kept by reference: callers treat them as immutable (the
    tensor worker marks cached blocks read-only). Fills are single-flight
    per key: the ventilator dispatches a row-group of epoch N+1 while epoch
    N's decode of it may still run, and the second ``get`` waits for the
    first one's entry instead of decoding again. A fill that raises caches
    nothing; a fill that returns ``None`` (an empty row-group) is cached.

    :param size_limit_bytes: evict least-recently-used entries while the
        total exceeds it (the newest entry always stays); ``None`` = no cap.
    """

    #: Serving tier in provenance records of a hit.
    lineage_tier = 'memory'

    def __init__(self, size_limit_bytes=None):
        self._entries = OrderedDict()   # key -> (value, nbytes)
        self._total = 0
        self._size_limit = size_limit_bytes
        self._lock = threading.Lock()
        self._inflight = {}             # key -> Event of the fill in flight
        self.hits = 0
        self.misses = 0

    def get(self, key, fill_cache_func):
        while True:
            with self._lock:
                entry = self._entries.get(key)
                if entry is not None:
                    self._entries.move_to_end(key)
                    self.hits += 1
                    return entry[0]
                event = self._inflight.get(key)
                if event is None:
                    event = self._inflight[key] = threading.Event()
                    break               # this thread fills
            event.wait()                # then re-check; a failed fill leaves no entry
        try:
            value = fill_cache_func()
            nbytes = approx_nbytes(value)
            with self._lock:
                self.misses += 1
                if key not in self._entries:
                    self._entries[key] = (value, nbytes)
                    self._total += nbytes
                    if self._size_limit is not None:
                        while self._total > self._size_limit and len(self._entries) > 1:
                            _, (_, old) = self._entries.popitem(last=False)
                            self._total -= old
            return value
        finally:
            # Always wake the waiters, or every later get() of the key hangs.
            with self._lock:
                self._inflight.pop(key, None)
            event.set()

    @property
    def nbytes(self):
        """Resident bytes (approximate)."""
        with self._lock:
            return self._total

    def evict(self, keep_frac=0.5):
        """Drop LRU entries until at most ``keep_frac`` of the current bytes
        remain; returns the bytes freed. An evicted entry refills at its
        next miss."""
        freed = 0
        with self._lock:
            target = self._total * float(keep_frac)
            while self._entries and self._total > target:
                _, (_, nbytes) = self._entries.popitem(last=False)
                self._total -= nbytes
                freed += nbytes
        return freed

    def cleanup(self):
        with self._lock:
            self._entries.clear()
            self._total = 0
