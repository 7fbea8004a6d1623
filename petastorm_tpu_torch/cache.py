"""Decoded row-group caches (counterpart of ``petastorm_tpu/cache.py:26-274``).

``MemoryCache`` keeps decoded chunks in RAM and ``LocalDiskCache`` keeps
them in files on local disk, so an epoch after the first skips the Parquet
read and the decode. The mmapped decoded-chunk store is
:mod:`petastorm_tpu_torch.chunk_store`. ``LocalDiskArrowTableCache`` waits
for ``make_batch_reader`` (ROADMAP §A9).
"""

import hashlib
import os
import pickle
import shutil
import tempfile
import threading
from collections import OrderedDict

from petastorm_tpu_torch.errors import CorruptChunkError
from petastorm_tpu_torch.membudget import approx_nbytes


class CacheBase(object):
    #: Serving tier in provenance records of a chunk this cache served.
    lineage_tier = 'cache'

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


class LocalDiskCache(CacheBase):
    """File-per-key cache with size-limited LRU eviction (by mtime).

    Decoded ndarray dicts (the tensor path's chunks) are stored in the
    chunk store's raw layout, so a hit parses a small header and wraps the
    bytes; any other value (the per-row path's row lists) is pickled. Older
    pickle entries of ndarray dicts are still read, and a raw entry that
    fails its check is filled again.

    :param path: the cache directory (created if missing).
    :param size_limit: approximate byte cap; ``None`` = no cap.
    :param cleanup: :meth:`cleanup` removes the directory.
    """

    _SUFFIX = '.pkl'
    lineage_tier = 'disk'

    def __init__(self, path, size_limit=None, cleanup=False):
        self._path = path
        self._size_limit = size_limit
        self._cleanup = cleanup
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        os.makedirs(path, exist_ok=True)

    def _key_path(self, key):
        digest = hashlib.md5(str(key).encode('utf-8')).hexdigest()
        return os.path.join(self._path, digest + self._SUFFIX)

    @staticmethod
    def _serialize(value):
        from petastorm_tpu_torch.chunk_store import conforms_tensor_chunk, pack_tensor_chunk
        if conforms_tensor_chunk(value):
            return pack_tensor_chunk(value)
        return pickle.dumps(value, protocol=pickle.HIGHEST_PROTOCOL)

    @staticmethod
    def _deserialize(blob):
        from petastorm_tpu_torch.chunk_store import is_tensor_chunk, read_tensor_chunk
        if is_tensor_chunk(blob):
            return read_tensor_chunk(blob)
        return pickle.loads(blob)

    def get(self, key, fill_cache_func):
        target = self._key_path(key)
        try:
            with open(target, 'rb') as f:
                blob = f.read()
            os.utime(target, None)   # the LRU's touch
            value = self._deserialize(blob)
            with self._lock:
                self.hits += 1
            return value
        except (FileNotFoundError, EOFError, pickle.UnpicklingError, CorruptChunkError):
            pass
        value = fill_cache_func()
        with self._lock:
            self.misses += 1
        blob = self._serialize(value)
        fd, tmp = tempfile.mkstemp(dir=self._path, suffix='.tmp')
        try:
            with os.fdopen(fd, 'wb') as f:
                f.write(blob)
            os.replace(tmp, target)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        self._maybe_evict()
        return value

    @property
    def nbytes(self):
        """Bytes of the entries on disk."""
        total = 0
        for name in os.listdir(self._path):
            if name.endswith(self._SUFFIX):
                try:
                    total += os.stat(os.path.join(self._path, name)).st_size
                except OSError:
                    continue
        return total

    def _maybe_evict(self):
        if self._size_limit is None:
            return
        with self._lock:
            entries, total = [], 0
            for name in os.listdir(self._path):
                if not name.endswith(self._SUFFIX):
                    continue
                full = os.path.join(self._path, name)
                try:
                    st = os.stat(full)
                except OSError:
                    continue
                entries.append((st.st_mtime, st.st_size, full))
                total += st.st_size
            if total <= self._size_limit:
                return
            entries.sort()   # oldest first
            for _, size, full in entries:
                try:
                    os.unlink(full)
                except OSError:
                    continue
                total -= size
                if total <= self._size_limit:
                    break

    def cleanup(self):
        if self._cleanup:
            shutil.rmtree(self._path, ignore_errors=True)
