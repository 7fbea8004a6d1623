"""Mmap-backed decoded-chunk store: the NVMe cache tier.

Counterpart of ``petastorm_tpu/chunk_store.py:1-881``, in the same on-disk
format byte for byte, so either package serves a store the other filled.
Left out (ROADMAP §A9): the ``store-read-corrupt`` fault site, the metrics
counters, the trace counters and the autotuner's throttle listener (the
throttle itself is here).

The tiers before it leave a gap: the device cache needs the dataset on the
card, ``MemoryCache`` needs it in RAM once per process, and a cache of
encoded bytes pays the decode every epoch. :class:`DecodedChunkStore`
keeps decoded tensors on local disk in their final memory layout:

* Epoch 0 (fill): the worker's decoded column blocks go to a write-behind
  thread (the decode never waits on the disk), which writes one file per
  key (dataset, row-group, Parquet file fingerprint, field set): a small
  JSON header with each field's dtype, shape, offset and CRC32, then the
  raw buffers, 64-byte aligned, into a temporary file renamed into place
  under an ``flock``'d lock file. Racing writers make exactly one entry,
  and a reader never sees a torn one.
* Later epochs (serve): the entry is mmapped (its CRCs checked once per
  process) and a hit hands out numpy views over the mapping; the worker
  publishes them read-only, so the loader copies once, mmap -> arena, with
  no decode.
* Robustness: a corrupt or truncated entry is renamed to ``*.corrupt`` and
  refilled by decoding again.
* :meth:`DecodedChunkStore.set_writer_throttled` paces the writer;
  :meth:`~DecodedChunkStore.set_spill_paused` (the memory governor's
  advisory rung) refuses new spill work.

The layout (:func:`pack_tensor_chunk`), shared with ``LocalDiskCache``'s
ndarray-dict entries::

    magic 'PSTC' | u16 version | u32 header_len | u64 data_start
    header JSON {fields: [{name, dtype, shape, offset, nbytes, crc32}]}
    ...padding to 64-byte alignment...
    field payloads (each 64-byte aligned, offsets relative to data_start)

Activation: ``cache_type='chunk-store'`` on ``make_tensor_reader`` (the
directory from ``cache_location`` or ``PSTT_CHUNK_STORE``), or
``PSTT_CHUNK_STORE`` alone with the default ``cache_type``. Offline fill:
``python -m petastorm_tpu_torch.tools.transcode``.
"""

import hashlib
import io
import json
import logging
import mmap
import os
import queue
import shutil
import struct
import tempfile
import threading
import time
import zlib
from collections import OrderedDict

import numpy as np

from petastorm_tpu_torch.cache import CacheBase
from petastorm_tpu_torch.errors import CorruptChunkError

logger = logging.getLogger(__name__)

ENV_VAR = 'PSTT_CHUNK_STORE'
WRITER_THREAD_NAME = 'pstt-chunk-store-writer'
#: Prefix of the temporary store directories the bench makes.
TEMP_DIR_PREFIX = 'pstt-chunk-store-'

_MAGIC = b'PSTC'
_VERSION = 1
_PREAMBLE = struct.Struct('<4sHIQ')   # magic, version, header_len, data_start
_ALIGN = 64
_ENTRY_SUFFIX = '.chunk'

#: Mapped entries kept open per process (an LRU; a dropped entry re-maps on
#: its next hit).
_MAX_OPEN_ENTRIES = 1024

#: Age past which a ``*.tmp``/``*.lock`` file cannot belong to a live write;
#: such files (left by a killed writer) are removed when a store opens.
_STALE_SCRATCH_S = 600

_STOP = object()


def _file_fingerprint(path):
    """Size and mtime of the row-group's Parquet file: a store outlives the
    session, so a dataset rewritten in place misses instead of serving
    stale tensors ('nofp' where the file cannot be stat'ed)."""
    try:
        st = os.stat(path)
        return '{}-{}'.format(st.st_size, st.st_mtime_ns)
    except (OSError, ValueError):
        return 'nofp'


def tensor_chunk_key(dataset_path_hash, piece_path, row_group, schema):
    """The cache key of one decoded row-group: dataset, row-group, the
    Parquet file's fingerprint and the hash of the field names read. The
    worker's lookup and the reader's readahead share it, and it is the JAX
    package's key string for string."""
    schema_digest = hashlib.md5(','.join(sorted(schema.fields)).encode()).hexdigest()[:8]
    return 'tensor:{}:{}:{}:{}:{}'.format(dataset_path_hash, piece_path, row_group,
                                          _file_fingerprint(str(piece_path)), schema_digest)


def _align(offset):
    return (offset + _ALIGN - 1) // _ALIGN * _ALIGN


def conforms_tensor_chunk(value):
    """True when ``value`` fits the raw layout: a non-empty dict of numpy
    arrays of plain buffer dtypes (no object or structured fields)."""
    if not isinstance(value, dict) or not value:
        return False
    return all(isinstance(v, np.ndarray) and v.dtype.kind not in ('O', 'V')
               for v in value.values())


def _field_records(cols):
    """The header records and the buffers to write, fields sorted by name,
    offsets relative to the data section."""
    records, buffers = [], []
    offset = 0
    for name in sorted(cols):
        arr = np.ascontiguousarray(cols[name])
        if arr.dtype.kind in ('M', 'm'):
            # The buffer protocol refuses datetime64/timedelta64; their bytes
            # are int64 ticks, and the header's dtype string restores them.
            mv = memoryview(arr.view(np.uint8)).cast('B')
        else:
            mv = memoryview(arr).cast('B')
        offset = _align(offset)
        records.append({'name': name, 'dtype': arr.dtype.str, 'shape': list(arr.shape),
                        'offset': offset, 'nbytes': arr.nbytes,
                        'crc32': zlib.crc32(mv) & 0xFFFFFFFF})
        buffers.append(mv)
        offset += arr.nbytes
    return records, buffers


def write_tensor_chunk(f, cols):
    """Write ``{name: ndarray}`` into the binary file ``f`` in the store
    layout; returns the bytes written."""
    records, buffers = _field_records(cols)
    header = json.dumps({'fields': records}).encode('utf-8')
    data_start = _align(_PREAMBLE.size + len(header))
    f.write(_PREAMBLE.pack(_MAGIC, _VERSION, len(header), data_start))
    f.write(header)
    pos = _PREAMBLE.size + len(header)
    for record, mv in zip(records, buffers):
        target = data_start + record['offset']
        if target > pos:
            f.write(b'\0' * (target - pos))
            pos = target
        f.write(mv)
        pos += record['nbytes']
    return pos


def pack_tensor_chunk(cols):
    """:func:`write_tensor_chunk` into bytes."""
    sink = io.BytesIO()
    write_tensor_chunk(sink, cols)
    return sink.getvalue()


def is_tensor_chunk(blob):
    """True when ``blob`` starts with the layout's magic."""
    return bytes(blob[:4]) == _MAGIC


def read_tensor_chunk(buf, validate=True, source='<buffer>'):
    """Parse the layout over ``buf`` (bytes or an mmap) into a dict of numpy
    views that alias it. Any structural or checksum mismatch raises
    :class:`~petastorm_tpu_torch.errors.CorruptChunkError`, header fields
    mangled into other types included."""
    size = len(buf)
    if size < _PREAMBLE.size:
        raise CorruptChunkError('{}: short preamble ({} bytes)'.format(source, size))
    magic, version, header_len, data_start = _PREAMBLE.unpack_from(buf, 0)
    if magic != _MAGIC:
        raise CorruptChunkError('{}: bad magic {!r}'.format(source, magic))
    if version != _VERSION:
        raise CorruptChunkError('{}: unsupported version {}'.format(source, version))
    if _PREAMBLE.size + header_len > size or data_start > size:
        raise CorruptChunkError('{}: truncated header'.format(source))
    try:
        header = json.loads(bytes(buf[_PREAMBLE.size:_PREAMBLE.size + header_len])
                            .decode('utf-8'))
        fields = header['fields']
    except (ValueError, KeyError, TypeError, UnicodeDecodeError) as e:
        raise CorruptChunkError('{}: unparsable header: {}'.format(source, e))
    cols = {}
    for record in fields:
        # The CRCs cover the payloads only: a flipped header byte can leave
        # the JSON valid with a mangled dtype, shape or offset.
        try:
            name = record['name']
            dtype = np.dtype(str(record['dtype']))
            shape = tuple(int(d) for d in record['shape'])
            nbytes = int(record['nbytes'])
            start = data_start + int(record['offset'])
            crc = int(record['crc32'])
        except (TypeError, ValueError, KeyError) as e:
            raise CorruptChunkError('{}: bad field record: {}'.format(source, e))
        if dtype.hasobject or dtype.itemsize == 0:
            raise CorruptChunkError('{}: field {!r} has non-buffer dtype {}'.format(
                source, name, dtype))
        expected = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        if expected != nbytes or nbytes < 0 or min(shape, default=0) < 0:
            raise CorruptChunkError('{}: field {!r} shape {} x {} does not cover {} bytes'
                                    .format(source, name, shape, dtype, nbytes))
        if start < 0 or start + nbytes > size:
            raise CorruptChunkError('{}: field {!r} extends past EOF'.format(source, name))
        view = memoryview(buf)[start:start + nbytes]
        if validate and (zlib.crc32(view) & 0xFFFFFFFF) != crc:
            raise CorruptChunkError('{}: field {!r} checksum mismatch'.format(source, name))
        try:
            arr = np.frombuffer(buf, dtype=dtype, count=nbytes // dtype.itemsize, offset=start)
            cols[name] = arr.reshape(shape)
        except (ValueError, TypeError) as e:
            raise CorruptChunkError('{}: field {!r} unmappable: {}'.format(source, name, e))
    return cols


class _OpenEntry(object):
    """One validated, mmapped entry in the per-process open-entry LRU.

    The mapping is never closed: views of it may live anywhere downstream
    (``mmap.close`` with exported buffers raises). Dropping the entry from
    the LRU lets the mapping die with its last view."""

    __slots__ = ('mm', 'views', 'nbytes')

    def __init__(self, mm, views, nbytes):
        self.mm = mm
        self.views = views
        self.nbytes = nbytes

    @classmethod
    def open(cls, path, validate=True):
        with open(path, 'rb') as f:
            if os.fstat(f.fileno()).st_size == 0:
                raise CorruptChunkError('{}: empty entry'.format(path))
            # ACCESS_COPY (MAP_PRIVATE): a write through a view lands on a
            # private page of this process, never in the shared file. The
            # worker still publishes the views read-only.
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        views = read_tensor_chunk(mm, validate=validate, source=path)
        return cls(mm, views, len(mm))

    def willneed(self):
        """Ask the kernel to read this entry's pages in ahead of the copy."""
        if hasattr(self.mm, 'madvise'):
            try:
                self.mm.madvise(mmap.MADV_WILLNEED)
            except (OSError, ValueError):
                pass


class DecodedChunkStore(CacheBase):
    """Epoch-persistent decoded-chunk cache on local disk, shared by every
    process that opens the directory.

    Plugs into the worker's ``cache.get(key, fill_fn)``: a miss runs
    ``fill_fn`` (read and decode) and queues the blocks for the writer; a
    hit returns a fresh dict of the mmapped entry's views.

    :param path: the store directory (created if missing); ``None`` reads
        ``PSTT_CHUNK_STORE``.
    :param size_limit: approximate byte cap of the entries; the oldest by
        mtime go after a write passes it. ``None`` = no cap.
    :param writer_queue_depth: pending writes; an overflowing queue drops
        the write (``write_skipped``) and never blocks the decode: the
        chunk misses again in its next epoch and re-queues.
    :param throttle_delay_s: the writer's pace while throttled.
    :param cleanup: :meth:`cleanup` removes the directory.

    Every field's CRC32 is checked once per process, when its entry is
    first mapped.
    """

    #: Gate of ``Reader.chunk_store``.
    is_chunk_store = True
    #: Serving tier in provenance records of a hit.
    lineage_tier = 'chunk-store'

    def __init__(self, path=None, size_limit=None, writer_queue_depth=16, throttle_delay_s=0.05,
                 cleanup=False):
        if path is None:
            path = os.environ.get(ENV_VAR) or None
        if not path:
            raise ValueError('DecodedChunkStore needs a directory: pass cache_location or set '
                             'the {} environment variable'.format(ENV_VAR))
        self._config = {'path': path, 'size_limit': size_limit,
                        'writer_queue_depth': writer_queue_depth,
                        'throttle_delay_s': throttle_delay_s, 'cleanup': cleanup}
        self._init_from_config()

    def _init_from_config(self):
        cfg = self._config
        self._path = cfg['path']
        self._size_limit = cfg['size_limit']
        self._queue_depth = max(1, int(cfg['writer_queue_depth']))
        self._throttle_delay_s = float(cfg['throttle_delay_s'])
        self._do_cleanup = bool(cfg['cleanup'])
        os.makedirs(self._path, exist_ok=True)
        self._sweep_stale_scratch()
        self._lock = threading.RLock()
        self._entries = OrderedDict()      # digest -> _OpenEntry, LRU order
        # Entries are immutable once published, so each is CRC-checked once
        # per process, also after the LRU dropped and reopened it.
        self._validated = set()
        self._writeq = None
        self._writeq_bytes = 0             # decoded bytes held by the queue
        self._writer = None
        self._stopping = False
        self._throttled = False
        self._spill_paused = False
        self._dir_bytes = None             # running size estimate; None = scan
        self.hits = 0
        self.misses = 0
        self.fills = 0          # misses that produced a chunk (not empty row-groups)
        self.writes = 0
        self.write_skipped = 0
        self.write_races = 0    # another writer published the key first
        self.corrupt = 0
        self.bytes_written = 0
        self.bytes_mapped = 0
        self.readaheads = 0
        self.unstorable = 0

    def _sweep_stale_scratch(self):
        """Remove ``*.tmp``/``*.lock`` files older than ``_STALE_SCRATCH_S``:
        a writer killed between ``mkstemp`` and the rename leaves a file no
        rename claims and no eviction counts."""
        now = time.time()
        try:
            names = os.listdir(self._path)
        except OSError:
            return
        for name in names:
            if not name.endswith(('.tmp', '.lock')):
                continue
            full = os.path.join(self._path, name)
            try:
                if now - os.stat(full).st_mtime > _STALE_SCRATCH_S:
                    os.unlink(full)
            except OSError:
                continue

    # -- pickling: another process opens the same directory ----------------

    def __getstate__(self):
        return {'config': dict(self._config)}

    def __setstate__(self, state):
        self._config = state['config']
        self._init_from_config()

    # -- keys and paths ----------------------------------------------------

    @staticmethod
    def _digest(key):
        return hashlib.md5(str(key).encode('utf-8')).hexdigest()

    def _entry_path(self, key):
        return os.path.join(self._path, self._digest(key) + _ENTRY_SUFFIX)

    # -- read path ---------------------------------------------------------

    def _quarantine(self, path, error):
        """Move a corrupt entry aside (never served, never retried) so that
        the caller refills it."""
        logger.warning('chunk store entry quarantined: %s', error)
        try:
            os.replace(path, path + '.corrupt')
        except OSError:
            try:
                os.unlink(path)
            except OSError:
                pass

    def _open_entry(self, key):
        """The validated entry of ``key``, opened on first touch, or
        ``None`` (absent, or quarantined just now)."""
        digest = self._digest(key)
        with self._lock:
            entry = self._entries.get(digest)
            if entry is not None:
                self._entries.move_to_end(digest)
                return entry
        path = os.path.join(self._path, digest + _ENTRY_SUFFIX)
        if not os.path.exists(path):
            return None
        # Open and check outside the lock: the first check reads the whole
        # entry, and the workers' hits must not queue behind it. Two threads
        # racing one entry check it twice; the insert keeps one.
        with self._lock:
            validate = digest not in self._validated
        try:
            entry = _OpenEntry.open(path, validate=validate)
        except CorruptChunkError as e:
            with self._lock:
                self.corrupt += 1
                self._validated.discard(digest)
            self._quarantine(path, e)
            return None
        except OSError as e:
            logger.warning('chunk store entry %s unreadable: %s', path, e)
            return None
        with self._lock:
            winner = self._entries.get(digest)
            if winner is not None:
                self._entries.move_to_end(digest)
                return winner
            self._entries[digest] = entry
            self._validated.add(digest)
            self.bytes_mapped += entry.nbytes
            while len(self._entries) > _MAX_OPEN_ENTRIES:
                # Dropped, not closed: live views keep the mapping alive.
                self._entries.popitem(last=False)
            return entry

    def readahead(self, key):
        """Fault-in hint for a row-group the ventilator just scheduled:
        ``madvise(WILLNEED)`` over its entry. It neither parses nor checks
        the entry (this runs on the ventilator's one thread; the workers
        check in parallel). True when an entry was hinted."""
        digest = self._digest(key)
        with self._lock:
            entry = self._entries.get(digest)
        if entry is not None:
            entry.willneed()
        else:
            path = os.path.join(self._path, digest + _ENTRY_SUFFIX)
            try:
                with open(path, 'rb') as f:
                    if os.fstat(f.fileno()).st_size == 0:
                        return False
                    mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
            except (OSError, ValueError):
                return False
            if hasattr(mm, 'madvise'):
                try:
                    mm.madvise(mmap.MADV_WILLNEED)
                except (OSError, ValueError):
                    pass
            mm.close()   # nothing exported; the pages stay in the page cache
        with self._lock:
            self.readaheads += 1
        return True

    # -- CacheBase ---------------------------------------------------------

    def get(self, key, fill_cache_func):
        entry = self._open_entry(key)
        if entry is not None:
            with self._lock:
                self.hits += 1
            # A fresh dict per hit: a caller may slice or pop its copy.
            return dict(entry.views)
        with self._lock:
            self.misses += 1
        value = fill_cache_func()
        if value is None:
            return None
        with self._lock:
            self.fills += 1
        if conforms_tensor_chunk(value):
            self._enqueue_write(key, value)
        else:
            with self._lock:
                self.unstorable += 1
        return value

    def has(self, key):
        """True when ``key`` is persisted (an existence probe: no mmap)."""
        return os.path.exists(self._entry_path(key))

    def put(self, key, cols):
        """Persist ``{field: ndarray}`` under ``key`` now (fsync and atomic
        rename), past the write-behind queue. True when the entry is on
        disk (already present counts), False when the value does not fit
        the layout."""
        if not conforms_tensor_chunk(cols):
            with self._lock:
                self.unstorable += 1
            return False
        self._write_entry(key, cols)
        return True

    # -- write-behind ------------------------------------------------------

    def _enqueue_write(self, key, cols):
        with self._lock:
            if self._stopping:
                return
            if self._spill_paused:
                self.write_skipped += 1
                return
            if self._writer is None:
                self._writeq = queue.Queue(maxsize=self._queue_depth)
                self._writer = threading.Thread(target=self._writer_loop, daemon=True,
                                                name=WRITER_THREAD_NAME)
                self._writer.start()
            nbytes = sum(int(getattr(arr, 'nbytes', 0)) for arr in cols.values())
            try:
                self._writeq.put_nowait((key, cols, nbytes))
                self._writeq_bytes += nbytes
            except queue.Full:
                # Never block the decode on the disk: drop; the next epoch's
                # miss re-queues the chunk.
                self.write_skipped += 1

    def set_spill_paused(self, paused):
        """The governor's advisory hook: while True new spill work is
        refused at the queue (counted as ``write_skipped``) and the queued
        backlog keeps draining. Holding the writer instead would pin a full
        queue of decoded chunks for the whole episode."""
        self._spill_paused = bool(paused)

    @property
    def spill_paused(self):
        return self._spill_paused

    def set_writer_throttled(self, throttled):
        """While True the writer is paced, one entry per
        ``throttle_delay_s``, so the fill cedes CPU and disk to a pipeline
        that is the bottleneck without starving the store."""
        self._throttled = bool(throttled)

    @property
    def writer_throttled(self):
        return self._throttled

    def _writer_loop(self):
        while True:
            item = self._writeq.get()
            try:
                if item is _STOP:
                    return
                waited = 0.0
                while self._throttled and not self._stopping and waited < self._throttle_delay_s:
                    time.sleep(0.005)
                    waited += 0.005
                key, cols, nbytes = item
                try:
                    self._write_entry(key, cols)
                except Exception:  # noqa: BLE001 - spill must never kill the pipeline
                    logger.exception('chunk store write-behind failed for %r', key)
                with self._lock:
                    self._writeq_bytes = max(0, self._writeq_bytes - nbytes)
            finally:
                self._writeq.task_done()

    def _write_entry(self, key, cols):
        import fcntl
        path = self._entry_path(key)
        if os.path.exists(path):
            return
        # Of N writers of one key, the flock lets one write; the others see
        # the entry on the re-check.
        lock_path = path + '.lock'
        with open(lock_path, 'a') as lock_file:
            fcntl.flock(lock_file, fcntl.LOCK_EX)
            try:
                if os.path.exists(path):
                    with self._lock:
                        self.write_races += 1
                    return
                fd, tmp = tempfile.mkstemp(dir=self._path, suffix='.tmp')
                try:
                    with os.fdopen(fd, 'wb') as f:
                        nbytes = write_tensor_chunk(f, cols)
                        f.flush()
                        os.fsync(f.fileno())
                    os.replace(tmp, path)   # atomic publish
                except BaseException:
                    try:
                        os.unlink(tmp)
                    except OSError:
                        pass
                    raise
                try:
                    os.unlink(lock_path)
                except OSError:
                    pass
            finally:
                fcntl.flock(lock_file, fcntl.LOCK_UN)
        with self._lock:
            self.writes += 1
            self.bytes_written += nbytes
        self._maybe_evict(nbytes)

    def _maybe_evict(self, new_bytes=0):
        """The size cap: a running estimate grows with each write, and the
        directory is scanned only when it crosses the limit; the oldest
        entries (quarantined ones too) go first."""
        if self._size_limit is None:
            return
        with self._lock:
            if self._dir_bytes is not None:
                self._dir_bytes += new_bytes
                if self._dir_bytes <= self._size_limit:
                    return
        entries, total = [], 0
        for name in os.listdir(self._path):
            if not name.endswith((_ENTRY_SUFFIX, '.corrupt')):
                continue
            full = os.path.join(self._path, name)
            try:
                st = os.stat(full)
            except OSError:
                continue
            entries.append((st.st_mtime, st.st_size, full))
            total += st.st_size
        if total > self._size_limit:
            entries.sort()
            for _, size, full in entries:
                try:
                    os.unlink(full)
                except OSError:
                    continue
                total -= size
                if total <= self._size_limit:
                    break
        with self._lock:
            self._dir_bytes = total

    # -- memory governor ---------------------------------------------------

    def governed_nbytes(self):
        """Host bytes the store holds: decoded chunks in the write queue and
        the open entries' mapped bytes (the upper bound of what hits have
        paged in)."""
        with self._lock:
            mapped = sum(entry.nbytes for entry in self._entries.values())
            return self._writeq_bytes + mapped

    def close_lru_mmaps(self, keep_frac=0.5):
        """The governor's degrade hook: drop least-recently-used open
        entries until at most ``keep_frac`` of them remain. Dropped, not
        closed (live views keep their pages); a dropped entry re-maps on its
        next hit without a second CRC pass. Returns the mapped bytes
        released from the account."""
        freed = 0
        with self._lock:
            keep = int(len(self._entries) * float(keep_frac))
            while len(self._entries) > keep:
                _, entry = self._entries.popitem(last=False)
                freed += entry.nbytes
        return freed

    def flush(self, timeout_s=30.0):
        """Wait until the write queue drained; False on timeout."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            q = self._writeq
            if q is None or q.unfinished_tasks == 0:
                return True
            time.sleep(0.005)
        return False

    # -- lifecycle and stats -----------------------------------------------

    def stats(self):
        """The counters, the JAX package's keys."""
        with self._lock:
            q = self._writeq
            return {'path': self._path, 'hits': self.hits, 'misses': self.misses,
                    'fills': self.fills, 'writes': self.writes,
                    'write_skipped': self.write_skipped, 'write_races': self.write_races,
                    'corrupt_quarantined': self.corrupt, 'bytes_written': self.bytes_written,
                    'bytes_mapped': self.bytes_mapped, 'readaheads': self.readaheads,
                    'unstorable': self.unstorable,
                    'pending_writes': q.unfinished_tasks if q is not None else 0,
                    'pending_write_bytes': self._writeq_bytes,
                    'writer_throttled': self._throttled, 'spill_paused': self._spill_paused,
                    'open_entries': len(self._entries)}

    def close(self, join_timeout_s=10):
        """Stop the writer once the queued writes are on disk."""
        with self._lock:
            self._stopping = True
            writer, q = self._writer, self._writeq
            self._writer = None
        joined = True
        if writer is not None and writer.is_alive():
            q.put(_STOP)
            writer.join(timeout=join_timeout_s)
            joined = not writer.is_alive()
        if joined:
            # Re-armed only once the old writer is gone.
            with self._lock:
                self._stopping = False
        else:
            logger.warning('chunk store writer still alive after close(); the store stays '
                           'write-disabled')

    def cleanup(self):
        self.close()
        if self._do_cleanup:
            shutil.rmtree(self._path, ignore_errors=True)
