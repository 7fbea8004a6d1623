"""Batch provenance: records, a crash-tolerant ledger, and single-batch replay.

Counterpart of ``petastorm_tpu/lineage.py``.

Provenance records
    Every batch that leaves :class:`~petastorm_tpu_torch.loader.TorchLoader`
    armed with ``lineage=`` gets a JSON-safe record: a monotonic
    ``batch_id``, the ordered **segments** composing it (Parquet file,
    row-group, row range, producing worker, serving tier ``decode`` or
    ``memory``), the reader's shuffle state, and a per-field CRC32 digest
    of the assembled host batch, taken before its copy to the device.
    Workers attach each chunk's segment when they publish it; a FIFO
    :class:`LineageCollector` inside the loader's batch assembly folds the
    segments into batches.

Ledger
    Records spill to a bounded JSONL file (:class:`LineageLedger`): a
    header line with the reader's context, then a line per batch, written
    line-buffered by a write-behind thread whose bounded queue drops on
    overflow (counted in ``dropped``), so delivery never waits on the disk.
    A killed process leaves at most one torn last line, which
    :func:`read_ledger_file` skips. ``PSTT_LINEAGE_DIR`` arms the ledger of
    every loader built with ``lineage=None``.

Ring
    The last records stay in memory; live trackers register in a
    process-wide registry (:func:`live_rings`).

Replay
    :func:`replay_record` re-reads exactly the recorded row-group spans
    through the port's own decoders and dtype rule
    (``loader._sanitize_array``, which keeps int64) and :func:`verify_record`
    checks the result against the record's digest bit for bit.

A row-level shuffling buffer or shape policies make records inexact, and
replay refuses them. Under the memory governor's degrade rung the ledger
spill is shed (the ring keeps every record; each shed one is counted in
``pressure_dropped``). Not ported (ROADMAP §A9): the metrics counters and
the flight recorder's dump of the rings; the replay command line.
"""

import glob
import json
import logging
import os
import queue
import tempfile
import threading
import time
import uuid
import weakref
import zlib
from collections import deque

import numpy as np

from petastorm_tpu_torch import membudget

logger = logging.getLogger(__name__)

#: Directory that arms the ledger of every loader built with ``lineage=None``.
ENV_VAR = 'PSTT_LINEAGE_DIR'
#: Prefix of the temporary ledger directories made for ``lineage=True``.
TEMP_DIR_PREFIX = 'pstt-lineage-'

_HEADER_KEY = '__pst_lineage_ledger__'
LEDGER_GLOB = 'ledger-*.jsonl'
RECORD_VERSION = 1
WRITER_THREAD_NAME = 'pstt-lineage-writer'


def lineage_enabled(explicit=None):
    """``explicit`` when not None (a path or True arms, False disarms),
    else whether ``PSTT_LINEAGE_DIR`` is set."""
    if explicit is not None:
        return bool(explicit)
    return bool(os.environ.get(ENV_VAR, '').strip())


def resolve_ledger_dir(explicit=None):
    """An explicit path, else ``PSTT_LINEAGE_DIR``, else a fresh temporary
    directory."""
    if isinstance(explicit, str) and explicit:
        return explicit
    env = os.environ.get(ENV_VAR, '').strip()
    if env:
        return env
    return tempfile.mkdtemp(prefix=TEMP_DIR_PREFIX)


def chunk_lineage(piece, piece_index, shuffle_row_drop_partition, n_rows, tier,
                  permuted=False, filtered=False, worker_id=None):
    """The segment a worker attaches to one published chunk. ``row_start``
    is the first delivered row within the chunk as published (a resume skip
    advances it); ``chunk_rows`` is the published length."""
    drop = None
    if shuffle_row_drop_partition is not None and shuffle_row_drop_partition[1] > 1:
        drop = [int(shuffle_row_drop_partition[0]), int(shuffle_row_drop_partition[1])]
    return {'path': str(piece.path), 'row_group': int(piece.row_group),
            'piece_index': int(piece_index), 'drop': drop, 'chunk_rows': int(n_rows),
            'row_start': 0, 'worker_pid': os.getpid(), 'worker_id': worker_id, 'tier': tier,
            'permuted': bool(permuted), 'filtered': bool(filtered)}


def _digest_array(arr):
    """CRC32 of an array's bytes in C order (object arrays: of their cells'
    contents, in order)."""
    arr = np.asarray(arr)
    if arr.dtype.kind == 'O':
        crc = 0
        for cell in arr.ravel():
            if isinstance(cell, (bytes, bytearray, memoryview)):
                crc = zlib.crc32(cell, crc)
            else:
                crc = zlib.crc32(np.ascontiguousarray(cell), crc)
        return crc & 0xFFFFFFFF
    arr = np.ascontiguousarray(arr)
    return zlib.crc32(arr.view(np.uint8) if arr.dtype.kind in ('M', 'm') else arr) & 0xFFFFFFFF


class LineageCollector(object):
    """FIFO row accounting from delivered chunks to emitted batches.

    The loader's assembly consumes chunks in delivery order (the block path
    slices them FIFO, the per-row path appends rows FIFO), so
    :meth:`on_chunk` pushes each chunk's segment with its row count and
    :meth:`on_batch` pops the spans covering a batch. A row-level shuffling
    buffer breaks the FIFO: :meth:`mark_inexact` flags later records. All
    calls come from the thread that drives the host-batch iterator.
    """

    def __init__(self, tracker, digest=True):
        self._tracker = tracker
        self._digest = digest
        self._fifo = deque()      # [segment, consumed offset, remaining]
        self._inexact = False

    def mark_inexact(self):
        self._inexact = True

    def on_chunk(self, segment, n_rows):
        """A chunk (or row) of ``n_rows`` arrived; ``segment`` None marks the
        record inexact."""
        if n_rows <= 0:
            return
        if segment is None:
            self._inexact = True
            segment = {'unknown': True, 'row_start': 0, 'chunk_rows': int(n_rows)}
        if self._fifo:
            tail = self._fifo[-1]
            if self._coalesces(tail, segment):
                tail[2] += n_rows
                tail[0]['chunk_rows'] = max(tail[0].get('chunk_rows', 0),
                                            segment.get('row_start', 0) + n_rows)
                return
        self._fifo.append([dict(segment), 0, int(n_rows)])

    @staticmethod
    def _coalesces(tail, segment):
        """Consecutive rows of one chunk (per-row readers) merge into one span."""
        prev = tail[0]
        if prev.get('unknown') or segment.get('unknown'):
            return bool(prev.get('unknown')) and bool(segment.get('unknown'))
        if (prev.get('path') != segment.get('path')
                or prev.get('row_group') != segment.get('row_group')
                or prev.get('drop') != segment.get('drop')):
            return False
        return prev.get('row_start', 0) + tail[1] + tail[2] == segment.get('row_start', 0)

    def on_batch(self, n_rows, batch=None, padded=0):
        """A batch of ``n_rows`` source rows (and ``padded`` repeated rows)
        is emitted: pop its spans, digest it, queue its pending entry."""
        segments = []
        need = int(n_rows)
        while need > 0 and self._fifo:
            entry = self._fifo[0]
            segment, offset, remaining = entry
            take = min(need, remaining)
            span = dict(segment)
            base = span.pop('row_start', 0) + offset
            span['row_start'] = base
            span['row_stop'] = base + take
            segments.append(span)
            entry[1] += take
            entry[2] -= take
            if entry[2] == 0:
                self._fifo.popleft()
            need -= take
        exact = (not self._inexact and need == 0
                 and not any(s.get('unknown') or s.get('filtered') for s in segments))
        digest = None
        if self._digest and batch is not None:
            digest = {name: _digest_array(arr) for name, arr in batch.items()}
        self._tracker._push_pending({
            'rows': int(n_rows) + int(padded), 'source_rows': int(n_rows),
            'padded': int(padded), 'segments': segments, 'exact': exact,
            'fields': sorted(batch) if batch is not None else None, 'digest': digest})


_live_trackers = weakref.WeakSet()
_live_lock = threading.Lock()


def live_rings():
    """``[{'ctx', 'records', 'in_flight'}]`` of every live tracker."""
    with _live_lock:
        trackers = list(_live_trackers)
    return [{'ctx': t.ctx, 'records': t.ring(), 'in_flight': t.pending_snapshot()}
            for t in trackers]


class LineageTracker(object):
    """One pipeline's provenance: collector -> pending queue -> a record per
    delivery -> ring and ledger.

    :param ctx: the reader's JSON-safe context (``Reader.lineage_context``
        plus the loader's batch settings), the ledger's header.
    :param ledger_dir: the JSONL ledger's directory; None keeps the ring only.
    :param ring_size: records kept in memory.
    :param digest: per-field CRC32 digests of each batch.
    :param state_fn: ``() -> dict`` sampled into each record (the reader's
        shuffle state).
    :param max_records: the ledger's line bound (past it records are dropped).
    :param queue_size: the write-behind queue's bound (overflow drops).
    """

    def __init__(self, ctx, ledger_dir=None, ring_size=128, digest=True, state_fn=None,
                 max_records=1000000, queue_size=1024):
        self.ctx = dict(ctx or {})
        self._state_fn = state_fn
        self._lock = threading.Lock()
        self._pending = deque()
        self._ring = deque(maxlen=ring_size)
        self._next_batch_id = 0
        self.records = 0
        self.dropped = 0
        self.pressure_dropped = 0   # records the memory governor shed
        self._pressure_shed = False
        self.collector = LineageCollector(self, digest=digest)
        self._ledger = (LineageLedger(ledger_dir, self.ctx, max_records=max_records,
                                      queue_size=queue_size)
                        if ledger_dir is not None else None)
        # The governor's lineage-queue pool: under degrade the ledger spill
        # is shed, each record counted in pressure_dropped.
        self._mem_handle = membudget.register_pool(
            'lineage-queue', self.queued_nbytes,
            degrade_fn=lambda: self.set_pressure_shedding(True),
            degrade_release_fn=lambda: self.set_pressure_shedding(False))
        with _live_lock:
            _live_trackers.add(self)

    def _push_pending(self, entry):
        with self._lock:
            self._pending.append(entry)

    def deliver(self):
        """A fresh batch reached the consumer: mint its record (FIFO against
        the assembly), append it to ring and ledger, return it (None without
        a pending entry)."""
        with self._lock:
            if not self._pending:
                return None
            entry = self._pending.popleft()
            batch_id = self._next_batch_id
            self._next_batch_id += 1
        record = {'v': RECORD_VERSION, 'batch_id': batch_id, 'wall_time': time.time(),
                  'pid': os.getpid()}
        record.update(entry)
        if self._state_fn is not None:
            record['shuffle'] = self._state_fn()
        with self._lock:
            self._ring.append(record)
            self.records += 1
        if self._ledger is not None:
            if self._pressure_shed:
                with self._lock:
                    self.dropped += 1
                    self.pressure_dropped += 1
            elif not self._ledger.append(record):
                with self._lock:
                    self.dropped += 1
        return record

    def set_pressure_shedding(self, shed):
        """The governor's degrade hook: while True, delivered batches still
        get ring records but the ledger spill is shed, each skipped record
        counted in ``pressure_dropped`` and ``dropped``. True when the flag
        flipped."""
        shed = bool(shed)
        with self._lock:
            changed = shed != self._pressure_shed
            self._pressure_shed = shed
        if changed:
            logger.warning('lineage ledger spill %s under memory pressure',
                           'shed' if shed else 'restored')
        return changed

    def queued_nbytes(self):
        """Estimated bytes waiting in the ledger's write-behind queue."""
        return self._ledger.queued_nbytes() if self._ledger is not None else 0

    def ring(self):
        with self._lock:
            return list(self._ring)

    def pending_snapshot(self):
        """Batches assembled but not delivered yet."""
        with self._lock:
            return [dict(e) for e in self._pending]

    @property
    def ledger_path(self):
        return self._ledger.path if self._ledger is not None else None

    def stats(self):
        with self._lock:
            out = {'records': self.records, 'dropped': self.dropped,
                   'pressure_dropped': self.pressure_dropped,
                   'pending': len(self._pending), 'ring': len(self._ring)}
        if self._ledger is not None:
            out['dropped'] += self._ledger.dropped
            out['ledger_path'] = self._ledger.path
            out['ledger_lag'] = self._ledger.lag
        return out

    def flush(self, timeout_s=5.0):
        return self._ledger.flush(timeout_s) if self._ledger is not None else True

    def close(self):
        self._mem_handle.close()
        with _live_lock:
            _live_trackers.discard(self)
        if self._ledger is not None:
            self._ledger.close()


class LineageLedger(object):
    """Bounded, crash-tolerant JSONL spill of records: ``ledger-<pid>-<uid>
    .jsonl``, a header line with the context, then a line per record,
    written line-buffered by a daemon thread. The queue drops on overflow;
    ``max_records`` bounds the file."""

    def __init__(self, directory, ctx, max_records=1000000, queue_size=1024):
        self.directory = directory
        self.path = None
        self._max_records = int(max_records)
        self._accepted = 0
        self._written = 0
        self.dropped = 0        # accepted but never written
        self._failed = False
        self._closed = False
        self._file = None
        self._record_bytes_ema = 0.0   # serialized size, kept by the writer
        self._queue = queue.Queue(maxsize=max(1, int(queue_size)))
        try:
            os.makedirs(directory, exist_ok=True)
            self.path = os.path.join(directory, 'ledger-{}-{}.jsonl'.format(
                os.getpid(), uuid.uuid4().hex[:8]))
            # One flush a line: whole lines survive a SIGKILL.
            self._file = open(self.path, 'w', buffering=1)
            self._file.write(json.dumps({_HEADER_KEY: 1, 'pid': os.getpid(),
                                         'wall0': time.time(), 'ctx': ctx}) + '\n')
        except (OSError, TypeError, ValueError):
            logger.warning('cannot open lineage ledger in %r; disabling spill', directory,
                           exc_info=True)
            self._failed = True
        self._thread = threading.Thread(target=self._drain, daemon=True,
                                        name=WRITER_THREAD_NAME)
        if not self._failed:
            self._thread.start()

    @property
    def lag(self):
        return self._queue.qsize()

    def queued_nbytes(self):
        """Estimated queued bytes: depth x the serialized size's average."""
        return int(self._queue.qsize() * self._record_bytes_ema)

    def append(self, record):
        """Queue one record; False when it was dropped (closed, failed,
        full, or past the line bound)."""
        if self._failed or self._closed or self._accepted >= self._max_records:
            return False
        try:
            self._queue.put_nowait(record)
        except queue.Full:
            return False
        self._accepted += 1
        return True

    def _drain(self):
        while True:
            record = self._queue.get()
            try:
                if record is None:
                    return
                if self._failed or self._written >= self._max_records:
                    self.dropped += 1
                    continue
                try:
                    line = json.dumps(record, default=repr) + '\n'
                    self._record_bytes_ema += 0.2 * (len(line) - self._record_bytes_ema)
                    self._file.write(line)
                    self._written += 1
                except (OSError, ValueError):
                    logger.warning('lineage ledger write failed; disabling', exc_info=True)
                    self._failed = True
                    self.dropped += 1
            finally:
                self._queue.task_done()

    def flush(self, timeout_s=5.0):
        """Wait until every accepted record is written; False on timeout."""
        deadline = time.monotonic() + timeout_s
        while (not self._failed and self._written < self._accepted
               and time.monotonic() < deadline):
            time.sleep(0.01)
        return not self._failed and self._written >= self._accepted

    def close(self, join_timeout_s=5.0):
        self._closed = True     # later appends count as dropped
        if self._thread.is_alive():
            try:
                self._queue.put(None, timeout=join_timeout_s)
            except queue.Full:
                pass
            self._thread.join(timeout=join_timeout_s)
        f, self._file = self._file, None
        if f is not None:
            f.close()


# --------------------------------------------------------------------------
# reading ledgers
# --------------------------------------------------------------------------

def read_ledger_file(path):
    """``(ctx or None, [records])`` of one ledger; torn or corrupt lines are
    skipped."""
    ctx = None
    records = []
    with open(path, 'r') as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                record = json.loads(line)
            except ValueError:
                continue
            if not isinstance(record, dict):
                continue
            if record.get(_HEADER_KEY):
                ctx = record.get('ctx')
            else:
                records.append(record)
    return ctx, records


def read_ledger_dir(directory):
    """Every ledger under ``directory`` as ``[(path, ctx, records)]``."""
    out = []
    for path in sorted(glob.glob(os.path.join(directory, LEDGER_GLOB))):
        ctx, records = read_ledger_file(path)
        if ctx is not None or records:
            out.append((path, ctx, records))
    return out


def find_record(directory, batch_id, pid=None):
    """``(ctx, record)`` of one batch in a ledger directory; ``LookupError``
    naming what exists when it is absent or ambiguous (pass ``pid``)."""
    ledgers = read_ledger_dir(directory)
    matches = [(ctx, record) for _, ctx, records in ledgers for record in records
               if record.get('batch_id') == batch_id and (pid is None or record.get('pid') == pid)]
    if not matches:
        available = ['{}: batch ids {}..{} ({} records)'.format(
            os.path.basename(path), min(ids), max(ids), len(ids))
            for path, _, records in ledgers
            for ids in [[r.get('batch_id') for r in records]] if ids]
        raise LookupError('batch_id {} not found under {!r}. Ledgers present: {}'.format(
            batch_id, directory, '; '.join(available) or 'none'))
    if len(matches) > 1:
        raise LookupError(
            'batch_id {} is ambiguous under {!r} ({} ledgers match); pass the producing pid '
            '(candidates: {})'.format(batch_id, directory, len(matches),
                                      sorted({record.get('pid') for _, record in matches})))
    return matches[0]


# --------------------------------------------------------------------------
# replay
# --------------------------------------------------------------------------

class ReplayError(RuntimeError):
    """A record cannot be re-materialized exactly."""


class ReplayMismatchError(ReplayError):
    """The replayed bytes differ from the record's digest."""


def _check_replayable(ctx, record):
    if ctx is None:
        raise ReplayError('record has no reader context (ledger header missing or torn)')
    if not record.get('exact', False):
        raise ReplayError('record {} is not exact (shuffling buffer, or a reader without '
                          'lineage); replay would not be bit-identical'.format(
                              record.get('batch_id')))
    if ctx.get('shape_policies'):
        raise ReplayError('record was produced under shape policies {}; replay cannot '
                          'reconstruct them'.format(ctx['shape_policies']))
    if ctx.get('mode') not in ('tensor', 'py_dict'):
        raise ReplayError('unsupported reader mode {!r}'.format(ctx.get('mode')))


def _replay_segment(stored_schema, ctx, segment, fields, pieces):
    """One segment's rows as column blocks, decoded and sanitized as the
    loader delivered them."""
    import pyarrow.parquet as pq

    from petastorm_tpu_torch.loader import _sanitize_array
    from petastorm_tpu_torch.py_dict_worker import decode_table_to_rows
    from petastorm_tpu_torch.tensor_worker import decode_table_to_blocks

    if segment.get('permuted'):
        raise ReplayError('in-chunk row permutation is not ported')
    piece = pieces.get((str(segment['path']), int(segment['row_group'])))
    if piece is None:
        raise ReplayError('row-group {} of {} no longer exists in the dataset at {}'.format(
            segment['row_group'], segment['path'], ctx.get('url')))
    names = [f for f in ctx.get('fields') or fields if f in stored_schema.fields]
    view = stored_schema.create_schema_view(names) if names else stored_schema
    with pq.ParquetFile(str(piece.path), memory_map=True) as pf:
        table = pf.read_row_group(piece.row_group, columns=list(view.fields))
    if ctx.get('mode') == 'tensor':
        cols = decode_table_to_blocks(table, view)
    else:
        rows = decode_table_to_rows(table, view)
        cols = {name: np.asarray([row[name] for row in rows]) for name in view.fields}
    n_rows = table.num_rows
    drop = segment.get('drop')
    if drop:
        from petastorm_tpu_torch.workers.rowgroup_worker_base import compute_row_slice
        start, stop = compute_row_slice(n_rows, (drop[0], drop[1]))
        cols = {k: v[start:stop] for k, v in cols.items()}
        n_rows = stop - start
    if segment.get('chunk_rows') is not None and n_rows != segment['chunk_rows']:
        raise ReplayError('row-group {} of {} now decodes to {} rows; the record says {}'.format(
            segment['row_group'], segment['path'], n_rows, segment['chunk_rows']))
    out = {}
    for name in fields:
        if name not in cols:
            raise ReplayError('field {!r} is no longer readable from the dataset'.format(name))
        arr = _sanitize_array(cols[name][segment['row_start']:segment['row_stop']])
        if arr is None:
            raise ReplayError('field {!r} cannot batch as the loader did'.format(name))
        out[name] = arr
    return out


def replay_record(record, ctx):
    """The recorded batch re-materialized: ``{field: np.ndarray}`` with the
    bytes the loader assembled (before the device copy)."""
    from petastorm_tpu_torch.etl.dataset_metadata import get_schema
    from petastorm_tpu_torch.storage import ParquetStore

    _check_replayable(ctx, record)
    fields = record.get('fields')
    if not fields:
        raise ReplayError('record carries no field list')
    if ctx.get('url') is None:
        raise ReplayError('record context carries no dataset url')
    store = ParquetStore(ctx['url'])
    schema = get_schema(store)
    pieces = {(str(p.path), int(p.row_group)): p for p in store.row_groups()}
    parts = [_replay_segment(schema, ctx, segment, fields, pieces)
             for segment in record.get('segments') or []]
    if not parts:
        raise ReplayError('record {} has no segments'.format(record.get('batch_id')))
    batch = {name: (parts[0][name] if len(parts) == 1
                    else np.concatenate([p[name] for p in parts])) for name in fields}
    padded = int(record.get('padded') or 0)
    if padded:      # repeat the last row, as last_batch='pad' does
        batch = {name: np.concatenate([arr] + [arr[-1:]] * padded) for name, arr in batch.items()}
    rows = int(record.get('rows', 0))
    got = len(next(iter(batch.values())))
    if rows and got != rows:
        raise ReplayError('replay produced {} rows, record says {}'.format(got, rows))
    return batch


def verify_record(record, ctx):
    """:func:`replay_record` and a digest check: the replayed batch, or
    :class:`ReplayMismatchError` naming the fields whose bytes differ."""
    batch = replay_record(record, ctx)
    digest = record.get('digest')
    if not digest:
        raise ReplayError('record {} carries no content digest; replay succeeded but cannot be '
                          'verified'.format(record.get('batch_id')))
    bad = ['{} (recorded {:#010x}, replayed {:#010x})'.format(name, int(digest[name]),
                                                               _digest_array(arr))
           for name, arr in batch.items()
           if digest.get(name) is not None and int(digest[name]) != _digest_array(arr)]
    if bad:
        raise ReplayMismatchError('replayed batch {} differs from the live batch: {}'.format(
            record.get('batch_id'), ', '.join(bad)))
    return batch
