"""Row-group worker base: row-groups read one at a time through an open
handle per data file, the drop-partition slice and the in-chunk row
permutation (counterpart of ``petastorm_tpu/workers/rowgroup_worker_base.py:
24-223``).

The files are opened through the store's filesystem: ``args['store_factory']``
(the reader's picklable ``_StoreFactory``) builds the worker's
:class:`~petastorm_tpu_torch.storage.ParquetStore` at its first read. A
local (``file``) store hands pyarrow the operating-system path; any other
store (``memory://``, an object store, HDFS) an fsspec file object. A
columnar worker (the tensor worker) of a local store reads through the
native C++ Parquet stage (:mod:`~petastorm_tpu_torch.native.parquet`) when
it builds, as the JAX package chooses it (``:58-82``): the stage opens
operating-system paths, so any other store reads through pyarrow. The
per-row worker keeps pyarrow (``_prefer_native_parquet``). A stage that did
not build, or a read it fails, leaves pyarrow.

Each read passes the ``fs-read-delay`` and ``fs-read-error`` fault sites,
keyed by :func:`~petastorm_tpu_torch.faults.rowgroup_fault_key` (``:108-111``),
inside a ``read`` span of the process's global tracer (``:103-104``).

A piece's hive partition values are not stored in its file:
:meth:`RowGroupWorkerBase._read_fields` reads the other fields and appends
a constant column for each partition field asked for.
"""

import hashlib
import logging

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from petastorm_tpu_torch import decode_budget
from petastorm_tpu_torch.determinism import hole_marker
from petastorm_tpu_torch.faults import maybe_inject, rowgroup_fault_key
from petastorm_tpu_torch.trace import get_global_tracer
from petastorm_tpu_torch.workers import WorkerBase

logger = logging.getLogger(__name__)


class RowGroupWorkerBase(WorkerBase):
    """``args``: ``row_groups`` (list of RowGroupPiece), ``schema`` (the
    reader's view), ``store_factory`` (a zero-argument callable giving
    the store's :class:`~petastorm_tpu_torch.storage.ParquetStore`) and
    ``decode_threads``: None in an in-process pool (each decode takes its
    live share of the process's budget), or a process pool worker's static
    share, which becomes its own process's whole budget
    (``petastorm_tpu/reader.py:785-800``)."""

    #: Whether this worker class reads through the native stage: a columnar
    #: worker gains from its export without a copy; the per-row worker
    #: turns columns into Python rows anyway.
    _prefer_native_parquet = True

    def __init__(self, worker_id, publish_func, args):
        super().__init__(worker_id, publish_func, args)
        decode_threads = args.get('decode_threads')
        if decode_threads is not None:
            decode_budget.set_budget(decode_budget.DecodeThreadBudget(total=decode_threads))
        self._files = {}
        self._store = None           # built at the first read
        self._native = None          # resolved at the first read
        self._leaf_indices = {}

    @property
    def store(self):
        if self._store is None:
            self._store = self.args['store_factory']()
        return self._store

    def _native_enabled(self):
        if self._native is None:
            self._native = False
            if self._prefer_native_parquet and self.store.is_local:
                from petastorm_tpu_torch.native import parquet as native_pq
                self._native = native_pq.is_available()
        return self._native

    def _read_row_group(self, piece, columns):
        """One row-group as a ``pa.Table`` of ``columns``, in that order."""
        with get_global_tracer().span('read', 'worker'):
            return self._read_row_group_traced(piece, columns)

    def _read_row_group_traced(self, piece, columns):
        fault_key = rowgroup_fault_key(piece.path, piece.row_group)
        maybe_inject('fs-read-delay', key=fault_key)
        maybe_inject('fs-read-error', key=fault_key)
        if self._native_enabled():
            from petastorm_tpu_torch.native import parquet as native_pq
            key = (piece.path, tuple(columns))
            if key not in self._leaf_indices:
                # None for a nested column: that read takes pyarrow.
                self._leaf_indices[key] = native_pq.leaf_indices_for_fields(
                    self._file(piece.path).schema, columns)
            indices = self._leaf_indices[key]
            if indices is not None:
                try:
                    batch = self._file(piece.path, native=True).read_row_group(
                        piece.row_group, columns=indices)
                    # Columns come in leaf order; restore the request's.
                    return pa.Table.from_batches([batch]).select(columns)
                except native_pq.NativeParquetError as e:
                    logger.warning('native row-group read failed (%s); falling back to pyarrow',
                                   e)
                    self._native = False
        return self._file(piece.path).read_row_group(piece.row_group, columns=columns)

    def _read_fields(self, piece, names):
        """The row-group's ``names`` as a ``pa.Table``: the stored columns
        read, then the piece's partition values appended."""
        stored = [n for n in names if n not in piece.partition_values]
        return with_partition_columns(self._read_row_group(piece, stored), piece, names)

    def _file(self, path, native=False):
        """The open handle of ``path``: a ``pq.ParquetFile`` (over the OS path
        of a local store, else over the store's file object) or
        (``native``) a ``NativeParquetFile``, opened once a worker."""
        key = (path, native)
        handle = self._files.get(key)
        if handle is None:
            if native:
                from petastorm_tpu_torch.native import parquet as native_pq
                handle = native_pq.NativeParquetFile(path)
            elif self.store.is_local:
                handle = pq.ParquetFile(path)
            else:
                handle = _RemoteParquetFile(self.store.open_file(path))
            self._files[key] = handle
        return handle

    def _publish_hole(self, pst_det):
        """Deterministic mode: an item that made no chunk still publishes a
        marker with its ``pst_det`` tag, so the resequencer passes it."""
        if pst_det is not None:
            self.publish_func(hole_marker(pst_det))

    def shutdown(self):
        for handle in self._files.values():
            handle.close()
        self._files = {}


class _RemoteParquetFile(pq.ParquetFile):
    """A ``pq.ParquetFile`` over a file object of the store's filesystem,
    which it closes with itself."""

    def __init__(self, fobj):
        super().__init__(fobj)
        self._fobj = fobj

    def close(self, force=False):
        super().close(force=force)
        self._fobj.close()


def with_partition_columns(table, piece, names):
    """``table`` with a constant column for each of ``names`` that is one of
    ``piece``'s partition keys and not a column yet."""
    for name, value in piece.partition_values.items():
        if name in names and name not in table.column_names:
            table = table.append_column(name, pa.array([value] * table.num_rows))
    return table


def compute_row_slice(num_rows, shuffle_row_drop_partition, ngram=None):
    """``(start, stop)`` of one drop-partition of a row-group, or None when
    the whole range is kept. With an NGram the slice reaches ``length - 1``
    rows into the next partition, so the windows across the cut survive."""
    if shuffle_row_drop_partition is None:
        return None
    this_partition, num_partitions = shuffle_row_drop_partition
    if num_partitions <= 1:
        return None
    bounds = [int(round(i * num_rows / num_partitions)) for i in range(num_partitions + 1)]
    start, stop = bounds[this_partition], bounds[this_partition + 1]
    if ngram is not None:
        stop = min(num_rows, stop + ngram.length - 1)
    return start, stop


def chunk_row_permutation(seed, dataset_hash, piece_path, row_group, shuffle_row_drop_partition,
                          n_rows):
    """The row order of one chunk under ``shuffle_rows_in_chunk``: the same
    for a chunk in every epoch and every session, so a resume skips the same
    leading rows. The argsort of a splitmix64 hash of each row index, keyed
    by an md5 of (seed, dataset, row-group, drop partition); pure uint64
    arithmetic and a stable sort, so any numpy gives the JAX package's
    order."""
    drop_idx = shuffle_row_drop_partition[0] if shuffle_row_drop_partition else 0
    digest = hashlib.md5('{}:{}:{}:{}:{}'.format(seed, dataset_hash, piece_path, row_group,
                                                 drop_idx).encode()).digest()
    z = np.arange(n_rows, dtype=np.uint64) + np.uint64(int.from_bytes(digest[:8], 'little'))
    z = z + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    z = z ^ (z >> np.uint64(31))
    return np.argsort(z, kind='stable')
