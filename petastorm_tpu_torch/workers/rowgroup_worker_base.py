"""Row-group worker base: one open ``pq.ParquetFile`` per data file, read
row-group by row-group (counterpart of
``petastorm_tpu/workers/rowgroup_worker_base.py:24-198`` without the native
Parquet reader, predicates and faults).

``chunk_row_permutation`` (``shuffle_rows_in_chunk``) is not ported
(ROADMAP §A9): a reader asked for it raises.
"""

import pyarrow.parquet as pq

from petastorm_tpu_torch.determinism import hole_marker
from petastorm_tpu_torch.workers import WorkerBase


class RowGroupWorkerBase(WorkerBase):
    """``args``: ``row_groups`` (list of RowGroupPiece) and ``schema`` (the
    reader's view)."""

    def __init__(self, worker_id, publish_func, args):
        super().__init__(worker_id, publish_func, args)
        self._files = {}

    def _read_row_group(self, piece, columns):
        pf = self._files.get(piece.path)
        if pf is None:
            pf = self._files[piece.path] = pq.ParquetFile(piece.path)
        return pf.read_row_group(piece.row_group, columns=columns)

    def _publish_hole(self, pst_det):
        """Deterministic mode: an item that made no chunk still publishes a
        marker with its ``pst_det`` tag, so the resequencer passes it."""
        if pst_det is not None:
            self.publish_func(hole_marker(pst_det))

    def shutdown(self):
        for pf in self._files.values():
            pf.close()
        self._files = {}


def compute_row_slice(num_rows, shuffle_row_drop_partition):
    """``(start, stop)`` of one drop-partition of a row-group, or None when
    the whole range is kept."""
    if shuffle_row_drop_partition is None:
        return None
    this_partition, num_partitions = shuffle_row_drop_partition
    if num_partitions <= 1:
        return None
    bounds = [int(round(i * num_rows / num_partitions)) for i in range(num_partitions + 1)]
    return bounds[this_partition], bounds[this_partition + 1]
