"""Row-group worker base: one open ``pq.ParquetFile`` per data file, read
row-group by row-group (counterpart of
``petastorm_tpu/workers/rowgroup_worker_base.py:24-130`` without the native
Parquet reader, predicates, faults or lineage)."""

import pyarrow.parquet as pq

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

    def shutdown(self):
        for pf in self._files.values():
            pf.close()
        self._files = {}
