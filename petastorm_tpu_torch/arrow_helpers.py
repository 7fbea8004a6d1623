"""Arrow helpers: re-chunking tables to an exact batch size (counterpart of
``petastorm_tpu/arrow_helpers.py``)."""

from collections import deque

import pyarrow as pa


class BatchingTableQueue(object):
    """FIFO of Arrow tables that hands out tables of exactly ``batch_size``
    rows, in arrival order, as zero-copy slices of the queued record
    batches. ``put`` takes tables (or record batches) of any row count; all
    must share the first one's schema."""

    def __init__(self, batch_size):
        if batch_size < 1:
            raise ValueError('batch_size must be >= 1, got {}'.format(batch_size))
        self._batch_size = batch_size
        self._chunks = deque()   # record batches, the head possibly part consumed
        self._offset = 0         # rows of the head already handed out
        self._available = 0
        self._schema = None

    def __len__(self):
        """Rows buffered."""
        return self._available

    def empty(self):
        """True while fewer than ``batch_size`` rows are buffered."""
        return self._available < self._batch_size

    def put(self, table_or_batch):
        """Append a ``pa.Table`` or ``pa.RecordBatch``."""
        if isinstance(table_or_batch, pa.RecordBatch):
            batches = [table_or_batch]
        else:
            batches = table_or_batch.to_batches()
        schema = table_or_batch.schema
        if self._schema is None:
            self._schema = schema
        elif not schema.equals(self._schema):
            raise ValueError('Schema mismatch: queue built over {} got {}'.format(
                self._schema, schema))
        for batch in batches:
            if batch.num_rows:
                self._chunks.append(batch)
                self._available += batch.num_rows

    def get(self):
        """A ``pa.Table`` of exactly ``batch_size`` rows; raises
        ``IndexError`` when :meth:`empty`."""
        if self.empty():
            raise IndexError('BatchingTableQueue underflow: {} rows buffered, batch_size={}'.format(
                self._available, self._batch_size))
        needed = self._batch_size
        out = []
        while needed:
            head = self._chunks[0]
            remaining = head.num_rows - self._offset
            take = min(needed, remaining)
            out.append(head.slice(self._offset, take))
            needed -= take
            if take == remaining:
                self._chunks.popleft()
                self._offset = 0
            else:
                self._offset += take
        self._available -= self._batch_size
        return pa.Table.from_batches(out, schema=self._schema)
