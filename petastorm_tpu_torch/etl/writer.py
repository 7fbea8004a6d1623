"""Pyarrow dataset writer: encode rows via codecs into Parquet row-groups.

Counterpart of ``petastorm_tpu/etl/writer.py:30-202``, trimmed to
unpartitioned local stores with an explicit ``rows_per_row_group``. On close
it writes the ``_metadata`` summary footer and the ``_common_metadata``
schema JSON and row-group index, in the JAX package's layout.
"""

import json
import os
import tempfile

import pyarrow as pa
import pyarrow.parquet as pq

from petastorm_tpu_torch.storage import NUM_ROW_GROUPS_KEY, UNISCHEMA_KEY, ParquetStore
from petastorm_tpu_torch.unischema import encode_row


class DatasetWriter(object):
    """Writes encoded rows into one Parquet file of a local store::

        with DatasetWriter('file:///tmp/ds', schema, rows_per_row_group=100) as w:
            for row in rows:
                w.write(row)   # row: dict of user-facing values
    """

    def __init__(self, dataset_url, schema, rows_per_row_group=256):
        if rows_per_row_group < 1:
            raise ValueError('rows_per_row_group must be >= 1, got {}'.format(rows_per_row_group))
        self._store = ParquetStore(dataset_url)
        self._schema = schema
        self._rows_per_row_group = int(rows_per_row_group)
        self._arrow_schema = schema.arrow_schema()
        self._buffer = []
        os.makedirs(self._store.path, exist_ok=True)
        self._file_path = os.path.join(self._store.path, 'part-00000-00000.parquet')
        self._writer = pq.ParquetWriter(self._file_path, self._arrow_schema, compression='snappy')
        self._closed = False

    def write(self, row_dict):
        self._buffer.append(encode_row(self._schema, row_dict))
        if len(self._buffer) >= self._rows_per_row_group:
            self._flush()

    def _flush(self):
        if not self._buffer:
            return
        rows, self._buffer = self._buffer, []
        columns = {f.name: pa.array([r[f.name] for r in rows], type=f.type)
                   for f in self._arrow_schema}
        self._writer.write_table(pa.Table.from_pydict(columns, schema=self._arrow_schema))

    def close(self):
        if self._closed:
            return
        self._closed = True
        self._flush()
        self._writer.close()
        md = pq.read_metadata(self._file_path)
        md.set_file_path(os.path.relpath(self._file_path, self._store.path))
        # pq.write_metadata re-reads its sink when given a collector: write
        # to a temp file, then move it into the store.
        with tempfile.NamedTemporaryFile(prefix='_', suffix='.parquet', dir=self._store.path,
                                         delete=False) as tmp:
            tmp_name = tmp.name
        pq.write_metadata(self._arrow_schema, tmp_name, metadata_collector=[md])
        os.replace(tmp_name, os.path.join(self._store.path, '_metadata'))
        self._store.write_common_metadata(self._arrow_schema, {
            UNISCHEMA_KEY: json.dumps(self._schema.to_json()),
            NUM_ROW_GROUPS_KEY: json.dumps(self._store.num_row_groups_per_file()),
        })

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        else:
            self._writer.close()
        return False


def write_dataset(dataset_url, schema, rows, rows_per_row_group=256):
    """One-shot convenience: write an iterable of row dicts as a dataset."""
    with DatasetWriter(dataset_url, schema, rows_per_row_group=rows_per_row_group) as writer:
        for row in rows:
            writer.write(row)
