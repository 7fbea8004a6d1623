"""Pyarrow dataset writer: encode rows via codecs into Parquet row-groups.

Counterpart of ``petastorm_tpu/etl/writer.py:30-202``, hive partitions
included, on any store the reader reads: directories and files are made
through the store's fsspec filesystem (``storage_options``: the driver's
keyword arguments). On close it writes the ``_metadata`` summary footer and
the ``_common_metadata`` schema JSON and row-group counts, in the JAX
package's layout (:func:`finalize_dataset_metadata`).
"""

import json
import logging
import posixpath
import tempfile

import pyarrow as pa
import pyarrow.parquet as pq

from petastorm_tpu_torch.storage import NUM_ROW_GROUPS_KEY, UNISCHEMA_KEY, ParquetStore
from petastorm_tpu_torch.unischema import encode_row

logger = logging.getLogger(__name__)

#: Rows a row-group when neither ``rows_per_row_group`` nor
#: ``row_group_size_mb`` is given.
DEFAULT_ROWS_PER_ROW_GROUP = 256


class DatasetWriter(object):
    """Writes encoded rows into a (hive-partitioned) store::

        with DatasetWriter('file:///tmp/ds', schema, rows_per_row_group=100) as w:
            for row in rows:
                w.write(row)   # row: dict of user-facing values

    ``row_group_size_mb`` sizes row-groups from the first 8 buffered rows'
    encoded bytes, as the JAX writer does; ``partition_fields`` (scalar
    fields) become ``name=value`` directories, one file each.
    """

    def __init__(self, dataset_url, schema, rows_per_row_group=None, row_group_size_mb=None,
                 partition_fields=(), storage_options=None):
        if rows_per_row_group is not None and rows_per_row_group < 1:
            raise ValueError('rows_per_row_group must be >= 1, got {}'.format(rows_per_row_group))
        if rows_per_row_group is None and row_group_size_mb is None:
            rows_per_row_group = DEFAULT_ROWS_PER_ROW_GROUP
        self._store = ParquetStore(dataset_url, storage_options)
        self._schema = schema
        self._partition_fields = tuple(partition_fields)
        for name in self._partition_fields:
            if name not in schema.fields:
                raise ValueError('Partition field {!r} not in schema'.format(name))
            if not schema.fields[name].is_scalar:
                raise ValueError('Partition field {!r} must be scalar'.format(name))
        self._rows_per_row_group = rows_per_row_group
        self._row_group_size_mb = row_group_size_mb
        self._arrow_schema = schema.arrow_schema(self._partition_fields)
        self._buffers = {}      # partition values -> encoded rows
        self._writers = {}      # partition values -> (pq.ParquetWriter, file path, sink)
        self._closed = False
        self._store.fs.makedirs(self._store.path, exist_ok=True)

    def write(self, row_dict):
        encoded = encode_row(self._schema, row_dict)
        key = tuple(encoded.pop(name) for name in self._partition_fields)
        buf = self._buffers.setdefault(key, [])
        buf.append(encoded)
        if len(buf) >= self._rows_per_group(buf):
            self._flush(key)

    def _rows_per_group(self, sample_rows):
        if self._rows_per_row_group is None:
            if len(sample_rows) < 8:
                return 8        # a sample to estimate the row size from
            total = sum(len(v) if isinstance(v, (bytes, bytearray, str)) else 8
                        for row in sample_rows for v in row.values())
            avg = max(1, total // len(sample_rows))
            self._rows_per_row_group = max(1, self._row_group_size_mb * 1024 * 1024 // avg)
        return self._rows_per_row_group

    def _flush(self, key):
        rows = self._buffers.get(key)
        if not rows:
            return
        self._buffers[key] = []
        columns = {f.name: pa.array([r[f.name] for r in rows], type=f.type)
                   for f in self._arrow_schema}
        writer = self._writers.get(key)
        if writer is None:
            directory = posixpath.join(self._store.path, *(
                '{}={}'.format(name, value) for name, value in zip(self._partition_fields, key)))
            self._store.fs.makedirs(directory, exist_ok=True)
            path = posixpath.join(directory,
                                  'part-00000-{:05d}.parquet'.format(len(self._writers)))
            sink = self._store.fs.open(path, 'wb')
            writer = (pq.ParquetWriter(sink, self._arrow_schema, compression='snappy'), path, sink)
            self._writers[key] = writer
        writer[0].write_table(pa.Table.from_pydict(columns, schema=self._arrow_schema))

    def close(self):
        if self._closed:
            return
        self._closed = True
        for key in list(self._buffers):
            self._flush(key)
        collector = []
        for pq_writer, path, sink in self._writers.values():
            pq_writer.close()
            sink.close()
            with self._store.fs.open(path, 'rb') as f:
                md = pq.read_metadata(f)
            md.set_file_path(posixpath.relpath(path, self._store.path))
            collector.append(md)
        finalize_dataset_metadata(self._store, self._schema, collector, self._partition_fields)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        else:
            for pq_writer, _, sink in self._writers.values():
                pq_writer.close()
                sink.close()
        return False


def finalize_dataset_metadata(store, schema, metadata_collector=None, partition_fields=()):
    """Write the ``_metadata`` summary (when given the files' footers) and
    ``_common_metadata``: the schema JSON and the row-group counts
    (``petastorm_tpu/etl/writer.py:170-190``)."""
    arrow_schema = schema.arrow_schema(partition_fields)
    if metadata_collector:
        # pq.write_metadata re-reads its sink when given a collector: write
        # to a local temp file, then put it into the store.
        with tempfile.NamedTemporaryFile(suffix='.parquet') as tmp:
            pq.write_metadata(arrow_schema, tmp.name,
                              metadata_collector=list(metadata_collector))
            store.fs.put(tmp.name, posixpath.join(store.path, '_metadata'))
    store.write_common_metadata(arrow_schema, {
        UNISCHEMA_KEY: json.dumps(schema.to_json()),
        NUM_ROW_GROUPS_KEY: json.dumps(store.num_row_groups_per_file()),
    })


def write_dataset(dataset_url, schema, rows, rows_per_row_group=None, row_group_size_mb=None,
                  partition_fields=(), storage_options=None):
    """One-shot convenience: write an iterable of row dicts as a dataset."""
    with DatasetWriter(dataset_url, schema, rows_per_row_group=rows_per_row_group,
                       row_group_size_mb=row_group_size_mb, partition_fields=partition_fields,
                       storage_options=storage_options) as writer:
        for row in rows:
            writer.write(row)
