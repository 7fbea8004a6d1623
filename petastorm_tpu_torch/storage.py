"""Parquet store discovery: files, row-group pieces, ``_common_metadata``.

Counterpart of ``petastorm_tpu/storage.py:39-280`` for local (``file://``)
stores. The metadata keys are the JAX package's, so either package reads a
store the other wrote. The unit of reader work is the Parquet row-group
(:class:`RowGroupPiece`), which carries the hive partition values
(``key=value`` directories) of its file.
"""

import os

import pyarrow.parquet as pq

from petastorm_tpu_torch.fs import local_path

UNISCHEMA_KEY = b'petastorm_tpu.unischema.v1'
NUM_ROW_GROUPS_KEY = b'petastorm_tpu.num_row_groups_per_file.v1'
ROWGROUP_INDEX_KEY = b'petastorm_tpu.rowgroups_index.v1'

_METADATA_FILE = '_metadata'
_COMMON_METADATA_FILE = '_common_metadata'


class RowGroupPiece(object):
    """One row-group of one Parquet file, with its file's partition values."""

    __slots__ = ('path', 'row_group', 'partition_values', 'num_rows')

    def __init__(self, path, row_group, partition_values=None, num_rows=None):
        self.path = path
        self.row_group = row_group
        self.partition_values = partition_values or {}
        self.num_rows = num_rows

    def __repr__(self):
        return 'RowGroupPiece({!r}, rg={}, partitions={}, rows={})'.format(
            self.path, self.row_group, self.partition_values, self.num_rows)

    def __eq__(self, other):
        return (isinstance(other, RowGroupPiece) and self.path == other.path
                and self.row_group == other.row_group)

    def __hash__(self):
        return hash((self.path, self.row_group))


def _partition_values(root, file_path):
    """The hive ``key=value`` directories of a file under ``root``, each
    value an int, else a float, else the string (as the JAX package reads
    them)."""
    values = {}
    for segment in os.path.relpath(file_path, root).split(os.sep)[:-1]:
        if '=' in segment:
            key, _, value = segment.partition('=')
            for cast in (int, float, str):
                try:
                    values[key] = cast(value)
                    break
                except ValueError:
                    continue
    return values


class ParquetStore(object):
    """A discovered local Parquet dataset."""

    def __init__(self, dataset_url):
        self.url, self.path = local_path(dataset_url)
        self._files = None
        self._common_metadata = None
        self._common_metadata_loaded = False

    @property
    def files(self):
        """Sorted data file paths (hidden and ``_``-prefixed files skipped)."""
        if self._files is None:
            if not os.path.exists(self.path):
                raise IOError('Dataset path does not exist: {}'.format(self.url))
            if os.path.isfile(self.path):
                self._files = [self.path]
            else:
                found = []
                for root, _, names in os.walk(self.path):
                    found.extend(os.path.join(root, n) for n in names
                                 if not n.startswith(('_', '.')) and not n.endswith('.crc'))
                self._files = sorted(found)
        return self._files

    @property
    def partition_names(self):
        """The hive partition keys of the store's files, in first-seen order."""
        names = []
        for path in self.files:
            for key in _partition_values(self.path, path):
                if key not in names:
                    names.append(key)
        return names

    def _metadata_path(self, name):
        return os.path.join(self.path, name)

    def read_common_metadata(self):
        """Key-value metadata dict of ``_common_metadata`` (or None)."""
        if not self._common_metadata_loaded:
            self._common_metadata_loaded = True
            target = self._metadata_path(_COMMON_METADATA_FILE)
            self._common_metadata = (dict(pq.read_schema(target).metadata or {})
                                     if os.path.exists(target) else None)
        return self._common_metadata

    def write_common_metadata(self, arrow_schema, extra_metadata):
        """Write ``_common_metadata`` merging ``extra_metadata`` key-values."""
        merged = dict(self.read_common_metadata() or {})
        for key, value in extra_metadata.items():
            key = key if isinstance(key, bytes) else key.encode('utf-8')
            merged[key] = value if isinstance(value, bytes) else value.encode('utf-8')
        pq.write_metadata(arrow_schema.with_metadata(merged),
                          self._metadata_path(_COMMON_METADATA_FILE))
        self._common_metadata = merged
        self._common_metadata_loaded = True

    def common_metadata_value(self, key, default=None):
        md = self.read_common_metadata()
        return default if md is None else md.get(key, default)

    def read_arrow_schema(self):
        """Arrow schema of the data files (``_common_metadata``'s when it has
        columns, else the first file's footer)."""
        target = self._metadata_path(_COMMON_METADATA_FILE)
        if os.path.exists(target):
            schema = pq.read_schema(target)
            if schema.names:
                return schema
        return pq.read_schema(self.files[0])

    def row_groups(self):
        """Every :class:`RowGroupPiece`, from the ``_metadata`` summary when
        there is one, else from the files' footers."""
        pieces = self._row_groups_from_summary_metadata()
        if pieces is None:
            pieces = []
            for path in self.files:
                md = pq.read_metadata(path)
                partitions = _partition_values(self.path, path)
                pieces.extend(RowGroupPiece(path, i, partitions, md.row_group(i).num_rows)
                              for i in range(md.num_row_groups))
        return pieces

    def _row_groups_from_summary_metadata(self):
        target = self._metadata_path(_METADATA_FILE)
        if not os.path.exists(target):
            return None
        metadata = pq.read_metadata(target)
        per_file = {}
        for i in range(metadata.num_row_groups):
            rg = metadata.row_group(i)
            file_path = rg.column(0).file_path
            if not file_path:
                return None
            per_file.setdefault(os.path.join(self.path, file_path), []).append(rg.num_rows)
        return [RowGroupPiece(path, idx, _partition_values(self.path, path), num_rows)
                for path in sorted(per_file)
                for idx, num_rows in enumerate(per_file[path])]

    def num_row_groups_per_file(self):
        """``{relative_path: count}`` for the JSON row-group index."""
        counts = {}
        for piece in self.row_groups():
            rel = os.path.relpath(piece.path, self.path)
            counts[rel] = counts.get(rel, 0) + 1
        return counts

