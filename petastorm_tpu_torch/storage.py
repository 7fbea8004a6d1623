"""Parquet store discovery: files, row-group pieces, ``_common_metadata``.

Counterpart of ``petastorm_tpu/storage.py:39-280``. The store is reached
through its fsspec filesystem (:mod:`~petastorm_tpu_torch.fs`), so a local
directory, an object-store bucket, ``memory://`` or HDFS read alike:
listing, partition parsing, the ``_metadata``/``_common_metadata`` reads and
writes and :meth:`ParquetStore.open_file` all go through ``self.fs``. The
metadata keys are the JAX package's, so either package reads a store the
other wrote. The unit of reader work is the Parquet row-group
(:class:`RowGroupPiece`), which carries the hive partition values
(``key=value`` directories) of its file.

Pieces come from the ``_metadata`` summary footer when the store has one,
else from each file's footer (read in parallel). The JAX package tries its
``_common_metadata`` row-group index before the footers; both orders give
the same pieces, and the footers also give each piece's row count.
"""

import posixpath
from concurrent.futures import ThreadPoolExecutor

import pyarrow.parquet as pq

from petastorm_tpu_torch.fs import FilesystemResolver

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


def _relative(root, file_path):
    """``file_path`` relative to ``root``, both as ``/``-rooted paths (an
    object store's listing may give ``/bucket/x`` for a root ``bucket``)."""
    return posixpath.relpath('/' + file_path.lstrip('/'), '/' + root.lstrip('/'))


def _partition_values(root, file_path):
    """The hive ``key=value`` directories of a file under ``root``, each
    value an int, else a float, else the string (as the JAX package reads
    them)."""
    values = {}
    for segment in _relative(root, file_path).split('/')[:-1]:
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
    """A discovered Parquet dataset on any fsspec filesystem.

    :param dataset_url: ``file:///...``, a bare absolute path, ``gs://``,
        ``s3://``, ``memory://``, ``hdfs://``, ...
    :param storage_options: the fsspec driver's keyword arguments.
    :param filesystem: an fsspec filesystem to use as it is (``path`` is
        then the in-filesystem path; default: ``dataset_url``).
    """

    def __init__(self, dataset_url, storage_options=None, filesystem=None, path=None):
        self.storage_options = dict(storage_options or {})
        if filesystem is not None:
            self.fs = filesystem
            self.path = path if path is not None else dataset_url
            self.url = dataset_url
            self.scheme = None
        else:
            resolver = FilesystemResolver(dataset_url, storage_options)
            self.fs = resolver.filesystem()
            self.path = resolver.get_dataset_path()
            self.url = resolver.dataset_url
            self.scheme = resolver.scheme
        self._files = None
        self._common_metadata = None
        self._common_metadata_loaded = False

    @property
    def is_local(self):
        """True for a ``file`` store, whose pieces are operating-system
        paths (the native Parquet stage opens those only)."""
        return self.scheme == 'file'

    @property
    def files(self):
        """Sorted data file paths (hidden and ``_``-prefixed files skipped)."""
        if self._files is None:
            if not self.fs.exists(self.path):
                raise IOError('Dataset path does not exist: {}'.format(self.url))
            if self.fs.isfile(self.path):
                self._files = [self.path]
            else:
                self._files = sorted(
                    f for f in self.fs.find(self.path)
                    if not posixpath.basename(f).startswith(('_', '.'))
                    and not f.endswith('.crc'))
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
        return posixpath.join(self.path, name)

    def read_common_metadata(self):
        """Key-value metadata dict of ``_common_metadata`` (or None)."""
        if not self._common_metadata_loaded:
            self._common_metadata_loaded = True
            target = self._metadata_path(_COMMON_METADATA_FILE)
            if self.fs.exists(target):
                with self.fs.open(target, 'rb') as f:
                    self._common_metadata = dict(pq.read_schema(f).metadata or {})
            else:
                self._common_metadata = None
        return self._common_metadata

    def write_common_metadata(self, arrow_schema, extra_metadata):
        """Write ``_common_metadata`` merging ``extra_metadata`` key-values."""
        merged = dict(self.read_common_metadata() or {})
        for key, value in extra_metadata.items():
            key = key if isinstance(key, bytes) else key.encode('utf-8')
            merged[key] = value if isinstance(value, bytes) else value.encode('utf-8')
        with self.fs.open(self._metadata_path(_COMMON_METADATA_FILE), 'wb') as f:
            pq.write_metadata(arrow_schema.with_metadata(merged), f)
        self._common_metadata = merged
        self._common_metadata_loaded = True
        crc = self._metadata_path('.' + _COMMON_METADATA_FILE + '.crc')
        if self.fs.exists(crc):     # a checksum of the old file is stale now
            self.fs.rm(crc)

    def common_metadata_value(self, key, default=None):
        md = self.read_common_metadata()
        return default if md is None else md.get(key, default)

    def read_arrow_schema(self):
        """Arrow schema of the data files (``_common_metadata``'s when it has
        columns, else the first file's footer)."""
        target = self._metadata_path(_COMMON_METADATA_FILE)
        if self.fs.exists(target):
            with self.fs.open(target, 'rb') as f:
                schema = pq.read_schema(f)
            if schema.names:
                return schema
        with self.fs.open(self.files[0], 'rb') as f:
            return pq.read_schema(f)

    def row_groups(self, max_footer_workers=10):
        """Every :class:`RowGroupPiece`, from the ``_metadata`` summary when
        there is one, else from the files' footers."""
        pieces = self._row_groups_from_summary_metadata()
        if pieces is None:
            pieces = self._row_groups_from_footers(max_footer_workers)
        return pieces

    def _row_groups_from_summary_metadata(self):
        target = self._metadata_path(_METADATA_FILE)
        if not self.fs.exists(target):
            return None
        with self.fs.open(target, 'rb') as f:
            metadata = pq.read_metadata(f)
        per_file = {}
        for i in range(metadata.num_row_groups):
            rg = metadata.row_group(i)
            file_path = rg.column(0).file_path
            if not file_path:
                return None
            per_file.setdefault(posixpath.join(self.path, file_path), []).append(rg.num_rows)
        return [RowGroupPiece(path, idx, _partition_values(self.path, path), num_rows)
                for path in sorted(per_file)
                for idx, num_rows in enumerate(per_file[path])]

    def _row_groups_from_footers(self, max_workers):
        def footer(path):
            with self.fs.open(path, 'rb') as f:
                md = pq.read_metadata(f)
            return [md.row_group(i).num_rows for i in range(md.num_row_groups)]

        files = self.files
        if len(files) == 1:
            counts = [footer(files[0])]
        else:
            with ThreadPoolExecutor(max_workers=min(max_workers, len(files)),
                                    thread_name_prefix='pstt-footer') as pool:
                counts = list(pool.map(footer, files))
        return [RowGroupPiece(path, idx, _partition_values(self.path, path), num_rows)
                for path, rows in zip(files, counts)
                for idx, num_rows in enumerate(rows)]

    def num_row_groups_per_file(self):
        """``{relative_path: count}`` for the JSON row-group index."""
        counts = {}
        for piece in self.row_groups():
            rel = _relative(self.path, piece.path)
            counts[rel] = counts.get(rel, 0) + 1
        return counts

    def open_file(self, path):
        return self.fs.open(path, 'rb')
