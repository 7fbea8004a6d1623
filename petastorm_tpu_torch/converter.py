"""In-memory table -> cached Parquet store -> loaders (counterpart of
``petastorm_tpu/converter.py``).

:func:`make_converter` writes a pandas DataFrame or a pyarrow Table once
into a plain Parquet store under a cache directory (float64 columns
narrowed to float32 unless ``precision=64``) and returns a
:class:`Converter`, whose :meth:`Converter.make_torch_loader` yields a
:class:`~petastorm_tpu_torch.loader.TorchLoader` over a ``make_batch_reader``
of it (``make_jax_loader`` is kept as its alias, for code written against
the JAX package) and :meth:`Converter.make_torch_dataloader` a
:class:`~petastorm_tpu_torch.pytorch.DataLoader`. A second call on a table
of the same content (a sha1 of its Arrow IPC stream, taken over fixed
windows so that chunk layout does not matter) and the same write
arguments returns the same converter without writing again.
:meth:`Converter.delete` removes the store; every store left is removed at
exit.

The cache directory: ``parent_cache_dir_url``, else the one given to
:func:`register_converter_cache_dir`, else ``PSTT_CONVERTER_CACHE_DIR``,
else ``petastorm_tpu_torch_converter_cache`` under the temporary directory.
:meth:`Converter.make_tf_dataset` gives a ``tf.data.Dataset`` of batches
(TensorFlow is imported only then).
"""

import atexit
import hashlib
import json
import logging
import os
import tempfile
import threading
import uuid
from contextlib import contextmanager

import pyarrow as pa
import pyarrow.parquet as pq

from petastorm_tpu_torch.fs import FilesystemResolver
from petastorm_tpu_torch.storage import NUM_ROW_GROUPS_KEY, ParquetStore

logger = logging.getLogger(__name__)

CACHE_DIR_ENV = 'PSTT_CONVERTER_CACHE_DIR'

_conversion_cache = {}
_cache_lock = threading.Lock()
_default_parent_dir = None


def register_converter_cache_dir(url_or_path):
    """Set the default parent cache directory of :func:`make_converter`."""
    global _default_parent_dir
    _default_parent_dir = url_or_path


def _parent_cache_dir(explicit):
    parent = explicit or _default_parent_dir or os.environ.get(CACHE_DIR_ENV)
    if parent is None:
        parent = os.path.join(tempfile.gettempdir(), 'petastorm_tpu_torch_converter_cache')
        logger.info('No converter cache dir configured (%s); using %s', CACHE_DIR_ENV, parent)
    return parent


def _narrow_precision(table, precision):
    """float64 columns as float32 when ``precision == 32`` (integers stay)."""
    if precision not in (32, 64):
        raise ValueError('precision must be 32 or 64, got {!r}'.format(precision))
    if precision == 64 or not any(pa.types.is_float64(f.type) for f in table.schema):
        return table
    fields = [f.with_type(pa.float32()) if pa.types.is_float64(f.type) else f
              for f in table.schema]
    return table.cast(pa.schema(fields, metadata=table.schema.metadata))


def _to_arrow_table(df):
    """A pyarrow Table of a pyarrow Table or a pandas DataFrame."""
    if isinstance(df, pa.Table):
        return df
    try:
        import pandas as pd
    except ImportError:
        pd = None
    if pd is not None and isinstance(df, pd.DataFrame):
        return pa.Table.from_pandas(df, preserve_index=False)
    raise TypeError('make_converter expects a pandas DataFrame or a pyarrow Table; got '
                    '{!r}'.format(type(df)))


class _HashSink(object):
    """File-like sink feeding sha1 as the IPC stream is written."""

    closed = False

    def __init__(self):
        self.digest = hashlib.sha1()

    def write(self, data):
        self.digest.update(memoryview(data))
        return len(data)

    def close(self):
        pass


def _fingerprint(table):
    """sha1 of the table's Arrow IPC stream (schema and data), written in
    windows of 64Ki rows, each combined into one chunk: tables of equal
    content hash equal whatever their record-batch boundaries, in memory
    of one window."""
    sink = _HashSink()
    window = 1 << 16
    with pa.ipc.new_stream(pa.PythonFile(sink, mode='w'), table.schema) as writer:
        for offset in range(0, table.num_rows, window):
            for batch in table.slice(offset, window).combine_chunks().to_batches():
                writer.write_batch(batch)
    return sink.digest.hexdigest()


class Converter(object):
    """A table materialized as a cached Parquet store at :attr:`dataset_url`."""

    def __init__(self, cache_url, num_rows, fingerprint, storage_options=None):
        self.dataset_url = cache_url
        #: The fsspec options of the store, passed on to its readers.
        self.storage_options = dict(storage_options or {})
        self._num_rows = num_rows
        self._fingerprint = fingerprint
        self._deleted = False

    def __len__(self):
        return self._num_rows

    @contextmanager
    def make_torch_loader(self, batch_size=32, device=None, num_epochs=None, workers_count=4,
                          seed=None, shuffle_row_groups=True, reader_pool_type='thread',
                          prefetch=2, shape_policies=None, last_batch='drop',
                          shuffling_queue_capacity=0, mesh=None, sharding=None,
                          **reader_kwargs):
        """Context manager yielding a :class:`~petastorm_tpu_torch.loader.
        TorchLoader` (on the card unless ``device='cpu'``) over a
        ``make_batch_reader`` of the store; ``reader_kwargs`` go to the
        reader."""
        from petastorm_tpu_torch.loader import TorchLoader
        from petastorm_tpu_torch.reader import make_batch_reader

        reader_kwargs.setdefault('storage_options', self.storage_options)
        with make_batch_reader(self.dataset_url, reader_pool_type=reader_pool_type,
                               workers_count=workers_count, num_epochs=num_epochs, seed=seed,
                               shuffle_row_groups=shuffle_row_groups, **reader_kwargs) as reader:
            with TorchLoader(reader, batch_size, device=device, prefetch=prefetch,
                             shape_policies=shape_policies, last_batch=last_batch,
                             shuffling_queue_capacity=shuffling_queue_capacity, seed=seed,
                             mesh=mesh, sharding=sharding) as loader:
                yield loader

    #: The JAX package's name of :meth:`make_torch_loader`.
    make_jax_loader = make_torch_loader

    @contextmanager
    def make_torch_dataloader(self, batch_size=32, device='cuda', num_epochs=None,
                              workers_count=4, seed=None, shuffle_row_groups=True,
                              reader_pool_type='thread', shuffling_queue_capacity=0,
                              collate_fn=None, **reader_kwargs):
        """Context manager yielding a :class:`~petastorm_tpu_torch.pytorch.
        DataLoader` over a ``make_batch_reader`` of the store."""
        from petastorm_tpu_torch.pytorch import DataLoader
        from petastorm_tpu_torch.reader import make_batch_reader

        reader_kwargs.setdefault('storage_options', self.storage_options)
        with make_batch_reader(self.dataset_url, reader_pool_type=reader_pool_type,
                               workers_count=workers_count, num_epochs=num_epochs, seed=seed,
                               shuffle_row_groups=shuffle_row_groups, **reader_kwargs) as reader:
            with DataLoader(reader, batch_size=batch_size, collate_fn=collate_fn,
                            shuffling_queue_capacity=shuffling_queue_capacity, seed=seed,
                            device=device) as loader:
                yield loader

    @contextmanager
    def make_tf_dataset(self, batch_size=32, num_epochs=None, workers_count=4, seed=None,
                        shuffle_row_groups=True, reader_pool_type='thread', **reader_kwargs):
        """Context manager yielding a ``tf.data.Dataset`` over a
        ``make_batch_reader`` of the store, batched by ``batch_size`` (None:
        the reader's row-group batches); requires TensorFlow."""
        from petastorm_tpu_torch.reader import make_batch_reader
        from petastorm_tpu_torch.tf_utils import make_petastorm_dataset

        reader_kwargs.setdefault('storage_options', self.storage_options)
        with make_batch_reader(self.dataset_url, reader_pool_type=reader_pool_type,
                               workers_count=workers_count, num_epochs=num_epochs, seed=seed,
                               shuffle_row_groups=shuffle_row_groups, **reader_kwargs) as reader:
            dataset = make_petastorm_dataset(reader)
            if batch_size is not None:
                dataset = dataset.batch(batch_size)
            yield dataset

    def delete(self):
        """Remove the store (and forget the converter)."""
        if self._deleted:
            return
        self._deleted = True
        with _cache_lock:
            _conversion_cache.pop(self._fingerprint, None)
        _delete_dataset_url(self.dataset_url, self.storage_options)


def _delete_dataset_url(url, storage_options=None):
    """Remove a store through its filesystem (best effort)."""
    try:
        resolver = FilesystemResolver(url, storage_options)
        fs, path = resolver.filesystem(), resolver.get_dataset_path()
        if fs.exists(path):
            fs.rm(path, recursive=True)
    except Exception:  # noqa: BLE001 - cleanup must not raise at exit
        logger.warning('Failed to remove converter cache %s', url, exc_info=True)


def _cleanup_all():
    with _cache_lock:
        converters = list(_conversion_cache.values())
        _conversion_cache.clear()
    for conv in converters:
        conv._deleted = True
        _delete_dataset_url(conv.dataset_url, conv.storage_options)


atexit.register(_cleanup_all)


def make_converter(df, parent_cache_dir_url=None, precision=32, rows_per_row_group=None,
                   row_group_size_mb=None, storage_options=None):
    """``df`` (a pandas DataFrame or a pyarrow Table) written as a plain
    Parquet store under the cache directory, as a :class:`Converter`.

    :param parent_cache_dir_url: a local directory or any store URL
        (``gs://bucket/cache``, ``memory://cache``, ...).
    :param precision: 32 narrows float64 columns to float32; 64 keeps them.
    :param rows_per_row_group: rows a row-group; else ``row_group_size_mb``
        of the table's average row, else the whole table up to 64Ki rows.
    :param storage_options: the fsspec driver's keyword arguments, kept for
        the converter's readers.
    """
    table = _narrow_precision(_to_arrow_table(df), precision)
    parent = _parent_cache_dir(parent_cache_dir_url)
    # The content and every write argument: another row-group size or cache
    # directory writes again.
    content_hash = _fingerprint(table)
    fingerprint = '{}:{}:{}:{}'.format(content_hash, parent, rows_per_row_group,
                                       row_group_size_mb)
    with _cache_lock:
        cached = _conversion_cache.get(fingerprint)
        if cached is not None:
            logger.info('Converter cache hit for fingerprint %s', content_hash[:12])
            return cached
    sub = 'conv_{}_{}'.format(content_hash[:16], uuid.uuid4().hex[:8])
    if '://' in parent:
        cache_url = parent.rstrip('/') + '/' + sub
    else:
        cache_url = 'file://' + os.path.join(os.path.abspath(parent), sub)
    resolver = FilesystemResolver(cache_url, storage_options)
    fs, path = resolver.filesystem(), resolver.get_dataset_path()
    fs.makedirs(path, exist_ok=True)
    if rows_per_row_group is None:
        if row_group_size_mb is not None:
            approx_row = max(1, table.nbytes // max(1, table.num_rows))
            rows_per_row_group = max(1, row_group_size_mb * 1024 * 1024 // approx_row)
        else:
            rows_per_row_group = min(max(1, table.num_rows), 64 * 1024)
    with fs.open(path + '/part-00000.parquet', 'wb') as f:
        pq.write_table(table, f, row_group_size=rows_per_row_group)
    # A plain store with the row-group counts, as the JAX package writes it.
    store = ParquetStore(cache_url, storage_options)
    store.write_common_metadata(
        table.schema, {NUM_ROW_GROUPS_KEY: json.dumps(store.num_row_groups_per_file())})
    converter = Converter(cache_url, table.num_rows, fingerprint, storage_options)
    with _cache_lock:
        existing = _conversion_cache.get(fingerprint)
        if existing is not None:     # lost a race: keep the first
            _delete_dataset_url(cache_url, storage_options)
            return existing
        _conversion_cache[fingerprint] = converter
    logger.info('Materialized converter cache %s (%d rows)', cache_url, table.num_rows)
    return converter
