"""Readers: per-row (``make_reader``) and decoded-columnar
(``make_tensor_reader``); counterparts of ``petastorm_tpu/reader.py:116-343``
and of the ``Reader`` at ``:633-1536``.

``make_reader`` yields one namedtuple per row (any field: ragged images,
strings, nullable values); ``make_tensor_reader`` yields one namedtuple of
``[rows, ...field.shape]`` numpy blocks per row-group. One :class:`Reader`
serves both, through its worker class. Row-groups are sharded by
``index % shard_count == cur_shard`` and, per epoch, shuffled by
``random.Random(seed)`` as in the JAX package, so one seed gives both
packages the same row-group order. Of the cache tiers, ``'null'`` and
``'memory'`` are ported (``petastorm_tpu/reader.py:76-113``); of the pools,
``'thread'`` and ``'dummy'``. The disk and chunk-store tiers, process
pools, predicates, transforms, ``state_dict``/resume, health and autotune
come in later slices (ROADMAP §A4, §A5, §A9).
"""

import hashlib
from collections import deque

from petastorm_tpu_torch.cache import MemoryCache, NullCache
from petastorm_tpu_torch.errors import NoDataAvailableError, PetastormMetadataError
from petastorm_tpu_torch.etl.dataset_metadata import get_schema
from petastorm_tpu_torch.py_dict_worker import PyDictWorker
from petastorm_tpu_torch.storage import ParquetStore
from petastorm_tpu_torch.tensor_worker import TensorWorker, validate_tensor_schema
from petastorm_tpu_torch.unischema import match_unischema_fields
from petastorm_tpu_torch.workers import EmptyResultError
from petastorm_tpu_torch.workers.dummy_pool import DummyPool
from petastorm_tpu_torch.workers.thread_pool import ThreadPool
from petastorm_tpu_torch.workers.ventilator import ConcurrentVentilator

#: Row-groups ventilated beyond the worker count, as in the JAX reader.
_VENTILATE_EXTRA_ROWGROUPS = 2
#: Tiers of the JAX package that are not ported yet.
_NOT_PORTED_CACHES = ('local-disk', 'chunk-store')


def _make_cache(cache_type, cache_size_limit):
    if cache_type == 'null':
        return NullCache()
    if cache_type == 'memory':
        return MemoryCache(size_limit_bytes=cache_size_limit)
    if cache_type in _NOT_PORTED_CACHES:
        raise ValueError('cache_type={!r} is not ported to petastorm_tpu_torch yet; '
                         "use 'null' or 'memory'".format(cache_type))
    raise ValueError('Unknown cache_type {!r}'.format(cache_type))


def _make_pool(reader_pool_type, workers_count, results_queue_size):
    if reader_pool_type == 'thread':
        return ThreadPool(workers_count, results_queue_size)
    if reader_pool_type == 'dummy':
        return DummyPool()
    raise ValueError("petastorm_tpu_torch has reader_pool_type='thread' and 'dummy' so far, "
                     'got {!r}'.format(reader_pool_type))


def _stored_view(store, schema_fields, factory):
    try:
        stored_schema = get_schema(store)
    except PetastormMetadataError as e:
        raise RuntimeError('{} requires a petastorm_tpu (codec-materialized) dataset: '
                           '{}'.format(factory, e))
    if schema_fields is None:
        return stored_schema
    return stored_schema.create_schema_view(
        match_unischema_fields(stored_schema, schema_fields, allow_empty_match=False))


def make_reader(dataset_url, schema_fields=None, reader_pool_type='thread', workers_count=10,
                results_queue_size=50, shuffle_row_groups=True, shuffle_row_drop_partitions=1,
                seed=None, predicate=None, num_epochs=1, cur_shard=None, shard_count=None,
                cache_type='null', cache_size_limit=None, transform_spec=None):
    """Reader of decoded rows, one namedtuple per row.

    The arguments are ``make_tensor_reader``'s, plus ``predicate``,
    ``transform_spec`` and ``shuffle_row_drop_partitions``, which are not
    ported yet (ROADMAP §A9) and raise ``ValueError`` unless left at their
    defaults. Fields of any shape are read: an image field with ``None``
    dims decodes at each row's own size.
    """
    if predicate is not None or transform_spec is not None or shuffle_row_drop_partitions != 1:
        raise ValueError('predicate, transform_spec and shuffle_row_drop_partitions are not '
                         'ported to petastorm_tpu_torch yet (ROADMAP §A9)')
    cache = _make_cache(cache_type, cache_size_limit)
    pool = _make_pool(reader_pool_type, workers_count, results_queue_size)
    store = ParquetStore(dataset_url)
    return Reader(store, _stored_view(store, schema_fields, 'make_reader'), pool,
                  worker_class=PyDictWorker, shuffle_row_groups=shuffle_row_groups, seed=seed,
                  num_epochs=num_epochs, cur_shard=cur_shard, shard_count=shard_count,
                  cache=cache)


def make_tensor_reader(dataset_url, schema_fields=None, reader_pool_type='thread',
                       workers_count=10, results_queue_size=50, shuffle_row_groups=True,
                       seed=None, num_epochs=1, cur_shard=None, shard_count=None,
                       cache_type='null', cache_size_limit=None):
    """Reader of decoded column blocks, one namedtuple per row-group.

    :param schema_fields: fields or full-match regex patterns to read
        (default: all).
    :param reader_pool_type: ``'thread'`` or ``'dummy'`` (the work runs on
        the consumer's thread).
    :param num_epochs: epochs to read; ``None`` = endless.
    :param cur_shard/shard_count: read only row-groups ``i`` with
        ``i % shard_count == cur_shard``.
    :param cache_type: ``'null'`` (decode every epoch) or ``'memory'``
        (keep decoded row-groups in RAM: later epochs skip read and
        decode). Other tiers raise ``ValueError``.
    :param cache_size_limit: the memory cache's approximate byte cap
        (``None`` = no cap).
    """
    cache = _make_cache(cache_type, cache_size_limit)
    pool = _make_pool(reader_pool_type, workers_count, results_queue_size)
    store = ParquetStore(dataset_url)
    view = _stored_view(store, schema_fields, 'make_tensor_reader')
    validate_tensor_schema(view)
    return Reader(store, view, pool, worker_class=TensorWorker,
                  shuffle_row_groups=shuffle_row_groups, seed=seed, num_epochs=num_epochs,
                  cur_shard=cur_shard, shard_count=shard_count, cache=cache)


class Reader(object):
    """Iterates decoded rows (``worker_class=PyDictWorker``) or row-group
    chunks (``TensorWorker``) off a worker pool. ``batched_output`` says
    which."""

    def __init__(self, store, schema, pool, worker_class=TensorWorker, shuffle_row_groups=True,
                 seed=None, num_epochs=1, cur_shard=None, shard_count=None, cache=None):
        if (cur_shard is None) != (shard_count is None):
            raise ValueError('cur_shard and shard_count must be specified together')
        if cur_shard is not None and not 0 <= cur_shard < shard_count:
            raise ValueError('cur_shard {} out of range [0, {})'.format(cur_shard, shard_count))
        self.schema = schema
        pieces = store.row_groups()
        if shard_count is not None:
            pieces = [p for i, p in enumerate(pieces) if i % shard_count == cur_shard]
        if not pieces:
            raise NoDataAvailableError('No row-groups left after sharding; cannot create a Reader')
        self._row_groups = pieces
        self._pool = pool
        self.cache = cache if cache is not None else NullCache()
        self.batched_output = worker_class.batched_output
        self._rows = deque()
        self._timings = {'read_s': 0.0, 'decode_s': 0.0, 'cache_s': 0.0, 'chunks': 0}
        self._stopped = False
        self._ventilator = ConcurrentVentilator(
            ventilate_fn=None,   # bound by pool.start
            items_to_ventilate=[{'piece_index': i} for i in range(len(pieces))],
            iterations=num_epochs,
            randomize_item_order=shuffle_row_groups,
            random_seed=seed,
            max_ventilation_queue_size=pool.workers_count + _VENTILATE_EXTRA_ROWGROUPS)
        pool.start(worker_class, {
            'row_groups': pieces, 'schema': schema, 'cache': self.cache,
            'dataset_path_hash': hashlib.md5(store.url.encode()).hexdigest()[:12],
        }, self._ventilator)

    def cache_stats(self):
        """``{'type', 'hits', 'misses', 'nbytes'}`` of the row-group cache
        (zeros for the null cache)."""
        if isinstance(self.cache, MemoryCache):
            return {'type': 'memory', 'hits': self.cache.hits, 'misses': self.cache.misses,
                    'nbytes': self.cache.nbytes}
        return {'type': 'null', 'hits': 0, 'misses': 0, 'nbytes': 0}

    @property
    def stage_timings(self):
        """Worker seconds summed over the row-groups delivered so far:
        ``read_s`` (Parquet), ``decode_s`` (codecs), ``cache_s`` (the
        cache's own bookkeeping), and ``chunks``."""
        return dict(self._timings)

    def __iter__(self):
        return self

    def _next_chunk(self):
        try:
            chunk = self._pool.get_results()
        except EmptyResultError:
            raise StopIteration
        for key, seconds in chunk['timings'].items():
            self._timings[key] += seconds
        self._timings['chunks'] += 1
        return chunk

    def __next__(self):
        if self._stopped:
            raise RuntimeError('Trying to iterate a stopped Reader')
        if self.batched_output:
            return self.schema.make_namedtuple(**self._next_chunk()['cols'])
        while not self._rows:
            self._rows.extend(self._next_chunk()['rows'])
        return self.schema.make_namedtuple(**self._rows.popleft())

    def stop(self):
        self._pool.stop()
        self._stopped = True

    def join(self):
        self._pool.join()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.stop()
        self.join()
        return False
