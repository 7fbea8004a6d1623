"""Readers: per-row (``make_reader``) and decoded-columnar
(``make_tensor_reader``); counterparts of ``petastorm_tpu/reader.py:116-343``
and of the ``Reader`` at ``:633-1536``.

``make_reader`` yields one namedtuple per row (any field: ragged images,
strings, nullable values); ``make_tensor_reader`` yields one namedtuple of
``[rows, ...field.shape]`` numpy blocks per row-group. One :class:`Reader`
serves both, through its worker class. Row-groups are sharded by
``index % shard_count == cur_shard`` and, per epoch, shuffled by
``random.Random(seed)`` as in the JAX package, so one seed gives both
packages the same row-group order. Every cache tier of
``petastorm_tpu/reader.py:76-113`` is ported: ``'null'``, ``'memory'``,
``'local-disk'`` (``cache_location``) and, on the tensor path,
``'chunk-store'`` (:mod:`~petastorm_tpu_torch.chunk_store`, whose directory
``PSTT_CHUNK_STORE`` can also give, and which that variable arms for the
default ``cache_type=None``). Of the pools, ``'thread'`` and ``'dummy'``.
Process pools, predicates, transforms, health and autotune come in later
slices (ROADMAP §A9).

Each reader registers its byte-holding pools with the host memory governor
(:mod:`~petastorm_tpu_torch.membudget`, ``petastorm_tpu/reader.py:965-
1050``): ``results-queue`` (its shed hook paces ventilation),
``memory-cache``, ``chunk-store`` and ``resequencer``; it arms the governor
when ``PSTT_HOST_MEM_BUDGET`` is set, and a breach raises
:class:`~petastorm_tpu_torch.errors.HostMemoryExceededError` from ``next``.

Resume (``petastorm_tpu/reader.py:711-790, 1291-1460``): ``state_dict()``
is a JSON-safe position that a new reader built with ``resume_state=`` and
the same configuration continues from, in either package: the config
fingerprint and the cursors are the JAX package's key for key. The default
mode tracks consumption per chunk (:mod:`~petastorm_tpu_torch.checkpoint`,
multiset-exact); ``deterministic=True`` makes the stream a pure function of
``(dataset, fields, seed, epoch, position)`` and its state a stream cursor
(:mod:`~petastorm_tpu_torch.determinism`). Every chunk carries its
provenance segment (:mod:`~petastorm_tpu_torch.lineage`).
"""

import hashlib
import os
import warnings
from collections import deque

from petastorm_tpu_torch import chunk_store as chunk_store_mod
from petastorm_tpu_torch import determinism, membudget
from petastorm_tpu_torch.cache import LocalDiskCache, MemoryCache, NullCache
from petastorm_tpu_torch.checkpoint import ConsumptionTracker, DeferredRowAccounting
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


def _make_cache(cache_type, cache_location, cache_size_limit, tensor_path=False, **extra):
    """The row-group cache of ``petastorm_tpu/reader.py:76-113``."""
    if cache_type is None:
        # Only the default is armed by the variable: an explicit 'null'
        # stays a genuine no-cache.
        if tensor_path and os.environ.get(chunk_store_mod.ENV_VAR):
            return chunk_store_mod.DecodedChunkStore(size_limit=cache_size_limit, **extra)
        return NullCache()
    if cache_type == 'null':
        return NullCache()
    if cache_type == 'local-disk':
        if cache_location is None:
            raise ValueError("cache_type='local-disk' requires cache_location")
        return LocalDiskCache(cache_location, size_limit=cache_size_limit, **extra)
    if cache_type == 'memory':
        return MemoryCache(size_limit_bytes=cache_size_limit)
    if cache_type == 'chunk-store':
        if not tensor_path:
            raise ValueError(
                "cache_type='chunk-store' serves decoded tensor chunks: use make_tensor_reader "
                "(make_reader/make_batch_reader values cannot be stored; use 'local-disk' "
                'there)')
        return chunk_store_mod.DecodedChunkStore(path=cache_location, size_limit=cache_size_limit,
                                                 **extra)
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
                cache_type=None, cache_location=None, cache_size_limit=None,
                cache_extra_settings=None, transform_spec=None, resume_state=None,
                deterministic=False):
    """Reader of decoded rows, one namedtuple per row.

    The arguments are ``make_tensor_reader``'s, plus ``predicate``,
    ``transform_spec`` and ``shuffle_row_drop_partitions``, which are not
    ported yet (ROADMAP §A9) and raise ``ValueError`` unless left at their
    defaults. Fields of any shape are read: an image field with ``None``
    dims decodes at each row's own size. ``cache_type='chunk-store'``
    raises (rows cannot be stored in its layout; ``'local-disk'`` can).
    """
    if predicate is not None or transform_spec is not None or shuffle_row_drop_partitions != 1:
        raise ValueError('predicate, transform_spec and shuffle_row_drop_partitions are not '
                         'ported to petastorm_tpu_torch yet (ROADMAP §A9)')
    cache = _make_cache(cache_type, cache_location, cache_size_limit,
                        **(cache_extra_settings or {}))
    pool = _make_pool(reader_pool_type, workers_count, results_queue_size)
    store = ParquetStore(dataset_url)
    return Reader(store, _stored_view(store, schema_fields, 'make_reader'), pool,
                  worker_class=PyDictWorker, shuffle_row_groups=shuffle_row_groups, seed=seed,
                  num_epochs=num_epochs, cur_shard=cur_shard, shard_count=shard_count,
                  cache=cache, resume_state=resume_state, deterministic=deterministic)


def make_tensor_reader(dataset_url, schema_fields=None, reader_pool_type='thread',
                       workers_count=10, results_queue_size=50, shuffle_row_groups=True,
                       seed=None, num_epochs=1, cur_shard=None, shard_count=None,
                       cache_type=None, cache_location=None, cache_size_limit=None,
                       cache_extra_settings=None, resume_state=None, deterministic=False,
                       shuffle_rows_in_chunk=False):
    """Reader of decoded column blocks, one namedtuple per row-group.

    :param schema_fields: fields or full-match regex patterns to read
        (default: all).
    :param reader_pool_type: ``'thread'`` or ``'dummy'`` (the work runs on
        the consumer's thread).
    :param num_epochs: epochs to read; ``None`` = endless.
    :param cur_shard/shard_count: read only row-groups ``i`` with
        ``i % shard_count == cur_shard`` (deterministic mode: every
        ``shard_count``-th position of the global order).
    :param cache_type: ``None`` (the default: the chunk store when
        ``PSTT_CHUNK_STORE`` names a directory, else no cache), ``'null'``
        (decode every epoch), ``'memory'`` (decoded row-groups in RAM),
        ``'local-disk'`` (in files under ``cache_location``) or
        ``'chunk-store'`` (mmapped decoded chunks under ``cache_location``
        or ``PSTT_CHUNK_STORE``, shared across processes and with the JAX
        package). With a cache, later epochs skip read and decode.
    :param cache_location: the directory of the disk tiers.
    :param cache_size_limit: the cache's approximate byte cap (``None`` =
        no cap).
    :param cache_extra_settings: keyword arguments of the cache's
        constructor (the chunk store's ``writer_queue_depth``, ...).
    :param resume_state: a ``state_dict()`` of a reader of the same
        configuration (of either package) to continue from.
    :param deterministic: seed-stable order and resequenced delivery: the
        same stream for any worker count, pool or shard count, and a
        stream cursor for ``state_dict()``.
    :param shuffle_rows_in_chunk: not ported (ROADMAP §A9); True raises.
    """
    if shuffle_rows_in_chunk:
        raise ValueError('shuffle_rows_in_chunk is not ported to petastorm_tpu_torch yet '
                         '(ROADMAP §A9)')
    cache = _make_cache(cache_type, cache_location, cache_size_limit, tensor_path=True,
                        **(cache_extra_settings or {}))
    pool = _make_pool(reader_pool_type, workers_count, results_queue_size)
    store = ParquetStore(dataset_url)
    view = _stored_view(store, schema_fields, 'make_tensor_reader')
    validate_tensor_schema(view)
    return Reader(store, view, pool, worker_class=TensorWorker,
                  shuffle_row_groups=shuffle_row_groups, seed=seed, num_epochs=num_epochs,
                  cur_shard=cur_shard, shard_count=shard_count, cache=cache,
                  resume_state=resume_state, deterministic=deterministic)


def make_pod_reader(dataset_url, reader_factory=None, pod_shard=None, mesh=None,
                    batch_axis='data', **kwargs):
    """A reader of this rank's data shard (``petastorm_tpu/reader.py:449-495``).

    ``cur_shard``/``shard_count`` come from
    :func:`~petastorm_tpu_torch.parallel.mesh.process_shard`: the rank's
    coordinate along ``batch_axis`` of ``mesh`` and that axis's size, so
    ranks that differ only on a tensor, sequence, expert or pipeline axis
    read the same rows (without a mesh, the rank and world of the default
    group). Every rank calls it alike; feed the result to a
    ``TorchLoader(..., mesh=mesh)``.

    :param reader_factory: the factory to wrap (default
        :func:`make_tensor_reader`; :func:`make_reader` for rows).
    :param pod_shard: ``(cur_shard, shard_count)`` overriding the mapping
        (simulated ranks in one process, or a launcher with its own).
    :param kwargs: forwarded to the factory; ``cur_shard`` or
        ``shard_count`` among them raises, since the mapping owns them.

    With ``deterministic=True`` the shards are strides of one global order,
    so their round-robin interleave is the one-rank stream for every shard
    count.
    """
    if 'cur_shard' in kwargs or 'shard_count' in kwargs:
        raise ValueError(
            'make_pod_reader owns cur_shard/shard_count (it maps them to the rank\'s '
            'coordinate on the mesh\'s batch axis); pass pod_shard=(i, n) to override, or '
            'call the underlying factory directly')
    if reader_factory is None:
        reader_factory = make_tensor_reader
    if pod_shard is None:
        from petastorm_tpu_torch.parallel.mesh import process_shard
        pod_shard = process_shard(mesh, batch_axis)
    cur_shard, shard_count = int(pod_shard[0]), int(pod_shard[1])
    if shard_count > 1:
        return reader_factory(dataset_url, cur_shard=cur_shard, shard_count=shard_count,
                              **kwargs)
    # A one-shard stride is the whole stream: no sharding arguments at all.
    return reader_factory(dataset_url, **kwargs)


def _check_resume_state(resume_state, deterministic, fingerprint):
    """The refusals and the config-drift warning of
    ``petastorm_tpu/reader.py:732-767``."""
    if not deterministic and resume_state.get('mode') == determinism.MODE:
        raise ValueError('resume_state is a deterministic-mode stream cursor; build the resumed '
                         'reader with deterministic=True (a multiset tracker would silently '
                         'ignore it)')
    if (deterministic and not resume_state.get('merged')
            and int(resume_state.get('shard_count') or 1) > 1):
        raise ValueError(
            "resume_state is host {} of {}'s private cursor; a multi-host deterministic resume "
            "must pass ALL hosts' cursors through determinism.merge_cursors() and give every "
            'resuming host the single merged result'.format(
                resume_state.get('cur_shard'), resume_state.get('shard_count')))
    stored = resume_state.get('config')
    if stored is not None:
        # Only keys both sides know: a state of another version lacks some.
        differing = sorted(k for k in set(stored) & set(fingerprint)
                           if stored[k] != fingerprint[k])
        if differing:
            warnings.warn('resume_state was captured under a different reader configuration '
                          '(differing: {}); resume positions may be meaningless'.format(differing))


class Reader(DeferredRowAccounting):
    """Iterates decoded rows (``worker_class=PyDictWorker``) or row-group
    chunks (``TensorWorker``) off a worker pool. ``batched_output`` says
    which."""

    def __init__(self, store, schema, pool, worker_class=TensorWorker, shuffle_row_groups=True,
                 seed=None, num_epochs=1, cur_shard=None, shard_count=None, cache=None,
                 resume_state=None, deterministic=False):
        # A mistyped memory budget fails before any thread starts.
        membudget.validate_env_budget()
        if (cur_shard is None) != (shard_count is None):
            raise ValueError('cur_shard and shard_count must be specified together')
        if cur_shard is not None and not 0 <= cur_shard < shard_count:
            raise ValueError('cur_shard {} out of range [0, {})'.format(cur_shard, shard_count))
        self.schema = schema
        self._store = store
        self._deterministic = bool(deterministic)
        self._seed = seed
        self._cur_shard = cur_shard
        self._shard_count = shard_count
        self._num_epochs = num_epochs
        self._lineage_mode = worker_class.lineage_mode
        pieces = store.row_groups()
        # Deterministic mode strides the shard over the global order in the
        # ventilator, so every host keeps the whole list.
        if shard_count is not None and not self._deterministic:
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
        self.last_row_consumed = False
        self._last_lineage = None
        self._config_fingerprint = {
            'url': store.url,
            'fields': sorted(schema.fields),
            'num_epochs': num_epochs,
            'cur_shard': None if self._deterministic else cur_shard,
            'shard_count': None if self._deterministic else shard_count,
            'deterministic': self._deterministic,
            'shuffle_row_groups': bool(shuffle_row_groups),
            'seed': seed if self._deterministic else None,
            'shuffle_row_drop_partitions': 1,
            'shuffle_rows_in_chunk': False,
            'n_row_groups': len(pieces),
            'predicate': None,
            'selector': None,
            'row_group_ids': [hashlib.md5('{}:{}'.format(p.path, p.row_group).encode())
                              .hexdigest()[:8] for p in pieces],
        }
        if resume_state is not None:
            _check_resume_state(resume_state, self._deterministic, self._config_fingerprint)
        self._resequencer = None
        if self._deterministic:
            if not hasattr(pool, 'set_resequencer'):
                raise ValueError('deterministic=True requires a pool that can resequence; {} '
                                 'cannot'.format(type(pool).__name__))
            self._tracker = determinism.DeterministicCursor(resume_state)
            self._resequencer = determinism.Resequencer()
            pool.set_resequencer(self._resequencer)
        else:
            self._tracker = ConsumptionTracker(resume_state, num_epochs=num_epochs)
        items = [{'piece_index': i, 'shuffle_row_drop_partition': (0, 1)}
                 for i in range(len(pieces))]
        det_config = None
        if self._deterministic:
            if shard_count is not None and shard_count > len(items):
                raise NoDataAvailableError(
                    'deterministic shard stride needs at least one item per shard: {} items < '
                    '{} shards'.format(len(items), shard_count))
            self._tracker.normalize(len(items))
            det_config = {'seed': seed, 'shuffle': bool(shuffle_row_groups),
                          'cur_shard': cur_shard or 0, 'shard_count': shard_count or 1,
                          'start_epoch': self._tracker.start_epoch,
                          'start_pos': self._tracker.start_pos}
        self._ventilator = ConcurrentVentilator(
            ventilate_fn=None,   # bound by pool.start
            items_to_ventilate=items,
            iterations=num_epochs,
            randomize_item_order=shuffle_row_groups and not self._deterministic,
            random_seed=seed,
            max_ventilation_queue_size=pool.workers_count + _VENTILATE_EXTRA_ROWGROUPS,
            deterministic=det_config)
        dataset_path_hash = hashlib.md5(store.url.encode()).hexdigest()[:12]
        if self.chunk_store is not None:
            # The store's readahead rides the dispatch order: the moment a
            # row-group is scheduled, its entry's pages are asked for.
            readahead = self.chunk_store.readahead
            keys = [chunk_store_mod.tensor_chunk_key(dataset_path_hash, p.path, p.row_group,
                                                     schema) for p in pieces]

            def on_ventilate(item):
                readahead(keys[item['piece_index']])

            self._ventilator.on_ventilate = on_ventilate
        pool.start(worker_class, {
            'row_groups': pieces, 'schema': schema, 'cache': self.cache,
            'dataset_path_hash': dataset_path_hash,
        }, self._ventilator)
        self._register_memory_pools()

    # -- host memory governor ----------------------------------------------

    def _register_memory_pools(self):
        """The reader's pools (``petastorm_tpu/reader.py:965-1012``): the
        results queue (its shed hook paces ventilation), the memory cache
        (degrade: LRU eviction), the chunk store (advisory: pause spill;
        degrade: drop LRU mmaps), the resequencer. A breach is raised by
        the next ``next()``, also from inside a wait on the pool."""
        governor = membudget.get_governor()
        self._mem_handles = []
        self._mem_shed_saved_watermark = None
        self._mem_shed_tight = None
        self._mem_shed_active = False
        self._stall_error = None
        pool = self._pool
        if hasattr(pool, 'results_nbytes'):
            self._mem_handles.append(governor.register_pool(
                'results-queue', pool.results_nbytes, shed_fn=self._shed_ventilation))
        if isinstance(self.cache, MemoryCache):
            cache = self.cache
            self._mem_handles.append(governor.register_pool(
                'memory-cache', lambda: cache.nbytes, degrade_fn=cache.evict))
        if self.chunk_store is not None:
            store = self.chunk_store
            self._mem_handles.append(governor.register_pool(
                'chunk-store', store.governed_nbytes, degrade_fn=store.close_lru_mmaps,
                advisory_fn=store.set_spill_paused))
        if self._resequencer is not None:
            self._mem_handles.append(governor.register_pool(
                'resequencer', self._resequencer.buffered_nbytes))

        def deliver_breach(error):
            self._stall_error = error
            inject = getattr(self._pool, 'inject_consumer_error', None)
            if inject is not None:
                inject(error)

        self._mem_breach_sink = governor.add_breach_sink(deliver_breach)
        self._mem_armed = membudget.maybe_arm_from_env()

    def _shed_ventilation(self, active):
        """The shed rung: a tight results watermark (an eighth of the queue,
        at least 2) makes the ventilator feed one item at a time; the
        previous watermark comes back when the ladder recedes, unless
        something else changed it meanwhile. Feeding order is unchanged."""
        pool = self._pool
        if active:
            if self._mem_shed_active:
                return
            self._mem_shed_active = True
            self._mem_shed_saved_watermark = pool.results_watermark
            self._mem_shed_tight = max(2, (pool.results_capacity or 8) // 8)
            pool.results_watermark = self._mem_shed_tight
        elif self._mem_shed_active:
            self._mem_shed_active = False
            if pool.results_watermark == self._mem_shed_tight:
                pool.results_watermark = self._mem_shed_saved_watermark

    @property
    def deterministic(self):
        """True when built with ``deterministic=True``."""
        return self._deterministic

    @property
    def chunk_store(self):
        """The reader's :class:`~petastorm_tpu_torch.chunk_store.DecodedChunkStore`
        (``cache_type='chunk-store'``, or ``PSTT_CHUNK_STORE``), else None."""
        return self.cache if getattr(self.cache, 'is_chunk_store', False) else None

    def cache_stats(self):
        """``{'type', 'hits', 'misses', 'nbytes'}`` of the row-group cache
        (zeros for the null cache); the chunk store adds its own counters
        (``fills``, ``writes``, ``corrupt_quarantined``, ``readaheads``,
        ...), ``nbytes`` being the host bytes it holds."""
        cache = self.cache
        if self.chunk_store is not None:
            return dict(cache.stats(), type='chunk-store', nbytes=cache.governed_nbytes())
        if isinstance(cache, (MemoryCache, LocalDiskCache)):
            return {'type': 'memory' if isinstance(cache, MemoryCache) else 'local-disk',
                    'hits': cache.hits, 'misses': cache.misses, 'nbytes': cache.nbytes}
        return {'type': 'null', 'hits': 0, 'misses': 0, 'nbytes': 0}

    @property
    def stage_timings(self):
        """Worker seconds summed over the row-groups delivered so far:
        ``read_s`` (Parquet), ``decode_s`` (codecs), ``cache_s`` (the
        cache's own bookkeeping), and ``chunks``."""
        return dict(self._timings)

    @property
    def last_chunk_lineage(self):
        """Provenance segment of the chunk (or, per row, the row) most
        recently returned: ``row_start`` is past any resume skip."""
        return self._last_lineage

    def __iter__(self):
        return self

    def _next_chunk(self):
        """The next non-hole chunk off the pool (in ventilation order in
        deterministic mode), its timings added up."""
        while True:
            try:
                chunk = self._pool.get_results()
            except EmptyResultError:
                self.last_row_consumed = True
                raise StopIteration
            if determinism.is_hole(chunk):
                continue
            for key, seconds in chunk['timings'].items():
                self._timings[key] += seconds
            self._timings['chunks'] += 1
            return chunk

    def _next_cols(self):
        """The next chunk's column blocks, past any resume skip."""
        while True:
            chunk = self._next_chunk()
            cols, key, det, lineage = chunk['cols'], chunk['key'], chunk.get('det'), \
                chunk['lineage']
            n_rows = len(next(iter(cols.values())))
            skip = self._tracker.on_chunk(key, n_rows, det=det)
            if skip:
                cols = {k: v[skip:] for k, v in cols.items()}
                n_rows -= skip
                lineage = dict(lineage, row_start=lineage['row_start'] + skip)
            if n_rows <= 0:
                continue
            self._record_chunk(key, n_rows)
            self._last_lineage = lineage
            return cols

    def __next__(self):
        if self._stopped:
            raise RuntimeError('Trying to iterate a stopped Reader')
        if self._stall_error is not None:
            raise self._stall_error
        if self.batched_output:
            return self.schema.make_namedtuple(**self._next_cols())
        while not self._rows:
            chunk = self._next_chunk()
            key, rows, det = chunk['key'], chunk['rows'], chunk.get('det')
            skip = self._tracker.on_chunk(key, len(rows), det=det)
            self._rows.extend((key, row, chunk['lineage'], skip + i)
                              for i, row in enumerate(rows[skip:]))
        key, row, lineage, row_index = self._rows.popleft()
        self._last_lineage = dict(lineage, row_start=row_index)
        self._tracker.rows_yielded(key, 1)
        return self.schema.make_namedtuple(**row)

    # -- checkpoint and provenance -----------------------------------------

    def enable_row_granular_checkpoint(self):
        """Defer the row accounting of chunks to :meth:`rows_consumed`, for a
        loader that consumes rows in delivery order: rows it still holds at
        a checkpoint re-deliver on resume. False for per-row readers, which
        count each row as it leaves."""
        if not self.batched_output:
            return False
        self.enable_deferred_rows()
        return True

    def state_dict(self):
        """JSON-safe position for ``resume_state=`` (see the module
        docstring): the tracker's state, the shard identity of a
        deterministic cursor, and the config fingerprint."""
        state = self._tracker.state_dict()
        if self._deterministic:
            state['cur_shard'] = self._cur_shard or 0
            state['shard_count'] = self._shard_count or 1
        state['config'] = self._config_fingerprint
        return state

    def lineage_context(self):
        """The static facts a provenance record needs to be replayed
        (JSON-safe; the JAX package's keys)."""
        return {
            'mode': self._lineage_mode,
            'url': self._store.url,
            'dataset_path_hash': hashlib.md5(self._store.url.encode()).hexdigest()[:12],
            'fields': sorted(self.schema.fields),
            'schema_hash': hashlib.md5(','.join(sorted(self.schema.fields)).encode())
            .hexdigest()[:8],
            'seed': self._seed,
            'cur_shard': self._cur_shard,
            'shard_count': self._shard_count,
            'num_epochs': self._num_epochs,
            'shuffle_rows_in_chunk': False,
            'deterministic': self._deterministic,
            'n_row_groups': len(self._row_groups),
            'transform': None,
            'predicate': None,
            'ngram': False,
        }

    def lineage_state(self):
        """The live shuffle state sampled into each provenance record."""
        return self._ventilator.lineage_state()

    def reset(self):
        """Read another round of ``num_epochs`` once every row was consumed."""
        if not self.last_row_consumed:
            raise NotImplementedError('Currently reset() is supported only after all rows were '
                                      'consumed')
        self.last_row_consumed = False
        if self._resequencer is not None:
            self._resequencer.reset()   # before the ventilator restarts its seq at 0
        self._ventilator.reset()

    def stop(self):
        """Stop the workers, unregister the memory pools (releasing the
        governor's arm reference) and stop the chunk store's writer once its
        queued writes are on disk. Idempotent."""
        governor = membudget.get_governor()
        for handle in self._mem_handles:
            handle.close()
        self._mem_handles = []
        governor.remove_breach_sink(self._mem_breach_sink)
        if self._mem_armed:
            self._mem_armed = False
            governor.release()
        self._pool.stop()
        if self.chunk_store is not None:
            self.chunk_store.close()
        self._stopped = True

    def join(self):
        self._pool.join()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.stop()
        self.join()
        return False
