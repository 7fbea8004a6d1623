"""LookupEngine: the local point-read request path (counterpart of
``petastorm_tpu/serving/engine.py``).

Resolves ``lookup(keys)`` / ``query(predicate, selector)`` through the
row-level index (:mod:`~petastorm_tpu_torch.serving.row_index`) and serves
decoded rows from the cache hierarchy the training feed warms:

* **memory**: a small per-engine LRU of recently served blocks
  (``membudget``-registered as ``lookup-blocks``: the governor's degrade
  rung sheds its older half);
* **chunk store**: the row-group's decoded block mmapped out of the
  :class:`~petastorm_tpu_torch.chunk_store.DecodedChunkStore` under the
  training ``TensorWorker``'s own
  :func:`~petastorm_tpu_torch.chunk_store.tensor_chunk_key`, so an epoch
  that ran (or ``tools.transcode``) makes every point read warm, and a
  lookup-driven fill warms the next epoch;
* **decode**: read and decode the row-group through
  ``decode_table_to_blocks``, the workers' own path, with **per-row-group
  coalescing** (:class:`_Fill`): of N concurrent requests on one cold
  row-group, one decodes and the rest wait on its fill.

The tier labels (``pst_lookup_cache_hits_total{tier}``), the chunk keys
and the packed-chunk bytes of the warm join are the JAX package's. The
engine is thread-safe; the block path takes no lock once a block is
resident. This module imports no torch.
"""

import hashlib
import logging
import threading
from collections import OrderedDict

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

logger = logging.getLogger(__name__)

#: Cache-tier labels for ``pst_lookup_cache_hits_total{tier}``.
TIER_MEMORY = 'memory'
TIER_DECODE = 'decode'
TIER_COALESCED = 'coalesced'

_DEFAULT_BLOCK_CACHE_ENTRIES = 8


class _Fill(object):
    """One in-flight block fill other requests coalesce onto."""

    __slots__ = ('event', 'cols', 'tier', 'error')

    def __init__(self):
        self.event = threading.Event()
        self.cols = None
        self.tier = None
        self.error = None


class LookupEngine(object):
    """Low-latency random access over one dataset.

    :param dataset_url: the dataset to serve (``file://``, ...).
    :param index_name: name of the row-level index
        (``SingleFieldRowIndexer``) to resolve keys through; ``None``
        auto-selects when the dataset stores exactly one.
    :param cache: the hot tier — a
        :class:`~petastorm_tpu_torch.chunk_store.DecodedChunkStore` (or any
        ``CacheBase``), a directory path (builds a chunk store there; the
        engine owns and closes it), or ``None`` (every cold block is a
        fresh decode; the in-engine LRU still absorbs hot row-groups).
        Share the TRAINING pipeline's store directory so both sides warm
        one cache.
    :param schema_fields: field-name list to serve (``None`` = all). Must
        match the training reader's selection for chunk-store keys to
        line up (the key hashes the schema's field set).
    :param block_cache_entries: in-engine decoded-block LRU depth.
    :param decode_threads: decode threads per miss (``None`` = the
        process decode budget's share).
    """

    def __init__(self, dataset_url, index_name=None, cache=None,
                 schema_fields=None, storage_options=None,
                 block_cache_entries=_DEFAULT_BLOCK_CACHE_ENTRIES,
                 decode_threads=None):
        from petastorm_tpu_torch import metrics as metrics_mod
        from petastorm_tpu_torch.etl.dataset_metadata import get_schema
        from petastorm_tpu_torch.serving.row_index import RowLocationIndex
        from petastorm_tpu_torch.storage import ParquetStore
        from petastorm_tpu_torch.tensor_worker import validate_tensor_schema

        self._store = ParquetStore(dataset_url, storage_options)
        schema = get_schema(self._store)
        if schema_fields is not None:
            schema = schema.create_schema_view(list(schema_fields))
        # Same constraint as make_tensor_reader: rows decode into dense
        # blocks (that is what the chunk store persists and what a
        # memcpy-speed hit requires).
        validate_tensor_schema(schema)
        self.schema = schema
        self._pieces = self._store.row_groups()
        self._partition_names = set(self._store.partition_names)
        self._physical = [n for n in schema.fields
                          if n not in self._partition_names]
        self._path_hash = hashlib.md5(
            self._store.url.encode()).hexdigest()[:12]
        self.index = RowLocationIndex.load(self._store, index_name)
        if self.index.field not in schema.fields:
            raise ValueError(
                'row index {!r} keys field {!r}, which the served schema '
                'does not include'.format(self.index.name, self.index.field))
        self._decode_threads = decode_threads

        self._owns_cache = isinstance(cache, str)
        if self._owns_cache:
            from petastorm_tpu_torch.chunk_store import DecodedChunkStore
            cache = DecodedChunkStore(cache)
        self._cache = cache

        self._lock = threading.Lock()
        self._blocks = OrderedDict()        # piece_index -> cols dict
        self._max_blocks = max(1, int(block_cache_entries))
        self._fills = {}                    # piece_index -> _Fill
        self._tier_counts = {}
        self._coalesced = 0
        self._closed = False

        self._m_hits = metrics_mod.counter(
            'pst_lookup_cache_hits_total',
            'Lookup-path block fetches, by serving tier',
            labelnames=('tier',))
        self._m_warm_fills = metrics_mod.counter(
            'pst_partition_warm_fill_chunks_total',
            'Chunk-store entries pre-filled from a peer replica at '
            'warm join')
        # Open-mmap / block accounting rides the memory governor like
        # every other byte-holding pool: the LRU sheds on degrade, and an
        # engine-owned chunk store registers its mmap residency too.
        from petastorm_tpu_torch import membudget
        self._mem_handles = [membudget.register_pool(
            'lookup-blocks', self._blocks_nbytes,
            degrade_fn=self._shed_blocks)]
        if self._owns_cache:
            self._mem_handles.append(membudget.register_pool(
                'lookup-store', cache.governed_nbytes,
                degrade_fn=cache.close_lru_mmaps,
                advisory_fn=cache.set_spill_paused))

    # -- cache accounting --------------------------------------------------

    def _blocks_nbytes(self):
        with self._lock:
            blocks = list(self._blocks.values())
        return sum(int(getattr(arr, 'nbytes', 0))
                   for cols in blocks for arr in cols.values())

    def _shed_blocks(self):
        """Governor degrade hook: drop the older half of the block LRU.
        Returns True when anything was released."""
        with self._lock:
            keep = len(self._blocks) // 2
            dropped = 0
            while len(self._blocks) > keep:
                self._blocks.popitem(last=False)
                dropped += 1
        return dropped > 0

    def _count_tier(self, tier):
        self._m_hits.labels(tier).inc()
        with self._lock:
            self._tier_counts[tier] = self._tier_counts.get(tier, 0) + 1

    # -- block path --------------------------------------------------------

    def _chunk_key(self, piece):
        from petastorm_tpu_torch.chunk_store import tensor_chunk_key
        return tensor_chunk_key(self._path_hash, piece.path,
                                piece.row_group, self.schema)

    def _decode_block(self, piece):
        """Read + decode one row-group into ``{field: block}`` — the same
        path ``TensorWorker.load()`` takes on a cache miss, so a
        lookup-driven fill publishes byte-identical blocks."""
        from petastorm_tpu_torch.tensor_worker import decode_table_to_blocks
        with self._store.open_file(piece.path) as f:
            table = pq.ParquetFile(f).read_row_group(
                piece.row_group, columns=self._physical)
        for name, value in piece.partition_values.items():
            if name in self.schema.fields \
                    and name not in table.column_names:
                table = table.append_column(
                    name, pa.array([value] * table.num_rows))
        return decode_table_to_blocks(table, self.schema,
                                      decode_threads=self._decode_threads)

    def _fetch_block(self, piece_index):
        """``{field: block}`` for one row-group, through memory LRU ->
        chunk store -> decode, coalescing concurrent cold fetches."""
        while True:
            with self._lock:
                if self._closed:
                    raise RuntimeError('LookupEngine is closed')
                cols = self._blocks.get(piece_index)
                if cols is not None:
                    self._blocks.move_to_end(piece_index)
                    self._m_hits.labels(TIER_MEMORY).inc()
                    self._tier_counts[TIER_MEMORY] = \
                        self._tier_counts.get(TIER_MEMORY, 0) + 1
                    return cols
                fill = self._fills.get(piece_index)
                filler = fill is None
                if filler:
                    fill = self._fills[piece_index] = _Fill()
            if not filler:
                fill.event.wait()
                if fill.error is not None:
                    raise fill.error
                self._m_hits.labels(TIER_COALESCED).inc()
                with self._lock:
                    self._tier_counts[TIER_COALESCED] = \
                        self._tier_counts.get(TIER_COALESCED, 0) + 1
                    self._coalesced += 1
                return fill.cols
            try:
                cols, tier = self._fill_block(piece_index)
                fill.cols, fill.tier = cols, tier
            except Exception as e:  # noqa: BLE001 - waiters re-raise it too
                fill.error = e
                raise
            finally:
                with self._lock:
                    self._fills.pop(piece_index, None)
                    if fill.cols is not None:
                        self._blocks[piece_index] = fill.cols
                        while len(self._blocks) > self._max_blocks:
                            self._blocks.popitem(last=False)
                fill.event.set()
            self._count_tier(tier)
            return cols

    def _fill_block(self, piece_index):
        """(cols, tier) through the shared cache (or a bare decode)."""
        piece = self._pieces[piece_index]
        if self._cache is None:
            return self._decode_block(piece), TIER_DECODE
        decoded_fresh = []

        def load():
            decoded_fresh.append(True)
            return self._decode_block(piece)

        cols = self._cache.get(self._chunk_key(piece), load)
        if cols is None:       # empty row-group (cannot happen via index)
            cols = {name: np.empty((0,)) for name in self.schema.fields}
        tier = (TIER_DECODE if decoded_fresh
                else getattr(self._cache, 'lineage_tier', 'cache'))
        return cols, tier

    # -- fleet support -----------------------------------------------------

    @property
    def piece_count(self):
        return len(self._pieces)

    def chunk_key(self, piece_index):
        """The chunk-store cache key of one row-group piece — identical
        across replicas serving the same dataset url/schema, which is
        what makes peer-to-peer cache warming sound."""
        return self._chunk_key(self._pieces[piece_index])

    def has_cached(self, piece_index):
        """True when the hot tier already holds this piece (warm join
        skips it without touching the peer)."""
        has = getattr(self._cache, 'has', None)
        if not callable(has):
            return False
        return bool(has(self.chunk_key(piece_index)))

    def packed_chunk(self, piece_index):
        """One piece's decoded block serialized in the chunk-store
        layout (CRC-protected) — the peer side of the warm-join
        protocol. Fetches through the normal tier ladder, so exporting
        warms the exporter too."""
        from petastorm_tpu_torch.chunk_store import pack_tensor_chunk
        return pack_tensor_chunk(self._fetch_block(piece_index))

    def warm_fill(self, piece_index, blob):
        """The joining side: validate a peer's packed chunk and persist
        it straight into this engine's :class:`DecodedChunkStore` under
        the piece's own ``tensor_chunk_key`` — the piece's first real
        read then hits the chunk-store tier instead of cold-decoding.
        Raises ``CorruptChunkError`` on a torn/bit-rotted blob and
        ``ValueError`` when the peer served a different field set."""
        from petastorm_tpu_torch.chunk_store import read_tensor_chunk
        put = getattr(self._cache, 'put', None)
        if not callable(put):
            raise ValueError(
                'warm_fill needs a DecodedChunkStore hot tier (engine '
                'cache is {!r})'.format(type(self._cache).__name__))
        cols = read_tensor_chunk(bytes(blob),
                                 source='warm-fill:{}'.format(piece_index))
        missing = set(self.schema.fields) - set(cols)
        if missing:
            raise ValueError('peer chunk for piece {} lacks served '
                             'fields {}'.format(piece_index,
                                                sorted(missing)))
        accepted = bool(put(self.chunk_key(piece_index), cols))
        if accepted:
            self._m_warm_fills.inc()
        return accepted

    def pieces_for_partitions(self, pmap, partitions):
        """Row-group piece ordinals a replica owning ``partitions``
        should hold warm: every piece the modular query cover assigns it
        plus every piece holding a key that hashes into one of its
        partitions (resolved through the row index)."""
        wanted = set(int(p) for p in partitions)
        pieces = set()
        for pid in wanted:
            pieces.update(pmap.pieces_of_partition(pid, len(self._pieces)))
        for key in self.index.keys():
            if pmap.partition_of_key(key) in wanted:
                pieces.update(p for p, _ in self.index.locations(key))
        return sorted(pieces)

    # -- request path ------------------------------------------------------

    def _slice_row(self, cols, offset, fields):
        """One served row: a fresh copy of each field's row slice (the
        blocks may be shared read-only mmap views — the response must not
        alias the store)."""
        row = {}
        for name in fields:
            row[name] = np.array(cols[name][offset], copy=True)
        return row

    def _resolve_fields(self, fields):
        if fields is None:
            return list(self.schema.fields)
        unknown = [f for f in fields if f not in self.schema.fields]
        if unknown:
            raise ValueError('unknown fields {} (serving {})'.format(
                unknown, sorted(self.schema.fields)))
        return list(fields)

    def lookup(self, keys, fields=None):
        """Point reads: for each key, the list of matching rows (each a
        ``{field: numpy value}`` dict; empty list = key absent). Keys
        hitting one row-group share a single block fetch."""
        fields = self._resolve_fields(fields)
        locations = [self.index.locations(key) for key in keys]
        needed = []          # piece ordinals, deduped, in first-use order
        for locs in locations:
            for piece, _ in locs:
                if piece not in needed:
                    needed.append(piece)
        blocks = {piece: self._fetch_block(piece) for piece in needed}
        return [[self._slice_row(blocks[piece], offset, fields)
                 for piece, offset in locs]
                for locs in locations]

    def query(self, predicate, selector=None, limit=None, fields=None,
              pieces=None, with_locations=False):
        """Predicate scan with index pruning: evaluate ``predicate`` (a
        ``predicates.PredicateBase``, e.g. ``in_lambda``) over every row
        of the candidate row-groups — all of them, or the set a
        ``selectors``-module selector picks from the stored indexes —
        serving matches until ``limit``.

        ``pieces`` restricts the scan to those row-group ordinals (the
        fleet's scatter-gather sends each partition its modular share of
        the dataset, so the union over partitions covers every piece
        exactly once). ``with_locations=True`` wraps each match as
        ``{'piece', 'offset', 'row'}`` so a gatherer can merge partial
        results back into single-engine dataset order."""
        fields = self._resolve_fields(fields)
        if limit is not None and limit <= 0:
            return []
        predicate_fields = sorted(predicate.get_fields())
        unknown = set(predicate_fields) - set(self.schema.fields)
        if unknown:
            raise ValueError(
                'predicate uses fields the engine does not serve: {}'
                .format(sorted(unknown)))
        if selector is not None:
            from petastorm_tpu_torch.etl.rowgroup_indexing import \
                get_row_group_indexes
            indexes = get_row_group_indexes(self._store)
            candidates = sorted(
                p for p in selector.select_row_groups(indexes)
                if 0 <= p < len(self._pieces))
        else:
            candidates = range(len(self._pieces))
        if pieces is not None:
            allowed = set(int(p) for p in pieces)
            candidates = [p for p in candidates if p in allowed]
        rows = []
        for piece_index in candidates:
            cols = self._fetch_block(piece_index)
            n = len(next(iter(cols.values()))) if cols else 0
            for i in range(n):
                values = {f: cols[f][i] for f in predicate_fields}
                if predicate.do_include(values):
                    row = self._slice_row(cols, i, fields)
                    rows.append({'piece': piece_index, 'offset': i,
                                 'row': row} if with_locations else row)
                    if limit is not None and len(rows) >= limit:
                        return rows
        return rows

    # -- observability / lifecycle ----------------------------------------

    def flush(self, timeout_s=30.0):
        """Block until the hot tier's write-behind spill drains (lookup-
        driven fills are published asynchronously — flush before
        measuring warm reads or handing the store to another consumer).
        True when drained, or when the cache has no spill to flush."""
        cache_flush = getattr(self._cache, 'flush', None)
        if cache_flush is None:
            return True
        return bool(cache_flush(timeout_s))

    def stats(self):
        with self._lock:
            tiers = dict(self._tier_counts)
            resident = len(self._blocks)
        out = {'dataset_url': self._store.url,
               'index': self.index.name,
               'index_field': self.index.field,
               'indexed_keys': len(self.index),
               'row_groups': len(self._pieces),
               'tiers': tiers,
               'coalesced': self._coalesced,
               'resident_blocks': resident}
        cache_stats = getattr(self._cache, 'stats', None)
        if callable(cache_stats):
            out['store'] = cache_stats()
        return out

    def close(self):
        with self._lock:
            self._closed = True
            self._blocks.clear()
        for handle in self._mem_handles:
            handle.close()
        self._mem_handles = []
        if self._owns_cache:
            self._cache.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
