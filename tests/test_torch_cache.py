"""The port's decoded-chunk memory cache, its ``cache_type='memory'``
reader and ``TorchLoader.superbatches`` held against the JAX package.

The cache is held against ``petastorm_tpu.cache.MemoryCache`` on one
sequence of ``get`` calls (hits, misses, evictions, bytes). The reader and
loader read one store, written by the JAX package's writer (PNG images, so
both decoders give the same pixels; int32 ids, which the JAX loader does
not narrow), with one worker and the same seed: every batch must be
CRC32-equal (``lineage._digest_array``).
"""

import threading

import numpy as np
import pytest

from petastorm_tpu import make_tensor_reader as jax_make_tensor_reader
from petastorm_tpu.cache import MemoryCache as JaxMemoryCache
from petastorm_tpu.codecs import CompressedImageCodec as JaxImageCodec
from petastorm_tpu.codecs import ScalarCodec as JaxScalarCodec
from petastorm_tpu.etl.writer import write_dataset as jax_write_dataset
from petastorm_tpu.jax_loader import JaxLoader
from petastorm_tpu.lineage import _digest_array
from petastorm_tpu.unischema import Unischema as JaxUnischema, UnischemaField as JaxField
from petastorm_tpu_torch import TorchLoader, make_tensor_reader
from petastorm_tpu_torch.cache import MemoryCache, NullCache, approx_nbytes
from petastorm_tpu_torch.tensor_worker import tensor_chunk_key

ROWS, PER_GROUP, GROUPS = 60, 10, 6


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    schema = JaxUnischema('CacheSchema', [
        JaxField('image', np.uint8, (6, 5, 3), JaxImageCodec('png'), False),
        JaxField('id', np.int32, (), JaxScalarCodec(np.int32), False),
    ])
    rng = np.random.default_rng(21)
    url = 'file://' + str(tmp_path_factory.mktemp('cache') / 'store')
    jax_write_dataset(url, schema, ({'image': rng.integers(0, 256, (6, 5, 3), dtype=np.uint8),
                                     'id': np.int32(i)} for i in range(ROWS)),
                      rows_per_row_group=PER_GROUP)
    return url


def _digests(batch):
    return {name: _digest_array(np.asarray(value)) for name, value in batch.items()}


# -- MemoryCache -------------------------------------------------------------

@pytest.mark.parametrize('limit', [None, 250, 1000])
def test_memory_cache_matches_jax_on_one_get_sequence(limit):
    rng = np.random.default_rng(limit or 0)
    sizes = {key: int(rng.integers(10, 200)) for key in 'abcdefgh'}
    keys = [str(k) for k in rng.choice(list(sizes), 60)]
    ours, theirs = MemoryCache(limit), JaxMemoryCache(limit)
    for key in keys:
        want = theirs.get(key, lambda: np.zeros(sizes[key], np.uint8))
        got = ours.get(key, lambda: np.zeros(sizes[key], np.uint8))
        assert got.shape == want.shape
        assert (ours.hits, ours.misses, ours.nbytes) == (theirs.hits, theirs.misses,
                                                         theirs.nbytes)
        assert list(ours._entries) == list(theirs._entries)      # same LRU order
    assert ours.evict(0.5) == theirs.evict(0.5)
    assert list(ours._entries) == list(theirs._entries)
    ours.cleanup()
    assert ours.nbytes == 0 and not ours._entries


def test_memory_cache_single_flight_under_threads():
    cache, calls, gate = MemoryCache(), [], threading.Event()

    def fill():
        calls.append(1)
        gate.wait(5)
        return np.arange(4)

    results = []
    threads = [threading.Thread(target=lambda: results.append(cache.get('k', fill)))
               for _ in range(6)]
    for t in threads:
        t.start()
    gate.set()
    for t in threads:
        t.join(10)
    assert len(calls) == 1 and len(results) == 6
    assert all(r is results[0] for r in results)
    assert (cache.misses, cache.hits) == (1, 5)


def test_memory_cache_raising_fill_caches_nothing_and_none_is_cached():
    cache = MemoryCache()

    def boom():
        raise IOError('transient read error')

    with pytest.raises(IOError):
        cache.get('k', boom)
    assert cache.nbytes == 0 and cache.misses == 0 and not cache._entries
    assert cache.get('k', lambda: np.ones(3)).sum() == 3     # the key refills
    fills = []
    assert cache.get('empty', lambda: fills.append(1)) is None
    assert cache.get('empty', lambda: fills.append(1)) is None
    assert fills == [1] and cache.hits == 1
    assert approx_nbytes({'a': np.zeros(8, np.float32)}) == 32 + approx_nbytes('a')


def test_null_cache_always_fills():
    fills = []
    cache = NullCache()
    for _ in range(3):
        cache.get('k', lambda: fills.append(1))
    assert len(fills) == 3


# -- the reader's memory tier ------------------------------------------------

def _jax_epochs(url, batch, epochs, superbatch=None):
    with jax_make_tensor_reader(url, reader_pool_type='thread', workers_count=1, seed=4,
                                num_epochs=epochs, cache_type='memory') as reader:
        with JaxLoader(reader, batch, prefetch=2, last_batch='drop') as loader:
            it = loader.superbatches(superbatch) if superbatch else loader
            return [{name: np.asarray(getattr(b, name)) for name in b._fields} for b in it]


def test_memory_tier_batches_equal_jax_and_count_hits(store):
    theirs = _jax_epochs(store, 8, 2)
    with make_tensor_reader(store, workers_count=1, seed=4, num_epochs=2,
                            cache_type='memory') as reader:
        with TorchLoader(reader, 8, device='cpu', prefetch=2) as loader:
            ours = []
            for b in loader:
                ours.append({name: getattr(b, name).numpy().copy() for name in b._fields})
                # A caller that writes into its batch must not reach the cache.
                b.image.fill_(0)
                b.id.fill_(-1)
            stats = reader.cache_stats()
    assert len(ours) == len(theirs) == 2 * ROWS // 8
    for got, want in zip(ours, theirs):
        assert _digests(got) == _digests(want)
    assert stats['type'] == 'memory'
    assert (stats['misses'], stats['hits']) == (GROUPS, GROUPS)
    assert stats['nbytes'] >= ROWS * (6 * 5 * 3 + 4)
    # Each row twice across the two epochs, epoch 2 unharmed by the writes.
    ids = np.concatenate([b['id'] for b in ours])
    assert sorted(ids.tolist()) == sorted(2 * list(range(ROWS)))


def test_cached_blocks_are_read_only(store):
    with make_tensor_reader(store, workers_count=1, num_epochs=1, cache_type='memory') as reader:
        chunk = next(reader)
        with pytest.raises(ValueError, match='read-only'):
            chunk.image[0, 0, 0, 0] = 1
        assert reader.cache_stats()['misses'] >= 1
    with make_tensor_reader(store, workers_count=1, num_epochs=1) as reader:
        chunk = next(reader)
        assert chunk.image.flags.writeable
        assert reader.cache_stats() == {'type': 'null', 'hits': 0, 'misses': 0, 'nbytes': 0}


@pytest.mark.parametrize('cache_type', ['local-disk', 'chunk-store', 'bogus'])
def test_other_cache_tiers_are_refused(store, cache_type, monkeypatch):
    # The disk tiers refuse to start without a directory; an unknown tier
    # is refused by name.
    monkeypatch.delenv('PSTT_CHUNK_STORE', raising=False)
    match = {'local-disk': 'requires cache_location', 'chunk-store': 'needs a directory',
             'bogus': 'Unknown cache_type'}[cache_type]
    with pytest.raises(ValueError, match=match):
        make_tensor_reader(store, cache_type=cache_type)


def test_chunk_key_tracks_file_content_and_fields(store, tmp_path):
    from petastorm_tpu.chunk_store import tensor_chunk_key as jax_key
    from petastorm_tpu_torch.etl import get_schema
    from petastorm_tpu_torch.storage import ParquetStore

    parquet_store = ParquetStore(store)
    schema = get_schema(parquet_store)
    piece = parquet_store.row_groups()[0]
    key = tensor_chunk_key('h', piece.path, piece.row_group, schema)
    assert key == jax_key('h', piece.path, piece.row_group, schema)
    view = schema.create_schema_view([schema.fields['id']])
    assert tensor_chunk_key('h', piece.path, piece.row_group, view) != key


# -- superbatches ------------------------------------------------------------

@pytest.mark.parametrize('k', [1, 2, 4])
@pytest.mark.parametrize('cache_type', ['null', 'memory'])
def test_superbatches_equal_jax_loader(store, k, cache_type):
    theirs = _jax_epochs(store, 5, 1, superbatch=k)
    with make_tensor_reader(store, workers_count=1, seed=4, num_epochs=1,
                            cache_type=cache_type) as reader:
        with TorchLoader(reader, 5, device='cpu', prefetch=1) as loader:
            ours = [{name: getattr(b, name).numpy().copy() for name in b._fields}
                    for b in loader.superbatches(k)]
    assert len(ours) == len(theirs) == (ROWS // 5) // k          # a partial group is dropped
    for got, want in zip(ours, theirs):
        assert got['image'].shape == (5 * k, 6, 5, 3)
        assert _digests(got) == _digests(want)
