"""The port's disk cache tiers against the JAX package's on the CPU: the
decoded-chunk store's format (byte for byte), the store's behaviour (the
counterparts of ``tests/test_chunk_store.py`` that need no fault site),
``LocalDiskCache``, the readers over both tiers, a store filled by either
package serving the other, and the transcode tool.

Batches are compared by the JAX package's lineage digest (CRC32 of each
field's bytes), so they must be bit-identical. The store is PNG (both
decoders give the same pixels) with fields that neither package narrows.
The JAX package is imported inside the tests that use it, so that the
process the cross-process test spawns imports only the port.
"""

import json
import multiprocessing
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest

from petastorm_tpu_torch import (CompressedImageCodec, NdarrayCodec, ScalarCodec, TorchLoader,
                                 Unischema, UnischemaField, make_reader, make_tensor_reader,
                                 write_dataset)
from petastorm_tpu_torch.cache import LocalDiskCache
from petastorm_tpu_torch.chunk_store import (ENV_VAR, DecodedChunkStore, conforms_tensor_chunk,
                                             is_tensor_chunk, pack_tensor_chunk,
                                             read_tensor_chunk)
from petastorm_tpu_torch.errors import CorruptChunkError
from petastorm_tpu_torch.lineage import _digest_array
from petastorm_tpu_torch.workers.ventilator import ConcurrentVentilator

pytestmark = pytest.mark.chunkstore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, PER_GROUP, BATCH = 40, 10, 8
FIELDS = ['id', 'image', 'vec']


def _cols(seed=0):
    rng = np.random.default_rng(seed)
    return {'img': rng.integers(0, 255, (8, 4, 4, 3), dtype=np.uint8),
            'label': np.arange(8, dtype=np.int64),
            'score': rng.random((8, 2)).astype(np.float32)}


def _entry_files(store_dir):
    return sorted(f for f in os.listdir(store_dir) if f.endswith('.chunk'))


@pytest.fixture(scope='module')
def store_url(tmp_path_factory):
    schema = Unischema('StoreSchema', [
        UnischemaField('id', np.int32, (), ScalarCodec(np.int32)),
        UnischemaField('vec', np.float32, (3,), NdarrayCodec()),
        UnischemaField('image', np.uint8, (12, 10, 3), CompressedImageCodec('png')),
    ])
    rng = np.random.default_rng(5)
    url = 'file://' + str(tmp_path_factory.mktemp('chunkstore') / 'store')
    write_dataset(url, schema, ({'id': i, 'vec': rng.normal(size=3).astype(np.float32),
                                 'image': rng.integers(0, 256, (12, 10, 3), dtype=np.uint8)}
                                for i in range(ROWS)), rows_per_row_group=PER_GROUP)
    return url


def _chunk_digests(chunks):
    return [{name: _digest_array(np.asarray(getattr(c, name))) for name in c._fields}
            for c in chunks]


# -- the on-disk format -------------------------------------------------------

_DTYPE_CASES = {
    'uint8': np.arange(24, dtype=np.uint8).reshape(2, 3, 4),
    'int32': np.arange(-5, 7, dtype=np.int32),
    'int64': np.arange(10, dtype=np.int64) * (1 << 40),
    'float16': np.linspace(-2, 2, 9).astype(np.float16),
    'float32': np.random.default_rng(0).normal(size=(3, 5)).astype(np.float32),
    'bool': np.array([True, False, True, True]),
    'datetime64': np.array(['2026-08-03T12:00', '2026-08-03T13:00'], dtype='datetime64[ns]'),
}


@pytest.mark.parametrize('dtype', sorted(_DTYPE_CASES))
def test_pack_bytes_equal_jax_and_each_reads_the_other(dtype):
    from petastorm_tpu import chunk_store as jax_store
    cols = {'x': _DTYPE_CASES[dtype], 'label': np.arange(3, dtype=np.int64)}
    ours = pack_tensor_chunk(cols)
    theirs = jax_store.pack_tensor_chunk(cols)
    assert ours == theirs
    assert is_tensor_chunk(ours) and conforms_tensor_chunk(cols)
    for blob, reader in ((theirs, read_tensor_chunk), (ours, jax_store.read_tensor_chunk)):
        out = reader(blob)
        assert sorted(out) == sorted(cols)
        for name, arr in cols.items():
            assert out[name].dtype == arr.dtype and out[name].shape == arr.shape
            np.testing.assert_array_equal(out[name], arr)


def _truncated(blob):
    return blob[:len(blob) // 2]


def _bitflip(blob):
    blob = bytearray(blob)
    blob[-10] ^= 0xFF
    return bytes(blob)


def _header_shape(blob):
    idx = blob.find(b'[8, 4, 4, 3]')
    return blob[:idx] + b'[8, 9, 4, 3]' + blob[idx + 12:]


def _mangled_dtype(blob):
    idx = blob.find(b'"dtype": "<i8"')
    return blob[:idx] + b'"dtype": "|O8"' + blob[idx + 14:]


@pytest.mark.parametrize('corrupt', [_truncated, _bitflip, _header_shape, _mangled_dtype],
                         ids=['truncation', 'bitflip', 'header', 'dtype'])
def test_corruption_raises_corrupt_chunk_error(corrupt):
    blob = pack_tensor_chunk(_cols())
    bad = corrupt(blob)
    assert bad != blob
    with pytest.raises(CorruptChunkError):
        read_tensor_chunk(bad)
    with pytest.raises(CorruptChunkError):
        read_tensor_chunk(blob[:3])


# -- the store ----------------------------------------------------------------

def test_store_fill_then_mmap_hit_fresh_dict_per_hit(tmp_path):
    store = DecodedChunkStore(str(tmp_path / 'store'))
    cols = _cols()
    fills = []

    def fill():
        fills.append(1)
        return cols

    assert store.get('k', fill) is cols
    assert store.flush(timeout_s=10)
    a, b = store.get('k', fill), store.get('k', fill)
    assert len(fills) == 1
    assert a is not b and a['label'] is b['label']
    for name in cols:
        np.testing.assert_array_equal(a[name], cols[name])
    # MAP_PRIVATE: a write through a view stays out of the file.
    a['label'][0] = 999
    with open(store._entry_path('k'), 'rb') as f:
        np.testing.assert_array_equal(read_tensor_chunk(f.read())['label'], cols['label'])
    stats = store.stats()
    assert (stats['hits'], stats['misses'], stats['fills'], stats['writes']) == (2, 1, 1, 1)
    store.close()


def test_store_write_behind_is_atomic(tmp_path):
    store_dir = str(tmp_path / 'store')
    store = DecodedChunkStore(store_dir)
    for i in range(4):
        store.get('k{}'.format(i), lambda i=i: _cols(i))
    assert store.flush(timeout_s=10)
    assert len(_entry_files(store_dir)) == 4
    assert not [f for f in os.listdir(store_dir) if f.endswith(('.tmp', '.lock'))]
    store.close()


@pytest.mark.parametrize('damage', ['tail', 'truncate'])
def test_store_corrupt_entry_quarantined_and_refilled(tmp_path, damage):
    store_dir = str(tmp_path / 'store')
    store = DecodedChunkStore(store_dir)
    store.get('k', _cols)
    assert store.flush(timeout_s=10)
    store.close()
    entry = os.path.join(store_dir, _entry_files(store_dir)[0])
    with open(entry, 'r+b') as f:
        if damage == 'tail':
            f.seek(-8, os.SEEK_END)
            f.write(b'\xde\xad\xbe\xef')
        else:
            f.truncate(os.path.getsize(entry) // 2)
    fresh = DecodedChunkStore(store_dir)
    fills = []
    value = fresh.get('k', lambda: (fills.append(1), _cols())[1])
    assert len(fills) == 1
    np.testing.assert_array_equal(value['label'], _cols()['label'])
    assert fresh.stats()['corrupt_quarantined'] == 1
    assert os.path.exists(entry + '.corrupt')
    assert fresh.flush(timeout_s=10)
    fresh.get('k', lambda: pytest.fail('the rewritten entry must hit'))
    fresh.close()


def test_store_overflowing_queue_drops_and_does_not_block(tmp_path):
    store = DecodedChunkStore(str(tmp_path / 'store'), writer_queue_depth=1, throttle_delay_s=1.0)
    store.set_writer_throttled(True)
    t0 = time.perf_counter()
    for i in range(6):
        store.get('k{}'.format(i), lambda i=i: _cols(i))
    assert time.perf_counter() - t0 < 2.0
    assert store.stats()['write_skipped'] >= 4
    store.set_writer_throttled(False)
    assert store.flush(timeout_s=10)
    assert len(_entry_files(str(tmp_path / 'store'))) >= 1
    store.close()


def test_store_writer_throttle_roundtrip(tmp_path):
    store = DecodedChunkStore(str(tmp_path / 'store'), throttle_delay_s=5.0)
    store.set_writer_throttled(True)
    store.get('k', _cols)
    time.sleep(0.1)
    assert not _entry_files(str(tmp_path / 'store'))
    assert store.stats()['writer_throttled'] and store.writer_throttled
    store.set_writer_throttled(False)
    assert store.flush(timeout_s=2)
    assert len(_entry_files(str(tmp_path / 'store'))) == 1
    store.close()


def test_store_spill_pause_refuses_new_writes(tmp_path):
    store = DecodedChunkStore(str(tmp_path / 'store'))
    store.set_spill_paused(True)
    store.get('k', _cols)
    assert store.flush(timeout_s=10) and store.stats()['write_skipped'] == 1
    assert not _entry_files(str(tmp_path / 'store'))
    store.set_spill_paused(False)
    store.get('k', _cols)
    assert store.flush(timeout_s=10) and len(_entry_files(str(tmp_path / 'store'))) == 1
    store.close()


def test_store_stale_scratch_swept_on_open(tmp_path):
    store_dir = str(tmp_path / 'store')
    os.makedirs(store_dir)
    old = time.time() - 3600
    paths = [os.path.join(store_dir, name) for name in ('orphan.tmp', 'orphan.chunk.lock',
                                                        'live.tmp')]
    for path in paths:
        with open(path, 'wb') as f:
            f.write(b'x' * 64)
    for path in paths[:2]:
        os.utime(path, (old, old))
    store = DecodedChunkStore(store_dir)
    assert [os.path.exists(p) for p in paths] == [False, False, True]
    store.close()


def test_store_size_limit_evicts_oldest(tmp_path):
    store_dir = str(tmp_path / 'store')
    one_entry = len(pack_tensor_chunk(_cols()))
    store = DecodedChunkStore(store_dir, size_limit=int(one_entry * 2.5))
    for i in range(5):
        store.get('k{}'.format(i), lambda i=i: _cols(i))
        assert store.flush(timeout_s=10)
        time.sleep(0.01)
    total = sum(os.path.getsize(os.path.join(store_dir, f)) for f in _entry_files(store_dir))
    assert total <= one_entry * 2.5 and len(_entry_files(store_dir)) < 5
    assert store.has('k4') and not store.has('k0')
    store.close()


def test_store_pickle_roundtrip(tmp_path):
    store = DecodedChunkStore(str(tmp_path / 'store'))
    store.get('k', _cols)
    assert store.flush(timeout_s=10)
    clone = pickle.loads(pickle.dumps(store))
    clone.get('k', lambda: pytest.fail('the clone must share the entry files'))
    assert clone.stats()['hits'] == 1
    store.close()
    clone.close()


def test_store_readahead_hints_without_validation(tmp_path):
    store = DecodedChunkStore(str(tmp_path / 'store'))
    assert store.readahead('absent') is False
    store.get('k', _cols)
    assert store.flush(timeout_s=10)
    fresh = DecodedChunkStore(str(tmp_path / 'store'))
    assert fresh.readahead('k') is True
    assert fresh.stats()['readaheads'] == 1 and fresh.stats()['open_entries'] == 0
    fresh.get('k', lambda: pytest.fail('must hit'))
    assert fresh.stats()['open_entries'] == 1
    assert fresh.readahead('k') is True and fresh.stats()['readaheads'] == 2
    store.close()
    fresh.close()


def test_store_governor_hooks(tmp_path):
    store = DecodedChunkStore(str(tmp_path / 'store'))
    for i in range(4):
        store.get('k{}'.format(i), lambda i=i: _cols(i))
    assert store.flush(timeout_s=10)
    for i in range(4):
        store.get('k{}'.format(i), lambda: pytest.fail('must hit'))
    mapped = store.governed_nbytes()
    assert mapped == store.stats()['bytes_mapped'] > 0
    freed = store.close_lru_mmaps(keep_frac=0.5)
    assert freed == mapped // 2 and store.stats()['open_entries'] == 2
    store.get('k0', lambda: pytest.fail('a dropped entry re-maps'))
    store.close()


def _publish_once(store_dir, start, results):
    store = DecodedChunkStore(store_dir)
    start.wait(30)
    store.put('shared', _cols(3))
    results.put(store.stats()['writes'])
    store.close()


def test_two_processes_publishing_one_key_make_one_entry(tmp_path):
    store_dir = str(tmp_path / 'store')
    os.makedirs(store_dir)
    ctx = multiprocessing.get_context('spawn')
    start, results = ctx.Event(), ctx.Queue()
    procs = [ctx.Process(target=_publish_once, args=(store_dir, start, results))
             for _ in range(2)]
    for p in procs:
        p.start()
    start.set()
    writes = [results.get(timeout=120) for _ in procs]
    for p in procs:
        p.join(timeout=60)
        assert p.exitcode == 0
    assert sum(writes) == 1
    assert len(_entry_files(store_dir)) == 1
    assert not [f for f in os.listdir(store_dir) if f.endswith(('.tmp', '.lock'))]
    store = DecodedChunkStore(store_dir)
    got = store.get('shared', lambda: pytest.fail('must hit'))
    np.testing.assert_array_equal(got['img'], _cols(3)['img'])
    store.close()


# -- LocalDiskCache -------------------------------------------------------------

def test_local_disk_cache_layout_legacy_pickle_and_corrupt_refill(tmp_path):
    cache = LocalDiskCache(str(tmp_path / 'disk'))
    cols = _cols()
    cache.get('t', lambda: cols)
    with open(cache._key_path('t'), 'rb') as f:
        blob = f.read()
    assert is_tensor_chunk(blob) and blob == pack_tensor_chunk(cols)
    got = cache.get('t', lambda: pytest.fail('must hit'))
    np.testing.assert_array_equal(got['img'], cols['img'])
    rows = [{'a': 1}, {'a': 2}]
    cache.get('rows', lambda: rows)
    with open(cache._key_path('rows'), 'rb') as f:
        assert pickle.loads(f.read()) == rows
    with open(cache._key_path('legacy'), 'wb') as f:
        pickle.dump(cols, f)
    np.testing.assert_array_equal(cache.get('legacy', lambda: pytest.fail('hit'))['label'],
                                  cols['label'])
    with open(cache._key_path('t'), 'r+b') as f:
        f.seek(-8, os.SEEK_END)
        f.write(b'\xde\xad\xbe\xef')
    fills = []
    cache.get('t', lambda: (fills.append(1), cols)[1])
    assert fills == [1] and cache.hits == 2 and cache.misses == 3


# -- the readers ------------------------------------------------------------------

def _port_chunks(url, **kwargs):
    with make_tensor_reader(url, schema_fields=FIELDS, reader_pool_type='thread',
                            workers_count=1, shuffle_row_groups=False, **kwargs) as reader:
        chunks = list(reader)
        if reader.chunk_store is not None:
            assert reader.chunk_store.flush(timeout_s=30)
        return chunks, reader.stage_timings, reader.cache_stats(), reader


def _jax_chunks(url, **kwargs):
    from petastorm_tpu import make_tensor_reader as jax_make_tensor_reader
    with jax_make_tensor_reader(url, schema_fields=FIELDS, reader_pool_type='thread',
                                workers_count=1, shuffle_row_groups=False, **kwargs) as reader:
        chunks = list(reader)
        stats = reader.chunk_store.stats() if reader.chunk_store is not None else None
        if reader.chunk_store is not None:
            assert reader.chunk_store.flush(timeout_s=30)
        return chunks, reader.stage_timings, stats


def test_store_filled_by_jax_serves_the_port(store_url, tmp_path):
    store_dir = str(tmp_path / 'store')
    theirs, _, filled = _jax_chunks(store_url, cache_type='chunk-store', cache_location=store_dir)
    assert filled['misses'] == ROWS // PER_GROUP
    ours, timings, stats, _ = _port_chunks(store_url, cache_type='chunk-store',
                                           cache_location=store_dir)
    assert stats['hits'] == ROWS // PER_GROUP and stats['misses'] == 0
    assert timings['decode_s'] == 0.0 and timings['read_s'] == 0.0
    assert _chunk_digests(ours) == _chunk_digests(theirs)


def test_store_filled_by_the_port_serves_jax(store_url, tmp_path):
    store_dir = str(tmp_path / 'store')
    ours, _, filled, reader = _port_chunks(store_url, cache_type='chunk-store',
                                           cache_location=store_dir)
    assert filled['misses'] == ROWS // PER_GROUP and filled['writes'] == ROWS // PER_GROUP
    theirs, timings, stats = _jax_chunks(store_url, cache_type='chunk-store',
                                         cache_location=store_dir)
    assert stats['hits'] == ROWS // PER_GROUP and stats['misses'] == 0
    assert timings['decode_s'] == 0.0
    assert _chunk_digests(theirs) == _chunk_digests(ours)
    assert reader.stage_timings['decode_s'] > 0


def _epochs_digests(reader_chunks, epochs):
    per = len(reader_chunks) // epochs
    return [_chunk_digests(reader_chunks[i * per:(i + 1) * per]) for i in range(epochs)]


def test_local_disk_tensor_reader_epoch2_equals_epoch1_and_jax(store_url, tmp_path):
    theirs, _, _ = _jax_chunks(store_url)
    with make_tensor_reader(store_url, schema_fields=FIELDS, reader_pool_type='thread',
                            workers_count=1, shuffle_row_groups=False, cache_type='local-disk',
                            cache_location=str(tmp_path / 'disk')) as reader:
        first = list(reader)
        decode_after_first = reader.stage_timings['decode_s']
    with make_tensor_reader(store_url, schema_fields=FIELDS, reader_pool_type='thread',
                            workers_count=1, shuffle_row_groups=False, cache_type='local-disk',
                            cache_location=str(tmp_path / 'disk')) as reader:
        second = list(reader)
        assert reader.stage_timings['decode_s'] == 0.0
        assert reader.cache_stats()['hits'] == ROWS // PER_GROUP
        assert reader.last_chunk_lineage['tier'] == 'disk'
    assert decode_after_first > 0
    assert _chunk_digests(first) == _chunk_digests(second) == _chunk_digests(theirs)


def test_local_disk_row_reader_epoch2_equals_epoch1_and_jax(store_url, tmp_path):
    from petastorm_tpu import make_reader as jax_make_reader

    def rows(reader):
        return [{name: _digest_array(np.asarray(getattr(r, name))) for name in FIELDS}
                for r in reader]

    with jax_make_reader(store_url, schema_fields=FIELDS, reader_pool_type='thread',
                         workers_count=1, shuffle_row_groups=False) as reader:
        theirs = rows(reader)
    with make_reader(store_url, schema_fields=FIELDS, reader_pool_type='thread', workers_count=1,
                     shuffle_row_groups=False, num_epochs=2, cache_type='local-disk',
                     cache_location=str(tmp_path / 'disk')) as reader:
        both = rows(reader)
        timings = reader.stage_timings
        stats = reader.cache_stats()
    # One decode a row-group: epoch 2 came from the disk.
    assert stats['misses'] == ROWS // PER_GROUP and stats['hits'] == ROWS // PER_GROUP
    assert timings['chunks'] == 2 * ROWS // PER_GROUP and timings['decode_s'] > 0
    assert both[:ROWS] == both[ROWS:] == theirs


def test_env_var_arms_the_default_tensor_reader_only(store_url, tmp_path, monkeypatch):
    store_dir = str(tmp_path / 'env_store')
    monkeypatch.setenv(ENV_VAR, store_dir)
    with make_tensor_reader(store_url, workers_count=1) as reader:
        assert reader.chunk_store is not None and reader.cache_stats()['type'] == 'chunk-store'
        list(reader)
    assert len(_entry_files(store_dir)) == ROWS // PER_GROUP
    with make_tensor_reader(store_url, workers_count=1, cache_type='null') as reader:
        assert reader.chunk_store is None and reader.cache_stats()['type'] == 'null'
    with make_reader(store_url, workers_count=1) as reader:
        assert reader.chunk_store is None


def test_chunk_store_on_make_reader_raises(store_url, tmp_path):
    with pytest.raises(ValueError, match='make_tensor_reader'):
        make_reader(store_url, cache_type='chunk-store', cache_location=str(tmp_path))


def test_transcode_tool_report_and_exit_code(store_url, tmp_path):
    store_dir = str(tmp_path / 'transcoded')
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, '-m', 'petastorm_tpu_torch.tools.transcode',
                          '--dataset-url', store_url, '--store', store_dir],
                         capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report['complete'] and report['row_groups'] == ROWS // PER_GROUP
    assert report['writes'] == ROWS // PER_GROUP and report['preexisting'] == 0
    for key in ('dataset_url', 'store', 'passes', 'write_races', 'bytes_written', 'unstorable'):
        assert key in report
    _, timings, stats, _ = _port_chunks(store_url, cache_type='chunk-store',
                                        cache_location=store_dir)
    assert timings['decode_s'] == 0.0 and stats['misses'] == 0
    again = subprocess.run([sys.executable, '-m', 'petastorm_tpu_torch.tools.transcode',
                            '--dataset-url', store_url, '--store', store_dir],
                           capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    report = json.loads(again.stdout.strip().splitlines()[-1])
    assert again.returncode == 0 and report['writes'] == 0
    assert report['preexisting'] == ROWS // PER_GROUP
    # A cap below one entry can never complete: exit 1.
    capped = subprocess.run([sys.executable, '-m', 'petastorm_tpu_torch.tools.transcode',
                             '--dataset-url', store_url, '--store', str(tmp_path / 'capped'),
                             '--size-limit', '10', '--max-passes', '2'],
                            capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert capped.returncode == 1
    assert not json.loads(capped.stdout.strip().splitlines()[-1])['complete']


def test_writing_into_cpu_batches_leaves_later_epochs_unchanged(store_url, tmp_path):
    store_dir = str(tmp_path / 'store')
    _port_chunks(store_url, cache_type='chunk-store', cache_location=store_dir)
    with make_tensor_reader(store_url, schema_fields=FIELDS, reader_pool_type='thread',
                            workers_count=1, shuffle_row_groups=False, num_epochs=2,
                            cache_type='chunk-store', cache_location=store_dir) as reader:
        with TorchLoader(reader, BATCH, device='cpu', prefetch=2) as loader:
            epochs = [[], []]
            for i, batch in enumerate(loader):
                epoch = epochs[i * BATCH // ROWS]
                epoch.append({name: _digest_array(getattr(batch, name).numpy().copy())
                              for name in FIELDS})
                for tensor in batch:
                    tensor.fill_(0)    # the consumer writes into its batch
            assert loader.stats['chunk_store']['hits'] == 2 * ROWS // PER_GROUP
    assert epochs[0] == epochs[1]


def test_ventilator_observer_sees_dispatch_order_and_its_errors_are_swallowed():
    seen, fed = [], []

    def observer(item):
        seen.append(item['i'])
        if item['i'] == 1:
            raise RuntimeError('advice only')

    vent = ConcurrentVentilator(lambda **item: fed.append(item['i']),
                                [{'i': i} for i in range(5)], iterations=1)
    vent.on_ventilate = observer
    vent.start(threaded=False)
    while vent.pump():
        pass
    assert seen == fed == list(range(5))


def test_reader_readahead_rides_the_ventilator(store_url, tmp_path):
    store_dir = str(tmp_path / 'store')
    _port_chunks(store_url, cache_type='chunk-store', cache_location=store_dir)
    _, _, stats, _ = _port_chunks(store_url, cache_type='chunk-store', cache_location=store_dir)
    assert stats['readaheads'] == ROWS // PER_GROUP and stats['hits'] == ROWS // PER_GROUP


def test_store_batches_through_the_loader_equal_the_decoded_ones(store_url, tmp_path):
    store_dir = str(tmp_path / 'store')

    def batches(**kwargs):
        with make_tensor_reader(store_url, schema_fields=FIELDS, reader_pool_type='thread',
                                workers_count=1, shuffle_row_groups=False, **kwargs) as reader:
            with TorchLoader(reader, BATCH, device='cpu') as loader:
                return [{name: _digest_array(getattr(b, name).numpy().copy()) for name in FIELDS}
                        for b in loader]

    decoded = batches(cache_type='null')
    assert batches(cache_type='chunk-store', cache_location=store_dir) == decoded
    assert batches(cache_type='chunk-store', cache_location=store_dir) == decoded
