"""The port's per-row ``make_reader`` against ``petastorm_tpu.make_reader`` on
the same store: ndarray, scalar, string, JPEG and ragged PNG fields; epochs
in the same seeded order; the shard union; memory-cache hits in epoch 2;
the dummy pool; the stage timings; and the arguments that are not ported.

JPEG fields go through different decoders (the JAX package's native one,
OpenCV in the port) and are compared at max abs diff <= 2; every other
field is compared exactly.
"""

import numpy as np
import pytest

from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu.codecs import (CompressedImageCodec as JaxImageCodec,
                                  NdarrayCodec as JaxNdarrayCodec, ScalarCodec as JaxScalarCodec)
from petastorm_tpu.etl.writer import write_dataset as jax_write_dataset
from petastorm_tpu.unischema import Unischema as JaxUnischema, UnischemaField as JaxField
from petastorm_tpu_torch import (CompressedImageCodec, NdarrayCodec, ScalarCodec, Unischema,
                                 UnischemaField, make_reader, write_dataset)

ROWS, PER_GROUP = 30, 7      # a short last row-group


def _rows():
    rng = np.random.default_rng(3)
    for i in range(ROWS):
        h, w = int(rng.integers(5, 12)), int(rng.integers(5, 12))
        yield {'id': i, 'name': 'row-{}'.format(i),
               'vec': rng.normal(size=(3,)).astype(np.float32),
               'photo': rng.integers(0, 256, (16, 16, 3), dtype=np.uint8),
               'ragged': rng.integers(0, 256, (h, w, 3), dtype=np.uint8)}


def _fields(field, image, ndarray, scalar):
    return [field('id', np.int32, (), scalar(np.int32)),
            field('name', np.str_, (), scalar(np.str_)),
            field('vec', np.float32, (3,), ndarray()),
            field('photo', np.uint8, (16, 16, 3), image('jpeg', 90)),
            field('ragged', np.uint8, (None, None, 3), image('png'))]


@pytest.fixture(scope='module', params=['port', 'jax'])
def store(request, tmp_path_factory):
    url = 'file://' + str(tmp_path_factory.mktemp('rows') / request.param)
    if request.param == 'port':
        write_dataset(url, Unischema('RowSchema', _fields(UnischemaField, CompressedImageCodec,
                                                          NdarrayCodec, ScalarCodec)),
                      _rows(), rows_per_row_group=PER_GROUP)
    else:
        jax_write_dataset(url, JaxUnischema('RowSchema', _fields(JaxField, JaxImageCodec,
                                                                 JaxNdarrayCodec, JaxScalarCodec)),
                          _rows(), rows_per_row_group=PER_GROUP)
    return url


def _read(factory, url, **kwargs):
    kwargs.setdefault('workers_count', 1)
    kwargs.setdefault('shuffle_row_groups', False)
    kwargs.setdefault('reader_pool_type', 'thread')
    with factory(url, **kwargs) as reader:
        return [row._asdict() for row in reader]


def _assert_rows_match(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b)
        assert a['id'] == b['id'] and type(a['id']) is type(b['id'])
        assert a['name'] == b['name'] and isinstance(a['name'], str)
        np.testing.assert_array_equal(a['vec'], b['vec'])
        assert a['vec'].dtype == b['vec'].dtype == np.float32
        np.testing.assert_array_equal(a['ragged'], b['ragged'])
        assert a['photo'].shape == b['photo'].shape == (16, 16, 3)
        diff = np.abs(a['photo'].astype(np.int16) - b['photo'].astype(np.int16))
        assert int(diff.max()) <= 2


def test_rows_match_jax_make_reader(store):
    ours = _read(make_reader, store)
    _assert_rows_match(ours, _read(jax_make_reader, store))
    assert [r['id'] for r in ours] == list(range(ROWS))
    want = list(_rows())
    for row, written in zip(ours, want):
        np.testing.assert_array_equal(row['ragged'], written['ragged'])   # lossless PNG


def test_schema_fields_view_and_dummy_pool_match_jax(store):
    ours = _read(make_reader, store, schema_fields=['id', 'rag.*'], reader_pool_type='dummy')
    theirs = _read(jax_make_reader, store, schema_fields=['id', 'rag.*'], reader_pool_type='dummy')
    assert [sorted(r) for r in ours] == [['id', 'ragged']] * ROWS
    assert [r['id'] for r in ours] == [r['id'] for r in theirs]
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a['ragged'], b['ragged'])


def test_seeded_epochs_follow_jax_order(store):
    kwargs = dict(schema_fields=['id'], shuffle_row_groups=True, seed=4, num_epochs=3)
    ours = [r['id'] for r in _read(make_reader, store, **kwargs)]
    assert ours == [r['id'] for r in _read(jax_make_reader, store, **kwargs)]
    assert len(ours) == 3 * ROWS
    for epoch in range(3):
        assert sorted(ours[epoch * ROWS:(epoch + 1) * ROWS]) == list(range(ROWS))
    assert ours[:ROWS] != list(range(ROWS))


def test_shards_partition_like_jax(store):
    seen = []
    for shard in range(3):
        ids = sorted(r['id'] for r in _read(make_reader, store, schema_fields=['id'],
                                              cur_shard=shard, shard_count=3))
        assert ids == sorted(r['id'] for r in _read(jax_make_reader, store, schema_fields=['id'],
                                                      cur_shard=shard, shard_count=3))
        seen.extend(ids)
    assert sorted(seen) == list(range(ROWS))


def test_memory_cache_serves_epoch_two(store):
    groups = -(-ROWS // PER_GROUP)
    with make_reader(store, workers_count=2, num_epochs=2, shuffle_row_groups=False,
                     cache_type='memory') as reader:
        rows = [r._asdict() for r in reader]
        stats, timings = reader.cache_stats(), reader.stage_timings
    assert stats['hits'] == groups and stats['misses'] == groups and stats['nbytes'] > 0
    by_id = {}
    for row in rows:
        by_id.setdefault(row['id'], []).append(row)
    assert sorted(by_id) == list(range(ROWS)) and all(len(v) == 2 for v in by_id.values())
    for first, second in by_id.values():
        np.testing.assert_array_equal(first['photo'], second['photo'])
        np.testing.assert_array_equal(first['ragged'], second['ragged'])
        assert not second['photo'].flags.writeable      # cached rows are shared
    assert timings['chunks'] == 2 * groups
    assert timings['read_s'] > 0 and timings['decode_s'] > 0 and timings['cache_s'] >= 0


def test_stage_timings_of_the_tensor_reader(tmp_path):
    from petastorm_tpu_torch import make_tensor_reader
    url = 'file://' + str(tmp_path / 'blocks')
    schema = Unischema('Blocks', [UnischemaField('x', np.float32, (4,), NdarrayCodec())])
    write_dataset(url, schema, ({'x': np.full(4, i, np.float32)} for i in range(20)),
                  rows_per_row_group=5)
    with make_tensor_reader(url, workers_count=1) as reader:
        assert reader.stage_timings == {'read_s': 0.0, 'decode_s': 0.0, 'cache_s': 0.0,
                                        'chunks': 0}
        assert sum(len(chunk.x) for chunk in reader) == 20
        timings = reader.stage_timings
    assert timings['chunks'] == 4 and timings['read_s'] > 0 and timings['decode_s'] > 0


@pytest.mark.parametrize('kwargs,match', [
    (dict(predicate=object()), 'predicate'),
    (dict(transform_spec=object()), 'transform_spec'),
    (dict(shuffle_row_drop_partitions=2), 'shuffle_row_drop_partitions'),
    (dict(cache_type='chunk-store'), 'make_tensor_reader'),
    (dict(reader_pool_type='process'), 'thread'),
])
def test_arguments_not_ported_raise(store, kwargs, match):
    with pytest.raises(ValueError, match=match):
        make_reader(store, **kwargs)
