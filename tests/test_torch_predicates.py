"""The port's predicates against ``petastorm_tpu.predicates`` (``tests/
test_end_to_end.py:86-108`` and ``tests/test_tensor_reader.py:57-75``): each
combinator gives the same answer on the same values, the split buckets the
same numpy scalars alike, and the readers keep the same rows, with the same
values, as the JAX readers on the same stores (a JAX-written store, and a
hive-partitioned one whose partition predicate prunes row-groups before any
worker runs). All comparisons are exact.
"""

import numpy as np
import pytest

from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu import make_tensor_reader as jax_make_tensor_reader
from petastorm_tpu import predicates as jax_predicates
from petastorm_tpu_torch import make_reader, make_tensor_reader
from petastorm_tpu_torch import predicates

STATIC_FIELDS = ['id', 'id2', 'image_png', 'matrix', 'matrix_compressed', 'sensor_name']

PREDICATES = {
    'in_set': lambda m: m.in_set({1, 3, 5, 30}, 'id'),
    'in_intersection': lambda m: m.in_intersection({2, 3}, 'tags'),
    'in_negate': lambda m: m.in_negate(m.in_set({'sensor_1'}, 'sensor_name')),
    'in_reduce_all': lambda m: m.in_reduce([m.in_set({0, 1, 2}, 'id2'),
                                            m.in_lambda(['id'], lambda id: id > 10)], all),
    'in_reduce_any': lambda m: m.in_reduce([m.in_set({0}, 'id2'),
                                            m.in_set({'sensor_2'}, 'sensor_name')], any),
    'in_lambda_state': lambda m: m.in_lambda(['id', 'id2'], lambda a, b, s: a + b > s,
                                             state_arg=20),
    'split_0': lambda m: m.in_pseudorandom_split([0.3, 0.7], 0, 'id'),
    'split_1': lambda m: m.in_pseudorandom_split([0.3, 0.7], 1, 'sensor_name'),
}


def _values(i, rng):
    return {'id': np.int64(i), 'id2': np.int32(i % 5), 'sensor_name': 'sensor_{}'.format(i % 17),
            'tags': list(rng.integers(0, 6, size=int(rng.integers(0, 4))))}


@pytest.mark.parametrize('name', sorted(PREDICATES))
def test_predicate_answers_equal_jax(name):
    ours, theirs = PREDICATES[name](predicates), PREDICATES[name](jax_predicates)
    assert ours.get_fields() == theirs.get_fields()
    rng = np.random.default_rng(5)
    rows = [_values(i, rng) for i in range(300)]
    got = [ours.do_include({f: row[f] for f in ours.get_fields()}) for row in rows]
    assert got == [theirs.do_include({f: row[f] for f in theirs.get_fields()}) for row in rows]
    assert any(got) and not all(got)


@pytest.mark.parametrize('value', [np.float32(0.1), np.float64(0.1), 0.1, np.int32(7),
                                   np.int64(7), 7, np.str_('a'), 'a', np.uint8(200)])
def test_split_buckets_a_value_as_jax_does(value):
    """The bucket is md5 of ``str(value)``: equal across packages for the same
    Python/numpy type (np.float32(0.1) and 0.1 print differently, which is
    why the workers hand predicates numpy scalars in both packages)."""
    assert predicates._stable_hash_fraction(value, 10000) == \
        jax_predicates._stable_hash_fraction(value, 10000)


def test_split_fractions_over_one_raise():
    with pytest.raises(ValueError, match='sum'):
        predicates.in_pseudorandom_split([0.8, 0.8], 0, 'id')


# -- through the readers ---------------------------------------------------------------

def _rows_by_id(factory, url, **kwargs):
    out = {}
    with factory(url, **kwargs) as reader:
        for sample in reader:
            if reader.batched_output:
                for i in range(len(sample.id)):
                    out[int(sample.id[i])] = {n: getattr(sample, n)[i] for n in sample._fields}
            else:
                out[int(sample.id)] = sample._asdict()
    return out


def _assert_rows_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert sorted(got[key]) == sorted(want[key])
        for name, value in want[key].items():
            ours = got[key][name]
            if value is None:
                assert ours is None, (key, name)
                continue
            assert type(ours) is type(value) or isinstance(value, np.ndarray), (key, name)
            np.testing.assert_array_equal(ours, value)
            assert np.asarray(ours).dtype == np.asarray(value).dtype, (key, name)


READERS = [
    pytest.param(make_reader, jax_make_reader, 'dummy', None, id='row-dummy'),
    pytest.param(make_reader, jax_make_reader, 'thread', None, id='row-thread'),
    pytest.param(make_tensor_reader, jax_make_tensor_reader, 'dummy', STATIC_FIELDS,
                 id='tensor-dummy'),
    pytest.param(make_tensor_reader, jax_make_tensor_reader, 'thread', STATIC_FIELDS,
                 id='tensor-thread'),
]


@pytest.mark.parametrize('port,jax,pool,fields', READERS)
@pytest.mark.parametrize('name', ['in_set', 'in_negate', 'in_reduce_all', 'in_lambda_state',
                                  'split_0', 'split_1'])
def test_reader_keeps_the_rows_jax_keeps(synthetic_dataset, port, jax, pool, fields, name):
    kwargs = dict(schema_fields=fields, reader_pool_type=pool, workers_count=3,
                  shuffle_row_groups=False)
    got = _rows_by_id(port, synthetic_dataset.url, predicate=PREDICATES[name](predicates),
                      **kwargs)
    want = _rows_by_id(jax, synthetic_dataset.url, predicate=PREDICATES[name](jax_predicates),
                       **kwargs)
    assert got
    _assert_rows_equal(got, want)


@pytest.mark.parametrize('subset', [0, 1])
def test_pseudorandom_split_halves_partition_the_store(synthetic_dataset, subset):
    kwargs = dict(schema_fields=['id', 'sensor_name'], reader_pool_type='dummy')
    ours = _rows_by_id(make_tensor_reader, synthetic_dataset.url,
                       predicate=predicates.in_pseudorandom_split([0.5, 0.5], subset, 'id'),
                       **kwargs)
    other = _rows_by_id(make_tensor_reader, synthetic_dataset.url,
                        predicate=predicates.in_pseudorandom_split([0.5, 0.5], 1 - subset, 'id'),
                        **kwargs)
    assert not set(ours) & set(other)
    assert sorted(set(ours) | set(other)) == sorted(r['id'] for r in synthetic_dataset.data)


def test_tensor_predicate_rejected(synthetic_dataset):
    with pytest.raises(ValueError, match='scalar'):
        make_tensor_reader(synthetic_dataset.url, schema_fields=STATIC_FIELDS,
                           predicate=predicates.in_lambda(['matrix'], lambda m: True))


def test_unknown_predicate_field_raises(synthetic_dataset):
    reader = make_reader(synthetic_dataset.url, reader_pool_type='dummy',
                         predicate=predicates.in_set({1}, 'no_such_field'))
    with reader, pytest.raises(ValueError, match='unknown fields'):
        next(reader)


# -- hive partitions -------------------------------------------------------------------

@pytest.mark.parametrize('port,jax,pool,fields', READERS)
def test_partition_predicate_prunes_like_jax(partitioned_synthetic_dataset, port, jax, pool,
                                             fields):
    url = partitioned_synthetic_dataset.url
    kwargs = dict(schema_fields=fields and fields + ['partition_key'], reader_pool_type=pool,
                  workers_count=2, shuffle_row_groups=False)
    with port(url, predicate=predicates.in_set({'p_1'}, 'partition_key'), **kwargs) as reader:
        # Pruned before ventilation: only p_1's row-groups, no worker predicate.
        assert {p.partition_values['partition_key'] for p in reader._row_groups} == {'p_1'}
    got = _rows_by_id(port, url, predicate=predicates.in_set({'p_1'}, 'partition_key'), **kwargs)
    want = _rows_by_id(jax, url, predicate=jax_predicates.in_set({'p_1'}, 'partition_key'),
                       **kwargs)
    _assert_rows_equal(got, want)
    expected = {r['id'] for r in partitioned_synthetic_dataset.data if r['partition_key'] == 'p_1'}
    assert set(got) == expected
    assert all(row['partition_key'] == 'p_1' for row in got.values())


@pytest.mark.parametrize('port,jax,pool,fields', READERS)
def test_partitioned_store_and_mixed_predicate_equal_jax(partitioned_synthetic_dataset, port,
                                                         jax, pool, fields):
    """A predicate over a partition field and a stored one runs in the
    workers, which append the partition column; the whole store reads as in
    the JAX package."""
    url = partitioned_synthetic_dataset.url
    kwargs = dict(schema_fields=fields, reader_pool_type=pool, workers_count=2,
                  shuffle_row_groups=False)
    _assert_rows_equal(_rows_by_id(port, url, **kwargs), _rows_by_id(jax, url, **kwargs))

    def make(m):
        return m.in_lambda(['partition_key', 'id'], lambda p, i: p != 'p_0' and i % 3 == 0)

    got = _rows_by_id(port, url, predicate=make(predicates), **kwargs)
    _assert_rows_equal(got, _rows_by_id(jax, url, predicate=make(jax_predicates), **kwargs))
    assert set(got) == {r['id'] for r in partitioned_synthetic_dataset.data
                        if r['partition_key'] != 'p_0' and r['id'] % 3 == 0}


@pytest.fixture(scope='module')
def numeric_partition_url(tmp_path_factory):
    """A string field hive-partitioned on numeric-looking values (``year=2020``),
    which both packages parse as ints."""
    from petastorm_tpu.codecs import ScalarCodec
    from petastorm_tpu.etl.writer import write_dataset
    from petastorm_tpu.unischema import Unischema, UnischemaField
    schema = Unischema('YearSchema', [
        UnischemaField('id', np.int64, (), ScalarCodec(np.int64), False),
        UnischemaField('year', np.str_, (), ScalarCodec(np.str_), False)])
    url = 'file://' + str(tmp_path_factory.mktemp('numeric_partition') / 'dataset')
    write_dataset(url, schema, [{'id': i, 'year': str(2020 + i % 2)} for i in range(40)],
                  rows_per_row_group=5, partition_fields=('year',))
    return url


@pytest.mark.parametrize('port,jax,pool,fields', READERS)
def test_numeric_partition_value_under_mixed_predicate_equals_jax(numeric_partition_url, port,
                                                                  jax, pool, fields):
    """The predicate sees a numeric partition value with the type the JAX
    reader of the same kind hands it (the row readers decode it by the
    field's dtype, the tensor readers pass the parsed value), so a
    type-sensitive predicate keeps the same rows."""
    kwargs = dict(reader_pool_type=pool, workers_count=2, shuffle_row_groups=False)

    def make(m, seen):
        def keep(year, i):
            seen.add((type(year), year))
            return year in (2020, '2021') and i % 3 != 0
        return m.in_lambda(['year', 'id'], keep)

    ours, theirs = set(), set()
    got = _rows_by_id(port, numeric_partition_url, predicate=make(predicates, ours), **kwargs)
    want = _rows_by_id(jax, numeric_partition_url, predicate=make(jax_predicates, theirs),
                       **kwargs)
    assert got
    _assert_rows_equal(got, want)
    assert ours == theirs and len(ours) == 2
