"""Row-group indexes and selectors of the port against the JAX package's
(``tests/test_indexing_and_selectors.py``): the same ten cases, each run on
a store indexed by the port's ``build_rowgroup_index`` and on one indexed
by the JAX package's, so an index built by either package is selected by
the other's. The payloads are JSON-equal across builders; the readers'
rows equal the JAX readers' with the same selector. All comparisons are
exact.
"""

import json
import shutil

import numpy as np
import pytest

from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu import make_tensor_reader as jax_make_tensor_reader
from petastorm_tpu import selectors as jax_selectors
from petastorm_tpu.etl import rowgroup_indexers as jax_indexers
from petastorm_tpu.etl.rowgroup_indexing import build_rowgroup_index as jax_build_index
from petastorm_tpu.etl.rowgroup_indexing import get_row_group_indexes as jax_get_indexes
from petastorm_tpu.etl.writer import write_dataset as jax_write_dataset
from petastorm_tpu_torch import make_reader, make_tensor_reader, selectors
from petastorm_tpu_torch.etl import rowgroup_indexers as indexers
from petastorm_tpu_torch.etl.rowgroup_indexing import build_rowgroup_index, get_row_group_indexes
from petastorm_tpu_torch.predicates import in_lambda
from tests.conftest import TestSchema, _row


def _indexers(m):
    return [m.SingleFieldIndexer('sensor_ix', 'sensor_name'),
            m.SingleFieldIndexer('id2_ix', 'id2'),
            m.FieldNotNullIndexer('nullable_ix', 'nullable_field'),
            m.SingleFieldRowIndexer('id_row_ix', 'id')]


@pytest.fixture(scope='module')
def unindexed(tmp_path_factory):
    path = tmp_path_factory.mktemp('indexed') / 'plain'
    rng = np.random.default_rng(11)
    rows = [_row(i, rng) for i in range(50)]
    jax_write_dataset('file://' + str(path), TestSchema, rows, rows_per_row_group=10)
    return path, rows


@pytest.fixture(scope='module', params=['port', 'jax'])
def indexed(request, unindexed):
    """A copy of the store, indexed by one package."""
    path, rows = unindexed
    target = path.parent / request.param
    shutil.copytree(str(path), str(target))
    url = 'file://' + str(target)
    if request.param == 'port':
        build_rowgroup_index(url, _indexers(indexers))
    else:
        jax_build_index(url, _indexers(jax_indexers))

    class _Dataset:
        pass

    ds = _Dataset()
    ds.url, ds.data, ds.builder = url, rows, request.param
    return ds


def _ids(factory, url, **kwargs):
    with factory(url, reader_pool_type='dummy', **kwargs) as reader:
        return sorted(i for s in reader for i in np.atleast_1d(s.id).tolist())


def test_index_payload_round_trip(indexed, tmp_path):
    payload = get_row_group_indexes(indexed.url)
    assert set(payload) == {'sensor_ix', 'id2_ix', 'nullable_ix', 'id_row_ix'}
    assert payload['sensor_ix']['field'] == 'sensor_name'
    assert payload['sensor_ix']['values']['sensor_0'] == [0, 1, 2, 3, 4]
    # Both packages read the same JSON back, and build the same payload.
    assert json.dumps(jax_get_indexes(indexed.url), sort_keys=True) == \
        json.dumps(payload, sort_keys=True)
    other = tmp_path / 'other'
    shutil.copytree(indexed.url[len('file://'):], str(other))
    if indexed.builder == 'port':
        jax_build_index('file://' + str(other), _indexers(jax_indexers))
    else:
        build_rowgroup_index('file://' + str(other), _indexers(indexers))
    assert json.dumps(get_row_group_indexes('file://' + str(other)), sort_keys=True) == \
        json.dumps(payload, sort_keys=True)


def test_single_index_selector(indexed):
    got = _ids(make_reader, indexed.url, shuffle_row_groups=False,
               rowgroup_selector=selectors.SingleIndexSelector('sensor_ix', ['sensor_1']))
    want = _ids(jax_make_reader, indexed.url, shuffle_row_groups=False,
                rowgroup_selector=jax_selectors.SingleIndexSelector('sensor_ix', ['sensor_1']))
    assert got == want
    assert {r['id'] for r in indexed.data if r['sensor_name'] == 'sensor_1'} <= set(got)


def test_selector_with_predicate_combined(indexed):
    kwargs = dict(predicate=in_lambda(['sensor_name'], lambda s: s == 'sensor_2'))
    got = _ids(make_reader, indexed.url,
               rowgroup_selector=selectors.SingleIndexSelector('sensor_ix', ['sensor_2']),
               **kwargs)
    assert got == sorted(r['id'] for r in indexed.data if r['sensor_name'] == 'sensor_2')
    tensor = _ids(make_tensor_reader, indexed.url, schema_fields=['id', 'sensor_name'],
                  rowgroup_selector=selectors.SingleIndexSelector('sensor_ix', ['sensor_2']),
                  **kwargs)
    assert tensor == got


def test_intersect_and_union_selectors(indexed):
    payload = get_row_group_indexes(indexed.url)
    a, b = selectors.SingleIndexSelector('id2_ix', [0]), selectors.SingleIndexSelector('id2_ix',
                                                                                        [1])
    inter = selectors.IntersectIndexSelector([a, b]).select_row_groups(payload)
    union = selectors.UnionIndexSelector([a, b]).select_row_groups(payload)
    assert inter <= union
    assert union == (a.select_row_groups(payload) | b.select_row_groups(payload))
    ja, jb = (jax_selectors.SingleIndexSelector('id2_ix', [v]) for v in (0, 1))
    assert inter == jax_selectors.IntersectIndexSelector([ja, jb]).select_row_groups(payload)
    assert union == jax_selectors.UnionIndexSelector([ja, jb]).select_row_groups(payload)


def test_not_null_indexer(indexed):
    payload = get_row_group_indexes(indexed.url)
    assert payload['nullable_ix']['values']['not_null'] == [0, 1, 2, 3, 4]


def test_intersect_and_union_over_row_level_index(indexed):
    payload = get_row_group_indexes(indexed.url)
    assert payload['id_row_ix']['type'] == 'single_field_rows'
    a = selectors.SingleIndexSelector('id_row_ix', [5])
    b = selectors.SingleIndexSelector('id_row_ix', [5, 17])
    assert selectors.IntersectIndexSelector([a, b]).select_row_groups(payload) == {0}
    assert selectors.UnionIndexSelector([a, b]).select_row_groups(payload) == {0, 1}
    sensors = selectors.SingleIndexSelector('sensor_ix', ['sensor_1'])
    mixed = selectors.IntersectIndexSelector([b, sensors]).select_row_groups(payload)
    assert mixed == ({0, 1} & sensors.select_row_groups(payload))


@pytest.mark.parametrize('port,jax', [(make_reader, jax_make_reader),
                                      (make_tensor_reader, jax_make_tensor_reader)],
                         ids=['row', 'tensor'])
def test_row_level_selector_through_reader(indexed, port, jax):
    kwargs = dict(schema_fields=['id', 'matrix'], shuffle_row_groups=False)
    got = _ids(port, indexed.url,
               rowgroup_selector=selectors.SingleIndexSelector('id_row_ix', [5, 17]), **kwargs)
    assert got == list(range(20))
    assert got == _ids(jax, indexed.url, rowgroup_selector=jax_selectors.SingleIndexSelector(
        'id_row_ix', [5, 17]), **kwargs)


def test_in_lambda_state_arg_with_selector(indexed):
    predicate = in_lambda(['id'], lambda id, threshold: id >= threshold, state_arg=15)
    ids = _ids(make_reader, indexed.url, predicate=predicate,
               rowgroup_selector=selectors.SingleIndexSelector('id_row_ix', [5, 17]))
    assert ids == [15, 16, 17, 18, 19]


def test_unknown_index_raises(indexed):
    with pytest.raises(ValueError, match='nope_ix'):
        make_reader(indexed.url, reader_pool_type='dummy',
                    rowgroup_selector=selectors.SingleIndexSelector('nope_ix', ['x']))


def test_selector_without_index_raises(unindexed):
    with pytest.raises(ValueError, match='no row-group index'):
        make_reader('file://' + str(unindexed[0]), reader_pool_type='dummy',
                    rowgroup_selector=selectors.SingleIndexSelector('sensor_ix', ['sensor_1']))


def test_indexer_objects_equal_jax(unindexed):
    """Fed the same decoded rows, each indexer's payload and lookups are the
    JAX indexer's."""
    _, rows = unindexed
    ours, theirs = _indexers(indexers), _indexers(jax_indexers)
    for piece in range(5):
        chunk = rows[piece * 10:(piece + 1) * 10]
        for a, b in zip(ours, theirs):
            a.build_index(chunk, piece)
            b.build_index(chunk, piece)
    for a, b in zip(ours, theirs):
        assert a.to_json_payload() == b.to_json_payload()
        assert a.indexed_values == b.indexed_values
        for value in a.indexed_values[:5]:
            assert a.get_row_group_indexes(value) == b.get_row_group_indexes(value)
    merged = indexers.SingleFieldIndexer('sensor_ix', 'sensor_name') + ours[0]
    assert merged.to_json_payload() == ours[0].to_json_payload()
    with pytest.raises(ValueError, match='different indexes'):
        ours[0] + ours[1]
