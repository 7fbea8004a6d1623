"""The port's TransformSpec against ``petastorm_tpu.transform``
(``tests/test_end_to_end.py:165-188``, ``tests/test_tensor_reader.py:180,
308`` and ``tests/test_lineage.py:230``): the output schema of every edit,
the per-row and the block transform through the readers equal to the JAX
readers' on the same store (with a removed field, an added one, and a
predicate and the in-chunk shuffle beside it), an in-place transform over a
cached reader that sees pristine values every epoch, the refusals, and a
transformed record that refuses replay with the JAX message. Exact.
"""

import numpy as np
import pytest

from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu import make_tensor_reader as jax_make_tensor_reader
from petastorm_tpu.etl.dataset_metadata import get_schema as jax_get_schema
from petastorm_tpu.predicates import in_lambda as jax_in_lambda
from petastorm_tpu.storage import ParquetStore as JaxParquetStore
from petastorm_tpu.transform import TransformSpec as JaxTransformSpec
from petastorm_tpu.transform import transform_schema as jax_transform_schema
from petastorm_tpu.unischema import UnischemaField as JaxField
from petastorm_tpu_torch import (TorchLoader, Unischema, UnischemaField, get_schema,
                                 make_reader, make_tensor_reader)
from petastorm_tpu_torch.lineage import ReplayError, read_ledger_dir, replay_record
from petastorm_tpu_torch.predicates import in_lambda
from petastorm_tpu_torch.storage import ParquetStore
from petastorm_tpu_torch.transform import TransformSpec, transform_schema


def _fields(schema):
    return [(f.name, np.dtype(f.numpy_dtype).str, tuple(f.shape), bool(f.nullable))
            for f in schema.fields.values()]


SPECS = {
    'removed': dict(removed_fields=['matrix']),
    'edit_tuple4': dict(edit_fields=[('score', np.float32, (), False)]),
    'edit_tuple5': dict(edit_fields=[('matrix', np.float64, (4, 5), None, False)]),
    'edit_field': dict(edit_fields=['FIELD']),
    'selected': dict(removed_fields=['id2'], selected_fields=['id', 'matrix']),
}


@pytest.mark.parametrize('name', sorted(SPECS))
def test_transform_schema_equals_jax(synthetic_dataset, name):
    ours = get_schema(ParquetStore(synthetic_dataset.url))
    theirs = jax_get_schema(JaxParquetStore(synthetic_dataset.url))

    def spec(cls, field):
        kwargs = dict(SPECS[name])
        if kwargs.get('edit_fields') == ['FIELD']:
            kwargs['edit_fields'] = [field('flag', np.bool_, (), None, False)]
        return cls(**kwargs)

    assert _fields(transform_schema(ours, spec(TransformSpec, UnischemaField))) == \
        _fields(jax_transform_schema(theirs, spec(JaxTransformSpec, JaxField)))


def test_transform_schema_refusals():
    with pytest.raises(TypeError, match='edit_fields'):
        TransformSpec(edit_fields=[('x', np.int32)])
    base = Unischema('S', [UnischemaField('a', np.int32, ())])
    with pytest.raises(ValueError, match='selected_fields'):
        transform_schema(base, TransformSpec(selected_fields=['b']))


# -- through the readers ---------------------------------------------------------------

def _double_id(row):
    row['id'] = row['id'] * 2
    return row


def _drop_matrix(row):
    del row['matrix']
    return row


def _blocks_double(cols):
    cols['matrix'] = cols['matrix'] * 2.0
    return cols


def _blocks_add_norm(cols):
    cols['norm'] = np.linalg.norm(cols['matrix'].reshape(len(cols['matrix']), -1),
                                  axis=1).astype(np.float32)
    return cols


def _samples(factory, url, **kwargs):
    with factory(url, **kwargs) as reader:
        return [s._asdict() for s in reader]


def _assert_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for name in b:
            np.testing.assert_array_equal(a[name], b[name])
            assert np.asarray(a[name]).dtype == np.asarray(b[name]).dtype


@pytest.mark.parametrize('pool', ['dummy', 'thread'])
@pytest.mark.parametrize('func,kwargs,fields', [
    (_double_id, {}, ['id']),
    (_drop_matrix, dict(removed_fields=['matrix']), ['id', 'matrix']),
], ids=['double_id', 'removes_field'])
def test_row_transform_equals_jax(synthetic_dataset, pool, func, kwargs, fields):
    common = dict(schema_fields=fields, reader_pool_type=pool, workers_count=2,
                  shuffle_row_groups=False)
    got = _samples(make_reader, synthetic_dataset.url,
                   transform_spec=TransformSpec(func, **kwargs), **common)
    want = _samples(jax_make_reader, synthetic_dataset.url,
                    transform_spec=JaxTransformSpec(func, **kwargs), **common)
    key = (lambda r: int(r['id']))
    _assert_equal(sorted(got, key=key), sorted(want, key=key))
    if func is _double_id:
        assert sorted(r['id'] for r in got) == sorted(r['id'] * 2 for r in synthetic_dataset.data)
    else:
        assert set(got[0]) == {'id'}


@pytest.mark.parametrize('func,edit', [(_blocks_double, None),
                                       (_blocks_add_norm, ('norm', np.float32, (), False))],
                         ids=['double', 'adds_field'])
def test_block_transform_equals_jax(synthetic_dataset, func, edit):
    common = dict(schema_fields=['id', 'matrix'], reader_pool_type='dummy',
                  shuffle_row_groups=False)
    edits = [edit] if edit else None
    got = _samples(make_tensor_reader, synthetic_dataset.url,
                   transform_spec=TransformSpec(func, edit_fields=edits), **common)
    want = _samples(jax_make_tensor_reader, synthetic_dataset.url,
                    transform_spec=JaxTransformSpec(func, edit_fields=edits), **common)
    _assert_equal(got, want)
    by_id = {row['id']: row for row in synthetic_dataset.data}
    if func is _blocks_double:
        for chunk in got:
            for i, m in zip(chunk['id'], chunk['matrix']):
                np.testing.assert_array_equal(m, by_id[int(i)]['matrix'] * 2.0)
    else:
        assert all('norm' in chunk for chunk in got)


def test_transform_with_predicate_and_in_chunk_shuffle_equals_jax(synthetic_dataset):
    """The worker's order of steps (predicate read, transform, permutation)
    gives the JAX stream chunk for chunk."""
    common = dict(schema_fields=['id', 'id2', 'matrix'], reader_pool_type='thread',
                  workers_count=3, deterministic=True, seed=4, num_epochs=2,
                  shuffle_rows_in_chunk=True)
    got = _samples(make_tensor_reader, synthetic_dataset.url,
                   predicate=in_lambda(['id2'], lambda v: v != 1),
                   transform_spec=TransformSpec(_blocks_double), **common)
    want = _samples(jax_make_tensor_reader, synthetic_dataset.url,
                    predicate=jax_in_lambda(['id2'], lambda v: v != 1),
                    transform_spec=JaxTransformSpec(_blocks_double), **common)
    _assert_equal(got, want)
    assert all((chunk['id2'] != 1).all() for chunk in got)


@pytest.mark.parametrize('cache', ['memory', 'local-disk'])
@pytest.mark.parametrize('kind', ['tensor', 'row'])
def test_cached_transform_does_not_corrupt_cache(synthetic_dataset, tmp_path, cache, kind):
    """An in-place transform over a cached reader sees pristine values in
    every epoch (cached blocks are shared with later epochs)."""
    def inplace_double(sample):
        sample['matrix'] *= 2.0
        return sample

    factory = make_tensor_reader if kind == 'tensor' else make_reader
    per_id = {}
    with factory(synthetic_dataset.url, schema_fields=['id', 'matrix'], reader_pool_type='dummy',
                 num_epochs=3, cache_type=cache, cache_location=str(tmp_path),
                 shuffle_row_groups=False,
                 transform_spec=TransformSpec(inplace_double)) as reader:
        for sample in reader:
            for i, m in zip(np.atleast_1d(sample.id), np.reshape(sample.matrix, (-1, 4, 5))):
                per_id.setdefault(int(i), []).append(m.copy())
    by_id = {row['id']: row for row in synthetic_dataset.data}
    assert sorted(per_id) == sorted(by_id)
    for i, values in per_id.items():
        assert len(values) == 3
        for value in values:
            np.testing.assert_array_equal(value, by_id[i]['matrix'] * 2.0)


def test_raw_image_fields_with_transform_raises(synthetic_dataset):
    with pytest.raises(ValueError, match='raw_image_fields is incompatible'):
        make_tensor_reader(synthetic_dataset.url, schema_fields=['id', 'image_png'],
                           raw_image_fields=True, transform_spec=TransformSpec(_blocks_double))


def test_transform_refuses_replay(synthetic_dataset, tmp_path):
    reader = make_tensor_reader(synthetic_dataset.url, schema_fields=['id', 'matrix'],
                                reader_pool_type='thread', workers_count=1,
                                shuffle_row_groups=False,
                                transform_spec=TransformSpec(_blocks_double, version='v2'))
    with reader:
        with TorchLoader(reader, 16, device='cpu', lineage=str(tmp_path / 'ledger')) as loader:
            batches = sum(1 for _ in loader)
    (_, ctx, records), = read_ledger_dir(str(tmp_path / 'ledger'))
    assert len(records) == batches
    assert ctx['transform'] == {'version': 'v2', 'func': '_blocks_double'}
    with pytest.raises(ReplayError, match='TransformSpec'):
        replay_record(records[0], ctx)
