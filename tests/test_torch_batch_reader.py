"""``make_batch_reader`` over plain Parquet: the port against the JAX package
(``petastorm_tpu/reader.py:382-446``, ``arrow_worker.py``, ``unischema.py:
201-253``, ``cache.py:277-292``) on the same seeded stores.

Schema inference over scalar, string, binary, decimal, timestamp, date,
dictionary, list (fixed, ragged, null) and hive-partitioned columns; the
Arrow-to-numpy conversion of every list case; the reader's chunks with the
thread and dummy pools, ``schema_fields``, a predicate (pandas' row values:
a split over a mixed int/float pair), a pandas ``TransformSpec``, drop
partitions and the in-chunk shuffle; the local-disk Arrow cache (either
package's directory serves the other); ``TorchLoader(device='cpu')``
against ``JaxLoader``; resume in each direction; the run with pandas
blocked; ``make_pod_reader`` with the batch factory. Numeric arrays are
compared by ``lineage._digest_array``, object arrays value by value. The
bar is exact equality, except that a JAX string column under pandas >= 3 is
pandas' string array (nan for a null) where the port's is an object ndarray
(None): those compare value by value with nan read as None.
"""

import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from petastorm_tpu import arrow_worker as jax_arrow_worker
from petastorm_tpu import make_batch_reader as jax_make_batch_reader
from petastorm_tpu import make_pod_reader as jax_make_pod_reader
from petastorm_tpu import predicates as jax_predicates
from petastorm_tpu.jax_loader import JaxLoader
from petastorm_tpu.lineage import _digest_array
from petastorm_tpu.transform import TransformSpec as JaxTransformSpec
from petastorm_tpu.unischema import Unischema as JaxUnischema
from petastorm_tpu_torch import TorchLoader, make_batch_reader, make_pod_reader, predicates
from petastorm_tpu_torch.arrow_worker import arrow_column_to_numpy
from petastorm_tpu_torch.errors import SchemaError
from petastorm_tpu_torch.transform import TransformSpec
from petastorm_tpu_torch.unischema import Unischema

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS_PER_PART, PER_GROUP = 30, 10


def _part_table(part, rng):
    import datetime
    import decimal
    n = ROWS_PER_PART
    ids = np.arange(part * n, (part + 1) * n)
    return pa.table({
        'id': pa.array(ids, pa.int64()),
        'f': pa.array(rng.random(n)),
        'i32': pa.array(rng.integers(-50, 50, n, dtype=np.int32)),
        'flag': pa.array(rng.random(n) > 0.5),
        's': pa.array(['s{}'.format(i % 7) if i % 9 else None for i in ids]),
        'b': pa.array([bytes([i % 256]) * 3 for i in ids]),
        'dec': pa.array([decimal.Decimal(int(i)) / 4 for i in ids], pa.decimal128(9, 2)),
        'ts': pa.array([datetime.datetime(2020, 1, 1) + datetime.timedelta(hours=int(i))
                        for i in ids], pa.timestamp('us')),
        'day': pa.array([datetime.date(2021, 1, 1) + datetime.timedelta(days=int(i))
                         for i in ids], pa.date32()),
        'cat': pa.array(['c{}'.format(i % 3) for i in ids]).dictionary_encode(),
        'fixed': pa.array([[int(i), int(i) + 1, int(i) * 2] for i in ids], pa.list_(pa.int32())),
        'vec': pa.array([rng.random(4).tolist() for _ in ids], pa.list_(pa.float32())),
        'ragged': pa.array([list(range(int(i) % 4)) for i in ids], pa.list_(pa.int64())),
        'nulled': pa.array([None if i % 11 == 0 else [int(i)] * 2 for i in ids],
                           pa.list_(pa.int64())),
        'fsl': pa.array([[1, 2]] * n, pa.list_(pa.int32(), 2)),
    })


@pytest.fixture(scope='module')
def plain_store(tmp_path_factory):
    """A hive-partitioned plain store (``part=0``, ``part=1``), no
    ``_common_metadata``, 10-row groups."""
    root = tmp_path_factory.mktemp('plain') / 'store'
    rng = np.random.default_rng(5)
    for part in range(2):
        directory = root / 'part={}'.format(part)
        os.makedirs(directory)
        pq.write_table(_part_table(part, rng), str(directory / 'data.parquet'),
                       row_group_size=PER_GROUP)
    return 'file://' + str(root)


def _same(got, want):
    """Exact equality of two converted columns (see the module docstring)."""
    want_values = want
    if not isinstance(want, np.ndarray):         # pandas' string array
        want_values = np.array([None if v is None or v != v else v for v in want], dtype=object)
    assert isinstance(got, np.ndarray)
    assert len(got) == len(want_values)
    if got.dtype == object or want_values.dtype == object:
        assert got.dtype == want_values.dtype == object
        for a, b in zip(got, want_values):
            if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
                assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                assert a.dtype == b.dtype and np.array_equal(a, b)
            else:
                assert a == b or (a is None and b is None)
        return
    assert got.dtype == want_values.dtype and got.shape == want_values.shape
    assert _digest_array(got) == _digest_array(want_values)


def _chunks(reader):
    with reader:
        return [chunk._asdict() for chunk in reader]


def _assert_streams_equal(port, jax):
    assert len(port) == len(jax)
    for got, want in zip(port, jax):
        assert list(got) == list(want)
        for name in got:
            _same(got[name], want[name])


# --------------------------------------------------------------------------
# inference and conversion
# --------------------------------------------------------------------------

def test_inferred_schema_equals_jax(plain_store):
    from petastorm_tpu.etl.dataset_metadata import infer_or_load_unischema as jax_infer
    from petastorm_tpu.storage import ParquetStore as JaxStore
    from petastorm_tpu_torch.etl.dataset_metadata import infer_or_load_unischema
    from petastorm_tpu_torch.storage import ParquetStore

    port, jax = infer_or_load_unischema(ParquetStore(plain_store)), jax_infer(JaxStore(plain_store))
    assert [(f.name, f.numpy_dtype, f.shape, f.nullable) for f in port.fields.values()] == \
        [(f.name, f.numpy_dtype, f.shape, f.nullable) for f in jax.fields.values()]
    assert 'fsl' not in port.fields and port.fields['part'].numpy_dtype == np.dtype('O')
    assert port.fields['ragged'].shape == (None,) and port.fields['cat'].numpy_dtype == object
    assert port.fields['ts'].numpy_dtype == np.dtype('datetime64[ns]')


@pytest.mark.parametrize('arrow_type', [
    pa.list_(pa.int32(), 2), pa.struct([('a', pa.int8())]), pa.list_(pa.list_(pa.int8())),
    pa.time32('s'), pa.month_day_nano_interval(), pa.list_view(pa.int8()),
    pa.dense_union([pa.field('a', pa.int8())]), pa.run_end_encoded(pa.int32(), pa.int8())])
def test_unsupported_types_raise_unless_omitted(arrow_type):
    schema = pa.schema([('x', arrow_type), ('y', pa.int8())])
    with pytest.raises(SchemaError):
        Unischema.from_arrow_schema(schema)
    with pytest.raises(Exception):
        JaxUnischema.from_arrow_schema(schema)
    assert list(Unischema.from_arrow_schema(schema, omit_unsupported_fields=True).fields) == \
        list(JaxUnischema.from_arrow_schema(schema, omit_unsupported_fields=True).fields) == ['y']


LIST_CASES = {
    'uniform_int32': pa.array([[1, 2, 3], [4, 5, 6]], pa.list_(pa.int32())),
    'uniform_float32': pa.array([[0.1, 0.2], [0.3, 0.4]], pa.list_(pa.float32())),
    'uniform_float64': pa.array([[0.1], [1e300]], pa.list_(pa.float64())),
    'uniform_bool': pa.array([[True, False], [False, False]], pa.list_(pa.bool_())),
    'uniform_uint8': pa.array([[255, 0], [1, 2]], pa.list_(pa.uint8())),
    'empty_lists': pa.array([[], [], []], pa.list_(pa.int64())),
    'ragged': pa.array([[1], [2, 3], []], pa.list_(pa.int64())),
    'null_row': pa.array([[1, 2], None, [3, 4]], pa.list_(pa.int64())),
    'null_item_float': pa.array([[1.0, None], [2.0, 3.0]], pa.list_(pa.float64())),
    'large_list': pa.array([[7, 8], [9, 10]], pa.large_list(pa.int16())),
    'sliced': pa.array([[0, 0], [1, 2], [3, 4], [5, 6, 7]], pa.list_(pa.int32())).slice(1, 2),
    'chunked': pa.chunked_array([pa.array([[1, 2]], pa.list_(pa.int32())),
                                 pa.array([[3, 4], [5, 6]], pa.list_(pa.int32()))]),
    'zero_rows': pa.array([], pa.list_(pa.int32())),
    'strings': pa.array(['a', None, 'c']),
    'binary': pa.array([b'\x00', b'x', None]),
    'dict_int': pa.array([3, 1, 3]).dictionary_encode(),
    'int_with_null': pa.array([1, None, 3]),
}


@pytest.mark.parametrize('case', sorted(LIST_CASES))
def test_column_conversion_equals_jax(case):
    column = LIST_CASES[case]
    if not isinstance(column, pa.ChunkedArray):
        column = pa.chunked_array([column])
    field = Unischema.from_arrow_schema(pa.schema([('x', column.type)])).fields['x']
    jax_field = JaxUnischema.from_arrow_schema(pa.schema([('x', column.type)])).fields['x']
    got = arrow_column_to_numpy(column, field)
    want = jax_arrow_worker._arrow_column_to_numpy(column, jax_field)
    if case == 'dict_int':     # pandas' Categorical in the JAX package
        want = np.asarray(want)
    _same(got, want)


@pytest.mark.parametrize('arrow_type', [
    pa.null(), pa.map_(pa.string(), pa.int8()), pa.binary(3), pa.string_view(),
    pa.binary_view(), pa.float16(), pa.uint64(), pa.duration('ms'), pa.bool_()])
def test_other_types_infer_as_in_jax(arrow_type):
    schema = pa.schema([('x', arrow_type)])
    port, jax = (cls.from_arrow_schema(schema).fields['x'] for cls in (Unischema, JaxUnischema))
    assert (port.numpy_dtype, port.shape, port.nullable) == \
        (jax.numpy_dtype, jax.shape, jax.nullable)


def test_null_item_of_an_int_list_raises_in_both():
    column = pa.chunked_array([pa.array([[1, None], [2, 3]], pa.list_(pa.int64()))])
    field = Unischema.from_arrow_schema(pa.schema([('x', column.type)])).fields['x']
    with pytest.raises(TypeError):
        jax_arrow_worker._arrow_column_to_numpy(column, field)
    with pytest.raises(TypeError):
        arrow_column_to_numpy(column, field)


def test_dictionary_column_with_nulls_decodes_its_values():
    """pyarrow's ``to_numpy`` of a dictionary array with nulls reads the
    null slots' indices; the port decodes the dictionary first. The JAX
    package's numeric path goes through that ``to_numpy`` and gives a value
    where the row is null (a fault of the reference the port avoids)."""
    column = pa.chunked_array([pa.array(['a', 'b', None, 'a']).dictionary_encode()])
    field = Unischema.from_arrow_schema(pa.schema([('x', column.type)])).fields['x']
    assert list(arrow_column_to_numpy(column, field)) == ['a', 'b', None, 'a']
    column = pa.chunked_array([pa.array([1, None, 3, 1]).dictionary_encode()])
    field = Unischema.from_arrow_schema(pa.schema([('x', column.type)])).fields['x']
    got = arrow_column_to_numpy(column, field)
    assert got[0] == 1 and np.isnan(got[1]) and list(got[2:]) == [3, 1]
    jax = jax_arrow_worker._arrow_column_to_numpy(column, field)
    assert not np.isnan(np.asarray(jax, dtype=float)[1])


# --------------------------------------------------------------------------
# the reader
# --------------------------------------------------------------------------

@pytest.mark.parametrize('pool,extra', [
    ('dummy', {'shuffle_row_groups': False}),
    ('thread', {'deterministic': True, 'seed': 3}),
])
def test_chunks_equal_jax(plain_store, pool, extra):
    port = _chunks(make_batch_reader(plain_store, reader_pool_type=pool, workers_count=3,
                                     **extra))
    jax = _chunks(jax_make_batch_reader(plain_store, reader_pool_type=pool, workers_count=3,
                                        **extra))
    assert sum(len(c['id']) for c in port) == 2 * ROWS_PER_PART
    _assert_streams_equal(port, jax)
    assert port[0]['fixed'].shape == (PER_GROUP, 3) and port[0]['fixed'].dtype == np.int32
    assert port[0]['ragged'].dtype == object and port[0]['part'].dtype == np.int64


def test_thread_pool_default_mode_is_the_same_multiset(plain_store):
    ids = sorted(int(i) for c in _chunks(make_batch_reader(plain_store, schema_fields=['id'],
                                                           workers_count=4, seed=1))
                 for i in c['id'])
    assert ids == list(range(2 * ROWS_PER_PART))


def test_schema_fields_are_names_or_regexes(plain_store):
    kwargs = dict(schema_fields=['id', 'f.*', 'part'], reader_pool_type='dummy',
                  shuffle_row_groups=False)
    port = _chunks(make_batch_reader(plain_store, **kwargs))
    _assert_streams_equal(port, _chunks(jax_make_batch_reader(plain_store, **kwargs)))
    assert set(port[0]) == {'f', 'fixed', 'flag', 'id', 'part'}
    field = Unischema.from_arrow_schema(pa.schema([('id', pa.int64())])).fields['id']
    with pytest.raises(ValueError, match='field-name'):
        make_batch_reader(plain_store, schema_fields=[field])


def _mixed_split(module):
    """A split over an int field beside a float one: the predicate sees the
    pandas row, where ``id`` is a float, so ``str(id)`` is ``'3.0'``."""
    return module.in_reduce([module.in_pseudorandom_split([0.5, 0.5], 0, 'id'),
                             module.in_lambda(['f'], lambda f: f >= 0.0)], all)


@pytest.mark.parametrize('pool', ['dummy', 'thread'])
def test_predicate_sees_pandas_row_values_as_in_jax(plain_store, pool):
    kwargs = dict(schema_fields=['id', 's'], reader_pool_type=pool, shuffle_row_groups=False,
                  deterministic=pool == 'thread', seed=0)
    port = _chunks(make_batch_reader(plain_store, predicate=_mixed_split(predicates), **kwargs))
    jax = _chunks(jax_make_batch_reader(plain_store, predicate=_mixed_split(jax_predicates),
                                        **kwargs))
    _assert_streams_equal(port, jax)
    kept = sorted(int(i) for c in port for i in c['id'])
    by_int = [i for i in range(2 * ROWS_PER_PART)
              if predicates.in_pseudorandom_split([0.5, 0.5], 0, 'id').do_include({'id': i})]
    by_float = [i for i in range(2 * ROWS_PER_PART)
                if predicates.in_pseudorandom_split([0.5, 0.5], 0, 'id').do_include(
                    {'id': float(i)})]
    assert kept == by_float != by_int


def test_predicate_on_a_partition_and_a_column(plain_store):
    def pred(module):
        return module.in_lambda(['part', 'i32'], lambda p, v: p == 1 and v > 0)

    kwargs = dict(schema_fields=['id', 'i32'], reader_pool_type='dummy',
                  shuffle_row_groups=False)
    port = _chunks(make_batch_reader(plain_store, predicate=pred(predicates), **kwargs))
    _assert_streams_equal(port, _chunks(jax_make_batch_reader(
        plain_store, predicate=pred(jax_predicates), **kwargs)))
    assert all(i >= ROWS_PER_PART for c in port for i in c['id'])


def _scale(df):
    df['f'] = df['f'] * 2.0
    df['twice'] = df['i32'].astype('int64') * 2
    return df


@pytest.mark.parametrize('drops,permute', [(1, False), (3, False), (1, True), (2, True)])
def test_transform_drop_partitions_and_permutation_equal_jax(plain_store, drops, permute):
    fields = [('twice', np.int64, (), False)]
    kwargs = dict(schema_fields=['id', 'f', 'i32', 'vec', 'nulled'], reader_pool_type='dummy',
                  shuffle_row_groups=False, shuffle_row_drop_partitions=drops,
                  shuffle_rows_in_chunk=permute, seed=7)
    port = _chunks(make_batch_reader(plain_store, transform_spec=TransformSpec(
        _scale, edit_fields=fields, removed_fields=['i32']), **kwargs))
    jax = _chunks(jax_make_batch_reader(plain_store, transform_spec=JaxTransformSpec(
        _scale, edit_fields=fields, removed_fields=['i32']), **kwargs))
    _assert_streams_equal(port, jax)
    assert 'i32' not in port[0] and port[0]['twice'].dtype == np.int64
    assert len(port) == 6 * drops


def test_local_disk_arrow_cache_is_shared_with_jax(plain_store, tmp_path):
    kwargs = dict(schema_fields=['id', 'fixed', 'ragged', 's'], reader_pool_type='dummy',
                  shuffle_row_groups=False, cache_type='local-disk',
                  cache_location=str(tmp_path / 'cache'))
    with jax_make_batch_reader(plain_store, **kwargs) as reader:
        jax = [c._asdict() for c in reader]
    reader = make_batch_reader(plain_store, num_epochs=2, **kwargs)
    port = _chunks(reader)
    assert reader.cache_stats()['misses'] == 0 and reader.cache_stats()['hits'] == 12
    _assert_streams_equal(port[:6], jax)
    _assert_streams_equal(port[6:], jax)
    assert {seg for seg in (reader.last_chunk_lineage['tier'],)} == {'disk'}
    # The port's own fills serve the JAX reader too.
    kwargs['cache_location'] = str(tmp_path / 'port_cache')
    first = make_batch_reader(plain_store, **kwargs)
    _chunks(first)
    assert first.cache_stats()['misses'] == 6
    _assert_streams_equal(port[:6], _chunks(jax_make_batch_reader(plain_store, **kwargs)))


def test_arrow_table_cache_entries_equal_jax(tmp_path):
    """The port's Arrow cache writes the JAX cache's bytes under the JAX
    cache's file name, and each serves the other's entry as a hit."""
    from petastorm_tpu.cache import LocalDiskArrowTableCache as JaxArrowCache
    from petastorm_tpu_torch.cache import LocalDiskArrowTableCache
    table = pa.table({'tokens': pa.array([[1, 2], [3, 4, 5]], pa.list_(pa.int32())),
                      'id': pa.array([7, 8], pa.int64())})
    port = LocalDiskArrowTableCache(str(tmp_path / 'port'))
    jax = JaxArrowCache(str(tmp_path / 'jax'))
    assert port.get('k', lambda: table).equals(table)
    assert jax.get('k', lambda: table).equals(table)
    names = [sorted(os.listdir(str(tmp_path / d))) for d in ('port', 'jax')]
    assert names[0] == names[1] and len(names[0]) == 1
    blobs = [open(str(tmp_path / d / names[0][0]), 'rb').read() for d in ('port', 'jax')]
    assert blobs[0] == blobs[1]

    def refill():
        raise AssertionError('a hit was expected')

    assert JaxArrowCache(str(tmp_path / 'port')).get('k', refill).equals(table)
    served = LocalDiskArrowTableCache(str(tmp_path / 'jax'))
    assert served.get('k', refill).equals(table)
    assert (port.misses, port.hits, served.misses, served.hits) == (1, 0, 0, 1)


def test_chunk_store_cache_is_refused(plain_store, tmp_path):
    with pytest.raises(ValueError, match='chunk-store'):
        make_batch_reader(plain_store, cache_type='chunk-store', cache_location=str(tmp_path))


def test_petastorm_store_warns_and_gives_encoded_columns(synthetic_dataset):
    kwargs = dict(schema_fields=['id', 'image_png', 'matrix'], reader_pool_type='dummy',
                  shuffle_row_groups=False)
    with pytest.warns(UserWarning, match='petastorm_tpu store'):
        port = _chunks(make_batch_reader(synthetic_dataset.url, **kwargs))
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        jax = _chunks(jax_make_batch_reader(synthetic_dataset.url, **kwargs))
    _assert_streams_equal(port, jax)
    assert isinstance(port[0]['image_png'][0], bytes)


# --------------------------------------------------------------------------
# the loaders, resume, the pod reader
# --------------------------------------------------------------------------

NUMERIC = ['f', 'fixed', 'flag', 'i32', 'id', 'vec']


def _loader_digests(batches):
    return [{name: _digest_array(np.asarray(batch[name])) for name in sorted(batch)}
            for batch in batches]


def _as_jax_dtypes(port, jax):
    """The port's batch cast to the JAX loader's dtypes (it narrows 64-bit
    types; the port keeps them; datetimes are int64 nanoseconds in the
    port)."""
    out = {}
    for name, value in port.items():
        want = np.asarray(jax[name])
        out[name] = value.numpy().astype(want.dtype) if want.dtype.kind != 'M' else \
            value.numpy().astype('datetime64[ns]').astype(want.dtype)
    return out


@pytest.mark.parametrize('last_batch', ['drop', 'partial', 'pad'])
def test_torch_loader_equals_jax_loader(plain_store, last_batch):
    kwargs = dict(schema_fields=NUMERIC + ['part'], reader_pool_type='dummy',
                  shuffle_row_groups=False)
    with make_batch_reader(plain_store, **kwargs) as reader:
        with TorchLoader(reader, 8, device='cpu', last_batch=last_batch) as loader:
            port = [{k: v.clone() for k, v in b._asdict().items()} for b in loader]
    with jax_make_batch_reader(plain_store, **kwargs) as reader:
        with JaxLoader(reader, 8, last_batch=last_batch) as loader:
            jax = [{k: np.asarray(v) for k, v in b._asdict().items()} for b in loader]
    assert len(port) == len(jax) == (7 if last_batch == 'drop' else 8)
    assert set(port[0]) == set(jax[0])
    assert _loader_digests([_as_jax_dtypes(p, j) for p, j in zip(port, jax)]) == \
        _loader_digests(jax)
    assert port[0]['fixed'].shape == (8, 3)


def test_loaders_drop_or_refuse_object_columns_alike(plain_store):
    kwargs = dict(schema_fields=['id', 'b', 'ragged'], reader_pool_type='dummy',
                  shuffle_row_groups=False)
    with make_batch_reader(plain_store, **kwargs) as reader:
        with pytest.warns(UserWarning, match="dropping non-tensor fields: \\['b'\\]"):
            with TorchLoader(reader, 8, device='cpu') as loader:
                with pytest.raises(ValueError, match='ragged'):
                    next(loader)
    with jax_make_batch_reader(plain_store, **kwargs) as reader:
        with pytest.warns(UserWarning, match="dropping non-tensor fields: \\['b'\\]"):
            with JaxLoader(reader, 8) as loader:
                with pytest.raises(ValueError, match='ragged'):
                    next(loader)
    for factory, loader_cls in ((make_batch_reader, TorchLoader),
                                (jax_make_batch_reader, JaxLoader)):
        extra = {'device': 'cpu'} if loader_cls is TorchLoader else {}
        with factory(plain_store, **dict(kwargs, schema_fields=['id', 'b'])) as reader:
            with pytest.raises(ValueError, match='cannot batch'):
                with loader_cls(reader, 8, strict_fields=True, **extra) as loader:
                    next(loader)


def test_null_list_rows_are_dropped_or_refused_alike(plain_store):
    """A list column whose chunk starts with a null row is dropped (no
    policy) or refused (a shape policy meets the None) by both loaders."""
    from petastorm_tpu.jax_loader import PadTo as JaxPadTo
    from petastorm_tpu_torch import PadTo

    kwargs = dict(schema_fields=['id', 'nulled'], reader_pool_type='dummy',
                  shuffle_row_groups=False)
    for factory, loader_cls, pad, extra in (
            (make_batch_reader, TorchLoader, PadTo, {'device': 'cpu'}),
            (jax_make_batch_reader, JaxLoader, JaxPadTo, {})):
        with factory(plain_store, **kwargs) as reader:
            with pytest.warns(UserWarning, match="dropping non-tensor fields: \\['nulled'\\]"):
                with loader_cls(reader, 10, **extra) as loader:
                    assert set(next(loader)._asdict()) == {'id'}
        with factory(plain_store, **kwargs) as reader:
            with loader_cls(reader, 10, shape_policies={'nulled': pad((2,))}, **extra) as loader:
                with pytest.raises(ValueError):      # the messages differ
                    next(loader)


def test_datetimes_batch_as_int64_nanoseconds(plain_store):
    """The port's dtype table: a datetime column batches as int64
    nanoseconds (the JAX loader refuses it)."""
    kwargs = dict(schema_fields=['id', 'day', 'ts'], reader_pool_type='dummy',
                  shuffle_row_groups=False)
    with make_batch_reader(plain_store, **kwargs) as reader:
        with TorchLoader(reader, 10, device='cpu') as loader:
            batch = next(loader)
    with jax_make_batch_reader(plain_store, **kwargs) as reader:
        chunk = next(reader)
        with pytest.raises(ValueError, match='day'):
            with JaxLoader(reader, 10) as loader:
                next(loader)
    assert batch.day.dtype == batch.ts.dtype == torch.int64
    assert np.array_equal(batch.day.numpy(), chunk.day.astype('datetime64[ns]').view(np.int64))
    assert np.array_equal(batch.ts.numpy(), chunk.ts.astype('datetime64[ns]').view(np.int64))


def _resume_pair(make_first, make_second, url, kwargs, consumed):
    """Read ``consumed`` chunks with the first package's reader, resume the
    second's from its state, and return (the resumed chunks, the whole
    uninterrupted stream)."""
    with make_first(url, **kwargs) as reader:
        for _ in range(consumed):
            next(reader)
        state = json.loads(json.dumps(reader.state_dict()))
    with make_second(url, resume_state=state, **kwargs) as reader:
        resumed = [c._asdict() for c in reader]
    return resumed, _chunks(make_batch_reader(url, **kwargs))


@pytest.mark.parametrize('direction', ['port_to_jax', 'jax_to_port'])
@pytest.mark.parametrize('deterministic', [True, False])
def test_resume_in_each_direction(plain_store, direction, deterministic):
    kwargs = dict(schema_fields=['id', 'fixed'], reader_pool_type='thread', workers_count=2,
                  seed=4, deterministic=deterministic, shuffle_rows_in_chunk=True,
                  shuffle_row_drop_partitions=2)
    first, second = ((make_batch_reader, jax_make_batch_reader) if direction == 'port_to_jax'
                     else (jax_make_batch_reader, make_batch_reader))
    with warnings.catch_warnings():
        warnings.simplefilter('error')           # the fingerprints agree
        resumed, whole = _resume_pair(first, second, plain_store, kwargs, 5)
    ids = [int(i) for c in resumed for i in c['id']]
    if deterministic:
        tail = [int(i) for c in whole[5:] for i in c['id']]
        assert ids == tail
    else:
        assert len(ids) == len(set(ids)) == 2 * ROWS_PER_PART - 5 * PER_GROUP // 2


def test_pandas_blocked(plain_store, tmp_path):
    """The batch reader and the loader run where pandas cannot be imported,
    to the values the JAX package reads with it. pandas is blocked by a
    finder that raises ``ImportError``, as an absent pandas does: with
    ``sys.modules['pandas'] = None`` pyarrow's own pandas check fails in
    every array constructor (``pa.array``, ``pa.scalar``), port or not."""
    out = str(tmp_path / 'blocked.npz')
    code = (
        'import sys\n'
        'class Block(object):\n'
        '    def find_spec(self, name, path=None, target=None):\n'
        '        if name.split(".")[0] == "pandas":\n'
        '            raise ImportError("pandas is blocked")\n'
        'sys.meta_path.insert(0, Block())\n'
        'import numpy as np\n'
        'from petastorm_tpu_torch import TorchLoader, make_batch_reader\n'
        'with make_batch_reader({url!r}, reader_pool_type="thread", workers_count=2,\n'
        '                       shuffle_row_groups=False, deterministic=True) as r:\n'
        '    chunks = [c._asdict() for c in r]\n'
        'with make_batch_reader({url!r}, schema_fields=["id", "fixed", "ts"],\n'
        '                       reader_pool_type="dummy", shuffle_row_groups=False) as r:\n'
        '    with TorchLoader(r, 8, device="cpu") as loader:\n'
        '        ids = np.concatenate([b.id.numpy().copy() for b in loader])\n'
        'np.savez({out!r}, ids=ids, **{{"{{}}_{{}}".format(i, k): v for i, c in '
        'enumerate(chunks) for k, v in c.items()}})\n'
        'print("ok", "pandas" in sys.modules)\n'
    ).format(url=plain_store, out=out)
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == 'ok False'
    saved = np.load(out, allow_pickle=True)
    jax = _chunks(jax_make_batch_reader(plain_store, reader_pool_type='dummy',
                                        shuffle_row_groups=False))
    for i, chunk in enumerate(jax):
        for name, want in chunk.items():
            _same(saved['{}_{}'.format(i, name)], want)
    assert list(saved['ids']) == list(range(7 * 8))


def test_make_pod_reader_with_the_batch_factory(plain_store):
    kwargs = dict(schema_fields=['id', 'vec'], deterministic=True, seed=2,
                  reader_pool_type='thread', workers_count=2)
    hosts = [_chunks(make_pod_reader(plain_store, reader_factory=make_batch_reader,
                                     pod_shard=(h, 2), **kwargs)) for h in range(2)]
    jax_hosts = [_chunks(jax_make_pod_reader(plain_store, reader_factory=jax_make_batch_reader,
                                             pod_shard=(h, 2), **kwargs)) for h in range(2)]
    for port, jax in zip(hosts, jax_hosts):
        _assert_streams_equal(port, jax)
    whole = _chunks(make_pod_reader(plain_store, reader_factory=make_batch_reader,
                                    pod_shard=(0, 1), **kwargs))
    interleaved = [hosts[j % 2][j // 2] for j in range(len(whole))]
    _assert_streams_equal(interleaved, whole)
    with pytest.raises(ValueError, match='owns cur_shard'):
        make_pod_reader(plain_store, reader_factory=make_batch_reader, cur_shard=0,
                        shard_count=2)


@pytest.mark.parametrize('mixture', [False, True])
def test_ledgered_batches_replay_in_both_packages(plain_store, tmp_path, mixture):
    """A batch reader's (and a mixture's) ledger records replay, permuted
    and sliced, to the delivered bytes, through the port's ``verify_record``
    and the JAX package's."""
    from petastorm_tpu import lineage as jax_lineage
    from petastorm_tpu_torch.lineage import read_ledger_dir, verify_record
    from petastorm_tpu_torch.weighted_sampling_reader import WeightedSamplingReader

    kwargs = dict(schema_fields=['fixed', 'vec', 'i32'], reader_pool_type='thread',
                  workers_count=2, deterministic=True, seed=6, shuffle_rows_in_chunk=True,
                  shuffle_row_drop_partitions=2)
    if mixture:
        reader = WeightedSamplingReader([make_batch_reader(plain_store, **kwargs),
                                         make_batch_reader(plain_store, **dict(kwargs, seed=7))],
                                        [0.5, 0.5], seed=1)
    else:
        reader = make_batch_reader(plain_store, **kwargs)
    ledger = str(tmp_path / 'ledger')
    with reader:
        with TorchLoader(reader, 4, device='cpu', lineage=ledger) as loader:
            delivered = [{k: v.numpy().copy() for k, v in b._asdict().items()} for b in loader]
    [(_, ctx, records)] = read_ledger_dir(ledger)
    assert ctx['mode'] == ('mixture' if mixture else 'arrow') and len(records) == len(delivered)
    sources = set()
    for record, batch in zip(records, delivered):
        replayed = verify_record(record, ctx)
        assert all(np.array_equal(replayed[k], batch[k]) for k in batch)
        jax_lineage.verify_record(record, ctx)
        sources.update(seg.get('source') for seg in record['segments'])
    assert sources == ({0, 1} if mixture else {None})


def test_batching_table_queue_equals_jax():
    from petastorm_tpu.arrow_helpers import BatchingTableQueue as JaxQueue
    from petastorm_tpu_torch.arrow_helpers import BatchingTableQueue

    rng = np.random.default_rng(0)
    sizes = [3, 0, 7, 1, 12, 5]
    tables = []
    start = 0
    for n in sizes:
        tables.append(pa.table({'x': np.arange(start, start + n), 'y': rng.random(n)}))
        start += n
    port, jax = BatchingTableQueue(4), JaxQueue(4)
    got, want = [], []
    for i, table in enumerate(tables):
        item = table.to_batches()[0] if (i % 2 and table.num_rows) else table
        for queue, out in ((port, got), (jax, want)):
            queue.put(item)
            while not queue.empty():
                out.append(queue.get())
        assert len(port) == len(jax)
    assert [t.equals(u) for t, u in zip(got, want)] == [True] * len(want) and len(got) == 7
    assert [t.num_rows for t in got] == [4] * 7
    with pytest.raises(IndexError, match='underflow'):
        port.get()
    with pytest.raises(ValueError, match='Schema mismatch'):
        port.put(pa.table({'z': [1]}))
    with pytest.raises(ValueError, match='batch_size'):
        BatchingTableQueue(0)
