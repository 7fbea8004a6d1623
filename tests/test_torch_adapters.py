"""The adapters: ``pytorch.DataLoader``/``BatchedDataLoader`` and the
converter, the port against the JAX package (``petastorm_tpu/pytorch.py:
34-159``, ``petastorm_tpu/converter.py``).

The port's ``DataLoader(device='cpu')`` yields the JAX adapter's batches
(the same host tensors, shuffling buffer included) over the same readers;
the sanitising widens and refuses alike; ``make_converter`` writes the
same store (narrowed floats, row-groups, ``_common_metadata``), dedupes by
content and write arguments, deletes; ``make_torch_loader`` (and its
``make_jax_loader`` alias) and ``make_torch_dataloader`` give the rows the
JAX converter's loaders give. Exact: tensors are compared with
``torch.equal``, stores by their Parquet tables.
"""

import collections
import decimal
import os

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from petastorm_tpu import converter as jax_converter
from petastorm_tpu import make_batch_reader as jax_make_batch_reader
from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu import pytorch as jax_pytorch
from petastorm_tpu.transform import TransformSpec as JaxTransformSpec
from petastorm_tpu_torch import converter, make_batch_reader, make_reader, pytorch
from petastorm_tpu_torch.transform import TransformSpec
from petastorm_tpu_torch.weighted_sampling_reader import WeightedSamplingReader


@pytest.fixture(autouse=True)
def _isolated_caches(tmp_path, monkeypatch):
    monkeypatch.setenv(converter.CACHE_DIR_ENV, str(tmp_path / 'port_cache'))
    monkeypatch.setenv(jax_converter.CACHE_DIR_ENV, str(tmp_path / 'jax_cache'))
    yield
    converter._cleanup_all()
    jax_converter._cleanup_all()


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert type(a).__name__ == type(b).__name__ and a._fields == b._fields
        for x, y in zip(a, b):
            if isinstance(y, torch.Tensor):
                assert isinstance(x, torch.Tensor) and x.dtype == y.dtype and torch.equal(x, y)
            else:
                assert x == y


def _batches(loader_cls, reader, **kwargs):
    with loader_cls(reader, **kwargs) as loader:
        return list(loader)


@pytest.mark.parametrize('cls', ['DataLoader', 'BatchedDataLoader'])
@pytest.mark.parametrize('shuffle', [0, 20])
def test_row_reader_batches_equal_jax(synthetic_dataset, cls, shuffle):
    kwargs = dict(schema_fields=['id', 'id2', 'matrix', 'image_png'], reader_pool_type='dummy',
                  shuffle_row_groups=False)
    port = _batches(getattr(pytorch, cls), make_reader(synthetic_dataset.url, **kwargs),
                    batch_size=8, shuffling_queue_capacity=shuffle, seed=4, device='cpu')
    jax = _batches(getattr(jax_pytorch, cls), jax_make_reader(synthetic_dataset.url, **kwargs),
                   batch_size=8, shuffling_queue_capacity=shuffle, seed=4)
    _assert_batches_equal(port, jax)
    assert [len(b.id) for b in port] == [8] * 6 + [2]


def test_batch_reader_batches_equal_jax(scalar_dataset):
    def spec(cls):
        return cls(selected_fields=['id', 'float_col', 'int_fixed', 'list_col'])

    kwargs = dict(reader_pool_type='dummy', shuffle_row_groups=False)
    port = _batches(pytorch.DataLoader, make_batch_reader(
        scalar_dataset.url, transform_spec=spec(TransformSpec), **kwargs),
        batch_size=30, shuffling_queue_capacity=40, seed=1, device='cpu')
    jax = _batches(jax_pytorch.DataLoader, jax_make_batch_reader(
        scalar_dataset.url, transform_spec=spec(JaxTransformSpec), **kwargs),
        batch_size=30, shuffling_queue_capacity=40, seed=1)
    _assert_batches_equal(port, jax)
    assert port[0].list_col.shape == (30, 2)


def test_mixture_through_the_data_loader(scalar_dataset):
    readers = [make_batch_reader(scalar_dataset.url, schema_fields=['id', 'int_fixed'],
                                 reader_pool_type='dummy', seed=s, num_epochs=1)
               for s in (0, 1)]
    mixture = WeightedSamplingReader(readers, [1, 1], seed=0)
    batches = _batches(pytorch.DataLoader, mixture, batch_size=16, device='cpu')
    assert sum(len(b.id) for b in batches) >= 100


def test_sanitising_equals_jax():
    row = {'a': np.uint16(3), 'b': np.bool_(True), 'c': np.arange(3, dtype=np.uint32),
           'd': np.float32(1.5), 'e': np.array([True, False]), 'f': np.arange(2, dtype=np.uint16)}
    port, jax = dict(row), dict(row)
    pytorch._sanitize_pytorch_types(port)
    jax_pytorch._sanitize_pytorch_types(jax)
    for name in row:
        assert np.asarray(port[name]).dtype == np.asarray(jax[name]).dtype
        assert np.array_equal(port[name], jax[name])
    for bad in ({'s': 'text'}, {'s': np.array(['a', 'b'])}, {'o': np.array([None], object)}):
        with pytest.raises(TypeError):
            pytorch._sanitize_pytorch_types(dict(bad))
        with pytest.raises(TypeError):
            jax_pytorch._sanitize_pytorch_types(dict(bad))


def test_decimal_friendly_collate_equals_jax():
    nt = collections.namedtuple('Row', ['d', 'x'])
    batch = [nt(decimal.Decimal('1.5'), np.float32(i)) for i in range(3)]
    port, jax = pytorch.decimal_friendly_collate(batch), jax_pytorch.decimal_friendly_collate(batch)
    assert port.d == jax.d == (decimal.Decimal('1.5'),) * 3
    assert torch.equal(port.x, jax.x)
    dicts = [{'a': np.int64(i), 'b': [np.int64(i), np.int64(2 * i)]} for i in range(2)]
    port, jax = pytorch.decimal_friendly_collate(dicts), jax_pytorch.decimal_friendly_collate(dicts)
    assert torch.equal(port['a'], jax['a']) and all(torch.equal(p, j)
                                                    for p, j in zip(port['b'], jax['b']))


def test_data_loader_refuses_ngram_and_a_second_iterator(synthetic_dataset):
    from petastorm_tpu_torch.ngram import NGram
    reader = make_reader(synthetic_dataset.url,
                         schema_fields=NGram({0: ['id'], 1: ['id']}, 5, 'id'))
    with pytest.raises(NotImplementedError, match='NGram'):
        pytorch.DataLoader(reader, device='cpu')
    reader.stop()
    reader.join()
    with pytorch.DataLoader(make_reader(synthetic_dataset.url, schema_fields=['id']),
                            batch_size=5, device='cpu') as loader:
        it = iter(loader)
        next(it)
        with pytest.raises(RuntimeError, match='one iterator'):
            next(iter(loader))


# --------------------------------------------------------------------------
# the converter
# --------------------------------------------------------------------------

def _frame(n=100, seed=0):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({'id': np.arange(n, dtype=np.int64), 'x': rng.standard_normal(n),
                         'y': rng.standard_normal(n).astype(np.float32),
                         'label': rng.integers(0, 10, n).astype(np.int32)})


def _store_tables(conv):
    path = conv.dataset_url[len('file://'):]
    files = sorted(f for f in os.listdir(path) if f.endswith('.parquet'))
    return [pq.ParquetFile(os.path.join(path, f)) for f in files], path


@pytest.mark.parametrize('kwargs', [{}, {'precision': 64}, {'rows_per_row_group': 7},
                                    {'row_group_size_mb': 0.001}])
def test_converter_writes_the_jax_store(kwargs):
    port, jax = converter.make_converter(_frame(50), **kwargs), \
        jax_converter.make_converter(_frame(50), **kwargs)
    assert len(port) == len(jax) == 50
    (port_files, port_path), (jax_files, jax_path) = _store_tables(port), _store_tables(jax)
    assert [f.metadata.num_row_groups for f in port_files] == \
        [f.metadata.num_row_groups for f in jax_files]
    assert port_files[0].read().equals(jax_files[0].read())
    assert pq.read_schema(os.path.join(port_path, '_common_metadata')).equals(
        pq.read_schema(os.path.join(jax_path, '_common_metadata')), check_metadata=True)
    assert port_files[0].schema_arrow.field('x').type == \
        (pa.float64() if kwargs.get('precision') == 64 else pa.float32())
    with pytest.raises(ValueError, match='precision'):
        converter.make_converter(_frame(5), precision=16)
    with pytest.raises(TypeError, match='DataFrame'):
        converter.make_converter([1, 2])


def test_converter_dedupes_by_content_and_write_arguments():
    a = converter.make_converter(_frame(32, seed=1))
    assert converter.make_converter(_frame(32, seed=1)) is a
    assert converter.make_converter(pa.Table.from_pandas(_frame(32, seed=1),
                                                         preserve_index=False)) is a
    assert converter.make_converter(_frame(32, seed=2)) is not a
    assert converter.make_converter(_frame(32, seed=1), rows_per_row_group=8) is not a
    data = pa.table({'x': pa.array(range(1000))})
    chunked = pa.Table.from_batches(data.to_batches(max_chunksize=77))
    assert converter._fingerprint(data) == converter._fingerprint(chunked) == \
        jax_converter._fingerprint(data)


def test_converter_delete_and_cache_directories(tmp_path, monkeypatch):
    conv = converter.make_converter(_frame(8, seed=3))
    path = conv.dataset_url[len('file://'):]
    assert path.startswith(str(tmp_path / 'port_cache'))
    conv.delete()
    assert not os.path.exists(path)
    assert converter.make_converter(_frame(8, seed=3)) is not conv
    conv = converter.make_converter(_frame(8), parent_cache_dir_url='file://' + str(
        tmp_path / 'explicit'))
    assert conv.dataset_url.startswith('file://' + str(tmp_path / 'explicit'))
    converter.register_converter_cache_dir(str(tmp_path / 'registered'))
    try:
        monkeypatch.delenv(converter.CACHE_DIR_ENV)
        assert converter.make_converter(_frame(9)).dataset_url.startswith(
            'file://' + str(tmp_path / 'registered'))
    finally:
        converter.register_converter_cache_dir(None)
    stale = converter.make_converter(_frame(10))
    converter._cleanup_all()          # what atexit runs
    assert not os.path.exists(stale.dataset_url[len('file://'):])


@pytest.mark.parametrize('method', ['make_torch_loader', 'make_jax_loader'])
def test_converter_loader_equals_jax(method):
    port, jax = converter.make_converter(_frame(96)), jax_converter.make_converter(_frame(96))
    kwargs = dict(batch_size=32, num_epochs=1, shuffle_row_groups=False, workers_count=2)
    with getattr(port, method)(device='cpu', **kwargs) as loader:
        got = [{k: v.clone() for k, v in b._asdict().items()} for b in loader]
    with jax.make_jax_loader(**kwargs) as loader:
        want = [{k: np.asarray(v) for k, v in b._asdict().items()} for b in loader]
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        for name in b:
            assert np.array_equal(a[name].numpy().astype(b[name].dtype), b[name])
        assert a['x'].dtype == torch.float32 and a['id'].dtype == torch.int64


def test_converter_torch_dataloader_equals_jax():
    port, jax = converter.make_converter(_frame(40)), jax_converter.make_converter(_frame(40))
    kwargs = dict(batch_size=10, num_epochs=1, shuffle_row_groups=False, workers_count=1,
                  shuffling_queue_capacity=15, seed=3)
    with port.make_torch_dataloader(device='cpu', **kwargs) as loader:
        got = list(loader)
    with jax.make_torch_dataloader(**kwargs) as loader:
        want = list(loader)
    _assert_batches_equal(got, want)
