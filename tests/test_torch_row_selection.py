"""Row-drop partitions, the in-chunk row shuffle, holes, cross-package
resume and replay of the port's readers and loader against the JAX
package's (``tests/test_end_to_end.py:190-196``, ``tests/test_tensor_reader.
py:371-436``, ``tests/test_determinism.py:422``): the slice and permutation
functions equal the JAX ones; the streams, under a predicate that leaves
chunks of uneven length and row-groups empty, equal the JAX readers'
chunk for chunk; a ``state_dict()`` of a filtered, permuted reader or
loader of either package resumes the other's with no row lost or repeated;
a permuted record replays to the delivered batch; the loader's block path,
``superbatches``, ``last_batch`` and the staging-step decode take chunks of
any length; and a store with a ``CompressedNdarrayCodec`` field written by
either package reads back bit-equal in the other. Exact throughout (JPEG
pixels too: both packages decode through the same native codec).
"""

import json

import numpy as np
import pytest

from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu import make_tensor_reader as jax_make_tensor_reader
from petastorm_tpu.codecs import CompressedNdarrayCodec as JaxCompressedNdarrayCodec
from petastorm_tpu.codecs import ScalarCodec as JaxScalarCodec
from petastorm_tpu.etl.writer import write_dataset as jax_write_dataset
from petastorm_tpu.jax_loader import JaxLoader
from petastorm_tpu.lineage import _digest_array
from petastorm_tpu.ngram import NGram as JaxNGram
from petastorm_tpu.predicates import in_lambda as jax_in_lambda
from petastorm_tpu.unischema import Unischema as JaxUnischema
from petastorm_tpu.unischema import UnischemaField as JaxField
from petastorm_tpu.workers import rowgroup_worker_base as jax_base
from petastorm_tpu_torch import (CompressedImageCodec, CompressedNdarrayCodec, NdarrayCodec,
                                 ScalarCodec, TorchLoader, Unischema, UnischemaField, make_reader,
                                 make_tensor_reader, write_dataset)
from petastorm_tpu_torch.lineage import read_ledger_dir, verify_record
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.predicates import in_lambda
from petastorm_tpu_torch.workers import rowgroup_worker_base as base

ROWS, PER_GROUP, BATCH = 70, 16, 8      # a short last row-group


def _row(i, rng):
    return {'id': i, 'label': int(rng.integers(0, 10)),
            'vec': rng.random(4, dtype=np.float32),
            'image': rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)}


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    schema = Unischema('SelectionSchema', [
        UnischemaField('id', np.int64, (), ScalarCodec(np.int64), False),
        UnischemaField('label', np.int64, (), ScalarCodec(np.int64), False),
        UnischemaField('vec', np.float32, (4,), NdarrayCodec(), False),
        UnischemaField('image', np.uint8, (16, 16, 3), CompressedImageCodec('jpeg', 90), False),
    ])
    rng = np.random.default_rng(21)
    url = 'file://' + str(tmp_path_factory.mktemp('selection') / 'store')
    write_dataset(url, schema, (_row(i, rng) for i in range(ROWS)), rows_per_row_group=PER_GROUP)
    return url


def _pred(module_in_lambda):
    """Keeps ids < 16 or >= 40 with label != 3: row-group 1 holds none of
    them in (16, 32), so its items publish holes; the others are uneven."""
    return module_in_lambda(['id', 'label'], lambda i, label: (i < 16 or i >= 40) and label != 3)



def _kept(store):
    with make_tensor_reader(store, schema_fields=['id', 'label'], reader_pool_type='dummy',
                            shuffle_row_groups=False) as reader:
        return sorted(int(i) for c in reader for i, label in zip(c.id, c.label)
                      if (i < 16 or i >= 40) and label != 3)


def _factories(kind):
    return ((make_tensor_reader, jax_make_tensor_reader) if kind == 'tensor'
            else (make_reader, jax_make_reader))


def _chunks(factory, url, **kwargs):
    out = []
    with factory(url, **kwargs) as reader:
        for sample in reader:
            out.append((np.atleast_1d(sample.id).tolist(),
                        {name: _digest_array(np.asarray(getattr(sample, name)))
                         for name in sample._fields}))
    return out


# -- the functions ---------------------------------------------------------------------

@pytest.mark.parametrize('n_rows', [0, 1, 7, 16, 101])
@pytest.mark.parametrize('partitions', [1, 2, 3, 5])
def test_compute_row_slice_equals_jax(n_rows, partitions):
    ngram, jax_ngram = (NGram({0: ['t'], 2: ['t']}, None, 't'),
                        JaxNGram({0: ['t'], 2: ['t']}, None, 't'))
    for p in range(partitions):
        assert base.compute_row_slice(n_rows, (p, partitions)) == \
            jax_base.compute_row_slice(n_rows, (p, partitions))
        assert base.compute_row_slice(n_rows, (p, partitions), ngram) == \
            jax_base.compute_row_slice(n_rows, (p, partitions), jax_ngram)
    assert base.compute_row_slice(n_rows, None) is None


def test_chunk_row_permutation_equals_jax():
    rng = np.random.default_rng(0)
    for _ in range(50):
        args = (int(rng.integers(0, 1000)) if rng.random() > 0.2 else None, 'abc123',
                '/data/part-{}.parquet'.format(int(rng.integers(0, 9))), int(rng.integers(0, 50)),
                (int(rng.integers(0, 3)), 3) if rng.random() > 0.5 else None,
                int(rng.integers(0, 300)))
        perm = base.chunk_row_permutation(*args)
        np.testing.assert_array_equal(perm, jax_base.chunk_row_permutation(*args))
        assert sorted(perm.tolist()) == list(range(args[-1]))


# -- the streams -----------------------------------------------------------------------

@pytest.mark.parametrize('pool,workers', [('dummy', 1), ('thread', 3)])
@pytest.mark.parametrize('kind', ['tensor', 'row'])
@pytest.mark.parametrize('partitions', [2, 3])
def test_drop_partitions_stream_equals_jax(store, kind, pool, workers, partitions):
    port, jax = _factories(kind)
    kwargs = dict(deterministic=True, seed=7, num_epochs=2, reader_pool_type=pool,
                  workers_count=workers, shuffle_row_drop_partitions=partitions)
    got = _chunks(port, store, **kwargs)
    assert got == _chunks(jax, store, **kwargs)
    assert sorted(i for ids, _ in got for i in ids) == sorted(list(range(ROWS)) * 2)


@pytest.mark.parametrize('kind', ['tensor', 'row'])
def test_drop_partitions_default_mode_multiset(store, kind):
    port, _ = _factories(kind)
    ids = [i for c, _ in _chunks(port, store, reader_pool_type='thread', workers_count=3,
                                 shuffle_row_drop_partitions=4, seed=2)
           for i in c]
    assert sorted(ids) == list(range(ROWS))


@pytest.mark.parametrize('pool,workers', [('dummy', 1), ('thread', 2), ('thread', 5)])
@pytest.mark.parametrize('kind', ['tensor', 'row'])
def test_filtered_permuted_stream_equals_jax(store, kind, pool, workers):
    """Predicate, drop partitions and (tensor) the in-chunk shuffle together:
    holes where a row-group keeps no row, uneven chunks elsewhere; the port's
    deterministic stream is the JAX one whatever the worker count."""
    port, jax = _factories(kind)
    kwargs = dict(deterministic=True, seed=11, num_epochs=2, reader_pool_type=pool,
                  workers_count=workers, shuffle_row_drop_partitions=2)
    if kind == 'tensor':
        kwargs['shuffle_rows_in_chunk'] = True
    got = _chunks(port, store, predicate=_pred(in_lambda), **kwargs)
    assert got == _chunks(jax, store, predicate=_pred(jax_in_lambda), **kwargs)
    ids = [i for c, _ in got for i in c]
    assert sorted(ids) == sorted(_kept(store) * 2)


def test_holes_from_predicates_keep_order_across_workers(store):
    def ids(workers):
        return [i for c, _ in _chunks(make_tensor_reader, store, deterministic=True, seed=7,
                                      workers_count=workers,
                                      predicate=in_lambda(['id'], lambda id: id < 20))
                for i in c]

    a = ids(2)
    assert a == ids(5)
    assert sorted(a) == list(range(20))


def test_shuffle_rows_in_chunk_multiset_and_pairing(store):
    kwargs = dict(schema_fields=['id', 'vec'], reader_pool_type='dummy',
                  shuffle_row_groups=False)
    plain = _chunks(make_tensor_reader, store, **kwargs)
    shuffled = _chunks(make_tensor_reader, store, seed=1, shuffle_rows_in_chunk=True, **kwargs)
    assert [sorted(c) for c, _ in plain] == [sorted(c) for c, _ in shuffled]
    assert any(p != s for (p, _), (s, _) in zip(plain, shuffled))
    assert shuffled == _chunks(jax_make_tensor_reader, store, seed=1, shuffle_rows_in_chunk=True,
                               **kwargs)
    # The permutation moves whole rows: every id keeps its vector.
    with make_reader(store, schema_fields=['id', 'vec'], reader_pool_type='dummy') as reader:
        by_id = {int(r.id): r.vec for r in reader}
    with make_tensor_reader(store, seed=1, shuffle_rows_in_chunk=True, **kwargs) as reader:
        for chunk in reader:
            for i, vec in zip(chunk.id, chunk.vec):
                np.testing.assert_array_equal(vec, by_id[int(i)])


def test_shuffle_rows_in_chunk_deterministic_across_sessions_and_epochs(store):
    kwargs = dict(schema_fields=['id'], reader_pool_type='dummy', shuffle_row_groups=False,
                  seed=3, shuffle_rows_in_chunk=True)
    one = _chunks(make_tensor_reader, store, **kwargs)
    assert one == _chunks(make_tensor_reader, store, **kwargs)
    two = _chunks(make_tensor_reader, store, num_epochs=2, **kwargs)
    assert two == one + one


def _loader_ids(factory, loader_cls, url, n=None, resume_state=None, **kwargs):
    """Row ids of a loader's batches (``n`` batches, else all), and its state."""
    seen = []
    with factory(url, resume_state=resume_state, **kwargs) as reader:
        extra = dict(device='cpu') if loader_cls is TorchLoader else dict(autotune=False)
        with loader_cls(reader, BATCH, last_batch='drop', resume_state=resume_state,
                        **extra) as loader:
            it = iter(loader)
            for batch in it if n is None else (next(it) for _ in range(n)):
                seen += np.asarray(batch.id).tolist()
            state = json.loads(json.dumps(loader.state_dict()))
    return seen, state


def test_shuffle_rows_in_chunk_resume_exact(store):
    kwargs = dict(schema_fields=['id'], reader_pool_type='thread', workers_count=2, seed=5,
                  shuffle_rows_in_chunk=True)
    seen1, state = _loader_ids(make_tensor_reader, TorchLoader, store, n=3, **kwargs)
    seen2, _ = _loader_ids(make_tensor_reader, TorchLoader, store, resume_state=state, **kwargs)
    assert not set(seen1) & set(seen2)
    assert ROWS - BATCH < len(seen1) + len(seen2) <= ROWS


@pytest.mark.parametrize('deterministic', [False, True])
@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_filtered_permuted_loader_state_resumes_the_other_package(store, writer, deterministic):
    """A loader state taken mid-chunk over a filtered, permuted, drop-
    partitioned reader resumes the other package's loader: together the two
    sessions deliver every kept row once (the resumed one from the cut on,
    in the uninterrupted stream's order in deterministic mode)."""
    first = (jax_make_tensor_reader, JaxLoader, jax_in_lambda) if writer == 'jax' else \
        (make_tensor_reader, TorchLoader, in_lambda)
    second = (make_tensor_reader, TorchLoader, in_lambda) if writer == 'jax' else \
        (jax_make_tensor_reader, JaxLoader, jax_in_lambda)
    kwargs = dict(schema_fields=['id', 'vec'], seed=9, num_epochs=1, deterministic=deterministic,
                  shuffle_rows_in_chunk=True, shuffle_row_drop_partitions=2,
                  reader_pool_type='thread' if deterministic else 'dummy', workers_count=3)
    full, _ = _loader_ids(second[0], second[1], store, predicate=_pred(second[2]), **kwargs)
    head, state = _loader_ids(first[0], first[1], store, n=3, predicate=_pred(first[2]),
                              **kwargs)
    tail, _ = _loader_ids(second[0], second[1], store, resume_state=state,
                          predicate=_pred(second[2]), **kwargs)
    kept = _kept(store)
    assert not set(head) & set(tail)
    assert len(kept) - BATCH < len(head) + len(tail) <= len(kept)
    assert set(head) | set(tail) <= set(kept)
    if deterministic:
        assert head + tail == full[:len(head) + len(tail)]


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_filtered_permuted_reader_cursor_resumes_the_other_package(store, writer):
    port, jax = make_tensor_reader, jax_make_tensor_reader
    first, second = (jax, port) if writer == 'jax' else (port, jax)
    kwargs = dict(deterministic=True, seed=13, num_epochs=2, workers_count=3,
                  shuffle_rows_in_chunk=True)
    pred = {port: _pred(in_lambda), jax: _pred(jax_in_lambda)}
    full = [i for c, _ in _chunks(port, store, predicate=pred[port], **kwargs) for i in c]
    with first(store, predicate=pred[first], **kwargs) as reader:
        head = [i for _ in range(4) for i in next(reader).id.tolist()]
        state = json.loads(json.dumps(reader.state_dict()))
    with port(store, predicate=pred[port], **kwargs) as a, \
            jax(store, predicate=pred[jax], **kwargs) as b:
        assert json.dumps(a.state_dict()['config'], sort_keys=True) == \
            json.dumps(b.state_dict()['config'], sort_keys=True)
        assert a.lineage_context() == dict(b.lineage_context(), mode='tensor')
    tail = [i for c, _ in _chunks(second, store, predicate=pred[second], resume_state=state,
                                  **kwargs) for i in c]
    assert head + tail == full


# -- replay ----------------------------------------------------------------------------

@pytest.mark.parametrize('partitions', [1, 2])
def test_replay_of_a_permuted_segment_equals_the_delivered_batch(store, tmp_path, partitions):
    live = []
    reader = make_tensor_reader(store, schema_fields=['id', 'vec', 'image'], seed=6,
                                shuffle_rows_in_chunk=True, workers_count=2,
                                shuffle_row_drop_partitions=partitions)
    with reader:
        with TorchLoader(reader, BATCH, device='cpu', lineage=str(tmp_path / 'ledger')) as loader:
            for batch in loader:
                live.append({n: getattr(batch, n).numpy().copy() for n in batch._fields})
    (_, ctx, records), = read_ledger_dir(str(tmp_path / 'ledger'))
    assert len(records) == len(live) and ctx['shuffle_rows_in_chunk'] is True
    assert all(s['permuted'] for r in records for s in r['segments'])
    for record in records:
        assert record['exact']
        replayed = verify_record(record, ctx)
        for name in record['fields']:
            assert replayed[name].tobytes() == live[record['batch_id']][name].tobytes()


def test_filtered_records_are_inexact(store, tmp_path):
    reader = make_tensor_reader(store, schema_fields=['id', 'label'], reader_pool_type='dummy',
                                predicate=_pred(in_lambda))
    with reader:
        with TorchLoader(reader, BATCH, device='cpu', lineage=str(tmp_path / 'ledger')) as loader:
            for _ in loader:
                pass
    (_, ctx, records), = read_ledger_dir(str(tmp_path / 'ledger'))
    assert ctx['predicate'] == {'type': 'in_lambda', 'fields': ['id', 'label']}
    assert records and not any(r['exact'] for r in records)
    assert all(s['filtered'] for r in records for s in r['segments'])


# -- the loader over uneven chunks -----------------------------------------------------

def _torch_batches(url, batch, loader_kwargs=None, **reader_kwargs):
    with make_tensor_reader(url, **reader_kwargs) as reader:
        with TorchLoader(reader, batch, device='cpu', **(loader_kwargs or {})) as loader:
            return [{n: getattr(b, n).numpy().copy() for n in b._fields} for b in loader]


def _jax_batches(url, batch, loader_kwargs=None, **reader_kwargs):
    with jax_make_tensor_reader(url, **reader_kwargs) as reader:
        with JaxLoader(reader, batch, autotune=False, **(loader_kwargs or {})) as loader:
            return [{n: np.asarray(getattr(b, n)) for n in b._fields} for b in loader]


def _assert_batches_equal(ours, theirs):
    assert len(ours) == len(theirs) and ours
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b)
        for name in a:
            # The JAX loader narrows int64 to int32; the port keeps it.
            got = a[name].astype(b[name].dtype) if a[name].dtype == np.int64 else a[name]
            assert got.dtype == b[name].dtype, name
            np.testing.assert_array_equal(got, b[name], err_msg=name)


SELECTED = dict(schema_fields=['id', 'vec', 'image'], deterministic=True, seed=2,
                shuffle_rows_in_chunk=True, shuffle_row_drop_partitions=2, workers_count=3)


@pytest.mark.parametrize('last_batch', ['drop', 'partial', 'pad'])
@pytest.mark.parametrize('batch', [5, 8, 13])
def test_block_path_over_uneven_chunks_equals_jax(store, batch, last_batch):
    kwargs = dict(SELECTED, num_epochs=1)
    ours = _torch_batches(store, batch, dict(last_batch=last_batch),
                          predicate=_pred(in_lambda), **kwargs)
    theirs = _jax_batches(store, batch, dict(last_batch=last_batch),
                          predicate=_pred(jax_in_lambda), **kwargs)
    _assert_batches_equal(ours, theirs)
    n = len(_kept(store))
    assert sum(len(b['id']) for b in ours) == {'drop': n // batch * batch, 'partial': n,
                                               'pad': -(-n // batch) * batch}[last_batch]


@pytest.mark.parametrize('prefetch', [0, 2])
def test_superbatches_over_uneven_chunks(store, prefetch):
    """``superbatches(k)`` cuts k batches of a filtered, permuted stream into
    one tensor each: the batches of the plain iteration, concatenated."""
    kwargs = dict(SELECTED, num_epochs=2, predicate=_pred(in_lambda))
    plain = _torch_batches(store, BATCH, dict(prefetch=prefetch), **kwargs)
    with make_tensor_reader(store, **kwargs) as reader:
        with TorchLoader(reader, BATCH, device='cpu', prefetch=prefetch) as loader:
            groups = [{n: getattr(g, n).numpy().copy() for n in g._fields}
                      for g in loader.superbatches(3)]
    assert len(groups) == len(plain) // 3
    for j, group in enumerate(groups):
        for name, value in group.items():
            assert value.shape[0] == 3 * BATCH
            np.testing.assert_array_equal(
                value, np.concatenate([b[name] for b in plain[3 * j:3 * j + 3]]))


def test_staging_decode_of_permuted_raw_chunks(store):
    """The loader's advice holds: ``raw_image_fields`` with
    ``shuffle_rows_in_chunk`` (and a predicate) runs, and the staging step
    decodes the permuted encoded bytes to the pixels the workers decode."""
    kwargs = dict(SELECTED, num_epochs=1, predicate=_pred(in_lambda))
    raw = _torch_batches(store, BATCH, dict(on_device_augment=True),
                         raw_image_fields=['image'], **kwargs)
    decoded = _torch_batches(store, BATCH, **kwargs)
    _assert_batches_equal(raw, decoded)
    assert sum(len(b['id']) for b in raw) == len(_kept(store)) // BATCH * BATCH


def test_filtered_deterministic_loader_batches_equal_jax(store):
    kwargs = dict(SELECTED, num_epochs=2, predicate=None)
    ours = _torch_batches(store, BATCH, dict(last_batch='partial'),
                          **dict(kwargs, predicate=_pred(in_lambda)))
    theirs = _jax_batches(store, BATCH, dict(last_batch='partial'),
                          **dict(kwargs, predicate=_pred(jax_in_lambda)))
    _assert_batches_equal(ours, theirs)


# -- CompressedNdarrayCodec across packages --------------------------------------------

@pytest.fixture(scope='module', params=['port', 'jax'])
def compressed_store(request, tmp_path_factory):
    rng = np.random.default_rng(8)
    rows = [{'id': i, 'm': rng.normal(size=(3, 5)).astype(np.float64)} for i in range(23)]
    url = 'file://' + str(tmp_path_factory.mktemp('compressed') / request.param)
    if request.param == 'port':
        write_dataset(url, Unischema('C', [
            UnischemaField('id', np.int64, (), ScalarCodec(np.int64), False),
            UnischemaField('m', np.float64, (3, 5), CompressedNdarrayCodec(), False)]),
            rows, rows_per_row_group=7)
    else:
        jax_write_dataset(url, JaxUnischema('C', [
            JaxField('id', np.int64, (), JaxScalarCodec(np.int64), False),
            JaxField('m', np.float64, (3, 5), JaxCompressedNdarrayCodec(), False)]),
            rows, rows_per_row_group=7)
    return url, rows


@pytest.mark.parametrize('kind', ['tensor', 'row'])
def test_compressed_ndarray_store_reads_bit_equal_in_both_packages(compressed_store, kind):
    url, rows = compressed_store
    kwargs = dict(reader_pool_type='dummy', shuffle_row_groups=False)
    for factory in _factories(kind):
        with factory(url, **kwargs) as reader:
            got = [np.asarray(s.m) for s in reader]
        got = np.concatenate(got) if kind == 'tensor' else np.stack(got)
        assert got.dtype == np.float64
        assert got.tobytes() == np.stack([r['m'] for r in rows]).tobytes()


def test_compressed_ndarray_codec_json_and_cells_cross_decode():
    field = UnischemaField('m', np.float32, (2, 2), CompressedNdarrayCodec())
    jax_field = JaxField('m', np.float32, (2, 2), JaxCompressedNdarrayCodec())
    value = np.arange(4, dtype=np.float32).reshape(2, 2)
    assert CompressedNdarrayCodec().to_json() == JaxCompressedNdarrayCodec().to_json()
    np.testing.assert_array_equal(
        JaxCompressedNdarrayCodec().decode(jax_field, CompressedNdarrayCodec().encode(field,
                                                                                     value)),
        value)
    np.testing.assert_array_equal(
        CompressedNdarrayCodec().decode(field, JaxCompressedNdarrayCodec().encode(jax_field,
                                                                                 value)),
        value)
    with pytest.raises(ValueError, match='shape'):
        CompressedNdarrayCodec().encode(field, np.zeros((3,), np.float32))

