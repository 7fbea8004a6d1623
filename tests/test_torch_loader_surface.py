"""The loader's surface against the JAX package's on the CPU: the shape
policies, ``iter_numpy_batches`` (per-row and block paths; ``last_batch``
drop/pad/partial; the shuffling buffer), and ``TorchLoader`` against
``JaxLoader`` with ``prefetch=0``, ``inflight``, ``arena_depth`` and
``echo`` (also under ``superbatches``).

Batches are compared by the JAX package's lineage digest (CRC32 of each
field's bytes, ``lineage._digest_array``), so they must be bit-identical.
The store is PNG (lossless: both decoders give the same pixels) and its
fields have types that neither package narrows.
"""

import numpy as np
import pytest
import torch

from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu import make_tensor_reader as jax_make_tensor_reader
from petastorm_tpu.jax_loader import CropTo as JaxCropTo, JaxLoader, PadTo as JaxPadTo
from petastorm_tpu.jax_loader import iter_numpy_batches as jax_iter_numpy_batches
from petastorm_tpu.lineage import _digest_array
from petastorm_tpu.shuffling_buffer import NoopShufflingBuffer as JaxNoopBuffer
from petastorm_tpu.shuffling_buffer import RandomShufflingBuffer as JaxShufflingBuffer
from petastorm_tpu_torch import (CompressedImageCodec, CropTo, NdarrayCodec, PadTo, ScalarCodec,
                                 TorchLoader, Unischema, UnischemaField, make_reader,
                                 make_tensor_reader, make_torch_loader, write_dataset)
from petastorm_tpu_torch.loader import iter_numpy_batches
from petastorm_tpu_torch.shuffling_buffer import (NoopShufflingBuffer, RandomShufflingBuffer,
                                                  build_shuffling_buffer)

ROWS, PER_GROUP, BATCH = 45, 10, 8     # 5 full batches, 5 rows left over


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    schema = Unischema('SurfaceSchema', [
        UnischemaField('id', np.int32, (), ScalarCodec(np.int32)),
        UnischemaField('vec', np.float32, (3,), NdarrayCodec()),
        UnischemaField('image', np.uint8, (12, 10, 3), CompressedImageCodec('png')),
        UnischemaField('ragged', np.uint8, (None, None), CompressedImageCodec('png')),
        UnischemaField('name', np.str_, (), ScalarCodec(np.str_)),
    ])
    rng = np.random.default_rng(8)
    url = 'file://' + str(tmp_path_factory.mktemp('surface') / 'store')
    write_dataset(url, schema, ({
        'id': i, 'vec': rng.normal(size=3).astype(np.float32),
        'image': rng.integers(0, 256, (12, 10, 3), dtype=np.uint8),
        'ragged': rng.integers(0, 256, tuple(rng.integers(4, 9, 2)), dtype=np.uint8),
        'name': 'n{}'.format(i)} for i in range(ROWS)), rows_per_row_group=PER_GROUP)
    return url


ROW_FIELDS = ['id', 'vec', 'image', 'ragged']
BLOCK_FIELDS = ['id', 'vec', 'image']


def _digests(batches):
    return [{name: (np.asarray(value).shape, np.asarray(value).dtype.str,
                    _digest_array(np.asarray(value)))
             for name, value in dict(batch).items()} for batch in batches]


def _readers(kind, url, port, **kwargs):
    kwargs.setdefault('workers_count', 1)
    kwargs.setdefault('shuffle_row_groups', False)
    if kind == 'row':
        factory = make_reader if port else jax_make_reader
        kwargs.setdefault('schema_fields', ROW_FIELDS)
    else:
        factory = make_tensor_reader if port else jax_make_tensor_reader
        kwargs.setdefault('schema_fields', BLOCK_FIELDS)
    return factory(url, reader_pool_type='thread', **kwargs)


# -- shape policies ----------------------------------------------------------

@pytest.mark.parametrize('shape', [(6, 4), (6, 9), (9, 9), (3, 2, 2)])
def test_pad_and_crop_equal_jax(shape):
    x = np.arange(int(np.prod(shape)), dtype=np.int16).reshape(shape)
    target = (6, 6) if len(shape) == 2 else (4, 2, 1)
    np.testing.assert_array_equal(PadTo(target, 7).apply(x), JaxPadTo(target, 7).apply(x))
    if all(a >= t for a, t in zip(shape, target)):
        got = CropTo(target).apply(x)
        np.testing.assert_array_equal(got, JaxCropTo(target).apply(x))
        assert got.shape == target
    else:
        with pytest.raises(ValueError, match='too small'):
            CropTo(target).apply(x)
        with pytest.raises(ValueError, match='too small'):
            JaxCropTo(target).apply(x)


# -- iter_numpy_batches --------------------------------------------------------

POLICIES = {'row': ({'ragged': PadTo((6, 7), 3)}, {'ragged': JaxPadTo((6, 7), 3)}),
            'block': ({'image': CropTo((8, 8, 3))}, {'image': JaxCropTo((8, 8, 3))})}


@pytest.mark.parametrize('kind', ['row', 'block'])
@pytest.mark.parametrize('options', [dict(last_batch='drop'), dict(last_batch='pad'),
                                     dict(last_batch='partial'),
                                     dict(shuffling_queue_capacity=50, seed=3,
                                          last_batch='partial')])
def test_iter_numpy_batches_equal_jax(store, kind, options):
    ours_policy, jax_policy = POLICIES[kind]
    with _readers(kind, store, True) as reader:
        ours = list(iter_numpy_batches(reader, BATCH, shape_policies=ours_policy, **options))
    with _readers(kind, store, False) as reader:
        theirs = list(jax_iter_numpy_batches(reader, BATCH, shape_policies=jax_policy,
                                             **options))
    assert _digests(ours) == _digests(theirs)
    full = ROWS // BATCH + (options['last_batch'] != 'drop')
    assert len(ours) == full
    if options['last_batch'] == 'pad':
        tail = ours[-1]
        assert all(len(v) == BATCH for v in tail.values())
        np.testing.assert_array_equal(tail['id'][ROWS % BATCH:], tail['id'][ROWS % BATCH - 1])
    ids = np.concatenate([b['id'] for b in ours])
    if 'seed' in options:
        assert sorted(ids) == list(range(ROWS)) and list(ids) != list(range(ROWS))


def test_unbatchable_fields_drop_or_raise_like_jax(store):
    with pytest.warns(UserWarning, match='name'):
        with _readers('row', store, True, schema_fields=['id', 'name']) as reader:
            batches = list(iter_numpy_batches(reader, BATCH))
    assert sorted(batches[0]) == ['id']
    for port, iterate in ((True, iter_numpy_batches), (False, jax_iter_numpy_batches)):
        with _readers('row', store, port, schema_fields=['id', 'name']) as reader:
            with pytest.raises(ValueError, match='name'):
                list(iterate(reader, BATCH, strict_fields=True))
    with _readers('row', store, True, schema_fields=['ragged']) as reader:
        with pytest.raises(ValueError, match='ragged shapes'):
            list(iter_numpy_batches(reader, BATCH))
    with pytest.raises(ValueError, match='last_batch'):
        next(iter_numpy_batches(iter(()), BATCH, last_batch='keep'))


def test_shuffling_buffer_draws_like_jax():
    ours, theirs = RandomShufflingBuffer(20, 5, seed=11), JaxShufflingBuffer(20, 5, seed=11)
    got, want = [], []
    for start in range(0, 60, 6):
        for buf, out in ((ours, got), (theirs, want)):
            buf.add_many(list(range(start, start + 6)))
            while buf.can_retrieve():
                out.append(buf.retrieve())
    for buf, out in ((ours, got), (theirs, want)):
        buf.finish()
        while buf.can_retrieve():
            out.append(buf.retrieve())
    assert got == want and sorted(got) == list(range(60)) and got != sorted(got)
    assert build_shuffling_buffer(50, None, 1)._min_after_retrieve == 40
    with pytest.raises(ValueError, match='min_after_retrieve'):
        RandomShufflingBuffer(5, 5)
    fifo = []
    for buf in (NoopShufflingBuffer(), JaxNoopBuffer()):
        buf.add_many([3, 1, 2])
        buf.finish()
        fifo.append([buf.retrieve() for _ in range(buf.size)] + [buf.can_add()])
    assert fifo[0] == fifo[1] == [3, 1, 2, False]


# -- TorchLoader against JaxLoader ----------------------------------------------

def _port_loader_batches(kind, url, superbatch=0, **options):
    with _readers(kind, url, True) as reader:
        with make_torch_loader(reader, BATCH, device='cpu', **options) as loader:
            it = loader.superbatches(superbatch) if superbatch else loader
            batches = [{k: v.numpy().copy() for k, v in b._asdict().items()} for b in it]
            stats = loader.stats
    return batches, stats


def _jax_loader_batches(kind, url, superbatch=0, **options):
    with _readers(kind, url, False) as reader:
        with JaxLoader(reader, BATCH, **options) as loader:
            it = loader.superbatches(superbatch) if superbatch else loader
            return [{k: np.asarray(v) for k, v in b._asdict().items()} for b in it]


LOADER_OPTIONS = [dict(prefetch=0), dict(prefetch=2, inflight=1), dict(prefetch=2, inflight=4),
                  dict(prefetch=1, arena_depth=3), dict(prefetch=2, echo=2),
                  dict(prefetch=0, echo=2, last_batch='pad')]


@pytest.mark.parametrize('kind', ['row', 'block'])
@pytest.mark.parametrize('options', LOADER_OPTIONS)
def test_torch_loader_equals_jax_loader(store, kind, options):
    policies = {'row': {'ragged': (PadTo((6, 7), 3), JaxPadTo((6, 7), 3))}, 'block': {}}[kind]
    ours, stats = _port_loader_batches(
        kind, store, shape_policies={k: v[0] for k, v in policies.items()}, **options)
    theirs = _jax_loader_batches(kind, store,
                                 shape_policies={k: v[1] for k, v in policies.items()}, **options)
    assert _digests(ours) == _digests(theirs)
    echo = options.get('echo', 1)
    fresh = ROWS // BATCH + (options.get('last_batch') == 'pad')
    assert len(ours) == stats['batches'] == echo * fresh
    assert stats['rows'] == (ROWS if options.get('last_batch') == 'pad' else fresh * BATCH)
    if echo > 1:
        for i in range(0, len(ours), echo):
            assert _digests(ours[i:i + echo - 1]) == _digests(ours[i + 1:i + echo])


@pytest.mark.parametrize('prefetch', [0, 2])
def test_echo_with_superbatches_equals_jax(store, prefetch):
    ours, stats = _port_loader_batches('block', store, superbatch=3, prefetch=prefetch, echo=2)
    theirs = _jax_loader_batches('block', store, superbatch=3, prefetch=prefetch, echo=2)
    assert _digests(ours) == _digests(theirs)
    assert len(ours) == (2 * (ROWS // BATCH)) // 3 and len(ours[0]['id']) == 3 * BATCH
    first = ours[0]['id']
    np.testing.assert_array_equal(first[:BATCH], first[BATCH:2 * BATCH])   # a batch and its echo
    # Every delivery counts, the dropped tail group's too; each source row once.
    assert stats['batches'] == 2 * (ROWS // BATCH) and stats['rows'] == (ROWS // BATCH) * BATCH


def test_reset_stats_and_staging_counters(store):
    with _readers('block', store, True, num_epochs=None) as reader:
        with TorchLoader(reader, BATCH, device='cpu', prefetch=2) as loader:
            for _ in range(6):
                next(loader)
            loader.reset_stats()
            zero = loader.stats
            for _ in range(4):
                next(loader)
            stats = loader.stats
    assert zero['batches'] == zero['rows'] == 0 and zero['wait_s'] == 0.0
    assert stats['batches'] == 4 and stats['rows'] == 4 * BATCH
    for key in ('assemble_s', 'dispatch_s', 'overlap_s', 'overlap_frac', 'ready_wait_s',
                'arena_reuse', 'arena_alloc', 'arena_wait_s', 'stage_dispatch_s', 'wait_s',
                'input_stall_frac', 'reader_wait_s', 'worker_stage_timings'):
        assert key in stats, key
    assert 0.0 <= stats['overlap_frac'] <= 1.0 and stats['worker_stage_timings']['chunks'] > 0


def test_loader_refuses_bad_options(store):
    for kwargs, match in ((dict(echo=0), 'echo'), (dict(inflight=0), 'inflight'),
                          (dict(last_batch='keep'), 'last_batch')):
        with pytest.raises(ValueError, match=match):
            TorchLoader(iter(()), BATCH, device='cpu', **kwargs)


def test_prefetch_zero_starts_no_thread(store):
    import threading
    before = {t.name for t in threading.enumerate()}
    with _readers('row', store, True, schema_fields=['id']) as reader:
        with TorchLoader(reader, BATCH, device='cpu', prefetch=0) as loader:
            first = next(loader)
            started = {t.name for t in threading.enumerate()} - before
    assert not any(name.startswith('pstt-staging-') for name in started)
    assert first.id.dtype == torch.int32 and len(first.id) == BATCH
