"""The port's device-resident dataset tier (``DeviceDatasetCache``, full
mode) held against the streamed batches and the JAX package's cache, on
the CPU device (the gather and the permutations run wherever the batches
lie).

Batches are compared by per-field CRC32 (``lineage._digest_array``); the
store has a float32 vector and an int32 id (the JAX loader does not narrow
int32), 48 rows in 8-row groups, read with one worker so that both
packages stream the same order.
"""

from collections import namedtuple

import numpy as np
import pytest
import torch

from petastorm_tpu import make_tensor_reader as jax_make_tensor_reader
from petastorm_tpu.codecs import NdarrayCodec as JaxNdarrayCodec
from petastorm_tpu.codecs import ScalarCodec as JaxScalarCodec
from petastorm_tpu.device_cache import DeviceDatasetCache as JaxDeviceDatasetCache
from petastorm_tpu.etl.writer import write_dataset as jax_write_dataset
from petastorm_tpu.jax_loader import JaxLoader
from petastorm_tpu.lineage import _digest_array
from petastorm_tpu.unischema import Unischema as JaxUnischema, UnischemaField as JaxField
from petastorm_tpu_torch import (DeviceCacheOverflow, DeviceDatasetCache, TorchLoader,
                                 make_tensor_reader)

N_ROWS, BATCH = 48, 4


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    schema = JaxUnischema('Cache', [
        JaxField('vec', np.float32, (3,), JaxNdarrayCodec(), False),
        JaxField('sid', np.int32, (), JaxScalarCodec(np.int32), False),
    ])
    rng = np.random.default_rng(11)
    url = 'file://' + str(tmp_path_factory.mktemp('ds') / 'store')
    jax_write_dataset(url, schema, ({'vec': rng.standard_normal(3).astype(np.float32),
                                     'sid': np.int32(i)} for i in range(N_ROWS)),
                      rows_per_row_group=8)
    return url


def _digests(batches):
    return [tuple(_digest_array(np.asarray(getattr(b, name))) for name in ('sid', 'vec'))
            for b in batches]


def _ids(batches):
    return [int(i) for b in batches for i in np.asarray(b.sid)]


def _port_cache(url, **kwargs):
    """A filled cache, and epoch 0 as it streamed."""
    with make_tensor_reader(url, workers_count=1, num_epochs=1, seed=0) as reader:
        with TorchLoader(reader, BATCH, device='cpu', prefetch=2) as loader:
            cache = DeviceDatasetCache(loader, **kwargs)
            first = [type(b)(*(t.clone() for t in b)) for b in cache.epoch(0)]
    return cache, first


def test_epoch_zero_is_the_streamed_pass(store):
    with make_tensor_reader(store, workers_count=1, num_epochs=1, seed=0) as reader:
        with TorchLoader(reader, BATCH, device='cpu', prefetch=2) as loader:
            streamed = [type(b)(*(t.clone() for t in b)) for b in loader]
    cache, first = _port_cache(store, shuffle=True, seed=3, superbatch_batches=5)
    assert _digests(first) == _digests(streamed)
    stats = cache.stats()
    assert stats['materialized'] and stats['total_batches'] == stats['cached_batches'] == 12
    assert stats['superbatches'] == 3                          # 5 + 5 + 2 batches
    assert cache.nbytes == N_ROWS * (3 * 4 + 4)


def test_no_shuffle_epochs_equal_the_jax_cache(store):
    with jax_make_tensor_reader(store, reader_pool_type='thread', workers_count=1, num_epochs=1,
                                seed=0) as reader:
        with JaxLoader(reader, BATCH, last_batch='drop') as loader:
            jax_cache = JaxDeviceDatasetCache(loader, shuffle=False, superbatch_batches=5)
            want = _digests(list(jax_cache.epoch(0)))
    cache, first = _port_cache(store, shuffle=False, superbatch_batches=5)
    assert _digests(first) == want
    for epoch in (1, 2):
        assert _digests(list(cache.epoch(epoch))) == want == _digests(list(jax_cache.epoch(epoch)))


def test_shuffled_epochs_are_permutations_and_reproducible(store):
    cache, first = _port_cache(store, shuffle=True, seed=7, superbatch_batches=3)
    by_id = {int(i): v for b in first for i, v in zip(b.sid, b.vec)}
    epochs = [list(cache.epoch(e)) for e in (1, 2, 3)]
    previous = _ids(first)
    for batches in epochs:
        ids = _ids(batches)
        assert sorted(ids) == list(range(N_ROWS)) and ids != previous
        previous = ids
        for b in batches:
            assert tuple(b.vec.shape) == (BATCH, 3) and b.sid.dtype == torch.int32
            for i, v in zip(b.sid, b.vec):                     # rows keep their fields
                assert torch.equal(v, by_id[int(i)])
    assert _ids(cache.epoch(2)) == _ids(epochs[1])             # one seed, one stream
    again, _ = _port_cache(store, shuffle=True, seed=7, superbatch_batches=3)
    assert _ids(again.epoch(2)) == _ids(epochs[1])
    other, _ = _port_cache(store, shuffle=True, seed=8, superbatch_batches=3)
    assert _ids(other.epoch(2)) != _ids(epochs[1])
    assert cache.stats()['hits'] == 4 * 12


def test_cached_batches_are_not_views_of_the_cache(store):
    for shuffle in (False, True):
        cache, _ = _port_cache(store, shuffle=shuffle)
        want = _digests(list(cache.epoch(1)))
        for b in cache.epoch(1):
            b.vec.fill_(0)
        assert _digests(list(cache.epoch(1))) == want


def test_overflow_raises_and_epoch_raises_it_again(store):
    with make_tensor_reader(store, workers_count=1, num_epochs=1) as reader:
        with TorchLoader(reader, BATCH, device='cpu') as loader:
            cache = DeviceDatasetCache(loader, max_bytes=3 * BATCH * 16)
            with pytest.raises(DeviceCacheOverflow, match='budget'):
                list(cache.epoch(0))
    assert cache.nbytes == 0 and not cache.materialized
    with pytest.raises(DeviceCacheOverflow, match='previously overflowed'):
        cache.epoch(1)


def test_abandoned_fill_clear_and_ragged_batches_raise(store):
    with make_tensor_reader(store, workers_count=1, num_epochs=1) as reader:
        with TorchLoader(reader, BATCH, device='cpu') as loader:
            cache = DeviceDatasetCache(loader)
            it = cache.epoch(0)
            next(it)
            with pytest.raises(RuntimeError, match='abandoned mid-stream'):
                cache.epoch(1)
    cache.clear()
    with pytest.raises(RuntimeError, match='cleared'):
        cache.epoch(1)
    Batch = namedtuple('Batch', ['x'])
    ragged = DeviceDatasetCache([Batch(torch.zeros(4)), Batch(torch.zeros(3))])
    with pytest.raises(ValueError, match='equal-size'):
        list(ragged.epoch(0))
    with pytest.raises(ValueError, match='no batches'):
        list(DeviceDatasetCache([]).epoch(0))
