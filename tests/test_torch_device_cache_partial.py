"""The port's partial device cache (``DeviceDatasetCache(partial=True,
loader_factory=...)``) against the JAX package's on the CPU, as
``tests/test_device_cache.py:167-271`` holds the JAX one: it streams past
its budget, with ``shuffle=False`` its epochs equal the streamed pass and
the JAX partial cache's, the governor's degrade rung evicts the run JAX
evicts, the advisory rung pauses the fill, and an eviction in the middle of
an epoch leaves the epoch complete.

The store (a float32 vector and an int32 id, which neither loader narrows,
48 rows in 8-row groups, read by one worker) gives both packages the same
batches: 128 bytes a batch of 8, so the JAX test's budgets hold as they
are.
"""

import numpy as np
import pytest

from petastorm_tpu_torch import DeviceDatasetCache, TorchLoader, make_tensor_reader, membudget
from petastorm_tpu_torch.lineage import _digest_array
from petastorm_tpu_torch.membudget import (STATE_ADVISORY, STATE_DEGRADE, STATE_OK,
                                           GovernorConfig, MemoryGovernor)

pytestmark = pytest.mark.devicecache

N_ROWS, BATCH = 48, 8
N_BATCHES = N_ROWS // BATCH


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    from petastorm_tpu.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu.etl.writer import write_dataset
    from petastorm_tpu.unischema import Unischema, UnischemaField

    schema = Unischema('Cache', [
        UnischemaField('vec', np.float32, (3,), NdarrayCodec(), False),
        UnischemaField('sid', np.int32, (), ScalarCodec(np.int32), False),
    ])
    rng = np.random.default_rng(11)
    url = 'file://' + str(tmp_path_factory.mktemp('ds') / 'store')
    write_dataset(url, schema, ({'vec': rng.standard_normal(3).astype(np.float32),
                                 'sid': np.int32(i)} for i in range(N_ROWS)), rows_per_row_group=8)
    return url


def _factory(url):
    """The same deterministic pass the cache was filled from."""
    def stream():
        with make_tensor_reader(url, num_epochs=1, seed=0, workers_count=1) as reader:
            with TorchLoader(reader, BATCH, device='cpu') as loader:
                yield from loader
    return stream


def _jax_factory(url):
    def stream():
        from petastorm_tpu import make_tensor_reader as jax_make_tensor_reader
        from petastorm_tpu.jax_loader import JaxLoader
        with jax_make_tensor_reader(url, num_epochs=1, seed=0, reader_pool_type='thread',
                                    workers_count=1) as reader:
            with JaxLoader(reader, BATCH, last_batch='drop') as loader:
                yield from loader
    return stream


def _digests(batches):
    return [tuple(_digest_array(np.asarray(getattr(b, name))) for name in ('sid', 'vec'))
            for b in batches]


def _ids(batches):
    return [int(i) for b in batches for i in np.asarray(b.sid)]


class _Port(object):
    """A partial cache over a fresh one-worker reader and loader."""

    def __init__(self, url, **kwargs):
        kwargs.setdefault('loader_factory', _factory(url))
        self.reader = make_tensor_reader(url, num_epochs=1, seed=0, workers_count=1)
        self.loader = TorchLoader(self.reader, BATCH, device='cpu')
        self.cache = DeviceDatasetCache(self.loader, partial=True, **kwargs)

    def fill(self):
        with self.reader, self.loader:
            return _digests(self.cache.epoch(0))


def _jax_partial(url, epochs, evict_after=None, **kwargs):
    from petastorm_tpu import make_tensor_reader as jax_make_tensor_reader
    from petastorm_tpu.device_cache import DeviceDatasetCache as JaxCache
    from petastorm_tpu.jax_loader import JaxLoader
    reader = jax_make_tensor_reader(url, num_epochs=1, seed=0, reader_pool_type='thread',
                                    workers_count=1)
    loader = JaxLoader(reader, BATCH, last_batch='drop')
    cache = JaxCache(loader, partial=True, loader_factory=_jax_factory(url), **kwargs)
    with reader, loader:
        out = [_digests(cache.epoch(0))]
    for epoch in range(1, epochs):
        if epoch == evict_after:
            assert cache._evict_coldest()
        out.append(_digests(cache.epoch(epoch)))
    stats = cache.stats()
    cache.clear()
    return out, stats


@pytest.fixture
def governor(monkeypatch):
    monkeypatch.delenv(membudget.ENV_VAR, raising=False)
    gov = MemoryGovernor(budget=1_000_000, config=GovernorConfig())
    previous = membudget.set_governor(gov)
    gov._arm_count += 1      # armed; the test drives check()
    try:
        yield gov
    finally:
        while gov._arm_count > 0:
            gov.release()
        membudget.set_governor(previous)


def test_streams_past_the_budget_without_overflow(store):
    port = _Port(store, shuffle=False, max_bytes=300, superbatch_batches=2)
    e0 = port.fill()
    st = port.loader.stats['device_cache']
    assert st['partial'] and st['fill_stopped'] and st['materialized']
    assert st['cached_batches'] == 2 and st['total_batches'] == N_BATCHES
    assert 0 < st['nbytes'] <= 300
    e1 = list(port.cache.epoch(1))
    assert sorted(_ids(e1)) == sorted(range(N_ROWS)) and _digests(e1) == e0
    assert port.cache.stats()['hits'] == 2
    port.cache.clear()


def test_epochs_equal_the_streamed_pass_and_the_jax_partial_cache(store):
    reference = _digests(_factory(store)())
    theirs, their_stats = _jax_partial(store, 3, evict_after=2, shuffle=False, max_bytes=300,
                                       superbatch_batches=2)
    port = _Port(store, shuffle=False, max_bytes=300, superbatch_batches=2)
    ours = [port.fill(), _digests(port.cache.epoch(1))]
    assert port.cache._evict_coldest()
    assert port.cache.stats()['superbatches'] == 0
    ours.append(_digests(port.cache.epoch(2)))
    assert ours == theirs == [reference] * 3
    stats = port.cache.stats()
    for key in ('partial', 'cached_batches', 'total_batches', 'hits', 'evictions',
                'fill_paused', 'fill_stopped', 'superbatches'):
        assert stats[key] == their_stats[key], key
    port.cache.clear()


def test_governor_degrade_evicts_the_run_jax_evicts(store, governor):
    port = _Port(store, shuffle=False, max_bytes=10 ** 9, superbatch_batches=2)
    port.fill()
    e1 = list(port.cache.epoch(1))     # hits the runs in start order
    assert port.cache.stats()['superbatches'] == 3
    ballast = governor.register_pool('ballast', lambda: 860_000)
    assert governor.check() == STATE_DEGRADE
    st = port.cache.stats()
    assert st['evictions'] == 1 and st['superbatches'] == 2
    ours = sorted(sb.start for sb in port.cache._superbatches)
    assert ours == [2, 4]
    e2 = list(port.cache.epoch(2))
    assert sorted(_ids(e2)) == sorted(_ids(e1))
    ballast.close()
    port.cache.clear()

    from petastorm_tpu import membudget as jax_membudget
    jax_gov = jax_membudget.MemoryGovernor(budget=1_000_000)
    previous = jax_membudget.set_governor(jax_gov)
    jax_gov._arm_count += 1
    try:
        from petastorm_tpu import make_tensor_reader as jax_make_tensor_reader
        from petastorm_tpu.device_cache import DeviceDatasetCache as JaxCache
        from petastorm_tpu.jax_loader import JaxLoader
        reader = jax_make_tensor_reader(store, num_epochs=1, seed=0, reader_pool_type='thread',
                                        workers_count=1)
        loader = JaxLoader(reader, BATCH, last_batch='drop')
        cache = JaxCache(loader, shuffle=False, partial=True, max_bytes=10 ** 9,
                         superbatch_batches=2, loader_factory=_jax_factory(store))
        with reader, loader:
            list(cache.epoch(0))
        list(cache.epoch(1))
        jax_ballast = jax_gov.register_pool('ballast', lambda: 860_000)
        assert jax_gov.check() == STATE_DEGRADE
        assert sorted(sb.start for sb in cache._superbatches) == ours
        jax_ballast.close()
        cache.clear()
    finally:
        while jax_gov._arm_count > 0:
            jax_gov.release()
        jax_membudget.set_governor(previous)


def test_governor_advisory_pauses_the_fill_and_relief_resumes(store, governor):
    ballast = governor.register_pool('ballast', lambda: 750_000)
    assert governor.check() == STATE_ADVISORY
    port = _Port(store, shuffle=False, max_bytes=10 ** 9, superbatch_batches=2)
    assert port.cache.stats()['fill_paused']     # joined the episode at registration
    e0 = port.fill()
    st = port.cache.stats()
    assert st['materialized'] and st['cached_batches'] == 0
    assert st['nbytes'] == 0 and not st['fill_stopped']
    ballast.close()
    assert governor.check() == STATE_OK
    assert not port.cache.stats()['fill_paused']
    assert _digests(port.cache.epoch(1)) == e0
    port.cache.clear()


def test_full_mode_registers_accounting_only(store, governor):
    reader = make_tensor_reader(store, num_epochs=1, seed=0, workers_count=1)
    loader = TorchLoader(reader, BATCH, device='cpu')
    cache = DeviceDatasetCache(loader, shuffle=False, superbatch_batches=2)
    with reader, loader:
        list(cache.epoch(0))
    handle = [h for h in governor._pools if h.name == 'device-cache'][0]
    assert handle.degrade_fn is None and handle.advisory_fn is None
    governor.check()
    assert governor.probe()['pools']['device-cache'] == cache.nbytes == N_BATCHES * 128
    cache.clear()
    assert 'device-cache' not in {h.name for h in governor._pools}


def test_eviction_mid_epoch_keeps_the_epoch_complete(store):
    reference = _digests(_factory(store)())
    # 600 bytes: the runs at 0 and 2 stay resident, the one at 4 streams.
    port = _Port(store, shuffle=False, max_bytes=600, superbatch_batches=2)
    port.fill()
    assert sorted(sb.start for sb in port.cache._superbatches) == [0, 2]
    got = []
    for i, batch in enumerate(port.cache.epoch(1)):
        got.append(batch)
        if i == 1:
            # The run at 2 is the coldest now: its batches stream instead.
            assert port.cache._evict_coldest()
            assert [sb.start for sb in port.cache._superbatches] == [0]
    assert _digests(got) == reference
    stats = port.cache.stats()
    assert stats['evictions'] == 1 and stats['hits'] == 2
    port.cache.clear()


def test_shuffled_partial_epochs_keep_each_runs_draw_across_an_eviction(store):
    port = _Port(store, shuffle=True, seed=5, max_bytes=600, superbatch_batches=2)
    port.fill()
    before = list(port.cache.epoch(3))
    assert sorted(_ids(before)) == list(range(N_ROWS))
    assert port.cache._evict_coldest()       # the run at 0, hit first
    assert [sb.start for sb in port.cache._superbatches] == [2]
    after = list(port.cache.epoch(3))
    assert sorted(_ids(after)) == list(range(N_ROWS))
    streamed = _digests(_factory(store)())
    for index, (a, b) in enumerate(zip(_digests(before), _digests(after))):
        if index in (2, 3):
            assert b == a                    # the resident run's draw is unchanged
        else:
            assert b == streamed[index]      # streamed in source order
    assert _digests(before)[:2] != streamed[:2]
    port.cache.clear()


def test_a_dropped_cache_leaves_the_governor(store, governor):
    """The pool holds the cache weakly: a cache dropped without ``clear()``
    is collected (its device memory with it) and its pool unregistered."""
    import gc
    import weakref
    port = _Port(store, shuffle=False, max_bytes=10 ** 9, superbatch_batches=2)
    port.fill()
    assert 'device-cache' in {h.name for h in governor._pools}
    gone = weakref.ref(port.cache)
    del port
    gc.collect()
    assert gone() is None
    assert 'device-cache' not in {h.name for h in governor._pools}
