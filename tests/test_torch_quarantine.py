"""Poison row-group quarantine under ``error_budget``, against the JAX
package. For ``make_reader``, ``make_tensor_reader`` and
``make_batch_reader`` under the same fault spec (the JAX side under its own
variable, the port under ``PSTT_FAULTS``), both packages quarantine the same
row-groups, deliver digest-equal batches (in order when deterministic, as
multisets otherwise), count a budget across epochs alike, raise at the same
item when it runs out and refuse the same ambiguous budgets. Also the
``store-read-corrupt`` and ``mem-pressure`` sites, the resequencer's
``mark_satisfied``, the pools' timeout message, and the phase-23 cell of
``chip_smoke.py`` on the CPU at a small size."""

import threading
import time

import numpy as np
import pytest

from petastorm_tpu import faults as jax_faults
from petastorm_tpu import make_batch_reader as jax_make_batch_reader
from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu import make_tensor_reader as jax_make_tensor_reader
from petastorm_tpu.errors import RowGroupQuarantinedError as JaxQuarantinedError
from petastorm_tpu.lineage import _digest_array as jax_digest
from petastorm_tpu_torch import (CompressedImageCodec, NdarrayCodec, ScalarCodec, Unischema,
                                 UnischemaField, faults, make_batch_reader, make_reader,
                                 make_tensor_reader, metrics, write_dataset)
from petastorm_tpu_torch.errors import RowGroupQuarantinedError
from petastorm_tpu_torch.lineage import _digest_array

ROWS, PER_GROUP = 64, 8
FACTORIES = {'tensor': (make_tensor_reader, jax_make_tensor_reader),
             'rows': (make_reader, jax_make_reader),
             'batch': (make_batch_reader, jax_make_batch_reader)}


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    schema = Unischema('QuarantineSchema', [
        UnischemaField('id', np.int32, (), ScalarCodec(np.int32)),
        UnischemaField('image', np.uint8, (8, 8, 3), CompressedImageCodec('png')),
        UnischemaField('vec', np.float32, (3,), NdarrayCodec()),
    ])
    rng = np.random.default_rng(0)
    url = 'file://' + str(tmp_path_factory.mktemp('quarantine') / 'store')
    write_dataset(url, schema, ({'id': i, 'image': rng.integers(0, 256, (8, 8, 3), np.uint8),
                                 'vec': rng.normal(size=3).astype(np.float32)}
                                for i in range(ROWS)), rows_per_row_group=PER_GROUP)
    return url


def _keys(url):
    from petastorm_tpu_torch.storage import ParquetStore
    return [faults.rowgroup_fault_key(p.path, p.row_group) for p in ParquetStore(url).row_groups()]


def _seed_for(site, keys, p, avoid=()):
    from petastorm_tpu_torch.bench import pick_fault_seed
    return pick_fault_seed(site, keys, p, avoid)


@pytest.fixture(scope='module')
def spec(store):
    """One row-group poisoned at decode, another failing its read."""
    keys = _keys(store)
    seed_a, key_a = _seed_for('decode-corrupt', keys, 0.125)
    seed_b, key_b = _seed_for('fs-read-error', keys, 0.125, avoid=(key_a,))
    return ('decode-corrupt:p=0.125:seed={};fs-read-error:p=0.125:seed={}'.format(
        seed_a, seed_b), sorted([key_a, key_b]))


def _set_spec(monkeypatch, text):
    monkeypatch.setenv(faults.ENV_VAR, text)
    monkeypatch.setenv(jax_faults.ENV_VAR, text)


def _summary(records):
    return sorted((r.get('piece_index'), r.get('row_group'), r.get('occurrences'),
                   r.get('error'), r.get('decode_error')) for r in records)


def _drain(reader, digest):
    """Every item's per-field digests, in delivery order."""
    return [{name: digest(np.asarray(getattr(item, name))) for name in item._fields}
            for item in reader]


def _run(factory, url, digest, **kwargs):
    with factory(url, **kwargs) as reader:
        items = _drain(reader, digest)
        diag = reader.diagnostics()
    return items, diag['quarantined_rowgroups'], diag['error_budget']


@pytest.mark.parametrize('kind', sorted(FACTORIES))
@pytest.mark.parametrize('pool', ['dummy', 'thread'])
def test_deterministic_readers_quarantine_alike(store, spec, monkeypatch, kind, pool):
    _set_spec(monkeypatch, spec[0])
    kwargs = dict(reader_pool_type=pool, workers_count=3, deterministic=True, seed=5,
                  num_epochs=3, error_budget=2)
    ours = _run(FACTORIES[kind][0], store, _digest_array, **kwargs)
    theirs = _run(FACTORIES[kind][1], store, jax_digest, **kwargs)
    assert ours[0] == theirs[0]
    assert _summary(ours[1]) == _summary(theirs[1])
    assert sorted(faults.rowgroup_fault_key(r['path'], r['row_group']) for r in ours[1]) == spec[1]
    assert [r['occurrences'] for r in ours[1]] == [3, 3]
    assert ours[2] == theirs[2] == 2
    per_item = PER_GROUP if kind != 'rows' else 1
    assert sum(1 for _ in ours[0]) * per_item == 3 * (ROWS - 2 * PER_GROUP)


@pytest.mark.parametrize('kind', sorted(FACTORIES))
def test_shuffled_readers_quarantine_alike_as_multisets(store, spec, monkeypatch, kind):
    _set_spec(monkeypatch, spec[0])
    kwargs = dict(reader_pool_type='thread', workers_count=4, seed=1, num_epochs=2,
                  error_budget=0.5)
    ours = _run(FACTORIES[kind][0], store, _digest_array, **kwargs)
    theirs = _run(FACTORIES[kind][1], store, jax_digest, **kwargs)

    def multiset(items):
        return sorted(tuple(sorted(d.items())) for d in items)

    assert multiset(ours[0]) == multiset(theirs[0])
    assert sorted((r['row_group'], r['occurrences']) for r in ours[1]) == \
        sorted((r['row_group'], r['occurrences']) for r in theirs[1])
    assert ours[2] == theirs[2] == 4      # half of 8 items


@pytest.mark.parametrize('kind', sorted(FACTORIES))
def test_budget_runs_out_at_the_same_item(store, spec, monkeypatch, kind):
    _set_spec(monkeypatch, spec[0])
    outcomes = []
    for factory, error, digest in ((FACTORIES[kind][0], RowGroupQuarantinedError,
                                    _digest_array),
                                   (FACTORIES[kind][1], JaxQuarantinedError, jax_digest)):
        delivered = []
        with pytest.raises(error) as info:
            with factory(store, reader_pool_type='dummy', deterministic=True, seed=2,
                         num_epochs=1, error_budget=1) as reader:
                for item in reader:
                    delivered.append(digest(np.asarray(item.id)))
        outcomes.append((delivered, _summary(info.value.quarantined),
                         str(info.value).split(' Latest')[0]))
    assert outcomes[0] == outcomes[1]
    assert len(outcomes[0][1]) == 2


@pytest.mark.parametrize('budget', [True, False, 1.0, 1.5, -1, 'two', 0.0])
def test_ambiguous_budgets_are_refused_alike(store, budget):
    for factory in (make_tensor_reader, jax_make_tensor_reader):
        with pytest.raises(ValueError, match='error_budget'):
            factory(store, reader_pool_type='dummy', error_budget=budget)


def test_no_budget_raises_the_failure(store, spec, monkeypatch):
    _set_spec(monkeypatch, spec[0])
    for factory in (make_tensor_reader, jax_make_tensor_reader):
        with pytest.raises((IOError, Exception)) as info:
            with factory(store, reader_pool_type='dummy', shuffle_row_groups=False) as reader:
                for _ in reader:
                    pass
        assert 'injected fault' in str(info.value)
    with make_tensor_reader(store, reader_pool_type='dummy') as reader:
        assert reader.diagnostics()['error_budget'] is None
        assert reader.diagnostics['quarantined_rowgroups'] == []


def test_a_malformed_spec_fails_before_any_thread(store, monkeypatch):
    monkeypatch.setenv(faults.ENV_VAR, 'decode-corrupt:match=part:1')
    before = {t.name for t in threading.enumerate()}
    with pytest.raises(ValueError, match='bad fault param'):
        make_tensor_reader(store, workers_count=2)
    assert {t.name for t in threading.enumerate() if t.name.startswith('pstt-')} <= before


def test_decode_corrupt_batch_carries_the_native_error(store, monkeypatch):
    from petastorm_tpu_torch.codecs import _native_image
    if _native_image() is None:
        pytest.skip('the native image codec does not build here')
    keys = _keys(store)
    seed, key = _seed_for('decode-corrupt-batch', keys, 0.125)
    _set_spec(monkeypatch, 'decode-corrupt-batch:p=0.125:seed={}'.format(seed))
    out = []
    for factory in (make_tensor_reader, jax_make_tensor_reader):
        items, records, _ = _run(factory, store, np.asarray, reader_pool_type='dummy',
                                 shuffle_row_groups=False, error_budget=1)
        out.append(([r['decode_error'] for r in records], [r['row_group'] for r in records],
                    sum(len(i['id']) for i in items)))
    assert out[0] == out[1]
    assert out[0][0] == ['not a JPEG or PNG stream'] and out[0][2] == ROWS - PER_GROUP
    assert keys[out[0][1][0]] == key


def test_quarantine_counter_counts_distinct_items(store, spec, monkeypatch):
    _set_spec(monkeypatch, spec[0])
    counts = []
    for mod, factory in ((metrics, make_tensor_reader), (None, jax_make_tensor_reader)):
        if mod is None:
            from petastorm_tpu import metrics as mod
        previous = mod.set_registry(mod.MetricsRegistry())
        try:
            with factory(store, reader_pool_type='thread', workers_count=2, num_epochs=4,
                         error_budget=2) as reader:
                for _ in reader:
                    pass
            counts.append(mod.get_registry().collect()[
                'pst_rowgroups_quarantined_total']['samples'][0]['value'])
        finally:
            mod.set_registry(previous)
    assert counts == [2, 2]


def test_resequencer_fills_a_quarantined_hole():
    from petastorm_tpu_torch.determinism import Resequencer
    from petastorm_tpu_torch.workers import EmptyResultError

    class Pool(object):
        def __init__(self, chunks, on_pull=None):
            self.chunks, self.on_pull = list(chunks), on_pull

        def get_results(self):
            if self.on_pull:
                self.on_pull(len(self.chunks))
            if not self.chunks:
                raise EmptyResultError()
            return self.chunks.pop(0)

    def chunk(seq):
        return {'det': {'seq': seq}, 'v': seq}

    reseq = Resequencer(end_grace_s=0.2)
    reseq.mark_satisfied(1)
    reseq.mark_satisfied(4)
    pool = Pool([chunk(3), chunk(2), chunk(0), chunk(5)])
    got = [reseq.next_chunk(pool)['v'] for _ in range(4)]
    assert got == [0, 2, 3, 5]
    assert reseq.stats()['expected_seq'] == 6
    # A late quarantine record fills the hole during the end-of-data grace.
    late = Resequencer(end_grace_s=5.0)
    late_pool = Pool([chunk(1)], on_pull=lambda left: left == 0 and late.mark_satisfied(0))
    assert late.next_chunk(late_pool)['v'] == 1
    late.reset()
    assert late.stats()['expected_seq'] == 0 and not late._satisfied


def test_thread_pool_timeout_names_workers_and_items_in_flight():
    from petastorm_tpu_torch.workers import TimeoutWaitingForResultError, WorkerBase
    from petastorm_tpu_torch.workers.thread_pool import ThreadPool
    from petastorm_tpu_torch.workers.ventilator import ConcurrentVentilator

    class Sleepy(WorkerBase):
        def process(self, value):
            time.sleep(2)
            self.publish_func({'v': value})

    pool = ThreadPool(1)
    pool.start(Sleepy, None, ConcurrentVentilator(None, [{'value': 1}], iterations=1))
    try:
        with pytest.raises(TimeoutWaitingForResultError) as info:
            pool.get_results(timeout=0.3)
        message = str(info.value)
        assert 'alive' in message and 'pstt-pool-worker-0' in message
        assert 'Items in flight: 1' in message and 'Respawns used: 0' in message
        assert pool.diagnostics['ventilated_unprocessed'] == 1
        assert pool.get_results()['v'] == 1
    finally:
        pool.stop()
        pool.join()


def test_queue_stall_site_delays_each_result(store, monkeypatch):
    slept = []
    real_sleep = time.sleep

    def spy(seconds):
        if seconds == 0.123:
            slept.append(seconds)
        else:
            real_sleep(seconds)

    monkeypatch.setattr(time, 'sleep', spy)
    monkeypatch.setenv(faults.ENV_VAR, 'queue-stall:delay=0.123')
    with make_tensor_reader(store, workers_count=2, shuffle_row_groups=False) as reader:
        assert sum(len(c.id) for c in reader) == ROWS
    # A chunk and an item-processed ack a row-group.
    assert len(slept) == 2 * ROWS // PER_GROUP


def test_store_read_corrupt_refills_an_equal_entry(store, tmp_path, monkeypatch):
    """The site makes the store's entry read fail its check: the entry is
    quarantined and refilled by decoding again, to the same blocks, in both
    packages."""
    outcomes = []
    for factory, mod, digest in ((make_tensor_reader, faults, _digest_array),
                                 (jax_make_tensor_reader, jax_faults, jax_digest)):
        location = str(tmp_path / mod.__name__)
        kwargs = dict(reader_pool_type='dummy', shuffle_row_groups=False,
                      cache_type='chunk-store', cache_location=location)
        with factory(store, **kwargs) as reader:
            decoded = _drain(reader, digest)
            reader.chunk_store.flush()
        monkeypatch.setenv(mod.ENV_VAR, 'store-read-corrupt:max=2')
        with factory(store, **kwargs) as reader:
            served = _drain(reader, digest)
            stats = reader.chunk_store.stats()
            reader.chunk_store.flush()
        monkeypatch.delenv(mod.ENV_VAR)
        with factory(store, **kwargs) as reader:
            again = _drain(reader, digest)
            after = reader.chunk_store.stats()
        assert served == decoded == again
        outcomes.append((stats['corrupt_quarantined'], stats['hits'], stats['misses'],
                         after['hits'], after['misses']))
    assert outcomes[0] == outcomes[1] == (2, 6, 2, 8, 0)


@pytest.mark.parametrize('inflate,state', [(600, 'advisory'), (700, 'degrade'),
                                           (800, 'shed'), (None, 'breach'), (1, 'ok')])
def test_mem_pressure_moves_the_governor_to_the_jax_rung(monkeypatch, tmp_path, inflate, state):
    from petastorm_tpu import membudget as jax_membudget
    from petastorm_tpu_torch import membudget
    monkeypatch.setenv('PETASTORM_TPU_FLIGHT_RECORDER', str(tmp_path))
    monkeypatch.setenv('PSTT_FLIGHT_RECORDER', str(tmp_path))
    text = 'mem-pressure:match=results' + ('' if inflate is None else ':bytes={}'.format(inflate))
    _set_spec(monkeypatch, text)
    seen = []
    for mod in (membudget, jax_membudget):
        gov = mod.MemoryGovernor(budget=1000)
        gov._arm_count += 1
        gov.register_pool('results-queue', lambda: 100)
        gov.register_pool('arena-pool', lambda: 50)
        gov.add_breach_sink(lambda e: None)
        seen.append((gov.check(now=0.0), gov.probe()['pools']))
        gov.release()
    assert seen[0] == seen[1]
    assert seen[0][0] == state
    assert seen[0][1] == {'results-queue': 100 + (1000 if inflate is None else inflate),
                          'arena-pool': 50}


def test_governor_instruments_follow_the_ladder(monkeypatch):
    from petastorm_tpu_torch import membudget
    previous = metrics.set_registry(metrics.MetricsRegistry())
    try:
        monkeypatch.setenv(faults.ENV_VAR, 'mem-pressure:match=results:bytes=800')
        gov = membudget.MemoryGovernor(budget=1000)
        assert gov.arm()
        gov.register_pool('results-queue', lambda: 100, degrade_fn=lambda: True)
        gov.check()
        snap = metrics.get_registry().collect()
        gov.release()
        after = metrics.get_registry().collect()
    finally:
        metrics.set_registry(previous)
    assert snap['pst_mem_budget_bytes']['samples'][0]['value'] == 1000
    assert snap['pst_mem_pressure_state']['samples'][0]['value'] == 2
    assert snap['pst_mem_accounted_bytes']['samples'] == [
        {'labels': {'pool': 'results-queue'}, 'value': 900}]
    assert snap['pst_mem_degrade_actions_total']['samples'] == [
        {'labels': {'action': 'degrade:results-queue'}, 'value': 1}]
    assert after['pst_mem_budget_bytes']['samples'][0]['value'] == 0


@pytest.fixture(scope='module')
def labelled_store(tmp_path_factory):
    """The imagenet store's schema at a small size: JPEG images and labels."""
    schema = Unischema('ImagenetSchema', [
        UnischemaField('image', np.uint8, (8, 8, 3), CompressedImageCodec('jpeg', 90)),
        UnischemaField('label', np.int64, (), ScalarCodec(np.int64)),
    ])
    rng = np.random.default_rng(7)
    url = 'file://' + str(tmp_path_factory.mktemp('faults_cell') / 'imagenet')
    write_dataset(url, schema, ({'image': rng.integers(0, 256, (8, 8, 3), np.uint8),
                                 'label': int(rng.integers(0, 1000))} for _ in range(ROWS)),
                  rows_per_row_group=PER_GROUP)
    return url


def test_faults_cell_glue_on_the_cpu(labelled_store, monkeypatch):
    """``bench.run_imagenet_faults`` (phase 23 of ``chip_smoke.py``) at a
    small size on the CPU: the training scan replaced by the same reader and
    loader, each superbatch observed; every check of the cell runs."""
    import torch
    from petastorm_tpu_torch import TorchLoader, bench, make_pod_reader

    windows = []

    def scan(url, device, train, state, warmup, calls, kernels, cache_type='memory',
             workers=4, reader_kwargs=None, observe=None, **_):
        reader = make_pod_reader(url, pod_shard=(0, 1), schema_fields=['image', 'label'],
                                 reader_pool_type='thread', workers_count=workers,
                                 shuffle_row_groups=True, seed=0, num_epochs=None,
                                 cache_type=cache_type, **(reader_kwargs or {}))
        with reader:
            with TorchLoader(reader, bench.BATCH, device='cpu', prefetch=2) as loader:
                groups = loader.superbatches(bench.SCAN_K)
                n = (warmup + 2 * calls) * bench.SCAN_K
                for _ in range(warmup + 2 * calls):
                    sb = next(groups)
                    observe(sb)
                stats, timings = loader.stats, reader.stage_timings
                diagnostics = reader.diagnostics()
                decoder = reader.decoder
        windows.append(n)
        return ({'img_per_s': 1.0, 'device_step_ms': 1.0, 'input_stall_frac': 0.0,
                 'rows_delivered': n * bench.BATCH, 'decoder': decoder,
                 'quarantined_rowgroups': diagnostics['quarantined_rowgroups'],
                 'stage_profile': bench.stage_profile(stats, {}, timings, 1.0)},
                ({}, {}, {'normalize_kernel': 0}, 0))

    monkeypatch.setattr(bench, 'stream_classifier_scan', scan)
    monkeypatch.setattr(bench, 'require_scan_launches', lambda *args: None)
    monkeypatch.setattr(bench, 'ROWS', ROWS)
    monkeypatch.setattr(bench, 'BATCH', 4)
    monkeypatch.setattr(bench, 'SCAN_K', 2)
    monkeypatch.setattr(bench, 'FAULTS_CHECK_BATCHES', 20)
    monkeypatch.setattr(bench, 'FAULTS_READ_DELAY_S', 0.001)
    monkeypatch.setattr(bench, 'FAULTS_URL', 'memory://pstt-faults-cell-test')
    monkeypatch.delenv(faults.ENV_VAR, raising=False)
    line = bench.run_imagenet_faults(labelled_store, torch.device('cpu'), 'cpu', None,
                                     warmup=1, calls=20, workers=3, min_epochs=2)
    assert line['checks']['epochs_read'] > 2
    assert line['store']['rows_kept_per_epoch'] == ROWS - 2 * PER_GROUP
    assert line['counters']['after_training']['pst_rowgroups_quarantined_total'] == 2
    assert line['decoder']['parquet'] == 'pyarrow'
    assert not faults.get_injector().active_sites
    assert windows == [82] and line['checks']['budget_1_raises']


def test_fingerprint_and_context_take_budget_and_options_as_jax(store):
    """The resume fingerprint and the provenance context leave out
    ``error_budget`` and ``storage_options``, as the JAX package's do, so a
    state taken with a budget resumes a reader without one in either
    package."""
    out = []
    for factory in (make_tensor_reader, jax_make_tensor_reader):
        with factory(store, reader_pool_type='dummy', seed=3, error_budget=1,
                     storage_options={}) as budgeted:
            state, ctx = budgeted.state_dict(), budgeted.lineage_context()
        with factory(store, reader_pool_type='dummy', seed=3) as plain:
            assert plain.state_dict()['config'] == state['config']
            assert plain.lineage_context() == ctx
        out.append((state['config'], {k: ctx[k] for k in ctx if k != 'x64'}))
    assert out[0][0] == out[1][0]
    assert set(out[0][1]) <= set(out[1][1])
    assert all(out[0][1][k] == out[1][1][k] for k in out[0][1])
