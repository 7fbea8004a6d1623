"""The port's process pools against its thread pool and the JAX package's
process pools, and their supervision under chaos.

Parity: for each pool kind (``'process'``, ``'process-shm'``,
``'process-zmq'``) and each reader (``make_tensor_reader``,
``make_reader``, ``make_batch_reader``), a ``deterministic=True`` stream
equals, chunk for chunk (row for row), by the CRC32 digest of every field
(``lineage._digest_array``), the port's ``'thread'`` stream of the same
store and the JAX package's process pool of the same kind.

Chaos, held against ``tests/test_chaos.py:72, 92, 112, 687`` and
``tests/test_determinism.py:607``: a SIGKILLed worker is respawned and its
items delivered exactly once; the ``worker-kill`` site with ``token=``
kills exactly one worker; a spent restart budget raises
``WorkerLostError``; the watchdog reads ``dead_workers`` as
``worker-pool-dead``; a deterministic stream stays bit-identical across a
kill, and a ledger recorded across one replays, its segments naming the
workers' real pids. Beyond them: a worker process imports no torch and
sees no card; without dill, what pickle cannot carry raises; the workers'
sidecars merge into one Chrome trace; ``reader_throughput`` measures a
process pool in a process of its own.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from petastorm_tpu import make_batch_reader as jax_make_batch_reader
from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu import make_tensor_reader as jax_make_tensor_reader
from petastorm_tpu_torch import (NdarrayCodec, ScalarCodec, TorchLoader, Unischema,
                                 UnischemaField, WorkerLostError, faults, make_batch_reader,
                                 make_reader, make_tensor_reader, metrics, write_dataset)
from petastorm_tpu_torch.errors import PipelineStallError
from petastorm_tpu_torch.lineage import _digest_array, read_ledger_dir
from petastorm_tpu_torch.native import shm_ring
from petastorm_tpu_torch.tools import replay
from petastorm_tpu_torch.workers import EmptyResultError
from petastorm_tpu_torch.workers.process_pool import ProcessPool
from petastorm_tpu_torch.workers.shm_process_pool import ShmProcessPool
from petastorm_tpu_torch.workers.ventilator import ConcurrentVentilator
from torch_pool_workers import EchoWorker, GatedEchoWorker, ProbeWorker

pytestmark = [pytest.mark.processpool, pytest.mark.chaos]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, PER_GROUP = 40, 5
KINDS = ('process', 'process-shm', 'process-zmq')
DET = dict(deterministic=True, seed=7, shuffle_row_groups=True, num_epochs=1, workers_count=2)


@pytest.fixture(scope='module')
def url(tmp_path_factory):
    """Scalar and ndarray fields: both packages decode them to the same bytes."""
    schema = Unischema('PoolSchema', [
        UnischemaField('id', np.int64, (), ScalarCodec(np.int64), False),
        UnischemaField('vec', np.float32, (4,), NdarrayCodec(), False),
        UnischemaField('code', np.int32, (), ScalarCodec(np.int32), False)])
    rng = np.random.default_rng(5)
    url = 'file://' + str(tmp_path_factory.mktemp('pool') / 'ds')
    write_dataset(url, schema, ({'id': i, 'vec': rng.random(4, dtype=np.float32),
                                 'code': int(rng.integers(0, 1000))} for i in range(ROWS)),
                  rows_per_row_group=PER_GROUP)
    return url


@pytest.fixture(scope='module')
def plain_url(tmp_path_factory):
    """A plain Parquet store (no schema): ints, floats and a fixed list."""
    path = tmp_path_factory.mktemp('plain')
    rng = np.random.default_rng(6)
    table = pa.table({'id': pa.array(np.arange(ROWS, dtype=np.int64)),
                      'f': pa.array(rng.random(ROWS)),
                      'fixed': pa.array([[i, i + 1, i + 2] for i in range(ROWS)],
                                        type=pa.list_(pa.int32()))})
    pq.write_table(table, str(path / 'part.parquet'), row_group_size=PER_GROUP)
    return 'file://' + str(path)


READERS = {'tensor': (make_tensor_reader, jax_make_tensor_reader, 'url'),
           'row': (make_reader, jax_make_reader, 'url'),
           'batch': (make_batch_reader, jax_make_batch_reader, 'plain_url')}


def _digests(reader):
    """Per chunk (per row for a row reader), every field's CRC32."""
    with reader:
        return [{k: _digest_array(v) for k, v in item._asdict().items()} for item in reader]


@pytest.fixture(scope='module')
def thread_streams(url, plain_url):
    urls = {'url': url, 'plain_url': plain_url}
    return {which: _digests(port(urls[store], reader_pool_type='thread', **DET))
            for which, (port, _, store) in READERS.items()}


@pytest.mark.parametrize('which', sorted(READERS))
@pytest.mark.parametrize('kind', KINDS)
def test_deterministic_stream_equals_thread_pool_and_jax_process_pool(url, plain_url,
                                                                      thread_streams,
                                                                      kind, which):
    port_factory, jax_factory, store = READERS[which]
    store_url = {'url': url, 'plain_url': plain_url}[store]
    reader = port_factory(store_url, reader_pool_type=kind, **DET)
    assert reader.diagnostics['transport'] == ('zmq' if kind == 'process-zmq' else 'shm_ring')
    port = _digests(reader)
    assert len(port) == (ROWS if which == 'row' else ROWS // PER_GROUP)
    assert port == thread_streams[which]
    assert port == _digests(jax_factory(store_url, reader_pool_type=kind, **DET))


@pytest.mark.parametrize('kind', KINDS)
def test_unknown_and_known_pool_kinds(url, kind):
    with pytest.raises(ValueError, match='thread|process|process-shm|process-zmq|dummy'):
        make_tensor_reader(url, reader_pool_type='processes')
    with make_tensor_reader(url, reader_pool_type=kind, workers_count=1,
                            shm_result_ring_bytes=1 << 16) as reader:
        assert sum(len(c.id) for c in reader) == ROWS
        if kind != 'process-zmq':
            assert reader._pool.result_ring_bytes == 1 << 16
        # A process worker decodes on a static share of the budget.
        assert reader._static_decode_threads >= 1 and reader._decode_share is None


# -- chaos -----------------------------------------------------------------------------

@pytest.fixture
def registry():
    fresh = metrics.MetricsRegistry()
    previous = metrics.set_registry(fresh)
    yield fresh
    metrics.set_registry(previous)


def _counter(registry, name):
    return sum(s['value'] for s in registry.collect().get(name, {}).get('samples', []))


@pytest.mark.parametrize('kind', ['process-zmq', 'process-shm'])
def test_sigkill_mid_epoch_respawns_and_delivers_exactly_once(url, registry, kind):
    with make_reader(url, reader_pool_type=kind, workers_count=2, num_epochs=1,
                     shuffle_row_groups=False) as reader:
        it = iter(reader)
        ids = [int(next(it).id) for _ in range(3)]
        os.kill(reader._pool._processes[0].pid, signal.SIGKILL)
        ids.extend(int(row.id) for row in it)
        assert reader.diagnostics()['worker_respawns'] == 1
    assert sorted(ids) == list(range(ROWS))
    assert _counter(registry, 'pst_worker_deaths_total') == 1
    assert _counter(registry, 'pst_worker_respawns_total') == 1


@pytest.mark.parametrize('kind', ['process-zmq', 'process-shm'])
def test_worker_kill_site_with_a_token_kills_exactly_one_worker(url, registry, tmp_path,
                                                                monkeypatch, kind):
    token = tmp_path / 'kill.token'
    monkeypatch.setenv(faults.ENV_VAR, 'worker-kill:token={}'.format(token))
    with make_reader(url, reader_pool_type=kind, workers_count=2, num_epochs=1,
                     shuffle_row_groups=False) as reader:
        ids = sorted(int(row.id) for row in reader)
        assert reader.diagnostics()['worker_respawns'] == 1
    assert token.exists()
    assert ids == list(range(ROWS))
    assert _counter(registry, 'pst_worker_deaths_total') == 1


@pytest.mark.parametrize('pool_class', [ProcessPool, ShmProcessPool])
def test_a_spent_restart_budget_raises_worker_lost(pool_class, tmp_path):
    # Every item but the first waits for the gate, which stays shut until
    # the kill has been seen: worker 0 dies with items in flight, so the
    # epoch cannot end quietly before the budget is checked.
    gate = tmp_path / 'gate'
    pool = pool_class(2, max_worker_restarts=0)
    ventilator = ConcurrentVentilator(None, [{'value': i} for i in range(200)], iterations=1)
    pool.start(GatedEchoWorker, str(gate), ventilator)
    try:
        pool.get_results()
        os.kill(pool._processes[0].pid, signal.SIGKILL)
        with pytest.raises(WorkerLostError, match='restart budget'):
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                try:
                    pool.get_results(timeout=5)
                except EmptyResultError:
                    break
    finally:
        gate.touch()
        pool.stop()
        pool.join()


def test_watchdog_classifies_a_dead_worker_as_worker_pool_dead(url):
    """The consumer paused, no poll respawns the killed worker: the
    probe's ``dead_workers`` classifies ``worker-pool-dead``; consuming
    again respawns it and the epoch completes exactly once (a stall raised
    meanwhile is diagnosed, and the stream goes on through it)."""
    with make_reader(url, reader_pool_type='process-zmq', workers_count=2, num_epochs=1,
                     shuffle_row_groups=False, watchdog=True, stall_timeout_s=0.1) as reader:
        it = iter(reader)
        ids = [int(next(it).id) for _ in range(3)]
        os.kill(reader._pool._processes[0].pid, signal.SIGKILL)
        label = None
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and label is None:
            last = reader.diagnostics()['watchdog']['last_stall']
            label = last['classification'] if last is not None else None
            time.sleep(0.05)
        assert label == 'worker-pool-dead'
        while True:
            try:
                row = next(it)
            except StopIteration:
                break
            except PipelineStallError:
                continue
            ids.append(int(row.id))
        assert reader.diagnostics()['worker_respawns'] == 1
    assert sorted(ids) == list(range(ROWS))


@pytest.mark.parametrize('kind', ['process-zmq', 'process-shm'])
def test_a_deterministic_stream_stays_bit_identical_across_a_kill(url, thread_streams, tmp_path,
                                                                  monkeypatch, kind):
    token = tmp_path / 'kill.token'
    monkeypatch.setenv(faults.ENV_VAR, 'worker-kill:token={}'.format(token))
    faulted = _digests(make_tensor_reader(url, reader_pool_type=kind, **DET))
    assert token.exists()
    assert faulted == thread_streams['tensor']


def test_a_ledger_across_a_kill_replays_with_the_workers_pids(url, tmp_path, monkeypatch):
    token = tmp_path / 'kill.token'
    monkeypatch.setenv(faults.ENV_VAR, 'worker-kill:token={}'.format(token))
    ledger = str(tmp_path / 'ledger')
    with make_tensor_reader(url, reader_pool_type='process', **DET) as reader:
        with TorchLoader(reader, 8, device='cpu', lineage=ledger) as loader:
            batches = sum(1 for _ in loader)
        assert reader.diagnostics()['worker_respawns'] == 1
    monkeypatch.delenv(faults.ENV_VAR)
    assert token.exists() and batches == ROWS // 8
    records = [r for _, _, recs in read_ledger_dir(ledger) for r in recs]
    pids = {s['worker_pid'] for r in records for s in r['segments']}
    assert os.getpid() not in pids and len(pids) >= 2
    for batch_id in (0, batches - 1):
        assert replay.main(['--ledger', ledger, '--batch-id', str(batch_id), '--verify']) == 0


# -- the worker process --------------------------------------------------------------

@pytest.mark.parametrize('pool_class', [ProcessPool, ShmProcessPool])
def test_a_worker_imports_no_torch_and_sees_no_card(pool_class):
    pool = pool_class(2)
    ventilator = ConcurrentVentilator(None, [{'value': i} for i in range(4)], iterations=1)
    pool.start(ProbeWorker, None, ventilator)
    try:
        probes = []
        with pytest.raises(EmptyResultError):
            while True:
                probes.append(pool.get_results())
        pids = set(pool.worker_pids())
    finally:
        pool.stop()
        pool.join()
    assert sorted(p['value'] for p in probes) == [0, 1, 2, 3]
    assert {p['pid'] for p in probes} <= pids and os.getpid() not in pids
    assert not any(p['torch'] or p['jax'] for p in probes)
    assert all(p['cuda_visible_devices'] == '' for p in probes)
    assert pool.startup_s is not None and pool.startup_s < 30


_NO_DILL = r'''
import sys
sys.modules['dill'] = None
from petastorm_tpu_torch import make_tensor_reader, predicates, transform
from petastorm_tpu_torch.native import shm_ring
from petastorm_tpu_torch.workers import exec_in_new_process
assert exec_in_new_process.PICKLER == 'pickle'
url = sys.argv[1]
with make_tensor_reader(url, reader_pool_type='process', workers_count=2, cache_type='memory',
                        predicate=predicates.in_set([1, 2, 3], 'code')) as reader:
    list(reader)
for kwargs in ({'predicate': predicates.in_lambda(['code'], lambda c: c > 3)},
               {'transform_spec': transform.TransformSpec(lambda cols: cols)}):
    try:
        make_tensor_reader(url, reader_pool_type='process', workers_count=2, **kwargs)
    except TypeError as e:
        assert 'dill' in str(e), e
    else:
        raise AssertionError('no TypeError for {}'.format(kwargs))
assert not shm_ring.list_segments('pstt_{}_'.format(__import__('os').getpid()))
print('ok')
'''


def test_without_dill_pickle_carries_the_reader_and_a_lambda_raises_naming_dill(url):
    result = subprocess.run([sys.executable, '-c', _NO_DILL, url], cwd=REPO,
                            capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr[-3000:]
    assert result.stdout.strip().endswith('ok')


# -- observability and the benchmark ------------------------------------------------

def test_worker_sidecars_merge_into_one_trace_under_distinct_pids(url, tmp_path, monkeypatch):
    from petastorm_tpu_torch import trace
    trace_dir = str(tmp_path / 'trace')
    os.makedirs(trace_dir)
    monkeypatch.setenv(trace.TRACE_DIR_ENV, trace_dir)
    tracer = trace.Tracer(spill_dir=False)
    with make_tensor_reader(url, reader_pool_type='process', workers_count=2,
                            num_epochs=1) as reader:
        with TorchLoader(reader, 8, device='cpu', tracer=tracer) as loader:
            assert sum(1 for _ in loader) == ROWS // 8
    out = str(tmp_path / 'merged.json')
    result = subprocess.run([sys.executable, '-m', 'petastorm_tpu_torch.tools.trace_merge',
                             '--dir', trace_dir, '--out', out], cwd=REPO, capture_output=True,
                            text=True, timeout=120)
    assert result.returncode == 0, result.stderr
    assert json.loads(result.stdout)['merged_files'] == 2
    events = json.load(open(out))['traceEvents']
    for name in ('read', 'decode', 'handoff'):
        pids = {e['pid'] for e in events if e.get('name') == name and e['ph'] == 'X'}
        assert len(pids) == 2 and os.getpid() not in pids, (name, pids)
    assert tracer.merge_process_files(trace_dir) == 2
    assert {'assemble', 'stage', 'decode'} <= {e['name'] for e in tracer.events if e['ph'] == 'X'}


def test_reader_throughput_of_a_process_pool_in_a_process_of_its_own(url):
    from petastorm_tpu_torch.benchmark import reader_throughput
    result = reader_throughput(url, warmup_cycles_count=10, measure_cycles_count=40,
                               pool_type='process', loaders_count=2, spawn_new_process=True)
    assert result.samples_per_second > 0 and result.time_mean > 0
    assert not shm_ring.list_segments('pstt_{}_'.format(os.getpid()))


def test_process_cell_glue_on_the_cpu(tmp_path, monkeypatch):
    """``bench.run_imagenet_process`` (phase 25 of ``chip_smoke.py``) at a
    small size on the CPU: the training scan replaced by the same reader and
    loader (its hooks called as the scan calls them), the step by a
    stand-in, ``nvidia-smi`` by an empty list; every other check of the
    cell runs: the shm transport, the deterministic labels against the
    thread pool's, the worker killed by the fault site, nothing left."""
    import torch
    from petastorm_tpu_torch import CompressedImageCodec, bench, make_pod_reader
    from petastorm_tpu_torch import models as models_mod

    schema = Unischema('ProcessCell', [
        UnischemaField('image', np.uint8, (16, 16, 3), CompressedImageCodec('png'), False),
        UnischemaField('label', np.int64, (), ScalarCodec(np.int64), False)])
    rng = np.random.default_rng(25)
    store = 'file://' + str(tmp_path / 'images')
    write_dataset(store, schema, ({'image': rng.integers(0, 256, (16, 16, 3), dtype=np.uint8),
                                   'label': i % 10} for i in range(64)), rows_per_row_group=8)

    def scan(url, device, train, state, warmup, calls, kernels, workers=4, reader_kwargs=None,
             hooks=None, cache_type='memory', **_):
        args = dict(schema_fields=['image', 'label'], reader_pool_type='thread',
                    workers_count=workers, shuffle_row_groups=True, seed=0, num_epochs=None,
                    cache_type=cache_type)
        args.update(reader_kwargs or {})
        with make_pod_reader(url, pod_shard=(0, 1), **args) as reader:
            with TorchLoader(reader, bench.BATCH, device='cpu',
                             prefetch=bench.SCAN_PREFETCH) as loader:
                groups = loader.superbatches(bench.SCAN_K)
                for _ in range(warmup + 2 * calls):
                    train(state, *next(groups)[:2])
                hooks('close', loader, reader)
                stats, timings = loader.stats, reader.stage_timings
        return ({'img_per_s': 1.0, 'device_step_ms': 1.0, 'input_stall_frac': 0.0,
                 'stage_profile': {'decode_s': timings['decode_s']}, 'decoder': stats['decoder'],
                 'launches': {}}, ({}, {}, {'normalize_kernel': 0}, 0))

    monkeypatch.setattr(bench, 'stream_classifier_scan', scan)
    monkeypatch.setattr(bench, 'require_scan_launches', lambda *args: None)
    monkeypatch.setattr(bench, 'cuda_compute_pids', lambda: [])
    monkeypatch.setattr(models_mod, 'make_scan_train_step',
                        lambda k, preprocess=None: lambda state, x, y: {
                            'loss': torch.ones(()), 'last_loss': torch.ones(())})
    monkeypatch.setattr(bench, 'ROWS', 64)
    monkeypatch.setattr(bench, 'BATCH', 4)
    monkeypatch.setattr(bench, 'SCAN_K', 2)
    monkeypatch.setattr(bench, 'SCAN_PREFETCH', 2)
    monkeypatch.setattr(bench, 'PROCESS_RING_MAX_BYTES', 1 << 20)
    monkeypatch.delenv(faults.ENV_VAR, raising=False)
    line = bench.run_imagenet_process(store, torch.device('cpu'), 'cpu', None,
                                      str(tmp_path / 'work'), warmup=1, calls=1, workers=2)
    assert line['phase'] == 'imagenet_process' and line['shm']['ring_bytes'] == 1 << 20
    seen = line['process_shm']['workers_seen']
    assert seen['transport'] == 'shm_ring' and len(seen['worker_pids']) == 2
    assert not seen['workers_mapping_cuda'] and not seen['segments_left']
    assert line['process_zmq']['workers_seen']['transport'] == 'zmq'
    assert line['deterministic']['labels_equal_thread_pool']
    assert line['worker_kill']['deaths'] == line['worker_kill']['respawns'] == 1
    assert line['worker_kill']['rows'] == 64
    assert not faults.get_injector().active_sites
