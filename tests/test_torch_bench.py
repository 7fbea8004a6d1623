"""The port's bench on the CPU: the ``pipeline`` child on a tiny store
prints the keys of ``bench.py``'s pipeline child, the median of its reps
with their spread, its stage profile with the ``lineage`` block (a replay
self-check that passes), the ``determinism`` block, the cache-tier sweep
with its ``chunk-store`` row, the ``decode_path_sweep`` and, with the
governor armed, the ``mem`` block, and the autotuner's record; the
``staging`` child and the top-level ``hello_world_samples_per_sec`` run on
a small hello_world store; an unknown child and a CUDA request without a
GPU raise."""

import json

import numpy as np
import pytest
import torch

from petastorm_tpu_torch import bench

ROWS, PER_GROUP, BATCH = 64, 16, 8


@pytest.fixture(scope='module')
def workdir(tmp_path_factory):
    """A bench workdir whose imagenet store is a tiny one of the bench's
    schema (the bench uses a store it finds there)."""
    from petastorm_tpu_torch import (CompressedImageCodec, ScalarCodec, Unischema,
                                     UnischemaField, write_dataset)
    schema = Unischema('ImagenetSchema', [
        UnischemaField('image', np.uint8, (32, 32, 3), CompressedImageCodec('jpeg', 90)),
        UnischemaField('label', np.int64, (), ScalarCodec(np.int64)),
    ])
    rng = np.random.default_rng(7)
    path = tmp_path_factory.mktemp('bench')
    write_dataset('file://' + str(path / 'imagenet'), schema,
                  ({'image': bench.synthetic_image(rng, 32), 'label': i} for i in range(ROWS)),
                  rows_per_row_group=PER_GROUP)
    assert bench.ensure_imagenet_store(str(path)) == 'file://' + str(path / 'imagenet')
    return str(path)


def test_pipeline_child_prints_the_bench_keys(workdir, monkeypatch, capsys):
    for key, value in (('BENCH_PIPELINE_BATCH', BATCH), ('BENCH_PIPELINE_BATCHES', 4),
                       ('BENCH_PIPELINE_REPS', 3), ('BENCH_PIPELINE_TIER_BATCHES', 2),
                       ('BENCH_PIPELINE_INFLIGHT', 1)):
        monkeypatch.setenv(key, str(value))
    assert bench.main(['--child', 'pipeline', '--device', 'cpu', '--workdir', workdir]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ('pipeline_img_per_sec', 'pipeline_img_per_sec_reps', 'pipeline_img_per_sec_spread',
                'pipeline_cold_img_per_sec', 'pipeline_batch', 'pipeline_prefetch',
                'pipeline_load', 'pipeline_stage_profile', 'pipeline_autotune', 'platform',
                'device_kind', 'n_devices'):
        assert key in out, key
    reps = out['pipeline_img_per_sec_reps']
    assert len(reps) == 3 and out['pipeline_img_per_sec'] == sorted(reps)[1]
    assert out['pipeline_img_per_sec_spread'] == max(reps) - min(reps)
    assert out['pipeline_batch'] == BATCH and out['pipeline_inflight'] == 1
    assert out['pipeline_warmup_batches'] == ROWS // BATCH + 2
    assert out['platform'] == 'cpu' and out['child'] == 'pipeline'
    profile = out['pipeline_stage_profile']
    for key in ('read_s', 'decode_s', 'cache_s', 'stage_dispatch_s', 'consumer_wait_s', 'wall_s',
                'assemble_s', 'dispatch_s', 'overlap_s', 'overlap_frac', 'ready_wait_s',
                'arena_reuse', 'arena_alloc', 'arena_wait_s', 'rss_mb', 'rss_peak_mb'):
        assert key in profile, key
    assert profile['batches'] == 3 * 4 and profile['rows'] == 3 * 4 * BATCH
    assert profile['cache']['hits'] > 0          # warmed through an epoch: served from RAM
    sweep = profile['cache_tier_sweep']
    assert sorted(sweep) == ['chunk-store', 'memory', 'null']
    assert sweep['null']['cache']['type'] == 'null'
    store = sweep['chunk-store']['chunk_store']
    # Filled by a pass of its own first: the measuring reader only hits.
    assert store['misses'] == store['writes'] == 0 and store['hits'] > 0
    assert sweep['chunk-store']['decode_s'] == 0.0 and store['corrupt_quarantined'] == 0
    assert sweep['chunk-store']['fill_s'] > 0
    assert 'mem' not in profile                # the governor is not armed here
    # The tuner runs by default (BENCH_PIPELINE_AUTOTUNE), over the loader's
    # knobs and the reader's, which the loader adopted.
    assert 'not_ported' not in out
    tuner = out['pipeline_autotune']
    assert {'prefetch', 'inflight', 'arena_depth', 'arena_pinned', 'workers', 'decode_threads',
            'results_watermark'} == set(tuner['knobs'])
    assert tuner['ticks'] >= 0 and isinstance(tuner['decisions'], list)
    decode = profile['decode_path_sweep']
    assert decode['workers'] == 1 and decode['gate_min_ratio'] == 1.5
    for row in ('scalar', 'batched', 'chunk-store-warm'):
        assert decode[row]['images'] == ROWS and decode[row]['img_per_sec'] > 0, row
        assert (decode[row]['decoder'], decode[row]['parquet']) == ('native', 'native'), row
    assert decode['chunk-store-warm']['decode_s'] == 0.0 < decode['batched']['decode_s']
    assert decode['ratio_batched_vs_scalar'] == (decode['batched']['img_per_sec']
                                                 / decode['scalar']['img_per_sec'])
    assert decode['gate_passed'] == (decode['ratio_batched_vs_scalar'] >= 1.5)
    stream = profile['per_device_stream']
    assert (stream['world_size'], stream['n_devices']) == (1, 1)
    # One tile copy a field (image and label) a staged batch; the count runs
    # with the staging threads, which may be a few batches ahead or behind.
    assert stream['shards_put'] > 0 and stream['shards_put'] % 2 == 0
    assert stream['per_device_h2d_GBps']['cpu'] > 0 and stream['img_per_sec'] > 0
    lineage = profile['lineage']
    assert lineage['replay_self_check'] is True
    assert lineage['records'] >= 3 * 4 and lineage['dropped'] == 0
    assert lineage['ledger_bytes'] > 0 and 'ledger_lag' in lineage
    det = profile['determinism']
    assert det['img_per_sec'] > 0 and det['default_img_per_sec'] == out['pipeline_img_per_sec']
    assert det['ratio_vs_default'] == det['img_per_sec'] / det['default_img_per_sec']


def test_pipeline_child_reports_the_armed_governor(workdir, monkeypatch, capsys):
    from petastorm_tpu_torch import membudget
    for key, value in (('BENCH_PIPELINE_BATCH', BATCH), ('BENCH_PIPELINE_BATCHES', 2),
                       ('BENCH_PIPELINE_REPS', 1), ('BENCH_PIPELINE_TIER_BATCHES', 2),
                       ('BENCH_PIPELINE_DETERMINISM', 0), ('BENCH_PIPELINE_DECODE_SWEEP', 0),
                       ('BENCH_PIPELINE_CACHE_TIERS', 'chunk-store'),
                       (membudget.ENV_VAR, 'auto')):
        monkeypatch.setenv(key, str(value))
    previous = membudget.set_governor(membudget.MemoryGovernor())
    try:
        assert bench.main(['--child', 'pipeline', '--device', 'cpu', '--workdir', workdir]) == 0
        assert not membudget.get_governor().armed     # every pipeline released its arm
    finally:
        membudget.set_governor(previous)
    profile = json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        'pipeline_stage_profile']
    mem = profile['mem']
    assert mem['budget_bytes'] > 0 and mem['budget_source'] in ('cgroup', 'meminfo')
    assert mem['breaches'] == 0 and 'arena-pool' in mem['pools']
    assert sorted(profile['cache_tier_sweep']) == ['chunk-store']
    assert 'decode_path_sweep' not in profile


def test_unknown_child_and_cuda_without_a_gpu_raise(workdir, tmp_path, monkeypatch):
    with pytest.raises(ValueError, match='unknown child'):
        bench.run_child('nope', 'cpu', str(tmp_path))
    with pytest.raises(SystemExit):
        bench.main(['--child', 'nope', '--device', 'cpu', '--workdir', str(tmp_path)])
    with pytest.raises(ValueError, match='card only'):
        bench.run_child('lm', 'cpu', str(tmp_path))
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='is_available'):
        bench.main(['--child', 'pipeline', '--workdir', workdir])
    with pytest.raises(RuntimeError, match='is_available'):
        bench.main([])                         # the whole bench asks for the card too


def test_children_follow_the_bench_order():
    assert list(bench.CHILDREN) == ['staging', 'imagenet', 'pipeline', 'imagenet_vit', 'lm',
                                    'lm_long', 'lm_moe', 'flashattn', 'imagenet_aug',
                                    'lookup', 'imagenet_remote', 'fleet_wire']
    assert bench.lm_rows(8193) == 256 and bench.lm_rows(1025) == 2048


@pytest.fixture(scope='module')
def hello_workdir(tmp_path_factory):
    """A workdir holding a 64-row hello_world store of the bench's schema."""
    path = tmp_path_factory.mktemp('hello')
    bench.write_hello_world_store(str(path / 'hello_world'), rows=64)
    return str(path)


def test_staging_child_pads_hello_world_batches(hello_workdir, monkeypatch, capsys):
    monkeypatch.setattr(bench, 'STAGING_BATCHES', 3)
    monkeypatch.setenv('BENCH_HELLO_POOL', 'dummy')
    assert bench.main(['--child', 'staging', '--device', 'cpu', '--workdir', hello_workdir]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out['child'] == 'staging' and out['platform'] == 'cpu' and out['device'] == 'cpu'
    assert out['staged_samples_per_sec'] > 0 and 0 <= out['hello_input_stall_frac'] <= 1
    assert (out['staging_batch'], out['staging_batches'], out['reader_pool']) == (32, 3, 'dummy')


def test_hello_world_metric_sweeps_pools_and_takes_the_median(hello_workdir, monkeypatch):
    monkeypatch.setattr(bench, 'HELLO_WARMUP_SAMPLES', 8)
    monkeypatch.setattr(bench, 'HELLO_MEASURE_SAMPLES', 40)
    url = bench.ensure_hello_world_store(hello_workdir)
    metric = bench.hello_world_metric(url, 3)
    config = metric['hello_config']
    assert metric['metric'] == 'hello_world_samples_per_sec' and metric['unit'] == 'samples/s'
    assert config['configs_swept'] == ['dummy-1', 'thread-1', 'thread-2', 'thread-3']
    best = max(config['sweep_rates'], key=config['sweep_rates'].get)
    assert best == '{}-{}'.format(config['reader_pool'], config['workers_count'])
    assert len(config['rep_rates']) == 3 and metric['value'] == sorted(config['rep_rates'])[1]
    assert metric['vs_baseline'] == metric['value'] / 709.84
    assert metric['hello_world_cached_samples_per_sec'] > 0
    assert metric['hello_world_single_draw_max'] == max(config['rep_rates']
                                                        + [config['sweep_rates'][best]])


@pytest.mark.parametrize('split', [bench.FILTERED_SPLIT, ((0.5, 0.5), 1)])
def test_filtered_cell_checks_hold_on_the_cpu(workdir, split):
    """The filtered cell's reader arguments on the CPU: one epoch through a
    loader gives the independent reckoning's labels (a multiset), and the
    threaded stream the dummy pool's, in order (the card phase's checks)."""
    from petastorm_tpu_torch import TorchLoader, make_tensor_reader
    url = bench.ensure_imagenet_store(workdir)
    kwargs, table = bench.filtered_reader_kwargs(split)
    assert sorted(table[table >= 0].tolist()) == list(range(int((table >= 0).sum())))
    with make_tensor_reader(url, workers_count=3, num_epochs=1, seed=0, **kwargs) as reader:
        with TorchLoader(reader, BATCH, device='cpu', last_batch='partial') as loader:
            epoch = np.concatenate([b.label.numpy().copy() for b in loader])
    reckoned = bench.reckon_filtered_labels(url, split, table)
    assert 0 < len(reckoned) < ROWS
    np.testing.assert_array_equal(np.sort(epoch), reckoned)
    assert (reckoned >= 0).all()

    def stream(pool):
        with make_tensor_reader(url, reader_pool_type=pool, workers_count=3, num_epochs=2,
                                seed=0, **bench.filtered_reader_kwargs(split)[0]) as reader:
            return np.concatenate([np.asarray(c.label) for c in reader])

    np.testing.assert_array_equal(stream('thread'), stream('dummy'))


def test_the_remote_variant_splits_its_timed_window_on_the_cpu(workdir, tmp_path, monkeypatch):
    """Phase 27 (a)'s glue on the CPU at a small size: a serve-CLI server
    over the tiny store feeding ``RemoteReader`` -> ``TorchLoader`` ->
    ``superbatches``, the scan window and the timed calls replaced by host
    versions. The line splits the timed window: the consumer's side (its
    wait, the reader wait, credits owed at both ends) and the server's
    (chunks served, decode seconds a chunk, serialize ms a chunk, bytes by
    transport, the chunks in flight at both ends)."""
    import time

    from torch_service_helpers import ipc_dir

    def step(state, x, y):
        return {'loss': torch.ones(()), 'last_loss': torch.ones(())}

    def scan_window(train, state, next_inputs, warmup, calls, kernels, profile=True, until=None):
        metrics = [train(state, *next_inputs()) for _ in range(warmup + calls)]
        return metrics, {}, {}, {'normalize_kernel': 0}, None, 0

    def time_scan_calls(train, state, next_inputs, calls):
        out, wait_s, t0 = [], 0.0, time.perf_counter()
        for _ in range(calls):
            t1 = time.perf_counter()
            inputs = next_inputs()
            wait_s += time.perf_counter() - t1
            out.append(train(state, *inputs))
        return time.perf_counter() - t0, wait_s, 1.0, out

    monkeypatch.setattr(bench, 'scan_window', scan_window)
    monkeypatch.setattr(bench, 'time_scan_calls', time_scan_calls)
    monkeypatch.setattr(bench, 'require_scan_launches', lambda *args: None)
    monkeypatch.setattr(bench, 'cuda_compute_pids', lambda: [])
    monkeypatch.setattr(bench, 'ROWS', ROWS)
    monkeypatch.setattr(bench, 'BATCH', BATCH)
    monkeypatch.setattr(bench, 'SCAN_K', 2)
    monkeypatch.setattr(bench, 'SCAN_PREFETCH', 2)
    monkeypatch.setattr(torch.cuda, 'empty_cache', lambda: None)
    chunk = PER_GROUP * 32 * 32 * 3 + PER_GROUP * 8
    line = bench._remote_variant(bench.ensure_imagenet_store(workdir), torch.device('cpu'), step,
                                 None, ipc_dir(tmp_path), 'remote-a', 2, 3, 2, None,
                                 bench.remote_ring_bytes(chunk, 16))
    assert line['failures'] == [] and line['segments_left'] == []
    assert line['rows_delivered'] == (2 + 2 * 3) * 2 * BATCH
    split, server = line['timed_split'], line['timed_server']
    assert split['wall_s'] > 0 and 0 <= split['consumer_wait_s'] <= split['wall_s']
    assert split['credits'] == bench.REMOTE_CREDITS
    assert 0 <= split['credits_owed_start'] <= bench.REMOTE_CREDITS
    assert 0 <= split['credits_owed_end'] <= bench.REMOTE_CREDITS
    assert server['chunks_served'] >= 0 and server['wall_s'] > 0
    assert server['decode_calls'] >= 0 and server['decode_s'] >= 0
    assert set(server['wire_bytes_by_transport']) <= {'shm', 'arrow', 'pickle'}
    assert sum(line['wire_bytes_by_transport'].values()) > 0
    assert server['in_flight_start'] >= 0 and server['in_flight_end'] >= 0
    assert line['server']['exit_code'] is not None
