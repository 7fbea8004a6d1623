"""The port's bench on the CPU: the ``pipeline`` child on a tiny store
prints the keys of ``bench.py``'s pipeline child, the median of its reps
with their spread, its stage profile with the ``lineage`` block (a replay
self-check that passes), the ``determinism`` block, the cache-tier sweep
with its ``chunk-store`` row and, with the governor armed, the ``mem``
block, and the blocks it does not port; an unknown child and a CUDA
request without a GPU raise."""

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
                'pipeline_load', 'pipeline_stage_profile', 'not_ported', 'platform',
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
    assert sorted(out['not_ported']) == sorted(['autotune', 'decode_path_sweep'])
    assert all('ROADMAP' in item for item in out['not_ported'].values())
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
                       ('BENCH_PIPELINE_DETERMINISM', 0),
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
    assert list(bench.CHILDREN) == ['imagenet', 'pipeline', 'imagenet_vit', 'lm', 'lm_long',
                                    'lm_moe', 'flashattn', 'imagenet_aug']
    assert bench.lm_rows(8193) == 256 and bench.lm_rows(1025) == 2048
