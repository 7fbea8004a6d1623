"""The sanitizer cell (``bench.run_imagenet_sanitize``, phase 30 of
``chip_smoke.py``) and its parts on the CPU, at a small size: the armed
in-order epoch equals the unarmed one, the seeded lock-order inversion
reaches the consumer and leaves no thread, and the whole cell's glue with the
training scan replaced by the same reader and loader. What only the card can
show (an arena recycled behind an in-flight copy, the stale view through a
copying loader) is named here and checked there."""

import threading

import numpy as np
import pytest
import torch

from petastorm_tpu.analysis import sanitize as jax_sanitize
from petastorm_tpu_torch import (CompressedImageCodec, ScalarCodec, TorchLoader, Unischema,
                                 UnischemaField, bench, faults, make_pod_reader, write_dataset)
from petastorm_tpu_torch import models as models_mod
from petastorm_tpu_torch.analysis import sanitize

ROWS, BATCH = 64, 4


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    schema = Unischema('SanitizeCell', [
        UnischemaField('image', np.uint8, (16, 16, 3), CompressedImageCodec('png'), False),
        UnischemaField('label', np.int64, (), ScalarCodec(np.int64), False)])
    rng = np.random.default_rng(30)
    url = 'file://' + str(tmp_path_factory.mktemp('sanitize') / 'images')
    write_dataset(url, schema, ({'image': rng.integers(0, 256, (16, 16, 3), dtype=np.uint8),
                                 'label': i} for i in range(ROWS)), rows_per_row_group=8)
    return url


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(bench, 'ROWS', ROWS)
    monkeypatch.setattr(bench, 'BATCH', BATCH)
    monkeypatch.delenv(faults.ENV_VAR, raising=False)
    monkeypatch.delenv(sanitize.ENV_VAR, raising=False)


def test_the_armed_epoch_equals_the_unarmed_one(store, small, monkeypatch):
    unarmed = bench.sanitize_epoch_digests(store, 'cpu')
    monkeypatch.setenv(sanitize.ENV_VAR, '1')
    armed = bench.sanitize_epoch_digests(store, 'cpu')
    assert len(unarmed) == ROWS // BATCH
    assert armed == unarmed


def test_the_seeded_inversion_reaches_the_consumer_and_leaves_no_thread(store, small,
                                                                       monkeypatch):
    monkeypatch.setattr(sanitize, '_inversion_pair', None)
    monkeypatch.setenv(sanitize.ENV_VAR, '1')
    out = bench.sanitize_seeded_bug(store, 'cpu', 'lock-order-invert')
    assert out['raised'] == 'LockOrderViolation', out
    assert out['threads_left'] == [] and out['batches_before'] == 0
    assert not faults.get_injector().active_sites
    monkeypatch.delenv(sanitize.ENV_VAR)
    monkeypatch.setattr(sanitize, '_inversion_pair', None)
    out = bench.sanitize_seeded_bug(store, 'cpu', 'lock-order-invert')
    assert out['raised'] is None and out['batches_before'] == ROWS // BATCH


def test_the_stale_view_needs_a_copying_loader(store, small, monkeypatch):
    """On the CPU an uncached reader's blocks reach the consumer as they are
    (no arena), so the seeded stale view has nothing to fire on: the epoch
    completes. Through the card's copying loader it raises (phase 30 (c));
    through the engine alone it raises here (``test_torch_pstlint.py``)."""
    monkeypatch.setenv(sanitize.ENV_VAR, '1')
    out = bench.sanitize_seeded_bug(store, 'cpu', 'arena-stale-view')
    assert out['raised'] is None and out['threads_left'] == []


def test_sanitize_cell_glue_on_the_cpu(store, small, monkeypatch):
    """The cell on the CPU with the training scan replaced by the same reader
    and loader and the step by a stand-in: every check runs; the only
    failure is the one that needs the card's copying loader."""
    def scan(url, device, train, state, warmup, calls, kernels, workers=4, loader_kwargs=None,
             **_):
        reader = make_pod_reader(url, pod_shard=(0, 1), schema_fields=['image', 'label'],
                                 reader_pool_type='thread', workers_count=workers,
                                 shuffle_row_groups=True, seed=0, num_epochs=None,
                                 cache_type='memory')
        with reader:
            with TorchLoader(reader, bench.BATCH, device='cpu', prefetch=bench.SCAN_PREFETCH,
                             **(loader_kwargs or {})) as loader:
                groups = loader.superbatches(bench.SCAN_K)
                for _ in range(warmup + 2 * calls):
                    next(groups)
        return ({'img_per_s': 1.0, 'device_step_ms': 1.0, 'input_stall_frac': 0.0},
                ({}, {}, {'normalize_kernel': 0}, 0))

    monkeypatch.setattr(bench, 'stream_classifier_scan', scan)
    monkeypatch.setattr(bench, 'require_scan_launches', lambda *args: None)
    monkeypatch.setattr(models_mod, 'make_scan_train_step',
                        lambda k, preprocess=None: lambda state, x, y: {'loss': torch.ones(())})
    monkeypatch.setattr(bench, 'SCAN_K', 2)
    monkeypatch.setattr(bench, 'SCAN_PREFETCH', 2)
    monkeypatch.setattr(sanitize, '_inversion_pair', None)
    before = {t.ident for t in threading.enumerate()}
    line = bench.run_imagenet_sanitize(store, torch.device('cpu'), 'cpu', None, warmup=1,
                                       calls=4)
    assert line['phase'] == 'imagenet_sanitize'
    assert line['failures'] == ['(c) arena-stale-view: the consumer got None, not '
                                'StaleViewError'], line['failures']
    assert line['poison_check']['digests_equal']
    assert line['sanitizer']['scan']['poisoned'] > 0
    assert line['sanitizer']['scan']['acquisitions'] > 0
    assert line['sanitizer']['after_seeded']['edges'] >= 1
    assert line['seeded']['lock-order-invert']['raised'] == 'LockOrderViolation'
    assert not sanitize.sanitize_active() and not faults.get_injector().active_sites
    left = [t.name for t in threading.enumerate()
            if t.ident not in before and t.name.startswith('pstt-') and t.is_alive()]
    assert left == []


def test_the_arming_variable_is_the_ports_own(monkeypatch):
    """``PSTT_SANITIZE`` arms the port and the JAX package's variable does
    not: each package reads its own."""
    monkeypatch.setenv(jax_sanitize.ENV_VAR, '1')
    monkeypatch.delenv(sanitize.ENV_VAR, raising=False)
    assert not sanitize.sanitize_active() and jax_sanitize.sanitize_active()
    monkeypatch.delenv(jax_sanitize.ENV_VAR)
    monkeypatch.setenv(sanitize.ENV_VAR, '1')
    assert sanitize.sanitize_active() and not jax_sanitize.sanitize_active()


def test_a_failed_phase_is_named_and_no_result_is_printed(monkeypatch, capsys):
    """``chip_smoke.py``: a phase that raises prints one line naming it (its
    elapsed seconds and the error's repr, at most 2,000 characters), then
    the failure propagates, so the exit code stays non-zero and no ``ok``
    line is printed."""
    import json
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    def run_phases(args, record, during, lines):
        record({'phase': 'device', 'name': 'stand-in'})
        during('imagenet_sanitize')
        raise AssertionError('imagenet_sanitize: ' + 'x' * 3000)

    monkeypatch.setattr(chip_smoke, 'run_phases', run_phases)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(sys, 'argv', ['chip_smoke.py'])
    with pytest.raises(AssertionError, match='imagenet_sanitize'):
        chip_smoke.main()
    out = [json.loads(line) for line in capsys.readouterr().out.splitlines()
           if line.startswith('{')]
    assert out[0]['phase'] == 'device' and 'elapsed_s' in out[0]
    failed = out[-1]
    assert failed['phase'] == 'failed' and failed['during'] == 'imagenet_sanitize'
    assert failed['elapsed_s'] >= 0 and len(failed['error']) == 2000
    assert failed['error'].startswith("AssertionError('imagenet_sanitize: ")
    assert not any('ok' in line for line in out)
