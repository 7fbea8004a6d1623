"""The port stands alone: it imports neither JAX nor the JAX package, its
CUDA entry points refuse to run without a GPU, and its threads end on
``close()``."""

import ast
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import petastorm_tpu_torch
from petastorm_tpu_torch import (CompressedImageCodec, ScalarCodec, TorchLoader, Unischema,
                                 UnischemaField, make_tensor_reader, write_dataset)
from petastorm_tpu_torch.device import resolve_device
from petastorm_tpu_torch.models import ResNet50, ResNetTiny, TransformerLM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.dirname(petastorm_tpu_torch.__file__)
BANNED_ROOTS = ('jax', 'jaxlib', 'flax', 'optax', 'orbax')


def _banned(module):
    return (module.split('.')[0] in BANNED_ROOTS or module == 'petastorm_tpu'
            or module.startswith('petastorm_tpu.'))


def _sources():
    for root, _, names in os.walk(PACKAGE):
        for name in names:
            if name.endswith('.py'):
                yield os.path.join(root, name)
    yield os.path.join(REPO, 'chip_smoke.py')


def test_importing_every_module_pulls_in_no_jax():
    code = (
        'import pkgutil, sys\n'
        'import petastorm_tpu_torch\n'
        'for m in pkgutil.walk_packages(petastorm_tpu_torch.__path__, "petastorm_tpu_torch."):\n'
        '    __import__(m.name)\n'
        'bad = sorted(m for m in sys.modules if m.split(".")[0] in {!r}\n'
        '             or m == "petastorm_tpu" or m.startswith("petastorm_tpu."))\n'
        'assert not bad, bad\n'
        'print("ok", len([m for m in sys.modules if m.startswith("petastorm_tpu_torch")]))\n'
    ).format(BANNED_ROOTS)
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith('ok ')


def test_no_source_imports_jax_or_the_jax_package():
    offenders = []
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or '']
            else:
                continue
            offenders.extend('{}:{} {}'.format(path, node.lineno, n) for n in names if _banned(n))
    assert not offenders
    assert not _banned('petastorm_tpu_torch') and _banned('petastorm_tpu.codecs')


def test_no_source_reads_the_jax_packages_environment():
    for path in _sources():
        with open(path) as f:
            assert 'PETASTORM_TPU_' not in f.read(), path


def test_cuda_entry_points_raise_without_a_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='is_available'):
        resolve_device('cuda')
    with pytest.raises(RuntimeError, match='is_available'):
        TorchLoader(iter(()), 4)    # device defaults to 'cuda'
    for build in (ResNetTiny, ResNet50):
        with pytest.raises(RuntimeError, match='is_available'):
            build(num_classes=10)   # device defaults to 'cuda'
    with pytest.raises(RuntimeError, match='is_available'):
        TransformerLM(64)           # device defaults to 'cuda'
    assert resolve_device('cpu') == torch.device('cpu')
    with pytest.raises(ValueError):
        resolve_device('meta')


def _store(tmp_path):
    schema = Unischema('ThreadSchema', [
        UnischemaField('image', np.uint8, (8, 8, 3), CompressedImageCodec('png')),
        UnischemaField('label', np.int64, (), ScalarCodec(np.int64)),
    ])
    rng = np.random.default_rng(0)
    url = 'file://' + str(tmp_path / 'store')
    write_dataset(url, schema, ({'image': rng.integers(0, 256, (8, 8, 3), dtype=np.uint8),
                                 'label': i} for i in range(64)), rows_per_row_group=8)
    return url


def _port_threads():
    return [t.name for t in threading.enumerate() if t.name.startswith('pstt-')]


def test_loader_refuses_prefetch_below_one():
    # prefetch=0 is consumer staging (no staging threads); below it is an error.
    with pytest.raises(ValueError, match='prefetch'):
        TorchLoader(iter(()), 4, device='cpu', prefetch=-1)


@pytest.mark.parametrize('prefetch', [1, 2])
def test_no_port_thread_survives_close(tmp_path, prefetch):
    url = _store(tmp_path)
    reader = make_tensor_reader(url, workers_count=3, num_epochs=None, seed=1)
    loader = TorchLoader(reader, 5, device='cpu', prefetch=prefetch)
    batches = [next(loader) for _ in range(7)]     # a batch spans chunks: arena path
    assert _port_threads()
    assert all(tuple(b.image.shape) == (5, 8, 8, 3) and b.label.dtype == torch.int64
               for b in batches)
    loader.close()
    reader.stop()
    reader.join()
    assert _port_threads() == []
    with pytest.raises(RuntimeError, match='closed'):
        next(loader)
