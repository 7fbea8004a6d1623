"""The throughput harness and the hello-world example of the port, beside
the JAX package's (``petastorm_tpu/benchmark/``, ``examples/hello_world/``).

``reader_throughput`` measures both read methods on a stored dataset and,
unlike the JAX harness (whose readers refuse it), a plain store through
``make_batch_reader``; without psutil it still measures, with no RSS or
CPU share. The example's store holds the JAX example's rows, and its reads
run end to end with ``device='cpu'``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu.benchmark import reader_throughput as jax_reader_throughput
from petastorm_tpu_torch import make_reader
from petastorm_tpu_torch.benchmark import BenchmarkResult, reader_throughput
from petastorm_tpu_torch.examples import hello_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize('read_method', ['python', 'torch'])
def test_reader_throughput_on_a_stored_dataset(synthetic_dataset, read_method):
    fields = ['id', 'matrix'] if read_method == 'torch' else None
    result = reader_throughput(synthetic_dataset.url, field_regex=fields, warmup_cycles_count=10,
                               measure_cycles_count=40, read_method=read_method,
                               loaders_count=2, shuffling_queue_size=0, min_after_dequeue=0,
                               torch_batch_size=8, device='cpu')
    assert isinstance(result, BenchmarkResult)
    assert result.samples_per_second > 0 and result.time_mean > 0
    assert result.memory_rss_mb > 0 and result.cpu_percent is not None


@pytest.mark.parametrize('read_method', ['python', 'torch'])
def test_reader_throughput_on_a_plain_store(scalar_dataset, read_method):
    result = reader_throughput(scalar_dataset.url, field_regex=['id', 'list_col'],
                               warmup_cycles_count=20, measure_cycles_count=100,
                               read_method=read_method, shuffling_queue_size=0,
                               min_after_dequeue=0, torch_batch_size=10, device='cpu')
    assert result.samples_per_second > 0
    with pytest.raises(RuntimeError, match='make_batch_reader'):
        jax_reader_throughput(scalar_dataset.url, warmup_cycles_count=1, measure_cycles_count=1)


def test_reader_throughput_without_psutil(scalar_dataset, monkeypatch):
    monkeypatch.setitem(sys.modules, 'psutil', None)
    result = reader_throughput(scalar_dataset.url, warmup_cycles_count=5,
                               measure_cycles_count=20)
    assert result.memory_rss_mb is None and result.cpu_percent is None
    assert result.samples_per_second > 0
    with pytest.raises(ValueError, match='read_method'):
        reader_throughput(scalar_dataset.url, read_method='jax')


def test_throughput_cli(scalar_dataset):
    out = subprocess.run([sys.executable, '-m', 'petastorm_tpu_torch.benchmark.cli',
                          scalar_dataset.url, '-w', '10', '-m', '50', '-d', 'torch',
                          '--device', 'cpu', '-q', '0', '--min-after-dequeue', '0'],
                         capture_output=True, text=True, env=dict(os.environ, PYTHONPATH=REPO),
                         timeout=180)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith('samples/sec: ')


def test_hello_world_store_holds_the_jax_examples_rows(tmp_path, monkeypatch):
    monkeypatch.syspath_prepend(REPO)
    from examples.hello_world.generate_dataset import \
        generate_hello_world_dataset as jax_generate
    port_url, jax_url = 'file://' + str(tmp_path / 'port'), 'file://' + str(tmp_path / 'jax')
    hello_world.generate_hello_world_dataset(port_url, rows_count=12)
    jax_generate(jax_url, rows_count=12)
    with make_reader(port_url, reader_pool_type='dummy', shuffle_row_groups=False) as reader:
        port = [r._asdict() for r in reader]
    with jax_make_reader(jax_url, reader_pool_type='dummy', shuffle_row_groups=False) as reader:
        jax = [r._asdict() for r in reader]
    assert len(port) == len(jax) == 12
    for a, b in zip(port, jax):
        assert a['id'] == b['id']
        assert np.array_equal(a['image1'], b['image1'])
        assert np.array_equal(a['array_4d'], b['array_4d'])


def test_hello_world_example_runs(tmp_path, capsys):
    assert hello_world.main(['--dataset-url', 'file://' + str(tmp_path / 'hw'),
                             '--device', 'cpu']) == 0
    out = capsys.readouterr().out
    assert 'row 0 (128, 256, 3) (4, 128, 30, 3)' in out
    assert 'card batch (8, 128, 256, 3) torch.uint8 cpu' in out
    assert 'read 100 rows in columnar batches; converter batch (16,) torch.float32' in out
