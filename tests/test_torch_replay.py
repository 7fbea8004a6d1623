"""The replay tool of the port against the JAX package's
(``petastorm_tpu/tools/replay.py``; ``tests/test_lineage.py:285``,
``tests/test_determinism.py:859``): on ledgers written by either package's
loader over one store, both tools give the same exit codes (0 replayed, 1
a lookup or usage error, 2 not replayable, 3 a digest mismatch) and the
same output (the summary, ``--print-record``, ``--out``'s arrays), and
``--diff-ledgers`` reports the same first divergent batch id. The store's
fields (int32, float32) batch alike in both packages, so one package's
records replay bit for bit through the other's tool."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from petastorm_tpu import make_tensor_reader as jax_make_tensor_reader
from petastorm_tpu.jax_loader import JaxLoader
from petastorm_tpu.tools import replay as jax_replay
from petastorm_tpu_torch import (NdarrayCodec, ScalarCodec, TorchLoader, Unischema,
                                 UnischemaField, make_tensor_reader, write_dataset)
from petastorm_tpu_torch.lineage import read_ledger_dir
from petastorm_tpu_torch.tools import replay

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, PER_GROUP, BATCH = 64, 8, 16
TOOLS = (replay, jax_replay)


@pytest.fixture(scope='module')
def url(tmp_path_factory):
    schema = Unischema('ReplaySchema', [
        UnischemaField('id', np.int32, (), ScalarCodec(np.int32), False),
        UnischemaField('vec', np.float32, (4,), NdarrayCodec(), False)])
    rng = np.random.default_rng(21)
    url = 'file://' + str(tmp_path_factory.mktemp('replay') / 'ds')
    write_dataset(url, schema, ({'id': i, 'vec': rng.random(4, dtype=np.float32)}
                                for i in range(ROWS)), rows_per_row_group=PER_GROUP)
    return url


def _ledger(package, url, directory, loader_kwargs=None, **reader_kwargs):
    """Drain one package's loader with its ledger in ``directory``."""
    kwargs = dict({'workers_count': 2, 'seed': 3, 'num_epochs': 1}, **reader_kwargs)
    loader_kwargs = dict(loader_kwargs or {}, lineage=str(directory))
    if package == 'port':
        with make_tensor_reader(url, **kwargs) as reader:
            with TorchLoader(reader, BATCH, device='cpu', **loader_kwargs) as loader:
                batches = sum(1 for _ in loader)
    else:
        with jax_make_tensor_reader(url, **kwargs) as reader:
            with JaxLoader(reader, BATCH, **loader_kwargs) as loader:
                batches = sum(1 for _ in loader)
    assert batches == ROWS // BATCH
    return str(directory)


@pytest.fixture(scope='module')
def ledgers(url, tmp_path_factory):
    root = tmp_path_factory.mktemp('ledgers')
    return {package: _ledger(package, url, root / package) for package in ('port', 'jax')}


def _run(tool, argv, capsys):
    code = tool.main(argv)
    captured = capsys.readouterr()
    return code, captured.out, captured.err


@pytest.mark.parametrize('writer', ['port', 'jax'])
@pytest.mark.parametrize('batch_id', [0, 3])
def test_verify_replays_either_packages_record_alike(ledgers, writer, batch_id, capsys,
                                                    tmp_path):
    outputs, arrays = [], []
    for tool in TOOLS:
        out = str(tmp_path / '{}.npz'.format(tool.__name__))
        code, stdout, _ = _run(tool, ['--ledger', ledgers[writer], '--batch-id', str(batch_id),
                                      '--verify', '--out', out], capsys)
        assert code == 0
        summary = json.loads(stdout)
        assert summary.pop('out') == out
        outputs.append(summary)
        with np.load(out) as npz:
            arrays.append({name: npz[name] for name in npz.files})
    assert outputs[0] == outputs[1]
    assert outputs[0]['verified'] and outputs[0]['rows'] == BATCH
    assert sorted(arrays[0]) == sorted(arrays[1]) == ['id', 'vec']
    for name in arrays[0]:
        assert arrays[0][name].dtype == arrays[1][name].dtype
        assert arrays[0][name].tobytes() == arrays[1][name].tobytes()


def test_print_record_and_a_ledger_file_alike(ledgers, capsys):
    (path, _, records), = read_ledger_dir(ledgers['port'])
    outputs = []
    for tool in TOOLS:
        outputs.append(_run(tool, ['--ledger', ledgers['port'], '--batch-id', '1',
                                   '--print-record'], capsys))
        outputs.append(_run(tool, ['--ledger', path, '--batch-id', '2'], capsys))
    assert outputs[0] == outputs[2] and outputs[1] == outputs[3]
    assert outputs[0][0] == 0 and json.loads(outputs[0][1])['record']['batch_id'] == 1
    assert json.loads(outputs[1][1])['batch_id'] == 2


def test_lookup_errors_exit_1_alike(ledgers, capsys, tmp_path):
    (path, _, _), = read_ledger_dir(ledgers['port'])
    for argv, words in ((['--ledger', ledgers['port'], '--batch-id', '999'], 'batch ids'),
                        (['--ledger', path, '--batch-id', '999'], 'not in'),
                        (['--ledger', str(tmp_path / 'none'), '--batch-id', '0'], 'not found')):
        results = [_run(tool, argv, capsys) for tool in TOOLS]
        assert [r[0] for r in results] == [1, 1]
        assert all(words in r[2] for r in results), results
    for tool in TOOLS:
        with pytest.raises(SystemExit) as usage:
            tool.main(['--batch-id', '0'])
        assert usage.value.code == 2


def test_an_inexact_record_is_not_replayable_alike(url, tmp_path, capsys):
    ledger = _ledger('port', url, tmp_path / 'shuffled',
                     loader_kwargs={'shuffling_queue_capacity': 32, 'seed': 1})
    results = [_run(tool, ['--ledger', ledger, '--batch-id', '0', '--verify'], capsys)
               for tool in TOOLS]
    assert [r[0] for r in results] == [2, 2]
    assert all('not replayable' in r[2] for r in results)


def test_a_tampered_digest_is_a_mismatch_alike(ledgers, tmp_path, capsys):
    (path, _, _), = read_ledger_dir(ledgers['jax'])
    tampered = str(tmp_path / os.path.basename(path))
    with open(path) as src, open(tampered, 'w') as dst:
        for line in src:
            record = json.loads(line)
            if record.get('batch_id') == 1:
                record['digest']['vec'] = '00000000'
            dst.write(json.dumps(record) + '\n')
    results = [_run(tool, ['--ledger', tampered, '--batch-id', '1', '--verify'], capsys)
               for tool in TOOLS]
    assert [r[0] for r in results] == [3, 3]
    assert all('DIGEST MISMATCH' in r[2] for r in results)


@pytest.fixture(scope='module')
def deterministic_ledgers(url, tmp_path_factory):
    root = tmp_path_factory.mktemp('det')
    return {name: _ledger(package, url, root / name, deterministic=True, seed=seed,
                          workers_count=workers)
            for name, package, seed, workers in (('a', 'port', 7, 2), ('b', 'port', 7, 3),
                                                 ('c', 'port', 8, 2), ('jax_a', 'jax', 7, 1))}


@pytest.mark.parametrize('pair,code', [(('a', 'b'), 0), (('a', 'jax_a'), 0), (('a', 'c'), 3),
                                       (('jax_a', 'c'), 3)])
def test_diff_ledgers_reports_the_first_divergence_alike(deterministic_ledgers, pair, code,
                                                         capsys):
    paths = [deterministic_ledgers[name] for name in pair]
    results = [_run(tool, ['--diff-ledgers'] + paths, capsys) for tool in TOOLS]
    assert results[0] == results[1]
    assert results[0][0] == code
    report = json.loads(results[0][1])
    assert report['common_batches'] == ROWS // BATCH
    if code:
        assert report['diverged'] == 0 and report['divergence']['fields_differing']
    else:
        assert report['diverged'] is None


def test_diff_ledgers_with_an_empty_side_exits_1_alike(deterministic_ledgers, tmp_path, capsys):
    argv = ['--diff-ledgers', deterministic_ledgers['a'], str(tmp_path / 'empty')]
    results = [_run(tool, argv, capsys) for tool in TOOLS]
    assert [r[0] for r in results] == [1, 1] and results[0][2] == results[1][2]


def test_replay_runs_as_a_module(ledgers):
    result = subprocess.run([sys.executable, '-m', 'petastorm_tpu_torch.tools.replay', '--ledger',
                             ledgers['jax'], '--batch-id', '1', '--verify'], cwd=REPO,
                            capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr
    assert json.loads(result.stdout)['verified']
