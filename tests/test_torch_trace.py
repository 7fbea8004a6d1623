"""Tracing of the port against the JAX package's (``tests/test_trace.py``):
``Tracer.summary`` on the same durations, ``PSTT_TRACE_DIR``'s grammar, the
bounded ring and sidecar, the Chrome export (``process_name`` and the
port's ``thread_name`` metadata), sidecars written by child processes of
either package merged alike by both packages' ``merge_process_files`` and
``trace_merge`` command lines (torn and corrupt lines included), and the
span names of the loaders and the workers on one store. Summaries, counts
and names are compared exactly; timestamps of one merge against the other
within a microsecond (each merge shifts onto its own tracer's anchor)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from petastorm_tpu import make_tensor_reader as jax_make_tensor_reader
from petastorm_tpu import trace as jax_trace
from petastorm_tpu.jax_loader import JaxLoader
from petastorm_tpu.tools import trace_merge as jax_trace_merge
from petastorm_tpu_torch import (NdarrayCodec, ScalarCodec, TorchLoader, Unischema,
                                 UnischemaField, make_tensor_reader, trace, write_dataset)
from petastorm_tpu_torch.tools import trace_merge

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _durations_us(seed, n):
    rng = np.random.default_rng(seed)
    return [float(x) for x in np.round(rng.lognormal(7, 1.5, n), 3)]


@pytest.mark.parametrize('seed,n', [(0, 1), (1, 7), (2, 100), (3, 1001)])
def test_summary_equals_the_jax_packages_on_the_same_durations(seed, n):
    summaries = []
    for mod in (trace, jax_trace):
        tracer = mod.Tracer(spill_dir=False)
        for i, dur in enumerate(_durations_us(seed, n)):
            tracer._append({'name': ('decode', 'read', 'wait')[i % 3], 'cat': 'x', 'ph': 'X',
                            'ts': float(i), 'dur': dur, 'pid': 1, 'tid': 1})
        tracer.instant('not-a-span')
        tracer.counter('arena_pool_free', 3)
        summaries.append(tracer.summary())
    assert summaries[0] == summaries[1]
    assert sum(s['count'] for s in summaries[0].values()) == n


def test_spans_instants_and_counters():
    tracer = trace.Tracer(spill_dir=False)
    with tracer.span('decode', 'worker'):
        pass
    tracer.instant('mark', args={'k': 1})
    tracer.counter('staging_inflight', 2, 'staging')
    events = tracer.events
    assert [e['ph'] for e in events] == ['X', 'i', 'C']
    assert events[1]['args'] == {'k': 1} and events[2]['args'] == {'staging_inflight': 2}
    assert {e['pid'] for e in events} == {os.getpid()}
    assert tracer.summary()['decode']['count'] == 1


@pytest.mark.parametrize('value', [None, '', '/tmp/pstt-trace-never-written'])
@pytest.mark.parametrize('spill_dir', [None, False])
def test_trace_dir_variable_parses_as_the_jax_packages(monkeypatch, value, spill_dir):
    dirs = []
    for mod in (trace, jax_trace):
        if value is None:
            monkeypatch.delenv(mod.TRACE_DIR_ENV, raising=False)
        else:
            monkeypatch.setenv(mod.TRACE_DIR_ENV, value)
        dirs.append(mod.Tracer(spill_dir=spill_dir)._spill_dir)
        dirs.append(mod.install_worker_tracer() is not None)
        mod.set_global_tracer(None)
    assert dirs[:2] == dirs[2:]
    assert trace.TRACE_DIR_ENV == 'PSTT_TRACE_DIR' != jax_trace.TRACE_DIR_ENV
    assert trace._HEADER_KEY == jax_trace._HEADER_KEY


def test_ring_and_sidecar_are_bounded_alike(tmp_path):
    kept = []
    for mod in (trace, jax_trace):
        d = str(tmp_path / mod.__name__)
        tracer = mod.Tracer(max_events=5, spill_dir=d, spill_max_events=3)
        for i in range(10):
            tracer.instant('e{}'.format(i))
        tracer.close()
        header, events = mod.read_sidecar_file(tracer.spill_path)
        kept.append(([e['name'] for e in tracer.events], [e['name'] for e in events],
                     sorted(header)))
    assert kept[0] == kept[1]
    assert kept[0][1] == ['e0', 'e1', 'e2', 'trace-spill-truncated']
    assert kept[0][0] == ['e5', 'e6', 'e7', 'e8', 'e9']


def test_chrome_export_is_atomic_and_labels_processes_and_threads(tmp_path):
    tracer = trace.Tracer(spill_dir=False, role='unit')
    with tracer.span('assemble', 'host'):
        pass
    path = str(tmp_path / 'trace.json')
    assert tracer.export_chrome_trace(path) == path
    assert os.listdir(str(tmp_path)) == ['trace.json']
    doc = json.load(open(path))
    meta = [e for e in doc['traceEvents'] if e['ph'] == 'M']
    assert {m['name'] for m in meta} == {'process_name', 'thread_name'}
    assert any(m['args']['name'] == 'unit (pid {})'.format(os.getpid()) for m in meta)
    assert any(m['name'] == 'thread_name' and m['args']['name'] == 'MainThread' for m in meta)
    assert doc['displayTimeUnit'] == 'ms'


def test_null_tracer_is_a_no_op():
    null = trace.NullTracer()
    with null.span('x'):
        pass
    null.instant('y')
    null.counter('z', 1)
    null.close()
    assert trace.get_global_tracer().__class__ is trace.NullTracer


_CHILD = (
    "import os, sys\n"
    "sys.path.insert(0, {root!r})\n"
    "from {module} import Tracer\n"
    "t = Tracer(role={role!r})\n"
    "for i, dur in enumerate({durs!r}):\n"
    "    t._append({{'name': 'decode', 'cat': 'worker', 'ph': 'X', 'ts': i * 10.0,\n"
    "               'dur': dur, 'pid': os.getpid(), 'tid': 7}})\n"
    "t.instant('fault:fs-read-delay', cat='fault')\n"
    "t.close()\n")


@pytest.fixture(scope='module')
def sidecars(tmp_path_factory):
    """One sidecar written by a child process of each package, a torn tail on
    the port's and a corrupt sidecar beside them."""
    d = str(tmp_path_factory.mktemp('sidecars'))
    env = dict(os.environ, PSTT_TRACE_DIR=d)
    env[jax_trace.TRACE_DIR_ENV] = d
    children = [subprocess.Popen([sys.executable, '-c', _CHILD.format(
        root=REPO, module=module, role=role, durs=_durations_us(seed, 20))], env=env)
        for module, role, seed in (('petastorm_tpu_torch.trace', 'port-worker', 4),
                                   ('petastorm_tpu.trace', 'jax-worker', 5))]
    assert [child.wait(timeout=120) for child in children] == [0, 0]
    files = sorted(os.listdir(d))
    assert len(files) == 2
    port_file = next(f for f in files
                     if trace.read_sidecar_file(os.path.join(d, f))[0]['role'] == 'port-worker')
    with open(os.path.join(d, port_file), 'a') as f:
        f.write('{"name": "torn-eve')
    with open(os.path.join(d, 'trace-999-deadbeef.jsonl'), 'w') as f:
        f.write('not json at all\n')
        f.write(json.dumps({'name': 'late', 'ph': 'i', 'ts': 1.0, 'pid': 999, 'tid': 1}) + '\n')
    return d


def test_either_packages_sidecars_merge_alike(sidecars):
    merged = []
    for mod in (trace, jax_trace):
        parent = mod.Tracer(spill_dir=False)
        assert parent.merge_process_files(sidecars) == 3
        absolute = sorted((e['name'], e['ph'], e.get('dur'), e.get('pid'), e.get('tid'),
                           round(e['ts'] + parent.wall0 * 1e6)) for e in parent.events)
        merged.append((absolute, parent.summary(), sorted(parent._roles.values())))
    assert merged[0][1] == merged[1][1] and merged[0][2] == merged[1][2]
    assert [e[:5] for e in merged[0][0]] == [e[:5] for e in merged[1][0]]
    # A sidecar without a header has no anchor: its events keep their ts.
    assert all(abs(a[5] - b[5]) <= 1 for a, b in zip(merged[0][0], merged[1][0])
               if a[3] != 999)
    assert merged[0][1]['decode']['count'] == 40
    assert merged[0][2] == ['jax-worker', 'port-worker']
    names = [e[0] for e in merged[0][0]]
    assert 'late' in names and not any('torn' in n for n in names)


def test_merge_since_wall0_skips_an_earlier_run(tmp_path):
    d = str(tmp_path / 'spill')
    old = trace.Tracer(spill_dir=d, role='previous-run')
    old._wall0 -= 3600.0
    with old.span('decode', 'worker'):
        pass
    old.close()
    fresh = trace.Tracer(spill_dir=d, role='current-run')
    with fresh.span('decode', 'worker'):
        pass
    fresh.close()
    for mod in (trace, jax_trace):
        assert mod.Tracer(spill_dir=False).merge_process_files(
            d, since_wall0=fresh.wall0 - 60) == 1
        assert mod.Tracer(spill_dir=False).merge_process_files(d) == 2


def test_merge_without_a_directory_raises(monkeypatch):
    monkeypatch.delenv(trace.TRACE_DIR_ENV, raising=False)
    with pytest.raises(ValueError, match='spill directory'):
        trace.Tracer(spill_dir=False).merge_process_files()


def test_trace_merge_command_lines_agree(sidecars, tmp_path, capsys):
    reports = []
    for mod in (trace_merge, jax_trace_merge):
        out = str(tmp_path / '{}.json'.format(mod.__name__))
        assert mod.main(['--dir', sidecars, '--out', out, '--summary']) == 0
        report = json.loads(capsys.readouterr().out)
        assert report.pop('out') == out
        doc = json.load(open(out))
        reports.append((report, sorted(e['name'] for e in doc['traceEvents'] if e['ph'] != 'M')))
    assert reports[0] == reports[1]
    assert reports[0][0]['merged_files'] == 3 and reports[0][0]['summary']['decode']['count'] == 40
    empty = str(tmp_path / 'empty')
    os.makedirs(empty)
    for mod in (trace_merge, jax_trace_merge):
        assert mod.main(['--dir', empty]) == 1
        assert 'no sidecar files' in capsys.readouterr().err
        with pytest.raises(SystemExit) as usage:
            mod.main(['--dir', str(tmp_path / 'missing')])
        assert usage.value.code == 2


def test_trace_merge_runs_as_a_module(sidecars, tmp_path):
    out = str(tmp_path / 'merged.json')
    result = subprocess.run([sys.executable, '-m', 'petastorm_tpu_torch.tools.trace_merge',
                             '--dir', sidecars, '--out', out], cwd=REPO, capture_output=True,
                            text=True, timeout=120)
    assert result.returncode == 0, result.stderr
    assert json.loads(result.stdout)['merged_files'] == 3
    assert any(e.get('name') == 'decode' for e in json.load(open(out))['traceEvents'])


# -- the pipeline's spans -------------------------------------------------------

@pytest.fixture(scope='module')
def url(tmp_path_factory):
    schema = Unischema('TraceSchema', [
        UnischemaField('id', np.int32, (), ScalarCodec(np.int32), False),
        UnischemaField('vec', np.float32, (4,), NdarrayCodec(), False)])
    url = 'file://' + str(tmp_path_factory.mktemp('trace') / 'ds')
    write_dataset(url, schema, [{'id': i, 'vec': np.full(4, i, np.float32)} for i in range(60)],
                  rows_per_row_group=10)
    return url


def _span_names(tracer):
    return {e['name'] for e in tracer.events if e['ph'] == 'X'}


@pytest.mark.parametrize('prefetch', [0, 2])
def test_loader_and_worker_spans_are_the_jax_packages(url, prefetch):
    """The loader's spans (``tracer=``) and the workers' (the global tracer)
    carry the JAX package's names."""
    names = {}
    for package in ('port', 'jax'):
        mod = trace if package == 'port' else jax_trace
        tracer = mod.Tracer(spill_dir=False)
        previous = mod.set_global_tracer(tracer)
        try:
            if package == 'port':
                with make_tensor_reader(url, workers_count=2, shuffle_row_groups=False) as reader:
                    with TorchLoader(reader, 10, device='cpu', tracer=tracer,
                                     prefetch=prefetch) as loader:
                        batches = sum(1 for _ in loader)
            else:
                with jax_make_tensor_reader(url, workers_count=2,
                                            shuffle_row_groups=False) as reader:
                    with JaxLoader(reader, 10, tracer=tracer, prefetch=prefetch) as loader:
                        batches = sum(1 for _ in loader)
        finally:
            mod.set_global_tracer(previous)
        assert batches == 6
        names[package] = _span_names(tracer)
    assert names['port'] == names['jax']
    expected = {'read', 'decode', 'handoff', 'assemble', 'stage'}
    expected |= {'wait', 'dispatch'} if prefetch else set()
    assert names['port'] == expected
