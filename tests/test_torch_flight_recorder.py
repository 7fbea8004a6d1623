"""The flight recorder of the port against the JAX package's
(``tests/test_metrics.py:303-360``, ``tests/test_chaos.py:1182``,
``tests/test_lineage.py:480``): a dump's file set and ``diagnosis.json``
keys on a synthetic diagnosis, on a stall injected into each package's
loader (``device-put-delay``) and on a memory-governor breach, and the
live provenance rings in ``lineage.json``. File sets and keys are compared
exactly."""

import json
import os

import numpy as np
import pytest

from petastorm_tpu import faults as jax_faults
from petastorm_tpu import flight_recorder as jax_flight
from petastorm_tpu import make_tensor_reader as jax_make_tensor_reader
from petastorm_tpu import membudget as jax_membudget
from petastorm_tpu import metrics as jax_metrics
from petastorm_tpu import trace as jax_trace
from petastorm_tpu.errors import PipelineStallError as JaxPipelineStallError
from petastorm_tpu.jax_loader import JaxLoader
from petastorm_tpu_torch import (NdarrayCodec, ScalarCodec, TorchLoader, Unischema,
                                 UnischemaField, faults, flight_recorder, make_tensor_reader,
                                 membudget, metrics, trace, write_dataset)
from petastorm_tpu_torch.errors import PipelineStallError

STALL_FILES = {'trace.json', 'metrics.prom', 'metrics_ring.json', 'diagnosis.json', 'stacks.txt',
               'lineage.json'}


@pytest.fixture(scope='module')
def url(tmp_path_factory):
    schema = Unischema('FlightSchema', [
        UnischemaField('id', np.int32, (), ScalarCodec(np.int32), False),
        UnischemaField('vec', np.float32, (4,), NdarrayCodec(), False)])
    url = 'file://' + str(tmp_path_factory.mktemp('flight') / 'ds')
    write_dataset(url, schema, [{'id': i, 'vec': np.full(4, i, np.float32)} for i in range(80)],
                  rows_per_row_group=10)
    return url


@pytest.fixture
def registries():
    previous = (metrics.set_registry(metrics.MetricsRegistry()),
                jax_metrics.set_registry(jax_metrics.MetricsRegistry()))
    try:
        yield metrics.get_registry(), jax_metrics.get_registry()
    finally:
        metrics.set_registry(previous[0])
        jax_metrics.set_registry(previous[1])


def _read_dump(path):
    files = set(os.listdir(path))
    with open(os.path.join(path, 'diagnosis.json')) as f:
        diagnosis = json.load(f)
    with open(os.path.join(path, 'trace.json')) as f:
        doc = json.load(f)
    with open(os.path.join(path, 'lineage.json')) as f:
        rings = json.load(f)
    return files, diagnosis, doc, rings


def test_a_dump_holds_the_jax_packages_files(tmp_path, registries):
    dumps = []
    for mod, trace_mod, registry in ((flight_recorder, trace, registries[0]),
                                     (jax_flight, jax_trace, registries[1])):
        registry.counter('pst_fr_total').inc(3)
        tracer = trace_mod.Tracer(spill_dir=False)
        with tracer.span('decode', 'worker'):
            pass
        recorder = mod.FlightRecorder(str(tmp_path / mod.__name__), tracer=tracer,
                                      sample_min_interval_s=0.0)
        assert recorder.sample()
        diagnosis = {'classification': 'dispatch-hung', 'stage': 'dispatch',
                     'detail': 'synthetic', 'beats': {}, 'probes': {'x': np.int64(3)},
                     'stacks': 'Thread MainThread (1):\n  fake frame'}
        path = recorder.dump(diagnosis, reason='dispatch-hung')
        assert path is not None and recorder.dumps == [path]
        name = os.path.basename(path)
        assert name.startswith(mod.DUMP_DIR_PREFIX) and '-dispatch-hung-' in name
        files, diag, doc, rings = _read_dump(path)
        assert any(e.get('name') == 'decode' for e in doc['traceEvents'])
        assert 'pst_fr_total 3' in open(os.path.join(path, 'metrics.prom')).read()
        ring = json.load(open(os.path.join(path, 'metrics_ring.json')))
        assert ring and 'pst_fr_total' in ring[0]['metrics']
        assert 'fake frame' in open(os.path.join(path, 'stacks.txt')).read()
        dumps.append((files, diag))
    assert dumps[0] == dumps[1]
    assert dumps[0][0] == STALL_FILES
    assert 'stacks' not in dumps[0][1]
    assert flight_recorder.DUMP_DIR_PREFIX == jax_flight.DUMP_DIR_PREFIX


def test_sampling_is_throttled(registries):
    recorder = flight_recorder.FlightRecorder('/nonexistent', sample_min_interval_s=60.0)
    assert recorder.sample()
    assert not recorder.sample()


def test_the_variable_arms_a_recorder(monkeypatch, tmp_path):
    for value, armed in ((None, False), ('', False), ('  ', False), (str(tmp_path), True)):
        outcomes = []
        for mod in (flight_recorder, jax_flight):
            if value is None:
                monkeypatch.delenv(mod.ENV_VAR, raising=False)
            else:
                monkeypatch.setenv(mod.ENV_VAR, value)
            recorder = mod.maybe_from_env()
            outcomes.append(None if recorder is None else recorder.base_dir)
        assert outcomes[0] == outcomes[1]
        assert (outcomes[0] is not None) == armed
    assert flight_recorder.ENV_VAR == 'PSTT_FLIGHT_RECORDER' != jax_flight.ENV_VAR


@pytest.mark.timeout(60)
def test_an_injected_stall_leaves_the_jax_packages_dump(url, tmp_path, monkeypatch, registries):
    seen = {}
    for package in ('port', 'jax'):
        fault_mod = faults if package == 'port' else jax_faults
        flight_mod = flight_recorder if package == 'port' else jax_flight
        monkeypatch.setenv(flight_mod.ENV_VAR, str(tmp_path / package))
        monkeypatch.setenv(fault_mod.ENV_VAR, 'device-put-delay:delay=1.5:max=1')
        trace_mod = trace if package == 'port' else jax_trace
        tracer = trace_mod.Tracer(spill_dir=False)
        previous = trace_mod.set_global_tracer(tracer)     # the fault's instant
        if package == 'port':
            reader = make_tensor_reader(url, workers_count=2, shuffle_row_groups=False)
            loader = TorchLoader(reader, 10, device='cpu', watchdog=True, stall_timeout_s=0.3,
                                 lineage=str(tmp_path / 'ledger'), tracer=tracer)
            error_type = PipelineStallError
        else:
            reader = jax_make_tensor_reader(url, workers_count=2, shuffle_row_groups=False)
            loader = JaxLoader(reader, 10, watchdog=True, stall_timeout_s=0.3,
                               lineage=str(tmp_path / 'jax-ledger'), tracer=tracer)
            error_type = JaxPipelineStallError
        try:
            with pytest.raises(error_type) as raised:
                for _ in loader:
                    pass
            stats = loader.stats['watchdog']
        finally:
            trace_mod.set_global_tracer(previous)
            monkeypatch.delenv(fault_mod.ENV_VAR)
            loader.close() if package == 'port' else loader.stop()
            reader.stop()
            reader.join()
        path = raised.value.diagnosis.get('flight_dump')
        assert path and os.path.isdir(path) and path.startswith(str(tmp_path / package))
        assert stats['flight_dumps'] == [path]
        files, diagnosis, doc, rings = _read_dump(path)
        stacks = open(os.path.join(path, 'stacks.txt')).read()
        thread = 'pstt-staging-dispatch' if package == 'port' else 'pst-staging-dispatch'
        section = stacks.split('Thread {} '.format(thread))[1].split('\nThread ')[0]
        assert 'time.sleep' in section or 'sleep(' in section
        assert any(e.get('name') == 'stall-hard:dispatch-hung' for e in doc['traceEvents'])
        assert any(e.get('name') == 'fault:device-put-delay' for e in doc['traceEvents'])
        assert len(rings) >= 1 and {'ctx', 'records', 'in_flight'} <= set(rings[0])
        seen[package] = (files, sorted(diagnosis), diagnosis['classification'],
                         sorted(diagnosis['beats']), sorted(diagnosis['probes']))
    assert seen['port'][:3] == seen['jax'][:3]
    assert seen['port'][0] == STALL_FILES and seen['port'][2] == 'dispatch-hung'
    # The beats and probes the watchdog saw: the JAX loader's, less its
    # autotuner's, plus the port's arena-pool probe.
    assert set(seen['port'][3]) == set(seen['jax'][3])
    assert set(seen['jax'][4]) <= set(seen['port'][4])


def _breach(mod):
    gov = mod.MemoryGovernor(budget=1000)
    gov._arm_count += 1
    gov.register_pool('prefetch-queue', lambda: 5000)
    gov.register_pool('arena-pool', lambda: 10)
    errors = []
    gov.add_breach_sink(errors.append)
    state = gov.check(now=0.0)
    gov.release()
    return state, errors[0]


def test_a_breach_leaves_the_jax_packages_dump(tmp_path, monkeypatch, registries):
    seen = []
    for mod, flight_mod in ((membudget, flight_recorder), (jax_membudget, jax_flight)):
        monkeypatch.setenv(flight_mod.ENV_VAR, str(tmp_path / mod.__name__))
        state, error = _breach(mod)
        assert state == 'breach'
        path = error.flight_dump
        assert path and os.path.isdir(path) and '-mem-breach-' in os.path.basename(path)
        assert path in str(error)
        files, diagnosis, _, _ = _read_dump(path)
        assert diagnosis['pool_ranking'][0]['pool'] == 'prefetch-queue'
        seen.append((files, sorted(diagnosis), diagnosis['pool_ranking']))
    assert seen[0] == seen[1]
    assert seen[0][0] == STALL_FILES - {'stacks.txt'}


def test_a_breach_without_the_variable_dumps_in_the_temporary_directory(tmp_path,
                                                                        monkeypatch,
                                                                        registries):
    import tempfile
    monkeypatch.delenv(flight_recorder.ENV_VAR, raising=False)
    monkeypatch.setattr(tempfile, 'tempdir', str(tmp_path))
    _, error = _breach(membudget)
    assert os.path.dirname(error.flight_dump) == str(tmp_path)


@pytest.mark.timeout(60)
def test_lineage_json_holds_the_live_rings(url, tmp_path):
    rings = {}
    for package in ('port', 'jax'):
        if package == 'port':
            reader = make_tensor_reader(url, workers_count=2, seed=4)
            loader = TorchLoader(reader, 16, device='cpu', prefetch=2,
                                 lineage=str(tmp_path / 'ledger'))
            recorder_cls = flight_recorder.FlightRecorder
        else:
            reader = jax_make_tensor_reader(url, workers_count=2, seed=4)
            loader = JaxLoader(reader, 16, prefetch=2, lineage=str(tmp_path / 'jax-ledger'))
            recorder_cls = jax_flight.FlightRecorder
        try:
            for i, _ in enumerate(loader):
                if i == 1:
                    path = recorder_cls(str(tmp_path / 'flight' / package)).dump(reason='test')
        finally:
            loader.close() if package == 'port' else loader.stop()
            reader.stop()
            reader.join()
        with open(os.path.join(path, 'lineage.json')) as f:
            ours = [ring for ring in json.load(f) if ring.get('ctx', {}).get('url') == url]
        assert ours, 'the live ring is missing from the dump'
        records = ours[0]['records']
        assert [r['batch_id'] for r in records] == [0, 1]
        assert records[0]['segments']
        rings[package] = (sorted(ours[0]), sorted(records[0]),
                          sorted(records[0]['segments'][0]))
    assert rings['port'] == rings['jax']
