"""The port's data service (``petastorm_tpu_torch/data_service.py``),
mirroring ``tests/test_data_service.py`` (all but its TF test) and the
data-service tests of ``tests/test_chaos.py`` (``:375, :624, :763,
:973``), and held against the JAX package:

* a deterministic store served by each package's ``DataServer`` to its own
  ``RemoteReader`` and loader gives batches equal by the lineage CRC32
  digests, and a mid-epoch ``state_dict`` cut resumes to the same rows in
  both packages;
* a port ``RemoteReader`` reads a JAX ``DataServer``, and a JAX
  ``RemoteReader`` a port ``DataServer``, on ``arrow-ipc`` and ``pickle``;
* a server process imports neither torch nor jax;
* the serve CLI (SIGTERM drain, ``--max-consumers``, the metrics port,
  SIGKILL and snapshot resume) and both demos of the port's example.

Every endpoint that a test may bind again is ``ipc://`` under its
``tmp_path``; only the tests of the TCP convention itself (the derived
ports, the bind retry, ``_connectable``) bind ``tcp://127.0.0.1:*``.
"""

import json
import os
import pickle
import signal
import subprocess
import sys
import threading
import time
import warnings

import numpy as np
import pytest
import zmq

from petastorm_tpu import data_service as jds
from petastorm_tpu import make_tensor_reader as jax_make_tensor_reader
from petastorm_tpu_torch import (NdarrayCodec, ScalarCodec, TorchLoader, Unischema,
                                 UnischemaField, faults, make_reader, make_tensor_reader,
                                 write_dataset)
from petastorm_tpu_torch import data_service as ds
from petastorm_tpu_torch.data_service import (DataServer, RemoteReader, RpcUnanswered,
                                              checkpoint_shared_stream, serve_dataset,
                                              verify_shared_stream_complete)
from petastorm_tpu_torch.errors import ServerOverloaded
from petastorm_tpu_torch.health import HeartbeatRegistry, Watchdog
from petastorm_tpu_torch.lineage import _digest_array
from petastorm_tpu_torch.retry import RetryPolicy
from torch_service_helpers import endpoints, ipc, ipc_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ROWS = 64


@pytest.fixture(scope='module')
def service_dataset(tmp_path_factory):
    schema = Unischema('Svc', [
        UnischemaField('vec', np.float32, (4,), NdarrayCodec(), False),
        UnischemaField('sid', np.int64, (), ScalarCodec(np.int64), False),
    ])
    rng = np.random.default_rng(21)
    url = 'file://' + str(tmp_path_factory.mktemp('svc') / 'store')
    write_dataset(url, schema, ({'vec': rng.standard_normal(4).astype(np.float32), 'sid': i}
                                for i in range(N_ROWS)), rows_per_row_group=8)
    return url


@pytest.fixture
def sock(tmp_path):
    path = ipc_dir(tmp_path)
    yield path
    if os.path.islink(path):
        os.unlink(path)


def _env():
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(filter(None, [REPO, env.get('PYTHONPATH')]))
    return env


def _ids(reader):
    out = []
    for chunk in reader:
        out.extend(int(i) for i in np.asarray(chunk.sid))
    return out


def _consume_n(reader, n):
    ids = []
    for _ in range(n):
        ids.extend(int(i) for i in np.asarray(next(reader).sid))
    return ids


# -- the stream -----------------------------------------------------------------------

def test_roundtrip_single_client(service_dataset, sock):
    with serve_dataset(service_dataset, ipc(sock, 'd'), num_epochs=1, seed=0) as server:
        assert (server.control_endpoint, server.rpc_endpoint) == endpoints(server.data_endpoint)
        with RemoteReader(server.data_endpoint) as remote:
            ids = _ids(remote)
    assert sorted(ids) == list(range(N_ROWS))
    assert remote.diagnostics['remote_chunks'] == server.served_chunks


def test_two_clients_disjoint_union(service_dataset, sock):
    results = {}

    def consume(name, endpoint):
        with RemoteReader(endpoint, shared_stream=True, end_grace_s=1.0) as remote:
            results[name] = _ids(remote)

    reader = make_tensor_reader(service_dataset, num_epochs=1, seed=0)
    with DataServer(reader, ipc(sock, 'd')) as server:
        threads = [threading.Thread(target=consume, args=(n, server.data_endpoint))
                   for n in ('a', 'b')]
        for t in threads:
            t.start()
        server.start()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    a, b = set(results['a']), set(results['b'])
    assert not (a & b)
    assert sorted(a | b) == list(range(N_ROWS))


def test_multi_server_fan_in(service_dataset, sock):
    s1 = serve_dataset(service_dataset, ipc(sock, 'a'), num_epochs=1, seed=0)
    s2 = serve_dataset(service_dataset, ipc(sock, 'b'), num_epochs=1, seed=1)
    with s1, s2:
        with RemoteReader([s1.data_endpoint, s2.data_endpoint]) as remote:
            ids = _ids(remote)
    assert len(ids) == 2 * N_ROWS
    assert sorted(set(ids)) == list(range(N_ROWS))


def test_torch_loader_over_remote_reader(service_dataset, sock):
    with serve_dataset(service_dataset, ipc(sock, 'd'), num_epochs=1, seed=0) as server:
        with RemoteReader(server.data_endpoint) as remote:
            with TorchLoader(remote, 16, device='cpu', last_batch='drop') as loader:
                ids, shapes = [], set()
                for batch in loader:
                    ids.extend(batch.sid.tolist())
                    shapes.add(tuple(batch.vec.shape))
    assert shapes == {(16, 4)}
    assert sorted(ids) == list(range(N_ROWS))


def test_client_stop_mid_stream(service_dataset, sock):
    with serve_dataset(service_dataset, ipc(sock, 'd'), num_epochs=None, seed=0) as server:
        with RemoteReader(server.data_endpoint) as remote:
            got = 0
            for _ in remote:
                got += 1
                if got >= 3:
                    break
    assert got == 3


def test_server_error_propagates_to_client(service_dataset, sock):
    from petastorm_tpu_torch.transform import TransformSpec

    def explode(cols):
        raise RuntimeError('decode tier exploded')

    reader = make_tensor_reader(service_dataset, num_epochs=1, seed=0,
                                transform_spec=TransformSpec(explode))
    with DataServer(reader, ipc(sock, 'd')) as server:
        with RemoteReader(server.data_endpoint) as remote:
            server.start()
            with pytest.raises(RuntimeError, match='failed mid-stream'):
                _ids(remote)


def test_serve_dataset_cleans_up_reader_on_bind_failure(service_dataset):
    blocker = serve_dataset(service_dataset, 'tcp://127.0.0.1:*', num_epochs=1, seed=0)
    with blocker:
        with pytest.raises(zmq.ZMQError):
            serve_dataset(service_dataset, blocker.data_endpoint, num_epochs=1, seed=0)


def test_per_row_reader_rejected(service_dataset, sock):
    with make_reader(service_dataset, num_epochs=1) as reader:
        with pytest.raises(ValueError, match='batched reader'):
            DataServer(reader, ipc(sock, 'd'))


@pytest.mark.parametrize('direction', ['port-to-jax', 'jax-to-port'])
def test_zero_copy_frames_roundtrip_across_packages(direction):
    cols = {'a': np.arange(32, dtype=np.float32).reshape(8, 4), 'b': np.arange(8, dtype=np.int64)}
    dump, load = ((ds._dump_frames, jds._load_frames) if direction == 'port-to-jax'
                  else (jds._dump_frames, ds._load_frames))
    frames = dump(cols)
    assert len(frames) == 3
    assert [bytes(f) for f in frames] == [bytes(f) for f in jds._dump_frames(cols)]
    out = load(frames)
    np.testing.assert_array_equal(out['a'], cols['a'])
    np.testing.assert_array_equal(out['b'], cols['b'])


def test_end_accounting_raises_on_lost_tail(service_dataset, sock):
    reader = make_tensor_reader(service_dataset, num_epochs=1, seed=0)
    with DataServer(reader, ipc(sock, 'd')) as server:
        thief = zmq.Context.instance().socket(zmq.PULL)
        thief.setsockopt(zmq.RCVHWM, 1000)
        thief.connect(server.data_endpoint)
        try:
            with RemoteReader(server.data_endpoint, end_grace_s=1.0) as remote:
                server.start()
                with pytest.raises(RuntimeError, match='advertised chunks'):
                    _ids(remote)
        finally:
            thief.close(linger=0)


# -- checkpoints ------------------------------------------------------------------------

def test_checkpoint_resume_across_service(service_dataset, sock):
    with serve_dataset(service_dataset, ipc(sock, 'd'), num_epochs=1, seed=0,
                       workers_count=1) as server:
        with RemoteReader(server.data_endpoint) as remote:
            before = _consume_n(remote, 2)
            state = remote.state_dict()
    assert state['server_states'][0] is not None
    with serve_dataset(service_dataset, ipc(sock, 'd'), num_epochs=1, seed=0, workers_count=1,
                       resume_state=state['server_states'][0]) as server2:
        with RemoteReader(server2.data_endpoint, resume_state=state) as remote2:
            after = _ids(remote2)
    assert sorted(before + after) == list(range(N_ROWS))


def test_torch_loader_checkpoint_over_service(service_dataset, sock):
    before = []
    with serve_dataset(service_dataset, ipc(sock, 'd'), num_epochs=1, seed=0,
                       workers_count=1) as server:
        with RemoteReader(server.data_endpoint) as remote:
            loader = TorchLoader(remote, 8, device='cpu', last_batch='drop', prefetch=4)
            it = iter(loader)
            for _ in range(2):
                before.extend(next(it).sid.tolist())
            state = loader.state_dict()
            loader.close()
    assert len(before) == 16
    after = []
    with serve_dataset(service_dataset, ipc(sock, 'd'), num_epochs=1, seed=0, workers_count=1,
                       resume_state=state['server_states'][0]) as server2:
        with RemoteReader(server2.data_endpoint, resume_state=state) as remote2:
            with TorchLoader(remote2, 8, device='cpu', last_batch='drop') as loader2:
                for batch in loader2:
                    after.extend(batch.sid.tolist())
    assert not (set(before) & set(after)), 'rows delivered twice'
    assert sorted(before + after) == list(range(N_ROWS)), 'rows lost'


def test_checkpoint_keeps_serving_after_snapshot(service_dataset, sock):
    with serve_dataset(service_dataset, ipc(sock, 'd'), num_epochs=1, seed=0) as server:
        with RemoteReader(server.data_endpoint) as remote:
            ids = [int(i) for i in next(remote).sid]
            state = remote.state_dict()
            assert isinstance(state['pending'], list)
            ids.extend(_ids(remote))
    assert sorted(ids) == list(range(N_ROWS))


def test_superbatches_and_state_through_the_service(service_dataset, sock):
    """superbatches(k) over a RemoteReader: a state taken between groups
    resumes to exactly the rows not yet delivered."""
    seen = []
    with serve_dataset(service_dataset, ipc(sock, 'd'), num_epochs=1, seed=0,
                       workers_count=1) as server:
        with RemoteReader(server.data_endpoint) as remote:
            loader = TorchLoader(remote, 8, device='cpu', last_batch='drop', prefetch=4)
            groups = loader.superbatches(2)
            sb = next(groups)
            assert tuple(sb.vec.shape) == (16, 4)
            seen.extend(sb.sid.reshape(-1).tolist())
            state = loader.state_dict()
            loader.close()
    with serve_dataset(service_dataset, ipc(sock, 'd'), num_epochs=1, seed=0, workers_count=1,
                       resume_state=state['server_states'][0]) as server2:
        with RemoteReader(server2.data_endpoint, resume_state=state) as remote2:
            with TorchLoader(remote2, 8, device='cpu', last_batch='drop') as loader2:
                for sb in loader2.superbatches(2):
                    seen.extend(sb.sid.reshape(-1).tolist())
    assert sorted(seen) == list(range(N_ROWS))


def test_a_shuffling_buffer_over_the_service_is_never_degraded(service_dataset, sock):
    """The memory governor's degrade halves a shuffling buffer only for a
    reader that says it is not deterministic; a RemoteReader says nothing,
    so the hook stays off (fail closed)."""
    from petastorm_tpu_torch import membudget

    with serve_dataset(service_dataset, ipc(sock, 'd'), num_epochs=1, seed=0) as server:
        with RemoteReader(server.data_endpoint) as remote:
            assert getattr(remote, 'deterministic', None) is None
            with TorchLoader(remote, 8, device='cpu', shuffling_queue_capacity=32,
                             seed=1) as loader:
                pools = [h for h in membudget.get_governor()._pools
                         if h.name == 'shuffling-buffer']
                assert pools and all(h.degrade_fn is None for h in pools)
                ids = [i for b in loader for i in b.sid.tolist()]
    assert sorted(ids) == list(range(N_ROWS))


def test_service_over_plain_parquet_store(tmp_path, sock):
    import pyarrow as pa
    import pyarrow.parquet as pq

    from petastorm_tpu_torch import make_batch_reader

    n = 40
    table = pa.table({'id': pa.array(range(n), pa.int64()),
                      'name': pa.array(['row-{}'.format(i) for i in range(n)]),
                      'value': pa.array(np.linspace(0, 1, n).astype(np.float64))})
    path = tmp_path / 'plain'
    path.mkdir()
    pq.write_table(table, str(path / 'part0.parquet'), row_group_size=8)
    with serve_dataset('file://' + str(path), ipc(sock, 'd'), reader_factory=make_batch_reader,
                       num_epochs=1) as server:
        with RemoteReader(server.data_endpoint) as remote:
            ids, names = [], []
            for chunk in remote:
                ids.extend(int(i) for i in chunk.id)
                names.extend(str(s) for s in chunk.name)
    assert sorted(ids) == list(range(n))
    assert sorted(names) == sorted('row-{}'.format(i) for i in range(n))


# -- rpc, stats, metrics -------------------------------------------------------------------

def test_stats_rpc(service_dataset, sock):
    with serve_dataset(service_dataset, ipc(sock, 'd'), num_epochs=1, seed=0) as server:
        with RemoteReader(server.data_endpoint) as remote:
            ids = _ids(remote)
            assert 'error' in remote._one_shot_rpc(remote._rpc_endpoints[0], {'cmd': 'nonsense'})
            stats = remote._one_shot_rpc(remote._rpc_endpoints[0], {'cmd': 'stats'})
    assert sorted(ids) == list(range(N_ROWS))
    assert stats['done'] and stats['sent'] == server.served_chunks
    assert stats['snapshot_lag_chunks'] is None


def test_stats_reports_snapshot_freshness(service_dataset, sock, tmp_path):
    with serve_dataset(service_dataset, ipc(sock, 'd'), num_epochs=1, seed=0, workers_count=1,
                       snapshot_path=str(tmp_path / 'snap.pkl'), snapshot_every=1) as server:
        with RemoteReader(server.data_endpoint) as remote:
            _ids(remote)
            stats = remote._one_shot_rpc(remote._rpc_endpoints[0], {'cmd': 'stats'})
    assert stats['snapshot_lag_chunks'] == 0
    assert stats['snapshot_age_s'] is not None and stats['snapshot_age_s'] < 60
    assert stats['wire'] and set(stats['wire'].values()) == {'pickle'}, 'snapshots pin pickle'


def test_diagnostics_per_server_ages(service_dataset, sock):
    def consume_until(remote, predicate, why, budget_s=60):
        deadline = time.monotonic() + budget_s
        while not predicate():
            assert time.monotonic() < deadline, why
            next(remote)

    with serve_dataset(service_dataset, ipc(sock, 'a'), num_epochs=None, seed=0) as s1, \
            serve_dataset(service_dataset, ipc(sock, 'b'), num_epochs=1, seed=0) as s2:
        with RemoteReader([s1.data_endpoint, s2.data_endpoint], shared_stream=True,
                          end_grace_s=1.0) as remote:
            consume_until(remote, lambda: len(remote.diagnostics['server_last_chunk_age_s']) >= 2,
                          'never saw chunks from both servers')
            mid = remote.diagnostics['server_last_chunk_age_s']
            assert len(mid) == 2 and all(a >= 0 for a in mid.values())
            consume_until(remote, lambda: len(remote.diagnostics['server_last_chunk_age_s']) == 1,
                          'the finite server never ended')
    assert len(remote.diagnostics['server_last_chunk_age_s']) == 1


def test_fleet_metrics_dead_server_lands_in_unreachable(service_dataset, sock):
    dead_rpc = ipc(sock, 'nobody') + '.2'
    with serve_dataset(service_dataset, ipc(sock, 'd'), num_epochs=1, seed=0) as server:
        with RemoteReader(server.data_endpoint, shared_stream=True, end_grace_s=1.0) as remote:
            _ids(remote)
            remote._rpc_endpoints.append(dead_rpc)
            fleet = remote.fleet_metrics(timeout_ms=300)
    assert fleet['unreachable'] == [dead_rpc]
    assert remote._rpc_endpoints[0] in fleet['servers']
    served = fleet['aggregate']['pst_data_service_chunks_served_total']
    assert sum(s['value'] for s in served['samples']) >= server.served_chunks
    assert fleet['wire'] == {server.rpc_endpoint: 'shm'} or fleet['wire'][server.rpc_endpoint] \
        in ('arrow-ipc', 'pickle', 'shm')


@pytest.mark.parametrize('unreachable_detail', [False, True])
@pytest.mark.parametrize('server_value', ['metrics', 'reply'])
def test_scrape_fleet_metrics_equals_jax(server_value, unreachable_detail):
    from petastorm_tpu import metrics as jmetrics
    from petastorm_tpu_torch import metrics

    snap = {'pst_x_total': {'type': 'counter', 'help': 'h',
                            'samples': [{'labels': {}, 'value': 2}]}}
    replies = {'a': {'metrics': snap, 'registry_id': 'p1'},
               'b': {'metrics': snap, 'registry_id': 'p1'},     # same process: folded once
               'c': {'metrics': snap},                          # no id: kept per endpoint
               'd': {'error': 'nope'}, 'e': 'garbled'}

    def scrape(endpoint):
        if endpoint == 'f':
            raise RuntimeError('connection refused')
        return replies[endpoint]

    args = (list('abcdef'), scrape, server_value, unreachable_detail)
    ours, theirs = metrics.scrape_fleet_metrics(*args), jmetrics.scrape_fleet_metrics(*args)
    assert ours == theirs
    assert ours['aggregate']['pst_x_total']['samples'][0]['value'] == 4


# -- the serve CLI --------------------------------------------------------------------------

def _cli(args, **kw):
    return subprocess.Popen([sys.executable, '-m', 'petastorm_tpu_torch.tools.serve_cli'] + args,
                            stdout=subprocess.PIPE, text=True, env=_env(), cwd=REPO, **kw)


def test_serve_cli_sigterm_graceful_drain(service_dataset, sock):
    proc = _cli([service_dataset, '--bind', ipc(sock, 'd'), '--workers', '2', '--epochs', '0',
                 '--sndhwm', '1', '--drain-grace', '1'])
    try:
        eps = json.loads(proc.stdout.readline())
        with RemoteReader(eps['data_endpoint'], rcvhwm=1) as remote:
            ids = [int(i) for i in next(remote).sid]
            os.kill(proc.pid, signal.SIGTERM)
            ids.extend(_ids(remote))
        final = json.loads(proc.stdout.readline())
        assert final['state'] == 'drained'
        assert final['served_chunks'] == remote.diagnostics['remote_chunks']
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_lease_expiry_counts_and_reconnect_window_raises(service_dataset, sock):
    """The reference's ``test_fleet_ft.py::test_lease_expiry_counts_and_reconnect_window_raises``
    against the port: a SIGKILLed serve-CLI server's lease expires on the
    consumer's side (``pst_server_lease_expiries_total`` counts it), and a
    sole consumer with a 2 s reconnect window and no replacement raises
    naming the reconnect window instead of polling forever."""
    from petastorm_tpu_torch import metrics
    expiries = metrics.counter('pst_server_lease_expiries_total', '')
    before = expiries.value
    proc = _cli([service_dataset, '--bind', ipc(sock, 'd'), '--workers', '2', '--epochs', '0',
                 '--sndhwm', '1', '--lease-s', '2'])
    try:
        eps = json.loads(proc.stdout.readline())
        with RemoteReader(eps['data_endpoint'], rcvhwm=1, reconnect_s=2.0,
                          admission=False) as remote:
            # The lease must be known before the kill; consuming pumps the
            # control socket.
            deadline = time.monotonic() + 15
            while not remote.diagnostics['leases']:
                assert time.monotonic() < deadline, 'no heartbeat seen'
                next(remote)
                time.sleep(0.05)
            proc.kill()
            proc.wait()
            with pytest.raises(RuntimeError, match='reconnect window'):
                _ids(remote)
        assert expiries.value > before
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_serve_cli_max_consumers_refuses_extra(service_dataset, sock):
    proc = _cli([service_dataset, '--bind', ipc(sock, 'd'), '--workers', '2', '--epochs', '0',
                 '--max-consumers', '0', '--drain-grace', '0'])
    try:
        eps = json.loads(proc.stdout.readline())
        with RemoteReader(eps['data_endpoint']) as remote:
            with pytest.raises(ServerOverloaded) as info:
                deadline = time.monotonic() + 30
                while time.monotonic() < deadline:
                    next(remote)
                raise AssertionError('refusal never surfaced')
        assert info.value.reason == 'overloaded'
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_serve_cli_end_to_end_imports_neither_torch_nor_jax(service_dataset, sock):
    """The CLI's server streams the whole epoch, exits 0 on its own, and
    its process never imported torch or jax (read over the stats of a
    probe run with ``-X importtime`` would be slow: the module list is
    printed by a wrapper instead)."""
    code = ('import runpy, sys, json, atexit\n'
            'def report():\n'
            '    bad = sorted(m for m in ("torch", "jax", "jaxlib", "petastorm_tpu") '
            'if m in sys.modules)\n'
            '    print(json.dumps({"imported": bad}), flush=True)\n'
            'atexit.register(report)\n'
            'sys.argv = ["serve_cli"] + sys.argv[1:]\n'
            'runpy.run_module("petastorm_tpu_torch.tools.serve_cli", run_name="__main__")\n')
    proc = subprocess.Popen([sys.executable, '-c', code, service_dataset, '--bind',
                             ipc(sock, 'd'), '--workers', '2', '--epochs', '1',
                             '--drain-grace', '0.5'],
                            stdout=subprocess.PIPE, text=True, env=dict(_env(),
                                                                          CUDA_VISIBLE_DEVICES=''))
    try:
        eps = json.loads(proc.stdout.readline())
        with RemoteReader(eps['data_endpoint']) as remote:
            ids = _ids(remote)
        assert sorted(ids) == list(range(N_ROWS))
        rest = proc.communicate(timeout=30)[0].splitlines()
        assert proc.returncode == 0
        assert json.loads(rest[-1]) == {'imported': []}
        assert json.loads(rest[-2])['state'] == 'served'
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_serve_cli_metrics_port(service_dataset, sock):
    import urllib.request

    proc = _cli([service_dataset, '--bind', ipc(sock, 'd'), '--workers', '2', '--epochs', '1',
                 '--metrics-port', '0', '--drain-grace', '1'])
    try:
        eps = json.loads(proc.stdout.readline())
        assert eps['metrics_endpoint'].startswith('http://127.0.0.1:')
        body = urllib.request.urlopen(eps['metrics_endpoint'], timeout=10).read().decode()
        assert '# TYPE pst_data_service_chunks_served_total counter' in body
        with RemoteReader(eps['data_endpoint']) as remote:
            assert sorted(_ids(remote)) == list(range(N_ROWS))
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope='module')
def kill_dataset(tmp_path_factory):
    """Chunks of ~64 KB, so a SIGKILL lands mid-epoch
    (``tests/test_data_service.py:779``)."""
    n = 512
    schema = Unischema('Kill', [
        UnischemaField('vec', np.float32, (1024,), NdarrayCodec(), False),
        UnischemaField('sid', np.int64, (), ScalarCodec(np.int64), False),
    ])
    rng = np.random.default_rng(3)
    url = 'file://' + str(tmp_path_factory.mktemp('kill') / 'store')
    write_dataset(url, schema, ({'vec': rng.standard_normal(1024).astype(np.float32), 'sid': i}
                                for i in range(n)), rows_per_row_group=16)
    return url, n


@pytest.mark.slow
def test_serve_cli_sigkill_resume(kill_dataset, sock, tmp_path):
    url, n_rows = kill_dataset
    snap = str(tmp_path / 'cli_snap.pkl')

    def spawn(resume=False):
        args = [url, '--bind', ipc(sock, 'd'), '--snapshot-path', snap, '--snapshot-every', '2',
                '--epochs', '1', '--sndhwm', '1']
        proc = _cli(args + (['--resume', snap] if resume else []))
        return proc, json.loads(proc.stdout.readline())

    procs = []
    try:
        proc1, eps = spawn()
        procs.append(proc1)
        with RemoteReader(eps['data_endpoint'], rcvhwm=1, end_grace_s=10.0) as remote:
            ids = _consume_n(remote, 4)
            proc1.kill()
            proc1.wait()
            proc2, eps2 = spawn(resume=True)
            procs.append(proc2)
            assert eps2['data_endpoint'] == eps['data_endpoint']
            deadline = time.monotonic() + 120
            for chunk in remote:
                ids.extend(int(i) for i in chunk.sid)
                assert time.monotonic() < deadline
        assert sorted(ids) == list(range(n_rows))
        assert procs[-1].wait(timeout=30) == 0
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def test_server_kill_site_and_snapshot_resume_deliver_each_row_once(service_dataset, sock,
                                                                    tmp_path):
    """``server-kill`` SIGKILLs a deterministic, snapshotting CLI server
    mid-epoch (after its fourth chunk); the server restarted with
    ``--resume`` on the same endpoint finishes the epoch, and the sole
    consumer sees every row exactly once."""
    snap = str(tmp_path / 'snap.pkl')
    token = str(tmp_path / 'kill.token')
    args = [service_dataset, '--bind', ipc(sock, 'd'), '--snapshot-path', snap,
            '--snapshot-every', '1', '--epochs', '1', '--deterministic', '--seed', '3',
            '--shuffle-row-groups', '--workers', '2', '--sndhwm', '1']
    # The site's unkeyed draws for seed 9 are 0.332, 0.357, 0.890, 0.848,
    # 0.074: at p=0.25 it fires on the fifth pass of the serve loop, after
    # chunks 0-3 went out.
    env = dict(_env(), PSTT_FAULTS='server-kill:p=0.25:seed=9:token={}'.format(token))
    first = subprocess.Popen([sys.executable, '-m', 'petastorm_tpu_torch.tools.serve_cli'] + args,
                             stdout=subprocess.PIPE, text=True, env=env, cwd=REPO)
    procs = [first]
    try:
        eps = json.loads(first.stdout.readline())
        with RemoteReader(eps['data_endpoint'], rcvhwm=1, end_grace_s=10.0) as remote:
            ids = _consume_n(remote, 1)
            assert first.wait(timeout=60) == -signal.SIGKILL
            assert os.path.exists(token)
            second = _cli(args + ['--resume', snap])
            procs.append(second)
            assert json.loads(second.stdout.readline())['data_endpoint'] == eps['data_endpoint']
            ids.extend(_ids(remote))
            dups = remote.diagnostics['duplicate_chunks']
        assert sorted(ids) == list(range(N_ROWS)), 'rows lost or delivered twice'
        assert dups >= 0
        assert second.wait(timeout=30) == 0
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


# -- adapters, cursors ---------------------------------------------------------------------

def test_det_cursor_none_without_deterministic_tags(service_dataset, sock):
    with serve_dataset(service_dataset, ipc(sock, 'd'), num_epochs=1, seed=0) as server:
        with RemoteReader(server.data_endpoint) as remote:
            next(remote)
            assert remote.det_cursor() is None
            _ids(remote)


def test_pytorch_loader_over_service_copies_read_only_views(service_dataset, sock):
    """The torch adapter consumes a RemoteReader like a local reader (the
    schema rides the rpc socket) and never wraps a read-only view: no
    'not writable' warning from torch."""
    import torch

    from petastorm_tpu_torch.pytorch import DataLoader

    with serve_dataset(service_dataset, ipc(sock, 'd'), num_epochs=1, seed=0) as server:
        remote = RemoteReader(server.data_endpoint)
        ids = []
        with warnings.catch_warnings():
            warnings.simplefilter('error', UserWarning)
            with DataLoader(remote, batch_size=16, device='cpu') as loader:
                for batch in loader:
                    assert isinstance(batch.vec, torch.Tensor)
                    assert tuple(batch.vec.shape[1:]) == (4,)
                    ids.extend(int(i) for i in batch.sid)
    assert sorted(ids) == list(range(N_ROWS))


def test_deterministic_reconnect_to_an_awaiting_replacement(service_dataset, sock,
                                                            monkeypatch):
    """A deterministic server dies mid-epoch; a replacement built with
    ``await_cursor=True`` on the same endpoint builds its reader from the
    cursor the consumer ships once the dead server's lease expired, and the
    stream continues bit-identically (``tests/test_fleet_ft.py``'s
    reconnect with resume)."""
    from petastorm_tpu_torch import metrics

    monkeypatch.setenv('PSTT_LEASE_S', '0.5')
    kw = dict(num_epochs=1, seed=5, deterministic=True, shuffle_row_groups=True, workers_count=2)
    with make_tensor_reader(service_dataset, **kw) as local:
        want = np.concatenate([np.array(c.sid) for c in local])
    bind = ipc(sock, 'd')
    server = serve_dataset(service_dataset, bind, sndhwm=1, **kw)
    replacements = []

    def replace():
        time.sleep(1.5)     # the dead server's queued chunks are in and its lease expired
        replacements.append(serve_dataset(service_dataset, bind, await_cursor=True, **kw))

    resumed = metrics.counter('pst_reconnects_total', labelnames=('outcome',)).labels('resumed')
    before = resumed.value
    got = []
    try:
        with RemoteReader(bind, rcvhwm=1, reconnect_s=30) as remote:
            for _ in range(3):
                got.append(np.array(next(remote).sid))
            server._stop.set()      # dies without an END
            server.stop()
            thread = threading.Thread(target=replace)
            thread.start()
            for chunk in remote:
                got.append(np.array(chunk.sid))
            thread.join()
    finally:
        for replacement in replacements:
            replacement.stop()
    assert np.concatenate(got).tolist() == want.tolist()
    assert resumed.value == before + 1


# -- chunk identity, shared streams, authentication ------------------------------------------

def test_seq_tracker_equals_jax():
    rng = np.random.default_rng(0)
    for _ in range(20):
        ours, theirs = ds._SeqTracker(), jds._SeqTracker()
        for seq in rng.integers(0, 40, 60):
            assert ours.add(int(seq)) == theirs.add(int(seq))
        assert (ours.watermark, ours.extras, ours.count) == \
            (theirs.watermark, theirs.extras, theirs.count)
    t = ds._SeqTracker()
    assert t.add(0) and t.add(2) and t.add(1)
    assert t.watermark == 3 and not t.extras
    assert not t.add(1) and not t.add(2)
    assert t.add(5) and not t.add(5)
    assert t.count == 4


def _shard_server(url, sock, shard, state=None, tag=''):
    return serve_dataset(url, ipc(sock, 's{}{}'.format(tag, shard)), num_epochs=1, seed=0,
                         workers_count=1, cur_shard=shard, shard_count=2, start=False,
                         resume_state=state)


def test_shared_stream_checkpoint(service_dataset, sock):
    before = []
    with _shard_server(service_dataset, sock, 0) as s1, \
            _shard_server(service_dataset, sock, 1) as s2:
        eps = [s1.data_endpoint, s2.data_endpoint]
        r1 = RemoteReader(eps, shared_stream=True)
        r2 = RemoteReader(eps, shared_stream=True)
        time.sleep(0.3)     # both pipes connect before the first push
        s1.start()
        s2.start()
        with r1, r2:
            before += _consume_n(r1, 2)
            before += _consume_n(r2, 1)
            state = checkpoint_shared_stream([r1, r2])
    assert len(state['server_states']) == 2 and len(state['consumers']) == 2
    with _shard_server(service_dataset, sock, 0, state['server_states'][0], 'b') as s1b, \
            _shard_server(service_dataset, sock, 1, state['server_states'][1], 'b') as s2b:
        eps = [s1b.data_endpoint, s2b.data_endpoint]
        r1b = RemoteReader(eps, shared_stream=True, end_grace_s=1.0,
                           resume_state=state['consumers'][0])
        r2b = RemoteReader(eps, shared_stream=True, end_grace_s=1.0,
                           resume_state=state['consumers'][1])
        s1b.start()
        s2b.start()
        after = []
        with r1b, r2b:
            after += _ids(r1b)
            after += _ids(r2b)
            totals = verify_shared_stream_complete([r1b, r2b])
    assert totals['received'] == totals['advertised']
    both = before + after
    assert len(both) == len(set(both)) and sorted(both) == list(range(N_ROWS))


def test_state_dict_refused_on_shared_stream(service_dataset, sock):
    with serve_dataset(service_dataset, ipc(sock, 'd'), num_epochs=1, seed=0) as server:
        with RemoteReader(server.data_endpoint, shared_stream=True, end_grace_s=1.0) as remote:
            with pytest.raises(RuntimeError, match='sole consumer'):
                remote.state_dict()
            _ids(remote)


def test_verify_shared_stream_detects_lost_tail(service_dataset, sock):
    reader = make_tensor_reader(service_dataset, num_epochs=1, seed=0)
    with DataServer(reader, ipc(sock, 'd')) as server:
        thief = zmq.Context.instance().socket(zmq.PULL)
        thief.setsockopt(zmq.RCVHWM, 1000)
        thief.connect(server.data_endpoint)
        try:
            with RemoteReader(server.data_endpoint, shared_stream=True,
                              end_grace_s=1.0) as remote:
                server.start()
                _ids(remote)
                with pytest.raises(RuntimeError, match='never received'):
                    verify_shared_stream_complete([remote])
        finally:
            thief.close(linger=0)


def test_auth_key_roundtrip_and_refusal(service_dataset, sock):
    key = b'service-secret'
    with serve_dataset(service_dataset, ipc(sock, 'd'), num_epochs=1, seed=0,
                       auth_key=key) as server:
        with RemoteReader(server.data_endpoint, auth_key=key) as remote:
            ids = _ids(remote)
        assert sorted(ids) == list(range(N_ROWS))
        assert remote.diagnostics['bad_auth_frames'] == 0
        req = zmq.Context.instance().socket(zmq.REQ)
        req.setsockopt(zmq.LINGER, 0)
        try:
            req.connect(server.rpc_endpoint)
            req.send(pickle.dumps({'cmd': 'stats'}))
            assert req.poll(5000)
            assert 'unauthenticated' in pickle.loads(req.recv()[:-16])['error']
        finally:
            req.close(linger=0)


def test_keyless_consumer_drops_authed_frames(service_dataset, sock):
    with serve_dataset(service_dataset, ipc(sock, 'd'), num_epochs=1, seed=0,
                       auth_key=b'service-secret') as server:
        remote = RemoteReader(server.data_endpoint)
        got = []

        def pull():
            try:
                got.append(next(remote))
            except (StopIteration, RuntimeError):
                pass

        t = threading.Thread(target=pull)
        t.start()
        t.join(timeout=2.0)
        remote.stop()
        t.join(timeout=5.0)
        remote.join()
        assert not t.is_alive() and not got
        assert remote.diagnostics['bad_auth_frames'] > 0


def test_keyed_consumer_keyless_server_fails_loudly(service_dataset, sock):
    with serve_dataset(service_dataset, ipc(sock, 'd'), num_epochs=1, seed=0) as server:
        with RemoteReader(server.data_endpoint, auth_key=b'wrong-key',
                          end_grace_s=1.0) as remote:
            with pytest.raises(RuntimeError, match='auth_key mismatch'):
                _ids(remote)
        assert remote.diagnostics['bad_auth_frames'] >= 3


def test_shared_stream_checkpoint_through_loaders(service_dataset, sock):
    before = []
    with _shard_server(service_dataset, sock, 0) as s1, \
            _shard_server(service_dataset, sock, 1) as s2:
        eps = [s1.data_endpoint, s2.data_endpoint]
        r1 = RemoteReader(eps, shared_stream=True)
        r2 = RemoteReader(eps, shared_stream=True)
        l1 = TorchLoader(r1, 8, device='cpu', last_batch='drop', prefetch=4)
        l2 = TorchLoader(r2, 8, device='cpu', last_batch='drop', prefetch=4)
        time.sleep(0.3)
        s1.start()
        s2.start()
        it1, it2 = iter(l1), iter(l2)
        for it, n in ((it1, 2), (it2, 1)):
            for _ in range(n):
                before.extend(next(it).sid.tolist())
        state = checkpoint_shared_stream([r1, r2])
        l1.close()
        l2.close()
    assert len(before) == 24
    after = []
    with _shard_server(service_dataset, sock, 0, state['server_states'][0], 'b') as s1b, \
            _shard_server(service_dataset, sock, 1, state['server_states'][1], 'b') as s2b:
        eps = [s1b.data_endpoint, s2b.data_endpoint]
        r1b = RemoteReader(eps, shared_stream=True, end_grace_s=1.0,
                           resume_state=state['consumers'][0])
        r2b = RemoteReader(eps, shared_stream=True, end_grace_s=1.0,
                           resume_state=state['consumers'][1])
        l1b = TorchLoader(r1b, 8, device='cpu', last_batch='drop')
        l2b = TorchLoader(r2b, 8, device='cpu', last_batch='drop')
        s1b.start()
        s2b.start()
        for loader in (l1b, l2b):
            with loader:
                for batch in loader:
                    after.extend(batch.sid.tolist())
    both = before + after
    assert len(both) == len(set(both)) and sorted(both) == list(range(N_ROWS))


def test_shared_stream_state_in_job_checkpoint():
    from petastorm_tpu import job_checkpoint as jjc
    from petastorm_tpu_torch.job_checkpoint import _decode_loader_state, _encode_loader_state

    for state in ({'server_states': [{'pos': 3}],
                   'consumers': [{'pending': [{'sid': np.arange(4)}]}]},
                  {'server_states': [None], 'pending': [{'sid': np.arange(2)}]}):
        entry = _encode_loader_state(state)
        assert list(entry) == list(jjc._encode_loader_state(state))
        back = _decode_loader_state(entry)
        assert back['server_states'] == state['server_states']
        pending = (back['consumers'][0]['pending'] if 'consumers' in state
                   else back['pending'])
        assert pending[0]['sid'].tolist() == list(range(len(pending[0]['sid'])))


# -- chaos (tests/test_chaos.py) --------------------------------------------------------------

def test_data_service_bind_retries_through_policy(service_dataset, monkeypatch):
    """A clash on a derived port is retried through the RetryPolicy: the
    first attempt derives an endpoint another socket holds."""
    blocker = zmq.Context.instance().socket(zmq.PULL)
    blocker.bind('tcp://127.0.0.1:*')
    held = blocker.getsockopt(zmq.LAST_ENDPOINT).decode()
    real = ds._next_port_endpoint
    calls = []

    def clashing(endpoint, offset=1):
        calls.append(endpoint)
        return held if len(calls) == 1 else real(endpoint, offset)

    monkeypatch.setattr(ds, '_next_port_endpoint', clashing)
    events, sleeps = [], []
    policy = RetryPolicy(max_attempts=4, base_delay_s=0.02, max_delay_s=0.25,
                         retry_exceptions=(zmq.ZMQError,),
                         on_retry=lambda name, attempt, exc, delay: events.append(
                             (name, attempt, delay)), sleep=sleeps.append)
    reader = make_tensor_reader(service_dataset, reader_pool_type='dummy', num_epochs=1,
                                shuffle_row_groups=False)
    try:
        server = DataServer(reader, 'tcp://127.0.0.1:*', bind_retry_policy=policy)
        try:
            assert events and events[0][0] == 'data-service-bind'
            assert all(0.0 <= d <= 0.25 for _, _, d in events)
            assert sleeps == [d for _, _, d in events]
            assert server.control_endpoint != held
        finally:
            server.stop()
    finally:
        blocker.close(linger=0)


@pytest.mark.parametrize('endpoint,want', [
    ('tcp://127.0.0.1:5555', ('tcp://127.0.0.1:5556', 'tcp://127.0.0.1:5557')),
    ('tcp://[::1]:7000', ('tcp://[::1]:7001', 'tcp://[::1]:7002')),
    ('ipc:///run/pstt/data', ('ipc:///run/pstt/data.1', 'ipc:///run/pstt/data.2')),
])
def test_derived_endpoints(endpoint, want):
    assert (ds._next_port_endpoint(endpoint), ds._next_port_endpoint(endpoint, 2)) == want
    if endpoint.startswith('tcp://'):
        assert ds._next_port_endpoint(endpoint, 2) == jds._next_port_endpoint(endpoint, 2)
    for bad in ('inproc://x', 'tcp://host', 'ipc://'):
        with pytest.raises(ValueError):
            ds._next_port_endpoint(bad)
    assert ds._connectable('tcp://127.0.0.1:9') == jds._connectable('tcp://127.0.0.1:9')
    assert ds._connectable('tcp://*:9') == jds._connectable('tcp://*:9')


def test_watchdog_remote_server_dead_fails_over_shared_stream(service_dataset, sock):
    server_reader = make_tensor_reader(service_dataset, reader_pool_type='dummy', num_epochs=1,
                                       shuffle_row_groups=False)
    server = DataServer(server_reader, ipc(sock, 'live')).start()
    dead = ipc(sock, 'dead')
    remote = RemoteReader([server.data_endpoint, dead], shared_stream=True, end_grace_s=0.75)
    registry = HeartbeatRegistry({'default': 0.4})
    remote.attach_health(registry)
    watchdog = Watchdog(registry)
    watchdog.start()
    try:
        assert sum(len(chunk.sid) for chunk in remote) == N_ROWS
        stats = watchdog.stats()
        assert stats['stalls_detected'] >= 1 and stats['soft_recoveries'] >= 1
        assert remote.diagnostics['failed_over_servers'] == [dead + '.2']
    finally:
        watchdog.stop()
        remote.stop()
        remote.join()
        server.stop()


def test_watchdog_classifies_consumer_not_draining_over_the_service(service_dataset, sock):
    with serve_dataset(service_dataset, ipc(sock, 'd'), num_epochs=1, seed=0) as server:
        with RemoteReader(server.data_endpoint) as remote:
            with TorchLoader(remote, 8, device='cpu', prefetch=2, watchdog=True,
                             stall_timeout_s=0.3) as loader:
                it = iter(loader)
                next(it)
                time.sleep(1.0)
                stats = loader.stats['watchdog']
                assert stats['last_stall']['classification'] == 'consumer-not-draining'
                assert stats['hard_stalls'] == 0
                assert sum(1 for _ in it) == N_ROWS // 8 - 1
                assert loader.stats['watchdog']['hard_stalls'] == 0


def test_one_shot_rpc_retries_before_declaring_dead(monkeypatch, sock):
    policy = RetryPolicy(max_attempts=3, base_delay_s=0.0, retry_exceptions=(RpcUnanswered,),
                         sleep=lambda s: None)
    reader = RemoteReader(ipc(sock, 'nothing'), rpc_retry_policy=policy)
    try:
        calls = {'n': 0}

        def flaky(endpoint, request, timeout_ms):
            calls['n'] += 1
            if calls['n'] < 3:
                raise RpcUnanswered('dropped REP')
            return {'ok': True}

        monkeypatch.setattr(reader, '_rpc_attempt', flaky)
        assert reader._one_shot_rpc('ipc://x', {'cmd': 'stats'}) == {'ok': True}
        assert calls['n'] == 3
        calls['n'] = 0

        def dead(endpoint, request, timeout_ms):
            calls['n'] += 1
            raise RpcUnanswered('nothing there')

        monkeypatch.setattr(reader, '_rpc_attempt', dead)
        assert reader._one_shot_rpc('ipc://x', {'cmd': 'stats'}) is None
        assert calls['n'] == 3
    finally:
        reader.stop()
        reader.join()


def test_rpc_blackhole_opens_the_breaker(service_dataset, sock, monkeypatch):
    """``rpc-blackhole`` swallows requests: whole retry budgets go
    unanswered, the endpoint's breaker opens, and calls then return None at
    once; with the site gone the half-open probe closes it again."""
    from petastorm_tpu_torch.retry import CircuitBreaker

    policy = RetryPolicy(max_attempts=1, base_delay_s=0.0, retry_exceptions=(RpcUnanswered,),
                         sleep=lambda s: None)
    with serve_dataset(service_dataset, ipc(sock, 'd'), num_epochs=None, seed=0) as server:
        remote = RemoteReader(server.data_endpoint, rpc_retry_policy=policy, admission=False)
        remote._breaker_reset_s = 0.5
        try:
            monkeypatch.setenv(faults.ENV_VAR, 'rpc-blackhole:max=3')
            for _ in range(3):
                assert remote._one_shot_rpc(server.rpc_endpoint, {'cmd': 'stats'},
                                            timeout_ms=300) is None
            assert remote._breaker(server.rpc_endpoint).state == CircuitBreaker.OPEN
            t0 = time.monotonic()
            assert remote._one_shot_rpc(server.rpc_endpoint, {'cmd': 'stats'}) is None
            assert time.monotonic() - t0 < 0.1
            monkeypatch.delenv(faults.ENV_VAR)
            time.sleep(0.6)
            assert remote._one_shot_rpc(server.rpc_endpoint, {'cmd': 'stats'},
                                        timeout_ms=3000)['sent'] >= 0
            assert remote._breaker(server.rpc_endpoint).state == CircuitBreaker.CLOSED
        finally:
            remote.stop()
            remote.join()


def test_server_slow_site_is_hedged_past(service_dataset, sock, monkeypatch):
    """``server-slow`` paces every chunk a server sends; the stream stays
    exact."""
    monkeypatch.setenv(faults.ENV_VAR, 'server-slow:delay=0.05')
    t0 = time.monotonic()
    with serve_dataset(service_dataset, ipc(sock, 'd'), num_epochs=1, seed=0) as server:
        with RemoteReader(server.data_endpoint) as remote:
            ids = _ids(remote)
    assert sorted(ids) == list(range(N_ROWS))
    assert time.monotonic() - t0 >= (N_ROWS // 8) * 0.05


# -- against the JAX package ------------------------------------------------------------------

DET = dict(num_epochs=1, seed=7, deterministic=True, shuffle_row_groups=True, workers_count=2)


def _jax_loader_digests(remote, batch):
    from petastorm_tpu.jax_loader import JaxLoader

    out = []
    with JaxLoader(remote, batch, last_batch='drop') as loader:
        for b in loader:
            out.append((_digest_array(np.asarray(b.vec)),
                        _digest_array(np.asarray(b.sid).astype(np.int64))))
    return out


def _port_loader_digests(remote, batch):
    out = []
    with TorchLoader(remote, batch, device='cpu', last_batch='drop') as loader:
        for b in loader:
            out.append((_digest_array(b.vec.numpy()),
                        _digest_array(b.sid.numpy().astype(np.int64))))
    return out


@pytest.mark.parametrize('batch', [8, 12])
def test_deterministic_stream_digests_equal_jax(service_dataset, sock, batch):
    bind_p, bind_j = ipc(sock, 'p'), ipc(sock, 'j')
    with serve_dataset(service_dataset, bind_p, **DET) as server:
        with RemoteReader(server.data_endpoint) as remote:
            ours = _port_loader_digests(remote, batch)
    ctrl, rpc = endpoints(bind_j)
    reader = jax_make_tensor_reader(service_dataset, **DET)
    with jds.DataServer(reader, bind_j, control_bind=ctrl, rpc_bind=rpc).start():
        with jds.RemoteReader(bind_j, control_endpoints=ctrl, rpc_endpoints=rpc) as remote:
            theirs = _jax_loader_digests(remote, batch)
    assert len(ours) == N_ROWS // batch and ours == theirs


def test_a_mid_epoch_cut_resumes_to_the_same_rows_in_both_packages(service_dataset, sock):
    def cut_and_resume(serve, reader_cls, loader_ids, bind, ctrl_kw):
        before, after = [], []
        with serve(bind, None) as server:
            with reader_cls(bind, **ctrl_kw) as remote:
                for c in range(2):
                    before.extend(int(i) for i in np.asarray(next(remote).sid))
                state = remote.state_dict()
        with serve(bind, state['server_states'][0]) as server:
            with reader_cls(bind, resume_state=state, **ctrl_kw) as remote:
                after = _ids(remote)
        return before, after

    def port_serve(bind, state):
        return serve_dataset(service_dataset, bind, resume_state=state, **DET)

    def jax_serve(bind, state):
        ctrl, rpc = endpoints(bind)
        reader = jax_make_tensor_reader(service_dataset, resume_state=state, **DET)
        return jds.DataServer(reader, bind, control_bind=ctrl, rpc_bind=rpc).start()

    ours = cut_and_resume(port_serve, RemoteReader, None, ipc(sock, 'p'), {})
    bind = ipc(sock, 'j')
    ctrl, rpc = endpoints(bind)
    theirs = cut_and_resume(jax_serve, jds.RemoteReader, None, bind,
                            {'control_endpoints': ctrl, 'rpc_endpoints': rpc})
    assert ours == theirs
    assert sorted(ours[0] + ours[1]) == list(range(N_ROWS))


@pytest.mark.parametrize('tier', ['arrow-ipc', 'pickle'])
@pytest.mark.parametrize('server_package', ['jax', 'port'])
def test_cross_package_streams_are_row_equal(service_dataset, sock, tier, server_package):
    """A port RemoteReader on a JAX DataServer and a JAX RemoteReader on a
    port DataServer: the same deterministic rows, in order, on the forced
    tier."""
    bind = ipc(sock, server_package)
    ctrl, rpc = endpoints(bind)
    if server_package == 'jax':
        server = jds.DataServer(jax_make_tensor_reader(service_dataset, **DET), bind,
                                control_bind=ctrl, rpc_bind=rpc, wire=tier)
        reader_cls = RemoteReader
    else:
        server = DataServer(make_tensor_reader(service_dataset, **DET), bind, wire=tier)
        reader_cls = jds.RemoteReader
    with make_tensor_reader(service_dataset, **DET) as local:
        want = [(np.array(c.vec), np.array(c.sid)) for c in local]
    with server.start():
        with reader_cls(bind, control_endpoints=ctrl, rpc_endpoints=rpc, wire=tier) as remote:
            got = [(np.array(c.vec), np.array(c.sid)) for c in remote]
            grant = remote.fleet_metrics(timeout_ms=2000)['wire'][rpc]
            det = remote.last_chunk_det
    assert grant == tier
    assert det is not None and det['epoch'] == 1
    assert len(got) == len(want)
    for (v1, s1), (v2, s2) in zip(got, want):
        assert v1.tobytes() == v2.tobytes() and s1.tolist() == s2.tolist()


def test_a_server_process_imports_neither_torch_nor_jax(service_dataset, sock):
    code = ('import sys, json\n'
            'from petastorm_tpu_torch.data_service import serve_dataset\n'
            'server = serve_dataset(sys.argv[1], sys.argv[2], num_epochs=1, seed=0)\n'
            'print(json.dumps({"ep": server.data_endpoint}), flush=True)\n'
            'server.wait(60)\n'
            'import time; time.sleep(0.5)\n'
            'server.stop()\n'
            'bad = sorted(m for m in ("torch", "jax", "jaxlib", "petastorm_tpu") '
            'if m in sys.modules)\n'
            'print(json.dumps({"imported": bad, "cuda": __import__("os").environ.get('
            '"CUDA_VISIBLE_DEVICES")}), flush=True)\n')
    proc = subprocess.Popen([sys.executable, '-c', code, service_dataset, ipc(sock, 'd')],
                            stdout=subprocess.PIPE, text=True,
                            env=dict(_env(), CUDA_VISIBLE_DEVICES=''))
    try:
        ep = json.loads(proc.stdout.readline())['ep']
        with RemoteReader(ep) as remote:
            assert sorted(_ids(remote)) == list(range(N_ROWS))
        report = json.loads(proc.communicate(timeout=60)[0].splitlines()[-1])
        assert report == {'imported': [], 'cuda': ''}
        assert proc.returncode == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_no_service_thread_outlives_its_owners(service_dataset, sock):
    """The service threads this server and reader started end with them:
    each is joined (5 s in all), and none is left alive. Threads of other
    tests in the process are not this test's owners'."""
    before = set(threading.enumerate())
    with serve_dataset(service_dataset, ipc(sock, 'd'), num_epochs=1, seed=0) as server:
        with RemoteReader(server.data_endpoint) as remote:
            owned = [t for t in threading.enumerate()
                     if t not in before and t.name.startswith('pstt-data-service')]
            _ids(remote)
    assert {t.name for t in owned} >= {'pstt-data-service-serve', 'pstt-data-service-rpc',
                                       'pstt-data-service-client'}
    deadline = time.monotonic() + 5
    for thread in owned:
        thread.join(max(0.0, deadline - time.monotonic()))
    left = [t.name for t in owned if t.is_alive()]
    assert not left


def test_a_stopped_readers_control_thread_ends_during_a_silent_rpc(service_dataset, sock,
                                                                   monkeypatch):
    """A server that stops answering the control plane's rpcs (credit
    grants here) must not hold the reader's control thread past its
    owner's ``stop()`` and ``join()``: the rpc in flight gives up at once,
    not after its timeout and the retries behind it (under load that wait
    outlived the owners, ``test_no_service_thread_outlives_its_owners``)."""
    silent = threading.Event()
    with serve_dataset(service_dataset, ipc(sock, 'd'), num_epochs=1, seed=0) as server:
        handle = server._handle_rpc

        def handle_rpc(request):
            if request.get('cmd') == 'credit':
                silent.set()
                time.sleep(3.0)         # past the grant's 1.5 s poll
            return handle(request)

        monkeypatch.setattr(server, '_handle_rpc', handle_rpc)
        remote = RemoteReader(server.data_endpoint, flow_control=2)
        try:
            for _ in range(2):          # the window: the grant of both goes out at once
                next(remote)
            assert silent.wait(30), 'no credit rpc reached the server'
            thread = remote._ctl_thread
            assert thread is not None and thread.is_alive()
        finally:
            t0 = time.monotonic()
            remote.stop()
            remote.join()
            joined_s = time.monotonic() - t0
        assert not thread.is_alive() and joined_s < 1.0, joined_s


# -- the example ---------------------------------------------------------------------------------

@pytest.mark.parametrize('demo', ['checkpoint', 'crash'])
def test_serve_and_train_example_on_cpu(demo):
    out = subprocess.run([sys.executable, '-m', 'petastorm_tpu_torch.examples.serve_and_train',
                          '--demo', demo, '--device', 'cpu'], capture_output=True, text=True,
                         env=_env(), cwd=REPO, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    last = out.stdout.strip().splitlines()[-1]
    if demo == 'checkpoint':
        assert 'distinct rows of 96' in last
    else:
        assert 'each of 192 rows delivered once per server' in last


# -- the bench's glue on the CPU ----------------------------------------------------------------

def test_fleet_wire_record_on_the_cpu(sock):
    """The ``fleet_wire`` record at a small size over ``ipc://``: every tier
    is granted as forced, delivers every chunk, ships its bytes on its own
    tier, and leaves no segment; shm serializes only its descriptor."""
    from petastorm_tpu_torch import bench

    record = bench.run_fleet_wire(reps=1, chunk_rows=64, n_chunks=6, bind=ipc(sock, 'w'))
    assert record['chunk_bytes'] == 64 * 1024 * 4 + 64 * 8
    for tier, line in record['tiers'].items():
        assert line['granted'] == tier and line['chunks'] == 6
        assert set(line['wire_bytes_by_transport']) == {tier}
        assert line['chunks_per_sec'] > 0 and len(line['chunks_per_sec_reps']) == 1
    assert record['tiers']['shm']['serialize_ms_per_chunk'] < 5
    assert record['leaked_segments'] == []


def test_the_remote_cells_server_sees_no_card_and_drains_on_sigterm(service_dataset, sock):
    """``bench.start_server`` runs the serve CLI with the card hidden; a
    SIGTERM drains it and its exit code is 0."""
    from petastorm_tpu_torch import bench

    url = service_dataset
    proc, status, up_s = bench.start_server(url, ipc(sock, 'b'), 2, 1, ['--await-cursor'])
    try:
        assert status['state'] == 'awaiting-cursor' and up_s > 0
        assert bench.maps_cuda_driver(proc.pid) is False
        with open('/proc/{}/environ'.format(proc.pid), 'rb') as f:
            assert b'CUDA_VISIBLE_DEVICES=\x00' in f.read()
    finally:
        assert bench.stop_server(proc) == 0
    snap = {'pst_wire_bytes_total': {'samples': [{'labels': {'transport': 'shm'}, 'value': 7}]},
            'pst_wire_serialize_seconds': {'samples': [{'sum': 0.5, 'count': 2}]}}
    assert bench.wire_counters(snap) == ({'shm': 7}, {'sum': 0.5, 'count': 2})
    assert bench.imagenet_chunk_bytes() == 38_535_168 + 256 * 8
    ring = bench.remote_ring_bytes(1 << 20, chunks=3)
    assert ring % 4096 == 0 and ring <= 3 << 20


# -- admission: tenants, drain, the fleet announce ------------------------------------------------

def test_the_tenant_hook_admits_clamps_refuses_and_releases(service_dataset, sock):
    """``DataServer(tenants=)`` with the port's ``TenantLedger``: a tenant
    at its consumer cap is refused ``tenant-over-budget`` on the
    ``overloaded`` kind, a grant is clamped to what is left of the
    tenant's credit partition, and a detach frees the slot and the credits."""
    from petastorm_tpu_torch.fleet.tenancy import TenantLedger

    tenants = TenantLedger({'noisy': {'max_consumers': 0}, 'quiet': {'credits': 11}},
                           membudget_pool=None)
    with serve_dataset(service_dataset, ipc(sock, 'd'), num_epochs=None, seed=0,
                       tenants=tenants) as server:
        with RemoteReader(server.data_endpoint, tenant='noisy') as noisy:
            with pytest.raises(ServerOverloaded) as info:
                deadline = time.monotonic() + 30
                while time.monotonic() < deadline:
                    next(noisy)
            assert info.value.reason == 'overloaded'
        with RemoteReader(server.data_endpoint, tenant='quiet', flow_control=8,
                          consumer_id='c-quiet') as quiet:
            next(quiet)
            reply = quiet._one_shot_rpc(server.rpc_endpoint, {'cmd': 'attach',
                                                               'consumer': 'probe',
                                                               'tenant': 'quiet',
                                                               'credits': 6})
            assert reply['credits'] == 3 and reply['tenant'] == 'quiet'
            fleet = quiet._one_shot_rpc(server.rpc_endpoint, {'cmd': 'fleet'})
            assert fleet['tenants']['quiet']['consumers'] == 2
            assert fleet['tenants']['quiet']['credits'] == 11
            assert fleet['tenants']['noisy']['consumers'] == 0
        deadline = time.monotonic() + 10
        while (tenants.snapshot()['quiet']['consumers'] != 1
               and time.monotonic() < deadline):
            time.sleep(0.05)
    quiet_books = tenants.snapshot()['quiet']
    assert quiet_books['consumers'] == 1, 'the detach frees the tenant slot'
    assert quiet_books['credits'] == 3, 'and returns its granted credits'
    tenants.close()


def test_drain_rpc_ends_cleanly_with_the_final_cursor(service_dataset, sock, monkeypatch):
    """The ``drain`` rpc: admission closes, the stream ENDs exactly (the sole
    consumer's accounting holds), the reply carries the deterministic final
    cursor, and the heartbeats announce the job and the drain."""
    from petastorm_tpu_torch.fleet import control_plane

    monkeypatch.setenv('PSTT_FLEET_JOB', 'imagenet-train')
    monkeypatch.setenv('PSTT_LEASE_S', '0.6')
    with serve_dataset(service_dataset, ipc(sock, 'd'), num_epochs=None, seed=2,
                       deterministic=True, sndhwm=1) as server:
        sub = zmq.Context.instance().socket(zmq.SUB)
        sub.setsockopt(zmq.SUBSCRIBE, b'')
        sub.connect(server.control_endpoint)
        with RemoteReader(server.data_endpoint, rcvhwm=1) as remote:
            ids = [int(i) for i in next(remote).sid]
            reply = remote._one_shot_rpc(server.rpc_endpoint, {'cmd': 'drain',
                                                                'timeout_s': 20})
            ids.extend(_ids(remote))
        assert reply['drained'] and reply['state'] == 'drained'
        assert reply['cursor']['mode'] == 'deterministic'
        assert len(ids) == 8 * reply['sent'] == 8 * remote.diagnostics['remote_chunks']
        # Beats queued since the subscription may predate the drain: the
        # next beat after them is the one the drained server sends.
        while sub.poll(0):
            sub.recv()
        beats = []
        deadline = time.monotonic() + 5
        while len(beats) < 1 and time.monotonic() < deadline:
            if sub.poll(200):
                hb = control_plane.parse_heartbeat(sub.recv())
                if hb is not None:
                    beats.append(hb)
        sub.close(linger=0)
    assert beats and beats[0]['state'] == 'drained'
    assert beats[0]['announce']['job'] == 'imagenet-train'
