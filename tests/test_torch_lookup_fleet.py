"""The port's partitioned lookup fleet (``serving/placement.py`` and the
fleet verbs of ``serving/server.py`` and ``serving/client.py``), mirroring
``tests/test_fleet_lookup.py`` and held against the JAX package:

* ``build_partition_map``, ``partition_of_key`` and the map's wire and
  JSON bytes equal the JAX package's over a grid of 1-5 members, 1-16
  partitions and replication 1-3, for integer and string keys, and across
  ``add_member`` / ``remove_member``;
* a port server warm-joins a JAX server's fleet from its chunk files and
  serves its first reads from the chunk-store tier;
* the fleet CLI mode's JSON lines equal the JAX CLI's, endpoints masked;
* the ``partition-lost`` and ``hb-flap`` sites fire on the port's servers;
* the slice: one request batch of JPEG rows through the port's fleet and
  through the JAX package's is digest-equal, and ResNetTiny (flax weights
  converted) over the plain normalize gives equal logits within
  ``rtol=1e-4, atol=1e-4`` (f32 on both sides).

Every endpoint is ``ipc://`` under the test's ``tmp_path``.
"""

import json
import os
import signal as signal_mod
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from petastorm_tpu import serving as jsv
from petastorm_tpu.etl.rowgroup_indexers import SingleFieldRowIndexer as JaxSingleFieldRowIndexer
from petastorm_tpu.etl.rowgroup_indexing import build_rowgroup_index as jax_build_rowgroup_index
from petastorm_tpu.etl.writer import write_dataset as jax_write_dataset
from petastorm_tpu.serving import placement as jax_placement
from petastorm_tpu.unischema import Unischema as JaxUnischema
from petastorm_tpu.unischema import UnischemaField as JaxUnischemaField
from petastorm_tpu_torch import faults, make_tensor_reader
from petastorm_tpu_torch.data_service import RpcUnanswered
from petastorm_tpu_torch.lineage import _digest_array
from petastorm_tpu_torch.predicates import in_lambda
from petastorm_tpu_torch.serving import (LookupClient, LookupEngine, LookupServer, PartitionMap,
                                         build_partition_map)
from petastorm_tpu_torch.serving import placement
from torch_service_helpers import ipc, ipc_dir

pytestmark = [pytest.mark.serving, pytest.mark.fleet]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 48
ROWS_PER_GROUP = 8
N_PIECES = ROWS // ROWS_PER_GROUP


def _schema():
    from petastorm_tpu.codecs import NdarrayCodec, ScalarCodec
    return JaxUnischema('FleetSchema', [
        JaxUnischemaField('id', np.int64, (), ScalarCodec(np.int64), False),
        JaxUnischemaField('bucket', np.int32, (), ScalarCodec(np.int32), False),
        JaxUnischemaField('vec', np.float32, (4,), NdarrayCodec(), False),
    ])


@pytest.fixture(scope='module')
def fleet_dataset(tmp_path_factory):
    url = 'file://' + str(tmp_path_factory.mktemp('fleet') / 'dataset')
    rng = np.random.default_rng(16)
    rows = [{'id': i, 'bucket': i % 4, 'vec': rng.random(4, dtype=np.float32)}
            for i in range(ROWS)]
    jax_write_dataset(url, _schema(), rows, rows_per_row_group=ROWS_PER_GROUP)
    jax_build_rowgroup_index(url, [JaxSingleFieldRowIndexer('id_row_ix', 'id')])

    class _Dataset:
        pass

    ds = _Dataset()
    ds.url, ds.rows = url, rows
    return ds


@pytest.fixture
def sock(tmp_path):
    path = ipc_dir(tmp_path)
    yield path
    if os.path.islink(path):
        os.unlink(path)


@pytest.fixture(autouse=True)
def _no_fleet_thread_survives():
    yield
    deadline = time.monotonic() + 3.0
    while True:
        left = [t.name for t in threading.enumerate()
                if t.is_alive() and t.name.startswith(('pstt-lookup', 'pstt-fleet'))]
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    assert not left, 'threads survived the test: {}'.format(left)


def _members(*names):
    return {name: {'rpc': 'tcp://10.0.0.{}:7000'.format(i + 1),
                   'control': 'tcp://10.0.0.{}:7001'.format(i + 1)}
            for i, name in enumerate(names)}


def _digests(row):
    return {name: _digest_array(np.asarray(value)) for name, value in row.items()}


def _env():
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(filter(None, [REPO, env.get('PYTHONPATH')]))
    env['JAX_PLATFORMS'] = 'cpu'
    env.pop(faults.ENV_VAR, None)
    return env


# -- placement ---------------------------------------------------------------------------------------

def test_placement_deterministic_and_replicated():
    members = _members('a', 'b', 'c')
    pmap = build_partition_map(members, n_partitions=16, replication=2)
    shuffled = dict(reversed(list(members.items())))
    assert build_partition_map(shuffled, n_partitions=16, replication=2) == pmap
    for pid in range(16):
        replicas = pmap.replicas(pid)
        assert len(replicas) == 2 and len(set(replicas)) == 2
        assert pmap.is_primary(replicas[0], pid)
    assert build_partition_map(_members('a'), replication=3).replicas(0) == ['a']
    counts = {name: len(pmap.partitions_of(name)) for name in members}
    assert sum(counts.values()) == 32 and min(counts.values()) >= 4


def test_placement_stable_under_join():
    before = build_partition_map(_members('a', 'b', 'c'), n_partitions=32, replication=2)
    after = placement.add_member(before, 'd', 'tcp://10.0.0.4:7000', 'tcp://10.0.0.4:7001')
    assert after.version == before.version + 1
    for pid in range(32):
        if 'd' not in after.replicas(pid):
            assert after.replicas(pid) == before.replicas(pid)
    assert 0 < len(after.partitions_of('d')) < 32


def test_placement_wire_round_trip_and_membership_edges():
    pmap = build_partition_map(_members('a', 'b'), n_partitions=4, replication=2, version=7)
    wire = json.loads(json.dumps(pmap.to_wire()))
    assert PartitionMap.from_wire(wire) == pmap
    with pytest.raises(ValueError, match='malformed'):
        PartitionMap.from_wire({'version': 1})
    with pytest.raises(ValueError, match='last fleet member'):
        placement.remove_member(build_partition_map(_members('a')), 'a')
    with pytest.raises(ValueError, match='at least one member'):
        build_partition_map({})
    with pytest.raises(ValueError, match='n_partitions'):
        build_partition_map(_members('a'), n_partitions=0)
    smaller = placement.remove_member(pmap, 'b')
    assert smaller.version == 8 and list(smaller.members) == ['a']


def test_partition_of_key_string_form_and_piece_cover():
    for key in (0, 7, 123456789, 'abc'):
        assert placement.partition_of_key(key, 8) == placement.partition_of_key(str(key), 8)
    pmap = build_partition_map(_members('a', 'b'), n_partitions=4)
    cover = sorted(p for pid in range(4) for p in pmap.pieces_of_partition(pid, 10))
    assert cover == list(range(10))
    assert pmap.pieces_of_partition(1, 10) == [1, 5, 9]


GRID = [(m, p, r) for m in range(1, 6) for p in (1, 2, 3, 8, 16) for r in (1, 2, 3)]


@pytest.mark.parametrize('n_members, n_partitions, replication', GRID,
                         ids=['m{}p{}r{}'.format(*case) for case in GRID])
def test_placement_equals_jax_over_a_grid(n_members, n_partitions, replication):
    """A pure function of membership in both packages: equal assignments,
    wire dicts and JSON bytes, the same partition for every key, and the
    same maps after a join and a leave."""
    names = ['srv-{}'.format(i) for i in range(n_members)]
    members = _members(*names)
    got = build_partition_map(members, n_partitions=n_partitions, replication=replication,
                              version=3)
    want = jax_placement.build_partition_map(members, n_partitions=n_partitions,
                                             replication=replication, version=3)
    assert got.assignments == want.assignments
    assert got.to_wire() == want.to_wire() and got.to_json() == want.to_json()
    for key in list(range(40)) + ['user-{}'.format(i) for i in range(20)]:
        assert got.partition_of_key(key) == want.partition_of_key(key)
    joined = placement.add_member(got, 'newcomer', 'tcp://10.0.9.1:7000')
    assert joined.to_json() == jax_placement.add_member(
        want, 'newcomer', 'tcp://10.0.9.1:7000').to_json()
    if n_members > 1:
        assert placement.remove_member(got, names[0]).to_json() == \
            jax_placement.remove_member(want, names[0]).to_json()
    # Each package reads the other's wire dict back to an equal map.
    assert PartitionMap.from_wire(want.to_wire()) == got
    assert jax_placement.PartitionMap.from_wire(got.to_wire()) == want


# -- a two-replica fleet --------------------------------------------------------------------------

@pytest.fixture
def fleet(fleet_dataset, sock):
    """Two named replicas over one dataset: srv-a bootstraps the map, srv-b
    joins (cold), the client dials and watches both."""
    engines = [LookupEngine(fleet_dataset.url, index_name='id_row_ix') for _ in range(2)]
    servers = [LookupServer(eng, ipc(sock, name), lease_s=1.0, server_name=name).start()
               for eng, name in zip(engines, ('srv-a', 'srv-b'))]
    servers[0].init_fleet(n_partitions=4, replication=2)
    servers[1].join_fleet(servers[0].rpc_endpoint, warm=False)
    client = LookupClient([s.rpc_endpoint for s in servers],
                          control_endpoints=[s.control_endpoint for s in servers],
                          timeout_ms=5000, hedge_after_ms=150)
    client.refresh_partition_map()
    try:
        yield servers, client
    finally:
        client.close()
        for server in servers:
            server.stop()
        for eng in engines:
            eng.close()


def test_fleet_join_converges_map_and_routing(fleet):
    servers, client = fleet
    pmap = client.partition_map
    assert pmap is not None and pmap.version == 2
    assert sorted(pmap.members) == ['srv-a', 'srv-b']
    assert servers[0].partition_map.version == 2
    for pid in range(pmap.n_partitions):
        candidates = client._candidates(partition=pid)
        assert candidates[0] == pmap.endpoints(pid)[0]
        assert set(candidates) == {s.rpc_endpoint for s in servers}
    table = client.routing_table()
    assert table['version'] == 2
    assert set(table['partitions']) == {str(p) for p in range(pmap.n_partitions)}
    assert all(entry['breaker'] == 'closed'
               for entries in table['partitions'].values() for entry in entries)


def test_scatter_lookup_multi_key_duplicates_and_absent(fleet, fleet_dataset):
    _, client = fleet
    keys = [5, 17, 5, 999, 40, '17']
    got = client.lookup(keys)
    assert [len(rows) for rows in got] == [1, 1, 1, 0, 1, 1]
    for key, rows in zip(keys, got):
        if rows:
            assert int(rows[0]['id']) == int(key)
            np.testing.assert_array_equal(rows[0]['vec'], fleet_dataset.rows[int(key)]['vec'])
    assert client.scatter_stats()['scatters'] >= 1


def _bucket_is(bucket, state):
    return bucket == state


def test_query_scatter_matches_engine_order_and_global_limit(fleet, fleet_dataset):
    _, client = fleet
    predicate = in_lambda(['bucket'], _bucket_is, state_arg=2)
    with LookupEngine(fleet_dataset.url, index_name='id_row_ix') as eng:
        want = eng.query(predicate)
        for limit in (None, 1, 5, 100):
            got = client.query(predicate, limit=limit)
            ref = want if limit is None else want[:limit]
            assert [_digests(r) for r in got] == [_digests(r) for r in ref]


def test_query_empty_partitions_contribute_nothing(fleet_dataset, sock):
    with LookupEngine(fleet_dataset.url, index_name='id_row_ix') as eng:
        with LookupServer(eng, ipc(sock, 'solo'), lease_s=1.0, server_name='solo').start() as srv:
            srv.init_fleet(n_partitions=16, replication=1)
            with LookupClient([srv.rpc_endpoint]) as client:
                client.refresh_partition_map()
                predicate = in_lambda(['bucket'], _bucket_is, state_arg=0)
                got = client.query(predicate)
                assert [int(r['id']) for r in got] == [i for i in range(ROWS) if i % 4 == 0]


def test_drain_reassigns_live_and_client_converges(fleet):
    servers, client = fleet
    assert client.lookup([5])[0]
    servers[0].drain()
    assert servers[0].partition_map.version == 3
    assert servers[1].partition_map.version == 3
    survivor_map = servers[1].partition_map
    assert list(survivor_map.members) == ['srv-b']
    for pid in range(survivor_map.n_partitions):
        assert survivor_map.replicas(pid) == ['srv-b']
    for key in range(ROWS):
        rows = client.lookup([key])[0]
        assert len(rows) == 1 and int(rows[0]['id']) == key
    client.refresh_partition_map()
    assert client.partition_map.version == 3


def test_warm_join_serves_first_reads_from_chunk_store(fleet_dataset, tmp_path, sock):
    from petastorm_tpu_torch.serving.engine import TIER_DECODE
    eng_a = LookupEngine(fleet_dataset.url, index_name='id_row_ix',
                         cache=str(tmp_path / 'store-a'))
    eng_b = LookupEngine(fleet_dataset.url, index_name='id_row_ix',
                         cache=str(tmp_path / 'store-b'))
    srv_a = srv_b = None
    try:
        for key in range(ROWS):
            assert eng_a.lookup([key])[0]
        assert eng_a.flush(30.0)
        srv_a = LookupServer(eng_a, ipc(sock, 'a'), lease_s=1.0, server_name='srv-a').start()
        srv_a.init_fleet(n_partitions=4, replication=2)
        srv_b = LookupServer(eng_b, ipc(sock, 'b'), lease_s=1.0, server_name='srv-b').start()
        summary = srv_b.join_fleet(srv_a.rpc_endpoint, warm=True)
        assert summary['partitions'] == [0, 1, 2, 3]
        assert summary['warmed_chunks'] == N_PIECES and summary['warm_failed'] == 0
        assert all(eng_b.has_cached(piece) for piece in range(N_PIECES))
        with LookupClient([srv_b.rpc_endpoint]) as client:
            for key in range(ROWS):
                assert int(client.lookup([key])[0][0]['id']) == key
        tiers = eng_b.stats()['tiers']
        assert tiers.get(TIER_DECODE, 0) == 0
        assert tiers.get('chunk-store', 0) >= N_PIECES
    finally:
        for srv in (srv_b, srv_a):
            if srv is not None:
                srv.stop()
        eng_b.close()
        eng_a.close()


def test_a_port_server_warm_joins_a_jax_fleet(fleet_dataset, tmp_path, sock):
    """A JAX server bootstraps the fleet over its warmed chunk store; a
    port server joins it warm (the ``chunk`` verb, the JAX package's packed
    chunks) and serves every key from the chunk-store tier, rows equal to
    the JAX server's; both hold the v2 map and a JAX client reads the
    mixed fleet."""
    ref = jsv.LookupEngine(fleet_dataset.url, index_name='id_row_ix',
                           cache=str(tmp_path / 'jax-store'))
    eng = LookupEngine(fleet_dataset.url, index_name='id_row_ix',
                       cache=str(tmp_path / 'port-store'))
    jax_srv = srv = None
    try:
        want = ref.lookup(list(range(ROWS)))
        assert ref.flush(30.0)
        jax_ep = ipc(sock, 'jax')
        jax_srv = jsv.LookupServer(ref, jax_ep, control_bind=jax_ep + '.1', lease_s=1.0,
                                   server_name='jax-a').start()
        jax_srv.init_fleet(n_partitions=4, replication=2)
        srv = LookupServer(eng, ipc(sock, 'port'), lease_s=1.0, server_name='port-b').start()
        summary = srv.join_fleet(jax_srv.rpc_endpoint, warm=True)
        assert summary['version'] == 2 and summary['warmed_chunks'] == N_PIECES
        assert summary['warm_failed'] == 0
        assert jax_srv.partition_map.version == 2
        assert jax_srv.partition_map.to_json() == srv.partition_map.to_json()
        with LookupClient([srv.rpc_endpoint]) as client:
            got = client.lookup(list(range(ROWS)))
        assert [[_digests(r) for r in rows] for rows in got] == \
            [[_digests(r) for r in rows] for rows in want]
        tiers = eng.stats()['tiers']
        assert tiers.get('decode', 0) == 0 and tiers.get('chunk-store', 0) >= N_PIECES
        with jsv.LookupClient([jax_srv.rpc_endpoint, srv.rpc_endpoint],
                              control_endpoints=[jax_srv.control_endpoint,
                                                 srv.control_endpoint]) as jax_client:
            assert jax_client.refresh_partition_map().version == 2
            mixed = jax_client.lookup(list(range(0, ROWS, 3)))
        assert [[_digests(r) for r in rows] for rows in mixed] == \
            [[_digests(r) for r in rows] for rows in want[::3]]
    finally:
        for server in (srv, jax_srv):
            if server is not None:
                server.stop()
        eng.close()
        ref.close()


def test_warm_fill_rejects_torn_blob(fleet_dataset, tmp_path):
    """A torn peer chunk is refused and not persisted. The blob comes from a
    peer engine, as in a warm join: exporting a piece warms the exporter's
    own store behind its back (a write-behind), so the exporter itself could
    hold the piece whatever ``warm_fill`` did. Two tears: the blob's middle
    byte and one inside the first field's CRC-covered payload."""
    from petastorm_tpu_torch.chunk_store import _PREAMBLE
    from petastorm_tpu_torch.errors import CorruptChunkError
    with LookupEngine(fleet_dataset.url, index_name='id_row_ix',
                      cache=str(tmp_path / 'peer')) as peer:
        packed = peer.packed_chunk(0)
    data_start = _PREAMBLE.unpack_from(packed, 0)[3]
    with LookupEngine(fleet_dataset.url, index_name='id_row_ix',
                      cache=str(tmp_path / 'store')) as eng:
        for at in (len(packed) // 2, data_start + 1):
            blob = bytearray(packed)
            blob[at] ^= 0xFF
            with pytest.raises(CorruptChunkError):
                eng.warm_fill(0, bytes(blob))
            assert not eng.has_cached(0)
        assert eng.warm_fill(0, packed) and eng.flush(30.0) and eng.has_cached(0)
    with LookupEngine(fleet_dataset.url, index_name='id_row_ix') as bare:
        with pytest.raises(ValueError, match='DecodedChunkStore'):
            bare.warm_fill(0, b'')


def test_client_endpoint_state_bounded_under_churn(fleet):
    servers, client = fleet
    live = servers[0].rpc_endpoint
    long_ago = time.monotonic() - 120.0
    client._hb['tcp://10.9.9.9:7000'] = ('serving', 1.0, long_ago)
    client._hb[live] = ('serving', 1.0, time.monotonic())
    client._server_ids['ghost-sid'] = ('tcp://10.9.9.9:7000', long_ago)
    client._prune_endpoint_state()
    assert 'tcp://10.9.9.9:7000' not in client._hb
    assert 'ghost-sid' not in client._server_ids
    assert live in client._hb
    client._hb['tcp://10.9.9.8:7000'] = ('serving', 30.0, time.monotonic() - 1.0)
    client._prune_endpoint_state()
    assert 'tcp://10.9.9.8:7000' in client._hb


# -- chaos: partition-lost, hb-flap, the per-partition shed, SIGKILL failover -------------------------

def _key_in_partition(pmap, pid, avoid=()):
    return next(key for key in range(ROWS)
                if pmap.partition_of_key(key) == pid and key not in avoid)


@pytest.mark.chaos
def test_partition_lost_raises_typed_never_truncates(fleet, monkeypatch):
    servers, client = fleet
    pmap = client.partition_map
    lost_key = _key_in_partition(pmap, 0)
    safe_key = next(k for k in range(ROWS) if pmap.partition_of_key(k) != 0)
    storm = LookupClient([s.rpc_endpoint for s in servers], timeout_ms=700,
                         hedge_after_ms=100, breaker_threshold=50, partition_map=pmap)
    try:
        assert storm.lookup([lost_key])[0]
        monkeypatch.setenv(faults.ENV_VAR, 'partition-lost:match=p0')
        assert int(storm.lookup([safe_key])[0][0]['id']) == safe_key
        with pytest.raises(RpcUnanswered):
            storm.lookup([lost_key])
        with pytest.raises(RpcUnanswered):
            storm.lookup([lost_key, safe_key])
        monkeypatch.delenv(faults.ENV_VAR)
        assert int(storm.lookup([lost_key])[0][0]['id']) == lost_key
    finally:
        storm.close()


@pytest.mark.chaos
def test_hb_flap_wobbles_ranking_not_reads(fleet, monkeypatch):
    servers, client = fleet
    watcher = LookupClient([servers[0].rpc_endpoint],
                           control_endpoints=[servers[0].control_endpoint])
    try:
        watcher.lookup([1])
        monkeypatch.setenv(faults.ENV_VAR, 'hb-flap:p=1')
        time.sleep(0.5)
        watcher._drain_heartbeats()          # what had queued before the flap
        time.sleep(0.8)                      # two heartbeat intervals, none sent
        before = len(watcher._hb)
        watcher._drain_heartbeats()
        hb = watcher._hb.get(servers[0].rpc_endpoint)
        assert hb is None or time.monotonic() - hb[2] >= 0.6, 'a heartbeat got through'
        assert len(watcher._hb) == before
        for key in (1, 9, 17, 33):
            rows = client.lookup([key])[0]
            assert len(rows) == 1 and int(rows[0]['id']) == key
        assert set(client._candidates()) == {s.rpc_endpoint for s in servers}
    finally:
        watcher.close()


def test_mem_shed_keeps_primary_partitions_sheds_secondary(fleet):
    servers, _ = fleet
    srv_b = servers[1]
    pmap = srv_b.partition_map
    primary = [pid for pid in range(pmap.n_partitions) if pmap.is_primary('srv-b', pid)]
    secondary = [pid for pid in range(pmap.n_partitions) if not pmap.is_primary('srv-b', pid)]
    assert primary and secondary, 'the 4-partition map splits srv-b both ways'
    assert srv_b._admit({'cmd': 'lookup', 'consumer': 'c1'}) is None
    srv_b._set_mem_shed(True)
    try:
        assert srv_b._admit({'cmd': 'lookup', 'consumer': 'c1',
                             'partition': primary[0]}) is None
        refusal = srv_b._admit({'cmd': 'lookup', 'consumer': 'c1',
                                'partition': secondary[0]})
        assert refusal['reason'] == 'memory-pressure'
        assert refusal['partition'] == secondary[0]
        stranger = srv_b._admit({'cmd': 'lookup', 'consumer': 'c2'})
        assert stranger['refused'] == 'overloaded'
    finally:
        srv_b._set_mem_shed(False)


def _serve_cli(dataset_url, name, bind, extra):
    cmd = [sys.executable, '-m', 'petastorm_tpu_torch.tools.lookup', '--dataset-url',
           dataset_url, '--key', 'id=3', '--index', 'id_row_ix', '--serve', '--name', name,
           '--bind', bind] + extra
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, env=_env())


def _read_until(proc, action, timeout_s=120):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        body = json.loads(line)
        if body.get('action') == action:
            return body
        assert 'error' not in body, body
    pytest.fail('server never printed {!r}'.format(action))


@pytest.mark.chaos
def test_sigkill_failover_within_lease_zero_failed_lookups(fleet_dataset, sock):
    """SIGKILL one replica of a live 2-member fleet under a 3-thread key
    storm: no lookup fails and every row equals the reader path's."""
    reader_digests = {}
    with make_tensor_reader(fleet_dataset.url, reader_pool_type='dummy',
                            shuffle_row_groups=False) as reader:
        for chunk in reader:
            for i in range(len(chunk.id)):
                reader_digests[int(chunk.id[i])] = {
                    'id': _digest_array(chunk.id[i]), 'bucket': _digest_array(chunk.bucket[i]),
                    'vec': _digest_array(chunk.vec[i])}
    assert len(reader_digests) == ROWS
    victim = _serve_cli(fleet_dataset.url, 'srv-victim', ipc(sock, 'victim'),
                        ['--partitions', '4', '--lease-s', '2'])
    survivor = None
    try:
        victim_serve = _read_until(victim, 'serve')
        survivor = _serve_cli(fleet_dataset.url, 'srv-survivor', ipc(sock, 'survivor'),
                              ['--join', victim_serve['rpc_endpoint'], '--no-warm',
                               '--lease-s', '2'])
        survivor_serve = _read_until(survivor, 'serve')
        endpoints = [victim_serve['rpc_endpoint'], survivor_serve['rpc_endpoint']]
        controls = [victim_serve['control_endpoint'], survivor_serve['control_endpoint']]
        failures, checked = [], [0]
        lock = threading.Lock()
        stop = threading.Event()

        def storm(worker_id):
            client = LookupClient(endpoints, control_endpoints=controls, timeout_ms=10000,
                                  hedge_after_ms=150, breaker_threshold=2, breaker_reset_s=1.0)
            try:
                client.refresh_partition_map()
                rng = np.random.default_rng(worker_id)
                while not stop.is_set():
                    key = int(rng.integers(0, ROWS))
                    try:
                        rows = client.lookup([key])[0]
                        assert len(rows) == 1
                        for field, want in reader_digests[key].items():
                            assert _digest_array(rows[0][field]) == want
                        with lock:
                            checked[0] += 1
                    except Exception as e:  # noqa: BLE001 - collected
                        with lock:
                            failures.append((key, repr(e)))
            finally:
                client.close()

        threads = [threading.Thread(target=storm, args=(i,), daemon=True) for i in range(3)]
        for thread in threads:
            thread.start()
        time.sleep(1.0)
        victim.kill()
        victim.wait(timeout=30)
        time.sleep(4.0)
        stop.set()
        for thread in threads:
            thread.join(timeout=60)
        assert failures == [], failures[:5]
        assert checked[0] > 50
    finally:
        for proc in (survivor, victim):
            if proc is not None and proc.poll() is None:
                proc.send_signal(signal_mod.SIGKILL)
            if proc is not None:
                proc.communicate()


# -- the CLI's fleet mode ------------------------------------------------------------------------------

def test_lookup_cli_fleet_mode_prints_routing_and_stats(fleet, fleet_dataset):
    """The port's CLI and the JAX package's against the same fleet: equal
    lines once endpoints and breaker/lease views are masked."""
    servers, _ = fleet
    argv = (['--key', 'id=7', '--fleet'] + [s.rpc_endpoint for s in servers]
            + ['--control'] + [s.control_endpoint for s in servers])
    lines = {}
    for package in ('petastorm_tpu_torch', 'petastorm_tpu'):
        proc = subprocess.run([sys.executable, '-m', package + '.tools.lookup'] + argv,
                              capture_output=True, text=True, timeout=180, env=_env())
        assert proc.returncode == 0, proc.stderr
        lines[package] = [json.loads(line) for line in proc.stdout.splitlines() if line.strip()]
    by_action = {line['action']: line for line in lines['petastorm_tpu_torch']}
    table = by_action['routing-table']['table']
    assert table['version'] == 2 and sorted(table['members']) == ['srv-a', 'srv-b']
    assert set(by_action['partition-health']['partitions']) == {'0', '1', '2', '3'}
    result = by_action['lookup']
    assert result['matches'] == 1 and result['rows'][0]['id']['value'] == 7
    assert result['rows'][0]['vec']['crc32'] == '{:#010x}'.format(
        _digest_array(fleet_dataset.rows[7]['vec']))

    def masked(line):
        line = json.loads(json.dumps(line))
        for entries in (line.get('table', {}).get('partitions', {}).values()
                        if line['action'] == 'routing-table' else
                        line.get('partitions', {}).values()):
            for entry in entries:
                entry.pop('hb_state', None)
                entry.pop('lease_fresh', None)
        return line
    assert [masked(line) for line in lines['petastorm_tpu_torch']] == \
        [masked(line) for line in lines['petastorm_tpu']]


# -- the slice: one request batch through either fleet, then ResNetTiny -----------------------------

IMAGE_ROWS, IMAGE_GROUP, IMAGE_SIZE = 48, 8, 32


@pytest.fixture(scope='module')
def image_store(tmp_path_factory):
    from petastorm_tpu.codecs import CompressedImageCodec, ScalarCodec
    schema = JaxUnischema('LookupImages', [
        JaxUnischemaField('idx', np.int64, (), ScalarCodec(np.int64), False),
        JaxUnischemaField('image', np.uint8, (IMAGE_SIZE, IMAGE_SIZE, 3),
                          CompressedImageCodec('jpeg', quality=90), False),
        JaxUnischemaField('label', np.int64, (), ScalarCodec(np.int64), False)])
    rng = np.random.default_rng(28)
    url = 'file://' + str(tmp_path_factory.mktemp('lookup-images') / 'store')
    jax_write_dataset(url, schema, (
        {'idx': i, 'image': rng.integers(0, 256, (IMAGE_SIZE, IMAGE_SIZE, 3), dtype=np.uint8),
         'label': int(rng.integers(0, 10))} for i in range(IMAGE_ROWS)),
        rows_per_row_group=IMAGE_GROUP)
    jax_build_rowgroup_index(url, [JaxSingleFieldRowIndexer('idx_row_ix', 'idx')])
    return url


def _fleet_batch(package, url, sock, prefix, keys):
    engine_cls = LookupEngine if package is None else package.LookupEngine
    server_cls = LookupServer if package is None else package.LookupServer
    client_cls = LookupClient if package is None else package.LookupClient
    engines = [engine_cls(url, index_name='idx_row_ix') for _ in range(2)]
    servers = []
    try:
        for i, eng in enumerate(engines):
            ep = ipc(sock, '{}{}'.format(prefix, i))
            servers.append(server_cls(eng, ep, control_bind=ep + '.1', lease_s=1.0,
                                      server_name='{}-{}'.format(prefix, i)).start())
        servers[0].init_fleet(n_partitions=2, replication=2)
        servers[1].join_fleet(servers[0].rpc_endpoint, warm=False)
        with client_cls([s.rpc_endpoint for s in servers]) as client:
            client.refresh_partition_map()
            rows = client.lookup(keys)
        return [row for matches in rows for row in matches]
    finally:
        for server in servers:
            server.stop()
        for eng in engines:
            eng.close()


def test_one_request_batch_through_either_fleet_then_resnet_tiny(image_store, sock):
    import jax
    import jax.numpy as jnp
    import torch
    from flax.traverse_util import flatten_dict

    from petastorm_tpu.models.resnet import ResNetTiny as JaxResNetTiny
    from petastorm_tpu.models.train import create_train_state as jax_create_train_state
    from petastorm_tpu.ops.image_ops import normalize_images as jax_normalize_images
    from petastorm_tpu_torch.convert import load_flax_resnet
    from petastorm_tpu_torch.models import ResNetTiny
    from petastorm_tpu_torch.ops.image_ops import normalize_images

    keys = [int(k) for k in np.random.default_rng(0).choice(IMAGE_ROWS, 8, replace=False)]
    ours = _fleet_batch(None, image_store, sock, 'port', keys)
    theirs = _fleet_batch(jsv, image_store, sock, 'jax', keys)
    assert [int(r['idx']) for r in ours] == keys
    assert [_digests(r) for r in ours] == [_digests(r) for r in theirs]
    images = np.stack([r['image'] for r in ours])

    jax_model = JaxResNetTiny(num_classes=10, dtype=jnp.float32)
    jax_state = jax_create_train_state(jax.random.PRNGKey(0), jax_model,
                                       (1, IMAGE_SIZE, IMAGE_SIZE, 3))
    port_model = load_flax_resnet(
        ResNetTiny(num_classes=10, dtype=torch.float32, device='cpu'),
        {k: np.asarray(v) for k, v in flatten_dict(jax_state.params).items()},
        {k: np.asarray(v) for k, v in flatten_dict(jax_state.batch_stats).items()})
    port_model.eval()
    with torch.no_grad():
        # A CPU tensor: normalize_images runs its plain version.
        logits = port_model(normalize_images(torch.from_numpy(images),
                                             dtype=torch.float32)).numpy()
    want = jax_model.apply({'params': jax_state.params, 'batch_stats': jax_state.batch_stats},
                           jax_normalize_images(images, dtype=jnp.float32), train=False)
    np.testing.assert_allclose(logits, np.asarray(want), rtol=1e-4, atol=1e-4)
    assert np.isfinite(logits).all()
