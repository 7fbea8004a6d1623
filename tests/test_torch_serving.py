"""The port's lookup tier (``petastorm_tpu_torch/serving``), mirroring
``tests/test_serving.py`` and held against the JAX package on one store
written from a numpy seed:

* ``RowLocationIndex`` locations, ``LookupEngine.lookup`` and ``query``
  rows and their order (per-field lineage CRC32 digests) and the tier
  counts of one access sequence equal the JAX package's;
* the rpc plane (admission, drain, leases, breaker, hedging) mirrors the
  reference's tests on ``ipc://`` endpoints under ``tmp_path``;
* a JAX ``LookupClient`` reads a port ``LookupServer`` and the reverse;
* the lookup CLI's JSON lines equal the JAX CLI's, endpoints masked;
* the ``server-slow`` and ``rpc-blackhole`` sites fire on the port's
  server, and no ``pstt-lookup-*`` thread survives ``stop()``.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import zmq

from petastorm_tpu import serving as jsv
from petastorm_tpu.etl.rowgroup_indexers import SingleFieldIndexer as JaxSingleFieldIndexer
from petastorm_tpu.etl.rowgroup_indexers import SingleFieldRowIndexer as JaxSingleFieldRowIndexer
from petastorm_tpu.etl.rowgroup_indexing import build_rowgroup_index as jax_build_rowgroup_index
from petastorm_tpu.etl.rowgroup_indexing import get_row_group_indexes as jax_get_row_group_indexes
from petastorm_tpu.etl.writer import write_dataset as jax_write_dataset
from petastorm_tpu.predicates import in_lambda as jax_in_lambda
from petastorm_tpu.unischema import Unischema as JaxUnischema
from petastorm_tpu.unischema import UnischemaField as JaxUnischemaField
from petastorm_tpu_torch import faults, make_tensor_reader
from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.data_service import RpcUnanswered
from petastorm_tpu_torch.errors import ServerOverloaded
from petastorm_tpu_torch.etl.rowgroup_indexers import SingleFieldRowIndexer
from petastorm_tpu_torch.etl.rowgroup_indexing import build_rowgroup_index, get_row_group_indexes
from petastorm_tpu_torch.lineage import _digest_array
from petastorm_tpu_torch.predicates import in_lambda
from petastorm_tpu_torch.retry import CircuitBreaker
from petastorm_tpu_torch.serving import (LookupClient, LookupEngine, LookupServer,
                                         RowLocationIndex)
from torch_service_helpers import ipc, ipc_dir

pytestmark = pytest.mark.serving

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 48
ROWS_PER_GROUP = 8


def _jax_schema():
    from petastorm_tpu.codecs import NdarrayCodec as JaxNdarrayCodec
    from petastorm_tpu.codecs import ScalarCodec as JaxScalarCodec
    return JaxUnischema('ServeSchema', [
        JaxUnischemaField('id', np.int64, (), JaxScalarCodec(np.int64), False),
        JaxUnischemaField('bucket', np.int32, (), JaxScalarCodec(np.int32), False),
        JaxUnischemaField('vec', np.float32, (4,), JaxNdarrayCodec(), False),
    ])


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    return [{'id': i, 'bucket': i % 4, 'vec': rng.random(4, dtype=np.float32)}
            for i in range(n)]


def _write(path, rows, rows_per_group):
    url = 'file://' + str(path)
    jax_write_dataset(url, _jax_schema(), rows, rows_per_row_group=rows_per_group)
    return url


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    """A JAX-written store with two row-level indexes and one row-group
    index, the reference's fixture from seed 5."""
    rows = _rows(ROWS, 5)
    url = _write(tmp_path_factory.mktemp('serving') / 'dataset', rows, ROWS_PER_GROUP)
    jax_build_rowgroup_index(url, [JaxSingleFieldRowIndexer('id_row_ix', 'id'),
                                   JaxSingleFieldRowIndexer('bucket_row_ix', 'bucket'),
                                   JaxSingleFieldIndexer('bucket_rg_ix', 'bucket')])

    class _Store:
        pass

    out = _Store()
    out.url, out.rows = url, rows
    return out


@pytest.fixture
def sock(tmp_path):
    path = ipc_dir(tmp_path)
    yield path
    if os.path.islink(path):
        os.unlink(path)


@pytest.fixture(autouse=True)
def _no_lookup_thread_survives():
    yield
    deadline = time.monotonic() + 3.0
    while True:
        left = [t.name for t in threading.enumerate()
                if t.is_alive() and t.name.startswith(('pstt-lookup', 'pstt-fleet'))]
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    assert not left, 'threads survived the test: {}'.format(left)


def _digests(row):
    return {name: _digest_array(np.asarray(value)) for name, value in row.items()}


def _env(**extra):
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(filter(None, [REPO, env.get('PYTHONPATH')]))
    env['JAX_PLATFORMS'] = 'cpu'
    env.pop(faults.ENV_VAR, None)
    env.update(extra)
    return env


# -- the row-level index --------------------------------------------------------------------------

def test_row_indexer_payload_round_trip(store, tmp_path):
    payload = get_row_group_indexes(store.url)
    ix = payload['id_row_ix']
    assert ix['type'] == 'single_field_rows'
    assert ix['values']['13'] == [[1, 5]]
    for i in (0, 7, 8, ROWS - 1):
        assert ix['values'][str(i)] == [[i // ROWS_PER_GROUP, i % ROWS_PER_GROUP]]
    # The port's build of the same store stores the JAX package's payload.
    copy = _write(tmp_path / 'copy', store.rows, ROWS_PER_GROUP)
    built = build_rowgroup_index(copy, [SingleFieldRowIndexer('id_row_ix', 'id')])
    assert built['id_row_ix'] == jax_get_row_group_indexes(store.url)['id_row_ix']


def test_row_indexer_merge_and_rowgroup_contract():
    a = SingleFieldRowIndexer('ix', 'k')
    a.build_index([{'k': 'x'}, {'k': 'y'}], 0)
    b = SingleFieldRowIndexer('ix', 'k')
    b.build_index([{'k': 'x'}], 3)
    a += b
    assert a.get_row_locations('x') == [(0, 0), (3, 0)]
    assert a.get_row_group_indexes('x') == [0, 3]
    assert a.get_row_group_indexes('y') == [0]


def test_row_location_index_load_and_autoselect(store):
    by_name = RowLocationIndex.load(store.url, index_name='id_row_ix')
    assert by_name.field == 'id'
    assert by_name.locations(13) == [(1, 5)]
    assert by_name.locations('13') == [(1, 5)]
    assert by_name.locations(9999) == []
    assert 13 in by_name and 9999 not in by_name
    with pytest.raises(ValueError, match='exactly one row-level'):
        RowLocationIndex.load(store.url)
    with pytest.raises(ValueError, match='not a row-level index'):
        RowLocationIndex.load(store.url, index_name='bucket_rg_ix')
    # Every key's locations equal the JAX package's, both indexes.
    for name in ('id_row_ix', 'bucket_row_ix'):
        port = RowLocationIndex.load(store.url, index_name=name)
        ref = jsv.RowLocationIndex.load(store.url, index_name=name)
        assert sorted(port.keys()) == sorted(ref.keys()) and len(port) == len(ref)
        for key in list(ref.keys()) + ['absent']:
            assert port.locations(key) == ref.locations(key)


def test_selectors_compose_over_row_level_index(store):
    from petastorm_tpu_torch.selectors import (IntersectIndexSelector, SingleIndexSelector,
                                               UnionIndexSelector)
    payload = get_row_group_indexes(store.url)
    row_level = SingleIndexSelector('bucket_row_ix', [1])
    rg_level = SingleIndexSelector('bucket_rg_ix', [1])
    assert row_level.select_row_groups(payload) == rg_level.select_row_groups(payload)
    a = SingleIndexSelector('id_row_ix', [3])
    b = SingleIndexSelector('id_row_ix', [3, 20])
    assert IntersectIndexSelector([a, b]).select_row_groups(payload) == {0}
    assert UnionIndexSelector([a, b]).select_row_groups(payload) == {0, 2}
    assert IntersectIndexSelector([b, rg_level]).select_row_groups(payload) == {0, 2}


# -- the engine: tiers, coalescing, the shared cache ----------------------------------------------

def test_engine_lookup_and_missing_keys(store):
    keys = [13, 7, 9999, 13, '7']
    with LookupEngine(store.url, index_name='id_row_ix') as eng, \
            jsv.LookupEngine(store.url, index_name='id_row_ix') as ref:
        got, want = eng.lookup(keys), ref.lookup(keys)
        assert [len(r) for r in got] == [1, 1, 0, 1, 1]
        for key, rows in zip((13, 7), got):
            assert int(rows[0]['id']) == key
            np.testing.assert_array_equal(rows[0]['vec'], store.rows[key]['vec'])
        assert [[_digests(r) for r in rows] for rows in got] == \
            [[_digests(r) for r in rows] for rows in want]
        assert eng.stats()['tiers'] == ref.stats()['tiers'] == {'decode': 2}
        assert eng.stats() == ref.stats()


def test_engine_multi_match_key(store):
    with LookupEngine(store.url, index_name='bucket_row_ix') as eng, \
            jsv.LookupEngine(store.url, index_name='bucket_row_ix') as ref:
        rows = eng.lookup([2])[0]
        assert sorted(int(r['id']) for r in rows) == [i for i in range(ROWS) if i % 4 == 2]
        assert [_digests(r) for r in rows] == [_digests(r) for r in ref.lookup([2])[0]]


def test_engine_tier_ladder_memory_store_decode(store, tmp_path):
    """One access sequence through both packages' engines, each over its
    own chunk store and an LRU of two blocks: the tier counts after every
    step are equal."""
    seen = []
    for mod, name in ((jsv, 'ref'), (None, 'port')):
        engine_cls = LookupEngine if mod is None else mod.LookupEngine
        with engine_cls(store.url, index_name='id_row_ix',
                        cache=str(tmp_path / name), block_cache_entries=2) as eng:
            steps = []
            for keys in ([13], [13], None, [13], [0, 20, 40], [5, 13], [47]):
                if keys is None:
                    assert eng.flush()
                    with eng._lock:
                        eng._blocks.clear()
                    continue
                eng.lookup(keys)
                # The write-behind spill lands before the next step reads.
                assert eng.flush()
                steps.append(dict(eng.stats()['tiers']))
            seen.append(steps)
    assert seen[0] == seen[1]
    assert seen[1][:3] == [{'decode': 1}, {'decode': 1, 'memory': 1},
                           {'decode': 1, 'memory': 1, 'chunk-store': 1}]


def test_engine_coalesces_concurrent_cold_fetches(store):
    with LookupEngine(store.url, index_name='id_row_ix') as eng:
        barrier = threading.Barrier(6)
        results, errors = [], []

        def read():
            barrier.wait()
            try:
                results.append(eng.lookup([13])[0][0])
            except Exception as e:  # noqa: BLE001 - asserted below
                errors.append(e)

        threads = [threading.Thread(target=read) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        assert not errors and len(results) == 6
        tiers = eng.stats()['tiers']
        assert tiers['decode'] == 1
        assert tiers.get('coalesced', 0) + tiers.get('memory', 0) == 5
        assert eng.stats()['coalesced'] == tiers.get('coalesced', 0)


def test_engine_shares_training_chunk_store(store, tmp_path):
    """An epoch of the port's training reader through the chunk store makes
    every point read of both packages' engines warm: one cache, one key."""
    store_dir = str(tmp_path / 'shared-store')
    with make_tensor_reader(store.url, reader_pool_type='dummy', shuffle_row_groups=False,
                            cache_type='chunk-store', cache_location=store_dir) as reader:
        for _ in reader:
            pass
        assert reader.chunk_store.flush()
    keys = list(range(0, ROWS, 5))
    for engine_cls in (LookupEngine, jsv.LookupEngine):
        with engine_cls(store.url, index_name='id_row_ix', cache=store_dir) as eng:
            eng.lookup(keys)
            tiers = eng.stats()['tiers']
            assert tiers.get('chunk-store', 0) > 0 and tiers.get('decode', 0) == 0, tiers


def _bucket_is(bucket, state):
    return bucket == state


def test_engine_query_in_lambda_state_arg_and_limit(store):
    from petastorm_tpu.selectors import SingleIndexSelector as JaxSingleIndexSelector
    from petastorm_tpu_torch.selectors import SingleIndexSelector
    with LookupEngine(store.url, index_name='id_row_ix') as eng, \
            jsv.LookupEngine(store.url, index_name='id_row_ix') as ref:
        predicate = in_lambda(['id', 'bucket'], lambda id, bucket, state: bucket == state,
                              state_arg=3)
        jax_predicate = jax_in_lambda(['id', 'bucket'],
                                      lambda id, bucket, state: bucket == state, state_arg=3)
        got = eng.query(predicate)
        assert sorted(int(r['id']) for r in got) == [i for i in range(ROWS) if i % 4 == 3]
        sel = SingleIndexSelector('id_row_ix', [20])
        got = eng.query(predicate, selector=sel)
        assert sorted(int(r['id']) for r in got) == [19, 23]
        assert len(eng.query(predicate, limit=2)) == 2
        assert eng.query(predicate, limit=0) == []
        # Rows and their order equal the JAX package's, with locations too.
        for kwargs, jax_kwargs in (
                ({}, {}), ({'limit': 5}, {'limit': 5}),
                ({'selector': sel}, {'selector': JaxSingleIndexSelector('id_row_ix', [20])}),
                ({'pieces': [1, 4], 'with_locations': True, 'fields': ['id', 'vec']},
                 {'pieces': [1, 4], 'with_locations': True, 'fields': ['id', 'vec']})):
            port_rows = eng.query(predicate, **kwargs)
            ref_rows = ref.query(jax_predicate, **jax_kwargs)
            if kwargs.get('with_locations'):
                assert [(r['piece'], r['offset']) for r in port_rows] == \
                    [(r['piece'], r['offset']) for r in ref_rows]
                port_rows = [r['row'] for r in port_rows]
                ref_rows = [r['row'] for r in ref_rows]
            assert [_digests(r) for r in port_rows] == [_digests(r) for r in ref_rows]


def test_engine_refuses_unknown_fields_and_a_closed_engine(store):
    eng = LookupEngine(store.url, index_name='id_row_ix')
    with pytest.raises(ValueError, match='unknown fields'):
        eng.lookup([1], fields=['nope'])
    with pytest.raises(ValueError, match='predicate uses fields'):
        eng.query(in_lambda(['nope'], lambda nope: True))
    assert eng.lookup([1], fields=['vec'])[0][0].keys() == {'vec'}
    eng.close()
    with pytest.raises(RuntimeError, match='closed'):
        eng.lookup([2])


# -- byte identity against the epoch reader ---------------------------------------------------------

def test_served_rows_byte_identical_to_reader_path(store, sock):
    reader_digests = {}
    with make_tensor_reader(store.url, reader_pool_type='dummy', shuffle_row_groups=False) as r:
        for chunk in r:
            for i in range(len(chunk.id)):
                reader_digests[int(chunk.id[i])] = {
                    'id': _digest_array(chunk.id[i]), 'bucket': _digest_array(chunk.bucket[i]),
                    'vec': _digest_array(chunk.vec[i])}
    assert len(reader_digests) == ROWS
    with LookupEngine(store.url, index_name='id_row_ix') as eng:
        with LookupServer(eng, ipc(sock, 'rpc')).start() as server:
            with LookupClient([server.rpc_endpoint]) as client:
                for key in range(ROWS):
                    row = client.lookup_one(key)
                    assert row is not None
                    for field, want in reader_digests[key].items():
                        assert _digest_array(row[field]) == want, (field, key)


# -- the service plane: verbs, admission, drain, failover, breaker -----------------------------------

@pytest.fixture
def lookup_fleet(store, sock):
    """Two servers over one store and a client dialing and watching both."""
    engines = [LookupEngine(store.url, index_name='id_row_ix') for _ in range(2)]
    servers = [LookupServer(eng, ipc(sock, 'srv{}'.format(i)), lease_s=1.0).start()
               for i, eng in enumerate(engines)]
    client = LookupClient([s.rpc_endpoint for s in servers],
                          control_endpoints=[s.control_endpoint for s in servers],
                          timeout_ms=5000, hedge_after_ms=150)
    try:
        yield servers, client
    finally:
        client.close()
        for server in servers:
            server.stop()
        for eng in engines:
            eng.close()


def test_rpc_verbs_and_fleet_metrics(lookup_fleet):
    servers, client = lookup_fleet
    assert servers[0].control_endpoint == servers[0].rpc_endpoint + '.1'
    assert int(client.lookup([7])[0][0]['id']) == 7
    rows = client.query(in_lambda(['bucket'], _bucket_is, state_arg=1), limit=3)
    assert len(rows) == 3 and all(int(r['bucket']) == 1 for r in rows)
    stats = client.stats()
    assert stats['state'] == 'serving'
    assert stats['engine']['index'] == 'id_row_ix'
    assert stats['wire'] and set(stats['wire'].values()) == {'pickle'}
    assert client.schema() is not None
    fleet = client.fleet_metrics()
    assert not fleet['unreachable']
    agg = fleet['aggregate']
    for name in ('pst_lookup_requests_total', 'pst_lookup_latency_seconds',
                 'pst_lookup_cache_hits_total'):
        assert name in agg


def test_admission_capacity_typed_refusal(store, sock):
    with LookupEngine(store.url, index_name='id_row_ix') as eng:
        with LookupServer(eng, ipc(sock, 'cap'), lease_s=1.0, max_consumers=1).start() as srv:
            with LookupClient([srv.rpc_endpoint]) as first:
                assert first.lookup([1])[0]
                with LookupClient([srv.rpc_endpoint]) as second:
                    with pytest.raises(ServerOverloaded) as exc_info:
                        second.lookup([1])
                    assert exc_info.value.reason == 'overloaded'
                assert first.lookup([2])[0]


def test_drain_refusal_fails_over_to_surviving_server(lookup_fleet):
    servers, client = lookup_fleet
    assert client.lookup([3])[0]
    reply = client._request_one(servers[0].rpc_endpoint, {'cmd': 'drain'}, 5000)
    assert reply['state'] == 'drained'
    for key in range(6):
        assert int(client.lookup([key])[0][0]['id']) == key
    client._request_one(servers[1].rpc_endpoint, {'cmd': 'drain'}, 5000)
    with pytest.raises(ServerOverloaded) as exc_info:
        client.lookup([3])
    assert exc_info.value.reason in ('draining', 'drained')


def test_lease_heartbeats_deprioritize_draining_server(lookup_fleet):
    servers, client = lookup_fleet
    client.lookup([1])
    servers[0].drain()
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        client._drain_heartbeats()
        hb = client._hb.get(servers[0].rpc_endpoint)
        if hb is not None and hb[0] in ('draining', 'drained'):
            break
        time.sleep(0.05)
    assert client._candidates()[0] == servers[1].rpc_endpoint


@pytest.mark.chaos
def test_blackholed_server_opens_breaker_then_heals(store, sock, monkeypatch):
    with LookupEngine(store.url, index_name='id_row_ix') as eng:
        with LookupServer(eng, ipc(sock, 'bh'), lease_s=1.0, rpc_workers=1).start() as server:
            with LookupClient([server.rpc_endpoint], timeout_ms=300, breaker_threshold=2,
                              breaker_reset_s=1.0) as client:
                assert client.lookup([1])[0]
                monkeypatch.setenv(faults.ENV_VAR, 'rpc-blackhole:max=10')
                for _ in range(2):
                    with pytest.raises(RpcUnanswered):
                        client.lookup([1])
                assert client.breaker_state(server.rpc_endpoint) == CircuitBreaker.OPEN
                t0 = time.perf_counter()
                with pytest.raises(RpcUnanswered):
                    client.lookup([1])
                assert time.perf_counter() - t0 < 0.25
                monkeypatch.delenv(faults.ENV_VAR)
                deadline = time.monotonic() + 10
                while time.monotonic() < deadline:
                    try:
                        if client.lookup([1])[0]:
                            break
                    except RpcUnanswered:
                        time.sleep(0.2)
                else:
                    pytest.fail('circuit never healed')
                assert client.breaker_state(server.rpc_endpoint) == CircuitBreaker.CLOSED


@pytest.mark.parametrize('rpc_workers', [1, 2])
def test_rpc_sites_fire_on_the_server(store, sock, monkeypatch, rpc_workers):
    """``server-slow`` delays a reply, ``rpc-blackhole`` swallows one: on the
    inline ROUTER and behind the REP workers alike."""
    with LookupEngine(store.url, index_name='id_row_ix') as eng:
        with LookupServer(eng, ipc(sock, 'sites'), rpc_workers=rpc_workers).start() as server:
            with LookupClient([server.rpc_endpoint], timeout_ms=1500) as client:
                assert client.lookup([1])[0]
                monkeypatch.setenv(faults.ENV_VAR, 'server-slow:delay=0.4:max=1')
                t0 = time.perf_counter()
                assert client.lookup([2])[0]
                assert time.perf_counter() - t0 >= 0.35
                monkeypatch.setenv(faults.ENV_VAR, 'rpc-blackhole:max=1')
                with pytest.raises(RpcUnanswered):
                    client.lookup([3])
                monkeypatch.delenv(faults.ENV_VAR)
                assert int(client.lookup([3])[0][0]['id']) == 3


def test_hedged_read_wins_past_a_silent_endpoint(store, sock):
    ctx = zmq.Context.instance()
    parking = ctx.socket(zmq.ROUTER)   # binds, never replies
    parking.bind(ipc(sock, 'parking'))
    try:
        with LookupEngine(store.url, index_name='id_row_ix') as eng:
            with LookupServer(eng, ipc(sock, 'live')).start() as server:
                with LookupClient([ipc(sock, 'parking'), server.rpc_endpoint], timeout_ms=5000,
                                  hedge_after_ms=100) as client:
                    t0 = time.perf_counter()
                    assert int(client.lookup([5])[0][0]['id']) == 5
                    assert time.perf_counter() - t0 < 3.0
                    assert client.hedges >= 1
    finally:
        parking.close(linger=0)


def test_stop_leaves_no_lookup_thread(store, sock):
    with LookupEngine(store.url, index_name='id_row_ix') as eng:
        server = LookupServer(eng, ipc(sock, 'threads'), rpc_workers=3).start()
        names = {t.name for t in threading.enumerate()}
        assert {'pstt-lookup-rpc', 'pstt-lookup-lease', 'pstt-lookup-worker-0',
                'pstt-lookup-worker-2'} <= names
        with LookupClient([server.rpc_endpoint]) as client:
            assert client.lookup([4])[0]
        server.stop()
    assert not [t.name for t in threading.enumerate() if t.name.startswith('pstt-lookup')]


# -- across the packages ----------------------------------------------------------------------------

def test_a_jax_client_reads_a_port_server_and_the_reverse(store, sock):
    """The lookup, pmap, chunk and stats verbs across the packages: rows
    digest-equal to the same package's own answer."""
    with LookupEngine(store.url, index_name='id_row_ix') as eng, \
            jsv.LookupEngine(store.url, index_name='id_row_ix') as ref:
        port_srv = LookupServer(eng, ipc(sock, 'port'), server_name='port-srv').start()
        jax_ep = ipc(sock, 'jax')
        jax_srv = jsv.LookupServer(ref, jax_ep, control_bind=jax_ep + '.1',
                                   server_name='jax-srv').start()
        try:
            port_srv.init_fleet(n_partitions=4, replication=1)
            jax_srv.init_fleet(n_partitions=4, replication=1)
            keys = [0, 9, 17, 33, 47, 99]
            with jsv.LookupClient([port_srv.rpc_endpoint]) as jax_client, \
                    LookupClient([jax_srv.rpc_endpoint]) as port_client:
                for client, answer in ((jax_client, eng), (port_client, ref)):
                    got = client.lookup(keys)
                    assert [[_digests(r) for r in rows] for rows in got] == \
                        [[_digests(r) for r in rows] for rows in answer.lookup(keys)]
                    pmap = client.refresh_partition_map()
                    assert pmap is not None and pmap.version == 1
                    stats = client.stats()
                    assert stats['engine']['index'] == 'id_row_ix'
                    assert stats['partition_map_version'] == 1
                    blob = client._request_one(client._endpoints[0],
                                               {'cmd': 'chunk', 'piece': 2}, 5000)['chunk']
                    assert bytes(blob) == bytes(answer.packed_chunk(2))
                # The maps the servers publish are one wire shape.
                assert port_client.partition_map.to_json().replace('jax-srv', 'x').replace(
                    jax_ep, 'ep') == jax_client.partition_map.to_json().replace(
                    'port-srv', 'x').replace(port_srv.rpc_endpoint, 'ep')
        finally:
            port_srv.stop()
            jax_srv.stop()


# -- the CLI -----------------------------------------------------------------------------------------

def _lookup_cli(package, argv, **kwargs):
    return subprocess.run([sys.executable, '-m', package + '.tools.lookup'] + argv,
                          capture_output=True, text=True, timeout=180, env=_env(), **kwargs)


def test_lookup_cli_build_index_and_point_read(tmp_path):
    rows = _rows(16, 3)
    lines = {}
    for package in ('petastorm_tpu_torch', 'petastorm_tpu'):
        url = _write(tmp_path / package, rows, 4)
        proc = _lookup_cli(package, ['--dataset-url', url, '--key', 'id=6', '--build-index'])
        assert proc.returncode == 0, proc.stderr
        lines[package] = [json.loads(line) for line in proc.stdout.splitlines() if line.strip()]
        for line in lines[package]:
            line.get('engine', {}).pop('dataset_url', None)
        absent = _lookup_cli(package, ['--dataset-url', url, '--key', 'id=999'])
        assert absent.returncode == 3
        assert json.loads(absent.stdout.splitlines()[-1])['matches'] == 0
    got = lines['petastorm_tpu_torch']
    assert got == lines['petastorm_tpu']
    assert got[0]['action'] == 'build-index' and got[0]['keys'] == 16
    assert got[1]['action'] == 'lookup' and got[1]['matches'] == 1
    assert got[1]['rows'][0]['id']['value'] == 6
    assert got[1]['rows'][0]['vec']['crc32'] == '{:#010x}'.format(_digest_array(rows[6]['vec']))


def test_lookup_cli_serve_mode(store, sock):
    import signal as signal_mod
    proc = subprocess.Popen(
        [sys.executable, '-m', 'petastorm_tpu_torch.tools.lookup', '--dataset-url', store.url,
         '--key', 'id=3', '--index', 'id_row_ix', '--serve', '--bind', ipc(sock, 'cli')],
        stdout=subprocess.PIPE, text=True, env=_env())
    try:
        assert json.loads(proc.stdout.readline())['matches'] == 1
        serve_line = json.loads(proc.stdout.readline())
        assert serve_line['action'] == 'serve'
        assert serve_line['control_endpoint'] == ipc(sock, 'cli') + '.1'
        with LookupClient([serve_line['rpc_endpoint']]) as client:
            assert int(client.lookup([11])[0][0]['id']) == 11
        proc.send_signal(signal_mod.SIGTERM)
        out, _ = proc.communicate(timeout=30)
        final = json.loads(out.splitlines()[-1])
        assert final['state'] == 'drained' and final['requests_served'] >= 1
        assert proc.returncode == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def test_the_serving_package_imports_no_torch():
    code = ('import sys; import petastorm_tpu_torch.serving, petastorm_tpu_torch.tools.lookup; '
            'print(sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "jax", "zmq")))')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True,
                         timeout=120, env=_env(), check=True).stdout
    assert json.loads(out.replace("'", '"')) == []


# -- the bench: the lookup child and phase 28's runner at a small size ------------------------------

@pytest.fixture
def small_lookup_bench(monkeypatch, tmp_path):
    from petastorm_tpu_torch import bench
    monkeypatch.setattr(bench, 'LOOKUP_ROWS', 64)
    monkeypatch.setattr(bench, 'LOOKUP_ROWS_PER_GROUP', 16)
    monkeypatch.setattr(bench, 'IMAGE', 32)
    return bench, str(tmp_path)


def test_the_lookup_child_on_the_cpu(small_lookup_bench, monkeypatch, capsys):
    """``python -m petastorm_tpu_torch.bench --child lookup --device cpu``
    at 64 rows: the JAX child's record, every read of its key, the fleet
    leg through its drain with no failed or short read and the client on
    the drain's map."""
    bench, workdir = small_lookup_bench
    monkeypatch.setenv('BENCH_LOOKUP_READS', '20')
    monkeypatch.setenv('BENCH_LOOKUP_REPS', '2')
    monkeypatch.setenv('BENCH_LOOKUP_FLEET_READS', '30')
    assert bench.main(['--child', 'lookup', '--device', 'cpu', '--workdir', workdir]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    profile = out['lookup_stage_profile']
    assert out['child'] == 'lookup' and out['platform'] == 'cpu'
    assert profile['wrong_idx'] == 0 and profile['cold_reads'] == 4
    assert profile['repetitions'] == 2 and len(profile['warm_p99_ms_reps']) == 2
    assert profile['tiers'].get('decode') == 4 and profile['hit_rate'] > 0.5
    assert set(profile) >= {'warm_p50_ms', 'warm_p99_ms', 'cold_p50_ms', 'cold_p99_ms',
                            'p99_gate_ms', 'p99_gate_passed', 'fleet', 'store', 'metrics'}
    fleet = profile['fleet']
    assert fleet['failed_lookups'] == 0 and fleet['truncated_lookups'] == 0
    assert fleet['wrong_idx'] == 0 and fleet['warm_join']['warmed_chunks'] == 4
    assert fleet['map_version_after_drain'] == 3 == fleet['client_map_version']
    assert 'pst_lookup_requests_total' in profile['metrics']


def test_the_lookup_phase_glue_on_the_cpu(small_lookup_bench):
    """``chip_smoke.run_lookup_phase`` (phase 28) on the CPU at 64 rows of
    32x32 images with ResNetTiny: (a) and (b) at their full counts of reads
    and requests, and every check of the phase on the real fleet, client and
    normalize; the CPU's normalize is its plain version, so nothing
    launches and (b)'s K1 count is 0."""
    import torch
    bench, workdir = small_lookup_bench
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    from petastorm_tpu_torch.models import ResNetTiny, create_train_state
    state = create_train_state(ResNetTiny(num_classes=10, dtype=torch.bfloat16, device='cpu'))
    line = chip_smoke.run_lookup_phase(workdir, 'cpu', 'cpu', state)
    assert line['failures'] == [], line['failures']
    assert line['phase'] == 'lookup' and line['rows'] == 64
    serve = line['serve']
    assert serve['served'] == 64 and serve['keys_per_request'] == 32 and serve['k1_launches'] == 0
    assert serve['map_version_after_drain'] == 3 == serve['client_map_version']
    first = serve['first_request']
    assert first['images_max_abs_diff_vs_opencv'] <= first['images_atol']
    assert first['k1_bf16_max_ulps_vs_plain'] == 0 and first['logits_f32_close']
    assert serve['request_p99_ms'] >= serve['request_p50_ms'] > 0
    assert state.model.training, 'the runner gives the model back in train mode'
    profile = line['lookup_stage_profile']
    assert profile['reads_per_rep'] == 200 and profile['fleet']['reads'] == 300
