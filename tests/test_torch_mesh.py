"""The port's mesh layer on gloo ranks, held against the JAX package's on
its virtual CPU devices: ``make_mesh``'s errors, ``device_shard_plan`` on the
shapes of ``test_multichip_staging.py:73-101``, ``make_pod_reader`` (two
simulated ranks interleave to the one-rank stream, digest-equal to JAX's
simulated hosts), tensor-parallel peers reading the same rows, and the mesh
``TorchLoader``'s tiles against the JAX loader's global arrays, a
sequence-split field included. Host batches are compared bit for bit by
per-field CRC32 (``lineage._digest_array``). One 4-rank group serves every
multi-rank case.
"""

import zlib

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

import torch_mesh_ranks
from petastorm_tpu import make_pod_reader as jax_make_pod_reader
from petastorm_tpu.jax_loader import JaxLoader
from petastorm_tpu.parallel import make_mesh as jax_make_mesh
from petastorm_tpu.parallel.mesh import batch_sharding as jax_batch_sharding
from petastorm_tpu.parallel.mesh import device_shard_plan as jax_device_shard_plan
from petastorm_tpu.parallel.mesh import sequence_sharding as jax_sequence_sharding
from petastorm_tpu_torch import (NdarrayCodec, ScalarCodec, TorchLoader, Unischema,
                                 UnischemaField, make_pod_reader, write_dataset)
from petastorm_tpu_torch.parallel import make_mesh
from petastorm_tpu_torch.parallel.launch import spawn
from petastorm_tpu_torch.parallel.mesh import mesh_shape, process_shard

ROWS, ROWS_PER_GROUP, T = 64, 4, 8
BATCH = 2 * ROWS_PER_GROUP          # two data shards: one row-group each a batch
PLAN_CASES = [(('data',), (16, 3)), (('data', 'model'), (16, 8)), (('data',), (6, 3)),
              ((), (16, 3))]


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    url = 'file://' + str(tmp_path_factory.mktemp('mesh_store'))
    schema = Unischema('MeshStore', [
        UnischemaField('id', np.int32, (), ScalarCodec(np.int32), False),
        UnischemaField('tokens', np.int32, (T,), NdarrayCodec(), False)])
    write_dataset(url, schema, ({'id': i, 'tokens': (np.arange(T) + 100 * i).astype(np.int32)}
                                for i in range(ROWS)), rows_per_row_group=ROWS_PER_GROUP)
    return url


@pytest.fixture(scope='module')
def ranks(store):
    return spawn(torch_mesh_ranks.mesh_loader_cases, 4, (store, BATCH, PLAN_CASES), timeout=90)


def test_make_mesh_errors_match_jax():
    assert mesh_shape({'data': -1, 'model': 2}, 8) == {'data': 4, 'model': 2}
    for axes, n in (({'data': -1, 'model': -1}, 8), ({'data': 3}, 8), ({'data': 2}, 8)):
        with pytest.raises(ValueError) as port_error:
            mesh_shape(axes, n)
        with pytest.raises(ValueError) as jax_error:
            jax_make_mesh(axes, devices=jax.devices()[:n])
        assert str(port_error.value) == str(jax_error.value)


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match='initialised process group'):
        make_mesh({'data': 1}, device='cpu')
    assert process_shard() == (0, 1)


@pytest.mark.timeout(200)
def test_device_shard_plans_match_jax(ranks):
    mesh = jax_make_mesh({'data': 2, 'model': 2}, devices=jax.devices()[:4])
    for (spec, shape), got in zip(PLAN_CASES, ranks[0]['plans']):
        want = jax_device_shard_plan(NamedSharding(mesh, PartitionSpec(*spec)), shape,
                                     process_count=1)
        if want is None:
            assert got is None, (spec, shape)
            continue
        n, global_shape, by_rank = got
        assert (n, global_shape) == (want.n_devices, want.global_shape)
        # Device k of the JAX mesh is rank k of the port's (row-major).
        jax_bounds = sorted((int(np.argwhere(mesh.devices == d)[0] @ [2, 1]), b)
                            for d, b in zip(want.devices, want.bounds))
        assert by_rank == jax_bounds


@pytest.mark.timeout(200)
def test_tensor_parallel_peers_read_the_same_rows(ranks):
    assert [r['shard'] for r in ranks] == [(0, 2), (0, 2), (1, 2), (1, 2)]
    assert ranks[0]['ids'] == ranks[1]['ids'] and ranks[2]['ids'] == ranks[3]['ids']
    assert not set(ranks[0]['ids']) & set(ranks[2]['ids'])
    assert sorted(ranks[0]['ids'] + ranks[2]['ids']) == list(range(ROWS))


def _digests(batches):
    return [tuple(zlib.crc32(np.ascontiguousarray(np.asarray(getattr(b, f)).astype(np.int32))
                             .tobytes()) for f in ('id', 'tokens')) for b in batches]


def _port_host(url, pod_shard):
    with make_pod_reader(url, pod_shard=pod_shard, deterministic=True, seed=7, num_epochs=1,
                         shuffle_row_groups=True, workers_count=2) as reader:
        with TorchLoader(reader, ROWS_PER_GROUP, device='cpu') as loader:
            return _digests(loader)


def _jax_host(url, pod_shard):
    with jax_make_pod_reader(url, pod_shard=pod_shard, deterministic=True, seed=7,
                             num_epochs=1, shuffle_row_groups=True,
                             reader_pool_type='thread', workers_count=2) as reader:
        with JaxLoader(reader, ROWS_PER_GROUP) as loader:
            return _digests(loader)


def _interleave(per_host):
    return [per_host[k % len(per_host)][k // len(per_host)]
            for k in range(sum(len(p) for p in per_host))]


def test_pod_reader_hosts_interleave_to_the_one_rank_stream_like_jax(store):
    single = _port_host(store, (0, 1))
    hosts = [_port_host(store, (h, 2)) for h in (0, 1)]
    assert _interleave(hosts) == single
    assert hosts == [_jax_host(store, (h, 2)) for h in (0, 1)]
    assert single == _jax_host(store, (0, 1))


def test_pod_reader_owns_the_shard_arguments(store):
    with pytest.raises(ValueError, match='owns cur_shard'):
        make_pod_reader(store, cur_shard=0, shard_count=2)


@pytest.mark.timeout(200)
def test_mesh_loader_tiles_match_the_jax_loaders_global_arrays(store, ranks):
    mesh = jax_make_mesh({'data': 2, 'sp': 2}, devices=jax.devices()[:4])
    with jax_make_pod_reader(store, pod_shard=(0, 1), deterministic=True, seed=7,
                             num_epochs=1, shuffle_row_groups=True,
                             reader_pool_type='thread', workers_count=1) as reader:
        with JaxLoader(reader, BATCH, mesh=mesh, sharding={
                'id': jax_batch_sharding(mesh),
                'tokens': jax_sequence_sharding(mesh, seq_axis='sp')}) as loader:
            want = [{f: np.asarray(getattr(b, f)) for f in b._fields} for b in loader]
    assert len(want) == ROWS // BATCH
    for rank in ranks:
        rows, cols = rank['index']
        assert len(rank['tiles']) == len(want)
        for got, whole in zip(rank['tiles'], want):
            np.testing.assert_array_equal(got['id'], whole['id'][rows])
            np.testing.assert_array_equal(got['tokens'], whole['tokens'][rows, cols])
            assert got['tokens'].shape == (BATCH // 2, T // 2)


@pytest.mark.timeout(200)
def test_mesh_loader_counts_its_tile_copies(ranks):
    for rank in ranks:
        stats = rank['stats']
        assert stats['n_devices'] == 1
        # One tile copy a batch (the id field); tokens is cut on the device.
        assert stats['shards_put'] == ROWS // BATCH
        assert stats['device_put_bytes']['cpu'] == (ROWS // BATCH) * (BATCH // 2) * 4 * (1 + T // 2)


def test_mesh_loader_refuses_partial_batches_and_uneven_splits():
    class _Mesh(object):
        mesh_dim_names = ('data',)

        def size(self, dim):
            return 2

    with pytest.raises(ValueError, match="last_batch='partial'"):
        TorchLoader(iter(()), 8, device='cpu', mesh=_Mesh(), last_batch='partial')
    with pytest.raises(ValueError, match='does not divide'):
        TorchLoader(iter(()), 7, device='cpu', mesh=_Mesh())
    with pytest.raises(ValueError, match='not an axis'):
        TorchLoader(iter(()), 8, device='cpu', mesh=_Mesh(), batch_axis='sp')


def test_mesh_loader_refuses_peers_without_a_deterministic_reader():
    """Tensor peers read one data shard each through a reader of their
    own: an order that may differ between them would train them on
    different rows."""
    class _Mesh(object):
        mesh_dim_names = ('data', 'model')

        def size(self, dim):
            return (1, 2)[dim]

    with pytest.raises(ValueError, match='deterministic=True'):
        TorchLoader(iter(()), 8, device='cpu', mesh=_Mesh())


def test_mesh_loader_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='is_available'):
        TorchLoader(iter(()), 8)


def test_make_mesh_defaults_to_cuda_and_raises_without_it(tmp_path, monkeypatch):
    """In a group of one rank: the default device is CUDA, absent here, so
    ``make_mesh`` raises; ``device='cpu'`` gives a gloo mesh."""
    import torch.distributed as dist
    dist.init_process_group('gloo', init_method='file://' + str(tmp_path / 'init'), rank=0,
                            world_size=1)
    try:
        monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
        with pytest.raises(RuntimeError, match='is_available'):
            make_mesh({'data': 1})
        mesh = make_mesh({'data': -1, 'model': 1}, device='cpu')
        assert mesh.mesh_dim_names == ('data', 'model') and process_shard(mesh) == (0, 1)
        assert process_shard() == (0, 1)
    finally:
        dist.destroy_process_group()
