"""The multi-GPU dry run (counterpart of ``__graft_entry__.dryrun_multichip``),
run by every rank of a job:

1. dp x tp ResNetTiny (``{'data': n/2, 'model': 2}``, the head split by
   column) from a tiny PNG Parquet store through ``make_pod_reader`` and the
   mesh ``TorchLoader``, every step behind ``PodSafeIterator``: three steps,
   ``state_dict()`` mid-epoch, teardown, a resume with ``resume_state=`` to
   the end of the epoch; no sample lost or repeated (but the dropped tail),
   the loss descending, and every rank staging its tile;
2. the HBM tier on the mesh: epoch 0 streams and caches, epochs 1-2 train
   from device memory, each a permutation of the same samples;
3. the LM on dp x sp x tp (``{'data': n/4, 'sp': 2, 'model': 2}``) with
   ring and with all-to-all attention, three epochs of four pod-guarded
   SGD steps each on a learnable token sequence; the two loss trajectories
   agree and descend.

On GPUs: ``torchrun --nproc-per-node=N -m petastorm_tpu_torch.parallel.dryrun``
(NCCL, one GPU a rank). On the CPU: ``python -m
petastorm_tpu_torch.parallel.dryrun --spawn N`` (gloo ranks).
"""

import argparse
import collections
import os
import shutil
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from petastorm_tpu_torch.parallel.mesh import axis_index, make_mesh
from petastorm_tpu_torch.parallel.pod_guard import PodSafeIterator


def _require(ok, message):
    """A claim of the dry run: ``AssertionError`` with ``message`` unless
    ``ok`` (kept under ``python -O``, unlike ``assert``)."""
    if not ok:
        raise AssertionError(message)


def _log(*parts):
    if dist.get_rank() == 0:
        print(*parts, flush=True)


def _shared_dir(workdir):
    """One scratch directory for every rank (rank 0 makes it)."""
    names = [tempfile.mkdtemp(prefix='pstt_dryrun_', dir=workdir) if dist.get_rank() == 0
             else None]
    dist.broadcast_object_list(names, src=0)
    return names[0]


def _gather(obj):
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _image_store(url, n_rows, rows_per_row_group):
    from petastorm_tpu_torch import (CompressedImageCodec, ScalarCodec, Unischema,
                                     UnischemaField, write_dataset)
    schema = Unischema('DryRun', [
        UnischemaField('image', np.uint8, (16, 16, 3), CompressedImageCodec('png'), False),
        UnischemaField('label', np.int64, (), ScalarCodec(np.int64), False),
        UnischemaField('sample_id', np.int64, (), ScalarCodec(np.int64), False)])
    rng = np.random.default_rng(0)
    # Each class has its own mean colour, so a few steps must lower the loss.
    palette = rng.integers(40, 216, (10, 3))

    def rows():
        for i in range(n_rows):
            label = i % 10
            img = np.clip(palette[label] + rng.integers(-25, 26, (16, 16, 3)), 0, 255)
            yield {'image': img.astype(np.uint8), 'label': label, 'sample_id': i}

    write_dataset(url, schema, rows(), rows_per_row_group=rows_per_row_group)


def _token_store(url, n_rows, seq_len, vocab):
    from petastorm_tpu_torch import NdarrayCodec, Unischema, UnischemaField, write_dataset
    schema = Unischema('LMDryRun', [
        UnischemaField('tokens', np.int32, (seq_len,), NdarrayCodec(), False)])
    rng = np.random.default_rng(1)
    # A learnable sequence (each token is its predecessor plus one), so the
    # loss must fall within an epoch; random tokens would certify finiteness.
    write_dataset(url, schema, ({'tokens': ((rng.integers(0, vocab) + np.arange(seq_len)) % vocab)
                                 .astype(np.int32)} for _ in range(n_rows)),
                  rows_per_row_group=2)


def _one_per_data_shard(mesh, value):
    """``value`` of every data shard, in shard order (the shard's rank with
    every other coordinate 0)."""
    coords = _gather((tuple(mesh.get_coordinate()), value))
    names = mesh.mesh_dim_names
    return [v for coord, v in sorted(coords, key=lambda cv: cv[0][names.index('data')])
            if all(c == 0 for a, c in zip(names, coord) if a != 'data')]


def _data_shard_ids(mesh, ids):
    """Every sample id the data shards saw, once a shard (tensor and
    sequence peers read the same rows)."""
    return [i for seen in _one_per_data_shard(mesh, ids) for i in seen]


def _resnet_axes(n):
    model_par = 2 if n % 2 == 0 else 1
    return {'data': n // model_par, 'model': model_par}


def _resnet_phase(n, url, device, n_rows, global_batch):
    from petastorm_tpu_torch import TorchLoader, make_pod_reader
    from petastorm_tpu_torch.models.resnet import ResNetTiny, init_flax_like
    from petastorm_tpu_torch.models.train import create_train_state, make_train_step
    mesh = make_mesh(_resnet_axes(n), device=device.type)
    model = init_flax_like(ResNetTiny(num_classes=10, device=device),
                           torch.Generator().manual_seed(0))
    # lr 0.05: the colour mapping descends in a few steps and stays stable.
    state = create_train_state(model, learning_rate=0.05, mesh=mesh)
    step = make_train_step(mesh=mesh)

    def pipeline(resume_state=None):
        # Deterministic: the tensor peers of a data shard read it in one order.
        reader = make_pod_reader(url, mesh=mesh, reader_pool_type='thread', workers_count=2,
                                 num_epochs=1, shuffle_row_groups=True, seed=0,
                                 deterministic=True, resume_state=resume_state)
        loader = TorchLoader(reader, global_batch, mesh=mesh, last_batch='drop')
        return reader, loader, PodSafeIterator(loader, mesh=mesh, on_abort='stop')

    seen, losses = [], []

    def drive(batches, max_steps=None):
        steps = 0
        for batch in batches:
            metrics = step(state, batch.image.float() / 255.0, batch.label)
            loss = float(metrics['loss'])
            _require(np.isfinite(loss), 'non-finite loss {} at step {}'.format(loss, len(losses)))
            losses.append(loss)
            seen.extend(batch.sample_id.cpu().tolist())
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return steps

    reader, loader, safe = pipeline()
    with reader, loader:
        steps1 = drive(safe, max_steps=3)
        stats = loader.stats
        resume = loader.state_dict()
    _require(steps1 == 3, 'expected 3 steps before the checkpoint, got {}'.format(steps1))
    staged = _gather((stats['n_devices'], stats['shards_put']))
    _require(sum(d for d, _ in staged) == n, 'per-device staging covered {}'.format(staged))
    _require(all(put >= steps1 for _, put in staged), staged)
    # A deterministic resume over shards takes every shard's cursor, merged
    # (at a row-group boundary: a shard's batch is one row-group).
    from petastorm_tpu_torch.determinism import merge_cursors
    reader, loader, safe = pipeline(resume_state=merge_cursors(_one_per_data_shard(mesh, resume)))
    with reader, loader:
        steps2 = drive(safe)
    _require(steps2 >= 1, 'the resumed run delivered no step')
    ids = _data_shard_ids(mesh, seen)
    _require(len(ids) == len(set(ids)), 'duplicate samples after the resume')
    missed = n_rows - len(ids)
    _require(0 <= missed < global_batch, 'lost {} rows across the resume'.format(missed))
    _require(np.mean(losses[-2:]) < np.mean(losses[:2]), 'loss did not decrease: {}'.format(losses))
    _log('dryrun_multigpu OK: mesh={} steps={}+{} samples={}/{} loss={} (pod-guarded, resumed '
         'mid-epoch, DESCENDING; per-rank staging {})'.format(
             dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)), steps1, steps2, len(ids), n_rows,
             ['{:.4f}'.format(x) for x in losses], staged))
    return mesh, state, step


def _device_cache_phase(url, mesh, state, step, global_batch):
    from petastorm_tpu_torch import DeviceDatasetCache, TorchLoader, make_pod_reader
    reader = make_pod_reader(url, mesh=mesh, reader_pool_type='thread', workers_count=2,
                             num_epochs=1, shuffle_row_groups=True, seed=0, deterministic=True)
    losses = []
    with reader:
        with TorchLoader(reader, global_batch, mesh=mesh, last_batch='drop') as loader:
            cache = DeviceDatasetCache(loader, shuffle=True, seed=0)
            batches0 = 0
            for batch in PodSafeIterator(cache.epoch(0), mesh=mesh, on_abort='stop'):
                step(state, batch.image.float() / 255.0, batch.label)
                batches0 += 1
    seen = []
    for epoch in (1, 2):
        n = 0
        for batch in cache.epoch(epoch):
            losses.append(float(step(state, batch.image.float() / 255.0, batch.label)['loss']))
            seen.extend(batch.sample_id.cpu().tolist())
            n += 1
        _require(n == batches0, 'device-cache epoch {} yielded {} batches, epoch 0 {}'.format(
            epoch, n, batches0))
    _require(all(np.isfinite(x) for x in losses), losses)
    counts = collections.Counter(_data_shard_ids(mesh, seen))
    _require(set(counts.values()) == {2}, 'device-cache epochs are not one multiset')
    cache.clear()
    _log('dryrun_multigpu device-cache OK: {} batches/epoch x 3 epochs (epochs 1-2 from device '
         'memory, reshuffled on the device), loss[last]={:.4f}'.format(batches0, losses[-1]))


def _lm_axes(n):
    sp = 2 if n % 2 == 0 else 1
    tp = 2 if n % (sp * 2) == 0 else 1
    return {'data': n // (sp * tp), 'sp': sp, 'model': tp}


def _lm_phase(n, url, device, seq_len, vocab, batch):
    from petastorm_tpu_torch import TorchLoader, make_pod_reader
    from petastorm_tpu_torch.models.train import (create_train_state, make_lm_train_step,
                                                  transformer_param_spec)
    from petastorm_tpu_torch.models.transformer import TransformerLM, init_flax_like
    from petastorm_tpu_torch.parallel.mesh import sequence_sharding
    mesh = make_mesh(_lm_axes(n), device=device.type)
    trajectories = {}
    for scheme in ('ring', 'a2a'):
        # 4 heads: a2a needs the heads of a tensor shard (4/2) to divide by sp.
        model = init_flax_like(TransformerLM(vocab, 16, 4, 1, max_len=seq_len, attention=scheme,
                                             dtype=torch.float32, device=device, mesh=mesh,
                                             seq_axis='sp'),
                               torch.Generator().manual_seed(0))
        state = create_train_state(model, learning_rate=0.1, momentum=0.0, mesh=mesh,
                                   param_spec_fn=transformer_param_spec)
        step = make_lm_train_step(mesh=mesh)
        losses = []
        # Deterministic: both schemes and every peer see one batch sequence.
        with make_pod_reader(url, mesh=mesh, reader_pool_type='thread', workers_count=2,
                             num_epochs=3, seed=0, deterministic=True) as reader:
            with TorchLoader(reader, batch, mesh=mesh, last_batch='drop', sharding={
                    'tokens': sequence_sharding(mesh, seq_axis='sp')}) as loader:
                for b in PodSafeIterator(loader, mesh=mesh, on_abort='stop'):
                    losses.append(float(step(state, b.tokens)['loss']))
                    _require(np.isfinite(losses[-1]), 'LM sp({}) non-finite loss'.format(scheme))
        _require(len(losses) >= 3, 'the LM phase must train 3 steps, got {}'.format(len(losses)))
        trajectories[scheme] = losses
    ring, a2a = trajectories['ring'], trajectories['a2a']
    np.testing.assert_allclose(ring, a2a, rtol=1e-4, atol=1e-5,
                               err_msg='ring vs a2a loss trajectories diverge')
    _require(ring[-1] < ring[0], 'loss did not decrease: {}'.format(ring))
    _log('dryrun_multigpu LM OK: mesh={} (dp x sp x tp) {} steps/scheme loss[ring]={} '
         'loss[a2a]={} (sp rank {})'.format(
             dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)), len(ring),
             ['{:.4f}'.format(x) for x in ring], ['{:.4f}'.format(x) for x in a2a],
             axis_index(mesh, 'sp')))
    return trajectories


def dryrun_multigpu(n_devices, device='cuda', workdir=None):
    """Run the three phases on this rank of an ``n_devices``-rank job (the
    default process group must be up) on ``device``: ``'cuda'`` (the
    default; raises without a GPU) or ``'cpu'`` for gloo ranks. Raises
    ``AssertionError`` on a failed claim; returns the LM's loss
    trajectories."""
    from petastorm_tpu_torch.device import resolve_device
    device = resolve_device(device)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError('dryrun_multigpu runs on every rank of a started process group')
    if dist.get_world_size() != n_devices:
        raise ValueError('dryrun_multigpu({}) on a group of {} ranks'.format(
            n_devices, dist.get_world_size()))
    root = _shared_dir(workdir)
    try:
        global_batch = 2 * n_devices
        n_rows = 8 * global_batch
        seq_len, vocab = 32, 64
        lm_batch = 2 * _lm_axes(n_devices)['data']
        images = 'file://' + os.path.join(root, 'images')
        tokens = 'file://' + os.path.join(root, 'tokens')
        if dist.get_rank() == 0:
            # One row-group a shard's batch, so a checkpoint between batches
            # is a row-group boundary, where merged cursors resume exactly.
            _image_store(images, n_rows, global_batch // _resnet_axes(n_devices)['data'])
            # Four full steps an epoch.
            _token_store(tokens, 4 * lm_batch, seq_len, vocab)
        dist.barrier()
        mesh, state, step = _resnet_phase(n_devices, images, device, n_rows, global_batch)
        _device_cache_phase(images, mesh, state, step, global_batch)
        return _lm_phase(n_devices, tokens, device, seq_len, vocab, lm_batch)
    finally:
        dist.barrier()
        if dist.get_rank() == 0:
            shutil.rmtree(root, ignore_errors=True)


def _spawned_rank(rank, world, workdir):
    return dryrun_multigpu(world, device='cpu', workdir=workdir)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--spawn', type=int, default=0,
                        help='run N gloo ranks on the CPU instead of joining a torchrun job')
    args = parser.parse_args(argv)
    if args.spawn:
        from petastorm_tpu_torch.parallel.launch import spawn
        spawn(_spawned_rank, args.spawn, (None,), timeout=600)
        return 0
    from petastorm_tpu_torch.parallel.launch import init_from_env
    with init_from_env('cuda') as device:
        dryrun_multigpu(dist.get_world_size(), device=device)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
