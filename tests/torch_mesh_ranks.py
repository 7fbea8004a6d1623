"""Rank programs of the port's multi-rank tests, run by
``petastorm_tpu_torch.parallel.launch.spawn`` in gloo processes.

Each function is ``fn(rank, world, *args)`` and returns numpy values for
the test to hold against the JAX package. This module imports only torch,
numpy and the port, so the ranks start without JAX.
"""

import numpy as np
import torch

from petastorm_tpu_torch.parallel import PodAbortError, PodSafeIterator, global_all, make_mesh


def _np(t):
    return t.detach().float().numpy().copy()


# -- data and tensor parallelism (ResNetTiny) ----------------------------------

def resnet_steps(rank, world, axes, params, batch_stats, x, labels, steps):
    """Momentum-SGD steps of ResNetTiny on a mesh: the global losses and
    accuracies, and this rank's state (shards as held)."""
    from petastorm_tpu_torch.convert import load_flax_resnet, sharded_state_from_flax
    from petastorm_tpu_torch.models.resnet import ResNetTiny
    from petastorm_tpu_torch.models.train import make_train_step
    from petastorm_tpu_torch.parallel.mesh import batch_sharding
    mesh = make_mesh(axes, device='cpu')
    model = ResNetTiny(num_classes=10, dtype=torch.float32, device='cpu')
    state = sharded_state_from_flax(model, load_flax_resnet, params, batch_stats, mesh=mesh,
                                    learning_rate=0.1, momentum=0.9)
    step = make_train_step(mesh=mesh)
    tile = batch_sharding(mesh).index(x.shape)
    metrics = []
    for i in range(steps):
        xi = x[::-1].copy() if i else x
        li = labels[::-1].copy() if i else labels
        out = step(state, torch.from_numpy(xi[tile]), torch.from_numpy(li[tile[:1]]))
        metrics.append((float(out['loss']), float(out['accuracy'])))
    return {'metrics': metrics,
            'state': {k: _np(v) for k, v in model.state_dict().items()},
            'placements': {k: v[0] for k, v in state.placements.items()}}


def pod_guard_cases(rank, world):
    """PodSafeIterator under a real 2-rank vote (``test_pod_guard.py:144-160``)."""
    out = {}

    def failing():
        yield 0
        if rank == 1:
            raise RuntimeError('rank 1 input died')
        yield 1
        yield 2

    got = []
    try:
        for b in PodSafeIterator(failing()):
            got.append(b)
        out['peer_failure'] = ('finished', got)
    except PodAbortError:
        out['peer_failure'] = ('abort', got)
    except RuntimeError as e:
        out['peer_failure'] = ('own', got, str(e))
    # Uneven tails: rank 0 has 3 batches, rank 1 has 5; both stop after 3.
    out['uneven'] = list(PodSafeIterator(iter(range(3 if rank == 0 else 5)), on_abort='stop'))
    out['global_all'] = (global_all(True), global_all(rank == 0))
    return out


# -- sequence parallelism -----------------------------------------------------

def attention_cases(rank, world, cases):
    """Ring and a2a attention of each case's ``[B, T, H, D]`` arrays on a
    mesh: this rank's tiles of the output and of dq, dk, dv."""
    from petastorm_tpu_torch.models.attention import a2a_self_attention, ring_self_attention
    from petastorm_tpu_torch.parallel.mesh import Sharding
    meshes = {}
    results = []
    for case in cases:
        axes = case['axes']
        key = tuple(axes.items())
        if key not in meshes:
            meshes[key] = make_mesh(axes, device='cpu')
        mesh = meshes[key]
        q, k, v, g = (torch.from_numpy(a) for a in case['arrays'])
        # [B, T, H, D]: batch over 'data', sequence over 'sp', heads over 'model'.
        spec = ['data' if 'data' in axes else None, 'sp',
                'model' if 'model' in axes else None, None]
        index = Sharding(mesh, spec).index(q.shape)
        fn = ring_self_attention if case['scheme'] == 'ring' else a2a_self_attention
        ql, kl, vl = (x[index].clone().requires_grad_() for x in (q, k, v))
        try:
            out = fn(ql, kl, vl, mesh, 'sp', causal=case['causal'])
        except ValueError as e:
            results.append({'error': str(e)})
            continue
        out.backward(g[index])
        results.append({'index': index, 'out': _np(out), 'dq': _np(ql.grad),
                        'dk': _np(kl.grad), 'dv': _np(vl.grad)})
    return results


def lm_steps(rank, world, configs, model_config, params, tokens, steps):
    """SGD steps of a TransformerLM (f32, lr 0.1, no momentum) for each
    ``(mesh axes, attention schemes)`` of ``configs``: per config and
    scheme, the global losses and this rank's params."""
    from petastorm_tpu_torch.convert import load_flax_transformer, sharded_state_from_flax
    from petastorm_tpu_torch.models.moe import expert_param_spec
    from petastorm_tpu_torch.models.train import make_lm_train_step, transformer_param_spec
    from petastorm_tpu_torch.models.transformer import TransformerLM
    from petastorm_tpu_torch.parallel.mesh import Sharding
    spec_fn = expert_param_spec if model_config.get('moe_experts') else transformer_param_spec
    out = []
    for axes, schemes in configs:
        mesh = make_mesh(axes, device='cpu')
        runs = {}
        for scheme in schemes:
            seq_axis = 'sp' if scheme in ('ring', 'a2a') else None
            model = TransformerLM(attention=scheme, dtype=torch.float32, device='cpu',
                                  mesh=mesh, seq_axis=seq_axis, **model_config)
            state = sharded_state_from_flax(model, load_flax_transformer, params, mesh=mesh,
                                            param_spec_fn=spec_fn,
                                            learning_rate=0.1, momentum=0.0)
            step = make_lm_train_step(mesh=mesh)
            batch = tuple(a for a in ('data', 'expert') if a in axes)
            tile = Sharding(mesh, (batch, seq_axis)).index(tokens.shape)
            losses = [float(step(state, torch.from_numpy(tokens[tile]))['loss'])
                      for _ in range(steps)]
            runs[scheme] = {'losses': losses,
                            'params': {k: _np(v) for k, v in model.state_dict().items()},
                            'placements': {k: v[0] for k, v in state.placements.items()}}
        out.append(runs)
    return out


# -- expert parallelism -------------------------------------------------------

def moe_ep(rank, world, axes, params, x, grad):
    """Expert-parallel SwitchMoE: this rank's groups in, its output tile,
    its input gradient and its (expert) weight gradients out."""
    from petastorm_tpu_torch.models.moe import SwitchMoE, expert_param_spec
    from petastorm_tpu_torch.parallel.mesh import batch_sharding
    from petastorm_tpu_torch.parallel.tensor_parallel import shard_parameters
    mesh = make_mesh(axes, device='cpu')
    e = params['w_up'].shape[0]
    d = x.shape[-1]
    moe = SwitchMoE(d, e, capacity_factor=4.0, dtype=torch.float32, mesh=mesh,
                    expert_axis='expert', batch_axes=('expert',))
    with torch.no_grad():
        moe.router.weight.copy_(torch.from_numpy(params['router']['kernel'].T.copy()))
        moe.router.bias.copy_(torch.tensor(params['router']['bias']))
        moe.w_up.copy_(torch.tensor(params['w_up']))
        moe.w_down.copy_(torch.tensor(params['w_down']))
    placements = shard_parameters(moe, mesh, lambda n, p, m, mod: expert_param_spec(
        'block.moe.' + n, p, m, mod))
    tile = batch_sharding(mesh, 'expert').index(x.shape)
    xl = torch.from_numpy(x[tile]).requires_grad_()
    out = moe(xl)
    (out * torch.from_numpy(grad[tile])).sum().backward()
    return {'tile': tile, 'out': _np(out), 'dx': _np(xl.grad), 'aux': float(moe.aux_loss.detach()),
            'dw_up': _np(moe.w_up.grad), 'w_up_local': _np(moe.w_up),
            'placements': {k: v[0] for k, v in placements.items()}}


# -- pipeline -----------------------------------------------------------------

def pipeline_cases(rank, world, params, x, grad, microbatch_counts):
    """``pipeline_apply`` with a 2-layer MLP stage on ``{'pipe': world}``:
    outputs and gradients (of ``sum(out * grad)``) for each microbatch count,
    and the refusal of a batch that does not divide."""
    from petastorm_tpu_torch.models.pipeline import pipeline_apply

    def stage_fn(p, h):
        return torch.tanh(h @ p['w'] + p['b']) * p['scale']

    mesh = make_mesh({'pipe': world}, device='cpu')
    out = {}
    for m in microbatch_counts:
        leaves = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
        xt = torch.from_numpy(x).requires_grad_()
        y = pipeline_apply(stage_fn, leaves, xt, mesh, microbatches=m)
        (y * torch.from_numpy(grad)).sum().backward()
        out[m] = {'out': _np(y), 'dx': _np(xt.grad),
                  'grads': {k: _np(v.grad) for k, v in leaves.items()}}
    try:
        pipeline_apply(stage_fn, {k: torch.from_numpy(v) for k, v in params.items()},
                       torch.from_numpy(x[:-1]), mesh, microbatches=2)
        out['indivisible'] = None
    except ValueError as e:
        out['indivisible'] = str(e)
    return out


# -- the sharded job checkpoint -------------------------------------------------

def checkpoint_save(rank, world, axes, directory, x, labels):
    """One ResNetTiny step on a mesh, a sharded save (with this rank's
    loader state), then a restore into a fresh state of the same mesh."""
    from petastorm_tpu_torch.job_checkpoint import JobCheckpointer
    from petastorm_tpu_torch.models.resnet import ResNetTiny, init_flax_like
    from petastorm_tpu_torch.models.train import create_train_state, make_train_step
    from petastorm_tpu_torch.parallel.mesh import batch_sharding

    def fresh(mesh, seed):
        model = init_flax_like(ResNetTiny(num_classes=10, dtype=torch.float32, device='cpu'),
                               torch.Generator().manual_seed(seed))
        return model, create_train_state(model, learning_rate=0.1, momentum=0.9, mesh=mesh)

    mesh = make_mesh(axes, device='cpu')
    model, state = fresh(mesh, 0)
    tile = batch_sharding(mesh).index(x.shape)
    make_train_step(mesh=mesh)(state, torch.from_numpy(x[tile]),
                               torch.from_numpy(labels[tile[:1]]))
    with JobCheckpointer(directory) as ckpt:
        ckpt.save(1, state, loader={'rank': rank, 'pos': 10 + rank}, extra={'tag': 'x'})
    model2, state2 = fresh(mesh, 1)
    with JobCheckpointer(directory) as ckpt:
        restored = ckpt.restore(state2)

    def momenta(model, state):
        return {n: _np(state.optimizer.state[p]['momentum_buffer'])
                for n, p in model.named_parameters()}

    return {'state': {k: _np(v) for k, v in model.state_dict().items()},
            'momenta': momenta(model, state),
            'restored': {k: _np(v) for k, v in model2.state_dict().items()},
            'restored_momenta': momenta(model2, state2),
            'loader_state': restored.loader_state, 'loader_states': restored.loader_states,
            'step': restored.state.step, 'extra': restored.extra,
            'placements': {k: v[0] for k, v in state.placements.items()}}


def full_from_shards(results, name, value_key='state', mesh_axes=None):
    """The global value of a split tensor from every rank's shard (ranks in
    row-major mesh order over ``mesh_axes``); a whole one from rank 0."""
    spec = results[0]['placements'].get(name)
    if spec is None:
        return results[0][value_key][name]
    names = list(mesh_axes)
    sizes = [mesh_axes[a] for a in names]
    pieces = {}
    for rank, res in enumerate(results):
        coord = np.unravel_index(rank, sizes)
        key = tuple(coord[names.index(a)] if a is not None else 0 for a in spec)
        pieces[key] = res[value_key][name]
    dims = [d for d, a in enumerate(spec) if a is not None]
    assert len(dims) == 1, spec
    d = dims[0]
    n = mesh_axes[spec[d]]
    parts = []
    for i in range(n):
        key = tuple(i if j == d else 0 for j in range(len(spec)))
        parts.append(pieces[key])
    return np.concatenate(parts, axis=d)



# -- the mesh, the pod reader and the mesh loader -------------------------------

def mesh_loader_cases(rank, world, url, batch, plan_cases):
    """On ``{'data': 2, 'model': 2}``: this rank's shard, the rows its pod
    reader delivers and the plans of ``plan_cases``; on ``{'data': 2, 'sp':
    2}``: the mesh loader's tiles (tokens split over 'sp') and counters."""
    from petastorm_tpu_torch import TorchLoader, make_pod_reader
    from petastorm_tpu_torch.parallel.mesh import (Sharding, device_shard_plan, process_shard,
                                                   replicated_sharding, sequence_sharding)
    out = {}
    mesh = make_mesh({'data': 2, 'model': 2}, device='cpu')
    out['shard'] = process_shard(mesh)
    with make_pod_reader(url, mesh=mesh, deterministic=True, seed=7, num_epochs=1,
                         shuffle_row_groups=True, workers_count=1) as reader:
        out['ids'] = [int(i) for chunk in reader for i in chunk.id]
    plans = []
    for spec, shape in plan_cases:
        plan = device_shard_plan(Sharding(mesh, spec) if spec else replicated_sharding(mesh),
                                 shape)
        plans.append(None if plan is None else (plan.n_devices, plan.global_shape,
                                                sorted(zip(plan.ranks, plan.bounds))))
    out['plans'] = plans
    mesh = make_mesh({'data': 2, 'sp': 2}, device='cpu')
    tiles = []
    with make_pod_reader(url, mesh=mesh, deterministic=True, seed=7, num_epochs=1,
                         shuffle_row_groups=True, workers_count=1) as reader:
        with TorchLoader(reader, batch, mesh=mesh,
                         sharding={'tokens': sequence_sharding(mesh, seq_axis='sp')}) as loader:
            for b in loader:
                tiles.append({f: getattr(b, f).numpy().copy() for f in b._fields})
            stats = loader.stats
    out['tiles'] = tiles
    out['index'] = sequence_sharding(mesh, seq_axis='sp').index((batch, 8))
    out['stats'] = {k: stats[k] for k in ('n_devices', 'shards_put', 'device_put_bytes')}
    return out


# -- the examples' mesh options -------------------------------------------------

def example_imagenet_model_parallel(rank, world, url):
    from petastorm_tpu_torch.examples import imagenet
    state, losses = imagenet.train(url, batch_size=8, steps=2, image_size=32, log_every=1,
                                   device='cpu', workers_count=2, model_parallel=world)
    return losses, {k: v[0] for k, v in state.placements.items()}


def example_long_context_seq_parallel(rank, world, url):
    from petastorm_tpu_torch.examples import long_context
    model, losses = long_context.train(url, vocab_size=512, batch_size=4, steps=4, d_model=32,
                                       num_heads=2, num_layers=1, log_every=2, device='cpu',
                                       seq_parallel=world)
    return losses, model.blocks[0].attn.attention
