"""Sequence parallelism of the port on gloo ranks, held against the JAX
package on its virtual CPU devices.

Ring and all-to-all attention (``ring_self_attention``,
``a2a_self_attention``) on sp = 2 and 4, causal and not, alone, on dp x sp
and with tensor-parallel heads: this rank's tiles of the output and of the
q/k/v gradients against the JAX functions on the same mesh and against
dense attention, in f32, forward ``atol=rtol=1e-5``, gradients
``atol=rtol=1e-4``. A TransformerLM trains three SGD steps on 2 x 2 ranks
with ring and a2a attention ({'sp': 2, 'model': 2}) and tensor-parallel
dense attention ({'data': 2, 'model': 2}); losses ``rtol=1e-4`` and updated
params ``rtol=1e-4, atol=1e-5`` against JAX's jitted step on the same
mesh. One 4-rank group serves every attention case, another every LM case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from flax.traverse_util import flatten_dict
from jax.sharding import NamedSharding, PartitionSpec

import torch_mesh_ranks
from petastorm_tpu.models import TransformerLM as JaxLM
from petastorm_tpu.models.attention import (a2a_self_attention, dense_attention,
                                            ring_self_attention)
from petastorm_tpu.models.train import transformer_param_spec as jax_spec
from petastorm_tpu.parallel import make_mesh as jax_make_mesh
from petastorm_tpu_torch.convert import transformer_params_from_flax
from petastorm_tpu_torch.models.transformer import TransformerLM
from petastorm_tpu_torch.parallel.launch import spawn

WORLD = 4
ATTENTION = [
    # (scheme, mesh, heads, causal)
    ('ring', {'sp': 4}, 4, False), ('ring', {'sp': 4}, 4, True),
    ('a2a', {'sp': 4}, 4, False), ('a2a', {'sp': 4}, 4, True),
    ('ring', {'data': 2, 'sp': 2}, 2, True), ('a2a', {'data': 2, 'sp': 2}, 2, False),
    ('a2a', {'data': 2, 'sp': 2}, 2, True),
    ('ring', {'sp': 2, 'model': 2}, 4, True), ('a2a', {'sp': 2, 'model': 2}, 4, True),
]
INDIVISIBLE = ('a2a', {'sp': 4}, 2, True)
LM = {'config': dict(vocab_size=32, d_model=16, num_heads=4, num_layers=1, max_len=16),
      'meshes': [({'sp': 2, 'model': 2}, ('ring', 'a2a')),
                 ({'data': 2, 'model': 2}, ('dense',))]}


def _arrays(seed, heads):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, 16, heads, 8)).astype(np.float32) for _ in range(4)]


def _jax_attention(scheme, axes, arrays, causal):
    """The JAX function's output and q/k/v gradients (of ``sum(out * g)``)
    on the same mesh, and dense attention's, in one jitted call."""
    mesh = jax_make_mesh(axes, devices=jax.devices()[:WORLD])
    fn = ring_self_attention if scheme == 'ring' else a2a_self_attention
    kwargs = dict(batch_axis='data' if 'data' in axes else None,
                  head_axis='model' if 'model' in axes else None)

    @jax.jit
    def both(q, k, v, g):
        out, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, mesh, 'sp', causal=causal, **kwargs),
                           q, k, v)
        dense, dense_vjp = jax.vjp(lambda q, k, v: dense_attention(q, k, v, causal), q, k, v)
        return (out,) + vjp(g), (dense,) + dense_vjp(g)

    want, dense = both(*(jnp.asarray(a) for a in arrays))
    return [np.asarray(x) for x in want], [np.asarray(x) for x in dense]


@pytest.fixture(scope='module')
def attention_runs():
    cases = [dict(scheme=s, axes=a, causal=c, arrays=_arrays(i, h))
             for i, (s, a, h, c) in enumerate(ATTENTION + [INDIVISIBLE])]
    results = spawn(torch_mesh_ranks.attention_cases, WORLD, (cases,), timeout=100)
    return cases, results


@pytest.mark.timeout(240)
@pytest.mark.parametrize('case', range(len(ATTENTION)), ids=[
    '{}-{}-{}'.format(s, 'x'.join('{}{}'.format(k, v) for k, v in a.items()),
                      'causal' if c else 'full') for s, a, _, c in ATTENTION])
def test_attention_tiles_match_jax_and_dense(attention_runs, case):
    cases, results = attention_runs
    spec = cases[case]
    want, dense = _jax_attention(spec['scheme'], spec['axes'], spec['arrays'], spec['causal'])
    for rank_results in results:
        got = rank_results[case]
        index = got['index']
        for name, g, w, d in zip(('out', 'dq', 'dk', 'dv'),
                                 [got[k] for k in ('out', 'dq', 'dk', 'dv')], want, dense):
            tol = 1e-5 if name == 'out' else 1e-4
            np.testing.assert_allclose(g, w[index], rtol=tol, atol=tol, err_msg=name)
            np.testing.assert_allclose(g, d[index], rtol=tol, atol=tol, err_msg=name)


@pytest.mark.timeout(240)
def test_a2a_indivisible_heads_raise(attention_runs):
    _, results = attention_runs
    for rank_results in results:
        assert 'divisible by the mesh axis size (4)' in rank_results[-1]['error']


def test_sequence_parallel_attention_needs_mesh_and_seq_axis():
    for scheme in ('ring', 'a2a'):
        with pytest.raises(ValueError, match=r"needs mesh= and seq_axis="):
            TransformerLM(32, 16, 4, 1, attention=scheme, device='cpu')


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree).items()}


def _lm_inputs():
    cfg = LM['config']
    flax_model = JaxLM(dtype=jnp.float32, **cfg)
    params = flax_model.init(jax.random.PRNGKey(5), jnp.zeros((1, cfg['max_len']), jnp.int32))
    tokens = np.random.default_rng(6).integers(0, cfg['vocab_size'], (4, cfg['max_len']))
    return params['params'], tokens.astype(np.int32)


def _jax_lm(axes, scheme, params, tokens, steps):
    """The JAX package's sequence/tensor-parallel LM step
    (``__graft_entry__.py:292-333``)."""
    mesh = jax_make_mesh(axes, devices=jax.devices()[:WORLD])
    seq = scheme in ('ring', 'a2a')
    model = JaxLM(attention=scheme, mesh=mesh, seq_axis='sp' if seq else None,
                  dtype=jnp.float32, **LM['config'])
    params = jax.tree_util.tree_map_with_path(
        lambda p, leaf: jax.device_put(leaf, NamedSharding(mesh, jax_spec(p, leaf, mesh))),
        params)
    data = NamedSharding(mesh, PartitionSpec('data' if 'data' in axes else None,
                                             'sp' if 'sp' in axes else None))
    tokens = jax.device_put(jnp.asarray(tokens), data)

    @jax.jit
    def step(params, tokens):
        def loss_fn(p):
            logits = model.apply({'params': p}, tokens)
            tgt = jnp.roll(tokens, -1, axis=1)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits[:, :-1], tgt[:, :-1]).mean()
        loss, grads = jax.value_and_grad(loss_fn)(params)
        return jax.tree_util.tree_map(lambda p, g: p - 0.1 * g, params, grads), loss

    losses = []
    for _ in range(steps):
        params, loss = step(params, tokens)
        losses.append(float(loss))
    return losses, {k: v.numpy() for k, v in
                    transformer_params_from_flax(_flat(params)).items()}


@pytest.fixture(scope='module')
def lm_runs():
    params, tokens = _lm_inputs()
    flat = _flat(params)
    configs = [(axes, schemes) for axes, schemes in LM['meshes']]
    results = spawn(torch_mesh_ranks.lm_steps, WORLD,
                    (configs, LM['config'], flat, tokens, 3), timeout=100)
    return params, tokens, results


LM_CASES = [(i, scheme) for i, (_, schemes) in enumerate(LM['meshes']) for scheme in schemes]


@pytest.mark.timeout(240)
@pytest.mark.parametrize('config,scheme', LM_CASES)
def test_lm_steps_match_jax(lm_runs, config, scheme):
    params, tokens, results = lm_runs
    axes = LM['meshes'][config][0]
    want_losses, want_params = _jax_lm(axes, scheme, params, tokens, 3)
    runs = [r[config][scheme] for r in results]
    for run in runs:
        np.testing.assert_allclose(run['losses'], want_losses, rtol=1e-4)
    assert want_losses[-1] < want_losses[0]
    assert runs[0]['placements'], 'the tensor-parallel LM split nothing'
    for name, value in want_params.items():
        got = torch_mesh_ranks.full_from_shards(runs, name, value_key='params', mesh_axes=axes)
        np.testing.assert_allclose(got, value, rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.timeout(240)
def test_ring_and_a2a_trajectories_agree(lm_runs):
    _, _, results = lm_runs
    ring, a2a = results[0][0]['ring']['losses'], results[0][0]['a2a']['losses']
    np.testing.assert_allclose(ring, a2a, rtol=1e-4, atol=1e-5)
