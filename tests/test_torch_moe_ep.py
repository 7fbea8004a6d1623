"""Expert-parallel ``SwitchMoE`` of the port on ``{'expert': 2}`` gloo
ranks (the dispatch and its return as explicit all-to-alls), held against
the one-rank port and the JAX layer on its virtual mesh
(``test_moe.py:54-76``), and a dp x ep TransformerLM step.

Each rank holds half of the experts and half of the groups (batch rows);
routing stays group-local. f32, capacity factor 4: the output tile and
the input gradient ``atol=rtol=1e-5``, the load-balance loss (of the whole
batch) ``rtol=1e-5``, the local experts' weight gradients ``atol=1e-5,
rtol=1e-4``. The LM: two SGD steps of ``ce + 1e-2 * aux`` on ``{'data': 1,
'expert': 2}`` against JAX's on the same mesh, losses ``rtol=1e-4`` and
params ``rtol=1e-4, atol=1e-5``. One spawned pair serves every case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict
from jax.sharding import NamedSharding, PartitionSpec

import torch_mesh_ranks
from petastorm_tpu.models import TransformerLM as JaxLM
from petastorm_tpu.models.moe import SwitchMoE as JaxMoE
from petastorm_tpu.models.moe import expert_param_spec as jax_expert_spec
from petastorm_tpu.parallel import make_mesh as jax_make_mesh
from petastorm_tpu_torch.convert import transformer_params_from_flax
from petastorm_tpu_torch.models.moe import SwitchMoE
from petastorm_tpu_torch.parallel.launch import spawn

E, G, S, D = 4, 4, 16, 16


def _inputs():
    rng = np.random.default_rng(21)
    x = rng.standard_normal((G, S, D)).astype(np.float32)
    grad = rng.standard_normal((G, S, D)).astype(np.float32)
    model = JaxMoE(num_experts=E, capacity_factor=4.0, dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, model.init(jax.random.PRNGKey(1),
                                                           jnp.asarray(x))['params'])
    return model, params, x, grad


def _one_rank_port(params, x, grad):
    moe = SwitchMoE(D, E, capacity_factor=4.0, dtype=torch.float32)
    with torch.no_grad():
        moe.router.weight.copy_(torch.from_numpy(params['router']['kernel'].T.copy()))
        moe.router.bias.copy_(torch.tensor(params['router']['bias']))
        moe.w_up.copy_(torch.tensor(params['w_up']))
        moe.w_down.copy_(torch.tensor(params['w_down']))
    xt = torch.from_numpy(x).requires_grad_()
    out = moe(xt)
    (out * torch.from_numpy(grad)).sum().backward()
    return out.detach().numpy(), xt.grad.numpy(), float(moe.aux_loss.detach()), moe.w_up.grad.numpy()


@pytest.fixture(scope='module')
def runs():
    model, params, x, grad = _inputs()
    results = spawn(torch_mesh_ranks.moe_ep, 2, ({'expert': 2}, params, x, grad), timeout=90)
    return model, params, x, grad, results


@pytest.mark.timeout(200)
def test_expert_parallel_matches_the_one_rank_port(runs):
    _, params, x, grad, results = runs
    out, dx, aux, dw_up = _one_rank_port(params, x, grad)
    for rank, res in enumerate(results):
        tile = res['tile']
        np.testing.assert_allclose(res['out'], out[tile], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(res['dx'], dx[tile], rtol=1e-5, atol=1e-5)
        assert res['aux'] == pytest.approx(aux, rel=1e-5)
        experts = slice(rank * E // 2, (rank + 1) * E // 2)
        np.testing.assert_allclose(res['w_up_local'], params['w_up'][experts])
        np.testing.assert_allclose(res['dw_up'], dw_up[experts], rtol=1e-4, atol=1e-5)


@pytest.mark.timeout(200)
def test_expert_parallel_matches_jax_on_its_mesh(runs):
    """JAX's ``test_expert_parallel_on_mesh``: the experts placed over
    'expert' by ``expert_param_spec``, the apply equal to the replicated
    one; the port's tiles equal JAX's output rows."""
    model, params, x, _, results = runs
    mesh = jax_make_mesh({'data': 1, 'expert': 2}, devices=jax.devices()[:2])
    sharded = jax.tree_util.tree_map_with_path(
        lambda p, leaf: jax.device_put(leaf, NamedSharding(mesh, jax_expert_spec(p, leaf, mesh))),
        {'params': params})
    assert sharded['params']['w_up'].sharding.spec == PartitionSpec('expert', None, None)
    want = np.asarray(jax.jit(model.apply)(sharded, jnp.asarray(x)))
    for res in results:
        np.testing.assert_allclose(res['out'], want[res['tile']], rtol=1e-5, atol=1e-5)
        assert res['placements'] == {'w_up': ('expert', None, None),
                                     'w_down': ('expert', None, None)}


LM_CONFIG = dict(vocab_size=32, d_model=16, num_heads=2, num_layers=1, max_len=16,
                 moe_experts=4)


def _jax_moe_lm(params, tokens, steps):
    """The bench's MoE LM loss, ``ce + 1e-2 * aux`` (``bench.py:216-244``),
    by plain SGD on a ``{'data': 1, 'expert': 2}`` mesh."""
    mesh = jax_make_mesh({'data': 1, 'expert': 2}, devices=jax.devices()[:2])
    model = JaxLM(mesh=mesh, expert_axis='expert', dtype=jnp.float32, **LM_CONFIG)
    params = jax.tree_util.tree_map_with_path(
        lambda p, leaf: jax.device_put(leaf, NamedSharding(mesh, jax_expert_spec(p, leaf, mesh))),
        params)

    @jax.jit
    def step(params, tokens):
        def loss_fn(p):
            logits, mods = model.apply({'params': p}, tokens[:, :-1], mutable=['intermediates'])
            ce = optax.softmax_cross_entropy_with_integer_labels(logits, tokens[:, 1:]).mean()
            return ce + 1e-2 * sum(jax.tree_util.tree_leaves(mods['intermediates']))
        loss, grads = jax.value_and_grad(loss_fn)(params)
        return jax.tree_util.tree_map(lambda p, g: p - 0.1 * g, params, grads), loss

    losses = []
    for _ in range(steps):
        params, loss = step(params, jnp.asarray(tokens))
        losses.append(float(loss))
    flat = {k: np.asarray(v) for k, v in flatten_dict(params).items()}
    return losses, {k: v.numpy() for k, v in transformer_params_from_flax(flat).items()}


@pytest.mark.timeout(200)
def test_expert_parallel_lm_steps_match_jax():
    params = JaxLM(dtype=jnp.float32, **LM_CONFIG).init(
        jax.random.PRNGKey(2), jnp.zeros((1, 15), jnp.int32))['params']
    flat = {k: np.asarray(v) for k, v in flatten_dict(params).items()}
    tokens = np.random.default_rng(3).integers(0, 32, (4, 16)).astype(np.int32)
    axes = {'data': 1, 'expert': 2}
    results = spawn(torch_mesh_ranks.lm_steps, 2,
                    ([(axes, ('dense',))], dict(LM_CONFIG, expert_axis='expert'), flat, tokens,
                     2), timeout=90)
    want_losses, want_params = _jax_moe_lm(params, tokens, 2)
    runs = [r[0]['dense'] for r in results]
    for run in runs:
        np.testing.assert_allclose(run['losses'], want_losses, rtol=1e-4)
    assert runs[0]['placements']['blocks.0.moe.w_up'] == ('expert', None, None)
    for name, value in want_params.items():
        got = torch_mesh_ranks.full_from_shards(runs, name, value_key='params', mesh_axes=axes)
        np.testing.assert_allclose(got, value, rtol=1e-4, atol=1e-5, err_msg=name)
