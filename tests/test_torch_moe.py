"""The port's SwitchMoE and the MoE TransformerLM against the flax ones, on
the CPU.

Weights are carried by ``convert.load_flax_transformer`` (the LM) or
``transformer_params_from_flax``'s MoE keys (the layer alone); inputs
come from numpy with a seed. Tolerances, as the port's other parity tests:
f32 outputs, aux losses and logits ``atol=rtol=1e-5``; bf16 outputs and
logits ``atol=2**-4`` (two bf16 ulps at |x| < 8; the bf16 LM up to each
row's first near tie of the router, see its test); gradients f32
``atol=1e-5, rtol=1e-4``; two SGD steps of the bench's MoE loss
``rtol=1e-5`` on the loss and ``atol=1e-6`` on every parameter. The scan
step against K one-step calls: exact.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

from petastorm_tpu.models import TransformerLM as JaxTransformerLM
from petastorm_tpu.models.moe import SwitchMoE as JaxSwitchMoE
from petastorm_tpu_torch.convert import load_flax_transformer, transformer_params_from_flax
from petastorm_tpu_torch.models import (SwitchMoE, TransformerLM, create_train_state,
                                        make_lm_scan_train_step, make_lm_train_step, moe_aux_loss)
from petastorm_tpu_torch.models.transformer import init_flax_like

DTYPES = {'float32': (jnp.float32, torch.float32), 'bfloat16': (jnp.bfloat16, torch.bfloat16)}
VOCAB, D, HEADS, LAYERS, MAX_LEN, EXPERTS = 64, 32, 4, 2, 16, 4


def _flat(params):
    return {k: np.asarray(v) for k, v in flatten_dict(params).items()}


def _x(g=2, s=8, d=16, seed=0):
    return np.random.default_rng(seed).standard_normal((g, s, d)).astype(np.float32)


def _layers(x, experts, capacity_factor, jdtype=jnp.float32, tdtype=torch.float32, seed=0):
    """The flax layer with its params and the port's with the same weights."""
    jax_moe = JaxSwitchMoE(num_experts=experts, capacity_factor=capacity_factor, dtype=jdtype)
    params = jax_moe.init(jax.random.PRNGKey(seed), jnp.asarray(x))['params']
    port = SwitchMoE(x.shape[-1], experts, capacity_factor=capacity_factor, dtype=tdtype)
    state = transformer_params_from_flax({('block_0', 'moe') + k: v
                                          for k, v in _flat(params).items()})
    port.load_state_dict({k[len('blocks.0.moe.'):]: v for k, v in state.items()})
    return jax_moe, params, port


def _jax_apply(jax_moe, params, x):
    out, mods = jax_moe.apply({'params': params}, jnp.asarray(x), mutable=['intermediates'])
    (aux,) = mods['intermediates']['aux_loss']
    return np.asarray(out, np.float32), float(aux)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('capacity_factor', [1.0, 1.25, 4.0])
def test_switch_moe_out_and_aux_loss_match_flax(capacity_factor, dtype):
    jdtype, tdtype = DTYPES[dtype]
    x = _x(g=3, s=12, seed=1)
    jax_moe, params, port = _layers(x, EXPERTS, capacity_factor, jdtype, tdtype)
    want, want_aux = _jax_apply(jax_moe, params, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == tdtype and tuple(got.shape) == x.shape
    np.testing.assert_allclose(float(port.aux_loss), want_aux, atol=1e-5, rtol=1e-5)
    if dtype == 'float32':
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    else:
        assert np.abs(want).max() < 8
        np.testing.assert_allclose(got.float().numpy(), want, atol=2 ** -4, rtol=0)


@pytest.mark.parametrize('s,capacity_factor,experts', [(1024, 1.25, 4), (8, 1.0, 4), (16, 0.25, 2),
                                                       (7, 1.3, 3), (1, 0.1, 8)])
def test_capacity_is_the_flax_float_floor_division(s, capacity_factor, experts):
    layer = SwitchMoE(8, experts, capacity_factor=capacity_factor)
    assert layer.capacity(s) == max(1, int(-(-s * capacity_factor // experts)))
    if s == 1024:
        assert layer.capacity(s) == 320


def test_capacity_overflow_drops_with_a_zero_contribution():
    """Two slots an expert over 16 tokens: at least 8 tokens overflow.
    Their slot index lies past the capacity; their rows come out exactly
    zero, as the flax layer's do, and nothing raises."""
    x = _x(g=1, s=16, seed=0)
    jax_moe, params, port = _layers(x, 2, 0.25)
    want, _ = _jax_apply(jax_moe, params, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    zero_rows = (got.reshape(16, -1) == 0).all(axis=1)
    assert zero_rows.sum() >= 8
    np.testing.assert_array_equal(zero_rows, (want.reshape(16, -1) == 0).all(axis=1))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_routing_is_group_local():
    """A group's outputs do not depend on the other groups: changing group
    0 leaves groups 1-3 as they were."""
    x = _x(g=4, s=8, seed=3)
    _, _, port = _layers(x, 2, 1.0)
    bumped = x.copy()
    bumped[0] = _x(g=1, s=8, seed=4)[0]
    with torch.no_grad():
        a, b = port(torch.from_numpy(x)), port(torch.from_numpy(bumped))
    assert torch.equal(a[1:], b[1:]) and not torch.equal(a[0], b[0])


def test_router_gradients_match_jax_grad():
    """Gradients of ``sum(out * w) + aux`` with respect to every param and
    the input, against ``jax.grad``; the router's carry the gate and the
    aux loss's mean probability."""
    x = _x(g=2, s=8, seed=5)
    w = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)
    jax_moe, params, port = _layers(x, EXPERTS, 1.25)

    def loss_fn(p, xj):
        out, mods = jax_moe.apply({'params': p}, xj, mutable=['intermediates'])
        return (out * w).sum() + mods['intermediates']['aux_loss'][0]

    want_p, want_x = jax.grad(loss_fn, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    ((port(xt) * torch.from_numpy(w)).sum() + port.aux_loss).backward()
    want = _flat(want_p)
    got = {('router', 'kernel'): port.router.weight.grad.T, ('router', 'bias'): port.router.bias.grad,
           ('w_up',): port.w_up.grad, ('w_down',): port.w_down.grad}
    assert set(got) == set(want)
    assert float(port.router.weight.grad.abs().sum()) > 0
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), value, atol=1e-5, rtol=1e-4, err_msg=str(key))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x), atol=1e-5, rtol=1e-4)


def _lms(jdtype, tdtype):
    jax_model = JaxTransformerLM(vocab_size=VOCAB, d_model=D, num_heads=HEADS, num_layers=LAYERS,
                                 max_len=MAX_LEN, moe_experts=EXPERTS, dtype=jdtype)
    params = jax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, MAX_LEN), jnp.int32))['params']
    port = TransformerLM(VOCAB, D, HEADS, LAYERS, MAX_LEN, attention='flash',
                         moe_experts=EXPERTS, dtype=tdtype, device='cpu')
    return jax_model, params, load_flax_transformer(port, _flat(params))


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, VOCAB, shape).astype(np.int32)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_moe_transformer_logits_match_flax(dtype):
    """f32: every logit and the summed aux loss. bf16: the activations the
    f32 router reads differ by ulps between the frameworks, so a token
    whose two best experts are within an ulp's reach may route to either,
    and through the capacity count and causal attention that moves every
    later position of its row. So in bf16 each row is compared up to its
    first near tie (a flax router-logit margin below 2**-6 in any layer;
    the ties that flipped in practice had margins below 0.005), and at
    least half of all positions must be compared. The aux loss, which one
    flip moves, is held in f32 here and in bf16 by the layer test."""
    jdtype, tdtype = DTYPES[dtype]
    jax_model, params, port = _lms(jdtype, tdtype)
    tokens = _tokens((4, MAX_LEN), 0)
    want, mods = jax_model.apply({'params': params}, jnp.asarray(tokens),
                                 capture_intermediates=True, mutable=['intermediates'])
    want = np.asarray(want)
    with torch.no_grad():
        got = port(torch.from_numpy(tokens)).numpy()
    assert got.dtype == np.float32 and got.shape == (4, MAX_LEN, VOCAB)
    if dtype == 'float32':
        aux = [v[0] for k, v in flatten_dict(mods['intermediates']).items() if k[-1] == 'aux_loss']
        assert len(aux) == LAYERS
        np.testing.assert_allclose(float(moe_aux_loss(port)), float(sum(aux)), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        return
    margins = []
    for key, value in flatten_dict(mods['intermediates']).items():
        if 'router' in key:
            top = np.sort(np.asarray(value[0], np.float32), axis=-1)
            margins.append(top[..., -1] - top[..., -2])
    assert len(margins) == LAYERS
    near = np.min(margins, axis=0) < 2 ** -6                       # [B, T]
    compared = 0
    for row in range(tokens.shape[0]):
        first = int(np.argmax(near[row])) if near[row].any() else MAX_LEN
        np.testing.assert_allclose(got[row, :first], want[row, :first], atol=2 ** -4, rtol=0)
        compared += first
    assert compared >= tokens.size // 2 and np.abs(want).max() < 8


def test_two_steps_of_the_bench_moe_loss_match_optax():
    """``bench.py:223-233``: ``ce + 1e-2 * aux`` with ``optax.sgd(0.01,
    0.9)``, against ``make_lm_train_step`` on the same tokens."""
    jax_model, params, port = _lms(jnp.float32, torch.float32)
    tx = optax.sgd(0.01, momentum=0.9)
    opt_state = tx.init(params)

    @jax.jit
    def jax_step(params, opt_state, tokens):
        x, y = tokens[:, :-1], tokens[:, 1:]

        def loss_fn(p):
            logits, mods = jax_model.apply({'params': p}, x, mutable=['intermediates'])
            aux = sum(jax.tree_util.tree_leaves(mods['intermediates']))
            ce = optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()
            return ce + 1e-2 * aux

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    state = create_train_state(port, learning_rate=0.01, momentum=0.9)
    step = make_lm_train_step()
    for seed in (2, 3):
        tokens = _tokens((4, MAX_LEN + 1), seed)
        params, opt_state, want = jax_step(params, opt_state, jnp.asarray(tokens))
        got = step(state, torch.from_numpy(tokens))
        assert set(got) == {'loss', 'aux_loss'} and float(got['aux_loss']) > 0
        np.testing.assert_allclose(float(got['loss']), float(want), rtol=1e-5)
    want_state = transformer_params_from_flax(_flat(params))
    got_state = port.state_dict()
    assert set(got_state) == set(want_state)
    for name, value in want_state.items():
        torch.testing.assert_close(got_state[name], value, atol=1e-6, rtol=0, msg=name)


def test_moe_scan_step_equals_k_one_step_calls_exactly():
    k, batch = 2, 3
    model = init_flax_like(TransformerLM(VOCAB, D, HEADS, LAYERS, MAX_LEN, attention='flash',
                                         moe_experts=EXPERTS, dtype=torch.float32, device='cpu'),
                           torch.Generator().manual_seed(7))
    scan_state = create_train_state(model, learning_rate=0.01, momentum=0.9)
    step_state = create_train_state(copy.deepcopy(model), learning_rate=0.01, momentum=0.9)
    scan, single = make_lm_scan_train_step(k), make_lm_train_step()
    tokens = torch.from_numpy(_tokens((k * batch, MAX_LEN + 1), 8))
    got = scan(scan_state, tokens)
    want = [single(step_state, tokens[i * batch:(i + 1) * batch]) for i in range(k)]
    assert torch.equal(got['losses'], torch.stack([m['loss'] for m in want]))
    assert torch.equal(got['aux_losses'], torch.stack([m['aux_loss'] for m in want]))
    for (name, a), b in zip(model.state_dict().items(), step_state.model.state_dict().values()):
        assert torch.equal(a, b), name
    assert scan_state.step == step_state.step == k


def test_aux_loss_is_summed_over_the_layers_and_absent_without_experts():
    _, _, port = _lms(jnp.float32, torch.float32)
    with pytest.raises(ValueError, match='not run a forward'):
        moe_aux_loss(port)
    with torch.no_grad():
        port(torch.from_numpy(_tokens((1, MAX_LEN), 9)))
    layers = [block.moe for block in port.blocks]
    assert float(moe_aux_loss(port)) == pytest.approx(sum(float(m.aux_loss) for m in layers))
    assert all(float(m.aux_loss) >= 0.99 for m in layers)      # 1 at uniform routing
    assert moe_aux_loss(TransformerLM(VOCAB, D, HEADS, 1, MAX_LEN, device='cpu')) is None


def test_moe_conversion_is_strict_and_init_is_per_expert():
    _, params, _ = _lms(jnp.float32, torch.float32)
    flat = _flat(params)
    flat.pop(('block_1', 'moe', 'w_down'))
    with pytest.raises(KeyError, match='missing'):
        load_flax_transformer(TransformerLM(VOCAB, D, HEADS, LAYERS, MAX_LEN,
                                            moe_experts=EXPERTS, device='cpu'), flat)
    flat[('block_0', 'moe', 'w_gate')] = np.zeros((EXPERTS, D, D), np.float32)
    with pytest.raises(KeyError, match='unexpected flax param'):
        transformer_params_from_flax(flat)
    model = init_flax_like(TransformerLM(VOCAB, 64, HEADS, 1, MAX_LEN, moe_experts=8,
                                         dtype=torch.float32, device='cpu'),
                           torch.Generator().manual_seed(0))
    for w, fan_in in ((model.blocks[0].moe.w_up, 64), (model.blocks[0].moe.w_down, 256)):
        std = (1.0 / fan_in) ** 0.5                    # per expert: not (E * fan_in)
        assert abs(float(w.detach().std()) / std - 1.0) < 0.05
