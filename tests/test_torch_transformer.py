"""The port's TransformerLM against the flax one, on the CPU.

Small model (vocab 64, d 32, 4 heads, 2 layers, max_len 16), flax weights
carried over by ``convert.load_flax_transformer``. Tolerances: f32 logits
``atol=rtol=1e-5`` (the largest error seen is ~2e-6: summation order);
bf16 logits ``atol=2**-4``, two bf16 ulps at |logits| < 8 (both models
round at the same places, and an ulp flips where one f32 sum lands on the
other side of a rounding boundary); one and two SGD steps ``rtol=1e-5`` on
the loss and ``atol=1e-6`` on every parameter (f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn
from flax.traverse_util import flatten_dict

from petastorm_tpu.models import TransformerLM as JaxTransformerLM
from petastorm_tpu_torch.convert import load_flax_transformer, transformer_params_from_flax
from petastorm_tpu_torch.models import TransformerLM, create_train_state, make_lm_train_step
from petastorm_tpu_torch.models.transformer import LayerNorm, gelu, init_flax_like

VOCAB, D, HEADS, LAYERS, MAX_LEN = 64, 32, 4, 2, 16
DTYPES = {'float32': (jnp.float32, torch.float32), 'bfloat16': (jnp.bfloat16, torch.bfloat16)}


def _flax(dtype):
    model = JaxTransformerLM(vocab_size=VOCAB, d_model=D, num_heads=HEADS, num_layers=LAYERS,
                             max_len=MAX_LEN, dtype=dtype)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, MAX_LEN), jnp.int32))['params']
    return model, params


def _flat(params):
    return {k: np.asarray(v) for k, v in flatten_dict(params).items()}


def _port(params, dtype, attention='dense'):
    model = TransformerLM(VOCAB, D, HEADS, LAYERS, MAX_LEN, attention=attention, dtype=dtype,
                          device='cpu')
    return load_flax_transformer(model, _flat(params))


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, shape).astype(np.int32)


@pytest.mark.parametrize('attention', ['dense', 'flash'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_logits_match_flax(dtype, attention):
    jdtype, tdtype = DTYPES[dtype]
    jax_model, params = _flax(jdtype)
    tokens = _tokens((2, MAX_LEN))
    want = np.asarray(jax_model.apply({'params': params}, jnp.asarray(tokens)))
    with torch.no_grad():
        got = _port(params, tdtype, attention)(torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, MAX_LEN, VOCAB)
    if dtype == 'float32':
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    else:
        assert np.abs(want).max() < 8
        np.testing.assert_allclose(got.numpy(), want, atol=2 ** -4, rtol=0)
        # The head ran in bf16: every logit is a bf16 value.
        assert torch.equal(got.to(torch.bfloat16).float(), got)


def test_flash_matches_dense_with_gradients():
    _, params = _flax(jnp.float32)
    tokens = torch.from_numpy(_tokens((2, 13), seed=1))      # T not a power of two
    results = []
    for attention in ('dense', 'flash'):
        model = _port(params, torch.float32, attention)
        logits = model(tokens)
        logits.square().mean().backward()
        results.append((logits.detach(), {n: p.grad for n, p in model.named_parameters()}))
    (dense, dense_grads), (flash, flash_grads) = results
    torch.testing.assert_close(flash, dense, atol=1e-5, rtol=1e-5)
    for name, grad in dense_grads.items():
        torch.testing.assert_close(flash_grads[name], grad, atol=1e-5, rtol=1e-4, msg=name)


def test_sgd_steps_match_optax():
    """Two steps of the bench's LM step body (``bench.py:216-240``, non-MoE)
    against ``make_lm_train_step``: same losses, same params after."""
    jax_model, params = _flax(jnp.float32)
    port = _port(params, torch.float32, 'flash')
    tx = optax.sgd(0.01, momentum=0.9)
    opt_state = tx.init(params)

    @jax.jit
    def jax_step(params, opt_state, tokens):
        x, y = tokens[:, :-1], tokens[:, 1:]

        def loss_fn(p):
            logits = jax_model.apply({'params': p}, x)
            return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    state = create_train_state(port, learning_rate=0.01, momentum=0.9)
    step = make_lm_train_step()
    for seed in (2, 3):
        tokens = _tokens((4, MAX_LEN + 1), seed)
        params, opt_state, want = jax_step(params, opt_state, jnp.asarray(tokens))
        got = step(state, torch.from_numpy(tokens))['loss']
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    want_state = transformer_params_from_flax(_flat(params))
    got_state = port.state_dict()
    assert set(got_state) == set(want_state)
    for name, value in want_state.items():
        torch.testing.assert_close(got_state[name], value, atol=1e-6, rtol=0, msg=name)


@pytest.mark.parametrize('spread', [1e-3, 3e-3])
def test_layernorm_matches_flax_epsilon(spread):
    """A variance near eps separates flax's 1e-6 from torch's 1e-5."""
    rng = np.random.default_rng(4)
    x = (spread * rng.standard_normal((3, 64))).astype(np.float32)
    flax_ln = fnn.LayerNorm()
    variables = flax_ln.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(flax_ln.apply(variables, jnp.asarray(x)))
    got = LayerNorm(64, torch.float32)(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    torch_default = F.layer_norm(torch.from_numpy(x), (64,)).numpy()
    assert np.abs(torch_default - want).max() > 1e-2


def test_layernorm_takes_f32_statistics_and_returns_the_compute_type():
    x = (100.0 + torch.randn((2, 64), generator=torch.Generator().manual_seed(5))).to(torch.bfloat16)
    flax_ln = fnn.LayerNorm(dtype=jnp.bfloat16)
    jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    want = np.asarray(flax_ln.apply(flax_ln.init(jax.random.PRNGKey(0), jx), jx), np.float32)
    got = LayerNorm(64, torch.bfloat16)(x)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().detach().numpy(), want)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-4.0, 4.0, 81).astype(np.float32)
    want = np.asarray(fnn.gelu(jnp.asarray(x)))
    np.testing.assert_allclose(gelu(torch.from_numpy(x)).numpy(), want, atol=1e-6, rtol=1e-6)
    assert np.abs(F.gelu(torch.from_numpy(x)).numpy() - want).max() > 1e-4


def test_what_is_not_ported_raises():
    model = TransformerLM(VOCAB, D, HEADS, LAYERS, MAX_LEN, dtype=torch.float32, device='cpu')
    with pytest.raises(ValueError, match='exceeds max_len'):
        model(torch.zeros((1, MAX_LEN + 1), dtype=torch.int32))
    # Sequence parallelism is ported; without a mesh it raises as JAX does.
    for attention in ('ring', 'a2a'):
        with pytest.raises(ValueError, match='needs mesh= and seq_axis='):
            TransformerLM(VOCAB, D, HEADS, LAYERS, MAX_LEN, attention=attention, device='cpu')
    # Switch MoE is ported: each block's MLP becomes a SwitchMoE.
    moe = TransformerLM(VOCAB, D, HEADS, LAYERS, MAX_LEN, moe_experts=4, device='cpu')
    assert all(block.moe is not None and block.moe.num_experts == 4 for block in moe.blocks)
    with pytest.raises(ValueError, match='unknown attention'):
        TransformerLM(VOCAB, D, HEADS, LAYERS, MAX_LEN, attention='sparse', device='cpu')


def test_conversion_is_strict():
    _, params = _flax(jnp.float32)
    flat = _flat(params)
    flat.pop(('block_1', 'attn', 'value', 'bias'))
    with pytest.raises(KeyError, match='missing'):
        load_flax_transformer(TransformerLM(VOCAB, D, HEADS, LAYERS, MAX_LEN, device='cpu'), flat)
    flat[('block_0', 'moe', 'kernel')] = np.zeros((2, 2), np.float32)
    with pytest.raises(KeyError, match='unexpected flax param'):
        transformer_params_from_flax(flat)


def test_init_flax_like_is_seeded_and_flax_scaled():
    def build(seed):
        model = TransformerLM(512, 64, 4, 2, MAX_LEN, dtype=torch.float32, device='cpu')
        return init_flax_like(model, torch.Generator().manual_seed(seed))

    a, b, c = build(0), build(0), build(1)
    for (name, x), y, z in zip(a.state_dict().items(), b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(x, y), name
    assert not torch.equal(a.embed.weight, c.embed.weight)
    # flax: Embed std 1/sqrt(d); Dense lecun-normal (std 1/sqrt(fan_in), cut at 2 sigma).
    assert abs(float(a.embed.weight.detach().std()) * 8.0 - 1.0) < 0.05
    w = a.blocks[0].mlp_in.weight.detach()
    assert abs(float(w.std()) * 8.0 - 1.0) < 0.05 and float(w.abs().max()) <= 2 / 8 / 0.8796 + 1e-6
    assert torch.equal(a.norm.scale, torch.ones(64)) and not a.head.bias.any()
