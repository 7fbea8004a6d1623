"""The port's ViT, ViTTiny and MLP against the flax ones, on the CPU.

Flax weights are carried over by ``convert.load_flax_vit`` /
``load_flax_mlp``; inputs come from numpy with a seed. Tolerances, as
``tests/test_torch_transformer.py`` holds the LM: f32 logits
``atol=rtol=1e-5``; bf16 logits ``atol=2**-4`` (two bf16 ulps) with
|logits| < 8; one and two SGD steps ``rtol=1e-5`` on the loss and
``atol=1e-6`` on every parameter (f32). Flash against dense: the same
function, so ``atol=rtol=1e-5`` on the logits and ``atol=1e-5, rtol=1e-4``
on the gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

from petastorm_tpu.models.mlp import MLP as JaxMLP
from petastorm_tpu.models.vit import ViT as JaxViT
from petastorm_tpu.models.vit import ViTTiny as JaxViTTiny
from petastorm_tpu_torch.convert import (load_flax_mlp, load_flax_vit, mlp_params_from_flax,
                                         vit_params_from_flax)
from petastorm_tpu_torch.models import MLP, ViT, ViTTiny, create_train_state, make_train_step
from petastorm_tpu_torch.models.vit import init_flax_like

DTYPES = {'float32': (jnp.float32, torch.float32), 'bfloat16': (jnp.bfloat16, torch.bfloat16)}
CLASSES = 10

# name -> (flax builder, port builder, image [H, W]); the narrow ViT keeps
# patch 16 and head dim 64 (the bench's) at 2 layers, on 3 x 4 patches.
MODELS = {
    'vit_tiny': (lambda dtype, **kw: JaxViTTiny(num_classes=CLASSES, dtype=dtype, **kw),
                 lambda dtype, hw, **kw: ViTTiny(CLASSES, image_size=hw, dtype=dtype,
                                                 device='cpu', **kw),
                 (16, 20)),
    'vit_patch16': (lambda dtype, **kw: JaxViT(num_classes=CLASSES, d_model=128, num_heads=2,
                                               num_layers=2, dtype=dtype, **kw),
                    lambda dtype, hw, **kw: ViT(CLASSES, image_size=hw, d_model=128, num_heads=2,
                                                num_layers=2, dtype=dtype, device='cpu', **kw),
                    (48, 64)),
}


def _flat(params):
    return {k: np.asarray(v) for k, v in flatten_dict(params).items()}


def _images(hw, n=3, seed=0):
    return np.random.default_rng(seed).uniform(0.0, 1.0, (n,) + hw + (3,)).astype(np.float32)


def _pair(name, jdtype, tdtype, **kwargs):
    """The flax model with its params and the port with the same weights."""
    jax_build, port_build, hw = MODELS[name]
    jax_model = jax_build(jdtype, **kwargs)
    params = jax_model.init(jax.random.PRNGKey(0), jnp.asarray(_images(hw, 1)))['params']
    port = load_flax_vit(port_build(tdtype, hw, **kwargs), _flat(params))
    return jax_model, params, port, hw


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('name', sorted(MODELS))
def test_vit_logits_match_flax(name, dtype):
    jdtype, tdtype = DTYPES[dtype]
    jax_model, params, port, hw = _pair(name, jdtype, tdtype)
    x = _images(hw, seed=1)
    want = np.asarray(jax_model.apply({'params': params}, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, CLASSES)
    if dtype == 'float32':
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    else:
        assert np.abs(want).max() < 8
        np.testing.assert_allclose(got.numpy(), want, atol=2 ** -4, rtol=0)
        assert torch.equal(got.to(torch.bfloat16).float(), got)   # the head ran in bf16


def test_vit_with_switch_moe_blocks_matches_flax():
    jax_model, params, port, hw = _pair('vit_tiny', jnp.float32, torch.float32, moe_experts=2)
    assert any(k[1] == 'moe' for k in flatten_dict(params) if k[0].startswith('block_'))
    x = _images(hw, seed=2)
    want = np.asarray(jax_model.apply({'params': params}, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_flash_matches_dense_non_causal_with_gradients():
    """5 x 6 patches + CLS = 31 tokens: not a power of two, not a multiple
    of a block; non-causal, so every token sees the padded tail's mask."""
    _, params, _, _ = _pair('vit_tiny', jnp.float32, torch.float32)
    x = torch.from_numpy(_images((20, 24), seed=3))
    results = []
    for attention in ('dense', 'flash'):
        model = ViTTiny(CLASSES, image_size=(20, 24), attention=attention, dtype=torch.float32,
                        device='cpu')
        flat = _flat(params)
        flat[('pos_embed',)] = np.random.default_rng(4).normal(
            0, 0.02, (1, 31, 32)).astype(np.float32)
        load_flax_vit(model, flat)
        logits = model(x)
        logits.square().mean().backward()
        results.append((logits.detach(), {n: p.grad for n, p in model.named_parameters()}))
    (dense, dense_grads), (flash, flash_grads) = results
    torch.testing.assert_close(flash, dense, atol=1e-5, rtol=1e-5)
    for name, grad in dense_grads.items():
        torch.testing.assert_close(flash_grads[name], grad, atol=1e-5, rtol=1e-4, msg=name)


def test_attention_is_bidirectional():
    """Moving only the last patch moves the CLS logits (a causal stack
    would leave position 0 blind to it)."""
    _, _, port, hw = _pair('vit_tiny', jnp.float32, torch.float32)
    x = torch.from_numpy(_images(hw, n=1, seed=5))
    bumped = x.clone()
    bumped[:, 12:, 16:, :] += 3.0
    with torch.no_grad():
        assert not torch.allclose(port(x), port(bumped))


def test_indivisible_patch_raises():
    with pytest.raises(ValueError, match='not divisible'):
        ViTTiny(2, image_size=(18, 16), device='cpu')
    model = ViTTiny(2, image_size=16, device='cpu')
    with pytest.raises(ValueError, match='not divisible'):
        model(torch.zeros((1, 18, 16, 3)))
    with pytest.raises(ValueError, match='built for 16'):
        model(torch.zeros((1, 20, 16, 3)))


@pytest.mark.parametrize('steps', [1, 2])
def test_sgd_steps_match_optax(steps):
    """``make_train_step`` on the ViT against the same SGD step in JAX
    (softmax cross entropy on integer labels, ``optax.sgd(0.1, 0.9)``)."""
    jax_model, params, port, hw = _pair('vit_tiny', jnp.float32, torch.float32)
    tx = optax.sgd(0.1, momentum=0.9)
    opt_state = tx.init(params)

    @jax.jit
    def jax_step(params, opt_state, images, labels):
        def loss_fn(p):
            logits = jax_model.apply({'params': p}, images)
            return optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    state = create_train_state(port, learning_rate=0.1, momentum=0.9)
    step = make_train_step()
    rng = np.random.default_rng(6)
    for _ in range(steps):
        images = _images(hw, n=4, seed=int(rng.integers(1 << 30)))
        labels = rng.integers(0, CLASSES, 4).astype(np.int32)
        params, opt_state, want = jax_step(params, opt_state, jnp.asarray(images),
                                           jnp.asarray(labels))
        got = step(state, torch.from_numpy(images), torch.from_numpy(labels).long())['loss']
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    want_state = vit_params_from_flax(_flat(params))
    got_state = port.state_dict()
    assert set(got_state) == set(want_state)
    for name, value in want_state.items():
        torch.testing.assert_close(got_state[name], value, atol=1e-6, rtol=0, msg=name)


def test_vit_conversion_is_strict():
    _, params, _, hw = _pair('vit_tiny', jnp.float32, torch.float32)
    flat = _flat(params)
    flat.pop(('block_1', 'attn', 'out', 'kernel'))
    with pytest.raises(KeyError, match='missing'):
        load_flax_vit(ViTTiny(CLASSES, image_size=hw, device='cpu'), flat)
    flat = _flat(params)
    flat[('block_0', 'mlp', 'kernel')] = np.zeros((2, 2), np.float32)
    with pytest.raises(KeyError, match='unexpected flax param'):
        vit_params_from_flax(flat)
    flat = _flat(params)
    flat[('cls_token',)] = np.zeros((1, 1, 32), np.float32)
    with pytest.raises(KeyError, match='unexpected flax param'):
        vit_params_from_flax(flat)
    with pytest.raises(ValueError, match='pos_embed'):
        load_flax_vit(ViTTiny(CLASSES, image_size=(16, 24), device='cpu'), _flat(params))


def test_vit_init_flax_like_is_seeded_and_flax_scaled():
    def build(seed):
        return init_flax_like(ViT(CLASSES, image_size=32, d_model=64, num_heads=1, num_layers=1,
                                  dtype=torch.float32, device='cpu'),
                              torch.Generator().manual_seed(seed))

    a, b, c = build(0), build(0), build(1)
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name
    assert not torch.equal(a.pos_embed, c.pos_embed)
    assert not a.cls.any() and abs(float(a.pos_embed.detach().std()) / 0.02 - 1.0) < 0.1
    # flax's conv: lecun-normal with fan-in p * p * C = 768, cut at 2 sigma.
    w = a.patch_embed.weight.detach()
    std = (1.0 / 768) ** 0.5
    assert abs(float(w.std()) / std - 1.0) < 0.05 and float(w.abs().max()) <= 2 * std / 0.8796 + 1e-6


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_mlp_logits_match_flax(dtype):
    jdtype, tdtype = DTYPES[dtype]
    jax_model = JaxMLP(features=(48, 24), num_classes=CLASSES, dtype=jdtype)
    x = np.random.default_rng(7).uniform(0.0, 1.0, (5, 6, 6, 1)).astype(np.float32)
    params = jax_model.init(jax.random.PRNGKey(0), jnp.asarray(x))['params']
    want = np.asarray(jax_model.apply({'params': params}, jnp.asarray(x)))
    port = load_flax_mlp(MLP(36, features=(48, 24), num_classes=CLASSES, dtype=tdtype,
                             device='cpu'), _flat(params))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (5, CLASSES)
    if dtype == 'float32':
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=2 ** -4, rtol=0)


def test_mlp_conversion_is_strict():
    jax_model = JaxMLP()
    params = jax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8)))['params']
    flat = _flat(params)
    assert set(mlp_params_from_flax(flat)) == set(MLP(8, device='cpu').state_dict())
    flat.pop(('Dense_2', 'bias'))
    with pytest.raises(KeyError, match='missing'):
        load_flax_mlp(MLP(8, device='cpu'), flat)
    flat[('Conv_0', 'kernel')] = np.zeros((1, 1), np.float32)
    with pytest.raises(KeyError, match='unexpected flax param'):
        mlp_params_from_flax(flat)
