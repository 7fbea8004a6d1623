"""The port's flash attention on the CPU against the JAX package's Pallas
kernels, run in interpret mode with explicit blocks (as
``tests/test_flash_attention.py`` runs them; without ``interpret=True`` the
JAX entry falls back to dense attention off the TPU).

The port's CPU path is the plain PyTorch versions of its CUDA kernels, so
these tests hold the kernels' arithmetic against the TPU kernels' bodies.
Tolerances: ``atol=rtol=1e-5`` for out, lse, dq, dk and dv in f32 (both
sides accumulate in f32 and differ only in summation order; the largest
error seen is ~1e-6); ``2e-4`` for end-to-end gradients in f32, as
``tests/test_flash_attention.py:102`` holds the Pallas backward; bf16
gradients within ``3e-2`` of JAX's (both round P, dS and the outputs to
bf16 at the same places, so they differ by an ulp or two of bf16, 2^-8
relative, where one f32 sum rounds the other way).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petastorm_tpu_torch.ops.flash_attention import flash_attention

jfa = importlib.import_module('petastorm_tpu.ops.flash_attention')
tfa = importlib.import_module('petastorm_tpu_torch.ops.flash_attention')

F32_TOL = dict(atol=1e-5, rtol=1e-5)

# The shapes of tests/test_flash_attention.py:17-22: even tiles, a padded
# tail, T below one block, block_q != block_k.
CASES = [
    ((2, 64, 2, 16), (16, 16)),
    ((1, 100, 2, 8), (32, 16)),
    ((1, 7, 1, 4), (8, 8)),
    ((2, 48, 3, 8), (16, 24)),
]


@pytest.mark.parametrize('t,block_q,block_k', [
    (1000, 512, 1000), (1000, 512, 1024), (7, 8, 8), (100, 32, 16), (48, 16, 24),
    (1024, 64, 64), (8192, 512, 1024), (1, 128, 128), (33, 1000, 17), (130, 64, 48)])
def test_pad_plan_matches_jax(t, block_q, block_k):
    assert tfa._pad_plan(t, block_q, block_k) == jfa._pad_plan(t, block_q, block_k)


def _inputs(shape, blocks, seed):
    b, t, h, d = shape
    bq, bk, t_pad = jfa._pad_plan(t, *blocks)
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    jax_in = tuple(jfa._to_bhtd(jnp.asarray(x), t_pad) for x in (q, k, v))
    torch_in = tuple(tfa._to_bhtd(torch.from_numpy(x), t_pad) for x in (q, k, v))
    return (bq, bk, t_pad), jax_in, torch_in


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('shape,blocks', CASES)
def test_plain_forward_matches_pallas(shape, blocks, causal):
    (bq, bk, _), (jq, jk, jv), (tq, tk, tv) = _inputs(shape, blocks, 0)
    t = shape[1]
    want_out, want_lse = jfa._flash_bhtd(jq, jk, jv, t, causal, bq, bk, True, True)
    out, lse = tfa.flash_fwd_plain(tq, tk, tv, t, causal, bk)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **F32_TOL)
    # JAX broadcasts lse over 128 lanes; the port keeps one value per row.
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[:, :, 0], **F32_TOL)


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('shape,blocks', CASES)
def test_plain_backward_matches_pallas(shape, blocks, causal):
    (bq, bk, t_pad), (jq, jk, jv), (tq, tk, tv) = _inputs(shape, blocks, 1)
    t = shape[1]
    out, lse = jfa._flash_bhtd(jq, jk, jv, t, causal, bq, bk, True, True)
    rng = np.random.default_rng(2)
    dout = rng.standard_normal(tq.shape).astype(np.float32)
    dout[:, t:] = 0.0                                    # the pad rows carry no gradient
    dd = (dout * np.asarray(out)).sum(-1)
    want = jfa._flash_bwd_bhtd(jq, jk, jv, jnp.asarray(dout), lse,
                               jnp.broadcast_to(jnp.asarray(dd)[:, :, None], lse.shape),
                               t, causal, bq, bk, True)
    lse_rows = torch.from_numpy(np.asarray(lse)[:, :, 0].copy())
    args = (tq, tk, tv, torch.from_numpy(dout), lse_rows, torch.from_numpy(dd), t, causal)
    got = (tfa.flash_dq_plain(*args, bk),) + tfa.flash_dkv_plain(*args, bq)
    for name, a, b in zip(('dq', 'dk', 'dv'), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **F32_TOL)


@pytest.mark.parametrize('dtype,tol', [(np.float32, 2e-4), ('bfloat16', 3e-2)])
def test_autograd_matches_jax_grad(dtype, tol):
    """The public entry, forward and ``torch.autograd`` backward on CPU
    tensors, against ``jax.grad`` of the JAX flash attention in interpret
    mode: padded tail, causal, block_q != block_k."""
    shape, blocks = (2, 40, 2, 8), (16, 8)
    rng = np.random.default_rng(3)
    arrays = [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]
    jdtype = jnp.float32 if dtype == np.float32 else jnp.bfloat16
    tdtype = torch.float32 if dtype == np.float32 else torch.bfloat16
    jq, jk, jv, jcot = (jnp.asarray(x, jdtype) for x in arrays)

    def loss(q, k, v):
        out = jfa.flash_attention(q, k, v, causal=True, block_q=blocks[0], block_k=blocks[1],
                                  interpret=True)
        return jnp.sum(out.astype(jnp.float32) * jcot.astype(jnp.float32)), out

    (_, want_out), want_grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(x).to(tdtype).requires_grad_() for x in arrays[:3])
    out = flash_attention(tq, tk, tv, causal=True, block_q=blocks[0], block_k=blocks[1])
    (out.float() * torch.from_numpy(arrays[3]).to(tdtype).float()).sum().backward()
    assert out.dtype == tdtype and tuple(out.shape) == shape
    np.testing.assert_allclose(out.detach().float().numpy(), np.asarray(want_out, np.float32),
                               atol=tol, rtol=tol)
    for name, got, want in zip('qkv', (tq.grad, tk.grad, tv.grad), want_grads):
        assert got.dtype == tdtype
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   atol=tol, rtol=tol, err_msg='d' + name)


def test_lse_is_written_only_when_a_gradient_is_needed(monkeypatch):
    seen = []
    real = tfa.flash_fwd

    def spy(*args):
        seen.append(args[-1])
        return real(*args)

    monkeypatch.setattr(tfa, 'flash_fwd', spy)
    x = torch.randn((1, 16, 2, 8))
    flash_attention(x, x, x, causal=True)
    with torch.no_grad():
        flash_attention(x.requires_grad_(), x, x)
    flash_attention(x, x, x).sum().backward()
    assert seen == [False, False, True]


def test_cpu_path_launches_no_kernel():
    tfa.reset_launch_counts()
    q = torch.randn((1, 20, 2, 8), requires_grad=True)
    flash_attention(q, q, q, causal=True).sum().backward()
    assert sum(tfa.LAUNCHES.values()) == 0


def test_kernel_wrappers_refuse_what_the_kernels_cannot_take():
    x = torch.zeros((2, 16, 8))
    lse = torch.zeros((2, 16))
    with pytest.raises(ValueError, match='CUDA'):
        tfa.flash_fwd_cuda(x, x, x, 16, True, True)
    with pytest.raises(TypeError, match='bfloat16 or float32'):
        tfa.flash_dq_cuda(*(x.double(),) * 4, lse, lse, 16, True)
    with pytest.raises(ValueError, match='head dim'):
        big = torch.zeros((2, 16, 160))
        tfa.flash_dkv_cuda(big, big, big, big, lse, lse, 16, True)
    with pytest.raises(ValueError, match='one \\[B, T, H, D\\] shape'):
        flash_attention(torch.zeros((1, 4, 2, 8)), torch.zeros((1, 5, 2, 8)),
                        torch.zeros((1, 4, 2, 8)))
