"""The port's normalize op held against the JAX package's: the XLA reference
and the Pallas kernel in interpret mode, on the same numpy inputs.

Tolerances: f32 outputs ``atol=1e-5`` (what ``tests/test_ops.py`` uses for
the Pallas kernel); bf16 outputs within one bf16 ulp of the JAX value, and
at least 1e-6: the two sides round an f32 value computed by a different
formula, which near zero differs by f32 rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petastorm_tpu.ops.image_ops import _normalize_pallas, normalize_images_reference
from petastorm_tpu_torch.ops import image_ops as port

SHAPES = [(4, 16, 128, 3), (5, 16, 128, 3), (8, 30, 30, 3), (3, 10, 10, 3)]
DTYPES = {'float32': (torch.float32, jnp.float32), 'bfloat16': (torch.bfloat16, jnp.bfloat16)}


def _images(shape, in_dtype, seed):
    rng = np.random.default_rng(seed)
    if in_dtype == 'uint8':
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.uniform(0.0, 255.0, shape).astype(np.float32)


def _jax_scale_shift():
    mean = jnp.asarray(port.IMAGENET_MEAN, jnp.float32)
    std = jnp.asarray(port.IMAGENET_STD, jnp.float32)
    return (1.0 / (255.0 * std)).reshape(1, 1, 1, -1), (-mean / std).reshape(1, 1, 1, -1)


def _assert_close(got, want, out_dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if out_dtype == 'float32':
        np.testing.assert_allclose(got, want, atol=1e-5)
    else:
        _, exponent = np.frexp(np.maximum(np.abs(want), 2.0 ** -126))   # m 2^e, m in [0.5, 1)
        # Near zero x * scale + shift cancels; f32 rounding then dominates.
        ulp = np.maximum(np.ldexp(1.0, exponent - 8), 1e-6)
        assert np.all(np.abs(got - want) <= ulp), float(np.max(np.abs(got - want)))


def _port(x, out_dtype, flip=None):
    out = port.normalize_images(torch.from_numpy(x), dtype=DTYPES[out_dtype][0],
                                flip=None if flip is None else torch.from_numpy(flip))
    assert out.dtype == DTYPES[out_dtype][0] and tuple(out.shape) == x.shape
    return out.float().numpy()


@pytest.mark.parametrize('shape', SHAPES)
@pytest.mark.parametrize('in_dtype', ['uint8', 'float32'])
@pytest.mark.parametrize('out_dtype', ['float32', 'bfloat16'])
def test_normalize_matches_jax_reference(shape, in_dtype, out_dtype):
    x = _images(shape, in_dtype, seed=sum(shape))
    want = normalize_images_reference(jnp.asarray(x), dtype=DTYPES[out_dtype][1])
    _assert_close(_port(x, out_dtype), want, out_dtype)


@pytest.mark.parametrize('shape', SHAPES)
@pytest.mark.parametrize('in_dtype', ['uint8', 'float32'])
def test_normalize_matches_pallas_interpret(shape, in_dtype):
    x = _images(shape, in_dtype, seed=7 + sum(shape))
    scale, shift = _jax_scale_shift()
    for out_dtype in DTYPES:
        want = _normalize_pallas(jnp.asarray(x), scale, shift, dtype=DTYPES[out_dtype][1],
                                 interpret=True)
        _assert_close(_port(x, out_dtype), want, out_dtype)


@pytest.mark.parametrize('in_dtype', ['uint8', 'float32'])
def test_flip_fused_normalize_matches_jax(in_dtype):
    x = _images((6, 12, 20, 3), in_dtype, seed=3)
    flip = np.array([True, False, True, True, False, False])
    flipped = jnp.where(jnp.asarray(flip)[:, None, None, None], jnp.flip(jnp.asarray(x), axis=2),
                        jnp.asarray(x))
    for out_dtype in DTYPES:
        want = normalize_images_reference(flipped, dtype=DTYPES[out_dtype][1])
        _assert_close(_port(x, out_dtype, flip), want, out_dtype)


def test_plain_version_is_the_cpu_path():
    x = torch.from_numpy(_images((2, 8, 8, 3), 'uint8', seed=1))
    scale, shift = port._scale_shift(port.IMAGENET_MEAN, port.IMAGENET_STD, x.device)
    before = port.LAUNCHES['normalize_images']
    assert torch.equal(port.normalize_images(x), port.normalize_images_plain(x, scale, shift))
    assert port.LAUNCHES['normalize_images'] == before   # the CPU never counts a launch


def test_normalize_rejects_non_nhwc():
    with pytest.raises(ValueError, match='NHWC'):
        port.normalize_images(torch.zeros(8, 8, 3, dtype=torch.uint8))



@pytest.mark.parametrize('out_dtype', ['float32', 'bfloat16'])
def test_five_channels_match_jax_reference(out_dtype):
    """The JAX function takes any channel count; so does the port."""
    x = _images((3, 9, 7, 5), 'uint8', seed=5)
    mean, std = (0.1, 0.2, 0.3, 0.4, 0.5), (0.5, 0.4, 0.3, 0.2, 0.25)
    want = normalize_images_reference(jnp.asarray(x), mean, std, dtype=DTYPES[out_dtype][1])
    got = port.normalize_images(torch.from_numpy(x), mean, std, dtype=DTYPES[out_dtype][0])
    _assert_close(got.float().numpy(), want, out_dtype)


def test_half_output_and_half_input_match_jax_reference():
    """f16 and bf16 images in, f16 out: within one f16 ulp (2^-10 of the
    value), at least 1e-6 where ``x * scale + shift`` cancels."""
    x = _images((2, 6, 8, 3), 'float32', seed=6)
    for in_dtype, jax_in in ((torch.float16, jnp.float16), (torch.bfloat16, jnp.bfloat16)):
        xin = torch.from_numpy(x).to(in_dtype)
        want = normalize_images_reference(jnp.asarray(xin.float().numpy()).astype(jax_in),
                                          dtype=jnp.float16)
        got = port.normalize_images(xin, dtype=torch.float16)
        assert got.dtype == torch.float16
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=2.0 ** -10, atol=1e-6)
