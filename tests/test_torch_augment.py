"""The port's augmentation held against the JAX ops.

``jax.random`` streams cannot be reproduced in torch, so each ``apply_*`` is
given the parameters the JAX op draws: the test repeats the op's own
``jax.random`` calls on the same key and hands the results to the port.
The ``sample_*`` halves get range and rate checks. Tolerances: exact for
crops and flips (pure indexing), ``atol=1e-3`` on the [0, 255] scale for
the resample and the jitter (f32 sums in another order), ``atol=1e-4``
after normalisation.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petastorm_tpu.ops import augment as jax_aug
from petastorm_tpu_torch.ops import augment as port


def _images(shape, seed, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.uniform(0.0, 255.0, shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_crop_offsets(key, n, h, w, crop_h, crop_w):
    key_y, key_x = jax.random.split(key)
    return (jax.random.randint(key_y, (n,), 0, h - crop_h + 1),
            jax.random.randint(key_x, (n,), 0, w - crop_w + 1))


def _jax_resized_crop_box(key, n, h, w, scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0)):
    k_area, k_ratio, k_y, k_x = jax.random.split(key, 4)
    area = jax.random.uniform(k_area, (n,), minval=scale[0], maxval=scale[1])
    log_r = jax.random.uniform(k_ratio, (n,), minval=math.log(ratio[0]), maxval=math.log(ratio[1]))
    aspect = jnp.exp(log_r)
    ch = jnp.sqrt(area * h * w / aspect)
    cw = jnp.clip(ch * aspect, 1.0, w)
    ch = jnp.clip(ch, 1.0, h)
    oy = jax.random.uniform(k_y, (n,)) * (h - ch)
    ox = jax.random.uniform(k_x, (n,)) * (w - cw)
    return tuple(_t(v) for v in (oy, ox, ch, cw))


def _jax_jitter_factors(key, n, b, c, s):
    k_b, k_c, k_s = jax.random.split(key, 3)
    return tuple(_t(1.0 + jax.random.uniform(k, (n, 1, 1, 1), minval=-x, maxval=x)).reshape(n)
                 for k, x in ((k_b, b), (k_c, c), (k_s, s)))


@pytest.mark.parametrize('seed', [0, 1])
def test_apply_crop_matches_random_crop(seed):
    x = _images((5, 20, 24, 3), seed)
    key = jax.random.PRNGKey(seed)
    ys, xs = _jax_crop_offsets(key, 5, 20, 24, 12, 16)
    want = jax_aug.random_crop(jnp.asarray(x), key, 12, 16)
    got = port.apply_crop(_t(x), _t(ys), _t(xs), 12, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_apply_flip_matches_random_flip():
    x = _images((8, 6, 10, 3), 2)
    key = jax.random.PRNGKey(3)
    flips = jax.random.bernoulli(key, 0.5, (8,))
    want = jax_aug.random_flip(jnp.asarray(x), key)
    np.testing.assert_array_equal(port.apply_flip(_t(x), _t(flips)).numpy(), np.asarray(want))


@pytest.mark.parametrize('out_hw', [(16, 16), (24, 40), (48, 32)])
def test_apply_resized_crop_matches_scale_and_translate(out_hw):
    """Explicit boxes through ``jax.image.scale_and_translate`` — down- and
    up-scaling, boxes touching the borders."""
    n, h, w = 4, 30, 36
    out_h, out_w = out_hw
    x = _images((n, h, w, 3), 5)
    rng = np.random.default_rng(6)
    ch = np.array([h, 7.5, 20.0, 1.0], np.float32)
    cw = np.array([w, 31.0, 9.25, 1.0], np.float32)
    oy = (rng.uniform(size=n) * (h - ch)).astype(np.float32)
    ox = (rng.uniform(size=n) * (w - cw)).astype(np.float32)
    want = []
    for i in range(n):
        sy, sx = np.float32(out_h) / ch[i], np.float32(out_w) / cw[i]
        want.append(jax.image.scale_and_translate(
            jnp.asarray(x[i], jnp.float32), (out_h, out_w, 3), (0, 1), jnp.stack([sy, sx]),
            jnp.stack([-oy[i] * sy, -ox[i] * sx]), method='linear'))
    got = port.apply_resized_crop(_t(x), _t(oy), _t(ox), _t(ch), _t(cw), out_h, out_w)
    assert got.dtype == torch.float32 and got.is_contiguous()   # the kernel reads NHWC
    np.testing.assert_allclose(got.numpy(), np.stack(want), atol=1e-3)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_apply_resized_crop_matches_random_resized_crop(seed):
    x = _images((6, 40, 32, 3), seed)
    key = jax.random.PRNGKey(seed)
    box = _jax_resized_crop_box(key, 6, 40, 32)
    want = jax_aug.random_resized_crop(jnp.asarray(x), key, 24, 24)
    got = port.apply_resized_crop(_t(x), *box, 24, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)


def test_apply_color_jitter_matches_color_jitter():
    x = _images((5, 12, 12, 3), 4, np.float32)
    key = jax.random.PRNGKey(9)
    factors = _jax_jitter_factors(key, 5, 0.4, 0.3, 0.2)
    want = jax_aug.color_jitter(jnp.asarray(x), key, 0.4, 0.3, 0.2)
    np.testing.assert_allclose(port.apply_color_jitter(_t(x), *factors).numpy(),
                               np.asarray(want), atol=1e-3)


def test_imagenet_train_augment_matches_jax_on_its_draws():
    """The whole recipe: crop, flip (fused into the normalize pass in the
    port), jitter, normalize, on the parameters the JAX op drew."""
    x = _images((4, 40, 48, 3), 8)
    key = jax.random.PRNGKey(11)
    k_crop, k_flip, k_jit = jax.random.split(key, 3)
    params = {'box': _jax_resized_crop_box(k_crop, 4, 40, 48),
              'flip': _t(jax.random.bernoulli(k_flip, 0.5, (4,))),
              'jitter': _jax_jitter_factors(k_jit, 4, 0.4, 0.4, 0.4)}
    want = jax_aug.imagenet_train_augment(jnp.asarray(x), key, 32, 32, dtype=jnp.float32)
    got = port.apply_imagenet_train_augment(_t(x), params, 32, 32, dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_train_augment_matches_jax_on_its_draws():
    x = _images((5, 20, 20, 3), 12)
    key = jax.random.PRNGKey(13)
    key_crop, key_flip = jax.random.split(key)
    ys, xs = _jax_crop_offsets(key_crop, 5, 20, 20, 16, 16)
    flips = jax.random.bernoulli(key_flip, 0.5, (5,))
    want = jax_aug.train_augment(jnp.asarray(x), key, 16, 16, dtype=jnp.float32)
    cropped = port.apply_crop(_t(x), _t(ys), _t(xs), 16, 16)
    got = port.normalize_images(cropped, dtype=torch.float32, flip=_t(flips))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_sample_ranges_and_rates():
    g = torch.Generator().manual_seed(0)
    n = 20000
    flip_rate = float(port.sample_flip(n, g, 'cpu').float().mean())
    assert 0.48 < flip_rate < 0.52
    ys, xs = port.sample_crop(n, 20, 30, 16, 16, g, 'cpu')
    assert ys.min() == 0 and ys.max() == 4 and xs.min() == 0 and xs.max() == 14
    oy, ox, ch, cw = port.sample_resized_crop(n, 40, 60, g, 'cpu')
    assert bool(((ch >= 1) & (ch <= 40) & (cw >= 1) & (cw <= 60)).all())
    assert bool(((oy >= 0) & (oy + ch <= 40 + 1e-4) & (ox >= 0) & (ox + cw <= 60 + 1e-4)).all())
    unclamped = (ch < 40) & (cw < 60)
    area = (ch * cw / (40 * 60))[unclamped]
    assert 0.08 - 1e-4 <= float(area.min()) and float(area.max()) <= 1.0 + 1e-4
    for f in port.sample_color_jitter(n, g, 'cpu', 0.4, 0.4, 0.4):
        assert 0.6 <= float(f.min()) and float(f.max()) <= 1.4 and abs(float(f.mean()) - 1) < 0.01
    assert port.sample_color_jitter(4, g, 'cpu', 0, 0.4, 0)[0] is None


def test_same_generator_seed_same_augmentation():
    x = torch.from_numpy(_images((3, 24, 24, 3), 14))
    a = port.imagenet_train_augment(x, torch.Generator().manual_seed(5), 16, 16)
    b = port.imagenet_train_augment(x, torch.Generator().manual_seed(5), 16, 16)
    c = port.imagenet_train_augment(x, torch.Generator().manual_seed(6), 16, 16)
    assert a.dtype == torch.bfloat16 and tuple(a.shape) == (3, 16, 16, 3)
    assert torch.equal(a, b) and not torch.equal(a, c)
    out = port.train_augment(x, torch.Generator().manual_seed(5), 16, 16)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (3, 16, 16, 3)
