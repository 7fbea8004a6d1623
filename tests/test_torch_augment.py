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


def _jax_beta_perm(key, n, alpha, splits):
    keys = jax.random.split(key, splits)
    return keys, jax.random.beta(keys[0], alpha, alpha), jax.random.permutation(keys[-1], n)


@pytest.mark.parametrize('dtype', [np.float32, jnp.bfloat16])
def test_apply_mixup_matches_mixup_on_its_draws(dtype):
    """The images blend in their own type (bf16 stays bf16); the soft
    labels in f32."""
    x = _images((6, 8, 10, 3), 15, np.float32) / 255.0
    labels = np.eye(5, dtype=np.float32)[np.random.default_rng(16).integers(0, 5, 6)]
    key = jax.random.PRNGKey(17)
    _, lam, perm = _jax_beta_perm(key, 6, 0.2, 2)
    jx = jnp.asarray(x, dtype)
    want_images, want_labels = jax_aug.mixup(jx, jnp.asarray(labels), key, alpha=0.2)
    tx = _t(np.asarray(jx, np.float32))
    if dtype != np.float32:
        tx = tx.to(torch.bfloat16)
    got_images, got_labels = port.apply_mixup(tx, _t(labels), _t(lam), _t(perm))
    assert got_images.dtype == tx.dtype and got_labels.dtype == torch.float32
    np.testing.assert_allclose(got_images.float().numpy(), np.asarray(want_images, np.float32),
                               atol=1e-6 if dtype == np.float32 else 2 ** -8, rtol=0)
    np.testing.assert_allclose(got_labels.numpy(), np.asarray(want_labels), atol=1e-6, rtol=0)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_apply_cutmix_matches_cutmix_on_its_draws(seed):
    """Integer box edges: the pasted pixels are exact, and the labels mix
    by the realised pixel area."""
    n, h, w = 5, 12, 18
    x = _images((n, h, w, 3), 18 + seed, np.float32)
    labels = np.eye(4, dtype=np.float32)[np.random.default_rng(seed).integers(0, 4, n)]
    key = jax.random.PRNGKey(20 + seed)
    keys, lam, perm = _jax_beta_perm(key, n, 1.0, 4)
    cy, cx = jax.random.uniform(keys[1]) * h, jax.random.uniform(keys[2]) * w
    want_images, want_labels = jax_aug.cutmix(jnp.asarray(x), jnp.asarray(labels), key)
    got_images, got_labels = port.apply_cutmix(_t(x), _t(labels), _t(lam), _t(cy), _t(cx),
                                               _t(perm))
    np.testing.assert_array_equal(got_images.numpy(), np.asarray(want_images))
    np.testing.assert_allclose(got_labels.numpy(), np.asarray(want_labels), atol=1e-6, rtol=0)


def test_mixup_and_cutmix_draw_from_their_generator():
    x = torch.from_numpy(_images((8, 6, 6, 3), 21, np.float32))
    labels = torch.eye(8)
    a = port.mixup(x, labels, torch.Generator().manual_seed(3))
    b = port.mixup(x, labels, torch.Generator().manual_seed(3))
    c = port.cutmix(x, labels, torch.Generator().manual_seed(3))
    d = port.cutmix(x, labels, torch.Generator().manual_seed(3))
    assert all(torch.equal(p, q) for p, q in zip(a + c, b + d))
    lam, perm = port.sample_mixup(8, torch.Generator().manual_seed(4), 'cpu')
    assert lam.dtype == torch.float32 and lam.ndim == 0 and 0.0 <= float(lam) <= 1.0
    assert sorted(perm.tolist()) == list(range(8))
    lam, cy, cx, perm = port.sample_cutmix(8, 10, 20, torch.Generator().manual_seed(5), 'cpu')
    assert 0.0 <= float(cy) < 10 and 0.0 <= float(cx) < 20 and sorted(perm.tolist()) == list(range(8))
    mixed, mixed_labels = port.cutmix(x, labels, torch.Generator().manual_seed(6))
    torch.testing.assert_close(mixed_labels.sum(-1), torch.ones(8))     # still distributions


@pytest.mark.parametrize('alpha', [0.2, 1.0, 2.0])
def test_beta_draws_have_the_beta_mean_and_variance(alpha):
    """Beta(a, a): mean 1/2, variance 1 / (4 (2a + 1)); 20000 draws, so the
    sample mean's standard error is below 0.004 and the variance's below
    ~0.003."""
    g = torch.Generator().manual_seed(7)
    draws = torch.stack([port.sample_beta(alpha, g, 'cpu') for _ in range(20000)]).double()
    assert bool(((draws >= 0) & (draws <= 1)).all())
    assert abs(float(draws.mean()) - 0.5) < 0.015
    want_var = 1.0 / (4.0 * (2.0 * alpha + 1.0))
    assert abs(float(draws.var()) - want_var) < 0.1 * want_var


@pytest.mark.parametrize('shape,out_hw', [((3, 40, 56, 3), (32, 32)), ((2, 48, 36, 3), (24, 20)),
                                          ((2, 24, 24, 3), (32, 32))])
def test_imagenet_eval_preprocess_matches_jax(shape, out_hw):
    """Deterministic, so compared directly: downscales and an upscale, a
    non-square source and a non-square output."""
    x = _images(shape, 22)
    out_h, out_w = out_hw
    want = jax_aug.imagenet_eval_preprocess(jnp.asarray(x), out_h, out_w, dtype=jnp.float32)
    got = port.imagenet_eval_preprocess(_t(x), out_h, out_w, dtype=torch.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == (shape[0], out_h, out_w, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    want_bf16 = jax_aug.imagenet_eval_preprocess(jnp.asarray(x), out_h, out_w)
    got_bf16 = port.imagenet_eval_preprocess(_t(x), out_h, out_w)
    assert got_bf16.dtype == torch.bfloat16
    np.testing.assert_allclose(got_bf16.float().numpy(), np.asarray(want_bf16, np.float32),
                               atol=2 ** -6, rtol=0)      # one bf16 ulp at |x| < 4


def test_imagenet_eval_preprocess_refuses_a_box_outside_the_image():
    x = _images((1, 40, 40, 3), 23)
    with pytest.raises(ValueError, match='exceeds'):
        jax_aug.imagenet_eval_preprocess(jnp.asarray(x), 16, 64)
    with pytest.raises(ValueError, match='exceeds'):
        port.imagenet_eval_preprocess(_t(x), 16, 64)


def test_scan_body_augment_equals_the_eager_augment_for_one_seed():
    """``make_scan_train_step(preprocess=augment, generator=g)`` runs the
    augment inside the K-step body on ``g``; K one-step calls on the
    microbatch slices, augmenting on a generator with the same seed, give
    the same metrics and params exactly."""
    import copy

    from petastorm_tpu_torch.models import (ResNetTiny, create_train_state,
                                            make_scan_train_step, make_train_step)
    from petastorm_tpu_torch.models.resnet import init_flax_like

    def augment(images, generator):
        return port.imagenet_train_augment(images, generator, 24, 24, dtype=torch.float32)

    k, micro = 2, 4
    model = init_flax_like(ResNetTiny(num_classes=5, dtype=torch.float32, device='cpu'),
                           torch.Generator().manual_seed(0))
    states = [create_train_state(m, learning_rate=0.1, momentum=0.9)
              for m in (model, copy.deepcopy(model))]
    scan = make_scan_train_step(k, augment, generator=torch.Generator().manual_seed(9))
    single, g = make_train_step(), torch.Generator().manual_seed(9)
    images = torch.from_numpy(_images((k * micro, 32, 40, 3), 24))
    labels = torch.arange(k * micro) % 5
    got = scan(states[0], images, labels)
    want = [single(states[1], augment(images[i * micro:(i + 1) * micro], g),
                   labels[i * micro:(i + 1) * micro]) for i in range(k)]
    assert torch.equal(got['last_loss'], want[-1]['loss'])
    assert torch.equal(got['loss'], torch.stack([m['loss'] for m in want]).mean())
    for (name, a), b in zip(states[0].model.state_dict().items(),
                            states[1].model.state_dict().values()):
        assert torch.equal(a, b), name
    with pytest.raises(ValueError, match='preprocess'):
        make_scan_train_step(k, generator=g)
