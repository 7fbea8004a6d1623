"""On-device image augmentation (counterpart of ``petastorm_tpu/ops/augment.py``).

Every op is split in two: ``sample_*`` draws its parameters from an explicit
``torch.Generator`` (never global RNG state), and ``apply_*`` applies given
parameters. ``jax.random`` streams cannot be reproduced in torch, so the
``apply_*`` half is what is held against the JAX ops on the same
parameters; the ``sample_*`` half follows the same distributions.

The resize in ``apply_resized_crop`` rebuilds ``jax.image.scale_and_translate
(method='linear')``, which antialiases when downscaling: per axis a
triangle-kernel weight matrix, the kernel widened by the downscale factor,
normalised, with taps of samples outside the image zeroed; then two batched
matmuls. ``F.interpolate(antialias=True)`` differs at the borders, so it is
not used. No Pallas kernel computes any of this: it stays plain PyTorch,
apart from the normalize kernel the recipes end in.

Inside a captured CUDA graph the draws come from the generator the graph
registered (``make_scan_train_step(generator=)``), so every replay draws
anew; the ops copy nothing from the host once their constants are cached
on the device (:func:`_gray_weights`).
"""

import math

import numpy as np
import torch

from petastorm_tpu_torch.ops.image_ops import (apply_flip, normalize_images,
                                               random_flip_and_normalize, sample_flip)

_GRAY = (0.299, 0.587, 0.114)
_gray_cache = {}


def _gray_weights(device):
    """The saturation term's luma weights, f32 on ``device``, made once per
    device: a host-to-device copy in every call would stop a graph capture."""
    if device not in _gray_cache:
        _gray_cache[device] = torch.tensor(_GRAY, dtype=torch.float32).to(device)
    return _gray_cache[device]


def sample_crop(n, h, w, crop_h, crop_w, generator, device):
    """Per-sample crop offsets ``(ys, xs)``, uniform over the valid range."""
    if crop_h > h or crop_w > w:
        raise ValueError('crop {}x{} exceeds image {}x{}'.format(crop_h, crop_w, h, w))
    ys = torch.randint(0, h - crop_h + 1, (n,), generator=generator, device=device)
    xs = torch.randint(0, w - crop_w + 1, (n,), generator=generator, device=device)
    return ys, xs


def apply_crop(images, ys, xs, crop_h, crop_w):
    """``[N, H, W, C] -> [N, crop_h, crop_w, C]`` at the given offsets."""
    n = images.shape[0]
    rows = ys.view(n, 1, 1) + torch.arange(crop_h, device=images.device).view(1, crop_h, 1)
    cols = xs.view(n, 1, 1) + torch.arange(crop_w, device=images.device).view(1, 1, crop_w)
    return images[torch.arange(n, device=images.device).view(n, 1, 1), rows, cols]


def random_crop(images, generator, crop_h, crop_w):
    n, h, w, _ = images.shape
    ys, xs = sample_crop(n, h, w, crop_h, crop_w, generator, images.device)
    return apply_crop(images, ys, xs, crop_h, crop_w)


def random_flip(images, generator):
    """Per-sample horizontal flip with probability 0.5."""
    return apply_flip(images, sample_flip(images.shape[0], generator, images.device))


def sample_resized_crop(n, h, w, generator, device, scale=(0.08, 1.0),
                        ratio=(3.0 / 4.0, 4.0 / 3.0)):
    """Inception-style crop boxes ``(oy, ox, ch, cw)``, f32 ``[n]`` each:
    area fraction ~ U(scale), aspect ~ exp(U(log ratio)), the box clamped
    inside the image and placed uniformly."""
    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=generator, device=device)

    area = uniform(scale[0], scale[1])
    aspect = torch.exp(uniform(math.log(ratio[0]), math.log(ratio[1])))
    ch = torch.sqrt(area * h * w / aspect)
    cw = ch * aspect
    ch = ch.clamp(1.0, h)
    cw = cw.clamp(1.0, w)
    oy = torch.rand(n, generator=generator, device=device) * (h - ch)
    ox = torch.rand(n, generator=generator, device=device) * (w - cw)
    return oy, ox, ch, cw


def _linear_weight_mat(input_size, output_size, scale, translation):
    """``[N, input_size, output_size]`` resampling weights, as
    ``jax.image``'s ``compute_weight_mat`` with the triangle kernel and
    antialiasing, for per-sample f32 ``scale``/``translation`` ``[N]``."""
    device = scale.device
    inv_scale = (1.0 / scale).view(-1, 1, 1)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = ((torch.arange(output_size, dtype=torch.float32, device=device) + 0.5).view(1, 1, -1)
                * inv_scale - translation.view(-1, 1, 1) * inv_scale - 0.5)
    x = (sample_f - torch.arange(input_size, dtype=torch.float32, device=device).view(1, -1, 1)
         ).abs() / kernel_scale
    weights = torch.clamp(1.0 - x, min=0.0)
    total = weights.sum(dim=1, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= input_size - 0.5)
    return torch.where(inside, weights, torch.zeros_like(weights))


def apply_resized_crop(images, oy, ox, ch, cw, out_h, out_w):
    """Resample each sample's box ``(oy, ox, ch, cw)`` to
    ``[N, out_h, out_w, C]`` f32, as the JAX op's
    ``scale_and_translate(..., method='linear')``."""
    n, h, w, c = images.shape
    sy, sx = out_h / ch, out_w / cw
    wy = _linear_weight_mat(h, out_h, sy, -oy * sy)   # [N, h, out_h]
    wx = _linear_weight_mat(w, out_w, sx, -ox * sx)   # [N, w, out_w]
    x = images.to(torch.float32).reshape(n, h, w * c)
    rows = torch.bmm(wy.transpose(1, 2), x).reshape(n, out_h, w, c)
    # einsum may hand back a permuted view; later ops keep its strides, and
    # the normalize kernel reads contiguous NHWC.
    return torch.einsum('niwc,nwj->nijc', rows, wx).contiguous()


def random_resized_crop(images, generator, out_h, out_w, scale=(0.08, 1.0),
                        ratio=(3.0 / 4.0, 4.0 / 3.0)):
    n, h, w, _ = images.shape
    box = sample_resized_crop(n, h, w, generator, images.device, scale, ratio)
    return apply_resized_crop(images, *box, out_h, out_w)


def sample_color_jitter(n, generator, device, brightness=0.4, contrast=0.4, saturation=0.4):
    """Per-sample factors ``1 + U(-x, x)`` (``None`` for a disabled term)."""
    def factor(x):
        if not x:
            return None
        return 1.0 + (2.0 * torch.rand(n, generator=generator, device=device) - 1.0) * x

    return factor(brightness), factor(contrast), factor(saturation)


def apply_color_jitter(images, brightness, contrast, saturation, max_value=255.0):
    """Brightness, contrast, then saturation jitter with the given ``[N]``
    factors (``None`` skips a term) on float ``[N, H, W, 3]`` images in
    ``[0, max_value]``; each stage clamps back into the domain."""
    out = images.to(torch.float32)
    if brightness is not None:
        out = (out * brightness.view(-1, 1, 1, 1)).clamp(0.0, max_value)
    if contrast is not None:
        mean = out.mean(dim=(1, 2, 3), keepdim=True)
        out = ((out - mean) * contrast.view(-1, 1, 1, 1) + mean).clamp(0.0, max_value)
    if saturation is not None:
        gray = (out * _gray_weights(out.device)).sum(dim=-1, keepdim=True)
        out = (gray + (out - gray) * saturation.view(-1, 1, 1, 1)).clamp(0.0, max_value)
    return out


def color_jitter(images, generator, brightness=0.4, contrast=0.4, saturation=0.4,
                 max_value=255.0):
    factors = sample_color_jitter(images.shape[0], generator, images.device,
                                  brightness, contrast, saturation)
    return apply_color_jitter(images, *factors, max_value=max_value)


def sample_imagenet_train_augment(n, h, w, generator, device, jitter=0.4):
    """Parameters of one :func:`imagenet_train_augment` call."""
    return {'box': sample_resized_crop(n, h, w, generator, device),
            'flip': sample_flip(n, generator, device),
            'jitter': sample_color_jitter(n, generator, device, jitter, jitter, jitter)}


def apply_imagenet_train_augment(images_u8, params, out_h=224, out_w=224, dtype=torch.bfloat16):
    """Resized crop -> color jitter -> flip fused into the normalize kernel.

    The JAX op flips before the jitter; the jitter is per image and per
    pixel (its contrast mean is over the whole image), so it commutes with
    a horizontal flip and the flip can ride the normalize pass for free.
    """
    out = apply_resized_crop(images_u8, *params['box'], out_h, out_w)
    out = apply_color_jitter(out, *params['jitter'])
    return normalize_images(out, dtype=dtype, flip=params['flip'])


def imagenet_train_augment(images_u8, generator, out_h=224, out_w=224, jitter=0.4,
                           dtype=torch.bfloat16):
    """The Inception/ResNet train recipe on device: uint8 ``[N, H, W, 3]``
    in, ``dtype`` ``[N, out_h, out_w, 3]`` out, one normalize-kernel launch
    on CUDA."""
    n, h, w, _ = images_u8.shape
    params = sample_imagenet_train_augment(n, h, w, generator, images_u8.device, jitter)
    return apply_imagenet_train_augment(images_u8, params, out_h, out_w, dtype)


def train_augment(images_u8, generator, crop_h, crop_w, flip=True, normalize=True,
                  dtype=torch.bfloat16):
    """Random crop -> random horizontal flip -> normalize; the flip fuses
    into the normalize kernel when both are on."""
    out = random_crop(images_u8, generator, crop_h, crop_w)
    if flip and normalize:
        return random_flip_and_normalize(out, generator, dtype=dtype)
    if flip:
        out = random_flip(out, generator)
    if normalize:
        return normalize_images(out, dtype=dtype)
    return out.to(dtype)


def sample_beta(alpha, generator, device):
    """One f32 draw of Beta(alpha, alpha), as ``X / (X + Y)`` with X and Y
    drawn from Gamma(alpha, 1) by ``torch._standard_gamma`` (the sampler
    behind ``torch.distributions.Gamma``) on ``generator``.
    ``torch.distributions.Beta`` takes no generator, and the ops never draw
    from global RNG state."""
    gammas = torch._standard_gamma(torch.full((2,), float(alpha), device=device),
                                   generator=generator)
    return gammas[0] / gammas.sum()


def _mix_labels(labels, lam, perm):
    """``lam * labels + (1 - lam) * labels[perm]`` in the type JAX promotes
    an f32 ``lam`` and ``labels`` to (f32 for bf16, f16 or integer labels)."""
    labels = labels.to(torch.promote_types(labels.dtype, torch.float32))
    return lam * labels + (1.0 - lam) * labels[perm]


def sample_mixup(n, generator, device, alpha=0.2):
    """``(lam, perm)``: one Beta(alpha, alpha) ``lam`` for the batch (f32,
    0-d) and a partner permutation of ``n``."""
    lam = sample_beta(alpha, generator, device)
    return lam, torch.randperm(n, generator=generator, device=device)


def apply_mixup(images, labels_onehot, lam, perm):
    """Convex-combine each sample with its partner ``perm``: the images in
    their own type (a bf16 pipeline stays bf16, ``augment.py:160-164``),
    the soft labels as JAX promotes them."""
    lam_i = lam.to(images.dtype)
    mixed = lam_i * images + (1 - lam_i) * images[perm]
    return mixed, _mix_labels(labels_onehot, lam, perm)


def mixup(images, labels_onehot, generator, alpha=0.2):
    """Batch mixup (Zhang et al. 2017): ``(mixed_images, mixed_labels)``."""
    lam, perm = sample_mixup(images.shape[0], generator, images.device, alpha)
    return apply_mixup(images, labels_onehot, lam, perm)


def sample_cutmix(n, h, w, generator, device, alpha=1.0):
    """``(lam, cy, cx, perm)``: one Beta(alpha, alpha) ``lam``, the box
    centre uniform over the image in pixels (f32, 0-d each) and a partner
    permutation."""
    lam = sample_beta(alpha, generator, device)
    cy = torch.rand((), generator=generator, device=device) * h
    cx = torch.rand((), generator=generator, device=device) * w
    return lam, cy, cx, torch.randperm(n, generator=generator, device=device)


def apply_cutmix(images, labels_onehot, lam, cy, cx, perm):
    """Paste the box of area ``1 - lam`` centred at ``(cy, cx)`` from each
    sample's partner. The box edges are whole pixels, clipped to the image,
    and the labels mix by the pixel area actually pasted
    (``augment.py:183-203``)."""
    _, h, w, _ = images.shape
    cut = torch.sqrt(1.0 - lam)
    bh, bw = cut * h, cut * w
    y0 = torch.floor(torch.clamp(cy - bh / 2.0, 0, h))
    y1 = torch.floor(torch.clamp(cy + bh / 2.0, 0, h))
    x0 = torch.floor(torch.clamp(cx - bw / 2.0, 0, w))
    x1 = torch.floor(torch.clamp(cx + bw / 2.0, 0, w))
    ys = torch.arange(h, dtype=torch.float32, device=images.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=images.device)[None, :]
    inside = (ys >= y0) & (ys < y1) & (xs >= x0) & (xs < x1)
    mixed = torch.where(inside[None, :, :, None], images[perm], images)
    lam_real = 1.0 - (y1 - y0) * (x1 - x0) / (h * w)
    return mixed, _mix_labels(labels_onehot, lam_real, perm)


def cutmix(images, labels_onehot, generator, alpha=1.0):
    """Batch CutMix (Yun et al. 2019) on ``[N, H, W, C]`` float images:
    ``(mixed_images, mixed_labels)``."""
    n, h, w, _ = images.shape
    return apply_cutmix(images, labels_onehot,
                        *sample_cutmix(n, h, w, generator, images.device, alpha))


def imagenet_eval_preprocess(images_u8, out_h=224, out_w=224, resize_ratio=256.0 / 224.0,
                             dtype=torch.bfloat16):
    """The deterministic eval recipe (``augment.py:206-246``): one resample
    of a centred box keyed off the shorter side (resize-256 then
    centre-crop-224, fused), then normalize, one normalize-kernel launch on
    CUDA. uint8 ``[N, H, W, 3]`` in, ``dtype`` ``[N, out_h, out_w, 3]`` out.
    Raises ``ValueError`` where the box would leave the image."""
    n, h, w, _ = images_u8.shape
    shorter = min(h, w)
    ch = out_h * shorter / (resize_ratio * min(out_h, out_w))
    cw = out_w * shorter / (resize_ratio * min(out_h, out_w))
    if ch > h or cw > w:
        raise ValueError(
            'eval crop box {:.0f}x{:.0f} exceeds the {}x{} source: the output aspect {}x{} is '
            'too far from the source aspect for resize_ratio={} (crop to a squarer output, or '
            'lower the ratio)'.format(ch, cw, h, w, out_h, out_w, resize_ratio))
    box = (torch.full((n,), value, dtype=torch.float32, device=images_u8.device)
           for value in ((h - ch) / 2.0, (w - cw) / 2.0, ch, cw))
    out = apply_resized_crop(images_u8, *box, out_h, out_w)
    return normalize_images(out, dtype=dtype)
