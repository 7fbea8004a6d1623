"""Fused on-device image normalization: uint8 or float NHWC -> bf16/f32.

Counterpart of ``petastorm_tpu/ops/image_ops.py:22-122``. On a CUDA tensor
``normalize_images`` launches a hand-written Triton kernel; on a CPU tensor
it takes the plain PyTorch version (``normalize_images_plain``). There is
no fallback between the two: a CUDA tensor launches the kernel or raises.

The kernel replaces the Pallas TPU kernel ``_normalize_kernel``
(``petastorm_tpu/ops/image_ops.py:31``, launched by ``_normalize_pallas``
at ``:48``). It is one elementwise pass, ``y = x * scale[c] + shift[c]``
with ``scale = 1 / (255 std)`` and ``shift = -mean / std``, computed in f32
and stored in the output type; an optional per-sample flip mask makes it
read the mirrored W column, which fuses ``random_flip_and_normalize``.
What bounds it on Hopper: HBM bytes (read the input once, write the output
once; 2 flops per element). The design therefore does nothing but stream:
a 1-D grid over the flattened tensor, contiguous vectorized loads and
stores, the channel as ``offset % C`` with C a compile-time constant, and
the three-entry scale/shift tables served from L1. The TPU kernel's
(8, 128) padding and int32 widening were Mosaic workarounds and are gone.
"""

import collections

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

#: Kernel launches per wrapper (incremented where the kernel is launched,
#: nowhere else): the proof that a run went through the kernel.
LAUNCHES = collections.Counter()

_BLOCK = 2048
_NUM_WARPS = 4
_KERNEL_IN = (torch.uint8, torch.float32)
_KERNEL_OUT = (torch.bfloat16, torch.float32)
_kernel = None
_scale_shift_cache = {}


def reset_launch_counts():
    LAUNCHES.clear()


def _scale_shift(mean, std, device):
    """Per-channel ``(scale, shift)`` f32 tensors, folded as in the JAX
    package: ``scale = 1 / (255 std)``, ``shift = -mean / std``."""
    key = (tuple(mean), tuple(std), device)
    if key not in _scale_shift_cache:
        mean_t = torch.tensor(mean, dtype=torch.float32)
        std_t = torch.tensor(std, dtype=torch.float32)
        _scale_shift_cache[key] = ((1.0 / (255.0 * std_t)).to(device),
                                   (-mean_t / std_t).to(device))
    return _scale_shift_cache[key]


def normalize_images_plain(images, scale, shift, dtype=torch.bfloat16, flip=None):
    """The kernel's arithmetic in plain PyTorch (the CPU path and the
    kernel's yardstick): optional per-sample W flip, then
    ``x * scale + shift`` in f32, then the cast."""
    if flip is not None:
        images = apply_flip(images, flip)
    return (images.to(torch.float32) * scale + shift).to(dtype)


def _build_kernel():
    # ``tl`` is bound as a module global: @triton.jit resolves the names a
    # kernel uses in its function's globals.
    global _kernel, tl
    import triton
    import triton.language as tl

    @triton.jit
    def normalize_kernel(x_ptr, out_ptr, scale_ptr, shift_ptr, flip_ptr,
                         total, image_len, row_len,
                         C: tl.constexpr, HAS_FLIP: tl.constexpr, BLOCK: tl.constexpr):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < total
        c = offs % C
        src = offs
        if HAS_FLIP:
            flip = tl.load(flip_ptr + offs // image_len, mask=mask, other=0)
            col = (offs % row_len) // C
            src = tl.where(flip != 0, offs + (row_len // C - 1 - 2 * col) * C, offs)
        x = tl.load(x_ptr + src, mask=mask, other=0).to(tl.float32)
        scale = tl.load(scale_ptr + c, mask=mask, other=0.0)
        shift = tl.load(shift_ptr + c, mask=mask, other=0.0)
        tl.store(out_ptr + offs, (x * scale + shift).to(out_ptr.dtype.element_ty), mask=mask)

    _kernel = (triton, normalize_kernel)
    return _kernel


def _normalize_triton(images, scale, shift, dtype, flip=None):
    n, h, w, c = images.shape
    if images.dtype not in _KERNEL_IN:
        raise TypeError('normalize kernel takes uint8 or float32 images, got {}'.format(images.dtype))
    if dtype not in _KERNEL_OUT:
        raise TypeError('normalize kernel writes bf16 or f32, got {}'.format(dtype))
    if not images.is_contiguous():
        raise ValueError('normalize kernel needs contiguous NHWC images')
    total = images.numel()
    if total >= 2 ** 31:
        raise ValueError('normalize kernel indexes with int32; {} elements is too many'.format(total))
    if flip is not None:
        if flip.shape != (n,) or flip.device != images.device:
            raise ValueError('flip must be a [{}] tensor on {}, got {} on {}'.format(
                n, images.device, tuple(flip.shape), flip.device))
        flip = flip.to(torch.uint8).contiguous()
    out = torch.empty(images.shape, dtype=dtype, device=images.device)
    if total == 0:
        return out
    triton, kernel = _kernel or _build_kernel()
    grid = (triton.cdiv(total, _BLOCK),)
    with torch.cuda.device(images.device):
        kernel[grid](images, out, scale, shift, flip if flip is not None else scale,
                     total, h * w * c, w * c,
                     C=c, HAS_FLIP=flip is not None, BLOCK=_BLOCK, num_warps=_NUM_WARPS)
    LAUNCHES['normalize_images'] += 1
    return out


def normalize_images(images, mean=IMAGENET_MEAN, std=IMAGENET_STD, dtype=torch.bfloat16,
                     flip=None):
    """``[N, H, W, C]`` uint8 or float (on the [0, 255] scale) ->
    ``((x / 255) - mean) / std`` in ``dtype``, optionally W-flipping the
    samples where the ``[N]`` bool ``flip`` mask is set.

    A CUDA tensor goes through the Triton kernel; a CPU tensor through
    :func:`normalize_images_plain`.
    """
    if images.ndim != 4:
        raise ValueError('Expected NHWC batch, got shape {}'.format(tuple(images.shape)))
    scale, shift = _scale_shift(mean, std, images.device)
    if images.device.type == 'cuda':
        return _normalize_triton(images, scale, shift, dtype, flip)
    if images.device.type == 'cpu':
        return normalize_images_plain(images, scale, shift, dtype, flip)
    raise ValueError('normalize_images runs on cuda or cpu tensors, got {}'.format(images.device))


def sample_flip(n, generator, device):
    """``[n]`` bool: flip each sample with probability 0.5."""
    return torch.rand(n, generator=generator, device=device) < 0.5


def apply_flip(images, flips):
    """W-flip the samples of ``[N, H, W, C]`` where the ``[N]`` mask is set."""
    return torch.where(flips.view(-1, 1, 1, 1).bool(), images.flip(2), images)


def random_flip_and_normalize(images, generator, mean=IMAGENET_MEAN, std=IMAGENET_STD,
                              dtype=torch.bfloat16):
    """Per-sample random horizontal flip fused into the normalization."""
    flips = sample_flip(images.shape[0], generator, images.device)
    return normalize_images(images, mean, std, dtype, flip=flips)
