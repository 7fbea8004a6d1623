"""Fused on-device image normalization: uint8 or float NHWC -> f32/bf16/f16.

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

- the grid is (sample, block of ``_BLOCK`` elements of that sample's
  rows), flattened to one axis so that neither count meets CUDA's limit
  on the second axis; the split is a division by a compile-time constant,
  once a program;
- H, W and C are compile-time constants, so no index needs a divide by a
  runtime value;
- the flip is one scalar load a program and picks one of two paths: the
  unflipped path reads a contiguous range whose start is a known multiple
  of ``_BLOCK`` (16-byte vector loads and stores); the flipped path reads
  the mirrored pixel, ``offset + (W - 1 - 2 w) C``, with ``w`` from the
  offset by constant divisors;
- for ``C <= 4`` channels scale and shift are scalar arguments selected by
  the channel; for more, each element reads them from a ``C``-entry f32
  table at ``offset % C`` (a few hundred bytes, served from L1).

The block of 2048 elements and 4 warps came from a sweep on the card at
the main path's shape, where every block of 1024-4096 elements with 4 or
8 warps ran within about 1% of the best (``PERF.md``). The kernel takes
uint8, f16, bf16 or f32 images and writes f32, bf16 or f16, as the JAX
function does. The TPU kernel's (8, 128) padding and int32 widening were
Mosaic workarounds and are gone.
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
#: Channels up to which scale and shift are scalar arguments; past it, a table.
_SCALAR_CHANNELS = 4
_KERNEL_IN = (torch.uint8, torch.float16, torch.bfloat16, torch.float32)
_KERNEL_OUT = (torch.float32, torch.bfloat16, torch.float16)
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
    def normalize_kernel(x_ptr, out_ptr, flip_ptr, scale_ptr, shift_ptr,
                         s0, s1, s2, s3, t0, t1, t2, t3,
                         H: tl.constexpr, W: tl.constexpr, C: tl.constexpr,
                         HAS_FLIP: tl.constexpr, BLOCK: tl.constexpr, TABLE: tl.constexpr):
        IMAGE: tl.constexpr = H * W * C
        BLOCKS: tl.constexpr = (IMAGE + BLOCK - 1) // BLOCK
        pid = tl.program_id(0)
        n = pid // BLOCKS                                # the sample
        local = (pid - n * BLOCKS) * BLOCK + tl.arange(0, BLOCK)
        local = tl.max_contiguous(tl.multiple_of(local, BLOCK), BLOCK)
        mask = local < IMAGE
        base = n * IMAGE                                 # int32: the wrapper keeps numel < 2**31
        c = local % C
        if TABLE:                                        # C > 4: per-channel table
            scale = tl.load(scale_ptr + c)
            shift = tl.load(shift_ptr + c)
        else:
            scale = tl.where(c == 0, s0, s1)
            shift = tl.where(c == 0, t0, t1)
            if C > 2:
                scale = tl.where(c == 2, s2, scale)
                shift = tl.where(c == 2, t2, shift)
            if C > 3:
                scale = tl.where(c == 3, s3, scale)
                shift = tl.where(c == 3, t3, shift)
        flipped = tl.full([], 0, tl.int32)               # without a mask the branch folds away
        if HAS_FLIP:
            flipped = tl.load(flip_ptr + n).to(tl.int32)
        if flipped != 0:
            w = (local // C) % W                         # the output pixel's column
            x = tl.load(x_ptr + base + local + (W - 1 - 2 * w) * C, mask=mask, other=0)
            y = x.to(tl.float32) * scale + shift
            tl.store(out_ptr + base + local, y.to(out_ptr.dtype.element_ty), mask=mask)
        else:
            x = tl.load(x_ptr + base + local, mask=mask, other=0)
            y = x.to(tl.float32) * scale + shift
            tl.store(out_ptr + base + local, y.to(out_ptr.dtype.element_ty), mask=mask)

    _kernel = (triton, normalize_kernel)
    return _kernel


def _normalize_triton(images, mean, std, dtype, flip=None):
    """Launch the kernel; ``mean`` and ``std`` are sequences of ``C`` (or
    one) floats."""
    n, h, w, c = images.shape
    if images.dtype not in _KERNEL_IN:
        raise TypeError('normalize kernel takes uint8, float16, bfloat16 or float32 images, '
                        'got {}'.format(images.dtype))
    if dtype not in _KERNEL_OUT:
        raise TypeError('normalize kernel writes float32, bfloat16 or float16, got {}'.format(dtype))
    if not images.is_contiguous():
        raise ValueError('normalize kernel needs contiguous NHWC images')
    if c < 1:
        raise ValueError('normalize kernel needs at least one channel')
    if len(mean) not in (1, c) or len(std) != len(mean):
        raise ValueError('normalize kernel takes one mean and std or one per channel, '
                         'got {} and {} for {} channels'.format(len(mean), len(std), c))
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
    mean, std = tuple(mean) * (c // len(mean)), tuple(std) * (c // len(std))
    table = c > _SCALAR_CHANNELS
    if table:
        # The table lives on the card (cached, so a CUDA graph's capture
        # copies nothing); the scalar arguments go unused.
        scale_t, shift_t = _scale_shift(mean, std, images.device)
        scalars = [0.0] * (2 * _SCALAR_CHANNELS)
    else:
        # The scalars are the tables' f32 values, taken on the host.
        scale_t = shift_t = images
        cpu_scale, cpu_shift = _scale_shift(mean, std, torch.device('cpu'))
        pad = [0.0] * (_SCALAR_CHANNELS - c)
        scalars = cpu_scale.tolist() + pad + cpu_shift.tolist() + pad
    triton, kernel = _kernel or _build_kernel()
    grid = (n * triton.cdiv(h * w * c, _BLOCK),)
    with torch.cuda.device(images.device):
        kernel[grid](images, out, flip if flip is not None else images, scale_t, shift_t, *scalars,
                     H=h, W=w, C=c, HAS_FLIP=flip is not None, BLOCK=_BLOCK, TABLE=table,
                     num_warps=_NUM_WARPS)
    LAUNCHES['normalize_images'] += 1
    return out


def normalize_images(images, mean=IMAGENET_MEAN, std=IMAGENET_STD, dtype=torch.bfloat16,
                     flip=None):
    """``[N, H, W, C]`` uint8 or float (on the [0, 255] scale) ->
    ``((x / 255) - mean) / std`` in ``dtype``, optionally W-flipping the
    samples where the ``[N]`` bool ``flip`` mask is set. ``mean`` and
    ``std`` hold one value or one per channel.

    A CUDA tensor goes through the Triton kernel; a CPU tensor through
    :func:`normalize_images_plain`.
    """
    if images.ndim != 4:
        raise ValueError('Expected NHWC batch, got shape {}'.format(tuple(images.shape)))
    if images.device.type == 'cuda':
        return _normalize_triton(images, mean, std, dtype, flip)
    if images.device.type == 'cpu':
        scale, shift = _scale_shift(mean, std, images.device)
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
