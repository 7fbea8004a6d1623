"""ResNet in PyTorch (counterpart of ``petastorm_tpu/models/resnet.py:18-117``).

The public interface keeps the JAX package's layout: NHWC input, f32
logits. Inside, the NHWC tensor is permuted to NCHW *view* whose memory is
``channels_last``, so cuDNN runs NHWC convolutions without a copy. Params
stay f32; with ``dtype=torch.bfloat16`` the forward runs under bf16
autocast, as the flax model computes in bf16 with f32 params.

Parity with flax, hazard by hazard:

- Flax ``'SAME'`` padding is asymmetric: a 3x3/2 conv on an even input pads
  ``(0, 1)``, the 3x3/2 max pool pads ``(0, 1)`` with -inf and the 4x4/1
  space-to-depth stem pads ``(1, 2)``. Every such pad is an explicit
  ``F.pad`` computed from the input size (:func:`same_padding`).
- Flax ``BatchNorm(momentum=0.9)`` updates ``ra = 0.9 ra + 0.1 batch`` with
  the *biased* batch variance; torch's ``momentum=0.1`` matches the mean,
  and :class:`BatchNorm` corrects torch's unbiased variance update.
- The last BatchNorm of every block starts with a zero scale.

On a mesh (``create_train_state(mesh=...)``) the batch statistics are
those of the global batch, as under the JAX package's pjit: each
BatchNorm sums its f32 sums and sums of squares over the batch axis
(differentiably) before it normalises, with flax's fast variance
``E[x^2] - E[x]^2``. The classifier head may be split over ``'model'``
by column (:func:`~petastorm_tpu_torch.models.train._param_spec`).
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from petastorm_tpu_torch.device import resolve_device
from petastorm_tpu_torch.parallel import collectives
from petastorm_tpu_torch.parallel.tensor_parallel import linear_forward


def same_padding(size, kernel, stride):
    """``(lo, hi)`` padding of flax/XLA ``'SAME'`` along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x, kernel, stride, value=0.0):
    """``F.pad`` an NCHW tensor as flax ``'SAME'`` would."""
    top, bottom = same_padding(x.shape[2], kernel, stride)
    left, right = same_padding(x.shape[3], kernel, stride)
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


class Conv(nn.Conv2d):
    """Bias-free conv with flax ``'SAME'`` (or explicit) padding."""

    def __init__(self, in_ch, out_ch, kernel, stride=1, padding=None):
        super().__init__(in_ch, out_ch, kernel, stride=stride, padding=0, bias=False)
        self.explicit_padding = padding   # (h, w) symmetric, or None = 'SAME'

    def forward(self, x):
        if self.explicit_padding is None:
            x = _pad_same(x, self.kernel_size[0], self.stride[0])
        else:
            ph, pw = self.explicit_padding
            x = F.pad(x, (pw, pw, ph, ph))
        return super().forward(x)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm with flax's conventions: ``eps=1e-5``, running stats
    ``0.9 ra + 0.1 batch`` with the biased batch variance."""

    def __init__(self, channels, zero_scale=False):
        super().__init__(channels, eps=1e-5, momentum=0.1)
        if zero_scale:
            nn.init.zeros_(self.weight)
        #: The process group of the batch's split, set on a mesh whose
        #: batch axis has more than one rank.
        self.sync_group = None
        self.sync_size = 1

    def _synced(self, x):
        """Train-mode BatchNorm over the batch of every rank of
        ``sync_group``: flax's statistics of the global batch."""
        xf = x.float()
        count = x.numel() // x.shape[1] * self.sync_size
        sums = torch.stack((xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3))))
        sums = collectives.all_reduce_sum(sums, self.sync_group)
        mean = sums[0] / count
        var = torch.clamp(sums[1] / count - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * var)
            self.num_batches_tracked.add_(1)
        scale = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[None, :, None, None]) * scale[None, :, None, None]
        return (y + self.bias[None, :, None, None]).to(x.dtype)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if self.sync_group is not None:
            return self._synced(x)
        old_var = self.running_var.detach().clone()
        y = super().forward(x)
        # torch folded the unbiased variance vu in: new = 0.9 old + 0.1 vu.
        # Flax folds the biased one, vu (n-1)/n, i.e. new - 0.1 vu / n.
        # ``.data``: the saved-for-backward running_var keeps its version.
        n = x.numel() // x.shape[1]
        var = self.running_var.data
        var.sub_((var - (1.0 - self.momentum) * old_var) / n)
        return y


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, in_ch, filters, strides=1):
        super().__init__()
        out_ch = filters * 4
        self.conv0 = Conv(in_ch, filters, 1)
        self.norm0 = BatchNorm(filters)
        self.conv1 = Conv(filters, filters, 3, stride=strides)
        self.norm1 = BatchNorm(filters)
        self.conv2 = Conv(filters, out_ch, 1)
        self.norm2 = BatchNorm(out_ch, zero_scale=True)
        self.conv_proj = self.norm_proj = None
        if in_ch != out_ch or strides != 1:
            self.conv_proj = Conv(in_ch, out_ch, 1, stride=strides)
            self.norm_proj = BatchNorm(out_ch)

    def forward(self, x):
        y = F.relu(self.norm0(self.conv0(x)))
        y = F.relu(self.norm1(self.conv1(y)))
        y = self.norm2(self.conv2(y))
        residual = x if self.conv_proj is None else self.norm_proj(self.conv_proj(x))
        return F.relu(residual + y)


class ResNetBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch, filters, strides=1):
        super().__init__()
        self.conv0 = Conv(in_ch, filters, 3, stride=strides)
        self.norm0 = BatchNorm(filters)
        self.conv1 = Conv(filters, filters, 3)
        self.norm1 = BatchNorm(filters, zero_scale=True)
        self.conv_proj = self.norm_proj = None
        if in_ch != filters or strides != 1:
            self.conv_proj = Conv(in_ch, filters, 1, stride=strides)
            self.norm_proj = BatchNorm(filters)

    def forward(self, x):
        y = F.relu(self.norm0(self.conv0(x)))
        y = self.norm1(self.conv1(y))
        residual = x if self.conv_proj is None else self.norm_proj(self.conv_proj(x))
        return F.relu(residual + y)


class Head(nn.Linear):
    """The classifier head; split by column over ``'model'`` (the only split
    ``_param_spec`` makes of it), it runs ``nn.Linear`` on its shard and its
    logits are gathered, so every rank of the axis computes the same loss."""

    def forward(self, x):
        return linear_forward(self, x, None, None, gather_output=True, whole=super().forward)


class ResNet(nn.Module):
    """``[N, H, W, C]`` images -> ``[N, num_classes]`` f32 logits.

    :param stem: ``'conv7'`` (7x7/2) or ``'space_to_depth'`` (2x2 pixel
        blocks to channels, then a 4x4/1 conv), as the flax model.
    :param dtype: compute type; ``torch.bfloat16`` runs under autocast.
    :param device: where the params live: ``'cuda'`` (default; raises
        without a GPU) or ``'cpu'``.
    """

    def __init__(self, stage_sizes, block_cls, num_classes=1000, num_filters=64,
                 stem='conv7', dtype=torch.bfloat16, in_channels=3, device='cuda'):
        super().__init__()
        if stem not in ('conv7', 'space_to_depth'):
            raise ValueError('unknown stem {!r}'.format(stem))
        device = resolve_device(device)
        self.stem = stem
        self.dtype = dtype
        if stem == 'space_to_depth':
            self.conv_init = Conv(4 * in_channels, num_filters, 4)
        else:
            self.conv_init = Conv(in_channels, num_filters, 7, stride=2, padding=(3, 3))
        self.bn_init = BatchNorm(num_filters)
        blocks, in_ch = [], num_filters
        for i, block_count in enumerate(stage_sizes):
            for j in range(block_count):
                strides = 2 if i > 0 and j == 0 else 1
                filters = num_filters * 2 ** i
                blocks.append(block_cls(in_ch, filters, strides))
                in_ch = filters * block_cls.expansion
        self.blocks = nn.ModuleList(blocks)
        self.head = Head(in_ch, num_classes)
        self.to(device)

    def forward(self, x):
        if self.stem == 'space_to_depth':
            b, h, w, c = x.shape
            if h % 2 or w % 2:
                raise ValueError('space_to_depth stem needs even H/W, got {}x{}'.format(h, w))
            x = (x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
                 .reshape(b, h // 2, w // 2, 4 * c))
        # NHWC -> an NCHW view with channels_last memory: no copy.
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        low_precision = self.dtype != torch.float32
        # No cast cache: each weight is cast once a forward anyway, and a
        # cache must stay off inside a captured CUDA graph.
        with torch.autocast(x.device.type, dtype=self.dtype, enabled=low_precision,
                            cache_enabled=False):
            x = F.relu(self.bn_init(self.conv_init(x)))
            x = F.max_pool2d(_pad_same(x, 3, 2, value=-math.inf), 3, stride=2)
            for block in self.blocks:
                x = block(x)
            x = self.head(x.mean(dim=(2, 3)))
        return x.float()


def init_flax_like(model, generator):
    """Initialise as flax does, from ``generator``: conv and dense kernels
    lecun-normal (truncated at 2 sigma), dense bias 0, BatchNorm scale 1
    (0 where the block zero-initialises it) and bias 0. Kernels are drawn
    on the generator's device and copied to the model's, so one seed gives
    the same weights wherever the model lives."""
    for module in model.modules():
        if isinstance(module, (nn.Conv2d, nn.Linear)):
            fan_in = module.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            draw = torch.empty(module.weight.shape, device=generator.device)
            nn.init.trunc_normal_(draw, std=std, a=-2 * std, b=2 * std, generator=generator)
            with torch.no_grad():
                module.weight.copy_(draw)
            if getattr(module, 'bias', None) is not None:
                nn.init.zeros_(module.bias)
    return model


def ResNet18(**kwargs):
    return ResNet(stage_sizes=[2, 2, 2, 2], block_cls=ResNetBlock, **kwargs)


def ResNet50(**kwargs):
    return ResNet(stage_sizes=[3, 4, 6, 3], block_cls=BottleneckBlock, **kwargs)


def ResNetTiny(**kwargs):
    """A tiny variant for CPU tests."""
    kwargs.setdefault('num_filters', 8)
    return ResNet(stage_sizes=[1, 1], block_cls=ResNetBlock, **kwargs)
