"""Vision Transformer (counterpart of ``petastorm_tpu/models/vit.py``).

``[B, H, W, C]`` images -> ``[B, num_classes]`` f32 logits: patchify, a
zero CLS token, learned positions, the LM stack's pre-LN
:class:`~.transformer.Block` with ``causal=False`` (dense or flash
attention; optional :class:`~.moe.SwitchMoE` MLPs), a final LayerNorm on
the CLS token, then the head.

Parity with flax, hazard by hazard:

- Patchify is flax's ``nn.Conv`` with kernel = stride = p (``'SAME'``
  pads nothing when H and W divide by p), whose ``[B, H/p, W/p, d]``
  output is flattened row-major. Here it is the same function as a
  product: each patch is read in (row, column, channel) order, the order
  of the flax HWIO kernel ``[p, p, C, d]`` flattened, and multiplied by it
  as a :class:`~.transformer.Dense` (the product in the compute type, then
  the bias in it, as flax's conv adds its bias). No NCHW layout, so no
  permute back before the flatten.
- ``pos_embed`` is ``[1, T + 1, d]``, sized by the image at flax's init; a
  torch module sizes it at construction from ``image_size``, and a forward
  on another number of patches raises. The CLS token starts at zeros,
  ``pos_embed`` normal with std 0.02 (:func:`init_flax_like`).
- The readout is the CLS token through the final LayerNorm (per token, so
  only the CLS row is normalised), the head, then f32.
"""

import torch
from torch import nn

from petastorm_tpu_torch.device import resolve_device
from petastorm_tpu_torch.models import transformer
from petastorm_tpu_torch.models.transformer import Block, Dense, LayerNorm


class ViT(nn.Module):
    """``[B, H, W, C]`` images (any type; cast to ``dtype``) ->
    ``[B, num_classes]`` float32 logits.

    :param image_size: ``H`` (square) or ``(H, W)`` of the inputs, which
        sizes ``pos_embed``; both must divide by ``patch_size``.
    :param attention: ``'dense'`` (default) or ``'flash'``.
    :param device: ``'cuda'`` (default; raises without a GPU) or ``'cpu'``.
    """

    def __init__(self, num_classes, image_size=224, patch_size=16, d_model=384, num_heads=6,
                 num_layers=8, mlp_ratio=4, attention='dense', moe_experts=0, in_channels=3,
                 dtype=torch.bfloat16, device='cuda'):
        super().__init__()
        h, w = (image_size, image_size) if isinstance(image_size, int) else image_size
        _check_divisible(h, w, patch_size)
        self.patch_size = patch_size
        self.num_patches = (h // patch_size) * (w // patch_size)
        self.dtype = dtype
        self.patch_embed = Dense(patch_size * patch_size * in_channels, d_model, dtype)
        self.cls = nn.Parameter(torch.zeros(1, 1, d_model))
        self.pos_embed = nn.Parameter(torch.zeros(1, self.num_patches + 1, d_model))
        self.blocks = nn.ModuleList(
            Block(d_model, num_heads, mlp_ratio, attention, False, moe_experts, dtype)
            for _ in range(num_layers))
        self.norm = LayerNorm(d_model, dtype)
        self.head = Dense(d_model, num_classes, dtype)
        self.to(resolve_device(device))

    def forward(self, images):
        b, h, w, c = images.shape
        p = self.patch_size
        _check_divisible(h, w, p)
        if (h // p) * (w // p) != self.num_patches:
            raise ValueError('image {}x{} gives {} patches; this ViT was built for {}'.format(
                h, w, (h // p) * (w // p), self.num_patches))
        x = images.to(self.dtype).reshape(b, h // p, p, w // p, p, c)
        x = self.patch_embed(x.permute(0, 1, 3, 2, 4, 5).reshape(b, self.num_patches, p * p * c))
        cls = self.cls.to(self.dtype).expand(b, 1, x.shape[-1])
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(self.dtype)
        for block in self.blocks:
            x = block(x)
        return self.head(self.norm(x[:, 0])).float()


class ViTTiny(ViT):
    """Test scale: patch 4, d 32, 2 heads, 2 layers."""

    def __init__(self, num_classes, image_size=224, patch_size=4, d_model=32, num_heads=2,
                 num_layers=2, **kwargs):
        super().__init__(num_classes, image_size, patch_size, d_model, num_heads, num_layers,
                         **kwargs)


def _check_divisible(h, w, p):
    if h % p or w % p:
        raise ValueError('image {}x{} not divisible by patch_size {}'.format(h, w, p))


def init_flax_like(model, generator):
    """Initialise as flax does, from ``generator``: every Dense, LayerNorm
    and expert layer as :func:`.transformer.init_flax_like` (the patch
    embedding's fan-in is ``p·p·C``, as the conv's), the CLS token zeros and
    ``pos_embed`` normal with std 0.02."""
    transformer.init_flax_like(model, generator)
    draw = torch.randn(model.pos_embed.shape, generator=generator, device=generator.device)
    with torch.no_grad():
        model.pos_embed.copy_(0.02 * draw)
        model.cls.zero_()
    return model
