"""MLP for the MNIST example (counterpart of ``petastorm_tpu/models/mlp.py``).

Flattens the input, then Dense + ReLU layers, then a Dense head; f32
logits. Flax infers the input width at init; a torch module takes it at
construction (``in_features``). Every layer is the port's flax-like
:class:`~.transformer.Dense` (product, then bias, in ``dtype``) and
:func:`~.transformer.init_flax_like` initialises it as flax does.
"""

import torch
from torch import nn

from petastorm_tpu_torch.device import resolve_device
from petastorm_tpu_torch.models.transformer import Dense


class MLP(nn.Module):
    """``[B, ...]`` -> ``[B, num_classes]`` float32 logits. ``layers``
    holds the hidden layers and then the head, as flax's ``Dense_0`` to
    ``Dense_<len(features)>``."""

    def __init__(self, in_features, features=(128, 64), num_classes=10, dtype=torch.float32,
                 device='cuda'):
        super().__init__()
        widths = (in_features,) + tuple(features) + (num_classes,)
        self.dtype = dtype
        self.layers = nn.ModuleList(Dense(a, b, dtype) for a, b in zip(widths, widths[1:]))
        self.to(resolve_device(device))

    def forward(self, x):
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        return self.layers[-1](x).float()
