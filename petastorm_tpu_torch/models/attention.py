"""Dense attention (counterpart of ``petastorm_tpu/models/attention.py:168``).

The reference path of :class:`~petastorm_tpu_torch.models.transformer.
MultiHeadAttention` and the oracle of the flash kernels. Ring and all-to-all
sequence parallelism (``attention.py:91``, ``:144``) are not ported yet.
"""

import math

import torch


def dense_attention(q, k, v, causal=False):
    """``[B, T, H, D]`` -> ``[B, T, H, D]``, computed in the inputs' type."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum('bqhd,bkhd->bhqk', q, k) * scale
    if causal:
        t = q.shape[1]
        mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, -math.inf)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum('bhqk,bkhd->bqhd', probs, v)
