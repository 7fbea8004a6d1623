"""Decoder-only Transformer LM (counterpart of ``petastorm_tpu/models/transformer.py``).

``[B, T]`` integer tokens -> ``[B, T, vocab]`` f32 logits, pre-LN residual
blocks, with ``attention='dense'`` (:func:`..attention.dense_attention`) or
``'flash'`` (:func:`petastorm_tpu_torch.ops.flash_attention.flash_attention`,
the hand-written CUDA kernels on the card). Params are f32; ``dtype`` is the
compute type, and every layer casts its params and input to it, as flax's
``dtype=`` does. With ``moe_experts > 0`` a :class:`~.moe.SwitchMoE`
replaces each block's MLP. ``'ring'`` and ``'a2a'`` are not ported yet and
raise.

Parity with flax, hazard by hazard:

- Flax ``LayerNorm`` has ``epsilon=1e-6`` (torch's default is 1e-5), takes
  its statistics in f32 even for bf16 input, with the fast variance
  ``E[x^2] - E[x]^2`` clipped at 0, and returns the compute type.
- ``nn.gelu`` is the tanh approximation: ``F.gelu(approximate='tanh')``.
- Dense layers round the product to the compute type, then add the bias
  in it (two roundings in bf16): the bias is added after the product here too.
- ``nn.Embed`` keeps an f32 table and looks it up cast to the compute type;
  ``pos_embed`` is an ``Embed(max_len)`` read at ``arange(t)``, and
  ``t > max_len`` raises.
- The head runs in the compute type and the logits are then cast to f32, so
  in bf16 they carry bf16 rounding.
- Weight layouts differ (flax ``[in, out]`` and ``[d, H, Dh]``; torch
  ``[out, in]``): :mod:`petastorm_tpu_torch.convert` carries them across.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from petastorm_tpu_torch.device import resolve_device
from petastorm_tpu_torch.models.attention import dense_attention
from petastorm_tpu_torch.models.moe import SwitchMoE

LN_EPSILON = 1e-6
_NOT_PORTED = ('ring', 'a2a')


def gelu(x):
    """Flax ``nn.gelu``: the tanh approximation, not torch's default erf."""
    return F.gelu(x, approximate='tanh')


class Dense(nn.Linear):
    """``nn.Linear`` computed as flax's ``Dense``: product in ``dtype``, then
    the bias added in ``dtype``."""

    def __init__(self, in_features, out_features, dtype):
        super().__init__(in_features, out_features)
        self.dtype = dtype

    def forward(self, x):
        y = torch.matmul(x.to(self.dtype), self.weight.to(self.dtype).t())
        return y + self.bias.to(self.dtype)


class LayerNorm(nn.Module):
    """Flax ``LayerNorm``: f32 statistics, fast variance, ``epsilon=1e-6``."""

    def __init__(self, features, dtype):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.dtype = dtype

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + LN_EPSILON) * self.scale
        return ((xf - mean) * mul + self.bias).to(self.dtype)


class MultiHeadAttention(nn.Module):
    def __init__(self, d_model, num_heads, attention='dense', causal=True, dtype=torch.bfloat16):
        super().__init__()
        if attention in _NOT_PORTED:
            raise NotImplementedError('attention={!r} (sequence parallelism) is not ported to '
                                      'petastorm_tpu_torch yet'.format(attention))
        if attention not in ('dense', 'flash'):
            raise ValueError('unknown attention {!r}'.format(attention))
        if d_model % num_heads:
            raise ValueError('d_model {} not divisible by num_heads {}'.format(d_model, num_heads))
        self.num_heads = num_heads
        self.attention = attention
        self.causal = causal
        self.dtype = dtype
        self.query = Dense(d_model, d_model, dtype)
        self.key = Dense(d_model, d_model, dtype)
        self.value = Dense(d_model, d_model, dtype)
        self.out = Dense(d_model, d_model, dtype)

    def forward(self, x):
        b, t, d = x.shape
        heads = (b, t, self.num_heads, d // self.num_heads)
        q, k, v = (proj(x).view(heads) for proj in (self.query, self.key, self.value))
        if self.attention == 'flash':
            from petastorm_tpu_torch.ops.flash_attention import flash_attention
            out = flash_attention(q, k, v, causal=self.causal)
        else:
            out = dense_attention(q, k, v, causal=self.causal)
        return self.out(out.to(self.dtype).reshape(b, t, d))


class Block(nn.Module):
    def __init__(self, d_model, num_heads, mlp_ratio=4, attention='dense', causal=True,
                 moe_experts=0, dtype=torch.bfloat16):
        super().__init__()
        self.norm_attn = LayerNorm(d_model, dtype)
        self.attn = MultiHeadAttention(d_model, num_heads, attention, causal, dtype)
        self.norm_mlp = LayerNorm(d_model, dtype)
        self.moe = None
        if moe_experts > 0:
            self.moe = SwitchMoE(d_model, moe_experts, mlp_ratio, dtype=dtype)
        else:
            self.mlp_in = Dense(d_model, d_model * mlp_ratio, dtype)
            self.mlp_out = Dense(d_model * mlp_ratio, d_model, dtype)

    def forward(self, x):
        x = x + self.attn(self.norm_attn(x))
        y = self.norm_mlp(x)
        if self.moe is not None:
            return x + self.moe(y)
        return x + self.mlp_out(gelu(self.mlp_in(y)))


class TransformerLM(nn.Module):
    """``[B, T]`` integer tokens -> ``[B, T, vocab]`` float32 logits (causal).

    :param device: where the params live: ``'cuda'`` (default; raises
        without a GPU) or ``'cpu'``.
    """

    def __init__(self, vocab_size, d_model=256, num_heads=4, num_layers=2, max_len=2048,
                 attention='dense', moe_experts=0, dtype=torch.bfloat16, device='cuda'):
        super().__init__()
        device = resolve_device(device)
        self.max_len = max_len
        self.dtype = dtype
        self.embed = nn.Embedding(vocab_size, d_model)
        self.pos_embed = nn.Embedding(max_len, d_model)
        self.blocks = nn.ModuleList(
            Block(d_model, num_heads, 4, attention, True, moe_experts, dtype)
            for _ in range(num_layers))
        self.norm = LayerNorm(d_model, dtype)
        self.head = Dense(d_model, vocab_size, dtype)
        self.to(device)

    def forward(self, tokens):
        b, t = tokens.shape
        if t > self.max_len:
            raise ValueError('sequence length {} exceeds max_len {}'.format(t, self.max_len))
        x = F.embedding(tokens.long(), self.embed.weight).to(self.dtype)
        x = x + self.pos_embed.weight[:t].to(self.dtype)[None]
        for block in self.blocks:
            x = block(x)
        return self.head(self.norm(x)).float()


def init_flax_like(model, generator):
    """Initialise as flax does, from ``generator``: dense kernels
    lecun-normal (truncated at 2 sigma, fan-in = input width), expert
    weights the same per expert (fan-in d or h, not E·d: flax's
    ``batch_axis=(0,)``), biases 0, embeddings normal with std
    ``1/sqrt(d_model)``, LayerNorm scale 1 and bias 0. Draws are made on the
    generator's device and copied to the model's, so one seed gives the same
    weights on the CPU and the card."""
    def lecun(param, fan_in):
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        draw = torch.empty(param.shape, device=generator.device)
        nn.init.trunc_normal_(draw, std=std, a=-2 * std, b=2 * std, generator=generator)
        with torch.no_grad():
            param.copy_(draw)

    for module in model.modules():
        if isinstance(module, nn.Linear):
            lecun(module.weight, module.in_features)
            with torch.no_grad():
                module.bias.zero_()
        elif isinstance(module, SwitchMoE):
            lecun(module.w_up, module.w_up.shape[-2])
            lecun(module.w_down, module.w_down.shape[-2])
        elif isinstance(module, nn.Embedding):
            draw = torch.randn(module.weight.shape, generator=generator, device=generator.device)
            with torch.no_grad():
                module.weight.copy_(draw / math.sqrt(module.embedding_dim))
        elif isinstance(module, LayerNorm):
            with torch.no_grad():
                module.scale.fill_(1.0)
                module.bias.zero_()
    return model
