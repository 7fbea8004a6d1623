"""Decoder-only Transformer LM (counterpart of ``petastorm_tpu/models/transformer.py``).

``[B, T]`` integer tokens -> ``[B, T, vocab]`` f32 logits, pre-LN residual
blocks, with ``attention='dense'`` (:func:`..attention.dense_attention`) or
``'flash'`` (:func:`petastorm_tpu_torch.ops.flash_attention.flash_attention`,
the hand-written CUDA kernels on the card). Params are f32; ``dtype`` is the
compute type, and every layer casts its params and input to it, as flax's
``dtype=`` does. With ``moe_experts > 0`` a :class:`~.moe.SwitchMoE`
replaces each block's MLP.

On a mesh (``mesh=``): ``attention='ring'`` or ``'a2a'`` with ``seq_axis``
is sequence parallelism (:mod:`.attention`): the model takes this rank's
``[B/dp, T/sp]`` tile of the tokens and positions it by the rank's
coordinate on ``seq_axis``. Tensor parallelism comes from the placements
of :func:`~petastorm_tpu_torch.models.train.transformer_param_spec`
(``create_train_state(mesh=...)``): q/k/v split by head, ``out`` by its head
input, ``mlp_in`` by column, ``mlp_out`` by row, the head by vocabulary,
each layer running the Megatron pair (:func:`~petastorm_tpu_torch.parallel.
tensor_parallel.linear_forward`); a layer whose split does not divide
stays whole. ``moe_experts`` with ``expert_axis`` is expert parallelism.

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
from petastorm_tpu_torch.models.attention import (a2a_self_attention, dense_attention,
                                                  ring_self_attention)
from petastorm_tpu_torch.models.moe import SwitchMoE
from petastorm_tpu_torch.parallel.mesh import axis_index, axis_names, axis_size, has_axis
from petastorm_tpu_torch.parallel.tensor_parallel import linear_forward

LN_EPSILON = 1e-6
_SEQUENCE_PARALLEL = ('ring', 'a2a')


def gelu(x):
    """Flax ``nn.gelu``: the tanh approximation, not torch's default erf."""
    return F.gelu(x, approximate='tanh')


class Dense(nn.Linear):
    """``nn.Linear`` computed as flax's ``Dense``: product in ``dtype``, then
    the bias added in ``dtype``. ``heads`` (attention projections) is what a
    spec function splits by; ``gather_output`` concatenates a column-split
    output over its axis (the vocabulary head)."""

    def __init__(self, in_features, out_features, dtype, heads=None, gather_output=False):
        super().__init__(in_features, out_features)
        self.dtype = dtype
        self.heads = heads
        self.gather_output = gather_output

    def forward(self, x):
        return linear_forward(
            self, x, lambda x: torch.matmul(x.to(self.dtype), self.weight.to(self.dtype).t()),
            lambda y: y + self.bias.to(self.dtype), self.gather_output)


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


def check_sequence_parallel(attention, mesh, seq_axis):
    """``attention='ring'|'a2a'`` needs ``mesh`` and ``seq_axis``: the JAX
    module's error (``petastorm_tpu/models/transformer.py:58-60``)."""
    if attention not in ('dense', 'flash') + _SEQUENCE_PARALLEL:
        raise ValueError('unknown attention {!r}'.format(attention))
    if attention in _SEQUENCE_PARALLEL and (mesh is None or seq_axis is None):
        raise ValueError("attention={!r} needs mesh= and seq_axis=".format(attention))
    if attention in _SEQUENCE_PARALLEL and not has_axis(mesh, seq_axis):
        raise ValueError('seq_axis {!r} is not an axis of the mesh {}'.format(
            seq_axis, mesh.mesh_dim_names))


class MultiHeadAttention(nn.Module):
    def __init__(self, d_model, num_heads, attention='dense', causal=True, dtype=torch.bfloat16,
                 mesh=None, seq_axis=None):
        super().__init__()
        check_sequence_parallel(attention, mesh, seq_axis)
        if d_model % num_heads:
            raise ValueError('d_model {} not divisible by num_heads {}'.format(d_model, num_heads))
        self.num_heads = num_heads
        self.head_dim = d_model // num_heads
        self.attention = attention
        self.causal = causal
        self.dtype = dtype
        self.mesh = mesh
        self.seq_axis = seq_axis
        self.query = Dense(d_model, d_model, dtype, heads=num_heads)
        self.key = Dense(d_model, d_model, dtype, heads=num_heads)
        self.value = Dense(d_model, d_model, dtype, heads=num_heads)
        self.out = Dense(d_model, d_model, dtype, heads=num_heads)

    def forward(self, x):
        b, t, _ = x.shape
        # This rank's heads: all of them, or its tensor-parallel shard.
        q, k, v = (proj(x).view(b, t, -1, self.head_dim)
                   for proj in (self.query, self.key, self.value))
        if self.attention == 'ring':
            out = ring_self_attention(q, k, v, self.mesh, self.seq_axis, causal=self.causal)
        elif self.attention == 'a2a':
            out = a2a_self_attention(q, k, v, self.mesh, self.seq_axis, causal=self.causal)
        elif self.attention == 'flash':
            from petastorm_tpu_torch.ops.flash_attention import flash_attention
            out = flash_attention(q, k, v, causal=self.causal)
        else:
            out = dense_attention(q, k, v, causal=self.causal)
        return self.out(out.to(self.dtype).reshape(b, t, -1))


class Block(nn.Module):
    def __init__(self, d_model, num_heads, mlp_ratio=4, attention='dense', causal=True,
                 moe_experts=0, dtype=torch.bfloat16, mesh=None, seq_axis=None,
                 expert_axis=None, batch_axes=()):
        super().__init__()
        self.norm_attn = LayerNorm(d_model, dtype)
        self.attn = MultiHeadAttention(d_model, num_heads, attention, causal, dtype, mesh,
                                       seq_axis)
        self.norm_mlp = LayerNorm(d_model, dtype)
        self.moe = None
        if moe_experts > 0:
            self.moe = SwitchMoE(d_model, moe_experts, mlp_ratio, dtype=dtype, mesh=mesh,
                                 expert_axis=expert_axis, batch_axes=batch_axes)
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
    :param mesh: the ``DeviceMesh`` of sequence or expert parallelism.
    :param seq_axis: the mesh axis the sequence is split over
        (``attention='ring'|'a2a'``): ``forward`` then takes this rank's
        ``[B, T/sp]`` tile.
    :param batch_axis: the mesh axis (or axes) the batch is split over; the
        Switch load-balance statistics are summed over it and
        ``expert_axis``.
    :param expert_axis: the mesh axis the experts (``moe_experts > 0``) are
        split over, with ``expert_param_spec``; the batch is then split over
        it too.
    """

    def __init__(self, vocab_size, d_model=256, num_heads=4, num_layers=2, max_len=2048,
                 attention='dense', moe_experts=0, dtype=torch.bfloat16, device='cuda',
                 mesh=None, seq_axis=None, batch_axis='data', expert_axis=None):
        super().__init__()
        device = resolve_device(device)
        check_sequence_parallel(attention, mesh, seq_axis)
        self.max_len = max_len
        self.dtype = dtype
        self.mesh = mesh
        self.seq_axis = seq_axis if attention in _SEQUENCE_PARALLEL else None
        self.expert_axis = expert_axis if moe_experts > 0 else None
        batch_axes = tuple(a for a in axis_names(batch_axis) + axis_names(expert_axis)
                           if has_axis(mesh, a))
        self.embed = nn.Embedding(vocab_size, d_model)
        self.pos_embed = nn.Embedding(max_len, d_model)
        self.blocks = nn.ModuleList(
            Block(d_model, num_heads, 4, attention, True, moe_experts, dtype, mesh,
                  self.seq_axis, expert_axis, batch_axes)
            for _ in range(num_layers))
        self.norm = LayerNorm(d_model, dtype)
        self.head = Dense(d_model, vocab_size, dtype, gather_output=True)
        self.to(device)

    def forward(self, tokens):
        b, t = tokens.shape
        start = 0
        length = t
        if self.seq_axis is not None:      # this rank's tile of the sequence
            start = axis_index(self.mesh, self.seq_axis) * t
            length = t * axis_size(self.mesh, self.seq_axis)
        if length > self.max_len:
            raise ValueError('sequence length {} exceeds max_len {}'.format(length, self.max_len))
        x = F.embedding(tokens.long(), self.embed.weight).to(self.dtype)
        x = x + self.pos_embed.weight[start:start + t].to(self.dtype)[None]
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
