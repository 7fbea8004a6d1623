"""Dense attention and the two sequence-parallel schemes (counterpart of
``petastorm_tpu/models/attention.py``).

:func:`dense_attention` is the reference path of :class:`~petastorm_tpu_torch.
models.transformer.MultiHeadAttention` and the oracle of the flash kernels.

Sequence parallelism: each rank holds a ``[B, T/n, H, D]`` slice of q, k
and v along the mesh axis ``seq_axis`` (in rank order), and gets its slice
of the exact attention over the whole sequence.

- :func:`ring_self_attention`: k/v blocks rotate rank i -> i+1 by
  ``batch_isend_irecv`` (n - 1 hops) while an online softmax in f32
  accumulates the output, with the causal mask by *global* position. P2P
  has no autograd, so the backward is written out
  (:class:`_RingAttention`): it rotates the k/v blocks the same way
  together with their dK/dV accumulators, which take one more hop to come
  home, and rebuilds each block's probabilities from the saved logsumexp.
  Plain PyTorch (``einsum``), as the JAX ring is ``jnp`` code outside any
  Pallas kernel.
- :func:`a2a_self_attention` (Ulysses): one ``all_to_all`` trades the
  sequence split for a head split (q/k/v stacked), the flash kernels run
  on the whole sequence for ``H/n`` heads, and a second one trades back.
  ``all_to_all_single`` splits dim 0, so the head chunks are moved there
  first and the rank-major sequence order is restored after.

Attention is elementwise over the batch and the heads, so a rank's batch
tile (``'data'``) and head shard (``'model'``) stay local: the JAX
function's ``batch_axis``/``head_axis`` are where its shard_map keeps them,
and need no counterpart here.
"""

import math

import torch
import torch.distributed as dist

from petastorm_tpu_torch.parallel import collectives
from petastorm_tpu_torch.parallel.mesh import axis_group


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


def _ring_peers(group):
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    return (n, me, dist.get_global_rank(group, (me + 1) % n),
            dist.get_global_rank(group, (me - 1) % n))


def _block_scores(qf, k_blk, scale, causal, q_block, k_block):
    """``[B, H, Tq, Tk]`` f32 scores of this rank's queries against kv block
    ``k_block``, masked by global position (``attention.py:45-52``)."""
    s = torch.einsum('bqhd,bkhd->bhqk', qf, k_blk.float()) * scale
    if causal:
        t = qf.shape[1]
        q_pos = q_block * t + torch.arange(t, device=qf.device)
        k_pos = k_block * t + torch.arange(t, device=qf.device)
        s = s.masked_fill(~(q_pos[:, None] >= k_pos[None, :]), -math.inf)
    return s


class _RingAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, group, causal):
        n, me, nxt, prev = _ring_peers(group)
        scale = 1.0 / math.sqrt(q.shape[-1])
        qf = q.float()
        b, t, h, d = q.shape
        kv = torch.stack((k, v)).contiguous()
        out = torch.zeros((b, t, h, d), dtype=torch.float32, device=q.device)
        running_max = torch.full((b, h, t), -math.inf, device=q.device)
        denom = torch.zeros((b, h, t), device=q.device)
        for step in range(n):
            s = _block_scores(qf, kv[0], scale, causal, me, (me - step) % n)
            new_max = torch.maximum(running_max, s.amax(-1))
            # exp(-inf - -inf) guards: a row with nothing unmasked yet keeps
            # new_max = -inf, and its rescale stays 0 (attention.py:55-66).
            correction = torch.exp(torch.where(torch.isneginf(running_max),
                                               torch.full_like(running_max, -math.inf),
                                               running_max - new_max))
            probs = torch.exp(s - new_max[..., None])
            probs = torch.where(torch.isneginf(s), torch.zeros_like(probs), probs)
            denom = denom * correction + probs.sum(-1)
            out = (out * correction.permute(0, 2, 1)[..., None]
                   + torch.einsum('bhqk,bkhd->bqhd', probs, kv[1].float()))
            running_max = new_max
            if step < n - 1:
                kv = collectives.exchange(kv, nxt, torch.empty_like(kv), prev, group)
        safe = torch.where(denom == 0.0, torch.ones_like(denom), denom)   # fully masked rows
        out = out / safe.permute(0, 2, 1)[..., None]
        lse = torch.where(denom == 0.0, torch.full_like(denom, -math.inf),
                          running_max + torch.log(safe))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal = group, causal
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        n, me, nxt, prev = _ring_peers(ctx.group)
        scale = 1.0 / math.sqrt(q.shape[-1])
        qf, do = q.float(), g.float()
        delta = (do * out).sum(-1).permute(0, 2, 1)            # [B, H, Tq]
        dq = torch.zeros_like(qf)
        # The bundle that travels: k, v and their dK, dV accumulators.
        bundle = torch.stack((k.float(), v.float(), torch.zeros_like(qf), torch.zeros_like(qf)))
        for step in range(n):
            k_blk, v_blk = bundle[0], bundle[1]
            s = _block_scores(qf, k_blk, scale, ctx.causal, me, (me - step) % n)
            p = torch.exp(s - lse[..., None])
            p = torch.where(torch.isneginf(s), torch.zeros_like(p), p)
            dp = torch.einsum('bqhd,bkhd->bhqk', do, v_blk)
            ds = p * (dp - delta[..., None])
            dq = dq + torch.einsum('bhqk,bkhd->bqhd', ds, k_blk) * scale
            bundle = torch.stack((k_blk, v_blk,
                                  bundle[2] + torch.einsum('bhqk,bqhd->bkhd', ds, qf) * scale,
                                  bundle[3] + torch.einsum('bhqk,bqhd->bkhd', p, do)))
            if step < n - 1:
                bundle = collectives.exchange(bundle, nxt, torch.empty_like(bundle), prev,
                                              ctx.group)
        # After n steps each block's accumulators sit one rank short of home.
        grads = bundle[2:].contiguous()
        if n > 1:
            grads = collectives.exchange(grads, nxt, torch.empty_like(grads), prev, ctx.group)
        return dq.to(q.dtype), grads[0].to(k.dtype), grads[1].to(v.dtype), None, None


def ring_self_attention(q, k, v, mesh, seq_axis, causal=False):
    """Exact attention of q/k/v split along the sequence over
    ``mesh[seq_axis]``: ``[B, T/n, H, D]`` tiles in, this rank's tile of
    the output out (in q's type), differentiable."""
    return _RingAttention.apply(q, k, v, axis_group(mesh, seq_axis), causal)


def a2a_self_attention(q, k, v, mesh, seq_axis, causal=False):
    """Ulysses sequence parallelism over ``mesh[seq_axis]``: ``[B, T/n, H,
    D]`` tiles in and out; the heads of this rank (of its tensor-parallel
    shard, with one) must divide by ``n``. Runs the flash kernels on the
    whole sequence for ``H/n`` heads."""
    group = axis_group(mesh, seq_axis)
    n = dist.get_world_size(group)
    b, t, h, d = q.shape
    if h % n:
        raise ValueError('a2a sequence parallelism needs heads ({}) divisible by the mesh axis '
                         'size ({})'.format(h, n))
    # [3, B, T/n, (n, H/n), D] -> head chunk j to rank j on dim 0.
    qkv = torch.stack((q, k, v)).reshape(3, b, t, n, h // n, d).permute(3, 0, 1, 2, 4, 5)
    qkv = collectives.all_to_all(qkv, group)                 # [n (source = seq block), ...]
    qkv = qkv.permute(1, 2, 0, 3, 4, 5).reshape(3, b, n * t, h // n, d)
    from petastorm_tpu_torch.ops.flash_attention import flash_attention
    # The sm90 kernels' tensor maps read [BH, T, D] rows: whole tensors, not views.
    out = flash_attention(qkv[0].contiguous(), qkv[1].contiguous(), qkv[2].contiguous(),
                          causal=causal)
    # [B, (n, T/n), H/n, D] -> sequence block i back to rank i on dim 0.
    out = out.to(q.dtype).reshape(b, n, t, h // n, d).permute(1, 0, 2, 3, 4)
    out = collectives.all_to_all(out, group)                 # [n (source = head chunk), ...]
    return out.permute(1, 2, 0, 3, 4).reshape(b, t, h, d)
