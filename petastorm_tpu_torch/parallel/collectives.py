"""The collectives the JAX package leaves to XLA, written out with their
backward passes.

Each is a ``torch.autograd.Function`` over one process group, taking and
returning plain contiguous tensors (never DTensors), so the hand-written
kernels take their outputs as they are and a CUDA graph captures the NCCL
calls between them. The Megatron pair (``copy_to`` / ``reduce_from``)
and the gather of a column-split output follow Shoeybi et al. (2019);
``all_to_all`` is its own transpose, so its backward is one more
``all_to_all``.
"""

import torch
import torch.distributed as dist


def group_size(group):
    return dist.get_world_size(group)


# ``all_gather_into_tensor`` was renamed ``all_gather_single`` in later torch.
_all_gather_single = getattr(dist, 'all_gather_single', None) or dist.all_gather_into_tensor


def _gather_stacked(x, group):
    """``[n, *x.shape]``: every rank's ``x`` in rank order (gloo and NCCL
    both take the output as ``[n * x.shape[0], ...]``)."""
    x = x.contiguous().reshape((1,) + tuple(x.shape)) if x.ndim == 0 else x.contiguous()
    n = group_size(group)
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    _all_gather_single(out, x, group=group)
    return out.reshape((n,) + tuple(x.shape))


class _CopyTo(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group (the
    input of a column-split layer, used by every rank of the group)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    """Sum over the group forward (the partial products of a row-split
    layer); identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group both ways: a statistic that every rank's loss
    reads (synchronised BatchNorm's sums, the sequence-parallel loss)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherLast(torch.autograd.Function):
    """Concatenate the ranks' pieces along the last dim, in rank order; the
    backward keeps this rank's piece (what follows runs alike on every rank)."""

    @staticmethod
    def forward(ctx, x, group):
        n = group_size(group)
        ctx.group, ctx.width = group, x.shape[-1]
        out = _gather_stacked(x, group)
        return out.movedim(0, -2).reshape(tuple(x.shape[:-1]) + (n * x.shape[-1],))

    @staticmethod
    def backward(ctx, g):
        i = dist.get_rank(ctx.group)
        return g[..., i * ctx.width:(i + 1) * ctx.width].contiguous(), None


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over dim 0 in equal chunks: chunk ``j`` goes to
    rank ``j``, and chunk ``i`` of the result came from rank ``i``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g, group=ctx.group)
        return out, None


def copy_to(x, group):
    return _CopyTo.apply(x, group)


def reduce_from(x, group):
    return _ReduceFrom.apply(x, group)


def all_reduce_sum(x, group):
    return _AllReduceSum.apply(x, group)


def gather_last(x, group):
    return _GatherLast.apply(x, group)


def all_to_all(x, group):
    if x.shape[0] % group_size(group):
        raise ValueError('all_to_all splits dim 0 ({}) into {} equal chunks'.format(
            x.shape[0], group_size(group)))
    return _AllToAll.apply(x, group)


def all_gather_plain(x, group):
    """``[n, *x.shape]`` of every rank's ``x``, without autograd."""
    return _gather_stacked(x, group)


def exchange(send=None, dst=None, recv=None, src=None, group=None):
    """One round of point-to-point: send ``send`` to global rank ``dst``
    and receive into ``recv`` from global rank ``src`` (either may be None),
    posted together so that a ring of ranks cannot deadlock."""
    ops = []
    if send is not None:
        ops.append(dist.P2POp(dist.isend, send.contiguous(), dst, group))
    if recv is not None:
        ops.append(dist.P2POp(dist.irecv, recv, src, group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return recv
