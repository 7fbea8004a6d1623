"""Pipeline parallelism: the GPipe schedule over a mesh axis (counterpart
of ``petastorm_tpu/models/pipeline.py``).

Each rank along ``pipe_axis`` runs one stage. Microbatches stream through
the stages in ``M + S - 1`` ticks: at tick ``t`` stage ``s`` runs
microbatch ``t - s``, stage 0 injects it from the input, every other stage
takes the activation stage ``s - 1`` sent it the tick before, and the last
stage collects microbatch ``t - (S - 1)``. Each tick ends with one posted
send to ``s + 1`` and receive from ``s - 1`` (``batch_isend_irecv``), so
the ranks advance in lockstep.

P2P has no autograd, so the schedule is one ``torch.autograd.Function``
(:class:`_GPipe`): the forward keeps each microbatch's stage input, and the
backward walks the ticks in reverse, receives each output's gradient from
``s + 1`` (the last stage takes the caller's), recomputes the stage on the
kept input and sends the input's gradient back to ``s - 1``. The stage
function is plain PyTorch, as the JAX stage is ``jnp`` code outside any
Pallas kernel.

As in JAX, the caller passes the global stage-stacked parameters (the same
on every rank) and gets the global output and gradients on every rank: the
last stage broadcasts the output, and the parameters' and the input's
gradients are summed over the axis (each is nonzero only on the stage that
used it).
"""

import torch
import torch.distributed as dist

from petastorm_tpu_torch.parallel import collectives
from petastorm_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size


def pipeline_param_spec(name, value, mesh, module=None):
    """Stage-stacked leaves over ``'pipe'`` on their leading dim; a rank-0
    leaf or one whose leading dim the axis does not divide stays whole on
    every stage (``pipeline.py:119-127``)."""
    del name, module
    if mesh is None or 'pipe' not in (mesh.mesh_dim_names or ()):
        return None
    if value.ndim >= 1 and value.shape[0] % axis_size(mesh, 'pipe') == 0:
        return ('pipe',) + (None,) * (value.ndim - 1)
    return None


def _stage_params(names, leaves, split, stage, n_stages):
    """This stage's parameters: stage ``s``'s block of a split leaf (its
    first entry, as the JAX stage takes ``p[0]`` of its shard), a whole
    leaf as it is."""
    out = {}
    for name, leaf, is_split in zip(names, leaves, split):
        if is_split:
            leaf = leaf.reshape((n_stages, leaf.shape[0] // n_stages) + tuple(leaf.shape[1:]))
            leaf = leaf[stage][0]
        out[name] = leaf
    return out


class _GPipe(torch.autograd.Function):

    @staticmethod
    def forward(ctx, stage_fn, names, split, mesh, pipe_axis, microbatches, x, *leaves):
        group = axis_group(mesh, pipe_axis)
        n, s = axis_size(mesh, pipe_axis), axis_index(mesh, pipe_axis)
        nxt = dist.get_global_rank(group, min(s + 1, n - 1))
        prev = dist.get_global_rank(group, max(s - 1, 0))
        xs = x.detach().reshape((microbatches, x.shape[0] // microbatches) + tuple(x.shape[1:]))
        params = _stage_params(names, [p.detach() for p in leaves], split, s, n)
        acc = torch.zeros_like(xs)
        inputs = [None] * microbatches
        buf = None
        for t in range(microbatches + n - 1):
            m = t - s
            out = None
            if 0 <= m < microbatches:
                inputs[m] = xs[m] if s == 0 else buf
                out = stage_fn(params, inputs[m])
                if s == n - 1:
                    acc[m] = out
            recv_m = t + 1 - s
            buf = collectives.exchange(
                out if s < n - 1 and out is not None else None, nxt,
                torch.empty_like(xs[0]) if s > 0 and 0 <= recv_m < microbatches else None,
                prev, group)
        dist.broadcast(acc, src=dist.get_global_rank(group, n - 1), group=group)
        ctx.stage_fn, ctx.names, ctx.split = stage_fn, names, split
        ctx.group, ctx.n, ctx.s, ctx.nxt, ctx.prev = group, n, s, nxt, prev
        ctx.inputs = inputs
        ctx.save_for_backward(*leaves)
        return acc.reshape(x.shape)

    @staticmethod
    def backward(ctx, grad):
        leaves = ctx.saved_tensors
        n, s, group = ctx.n, ctx.s, ctx.group
        microbatches = len(ctx.inputs)
        g = grad.reshape((microbatches, grad.shape[0] // microbatches) + tuple(grad.shape[1:]))
        with torch.enable_grad():
            live = [p.detach().requires_grad_() for p in leaves]
            params = _stage_params(ctx.names, live, ctx.split, s, n)
        grads = [torch.zeros_like(p) for p in leaves]
        dx = torch.zeros_like(g)
        gbuf = None
        for t in reversed(range(microbatches + n - 1)):
            m = t - s
            dh = None
            if 0 <= m < microbatches:
                with torch.enable_grad():
                    h = ctx.inputs[m].detach().requires_grad_()
                    out = ctx.stage_fn(params, h)
                    found = torch.autograd.grad(out, [h] + live, g[m] if s == n - 1 else gbuf,
                                                allow_unused=True)
                dh = found[0]
                for acc, got in zip(grads, found[1:]):
                    if got is not None:
                        acc.add_(got)
                if s == 0:
                    dx[m] = dh
            recv_m = t - 1 - s
            gbuf = collectives.exchange(
                dh if s > 0 else None, ctx.prev,
                torch.empty_like(g[0]) if s < n - 1 and 0 <= recv_m < microbatches else None,
                ctx.nxt, group)
        # Each gradient is nonzero only on the stage that used it: the sum
        # over the axis is the global one, on every rank.
        flat = torch.cat([dx.reshape(-1)] + [x.reshape(-1) for x in grads])
        dist.all_reduce(flat, group=group)
        out, offset = [], 0
        for like in [dx] + grads:
            out.append(flat[offset:offset + like.numel()].view_as(like))
            offset += like.numel()
        ctx.inputs = None
        return (None, None, None, None, None, None, out[0].reshape(grad.shape)) + tuple(out[1:])


def pipeline_apply(stage_fn, stage_params, x, mesh, pipe_axis='pipe', microbatches=None):
    """Run ``x`` through ``S = mesh[pipe_axis]`` sequential stages, pipelined
    (``pipeline.py:35-116``).

    :param stage_fn: ``(params, activation) -> activation``, one stage; the
        activation's shape must not change.
    :param stage_params: dict of tensors with a leading ``[S, ...]`` stage
        dim (stage ``i``'s at index ``i``), the same on every rank; a leaf
        :func:`pipeline_param_spec` leaves whole is given whole to every
        stage.
    :param x: ``[batch, ...]``; ``batch`` must divide into
        ``microbatches`` (default S) equal microbatches.
    :returns: ``[batch, ...]``, the last stage's output, on every rank;
        differentiable in ``x`` and every leaf.
    """
    n = axis_size(mesh, pipe_axis)
    microbatches = n if microbatches is None else microbatches
    if x.shape[0] % microbatches:
        raise ValueError('batch {} not divisible into {} microbatches'.format(
            x.shape[0], microbatches))
    names = sorted(stage_params)
    leaves = [stage_params[k] for k in names]
    split = [pipeline_param_spec(k, v, mesh) is not None for k, v in zip(names, leaves)]
    return _GPipe.apply(stage_fn, names, split, mesh, pipe_axis, microbatches, x, *leaves)
