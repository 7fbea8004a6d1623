"""Parameters on a mesh: the spec functions' placements applied to a
module, the split layers' forward, and the gradient all-reduce.

The JAX package places each leaf with ``NamedSharding(mesh,
spec_fn(path, leaf, mesh))`` and lets XLA derive the collectives. The
port narrows each parameter to this rank's shard (:func:`shard_parameters`)
and keeps the placement beside it; the layers read it and run the
Megatron pair around their local products (:func:`linear_forward`), and
:func:`sync_gradients` averages the gradients over the axes the batch is
split over (flattened into one buffer a group, so that a CUDA graph captures one
NCCL call a group). :func:`to_dtensors` views the local shards as
``DTensor``s for ``torch.distributed.checkpoint``.

A spec here is a tuple with one entry per dim of the *port's* layout
(``nn.Linear`` weights are ``[out, in]``, the transpose of flax's
kernels): an axis name, a tuple of them, or None.
"""

import torch
import torch.distributed as dist
from torch import nn

from petastorm_tpu_torch.parallel import collectives
from petastorm_tpu_torch.parallel.mesh import axis_names, axis_group, axis_index, axis_size


def spec_axes(spec):
    """Every mesh axis a spec splits over."""
    return {a for entry in (spec or ()) for a in axis_names(entry)}


def shard_tensor(tensor, mesh, spec):
    """This rank's block of ``tensor`` (its global value) under ``spec``;
    ``ValueError`` when a split dim does not divide."""
    local = tensor
    for dim, entry in enumerate(spec or ()):
        n = axis_size(mesh, entry)
        if n == 1:
            continue
        if local.shape[dim] % n:
            raise ValueError('dim {} of {} does not divide over {} = {}'.format(
                dim, tuple(tensor.shape), entry, n))
        step = local.shape[dim] // n
        local = local.narrow(dim, axis_index(mesh, entry) * step, step)
    return local


def shard_parameters(model, mesh, spec_fn):
    """Replace every parameter of ``model`` that ``spec_fn(name, param,
    mesh, module)`` splits by this rank's shard of it (the current value
    is the global one: the same on every rank, e.g. from one seed or one
    flax tree). Returns ``{name: (spec, global_shape)}`` of the split ones;
    each owning module keeps ``_tp_specs`` (leaf -> spec) and ``_tp_mesh``."""
    placements = {}
    for name, param in list(model.named_parameters()):
        module_name, _, leaf = name.rpartition('.')
        module = model.get_submodule(module_name) if module_name else model
        spec = spec_fn(name, param, mesh, module)
        if not spec_axes(spec):
            continue
        spec = tuple(spec)
        local = shard_tensor(param.detach(), mesh, spec).clone()
        setattr(module, leaf, nn.Parameter(local, requires_grad=param.requires_grad))
        specs = dict(getattr(module, '_tp_specs', {}))
        specs[leaf] = spec
        module._tp_specs = specs
        module._tp_mesh = mesh
        placements[name] = (spec, tuple(param.shape))
    return placements


def param_spec(module, leaf):
    specs = getattr(module, '_tp_specs', None)
    return specs.get(leaf) if specs else None


def linear_forward(module, x, product, add_bias, gather_output=False, whole=None):
    """A linear layer whose weight may be split over one mesh axis.

    Unsplit: ``whole(x)`` (the layer's own forward, where it fuses the
    bias), or ``add_bias(product(x))``. Column-split (``weight`` spec
    ``(axis, None)``, the bias split alike): the input's gradient is summed
    over the axis (:func:`~.collectives.copy_to`), this rank computes its
    output features the same way on its shard, and ``gather_output``
    concatenates them in rank order. Row-split (``(None, axis)``, the bias
    whole): the partial products are summed over the axis, then the bias is
    added once.
    """
    spec = param_spec(module, 'weight')
    local = whole or (lambda x: add_bias(product(x)))
    if spec is None:
        return local(x)
    if spec[0] is not None:
        group = axis_group(module._tp_mesh, spec[0])
        y = local(collectives.copy_to(x, group))
        return collectives.gather_last(y, group) if gather_output else y
    group = axis_group(module._tp_mesh, spec[1])
    return add_bias(collectives.reduce_from(product(x), group))


def _mesh_order(mesh, axes):
    return tuple(sorted(axes, key=mesh.mesh_dim_names.index))


def sync_gradients(model, mesh, data_axes, placements):
    """Average every gradient over the ``data_axes`` its parameter is not
    split over, as XLA reduces a replicated leaf's gradient over the batch's
    axes. Each rank's loss is the mean over its tile, so the average is the
    global loss's gradient. A parameter split over a data axis (an expert
    over ``'expert'``) already holds the sum over that axis's ranks (through
    the all-to-all's backward), so it is divided by the axis's size instead.

    One flattened buffer a group of axes, reduced with ``ReduceOp.AVG`` on
    NCCL (a reduction kernel even on one rank, inside a captured graph too)
    and as a sum then a division on gloo, which has no average.
    """
    buckets = {}
    for name, param in model.named_parameters():
        if param.grad is None:
            continue
        split = spec_axes(placements.get(name, (None,))[0])
        axes = tuple(a for a in data_axes if a not in split)
        scale = 1.0 / axis_size(mesh, tuple(a for a in data_axes if a in split))
        if scale != 1.0:
            param.grad.mul_(scale)
        if axes:
            buckets.setdefault(_mesh_order(mesh, axes), []).append(param.grad)
    for axes, grads in buckets.items():
        group = axis_group(mesh, axes)
        flat = torch.cat([g.reshape(-1) for g in grads])
        if dist.get_backend(group) == 'nccl':
            dist.all_reduce(flat, op=dist.ReduceOp.AVG, group=group)
        else:
            dist.all_reduce(flat, group=group)
            flat.div_(axis_size(mesh, axes))
        # One multi-tensor copy back, not a kernel a parameter.
        pieces = flat.split([g.numel() for g in grads])
        torch._foreach_copy_(grads, [p.view_as(g) for p, g in zip(pieces, grads)])


def mean_over(value, mesh, axes):
    """A metric averaged over ``axes`` (no autograd): the global loss from
    the ranks' tile means."""
    axes = tuple(a for a in axes if axis_size(mesh, a) > 1)
    if not axes:
        return value
    value = value.detach().clone()
    dist.all_reduce(value, group=axis_group(mesh, _mesh_order(mesh, axes)))
    return value / axis_size(mesh, axes)


def to_dtensors(tensors, mesh, placements):
    """``{name: tensor}`` with each split entry viewed as a ``DTensor`` of
    its global shape (the local shard, no copy), for
    ``torch.distributed.checkpoint``: a save writes each rank's shard, a
    load fills them in place, and a restore onto another mesh reshards."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    out = {}
    for name, tensor in tensors.items():
        if name not in placements or not torch.is_tensor(tensor):
            out[name] = tensor
            continue
        spec, global_shape = placements[name]
        dims = {}
        for dim, entry in enumerate(spec):
            for a in axis_names(entry):
                dims[a] = dim
        if any(len(axis_names(entry)) > 1 for entry in spec):
            raise ValueError('a checkpoint takes one mesh axis a dim, got {}'.format(spec))
        mesh_placements = [Shard(dims[a]) if a in dims else Replicate()
                           for a in mesh.mesh_dim_names]
        out[name] = DTensor.from_local(tensor, mesh, mesh_placements, run_check=False,
                                       shape=torch.Size(global_shape),
                                       stride=torch.empty(global_shape, device='meta').stride())
    return out
