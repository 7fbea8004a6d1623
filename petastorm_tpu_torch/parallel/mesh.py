"""Device meshes over ``torch.distributed`` (counterpart of
``petastorm_tpu/parallel/mesh.py``).

The JAX package runs one process per host and lets XLA place the
collectives; the port runs one process per GPU (``torchrun`` style) on a
:class:`torch.distributed.device_mesh.DeviceMesh` whose dims carry the
JAX axis names (``'data'``, ``'model'``, ``'sp'``, ``'expert'``,
``'pipe'``), and writes its collectives out (:mod:`.collectives`).

Two differences follow from the process model:

- :func:`process_shard` is the rank's coordinate on the batch axis and that
  axis's size, not ``(rank, world)``. In JAX one process owns a host's
  devices, so ``jax.process_index()`` is that coordinate; here ranks that
  differ only on ``'model'``, ``'sp'``, ``'expert'`` or ``'pipe'`` must read
  the same rows, and the global rank would give every tensor-parallel pair
  different data.
- ``replica_safe_concat`` (``mesh.py:47-65``) is left out: it steps around a
  replica-sum bug of jaxlib's SPMD concatenate, and ``torch.cat`` on a
  rank's own tensors has no such bug (as ``TorchLoader.superbatches`` says).

A :class:`Sharding` is the port's ``NamedSharding``: a mesh and a spec with
one entry a dim (an axis name, a tuple of them, or None), read in the
global shape's layout. :func:`device_shard_plan` maps every mesh coordinate
to its row range of the batch, as the JAX function maps devices.
"""

import numpy as np
import torch
import torch.distributed as dist

from petastorm_tpu_torch.device import resolve_device


def mesh_shape(axis_shapes, n_devices):
    """``{'axis': size}`` with ``-1`` filled from ``n_devices``, or the JAX
    function's ``ValueError`` (``mesh.py:136-158``)."""
    names = list(axis_shapes)
    sizes = list(axis_shapes.values())
    if sizes.count(-1) > 1:
        raise ValueError('At most one axis may be -1')
    known = int(np.prod([s for s in sizes if s != -1]))
    if n_devices % known:
        raise ValueError('{} devices not divisible by fixed axes {}'.format(
            n_devices, axis_shapes))
    sizes = [n_devices // known if s == -1 else s for s in sizes]
    if int(np.prod(sizes)) != n_devices:
        raise ValueError('Mesh {} does not cover {} devices'.format(
            dict(zip(names, sizes)), n_devices))
    return dict(zip(names, sizes))


def make_mesh(axis_shapes, device='cuda'):
    """A ``DeviceMesh`` over every rank of the default process group, from
    ``{'axis': size}`` (``-1`` fills with the remaining ranks), row-major
    as ``np.reshape`` lays out JAX's devices.

    The process group must be up (``init_process_group`` with ``nccl`` on
    the card, ``gloo`` with ``device='cpu'``): a mesh never starts one.
    ``device='cuda'`` (the default) raises without a GPU.
    """
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError('make_mesh needs an initialised process group: call '
                           'torch.distributed.init_process_group first')
    dev = resolve_device(device)
    shape = mesh_shape(axis_shapes, dist.get_world_size())
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dev.type, tuple(shape.values()), mesh_dim_names=tuple(shape))


def axis_names(axis):
    """``axis`` (a name, a tuple of names, or None) as a tuple of names."""
    if axis is None:
        return ()
    return (axis,) if isinstance(axis, str) else tuple(axis)


def has_axis(mesh, axis):
    return mesh is not None and all(a in (mesh.mesh_dim_names or ()) for a in axis_names(axis))


def axis_size(mesh, axis):
    """Ranks along ``axis`` (a name or a tuple of names; 1 for none)."""
    size = 1
    for a in axis_names(axis):
        size *= mesh.size(mesh.mesh_dim_names.index(a))
    return size


def axis_index(mesh, axis, coordinate=None):
    """This rank's (or ``coordinate``'s) index along ``axis``; a tuple of
    axes is row-major, as a ``PartitionSpec(('data', 'sp'))`` tiles."""
    if coordinate is None:
        coordinate = mesh.get_coordinate()
    index = 0
    for a in axis_names(axis):
        dim = mesh.mesh_dim_names.index(a)
        index = index * mesh.size(dim) + coordinate[dim]
    return index


def axis_group(mesh, axis):
    """The process group of this rank's peers along ``axis``; a tuple of
    axes is flattened into one group (the mesh makes it on first use,
    collectively, and keeps it: every rank must ask for the same tuples in
    the same order)."""
    axes = axis_names(axis)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


def process_shard(mesh=None, batch_axis='data'):
    """``(cur_shard, shard_count)`` for this rank's reader.

    With a ``mesh``: the rank's coordinate along ``batch_axis`` and its
    size, so the ranks of one data shard (tensor, sequence, expert or
    pipeline peers) read the same rows. Without one: ``(rank, world)`` of
    the default group, or ``(0, 1)`` with none.
    """
    if mesh is not None:
        if not has_axis(mesh, batch_axis):
            return 0, 1
        return axis_index(mesh, batch_axis), axis_size(mesh, batch_axis)
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Sharding(object):
    """The port's ``NamedSharding``: ``spec[d]`` names the mesh axis (or
    axes, row-major) that dim ``d`` of the global array is split over;
    missing or None entries are replicated."""

    __slots__ = ('mesh', 'spec')

    def __init__(self, mesh, spec=()):
        spec = tuple(spec)
        for entry in spec:
            for a in axis_names(entry):
                if a not in mesh.mesh_dim_names:
                    raise ValueError('axis {!r} is not in the mesh {}'.format(
                        a, mesh.mesh_dim_names))
        self.mesh = mesh
        self.spec = spec

    def axis_of(self, dim):
        return self.spec[dim] if dim < len(self.spec) else None

    def shard_dims(self):
        """The dims that are split, ``[(dim, axis), ...]``."""
        return [(d, a) for d, a in enumerate(self.spec) if axis_names(a)]

    def index(self, global_shape, coordinate=None):
        """``coordinate``'s (default this rank's) tile of ``global_shape``:
        a tuple of slices, or ``ValueError`` when a split dim does not
        divide."""
        out = []
        for dim, size in enumerate(global_shape):
            axis = self.axis_of(dim)
            n = axis_size(self.mesh, axis)
            if size % n:
                raise ValueError('dim {} of {} does not divide over {} = {}'.format(
                    dim, tuple(global_shape), axis, n))
            i = axis_index(self.mesh, axis, coordinate) if n > 1 else 0
            step = size // n
            out.append(slice(i * step, (i + 1) * step))
        return tuple(out)


def batch_sharding(mesh, batch_axes='data'):
    """The leading (batch) dim over ``batch_axes``, the rest replicated."""
    return Sharding(mesh, (axis_names(batch_axes),))


def replicated_sharding(mesh):
    return Sharding(mesh, ())


def sequence_sharding(mesh, batch_axis='data', seq_axis='model', seq_dim=1):
    """Batch dim over ``batch_axis``, dim ``seq_dim`` over ``seq_axis``: each
    rank holds a ``[B/dp, T/sp, ...]`` tile (the layout ring and all-to-all
    attention take). ``TorchLoader(..., sharding={'tokens':
    sequence_sharding(mesh, seq_axis='sp')})``."""
    if seq_dim < 1:
        raise ValueError('seq_dim must be >= 1 (0 is the batch dim)')
    spec = [None] * (seq_dim + 1)
    spec[0] = batch_axis
    spec[seq_dim] = seq_axis
    return Sharding(mesh, spec)


class DeviceShardPlan(object):
    """Per-rank row ranges of a batch-dim-sharded batch: mesh coordinate
    ``coordinates[k]`` (global rank ``ranks[k]``) holds rows
    ``bounds[k] = (start, stop)`` of ``global_shape``. Replicas (ranks that
    differ only on an axis the batch is not split over) share a bound."""

    __slots__ = ('coordinates', 'ranks', 'bounds', 'global_shape')

    def __init__(self, coordinates, ranks, bounds, global_shape):
        self.coordinates = tuple(coordinates)
        self.ranks = tuple(ranks)
        self.bounds = tuple(bounds)
        self.global_shape = tuple(global_shape)

    @property
    def n_devices(self):
        return len(self.ranks)


def device_shard_plan(sharding, local_shape, process_count=1):
    """The :class:`DeviceShardPlan` of one field, or ``None``
    (``mesh.py:68-133``).

    The global batch is ``local_shape[0] * process_count`` rows. Eligible:
    only the leading dim is split, and the distinct row ranges are equal
    and tile the global batch. A split non-batch dim (a sequence field),
    an uneven split, or ranges that do not tile return ``None``; the loader
    then cuts such a field by :meth:`Sharding.index`.
    """
    local_shape = tuple(local_shape)
    if not local_shape or local_shape[0] <= 0:
        return None
    global_shape = (local_shape[0] * int(process_count),) + local_shape[1:]
    if any(d > 0 for d, _ in sharding.shard_dims()):
        return None
    axis = sharding.axis_of(0)
    n = axis_size(sharding.mesh, axis)
    if global_shape[0] % n:
        return None
    rows = global_shape[0] // n
    mesh_ranks = sharding.mesh.mesh
    coordinates, ranks, bounds = [], [], []
    for coordinate in np.ndindex(*mesh_ranks.shape):
        i = axis_index(sharding.mesh, axis, coordinate) if n > 1 else 0
        coordinates.append(coordinate)
        ranks.append(int(mesh_ranks[coordinate]))
        bounds.append((i * rows, (i + 1) * rows))
    return DeviceShardPlan(coordinates, ranks, bounds, global_shape)


def local_device(mesh):
    """The ``torch.device`` this rank computes on."""
    if mesh.device_type == 'cuda':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device(mesh.device_type)
