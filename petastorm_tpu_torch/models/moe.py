"""Switch-style Mixture-of-Experts MLP on one GPU (counterpart of
``petastorm_tpu/models/moe.py:34-114``).

Top-1 routing as dense one-hot dispatch and combine products (GShard /
Switch): every op is a static-shaped product or elementwise pass, so the
layer captures into a CUDA graph. Routing is per group (one group per
batch row); each expert has ``capacity`` slots a group, and the tokens
past them drop: their expert contribution is zero and the block's residual
carries them. No product here is a Pallas kernel in the JAX package, so
they stay ``torch.einsum`` / ``torch.matmul``.

Expert parallelism (``mesh``, ``expert_axis``; the weights split by
:func:`expert_param_spec`): each rank holds ``E/n`` experts and its own
groups (the batch is split over the expert axis too). Routing stays
group-local; the dispatched ``expert_in [E, G, C, d]`` goes to the expert
ranks by an explicit ``all_to_all`` (what XLA derives from the JAX
layer's sharding constraint, ``moe.py:87-94``), the local experts run on
every rank's groups, and a second ``all_to_all`` brings the outputs back.
The load-balance statistics are summed over the axes the groups are split
over, so the loss is the one of the whole batch.

Parity with flax, hazard by hazard:

- Capacity is ``max(1, int(-(-S * capacity_factor // E)))``, a float floor
  division, copied as written (320 at S 1024, E 4, factor 1.25).
- The router is an f32 Dense with a bias: product, then bias, in f32.
  ``argmax`` takes the first of equal maxima in both frameworks.
- The load-balance loss reads the routing mask before the capacity cut;
  only the mean router probability carries a gradient.
- An overflow token's slot index is at or past the capacity, where
  ``jax.nn.one_hot`` gives a zero row and ``F.one_hot`` raises (an assert
  on the card): the slot one-hot here is a comparison with ``arange(C)``.
- Dispatch and combine are f32 products; the experts run in the compute
  type. Expert weights keep flax's ``[E, d, h]`` / ``[E, h, d]`` layout.

The counterpart of ``sow('intermediates', 'aux_loss', ...)``: each layer
keeps the loss of its latest forward in ``aux_loss`` (a tensor, inside a
captured graph too), and :func:`moe_aux_loss` sums them over a model.
"""

import torch
import torch.nn.functional as F
from torch import nn

from petastorm_tpu_torch.parallel import collectives
from petastorm_tpu_torch.parallel.mesh import axis_group, axis_size
from petastorm_tpu_torch.parallel.tensor_parallel import param_spec


def _one_hot(index, n):
    """f32 one-hot of ``index`` over ``n`` classes; an index outside
    ``[0, n)`` gives a zero row (as ``jax.nn.one_hot``)."""
    return (index[..., None] == torch.arange(n, device=index.device)).float()


class SwitchMoE(nn.Module):
    """Top-1 routed expert MLP: ``[G, S, d] -> [G, S, d]`` in ``dtype``."""

    def __init__(self, d_model, num_experts, mlp_ratio=4, capacity_factor=1.25,
                 dtype=torch.bfloat16, mesh=None, expert_axis=None, batch_axes=()):
        super().__init__()
        if num_experts < 1:
            raise ValueError('num_experts must be >= 1, got {}'.format(num_experts))
        self.mesh = mesh
        self.expert_axis = expert_axis
        # The axes this rank's groups are a share of (statistics sum over them).
        self.batch_axes = tuple(a for a in batch_axes if axis_size(mesh, a) > 1) if mesh else ()
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        hidden = mlp_ratio * d_model
        self.router = nn.Linear(d_model, num_experts)
        self.w_up = nn.Parameter(torch.empty(num_experts, d_model, hidden))
        self.w_down = nn.Parameter(torch.empty(num_experts, hidden, d_model))
        nn.init.normal_(self.w_up, std=d_model ** -0.5)
        nn.init.normal_(self.w_down, std=hidden ** -0.5)
        self.aux_loss = None

    def capacity(self, tokens):
        return max(1, int(-(-tokens * self.capacity_factor // self.num_experts)))

    def forward(self, x):
        _, s, _ = x.shape
        e, capacity = self.num_experts, self.capacity(s)
        xf = x.float()
        logits = torch.matmul(xf, self.router.weight.t()) + self.router.bias    # [G, S, E]
        probs = torch.softmax(logits, dim=-1)
        expert_prob, expert_idx = probs.max(dim=-1)
        expert_mask = _one_hot(expert_idx, e)
        # Switch load-balance loss: E * sum_e(frac_tokens_e * mean_prob_e),
        # the mask taken before the capacity cut.
        frac, mean_prob = expert_mask.mean(dim=(0, 1)), probs.mean(dim=(0, 1))
        if self.batch_axes:
            group = axis_group(self.mesh, self.batch_axes)
            n = axis_size(self.mesh, self.batch_axes)
            stats = collectives.all_reduce_sum(torch.stack((frac, mean_prob)), group) / n
            frac, mean_prob = stats[0], stats[1]
        self.aux_loss = e * torch.sum(frac * mean_prob)

        position_in_expert = (torch.cumsum(expert_mask, dim=1) - 1.0) * expert_mask
        expert_mask = expert_mask * (position_in_expert < capacity)
        gate = expert_prob[..., None] * expert_mask                             # [G, S, E]
        slot = _one_hot(position_in_expert.sum(dim=-1).to(torch.int32), capacity)
        dispatch = expert_mask[..., None] * slot[:, :, None, :]                 # [G, S, E, C]
        combine = gate[..., None] * slot[:, :, None, :]

        expert_in = torch.einsum('gsec,gsd->egcd', dispatch, xf).to(self.dtype)
        split = param_spec(self, 'w_up')
        if split is not None:
            expert_in = self._to_experts(expert_in, axis_group(self.mesh, split[0]))
        h = torch.einsum('egcd,edh->egch', expert_in, self.w_up.to(self.dtype))
        h = F.gelu(h, approximate='tanh')
        expert_out = torch.einsum('egch,ehd->egcd', h, self.w_down.to(self.dtype))
        if split is not None:
            expert_out = self._from_experts(expert_out, axis_group(self.mesh, split[0]))
        out = torch.einsum('gsec,egcd->gsd', combine, expert_out.float())
        return out.to(self.dtype)

    @staticmethod
    def _to_experts(expert_in, group):
        """``[E, G, C, d]`` of this rank's groups -> ``[E/n, n*G, C, d]``:
        every rank's groups (rank-major) for this rank's experts."""
        n = collectives.group_size(group)
        e, g, c, d = expert_in.shape
        received = collectives.all_to_all(expert_in.reshape(n, e // n, g, c, d), group)
        return received.permute(1, 0, 2, 3, 4).reshape(e // n, n * g, c, d)

    @staticmethod
    def _from_experts(expert_out, group):
        """The inverse: ``[E/n, n*G, C, d]`` -> ``[E, G, C, d]``."""
        n = collectives.group_size(group)
        e_local, ng, c, d = expert_out.shape
        chunks = expert_out.reshape(e_local, n, ng // n, c, d).permute(1, 0, 2, 3, 4)
        return collectives.all_to_all(chunks, group).reshape(n * e_local, ng // n, c, d)


def expert_param_spec(name, param, mesh, module=None):
    """Expert weights (``w_up [E, d, h]``, ``w_down [E, h, d]``) split over
    ``'expert'`` on dim 0 when E divides; every other parameter as
    :func:`~petastorm_tpu_torch.models.train.transformer_param_spec`
    (``moe.py:117-128``)."""
    from petastorm_tpu_torch.models.train import transformer_param_spec
    if (mesh is not None and 'expert' in (mesh.mesh_dim_names or ())
            and name.rsplit('.', 1)[-1] in ('w_up', 'w_down')
            and param.shape[0] % axis_size(mesh, 'expert') == 0):
        return ('expert', None, None)
    return transformer_param_spec(name, param, mesh, module)


def moe_aux_loss(model):
    """The sum of the load-balance losses of ``model``'s :class:`SwitchMoE`
    layers from their latest forward, or None for a model without experts
    (the counterpart of ``sum(tree_leaves(mods['intermediates']))``)."""
    losses = [m.aux_loss for m in model.modules() if isinstance(m, SwitchMoE)]
    if not losses:
        return None
    if any(loss is None for loss in losses):
        raise ValueError('a SwitchMoE layer has not run a forward yet')
    return torch.stack(losses).sum()
