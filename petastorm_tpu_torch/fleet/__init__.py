"""The data service's fleet layer (counterpart of ``petastorm_tpu/fleet``):

* :mod:`~petastorm_tpu_torch.fleet.control_plane`: leases, admission,
  drain and typed refusals, shared by the data service and the lookup
  tier;
* :mod:`~petastorm_tpu_torch.fleet.wire`: the negotiated transport tiers;
* :mod:`~petastorm_tpu_torch.fleet.registry`: per-job membership built
  from the heartbeat stream;
* :mod:`~petastorm_tpu_torch.fleet.tenancy`: per-tenant consumer caps,
  credit partitions, memory sub-pools and SLO metrics;
* :mod:`~petastorm_tpu_torch.fleet.autoscaler`: the drain-first control
  loop that grows and shrinks a job's worker set.

Import the submodules directly: this package re-exports nothing, so
importing it imports no zmq.
"""
