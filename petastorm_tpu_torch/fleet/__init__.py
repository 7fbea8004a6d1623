"""The data service's fleet layer (counterpart of ``petastorm_tpu/fleet``):
:mod:`~petastorm_tpu_torch.fleet.control_plane` (leases, admission, drain,
typed refusals) and :mod:`~petastorm_tpu_torch.fleet.wire` (the negotiated
transport tiers). Import the submodules directly: this package re-exports
nothing, so importing it imports no zmq.
"""
