"""Multi-GPU: device meshes, the written-out collectives, the pod guard,
and a launcher for CPU runs of the ranks (counterpart of
``petastorm_tpu/parallel``)."""

from petastorm_tpu_torch.parallel.mesh import (DeviceShardPlan, Sharding,  # noqa: F401
                                               batch_sharding, device_shard_plan, make_mesh,
                                               process_shard, replicated_sharding,
                                               sequence_sharding)
from petastorm_tpu_torch.parallel.pod_guard import (PodAbortError, PodSafeIterator,  # noqa: F401
                                                    global_all)
