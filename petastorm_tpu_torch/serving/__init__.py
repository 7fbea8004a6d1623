"""The online lookup tier: point reads over the training cache
(counterpart of ``petastorm_tpu/serving``).

* :mod:`~petastorm_tpu_torch.serving.row_index`: the row-level key index a
  ``SingleFieldRowIndexer`` pass stored, key value -> ``(row-group,
  row offset)`` locations.
* :mod:`~petastorm_tpu_torch.serving.engine`: :class:`LookupEngine`, the
  local request path: ``lookup(keys)`` / ``query(predicate, selector)``
  served from a block LRU, then the ``DecodedChunkStore`` mmap tier under
  the training readers' own ``tensor_chunk_key``, then a decode, with the
  cold fetches of one row-group coalesced.
* :mod:`~petastorm_tpu_torch.serving.placement`: :class:`PartitionMap`,
  the versioned consistent-hash placement of the key space over a
  replicated fleet, a pure function of the membership set.
* :mod:`~petastorm_tpu_torch.serving.server` /
  :mod:`~petastorm_tpu_torch.serving.client`: the service plane over zmq
  (leases, drain, admission with typed refusals, the partition map in the
  heartbeats, the warm join over the ``chunk`` verb) and the fleet-aware
  client (failover, circuit breakers, hedged reads, scatter-gather).

The verbs, heartbeats, map bytes and metric names are the JAX package's:
a client of one package reads from a server of the other. Threads are
``pstt-lookup-*`` and ``pstt-fleet-scatter-*``. Importing this package
imports no torch (nor zmq, until a server or client is built).

Smoke-test without writing code::

    python -m petastorm_tpu_torch.tools.lookup --dataset-url URL \\
        --key id=7 [--build-index] [--store DIR] [--serve]
"""

from petastorm_tpu_torch.serving.client import LookupClient  # noqa: F401
from petastorm_tpu_torch.serving.engine import LookupEngine  # noqa: F401
from petastorm_tpu_torch.serving.placement import (  # noqa: F401
    PartitionMap, build_partition_map)
from petastorm_tpu_torch.serving.row_index import RowLocationIndex  # noqa: F401
from petastorm_tpu_torch.serving.server import LookupServer  # noqa: F401
