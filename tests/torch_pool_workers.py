"""Workers of the port's process-pool tests, pickled by reference into
spawned worker processes. This module imports only numpy, pyarrow and the
port's worker tier, so those processes start without torch or JAX."""

import os
import sys
import time

import numpy as np
import pyarrow as pa

from petastorm_tpu_torch.workers import WorkerBase


class EchoWorker(WorkerBase):
    def process(self, value):
        self.publish_func([value * 2])


class GatedEchoWorker(WorkerBase):
    """Echoes item 0 at once and holds every other item until the gate file
    (its worker args) exists, for at most a minute: a worker killed while
    the gate is shut dies with items in flight."""

    def process(self, value):
        deadline = time.monotonic() + 60
        while value and not os.path.exists(self.args) and time.monotonic() < deadline:
            time.sleep(0.01)
        self.publish_func([value * 2])


class BigBlobWorker(WorkerBase):
    """Payloads far larger than a small result ring: one in-band bytes
    object and one out-of-band array."""

    def process(self, value):
        self.publish_func({'blob': bytes([value % 256]) * (3 << 20), 'value': value,
                           'array': np.full((1 << 20,), value, dtype=np.int32)})


class FailingWorker(WorkerBase):
    def process(self, value):
        raise ValueError('boom {}'.format(value))


class TableWorker(WorkerBase):
    """Publishes Arrow tables (the payload of ``ArrowTableSerializer``)."""

    def process(self, value):
        self.publish_func(pa.table({'value': [value] * 4, 'name': ['v{}'.format(value)] * 4}))


class ProbeWorker(WorkerBase):
    """Imports the reader's worker tier as a reader's worker does, then
    reports what its process has loaded and may reach."""

    def process(self, value):
        import petastorm_tpu_torch.arrow_worker  # noqa: F401
        import petastorm_tpu_torch.py_dict_worker  # noqa: F401
        import petastorm_tpu_torch.reader  # noqa: F401
        import petastorm_tpu_torch.tensor_worker  # noqa: F401
        self.publish_func({'value': value, 'pid': os.getpid(),
                           'torch': 'torch' in sys.modules,
                           'jax': 'jax' in sys.modules,
                           'cuda_visible_devices': os.environ.get('CUDA_VISIBLE_DEVICES')})
