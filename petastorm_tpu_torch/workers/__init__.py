"""Worker pools: ventilator-fed parallel execution with a bounded results
queue (counterpart of ``petastorm_tpu/workers/__init__.py``)."""


class EmptyResultError(Exception):
    """Raised by ``pool.get_results()`` when all work is done."""


class VentilatedItemProcessedMessage(object):
    """Sentinel a worker publishes after fully processing one ventilated item."""


class WorkerBase(object):
    """A worker: ``process(**item)`` publishes results via ``publish_func``."""

    def __init__(self, worker_id, publish_func, args):
        self.worker_id = worker_id
        self.publish_func = publish_func
        self.args = args

    def process(self, *args, **kwargs):
        raise NotImplementedError

    def shutdown(self):
        """Called when the pool stops."""
