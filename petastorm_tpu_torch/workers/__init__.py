"""Worker pools: ventilator-fed parallel execution with a bounded results
queue (counterpart of ``petastorm_tpu/workers/__init__.py``): threads
(``thread_pool``), the consumer's own thread (``dummy_pool``), and worker
processes over zmq sockets (``process_pool``) or shared-memory rings
(``shm_process_pool``), supervised and respawned (``supervision``).

A worker may quarantine a poison row-group, when the reader has an
``error_budget``: instead of ending the epoch it publishes a
:class:`RowGroupQuarantined` record, which counts as the item's processed
ack, and the pool hands it to its ``quarantine_sink`` (the reader's
budget), which raises ``RowGroupQuarantinedError`` once the budget is spent.
"""


class EmptyResultError(Exception):
    """Raised by ``pool.get_results()`` when all work is done."""


class TimeoutWaitingForResultError(Exception):
    """``pool.get_results(timeout=...)`` saw no result in time; the message
    names the workers and the items in flight."""


class VentilatedItemProcessedMessage(object):
    """Sentinel a worker publishes after fully processing one ventilated item.

    ``worker_id``/``seq`` say which worker finished which dispatched item
    (the process pools' supervision, :mod:`~petastorm_tpu_torch.workers.
    supervision`); ``None`` from the in-process pools."""

    def __init__(self, worker_id=None, seq=None):
        self.worker_id = worker_id
        self.seq = seq


class RowGroupQuarantined(object):
    """A worker skipped a poison ventilated item (``petastorm_tpu/workers/
    __init__.py:37-71``).

    ``item`` is a JSON-safe summary of the item's arguments
    (``piece_index``, ``shuffle_row_drop_partition`` and, in deterministic
    mode, ``pst_det``); ``decode_error`` is the native codec's own error
    string when the failure came out of the C++ batch decode
    (``DecodeFieldError.native_error``)."""

    def __init__(self, worker_id, item, error, traceback_str, seq=None, decode_error=None):
        self.worker_id = worker_id
        self.item = item
        self.error = error
        self.traceback_str = traceback_str
        self.seq = seq
        self.decode_error = decode_error


def _summarize_item(args, kwargs):
    """JSON-safe description of a ventilated item."""
    summary = {}
    if isinstance(kwargs, dict):
        for key in ('piece_index', 'shuffle_row_drop_partition'):
            value = kwargs.get(key)
            if isinstance(value, (int, str)) or (
                    isinstance(value, tuple) and all(isinstance(v, int) for v in value)):
                summary[key] = value
        det = kwargs.get('pst_det')
        if isinstance(det, dict):
            # The resequencer fills the item's sequence hole by its seq.
            summary['pst_det'] = {k: det.get(k) for k in ('seq', 'epoch', 'pos')}
    if not summary and args:
        summary['args'] = repr(args)[:120]
    return summary


def quarantine_record_for(worker, exc, args, kwargs):
    """The :class:`RowGroupQuarantined` of this failure, or None when it
    must surface (the reader has no budget, or the exception is not a data
    or IO failure)."""
    worker_args = getattr(worker, 'args', None)
    if not (isinstance(worker_args, dict) and worker_args.get('quarantine_poison_rowgroups')):
        return None
    from petastorm_tpu_torch.errors import QUARANTINE_EXCEPTION_TYPES
    if not isinstance(exc, QUARANTINE_EXCEPTION_TYPES):
        return None
    import traceback
    return RowGroupQuarantined(worker_id=getattr(worker, 'worker_id', None),
                               item=_summarize_item(args, kwargs),
                               error='{}: {}'.format(type(exc).__name__, exc),
                               traceback_str=traceback.format_exc(),
                               decode_error=getattr(exc, 'native_error', None))


def deliver_quarantine(pool, record):
    """Hand a record to the pool's sink; raise when there is none (a worker
    quarantined something the consumer never opted into)."""
    sink = getattr(pool, 'quarantine_sink', None)
    if sink is None:
        from petastorm_tpu_torch.errors import RowGroupQuarantinedError
        raise RowGroupQuarantinedError(
            'worker {} quarantined {} ({}) but no quarantine sink/error budget is '
            'configured'.format(record.worker_id, record.item, record.error),
            quarantined=[record])
    sink(record)


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
