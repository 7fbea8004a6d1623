"""Exception types of the port (counterpart of ``petastorm_tpu/errors.py``,
trimmed to what the port raises)."""


class PetastormTorchError(Exception):
    """Base class of the port's own errors."""


class SchemaError(PetastormTorchError, ValueError):
    """A schema, field pattern or codec spec is invalid."""


class DecodeFieldError(PetastormTorchError):
    """A stored cell could not be decoded into its field's shape/dtype.

    ``native_error`` is the native codec's own error string (for example
    ``'not a JPEG or PNG stream'``) when the failure came out of the C++
    batch decode, else None."""

    def __init__(self, message, native_error=None):
        super().__init__(message)
        self.native_error = native_error


class WorkerLostError(PetastormTorchError):
    """A process-pool worker died and the pool's restart budget is spent
    (``petastorm_tpu/errors.py:13``); the message names the workers'
    states and the items that were in flight."""


class ServerOverloaded(PetastormTorchError):
    """Every data-service server refused this consumer's attach: at its
    ``max_consumers`` capacity, shedding under memory pressure, or draining
    (``petastorm_tpu/errors.py:140``). ``endpoint`` names a refusing rpc
    endpoint; ``reason`` is the server's refusal (``overloaded`` /
    ``draining`` / ``drained``)."""

    def __init__(self, message, endpoint=None, reason=None):
        super(ServerOverloaded, self).__init__(message)
        self.endpoint = endpoint
        self.reason = reason


class RowGroupQuarantinedError(PetastormTorchError):
    """Poison row-group failures went past the reader's ``error_budget``.

    ``quarantined`` holds the records gathered before the budget ran out
    (``Reader.diagnostics()['quarantined_rowgroups']`` has them while the
    budget holds)."""

    def __init__(self, message, quarantined=None):
        super(RowGroupQuarantinedError, self).__init__(message)
        self.quarantined = list(quarantined or [])


class NoDataAvailableError(PetastormTorchError):
    """Filtering or sharding left a reader with no row-groups."""


class PetastormMetadataError(PetastormTorchError):
    """The store carries no petastorm_tpu schema metadata."""


class CorruptChunkError(PetastormTorchError):
    """A persisted decoded chunk (a ``chunk_store.DecodedChunkStore`` entry or
    a ``LocalDiskCache`` raw-layout blob) failed its magic, structure or
    CRC32 check. The caches quarantine the bytes and refill by decoding
    again; this error does not cross ``cache.get``."""


class HostMemoryExceededError(PetastormTorchError):
    """The host memory governor (``petastorm_tpu_torch.membudget``) saw the
    accounted bytes reach its budget after the whole ladder (advisory,
    degrade, shed). Raised in the consumer instead of letting the kernel's
    OOM killer end the process without a word.

    ``ranking`` is the per-pool byte ranking (``[{'pool', 'nbytes'}, ...]``,
    biggest first); ``budget``/``accounted`` are the bytes of the breach;
    ``flight_dump`` the flight-recorder dump's directory (``None`` when even
    its creation failed).
    """

    def __init__(self, message, budget=None, accounted=None, ranking=None, flight_dump=None):
        super(HostMemoryExceededError, self).__init__(message)
        self.budget = budget
        self.accounted = accounted
        self.ranking = list(ranking or [])
        self.flight_dump = flight_dump


class PipelineStallError(PetastormTorchError):
    """The health watchdog (:mod:`petastorm_tpu_torch.health`) diagnosed a
    stalled pipeline stage and its soft recovery did not clear it
    (``petastorm_tpu/errors.py:105-116``).

    The message names the stage and the classification and holds the
    all-thread stack dump; ``diagnosis`` is the structured report
    (classification, stage, detail, the last-beat table, probe snapshots,
    stacks and, with a flight recorder, ``flight_dump``)."""

    def __init__(self, message, diagnosis=None):
        super(PipelineStallError, self).__init__(message)
        self.diagnosis = diagnosis or {}


#: Failures a worker may quarantine (skip the row-group and record it)
#: instead of ending the epoch, when the reader has an ``error_budget``:
#: data and IO problems; a programming error (TypeError, KeyError, ...)
#: always surfaces.
QUARANTINE_EXCEPTION_TYPES = (DecodeFieldError, IOError, OSError)
