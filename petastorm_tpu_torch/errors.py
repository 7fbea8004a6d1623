"""Exception types of the port (counterpart of ``petastorm_tpu/errors.py``,
trimmed to what the port raises)."""


class PetastormTorchError(Exception):
    """Base class of the port's own errors."""


class SchemaError(PetastormTorchError, ValueError):
    """A schema, field pattern or codec spec is invalid."""


class DecodeFieldError(PetastormTorchError):
    """A stored cell could not be decoded into its field's shape/dtype."""


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
    biggest first); ``budget``/``accounted`` are the bytes of the breach.
    """

    def __init__(self, message, budget=None, accounted=None, ranking=None):
        super(HostMemoryExceededError, self).__init__(message)
        self.budget = budget
        self.accounted = accounted
        self.ranking = list(ranking or [])
