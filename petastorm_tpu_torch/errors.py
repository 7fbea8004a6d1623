"""Exception types of the port (counterpart of ``petastorm_tpu/errors.py``,
trimmed to what the reader slice raises)."""


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
