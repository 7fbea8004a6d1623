"""Dataset writing and stored-schema access."""

from petastorm_tpu_torch.etl.dataset_metadata import get_schema  # noqa: F401
from petastorm_tpu_torch.etl.writer import DatasetWriter, write_dataset  # noqa: F401
