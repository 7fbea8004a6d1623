"""Dataset writing, stored-schema access and inference, row-group indexing."""

from petastorm_tpu_torch.etl.dataset_metadata import (get_schema,  # noqa: F401
                                                      get_schema_from_dataset_url,
                                                      infer_or_load_unischema,
                                                      materialize_dataset)
from petastorm_tpu_torch.etl.writer import DatasetWriter, write_dataset  # noqa: F401


class RowGroupIndexerBase(object):
    """A row-group index builder (``petastorm_tpu/etl/__init__.py``):
    :func:`~petastorm_tpu_torch.etl.rowgroup_indexing.build_rowgroup_index`
    hands it each row-group's decoded rows and stores its JSON payload."""

    @property
    def index_name(self):
        raise NotImplementedError

    @property
    def column_names(self):
        raise NotImplementedError

    @property
    def indexed_values(self):
        raise NotImplementedError

    def get_row_group_indexes(self, value_key):
        raise NotImplementedError

    def build_index(self, decoded_rows, piece_index):
        raise NotImplementedError
