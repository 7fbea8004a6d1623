"""Stored-schema access (counterpart of ``petastorm_tpu/etl/dataset_metadata.py:31-53``).

The schema lives as JSON under ``petastorm_tpu.unischema.v1`` in the
store's ``_common_metadata``, the key the JAX package writes and reads.
"""

import json
import os

from petastorm_tpu_torch.errors import PetastormMetadataError
from petastorm_tpu_torch.storage import UNISCHEMA_KEY
from petastorm_tpu_torch.unischema import Unischema


def get_schema(store):
    """The Unischema stored in ``_common_metadata``; raises if absent."""
    blob = store.common_metadata_value(UNISCHEMA_KEY)
    if blob is None:
        if not os.path.exists(store.path):
            raise IOError('Dataset path does not exist: {}'.format(store.url))
        raise PetastormMetadataError(
            'Dataset at {} has no petastorm_tpu schema metadata; write it with '
            'DatasetWriter/write_dataset'.format(store.url))
    return Unischema.from_json(json.loads(blob.decode('utf-8')))

