"""Build row-group indexes and store them in ``_common_metadata``
(counterpart of ``petastorm_tpu/etl/rowgroup_indexing.py``).

The indexes are JSON under ``petastorm_tpu.rowgroups_index.v1``, the JAX
package's key, so a store indexed by either package is selected by the
other's :mod:`~petastorm_tpu_torch.selectors`; the reference petastorm's
pickled indexes are read too. Row-groups are read on a
thread pool (no Spark) and indexed in order.
"""

import json
import logging
from concurrent.futures import ThreadPoolExecutor

import pyarrow.parquet as pq

from petastorm_tpu_torch.etl.dataset_metadata import get_schema
from petastorm_tpu_torch.storage import ROWGROUP_INDEX_KEY, ParquetStore

logger = logging.getLogger(__name__)


def build_rowgroup_index(dataset_url, indexers, storage_options=None, max_workers=10):
    """Index every row-group with ``indexers`` and store the payloads (merged
    into any the store holds). Returns the stored payload."""
    from petastorm_tpu_torch.py_dict_worker import decode_table_to_rows
    from petastorm_tpu_torch.workers.rowgroup_worker_base import with_partition_columns

    store = ParquetStore(dataset_url, storage_options)
    schema = get_schema(store)
    pieces = store.row_groups()
    needed = sorted({c for ix in indexers for c in ix.column_names})
    unknown = [c for c in needed if c not in schema.fields]
    if unknown:
        raise ValueError('Indexer columns not in schema: {}'.format(unknown))
    view = schema.create_schema_view(needed)
    partition_names = set(store.partition_names)
    physical = [c for c in needed if c not in partition_names]

    def read(item):
        piece_index, piece = item
        with store.open_file(piece.path) as f:
            table = pq.ParquetFile(f).read_row_group(piece.row_group, columns=physical)
        return piece_index, with_partition_columns(table, piece, needed)

    # Row-groups are read in parallel and indexed in order.
    with ThreadPoolExecutor(max_workers=max(1, min(max_workers, len(pieces)))) as pool:
        for piece_index, table in pool.map(read, enumerate(pieces)):
            rows = decode_table_to_rows(table, view)
            for indexer in indexers:
                indexer.build_index(rows, piece_index)
    payload = {ix.index_name: ix.to_json_payload() for ix in indexers}
    existing = store.common_metadata_value(ROWGROUP_INDEX_KEY)
    if existing is not None:
        merged = json.loads(existing.decode('utf-8'))
        merged.update(payload)
        payload = merged
    store.write_common_metadata(store.read_arrow_schema(),
                                {ROWGROUP_INDEX_KEY: json.dumps(payload)})
    logger.info('Stored %d row-group indexes over %d pieces', len(payload), len(pieces))
    return payload


def get_row_group_indexes(dataset_url_or_store, storage_options=None):
    """The stored payload ``{index_name: {'type', 'field', 'values'}}``; a
    store of the reference petastorm's pickled indexes is read through
    :mod:`~petastorm_tpu_torch.etl.legacy`."""
    store = (dataset_url_or_store if isinstance(dataset_url_or_store, ParquetStore)
             else ParquetStore(dataset_url_or_store, storage_options))
    blob = store.common_metadata_value(ROWGROUP_INDEX_KEY)
    if blob is None:
        from petastorm_tpu_torch.etl.legacy import (LEGACY_ROWGROUP_INDEX_KEY,
                                                    load_legacy_row_group_indexes)
        legacy_blob = store.common_metadata_value(LEGACY_ROWGROUP_INDEX_KEY)
        if legacy_blob is not None:
            return load_legacy_row_group_indexes(legacy_blob)
        raise ValueError('Dataset {} has no row-group index; run build_rowgroup_index '
                         'first'.format(store.url))
    return json.loads(blob.decode('utf-8'))
