"""Row-level key index: load and resolve ``value -> (row-group, offset)``
(counterpart of ``petastorm_tpu/serving/row_index.py``).

The build side lives in the existing indexer pass
(``etl.rowgroup_indexers.SingleFieldRowIndexer`` run through
``etl.rowgroup_indexing.build_rowgroup_index``); this module is the read
side: pick the row-level payload out of the stored index blob
(``get_row_group_indexes``) and answer point resolutions in O(1).
"""

import logging

logger = logging.getLogger(__name__)

#: Payload ``type`` tag written by ``SingleFieldRowIndexer``.
ROW_INDEX_TYPE = 'single_field_rows'


class RowLocationIndex(object):
    """One loaded row-level index: key value -> row locations.

    :param name: the index name it was stored under.
    :param payload: the stored JSON payload
        (``{'type', 'field', 'values'}``).
    """

    def __init__(self, name, payload):
        if payload.get('type') != ROW_INDEX_TYPE:
            raise ValueError(
                'index {!r} is type {!r}, not a row-level index (build it '
                'with SingleFieldRowIndexer)'.format(
                    name, payload.get('type')))
        self.name = name
        self.field = payload['field']
        # JSON round-trips pairs as lists; normalize to tuples once so
        # lookups hand out hashable, immutable locations.
        self._values = {value: [tuple(loc) for loc in locations]
                        for value, locations in payload['values'].items()}

    @classmethod
    def load(cls, dataset_url_or_store, index_name=None,
             storage_options=None):
        """Load the row-level index from a dataset's stored index blob.

        ``index_name=None`` auto-selects when exactly one row-level index
        exists; several (or none) raise with the available names so the
        caller can disambiguate.
        """
        from petastorm_tpu_torch.etl.rowgroup_indexing import get_row_group_indexes
        payload = get_row_group_indexes(dataset_url_or_store,
                                        storage_options=storage_options)
        if index_name is not None:
            if index_name not in payload:
                raise ValueError('Index {!r} not found; available: {}'.format(
                    index_name, sorted(payload)))
            return cls(index_name, payload[index_name])
        row_level = {name: p for name, p in payload.items()
                     if p.get('type') == ROW_INDEX_TYPE}
        if len(row_level) != 1:
            raise ValueError(
                'expected exactly one row-level index, found {} (stored '
                'indexes: {}); pass index_name= or build one with '
                'SingleFieldRowIndexer'.format(
                    sorted(row_level) or 'none',
                    {name: p.get('type') for name, p in payload.items()}))
        name, p = next(iter(row_level.items()))
        return cls(name, p)

    def locations(self, value):
        """``[(piece_index, row_offset)]`` for ``value`` (dataset order);
        empty when the key is absent. Values are matched by their string
        form — the JSON payload stores string keys, same as the
        row-group-level indexes."""
        return list(self._values.get(str(value), ()))

    def __contains__(self, value):
        return str(value) in self._values

    def __len__(self):
        return len(self._values)

    def keys(self):
        return self._values.keys()
