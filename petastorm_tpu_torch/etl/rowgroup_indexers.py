"""Row-group indexers: value -> row-group maps, stored as JSON (counterpart
of ``petastorm_tpu/etl/rowgroup_indexers.py``). The payloads are the JAX
package's, so a store indexed by either package serves the other's
selectors."""

from petastorm_tpu_torch.etl import RowGroupIndexerBase


class SingleFieldIndexer(RowGroupIndexerBase):
    """Maps every value of one field to the row-groups that hold it."""

    def __init__(self, index_name, index_field):
        self._index_name = index_name
        self._field_name = index_field
        self._values = {}

    @property
    def index_name(self):
        return self._index_name

    @property
    def column_names(self):
        return [self._field_name]

    @property
    def indexed_values(self):
        return sorted(self._values)

    def get_row_group_indexes(self, value_key):
        return sorted(self._values.get(str(value_key), ()))

    def build_index(self, decoded_rows, piece_index):
        for row in decoded_rows:
            value = row.get(self._field_name)
            if value is not None:
                self._values.setdefault(str(value), set()).add(piece_index)

    def __add__(self, other):
        if other.index_name != self.index_name:
            raise ValueError('Cannot merge indexers of different indexes')
        for value, pieces in other._values.items():
            self._values.setdefault(value, set()).update(pieces)
        return self

    def to_json_payload(self):
        return {'type': 'single_field', 'field': self._field_name,
                'values': {v: sorted(ids) for v, ids in self._values.items()}}


class SingleFieldRowIndexer(RowGroupIndexerBase):
    """Maps every value of one field to ``[(row-group ordinal, row offset)]``:
    a point read can then slice its rows out of a decoded row-group. The
    selectors read a pair's first element as the row-group ordinal."""

    def __init__(self, index_name, index_field):
        self._index_name = index_name
        self._field_name = index_field
        self._values = {}

    @property
    def index_name(self):
        return self._index_name

    @property
    def column_names(self):
        return [self._field_name]

    @property
    def indexed_values(self):
        return sorted(self._values)

    def get_row_group_indexes(self, value_key):
        return sorted({piece for piece, _ in self._values.get(str(value_key), ())})

    def get_row_locations(self, value_key):
        """``[(piece_index, row_offset)]`` of every row holding the value."""
        return sorted(self._values.get(str(value_key), ()))

    def build_index(self, decoded_rows, piece_index):
        for offset, row in enumerate(decoded_rows):
            value = row.get(self._field_name)
            if value is not None:
                self._values.setdefault(str(value), []).append((piece_index, offset))

    def __add__(self, other):
        if other.index_name != self.index_name:
            raise ValueError('Cannot merge indexers of different indexes')
        for value, locations in other._values.items():
            self._values.setdefault(value, []).extend(locations)
        return self

    def to_json_payload(self):
        return {'type': 'single_field_rows', 'field': self._field_name,
                'values': {v: [list(loc) for loc in sorted(locs)]
                           for v, locs in self._values.items()}}


class FieldNotNullIndexer(RowGroupIndexerBase):
    """The row-groups holding at least one non-null value of a field."""

    _KEY = 'not_null'

    def __init__(self, index_name, index_field):
        self._index_name = index_name
        self._field_name = index_field
        self._pieces = set()

    @property
    def index_name(self):
        return self._index_name

    @property
    def column_names(self):
        return [self._field_name]

    @property
    def indexed_values(self):
        return [self._KEY]

    def get_row_group_indexes(self, value_key=None):
        return sorted(self._pieces)

    def build_index(self, decoded_rows, piece_index):
        if any(row.get(self._field_name) is not None for row in decoded_rows):
            self._pieces.add(piece_index)

    def __add__(self, other):
        if other.index_name != self.index_name:
            raise ValueError('Cannot merge indexers of different indexes')
        self._pieces.update(other._pieces)
        return self

    def to_json_payload(self):
        return {'type': 'field_not_null', 'field': self._field_name,
                'values': {self._KEY: sorted(self._pieces)}}
