"""Row-group selectors: choose row-groups through a stored index
(counterpart of ``petastorm_tpu/selectors.py``).

A selector reads the index payload that
:func:`~petastorm_tpu_torch.etl.rowgroup_indexing.build_rowgroup_index` (or
the JAX package's) stored in ``_common_metadata`` and returns row-group
ordinals. Both index granularities compose: row-group-level entries
(``SingleFieldIndexer``: value -> ordinals) and row-level ones
(``SingleFieldRowIndexer``: value -> ``[piece, offset]`` pairs), which
:func:`entry_row_groups` reduces to ordinals.
"""


def entry_row_groups(entries):
    """Row-group ordinals of one index value's entries: plain ints or
    ``[piece, row_offset]`` pairs."""
    return {entry[0] if isinstance(entry, (list, tuple)) else entry for entry in entries}


class RowGroupSelectorBase(object):
    def get_index_names(self):
        raise NotImplementedError

    def select_row_groups(self, indexes):
        """``indexes``: the stored payload ``{index_name: {'values': {...}}}``;
        returns a set of row-group ordinals."""
        raise NotImplementedError


class SingleIndexSelector(RowGroupSelectorBase):
    """The row-groups holding any of ``values_list`` in one index."""

    def __init__(self, index_name, values_list):
        self._index_name = index_name
        self._values = list(values_list)

    def get_index_names(self):
        return [self._index_name]

    def select_row_groups(self, indexes):
        if self._index_name not in indexes:
            raise ValueError('Index {!r} not found; available: {}'.format(
                self._index_name, sorted(indexes)))
        value_map = indexes[self._index_name]['values']
        selected = set()
        for value in self._values:
            selected |= entry_row_groups(value_map.get(str(value), ()))
        return selected


class IntersectIndexSelector(RowGroupSelectorBase):
    """The row-groups every selector picks."""

    def __init__(self, selectors):
        self._selectors = list(selectors)

    def get_index_names(self):
        return sorted({n for s in self._selectors for n in s.get_index_names()})

    def select_row_groups(self, indexes):
        result = None
        for selector in self._selectors:
            picked = selector.select_row_groups(indexes)
            result = picked if result is None else (result & picked)
        return result or set()


class UnionIndexSelector(RowGroupSelectorBase):
    """The row-groups any selector picks."""

    def __init__(self, selectors):
        self._selectors = list(selectors)

    def get_index_names(self):
        return sorted({n for s in self._selectors for n in s.get_index_names()})

    def select_row_groups(self, indexes):
        result = set()
        for selector in self._selectors:
            result |= selector.select_row_groups(indexes)
        return result
