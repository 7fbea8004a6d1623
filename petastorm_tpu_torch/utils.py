"""Small host-side helpers shared by the loader and the data service."""

from collections import namedtuple


def cached_namedtuple(cache, type_name, names):
    """The namedtuple type for ``names``, memoized in the caller's ``cache``
    dict (``petastorm_tpu/utils.py:35``): a consumer that builds batches
    from dicts hands out one type per field set, so consecutive batches
    compare as one structure."""
    nt = cache.get(names)
    if nt is None:
        nt = cache[names] = namedtuple(type_name, names)
    return nt
