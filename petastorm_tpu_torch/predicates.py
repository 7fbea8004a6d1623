"""Row predicates evaluated inside the reader's workers (counterpart of
``petastorm_tpu/predicates.py``).

A predicate names the fields it needs (``get_fields``), which the workers
read and decode first, and tests one row at a time (``do_include``) on the
decoded values: numpy scalars and strings, as the JAX package's workers
hand them over, so a predicate keeps the same rows in both packages.
"""

import hashlib

import numpy as np


class PredicateBase(object):
    """Predicate interface: which fields it needs, and the row test."""

    def get_fields(self):
        raise NotImplementedError

    def do_include(self, values):
        """``values``: dict of field name -> value for fields in get_fields()."""
        raise NotImplementedError


class in_set(PredicateBase):
    """Include rows whose field value is in a given set."""

    def __init__(self, values, predicate_field):
        self._values = set(values)
        self._field = predicate_field

    def get_fields(self):
        return {self._field}

    def do_include(self, values):
        return values[self._field] in self._values


class in_intersection(PredicateBase):
    """Include rows whose (iterable) field value shares an element with a
    given set."""

    def __init__(self, values, predicate_field):
        self._values = set(values)
        self._field = predicate_field

    def get_fields(self):
        return {self._field}

    def do_include(self, values):
        return bool(self._values.intersection(values[self._field]))


class in_negate(PredicateBase):
    """Logical NOT of another predicate."""

    def __init__(self, predicate):
        self._predicate = predicate

    def get_fields(self):
        return self._predicate.get_fields()

    def do_include(self, values):
        return not self._predicate.do_include(values)


class in_reduce(PredicateBase):
    """Reduce several predicates with e.g. ``all`` or ``any``."""

    def __init__(self, predicate_list, reduce_func):
        self._predicates = list(predicate_list)
        self._reduce = reduce_func

    def get_fields(self):
        fields = set()
        for p in self._predicates:
            fields |= set(p.get_fields())
        return fields

    def do_include(self, values):
        return self._reduce([p.do_include(values) for p in self._predicates])


class in_lambda(PredicateBase):
    """A user function over a declared list of fields: it receives one
    positional argument per field, in declaration order
    (``in_lambda(['id'], lambda id: id < 5)``), then ``state_arg`` when
    given."""

    def __init__(self, fields, func, state_arg=None):
        if not isinstance(fields, (list, tuple)):
            raise ValueError('in_lambda fields must be a list')
        self._ordered_fields = list(fields)
        self._func = func
        self._state = state_arg

    def get_fields(self):
        return set(self._ordered_fields)

    def do_include(self, values):
        args = [values[f] for f in self._ordered_fields]
        if self._state is not None:
            args.append(self._state)
        return self._func(*args)


def _stable_hash_fraction(value, num_buckets):
    """The bucket of ``value``: md5 of ``str(value)``, so the same value of
    the same numpy type lands in the same bucket in every process."""
    digest = hashlib.md5(str(value).encode('utf-8')).hexdigest()
    return int(digest, 16) % num_buckets


class in_pseudorandom_split(PredicateBase):
    """A deterministic train/validation/test split on a hash of a key field:
    ``fraction_list`` cuts 10,000 buckets into ranges, ``subset_index``
    picks the range kept."""

    _BUCKETS = 10000

    def __init__(self, fraction_list, subset_index, predicate_field):
        if not np.isclose(sum(fraction_list), 1.0) and sum(fraction_list) > 1.0:
            raise ValueError('fractions must sum to <= 1.0')
        self._fractions = list(fraction_list)
        self._index = subset_index
        self._field = predicate_field
        bounds = np.cumsum([0.0] + self._fractions)
        self._low = int(bounds[subset_index] * self._BUCKETS)
        self._high = int(bounds[subset_index + 1] * self._BUCKETS)

    def get_fields(self):
        return {self._field}

    def do_include(self, values):
        bucket = _stable_hash_fraction(values[self._field], self._BUCKETS)
        return self._low <= bucket < self._high
