"""Unischema: a framework-neutral dataset schema with per-field codecs.

Counterpart of ``petastorm_tpu/unischema.py:30-280``, trimmed to what the
tensor-reader slice needs. The JSON form (``to_json``/``from_json``) is the
same as the JAX package's, so a store written by either package carries a
schema the other reads.
"""

import re
from collections import OrderedDict, namedtuple

import numpy as np
import pyarrow as pa

from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec, codec_from_json
from petastorm_tpu_torch.errors import SchemaError


class UnischemaField(object):
    """A single schema field: ``(name, numpy_dtype, shape, codec, nullable)``.

    ``shape`` is a tuple; ``None`` entries are variable-size dimensions.
    Equality ignores the codec, as in the JAX package.
    """

    __slots__ = ('name', 'numpy_dtype', 'shape', 'codec', 'nullable')

    def __init__(self, name, numpy_dtype, shape=(), codec=None, nullable=False):
        self.name = name
        self.numpy_dtype = np.dtype(numpy_dtype)
        self.shape = tuple(shape)
        self.codec = codec
        self.nullable = nullable

    def _key(self):
        return (self.name, self.numpy_dtype, self.shape, self.nullable)

    def __eq__(self, other):
        if not isinstance(other, UnischemaField):
            return NotImplemented
        return self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return 'UnischemaField({!r}, {}, {}, {}, nullable={})'.format(
            self.name, self.numpy_dtype, self.shape, self.codec, self.nullable)

    @property
    def is_scalar(self):
        return self.shape == ()

    def resolved_codec(self):
        """The explicit codec, else a native scalar column for scalars and
        ``NdarrayCodec`` bytes for tensors."""
        if self.codec is not None:
            return self.codec
        if self.is_scalar:
            return ScalarCodec(self.numpy_dtype)
        return NdarrayCodec()

    def to_json(self):
        return {
            'name': self.name,
            'dtype': self.numpy_dtype.str,
            'shape': list(self.shape),
            'codec': self.codec.to_json() if self.codec is not None else None,
            'nullable': bool(self.nullable),
        }

    @classmethod
    def from_json(cls, spec):
        return cls(spec['name'], np.dtype(spec['dtype']),
                   tuple(spec.get('shape', ())),
                   codec_from_json(spec.get('codec')),
                   spec.get('nullable', False))


_NAMEDTUPLE_CACHE = {}


def _namedtuple_type(schema_name, field_names):
    """One generated row type per (schema name, fields), so repeated calls
    hand out the identical type."""
    key = (schema_name, tuple(field_names))
    if key not in _NAMEDTUPLE_CACHE:
        _NAMEDTUPLE_CACHE[key] = namedtuple('{}_view'.format(schema_name),
                                            list(field_names))
    return _NAMEDTUPLE_CACHE[key]


class Unischema(object):
    """An ordered (by name) collection of :class:`UnischemaField`."""

    def __init__(self, name, fields):
        self._name = name
        self._fields = OrderedDict((f.name, f) for f in sorted(fields, key=lambda f: f.name))
        for f in self._fields.values():
            if re.match(r'^[A-Za-z_][A-Za-z0-9_]*$', f.name) is None:
                raise SchemaError('Field name {!r} is not a valid identifier'.format(f.name))

    @property
    def name(self):
        return self._name

    @property
    def fields(self):
        return self._fields

    def __getattr__(self, item):
        fields = object.__getattribute__(self, '_fields')
        if item in fields:
            return fields[item]
        raise AttributeError('{!r} object has no attribute/field {!r}'.format(
            type(self).__name__, item))

    def __repr__(self):
        lines = ['Unischema({!r}, ['.format(self._name)]
        lines.extend('  {!r},'.format(f) for f in self._fields.values())
        lines.append('])')
        return '\n'.join(lines)

    def create_schema_view(self, fields_or_patterns):
        """Subset view by field objects and/or full-match regex strings."""
        view_fields = []
        for f in match_unischema_fields(self, fields_or_patterns, allow_empty_match=False):
            if self._fields.get(f.name) != f:
                raise SchemaError('create_schema_view: field {!r} does not belong to schema {!r}'.format(
                    f.name, self._name))
            view_fields.append(self._fields[f.name])
        return Unischema(self._name, view_fields)

    def namedtuple_type(self):
        return _namedtuple_type(self._name, list(self._fields))

    def make_namedtuple(self, **kwargs):
        return self.namedtuple_type()(**{k: kwargs[k] for k in self._fields})

    def to_json(self):
        return {'name': self._name,
                'fields': [f.to_json() for f in self._fields.values()]}

    @classmethod
    def from_json(cls, spec):
        return cls(spec['name'], [UnischemaField.from_json(f) for f in spec['fields']])

    def arrow_schema(self):
        """Arrow schema of the encoded representation (the write path)."""
        return pa.schema([pa.field(f.name, f.resolved_codec().arrow_type(), nullable=True)
                          for f in self._fields.values()])


def match_unischema_fields(schema, fields_or_patterns, allow_empty_match=True):
    """Resolve a mixed list of fields and full-match regex strings."""
    if fields_or_patterns is None:
        return list(schema.fields.values())
    resolved = OrderedDict()
    for item in fields_or_patterns:
        if isinstance(item, UnischemaField):
            resolved[item.name] = item
        elif isinstance(item, str):
            pattern = re.compile(item)
            matched = [f for n, f in schema.fields.items() if pattern.fullmatch(n)]
            if not matched and not allow_empty_match:
                raise SchemaError('Pattern {!r} matched no fields of schema {!r}'.format(
                    item, schema.name))
            for f in matched:
                resolved[f.name] = f
        else:
            raise TypeError('Expected UnischemaField or str pattern, got {!r}'.format(item))
    return list(resolved.values())


def encode_row(schema, row_dict):
    """Encode a user row dict into Parquet-storable cell values."""
    if not isinstance(row_dict, dict):
        raise TypeError('row must be a dict, got {}'.format(type(row_dict)))
    unknown = set(row_dict) - set(schema.fields)
    if unknown:
        raise ValueError('Row has fields not in schema {!r}: {}'.format(schema.name, sorted(unknown)))
    encoded = {}
    for name, field in schema.fields.items():
        value = row_dict.get(name)
        if value is None:
            if not field.nullable:
                raise ValueError('Field {!r} is not nullable but is missing or None'.format(name))
            encoded[name] = None
        else:
            encoded[name] = field.resolved_codec().encode(field, value)
    return encoded
