"""Unischema: a framework-neutral dataset schema with per-field codecs.

Counterpart of ``petastorm_tpu/unischema.py:30-429``. The JSON form
(``to_json``/``from_json``) is the same as the JAX package's, so a store
written by either package carries a schema the other reads.
:meth:`Unischema.from_arrow_schema` infers a schema from a plain Parquet
store's Arrow schema, as ``make_batch_reader`` needs it: lists become
``(None,)`` fields, strings, binary and decimals objects, timestamps and
dates ``datetime64[ns]``, dictionary types their value type.
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
            if not _valid_attr_name(f.name):
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

    def arrow_schema(self, partition_fields=()):
        """Arrow schema of the encoded representation (the write path);
        ``partition_fields`` are left out (they become directory names)."""
        return pa.schema([pa.field(f.name, f.resolved_codec().arrow_type(), nullable=True)
                          for f in self._fields.values() if f.name not in partition_fields])

    @classmethod
    def from_arrow_schema(cls, arrow_schema, schema_name='inferred_schema',
                          partition_columns=(), omit_unsupported_fields=False):
        """A schema inferred from a plain Parquet store's Arrow schema
        (``petastorm_tpu/unischema.py:201-225``): one codec-less field a
        column, nullable as the column is, and an object field for each
        hive partition column the files do not hold. A column of a type
        with no numpy counterpart (a struct, a fixed-size list) raises
        ``SchemaError``, or is left out with ``omit_unsupported_fields``."""
        fields = []
        for name in arrow_schema.names:
            arrow_field = arrow_schema.field(name)
            try:
                np_dtype, shape = _arrow_to_numpy_dtype(arrow_field.type)
            except SchemaError:
                if omit_unsupported_fields:
                    continue
                raise
            fields.append(UnischemaField(name, np_dtype, shape, codec=None,
                                         nullable=arrow_field.nullable))
        for name in partition_columns:
            if not any(f.name == name for f in fields):
                fields.append(UnischemaField(name, np.dtype('O'), (), codec=None, nullable=False))
        return cls(schema_name, fields)


def _valid_attr_name(name):
    return re.match(r'^[A-Za-z_][A-Za-z0-9_]*$', name) is not None


def _arrow_to_numpy_dtype(arrow_type):
    """``(numpy dtype, shape)`` of an Arrow type; a list is a ``(None,)``
    field of its item type (``petastorm_tpu/unischema.py:230-253``)."""
    if pa.types.is_list(arrow_type) or pa.types.is_large_list(arrow_type):
        inner, inner_shape = _arrow_to_numpy_dtype(arrow_type.value_type)
        if inner_shape != ():
            raise SchemaError('Nested lists are not supported: {}'.format(arrow_type))
        return inner, (None,)
    if (pa.types.is_string(arrow_type) or pa.types.is_large_string(arrow_type)
            or pa.types.is_binary(arrow_type) or pa.types.is_large_binary(arrow_type)
            or pa.types.is_decimal(arrow_type)):
        return np.dtype('O'), ()
    if pa.types.is_timestamp(arrow_type) or pa.types.is_date(arrow_type):
        return np.dtype('datetime64[ns]'), ()
    if pa.types.is_dictionary(arrow_type):
        return _arrow_to_numpy_dtype(arrow_type.value_type)
    primitive = arrow_primitive_dtype(arrow_type)
    if primitive is not None:
        return primitive, ()
    if _object_typed(arrow_type):
        return np.dtype('O'), ()
    if _unsupported(arrow_type):
        raise SchemaError('Unsupported Arrow type: {}'.format(arrow_type))
    try:
        return np.dtype(arrow_type.to_pandas_dtype()), ()
    except NotImplementedError:
        raise SchemaError('Unsupported Arrow type: {}'.format(arrow_type))


_FLOAT_DTYPES = {'halffloat': np.dtype('float16'), 'float': np.dtype('float32'),
                 'double': np.dtype('float64')}


def arrow_primitive_dtype(arrow_type):
    """The numpy dtype of an integer, float, bool or duration Arrow type
    (what ``to_pandas_dtype`` gives, without the pandas that pyarrow's
    version consults), else None."""
    if pa.types.is_integer(arrow_type):
        return np.dtype(str(arrow_type))
    if pa.types.is_floating(arrow_type):
        return _FLOAT_DTYPES[str(arrow_type)]
    if pa.types.is_boolean(arrow_type):
        return np.dtype(bool)
    if pa.types.is_duration(arrow_type):
        return np.dtype('timedelta64[{}]'.format(arrow_type.unit))
    return None


def _unsupported(arrow_type):
    """The types ``to_pandas_dtype`` refuses (the JAX package's
    ``SchemaError``), told apart without pandas."""
    return any(check(arrow_type) for check in (
        pa.types.is_time, pa.types.is_struct, pa.types.is_fixed_size_list,
        pa.types.is_interval, pa.types.is_union, pa.types.is_list_view,
        pa.types.is_large_list_view, pa.types.is_run_end_encoded))


def _object_typed(arrow_type):
    """The types ``to_pandas_dtype`` maps to object, told apart without
    pandas."""
    return any(check(arrow_type) for check in (
        pa.types.is_null, pa.types.is_map, pa.types.is_fixed_size_binary,
        pa.types.is_string_view, pa.types.is_binary_view))


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
