"""Stores written by the reference petastorm, whose metadata is pickled
(counterpart of ``petastorm_tpu/etl/legacy.py``).

The reference keeps its schema as a pickle of ``petastorm.unischema.
Unischema`` under the ``_common_metadata`` key ``dataset-toolkit.unischema.
v1``, the row-group counts as JSON under ``dataset-toolkit.num_row_groups_
per_file.v1`` and its row-group indexes as a pickled ``{name: indexer}``
dict under ``dataset-toolkit.rowgroups_index.v1``.

Reading: a restricted unpickler (a ``find_class`` whitelist; any other
global raises :class:`LegacyMetadataError`, so a crafted
``_common_metadata`` cannot run code) maps the reference's classes onto
stubs, which are converted to the port's :class:`~petastorm_tpu_torch.
unischema.Unischema`, codecs and JSON index payloads. The renamed
ancestors of the reference package (``av.*.dataset_toolkit``) are
normalised by module name.

Writing: :func:`dumps_legacy_unischema` pickles an equivalent object graph
under shim modules named ``petastorm.unischema``, ``petastorm.codecs`` and
``pyspark.sql.types``, installed in ``sys.modules`` only for the dump (a
module of those names already imported is shadowed and put back), so the
reference reads the result. Both packages write the same bytes.
"""

import collections
import copyreg
import decimal
import io
import json
import logging
import pickle
import sys
import threading
import types
from collections import OrderedDict, defaultdict

import numpy as np

from petastorm_tpu_torch import codecs
from petastorm_tpu_torch.errors import PetastormTorchError
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

logger = logging.getLogger(__name__)

LEGACY_UNISCHEMA_KEY = b'dataset-toolkit.unischema.v1'
LEGACY_NUM_ROW_GROUPS_KEY = b'dataset-toolkit.num_row_groups_per_file.v1'
LEGACY_ROWGROUP_INDEX_KEY = b'dataset-toolkit.rowgroups_index.v1'

#: Renamed ancestors of the reference package.
_LEGACY_PACKAGE_PREFIXES = (
    'av.experimental.deepdrive.dataset_toolkit.',
    'av.ml.dataset_toolkit.',
    'dataset_toolkit.',
)


class LegacyMetadataError(PetastormTorchError):
    """Reference petastorm metadata exists but cannot be decoded."""


# --------------------------------------------------------------------------
# reading: restricted unpickling into stubs, then conversion
# --------------------------------------------------------------------------

class _Stub(object):
    """Absorbs pickle's NEWOBJ/BUILD into a plain ``__dict__``."""

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        elif state is not None:
            self.__dict__['_state'] = state


class _StubUnischema(_Stub):
    pass


class _StubCompressedImageCodec(_Stub):
    pass


class _StubNdarrayCodec(_Stub):
    pass


class _StubCompressedNdarrayCodec(_Stub):
    pass


class _StubScalarCodec(_Stub):
    pass


class _StubSingleFieldIndexer(_Stub):
    pass


class _StubFieldNotNullIndexer(_Stub):
    pass


class _StubSparkType(_Stub):
    """Any ``pyspark.sql.types.*`` instance; records the type's name."""

    spark_name = None


_SPARK_TYPE_NAMES = (
    'ByteType', 'ShortType', 'IntegerType', 'LongType', 'FloatType',
    'DoubleType', 'BooleanType', 'StringType', 'BinaryType', 'DecimalType',
    'TimestampType', 'DateType', 'NullType',
)
_SPARK_STUBS = {name: type('_Stub' + name, (_StubSparkType,), {'spark_name': name})
                for name in _SPARK_TYPE_NAMES}

_SPARK_NAME_TO_NUMPY = {
    'ByteType': np.int8,
    'ShortType': np.int16,
    'IntegerType': np.int32,
    'LongType': np.int64,
    'FloatType': np.float32,
    'DoubleType': np.float64,
    'BooleanType': np.bool_,
    'StringType': np.str_,
    'BinaryType': np.bytes_,
    'TimestampType': 'datetime64[ns]',
    'DateType': 'datetime64[D]',
}

# The numpy globals a reference unischema pickle holds: scalar types,
# ``numpy.dtype``, and the ndarray/scalar reconstructors of pickled defaults.
_ALLOWED_NUMPY = (frozenset(t.__name__ for t in np.sctypeDict.values())
                  | {'str_', 'bytes_', 'unicode_', 'string_', 'bool_', 'object_', 'dtype',
                     'ndarray'})
_NUMPY_MULTIARRAY = getattr(np, '_core', None) or np.core

_PETASTORM_CLASS_MAP = {
    ('petastorm.unischema', 'Unischema'): _StubUnischema,
    ('petastorm.codecs', 'CompressedImageCodec'): _StubCompressedImageCodec,
    ('petastorm.codecs', 'NdarrayCodec'): _StubNdarrayCodec,
    ('petastorm.codecs', 'CompressedNdarrayCodec'): _StubCompressedNdarrayCodec,
    ('petastorm.codecs', 'ScalarCodec'): _StubScalarCodec,
    ('petastorm.etl.rowgroup_indexers', 'SingleFieldIndexer'): _StubSingleFieldIndexer,
    ('petastorm.etl.rowgroup_indexers', 'FieldNotNullIndexer'): _StubFieldNotNullIndexer,
}

_ALLOWED_BUILTINS = frozenset(('set', 'frozenset', 'list', 'dict', 'tuple', 'object', 'bytearray',
                               'complex', 'int', 'float', 'bool', 'str', 'bytes'))


class _StubUnischemaField(tuple):
    """The reference's ``UnischemaField`` namedtuple (its pickle is NEWOBJ
    with the five values)."""

    def __new__(cls, name, numpy_dtype, shape, codec=None, nullable=False):
        return tuple.__new__(cls, (name, numpy_dtype, shape, codec, nullable))

    name = property(lambda self: self[0])
    numpy_dtype = property(lambda self: self[1])
    shape = property(lambda self: self[2])
    codec = property(lambda self: self[3])
    nullable = property(lambda self: self[4])


def _normalize_module(module):
    for prefix in _LEGACY_PACKAGE_PREFIXES:
        if module.startswith(prefix):
            return 'petastorm.' + module[len(prefix):]
    # 'sequence' was renamed 'ngram' before the package rename settled.
    if module == 'petastorm.sequence':
        return 'petastorm.ngram'
    return module


class _RestrictedUnpickler(pickle.Unpickler):
    """Resolves only the whitelisted globals; any other raises."""

    def find_class(self, module, name):
        module = _normalize_module(module)
        if module.startswith('petastorm.'):
            if (module, name) == ('petastorm.unischema', 'UnischemaField'):
                return _StubUnischemaField
            stub = _PETASTORM_CLASS_MAP.get((module, name))
            if stub is not None:
                return stub
            raise LegacyMetadataError(
                'Unsupported petastorm class in legacy metadata: {}.{}'.format(module, name))
        if module == 'pyspark.sql.types' and name in _SPARK_STUBS:
            return _SPARK_STUBS[name]
        if module in ('numpy', 'numpy.core.numerictypes') and name in _ALLOWED_NUMPY:
            return getattr(np, name)
        if module == 'numpy' and name == '_reconstruct':
            return _NUMPY_MULTIARRAY.multiarray._reconstruct
        if (module in ('numpy.core.multiarray', 'numpy._core.multiarray')
                and name in ('_reconstruct', 'scalar')):
            return getattr(_NUMPY_MULTIARRAY.multiarray, name)
        if module == 'decimal' and name == 'Decimal':
            return decimal.Decimal
        if module == 'collections' and name in ('OrderedDict', 'defaultdict'):
            return {'OrderedDict': OrderedDict, 'defaultdict': defaultdict}[name]
        if module in ('builtins', '__builtin__') and name in _ALLOWED_BUILTINS:
            return getattr(__import__('builtins'), name)
        if module in ('copy_reg', 'copyreg') and name == '_reconstructor':
            return copyreg._reconstructor
        raise LegacyMetadataError('Refusing to unpickle disallowed global {}.{} from legacy '
                                  'petastorm metadata'.format(module, name))


def _restricted_loads(blob):
    try:
        return _RestrictedUnpickler(io.BytesIO(blob)).load()
    except LegacyMetadataError:
        raise
    except Exception as e:
        raise LegacyMetadataError('Cannot decode legacy petastorm metadata: {}'.format(e))


def _convert_codec(stub, numpy_dtype):
    if stub is None:
        return None
    if isinstance(stub, _StubCompressedImageCodec):
        fmt = getattr(stub, '_image_codec', '.png').lstrip('.')
        return codecs.CompressedImageCodec(fmt, quality=getattr(stub, '_quality', 80))
    if isinstance(stub, _StubNdarrayCodec):
        return codecs.NdarrayCodec()
    if isinstance(stub, _StubCompressedNdarrayCodec):
        return codecs.CompressedNdarrayCodec()
    if isinstance(stub, _StubScalarCodec):
        spark = getattr(stub, '_spark_type', None)
        if isinstance(spark, _StubSparkType):
            if spark.spark_name in _SPARK_NAME_TO_NUMPY:
                return codecs.ScalarCodec(np.dtype(_SPARK_NAME_TO_NUMPY[spark.spark_name]))
            if spark.spark_name == 'DecimalType':
                return codecs.ScalarCodec(np.str_)
        return codecs.ScalarCodec(numpy_dtype)
    raise LegacyMetadataError('Unknown legacy codec stub {!r}'.format(stub))


def _convert_field(stub):
    if not isinstance(stub, _StubUnischemaField):
        raise LegacyMetadataError('Expected UnischemaField, got {!r}'.format(stub))
    # The reference yields decimal.Decimal objects for DecimalType fields;
    # strings are their fixed-width stand-in, as in the JAX package.
    numpy_dtype = (np.dtype(np.str_) if stub.numpy_dtype is decimal.Decimal
                   else np.dtype(stub.numpy_dtype))
    shape = tuple(stub.shape) if stub.shape is not None else ()
    return UnischemaField(stub.name, numpy_dtype, shape, _convert_codec(stub.codec, numpy_dtype),
                          bool(stub.nullable))


def load_legacy_unischema(blob):
    """A ``dataset-toolkit.unischema.v1`` pickle as the port's Unischema."""
    stub = _restricted_loads(blob)
    if not isinstance(stub, _StubUnischema):
        raise LegacyMetadataError('Legacy unischema blob did not contain a Unischema')
    state = stub.__dict__
    fields = [_convert_field(f) for f in state.get('_fields', {}).values()]
    name = state.get('_name', 'LegacySchema')
    logger.info('Loaded legacy petastorm unischema %r with %d fields', name, len(fields))
    return Unischema(name, fields)


def _convert_indexer(name, stub):
    """A legacy indexer as the JSON index payload the selectors read."""
    field = getattr(stub, '_column_name', name)
    data = getattr(stub, '_index_data', {})
    if isinstance(stub, _StubSingleFieldIndexer):
        return {'type': 'single_field', 'field': field,
                'values': {str(v): sorted(int(p) for p in pieces) for v, pieces in data.items()}}
    if isinstance(stub, _StubFieldNotNullIndexer):
        # The reference keeps a flat set of piece indexes.
        pieces = ({int(x) for x in data} if not isinstance(data, dict)
                  else {int(x) for p in data.values() for x in p})
        return {'type': 'field_not_null', 'field': field,
                'values': {'not_null': sorted(pieces)}}
    raise LegacyMetadataError('Unknown legacy indexer {!r}'.format(stub))


def load_legacy_row_group_indexes(blob):
    """A ``dataset-toolkit.rowgroups_index.v1`` pickle as the JSON index
    payload ``{name: {'type', 'field', 'values'}}``."""
    raw = _restricted_loads(blob)
    if not isinstance(raw, dict):
        raise LegacyMetadataError('Legacy rowgroup index blob is not a dict')
    return {name: _convert_indexer(name, stub) for name, stub in raw.items()}


# --------------------------------------------------------------------------
# writing: a pickle the reference loads
# --------------------------------------------------------------------------

_export_modules_lock = threading.Lock()


def _shim_module(name, package=False):
    mod = types.ModuleType(name)
    mod.__dict__['__petastorm_tpu_torch_shim__'] = True
    if package:
        mod.__path__ = []
    return mod


def _build_export_modules():
    """Shim modules ``petastorm.unischema``, ``petastorm.codecs`` and
    ``pyspark.sql.types`` (and their parent packages, which pickle imports
    to check a class), whose classes pickle under the reference's names."""
    uni = _shim_module('petastorm.unischema')
    cod = _shim_module('petastorm.codecs')
    spark = _shim_module('pyspark.sql.types')

    field_cls = collections.namedtuple(
        'UnischemaField', ['name', 'numpy_dtype', 'shape', 'codec', 'nullable'])
    field_cls.__module__ = 'petastorm.unischema'
    field_cls.__qualname__ = 'UnischemaField'
    uni.UnischemaField = field_cls
    unischema_cls = type('Unischema', (object,), {'__module__': 'petastorm.unischema'})
    uni.Unischema = unischema_cls

    codec_classes = {}
    for cname in ('CompressedImageCodec', 'NdarrayCodec', 'CompressedNdarrayCodec',
                  'ScalarCodec'):
        codec_classes[cname] = type(cname, (object,), {'__module__': 'petastorm.codecs'})
        setattr(cod, cname, codec_classes[cname])
    spark_classes = {}
    for sname in _SPARK_TYPE_NAMES:
        spark_classes[sname] = type(sname, (object,), {'__module__': 'pyspark.sql.types'})
        setattr(spark, sname, spark_classes[sname])

    pst = _shim_module('petastorm', package=True)
    pst.unischema, pst.codecs = uni, cod
    sql = _shim_module('pyspark.sql', package=True)
    sql.types = spark
    pysp = _shim_module('pyspark', package=True)
    pysp.sql = sql
    return {
        'modules': {'petastorm': pst, 'petastorm.unischema': uni, 'petastorm.codecs': cod,
                    'pyspark': pysp, 'pyspark.sql': sql, 'pyspark.sql.types': spark},
        'field_cls': field_cls, 'unischema_cls': unischema_cls,
        'codec_classes': codec_classes, 'spark_classes': spark_classes,
    }


_NUMPY_TO_SPARK_NAME = {
    'int8': 'ByteType', 'uint8': 'ShortType', 'int16': 'ShortType',
    'uint16': 'IntegerType', 'int32': 'IntegerType', 'uint32': 'LongType',
    'int64': 'LongType', 'float32': 'FloatType', 'float64': 'DoubleType',
    'bool': 'BooleanType',
}


def _export_spark_type(shims, numpy_dtype):
    dt = np.dtype(numpy_dtype)
    if dt.kind in 'SU' or dt == np.object_:
        name = 'StringType'
    elif dt.kind == 'M':
        name = 'TimestampType'
    else:
        name = _NUMPY_TO_SPARK_NAME.get(dt.name, 'StringType')
    return shims['spark_classes'][name]()


def _export_codec(shims, codec, numpy_dtype):
    cc = shims['codec_classes']
    if isinstance(codec, codecs.CompressedImageCodec):
        out = cc['CompressedImageCodec']()
        out._image_codec = '.' + codec.image_codec
        out._quality = codec.quality
        return out
    if isinstance(codec, codecs.CompressedNdarrayCodec):
        return cc['CompressedNdarrayCodec']()
    if isinstance(codec, codecs.NdarrayCodec):
        return cc['NdarrayCodec']()
    if isinstance(codec, codecs.ScalarCodec) or codec is None:
        out = cc['ScalarCodec']()
        out._spark_type = _export_spark_type(shims, numpy_dtype)
        return out
    raise LegacyMetadataError('Codec {!r} has no legacy petastorm equivalent'.format(codec))


def _export_field(shims, field):
    dt = field.numpy_dtype
    codec = field.codec if field.codec is not None else field.resolved_codec()
    return shims['field_cls'](field.name, dt.type, tuple(field.shape),
                              _export_codec(shims, codec, dt), bool(field.nullable))


def dumps_legacy_unischema(schema):
    """Pickle bytes that the reference petastorm's ``get_schema`` loads."""
    shims = _build_export_modules()
    uni = shims['unischema_cls'].__new__(shims['unischema_cls'])
    fields = [(f.name, _export_field(shims, f)) for f in schema.fields.values()]
    uni.__dict__['_name'] = schema.name
    uni.__dict__['_fields'] = OrderedDict(sorted(fields))
    for fname, f in fields:
        if fname not in uni.__dict__:
            uni.__dict__[fname] = f
    # pickle checks a class by importing its module: install the shims for
    # the dump only, shadowing (and then restoring) any module of the name.
    with _export_modules_lock:
        saved = {}
        try:
            for name, mod in shims['modules'].items():
                if name in sys.modules:
                    saved[name] = sys.modules[name]
                sys.modules[name] = mod
            return pickle.dumps(uni, protocol=2)
        finally:
            for name in shims['modules']:
                if name in saved:
                    sys.modules[name] = saved[name]
                else:
                    del sys.modules[name]


def export_legacy_metadata(store_or_url, schema=None):
    """Add the reference's keys to a store's ``_common_metadata`` (the
    pickled unischema and the row-group counts), so the reference petastorm
    reads a store the port wrote. The port's own keys stay."""
    from petastorm_tpu_torch.storage import NUM_ROW_GROUPS_KEY, ParquetStore

    store = store_or_url if isinstance(store_or_url, ParquetStore) else ParquetStore(store_or_url)
    if schema is None:
        from petastorm_tpu_torch.etl.dataset_metadata import get_schema
        schema = get_schema(store)
    counts = store.common_metadata_value(NUM_ROW_GROUPS_KEY)
    if counts is None:
        counts = json.dumps(store.num_row_groups_per_file()).encode('utf-8')
    store.write_common_metadata(store.read_arrow_schema(), {
        LEGACY_UNISCHEMA_KEY: dumps_legacy_unischema(schema),
        LEGACY_NUM_ROW_GROUPS_KEY: counts})
    logger.info('Wrote legacy petastorm metadata for %s', store.url)
