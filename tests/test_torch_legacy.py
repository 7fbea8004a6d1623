"""Reference petastorm stores, ``materialize_dataset(url)``, the metadata CLI
and ``copy_dataset``: the port against the JAX package
(``petastorm_tpu/etl/legacy.py``, ``etl/dataset_metadata.py:31-119``,
``etl/rowgroup_indexing.py:95-100``, ``etl/metadata_cli.py``,
``tools/copy_dataset.py``).

A reference store is the JAX tests' fabrication (``tests/test_legacy_
interop.py``): the port's or the JAX package's store with its own metadata
keys replaced by the reference's pickled ``dataset-toolkit.*`` ones, built
through shim modules named as the reference's. The pickles both packages
write are byte-equal, each loads the other's, and the restricted unpickler
refuses any other global. Rows are compared exactly.
"""

import os
import pickle
import subprocess
import sys
import types

import numpy as np
import pyarrow.parquet as pq
import pytest

from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu.codecs import CompressedImageCodec as JaxImageCodec
from petastorm_tpu.codecs import CompressedNdarrayCodec as JaxCompressedNdarrayCodec
from petastorm_tpu.codecs import NdarrayCodec as JaxNdarrayCodec
from petastorm_tpu.codecs import ScalarCodec as JaxScalarCodec
from petastorm_tpu.etl import legacy as jax_legacy
from petastorm_tpu.etl.dataset_metadata import get_schema as jax_get_schema
from petastorm_tpu.etl.dataset_metadata import materialize_dataset as jax_materialize_dataset
from petastorm_tpu.etl.metadata_cli import generate_metadata as jax_generate_metadata
from petastorm_tpu.etl.rowgroup_indexing import get_row_group_indexes as jax_get_indexes
from petastorm_tpu.storage import ParquetStore as JaxStore
from petastorm_tpu.tools.copy_dataset import copy_dataset as jax_copy_dataset
from petastorm_tpu.unischema import Unischema as JaxUnischema
from petastorm_tpu.unischema import UnischemaField as JaxField
from petastorm_tpu_torch import (CompressedImageCodec, CompressedNdarrayCodec, NdarrayCodec,
                                 ScalarCodec, Unischema, UnischemaField, make_reader,
                                 make_tensor_reader, materialize_dataset, write_dataset)
from petastorm_tpu_torch.errors import PetastormMetadataError
from petastorm_tpu_torch.etl import legacy
from petastorm_tpu_torch.etl.dataset_metadata import get_schema
from petastorm_tpu_torch.etl.metadata_cli import generate_metadata, print_metadata
from petastorm_tpu_torch.etl.rowgroup_indexing import get_row_group_indexes
from petastorm_tpu_torch.selectors import SingleIndexSelector
from petastorm_tpu_torch.storage import NUM_ROW_GROUPS_KEY, UNISCHEMA_KEY, ParquetStore
from petastorm_tpu_torch.tools.copy_dataset import copy_dataset
from test_legacy_interop import genuine_reference_store  # noqa: F401 - a fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fields(make_field, image, ndarray, packed, scalar):
    return [make_field('id', np.int64, (), scalar(np.int64), False),
            make_field('image', np.uint8, (8, 6, 3), image('png'), False),
            make_field('matrix', np.float32, (3, 4), ndarray(), False),
            make_field('packed', np.int16, (2, 2), packed(), False),
            make_field('name', np.str_, (), scalar(np.str_), True)]


SCHEMA = Unischema('LegacySchema', _fields(UnischemaField, CompressedImageCodec, NdarrayCodec,
                                           CompressedNdarrayCodec, ScalarCodec))
JAX_SCHEMA = JaxUnischema('LegacySchema', _fields(JaxField, JaxImageCodec, JaxNdarrayCodec,
                                                  JaxCompressedNdarrayCodec, JaxScalarCodec))


def _rows(n=12):
    rng = np.random.default_rng(7)
    return [{'id': i, 'image': rng.integers(0, 255, (8, 6, 3), dtype=np.uint8),
             'matrix': rng.standard_normal((3, 4)).astype(np.float32),
             'packed': rng.integers(-5, 5, (2, 2)).astype(np.int16),
             'name': None if i == 5 else 'row{}'.format(i)} for i in range(n)]


def _write(path):
    url = 'file://' + str(path)
    write_dataset(url, SCHEMA, _rows(), rows_per_row_group=4)
    return url


def _strip_to_legacy(url, extra=None, dumps=legacy.dumps_legacy_unischema):
    """The store's ``_common_metadata`` with the reference's keys only."""
    store = ParquetStore(url)
    md = dict(store.read_common_metadata())
    kept = {k: v for k, v in md.items() if not k.startswith(b'petastorm_tpu.')}
    kept[legacy.LEGACY_UNISCHEMA_KEY] = dumps(get_schema(store))
    kept[legacy.LEGACY_NUM_ROW_GROUPS_KEY] = md[NUM_ROW_GROUPS_KEY]
    kept.update(extra or {})
    pq.write_metadata(store.read_arrow_schema().with_metadata(kept),
                      os.path.join(store.path, '_common_metadata'))
    return url


def _field_keys(schema):
    return [(f.name, f.numpy_dtype, f.shape, f.nullable, type(f.codec).__name__)
            for f in schema.fields.values()]


def _read_rows(factory, url, **kwargs):
    with factory(url, reader_pool_type='dummy', shuffle_row_groups=False, **kwargs) as reader:
        return [r._asdict() for r in reader]


def _assert_rows_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert list(x) == list(y)
        for name in x:
            if isinstance(x[name], np.ndarray):
                assert x[name].dtype == y[name].dtype and np.array_equal(x[name], y[name])
            else:
                assert x[name] == y[name]


# --------------------------------------------------------------------------
# the pickles
# --------------------------------------------------------------------------

def test_both_packages_write_the_same_pickle_and_read_each_others():
    port_blob = legacy.dumps_legacy_unischema(SCHEMA)
    jax_blob = jax_legacy.dumps_legacy_unischema(JAX_SCHEMA)
    assert port_blob == jax_blob
    assert _field_keys(legacy.load_legacy_unischema(jax_blob)) == \
        _field_keys(jax_legacy.load_legacy_unischema(port_blob)) == _field_keys(SCHEMA)
    image = legacy.load_legacy_unischema(jax_blob).fields['image'].codec
    assert isinstance(image, CompressedImageCodec) and image.image_codec == 'png'


def test_restricted_unpickler_refuses_arbitrary_globals():
    class Evil(object):
        def __reduce__(self):
            return (os.system, ('true',))

    with pytest.raises(legacy.LegacyMetadataError, match='disallowed global'):
        legacy.load_legacy_unischema(pickle.dumps(Evil(), protocol=2))
    with pytest.raises(legacy.LegacyMetadataError):
        legacy.load_legacy_unischema(b'not a pickle')
    with pytest.raises(legacy.LegacyMetadataError, match='Unsupported petastorm class'):
        legacy.load_legacy_unischema(
            legacy.dumps_legacy_unischema(SCHEMA).replace(b'Unischema\n', b'Unischemb\n'))


def test_legacy_package_rename_is_normalised():
    blob = legacy.dumps_legacy_unischema(SCHEMA)
    old = blob.replace(b'petastorm.unischema', b'av.ml.dataset_toolkit.unischema') \
              .replace(b'petastorm.codecs', b'av.ml.dataset_toolkit.codecs')
    assert _field_keys(legacy.load_legacy_unischema(old)) == _field_keys(SCHEMA)


def test_export_shadows_and_restores_modules_and_leaves_none():
    fake = types.ModuleType('pyspark')
    fake.__path__ = []
    before = set(sys.modules)
    sys.modules['pyspark'] = fake
    try:
        blob = legacy.dumps_legacy_unischema(SCHEMA)
        assert sys.modules['pyspark'] is fake
        jax_legacy.dumps_legacy_unischema(JAX_SCHEMA)
        assert sys.modules['pyspark'] is fake
    finally:
        del sys.modules['pyspark']
    assert set(sys.modules) - before == set()
    assert not [m for m in sys.modules if m == 'petastorm' or m.startswith('petastorm.')]
    assert _field_keys(legacy.load_legacy_unischema(blob)) == _field_keys(SCHEMA)


# --------------------------------------------------------------------------
# reference stores
# --------------------------------------------------------------------------

@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_reference_store_reads_as_in_jax(tmp_path, writer):
    dumps = legacy.dumps_legacy_unischema if writer == 'port' else \
        (lambda schema: jax_legacy.dumps_legacy_unischema(JAX_SCHEMA))
    url = _strip_to_legacy(_write(tmp_path), dumps=dumps)
    assert ParquetStore(url).common_metadata_value(UNISCHEMA_KEY) is None
    assert _field_keys(get_schema(ParquetStore(url))) == _field_keys(SCHEMA)
    port_rows = _read_rows(make_reader, url)
    _assert_rows_equal(port_rows, _read_rows(jax_make_reader, url))
    assert [r['id'] for r in port_rows] == list(range(12)) and port_rows[5]['name'] is None
    with make_tensor_reader(url, schema_fields=['id', 'image', 'matrix'], shuffle_row_groups=False,
                            reader_pool_type='dummy') as reader:
        chunk = next(reader)
    assert np.array_equal(chunk.image, np.stack([r['image'] for r in port_rows[:4]]))


def _legacy_index_blob():
    """A pickled ``{name: indexer}`` under the reference's class names."""
    created = []

    def module(name, package=False):
        mod = types.ModuleType(name)
        if package:
            mod.__path__ = []
        sys.modules[name] = mod
        created.append(name)
        return mod

    pkg, etl = module('petastorm', True), module('petastorm.etl', True)
    idx = module('petastorm.etl.rowgroup_indexers')
    pkg.etl, etl.rowgroup_indexers = etl, idx
    single_cls = type('SingleFieldIndexer', (object,), {'__module__': idx.__name__})
    notnull_cls = type('FieldNotNullIndexer', (object,), {'__module__': idx.__name__})
    idx.SingleFieldIndexer, idx.FieldNotNullIndexer = single_cls, notnull_cls
    try:
        single, notnull = single_cls(), notnull_cls()
        single.__dict__.update(_index_name='by_name', _column_name='name',
                               _index_data={'row1': {0}, 'row10': {2}, 'row4': {1}})
        notnull.__dict__.update(_index_name='name_set', _column_name='name',
                                _index_data={0, 1, 2})
        return pickle.dumps({'by_name': single, 'name_set': notnull}, protocol=2)
    finally:
        for name in created:
            del sys.modules[name]


def test_legacy_row_group_index_reads_and_selects_as_in_jax(tmp_path):
    blob = _legacy_index_blob()
    assert legacy.load_legacy_row_group_indexes(blob) == \
        jax_legacy.load_legacy_row_group_indexes(blob)
    url = _strip_to_legacy(_write(tmp_path), extra={legacy.LEGACY_ROWGROUP_INDEX_KEY: blob})
    assert get_row_group_indexes(url) == jax_get_indexes(url)
    assert get_row_group_indexes(url)['by_name']['values'] == {'row1': [0], 'row10': [2],
                                                                'row4': [1]}
    from petastorm_tpu.selectors import SingleIndexSelector as JaxSingleIndexSelector
    port = _read_rows(make_reader, url, schema_fields=['id'],
                      rowgroup_selector=SingleIndexSelector('by_name', ['row10']))
    jax = _read_rows(jax_make_reader, url, schema_fields=['id'],
                     rowgroup_selector=JaxSingleIndexSelector('by_name', ['row10']))
    assert [r['id'] for r in port] == [r['id'] for r in jax] == [8, 9, 10, 11]


def test_export_legacy_metadata_reads_in_jax_without_the_json_key(tmp_path):
    url = _write(tmp_path)
    legacy.export_legacy_metadata(url)
    store = ParquetStore(url)
    assert store.common_metadata_value(UNISCHEMA_KEY) is not None
    md = {k: v for k, v in store.read_common_metadata().items() if k != UNISCHEMA_KEY}
    assert md[legacy.LEGACY_NUM_ROW_GROUPS_KEY] == md[NUM_ROW_GROUPS_KEY]
    pq.write_metadata(store.read_arrow_schema().with_metadata(md),
                      os.path.join(store.path, '_common_metadata'))
    assert _field_keys(jax_get_schema(JaxStore(url))) == _field_keys(SCHEMA)
    _assert_rows_equal(_read_rows(make_reader, url), _read_rows(jax_make_reader, url))


def test_genuine_reference_store(genuine_reference_store):  # noqa: F811
    url = 'file://' + os.path.join(genuine_reference_store, 'dataset')
    expected = np.load(os.path.join(genuine_reference_store, 'expected.npz'))
    rows = sorted(_read_rows(make_reader, url), key=lambda r: r['id'])
    assert [r['id'] for r in rows] == list(expected['id'])
    np.testing.assert_array_equal(np.stack([r['image'] for r in rows]), expected['image'])
    assert [r['name'] for r in rows] == list(expected['name'])


def test_missing_metadata_points_to_make_batch_reader(tmp_path):
    path = tmp_path / 'plain'
    os.makedirs(path)
    pq.write_table(pq.read_table(ParquetStore(_write(tmp_path / 'src')).files[0]),
                   str(path / 'x.parquet'))
    with pytest.raises(PetastormMetadataError, match='make_batch_reader'):
        get_schema(ParquetStore('file://' + str(path)))
    with pytest.raises(RuntimeError, match='make_batch_reader'):
        make_reader('file://' + str(path))


# --------------------------------------------------------------------------
# materialize_dataset, the metadata CLI, copy_dataset
# --------------------------------------------------------------------------

@pytest.mark.parametrize('kwargs', [{'rows_per_row_group': 5},
                                    {'row_group_size_mb': 1},
                                    {'rows_per_row_group': 3, 'partition_fields': ['id']}])
def test_materialize_dataset_url_flavour_equals_jax(tmp_path, kwargs):
    rows = _rows()
    port_url, jax_url = 'file://' + str(tmp_path / 'port'), 'file://' + str(tmp_path / 'jax')
    with materialize_dataset(port_url, SCHEMA, **kwargs) as writer:
        for row in rows:
            writer.write(row)
    with jax_materialize_dataset(jax_url, JAX_SCHEMA, **kwargs) as writer:
        for row in rows:
            writer.write(row)
    port_store, jax_store = ParquetStore(port_url), ParquetStore(jax_url)
    assert [os.path.relpath(f, port_store.path) for f in port_store.files] == \
        [os.path.relpath(f, jax_store.path) for f in jax_store.files]
    assert [p.num_rows for p in port_store.row_groups()] == \
        [p.num_rows for p in jax_store.row_groups()]
    assert port_store.read_common_metadata()[UNISCHEMA_KEY] == \
        jax_store.read_common_metadata()[UNISCHEMA_KEY]
    for url in (port_url, jax_url):
        _assert_rows_equal(_read_rows(make_reader, url), _read_rows(jax_make_reader, jax_url))
    with pytest.raises(ValueError, match='schema'):
        with materialize_dataset(port_url, None):
            pass


def test_generate_metadata_migrates_a_reference_store_as_in_jax(tmp_path, capsys):
    port_url = _strip_to_legacy(_write(tmp_path / 'port'))
    jax_url = _strip_to_legacy(_write(tmp_path / 'jax'))
    assert generate_metadata(port_url).name == jax_generate_metadata(jax_url).name
    for url in (port_url, jax_url):
        assert ParquetStore(url).common_metadata_value(legacy.LEGACY_UNISCHEMA_KEY) is not None
    assert ParquetStore(port_url).read_common_metadata()[UNISCHEMA_KEY] == \
        ParquetStore(jax_url).read_common_metadata()[UNISCHEMA_KEY]
    print_metadata(port_url)
    out = capsys.readouterr().out
    assert "Unischema('LegacySchema'" in out and '3 row-groups in 1 files' in out


def test_generate_metadata_infers_a_plain_store(scalar_dataset, tmp_path):
    import shutil
    port, jax = tmp_path / 'port', tmp_path / 'jax'
    shutil.copytree(scalar_dataset.path, port)
    shutil.copytree(scalar_dataset.path, jax)
    generate_metadata('file://' + str(port))
    jax_generate_metadata('file://' + str(jax))
    assert ParquetStore('file://' + str(port)).read_common_metadata() == \
        ParquetStore('file://' + str(jax)).read_common_metadata()


def test_metadata_cli_runs_as_a_module(tmp_path):
    url = _strip_to_legacy(_write(tmp_path))
    env = dict(os.environ, PYTHONPATH=REPO)
    cli = [sys.executable, '-m', 'petastorm_tpu_torch.etl.metadata_cli']
    out = subprocess.run(cli + ['generate', url], capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "Wrote metadata for schema 'LegacySchema'" in out.stdout
    out = subprocess.run(cli + ['print', url, '--index'], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0 and 'No row-group indexes stored' in out.stdout


@pytest.mark.parametrize('kwargs', [{}, {'field_regex': ['id', 'na.*']},
                                    {'not_null_fields': ['name'], 'rows_per_row_group': 5}])
def test_copy_dataset_equals_jax(tmp_path, kwargs):
    source = _strip_to_legacy(_write(tmp_path / 'src'))   # a reference store as the source
    port_url, jax_url = 'file://' + str(tmp_path / 'port'), 'file://' + str(tmp_path / 'jax')
    assert copy_dataset(source, port_url, **kwargs) == jax_copy_dataset(source, jax_url, **kwargs)
    port_rows = _read_rows(make_reader, port_url)
    jax_rows = sorted(_read_rows(jax_make_reader, jax_url), key=lambda r: r['id'])
    _assert_rows_equal(port_rows, jax_rows)     # the port's copy keeps storage order
    assert [r['id'] for r in port_rows] == sorted(r['id'] for r in port_rows)
    assert get_schema(ParquetStore(port_url)).fields.keys() == \
        jax_get_schema(JaxStore(jax_url)).fields.keys()


def test_copy_dataset_runs_as_a_module(tmp_path):
    source = _write(tmp_path / 'src')
    target = 'file://' + str(tmp_path / 'dst')
    out = subprocess.run([sys.executable, '-m', 'petastorm_tpu_torch.tools.copy_dataset', source,
                          target, '--field-regex', 'id', 'matrix', '--rows-per-row-group', '6'],
                         capture_output=True, text=True, env=dict(os.environ, PYTHONPATH=REPO),
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'Copied 12 rows'
    assert [p.num_rows for p in ParquetStore(target).row_groups()] == [6, 6]
