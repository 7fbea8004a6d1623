"""Storage beyond local paths: the port's ``fs``/``storage`` against the JAX
package's. Resolver and retry-wrapper cases as in
``tests/test_fs_and_arrow_helpers.py:43-100``; a store written by either
package to fsspec's ``memory://`` reads through the other to digest-equal
batches; the native Parquet stage is never chosen for a store that is not
local; and the callers that need an operating-system path refuse one that
is not."""

import pickle
import uuid

import fsspec
import numpy as np
import pytest

from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu import make_tensor_reader as jax_make_tensor_reader
from petastorm_tpu.codecs import (CompressedImageCodec as JaxImageCodec,
                                  NdarrayCodec as JaxNdarrayCodec, ScalarCodec as JaxScalarCodec)
from petastorm_tpu.etl.writer import write_dataset as jax_write_dataset
from petastorm_tpu.fs import FilesystemResolver as JaxResolver
from petastorm_tpu.lineage import _digest_array as jax_digest
from petastorm_tpu.storage import ParquetStore as JaxStore
from petastorm_tpu.unischema import Unischema as JaxUnischema, UnischemaField as JaxField
from petastorm_tpu_torch import (CompressedImageCodec, NdarrayCodec, ScalarCodec, Unischema,
                                 UnischemaField, make_batch_reader, make_reader,
                                 make_tensor_reader, write_dataset)
from petastorm_tpu_torch.fs import (FilesystemResolver, RetryingFilesystemWrapper,
                                    get_filesystem_and_path, local_path, normalize_dataset_url)
from petastorm_tpu_torch.lineage import _digest_array
from petastorm_tpu_torch.storage import ParquetStore

ROWS, PER_GROUP = 40, 8


class FlakyFs(object):
    """Mock filesystem failing the first N calls of each method."""

    def __init__(self, failures):
        self.failures = failures
        self.calls = {}

    def _maybe_fail(self, name):
        count = self.calls.get(name, 0)
        self.calls[name] = count + 1
        if count < self.failures:
            raise IOError('transient failure #{} in {}'.format(count, name))

    def exists(self, path):
        self._maybe_fail('exists')
        return True

    def ls(self, path):
        self._maybe_fail('ls')
        return ['a', 'b']

    def rm(self, path):
        self._maybe_fail('rm')
        return 'removed'

    def not_retryable_marker(self):
        return 'passthrough'


@pytest.fixture
def memory_url():
    """A fresh ``memory://`` store URL, removed afterwards."""
    name = 'pstt-test-{}'.format(uuid.uuid4().hex[:8])
    yield 'memory://' + name
    fs = fsspec.filesystem('memory')
    if fs.exists(name):
        fs.rm(name, recursive=True)


@pytest.mark.parametrize('url,scheme,path', [
    ('file:///tmp/ds', 'file', '/tmp/ds'),
    ('/tmp/ds/', 'file', '/tmp/ds'),
    ('gs://bucket/a/b', 'gs', 'bucket/a/b'),
    ('gcs://bucket/a', 'gs', 'bucket/a'),
    ('s3://bucket/key', 's3', 'bucket/key'),
    ('memory://store', 'memory', 'store'),
    ('memory:///store/x', 'memory', 'store/x'),
    ('hdfs://ns1/user/data', 'hdfs', '/user/data'),
    ('hdfs://namenode:8020', 'hdfs', '/'),
    ('webhdfs://host:50070/d', 'webhdfs', '/d'),
    ('abfs://container/dir', 'abfs', 'container/dir'),
])
def test_resolver_cases_equal_the_jax_packages(url, scheme, path):
    port, jax = FilesystemResolver(url), JaxResolver(url)
    assert (port.scheme, port.get_dataset_path(), port.dataset_url) == \
        (jax.scheme, jax.get_dataset_path(), jax.dataset_url) == \
        (scheme, path, jax.dataset_url)


def test_normalize_url_rejects_relative():
    for bad in ('relative/path', 7):
        with pytest.raises(ValueError):
            normalize_dataset_url(bad)
    assert normalize_dataset_url('/a/b/') == 'file:///a/b'


def test_local_path_refuses_other_schemes():
    assert local_path('/tmp/x') == ('file:///tmp/x', '/tmp/x')
    for url in ('memory://x', 'gs://b/x', 'hdfs://ns/x'):
        with pytest.raises(ValueError, match='not a local'):
            local_path(url)


def test_resolver_not_picklable_but_its_factory_is():
    resolver = FilesystemResolver('memory://pstt-pickle')
    with pytest.raises(RuntimeError):
        pickle.dumps(resolver)
    rebuilt = pickle.loads(pickle.dumps(resolver.filesystem_factory()))()
    assert rebuilt.protocol == resolver.filesystem().protocol
    local = pickle.loads(pickle.dumps(FilesystemResolver('file:///tmp').filesystem_factory()))()
    assert local.exists('/')


def test_storage_options_reach_the_driver(monkeypatch):
    seen = {}
    memory = fsspec.filesystem('memory')

    def fake(protocol, **options):
        seen[protocol] = options
        return memory

    monkeypatch.setattr(fsspec, 'filesystem', fake)
    FilesystemResolver('gs://b/x', {'project': 'p', 'token': 'anon'}).filesystem()
    FilesystemResolver('webhdfs://host:50070/d', {'user': 'u'}).filesystem()
    assert seen == {'gs': {'project': 'p', 'token': 'anon'},
                    'webhdfs': {'user': 'u', 'host': 'host', 'port': 50070}}


def test_retry_succeeds_within_budget():
    events = []
    fs = RetryingFilesystemWrapper(FlakyFs(failures=2), retries=2, backoff_s=0,
                                   on_retry=lambda m, a, e: events.append((m, a)))
    assert fs.exists('/x') is True
    assert fs.wrapped.calls['exists'] == 3
    assert events == [('exists', 0), ('exists', 1)]


def test_retry_exhausted_raises_last_error():
    fs = RetryingFilesystemWrapper(FlakyFs(failures=5), retries=2, backoff_s=0)
    with pytest.raises(IOError):
        fs.ls('/x')
    assert fs.wrapped.calls['ls'] == 3


def test_non_retry_methods_delegate():
    fs = RetryingFilesystemWrapper(FlakyFs(failures=1), retries=3, backoff_s=0)
    assert fs.not_retryable_marker() == 'passthrough'
    with pytest.raises(IOError):
        fs.rm('/x')                 # not idempotent: not retried by default
    opted = RetryingFilesystemWrapper(FlakyFs(failures=1), retries=3, backoff_s=0,
                                      extra_retry_methods=('rm',))
    assert opted.rm('/x') == 'removed'


def test_non_matching_exceptions_propagate_immediately():
    class Broken(object):
        def __init__(self):
            self.calls = 0

        def exists(self, path):
            self.calls += 1
            raise ValueError('not transient')

    broken = Broken()
    with pytest.raises(ValueError):
        RetryingFilesystemWrapper(broken, retries=3, backoff_s=0).exists('/x')
    assert broken.calls == 1


def test_get_filesystem_and_path_retries_opt_in(tmp_path):
    fs, path = get_filesystem_and_path('file://' + str(tmp_path), retries=1)
    assert isinstance(fs, RetryingFilesystemWrapper)
    assert fs.exists(path)
    plain, _ = get_filesystem_and_path('file://' + str(tmp_path))
    assert not isinstance(plain, RetryingFilesystemWrapper)


def _rows():
    rng = np.random.default_rng(0)
    for i in range(ROWS):
        yield {'id': i, 'image': rng.integers(0, 256, (12, 16, 3), dtype=np.uint8),
               'vec': rng.normal(size=(4,)).astype(np.float32)}


def _write(url, writer, partitioned=False):
    kwargs = {'rows_per_row_group': PER_GROUP}
    if partitioned:
        kwargs['partition_fields'] = ('part',)
    rows = ({**row, 'part': row['id'] % 2} for row in _rows()) if partitioned else _rows()
    if writer == 'jax':
        fields = [JaxField('id', np.int64, (), JaxScalarCodec(np.int64)),
                  JaxField('image', np.uint8, (12, 16, 3), JaxImageCodec('png')),
                  JaxField('vec', np.float32, (4,), JaxNdarrayCodec())]
        if partitioned:
            fields.append(JaxField('part', np.int64, (), JaxScalarCodec(np.int64)))
        jax_write_dataset(url, JaxUnischema('FsSchema', fields), rows, **kwargs)
    else:
        fields = [UnischemaField('id', np.int64, (), ScalarCodec(np.int64)),
                  UnischemaField('image', np.uint8, (12, 16, 3), CompressedImageCodec('png')),
                  UnischemaField('vec', np.float32, (4,), NdarrayCodec())]
        if partitioned:
            fields.append(UnischemaField('part', np.int64, (), ScalarCodec(np.int64)))
        write_dataset(url, Unischema('FsSchema', fields), rows, **kwargs)


def _digests(factory, url, digest, **kwargs):
    with factory(url, reader_pool_type='dummy', shuffle_row_groups=False, **kwargs) as reader:
        out = []
        for item in reader:
            out.append({name: digest(np.asarray(getattr(item, name))) for name in item._fields})
        return out


@pytest.mark.parametrize('writer', ['jax', 'port'])
@pytest.mark.parametrize('factories', ['tensor', 'rows'])
def test_memory_store_reads_digest_equal_across_packages(memory_url, writer, factories):
    _write(memory_url, writer)
    port_factory, jax_factory = ((make_tensor_reader, jax_make_tensor_reader)
                                 if factories == 'tensor' else (make_reader, jax_make_reader))
    port = _digests(port_factory, memory_url, _digest_array)
    jax = _digests(jax_factory, memory_url, jax_digest)
    assert port == jax and len(port) == (ROWS // PER_GROUP if factories == 'tensor' else ROWS)


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_memory_store_pieces_and_metadata_equal_across_packages(memory_url, writer):
    _write(memory_url, writer, partitioned=True)
    port, jax = ParquetStore(memory_url), JaxStore(memory_url)
    assert [(p.path, p.row_group, p.partition_values) for p in port.row_groups()] == \
        [(p.path, p.row_group, p.partition_values) for p in jax.row_groups()]
    assert port.partition_names == jax.partition_names == ['part']
    assert port.read_common_metadata() == jax.read_common_metadata()
    assert port.files == jax.files
    if writer == 'port':
        # The port's index names files relative to the store's root.
        assert sorted(port.num_row_groups_per_file()) == [
            'part=0/part-00000-00000.parquet', 'part=1/part-00000-00001.parquet']


def test_store_on_an_explicit_filesystem(memory_url):
    """``ParquetStore(url, filesystem=fs, path=p)`` takes the filesystem as
    it is (as the JAX store does), and the workers' store factory hands
    that store over rather than resolving its URL again."""
    from petastorm_tpu_torch.reader import _StoreFactory
    _write(memory_url, 'port')
    name = memory_url[len('memory://'):]
    fs = fsspec.filesystem('memory')
    store = ParquetStore('anything', filesystem=fs, path=name)
    jax = JaxStore('anything', filesystem=fs, path=name)
    assert [(p.path, p.row_group) for p in store.row_groups()] == \
        [(p.path, p.row_group) for p in jax.row_groups()]
    assert not store.is_local and _StoreFactory(store)() is store
    resolved = ParquetStore(memory_url)
    assert _StoreFactory(resolved)() is not resolved
    assert _StoreFactory(resolved)().files == resolved.files


def test_memory_store_partitioned_reads_digest_equal(memory_url):
    _write(memory_url, 'port', partitioned=True)
    port = _digests(make_tensor_reader, memory_url, _digest_array)
    jax = _digests(jax_make_tensor_reader, memory_url, jax_digest)
    assert port == jax


def test_batch_reader_reads_a_plain_memory_store(memory_url):
    import pyarrow as pa
    import pyarrow.parquet as pq
    fs = fsspec.filesystem('memory')
    name = memory_url[len('memory://'):]
    table = pa.table({'x': np.arange(64, dtype=np.int64), 'y': np.arange(64) * 0.5})
    with fs.open(name + '/a.parquet', 'wb') as f:
        pq.write_table(table, f, row_group_size=16)
    with make_batch_reader(memory_url, reader_pool_type='dummy', shuffle_row_groups=False) as r:
        got = np.concatenate([np.asarray(c.x) for c in r])
    assert np.array_equal(got, np.arange(64))


def test_native_stage_is_never_chosen_for_a_memory_store(memory_url, tmp_path):
    """The native Parquet stage opens operating-system paths: a local store
    reads through it (it builds here), a ``memory://`` store through pyarrow
    on fsspec file objects, to the same batches."""
    from petastorm_tpu_torch.native import parquet as native_pq
    from petastorm_tpu_torch.workers import rowgroup_worker_base as base
    if not native_pq.is_available():
        pytest.skip('the native Parquet stage does not build: {}'.format(native_pq.load_error()))
    local_url = 'file://' + str(tmp_path / 'local')
    _write(local_url, 'port')
    _write(memory_url, 'port')
    opened = []
    real = native_pq.NativeParquetFile

    def spy(path):
        opened.append(path)
        return real(path)

    digests = {}
    for url in (local_url, memory_url):
        del opened[:]
        base_native = base.RowGroupWorkerBase._native_enabled
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(native_pq, 'NativeParquetFile', spy)
            with make_tensor_reader(url, reader_pool_type='dummy', shuffle_row_groups=False) as r:
                decoder = r.decoder
                digests[url] = [{n: _digest_array(np.asarray(getattr(c, n))) for n in c._fields}
                                for c in r]
        assert base.RowGroupWorkerBase._native_enabled is base_native
        if url == local_url:
            assert decoder['parquet'] == 'native' and opened
        else:
            assert decoder['parquet'] == 'pyarrow' and not opened
            assert 'not local' in decoder['parquet_error']
    assert digests[local_url] == digests[memory_url]


def test_disk_caches_refuse_a_non_local_location(tmp_path, memory_url):
    from petastorm_tpu_torch.cache import LocalDiskCache
    from petastorm_tpu_torch.chunk_store import DecodedChunkStore
    for cls in (LocalDiskCache, DecodedChunkStore):
        with pytest.raises(ValueError, match='local'):
            cls('gs://bucket/cache')
        assert cls('file://' + str(tmp_path / cls.__name__))._path == \
            str(tmp_path / cls.__name__)
    _write(memory_url, 'port')
    with make_tensor_reader(memory_url, reader_pool_type='dummy', cache_type='chunk-store',
                            cache_location=str(tmp_path / 'store')) as reader:
        assert sum(len(c.id) for c in reader) == ROWS


def test_converter_on_a_memory_parent(memory_url):
    import pyarrow as pa
    from petastorm_tpu_torch.converter import make_converter
    table = pa.table({'x': np.arange(32, dtype=np.int64)})
    conv = make_converter(table, parent_cache_dir_url=memory_url)
    try:
        assert conv.dataset_url.startswith(memory_url + '/conv_')
        with make_batch_reader(conv.dataset_url, reader_pool_type='dummy') as reader:
            assert sorted(np.concatenate([np.asarray(c.x) for c in reader])) == list(range(32))
    finally:
        conv.delete()
    resolver = FilesystemResolver(conv.dataset_url)
    assert not resolver.filesystem().exists(resolver.get_dataset_path())


def test_lineage_replays_a_memory_store_batch(memory_url):
    from petastorm_tpu_torch import TorchLoader
    from petastorm_tpu_torch.lineage import verify_record
    _write(memory_url, 'port')
    with make_tensor_reader(memory_url, reader_pool_type='dummy', shuffle_row_groups=False,
                            schema_fields=['id', 'vec']) as reader:
        with TorchLoader(reader, 10, device='cpu', lineage=True) as loader:
            live = [{n: getattr(b, n).numpy().copy() for n in b._fields} for b in loader]
            tracker = loader.lineage_tracker
            record, ctx = tracker.ring()[2], tracker.ctx
    replayed = verify_record(record, ctx, storage_options={})
    assert all(np.array_equal(replayed[n], live[2][n]) for n in live[2])
