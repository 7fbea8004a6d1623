"""The port stands alone: it imports neither JAX nor the JAX package, its
CUDA entry points refuse to run without a GPU, and its threads end on
``close()``."""

import ast
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import petastorm_tpu_torch
from petastorm_tpu_torch import (CompressedImageCodec, ScalarCodec, TorchLoader, Unischema,
                                 UnischemaField, make_tensor_reader, write_dataset)
from petastorm_tpu_torch.device import resolve_device
from petastorm_tpu_torch.models import ResNet50, ResNetTiny, TransformerLM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.dirname(petastorm_tpu_torch.__file__)
BANNED_ROOTS = ('jax', 'jaxlib', 'flax', 'optax', 'orbax')


def _banned(module):
    return (module.split('.')[0] in BANNED_ROOTS or module == 'petastorm_tpu'
            or module.startswith('petastorm_tpu.'))


def _sources():
    for root, _, names in os.walk(PACKAGE):
        for name in names:
            if name.endswith('.py'):
                yield os.path.join(root, name)
    yield os.path.join(REPO, 'chip_smoke.py')


def test_importing_every_module_pulls_in_no_jax():
    code = (
        'import pkgutil, sys\n'
        'import petastorm_tpu_torch\n'
        'for m in pkgutil.walk_packages(petastorm_tpu_torch.__path__, "petastorm_tpu_torch."):\n'
        '    __import__(m.name)\n'
        'bad = sorted(m for m in sys.modules if m.split(".")[0] in {!r}\n'
        '             or m == "petastorm_tpu" or m.startswith("petastorm_tpu."))\n'
        'assert not bad, bad\n'
        'print("ok", len([m for m in sys.modules if m.startswith("petastorm_tpu_torch")]))\n'
    ).format(BANNED_ROOTS)
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith('ok ')


def test_no_source_imports_jax_or_the_jax_package():
    offenders = []
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or '']
            else:
                continue
            offenders.extend('{}:{} {}'.format(path, node.lineno, n) for n in names if _banned(n))
    assert not offenders
    assert not _banned('petastorm_tpu_torch') and _banned('petastorm_tpu.codecs')


def test_no_source_reads_the_jax_packages_environment():
    for path in _sources():
        with open(path) as f:
            assert 'PETASTORM_TPU_' not in f.read(), path


def test_cuda_entry_points_raise_without_a_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='is_available'):
        resolve_device('cuda')
    with pytest.raises(RuntimeError, match='is_available'):
        TorchLoader(iter(()), 4)    # device defaults to 'cuda'
    for build in (ResNetTiny, ResNet50):
        with pytest.raises(RuntimeError, match='is_available'):
            build(num_classes=10)   # device defaults to 'cuda'
    with pytest.raises(RuntimeError, match='is_available'):
        TransformerLM(64)           # device defaults to 'cuda'
    assert resolve_device('cpu') == torch.device('cpu')
    with pytest.raises(ValueError):
        resolve_device('meta')


def test_plain_parquet_entry_points_raise_without_a_gpu(monkeypatch, tmp_path):
    """The batch reader's loaders, the converter's, the ``DataLoader`` and
    the throughput harness's ``'torch'`` method default to the card and
    raise without one; ``device='cpu'`` runs them."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.benchmark import reader_throughput
    from petastorm_tpu_torch.converter import make_converter
    from petastorm_tpu_torch.pytorch import DataLoader

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    (tmp_path / 'plain').mkdir()
    pq.write_table(pa.table({'x': np.arange(16)}), str(tmp_path / 'plain' / 'x.parquet'),
                   row_group_size=8)
    url = 'file://' + str(tmp_path / 'plain')
    with make_batch_reader(url, reader_pool_type='dummy') as reader:
        with pytest.raises(RuntimeError, match='is_available'):
            TorchLoader(reader, 4)
        with pytest.raises(RuntimeError, match='is_available'):
            DataLoader(reader)
        with DataLoader(reader, batch_size=4, device='cpu') as loader:
            assert next(iter(loader)).x.device.type == 'cpu'
    with pytest.raises(RuntimeError, match='is_available'):
        reader_throughput(url, read_method='torch', warmup_cycles_count=1,
                          measure_cycles_count=1)
    conv = make_converter(pa.table({'x': np.arange(16)}),
                          parent_cache_dir_url=str(tmp_path / 'conv'))
    try:
        for make in (conv.make_torch_loader, conv.make_jax_loader, conv.make_torch_dataloader):
            with pytest.raises(RuntimeError, match='is_available'):
                with make(batch_size=4):
                    pass
            with make(batch_size=4, device='cpu', num_epochs=1) as loader:
                assert next(iter(loader)).x.device.type == 'cpu'
    finally:
        conv.delete()


def _store(tmp_path):
    schema = Unischema('ThreadSchema', [
        UnischemaField('image', np.uint8, (8, 8, 3), CompressedImageCodec('png')),
        UnischemaField('label', np.int64, (), ScalarCodec(np.int64)),
    ])
    rng = np.random.default_rng(0)
    url = 'file://' + str(tmp_path / 'store')
    write_dataset(url, schema, ({'image': rng.integers(0, 256, (8, 8, 3), dtype=np.uint8),
                                 'label': i} for i in range(64)), rows_per_row_group=8)
    return url


def _port_threads():
    return [t.name for t in threading.enumerate() if t.name.startswith('pstt-')]


def test_loader_refuses_prefetch_below_one():
    # prefetch=0 is consumer staging (no staging threads); below it is an error.
    with pytest.raises(ValueError, match='prefetch'):
        TorchLoader(iter(()), 4, device='cpu', prefetch=-1)


@pytest.mark.parametrize('prefetch', [1, 2])
def test_no_port_thread_survives_close(tmp_path, prefetch):
    url = _store(tmp_path)
    reader = make_tensor_reader(url, workers_count=3, num_epochs=None, seed=1)
    loader = TorchLoader(reader, 5, device='cpu', prefetch=prefetch)
    batches = [next(loader) for _ in range(7)]     # a batch spans chunks: arena path
    assert _port_threads()
    assert all(tuple(b.image.shape) == (5, 8, 8, 3) and b.label.dtype == torch.int64
               for b in batches)
    loader.close()
    reader.stop()
    reader.join()
    assert _port_threads() == []
    with pytest.raises(RuntimeError, match='closed'):
        next(loader)


@pytest.mark.parametrize('prefetch', [0, 2])
def test_no_autotune_thread_survives_close(tmp_path, prefetch):
    """The tuner (``pstt-autotune``) runs while its loader lives; the
    reader's own stops when the loader adopts its knobs."""
    from petastorm_tpu_torch.autotune import AutotuneConfig
    url = _store(tmp_path)
    reader = make_tensor_reader(url, workers_count=2, num_epochs=None, seed=1, autotune=True)
    assert _port_threads().count('pstt-autotune') == 1
    loader = TorchLoader(reader, 5, device='cpu', prefetch=prefetch,
                         autotune=AutotuneConfig(interval_s=0.05))
    next(loader)
    assert _port_threads().count('pstt-autotune') == 1 and 'autotune' in loader.stats
    loader.close()
    reader.stop()
    reader.join()
    assert _port_threads() == []


@pytest.mark.parametrize('prefetch', [0, 2])
def test_no_watchdog_thread_survives_close(tmp_path, prefetch):
    """The watchdog (``pstt-watchdog``) runs while its loader lives and its
    reader's own stops when the loader takes over."""
    url = _store(tmp_path)
    reader = make_tensor_reader(url, workers_count=2, num_epochs=None, seed=1, watchdog=True)
    assert _port_threads().count('pstt-watchdog') == 1
    loader = TorchLoader(reader, 5, device='cpu', prefetch=prefetch, watchdog=True)
    next(loader)
    assert _port_threads().count('pstt-watchdog') == 1
    assert loader.stats['watchdog']['alive']
    loader.close()
    reader.stop()
    reader.join()
    assert _port_threads() == []
    assert not loader.stats['watchdog']['alive']


def test_native_decode_budget_and_bench_run_without_the_jax_package(tmp_path):
    """The native codec and Parquet stage, the decode budget, the staging-
    step decode and the bench's new reader code run in a process that never
    loads JAX or the JAX package, from the port's own C++ sources and
    libraries (``libpstt_*`` under ``.torch_build/native/``, never the JAX
    package's ``libpst_*``)."""
    code = (
        'import sys, numpy as np\n'
        'from petastorm_tpu_torch import (CompressedImageCodec, ScalarCodec, TorchLoader,\n'
        '    Unischema, UnischemaField, bench, decode_budget, make_tensor_reader, write_dataset)\n'
        'from petastorm_tpu_torch.native import build\n'
        'schema = Unischema("S", [UnischemaField("id", np.int64, (), ScalarCodec(np.int64)),\n'
        '    UnischemaField("image", np.uint8, (8, 8, 3), CompressedImageCodec("jpeg", 90))])\n'
        'rng = np.random.default_rng(0)\n'
        'url = "file://{root}/jpeg"\n'
        'write_dataset(url, schema, ({{"id": i, "image": rng.integers(0, 256, (8, 8, 3),\n'
        '    dtype=np.uint8)}} for i in range(16)), rows_per_row_group=8)\n'
        'with make_tensor_reader(url, raw_image_fields=True, reader_pool_type="dummy") as r:\n'
        '    assert r.decoder["image"] == "native" and r.decoder["parquet"] == "native"\n'
        '    with TorchLoader(r, 8, device="cpu", on_device_augment=True) as loader:\n'
        '        assert [tuple(b.image.shape) for b in loader] == [(8, 8, 8, 3)] * 2\n'
        'assert decode_budget.get_budget().sharers() == 0\n'
        'hello = bench.write_hello_world_store("{root}/hello", rows=32)\n'
        'bench.STAGING_BATCHES = 1\n'
        'assert bench.run_staging(hello, "cpu", 1)["staged_samples_per_sec"] > 0\n'
        'maps = open("/proc/self/maps").read()\n'
        'assert "libpstt_image-" in maps and "libpstt_parquet-" in maps, maps\n'
        'assert "libpst_image-" not in maps and "libpst_parquet-" not in maps\n'
        'assert build.SRC_DIR.startswith({package!r})\n'
        'bad = sorted(m for m in sys.modules if m.split(".")[0] in {banned!r}\n'
        '             or m == "petastorm_tpu" or m.startswith("petastorm_tpu."))\n'
        'assert not bad, bad\n'
        'print("ok")\n'
    ).format(root=str(tmp_path), package=PACKAGE, banned=BANNED_ROOTS)
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith('ok')


def test_storage_and_failure_model_run_without_the_jax_package(tmp_path):
    """A ``memory://`` store written and read with a fault spec, the
    quarantine, the retrying filesystem, HDFS resolution on a mock and the
    metrics exporter run in a process that never loads JAX or the JAX
    package; the exporter's thread is the port's and ends on ``stop()``."""
    code = (
        'import os, sys, threading, urllib.request, numpy as np\n'
        'from petastorm_tpu_torch import (CompressedImageCodec, ScalarCodec, Unischema,\n'
        '    UnischemaField, faults, make_tensor_reader, metrics, retry, write_dataset)\n'
        'from petastorm_tpu_torch.fs import RetryingFilesystemWrapper, get_filesystem_and_path\n'
        'from petastorm_tpu_torch.hdfs import HdfsNamenodeResolver\n'
        'schema = Unischema("S", [UnischemaField("id", np.int64, (), ScalarCodec(np.int64)),\n'
        '    UnischemaField("image", np.uint8, (8, 8, 3), CompressedImageCodec("png"))])\n'
        'rng = np.random.default_rng(0)\n'
        'write_dataset("memory://pstt-iso", schema, ({{"id": i, "image": rng.integers(0, 256,\n'
        '    (8, 8, 3), dtype=np.uint8)}} for i in range(32)), rows_per_row_group=8)\n'
        'os.environ[faults.ENV_VAR] = "decode-corrupt:p=1:match=parquet"\n'
        'with make_tensor_reader("memory://pstt-iso", error_budget=4, workers_count=2) as r:\n'
        '    assert list(r) == [] and len(r.diagnostics()["quarantined_rowgroups"]) == 4\n'
        'del os.environ[faults.ENV_VAR]\n'
        'fs, path = get_filesystem_and_path("memory://pstt-iso", retries=1)\n'
        'assert isinstance(fs, RetryingFilesystemWrapper) and fs.exists(path)\n'
        'assert HdfsNamenodeResolver({{}}).resolve_hdfs_name_service("x") is None\n'
        'assert retry.RetryPolicy(jitter="none").compute_delay(1) == 0.2\n'
        'exporter = metrics.start_http_exporter(port=0)\n'
        'assert "pst_rowgroups_quarantined_total 4" in urllib.request.urlopen(\n'
        '    exporter.address, timeout=5).read().decode()\n'
        'assert any(t.name == "pstt-metrics-exporter" for t in threading.enumerate())\n'
        'exporter.stop()\n'
        'assert not any(t.name.startswith("pstt-") for t in threading.enumerate())\n'
        'bad = sorted(m for m in sys.modules if m.split(".")[0] in {banned!r}\n'
        '             or m == "petastorm_tpu" or m.startswith("petastorm_tpu."))\n'
        'assert not bad, bad\n'
        'print("ok")\n'
    ).format(banned=BANNED_ROOTS)
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith('ok')


@pytest.mark.parametrize('module', ['metrics', 'faults', 'retry', 'fs', 'hdfs', 'storage'])
def test_new_modules_stand_alone(module):
    """Each module of the storage and failure-model slice imports alone in a
    fresh process without JAX or the JAX package, and reads no variable of
    the JAX package's."""
    path = os.path.join(PACKAGE, module + '.py')
    with open(path) as f:
        assert 'PETASTORM_TPU_' not in f.read()
    code = ('import sys, importlib\n'
            'importlib.import_module("petastorm_tpu_torch.{}")\n'
            'bad = sorted(m for m in sys.modules if m.split(".")[0] in {!r}\n'
            '             or m == "petastorm_tpu" or m.startswith("petastorm_tpu."))\n'
            'assert not bad, bad\n').format(module, BANNED_ROOTS)
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


@pytest.mark.parametrize('module', ['data_service', 'fleet', 'fleet.control_plane', 'fleet.wire',
                                    'tools.serve_cli', 'utils', 'examples.serve_and_train',
                                    'serving', 'serving.row_index', 'serving.placement',
                                    'serving.engine', 'serving.server', 'serving.client',
                                    'fleet.registry', 'fleet.tenancy', 'fleet.autoscaler',
                                    'tools.lookup', 'tools.fleet'])
def test_the_service_tier_imports_no_torch(module):
    """The data service, its fleet layer, the lookup tier, the serve,
    lookup and fleet CLIs and the example's server half import alone
    without torch, JAX or the JAX package: a server process never loads
    the card's runtime."""
    code = ('import sys, importlib\n'
            'importlib.import_module("petastorm_tpu_torch.{}")\n'
            'bad = sorted(m for m in sys.modules if m.split(".")[0] in {!r}\n'
            '             or m == "petastorm_tpu" or m.startswith("petastorm_tpu.")\n'
            '             or m == "torch" or m.startswith("torch."))\n'
            'assert not bad, bad\n').format(module, BANNED_ROOTS)
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


@pytest.mark.parametrize('module', ['analysis', 'analysis.core', 'analysis.lock_order',
                                    'analysis.threads', 'analysis.determinism_taint',
                                    'analysis.bounded_queues', 'analysis.registry',
                                    'analysis.registry_sync', 'analysis.sanitize',
                                    'tools.pstlint', 'generator', 'test_util',
                                    'test_util.reader_mock', 'test_util.shuffling_analysis',
                                    'tf_utils', 'spark_utils', 'tools.spark_session_cli'])
def test_the_last_slice_imports_no_torch_tf_or_spark(module):
    """The lints, the sanitizer, the test utilities and the TF and Spark
    adapters import alone without JAX, the JAX package, torch, TensorFlow
    or pyspark: TensorFlow and pyspark load only when a function needs
    them (the card machine has neither)."""
    code = ('import sys, importlib\n'
            'importlib.import_module("petastorm_tpu_torch.{}")\n'
            'bad = sorted(m for m in sys.modules if m.split(".")[0] in {!r}\n'
            '             or m == "petastorm_tpu" or m.startswith("petastorm_tpu.")\n'
            '             or m.split(".")[0] in ("torch", "tensorflow", "pyspark"))\n'
            'assert not bad, bad\n').format(module, BANNED_ROOTS)
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


def test_the_package_imports_no_tf_or_spark():
    """Importing the package and every module of it loads neither
    TensorFlow nor pyspark."""
    code = ('import pkgutil, sys\n'
            'import petastorm_tpu_torch\n'
            'for m in pkgutil.walk_packages(petastorm_tpu_torch.__path__, "petastorm_tpu_torch."):\n'
            '    __import__(m.name)\n'
            'bad = sorted(m for m in sys.modules\n'
            '             if m.split(".")[0] in ("tensorflow", "pyspark", "keras"))\n'
            'assert not bad, bad[:10]\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


def test_every_jax_module_has_a_port_counterpart():
    """File by file, the port holds every module of the JAX package but
    those left out on purpose (ROADMAP §A): ``jax_loader.py`` is the port's
    ``loader.py``, ``shard_map_compat.py`` is JAX only, and torch's pinned
    host memory replaces ``native/pinned.py``."""
    jax_root = os.path.join(REPO, 'petastorm_tpu')

    def modules(root):
        return {os.path.relpath(os.path.join(d, n), root) for d, _, names in os.walk(root)
                for n in names if n.endswith('.py')}
    missing = sorted(modules(jax_root) - modules(PACKAGE))
    assert missing == ['jax_loader.py', os.path.join('models', 'shard_map_compat.py'),
                       os.path.join('native', 'pinned.py')]
    assert os.path.exists(os.path.join(PACKAGE, 'loader.py'))


def test_no_lookup_or_fleet_thread_survives_stop(tmp_path):
    """A lookup server with REP workers, a scatter-gather client, a
    registry's watch thread and an autoscaler's loop, stopped, leave no
    ``pstt-lookup-*`` or ``pstt-fleet-*`` thread."""
    import time

    from petastorm_tpu_torch.etl.rowgroup_indexers import SingleFieldRowIndexer
    from petastorm_tpu_torch.etl.rowgroup_indexing import build_rowgroup_index
    from petastorm_tpu_torch.fleet.autoscaler import FleetAutoscaler, ScalePolicy, WorkerLauncher
    from petastorm_tpu_torch.fleet.registry import FleetRegistry
    from petastorm_tpu_torch.serving import LookupClient, LookupEngine, LookupServer
    url = 'file://' + str(tmp_path / 'store')
    schema = Unischema('Svc', [UnischemaField('id', np.int64, (), ScalarCodec(np.int64))])
    write_dataset(url, schema, ({'id': i} for i in range(16)), rows_per_row_group=4)
    build_rowgroup_index(url, [SingleFieldRowIndexer('id_row_ix', 'id')])
    with LookupEngine(url) as engine:
        server = LookupServer(engine, 'ipc://' + str(tmp_path / 'l'), rpc_workers=2,
                              lease_s=0.5, job_id='j').start()
        server.init_fleet(n_partitions=4, replication=1)
        with LookupClient([server.rpc_endpoint]) as client:
            client.refresh_partition_map()
            assert [int(rows[0]['id']) for rows in client.lookup(list(range(16)))] == \
                list(range(16))
        registry = FleetRegistry().watch([server.control_endpoint])
        assert registry.wait_for_member('j', timeout_s=10)
        scaler = FleetAutoscaler('j', registry, WorkerLauncher(), policy=ScalePolicy(
            min_workers=1, max_workers=1, interval_s=0.05)).start()
        running = {t.name for t in threading.enumerate()}
        assert {'pstt-lookup-rpc', 'pstt-lookup-lease', 'pstt-lookup-worker-1',
                'pstt-fleet-registry', 'pstt-fleet-autoscaler'} <= running
        scaler.stop()
        registry.stop()
        server.stop()
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        left = [t.name for t in threading.enumerate()
                if t.name.startswith(('pstt-lookup', 'pstt-fleet'))]
        if not left:
            break
        time.sleep(0.05)
    assert not left


def test_no_service_thread_survives_stop(tmp_path):
    """A server and its consumer, stopped, leave no ``pstt-data-service``
    thread."""
    import time

    from petastorm_tpu_torch.data_service import RemoteReader, serve_dataset
    url = 'file://' + str(tmp_path / 'store')
    schema = Unischema('Svc', [UnischemaField('id', np.int64, (), ScalarCodec(np.int64))])
    write_dataset(url, schema, ({'id': i} for i in range(16)), rows_per_row_group=4)
    bind = 'ipc://' + str(tmp_path / 'd')
    with serve_dataset(url, bind, num_epochs=1, seed=0) as server:
        with RemoteReader(server.data_endpoint) as remote:
            assert sorted(int(i) for c in remote for i in c.id) == list(range(16))
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        left = [t.name for t in threading.enumerate() if t.name.startswith('pstt-data-service')]
        if not left:
            break
        time.sleep(0.05)
    assert not left
