"""The metrics registry: the port's against the JAX package's. The same
instrument operations give the same ``collect()`` snapshot and the same
Prometheus text; ``aggregate_snapshots`` folds alike; the port registers
only names the JAX package registers, with the same help and labels; and
its HTTP exporter serves on 127.0.0.1 and stops."""

import glob
import json
import os
import re
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

import petastorm_tpu_torch
from petastorm_tpu import metrics as jax_metrics
from petastorm_tpu_torch import metrics


def _drive(mod, ops):
    """Run ``ops`` on a fresh registry of ``mod``; returns it."""
    registry = mod.MetricsRegistry()
    for op in ops:
        op(registry)
    return registry


def _counters(r):
    c = r.counter('pst_c_total', 'help text')
    c.inc()
    c.inc(4)
    r.counter('pst_retries_total', 'Retried operations, by retry-loop name',
              labelnames=('op',)).labels('exists').inc(2)


def _gauges(r):
    g = r.gauge('pst_g', 'a gauge')
    g.set(3.5)
    g.inc(2)
    g.dec(0.5)
    lag = r.gauge('pst_lineage_ledger_lag', 'lag', labelnames=('ledger',))
    lag.labels('a').set(1)
    lag.labels('b').set_function(lambda: 7)
    lag.labels('c').set(9)
    lag.remove('c')


def _histograms(r):
    h = r.histogram('pst_decode_seconds', 'Row-group decode latency inside workers')
    for v in (0.00005, 0.0003, 0.02, 0.02, 1.5, 100.0):
        h.observe(v)
    sized = r.histogram('pst_sizes_bytes', 'sizes', labelnames=('pool',),
                        buckets=metrics.DEFAULT_SIZE_BUCKETS)
    sized.labels('arena').observe(5000)
    sized.labels('queue').observe(1 << 30)


def _escapes(r):
    r.counter('pst_escape_total', 'multi\nline \\ help',
              labelnames=('path',)).labels('a"b\\c\nd').inc()


SCENARIOS = {'counters': [_counters], 'gauges': [_gauges], 'histograms': [_histograms],
             'escapes': [_escapes], 'all': [_counters, _gauges, _histograms, _escapes]}


@pytest.mark.parametrize('scenario', sorted(SCENARIOS))
def test_same_operations_render_the_same_text(scenario):
    port = _drive(metrics, SCENARIOS[scenario])
    jax = _drive(jax_metrics, SCENARIOS[scenario])
    assert port.collect() == jax.collect()
    assert port.render_text() == jax.render_text()
    assert metrics.render_text(jax.collect()) == jax_metrics.render_text(port.collect())


def test_buckets_are_the_jax_packages():
    assert metrics.DEFAULT_LATENCY_BUCKETS == jax_metrics.DEFAULT_LATENCY_BUCKETS
    assert metrics.DEFAULT_SIZE_BUCKETS == jax_metrics.DEFAULT_SIZE_BUCKETS


def test_aggregate_snapshots_fold_alike():
    def snapshot(mod, n):
        r = mod.MetricsRegistry()
        r.counter('pst_a_total', labelnames=('op',)).labels('x').inc(n)
        r.histogram('pst_l_seconds', buckets=(1.0,)).observe(0.5 * n)
        r.gauge('pst_depth').set(n)
        if n == 5:
            r.counter('pst_only_five_total').inc()
        return r.collect()

    port = metrics.aggregate_snapshots([snapshot(metrics, 2), snapshot(metrics, 5), None])
    jax = jax_metrics.aggregate_snapshots([snapshot(jax_metrics, 2), snapshot(jax_metrics, 5),
                                           None])
    assert port == jax
    assert port['pst_a_total']['samples'][0]['value'] == 7
    assert 'pst_a_total{op="x"} 7' in metrics.render_text(port)


def test_conflicts_and_bad_names_are_refused_alike():
    for mod in (metrics, jax_metrics):
        r = mod.MetricsRegistry()
        r.counter('pst_x_total', labelnames=('a',))
        with pytest.raises(ValueError):
            r.gauge('pst_x_total')
        with pytest.raises(ValueError):
            r.counter('pst_x_total', labelnames=('b',))
        with pytest.raises(ValueError):
            r.counter('pst bad name')
        with pytest.raises(ValueError):
            r.counter('pst_y_total').inc(-1)
        with pytest.raises(ValueError):
            r.counter('pst_x_total', labelnames=('a',)).labels('1', '2')


def test_write_textfile_atomic(tmp_path):
    r = _drive(metrics, [_counters])
    path = str(tmp_path / 'pst.prom')
    assert r.write_textfile(path) == path
    with open(path) as f:
        assert f.read() == r.render_text()
    assert os.listdir(str(tmp_path)) == ['pst.prom']


def test_scrape_endpoint_lifecycle():
    r = metrics.MetricsRegistry()
    r.counter('pst_scrape_total').inc(9)
    exporter = metrics.start_http_exporter(port=0, registry=r)
    try:
        assert exporter.address.startswith('http://127.0.0.1:')
        assert any(t.name == metrics.THREAD_NAME for t in threading.enumerate())
        reply = urllib.request.urlopen(exporter.address, timeout=5)
        assert reply.status == 200
        assert 'text/plain' in reply.headers['Content-Type']
        assert reply.read().decode() == r.render_text()
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen('http://127.0.0.1:{}/nope'.format(exporter.port), timeout=5)
    finally:
        exporter.stop()
    assert not any(t.name == metrics.THREAD_NAME for t in threading.enumerate())
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(exporter.address, timeout=1)
    with metrics.MetricsExporter(registry=r) as again:
        assert 'pst_scrape_total 9' in urllib.request.urlopen(
            again.address, timeout=5).read().decode()


def test_set_registry_swaps_and_restores():
    fresh = metrics.MetricsRegistry()
    previous = metrics.set_registry(fresh)
    try:
        assert metrics.get_registry() is fresh
        metrics.counter('pst_swap_total').inc()
        assert fresh.collect()['pst_swap_total']['samples'][0]['value'] == 1
    finally:
        assert metrics.set_registry(previous) is fresh
    assert 'pst_swap_total' not in metrics.get_registry().collect()


def _names(root, extra=()):
    paths = glob.glob(os.path.join(root, '**', '*.py'), recursive=True) + list(extra)
    names = set()
    for path in paths:
        with open(path) as f:
            text = f.read()
        names.update(re.findall(r"['\"](pst_[a-z0-9_]+)['\"]", text))
        fmt = re.search(r"['\"](pst_[a-z0-9_]*)\{\}([a-z0-9_]*)['\"][\s\S]{0,200}?"
                        r"for name in \(([^)]+)\)", text)
        if fmt:
            prefix, suffix, body = fmt.groups()
            names.update('{}{}{}'.format(prefix, item, suffix)
                         for item in re.findall(r"'([a-z0-9_]+)'", body))
    return names


def test_the_port_registers_only_the_jax_packages_names():
    import petastorm_tpu
    port_root = os.path.dirname(petastorm_tpu_torch.__file__)
    # Exposition names of a histogram's series count as the histogram's.
    port = {re.sub(r'_(count|sum|bucket)$', '', n) if n.endswith(('_count', '_sum', '_bucket'))
            else n for n in _names(port_root)}
    jax = _names(os.path.dirname(petastorm_tpu.__file__))
    assert port and not (port - jax), sorted(port - jax)


def _pipeline_snapshot(tmp_path, torch_side):
    """One tensor-reader epoch through each package's loader on a fresh
    registry: the snapshot."""
    from petastorm_tpu_torch import (CompressedImageCodec, ScalarCodec, TorchLoader, Unischema,
                                     UnischemaField, make_tensor_reader, write_dataset)
    url = 'file://' + str(tmp_path / 'store')
    if not os.path.exists(str(tmp_path / 'store')):
        # int32: the JAX loader narrows int64, which would change its bytes.
        schema = Unischema('M', [UnischemaField('id', np.int32, (), ScalarCodec(np.int32)),
                                 UnischemaField('image', np.uint8, (8, 8, 3),
                                                CompressedImageCodec('jpeg', 90))])
        rng = np.random.default_rng(0)
        write_dataset(url, schema, ({'id': i, 'image': rng.integers(0, 256, (8, 8, 3),
                                                                     dtype=np.uint8)}
                                    for i in range(40)), rows_per_row_group=8)
    mod = metrics if torch_side else jax_metrics
    previous = mod.set_registry(mod.MetricsRegistry())
    try:
        if torch_side:
            with make_tensor_reader(url, workers_count=2, shuffle_row_groups=False) as reader:
                with TorchLoader(reader, 10, device='cpu') as loader:
                    batches = sum(1 for _ in loader)
        else:
            from petastorm_tpu import make_tensor_reader as jax_reader
            from petastorm_tpu.jax_loader import JaxLoader
            with jax_reader(url, workers_count=2, shuffle_row_groups=False) as reader:
                with JaxLoader(reader, 10) as loader:
                    batches = sum(1 for _ in loader)
        return batches, mod.get_registry().collect()
    finally:
        mod.set_registry(previous)


def test_loader_run_populates_the_jax_packages_instruments(tmp_path):
    batches, port = _pipeline_snapshot(tmp_path, True)
    jax_batches, jax = _pipeline_snapshot(tmp_path, False)
    assert batches == jax_batches == 4
    for name in ('pst_loader_batches_total', 'pst_staged_bytes_total',
                 'pst_decode_batch_calls_total', 'pst_decode_batch_images_total'):
        assert port[name]['samples'] == jax[name]['samples'], name
        assert port[name]['help'] == jax[name]['help']
    for name in ('pst_batch_wait_seconds', 'pst_assemble_seconds', 'pst_dispatch_seconds',
                 'pst_decode_seconds'):
        assert port[name]['help'] == jax[name]['help']
        assert port[name]['samples'][0]['count'] == jax[name]['samples'][0]['count'], name
    assert port['pst_decode_batch_images_total']['samples'][0]['value'] == 40
    json.dumps(port)


def test_opencv_batched_route_counts_as_a_batched_call(monkeypatch):
    """Without the native codec the batched decode is OpenCV's, one call a
    row-group over the decode threads; it counts as a batched call (the JAX
    package counts native calls only: ROADMAP §C)."""
    from petastorm_tpu_torch import codecs
    from petastorm_tpu_torch.codecs import CompressedImageCodec
    from petastorm_tpu_torch.unischema import UnischemaField
    if codecs.cv2 is None:
        pytest.skip('OpenCV is not installed')
    monkeypatch.setattr(codecs, '_native_image', lambda: None)
    field = UnischemaField('image', np.uint8, (8, 8, 3), CompressedImageCodec('png'))
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (6, 8, 8, 3), dtype=np.uint8)
    blobs = [field.codec.encode(field, img) for img in images]
    previous = metrics.set_registry(metrics.MetricsRegistry())
    try:
        for threads in (1, 3):
            out = np.empty((6, 8, 8, 3), np.uint8)
            assert codecs.decode_image_batch_into(field, out, blobs.__getitem__,
                                                  decode_threads=threads) == 0
            assert np.array_equal(out, images)
        snap = metrics.get_registry().collect()
    finally:
        metrics.set_registry(previous)
    assert snap['pst_decode_batch_calls_total']['samples'][0]['value'] == 2
    assert snap['pst_decode_batch_images_total']['samples'][0]['value'] == 12
