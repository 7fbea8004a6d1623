"""The port's TensorFlow adapter against the JAX package's: ``tf_tensors``
and ``make_petastorm_dataset`` over the port's readers give the JAX
versions' elements, batch for batch, on one store; the converter's
``make_tf_dataset`` and the ``'tf'``/``'tensor'`` read methods of
``reader_throughput``. Skipped without TensorFlow, as the JAX package's
``tests/test_tf_tensors.py`` is."""

import numpy as np
import pytest

tf = pytest.importorskip('tensorflow')

import petastorm_tpu as jax_pst  # noqa: E402
from petastorm_tpu import tf_utils as jax_tf_utils  # noqa: E402
from petastorm_tpu_torch import make_batch_reader, make_reader, make_tensor_reader  # noqa: E402
from petastorm_tpu_torch import tf_utils  # noqa: E402

FIELDS = ['id', 'id2', 'matrix', 'sensor_name', 'image_png']


def _elements(dataset):
    return [{name: np.asarray(value) for name, value in element._asdict().items()}
            for element in dataset.as_numpy_iterator()]


def _assert_same(port, jax):
    assert len(port) == len(jax) > 0
    for a, b in zip(port, jax):
        assert sorted(a) == sorted(b)
        for name in a:
            assert a[name].dtype == b[name].dtype, name
            np.testing.assert_array_equal(a[name], b[name])


@pytest.mark.parametrize('factory', ['row', 'tensor'])
def test_make_petastorm_dataset_equals_jax(synthetic_dataset, factory):
    port_factory = make_reader if factory == 'row' else make_tensor_reader
    jax_factory = jax_pst.make_reader if factory == 'row' else jax_pst.make_tensor_reader
    kwargs = dict(schema_fields=FIELDS, reader_pool_type='dummy', shuffle_row_groups=False)
    with port_factory(synthetic_dataset.url, **kwargs) as reader:
        port = _elements(tf_utils.make_petastorm_dataset(reader))
    with jax_factory(synthetic_dataset.url, **kwargs) as reader:
        jax = _elements(jax_tf_utils.make_petastorm_dataset(reader))
    _assert_same(port, jax)
    assert sorted(int(e['id']) for e in port if e['id'].ndim == 0) == \
        (list(range(50)) if factory == 'row' else [])


def test_make_petastorm_dataset_over_a_plain_store_equals_jax(scalar_dataset):
    kwargs = dict(schema_fields=['id', 'float_col', 'int_fixed'], reader_pool_type='dummy',
                  shuffle_row_groups=False)
    with make_batch_reader(scalar_dataset.url, **kwargs) as reader:
        port = _elements(tf_utils.make_petastorm_dataset(reader))
    with jax_pst.make_batch_reader(scalar_dataset.url, **kwargs) as reader:
        jax = _elements(jax_tf_utils.make_petastorm_dataset(reader))
    _assert_same(port, jax)
    assert sum(len(e['id']) for e in port) == scalar_dataset.table.num_rows


def test_eager_mode_rejected(synthetic_dataset):
    with make_reader(synthetic_dataset.url, reader_pool_type='dummy') as reader:
        with pytest.raises(RuntimeError, match='make_petastorm_dataset'):
            tf_utils.tf_tensors(reader)


def _graph_rows(module, factory, url, n):
    with tf.Graph().as_default():
        with factory(url, schema_fields=['id', 'matrix'], reader_pool_type='dummy',
                     shuffle_row_groups=False) as reader:
            sample = module.tf_tensors(reader)
            assert sample.matrix.shape.as_list() == [4, 5]
            with tf.compat.v1.Session() as sess:
                return [sess.run(sample) for _ in range(n)]


def test_graph_mode_reads_the_rows_jax_reads(synthetic_dataset):
    port = _graph_rows(tf_utils, make_reader, synthetic_dataset.url, 50)
    jax = _graph_rows(jax_tf_utils, jax_pst.make_reader, synthetic_dataset.url, 50)
    assert [int(r.id) for r in port] == [int(r.id) for r in jax]
    assert sorted(int(r.id) for r in port) == list(range(50))
    for a, b in zip(port, jax):
        np.testing.assert_array_equal(a.matrix, b.matrix)


def test_graph_mode_shuffling_queue(synthetic_dataset):
    with tf.Graph().as_default():
        with make_reader(synthetic_dataset.url, schema_fields=['id'], reader_pool_type='thread',
                         workers_count=2, num_epochs=None, seed=0) as reader:
            sample = tf_utils.tf_tensors(reader, shuffling_queue_capacity=30,
                                         min_after_dequeue=10)
            with tf.compat.v1.Session() as sess:
                coord = tf.train.Coordinator()
                threads = tf.compat.v1.train.start_queue_runners(sess=sess, coord=coord)
                ids = [int(sess.run(sample).id) for _ in range(40)]
                coord.request_stop()
                coord.join(threads, stop_grace_period_secs=5, ignore_live_threads=True)
    assert len(ids) == 40 and ids != sorted(ids)


def test_batched_reader_shuffling_rejected(scalar_dataset):
    with tf.Graph().as_default():
        with make_batch_reader(scalar_dataset.url, reader_pool_type='dummy') as reader:
            with pytest.raises(ValueError, match='batched'):
                tf_utils.tf_tensors(reader, shuffling_queue_capacity=10)


def test_sanitized_types_equal_jax():
    import datetime
    import decimal
    row = {'d': decimal.Decimal('1.5'), 'u16': np.arange(3, dtype=np.uint16),
           'u32': np.uint32(7), 'when': datetime.date(2020, 1, 2),
           'stamps': np.array(['2020-01-01'], dtype='datetime64[D]')}
    port = tf_utils._sanitize_field_tf_types(row)
    jax = jax_tf_utils._sanitize_field_tf_types(row)
    for name in row:
        assert type(port[name]) is type(jax[name]), name
        np.testing.assert_array_equal(port[name], jax[name])
    with pytest.raises(RuntimeError, match='None'):
        tf_utils._sanitize_field_tf_types({'x': None})


def test_converter_make_tf_dataset_equals_jax(tmp_path):
    import pyarrow as pa
    from petastorm_tpu.converter import make_converter as jax_make_converter
    from petastorm_tpu_torch.converter import make_converter
    table = pa.table({'x': np.arange(40, dtype=np.int64),
                      'y': np.linspace(0, 1, 40).astype(np.float32)})
    port_conv = make_converter(table, parent_cache_dir_url='file://' + str(tmp_path / 'p'))
    jax_conv = jax_make_converter(table, parent_cache_dir_url='file://' + str(tmp_path / 'j'))
    try:
        kwargs = dict(batch_size=8, num_epochs=1, workers_count=1, shuffle_row_groups=False)
        with port_conv.make_tf_dataset(**kwargs) as dataset:
            port = _elements(dataset)
        with jax_conv.make_tf_dataset(**kwargs) as dataset:
            jax = _elements(dataset)
    finally:
        port_conv.delete()
        jax_conv.delete()
    _assert_same(port, jax)
    assert np.concatenate([e['x'].reshape(-1) for e in port]).tolist() == list(range(40))


@pytest.mark.parametrize('read_method', ['tf', 'tensor'])
def test_reader_throughput_read_methods(synthetic_dataset, read_method):
    from petastorm_tpu_torch.benchmark.throughput import READ_METHODS, reader_throughput
    assert set(READ_METHODS) == {'python', 'torch', 'tensor', 'tf'}
    result = reader_throughput(synthetic_dataset.url, field_regex=['id', 'matrix'],
                               warmup_cycles_count=5, measure_cycles_count=20,
                               pool_type='thread', loaders_count=1, read_method=read_method)
    assert result.samples_per_second > 0 and result.time_mean > 0
