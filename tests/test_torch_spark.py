"""The port's Spark adapters without a Spark session, against the JAX
package's: ``spark_utils`` imports without pyspark and a call raises a
clear error (as ``tests/test_spark_utils.py`` holds for the JAX package),
the session CLI's flags, and ``materialize_dataset(spark, url, schema)``,
which blesses files the body wrote with the same metadata the JAX
package's writes."""

import argparse
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from petastorm_tpu import codecs as jax_codecs
from petastorm_tpu import unischema as jax_unischema
from petastorm_tpu.etl.dataset_metadata import materialize_dataset as jax_materialize_dataset
from petastorm_tpu.tools import spark_session_cli as jax_cli
from petastorm_tpu_torch import codecs, make_reader, unischema
from petastorm_tpu_torch.etl.dataset_metadata import get_schema_from_dataset_url, \
    materialize_dataset
from petastorm_tpu_torch.storage import UNISCHEMA_KEY
from petastorm_tpu_torch.tools import spark_session_cli


def _pyspark_missing():
    try:
        import pyspark  # noqa: F401
    except ImportError:
        return True
    return False


def test_module_imports_without_pyspark():
    import sys

    import petastorm_tpu_torch.spark_utils  # noqa: F401
    if _pyspark_missing():
        assert 'pyspark' not in sys.modules


def test_dataset_as_rdd_requires_pyspark(synthetic_dataset):
    if not _pyspark_missing():
        pytest.skip('pyspark installed; gating not exercised')
    from petastorm_tpu.spark_utils import dataset_as_rdd as jax_dataset_as_rdd
    from petastorm_tpu_torch.spark_utils import dataset_as_rdd
    with pytest.raises(ImportError, match='pyspark') as port:
        dataset_as_rdd(synthetic_dataset.url, spark_session=None)
    with pytest.raises(ImportError, match='pyspark') as jax:
        jax_dataset_as_rdd(synthetic_dataset.url, spark_session=None)
    assert str(port.value) == str(jax.value)


class _FakeBuilder(object):
    def __init__(self):
        self.calls = []

    def master(self, m):
        self.calls.append(('master', m))
        return self

    def config(self, k, v):
        self.calls.append(('config', k, v))
        return self


def test_spark_session_cli_args_equal_jax():
    argv = ['--master', 'local[2]', '--spark-session-config', 'a.b=1', 'c.d=x']
    port_args = spark_session_cli.add_configure_spark_arguments(
        argparse.ArgumentParser()).parse_args(argv)
    jax_args = jax_cli.add_configure_spark_arguments(argparse.ArgumentParser()).parse_args(argv)
    assert vars(port_args) == vars(jax_args)
    port = spark_session_cli.configure_spark(_FakeBuilder(), port_args).calls
    assert port == jax_cli.configure_spark(_FakeBuilder(), jax_args).calls
    assert ('master', 'local[2]') in port and ('config', 'c.d', 'x') in port
    bad = spark_session_cli.add_configure_spark_arguments(
        argparse.ArgumentParser()).parse_args(['--spark-session-config', 'noequals'])
    with pytest.raises(ValueError):
        spark_session_cli.configure_spark(_FakeBuilder(), bad)
    if _pyspark_missing():
        with pytest.raises(ImportError, match='pyspark'):
            spark_session_cli.create_spark_session(port_args)


class _FakeSpark(object):
    """Stands in for a SparkSession: records the row-group size it is given."""

    def __init__(self):
        self.block_sizes = []
        outer = self

        class _Conf(object):
            def setInt(self, key, value):
                outer.block_sizes.append((key, value))

        class _Jsc(object):
            def hadoopConfiguration(self):
                return _Conf()

        class _Context(object):
            _jsc = _Jsc()

        self.sparkContext = _Context()


def _schema(unischema_mod, codecs_mod):
    return unischema_mod.Unischema('SparkSchema', [
        unischema_mod.UnischemaField('id', np.int64, (), codecs_mod.ScalarCodec(np.int64), False),
        unischema_mod.UnischemaField('score', np.float32, (), codecs_mod.ScalarCodec(np.float32),
                                     False)])


def _spark_write(path):
    """What ``df.write.parquet(url)`` leaves: part files, no metadata."""
    os.makedirs(path)
    table = pa.table({'id': np.arange(30, dtype=np.int64),
                      'score': np.linspace(0, 1, 30).astype(np.float32)})
    pq.write_table(table.slice(0, 15), os.path.join(path, 'part-00000.parquet'), row_group_size=5)
    pq.write_table(table.slice(15), os.path.join(path, 'part-00001.parquet'), row_group_size=5)


def test_materialize_dataset_with_a_session_equals_jax(tmp_path):
    port_path, jax_path = str(tmp_path / 'port'), str(tmp_path / 'jax')
    port_spark, jax_spark = _FakeSpark(), _FakeSpark()
    with materialize_dataset(port_spark, 'file://' + port_path, _schema(unischema, codecs),
                             row_group_size_mb=4) as yielded:
        assert yielded is None
        _spark_write(port_path)
    with jax_materialize_dataset(jax_spark, 'file://' + jax_path,
                                 _schema(jax_unischema, jax_codecs), row_group_size_mb=4):
        _spark_write(jax_path)
    assert port_spark.block_sizes == jax_spark.block_sizes == [('parquet.block.size', 4 << 20)]
    port_meta = pq.read_schema(os.path.join(port_path, '_common_metadata')).metadata
    jax_meta = pq.read_schema(os.path.join(jax_path, '_common_metadata')).metadata
    assert port_meta[UNISCHEMA_KEY] == jax_meta[UNISCHEMA_KEY]
    assert list(get_schema_from_dataset_url('file://' + port_path).fields) == ['id', 'score']
    with make_reader('file://' + port_path, reader_pool_type='dummy',
                     shuffle_row_groups=False) as reader:
        assert sorted(int(row.id) for row in reader) == list(range(30))


def test_materialize_dataset_refuses_a_session_without_a_schema(tmp_path):
    with pytest.raises(ValueError, match='requires a schema'):
        with materialize_dataset(_FakeSpark(), 'file://' + str(tmp_path / 's')):
            pass


def test_materialize_dataset_still_takes_a_url_first(tmp_path):
    url = 'file://' + str(tmp_path / 'w')
    with materialize_dataset(url, _schema(unischema, codecs), rows_per_row_group=4) as writer:
        for i in range(6):
            writer.write({'id': i, 'score': np.float32(i)})
    with make_reader(url, reader_pool_type='dummy', shuffle_row_groups=False) as reader:
        assert [int(row.id) for row in reader] == list(range(6))
