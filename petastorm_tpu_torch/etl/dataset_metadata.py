"""Stored-schema access and schema inference (counterpart of
``petastorm_tpu/etl/dataset_metadata.py:31-119``).

The schema lives as JSON under ``petastorm_tpu.unischema.v1`` in the
store's ``_common_metadata``, the key the JAX package writes and reads. A
store written by the reference petastorm holds a pickled schema under
``dataset-toolkit.unischema.v1`` instead, which :func:`get_schema` reads
through :mod:`~petastorm_tpu_torch.etl.legacy`. A plain Parquet store has
neither; :func:`infer_or_load_unischema` infers its schema from the Arrow
schema (the ``make_batch_reader`` path).
"""

import json
import logging
from contextlib import contextmanager

from petastorm_tpu_torch.errors import PetastormMetadataError
from petastorm_tpu_torch.storage import UNISCHEMA_KEY, ParquetStore
from petastorm_tpu_torch.unischema import Unischema

logger = logging.getLogger(__name__)


def get_schema(store):
    """The Unischema stored in ``_common_metadata`` (the port's JSON, else
    the reference's pickle); raises ``PetastormMetadataError`` if neither."""
    blob = store.common_metadata_value(UNISCHEMA_KEY)
    if blob is None:
        from petastorm_tpu_torch.etl.legacy import LEGACY_UNISCHEMA_KEY, load_legacy_unischema
        legacy_blob = store.common_metadata_value(LEGACY_UNISCHEMA_KEY)
        if legacy_blob is not None:
            return load_legacy_unischema(legacy_blob)
        if not store.fs.exists(store.path):
            raise IOError('Dataset path does not exist: {}'.format(store.url))
        raise PetastormMetadataError(
            'Dataset at {} has no petastorm_tpu schema metadata. Either materialize it with '
            'DatasetWriter/materialize_dataset, regenerate its metadata with python -m '
            'petastorm_tpu_torch.etl.metadata_cli, or read it with make_batch_reader (schema '
            'inference).'.format(store.url))
    return Unischema.from_json(json.loads(blob.decode('utf-8')))


def get_schema_from_dataset_url(dataset_url, storage_options=None):
    """:func:`get_schema` of the store at ``dataset_url`` (``storage_options``:
    the fsspec driver's keyword arguments)."""
    return get_schema(ParquetStore(dataset_url, storage_options))


def infer_or_load_unischema(store, omit_unsupported_fields=True):
    """The stored schema if there is one, else one inferred from the Arrow
    schema, hive partition columns included."""
    try:
        return get_schema(store)
    except PetastormMetadataError:
        logger.debug('Dataset %s has no stored unischema; inferring from Arrow schema',
                     store.url)
        return Unischema.from_arrow_schema(store.read_arrow_schema(),
                                           partition_columns=store.partition_names,
                                           omit_unsupported_fields=omit_unsupported_fields)


@contextmanager
def materialize_dataset(spark_or_url, dataset_url_or_schema=None, schema=None,
                        row_group_size_mb=None, rows_per_row_group=None, partition_fields=(),
                        storage_options=None):
    """Materialization context manager in the JAX package's two flavours
    (``petastorm_tpu/etl/dataset_metadata.py:75``).

    **A URL first** — yields a :class:`~petastorm_tpu_torch.etl.writer.DatasetWriter`::

        with materialize_dataset('file:///tmp/ds', schema, rows_per_row_group=64) as w:
            w.write({'id': 0, 'image': ...})

    The metadata is written only when the body ends without an exception:
    a store left half-written is not blessed as complete.

    **A SparkSession first** — ``materialize_dataset(spark, url, schema)``
    yields None; the body writes the Parquet files itself (``df.write.
    parquet(url)``), and on exit the metadata is generated over what it
    wrote. ``row_group_size_mb`` sets the session's ``parquet.block.size``.
    """
    from petastorm_tpu_torch.etl.writer import DatasetWriter, finalize_dataset_metadata

    if not isinstance(spark_or_url, str):
        dataset_url = dataset_url_or_schema
        if schema is None:
            raise ValueError('materialize_dataset(spark, url, schema) requires a schema')
        _configure_spark_row_group_size(spark_or_url, row_group_size_mb)
        yield None
        finalize_dataset_metadata(ParquetStore(dataset_url, storage_options), schema,
                                  partition_fields=partition_fields)
        return
    the_schema = dataset_url_or_schema if schema is None else schema
    if the_schema is None:
        raise ValueError('materialize_dataset(url, schema) requires a schema')
    writer = DatasetWriter(spark_or_url, the_schema, row_group_size_mb=row_group_size_mb,
                           rows_per_row_group=rows_per_row_group,
                           partition_fields=partition_fields, storage_options=storage_options)
    yield writer
    writer.close()


def _configure_spark_row_group_size(spark, row_group_size_mb):
    """Best effort: Hadoop's ``parquet.block.size`` on the session."""
    if row_group_size_mb is None:
        return
    try:
        hadoop_conf = spark.sparkContext._jsc.hadoopConfiguration()
        hadoop_conf.setInt('parquet.block.size', row_group_size_mb * 1024 * 1024)
    except Exception:  # noqa: BLE001 - depends on the JVM's internals
        logger.warning('Could not set parquet.block.size on the Spark session')
