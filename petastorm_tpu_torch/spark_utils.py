"""Spark helpers (optional — pyspark is not part of the TPU-VM stack).

Parity: reference ``petastorm/spark_utils.py:23-52`` (``dataset_as_rdd``:
decoded dataset rows as an RDD of namedtuples). Import of pyspark is deferred
so the module is importable everywhere; calling without pyspark raises a
clear error.
"""


def dataset_as_rdd(dataset_url, spark_session, schema_fields=None,
                   storage_options=None, max_partitions=64):
    """An RDD of decoded namedtuple rows from a materialized dataset.

    :param max_partitions: cap on Spark partitions (default 64; pass ``None``
        for one partition per row-group). When the cap truncates, each task
        reads ``n_pieces / max_partitions`` row-groups single-threaded — a
        log line records the truncation.

    Each Spark partition opens its own single-threaded reader over one shard
    of the row-groups — decode happens on the executors, like the reference's
    per-executor piece reads.
    """
    try:
        import pyspark  # noqa: F401
    except ImportError:
        raise ImportError('dataset_as_rdd requires pyspark; install it or use '
                          'make_reader directly')

    if max_partitions is not None and max_partitions < 1:
        raise ValueError('max_partitions must be >= 1 or None, got {!r}'
                         .format(max_partitions))

    from petastorm_tpu_torch.etl.dataset_metadata import get_schema_from_dataset_url
    from petastorm_tpu_torch.storage import ParquetStore

    schema = get_schema_from_dataset_url(dataset_url, storage_options)
    n_pieces = len(ParquetStore(dataset_url, storage_options).row_groups())
    n_partitions = max(1, n_pieces)
    if max_partitions is not None and n_partitions > max_partitions:
        import logging
        logging.getLogger(__name__).info(
            'dataset_as_rdd: capping %d row-groups to %d partitions '
            '(~%d row-groups per task); raise max_partitions to spread wider',
            n_pieces, max_partitions, -(-n_pieces // max_partitions))
        n_partitions = max_partitions

    field_names = None
    if schema_fields is not None:
        field_names = [f if isinstance(f, str) else f.name for f in schema_fields]

    def read_shard(shard):
        from petastorm_tpu_torch.reader import make_reader
        with make_reader(dataset_url, schema_fields=field_names,
                         reader_pool_type='dummy', shuffle_row_groups=False,
                         cur_shard=shard, shard_count=n_partitions,
                         storage_options=storage_options) as reader:
            for row in reader:
                yield row

    sc = spark_session.sparkContext
    _ = schema  # schema load validates the store before the job is launched
    return sc.parallelize(range(n_partitions), n_partitions).flatMap(
        lambda shard: read_shard(shard))
