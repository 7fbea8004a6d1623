"""Spark-session argparse plumbing for CLIs (optional pyspark).

Parity: reference ``petastorm/tools/spark_session_cli.py:19-50``
(``--master`` / ``--spark-session-config key=val`` flags +
``configure_spark``).
"""


def add_configure_spark_arguments(parser):
    """Add ``--master`` and ``--spark-session-config`` to an ArgumentParser."""
    parser.add_argument('--master', type=str, default='local[*]',
                        help='Spark master (default local[*])')
    parser.add_argument('--spark-session-config', type=str, nargs='*', default=[],
                        help='Extra spark conf entries as key=value pairs')
    return parser


def configure_spark(builder, args):
    """Apply parsed CLI args onto a ``SparkSession.Builder``."""
    builder = builder.master(args.master)
    for entry in args.spark_session_config:
        key, sep, value = entry.partition('=')
        if not sep:
            raise ValueError('--spark-session-config entries must be key=value, '
                             'got {!r}'.format(entry))
        builder = builder.config(key, value)
    return builder


def create_spark_session(args, app_name='petastorm_tpu_torch'):
    """Build a SparkSession from CLI args (requires pyspark)."""
    try:
        from pyspark.sql import SparkSession
    except ImportError:
        raise ImportError('create_spark_session requires pyspark')
    return configure_spark(SparkSession.builder.appName(app_name), args).getOrCreate()
