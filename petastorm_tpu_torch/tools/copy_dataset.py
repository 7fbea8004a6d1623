"""Copy a stored dataset, or a subset of it (counterpart of
``petastorm_tpu/tools/copy_dataset.py``)::

    python -m petastorm_tpu_torch.tools.copy_dataset SOURCE_URL TARGET_URL \\
        [--field-regex R ...] [--not-null-fields F ...] [--rows-per-row-group N]
        [--row-group-size-mb M] [--partition-fields F ...]

Rows are read in storage order by a deterministic ``make_reader`` (fields
matching the regexes, rows whose ``--not-null-fields`` are all set) and
written in that order by the port's ``DatasetWriter`` with the source's
schema (or its view); the JAX tool's thread pool interleaves row-groups.
The source may be a reference petastorm store; the copy carries the port's
metadata.
"""

import argparse
import sys

from petastorm_tpu_torch.etl.dataset_metadata import get_schema_from_dataset_url
from petastorm_tpu_torch.etl.writer import DatasetWriter
from petastorm_tpu_torch.predicates import in_lambda
from petastorm_tpu_torch.reader import make_reader


def copy_dataset(source_url, target_url, field_regex=None, not_null_fields=None,
                 rows_per_row_group=None, row_group_size_mb=None, partition_fields=()):
    """Copy the rows; returns how many were copied."""
    schema = get_schema_from_dataset_url(source_url)
    if field_regex:
        schema = schema.create_schema_view(field_regex)
    predicate = None
    if not_null_fields:
        predicate = in_lambda(list(not_null_fields),
                              lambda *values: all(v is not None for v in values))
    copied = 0
    # Deterministic mode: the threads' rows come out in storage order.
    with make_reader(source_url, schema_fields=list(schema.fields), predicate=predicate,
                     shuffle_row_groups=False, deterministic=True) as reader:
        with DatasetWriter(target_url, schema, rows_per_row_group=rows_per_row_group,
                           row_group_size_mb=row_group_size_mb,
                           partition_fields=partition_fields) as writer:
            for row in reader:
                writer.write(row._asdict())
                copied += 1
    return copied


def main(argv=None):
    parser = argparse.ArgumentParser(description='Copy a stored dataset')
    parser.add_argument('source_url')
    parser.add_argument('target_url')
    parser.add_argument('--field-regex', nargs='+', default=None)
    parser.add_argument('--not-null-fields', nargs='+', default=None)
    parser.add_argument('--rows-per-row-group', type=int, default=None)
    parser.add_argument('--row-group-size-mb', type=int, default=None)
    parser.add_argument('--partition-fields', nargs='+', default=())
    args = parser.parse_args(argv)
    count = copy_dataset(args.source_url, args.target_url, field_regex=args.field_regex,
                         not_null_fields=args.not_null_fields,
                         rows_per_row_group=args.rows_per_row_group,
                         row_group_size_mb=args.row_group_size_mb,
                         partition_fields=tuple(args.partition_fields))
    print('Copied {} rows'.format(count))
    return 0


if __name__ == '__main__':
    sys.exit(main())
