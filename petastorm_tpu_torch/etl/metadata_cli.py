"""Metadata tools (counterpart of ``petastorm_tpu/etl/metadata_cli.py``)::

    python -m petastorm_tpu_torch.etl.metadata_cli generate URL [--unischema-class M.S]
    python -m petastorm_tpu_torch.etl.metadata_cli print URL [--index]

``generate`` (re)writes a store's ``_common_metadata``: the schema given as
a ``module.attribute`` path, else the stored one (a reference petastorm
store's pickled schema is rewritten as the port's JSON), else one inferred
from the Arrow schema, with the row-group counts. ``print`` prints the
schema, the row-group count and, with ``--index``, the row-group indexes.
"""

import argparse
import importlib
import json
import sys

from petastorm_tpu_torch.etl.dataset_metadata import infer_or_load_unischema
from petastorm_tpu_torch.etl.writer import finalize_dataset_metadata
from petastorm_tpu_torch.storage import ROWGROUP_INDEX_KEY, ParquetStore


def generate_metadata(dataset_url, unischema_class=None):
    """Write the store's schema and row-group counts; returns the schema."""
    store = ParquetStore(dataset_url)
    if unischema_class:
        module_path, _, attr = unischema_class.rpartition('.')
        schema = getattr(importlib.import_module(module_path), attr)
    else:
        schema = infer_or_load_unischema(store)
    finalize_dataset_metadata(store, schema, partition_fields=tuple(store.partition_names))
    return schema


def print_metadata(dataset_url, show_index=False):
    store = ParquetStore(dataset_url)
    print(infer_or_load_unischema(store))
    print('{} row-groups in {} files'.format(len(store.row_groups()), len(store.files)))
    if show_index:
        blob = store.common_metadata_value(ROWGROUP_INDEX_KEY)
        if blob is None:
            print('No row-group indexes stored')
        else:
            for name, index in json.loads(blob.decode('utf-8')).items():
                print('index {!r} on field {!r}: {} values'.format(
                    name, index.get('field'), len(index.get('values', {}))))


def main(argv=None):
    parser = argparse.ArgumentParser(description='Write or inspect a store\'s metadata')
    commands = parser.add_subparsers(dest='command', required=True)
    generate = commands.add_parser('generate', help='(re)write _common_metadata')
    generate.add_argument('dataset_url')
    generate.add_argument('--unischema-class', default=None,
                          help='the schema object to store, e.g. mypkg.schema.MySchema')
    show = commands.add_parser('print', help='print the schema and row-group count')
    show.add_argument('dataset_url')
    show.add_argument('--index', '--print-values', action='store_true', dest='show_index')
    args = parser.parse_args(argv)
    if args.command == 'generate':
        schema = generate_metadata(args.dataset_url, args.unischema_class)
        print('Wrote metadata for schema {!r}'.format(schema.name))
    else:
        print_metadata(args.dataset_url, show_index=args.show_index)
    return 0


if __name__ == '__main__':
    sys.exit(main())
