"""Offline transcode: fill the decoded-chunk store before training.

    python -m petastorm_tpu_torch.tools.transcode --dataset-url URL --store DIR

Counterpart of ``petastorm_tpu/tools/transcode.py``. Walks every row-group
of a dataset through the tensor decode path into the store
(:mod:`petastorm_tpu_torch.chunk_store`) with the same keys, locks and
write-behind as a training reader, so that a later job's epoch 0 is served
from the store (``decode_s`` = 0). The write-behind drops writes when its
queue overflows, so one pass is no guarantee: the tool walks the dataset
again until a pass serves every row-group from the store, or
``--max-passes`` is spent. The store's format is the JAX package's, so
either package's training reader can use it.

It prints one JSON report line::

    {"row_groups": 12, "passes": 2, "writes": 12, "preexisting": 0,
     "bytes_written": 123456, "complete": true, ...}

and exits 0 when the last pass was all hits, 1 otherwise.
"""

import argparse
import json
import sys

#: A deeper write-behind queue than a training reader's: the spill is the
#: job here.
_ETL_WRITER_QUEUE_DEPTH = 64


def transcode_dataset(dataset_url, store_path, schema_fields=None, workers_count=4, max_passes=4,
                      flush_timeout_s=300.0, size_limit=None):
    """Fill ``store_path`` with every decoded chunk of ``dataset_url``;
    returns the report (see the module docstring). ``schema_fields``
    narrows the fields: the key holds the field set, so a job reading
    other fields misses."""
    from petastorm_tpu_torch import make_tensor_reader

    report = {'dataset_url': dataset_url, 'store': store_path, 'passes': 0, 'row_groups': None,
              'writes': 0, 'write_races': 0, 'preexisting': 0, 'bytes_written': 0,
              'unstorable': 0, 'complete': False}
    for _ in range(max_passes):
        report['passes'] += 1
        reader = make_tensor_reader(
            dataset_url, schema_fields=schema_fields, reader_pool_type='thread',
            workers_count=workers_count, shuffle_row_groups=False, num_epochs=1,
            cache_type='chunk-store', cache_location=store_path, cache_size_limit=size_limit,
            cache_extra_settings={'writer_queue_depth': _ETL_WRITER_QUEUE_DEPTH})
        store = reader.chunk_store
        try:
            for _ in reader:
                pass
            # A pass counts once its queued writes are on disk.
            flushed = store.flush(timeout_s=flush_timeout_s)
            stats = store.stats()
        finally:
            reader.stop()
            reader.join()
        report['row_groups'] = stats['hits'] + stats['misses']
        report['writes'] += stats['writes']
        report['write_races'] += stats['write_races']
        report['bytes_written'] += stats['bytes_written']
        report['unstorable'] = stats['unstorable']
        if report['passes'] == 1:
            # Entries an earlier transcode or training job published.
            report['preexisting'] = stats['hits']
        if stats['unstorable']:
            break       # object fields never store: narrow schema_fields
        if flushed and stats['misses'] == 0:
            report['complete'] = True
            break
    return report


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog='python -m petastorm_tpu_torch.tools.transcode',
        description='Fill the decoded-chunk store so that training decodes no JPEG')
    parser.add_argument('--dataset-url', required=True, help='dataset URL (file://...)')
    parser.add_argument('--store', required=True,
                        help='chunk-store directory (what training passes as cache_location or '
                             'PSTT_CHUNK_STORE)')
    parser.add_argument('--fields', nargs='*', default=None,
                        help='fields to transcode (default: all; the key holds the field set)')
    parser.add_argument('--workers', type=int, default=4)
    parser.add_argument('--max-passes', type=int, default=4,
                        help='passes until one is all hits (dropped writes heal on later passes)')
    parser.add_argument('--size-limit', type=int, default=None,
                        help='store byte cap (oldest entries go past it; a cap below the '
                             'dataset never completes)')
    args = parser.parse_args(argv)
    report = transcode_dataset(args.dataset_url, args.store, schema_fields=args.fields,
                               workers_count=args.workers, max_passes=args.max_passes,
                               size_limit=args.size_limit)
    print(json.dumps(report))
    return 0 if report['complete'] else 1


if __name__ == '__main__':
    sys.exit(main())
