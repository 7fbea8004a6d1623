"""``python -m petastorm_tpu_torch.tools.replay``: re-materialise one
ledgered batch (counterpart of ``petastorm_tpu/tools/replay.py``).

The command line of :func:`petastorm_tpu_torch.lineage.replay_record`:
given a provenance ledger directory (``PSTT_LINEAGE_DIR`` of the training
run, or a loader's ``lineage=`` directory) and a batch id, it reopens the
dataset, re-reads exactly the recorded row-group spans, re-applies the
recorded slices, permutations and dtype rule, and writes (or only checks)
the batch the training loop saw::

    python -m petastorm_tpu_torch.tools.replay --ledger /nvme/lineage \\
        --batch-id 41237 --verify --out /tmp/batch41237.npz

``--verify`` holds the replay bit for bit against the record's per-field
CRC32 digests (exit 3 on a mismatch: the dataset or the decode changed
since the run). ``--print-record`` prints the raw record. Exit codes: 0
ok, 1 a usage or lookup error, 2 not replayable (an inexact record, a
transform, an unsupported mode), 3 a digest mismatch.

``--diff-ledgers A B`` compares two runs' ledgers batch by batch (their
per-field digests) and reports the first batch id where they diverge: the
place to start when a ``deterministic=True`` resume that should be bit
for bit the same splits from its original. Exit 0 when the ids both hold
match, 3 on a divergence, 1 when a ledger is empty or unreadable.
"""

import argparse
import json
import os
import sys


def _ledger_digests(path):
    """batch_id -> (digest dict, rows) over every ledger under ``path`` (a
    directory or one file)."""
    from petastorm_tpu_torch import lineage

    if os.path.isfile(path):
        _, records = lineage.read_ledger_file(path)
    else:
        records = [r for _, _, recs in lineage.read_ledger_dir(path) for r in recs]
    out = {}
    for record in records:
        batch_id = record.get('batch_id')
        if batch_id is not None:
            out[batch_id] = (record.get('digest'), record.get('rows'))
    return out


def diff_ledgers(path_a, path_b):
    """Compare two ledgers' digest sequences: a JSON-safe report with
    ``diverged`` (the first differing batch id, or None) and the coverage;
    ``LookupError`` when either holds no record."""
    a, b = _ledger_digests(path_a), _ledger_digests(path_b)
    if not a:
        raise LookupError('no ledger records under {!r}'.format(path_a))
    if not b:
        raise LookupError('no ledger records under {!r}'.format(path_b))
    common = sorted(set(a) & set(b))
    diverged = None
    detail = None
    for batch_id in common:
        if a[batch_id] != b[batch_id]:
            diverged = batch_id
            digest_a, rows_a = a[batch_id]
            digest_b, rows_b = b[batch_id]
            fields = sorted(set(digest_a or {}) | set(digest_b or {}))
            detail = {'fields_differing': [f for f in fields
                                           if (digest_a or {}).get(f) != (digest_b or {}).get(f)],
                      'rows_a': rows_a, 'rows_b': rows_b}
            break
    return {'a': str(path_a), 'b': str(path_b),
            'records_a': len(a), 'records_b': len(b),
            'common_batches': len(common),
            'common_range': [common[0], common[-1]] if common else None,
            'only_in_a': len(set(a) - set(b)),
            'only_in_b': len(set(b) - set(a)),
            'diverged': diverged,
            'divergence': detail}


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog='python -m petastorm_tpu_torch.tools.replay',
        description='Deterministically re-materialize one batch from a provenance ledger')
    parser.add_argument('--ledger', help='ledger directory (PSTT_LINEAGE_DIR of the run) or a '
                                         'single ledger-*.jsonl file')
    parser.add_argument('--batch-id', type=int,
                        help='the batch to re-materialize (record batch_id)')
    parser.add_argument('--diff-ledgers', nargs=2, metavar=('A', 'B'),
                        help='compare two runs\' ledgers and report the first batch id whose '
                             'per-field digests diverge (exit 3 on divergence)')
    parser.add_argument('--pid', type=int, default=None,
                        help='producing process pid, to disambiguate when several pipelines '
                             'ledgered into one directory')
    parser.add_argument('--verify', action='store_true',
                        help='assert the replay bit-identical against the record\'s CRC32 '
                             'content digest (exit 3 on mismatch)')
    parser.add_argument('--out', default=None, help='write the replayed batch as a .npz file')
    parser.add_argument('--print-record', action='store_true',
                        help='dump the raw record JSON instead of a summary')
    args = parser.parse_args(argv)

    if args.diff_ledgers:
        try:
            report = diff_ledgers(*args.diff_ledgers)
        except LookupError as e:
            print('replay: {}'.format(e), file=sys.stderr)
            return 1
        print(json.dumps(report))
        return 3 if report['diverged'] is not None else 0

    if args.ledger is None or args.batch_id is None:
        parser.error('--ledger and --batch-id are required (or use --diff-ledgers A B)')

    from petastorm_tpu_torch import lineage

    try:
        if os.path.isfile(args.ledger):
            ctx, records = lineage.read_ledger_file(args.ledger)
            matches = [r for r in records
                       if r.get('batch_id') == args.batch_id
                       and (args.pid is None or r.get('pid') == args.pid)]
            if not matches:
                ids = sorted(r.get('batch_id') for r in records)
                raise LookupError('batch_id {} not in {} (ids {}..{}, {} records)'.format(
                    args.batch_id, args.ledger, ids[0] if ids else '-',
                    ids[-1] if ids else '-', len(ids)))
            record = matches[0]
        else:
            ctx, record = lineage.find_record(args.ledger, args.batch_id, pid=args.pid)
    except LookupError as e:
        print('replay: {}'.format(e), file=sys.stderr)
        return 1

    if args.print_record:
        print(json.dumps({'ctx': ctx, 'record': record}, indent=1))
        if not (args.verify or args.out):
            return 0

    try:
        if args.verify:
            batch = lineage.verify_record(record, ctx)
        else:
            batch = lineage.replay_record(record, ctx)
    except lineage.ReplayMismatchError as e:
        print('replay: DIGEST MISMATCH: {}'.format(e), file=sys.stderr)
        return 3
    except lineage.ReplayError as e:
        print('replay: not replayable: {}'.format(e), file=sys.stderr)
        return 2

    if args.out:
        import numpy as np
        np.savez(args.out, **batch)

    summary = {
        'batch_id': record.get('batch_id'),
        'rows': record.get('rows'),
        'padded': record.get('padded', 0),
        'fields': {name: {'shape': list(arr.shape), 'dtype': str(arr.dtype)}
                   for name, arr in batch.items()},
        'segments': len(record.get('segments') or []),
        'tiers': sorted({s.get('tier') for s in record.get('segments') or []}),
        'verified': bool(args.verify),
        'out': args.out,
    }
    print(json.dumps(summary))
    return 0


if __name__ == '__main__':
    sys.exit(main())
