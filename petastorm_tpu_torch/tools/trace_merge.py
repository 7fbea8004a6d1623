"""Merge per-process trace sidecars into one Chrome trace JSON
(counterpart of ``petastorm_tpu/tools/trace_merge.py``)::

    python -m petastorm_tpu_torch.tools.trace_merge --dir /tmp/pstt-trace \\
        --out /tmp/pipeline.json --summary

A run traced with ``PSTT_TRACE_DIR`` leaves one ``trace-<pid>-<uid>.jsonl``
sidecar a process; either package's sidecars merge. Torn trailing lines (a
process killed mid-write) are skipped. ``--summary`` adds the per-span
count/total/p50/p99 digest to the JSON report on stdout. Exit codes: 0
merged, 1 no sidecar in the directory, 2 a usage error (no directory).
"""

import argparse
import json
import os
import sys


def main(argv=None):
    from petastorm_tpu_torch.trace import TRACE_DIR_ENV, Tracer

    parser = argparse.ArgumentParser(
        prog='python -m petastorm_tpu_torch.tools.trace_merge',
        description='Merge per-process trace sidecar (JSONL) files from a finished run into one '
                    'Chrome trace JSON.')
    parser.add_argument('--dir', dest='spill_dir', default=os.environ.get(TRACE_DIR_ENV),
                        help='sidecar directory (default: ${})'.format(TRACE_DIR_ENV))
    parser.add_argument('--out', dest='out_path', default=None,
                        help='output trace path (default: <dir>/merged_trace.json)')
    parser.add_argument('--summary', action='store_true',
                        help='also print the per-span count/total/p50/p99 digest as JSON')
    args = parser.parse_args(argv)

    if not args.spill_dir:
        parser.error('no sidecar directory: pass --dir or set {}'.format(TRACE_DIR_ENV))
    if not os.path.isdir(args.spill_dir):
        parser.error('not a directory: {!r}'.format(args.spill_dir))
    out_path = args.out_path or os.path.join(args.spill_dir, 'merged_trace.json')

    # spill_dir=False: the merge must not add a sidecar of its own.
    tracer = Tracer(spill_dir=False, role='trace-merge')
    merged = tracer.merge_process_files(args.spill_dir)
    if merged == 0:
        print('no sidecar files under {!r}'.format(args.spill_dir), file=sys.stderr)
        return 1
    tracer.export_chrome_trace(out_path)
    report = {'merged_files': merged, 'events': len(tracer.events), 'out': out_path}
    if args.summary:
        report['summary'] = tracer.summary()
    print(json.dumps(report, indent=1))
    return 0


if __name__ == '__main__':
    sys.exit(main())
