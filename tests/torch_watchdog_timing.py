"""Times the parts of the watchdog's check on the card, over runs of the
setup of ``test_torch_cuda.py::test_watchdog_check_returns_during_a_card_sleep``:
a 60-row PNG store, a 2-thread tensor reader, a loader with
``watchdog=True``, one batch, then a ~2 s sleep of the card and one
``Watchdog.check`` with every heartbeat made stale.

Timed on the host clock: the flight recorder's sample, ``registry.stalled``,
the beat table, each probe, the stall classification,
``StallDiagnosis.capture`` and the stack walk it makes, the recoveries and
the warning's log call; then, after the check, the formatting of the stacks
(which a check that formats at capture has already paid). A tree whose
capture calls ``dump_all_stacks`` (walk and format at once) is timed too,
so two trees compare on one card::

    python tests/torch_watchdog_timing.py --runs 25 [--root TREE] [--out FILE]

prints a JSON line a run and one of medians and maxima. ``--root`` is the
tree whose ``petastorm_tpu_torch`` is timed (default: this checkout). The
card test drives :func:`time_watchdog_check` with a few runs.
"""

import argparse
import json
import os
import sys
import tempfile
import threading
import time

PARTS = ('flight_recorder_sample', 'stalled', 'beat_table', 'probe_snapshot', 'classify_stall',
         'capture', 'stack_walk', 'recoveries', 'log_warning')


def _timed(times, key, fn):
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            times[key] = times.get(key, 0.0) + time.perf_counter() - t0
    return wrapper


def _store(workdir):
    import numpy as np
    from petastorm_tpu_torch import (CompressedImageCodec, ScalarCodec, Unischema,
                                     UnischemaField, write_dataset)
    schema = Unischema('CardSchema', [
        UnischemaField('image', np.uint8, (16, 16, 3), CompressedImageCodec('png')),
        UnischemaField('label', np.int64, (), ScalarCodec(np.int64))])
    rng = np.random.default_rng(3)
    url = 'file://' + os.path.join(workdir, 'store')
    write_dataset(url, schema, ({'image': rng.integers(0, 256, (16, 16, 3), dtype=np.uint8),
                                 'label': i} for i in range(60)), rows_per_row_group=12)
    return url


def time_watchdog_check(device, runs, workdir):
    """``runs`` timed checks on ``device``; returns a row a run (seconds a
    part, ``check_s``, ``stats_s``, ``rest_s`` = the check less its parts,
    the thread count, whether the card was busy at the check, and the
    classification) and the summary (medians, maxima, runs at or over the
    card test's 0.05 s bound)."""
    import numpy as np
    import torch
    from petastorm_tpu_torch import TorchLoader, health, make_tensor_reader

    url = _store(workdir)
    # The stack walk capture makes: a walk alone, or walk and format at once.
    walk_name = 'snapshot_stacks' if hasattr(health, 'snapshot_stacks') else 'dump_all_stacks'
    saved = (health.classify_stall, health.StallDiagnosis.__dict__['capture'],
             getattr(health, walk_name), health.logger.warning)
    rows = []
    try:
        for _ in range(runs):
            times = {}
            health.classify_stall = _timed(times, 'classify_stall', saved[0])
            health.StallDiagnosis.capture = classmethod(_timed(times, 'capture',
                                                               saved[1].__func__))
            setattr(health, walk_name, _timed(times, 'stack_walk', saved[2]))
            health.logger.warning = _timed(times, 'log_warning', saved[3])
            with make_tensor_reader(url, workers_count=2, num_epochs=None, seed=0) as reader:
                with TorchLoader(reader, 8, device=device, watchdog=True,
                                 stall_timeout_s=30) as loader:
                    next(loader)
                    dog = loader._health.watchdog
                    registry = dog._registry
                    for name in ('stalled', 'beat_table', 'probe_snapshot'):
                        setattr(registry, name, _timed(times, name, getattr(registry, name)))
                    registry._probes = {name: _timed(times, 'probe:' + name, fn)
                                        for name, fn in registry._probes.items()}
                    registry._recoveries = {
                        c: [_timed(times, 'recoveries', fn) for fn in fns]
                        for c, fns in registry._recoveries.items()}
                    if dog._flight_recorder is not None:
                        dog._flight_recorder.sample = _timed(times, 'flight_recorder_sample',
                                                             dog._flight_recorder.sample)
                    threads = threading.active_count()
                    torch.cuda._sleep(4_000_000_000)      # ~2 s at the H100's ~1.98 GHz
                    t0 = time.perf_counter()
                    diagnosis = dog.check(now=time.monotonic() + 1000.0)
                    check_s = time.perf_counter() - t0
                    t0 = time.perf_counter()
                    loader.stats
                    stats_s = time.perf_counter() - t0
                    busy = not torch.cuda.current_stream(device).query()
                    t0 = time.perf_counter()
                    stacks = ('' if diagnosis is None else diagnosis.stacks_text()
                              if hasattr(diagnosis, 'stacks_text') else diagnosis['stacks'])
                    times['format_stacks'] = time.perf_counter() - t0
                    torch.cuda.synchronize(device)
            parts = sum(v for k, v in times.items() if k in PARTS and k != 'stack_walk')
            rows.append(dict(times, check_s=check_s, stats_s=stats_s, rest_s=check_s - parts,
                             threads=threads, busy=busy, stacks_chars=len(stacks),
                             classification=diagnosis and diagnosis['classification']))
    finally:
        (health.classify_stall, health.StallDiagnosis.capture) = saved[:2]
        setattr(health, walk_name, saved[2])
        health.logger.warning = saved[3]
    keys = sorted({k for row in rows for k, v in row.items() if isinstance(v, float)})
    summary = {'runs': runs, 'stack_walk': walk_name,
               'median_s': {k: float(np.median([row.get(k, 0.0) for row in rows])) for k in keys},
               'max_s': {k: max(row.get(k, 0.0) for row in rows) for k in keys},
               'over_bound': sum(row['check_s'] >= 0.05 for row in rows)}
    return rows, summary


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--runs', type=int, default=25)
    parser.add_argument('--root', default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    parser.add_argument('--out', default=None, help='also write the lines to this file')
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    os.environ.pop('PSTT_AUTOTUNE', None)
    import subprocess

    import torch
    if not torch.cuda.is_available():
        print('torch_watchdog_timing: needs a CUDA device', file=sys.stderr)
        return 2
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as workdir:
        rows, summary = time_watchdog_check(torch.device('cuda', 0), args.runs, workdir)
    lines = [dict(row, run=i) for i, row in enumerate(rows)]
    lines.append(dict(summary, card=smi, root=os.path.abspath(args.root)))
    for line in lines:
        print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, 'w') as f:
            f.writelines(json.dumps(line) + '\n' for line in lines)
    return 0


if __name__ == '__main__':
    sys.exit(main())
