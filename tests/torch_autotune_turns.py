"""Phase 26 of ``chip_smoke.py`` (``imagenet_autotune``) in turns on one
card: the imagenet store, imagenet_scan for its state, one imagenet_decode
(a) run to warm the decode path (the first after imagenet_scan reads cold),
then per turn a thread-pool imagenet_decode (a) run and
``chip_smoke.run_autotune`` against it. Every line is kept, a failed
check's too (the phase prints its line before it fails), and the last line
counts the turns and those under the 0.90 check, so the pass rate over
turns reads from one file::

    python tests/torch_autotune_turns.py OUT.jsonl TURNS [--root TREE] [--ticks]

The cell swings with the shared host, so it is judged over turns, not one.
``--root`` runs another tree's package and ``chip_smoke.py`` (the parent's,
unpacked with ``git archive``), so two trees compare on one card: run the
script once a tree in turns (P C C P) within one call.
``--ticks`` adds a line a turn with every tick of the convergence tuner:
its time, class, the batches the tick counted and the decision it took.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _log_ticks(autotune, log):
    """Wrap ``AutoTuner.tick`` so every tick of every tuner lands in
    ``log[tuner]``: (seconds, class, batches counted, action or None)."""
    tick = autotune.AutoTuner.tick

    def logged(self, now=None):
        before = (self._prev or {}).get('batches')
        decision = tick(self, now)
        after = (self._prev or {}).get('batches')
        t = (self._prev_t or 0.0) - (self._t0 or 0.0)
        log.setdefault(id(self), []).append(
            (round(t, 3), self.last_class,
             None if before is None or after is None else after - before,
             decision['action'] if decision else None))
        return decision
    autotune.AutoTuner.tick = logged


def main(out_path, turns, root=ROOT, ticks=False):
    sys.path.insert(0, root)
    import torch

    import chip_smoke
    from petastorm_tpu_torch import autotune, bench
    from petastorm_tpu_torch.models import make_scan_train_step
    tick_log = {}
    if ticks:
        _log_ticks(autotune, tick_log)

    out = open(out_path, 'w')

    def emit(obj):
        line = json.dumps(obj)
        print(line[:800], flush=True)
        out.write(line + '\n')
        out.flush()
    bench.emit = emit

    device = torch.device('cuda', 0)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True).stdout.strip()
    card = '{} ({})'.format(torch.cuda.get_device_name(0), smi)
    t0 = time.perf_counter()
    os.makedirs(os.path.join(ROOT, '.torch_build'), exist_ok=True)
    store_dir = tempfile.mkdtemp(dir=os.path.join(ROOT, '.torch_build'))
    emit({'root': os.path.relpath(root, ROOT), 'card': card})
    url = bench.write_imagenet_store(os.path.join(store_dir, 'imagenet'))
    scan, state = bench.run_imagenet_scan(url, device, card, calls=11)
    emit({k: scan[k] for k in ('phase', 'img_per_s', 'device_step_ms', 'input_stall_frac')})

    def decode_a():
        train = make_scan_train_step(bench.SCAN_K, preprocess=bench.normalize_bf16)
        decode, _ = bench.stream_classifier_scan(url, device, train, state, 3, 11,
                                                 ('normalize_kernel',), cache_type='null',
                                                 workers=8)
        emit({'decode_a': {k: decode[k] for k in ('img_per_s', 'device_step_ms',
                                                  'input_stall_frac')},
              't': time.perf_counter() - t0})
        return decode

    decode_a()                  # the decode path's first run after imagenet_scan reads cold
    under = 0
    for turn in range(turns):
        decode = decode_a()
        tick_log.clear()
        try:
            line = chip_smoke.run_autotune(url, device, card, state, scan, decode)
            line['turn'] = turn
            emit(line)
        except AssertionError as e:
            emit({'turn': turn, 'failed': str(e)[:2000], 't': time.perf_counter() - t0})
            under += 'under 0.9' in str(e)
        if ticks:
            # The convergence tuner is the phase's first.
            emit({'turn': turn, 'ticks': next(iter(tick_log.values()), [])})
    emit({'root': os.path.relpath(root, ROOT), 'turns': turns, 'under_090': under})
    shutil.rmtree(store_dir, ignore_errors=True)
    print('turns done', time.perf_counter() - t0)
    return 0


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('out')
    parser.add_argument('turns', type=int)
    parser.add_argument('--root', default=ROOT, help='the tree whose package and script run')
    parser.add_argument('--ticks', action='store_true', help='log every tick of the tuner')
    args = parser.parse_args()
    sys.exit(main(args.out, args.turns, os.path.abspath(args.root), args.ticks))
