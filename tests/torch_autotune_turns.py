"""Phase 26 of ``chip_smoke.py`` (``imagenet_autotune``) in turns on one
card: the imagenet store, imagenet_scan for its state, then per turn a
thread-pool imagenet_decode (a) run and ``chip_smoke.run_autotune`` beside
it. Every line is kept, a failed check's too (the phase prints its line
before it fails), so the pass rate over turns reads from one file::

    python tests/torch_autotune_turns.py OUT.jsonl TURNS [--root TREE] [--ticks]

The cell swings with the shared host, so it is judged over turns, not one.
``--root`` runs another tree's package and ``chip_smoke.py`` (the parent's,
unpacked with ``git archive``), so two trees compare on one card.
``--ticks`` adds a line a turn with every tick of the convergence tuner:
its time, class, the batches the tick counted and the decision it took.

``--alternate`` compares two references of phase 26's 0.90 check in
windows taken in turns (P, C, C, P, ...): a P window holds the autotune run
against the decode (a) rate measured once at the start with phase 20's
protocol (3 + 11 + 11 calls), as ``chip_smoke.py`` does; a C window against
a decode (a) rate measured just before it (:func:`_decode_a_window`, 3 + 3 +
3 calls). Each window's line carries ``arm`` and ``ratio``; the last line
counts the failures of the 0.90 check in each arm.
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


def _decode_a_window(chip_smoke, bench, url, device, state):
    """imagenet_decode (a) measured again just before a C window: the same
    store, state and hand-set pool (``DECODE_WORKERS`` threads, ``null``
    cache), ``chip_smoke.EARLY_CALLS`` counted and timed calls. Returns the
    path's line."""
    import torch
    from petastorm_tpu_torch.models import make_scan_train_step

    train = make_scan_train_step(bench.SCAN_K, preprocess=bench.normalize_bf16)
    result, window = bench.stream_classifier_scan(
        url, device, train, state, 3, chip_smoke.EARLY_CALLS, ('normalize_kernel',),
        cache_type='null', workers=chip_smoke.DECODE_WORKERS)
    bench.require_scan_launches(*window[:3], ('normalize_images',), bench.SCAN_K, window[3])
    del train
    torch.cuda.empty_cache()
    return result


def _alternate(chip_smoke, url, device, card, state, scan, decode_a, turns, emit, store_dir, t0):
    """``--alternate``: ``turns`` windows of each arm in the order P, C, C, P."""
    from petastorm_tpu_torch import bench
    stale = decode_a()
    arms = [('P', 'C') if i % 2 == 0 else ('C', 'P') for i in range(turns)]
    failed = {'P': 0, 'C': 0}
    windows = {'P': 0, 'C': 0}
    for turn, pair in enumerate(arms):
        for arm in pair:
            if arm == 'P':
                reference = stale
            else:
                w0 = time.perf_counter()
                reference = _decode_a_window(chip_smoke, bench, url, device, state)
                emit({'phase': 'decode_a_window', 'img_per_s': reference['img_per_s'],
                      'seconds': time.perf_counter() - w0})
            windows[arm] += 1
            try:
                line = chip_smoke.run_autotune(url, device, card, state, scan, reference)
                ok = True
            except AssertionError as e:
                line, ok = {'failed': str(e)[:2000]}, False
                failed[arm] += 1
            rate = line.get('img_per_s')
            emit({'turn': turn, 'arm': arm, 'ok': ok, 'img_per_s': rate,
                  'reference_img_per_s': reference['img_per_s'],
                  'ratio': rate / reference['img_per_s'] if rate else None,
                  'failed': line.get('failed'), 't': time.perf_counter() - t0})
    emit({'alternate': {'windows': windows, 'failed_090': failed}})
    shutil.rmtree(store_dir, ignore_errors=True)
    print('turns done', time.perf_counter() - t0)
    return 0


def main(out_path, turns, root=ROOT, ticks=False, alternate=False):
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

    if alternate:
        return _alternate(chip_smoke, url, device, card, state, scan, decode_a, turns, emit,
                          store_dir, t0)
    for turn in range(turns):
        decode = decode_a()
        tick_log.clear()
        try:
            line = chip_smoke.run_autotune(url, device, card, state, scan, decode)
            line['turn'] = turn
            emit(line)
        except AssertionError as e:
            emit({'turn': turn, 'failed': str(e)[:2000], 't': time.perf_counter() - t0})
        if ticks:
            # The convergence tuner is the phase's first.
            emit({'turn': turn, 'ticks': next(iter(tick_log.values()), [])})
    shutil.rmtree(store_dir, ignore_errors=True)
    print('turns done', time.perf_counter() - t0)
    return 0


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('out')
    parser.add_argument('turns', type=int)
    parser.add_argument('--root', default=ROOT, help='the tree whose package and script run')
    parser.add_argument('--ticks', action='store_true', help='log every tick of the tuner')
    parser.add_argument('--alternate', action='store_true',
                        help='windows of the stale and the fresh decode (a) reference in turns')
    args = parser.parse_args()
    sys.exit(main(args.out, args.turns, os.path.abspath(args.root), args.ticks, args.alternate))
