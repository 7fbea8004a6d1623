#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``petastorm_tpu_torch``) end to end on one GPU.

    python3 chip_smoke.py [--steps N] [--out FILE]

Phases, each printing one JSON line; any failure ends the script with a
non-zero exit and no result line:

1. device: the card's name and power limit.
2. kernels: every kernel of both paths is built from this checkout (the
   Triton normalize kernel, cached under ``.torch_build/``; the two CUDA
   C++ flash-attention libraries, the Hopper route's and the WMMA route's,
   each compiled by ``nvcc`` into ``.torch_build/kernels/``, both builds
   started in the background at once), launched at the main paths' shapes
   and held against its plain PyTorch version; its time, the plain
   version's, a PyTorch library call's where one exists, and the bound for
   the card. Every time is device time; an entry's ``host_bound`` lists
   the times that may hold host time as well (see :func:`time_ms`). The
   Hopper forward, dQ and dK/dV are also timed
   against the WMMA kernels they replace on the LM path (``previous_ms``,
   in turns, same inputs; the WMMA kernels are checked against the plain
   versions too), with their registers and spills from ``build.log``, and
   are checked and timed again at the bench's ``flashattn`` shape
   ([32, 8192, 128] bf16 causal), and checked and timed beside SDPA at
   lm_long's shape ([16, 8192, 64]). The WMMA kernels are also checked in
   f32 at a small shape, causal and not, with T not a multiple of a tile.
3. checks: the loader's first batch against an independent decode of the
   store, the ResNet-50 forward on the card against the CPU, and the
   TransformerLM (f32, flash kernels, 2 layers) on the card against the CPU;
   the flash kernels non-causal at ViT's T = 197 against the plain
   versions and a 2-layer ViT with flash attention against dense (bf16);
   the MoE TransformerLM (f32, 2 layers, 4 experts) on the card against
   the CPU.
   Also ``check_scan_graph``: ResNetTiny (bf16, K1 preprocess) and a
   2-layer TransformerLM at the lm widths (flash, bf16, head dim 64), each
   trained 3 calls of K = 4 steps from one state through the captured CUDA
   graph of ``make_scan_train_step`` / ``make_lm_scan_train_step`` and as
   K calls of the one-step trainer on the microbatch slices; losses and
   params compared (LM: exact; ResNet: rtol 1e-2, atol 1e-3, cuDNN's
   backward may sum with atomics), and call 2's metrics must survive call 3.
4. imagenet: an ImageNet-shaped JPEG Parquet store (2048 rows, 224x224x3,
   q90, int64 label, 256-row groups) is written with the port's writer,
   read by ``make_tensor_reader`` (4 threads), loaded by ``TorchLoader``
   (batch 128, pinned arenas), augmented by ``imagenet_train_augment`` and
   fed to ResNet-50 SGD steps (bf16 autocast, channels_last), one eager
   step a call.
5. imagenet_scan: the bench's ``_child_imagenet`` protocol
   (``bench.py:1792-1966``): the reader with ``cache_type='memory'``
   (endless, seed 0), ``TorchLoader(batch=128, prefetch=8)``,
   ``loader.superbatches(8)``, ResNet-50 through ``make_scan_train_step(8,
   preprocess=K1 normalize -> bf16)``: call 1 eager, call 2 captures the
   8-step CUDA graph, every later call replays it; 3 warm-up calls (more
   than one epoch, so the cache is warm), then 11 measured (the bench: 5;
   see ``SCAN_CALLS``).
6. imagenet_hbm: ``_measure_device_cache`` (``bench.py:2109-2176``): a
   one-epoch reader fills a ``DeviceDatasetCache``; superbatches of 8
   carried across epoch boundaries through a scan step of its own (its own
   capture) on the state imagenet_scan trained: epoch 1 warms up, epochs
   2 to 17 are measured.
7. imagenet_chunkstore: imagenet_scan's protocol on the same state, the
   reader with ``cache_type='chunk-store'`` (a fresh store under
   ``.torch_build/``: epoch 0 decodes and spills, later epochs are read from
   the mapped entries, whose writes are flushed before the timed calls);
   img/s, ``decode_s`` of the timed calls (must be 0), the store's
   counters, K1 8 times a replay. Then an in-order pass of a fresh store
   (4 workers, resequenced): a new reader's epoch 1, served from the store,
   must give epoch 0's (decoded) per-field CRC32 digests batch for batch;
   and ``tools.transcode`` fills another store whose epoch 0 decodes
   nothing.
8. imagenet_hbm_partial: ``DeviceDatasetCache(partial=True, max_bytes=160e6,
   superbatch_batches=4)`` filled from the transcoded store (deterministic
   chunk-store reader), with ``loader_factory`` a fresh such reader and
   loader: 8 of the 16 batches stay resident in two runs, 8 stream each
   epoch. A memory governor is installed before the cache; after a
   partial window (1 warm-up, 6 counted, 6 timed epochs through a scan
   step of its own) a ballast pool drives one ``check()`` to degrade, which
   evicts the coldest run (the card's allocated bytes fall by the run's),
   and a second window trains on 4 resident batches. K1 8 times a replay
   in each window; every epoch's multiset of per-row image digests equals
   the fill epoch's.
9. lm: the bench's token store (``bench.py:130-157``: 2048 rows of 1025
   int32 tokens, vocab 32768, 256-row groups) is written with the port's
   writer, read and loaded (batch 8) and fed to SGD steps (lr 0.01,
   momentum 0.9) of ``TransformerLM`` (d 512, 8 heads, 8 layers, bf16,
   ``attention='flash'``), as the bench's ``lm`` child configures it; its
   attention (bf16, head dim 64) must run the Hopper forward, dQ and dK/dV,
   8 launches each a step.
10. lm_scan: the ``lm`` child's protocol (``bench.py:160-306``): the token
   reader with ``cache_type='memory'``, ``TorchLoader(batch=64)``, the same
   model through ``make_lm_scan_train_step(8)`` (one CUDA graph replay a
   call of 8 steps of batch 8); 2 warm-up calls, then 6 measured, as the
   bench.
11. imagenet_vit: the ``imagenet_vit`` child (``bench.py:2511-2515``):
   ``ViT(num_classes=1000)`` (patch 16, d 384, 6 heads, 8 layers, dense
   attention, bf16) behind the bench's bare cast (``float() / 255``),
   batch 128, K = 8, SGD lr 0.1 momentum 0.9; streamed from the memory
   cache (2 warm-up and 2 measured calls), then from the HBM tier through a
   scan step of its own (epoch 1 warm-up, 4 epochs counted).
12. imagenet_aug: the ``imagenet_aug`` child (``bench.py:2553-2557``) on
   the HBM tier: the ResNet-50 state of imagenet_hbm trained (b) through
   the bare cast, from a copy of the state, and (a) through
   ``imagenet_train_augment`` (f32 out) inside the 8-step graph, which
   registers the augment's generator; ``aug_cost_frac = 1 - aug / bare``.
   K1 runs 8 times a replay of (a), never in (b); two more replays of (a)
   must draw different crop boxes. Epoch 1 warms up, 6 are counted (the
   bench: 4).
13. lm_long: the ``lm_long`` child (``bench.py:2526-2530``): a store of 256
   rows of 8193 tokens (``bench.py:141``), ``TransformerLM(max_len=8192)``,
   batch 2, K = 4, 2 warm-up and 12 measured calls; each flash kernel 32
   times a replay; attention's share of the traced step.
14. lm_moe: the ``lm_moe`` child (``bench.py:2537-2540``): the lm store and
   widths with 4 Switch-MoE experts and 4 layers, loss ``ce + 1e-2 * aux``,
   batch 8, K = 8, 2 warm-up and 12 measured calls; each flash kernel 32
   times a replay; the losses and the aux losses.
15. pipeline: the bench's ``pipeline`` child (``bench.py:774-949``) on the
   imagenet store: the host pipeline alone, no model (see
   ``petastorm_tpu_torch.bench.run_pipeline``): median img/s of 3 reps of 32
   batches, spread, cold rate, stage profile, the null/memory/chunk-store
   tier sweep, and, with ``PSTT_HOST_MEM_BUDGET=auto`` set for the phase,
   the memory governor's ``mem`` block.
16. loader_surface: a small store through ``TorchLoader`` on the card (tensor
   reader; row reader with ``CropTo``): ``prefetch=0``, ``prefetch=2,
   inflight=1`` and ``prefetch=2, inflight=4, arena_depth=3`` bit-equal to
   the default's batches; ``echo=2`` delivers each twice.
17. examples: the imagenet example with ``augment=True`` at 224 from a ragged
   store (K1 once a step), the long_context example at its defaults (K2-K4
   once a layer a step), the mnist example (accuracy over 0.8).
18. preemptible: ResNet-50 killed mid-epoch and resumed from a job
   checkpoint (see :func:`run_preemptible`), three child processes on the
   imagenet store, deterministic reader, lineage ledger, ``superbatches(8)``
   and the 8-step scan trainer with K1 in its graph: U runs 6 calls (3
   epochs); S1 saves after every call (async ``JobCheckpointer``) and is
   SIGKILLed once the save of call 3 is durable; S2 restores and runs
   calls 4-6. S2's per-batch ledger digests must equal U's, the restored
   state S1's save bit for bit, S2's final loader state U's, and an S2
   record must replay bit-identical (``verify_record``); losses within
   ``PREEMPT_LOSS_RTOL``; K1 counted in S2's window.
19. mesh: the multi-GPU paths at world size 1 (the machine has one card),
   in a child process of their own that starts an NCCL process group from
   a file (no fallback to gloo) and destroys it (see :func:`run_mesh`):
   (a) ResNet-50 on ``{'data': 1, 'model': 1}`` through
   ``make_pod_reader`` -> the mesh ``TorchLoader`` -> ``make_scan_train_step
   (mesh=...)``, K1 and the gradient all-reduce (NCCL ``ReduceOp.AVG``,
   whose one-rank reduction kernel runs) in the 8-step graph, each counted
   by name among the graph's kernel nodes, 8 a replay in 13 replays; (c)
   the sharded ``JobCheckpointer`` save
   of (a)'s state through the group and its restore into a fresh state,
   bit for bit; (b) the lm cell's TransformerLM on ``{'data': 1, 'sp': 1,
   'model': 1}`` with ``attention='a2a'`` through the 8-step scan graph (K2-
   K4 counted as lm_scan counts them) and ``attention='ring'`` for three
   eager steps, each holding its first losses to ``attention='flash'``'s
   within ``MESH_LOSS_ATOL``. No number of this phase measures
   communication between two cards. It runs after lm_moe.

Phases 5 to 15 and 18 run the bench's protocol through the functions of
``petastorm_tpu_torch/bench.py`` (``python -m petastorm_tpu_torch.bench``
runs them as the bench's children); this script holds their launch counts.
Each path's kernel launch counts are zeroed just before it and read just
after. On an eager path the wrappers count every launch, and three more
calls are then traced with ``torch.profiler`` (the card's busy time a call
and idle share, ``trace`` in its line). On a scan path a replay calls no
wrapper, so the wrappers count only call 1 (eager) and the capture; the
kernels of the path's replays are counted by name among the captured
graph's kernel nodes, read once through the CUDA driver's graph API
(``bench.graph_kernels``), times the window's replays: K of K1, layers x K
of each flash kernel a replay (none of either on imagenet_vit and on
imagenet_aug's bare cast), or the phase fails. The measured calls run under
``torch.profiler``, whose profile gives ``trace``; img/s, tokens/s, stall
and device ms come from as many more calls, unprofiled, after the window.

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power line, and
last ``{"ok": true, "device": {...}}``.
"""

import argparse
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(ROOT, '.torch_build')
os.environ.setdefault('TRITON_CACHE_DIR', os.path.join(BUILD_DIR, 'triton'))
sys.path.insert(0, ROOT)
try:
    # The bench's stores, widths and scan protocol live in the package's
    # bench module; this script drives the same functions and holds their
    # launch counts.
    from petastorm_tpu_torch import bench
    from petastorm_tpu_torch.bench import (BATCH, IMAGE, LM_BATCH, LM_D, LM_HEADS, LM_LAYERS,
                                           LM_ROWS, LM_SEQ, LM_VOCAB, ROWS, ROWS_PER_GROUP,
                                           launch_counts, reset_launch_counts, trace_calls)
except ImportError:      # the script alone, without the package: main() refuses to run
    bench = None

#: Eager steps before the measured ones (the imagenet and lm eager paths).
WARMUP_STEPS = 3

#: HBM bandwidth (bytes/s) by card, from NVIDIA's data sheets.
HBM_BYTES_PER_S = {'H100 80GB HBM3': 3.35e12, 'H100 SXM': 3.35e12, 'H100 NVL': 3.9e12,
                   'H100 PCIe': 2.0e12, 'H200': 4.8e12}
#: Peak f32 rate outside the tensor cores (flop/s), H100 SXM data sheet.
F32_FLOPS = 67e12
#: Peak dense bf16 tensor-core rate (flop/s), H100 SXM data sheet.
BF16_TC_FLOPS = 989e12
#: Clock cycles the card first spins ahead of a timed run (~10 ms at 1.98 GHz),
#: and the most it spins once doubled (see :func:`time_ms`).
SPIN_CYCLES = 20_000_000
MAX_SPIN_CYCLES = 16 * SPIN_CYCLES

# The bench's flashattn child (bench.py:1610-1618): [B, T, H, D] = [4, 8192, 8, 128].
FA_BATCH, FA_SEQ, FA_HEADS, FA_D = 4, 8192, 8, 128
# The lm_long child (bench.py:2526-2530; store bench.py:141): 256 rows of 8193
# tokens, batch 2, K 4, 48 measured steps (the bench: 16): the flash kernels
# see [16, 8192, 64].
LONG_SEQ, LONG_BATCH, LONG_K, LONG_STEPS = 8193, 2, 4, 48
# The lm_moe child (bench.py:2537-2540): 4 experts, 4 layers; batch 8, K 8, 96
# steps (the bench: 16).
MOE_EXPERTS, MOE_LAYERS, MOE_STEPS = 4, 4, 96
# Measured calls of the streamed ResNet scan paths (the bench: 5) and the
# imagenet_aug epochs (the bench: 4): 13 replays counted, 104 K1 launches,
# and as many calls timed.
SCAN_CALLS, AUG_EPOCHS = 11, 6


def hbm_rate(name):
    for key, rate in HBM_BYTES_PER_S.items():
        if key in name:
            return rate
    raise RuntimeError('no HBM bandwidth on record for card {!r}'.format(name))


def time_ms(fn, reps=30, warmup=3):
    """(median device time of ``fn()`` over ``reps`` calls, host-bound):
    CUDA events between back-to-back calls, all queued behind a spin of
    the card so that the host's launch overhead falls outside the timed
    intervals. If the spin ended before the host had queued the last call
    (a host-heavy ``fn`` such as an autograd backward, or a slow host),
    the run is repeated behind a spin twice as long, up to
    ``MAX_SPIN_CYCLES``. If even that spin ends first, the median may hold
    host time, and host-bound is True."""
    import torch
    for _ in range(warmup):
        fn()
    spin = SPIN_CYCLES
    while True:
        events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
        torch.cuda.synchronize()
        torch.cuda._sleep(spin)
        events[0].record()
        for event in events[1:]:
            fn()
            event.record()
        queued_in_time = not events[0].query()   # the card still spun after the last call
        events[-1].synchronize()
        if queued_in_time or spin >= MAX_SPIN_CYCLES:
            break
        spin *= 2
    times = sorted(a.elapsed_time(b) for a, b in zip(events, events[1:]))
    return times[len(times) // 2], not queued_in_time


def time_into(entry, reps=30, **fns):
    """``entry[key]`` = the device time of ``fns[key]()``, for each key;
    ``entry['host_bound']`` lists the keys whose time may hold host time."""
    host_bound = entry.setdefault('host_bound', [])
    for key, fn in fns.items():
        entry[key], slow = time_ms(fn, reps=reps)
        if slow:
            host_bound.append(key)


# --------------------------------------------------------------------------
# phase 2: kernels
# --------------------------------------------------------------------------

def bf16_ulp(ref):
    """One bf16 ulp at each |ref| (8 significant bits)."""
    import torch
    _, exponent = torch.frexp(ref.abs().clamp(min=2.0 ** -126))   # |ref| = m 2^e, m in [0.5, 1)
    return torch.ldexp(torch.ones_like(ref), exponent - 8)


def _normalize_error(got, want, dtype):
    """(max abs error, within tolerance, the tolerance stated)."""
    import torch
    diff = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        tolerance = '1e-5 absolute (f32 fma vs mul+add)'
        ok = bool((diff <= 1e-5).all())
    else:
        # Near zero, x * scale + shift cancels: the f32 roundings of the
        # two formulas (fma or not) then differ by ~1e-7 absolute.
        tolerance = '1 bf16 ulp of the plain value, at least 1e-6'
        ok = bool((diff <= bf16_ulp(want.float()).clamp(min=1e-6)).all())
    return float(diff.max()), ok, tolerance


def check_normalize(device, rate):
    """K1 at the main path's shape in five variants; the main path's own is
    f32 (after color jitter) -> bf16 with the flip fused."""
    import torch
    from petastorm_tpu_torch.ops import image_ops

    g = torch.Generator(device=device).manual_seed(0)
    shape = (BATCH, IMAGE, IMAGE, 3)
    x_u8 = torch.randint(0, 256, shape, generator=g, device=device, dtype=torch.uint8)
    x_f32 = torch.rand(shape, generator=g, device=device) * 255.0
    flip = image_ops.sample_flip(BATCH, g, device)
    scale, shift = image_ops._scale_shift(image_ops.IMAGENET_MEAN, image_ops.IMAGENET_STD, device)
    variants = [('f32->bf16+flip', x_f32, torch.bfloat16, flip),
                ('f32->bf16', x_f32, torch.bfloat16, None),
                ('u8->bf16', x_u8, torch.bfloat16, None),
                ('f32->f32', x_f32, torch.float32, None),
                ('u8->bf16+flip', x_u8, torch.bfloat16, flip)]
    results = []
    for label, x, dtype, fl in variants:
        got = image_ops.normalize_images(x, dtype=dtype, flip=fl)
        want = image_ops.normalize_images_plain(x, scale, shift, dtype, fl)
        torch.cuda.synchronize()
        max_err, ok, tolerance = _normalize_error(got, want, dtype)
        if not ok:
            raise AssertionError('normalize kernel {} disagrees with its plain version: '
                                 'max abs err {}'.format(label, max_err))
        n = x.numel()
        nbytes = n * (x.element_size() + torch.empty((), dtype=dtype).element_size())
        nbytes += 0 if fl is None else BATCH
        bytes_ms, ops_ms = nbytes / rate * 1e3, 2 * n / F32_FLOPS * 1e3
        entry = {
            'variant': label, 'shape': list(shape), 'max_abs_err': max_err, 'tolerance': tolerance,
            'bound_ms': max(bytes_ms, ops_ms),
            'bound_by': 'bytes' if bytes_ms >= ops_ms else 'operations',
            'library_ms': None, 'bytes_moved': nbytes}
        time_into(entry,
                  ms=lambda: image_ops.normalize_images(x, dtype=dtype, flip=fl),
                  plain_ms=lambda: image_ops.normalize_images_plain(x, scale, shift, dtype, fl),
                  # PyTorch's cast of the input into the output type: the same bytes,
                  # no arithmetic, so the streaming rate the card reaches in practice.
                  copy_ms=lambda: got.copy_(x))
        if dtype == torch.float32 and fl is None:
            time_into(entry, library_ms=lambda: torch.addcmul(shift, x, scale))
        results.append(entry)
    main = dict(results[0])
    return dict(main, name='normalize_images', route='triton',
                source='petastorm_tpu_torch/ops/image_ops.py',
                replaces='petastorm_tpu/ops/image_ops.py:31', variants=results[1:],
                block=image_ops._BLOCK, num_warps=image_ops._NUM_WARPS)


def _bf16_tolerance(want):
    """Two bf16 ulps of each value plus 2^-8 of the largest: the kernels and
    the plain versions round P and dS to bf16 at the same places, and a
    value one f32 sum puts on the other side of a rounding boundary moves
    by an ulp, through the next product."""
    return 2 * bf16_ulp(want) + 2.0 ** -8 * want.abs().max()


def _flash_errors(got, want, dtype, t, names=('out', 'lse', 'dq', 'dk', 'dv')):
    """Max abs errors and whether each is within tolerance (rows past t are pad)."""
    import torch
    errs, ok = [], True
    for name, a, b in zip(names, got, want):
        a, b = a[:, :t].float(), b[:, :t].float()
        diff = (a - b).abs()
        if name == 'lse' or dtype == torch.float32:
            bound = 1e-5 + 1e-5 * b.abs()
        else:
            bound = _bf16_tolerance(b)
        ok = ok and bool((diff <= bound).all())
        errs.append(float(diff.max()))
    return dict(zip(names, errs)), ok


def _flash_inputs(shape, dtype, t, device, seed):
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=g, device=device).to(dtype) for _ in range(4))
    do[:, t:] = 0                      # pad rows carry no gradient
    return q, k, v, do


def _flash_run(fa, q, k, v, do, t, causal, block):
    """Kernels and plain versions on the same inputs; the backward of both
    is fed the plain forward's lse and D, so each kernel is held alone."""
    pout, plse = fa.flash_fwd_plain(q, k, v, t, causal, block)
    dd = (do.float() * pout.float()).sum(-1)
    out, lse = fa.flash_fwd_cuda(q, k, v, t, causal, True)
    dq = fa.flash_dq_cuda(q, k, v, do, plse, dd, t, causal)
    dk, dv = fa.flash_dkv_cuda(q, k, v, do, plse, dd, t, causal)
    want = (pout, plse, fa.flash_dq_plain(q, k, v, do, plse, dd, t, causal, block)) + \
        fa.flash_dkv_plain(q, k, v, do, plse, dd, t, causal, block)
    return (out, lse, dq, dk, dv), want, plse, dd


def _wmma_fwd(fa, q, k, v, t, causal):
    """The WMMA forward (``flash_attention.cu``) on the same bf16 inputs,
    called on its library directly: the kernel the Hopper route replaced,
    kept as the yardstick (no launch is counted)."""
    import torch
    bh, t_pad, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((bh, t_pad), dtype=torch.float32, device=q.device)
    fa._raise_on(fa._library().flash_fwd(
        1, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), bh, t_pad,
        d, t, int(causal), 1.0 / math.sqrt(d), fa._stream(q)), 'flash_fwd (WMMA)')
    return out, lse


def _wmma_dq(fa, q, k, v, do, lse, dd, t, causal):
    """The WMMA dQ on the same bf16 inputs (see :func:`_wmma_fwd`)."""
    import torch
    bh, t_pad, d = q.shape
    dq = torch.empty_like(q)
    fa._raise_on(fa._library().flash_dq(
        1, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), dd.data_ptr(),
        dq.data_ptr(), bh, t_pad, d, t, int(causal), 1.0 / math.sqrt(d), fa._stream(q)),
        'flash_dq (WMMA)')
    return dq


def _wmma_dkv(fa, q, k, v, do, lse, dd, t, causal):
    """The WMMA dK/dV on the same bf16 inputs (see :func:`_wmma_fwd`)."""
    import torch
    bh, t_pad, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fa._raise_on(fa._library().flash_dkv(
        1, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), dd.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), bh, t_pad, d, t, int(causal), 1.0 / math.sqrt(d),
        fa._stream(q)), 'flash_dkv (WMMA)')
    return dk, dv


#: Library yardsticks of the flash kernels (timed here only; the port never calls them).
SDPA_FWD = 'scaled_dot_product_attention(is_causal=True) forward'
SDPA_DQ = ('scaled_dot_product_attention backward for q alone (k and v need no gradient; '
           'forward + autograd.grad minus forward): its fused backward may still compute '
           'dK/dV inside')
SDPA_BWD = 'scaled_dot_product_attention backward (fwd+bwd minus fwd): covers K3+K4'


def sdpa_ms(q, k, v, do, reps):
    """SDPA's causal forward, its backward for q alone, and its backward for
    q, k and v, on ``[B, H, T, D]`` views of the kernels' inputs; each
    backward as forward + backward minus forward. Each is (ms, host-bound),
    as :func:`time_ms` gives them."""
    import torch
    import torch.nn.functional as F

    def attend(*qkv):
        return F.scaled_dot_product_attention(*qkv, is_causal=True)

    fwd = time_ms(lambda: attend(q, k, v), reps=reps)
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q, k, v))
    dq = time_ms(lambda: torch.autograd.grad(attend(qg, k, v), qg, do), reps=reps)
    bwd = time_ms(lambda: attend(qg, kg, vg).backward(do), reps=reps)
    return {'flash_fwd_sm90': fwd, 'flash_dq_sm90': (dq[0] - fwd[0], dq[1] or fwd[1]),
            'flash_dkv_sm90': (bwd[0] - fwd[0], bwd[1] or fwd[1])}


#: ``flash_sm90_smem_bytes`` kernel codes.
SMEM_CODE = {'flash_fwd_sm90': 0, 'flash_dkv_sm90': 1, 'flash_dq_sm90': 2}


def ptxas_report(kernel, d):
    """Registers and spills of ``<kernel>_kernel<d>`` from the Hopper
    library's ``build.log`` (``nvcc -Xptxas -v``), and its dynamic shared
    memory."""
    from petastorm_tpu_torch.ops import _cuda_build
    from petastorm_tpu_torch.ops import flash_attention as fa
    log_path = os.path.join(os.path.dirname(_cuda_build.library_path(fa._SM90_SOURCE)), 'build.log')
    with open(log_path) as f:
        log = f.read()
    entry = '{}_kernelILi{}E'.format(kernel, d)
    report, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = m.group(1)
        elif current and entry in current:
            m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads', line)
            if m:
                report['spill_stores'], report['spill_loads'] = int(m.group(1)), int(m.group(2))
            m = re.search(r'Used (\d+) registers', line)
            if m:
                report['registers'] = int(m.group(1))
    if set(report) != {'registers', 'spill_stores', 'spill_loads'}:
        raise AssertionError('no ptxas report for {} in {}'.format(entry, log_path))
    report['smem_bytes'] = fa._library(fa._SM90_SOURCE).flash_sm90_smem_bytes(SMEM_CODE[kernel], d)
    return report


def _in_turns(entry, previous, kernel, reps=30):
    """``entry['ms']`` and ``entry['previous_ms']``: each timed twice, in
    turns previous, kernel, kernel, previous, on the same inputs; the mean
    of each pair (host-bound if either time of the pair is)."""
    p1, k1, k2, p2 = (time_ms(fn, reps=reps) for fn in (previous, kernel, kernel, previous))
    host_bound = entry.setdefault('host_bound', [])
    for key, (a, b) in (('ms', (k1, k2)), ('previous_ms', (p1, p2))):
        entry[key] = (a[0] + b[0]) / 2
        if a[1] or b[1]:
            host_bound.append(key)


def _library_into(entry, timing):
    """``entry['library_ms']`` from an :func:`sdpa_ms` timing."""
    entry['library_ms'] = timing[0]
    if timing[1]:
        entry.setdefault('host_bound', []).append('library_ms')


def _bound(products, product_flops, nbytes, rate):
    ops_ms = products * product_flops / BF16_TC_FLOPS * 1e3
    bytes_ms = nbytes / rate * 1e3
    return max(ops_ms, bytes_ms), 'operations' if ops_ms >= bytes_ms else 'bytes'


def check_flash_at(device, rate, b, t, h, d, variant, previous):
    """The Hopper forward, dQ and dK/dV at ``[B*H, T, D]`` bf16 causal,
    against the plain versions, timed beside SDPA (and beside the WMMA
    kernels, in turns, when ``previous``)."""
    import torch
    from petastorm_tpu_torch.ops import flash_attention as fa

    bh = b * h
    if fa.kernel_route(torch.bfloat16, d) != 'cuda-sm90':
        raise AssertionError('bf16 D={} does not take the Hopper route'.format(d))
    q, k, v, do = _flash_inputs((bh, t, d), torch.bfloat16, t, device, 3)
    got, want, plse, dd = _flash_run(fa, q, k, v, do, t, True, fa.DEFAULT_BLOCK)
    torch.cuda.synchronize()
    errs, ok = _flash_errors(got, want, torch.bfloat16, t)
    if not ok:
        raise AssertionError('Hopper flash kernels disagree with the plain versions at '
                             '[{}, {}, {}]: {}'.format(bh, t, d, errs))
    library = sdpa_ms(*(x.view(b, h, t, d) for x in (q, k, v, do)), reps=10)
    product = 2.0 * bh * t * t * d / 2
    tile, row = bh * t * d * 2, bh * t * 4
    timed = {
        'flash_fwd_sm90': (2, 3 * tile + tile + row, max(errs['out'], errs['lse']),
                           lambda: _wmma_fwd(fa, q, k, v, t, True),
                           lambda: fa.flash_fwd_cuda(q, k, v, t, True, True)),
        'flash_dq_sm90': (3, 4 * tile + 2 * row + tile, errs['dq'],
                          lambda: _wmma_dq(fa, q, k, v, do, plse, dd, t, True),
                          lambda: fa.flash_dq_cuda(q, k, v, do, plse, dd, t, True)),
        'flash_dkv_sm90': (4, 4 * tile + 2 * row + 2 * tile, max(errs['dk'], errs['dv']),
                           lambda: _wmma_dkv(fa, q, k, v, do, plse, dd, t, True),
                           lambda: fa.flash_dkv_cuda(q, k, v, do, plse, dd, t, True)),
    }
    tolerance = 'bf16 outputs: 2 bf16 ulps + 2^-8 max|plain|; lse (f32): atol=rtol=1e-5'
    results = {}
    for name, (products, nbytes, err, wmma, kernel) in timed.items():
        bound_ms, bound_by = _bound(products, product, nbytes, rate)
        entry = {'variant': variant, 'shape': [bh, t, d], 'tolerance': tolerance,
                 'max_abs_err': err, 'bound_ms': bound_ms, 'bound_by': bound_by}
        if previous:
            entry['ptxas'] = ptxas_report(name, d)
            _in_turns(entry, wmma, kernel, reps=10)
        else:
            time_into(entry, reps=10, ms=kernel)
        _library_into(entry, library[name])
        results[name] = entry
    return results


def check_flash(device, rate):
    """K2-K4 (flash forward, dQ, dK/dV) at the lm path's shape in bf16,
    causal: the Hopper kernels beside the WMMA kernels they replaced, and
    at the flashattn shape; the WMMA kernels also at a small f32 shape,
    causal and not, with a padded tail. Returns (kernel entries, f32 checks)."""
    import torch
    from petastorm_tpu_torch.ops import flash_attention as fa

    small = []
    for causal in (False, True):
        t, bh, d = 100, 6, 16
        bq, bk, t_pad = fa._pad_plan(t, fa.DEFAULT_BLOCK, fa.DEFAULT_BLOCK)
        q, k, v, do = _flash_inputs((bh, t_pad, d), torch.float32, t, device, 1)
        got, want, _, _ = _flash_run(fa, q, k, v, do, t, causal, bk)
        torch.cuda.synchronize()
        errs, ok = _flash_errors(got, want, torch.float32, t)
        if not ok:
            raise AssertionError('flash kernels disagree with the plain versions in f32 '
                                 '(causal={}): {}'.format(causal, errs))
        small.append({'shape': [bh, t_pad, d], 'seq_len': t, 'dtype': 'float32', 'causal': causal,
                      'max_abs_err': errs, 'tolerance': 'atol=rtol=1e-5 (f32)'})

    b, h, t, d = LM_BATCH, LM_HEADS, LM_SEQ - 1, LM_D // LM_HEADS
    bh = b * h
    q, k, v, do = _flash_inputs((bh, t, d), torch.bfloat16, t, device, 2)
    got, want, lse, dd = _flash_run(fa, q, k, v, do, t, True, fa.DEFAULT_BLOCK)
    torch.cuda.synchronize()
    errs, ok = _flash_errors(got, want, torch.bfloat16, t)
    if not ok:
        raise AssertionError('flash kernels disagree with the plain versions at the lm shape: '
                             '{}'.format(errs))
    tolerance = ('bf16 outputs: 2 bf16 ulps + 2^-8 max|plain|; lse (f32): atol=rtol=1e-5')
    library = sdpa_ms(*(x.view(b, h, t, d) for x in (q, k, v, do)), reps=30)

    # The WMMA kernels the Hopper route replaced, on the same inputs.
    prev = (_wmma_fwd(fa, q, k, v, t, True) + (_wmma_dq(fa, q, k, v, do, lse, dd, t, True),)
            + _wmma_dkv(fa, q, k, v, do, lse, dd, t, True))
    torch.cuda.synchronize()
    prev_errs, ok = _flash_errors(prev, want, torch.bfloat16, t)
    if not ok:
        raise AssertionError('WMMA flash kernels disagree with the plain versions at the lm '
                             'shape: {}'.format(prev_errs))

    product = 2.0 * bh * t * t * d / 2          # one causal product's flops
    tile = bh * t * d * 2                       # one bf16 [BH, T, D] tensor's bytes
    row = bh * t * 4                            # one f32 [BH, T] row vector's bytes
    source = 'petastorm_tpu_torch/csrc/flash_attention_sm90.cu'
    specs = [
        ('flash_fwd_sm90', 'petastorm_tpu/ops/flash_attention.py:115', 2, 3 * tile, tile + row,
         ('out', 'lse'), SDPA_FWD,
         lambda: fa.flash_fwd_cuda(q, k, v, t, True, True),
         lambda: fa.flash_fwd_plain(q, k, v, t, True, fa.DEFAULT_BLOCK),
         lambda: _wmma_fwd(fa, q, k, v, t, True)),
        ('flash_dq_sm90', 'petastorm_tpu/ops/flash_attention.py:232', 3, 4 * tile + 2 * row, tile,
         ('dq',), SDPA_DQ,
         lambda: fa.flash_dq_cuda(q, k, v, do, lse, dd, t, True),
         lambda: fa.flash_dq_plain(q, k, v, do, lse, dd, t, True, fa.DEFAULT_BLOCK),
         lambda: _wmma_dq(fa, q, k, v, do, lse, dd, t, True)),
        ('flash_dkv_sm90', 'petastorm_tpu/ops/flash_attention.py:270', 4, 4 * tile + 2 * row,
         2 * tile, ('dk', 'dv'), SDPA_BWD,
         lambda: fa.flash_dkv_cuda(q, k, v, do, lse, dd, t, True),
         lambda: fa.flash_dkv_plain(q, k, v, do, lse, dd, t, True, fa.DEFAULT_BLOCK),
         lambda: _wmma_dkv(fa, q, k, v, do, lse, dd, t, True)),
    ]
    others = (check_flash_at(device, rate, FA_BATCH, FA_SEQ, FA_HEADS, FA_D,
                             'bf16 causal, flashattn child shape', True),
              check_flash_at(device, rate, LONG_BATCH, LONG_SEQ - 1, LM_HEADS, LM_D // LM_HEADS,
                             'bf16 causal, lm_long shape', False))
    results = []
    for name, replaces, products, read, written, outputs, library_label, kernel, plain, previous in specs:
        bound_ms, bound_by = _bound(products, product, read + written, rate)
        entry = {
            'name': name, 'route': 'cuda', 'kernel_route': 'cuda-sm90', 'source': source,
            'replaces': replaces,
            'max_abs_err': max(errs[o] for o in outputs), 'tolerance': tolerance,
            'bound_ms': bound_ms, 'bound_by': bound_by, 'library': library_label,
            'flops': products * product, 'bytes_moved': read + written,
            'variant': 'bf16 causal (lm path)', 'shape': [bh, t, d],
            'previous': 'WMMA kernel of flash_attention.cu, same inputs',
            'previous_max_abs_err': max(prev_errs[o] for o in outputs),
            'ptxas': ptxas_report(name, d), 'variants': [other[name] for other in others]}
        _in_turns(entry, previous, kernel)
        time_into(entry, reps=10, plain_ms=plain)
        _library_into(entry, library[name])
        results.append(entry)
    return results, small


# --------------------------------------------------------------------------
# phases 3 to 5: checks and the two paths
# --------------------------------------------------------------------------


def check_first_batch(url, device):
    """The loader's first batch of an unshuffled read equals the store's
    first rows decoded independently (pyarrow + OpenCV, no port code)."""
    import cv2
    import numpy as np
    import pyarrow.parquet as pq
    import torch
    from petastorm_tpu_torch import TorchLoader, make_tensor_reader

    path = url[len('file://'):]
    data_file = sorted(f for f in os.listdir(path) if f.endswith('.parquet') and not f.startswith('_'))[0]
    table = pq.ParquetFile(os.path.join(path, data_file)).read_row_group(0)
    want_images = np.stack([cv2.cvtColor(cv2.imdecode(np.frombuffer(b, np.uint8), cv2.IMREAD_COLOR),
                                         cv2.COLOR_BGR2RGB)
                            for b in table.column('image').to_pylist()[:BATCH]])
    want_labels = np.asarray(table.column('label').to_pylist()[:BATCH])
    with make_tensor_reader(url, workers_count=1, shuffle_row_groups=False, num_epochs=1) as reader:
        with TorchLoader(reader, BATCH, device=device, prefetch=2) as loader:
            batch = next(loader)
            torch.cuda.synchronize()
            ok = (batch.image.is_cuda and batch.image.dtype == torch.uint8
                  and np.array_equal(batch.image.cpu().numpy(), want_images)
                  and np.array_equal(batch.label.cpu().numpy(), want_labels))
    if not ok:
        raise AssertionError('first TorchLoader batch differs from an independent decode')
    return {'check': 'loader_first_batch', 'rows': BATCH, 'bit_exact': True}


def check_model(device):
    """ResNet-50 (f32, TF32 off) train-mode forward on the card vs the CPU."""
    import torch
    from petastorm_tpu_torch.models.resnet import ResNet50, init_flax_like

    model = init_flax_like(ResNet50(num_classes=1000, dtype=torch.float32, device='cpu'),
                           torch.Generator().manual_seed(1))
    x = torch.rand((2, 64, 64, 3), generator=torch.Generator().manual_seed(2)) * 4 - 2
    with torch.no_grad():
        want = model(x)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        model_gpu = init_flax_like(ResNet50(num_classes=1000, dtype=torch.float32, device=device),
                                   torch.Generator().manual_seed(1))
        with torch.no_grad():
            got = model_gpu(x.to(device)).cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    err = float((got - want).abs().max())
    if not (torch.isfinite(got).all() and torch.allclose(got, want, rtol=1e-3, atol=1e-3)):
        raise AssertionError('ResNet-50 on the card disagrees with the CPU: max abs err {}'.format(err))
    return {'check': 'resnet50_forward_card_vs_cpu', 'max_abs_err': err, 'tolerance': 'rtol=atol=1e-3 (f32)'}


def run_imagenet(url, device, steps, card):
    import numpy as np
    import torch
    from petastorm_tpu_torch import TorchLoader, make_tensor_reader
    from petastorm_tpu_torch.models import make_train_step
    from petastorm_tpu_torch.ops.augment import imagenet_train_augment

    state = bench.resnet50_state(device)
    train_step = make_train_step()
    aug_gen = torch.Generator(device=device).manual_seed(0)
    total = WARMUP_STEPS + steps
    losses, wait_s, aug_ms, step_ms = [], 0.0, [], []
    torch.cuda.reset_peak_memory_stats(device)
    reader = make_tensor_reader(url, schema_fields=['image', 'label'], reader_pool_type='thread',
                                workers_count=4, shuffle_row_groups=True, seed=0, num_epochs=None)
    with reader:
        with TorchLoader(reader, BATCH, device=device, prefetch=2) as loader:
            reset_launch_counts()                    # the path starts here
            for i in range(total):
                if i == WARMUP_STEPS:
                    torch.cuda.synchronize()
                    t_start, wait_s = time.perf_counter(), 0.0
                    stats0 = dict(loader.stats)
                t0 = time.perf_counter()
                batch = next(loader)
                wait_s += time.perf_counter() - t0
                if not (batch.image.is_cuda and batch.label.is_cuda):
                    raise AssertionError('TorchLoader handed out host tensors')
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                ev[0].record()
                images = imagenet_train_augment(batch.image, aug_gen, IMAGE, IMAGE,
                                                dtype=torch.bfloat16)
                ev[1].record()
                metrics = train_step(state, images, batch.label)
                ev[2].record()
                losses.append(metrics['loss'])
                if i >= WARMUP_STEPS:
                    aug_ms.append((ev[0], ev[1]))
                    step_ms.append((ev[1], ev[2]))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t_start
            launches = launch_counts()               # the path ends here
            stats = dict(loader.stats)
    device_step_ms = float(np.median([a.elapsed_time(b) for a, b in step_ms]))
    trace = trace_calls(lambda: train_step(state, imagenet_train_augment(
        batch.image, aug_gen, IMAGE, IMAGE, dtype=torch.bfloat16), batch.label),
        float(np.median([a.elapsed_time(b) for a, b in aug_ms])) + device_step_ms)
    losses = [float(v) for v in losses]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError('non-finite loss: {}'.format(losses))
    if stats['rows'] != total * BATCH:
        raise AssertionError('loader delivered {} rows, expected {}'.format(stats['rows'], total * BATCH))
    if launches.get('normalize_images', 0) != total:
        raise AssertionError('normalize kernel launched {} times in {} steps'.format(
            launches.get('normalize_images', 0), total))
    h2d_bytes = stats['h2d_bytes'] - stats0['h2d_bytes']
    h2d_s = stats['h2d_s'] - stats0['h2d_s']
    return {
        'phase': 'imagenet', 'card': card, 'model': 'resnet50', 'stem': 'conv7', 'classes': 1000,
        'batch': BATCH, 'image': [IMAGE, IMAGE, 3], 'steps': total, 'measured_steps': steps,
        'losses': losses, 'img_per_s': steps * BATCH / wall, 'step_ms': wall / steps * 1e3,
        'input_stall_frac': wait_s / wall,
        'h2d_GBps': h2d_bytes / h2d_s / 1e9 if h2d_s else None,
        'device_aug_ms_median': float(np.median([a.elapsed_time(b) for a, b in aug_ms])),
        'device_train_step_ms_median': device_step_ms,
        'peak_mem_GB': torch.cuda.max_memory_allocated(device) / 1e9,
        'rows_delivered': stats['rows'], 'launches': launches, 'trace': trace}


def check_lm_model(device):
    """TransformerLM (lm widths, 2 layers, f32, flash) on the card, through
    the CUDA kernels with TF32 off, against the CPU's plain versions; T = 200
    is not a multiple of a tile."""
    import torch
    from petastorm_tpu_torch.models import TransformerLM
    from petastorm_tpu_torch.models.transformer import init_flax_like
    from petastorm_tpu_torch.ops import flash_attention

    def build(where):
        model = TransformerLM(LM_VOCAB, LM_D, LM_HEADS, 2, LM_SEQ - 1, attention='flash',
                              dtype=torch.float32, device=where)
        return init_flax_like(model, torch.Generator().manual_seed(3))

    tokens = torch.randint(0, LM_VOCAB, (2, 200), generator=torch.Generator().manual_seed(4),
                           dtype=torch.int32)
    with torch.no_grad():
        want = build('cpu')(tokens)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        before = flash_attention.LAUNCHES['flash_fwd']
        with torch.no_grad():
            got = build(device)(tokens.to(device)).cpu()
        launched = flash_attention.LAUNCHES['flash_fwd'] - before
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    err = float((got - want).abs().max())
    if launched != 2 or not (torch.isfinite(got).all()
                             and torch.allclose(got, want, rtol=1e-4, atol=1e-4)):
        raise AssertionError('TransformerLM on the card disagrees with the CPU: max abs err {}, '
                             '{} flash_fwd launches'.format(err, launched))
    return {'check': 'transformer_lm_forward_card_vs_cpu', 'layers': 2, 'tokens': [2, 200],
            'max_abs_err': err, 'tolerance': 'rtol=atol=1e-4 (f32)'}


def check_vit_flash(device):
    """ViT's attention on the Hopper route, non-causal at T = 197 (not a
    multiple of a tile), head dim 64, bf16: the three kernels at the
    bench's ViT shape ([B*6, 256, 64], batch 8) against the plain versions,
    and a ViT at the bench's widths (2 layers) with ``attention='flash'``
    against the dense one on the same weights, on the card."""
    import torch
    from petastorm_tpu_torch.models import ViT
    from petastorm_tpu_torch.models.vit import init_flax_like
    from petastorm_tpu_torch.ops import flash_attention as fa

    t, heads, d = 197, 6, 64
    _, block_k, t_pad = fa._pad_plan(t, fa.DEFAULT_BLOCK, fa.DEFAULT_BLOCK)
    q, k, v, do = _flash_inputs((8 * heads, t_pad, d), torch.bfloat16, t, device, 5)
    got, want, _, _ = _flash_run(fa, q, k, v, do, t, False, block_k)
    torch.cuda.synchronize()
    errs, ok = _flash_errors(got, want, torch.bfloat16, t)
    if not ok:
        raise AssertionError('flash kernels disagree with the plain versions at the ViT shape: '
                             '{}'.format(errs))
    x = torch.rand((8, IMAGE, IMAGE, 3), generator=torch.Generator().manual_seed(6)).to(device)
    logits = {}
    for attention in ('dense', 'flash'):
        model = init_flax_like(ViT(1000, image_size=IMAGE, num_layers=2, attention=attention,
                                   device=device),
                               torch.Generator().manual_seed(7))
        before = fa.LAUNCHES['flash_fwd_sm90']
        with torch.no_grad():
            logits[attention] = model(x)
        launched = fa.LAUNCHES['flash_fwd_sm90'] - before
    err = float((logits['flash'] - logits['dense']).abs().max())
    scale = float(logits['dense'].abs().max())
    if launched != 2 or not (torch.isfinite(logits['flash']).all() and err <= 2 ** -4):
        raise AssertionError('ViT with flash attention disagrees with dense on the card: max abs '
                             'err {} (|logits| <= {}), {} sm90 forward launches'.format(
                                 err, scale, launched))
    return {'check': 'vit_flash_non_causal_t197', 'kernel_shape': [8 * heads, t_pad, d],
            'seq_len': t, 'kernel_max_abs_err': errs,
            'kernel_tolerance': 'bf16 outputs: 2 bf16 ulps + 2^-8 max|plain|; lse: 1e-5',
            'model': 'ViT d 384, 6 heads, 2 layers, bf16, batch 8',
            'logits_max_abs_err_flash_vs_dense': err, 'logits_max_abs': scale,
            'tolerance': '2^-4 absolute (two bf16 ulps at |x| < 8)'}


def check_moe_model(device):
    """The MoE TransformerLM (lm widths, 4 experts, 2 layers, f32, flash)
    on the card, TF32 off, against the CPU: logits and the summed aux loss."""
    import torch
    from petastorm_tpu_torch.models import TransformerLM, moe_aux_loss
    from petastorm_tpu_torch.models.transformer import init_flax_like

    def run(where):
        model = init_flax_like(TransformerLM(LM_VOCAB, LM_D, LM_HEADS, 2, LM_SEQ - 1,
                                             attention='flash', moe_experts=MOE_EXPERTS,
                                             dtype=torch.float32, device=where),
                               torch.Generator().manual_seed(8))
        with torch.no_grad():
            out = model(tokens.to(where))
        return out.cpu(), moe_aux_loss(model).cpu()

    tokens = torch.randint(0, LM_VOCAB, (2, 200), generator=torch.Generator().manual_seed(9),
                           dtype=torch.int32)
    want, want_aux = run('cpu')
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got, got_aux = run(device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    err, aux_err = float((got - want).abs().max()), float((got_aux - want_aux).abs())
    if not (torch.isfinite(got).all() and torch.allclose(got, want, rtol=1e-4, atol=1e-4)
            and torch.allclose(got_aux, want_aux, rtol=1e-5, atol=1e-5)):
        raise AssertionError('MoE TransformerLM on the card disagrees with the CPU: logits {}, '
                             'aux {}'.format(err, aux_err))
    return {'check': 'moe_lm_forward_card_vs_cpu', 'experts': MOE_EXPERTS, 'layers': 2,
            'tokens': [2, 200], 'max_abs_err': err, 'aux_loss': float(got_aux),
            'aux_abs_err': aux_err, 'tolerance': 'logits rtol=atol=1e-4, aux 1e-5 (f32)'}


def run_lm(url, device, steps, card):
    import numpy as np
    import torch
    from petastorm_tpu_torch import TorchLoader, make_tensor_reader
    from petastorm_tpu_torch.models import TransformerLM, create_train_state, make_lm_train_step
    from petastorm_tpu_torch.models.transformer import init_flax_like

    t = LM_SEQ - 1
    model = init_flax_like(
        TransformerLM(LM_VOCAB, LM_D, LM_HEADS, LM_LAYERS, max_len=t, attention='flash',
                      dtype=torch.bfloat16, device=device), torch.Generator().manual_seed(0))
    params = sum(p.numel() for p in model.parameters())
    state = create_train_state(model, learning_rate=0.01, momentum=0.9)
    train_step = make_lm_train_step()
    total = WARMUP_STEPS + steps
    losses, wait_s, step_ms = [], 0.0, []
    torch.cuda.reset_peak_memory_stats(device)
    reader = make_tensor_reader(url, schema_fields=['tokens'], reader_pool_type='thread',
                                workers_count=2, shuffle_row_groups=True, seed=0, num_epochs=None)
    with reader:
        with TorchLoader(reader, LM_BATCH, device=device, prefetch=2) as loader:
            reset_launch_counts()                    # the path starts here
            for i in range(total):
                if i == WARMUP_STEPS:
                    torch.cuda.synchronize()
                    t_start, wait_s = time.perf_counter(), 0.0
                t0 = time.perf_counter()
                batch = next(loader)
                wait_s += time.perf_counter() - t0
                tokens = batch.tokens
                if not (tokens.is_cuda and tokens.dtype == torch.int32
                        and tuple(tokens.shape) == (LM_BATCH, LM_SEQ)):
                    raise AssertionError('tokens arrived as {} {} on {}'.format(
                        tokens.dtype, tuple(tokens.shape), tokens.device))
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                losses.append(train_step(state, tokens)['loss'])
                ev[1].record()
                if i >= WARMUP_STEPS:
                    step_ms.append(ev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t_start
            launches = launch_counts()               # the path ends here
            stats = dict(loader.stats)
    device_step_ms = float(np.median([a.elapsed_time(b) for a, b in step_ms]))
    trace = trace_calls(lambda: train_step(state, tokens), device_step_ms)
    losses = [float(v) for v in losses]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError('non-finite loss: {}'.format(losses))
    if stats['rows'] != total * LM_BATCH:
        raise AssertionError('loader delivered {} rows, expected {}'.format(
            stats['rows'], total * LM_BATCH))
    for name in ('flash_fwd', 'flash_dq', 'flash_dkv', 'flash_fwd_sm90', 'flash_dq_sm90',
                 'flash_dkv_sm90'):
        if launches.get(name, 0) != LM_LAYERS * total:
            raise AssertionError('{} launched {} times in {} steps of {} layers'.format(
                name, launches.get(name, 0), total, LM_LAYERS))
    return {
        'phase': 'lm', 'card': card, 'model': 'TransformerLM', 'params': params,
        'vocab': LM_VOCAB, 'd_model': LM_D, 'heads': LM_HEADS, 'layers': LM_LAYERS, 'seq': t,
        'batch': LM_BATCH, 'attention': 'flash', 'dtype': 'bfloat16', 'steps': total,
        'measured_steps': steps, 'losses': losses,
        'tokens_per_s': steps * LM_BATCH * t / wall, 'step_ms': wall / steps * 1e3,
        'input_stall_frac': wait_s / wall,
        'device_train_step_ms_median': device_step_ms,
        'peak_mem_GB': torch.cuda.max_memory_allocated(device) / 1e9,
        'rows_delivered': stats['rows'], 'launches': launches, 'trace': trace}


# --------------------------------------------------------------------------
# the scan paths: K steps a call as one CUDA graph replay
# --------------------------------------------------------------------------

def _max_diff(a, b):
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def _eager_classifier(k, preprocess):
    """The eager reference of a classifier scan step: K calls of the
    one-step trainer on the microbatch slices, the metrics stacked and
    averaged as the scan step's are."""
    import torch
    from petastorm_tpu_torch.models import make_train_step
    train_step = make_train_step()

    def run(state, images, labels):
        micro = images.shape[0] // k
        out = [train_step(state, preprocess(images[i * micro:(i + 1) * micro]),
                          labels[i * micro:(i + 1) * micro]) for i in range(k)]
        losses = torch.stack([m['loss'] for m in out])
        return {'loss': losses.mean(), 'accuracy': torch.stack([m['accuracy'] for m in out]).mean(),
                'last_loss': losses[-1]}

    return run


def _eager_lm(k):
    """The eager reference of an LM scan step (see :func:`_eager_classifier`)."""
    import torch
    from petastorm_tpu_torch.models import make_lm_train_step
    train_step = make_lm_train_step()

    def run(state, tokens):
        micro = tokens.shape[0] // k
        return {'losses': torch.stack([train_step(state, tokens[i * micro:(i + 1) * micro])['loss']
                                       for i in range(k)])}

    return run


def check_scan_graph(device):
    """The captured graph of K steps against K calls of the one-step
    trainer, from one state (a deep copy) on the same superbatches, three
    calls each."""
    import copy
    import torch
    from petastorm_tpu_torch.models import (ResNetTiny, TransformerLM, create_train_state,
                                            make_lm_scan_train_step, make_scan_train_step)
    from petastorm_tpu_torch.models import resnet, transformer
    from petastorm_tpu_torch.ops import image_ops

    k = 4

    def tiny():
        model = resnet.init_flax_like(ResNetTiny(num_classes=10, dtype=torch.bfloat16,
                                                 device=device), torch.Generator().manual_seed(5))
        return model.to(memory_format=torch.channels_last)

    def lm():
        model = TransformerLM(LM_VOCAB, LM_D, LM_HEADS, 2, LM_SEQ - 1, attention='flash',
                              dtype=torch.bfloat16, device=device)
        return transformer.init_flax_like(model, torch.Generator().manual_seed(6))

    def images(call):
        g = torch.Generator(device=device).manual_seed(call)
        return (torch.randint(0, 256, (k * 16, 64, 64, 3), generator=g, device=device,
                              dtype=torch.uint8),
                torch.randint(0, 10, (k * 16,), generator=g, device=device))

    def tokens(call):
        g = torch.Generator(device=device).manual_seed(call)
        return (torch.randint(0, LM_VOCAB, (k * 2, LM_SEQ), generator=g, device=device,
                              dtype=torch.int32),)

    def normalize(x):
        return image_ops.normalize_images(x, dtype=torch.bfloat16)

    cases = [
        ('resnet_tiny_bf16_k1', tiny, lambda: make_scan_train_step(k, normalize),
         lambda: _eager_classifier(k, normalize), images, 0.1, False),
        ('transformer_lm_2_layers_bf16_flash', lm, lambda: make_lm_scan_train_step(k),
         lambda: _eager_lm(k), tokens, 0.01, True),
    ]
    results = []
    for name, build, make_scan, make_eager, inputs_of, lr, exact in cases:
        model = build()
        states = [create_train_state(m, learning_rate=lr, momentum=0.9)
                  for m in (model, copy.deepcopy(model))]
        steps = [make_eager(), make_scan()]
        out = [[], []]
        for call in range(3):
            inputs = inputs_of(call)
            out[0].append(steps[0](states[0], *inputs))
            before = launch_counts()
            out[1].append(steps[1](states[1], *inputs))
            if call == 1:
                captured = bench._launch_diff(launch_counts(), before)
                kept = {key: v.clone() for key, v in out[1][1].items()}
        torch.cuda.synchronize()
        kept_ok = all(torch.equal(out[1][1][key], kept[key]) for key in kept)
        metric_diff = max(_max_diff(a[key], b[key]) for a, b in zip(*out) for key in a)
        pairs = list(zip(states[0].model.state_dict().values(),
                         states[1].model.state_dict().values()))
        param_diff = max(_max_diff(a, b) for a, b in pairs)
        bit_equal = metric_diff == 0 and param_diff == 0
        if exact:
            tolerance = 'exact (deterministic kernels and products)'
            ok = bit_equal
        else:
            tolerance = ('rtol 1e-2, atol 1e-3 on metrics, params and running stats '
                         "(cuDNN's backward may sum with atomics)")
            ok = (all(torch.allclose(b[key].float(), a[key].float(), rtol=1e-2, atol=1e-3)
                      for a, b in zip(*out) for key in a)
                  and all(torch.allclose(b.float(), a.float(), rtol=1e-2, atol=1e-3)
                          for a, b in pairs))
        checksums = [sum(float(v.double().sum()) for v in st.model.state_dict().values())
                     for st in states]
        entry = {'check': 'scan_graph_vs_eager', 'case': name, 'microbatches': k, 'calls': 3,
                 'eager': 'K calls of the one-step trainer on the microbatch slices',
                 'metrics_graph': [{key: v.tolist() for key, v in m.items()} for m in out[1]],
                 'max_abs_diff_metrics': metric_diff, 'max_abs_diff_params': param_diff,
                 'param_checksum_eager': checksums[0], 'param_checksum_graph': checksums[1],
                 'bit_equal': bit_equal, 'tolerance': tolerance,
                 'call2_metrics_kept_after_call3': kept_ok,
                 'wrapper_launches_across_capture': captured}
        if not (ok and kept_ok and steps[1].graph is not None):
            raise AssertionError('scan graph disagrees with eager steps: {}'.format(entry))
        results.append(entry)
    return results


# --------------------------------------------------------------------------
# preemptible: ResNet-50 killed mid-epoch and resumed from a job checkpoint
# --------------------------------------------------------------------------

#: Scan calls of a whole run (3 epochs of the store in superbatches of
#: SCAN_K batches), and the call after whose durable save S1 is killed.
PREEMPT_EPOCHS, PREEMPT_KILL_AFTER = 3, 3
#: S2's losses against U's (mean and last of each call): cuDNN's convolution
#: backward may sum with atomics and cudnn.benchmark picks algorithms per
#: process, so the runs are not bit-equal in their losses.
PREEMPT_LOSS_RTOL = 1e-2
PREEMPT_CHILD_TIMEOUT_S = 300

# The mesh phase: the lm cell's T as a whole-sequence field (the sequence-
# parallel loss predicts token t + 1 of it), three eager ring steps, and
# the losses of every step held to flash's within MESH_LOSS_ATOL: on an H100
# the a2a scan's 8 and the ring's 3 stayed within 1.7e-4 of flash's (near
# 10.9), so 2e-3 leaves a margin of about ten.
MESH_SEQ, MESH_RING_STEPS, MESH_LOSS_ATOL = 1024, 3, 2e-3
MESH_LM_CALLS, MESH_CHILD_TIMEOUT_S = 12, 600
# NCCL's one-rank reduction kernel (ReduceOp.AVG; an in-place sum on one
# rank enqueues nothing): the gradient all-reduce, counted by name among
# the graph's kernel nodes.
NCCL_KERNEL = 'oneRankReduce'


def _state_digests(state):
    """CRC32 of every parameter, buffer (BatchNorm statistics) and momentum
    buffer of a ResNet TrainState, by name, and its step."""
    import zlib

    import torch

    def crc(t):
        return zlib.crc32(t.detach().reshape(-1).contiguous().view(torch.uint8).cpu().numpy())

    out = {'model.' + name: crc(t) for name, t in state.model.state_dict().items()}
    for name, p in state.model.named_parameters():
        out['momentum.' + name] = crc(state.optimizer.state[p]['momentum_buffer'])
    out['step'] = state.step
    return out


def preemptible_role(role, url, workdir, launched, device='cuda'):
    """One run of the preemptible phase, in a process of its own (``role``:
    ``U`` uninterrupted, ``S1`` saves every call and waits to be killed,
    ``S2`` restores the latest step and finishes). Prints one JSON line."""
    import torch
    from petastorm_tpu_torch import TorchLoader, lineage, make_tensor_reader
    from petastorm_tpu_torch.job_checkpoint import JobCheckpointer
    from petastorm_tpu_torch.models import make_scan_train_step

    device = torch.device(device)
    ckpt_dir = os.path.join(workdir, 'ckpt')
    ledger_dir = os.path.join(workdir, 'ledger_' + role)
    state = bench.resnet50_state(device)
    out = {'role': role}
    resume, first_call = None, 1
    if role == 'S2':
        t0 = time.perf_counter()
        with JobCheckpointer(ckpt_dir) as ckpt:
            job = ckpt.restore(state)
        if device.type == 'cuda':
            torch.cuda.synchronize()
        out['restore_s'] = time.perf_counter() - t0
        with open(os.path.join(workdir, 'digests.json')) as f:
            saved = json.load(f)
        got = _state_digests(state)
        out['restored_step'] = job.step
        out['restored_tensors'] = len(got) - 1
        out['state_bit_equal'] = got == saved
        out['state_mismatches'] = sorted(k for k in saved if saved[k] != got.get(k))[:10]
        resume, first_call = job.loader_state, job.step + 1
    reader = make_tensor_reader(url, schema_fields=['image', 'label'], reader_pool_type='thread',
                                workers_count=4, shuffle_row_groups=True, seed=0,
                                num_epochs=PREEMPT_EPOCHS, cache_type='memory',
                                deterministic=True, resume_state=resume)
    train = make_scan_train_step(bench.SCAN_K, preprocess=bench.normalize_bf16)
    calls = PREEMPT_EPOCHS * ROWS // BATCH // bench.SCAN_K
    with reader, TorchLoader(reader, BATCH, device=device, prefetch=2,
                             lineage=ledger_dir) as loader:
        groups = loader.superbatches(bench.SCAN_K)

        def next_inputs():
            sb = next(groups)
            return sb.image, sb.label

        if role == 'S1':
            ckpt = JobCheckpointer(ckpt_dir, max_to_keep=2, async_save=True)
            dispatch = []
            for call in range(1, PREEMPT_KILL_AFTER + 1):
                train(state, *next_inputs())
                t0 = time.perf_counter()
                ckpt.save(call, state, loader=loader)
                dispatch.append(time.perf_counter() - t0)
            ckpt.wait()
            durable = time.perf_counter() - t0
            with open(os.path.join(workdir, 'digests.json'), 'w') as f:
                json.dump(_state_digests(state), f)
            with JobCheckpointer(os.path.join(workdir, 'sync'), max_to_keep=1) as sync:
                t0 = time.perf_counter()
                sync.save(PREEMPT_KILL_AFTER, state, loader=loader)
                sync_s = time.perf_counter() - t0
            out.update(saves=PREEMPT_KILL_AFTER, async_save_dispatch_s=dispatch,
                       async_save_durable_s=durable, sync_save_s=sync_s,
                       checkpoint_bytes=ckpt.step_nbytes(PREEMPT_KILL_AFTER),
                       steps_kept=ckpt.all_steps(), loader_state=loader.state_dict())
            bench.emit(out)
            print('READY', flush=True)
            time.sleep(PREEMPT_CHILD_TIMEOUT_S)     # the parent kills it here
            raise RuntimeError('S1 was not killed')
        n = calls - first_call + 1
        if role == 'S2':
            # K1's launches in S2's window: call 4 eager, call 5 captures and replays.
            metrics, launches, captured, ran, _, replays = bench.scan_window(
                train, state, next_inputs, 1, 1, ('normalize_kernel',))
            out['process_start_to_first_replay_s'] = time.time() - launched
            bench.require_scan_launches(launches, captured, ran, ('normalize_images',),
                                        bench.SCAN_K, replays)
            out['launches'] = bench._scan_launches(launches, captured, ran, 2, replays)
        else:
            metrics = [train(state, *next_inputs()) for _ in range(2)]
        wall, _, call_ms, timed = bench.time_scan_calls(train, state, next_inputs, n - 2)
        try:
            next(groups)
            raise AssertionError('{}: the loader delivered past {} calls'.format(role, calls))
        except StopIteration:
            pass
        final_state = loader.state_dict()
    _, records = lineage.read_ledger_file(lineage.read_ledger_dir(ledger_dir)[0][0])
    ctx = lineage.read_ledger_dir(ledger_dir)[0][1]
    if role == 'S2':
        lineage.verify_record(records[0], ctx)
        out['verify_record'] = {'batch_id': records[0]['batch_id'], 'ok': True}
    out.update(
        first_call=first_call, calls=n,
        losses_mean_last=[[float(m['loss']), float(m['last_loss'])] for m in metrics + timed],
        timed_calls=n - 2, img_per_s=(n - 2) * bench.SCAN_K * BATCH / wall,
        device_call_ms_median=call_ms, final_loader_state=final_state,
        digests=[r['digest'] for r in records], ledger_records=len(records),
        tiers=sorted({s['tier'] for r in records for s in r['segments']}))
    bench.emit(out)


def preemptible_checks(u, s1, s2):
    """The phase's checks over the three runs' lines; raises unless all
    hold. Returns (the checks, S2's worst relative loss difference)."""
    resumed_at = PREEMPT_KILL_AFTER * bench.SCAN_K
    checks = {
        'digests_equal_u': s2['digests'] == u['digests'][resumed_at:],
        'state_bit_equal': s2['state_bit_equal'],
        'final_loader_state_equal': s2['final_loader_state'] == u['final_loader_state'],
        'verify_record': s2['verify_record']['ok'],
        'restored_step': s2['restored_step'] == PREEMPT_KILL_AFTER,
        'killed_by_sigkill': s1['killed_signal'] == signal.SIGKILL}
    u_losses = u['losses_mean_last'][PREEMPT_KILL_AFTER:]
    worst = max(abs(a - b) / abs(b) for got, want in zip(s2['losses_mean_last'], u_losses)
                for a, b in zip(got, want))
    checks['losses_within_rtol'] = (len(s2['losses_mean_last']) == len(u_losses)
                                    and worst <= PREEMPT_LOSS_RTOL)
    if not all(checks.values()):
        raise AssertionError('preemptible checks failed: {} (S2 {} records, U {}; state '
                             'mismatches {}; worst loss rel diff {})'.format(
                                 checks, len(s2['digests']), len(u['digests']),
                                 s2['state_mismatches'], worst))
    return checks, worst


def _role_line(proc, role):
    for line in proc.stdout:
        if line.startswith('{') and '"role"' in line:
            return json.loads(line)
    raise AssertionError('preemptible {} printed no result (exit {})'.format(role, proc.wait()))


def run_preemptible(url, card):
    """The preemptible phase: three child processes on the imagenet store
    (``make_tensor_reader(deterministic=True, seed=0, workers_count=4,
    cache_type='memory', num_epochs=3)``, ``TorchLoader(batch 128,
    prefetch 2, lineage=<dir>)``, ``superbatches(8)``, the 8-step ResNet-50
    scan trainer with K1 in its graph). U runs the 6 calls; S1 runs the
    same with an async ``JobCheckpointer`` save after every call and is
    SIGKILLed once the save of call 3 is durable, mid-epoch 2 with batches
    in prefetch; S2, a fresh process, restores the latest step and its
    loader state and runs calls 4-6. Fails unless S2's per-batch ledger
    digests equal U's for those calls, the restored state is bit-equal to
    what S1 saved, S2's final loader state equals U's, ``verify_record``
    passes on an S2 record, S2's losses lie within ``PREEMPT_LOSS_RTOL`` of
    U's, and K1 ran 8 times a call in S2's window."""
    workdir = tempfile.mkdtemp(prefix='preempt_', dir=BUILD_DIR)
    t_phase = time.perf_counter()
    lines = {}
    try:
        for role in ('U', 'S1', 'S2'):
            cmd = [sys.executable, os.path.abspath(__file__), '--preemptible-role', role,
                   '--preemptible-url', url, '--preemptible-dir', workdir,
                   '--preemptible-launched', repr(time.time())]
            with subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, cwd=ROOT) as proc:
                try:
                    lines[role] = _role_line(proc, role)
                    if role == 'S1':
                        if proc.stdout.readline().strip() != 'READY':
                            raise AssertionError('S1 did not report its durable save')
                        os.kill(proc.pid, signal.SIGKILL)
                        lines[role]['killed_signal'] = -proc.wait(timeout=60)
                    elif proc.wait(timeout=PREEMPT_CHILD_TIMEOUT_S) != 0:
                        raise AssertionError('preemptible {} exited {}'.format(
                            role, proc.returncode))
                finally:
                    if proc.poll() is None:
                        proc.kill()
        u, s1, s2 = lines['U'], lines['S1'], lines['S2']
        checks, worst = preemptible_checks(u, s1, s2)
        return {
            'phase': 'preemptible', 'card': card, 'checks': checks,
            'loss_rtol': PREEMPT_LOSS_RTOL, 'worst_loss_rel_diff': worst,
            'cudnn_deterministic': False,
            'k1_launches_s2_window': bench.path_launches(s2, 'normalize_images',
                                                          'normalize_kernel'),
            'checkpoint_bytes': s1['checkpoint_bytes'],
            'async_save_dispatch_s': s1['async_save_dispatch_s'],
            'async_save_durable_s': s1['async_save_durable_s'], 'sync_save_s': s1['sync_save_s'],
            'restore_s': s2['restore_s'], 'restored_tensors': s2['restored_tensors'],
            'steps_kept': s1['steps_kept'],
            'process_start_to_first_replay_s': s2['process_start_to_first_replay_s'],
            'img_per_s': {'U': u['img_per_s'], 'S2': s2['img_per_s']},
            'timed_calls': {'U': u['timed_calls'], 'S2': s2['timed_calls']},
            'ledger_records': {'U': u['ledger_records'], 'S2': s2['ledger_records']},
            'tiers': {'U': u['tiers'], 'S2': s2['tiers']},
            'losses_mean_last': {'U': u['losses_mean_last'], 'S2': s2['losses_mean_last']},
            'saved_loader_state': s1['loader_state'],
            'seconds': time.perf_counter() - t_phase}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


# --------------------------------------------------------------------------
# the mesh phase: the multi-GPU paths at world size 1, over NCCL
# --------------------------------------------------------------------------

def mesh_resnet(url, device):
    """(a): ResNet-50 scan training on ``{'data': 1, 'model': 1}``; K1 8
    times a call and the gradient all-reduce 8 times a call in the graph."""
    from petastorm_tpu_torch.models import make_scan_train_step
    from petastorm_tpu_torch.parallel import make_mesh
    mesh = make_mesh({'data': 1, 'model': 1})
    state = bench.resnet50_state(device, mesh=mesh)
    train = make_scan_train_step(bench.SCAN_K, preprocess=bench.normalize_bf16, mesh=mesh)
    result, (launches, captured, ran, replays) = bench.stream_classifier_scan(
        url, device, train, state, 3, SCAN_CALLS, ('normalize_kernel', NCCL_KERNEL), mesh=mesh)
    # K1 and the all-reduce, each 8 times a replay.
    bench.require_scan_launches(launches, captured, ran, ('normalize_images',), bench.SCAN_K,
                                replays)
    reduced = ran[NCCL_KERNEL]
    expected = bench.SCAN_K * replays
    result.update(mesh={'data': 1, 'model': 1}, placements={
        name: list(spec) for name, (spec, _) in state.placements.items()},
        all_reduce_kernel={'name': NCCL_KERNEL, 'ran': reduced, 'expected': expected},
        peak_mem_GB_rank0=result['peak_mem_GB'])
    return result, state


def mesh_checkpoint(state, workdir, device):
    """(c): the sharded save of ``state`` through the group, and its
    restore into a fresh ResNet-50 on the same mesh, bit for bit."""
    import torch
    from petastorm_tpu_torch.job_checkpoint import JobCheckpointer
    root = os.path.join(workdir, 'checkpoint')
    t0 = time.perf_counter()
    with JobCheckpointer(root) as ckpt:
        ckpt.save(state.step, state, loader={'rank': 0, 'world': 1})
        nbytes = ckpt.step_nbytes(state.step)
    save_s = time.perf_counter() - t0
    fresh = bench.resnet50_state(device, mesh=state.mesh, seed=1)
    t0 = time.perf_counter()
    with JobCheckpointer(root) as ckpt:
        job = ckpt.restore(fresh)
    restore_s = time.perf_counter() - t0
    want, got = state.model.state_dict(), fresh.model.state_dict()
    unequal = [name for name in want if not torch.equal(want[name], got[name])]
    unequal += ['momentum:' + name for (name, p), q in zip(state.model.named_parameters(),
                                                            fresh.model.parameters())
                if not torch.equal(state.optimizer.state[p]['momentum_buffer'],
                                   fresh.optimizer.state[q]['momentum_buffer'])]
    if unequal or job.step != state.step or job.loader_state != {'rank': 0, 'world': 1}:
        raise AssertionError('the sharded restore differs: {} (step {} vs {}, loader {})'.format(
            unequal[:5], job.step, state.step, job.loader_state))
    return {'step': job.step, 'bytes': nbytes, 'save_s': save_s, 'restore_s': restore_s,
            'files': sorted(os.listdir(os.path.join(root, str(job.step)))),
            'dtensor_entries': sorted(state.placements), 'bit_equal': True,
            'restored_tensors': len(want) + len(state.optimizer.state)}


def _eager_lm_losses(device, mesh, attention, tokens, steps):
    """Losses of ``steps`` eager SGD steps (lr 0.01, momentum 0.9, as the
    scan's) of a fresh seed-0 lm model on the microbatches of ``tokens``."""
    import torch
    from petastorm_tpu_torch.models import create_train_state, make_lm_train_step
    from petastorm_tpu_torch.models.train import transformer_param_spec
    model = bench.lm_model(device, LM_LAYERS, MESH_SEQ, attention=attention, mesh=mesh,
                           seq_axis='sp' if attention in ('ring', 'a2a') else None)
    state = create_train_state(model, learning_rate=0.01, momentum=0.9, mesh=mesh,
                               param_spec_fn=transformer_param_spec)
    step = make_lm_train_step(mesh=mesh)
    losses = [float(step(state, tokens[i * LM_BATCH:(i + 1) * LM_BATCH])['loss'])
              for i in range(steps)]
    del model, state
    torch.cuda.empty_cache()
    return losses


def mesh_lm(workdir, device):
    """(b): the lm cell's TransformerLM on ``{'data': 1, 'sp': 1, 'model':
    1}``: a2a through the scan graph, ring eagerly, both against flash."""
    import torch
    from petastorm_tpu_torch.parallel import make_mesh
    url = bench.write_lm_store(os.path.join(workdir, 'lm'), LM_ROWS, MESH_SEQ)
    mesh = make_mesh({'data': 1, 'sp': 1, 'model': 1})
    first = []
    model = bench.lm_model(device, LM_LAYERS, MESH_SEQ, attention='a2a', mesh=mesh,
                           seq_axis='sp')
    result, metrics, _ = bench.lm_scan(url, device, model, LM_BATCH, bench.SCAN_K, 2,
                                       MESH_LM_CALLS, LM_LAYERS, mesh=mesh, first=first)
    del model
    torch.cuda.empty_cache()
    a2a = [float(v) for v in metrics[0]['losses']]
    flash = _eager_lm_losses(device, mesh, 'flash', first[0], bench.SCAN_K)
    torch.cuda.reset_peak_memory_stats(device)
    ring = _eager_lm_losses(device, mesh, 'ring', first[0], MESH_RING_STEPS)
    ring_peak = torch.cuda.max_memory_allocated(device) / 1e9
    diffs = {'a2a': max(abs(a - f) for a, f in zip(a2a, flash)),
             'ring': max(abs(r - f) for r, f in zip(ring, flash))}
    if not all(d <= MESH_LOSS_ATOL for d in diffs.values()):
        raise AssertionError('first losses off flash\'s: a2a {} ring {} flash {}'.format(
            a2a, ring, flash))
    result.update(mesh={'data': 1, 'sp': 1, 'model': 1}, attention='a2a', seq=MESH_SEQ,
                  first_losses={'a2a_scan': a2a, 'ring_eager': ring, 'flash_eager': flash},
                  loss_atol=MESH_LOSS_ATOL, max_loss_diff=diffs,
                  ring_peak_mem_GB_rank0=ring_peak, peak_mem_GB_rank0=result['peak_mem_GB'])
    return result


def mesh_role(url, workdir):
    """The mesh phase's child process: NCCL at world size 1 from a file,
    (a), (c) and (b), one JSON line; the group is destroyed on the way out."""
    import torch
    import torch.distributed as dist
    device = torch.device('cuda', 0)
    torch.cuda.set_device(device)
    t0 = time.perf_counter()
    dist.init_process_group('nccl', init_method='file://' + os.path.join(workdir, 'init'),
                            rank=0, world_size=1, device_id=device)
    out = {'role': 'mesh', 'nccl_init_s': time.perf_counter() - t0,
           'backend': dist.get_backend(), 'world_size': dist.get_world_size()}
    try:
        out['resnet'], state = mesh_resnet(url, device)
        out['checkpoint'] = mesh_checkpoint(state, workdir, device)
        del state
        torch.cuda.empty_cache()
        out['lm'] = mesh_lm(workdir, device)
    finally:
        dist.destroy_process_group()
    print(json.dumps(out), flush=True)


def run_mesh(url, card):
    """Phase 19 in a child process (see :func:`mesh_role`): its line, to
    which ``main`` adds the same run's single-GPU numbers."""
    workdir = tempfile.mkdtemp(prefix='mesh_', dir=BUILD_DIR)
    t0 = time.perf_counter()
    try:
        cmd = [sys.executable, os.path.abspath(__file__), '--mesh-role', '--mesh-url', url,
               '--mesh-dir', workdir]
        with subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, cwd=ROOT) as proc:
            try:
                line = None
                for text in proc.stdout:
                    if text.startswith('{') and '"role": "mesh"' in text:
                        line = json.loads(text)
                code = proc.wait(timeout=MESH_CHILD_TIMEOUT_S)
            finally:
                if proc.poll() is None:
                    proc.kill()
        if code != 0 or line is None:
            raise AssertionError('the mesh child exited {} ({})'.format(
                code, 'no result' if line is None else 'with a result'))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    del line['role']
    return dict({'phase': 'mesh', 'card': card, 'seconds': time.perf_counter() - t0,
                 'cross_card_transfer': 'not measured: world size 1 on one card, so no number '
                                        'here measures communication between two cards'},
                **line)


# --------------------------------------------------------------------------
# the loader's surface and the examples on the card
# --------------------------------------------------------------------------

def check_loader_surface(store_dir, device):
    """A small store through ``TorchLoader`` on the card, tensor reader and
    row reader (``CropTo`` on a ragged field), one worker, no shuffle: the
    batches of ``prefetch=0``, of ``prefetch=2, inflight=1`` and of
    ``prefetch=2, inflight=4, arena_depth=3`` must equal the default's bit
    for bit, and ``echo=2`` must deliver each of them twice."""
    import numpy as np
    import torch
    from petastorm_tpu_torch import (CompressedImageCodec, CropTo, NdarrayCodec, ScalarCodec,
                                     TorchLoader, Unischema, UnischemaField, make_reader,
                                     make_tensor_reader, write_dataset)

    rows, batch = 200, 24
    schema = Unischema('SurfaceSchema', [
        UnischemaField('id', np.int32, (), ScalarCodec(np.int32)),
        UnischemaField('vec', np.float32, (5,), NdarrayCodec()),
        UnischemaField('image', np.uint8, (40, 40, 3), CompressedImageCodec('png')),
        UnischemaField('ragged', np.uint8, (None, None, 3), CompressedImageCodec('png')),
    ])
    rng = np.random.default_rng(5)
    url = 'file://' + os.path.join(store_dir, 'surface')
    write_dataset(url, schema, ({
        'id': i, 'vec': rng.normal(size=5).astype(np.float32),
        'image': rng.integers(0, 256, (40, 40, 3), dtype=np.uint8),
        'ragged': rng.integers(0, 256, (int(rng.integers(20, 30)), int(rng.integers(20, 30)), 3),
                               dtype=np.uint8)} for i in range(rows)), rows_per_row_group=16)
    readers = {
        'tensor': lambda: make_tensor_reader(url, schema_fields=['id', 'vec', 'image'],
                                             workers_count=1, shuffle_row_groups=False),
        'row': lambda: make_reader(url, schema_fields=['id', 'vec', 'ragged'], workers_count=1,
                                   shuffle_row_groups=False)}
    policies = {'tensor': None, 'row': {'ragged': CropTo((20, 20, 3))}}
    configs = {'default': {}, 'prefetch=0': dict(prefetch=0),
               'prefetch=2,inflight=1': dict(prefetch=2, inflight=1),
               'prefetch=2,inflight=4,arena_depth=3': dict(prefetch=2, inflight=4, arena_depth=3),
               'echo=2': dict(echo=2)}
    result = {'check': 'loader_surface', 'rows': rows, 'batch': batch, 'configs': list(configs)}
    for kind, factory in readers.items():
        got = {}
        for label, options in configs.items():
            with factory() as reader:
                with TorchLoader(reader, batch, device=device, shape_policies=policies[kind],
                                 **options) as loader:
                    batches = []
                    for b in loader:
                        if not all(t.is_cuda for t in b):
                            raise AssertionError('{} {} handed out host tensors'.format(kind, label))
                        batches.append([t.cpu() for t in b])
                    stats = loader.stats
            got[label] = batches
            fresh = rows // batch
            want_batches = fresh * options.get('echo', 1)
            if stats['batches'] != want_batches or stats['rows'] != fresh * batch:
                raise AssertionError('{} {}: stats {} batches, {} rows; expected {}, {}'.format(
                    kind, label, stats['batches'], stats['rows'], want_batches, fresh * batch))
        want = got['default']
        echoed = [b for b in want for _ in range(2)]
        for label, batches in got.items():
            expect = echoed if label == 'echo=2' else want
            if len(batches) != len(expect) or not all(
                    all(torch.equal(a, b) for a, b in zip(x, y)) for x, y in zip(batches, expect)):
                raise AssertionError('{} loader {} differs from the default'.format(kind, label))
        result[kind] = {'batches': len(want), 'bit_equal': True}
    return result


def _mnist_store(url):
    """The mnist example's store: scikit-learn's digits where scikit-learn
    is installed, else 1797 rows of noisy 8x8 class templates (seed 0) in
    the same schema and split."""
    import numpy as np
    from petastorm_tpu_torch import write_dataset
    from petastorm_tpu_torch.examples import mnist
    try:
        mnist.generate_mnist_dataset(url)
        return 'sklearn load_digits'
    except ImportError:
        pass
    rng = np.random.default_rng(0)
    templates = rng.integers(0, 17, (10, 8, 8))
    labels = rng.integers(0, 10, 1797)
    images = np.clip(templates[labels] + rng.integers(-3, 4, (1797, 8, 8)), 0, 16).astype(np.uint8)
    split = int(1797 * 0.8)
    for name, lo, hi in (('train', 0, split), ('test', split, 1797)):
        write_dataset(url + '/' + name, mnist.MnistSchema,
                      ({'idx': i, 'digit': int(labels[i]), 'image': images[i]}
                       for i in range(lo, hi)), rows_per_row_group=200)
    return 'synthetic 8x8 class templates (scikit-learn absent)'


def run_examples(store_dir, device, card):
    """The three examples on the card. imagenet: ``augment=True`` at 224
    from a ragged synthetic store (256-288 px a side), 4 steps of batch 32;
    K1 must launch once a step. long_context: its defaults (d 256, 4 heads,
    2 layers, T 2048, batch 8), 6 steps; K2-K4 must launch once a layer a
    step. mnist: 3 epochs; accuracy over 0.8. Losses must be finite."""
    import contextlib
    import io
    from petastorm_tpu_torch.examples import imagenet, long_context, mnist

    out = {'phase': 'examples', 'card': card}
    url = 'file://' + os.path.join(store_dir, 'example_imagenet')
    imagenet.generate_synthetic(url, classes=4, images_per_class=40, height=256, width=256,
                                ragged=32, rows_per_row_group=32)
    steps = 4
    reset_launch_counts()                            # the path starts here
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        _, losses = imagenet.train(url, batch_size=32, steps=steps, image_size=224, log_every=steps,
                                   augment=True, device=device)
    launches = launch_counts()                       # the path ends here
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        raise AssertionError('imagenet example losses: {}'.format(losses))
    if launches.get('normalize_images', 0) != steps:
        raise AssertionError('imagenet example launched K1 {} times in {} steps'.format(
            launches.get('normalize_images', 0), steps))
    out['imagenet'] = {'augment': True, 'image_size': 224, 'canvas': 256, 'batch': 32,
                       'steps': steps, 'losses': losses, 'seconds': time.perf_counter() - t0,
                       'launches': launches}

    url = 'file://' + os.path.join(store_dir, 'example_lm')
    long_context.generate(url)
    steps, layers = 6, 2
    reset_launch_counts()                            # the path starts here
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        _, losses = long_context.train(url, steps=steps, device=device)
    launches = launch_counts()                       # the path ends here
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        raise AssertionError('long_context example losses: {}'.format(losses))
    if any(launches.get(name, 0) != layers * steps for name in bench.FLASH_WRAPPERS):
        raise AssertionError('long_context example launches {} in {} steps of {} layers'.format(
            launches, steps, layers))
    out['long_context'] = {'steps': steps, 'layers': layers, 'seq': 2048, 'batch': 8,
                           'losses': losses, 'seconds': time.perf_counter() - t0,
                           'launches': launches}

    url = 'file://' + os.path.join(store_dir, 'example_mnist')
    source = _mnist_store(url)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        accuracy = mnist.train_and_test(url, epochs=3, device=device)
    if not accuracy > 0.8:
        raise AssertionError('mnist example accuracy {}'.format(accuracy))
    out['mnist'] = {'store': source, 'epochs': 3, 'test_accuracy': accuracy,
                    'seconds': time.perf_counter() - t0}
    return out


def run_pipeline_governed(url, device, workers):
    """The pipeline child with ``PSTT_HOST_MEM_BUDGET=auto`` set for the
    phase, so the pipeline arms the memory governor. Fails unless the
    ``chunk-store`` row of the tier sweep served its window from the store,
    the ``mem`` block reports an armed budget with no breach, and the
    ``per_device_stream`` block's one-rank NCCL group put tiles on its one
    device."""
    from petastorm_tpu_torch import membudget
    saved = os.environ.get(membudget.ENV_VAR)
    os.environ[membudget.ENV_VAR] = 'auto'
    try:
        pipeline = bench.run_pipeline(url, device, workers)
    finally:
        if saved is None:
            os.environ.pop(membudget.ENV_VAR, None)
        else:
            os.environ[membudget.ENV_VAR] = saved
    profile = pipeline['pipeline_stage_profile']
    row = profile['cache_tier_sweep'].get('chunk-store')
    mem = profile.get('mem')
    if (row is None or 'error' in row or 'not_ported' in row or row['decode_s'] != 0.0
            or row['chunk_store']['hits'] == 0 or mem is None or not mem['budget_bytes']
            or mem['breaches']):
        raise AssertionError('pipeline: chunk-store row {}, mem block {}'.format(row, mem))
    stream = profile['per_device_stream']
    if ((stream['world_size'], stream['n_devices']) != (1, 1) or stream['shards_put'] == 0
            or not stream['per_device_h2d_GBps'].get('cuda:0')):
        raise AssertionError('pipeline: per_device_stream block {}'.format(stream))
    if membudget.get_governor().armed:
        raise AssertionError('the pipeline left the memory governor armed')
    return pipeline


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--steps', type=int, default=20, help='measured SGD steps (after 3 warm-up)')
    parser.add_argument('--out', default=None, help='also write every JSON line to this file')
    # One run of the preemptible phase, started by the phase itself.
    parser.add_argument('--preemptible-role', choices=('U', 'S1', 'S2'), help=argparse.SUPPRESS)
    parser.add_argument('--preemptible-url', help=argparse.SUPPRESS)
    parser.add_argument('--preemptible-dir', help=argparse.SUPPRESS)
    parser.add_argument('--preemptible-launched', type=float, help=argparse.SUPPRESS)
    # The mesh phase's child process.
    parser.add_argument('--mesh-role', action='store_true', help=argparse.SUPPRESS)
    parser.add_argument('--mesh-url', help=argparse.SUPPRESS)
    parser.add_argument('--mesh-dir', help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.steps < 10:
        parser.error('--steps must be >= 10')

    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this script needs a GPU',
              file=sys.stderr)
        return 2
    if bench is None:
        print('chip_smoke: petastorm_tpu_torch is not beside this script; run it from the '
              'root of a checkout', file=sys.stderr)
        return 2
    if args.preemptible_role:
        preemptible_role(args.preemptible_role, args.preemptible_url, args.preemptible_dir,
                         args.preemptible_launched)
        return 0
    if args.mesh_role:
        mesh_role(args.mesh_url, args.mesh_dir)
        return 0

    lines = []

    started = time.perf_counter()

    def record(obj):
        if 'phase' in obj:      # seconds since the script started, on each phase's line
            obj = dict(obj, elapsed_s=time.perf_counter() - started)
        bench.emit(obj)
        lines.append(obj)

    device = torch.device('cuda', 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    card = '{} ({})'.format(name, smi.splitlines()[0])
    record({'phase': 'device', 'name': name, 'count': torch.cuda.device_count(),
            'nvidia_smi': smi, 'torch': torch.__version__, 'cuda': torch.version.cuda})

    # nvcc builds both flash libraries in the background, at once, while
    # K1's Triton kernel compiles and runs.
    from petastorm_tpu_torch.ops import flash_attention

    def timed_build(load):
        start = time.perf_counter()
        load()
        return time.perf_counter() - start

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        builds = {source: pool.submit(timed_build, load) for source, load in (
            (flash_attention._SOURCE, lambda: flash_attention._library()),
            (flash_attention._SM90_SOURCE,
             lambda: flash_attention._library(flash_attention._SM90_SOURCE)))}
        k1 = check_normalize(device, hbm_rate(name))
        build_s = {source: build.result() for source, build in builds.items()}
    flash, wmma_f32 = check_flash(device, hbm_rate(name))
    record({'phase': 'kernels', 'card': card, 'seconds': time.perf_counter() - t0,
            'build_s': build_s, 'normalize_images': k1, 'flash': flash, 'wmma_f32': wmma_f32})

    os.makedirs(BUILD_DIR, exist_ok=True)
    store_dir = tempfile.mkdtemp(prefix='smoke_store_', dir=BUILD_DIR)
    try:
        t0 = time.perf_counter()
        url = bench.write_imagenet_store(os.path.join(store_dir, 'imagenet'))
        record({'phase': 'store', 'path': 'imagenet', 'rows': ROWS, 'rows_per_group': ROWS_PER_GROUP,
                'codec': 'jpeg q90', 'seconds': time.perf_counter() - t0})
        t0 = time.perf_counter()
        lm_url = bench.write_lm_store(os.path.join(store_dir, 'lm'))
        record({'phase': 'store', 'path': 'lm', 'rows': LM_ROWS, 'rows_per_group': ROWS_PER_GROUP,
                'codec': 'ndarray int32 ({},)'.format(LM_SEQ), 'seconds': time.perf_counter() - t0})
        record(dict(check_first_batch(url, device), phase='checks'))
        record(dict(check_model(device), phase='checks'))
        record(dict(check_lm_model(device), phase='checks'))
        record(dict(check_vit_flash(device), phase='checks'))
        record(dict(check_moe_model(device), phase='checks'))
        for entry in check_scan_graph(device):
            record(dict(entry, phase='checks'))
        result = run_imagenet(url, device, args.steps, card)
        record(result)
        k1['launches'] = result['launches'].get('normalize_images', 0)
        by_path = {'imagenet': k1['launches']}
        result, state = bench.run_imagenet_scan(url, device, card, calls=SCAN_CALLS)
        record(result)
        imagenet_scan = result
        imagenet_scan_rate = result['img_per_s']
        by_path['imagenet_scan'] = bench.path_launches(result, 'normalize_images',
                                                       'normalize_kernel')
        result = bench.run_imagenet_hbm(url, device, card, state)
        record(result)
        by_path['imagenet_hbm'] = bench.path_launches(result, 'normalize_images',
                                                      'normalize_kernel')
        rates = {'imagenet_scan': imagenet_scan_rate, 'imagenet_hbm': result['img_per_s']}
        chunk_dir = os.path.join(store_dir, 'chunks')
        result = bench.run_imagenet_chunkstore(url, device, card, state, chunk_dir,
                                               calls=SCAN_CALLS)
        record(result)
        by_path['imagenet_chunkstore'] = bench.path_launches(result, 'normalize_images',
                                                             'normalize_kernel')
        result = bench.run_imagenet_hbm_partial(url, device, card, state,
                                                os.path.join(chunk_dir, 'transcoded'), rates)
        record(result)
        by_path['imagenet_hbm_partial'] = {
            window: bench.path_launches(result[window], 'normalize_images', 'normalize_kernel')
            for window in ('partial', 'after_eviction')}
        shutil.rmtree(chunk_dir, ignore_errors=True)
        k1['launches_by_path'] = by_path
        lm_result = run_lm(lm_url, device, args.steps, card)
        record(lm_result)
        scans = {'lm_scan': bench.run_lm_scan(lm_url, device, card)}
        record(scans['lm_scan'])
        record(bench.run_imagenet_vit(url, device, card))
        aug = bench.run_imagenet_aug(url, device, card, state, epochs=AUG_EPOCHS)
        record(aug)
        by_path['imagenet_aug'] = bench.path_launches(aug['augmented'], 'normalize_images',
                                                      'normalize_kernel')
        del state
        t0 = time.perf_counter()
        long_rows = bench.lm_rows(LONG_SEQ)
        long_url = bench.write_lm_store(os.path.join(store_dir, 'lm_long'), long_rows, LONG_SEQ)
        record({'phase': 'store', 'path': 'lm_long', 'rows': long_rows,
                'rows_per_group': ROWS_PER_GROUP, 'codec': 'ndarray int32 ({},)'.format(LONG_SEQ),
                'seconds': time.perf_counter() - t0})
        scans['lm_long'] = bench.run_lm_scan(long_url, device, card, seq=LONG_SEQ,
                                             batch=LONG_BATCH, k=LONG_K, steps=LONG_STEPS)
        record(scans['lm_long'])
        scans['lm_moe'] = bench.run_lm_scan(lm_url, device, card, steps=MOE_STEPS,
                                            layers=MOE_LAYERS, moe_experts=MOE_EXPERTS)
        record(scans['lm_moe'])
        mesh = run_mesh(url, card)
        mesh['single_gpu'] = {
            'imagenet_scan': {k: imagenet_scan[k] for k in (
                'img_per_s', 'device_step_ms', 'peak_mem_GB')},
            'lm_scan': {k: scans['lm_scan'][k] for k in (
                'tokens_per_s', 'device_step_ms', 'peak_mem_GB')}}
        record(mesh)
        by_path['mesh_resnet'] = bench.path_launches(mesh['resnet'], 'normalize_images',
                                                     'normalize_kernel')
        workers = max(4, min(10, os.cpu_count() or 4))
        pipeline = run_pipeline_governed(url, device, workers)
        record(dict({'phase': 'pipeline', 'card': card}, **pipeline))
        record(dict(check_loader_surface(store_dir, device), phase='loader_surface', card=card))
        preempt = run_preemptible(url, card)
        preempt['imagenet_scan_img_per_s'] = imagenet_scan_rate
        record(preempt)
        by_path['preemptible_s2'] = preempt['k1_launches_s2_window']
        examples = run_examples(store_dir, device, card)
        record(examples)
        by_path['example_imagenet'] = examples['imagenet']['launches']['normalize_images']
        for k in flash:
            k['launches'] = lm_result['launches'].get(k['name'], 0)
            k['launches_by_path'] = dict(
                {'lm': k['launches'],
                 'example_long_context': examples['long_context']['launches'][k['name']]},
                **{path: bench.path_launches(scan, k['name'], k['name'] + '_kernel')
                   for path, scan in dict(scans, mesh_lm_a2a=mesh['lm']).items()})
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
    keys = ('name', 'route', 'kernel_route', 'source', 'replaces', 'launches', 'max_abs_err', 'ms',
            'plain_ms',
            'bound_ms', 'bound_by', 'library_ms', 'previous_ms', 'host_bound', 'launches_by_path',
            'ptxas', 'variant', 'shape', 'block', 'num_warps', 'variants')
    record({'kernels': [{key: k[key] for key in keys if key in k} for k in [k1] + flash]})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as f:
            for obj in lines:
                f.write(json.dumps(obj) + '\n')
    print(smi.splitlines()[0], flush=True)
    bench.emit({'ok': True, 'device': {'platform': 'gpu', 'kind': name,
                                       'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
