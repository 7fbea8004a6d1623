"""The port's bench (counterpart of the repo's ``bench.py`` children).

    python -m petastorm_tpu_torch.bench                      # every child, in order
    python -m petastorm_tpu_torch.bench --child pipeline     # one child, one JSON line

Run with no ``--child``, it writes the bench's stores (the ImageNet-shaped
JPEG store of ``bench.py:99-127``, the token stores of ``bench.py:130-157``)
into ``--workdir`` (default: a temporary directory, removed at the end) and
runs the children in the bench's probe order (``bench.py:2475-2560``), each
in a subprocess under a timeout as ``bench.py:_run_child`` does: imagenet,
pipeline, imagenet_vit, lm, lm_long, lm_moe, flashattn, imagenet_aug. It
prints one JSON object with a key per child and exits 1 when any child
failed, naming which.

The variants are chosen through the ``BENCH_*`` environment variables that
``bench.py`` sets (``BENCH_IMAGENET_MODEL``, ``BENCH_IMAGENET_AUG``,
``BENCH_LM_SEQ``, ``BENCH_LM_BATCH``, ``BENCH_LM_SCAN_K``,
``BENCH_LM_STEPS``, ``BENCH_LM_MOE``, ``BENCH_LM_LAYERS``): a named variant
(``--child lm_long``) sets its defaults, and the environment overrides them.

Children run on the card. The scan children follow the bench's protocol
through the port: the memory cache, ``superbatches(8)``, the K-step scan
trainer captured as one CUDA graph and replayed, the HBM tier. Their launch
windows (:func:`scan_window`) count each hand kernel by name among the
captured graph's kernel nodes, times the replays; ``chip_smoke.py`` drives
the same functions and holds the counts. ``--device cpu`` exists for the tests and runs the ``pipeline``
child only. No MFU is reported (the bench's TPU peak table has no
counterpart here): the children report device ms a step instead.
"""

import argparse
import json
import math
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(ROOT, '.torch_build')

# The bench's stores (bench.py:39-50, 99-157).
BATCH = 128
IMAGE = 224
ROWS = 2048
ROWS_PER_GROUP = 256
LM_VOCAB, LM_D, LM_HEADS, LM_LAYERS, LM_SEQ = 32768, 512, 8, 8, 1025
LM_BATCH, LM_ROWS = 8, 2048
# The bench's scan protocol (bench.py:1819-1821, 1855, 1859; 193-194, 260-269).
SCAN_K = 8
SCAN_PREFETCH = 8
HBM_EPOCHS = max(6, 2 * SCAN_K)
# imagenet_vit (bench.py:2511-2515) and imagenet_aug (bench.py:2553-2557): HBM epochs.
VIT_HBM_EPOCHS = 4
AUG_EPOCHS = 4
# The bench's flashattn child (bench.py:1555-1650).
FLASH_SEQS = '2048,8192,16384'
#: Profiled calls of an eager path after its launch counts are read.
TRACED_CALLS = 3
#: ``CUgraphNodeType`` (``cuda.h``): a kernel node and a child-graph node.
_KERNEL_NODE, _CHILD_GRAPH_NODE = 0, 4
FLASH_WRAPPERS = ('flash_fwd', 'flash_dq', 'flash_dkv', 'flash_fwd_sm90', 'flash_dq_sm90',
                  'flash_dkv_sm90')
FLASH_KERNELS = ('flash_fwd_sm90_kernel', 'flash_dq_sm90_kernel', 'flash_dkv_sm90_kernel')

#: The pipeline child's blocks that wait on modules not yet ported, by the
#: ROADMAP item that brings them.
PIPELINE_NOT_PORTED = {
    'autotune': 'ROADMAP §A9 (autotune)',
    'decode_path_sweep': 'ROADMAP §A9 (the native decoders)',
}
#: The cache tiers the pipeline child sweeps (``BENCH_PIPELINE_CACHE_TIERS``).
PIPELINE_CACHE_TIERS = ('null', 'memory', 'chunk-store')


def emit(obj):
    print(json.dumps(obj), flush=True)


def _env_int(name, default):
    return int(os.environ.get(name, str(default)))


# --------------------------------------------------------------------------
# stores
# --------------------------------------------------------------------------

def synthetic_image(rng, size):
    """A photo-like image: a low-frequency random field plus mild noise (the
    bench's ImageNet stand-in, ``bench.py:86-92``, so JPEG sizes and decode
    costs are real)."""
    low = rng.integers(0, 255, (size // 16, size // 16, 3), dtype=np.uint8)
    img = np.kron(low, np.ones((16, 16, 1), dtype=np.uint8))
    noise = rng.integers(0, 24, (size, size, 3), dtype=np.uint8)
    return np.clip(img.astype(np.int16) + noise - 12, 0, 255).astype(np.uint8)


def write_imagenet_store(path, rows=ROWS, size=IMAGE):
    """The bench's ImageNet store (``bench.py:95-127``) with the port's
    writer: 224x224x3 JPEG q90, int64 label, 256-row groups, seed 7."""
    from petastorm_tpu_torch import (CompressedImageCodec, ScalarCodec, Unischema,
                                     UnischemaField, write_dataset)
    schema = Unischema('ImagenetSchema', [
        UnischemaField('image', np.uint8, (size, size, 3), CompressedImageCodec('jpeg', 90)),
        UnischemaField('label', np.int64, (), ScalarCodec(np.int64)),
    ])
    rng = np.random.default_rng(7)
    url = 'file://' + path
    write_dataset(url, schema, ({'image': synthetic_image(rng, size),
                                 'label': int(rng.integers(0, 1000))} for _ in range(rows)),
                  rows_per_row_group=ROWS_PER_GROUP)
    return url


def write_lm_store(path, rows=LM_ROWS, seq=LM_SEQ):
    """The bench's token store (``bench.py:130-157``), with the port's writer."""
    from petastorm_tpu_torch import NdarrayCodec, Unischema, UnischemaField, write_dataset
    schema = Unischema('LMBenchSchema', [
        UnischemaField('tokens', np.int32, (seq,), NdarrayCodec(), False)])
    rng = np.random.default_rng(11)
    url = 'file://' + path
    write_dataset(url, schema, ({'tokens': rng.integers(0, LM_VOCAB, seq, dtype=np.int32)}
                                for _ in range(rows)), rows_per_row_group=ROWS_PER_GROUP)
    return url


def lm_rows(seq):
    """Rows of the token store for ``seq`` (``bench.py:138``)."""
    return LM_ROWS if seq <= 2048 else max(256, LM_ROWS * 1024 // seq)


def ensure_imagenet_store(workdir):
    path = os.path.join(workdir, 'imagenet')
    if not os.path.exists(os.path.join(path, '_common_metadata')):
        shutil.rmtree(path, ignore_errors=True)
        write_imagenet_store(path)
    return 'file://' + path


def ensure_lm_store(workdir, seq):
    path = os.path.join(workdir, 'lm_{}'.format(seq))
    if not os.path.exists(os.path.join(path, '_common_metadata')):
        shutil.rmtree(path, ignore_errors=True)
        write_lm_store(path, lm_rows(seq), seq)
    return 'file://' + path


# --------------------------------------------------------------------------
# launch counts and traces
# --------------------------------------------------------------------------

def reset_launch_counts():
    from petastorm_tpu_torch.ops import flash_attention, image_ops
    image_ops.reset_launch_counts()
    flash_attention.reset_launch_counts()


def launch_counts():
    from petastorm_tpu_torch.ops import flash_attention, image_ops
    return dict(image_ops.LAUNCHES, **flash_attention.LAUNCHES)


def device_profile(run):
    """``run()`` under ``torch.profiler``, CUDA activity only: the
    profile's events by name (``key_averages()``: kernels, copies, sets)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return prof.key_averages()


def busy_trace(events, calls, call_ms):
    """The card's busy time a call over ``calls`` profiled calls (kernels,
    copies and sets), its idle share against ``call_ms`` (the unprofiled
    device time of a call) and the five kernels that take the most of it;
    None if the profiler recorded no device time."""
    events = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / calls
    if busy_ms == 0:
        return {'traced_calls': calls, 'device_busy_ms_per_call': None,
                'device_idle_share': None}
    return {'traced_calls': calls, 'device_busy_ms_per_call': busy_ms,
            'device_idle_share': 1 - busy_ms / call_ms,
            'top_kernels_ms_per_call': [[e.key, e.self_device_time_total / 1e3 / calls]
                                        for e in events[:5]]}


def trace_calls(call, call_ms):
    """``TRACED_CALLS`` more calls of an eager path's step (after its
    launch counts are read), traced: see :func:`busy_trace`."""
    return busy_trace(device_profile(lambda: [call() for _ in range(TRACED_CALLS)]),
                      TRACED_CALLS, call_ms)


def per_step(trace, k):
    """``trace`` with the card's busy time a step of a K-step call."""
    busy = trace['device_busy_ms_per_call']
    return dict(trace, device_busy_ms_per_step=None if busy is None else busy / k)


def attention_share(events):
    """The flash kernels' summed busy time over all the card's busy time
    in a profile (kernels, copies, sets)."""
    total = sum(e.self_device_time_total for e in events)
    flash = sum(e.self_device_time_total for e in events
                if any(name in e.key for name in FLASH_KERNELS))
    return {'flash_ms': flash / 1e3, 'busy_ms': total / 1e3,
            'share': flash / total if total else None}


# --------------------------------------------------------------------------
# the scan protocol: K steps a call as one CUDA graph replay
# --------------------------------------------------------------------------

def _launch_diff(after, before):
    return {name: count - before.get(name, 0) for name, count in after.items()
            if count != before.get(name, 0)}


def graph_kernels(graph):
    """The kernel nodes of a captured ``torch.cuda.CUDAGraph`` made with
    ``keep_graph=True`` (as :class:`~petastorm_tpu_torch.models.train.
    ScanStep` makes it), by kernel name: ``{name: nodes}``, child graphs
    included. Read through the CUDA driver's graph API; each replay runs
    every node once."""
    import collections
    import ctypes

    driver = ctypes.CDLL('libcuda.so.1')

    class KernelNodeParams(ctypes.Structure):      # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [('func', ctypes.c_void_p), ('grid', ctypes.c_uint * 3),
                    ('block', ctypes.c_uint * 3), ('shared_mem_bytes', ctypes.c_uint),
                    ('kernel_params', ctypes.c_void_p), ('extra', ctypes.c_void_p),
                    ('kern', ctypes.c_void_p), ('ctx', ctypes.c_void_p)]

    def call(name, *args):
        result = getattr(driver, name)(*args)
        if result != 0:
            raise RuntimeError('{} failed with CUresult {}'.format(name, result))

    def kernel_name(node):
        params = KernelNodeParams()
        call('cuGraphKernelNodeGetParams_v2', node, ctypes.byref(params))
        name = ctypes.c_char_p()
        if params.func:
            call('cuFuncGetName', ctypes.byref(name), ctypes.c_void_p(params.func))
        else:
            call('cuKernelGetName', ctypes.byref(name), ctypes.c_void_p(params.kern))
        return name.value.decode()

    counts = collections.Counter()

    def walk(handle):
        n = ctypes.c_size_t(0)
        call('cuGraphGetNodes', handle, None, ctypes.byref(n))
        nodes = (ctypes.c_void_p * n.value)()
        call('cuGraphGetNodes', handle, nodes, ctypes.byref(n))
        for node in nodes:
            node = ctypes.c_void_p(node)
            kind = ctypes.c_int()
            call('cuGraphNodeGetType', node, ctypes.byref(kind))
            if kind.value == _KERNEL_NODE:
                counts[kernel_name(node)] += 1
            elif kind.value == _CHILD_GRAPH_NODE:
                child = ctypes.c_void_p()
                call('cuGraphChildGraphNodeGetGraph', node, ctypes.byref(child))
                walk(child)

    walk(ctypes.c_void_p(graph.raw_cuda_graph()))
    return dict(counts)


def graph_launches(train, kernels, replays):
    """How many times each of ``kernels`` (a substring of kernel names) ran
    in ``replays`` replays of ``train``'s captured graph: its kernel nodes
    (:func:`graph_kernels`) times the replays."""
    nodes = graph_kernels(train.graph) if train.graph is not None else {}
    return {name: replays * sum(n for kernel, n in nodes.items() if name in kernel)
            for name in kernels}


def scan_window(train, state, next_inputs, warmup, calls, kernels):
    """One scan path's counted window: the launch counts zeroed, ``warmup``
    calls (call 1 eager, call 2 captures the graph and replays it, later
    calls replay), then ``calls`` measured calls under ``torch.profiler``
    (the path's trace), the counts read. A replay calls no wrapper, so the
    wrappers count call 1 and the capture; each of ``kernels`` is counted
    in the window's replays by :func:`graph_launches`. Returns (metrics of
    each call, the wrappers' counts, their counts across the capturing
    call, the kernels that ran in the window's replays, the measured calls'
    profile, the number of replays)."""
    metrics, captured = [], {}

    def run(n):
        for _ in range(n):
            capturing, before = train.graph is None and train.calls == 1, launch_counts()
            metrics.append(train(state, *next_inputs()))
            if capturing:
                captured.update(_launch_diff(launch_counts(), before))

    reset_launch_counts()                            # the path starts here
    replays = train.replays
    run(warmup)
    measured = device_profile(lambda: run(calls))
    launches = launch_counts()                       # the path ends here
    replays = train.replays - replays
    return (metrics, launches, captured, graph_launches(train, kernels, replays), measured,
            replays)


def require_scan_launches(launches, captured, ran, wrappers, per_call, replays):
    """Fail unless each wrapper counted ``per_call`` launches in call 1 and
    as many in the capture, and each kernel ran ``per_call`` times in each
    of the window's ``replays``."""
    wrapped = {name: launches.get(name, 0) for name in wrappers}
    if (wrapped != dict.fromkeys(wrappers, 2 * per_call)
            or captured != dict.fromkeys(wrappers, per_call)
            or ran != dict.fromkeys(ran, per_call * replays)):
        raise AssertionError('scan path launches: wrappers {}, across the capture {}, ran in the '
                             'replays {}; expected {} a call in {} replays'.format(
                                 wrapped, captured, ran, per_call, replays))


def require_no_kernel(window):
    """Fail unless no wrapper counted a launch and no listed kernel ran."""
    launches, captured, ran, calls = window
    if any(launches.values()) or captured or any(ran.values()):
        raise AssertionError('a path without hand kernels launched {} (capture {}, ran {}) in {} '
                             'calls'.format(launches, captured, ran, calls))


def time_scan_calls(train, state, next_inputs, calls):
    """``calls`` more calls, unprofiled, after the counted window: (wall
    seconds, seconds blocked in ``next_inputs``, median device ms a call,
    metrics)."""
    import torch
    torch.cuda.synchronize()
    metrics, events, wait_s = [], [], 0.0
    t_start = time.perf_counter()
    for _ in range(calls):
        t0 = time.perf_counter()
        inputs = next_inputs()
        wait_s += time.perf_counter() - t0
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        metrics.append(train(state, *inputs))
        ev[1].record()
        events.append(ev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    return wall, wait_s, float(np.median([a.elapsed_time(b) for a, b in events])), metrics


def _scan_launches(launches, captured, ran, calls, replays):
    return {'wrappers': launches, 'across_capture': captured, 'ran_on_card': ran,
            'calls': calls, 'replays': replays}


def path_launches(result, wrapper, kernel):
    """A kernel's launches on a scan path, each counted in that path's own
    window: its wrapper's (call 1 and the capture), the wrapper's across
    the capture (the kernels the graph holds), and the kernels that ran on
    the card in the window's replays, counted by name in the graph."""
    launches = result['launches']
    return {'wrapper': launches['wrappers'].get(wrapper, 0),
            'across_capture': launches['across_capture'].get(wrapper, 0),
            'ran_on_card': launches['ran_on_card'][kernel], 'calls': launches['calls'],
            'replays': launches['replays']}


def normalize_bf16(x):
    """The imagenet child's preprocess: K1 normalize -> bf16."""
    import torch
    from petastorm_tpu_torch.ops.image_ops import normalize_images
    return normalize_images(x, dtype=torch.bfloat16)


def bare_cast(images):
    """The bench's preprocess without augment (``bench.py:1890-1895``)."""
    return images.float() / 255.0


def resnet50_state(device, mesh=None, seed=0):
    """The bench's ResNet-50 (``conv7`` stem, 1000 classes, bf16,
    channels_last), weights from ``seed``, SGD lr 0.1 momentum 0.9; on a
    ``mesh`` (the head split over ``'model'``)."""
    import torch
    from petastorm_tpu_torch.models import ResNet50, create_train_state
    from petastorm_tpu_torch.models.resnet import init_flax_like

    torch.backends.cudnn.benchmark = True
    model = init_flax_like(ResNet50(num_classes=1000, stem='conv7', dtype=torch.bfloat16,
                                    device=device), torch.Generator().manual_seed(seed))
    return create_train_state(model.to(memory_format=torch.channels_last), learning_rate=0.1,
                              momentum=0.9, mesh=mesh)


def lm_model(device, layers, max_len, moe_experts=0, attention='flash', mesh=None,
             seq_axis=None):
    """The bench's TransformerLM (``bench.py:186-209``) at the lm widths,
    bf16, weights from seed 0; flash attention, or ``'a2a'``/``'ring'`` over
    ``seq_axis`` of ``mesh``."""
    import torch
    from petastorm_tpu_torch.models import TransformerLM
    from petastorm_tpu_torch.models.transformer import init_flax_like
    model = TransformerLM(LM_VOCAB, LM_D, LM_HEADS, layers, max_len=max_len, attention=attention,
                          moe_experts=moe_experts, dtype=torch.bfloat16, device=device, mesh=mesh,
                          seq_axis=seq_axis)
    return init_flax_like(model, torch.Generator().manual_seed(0))


def staging_counters(stats):
    """The staging engine's and the arena pool's counters of a loader's
    stats (``bench.py:_staging_counters``)."""
    return {k: stats.get(k, 0) for k in
            ('assemble_s', 'dispatch_s', 'overlap_s', 'overlap_frac', 'overlap_frac_total',
             'ready_wait_s', 'arena_reuse', 'arena_alloc', 'arena_wait_s')}


def stage_profile(stats, timings0, timings, wall_s):
    """A stage profile over one stats window: the workers' read, decode
    and cache seconds, the copies' issue time, the consumer's wait, the
    staging counters and the H2D rate."""
    profile = {k: timings.get(k, 0.0) - timings0.get(k, 0.0)
               for k in ('read_s', 'decode_s', 'cache_s')}
    profile.update(stage_dispatch_s=stats['stage_dispatch_s'], consumer_wait_s=stats['wait_s'],
                   wall_s=wall_s, reader_wait_s=stats.get('reader_wait_s', 0.0),
                   h2d_GBps=stats['h2d_bytes'] / stats['h2d_s'] / 1e9 if stats['h2d_s'] else None)
    profile.update(staging_counters(stats))
    return profile


def stream_classifier_scan(url, device, train, state, warmup, calls, kernels,
                           cache_type='memory', cache_location=None, mesh=None):
    """A classifier scan path streamed from a cache tier (the bench's
    ``_child_imagenet`` loop): the reader with ``cache_type`` (default
    ``'memory'``; endless, seed 0), ``TorchLoader(batch=128, prefetch=8)``,
    ``superbatches(8)``; :func:`scan_window` over ``warmup`` + ``calls``
    calls, then ``calls`` timed (the stage profile covers those). A chunk
    store's queued writes are flushed before the timed calls. On a ``mesh``
    the reader is ``make_pod_reader``'s and the loader the mesh's (128 is
    the global batch). Returns the path's line (without phase and model
    keys) and its launch window."""
    import torch
    from petastorm_tpu_torch import TorchLoader, make_pod_reader

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    reader = make_pod_reader(url, mesh=mesh, pod_shard=None if mesh else (0, 1),
                             schema_fields=['image', 'label'], reader_pool_type='thread',
                             workers_count=4, shuffle_row_groups=True, seed=0, num_epochs=None,
                             cache_type=cache_type, cache_location=cache_location)
    with reader:
        with TorchLoader(reader, BATCH, device=device, prefetch=SCAN_PREFETCH,
                         mesh=mesh) as loader:
            groups = loader.superbatches(SCAN_K)

            def next_inputs():
                sb = next(groups)
                return sb.image, sb.label

            metrics, launches, captured, ran, measured, replays = scan_window(
                train, state, next_inputs, warmup, calls, kernels)
            if reader.chunk_store is not None and not reader.chunk_store.flush(timeout_s=120):
                raise RuntimeError('the chunk store did not drain its writes before the timed '
                                   'calls')
            stats0, cache0, timings0 = loader.stats, reader.cache_stats(), reader.stage_timings
            loader.reset_stats()
            wall, wait_s, call_ms, timed = time_scan_calls(train, state, next_inputs, calls)
            stats, cache, timings = loader.stats, reader.cache_stats(), reader.stage_timings
    losses = [[float(m['loss']), float(m['last_loss'])] for m in metrics + timed]
    if not all(math.isfinite(v) for pair in losses for v in pair):
        raise AssertionError('non-finite loss: {}'.format(losses))
    rows = (warmup + 2 * calls) * SCAN_K * BATCH
    if stats0['rows'] + stats['rows'] != rows:
        raise AssertionError('loader delivered {} rows, expected {}'.format(
            stats0['rows'] + stats['rows'], rows))
    steps = calls * SCAN_K
    result = {
        'batch': BATCH, 'microbatches': SCAN_K, 'prefetch': SCAN_PREFETCH,
        'cache_type': cache_type, 'warmup_calls': warmup, 'counted_calls': calls,
        'timed_calls': calls, 'losses_mean_last': losses, 'img_per_s': steps * BATCH / wall,
        'step_ms': wall / steps * 1e3, 'input_stall_frac': wait_s / wall,
        'h2d_GBps': stats['h2d_bytes'] / stats['h2d_s'] / 1e9 if stats['h2d_s'] else None,
        'device_call_ms_median': call_ms, 'device_step_ms': call_ms / SCAN_K,
        'cache_timed': {key: cache[key] - cache0[key] for key in ('hits', 'misses')},
        'cache': cache, 'peak_mem_GB': torch.cuda.max_memory_allocated(device) / 1e9,
        'peak_reserved_GB': torch.cuda.max_memory_reserved(device) / 1e9,
        'rows_delivered': stats0['rows'] + stats['rows'],
        'stage_profile': stage_profile(stats, timings0, timings, wall),
        'launches': _scan_launches(launches, captured, ran, warmup + calls, replays),
        'trace': per_step(busy_trace(measured, calls, call_ms), SCAN_K)}
    return result, (launches, captured, ran, replays)


def fill_device_cache(url, device):
    """``_measure_device_cache``'s fill (``bench.py:2120-2130``): a
    one-epoch reader into ``DeviceDatasetCache(shuffle=True, seed=0)``.
    Returns (the cache, seconds)."""
    import torch
    from petastorm_tpu_torch import DeviceDatasetCache, TorchLoader, make_tensor_reader

    reader = make_tensor_reader(url, schema_fields=['image', 'label'], reader_pool_type='thread',
                                workers_count=4, num_epochs=1, seed=0, cache_type='memory')
    t0 = time.perf_counter()
    with reader:
        with TorchLoader(reader, BATCH, device=device) as loader:
            cache = DeviceDatasetCache(loader, shuffle=True, seed=0)
            for _ in cache.epoch(0):
                pass
    torch.cuda.synchronize()
    return cache, time.perf_counter() - t0


def hbm_scan(cache, train, state, epochs, kernels, first_epoch=1, observe=None):
    """Superbatches of ``SCAN_K`` cached batches, carried across epoch
    boundaries, through ``train`` (a scan step of its own, its own
    capture): epoch ``first_epoch`` warms up (call 1 eager, call 2
    captures), the next ``epochs`` are counted (:func:`scan_window`), and as
    many more timed. ``observe(epoch, batch)`` sees each batch. Returns the
    path's line (without phase keys) and its launch window."""
    import torch

    def superbatches():
        group, epoch = [], first_epoch
        while True:
            for b in cache.epoch(epoch):
                if observe is not None:
                    observe(epoch, b)
                group.append(b)
                if len(group) == SCAN_K:
                    yield type(b)(*(torch.cat(columns) for columns in zip(*group)))
                    group = []
            epoch += 1

    stream = superbatches()

    def next_inputs():
        sb = next(stream)
        return sb.image, sb.label

    per_epoch = ROWS // BATCH // SCAN_K
    warmup, calls = per_epoch, per_epoch * epochs
    metrics, launches, captured, ran, measured, replays = scan_window(
        train, state, next_inputs, warmup, calls, kernels)
    wall, _, call_ms, timed = time_scan_calls(train, state, next_inputs, calls)
    losses = [float(m['loss']) for m in metrics + timed]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError('hbm path losses: {}'.format(losses))
    steps = calls * SCAN_K
    result = {
        'microbatches': SCAN_K, 'warmup_calls': warmup, 'counted_calls': calls,
        'timed_calls': calls, 'epochs_counted': epochs, 'epochs_timed': epochs,
        'img_per_s': steps * BATCH / wall, 'step_ms': wall / steps * 1e3,
        'device_call_ms_median': call_ms, 'device_step_ms': call_ms / SCAN_K,
        'hbm_cached_GB': cache.nbytes / 1e9, 'cache_stats': cache.stats(),
        'loss_first_last': [losses[0], losses[-1]],
        'peak_mem_GB': torch.cuda.max_memory_allocated() / 1e9,
        'peak_reserved_GB': torch.cuda.max_memory_reserved() / 1e9,
        'launches': _scan_launches(launches, captured, ran, warmup + calls, replays),
        'trace': per_step(busy_trace(measured, calls, call_ms), SCAN_K)}
    return result, (launches, captured, ran, replays)


def run_imagenet_scan(url, device, card, warmup=3, calls=5):
    """The imagenet child streamed: ResNet-50 through
    ``make_scan_train_step(8, preprocess=K1 normalize -> bf16)``; K1 must
    run 8 times a call. Returns (its line, the trained state)."""
    from petastorm_tpu_torch.models import make_scan_train_step

    state = resnet50_state(device)
    train = make_scan_train_step(SCAN_K, preprocess=normalize_bf16)
    result, window = stream_classifier_scan(url, device, train, state, warmup, calls,
                                            ('normalize_kernel',))
    require_scan_launches(*window[:3], ('normalize_images',), SCAN_K, window[3])
    return dict({'phase': 'imagenet_scan', 'card': card, 'model': 'resnet50', 'stem': 'conv7',
                 'classes': 1000}, **result), state


def run_imagenet_hbm(url, device, card, state):
    """``_measure_device_cache`` through the port on ``state``: see
    :func:`hbm_scan`."""
    import torch
    from petastorm_tpu_torch.models import make_scan_train_step

    torch.cuda.reset_peak_memory_stats(device)
    cache, fill_s = fill_device_cache(url, device)
    train = make_scan_train_step(SCAN_K, preprocess=normalize_bf16)
    result, window = hbm_scan(cache, train, state, HBM_EPOCHS, ('normalize_kernel',))
    require_scan_launches(*window[:3], ('normalize_images',), SCAN_K, window[3])
    return dict({'phase': 'imagenet_hbm', 'card': card, 'fill_s': fill_s}, **result)


def _epoch_digests(loader):
    """Per-field CRC32 digests of each batch of ``loader``, on the host."""
    from petastorm_tpu_torch.lineage import _digest_array
    return [{name: _digest_array(getattr(b, name).cpu().numpy()) for name in b._fields}
            for b in loader]


def _store_epoch(url, device, store_dir):
    """One epoch of the imagenet store through a chunk-store reader (in
    order: 4 workers, resequenced) and ``TorchLoader`` on ``device``: (the
    batches' digests, the workers' stage timings, the store's counters)."""
    from petastorm_tpu_torch import TorchLoader, make_tensor_reader
    reader = make_tensor_reader(url, schema_fields=['image', 'label'], workers_count=4,
                                num_epochs=1, shuffle_row_groups=False, deterministic=True,
                                cache_type='chunk-store', cache_location=store_dir)
    with reader:
        with TorchLoader(reader, BATCH, device=device) as loader:
            digests = _epoch_digests(loader)
        store = reader.chunk_store
        if not store.flush(timeout_s=120):
            raise RuntimeError('the chunk store did not drain its writes')
        return digests, reader.stage_timings, store.stats()


def run_imagenet_chunkstore(url, device, card, state, store_dir, warmup=3, calls=5):
    """``imagenet_scan`` served from the decoded-chunk store: the reader
    with ``cache_type='chunk-store'`` under ``store_dir`` (fresh), the
    bench's scan protocol (:func:`stream_classifier_scan`) on ``state``
    through a scan step of its own; K1 must run 8 times a replay and the
    timed calls decode nothing. Then two checks: an in-order pass of a
    fresh store (epoch 0 decoded, then a new reader's epoch 1 served from
    the mapped entries) gives the same per-field CRC32 digests batch for
    batch; and ``tools.transcode`` fills another store whose first epoch
    decodes nothing."""
    from petastorm_tpu_torch.models import make_scan_train_step
    from petastorm_tpu_torch.tools.transcode import transcode_dataset

    train = make_scan_train_step(SCAN_K, preprocess=normalize_bf16)
    result, window = stream_classifier_scan(url, device, train, state, warmup, calls,
                                            ('normalize_kernel',), cache_type='chunk-store',
                                            cache_location=os.path.join(store_dir, 'scan'))
    require_scan_launches(*window[:3], ('normalize_images',), SCAN_K, window[3])
    timed_decode = result['stage_profile']['decode_s']
    if timed_decode != 0.0:
        raise AssertionError('the timed calls decoded ({} s) instead of reading the store'.format(
            timed_decode))
    cache = result['cache']
    if cache['writes'] != ROWS // ROWS_PER_GROUP or cache['corrupt_quarantined']:
        raise AssertionError('chunk store counters: {}'.format(cache))

    t0 = time.perf_counter()
    decoded, decode_timings, fill = _store_epoch(url, device, os.path.join(store_dir, 'check'))
    fill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    served, serve_timings, serve = _store_epoch(url, device, os.path.join(store_dir, 'check'))
    serve_s = time.perf_counter() - t0
    if (served != decoded or len(served) != ROWS // BATCH or serve['misses']
            or serve_timings['decode_s'] != 0.0 or decode_timings['decode_s'] == 0.0):
        raise AssertionError('mmap-served epoch against the decoded one: {} of {} batches equal, '
                             'store {}, decode_s {} then {}'.format(
                                 sum(a == b for a, b in zip(served, decoded)), len(decoded),
                                 serve, decode_timings['decode_s'], serve_timings['decode_s']))
    t0 = time.perf_counter()
    report = transcode_dataset(url, os.path.join(store_dir, 'transcoded'), workers_count=4)
    transcode_s = time.perf_counter() - t0
    transcoded, transcoded_timings, transcoded_stats = _store_epoch(
        url, device, os.path.join(store_dir, 'transcoded'))
    if (not report['complete'] or transcoded_timings['decode_s'] != 0.0
            or transcoded_stats['misses'] or transcoded != decoded):
        raise AssertionError('transcoded store: report {}, epoch 0 decode_s {}, store {}'.format(
            report, transcoded_timings['decode_s'], transcoded_stats))
    return dict({'phase': 'imagenet_chunkstore', 'card': card, 'model': 'resnet50',
                 'stem': 'conv7', 'classes': 1000}, **result, **{
        'decode_s_timed': timed_decode,
        'store': {k: cache[k] for k in ('hits', 'misses', 'fills', 'writes', 'write_skipped',
                                        'corrupt_quarantined', 'readaheads', 'bytes_written',
                                        'bytes_mapped')},
        'digest_check': {'batches': len(served), 'equal': True,
                         'decoded_epoch_s': fill_s, 'served_epoch_s': serve_s,
                         'decoded_img_per_s': ROWS / fill_s, 'served_img_per_s': ROWS / serve_s,
                         'decode_s': [decode_timings['decode_s'], serve_timings['decode_s']]},
        'transcode': dict(report, seconds=transcode_s,
                          epoch0_decode_s=transcoded_timings['decode_s'],
                          epoch0_hits=transcoded_stats['hits'])})


#: The partial HBM tier's budget: 8 of the 16 batches of 19,268,608 bytes
#: fit (154,148,864 bytes), the ninth does not.
PARTIAL_MAX_BYTES = 160_000_000
PARTIAL_RUN_BATCHES = 4
#: Epochs counted (and as many timed) in each partial window, after its
#: warm-up epoch.
PARTIAL_EPOCHS = 6


def _row_digests(images):
    """One int64 digest a row, computed on the card: the row's bytes against
    fixed weights, exactly (no rounding), so equal rows give equal digests."""
    import torch
    flat = images.reshape(images.shape[0], -1)
    weights = _row_digest_weights(flat.shape[1], flat.device)
    return (flat.to(torch.int64) * weights).sum(dim=1)


_ROW_WEIGHTS = {}


def _row_digest_weights(n, device):
    import torch
    key = (n, str(device))
    if key not in _ROW_WEIGHTS:
        _ROW_WEIGHTS[key] = torch.randint(1, 1 << 20, (n,), dtype=torch.int64,
                                          generator=torch.Generator().manual_seed(9)).to(device)
    return _ROW_WEIGHTS[key]


def run_imagenet_hbm_partial(url, device, card, state, store_dir, reference_rates):
    """The partial HBM tier under ResNet-50 scan training: a
    ``DeviceDatasetCache(partial=True, max_bytes=160e6,
    superbatch_batches=4, shuffle=True)`` filled from a deterministic
    chunk-store reader over ``store_dir`` (an in-order pass, 4 workers),
    with ``loader_factory`` a fresh such reader and loader a pass. 8 of the
    16 batches stay resident in two runs; each epoch streams the other 8.
    Epoch 0 fills; :func:`hbm_scan` trains a partial window (its warm-up
    epoch, ``PARTIAL_EPOCHS`` counted, as many timed) through a scan step
    of its own; then a ballast pool drives one ``check()`` of a memory
    governor (installed before the cache) to *degrade*, which evicts the
    coldest run, and the card's allocated bytes must fall by the run's;
    the ballast goes and a second ``check()`` returns the ladder to *ok*;
    then a second window with a new scan step. K1 must run 8 times a replay
    in each window, and every epoch's multiset of per-row image digests
    must equal the fill epoch's."""
    import torch
    from petastorm_tpu_torch import DeviceDatasetCache, TorchLoader, make_tensor_reader, membudget
    from petastorm_tpu_torch.models import make_scan_train_step

    def reader():
        return make_tensor_reader(url, schema_fields=['image', 'label'], workers_count=4,
                                  num_epochs=1, shuffle_row_groups=False, deterministic=True,
                                  cache_type='chunk-store', cache_location=store_dir)

    def factory():
        with reader() as r:
            with TorchLoader(r, BATCH, device=device) as loader:
                yield from loader

    digests = {}

    def observe(epoch, batch):
        digests.setdefault(epoch, []).append(_row_digests(batch.image))

    budget = 16 << 30
    governor = membudget.MemoryGovernor(budget=budget,
                                        config=membudget.GovernorConfig(interval_s=3600))
    previous = membudget.set_governor(governor)
    governor.arm(budget)          # the sampler waits an hour: this phase drives check()
    try:
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        with reader() as r:
            with TorchLoader(r, BATCH, device=device) as loader:
                cache = DeviceDatasetCache(loader, shuffle=True, seed=0, partial=True,
                                           max_bytes=PARTIAL_MAX_BYTES,
                                           superbatch_batches=PARTIAL_RUN_BATCHES,
                                           loader_factory=factory)
                for batch in cache.epoch(0):
                    observe(0, batch)
        torch.cuda.synchronize()
        fill_s = time.perf_counter() - t0
        filled = cache.stats()
        run_bytes = PARTIAL_RUN_BATCHES * BATCH * (IMAGE * IMAGE * 3 + 8)
        if (filled['cached_batches'] != 8 or filled['total_batches'] != ROWS // BATCH
                or filled['superbatches'] != 2 or not filled['fill_stopped']):
            raise AssertionError('partial fill: {}'.format(filled))
        windows, freed = [], None
        for first in (1, 2 + 2 * PARTIAL_EPOCHS):
            if windows:
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated(device)
                ballast = governor.register_pool(
                    'ballast', lambda: int(0.88 * budget) - cache.nbytes)
                state_after = governor.check()
                torch.cuda.synchronize()
                freed = before - torch.cuda.memory_allocated(device)
                evicted = cache.stats()
                # The relief: the advisory toggles (the cache's fill pause,
                # the store's spill, unpinned arenas) end with the episode.
                ballast.close()
                if governor.check() != membudget.STATE_OK:
                    raise AssertionError('the ladder did not recede: {}'.format(
                        governor.probe()))
                # The allocator may keep a run's block whole with its
                # segment's tail (under 1 MiB for a large block), so up to
                # 2 MiB a column more than the run's bytes may go.
                if (state_after != membudget.STATE_DEGRADE or evicted['evictions'] != 1
                        or evicted['cached_batches'] != 4
                        or not run_bytes <= freed < run_bytes + (4 << 20)):
                    raise AssertionError('eviction: state {}, cache {}, {} bytes freed of a {} '
                                         'byte run'.format(state_after, evicted, freed, run_bytes))
            train = make_scan_train_step(SCAN_K, preprocess=normalize_bf16)
            result, window = hbm_scan(cache, train, state, PARTIAL_EPOCHS, ('normalize_kernel',),
                                      first_epoch=first, observe=observe)
            require_scan_launches(*window[:3], ('normalize_images',), SCAN_K, window[3])
            windows.append(result)
        stats = cache.stats()
        probe = governor.stats()
    finally:
        governor.release()
        membudget.set_governor(previous)
    reference = torch.sort(torch.cat(digests[0])).values
    epochs = sorted(digests)
    mismatched = [e for e in epochs if len(digests[e]) == ROWS // BATCH
                  and not torch.equal(torch.sort(torch.cat(digests[e])).values, reference)]
    complete = [e for e in epochs if len(digests[e]) == ROWS // BATCH]
    if mismatched or len(complete) < 1 + 2 * (1 + 2 * PARTIAL_EPOCHS):
        raise AssertionError('per-row image digests: epochs {} differ from the fill epoch; {} '
                             'complete epochs'.format(mismatched, len(complete)))
    cache.clear()
    partial, evicted = windows
    return {'phase': 'imagenet_hbm_partial', 'card': card, 'model': 'resnet50', 'stem': 'conv7',
            'classes': 1000, 'max_bytes': PARTIAL_MAX_BYTES,
            'superbatch_batches': PARTIAL_RUN_BATCHES, 'fill_s': fill_s,
            'fill_img_per_s': ROWS / fill_s, 'fill_stats': filled,
            'partial': partial, 'after_eviction': evicted,
            'img_per_s': {'fill_epoch_no_training': ROWS / fill_s,
                          'partial_8_of_16': partial['img_per_s'],
                          'partial_4_of_16': evicted['img_per_s'],
                          'imagenet_scan': reference_rates.get('imagenet_scan'),
                          'imagenet_hbm': reference_rates.get('imagenet_hbm')},
            'run_bytes': run_bytes, 'eviction_freed_bytes': freed, 'cache_stats': stats,
            'governor': {key: probe[key] for key in ('budget_bytes', 'peak_state',
                                                      'degrade_actions', 'breaches')},
            'digest_epochs': len(complete), 'digests_equal': True}


def run_imagenet_vit(url, device, card, warmup=2, calls=2):
    """The ``imagenet_vit`` child (``bench.py:2511-2515``): ``ViT(num_classes
    =1000)`` at its widths (patch 16, d 384, 6 heads, 8 layers, dense
    attention, bf16) behind the bare cast, SGD lr 0.1 momentum 0.9; streamed
    from the memory cache, then from the HBM tier through a scan step of its
    own. No hand kernel is on this path."""
    import torch
    from petastorm_tpu_torch.models import ViT, create_train_state, make_scan_train_step
    from petastorm_tpu_torch.models.vit import init_flax_like

    model = init_flax_like(ViT(num_classes=1000, image_size=IMAGE, device=device),
                           torch.Generator().manual_seed(0))
    state = create_train_state(model, learning_rate=0.1, momentum=0.9)
    kernels = ('normalize_kernel',) + FLASH_KERNELS
    streamed, window = stream_classifier_scan(
        url, device, make_scan_train_step(SCAN_K, preprocess=bare_cast), state, warmup, calls,
        kernels)
    require_no_kernel(window)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    cache, fill_s = fill_device_cache(url, device)
    hbm, window = hbm_scan(cache, make_scan_train_step(SCAN_K, preprocess=bare_cast), state,
                           VIT_HBM_EPOCHS, kernels)
    require_no_kernel(window)
    return {'phase': 'imagenet_vit', 'card': card, 'model': 'ViT', 'classes': 1000,
            'patch': model.patch_size, 'tokens': model.num_patches + 1, 'd_model': 384,
            'heads': 6, 'layers': len(model.blocks), 'attention': 'dense', 'dtype': 'bfloat16',
            'params': sum(p.numel() for p in model.parameters()), 'preprocess': 'float() / 255',
            'streamed': streamed, 'hbm': dict(hbm, fill_s=fill_s)}


def run_imagenet_aug(url, device, card, state, epochs=AUG_EPOCHS):
    """The ``imagenet_aug`` child (``bench.py:2553-2557``, ``:1872-1889``,
    ``:1975-2010``) on the HBM tier: the ResNet-50 ``state`` trained through
    (b) the bare cast, from a copy of the state, and (a) the augment inside
    the 8-step graph (``imagenet_train_augment``, f32 out; the graph
    registers its generator), each through a scan step of its own;
    ``aug_cost_frac = 1 - aug / bare``. K1 runs 8 times a replay of (a) and
    never in (b); two more replays of (a) must draw different boxes. Each
    window: epoch 1 warms up, ``epochs`` are counted, as many timed."""
    import copy
    import torch
    from petastorm_tpu_torch.models import make_scan_train_step
    from petastorm_tpu_torch.ops.augment import (apply_imagenet_train_augment,
                                                 sample_imagenet_train_augment)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    cache, fill_s = fill_device_cache(url, device)
    bare_state = copy.deepcopy(state)
    bare, window = hbm_scan(cache, make_scan_train_step(SCAN_K, preprocess=bare_cast),
                            bare_state, epochs, ('normalize_kernel',))
    require_no_kernel(window)
    del bare_state
    torch.cuda.empty_cache()

    boxes = []

    def augment(images, generator):
        """``imagenet_train_augment`` (its two halves), keeping the boxes."""
        n, h, w, _ = images.shape
        params = sample_imagenet_train_augment(n, h, w, generator, images.device)
        boxes.append(params['box'][0])
        return apply_imagenet_train_augment(images, params, IMAGE, IMAGE, dtype=torch.float32)

    train = make_scan_train_step(SCAN_K, preprocess=augment,
                                 generator=torch.Generator(device=device).manual_seed(0))
    aug, window = hbm_scan(cache, train, state, epochs, ('normalize_kernel',))
    require_scan_launches(*window[:3], ('normalize_images',), SCAN_K, window[3])
    if len(boxes) != 2 * SCAN_K:
        raise AssertionError('the augment ran {} times on the host; expected {} (call 1 and the '
                             'capture)'.format(len(boxes), 2 * SCAN_K))
    superbatch = [b for _, b in zip(range(SCAN_K), cache.epoch(1))]
    inputs = [torch.cat(column) for column in zip(*superbatch)]
    drawn = []
    for _ in range(2):
        train(state, *inputs)
        drawn.append(boxes[-1].clone())                  # the graph rewrites it each replay
    if torch.equal(*drawn):
        raise AssertionError('two replays of the augment graph drew the same boxes')
    return {'phase': 'imagenet_aug', 'card': card, 'model': 'resnet50', 'fill_s': fill_s,
            'augment': 'imagenet_train_augment -> float32 (in the graph)',
            'bare': 'float() / 255', 'bare_cast': bare, 'augmented': aug,
            'aug_cost_frac': 1 - aug['img_per_s'] / bare['img_per_s'],
            'replays_draw_anew': True,
            'crop_y_offsets_two_replays': [v.tolist()[:4] for v in drawn]}


def lm_scan(url, device, model, batch, k, warmup, calls, layers, mesh=None, first=None):
    """An LM scan path (the ``lm`` child's protocol, ``bench.py:160-306``):
    the token reader with ``cache_type='memory'``, ``TorchLoader(batch=
    batch * k)``, ``make_lm_scan_train_step(k)`` (SGD lr 0.01, momentum
    0.9); :func:`scan_window` over ``warmup`` + ``calls`` calls, each flash
    kernel ``layers * k`` times a call on the Hopper route, then ``calls``
    timed; the losses must be finite and fall. On a ``mesh`` the reader is
    ``make_pod_reader``'s, the loader the mesh's (the tokens split over the
    model's ``seq_axis``) and the state's parameters split by
    ``transformer_param_spec``; ``first`` (a list) receives a copy of the
    first superbatch. Returns the path's line (without phase and model
    keys), the metrics of every call and the measured calls' profile."""
    import torch
    from petastorm_tpu_torch import TorchLoader, make_pod_reader
    from petastorm_tpu_torch.models import create_train_state, make_lm_scan_train_step
    from petastorm_tpu_torch.models.train import transformer_param_spec
    from petastorm_tpu_torch.parallel.mesh import sequence_sharding

    state = create_train_state(model, learning_rate=0.01, momentum=0.9, mesh=mesh,
                               param_spec_fn=transformer_param_spec)
    train = make_lm_scan_train_step(k, mesh=mesh)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    reader = make_pod_reader(url, mesh=mesh, pod_shard=None if mesh else (0, 1),
                             schema_fields=['tokens'], reader_pool_type='thread',
                             workers_count=2, shuffle_row_groups=True, seed=0, num_epochs=None,
                             cache_type='memory')
    sharding = None
    if mesh is not None and model.seq_axis is not None:
        sharding = {'tokens': sequence_sharding(mesh, seq_axis=model.seq_axis)}
    with reader:
        with TorchLoader(reader, batch * k, device=device, prefetch=2, mesh=mesh,
                         sharding=sharding) as loader:
            def next_inputs():
                tokens = next(loader).tokens
                if first is not None and not first:
                    first.append(tokens.clone())
                return (tokens,)

            metrics, launches, captured, ran, measured, replays = scan_window(
                train, state, next_inputs, warmup, calls, FLASH_KERNELS)
            wall, wait_s, call_ms, timed = time_scan_calls(train, state, next_inputs, calls)
            stats, cache = loader.stats, reader.cache_stats()
    seq = model.max_len
    require_scan_launches(launches, captured, ran, FLASH_WRAPPERS, layers * k, replays)
    losses = [float(v) for m in metrics + timed for v in m['losses']]
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError('lm scan losses did not fall: {}'.format(losses))
    steps = calls * k
    result = {
        'layers': layers, 'seq': seq, 'batch': batch, 'microbatches': k, 'cache_type': 'memory',
        'params': sum(p.numel() for p in model.parameters()),
        'warmup_calls': warmup, 'counted_calls': calls, 'timed_calls': calls, 'losses': losses,
        'tokens_per_s': steps * batch * seq / wall, 'step_ms': wall / steps * 1e3,
        'input_stall_frac': wait_s / wall, 'device_call_ms_median': call_ms,
        'device_step_ms': call_ms / k, 'cache': cache,
        'peak_mem_GB': torch.cuda.max_memory_allocated(device) / 1e9,
        'peak_reserved_GB': torch.cuda.max_memory_reserved(device) / 1e9,
        'rows_delivered': stats['rows'],
        'launches': _scan_launches(launches, captured, ran, warmup + calls, replays),
        'trace': per_step(busy_trace(measured, calls, call_ms), k)}
    return result, metrics + timed, measured


def run_lm_scan(url, device, card, seq=LM_SEQ, batch=LM_BATCH, k=SCAN_K, steps=48,
                layers=LM_LAYERS, moe_experts=0, warmup=2):
    """The ``lm`` child and its variants: ``steps // k`` measured calls of
    ``k`` steps of ``batch`` rows of ``seq - 1`` tokens. ``lm_long`` adds
    attention's share of the traced step, ``lm_moe`` the aux losses."""
    model = lm_model(device, layers, seq - 1, moe_experts)
    result, metrics, measured = lm_scan(url, device, model, batch, k, warmup,
                                        max(1, steps // k), layers)
    line = dict({'phase': 'lm_scan', 'card': card, 'model': 'TransformerLM'}, **result)
    if seq > LM_SEQ:
        line.update(phase='lm_long', attention_share=attention_share(measured))
    if moe_experts:
        aux = [float(v) for m in metrics for v in m['aux_losses']]
        if not all(math.isfinite(v) and v > 0 for v in aux):
            raise AssertionError('lm_moe aux losses: {}'.format(aux))
        line.update(phase='lm_moe', experts=moe_experts, loss='ce + 1e-2 * aux',
                    capacity=model.blocks[0].moe.capacity(seq - 1), aux_losses=aux)
    return line


# --------------------------------------------------------------------------
# the pipeline child: the host pipeline alone (bench.py:774-949)
# --------------------------------------------------------------------------

def _rss_mb():
    """Current resident-set size in MB (``/proc/self/statm``)."""
    with open('/proc/self/statm') as f:
        pages = int(f.read().split()[1])
    return pages * os.sysconf('SC_PAGE_SIZE') / 1e6


def _peak_rss_mb():
    """Lifetime peak resident-set size in MB (``ru_maxrss``, KiB on Linux)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e6


def _store_rows(url):
    from petastorm_tpu_torch.storage import ParquetStore
    return sum(piece.num_rows for piece in ParquetStore(url).row_groups())


def _fence(batch):
    """Wait until the batch's copy landed: the consumer stream waits on the
    copy's event, so its completion is the copy's."""
    import torch
    if batch.image.is_cuda:
        torch.cuda.current_stream(batch.image.device).synchronize()


def _measure_cache_tier(url, device, workers, batch, warm, measure, tier):
    """One row of the cache-tier sweep (``bench.py:581-650``): img/s of
    ``measure`` batches after ``warm`` (an epoch and two batches), and the
    process's RSS. The chunk store gets a fresh directory, filled first by
    one pass of a reader of its own whose writes are flushed (``fill_s``):
    the bench flushes after the warm-up instead, and row-groups that missed
    before their first write landed, still in flight at the flush, would
    decode inside the window. Its counters are reported."""
    from petastorm_tpu_torch import TorchLoader, make_tensor_reader
    from petastorm_tpu_torch.chunk_store import TEMP_DIR_PREFIX

    kwargs = dict(schema_fields=['image', 'label'], reader_pool_type='thread',
                  workers_count=workers, shuffle_row_groups=True, seed=0, cache_type=tier)
    store_dir = fill_s = None
    if tier == 'chunk-store':
        os.makedirs(BUILD_DIR, exist_ok=True)
        store_dir = tempfile.mkdtemp(prefix=TEMP_DIR_PREFIX, dir=BUILD_DIR)
        kwargs['cache_location'] = store_dir
        t0 = time.perf_counter()
        with make_tensor_reader(url, num_epochs=1, **kwargs) as filler:
            for _ in filler:
                pass
            if not filler.chunk_store.flush(timeout_s=120):
                raise RuntimeError('the chunk store did not drain its writes')
        fill_s = time.perf_counter() - t0
    try:
        reader = make_tensor_reader(url, num_epochs=None, **kwargs)
        with reader:
            with TorchLoader(reader, batch, device=device, prefetch=2) as loader:
                for _ in range(warm):
                    b = next(loader)
                _fence(b)
                store = reader.chunk_store
                if store is not None and not store.flush(timeout_s=120):
                    raise RuntimeError('the chunk store did not drain its writes before the '
                                       'measured window')
                timings0 = reader.stage_timings
                t0 = time.perf_counter()
                for _ in range(measure):
                    b = next(loader)
                _fence(b)
                record = {'img_per_sec': batch * measure / (time.perf_counter() - t0),
                          'rss_mb': _rss_mb(), 'rss_peak_mb': _peak_rss_mb(),
                          'decode_s': reader.stage_timings['decode_s'] - timings0['decode_s'],
                          'cache': reader.cache_stats()}
                if store is not None:
                    stats = store.stats()
                    record['chunk_store'] = {k: stats[k] for k in (
                        'hits', 'misses', 'fills', 'writes', 'corrupt_quarantined',
                        'readaheads', 'bytes_mapped')}
                    record['fill_s'] = fill_s
                return record
    finally:
        if store_dir is not None:
            shutil.rmtree(store_dir, ignore_errors=True)


def _mem_governor_summary():
    """The ``mem`` block (``bench.py:538-555``) while the governor is armed:
    budget and its source, the ladder's state and peaks, the pools' bytes
    (sampled now: one pass of the sampler's own check), degrade actions,
    breaches; else None."""
    from petastorm_tpu_torch import membudget
    governor = membudget.get_governor()
    if not governor.armed:
        return None
    governor.check()
    stats = governor.stats()
    return {key: stats[key] for key in ('budget_bytes', 'budget_source', 'state', 'peak_state',
                                        'peak_frac', 'accounted_bytes', 'pools',
                                        'degrade_actions', 'breaches')}


def _lineage_summary(loader, ledger_dir):
    """The ``lineage`` block (``bench.py:818-846``): records and dropped,
    the write-behind lag, the ledger's bytes, and ``replay_self_check``:
    the newest ring record re-read from the store and digest-verified (True,
    or ``'failed: ...'``). Removes the throwaway ledger directory."""
    from petastorm_tpu_torch import lineage

    tracker = loader.lineage_tracker
    out = dict(tracker.stats())
    path = out.pop('ledger_path', None)
    out['ledger_bytes'] = os.path.getsize(path) if path else 0
    ring = tracker.ring()
    check = None
    if ring:
        try:
            lineage.verify_record(ring[-1], tracker.ctx)
            check = True
        except lineage.ReplayError as e:
            check = 'failed: {!r}'.format(e)
    out['replay_self_check'] = check
    shutil.rmtree(ledger_dir, ignore_errors=True)
    return out


def _deterministic_rate(url, device, workers, batch, prefetch, inflight, warm_batches,
                        measure_batches):
    """The same pipeline with ``deterministic=True`` (``bench.py:860-884``):
    img/s of ``measure_batches`` after the warm-up."""
    from petastorm_tpu_torch import TorchLoader, make_tensor_reader

    reader = make_tensor_reader(url, schema_fields=['image', 'label'], reader_pool_type='thread',
                                workers_count=workers, num_epochs=None, shuffle_row_groups=True,
                                seed=0, cache_type='memory', deterministic=True)
    with reader:
        with TorchLoader(reader, batch, device=device, prefetch=prefetch,
                         inflight=inflight) as loader:
            for _ in range(warm_batches):
                b = next(loader)
            _fence(b)
            start = time.perf_counter()
            for _ in range(measure_batches):
                b = next(loader)
            _fence(b)
            return batch * measure_batches / (time.perf_counter() - start)


def _per_device_stream_probe(url, device, workers, batch):
    """The ``per_device_stream`` block (``bench.py:718-770``): a short run
    of ``make_pod_reader`` -> the mesh ``TorchLoader`` on ``{'data': world}``,
    so ``h2d_overlap_frac`` is the overlap of the collate with the tile
    copies of the mesh path. In a process without a group it starts a
    one-rank group from a file (NCCL on the card, gloo on the CPU) and ends
    it after; at world size 1 no number here is a transfer between cards.
    A failure, a failed ``init_process_group`` included, raises."""
    import torch
    import torch.distributed as dist
    from petastorm_tpu_torch import TorchLoader, make_pod_reader
    from petastorm_tpu_torch.parallel import make_mesh

    measure = _env_int('BENCH_PIPELINE_STREAM_BATCHES', 16)
    started = not dist.is_initialized()
    init_dir = tempfile.mkdtemp(prefix='pstt-group-')
    try:
        if started:
            cuda = torch.device(device).type == 'cuda'
            dist.init_process_group(
                'nccl' if cuda else 'gloo', rank=0, world_size=1,
                init_method='file://' + os.path.join(init_dir, 'init'),
                **({'device_id': torch.device(device)} if cuda else {}))
        mesh = make_mesh({'data': dist.get_world_size()}, device=torch.device(device).type)
        reader = make_pod_reader(url, mesh=mesh, schema_fields=['image', 'label'],
                                 reader_pool_type='thread', workers_count=workers,
                                 num_epochs=None, shuffle_row_groups=True, seed=0,
                                 cache_type='memory')
        with reader:
            with TorchLoader(reader, batch, mesh=mesh) as loader:
                for _ in range(4):
                    b = next(loader)
                _fence(b)
                loader.reset_stats()
                t0 = time.perf_counter()
                for _ in range(measure):
                    b = next(loader)
                _fence(b)
                elapsed = time.perf_counter() - t0
                stats = loader.stats
        world = dist.get_world_size()
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(init_dir, ignore_errors=True)
    put_s, put_bytes = stats['device_put_s'], stats['device_put_bytes']
    return {'world_size': world, 'n_devices': stats['n_devices'],
            'img_per_sec': batch * measure / elapsed, 'h2d_overlap_frac': stats['overlap_frac'],
            'shards_put': stats['shards_put'],
            'per_device_h2d_GBps': {dev: (put_bytes[dev] / sec / 1e9 if sec else None)
                                    for dev, sec in put_s.items()},
            'arena_pinned': stats['arena_pinned'], 'measure_batches': measure}


def run_pipeline(url, device, workers):
    """Loader-only capacity: the imagenet child's reader and loader with no
    train step (``bench.py:774-949``). ``make_tensor_reader(cache_type=
    'memory', num_epochs=None, shuffle_row_groups=True, seed=0)``,
    ``TorchLoader(batch, prefetch, inflight, arena_depth, lineage=<a
    throwaway ledger directory>)`` (defaults 128, 2, 2, the loader's;
    ``BENCH_PIPELINE_*``); warm-up through one epoch plus two batches,
    ``reset_stats()``, then ``reps`` (3) windows of 32 batches, each timed
    to the last batch's copy. The rate is the median, the spread max - min;
    the stage profile spans all reps. As in the bench, the lineage ledger is
    armed during the reps, so each batch's fields are CRC32-digested on the
    assemble thread. Then the same pipeline with ``deterministic=True``
    (``determinism``; ``BENCH_PIPELINE_DETERMINISM=0`` skips it), the
    cache-tier sweep (``null``, ``memory``, ``chunk-store``; a tier that
    fails makes the child fail) and the mesh loader's ``per_device_stream``
    block (its failure fails the child too). With ``PSTT_HOST_MEM_BUDGET``
    set the pipeline arms the governor and the ``mem`` block reports it."""
    from petastorm_tpu_torch import TorchLoader, make_tensor_reader
    from petastorm_tpu_torch.lineage import TEMP_DIR_PREFIX

    batch = _env_int('BENCH_PIPELINE_BATCH', BATCH)
    warm_batches = max(1, _env_int('BENCH_PIPELINE_WARMUP', _store_rows(url) // batch + 2))
    measure_batches = _env_int('BENCH_PIPELINE_BATCHES', 32)
    prefetch = _env_int('BENCH_PIPELINE_PREFETCH', 2)
    inflight = _env_int('BENCH_PIPELINE_INFLIGHT', 2)
    arena_depth = os.environ.get('BENCH_PIPELINE_ARENA_DEPTH')
    reps = max(1, _env_int('BENCH_PIPELINE_REPS', 3))
    tiers = os.environ.get('BENCH_PIPELINE_CACHE_TIERS', ','.join(PIPELINE_CACHE_TIERS))

    load_before = os.getloadavg()
    ledger_dir = tempfile.mkdtemp(prefix=TEMP_DIR_PREFIX)
    reader = make_tensor_reader(url, schema_fields=['image', 'label'], reader_pool_type='thread',
                                workers_count=workers, num_epochs=None, shuffle_row_groups=True,
                                seed=0, cache_type='memory')
    with reader:
        with TorchLoader(reader, batch, device=device, prefetch=prefetch, inflight=inflight,
                         arena_depth=int(arena_depth) if arena_depth else None,
                         lineage=ledger_dir) as loader:
            # Warm through one epoch: the memory cache fills, so the steady
            # state isolates the pipeline from first-epoch decode (the cold
            # rate below).
            t0 = time.perf_counter()
            for _ in range(warm_batches):
                b = next(loader)
            _fence(b)
            cold_rate = batch * warm_batches / (time.perf_counter() - t0)
            timings0 = reader.stage_timings
            loader.reset_stats()        # one stats window across all reps
            rates, wall_s = [], 0.0
            for _ in range(reps):
                start = time.perf_counter()
                for _ in range(measure_batches):
                    b = next(loader)
                _fence(b)
                elapsed = time.perf_counter() - start
                wall_s += elapsed
                rates.append(batch * measure_batches / elapsed)
            stats, timings, cache = loader.stats, reader.stage_timings, reader.cache_stats()
            mem = _mem_governor_summary()     # while this pipeline holds its arm
    det_rate = None
    if os.environ.get('BENCH_PIPELINE_DETERMINISM', '1') == '1':
        det_rate = _deterministic_rate(url, device, workers, batch, prefetch, inflight,
                                       warm_batches, measure_batches)
    load_after = os.getloadavg()
    ranked = sorted(rates)
    middle = len(ranked) // 2
    median = ranked[middle] if len(ranked) % 2 else (ranked[middle - 1] + ranked[middle]) / 2
    profile = stage_profile(stats, timings0, timings, wall_s)
    profile.update(rss_mb=_rss_mb(), rss_peak_mb=_peak_rss_mb(), cache=cache,
                   batches=stats['batches'], rows=stats['rows'])
    profile['lineage'] = _lineage_summary(loader, ledger_dir)
    if mem is not None:
        profile['mem'] = mem
    if det_rate is not None:
        profile['determinism'] = {'img_per_sec': det_rate, 'default_img_per_sec': median,
                                  'ratio_vs_default': det_rate / median if median else None}
    sweep = {}
    # A PSTT_CHUNK_STORE in the environment would arm the 'null' row with a
    # warm store; the sweep makes its own.
    from petastorm_tpu_torch.chunk_store import ENV_VAR
    saved = os.environ.pop(ENV_VAR, None)
    try:
        for tier in (t.strip() for t in tiers.split(',') if t.strip()):
            sweep[tier] = _measure_cache_tier(url, device, workers, batch, warm_batches,
                                              _env_int('BENCH_PIPELINE_TIER_BATCHES', 16), tier)
    finally:
        if saved is not None:
            os.environ[ENV_VAR] = saved
    profile['cache_tier_sweep'] = sweep
    profile['per_device_stream'] = _per_device_stream_probe(url, device, workers, batch)
    return {
        'pipeline_img_per_sec': median,
        'pipeline_img_per_sec_reps': rates,
        'pipeline_img_per_sec_spread': ranked[-1] - ranked[0],
        'pipeline_cold_img_per_sec': cold_rate,
        'pipeline_batch': batch, 'pipeline_prefetch': prefetch, 'pipeline_inflight': inflight,
        'pipeline_workers': workers, 'pipeline_warmup_batches': warm_batches,
        'pipeline_measure_batches': measure_batches,
        'pipeline_load': {'loadavg_before': list(load_before), 'loadavg_after': list(load_after),
                          'repetitions': reps,
                          'probe_lock': 'left out: the bench takes it against its TPU pool\'s '
                                        'opportunistic prober, which the card does not have'},
        'pipeline_stage_profile': profile,
        'not_ported': dict(PIPELINE_NOT_PORTED)}


# --------------------------------------------------------------------------
# the flashattn child (bench.py:1555-1650)
# --------------------------------------------------------------------------

def _event_ms(fn, reps):
    """Median device ms of ``fn()`` over ``reps`` back-to-back calls (CUDA
    events between the calls), after two warm-up calls."""
    import torch
    for _ in range(2):
        fn()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda.synchronize()
    events[0].record()
    for event in events[1:]:
        fn()
        event.record()
    events[-1].synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in zip(events, events[1:])]))


def run_flashattn(device):
    """``flash_attention`` against ``dense_attention``: the forward's and the
    input gradients' max error relative to the dense maximum at [2, 512, 4,
    64] f32 causal; then the fwd+bwd time of the kernels at [B, T, 8, 128]
    bf16 causal, B 1 and 4, T from ``BENCH_FLASH_SEQ``."""
    import torch
    from petastorm_tpu_torch.models.attention import dense_attention
    from petastorm_tpu_torch.ops.flash_attention import flash_attention

    g = torch.Generator(device=device).manual_seed(0)
    q, k, v = (torch.randn((2, 512, 4, 64), generator=g, device=device).requires_grad_()
               for _ in range(3))
    out = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        o_f = flash_attention(q, k, v, causal=True)
        o_d = dense_attention(q, k, v, causal=True)
        grads_f = torch.autograd.grad((o_f ** 2).sum(), (q, k, v))
        grads_d = torch.autograd.grad((o_d ** 2).sum(), (q, k, v))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    out['fwd_max_rel_err'] = float((o_f - o_d).abs().max() / o_d.abs().max())
    out['grad_max_rel_err'] = max(float((a - b).abs().max() / b.abs().max())
                                  for a, b in zip(grads_f, grads_d))
    timings = {}
    for t in (int(s) for s in os.environ.get('BENCH_FLASH_SEQ', FLASH_SEQS).split(',')):
        for b, tag in ((1, 'T{}'), (4, 'T{}_b4')):
            shape = (b, t, 8, 128)
            gt = torch.Generator(device=device).manual_seed(t)
            qb, kb, vb = (torch.randn(shape, generator=gt, device=device, dtype=torch.bfloat16)
                          .requires_grad_() for _ in range(3))
            do = torch.randn(shape, generator=gt, device=device, dtype=torch.bfloat16)

            def step():
                flash_attention(qb, kb, vb, causal=True).backward(do)

            ms = _event_ms(step, 8 if b == 1 else 16)
            flops = 2.5 * 4 * b * t * t * 8 * 128 / 2      # causal halves; fwd+bwd ~2.5x fwd
            timings[tag.format(t)] = {'fwd_bwd_ms': ms, 'tflops_per_s': flops / ms / 1e9}
    out['flash_train_step'] = timings
    return out


# --------------------------------------------------------------------------
# the children, and the run of them all
# --------------------------------------------------------------------------

#: The children in the bench's probe order (bench.py:2475-2560): the child
#: each runs and the ``BENCH_*`` defaults its variant sets.
CHILDREN = {
    'imagenet': ('imagenet', {}),
    'pipeline': ('pipeline', {}),
    'imagenet_vit': ('imagenet', {'BENCH_IMAGENET_MODEL': 'vit', 'BENCH_IMAGENET_WARMUP': '4',
                                  'BENCH_IMAGENET_STEPS': '16'}),
    'lm': ('lm', {}),
    'lm_long': ('lm', {'BENCH_LM_SEQ': '8193', 'BENCH_LM_BATCH': '2', 'BENCH_LM_SCAN_K': '4',
                       'BENCH_LM_STEPS': '16'}),
    'lm_moe': ('lm', {'BENCH_LM_MOE': '4', 'BENCH_LM_LAYERS': '4', 'BENCH_LM_STEPS': '16'}),
    'flashattn': ('flashattn', {}),
    'imagenet_aug': ('imagenet', {'BENCH_IMAGENET_AUG': '1', 'BENCH_IMAGENET_WARMUP': '4',
                                  'BENCH_IMAGENET_STEPS': '16'}),
}
#: Seconds each child may take (bench.py's longest child timeout but one).
CHILD_TIMEOUT_S = 900


def _device_keys(device):
    import torch
    if device.type == 'cuda':
        return {'platform': 'gpu', 'device_kind': torch.cuda.get_device_name(device),
                'n_devices': 1}
    return {'platform': 'cpu', 'device_kind': 'cpu', 'n_devices': 1}


def _card(device):
    import torch
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    return '{} ({})'.format(torch.cuda.get_device_name(device),
                            smi.splitlines()[0] if smi else 'nvidia-smi gave nothing')


def child_imagenet(device, workdir):
    """The imagenet child and its ``vit`` and ``aug`` variants: the
    streamed scan path and the HBM tier. ``BENCH_IMAGENET_WARMUP`` and
    ``BENCH_IMAGENET_STEPS`` (steps) become calls of 8 steps: at least 2
    warm-up calls (call 2 captures the graph) and 1 measured."""
    url = ensure_imagenet_store(workdir)
    model = os.environ.get('BENCH_IMAGENET_MODEL', 'resnet50')
    aug = os.environ.get('BENCH_IMAGENET_AUG', '0') == '1'
    warmup = max(2, -(-_env_int('BENCH_IMAGENET_WARMUP', ROWS // BATCH + 3) // SCAN_K))
    calls = max(1, _env_int('BENCH_IMAGENET_STEPS', 40) // SCAN_K)
    card = _card(device)
    config = {'model': model, 'augment': aug, 'batch': BATCH, 'scan_microbatches': SCAN_K,
              'prefetch': SCAN_PREFETCH, 'workers': 4, 'cache_type': 'memory',
              'warmup_calls': warmup, 'measured_calls': calls}
    if model == 'vit':
        line = run_imagenet_vit(url, device, card, warmup, calls)
        streamed, hbm = line['streamed'], line['hbm']
    elif model == 'resnet50':
        if aug:
            line = run_imagenet_aug(url, device, card, resnet50_state(device))
            streamed, hbm = None, line['augmented']
        else:
            streamed, state = run_imagenet_scan(url, device, card, warmup, calls)
            hbm = run_imagenet_hbm(url, device, card, state)
            line = {'streamed': streamed, 'hbm': hbm}
    else:
        raise ValueError('BENCH_IMAGENET_MODEL={!r}: the port runs resnet50 and vit'.format(model))
    head = streamed if streamed is not None else hbm
    out = {
        'imagenet_img_per_sec_per_chip': head['img_per_s'],
        'streamed_img_per_sec_per_chip': streamed['img_per_s'] if streamed else None,
        'hbm_resident_img_per_sec_per_chip': hbm['img_per_s'],
        'step_time_ms': head['step_ms'],
        'device_ms_a_step': head['device_step_ms'],
        'input_stall_frac': streamed['input_stall_frac'] if streamed else None,
        'stage_profile': streamed['stage_profile'] if streamed else None,
        'final_loss': (streamed['losses_mean_last'][-1][1] if streamed
                       else hbm['loss_first_last'][-1]),
        'bench_config': config, 'card': card, 'detail': line}
    if aug:
        out.update(aug_cost_frac=line['aug_cost_frac'],
                   bare_img_per_sec_per_chip=line['bare_cast']['img_per_s'])
    return out


def child_lm(device, workdir):
    """The lm child and its ``lm_long`` and ``lm_moe`` variants."""
    seq = _env_int('BENCH_LM_SEQ', LM_SEQ)
    batch, k = _env_int('BENCH_LM_BATCH', LM_BATCH), max(1, _env_int('BENCH_LM_SCAN_K', SCAN_K))
    steps, moe = _env_int('BENCH_LM_STEPS', 48), _env_int('BENCH_LM_MOE', 0)
    layers = _env_int('BENCH_LM_LAYERS', LM_LAYERS)
    line = run_lm_scan(ensure_lm_store(workdir, seq), device, _card(device), seq, batch, k, steps,
                       layers, moe)
    return {'lm_tokens_per_sec_per_chip': line['tokens_per_s'],
            'lm_step_time_ms': line['step_ms'], 'lm_device_ms_a_step': line['device_step_ms'],
            'lm_final_loss': line['losses'][-1], 'lm_input_stall_frac': line['input_stall_frac'],
            'lm_config': {'vocab': LM_VOCAB, 'd_model': LM_D, 'layers': layers, 'heads': LM_HEADS,
                          'seq': seq - 1, 'batch_per_chip': batch, 'scan_microbatches': k,
                          'steps': line['counted_calls'] * k, 'attention': 'flash',
                          'moe_experts': moe},
            'card': line['card'], 'detail': line}


def child_pipeline(device, workdir):
    workers = max(4, min(10, os.cpu_count() or 4))
    return run_pipeline(ensure_imagenet_store(workdir), device, workers)


def child_flashattn(device, workdir):
    return dict(run_flashattn(device), card=_card(device))


def run_child(name, device, workdir):
    """One child in this process: its JSON object. The stores it reads are
    written into ``workdir`` unless they are there already."""
    from petastorm_tpu_torch.device import resolve_device
    if name not in CHILDREN:
        raise ValueError('unknown child {!r}; the children are {}'.format(name, list(CHILDREN)))
    device = resolve_device(device)
    kind, env = CHILDREN[name]
    for key, value in env.items():
        os.environ.setdefault(key, value)
    if kind == 'pipeline':
        out = child_pipeline(device, workdir)
    elif device.type != 'cuda':
        raise ValueError('child {!r} runs on the card only; --device cpu runs the pipeline '
                         'child'.format(name))
    else:
        out = {'imagenet': child_imagenet, 'lm': child_lm,
               'flashattn': child_flashattn}[kind](device, workdir)
    out.update(_device_keys(device), child=name)
    return out


def run_all(device, workdir):
    """Every child in a subprocess, in order: ``(results, failures)``."""
    ensure_imagenet_store(workdir)
    for seq in (LM_SEQ, 8193):
        ensure_lm_store(workdir, seq)
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(filter(None, [ROOT, env.get('PYTHONPATH')]))
    results, failures = {}, {}
    for name in CHILDREN:
        cmd = [sys.executable, '-m', 'petastorm_tpu_torch.bench', '--child', name,
               '--device', device, '--workdir', workdir]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, timeout=CHILD_TIMEOUT_S, capture_output=True, text=True,
                                  env=env, cwd=ROOT)
        except subprocess.TimeoutExpired:
            failures[name] = 'timed out after {} s'.format(CHILD_TIMEOUT_S)
            continue
        lines = [line for line in proc.stdout.splitlines() if line.startswith('{')]
        if proc.returncode != 0 or not lines:
            tail = ' | '.join(proc.stderr.strip().splitlines()[-5:])
            failures[name] = 'rc={}: {}'.format(proc.returncode, tail)
            continue
        results[name] = dict(json.loads(lines[-1]), seconds=time.perf_counter() - t0)
    return results, failures


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--child', default=None, help='run one child: ' + ', '.join(CHILDREN))
    parser.add_argument('--device', default='cuda', help="'cuda' (default) or, for the tests, "
                                                         "'cpu' (the pipeline child only)")
    parser.add_argument('--workdir', default=None,
                        help='where the stores are written, or found if they are there '
                             '(default: a temporary directory)')
    args = parser.parse_args(argv)
    os.environ.setdefault('TRITON_CACHE_DIR', os.path.join(BUILD_DIR, 'triton'))
    from petastorm_tpu_torch.device import resolve_device
    resolve_device(args.device)          # raises without a GPU, before any store is written
    if args.child is not None and args.child not in CHILDREN:
        parser.error('unknown child {!r}; the children are {}'.format(args.child, list(CHILDREN)))
    workdir = args.workdir or tempfile.mkdtemp(prefix='pstt-bench-')
    try:
        if args.child is not None:
            emit(run_child(args.child, args.device, workdir))
            return 0
        results, failures = run_all(args.device, workdir)
        emit(dict(results, failed=sorted(failures), failures=failures))
        if failures:
            print('bench: children failed: {}'.format(', '.join(sorted(failures))),
                  file=sys.stderr)
            return 1
        return 0
    finally:
        if args.workdir is None:
            shutil.rmtree(workdir, ignore_errors=True)


if __name__ == '__main__':
    sys.exit(main())
