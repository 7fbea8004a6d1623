"""The port's bench (counterpart of the repo's ``bench.py`` children).

    python -m petastorm_tpu_torch.bench                      # every child, in order
    python -m petastorm_tpu_torch.bench --child pipeline     # one child, one JSON line

Run with no ``--child``, it writes the bench's stores (the hello_world store
of ``bench.py:64-87``, the ImageNet-shaped JPEG store of ``bench.py:99-127``,
the token stores of ``bench.py:130-157``) into ``--workdir`` (default: a
temporary directory, removed at the end), measures the top-level reader
metric ``hello_world_samples_per_sec`` in this process (the per-row
``make_reader`` over the hello_world store, the ``dummy`` and ``thread``
pools swept, the median of 3 runs at the best, beside the reference's
709.84; ``bench.py:2657-2700``), and runs the children in the bench's order
(``bench.py:2475-2560, 2781``), each in a subprocess under a timeout as
``bench.py:_run_child`` does: staging (hello_world batches through the
loader with ``PadTo``, on the sweep's pool), imagenet, pipeline,
imagenet_vit, lm, lm_long, lm_moe, flashattn, imagenet_aug, lookup (the
lookup tier's point reads and its fleet, :func:`run_lookup`), then, where
the bench runs its ``fleet_wire`` child, imagenet_remote (the imagenet
store decoded in a data-service server process, :func:`run_imagenet_remote`)
and fleet_wire (:func:`run_fleet_wire`). It prints one
JSON object with the metric and a key per child and exits 1 when any child
failed, naming which.

The variants are chosen through the ``BENCH_*`` environment variables that
``bench.py`` sets (``BENCH_IMAGENET_MODEL``, ``BENCH_IMAGENET_AUG``,
``BENCH_LM_SEQ``, ``BENCH_LM_BATCH``, ``BENCH_LM_SCAN_K``,
``BENCH_LM_STEPS``, ``BENCH_LM_MOE``, ``BENCH_LM_LAYERS``): a named variant
(``--child lm_long``) sets its defaults, and the environment overrides them.
``BENCH_HELLO_POOL`` and ``BENCH_HELLO_WORKERS`` give the staging child its
reader pool (the whole bench passes the hello_world sweep's choice).

Children run on the card. The scan children follow the bench's protocol
through the port: the memory cache, ``superbatches(8)``, the K-step scan
trainer captured as one CUDA graph and replayed, the HBM tier. Their launch
windows (:func:`scan_window`) count each hand kernel by name among the
captured graph's kernel nodes, times the replays; ``chip_smoke.py`` drives
the same functions and holds the counts. ``--device cpu`` exists for the tests and runs the
``pipeline``, ``staging``, ``lookup`` and ``fleet_wire`` children only. No MFU is reported (the bench's TPU peak table has no
counterpart here): the children report device ms a step instead.
"""

import argparse
import collections
import contextlib
import json
import math
import os
import resource
import shutil
import signal
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
# imagenet_filtered: the train split (fractions, subset) on ``label``, and the
# batches of its stream held in order against a single-threaded reader's.
FILTERED_SPLIT = ((0.9, 0.1), 0)
FILTERED_CHECK_BATCHES = 16
# lm_plain: the plain token stores' row-groups, B's rows and seed, the mixture.
LM_PLAIN_ROWS_PER_GROUP = 128
LM_PLAIN_B_ROWS, LM_PLAIN_B_SEED = 1024, 12
LM_PLAIN_MIX = (0.7, 0.3)
# lm_plain's reader_throughput(A): an epoch of warm-up, 8 epochs measured, 5 runs a method.
LM_PLAIN_THROUGHPUT_EPOCHS, LM_PLAIN_THROUGHPUT_RUNS = 8, 5
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

#: The decode sweep's acceptance ratio of batched over scalar img/s
#: (``bench.py:709-714``).
DECODE_GATE_MIN_RATIO = 1.5
# The hello_world store and the reader metric (bench.py:35-36, 39-40, 64-87).
HELLO_ROWS, HELLO_ROWS_PER_GROUP = 400, 32
HELLO_WARMUP_SAMPLES, HELLO_MEASURE_SAMPLES = 200, 2000
#: The reference petastorm's hello_world rate (its docs/benchmarks_tutorial.rst).
REFERENCE_SAMPLES_PER_SEC = 709.84
# The staging child (bench.py:339-370).
STAGING_BATCH, STAGING_BATCHES = 32, 40
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


def read_store_column(url, column, storage_options=None):
    """One column of a store, its files in the store's order, read with
    pyarrow through the store's filesystem (a reckoning apart from the
    readers)."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    from petastorm_tpu_torch.storage import ParquetStore

    store = ParquetStore(url, storage_options)
    tables = []
    for path in store.files:
        with store.fs.open(path, 'rb') as f:
            tables.append(pq.read_table(f, columns=[column]))
    return pa.concat_tables(tables).column(column)


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


def write_hello_world_store(path, rows=HELLO_ROWS):
    """The bench's hello_world store (``bench.py:64-87``) with the port's
    writer: an int32 id, a 128x256x3 PNG image and a ``(None, 128, 30,
    None)`` uint8 ndarray (each row ``(4, 128, 30, 3)``), 32-row groups,
    seed 0."""
    from petastorm_tpu_torch import (CompressedImageCodec, NdarrayCodec, ScalarCodec, Unischema,
                                     UnischemaField, write_dataset)
    schema = Unischema('HelloWorldSchema', [
        UnischemaField('id', np.int32, (), ScalarCodec(np.int32), False),
        UnischemaField('image1', np.uint8, (128, 256, 3), CompressedImageCodec('png'), False),
        UnischemaField('array_4d', np.uint8, (None, 128, 30, None), NdarrayCodec(), False),
    ])
    rng = np.random.default_rng(0)
    url = 'file://' + path
    write_dataset(url, schema, ({'id': i,
                                 'image1': rng.integers(0, 255, (128, 256, 3), dtype=np.uint8),
                                 'array_4d': rng.integers(0, 255, (4, 128, 30, 3), dtype=np.uint8)}
                                for i in range(rows)), rows_per_row_group=HELLO_ROWS_PER_GROUP)
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


def ensure_hello_world_store(workdir):
    path = os.path.join(workdir, 'hello_world')
    if not os.path.exists(os.path.join(path, '_common_metadata')):
        shutil.rmtree(path, ignore_errors=True)
        write_hello_world_store(path)
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
    (:func:`graph_kernels`) times the replays. No kernel asked, no walk."""
    if not kernels:
        return {}
    nodes = graph_kernels(train.graph) if train.graph is not None else {}
    return {name: replays * sum(n for kernel, n in nodes.items() if name in kernel)
            for name in kernels}


def scan_window(train, state, next_inputs, warmup, calls, kernels, profile=True, until=None):
    """One scan path's counted window: the launch counts zeroed, ``warmup``
    calls (call 1 eager, call 2 captures the graph and replays it, later
    calls replay; with ``until``, more of them until ``until()`` returns
    True), then ``calls`` measured calls under ``torch.profiler``
    (the path's trace; ``profile=False`` runs them unprofiled and returns
    no profile), the counts read. A replay calls no wrapper, so the
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
    while until is not None and not until():
        run(1)
    if profile:
        measured = device_profile(lambda: run(calls))
    else:
        run(calls)
        measured = None
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
    and cache seconds, the copies' issue time, the staging-step decode's
    seconds, the consumer's wait, the staging counters and the H2D rate."""
    profile = {k: timings.get(k, 0.0) - timings0.get(k, 0.0)
               for k in ('read_s', 'decode_s', 'cache_s')}
    profile.update(stage_dispatch_s=stats['stage_dispatch_s'], consumer_wait_s=stats['wait_s'],
                   stage_decode_s=stats['stage_decode_s'],
                   stage_decode_threads=stats['stage_decode_threads'],
                   wall_s=wall_s, reader_wait_s=stats.get('reader_wait_s', 0.0),
                   h2d_GBps=stats['h2d_bytes'] / stats['h2d_s'] / 1e9 if stats['h2d_s'] else None)
    profile.update(staging_counters(stats))
    return profile


def stream_classifier_scan(url, device, train, state, warmup, calls, kernels,
                           cache_type='memory', cache_location=None, mesh=None, workers=4,
                           reader_kwargs=None, loader_kwargs=None, observe=None, hooks=None,
                           profile=True):
    """A classifier scan path streamed from a cache tier (the bench's
    ``_child_imagenet`` loop): the reader with ``cache_type`` (default
    ``'memory'``; endless, seed 0), ``TorchLoader(batch=128, prefetch=8)``,
    ``superbatches(8)``; :func:`scan_window` over ``warmup`` + ``calls``
    calls, then ``calls`` timed (the stage profile covers those). A chunk
    store's queued writes are flushed before the timed calls. On a ``mesh``
    the reader is ``make_pod_reader``'s and the loader the mesh's (128 is
    the global batch). ``workers`` reader threads; ``reader_kwargs`` and
    ``loader_kwargs`` go to the reader and the loader (the decode cell's
    ``raw_image_fields`` and ``on_device_augment``; the process cell's
    ``reader_pool_type``, which replaces ``'thread'``; ``autotune``, off
    unless one of them arms it: its record then rides the line's
    ``autotune``). ``observe(superbatch)``
    sees each superbatch before its call. ``hooks(stage, loader, reader)`` is
    called with ``'timed'`` just before the timed calls and ``'close'`` just
    after them, while the loader still runs. ``profile=False`` leaves the
    counted calls unprofiled (``trace`` is then None). Returns the path's
    line (without phase and model keys) and its launch window."""
    import torch
    from petastorm_tpu_torch import TorchLoader, make_pod_reader

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    reader_args = dict(schema_fields=['image', 'label'], reader_pool_type='thread',
                       workers_count=workers, shuffle_row_groups=True, seed=0, num_epochs=None,
                       cache_type=cache_type, cache_location=cache_location, autotune=False)
    reader_args.update(reader_kwargs or {})
    loader_args = dict(prefetch=SCAN_PREFETCH, autotune=False)
    loader_args.update(loader_kwargs or {})
    reader = make_pod_reader(url, mesh=mesh, pod_shard=None if mesh else (0, 1), **reader_args)
    with reader:
        with TorchLoader(reader, BATCH, device=device, mesh=mesh, **loader_args) as loader:
            groups = loader.superbatches(SCAN_K)

            def next_inputs():
                sb = next(groups)
                if observe is not None:
                    observe(sb)
                return sb.image, sb.label

            metrics, launches, captured, ran, measured, replays = scan_window(
                train, state, next_inputs, warmup, calls, kernels, profile=profile)
            if reader.chunk_store is not None and not reader.chunk_store.flush(timeout_s=120):
                raise RuntimeError('the chunk store did not drain its writes before the timed '
                                   'calls')
            stats0, cache0, timings0 = loader.stats, reader.cache_stats(), reader.stage_timings
            loader.reset_stats()
            if hooks is not None:
                hooks('timed', loader, reader)
            wall, wait_s, call_ms, timed = time_scan_calls(train, state, next_inputs, calls)
            if hooks is not None:
                hooks('close', loader, reader)
            stats, cache, timings = loader.stats, reader.cache_stats(), reader.stage_timings
            holes = reader.holes
            diagnostics = reader.diagnostics()
            autotune = autotune_summary(stats)
    losses = [[float(m['loss']), float(m['last_loss'])] for m in metrics + timed]
    if not all(math.isfinite(v) for pair in losses for v in pair):
        raise AssertionError('non-finite loss: {}'.format(losses))
    rows = (warmup + 2 * calls) * SCAN_K * BATCH
    if stats0['rows'] + stats['rows'] != rows:
        raise AssertionError('loader delivered {} rows, expected {}'.format(
            stats0['rows'] + stats['rows'], rows))
    steps = calls * SCAN_K
    result = {
        'batch': BATCH, 'microbatches': SCAN_K, 'prefetch': SCAN_PREFETCH, 'workers': workers,
        'cache_type': cache_type, 'warmup_calls': warmup, 'counted_calls': calls,
        'timed_calls': calls, 'losses_mean_last': losses, 'img_per_s': steps * BATCH / wall,
        'step_ms': wall / steps * 1e3, 'input_stall_frac': wait_s / wall,
        'h2d_GBps': stats['h2d_bytes'] / stats['h2d_s'] / 1e9 if stats['h2d_s'] else None,
        'device_call_ms_median': call_ms, 'device_step_ms': call_ms / SCAN_K,
        'cache_timed': {key: cache[key] - cache0[key] for key in ('hits', 'misses')},
        'cache': cache, 'peak_mem_GB': torch.cuda.max_memory_allocated(device) / 1e9,
        'peak_reserved_GB': torch.cuda.max_memory_reserved(device) / 1e9,
        'rows_delivered': stats0['rows'] + stats['rows'],
        'reader_chunks': timings['chunks'], 'reader_holes': holes,
        'quarantined_rowgroups': diagnostics['quarantined_rowgroups'],
        'stage_profile': stage_profile(stats, timings0, timings, wall),
        'decoder': stats['decoder'],
        'launches': _scan_launches(launches, captured, ran, warmup + calls, replays),
        'trace': (per_step(busy_trace(measured, calls, call_ms), SCAN_K)
                  if measured is not None else None)}
    if autotune is not None:
        result['autotune'] = autotune
    return result, (launches, captured, ran, replays)


def autotune_summary(stats):
    """The tuner's record for a bench line (``bench.py:454-467``): the
    knobs, the last class, the tick counts and the tails of the decision log
    and the trajectory; None without a tuner."""
    at = stats.get('autotune')
    if not at:
        return None
    return {'knobs': at.get('knobs'), 'last_class': at.get('last_class'),
            'ticks': at.get('ticks'), 'paused_ticks': at.get('paused_ticks'),
            'reverts': at.get('reverts'), 'mem_shrinks': at.get('mem_shrinks'),
            'decisions': at.get('decisions', [])[-40:],
            'trajectory': at.get('trajectory', [])[-40:]}


def fill_device_cache(url, device):
    """``_measure_device_cache``'s fill (``bench.py:2120-2130``): a
    one-epoch reader into ``DeviceDatasetCache(shuffle=True, seed=0)``.
    Returns (the cache, seconds)."""
    import torch
    from petastorm_tpu_torch import DeviceDatasetCache, TorchLoader, make_tensor_reader

    reader = make_tensor_reader(url, schema_fields=['image', 'label'], reader_pool_type='thread',
                                workers_count=4, num_epochs=1, seed=0, cache_type='memory',
                                autotune=False)
    t0 = time.perf_counter()
    with reader:
        with TorchLoader(reader, BATCH, device=device, autotune=False) as loader:
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


def run_imagenet_scan(url, device, card, warmup=3, calls=5, autotune=False):
    """The imagenet child streamed: ResNet-50 through
    ``make_scan_train_step(8, preprocess=K1 normalize -> bf16)``; K1 must
    run 8 times a call. ``autotune`` arms the loader's tuner, which adopts
    the reader's knobs (the bench's ``BENCH_IMAGENET_AUTOTUNE``). Returns
    (its line, the trained state)."""
    from petastorm_tpu_torch.models import make_scan_train_step

    state = resnet50_state(device)
    train = make_scan_train_step(SCAN_K, preprocess=normalize_bf16)
    result, window = stream_classifier_scan(url, device, train, state, warmup, calls,
                                            ('normalize_kernel',),
                                            loader_kwargs={'autotune': autotune})
    require_scan_launches(*window[:3], ('normalize_images',), SCAN_K, window[3])
    return dict({'phase': 'imagenet_scan', 'card': card, 'model': 'resnet50', 'stem': 'conv7',
                 'classes': 1000}, **result), state


def run_imagenet_decode(url, device, card, state, warmup=3, calls=5, workers=8,
                        staging_calls=None):
    """The decode cell: imagenet_scan's model and protocol over a ``null``
    cache, so every epoch decodes, ``workers`` reader threads, on ``state``.
    Variant ``worker_decode``: the workers' batched native decode.
    Variant ``staging_decode`` (``staging_calls`` counted and timed calls,
    by default ``calls``): ``raw_image_fields=['image']`` and
    ``on_device_augment=True``, so the loader's staging thread decodes each
    batch next to its copy, the graph still applying K1. K1 must run 8 times
    a replay in each. Returns the phase's line with a line a variant."""
    import torch
    from petastorm_tpu_torch.models import make_scan_train_step

    out = {'phase': 'imagenet_decode', 'card': card, 'model': 'resnet50', 'stem': 'conv7',
           'classes': 1000, 'cache_type': 'null', 'workers': workers}
    for variant, reader_kwargs, loader_kwargs, n in (
            ('worker_decode', {}, {}, calls),
            ('staging_decode', {'raw_image_fields': ['image']}, {'on_device_augment': True},
             calls if staging_calls is None else staging_calls)):
        train = make_scan_train_step(SCAN_K, preprocess=normalize_bf16)
        result, window = stream_classifier_scan(
            url, device, train, state, warmup, n, ('normalize_kernel',), cache_type='null',
            workers=workers, reader_kwargs=reader_kwargs, loader_kwargs=loader_kwargs)
        require_scan_launches(*window[:3], ('normalize_images',), SCAN_K, window[3])
        result['k1_graph'] = {'ran': window[2]['normalize_kernel'],
                              'expected': SCAN_K * window[3], 'replays': window[3]}
        out[variant] = result
        del train
        torch.cuda.empty_cache()
    return out


class LabelRemap(object):
    """The filtered cell's ``TransformSpec`` function: each kept label to a
    dense class id through a 1000-entry int64 table (an unkept class maps to
    -1), on the chunk's blocks; it edits no shape."""

    def __init__(self, table):
        self.table = np.asarray(table, dtype=np.int64)

    def __call__(self, cols):
        cols['label'] = self.table[cols['label']]
        return cols


def filtered_reader_kwargs(split, classes=1000):
    """The filtered cell's reader arguments: the ``in_pseudorandom_split``
    ``split`` (fractions, subset) on ``label``, the dense relabelling of
    the classes it keeps, the in-chunk shuffle, deterministic order."""
    from petastorm_tpu_torch.predicates import in_pseudorandom_split
    from petastorm_tpu_torch.transform import TransformSpec

    predicate = in_pseudorandom_split(split[0], split[1], 'label')
    kept = [c for c in range(classes) if predicate.do_include({'label': np.int64(c)})]
    table = np.full(classes, -1, dtype=np.int64)
    table[kept] = np.arange(len(kept))
    return {'predicate': predicate, 'transform_spec': TransformSpec(LabelRemap(table)),
            'shuffle_rows_in_chunk': True, 'deterministic': True}, table


def reckon_filtered_labels(url, split, table):
    """The kept, relabelled labels of one epoch, reckoned apart from the
    port: pyarrow reads the ``label`` column, the split is md5 of each
    value's text in buckets of 10,000 (the JAX package's rule), ``table``
    relabels. Returns the sorted labels."""
    import hashlib

    labels = read_store_column(url, 'label').to_numpy()
    bounds = np.cumsum([0.0] + list(split[0]))
    low, high = int(bounds[split[1]] * 10000), int(bounds[split[1] + 1] * 10000)
    buckets = np.array([int(hashlib.md5(str(np.int64(v)).encode()).hexdigest(), 16) % 10000
                        for v in labels])
    return np.sort(table[labels[(buckets >= low) & (buckets < high)]])


def run_imagenet_filtered(url, device, card, state, warmup=3, calls=5, workers=8):
    """The filtered cell: imagenet_scan's model and protocol on ``state``,
    the reader with ``FILTERED_SPLIT`` (``in_pseudorandom_split`` on ``label``),
    a dense relabelling ``TransformSpec``, ``shuffle_rows_in_chunk`` and
    deterministic order, no cache (a predicate read decodes every epoch),
    ``workers`` reader threads. Fails unless K1 ran 8 times a replay, one
    epoch's label multiset (a one-epoch reader of the same arguments through
    a loader on the card) equals :func:`reckon_filtered_labels`, the first
    ``FILTERED_CHECK_BATCHES`` batches' labels of the training stream, copied back
    from the card, equal in order a ``'dummy'`` reader's of the same
    arguments, and every loss is finite. Returns the phase's line."""
    import torch
    from petastorm_tpu_torch import TorchLoader, make_tensor_reader
    from petastorm_tpu_torch.models import make_scan_train_step

    split, check_batches = FILTERED_SPLIT, FILTERED_CHECK_BATCHES
    reader_kwargs, table = filtered_reader_kwargs(split)
    seen = []

    def observe(sb):
        if len(seen) * SCAN_K < check_batches:
            seen.append(sb.label.cpu().numpy())

    train = make_scan_train_step(SCAN_K, preprocess=normalize_bf16)
    result, window = stream_classifier_scan(
        url, device, train, state, warmup, calls, ('normalize_kernel',), cache_type=None,
        workers=workers, reader_kwargs=reader_kwargs, observe=observe)
    require_scan_launches(*window[:3], ('normalize_images',), SCAN_K, window[3])
    del train
    torch.cuda.empty_cache()
    streamed = np.concatenate(seen)[:check_batches * BATCH]
    # One epoch through a loader on the card, against the reckoning.
    epoch, holes = [], 0
    with make_tensor_reader(url, schema_fields=['image', 'label'], reader_pool_type='thread',
                            workers_count=workers, seed=0, num_epochs=1,
                            autotune=False, **reader_kwargs) as reader:
        with TorchLoader(reader, BATCH, device=device, last_batch='partial',
                         autotune=False) as loader:
            for batch in loader:
                epoch.append(batch.label.cpu().numpy())
        chunks, holes = reader.stage_timings['chunks'], reader.holes
    epoch = np.concatenate(epoch)
    reckoned = reckon_filtered_labels(url, split, table)
    if not np.array_equal(np.sort(epoch), reckoned):
        raise AssertionError('the epoch\'s label multiset ({} rows) differs from the reckoning '
                             '({} rows)'.format(len(epoch), len(reckoned)))
    # The threaded, resequenced, permuted stream is the single-threaded one.
    single = []
    with make_tensor_reader(url, schema_fields=['image', 'label'], reader_pool_type='dummy',
                            seed=0, num_epochs=None, autotune=False, **reader_kwargs) as reader:
        while sum(len(c) for c in single) < check_batches * BATCH:
            single.append(np.asarray(next(reader).label))
    single = np.concatenate(single)[:check_batches * BATCH]
    if len(streamed) != check_batches * BATCH or not np.array_equal(streamed, single):
        raise AssertionError('the first {} batches\' labels differ from the dummy-pool '
                             'reader\'s'.format(check_batches))
    result['k1_graph'] = {'ran': window[2]['normalize_kernel'], 'expected': SCAN_K * window[3],
                          'replays': window[3]}
    result['checks'] = {'k1_per_replay': SCAN_K, 'epoch_labels_equal_reckoning': True,
                        'first_batches_equal_dummy_pool': check_batches, 'losses_finite': True}
    result['epoch'] = {'rows_kept': int(len(epoch)), 'rows': ROWS, 'chunks': chunks,
                       'holes': holes, 'classes_kept': int((table >= 0).sum())}
    result['split'] = {'fractions': list(split[0]), 'subset': split[1], 'field': 'label'}
    return dict({'phase': 'imagenet_filtered', 'card': card, 'model': 'resnet50',
                 'stem': 'conv7', 'classes': 1000}, **result)


#: The faults cell's store, in fsspec's in-process filesystem: no OS path.
FAULTS_URL = 'memory://pstt-imagenet'
#: Its budget of quarantined row-group items, and the delay of every read.
FAULTS_BUDGET, FAULTS_READ_DELAY_S = 2, 0.02
FAULTS_CHECK_BATCHES = 16


def copy_store(src_url, dst_url):
    """Copy every file of the store at ``src_url`` (data and metadata) to
    ``dst_url`` through both filesystems; returns the bytes copied."""
    from petastorm_tpu_torch.storage import ParquetStore

    src, dst = ParquetStore(src_url), ParquetStore(dst_url)
    nbytes = 0
    for path in src.fs.find(src.path):
        rel = path[len(src.path.rstrip('/')) + 1:]
        with src.fs.open(path, 'rb') as f:
            data = f.read()
        dst.fs.pipe_file(dst.path.rstrip('/') + '/' + rel, data)
        nbytes += len(data)
    return nbytes


def pick_fault_seed(site, keys, p, avoid=()):
    """The least seed under which ``site`` with probability ``p`` selects
    exactly one of ``keys``, not one of ``avoid``: ``(seed, key)``."""
    from petastorm_tpu_torch.faults import FaultInjector

    for seed in range(10000):
        injector = FaultInjector.from_string('{}:p={}:seed={}'.format(site, p, seed))
        chosen = [k for k in keys if injector.selected(site, k)]
        if len(chosen) == 1 and chosen[0] not in avoid:
            return seed, chosen[0]
    raise ValueError('no seed selects exactly one of {} keys'.format(len(keys)))


def faults_spec(url):
    """The faults cell's ``PSTT_FAULTS`` over the store at ``url``: one
    row-group poisoned at decode (``decode-corrupt``), another failing its
    read (``fs-read-error``), each chosen by a seed that selects exactly one
    row-group and ``match=`` the store's file, and ``fs-read-delay`` on
    every read. Returns (spec, the two selected pieces)."""
    from petastorm_tpu_torch.faults import rowgroup_fault_key
    from petastorm_tpu_torch.storage import ParquetStore

    pieces = ParquetStore(url).row_groups()
    keys = [rowgroup_fault_key(p.path, p.row_group) for p in pieces]
    p = 1.0 / len(pieces)
    seed_a, key_a = pick_fault_seed('decode-corrupt', keys, p)
    seed_b, key_b = pick_fault_seed('fs-read-error', keys, p, avoid=(key_a,))
    spec = ';'.join([
        'decode-corrupt:p={}:seed={}:match={}'.format(p, seed_a, key_a.rsplit(':', 1)[0]),
        'fs-read-error:p={}:seed={}:match={}'.format(p, seed_b, key_b.rsplit(':', 1)[0]),
        'fs-read-delay:delay={}'.format(FAULTS_READ_DELAY_S)])
    chosen = [pieces[keys.index(key_a)], pieces[keys.index(key_b)]]
    return spec, chosen


def run_imagenet_faults(url, device, card, state, warmup=3, calls=5, workers=8, min_epochs=1):
    """The faults cell: imagenet_scan's model and protocol on ``state`` from
    a copy of the store at ``url`` in ``memory://`` (every read an fsspec
    file object through pyarrow; the native Parquet stage must not be
    chosen), a ``null`` cache (every epoch reads and decodes again),
    deterministic order, ``error_budget=FAULTS_BUDGET``, under
    :func:`faults_spec` set in ``PSTT_FAULTS`` for the cell only and a fresh
    metrics registry. Fails unless: K1 ran 8 times a replay; the training
    reader quarantined exactly the two row-groups ``FaultInjector.selected``
    picks, each seen at least once an epoch, over more than ``min_epochs``
    epochs, and ``pst_rowgroups_quarantined_total`` is 2; one epoch through
    a loader on the card gives pyarrow's labels less those two row-groups,
    as a multiset; the first ``FAULTS_CHECK_BATCHES`` batches' labels equal
    in order a ``'dummy'`` reader's; the registry's text and one scrape of
    the HTTP exporter show the quarantine, decode and loader counters; every
    loss is finite; a budget of 1 raises ``RowGroupQuarantinedError``
    within one epoch; and the fault spec is gone afterwards. Returns the
    phase's line."""
    import urllib.request

    import pyarrow.parquet as pq
    import torch
    from petastorm_tpu_torch import TorchLoader, faults, make_tensor_reader, metrics
    from petastorm_tpu_torch.errors import RowGroupQuarantinedError
    from petastorm_tpu_torch.models import make_scan_train_step
    from petastorm_tpu_torch.storage import ParquetStore

    mem = ParquetStore(FAULTS_URL)
    if mem.fs.exists(mem.path):
        mem.fs.rm(mem.path, recursive=True)
    t0 = time.perf_counter()
    store_bytes = copy_store(url, FAULTS_URL)
    copy_s = time.perf_counter() - t0
    spec, chosen = faults_spec(FAULTS_URL)
    kwargs = {'cache_type': 'null', 'deterministic': True, 'error_budget': FAULTS_BUDGET}
    previous_spec = os.environ.get(faults.ENV_VAR)
    previous_registry = metrics.set_registry(metrics.MetricsRegistry())
    os.environ[faults.ENV_VAR] = spec
    try:
        registry = metrics.get_registry()
        seen = []

        def observe(sb):
            if len(seen) * SCAN_K < FAULTS_CHECK_BATCHES:
                seen.append(sb.label.cpu().numpy())

        train = make_scan_train_step(SCAN_K, preprocess=normalize_bf16)
        result, window = stream_classifier_scan(
            FAULTS_URL, device, train, state, warmup, calls, ('normalize_kernel',),
            cache_type='null', workers=workers,
            reader_kwargs={'deterministic': True, 'error_budget': FAULTS_BUDGET},
            observe=observe)
        require_scan_launches(*window[:3], ('normalize_images',), SCAN_K, window[3])
        del train
        torch.cuda.empty_cache()
        if result['decoder']['parquet'] != 'pyarrow':
            raise AssertionError('the native Parquet stage was chosen for a memory:// store')
        quarantined = result['quarantined_rowgroups']
        expected = sorted((p.path, p.row_group) for p in chosen)
        got = sorted((q.get('path'), q.get('row_group')) for q in quarantined)
        if got != expected:
            raise AssertionError('quarantined {} ; the injector selects {}'.format(got, expected))
        rows_epoch = ROWS - sum(p.num_rows for p in chosen)
        epochs_read = result['rows_delivered'] // rows_epoch
        if epochs_read <= min_epochs or \
                min(q['occurrences'] for q in quarantined) < epochs_read:
            raise AssertionError('{} epochs read; occurrences {}'.format(
                epochs_read, [q['occurrences'] for q in quarantined]))
        counters = _counter_values(registry)
        if counters.get('pst_rowgroups_quarantined_total') != 2:
            raise AssertionError('pst_rowgroups_quarantined_total is {}, expected 2'.format(
                counters.get('pst_rowgroups_quarantined_total')))
        # One epoch through a loader on the card, against pyarrow.
        epoch = []
        with make_tensor_reader(FAULTS_URL, schema_fields=['image', 'label'], seed=0,
                                workers_count=workers, num_epochs=1, autotune=False,
                                **kwargs) as reader:
            with TorchLoader(reader, BATCH, device=device, last_batch='partial',
                             autotune=False) as loader:
                for batch in loader:
                    epoch.append(batch.label.cpu().numpy())
        epoch = np.concatenate(epoch)
        reckoned = []
        skip = {(p.path, p.row_group) for p in chosen}
        for piece in mem.row_groups():
            if (piece.path, piece.row_group) not in skip:
                with mem.fs.open(piece.path, 'rb') as f:
                    reckoned.append(pq.ParquetFile(f).read_row_group(
                        piece.row_group, columns=['label']).column('label').to_numpy())
        reckoned = np.concatenate(reckoned)
        if len(epoch) != rows_epoch or not np.array_equal(np.sort(epoch), np.sort(reckoned)):
            raise AssertionError('the epoch\'s {} labels differ from pyarrow\'s {} less the '
                                 'quarantined row-groups'.format(len(epoch), len(reckoned)))
        # The threaded, resequenced stream past the holes is the dummy pool's.
        rows = FAULTS_CHECK_BATCHES * BATCH
        single = []
        with make_tensor_reader(FAULTS_URL, schema_fields=['image', 'label'], seed=0,
                                reader_pool_type='dummy', num_epochs=None, autotune=False,
                                **kwargs) as reader:
            while sum(len(c) for c in single) < rows:
                single.append(np.asarray(next(reader).label))
        streamed = np.concatenate(seen)[:rows]
        if len(streamed) != rows or not np.array_equal(streamed, np.concatenate(single)[:rows]):
            raise AssertionError('the first {} batches\' labels differ from the dummy-pool '
                                 'reader\'s'.format(FAULTS_CHECK_BATCHES))
        # The registry, rendered and scraped once over HTTP on 127.0.0.1.
        text = registry.render_text()
        exporter = metrics.start_http_exporter(port=0, registry=registry)
        try:
            with urllib.request.urlopen(exporter.address, timeout=10) as response:
                scraped = response.read().decode()
        finally:
            exporter.stop()
        shown = ('pst_rowgroups_quarantined_total', 'pst_decode_batch_calls_total',
                 'pst_decode_batch_images_total', 'pst_decode_seconds_count',
                 'pst_loader_batches_total')
        missing = [name for name in shown if name not in text or name not in scraped]
        if missing:
            raise AssertionError('the registry\'s text or its scrape lacks {}'.format(missing))
        # A budget of one item raises within one epoch.
        raised = None
        try:
            with make_tensor_reader(FAULTS_URL, schema_fields=['image', 'label'], seed=0,
                                    workers_count=workers, num_epochs=1, cache_type='null',
                                    deterministic=True, error_budget=1, autotune=False) as reader:
                for _ in reader:
                    pass
        except RowGroupQuarantinedError as e:
            raised = len(e.quarantined)
        if raised != 2:
            raise AssertionError('error_budget=1 did not raise within one epoch')
        counters_after = _counter_values(registry)
    finally:
        if previous_spec is None:
            os.environ.pop(faults.ENV_VAR, None)
        else:
            os.environ[faults.ENV_VAR] = previous_spec
        metrics.set_registry(previous_registry)
        if mem.fs.exists(mem.path):
            mem.fs.rm(mem.path, recursive=True)
    if faults.get_injector().active_sites:
        raise AssertionError('the fault spec outlived the cell: {}'.format(
            faults.get_injector().active_sites))
    profile = result['stage_profile']
    result['k1_graph'] = {'ran': window[2]['normalize_kernel'], 'expected': SCAN_K * window[3],
                          'replays': window[3]}
    result['checks'] = {
        'k1_per_replay': SCAN_K, 'quarantined_equal_selected': True, 'epochs_read': epochs_read,
        'quarantined_counter': 2, 'epoch_labels_equal_pyarrow': True,
        'first_batches_equal_dummy_pool': FAULTS_CHECK_BATCHES, 'registry_text_and_scrape': True,
        'losses_finite': True, 'budget_1_raises': True, 'faults_restored': True}
    result['store'] = {'url': FAULTS_URL, 'bytes': store_bytes, 'copy_s': copy_s,
                       'rows': ROWS, 'rows_kept_per_epoch': int(len(epoch))}
    result['faults'] = {'spec': spec, 'error_budget': FAULTS_BUDGET,
                        'selected': [{'path': p.path, 'row_group': p.row_group,
                                      'rows': p.num_rows} for p in chosen]}
    result['read_s'], result['decode_s'] = profile['read_s'], profile['decode_s']
    result['counters'] = {'after_training': counters, 'after_checks': counters_after}
    return dict({'phase': 'imagenet_faults', 'card': card, 'model': 'resnet50',
                 'stem': 'conv7', 'classes': 1000}, **result)


def _counter_values(registry):
    """``{name: value}`` of the registry's unlabelled counters, the
    histograms' observation counts as ``<name>_count``."""
    out = {}
    for name, metric in registry.collect().items():
        for sample in metric['samples']:
            if sample.get('labels'):
                continue
            if metric['type'] == 'counter':
                out[name] = sample['value']
            elif metric['type'] == 'histogram':
                out[name + '_count'] = sample['count']
    return out


# imagenet_health: the watchdog, the tracer, the flight recorder and the
# replay tool under imagenet_scan's protocol.
HEALTH_STALL_TIMEOUT_S = 10.0
#: The injected stall: a copy issue that sleeps several times the 0.6 s at
#: which a 0.3 s deadline escalates.
HEALTH_FAULT_DELAY_S, HEALTH_FAULT_TIMEOUT_S = 3.0, 0.3
HEALTH_STAGES = ('ventilator', 'reader-handoff', 'worker-pool', 'assemble', 'dispatch',
                 'consumer')
HEALTH_SPANS = ('read', 'decode', 'handoff', 'assemble', 'dispatch', 'stage', 'wait')
HEALTH_DUMP_FILES = ('diagnosis.json', 'lineage.json', 'metrics.prom', 'metrics_ring.json',
                     'stacks.txt', 'trace.json')


def _replay_verify(ledger_dir, batch_ids):
    """``python -m petastorm_tpu_torch.tools.replay --verify`` of each batch,
    the processes run at once: ``{batch_id: (exit code, the summary or the
    error)}``."""
    procs = {batch_id: subprocess.Popen(
        [sys.executable, '-m', 'petastorm_tpu_torch.tools.replay', '--ledger', ledger_dir,
         '--batch-id', str(batch_id), '--verify'], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for batch_id in batch_ids}
    out = {}
    for batch_id, proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
        out[batch_id] = (proc.returncode, json.loads(stdout) if proc.returncode == 0
                         else stderr.strip()[-2000:])
    return out


def _span_window(tracer, name, start_us, end_us):
    """Seconds of ``name`` spans that began in ``[start_us, end_us)``."""
    return sum(e['dur'] for e in tracer.events
               if e.get('ph') == 'X' and e['name'] == name and start_us <= e['ts'] < end_us) / 1e6


def _hard_stall_counts(registry):
    metric = registry.collect().get('pst_watchdog_hard_stalls_total') or {'samples': []}
    return {sample['labels'].get('classification'): sample['value']
            for sample in metric['samples'] if sample.get('labels')}


def run_imagenet_health(url, device, card, state, workdir, warmup=3, calls=5, workers=4,
                        reference_rate=None):
    """The health cell on ``state``: (a) imagenet_scan's protocol (memory
    cache, seed 0, endless; ``TorchLoader(batch=128, prefetch=8)``,
    ``superbatches(8)``, ResNet-50 through ``make_scan_train_step(8,
    preprocess=K1)``) with ``watchdog=True``, ``stall_timeout_s=10``, a
    :class:`~petastorm_tpu_torch.trace.Tracer` on the loader and as the
    global tracer, ``PSTT_FLIGHT_RECORDER`` and the lineage ledger under
    ``workdir``; its counted calls run unprofiled (the profiler's
    processing after them keeps the training loop away from the loader
    longer than the 10 s deadline, which the watchdog rightly reports as a
    consumer that stopped draining), and K1 is counted among the graph's
    nodes as in every scan path; (b) the same reader, its memory cache
    filled by one epoch through a plain loader (so that no cold decode
    starves the 0.3 s deadline before the fault), and the same loader under
    ``PSTT_FAULTS=device-put-delay:delay=3:max=1`` with
    ``stall_timeout_s=0.3`` and a fresh metrics registry, then one more
    call from a fresh loader. Fails unless: (a) K1 ran 8 times a replay; the
    watchdog ran with no stall episode, no hard stall and the six stage
    heartbeats; the tracer's summary holds every span of
    :data:`HEALTH_SPANS`; the exported Chrome trace parses with its
    ``process_name`` and ``thread_name`` metadata; img/s is at least 0.95 of
    ``reference_rate`` (when given); the replay tool verifies one batch of
    epoch 1 and one of the timed calls, exit 0; (b) ``next`` raises
    ``PipelineStallError`` within 5 s of the fault's instant, classified
    ``dispatch-hung`` at ``dispatch``, with a flight dump of the six files
    whose ``stacks.txt`` shows the staging dispatch thread asleep;
    ``pst_watchdog_hard_stalls_total{classification="dispatch-hung"}`` is 1;
    no thread of the port outlives the loader; the fresh loader's call
    gives a finite loss. Returns the phase's line."""
    import threading

    from petastorm_tpu_torch import (TorchLoader, faults, flight_recorder, make_tensor_reader,
                                     metrics)
    from petastorm_tpu_torch.errors import PipelineStallError
    from petastorm_tpu_torch.models import make_scan_train_step
    from petastorm_tpu_torch.trace import Tracer, set_global_tracer

    flight_dir = os.path.join(workdir, 'flight')
    ledger_dir = os.path.join(workdir, 'ledger')
    previous_env = {name: os.environ.get(name)
                    for name in (flight_recorder.ENV_VAR, faults.ENV_VAR)}
    os.environ[flight_recorder.ENV_VAR] = flight_dir
    tracer = Tracer(spill_dir=False)
    previous_tracer = set_global_tracer(tracer)
    train = make_scan_train_step(SCAN_K, preprocess=normalize_bf16)
    seen = {}

    def hooks(stage, loader, reader):
        seen[stage + '_us'] = (time.perf_counter() - tracer._t0) * 1e6
        if stage == 'close':
            seen['watchdog'] = loader.stats['watchdog']
            seen['stall_frac'] = loader.stats['input_stall_frac']

    try:
        # (a) the healthy run.
        result, window = stream_classifier_scan(
            url, device, train, state, warmup, calls, ('normalize_kernel',), workers=workers,
            loader_kwargs={'tracer': tracer, 'watchdog': True,
                           'stall_timeout_s': HEALTH_STALL_TIMEOUT_S, 'lineage': ledger_dir},
            hooks=hooks, profile=False)
        require_scan_launches(*window[:3], ('normalize_images',), SCAN_K, window[3])
        watchdog = seen['watchdog']
        missing_beats = sorted(set(HEALTH_STAGES) - set(watchdog['beats']))
        if not watchdog['alive'] or watchdog['stalls_detected'] or watchdog['hard_stalls'] \
                or missing_beats:
            raise AssertionError('the healthy run\'s watchdog: alive {}, {} stall episode(s), {} '
                                 'hard, heartbeats missing {}; last stall {}'.format(
                                     watchdog['alive'], watchdog['stalls_detected'],
                                     watchdog['hard_stalls'], missing_beats,
                                     watchdog['last_stall']))
        summary = tracer.summary()
        empty = [name for name in HEALTH_SPANS if summary.get(name, {}).get('count', 0) == 0]
        if empty:
            raise AssertionError('the tracer recorded no {} span'.format(empty))
        trace_path = tracer.export_chrome_trace(os.path.join(workdir, 'trace.json'))
        with open(trace_path) as f:
            doc = json.load(f)
        meta = {e['name'] for e in doc['traceEvents'] if e.get('ph') == 'M'}
        if not {'process_name', 'thread_name'} <= meta:
            raise AssertionError('the Chrome trace lacks process or thread names: {}'.format(meta))
        if reference_rate is not None and result['img_per_s'] < 0.95 * reference_rate:
            raise AssertionError("img/s {} below 0.95 of imagenet_scan's {}".format(
                result['img_per_s'], reference_rate))
        batches_per_epoch = ROWS // BATCH
        replay_ids = (batches_per_epoch // 2, (warmup + calls + calls // 2) * SCAN_K)
        replayed = _replay_verify(ledger_dir, replay_ids)
        failed = {k: v for k, v in replayed.items() if v[0] != 0}
        if failed:
            raise AssertionError('the replay tool did not verify {}'.format(failed))
        window_us = seen['close_us'] - seen['timed_us']
        healthy = {
            'watchdog': {k: watchdog[k] for k in ('alive', 'stalls_detected', 'soft_recoveries',
                                                  'hard_stalls', 'episode_active')},
            'heartbeats': {name: {k: beat[k] for k in ('state', 'beats', 'stall_timeout_s')}
                           for name, beat in watchdog['beats'].items()},
            'spans': summary, 'trace_events': len(tracer.events),
            'trace_bytes': os.path.getsize(trace_path),
            'timed_window': {
                'wait_s': _span_window(tracer, 'wait', seen['timed_us'], seen['close_us']),
                'wall_s': window_us / 1e6,
                'loader_input_stall_frac': seen['stall_frac'],
                'spans_s': {name: _span_window(tracer, name, seen['timed_us'], seen['close_us'])
                            for name in ('assemble', 'dispatch', 'stage', 'wait')}},
            'replayed': {str(k): v[1]['verified'] for k, v in replayed.items()}}
        healthy['timed_window']['wait_share'] = (healthy['timed_window']['wait_s']
                                                 / healthy['timed_window']['wall_s'])

        # (b) the injected stall.
        registry = metrics.MetricsRegistry()
        previous_registry = metrics.set_registry(registry)
        stall_tracer = Tracer(spill_dir=False)
        set_global_tracer(stall_tracer)
        before = {t.ident for t in threading.enumerate()}
        error = raised_at = None
        try:
            reader = make_tensor_reader(url, schema_fields=['image', 'label'],
                                        reader_pool_type='thread', workers_count=workers,
                                        shuffle_row_groups=True, seed=0, num_epochs=None,
                                        cache_type='memory', autotune=False)
            try:
                t_warm = time.perf_counter()
                with TorchLoader(reader, BATCH, device=device, prefetch=SCAN_PREFETCH,
                                 autotune=False) as warm:
                    for _ in range(ROWS // BATCH):
                        next(warm)
                warm_s = time.perf_counter() - t_warm
                os.environ[faults.ENV_VAR] = 'device-put-delay:delay={}:max=1'.format(
                    HEALTH_FAULT_DELAY_S)
                loader = TorchLoader(reader, BATCH, device=device, prefetch=SCAN_PREFETCH,
                                     tracer=stall_tracer, watchdog=True,
                                     stall_timeout_s=HEALTH_FAULT_TIMEOUT_S, autotune=False)
                try:
                    next(loader.superbatches(SCAN_K))
                except PipelineStallError as e:
                    error, raised_at = e, time.perf_counter()
                finally:
                    t_close = time.perf_counter()
                    loader.close()
                    close_s = time.perf_counter() - t_close
            finally:
                reader.stop()
                reader.join()
        finally:
            os.environ.pop(faults.ENV_VAR, None)
            metrics.set_registry(previous_registry)
        if error is None:
            raise AssertionError('the injected stall raised no PipelineStallError')
        fired = [e for e in stall_tracer.events if e['name'] == 'fault:device-put-delay']
        if len(fired) != 1:
            raise AssertionError('the fault fired {} times'.format(len(fired)))
        to_error_s = raised_at - (stall_tracer._t0 + fired[0]['ts'] / 1e6)
        diagnosis = error.diagnosis
        dump = diagnosis.get('flight_dump')
        files = sorted(os.listdir(dump)) if dump and os.path.isdir(dump) else []
        stacks = ''
        if 'stacks.txt' in files:
            with open(os.path.join(dump, 'stacks.txt')) as f:
                stacks = f.read()
        dispatch_stack = stacks.split('Thread pstt-staging-dispatch ')[-1].split('\nThread ')[0] \
            if 'Thread pstt-staging-dispatch ' in stacks else ''
        hard = _hard_stall_counts(registry)
        leaked = sorted(t.name for t in threading.enumerate()
                        if t.name.startswith('pstt-') and t.ident not in before)
        problems = []
        if not 0 <= to_error_s < 5.0:
            problems.append('raised {} s after the fault'.format(to_error_s))
        if (diagnosis.get('classification'), diagnosis.get('stage')) != ('dispatch-hung',
                                                                          'dispatch'):
            problems.append('classified {} at {}'.format(diagnosis.get('classification'),
                                                       diagnosis.get('stage')))
        if files != sorted(HEALTH_DUMP_FILES):
            problems.append('the flight dump {} holds {}'.format(dump, files))
        if 'sleep' not in dispatch_stack:
            problems.append('stacks.txt shows no sleeping staging dispatch thread')
        if hard != {'dispatch-hung': 1}:
            problems.append('pst_watchdog_hard_stalls_total {}'.format(hard))
        if leaked:
            problems.append('threads left behind: {}'.format(leaked))
        if problems:
            raise AssertionError('the injected stall: ' + '; '.join(problems))
        stall = {'spec': 'device-put-delay:delay={}:max=1'.format(HEALTH_FAULT_DELAY_S),
                 'stall_timeout_s': HEALTH_FAULT_TIMEOUT_S, 'fault_to_error_s': to_error_s,
                 'cache_warm_s': warm_s, 'close_s': close_s,
                 'classification': diagnosis['classification'],
                 'stage': diagnosis['stage'], 'detail': diagnosis['detail'],
                 'hard_stalls_total': hard, 'flight_dump': {
                     'files': {name: os.path.getsize(os.path.join(dump, name)) for name in files},
                     'bytes': sum(os.path.getsize(os.path.join(dump, name)) for name in files)}}

        # One more call from a fresh loader.
        set_global_tracer(previous_tracer)
        with make_tensor_reader(url, schema_fields=['image', 'label'], reader_pool_type='thread',
                                workers_count=workers, shuffle_row_groups=True, seed=0,
                                num_epochs=None, cache_type='memory', autotune=False) as reader:
            with TorchLoader(reader, BATCH, device=device, prefetch=SCAN_PREFETCH,
                             autotune=False) as loader:
                sb = next(loader.superbatches(SCAN_K))
                metrics_after = train(state, sb.image, sb.label)
                loss_after = float(metrics_after['loss'])
        if not math.isfinite(loss_after):
            raise AssertionError('the call after the stall gave loss {}'.format(loss_after))
        stall['loss_after'] = loss_after
    finally:
        set_global_tracer(previous_tracer)
        for name, value in previous_env.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value
    result['k1_graph'] = {'ran': window[2]['normalize_kernel'], 'expected': SCAN_K * window[3],
                          'replays': window[3]}
    result['healthy'] = healthy
    result['injected_stall'] = stall
    result['checks'] = {
        'k1_per_replay': SCAN_K, 'watchdog_alive_no_stall': True,
        'heartbeats': list(HEALTH_STAGES), 'spans': list(HEALTH_SPANS),
        'chrome_trace_metadata': True, 'img_per_s_vs_reference': (
            None if reference_rate is None else result['img_per_s'] / reference_rate),
        'replay_verified': [int(i) for i in replay_ids], 'stall_raised_within_5_s': True,
        'dispatch_hung': True, 'flight_dump_files': list(HEALTH_DUMP_FILES),
        'hard_stalls_counter': 1, 'no_thread_left': True, 'loss_after_finite': True}
    return dict({'phase': 'imagenet_health', 'card': card, 'model': 'resnet50',
                 'stem': 'conv7', 'classes': 1000}, **result)


# imagenet_process: imagenet_decode (a)'s protocol, decoded in worker processes.

#: The process cell's largest result ring (the shm pool's default).
PROCESS_RING_MAX_BYTES = 64 << 20
#: Batches of the process cell's in-order check.
PROCESS_CHECK_BATCHES = 16


def process_ring_bytes(workers):
    """The result ring for ``workers`` workers: what ``os.statvfs`` says
    fits ``workers`` x 2 rings in ``/dev/shm``'s free bytes, at most
    :data:`PROCESS_RING_MAX_BYTES`, a multiple of 4096 (0 without a mount)."""
    from petastorm_tpu_torch.native import shm_ring
    free = shm_ring.shm_free_bytes() or 0
    return min(PROCESS_RING_MAX_BYTES, free // (2 * workers) // 4096 * 4096)


def cuda_compute_pids():
    """The pids ``nvidia-smi`` lists with a compute context on a card."""
    out = subprocess.run(['nvidia-smi', '--query-compute-apps=pid', '--format=csv,noheader'],
                         check=True, capture_output=True, text=True, timeout=60).stdout
    return sorted(int(x) for x in out.split() if x.strip().isdigit())


def maps_cuda_driver(pid):
    """Whether process ``pid`` has the CUDA driver library mapped (any
    context needs it), or None when its maps cannot be read."""
    try:
        with open('/proc/{}/maps'.format(pid)) as f:
            return 'libcuda' in f.read()
    except OSError:
        return None


def _pid_alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def _process_variant(url, device, train, state, warmup, calls, workers, reader_kwargs):
    """One variant of the process cell: imagenet_decode (a)'s protocol with
    ``reader_kwargs``, its counted calls unprofiled (the phase has no
    trace, and the profiler's processing would double the variant's
    time); while the loader still runs, the pool's transport,
    its workers' pids and start-up seconds, the card's compute pids and
    whether a worker maps the CUDA driver. Fails unless K1 ran 8 times a
    replay, no worker is among the card's compute pids or maps the driver,
    and after the reader stopped no worker is alive and no segment of this
    process is left in ``/dev/shm``. Returns the variant's line."""
    from petastorm_tpu_torch.native import shm_ring

    seen = {}

    def hooks(stage, loader, reader):
        if stage == 'close':
            pool = reader._pool
            pids = pool.worker_pids()
            seen.update(transport=pool.transport, worker_pids=pids,
                        worker_startup_s=pool.startup_s,
                        respawns=pool.diagnostics['worker_respawns'],
                        card_compute_pids=cuda_compute_pids(),
                        workers_mapping_cuda=[p for p in pids if maps_cuda_driver(p)],
                        main_maps_cuda=maps_cuda_driver(os.getpid()))

    result, window = stream_classifier_scan(
        url, device, train, state, warmup, calls, ('normalize_kernel',), cache_type='null',
        workers=workers, reader_kwargs=reader_kwargs, hooks=hooks, profile=False)
    require_scan_launches(*window[:3], ('normalize_images',), SCAN_K, window[3])
    result['k1_graph'] = {'ran': window[2]['normalize_kernel'], 'expected': SCAN_K * window[3],
                          'replays': window[3]}
    on_card = sorted(set(seen['worker_pids']) & set(seen['card_compute_pids']))
    if on_card or seen['workers_mapping_cuda']:
        raise AssertionError('worker processes hold the card: {} listed by nvidia-smi, {} map '
                             'the CUDA driver'.format(on_card, seen['workers_mapping_cuda']))
    left = shm_ring.list_segments('{}{}_'.format(shm_ring.SEGMENT_PREFIX, os.getpid()))
    alive = [p for p in seen['worker_pids'] if _pid_alive(p)]
    if left or alive:
        raise AssertionError('after stop: segments {} left, workers {} alive'.format(left, alive))
    seen.update(main_listed_by_nvidia_smi=os.getpid() in seen['card_compute_pids'],
                segments_left=left, workers_alive_after_stop=alive)
    result['workers_seen'] = seen
    return result


def _first_labels(url, device, workers, reader_pool_type, batches, ring_bytes=None):
    """The labels of a deterministic null-cache reader's first ``batches``
    batches through a loader on the card, copied back."""
    from petastorm_tpu_torch import TorchLoader, make_tensor_reader

    extra = {'shm_result_ring_bytes': ring_bytes} if ring_bytes else {}
    labels = []
    with make_tensor_reader(url, schema_fields=['image', 'label'], deterministic=True, seed=0,
                            num_epochs=None, cache_type='null', workers_count=workers,
                            reader_pool_type=reader_pool_type, autotune=False, **extra) as reader:
        with TorchLoader(reader, BATCH, device=device, autotune=False) as loader:
            for batch in loader:
                labels.append(batch.label.cpu().numpy())
                if len(labels) == batches:
                    break
    return np.concatenate(labels)


#: The sanitize cell's (b) and (c) loaders: a shallow arena pool, so arenas
#: come back (and are poisoned) as fast as their copies finish.
SANITIZE_ARENA_DEPTH = 2
SANITIZE_FIELDS = ('image', 'label')


def _sanitize_reader(url):
    """The sanitize cell's deterministic reader: one worker, row-groups in
    order, one epoch, no cache."""
    from petastorm_tpu_torch import make_tensor_reader
    return make_tensor_reader(url, schema_fields=list(SANITIZE_FIELDS), reader_pool_type='thread',
                              workers_count=1, shuffle_row_groups=False, num_epochs=1,
                              autotune=False)


def sanitize_epoch_digests(url, device):
    """One epoch of :func:`_sanitize_reader` through ``TorchLoader(batch=128,
    arena_depth=2)`` on ``device``: each batch copied back to the host and
    reduced to its fields' CRC32 digests (``lineage._digest_array``)."""
    from petastorm_tpu_torch import TorchLoader
    from petastorm_tpu_torch.lineage import _digest_array

    digests = []
    with _sanitize_reader(url) as reader:
        with TorchLoader(reader, BATCH, device=device, arena_depth=SANITIZE_ARENA_DEPTH,
                         autotune=False) as loader:
            for batch in loader:
                digests.append({name: _digest_array(getattr(batch, name).cpu().numpy())
                                for name in SANITIZE_FIELDS})
    return digests


def _port_threads():
    import threading
    return {t.ident: t.name for t in threading.enumerate()
            if t.name.startswith('pstt-') and t.is_alive()}


def sanitize_seeded_bug(url, device, site, timeout_s=10.0):
    """``PSTT_FAULTS=<site>:max=1`` on :func:`_sanitize_reader` through
    ``TorchLoader(batch=128, arena_depth=2)`` on ``device``: what the
    consumer got (the exception, or None after a whole epoch), the batches
    it took before, and the port's threads this pipeline left alive
    ``timeout_s`` after its ``close()``."""
    from petastorm_tpu_torch import TorchLoader, faults
    from petastorm_tpu_torch.analysis.sanitize import LockOrderViolation, StaleViewError

    before = _port_threads()
    saved = os.environ.get(faults.ENV_VAR)
    os.environ[faults.ENV_VAR] = site + ':max=1'
    raised, batches = None, 0
    try:
        with _sanitize_reader(url) as reader:
            with TorchLoader(reader, BATCH, device=device, arena_depth=SANITIZE_ARENA_DEPTH,
                             autotune=False) as loader:
                try:
                    for _ in loader:
                        batches += 1
                except (StaleViewError, LockOrderViolation) as e:
                    raised = e
    finally:
        if saved is None:
            os.environ.pop(faults.ENV_VAR, None)
        else:
            os.environ[faults.ENV_VAR] = saved
    deadline = time.monotonic() + timeout_s
    while True:
        left = sorted(name for ident, name in _port_threads().items() if ident not in before)
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    return {'raised': type(raised).__name__ if raised is not None else None,
            'message': str(raised)[:300] if raised is not None else None,
            'batches_before': batches, 'threads_left': left}


def run_imagenet_sanitize(url, device, card, state, warmup=3, calls=5):
    """The sanitize cell on ``state``, with ``PSTT_SANITIZE=1`` set before
    its readers and loaders are built and removed after, and a fresh
    metrics registry (its lock built armed). (a) imagenet_scan's protocol
    (memory cache, ``superbatches(8)``, ResNet-50 through
    ``make_scan_train_step(8, preprocess=K1)``) at ``warmup`` + ``calls``
    calls: no ``StaleViewError`` or ``LockOrderViolation``, arenas poisoned
    and tracked-lock acquisitions counted by the sanitizer, K1 8 times a
    replay, every loss finite; no rate gate. (b) The in-order poison check:
    one epoch of a one-worker, in-order reader through ``TorchLoader(batch=
    128, arena_depth=2)`` on ``device``, armed, every batch copied back,
    must give the per-field CRC32 digests of the same reader's batches taken
    unarmed on the CPU: a poisoned byte that reached the card fails it.
    (c) The seeded bugs through the same loader: ``arena-stale-view`` must
    reach the consumer as ``StaleViewError`` and ``lock-order-invert`` as
    ``LockOrderViolation`` (the recorder then holds the canary's edge), and
    neither may leave a thread of the port behind. Returns the phase's line
    (its ``failures`` fail the phase once it is printed)."""
    import torch
    from petastorm_tpu_torch import metrics
    from petastorm_tpu_torch.analysis import sanitize
    from petastorm_tpu_torch.models import make_scan_train_step

    t0 = time.perf_counter()
    failures = []
    # On the card every batch goes through an arena; on the CPU an uncached
    # reader's blocks are lent as they are, so (b) poisons nothing there.
    copying = torch.device(device).type == 'cuda'
    # The reference digests, taken unarmed on the CPU before arming.
    saved = os.environ.get(sanitize.ENV_VAR)
    os.environ.pop(sanitize.ENV_VAR, None)
    reference = sanitize_epoch_digests(url, 'cpu')
    os.environ[sanitize.ENV_VAR] = '1'
    previous_registry = metrics.set_registry(metrics.MetricsRegistry())
    sanitize.reset_counters()
    try:
        # (a) scan training, armed.
        train = make_scan_train_step(SCAN_K, preprocess=normalize_bf16)
        result, window = stream_classifier_scan(url, device, train, state, warmup, calls,
                                                ('normalize_kernel',))
        require_scan_launches(*window[:3], ('normalize_images',), SCAN_K, window[3])
        del train
        counts_a = sanitize.counters()
        if counts_a['poisoned'] <= 0 or counts_a['acquisitions'] <= 0:
            failures.append('(a) the sanitizer did not arm: {}'.format(counts_a))
        if counts_a['violations']:
            failures.append('(a) {} lock-order violation(s) recorded'.format(
                counts_a['violations']))
        # (b) the in-order poison check.
        armed = sanitize_epoch_digests(url, device)
        counts_b = sanitize.counters()
        mismatched = [i for i, (a, b) in enumerate(zip(armed, reference)) if a != b]
        if len(armed) != len(reference) or len(armed) != ROWS // BATCH or mismatched:
            failures.append('(b) {} armed batches on the card against {} unarmed on the CPU; '
                            'digests differ at {}'.format(len(armed), len(reference),
                                                          mismatched[:8]))
        if copying and counts_b['poisoned'] <= counts_a['poisoned']:
            failures.append('(b) no arena was poisoned during the epoch: {}'.format(counts_b))
        # (c) the seeded bugs.
        seeded = {}
        for site, expected in (('arena-stale-view', 'StaleViewError'),
                               ('lock-order-invert', 'LockOrderViolation')):
            seeded[site] = sanitize_seeded_bug(url, device, site)
            if seeded[site]['raised'] != expected:
                failures.append('(c) {}: the consumer got {}, not {}'.format(
                    site, seeded[site]['raised'], expected))
            if seeded[site]['threads_left']:
                failures.append('(c) {}: threads left after close: {}'.format(
                    site, seeded[site]['threads_left']))
        counts_c = sanitize.counters()
        if counts_c['edges'] <= 0:
            failures.append('(c) the recorder holds no lock-order edge: {}'.format(counts_c))
    finally:
        metrics.set_registry(previous_registry)
        if saved is None:
            os.environ.pop(sanitize.ENV_VAR, None)
        else:
            os.environ[sanitize.ENV_VAR] = saved
    result = dict({'phase': 'imagenet_sanitize', 'card': card, 'model': 'resnet50',
                   'stem': 'conv7', 'classes': 1000}, **result)
    result.update({
        'k1_graph': {'ran': window[2]['normalize_kernel'], 'expected': SCAN_K * window[3],
                     'replays': window[3]},
        'sanitizer': {'scan': counts_a, 'after_epoch': counts_b, 'after_seeded': counts_c},
        'poison_check': {'batches': len(armed), 'reference_batches': len(reference),
                         'arena_depth': SANITIZE_ARENA_DEPTH, 'digests_equal': not mismatched
                         and len(armed) == len(reference)},
        'seeded': seeded, 'failures': failures, 'seconds': time.perf_counter() - t0})
    return result


def run_imagenet_process(url, device, card, state, workdir, warmup=3, calls=5, workers=8):
    """The process cell: imagenet_decode (a)'s protocol (a ``null`` cache,
    so every epoch decodes; ``workers`` workers; K1 in the 8-step graph) on
    ``state``, decoded in worker processes. (a) ``reader_pool_type=
    'process'`` with the result ring of :func:`process_ring_bytes`; fails
    unless the pool runs on shared memory. (b) ``'process-zmq'``, when
    pyzmq imports (else its entry says so). (c) A deterministic
    ``'process'`` reader's first 16 batches' labels, copied back from the
    card, equal a ``'thread'`` reader's in order. (d) Under
    ``PSTT_FAULTS=worker-kill:token=<file>`` and a fresh metrics registry,
    one epoch of a ``'process'`` reader trains through (a)'s graph: exactly
    one worker is SIGKILLed, the epoch's labels equal pyarrow's 2,048 as a
    multiset, ``pst_worker_deaths_total`` and ``pst_worker_respawns_total``
    are 1, and every loss is finite. Each variant of (a) and (b) is checked
    by :func:`_process_variant`. Returns the phase's line."""
    import torch
    from petastorm_tpu_torch import TorchLoader, faults, make_tensor_reader, metrics
    from petastorm_tpu_torch.models import make_scan_train_step
    from petastorm_tpu_torch.native import shm_ring
    from petastorm_tpu_torch.workers.exec_in_new_process import PICKLER
    from petastorm_tpu_torch.workers.process_pool import zmq_available

    t0 = time.perf_counter()
    ring = process_ring_bytes(workers)
    shm = {'ring_bytes': ring, 'dev_shm_bytes': shm_ring.shm_total_bytes(),
           'dev_shm_free_bytes': shm_ring.shm_free_bytes()}
    emit({'phase': 'imagenet_process', 'step': 'ring', 'shm': shm})
    out = {'phase': 'imagenet_process', 'card': card, 'model': 'resnet50', 'stem': 'conv7',
           'classes': 1000, 'cache_type': 'null', 'workers': workers, 'shm': shm,
           'dill': PICKLER == 'dill', 'pyzmq': zmq_available()}
    train = make_scan_train_step(SCAN_K, preprocess=normalize_bf16)
    # (a) the shared-memory pool.
    line = _process_variant(url, device, train, state, warmup, calls, workers,
                            {'reader_pool_type': 'process', 'shm_result_ring_bytes': ring})
    if line['workers_seen']['transport'] != 'shm_ring':
        raise AssertionError("reader_pool_type='process' ran on {}, not shared memory".format(
            line['workers_seen']['transport']))
    out['process_shm'] = line
    # (b) the zmq pool.
    if out['pyzmq']:
        del train
        torch.cuda.empty_cache()
        train = make_scan_train_step(SCAN_K, preprocess=normalize_bf16)
        out['process_zmq'] = _process_variant(url, device, train, state, warmup, calls, workers,
                                              {'reader_pool_type': 'process-zmq'})
    else:
        out['process_zmq'] = 'pyzmq: absent'
    # (c) the deterministic stream against the thread pool's.
    rows = PROCESS_CHECK_BATCHES * BATCH
    by_process = _first_labels(url, device, workers, 'process', PROCESS_CHECK_BATCHES, ring)
    by_thread = _first_labels(url, device, workers, 'thread', PROCESS_CHECK_BATCHES)
    if len(by_process) != rows or not np.array_equal(by_process, by_thread):
        raise AssertionError('the deterministic process reader\'s first {} batches\' labels '
                             'differ from the thread reader\'s'.format(PROCESS_CHECK_BATCHES))
    out['deterministic'] = {'batches': PROCESS_CHECK_BATCHES, 'labels_equal_thread_pool': True}
    # (d) a worker killed by the fault site, one epoch trained through.
    token = os.path.join(workdir, 'worker-kill.token')
    os.makedirs(workdir, exist_ok=True)
    previous_spec = os.environ.get(faults.ENV_VAR)
    previous_registry = metrics.set_registry(metrics.MetricsRegistry())
    os.environ[faults.ENV_VAR] = 'worker-kill:token={}'.format(token)
    labels, losses = [], []
    try:
        registry = metrics.get_registry()
        with make_tensor_reader(url, schema_fields=['image', 'label'], reader_pool_type='process',
                                workers_count=workers, cache_type='null', num_epochs=1, seed=0,
                                shm_result_ring_bytes=ring, autotune=False) as reader:
            with TorchLoader(reader, BATCH, device=device, prefetch=SCAN_PREFETCH,
                             autotune=False) as loader:
                for sb in loader.superbatches(SCAN_K):
                    labels.append(sb.label.cpu().numpy())
                    metrics_ = train(state, sb.image, sb.label)
                    losses.append([float(metrics_['loss']), float(metrics_['last_loss'])])
            respawns = reader.diagnostics()['worker_respawns']
        counters = _counter_values(registry)
    finally:
        if previous_spec is None:
            os.environ.pop(faults.ENV_VAR, None)
        else:
            os.environ[faults.ENV_VAR] = previous_spec
        metrics.set_registry(previous_registry)
    labels = np.concatenate(labels)
    reckoned = read_store_column(url, 'label')
    deaths = counters.get('pst_worker_deaths_total')
    respawned = counters.get('pst_worker_respawns_total')
    if not os.path.exists(token) or deaths != 1 or respawned != 1 or respawns != 1:
        raise AssertionError('worker-kill: token {}, deaths {}, respawns {} (pool: {})'.format(
            os.path.exists(token), deaths, respawned, respawns))
    if len(labels) != ROWS or not np.array_equal(np.sort(labels), np.sort(reckoned)):
        raise AssertionError('the epoch across the kill gave {} labels, not pyarrow\'s {} as a '
                             'multiset'.format(len(labels), len(reckoned)))
    if not all(math.isfinite(v) for pair in losses for v in pair):
        raise AssertionError('non-finite loss across the kill: {}'.format(losses))
    out['worker_kill'] = {'deaths': deaths, 'respawns': respawned, 'rows': int(len(labels)),
                          'labels_equal_pyarrow': True, 'losses_mean_last': losses}
    del train
    torch.cuda.empty_cache()
    a = out['process_shm']
    out.update(img_per_s=a['img_per_s'], device_step_ms=a['device_step_ms'],
               input_stall_frac=a['input_stall_frac'],
               decode_s=a['stage_profile']['decode_s'], decoder=a['decoder'],
               worker_startup_s=a['workers_seen']['worker_startup_s'],
               k1_graph=a['k1_graph'], launches=a['launches'],
               checks={'k1_per_replay': SCAN_K, 'shm_transport': True,
                       'no_worker_on_card': True, 'nothing_left_after_stop': True,
                       'zmq_variant': bool(out['pyzmq']),
                       'deterministic_labels_equal_thread': PROCESS_CHECK_BATCHES,
                       'worker_kill_exactly_once': True, 'losses_finite': True},
               seconds=time.perf_counter() - t0)
    return out


# imagenet_remote: imagenet_decode (a)'s protocol with the reader in a server
# process (the data service), and the fleet_wire record of bench.py:1344-1552.

#: The remote cell's flow-control credits (chunks sent and not yet granted
#: back), and the server's and the consumer's zmq high-water marks. A
#: consumer grants its credits back every 0.25 s once half are owed, so up
#: to ~10 chunks (0.75 s at 14 chunks/s) sit received and not yet granted;
#: with 16 credits the server could then run only ~6 chunks ahead, fewer
#: than the 8 a superbatch call takes at once.
REMOTE_CREDITS, REMOTE_SNDHWM, REMOTE_RCVHWM = 32, 4, 4
#: Chunks the shm ring holds: the credits, the loader's prefetch (4 chunks)
#: and the superbatch it gathers (4), the chunk being cut, acks in transit
#: (a 0.25 s flush, ~4 chunks), and room to spare.
REMOTE_RING_CHUNKS = 48
#: The crash variant: 2 epochs, the server SIGKILLed by ``server-kill``
#: (unkeyed draws of seed 5: 0.953, 0.325, 0.369, 0.508, 0.539, 0.202, so at
#: p=0.25 it fires on the serve loop's sixth pass, before chunk 5 is sent).
REMOTE_CRASH_EPOCHS, REMOTE_KILL_SPEC, REMOTE_KILL_CHUNK = 2, 'server-kill:p=0.25:seed=5', 5
#: (a)'s img/s floor against imagenet_decode (a)'s of the same run. (a) has
#: read 0.62 to 1.29 of it on an H100 host with every byte on shm, so the
#: floor catches a tier that falls back or a server that stalls, not the
#: host's swings; the line's ``timed_split`` and ``timed_server`` say where
#: a slow window's time went.
REMOTE_MIN_RATIO = 0.75
#: The fleet_wire record: 4096 rows of 4 KB (16 MB chunks) a chunk, 48 chunks
#: a pass, the JAX child's 3 repetitions a tier (``BENCH_WIRE_*`` override).
WIRE_ROWS, WIRE_WIDTH, WIRE_CHUNKS, WIRE_REPS = 4096, 1024, 48, 3


def imagenet_chunk_bytes(rows=ROWS_PER_GROUP, size=IMAGE):
    """One decoded row-group of the imagenet store: uint8 images and int64
    labels."""
    return rows * size * size * 3 + rows * 8


def remote_ring_bytes(chunk_bytes, chunks=REMOTE_RING_CHUNKS):
    """The wire ring for ``chunks`` chunks of ``chunk_bytes``, at most half of
    ``/dev/shm``'s free bytes, a multiple of 4096."""
    from petastorm_tpu_torch.native import shm_ring
    free = shm_ring.shm_free_bytes() or 0
    return min(chunks * chunk_bytes, free // 2) // 4096 * 4096


def start_server(url, bind, workers, epochs, args=(), env=None, timeout_s=120):
    """``python -m petastorm_tpu_torch.tools.serve_cli`` over ``url``'s image
    and label fields, in a process that sees no card
    (``CUDA_VISIBLE_DEVICES=''``): ``workers`` reader threads, a ``null``
    cache, shuffled row-groups (seed 0), ``epochs`` epochs. Returns (the
    process, its status line, seconds until the line)."""
    cmd = [sys.executable, '-m', 'petastorm_tpu_torch.tools.serve_cli', url, '--bind', bind,
           '--fields', 'image', 'label', '--workers', str(workers), '--epochs', str(epochs),
           '--cache-type', 'null', '--shuffle-row-groups', '--seed', '0',
           '--sndhwm', str(REMOTE_SNDHWM)] + list(args)
    full_env = dict(os.environ if env is None else env, CUDA_VISIBLE_DEVICES='')
    full_env['PYTHONPATH'] = os.pathsep.join(filter(None, [ROOT, full_env.get('PYTHONPATH')]))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, env=full_env, cwd=ROOT)
    line = proc.stdout.readline()
    if not line:
        proc.wait(timeout_s)
        raise RuntimeError('the server exited with {} before its status line'.format(
            proc.returncode))
    return proc, json.loads(line), time.perf_counter() - t0


def stop_server(proc, timeout_s=30):
    """A SIGTERM (the CLI drains), another after 1 s (it stops without the
    5 s grace that lets a served stream's tail and END reach its consumer),
    SIGKILL past ``timeout_s``; the exit code."""
    for signum, wait_s in ((signal.SIGTERM, 1.0), (signal.SIGTERM, timeout_s)):
        if proc.poll() is not None:
            return proc.returncode
        proc.send_signal(signum)
        try:
            return proc.wait(wait_s)
        except subprocess.TimeoutExpired:
            pass
    proc.kill()
    return proc.wait()


def wire_segments_of(pids):
    """The ``pstt-wire-`` segments in ``/dev/shm`` whose header names one of
    ``pids`` as its owner (segments of other processes are left out)."""
    from petastorm_tpu_torch.fleet import wire as wire_mod
    from petastorm_tpu_torch.native import shm_ring
    out = []
    for name in shm_ring.list_segments(wire_mod.SEGMENT_PREFIX):
        header = wire_mod.read_segment_header(os.path.join(shm_ring.shm_dir(), name))
        if header is not None and header[1] in pids:
            out.append(name)
    return out


def wire_counters(snapshot):
    """``pst_wire_bytes_total`` by transport and the serialize seconds'
    sum and count of a metrics snapshot."""
    by_transport = {s['labels'].get('transport'): s['value']
                    for s in (snapshot.get('pst_wire_bytes_total') or {}).get('samples', [])}
    ser = {'sum': 0.0, 'count': 0}
    for s in (snapshot.get('pst_wire_serialize_seconds') or {}).get('samples', []):
        ser['sum'] += s.get('sum', 0.0)
        ser['count'] += s.get('count', 0)
    return by_transport, ser


def remote_classifier_scan(endpoint, device, train, state, warmup, calls, kernels, wire=None,
                           hooks=None):
    """The scan protocol of :func:`stream_classifier_scan` fed by a data
    server: ``RemoteReader(endpoint, flow_control=REMOTE_CREDITS)`` ->
    ``TorchLoader(batch=128, prefetch=8)`` -> ``superbatches(8)``;
    :func:`scan_window` over ``warmup`` + ``calls`` calls (unprofiled), then
    ``calls`` timed. ``wire`` forces the consumer's tier. ``hooks(stage,
    reader)`` runs with ``'timed'`` just before the timed calls and with
    ``'close'`` just after them, while the stream is open; what the second
    returns joins the line. The line's ``timed_split`` says where the timed
    window's wall went on the consumer's side: blocked in ``next``, the
    staging threads' wait on the reader, the copies' issue and the arenas'
    wait, and the credits owed to the server at its end. Returns the line
    and the launch window."""
    import torch
    from petastorm_tpu_torch import TorchLoader
    from petastorm_tpu_torch.data_service import RemoteReader

    torch.cuda.empty_cache()
    reader = RemoteReader(endpoint, rcvhwm=REMOTE_RCVHWM, flow_control=REMOTE_CREDITS,
                          wire=wire, end_grace_s=30.0)
    with reader:
        with TorchLoader(reader, BATCH, device=device, prefetch=SCAN_PREFETCH,
                         autotune=False) as loader:
            groups = loader.superbatches(SCAN_K)

            def next_inputs():
                sb = next(groups)
                return sb.image, sb.label

            metrics, launches, captured, ran, _, replays = scan_window(
                train, state, next_inputs, warmup, calls, kernels, profile=False)
            stats0 = loader.stats
            loader.reset_stats()
            if hooks is not None:
                hooks('timed', reader)
            owed0 = reader.diagnostics['credits_owed']
            wall, wait_s, call_ms, timed = time_scan_calls(train, state, next_inputs, calls)
            stats = loader.stats
            diagnostics = reader.diagnostics
            extra = hooks('close', reader) if hooks is not None else {}
    losses = [[float(m['loss']), float(m['last_loss'])] for m in metrics + timed]
    if not all(math.isfinite(v) for pair in losses for v in pair):
        raise AssertionError('non-finite loss: {}'.format(losses))
    rows = (warmup + 2 * calls) * SCAN_K * BATCH
    if stats0['rows'] + stats['rows'] != rows:
        raise AssertionError('loader delivered {} rows, expected {}'.format(
            stats0['rows'] + stats['rows'], rows))
    steps = calls * SCAN_K
    result = dict({
        'batch': BATCH, 'microbatches': SCAN_K, 'prefetch': SCAN_PREFETCH,
        'warmup_calls': warmup, 'counted_calls': calls, 'timed_calls': calls,
        'losses_mean_last': losses, 'img_per_s': steps * BATCH / wall,
        'step_ms': wall / steps * 1e3, 'input_stall_frac': wait_s / wall,
        'device_call_ms_median': call_ms, 'device_step_ms': call_ms / SCAN_K,
        'rows_delivered': stats0['rows'] + stats['rows'],
        'remote_chunks': diagnostics['remote_chunks'],
        'duplicate_chunks': diagnostics['duplicate_chunks'],
        'wire_decode_errors': diagnostics['wire_decode_errors'],
        'granted': diagnostics['wire'],
        'timed_split': {'wall_s': wall, 'consumer_wait_s': wait_s,
                        'reader_wait_s': stats.get('reader_wait_s', 0.0),
                        'stage_dispatch_s': stats['stage_dispatch_s'],
                        'arena_wait_s': stats.get('arena_wait_s', 0.0),
                        'ready_wait_s': stats.get('ready_wait_s', 0.0),
                        'credits_owed_start': owed0,
                        'credits_owed_end': diagnostics['credits_owed'],
                        'credits': REMOTE_CREDITS},
        'launches': _scan_launches(launches, captured, ran, warmup + calls, replays)}, **extra)
    return result, (launches, captured, ran, replays)


def _server_counters(reader):
    """The server's counters from its metrics: wire bytes by transport,
    serialize seconds and their count, decode seconds and their count (the
    reader's ``pst_decode_seconds``) and chunks served; and the chunks the
    consumer received."""
    received = reader.diagnostics['remote_chunks']     # first: served >= received
    fleet = reader.fleet_metrics(timeout_ms=10000)
    aggregate = fleet['aggregate']
    by_transport, ser = wire_counters(aggregate)
    decode = {'sum': 0.0, 'count': 0}
    for s in (aggregate.get('pst_decode_seconds') or {}).get('samples', []):
        decode['sum'] += s.get('sum', 0.0)
        decode['count'] += s.get('count', 0)
    return {'by_transport': by_transport, 'serialize': ser, 'decode': decode,
            'served': sum(s['value'] for s in aggregate.get(
                'pst_data_service_chunks_served_total', {}).get('samples', [])),
            'received': received}


def _server_hooks(proc, seen):
    """While the stream is open: the server's counters at the timed
    window's start and end (:func:`_server_counters`), and whether its
    process maps the CUDA driver or is among the card's compute pids. The
    line gets the totals and, under ``timed_server``, the window's share:
    chunks served, decode seconds a chunk and the decode threads' busy
    share of the window's wall, serialize ms a chunk, bytes by transport,
    and the chunks in flight at both ends (served and not yet received:
    with the consumer's credits owed, what the server's credit lacks)."""
    start = {}

    def hooks(stage, reader):
        counters = _server_counters(reader)
        if stage == 'timed':
            start.update(counters, t=time.perf_counter())
            return {}
        wall = time.perf_counter() - start['t']
        seen.update(server_pid=proc.pid, server_maps_cuda=maps_cuda_driver(proc.pid),
                    server_on_card=proc.pid in cuda_compute_pids())
        ser, decode = counters['serialize'], counters['decode']
        served = counters['served'] - start['served']
        d_count = decode['count'] - start['decode']['count']
        d_sum = decode['sum'] - start['decode']['sum']
        s_count = ser['count'] - start['serialize']['count']
        s_sum = ser['sum'] - start['serialize']['sum']
        return {'wire_bytes_by_transport': counters['by_transport'],
                'serialize_ms_per_chunk': ser['sum'] / ser['count'] * 1e3 if ser['count'] else None,
                'serialized_chunks': ser['count'],
                'server_chunks_served': counters['served'],
                'timed_server': {
                    'wall_s': wall, 'chunks_served': served,
                    'decode_calls': d_count, 'decode_s': d_sum,
                    'decode_s_per_chunk': d_sum / served if served else None,
                    'decode_busy_share': d_sum / wall if wall > 0 else None,
                    'serialize_ms_per_chunk': s_sum / s_count * 1e3 if s_count else None,
                    'wire_bytes_by_transport': {
                        k: v - start['by_transport'].get(k, 0)
                        for k, v in counters['by_transport'].items()},
                    'in_flight_start': start['served'] - start['received'],
                    'in_flight_end': counters['served'] - counters['received']}}
    return hooks


def _remote_variant(url, device, train, state, workdir, name, warmup, calls, workers, wire,
                    ring_bytes):
    """One streamed variant of the remote cell: a server for as many epochs
    as the calls need (``--await-cursor``: it reads nothing before the
    trainer's attach, so no chunk rides the empty fleet's tier), the scan
    protocol through :func:`remote_classifier_scan`. Fails unless K1 ran 8
    times a replay, the server neither maps the CUDA driver nor is among
    the card's compute pids, and no ``pstt-wire-`` segment is left once it
    stopped. Returns the variant's line."""
    t0 = time.perf_counter()
    rows = (warmup + 2 * calls) * SCAN_K * BATCH + (SCAN_PREFETCH + SCAN_K) * BATCH
    epochs = -(-rows // ROWS) + 1
    env = dict(os.environ, PSTT_WIRE_SEGMENT_MB=str(ring_bytes / (1 << 20)))
    bind = 'ipc://' + os.path.join(workdir, name)
    proc, status, up_s = start_server(url, bind, workers, epochs, ['--await-cursor'], env=env)
    seen = {}
    try:
        result, window = remote_classifier_scan(status['data_endpoint'], device, train, state,
                                                warmup, calls, ('normalize_kernel',), wire=wire,
                                                hooks=_server_hooks(proc, seen))
    finally:
        rc = stop_server(proc)
    failures = []
    try:
        require_scan_launches(*window[:3], ('normalize_images',), SCAN_K, window[3])
    except AssertionError as e:
        failures.append(str(e))
    left = wire_segments_of({proc.pid})
    if seen.get('server_maps_cuda') is not False or seen.get('server_on_card'):
        failures.append('the server process holds the card: maps libcuda {}, listed by '
                        'nvidia-smi {}'.format(seen.get('server_maps_cuda'),
                                               seen.get('server_on_card')))
    if left:
        failures.append('segments left after the server stopped: {}'.format(left))
    result.update(server=dict(seen, epochs=epochs, start_s=up_s, exit_code=rc,
                              ring_bytes=ring_bytes),
                  segments_left=left, failures=failures, seconds=time.perf_counter() - t0,
                  k1_graph={'ran': window[2]['normalize_kernel'],
                            'expected': SCAN_K * window[3], 'replays': window[3]})
    return result


def _remote_crash(url, device, train, state, workdir, workers):
    """(c): a deterministic server with self-snapshots, SIGKILLed by the
    ``server-kill`` site mid-epoch and restarted with ``--resume`` on the
    same endpoint while the trainer keeps stepping. Each epoch's rows,
    digested on the card (:func:`_row_digests`), must equal an
    uninterrupted epoch's as a multiset."""
    import threading
    import torch
    from petastorm_tpu_torch import TorchLoader, make_tensor_reader
    from petastorm_tpu_torch.data_service import RemoteReader

    t0 = time.perf_counter()
    with make_tensor_reader(url, schema_fields=['image', 'label'], num_epochs=1,
                            cache_type='null', workers_count=workers, autotune=False) as reader:
        with TorchLoader(reader, BATCH, device=device, autotune=False) as loader:
            reference = torch.sort(torch.cat([_row_digests(b.image) for b in loader])).values
    snap = os.path.join(workdir, 'remote-crash.pkl')
    token = os.path.join(workdir, 'remote-crash.token')
    bind = 'ipc://' + os.path.join(workdir, 'remote-crash')
    args = ['--deterministic', '--snapshot-path', snap, '--snapshot-every', '4']
    env = dict(os.environ, PSTT_FAULTS='{}:token={}'.format(REMOTE_KILL_SPEC, token))
    env.pop('PSTT_WIRE_SEGMENT_MB', None)
    first, status, up_s = start_server(url, bind, workers, REMOTE_CRASH_EPOCHS, args, env=env)
    # Read while no consumer is attached, so the server cannot have died yet.
    maps_cuda = [maps_cuda_driver(first.pid)]
    clean_env = {k: v for k, v in os.environ.items() if k != 'PSTT_FAULTS'}
    restart = {}

    def restarter():
        rc = first.wait()
        t0 = time.perf_counter()
        restart['kill_rc'] = rc
        try:
            proc, line, _ = start_server(url, bind, workers, REMOTE_CRASH_EPOCHS,
                                         args + ['--resume', snap], env=clean_env)
            restart.update(proc=proc, status=line, seconds=time.perf_counter() - t0)
            maps_cuda.append(maps_cuda_driver(proc.pid))
        except Exception as e:  # noqa: BLE001 - reported by the phase
            restart['error'] = repr(e)

    watcher = threading.Thread(target=restarter, name='pstt-bench-restarter', daemon=True)
    watcher.start()
    digests, losses, failures, diagnostics = [], [], [], {}
    try:
        with RemoteReader(status['data_endpoint'], rcvhwm=REMOTE_RCVHWM, end_grace_s=30.0,
                          reconnect_s=60.0) as remote:
            try:
                with TorchLoader(remote, BATCH, device=device, prefetch=SCAN_PREFETCH,
                                 autotune=False) as loader:
                    for sb in loader.superbatches(SCAN_K):
                        digests.append(_row_digests(sb.image))
                        metrics = train(state, sb.image, sb.label)
                        losses.append([float(metrics['loss']), float(metrics['last_loss'])])
            except Exception as e:  # noqa: BLE001 - the line reports it, then the phase fails
                failures.append('the stream raised across the kill: {!r}'.format(e))
            diagnostics = remote.diagnostics
        watcher.join(timeout=60)
    finally:
        for proc in (first, restart.get('proc')):
            if proc is not None:
                stop_server(proc)
    if 'error' in restart or 'proc' not in restart:
        failures.append('the restart failed: {}'.format(restart.get('error', 'no restart')))
    got = torch.cat(digests) if digests else torch.empty(0, dtype=torch.int64, device=device)
    per_epoch = ROWS
    lost = duplicated = 0
    for epoch in range(REMOTE_CRASH_EPOCHS):
        part = torch.sort(got[epoch * per_epoch:(epoch + 1) * per_epoch]).values
        if part.numel() != reference.numel() or not torch.equal(part, reference):
            ref_counts = collections.Counter(reference.tolist())
            got_counts = collections.Counter(part.tolist())
            lost += sum((ref_counts - got_counts).values())
            duplicated += sum((got_counts - ref_counts).values())
    lost += max(0, REMOTE_CRASH_EPOCHS * per_epoch - got.numel())
    out = {'epochs': REMOTE_CRASH_EPOCHS, 'rows': int(got.numel()),
           'kill_spec': REMOTE_KILL_SPEC, 'kill_chunk': REMOTE_KILL_CHUNK,
           'kill_exit_code': restart.get('kill_rc'), 'token': os.path.exists(token),
           'restart_s': restart.get('seconds'), 'first_server_start_s': up_s,
           'server_pids': [first.pid] + ([restart['proc'].pid] if 'proc' in restart else []),
           'servers_map_cuda': maps_cuda,
           'duplicate_chunks_dropped': diagnostics.get('duplicate_chunks'),
           'remote_chunks': diagnostics.get('remote_chunks'), 'rows_lost': lost,
           'rows_duplicated': duplicated, 'losses_mean_last': losses, 'failures': failures,
           'seconds': time.perf_counter() - t0}
    if restart.get('kill_rc') != -signal.SIGKILL or not out['token']:
        failures.append('server-kill did not SIGKILL the server: exit {}, token {}'.format(
            restart['kill_rc'], out['token']))
    if any(m is not False for m in maps_cuda):
        failures.append('a server process maps the CUDA driver: {}'.format(maps_cuda))
    if lost or duplicated or got.numel() != REMOTE_CRASH_EPOCHS * per_epoch:
        failures.append('across the kill: {} rows, {} lost, {} delivered twice'.format(
            got.numel(), lost, duplicated))
    if not all(math.isfinite(v) for pair in losses for v in pair):
        failures.append('non-finite loss across the kill: {}'.format(losses))
    return out


def run_imagenet_remote(url, device, card, state, workdir, warmup=3, calls=5, workers=8,
                        decode_rate=None, wire_reps=1, arrow_calls=None):
    """The remote cell: imagenet_decode (a)'s protocol (a ``null`` cache,
    ``workers`` OpenCV threads, K1 in the 8-step graph) on ``state``, with
    the reader in a server process (``serve_cli``, no card) feeding
    ``RemoteReader`` -> ``TorchLoader`` -> ``superbatches(8)`` over
    ``ipc://`` sockets in ``workdir``. (a) negotiated: the sole same-host
    consumer is granted shm, the ring sized by :func:`remote_ring_bytes`;
    (b) ``wire='arrow-ipc'`` forced on the consumer (``arrow_calls``
    counted and timed calls, by default ``calls``); (c)
    :func:`_remote_crash`; (d) :func:`run_fleet_wire` with ``wire_reps``
    repetitions. The line's ``failures`` lists every check that failed: K1
    not 8 a replay in (a) or (b), a server mapping the CUDA driver or listed
    by ``nvidia-smi``, a segment left, a row lost or delivered twice across
    (c)'s kill, and (a) under :data:`REMOTE_MIN_RATIO` of ``decode_rate``
    when it is given; the caller prints the line, then fails on them.
    Returns the phase's line."""
    import torch
    from petastorm_tpu_torch.models import make_scan_train_step
    from petastorm_tpu_torch.native import shm_ring

    t0 = time.perf_counter()
    os.makedirs(workdir, exist_ok=True)
    chunk = imagenet_chunk_bytes()
    ring = remote_ring_bytes(chunk)
    out = {'phase': 'imagenet_remote', 'card': card, 'model': 'resnet50', 'stem': 'conv7',
           'classes': 1000, 'cache_type': 'null', 'workers': workers, 'chunk_bytes': chunk,
           'ring_bytes': ring, 'ring_chunks': ring // chunk,
           'dev_shm_free_bytes': shm_ring.shm_free_bytes(), 'credits': REMOTE_CREDITS,
           'sndhwm': REMOTE_SNDHWM, 'rcvhwm': REMOTE_RCVHWM}
    emit({'phase': 'imagenet_remote', 'step': 'ring', 'ring_bytes': ring, 'chunk_bytes': chunk})
    for name, wire, n in (('negotiated', None, calls),
                          ('arrow', 'arrow-ipc', calls if arrow_calls is None else arrow_calls)):
        train = make_scan_train_step(SCAN_K, preprocess=normalize_bf16)
        out[name] = _remote_variant(url, device, train, state, workdir, 'remote-' + name,
                                    warmup, n, workers, wire, ring)
        if name == 'arrow':
            out['crash'] = _remote_crash(url, device, train, state, workdir, workers)
        del train
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    out['fleet_wire'] = run_fleet_wire(reps=wire_reps)
    out['fleet_wire']['seconds'] = time.perf_counter() - t1
    a = out['negotiated']
    failures = ['{}: {}'.format(name, f) for name in ('negotiated', 'arrow', 'crash')
                for f in out[name]['failures']]
    if out['fleet_wire']['leaked_segments']:
        failures.append('fleet_wire: segments left {}'.format(
            out['fleet_wire']['leaked_segments']))
    out.update(img_per_s=a['img_per_s'], device_step_ms=a['device_step_ms'],
               input_stall_frac=a['input_stall_frac'], k1_graph=a['k1_graph'],
               launches=a['launches'], failures=failures, seconds=time.perf_counter() - t0)
    if decode_rate:
        out['img_per_s_vs_decode_worker_decode'] = a['img_per_s'] / decode_rate
        out['min_ratio'] = REMOTE_MIN_RATIO
        if a['img_per_s'] < REMOTE_MIN_RATIO * decode_rate:
            failures.append('(a) at {:.4f} of imagenet_decode (a)\'s img/s, under {}'.format(
                a['img_per_s'] / decode_rate, REMOTE_MIN_RATIO))
    return out


def _fleet_wire_server(argv):
    """The server half of :func:`run_fleet_wire`, run as ``python -c`` in a
    process of its own that sees no card (an in-process server would share
    the consumer's GIL, ``bench.py:1346-1360``). ``argv``: tier, bind,
    chunk rows, row width, chunks. Serves the synthetic chunks at the tier,
    held until the consumer attached; prints the data endpoint, then, once
    a line arrives on stdin, its metrics snapshot."""
    tier, bind = argv[0], argv[1]
    chunk_rows, row_width, n_chunks = (int(v) for v in argv[2:5])
    import collections as collections_mod
    from petastorm_tpu_torch import data_service, metrics

    class _StreamReader(object):
        batched_output = True
        ngram = None

        def __iter__(self):
            nt = collections_mod.namedtuple('WireChunk', ['vec', 'sid'])
            vec = np.random.default_rng(7).random((chunk_rows, row_width)).astype(np.float32)
            for i in range(n_chunks):
                yield nt(vec=vec, sid=np.arange(i * chunk_rows, (i + 1) * chunk_rows,
                                                dtype=np.int64))

        def stop(self):
            pass

        def join(self):
            pass

    server = data_service.DataServer(_StreamReader(), bind, sndhwm=32, wire=tier)
    server._pause.set()
    server.start()
    print(json.dumps({'data_endpoint': server.data_endpoint}), flush=True)
    deadline = time.monotonic() + 120
    while server._admission.count() < 1 and time.monotonic() < deadline:
        time.sleep(0.005)
    server._pause.clear()
    sys.stdin.readline()
    print(json.dumps(metrics.get_registry().collect()), flush=True)
    server.stop()


def run_fleet_wire(reps=None, chunk_rows=None, n_chunks=None, bind='tcp://127.0.0.1:*'):
    """The bench's ``fleet_wire`` child (``bench.py:1416-1552``): one
    synthetic stream (``chunk_rows`` x 1024 float32, 16 MB chunks by
    default) drained through ``DataServer`` (a process of its own) ->
    ``RemoteReader`` once a repetition for each tier, pickle, arrow-ipc and
    shm, forced on the server. Per tier the median repetition's chunks/s and
    payload GB/s, the server's ``pst_wire_bytes_total`` by transport (a pass
    that fell back shows it) and its serialize ms a chunk. Acks are flushed
    inline every 4 chunks, as the child does. Returns the record."""
    import gc
    from petastorm_tpu_torch.data_service import RemoteReader
    from petastorm_tpu_torch.fleet import wire as wire_mod
    from petastorm_tpu_torch.native import shm_ring

    chunk_rows = chunk_rows or _env_int('BENCH_WIRE_ROWS', WIRE_ROWS)
    n_chunks = n_chunks or _env_int('BENCH_WIRE_CHUNKS', WIRE_CHUNKS)
    reps = max(1, reps or _env_int('BENCH_WIRE_REPS', WIRE_REPS))
    chunk_bytes = chunk_rows * WIRE_WIDTH * 4 + chunk_rows * 8
    # A ring of 48 chunks: capacity never forces a fallback mid-pass
    # (bench.py:1363-1367), within half of /dev/shm's free bytes.
    free_mb = (shm_ring.shm_free_bytes() or 0) / 2 / (1 << 20)
    ring_mb = max(1.0, min(max(64.0, 48 * chunk_bytes / (1 << 20)), free_mb))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='', PSTT_WIRE_SEGMENT_MB=str(ring_mb))
    env['PYTHONPATH'] = os.pathsep.join(filter(None, [ROOT, env.get('PYTHONPATH')]))
    code = 'import sys; from petastorm_tpu_torch import bench; bench._fleet_wire_server(sys.argv[1:])'

    def run_tier(tier, rep):
        tier_bind = bind if bind.startswith('tcp://') else '{}-{}-{}'.format(bind, tier, rep)
        proc = subprocess.Popen([sys.executable, '-c', code, tier, tier_bind, str(chunk_rows),
                                 str(WIRE_WIDTH), str(n_chunks)], stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE, text=True, env=env, cwd=ROOT)
        server_pids.add(proc.pid)
        try:
            line = proc.stdout.readline()
            if not line:
                raise RuntimeError('the fleet_wire server exited with {}'.format(proc.wait(60)))
            reader = RemoteReader(json.loads(line)['data_endpoint'], rcvhwm=32)
            got = 0
            t0 = t_last = time.perf_counter()
            try:
                for chunk in reader:
                    if chunk.vec.dtype != np.float32 or chunk.vec.shape != (chunk_rows,
                                                                            WIRE_WIDTH):
                        raise AssertionError('chunk {} came back as {} {}'.format(
                            got, chunk.vec.dtype, chunk.vec.shape))
                    got += 1
                    t_last = time.perf_counter()
                    if got == 1:
                        t0 = t_last
                    del chunk
                    if got % 4 == 0:
                        reader._flush_wire_acks()
                grant = next(iter(reader.fleet_metrics()['wire'].values()))
            finally:
                gc.collect()
                reader._flush_wire_acks()
                reader.stop()
                reader.join()
            server_metrics = json.loads(proc.communicate('stop\n', timeout=60)[0].splitlines()[-1])
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if got != n_chunks:
            raise AssertionError('{}: {} of {} chunks'.format(tier, got, n_chunks))
        elapsed = max(t_last - t0, 1e-9)
        by_transport, ser = wire_counters(server_metrics)
        return {'granted': grant, 'chunks': got, 'chunks_per_sec': (got - 1) / elapsed,
                'payload_gb_per_sec': (got - 1) * chunk_bytes / elapsed / 1e9,
                'wire_bytes_by_transport': by_transport,
                'serialize_ms_per_chunk': ser['sum'] / ser['count'] * 1e3 if ser['count']
                else None}

    tiers, server_pids = {}, set()
    for tier in (wire_mod.TRANSPORT_PICKLE, wire_mod.TRANSPORT_ARROW, wire_mod.TRANSPORT_SHM):
        runs = sorted((run_tier(tier, rep) for rep in range(reps)),
                      key=lambda r: r['chunks_per_sec'])
        tiers[tier] = dict(runs[len(runs) // 2],
                           chunks_per_sec_reps=[r['chunks_per_sec'] for r in runs])
    shm_rate = tiers[wire_mod.TRANSPORT_SHM]['chunks_per_sec']
    pickle_rate = tiers[wire_mod.TRANSPORT_PICKLE]['chunks_per_sec']
    return {'chunk_bytes': chunk_bytes, 'chunks_per_epoch': n_chunks, 'repetitions': reps,
            'ring_mb': ring_mb, 'bind': bind.split('://')[0], 'tiers': tiers,
            'shm_over_pickle': shm_rate / pickle_rate if pickle_rate else None,
            'gate_min_ratio': 2.0, 'gate_passed': shm_rate >= 2.0 * pickle_rate,
            'leaked_segments': wire_segments_of(server_pids)}


# --------------------------------------------------------------------------
# the lookup tier: the JAX bench's lookup child and requests on the card
# --------------------------------------------------------------------------

#: The lookup child's store and protocol (``bench.py:1085-1341``): 512 rows
#: of 224x224x3 JPEG q90 with a unique int64 key ``idx``, 64 rows a
#: row-group, the row-level index ``idx_row_ix``; 200 warm reads x 3
#: repetitions; a 2-partition x 2-replica fleet of 300 reads with a drain at
#: read 150. The 10 ms p99 gate is recorded as the JAX child records it.
LOOKUP_ROWS, LOOKUP_ROWS_PER_GROUP = 512, 64
LOOKUP_READS, LOOKUP_REPS, LOOKUP_FLEET_READS = 200, 3, 300
LOOKUP_P99_GATE_MS = 10.0
#: Requests on the card (phase 28 (b)): 64 requests of 32 keys (numpy seed
#: 0), one at a time, one member drained before request 32.
SERVE_REQUESTS, SERVE_KEYS, SERVE_DRAIN_AT = 64, 32, 32


def write_lookup_store(path, rows=None):
    """The lookup child's store (``bench.py:1085-1128``) with the port's
    writer and indexer: ``idx`` (unique), a 224x224x3 JPEG q90 ``image``
    and an int64 ``label``, 64-row groups, seed 13, and ``idx_row_ix``."""
    from petastorm_tpu_torch import (CompressedImageCodec, ScalarCodec, Unischema,
                                     UnischemaField, write_dataset)
    from petastorm_tpu_torch.etl.rowgroup_indexers import SingleFieldRowIndexer
    from petastorm_tpu_torch.etl.rowgroup_indexing import build_rowgroup_index
    schema = Unischema('LookupBenchSchema', [
        UnischemaField('idx', np.int64, (), ScalarCodec(np.int64), False),
        UnischemaField('image', np.uint8, (IMAGE, IMAGE, 3), CompressedImageCodec('jpeg', 90),
                       False),
        UnischemaField('label', np.int64, (), ScalarCodec(np.int64), False),
    ])
    rng = np.random.default_rng(13)
    url = 'file://' + path
    write_dataset(url, schema, ({'idx': i, 'image': synthetic_image(rng, IMAGE),
                                 'label': int(rng.integers(0, 1000))}
                                for i in range(LOOKUP_ROWS if rows is None else rows)),
                  rows_per_row_group=LOOKUP_ROWS_PER_GROUP)
    build_rowgroup_index(url, [SingleFieldRowIndexer('idx_row_ix', 'idx')])
    return url


def ensure_lookup_store(workdir):
    """The lookup store in ``workdir``, written (and indexed) unless it is
    there with its index."""
    from petastorm_tpu_torch.etl.rowgroup_indexing import get_row_group_indexes
    path = os.path.join(workdir, 'lookup')
    if os.path.exists(os.path.join(path, '_common_metadata')):
        try:
            if 'idx_row_ix' in get_row_group_indexes('file://' + path):
                return 'file://' + path
        except Exception:  # noqa: BLE001 - a store without its index is written again
            pass
    shutil.rmtree(path, ignore_errors=True)
    return write_lookup_store(path)


def percentile_ms(samples, frac):
    """Nearest-rank percentile of a list of seconds, in ms (the JAX
    child's ``_percentile_ms``)."""
    ranked = sorted(samples)
    rank = max(0, min(len(ranked) - 1, int(round(frac * len(ranked))) - 1))
    return round(ranked[rank] * 1000.0, 3)


#: The lookup tier's series, as the serving modules register them.
LOOKUP_METRICS = ('pst_lookup_requests_total', 'pst_lookup_latency_seconds',
                  'pst_lookup_cache_hits_total', 'pst_lookup_hedges_total',
                  'pst_partition_map_version', 'pst_partition_reassignments_total',
                  'pst_partition_map_updates_total', 'pst_partition_retries_total',
                  'pst_partition_warm_fill_chunks_total')


def _lookup_metrics():
    """The registry's series of :data:`LOOKUP_METRICS`."""
    from petastorm_tpu_torch import metrics
    return {name: metric for name, metric in metrics.get_registry().collect().items()
            if name in LOOKUP_METRICS}


@contextlib.contextmanager
def lookup_fleet(url, workdir, names, block_cache_entries=8):
    """Two lookup servers over ``url`` on ``ipc://`` sockets in
    ``workdir``, each over a chunk store of its own: the first's filled
    (every piece decoded and flushed) and holding a 2-partition x 2-replica
    map, the second warm-joined from it over the ``chunk`` verb; then a
    ``LookupClient`` on the fleet that has read every piece from every
    replica once (the first read of a warm-filled chunk opens its mmap).
    Yields ``(servers, client, the join's summary)``; stops everything."""
    from petastorm_tpu_torch.serving import LookupClient, LookupEngine, LookupServer

    dirs = [tempfile.mkdtemp(prefix='pstt-lookup-store-', dir=workdir) for _ in names]
    engines, servers = [], []
    try:
        engines = [LookupEngine(url, index_name='idx_row_ix', cache=d,
                                block_cache_entries=block_cache_entries) for d in dirs]
        for piece in range(engines[0].piece_count):
            engines[0].packed_chunk(piece)
        if not engines[0].flush(60.0):
            raise AssertionError('the donor chunk store did not drain its spill')
        servers = [LookupServer(eng, 'ipc://' + os.path.join(workdir, name), lease_s=1.0,
                                server_name=name).start()
                   for eng, name in zip(engines, names)]
        servers[0].init_fleet(n_partitions=2, replication=2)
        join = servers[1].join_fleet(servers[0].rpc_endpoint, warm=True)
        with LookupClient([s.rpc_endpoint for s in servers],
                          control_endpoints=[s.control_endpoint for s in servers],
                          timeout_ms=30000, hedge_after_ms=50) as client:
            client.refresh_partition_map()
            # Each replica's engine, as its server would for a request.
            for engine in engines:
                for key in range(0, LOOKUP_ROWS, LOOKUP_ROWS_PER_GROUP):
                    engine.lookup([key])
            yield servers, client, join
    finally:
        for server in servers:
            server.stop()
        for eng in engines:
            eng.close()
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)


def _lookup_fleet(url, workdir, reads):
    """The fleet leg (``bench.py:1136-1238``) over :func:`lookup_fleet`
    (block LRUs of one block): ``reads`` timed single-key reads with member
    0 drained before read ``reads // 2``. Besides the JAX child's keys,
    ``wrong_idx`` counts rows whose ``idx`` is not their key."""
    rng = np.random.default_rng(1)
    lat, failed, truncated, wrong = [], 0, 0, 0
    drain_at, version_after_drain = reads // 2, None
    with lookup_fleet(url, workdir, ('bench-a', 'bench-b'), block_cache_entries=1) \
            as (servers, client, join):
        for i in range(reads):
            if i == drain_at:
                servers[0].drain()
                version_after_drain = servers[1].partition_map.version
            key = int(rng.integers(0, LOOKUP_ROWS))
            t0 = time.perf_counter()
            try:
                rows = client.lookup([key])[0]
            except Exception:  # noqa: BLE001 - counted; the gate fails
                failed += 1
                continue
            lat.append(time.perf_counter() - t0)
            if not rows or int(rows[0]['idx']) != key:
                truncated += 1
                wrong += bool(rows)
        scatter = client.scatter_stats()
        # A short storm can end inside one heartbeat: converge now.
        client.refresh_partition_map()
        client_version = client.partition_map.version if client.partition_map else None
    p99 = percentile_ms(lat, 0.99) if lat else None
    return {'n_partitions': 2, 'replication': 2, 'reads': reads,
            'drained_member_at_read': drain_at,
            'warm_p50_ms': percentile_ms(lat, 0.50) if lat else None, 'warm_p99_ms': p99,
            'failed_lookups': failed, 'truncated_lookups': truncated, 'wrong_idx': wrong,
            'warm_join': {k: join[k] for k in ('warmed_chunks', 'warm_skipped', 'warm_failed')},
            'map_version_after_join': 2, 'map_version_after_drain': version_after_drain,
            'client_map_version': client_version, 'scatter': scatter,
            'p99_gate_ms': LOOKUP_P99_GATE_MS,
            'p99_gate_passed': (p99 is not None and p99 < LOOKUP_P99_GATE_MS
                                and failed == 0 and truncated == 0)}


def run_lookup(url, workdir, reads=LOOKUP_READS, reps=LOOKUP_REPS,
               fleet_reads=LOOKUP_FLEET_READS):
    """The JAX bench's lookup child (``bench.py:1241-1341``) on the port:
    cold and warm point reads through ``LookupServer`` + ``LookupClient``
    (``ipc://`` sockets in ``workdir``) over a chunk-store hot tier whose
    block LRU holds one block, so warm reads are chunk-store hits; the
    median of ``reps`` repetitions of ``reads`` warm reads; then the fleet
    leg (:func:`_lookup_fleet`). The probe flock stays out (ROADMAP §A).
    Returns the child's ``lookup_stage_profile``; ``wrong_idx`` counts rows
    whose ``idx`` is not their key, in both legs."""
    import statistics

    from petastorm_tpu_torch.serving import LookupClient, LookupEngine, LookupServer

    os.makedirs(workdir, exist_ok=True)
    rng = np.random.default_rng(0)
    store_dir = tempfile.mkdtemp(prefix='pstt-lookup-store-', dir=workdir)
    wrong = 0
    try:
        load_before = os.getloadavg()
        with LookupEngine(url, index_name='idx_row_ix', cache=store_dir,
                          block_cache_entries=1) as engine:
            with LookupServer(engine, 'ipc://' + os.path.join(workdir, 'lookup-rpc')).start() \
                    as server:
                with LookupClient([server.rpc_endpoint], timeout_ms=30000) as client:
                    cold = []
                    for key in range(0, LOOKUP_ROWS, LOOKUP_ROWS_PER_GROUP):
                        t0 = time.perf_counter()
                        rows = client.lookup([key])[0]
                        cold.append(time.perf_counter() - t0)
                        wrong += not rows or int(rows[0]['idx']) != key
                    if not engine.flush(60.0):
                        raise AssertionError('the chunk store did not drain its spill')
                    warm_rates, warm_p50s, warm_p99s = [], [], []
                    for _ in range(reps):
                        warm = []
                        for key in rng.integers(0, LOOKUP_ROWS, reads):
                            t0 = time.perf_counter()
                            rows = client.lookup([int(key)])[0]
                            warm.append(time.perf_counter() - t0)
                            wrong += not rows or int(rows[0]['idx']) != int(key)
                        warm_p50s.append(percentile_ms(warm, 0.50))
                        warm_p99s.append(percentile_ms(warm, 0.99))
                        warm_rates.append(reads / sum(warm))
                    stats = engine.stats()
                    served = server.requests_served
        fleet = _lookup_fleet(url, workdir, fleet_reads)
        load_after = os.getloadavg()
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
    tiers = stats['tiers']
    store_stats = stats.get('store') or {}
    total = sum(tiers.values()) or 1
    hot = sum(n for tier, n in tiers.items() if tier != 'decode')
    warm_p99 = statistics.median(warm_p99s)
    return {'warm_p50_ms': statistics.median(warm_p50s), 'warm_p99_ms': warm_p99,
            'warm_p99_ms_reps': warm_p99s,
            'warm_reads_per_sec': round(statistics.median(warm_rates), 1),
            'cold_p50_ms': percentile_ms(cold, 0.50), 'cold_p99_ms': percentile_ms(cold, 0.99),
            'cold_reads': len(cold), 'hit_rate': round(hot / total, 4), 'tiers': tiers,
            'store': {k: store_stats.get(k) for k in ('hits', 'misses', 'writes',
                                                      'bytes_mapped')},
            'requests_served': served, 'reads_per_rep': reads, 'repetitions': reps,
            'p99_gate_ms': LOOKUP_P99_GATE_MS, 'p99_gate_passed': warm_p99 < LOOKUP_P99_GATE_MS,
            'wrong_idx': wrong, 'fleet': fleet,
            'load': {'loadavg_before': list(load_before), 'loadavg_after': list(load_after)},
            'metrics': _lookup_metrics()}


def _independent_images(url, keys):
    """The stored JPEG bytes of ``keys`` decoded without port code (pyarrow
    + OpenCV), in the keys' order."""
    import cv2
    idx = read_store_column(url, 'idx').to_pylist()
    blobs = read_store_column(url, 'image')
    at = {key: i for i, key in enumerate(idx)}
    return np.stack([cv2.cvtColor(cv2.imdecode(np.frombuffer(blobs[at[int(k)]].as_py(), np.uint8),
                                               cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
                     for k in keys])


def _bf16_ulps(got, want):
    """Largest |got - want| in units of ``want``'s bf16 ulp (floor 1e-6)."""
    import torch
    want = want.float()
    _, exponent = torch.frexp(want)
    ulp = torch.clamp(torch.ldexp(torch.ones_like(want), exponent - 8), min=1e-6)
    return float(((got.float() - want).abs() / ulp).max())


def run_lookup_serve(url, device, card, state, workdir, requests=SERVE_REQUESTS,
                     keys_per_request=SERVE_KEYS, drain_at=SERVE_DRAIN_AT):
    """Requests answered on the card: a 2-server lookup fleet (2 partitions
    x 2 replicas over ``ipc://`` sockets in ``workdir``, the donor's chunk
    store warmed, the joiner's warm-filled) and one ``LookupClient``;
    ``requests`` requests of ``keys_per_request`` keys (numpy seed 0), one
    at a time, member 0 drained before request ``drain_at``. Each request:
    ``client.lookup(keys)`` -> a pinned uint8 ``[keys, 224, 224, 3]`` ->
    ``non_blocking`` copy -> K1 ``normalize_images`` (bf16) -> ``state``'s
    ResNet-50 forward in eval mode -> top-1 ids to the host. Lookup ms on
    the host clock; card ms by CUDA events around the copy, K1 and the
    forward. Checks (``failures``): every row's ``idx`` is its key; no
    request failed or came back short; K1 launched once a request; the
    client's map version is the drain's; the first request's images equal
    an independent decode of the stored bytes (exact under OpenCV, within 2
    levels under the native codec); its K1 output is within 1 bf16 ulp of
    ``normalize_images_plain``'s; and its batch through K1 and through
    ``normalize_images_plain``, both f32, gives logits within rtol=atol=1e-3
    (phase 3's ResNet-50 tolerance, TF32 off). Raises without a GPU unless
    ``device`` is the CPU. Returns the phase's line."""
    import torch
    from petastorm_tpu_torch.codecs import decoder_info
    from petastorm_tpu_torch.device import resolve_device
    from petastorm_tpu_torch.ops import image_ops

    device = resolve_device(device)
    cuda = device.type == 'cuda'
    t_phase = time.perf_counter()
    os.makedirs(workdir, exist_ok=True)
    key_sets = np.random.default_rng(0).integers(0, LOOKUP_ROWS, (requests, keys_per_request))
    model = state.model
    was_training = model.training
    lookup_s, request_s, card_ms, events = [], [], [], []
    failed, truncated, wrong, errors = 0, 0, 0, []
    first = None
    try:
        with lookup_fleet(url, workdir, ('serve-0', 'serve-1')) as (servers, client, join):
            model.eval()
            pinned = torch.empty((keys_per_request, IMAGE, IMAGE, 3), dtype=torch.uint8,
                                 pin_memory=cuda)
            host = pinned.numpy()
            with torch.no_grad():            # cudnn picks its eval algorithms here
                model(image_ops.normalize_images(pinned.to(device), dtype=torch.bfloat16))
            if cuda:
                torch.cuda.synchronize()
            reset_launch_counts()            # the path starts here
            version_after_drain = None
            t_loop = time.perf_counter()
            for i, keys in enumerate(key_sets):
                if i == drain_at:
                    servers[0].drain()
                    version_after_drain = servers[1].partition_map.version
                keys = [int(k) for k in keys]
                t0 = time.perf_counter()
                try:
                    rows = client.lookup(keys)
                except Exception as e:  # noqa: BLE001 - counted; the phase fails
                    failed += 1
                    errors.append(repr(e))
                    continue
                short = [key for key, matches in zip(keys, rows) if len(matches) != 1]
                bad = [key for key, matches in zip(keys, rows)
                       if len(matches) == 1 and int(matches[0]['idx']) != key]
                truncated += bool(short)
                wrong += len(bad)
                if short or bad:
                    continue
                for j, matches in enumerate(rows):
                    host[j] = matches[0]['image']
                t1 = time.perf_counter()
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if cuda else None
                if cuda:
                    ev[0].record()
                x = pinned.to(device, non_blocking=True)
                xn = image_ops.normalize_images(x, dtype=torch.bfloat16)
                with torch.no_grad():
                    logits = model(xn)
                if cuda:
                    ev[1].record()
                top1 = logits.argmax(-1).cpu()
                t2 = time.perf_counter()
                lookup_s.append(t1 - t0)
                request_s.append(t2 - t0)
                if cuda:
                    events.append(ev)
                else:
                    card_ms.append((t2 - t1) * 1e3)
                if first is None:
                    first = {'keys': keys, 'images': host.copy(), 'k1_bf16': xn.clone(),
                             'top1': top1.tolist()}
            wall = time.perf_counter() - t_loop
            launches = launch_counts()       # the path ends here
            scatter = client.scatter_stats()
            client.refresh_partition_map()
            client_version = client.partition_map.version if client.partition_map else None
        if cuda:
            torch.cuda.synchronize()
            card_ms = [a.elapsed_time(b) for a, b in events]
        checks = {}
        if first is not None:
            decoder = decoder_info()['decoder']
            want = _independent_images(url, first['keys'])
            diff = int(np.abs(first['images'].astype(np.int16) - want.astype(np.int16)).max())
            x = torch.from_numpy(first['images']).to(device)
            scale, shift = image_ops._scale_shift(image_ops.IMAGENET_MEAN, image_ops.IMAGENET_STD,
                                                  device)
            plain_bf16 = image_ops.normalize_images_plain(x, scale, shift, dtype=torch.bfloat16)
            tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
            dtype, model.dtype = model.dtype, torch.float32
            try:
                with torch.no_grad():
                    via_k1 = model(image_ops.normalize_images(x, dtype=torch.float32)).cpu()
                    via_plain = model(image_ops.normalize_images_plain(
                        x, scale, shift, dtype=torch.float32)).cpu()
            finally:
                model.dtype = dtype
                torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
            checks = {'decoder': decoder, 'images_max_abs_diff_vs_opencv': diff,
                      'images_atol': 0 if decoder == 'cv2' else 2,
                      'k1_bf16_max_ulps_vs_plain': _bf16_ulps(first['k1_bf16'], plain_bf16),
                      'logits_f32_max_abs_err': float((via_k1 - via_plain).abs().max()),
                      'logits_f32_close': bool(torch.isfinite(via_k1).all() and torch.allclose(
                          via_k1, via_plain, rtol=1e-3, atol=1e-3)),
                      'logits_tolerance': 'rtol=atol=1e-3 (f32, TF32 off)'}
    finally:
        model.train(was_training)
    served = len(request_s)
    k1 = launches.get('normalize_images', 0)
    failures = []
    if failed or truncated or wrong:
        failures.append('{} failed, {} short and {} rows of another key: {}'.format(
            failed, truncated, wrong, errors[:3]))
    # On the CPU the plain normalize runs and nothing launches.
    if k1 != (requests if cuda else 0) or served != requests:
        failures.append('K1 launched {} times for {} requests ({} served)'.format(
            k1, requests, served))
    if client_version != version_after_drain:
        failures.append('the client holds map v{}, the drain made v{}'.format(
            client_version, version_after_drain))
    if first is None:
        failures.append('no request was answered')
    else:
        if checks['images_max_abs_diff_vs_opencv'] > checks['images_atol']:
            failures.append('the first images differ from an independent decode by {}'.format(
                checks['images_max_abs_diff_vs_opencv']))
        if checks['k1_bf16_max_ulps_vs_plain'] > 1:
            failures.append('K1 differs from the plain normalize by {} bf16 ulps'.format(
                checks['k1_bf16_max_ulps_vs_plain']))
        if not checks['logits_f32_close']:
            failures.append('logits through K1 and the plain normalize differ by {}'.format(
                checks['logits_f32_max_abs_err']))
    return {'phase': 'lookup', 'variant': 'serve', 'card': card, 'model': 'resnet50',
            'mode': 'eval', 'requests': requests, 'keys_per_request': keys_per_request,
            'served': served, 'drained_member_at_request': drain_at,
            'request_p50_ms': percentile_ms(request_s, 0.50) if request_s else None,
            'request_p99_ms': percentile_ms(request_s, 0.99) if request_s else None,
            'lookup_p50_ms': percentile_ms(lookup_s, 0.50) if lookup_s else None,
            'lookup_p99_ms': percentile_ms(lookup_s, 0.99) if lookup_s else None,
            'card_p50_ms': float(np.percentile(card_ms, 50)) if card_ms else None,
            'card_p99_ms': float(np.percentile(card_ms, 99)) if card_ms else None,
            'img_per_s': served * keys_per_request / wall if served else 0.0,
            'failed': failed, 'truncated': truncated, 'wrong_idx': wrong,
            'warm_join': {k: join[k] for k in ('warmed_chunks', 'warm_skipped', 'warm_failed')},
            'map_version_after_drain': version_after_drain, 'client_map_version': client_version,
            'scatter': scatter, 'k1_launches': k1, 'launches': launches,
            'first_request': dict(checks, top1=first['top1'][:8]) if first else None,
            'failures': failures, 'seconds': time.perf_counter() - t_phase}


# --------------------------------------------------------------------------
# the preprocessing fleet under scan training
# --------------------------------------------------------------------------

#: Phase 29: the job, the spawns' lease (worker 0, worker 1 and the
#: reference keep the default 10 s: under 8 decode threads a 0.5 s lease
#: expires the trainer's admission and frees its shm regions under it), the
#: spawns' grace to their first heartbeat, and the scan calls after the
#: dance before worker 0 drains.
FLEET_JOB, FLEET_LEASE_S, FLEET_SPAWN_GRACE_S, FLEET_TAIL_CALLS = 'pstt-bench', 0.5, 1.5, 3
#: The trainer gives up on a dance that runs longer than this.
FLEET_DANCE_LIMIT_S = 150.0


def fleet_worker_argv(url, bind, workers=1, job=None, quotas=None, det=False, epochs=0,
                      lease_s=None, drain_grace=0.5, await_cursor=False):
    """``python -m petastorm_tpu_torch.tools.fleet --worker`` over ``url``
    (``lease_s`` None: the CLI's default lease)."""
    argv = [sys.executable, '-m', 'petastorm_tpu_torch.tools.fleet', '--worker', url, '--bind',
            bind, '--workers', str(workers), '--epochs', str(epochs), '--drain-grace',
            str(drain_grace)]
    if lease_s is not None:
        argv += ['--lease-s', str(lease_s)]
    if job is not None:
        argv += ['--job', job]
    if quotas is not None:
        argv += ['--tenant-quotas', json.dumps(quotas)]
    if det:
        argv += ['--deterministic', '--seed', '0']
    if await_cursor:
        argv.append('--await-cursor')
    return argv


def fleet_worker_env(faults_spec=None, ring_bytes=None):
    """A fleet worker's environment: no card, the repository on the path,
    ``PSTT_FAULTS`` only as given, the wire ring sized when asked."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    env['PYTHONPATH'] = os.pathsep.join(filter(None, [ROOT, env.get('PYTHONPATH')]))
    env.pop('PSTT_FAULTS', None)
    if faults_spec:
        env['PSTT_FAULTS'] = faults_spec
    if ring_bytes:
        env['PSTT_WIRE_SEGMENT_MB'] = str(ring_bytes / (1 << 20))
    return env


def start_fleet_worker(argv, env, timeout_s=120):
    """A fleet worker process and its announce line (its stdout stays a
    pipe: the final line comes at exit)."""
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE, text=True, env=env, cwd=ROOT)
    line = proc.stdout.readline()
    if not line:
        proc.wait(timeout_s)
        raise RuntimeError('the fleet worker exited with {} before its announce line'.format(
            proc.returncode))
    return proc, json.loads(line)


def finish_fleet_worker(proc, timeout_s=60, delivered=False):
    """Wait for a worker that was asked to drain: (exit code, final line).
    ``delivered``: its consumer already took the stream's END, so a second
    SIGTERM ends the drain grace the worker would otherwise wait out."""
    if delivered and proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        out, _ = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
    lines = [json.loads(line) for line in (out or '').splitlines() if line.startswith('{')]
    return proc.returncode, (lines[-1] if lines else None)


def run_cli(main, argv):
    """A command line's ``main(argv)`` in this process, its standard output
    captured (no interpreter to start): (exit code, the output's text)."""
    import contextlib
    import io
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return rc or 0, out.getvalue()


def fleet_status(rpc_endpoints, timeout_s=10.0):
    """``python -m petastorm_tpu_torch.tools.fleet --status`` (through
    :func:`run_cli`): (exit code, its JSON line)."""
    from petastorm_tpu_torch.tools import fleet as fleet_cli
    rc, text = run_cli(fleet_cli.main, ['--status', '--rpc'] + list(rpc_endpoints)
                       + ['--timeout-s', str(timeout_s)])
    lines = [line for line in text.splitlines() if line.startswith('{')]
    return rc, (json.loads(lines[-1]) if lines else None)


def tenant_refusals(status):
    """``pst_fleet_tenant_refusals_total`` by tenant out of a status line."""
    metric = ((status or {}).get('tenant_slo') or {}).get('pst_fleet_tenant_refusals_total') or {}
    out = {}
    for sample in metric.get('samples', ()):
        tenant = sample['labels'].get('tenant')
        out[tenant] = out.get(tenant, 0) + sample['value']
    return out


def _fleet_dance(scaler, registry, launcher, job, log):
    """The dance of ``tests/test_fleet_preproc.py:645``, actions forced as
    there: 1 -> 3 (one spawn SIGKILLed by ``fleet-worker-kill``, reaped and
    retried), a drain-first scale-down under ``registry-blackhole`` (the
    registry's alone), membership back to 2, then a drain back to 1.
    Fills ``log``."""
    from petastorm_tpu_torch.faults import FaultInjector

    t0 = time.perf_counter()
    joined = log.setdefault('joined', {})
    deadline = time.monotonic() + 120
    while True:
        for member in registry.members(job):
            joined.setdefault(member['key'], member['joined'])
        # A spawn killed after its first beat counts until it ages out.
        count, live = registry.worker_count(job), scaler.live_workers()
        if count == 3 and live == 2:
            break
        if time.monotonic() > deadline:
            raise AssertionError('the fleet never reached 3 live workers ({}, {} '
                                 'launched alive)'.format(count, live))
        if count < 3:
            scaler.scale_to(3)
        else:
            time.sleep(0.1)
    log['scale_up_s'] = time.perf_counter() - t0
    t1 = time.perf_counter()
    registry.fault_injector = FaultInjector.from_string('registry-blackhole')
    try:
        # Forced, as the drill forces it: scale_to would relaunch the
        # members the blind registry ages out.
        log['blackholed_down'] = scaler._act('down', registry.worker_count(job))
    finally:
        registry.fault_injector = None
    log['blackholed_drain_s'] = time.perf_counter() - t1
    deadline = time.monotonic() + 60
    while registry.worker_count(job) != 2:
        if time.monotonic() > deadline:
            raise AssertionError('membership never came back to 2 after the blackhole')
        time.sleep(0.05)
    log['reconverged_s'] = time.perf_counter() - t1
    t2 = time.perf_counter()
    scaler.drain_all()
    log['drain_all_s'] = time.perf_counter() - t2
    deadline = time.monotonic() + 60
    while registry.worker_count(job) != 1:
        if time.monotonic() > deadline:
            raise AssertionError('the fleet never shrank back to 1')
        time.sleep(0.05)
    log['members_after'] = [m['key'] for m in registry.members(job)]
    log['seconds'] = time.perf_counter() - t0


def run_fleet_scale(url, device, card, state, workdir, remote_rate=None, workers=8):
    """ResNet-50 scan training fed by an autoscaled two-tenant fleet (the
    drill of ``tests/test_fleet_preproc.py:645`` with the card as the
    deterministic tenant's consumer), over ``ipc://`` sockets in
    ``workdir``.

    Worker 0 is ``tools.fleet --worker`` over ``url`` (job ``pstt-bench``,
    tenant quotas ``{"det": {}}``, deterministic, seed 0, ``workers``
    threads, no card, endless); worker 1 the same for tenant ``noisy`` with
    ``max_consumers`` 1, one epoch. The trainer is ``RemoteReader(worker 0,
    tenant='det', flow_control=32)`` -> ``TorchLoader`` with a lineage
    ledger -> ``superbatches(8)`` -> imagenet_scan's 8-step graph on
    ``state``. After the trainer's first replay a thread runs the dance
    (:func:`_fleet_dance`: a ``FleetRegistry`` and a ``FleetAutoscaler``
    with a ``SubprocessLauncher`` of one-thread workers); ``FLEET_TAIL_CALLS``
    calls after it ends, worker 0 is drained (SIGTERM) and the trainer
    takes the stream to its END. Then the noisy tenant's one consumer takes
    worker 1's whole epoch and a second is refused, and a reference run (a
    fresh worker 0, a loader on the card with no model step) takes as many
    batches of the same stream into its own ledger.

    ``failures``: the dance not inside the training; det's served chunks
    not its delivered ones, or noisy's not its epoch; the ledgers diverging
    (``tools.replay --diff-ledgers`` not 0); det refused; no kill, or a
    drain not acknowledged; ``tools.fleet --status`` not 0; a
    ``pstt-wire-`` segment left; a worker mapping ``libcuda``; K1's graph
    nodes times the replays not exact. Raises without a GPU unless
    ``device`` is the CPU. Returns the phase's line."""
    import threading

    import torch
    from petastorm_tpu_torch import TorchLoader
    from petastorm_tpu_torch.data_service import RemoteReader
    from petastorm_tpu_torch.device import resolve_device
    from petastorm_tpu_torch.errors import ServerOverloaded
    from petastorm_tpu_torch.fleet.autoscaler import (FleetAutoscaler, ScalePolicy,
                                                      SubprocessLauncher)
    from petastorm_tpu_torch.fleet.registry import FleetRegistry
    from petastorm_tpu_torch.models import make_scan_train_step

    device = resolve_device(device)
    t_phase = time.perf_counter()
    os.makedirs(workdir, exist_ok=True)
    ring = remote_ring_bytes(imagenet_chunk_bytes()) if device.type == 'cuda' else None
    sock = lambda name: 'ipc://' + os.path.join(workdir, name)  # noqa: E731
    det_argv = fleet_worker_argv(url, sock('w0'), workers, job=FLEET_JOB, quotas={'det': {}},
                                 det=True, drain_grace=5.0, await_cursor=True)
    out = {'phase': 'fleet_scale', 'card': card, 'model': 'resnet50', 'stem': 'conv7',
           'classes': 1000, 'job': FLEET_JOB, 'workers': workers,
           'spawn_lease_s': FLEET_LEASE_S,
           'spawn_grace_s': FLEET_SPAWN_GRACE_S, 'credits': REMOTE_CREDITS, 'ring_bytes': ring}
    failures = []
    procs, spawned = {}, []
    status_rc = status = None
    maps = {}           # pid -> whether the live worker maps libcuda
    kill_token = os.path.join(workdir, 'kill-one-spawn.token')
    registry = FleetRegistry()

    class Launcher(SubprocessLauncher):
        """Points the registry at each spawn and books its pid, its
        launch time, whether it maps the CUDA driver, and acknowledged
        drains."""
        drained_ok = []

        def launch(self, index):
            t0 = time.monotonic()
            handle = super(Launcher, self).launch(index)
            pid = handle['proc'].pid
            maps[pid] = maps_cuda_driver(pid)
            spawned.append({'index': index, 'key': handle['key'], 'pid': pid, 'launched': t0})
            registry.watch([handle['info']['control_endpoint']])
            return handle

        def drain(self, handle, timeout_s):
            ok = super(Launcher, self).drain(handle, timeout_s)
            if ok:
                self.drained_ok.append(handle['key'])
            return ok

    launcher = Launcher(lambda index: fleet_worker_argv(url, sock('s{}'.format(index)), 1,
                                                        job=FLEET_JOB, lease_s=FLEET_LEASE_S),
                        announce_timeout_s=60.0,
                        env=fleet_worker_env('fleet-worker-kill:token={}'.format(kill_token)))
    scaler = FleetAutoscaler(FLEET_JOB, registry, launcher, metrics_fn=None,
                             policy=ScalePolicy(min_workers=1, max_workers=3,
                                                spawn_grace_s=FLEET_SPAWN_GRACE_S,
                                                drain_timeout_s=60.0))
    dance, dance_error = {}, []
    dance_thread = threading.Thread(
        target=lambda: _run_into(dance_error, _fleet_dance, scaler, registry, launcher,
                                 FLEET_JOB, dance), name='pstt-bench-fleet-dance', daemon=True)
    train = make_scan_train_step(SCAN_K, preprocess=normalize_bf16)
    try:
        procs['w0'], w0 = start_fleet_worker(det_argv, fleet_worker_env(ring_bytes=ring))
        procs['w1'], w1 = start_fleet_worker(
            fleet_worker_argv(url, sock('w1'), workers, quotas={'noisy': {'max_consumers': 1}},
                              epochs=1, drain_grace=60.0), fleet_worker_env())
        out['worker_pids'] = {name: proc.pid for name, proc in procs.items()}
        registry.watch([w0['control_endpoint']])
        if not registry.wait_for_member(FLEET_JOB, min_count=1, timeout_s=30.0):
            raise AssertionError('worker 0 never reached the registry')
        # -- the trainer, with the dance between its first replay and its last
        ledger = os.path.join(workdir, 'ledger-fleet')
        metrics, calls_at, captured = [], [], {}
        reset_launch_counts()
        replays0 = train.replays
        drain_sent = None
        reader = RemoteReader(w0['data_endpoint'], rcvhwm=REMOTE_RCVHWM,
                              flow_control=REMOTE_CREDITS, tenant='det', end_grace_s=30.0)
        with reader:
            with TorchLoader(reader, BATCH, device=device, prefetch=SCAN_PREFETCH,
                             autotune=False, lineage=ledger) as loader:
                groups = loader.superbatches(SCAN_K)
                tail = None
                while True:
                    try:
                        sb = next(groups)
                    except StopIteration:
                        break
                    capturing, before = train.graph is None and train.calls == 1, launch_counts()
                    metrics.append(train(state, sb.image, sb.label))
                    if capturing:
                        captured.update(_launch_diff(launch_counts(), before))
                    calls_at.append((time.perf_counter(), train.replays - replays0))
                    if 'start' not in out and train.replays - replays0 >= 1:
                        out['start'] = {'call': len(metrics), 'replays': train.replays - replays0}
                        dance['t_start'] = time.perf_counter()
                        dance_thread.start()
                    elif 'end' not in out and 'start' in out \
                            and time.perf_counter() - dance['t_start'] > FLEET_DANCE_LIMIT_S:
                        raise AssertionError('the dance took over {} s: {}'.format(
                            FLEET_DANCE_LIMIT_S, dance))
                    if 'start' in out and not dance_thread.is_alive() and tail is None:
                        tail = len(metrics)
                        out['end'] = {'call': len(metrics), 'replays': train.replays - replays0}
                        dance['t_end'] = time.perf_counter()
                    if tail is not None and drain_sent is None \
                            and len(metrics) >= tail + FLEET_TAIL_CALLS:
                        status_rc, status = fleet_status([w0['rpc_endpoint'], w1['rpc_endpoint']])
                        maps.update({proc.pid: maps_cuda_driver(proc.pid)
                                     for proc in procs.values()})
                        procs['w0'].send_signal(signal.SIGTERM)
                        drain_sent = time.perf_counter()
                stream_end = time.perf_counter()
                if device.type == 'cuda':
                    torch.cuda.synchronize()
                lineage_stats = loader.stats.get('lineage') or {}
                loader_rows = loader.stats['rows']
            diagnostics = reader.diagnostics
        launches = launch_counts()
        replays = train.replays - replays0
        ran = graph_launches(train, ('normalize_kernel',), replays)
        w0_rc, w0_final = finish_fleet_worker(procs.pop('w0'), delivered=drain_sent is not None)
        # The reference's worker starts now, reading nothing before its
        # consumer attaches (``--await-cursor``), and runs after the noisy
        # tenant's epoch.
        ref_ledger = os.path.join(workdir, 'ledger-ref')
        batches = int(lineage_stats.get('records') or 0)
        ref_argv = fleet_worker_argv(url, sock('ref'), workers, quotas={'det': {}}, det=True,
                                     drain_grace=5.0, await_cursor=True)
        procs['ref'], ref = start_fleet_worker(ref_argv, fleet_worker_env(ring_bytes=ring))
        # -- the noisy tenant: one consumer takes the epoch, a second is refused
        with RemoteReader(w1['data_endpoint'], tenant='noisy') as noisy:
            noisy_rows = sum(int(np.asarray(chunk.label).shape[0]) for chunk in noisy)
            refused = RemoteReader(w1['data_endpoint'], tenant='noisy')
            noisy_refusal = None
            try:
                deadline = time.monotonic() + 30
                while time.monotonic() < deadline:
                    next(refused)
            except ServerOverloaded as e:
                noisy_refusal = e.reason
            except StopIteration:
                pass
            finally:
                refused.join()
            status_end_rc, status_end = fleet_status([w1['rpc_endpoint']])
        w1_served = ((status_end or {}).get('members') or {}).get(w1['rpc_endpoint'], {}).get(
            'sent')
        stop_server(procs.pop('w1'))
        # -- the reference: the same stream, no scaling, a loader with no model step
        ref_pid = procs['ref'].pid
        maps[ref_pid] = maps_cuda_driver(ref_pid)
        t_ref = time.perf_counter()
        with RemoteReader(ref['data_endpoint'], rcvhwm=REMOTE_RCVHWM,
                          flow_control=REMOTE_CREDITS, tenant='det', end_grace_s=30.0) as remote:
            with TorchLoader(remote, BATCH, device=device, prefetch=SCAN_PREFETCH,
                             autotune=False, lineage=ref_ledger) as loader:
                for _ in range(batches):
                    next(loader)
            ref_granted = remote.diagnostics['wire']
        ref_s = time.perf_counter() - t_ref
        stop_server(procs.pop('ref'))
        from petastorm_tpu_torch.tools import replay as replay_cli
        diff_rc, diff_out = run_cli(replay_cli.main, ['--diff-ledgers', ref_ledger, ledger])
    finally:
        if dance_thread.ident is not None:
            dance_thread.join(timeout=180)
        scaler.stop()
        scaler.drain_all()
        registry.stop()
        for proc in procs.values():
            stop_server(proc)
    left = wire_segments_of(set(maps) | set(out.get('worker_pids', {}).values()))
    # -- the record and its checks
    t_start, t_end = dance.get('t_start'), dance.get('t_end')
    during = [i for i, (t, _) in enumerate(calls_at) if t_start is not None and t_end is not None
              and t_start <= t <= t_end]
    dance_rows = len(during) * SCAN_K * BATCH
    img_per_s = dance_rows / (t_end - t_start) if during and t_end > t_start else None
    joins = dance.get('joined', {})
    det_served = (w0_final or {}).get('served_chunks')
    refusals_mid = tenant_refusals(status)
    refusals_end = tenant_refusals(status_end)
    down = dance.get('blackholed_down') or {}
    out.update({
        'calls': len(metrics), 'replays': replays, 'dance': {
            k: v for k, v in dance.items() if k not in ('t_start', 't_end')},
        'dance_error': dance_error[:1],
        'img_per_s_during_dance': img_per_s, 'dance_calls': len(during),
        'imagenet_remote_img_per_s': remote_rate,
        'img_per_s_vs_imagenet_remote': img_per_s / remote_rate if img_per_s and remote_rate
        else None,
        'spawns': [{'index': s['index'], 'key': s['key'], 'pid': s['pid'],
                    'joined_after_s': (joins[s['key']] - s['launched'])
                    if s['key'] in joins else None} for s in spawned],
        'kill_fired': os.path.exists(kill_token),
        'drains_acknowledged': list(Launcher.drained_ok),
        'det': {'served_chunks': det_served, 'delivered_chunks': diagnostics['remote_chunks'],
                'duplicate_chunks': diagnostics['duplicate_chunks'], 'loader_rows': loader_rows,
                'granted': diagnostics['wire'], 'ledger_batches': batches,
                'worker_exit': w0_rc, 'drain_to_end_s': (stream_end - drain_sent)
                if drain_sent else None},
        'noisy': {'rows': noisy_rows, 'served_chunks': w1_served,
                  'second_consumer_refused': noisy_refusal},
        'refusals': {'mid': refusals_mid, 'end': refusals_end},
        'status_rc': [status_rc, status_end_rc],
        'reference': {'seconds': ref_s, 'img_per_s': batches * BATCH / ref_s,
                      'granted': ref_granted},
        'diff_ledgers_rc': diff_rc, 'diff_ledgers': diff_out.strip()[-2000:],
        'segments_left': left,
        'workers_map_cuda': {str(pid): mapped for pid, mapped in maps.items()},
        'k1_graph': {'ran': ran['normalize_kernel'], 'expected': SCAN_K * replays,
                     'replays': replays},
        'launches': _scan_launches(launches, captured, ran, len(metrics), replays),
        'losses_mean_last': [[float(m['loss']), float(m['last_loss'])] for m in metrics[-3:]]})
    if dance_error or 'start' not in out or 'end' not in out \
            or out['end']['replays'] >= replays:
        failures.append('the dance did not run inside the training: start {}, end {}, {} '
                        'replays, {}'.format(out.get('start'), out.get('end'), replays,
                                             dance_error[:1]))
    if det_served is None or det_served != diagnostics['remote_chunks'] \
            or loader_rows > diagnostics['remote_chunks'] * ROWS_PER_GROUP:
        failures.append('det: served {} chunks, delivered {} ({} loader rows)'.format(
            det_served, diagnostics['remote_chunks'], loader_rows))
    if noisy_rows != ROWS or w1_served != ROWS // ROWS_PER_GROUP:
        failures.append('noisy: {} rows delivered, {} chunks served'.format(noisy_rows,
                                                                          w1_served))
    if noisy_refusal != 'overloaded' or refusals_end.get('noisy', 0) < 1:
        failures.append('the second noisy consumer was not refused: {} {}'.format(
            noisy_refusal, refusals_end))
    if refusals_mid.get('det', 0) or refusals_end.get('det', 0):
        failures.append('det was refused: {} {}'.format(refusals_mid, refusals_end))
    if diff_rc != 0 or not batches:
        failures.append('the ledgers diverge (rc {}, {} batches): {}'.format(
            diff_rc, batches, diff_out.strip()[-400:]))
    if not out['kill_fired'] or len(Launcher.drained_ok) != 2 or not down.get('ok'):
        failures.append('kill {}, drains acknowledged {}, blackholed drain {}'.format(
            out['kill_fired'], Launcher.drained_ok, down))
    if status_rc != 0 or status_end_rc != 0:
        failures.append('tools.fleet --status exited {} and {}'.format(status_rc, status_end_rc))
    if left:
        failures.append('segments left: {}'.format(left))
    # Read while each lived; a spawn that killed itself may be gone (None).
    if any(maps.values()) or any(maps.get(pid) is not False for pid in
                                 list(out.get('worker_pids', {}).values()) + [ref_pid]):
        failures.append('a fleet worker maps libcuda: {}'.format(out['workers_map_cuda']))
    try:
        require_scan_launches(launches, captured, ran, ('normalize_images',), SCAN_K, replays)
    except AssertionError as e:
        failures.append(str(e))
    if not all(math.isfinite(v) for m in metrics for v in (float(m['loss']),
                                                           float(m['last_loss']))):
        failures.append('a non-finite loss')
    out.update(failures=failures, seconds=time.perf_counter() - t_phase)
    return out


def _run_into(errors, fn, *args):
    """``fn(*args)`` on a thread: its exception into ``errors``."""
    try:
        fn(*args)
    except Exception as e:  # noqa: BLE001 - the caller's checks report it
        errors.append(repr(e))


AUTOTUNE_INTERVAL_S = 0.25
#: The convergence window: the counted calls start once the tuner has grown,
#: then changed no knob (no grow, revert or shrink) for this many ticks, and
#: its last tick's class finds no knob to grow (``AutoTuner.can_grow``), or
#: after AUTOTUNE_CONVERGE_S seconds. A revert undoes a grow, so a grow that
#: the guard reverted does not count as one the tuner settled on; a pause
#: between grows (a class that changes from tick to tick breaks the
#: hysteresis) is not a settled tuner while the pipeline still starves.
#: From one worker and one decode thread the ramp takes 18-30 s on an H100
#: host when few grows are reverted, and up to 41 s when many are: a window
#: that the cap started while the decode threads still grew read 0.59-0.80
#: of decode (a), so the cap leaves room for the slow ramps.
AUTOTUNE_SETTLE_TICKS = 8
AUTOTUNE_CONVERGE_S = 45.0
AUTOTUNE_MIN_RATIO = 0.90
AUTOTUNE_MEM_CALLS = 3
#: The memory cell's governor budget and the ballast that parks its ladder
#: at advisory (75% of the budget; advisory starts at 70%, degrade at 85%).
AUTOTUNE_MEM_BUDGET = 10 << 30
AUTOTUNE_MEM_BALLAST = int(0.75 * AUTOTUNE_MEM_BUDGET)


def _tuner_gauges(registry, label):
    """The registry's ``pst_autotune_*`` gauge samples of pipeline ``label``."""
    snap = registry.collect()
    return [(name, s['labels']) for name in ('pst_autotune_bottleneck', 'pst_autotune_knob')
            for s in snap.get(name, {}).get('samples', ())
            if (s.get('labels') or {}).get('pipeline') == label]


def _autotune_record(at):
    """The phase line's digest of a tuner's ``stats()``."""
    decisions = at['decisions']
    grows = [d for d in decisions if d['action'] == 'grow']
    actions = {}
    for d in decisions:
        actions[d['action']] = actions.get(d['action'], 0) + 1
    trajectory = at['trajectory']
    return {'start_knobs': ({k: v for k, v in trajectory[0].items() if k != 't'}
                            if trajectory else None),
            'final_knobs': at['knobs'], 'ticks': at['ticks'], 'paused_ticks': at['paused_ticks'],
            'reverts': at['reverts'], 'mem_shrinks': at['mem_shrinks'],
            'last_class': at['last_class'], 'decisions_by_action': actions,
            'seconds_to_last_grow': grows[-1]['t'] if grows else None,
            'workers_decode_threads': [(p['t'], p.get('workers'), p.get('decode_threads'))
                                       for p in trajectory],
            'decisions': [{k: d.get(k) for k in ('t', 'tick', 'action', 'class', 'changes',
                                                 'rate')} for d in decisions]}


def run_imagenet_autotune(url, device, card, state, decode_rate, warmup=3, calls=5):
    """The autotune cell on ``state``, started from starved knobs: the
    decode cell's store and protocol (a ``null`` cache, so every epoch
    decodes; K1 in the 8-step graph), ``make_tensor_reader(workers_count=1)``
    and ``TorchLoader(prefetch=1, inflight=1, arena_depth=2,
    autotune=AutotuneConfig(interval_s=0.25))``, which adopts the reader's
    knobs, under a decode-thread budget of 1 (the process's comes back
    after) and a fresh metrics registry. (a) Convergence: after ``warmup``
    calls, calls go on until the tuner's last grow, and every knob change
    after it, is ``AUTOTUNE_SETTLE_TICKS`` ticks old and its last tick's
    class finds no knob to grow, or ``AUTOTUNE_CONVERGE_S`` seconds passed;
    then ``calls`` counted calls, unprofiled, and as many timed. A line
    that fails a check is printed before the phase raises.
    Fails unless K1 ran 8 times in each of the window's replays, the tuner
    grew at least once on a ``reader-starved`` or ``input-bound`` tick and
    ended above one worker, img/s is at least ``AUTOTUNE_MIN_RATIO`` of
    ``decode_rate`` (imagenet_decode (a)'s of the same run), every loss is
    finite, and after ``close()`` no ``pstt-autotune`` thread and no
    ``pst_autotune_*`` gauge of the tuner's pipeline is left. (b) The memory
    bias: the same reader and loader, built under a fresh governor armed
    with an ``AUTOTUNE_MEM_BUDGET`` budget and a ballast pool that holds its
    ladder at advisory, run ``AUTOTUNE_MEM_CALLS`` calls through (a)'s
    graph. Fails unless the tuner took a ``mem-shrink`` step, never grew,
    and every loss is finite. Returns the phase's line."""
    import threading

    import torch
    from petastorm_tpu_torch import (TorchLoader, decode_budget, make_tensor_reader, membudget,
                                     metrics)
    from petastorm_tpu_torch.autotune import (INPUT_BOUND, READER_STARVED, THREAD_NAME,
                                              AutotuneConfig)
    from petastorm_tpu_torch.models import make_scan_train_step
    from petastorm_tpu_torch.reader import host_cores

    t_phase = time.perf_counter()
    config = AutotuneConfig(interval_s=AUTOTUNE_INTERVAL_S)
    knobs = dict(prefetch=1, inflight=1, arena_depth=2)
    out = {'phase': 'imagenet_autotune', 'card': card, 'model': 'resnet50', 'stem': 'conv7',
           'classes': 1000, 'cache_type': 'null',
           'start': dict(knobs, workers=1, decode_threads=1), 'interval_s': config.interval_s,
           'host_cores': host_cores()}

    def make_reader():
        return make_tensor_reader(url, schema_fields=['image', 'label'],
                                  reader_pool_type='thread', workers_count=1, cache_type='null',
                                  shuffle_row_groups=True, seed=0, num_epochs=None,
                                  autotune=False)

    def inputs_of(loader):
        groups = loader.superbatches(SCAN_K)

        def next_inputs():
            sb = next(groups)
            return sb.image, sb.label
        return next_inputs

    def finite(losses):
        return all(math.isfinite(v) for pair in losses for v in pair)

    previous_budget = decode_budget.set_budget(decode_budget.DecodeThreadBudget(total=1))
    previous_registry = metrics.set_registry(metrics.MetricsRegistry())
    try:
        registry = metrics.get_registry()
        train = make_scan_train_step(SCAN_K, preprocess=normalize_bf16)
        torch.cuda.reset_peak_memory_stats(device)
        # (a) convergence from starved knobs.
        with make_reader() as reader:
            with TorchLoader(reader, BATCH, device=device, autotune=config, **knobs) as loader:
                tuner = loader._autotuner
                next_inputs = inputs_of(loader)
                t0 = time.perf_counter()
                settle = {}

                def settled():
                    at = tuner.stats()
                    changes = [d['tick'] for d in at['decisions']
                               if d['action'] in ('grow', 'revert', 'shrink')]
                    grew = any(d['action'] == 'grow' for d in at['decisions'])
                    if (grew and at['ticks'] - changes[-1] >= AUTOTUNE_SETTLE_TICKS
                            and not tuner.can_grow()):
                        reason = 'ticks'
                    elif time.perf_counter() - t0 >= AUTOTUNE_CONVERGE_S:
                        reason = 'cap'
                    else:
                        return False
                    settle.update(s=time.perf_counter() - t0, reason=reason, knobs=at['knobs'],
                                  tick=at['ticks'])
                    return True

                # The graph's kernels are counted after the timed calls: the
                # walk takes the consumer away for about a second, which the
                # tuner reads as a pipeline ahead of its trainer and answers
                # with a shrink just before the timed window.
                metrics_, launches, captured, _, _, replays = scan_window(
                    train, state, next_inputs, warmup, calls, (), profile=False,
                    until=settled)
                window_s = time.perf_counter() - t0
                loader.reset_stats()
                wall, wait_s, call_ms, timed = time_scan_calls(train, state, next_inputs, calls)
                stats = loader.stats
                ran = graph_launches(train, ('normalize_kernel',), replays)
        time.sleep(0.1)
        left = {'threads': [t.name for t in threading.enumerate()
                            if t.name.startswith(THREAD_NAME) and t.is_alive()],
                'gauges': _tuner_gauges(registry, tuner.pipeline_label)}
        at = stats['autotune']
        require_scan_launches(launches, captured, ran, ('normalize_images',), SCAN_K, replays)
        losses = [[float(m['loss']), float(m['last_loss'])] for m in metrics_ + timed]
        img_per_s = calls * SCAN_K * BATCH / wall
        grew = [d for d in at['decisions']
                if d['action'] == 'grow' and d['class'] in (READER_STARVED, INPUT_BOUND)]
        last_grow = max((d['tick'] for d in at['decisions'] if d['action'] == 'grow'),
                        default=0)
        record = _autotune_record(at)
        out['convergence'] = dict(
            record, img_per_s=img_per_s, step_ms=wall / (calls * SCAN_K) * 1e3,
            input_stall_frac=wait_s / wall, device_call_ms_median=call_ms,
            device_step_ms=call_ms / SCAN_K, settle_calls=len(metrics_) - calls,
            settle_s=settle['s'], settled_on=settle['reason'], knobs_at_window=settle['knobs'],
            reverts_after_last_grow=sum(1 for d in at['decisions']
                                        if d['action'] == 'revert' and d['tick'] > last_grow),
            changes_after_settle=[d for d in record['decisions']
                                  if d['tick'] > settle['tick']],
            window_s=window_s, counted_calls=calls, timed_calls=calls,
            img_per_s_vs_decode_worker_decode=img_per_s / decode_rate,
            decode_s=stats['worker_stage_timings']['decode_s'], decoder=stats['decoder'],
            losses_mean_last=losses, left_after_close=left,
            k1_graph={'ran': ran['normalize_kernel'], 'expected': SCAN_K * replays,
                      'replays': replays},
            launches=_scan_launches(launches, captured, ran, len(metrics_), replays))
        problems = []
        if not grew or at['knobs']['workers'] <= 1:
            problems.append('no starved grow past one worker: {}'.format(at['knobs']))
        if img_per_s < AUTOTUNE_MIN_RATIO * decode_rate:
            problems.append("{} img/s is under {} of imagenet_decode (a)'s {}".format(
                img_per_s, AUTOTUNE_MIN_RATIO, decode_rate))
        if not finite(losses):
            problems.append('non-finite loss: {}'.format(losses))
        if left['threads'] or left['gauges']:
            problems.append('left after close: {}'.format(left))
        if problems:
            emit(dict(out, failed=problems))
            raise AssertionError('imagenet_autotune (a): {}'.format('; '.join(problems)))
        # (b) the memory bias: a ballast parks the ladder at advisory.
        decode_budget.set_budget(decode_budget.DecodeThreadBudget(total=1))
        governor = membudget.MemoryGovernor()
        previous_governor = membudget.set_governor(governor)
        try:
            governor.arm(budget=AUTOTUNE_MEM_BUDGET)
            ballast = governor.register_pool('ballast', lambda: AUTOTUNE_MEM_BALLAST)
            try:
                with make_reader() as reader:
                    with TorchLoader(reader, BATCH, device=device, autotune=config,
                                     **knobs) as loader:
                        governor.check()
                        level = governor.pressure_level()
                        wall_b, wait_b, call_ms_b, timed_b = time_scan_calls(
                            train, state, inputs_of(loader), AUTOTUNE_MEM_CALLS)
                        level_after = governor.pressure_level()
                        stats_b = loader.stats
                mem_state = governor.stats().get('state')
            finally:
                ballast.close()
        finally:
            governor.release()
            membudget.set_governor(previous_governor)
        at_b = stats_b['autotune']
        losses_b = [[float(m['loss']), float(m['last_loss'])] for m in timed_b]
        out['memory_bias'] = dict(
            _autotune_record(at_b), calls=AUTOTUNE_MEM_CALLS,
            img_per_s=AUTOTUNE_MEM_CALLS * SCAN_K * BATCH / wall_b,
            input_stall_frac=wait_b / wall_b, device_step_ms=call_ms_b / SCAN_K,
            arena_pinned=stats_b['arena_pinned'], pressure_level=level, mem_state=mem_state,
            budget=AUTOTUNE_MEM_BUDGET, ballast=AUTOTUNE_MEM_BALLAST, losses_mean_last=losses_b)
        problems = []
        if level != 1 or level_after != 1:
            problems.append('the ladder read {} and {}, not advisory'.format(level, level_after))
        if at_b['mem_shrinks'] < 1:
            problems.append('no mem-shrink')
        if any(d['action'] == 'grow' for d in at_b['decisions']):
            problems.append('a grow at advisory')
        if not finite(losses_b):
            problems.append('non-finite loss: {}'.format(losses_b))
        if problems:
            emit(dict(out, failed=problems))
            raise AssertionError('imagenet_autotune (b): {}'.format('; '.join(problems)))
    finally:
        metrics.set_registry(previous_registry)
        decode_budget.set_budget(previous_budget)
    del train
    torch.cuda.empty_cache()
    a = out['convergence']
    out.update(img_per_s=a['img_per_s'], device_step_ms=a['device_step_ms'],
               input_stall_frac=a['input_stall_frac'], k1_graph=a['k1_graph'],
               launches=a['launches'], peak_mem_GB=torch.cuda.max_memory_allocated(device) / 1e9,
               checks={'k1_per_replay': SCAN_K, 'starved_grow': True, 'workers_above_one': True,
                       'min_ratio_vs_decode_worker_decode': AUTOTUNE_MIN_RATIO,
                       'losses_finite': True, 'nothing_left_after_close': True,
                       'mem_shrink_without_grow': True},
               seconds=time.perf_counter() - t_phase)
    return out


def run_imagenet_hbm(url, device, card, state, epochs=HBM_EPOCHS):
    """``_measure_device_cache`` through the port on ``state``: see
    :func:`hbm_scan` (``epochs`` counted, as many timed)."""
    import torch
    from petastorm_tpu_torch.models import make_scan_train_step

    torch.cuda.reset_peak_memory_stats(device)
    cache, fill_s = fill_device_cache(url, device)
    train = make_scan_train_step(SCAN_K, preprocess=normalize_bf16)
    result, window = hbm_scan(cache, train, state, epochs, ('normalize_kernel',))
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
                                cache_type='chunk-store', cache_location=store_dir, autotune=False)
    with reader:
        with TorchLoader(reader, BATCH, device=device, autotune=False) as loader:
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


def run_imagenet_hbm_partial(url, device, card, state, store_dir, reference_rates,
                             counted=PARTIAL_EPOCHS):
    """The partial HBM tier under ResNet-50 scan training: a
    ``DeviceDatasetCache(partial=True, max_bytes=160e6,
    superbatch_batches=4, shuffle=True)`` filled from a deterministic
    chunk-store reader over ``store_dir`` (an in-order pass, 4 workers),
    with ``loader_factory`` a fresh such reader and loader a pass. 8 of the
    16 batches stay resident in two runs; each epoch streams the other 8.
    Epoch 0 fills; :func:`hbm_scan` trains a partial window (its warm-up
    epoch, ``counted`` epochs counted, as many timed) through a scan step
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
                                  cache_type='chunk-store', cache_location=store_dir,
                                  autotune=False)

    def factory():
        with reader() as r:
            with TorchLoader(r, BATCH, device=device, autotune=False) as loader:
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
            with TorchLoader(r, BATCH, device=device, autotune=False) as loader:
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
        for first in (1, 2 + 2 * counted):
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
            result, window = hbm_scan(cache, train, state, counted, ('normalize_kernel',),
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
    if mismatched or len(complete) < 1 + 2 * (1 + 2 * counted):
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


def lm_token_reader(url, mesh=None):
    """The ``lm`` child's token reader (``bench.py:160-306``):
    ``make_pod_reader`` of ``tokens``, 2 threads, shuffled row-groups (seed
    0), endless, ``cache_type='memory'``; this host's whole store, or on a
    ``mesh`` its share."""
    from petastorm_tpu_torch import make_pod_reader
    return make_pod_reader(url, mesh=mesh, pod_shard=None if mesh else (0, 1),
                           schema_fields=['tokens'], reader_pool_type='thread',
                           workers_count=2, shuffle_row_groups=True, seed=0,
                           num_epochs=None, cache_type='memory', autotune=False)


def lm_scan(reader, device, model, batch, k, warmup, calls, layers, mesh=None, lineage=None,
            observe=None):
    """An LM scan path (the ``lm`` child's protocol, ``bench.py:160-306``):
    ``reader`` (of ``tokens``; this function stops it; the ``lm`` child's is
    :func:`lm_token_reader`), ``TorchLoader(batch=batch * k)``,
    ``make_lm_scan_train_step(k)`` (SGD lr 0.01, momentum 0.9);
    :func:`scan_window` over ``warmup`` + ``calls`` calls, each flash kernel
    ``layers * k`` times a call on the Hopper route, then ``calls`` timed;
    the losses must be finite and fall. On a ``mesh`` the loader is the
    mesh's (the tokens split over the model's ``seq_axis``) and the state's
    parameters are split by ``transformer_param_spec``. ``lineage`` is the
    loader's; ``observe(tokens, loader)`` sees each superbatch before its
    call. Returns the path's line (without phase and model keys), the
    metrics of every call and the measured calls' profile."""
    import torch
    from petastorm_tpu_torch import TorchLoader
    from petastorm_tpu_torch.models import create_train_state, make_lm_scan_train_step
    from petastorm_tpu_torch.models.train import transformer_param_spec
    from petastorm_tpu_torch.parallel.mesh import sequence_sharding

    state = create_train_state(model, learning_rate=0.01, momentum=0.9, mesh=mesh,
                               param_spec_fn=transformer_param_spec)
    train = make_lm_scan_train_step(k, mesh=mesh)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    sharding = None
    if mesh is not None and model.seq_axis is not None:
        sharding = {'tokens': sequence_sharding(mesh, seq_axis=model.seq_axis)}
    with reader:
        with TorchLoader(reader, batch * k, device=device, prefetch=2, mesh=mesh,
                         sharding=sharding, lineage=lineage, autotune=False) as loader:
            def next_inputs():
                tokens = next(loader).tokens
                if observe is not None:
                    observe(tokens, loader)
                return (tokens,)

            metrics, launches, captured, ran, measured, replays = scan_window(
                train, state, next_inputs, warmup, calls, FLASH_KERNELS)
            wall, wait_s, call_ms, timed = time_scan_calls(train, state, next_inputs, calls)
            stats = loader.stats
            cache = reader.cache_stats() if hasattr(reader, 'cache_stats') else None
    seq = model.max_len
    require_scan_launches(launches, captured, ran, FLASH_WRAPPERS, layers * k, replays)
    losses = [float(v) for m in metrics + timed for v in m['losses']]
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError('lm scan losses did not fall: {}'.format(losses))
    steps = calls * k
    result = {
        'layers': layers, 'seq': seq, 'batch': batch, 'microbatches': k,
        'cache_type': cache['type'] if cache else None,
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
    result, metrics, measured = lm_scan(lm_token_reader(url), device, model, batch, k, warmup,
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
# lm_plain: the lm cell trained from plain Parquet and from a mixture
# --------------------------------------------------------------------------

def write_lm_plain_store(path, rows=LM_ROWS, seq=LM_SEQ, seed=11):
    """The token store as plain Parquet, as Spark, pandas or pyarrow users
    write it: ``pyarrow.parquet.write_table`` of one ``list<int32>`` column
    ``tokens``, ``LM_PLAIN_ROWS_PER_GROUP``-row groups, no
    ``_common_metadata``. Seed 11 draws :func:`write_lm_store`'s values.
    Returns (the URL, the ``[rows, seq]`` tokens written)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(seed)
    tokens = np.stack([rng.integers(0, LM_VOCAB, seq, dtype=np.int32) for _ in range(rows)])
    offsets = pa.array(np.arange(0, rows * seq + 1, seq, dtype=np.int32))
    column = pa.ListArray.from_arrays(offsets, pa.array(tokens.ravel()))
    os.makedirs(path, exist_ok=True)
    pq.write_table(pa.table({'tokens': column}), os.path.join(path, 'part-00000.parquet'),
                   row_group_size=LM_PLAIN_ROWS_PER_GROUP)
    return 'file://' + path, tokens


def lm_plain_reader_kwargs(cache_dir):
    """The lm_plain cell's batch reader arguments: the token field, the
    local-disk Arrow cache under ``cache_dir``, deterministic order (seed
    0), endless, 2 threads."""
    return {'schema_fields': ['tokens'], 'cache_type': 'local-disk',
            'cache_location': cache_dir, 'deterministic': True, 'seed': 0,
            'num_epochs': None, 'workers_count': 2}


def _rows_of(reader, n):
    """The first ``n`` rows of a batch reader's ``tokens``."""
    out, have = [], 0
    while have < n:
        block = np.asarray(next(reader).tokens)
        out.append(block)
        have += len(block)
    return np.concatenate(out)[:n]


def run_lm_plain(url_a, url_b, tokens_b, lm_url, device, card, workdir, lm_scan_line,
                 warmup=2, calls=6):
    """The lm cell's TransformerLM trained, with lm_scan's protocol
    (:func:`lm_scan`), from (a) ``make_batch_reader`` over the plain store
    A (:func:`lm_plain_reader_kwargs`) and (b) ``WeightedSamplingReader([A,
    B], LM_PLAIN_MIX, seed=0)`` of two such readers; then the adapters on
    the card: ``make_converter`` of B's table (``tokens_b``, its rows), a
    reference petastorm copy of the lm store (``lm_url``), and
    ``reader_throughput(A)``. ``lm_scan_line`` is lm_scan's line of the same
    run, set beside. Fails unless every check of phase 22 of
    ``chip_smoke.py`` passes. Returns the phase's three lines: (a), (b)
    and the adapters'."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    import torch
    from petastorm_tpu_torch import TorchLoader, make_batch_reader, make_tensor_reader
    from petastorm_tpu_torch.benchmark import reader_throughput
    from petastorm_tpu_torch.converter import make_converter
    from petastorm_tpu_torch.etl.legacy import LEGACY_UNISCHEMA_KEY, export_legacy_metadata
    from petastorm_tpu_torch.fs import FilesystemResolver
    from petastorm_tpu_torch.lineage import _digest_array
    from petastorm_tpu_torch.storage import UNISCHEMA_KEY, ParquetStore
    from petastorm_tpu_torch.tools.copy_dataset import copy_dataset
    from petastorm_tpu_torch.weighted_sampling_reader import WeightedSamplingReader

    cache_dir = os.path.join(workdir, 'arrow_cache')
    kwargs = lm_plain_reader_kwargs(cache_dir)
    beside = {'lm_scan': {key: lm_scan_line[key] for key in (
        'tokens_per_s', 'device_step_ms', 'input_stall_frac', 'peak_mem_GB')}}
    beside['lm_scan']['trace'] = {key: lm_scan_line['trace'][key] for key in (
        'device_busy_ms_per_step', 'device_idle_share')}

    def line(variant, result, t0):
        return dict({'phase': 'lm_plain', 'variant': variant, 'card': card,
                     'model': 'TransformerLM', 'beside': beside,
                     'tokens_per_s_vs_lm_scan': result['tokens_per_s']
                     / lm_scan_line['tokens_per_s'],
                     'seconds': time.perf_counter() - t0}, **result)

    # Epoch 1, in storage order, fills the Arrow cache: a miss a row-group.
    t0 = time.perf_counter()
    groups = LM_ROWS // LM_PLAIN_ROWS_PER_GROUP
    with make_batch_reader(url_a, shuffle_row_groups=False, autotune=False, **dict(kwargs,
                           num_epochs=1)) as r:
        with TorchLoader(r, LM_BATCH * SCAN_K, device=device, last_batch='partial',
                         autotune=False) as loader:
            epoch = torch.cat([b.tokens for b in loader]).cpu().numpy()
        fill = r.cache_stats()
    column = read_store_column(url_a, 'tokens').to_pylist()
    if not np.array_equal(epoch, np.array(column, dtype=np.int32)):
        raise AssertionError('lm_plain (a): an in-order epoch differs from pyarrow\'s column')
    if fill['misses'] != groups or fill['hits']:
        raise AssertionError('lm_plain (a): epoch 1 counted {} misses and {} hits; expected {} '
                             'misses'.format(fill['misses'], fill['hits'], groups))

    # (a) the batch reader, served by the Arrow cache.
    kept = []
    reader = make_batch_reader(url_a, autotune=False, **kwargs)
    result, _, _ = lm_scan(reader, device, lm_model(device, LM_LAYERS, LM_SEQ - 1), LM_BATCH,
                           SCAN_K, warmup, calls, LM_LAYERS,
                           observe=lambda tokens, loader: kept.append(tokens.clone()))
    streamed = torch.cat(kept).cpu().numpy()
    with make_batch_reader(url_a, reader_pool_type='dummy', autotune=False, **kwargs) as single:
        if not np.array_equal(streamed, _rows_of(single, len(streamed))):
            raise AssertionError('lm_plain (a): the training stream\'s {} batches differ from '
                                 'the dummy-pool reader\'s'.format(len(kept)))
    cache, chunks = result['cache'], len(streamed) // LM_PLAIN_ROWS_PER_GROUP
    if cache['misses'] or cache['hits'] < chunks:
        raise AssertionError('lm_plain (a): the Arrow cache counted {} misses and {} hits over '
                             '{} delivered chunks; expected hits only'.format(
                                 cache['misses'], cache['hits'], chunks))
    result['epoch_1_cache'] = fill
    result['checks'] = {'k2_k4_per_replay': LM_LAYERS * SCAN_K,
                        'stream_equals_dummy_pool_batches': len(kept),
                        'epoch_equals_pyarrow_rows': len(epoch),
                        'cache_misses_epoch_1': groups, 'cache_hits_after': cache['hits'],
                        'losses_finite_and_fall': True}
    result['store'] = {'rows': LM_ROWS, 'rows_per_group': LM_PLAIN_ROWS_PER_GROUP,
                       'column': 'list<int32>', 'common_metadata': False}
    lines = [line('batch_reader', result, t0)]

    # (b) the mixture of A and B.
    t0 = time.perf_counter()
    sources = []

    def observe(tokens, loader):
        for segment in loader.last_provenance['segments']:
            if segment['row_start'] == 0:           # a chunk's first rows
                sources.append(segment['source'])

    mixture = WeightedSamplingReader([make_batch_reader(url_a, autotune=False, **kwargs),
                                      make_batch_reader(url_b, autotune=False, **kwargs)],
                                     list(LM_PLAIN_MIX), seed=0)
    result, _, _ = lm_scan(mixture, device, lm_model(device, LM_LAYERS, LM_SEQ - 1), LM_BATCH,
                           SCAN_K, warmup, calls, LM_LAYERS,
                           lineage=os.path.join(workdir, 'ledger'), observe=observe)
    reckoned = np.searchsorted(np.cumsum(LM_PLAIN_MIX),
                               np.random.default_rng(0).random(len(sources)), side='right')
    if list(reckoned) != sources or set(sources) != {0, 1}:
        raise AssertionError('lm_plain (b): chunk sources {} against the reckoning {}'.format(
            sources, list(reckoned)))
    result['source_chunks'] = [sources.count(0), sources.count(1)]
    result['sources_in_order'] = sources
    result['mixture'] = {'probabilities': list(LM_PLAIN_MIX), 'seed': 0,
                         'b_rows': len(tokens_b)}
    result['checks'] = {'k2_k4_per_replay': LM_LAYERS * SCAN_K,
                        'chunk_sources_equal_reckoning': len(sources),
                        'both_sources_drawn': True, 'losses_finite_and_fall': True}
    lines.append(line('mixture', result, t0))

    # The adapters: the converter, a reference store, the throughput harness.
    t0 = time.perf_counter()
    conv_dir = os.path.join(workdir, 'converter')
    table_b = pa.table({'tokens': pa.array(list(tokens_b), pa.list_(pa.int32()))})
    converter = make_converter(table_b, parent_cache_dir_url=conv_dir)
    with converter.make_torch_loader(batch_size=LM_BATCH * SCAN_K, device=device,
                                     shuffle_row_groups=False, num_epochs=1) as loader:
        first = [next(loader) for _ in range(2)]
    got = torch.cat([b.tokens for b in first]).cpu().numpy()
    if (first[0].tokens.device.type != torch.device(device).type
            or not np.array_equal(got, tokens_b[:len(got)])):
        raise AssertionError('lm_plain: the converter\'s first batches differ from B\'s rows')
    entries = sorted(os.listdir(conv_dir))
    if make_converter(table_b, parent_cache_dir_url=conv_dir) is not converter or \
            sorted(os.listdir(conv_dir)) != entries:
        raise AssertionError('lm_plain: a second make_converter of the same table wrote again')
    converter.delete()
    resolver = FilesystemResolver(converter.dataset_url)
    if resolver.filesystem().exists(resolver.get_dataset_path()):
        raise AssertionError('lm_plain: delete() left the converter\'s store')
    legacy_url = 'file://' + os.path.join(workdir, 'legacy')
    copied = copy_dataset(lm_url, legacy_url, rows_per_row_group=ROWS_PER_GROUP)
    export_legacy_metadata(legacy_url)
    store = ParquetStore(legacy_url)
    metadata = {k: v for k, v in store.read_common_metadata().items() if k != UNISCHEMA_KEY}
    schema = store.read_arrow_schema().with_metadata(metadata)   # before the file is truncated
    with store.fs.open(store.path + '/_common_metadata', 'wb') as f:
        pq.write_metadata(schema, f)
    if LEGACY_UNISCHEMA_KEY not in metadata:
        raise AssertionError('lm_plain: the copy carries no reference schema')
    digests = []
    for url in (lm_url, legacy_url):
        with make_tensor_reader(url, shuffle_row_groups=False, reader_pool_type='dummy',
                                autotune=False) as r:
            with TorchLoader(r, LM_BATCH * SCAN_K, device=device, autotune=False) as loader:
                digests.append(_digest_array(next(loader).tokens.cpu().numpy()))
    if digests[0] != digests[1]:
        raise AssertionError('lm_plain: the reference copy\'s first batch differs from the '
                             'lm store\'s')
    rates = {}
    for method in ('python', 'torch'):
        runs = [reader_throughput(url_a, field_regex=['tokens'], read_method=method,
                                  warmup_cycles_count=LM_ROWS,
                                  measure_cycles_count=LM_PLAIN_THROUGHPUT_EPOCHS * LM_ROWS,
                                  shuffling_queue_size=0, min_after_dequeue=0,
                                  torch_batch_size=LM_BATCH * SCAN_K, device=device)
                for _ in range(LM_PLAIN_THROUGHPUT_RUNS)]
        per_s = [r.samples_per_second for r in runs]
        median = float(np.median(per_s))
        rates[method] = {'warmup_rows': LM_ROWS,
                         'measured_rows': LM_PLAIN_THROUGHPUT_EPOCHS * LM_ROWS,
                         'samples_per_second': per_s, 'median': median,
                         'spread_frac': (max(per_s) - min(per_s)) / median,
                         'memory_rss_mb': runs[-1].memory_rss_mb,
                         'cpu_percent': [r.cpu_percent for r in runs]}
    lines.append({'phase': 'lm_plain', 'variant': 'adapters', 'card': card,
                  'converter': {'rows': len(tokens_b), 'first_batches_equal_b': len(first),
                                'second_call_same_converter': True, 'deleted': True},
                  'reference_store': {'rows_copied': copied, 'first_batch_digest_equal': True,
                                      'digest': digests[0]},
                  'reader_throughput_a': rates,
                  'psutil': rates['python']['memory_rss_mb'] is not None,
                  'seconds': time.perf_counter() - t0})
    return lines


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
    if batch[0].is_cuda:
        torch.cuda.current_stream(batch[0].device).synchronize()


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
        with make_tensor_reader(url, num_epochs=1, autotune=False, **kwargs) as filler:
            for _ in filler:
                pass
            if not filler.chunk_store.flush(timeout_s=120):
                raise RuntimeError('the chunk store did not drain its writes')
        fill_s = time.perf_counter() - t0
    try:
        reader = make_tensor_reader(url, num_epochs=None, autotune=False, **kwargs)
        with reader:
            with TorchLoader(reader, batch, device=device, prefetch=2, autotune=False) as loader:
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


def decode_path_sweep(url):
    """The cold decode path's img/s (``bench.py:651-715``): ``scalar`` (one
    native call an image, ``PSTT_DECODE_PATH=scalar``), ``batched`` (one
    call a row-group, fanned over the decode-thread budget) and
    ``chunk-store-warm`` (a store filled by ``tools.transcode``: no JPEG is
    decoded), each one pass of ``BENCH_PIPELINE_DECODE_WORKERS`` (1) worker
    over a cold ``null`` cache, in store order. With one worker the scalar
    row is one decode thread, and the batched row that worker with the
    whole budget. ``ratio_batched_vs_scalar`` stands beside the JAX bench's
    ``gate_min_ratio`` of 1.5. Each row names the decoder it ran; a row
    that fails fails the child."""
    from petastorm_tpu_torch import decode_budget, make_tensor_reader
    from petastorm_tpu_torch.chunk_store import TEMP_DIR_PREFIX
    from petastorm_tpu_torch.codecs import DECODE_PATH_ENV
    from petastorm_tpu_torch.tools.transcode import transcode_dataset

    workers = _env_int('BENCH_PIPELINE_DECODE_WORKERS', 1)
    out = {'workers': workers, 'decode_threads_total': decode_budget.get_budget().total}

    def measure(**kwargs):
        with make_tensor_reader(url, schema_fields=['image', 'label'], reader_pool_type='thread',
                                workers_count=workers, num_epochs=1, shuffle_row_groups=False,
                                autotune=False, **kwargs) as reader:
            t0 = time.perf_counter()
            images = sum(len(chunk.image) for chunk in reader)
            elapsed = time.perf_counter() - t0
            timings, decoder = reader.stage_timings, reader.decoder
        return {'img_per_sec': images / elapsed, 'images': images, 'wall_s': elapsed,
                'read_s': timings['read_s'], 'decode_s': timings['decode_s'],
                'decoder': decoder['image'], 'decoder_error': decoder['image_error'],
                'parquet': decoder['parquet']}

    saved = os.environ.get(DECODE_PATH_ENV)
    os.makedirs(BUILD_DIR, exist_ok=True)
    store_dir = tempfile.mkdtemp(prefix=TEMP_DIR_PREFIX, dir=BUILD_DIR)
    try:
        os.environ[DECODE_PATH_ENV] = 'scalar'
        out['scalar'] = measure(cache_type='null')
        os.environ[DECODE_PATH_ENV] = 'batched'
        out['batched'] = measure(cache_type='null')
        transcode_dataset(url, store_dir, schema_fields=['image', 'label'],
                          workers_count=max(2, workers))
        out['chunk-store-warm'] = measure(cache_type='chunk-store', cache_location=store_dir)
    finally:
        if saved is None:
            os.environ.pop(DECODE_PATH_ENV, None)
        else:
            os.environ[DECODE_PATH_ENV] = saved
        shutil.rmtree(store_dir, ignore_errors=True)
    ratio = out['batched']['img_per_sec'] / out['scalar']['img_per_sec']
    out.update(ratio_batched_vs_scalar=ratio, gate_min_ratio=DECODE_GATE_MIN_RATIO,
               gate_passed=ratio >= DECODE_GATE_MIN_RATIO)
    return out


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
                                seed=0, cache_type='memory', deterministic=True, autotune=False)
    with reader:
        with TorchLoader(reader, batch, device=device, prefetch=prefetch,
                         inflight=inflight, autotune=False) as loader:
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
                                 cache_type='memory', autotune=False)
        with reader:
            with TorchLoader(reader, batch, mesh=mesh, autotune=False) as loader:
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


def run_pipeline(url, device, workers, autotune):
    """Loader-only capacity: the imagenet child's reader and loader with no
    train step (``bench.py:774-949``). ``make_tensor_reader(cache_type=
    'memory', num_epochs=None, shuffle_row_groups=True, seed=0)``,
    ``TorchLoader(batch, prefetch, inflight, arena_depth, lineage=<a
    throwaway ledger directory>, autotune)`` (defaults 128, 2, 2, the
    loader's; ``BENCH_PIPELINE_*``). ``autotune`` arms the loader's tuner
    (the child passes ``BENCH_PIPELINE_AUTOTUNE``, default on,
    ``bench.py:805-809``), and its record is ``pipeline_autotune``; warm-up through one epoch plus two batches,
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
                                seed=0, cache_type='memory', autotune=False)
    with reader:
        with TorchLoader(reader, batch, device=device, prefetch=prefetch, inflight=inflight,
                         arena_depth=int(arena_depth) if arena_depth else None,
                         lineage=ledger_dir, autotune=autotune) as loader:
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
            autotune_record = autotune_summary(stats)
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
    if os.environ.get('BENCH_PIPELINE_DECODE_SWEEP', '1') == '1':
        profile['decode_path_sweep'] = decode_path_sweep(url)
    out = {
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
        'pipeline_stage_profile': profile}
    if autotune_record is not None:
        out['pipeline_autotune'] = autotune_record
    return out


# --------------------------------------------------------------------------
# the reader metric and the staging child (bench.py:313-370, 2657-2700)
# --------------------------------------------------------------------------

def measure_reader(url, workers, pool='thread', cache_type='null'):
    """samples/s of the per-row ``make_reader`` (endless, shuffled, seed 0)
    over ``HELLO_MEASURE_SAMPLES`` rows after ``HELLO_WARMUP_SAMPLES``
    (``bench.py:313-327``)."""
    from petastorm_tpu_torch import make_reader
    with make_reader(url, reader_pool_type=pool, workers_count=workers, num_epochs=None,
                     shuffle_row_groups=True, seed=0, cache_type=cache_type,
                     autotune=False) as reader:
        for _ in range(HELLO_WARMUP_SAMPLES):
            next(reader)
        start = time.perf_counter()
        for _ in range(HELLO_MEASURE_SAMPLES):
            next(reader)
        return HELLO_MEASURE_SAMPLES / (time.perf_counter() - start)


def hello_world_metric(url, workers):
    """The bench's top-level metric (``bench.py:2657-2700``): the pools
    ``dummy`` and ``thread`` with 1, 2 and ``workers`` workers swept, the
    best run three more times, the median the value; the single-draw best
    and the memory cache's rate at the same configuration beside it."""
    swept = [('dummy', 1)] + [('thread', w) for w in sorted({1, 2, workers})]
    rates = {cfg: measure_reader(url, cfg[1], pool=cfg[0]) for cfg in swept}
    pool, n = max(rates, key=rates.get)
    reps = sorted(measure_reader(url, n, pool=pool) for _ in range(3))
    return {'metric': 'hello_world_samples_per_sec', 'value': reps[1], 'unit': 'samples/s',
            'vs_baseline': reps[1] / REFERENCE_SAMPLES_PER_SEC,
            'baseline_samples_per_sec': REFERENCE_SAMPLES_PER_SEC,
            'hello_world_cached_samples_per_sec': measure_reader(url, n, pool=pool,
                                                                 cache_type='memory'),
            'hello_world_single_draw_max': max(reps + [rates[(pool, n)]]),
            'hello_config': {'reader_pool': pool, 'workers_count': n,
                             'configs_swept': ['{}-{}'.format(p, w) for p, w in swept],
                             'sweep_rates': {'{}-{}'.format(p, w): r
                                             for (p, w), r in rates.items()},
                             'rep_rates': reps, 'rows': HELLO_ROWS,
                             'warmup': HELLO_WARMUP_SAMPLES, 'measure': HELLO_MEASURE_SAMPLES}}


def run_staging(url, device, workers, pool='thread'):
    """The staging child (``bench.py:339-370``): hello_world rows through
    ``make_reader`` and ``TorchLoader(batch 32, PadTo((4, 128, 30, 3)) on
    array_4d)`` to ``device``; samples/s of 40 batches after the first, each
    fenced on its copy, and the input stall."""
    from petastorm_tpu_torch import PadTo, TorchLoader, make_reader
    with make_reader(url, reader_pool_type=pool, workers_count=workers, num_epochs=None,
                     shuffle_row_groups=True, seed=0, autotune=False) as reader:
        with TorchLoader(reader, STAGING_BATCH, device=device,
                         shape_policies={'array_4d': PadTo((4, 128, 30, 3))},
                         autotune=False) as loader:
            _fence(next(loader))
            loader.reset_stats()
            start = time.perf_counter()
            for _ in range(STAGING_BATCHES):
                batch = next(loader)
                _fence(batch)
            elapsed = time.perf_counter() - start
            stall = loader.stats['input_stall_frac']
    if tuple(batch.array_4d.shape) != (STAGING_BATCH, 4, 128, 30, 3):
        raise AssertionError('staging: array_4d came out {}'.format(tuple(batch.array_4d.shape)))
    return {'staged_samples_per_sec': STAGING_BATCH * STAGING_BATCHES / elapsed,
            'hello_input_stall_frac': stall, 'staging_batches': STAGING_BATCHES,
            'staging_batch': STAGING_BATCH, 'reader_pool': pool, 'workers_count': workers,
            'device': str(batch.image1.device)}


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
    'staging': ('staging', {}),
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
    # Before the fleet children, where the JAX bench runs it (bench.py:2768-2775).
    'lookup': ('lookup', {}),
    # Last, where the JAX bench runs its fleet_wire child (bench.py:2836).
    'imagenet_remote': ('imagenet_remote', {}),
    'fleet_wire': ('fleet_wire', {}),
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
    warm-up calls (call 2 captures the graph) and 1 measured. ResNet-50's
    streamed loader runs with the autotuner unless
    ``BENCH_IMAGENET_AUTOTUNE=0``, and its record is ``imagenet_autotune``."""
    url = ensure_imagenet_store(workdir)
    model = os.environ.get('BENCH_IMAGENET_MODEL', 'resnet50')
    aug = os.environ.get('BENCH_IMAGENET_AUG', '0') == '1'
    warmup = max(2, -(-_env_int('BENCH_IMAGENET_WARMUP', ROWS // BATCH + 3) // SCAN_K))
    calls = max(1, _env_int('BENCH_IMAGENET_STEPS', 40) // SCAN_K)
    # The tuner runs by default, as in the bench (bench.py:1868-1870).
    autotune = os.environ.get('BENCH_IMAGENET_AUTOTUNE', '1') == '1'
    card = _card(device)
    config = {'model': model, 'augment': aug, 'batch': BATCH, 'scan_microbatches': SCAN_K,
              'prefetch': SCAN_PREFETCH, 'workers': 4, 'cache_type': 'memory',
              'warmup_calls': warmup, 'measured_calls': calls, 'autotune': autotune}
    if model == 'vit':
        line = run_imagenet_vit(url, device, card, warmup, calls)
        streamed, hbm = line['streamed'], line['hbm']
    elif model == 'resnet50':
        if aug:
            line = run_imagenet_aug(url, device, card, resnet50_state(device))
            streamed, hbm = None, line['augmented']
        else:
            streamed, state = run_imagenet_scan(url, device, card, warmup, calls,
                                                autotune=autotune)
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
    if streamed is not None and streamed.get('autotune') is not None:
        out['imagenet_autotune'] = streamed['autotune']
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
    return run_pipeline(ensure_imagenet_store(workdir), device, workers,
                        autotune=os.environ.get('BENCH_PIPELINE_AUTOTUNE', '1') == '1')


def child_staging(device, workdir):
    return run_staging(ensure_hello_world_store(workdir), device,
                       _env_int('BENCH_HELLO_WORKERS', 2),
                       os.environ.get('BENCH_HELLO_POOL', 'thread'))


def child_flashattn(device, workdir):
    return dict(run_flashattn(device), card=_card(device))


def child_imagenet_remote(device, workdir):
    """The remote cell (:func:`run_imagenet_remote`) on a fresh ResNet-50
    state: the 3 + 5 + 5 calls of the imagenet child's protocol, the
    fleet_wire record at its 3 repetitions."""
    url = ensure_imagenet_store(workdir)
    return run_imagenet_remote(url, device, _card(device), resnet50_state(device),
                               os.path.join(workdir, 'remote'), wire_reps=WIRE_REPS)


def child_fleet_wire(device, workdir):
    return {'fleet_wire_stage_profile': run_fleet_wire()}


def child_lookup(device, workdir):
    """The JAX bench's lookup child (:func:`run_lookup`); ``BENCH_LOOKUP_READS``,
    ``BENCH_LOOKUP_REPS`` and ``BENCH_LOOKUP_FLEET_READS`` as there."""
    sock_dir = tempfile.mkdtemp(prefix='pstt-lookup-', dir=workdir)
    try:
        return {'lookup_stage_profile': run_lookup(
            ensure_lookup_store(workdir), sock_dir,
            reads=_env_int('BENCH_LOOKUP_READS', LOOKUP_READS),
            reps=max(1, _env_int('BENCH_LOOKUP_REPS', LOOKUP_REPS)),
            fleet_reads=_env_int('BENCH_LOOKUP_FLEET_READS', LOOKUP_FLEET_READS))}
    finally:
        shutil.rmtree(sock_dir, ignore_errors=True)


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
    elif kind == 'staging':
        out = child_staging(device, workdir)
    elif kind == 'fleet_wire':
        out = child_fleet_wire(device, workdir)
    elif kind == 'lookup':
        out = child_lookup(device, workdir)
    elif device.type != 'cuda':
        raise ValueError('child {!r} runs on the card only; --device cpu runs the pipeline, '
                         'staging, lookup and fleet_wire children'.format(name))
    else:
        out = {'imagenet': child_imagenet, 'lm': child_lm, 'flashattn': child_flashattn,
               'imagenet_remote': child_imagenet_remote}[kind](device, workdir)
    out.update(_device_keys(device), child=name)
    return out


def run_all(device, workdir):
    """The reader metric (:func:`hello_world_metric`), then every child in a
    subprocess, in order: ``(metric, results, failures)``."""
    hello_url = ensure_hello_world_store(workdir)
    ensure_imagenet_store(workdir)
    for seq in (LM_SEQ, 8193):
        ensure_lm_store(workdir, seq)
    metric = hello_world_metric(hello_url, max(4, min(10, os.cpu_count() or 4)))
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(filter(None, [ROOT, env.get('PYTHONPATH')]))
    env['BENCH_HELLO_POOL'] = metric['hello_config']['reader_pool']
    env['BENCH_HELLO_WORKERS'] = str(metric['hello_config']['workers_count'])
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
    return metric, results, failures


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--child', default=None, help='run one child: ' + ', '.join(CHILDREN))
    parser.add_argument('--device', default='cuda', help="'cuda' (default) or, for the tests, "
                                                         "'cpu' (the pipeline, staging, lookup "
                                                         "and fleet_wire children only)")
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
        metric, results, failures = run_all(args.device, workdir)
        emit(dict(metric, **results, failed=sorted(failures), failures=failures))
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
