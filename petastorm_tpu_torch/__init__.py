"""petastorm_tpu_torch: the PyTorch/CUDA port of petastorm_tpu.

It stands beside the JAX package and imports nothing of it: JPEG Parquet
-> per-row or decoded-columnar reader (with an optional decoded-chunk
cache: in memory, in files on local disk, or the mmapped chunk store that
either package can fill) -> pinned-arena H2D loader (batches or superbatches; shape
policies, a row-level shuffling buffer, echo) -> on-device
augmentation ending in a hand-written normalize kernel -> ResNet training;
and token Parquet -> the same reader and loader -> TransformerLM with
hand-written CUDA flash attention -> SGD steps, one at a time or K at a
time as one replayed CUDA graph; and a device-resident dataset tier
(``DeviceDatasetCache``, whole or partial with eviction). A host memory
governor (``membudget``) accounts the pipeline's pools against one budget.
Images decode through a native C++ codec, one call a row-group, fanned over
a process-wide decode-thread budget (``decode_budget``), in the workers or
at the loader's staging step (``raw_image_fields``). Stores are any fsspec
URL (``storage_options``); a reader with an ``error_budget`` quarantines
poison row-groups (``faults`` injects them: ``PSTT_FAULTS``), and the
``metrics`` registry counts the pipeline. Each stage beats a heartbeat
that a watchdog (``health``, ``watchdog=True`` or ``PSTT_WATCHDOG``) turns
into a diagnosed ``PipelineStallError`` and a flight-recorder dump
(``PSTT_FLIGHT_RECORDER``); ``trace.Tracer`` records the stages' host spans
as a Chrome trace. An autotuner (``autotune``, ``autotune=True`` or
``PSTT_AUTOTUNE``; ``AutotuneConfig``) resizes the worker pool and turns the
loader's depths while the pipeline runs. Entry points take ``device=`` and
default to ``'cuda'``.

The public names resolve lazily (PEP 562): importing the package imports
none of its modules, so a worker process of a process pool, which imports
only the reader's workers and what they need, loads no ``torch`` and can
never make a CUDA context.
"""

import importlib

_EXPORTS = {
    'petastorm_tpu_torch.autotune': ('AutotuneConfig',),
    'petastorm_tpu_torch.cache': ('LocalDiskArrowTableCache', 'LocalDiskCache', 'MemoryCache',
                                  'NullCache'),
    'petastorm_tpu_torch.chunk_store': ('DecodedChunkStore',),
    'petastorm_tpu_torch.codecs': ('CompressedImageCodec', 'CompressedNdarrayCodec',
                                   'NdarrayCodec', 'ScalarCodec'),
    'petastorm_tpu_torch.decode_budget': ('DecodeThreadBudget', 'get_decode_budget'),
    'petastorm_tpu_torch.device': ('resolve_device',),
    'petastorm_tpu_torch.device_cache': ('DeviceCacheOverflow', 'DeviceDatasetCache'),
    'petastorm_tpu_torch.data_service': ('DataServer', 'RemoteReader', 'serve_dataset'),
    'petastorm_tpu_torch.errors': ('HostMemoryExceededError', 'PipelineStallError',
                                   'RowGroupQuarantinedError', 'ServerOverloaded',
                                   'WorkerLostError'),
    'petastorm_tpu_torch.etl': ('DatasetWriter', 'get_schema', 'materialize_dataset',
                                'write_dataset'),
    'petastorm_tpu_torch.loader': ('CropTo', 'PadTo', 'ShapePolicy', 'TorchLoader',
                                   'make_torch_loader', 'register_device_decode'),
    'petastorm_tpu_torch.metrics': ('MetricsExporter', 'MetricsRegistry', 'start_http_exporter'),
    'petastorm_tpu_torch.reader': ('Reader', 'make_batch_reader', 'make_pod_reader',
                                   'make_reader', 'make_tensor_reader'),
    'petastorm_tpu_torch.trace': ('Tracer',),
    'petastorm_tpu_torch.unischema': ('Unischema', 'UnischemaField'),
}
_MODULE_OF = {name: module for module, names in _EXPORTS.items() for name in names}
__all__ = sorted(_MODULE_OF)


def __getattr__(name):
    module = _MODULE_OF.get(name)
    if module is None:
        # An AttributeError lets ``from petastorm_tpu_torch import <submodule>``
        # import the submodule.
        raise AttributeError('module {!r} has no attribute {!r}'.format(__name__, name))
    value = getattr(importlib.import_module(module), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
