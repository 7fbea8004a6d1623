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
as a Chrome trace. Entry points take ``device=`` and default to
``'cuda'``.
"""

from petastorm_tpu_torch.cache import (LocalDiskArrowTableCache, LocalDiskCache,  # noqa: F401
                                       MemoryCache, NullCache)
from petastorm_tpu_torch.chunk_store import DecodedChunkStore  # noqa: F401
from petastorm_tpu_torch.codecs import (CompressedImageCodec, CompressedNdarrayCodec,  # noqa: F401
                                        NdarrayCodec, ScalarCodec)
from petastorm_tpu_torch.decode_budget import DecodeThreadBudget, get_decode_budget  # noqa: F401
from petastorm_tpu_torch.device import resolve_device  # noqa: F401
from petastorm_tpu_torch.device_cache import DeviceCacheOverflow, DeviceDatasetCache  # noqa: F401
from petastorm_tpu_torch.errors import (HostMemoryExceededError,  # noqa: F401
                                        PipelineStallError, RowGroupQuarantinedError)
from petastorm_tpu_torch.etl import (DatasetWriter, get_schema, materialize_dataset,  # noqa: F401
                                     write_dataset)
from petastorm_tpu_torch.loader import (CropTo, PadTo, ShapePolicy, TorchLoader,  # noqa: F401
                                        make_torch_loader, register_device_decode)
from petastorm_tpu_torch.metrics import (MetricsExporter, MetricsRegistry,  # noqa: F401
                                         start_http_exporter)
from petastorm_tpu_torch.reader import (Reader, make_batch_reader,  # noqa: F401
                                        make_pod_reader, make_reader, make_tensor_reader)
from petastorm_tpu_torch.trace import Tracer  # noqa: F401
from petastorm_tpu_torch.unischema import Unischema, UnischemaField  # noqa: F401
