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
Entry points take ``device=`` and default to ``'cuda'``.
"""

from petastorm_tpu_torch.cache import LocalDiskCache, MemoryCache, NullCache  # noqa: F401
from petastorm_tpu_torch.chunk_store import DecodedChunkStore  # noqa: F401
from petastorm_tpu_torch.codecs import CompressedImageCodec, NdarrayCodec, ScalarCodec  # noqa: F401
from petastorm_tpu_torch.device import resolve_device  # noqa: F401
from petastorm_tpu_torch.device_cache import DeviceCacheOverflow, DeviceDatasetCache  # noqa: F401
from petastorm_tpu_torch.etl import DatasetWriter, get_schema, write_dataset  # noqa: F401
from petastorm_tpu_torch.loader import (CropTo, PadTo, ShapePolicy, TorchLoader,  # noqa: F401
                                        make_torch_loader)
from petastorm_tpu_torch.reader import (Reader, make_pod_reader, make_reader,  # noqa: F401
                                        make_tensor_reader)
from petastorm_tpu_torch.unischema import Unischema, UnischemaField  # noqa: F401
