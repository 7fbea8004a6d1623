"""petastorm_tpu_torch: the PyTorch/CUDA port of petastorm_tpu.

It stands beside the JAX package and imports nothing of it: JPEG Parquet
-> decoded-columnar tensor reader -> pinned-arena H2D loader -> on-device
augmentation ending in a hand-written normalize kernel -> ResNet training;
and token Parquet -> the same reader and loader -> TransformerLM with
hand-written CUDA flash attention -> SGD steps. Entry points take
``device=`` and default to ``'cuda'``.
"""

from petastorm_tpu_torch.codecs import CompressedImageCodec, NdarrayCodec, ScalarCodec  # noqa: F401
from petastorm_tpu_torch.device import resolve_device  # noqa: F401
from petastorm_tpu_torch.etl import DatasetWriter, get_schema, write_dataset  # noqa: F401
from petastorm_tpu_torch.loader import TorchLoader  # noqa: F401
from petastorm_tpu_torch.reader import Reader, make_tensor_reader  # noqa: F401
from petastorm_tpu_torch.unischema import Unischema, UnischemaField  # noqa: F401
