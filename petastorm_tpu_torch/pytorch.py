"""PyTorch ``DataLoader`` adapter over the port's readers (counterpart of
``petastorm_tpu/pytorch.py:34-159``).

Rows are sanitised for torch (bool to uint8, uint16 to int32, uint32 to
int64; strings refused), optionally decorrelated through a
:class:`~petastorm_tpu_torch.shuffling_buffer.RandomShufflingBuffer`
seeded as the JAX adapter seeds it, and collated by
:func:`decimal_friendly_collate` into batches of ``batch_size`` rows (the
last one partial). A batched reader's row-group columns are transposed into
rows first. ``device='cuda'`` (the default, like every entry point of the
port) moves each collated batch to the card through pinned memory;
``device='cpu'`` keeps the host tensors the JAX package's adapter yields.
For fixed-size device batches with staging threads and pinned arenas, use
:class:`~petastorm_tpu_torch.loader.TorchLoader`.
"""

import decimal
import re

import numpy as np
import torch
from torch.utils.data.dataloader import default_collate

from petastorm_tpu_torch.device import resolve_device
from petastorm_tpu_torch.shuffling_buffer import NoopShufflingBuffer, RandomShufflingBuffer


def _sanitize_pytorch_types(row_as_dict):
    """In place: the dtypes torch cannot hold widened or refused
    (``petastorm_tpu/pytorch.py:34-56``)."""
    for name, value in row_as_dict.items():
        if isinstance(value, np.ndarray):
            if value.dtype == np.uint16:
                row_as_dict[name] = value.astype(np.int32)
            elif value.dtype == np.uint32:
                row_as_dict[name] = value.astype(np.int64)
            elif value.dtype == np.bool_:
                row_as_dict[name] = value.astype(np.uint8)
            elif re.search('[SaUO]', value.dtype.str):
                raise TypeError('Field {} has dtype {} which is not supported by torch'.format(
                    name, value.dtype))
        elif isinstance(value, np.bool_):
            row_as_dict[name] = np.uint8(value)
        elif isinstance(value, np.uint16):
            row_as_dict[name] = np.int32(value)
        elif isinstance(value, np.uint32):
            row_as_dict[name] = np.int64(value)
        elif isinstance(value, str):
            raise TypeError('Field {} is a string; strings are not supported by torch. Use a '
                            'TransformSpec to drop or encode it'.format(name))


def decimal_friendly_collate(batch):
    """``default_collate``, except that ``decimal.Decimal`` values stay a
    list, through namedtuples, tuples, lists and dicts."""
    if isinstance(batch[0], decimal.Decimal):
        return batch
    if hasattr(batch[0], '_fields'):    # a namedtuple, before the tuple branch
        return type(batch[0])(*(decimal_friendly_collate(samples) for samples in zip(*batch)))
    if isinstance(batch[0], (tuple, list)) and not isinstance(batch[0], str):
        return [decimal_friendly_collate(samples) for samples in zip(*batch)]
    if isinstance(batch[0], dict):
        return {key: decimal_friendly_collate([d[key] for d in batch]) for key in batch[0]}
    return default_collate(batch)


def _to_device(value, device):
    """``value``'s tensors on ``device``, copied from pinned memory."""
    if isinstance(value, torch.Tensor):
        return value.pin_memory().to(device, non_blocking=True)
    if hasattr(value, '_fields'):
        return type(value)(*(_to_device(v, device) for v in value))
    if isinstance(value, (tuple, list)):
        return type(value)(_to_device(v, device) for v in value)
    if isinstance(value, dict):
        return {k: _to_device(v, device) for k, v in value.items()}
    return value


class DataLoader(object):
    """Iterates collated torch batches off a reader.

    :param reader: a reader of the port (per-row, tensor, batch, or a
        ``WeightedSamplingReader``); NGram readers are refused.
    :param batch_size: rows a batch (the last batch may be short).
    :param collate_fn: default :func:`decimal_friendly_collate`.
    :param shuffling_queue_capacity: > 0 draws rows through a shuffling
        buffer of that capacity, floor ``min_after_dequeue`` (default 4/5 of
        it), seeded with ``seed``.
    :param device: where batches go: ``'cuda'`` (default) or ``'cpu'``.
    """

    def __init__(self, reader, batch_size=1, collate_fn=None, shuffling_queue_capacity=0,
                 min_after_dequeue=None, seed=None, device='cuda'):
        if getattr(reader, 'ngram', None) is not None:
            raise NotImplementedError('pytorch.DataLoader does not support NGram readers; '
                                      'consume the reader directly for windowed rows')
        self.device = resolve_device(device)
        self.reader = reader
        self.batch_size = batch_size
        self.collate_fn = collate_fn or decimal_friendly_collate
        self.shuffling_queue_capacity = shuffling_queue_capacity
        self._min_after_dequeue = (min_after_dequeue if min_after_dequeue is not None
                                   else shuffling_queue_capacity * 4 // 5)
        self._seed = seed
        self._in_iter = False

    def __iter__(self):
        if self._in_iter:
            raise RuntimeError('Only one iterator per DataLoader is supported')
        self._in_iter = True
        try:
            for batch in self._iter_impl():
                yield batch if self.device.type == 'cpu' else _to_device(batch, self.device)
        finally:
            self._in_iter = False

    def _iter_impl(self):
        if self.shuffling_queue_capacity > 0:
            buffer = RandomShufflingBuffer(self.shuffling_queue_capacity, self._min_after_dequeue,
                                           extra_capacity=100000, seed=self._seed)
        else:
            buffer = NoopShufflingBuffer()
        nt_type = self.reader.transformed_schema.namedtuple_type()
        batch = []
        for row in self.reader:
            if self.reader.batched_output:
                # A row-group's columns transposed into rows. A read-only
                # block (a cache's shared chunk, a data-service view over a
                # zmq frame or a shm segment) is copied once, so torch never
                # wraps memory it must not write.
                row_dict = {k: v.copy() if isinstance(v, np.ndarray) and not v.flags.writeable
                            else v for k, v in row._asdict().items()}
                keys = list(row_dict)
                rows = [dict(zip(keys, values)) for values in zip(*(row_dict[k] for k in keys))]
            else:
                rows = [row._asdict()]
            for row_dict in rows:
                _sanitize_pytorch_types(row_dict)
            buffer.add_many([nt_type(**r) for r in rows])
            while buffer.can_retrieve():
                batch.append(buffer.retrieve())
                if len(batch) == self.batch_size:
                    yield self.collate_fn(batch)
                    batch = []
        buffer.finish()
        while buffer.can_retrieve():
            batch.append(buffer.retrieve())
            if len(batch) == self.batch_size:
                yield self.collate_fn(batch)
                batch = []
        if batch:
            yield self.collate_fn(batch)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.reader.stop()
        self.reader.join()
        return False


class BatchedDataLoader(DataLoader):
    """The JAX package's alias of :class:`DataLoader` (the reference
    petastorm exposes both names)."""
