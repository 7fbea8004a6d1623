"""Decoded-columnar row-group worker (counterpart of
``petastorm_tpu/tensor_worker.py:42-465``).

Each row-group is read with pyarrow and every column is decoded inside the
worker straight into one contiguous ``[rows, ...field.shape]`` numpy block
(images through OpenCV, whose decode releases the GIL). The worker
publishes one small dict of big arrays per row-group, so decoded tensors
never cross a per-row Python boundary on their way to the loader.

With a cache (``cache_type='memory'``, ``'local-disk'`` or
``'chunk-store'``) the worker looks the row-group up ahead of the read,
keyed by :func:`~petastorm_tpu_torch.chunk_store.tensor_chunk_key` (the
reader's readahead computes the same key), and reads and decodes only on a
miss. Cached blocks are shared by every later epoch (a chunk-store hit is a
view of a mapping the whole process shares), so they are published
read-only, hits and fills alike: the loader copies out of them and never
hands them to a caller that could write into them.
"""

import time

import numpy as np

from petastorm_tpu_torch.cache import NullCache
from petastorm_tpu_torch.checkpoint import chunk_key
from petastorm_tpu_torch.chunk_store import tensor_chunk_key
from petastorm_tpu_torch.codecs import CompressedImageCodec, NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.errors import DecodeFieldError
from petastorm_tpu_torch.lineage import chunk_lineage
from petastorm_tpu_torch.workers.rowgroup_worker_base import RowGroupWorkerBase, compute_row_slice


def validate_tensor_schema(schema):
    """Raise unless every field can decode into a fixed-shape dense block."""
    for name, field in schema.fields.items():
        if isinstance(field.resolved_codec(), ScalarCodec):
            continue
        if any(dim is None for dim in field.shape):
            raise ValueError(
                'make_tensor_reader requires static shapes, but field {!r} has '
                'shape {} (None = variable dim)'.format(name, field.shape))


def _read_only(cols):
    """Mark decoded blocks shared: writes into them raise."""
    if cols is not None:
        for block in cols.values():
            block.flags.writeable = False
    return cols


class TensorWorker(RowGroupWorkerBase):
    """Publishes ``{'key', 'cols': {name: block}, 'lineage', 'timings'}``
    per row-group, plus ``'det'`` in deterministic mode (an empty
    row-group publishes a hole marker then). ``args`` also holds ``cache``
    (a :class:`~petastorm_tpu_torch.cache.CacheBase`) and
    ``dataset_path_hash``. ``timings`` holds the seconds of this
    row-group's ``read_s`` and ``decode_s`` (on a miss) and ``cache_s``
    (the cache's own bookkeeping, with a cache). ``lineage`` is the
    chunk's provenance segment; its tier is ``'decode'`` when this call
    decoded, else the cache's tier (``'memory'``, ``'disk'`` or
    ``'chunk-store'``)."""

    batched_output = True
    #: Reader mode of provenance contexts: replay decodes by it.
    lineage_mode = 'tensor'

    def process(self, piece_index, shuffle_row_drop_partition=None, pst_det=None):
        piece = self.args['row_groups'][piece_index]
        schema = self.args['schema']
        timings = {}
        decoded = []

        def load():
            decoded.append(True)
            t0 = time.perf_counter()
            table = self._read_row_group(piece, list(schema.fields))
            timings['read_s'] = time.perf_counter() - t0
            if not table.num_rows:
                return None
            t0 = time.perf_counter()
            cols = decode_table_to_blocks(table, schema)
            timings['decode_s'] = time.perf_counter() - t0
            return cols

        cache = self.args['cache']
        if isinstance(cache, NullCache):
            cols = load()
        else:
            key = tensor_chunk_key(self.args['dataset_path_hash'], piece.path, piece.row_group,
                                   schema)
            t0 = time.perf_counter()
            cols = _read_only(cache.get(key, load))
            timings['cache_s'] = (time.perf_counter() - t0 - timings.get('read_s', 0.0)
                                  - timings.get('decode_s', 0.0))
        n_rows = len(next(iter(cols.values()))) if cols else 0
        row_slice = compute_row_slice(n_rows, shuffle_row_drop_partition)
        if row_slice is not None:
            cols = {k: v[row_slice[0]:row_slice[1]] for k, v in cols.items()}
            n_rows = max(0, row_slice[1] - row_slice[0])
        if not n_rows:
            self._publish_hole(pst_det)
            return
        tier = 'decode' if decoded else cache.lineage_tier
        payload = {'key': chunk_key(piece_index, shuffle_row_drop_partition), 'cols': cols,
                   'lineage': chunk_lineage(piece, piece_index, shuffle_row_drop_partition,
                                            n_rows, tier, worker_id=self.worker_id),
                   'timings': timings}
        if pst_det is not None:
            payload['det'] = pst_det
        self.publish_func(payload)


def decode_table_to_blocks(table, schema):
    """Arrow table -> dict of contiguous per-field numpy blocks, decoded."""
    cols = {}
    for name, field in schema.fields.items():
        column = table.column(name).combine_chunks()
        if column.null_count:
            raise DecodeFieldError(
                'Field {!r} contains nulls; the tensor path requires dense columns'.format(name))
        codec = field.resolved_codec()
        try:
            if isinstance(codec, CompressedImageCodec):
                cols[name] = _decode_image_column(column, field, codec)
            elif isinstance(codec, NdarrayCodec):
                cols[name] = _decode_ndarray_column(column, field, codec)
            else:
                cols[name] = _scalar_column_to_numpy(column, field)
        except DecodeFieldError:
            raise
        except Exception as e:
            raise DecodeFieldError('Unable to decode field {!r}: {}'.format(name, e)) from e
    return cols


def _decode_image_column(column, field, codec):
    out = np.empty((len(column),) + tuple(field.shape), dtype=field.numpy_dtype)
    for i, cell in enumerate(column):
        codec.decode_into(field, cell.as_buffer(), out[i])
    return out


def _decode_ndarray_column(column, field, codec):
    out = np.empty((len(column),) + tuple(field.shape), dtype=field.numpy_dtype)
    for i, cell in enumerate(column):
        out[i] = codec.decode(field, cell.as_py())
    return out


def _scalar_column_to_numpy(column, field):
    np_dtype = np.dtype(field.numpy_dtype)
    if np_dtype.kind in ('O', 'S', 'U'):
        return np.asarray(column.to_pylist(), dtype=object)
    # A copy: Arrow's zero-copy numpy views are read-only.
    return np.array(column.to_numpy(zero_copy_only=False), dtype=np_dtype)
