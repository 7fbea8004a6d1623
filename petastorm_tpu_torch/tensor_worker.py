"""Decoded-columnar row-group worker (counterpart of
``petastorm_tpu/tensor_worker.py:42-465``).

Each row-group is read (through the native Parquet stage when it builds,
else pyarrow: :class:`~petastorm_tpu_torch.workers.rowgroup_worker_base.
RowGroupWorkerBase`) and every column is decoded inside the worker straight
into one contiguous ``[rows, ...field.shape]`` numpy block: an image column
by one native call for the whole row-group, fanned over the worker's share
of the decode-thread budget (:func:`~petastorm_tpu_torch.codecs.
decode_image_batch_into`). The worker publishes one small dict of big
arrays per row-group, so decoded tensors never cross a per-row Python
boundary on their way to the loader. ``raw_image_fields`` (in ``args``)
are published encoded instead, as object columns of the JPEG/PNG bytes,
for the loader's staging step to decode.

Failure model (``petastorm_tpu/tensor_worker.py:74-111``): the
``decode-corrupt`` fault site fires before the row-group is looked up, keyed
by :func:`~petastorm_tpu_torch.faults.rowgroup_fault_key`, and the batched
image decode carries the same key for ``decode-corrupt-batch``. A decode's
seconds go to the ``pst_decode_seconds`` histogram, one observation a
row-group. The decode runs in a ``decode`` span and the publish in a
``handoff`` span of the process's global tracer (``:85-98, 184-204``).

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
import pyarrow as pa

from petastorm_tpu_torch import metrics
from petastorm_tpu_torch.cache import NullCache
from petastorm_tpu_torch.checkpoint import chunk_key
from petastorm_tpu_torch.chunk_store import tensor_chunk_key
from petastorm_tpu_torch.codecs import (CompressedImageCodec, CompressedNdarrayCodec,
                                        NdarrayCodec, ScalarCodec, _native_image,
                                        decode_image_batch_into)
from petastorm_tpu_torch.errors import DecodeFieldError
from petastorm_tpu_torch.faults import maybe_inject, rowgroup_fault_key
from petastorm_tpu_torch.lineage import chunk_lineage
from petastorm_tpu_torch.trace import get_global_tracer
from petastorm_tpu_torch.workers.rowgroup_worker_base import (RowGroupWorkerBase,
                                                              chunk_row_permutation,
                                                              compute_row_slice)


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
    per row-group item, plus ``'det'`` in deterministic mode (an item left
    empty publishes a hole marker then). ``args`` also holds ``cache`` (a
    :class:`~petastorm_tpu_torch.cache.CacheBase`), ``dataset_path_hash``,
    ``full_schema`` (the stored schema, for predicate fields outside the
    view), and may hold ``raw_image_fields``, ``transform_spec`` with
    ``transformed_schema``, ``shuffle_rows_in_chunk`` and ``shuffle_seed``.
    ``timings`` holds the seconds of this row-group's ``read_s`` and
    ``decode_s`` (on a miss) and ``cache_s`` (the cache's own bookkeeping,
    with a cache). ``lineage`` is the chunk's provenance segment; its tier
    is ``'decode'`` when this call decoded, else the cache's tier
    (``'memory'``, ``'disk'`` or ``'chunk-store'``).

    The steps follow ``petastorm_tpu/tensor_worker.py:72-207``: the read
    (with a worker predicate, two phases on decoded scalars, past every
    cache), the drop-partition slice, the ``TransformSpec`` on the blocks
    (on copies when the blocks came from a cache, so that an in-place
    transform cannot reach a later epoch), then the in-chunk permutation."""

    batched_output = True
    #: Reader mode of provenance contexts: replay decodes by it.
    lineage_mode = 'tensor'

    def process(self, piece_index, worker_predicate=None, shuffle_row_drop_partition=None,
                pst_det=None):
        piece = self.args['row_groups'][piece_index]
        schema = self.args['schema']
        fault_key = rowgroup_fault_key(piece.path, piece.row_group)
        maybe_inject('decode-corrupt', key=fault_key)
        timings = {}
        decoded = []

        def load():
            decoded.append(True)
            t0 = time.perf_counter()
            table = self._load_table(piece, worker_predicate)
            timings['read_s'] = time.perf_counter() - t0
            if table is None or not table.num_rows:
                return None
            t0 = time.perf_counter()
            with get_global_tracer().span('decode', 'worker'):
                cols = decode_table_to_blocks(table, schema,
                                              self.args.get('raw_image_fields') or (),
                                              fault_key=fault_key)
            timings['decode_s'] = time.perf_counter() - t0
            metrics.histogram('pst_decode_seconds',
                              'Row-group decode latency inside workers').observe(
                                  timings['decode_s'])
            return cols

        cache = self.args['cache']
        # A predicate read bypasses the cache: its chunks hold only the kept
        # rows, and are private.
        cached = worker_predicate is None and not isinstance(cache, NullCache)
        if cached:
            key = tensor_chunk_key(self.args['dataset_path_hash'], piece.path, piece.row_group,
                                   schema)
            t0 = time.perf_counter()
            cols = _read_only(cache.get(key, load))
            timings['cache_s'] = (time.perf_counter() - t0 - timings.get('read_s', 0.0)
                                  - timings.get('decode_s', 0.0))
        else:
            cols = load()
        if cols is None:            # an empty row-group, or no row kept
            self._publish_hole(pst_det)
            return
        n_rows = len(next(iter(cols.values())))
        row_slice = compute_row_slice(n_rows, shuffle_row_drop_partition)
        if row_slice is not None:
            cols = {k: v[row_slice[0]:row_slice[1]] for k, v in cols.items()}
            n_rows = max(0, row_slice[1] - row_slice[0])
        transform_spec = self.args.get('transform_spec')
        if n_rows and transform_spec is not None and transform_spec.func is not None:
            if cached:
                cols = {k: np.array(v) for k, v in cols.items()}
            out = transform_spec.func(dict(cols))
            for name in transform_spec.removed_fields:
                out.pop(name, None)
            keep = self.args['transformed_schema'].fields
            cols = {k: np.asarray(v) for k, v in out.items() if k in keep}
            n_rows = len(next(iter(cols.values()))) if cols else 0
        permuted = bool(n_rows and self.args.get('shuffle_rows_in_chunk'))
        if permuted:
            perm = chunk_row_permutation(self.args.get('shuffle_seed'),
                                         self.args['dataset_path_hash'], piece.path,
                                         piece.row_group, shuffle_row_drop_partition, n_rows)
            cols = {k: v[perm] for k, v in cols.items()}
        if not n_rows:
            self._publish_hole(pst_det)
            return
        tier = 'decode' if decoded else cache.lineage_tier
        payload = {'key': chunk_key(piece_index, shuffle_row_drop_partition), 'cols': cols,
                   'lineage': chunk_lineage(piece, piece_index, shuffle_row_drop_partition,
                                            n_rows, tier, permuted=permuted,
                                            filtered=worker_predicate is not None,
                                            worker_id=self.worker_id),
                   'timings': timings}
        if pst_det is not None:
            payload['det'] = pst_det
        with get_global_tracer().span('handoff', 'worker'):
            self.publish_func(payload)

    def _load_table(self, piece, predicate):
        """The row-group's fields of the view, only the rows ``predicate``
        keeps (None: every row, or None when it keeps none)."""
        names = list(self.args['schema'].fields)
        if predicate is None:
            return self._read_fields(piece, names)
        # Phase one: the predicate's stored fields, decoded as make_reader
        # decodes them, so it tests numpy scalars and strings; a partition
        # field is its parsed directory value as a numpy array, whatever the
        # field's dtype (``petastorm_tpu/tensor_worker.py:253-258``).
        full_schema = self.args['full_schema']
        fields = sorted(predicate.get_fields())
        unknown = set(fields) - set(full_schema.fields)
        if unknown:
            raise ValueError('Predicate uses unknown fields: {}'.format(sorted(unknown)))
        stored = [f for f in fields if f not in piece.partition_values]
        if not stored:
            raise ValueError('Predicate on partition values only should '
                             'have been pruned before ventilation')
        pred_table = self._read_row_group(piece, stored)
        n = pred_table.num_rows
        pred_cols = decode_table_to_blocks(pred_table, full_schema.create_schema_view(stored))
        for name in fields:
            if name in piece.partition_values:
                pred_cols[name] = np.asarray([piece.partition_values[name]] * n)
        mask = np.asarray([predicate.do_include({f: pred_cols[f][i] for f in fields})
                           for i in range(n)], dtype=bool)
        if not mask.any():
            return None
        # Phase two: the view's fields, only the kept rows.
        return self._read_fields(piece, names).take(pa.array(np.flatnonzero(mask)))


def decode_table_to_blocks(table, schema, raw_fields=(), fault_key=None, decode_threads=None):
    """Arrow table -> dict of contiguous per-field numpy blocks, decoded
    (``petastorm_tpu/tensor_worker.py:365-470``); an image column's call
    takes ``decode_threads`` threads, by default the worker's live share of
    the decode budget. ``raw_fields``
    names image columns that come out as object columns of their encoded
    bytes instead. ``fault_key`` is the row-group's key of the
    ``decode-corrupt-batch`` fault site."""
    cols = {}
    for name, field in schema.fields.items():
        column = table.column(name).combine_chunks()
        if column.null_count:
            raise DecodeFieldError(
                'Field {!r} contains nulls; the tensor path requires dense columns'.format(name))
        codec = field.resolved_codec()
        try:
            if isinstance(codec, CompressedImageCodec):
                if name in raw_fields:
                    cols[name] = _raw_image_column(column)
                else:
                    cols[name] = _decode_image_column(column, field, fault_key, decode_threads)
            elif isinstance(codec, (NdarrayCodec, CompressedNdarrayCodec)):
                cols[name] = _decode_ndarray_column(column, field, codec)
            else:
                cols[name] = _scalar_column_to_numpy(column, field)
        except DecodeFieldError:
            raise
        except Exception as e:
            raise DecodeFieldError('Unable to decode field {!r}: {}'.format(name, e)) from e
    return cols


def _binary_column_view(column):
    """(addresses, lengths) of a binary column's cells: pointer math over
    its value buffer, no per-cell ``bytes``."""
    buffers = column.buffers()     # validity, offsets, data
    off_dtype = np.int64 if pa.types.is_large_binary(column.type) else np.int32
    offsets = np.frombuffer(buffers[1], dtype=off_dtype, count=len(column) + column.offset + 1)
    offsets = offsets[column.offset:column.offset + len(column) + 1].astype(np.int64)
    return buffers[2].address + offsets[:-1], np.diff(offsets)


def _decode_image_column(column, field, fault_key=None, decode_threads=None):
    """One ``[N, ...field.shape]`` block, by one native call over the
    column's value buffer (the column stays alive for the call)."""
    out = np.empty((len(column),) + tuple(field.shape), dtype=field.numpy_dtype)
    ptrs = lens = None
    if _native_image() is not None and out.dtype == np.uint8:
        ptrs, lens = _binary_column_view(column)
    decode_image_batch_into(field, out, lambda i: column[i].as_py(), ptrs=ptrs, lens=lens,
                            decode_threads=decode_threads, fault_key=fault_key)
    return out


def _raw_image_column(column):
    """The encoded bytes as an object column (the staging-step decode's
    input): a reference a cell, no pixel work."""
    out = np.empty(len(column), dtype=object)
    for i, cell in enumerate(column):
        out[i] = cell.as_py()
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
