"""Columnar row-group worker of ``make_batch_reader`` over any Parquet store
(counterpart of ``petastorm_tpu/arrow_worker.py:27-282``).

Each row-group item is read as an Arrow table of the view's fields (hive
partition values appended as constant columns), through the cache when
there is one (``LocalDiskArrowTableCache``, ``MemoryCache``: the table is
what is cached), then cut to its drop partition, transformed by a
``TransformSpec`` on a pandas DataFrame, and permuted in place
(``shuffle_rows_in_chunk``), in the JAX worker's order. A predicate runs
in two phases: its own columns first, tested row by row on a pandas
DataFrame as the JAX worker tests them (so a predicate sees pandas' row
values: an int column beside a float one arrives as a float), then the
other columns of the kept rows only; it bypasses the cache.

The table's columns then become numpy arrays on the worker's thread
(:func:`arrow_table_to_columns`), where the JAX package converts them on
the consumer's: a list column whose rows all have one length is one
``[rows, L]`` block, any other list column an object array of per-row
arrays (``None`` for a null row), a string, binary or decimal column an
object array, any other column ``to_numpy``'s array. The worker publishes
the tensor worker's payload (``key``, ``cols``, ``lineage``, ``timings``,
``det``), so the reader's resume accounting, resequencer and provenance
are the tensor path's, over every pool kind (a process pool pickles the
payload, its arrays out of band); the JAX worker carries the same facts in
the table's ``pst.*`` schema metadata and ships the table over Arrow IPC.
pandas is imported only by a transform and a predicate.

Spans (the global tracer's, ``:37-94``): the ``decode`` span covers that
conversion (the worker's ``decode_s``), where the JAX package's covers the
table's load, the ``read`` span nested; the publish is a ``handoff`` span.
"""

import hashlib
import time

import numpy as np
import pyarrow as pa

from petastorm_tpu_torch.checkpoint import chunk_key
from petastorm_tpu_torch.errors import DecodeFieldError
from petastorm_tpu_torch.faults import maybe_inject, rowgroup_fault_key
from petastorm_tpu_torch.lineage import chunk_lineage
from petastorm_tpu_torch.trace import get_global_tracer
from petastorm_tpu_torch.unischema import arrow_primitive_dtype
from petastorm_tpu_torch.workers.rowgroup_worker_base import (RowGroupWorkerBase,
                                                              chunk_row_permutation,
                                                              compute_row_slice,
                                                              with_partition_columns)


class ArrowWorker(RowGroupWorkerBase):
    """``args`` as :class:`~petastorm_tpu_torch.tensor_worker.TensorWorker`'s.
    ``timings``: ``read_s`` (the Parquet read, 0 on a cache hit),
    ``decode_s`` (Arrow to numpy) and ``cache_s``."""

    batched_output = True
    #: Reader mode of provenance contexts.
    lineage_mode = 'arrow'

    def process(self, piece_index, worker_predicate=None, shuffle_row_drop_partition=None,
                pst_det=None):
        piece = self.args['row_groups'][piece_index]
        maybe_inject('decode-corrupt', key=rowgroup_fault_key(piece.path, piece.row_group))
        timings = {}
        table, read_fresh = self._load_table(piece, worker_predicate, timings)
        if table is None or not table.num_rows:
            self._publish_hole(pst_det)
            return
        row_slice = compute_row_slice(table.num_rows, shuffle_row_drop_partition)
        if row_slice is not None:
            table = table.slice(row_slice[0], row_slice[1] - row_slice[0])
        transform_spec = self.args.get('transform_spec')
        if table.num_rows and transform_spec is not None and transform_spec.func is not None:
            table = self._apply_transform(table, transform_spec)
        permuted = bool(table.num_rows and self.args.get('shuffle_rows_in_chunk'))
        if permuted:
            perm = chunk_row_permutation(self.args.get('shuffle_seed'),
                                         self.args['dataset_path_hash'], piece.path,
                                         piece.row_group, shuffle_row_drop_partition,
                                         table.num_rows)
            table = table.take(pa.array(perm))
        if not table.num_rows:
            self._publish_hole(pst_det)
            return
        t0 = time.perf_counter()
        with get_global_tracer().span('decode', 'worker'):
            cols = arrow_table_to_columns(table, self.args['transformed_schema'])
        timings['decode_s'] = time.perf_counter() - t0
        tier = 'decode' if read_fresh else self.args['cache'].lineage_tier
        payload = {'key': chunk_key(piece_index, shuffle_row_drop_partition), 'cols': cols,
                   'lineage': chunk_lineage(piece, piece_index, shuffle_row_drop_partition,
                                            table.num_rows, tier, permuted=permuted,
                                            filtered=worker_predicate is not None,
                                            worker_id=self.worker_id),
                   'timings': timings}
        if pst_det is not None:
            payload['det'] = pst_det
        with get_global_tracer().span('handoff', 'worker'):
            self.publish_func(payload)

    def _apply_transform(self, table, transform_spec):
        """The pandas transform of ``petastorm_tpu/arrow_worker.py:111-121``:
        the function takes and returns a DataFrame; removed fields are
        dropped, and the columns of the transformed schema kept."""
        out = transform_spec.func(table.to_pandas())
        for name in transform_spec.removed_fields:
            if name in out.columns:
                out = out.drop(columns=[name])
        keep = [n for n in self.args['transformed_schema'].fields if n in out.columns]
        return pa.Table.from_pandas(out[keep], preserve_index=False)

    def _load_table(self, piece, predicate, timings):
        """``(table, read_fresh)``: the row-group's fields of the view (only
        the rows ``predicate`` keeps; None when it keeps none), and whether
        this call read the store (else the cache served it)."""
        names = list(self.args['schema'].fields)
        if predicate is not None:
            t0 = time.perf_counter()
            table = self._load_with_predicate(piece, names, predicate)
            timings['read_s'] = time.perf_counter() - t0
            return table, True
        # The JAX package's key: a cache directory either package filled
        # serves the other.
        key = '{}:{}:{}:{}'.format(self.args['dataset_path_hash'], piece.path, piece.row_group,
                                   hashlib.md5(','.join(names).encode()).hexdigest()[:8])

        def load():
            t1 = time.perf_counter()
            table = self._read_fields(piece, names)
            timings['read_s'] = time.perf_counter() - t1
            return table

        t0 = time.perf_counter()
        table = self.args['cache'].get(key, load)
        timings['cache_s'] = time.perf_counter() - t0 - timings.get('read_s', 0.0)
        return table, 'read_s' in timings

    def _load_with_predicate(self, piece, names, predicate):
        """The two-phase read of ``petastorm_tpu/arrow_worker.py:157-182``."""
        fields = sorted(predicate.get_fields())
        unknown = set(fields) - set(self.args['full_schema'].fields)
        if unknown:
            raise ValueError('Predicate uses unknown fields: {}'.format(sorted(unknown)))
        pred_table = self._read_fields(piece, fields)
        pred_df = pred_table.to_pandas()
        mask = (pred_df.apply(lambda r: predicate.do_include({f: r[f] for f in fields}),
                              axis=1).values
                if len(pred_df) else np.zeros(0, dtype=bool))
        if not mask.any():
            return None
        other = [n for n in names if n not in fields and n not in piece.partition_values]
        if other:
            other_table = self._read_row_group(piece, other)
            for name in other_table.column_names:
                pred_table = pred_table.append_column(name, other_table.column(name))
        table = with_partition_columns(pred_table, piece, names)
        keep = [n for n in names if n in table.column_names]
        return table.select(keep).take(pa.array(np.flatnonzero(mask)))


def arrow_table_to_columns(table, schema):
    """``{name: numpy array}`` of the table's columns that ``schema`` names
    (see the module docstring)."""
    cols = {}
    for name, field in schema.fields.items():
        if name in table.column_names:
            try:
                cols[name] = arrow_column_to_numpy(table.column(name), field)
            except DecodeFieldError:
                raise
            except Exception as e:
                raise DecodeFieldError('Unable to convert field {!r}: {}'.format(name, e)) from e
    return cols


def arrow_column_to_numpy(column, field):
    """One Arrow column as numpy (``petastorm_tpu/arrow_worker.py:258-282``):
    a list column whose rows are all present and of one shape vstacks into a
    2-D block of the field's dtype, any other list column is an object
    array of per-row arrays; an object field (strings, binary, decimals) is
    an object array; a dictionary column is decoded first."""
    if isinstance(column, pa.ChunkedArray):
        column = column.combine_chunks()
    if pa.types.is_dictionary(column.type):
        column = column.cast(column.type.value_type)
    if pa.types.is_list(column.type) or pa.types.is_large_list(column.type):
        block = _dense_list_block(column, field)
        if block is not None:
            return block
        values = column.to_pylist()
        shapes = {np.shape(v) for v in values if v is not None}
        if len(shapes) == 1 and None not in values:
            return np.vstack([np.asarray(v, dtype=field.numpy_dtype) for v in values])
        out = np.empty(len(values), dtype=object)
        for i, v in enumerate(values):
            out[i] = None if v is None else np.asarray(v, dtype=field.numpy_dtype)
        return out
    return column.to_numpy(zero_copy_only=False)


def _dense_list_block(column, field):
    """The ``[rows, L]`` block of a list column in one pass over its value
    buffer, or None unless every row is present and of one length and the
    items are null-free numbers of the field's dtype (the cases where it
    equals the row-by-row ``np.vstack``)."""
    item_type = column.type.value_type
    if not len(column) or column.null_count or not (
            pa.types.is_integer(item_type) or pa.types.is_float32(item_type)
            or pa.types.is_float64(item_type) or pa.types.is_boolean(item_type)):
        return None
    if arrow_primitive_dtype(item_type) != field.numpy_dtype:
        return None
    lengths = np.diff(np.asarray(column.offsets))
    if (lengths != lengths[0]).any():
        return None
    values = column.flatten()
    if values.null_count:
        return None
    return np.array(values.to_numpy(zero_copy_only=False), dtype=field.numpy_dtype).reshape(
        len(column), int(lengths[0]))


def restack_list_columns(cols):
    """``cols`` with each object column of per-row arrays that are now all
    of one shape vstacked into a block: what the JAX package's conversion
    gives for the rows a resume leaves of a chunk, since it converts after
    the skip."""
    out = dict(cols)
    for name, block in cols.items():
        if (block.dtype == object and len(block)
                and all(isinstance(v, np.ndarray) for v in block)
                and len({v.shape for v in block}) == 1):
            out[name] = np.vstack(list(block))
    return out
