"""Per-row row-group worker (counterpart of ``petastorm_tpu/py_dict_worker.py:20-190``).

Each row-group is read with pyarrow and every row's fields are decoded
through the port's codecs into one dict of user-facing values per row:
ndarrays, numpy scalars and strings, images of any size (a field with
``None`` dims). The worker publishes the rows of each row-group with their
chunk key and provenance segment; the reader hands them out one at a time.
A worker predicate, ``transform_spec``, row-drop partitions and NGram
windows run here, in the JAX worker's order (:class:`PyDictWorker`). The
decode runs in a ``decode`` span and the publish in a ``handoff`` span of
the process's global tracer (``:78-140``).

With a cache (``cache_type='memory'`` or ``'local-disk'``, where the rows
are pickled) the row-group's decoded rows are kept and served to every
later epoch, so their arrays are published read-only.
"""

import hashlib
import time

import numpy as np
import pyarrow as pa

from petastorm_tpu_torch.cache import NullCache
from petastorm_tpu_torch.checkpoint import chunk_key
from petastorm_tpu_torch.errors import DecodeFieldError
from petastorm_tpu_torch.faults import maybe_inject, rowgroup_fault_key
from petastorm_tpu_torch.lineage import chunk_lineage
from petastorm_tpu_torch.trace import get_global_tracer
from petastorm_tpu_torch.workers.rowgroup_worker_base import RowGroupWorkerBase, compute_row_slice


def decode_table_to_rows(table, schema):
    """Arrow table -> list of per-row dicts of decoded values (``None``
    stays ``None`` for a nullable field)."""
    columns = {}
    for name, field in schema.fields.items():
        codec = field.resolved_codec()
        values = []
        for cell in table.column(name).to_pylist():
            if cell is None:
                values.append(None)
                continue
            try:
                values.append(codec.decode(field, cell))
            except DecodeFieldError:
                raise
            except Exception as e:
                raise DecodeFieldError('Unable to decode field {!r}: {}'.format(name, e)) from e
        columns[name] = values
    names = list(columns)
    return [dict(zip(names, row)) for row in zip(*(columns[name] for name in names))]


def _read_only(rows):
    for row in rows:
        for value in row.values():
            if isinstance(value, np.ndarray):
                value.flags.writeable = False
    return rows


class PyDictWorker(RowGroupWorkerBase):
    """Reads through pyarrow (``petastorm_tpu/py_dict_worker.py:34``).
    Publishes ``{'key', 'rows': [dict, ...], 'lineage', 'timings'}`` per
    non-empty row-group item, plus ``'det'`` in deterministic mode (an item
    left empty publishes a hole marker then). ``args`` also holds ``cache``,
    ``dataset_path_hash`` and ``full_schema``, and may hold ``ngram``,
    ``transform_spec`` and ``transformed_schema``.

    The steps follow ``petastorm_tpu/py_dict_worker.py:39-147``: the rows
    (with a worker predicate, a two-phase read past the cache: the
    predicate's fields, then the other fields of the kept rows only), the
    drop-partition slice (reaching into the next partition by an NGram's
    length), then the ``TransformSpec`` on each row, or the NGram windows
    and the transform on each of their rows. A window is not a stored row,
    so NGram chunks carry no lineage."""

    batched_output = False
    _prefer_native_parquet = False
    #: Reader mode of provenance contexts: replay decodes by it.
    lineage_mode = 'py_dict'

    def process(self, piece_index, worker_predicate=None, shuffle_row_drop_partition=None,
                pst_det=None):
        piece = self.args['row_groups'][piece_index]
        maybe_inject('decode-corrupt', key=rowgroup_fault_key(piece.path, piece.row_group))
        schema = self.args['schema']
        ngram = self.args.get('ngram')
        timings = {}
        decoded = []

        def load():
            decoded.append(True)
            t0 = time.perf_counter()
            table = self._read_fields(piece, list(schema.fields))
            timings['read_s'] = time.perf_counter() - t0
            t0 = time.perf_counter()
            with get_global_tracer().span('decode', 'worker'):
                rows = decode_table_to_rows(table, schema)
            timings['decode_s'] = time.perf_counter() - t0
            return rows

        cache = self.args['cache']
        if worker_predicate is not None:
            decoded.append(True)
            rows = self._load_rows_with_predicate(piece, worker_predicate, timings)
        elif isinstance(cache, NullCache):
            rows = load()
        else:
            key = 'rows:{}:{}:{}:{}'.format(
                self.args['dataset_path_hash'], piece.path, piece.row_group,
                hashlib.md5(','.join(schema.fields).encode()).hexdigest()[:8])
            t0 = time.perf_counter()
            rows = _read_only(cache.get(key, load))
            timings['cache_s'] = (time.perf_counter() - t0 - timings.get('read_s', 0.0)
                                  - timings.get('decode_s', 0.0))
        row_slice = compute_row_slice(len(rows), shuffle_row_drop_partition, ngram)
        if row_slice is not None:
            rows = rows[row_slice[0]:row_slice[1]]
        transform_spec = self.args.get('transform_spec')
        if transform_spec is not None and transform_spec.func is None:
            transform_spec = None
        # Cached rows are shared with later epochs: a transform that writes
        # into its row's dict or arrays gets copies.
        copy = _copy_row if worker_predicate is None and not isinstance(cache, NullCache) \
            else dict
        lineage = None
        if ngram is not None:
            rows = ngram.form_ngram(rows, schema)
            if transform_spec is not None:
                rows = [{offset: _apply_transform(copy(row), transform_spec)
                         for offset, row in window.items()} for window in rows]
        else:
            if transform_spec is not None:
                rows = [_apply_transform(copy(row), transform_spec) for row in rows]
            if rows:
                tier = 'decode' if decoded else cache.lineage_tier
                lineage = chunk_lineage(piece, piece_index, shuffle_row_drop_partition,
                                        len(rows), tier, filtered=worker_predicate is not None,
                                        worker_id=self.worker_id)
        if not rows:
            self._publish_hole(pst_det)
            return
        payload = {'key': chunk_key(piece_index, shuffle_row_drop_partition), 'rows': rows,
                   'lineage': lineage, 'timings': timings}
        if pst_det is not None:
            payload['det'] = pst_det
        with get_global_tracer().span('handoff', 'worker'):
            self.publish_func(payload)

    def _load_rows_with_predicate(self, piece, predicate, timings):
        """The decoded rows ``predicate`` keeps
        (``petastorm_tpu/py_dict_worker.py:147-190``)."""
        schema = self.args['schema']
        full_schema = self.args['full_schema']
        fields = sorted(predicate.get_fields())
        unknown = set(fields) - set(full_schema.fields)
        if unknown:
            raise ValueError('Predicate uses unknown fields: {}'.format(sorted(unknown)))
        t0 = time.perf_counter()
        pred_table = self._read_fields(piece, fields)
        timings['read_s'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        pred_rows = decode_table_to_rows(pred_table, full_schema.create_schema_view(fields))
        kept = [i for i, row in enumerate(pred_rows) if predicate.do_include(row)]
        timings['decode_s'] = time.perf_counter() - t0
        if not kept:
            return []
        others = [n for n in schema.fields if n not in fields]
        if not others:
            return [{k: v for k, v in pred_rows[i].items() if k in schema.fields} for i in kept]
        t0 = time.perf_counter()
        table = self._read_fields(piece, others).take(pa.array(kept))
        timings['read_s'] += time.perf_counter() - t0
        t0 = time.perf_counter()
        rows = decode_table_to_rows(table, schema.create_schema_view(others))
        for i, row in zip(kept, rows):
            row.update((k, v) for k, v in pred_rows[i].items() if k in schema.fields)
        timings['decode_s'] += time.perf_counter() - t0
        return rows


def _copy_row(row):
    return {k: np.array(v) if isinstance(v, np.ndarray) else v for k, v in row.items()}


def _apply_transform(row, transform_spec):
    out = transform_spec.func(row)
    for name in transform_spec.removed_fields:
        out.pop(name, None)
    return out
