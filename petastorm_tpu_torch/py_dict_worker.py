"""Per-row row-group worker (counterpart of ``petastorm_tpu/py_dict_worker.py:20-147``).

Each row-group is read with pyarrow and every row's fields are decoded
through the port's codecs into one dict of user-facing values per row:
ndarrays, numpy scalars and strings, images of any size (a field with
``None`` dims). The worker publishes the rows of each row-group with their
chunk key and provenance segment; the reader hands them out one at a time.

With a cache (``cache_type='memory'`` or ``'local-disk'``, where the rows
are pickled) the row-group's decoded rows are kept and served to every
later epoch, so their arrays are published read-only. Predicates,
``transform_spec``, row-drop partitions and NGram windows of the JAX worker
are not ported.
"""

import hashlib
import time

import numpy as np

from petastorm_tpu_torch.cache import NullCache
from petastorm_tpu_torch.checkpoint import chunk_key
from petastorm_tpu_torch.errors import DecodeFieldError
from petastorm_tpu_torch.lineage import chunk_lineage
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
    """Publishes ``{'key', 'rows': [dict, ...], 'lineage', 'timings'}`` per
    non-empty row-group, plus ``'det'`` in deterministic mode (an empty
    row-group publishes a hole marker then). ``args`` also holds ``cache``
    and ``dataset_path_hash``."""

    batched_output = False
    #: Reader mode of provenance contexts: replay decodes by it.
    lineage_mode = 'py_dict'

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
            t0 = time.perf_counter()
            rows = decode_table_to_rows(table, schema)
            timings['decode_s'] = time.perf_counter() - t0
            return rows

        cache = self.args['cache']
        if isinstance(cache, NullCache):
            rows = load()
        else:
            key = 'rows:{}:{}:{}:{}'.format(
                self.args['dataset_path_hash'], piece.path, piece.row_group,
                hashlib.md5(','.join(schema.fields).encode()).hexdigest()[:8])
            t0 = time.perf_counter()
            rows = _read_only(cache.get(key, load))
            timings['cache_s'] = (time.perf_counter() - t0 - timings.get('read_s', 0.0)
                                  - timings.get('decode_s', 0.0))
        row_slice = compute_row_slice(len(rows), shuffle_row_drop_partition)
        if row_slice is not None:
            rows = rows[row_slice[0]:row_slice[1]]
        if not rows:
            self._publish_hole(pst_det)
            return
        tier = 'decode' if decoded else cache.lineage_tier
        payload = {'key': chunk_key(piece_index, shuffle_row_drop_partition), 'rows': rows,
                   'lineage': chunk_lineage(piece, piece_index, shuffle_row_drop_partition,
                                            len(rows), tier, worker_id=self.worker_id),
                   'timings': timings}
        if pst_det is not None:
            payload['det'] = pst_det
        self.publish_func(payload)
