"""Readers: per-row (``make_reader``), decoded-columnar
(``make_tensor_reader``) and columnar over any Parquet store
(``make_batch_reader``); counterparts of ``petastorm_tpu/reader.py:116-446``
and of the ``Reader`` at ``:633-1536``.

``make_reader`` yields one namedtuple per row (any field: ragged images,
strings, nullable values); ``make_tensor_reader`` yields one namedtuple of
``[rows, ...field.shape]`` numpy blocks per row-group; ``make_batch_reader``
yields one namedtuple of column arrays per row-group of a store that any
Parquet writer made, its schema inferred from the Arrow schema when the
store carries none (:func:`~petastorm_tpu_torch.etl.dataset_metadata.
infer_or_load_unischema`). One :class:`Reader` serves all three, through
its worker class. Row-groups are sharded by
``index % shard_count == cur_shard`` and, per epoch, shuffled by
``random.Random(seed)`` as in the JAX package, so one seed gives both
packages the same row-group order. Every cache tier of
``petastorm_tpu/reader.py:76-113`` is ported: ``'null'``, ``'memory'``,
``'local-disk'`` (``cache_location``; Arrow tables in IPC files for the
batch reader) and, on the tensor path, ``'chunk-store'``
(:mod:`~petastorm_tpu_torch.chunk_store`, whose directory
``PSTT_CHUNK_STORE`` can also give, and which that variable arms for the
default ``cache_type=None``). Every pool of ``petastorm_tpu/reader.py:41-73``:
``'thread'``, ``'dummy'``, and worker processes over shared-memory rings
or zmq sockets (``'process'``, ``'process-shm'``, ``'process-zmq'``;
:mod:`~petastorm_tpu_torch.workers.supervision` respawns a dead worker).

Autotune (``petastorm_tpu/reader.py:169-174, 922-960, 1036-1128``):
``autotune=`` (``True`` or an :class:`~petastorm_tpu_torch.autotune.
AutotuneConfig`; ``None`` defers to ``PSTT_AUTOTUNE``) arms an
:class:`~petastorm_tpu_torch.autotune.AutoTuner` over the reader's knobs:
``workers`` (a thread pool's live resize, the ventilator's cap kept at
workers + 2), ``decode_threads`` (the decode-thread budget's total, while
the reader holds a share of it) and ``results_watermark`` (capacity means
unarmed). Where OpenCV or PIL decodes, both holding the GIL between
images, ``workers`` and ``decode_threads`` stop at the host's cores. A process or dummy pool cannot resize, so it exposes no
``workers`` knob, and a reader of one alone arms no tuner. A chunk store's
writer is throttled while the tuner blames the pipeline. A ``TorchLoader``
over the reader adopts its knobs (:meth:`Reader.adopt_autotune`), so one
controller tunes the pipeline; ``diagnostics()['autotune']`` holds the
tuner's log and trajectory.

Health (``petastorm_tpu/reader.py:135-167, 922-972, 1130-1185, 1508-1509``):
``watchdog=``/``stall_timeout_s=`` (or ``PSTT_WATCHDOG``) arm a
:class:`~petastorm_tpu_torch.health.HealthMonitor`.
:meth:`Reader.attach_health` registers the ``ventilator``,
``reader-handoff`` and ``worker-pool`` heartbeats, the ``worker-pool``,
``memory`` and (deterministic mode) ``resequencer`` probes, and a soft
recovery that wakes the ventilator on ``reader-starved`` and
``worker-pool-dead``. A ``TorchLoader`` over the reader attaches it to its
own registry (one watchdog for the pipeline; the reader's own stops); a
reader used alone owns its monitor, whose hard stall is raised by ``next``
as a :class:`~petastorm_tpu_torch.errors.PipelineStallError`, also from
inside a wait on the pool. ``diagnostics()['watchdog']`` holds its
counts, its last diagnosis and the beat table.

Storage (``petastorm_tpu/reader.py:177, 1528-1536``): ``dataset_url`` is
any store :mod:`~petastorm_tpu_torch.fs` resolves (``file://``, ``gs://``,
``s3://``, ``memory://``, ``hdfs://``, ...) and ``storage_options`` the
fsspec driver's keyword arguments; the workers open their files through a
picklable ``_StoreFactory`` of both.

Failure model (``petastorm_tpu/reader.py:525-612, 821-854, 1492-1510``):
with ``error_budget`` set, a worker whose row-group fails to read or decode
(``errors.QUARANTINE_EXCEPTION_TYPES``) skips it and reports it; the
reader's :class:`QuarantineLog` records each distinct item once (a poison
row-group read again in a later epoch bumps its ``occurrences``), counts
``pst_rowgroups_quarantined_total`` and raises
:class:`~petastorm_tpu_torch.errors.RowGroupQuarantinedError` from ``next``
once more items than the budget were quarantined. In deterministic mode the
quarantined item's sequence hole is filled first
(``Resequencer.mark_satisfied``), so the stream goes on in order.
:meth:`Reader.diagnostics` lists the records.

Row selection and transforms (``petastorm_tpu/reader.py:116-345, 825-835,
1192-1235``): a ``rowgroup_selector`` picks row-groups through a stored
index (:mod:`~petastorm_tpu_torch.selectors`), a ``predicate`` on
partition fields alone prunes row-groups and any other runs in the workers
(:mod:`~petastorm_tpu_torch.predicates`), then the shard. Each row-group is
ventilated ``shuffle_row_drop_partitions`` times, once a slice of its rows.
A ``transform_spec`` (:mod:`~petastorm_tpu_torch.transform`) runs in the
workers, ``shuffle_rows_in_chunk`` permutes each tensor chunk's rows the
same way in every epoch, and ``make_reader(schema_fields=NGram(...))``
yields windows of rows (:mod:`~petastorm_tpu_torch.ngram`).

Decode (``petastorm_tpu/reader.py:789-818, 917``): a reader whose schema
has an image field registers its pool's workers with the process's
decode-thread budget (:mod:`~petastorm_tpu_torch.decode_budget`) and
releases them when it stops; each worker's batched native decode takes its
live share. ``make_tensor_reader(raw_image_fields=...)`` ships image fields
encoded, for a ``TorchLoader`` to decode at its staging step.
:attr:`Reader.decoder` names the image decoder and the Parquet stage in
use, with the reason a native one is not.

Each reader registers its byte-holding pools with the host memory governor
(:mod:`~petastorm_tpu_torch.membudget`, ``petastorm_tpu/reader.py:965-
1050``): ``results-queue`` (its shed hook paces ventilation),
``memory-cache``, ``chunk-store`` and ``resequencer``; it arms the governor
when ``PSTT_HOST_MEM_BUDGET`` is set, and a breach raises
:class:`~petastorm_tpu_torch.errors.HostMemoryExceededError` from ``next``.

Resume (``petastorm_tpu/reader.py:711-790, 1291-1460``): ``state_dict()``
is a JSON-safe position that a new reader built with ``resume_state=`` and
the same configuration continues from, in either package: the config
fingerprint and the cursors are the JAX package's key for key. The default
mode tracks consumption per chunk (:mod:`~petastorm_tpu_torch.checkpoint`,
multiset-exact); ``deterministic=True`` makes the stream a pure function of
``(dataset, fields, seed, epoch, position)`` and its state a stream cursor
(:mod:`~petastorm_tpu_torch.determinism`). Every chunk carries its
provenance segment (:mod:`~petastorm_tpu_torch.lineage`).
"""

import hashlib
import logging
import os
import threading
import warnings
from collections import deque

import numpy as np

from petastorm_tpu_torch import autotune as autotune_mod
from petastorm_tpu_torch import chunk_store as chunk_store_mod
from petastorm_tpu_torch import decode_budget, determinism, faults, membudget, metrics
from petastorm_tpu_torch.arrow_worker import ArrowWorker, restack_list_columns
from petastorm_tpu_torch.cache import (LocalDiskArrowTableCache, LocalDiskCache, MemoryCache,
                                       NullCache)
from petastorm_tpu_torch.checkpoint import ConsumptionTracker, DeferredRowAccounting
from petastorm_tpu_torch.codecs import CompressedImageCodec, decode_path, decoder_info
from petastorm_tpu_torch.errors import (NoDataAvailableError, PetastormMetadataError,
                                        PipelineStallError, RowGroupQuarantinedError)
from petastorm_tpu_torch.etl.dataset_metadata import get_schema, infer_or_load_unischema
from petastorm_tpu_torch.health import (READER_STARVED, WORKER_POOL_DEAD,
                                        PipelineSupervisor)
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.py_dict_worker import PyDictWorker
from petastorm_tpu_torch.storage import ParquetStore
from petastorm_tpu_torch.tensor_worker import TensorWorker, validate_tensor_schema
from petastorm_tpu_torch.transform import TransformSpec, transform_schema
from petastorm_tpu_torch.unischema import match_unischema_fields
from petastorm_tpu_torch.workers import EmptyResultError
from petastorm_tpu_torch.workers.dummy_pool import DummyPool
from petastorm_tpu_torch.workers.supervision import SupervisedPoolMixin
from petastorm_tpu_torch.workers.thread_pool import ThreadPool
from petastorm_tpu_torch.workers.ventilator import ConcurrentVentilator

logger = logging.getLogger(__name__)

#: Row-groups ventilated beyond the worker count, as in the JAX reader.
_VENTILATE_EXTRA_ROWGROUPS = 2


def _make_cache(cache_type, cache_location, cache_size_limit, tensor_path=False,
                arrow_cache=False, **extra):
    """The row-group cache of ``petastorm_tpu/reader.py:76-113``
    (``arrow_cache``: the batch reader's, whose local-disk tier stores Arrow
    tables)."""
    if cache_type is None:
        # Only the default is armed by the variable: an explicit 'null'
        # stays a genuine no-cache.
        if tensor_path and os.environ.get(chunk_store_mod.ENV_VAR):
            return chunk_store_mod.DecodedChunkStore(size_limit=cache_size_limit, **extra)
        return NullCache()
    if cache_type == 'null':
        return NullCache()
    if cache_type == 'local-disk':
        if cache_location is None:
            raise ValueError("cache_type='local-disk' requires cache_location")
        cls = LocalDiskArrowTableCache if arrow_cache else LocalDiskCache
        return cls(cache_location, size_limit=cache_size_limit, **extra)
    if cache_type == 'memory':
        return MemoryCache(size_limit_bytes=cache_size_limit)
    if cache_type == 'chunk-store':
        if not tensor_path:
            raise ValueError(
                "cache_type='chunk-store' serves decoded tensor chunks: use make_tensor_reader "
                "(make_reader/make_batch_reader values cannot be stored; use 'local-disk' "
                'there)')
        return chunk_store_mod.DecodedChunkStore(path=cache_location, size_limit=cache_size_limit,
                                                 **extra)
    raise ValueError('Unknown cache_type {!r}'.format(cache_type))


def _make_pool(reader_pool_type, workers_count, results_queue_size, shm_result_ring_bytes=None,
               profiling=False):
    """The pool of ``petastorm_tpu/reader.py:41-73``: ``'process'`` takes
    the shared-memory rings when they build, else zmq (``diagnostics()
    ['transport']`` says which); ``'process-shm'`` and ``'process-zmq'``
    pin one and raise when it is missing. ``profiling`` profiles a thread
    pool's workers; another pool warns that it ignores it."""
    if reader_pool_type == 'thread':
        return ThreadPool(workers_count, results_queue_size, profiling_enabled=profiling)
    if profiling:
        warnings.warn('pool_profiling is only supported by the thread pool; ignoring for '
                      '{!r}'.format(reader_pool_type))
    if reader_pool_type == 'dummy':
        return DummyPool()
    if reader_pool_type not in ('process', 'process-shm', 'process-zmq'):
        raise ValueError('Unknown reader_pool_type {!r}; expected '
                         'thread|process|process-shm|process-zmq|dummy'.format(reader_pool_type))
    from petastorm_tpu_torch.workers.process_pool import ProcessPool, zmq_available
    from petastorm_tpu_torch.workers.shm_process_pool import (ShmProcessPool,
                                                              shm_transport_available)
    if reader_pool_type != 'process-zmq':
        if shm_transport_available():
            extra = {'result_ring_bytes': shm_result_ring_bytes} if shm_result_ring_bytes else {}
            return ShmProcessPool(workers_count, results_queue_size, **extra)
        if reader_pool_type == 'process-shm':
            from petastorm_tpu_torch.native import shm_ring
            raise RuntimeError('process-shm pool requested but the native shm transport failed '
                               'to build: {}'.format(shm_ring.load_error()))
    if not zmq_available():
        raise RuntimeError('reader_pool_type={!r} needs pyzmq, which does not import{}'.format(
            reader_pool_type, '' if reader_pool_type == 'process-zmq'
            else ', or the native shm transport, which did not build'))
    return ProcessPool(workers_count, results_queue_size)


def _stored_schema(store, factory):
    try:
        return get_schema(store)
    except PetastormMetadataError as e:
        raise RuntimeError('{} requires a petastorm_tpu (codec-materialized) dataset. Use '
                           'make_batch_reader for plain Parquet stores: {}'.format(factory, e))


def _view(stored_schema, schema_fields):
    if schema_fields is None:
        return stored_schema
    return stored_schema.create_schema_view(
        match_unischema_fields(stored_schema, schema_fields, allow_empty_match=False))


def _check_selection_args(predicate, transform_spec, shuffle_row_drop_partitions):
    """Refuse what the workers could not run, before any thread starts."""
    if predicate is not None and not (callable(getattr(predicate, 'get_fields', None))
                                      and callable(getattr(predicate, 'do_include', None))):
        raise ValueError('predicate must have get_fields() and do_include(values) (a '
                         'petastorm_tpu_torch.predicates class), got {!r}'.format(predicate))
    if transform_spec is not None and not isinstance(transform_spec, TransformSpec):
        raise ValueError('transform_spec must be a petastorm_tpu_torch.transform.TransformSpec, '
                         'got {!r}'.format(transform_spec))
    if not isinstance(shuffle_row_drop_partitions, int) or shuffle_row_drop_partitions < 1:
        raise ValueError('shuffle_row_drop_partitions must be an int >= 1, got {!r}'.format(
            shuffle_row_drop_partitions))


def _describe_filter(obj):
    """A JSON-safe descriptor of a predicate or selector for the resume
    fingerprint and the provenance context: its type and fields, as the JAX
    package describes it (``petastorm_tpu/reader.py:616-630``)."""
    if obj is None:
        return None
    desc = {'type': type(obj).__name__}
    get_fields = getattr(obj, 'get_fields', None)
    if callable(get_fields):
        try:
            desc['fields'] = sorted(get_fields())
        except Exception:  # noqa: BLE001 - a user predicate's own failure
            pass
    return desc


def make_reader(dataset_url, schema_fields=None, reader_pool_type='thread', workers_count=10,
                results_queue_size=50, shuffle_row_groups=True, shuffle_row_drop_partitions=1,
                seed=None, predicate=None, rowgroup_selector=None, num_epochs=1,
                cur_shard=None, shard_count=None, cache_type=None, cache_location=None,
                cache_size_limit=None, cache_extra_settings=None, transform_spec=None,
                resume_state=None, deterministic=False, storage_options=None,
                error_budget=None, watchdog=None, stall_timeout_s=None,
                shm_result_ring_bytes=None, pool_profiling=False, autotune=None):
    """Reader of decoded rows, one namedtuple per row.

    The arguments are ``make_tensor_reader``'s, except
    ``shuffle_rows_in_chunk`` and ``raw_image_fields``. Fields of any shape
    are read: an image field with ``None`` dims decodes at each row's own
    size. ``cache_type='chunk-store'`` raises (rows cannot be stored in its
    layout; ``'local-disk'`` can). ``transform_spec.func`` takes and returns
    one row's dict. ``schema_fields`` may be an
    :class:`~petastorm_tpu_torch.ngram.NGram`: the reader then yields one
    dict ``{offset: namedtuple}`` per window of consecutive rows (within a
    row-group); non-overlapping windows with ``shuffle_row_drop_partitions
    > 1`` raise ``NotImplementedError``.
    """
    _check_selection_args(predicate, transform_spec, shuffle_row_drop_partitions)
    store = ParquetStore(dataset_url, storage_options)
    stored_schema = _stored_schema(store, 'make_reader')
    ngram = None
    if isinstance(schema_fields, NGram):
        ngram, schema_fields = schema_fields, None
        if not ngram.timestamp_overlap and shuffle_row_drop_partitions > 1:
            raise NotImplementedError('shuffle_row_drop_partitions with non-overlapping ngrams '
                                      'is not supported')
        ngram.resolve_regex_field_names(stored_schema)
        schema_fields = [n for n in ngram.get_field_names_at_all_timesteps()
                         if n in stored_schema.fields]
    view = _view(stored_schema, schema_fields)
    cache = _make_cache(cache_type, cache_location, cache_size_limit,
                        **(cache_extra_settings or {}))
    pool = _make_pool(reader_pool_type, workers_count, results_queue_size,
                      shm_result_ring_bytes, pool_profiling)
    return Reader(store, view, pool, worker_class=PyDictWorker, full_schema=stored_schema,
                  shuffle_row_groups=shuffle_row_groups,
                  shuffle_row_drop_partitions=shuffle_row_drop_partitions, seed=seed,
                  predicate=predicate, rowgroup_selector=rowgroup_selector, num_epochs=num_epochs,
                  cur_shard=cur_shard, shard_count=shard_count, cache=cache,
                  transform_spec=transform_spec, ngram=ngram, resume_state=resume_state,
                  deterministic=deterministic, error_budget=error_budget, watchdog=watchdog,
                  stall_timeout_s=stall_timeout_s, autotune=autotune)


def make_tensor_reader(dataset_url, schema_fields=None, reader_pool_type='thread',
                       workers_count=10, results_queue_size=50, shuffle_row_groups=True,
                       shuffle_row_drop_partitions=1, seed=None, predicate=None,
                       rowgroup_selector=None, num_epochs=1, cur_shard=None, shard_count=None,
                       cache_type=None, cache_location=None, cache_size_limit=None,
                       cache_extra_settings=None, transform_spec=None, resume_state=None,
                       deterministic=False, shuffle_rows_in_chunk=False,
                       raw_image_fields=None, storage_options=None, error_budget=None,
                       watchdog=None, stall_timeout_s=None, shm_result_ring_bytes=None,
                       pool_profiling=False, autotune=None):
    """Reader of decoded column blocks, one namedtuple per row-group.

    :param schema_fields: fields or full-match regex patterns to read
        (default: all).
    :param reader_pool_type: ``'thread'``, ``'dummy'`` (the work runs on
        the consumer's thread), or worker processes: ``'process'`` (over
        shared-memory rings, else zmq), ``'process-shm'`` or
        ``'process-zmq'``. A process worker imports no ``torch`` and decodes
        on a static share of the decode-thread budget.
    :param shuffle_row_drop_partitions: ventilate each row-group this many
        times, each time one contiguous slice of its rows, so a row-group's
        rows spread over the epoch (1: whole row-groups).
    :param predicate: a :mod:`~petastorm_tpu_torch.predicates` object on
        scalar fields only. On partition fields alone it prunes row-groups;
        otherwise the workers read and decode its fields first and the rest
        of the kept rows only. A predicate read bypasses every cache tier.
    :param rowgroup_selector: a :mod:`~petastorm_tpu_torch.selectors`
        object; the row-groups it picks from the store's index (built by
        either package's ``build_rowgroup_index``) are read, before pruning
        and sharding.
    :param num_epochs: epochs to read; ``None`` = endless.
    :param cur_shard/shard_count: read only row-groups ``i`` with
        ``i % shard_count == cur_shard`` (deterministic mode: every
        ``shard_count``-th position of the global order).
    :param cache_type: ``None`` (the default: the chunk store when
        ``PSTT_CHUNK_STORE`` names a directory, else no cache), ``'null'``
        (decode every epoch), ``'memory'`` (decoded row-groups in RAM),
        ``'local-disk'`` (in files under ``cache_location``) or
        ``'chunk-store'`` (mmapped decoded chunks under ``cache_location``
        or ``PSTT_CHUNK_STORE``, shared across processes and with the JAX
        package). With a cache, later epochs skip read and decode.
    :param cache_location: the directory of the disk tiers.
    :param cache_size_limit: the cache's approximate byte cap (``None`` =
        no cap).
    :param cache_extra_settings: keyword arguments of the cache's
        constructor (the chunk store's ``writer_queue_depth``, ...).
    :param transform_spec: a :class:`~petastorm_tpu_torch.transform.
        TransformSpec` whose ``func`` takes and returns the chunk's dict of
        column blocks (numpy in, numpy out), run in the workers after the
        drop-partition slice (on copies of cached blocks).
    :param resume_state: a ``state_dict()`` of a reader of the same
        configuration (of either package) to continue from.
    :param deterministic: seed-stable order and resequenced delivery: the
        same stream for any worker count, pool or shard count, and a
        stream cursor for ``state_dict()``.
    :param shuffle_rows_in_chunk: permute each chunk's rows in the worker,
        after the transform, by a permutation of (seed, row-group, drop
        partition): the same in every epoch and session (and in the JAX
        package), so resume stays exact; the epochs differ by the row-group
        order.
    :param raw_image_fields: image fields to ship encoded (the staging-step
        decode, ``petastorm_tpu/reader.py:273-313``): ``True`` takes every
        fixed-shape uint8 image-codec field, an iterable names them. The
        workers skip their decode and publish object columns of the JPEG/
        PNG bytes; a ``TorchLoader`` decodes them next to the copy to the
        card. Another field, ``True`` with no such field, or any together
        with ``transform_spec`` raises ``ValueError``.
    :param storage_options: the fsspec driver's keyword arguments for a
        store that is not local (credentials, project, endpoint).
    :param error_budget: ``None`` (a row-group that fails to read or decode
        ends the epoch), an int >= 0 (that many distinct row-group items may
        be quarantined: skipped and recorded; one more raises
        ``RowGroupQuarantinedError``) or a float in (0, 1) (that fraction of
        the epoch's items). ``bool`` and floats >= 1 raise ``ValueError``.
    :param watchdog: ``True`` arms the health watchdog of a reader used
        alone (a ``TorchLoader`` over it supervises it anyway when the
        loader's is armed), ``False`` keeps it off, ``None`` defers to
        ``PSTT_WATCHDOG`` (off by default).
    :param stall_timeout_s: the stages' stall deadline in seconds (a number
        or a dict stage -> seconds); a stall past twice it raises
        ``PipelineStallError`` from ``next``.
    :param shm_result_ring_bytes: each worker's result ring of the
        shared-memory pool (default 64 MiB), reserved in ``/dev/shm`` when
        the reader is built; the other pools ignore it.
    :param pool_profiling: run the thread pool's workers under ``cProfile``
        and print their profile when the reader joins.
    :param autotune: ``True`` or an :class:`~petastorm_tpu_torch.autotune.
        AutotuneConfig` arms the autotuner over the reader's knobs (see the
        module docstring), ``False`` keeps it off, ``None`` defers to
        ``PSTT_AUTOTUNE`` (off by default).
    """
    _check_selection_args(predicate, transform_spec, shuffle_row_drop_partitions)
    if isinstance(schema_fields, NGram):
        raise NotImplementedError('NGram is not supported with tensor readers; use make_reader')
    store = ParquetStore(dataset_url, storage_options)
    stored_schema = _stored_schema(store, 'make_tensor_reader')
    view = _view(stored_schema, schema_fields)
    validate_tensor_schema(view)
    raw_image_fields = _resolve_raw_image_fields(view, raw_image_fields)
    if raw_image_fields and transform_spec is not None:
        raise ValueError('raw_image_fields is incompatible with transform_spec: tensor transforms '
                         'operate on decoded column blocks, but raw fields ship encoded bytes '
                         '(augment on the card through TorchLoader(on_device_augment=...) '
                         'instead)')
    if predicate is not None:
        bad = [f for f in predicate.get_fields()
               if f in stored_schema.fields and stored_schema.fields[f].shape != ()]
        if bad:
            raise ValueError('Tensor-reader predicates may only reference scalar fields; got '
                             'tensor fields {}'.format(bad))
    cache = _make_cache(cache_type, cache_location, cache_size_limit, tensor_path=True,
                        **(cache_extra_settings or {}))
    pool = _make_pool(reader_pool_type, workers_count, results_queue_size,
                      shm_result_ring_bytes, pool_profiling)
    return Reader(store, view, pool, worker_class=TensorWorker, full_schema=stored_schema,
                  shuffle_row_groups=shuffle_row_groups,
                  shuffle_row_drop_partitions=shuffle_row_drop_partitions, seed=seed,
                  predicate=predicate, rowgroup_selector=rowgroup_selector,
                  num_epochs=num_epochs, cur_shard=cur_shard, shard_count=shard_count,
                  cache=cache, transform_spec=transform_spec, resume_state=resume_state,
                  deterministic=deterministic, shuffle_rows_in_chunk=shuffle_rows_in_chunk,
                  raw_image_fields=raw_image_fields, error_budget=error_budget,
                  watchdog=watchdog, stall_timeout_s=stall_timeout_s, autotune=autotune)


def make_batch_reader(dataset_url, schema_fields=None, reader_pool_type='thread',
                      workers_count=10, results_queue_size=50, shuffle_row_groups=True,
                      shuffle_row_drop_partitions=1, seed=None, predicate=None,
                      rowgroup_selector=None, num_epochs=1, cur_shard=None, shard_count=None,
                      cache_type='null', cache_location=None, cache_size_limit=None,
                      cache_row_size_estimate=None, cache_extra_settings=None,
                      transform_spec=None, resume_state=None, shuffle_rows_in_chunk=False,
                      deterministic=False, storage_options=None, error_budget=None,
                      watchdog=None, stall_timeout_s=None, shm_result_ring_bytes=None,
                      pool_profiling=False, autotune=None):
    """Reader of column arrays, one namedtuple per row-group, over any
    Parquet store (``petastorm_tpu/reader.py:382-446``).

    The schema is the store's when it has one (a petastorm store: a warning
    says that its columns come out encoded), else inferred from the Arrow
    schema: a list column is a ``(None,)`` field that arrives as a ``[rows,
    L]`` block when a row-group's rows have one length, strings, binary and
    decimals as object arrays. The arguments are ``make_tensor_reader``'s,
    except that ``schema_fields`` takes field names or full-match regexes
    only, a ``predicate`` tests rows of a pandas DataFrame (any field), a
    ``transform_spec.func`` takes and returns a pandas DataFrame, and
    ``cache_type='local-disk'`` stores each row-group's Arrow table in the
    IPC format (``'chunk-store'`` raises). ``cache_row_size_estimate`` is
    accepted and unused, as in the JAX package. A ``resume_state`` of
    either package's batch reader resumes the other.
    """
    _check_selection_args(predicate, transform_spec, shuffle_row_drop_partitions)
    store = ParquetStore(dataset_url, storage_options)
    try:
        get_schema(store)
        warnings.warn('Dataset at {} is a petastorm_tpu store: consider using make_reader for '
                      'codec-decoded rows. make_batch_reader will return raw (encoded) '
                      'columns.'.format(dataset_url))
    except PetastormMetadataError:
        pass
    stored_schema = infer_or_load_unischema(store)
    if schema_fields is not None and not all(isinstance(f, str) for f in schema_fields):
        raise ValueError('make_batch_reader schema_fields must be field-name strings/regexes')
    view = _view(stored_schema, schema_fields)
    cache = _make_cache(cache_type, cache_location, cache_size_limit, arrow_cache=True,
                        **(cache_extra_settings or {}))
    pool = _make_pool(reader_pool_type, workers_count, results_queue_size,
                      shm_result_ring_bytes, pool_profiling)
    return Reader(store, view, pool, worker_class=ArrowWorker, full_schema=stored_schema,
                  shuffle_row_groups=shuffle_row_groups,
                  shuffle_row_drop_partitions=shuffle_row_drop_partitions, seed=seed,
                  predicate=predicate, rowgroup_selector=rowgroup_selector,
                  num_epochs=num_epochs, cur_shard=cur_shard, shard_count=shard_count,
                  cache=cache, transform_spec=transform_spec, resume_state=resume_state,
                  deterministic=deterministic, shuffle_rows_in_chunk=shuffle_rows_in_chunk,
                  error_budget=error_budget, watchdog=watchdog, stall_timeout_s=stall_timeout_s,
                  autotune=autotune)


def _resolve_raw_image_fields(view, raw_image_fields):
    """``raw_image_fields`` checked and expanded to a tuple of names, with
    the JAX package's errors (``petastorm_tpu/reader.py:346-380``)."""
    if not raw_image_fields:
        return ()

    def eligible(field):
        return (isinstance(field.resolved_codec(), CompressedImageCodec) and field.shape
                and not any(d is None for d in field.shape)
                and np.dtype(field.numpy_dtype) == np.uint8)

    if raw_image_fields is True:
        names = tuple(n for n, f in view.fields.items() if eligible(f))
        if not names:
            raise ValueError('raw_image_fields=True but the schema view has no fixed-shape '
                             'uint8 image-codec field to ship raw')
        return names
    names = tuple(raw_image_fields)
    for name in names:
        if name not in view.fields:
            raise ValueError('raw_image_fields names unknown field {!r}'.format(name))
        if not eligible(view.fields[name]):
            raise ValueError('raw_image_fields field {!r} is not a fixed-shape uint8 '
                             'image-codec field — only those can defer decode to the staging '
                             'step'.format(name))
    return names


def host_cores():
    """The cores this process may run on (its CPU affinity where the
    platform reports it, else the host's count)."""
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:
        return os.cpu_count() or 4


def _has_image_fields(schema):
    return any(isinstance(f.resolved_codec(), CompressedImageCodec)
               for f in schema.fields.values())


def make_pod_reader(dataset_url, reader_factory=None, pod_shard=None, mesh=None,
                    batch_axis='data', **kwargs):
    """A reader of this rank's data shard (``petastorm_tpu/reader.py:449-495``).

    ``cur_shard``/``shard_count`` come from
    :func:`~petastorm_tpu_torch.parallel.mesh.process_shard`: the rank's
    coordinate along ``batch_axis`` of ``mesh`` and that axis's size, so
    ranks that differ only on a tensor, sequence, expert or pipeline axis
    read the same rows (without a mesh, the rank and world of the default
    group). Every rank calls it alike; feed the result to a
    ``TorchLoader(..., mesh=mesh)``.

    :param reader_factory: the factory to wrap (default
        :func:`make_tensor_reader`; :func:`make_reader` for rows,
        :func:`make_batch_reader` for a plain Parquet store).
    :param pod_shard: ``(cur_shard, shard_count)`` overriding the mapping
        (simulated ranks in one process, or a launcher with its own).
    :param kwargs: forwarded to the factory (``watchdog`` and
        ``stall_timeout_s`` among them); ``cur_shard`` or ``shard_count``
        among them raises, since the mapping owns them.

    With ``deterministic=True`` the shards are strides of one global order,
    so their round-robin interleave is the one-rank stream for every shard
    count.
    """
    if 'cur_shard' in kwargs or 'shard_count' in kwargs:
        raise ValueError(
            'make_pod_reader owns cur_shard/shard_count (it maps them to the rank\'s '
            'coordinate on the mesh\'s batch axis); pass pod_shard=(i, n) to override, or '
            'call the underlying factory directly')
    if reader_factory is None:
        reader_factory = make_tensor_reader
    if pod_shard is None:
        from petastorm_tpu_torch.parallel.mesh import process_shard
        pod_shard = process_shard(mesh, batch_axis)
    cur_shard, shard_count = int(pod_shard[0]), int(pod_shard[1])
    if shard_count > 1:
        return reader_factory(dataset_url, cur_shard=cur_shard, shard_count=shard_count,
                              **kwargs)
    # A one-shard stride is the whole stream: no sharding arguments at all.
    return reader_factory(dataset_url, **kwargs)


def _check_resume_state(resume_state, deterministic, fingerprint):
    """The refusals and the config-drift warning of
    ``petastorm_tpu/reader.py:732-767``."""
    if not deterministic and resume_state.get('mode') == determinism.MODE:
        raise ValueError('resume_state is a deterministic-mode stream cursor; build the resumed '
                         'reader with deterministic=True (a multiset tracker would silently '
                         'ignore it)')
    if (deterministic and not resume_state.get('merged')
            and int(resume_state.get('shard_count') or 1) > 1):
        raise ValueError(
            "resume_state is host {} of {}'s private cursor; a multi-host deterministic resume "
            "must pass ALL hosts' cursors through determinism.merge_cursors() and give every "
            'resuming host the single merged result'.format(
                resume_state.get('cur_shard'), resume_state.get('shard_count')))
    stored = resume_state.get('config')
    if stored is not None:
        # Only keys both sides know: a state of another version lacks some.
        differing = sorted(k for k in set(stored) & set(fingerprint)
                           if stored[k] != fingerprint[k])
        if differing:
            warnings.warn('resume_state was captured under a different reader configuration '
                          '(differing: {}); resume positions may be meaningless'.format(differing))


class _CallableDict(dict):
    """A dict that also answers ``()`` with itself: ``Reader.diagnostics``
    reads as a mapping and as a call, as in the JAX package."""

    def __call__(self):
        return self


class QuarantineLog(object):
    """The consumer's record of quarantined row-group items and the error
    budget (``petastorm_tpu/reader.py:525-612``).

    The budget counts distinct ventilated items (row-group x drop
    partition): a poison row-group read again in a later epoch bumps its
    record's ``occurrences`` and spends nothing more. ``budget`` is ``None``
    (quarantine off: the workers raise), an int >= 0 (that many items
    absorbed, one more raises) or a float in (0, 1) (that fraction of the
    epoch's items); ``bool`` and floats >= 1 (is 1.0 one item or all of
    them?) are refused."""

    def __init__(self, budget, total_items, row_groups):
        self._lock = threading.Lock()
        self._row_groups = row_groups
        self._records = []
        self._by_item = {}
        self.enabled = budget is not None
        if budget is None:
            self._max = 0
        elif isinstance(budget, bool):
            raise ValueError('error_budget must be None, an int >= 0, or a fraction in (0, 1); '
                             'got {!r}'.format(budget))
        elif isinstance(budget, int) and budget >= 0:
            self._max = budget
        elif isinstance(budget, float) and 0 < budget < 1:
            self._max = int(budget * total_items)
        else:
            raise ValueError('error_budget must be None, an int >= 0, or a fraction in (0, 1); '
                             'got {!r}'.format(budget))
        self.budget = self._max

    def record(self, quarantine):
        """The pools' sink: record the quarantine; raise
        ``RowGroupQuarantinedError`` once past the budget."""
        entry = {'worker_id': quarantine.worker_id, 'error': quarantine.error,
                 'occurrences': 1}
        if quarantine.decode_error is not None:
            entry['decode_error'] = quarantine.decode_error
        item = quarantine.item if isinstance(quarantine.item, dict) else {}
        piece_index = item.get('piece_index')
        entry['piece_index'] = piece_index
        if 'shuffle_row_drop_partition' in item:
            entry['shuffle_row_drop_partition'] = item['shuffle_row_drop_partition']
        if piece_index is not None and 0 <= piece_index < len(self._row_groups):
            piece = self._row_groups[piece_index]
            entry['path'] = piece.path
            entry['row_group'] = piece.row_group
        item_key = (piece_index, item.get('shuffle_row_drop_partition'))
        with self._lock:
            known = self._by_item.get(item_key) if piece_index is not None else None
            if known is not None:
                known['occurrences'] += 1
                return      # the same poison item in another epoch: already spent
            self._records.append(entry)
            if piece_index is not None:
                self._by_item[item_key] = entry
            over_budget = len(self._records) > self._max
            snapshot = list(self._records)
        metrics.counter('pst_rowgroups_quarantined_total',
                        'Distinct poison row-group items quarantined under '
                        'the error budget').inc()
        logger.warning('Quarantined row-group %s (%d/%d of error budget used)',
                       entry.get('path', piece_index), len(snapshot), self._max)
        if over_budget:
            raise RowGroupQuarantinedError(
                'error_budget exhausted: {} row-group item(s) quarantined, budget is {}. '
                'Latest: {} ({})'.format(len(snapshot), self._max,
                                         entry.get('path', piece_index), entry['error']),
                quarantined=snapshot)

    def snapshot(self):
        with self._lock:
            return [dict(e) for e in self._records]


class _StoreFactory(object):
    """Picklable :class:`ParquetStore` factory of the workers
    (``petastorm_tpu/reader.py:1528-1536``); a store built on an explicit
    filesystem is handed over as it is."""

    def __init__(self, store):
        self._url = store.url
        self._storage_options = store.storage_options
        self._store = store if store.scheme is None else None

    def __call__(self):
        if self._store is not None:
            return self._store
        return ParquetStore(self._url, self._storage_options)


class Reader(DeferredRowAccounting):
    """Iterates decoded rows (``worker_class=PyDictWorker``) or row-group
    chunks (``TensorWorker``, ``ArrowWorker``) off a worker pool. ``batched_output`` says
    which. ``schema`` is the view read; rows and chunks come out as
    namedtuples of the view after ``transform_spec``, or, with an
    ``ngram``, as dicts of per-offset namedtuples."""

    def __init__(self, store, schema, pool, worker_class=TensorWorker, shuffle_row_groups=True,
                 seed=None, num_epochs=1, cur_shard=None, shard_count=None, cache=None,
                 resume_state=None, deterministic=False, raw_image_fields=(), full_schema=None,
                 predicate=None, rowgroup_selector=None, shuffle_row_drop_partitions=1,
                 transform_spec=None, shuffle_rows_in_chunk=False, ngram=None,
                 error_budget=None, watchdog=None, stall_timeout_s=None, autotune=None):
        # A mistyped memory budget or fault spec fails before any thread
        # starts (a worker thread that met it would die without a word).
        membudget.validate_env_budget()
        faults.get_injector()
        if (cur_shard is None) != (shard_count is None):
            raise ValueError('cur_shard and shard_count must be specified together')
        if cur_shard is not None and not 0 <= cur_shard < shard_count:
            raise ValueError('cur_shard {} out of range [0, {})'.format(cur_shard, shard_count))
        self.schema = schema
        self.ngram = ngram
        self._transform_spec = transform_spec
        self._output_schema = (transform_schema(schema, transform_spec)
                               if transform_spec is not None else schema)
        self._store = store
        self._deterministic = bool(deterministic)
        self._seed = seed
        self._cur_shard = cur_shard
        self._shard_count = shard_count
        self._num_epochs = num_epochs
        self._predicate = predicate
        self._shuffle_rows_in_chunk = bool(shuffle_rows_in_chunk)
        self._lineage_mode = worker_class.lineage_mode
        self._raw_image_fields = tuple(raw_image_fields or ())
        self._decode_share = None
        # Deterministic mode strides the shard over the global order in the
        # ventilator, so every host keeps the whole list.
        pieces, worker_predicate = self._filter_row_groups(
            store.row_groups(), predicate, rowgroup_selector,
            None if self._deterministic else cur_shard,
            None if self._deterministic else shard_count)
        self._row_groups = pieces
        self._pool = pool
        self.cache = cache if cache is not None else NullCache()
        self.batched_output = worker_class.batched_output
        self._rows = deque()
        self._timings = {'read_s': 0.0, 'decode_s': 0.0, 'cache_s': 0.0, 'chunks': 0}
        #: Hole markers passed: items that a predicate or the drop slice left
        #: empty (deterministic mode; elsewhere an empty item publishes none).
        self.holes = 0
        self._stopped = False
        self.last_row_consumed = False
        self._last_lineage = None
        self._last_det = None
        self._rows_delivered = 0     # values handed out: the tuner's rate
        # Checkpoint keys index the filtered row-group list, so whatever
        # filters it is part of the fingerprint.
        self._config_fingerprint = {
            'url': store.url,
            'fields': sorted(schema.fields),
            'num_epochs': num_epochs,
            'cur_shard': None if self._deterministic else cur_shard,
            'shard_count': None if self._deterministic else shard_count,
            'deterministic': self._deterministic,
            'shuffle_row_groups': bool(shuffle_row_groups),
            'seed': seed if self._deterministic else None,
            'shuffle_row_drop_partitions': shuffle_row_drop_partitions,
            'shuffle_rows_in_chunk': self._shuffle_rows_in_chunk,
            'n_row_groups': len(pieces),
            'predicate': _describe_filter(predicate),
            'selector': _describe_filter(rowgroup_selector),
            'row_group_ids': [hashlib.md5('{}:{}'.format(p.path, p.row_group).encode())
                              .hexdigest()[:8] for p in pieces],
        }
        if resume_state is not None:
            _check_resume_state(resume_state, self._deterministic, self._config_fingerprint)
        self._resequencer = None
        if self._deterministic:
            if not hasattr(pool, 'set_resequencer'):
                raise ValueError('deterministic=True requires a pool that can resequence; {} '
                                 'cannot'.format(type(pool).__name__))
            self._tracker = determinism.DeterministicCursor(resume_state,
                                                            stride=shard_count or 1)
            self._resequencer = determinism.Resequencer()
            pool.set_resequencer(self._resequencer)
        else:
            self._tracker = ConsumptionTracker(resume_state, num_epochs=num_epochs)
        # Pieces x drop partitions, in the JAX package's order.
        items = [{'piece_index': i, 'worker_predicate': worker_predicate,
                  'shuffle_row_drop_partition': (drop, shuffle_row_drop_partitions)}
                 for i in range(len(pieces)) for drop in range(shuffle_row_drop_partitions)]
        # Before any thread starts: a refused budget leaves nothing to stop.
        self._quarantine_log = QuarantineLog(error_budget, len(items), pieces)
        if error_budget is not None:
            pool.quarantine_sink = self._quarantine_sink
        det_config = None
        if self._deterministic:
            if shard_count is not None and shard_count > len(items):
                raise NoDataAvailableError(
                    'deterministic shard stride needs at least one item per shard: {} items < '
                    '{} shards'.format(len(items), shard_count))
            self._tracker.normalize(len(items))
            det_config = {'seed': seed, 'shuffle': bool(shuffle_row_groups),
                          'cur_shard': cur_shard or 0, 'shard_count': shard_count or 1,
                          'start_epoch': self._tracker.start_epoch,
                          'start_pos': self._tracker.start_pos}
        self._ventilator = ConcurrentVentilator(
            ventilate_fn=None,   # bound by pool.start
            items_to_ventilate=items,
            iterations=num_epochs,
            randomize_item_order=shuffle_row_groups and not self._deterministic,
            random_seed=seed,
            max_ventilation_queue_size=pool.workers_count + _VENTILATE_EXTRA_ROWGROUPS,
            deterministic=det_config)
        dataset_path_hash = hashlib.md5(store.url.encode()).hexdigest()[:12]
        if self.chunk_store is not None and worker_predicate is None:
            # The store's readahead rides the dispatch order: the moment a
            # row-group is scheduled, its entry's pages are asked for (a
            # predicate read bypasses the store).
            readahead = self.chunk_store.readahead
            keys = [chunk_store_mod.tensor_chunk_key(dataset_path_hash, p.path, p.row_group,
                                                     schema) for p in pieces]

            def on_ventilate(item):
                readahead(keys[item['piece_index']])

            self._ventilator.on_ventilate = on_ventilate
        # A process pool's workers cannot share this process's budget live:
        # each gets a static share of its total (``petastorm_tpu/reader.py:
        # 785-800``).
        self._in_process_pool = not isinstance(pool, SupervisedPoolMixin)
        self._static_decode_threads = (
            None if self._in_process_pool
            else max(1, decode_budget.get_budget().total // pool.workers_count))
        pool.start(worker_class, {
            'store_factory': _StoreFactory(store), 'decode_threads': self._static_decode_threads,
            'quarantine_poison_rowgroups': error_budget is not None,
            'row_groups': pieces, 'schema': schema,
            'full_schema': full_schema if full_schema is not None else schema,
            'cache': self.cache, 'dataset_path_hash': dataset_path_hash,
            'raw_image_fields': self._raw_image_fields, 'ngram': ngram,
            'transform_spec': transform_spec, 'transformed_schema': self._output_schema,
            'shuffle_rows_in_chunk': self._shuffle_rows_in_chunk, 'shuffle_seed': seed,
        }, self._ventilator)
        # After every raise of the constructor: stop() is the only release.
        # A schema without an image field never decodes one, so its workers
        # would only shrink the other readers' shares.
        if _has_image_fields(schema) and self._in_process_pool:
            self._decode_share = decode_budget.get_budget().register_pool(pool.workers_count)
            if hasattr(pool, 'resize'):
                pool.decode_share = self._decode_share      # a resize re-divides it
        self._register_memory_pools()
        # A reader used alone owns its monitor; a loader over it calls
        # attach_health with its own registry instead.
        self._supervisor = PipelineSupervisor()
        self._health = None
        self._health_registry = None
        self._hb_handoff = None
        self._watchdog_error = None
        self._autotuner = None
        try:
            self._health = self._supervisor.arm_health(watchdog, stall_timeout_s,
                                                       self._deliver_stall,
                                                       attach_fn=self.attach_health)
            listeners = []
            if self.chunk_store is not None:
                listeners.append(autotune_mod.writer_throttle_listener(self.chunk_store))
            self._autotuner = self._supervisor.arm_autotune(
                autotune, self._autotune_knobs, self._autotune_telemetry,
                autotune_mod.classify_reader, watchdog_active_fn=self._watchdog_episode_active,
                memory_state_fn=membudget.get_governor().pressure_level, listeners=listeners)
        except Exception:
            self.stop()     # a refused deadline leaves no thread running
            raise

    def _watchdog_episode_active(self):
        return self._health is not None and self._health.watchdog.episode_active

    def _autotune_knobs(self, config):
        """The reader's knobs (``petastorm_tpu/reader.py:1053-1103``): for a
        pool that resizes, ``workers`` and, while the reader holds a
        decode-thread share, ``decode_threads``; ``results_watermark`` for a
        pool with one. A reader whose images decode without the native codec
        clamps ``workers`` and ``decode_threads`` at the host's cores."""
        pool = self._pool
        knobs = {}
        # The default clamps (4x the cores for workers, 2x for decode
        # threads) assume the native codec, which decodes a whole row-group
        # without the GIL. OpenCV and PIL hold it between images, so
        # threads past the cores only slow the training loop's thread
        # (PERF.md, the autotune cell).
        cores = (host_cores() if self._decode_share is not None
                 and decoder_info()['decoder'] != 'native' else None)
        if hasattr(pool, 'resize'):
            ventilator = self._ventilator

            def set_workers(n):
                # The resize re-divides the reader's decode share.
                pool.resize(n)
                ventilator.set_max_in_flight(n + _VENTILATE_EXTRA_ROWGROUPS)

            hi = config.max_workers if cores is None else min(config.max_workers, cores)
            knobs['workers'] = autotune_mod.Knob(
                'workers', lambda: pool.workers_count, set_workers,
                lo=config.min_workers, hi=max(config.min_workers, hi))
        if self._decode_share is not None and hasattr(pool, 'resize'):
            budget = decode_budget.get_budget()
            hi = (config.max_decode_threads if cores is None
                  else min(config.max_decode_threads, cores))
            knobs['decode_threads'] = autotune_mod.Knob(
                'decode_threads', lambda: budget.total, budget.set_total,
                lo=config.min_decode_threads, hi=max(config.min_decode_threads, hi))
        if hasattr(pool, 'results_watermark'):
            capacity = pool.results_capacity

            def get_watermark():
                watermark = pool.results_watermark
                return watermark if watermark is not None else capacity

            def set_watermark(n):
                # Capacity is the unarmed state (None): an armed watermark
                # at capacity never trips but keeps the feeder paced.
                n = int(n)
                pool.results_watermark = None if n >= capacity else n

            knobs['results_watermark'] = autotune_mod.Knob(
                'results_watermark', get_watermark, set_watermark,
                lo=config.min_watermark, hi=capacity)
        return knobs

    def _autotune_telemetry(self):
        """Values delivered and the pool's queue gauges, the inputs of
        :func:`~petastorm_tpu_torch.autotune.classify_reader`."""
        pool = self._pool
        out = {'batches': self._rows_delivered}
        qsize = getattr(pool, 'results_qsize', None)
        if qsize is not None:
            out['results_queue_depth'] = qsize
            out['results_queue_capacity'] = getattr(pool, 'results_capacity', 1)
        unprocessed = pool.diagnostics.get('ventilated_unprocessed')
        if unprocessed is not None:
            out['ventilated_unprocessed'] = unprocessed
        return out

    def adopt_autotune(self, config):
        """A wrapping loader takes the tuning over: this reader's own tuner
        stops, and its knobs and telemetry function are handed back for the
        loader's tuner."""
        if self._autotuner is not None:
            self._autotuner.stop()
            self._autotuner = None
            self._supervisor.autotuner = None
        return self._autotune_knobs(config), self._autotune_telemetry

    def _deliver_stall(self, error):
        """The watchdog's hard stall: raised at the next ``next``, and handed
        to a consumer parked in the pool's wait."""
        self._watchdog_error = error
        inject = getattr(self._pool, 'inject_consumer_error', None)
        if inject is not None:
            inject(error)

    def attach_health(self, registry):
        """Register this reader's stages with ``registry`` (a
        :class:`~petastorm_tpu_torch.health.HeartbeatRegistry`; called by a
        wrapping loader, or at construction for a reader's own monitor):
        the ``ventilator``, ``reader-handoff`` and ``worker-pool``
        heartbeats, the ``worker-pool``, ``memory`` and ``resequencer``
        probes, and the ventilator's wake-up as the soft recovery of
        ``reader-starved`` and ``worker-pool-dead``. A loader's registry
        replaces the reader's own monitor, which stops."""
        if self._health is not None and registry is not self._health.registry:
            self._health.stop()
            self._health = None
            self._supervisor.health = None
        self._health_registry = registry
        self._ventilator.heartbeat = registry.register('ventilator')
        self._hb_handoff = registry.register('reader-handoff')
        pool = self._pool
        pool.health_heartbeat = registry.register('worker-pool')
        # A process pool's diagnostics name its dead workers
        # (``dead_workers``), which classify as worker-pool-dead.
        registry.register_probe('worker-pool', lambda: dict(pool.diagnostics))
        registry.register_probe('memory', membudget.get_governor().probe)
        if self._resequencer is not None:
            # The resequencer-stalled signature: chunks held behind a hole
            # while the handoff goes quiet.
            registry.register_probe('resequencer', self._resequencer.stats)
        ventilator = self._ventilator

        def nudge_reader(diagnosis):
            # Safe from the watchdog's thread: wake a parked ventilator.
            ventilator._wakeup.set()
            return True

        registry.register_recovery(READER_STARVED, nudge_reader)
        registry.register_recovery(WORKER_POOL_DEAD, nudge_reader)

    def _quarantine_sink(self, record):
        """A quarantined item never publishes a chunk: in deterministic mode
        its sequence hole is filled first (the stream must not wedge even
        when the budget raise follows), then the log records it."""
        det = record.item.get('pst_det') if isinstance(record.item, dict) else None
        if self._resequencer is not None and isinstance(det, dict) \
                and det.get('seq') is not None:
            self._resequencer.mark_satisfied(det['seq'])
        self._quarantine_log.record(record)

    # -- row selection ------------------------------------------------------

    def _filter_row_groups(self, pieces, predicate, rowgroup_selector, cur_shard, shard_count):
        """The selector's row-groups, pruned by a predicate on partition
        fields alone (which then needs no worker), then the shard
        (``petastorm_tpu/reader.py:1192-1225``). Returns (pieces, the
        predicate the workers run or None)."""
        # The stored index holds positions in the whole sorted list, so the
        # selector comes first (``petastorm_tpu/reader.py:1227-1235``).
        if rowgroup_selector is not None:
            from petastorm_tpu_torch.etl.rowgroup_indexing import get_row_group_indexes
            selected = set(rowgroup_selector.select_row_groups(get_row_group_indexes(self._store)))
            pieces = [p for i, p in enumerate(pieces) if i in selected]
        worker_predicate = predicate
        if predicate is not None:
            fields = set(predicate.get_fields())
            if fields and fields <= set(self._store.partition_names):
                pieces = [p for p in pieces
                          if predicate.do_include({f: p.partition_values.get(f) for f in fields})]
                worker_predicate = None
        if shard_count is not None:
            pieces = [p for i, p in enumerate(pieces) if i % shard_count == cur_shard]
            if not pieces:
                raise NoDataAvailableError(
                    'No row-groups assigned to shard {} of {}. The dataset has too few '
                    'row-groups for this shard count.'.format(cur_shard, shard_count))
        if not pieces:
            raise NoDataAvailableError('No row-groups left after filtering; cannot create a '
                                       'Reader')
        return pieces, worker_predicate

    # -- host memory governor ----------------------------------------------

    def _register_memory_pools(self):
        """The reader's pools (``petastorm_tpu/reader.py:965-1012``): the
        results queue (its shed hook paces ventilation), the memory cache
        (degrade: LRU eviction), the chunk store (advisory: pause spill;
        degrade: drop LRU mmaps), the resequencer. A breach is raised by
        the next ``next()``, also from inside a wait on the pool."""
        governor = membudget.get_governor()
        self._mem_handles = []
        self._mem_shed_saved_watermark = None
        self._mem_shed_tight = None
        self._mem_shed_active = False
        self._stall_error = None
        pool = self._pool
        if hasattr(pool, 'results_nbytes'):
            self._mem_handles.append(governor.register_pool(
                'results-queue', pool.results_nbytes, shed_fn=self._shed_ventilation))
        if isinstance(self.cache, MemoryCache):
            cache = self.cache
            self._mem_handles.append(governor.register_pool(
                'memory-cache', lambda: cache.nbytes, degrade_fn=cache.evict))
        if self.chunk_store is not None:
            store = self.chunk_store
            self._mem_handles.append(governor.register_pool(
                'chunk-store', store.governed_nbytes, degrade_fn=store.close_lru_mmaps,
                advisory_fn=store.set_spill_paused))
        if self._resequencer is not None:
            self._mem_handles.append(governor.register_pool(
                'resequencer', self._resequencer.buffered_nbytes))

        def deliver_breach(error):
            self._stall_error = error
            inject = getattr(self._pool, 'inject_consumer_error', None)
            if inject is not None:
                inject(error)

        self._mem_breach_sink = governor.add_breach_sink(deliver_breach)
        self._mem_armed = membudget.maybe_arm_from_env()

    def _shed_ventilation(self, active):
        """The shed rung: a tight results watermark (an eighth of the queue,
        at least 2) makes the ventilator feed one item at a time; the
        previous watermark comes back when the ladder recedes, unless
        something else changed it meanwhile. Feeding order is unchanged."""
        pool = self._pool
        if active:
            if self._mem_shed_active:
                return
            self._mem_shed_active = True
            self._mem_shed_saved_watermark = pool.results_watermark
            self._mem_shed_tight = max(2, (pool.results_capacity or 8) // 8)
            pool.results_watermark = self._mem_shed_tight
        elif self._mem_shed_active:
            self._mem_shed_active = False
            if pool.results_watermark == self._mem_shed_tight:
                pool.results_watermark = self._mem_shed_saved_watermark

    @property
    def deterministic(self):
        """True when built with ``deterministic=True``."""
        return self._deterministic

    @property
    def transformed_schema(self):
        """The schema of what the reader yields (after a ``transform_spec``)."""
        return self._output_schema

    @property
    def raw_image_fields(self):
        """Image fields this reader ships encoded (object columns of their
        bytes) for the loader's staging step to decode; empty otherwise."""
        return self._raw_image_fields

    @property
    def decoder(self):
        """The decode path in use: ``image`` (``'native'``, ``'cv2'`` or
        ``'pil'``) and ``image_error`` (why the native codec is not used, or
        None), ``decode_path`` (``PSTT_DECODE_PATH``), ``decode_threads``
        (a worker's share of the budget now, a process worker's static one;
        None for a reader that decodes no image), ``parquet`` (``'native'`` or ``'pyarrow'``, the
        tensor path's stage) and ``parquet_error``."""
        from petastorm_tpu_torch.native import parquet as native_pq
        image = decoder_info()
        parquet, parquet_error = 'pyarrow', None
        if self.batched_output:
            if not self._store.is_local:
                parquet_error = ('the store is not local ({}); the native stage opens '
                                 'operating-system paths'.format(self._store.url))
            elif native_pq.is_available():
                parquet = 'native'
            else:
                parquet_error = native_pq.load_error()
        if self._decode_share is not None:
            decode_threads = self._decode_share.share
        else:
            decode_threads = self._static_decode_threads if _has_image_fields(self.schema) \
                else None
        return {'image': image['decoder'], 'image_error': image['native_error'],
                'decode_path': decode_path(), 'decode_threads': decode_threads,
                'parquet': parquet, 'parquet_error': parquet_error}

    @property
    def chunk_store(self):
        """The reader's :class:`~petastorm_tpu_torch.chunk_store.DecodedChunkStore`
        (``cache_type='chunk-store'``, or ``PSTT_CHUNK_STORE``), else None."""
        return self.cache if getattr(self.cache, 'is_chunk_store', False) else None

    def cache_stats(self):
        """``{'type', 'hits', 'misses', 'nbytes'}`` of the row-group cache
        (zeros for the null cache); the chunk store adds its own counters
        (``fills``, ``writes``, ``corrupt_quarantined``, ``readaheads``,
        ...), ``nbytes`` being the host bytes it holds."""
        cache = self.cache
        if self.chunk_store is not None:
            return dict(cache.stats(), type='chunk-store', nbytes=cache.governed_nbytes())
        if isinstance(cache, (MemoryCache, LocalDiskCache)):
            return {'type': 'memory' if isinstance(cache, MemoryCache) else 'local-disk',
                    'hits': cache.hits, 'misses': cache.misses, 'nbytes': cache.nbytes}
        return {'type': 'null', 'hits': 0, 'misses': 0, 'nbytes': 0}

    @property
    def diagnostics(self):
        """The pool's queues, the quarantine records (``quarantined_rowgroups``)
        and ``error_budget`` (None without one), the chunk store's and the
        resequencer's counters, the watchdog's and the autotuner's (its
        ``stats()``) when armed, and the memory governor's when armed. Reads
        as a mapping and as a call (``reader.diagnostics()['...']``)."""
        diag = _CallableDict(self._pool.diagnostics)
        if self.chunk_store is not None:
            diag['chunk_store'] = self.chunk_store.stats()
        diag['quarantined_rowgroups'] = self._quarantine_log.snapshot()
        diag['error_budget'] = (self._quarantine_log.budget if self._quarantine_log.enabled
                                else None)
        if self._resequencer is not None:
            diag['resequencer'] = self._resequencer.stats()
        if self._health is not None:
            diag['watchdog'] = self._health.stats()
        elif self._health_registry is not None:
            diag['heartbeats'] = self._health_registry.beat_table()
        if self._autotuner is not None:
            diag['autotune'] = self._autotuner.stats()
        governor = membudget.get_governor()
        if governor.armed:
            diag['mem'] = governor.stats()
        return diag

    @property
    def stage_timings(self):
        """Worker seconds summed over the row-groups delivered so far:
        ``read_s`` (Parquet), ``decode_s`` (codecs), ``cache_s`` (the
        cache's own bookkeeping), and ``chunks``."""
        return dict(self._timings)

    @property
    def last_chunk_lineage(self):
        """Provenance segment of the chunk (or, per row, the row) most
        recently returned: ``row_start`` is past any resume skip."""
        return self._last_lineage

    @property
    def last_chunk_det(self):
        """The deterministic-mode tag (``{'seq', 'epoch', 'pos'}``) of the
        chunk most recently returned by a batched reader, or None
        (``petastorm_tpu/reader.py:1356``). A data server ships it with the
        chunk, and a consumer's resume cursor is built from it."""
        return getattr(self, '_last_det', None)

    def __iter__(self):
        return self

    def _next_chunk(self):
        """The next non-hole chunk off the pool (in ventilation order in
        deterministic mode), its timings added up."""
        while True:
            try:
                chunk = self._pool.get_results()
            except EmptyResultError:
                self.last_row_consumed = True
                if self._hb_handoff is not None:
                    self._hb_handoff.beat('idle')      # exhausted, not stalled
                    pool_hb = getattr(self._pool, 'health_heartbeat', None)
                    if pool_hb is not None:
                        pool_hb.beat('idle')
                raise StopIteration
            if determinism.is_hole(chunk):
                self.holes += 1
                continue
            for key, seconds in chunk['timings'].items():
                self._timings[key] += seconds
            self._timings['chunks'] += 1
            return chunk

    def _next_cols(self):
        """The next chunk's column blocks, past any resume skip."""
        while True:
            chunk = self._next_chunk()
            cols, key, det, lineage = chunk['cols'], chunk['key'], chunk.get('det'), \
                chunk['lineage']
            n_rows = len(next(iter(cols.values())))
            skip = self._tracker.on_chunk(key, n_rows, det=det)
            if skip:
                cols = {k: v[skip:] for k, v in cols.items()}
                n_rows -= skip
                lineage = dict(lineage, row_start=lineage['row_start'] + skip)
            if n_rows <= 0:
                continue
            if skip and self._lineage_mode == ArrowWorker.lineage_mode:
                cols = restack_list_columns(cols)
            self._record_chunk(key, n_rows)
            self._last_lineage = lineage
            self._last_det = det
            return cols

    def __next__(self):
        if self._stopped:
            raise RuntimeError('Trying to iterate a stopped Reader')
        if self._stall_error is not None:
            raise self._stall_error
        if self._watchdog_error is not None:
            error, self._watchdog_error = self._watchdog_error, None
            raise error
        hb = self._hb_handoff
        if hb is None:
            value = self._next_value()
            self._rows_delivered += 1
            return value
        # 'poll': waiting on the workers (stale = reader-starved);
        # 'handoff': delivered (stale = the consumer stopped pulling).
        hb.beat('poll')
        try:
            value = self._next_value()
        except PipelineStallError as error:
            # The pool raised the injected copy: do not raise it again.
            if error is self._watchdog_error:
                self._watchdog_error = None
            raise
        self._rows_delivered += 1
        hb.beat('handoff')
        # A delivered value is recovery: a stall diagnosed while the consumer
        # waited must not end a pipeline that came back.
        self._watchdog_error = None
        return value

    def _next_value(self):
        if self.batched_output:
            return self._output_schema.make_namedtuple(**self._next_cols())
        while not self._rows:
            chunk = self._next_chunk()
            key, rows, det = chunk['key'], chunk['rows'], chunk.get('det')
            skip = self._tracker.on_chunk(key, len(rows), det=det)
            self._rows.extend((key, row, chunk['lineage'], skip + i)
                              for i, row in enumerate(rows[skip:]))
        key, row, lineage, row_index = self._rows.popleft()
        # An NGram chunk carries no lineage: a window is not a stored row.
        self._last_lineage = None if lineage is None else dict(lineage, row_start=row_index)
        self._tracker.rows_yielded(key, 1)
        if self.ngram is not None:
            return self.ngram.make_namedtuple(self._output_schema, row)
        return self._output_schema.make_namedtuple(**row)

    # -- checkpoint and provenance -----------------------------------------

    def enable_row_granular_checkpoint(self):
        """Defer the row accounting of chunks to :meth:`rows_consumed`, for a
        loader that consumes rows in delivery order: rows it still holds at
        a checkpoint re-deliver on resume. False for per-row readers, which
        count each row as it leaves."""
        if not self.batched_output:
            return False
        self.enable_deferred_rows()
        return True

    def state_dict(self):
        """JSON-safe position for ``resume_state=`` (see the module
        docstring): the tracker's state, the shard identity of a
        deterministic cursor, and the config fingerprint."""
        state = self._tracker.state_dict()
        if self._deterministic:
            state['cur_shard'] = self._cur_shard or 0
            state['shard_count'] = self._shard_count or 1
        state['config'] = self._config_fingerprint
        return state

    def lineage_context(self):
        """The static facts a provenance record needs to be replayed
        (JSON-safe; the JAX package's keys). A transform is described by its
        ``version`` tag and its function's name: replay cannot run it."""
        transform = None
        if self._transform_spec is not None:
            func = self._transform_spec.func
            transform = {'version': self._transform_spec.version,
                         'func': getattr(func, '__qualname__', None) if func is not None
                         else None}
        return {
            'mode': self._lineage_mode,
            'url': self._store.url,
            'dataset_path_hash': hashlib.md5(self._store.url.encode()).hexdigest()[:12],
            'fields': sorted(self.schema.fields),
            'schema_hash': hashlib.md5(','.join(sorted(self.schema.fields)).encode())
            .hexdigest()[:8],
            'seed': self._seed,
            'cur_shard': self._cur_shard,
            'shard_count': self._shard_count,
            'num_epochs': self._num_epochs,
            'shuffle_rows_in_chunk': self._shuffle_rows_in_chunk,
            'deterministic': self._deterministic,
            'n_row_groups': len(self._row_groups),
            'transform': transform,
            'predicate': _describe_filter(self._predicate),
            'ngram': self.ngram is not None,
        }

    def lineage_state(self):
        """The live shuffle state sampled into each provenance record."""
        return self._ventilator.lineage_state()

    def reset(self):
        """Read another round of ``num_epochs`` once every row was consumed."""
        if not self.last_row_consumed:
            raise NotImplementedError('Currently reset() is supported only after all rows were '
                                      'consumed')
        self.last_row_consumed = False
        if self._resequencer is not None:
            self._resequencer.reset()   # before the ventilator restarts its seq at 0
        self._ventilator.reset()

    def stop(self):
        """Stop the workers, unregister the memory pools (releasing the
        governor's arm reference) and stop the chunk store's writer once its
        queued writes are on disk. Idempotent. The tuner stops first (it
        would resize a pool being joined), then the watchdog (it would read
        the stopped stages as a stall); ``diagnostics`` keeps their
        sections."""
        self._supervisor.stop()
        governor = membudget.get_governor()
        for handle in self._mem_handles:
            handle.close()
        self._mem_handles = []
        governor.remove_breach_sink(self._mem_breach_sink)
        if self._mem_armed:
            self._mem_armed = False
            governor.release()
        self._pool.stop()
        if self._decode_share is not None:
            self._decode_share.release()
            self._decode_share = None
        if self.chunk_store is not None:
            self.chunk_store.close()
        self._stopped = True

    def join(self):
        self._pool.join()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.stop()
        self.join()
        return False
