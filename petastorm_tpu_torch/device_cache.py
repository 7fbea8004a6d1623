"""Device-resident dataset tier: decode once, train epochs out of device
memory (counterpart of ``petastorm_tpu/device_cache.py:61-521``).

Epoch 0 streams through the normal reader -> decode -> ``TorchLoader``
pipeline (training can start at once) while every group of
``superbatch_batches`` batches is consolidated into one contiguous
``[k * rows, ...]`` tensor per field, so the fill holds at most one group
twice. Later epochs run from device memory: no read, decode or
host-to-device copy.

Superbatches are also the unit of eviction. In partial mode
(``partial=True``) the budget is a watermark instead of a wall: the runs
that fit stay resident and the rest streams each epoch from
``loader_factory`` (a fresh pass of the same deterministic stream); each
batch index is served from the card when a resident run covers it, else
from the stream (whose copy of a resident batch is dropped), so the epoch
is complete and, with ``shuffle=False``, equal to the streamed pass even
when a run is evicted mid-epoch. The cache registers the memory governor's
``device-cache`` pool (:mod:`~petastorm_tpu_torch.membudget`); in partial
mode the degrade rung evicts the coldest run and the advisory rung pauses
the fill. On the card the pool counts device bytes against the host
budget, as the JAX package counts HBM bytes on a TPU.

Epochs reshuffle on the device, in two levels: the order in which the
superbatches are visited, and the rows within each superbatch, each drawn
from a ``torch.Generator`` seeded from ``(seed, epoch, superbatch start)``
as ``_epoch_perms`` (``device_cache.py:396-409``) folds them into its key,
so an eviction never shifts another run's draw; batches are gathered with
``index_select``. Every batch of every epoch is a fresh tensor, never a
view of the cache.

Usage::

    with make_tensor_reader(url, num_epochs=1, seed=0) as reader:
        with TorchLoader(reader, batch) as loader:
            cache = DeviceDatasetCache(loader, shuffle=True, seed=0)
            for epoch in range(90):
                for batch in cache.epoch(epoch):
                    metrics = train_step(state, batch.image, batch.label)

The source loader must be finite (``num_epochs=1``).
"""

import hashlib
import logging
import threading
import weakref

import torch

from petastorm_tpu_torch import membudget

logger = logging.getLogger(__name__)

_DEFAULT_MEMORY_FRACTION = 0.4
_DEFAULT_SUPERBATCH_BATCHES = 8
#: The key of the superbatch visit order; no superbatch starts there.
_ORDER_KEY = 0xffffffff


class DeviceCacheOverflow(RuntimeError):
    """The cached bytes exceeded the cache's budget (full mode only)."""


def _seed_of(*parts):
    """A 63-bit generator seed from integers, the same in every process."""
    digest = hashlib.blake2b(repr(parts).encode(), digest_size=8).digest()
    return int.from_bytes(digest, 'little') >> 1


def _default_budget(device):
    """40% of the card's memory (``torch.cuda.mem_get_info``'s total); no
    limit (0) on the CPU."""
    if device is None or torch.device(device).type != 'cuda':
        return 0
    return int(torch.cuda.mem_get_info(device)[1] * _DEFAULT_MEMORY_FRACTION)


class _Superbatch(object):
    """``columns[name]``: ``[n_batches * rows, ...]``; ``start``: the first
    source batch index it covers; ``stream``: the CUDA stream its memory
    was allocated on (None on the CPU); ``last_hit`` orders eviction."""

    __slots__ = ('columns', 'start', 'n_batches', 'nbytes', 'stream', 'last_hit', 'hits')

    def __init__(self, columns, start, n_batches, stream=None):
        self.columns = columns
        self.start = start
        self.n_batches = n_batches
        self.nbytes = sum(col.nbytes for col in columns.values())
        self.stream = stream
        self.last_hit = 0
        self.hits = 0

    def covers(self, batch_index):
        return self.start <= batch_index < self.start + self.n_batches


class DeviceDatasetCache(object):
    """Caches a finite loader's batches on its device in superbatch units and
    reshuffles each later epoch on the device.

    :param loader: a :class:`~petastorm_tpu_torch.loader.TorchLoader` (or
        any iterable of equal-size namedtuples of tensors) over a finite
        reader, consumed by ``epoch(0)``; it can be closed afterwards. The
        cache attaches itself, so ``loader.stats['device_cache']`` reports it.
    :param shuffle: reshuffle each epoch (superbatch order and rows within
        each superbatch); ``False`` replays cache order, batch boundaries
        kept.
    :param seed: base of the per-epoch permutations: every epoch differs,
        and one seed reproduces the stream (over the same cache content).
    :param max_bytes: the budget of cached bytes; ``None`` = 40% of the
        card's memory (no limit on the CPU). Past it full mode raises
        :class:`DeviceCacheOverflow` and partial mode stops filling.
    :param partial: keep the superbatches that fit and stream the rest each
        epoch from ``loader_factory``.
    :param superbatch_batches: batches consolidated into one superbatch: the
        fill's transient double hold and the eviction unit.
    :param loader_factory: zero-argument callable returning a fresh
        iterable over the same deterministic batch stream (a new reader and
        loader); partial epochs walk it.

    On a mesh (a ``TorchLoader(..., mesh=mesh)``, one cache a rank) each
    rank keeps its own tile of every batch, and the permutations are drawn
    from the same seeds on every rank, so the ranks keep visiting the same
    global batch: a shuffled epoch permutes the superbatch order and the
    rows within each rank's part of a superbatch, but never moves a row to
    another rank (the JAX tier's gather may; ``device_cache.py:340-400``).
    A tensor or sequence peer holds the same rows and draws the same
    permutation.
    """

    def __init__(self, loader, shuffle=True, seed=0, max_bytes=None, partial=False,
                 superbatch_batches=_DEFAULT_SUPERBATCH_BATCHES, loader_factory=None):
        self._loader = loader
        self._shuffle = shuffle
        self._seed = seed
        self._partial = bool(partial)
        self._loader_factory = loader_factory
        self._superbatch_batches = max(1, int(superbatch_batches))
        self._max_bytes = (max_bytes if max_bytes is not None
                           else _default_budget(getattr(loader, 'device', None)))
        self._lock = threading.Lock()    # the governor's thread against the consumer
        self._superbatches = []
        self._nt_type = None
        self._batch_rows = None
        self._total_batches = None
        self._bytes = 0
        self._staged_bytes = 0
        self._hits = 0
        self._hit_clock = 0
        self._evictions = 0
        self._fill_paused = False
        self._fill_stopped = False
        self._streaming = False
        self._materialized = False
        self._overflow_msg = None
        self._cleared = False
        # Accounting always; eviction and the fill pause only in partial
        # mode, where an epoch need not be the whole cache. The hooks hold
        # the cache weakly and the pool closes when the cache is collected:
        # the process-wide registry must not keep a dropped cache's device
        # memory alive.
        ref = weakref.ref(self)
        self._mem_handle = membudget.register_pool(
            'device-cache', lambda: getattr(ref(), '_bytes', 0),
            degrade_fn=(lambda: ref() is not None and ref()._evict_coldest())
            if self._partial else None,
            advisory_fn=(lambda active: ref() is not None and ref()._set_fill_paused(active))
            if self._partial else None)
        weakref.finalize(self, self._mem_handle.close)
        try:
            loader._device_cache = self
        except AttributeError:
            pass

    @property
    def materialized(self):
        return self._materialized

    @property
    def nbytes(self):
        """Bytes resident (summed over superbatches)."""
        return self._bytes

    def stats(self):
        with self._lock:
            return {'materialized': self._materialized, 'partial': self._partial,
                    'superbatches': len(self._superbatches),
                    'cached_batches': sum(sb.n_batches for sb in self._superbatches),
                    'total_batches': self._total_batches, 'nbytes': self._bytes,
                    'hits': self._hits, 'evictions': self._evictions,
                    'fill_paused': self._fill_paused, 'fill_stopped': self._fill_stopped}

    # -- the governor's hooks (partial mode) -------------------------------

    def _set_fill_paused(self, active):
        with self._lock:
            self._fill_paused = bool(active)

    def _evict_coldest(self):
        """Degrade rung: drop the coldest superbatch (least recently hit,
        earliest on ties). Its batch indices stream from the next lookup on,
        mid-epoch too (coverage is read per batch). The memory goes back to
        the caching allocator once the last reference is dropped: a gather
        in flight holds the run (see :meth:`_sb_batch`)."""
        with self._lock:
            if not self._superbatches:
                return False
            coldest = min(self._superbatches, key=lambda sb: (sb.last_hit, sb.start))
            self._superbatches.remove(coldest)
            self._bytes -= coldest.nbytes
            self._evictions += 1
        logger.info('device cache evicted superbatch [%d, %d) under memory pressure (%.2f GB '
                    'freed)', coldest.start, coldest.start + coldest.n_batches,
                    coldest.nbytes / 1e9)
        return True

    # -- iteration -----------------------------------------------------------

    def epoch(self, epoch_index=0):
        """Iterate one epoch: the first call streams from the loader while
        caching, later calls run from device memory (and, in partial mode,
        the streamed remainder)."""
        if self._cleared:
            raise RuntimeError('DeviceDatasetCache was cleared; construct a new cache over a '
                               'fresh loader')
        if not self._materialized:
            if self._overflow_msg is not None:
                raise DeviceCacheOverflow(
                    'the caching epoch previously overflowed: {} -- this cache cannot be '
                    'retried; construct a new DeviceDatasetCache (with a larger max_bytes) over '
                    'a fresh loader'.format(self._overflow_msg))
            if self._streaming:
                raise RuntimeError('the caching epoch was abandoned mid-stream; exhaust '
                                   'epoch(0) fully (or construct a new cache) before iterating '
                                   'further epochs')
            return self._first_epoch()
        return self._cached_epoch(epoch_index)

    def _first_epoch(self):
        self._streaming = True
        hold = getattr(self._loader, 'hold_batches', None)
        if hold is not None:
            hold(self._superbatch_batches)
        pending, pending_start, n = [], 0, 0
        for batch in self._loader:
            rows = len(batch[0])
            if self._batch_rows is None:
                self._batch_rows = rows
            elif rows != self._batch_rows:
                raise ValueError('device cache requires equal-size batches, but batch {} has {} '
                                 'rows (expected {})'.format(n, rows, self._batch_rows))
            self._nt_type = type(batch)
            if not self._cache_batch(batch, n, pending, pending_start):
                if not pending:
                    pending_start = n
                pending.append(batch)
                if len(pending) == self._superbatch_batches:
                    self._consolidate(pending, pending_start)
                    pending = []
            n += 1
            yield batch
        if n == 0:
            raise ValueError('source loader yielded no batches to cache')
        if pending:
            self._consolidate(pending, pending_start)
        self._total_batches = n
        self._materialized = True
        self._streaming = False
        with self._lock:
            cached = sum(sb.n_batches for sb in self._superbatches)
        logger.info('device cache materialized: %d/%d batches x %d rows in %d superbatch(es), '
                    '%.2f GB%s', cached, n, self._batch_rows, len(self._superbatches),
                    self._bytes / 1e9, ' (partial)' if cached < n else '')

    def _cache_batch(self, batch, index, pending, pending_start):
        """The budget and pause gate of one streamed batch: True when it is
        not cached (stream only). The pending run is consolidated first, so
        each superbatch covers contiguous indices."""
        with self._lock:
            paused = self._fill_paused or self._fill_stopped
        if paused and self._partial:
            self._flush_pending(pending, pending_start)
            return True
        nbytes = sum(t.nbytes for t in batch)
        if self._max_bytes and self._staged_bytes + nbytes > self._max_bytes:
            msg = ('device cache exceeded its {:.2f} GB budget after {} batches ({:.2f} GB '
                   'staged); raise max_bytes or drop the cache for this dataset'.format(
                       self._max_bytes / 1e9, index + 1, (self._staged_bytes + nbytes) / 1e9))
            if not self._partial:
                self._overflow_msg = msg
                self._drop_all()
                raise DeviceCacheOverflow(msg)
            with self._lock:
                if not self._fill_stopped:
                    self._fill_stopped = True
                    logger.info('device cache budget reached; streaming the remainder '
                                '(partial mode): %s', msg)
            self._flush_pending(pending, pending_start)
            return True
        self._staged_bytes += nbytes
        return False

    def _flush_pending(self, pending, pending_start):
        if pending:
            self._consolidate(pending, pending_start)
            del pending[:]

    def _consolidate(self, batches, start):
        columns = {name: torch.cat([getattr(b, name) for b in batches])
                   for name in self._nt_type._fields}
        first = next(iter(columns.values()))
        stream = torch.cuda.current_stream(first.device) if first.is_cuda else None
        sb = _Superbatch(columns, start, len(batches), stream)
        with self._lock:
            self._superbatches.append(sb)
            self._superbatches.sort(key=lambda s: s.start)
            self._bytes += sb.nbytes

    def _covering(self, batch_index):
        """The resident run covering ``batch_index`` (a hit), or None. The
        reference is taken under the lock, so an eviction meanwhile only
        drops the cache's own."""
        with self._lock:
            for sb in self._superbatches:
                if sb.covers(batch_index):
                    self._hit_clock += 1
                    sb.last_hit = self._hit_clock
                    sb.hits += 1
                    self._hits += 1
                    return sb
        return None

    def _sb_batch(self, sb, batch_index, perm):
        """One batch of a resident run: a slice copy in cache order, an
        ``index_select`` under the epoch's permutation. A gather queued on
        another stream than the run's own marks the run used there, so an
        eviction cannot hand its memory to that stream early."""
        rows = self._batch_rows
        local = batch_index - sb.start
        if sb.stream is not None:
            current = torch.cuda.current_stream(sb.stream.device)
            if current != sb.stream:
                for col in sb.columns.values():
                    col.record_stream(current)
        if perm is None:
            return self._nt_type(**{name: col[local * rows:(local + 1) * rows].clone()
                                    for name, col in sb.columns.items()})
        idx = perm[local * rows:(local + 1) * rows]
        return self._nt_type(**{name: col.index_select(0, idx)
                                for name, col in sb.columns.items()})

    def _epoch_perms(self, epoch_index):
        """Row permutations of each resident run for one epoch (none without
        shuffle), keyed by the run's start."""
        if not self._shuffle:
            return {}
        with self._lock:
            runs = [(sb.start, sb.n_batches * self._batch_rows,
                     next(iter(sb.columns.values())).device) for sb in self._superbatches]
        perms = {}
        for start, total, device in runs:
            generator = torch.Generator(device=device).manual_seed(
                _seed_of(self._seed, epoch_index, start))
            perms[start] = torch.randperm(total, generator=generator, device=device)
        return perms

    def _cached_epoch(self, epoch_index):
        perms = self._epoch_perms(epoch_index)
        with self._lock:
            sbs = list(self._superbatches)
        if sum(sb.n_batches for sb in sbs) == self._total_batches:
            # The whole dataset is resident: superbatches in a permuted
            # order, rows permuted within each.
            order = range(len(sbs))
            if self._shuffle:
                order = torch.randperm(len(sbs), generator=torch.Generator().manual_seed(
                    _seed_of(self._seed, epoch_index, _ORDER_KEY))).tolist()
            del sbs
            yield from self._resident_epoch(order, perms)
            return
        del sbs
        yield from self._partial_epoch(perms)

    def _resident_epoch(self, order, perms):
        with self._lock:
            sbs = list(self._superbatches)
        for sb_i in order:
            sb = sbs[sb_i]
            perm = perms.get(sb.start)
            for local in range(sb.n_batches):
                batch_index = sb.start + local
                self._covering(batch_index)   # hit accounting
                yield self._sb_batch(sb, batch_index, perm)

    def _partial_epoch(self, perms):
        """Resident runs merged with the streamed remainder by batch index.
        The source pass still produces the resident indices; their copies
        are dropped."""
        if self._loader_factory is None:
            raise RuntimeError('partial device cache needs loader_factory= to stream the uncached '
                               'remainder (cached {}/{} batches)'.format(
                                   self.stats()['cached_batches'], self._total_batches))
        source = iter(self._loader_factory())
        try:
            for batch_index in range(self._total_batches):
                streamed = next(source, None)
                sb = self._covering(batch_index)
                if sb is not None:
                    del streamed
                    yield self._sb_batch(sb, batch_index, perms.get(sb.start))
                    del sb
                elif streamed is not None:
                    yield streamed
                    del streamed
                else:
                    raise RuntimeError(
                        'loader_factory stream ended at batch {} of {}; the remainder source '
                        'must replay the full deterministic pass'.format(
                            batch_index, self._total_batches))
        finally:
            close = getattr(source, 'close', None)
            if close is not None:
                close()

    def _drop_all(self):
        with self._lock:
            self._superbatches = []
            self._bytes = 0

    def clear(self):
        """Free the cached tensors and unregister the governor's pool. The
        cache is finished: ``epoch()`` raises afterwards."""
        self._drop_all()
        self._materialized = False
        self._cleared = True
        self._mem_handle.close()
