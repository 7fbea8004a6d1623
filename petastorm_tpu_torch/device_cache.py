"""Device-resident dataset tier: decode once, train epochs out of device
memory (counterpart of ``petastorm_tpu/device_cache.py:61-521``, full mode).

Epoch 0 streams through the normal reader -> decode -> ``TorchLoader``
pipeline (training can start at once) while every group of
``superbatch_batches`` batches is consolidated into one contiguous
``[k * rows, ...]`` tensor per field, so the fill holds at most one group
twice. Later epochs run entirely from device memory: no read, decode or
host-to-device copy.

Epochs reshuffle on the device, in two levels: the order in which the
superbatches are visited, and the rows within each superbatch, each drawn
from a ``torch.Generator`` seeded from ``(seed, epoch, superbatch start)``
as ``_epoch_perms`` (``device_cache.py:396-409``) folds them into its key;
batches are gathered with ``index_select``. Every batch of every epoch is
a fresh tensor, never a view of the cache.

Usage::

    with make_tensor_reader(url, num_epochs=1, seed=0) as reader:
        with TorchLoader(reader, batch) as loader:
            cache = DeviceDatasetCache(loader, shuffle=True, seed=0)
            for epoch in range(90):
                for batch in cache.epoch(epoch):
                    metrics = train_step(state, batch.image, batch.label)

The source loader must be finite (``num_epochs=1``). Partial mode (a
budget watermark with the remainder streamed each epoch), coldest-first
eviction and the memory governor's pool are not ported yet: past its
budget the cache raises :class:`DeviceCacheOverflow`.
"""

import hashlib

import torch

_DEFAULT_MEMORY_FRACTION = 0.4
_DEFAULT_SUPERBATCH_BATCHES = 8
#: The key of the superbatch visit order; no superbatch starts there.
_ORDER_KEY = 0xffffffff


class DeviceCacheOverflow(RuntimeError):
    """The cached bytes exceeded the cache's budget."""


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
    source batch index it covers."""

    __slots__ = ('columns', 'start', 'n_batches', 'nbytes')

    def __init__(self, columns, start, n_batches):
        self.columns = columns
        self.start = start
        self.n_batches = n_batches
        self.nbytes = sum(col.nbytes for col in columns.values())


class DeviceDatasetCache(object):
    """Caches a finite loader's batches on its device in superbatch units and
    reshuffles each later epoch on the device.

    :param loader: a :class:`~petastorm_tpu_torch.loader.TorchLoader` (or
        any iterable of equal-size namedtuples of tensors) over a finite
        reader, consumed by ``epoch(0)``; it can be closed afterwards.
    :param shuffle: reshuffle each epoch (superbatch order and rows within
        each superbatch); ``False`` replays cache order, batch boundaries
        kept.
    :param seed: base of the per-epoch permutations: every epoch differs,
        and one seed reproduces the stream (over the same cache content).
    :param max_bytes: the budget of cached bytes; ``None`` = 40% of the
        card's memory (no limit on the CPU). Past it :class:`DeviceCacheOverflow`.
    :param superbatch_batches: batches consolidated into one superbatch.
    """

    def __init__(self, loader, shuffle=True, seed=0, max_bytes=None,
                 superbatch_batches=_DEFAULT_SUPERBATCH_BATCHES):
        self._loader = loader
        self._shuffle = shuffle
        self._seed = seed
        self._superbatch_batches = max(1, int(superbatch_batches))
        self._max_bytes = (max_bytes if max_bytes is not None
                           else _default_budget(getattr(loader, 'device', None)))
        self._superbatches = []
        self._nt_type = None
        self._batch_rows = None
        self._total_batches = None
        self._bytes = 0
        self._staged_bytes = 0
        self._hits = 0
        self._streaming = False
        self._materialized = False
        self._overflow_msg = None
        self._cleared = False

    @property
    def materialized(self):
        return self._materialized

    @property
    def nbytes(self):
        """Bytes resident (summed over superbatches)."""
        return self._bytes

    def stats(self):
        return {'materialized': self._materialized,
                'superbatches': len(self._superbatches),
                'cached_batches': sum(sb.n_batches for sb in self._superbatches),
                'total_batches': self._total_batches,
                'nbytes': self._bytes,
                'hits': self._hits}

    def epoch(self, epoch_index=0):
        """Iterate one epoch: the first call streams from the loader while
        caching, later calls run from device memory."""
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
            self._admit(batch, n)
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

    def _admit(self, batch, index):
        """Count the batch against the budget; raise past it."""
        nbytes = sum(t.nbytes for t in batch)
        if self._max_bytes and self._staged_bytes + nbytes > self._max_bytes:
            msg = ('device cache exceeded its {:.2f} GB budget after {} batches ({:.2f} GB '
                   'staged); raise max_bytes or drop the cache for this dataset'.format(
                       self._max_bytes / 1e9, index + 1, (self._staged_bytes + nbytes) / 1e9))
            self._overflow_msg = msg
            self._drop_all()
            raise DeviceCacheOverflow(msg)
        self._staged_bytes += nbytes

    def _consolidate(self, batches, start):
        columns = {name: torch.cat([getattr(b, name) for b in batches])
                   for name in self._nt_type._fields}
        sb = _Superbatch(columns, start, len(batches))
        self._superbatches.append(sb)
        self._bytes += sb.nbytes

    def _cached_epoch(self, epoch_index):
        sbs = list(self._superbatches)
        order = range(len(sbs))
        if self._shuffle:
            order = torch.randperm(len(sbs), generator=torch.Generator().manual_seed(
                _seed_of(self._seed, epoch_index, _ORDER_KEY))).tolist()
        rows = self._batch_rows
        for sb_i in order:
            sb = sbs[sb_i]
            perm = None
            if self._shuffle:
                device = next(iter(sb.columns.values())).device
                generator = torch.Generator(device=device).manual_seed(
                    _seed_of(self._seed, epoch_index, sb.start))
                perm = torch.randperm(sb.n_batches * rows, generator=generator, device=device)
            for local in range(sb.n_batches):
                self._hits += 1
                if perm is None:
                    yield self._nt_type(**{name: col[local * rows:(local + 1) * rows].clone()
                                           for name, col in sb.columns.items()})
                else:
                    idx = perm[local * rows:(local + 1) * rows]
                    yield self._nt_type(**{name: col.index_select(0, idx)
                                           for name, col in sb.columns.items()})

    def _drop_all(self):
        self._superbatches = []
        self._bytes = 0

    def clear(self):
        """Free the cached tensors. The cache is finished: ``epoch()``
        raises afterwards."""
        self._drop_all()
        self._materialized = False
        self._cleared = True
