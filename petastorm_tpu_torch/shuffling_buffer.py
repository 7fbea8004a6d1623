"""Bounded random shuffling buffer for row-level decorrelation.

Counterpart of ``petastorm_tpu/shuffling_buffer.py:20-261``. The draws come from
``np.random.default_rng(seed)`` with the same call sequence as the JAX
buffer, so one seed gives both packages the same row order: this is host
data order, not a torch random stream. :class:`RandomShufflingBuffer` is
checkpointable: ``state_dict()``/``restore()`` carry the buffered rows and
the generator's state, so a resumed buffer replays the same draws. Its
``nbytes`` is the memory governor's ``shuffling-buffer`` pool, and
``shrink_capacity`` that pool's degrade hook (registered only for readers
that are not deterministic: it changes the draws).
"""

import threading
from collections import deque

import numpy as np

from petastorm_tpu_torch.membudget import approx_nbytes


class NoopShufflingBuffer(object):
    """Pass-through FIFO."""

    def __init__(self):
        self._store = deque()
        self._done = False

    def add_many(self, items):
        self._store.extend(items)

    def retrieve(self):
        return self._store.popleft()

    def can_add(self):
        return not self._done

    def can_retrieve(self):
        return len(self._store) > 0

    @property
    def size(self):
        return len(self._store)

    def finish(self):
        self._done = True


class RandomShufflingBuffer(object):
    """Uniform random retrieval from a bounded buffer.

    :param shuffling_buffer_capacity: soft cap; ``can_add`` is False at/above it.
    :param min_after_retrieve: retrieval floor before ``finish()``: keeps the
        buffer full enough to decorrelate.
    :param extra_capacity: how far a single ``add_many`` may overshoot the cap.
    :param seed: RNG seed for reproducible shuffling.
    """

    def __init__(self, shuffling_buffer_capacity, min_after_retrieve, extra_capacity=1000,
                 seed=None):
        if min_after_retrieve >= shuffling_buffer_capacity:
            raise ValueError('min_after_retrieve ({}) must be < capacity ({})'.format(
                min_after_retrieve, shuffling_buffer_capacity))
        self._capacity = shuffling_buffer_capacity
        self._min_after_retrieve = min_after_retrieve
        self._extra_capacity = extra_capacity
        self._store = []
        self._row_nbytes = None   # per-row estimate, a moving average of sampled rows
        self._pending = None   # armed by track_pending()
        #: Field order of the buffered row tuples (set by the batch
        #: iterator): rides the checkpoint, since a resumed reader may yield
        #: no sample to learn it from.
        self.field_names = None
        self._done_adding = False
        self._rng = np.random.default_rng(seed)
        # The assemble thread adds and draws while the training thread may
        # take a snapshot.
        self._lock = threading.Lock()

    def add_many(self, items):
        with self._lock:
            if self._done_adding:
                raise RuntimeError('Cannot add after finish()')
            if len(self._store) + len(items) > self._capacity + self._extra_capacity:
                raise RuntimeError(
                    'add_many of {} items would exceed capacity+extra ({}+{}); current size {}. '
                    'Check can_add() before adding.'.format(
                        len(items), self._capacity, self._extra_capacity, len(self._store)))
            if len(items):
                # One sampled row an add, averaged: rows of varying size
                # would otherwise be weighed by the first forever.
                sample = max(1, approx_nbytes(items[0]))
                if self._row_nbytes is None:
                    self._row_nbytes = sample
                else:
                    self._row_nbytes += 0.2 * (sample - self._row_nbytes)
            self._store.extend(items)

    def retrieve(self):
        with self._lock:
            if not self.can_retrieve():
                raise RuntimeError('Buffer below decorrelation floor; add more or finish()')
            index = int(self._rng.integers(0, len(self._store)))
            # O(1) random pop: swap with the last row.
            self._store[index], self._store[-1] = self._store[-1], self._store[index]
            row = self._store.pop()
            if self._pending is not None:
                self._pending.append(row)
            return row

    def can_add(self):
        return len(self._store) < self._capacity and not self._done_adding

    def can_retrieve(self):
        if self._done_adding:
            return len(self._store) > 0
        return len(self._store) > self._min_after_retrieve

    @property
    def size(self):
        return len(self._store)

    @property
    def capacity(self):
        return self._capacity

    @property
    def nbytes(self):
        """Estimated bytes of the buffered and drawn-but-undelivered rows."""
        if self._row_nbytes is None:
            return 0
        pending = len(self._pending) if self._pending is not None else 0
        return int((len(self._store) + pending) * self._row_nbytes)

    def shrink_capacity(self, factor=2):
        """Halve (by default) the capacity and the decorrelation floor: the
        governor's degrade hook. The floor sets how many rows stay buffered,
        so it shrinks too; the capacity never falls below the rows held (an
        add past it would raise), and later ticks ratchet it down as the
        buffer drains. No row is dropped. True when anything moved."""
        factor = max(1, int(factor))
        with self._lock:
            new_min = max(1, self._min_after_retrieve // factor)
            new_cap = max(new_min + 1, self._capacity // factor, len(self._store))
            if new_cap >= self._capacity and new_min >= self._min_after_retrieve:
                return False
            self._capacity = min(new_cap, self._capacity)
            self._min_after_retrieve = min(new_min, self._min_after_retrieve)
            return True

    def finish(self):
        self._done_adding = True

    # -- checkpoint ----------------------------------------------------------

    STATE_VERSION = 1

    def track_pending(self):
        """Keep drawn rows until :meth:`mark_delivered` says their batch
        reached the consumer; ``state_dict()`` then carries them too (else
        rows drawn into staged, undelivered batches would be lost)."""
        with self._lock:
            if self._pending is None:
                self._pending = deque()

    def mark_delivered(self, n):
        """Release the ``n`` oldest drawn rows (past the count: no-op)."""
        with self._lock:
            if self._pending is None:
                return
            for _ in range(min(int(n), len(self._pending))):
                self._pending.popleft()

    def state_dict(self):
        """The undelivered rows (drawn-but-pending first, then buffered) and
        the generator's state. The rows are arbitrary values: pickle-safe,
        not JSON-safe (``JobCheckpointer`` pickles such a loader state)."""
        with self._lock:
            rows = list(self._pending or ()) + list(self._store)
            return {'version': self.STATE_VERSION, 'rows': rows,
                    'rng_state': self._rng.bit_generator.state,
                    'field_names': list(self.field_names) if self.field_names is not None
                    else None,
                    'size': len(rows)}

    def restore(self, state):
        """Refill from a :meth:`state_dict` snapshot before iteration: the
        rows come back and the generator continues the earlier draws."""
        if state.get('version') != self.STATE_VERSION:
            raise ValueError('Unsupported shuffling-buffer state version {!r}'.format(
                state.get('version')))
        with self._lock:
            if self._store:
                raise RuntimeError('restore() into a non-empty buffer')
            self._store = list(state['rows'])
            self._rng.bit_generator.state = state['rng_state']
            if state.get('field_names'):
                self.field_names = list(state['field_names'])


def build_shuffling_buffer(capacity, min_after_dequeue, seed):
    """The loader's buffer (``petastorm_tpu/jax_loader.py:162-170``): the
    decorrelation floor defaults to 4/5 of the capacity, with 100000 rows
    of headroom for one chunk's overshoot."""
    if min_after_dequeue is None:
        min_after_dequeue = capacity * 4 // 5
    return RandomShufflingBuffer(capacity, min_after_dequeue, seed=seed, extra_capacity=100000)
