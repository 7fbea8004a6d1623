"""Bounded random shuffling buffer for row-level decorrelation.

Counterpart of ``petastorm_tpu/shuffling_buffer.py:20-160`` without the
checkpoint (``state_dict``/``restore``/pending rows) and the memory
governor's hooks, which come with determinism and resume (ROADMAP §A5).
The draws come from ``np.random.default_rng(seed)`` with the same call
sequence as the JAX buffer, so one seed gives both packages the same row
order: this is host data order, not a torch random stream.
"""

from collections import deque

import numpy as np


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
        self._done_adding = False
        self._rng = np.random.default_rng(seed)

    def add_many(self, items):
        if self._done_adding:
            raise RuntimeError('Cannot add after finish()')
        if len(self._store) + len(items) > self._capacity + self._extra_capacity:
            raise RuntimeError(
                'add_many of {} items would exceed capacity+extra ({}+{}); current size {}. '
                'Check can_add() before adding.'.format(
                    len(items), self._capacity, self._extra_capacity, len(self._store)))
        self._store.extend(items)

    def retrieve(self):
        if not self.can_retrieve():
            raise RuntimeError('Buffer below decorrelation floor; add more or finish()')
        index = int(self._rng.integers(0, len(self._store)))
        # O(1) random pop: swap with the last row.
        self._store[index], self._store[-1] = self._store[-1], self._store[index]
        return self._store.pop()

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

    def finish(self):
        self._done_adding = True


def build_shuffling_buffer(capacity, min_after_dequeue, seed):
    """The loader's buffer (``petastorm_tpu/jax_loader.py:162-170``): the
    decorrelation floor defaults to 4/5 of the capacity, with 100000 rows
    of headroom for one chunk's overshoot."""
    if min_after_dequeue is None:
        min_after_dequeue = capacity * 4 // 5
    return RandomShufflingBuffer(capacity, min_after_dequeue, seed=seed, extra_capacity=100000)
