"""Mid-epoch resume for readers: the default (multiset-exact) mode.

Counterpart of ``petastorm_tpu/checkpoint.py``; its ``state_dict()`` is
JSON-equal to the JAX package's for the same sequence of chunks and rows,
so either package resumes a state the other wrote.

* Every chunk a worker publishes is tagged with its ventilation key
  ``"piece:drop_partition"`` (:func:`chunk_key`).
* The consumer-side :class:`ConsumptionTracker` counts, per key, the
  instances fully consumed and the rows consumed of the open instance.
* ``Reader.state_dict()`` serialises those counters; a new reader built
  with ``resume_state=`` drops, consumer-side, what was consumed:
  completed keys on their next arrival, a partial key's first rows.

With a finite ``num_epochs`` the skips are absolute (rebuild with the same
``num_epochs``); with ``num_epochs=None`` they are relative to the
least-consumed key. Worker interleaving may reorder rows, so the guarantee
is multiset-exactness; ``deterministic=True`` readers use the stream
cursor of :mod:`petastorm_tpu_torch.determinism` instead.
"""

import threading
from collections import deque

STATE_VERSION = 1


def chunk_key(piece_index, shuffle_row_drop_partition):
    drop_idx = shuffle_row_drop_partition[0] if shuffle_row_drop_partition else 0
    return '{}:{}'.format(piece_index, drop_idx)


class DeferredRowAccounting(object):
    """Mixin for readers of chunks: optional row-granular attribution.

    By default a chunk's rows count as consumed the moment it leaves the
    reader. After :meth:`enable_deferred_rows` (asked for by a loader that
    consumes rows strictly in delivery order, ``TorchLoader`` without a
    shuffling buffer), ``_record_chunk`` queues ``(key, rows)`` and the
    loader attributes what it delivered through :meth:`rows_consumed`:
    rows still buffered downstream at a checkpoint re-deliver on resume.
    """

    _tracker = None
    _pending_rows = None

    def set_tracker(self, tracker):
        self._tracker = tracker

    def enable_deferred_rows(self):
        if self._pending_rows is None:
            self._pending_rows = deque()

    def _record_chunk(self, key, n_rows):
        """A chunk's rows (after any resume skip) left the reader."""
        if self._tracker is None:
            return
        if self._pending_rows is not None:
            self._pending_rows.append((key, n_rows))
        else:
            self._tracker.rows_yielded(key, n_rows)

    def rows_consumed(self, n):
        """Attribute ``n`` consumed rows to chunks in delivery order."""
        if self._tracker is None or self._pending_rows is None:
            return
        while n > 0 and self._pending_rows:
            key, left = self._pending_rows[0]
            take = min(n, left)
            self._tracker.rows_yielded(key, take)
            n -= take
            if take == left:
                self._pending_rows.popleft()
            else:
                self._pending_rows[0] = (key, left - take)


class ConsumptionTracker(object):
    """Counts per-key consumption and computes the resume-time skips.

    Thread-safe: a loader's assemble thread drives the reader while
    ``state_dict()`` is called from the training thread, so every mutation
    and the snapshot hold one lock (else a snapshot could see ``done``
    advanced but ``partial`` not yet reset, and a resume would drop rows).
    """

    def __init__(self, resume_state=None, num_epochs=1):
        self._lock = threading.Lock()
        self._done = {}      # key -> instances fully consumed (prior sessions included)
        self._partial = {}   # key -> rows consumed of the open instance
        self._totals = {}    # key -> rows per instance (observed)
        self._skip_instances = {}
        self._skip_rows = {}
        if resume_state:
            self._load(resume_state, num_epochs)

    def _load(self, state, num_epochs):
        if state.get('version') != STATE_VERSION:
            raise ValueError('Unsupported reader state version {!r}'.format(state.get('version')))
        keys = state.get('keys', {})
        if not keys:
            return
        # Endless epochs: skip only what a key is ahead of the least-consumed
        # one (absolute skips would discard unbounded decode work).
        base = min(entry['done'] for entry in keys.values()) if num_epochs is None else 0
        for key, entry in keys.items():
            done = int(entry['done'])
            partial = int(entry.get('partial', 0))
            self._done[key] = done
            self._partial[key] = 0   # the session-local position restarts
            if entry.get('total') is not None:
                self._totals[key] = int(entry['total'])
            skip = done - base
            if num_epochs is not None:
                skip = min(skip, num_epochs)
            if skip > 0:
                self._skip_instances[key] = skip
            if partial > 0:
                self._skip_rows[key] = partial

    def on_chunk(self, key, total_rows, det=None):
        """A new instance of ``key`` with ``total_rows`` rows arrived; returns
        how many leading rows the consumer drops. ``det`` is accepted for
        the same call as :class:`~petastorm_tpu_torch.determinism.
        DeterministicCursor` and ignored. Skipped rows were counted by an
        earlier session and are not counted again."""
        del det
        with self._lock:
            self._totals[key] = total_rows
            if self._skip_instances.get(key, 0) > 0:
                self._skip_instances[key] -= 1
                return total_rows
            skip = self._skip_rows.pop(key, 0)
            if skip >= total_rows:
                return total_rows
            if skip:
                self._partial[key] = skip
            return skip

    def rows_yielded(self, key, n):
        with self._lock:
            partial = self._partial.get(key, 0) + n
            total = self._totals.get(key)
            if total is not None and partial >= total:
                self._done[key] = self._done.get(key, 0) + 1
                partial = 0
            self._partial[key] = partial

    def state_dict(self):
        with self._lock:
            keys = {}
            for key in set(self._done) | set(self._partial) | set(self._totals):
                partial = self._partial.get(key, 0)
                # A partial skip not yet re-observed is an earlier session's
                # consumption: carry it to the next resume.
                keys[key] = {'done': self._done.get(key, 0),
                             'partial': partial or self._skip_rows.get(key, 0),
                             'total': self._totals.get(key)}
            return {'version': STATE_VERSION, 'keys': keys}
