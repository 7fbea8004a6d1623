"""Deterministic pipeline mode: order-stable shuffle, resequencing, cursor.

Counterpart of ``petastorm_tpu/determinism.py``. ``deterministic=True`` on
the reader factories makes the chunk stream a pure function of
``(dataset, schema, seed, epoch, position)``, whatever the worker count,
the pool or the timing, and across restarts:

:func:`epoch_order` / :func:`feistel_permute`
    A counter-based permutation of the epoch's ventilation items: a
    4-round Feistel network keyed by ``(seed, epoch)`` through MD5, with
    cycle-walking onto the domain. Python-int arithmetic only, so it is
    the same integers as the JAX package's on every host, and a resume
    recomputes the order from two scalars and fast-forwards to its cursor.

:class:`Resequencer`
    Workers tag each published chunk with its ventilation sequence number
    (the ``pst_det`` item argument, echoed as the chunk's ``det``); the
    resequencer holds chunks that arrive early and releases them strictly
    in ventilation order. The ventilator's in-flight cap bounds its buffer.

:class:`DeterministicCursor`
    Delivery order is ventilation order, so the consumption state is a
    frontier ``(epoch, global position, rows into the open chunk)``.

Sharding in this mode is a stride over the global order inside the
ventilator: host ``h`` of ``M`` feeds the positions ``p`` with
``(p - base + phase) % M == h``, so the round-robin of the per-host streams
is the single-host stream for every ``M``, and a job checkpointed on N
hosts resumes on M through :func:`merge_cursors`.

The JAX package also registers the resequencer as a watchdog probe, whose
``stats()`` then classify a stalled hole; that waits for the port of
``health.py`` (ROADMAP §A9). ``stats()`` is here already.
"""

import hashlib
import threading
import time
from collections import deque

MODE = 'deterministic'
STATE_VERSION = 1

_M64 = (1 << 64) - 1
_MISSING = object()


# --------------------------------------------------------------------------
# seed-stable permutation (counter-based: Feistel + cycle-walking)
# --------------------------------------------------------------------------

def epoch_key(seed, epoch):
    """64-bit permutation key of ``(seed, epoch)``, hashed so that nearby
    seeds and epochs give unrelated permutations."""
    digest = hashlib.md5('pst-det:{}:{}'.format(seed, epoch).encode()).digest()
    return int.from_bytes(digest[:8], 'little')


def _mix64(v):
    """splitmix64's finaliser on a Python int, mod 2^64."""
    v &= _M64
    v = ((v ^ (v >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    v = ((v ^ (v >> 27)) * 0x94D049BB133111EB) & _M64
    return v ^ (v >> 31)


def feistel_permute(index, n, key):
    """Position of ``index`` under the keyed permutation of ``[0, n)``: a
    4-round balanced Feistel network over the smallest even-bit domain
    covering ``n``, walking values outside ``[0, n)`` through it again."""
    if n <= 1:
        return 0
    if not 0 <= index < n:
        raise ValueError('index {} out of [0, {})'.format(index, n))
    half_bits = ((n - 1).bit_length() + 1) // 2
    mask = (1 << half_bits) - 1
    x = index
    while True:
        left, right = x >> half_bits, x & mask
        for rnd in range(4):
            left, right = right, left ^ (
                _mix64(right + key + 0x9E3779B97F4A7C15 * (rnd + 1)) & mask)
        x = (left << half_bits) | right
        if x < n:
            return x


def epoch_order(n, seed, epoch, shuffle=True):
    """``order[p]``: the item fed at global position ``p`` of ``epoch``;
    the identity with ``shuffle=False``."""
    if not shuffle:
        return list(range(n))
    key = epoch_key(seed, epoch)
    return [feistel_permute(p, n, key) for p in range(n)]


def shard_positions(n, base, cur_shard, shard_count, phase=0):
    """The global positions host ``cur_shard`` of ``shard_count`` feeds in
    one epoch: ``p`` in ``[base, n)`` with ``(p - base + phase) %
    shard_count == cur_shard``. ``base`` is the resume cursor's position (0
    for a fresh epoch); ``phase`` counts the positions fed in earlier epochs
    since the stride's base, mod ``shard_count``, so global item ``j`` lands
    on host ``j % shard_count`` across epoch boundaries too."""
    first = base + ((cur_shard - phase) % shard_count)
    return list(range(first, n, shard_count))


def order_digest(items, order):
    """Short digest of an epoch's fed order, by each item's identity."""
    digest = hashlib.md5()
    for index in order:
        item = items[index]
        identity = ((item.get('piece_index', index), item.get('shuffle_row_drop_partition'))
                    if isinstance(item, dict) else index)
        digest.update(repr(identity).encode())
    return digest.hexdigest()[:12]


# --------------------------------------------------------------------------
# chunk metadata
# --------------------------------------------------------------------------

HOLE_KEY = '__pst_det_hole__'


def hole_marker(det):
    """What a worker publishes for a ventilated item that made no chunk,
    so the resequencer's frontier passes its sequence number."""
    return {HOLE_KEY: 1, 'det': det}


def is_hole(chunk):
    return isinstance(chunk, dict) and bool(chunk.get(HOLE_KEY))


def chunk_det(chunk):
    """The ``{'seq', 'epoch', 'pos'}`` tag of a published chunk, or None."""
    return chunk.get('det') if isinstance(chunk, dict) else None


class ResequencedReads(object):
    """Mixin for worker pools: with a :class:`Resequencer` set,
    ``get_results()`` releases chunks in ventilation order. The pool
    provides ``_next_result()``, its own next result in arrival order."""

    _resequencer = None
    _arrivals = None

    def set_resequencer(self, resequencer):
        self._resequencer = resequencer
        self._arrivals = _Arrivals(self._next_result)

    def get_results(self):
        """The next chunk; end of data raises ``EmptyResultError``."""
        if self._resequencer is not None:
            return self._resequencer.next_chunk(self._arrivals)
        return self._next_result()


class _Arrivals(object):
    """A pool's results in arrival order, as :meth:`Resequencer.next_chunk`
    pulls them."""

    __slots__ = ('get_results',)

    def __init__(self, pull):
        self.get_results = pull


# --------------------------------------------------------------------------
# order restoration
# --------------------------------------------------------------------------

class Resequencer(object):
    """Bounded reorder buffer releasing chunks strictly in ventilation order.

    Driven by the consumer's thread (:meth:`next_chunk`); :meth:`stats` may
    be read from another, hence the lock (one acquisition a chunk). The JAX
    package's ``mark_satisfied`` (a quarantined row-group's hole) waits for
    the port of quarantine (ROADMAP §A9).
    ``max_buffer`` is a safety net far above the ventilator's in-flight cap.
    When the pool declares the end of data with chunks still held behind a
    hole, the verdict is re-polled for ``end_grace_s`` before it raises:
    the pool's end signal samples several counters without one lock.
    """

    def __init__(self, max_buffer=4096, end_grace_s=2.0):
        self._lock = threading.Lock()
        self._expected = 0
        self._buffer = {}
        self._wait_since = None   # when the current hole opened
        self._max_buffer = max_buffer
        self._out_of_order = 0
        self._end_grace_s = float(end_grace_s)

    def next_chunk(self, pool):
        """The next chunk in ventilation order, pulling ``pool.get_results()``
        as needed. The pool's end of data propagates; untagged payloads pass
        straight through."""
        from petastorm_tpu_torch.workers import EmptyResultError
        grace_deadline = None
        while True:
            with self._lock:
                chunk = self._pop_ready_locked()
            if chunk is not _MISSING:
                return chunk
            try:
                result = pool.get_results()
            except EmptyResultError:
                with self._lock:
                    buffered = len(self._buffer)
                if buffered:
                    now = time.monotonic()
                    if grace_deadline is None:
                        grace_deadline = now + self._end_grace_s
                    if now < grace_deadline:
                        time.sleep(0.01)
                        continue
                    raise RuntimeError(
                        'Resequencer: pool exhausted with {} chunk(s) buffered behind missing '
                        'ventilation seq {}; a published chunk was lost'.format(
                            buffered, self._expected))
                raise
            grace_deadline = None
            det = chunk_det(result)
            if det is None:
                return result
            seq = det.get('seq')
            with self._lock:
                if seq is None or seq == self._expected:
                    self._advance_locked()
                    return result
                if seq < self._expected:
                    continue    # a stale duplicate: dropping it keeps the order
                self._out_of_order += 1
                self._buffer[seq] = result
                if self._wait_since is None:
                    self._wait_since = time.monotonic()
                if len(self._buffer) > self._max_buffer:
                    raise RuntimeError(
                        'Resequencer buffer overflow: {} chunks held waiting for ventilation '
                        'seq {}; sequence accounting is broken'.format(
                            len(self._buffer), self._expected))

    def _pop_ready_locked(self):
        chunk = self._buffer.pop(self._expected, _MISSING)
        if chunk is not _MISSING:
            self._advance_locked()
        return chunk

    def _advance_locked(self):
        self._expected += 1
        self._wait_since = time.monotonic() if self._buffer else None

    def stats(self):
        """How long the stream has been held at a hole and how much waits
        behind it."""
        with self._lock:
            waiting = (time.monotonic() - self._wait_since
                       if self._wait_since is not None and self._buffer else 0.0)
            return {'expected_seq': self._expected,
                    'buffered': len(self._buffer),
                    'waiting_s': round(waiting, 3),
                    'out_of_order_total': self._out_of_order}

    def buffered_nbytes(self):
        """Estimated bytes of the chunks held behind a hole: the memory
        governor's ``resequencer`` pool (the buffer is bounded by the
        ventilator's window, so walking it a tick is cheap)."""
        from petastorm_tpu_torch.membudget import approx_nbytes
        with self._lock:
            chunks = list(self._buffer.values())
        return sum(approx_nbytes(chunk) for chunk in chunks)

    def reset(self):
        """Restart the sequence (``Reader.reset()``, before the ventilator's)."""
        with self._lock:
            self._expected = 0
            self._buffer.clear()
            self._wait_since = None


# --------------------------------------------------------------------------
# stream cursor
# --------------------------------------------------------------------------

class DeterministicCursor(object):
    """Consumption tracking in deterministic mode: the stream's frontier.

    Chunks arrive in ventilation order, so the state is ``(epoch, global
    position of the open item, rows consumed into it)``. A resume does not
    skip chunks consumer-side: the ventilator fast-forwards to the cursor,
    and only the first chunk's ``rows_into`` is dropped. Items delivered
    but not yet fully attributed (rows buffered downstream under
    row-granular accounting) wait in ``_open``; the frontier passes an item
    only when all its rows were attributed. Thread-safe, as
    ``ConsumptionTracker`` is.
    """

    def __init__(self, resume_state=None):
        self._lock = threading.Lock()
        self._open = deque()     # [epoch, pos, total_rows, rows_done]
        epoch, pos, rows = 1, 0, 0
        if resume_state:
            if resume_state.get('mode') != MODE:
                raise ValueError(
                    'resume_state is not a deterministic-mode cursor (mode={!r}); it was '
                    'captured without deterministic=True'.format(resume_state.get('mode')))
            if resume_state.get('version') != STATE_VERSION:
                raise ValueError('Unsupported deterministic cursor version {!r}'.format(
                    resume_state.get('version')))
            epoch = int(resume_state.get('epoch', 1))
            pos = int(resume_state.get('pos', 0))
            rows = int(resume_state.get('rows_into', 0))
        self.start_epoch = epoch
        self.start_pos = pos
        self.start_rows = rows
        self._frontier = (epoch, pos, rows)
        self._resume_pending = rows > 0

    def normalize(self, n_items):
        """Fold a cursor at an epoch's end (``pos == n_items``) onto the next
        epoch's start."""
        with self._lock:
            while n_items and self.start_pos >= n_items:
                self.start_epoch += 1
                self.start_pos = 0
                self.start_rows = 0
                self._resume_pending = False
                self._frontier = (self.start_epoch, 0, 0)

    def on_chunk(self, key, total_rows, det=None):
        """The chunk of global position ``det['pos']`` arrived (in order);
        returns the leading rows to drop (the resume chunk's partial)."""
        if det is None:
            return 0
        with self._lock:
            skip = 0
            if self._resume_pending:
                if det.get('epoch') == self.start_epoch and det.get('pos') == self.start_pos:
                    skip = min(self.start_rows, total_rows)
                    self._resume_pending = False
                elif (det.get('epoch', 0) > self.start_epoch
                      or (det.get('epoch') == self.start_epoch
                          and det.get('pos', 0) > self.start_pos)):
                    # A chunk past the cursor: the cursor's chunk went to
                    # another shard of a resharded resume.
                    self._resume_pending = False
            self._open.append([det.get('epoch'), det.get('pos'), total_rows, skip])
            self._commit_locked()
            return skip

    def rows_yielded(self, key, n):
        """Attribute ``n`` consumed rows to open items in delivery order."""
        with self._lock:
            while n > 0 and self._open:
                head = self._open[0]
                free = head[2] - head[3]
                if free <= 0:
                    self._commit_locked()
                    continue
                take = min(n, free)
                head[3] += take
                n -= take
                self._commit_locked()

    def _commit_locked(self):
        while self._open:
            head = self._open[0]
            if head[3] < head[2]:
                self._frontier = (head[0], head[1], head[3])
                return
            self._open.popleft()
            self._frontier = (head[0], head[1] + 1, 0)

    def state_dict(self):
        with self._lock:
            epoch, pos, rows = self._frontier
            if self._resume_pending:
                epoch, pos, rows = self.start_epoch, self.start_pos, self.start_rows
            return {'version': STATE_VERSION, 'mode': MODE, 'epoch': int(epoch),
                    'pos': int(pos), 'rows_into': int(rows)}


def det_tag_cursor(det, rows_into=0):
    """The resume cursor of the stream position after the chunk tagged
    ``det`` (or, with ``rows_into > 0``, ``rows_into`` rows into it)."""
    if not isinstance(det, dict) or det.get('pos') is None:
        raise ValueError('det_tag_cursor needs a deterministic chunk tag with epoch/pos, '
                         'got {!r}'.format(det))
    rows_into = int(rows_into)
    pos = int(det['pos']) if rows_into > 0 else int(det['pos']) + 1
    return {'version': STATE_VERSION, 'mode': MODE, 'epoch': int(det.get('epoch', 1)),
            'pos': pos, 'rows_into': rows_into if rows_into > 0 else 0}


def merge_cursors(states):
    """The global cursor of a sharded job: the least-advanced host cursor.

    Every multi-host resume needs it: a host's own cursor is its strided
    frontier, and the reader refuses an unmerged multi-shard cursor. Pass
    all N hosts' cursors and give the merged one to every resuming host;
    positions between the slowest and fastest frontier re-deliver (at most
    ``N - 1`` items), and a faster host's ``rows_into`` is dropped.
    """
    cursors, configs = [], []
    shard_counts, shards_seen = set(), set()
    for state in states:
        if not isinstance(state, dict) or state.get('mode') != MODE:
            raise ValueError('merge_cursors needs deterministic-mode cursors, got {!r}'.format(
                state))
        if state.get('shard_count') is not None:
            shard_counts.add(int(state['shard_count']))
            if state.get('cur_shard') is not None:
                shards_seen.add(int(state['cur_shard']))
        if isinstance(state.get('config'), dict):
            configs.append(state['config'])
        cursors.append((int(state.get('epoch', 1)), int(state.get('pos', 0)),
                        int(state.get('rows_into', 0))))
    if not cursors:
        raise ValueError('merge_cursors needs at least one cursor')
    if len(shard_counts) > 1:
        raise ValueError('cursors disagree on shard_count ({}): they were not captured by one '
                         'job'.format(sorted(shard_counts)))
    if shard_counts:
        count = shard_counts.pop()
        if shards_seen and shards_seen != set(range(count)):
            raise ValueError(
                "merge_cursors got shards {} of a {}-shard job; the global cursor needs every "
                "host's cursor".format(sorted(shards_seen), count))
    if configs and any(c != configs[0] for c in configs[1:]):
        raise ValueError('cursors carry differing reader config fingerprints: they were not '
                         'captured by one job')
    epoch, pos, rows = min(cursors)
    if (epoch, pos) != max(cursors)[:2]:
        rows = 0   # a partial row offset means something only on an agreed item
    merged = {'version': STATE_VERSION, 'mode': MODE, 'merged': True,
              'epoch': epoch, 'pos': pos, 'rows_into': rows}
    if configs:
        merged['config'] = configs[0]
    return merged
