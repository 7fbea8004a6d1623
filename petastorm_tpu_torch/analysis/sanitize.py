"""Opt-in runtime sanitizer: stale-view borrow tags + lock-order recorder.

The port's copy of ``petastorm_tpu/analysis/sanitize.py``, armed by
``PSTT_SANITIZE`` with the JAX grammar. It adds :func:`counters` (arenas
poisoned, the recorder's edges and violations, so a run can show that it
was armed) and the ``threading.Condition`` protocol on :class:`TrackedLock`.

``PSTT_SANITIZE=1`` arms two dynamic checks that complement the
static analyzer (``python -m petastorm_tpu_torch.tools.pstlint``). Both target
the codebase's hardest bug classes — the ones reviews kept catching by
hand:

**Use-after-reclaim on zero-copy views.** The staging arenas
(``staging.ArenaPool``) and the chunk store's mmap entries serve numpy
views whose backing memory is *recycled*; a consumer (or an engine bug)
holding a view past reclamation reads bytes that now belong to a newer
batch — silent corruption, bit-identical shapes, no crash. Armed, every
arena reclaim **poisons** the buffers (0xCB fill) and bumps the arena's
``view_epoch``; views handed out through :func:`guard_view` carry a borrow
tag (the epoch at hand-out) and **raise** :class:`StaleViewError` at touch
time — indexing, ufunc arithmetic, ``np.*`` calls — turning a
heisenbug into a stack trace at the exact stale access.

**Lock-order inversions.** :func:`tracked_lock` returns a plain
``threading.Lock`` when unarmed (zero overhead) and a recording wrapper
when armed: the process-wide :class:`LockOrderRecorder` keeps a per-thread
held stack, accretes the observed acquired-before edge set, and raises
:class:`LockOrderViolation` *before blocking* when an acquisition inverts
a known edge — i.e. the deadlock is reported by the thread that would have
deadlocked, with both orders' first-seen sites. Seed it with the static
analyzer's graph (:func:`LockOrderRecorder.load_static_edges` /
``pstlint --emit-lock-graph``) and production traffic is asserted against
the statically proven order, not just against itself.

Both checks have seeded-bug proofs wired as fault sites
(``arena-stale-view``, ``lock-order-invert`` in
``PSTT_FAULTS``) — ``tests/test_torch_pstlint.py`` injects each bug
and asserts the armed sanitizer fails loudly where the unarmed pipeline
corrupts silently.
"""

import logging
import os
import threading

import numpy as np

logger = logging.getLogger(__name__)

ENV_VAR = 'PSTT_SANITIZE'

#: Fill byte for reclaimed arena buffers: 0xCB reads as huge floats /
#: distinctive ints, so even an unguarded stale read is *visible* in data.
POISON_BYTE = 0xCB


class StaleViewError(RuntimeError):
    """A borrow-tagged view was touched after its arena was reclaimed."""


class LockOrderViolation(RuntimeError):
    """An acquisition inverted the recorded/static lock order."""


def sanitize_active():
    """True when ``PSTT_SANITIZE`` is set to a truthy value.
    Read per call (cheap) so tests can flip it between pipelines in one
    process."""
    value = os.environ.get(ENV_VAR, '').strip().lower()
    return value not in ('', '0', 'false', 'off', 'no')


# --------------------------------------------------------------------------
# stale-view borrow tags
# --------------------------------------------------------------------------

class _GuardedView(np.ndarray):
    """ndarray view carrying a borrow tag: (epoch source, epoch at borrow).

    Touch paths — indexing, assignment, ufuncs (which covers arithmetic
    and reductions like ``.sum()``), ``np.*`` dispatch, and explicit
    materialization — validate the tag first and raise
    :class:`StaleViewError` when the source has moved on."""

    _pst_source = None
    _pst_epoch = None

    def __array_finalize__(self, obj):
        if obj is not None:
            self._pst_source = getattr(obj, '_pst_source', None)
            self._pst_epoch = getattr(obj, '_pst_epoch', None)

    def _pst_check(self):
        source = self._pst_source
        if source is None:
            return
        current = getattr(source, 'view_epoch', None)
        if current != self._pst_epoch:
            raise StaleViewError(
                'use-after-reclaim: this view was borrowed from {} at '
                'epoch {} but the buffer was reclaimed (now epoch {}) — '
                'the memory belongs to a different batch. Hold the staged '
                'batch (add_hold) or copy before the arena retires.'.format(
                    source, self._pst_epoch, current))

    def __getitem__(self, key):
        self._pst_check()
        return super().__getitem__(key)

    def __setitem__(self, key, value):
        self._pst_check()
        return super().__setitem__(key, value)

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        for operand in inputs:
            if isinstance(operand, _GuardedView):
                operand._pst_check()
        cleaned = [np.asarray(x) if isinstance(x, _GuardedView) else x
                   for x in inputs]
        out = kwargs.get('out')
        if out is not None:
            for target in out:
                if isinstance(target, _GuardedView):
                    target._pst_check()
            kwargs['out'] = tuple(
                x.view(np.ndarray) if isinstance(x, _GuardedView) else x
                for x in out)
        return getattr(ufunc, method)(*cleaned, **kwargs)

    def __array_function__(self, func, types, args, kwargs):
        for arg in args:
            if isinstance(arg, _GuardedView):
                arg._pst_check()
        return super().__array_function__(func, types, args, kwargs)

    def __array__(self, dtype=None):
        self._pst_check()
        base = self.view(np.ndarray)
        return base if dtype is None else base.astype(dtype, copy=False)

    def __repr__(self):
        try:
            self._pst_check()
        except StaleViewError:
            return '<stale _GuardedView epoch={}>'.format(self._pst_epoch)
        return super().__repr__()


def guard_view(array, epoch_source):
    """Borrow-tag ``array`` against ``epoch_source.view_epoch``. Returns
    the array unchanged when the sanitizer is unarmed — the production
    path never pays the subclass dispatch."""
    if not sanitize_active():
        return array
    view = np.asarray(array).view(_GuardedView)
    view._pst_source = epoch_source
    view._pst_epoch = getattr(epoch_source, 'view_epoch', None)
    return view


_poisoned = 0


def poison(buffers):
    """Overwrite reclaimed buffers with the poison pattern. Best-effort:
    a dtype that cannot be byte-viewed falls back to zeroing, and a
    read-only buffer is left alone (it cannot be recycled into a new
    batch anyway)."""
    if not sanitize_active():
        return
    global _poisoned
    _poisoned += 1
    for array in buffers:
        try:
            array.view(np.uint8).fill(POISON_BYTE)
        except (ValueError, TypeError):
            try:
                array.fill(0)
            except (ValueError, TypeError):  # pragma: no cover - exotic dtype
                continue


# --------------------------------------------------------------------------
# lock-order recorder
# --------------------------------------------------------------------------

class LockOrderRecorder(object):
    """Process-wide observed lock-order graph with inversion detection.

    ``on_acquire(name)`` is called *before* the underlying lock blocks:
    when the calling thread already holds ``a`` and the combined
    static+observed edge set contains ``(name, a)``, the acquisition is an
    inversion — two threads running both paths concurrently can deadlock —
    and the recorder raises (mode='raise', default) or records the
    violation (mode='record', for probes that must not throw)."""

    def __init__(self, static_edges=None, mode='raise'):
        self._mutex = threading.Lock()
        self._tls = threading.local()
        self._edges = {}          # (a, b) -> first-seen description
        self._static = set()
        #: Incremental successor map over observed+static edges: edges are
        #: append-only (except reset()), so the per-acquisition reachability
        #: BFS must not rebuild the adjacency from scratch under the
        #: process-wide mutex on every nested acquire.
        self._succ = {}
        self._violations = []
        #: Acquisitions seen (a count only: a racy increment may drop one).
        self.acquisitions = 0
        self.mode = mode
        if static_edges:
            self.load_static_edges(static_edges)

    def _add_succ_locked(self, a, b):
        self._succ.setdefault(a, set()).add(b)

    def load_static_edges(self, edges):
        """Seed the acquired-before contract from the static analyzer
        (``pstlint --emit-lock-graph`` / ``lock_order.static_edges``)."""
        with self._mutex:
            for a, b in edges:
                self._static.add((a, b))
                self._add_succ_locked(a, b)

    def _held(self):
        stack = getattr(self._tls, 'stack', None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def held(self):
        return tuple(self._held())

    def _reaches_locked(self, start, targets):
        """True when ``start`` can reach any of ``targets`` through the
        combined observed+static edge set (caller holds ``self._mutex``).
        Transitive on purpose: recorded adjacent edges a->b, b->c plus an
        acquisition of a while holding c is the same deadlock the static
        checker's SCC pass would flag."""
        seen, frontier = {start}, [start]
        while frontier:
            node = frontier.pop()
            if node in targets:
                return True
            for nxt in self._succ.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    frontier.append(nxt)
        return False

    def on_acquire(self, name, blocking=True):
        """Record (and police) an acquisition attempt. ``blocking=False``
        attempts cannot deadlock — they give up instead of waiting — so
        they are pushed onto the held stack (nesting *under* them still
        constrains later blocking acquires) but create no edge and raise
        no violation."""
        self.acquisitions += 1
        stack = self._held()
        if stack and blocking:
            held = [h for h in stack if h != name]
            top = stack[-1]
            violation = None
            with self._mutex:
                # Inversion = the new lock already reaches ANY held lock
                # in the acquired-before relation (direct or transitive):
                # some other thread may take that path and block on what
                # this thread holds.
                if held and self._reaches_locked(name, set(held)):
                    violation = (
                        'lock-order inversion: acquiring {!r} while '
                        'holding {} — the recorded order already has {!r} '
                        'acquired (possibly transitively) before the held '
                        'lock(s); two threads running both paths can '
                        'deadlock'.format(name, held, name))
                    self._violations.append(violation)
                elif top != name:
                    if (top, name) not in self._edges:
                        self._edges[(top, name)] = \
                            'first observed on thread {}'.format(
                                threading.current_thread().name)
                        self._add_succ_locked(top, name)
            if violation is not None:
                logger.error('pstt-sanitize: %s', violation)
                if self.mode == 'raise':
                    raise LockOrderViolation(violation)
        stack.append(name)

    def on_release(self, name):
        stack = self._held()
        # Remove the most recent occurrence: releases may be out of LIFO
        # order (hand-over-hand), and a miss is not an error.
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == name:
                del stack[i]
                return

    def edges(self):
        with self._mutex:
            return sorted(self._edges)

    def violations(self):
        with self._mutex:
            return list(self._violations)

    def reset(self):
        with self._mutex:
            self._edges.clear()
            self._succ.clear()
            for a, b in self._static:
                self._add_succ_locked(a, b)
            self._violations[:] = []
            self.acquisitions = 0
        self._tls = threading.local()


_recorder = None
_recorder_mutex = threading.Lock()


def get_recorder():
    """The process-wide recorder (created on first armed use)."""
    global _recorder
    with _recorder_mutex:
        if _recorder is None:
            _recorder = LockOrderRecorder()
        return _recorder


def set_recorder(recorder):
    """Swap the process recorder (test isolation). Returns the previous
    one."""
    global _recorder
    with _recorder_mutex:
        previous, _recorder = _recorder, recorder
        return previous


class TrackedLock(object):
    """``threading.Lock`` wrapper feeding the process recorder. Only ever
    constructed when the sanitizer is armed; the unarmed path gets a
    plain Lock from :func:`tracked_lock` with zero indirection."""

    def __init__(self, name, recorder=None):
        self.name = name
        self._lock = threading.Lock()
        self._recorder = recorder

    def _rec(self):
        return self._recorder if self._recorder is not None \
            else get_recorder()

    def acquire(self, blocking=True, timeout=-1):
        # Disarming mid-process silences an already-tracked lock (the
        # armed=loud / unarmed=silent contract follows the env var, not
        # the construction snapshot). The reverse direction necessarily
        # IS construction-time: arm before building the pipeline, same as
        # every other env knob (TRACE_DIR, LINEAGE_DIR).
        if not sanitize_active():
            return self._lock.acquire(blocking, timeout)
        # Record (and possibly raise) BEFORE blocking: the inversion must
        # be reported by the thread that would have deadlocked. A
        # non-blocking attempt is exempt from violations — it gives up
        # instead of deadlocking (mirrors the static checker's
        # `if lock.acquire(blocking=False):` exemption).
        self._rec().on_acquire(self.name, blocking=blocking)
        ok = self._lock.acquire(blocking, timeout)
        if not ok:
            self._rec().on_release(self.name)
        return ok

    def release(self):
        self._lock.release()
        # Unconditional: a held-stack entry pushed while armed must pop
        # even if the env was flipped off mid-hold (on_release is a no-op
        # when the name is absent).
        self._rec().on_release(self.name)

    def locked(self):
        return self._lock.locked()

    # threading.Condition's protocol: a Condition over a TrackedLock
    # releases and re-takes it through the recorder around each wait.
    def _release_save(self):
        self.release()

    def _acquire_restore(self, _state):
        self.acquire()

    def _is_owned(self):
        if self._lock.acquire(False):
            self._lock.release()
            return False
        return True

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.release()
        return False


def counters():
    """What the sanitizer did in this process: ``poisoned`` (reclaims
    that poisoned an arena), ``acquisitions`` of tracked locks, ``edges``
    (lock-order edges the recorder observed: a tracked lock taken while
    another is held) and ``violations``."""
    recorder = get_recorder()
    return {'poisoned': _poisoned, 'acquisitions': recorder.acquisitions,
            'edges': len(recorder.edges()), 'violations': len(recorder.violations())}


def reset_counters():
    """Zero :func:`counters` (the recorder's edges and violations too)."""
    global _poisoned
    _poisoned = 0
    get_recorder().reset()


def tracked_lock(name, recorder=None):
    """A mutex participating in lock-order recording when the sanitizer
    is armed; a plain ``threading.Lock`` otherwise. ``name`` should match
    the static analyzer's node id (``module:Class.attr``) so the runtime
    and static graphs overlay.

    Arming is **construction-time** in the unarmed->armed direction (a
    lock built unarmed is a plain Lock forever — arm the env before
    building the pipeline, exactly like ``PSTT_TRACE_DIR`` /
    ``PSTT_LINEAGE_DIR`` arm tracers/ledgers built after), but a
    :class:`TrackedLock` re-checks the env per acquire, so *disarming*
    mid-process silences it immediately."""
    if not sanitize_active():
        return threading.Lock()
    return TrackedLock(name, recorder=recorder)


# --------------------------------------------------------------------------
# seeded-bug injection (PSTT_FAULTS consumers)
# --------------------------------------------------------------------------

_inversion_pair = None   # (armed_flag, lock_a, lock_b)
_inversion_mutex = threading.Lock()


def maybe_inject_lock_inversion():
    """Consume the ``lock-order-invert`` fault site: acquire a canonical
    pair of tracked locks in inverted order. With the sanitizer armed the
    recorder raises :class:`LockOrderViolation` (which the caller lets
    propagate to the consumer); unarmed, the inversion is silent — exactly
    the bug class the sanitizer exists to catch. Near-zero cost when the
    site is inactive (one env read + dict lookup)."""
    from petastorm_tpu_torch import faults
    injector = faults.get_injector()
    if injector.spec('lock-order-invert') is None:
        return
    # The canary pair is keyed on the armed flag: sanitize_active() is
    # documented to be flippable between pipelines in one process, and a
    # pair cached under the other arming state would invert the
    # armed=loud / unarmed=silent contract.
    armed = sanitize_active()
    global _inversion_pair
    with _inversion_mutex:
        if _inversion_pair is None or _inversion_pair[0] != armed:
            a = tracked_lock('pstt-sanitize-canary-a')
            b = tracked_lock('pstt-sanitize-canary-b')
            # Establish the canonical order a -> b (records the edge when
            # the recorder is armed).
            with a:
                with b:
                    pass
            _inversion_pair = (armed, a, b)
    _, a, b = _inversion_pair
    if not injector.should_fire('lock-order-invert'):
        return
    logger.warning('fault injection: lock-order-invert acquiring the '
                   'canary pair in inverted order')
    with b:       # inverted: the recorder sees b held while acquiring a
        with a:
            pass
