"""Pipeline health supervision: heartbeats, stall diagnosis, recovery.

Counterpart of ``petastorm_tpu/health.py`` (and of the health half of
``petastorm_tpu/fleet/control_plane.py:367-415``'s ``PipelineSupervisor``,
:class:`PipelineSupervisor` here).

:class:`Heartbeat` / :class:`HeartbeatRegistry`
    Every stage (the reader's ventilator, its result handoff and its worker
    pool, the staging engine's assemble and dispatch threads, the
    ``TorchLoader`` consumer) registers a named heartbeat and *beats* on its
    hot path: two attribute stores, a ``time.monotonic()`` stamp and a
    state label (``'reader-wait'``, ``'device_put'``, ...), no lock. Each
    heartbeat is written by one thread. The label turns a stale stamp into
    a diagnosis: it says what the stage was last doing.

:class:`Watchdog`
    A supervisor thread (``pstt-watchdog``) with per-stage deadlines. On a
    stall it (a) classifies it (:func:`classify_stall`) from the beat ages,
    the labels and the registered probes' snapshots (queue depths, staging
    counters, worker liveness, the resequencer, the memory governor); (b)
    records a diagnosis (an all-thread stack dump, the beat table, the
    probes) into ``Reader.diagnostics()`` / ``TorchLoader.stats``, as a
    trace instant and in ``pst_watchdog_*`` counters; (c) runs the soft
    recoveries registered for the classification, and if the same stall
    outlives ``escalation x deadline`` (and is not in :data:`SOFT_ONLY`),
    delivers a :class:`~petastorm_tpu_torch.errors.PipelineStallError`
    carrying the diagnosis, after a flight-recorder dump
    (:mod:`~petastorm_tpu_torch.flight_recorder`) when one is armed.

The watchdog never waits on the card: its probes read Python counters,
never ``torch.cuda.synchronize``, ``.item()`` or an event's
``synchronize``, so a check during a graph replay returns at once. The
port's dispatch stage only issues its copies; it labels its heartbeat
``'device_put'`` before the ``device-put-delay`` fault site and the copy
issue, and ``'ready-wait'`` before it waits on a copy's event, so a hung
copy classifies ``dispatch-hung`` as in the JAX package.

Armed by ``watchdog=True`` (or ``stall_timeout_s``) on the readers and the
loader, or process-wide by ``PSTT_WATCHDOG`` (the JAX grammar: ``1``/
``true`` = on with the default deadline, a number = on with that deadline
in seconds, ``0``/``off``/``false``/``no``/unset = off). Off by default.
"""

import logging
import os
import sys
import threading
import time
import traceback

from petastorm_tpu_torch import metrics
from petastorm_tpu_torch.analysis import sanitize
from petastorm_tpu_torch.errors import PipelineStallError
from petastorm_tpu_torch.membudget import STATE_BREACH, STATE_DEGRADE, STATE_SHED

logger = logging.getLogger(__name__)

ENV_VAR = 'PSTT_WATCHDOG'
THREAD_NAME = 'pstt-watchdog'

#: Default per-stage stall deadline (seconds): a pipeline that produces
#: nothing for a minute is stuck, while a cold read or a long first step
#: can take tens of seconds.
DEFAULT_STALL_TIMEOUT_S = 60.0

#: A stall that outlives its soft recovery for this multiple of its stage's
#: deadline escalates to a :class:`PipelineStallError`.
DEFAULT_ESCALATION_FACTOR = 2.0

# The classification vocabulary (the JAX package's labels).
READER_STARVED = 'reader-starved'
WORKER_POOL_DEAD = 'worker-pool-dead'
ASSEMBLE_STUCK = 'assemble-stuck'
DISPATCH_HUNG = 'dispatch-hung'
CONSUMER_NOT_DRAINING = 'consumer-not-draining'
ARENA_POOL_WEDGED = 'arena-pool-wedged'
REMOTE_SERVER_DEAD = 'remote-server-dead'
SERVER_DRAINING = 'server-draining'
SERVER_OVERLOADED = 'server-overloaded'
RESEQUENCER_STALLED = 'resequencer-stalled'
#: The memory governor sits at degrade or worse: a quiet pipeline is the
#: governor's episode (caches evicting, ventilation paced), not a stage
#: fault. Soft: the governor owns the hard path (its own typed error).
MEMORY_PRESSURE = 'memory-pressure'

#: Governor states that turn a starvation-shaped stall into memory-pressure.
_MEM_DEGRADED_STATES = (STATE_DEGRADE, STATE_SHED, STATE_BREACH)

#: What the memory overlay reinterprets: the symptoms that degradation
#: itself causes. A dead worker, a wedged publish or a hung copy keeps its
#: own classification and its escalation.
_MEM_REINTERPRETED = frozenset({READER_STARVED, ARENA_POOL_WEDGED, SERVER_OVERLOADED})

#: Pseudo-classification: every stale stage waits on another and no
#: culprit has passed its own deadline; the watchdog records nothing.
PIPELINE_WAITING = 'pipeline-waiting'

#: Never escalated: a consumer that stopped draining is the training loop's
#: choice (a long first step, an evaluation, a checkpoint); a draining
#: server an operator's; memory pressure the governor's.
SOFT_ONLY = frozenset({CONSUMER_NOT_DRAINING, SERVER_DRAINING, MEMORY_PRESSURE})

#: States of a stage parked on its upstream or on the consumer: a stale
#: heartbeat in one of them is a symptom, not a culprit.
_WAITING_STATES = frozenset({'stageq-get', 'stageq-put', 'queue-wait', 'poll', 'idle'})


def watchdog_enabled(explicit=None):
    """``explicit`` when it is not None, else whether ``PSTT_WATCHDOG``
    arms the watchdog (unset, empty, ``0``, ``off``, ``false``, ``no``:
    off)."""
    if explicit is not None:
        return bool(explicit)
    raw = os.environ.get(ENV_VAR, '').strip().lower()
    return raw not in ('', '0', 'off', 'false', 'no')


def env_stall_timeout():
    """A positive number in ``PSTT_WATCHDOG`` is the default deadline in
    seconds; anything else gives None (the built-in default)."""
    raw = os.environ.get(ENV_VAR, '').strip()
    try:
        value = float(raw)
    except ValueError:
        return None
    return value if value > 0 else None


def snapshot_stacks():
    """Every live thread's stack as ``[(name, ident, [(file, line, function),
    ...]), ...]``, outermost frame first: a walk of the frames and nothing
    more, so that a watchdog's check holds the GIL for a fraction of a
    millisecond (formatting with source lines takes tens of milliseconds
    when busy threads take the GIL in turns). :func:`format_stacks` makes
    the text."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for ident, frame in sorted(sys._current_frames().items()):
        frames = []
        while frame is not None:
            frames.append((frame.f_code.co_filename, frame.f_lineno, frame.f_code.co_name))
            frame = frame.f_back
        frames.reverse()
        out.append((names.get(ident, '?'), ident, frames))
    return out


def format_stacks(snapshot):
    """A :func:`snapshot_stacks` as text, each frame with its source line."""
    return '\n'.join('Thread {} ({}):\n{}'.format(
        name, ident, ''.join(traceback.StackSummary.from_list(
            [(path, line, function, None) for path, line, function in frames]).format()))
        for name, ident, frames in snapshot)


def dump_all_stacks():
    """Every live thread's stack, formatted as one string."""
    return format_stacks(snapshot_stacks())


class Heartbeat(object):
    """One stage's liveness record, beaten by one thread and read by the
    watchdog. ``beat()`` is two attribute stores and a count."""

    __slots__ = ('name', 'stall_timeout_s', 'last_beat', 'state', 'beats')

    def __init__(self, name, stall_timeout_s):
        self.name = name
        self.stall_timeout_s = stall_timeout_s
        self.last_beat = time.monotonic()
        self.state = 'idle'
        self.beats = 0

    def beat(self, state=None):
        if state is not None:
            self.state = state
        self.last_beat = time.monotonic()
        self.beats += 1

    def age(self, now=None):
        return (now if now is not None else time.monotonic()) - self.last_beat

    def stalled(self, now=None):
        # 'idle' is explicit quiescence: not started yet, or finished.
        if self.state == 'idle':
            return False
        return self.stall_timeout_s is not None and self.age(now) > self.stall_timeout_s


class HeartbeatRegistry(object):
    """Named heartbeats, probes and recoveries of one pipeline.

    ``stall_timeouts`` maps a stage name (or ``'default'``) to a deadline in
    seconds; a scalar applies to every stage; the default is
    ``PSTT_WATCHDOG``'s number, else :data:`DEFAULT_STALL_TIMEOUT_S`.
    """

    def __init__(self, stall_timeouts=None):
        # Lock-order-recorded when PSTT_SANITIZE is armed (the name is
        # pstlint's static graph node), a plain lock otherwise.
        self._lock = sanitize.tracked_lock('petastorm_tpu_torch.health:HeartbeatRegistry._lock')
        self._beats = {}
        self._probes = {}
        self._recoveries = {}     # classification -> [fn, ...]
        env_default = env_stall_timeout()
        if stall_timeouts is None:
            stall_timeouts = {}
        elif not isinstance(stall_timeouts, dict):
            stall_timeouts = {'default': float(stall_timeouts)}
        self._timeouts = dict(stall_timeouts)
        if 'default' not in self._timeouts:
            self._timeouts['default'] = (env_default if env_default is not None
                                         else DEFAULT_STALL_TIMEOUT_S)

    def timeout_for(self, name):
        return self._timeouts.get(name, self._timeouts['default'])

    def register(self, name, stall_timeout_s=None):
        """The heartbeat of ``name``, made on first call."""
        with self._lock:
            hb = self._beats.get(name)
            if hb is None:
                hb = Heartbeat(name, stall_timeout_s if stall_timeout_s is not None
                               else self.timeout_for(name))
                self._beats[name] = hb
            return hb

    def unregister(self, name):
        with self._lock:
            self._beats.pop(name, None)
            self._probes.pop(name, None)

    def register_probe(self, name, fn):
        """``fn() -> dict`` sampled into every diagnosis; it must not block
        (its exceptions land in the snapshot)."""
        with self._lock:
            self._probes[name] = fn

    def register_recovery(self, classification, fn):
        """``fn(diagnosis) -> bool``: a soft recovery for a stall of
        ``classification`` (True: it acted). It runs on the watchdog thread."""
        with self._lock:
            self._recoveries.setdefault(classification, []).append(fn)

    def recoveries_for(self, classification):
        with self._lock:
            return list(self._recoveries.get(classification, ()))

    def beat_table(self, now=None):
        now = now if now is not None else time.monotonic()
        with self._lock:
            return {name: {'age_s': round(hb.age(now), 3), 'state': hb.state,
                           'beats': hb.beats, 'stall_timeout_s': hb.stall_timeout_s}
                    for name, hb in self._beats.items()}

    def probe_snapshot(self):
        with self._lock:
            probes = list(self._probes.items())
        out = {}
        for name, fn in probes:
            try:
                out[name] = fn()
            except Exception as e:  # noqa: BLE001 - a probe must not kill the dog
                out[name] = {'probe_error': repr(e)}
        return out

    def stalled(self, now=None):
        """Heartbeats past their deadline, the stalest first."""
        now = now if now is not None else time.monotonic()
        with self._lock:
            late = [hb for hb in self._beats.values() if hb.stalled(now)]
        return sorted(late, key=lambda hb: hb.age(now), reverse=True)

    def min_timeout(self):
        with self._lock:
            timeouts = [hb.stall_timeout_s for hb in self._beats.values()
                        if hb.stall_timeout_s is not None]
        timeouts.append(self._timeouts['default'])
        return min(timeouts)


def classify_stall(beats, probes):
    """``(classification, stage, detail)`` of a stall, from the beat table
    (``name -> {age_s, state, stall_timeout_s}``) and the probes' snapshots.

    It walks from the upstream culprits down: a stage parked in a waiting
    state is a symptom, so the blame lands on the stage last seen working.
    With the memory governor armed at degrade or worse, the
    starvation-shaped results (:data:`_MEM_REINTERPRETED`) become the
    soft-only ``memory-pressure``; genuine faults keep their label.
    """
    classification, stage, detail = _classify_stall_stages(beats, probes)
    memory = probes.get('memory') or {}
    if memory.get('armed') and memory.get('state') in _MEM_DEGRADED_STATES \
            and classification in _MEM_REINTERPRETED:
        return (MEMORY_PRESSURE, 'memory',
                'host memory governor at {!r} ({} of {} budget bytes, {:.0%}) — would otherwise '
                'classify {}: {}'.format(memory.get('state'), memory.get('accounted_bytes'),
                                        memory.get('budget_bytes'), memory.get('frac') or 0.0,
                                        classification, detail))
    return classification, stage, detail


def _classify_stall_stages(beats, probes):
    def stale(name):
        entry = beats.get(name)
        return (entry is not None and entry['stall_timeout_s'] is not None
                and entry['state'] != 'idle' and entry['age_s'] > entry['stall_timeout_s'])

    def state(name):
        entry = beats.get(name, None)
        return entry['state'] if entry else None

    # A dead worker process outranks every downstream symptom.
    pool = probes.get('worker-pool', {})
    dead_workers = pool.get('dead_workers') or []
    if dead_workers:
        return (WORKER_POOL_DEAD, 'worker-pool',
                'worker process(es) {} are dead (the pool respawns them on its next '
                'get_results poll while its restart budget lasts)'.format(dead_workers))

    # Deterministic mode: chunks held behind a sequence hole while the
    # handoff went quiet: one item never published.
    resequencer = probes.get('resequencer') or {}
    if resequencer.get('buffered', 0) > 0 and resequencer.get('waiting_s', 0) > 0 \
            and (stale('reader-handoff') or stale('consumer')
                 or (stale('assemble') and state('assemble') == 'reader-wait')):
        return (RESEQUENCER_STALLED, 'resequencer',
                'deterministic resequencer has held {} chunk(s) for {}s waiting for ventilation '
                'seq {} — one item never published'.format(resequencer.get('buffered'),
                                                           resequencer.get('waiting_s'),
                                                           resequencer.get('expected_seq')))

    if stale('assemble'):
        st = state('assemble')
        if st == 'arena-wait':
            return (ARENA_POOL_WEDGED, 'assemble',
                    'assemble thread has waited {}s for a free host arena (all arenas pinned by '
                    'GC holds / undelivered batches)'.format(beats['assemble']['age_s']))
        # 'reader-wait' is decided below the remote-receive rule.
        if st != 'reader-wait' and st not in _WAITING_STATES:
            return (ASSEMBLE_STUCK, 'assemble',
                    'assemble thread silent for {}s inside {!r} (collate/shape-policy/transform '
                    'work wedged)'.format(beats['assemble']['age_s'], st))

    if stale('dispatch'):
        st = state('dispatch')
        if st in ('device_put', 'ready-wait'):
            return (DISPATCH_HUNG, 'dispatch',
                    'dispatch thread stuck {}s in {!r} — a device_put/transfer fence never '
                    'completed (wedged device or interconnect)'.format(
                        beats['dispatch']['age_s'], st))
        if st == 'out-put':
            return (CONSUMER_NOT_DRAINING, 'dispatch',
                    'dispatch thread blocked {}s handing a staged batch to a full consumer '
                    'queue'.format(beats['dispatch']['age_s']))

    if stale('consumer'):
        st = state('consumer')
        # Inline staging (prefetch=0): the consumer's states mean what the
        # engine threads' do.
        if st == 'device_put':
            return (DISPATCH_HUNG, 'consumer',
                    'inline device staging (prefetch=0) stuck {}s in a device_put that never '
                    'completed'.format(beats['consumer']['age_s']))
        if st == 'reader-wait':
            return (READER_STARVED, 'consumer',
                    'inline consumer (prefetch=0) has waited {}s for the reader'.format(
                        beats['consumer']['age_s']))
        if st == 'delivered':
            depth = probes.get('consumer', {}).get('queue_depth')
            return (CONSUMER_NOT_DRAINING, 'consumer',
                    'consumer has not requested a batch for {}s ({} staged batch(es) '
                    'waiting)'.format(beats['consumer']['age_s'], depth))

    # The remote tier, after the downstream rules (a paused consumer quiets
    # the receive loop too).
    if stale('remote-recv'):
        remote = probes.get('remote-recv', {})
        dead = remote.get('dead_endpoints') or []
        if dead:
            return (REMOTE_SERVER_DEAD, 'remote-recv',
                    'data-service server(s) dead (lease expired or unreachable over rpc): '
                    '{}'.format(sorted(dead)))
        draining = remote.get('draining_endpoints') or []
        if draining:
            return (SERVER_DRAINING, 'remote-recv',
                    'data-service server(s) draining (graceful shutdown announced in lease '
                    'heartbeats): {}'.format(sorted(draining)))
        refused = remote.get('refused_endpoints') or {}
        if refused:
            return (SERVER_OVERLOADED, 'remote-recv',
                    'data-service server(s) refused this consumer (admission control at '
                    'capacity): {}'.format(sorted(refused)))
        return (READER_STARVED, 'remote-recv',
                'no chunks from any data-service server for {}s but all rpc probes answer — '
                'decode tier is slow, not dead'.format(beats['remote-recv']['age_s']))

    if stale('assemble') and state('assemble') == 'reader-wait':
        return (READER_STARVED, 'assemble',
                'assemble thread has waited {}s for the reader (decode/IO tier produced '
                'nothing)'.format(beats['assemble']['age_s']))

    # Reader-only pipelines: 'poll' waits on the workers, 'handoff' means
    # the consumer stopped pulling.
    if stale('reader-handoff'):
        st = state('reader-handoff')
        if st == 'handoff':
            return (CONSUMER_NOT_DRAINING, 'reader-handoff',
                    'no one has pulled a row from the reader for {}s'.format(
                        beats['reader-handoff']['age_s']))
        if st != 'idle':
            return (READER_STARVED, 'reader-handoff',
                    'reader produced nothing for {}s'.format(beats['reader-handoff']['age_s']))
    if stale('ventilator') and state('ventilator') not in _WAITING_STATES:
        return (READER_STARVED, 'ventilator',
                'ventilator made no progress for {}s'.format(beats['ventilator']['age_s']))

    # The stalest stage doing actual work, else pipeline-waiting.
    worst = max((n for n in beats
                 if stale(n) and beats[n]['state'] != 'idle'
                 and beats[n]['state'] not in _WAITING_STATES),
                key=lambda n: beats[n]['age_s'], default=None)
    if worst is None:
        return (PIPELINE_WAITING, 'unknown',
                'every stale stage is parked waiting on another; no culpable stage has crossed '
                'its own deadline yet')
    return ('{}-stalled'.format(worst), worst,
            'stage {!r} silent for {}s in state {!r}'.format(worst, beats[worst]['age_s'],
                                                            beats[worst]['state']))


class StallDiagnosis(dict):
    """classification, stage, detail, the beat table, the probes, the
    all-thread stacks as walked (``stacks``, a :func:`snapshot_stacks`, where
    the JAX package keeps the formatted text) and the capture time. The
    stacks are formatted only when printed (:meth:`stacks_text`,
    :meth:`format`): a check stays cheap, and a diagnosis that nobody
    prints is never formatted."""

    @classmethod
    def capture(cls, registry, classification, stage, detail, beats=None, probes=None):
        """``beats``/``probes``: the snapshots that drove the
        classification, reported as they were (not sampled again)."""
        return cls(classification=classification, stage=stage, detail=detail,
                   beats=beats if beats is not None else registry.beat_table(),
                   probes=probes if probes is not None else registry.probe_snapshot(),
                   stacks=snapshot_stacks(), captured_at=time.time())

    def stacks_text(self):
        """The all-thread stack dump, formatted with source lines."""
        return format_stacks(self.get('stacks') or ())

    def summary(self):
        """The diagnosis without its stacks."""
        return {k: v for k, v in self.items() if k != 'stacks'}

    def format(self):
        lines = ['pipeline stall: {} (stage {!r}): {}'.format(
            self['classification'], self['stage'], self['detail'])]
        lines.append('last beats: {}'.format(
            {n: '{}s/{}'.format(b['age_s'], b['state']) for n, b in sorted(self['beats'].items())}))
        if self['probes']:
            lines.append('probes: {}'.format(self['probes']))
        lines.append('--- all-thread stack dump ---')
        lines.append(self.stacks_text())
        return '\n'.join(lines)


class Watchdog(object):
    """The supervisor thread over a :class:`HeartbeatRegistry`.

    It ticks four times a tightest deadline (between 20 ms and 5 s). A new
    stall episode is classified, recorded, counted
    (``pst_watchdog_stalls_total{classification}``), traced as
    ``stall:<classification>`` and soft-recovered
    (``pst_watchdog_soft_recoveries_total``); one that persists for
    ``escalation x deadline`` and is not soft-only is counted
    (``pst_watchdog_hard_stalls_total{classification}``), dumped by the
    flight recorder, and handed to ``on_hard_stall`` as a
    :class:`PipelineStallError`. :meth:`check` is one pass (``now=`` lets a
    test drive it on its own clock).
    """

    def __init__(self, registry, on_hard_stall=None, tracer=None,
                 escalation=DEFAULT_ESCALATION_FACTOR, poll_interval_s=None, name=THREAD_NAME,
                 flight_recorder=None):
        self._registry = registry
        self._on_hard_stall = on_hard_stall
        if tracer is None:
            from petastorm_tpu_torch.trace import NullTracer
            tracer = NullTracer()
        self._tracer = tracer
        self._flight_recorder = flight_recorder
        self._m_stalls = metrics.counter('pst_watchdog_stalls_total',
                                         'Stall episodes detected, by classification',
                                         labelnames=('classification',))
        self._m_soft = metrics.counter('pst_watchdog_soft_recoveries_total',
                                       'Stall episodes where a soft recovery action ran')
        self._m_hard = metrics.counter('pst_watchdog_hard_stalls_total',
                                       'Stalls escalated to PipelineStallError, by classification',
                                       labelnames=('classification',))
        self._escalation = max(1.0, float(escalation))
        self._poll_interval_s = poll_interval_s
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True, name=name)
        self._lock = threading.Lock()
        # The current episode: (stage, classification, started_at, hard_fired).
        self._episode = None
        self.stalls_detected = 0
        self.soft_recoveries = 0
        self.hard_stalls = 0
        self.last_diagnosis = None

    def start(self):
        self._thread.start()
        return self

    def stop(self, join_timeout_s=5):
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=join_timeout_s)

    @property
    def alive(self):
        return self._thread.is_alive()

    @property
    def episode_active(self):
        """True while a stall episode is in progress."""
        return self._episode is not None

    def _interval(self):
        if self._poll_interval_s is not None:
            return self._poll_interval_s
        return min(max(self._registry.min_timeout() / 4.0, 0.02), 5.0)

    def _loop(self):
        while not self._stop.wait(self._interval()):
            try:
                self.check()
            except Exception:  # noqa: BLE001 - the dog must not die of a bug
                logger.exception('watchdog check failed')

    def check(self, now=None):
        """One supervision pass; returns the diagnosis it recorded, or None."""
        now = now if now is not None else time.monotonic()
        if self._flight_recorder is not None:
            try:
                self._flight_recorder.sample()
            except Exception:  # noqa: BLE001 - recording must not kill the dog
                logger.debug('flight recorder sample failed', exc_info=True)
        stalled = self._registry.stalled(now)
        if not stalled:
            self._episode = None
            return None
        beats = self._registry.beat_table(now)
        probes = self._registry.probe_snapshot()
        classification, stage, detail = classify_stall(beats, probes)
        if classification == PIPELINE_WAITING:
            self._episode = None
            return None
        episode = self._episode
        if episode is None or episode[0] != stage or episode[1] != classification:
            diagnosis = StallDiagnosis.capture(self._registry, classification, stage, detail,
                                               beats=beats, probes=probes)
            with self._lock:
                self.stalls_detected += 1
                self.last_diagnosis = diagnosis
            self._m_stalls.labels(classification).inc()
            self._tracer.instant('stall:{}'.format(classification), cat='watchdog')
            logger.warning('pipeline stall detected: %s (stage %r): %s', classification, stage,
                           detail)
            acted = False
            for fn in self._registry.recoveries_for(classification):
                try:
                    acted = bool(fn(diagnosis)) or acted
                except Exception:  # noqa: BLE001
                    logger.exception('soft recovery for %s failed', classification)
            if acted:
                with self._lock:
                    self.soft_recoveries += 1
                self._m_soft.inc()
                self._tracer.instant('stall-recovery:{}'.format(classification), cat='watchdog')
            self._episode = (stage, classification, now, False)
            return diagnosis
        _, _, started_at, hard_fired = episode
        deadline = self._registry.timeout_for(stage)
        hb_entry = beats.get(stage)
        if hb_entry is not None and hb_entry['stall_timeout_s'] is not None:
            deadline = hb_entry['stall_timeout_s']
        if (not hard_fired and classification not in SOFT_ONLY
                and now - started_at >= self._escalation * deadline):
            diagnosis = StallDiagnosis.capture(self._registry, classification, stage, detail,
                                               beats=beats, probes=probes)
            with self._lock:
                self.hard_stalls += 1
                self.last_diagnosis = diagnosis
            self._episode = (stage, classification, started_at, True)
            self._m_hard.labels(classification).inc()
            self._tracer.instant('stall-hard:{}'.format(classification), cat='watchdog')
            if self._flight_recorder is not None:
                # Dumped before the error is delivered: the post-mortem must
                # exist even if the consumer's teardown ends the process.
                try:
                    dump_path = self._flight_recorder.dump(diagnosis, reason=classification)
                    if dump_path is not None:
                        diagnosis['flight_dump'] = dump_path
                except Exception:  # noqa: BLE001 - best-effort by contract
                    logger.exception('flight recorder dump failed')
            error = PipelineStallError(diagnosis.format(), diagnosis=diagnosis)
            logger.error('pipeline stall escalated to hard error: %s (stage %r)', classification,
                         stage)
            if self._on_hard_stall is not None:
                try:
                    self._on_hard_stall(error)
                except Exception:  # noqa: BLE001
                    logger.exception('hard-stall delivery failed')
            return diagnosis
        return None

    def stats(self):
        with self._lock:
            last = self.last_diagnosis
            out = {'stalls_detected': self.stalls_detected,
                   'soft_recoveries': self.soft_recoveries,
                   'hard_stalls': self.hard_stalls,
                   'episode_active': self.episode_active,
                   'last_stall': last.summary() if last is not None else None}
        if self._flight_recorder is not None:
            out['flight_dumps'] = list(self._flight_recorder.dumps)
        return out


class HealthMonitor(object):
    """A registry and its watchdog, owned by one reader or loader. A loader
    shares its registry with the reader under it (``attach_health``), so one
    watchdog supervises the whole pipeline. Without a ``flight_recorder``
    one is armed by ``PSTT_FLIGHT_RECORDER``."""

    def __init__(self, stall_timeouts=None, on_hard_stall=None, tracer=None,
                 escalation=DEFAULT_ESCALATION_FACTOR, poll_interval_s=None,
                 flight_recorder=None):
        self.registry = HeartbeatRegistry(stall_timeouts)
        if flight_recorder is None:
            from petastorm_tpu_torch import flight_recorder as flight_mod
            flight_recorder = flight_mod.maybe_from_env(tracer=tracer)
        self.flight_recorder = flight_recorder
        self.watchdog = Watchdog(self.registry, on_hard_stall=on_hard_stall, tracer=tracer,
                                 escalation=escalation, poll_interval_s=poll_interval_s,
                                 flight_recorder=flight_recorder)

    def start(self):
        self.watchdog.start()
        return self

    def stop(self):
        self.watchdog.stop()

    def stats(self):
        """The watchdog's counts and last diagnosis, ``alive`` (its thread
        runs) and the beat table."""
        out = self.watchdog.stats()
        out['alive'] = self.watchdog.alive
        out['beats'] = self.registry.beat_table()
        return out


class PipelineSupervisor(object):
    """The JAX package's ``PipelineSupervisor``
    (``petastorm_tpu/fleet/control_plane.py:367-457``; the rest of that
    module is :mod:`petastorm_tpu_torch.fleet.control_plane`, which exposes
    this class under the same name): one arm/start/stop lifecycle
    for a reader's or a loader's :class:`HealthMonitor` and
    :class:`~petastorm_tpu_torch.autotune.AutoTuner`. Health is armed first
    (the tuner reads its watchdog's ``episode_active``); :meth:`stop` stops
    the tuner first. The owner keeps :attr:`health` and :attr:`autotuner`
    for its stats."""

    def __init__(self):
        self.health = None
        self.autotuner = None

    def arm_health(self, watchdog, stall_timeouts, on_hard_stall, tracer=None, attach_fn=None,
                   start=True):
        """Build the monitor when ``watchdog`` resolves on (else return
        None); ``attach_fn(registry)`` registers the owner's heartbeats and
        probes before the start; ``start=False`` defers the start to
        :meth:`start_health` (the loader's stages register later, and the
        first classification must see every heartbeat)."""
        if not watchdog_enabled(watchdog):
            return None
        if tracer is None:
            from petastorm_tpu_torch.trace import get_global_tracer
            tracer = get_global_tracer()
        self.health = HealthMonitor(stall_timeouts=stall_timeouts, tracer=tracer,
                                    on_hard_stall=on_hard_stall)
        if attach_fn is not None:
            attach_fn(self.health.registry)
        if start:
            self.health.start()
        return self.health

    def start_health(self):
        """Start a monitor armed with ``start=False`` (no-op when off)."""
        if self.health is not None:
            self.health.start()

    def arm_autotune(self, autotune, knobs_fn, telemetry_fn, classify_fn,
                     watchdog_active_fn=None, memory_state_fn=None, tracer=None,
                     listeners=()):
        """Start an :class:`~petastorm_tpu_torch.autotune.AutoTuner` when
        ``autotune`` resolves on (``True``, an ``AutotuneConfig``, or
        ``PSTT_AUTOTUNE`` for ``None``) and ``knobs_fn(config)`` returns a
        knob; else return None. ``listeners`` see every classified tick."""
        from petastorm_tpu_torch import autotune as autotune_mod
        if not autotune_mod.autotune_enabled(autotune):
            return None
        config = autotune_mod.resolve_config(autotune)
        knobs = knobs_fn(config)
        if not knobs:
            return None
        if tracer is None:
            from petastorm_tpu_torch.trace import get_global_tracer
            tracer = get_global_tracer()
        self.autotuner = autotune_mod.AutoTuner(
            telemetry_fn=telemetry_fn, knobs=knobs, config=config, tracer=tracer,
            classify_fn=classify_fn, watchdog_active_fn=watchdog_active_fn,
            memory_state_fn=memory_state_fn)
        for listener in listeners:
            self.autotuner.add_listener(listener)
        return self.autotuner.start()

    def stop(self):
        """Stop the tuner (it turns knobs of stages the monitor watches),
        then the monitor. Idempotent."""
        tuner, self.autotuner = self.autotuner, None
        if tuner is not None:
            tuner.stop()
        health, self.health = self.health, None
        if health is not None:
            health.stop()
