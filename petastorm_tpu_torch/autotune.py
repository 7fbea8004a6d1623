"""Adaptive pipeline autotuner: a feedback controller over the pipeline's
knobs (counterpart of ``petastorm_tpu/autotune.py:1-685``).

The speed knobs (reader workers, decode threads, the results watermark, the
loader's prefetch, copy window and arena depth) are set when a pipeline is
built, yet the best setting moves while it runs: a first epoch that decodes
wants more workers than a cache-warm one, and a shared host's capacity
swings between runs. :class:`AutoTuner` is a thread (``pstt-autotune``)
that samples a telemetry function every ``interval_s``, differences its
cumulative wait counters, classifies the dominant bottleneck
(:func:`classify_loader`, :func:`classify_reader`) and moves one knob a
decision:

* ``reader-starved``: grow the worker pool, then the decode threads, then
  loosen the results watermark;
* ``input-bound`` (the consumer waits and no stage blames a wait): grow the
  decode threads, then the workers;
* ``dispatch-bound``: pin the arenas, widen the copy window, then prefetch;
* ``arena-bound``: deepen the arena pool;
* ``consumer-bound``: step every knob down one step.

Safeguards, as in the JAX package: per-knob clamps, ``hysteresis`` ticks of
one class before any action, a ``cooldown`` after one, a throughput guard
that reverts the last action when the delivered rate falls past
``throughput_tolerance``, a pause while the watchdog has a stall episode
open (``watchdog_active_fn``), and the memory bias: while the host memory
governor's ladder is at advisory or worse (``memory_state_fn``), no grow,
and one ``mem-shrink`` step down per cooldown. A tick whose counters went
backward (``reset_stats()``) is discarded with any pending verdict.

Where the consumer takes its batches in bursts (``TorchLoader.superbatches``:
a scan trainer takes 8 at once, then trains for a few hundred ms), a tick of a
pipeline that keeps up counts 0, 8 or 16 of them, and the JAX package's
one-tick verdict reverts on that noise. The telemetry then carries
``take_batches`` and ``take_t``, the delivered count and the time at the end
of the consumer's last take; those marks are exact points of the delivered
curve, so the guard judges such a pipeline on them instead
(:meth:`AutoTuner._take_verdict`): the base rate over the takes of a settling
window before the action, the verdict over the takes of at least a settling
window after it. Without those keys (batches taken one at a time) the guard is
the JAX package's, tick for tick.

Every decision lands in a bounded log and the knob trajectory
(``stats()``, surfaced as ``Reader.diagnostics()['autotune']`` and
``TorchLoader.stats['autotune']``), in the metrics registry
(``pst_autotune_decisions_total{action}``, the enum gauge
``pst_autotune_bottleneck{pipeline, class}`` and
``pst_autotune_knob{pipeline, knob}``, whose ``pipeline`` children
``stop()`` retires) and in the tracer (an ``autotune:<action>:<class>``
instant and an ``autotune_<knob>`` counter).

Armed by ``autotune=True`` or an :class:`AutotuneConfig` on the three
readers and ``TorchLoader``, or by ``PSTT_AUTOTUNE`` (``1``/``true``: on;
a number: on with that tick interval in seconds; unset/``0``/``off``:
off). A loader over an autotuned reader adopts its knobs, so one
controller tunes the pipeline. This module imports no torch: a process
pool's workers import the reader, which imports it.
"""

import logging
import os
import threading
import time
from collections import deque

from petastorm_tpu_torch import metrics
from petastorm_tpu_torch.trace import NullTracer

logger = logging.getLogger(__name__)

ENV_VAR = 'PSTT_AUTOTUNE'
THREAD_NAME = 'pstt-autotune'

READER_STARVED = 'reader-starved'
DISPATCH_BOUND = 'dispatch-bound'
ARENA_BOUND = 'arena-bound'
CONSUMER_BOUND = 'consumer-bound'
INPUT_BOUND = 'input-bound'
BALANCED = 'balanced'


def active_bottleneck_classes(snapshot):
    """``{pipeline: class}`` of every pipeline whose
    ``pst_autotune_bottleneck`` sample reads >= 1 in a metrics snapshot
    (``MetricsRegistry.collect()``)."""
    metric = (snapshot or {}).get('pst_autotune_bottleneck') or {}
    active = {}
    for sample in metric.get('samples', ()):
        if sample.get('value', 0) >= 1:
            labels = sample.get('labels') or {}
            active[labels.get('pipeline', '')] = labels.get('class')
    return active


def autotune_enabled(explicit=None):
    """``explicit`` when not None (an :class:`AutotuneConfig` counts as
    True), else whether ``PSTT_AUTOTUNE`` arms the tuner (unset, empty,
    ``0``, ``off``, ``false``, ``no``: off)."""
    if explicit is not None:
        return bool(explicit)
    raw = os.environ.get(ENV_VAR, '').strip().lower()
    return raw not in ('', '0', 'off', 'false', 'no')


def env_interval():
    """A number in ``PSTT_AUTOTUNE`` is the tick interval in seconds; any
    other value gives None (the default). ``'1'`` is the plain on-switch,
    not a one-second interval."""
    raw = os.environ.get(ENV_VAR, '').strip()
    if raw == '1':
        return None
    try:
        value = float(raw)
    except ValueError:
        return None
    return value if value > 0 else None


class AutotuneConfig(object):
    """Clamps and pacing of the control loop (the JAX package's defaults).

    Every knob has a ``[min, max]`` the tuner never crosses;
    ``hysteresis`` and ``cooldown`` are in ticks; ``throughput_tolerance``
    is the fractional rate drop past which the last action is reverted;
    ``starve_frac`` is the consumer's blocked share of a tick below which
    it counts as fed, and ``signal_frac`` the stage-wait share that earns a
    stage the blame.
    """

    def __init__(self, interval_s=0.5, hysteresis=2, cooldown=2,
                 throughput_tolerance=0.15, log_size=256,
                 min_workers=1, max_workers=None,
                 min_prefetch=1, max_prefetch=8,
                 min_inflight=1, max_inflight=8,
                 min_device_inflight=1, max_device_inflight=8,
                 min_device_stream_mb=1, max_device_stream_mb=64,
                 min_arena_depth=2, max_arena_depth=16,
                 min_watermark=4,
                 min_decode_threads=1, max_decode_threads=None,
                 starve_frac=0.05, signal_frac=0.05):
        if interval_s <= 0:
            raise ValueError('interval_s must be positive, got {}'.format(interval_s))
        self.interval_s = float(interval_s)
        self.hysteresis = max(1, int(hysteresis))
        self.cooldown = max(0, int(cooldown))
        self.throughput_tolerance = float(throughput_tolerance)
        self.log_size = int(log_size)
        self.min_workers = max(1, int(min_workers))
        if max_workers is None:
            max_workers = min(32, 4 * (os.cpu_count() or 4))
        self.max_workers = max(self.min_workers, int(max_workers))
        self.min_prefetch = max(1, int(min_prefetch))
        self.max_prefetch = max(self.min_prefetch, int(max_prefetch))
        self.min_inflight = max(1, int(min_inflight))
        self.max_inflight = max(self.min_inflight, int(max_inflight))
        # The per-device knobs' clamps are kept for the JAX package's
        # signature: the port runs one process a GPU and has no per-device
        # stager, so no knob reads them.
        self.min_device_inflight = max(1, int(min_device_inflight))
        self.max_device_inflight = max(self.min_device_inflight, int(max_device_inflight))
        self.min_device_stream_mb = max(0, int(min_device_stream_mb))
        self.max_device_stream_mb = max(self.min_device_stream_mb, int(max_device_stream_mb))
        self.min_arena_depth = max(1, int(min_arena_depth))
        self.max_arena_depth = max(self.min_arena_depth, int(max_arena_depth))
        self.min_watermark = max(2, int(min_watermark))
        self.min_decode_threads = max(1, int(min_decode_threads))
        if max_decode_threads is None:
            max_decode_threads = 2 * (os.cpu_count() or 4)
        self.max_decode_threads = max(self.min_decode_threads, int(max_decode_threads))
        self.starve_frac = float(starve_frac)
        self.signal_frac = float(signal_frac)


def resolve_config(explicit=None):
    """An :class:`AutotuneConfig` passes through; anything else gives the
    defaults with ``PSTT_AUTOTUNE``'s interval, if it names one."""
    if isinstance(explicit, AutotuneConfig):
        return explicit
    interval = env_interval()
    return AutotuneConfig(interval_s=interval) if interval else AutotuneConfig()


class Knob(object):
    """One tunable parameter: a getter, a setter and its clamps. Both run on
    the tuner's thread, so they must be thread-safe."""

    def __init__(self, name, get, set, lo, hi):
        self.name = name
        self.get = get
        self.set = set
        self.lo = int(lo)
        self.hi = int(hi)

    def clamp(self, value):
        return max(self.lo, min(self.hi, int(value)))


# --------------------------------------------------------------------------
# bottleneck classification
# --------------------------------------------------------------------------

def classify_loader(deltas, gauges, dt, config):
    """``(label, detail)`` of a loader's tick: the consumer's blocked share
    says whether the pipeline keeps up; when it does not, the stage that
    spent the largest share of the tick waiting (reader pull, arena
    acquire, copy fence) is the bottleneck."""
    wait_frac = deltas.get('wait_s', 0.0) / dt
    reader_frac = deltas.get('reader_wait_s', 0.0) / dt
    arena_frac = deltas.get('arena_wait_s', 0.0) / dt
    ready_frac = deltas.get('ready_wait_s', 0.0) / dt
    capacity = gauges.get('queue_capacity') or 1
    fill = (gauges.get('queue_depth') or 0) / capacity
    if wait_frac < config.starve_frac:
        if fill >= 0.5:
            return (CONSUMER_BOUND,
                    'consumer blocked {:.0%} of the tick with the staging '
                    'queue {:.0%} full — pipeline is ahead of the trainer'
                    .format(wait_frac, fill))
        return (BALANCED, 'consumer blocked only {:.0%} of the tick'.format(wait_frac))
    candidates = [(READER_STARVED, reader_frac),
                  (ARENA_BOUND, arena_frac),
                  (DISPATCH_BOUND, ready_frac)]
    label, frac = max(candidates, key=lambda kv: kv[1])
    if frac < config.signal_frac:
        return (INPUT_BOUND,
                'consumer blocked {:.0%} of the tick but no stage reports '
                'waiting — pipeline work itself is the limit'.format(wait_frac))
    return (label, 'consumer blocked {:.0%}; dominant stage wait: {} '
            '{:.0%} of the tick'.format(wait_frac, label, frac))


def classify_reader(deltas, gauges, dt, config):
    """``(label, detail)`` of a reader used alone, from its results queue:
    full means the consumer is the limit, empty with work ventilated means
    the decode tier is. An unbounded queue gives no signal."""
    capacity = gauges.get('results_queue_capacity') or 0
    if capacity <= 0:
        return (BALANCED, 'results queue unbounded: no fill signal')
    fill = (gauges.get('results_queue_depth') or 0) / capacity
    pending = gauges.get('ventilated_unprocessed') or 0
    if fill >= 0.6:
        return (CONSUMER_BOUND, 'results queue {:.0%} full — consumer is the limit'.format(fill))
    if fill <= 0.1 and pending > 0:
        return (READER_STARVED,
                'results queue {:.0%} full with {} ventilated item(s) still '
                'unprocessed — decode tier is the limit'.format(fill, pending))
    return (BALANCED, 'results queue {:.0%} full'.format(fill))


#: Per class, the knobs a grow tries in order: the first that exists and is
#: below its clamp takes one additive step. The per-device knobs are the
#: JAX package's (the port has none of them, so they are skipped).
_GROW_ACTIONS = {
    READER_STARVED: (('workers', 1), ('decode_threads', 2), ('results_watermark', 8)),
    INPUT_BOUND: (('decode_threads', 2), ('workers', 1)),
    DISPATCH_BOUND: (('device_inflight', 1), ('arena_pinned', 1),
                     ('device_stream_min_mb', 8), ('inflight', 1), ('prefetch', 1)),
    ARENA_BOUND: (('arena_depth', 2),),
}

#: A shrink (consumer-bound, or the memory bias): one step down on every
#: knob there is.
_SHRINK_STEPS = (('workers', 1), ('prefetch', 1), ('inflight', 1),
                 ('device_inflight', 1), ('arena_depth', 2), ('arena_pinned', 1),
                 ('decode_threads', 2), ('results_watermark', 8))

#: Telemetry keys that are cumulative counters (the rest are gauges).
_CUMULATIVE_KEYS = ('batches', 'wait_s', 'reader_wait_s', 'arena_wait_s', 'ready_wait_s')

#: A verdict judged on takes waits at most this many settling windows for
#: a take that closes its window; then it judges the delivered count.
TAKE_VERDICT_WAIT_WINDOWS = 8

#: Classes during which the chunk store's write-behind writer is paced: the
#: pipeline's own work is the limit, so the epoch-0 spill must not take its
#: CPU or disk. Balanced and consumer-bound ticks release it.
WRITER_THROTTLE_CLASSES = (DISPATCH_BOUND, READER_STARVED, INPUT_BOUND)


def writer_throttle_listener(store):
    """A classification listener (:meth:`AutoTuner.add_listener`) that
    throttles ``store``'s writer (``set_writer_throttled``) while the tick's
    class is in :data:`WRITER_THROTTLE_CLASSES` and releases it otherwise."""
    def listener(label, detail=None):
        store.set_writer_throttled(label in WRITER_THROTTLE_CLASSES)
    return listener


_tuner_id_lock = threading.Lock()
_tuner_id_next = 0


def _next_tuner_id():
    global _tuner_id_next
    with _tuner_id_lock:
        tuner_id, _tuner_id_next = _tuner_id_next, _tuner_id_next + 1
        return tuner_id


class AutoTuner(object):
    """The control thread over a dict of :class:`Knob`.

    :param telemetry_fn: ``() -> dict`` sampled once a tick; the keys of
        ``_CUMULATIVE_KEYS`` are counters, the rest gauges. It must not block.
    :param knobs: dict name -> :class:`Knob`.
    :param config: an :class:`AutotuneConfig` (defaults when None).
    :param classify_fn: ``(deltas, gauges, dt, config) -> (label, detail)``.
    :param watchdog_active_fn: ``() -> bool``; True pauses the tick (a stall
        episode is open: recovery owns the pipeline).
    :param memory_state_fn: ``() -> int``, the governor's pressure level
        (``membudget.get_governor().pressure_level``); at 1 (advisory) or
        more, no grow, and one ``mem-shrink`` step per cooldown.
    """

    def __init__(self, telemetry_fn, knobs, config=None, tracer=None,
                 classify_fn=classify_loader, watchdog_active_fn=None,
                 memory_state_fn=None, name=THREAD_NAME):
        self._telemetry_fn = telemetry_fn
        self.knobs = dict(knobs)
        self.config = config if config is not None else AutotuneConfig()
        self._tracer = tracer if tracer is not None else NullTracer()
        self._classify_fn = classify_fn
        self._watchdog_active_fn = watchdog_active_fn
        self._memory_state_fn = memory_state_fn
        self.mem_shrinks = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True, name=name)
        self._lock = threading.Lock()
        self._log = deque(maxlen=self.config.log_size)
        self._trajectory = deque(maxlen=self.config.log_size)
        self._t0 = None
        self._prev = None
        self._prev_t = None
        self._streak = (None, 0)
        self._cooldown = 0
        self._pending = None      # the last action, awaiting its throughput verdict
        self._takes = deque(maxlen=64)   # (take_batches, take_t) marks, oldest first
        self._paused_streak = False
        self._listeners = []
        self.ticks = 0
        self.paused_ticks = 0
        self.reverts = 0
        self.last_class = None
        # Gauges carry a per-tuner ``pipeline`` label, so two controllers
        # in one process (train and eval loaders) do not overwrite each
        # other's class or knob values.
        self._pipeline_label = 'tuner-{}'.format(_next_tuner_id())
        self._m_decisions = metrics.counter(
            'pst_autotune_decisions_total', 'Autotuner knob decisions, by action',
            labelnames=('action',))
        self._m_bottleneck = metrics.gauge(
            'pst_autotune_bottleneck',
            'Current bottleneck classification (enum gauge: per pipeline, '
            'the active class reads 1, every other 0)',
            labelnames=('pipeline', 'class'))
        self._m_knobs = metrics.gauge(
            'pst_autotune_knob', 'Current autotuner knob values', labelnames=('pipeline', 'knob'))
        self._metric_class = None
        self._metric_classes_seen = set()

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        self._thread.start()
        return self

    def stop(self, join_timeout_s=5):
        """Stop the thread and retire this tuner's gauge children (a stopped
        tuner must not scrape as a live bottleneck, and loaders built each
        epoch must not grow the registry)."""
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=join_timeout_s)
        for label in self._metric_classes_seen:
            self._m_bottleneck.remove(self._pipeline_label, label)
        self._metric_classes_seen.clear()
        self._metric_class = None
        for name in self.knobs:
            self._m_knobs.remove(self._pipeline_label, name)

    @property
    def alive(self):
        return self._thread.is_alive()

    @property
    def pipeline_label(self):
        """This tuner's ``pipeline`` label in the gauges."""
        return self._pipeline_label

    def add_listener(self, fn):
        """``fn(label, detail)`` runs after every classified tick (not while
        paused); its exceptions are logged and swallowed."""
        self._listeners.append(fn)
        return fn

    def _loop(self):
        while not self._stop.wait(self.config.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 - the tuner must not die of a bug
                logger.exception('autotune tick failed')

    # -- control loop ------------------------------------------------------

    def tick(self, now=None):
        """One control pass (``now=`` drives it on a synthetic clock).
        Returns the decision when a knob changed, else None."""
        now = now if now is not None else time.monotonic()
        if self._t0 is None:
            self._t0 = now
        snap = self._telemetry_fn() or {}
        prev, prev_t = self._prev, self._prev_t
        self._prev, self._prev_t = snap, now
        self.ticks += 1
        if self._watchdog_active_fn is not None and self._watchdog_active_fn():
            self.paused_ticks += 1
            self._streak = (None, 0)
            self._pending = None
            if not self._paused_streak:
                self._paused_streak = True
                self._record({'action': 'paused', 'detail': 'watchdog stall episode active'},
                             now)
            return None
        self._paused_streak = False
        if self._memory_state_fn is not None and self._mem_pressure():
            # The governor's ladder owns the direction: no grow, and no
            # revert of memory relief when the rate dips.
            self._pending = None
            self._streak = (None, 0)
            if self._cooldown > 0:
                self._cooldown -= 1
                return None
            changes = self._shrink()
            if not changes:
                return None
            self.mem_shrinks += 1
            decision = {'action': 'mem-shrink', 'class': 'memory-pressure', 'changes': changes,
                        'detail': 'host memory governor at advisory or worse: biasing every '
                                  'knob down one step'}
            self._record(decision, now)
            self._snapshot_trajectory(now)
            self._cooldown = self.config.cooldown
            return decision
        if prev is None:
            self._snapshot_trajectory(now)
            return None
        dt = now - prev_t
        if dt <= 0:
            return None
        deltas = {k: snap.get(k, 0) - prev.get(k, 0) for k in _CUMULATIVE_KEYS}
        if any(v < 0 for v in deltas.values()):
            # A counter went backward (reset_stats()): the tick and any
            # verdict judged on it are garbage; re-baseline from here.
            self._pending = None
            self._streak = (None, 0)
            self._takes.clear()
            return None
        if snap.get('take_t') is not None and (
                not self._takes or self._takes[-1][1] != snap['take_t']):
            self._takes.append((snap['take_batches'], snap['take_t']))
        rate = deltas.get('batches', 0) / dt
        label, detail = self._classify_fn(deltas, snap, dt, self.config)
        self.last_class = label
        if label != self._metric_class:
            if self._metric_class is not None:
                self._m_bottleneck.labels(self._pipeline_label, self._metric_class).set(0)
            self._m_bottleneck.labels(self._pipeline_label, label).set(1)
            self._metric_class = label
            self._metric_classes_seen.add(label)
        for listener in self._listeners:
            try:
                listener(label, detail)
            except Exception:  # noqa: BLE001 - a listener must not kill the tuner
                logger.exception('autotune classification listener failed')

        # The verdict on the previous action is due one settling window
        # after it.
        if self._pending is not None and self._cooldown <= 1:
            judged = rate
            if 'take' in self._pending:
                judged = self._take_verdict(snap, now)
                if judged is None:
                    return None       # no take has closed the window yet
            pending, self._pending = self._pending, None
            base = pending['base_rate']
            tol = self.config.throughput_tolerance
            if base > 0 and judged < base * (1.0 - tol):
                for name, old, _new in pending['changes']:
                    self.knobs[name].set(old)
                self.reverts += 1
                decision = {'action': 'revert', 'class': label,
                            'changes': [(n, new, old) for n, old, new in pending['changes']],
                            'rate': round(judged, 2),
                            'detail': 'rate {:.1f}/s fell past {:.0%} of pre-action '
                                      '{:.1f}/s'.format(judged, 1.0 - tol, base)}
                if 'take' in pending:
                    decision['basis'] = 'takes'
                self._record(decision, now)
                self._snapshot_trajectory(now)
                self._cooldown = self.config.cooldown
                self._streak = (None, 0)
                return decision

        if self._cooldown > 0:
            self._cooldown -= 1
            return None

        streak_label, streak_count = self._streak
        self._streak = (label, streak_count + 1 if label == streak_label else 1)
        if self._streak[1] < self.config.hysteresis:
            return None
        if label == BALANCED:
            return None

        changes = self._shrink() if label == CONSUMER_BOUND else self._grow(label)
        if not changes:
            self._streak = (label, 0)
            return None
        decision = {'action': 'shrink' if label == CONSUMER_BOUND else 'grow',
                    'class': label, 'changes': changes, 'rate': round(rate, 2),
                    'detail': detail}
        self._record(decision, now)
        self._snapshot_trajectory(now)
        self._pending = {'changes': changes, 'base_rate': rate}
        if snap.get('take_t') is not None:
            self._pending.update(self._take_base(snap, now))
        self._cooldown = self.config.cooldown
        self._streak = (label, 0)
        return decision

    # -- the guard on takes ------------------------------------------------

    def _settle_s(self):
        """The settling window's length: the cooldown's ticks (one at least)."""
        return max(1, self.config.cooldown) * self.config.interval_s

    def _take_base(self, snap, now):
        """The pending verdict's base on takes: the rate between the newest
        take mark and the newest one at least a settling window older (the
        oldest there is, if none is), and the delivered count the pipeline
        is reckoned to have reached at the action, ``now``: the newest mark's
        plus the base rate since (at most one take more), and no less than
        the tick's count. With fewer than two marks there is no base: the
        action gets no verdict, as a one-tick base of 0 gets none."""
        if self.config.throughput_tolerance >= 1.0:
            return {}                 # a guard that can revert nothing waits for nothing
        if len(self._takes) < 2:
            return {'take': None, 'base_rate': 0.0}
        last_b, last_t = self._takes[-1]
        first_b, first_t = self._takes[0]
        for b, t in reversed(self._takes):
            if last_t - t >= self._settle_s():
                first_b, first_t = b, t
                break
        base = (last_b - first_b) / (last_t - first_t) if last_t > first_t else 0.0
        supplied = min(base * max(0.0, now - last_t), last_b - self._takes[-2][0])
        at_action = max(float(snap.get('batches', 0)), last_b + supplied)
        return {'take': (at_action, now), 'base_rate': base}

    def _take_verdict(self, snap, now):
        """The rate since the action on takes: from the count reckoned at
        the action to the newest take mark at least a settling window after
        it. None while no such mark exists, for up to
        ``TAKE_VERDICT_WAIT_WINDOWS`` settling windows; then the tick's
        delivered count since the action over the time since. With no base
        (fewer than two marks at the action) 0.0: nothing to judge."""
        start = self._pending['take']
        if start is None:
            return 0.0
        count0, t0 = start
        if self._takes:
            b, t = self._takes[-1]
            if t - t0 >= self._settle_s():
                return max(0.0, b - count0) / (t - t0)
        if now - t0 < TAKE_VERDICT_WAIT_WINDOWS * self._settle_s():
            return None
        return max(0.0, snap.get('batches', 0) - count0) / (now - t0)

    def can_grow(self, label=None):
        """Whether a tick of class ``label`` (the last classified one when
        None) finds a knob to grow: False for ``balanced`` and
        ``consumer-bound`` ticks, and once every knob the class grows is at
        its clamp."""
        label = self.last_class if label is None else label
        return any(name in self.knobs and self.knobs[name].get() < self.knobs[name].hi
                   for name, _ in _GROW_ACTIONS.get(label, ()))

    def _mem_pressure(self):
        """True at advisory (level 1) or worse; a failing probe reads 0."""
        try:
            return int(self._memory_state_fn()) >= 1
        except Exception:  # noqa: BLE001 - a failing probe must not kill the tuner
            return False

    def _grow(self, label):
        for name, step in _GROW_ACTIONS.get(label, ()):
            knob = self.knobs.get(name)
            if knob is None:
                continue
            old = knob.get()
            if old >= knob.hi:
                # At or above the clamp: clamping old + step would move the
                # knob down.
                continue
            new = knob.clamp(old + step)
            if new != old:
                knob.set(new)
                return [(name, old, new)]
        return []

    def _shrink(self):
        changes = []
        for name, step in _SHRINK_STEPS:
            knob = self.knobs.get(name)
            if knob is None:
                continue
            old = knob.get()
            if old <= knob.lo:
                continue
            # Floored at lo but not clamped to hi: a value set by hand above
            # the range steps down gradually.
            new = max(knob.lo, old - step)
            if new != old:
                knob.set(new)
                changes.append((name, old, new))
        return changes

    # -- bookkeeping -------------------------------------------------------

    def _record(self, decision, now):
        decision = dict(decision)
        decision['t'] = round(now - self._t0, 3)
        decision['tick'] = self.ticks
        self._m_decisions.labels(decision['action']).inc()
        with self._lock:
            self._log.append(decision)
        self._tracer.instant('autotune:{}:{}'.format(decision['action'],
                                                     decision.get('class', '-')),
                             cat='autotune',
                             args={k: v for k, v in decision.items() if k != 'detail'})
        logger.debug('autotune decision: %s', decision)

    def _snapshot_trajectory(self, now):
        point = {'t': round(now - self._t0, 3)}
        for name, knob in self.knobs.items():
            try:
                point[name] = knob.get()
                self._tracer.counter('autotune_{}'.format(name), point[name], 'autotune')
                self._m_knobs.labels(self._pipeline_label, name).set(point[name])
            except Exception:  # noqa: BLE001 - a failing getter must not kill the tuner
                point[name] = None
        with self._lock:
            self._trajectory.append(point)

    def stats(self):
        """``ticks``, ``paused_ticks``, ``reverts``, ``mem_shrinks``,
        ``last_class``, the current ``knobs``, the ``decisions`` log and the
        knob ``trajectory``."""
        knobs = {}
        for name, knob in self.knobs.items():
            try:
                knobs[name] = knob.get()
            except Exception:  # noqa: BLE001
                knobs[name] = None
        with self._lock:
            return {'ticks': self.ticks,
                    'paused_ticks': self.paused_ticks,
                    'reverts': self.reverts,
                    'mem_shrinks': self.mem_shrinks,
                    'last_class': self.last_class,
                    'knobs': knobs,
                    'decisions': list(self._log),
                    'trajectory': list(self._trajectory)}
