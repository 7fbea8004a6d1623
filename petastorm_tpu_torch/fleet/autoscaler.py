"""Drain-first fleet autoscaler (counterpart of
``petastorm_tpu/fleet/autoscaler.py``): grow and shrink one job's worker
set from the pipeline's own bottleneck telemetry.

The signal is the fleet-aggregated ``pst_autotune_bottleneck`` enum gauge
(what the consumers' tuners classify every tick) and the served-chunk rate
out of ``fleet_metrics()``; the discipline is the tuner's own: hysteresis,
a cooldown after an action, and a throughput guard that reverts a
scale-down whose served rate collapsed. Actions go through a
:class:`WorkerLauncher` (:class:`SubprocessLauncher` runs
``python -m petastorm_tpu_torch.tools.fleet --worker``):

* **scale-up** launches a worker and counts it only once the registry
  sees its first heartbeat; a spawn that never joins (the
  ``fleet-worker-kill`` drill) is reaped and retried on a later tick;
* **scale-down** is drain-first: the newest serving member drains to an
  acknowledged END before its process is released, judged by the worker's
  own acknowledgement, never by registry state, so a blackholed registry
  (``registry-blackhole``) cannot turn a drain into a drop;
* the ``scale-race`` delay site stretches the observe-to-act window.

Policy variables: ``PSTT_FLEET_MIN_WORKERS``, ``PSTT_FLEET_MAX_WORKERS``
and ``PSTT_FLEET_INTERVAL_S`` (the JAX package's grammar). Metrics:
``pst_fleet_scale_actions_total{job,action}`` and
``pst_fleet_target_workers{job}``. Threads: ``pstt-fleet-autoscaler`` and
``pstt-fleet-autoscaler-announce``.
"""

import logging
import os
import threading
import time

from petastorm_tpu_torch.fleet import control_plane

logger = logging.getLogger(__name__)

#: Worker-count floor/ceiling and control-loop cadence; constructor
#: args override, fleet-wide env defaults below them.
ENV_MIN_WORKERS = 'PSTT_FLEET_MIN_WORKERS'
ENV_MAX_WORKERS = 'PSTT_FLEET_MAX_WORKERS'
ENV_INTERVAL = 'PSTT_FLEET_INTERVAL_S'

#: Bottleneck classes that mean "the input tier is the limit" (grow)
#: vs "the input tier outruns its consumers" (shrink candidates).
SCALE_UP_CLASSES = ('input-bound', 'reader-starved', 'arena-bound',
                    'dispatch-bound')
SCALE_DOWN_CLASSES = ('consumer-bound', 'balanced')


def _env_int(var, default):
    raw = os.environ.get(var, '').strip()
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        logger.warning('ignoring non-integer %s=%r', var, raw)
        return default


class ScalePolicy(object):
    """Autoscaler knobs (AutoTuner's safeguards, fleet-sized).

    :param min_workers/max_workers: clamp the job's worker count
        (defaults: ``PSTT_FLEET_MIN_WORKERS`` / ``PSTT_FLEET_MAX_WORKERS``,
        else 1 / 4).
    :param interval_s: control-loop cadence (``PSTT_FLEET_INTERVAL_S``,
        else 5s).
    :param hysteresis: consecutive ticks a direction must repeat.
    :param cooldown_ticks: ticks to hold after any action.
    :param throughput_tolerance: fractional served-rate drop past which
        the last scale-down is reverted.
    :param spawn_grace_s: how long a launched worker has to produce its
        first heartbeat before it is reaped as a failed spawn.
    :param drain_timeout_s: per-victim drain budget on scale-down.
    """

    def __init__(self, min_workers=None, max_workers=None, interval_s=None,
                 hysteresis=2, cooldown_ticks=2, throughput_tolerance=0.5,
                 spawn_grace_s=30.0, drain_timeout_s=30.0):
        self.min_workers = max(0, int(
            _env_int(ENV_MIN_WORKERS, 1) if min_workers is None
            else min_workers))
        self.max_workers = max(self.min_workers, int(
            _env_int(ENV_MAX_WORKERS, 4) if max_workers is None
            else max_workers))
        self.interval_s = float(
            control_plane.env_float(ENV_INTERVAL, 5.0)
            if interval_s is None else interval_s)
        self.hysteresis = max(1, int(hysteresis))
        self.cooldown_ticks = max(0, int(cooldown_ticks))
        self.throughput_tolerance = float(throughput_tolerance)
        self.spawn_grace_s = float(spawn_grace_s)
        self.drain_timeout_s = float(drain_timeout_s)


class WorkerLauncher(object):
    """The seam orchestrators implement. A *handle* is whatever
    :meth:`launch` returned; the autoscaler treats it as opaque apart
    from the ``'key'`` entry (the registry identity to wait for)."""

    def launch(self, index):
        """Start worker ``index``; return a handle dict containing at
        least ``{'key': <registry member key>}``."""
        raise NotImplementedError

    def drain(self, handle, timeout_s):
        """Drain-first release; True once the worker acknowledged a
        complete drain (zero-loss). Must NOT kill on failure."""
        raise NotImplementedError

    def terminate(self, handle):
        """Hard-release the worker's resources (after drain, or for a
        spawn that never joined)."""
        raise NotImplementedError

    def alive(self, handle):
        raise NotImplementedError


class SubprocessLauncher(WorkerLauncher):
    """In-tree launcher: one worker = one
    ``python -m petastorm_tpu_torch.tools.fleet --worker`` subprocess.

    ``argv_fn(index)`` builds the command line; the worker announces
    itself with one JSON line on stdout (``server_id``, endpoints) that
    becomes the handle, and drains on SIGTERM (the serve-CLI signal
    discipline — first SIGTERM drains, second forces).
    """

    def __init__(self, argv_fn, announce_timeout_s=30.0, env=None):
        self._argv_fn = argv_fn
        self._announce_timeout_s = float(announce_timeout_s)
        self._env = env

    def launch(self, index):
        import json
        import subprocess
        proc = subprocess.Popen(
            self._argv_fn(index), stdout=subprocess.PIPE, text=True,
            env=self._env)
        line = _readline_with_timeout(proc, self._announce_timeout_s)
        if not line:
            proc.kill()
            proc.wait()
            raise RuntimeError('fleet worker {} died before announcing '
                               'itself'.format(index))
        info = json.loads(line)
        return {'key': info.get('name') or info.get('server_id'),
                'proc': proc, 'info': info, 'index': index}

    def drain(self, handle, timeout_s):
        import signal
        proc = handle['proc']
        if proc.poll() is not None:
            return False    # already dead — nothing drained it
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=timeout_s)
        except Exception:  # noqa: BLE001 - subprocess.TimeoutExpired
            return False
        return proc.returncode == 0

    def terminate(self, handle):
        proc = handle['proc']
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        if proc.stdout is not None:
            proc.stdout.close()

    def alive(self, handle):
        return handle['proc'].poll() is None


def _readline_with_timeout(proc, timeout_s):
    """One stdout line from a subprocess, bounded — a worker that
    wedges before announcing must not wedge the autoscaler with it."""
    result = {}

    def _read():
        result['line'] = proc.stdout.readline()

    t = threading.Thread(target=_read, daemon=True,
                         name='pstt-fleet-autoscaler-announce')
    t.start()
    t.join(timeout_s)
    return (result.get('line') or '').strip()


class FleetAutoscaler(object):
    """The per-job control loop. Synchronous :meth:`tick` for tests and
    orchestrators with their own cadence; :meth:`start` runs it on a
    'pstt-fleet-autoscaler' thread every ``policy.interval_s``.

    :param job: job id this loop owns.
    :param registry: a :class:`~petastorm_tpu_torch.fleet.registry.
        FleetRegistry` watching the job's control endpoints.
    :param launcher: a :class:`WorkerLauncher`.
    :param metrics_fn: ``() -> fleet_metrics()``-shaped dict (or None)
        — typically a bound ``RemoteReader.fleet_metrics`` or a scrape
        via :func:`petastorm_tpu_torch.metrics.scrape_fleet_metrics`.
    """

    def __init__(self, job, registry, launcher, metrics_fn=None,
                 policy=None):
        from petastorm_tpu_torch import metrics as metrics_mod
        self.job = job
        self.registry = registry
        self.launcher = launcher
        self.metrics_fn = metrics_fn
        self.policy = policy or ScalePolicy()
        self._handles = {}          # member key -> launcher handle
        self._launch_index = 0
        self._streak = (None, 0)
        self._cooldown = 0
        self._pending = None        # last scale-down awaiting its verdict
        self._prev_served = None    # (total, monotonic) for the rate
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        self.decisions = []
        self._m_actions = metrics_mod.counter(
            'pst_fleet_scale_actions_total',
            'Autoscaler actions taken, by job and action',
            labelnames=('job', 'action'))
        self._m_target = metrics_mod.gauge(
            'pst_fleet_target_workers',
            'Worker count the autoscaler currently steers the job '
            'toward', labelnames=('job',))

    # -- signal ------------------------------------------------------------

    def _served_rate(self, fleet, now):
        """Served-chunk rate (chunks/s) between this tick and the
        last, from the aggregate counter; None until two samples."""
        if not fleet:
            return None
        metric = (fleet.get('aggregate') or {}).get(
            'pst_data_service_chunks_served_total') or {}
        total = sum(s.get('value', 0) for s in metric.get('samples', ()))
        prev, self._prev_served = self._prev_served, (total, now)
        if prev is None or now <= prev[1]:
            return None
        return max(0.0, total - prev[0]) / (now - prev[1])

    def _direction(self, fleet):
        """'up' / 'down' / None from the bottleneck vocabulary."""
        from petastorm_tpu_torch import autotune
        classes = autotune.active_bottleneck_classes(
            (fleet or {}).get('aggregate'))
        if not classes:
            return None
        if any(c in SCALE_UP_CLASSES for c in classes.values()):
            return 'up'
        if all(c in SCALE_DOWN_CLASSES for c in classes.values()):
            return 'down'
        return None

    # -- the control loop --------------------------------------------------

    def tick(self, now=None):
        """One observe->decide->act pass. Returns the decision dict
        when an action ran (or was attempted), else None."""
        now = time.monotonic() if now is None else now
        self._reap_dead()
        observed = self.registry.worker_count(self.job)
        fleet = None
        if self.metrics_fn is not None:
            try:
                fleet = self.metrics_fn()
            except Exception:  # noqa: BLE001 - scrape failure = no signal
                logger.debug('autoscaler %r: metrics scrape failed',
                             self.job, exc_info=True)
        rate = self._served_rate(fleet, now)
        # Throughput guard: one settling window after a scale-down, a
        # collapsed served rate reverts it (same discipline as the
        # AutoTuner's _pending verdict).
        if self._pending is not None and self._cooldown <= 1:
            pending, self._pending = self._pending, None
            base = pending['base_rate']
            tol = self.policy.throughput_tolerance
            if base is not None and rate is not None \
                    and base > 0 and rate < base * (1.0 - tol):
                self._cooldown = self.policy.cooldown_ticks
                return self._act('revert-up', observed,
                                 detail='rate {:.1f}/s fell past {:.0%} '
                                        'of {:.1f}/s — reverting last '
                                        'scale-down'.format(
                                            rate, 1.0 - tol, base))
        # Floors/ceilings act immediately (no hysteresis: a fleet below
        # min is not a trend, it is a deficit — e.g. first tick, or a
        # worker the chaos drill SIGKILLed).
        if observed < self.policy.min_workers:
            return self._act('up', observed,
                             detail='below min_workers={}'.format(
                                 self.policy.min_workers))
        direction = self._direction(fleet)
        if direction == 'up' and observed >= self.policy.max_workers:
            direction = None
        if direction == 'down' and observed <= self.policy.min_workers:
            direction = None
        label, streak = self._streak
        streak = streak + 1 if label == direction else 1
        self._streak = (direction, streak)
        if self._cooldown > 0:
            self._cooldown -= 1
            return None
        if direction is None or streak < self.policy.hysteresis:
            return None
        self._streak = (None, 0)
        self._cooldown = self.policy.cooldown_ticks
        if direction == 'down':
            self._pending = {'base_rate': rate}
        return self._act(direction, observed, rate=rate)

    def _act(self, action, observed, detail=None, rate=None):
        from petastorm_tpu_torch import faults
        # Chaos seam: the window between deciding and acting, where a
        # worker can die or join and make the decision stale.
        faults.maybe_inject('scale-race')
        if action in ('up', 'revert-up'):
            target = min(observed + 1, self.policy.max_workers)
            ok, note = self._scale_up()
        else:
            target = max(observed - 1, self.policy.min_workers)
            ok, note = self._scale_down()
        self._m_target.labels(self.job).set(target)
        self._m_actions.labels(
            self.job, action if ok else action + '-failed').inc()
        decision = {'action': action, 'ok': ok, 'observed': observed,
                    'target': target, 'rate': rate,
                    'detail': detail or note}
        self.decisions.append(decision)
        logger.info('autoscaler %r: %s', self.job, decision)
        return decision

    def _scale_up(self):
        """Launch one worker; count it only once the registry sees its
        first heartbeat. A spawn that never joins (SIGKILL mid-scale-up
        drill) is reaped and retried on a later tick — never counted."""
        self._launch_index += 1
        try:
            handle = self.launcher.launch(self._launch_index)
        except Exception as e:  # noqa: BLE001 - launcher is external code
            logger.warning('autoscaler %r: launch failed: %r',
                           self.job, e)
            return False, 'launch failed: {!r}'.format(e)
        key = handle.get('key')
        if not self.registry.wait_for_member(
                self.job, key=key, timeout_s=self.policy.spawn_grace_s):
            self.launcher.terminate(handle)
            return False, ('worker {} produced no heartbeat within '
                           '{}s — reaped'.format(
                               key, self.policy.spawn_grace_s))
        with self._lock:
            self._handles[key] = handle
        return True, 'worker {} joined'.format(key)

    def _scale_down(self):
        """Drain-first shrink: newest serving member drains to an
        acknowledged zero-loss END, then (and only then) its process is
        released. Drain acknowledgement comes from the worker itself —
        a blackholed registry changes nothing about chunk safety."""
        members = self.registry.members(self.job, states=('serving',))
        if not members:
            return False, 'no serving member to drain'
        victim = members[-1]    # newest first out: LIFO keeps the
        key = victim['key']     # warmest caches serving longest
        with self._lock:
            handle = self._handles.get(key)
        if handle is not None:
            drained = self.launcher.drain(
                handle, self.policy.drain_timeout_s)
            self.launcher.terminate(handle)
            with self._lock:
                self._handles.pop(key, None)
        else:
            drained = self._drain_rpc(victim)
        return bool(drained), 'drained worker {}'.format(key)

    def _drain_rpc(self, member):
        """Drain a member this autoscaler did not launch, over its rpc
        endpoint (the same typed `drain` verb orchestrators use)."""
        endpoint = member.get('rpc')
        if not endpoint:
            return False
        import zmq

        from petastorm_tpu_torch.serving.server import _one_shot
        try:
            reply = _one_shot(
                zmq.Context.instance(), endpoint,
                {'cmd': 'drain',
                 'timeout_s': self.policy.drain_timeout_s},
                timeout_ms=int(self.policy.drain_timeout_s * 1000)
                + 2000)
        except Exception:  # noqa: BLE001 - a dead member can't drain
            logger.warning('autoscaler %r: drain rpc to %s failed',
                           self.job, endpoint, exc_info=True)
            return False
        return bool(reply.get('drained'))

    def _reap_dead(self):
        """Forget handles whose process died outside our control (the
        chaos drill's SIGKILL mid-serve); the registry ages the member
        out on its own and min_workers pulls in a replacement."""
        with self._lock:
            dead = [key for key, h in self._handles.items()
                    if not self.launcher.alive(h)]
            for key in dead:
                handle = self._handles.pop(key)
                try:
                    self.launcher.terminate(handle)
                except Exception:  # noqa: BLE001 - reap must not wedge
                    pass
                logger.warning('autoscaler %r: worker %s died '
                               'unexpectedly', self.job, key)

    def live_workers(self):
        """The workers this loop launched that are alive now (the dead
        reaped first); the port's own."""
        self._reap_dead()
        with self._lock:
            return len(self._handles)

    # -- imperative control --------------------------------------------------

    def scale_to(self, n, max_ticks=64):
        """Steer to exactly ``n`` workers now (drain-first downward),
        bypassing hysteresis — the orchestration entry tests and CLIs
        use. Returns the registry's final worker count."""
        n = max(self.policy.min_workers,
                min(int(n), self.policy.max_workers))
        for _ in range(max_ticks):
            observed = self.registry.worker_count(self.job)
            if observed == n:
                break
            if observed < n:
                self._act('up', observed, detail='scale_to({})'.format(n))
            else:
                self._act('down', observed,
                          detail='scale_to({})'.format(n))
        return self.registry.worker_count(self.job)

    def drain_all(self):
        """Drain-first release of every worker this loop launched
        (shutdown path: zero-loss by the same construction)."""
        with self._lock:
            handles = dict(self._handles)
            self._handles.clear()
        for key, handle in handles.items():
            self.launcher.drain(handle, self.policy.drain_timeout_s)
            self.launcher.terminate(handle)

    # -- thread lifecycle ----------------------------------------------------

    def start(self):
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name='pstt-fleet-autoscaler')
            self._thread.start()
        return self

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:  # noqa: BLE001 - the loop must outlive a tick
                logger.exception('autoscaler %r: tick failed', self.job)
            self._stop.wait(self.policy.interval_s)

    def stop(self):
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=10.0)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.stop()
