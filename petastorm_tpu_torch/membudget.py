"""Host memory governor: one byte account over the pipeline's pools, a
pressure ladder, and a typed error instead of the kernel's OOM kill.

Counterpart of ``petastorm_tpu/membudget.py:1-887``. Each ladder
transition is a ``mem-pressure:<state>`` instant of the global tracer
(``:646-647``); a breach dumps the flight recorder
(:mod:`~petastorm_tpu_torch.flight_recorder`, ``:761-776``) under
``PSTT_FLIGHT_RECORDER``, else the temporary directory, before it raises;
:meth:`MemoryGovernor.probe` is the watchdog's ``memory`` probe, whose
state turns a starvation-shaped stall into the soft ``memory-pressure``
(:func:`~petastorm_tpu_torch.health.classify_stall`). Its instruments are
the JAX package's (``:382-397``):
``pst_mem_budget_bytes``, ``pst_mem_accounted_bytes{pool}``,
``pst_mem_pressure_state``, ``pst_mem_degrade_actions_total{action}`` and
``pst_mem_breaches_total``. The ``mem-pressure`` fault site (``:571-580``)
inflates the bytes a pool reports by ``bytes=`` (default: one whole budget)
every tick, so a test parks the ladder on any rung without allocating.

Each byte-holding part of the pipeline (the results queue, the arenas, the
prefetch queue, the shuffling buffer, the resequencer, the lineage queue,
the memory cache, the chunk store, the device cache) registers a pool: a
``(name, nbytes_fn, degrade_fn, shed_fn, advisory_fn)`` handle. Pools
register whether or not the governor is armed, so :meth:`MemoryGovernor.
probe` always has the inventory. Armed (``PSTT_HOST_MEM_BUDGET`` set to a
byte count with an optional ``k``/``m``/``g``/``t`` suffix, or ``auto``), a
sampler thread (``pstt-mem-governor``) sums the pools every tick and walks
the ladder:

========== ============== ====================================================
state      trigger        actions
========== ============== ====================================================
ok         < 70% budget   none
advisory   >= 70%         chunk-store spill paused, new arenas unpinned, the
                          partial device cache's fill paused; an autotuner
                          (its ``memory_state_fn`` is :meth:`MemoryGovernor.
                          pressure_level`) stops growing and steps every knob
                          down once a cooldown (``mem-shrink``)
degrade    >= 85%         every tick while it holds: evict ``MemoryCache``,
                          drop LRU chunk-store mmaps, evict the device
                          cache's coldest run, shed lineage ledger records
                          (counted), halve the shuffling buffer (only for
                          readers that are not deterministic)
shed       >= 92%         paced ventilation (a tight results watermark)
breach     >= 100%        once per episode: pools ranked by bytes, and a
                          :class:`~petastorm_tpu_torch.errors.
                          HostMemoryExceededError` delivered to every
                          breach sink (the readers and loaders raise it
                          from ``next``)
========== ============== ====================================================

``auto`` resolves to the cgroup v2 ``memory.max`` (or v1
``limit_in_bytes``) limit less headroom, else a share of ``MemTotal``.
The governor is process-wide and refcount-armed: every reader and loader
built while the variable is set takes an arm reference, and the sampler
ends with the last release.

Degradation keeps deterministic streams bit-identical: the hooks change
queue depths, pool sizes and cache contents, never item order, and the
one order-changing hook (the shuffling buffer's halving) registers only
for readers that report ``deterministic is False``.
"""

import contextlib
import logging
import os
import sys
import tempfile
import threading
import time
from collections import deque

from petastorm_tpu_torch import faults, metrics
from petastorm_tpu_torch.analysis import sanitize
from petastorm_tpu_torch.errors import HostMemoryExceededError

logger = logging.getLogger(__name__)

ENV_VAR = 'PSTT_HOST_MEM_BUDGET'
THREAD_NAME = 'pstt-mem-governor'

STATE_OK = 'ok'
STATE_ADVISORY = 'advisory'
STATE_DEGRADE = 'degrade'
STATE_SHED = 'shed'
STATE_BREACH = 'breach'
STATES = (STATE_OK, STATE_ADVISORY, STATE_DEGRADE, STATE_SHED, STATE_BREACH)
STATE_LEVELS = {name: level for level, name in enumerate(STATES)}

#: Headroom taken off a container limit: the rest of the process (python,
#: torch, the CUDA context) needs room of its own under the same limit.
DEFAULT_HEADROOM_FRAC = 0.1
MIN_HEADROOM_BYTES = 256 << 20

#: No cgroup limit (a bare host): the budget is this share of MemTotal.
DEFAULT_HOST_FRAC = 0.8

_BYTE_SUFFIXES = {'k': 1 << 10, 'm': 1 << 20, 'g': 1 << 30, 't': 1 << 40}

#: cgroups report "no limit" as a value near 2**63.
_CGROUP_UNLIMITED = 1 << 60


def parse_bytes(text):
    """``'512m'``, ``'2g'``, ``'1073741824'`` -> bytes; None for empty or
    ``auto``. Raises ``ValueError`` on anything else: a mistyped budget
    fails the run that set it instead of leaving the governor off."""
    text = (text or '').strip().lower()
    if not text or text == 'auto':
        return None
    mult = 1
    if text[-1] in _BYTE_SUFFIXES:
        mult = _BYTE_SUFFIXES[text[-1]]
        text = text[:-1]
    value = int(float(text) * mult)
    if value <= 0:
        raise ValueError('memory budget must be positive, got {!r}'.format(value))
    return value


def cgroup_memory_limit(cgroup_root='/sys/fs/cgroup'):
    """The container's memory limit in bytes, or None: cgroup v2
    ``memory.max``, then v1 ``memory/memory.limit_in_bytes``."""
    for rel in ('memory.max', os.path.join('memory', 'memory.limit_in_bytes')):
        path = os.path.join(cgroup_root, rel)
        try:
            with open(path) as f:
                raw = f.read().strip()
        except OSError:
            continue
        if raw == 'max':
            continue
        try:
            value = int(raw)
        except ValueError:
            continue
        if 0 < value < _CGROUP_UNLIMITED:
            return value
    return None


def host_memory_total(meminfo_path='/proc/meminfo'):
    """MemTotal in bytes, or None off Linux."""
    try:
        with open(meminfo_path) as f:
            for line in f:
                if line.startswith('MemTotal:'):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        return None
    return None


def process_rss_bytes(statm_path='/proc/self/statm'):
    """The resident set size in bytes, or None off Linux."""
    try:
        with open(statm_path) as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf('SC_PAGE_SIZE')
    except (OSError, ValueError, IndexError):
        return None


def peak_rss_bytes():
    """Lifetime peak RSS (``ru_maxrss``: KiB on Linux, bytes on macOS)."""
    import resource
    maxrss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return int(maxrss if sys.platform == 'darwin' else maxrss * 1024)


def resolve_budget(explicit=None, cgroup_root='/sys/fs/cgroup', meminfo_path='/proc/meminfo'):
    """``(budget_bytes, source)``: ``explicit`` (an int, or a string for
    :func:`parse_bytes`) wins, else ``PSTT_HOST_MEM_BUDGET``; ``auto`` takes
    the cgroup limit less headroom, else ``MemTotal * DEFAULT_HOST_FRAC``.
    ``(None, None)`` when nothing is configured."""
    if explicit is not None:
        value = explicit if isinstance(explicit, int) else parse_bytes(explicit)
        source = 'explicit'
    else:
        raw = os.environ.get(ENV_VAR, '')
        if not raw.strip():
            return None, None
        value = parse_bytes(raw)
        source = 'env'
    if value is not None:
        return value, source
    limit = cgroup_memory_limit(cgroup_root)
    if limit is not None:
        headroom = max(MIN_HEADROOM_BYTES, int(limit * DEFAULT_HEADROOM_FRAC))
        return max(1, limit - headroom), 'cgroup'
    total = host_memory_total(meminfo_path)
    if total is not None:
        return int(total * DEFAULT_HOST_FRAC), 'meminfo'
    return max(1 << 30, peak_rss_bytes() * 4), 'rss-fraction'


def approx_nbytes(value, _depth=0):
    """A cheap byte estimate of a pool's contents: ``.nbytes`` arrays and
    tensors, dicts, lists and tuples of them, bytes-likes, scalars. Long
    lists are sampled at 8 evenly spaced elements and extrapolated."""
    if value is None:
        return 0
    if _depth > 6:
        try:
            return sys.getsizeof(value)
        except TypeError:
            return 64
    nbytes = getattr(value, 'nbytes', None)
    if nbytes is not None:
        try:
            return int(nbytes)
        except (TypeError, ValueError):
            pass
    if isinstance(value, (bytes, bytearray, memoryview)):
        return len(value)
    if isinstance(value, str):
        return sys.getsizeof(value)
    if isinstance(value, dict):
        return sum(approx_nbytes(k, _depth + 1) + approx_nbytes(v, _depth + 1)
                   for k, v in value.items())
    if isinstance(value, (list, tuple)):
        if len(value) > 16:
            stride = len(value) // 8
            picked = value[::stride][:8]
            sampled = sum(approx_nbytes(v, _depth + 1) for v in picked)
            return int(sampled * len(value) / len(picked))
        return sum(approx_nbytes(v, _depth + 1) for v in value)
    try:
        return sys.getsizeof(value)
    except TypeError:
        return 64


class GovernorConfig(object):
    """Ladder thresholds (shares of the budget) and the sampler's interval."""

    def __init__(self, interval_s=0.5, advisory_frac=0.70, degrade_frac=0.85, shed_frac=0.92,
                 breach_frac=1.0, transitions_log=256):
        if not 0 < advisory_frac <= degrade_frac <= shed_frac <= breach_frac:
            raise ValueError(
                'ladder thresholds must ascend: advisory {} <= degrade {} <= shed {} <= '
                'breach {}'.format(advisory_frac, degrade_frac, shed_frac, breach_frac))
        self.interval_s = float(interval_s)
        self.advisory_frac = float(advisory_frac)
        self.degrade_frac = float(degrade_frac)
        self.shed_frac = float(shed_frac)
        self.breach_frac = float(breach_frac)
        self.transitions_log = int(transitions_log)

    def state_for(self, frac):
        if frac >= self.breach_frac:
            return STATE_BREACH
        if frac >= self.shed_frac:
            return STATE_SHED
        if frac >= self.degrade_frac:
            return STATE_DEGRADE
        if frac >= self.advisory_frac:
            return STATE_ADVISORY
        return STATE_OK


class PoolHandle(object):
    """One registered pool.

    :param nbytes_fn: ``() -> int``, the bytes held now; cheap and
        thread-safe (it runs on the sampler thread).
    :param degrade_fn: ``() -> truthy if it acted``, called once a tick
        while the ladder is at *degrade* or above; idempotent.
    :param degrade_release_fn: ``() -> None``, called when the ladder falls
        below *degrade* (a standing degrade mode ends there).
    :param shed_fn: ``(active) -> None``, on entering and leaving *shed*.
    :param advisory_fn: ``(active) -> None``, on entering and leaving
        *advisory* or above.

    The toggles must be idempotent: a pool registered mid-episode gets its
    toggle at registration, and the sampler may fire the same one again.
    """

    __slots__ = ('name', 'nbytes_fn', 'degrade_fn', 'degrade_release_fn', 'shed_fn',
                 'advisory_fn', 'last_nbytes', '_governor')

    def __init__(self, governor, name, nbytes_fn, degrade_fn=None, degrade_release_fn=None,
                 shed_fn=None, advisory_fn=None):
        self.name = name
        self.nbytes_fn = nbytes_fn
        self.degrade_fn = degrade_fn
        self.degrade_release_fn = degrade_release_fn
        self.shed_fn = shed_fn
        self.advisory_fn = advisory_fn
        self.last_nbytes = 0
        self._governor = governor

    def close(self):
        """Unregister (idempotent); owners call it at teardown."""
        governor, self._governor = self._governor, None
        if governor is not None:
            governor._unregister(self)


class MemoryGovernor(object):
    """Process-wide pool registry, budget and pressure-ladder sampler.

    Reached through :func:`get_governor`; tests build their own and call
    :meth:`check` themselves."""

    def __init__(self, budget=None, config=None):
        self.config = config if config is not None else GovernorConfig()
        # Lock-order-recorded when PSTT_SANITIZE is armed (the name is
        # pstlint's static graph node), a plain lock otherwise.
        self._lock = sanitize.tracked_lock('petastorm_tpu_torch.membudget:MemoryGovernor._lock')
        self._pools = []
        self._breach_sinks = []
        self._budget = budget
        self._budget_source = 'explicit' if budget is not None else None
        self._arm_count = 0
        self._thread = None          # (Thread, its stop Event) while armed
        self._state = STATE_OK
        self._frac = 0.0
        self._accounted = 0
        self._last_pools = {}
        self._peak_frac = 0.0
        self._peak_level = 0
        self._peak_rss = 0
        self._breach_fired = False
        self.breaches = 0
        self.last_breach = None
        self._transitions = deque(maxlen=self.config.transitions_log)
        self._t0 = None
        self._degrade_actions = {}
        self._m_budget = metrics.gauge(
            'pst_mem_budget_bytes',
            'Host memory budget the governor enforces (0 = unarmed)')
        self._m_accounted = metrics.gauge(
            'pst_mem_accounted_bytes',
            'Bytes currently held, by accountable pool',
            labelnames=('pool',))
        self._m_state = metrics.gauge(
            'pst_mem_pressure_state',
            'Pressure-ladder position (0 ok, 1 advisory, 2 degrade, '
            '3 shed, 4 breach)')
        self._m_actions = metrics.counter(
            'pst_mem_degrade_actions_total',
            'Degradation actions the governor ran, by action',
            labelnames=('action',))
        self._m_breaches = metrics.counter(
            'pst_mem_breaches_total',
            'Hard budget breaches (flight dump + HostMemoryExceededError)')

    # -- pool registry -----------------------------------------------------

    def register_pool(self, name, nbytes_fn, degrade_fn=None, degrade_release_fn=None,
                      shed_fn=None, advisory_fn=None):
        """Register a pool; returns its :class:`PoolHandle` (close it at
        teardown). Handles may share a name: accounting sums them."""
        handle = PoolHandle(self, name, nbytes_fn, degrade_fn=degrade_fn,
                            degrade_release_fn=degrade_release_fn, shed_fn=shed_fn,
                            advisory_fn=advisory_fn)
        with self._lock:
            self._pools.append(handle)
            shedding = STATE_LEVELS[self._state] >= STATE_LEVELS[STATE_SHED]
            advising = STATE_LEVELS[self._state] >= STATE_LEVELS[STATE_ADVISORY]
        # A pool registered mid-episode joins the episode's toggles.
        if advising:
            self._toggle(handle.advisory_fn, True, handle.name, 'advisory')
        if shedding:
            self._toggle(handle.shed_fn, True, handle.name, 'shed')
        return handle

    def _unregister(self, handle):
        with self._lock:
            try:
                self._pools.remove(handle)
            except ValueError:
                return
            survivors = {h.name for h in self._pools}
        if handle.name not in survivors:
            # Rebound, not mutated: probe() reads the dict from other threads.
            last = dict(self._last_pools)
            last.pop(handle.name, None)
            self._last_pools = last

    def add_breach_sink(self, fn):
        """``fn(HostMemoryExceededError)``, called on the sampler thread at
        a breach: pipelines hand it to their consumer."""
        with self._lock:
            self._breach_sinks.append(fn)
        return fn

    def remove_breach_sink(self, fn):
        with self._lock:
            try:
                self._breach_sinks.remove(fn)
            except ValueError:
                pass

    # -- arming ------------------------------------------------------------

    @property
    def armed(self):
        return self._arm_count > 0 and self._budget is not None

    @property
    def budget(self):
        return self._budget

    def arm(self, budget=None):
        """Take an arm reference: resolve the budget (on each fresh arming,
        or when one is passed) and start the sampler. True when armed; pair
        every arm with one :meth:`release`. A malformed budget raises
        ``ValueError``."""
        with self._lock:
            if budget is not None or self._budget is None or self._arm_count == 0:
                resolved, source = resolve_budget(explicit=budget)
                if resolved is not None:
                    self._budget = resolved
                    self._budget_source = source
                elif self._budget is None:
                    return False
            self._arm_count += 1
            thread = None
            if self._thread is None:
                # Each sampler has its own stop event, so a re-arm racing a
                # release starts a new thread instead of reviving the old.
                stop = threading.Event()
                thread = threading.Thread(target=self._loop, args=(stop,), daemon=True,
                                          name=THREAD_NAME)
                self._thread = (thread, stop)
        if thread is not None:
            thread.start()
        self._m_budget.set(self._budget)
        logger.info('memory governor armed: budget %d bytes (%s)', self._budget,
                    self._budget_source)
        return True

    def release(self):
        """Drop one arm reference; the last one stops the sampler and
        returns the ladder to ``ok``."""
        with self._lock:
            self._arm_count = max(0, self._arm_count - 1)
            entry = None
            last = self._arm_count == 0
            if last:
                entry, self._thread = self._thread, None
        if entry is not None:
            thread, stop = entry
            stop.set()
            if thread.is_alive():
                thread.join(timeout=5)
        if last:
            self._reset_ladder()
            # '0 = unarmed': nothing else resets the gauges once the
            # sampler is gone.
            self._m_budget.set(0)
            self._m_state.set(0)

    def _reset_ladder(self):
        """Back to ``ok`` when the last owner releases, through the normal
        recede path, so no pool is left with its spill paused or its fill
        stopped and nobody to undo it."""
        previous = self._state
        if previous == STATE_OK:
            return
        self._state = STATE_OK
        self._frac = 0.0
        self._breach_fired = False
        with self._lock:
            self._transitions.append({
                't': round(time.monotonic() - self._t0, 3) if self._t0 is not None else 0.0,
                'state': STATE_OK, 'frac': 0.0, 'accounted': self._accounted,
                'reason': 'disarmed'})
        logger.info('memory governor disarmed at %r: ladder reset to ok', previous)
        self._apply_rung(STATE_OK, previous, {})

    def _loop(self, stop):
        while not stop.wait(self.config.interval_s):
            try:
                self.check()
            except Exception:  # noqa: BLE001 - the governor must not die of a bug
                logger.exception('memory governor check failed')

    # -- the ladder --------------------------------------------------------

    def pressure_level(self):
        """The ladder's level (0 ok .. 4 breach); 0 while unarmed. The
        autotuner's memory bias reads it every tick."""
        if not self.armed:
            return 0
        return STATE_LEVELS[self._state]

    def _sample_pools(self):
        """``{name: bytes}`` summed over the handles; a failing
        ``nbytes_fn`` counts its last good sample. The ``mem-pressure``
        fault site then inflates each selected pool name (not each handle:
        two same-named pools must not double the injected pressure)."""
        spec = faults.get_injector().spec('mem-pressure')
        with self._lock:
            handles = list(self._pools)
        sampled = {}
        for handle in handles:
            try:
                nbytes = int(handle.nbytes_fn() or 0)
            except Exception:  # noqa: BLE001 - a dying pool must not kill the tick
                logger.debug('pool %s nbytes_fn failed', handle.name, exc_info=True)
                nbytes = handle.last_nbytes
            # The fallback keeps the sample before inflation, or a failing
            # pool under the fault would compound it every tick.
            handle.last_nbytes = nbytes
            sampled[handle.name] = sampled.get(handle.name, 0) + nbytes
        if spec is not None:
            inflate = spec.inflate_bytes
            if inflate is None:
                inflate = self._budget or 0
            injector = faults.get_injector()
            for name in list(sampled):
                if injector.selected('mem-pressure', name):
                    sampled[name] += int(inflate)
        return sampled

    def check(self, now=None):
        """One pass (the sampler's tick): sample every pool, walk the
        ladder, run the rung's actions. Returns the state."""
        now = now if now is not None else time.monotonic()
        if self._t0 is None:
            self._t0 = now
        pools = self._sample_pools()
        accounted = sum(pools.values())
        budget = self._budget
        frac = (accounted / budget) if budget else 0.0
        state = self.config.state_for(frac) if self.armed else STATE_OK
        previous = self._state
        self._accounted = accounted
        self._frac = frac
        self._last_pools = pools
        rss = process_rss_bytes()
        if rss:
            self._peak_rss = max(self._peak_rss, rss)
        for name, nbytes in pools.items():
            self._m_accounted.labels(name).set(nbytes)
        self._m_state.set(STATE_LEVELS[state])
        if frac > self._peak_frac:
            self._peak_frac = frac
        if STATE_LEVELS[state] > self._peak_level:
            self._peak_level = STATE_LEVELS[state]
        if state != previous:
            self._state = state
            with self._lock:
                self._transitions.append({'t': round(now - self._t0, 3), 'state': state,
                                          'frac': round(frac, 4), 'accounted': accounted})
            logger.log(logging.WARNING if STATE_LEVELS[state] > STATE_LEVELS[previous]
                       else logging.INFO,
                       'memory pressure %s -> %s: %d of %s budget bytes (%.0f%%)',
                       previous, state, accounted, budget, 100 * frac)
            from petastorm_tpu_torch.trace import get_global_tracer
            get_global_tracer().instant('mem-pressure:{}'.format(state), cat='membudget')
        self._apply_rung(state, previous, pools)
        return state

    def _toggle(self, fn, active, pool_name, rung):
        if fn is None:
            return
        try:
            fn(active)
            if active:
                self._count_action('{}:{}'.format(rung, pool_name))
        except Exception:  # noqa: BLE001 - one pool's hook must not stop the rest
            logger.exception('%s toggle for pool %s failed', rung, pool_name)

    def _count_action(self, action):
        self._m_actions.labels(action).inc()
        with self._lock:
            self._degrade_actions[action] = self._degrade_actions.get(action, 0) + 1

    def _apply_rung(self, state, previous, pools):
        level, prev_level = STATE_LEVELS[state], STATE_LEVELS[previous]
        advisory, shed = STATE_LEVELS[STATE_ADVISORY], STATE_LEVELS[STATE_SHED]
        degrade = STATE_LEVELS[STATE_DEGRADE]
        with self._lock:
            handles = list(self._pools)
        # Advisory and shed are toggles: entering and leaving the band.
        if (level >= advisory) != (prev_level >= advisory):
            for handle in handles:
                self._toggle(handle.advisory_fn, level >= advisory, handle.name, 'advisory')
        if (level >= shed) != (prev_level >= shed):
            for handle in handles:
                self._toggle(handle.shed_fn, level >= shed, handle.name, 'shed')
        # Degrade hooks run every tick while the rung holds: memory may keep
        # climbing between ticks, and the actions are idempotent frees.
        if level >= degrade:
            for handle in handles:
                if handle.degrade_fn is None:
                    continue
                try:
                    acted = handle.degrade_fn()
                except Exception:  # noqa: BLE001
                    logger.exception('degrade hook for pool %s failed', handle.name)
                    continue
                if acted:
                    self._count_action('degrade:{}'.format(handle.name))
        elif prev_level >= degrade:
            for handle in handles:
                if handle.degrade_release_fn is None:
                    continue
                try:
                    handle.degrade_release_fn()
                except Exception:  # noqa: BLE001
                    logger.exception('degrade release for pool %s failed', handle.name)
        if level >= STATE_LEVELS[STATE_BREACH]:
            if not self._breach_fired:
                self._breach_fired = True
                self._fire_breach()
        else:
            self._breach_fired = False

    # -- breach ------------------------------------------------------------

    def pool_ranking(self):
        """Pools by bytes, biggest first."""
        return sorted(({'pool': name, 'nbytes': nbytes}
                       for name, nbytes in self._last_pools.items()),
                      key=lambda entry: entry['nbytes'], reverse=True)

    def _fire_breach(self):
        self.breaches += 1
        self._m_breaches.inc()
        ranking = self.pool_ranking()
        with self._lock:
            transitions = list(self._transitions)
        diagnosis = {'budget_bytes': self._budget, 'budget_source': self._budget_source,
                     'accounted_bytes': self._accounted, 'frac': round(self._frac, 4),
                     'rss_bytes': process_rss_bytes(), 'peak_rss_bytes': self._peak_rss,
                     'pool_ranking': ranking, 'transitions': transitions}
        dump_path = self._dump_flight(diagnosis)
        top = ranking[0] if ranking else {'pool': 'none', 'nbytes': 0}
        message = ('host memory budget breached: {} accounted bytes of {} budget ({:.0%}); top '
                   'pool {!r} holds {} bytes. Flight dump: {}. Raising before the kernel OOM '
                   'killer does it without a diagnosis.'.format(
                       self._accounted, self._budget, self._frac, top['pool'], top['nbytes'],
                       dump_path or '<unavailable>'))
        error = HostMemoryExceededError(message, budget=self._budget, accounted=self._accounted,
                                        ranking=ranking, flight_dump=dump_path)
        self.last_breach = error
        logger.error('%s', message)
        with self._lock:
            sinks = list(self._breach_sinks)
        for sink in sinks:
            try:
                sink(error)
            except Exception:  # noqa: BLE001 - delivery is best-effort per sink
                logger.exception('memory breach delivery failed')

    def _dump_flight(self, diagnosis):
        """The breach's flight-recorder dump (trace ring, metrics, the pool
        ranking) under ``PSTT_FLIGHT_RECORDER``, else the temporary
        directory: a breach post-mortem exists even where no stall recorder
        was armed. Best-effort: returns the path or None."""
        try:
            from petastorm_tpu_torch import flight_recorder
            from petastorm_tpu_torch.trace import get_global_tracer
            base_dir = os.environ.get(flight_recorder.ENV_VAR, '').strip() \
                or tempfile.gettempdir()
            recorder = flight_recorder.FlightRecorder(base_dir, tracer=get_global_tracer())
            return recorder.dump(diagnosis, reason='mem-breach')
        except Exception:  # noqa: BLE001 - a failed dump must not mask the breach
            logger.exception('memory breach flight dump failed')
            return None

    # -- observability -----------------------------------------------------

    def probe(self):
        """The last sample, without a new walk (the watchdog's ``memory``
        probe)."""
        return {'state': self._state, 'level': STATE_LEVELS[self._state], 'armed': self.armed,
                'frac': round(self._frac, 4), 'budget_bytes': self._budget,
                'accounted_bytes': self._accounted, 'pools': dict(self._last_pools)}

    def stats(self):
        """Budget and its source, the ladder's peaks, degrade actions by
        hook, breaches and the transition history."""
        with self._lock:
            actions = dict(self._degrade_actions)
            transitions = list(self._transitions)
        return {'armed': self.armed, 'budget_bytes': self._budget,
                'budget_source': self._budget_source, 'state': self._state,
                'frac': round(self._frac, 4), 'accounted_bytes': self._accounted,
                'peak_frac': round(self._peak_frac, 4), 'peak_state': STATES[self._peak_level],
                'peak_rss_bytes': self._peak_rss, 'pools': dict(self._last_pools),
                'degrade_actions': actions, 'breaches': self.breaches,
                'transitions': transitions}


# --------------------------------------------------------------------------
# the process-wide governor
# --------------------------------------------------------------------------

_governor = None
_governor_lock = threading.Lock()


def get_governor():
    """The process-wide governor every part of the pipeline registers with."""
    global _governor
    if _governor is None:
        with _governor_lock:
            if _governor is None:
                _governor = MemoryGovernor()
    return _governor


def set_governor(governor):
    """Swap the process-wide governor (before building pipelines: pools
    stay on the governor they registered with); returns the previous."""
    global _governor
    with _governor_lock:
        previous = _governor
        _governor = governor
        return previous


def register_pool(name, nbytes_fn, degrade_fn=None, degrade_release_fn=None, shed_fn=None,
                  advisory_fn=None):
    """Register a pool on the process-wide governor."""
    return get_governor().register_pool(name, nbytes_fn, degrade_fn=degrade_fn,
                                        degrade_release_fn=degrade_release_fn,
                                        shed_fn=shed_fn, advisory_fn=advisory_fn)


@contextlib.contextmanager
def transient_pool(name, nbytes_fn, degrade_fn=None, shed_fn=None, advisory_fn=None):
    """A pool registered for the duration of a ``with`` block, closed on the
    way out even when the block raises."""
    handle = register_pool(name, nbytes_fn, degrade_fn=degrade_fn, shed_fn=shed_fn,
                           advisory_fn=advisory_fn)
    try:
        yield handle
    finally:
        handle.close()


def validate_env_budget():
    """Parse ``PSTT_HOST_MEM_BUDGET`` without arming; ``ValueError`` on a
    malformed value. Readers and loaders call it first in ``__init__``, so
    a typo fails before any thread starts."""
    raw = os.environ.get(ENV_VAR, '')
    if raw.strip():
        parse_bytes(raw)


def maybe_arm_from_env():
    """Arm the process-wide governor when ``PSTT_HOST_MEM_BUDGET`` is set.
    True when this call took an arm reference (release it at teardown)."""
    if not os.environ.get(ENV_VAR, '').strip():
        return False
    return get_governor().arm()
