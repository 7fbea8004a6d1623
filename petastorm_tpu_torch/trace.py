"""Input-pipeline tracing: Chrome trace timelines across processes.

Counterpart of ``petastorm_tpu/trace.py``. A :class:`Tracer` records
*spans* (named, timed durations of one thread), instants and counter
samples, and exports the Chrome trace-event JSON that chrome://tracing and
Perfetto draw as a timeline. That is how an input stall is seen: the
consumer's ``wait`` spans grow exactly when the dispatch thread's
``dispatch`` spans or the workers' ``decode`` spans stretch.

The stages record (the JAX package's names):

* ``read``, ``decode`` and ``handoff``: the reader's workers, through the
  process's global tracer (:func:`set_global_tracer`);
* ``assemble`` (collate into an arena) and ``dispatch`` (the staging
  engine's call of the loader's stage function), with the counters
  ``staging_inflight`` and ``arena_pool_free``;
* ``stage`` (the loader's copy issue, inside ``dispatch``) and ``wait``
  (the consumer blocked in ``next``).

Every span is host time. On the card a ``dispatch`` or ``stage`` span
measures the *issue* of the asynchronous (``non_blocking``) copies, not the
copies: the wait for a copy is the dispatch thread's retire of its arena,
and the copies themselves are seen by ``torch.profiler``, not here.

Sidecars: with ``PSTT_TRACE_DIR`` set (the JAX package's grammar: any
non-empty value is a directory), every tracer built afterwards also spills
its events to a per-process JSONL file ``trace-<pid>-<uid>.jsonl`` there,
line-buffered and bounded, with a header line keyed ``__pst_trace_sidecar__``
(the JAX package's key, so either package's merge reads the other's
sidecars). A process killed mid-write leaves at most one torn trailing
line, which :meth:`Tracer.merge_process_files` and ``python -m
petastorm_tpu_torch.tools.trace_merge`` skip.

The port's export also writes a ``thread_name`` metadata event for each
thread seen (the JAX package's writes ``process_name`` only), so the
timeline's tracks carry the ``pstt-*`` thread names.

Pure stdlib, thread-safe, bounded (the oldest events drop beyond
``max_events``; sidecars stop at ``spill_max_events`` lines).
"""

import glob
import json
import logging
import os
import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager

logger = logging.getLogger(__name__)

#: Directory that arms per-process sidecar spill for every Tracer built
#: while it is set.
TRACE_DIR_ENV = 'PSTT_TRACE_DIR'

_SIDECAR_GLOB = 'trace-*.jsonl'
_HEADER_KEY = '__pst_trace_sidecar__'


class Tracer(object):
    """Thread-safe span recorder with Chrome trace-event export.

    :param max_events: the in-memory ring's bound (the oldest drop past it).
    :param spill_dir: directory of this process's JSONL sidecar. ``None``
        (default) reads ``PSTT_TRACE_DIR``; ``False`` disables spill even
        when the variable is set.
    :param role: label of this process's track in merged timelines.
    :param spill_max_events: the sidecar's line bound (default
        ``max_events``); past it events still land in memory, and one
        truncation marker is written.
    """

    def __init__(self, max_events=100000, spill_dir=None, role=None, spill_max_events=None):
        self._events = deque(maxlen=max_events)
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        # The wall-clock anchor of t0 aligns sidecars of other processes.
        self._wall0 = time.time()
        self._pid = os.getpid()
        self.role = role or 'main'
        if spill_dir is None:
            spill_dir = os.environ.get(TRACE_DIR_ENV) or None
        elif spill_dir is False:
            spill_dir = None
        self._spill_dir = spill_dir
        self._spill_file = None
        self._spill_path = None
        self._spill_count = 0
        self._spill_dropped = 0
        self._spill_failed = False
        self._spill_max = int(spill_max_events) if spill_max_events is not None else max_events
        self._merged = []            # events folded in from sidecar files
        self._roles = {}             # pid -> role (merged sidecar headers)
        self._thread_names = {}      # tid -> thread name, at its first event

    # -- recording ---------------------------------------------------------

    @contextmanager
    def span(self, name, cat='pipeline'):
        start = time.perf_counter()
        try:
            yield
        finally:
            end = time.perf_counter()
            self._append({'name': name, 'cat': cat, 'ph': 'X',
                          'ts': (start - self._t0) * 1e6, 'dur': (end - start) * 1e6,
                          'pid': self._pid, 'tid': threading.get_ident()})

    def instant(self, name, cat='pipeline', args=None):
        """A zero-duration marker; ``args`` (JSON-safe) shows in the
        viewer's detail pane."""
        event = {'name': name, 'cat': cat, 'ph': 'i', 's': 't',
                 'ts': (time.perf_counter() - self._t0) * 1e6,
                 'pid': self._pid, 'tid': threading.get_ident()}
        if args:
            event['args'] = dict(args)
        self._append(event)

    def counter(self, name, value, cat='pipeline'):
        """A counter-track sample (a 'C' event, drawn as an area chart)."""
        self._append({'name': name, 'cat': cat, 'ph': 'C',
                      'ts': (time.perf_counter() - self._t0) * 1e6,
                      'pid': self._pid, 'tid': threading.get_ident(),
                      'args': {name: value}})

    def _append(self, event):
        tid = event.get('tid')
        with self._lock:
            if tid not in self._thread_names:
                self._thread_names[tid] = threading.current_thread().name
            self._events.append(event)
            if self._spill_dir is not None:
                self._spill(event)

    # -- sidecar spill -----------------------------------------------------

    def _spill(self, event):
        """One event line into the sidecar (lock held)."""
        if self._spill_failed:
            return
        if self._spill_file is None and not self._open_spill():
            return
        if self._spill_count >= self._spill_max:
            if self._spill_dropped == 0:
                try:
                    self._spill_file.write(json.dumps(
                        {'name': 'trace-spill-truncated', 'cat': 'trace', 'ph': 'i', 's': 't',
                         'ts': event.get('ts', 0.0), 'pid': self._pid,
                         'tid': threading.get_ident()}) + '\n')
                except OSError:
                    self._spill_failed = True
            self._spill_dropped += 1
            return
        try:
            self._spill_file.write(json.dumps(event) + '\n')
            self._spill_count += 1
        except (OSError, TypeError, ValueError):
            # Tracing is advice: a full disk or an args payload that is not
            # JSON must not take the pipeline down.
            logger.warning('trace sidecar write failed; disabling spill', exc_info=True)
            self._spill_failed = True

    def _open_spill(self):
        try:
            os.makedirs(self._spill_dir, exist_ok=True)
            path = os.path.join(self._spill_dir, 'trace-{}-{}.jsonl'.format(
                self._pid, uuid.uuid4().hex[:8]))
            # Line-buffered: a killed process leaves whole lines.
            self._spill_file = open(path, 'w', buffering=1)
            self._spill_path = path
            self._spill_file.write(json.dumps({_HEADER_KEY: 1, 'pid': self._pid,
                                               'role': self.role, 'wall0': self._wall0}) + '\n')
            return True
        except OSError:
            logger.warning('cannot open trace sidecar in %r; disabling spill', self._spill_dir,
                           exc_info=True)
            self._spill_failed = True
            return False

    @property
    def spill_path(self):
        """This tracer's sidecar file (None when spill is off or before the
        first event)."""
        with self._lock:
            return self._spill_path

    def close(self):
        """Flush and close the sidecar (idempotent)."""
        with self._lock:
            f, self._spill_file = self._spill_file, None
        if f is not None:
            try:
                f.flush()
                f.close()
            except OSError:
                pass

    # -- merge -------------------------------------------------------------

    @property
    def wall0(self):
        """The wall-clock anchor of this tracer's t0 (the merge timebase)."""
        return self._wall0

    def merge_process_files(self, spill_dir=None, since_wall0=None):
        """Fold every sidecar under ``spill_dir`` (default: this tracer's,
        else ``PSTT_TRACE_DIR``) into this timeline, each file's events
        shifted by its wall-clock anchor; this tracer's own sidecar is
        skipped, and so are torn or corrupt lines. ``since_wall0`` skips
        files anchored before it (an earlier run's leftovers: the directory
        is not scoped to one run). Returns the number of files merged."""
        directory = spill_dir or self._spill_dir or os.environ.get(TRACE_DIR_ENV)
        if not directory:
            raise ValueError('no spill directory: pass spill_dir or set {}'.format(TRACE_DIR_ENV))
        own = self.spill_path
        merged_files = 0
        for path in sorted(glob.glob(os.path.join(directory, _SIDECAR_GLOB))):
            if own is not None and os.path.abspath(path) == os.path.abspath(own):
                continue
            header, events = read_sidecar_file(path)
            if header is None and not events:
                continue
            if since_wall0 is not None and header is not None \
                    and header.get('wall0', since_wall0) < since_wall0:
                continue
            offset_us = 0.0
            pid = None
            if header is not None:
                pid = header.get('pid')
                offset_us = (header.get('wall0', self._wall0) - self._wall0) * 1e6
                if pid is not None and header.get('role'):
                    self._roles[pid] = header['role']
            adjusted = []
            for event in events:
                event = dict(event)
                event['ts'] = event.get('ts', 0.0) + offset_us
                if 'pid' not in event and pid is not None:
                    event['pid'] = pid
                adjusted.append(event)
            with self._lock:
                self._merged.extend(adjusted)
            merged_files += 1
        return merged_files

    # -- inspection and export ---------------------------------------------

    @property
    def events(self):
        with self._lock:
            return list(self._events) + list(self._merged)

    def summary(self):
        """``{name: {'count', 'total_s', 'p50_s', 'p99_s'}}`` over the
        spans (nearest-rank percentiles)."""
        durations = {}
        for e in self.events:
            if e.get('ph') == 'X':
                durations.setdefault(e['name'], []).append(e.get('dur', 0.0) / 1e6)
        out = {}
        for name, values in sorted(durations.items()):
            values.sort()
            out[name] = {'count': len(values), 'total_s': round(sum(values), 4),
                         'p50_s': round(_percentile(values, 0.50), 6),
                         'p99_s': round(_percentile(values, 0.99), 6)}
        return out

    def export_chrome_trace(self, path):
        """Write the Chrome trace-event JSON to ``path``, atomically (a
        temporary file renamed over it), with a ``process_name`` event for
        each pid and a ``thread_name`` event for each thread of this
        process that recorded. Returns ``path``."""
        events = self.events
        with self._lock:
            roles = dict(self._roles)
            thread_names = dict(self._thread_names)
        roles.setdefault(self._pid, self.role)
        metadata = []
        for pid in sorted({e.get('pid') for e in events if 'pid' in e}):
            metadata.append({'name': 'process_name', 'ph': 'M', 'pid': pid,
                             'args': {'name': '{} (pid {})'.format(roles.get(pid, 'process'),
                                                                   pid)}})
        for tid, name in sorted(thread_names.items(), key=lambda item: str(item[0])):
            metadata.append({'name': 'thread_name', 'ph': 'M', 'pid': self._pid, 'tid': tid,
                             'args': {'name': name}})
        tmp = '{}.tmp.{}.{}'.format(path, os.getpid(), uuid.uuid4().hex[:8])
        with open(tmp, 'w') as f:
            json.dump({'traceEvents': metadata + events, 'displayTimeUnit': 'ms'}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return path


def _percentile(sorted_values, q):
    """Nearest-rank percentile of an ascending list (empty: 0)."""
    if not sorted_values:
        return 0.0
    index = min(len(sorted_values) - 1, max(0, int(round(q * (len(sorted_values) - 1)))))
    return sorted_values[index]


def read_sidecar_file(path):
    """``(header or None, [events])`` of one sidecar; torn and corrupt
    lines are skipped."""
    header = None
    events = []
    try:
        with open(path, 'r') as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    record = json.loads(line)
                except ValueError:
                    continue
                if not isinstance(record, dict):
                    continue
                if record.get(_HEADER_KEY):
                    header = record
                else:
                    events.append(record)
    except OSError:
        logger.warning('cannot read trace sidecar %r', path, exc_info=True)
    return header, events


def install_worker_tracer(role=None):
    """With ``PSTT_TRACE_DIR`` set, a spilling tracer installed as this
    process's global tracer (a worker process's start-up hook; the caller
    closes it at shutdown), else None."""
    if not os.environ.get(TRACE_DIR_ENV):
        return None
    tracer = Tracer(role=role or 'worker-{}'.format(os.getpid()))
    set_global_tracer(tracer)
    return tracer


_global_tracer = None


def set_global_tracer(tracer):
    """Install the process-wide tracer that instrumentation points without
    a tracer argument report to (the workers' spans, the fault sites, the
    memory governor, the chunk store); ``None`` resets. Returns the
    previous one."""
    global _global_tracer
    previous = _global_tracer
    _global_tracer = tracer
    return previous


def get_global_tracer():
    """The installed global tracer, or a shared :class:`NullTracer`."""
    return _global_tracer if _global_tracer is not None else _NULL_TRACER


class _NullSpan(object):
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class NullTracer(object):
    """No-op stand-in, so call sites never branch."""

    _SPAN = _NullSpan()

    def span(self, name, cat='pipeline'):
        return self._SPAN

    def instant(self, name, cat='pipeline', args=None):
        pass

    def counter(self, name, value, cat='pipeline'):
        pass

    def close(self):
        pass


_NULL_TRACER = NullTracer()
