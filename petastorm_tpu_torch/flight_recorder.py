"""Stall flight recorder: post-mortem dumps that need no live process.

Counterpart of ``petastorm_tpu/flight_recorder.py``. It keeps a bounded
ring of periodic metric samples beside the tracer's own event ring, and on
a watchdog's escalation (or a memory breach) dumps everything to a
timestamped directory::

    <base_dir>/pst-flight-20261017-231557-dispatch-hung-ab12cd34/
        trace.json        # Chrome trace of the tracer's event ring
        metrics.prom      # the metrics registry's text exposition
        metrics_ring.json # the recent periodic registry samples (wall-clocked)
        diagnosis.json    # classification, stage, detail, beats, probes
        stacks.txt        # the all-thread stack dump
        lineage.json      # every live provenance ring: the rows in flight

``PSTT_FLIGHT_RECORDER`` (a directory) arms one for every supervised
pipeline built while it is set (:func:`maybe_from_env`); a
:class:`FlightRecorder` can also be handed to
:class:`~petastorm_tpu_torch.health.HealthMonitor`. Dumping is best-effort:
a recorder failure never worsens the stall it documents.
"""

import json
import logging
import os
import threading
import time
import uuid
from collections import deque

logger = logging.getLogger(__name__)

#: Directory that arms a flight recorder for every supervised pipeline.
ENV_VAR = 'PSTT_FLIGHT_RECORDER'

DUMP_DIR_PREFIX = 'pst-flight-'


class FlightRecorder(object):
    """A bounded metrics ring and timestamped post-mortem dumps.

    :param base_dir: where dump directories are made.
    :param tracer: the pipeline's :class:`~petastorm_tpu_torch.trace.Tracer`
        (its ring is the trace flight ring; without one ``trace.json`` is
        an empty timeline).
    :param registry: the :class:`~petastorm_tpu_torch.metrics.MetricsRegistry`
        to snapshot (default: the process's).
    :param metric_ring: periodic samples kept.
    :param sample_min_interval_s: :meth:`sample`'s throttle.
    """

    def __init__(self, base_dir, tracer=None, registry=None, metric_ring=256,
                 sample_min_interval_s=0.25):
        self._base_dir = base_dir
        self._tracer = tracer
        if registry is None:
            from petastorm_tpu_torch import metrics
            registry = metrics.get_registry()
        self._registry = registry
        self._lock = threading.Lock()
        self._samples = deque(maxlen=metric_ring)
        self._sample_min_interval_s = float(sample_min_interval_s)
        self._last_sample_t = 0.0
        self.dumps = []

    @property
    def base_dir(self):
        return self._base_dir

    def sample(self):
        """One wall-clocked registry snapshot into the ring (throttled: the
        watchdog calls it every pass). True when one was taken."""
        now = time.monotonic()
        with self._lock:
            if now - self._last_sample_t < self._sample_min_interval_s:
                return False
            self._last_sample_t = now
        try:
            snapshot = self._registry.collect()
        except Exception:  # noqa: BLE001 - recording must not hurt the pipeline
            logger.debug('flight recorder sample failed', exc_info=True)
            return False
        with self._lock:
            self._samples.append({'wall_time': time.time(), 'metrics': snapshot})
        return True

    def dump(self, diagnosis=None, reason='stall'):
        """Write the rings and ``diagnosis`` to a fresh directory; returns
        its path (None when even its creation failed)."""
        stamp = time.strftime('%Y%m%d-%H%M%S')
        safe_reason = ''.join(c if c.isalnum() or c == '-' else '-'
                              for c in str(reason))[:48] or 'stall'
        path = os.path.join(self._base_dir, '{}{}-{}-{}'.format(
            DUMP_DIR_PREFIX, stamp, safe_reason, uuid.uuid4().hex[:8]))
        try:
            os.makedirs(path, exist_ok=True)
        except OSError:
            logger.warning('flight recorder cannot create dump dir under %r', self._base_dir,
                           exc_info=True)
            return None
        self._write_trace(os.path.join(path, 'trace.json'))
        self._write_metrics(path)
        self._write_diagnosis(path, diagnosis)
        self._write_lineage(path)
        with self._lock:
            self.dumps.append(path)
        logger.warning('flight recorder dumped stall evidence to %s', path)
        return path

    # -- the pieces, each best-effort --------------------------------------

    def _write_trace(self, path):
        try:
            export = getattr(self._tracer, 'export_chrome_trace', None)
            if export is not None:
                export(path)
            else:
                with open(path, 'w') as f:
                    json.dump({'traceEvents': [], 'displayTimeUnit': 'ms'}, f)
        except Exception:  # noqa: BLE001
            logger.debug('flight recorder trace dump failed', exc_info=True)

    def _write_metrics(self, dump_dir):
        try:
            self._registry.write_textfile(os.path.join(dump_dir, 'metrics.prom'))
        except Exception:  # noqa: BLE001
            logger.debug('flight recorder metrics dump failed', exc_info=True)
        try:
            with self._lock:
                samples = list(self._samples)
            with open(os.path.join(dump_dir, 'metrics_ring.json'), 'w') as f:
                json.dump(samples, f, default=repr)
        except Exception:  # noqa: BLE001
            logger.debug('flight recorder ring dump failed', exc_info=True)

    def _write_lineage(self, dump_dir):
        """Every live provenance tracker's ring and in-flight records
        (:func:`~petastorm_tpu_torch.lineage.live_rings`); ``[]`` when none
        is armed."""
        try:
            from petastorm_tpu_torch import lineage
            with open(os.path.join(dump_dir, 'lineage.json'), 'w') as f:
                json.dump(lineage.live_rings(), f, default=repr)
        except Exception:  # noqa: BLE001
            logger.debug('flight recorder lineage dump failed', exc_info=True)

    def _write_diagnosis(self, dump_dir, diagnosis):
        if diagnosis is None:
            return
        try:
            # A watchdog's StallDiagnosis holds its stacks as walked; a
            # plain dict may carry them as text.
            stacks = (diagnosis.stacks_text() if hasattr(diagnosis, 'stacks_text')
                      else diagnosis.get('stacks'))
            summary = {k: v for k, v in dict(diagnosis).items() if k != 'stacks'}
            with open(os.path.join(dump_dir, 'diagnosis.json'), 'w') as f:
                # default=repr: probe snapshots may hold numpy scalars.
                json.dump(summary, f, default=repr, indent=1)
            if stacks:
                with open(os.path.join(dump_dir, 'stacks.txt'), 'w') as f:
                    f.write(stacks)
        except Exception:  # noqa: BLE001
            logger.debug('flight recorder diagnosis dump failed', exc_info=True)


def maybe_from_env(tracer=None, registry=None):
    """A :class:`FlightRecorder` under ``PSTT_FLIGHT_RECORDER`` when it names
    a directory, else None."""
    base_dir = os.environ.get(ENV_VAR, '').strip()
    if not base_dir:
        return None
    return FlightRecorder(base_dir, tracer=tracer, registry=registry)
