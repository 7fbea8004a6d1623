"""Metrics registry: typed instruments and Prometheus exporters.

Counterpart of ``petastorm_tpu/metrics.py:1-605``, with
:func:`scrape_fleet_metrics` for the data service's fleet scrape. The port
registers only names the JAX package registers, with the same help text,
labels and buckets, so one dashboard reads either package.

:class:`Counter` / :class:`Gauge` / :class:`Histogram`
    Thread-safe instruments with optional labels. Histograms use fixed
    log-spaced buckets (:data:`DEFAULT_LATENCY_BUCKETS`), so snapshots of
    several processes merge bucket for bucket.

:class:`MetricsRegistry`
    Name -> instrument map. ``collect()`` is one JSON-safe snapshot;
    ``render_text()`` the Prometheus text exposition (format 0.0.4).

Exporters
    ``write_textfile(path)`` (tmp file and rename) and
    :class:`MetricsExporter`, an opt-in ``http.server`` scrape endpoint on
    a daemon thread named ``pstt-metrics-exporter``, bound to 127.0.0.1 by
    default. :func:`aggregate_snapshots` folds snapshots of several
    processes into one.

Call sites get instruments through :func:`counter`/:func:`gauge`/
:func:`histogram` (get-or-create on the default registry) and keep the
returned object: an ``inc()`` is then one lock and an add, so counters stay
off the per-row path (one bump per row-group or batch).
"""

import json
import logging
import math
import os
import threading
import uuid

from petastorm_tpu_torch.analysis import sanitize

logger = logging.getLogger(__name__)

THREAD_NAME = 'pstt-metrics-exporter'

#: Process-unique registry identity (a bare OS pid collides across hosts
#: and containers), for a consumer that dedupes snapshots before folding.
REGISTRY_INSTANCE_ID = uuid.uuid4().hex

#: Log-spaced latency buckets (seconds): three per decade, 100us..60s.
#: Fixed (not configurable per instrument creation site) so histograms
#: recorded by different pipelines/processes merge bucket-for-bucket.
DEFAULT_LATENCY_BUCKETS = (
    0.0001, 0.00025, 0.0005,
    0.001, 0.0025, 0.005,
    0.01, 0.025, 0.05,
    0.1, 0.25, 0.5,
    1.0, 2.5, 5.0,
    10.0, 30.0, 60.0)

#: Log-spaced size buckets (bytes): 1KB..4GB by powers of 4.
DEFAULT_SIZE_BUCKETS = tuple(float(1 << s) for s in range(10, 33, 2))


def _check_name(name):
    if not name or not all(c.isalnum() or c in '_:' for c in name):
        raise ValueError('invalid metric name {!r} (want [a-zA-Z0-9_:]+)'
                         .format(name))


def _escape_label_value(value):
    return (str(value).replace('\\', r'\\').replace('\n', r'\n')
            .replace('"', r'\"'))


def _format_labels(labels):
    if not labels:
        return ''
    return '{{{}}}'.format(','.join(
        '{}="{}"'.format(k, _escape_label_value(v))
        for k, v in sorted(labels.items())))


def _format_value(value):
    if value == math.inf:
        return '+Inf'
    if isinstance(value, float) and value.is_integer():
        return str(int(value))
    return repr(value) if isinstance(value, float) else str(value)


class _Instrument(object):
    """Base: a named, typed metric with optional labels. A labeled parent
    holds children keyed by label-value tuples; an unlabeled instrument is
    its own sole sample."""

    _type = 'untyped'

    def __init__(self, name, help='', labelnames=()):
        _check_name(name)
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children = {}          # label-values tuple -> child
        self._value = 0.0

    def labels(self, *values, **kwargs):
        """The child instrument for one label-value combination."""
        if kwargs:
            if values:
                raise ValueError('pass label values positionally OR by name')
            values = tuple(kwargs[n] for n in self.labelnames)
        values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError('{} expects labels {}, got {!r}'.format(
                self.name, self.labelnames, values))
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._new_child()
                self._children[values] = child
            return child

    def _new_child(self):
        return type(self)(self.name, self.help)

    def remove(self, *values):
        """Drop the child for one label-value combination (no-op when
        absent). Owners of per-instance labels (the lineage ledger's
        ``ledger`` gauge) call this on teardown so dead instances stop
        scraping as live and label children don't accumulate unboundedly
        in a long process."""
        values = tuple(str(v) for v in values)
        with self._lock:
            self._children.pop(values, None)

    def _samples(self):
        """[(labels dict, sample dict)] for collection."""
        if self.labelnames:
            with self._lock:
                children = list(self._children.items())
            return [(dict(zip(self.labelnames, values)), child._sample())
                    for values, child in children]
        return [({}, self._sample())]

    def _sample(self):
        with self._lock:
            return {'value': self._value}


class Counter(_Instrument):
    """Monotonically increasing count. ``inc()`` only goes up."""

    _type = 'counter'

    def inc(self, amount=1):
        if amount < 0:
            raise ValueError('counters only go up; inc({}) refused'
                             .format(amount))
        with self._lock:
            self._value += amount

    @property
    def value(self):
        with self._lock:
            return self._value


class Gauge(_Instrument):
    """A value that can go anywhere: set/inc/dec, or a ``set_function``
    callable read at collect time (for values owned by live objects)."""

    _type = 'gauge'

    def __init__(self, name, help='', labelnames=()):
        super(Gauge, self).__init__(name, help, labelnames)
        self._fn = None

    def set(self, value):
        with self._lock:
            self._value = float(value)

    def inc(self, amount=1):
        with self._lock:
            self._value += amount

    def dec(self, amount=1):
        with self._lock:
            self._value -= amount

    def set_function(self, fn):
        """Read the gauge from ``fn()`` at collect time (exceptions fall
        back to the last set value)."""
        with self._lock:
            self._fn = fn

    @property
    def value(self):
        return self._sample()['value']

    def _sample(self):
        with self._lock:
            fn = self._fn
            value = self._value
        if fn is not None:
            try:
                value = float(fn())
            except Exception:  # noqa: BLE001 - a dying getter must not kill collect
                logger.debug('gauge %s set_function failed', self.name,
                             exc_info=True)
        return {'value': value}


class Histogram(_Instrument):
    """Fixed-bucket histogram (cumulative, Prometheus-style)."""

    _type = 'histogram'

    def __init__(self, name, help='', labelnames=(), buckets=None):
        super(Histogram, self).__init__(name, help, labelnames)
        self.buckets = tuple(sorted(buckets if buckets is not None
                                    else DEFAULT_LATENCY_BUCKETS))
        self._counts = [0] * (len(self.buckets) + 1)   # +1 = +Inf
        self._sum = 0.0
        self._count = 0

    def _new_child(self):
        # children share the parent's buckets, not the module defaults
        return Histogram(self.name, self.help, buckets=self.buckets)

    def observe(self, value):
        value = float(value)
        with self._lock:
            self._sum += value
            self._count += 1
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    def _sample(self):
        with self._lock:
            cumulative, total = {}, 0
            for bound, n in zip(self.buckets, self._counts):
                total += n
                cumulative['{:g}'.format(bound)] = total
            cumulative['+Inf'] = total + self._counts[-1]
            return {'buckets': cumulative,
                    'sum': self._sum,
                    'count': self._count}


class MetricsRegistry(object):
    """Thread-safe name -> instrument map with one-snapshot collection."""

    def __init__(self):
        # Lock-order-recorded when PSTT_SANITIZE is armed (the name is
        # pstlint's static graph node), a plain lock otherwise.
        self._lock = sanitize.tracked_lock('petastorm_tpu_torch.metrics:MetricsRegistry._lock')
        self._instruments = {}

    def _get_or_create(self, cls, name, help, labelnames, **kwargs):
        with self._lock:
            existing = self._instruments.get(name)
            if existing is not None:
                if not isinstance(existing, cls) \
                        or existing.labelnames != tuple(labelnames):
                    raise ValueError(
                        'metric {!r} already registered as {} with labels {} '
                        '(requested {} with labels {})'.format(
                            name, existing._type, existing.labelnames,
                            cls._type, tuple(labelnames)))
                return existing
            instrument = cls(name, help=help, labelnames=labelnames, **kwargs)
            self._instruments[name] = instrument
            return instrument

    def counter(self, name, help='', labelnames=()):
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help='', labelnames=()):
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name, help='', labelnames=(), buckets=None):
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def unregister(self, name):
        with self._lock:
            self._instruments.pop(name, None)

    def clear(self):
        """Drop every instrument (tests)."""
        with self._lock:
            self._instruments.clear()

    def collect(self):
        """One JSON-safe snapshot of every instrument::

            {name: {'type': ..., 'help': ..., 'samples': [
                {'labels': {...}, 'value': v}                  # counter/gauge
                {'labels': {...}, 'buckets': {...},            # histogram
                 'sum': s, 'count': n}]}}
        """
        with self._lock:
            instruments = sorted(self._instruments.items())
        out = {}
        for name, instrument in instruments:
            samples = []
            for labels, sample in instrument._samples():
                entry = dict(sample)
                entry['labels'] = labels
                samples.append(entry)
            out[name] = {'type': instrument._type,
                         'help': instrument.help,
                         'samples': samples}
        return out

    def render_text(self):
        """Prometheus text exposition (format 0.0.4) of :meth:`collect`."""
        return render_text(self.collect())

    def write_textfile(self, path):
        """Atomically write the exposition to ``path`` (tmp + rename), the
        node-exporter textfile-collector contract: a scraper can never see
        a torn file, even if this process dies mid-write."""
        text = self.render_text()
        # pid alone is not unique enough: two threads writing the same
        # textfile (periodic export racing a flight-recorder dump) must
        # not share — and truncate — one tmp file.
        tmp = '{}.tmp.{}.{}'.format(path, os.getpid(), uuid.uuid4().hex[:8])
        with open(tmp, 'w') as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return path


def render_text(snapshot):
    """Prometheus text exposition of a :meth:`MetricsRegistry.collect`
    snapshot (module-level so RPC'd remote snapshots render too)."""
    lines = []
    for name, metric in sorted(snapshot.items()):
        if metric.get('help'):
            lines.append('# HELP {} {}'.format(
                name, metric['help'].replace('\\', r'\\').replace('\n', r'\n')))
        lines.append('# TYPE {} {}'.format(name, metric['type']))
        for sample in metric['samples']:
            labels = sample.get('labels') or {}
            if metric['type'] == 'histogram':
                for bound, count in sample['buckets'].items():
                    bucket_labels = dict(labels)
                    bucket_labels['le'] = bound
                    lines.append('{}_bucket{} {}'.format(
                        name, _format_labels(bucket_labels),
                        _format_value(count)))
                lines.append('{}_sum{} {}'.format(
                    name, _format_labels(labels),
                    _format_value(sample['sum'])))
                lines.append('{}_count{} {}'.format(
                    name, _format_labels(labels),
                    _format_value(sample['count'])))
            else:
                lines.append('{}{} {}'.format(
                    name, _format_labels(labels),
                    _format_value(sample['value'])))
    return '\n'.join(lines) + '\n'


def aggregate_snapshots(snapshots):
    """Merge ``collect()`` snapshots from several processes/servers into
    one snapshot: counters and histograms sum per (name, labels); gauges
    sum too (totals: queue depths and open-entry counts add; a consumer
    wanting per-process gauges reads the unmerged snapshots)."""
    merged = {}
    for snapshot in snapshots:
        if not snapshot:
            continue
        for name, metric in snapshot.items():
            target = merged.setdefault(name, {'type': metric['type'],
                                              'help': metric.get('help', ''),
                                              'samples': []})
            if target['type'] != metric['type']:
                logger.warning('metric %s type mismatch across snapshots '
                               '(%s vs %s); skipping one side', name,
                               target['type'], metric['type'])
                continue
            by_labels = {json.dumps(s.get('labels') or {}, sort_keys=True): s
                         for s in target['samples']}
            for sample in metric['samples']:
                key = json.dumps(sample.get('labels') or {}, sort_keys=True)
                into = by_labels.get(key)
                if into is None:
                    copied = dict(sample)
                    if 'buckets' in copied:
                        copied['buckets'] = dict(copied['buckets'])
                    target['samples'].append(copied)
                    by_labels[key] = copied
                    continue
                if metric['type'] == 'histogram':
                    into['sum'] += sample['sum']
                    into['count'] += sample['count']
                    for bound, count in sample['buckets'].items():
                        into['buckets'][bound] = \
                            into['buckets'].get(bound, 0) + count
                else:
                    into['value'] += sample['value']
    return merged


def scrape_fleet_metrics(endpoints, scrape_one, server_value='metrics',
                         unreachable_detail=False):
    """One fleet-wide scrape (``petastorm_tpu/metrics.py:428``):
    ``scrape_one(endpoint)`` performs one ``metrics`` rpc and returns its
    reply dict (or raises). Replies are deduplicated on the process
    registry's uuid (servers in one process share a registry, and summing
    the same snapshot twice would double every counter) and folded through
    :func:`aggregate_snapshots`. An endpoint that raises or replies without
    a ``metrics`` dict lands in ``unreachable``. ``server_value``:
    ``'metrics'`` (the snapshot) or ``'reply'`` (the whole reply) per
    endpoint; ``unreachable_detail=True`` records ``{'endpoint', 'error'}``
    dicts instead of bare endpoints."""
    servers, unreachable, by_process = {}, [], {}

    def _mark_unreachable(endpoint, error):
        unreachable.append({'endpoint': endpoint, 'error': error}
                           if unreachable_detail else endpoint)

    for endpoint in endpoints:
        try:
            reply = scrape_one(endpoint)
        except Exception as e:  # noqa: BLE001 - a server dying mid-scrape
            logger.debug('fleet metrics scrape: %s failed', endpoint, exc_info=True)
            _mark_unreachable(endpoint, repr(e))
            continue
        if not isinstance(reply, dict) or 'error' in reply \
                or not isinstance(reply.get('metrics'), dict):
            _mark_unreachable(endpoint, repr(reply))
            continue
        servers[endpoint] = reply if server_value == 'reply' else reply['metrics']
        # Without a registry id a reply cannot be deduplicated: kept per endpoint.
        process_key = reply.get('registry_id')
        by_process[process_key if process_key is not None
                   else ('endpoint', endpoint)] = reply['metrics']
    return {'servers': servers,
            'aggregate': aggregate_snapshots(by_process.values()),
            'unreachable': unreachable}


# --------------------------------------------------------------------------
# process-wide default registry
# --------------------------------------------------------------------------

_default_registry = MetricsRegistry()
_registry_lock = threading.Lock()


def get_registry():
    """The process-wide default registry every instrumented call site
    reports to."""
    return _default_registry


def set_registry(registry):
    """Swap the default registry (tests isolate counters this way).
    Returns the previous one. Call sites that CACHED an instrument keep
    reporting to the old registry — swap before building pipelines."""
    global _default_registry
    with _registry_lock:
        previous = _default_registry
        _default_registry = registry if registry is not None \
            else MetricsRegistry()
        return previous


def counter(name, help='', labelnames=()):
    """Get-or-create a :class:`Counter` on the default registry."""
    return get_registry().counter(name, help, labelnames)


def gauge(name, help='', labelnames=()):
    """Get-or-create a :class:`Gauge` on the default registry."""
    return get_registry().gauge(name, help, labelnames)


def histogram(name, help='', labelnames=(), buckets=None):
    """Get-or-create a :class:`Histogram` on the default registry."""
    return get_registry().histogram(name, help, labelnames, buckets=buckets)


# --------------------------------------------------------------------------
# HTTP scrape endpoint (opt-in)
# --------------------------------------------------------------------------

class MetricsExporter(object):
    """Opt-in Prometheus scrape endpoint on a stdlib ``http.server``.

    ::

        exporter = MetricsExporter(port=9095).start()
        # GET http://127.0.0.1:9095/metrics
        exporter.stop()

    ``port=0`` binds an ephemeral port (read it back from ``.port``).
    The serving thread is a daemon named ``pstt-metrics-exporter`` so a
    leak is findable. ``stop()`` shuts the listener down and joins the thread.
    """

    def __init__(self, registry=None, host='127.0.0.1', port=0):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self._registry = registry if registry is not None else get_registry()
        registry_ref = self._registry

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - http.server API
                if self.path.split('?')[0] not in ('/metrics', '/'):
                    self.send_error(404)
                    return
                try:
                    body = registry_ref.render_text().encode()
                except Exception as e:  # noqa: BLE001 - scrape must not kill serving
                    self.send_error(500, explain=repr(e))
                    return
                self.send_response(200)
                self.send_header('Content-Type',
                                 'text/plain; version=0.0.4; charset=utf-8')
                self.send_header('Content-Length', str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):   # silence per-scrape stderr spam
                pass

        self._server = ThreadingHTTPServer((host, port), _Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        kwargs={'poll_interval': 0.1},
                                        daemon=True,
                                        name=THREAD_NAME)
        self._started = False

    @property
    def port(self):
        return self._server.server_address[1]

    @property
    def address(self):
        host, port = self._server.server_address[:2]
        return 'http://{}:{}/metrics'.format(host, port)

    def start(self):
        if not self._started:
            self._thread.start()
            self._started = True
        return self

    def stop(self, join_timeout_s=5):
        if self._started:
            self._server.shutdown()
        self._server.server_close()
        if self._started and self._thread.is_alive():
            self._thread.join(timeout=join_timeout_s)
        self._started = False

    def __enter__(self):
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        self.stop()
        return False


def start_http_exporter(port=0, host='127.0.0.1', registry=None):
    """Convenience: build + start a :class:`MetricsExporter`."""
    return MetricsExporter(registry=registry, host=host, port=port).start()
