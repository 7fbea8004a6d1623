"""Deterministic fault injection for the input pipeline.

Counterpart of ``petastorm_tpu/faults.py``. The failure model (poison
row-group quarantine under ``error_budget``, retry with backoff) is only
trustworthy when each failure it claims to survive can be injected on
purpose, so every such failure has a site here, armed through the
``PSTT_FAULTS`` environment variable. The spec text is the JAX package's,
and :data:`KNOWN_SITES` is its whole list, so one spec parses alike in both
packages and selects the same keys.

Spec syntax (semicolon-separated sites, colon-separated ``key=value`` params)::

    PSTT_FAULTS="decode-corrupt:p=0.3:seed=7;fs-read-error:max=2"

Sites the port runs, and their effect when they fire:

======================== ==================================================
``fs-read-error``        raise ``IOError`` at the row-group read and in the
                         retrying filesystem wrapper
``fs-read-delay``        sleep ``delay`` seconds at the same points
``decode-corrupt``       raise ``DecodeFieldError`` before a row-group's
                         decode (tensor, per-row and Arrow workers)
``decode-corrupt-batch`` poison slot 0 of a batched image decode
                         (``codecs.decode_image_batch_into``): only that
                         row-group fails, and its ``DecodeFieldError``
                         carries the native codec's error string
``queue-stall``          sleep ``delay`` seconds before a pool's worker
                         publishes a result (threads and processes)
``worker-kill``          SIGKILL the process-pool worker about to run an
                         item (``workers/process_pool.run_worker_item``);
                         with ``token=`` exactly one across the pool
``device-put-delay``     sleep ``delay`` seconds at the loader's staging step
``store-read-corrupt``   the chunk store treats the entry read as a
                         checksum failure: the entry is quarantined and
                         refilled by decoding again (consumed through
                         ``should_fire``, keyed by the chunk's cache key)
``mem-pressure``         inflate the bytes a memory-governor pool reports by
                         ``bytes=`` (default: one whole budget); ``match=``
                         picks pools by name. Read through the non-consuming
                         ``selected`` every sampler tick, so the pressure
                         holds and the ladder parks on one rung
``server-kill``          SIGKILL the data-service server process at a chunk
                         boundary of its serve loop (``DataServer``)
``server-slow``          sleep ``delay`` seconds before each chunk a server
                         sends
``rpc-blackhole``        the server's rpc thread swallows a request without
                         a reply (and re-binds its REP socket)
``wire-segment-leak``    the wire's teardown leaves its shm segments behind
                         (a SIGKILLed server without the SIGKILL), for the
                         next server's start-up sweep to collect
``partition-lost``       a lookup server swallows a request for one
                         partition (keyed ``p<partition>``, so every
                         replica drops it alike): the client must raise,
                         never return a short result
``hb-flap``              a lookup server suppresses one lease heartbeat
``fleet-worker-kill``    a fleet worker (``tools.fleet --worker``) SIGKILLs
                         itself right after its announce line; with
                         ``token=`` exactly one spawn
``registry-blackhole``   the fleet registry drops a heartbeat at ingest
``scale-race``           the autoscaler sleeps ``delay`` seconds between
                         deciding and acting
======================== ==================================================

The other names of :data:`KNOWN_SITES` parse and never fire here:
``arena-stale-view`` and ``lock-order-invert`` belong to the runtime
sanitizer, which is not ported yet.

Params (all optional):

* ``p`` — selection probability in ``[0, 1]`` (default 1.0). With a key
  (``rowgroup_fault_key`` gives ``"<file basename>:<row_group>"``),
  selection is a pure md5 hash of ``(seed, site, key)``: the same keys fire
  in every process, epoch and order, and in both packages. Without a key it
  draws from a per-process ``random.Random`` stream of ``(seed, site)``.
* ``seed`` — selection seed (default 0).
* ``max`` — at most N fires per process (default unlimited).
* ``delay`` — sleep seconds of the delay sites (default 0.05).
* ``token`` — a file path: the site fires at most once across processes
  (the first to create the file with ``O_CREAT|O_EXCL``).
* ``match`` — a substring the key must contain.
* ``bytes`` — the ``mem-pressure`` inflation (``k``/``m``/``g`` suffixes).

Every fire logs a warning and records a ``fault:<site>`` instant on the
global tracer (:func:`petastorm_tpu_torch.trace.get_global_tracer`).
"""

import hashlib
import logging
import os
import random
import threading
import time

logger = logging.getLogger(__name__)

ENV_VAR = 'PSTT_FAULTS'

#: The JAX package's whole site list: :meth:`FaultSpec.parse` rejects any
#: other name, so a mistyped spec fails the run that wrote it instead of
#: injecting nothing.
KNOWN_SITES = (
    'fs-read-error',
    'fs-read-delay',
    'decode-corrupt',
    'decode-corrupt-batch',
    'worker-kill',
    'queue-stall',
    'device-put-delay',
    'store-read-corrupt',
    'arena-stale-view',
    'lock-order-invert',
    'server-kill',
    'server-slow',
    'rpc-blackhole',
    'mem-pressure',
    'partition-lost',
    'hb-flap',
    'fleet-worker-kill',
    'registry-blackhole',
    'scale-race',
    'wire-segment-leak',
)

#: Sites whose effect is a sleep rather than an error.
_DELAY_SITES = ('fs-read-delay', 'queue-stall', 'device-put-delay',
                'server-slow', 'scale-race')

_DEFAULT_DELAY_S = 0.05


class FaultSpec(object):
    """Parsed configuration of one injection site."""

    def __init__(self, site, p=1.0, seed=0, max_fires=None, delay_s=_DEFAULT_DELAY_S,
                 token=None, match=None, inflate_bytes=None):
        self.site = site
        self.p = float(p)
        self.seed = int(seed)
        self.max_fires = max_fires if max_fires is None else int(max_fires)
        self.delay_s = float(delay_s)
        self.token = token
        #: Substring filter on the injection key: only keys containing it
        #: are eligible (``mem-pressure`` targets one governor pool by
        #: name this way; the hash-based ``p`` selection composes on top).
        self.match = match
        #: Byte inflation for ``mem-pressure`` (``bytes=`` in a spec);
        #: None = the consumer's default (one whole budget). Accepts the
        #: same ``k``/``m``/``g`` suffixes as the budget env var — an
        #: operator who just wrote PSTT_HOST_MEM_BUDGET=2g will write
        #: bytes=512m, and the two surfaces must agree.
        if inflate_bytes is None:
            self.inflate_bytes = None
        elif isinstance(inflate_bytes, str):
            from petastorm_tpu_torch.membudget import parse_bytes
            self.inflate_bytes = parse_bytes(inflate_bytes)
        else:
            self.inflate_bytes = int(inflate_bytes)

    @classmethod
    def parse(cls, text):
        """``"site:k=v:k=v"`` -> FaultSpec."""
        parts = [p.strip() for p in text.strip().split(':') if p.strip()]
        if not parts:
            raise ValueError('empty fault spec')
        site, kwargs = parts[0], {}
        if site not in KNOWN_SITES:
            raise ValueError(
                'unknown fault site {!r} (known: {}) — a typo here would '
                'otherwise inject nothing, silently'.format(
                    site, ', '.join(KNOWN_SITES)))
        renames = {'p': 'p', 'seed': 'seed', 'max': 'max_fires',
                   'delay': 'delay_s', 'token': 'token', 'match': 'match',
                   'bytes': 'inflate_bytes'}
        for param in parts[1:]:
            key, sep, value = param.partition('=')
            if not sep or key not in renames:
                raise ValueError(
                    'bad fault param {!r} in {!r} (expected one of {})'.format(
                        param, text, sorted(renames)))
            kwargs[renames[key]] = value
        return cls(site, **kwargs)

    def __repr__(self):
        return ('FaultSpec({s.site!r}, p={s.p}, seed={s.seed}, '
                'max_fires={s.max_fires}, delay_s={s.delay_s}, '
                'token={s.token!r}, match={s.match!r}, '
                'inflate_bytes={s.inflate_bytes})'.format(s=self))

    def key_matches(self, key):
        """The ``match=`` substring filter (True when unset)."""
        if self.match is None:
            return True
        return key is not None and self.match in str(key)


def _key_selected(seed, site, key, p):
    """Deterministic (process-independent) selection: hash fraction < p."""
    digest = hashlib.md5('{}:{}:{}'.format(seed, site, key).encode()).digest()
    fraction = int.from_bytes(digest[:8], 'little') / float(1 << 64)
    return fraction < p


class FaultInjector(object):
    """Holds the parsed specs plus per-process fire counters/streams."""

    def __init__(self, specs):
        self._specs = {s.site: s for s in specs}
        self._fired = {}
        self._streams = {}
        # Injection sites run concurrently on ThreadPool worker threads;
        # the max-fires budget and the per-site RNG stream are
        # check-then-mutate state that must not race or the promised
        # deterministic fire counts drift.
        self._lock = threading.Lock()

    @classmethod
    def from_string(cls, text):
        if not text or not text.strip():
            return cls([])
        return cls([FaultSpec.parse(part)
                    for part in text.split(';') if part.strip()])

    @property
    def active_sites(self):
        return sorted(self._specs)

    def spec(self, site):
        return self._specs.get(site)

    def selected(self, site, key):
        """Non-consuming deterministic predicate: would ``key`` be selected
        at ``site``? (Tests use this to compute expected fault sets; ignores
        ``max``/``token`` budgets.)"""
        spec = self._specs.get(site)
        if spec is None:
            return False
        if not spec.key_matches(key):
            return False
        return _key_selected(spec.seed, site, key, spec.p)

    def _claim_token(self, spec):
        try:
            fd = os.open(spec.token, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        except OSError as e:  # unwritable token dir: fail open (no injection)
            logger.warning('fault token %r not claimable: %s', spec.token, e)
            return False
        with os.fdopen(fd, 'w') as f:
            f.write('pid={}\n'.format(os.getpid()))
        return True

    def should_fire(self, site, key=None):
        """Decide-and-consume: True when ``site`` fires for this call."""
        spec = self._specs.get(site)
        if spec is None:
            return False
        if not spec.key_matches(key):
            return False
        with self._lock:
            if spec.max_fires is not None \
                    and self._fired.get(site, 0) >= spec.max_fires:
                return False
            if key is not None:
                if not _key_selected(spec.seed, site, key, spec.p):
                    return False
            elif spec.p < 1.0:
                stream = self._streams.get(site)
                if stream is None:
                    stream = self._streams[site] = random.Random(
                        '{}:{}'.format(spec.seed, site))
                if stream.random() >= spec.p:
                    return False
            if spec.token is not None and not self._claim_token(spec):
                return False
            self._fired[site] = self._fired.get(site, 0) + 1
            return True

    def inject(self, site, key=None):
        """Fire ``site``'s effect if selected; no-op otherwise."""
        if not self._specs:
            return
        if not self.should_fire(site, key):
            return
        from petastorm_tpu_torch.trace import get_global_tracer
        get_global_tracer().instant('fault:{}'.format(site), cat='fault')
        spec = self._specs[site]
        if site in _DELAY_SITES:
            logger.warning('fault injection: %s key=%r sleeping %.3fs',
                           site, key, spec.delay_s)
            time.sleep(spec.delay_s)
            return
        if site in ('worker-kill', 'server-kill', 'fleet-worker-kill'):
            logger.warning('fault injection: %s SIGKILLing pid %d',
                           site, os.getpid())
            import signal
            os.kill(os.getpid(), signal.SIGKILL)
            return  # pragma: no cover - unreachable
        logger.warning('fault injection: %s key=%r raising', site, key)
        if site == 'decode-corrupt':
            from petastorm_tpu_torch.errors import DecodeFieldError
            raise DecodeFieldError(
                'injected fault: decode-corrupt (key={!r})'.format(key))
        raise IOError('injected fault: {} (key={!r})'.format(site, key))


_cached = (None, None)  # (env string, FaultInjector)
_cached_lock = threading.Lock()


def get_injector():
    """The process-wide injector, re-parsed whenever the env var changes
    (tests flip ``PSTT_FAULTS`` between readers in one process).

    Lock-free on the steady-state path: tuple rebinding is atomic, so the
    common no-faults case is one env read + string compare + tuple read —
    ``maybe_inject`` sits on per-result hot paths and must not serialize
    decode threads on a global lock."""
    global _cached
    text = os.environ.get(ENV_VAR, '')
    cached = _cached
    if cached[0] == text:
        return cached[1]
    with _cached_lock:
        if _cached[0] != text:
            _cached = (text, FaultInjector.from_string(text))
        return _cached[1]


def maybe_inject(site, key=None):
    """The one-liner injection sites call. Near-zero cost when inactive
    (one env read + string compare)."""
    get_injector().inject(site, key)


def faults_active():
    return bool(get_injector().active_sites)


def rowgroup_fault_key(piece_path, row_group):
    """Selection key for row-group-targeted sites.

    Keyed by file *basename* + row-group index, not the absolute path: the
    same logical dataset then draws the same fault set wherever it is
    mounted (and tests computing expected sets stay deterministic across
    tmp directories)."""
    return '{}:{}'.format(os.path.basename(str(piece_path)), row_group)
