"""The control plane shared by the data service: leases, admission, drain
and typed refusals (counterpart of ``petastorm_tpu/fleet/control_plane.py``).

* **Heartbeat wire**: both dialects, the data plane's binary ``PST_HB`` +
  :data:`HB_STRUCT` frame and the JSON ``PST_LHB`` one, with one
  :func:`parse_heartbeat` for either. The binary frame carries an optional
  **announce tail** (job id and capacity, JSON after a ``\\n`` behind the
  rpc endpoint); consumers that predate the tail parse around it.
* :func:`mac` / :func:`mac_ok`: keyed BLAKE2b over length-framed parts.
* :class:`AdmissionLedger`: consumer id -> entry with a 3-lease expiry.
* :class:`DrainState`: serving -> draining -> drained.
* **Typed refusals**: the ``{'refused': ..., 'reason': ...}`` replies
  clients fail over on.
* **Session transport**: the negotiated wire tier (``fleet/wire.py``) is a
  property of the consumer session, kept on its admission entry and read
  through :func:`session_transport` / :func:`session_transports_locked`.
* :class:`PipelineSupervisor`: the one in :mod:`petastorm_tpu_torch.health`,
  exposed here under the JAX package's name, not copied.

The bytes on the wire are the JAX package's, so a server of one package
and a consumer of the other understand each other. The module is stdlib
only: it never imports zmq, torch or pyarrow.
"""

import hashlib
import hmac as hmac_mod
import json
import logging
import os
import struct
import threading

logger = logging.getLogger(__name__)

# -- lease configuration ----------------------------------------------------

#: Server lease duration (seconds): heartbeats go out every third of it,
#: consumers declare a server dead one full lease after its last
#: heartbeat, admission entries expire after EXPIRY_LEASES of silence.
ENV_LEASE = 'PSTT_LEASE_S'
DEFAULT_LEASE_S = 10.0
#: Fleet job this worker serves (announced in every heartbeat); the
#: registry groups members per job. Unset = not a fleet member.
ENV_JOB = 'PSTT_FLEET_JOB'
#: Admission entries (and registry members) expire after this many
#: leases without a renew/heartbeat — one missed beat is congestion,
#: three is a corpse.
EXPIRY_LEASES = 3


def env_float(var, default):
    raw = os.environ.get(var, '').strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        logger.warning('ignoring non-numeric %s=%r', var, raw)
        return default


def resolve_lease_s(lease_s=None):
    """Explicit value > ``PSTT_LEASE_S`` > default."""
    if lease_s is not None:
        return float(lease_s)
    return env_float(ENV_LEASE, DEFAULT_LEASE_S)


def resolve_job_id(job_id=None):
    """Explicit value > ``PSTT_FLEET_JOB`` > None."""
    if job_id is not None:
        return str(job_id)
    raw = os.environ.get(ENV_JOB, '').strip()
    return raw or None


def heartbeat_interval(lease_s):
    """Beats per lease: three, floored so a microscopic test lease
    cannot spin the control thread."""
    return max(float(lease_s) / 3.0, 0.05)


# -- heartbeat wire ---------------------------------------------------------

#: Binary dialect (data plane): ``PST_HB`` + HB_STRUCT + rpc endpoint
#: utf-8 [+ ``\n`` + announce JSON] [+ 16-byte mac over the whole msg].
CTRL_HB = b'PST_HB'
HB_STRUCT = struct.Struct('<16sdB')     # (server_id, lease_s, state code)
#: JSON dialect (lookup tier): ``PST_LHB`` + one JSON object.
CTRL_HB_JSON = b'PST_LHB'
STATE_CODES = {'serving': 0, 'draining': 1, 'drained': 2,
               'awaiting-cursor': 3}
STATE_NAMES = {v: k for k, v in STATE_CODES.items()}
#: Separates the rpc endpoint from the announce JSON in the binary
#: tail. Endpoints are single-line by construction, so the split is
#: unambiguous and tail-less messages stay parseable by old consumers.
ANNOUNCE_SEP = b'\n'
MAC_LEN = 16
_LEN_STRUCT = struct.Struct('<Q')


def mac(key, *parts):
    """Keyed BLAKE2b over length-framed parts (frame lengths are MACed
    so bytes cannot migrate across frame boundaries unnoticed)."""
    h = hashlib.blake2b(digest_size=MAC_LEN, key=key)
    for p in parts:
        h.update(_LEN_STRUCT.pack(len(p)))
        h.update(p)
    return h.digest()


def mac_ok(key, tag, *parts):
    return hmac_mod.compare_digest(bytes(tag), mac(key, *parts))


def pack_heartbeat(server_id, lease_s, state, rpc_endpoint,
                   announce=None, auth_key=None):
    """Build one binary-dialect heartbeat message (``PST_HB`` wire).

    ``announce`` (a JSON-safe dict — job id, capacity, ...) rides the
    tail after :data:`ANNOUNCE_SEP`; the mac, when armed, covers the
    announce too."""
    tail = (rpc_endpoint or '').encode('utf-8')
    if announce:
        tail += ANNOUNCE_SEP + json.dumps(
            announce, sort_keys=True).encode('utf-8')
    msg = (CTRL_HB
           + HB_STRUCT.pack(server_id, float(lease_s),
                            STATE_CODES.get(state, 0))
           + tail)
    if auth_key is not None:
        msg += mac(auth_key, msg)
    return msg


def split_hb_tail(tail):
    """``(rpc_endpoint, announce_dict_or_None)`` from the bytes after
    :data:`HB_STRUCT` in a binary heartbeat. Tolerant: a mangled
    announce degrades to None, never breaks lease tracking."""
    raw_ep, sep, raw_announce = tail.partition(ANNOUNCE_SEP)
    rpc_ep = raw_ep.decode('utf-8', 'replace') or None
    announce = None
    if sep:
        try:
            announce = json.loads(raw_announce.decode('utf-8'))
        except (ValueError, UnicodeDecodeError):
            announce = None
    return rpc_ep, announce


def parse_heartbeat(msg, auth_key=None):
    """Parse a full heartbeat message of EITHER dialect into one shape:
    ``{'server_id': hex str, 'lease_s': float, 'state': str,
    'rpc': str|None, 'name': str|None, 'announce': dict|None}``.
    Returns None for non-heartbeat or unverifiable messages — the
    registry feeds raw PUB traffic through here."""
    if msg.startswith(CTRL_HB_JSON):
        try:
            hb = json.loads(msg[len(CTRL_HB_JSON):].decode('utf-8'))
        except (ValueError, UnicodeDecodeError):
            return None
        announce = {k: hb[k] for k in ('job', 'capacity') if k in hb}
        return {'server_id': hb.get('server_id'),
                'lease_s': float(hb.get('lease_s') or DEFAULT_LEASE_S),
                'state': hb.get('state') or 'serving',
                'rpc': hb.get('rpc'),
                'name': hb.get('name'),
                'announce': announce or None}
    if msg.startswith(CTRL_HB):
        body = msg[len(CTRL_HB):]
        if auth_key is not None:
            if len(body) < HB_STRUCT.size + MAC_LEN:
                return None
            tag = msg[-MAC_LEN:]
            if not mac_ok(auth_key, tag, msg[:-MAC_LEN]):
                return None
            body = body[:-MAC_LEN]
        if len(body) < HB_STRUCT.size:
            return None
        sid, lease_s, code = HB_STRUCT.unpack_from(body)
        rpc_ep, announce = split_hb_tail(body[HB_STRUCT.size:])
        name = (announce or {}).get('name')
        return {'server_id': sid.hex(), 'lease_s': lease_s,
                'state': STATE_NAMES.get(code, 'serving'),
                'rpc': rpc_ep, 'name': name, 'announce': announce}
    return None


# -- typed refusals ---------------------------------------------------------

REFUSED_DRAINING = 'draining'
REFUSED_DRAINED = 'drained'
REFUSED_OVERLOADED = 'overloaded'
REASON_MEMORY_PRESSURE = 'memory-pressure'
#: Tenancy: the refusing server is fine, THIS tenant is over its quota.
#: Spelled as refused='overloaded' + this reason so every existing
#: client fails over / backs off without learning a new refusal kind.
REASON_TENANT_OVER_BUDGET = 'tenant-over-budget'


def refusal(server_id, refused, state, reason=None, **extra):
    """The one spelling of a typed admission refusal. ``refused`` is
    what clients branch on (draining/drained/overloaded); ``reason``
    names the pressure for operators and metrics labels."""
    reply = {'server_id': server_id, 'refused': refused, 'state': state}
    if reason is not None:
        reply['reason'] = reason
    reply.update(extra)
    return reply


# -- admission ledger -------------------------------------------------------

class AdmissionLedger(object):
    """Consumer admission bookkeeping shared by both service planes.

    Entries are dicts (``{'renewed': monotonic, ...owner fields}``) so
    the data plane can hang credits/tenant on them while the lookup
    tier stores nothing extra. The lock is PUBLIC: owners take it for
    compound admission decisions (admit + credit math must be atomic),
    and every ``*_locked`` method documents that contract.
    """

    def __init__(self, lease_s, expiry_leases=EXPIRY_LEASES):
        self.lock = threading.Lock()
        self.lease_s = float(lease_s)
        self.expiry_leases = expiry_leases
        self._entries = {}

    # All *_locked methods require self.lock held by the caller.

    def known_locked(self, cid):
        return cid in self._entries

    def get_locked(self, cid):
        return self._entries.get(cid)

    def admit_locked(self, cid, now, **fields):
        entry = dict(fields)
        entry['renewed'] = now
        self._entries[cid] = entry
        return entry

    def renew_locked(self, cid, now):
        entry = self._entries.get(cid)
        if entry is not None:
            entry['renewed'] = now
        return entry

    def release_locked(self, cid):
        return self._entries.pop(cid, None)

    def prune_locked(self, now):
        """Expire entries silent for ``expiry_leases`` leases; returns
        ``[(cid, entry), ...]`` so the owner can refund credits /
        release tenant slots / log with its own identity."""
        expiry = self.expiry_leases * self.lease_s
        dead = [cid for cid, e in self._entries.items()
                if now - e['renewed'] > expiry]
        return [(cid, self._entries.pop(cid)) for cid in dead]

    def count_locked(self):
        return len(self._entries)

    def entries_locked(self):
        return self._entries

    def count(self):
        with self.lock:
            return len(self._entries)

    def snapshot(self):
        with self.lock:
            return {cid: dict(e) for cid, e in self._entries.items()}


#: Legacy/default wire tier: sessions that never negotiated (an old
#: client, a plane without a data wire) are pickle sessions. Spelled
#: here — not imported from ``fleet.wire`` — because that module needs
#: numpy and this one must not.
DEFAULT_TRANSPORT = 'pickle'


def session_transport(entry):
    """The negotiated data-plane tier recorded on an admission entry
    (``'wire'`` field); :data:`DEFAULT_TRANSPORT` for legacy sessions."""
    return (entry or {}).get('wire') or DEFAULT_TRANSPORT


def session_transports_locked(ledger):
    """Granted tier per admitted consumer — the input to the send
    loop's best-common-tier pick and to the per-session stats surfaces.
    Caller holds ``ledger.lock``."""
    return {cid: session_transport(e)
            for cid, e in ledger.entries_locked().items()}


# -- drain state machine ----------------------------------------------------

class DrainState(object):
    """serving -> draining -> drained, one direction only.

    The two events are exposed so an owner's hot loops can poll
    ``draining.is_set()`` directly (the serve loop checks it between
    chunks thousands of times a second — no reason to pay a method
    call); the transitions and the state-name spelling live here.
    """

    def __init__(self):
        self.draining = threading.Event()
        self.drained = threading.Event()

    def request(self):
        """Enter draining; True only for the first caller (idempotent
        drains must run their reassign/handoff side effects once)."""
        first = not self.draining.is_set()
        self.draining.set()
        return first

    def mark_drained(self):
        self.draining.set()
        self.drained.set()

    @property
    def is_draining(self):
        return self.draining.is_set()

    @property
    def is_drained(self):
        return self.drained.is_set()

    def state(self, serving='serving'):
        """Current state name; ``serving`` lets the data plane report
        'awaiting-cursor' while its deferred reader is unbuilt."""
        if self.drained.is_set():
            return 'drained'
        if self.draining.is_set():
            return 'draining'
        return serving


def __getattr__(name):
    # The supervisor lives in health.py; resolved on first use so importing
    # the control plane stays stdlib only.
    if name == 'PipelineSupervisor':
        from petastorm_tpu_torch.health import PipelineSupervisor
        return PipelineSupervisor
    raise AttributeError('module {!r} has no attribute {!r}'.format(__name__, name))
