"""The negotiated data-plane wire of the data service (counterpart of
``petastorm_tpu/fleet/wire.py``; the bytes on the wire are the JAX
package's, so either package's consumer decodes either package's server).

The transport of a chunk is a property of the consumer session (its
admission-ledger entry, :mod:`~petastorm_tpu_torch.fleet.control_plane`): at
``attach`` the client advertises what it can decode
(:func:`client_capabilities`: same-host fingerprint, shm, Arrow IPC) and the
server grants a tier (:func:`negotiate`):

``shm``
    A co-located sole consumer. Column blocks are placed into a
    per-consumer POSIX shm segment ring (``/dev/shm/pstt-wire-*``,
    :class:`ShmSegmentRing`); zmq carries only a JSON descriptor (segment,
    per-field dtype, shape, offset and checksum, the lineage sidecar). The
    consumer maps read-only views over the segment (:class:`WireClient`),
    which the loader copies into its arenas; freed regions go back over a
    batched ``wire_ack`` rpc driven by the views' garbage collection
    (:class:`_Region` finalizers). The byte ring of ``native/shm_ring.py``
    pops a copy of each message, which is the copy this tier removes, so
    the wire ring grants regions instead; it shares that module's directory
    (:func:`~petastorm_tpu_torch.native.shm_ring.shm_dir`) and its
    boot-id + pid liveness discipline.

``arrow-ipc``
    Remote (or several) consumers get one Arrow IPC stream a chunk.
    Fixed-width columns ride as ``FixedSizeBinary`` with dtype and shape in
    the field metadata, so decode is ``np.frombuffer`` over the IPC buffer.

``pickle``
    Pickle protocol 5 with out-of-band buffers, byte-identical to the
    pre-wire format, for consumers that never negotiate.

The server's PUSH socket fair-queues chunks and cannot address one
consumer, so each chunk rides the best tier every admitted consumer decodes
(:func:`common_transport`), and every non-pickle chunk carries a one-byte
tag in its meta frame. A chunk that cannot ride its tier (a full ring, an
object column on Arrow) falls back a tier and is counted in
``pst_wire_bytes_total{transport}``.

A SIGKILLed server cannot unlink its segments, so each segment starts with
a liveness header (magic, boot id, owner pid) and
:func:`sweep_stale_segments`, run at server start, unlinks those whose boot
id is stale or whose owner is dead. The port's segments are named
``pstt-wire-*``, so its sweep and the JAX package's never meet. The
``wire-segment-leak`` fault site makes teardown skip the unlink.

Environment: ``PSTT_WIRE`` forces a tier (``shm`` / ``arrow-ipc`` /
``pickle``; ``auto`` negotiates) and ``PSTT_WIRE_SEGMENT_MB`` sizes the
per-consumer ring (default 64). No zmq, no torch here: socket I/O stays in
``data_service.py``.
"""

import json
import logging
import mmap
import os
import struct
import threading
import time
import weakref
from collections import OrderedDict

import numpy as np

from petastorm_tpu_torch.native import shm_ring

logger = logging.getLogger(__name__)

ENV_WIRE = 'PSTT_WIRE'
ENV_WIRE_SEGMENT_MB = 'PSTT_WIRE_SEGMENT_MB'
DEFAULT_SEGMENT_MB = 64

TRANSPORT_SHM = 'shm'
TRANSPORT_ARROW = 'arrow-ipc'
TRANSPORT_PICKLE = 'pickle'
#: Preference order, best first. ``common_transport`` picks the first
#: tier every admitted consumer can decode.
TIER_ORDER = (TRANSPORT_SHM, TRANSPORT_ARROW, TRANSPORT_PICKLE)

#: One-byte transport tags appended to the chunk meta frame. Legacy
#: pickle chunks stay UNTAGGED (byte-identical to the pre-wire format)
#: so consumers that predate negotiation keep decoding them.
TAG_ARROW = b'A'
TAG_SHM = b'S'

SEGMENT_PREFIX = 'pstt-wire-'
#: The JAX package's segment prefix: a port consumer maps a JAX server's
#: segments too (read only; the sweep still touches only its own).
JAX_SEGMENT_PREFIX = 'pst-wire-'
#: Segment liveness header: magic, boot id (36 ascii bytes), owner pid,
#: ring capacity. The data area starts at HEADER_SIZE (one page), so
#: region offsets are page-aligned-friendly and the header can be
#: rewritten without touching payload bytes.
_SEG_MAGIC = b'PSTWIRE1'
_SEG_HDR = struct.Struct('<8s36sQQ')
HEADER_SIZE = 4096

_BOOT_ID_PATH = '/proc/sys/kernel/random/boot_id'

_U64_MASK = 0xFFFFFFFFFFFFFFFF
#: Bytes checksummed at each end of a large field. Stripes suffice
#: because ring overwrites are prefix-contiguous: a recycling chunk
#: writes its fields from the region's start, so any overwrite that
#: reaches byte B of a field has already clobbered every region byte
#: before B — including that field's head stripe. Full-field coverage
#: would double the DRAM passes on BOTH ends (the server rereads what
#: it just copied, the consumer rereads what it's about to use) and at
#: MB-scale chunks that second pass costs as much as the copy itself.
_CSUM_STRIPE = 64 << 10


def _lane_sum(buf):
    lanes = len(buf) // 8
    total = 0
    if lanes:
        total = int(np.frombuffer(buf[:lanes * 8], dtype='<u8')
                    .sum(dtype=np.uint64))
    for b in buf[lanes * 8:]:
        total += b
    return total & _U64_MASK


def _checksum(view):
    """Recycle-tripwire checksum of a placed field: uint64 lane sum (+
    trailing bytes), mod 2^64, over the whole field when small and over
    a head+tail stripe (see ``_CSUM_STRIPE``) when large. It guards
    against a ring region being recycled while a consumer view is still
    alive — a bug tripwire, not adversarial integrity: the descriptor
    frame rides the MAC'd chunk meta for authenticity."""
    buf = memoryview(view).cast('B')
    if len(buf) <= 2 * _CSUM_STRIPE:
        return _lane_sum(buf)
    head = _lane_sum(buf[:_CSUM_STRIPE])
    tail = _lane_sum(buf[-_CSUM_STRIPE:])
    # Rotate the head so head/tail swaps don't cancel.
    return (((head << 1) | (head >> 63)) + tail) & _U64_MASK


def _read_boot_id():
    try:
        with open(_BOOT_ID_PATH, 'r') as f:
            return f.read().strip()[:36]
    except OSError:
        # Non-Linux fallback: same-host detection degrades to hostname
        # (weaker — containers sharing a hostname without a shared
        # /dev/shm would mis-detect, but those lack the boot_id file
        # only on exotic setups).
        import socket
        return 'host-' + socket.gethostname()[:31]


def host_fingerprint():
    """Same-host identity for shm eligibility: boot id + uid. Two
    processes with equal fingerprints share a kernel (boot id) and can
    open each other's shm files (same uid) — containers with a private
    /dev/shm get distinct mount namespaces but usually share the boot
    id, so the grant additionally requires the consumer to *open* the
    segment before any shm chunk is sent (attach-time map)."""
    uid = os.getuid() if hasattr(os, 'getuid') else 0
    return '{}:{}'.format(_read_boot_id(), uid)


def shm_available(base_dir=None):
    """POSIX shm usable: the segment directory exists and is writable."""
    d = base_dir or shm_ring.shm_dir()
    return d is not None and os.path.isdir(d) and os.access(d, os.W_OK)


def arrow_available():
    try:
        import pyarrow  # noqa: F401
        import pyarrow.ipc  # noqa: F401
        return True
    except Exception:  # noqa: BLE001 - any import failure = no arrow
        return False


def forced_transport(value=None):
    """Explicit value > ``PSTT_WIRE`` > None (= auto)."""
    raw = (value if value is not None
           else os.environ.get(ENV_WIRE, '')).strip().lower()
    if raw in ('', 'auto'):
        return None
    if raw in TIER_ORDER:
        return raw
    logger.warning('ignoring unknown %s=%r (want shm/arrow-ipc/pickle/auto)',
                   ENV_WIRE, raw)
    return None


def segment_capacity_bytes(value=None):
    mb = value
    if mb is None:
        raw = os.environ.get(ENV_WIRE_SEGMENT_MB, '').strip()
        try:
            mb = float(raw) if raw else DEFAULT_SEGMENT_MB
        except ValueError:
            logger.warning('ignoring non-numeric %s=%r',
                           ENV_WIRE_SEGMENT_MB, raw)
            mb = DEFAULT_SEGMENT_MB
    return max(1, int(mb * (1 << 20)))


def client_capabilities(force=None):
    """What this consumer can decode, advertised in the attach rpc.
    ``transports`` is the decodable set in preference order — a forced
    tier truncates it so the server cannot grant anything better."""
    forced = forced_transport(force)
    transports = [TRANSPORT_PICKLE]
    if arrow_available():
        transports.insert(0, TRANSPORT_ARROW)
    if shm_available():
        transports.insert(0, TRANSPORT_SHM)
    if forced is not None:
        transports = transports[transports.index(forced):] \
            if forced in transports else [TRANSPORT_PICKLE]
    # 'segments' names the segment prefixes this consumer maps. A JAX
    # consumer sends none and maps only its own package's segments, so a
    # port server grants it no shm (ServerWire.negotiate); a JAX server
    # ignores the key.
    return {'fingerprint': host_fingerprint(),
            'transports': transports,
            'segments': [SEGMENT_PREFIX, JAX_SEGMENT_PREFIX]}


def negotiate(server_fingerprint, caps, sole_consumer, allow_shm=True,
              allow_arrow=True, force=None):
    """Server-side tier grant for one consumer session.

    ``caps`` is the attach request's ``wire`` dict (None for a legacy
    consumer → pickle). shm requires: matching host fingerprint, the
    consumer advertising shm, the server allowing it (native shm
    usable, snapshots off, no memory degrade), and a **sole admitted
    consumer** — the segment ring is per-consumer while the data socket
    fair-queues, so two admitted consumers would race one ring.
    """
    if not caps or not isinstance(caps, dict):
        return TRANSPORT_PICKLE
    transports = list(caps.get('transports') or [TRANSPORT_PICKLE])
    forced = forced_transport(force)
    order = [t for t in TIER_ORDER
             if forced is None or TIER_ORDER.index(t) >= TIER_ORDER.index(forced)]
    for tier in order:
        if tier not in transports:
            continue
        if tier == TRANSPORT_SHM:
            if (allow_shm and sole_consumer and shm_available()
                    and caps.get('fingerprint') == server_fingerprint):
                return tier
            continue
        if tier == TRANSPORT_ARROW:
            if allow_arrow and arrow_available():
                return tier
            continue
        return TRANSPORT_PICKLE
    return TRANSPORT_PICKLE


def common_transport(session_tiers):
    """Best tier decodable by EVERY admitted consumer — what the
    fair-queued data socket actually ships. ``session_tiers`` is the
    granted tier per consumer session (the ``wire`` field on the
    admission-ledger entries). A granted tier implies every lower tier
    is decodable; shm additionally requires being the sole session."""
    tiers = list(session_tiers)
    if not tiers:
        return TRANSPORT_PICKLE
    worst = max(TIER_ORDER.index(t) if t in TIER_ORDER
                else TIER_ORDER.index(TRANSPORT_PICKLE) for t in tiers)
    tier = TIER_ORDER[worst]
    if tier == TRANSPORT_SHM and len(tiers) != 1:
        return TRANSPORT_ARROW if arrow_available() else TRANSPORT_PICKLE
    return tier


# -- metrics ----------------------------------------------------------------

_metrics_lock = threading.Lock()
_metrics = None


def wire_metrics():
    """Process-wide wire instruments (shared by servers and consumers)."""
    global _metrics
    with _metrics_lock:
        if _metrics is None:
            from petastorm_tpu_torch import metrics as metrics_mod
            _metrics = {
                'bytes': metrics_mod.counter(
                    'pst_wire_bytes_total',
                    'Chunk payload bytes shipped over the fleet wire, by '
                    'transport tier', labelnames=('transport',)),
                'serialize': metrics_mod.histogram(
                    'pst_wire_serialize_seconds',
                    'Per-chunk data-plane serialization time (pickle dumps '
                    '/ Arrow IPC encode; ~0 on the shm tier — its '
                    'descriptor is the only thing serialized)'),
                'segments': metrics_mod.gauge(
                    'pst_wire_segments_active',
                    'pst-wire-* shm segments currently created (server) or '
                    'mapped (consumer) in this process'),
            }
        return _metrics


# -- stale-segment sweep ----------------------------------------------------

def _pid_alive(pid):
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True     # someone else's live pid
    except OSError:
        return False
    return True


def read_segment_header(path):
    """``(boot_id, pid, capacity)`` from a segment file, or None when the
    file is not a wire segment (foreign file with our prefix: skip, never
    unlink what we did not create)."""
    try:
        with open(path, 'rb') as f:
            raw = f.read(_SEG_HDR.size)
    except OSError:
        return None
    if len(raw) < _SEG_HDR.size:
        return None
    magic, boot, pid, capacity = _SEG_HDR.unpack(raw)
    if magic != _SEG_MAGIC:
        return None
    return boot.decode('ascii', 'replace').rstrip('\0'), pid, capacity


def sweep_stale_segments(base_dir=None):
    """Unlink ``pstt-wire-*`` segments whose owner cannot unlink them
    anymore: a different boot id (host rebooted — every pid is stale) or
    a dead owner pid on this boot (SIGKILLed server). Run at server
    start, mirroring the chunk store's stale ``.tmp``/``.lock`` sweep.
    Returns the list of unlinked paths."""
    d = base_dir or shm_ring.shm_dir()
    if d is None or not os.path.isdir(d):
        return []
    boot_id = _read_boot_id()
    removed = []
    try:
        names = os.listdir(d)
    except OSError:
        return []
    for name in names:
        if not name.startswith(SEGMENT_PREFIX):
            continue
        path = os.path.join(d, name)
        hdr = read_segment_header(path)
        if hdr is None:
            continue
        seg_boot, pid, _capacity = hdr
        if seg_boot == boot_id and _pid_alive(pid):
            continue
        try:
            os.unlink(path)
            removed.append(path)
            logger.warning('swept stale wire segment %s (owner pid %d %s)',
                           path, pid,
                           'dead' if seg_boot == boot_id else 'pre-reboot')
        except OSError:
            pass
    return removed


# -- server-side segment ring ----------------------------------------------

class ShmSegmentRing(object):
    """Per-consumer region ring over one ``pstt-wire-*`` shm segment.

    The server places each chunk's column blocks at a contiguous offset
    run and ships a descriptor; the consumer aliases the bytes in place
    and acks the chunk seq once its views are garbage. ``free`` marks a
    region; the tail only advances over the *oldest contiguous* freed
    regions (ring order = seq order), so a consumer holding one old
    chunk pins at most the ring behind it — same discipline as the
    arena pools. Single-writer (the serve thread); ``free`` arrives from
    the rpc thread, so the bookkeeping is locked.
    """

    def __init__(self, name, capacity=None, base_dir=None):
        self.name = name
        self.capacity = segment_capacity_bytes() if capacity is None \
            else int(capacity)
        d = base_dir or shm_ring.shm_dir()
        if d is None:
            raise RuntimeError('no shm directory available for wire segments')
        self.path = os.path.join(d, name)
        fd = os.open(self.path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
        try:
            # Reserve the pages (a sparse segment would die of SIGBUS at the
            # first page past a full /dev/shm): no room raises ENOSPC here,
            # and the caller downgrades the session's tier.
            os.posix_fallocate(fd, 0, HEADER_SIZE + self.capacity)
            self._mm = mmap.mmap(fd, HEADER_SIZE + self.capacity)
        except BaseException:
            os.close(fd)
            os.unlink(self.path)
            raise
        os.close(fd)
        self._prefault()
        boot = _read_boot_id().encode('ascii', 'replace')[:36].ljust(36, b'\0')
        self._mm[:_SEG_HDR.size] = _SEG_HDR.pack(
            _SEG_MAGIC, boot, os.getpid(), self.capacity)
        self._lock = threading.Lock()
        self._regions = OrderedDict()   # key -> [off, size, freed]
        self._pad = 0
        self._head = 0
        self._used = 0
        self._closed = False
        wire_metrics()['segments'].inc()

    def _prefault(self):
        """Touch every page once at creation (attach time): a fresh shm
        page costs a minor fault + zero-fill on first write, which would
        otherwise land inside ``place()`` on the serve loop's critical
        path — measured ~10x the steady-state memcpy for a cold region.
        MADV_POPULATE_WRITE prefaults in one syscall where the kernel
        has it; the fallback writes a zero page per page, same effect."""
        madv = getattr(mmap, 'MADV_POPULATE_WRITE', None)
        if madv is not None:
            try:
                self._mm.madvise(madv)
                return
            except (OSError, ValueError):
                pass    # pre-5.14 kernel: fall through to the write loop
        step = 1 << 20
        zeros = bytes(step)
        total = HEADER_SIZE + self.capacity
        for off in range(0, total, step):
            end = min(off + step, total)
            self._mm[off:end] = zeros[:end - off]

    def _alloc_locked(self, size):
        """Contiguous offset for ``size`` bytes, or None when the live
        span leaves no room. Wrap inserts a pre-freed pad region so the
        tail accounting stays strictly ring-ordered."""
        if size > self.capacity:
            return None
        if self._used == 0:
            self._head = 0
        tail = self._tail_locked()
        if self._used and self._head <= tail:
            # Live span wraps: free run is [head, tail).
            if tail - self._head >= size:
                off = self._head
            else:
                return None
        else:
            # Free runs: [head, capacity) then [0, tail).
            if self.capacity - self._head >= size:
                off = self._head
            elif tail >= size and tail > 0:
                pad = self.capacity - self._head
                if pad:
                    self._pad += 1
                    self._regions['pad-{}'.format(self._pad)] = \
                        [self._head, pad, True]
                    self._used += pad
                off = 0
            else:
                return None
        self._head = (off + size) % self.capacity
        self._used += size
        return off

    def _tail_locked(self):
        for off, size, _freed in self._regions.values():
            return off
        return self._head

    def place(self, seq, blocks):
        """Copy ``{name: ndarray}`` blocks into one contiguous region;
        returns the descriptor field list (dtype/shape/offset/checksum
        per field) or None when the ring is too full — the caller waits for
        acks or downgrades the chunk's tier. Offsets are absolute into
        the segment (header included) so consumers slice the mapped file
        directly."""
        blocks = {name: np.ascontiguousarray(arr) for name, arr in blocks.items()}
        total = sum(arr.nbytes for arr in blocks.values())
        # The copy runs under the lock, so close() cannot unmap the segment
        # under a placement; free() from the rpc thread waits for it.
        with self._lock:
            if self._closed:
                return None
            off = self._alloc_locked(max(total, 1))
            if off is None:
                return None
            self._regions[seq] = [off, max(total, 1), False]
            fields = []
            cursor = HEADER_SIZE + off
            for name, arr in blocks.items():
                nbytes = arr.nbytes
                view = memoryview(self._mm)[cursor:cursor + nbytes]
                if nbytes:
                    # numpy's copy releases the GIL, which the server's
                    # decode threads share (a memoryview slice assignment
                    # holds it for the whole 38.5 MB of an imagenet chunk).
                    np.copyto(np.frombuffer(view, dtype=np.uint8),
                              arr.reshape(-1).view(np.uint8))
                fields.append({'name': name,
                               'dtype': arr.dtype.str,
                               'shape': list(arr.shape),
                               'offset': cursor,
                               'csum': _checksum(view)})
                view.release()
                cursor += nbytes
        return fields

    def free(self, seq):
        """Mark a region acked; advance the tail over the oldest
        contiguous freed run. Unknown seqs are ignored (acks can trail a
        segment teardown)."""
        with self._lock:
            region = self._regions.get(seq)
            if region is None:
                return
            region[2] = True
            while self._regions:
                key, (off, size, freed) = next(iter(self._regions.items()))
                if not freed:
                    break
                del self._regions[key]
                self._used -= size

    def free_all(self):
        with self._lock:
            self._regions.clear()
            self._used = 0
            self._head = 0

    @property
    def used_bytes(self):
        return self._used

    def close(self, unlink=True):
        """Tear down; ``unlink=False`` simulates the SIGKILL leak the
        ``wire-segment-leak`` fault site drives (the next server start's
        sweep must collect the orphan)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if unlink:
            try:
                os.unlink(self.path)
            except OSError:
                pass
        self._mm.close()
        wire_metrics()['segments'].inc(-1)


class ServerWire(object):
    """The DataServer's side of the negotiated wire: per-session grants,
    per-chunk encode at the fleet's common tier, ack bookkeeping, and
    the ``wire-shm`` memory-governor pool."""

    def __init__(self, server_id, allow_shm=True, force=None,
                 segment_bytes=None):
        self.fingerprint = host_fingerprint()
        self._server_hex = server_id.hex() if isinstance(server_id, bytes) \
            else str(server_id)
        self._force = force
        self._allow_shm = allow_shm
        self._segment_bytes = segment_bytes
        self._mem_degraded = False
        self._rings = {}            # consumer id -> ShmSegmentRing
        self._rings_made = 0        # numbers each session's segment name
        self._closed = False        # close() ran: no ring is made after it
        self._lock = threading.Lock()
        self._m = wire_metrics()
        from petastorm_tpu_torch import membudget
        self._mem_handle = membudget.register_pool(
            'wire-shm', self._shm_nbytes,
            degrade_fn=self._set_mem_degraded,
            degrade_release_fn=self._clear_mem_degraded)

    # -- negotiation -------------------------------------------------------

    def negotiate(self, consumer, caps, sole_consumer):
        """Grant a tier for one attach; creates/keeps the consumer's
        segment ring on an shm grant. Returns the reply ``wire`` dict."""
        allow_shm = (self._allow_shm and not self._mem_degraded
                     and SEGMENT_PREFIX in ((caps or {}).get('segments') or ()))
        tier = negotiate(self.fingerprint, caps, sole_consumer,
                         allow_shm=allow_shm, force=self._force)
        reply = {'transport': tier}
        if tier == TRANSPORT_SHM:
            with self._lock:
                ring = self._rings.get(consumer)
                if ring is None and not self._closed:
                    # The session number ends the name: a consumer whose
                    # admission expired keeps its old ring mapped (views,
                    # chunks in flight), and its map cache is by name.
                    self._rings_made += 1
                    name = '{}{}-{}-{}'.format(
                        SEGMENT_PREFIX, self._server_hex[:12],
                        str(consumer)[:24], self._rings_made)
                    try:
                        ring = ShmSegmentRing(
                            name, capacity=self._segment_bytes)
                    except OSError:
                        logger.warning('wire segment create failed; '
                                       'downgrading %s to arrow/pickle',
                                       consumer, exc_info=True)
                    else:
                        self._rings[consumer] = ring
            if ring is None:
                # No ring could be made, or the server is stopping (an
                # attach its rpc thread answers after close() would make
                # a ring nothing unlinks).
                reply['transport'] = (
                    TRANSPORT_ARROW
                    if arrow_available() and
                    TRANSPORT_ARROW in (caps or {}).get('transports', ())
                    else TRANSPORT_PICKLE)
                return reply
            reply['segment'] = ring.name
            reply['capacity'] = ring.capacity
        return reply

    def effective_transport(self, session_tiers):
        tier = common_transport(session_tiers)
        if tier == TRANSPORT_SHM and (self._mem_degraded or not self._rings):
            tier = TRANSPORT_ARROW if arrow_available() else TRANSPORT_PICKLE
        return tier

    # -- encode ------------------------------------------------------------

    def encode(self, seq, payload, transport, pickle_fn):
        """``(tag, frames)`` for chunk ``seq`` at ``transport``; falls
        back tier by tier when a chunk cannot ride the granted one
        (object columns on arrow, a ring with no room on shm until acks
        drain) — the per-chunk tag makes a mixed stream legal.
        ``pickle_fn`` is the legacy framing (kept in data_service so the
        fallback stays byte-identical to the pre-wire format)."""
        sidecar = payload.get('__pst_lineage__')
        if transport == TRANSPORT_SHM:
            result = self._encode_shm(seq, payload, sidecar)
            if result is not None:
                return result
            transport = TRANSPORT_ARROW
        if transport == TRANSPORT_ARROW:
            result = self._encode_arrow(payload, sidecar)
            if result is not None:
                return result
        t0 = time.perf_counter()
        frames = pickle_fn(payload)
        self._m['serialize'].observe(time.perf_counter() - t0)
        self._m['bytes'].labels(TRANSPORT_PICKLE).inc(
            sum(_frame_nbytes(f) for f in frames))
        return None, frames

    def _blocks(self, payload):
        blocks = {}
        for name, value in payload.items():
            if name == '__pst_lineage__':
                continue
            arr = np.asarray(value)
            if arr.dtype.hasobject:
                return None     # not raw-placeable: downgrade the chunk
            blocks[name] = arr
        return blocks

    def _sole_ring(self):
        with self._lock:
            if len(self._rings) != 1:
                return None, None
            return next(iter(self._rings.items()))

    def _encode_shm(self, seq, payload, sidecar):
        consumer, ring = self._sole_ring()
        if ring is None:
            return None
        blocks = self._blocks(payload)
        if blocks is None:
            return None
        fields = ring.place(seq, blocks)
        if fields is None:
            return None     # ring full: caller-side tier fallback
        desc = {'segment': ring.name, 'seq': seq, 'fields': fields}
        if sidecar is not None:
            desc['sidecar'] = sidecar
        # Serialization on this tier is the descriptor alone — the
        # block bytes were *placed*, not serialized (the memcpy rides
        # pst_wire_bytes_total, not serialize_seconds).
        t0 = time.perf_counter()
        frame = json.dumps(desc).encode('utf-8')
        self._m['serialize'].observe(time.perf_counter() - t0)
        self._m['bytes'].labels(TRANSPORT_SHM).inc(
            sum(int(np.prod(f['shape']) or 0)
                * np.dtype(f['dtype']).itemsize for f in fields))
        return TAG_SHM, [frame]

    def _encode_arrow(self, payload, sidecar):
        frame = encode_arrow(payload, sidecar, as_buffer=True)
        if frame is None:
            return None
        self._m['bytes'].labels(TRANSPORT_ARROW).inc(frame.size)
        return TAG_ARROW, [frame]

    # -- ack / lifecycle ---------------------------------------------------

    def ack(self, consumer, seqs):
        with self._lock:
            ring = self._rings.get(consumer)
        if ring is None:
            return
        for seq in seqs:
            ring.free(seq)

    def release_consumer(self, consumer, unlink=True):
        """A consumer detached / lease-expired: its ring (and every
        unacked region in it) goes away — future chunks renegotiate to
        the remaining consumers' common tier."""
        with self._lock:
            ring = self._rings.pop(consumer, None)
        if ring is not None:
            ring.close(unlink=unlink)

    def segments(self):
        with self._lock:
            return {c: r.name for c, r in self._rings.items()}

    def _shm_nbytes(self):
        with self._lock:
            return sum(r.used_bytes for r in self._rings.values())

    def _set_mem_degraded(self):
        self._mem_degraded = True

    def _clear_mem_degraded(self):
        self._mem_degraded = False

    def close(self):
        from petastorm_tpu_torch import faults
        leak = faults.get_injector().should_fire('wire-segment-leak')
        if leak:
            logger.warning('fault injection: wire-segment-leak leaving '
                           'segment(s) behind for the next sweep')
        with self._lock:
            rings, self._rings = dict(self._rings), {}
            self._closed = True
        for ring in rings.values():
            ring.close(unlink=not leak)
        self._mem_handle.close()


def _frame_nbytes(frame):
    """Payload size of one outgoing frame (bytes, PickleBuffer, zmq
    Frame, memoryview — whatever the framing hands us)."""
    for attr in ('nbytes',):
        n = getattr(frame, attr, None)
        if isinstance(n, int):
            return n
    try:
        return len(frame)
    except TypeError:
        try:
            return memoryview(frame).nbytes
        except TypeError:
            return 0


# -- arrow codec ------------------------------------------------------------

def encode_arrow(payload, sidecar=None, as_buffer=False):
    """One chunk as Arrow IPC stream bytes (schema + one record batch),
    or None when a column cannot ride (object dtypes that are not all
    bytes, zero-width fields) — the caller falls back a tier. Fixed-
    width columns are zero-copy on both sides: ``FixedSizeBinary`` over
    the array's own buffer out, ``np.frombuffer`` over the IPC buffer
    in. ``as_buffer=True`` returns the ``pyarrow.Buffer`` the stream was
    written into (the same bytes, not copied into a ``bytes`` object while
    holding the GIL), which zmq sends as it is."""
    if not arrow_available():
        return None
    import pyarrow as pa
    names, arrays, fields = [], [], []
    nrows = None
    for name, value in payload.items():
        if name == '__pst_lineage__':
            continue
        arr = np.asarray(value)
        if arr.ndim == 0:
            arr = arr.reshape(1)
        n = arr.shape[0]
        if nrows is None:
            nrows = n
        if n != nrows:
            return None     # ragged payload: not a columnar chunk
        if arr.dtype.hasobject:
            values = arr.tolist()
            if not all(isinstance(v, (bytes, bytearray)) for v in values):
                return None
            arrays.append(pa.array([bytes(v) for v in values], pa.binary()))
            fields.append(pa.field(name, pa.binary(),
                                   metadata={'pst_object': 'bytes'}))
            continue
        width = int(arr.dtype.itemsize * (np.prod(arr.shape[1:])
                                          if arr.ndim > 1 else 1))
        if width <= 0:
            return None
        flat = np.ascontiguousarray(arr)
        buf = pa.py_buffer(flat.reshape(-1).view(np.uint8).data
                           if flat.nbytes else b'')
        typ = pa.binary(width)
        arrays.append(pa.FixedSizeBinaryArray.from_buffers(
            typ, n, [None, buf]))
        fields.append(pa.field(name, typ, metadata={
            'pst_dtype': arr.dtype.str,
            'pst_shape': json.dumps(list(arr.shape[1:]))}))
    if nrows is None:
        return None
    meta = {}
    if sidecar is not None:
        try:
            meta['pst_sidecar'] = json.dumps(sidecar)
        except (TypeError, ValueError):
            return None     # non-JSON sidecar: legacy pickle carries it
    schema = pa.schema(fields, metadata=meta or None)
    batch = pa.record_batch(arrays, schema=schema)
    t0 = time.perf_counter()
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, schema) as writer:
        writer.write_batch(batch)
    out = sink.getvalue()
    if not as_buffer:
        out = out.to_pybytes()
    wire_metrics()['serialize'].observe(time.perf_counter() - t0)
    return out


def decode_arrow(frame):
    """Inverse of :func:`encode_arrow`: ``{name: ndarray}`` columns (+
    the ``__pst_lineage__`` sidecar when one rode the schema metadata).
    Fixed-width columns alias the IPC buffer (read-only views)."""
    import pyarrow as pa
    if not isinstance(frame, (bytes, bytearray, memoryview)):
        frame = frame.buffer if hasattr(frame, 'buffer') else bytes(frame)
    with pa.ipc.open_stream(pa.py_buffer(frame)) as reader:
        batch = reader.read_next_batch()
        schema = reader.schema
    cols = {}
    for i, field in enumerate(schema):
        col = batch.column(i)
        md = field.metadata or {}
        if b'pst_object' in md:
            cols[field.name] = np.array(
                [v.as_py() for v in col], dtype=object)
            continue
        dtype = np.dtype(md[b'pst_dtype'].decode())
        tail_shape = tuple(json.loads(md[b'pst_shape'].decode()))
        data = col.buffers()[1]
        width = col.type.byte_width
        base = np.frombuffer(data, dtype=np.uint8,
                             count=(col.offset + len(col)) * width)
        arr = base[col.offset * width:].view(dtype)
        cols[field.name] = arr.reshape((len(col),) + tail_shape)
    meta = schema.metadata or {}
    if b'pst_sidecar' in meta:
        cols['__pst_lineage__'] = json.loads(meta[b'pst_sidecar'].decode())
    return cols


# -- consumer side ----------------------------------------------------------

class _Region(object):
    """Liveness anchor of one mapped shm chunk: every view holds a
    strong reference; the finalizer (all views dead) queues the ack."""
    __slots__ = ('seq', 'segment', '__weakref__')

    def __init__(self, seq, segment):
        self.seq = seq
        self.segment = segment


class WireView(np.ndarray):
    """Read-only column view over a mapped wire segment. Slices (and
    anything ``__array_finalize__`` reaches) inherit the region anchor,
    so a batch sliced out of a chunk keeps the chunk's ring region
    alive until the batch is staged and dropped."""
    _pst_wire_region = None

    def __array_finalize__(self, obj):
        if obj is not None:
            self._pst_wire_region = getattr(obj, '_pst_wire_region', None)


class WireClient(object):
    """Consumer-side shm tier: maps segments read-only, builds
    :class:`WireView` columns from descriptors, verifies the per-field
    checksum, and collects acks from view finalizers for the owner's
    batched ``wire_ack`` rpc flush."""

    def __init__(self, base_dir=None):
        self._base_dir = base_dir or shm_ring.shm_dir()
        self._segments = {}      # name -> mmap
        self._retired = []       # maps of replaced rings that views still alias
        self._lock = threading.Lock()
        self._acks = {}          # segment name -> [seqs]
        self._m = wire_metrics()

    def map_segment(self, name):
        with self._lock:
            mm = self._segments.get(name)
            if mm is not None:
                return mm
        if (os.sep in name) or not name.startswith((SEGMENT_PREFIX, JAX_SEGMENT_PREFIX)):
            raise ValueError('refusing non-wire segment name '
                             '{!r}'.format(name))
        path = os.path.join(self._base_dir, name)
        fd = os.open(path, os.O_RDONLY)
        try:
            size = os.fstat(fd).st_size
            mm = mmap.mmap(fd, size, prot=mmap.PROT_READ)
        finally:
            os.close(fd)
        with self._lock:
            if name not in self._segments:
                self._segments[name] = mm
                self._m['segments'].inc()
            else:
                mm.close()
                mm = self._segments[name]
        return mm

    def can_map(self, name):
        try:
            self.map_segment(name)
            return True
        except (OSError, ValueError):
            return False

    def decode_chunk(self, descriptor):
        """Descriptor frame -> ``{name: WireView}`` columns + sidecar.
        Raises on a checksum mismatch — that is a ring-overwrite bug
        (an ack the server never got, or a corrupted descriptor), never
        something to feed the trainer."""
        desc = json.loads(bytes(descriptor).decode('utf-8'))
        mm = self.map_segment(desc['segment'])
        region = _Region(desc.get('seq'), desc['segment'])
        weakref.finalize(region, self._queue_ack,
                         desc['segment'], desc.get('seq'))
        cols = {}
        for f in desc['fields']:
            dtype = np.dtype(f['dtype'])
            shape = tuple(f['shape'])
            nbytes = int(dtype.itemsize * (np.prod(shape) if shape else 1))
            view = memoryview(mm)[f['offset']:f['offset'] + nbytes]
            if _checksum(view) != f['csum']:
                raise RuntimeError(
                    'wire chunk checksum mismatch on field {!r} (segment '
                    '{}, seq {}) — shm region overwritten before release'
                    .format(f['name'], desc['segment'], desc.get('seq')))
            arr = np.frombuffer(view, dtype=dtype)
            arr = arr.reshape(shape).view(WireView)
            arr._pst_wire_region = region
            cols[f['name']] = arr
        # pst_wire_bytes_total is counted where shipping happens (the
        # server's place/encode) — counting the decode too would double
        # every shm byte whenever both ends share a process/registry.
        if 'sidecar' in desc:
            cols['__pst_lineage__'] = desc['sidecar']
        return cols

    def _queue_ack(self, segment, seq):
        if seq is None:
            return
        with self._lock:
            self._acks.setdefault(segment, []).append(seq)

    def drain_acks(self):
        """``{segment: [seqs]}`` accumulated since the last drain — the
        owner flushes them as ``wire_ack`` rpcs (batched, like credit
        grants). Unmaps the replaced rings whose last view has gone."""
        with self._lock:
            acks, self._acks = self._acks, {}
            retired = bool(self._retired)
        if retired:
            self._close_retired()
        return acks

    def retire_segment(self, name):
        """The server granted this consumer a new ring in place of ``name``
        (a re-attach after its admission expired, when the server freed the
        old ring): unmap ``name`` now, or once the last view of it is gone,
        and drop its pending acks. The map cache then holds one ring a
        server."""
        with self._lock:
            mm = self._segments.pop(name, None)
            self._acks.pop(name, None)
            if mm is not None:
                self._retired.append(mm)
        if mm is not None:
            self._close_retired()

    def _close_retired(self):
        with self._lock:
            retired, self._retired = self._retired, []
        kept = []
        for mm in retired:
            try:
                mm.close()
            except BufferError:
                kept.append(mm)      # a view still aliases it: next drain
        with self._lock:
            self._retired.extend(kept)
        if len(retired) > len(kept):
            self._m['segments'].inc(-(len(retired) - len(kept)))

    def requeue_acks(self, segment, seqs):
        """A ``wire_ack`` rpc flush failed: put the seqs back for the
        next flush — a dropped ack must not permanently pin its ring
        regions on a healthy server. (Acks for a DEAD server's segment
        converge to garbage the owner stops routing; its ring died with
        it.)"""
        with self._lock:
            self._acks.setdefault(segment, []).extend(seqs)

    def close(self):
        with self._lock:
            segments, self._segments = dict(self._segments), {}
            retired, self._retired = self._retired, []
        for mm in list(segments.values()) + retired:
            try:
                mm.close()
            except (BufferError, OSError):
                # Live views still alias the map (a trainer holding the
                # final batch): the map stays until they go — the server
                # unlinks the file regardless.
                pass
        if segments or retired:
            self._m['segments'].inc(-(len(segments) + len(retired)))
