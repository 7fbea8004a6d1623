"""The port's negotiated wire (``petastorm_tpu_torch/fleet/wire.py``),
mirroring ``tests/test_wire.py`` and held against the JAX package's wire:

* ``negotiate`` and ``common_transport`` decide alike over a grid of
  capabilities, and ``client_capabilities`` advertises what the JAX
  package's does, plus the segment prefixes the port maps;
* ``encode_arrow`` of either package decodes in the other, arrays equal;
  the ring checksum is the JAX package's over random buffers;
* the shm ring allocates, wraps and verifies; views keep their region and
  ack it when they die; the sweep and the ``wire-segment-leak`` drill touch
  only ``pstt-wire-*`` segments;
* through the service: a shm epoch is bit-identical to a pickle one, a
  full ring falls back to Arrow and counts it, a mixed fleet (a port shm
  server beside a JAX pickle server) decodes both, a restarted server
  renegotiates, a port consumer of a JAX server is granted shm and maps
  its segment, and a JAX consumer of a port server is granted Arrow.

Every service endpoint is ``ipc://`` under the test's ``tmp_path``.
"""

import gc
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from petastorm_tpu import data_service as jds
from petastorm_tpu.fleet import wire as jwire
from petastorm_tpu_torch import data_service as ds
from petastorm_tpu_torch import metrics
from petastorm_tpu_torch.data_service import DataServer, RemoteReader
from petastorm_tpu_torch.fleet import wire
from petastorm_tpu_torch.native import shm_ring
from torch_service_helpers import CHUNK_ROWS, endpoints, ipc, ipc_dir, make_stream_reader

pytestmark = pytest.mark.wire

SHM, ARROW, PICKLE = wire.TRANSPORT_SHM, wire.TRANSPORT_ARROW, wire.TRANSPORT_PICKLE
needs_shm = pytest.mark.skipif(not wire.shm_available(), reason='no writable /dev/shm')


@pytest.fixture
def sock(tmp_path):
    path = ipc_dir(tmp_path)
    yield path
    if os.path.islink(path):
        os.unlink(path)


def _own_segments():
    """This process's ``pstt-wire-`` segments (by the owner pid in their
    header): other test processes make theirs beside them."""
    own = set()
    for name in shm_ring.list_segments(wire.SEGMENT_PREFIX):
        header = wire.read_segment_header(os.path.join(shm_ring.shm_dir(), name))
        if header is not None and header[1] == os.getpid():
            own.add(name)
    return own


@pytest.fixture(autouse=True)
def _no_segment_left():
    before = _own_segments()
    yield
    gc.collect()
    assert _own_segments() <= before


def _serve_attached(reader, bind, tier, **kw):
    """A started server whose serve loop waits for the first attach, so no
    chunk rides the empty fleet's tier (``tests/test_wire.py:70``)."""
    server = DataServer(reader, bind, wire=tier, **kw)
    server._pause.set()
    server.start()
    return server


def _release_on_attach(server, timeout_s=30):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        with server._admission_lock:
            if server._admission.count_locked() >= 1:
                break
        time.sleep(0.005)
    server._pause.clear()


def _drain(remote):
    return [(np.array(c.vec, copy=True), np.array(c.sid, copy=True)) for c in remote]


def _wire_bytes():
    fam = metrics.get_registry().collect().get('pst_wire_bytes_total') or {'samples': []}
    return {s['labels']['transport']: s['value'] for s in fam['samples']}


# -- negotiation ---------------------------------------------------------------

def _caps_grid(fp):
    tiers = ([SHM, ARROW, PICKLE], [ARROW, PICKLE], [PICKLE], [SHM, PICKLE], [SHM], [])
    for transports in tiers:
        for fingerprint in (fp, 'other-host:0'):
            yield {'fingerprint': fingerprint, 'transports': transports}
    yield None
    yield {}


@pytest.mark.parametrize('force', [None, 'auto', SHM, ARROW, PICKLE, 'bogus'])
@pytest.mark.parametrize('sole', [True, False])
def test_negotiate_equals_jax_over_a_grid(force, sole):
    fp = wire.host_fingerprint()
    assert fp == jwire.host_fingerprint()
    for caps in _caps_grid(fp):
        for allow_shm in (True, False):
            for allow_arrow in (True, False):
                ours = wire.negotiate(fp, caps, sole, allow_shm=allow_shm,
                                      allow_arrow=allow_arrow, force=force)
                assert ours == jwire.negotiate(fp, caps, sole, allow_shm=allow_shm,
                                               allow_arrow=allow_arrow, force=force), caps


def test_negotiate_matrix():
    fp = wire.host_fingerprint()
    full = {'fingerprint': fp, 'transports': [SHM, ARROW, PICKLE]}
    assert wire.negotiate(fp, None, True) == PICKLE
    assert wire.negotiate(fp, {}, True) == PICKLE
    assert wire.negotiate(fp, full, True) == (SHM if wire.shm_available() else ARROW)
    assert wire.negotiate(fp, full, False) == ARROW
    assert wire.negotiate(fp, dict(full, fingerprint='other-host-boot-uid'), True) == ARROW
    assert wire.negotiate(fp, full, True, allow_shm=False) == ARROW
    assert wire.negotiate(fp, {'fingerprint': fp, 'transports': [PICKLE]}, True) == PICKLE
    assert wire.negotiate(fp, full, True, force=ARROW) == ARROW
    assert wire.negotiate(fp, full, True, force=PICKLE) == PICKLE


def test_negotiate_same_host_without_shm_grants_arrow(monkeypatch):
    fp = wire.host_fingerprint()
    caps = {'fingerprint': fp, 'transports': [SHM, ARROW, PICKLE]}
    monkeypatch.setattr(wire, 'shm_available', lambda base_dir=None: False)
    assert wire.negotiate(fp, caps, True) == ARROW


@pytest.mark.parametrize('force', [None, SHM, ARROW, PICKLE])
def test_client_capabilities_equal_jax_plus_the_segment_prefixes(force):
    ours = wire.client_capabilities(force=force)
    theirs = jwire.client_capabilities(force=force)
    assert ours.pop('segments') == [wire.SEGMENT_PREFIX, jwire.SEGMENT_PREFIX]
    assert ours == theirs
    assert ours['transports'][-1] == PICKLE
    if force == PICKLE:
        assert ours['transports'] == [PICKLE]
    if force == ARROW:
        assert ours['transports'][0] == ARROW and SHM not in ours['transports']


def test_env_forces_a_tier_and_sizes_the_ring(monkeypatch):
    monkeypatch.setenv('PSTT_WIRE', 'arrow-ipc')
    assert wire.forced_transport() == ARROW
    monkeypatch.setenv('PSTT_WIRE', 'nonsense')
    assert wire.forced_transport() is None
    monkeypatch.setenv('PSTT_WIRE_SEGMENT_MB', '2')
    assert wire.segment_capacity_bytes() == 2 << 20
    monkeypatch.setenv('PSTT_WIRE_SEGMENT_MB', 'x')
    assert wire.segment_capacity_bytes() == wire.DEFAULT_SEGMENT_MB << 20
    assert wire.segment_capacity_bytes(0.5) == 1 << 19


@pytest.mark.parametrize('tiers', [[], [SHM], [SHM, ARROW], [ARROW, PICKLE], [SHM, SHM],
                                   [ARROW], [PICKLE, PICKLE], ['bogus'], [SHM, 'bogus']])
def test_common_transport_equals_jax(tiers):
    assert wire.common_transport(tiers) == jwire.common_transport(tiers)


def test_common_transport_is_fleet_floor():
    assert wire.common_transport([]) == PICKLE
    assert wire.common_transport([SHM]) == SHM
    assert wire.common_transport([SHM, ARROW]) == ARROW
    assert wire.common_transport([ARROW, PICKLE]) == PICKLE
    assert wire.common_transport([SHM, SHM]) != SHM


# -- the arrow codec -------------------------------------------------------------

def _payloads():
    rng = np.random.default_rng(5)
    yield {'vec': rng.random((6, 3, 2)).astype(np.float32), 'sid': np.arange(6, dtype=np.int64),
           'blob': np.array([b'x' * i for i in range(6)], dtype=object)}
    yield {'img': rng.integers(0, 255, (4, 7, 5, 3), dtype=np.uint8),
           'label': rng.integers(0, 1000, 4).astype(np.int32)}
    yield {'half': rng.random((3, 2)).astype(np.float16), 'flag': np.array([True, False, True])}
    yield {'empty_rows': np.zeros((0, 4), np.float64), 'ids': np.zeros((0,), np.int64)}


@pytest.mark.parametrize('index', range(4))
@pytest.mark.parametrize('direction', ['port-to-jax', 'jax-to-port'])
def test_arrow_frames_decode_in_the_other_package(index, direction):
    payload = list(_payloads())[index]
    sidecar = {'endpoint': 'ipc:///x', 'seg': {'k': index}, 'det': {'seq': 1, 'epoch': 1,
                                                                    'pos': index}}
    enc, dec = ((wire.encode_arrow, jwire.decode_arrow) if direction == 'port-to-jax'
                else (jwire.encode_arrow, wire.decode_arrow))
    frame = enc(payload, sidecar)
    assert frame is not None
    assert frame == (jwire.encode_arrow if enc is wire.encode_arrow else wire.encode_arrow)(
        payload, sidecar)
    cols = dec(frame)
    assert cols.pop('__pst_lineage__') == sidecar
    assert sorted(cols) == sorted(payload)
    for name, want in payload.items():
        got = cols[name]
        if want.dtype.hasobject:
            assert list(got) == list(want)
        else:
            assert got.dtype == want.dtype and got.shape == want.shape
            assert got.tobytes() == want.tobytes()
            assert not got.size or not got.flags.writeable


def test_arrow_refuses_unrideable_payloads():
    for enc in (wire.encode_arrow, jwire.encode_arrow):
        assert enc({'bad': np.array([object(), object()], dtype=object)}) is None
        assert enc({'a': np.zeros(3, np.float32), 'b': np.zeros(4, np.float32)}) is None
        assert enc({'zero_width': np.zeros((3, 0), np.float32)}) is None
        assert enc({}) is None


@pytest.mark.parametrize('size', [0, 7, 64, 1000, 2 * wire._CSUM_STRIPE,
                                  2 * wire._CSUM_STRIPE + 13, 5 * wire._CSUM_STRIPE])
def test_checksum_equals_jax(size):
    buf = np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8).tobytes()
    assert wire._checksum(memoryview(buf)) == jwire._checksum(memoryview(buf))


def test_checksum_stripe_detects_prefix_contiguous_overwrites():
    big = bytearray(os.urandom(3 * wire._CSUM_STRIPE))
    ref = wire._checksum(memoryview(big))
    for index in (0, -1):
        hit = bytearray(big)
        hit[index] ^= 0xFF
        assert wire._checksum(memoryview(hit)) != ref
    small = bytearray(os.urandom(100))
    sref = wire._checksum(memoryview(small))
    small[50] ^= 0xFF
    assert wire._checksum(memoryview(small)) != sref


# -- the shm segment ring ----------------------------------------------------------

@needs_shm
def test_ring_alloc_free_wrap_and_checksum():
    cap = 1 << 20
    ring = wire.ShmSegmentRing('pstt-wire-test-ring-{}'.format(os.getpid()), capacity=cap)
    try:
        with open(ring.path, 'rb') as f:
            magic, _boot, pid, capacity = wire._SEG_HDR.unpack(f.read(wire._SEG_HDR.size))
        assert (magic, pid, capacity) == (wire._SEG_MAGIC, os.getpid(), cap)
        block = np.arange(40_000, dtype=np.uint8)
        placed, seq = [], 0
        while True:
            fields = ring.place(seq, {'b': block})
            if fields is None:
                break
            placed.append((seq, fields))
            seq += 1
        assert len(placed) >= cap // block.nbytes - 1
        for _, fields in placed:
            f = fields[0]
            view = memoryview(ring._mm)[f['offset']:f['offset'] + block.nbytes]
            try:
                assert wire._checksum(view) == f['csum']
                assert bytes(view) == block.tobytes()
            finally:
                view.release()
        for s, _ in placed[:len(placed) // 2 + 1]:
            ring.free(s)
        refill = 0
        while ring.place(seq, {'b': block}) is not None:
            refill += 1
            seq += 1
        assert refill >= 1
        assert ring.place(seq, {'b': np.zeros(cap + 1, np.uint8)}) is None
    finally:
        ring.free_all()
        gc.collect()
        ring.close()
    assert not os.path.exists(ring.path)


@needs_shm
def test_a_ring_the_mount_cannot_hold_raises_and_leaves_no_file(monkeypatch):
    def no_room(fd, offset, length):
        raise OSError(28, 'No space left on device')

    monkeypatch.setattr(os, 'posix_fallocate', no_room)
    name = 'pstt-wire-test-full-{}'.format(os.getpid())
    with pytest.raises(OSError):
        wire.ShmSegmentRing(name, capacity=1 << 20)
    assert not os.path.exists(os.path.join(shm_ring.shm_dir(), name))
    # A server whose ring cannot be made downgrades the session to arrow.
    sw = wire.ServerWire(b'full-mount-server')
    try:
        reply = sw.negotiate('c1', wire.client_capabilities(), sole_consumer=True)
        assert reply == {'transport': ARROW}
    finally:
        sw.close()


@needs_shm
def test_wireclient_view_lifecycle_and_acks():
    ring = wire.ShmSegmentRing('pstt-wire-test-views-{}'.format(os.getpid()), capacity=1 << 20)
    client = wire.WireClient()
    try:
        data = np.arange(600, dtype=np.float32).reshape(20, 30)
        fields = ring.place(7, {'vec': data})
        desc = json.dumps({'segment': ring.name, 'seq': 7, 'fields': fields}).encode()
        cols = client.decode_chunk(desc)
        view = cols['vec']
        assert isinstance(view, wire.WireView) and not view.flags.writeable
        assert view.tobytes() == data.tobytes()
        tail = view[10:]
        del cols, view
        gc.collect()
        assert client.drain_acks() == {}, 'a live slice pins the region'
        del tail
        gc.collect()
        assert client.drain_acks() == {ring.name: [7]}
        client.requeue_acks(ring.name, [7])
        assert client.drain_acks() == {ring.name: [7]}
        fields2 = ring.place(8, {'vec': data})
        off = fields2[0]['offset']
        ring._mm[off:off + 4] = b'\xff\xff\xff\xff'
        desc2 = json.dumps({'segment': ring.name, 'seq': 8, 'fields': fields2}).encode()
        with pytest.raises(RuntimeError, match='checksum mismatch'):
            client.decode_chunk(desc2)
    finally:
        client.close()
        gc.collect()
        ring.free_all()
        ring.close()


@needs_shm
def test_wireclient_maps_jax_segments_and_refuses_foreign_names():
    client = wire.WireClient()
    with pytest.raises(ValueError, match='non-wire segment'):
        client.map_segment('etc/passwd')
    with pytest.raises(ValueError, match='non-wire segment'):
        client.map_segment('not-our-prefix')
    ring = jwire.ShmSegmentRing('pst-wire-test-jaxmap-{}'.format(os.getpid()),
                                capacity=1 << 16)
    try:
        data = np.arange(100, dtype=np.int64)
        desc = json.dumps({'segment': ring.name, 'seq': 0,
                           'fields': ring.place(0, {'ids': data})}).encode()
        cols = client.decode_chunk(desc)
        assert cols['ids'].tobytes() == data.tobytes()
        del cols
        gc.collect()
        assert client.drain_acks() == {ring.name: [0]}
    finally:
        client.close()
        ring.free_all()
        ring.close()


def _dead_pid():
    """A pid no process can hold: ``pid_max`` itself (pids stay below it).
    A reaped child's pid is not safe here, since a busy host that wraps its
    pid space may hand it to a new thread before the sweep looks."""
    try:
        with open('/proc/sys/kernel/pid_max') as f:
            return int(f.read())
    except OSError:
        proc = subprocess.Popen([sys.executable, '-c', 'pass'])
        proc.wait()
        return proc.pid


def test_sweep_stale_segments_touches_only_the_ports(tmp_path):
    d = str(tmp_path)
    boot = wire._read_boot_id()

    def seg(name, pid, boot_id=boot):
        path = os.path.join(d, name)
        with open(path, 'wb') as f:
            f.write(wire._SEG_HDR.pack(wire._SEG_MAGIC, boot_id.encode('ascii').ljust(36, b'\0'),
                                       pid, 4096))
            f.write(b'\0' * 64)
        return path

    live = seg('pstt-wire-live', os.getpid())
    dead = seg('pstt-wire-dead', _dead_pid())
    rebooted = seg('pstt-wire-reboot', os.getpid(), boot_id='0' * 36)
    jax_dead = seg('pst-wire-dead', _dead_pid())
    foreign = os.path.join(d, 'pstt-wire-foreign')
    with open(foreign, 'wb') as f:
        f.write(b'NOTOURS!' + b'\0' * 80)
    removed = wire.sweep_stale_segments(base_dir=d)
    assert sorted(removed) == sorted([dead, rebooted])
    assert os.path.exists(live) and os.path.exists(foreign)
    assert os.path.exists(jax_dead), 'the JAX package sweeps its own segments'
    assert jwire.sweep_stale_segments(base_dir=d) == [jax_dead]
    assert os.path.exists(live)


@needs_shm
def test_a_closed_server_wire_makes_no_ring():
    """An attach answered after the server closed its wire (stop() closes it
    before the rpc thread ends) is granted no ring: nothing would unlink it."""
    server_id = os.urandom(16)
    sw = wire.ServerWire(server_id)
    caps = wire.client_capabilities()
    granted = sw.negotiate('c1', caps, sole_consumer=True)
    assert granted['transport'] == SHM
    sw.close()
    try:
        reply = sw.negotiate('c2', caps, sole_consumer=True)
        assert reply['transport'] != SHM and 'segment' not in reply
        assert sw.segments() == {}
        assert not os.path.exists(os.path.join(shm_ring.shm_dir(), granted['segment']))
        made = '{}{}-c2-'.format(wire.SEGMENT_PREFIX, server_id.hex()[:12])
        assert not [n for n in shm_ring.list_segments(wire.SEGMENT_PREFIX) if n.startswith(made)]
    finally:
        sw.close()


@needs_shm
def test_wire_segment_leak_drill(monkeypatch):
    sw = wire.ServerWire(b'leakdrill-server')
    reply = sw.negotiate('c1', wire.client_capabilities(), sole_consumer=True)
    assert reply['transport'] == SHM and reply['segment'].startswith('pstt-wire-')
    seg_path = os.path.join(shm_ring.shm_dir(), reply['segment'])
    assert os.path.exists(seg_path)
    monkeypatch.setenv('PSTT_FAULTS', 'wire-segment-leak:max=1')
    sw.close()
    monkeypatch.delenv('PSTT_FAULTS')
    try:
        assert os.path.exists(seg_path), 'the drill leaves the segment'
        assert seg_path not in wire.sweep_stale_segments()
        with open(seg_path, 'r+b') as f:
            magic, boot, _pid, cap = wire._SEG_HDR.unpack(f.read(wire._SEG_HDR.size))
            f.seek(0)
            f.write(wire._SEG_HDR.pack(magic, boot, _dead_pid(), cap))
        assert seg_path in wire.sweep_stale_segments()
    finally:
        if os.path.exists(seg_path):
            os.unlink(seg_path)


# -- through the service ------------------------------------------------------------

def _drain_tier(bind, tier, sids):
    server = _serve_attached(make_stream_reader(sids), bind, tier)
    try:
        with RemoteReader(server.data_endpoint) as remote:
            _release_on_attach(server)
            chunks = _drain(remote)
            # Under load the attach's reply can come after the stream's end
            # (its first try timed out, the server had already admitted).
            deadline = time.monotonic() + 10
            while not remote._endpoint_wire and time.monotonic() < deadline:
                time.sleep(0.02)
            grants = dict(remote.fleet_metrics(timeout_ms=2000)['wire'])
    finally:
        server.stop()
    return chunks, grants


@needs_shm
def test_shm_epoch_bit_identical_to_pickle_and_arrow(sock):
    sids = [0, 100, 200, 300, 400, 500]
    base, grants = _drain_tier(ipc(sock, 'p'), PICKLE, sids)
    assert set(grants.values()) == {PICKLE}
    for tier in (ARROW, SHM):
        before = _wire_bytes()
        got, grants = _drain_tier(ipc(sock, tier[:3]), tier, sids)
        after = _wire_bytes()
        assert set(grants.values()) == {tier}
        assert after.get(tier, 0) > before.get(tier, 0)
        assert after.get(PICKLE, 0) == before.get(PICKLE, 0), 'no chunk fell back to pickle'
        assert len(got) == len(base) == len(sids)
        for (v1, s1), (v2, s2) in zip(base, got):
            assert v1.tobytes() == v2.tobytes() and s1.tobytes() == s2.tobytes()


@needs_shm
def test_acks_reach_the_server_after_the_stream_ended(sock):
    """Once a stream has ended the consumer still flushes the acks of the
    views it released, so the server's ring empties (the card test of a
    scan graph replaying over a ring of 8 chunks reads the same)."""
    server = _serve_attached(make_stream_reader([0, 100, 200, 300, 400, 500]), ipc(sock, 'd'),
                             SHM)
    try:
        with RemoteReader(server.data_endpoint, flow_control=2) as remote:
            _release_on_attach(server)
            assert len(_drain(remote)) == 6
            gc.collect()
            ring = next(iter(server._wire._rings.values()))
            deadline = time.monotonic() + 10
            while ring.used_bytes and time.monotonic() < deadline:
                remote._flush_wire_acks()
                time.sleep(0.02)
            assert ring.used_bytes == 0
    finally:
        server.stop()


@needs_shm
def test_a_full_ring_falls_back_to_arrow_and_counts_it(sock, monkeypatch):
    # A ring of one chunk, and views the consumer keeps: later chunks cannot
    # be placed, ride Arrow, and every row still arrives once.
    monkeypatch.setenv('PSTT_WIRE_SEGMENT_MB', str(CHUNK_ROWS * 48 * 4 * 1.5 / (1 << 20)))
    sids = [0, 100, 200, 300]
    server = _serve_attached(make_stream_reader(sids), ipc(sock, 'd'), None)
    kept = []
    try:
        before = _wire_bytes()
        with RemoteReader(server.data_endpoint) as remote:
            _release_on_attach(server)
            for chunk in remote:
                kept.append(chunk)
        after = _wire_bytes()
    finally:
        server.stop()
    assert sorted(int(i) for c in kept for i in c.sid) == sorted(
        i for b in sids for i in range(b, b + CHUNK_ROWS))
    assert after.get(SHM, 0) > before.get(SHM, 0)
    assert after.get(ARROW, 0) > before.get(ARROW, 0), 'the fallback is counted'
    del kept


@needs_shm
def test_mixed_fleet_tier_mix_in_fleet_metrics(sock):
    """A port server granting shm beside a JAX server forced to pickle (a
    fleet of mixed builds): the consumer decodes both by the chunks' tags."""
    srv_new = _serve_attached(make_stream_reader([0, 100, 200]), ipc(sock, 'new'), None)
    old_bind = ipc(sock, 'old')
    ctrl, rpc = endpoints(old_bind)
    srv_old = jds.DataServer(make_stream_reader([1000, 1100]), old_bind, control_bind=ctrl,
                             rpc_bind=rpc, wire=PICKLE)
    srv_old._pause.set()
    srv_old.start()
    try:
        with RemoteReader([srv_new.data_endpoint, srv_old.data_endpoint]) as remote:
            _release_on_attach(srv_new)
            deadline = time.monotonic() + 30
            while srv_old._admission.count() < 1 and time.monotonic() < deadline:
                time.sleep(0.005)
            srv_old._pause.clear()
            chunks = _drain(remote)
            tier_mix = dict(remote.fleet_metrics(timeout_ms=2000)['wire'])
    finally:
        srv_new.stop()
        srv_old.stop()
    ids = sorted(int(i) for _, sid in chunks for i in sid)
    assert ids == sorted(i for b in (0, 100, 200, 1000, 1100) for i in range(b, b + CHUNK_ROWS))
    assert tier_mix[srv_new.rpc_endpoint] == SHM
    assert tier_mix[srv_old.rpc_endpoint] == PICKLE


@needs_shm
def test_midstream_restart_renegotiates_and_loses_nothing(sock, monkeypatch):
    monkeypatch.setenv('PSTT_LEASE_S', '1.0')
    a_sids, b_sids = [0, 100, 200], [300, 400]
    keeper = DataServer(make_stream_reader([5000], forever=True), ipc(sock, 'k'), wire=PICKLE)
    keeper.start()
    srv_a = _serve_attached(make_stream_reader(a_sids), ipc(sock, 'a'), None)
    seen, srv_b = [], None
    want = {i for b in a_sids + b_sids for i in range(b, b + CHUNK_ROWS)}
    try:
        with RemoteReader([srv_a.data_endpoint, keeper.data_endpoint]) as remote:
            _release_on_attach(srv_a)
            it = iter(remote)
            deadline = time.monotonic() + 30
            while remote.fleet_metrics(timeout_ms=1000)['wire'].get(srv_a.rpc_endpoint) != SHM:
                assert time.monotonic() < deadline, 'no shm grant for A'
                time.sleep(0.05)
            from_a = set()
            while len(from_a) < len(a_sids) * CHUNK_ROWS:
                ids = [int(i) for i in next(it).sid]
                seen.extend(ids)
                if ids[0] < 1000:
                    from_a.update(ids)
            srv_a.stop()
            srv_b = DataServer(make_stream_reader(b_sids), srv_a.data_endpoint, wire=PICKLE)
            srv_b.start()
            deadline = time.monotonic() + 60
            while not want.issubset(seen):
                assert time.monotonic() < deadline, 'restart drain stalled'
                seen.extend(int(i) for i in next(it).sid)
            deadline = time.monotonic() + 30
            while remote.fleet_metrics(timeout_ms=1000)['wire'].get(srv_a.rpc_endpoint) != PICKLE:
                assert time.monotonic() < deadline, 'the grant never renegotiated down'
                time.sleep(0.1)
    finally:
        if srv_b is not None:
            srv_b.stop()
        keeper.stop()
    deliveries = [i for i in seen if i < 1000]
    assert sorted(deliveries) == sorted(want)
    bases = [i for i in deliveries if i % 100 == 0]
    assert [b for b in bases if b < 300] == [0, 100, 200]
    assert [b for b in bases if b >= 300] == [300, 400]


def _mapped(client):
    """The rings a port consumer maps: the live ones by name, and how many
    replaced ones a view still holds."""
    return sorted(client._segments), len(client._retired)


def _read_past_a_starved_reattach(package, sock, monkeypatch, stalls=(3,), keep=True,
                                  mappings=None, held=None, lag=False):
    """A sole shm consumer (4 credits) of a server with a 0.3 s lease stops
    re-attaching after each chunk index in ``stalls`` until the server has
    expired its admission (3 leases without a renew), while it holds the
    chunks it read (``keep``), then reads on. Returns the rows it got, the
    chunks it dropped as undecodable, and each shm ring the server granted,
    as (name, inode), in order.

    At each stall the server sends one chunk after the expiry (no ring:
    another tier) and waits until the consumer has heard of the ring its
    re-attach was granted. A stall after the first waits, from its index
    on, for a chunk of a ring the consumer had not read at the stall
    before, so that the consumer has caught up with the newest ring when it
    stalls. With ``lag`` it stalls at the index itself, and the server
    sends one chunk on the new ring and waits again, until the last stall:
    each new ring is freed with a chunk of it queued, unread, behind chunks
    of other tiers.

    ``mappings``, a list, gets the rings the port consumer maps at each
    stall, just before it stalls, and just before it closes, which waits
    until the consumer holds the newest ring the server granted; ``held``, a
    list, gets how many rings the server had granted when it did (0 if it
    never did)."""
    mod = jds if package == 'jax' else ds
    bind = ipc(sock, 'd')
    ctrl, rpc = endpoints(bind)
    sids = [i * 100 for i in range(200)]
    kw = dict(control_bind=ctrl, rpc_bind=rpc) if package == 'jax' else {}
    server = mod.DataServer(make_stream_reader(sids), bind, lease_s=0.3, **kw)
    rings = []
    negotiate = server._wire.negotiate

    def granting(*args, **kwargs):
        reply = negotiate(*args, **kwargs)
        if reply.get('segment'):
            ring = (reply['segment'],
                    os.stat(os.path.join(shm_ring.shm_dir(), reply['segment'])).st_ino)
            if ring not in rings:
                rings.append(ring)
        return reply

    monkeypatch.setattr(server._wire, 'negotiate', granting)
    park, parking = [], threading.Lock()
    encode = server._wire.encode

    def encoding(*args, **kwargs):
        tag, frames = encode(*args, **kwargs)
        ring = json.loads(bytes(frames[0]))['segment'] if tag == wire.TAG_SHM else None
        with parking:
            if park and park[0][0](ring):
                server._pause.set()
                park.pop()[1].set()
        return tag, frames

    def park_after(sent):
        """Let the server send until a chunk on a ring for which ``sent``
        holds, then park it; the event is set once it parks."""
        parked = threading.Event()
        with parking:
            park[:] = [(sent, parked)]
            server._pause.clear()
        return parked

    def run_free():
        with parking:
            park.clear()
            server._pause.clear()

    monkeypatch.setattr(server._wire, 'encode', encoding)
    server._pause.set()
    server.start()
    stall = threading.Event()
    attach = mod.RemoteReader._do_attach

    def starved(self, *args, **kwargs):
        while stall.is_set():
            time.sleep(0.02)
        return attach(self, *args, **kwargs)

    monkeypatch.setattr(mod.RemoteReader, '_do_attach', starved)
    if mappings is not None:
        close_sockets = mod.RemoteReader._close_sockets

        def closing(self):
            if not self._closed and self._wire_client is not None:
                newest = len(rings) if heard(0) else 0
                gc.collect()
                self._wire_client.drain_acks()
                mappings.append(_mapped(self._wire_client))
                if held is not None:
                    held.append(newest)
            return close_sockets(self)

        monkeypatch.setattr(mod.RemoteReader, '_close_sockets', closing)
    rows, kept, done = [], [], threading.Event()
    remote = mod.RemoteReader(server.data_endpoint, control_endpoints=[ctrl],
                              rpc_endpoints=[rpc], flow_control=4)

    def expired():
        """Until the server pruned the consumer's admission and freed its
        ring (30 s at most)."""
        deadline = time.monotonic() + 30
        while ((server._admission.count() > 0 or server._wire._rings)
               and time.monotonic() < deadline):
            time.sleep(0.02)

    def heard(before):
        """Until the consumer holds the newest ring, granted after ``before``
        rings (30 s at most); whether it does."""
        deadline = time.monotonic() + 30
        while True:
            holds = (len(rings) > before and (remote._endpoint_wire.get(rpc) or {})
                     .get('segment') == rings[-1][0])
            if holds or time.monotonic() >= deadline:
                return holds
            time.sleep(0.02)

    def consume():
        due, stalled_on = sorted(stalls), set()
        try:
            for i, chunk in enumerate(remote):
                if keep:
                    kept.append(chunk)
                rows.extend(int(x) for x in chunk.sid)
                ring = getattr(getattr(chunk.sid, '_pst_wire_region', None), 'segment', None)
                del chunk
                if not due or i < due[0]:
                    continue
                if stalled_on and not lag and ring in stalled_on | {None}:
                    continue
                due.pop(0)
                stalled_on.add(ring)
                if mappings is not None:
                    # No view of a ring a re-attach replaced is left: each
                    # chunk of it came before the expiry this stream read past.
                    gc.collect()
                    client = remote._wire_client
                    for segment, seqs in client.drain_acks().items():
                        client.requeue_acks(segment, seqs)
                    mappings.append(_mapped(client))
                before = len(rings)
                gap = park_after(lambda ring: ring is None)
                stall.set()
                expired()
                gap.wait(30)
                stall.clear()
                heard(before)
                if lag:
                    park_after(lambda ring: ring == rings[-1][0]).wait(30)
                if not lag or not due:
                    run_free()
        except Exception:  # noqa: BLE001 - the stream's end is what is read
            pass
        finally:
            done.set()

    try:
        deadline = time.monotonic() + 30
        while server._admission.count() < 1:
            assert time.monotonic() < deadline, 'no attach'
            time.sleep(0.005)
        server._pause.clear()
        thread = threading.Thread(target=consume, daemon=True)
        thread.start()
        # Until the stream ends, or it stalls short of it on the chunks it
        # dropped as undecodable.
        deadline = time.monotonic() + 120
        last, still = -1, time.monotonic()
        while not done.wait(0.1) and time.monotonic() < deadline:
            if len(rows) != last:
                last, still = len(rows), time.monotonic()
            elif (not stall.is_set() and remote.diagnostics['wire_decode_errors']
                  and time.monotonic() - still > 2.0):
                break
        errors = remote.diagnostics['wire_decode_errors']
    finally:
        remote.stop()
        remote.join()
        done.wait(10)
        server.stop()
    del kept
    want = sorted(i for b in sids for i in range(b, b + CHUNK_ROWS))
    return sorted(rows), want, errors, rings


@needs_shm
@pytest.mark.parametrize('package', ['jax', 'port'])
def test_a_consumer_past_its_admission_expiry_reads_no_overwritten_region(sock, monkeypatch,
                                                                          package):
    """The server frees an expired consumer's ring, which the consumer still
    maps, and makes a new one when it re-attaches. The JAX package names
    the new ring as the old one: the consumer, whose map cache is by name,
    reads the new descriptors through the old map, drops them on their
    checksum and stalls short of the stream. The port names each ring by
    its session (ROADMAP section C): every row arrives once."""
    rows, want, errors, rings = _read_past_a_starved_reattach(package, sock, monkeypatch)
    assert len(rings) == 2, 'a ring before the stall and one after the re-attach'
    (before, _), (after, _) = rings
    if package == 'jax':
        assert before == after
        assert errors > 0 and len(rows) < len(want)
    else:
        assert before != after and before.startswith(wire.SEGMENT_PREFIX)
        assert errors == 0 and rows == want


@needs_shm
def test_forced_expiries_leave_one_mapping_a_server(sock, monkeypatch):
    """Three admission expiries in one stream: each re-attach is granted a
    new ring, and the consumer unmaps the ring it replaced (at once, or as
    soon as its last view goes), so it maps at most one ring of its one
    server, not one an expiry. Every row still arrives once."""
    mappings, held = [], []
    rows, want, errors, rings = _read_past_a_starved_reattach(
        'port', sock, monkeypatch, stalls=(3, 12, 21), keep=False, mappings=mappings,
        held=held)
    assert len(rings) >= 2, 'no expiry was forced: {}'.format(rings)
    assert len({name for name, _ in rings}) == len(rings)
    assert errors == 0 and rows == want
    assert len(mappings) == 4, mappings
    assert all(len(names) + retired <= 1 for names, retired in mappings), (rings, mappings)
    # Just before close, the consumer holding the server's newest grant: no
    # ring the server granted before that one is left mapped.
    assert held and held[-1], ('the consumer never held the newest grant', rings)
    expired = {name for name, _ in rings[:held[-1] - 1]}
    names, retired = mappings[-1]
    assert not expired & set(names) and retired == 0, (rings, mappings)


@needs_shm
def test_expiries_behind_queued_chunks_lose_no_row(sock, monkeypatch):
    """Three admission expiries, each after the consumer heard of the ring
    its last re-attach was granted and while chunks sent before that ring
    are still queued for it: the server frees each new ring before the
    consumer read a chunk of it. The consumer maps a granted ring at once
    and retires a ring only once a chunk of a later one arrives, so every
    row still arrives once, and at the end only the newest ring is mapped."""
    mappings, held = [], []
    rows, want, errors, rings = _read_past_a_starved_reattach(
        'port', sock, monkeypatch, stalls=(3, 4, 5), keep=False, mappings=mappings,
        held=held, lag=True)
    assert len(rings) >= 4, 'three expiries, each with a re-attach: {}'.format(rings)
    assert errors == 0 and rows == want
    assert held and held[-1], ('the consumer never held the newest grant', rings)
    expired = {name for name, _ in rings[:held[-1] - 1]}
    names, retired = mappings[-1]
    assert not expired & set(names) and retired == 0, (rings, mappings)


@needs_shm
@pytest.mark.parametrize('server_package', ['jax', 'port'])
def test_auto_negotiation_across_packages(sock, server_package):
    """A port consumer of a JAX server is granted shm and maps the JAX
    segment; a JAX consumer of a port server (which cannot map a
    ``pstt-wire-`` segment) is granted Arrow. Rows equal in both."""
    sids = [0, 100, 200]
    bind = ipc(sock, server_package)
    ctrl, rpc = endpoints(bind)
    server_cls = jds.DataServer if server_package == 'jax' else DataServer
    server = server_cls(make_stream_reader(sids), bind, control_bind=ctrl, rpc_bind=rpc)
    server._pause.set()
    server.start()
    reader_cls = RemoteReader if server_package == 'jax' else jds.RemoteReader
    try:
        with reader_cls(bind, control_endpoints=ctrl, rpc_endpoints=rpc) as remote:
            deadline = time.monotonic() + 30
            while server._admission.count() < 1 and time.monotonic() < deadline:
                time.sleep(0.005)
            server._pause.clear()
            chunks = _drain(remote)
            grant = remote.fleet_metrics(timeout_ms=2000)['wire'][rpc]
    finally:
        server.stop()
    assert grant == (SHM if server_package == 'jax' else ARROW)
    assert [int(s[0]) for _, s in chunks] == sids
    for (vec, sid), base in zip(chunks, sids):
        want = make_stream_reader([base])
        assert vec.tobytes() == next(iter(want)).vec.tobytes()
