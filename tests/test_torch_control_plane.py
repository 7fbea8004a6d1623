"""The port's control plane (``petastorm_tpu_torch/fleet/control_plane.py``)
against the JAX package's (``petastorm_tpu/fleet/control_plane.py``): the
same inputs give the same bytes and the same decisions.

* Heartbeats of both dialects, with and without the announce tail and the
  MAC, packed by one package are byte-equal to the other's and parse alike
  in both; a mangled or forged one parses to None in both.
* MACs and refusals are equal; the admission ledger and the drain state
  make the same decisions over one scripted history.
* The lease and job resolution read ``PSTT_LEASE_S`` / ``PSTT_FLEET_JOB``
  with the JAX package's grammar for its ``PETASTORM_TPU_*`` variables.
* The module is stdlib only, and its ``PipelineSupervisor`` is health's.
"""

import json
import subprocess
import sys

import pytest

from petastorm_tpu.fleet import control_plane as jcp
from petastorm_tpu_torch import health
from petastorm_tpu_torch.fleet import control_plane as cp

SIDS = (b'\x00' * 16, bytes(range(16)), b'\xffserver-id-00001')
STATES = ('serving', 'draining', 'drained', 'awaiting-cursor', 'unknown-state')
ANNOUNCES = (None, {'job': 'imagenet', 'capacity': 4}, {'job': 'j', 'capacity': None,
                                                        'data': 'ipc:///tmp/x', 'sent': 17})
KEYS = (None, b'secret', b'\x00' * 32)
ENDPOINTS = ('tcp://127.0.0.1:5557', 'ipc:///tmp/pstt/data.2', '')


def _grid():
    for sid in SIDS:
        for state in STATES:
            for announce in ANNOUNCES:
                for key in KEYS:
                    for ep in ENDPOINTS:
                        yield sid, state, announce, key, ep


@pytest.mark.parametrize('lease_s', [0.3, 10.0, 123.5])
def test_binary_heartbeats_are_byte_equal_and_parse_alike(lease_s):
    n = 0
    for sid, state, announce, key, ep in _grid():
        ours = cp.pack_heartbeat(sid, lease_s, state, ep, announce=announce, auth_key=key)
        theirs = jcp.pack_heartbeat(sid, lease_s, state, ep, announce=announce, auth_key=key)
        assert ours == theirs
        parsed = cp.parse_heartbeat(ours, auth_key=key)
        assert parsed == jcp.parse_heartbeat(theirs, auth_key=key)
        assert parsed['server_id'] == sid.hex() and parsed['lease_s'] == lease_s
        assert parsed['announce'] == announce
        assert parsed['state'] == (state if state in cp.STATE_CODES else 'serving')
        n += 1
    assert n == len(SIDS) * len(STATES) * len(ANNOUNCES) * len(KEYS) * len(ENDPOINTS)


@pytest.mark.parametrize('key', [b'secret', b'other'])
def test_forged_or_truncated_heartbeats_parse_to_none_in_both(key):
    msg = cp.pack_heartbeat(SIDS[1], 1.0, 'serving', ENDPOINTS[0], auth_key=key)
    forged = bytearray(msg)
    forged[10] ^= 0x01
    for bad in (bytes(forged), msg[:len(cp.CTRL_HB) + 4], b'PST_HBx', b'not a heartbeat'):
        assert cp.parse_heartbeat(bad, auth_key=key) is None
        assert jcp.parse_heartbeat(bad, auth_key=key) is None
    # The wrong key refuses; no key reads the MAC as part of the tail.
    assert cp.parse_heartbeat(msg, auth_key=b'wrong') is None
    assert jcp.parse_heartbeat(msg, auth_key=b'wrong') is None
    assert cp.parse_heartbeat(msg) == jcp.parse_heartbeat(msg)


@pytest.mark.parametrize('body', [
    {'server_id': 'ab', 'lease_s': 2.0, 'state': 'draining', 'rpc': 'tcp://h:1', 'name': 'n',
     'job': 'j', 'capacity': 3},
    {'server_id': 'cd'},
    {'lease_s': 0},
])
def test_json_heartbeats_parse_alike(body):
    msg = cp.CTRL_HB_JSON + json.dumps(body).encode()
    assert cp.CTRL_HB_JSON == jcp.CTRL_HB_JSON
    assert cp.parse_heartbeat(msg) == jcp.parse_heartbeat(msg)
    garbled = cp.CTRL_HB_JSON + b'{not json'
    assert cp.parse_heartbeat(garbled) is None and jcp.parse_heartbeat(garbled) is None


@pytest.mark.parametrize('tail', [b'', b'tcp://h:1', b'tcp://h:1\n{"job": "x"}',
                                  b'ipc:///p.2\n{broken', b'\xff\xfe\n{}'])
def test_heartbeat_tails_split_alike(tail):
    assert cp.split_hb_tail(tail) == jcp.split_hb_tail(tail)


@pytest.mark.parametrize('key', KEYS[1:])
def test_macs_are_equal_and_cross_verify(key):
    parts_grid = ((b'',), (b'a', b'bc'), (b'ab', b'c'), (bytes(range(256)),) * 3)
    for parts in parts_grid:
        tag = cp.mac(key, *parts)
        assert tag == jcp.mac(key, *parts) and len(tag) == cp.MAC_LEN == jcp.MAC_LEN
        assert cp.mac_ok(key, tag, *parts) and jcp.mac_ok(key, tag, *parts)
        assert not cp.mac_ok(key, tag[:-1] + bytes([tag[-1] ^ 1]), *parts)
    # Frame lengths are MACed: moving a byte across a boundary changes the tag.
    assert cp.mac(key, b'a', b'bc') != cp.mac(key, b'ab', b'c')


@pytest.mark.parametrize('refused,reason,extra', [
    (cp.REFUSED_DRAINING, None, {'sent': 3}),
    (cp.REFUSED_DRAINED, None, {}),
    (cp.REFUSED_OVERLOADED, None, {'max_consumers': 2}),
    (cp.REFUSED_OVERLOADED, cp.REASON_MEMORY_PRESSURE, {}),
    (cp.REFUSED_OVERLOADED, cp.REASON_TENANT_OVER_BUDGET, {'tenant': 't'}),
])
def test_refusals_are_equal(refused, reason, extra):
    ours = cp.refusal(b'sid', refused, 'serving', reason=reason, **extra)
    assert ours == jcp.refusal(b'sid', refused, 'serving', reason=reason, **extra)
    for name in ('REFUSED_DRAINING', 'REFUSED_DRAINED', 'REFUSED_OVERLOADED',
                 'REASON_MEMORY_PRESSURE', 'REASON_TENANT_OVER_BUDGET', 'DEFAULT_TRANSPORT',
                 'EXPIRY_LEASES', 'DEFAULT_LEASE_S', 'ANNOUNCE_SEP', 'STATE_CODES'):
        assert getattr(cp, name) == getattr(jcp, name), name
    assert cp.HB_STRUCT.format == jcp.HB_STRUCT.format


def _ledger_history(mod, lease_s):
    """One scripted admission history; returns every observable outcome."""
    ledger = mod.AdmissionLedger(lease_s)
    out = []
    with ledger.lock:
        ledger.admit_locked('a', 0.0, credits=4, tenant=None, wire='shm')
        ledger.admit_locked('b', 1.0, credits=0, tenant='t')
        out.append(ledger.known_locked('a'))
        out.append(ledger.renew_locked('a', 2.0)['renewed'])
        out.append(ledger.renew_locked('zz', 2.0))
        out.append(mod.session_transports_locked(ledger))
        out.append(sorted(c for c, _ in ledger.prune_locked(1.0 + 3 * lease_s + 0.01)))
        out.append(ledger.count_locked())
        ledger.admit_locked('c', 5.0)
        out.append(ledger.release_locked('a') is not None)
        out.append(ledger.release_locked('a'))
        out.append(sorted(c for c, _ in ledger.prune_locked(100.0)))
    out.append(ledger.count())
    out.append(ledger.snapshot())
    return out


@pytest.mark.parametrize('lease_s', [0.5, 1.0, 10.0])
def test_admission_ledgers_decide_alike(lease_s):
    assert _ledger_history(cp, lease_s) == _ledger_history(jcp, lease_s)


@pytest.mark.parametrize('entry', [None, {}, {'wire': None}, {'wire': 'shm'},
                                   {'wire': 'arrow-ipc', 'credits': 3}])
def test_session_transport_is_equal(entry):
    assert cp.session_transport(entry) == jcp.session_transport(entry)


def test_drain_states_step_alike():
    ours, theirs = cp.DrainState(), jcp.DrainState()
    trace = []
    for d in (ours, theirs):
        steps = [d.state(), d.state(serving='awaiting-cursor'), d.request(), d.request(),
                 d.state(), d.is_draining, d.is_drained]
        d.mark_drained()
        steps += [d.state(), d.is_drained, d.request()]
        trace.append(steps)
    assert trace[0] == trace[1]
    assert trace[0][2] is True and trace[0][3] is False


@pytest.mark.parametrize('raw', [None, '', '2.5', ' 7 ', 'abc', '0'])
def test_lease_and_job_resolution_follow_the_jax_grammar(monkeypatch, raw):
    for name in (cp.ENV_LEASE, jcp.ENV_LEASE, cp.ENV_JOB, jcp.ENV_JOB):
        monkeypatch.delenv(name, raising=False)
    assert cp.ENV_LEASE == 'PSTT_LEASE_S' and cp.ENV_JOB == 'PSTT_FLEET_JOB'
    if raw is not None:
        monkeypatch.setenv(cp.ENV_LEASE, raw)
        monkeypatch.setenv(jcp.ENV_LEASE, raw)
        monkeypatch.setenv(cp.ENV_JOB, raw)
        monkeypatch.setenv(jcp.ENV_JOB, raw)
    assert cp.resolve_lease_s() == jcp.resolve_lease_s()
    assert cp.resolve_lease_s(3) == jcp.resolve_lease_s(3) == 3.0
    assert cp.resolve_job_id() == jcp.resolve_job_id()
    assert cp.resolve_job_id('x') == jcp.resolve_job_id('x') == 'x'
    for lease in (0.01, 0.3, 3.0, 30.0):
        assert cp.heartbeat_interval(lease) == jcp.heartbeat_interval(lease)


def test_the_supervisor_is_healths_and_the_module_is_stdlib_only():
    assert cp.PipelineSupervisor is health.PipelineSupervisor
    with pytest.raises(AttributeError):
        cp.NoSuchName  # noqa: B018
    code = ('import sys\n'
            'import petastorm_tpu_torch.fleet.control_plane as cp\n'
            'bad = sorted(m for m in ("zmq", "torch", "pyarrow", "numpy", "jax") '
            'if m in sys.modules)\n'
            'assert not bad, bad\n'
            'print("ok")\n')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 0 and out.stdout.strip() == 'ok', out.stderr
