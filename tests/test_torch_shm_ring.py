"""The port's shared-memory ring and the pool on it, held to the JAX
package's tests (``tests/test_shm_pool.py:25-67``, and its pool cases):
FIFO order, wrap-around, an oversized message, closed after drain, the flag
that aborts a blocked write; payloads many times the ring streamed in
pieces; a worker's error raised in the consumer. Beyond them: a ring the
shm mount cannot hold raises at creation, never ``SIGBUS`` in a worker; the
segments carry the port's own prefix and are gone after ``join``; tagged
messages pop into a caller's buffer."""

import os

import numpy as np
import pytest

from petastorm_tpu_torch.native import shm_ring
from petastorm_tpu_torch.workers import EmptyResultError
from petastorm_tpu_torch.workers.serializers import ArrowTableSerializer
from petastorm_tpu_torch.workers.shm_process_pool import ShmProcessPool
from petastorm_tpu_torch.workers.ventilator import ConcurrentVentilator
from torch_pool_workers import BigBlobWorker, EchoWorker, FailingWorker, TableWorker

pytestmark = pytest.mark.processpool


@pytest.fixture(autouse=True)
def _needs_the_ring():
    if not shm_ring.available():
        pytest.fail('the shm ring did not build: {}'.format(shm_ring.load_error()))


def _ring_pair(tag, capacity=1 << 16):
    name = '/pstt_t_{}_{}'.format(tag, os.getpid())
    producer = shm_ring.ShmRing.create(name, capacity)
    return producer, shm_ring.ShmRing.open(name)


def test_ring_fifo_order():
    a, b = _ring_pair('fifo')
    for i in range(100):
        b.write(bytes([i]) * (i + 1))
    for i in range(100):
        assert a.read() == bytes([i]) * (i + 1)
    assert a.read() is None
    a.close()
    b.close()


def test_ring_wraparound_many_messages():
    a, b = _ring_pair('wrap', capacity=8192)
    rng = np.random.default_rng(0)
    pending = []
    for _ in range(2000):
        msg = bytes(rng.integers(0, 255, int(rng.integers(0, 1500))).astype(np.uint8))
        b.write(msg, timeout_ms=1000)
        pending.append(msg)
        while len(pending) > 2:     # the ring stays partly full across wraps
            assert a.read(timeout_ms=100) == pending.pop(0)
    while pending:
        assert a.read(timeout_ms=100) == pending.pop(0)
    a.close()
    b.close()


def test_ring_too_big_message():
    a, b = _ring_pair('big', capacity=8192)
    with pytest.raises(ValueError, match='exceeds ring capacity'):
        b.write(b'x' * 8000)
    a.close()
    b.close()


def test_ring_closed_after_drain():
    a, b = _ring_pair('closed')
    b.write(b'last')
    b.mark_closed()
    assert a.read() == b'last'
    with pytest.raises(shm_ring.RingClosed):
        a.read(timeout_ms=100)
    a.close()
    b.close()


def test_ring_flag_aborts_blocked_write():
    a, b = _ring_pair('flag', capacity=8192)
    while True:     # fill the ring so that the next write would block
        try:
            b.write(b'y' * 3000, timeout_ms=50)
        except shm_ring.RingTimeout:
            break
    a.set_flags(1)
    with pytest.raises(shm_ring.RingClosed):
        b.write(b'y' * 3000, timeout_ms=5000)
    a.close()
    b.close()


def test_tagged_message_peeks_its_tag_and_pops_into_a_buffer_at_an_offset():
    a, b = _ring_pair('tagged')
    payload = np.arange(10, dtype=np.uint8)
    payload.flags.writeable = False         # a read-only buffer writes too
    b.write(payload, tag=b'D')
    assert a.peek() == (ord('D'), 11)
    out = np.zeros(16, dtype=np.uint8)
    assert a.pop_into(out[3:13], skip=1) == 10
    np.testing.assert_array_equal(out[3:13], payload)
    assert out[:3].sum() == 0 and out[13:].sum() == 0
    assert a.peek() is None
    a.close()
    b.close()


def test_a_ring_the_mount_cannot_hold_raises_at_creation():
    """The JAX ring only ftruncates: on a full mount its writer dies of
    SIGBUS at the first page past the free space. The port's raises when
    the ring is made, naming the mount and its free bytes."""
    name = '/pstt_t_full_{}'.format(os.getpid())
    with pytest.raises(OSError, match='/dev/shm has [0-9]+ bytes free') as info:
        shm_ring.ShmRing.create(name, shm_ring.shm_free_bytes() + (1 << 30))
    assert info.value.errno == 28
    assert name[1:] not in shm_ring.list_segments()


def test_the_native_reservation_raises_where_the_python_check_is_passed(monkeypatch):
    """Past the Python check (another process may fill the mount between
    it and the call), the native create reserves the pages and fails with
    ENOSPC instead of leaving a sparse segment."""
    monkeypatch.setattr(shm_ring, 'shm_free_bytes', lambda: 1 << 62)
    name = '/pstt_t_fullc_{}'.format(os.getpid())
    with pytest.raises(OSError, match='cannot reserve') as info:
        shm_ring.ShmRing.create(name, shm_ring.shm_total_bytes() + (1 << 30))
    assert info.value.errno == 28
    assert name[1:] not in shm_ring.list_segments()


def test_a_created_ring_is_resident():
    a, b = _ring_pair('resident', capacity=1 << 20)
    st = os.stat(os.path.join(shm_ring.SHM_DIR, a.name[1:]))
    assert st.st_blocks * 512 >= (1 << 20)      # reserved, not sparse
    a.close()
    b.close()


# -- the pool ----------------------------------------------------------------------------

def _drain(pool):
    out = []
    with pytest.raises(EmptyResultError):
        while True:
            out.append(pool.get_results())
    return out


def _run(pool, worker, values, iterations=1):
    ventilator = ConcurrentVentilator(None, [{'value': v} for v in values],
                                      iterations=iterations)
    pool.start(worker, None, ventilator)
    try:
        return _drain(pool)
    finally:
        pool.stop()
        pool.join()


def test_shm_pool_multiple_epochs_and_no_segment_left():
    pool = ShmProcessPool(2)
    results = _run(pool, EchoWorker, range(5), iterations=3)
    assert sorted(v for r in results for v in r) == sorted([i * 2 for i in range(5)] * 3)
    assert not [s for s in shm_ring.list_segments() if s.startswith(pool._base[1:])]


def test_shm_pool_streams_payloads_many_times_its_ring():
    """A 1 MiB ring carries 3 MiB in-band bytes and a 4 MiB array a payload
    (the card's 38.5 MB row-group in a 64 MiB ring takes the same path)."""
    results = _run(ShmProcessPool(2, result_ring_bytes=1 << 20), BigBlobWorker, range(6))
    assert sorted(r['value'] for r in results) == list(range(6))
    for r in results:
        assert r['blob'] == bytes([r['value'] % 256]) * (3 << 20)
        np.testing.assert_array_equal(r['array'], np.full((1 << 20,), r['value'], np.int32))
        assert r['array'].flags.writeable


def test_shm_pool_carries_arrow_tables():
    results = _run(ShmProcessPool(2, serializer=ArrowTableSerializer()), TableWorker, range(4))
    assert sorted(t.column('value')[0].as_py() for t in results) == list(range(4))
    assert all(t.column('name').to_pylist() == ['v{}'.format(t.column('value')[0].as_py())] * 4
               for t in results)


def test_shm_pool_exception_propagates():
    pool = ShmProcessPool(2)
    ventilator = ConcurrentVentilator(None, [{'value': i} for i in range(4)], iterations=1)
    pool.start(FailingWorker, None, ventilator)
    with pytest.raises(ValueError, match='boom'):
        while True:
            pool.get_results()
    assert pool._processes == []        # the error stopped and joined the pool
    assert not [s for s in shm_ring.list_segments() if s.startswith(pool._base[1:])]


def test_a_pool_whose_rings_do_not_fit_raises_and_leaves_nothing():
    pool = ShmProcessPool(2, result_ring_bytes=shm_ring.shm_free_bytes() + (1 << 30))
    ventilator = ConcurrentVentilator(None, [{'value': 1}], iterations=1)
    with pytest.raises(OSError, match='bytes free'):
        pool.start(EchoWorker, None, ventilator)
    assert pool._processes == []
    assert not [s for s in shm_ring.list_segments() if s.startswith(pool._base[1:])]


def test_a_ring_never_closed_is_removed_when_its_process_exits():
    """A reader that was never stopped must not leave its rings in the
    mount: an unclosed ring is released at interpreter exit."""
    import subprocess
    import sys
    name = 'pstt_t_exit_{}'.format(os.getpid())
    code = ('from petastorm_tpu_torch.native import shm_ring\n'
            'kept = shm_ring.ShmRing.create({!r}, 1 << 16)\n'
            'print(shm_ring.list_segments({!r}))\n').format('/' + name, name)
    result = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True,
                            timeout=120, cwd=os.path.dirname(os.path.dirname(
                                os.path.abspath(__file__))))
    assert result.returncode == 0, result.stderr
    assert name in result.stdout            # it existed while the process ran
    assert name not in shm_ring.list_segments(name)
