"""ctypes bindings of the shared-memory ring (``src/shm_ring.cc``;
counterpart of ``petastorm_tpu/native/shm_ring.py:7-220``).

One single-producer single-consumer ring a direction a worker. The blocking
calls release the GIL (ctypes), so a consumer waiting on a ring holds up
no other thread. The library builds with ``g++ ... -lrt`` at first use
(:mod:`~petastorm_tpu_torch.native.build`); where it cannot,
:func:`available` is False and :func:`load_error` says why.

A ring's pages are reserved when it is created: a ring that does not fit
in the shm mount's free space raises ``OSError`` (``ENOSPC``) naming the
mount and its free bytes, where a sparse segment would kill its writer with
``SIGBUS`` at the first page past the free space. Segment names start with
:data:`SEGMENT_PREFIX`, the port's own, so sweeps of the two packages'
segments never meet.
"""

import ctypes
import errno
import logging
import os
import weakref

import numpy as np

from petastorm_tpu_torch.native.build import NativeBuildError, build_and_load

logger = logging.getLogger(__name__)

#: Where POSIX shared-memory objects appear as files (Linux tmpfs).
SHM_DIR = '/dev/shm'
#: The first characters of every segment the port creates.
SEGMENT_PREFIX = 'pstt_'

RING_OK = 0
RING_ERR_TIMEOUT = -3
RING_ERR_CLOSED = -4
RING_ERR_TOO_BIG = -5
RING_ERR_AGAIN = -6

_lib = None
_load_error = None


def shm_dir():
    """The shm mount, or None when the host has none."""
    return SHM_DIR if os.path.isdir(SHM_DIR) else None


def shm_free_bytes():
    """Bytes free on the shm mount (``os.statvfs``), or None."""
    d = shm_dir()
    if d is None:
        return None
    st = os.statvfs(d)
    return st.f_bavail * st.f_frsize


def shm_total_bytes():
    """The shm mount's size, or None."""
    d = shm_dir()
    if d is None:
        return None
    st = os.statvfs(d)
    return st.f_blocks * st.f_frsize


def list_segments(prefix=SEGMENT_PREFIX):
    """Names of the shm segments starting with ``prefix``, sorted."""
    d = shm_dir()
    if d is None:
        return []
    try:
        return sorted(n for n in os.listdir(d) if n.startswith(prefix))
    except OSError:
        return []


def _load():
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return _lib
    try:
        lib = build_and_load('pstt_shm_ring', ['shm_ring.cc'], link_flags=['-lrt'])
    except NativeBuildError as exc:
        logger.warning('shm ring transport unavailable: %s', exc)
        _load_error = str(exc)
        return None
    c_ring, c_u64, c_int = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int
    for name, restype, argtypes in (
            ('pstt_ring_create', c_ring, [ctypes.c_char_p, c_u64, ctypes.POINTER(c_int)]),
            ('pstt_ring_open', c_ring, [ctypes.c_char_p]),
            ('pstt_ring_close', None, [c_ring]),
            ('pstt_ring_unlink', c_int, [ctypes.c_char_p]),
            ('pstt_ring_write', c_int, [c_ring, c_int, ctypes.c_uint8, ctypes.c_void_p, c_u64,
                                        c_int]),
            ('pstt_ring_mark_closed', None, [c_ring]),
            ('pstt_ring_wait', c_int, [c_ring, ctypes.POINTER(c_u64),
                                       ctypes.POINTER(ctypes.c_uint8), c_int]),
            ('pstt_ring_pop', c_int, [c_ring, c_u64, ctypes.c_void_p, c_u64]),
            ('pstt_ring_capacity', c_u64, [c_ring]),
            ('pstt_ring_set_flags', None, [c_ring, ctypes.c_uint32]),
            ('pstt_ring_get_flags', ctypes.c_uint32, [c_ring])):
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    _lib = lib
    return _lib


def available():
    return _load() is not None


def load_error():
    """Why the library did not build, or None."""
    _load()
    return _load_error


class RingClosed(Exception):
    """The producer closed the ring and it is drained, or the control flag
    aborted a blocked write."""


class RingTimeout(Exception):
    pass


def _address(data):
    """``(address, nbytes, keepalive)`` of any contiguous buffer, read-only
    ones included."""
    array = np.frombuffer(data, dtype=np.uint8)
    return array.ctypes.data, array.nbytes, array


def _release(handle, unlink_name):
    _lib.pstt_ring_close(handle)
    if unlink_name is not None:
        _lib.pstt_ring_unlink(unlink_name.encode())


class ShmRing(object):
    """One end of a shared-memory ring. :meth:`close` unmaps it and, on the
    end that created it, removes the segment; a ring never closed is
    released when it is collected or, at the latest, when the interpreter
    exits, so a reader that was never stopped leaves no segment behind."""

    def __init__(self, handle, name, owner):
        self._h = handle
        self.name = name
        self._finalizer = weakref.finalize(self, _release, handle, name if owner else None)

    @classmethod
    def create(cls, name, capacity):
        """A new ring of ``capacity`` data bytes, its pages reserved."""
        lib = _load()
        if lib is None:
            raise RuntimeError('shm ring native library unavailable: {}'.format(_load_error))
        free = shm_free_bytes()
        if free is not None and capacity + 4096 > free:
            raise OSError(errno.ENOSPC, _no_space_message(name, capacity, free))
        err = ctypes.c_int(0)
        h = lib.pstt_ring_create(name.encode(), capacity, ctypes.byref(err))
        if not h:
            if err.value == errno.ENOSPC:
                raise OSError(errno.ENOSPC, _no_space_message(name, capacity, shm_free_bytes()))
            raise OSError(err.value, 'cannot create shm ring {!r} of {} bytes: {}'.format(
                name, capacity, os.strerror(err.value)))
        return cls(h, name, owner=True)

    @classmethod
    def open(cls, name):
        lib = _load()
        if lib is None:
            raise RuntimeError('shm ring native library unavailable: {}'.format(_load_error))
        h = lib.pstt_ring_open(name.encode())
        if not h:
            raise OSError('failed to open shm ring {!r}'.format(name))
        return cls(h, name, owner=False)

    def write(self, data, timeout_ms=-1, tag=None):
        """One message: ``tag`` (one byte, when given) then ``data`` (any
        contiguous buffer, copied once, into the ring)."""
        address, nbytes, keep = _address(data)
        rc = _lib.pstt_ring_write(self._h, tag is not None, tag[0] if tag is not None else 0,
                                  address, nbytes, timeout_ms)
        del keep
        if rc == RING_OK:
            return
        if rc == RING_ERR_CLOSED:
            raise RingClosed()
        if rc == RING_ERR_TIMEOUT:
            raise RingTimeout()
        if rc == RING_ERR_TOO_BIG:
            raise ValueError('message of {} bytes exceeds ring capacity/2; raise the ring\'s '
                             'bytes (shm_result_ring_bytes) or shrink row-groups'.format(
                                 nbytes + (tag is not None)))
        raise OSError('ring write failed (rc={})'.format(rc))

    def peek(self, timeout_ms=0):
        """``(first byte, length)`` of the next message without taking it;
        None when there is none in time (``timeout_ms=0``: do not wait).
        Raises :class:`RingClosed` once the producer closed and it drained."""
        length = ctypes.c_uint64()
        tag = ctypes.c_uint8()
        rc = _lib.pstt_ring_wait(self._h, ctypes.byref(length), ctypes.byref(tag), timeout_ms)
        if rc in (RING_ERR_AGAIN, RING_ERR_TIMEOUT):
            return None
        if rc == RING_ERR_CLOSED:
            raise RingClosed()
        if rc != RING_OK:
            raise OSError('ring peek failed (rc={})'.format(rc))
        return tag.value, length.value

    def pop_into(self, out, skip=0):
        """Take the next message, less its first ``skip`` bytes, into the
        writable buffer ``out`` (at least that long); returns the bytes
        copied."""
        array = np.frombuffer(out, dtype=np.uint8)
        length = ctypes.c_uint64()
        if _lib.pstt_ring_wait(self._h, ctypes.byref(length), None, 0) != RING_OK:
            raise OSError('ring pop without a message')
        n = length.value - skip
        rc = _lib.pstt_ring_pop(self._h, skip, array.ctypes.data, array.nbytes)
        if rc != RING_OK:
            raise OSError('ring pop failed (rc={})'.format(rc))
        return n

    def read(self, timeout_ms=0, skip=0):
        """The next message (less ``skip`` bytes) as a writable memoryview;
        None when empty in time. Raises :class:`RingClosed` once the
        producer closed and the ring drained."""
        head = self.peek(timeout_ms)
        if head is None:
            return None
        buf = bytearray(head[1] - skip)
        self.pop_into(buf, skip)
        return memoryview(buf)

    def mark_closed(self):
        _lib.pstt_ring_mark_closed(self._h)

    def set_flags(self, flags):
        _lib.pstt_ring_set_flags(self._h, flags)

    def get_flags(self):
        return _lib.pstt_ring_get_flags(self._h)

    @property
    def capacity(self):
        return _lib.pstt_ring_capacity(self._h)

    def close(self):
        self._finalizer()


def _no_space_message(name, capacity, free):
    return ('cannot reserve shm ring {!r} of {} bytes: {} has {} bytes free; shrink '
            'shm_result_ring_bytes or the worker count, or enlarge the mount'.format(
                name, capacity, SHM_DIR, free))
