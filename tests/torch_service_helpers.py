"""Helpers of the port's data-service tests: short ``ipc://`` endpoints under
a test's ``tmp_path`` (a Unix socket's path has at most 107 bytes), and the
synthetic batched reader of ``tests/test_wire.py``."""

import collections
import os
import tempfile

import numpy as np

#: Room left for the socket's own name and its ``.1`` / ``.2`` suffixes.
_MAX_DIR_LEN = 90

CHUNK_ROWS = 32
VEC_WIDTH = 48


def ipc_dir(tmp_path):
    """A directory for ``ipc://`` sockets inside ``tmp_path``, reached
    through a short symlink under the temporary directory when
    ``tmp_path`` itself is too long. Returns the path to use."""
    path = tmp_path / 'ipc'
    path.mkdir(exist_ok=True)
    if len(str(path)) <= _MAX_DIR_LEN:
        return str(path)
    link = tempfile.mktemp(prefix='pstt-ipc-')
    os.symlink(str(path), link)
    return link


def ipc(directory, name):
    return 'ipc://' + os.path.join(directory, name)


def endpoints(data_endpoint):
    """``(control, rpc)`` of an ``ipc://`` data endpoint by the port's
    convention, for the JAX package, which needs them passed."""
    return data_endpoint + '.1', data_endpoint + '.2'


def make_stream_reader(sids, forever=False):
    """The minimal batched-reader surface serving one synthetic chunk per
    entry of ``sids`` (row-id bases), as ``tests/test_wire.py`` does."""
    nt = collections.namedtuple('WireChunk', ['vec', 'sid'])

    class _StreamReader(object):
        batched_output = True
        ngram = None

        def __iter__(self):
            while True:
                for base in sids:
                    rng = np.random.default_rng(base)
                    yield nt(vec=rng.random((CHUNK_ROWS, VEC_WIDTH)).astype(np.float32),
                             sid=np.arange(base, base + CHUNK_ROWS, dtype=np.int64))
                if not forever:
                    return

        def stop(self):
            pass

        def join(self):
            pass

        @property
        def diagnostics(self):
            return {}

    return _StreamReader()
