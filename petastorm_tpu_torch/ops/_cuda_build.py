"""Build the port's CUDA C++ kernels with ``nvcc`` and load them with ``ctypes``.

A source under ``petastorm_tpu_torch/csrc/`` is compiled at first use into
``.torch_build/kernels/<hash>/lib<name>.so`` at the root of the checkout
(``.gitignore`` lists ``.torch_build/``); the hash covers every file under
``csrc/`` (the named source and any header it includes) and the flags, so
an edited kernel or header is rebuilt and an unchanged one is loaded as it
is. The library has a plain C interface: no PyTorch headers, so ``nvcc``
takes seconds, not minutes. ``nvcc`` comes from ``$CUDA_HOME/bin``,
``PATH`` or ``/usr/local/cuda/bin``; a missing compiler or a failed build
raises. ``-Xptxas -v`` (registers, shared memory, spills per kernel) is kept
in ``build.log`` beside the library.
"""

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PACKAGE, 'csrc')
BUILD_ROOT = os.path.join(os.path.dirname(PACKAGE), '.torch_build', 'kernels')
FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3', '-shared',
         '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_libs = {}
_lock = threading.Lock()                          # guards _locks
_locks = collections.defaultdict(threading.Lock)  # one per source: two sources build at once


def find_nvcc():
    candidates = []
    if os.environ.get('CUDA_HOME'):
        candidates.append(os.path.join(os.environ['CUDA_HOME'], 'bin', 'nvcc'))
    candidates += [shutil.which('nvcc'), '/usr/local/cuda/bin/nvcc']
    for path in candidates:
        if path and os.access(path, os.X_OK):
            return path
    raise RuntimeError('nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin): '
                       'the port\'s CUDA kernels are built from source at first use')


def library_path(source):
    """Where ``csrc/<source>`` builds to: keyed by the source's name, the
    content of every file under ``csrc/`` and the flags."""
    digest = hashlib.sha256(' '.join((source,) + FLAGS).encode())
    for root, dirs, files in os.walk(CSRC):
        dirs.sort()
        for name in sorted(files):
            path = os.path.join(root, name)
            digest.update(os.path.relpath(path, CSRC).encode() + b'\0')
            with open(path, 'rb') as f:
                digest.update(f.read())
    name = os.path.splitext(source)[0]
    return os.path.join(BUILD_ROOT, digest.hexdigest()[:16], 'lib{}.so'.format(name))


def load(source):
    """The ``ctypes.CDLL`` of ``csrc/<source>``, built first if need be."""
    with _lock:
        lock = _locks[source]
    with lock:
        if source in _libs:
            return _libs[source]
        lib_path = library_path(source)
        if not os.path.exists(lib_path):
            _compile(os.path.join(CSRC, source), lib_path)
        _libs[source] = ctypes.CDLL(lib_path)
        return _libs[source]


def _compile(src, lib_path):
    out_dir = os.path.dirname(lib_path)
    os.makedirs(out_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=out_dir)
    os.close(fd)
    cmd = [find_nvcc(), *FLAGS, '-o', tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    with open(os.path.join(out_dir, 'build.log'), 'w') as log:
        log.write(' '.join(cmd) + '\n' + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError('nvcc failed ({}) building {}:\n{}'.format(
            proc.returncode, src, proc.stderr[-4000:]))
    os.replace(tmp, lib_path)    # atomic: a concurrent loader sees all or nothing
