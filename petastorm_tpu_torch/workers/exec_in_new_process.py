"""Run a Python callable in a brand-new interpreter (counterpart of
``petastorm_tpu/workers/exec_in_new_process.py:17-58``).

The callable and its arguments are pickled to a temporary file and a fresh
``python -m petastorm_tpu_torch.workers.exec_in_new_process <file>`` loads
and calls them. Spawning, never forking, keeps the parent's state out of
the workers: its threads, its CUDA context, its imported ``torch``. The
package's names resolve lazily, so a worker imports only what its
callable's pickle names.

The pickler is ``dill`` where it imports (as in the JAX package: it
carries lambdas and closures), else the standard library's ``pickle``.
What the latter cannot carry (a lambda in an ``in_lambda`` predicate or a
``TransformSpec``) raises a ``TypeError`` naming ``dill``: it never falls
back to threads. :func:`dumps` and :func:`loads` are the same choice for
the pools' work items.
"""

import os
import pickle
import subprocess
import sys
import tempfile

try:
    import dill
except ImportError:
    dill = None

#: The pickler in use: ``'dill'`` or ``'pickle'``.
PICKLER = 'dill' if dill is not None else 'pickle'


def dumps(obj):
    """``obj`` pickled by :data:`PICKLER`; ``TypeError`` naming ``dill``
    when the standard library's pickle cannot carry it."""
    if dill is not None:
        return dill.dumps(obj, recurse=False)
    try:
        return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    except (pickle.PicklingError, AttributeError, TypeError) as e:
        raise TypeError(
            'a process pool must pickle {!r} for its workers, and the standard library\'s '
            'pickle cannot ({}); install dill, which carries lambdas and closures, or pass '
            'module-level functions'.format(_short(obj), e)) from e


def loads(data):
    return (dill if dill is not None else pickle).loads(data)


def _short(obj):
    text = repr(obj)
    return text if len(text) <= 160 else text[:157] + '...'


def exec_in_new_process(func, *args, **kwargs):
    """Launch ``func(*args, **kwargs)`` in a new Python process; returns
    its ``subprocess.Popen``."""
    payload = dumps((func, args, kwargs))
    fd, payload_path = tempfile.mkstemp(suffix='.pstt-worker')
    with os.fdopen(fd, 'wb') as f:
        # sys.path first, applied before the callable's record resolves its
        # imports (classes of test modules, uninstalled checkouts).
        pickle.dump({'pickler': PICKLER, 'sys_path': list(sys.path)}, f)
        f.write(payload)
    env = dict(os.environ)
    parent_paths = [p for p in sys.path if p]
    if env.get('PYTHONPATH'):
        parent_paths.append(env['PYTHONPATH'])
    env['PYTHONPATH'] = os.pathsep.join(parent_paths)
    return subprocess.Popen(
        [sys.executable, '-m', 'petastorm_tpu_torch.workers.exec_in_new_process', payload_path],
        close_fds=True, env=env)


def _main():
    payload_path = sys.argv[1]
    with open(payload_path, 'rb') as f:
        header = pickle.load(f)
        for entry in reversed(header['sys_path']):
            if entry not in sys.path:
                sys.path.insert(0, entry)
        payload = f.read()
    try:
        os.unlink(payload_path)
    except OSError:
        pass
    if header['pickler'] == 'dill':
        import dill as pickler
    else:
        pickler = pickle
    func, args, kwargs = pickler.loads(payload)
    func(*args, **kwargs)


if __name__ == '__main__':
    _main()
