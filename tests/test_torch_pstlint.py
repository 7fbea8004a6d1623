"""The port's lints and runtime sanitizer against the JAX package's.

``petastorm_tpu_torch.analysis`` is the port's copy of ``petastorm_tpu.analysis``
pointed at the port: ``pstt-`` threads and its own leak-guard registry,
``PSTT_*`` variables and fault sites tabled in ``docs/torch_guide.rst``, and
the shared ``pytest.ini``. Each test mirrors one of ``tests/test_pstlint.py``.
Where the check is the same, both analyzers run on the same fixture source
and must give the same findings (check and line); the thread fixtures name
their threads ``pst-`` for the JAX analyzer and ``pstt-`` for the port's.
The seeded bugs (a stale arena view, a lock-order inversion) run against the
port's staging engine: armed they raise, unarmed the stream completes.
``test_package_tree_is_clean`` holds ``petastorm_tpu_torch/`` at zero findings.
"""

import gc
import json
import os
import queue
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

import petastorm_tpu.analysis as jax_analysis
from petastorm_tpu.analysis import bounded_queues as jax_bounded_queues
from petastorm_tpu.analysis import core as jax_core
from petastorm_tpu.analysis import determinism_taint as jax_determinism_taint
from petastorm_tpu.analysis import lock_order as jax_lock_order
from petastorm_tpu.analysis import registry_sync as jax_registry_sync
from petastorm_tpu.analysis import threads as jax_threads
from petastorm_tpu.analysis.sanitize import LockOrderRecorder as JaxLockOrderRecorder
from petastorm_tpu.analysis.sanitize import LockOrderViolation as JaxLockOrderViolation
from petastorm_tpu_torch import faults
from petastorm_tpu_torch.analysis import (bounded_queues, core, determinism_taint, lock_order,
                                          registry, registry_sync, run_checks, threads)
from petastorm_tpu_torch.analysis import sanitize as sanitize_mod
from petastorm_tpu_torch.analysis.sanitize import (LockOrderRecorder, LockOrderViolation,
                                                   StaleViewError, guard_view, sanitize_active,
                                                   tracked_lock)
from petastorm_tpu_torch.staging import ArenaPool, StagingEngine

pytestmark = pytest.mark.pstlint

_END = object()

PACKAGE_ROOT = os.path.dirname(os.path.abspath(__import__('petastorm_tpu_torch').__file__))
REPO_ROOT = os.path.dirname(PACKAGE_ROOT)
ENV = 'PSTT_SANITIZE'


def _write_pkg(tmp_path, files):
    """Materialize a mini package under tmp_path/pkg; returns its root."""
    root = tmp_path / 'pkg'
    root.mkdir(parents=True, exist_ok=True)
    (root / '__init__.py').write_text('')
    for name, body in files.items():
        (root / name).write_text(textwrap.dedent(body))
    return str(root)


def _project(tmp_path, files):
    return core.load_project(_write_pkg(tmp_path, files))


def _checks(findings, check):
    return [f for f in findings if f.check == check]


def _key(findings):
    return sorted((f.check, f.line) for f in findings)


def _both(tmp_path, files, port_mod, jax_mod, jax_files=None):
    """Run one checker of each package over the same fixture; the findings
    (check, line) must agree. Returns the port's findings (and, for the
    lock-order checker, its edges)."""
    port_project = core.load_project(_write_pkg(tmp_path / 'port', files))
    jax_project = jax_core.load_project(_write_pkg(tmp_path / 'jax', jax_files or files))
    port_out, jax_out = port_mod.check(port_project), jax_mod.check(jax_project)
    if isinstance(port_out, tuple):
        assert _key(port_out[0]) == _key(jax_out[0])
        assert sorted(port_out[1]) == sorted(jax_out[1])
    else:
        assert _key(port_out) == _key(jax_out)
    return port_out


def _suppressed_both(tmp_path, files, checks):
    """Lock-order findings after suppressions, in both packages."""
    port_project = core.load_project(_write_pkg(tmp_path / 'port', files))
    jax_project = jax_core.load_project(_write_pkg(tmp_path / 'jax', files))
    port = core.apply_suppressions(port_project, lock_order.check(port_project)[0], checks)
    jax = jax_core.apply_suppressions(jax_project, jax_lock_order.check(jax_project)[0], checks)
    assert _key(port) == _key(jax)
    return port


def _threads_both(tmp_path, body):
    """The thread checker on a fixture naming its threads ``pst-`` for the
    JAX analyzer and ``pstt-`` for the port's."""
    return _both(tmp_path, {'m.py': body.replace("'pst-", "'pstt-")}, threads, jax_threads,
                 jax_files={'m.py': body})


# ---------------------------------------------------------------------------
# suppressions
# ---------------------------------------------------------------------------

def test_suppression_silences_with_reason(tmp_path):
    findings = _suppressed_both(tmp_path, {'m.py': '''
        import threading

        class A(object):
            def __init__(self):
                self._lock = threading.Lock()

            def f(self):
                with self._lock:
                    open('/tmp/x')  # pstlint: disable=lock-order-blocking(one-time init; contended path never reaches this)
    '''}, {'lock-order-blocking', 'suppression'})
    assert findings == []


def test_suppression_without_reason_is_a_finding(tmp_path):
    findings = _suppressed_both(tmp_path, {'m.py': '''
        import threading

        class A(object):
            def __init__(self):
                self._lock = threading.Lock()

            def f(self):
                with self._lock:
                    open('/tmp/x')  # pstlint: disable=lock-order-blocking
    '''}, {'lock-order-blocking', 'suppression'})
    assert sorted(f.check for f in findings) == ['lock-order-blocking', 'suppression']


def test_unused_suppression_is_a_finding(tmp_path):
    findings = _suppressed_both(tmp_path, {'m.py': '''
        def clean():
            return 1  # pstlint: disable=lock-order-blocking(stale claim)
    '''}, {'lock-order-blocking', 'suppression'})
    assert [f.check for f in findings] == ['suppression']
    assert 'unused' in findings[0].message


def test_docstring_mention_is_not_a_suppression(tmp_path):
    findings = _suppressed_both(tmp_path, {'m.py': '''
        def documented():
            """Silence with # pstlint: disable=lock-order-blocking(reason)."""
            return 1
    '''}, {'lock-order-blocking', 'suppression'})
    assert findings == []


# ---------------------------------------------------------------------------
# lock-order checker
# ---------------------------------------------------------------------------

def test_lock_cycle_detected(tmp_path):
    findings, edges = _both(tmp_path, {'m.py': '''
        import threading

        class C(object):
            def __init__(self):
                self._alpha_lock = threading.Lock()
                self._beta_lock = threading.Lock()

            def forward(self):
                with self._alpha_lock:
                    with self._beta_lock:
                        pass

            def backward(self):
                with self._beta_lock:
                    with self._alpha_lock:
                        pass
    '''}, lock_order, jax_lock_order)
    cycles = _checks(findings, 'lock-order-cycle')
    assert len(cycles) == 1
    assert '_alpha_lock' in cycles[0].message and '_beta_lock' in cycles[0].message
    assert ('pkg.m:C._alpha_lock', 'pkg.m:C._beta_lock') in edges
    assert ('pkg.m:C._beta_lock', 'pkg.m:C._alpha_lock') in edges


def test_lock_cycle_across_modules_via_calls(tmp_path):
    findings, edges = _both(tmp_path, {
        'a.py': '''
            import threading
            from pkg import b

            class A(object):
                def __init__(self):
                    self._lock = threading.Lock()
                    self._peer = b.B(self)

                def poke(self):
                    with self._lock:
                        self._peer.ping()

                def pinged(self):
                    with self._lock:
                        pass
        ''',
        'b.py': '''
            import threading

            class B(object):
                def __init__(self, owner):
                    self._lock = threading.Lock()

                def ping(self):
                    with self._lock:
                        pass

                def poke_back(self, a_obj):
                    with self._lock:
                        call_owner(a_obj)

            def call_owner(a_obj):
                a_obj.pinged()
        '''}, lock_order, jax_lock_order)
    assert ('pkg.a:A._lock', 'pkg.b:B._lock') in edges
    assert _checks(findings, 'lock-order-cycle') == []


def test_blocking_calls_under_lock_flagged(tmp_path):
    findings, _ = _both(tmp_path, {'m.py': '''
        import queue
        import threading
        import time

        class C(object):
            def __init__(self):
                self._lock = threading.Lock()
                self._inbox = queue.Queue()
                self._cond = threading.Condition()

            def bad_put(self):
                with self._lock:
                    self._inbox.put(1)

            def bad_sleep(self):
                with self._lock:
                    time.sleep(0.1)

            def bad_join(self, t):
                with self._lock:
                    t.join()

            def ok_nowait(self):
                with self._lock:
                    self._inbox.put_nowait(1)

            def ok_cond_wait(self):
                with self._cond:
                    self._cond.wait(timeout=1)

            def bad_wait_under_outer(self):
                with self._lock:
                    with self._cond:
                        self._cond.wait()
    '''}, lock_order, jax_lock_order)
    blocking = _checks(findings, 'lock-order-blocking')
    kinds = sorted(f.message.split(' while')[0] for f in blocking)
    assert any('queue.put' in k for k in kinds)
    assert any('time.sleep' in k for k in kinds)
    assert any('join()' in k for k in kinds)
    assert any('outer lock' in f.message for f in blocking)
    lines = {f.line for f in blocking}
    ok_lines = [i for i, text in enumerate(
        (tmp_path / 'port' / 'pkg' / 'm.py').read_text().splitlines(), 1)
        if 'ok_nowait' in text or 'ok_cond_wait' in text]
    assert not any(line in lines for line in range(min(ok_lines), max(ok_lines) + 3))


def test_acquire_release_pairs_tracked(tmp_path):
    findings, _ = _both(tmp_path, {'m.py': '''
        import queue
        import threading

        class C(object):
            def __init__(self):
                self._lock = threading.Lock()
                self._q = queue.Queue()

            def explicit(self):
                self._lock.acquire()
                try:
                    self._q.put(1)
                finally:
                    self._lock.release()

            def after_release(self):
                self._lock.acquire()
                self._lock.release()
                self._q.put(1)
    '''}, lock_order, jax_lock_order)
    assert len(_checks(findings, 'lock-order-blocking')) == 1


# ---------------------------------------------------------------------------
# thread-lifecycle checker
# ---------------------------------------------------------------------------

def test_unnamed_thread_flagged(tmp_path):
    assert _checks(_threads_both(tmp_path, '''
        import threading

        def spawn():
            threading.Thread(target=print, daemon=True).start()
    '''), 'thread-name')


def test_non_pst_name_flagged(tmp_path):
    findings = _checks(_threads_both(tmp_path, '''
        import threading

        def spawn():
            threading.Thread(target=print, daemon=True,
                             name='my-worker').start()
    '''), 'thread-name')
    assert findings and 'pstt-' in findings[0].message


def test_jax_namespace_is_foreign_to_the_port(tmp_path):
    """A ``pst-`` name (the JAX package's namespace) is a finding in the
    port, which keys stack dumps and sweeps on ``pstt-``."""
    project = _project(tmp_path, {'m.py': '''
        import threading

        def spawn():
            threading.Thread(target=print, daemon=True, name='pst-autotune').start()
    '''})
    findings = _checks(threads.check(project), 'thread-name')
    assert findings and 'pstt-' in findings[0].message


def test_unregistered_prefix_flagged(tmp_path):
    findings = _checks(_threads_both(tmp_path, '''
        import threading

        def spawn():
            threading.Thread(target=print, daemon=True,
                             name='pst-never-registered').start()
    '''), 'thread-registry')
    assert findings and 'registry' in findings[0].message


def test_registered_prefix_and_param_default_resolve(tmp_path):
    assert _threads_both(tmp_path, '''
        import threading

        class T(object):
            def __init__(self, name='pst-autotune-x'):
                self._t = threading.Thread(target=print, daemon=True,
                                           name=name)
    ''') == []


def test_module_constants_and_concatenation_resolve(tmp_path):
    """The port's own resolution: a module constant of the same file, as
    the name or a parameter's default, and ``PREFIX + suffix``."""
    project = _project(tmp_path, {'m.py': '''
        import threading

        THREAD_NAME = 'pstt-autotune'
        THREAD_PREFIX = 'pstt-staging-'

        class T(object):
            def __init__(self, name=THREAD_NAME):
                self._a = threading.Thread(target=print, daemon=True, name=name)
                self._b = threading.Thread(target=print, daemon=True, name=THREAD_NAME)
                self._c = threading.Thread(target=print, daemon=True,
                                           name=THREAD_PREFIX + 'assemble')
                self._d = threading.Thread(target=print, daemon=True,
                                           name=UNKNOWN + 'x')
    '''})
    findings = threads.check(project)
    assert [(f.check, f.line) for f in findings] == [('thread-name', 13)]


def test_non_daemon_unjoined_flagged_and_joined_ok(tmp_path):
    findings = _checks(_threads_both(tmp_path, '''
        import threading

        class Bad(object):
            def spawn(self):
                self._t = threading.Thread(target=print,
                                           name='pst-autotune-b')
                self._t.start()

        class Good(object):
            def spawn(self):
                self._t = threading.Thread(target=print,
                                           name='pst-autotune-g')
                self._t.start()

            def stop(self):
                self._t.join()
    '''), 'thread-lifecycle')
    assert len(findings) == 1


def test_thread_subclass_super_init_checked(tmp_path):
    findings = _checks(_threads_both(tmp_path, '''
        import threading

        class W(threading.Thread):
            def __init__(self):
                super().__init__(daemon=True)
    '''), 'thread-name')
    assert findings and 'subclass' in findings[0].message


# ---------------------------------------------------------------------------
# determinism-taint checker
# ---------------------------------------------------------------------------

def test_direct_taint_in_marked_function(tmp_path):
    findings = _both(tmp_path, {'m.py': '''
        import time
        from petastorm_tpu_torch.determinism import deterministic_safe

        @deterministic_safe
        def order(n):
            return [time.time() for _ in range(n)]
    '''}, determinism_taint, jax_determinism_taint)
    assert findings and 'time.time' in findings[0].message


def test_transitive_taint_reported_with_chain(tmp_path):
    findings = _both(tmp_path, {'m.py': '''
        import random
        from petastorm_tpu_torch.determinism import deterministic_safe

        def helper():
            return inner()

        def inner():
            return random.random()

        @deterministic_safe
        def order(n):
            return helper()
    '''}, determinism_taint, jax_determinism_taint)
    assert findings
    assert 'call chain' in findings[0].message and 'random.random' in findings[0].message


def test_set_iteration_flagged_sorted_ok(tmp_path):
    findings = _both(tmp_path, {'m.py': '''
        from petastorm_tpu_torch.determinism import deterministic_safe

        @deterministic_safe
        def bad(items):
            return [x for x in set(items)]

        @deterministic_safe
        def good(items):
            return [x for x in sorted(set(items))]
    '''}, determinism_taint, jax_determinism_taint)
    assert len(findings) == 1 and 'PYTHONHASHSEED' in findings[0].message


def test_pure_marked_function_clean(tmp_path):
    assert _both(tmp_path, {'m.py': '''
        import hashlib
        from petastorm_tpu_torch.determinism import deterministic_safe

        @deterministic_safe
        def key(seed, epoch):
            digest = hashlib.md5('{}:{}'.format(seed, epoch).encode())
            return digest.hexdigest()
    '''}, determinism_taint, jax_determinism_taint) == []


def test_real_feistel_path_is_marked():
    from petastorm_tpu.determinism import epoch_key as jax_epoch_key
    from petastorm_tpu_torch import determinism
    for fn in (determinism.epoch_key, determinism.feistel_permute, determinism.epoch_order,
               determinism.shard_positions, determinism.order_digest):
        assert getattr(fn, '__deterministic_safe__', False), fn.__name__
    assert determinism.epoch_key(7, 3) == jax_epoch_key(7, 3)


# ---------------------------------------------------------------------------
# registry-sync checker (the port's table is docs/torch_guide.rst)
# ---------------------------------------------------------------------------

def _mini_repo(tmp_path, env_reads=('PSTT_DEMO',), env_docs=('PSTT_DEMO',),
               marker_used='slow', marker_registered='slow'):
    repo = tmp_path / 'repo'
    pkg = repo / 'pkg'
    pkg.mkdir(parents=True)
    (pkg / '__init__.py').write_text('')
    body = 'import os\n' + ''.join(
        "V_{i} = os.environ.get('{v}')\n".format(i=i, v=v) for i, v in enumerate(env_reads))
    (pkg / 'mod.py').write_text(body)
    docs = repo / 'docs'
    docs.mkdir()
    rows = ''.join('``{}``  x\n'.format(v) for v in env_docs)
    (docs / 'torch_guide.rst').write_text(
        'Guide\n=====\n\n.. begin-env-table\n\n' + rows + '\n.. end-env-table\n')
    tests = repo / 'tests'
    tests.mkdir()
    (tests / 'test_x.py').write_text(
        'import pytest\n\n@pytest.mark.{}\ndef test_a():\n    pass\n'.format(marker_used))
    (repo / 'pytest.ini').write_text(
        '[pytest]\nmarkers =\n    {}: something\n'.format(marker_registered))
    return str(pkg)


def test_registry_env_docstring_mention_is_not_a_read_site(tmp_path):
    pkg = _mini_repo(tmp_path, env_docs=('PSTT_DEMO', 'PSTT_GHOST'))
    with open(os.path.join(pkg, 'ghost.py'), 'w') as f:
        f.write('"""Mentions PSTT_GHOST but never reads it."""\n\n'
                'def noop():\n    """Also mentions PSTT_GHOST."""\n')
    findings = _checks(registry_sync.check(core.load_project(pkg)), 'registry-env')
    assert any('PSTT_GHOST' in f.message and 'no reading source site' in f.message
               for f in findings)


def test_registry_env_two_way(tmp_path):
    assert _checks(registry_sync.check(core.load_project(_mini_repo(tmp_path))),
                   'registry-env') == []
    project = core.load_project(_mini_repo(tmp_path / 'a', env_reads=('PSTT_DEMO', 'PSTT_SECRET')))
    findings = _checks(registry_sync.check(project), 'registry-env')
    assert findings and 'PSTT_SECRET' in findings[0].message
    project = core.load_project(_mini_repo(tmp_path / 'b', env_docs=('PSTT_DEMO', 'PSTT_GONE')))
    findings = _checks(registry_sync.check(project), 'registry-env')
    assert findings and 'PSTT_GONE' in findings[0].message


def test_registry_env_ignores_the_jax_variables(tmp_path):
    """The port's table holds ``PSTT_*`` only: a ``PETASTORM_TPU_*`` literal
    is the JAX lint's business, and a ``PSTT_*`` one is foreign to it."""
    pkg = _mini_repo(tmp_path, env_reads=('PSTT_DEMO', 'PETASTORM' + '_TPU_OTHER'))
    assert _checks(registry_sync.check(core.load_project(pkg)), 'registry-env') == []
    jax_findings = _checks(jax_registry_sync.check(jax_core.load_project(pkg)), 'registry-env')
    assert not any('PSTT_DEMO' in f.message for f in jax_findings)


def test_registry_marker_two_way(tmp_path):
    project = core.load_project(_mini_repo(tmp_path, marker_used='mystery'))
    findings = _checks(registry_sync.check(project), 'registry-marker')
    assert findings and 'mystery' in findings[0].message
    project = core.load_project(_mini_repo(tmp_path / 'c', marker_registered='dead'))
    findings = _checks(registry_sync.check(project), 'registry-marker')
    assert any('dead' in f.message for f in findings)


def test_undeclared_fault_site_flagged(tmp_path):
    pkg = _mini_repo(tmp_path)
    with open(os.path.join(pkg, 'faults.py'), 'w') as f:
        f.write("KNOWN_SITES = ('real-site',)\n"
                "def maybe_inject(site, key=None):\n    pass\n")
    with open(os.path.join(pkg, 'user.py'), 'w') as f:
        f.write("from pkg.faults import maybe_inject\n"
                "def go():\n    maybe_inject('typo-site')\n")
    findings = _checks(registry_sync.check(core.load_project(pkg)), 'registry-fault')
    assert any('typo-site' in f.message for f in findings)
    assert any("'real-site' is not documented" in f.message for f in findings)


def test_unknown_fault_site_rejected_at_parse():
    with pytest.raises(ValueError, match='unknown fault site'):
        faults.FaultSpec.parse('definitely-not-a-site:p=0.5')
    spec = faults.FaultSpec.parse('arena-stale-view:max=1')
    assert spec.site == 'arena-stale-view'
    assert spec.max_fires == 1


# ---------------------------------------------------------------------------
# the leak-guard registry itself
# ---------------------------------------------------------------------------

def test_registry_dir_prefixes_match_module_constants():
    from petastorm_tpu_torch.chunk_store import TEMP_DIR_PREFIX as chunk_prefix
    from petastorm_tpu_torch.fleet.wire import SEGMENT_PREFIX as wire_prefix
    from petastorm_tpu_torch.flight_recorder import DUMP_DIR_PREFIX as dump_prefix
    from petastorm_tpu_torch.lineage import TEMP_DIR_PREFIX as lineage_prefix
    patterns = {p for g in registry.DIR_GUARDS for p in g.patterns}
    for prefix in (chunk_prefix, lineage_prefix, dump_prefix, wire_prefix):
        assert prefix + '*' in patterns, prefix


def test_registry_thread_prefixes_cover_live_thread_names():
    from petastorm_tpu_torch import autotune, health, lineage, membudget, metrics
    from petastorm_tpu_torch.chunk_store import WRITER_THREAD_NAME as chunk_writer
    from petastorm_tpu_torch.staging import THREAD_PREFIX as staging_prefix
    from petastorm_tpu_torch.workers import process_pool, thread_pool, ventilator
    prefixes = registry.thread_prefixes()
    for name in (autotune.THREAD_NAME, metrics.THREAD_NAME, lineage.WRITER_THREAD_NAME,
                 chunk_writer, ventilator.THREAD_NAME, staging_prefix + 'assemble',
                 'pstt-data-service-serve', thread_pool.THREAD_PREFIX + '3',
                 process_pool.ORPHAN_WATCH_THREAD, membudget.THREAD_NAME, health.THREAD_NAME):
        assert any(name.startswith(p) for p in prefixes), name
    for guard in registry.THREAD_GUARDS:
        assert guard.prefix.startswith('pstt-')
        assert guard.action in ('fail', 'note')
        assert guard.rationale


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _run_cli(*args, module='petastorm_tpu_torch.tools.pstlint'):
    return subprocess.run([sys.executable, '-m', module] + list(args),
                          capture_output=True, text=True, cwd=REPO_ROOT, timeout=300)


def test_cli_clean_tree_exits_zero():
    result = _run_cli('petastorm_tpu_torch/')
    assert result.returncode == 0, result.stdout + result.stderr
    assert 'clean' in result.stdout
    result = _run_cli()     # the default root is the port's package
    assert result.returncode == 0, result.stdout + result.stderr
    assert 'petastorm_tpu_torch' in result.stdout


def test_cli_findings_exit_nonzero_and_render(tmp_path):
    pkg = _write_pkg(tmp_path, {'m.py': '''
        import threading

        def spawn():
            threading.Thread(target=print, daemon=True).start()
    '''})
    result = _run_cli(pkg, '--check', 'threads')
    assert result.returncode == 1
    assert '[thread-name]' in result.stdout
    result_json = _run_cli(pkg, '--check', 'threads', '--format', 'json')
    assert result_json.returncode == 1
    payload = json.loads(result_json.stdout)
    jax_payload = json.loads(_run_cli(pkg, '--check', 'threads', '--format', 'json',
                                      module='petastorm_tpu.tools.pstlint').stdout)
    assert [(f['check'], f['line']) for f in payload] == \
        [(f['check'], f['line']) for f in jax_payload] == [('thread-name', 5)]


def test_cli_list_checks_and_bad_path():
    listed = _run_cli('--list-checks').stdout.split()
    assert listed == list(jax_analysis.CHECKS)
    assert _run_cli('/nonexistent/path').returncode == 2
    assert _run_cli('petastorm_tpu_torch/', '--check', 'bogus').returncode == 2


def test_cli_emit_lock_graph(tmp_path):
    out = str(tmp_path / 'graph.json')
    result = _run_cli('petastorm_tpu_torch/', '--check', 'lock-order', '--emit-lock-graph', out)
    assert result.returncode == 0, result.stdout + result.stderr
    edges = json.load(open(out))
    assert edges and all(len(edge) == 2 for edge in edges)
    assert all(a.startswith('petastorm_tpu_torch.') for a, _ in edges)


def test_cli_emit_lock_graph_implies_lock_order_check(tmp_path):
    pkg = _write_pkg(tmp_path, {'m.py': '''
        import threading

        class C(object):
            def __init__(self):
                self._outer_lock = threading.Lock()
                self._inner_lock = threading.Lock()

            def nested(self):
                with self._outer_lock:
                    with self._inner_lock:
                        pass
    '''})
    out = str(tmp_path / 'graph.json')
    result = _run_cli(pkg, '--check', 'threads', '--emit-lock-graph', out)
    assert result.returncode == 0, result.stdout + result.stderr
    assert ['pkg.m:C._outer_lock', 'pkg.m:C._inner_lock'] in json.load(open(out))


# ---------------------------------------------------------------------------
# the tier-1 gate: the port's tree is clean
# ---------------------------------------------------------------------------

def test_package_tree_is_clean():
    """The full analyzer over ``petastorm_tpu_torch/`` reports nothing: every
    violation is fixed or carries a reasoned suppression, and no
    suppression is unexplained or stale."""
    findings, _ = run_checks([PACKAGE_ROOT])
    rendered = '\n'.join(f.render(relative_to=REPO_ROOT) for f in findings)
    assert not findings, 'pstlint findings on the port tree:\n' + rendered


def test_the_port_tree_holds_every_variable_it_reads_in_its_own_table():
    """The 20 ``PSTT_*`` variables the port reads are the rows of
    ``docs/torch_guide.rst``, and the JAX table is left alone."""
    project = core.load_project(PACKAGE_ROOT)
    read = set(registry_sync._source_env_vars(project))
    documented, _ = registry_sync._documented_env_vars(
        os.path.join(REPO_ROOT, 'docs', 'torch_guide.rst'))
    assert read == documented and len(read) == 20 and 'PSTT_SANITIZE' in read
    jax_documented, _ = jax_registry_sync._documented_env_vars(
        os.path.join(REPO_ROOT, 'docs', 'tpu_guide.rst'))
    assert not any(v.startswith('PSTT_') for v in jax_documented)


# ---------------------------------------------------------------------------
# runtime sanitizer: guarded views + poison
# ---------------------------------------------------------------------------

class _Src(object):
    view_epoch = 0


def test_guard_view_unarmed_is_passthrough(monkeypatch):
    monkeypatch.delenv(ENV, raising=False)
    buf = np.zeros(4)
    assert guard_view(buf, _Src()) is buf
    assert not sanitize_active()


@pytest.mark.parametrize('value, armed', [('1', True), ('true', True), ('on', True),
                                          ('0', False), ('off', False), ('no', False),
                                          ('', False)])
def test_sanitize_env_uses_the_jax_grammar(monkeypatch, value, armed):
    from petastorm_tpu.analysis import sanitize as jax_sanitize
    monkeypatch.setenv(ENV, value)
    monkeypatch.setenv(jax_sanitize.ENV_VAR, value)
    assert sanitize_active() is armed
    assert jax_sanitize.sanitize_active() is armed


def test_guarded_view_raises_at_touch_after_reclaim(monkeypatch):
    monkeypatch.setenv(ENV, '1')
    src = _Src()
    view = guard_view(np.arange(12, dtype=np.float32).reshape(4, 3), src)
    np.copyto(view[:2], np.ones((2, 3), np.float32))
    view[2] = 5
    assert view.sum() > 0
    src.view_epoch += 1
    for touch in (lambda: view.sum(), lambda: view[0],
                  lambda: view + 1, lambda: np.copyto(view, 0.0)):
        with pytest.raises(StaleViewError):
            touch()


def _pool(depth):
    return ArenaPool(depth, threading.Event(), pinned=False)


def test_arena_reclaim_poisons_and_stales_views(monkeypatch):
    monkeypatch.setenv(ENV, '1')
    pool = _pool(1)
    bufs = pool.get_buffers({'x': ((2, 3), np.dtype(np.float32))})
    arena = pool.claim_pending()
    view = bufs['x']
    np.copyto(view, np.ones((2, 3), np.float32))
    raw = arena.buffers['x']
    assert arena.owns('x', view) and arena.owns('x', raw)
    arena.retire()
    with pytest.raises(StaleViewError):
        view.sum()
    assert (raw.view(np.uint8) == 0xCB).all()


def test_an_unsettled_reclaim_stales_views_but_never_poisons(monkeypatch):
    """The stop path retires an arena whose copy to the card may still be
    in flight: the epoch moves (views go stale) but the bytes stay, or the
    card would copy 0xCB."""
    monkeypatch.setenv(ENV, '1')
    pool = _pool(1)
    view = pool.get_buffers({'x': ((2, 3), np.dtype(np.uint8))})['x']
    arena = pool.claim_pending()
    np.copyto(view, np.full((2, 3), 7, np.uint8))
    before = sanitize_mod.counters()['poisoned']
    arena.retire(settled=False)
    with pytest.raises(StaleViewError):
        view.sum()
    assert (arena.buffers['x'] == 7).all()
    assert sanitize_mod.counters()['poisoned'] == before


def test_torch_tensors_over_an_arena_hold_it_instead_of_a_guard(monkeypatch):
    """On the CPU a staged tensor aliases its arena (``torch.from_numpy``),
    and no numpy guard sees a touch through it. It cannot be stale: the
    tensor holds the arena (holds mode), so the reclaim, and with it the
    poison, waits until the tensor is collected."""
    monkeypatch.setenv(ENV, '1')
    pool = _pool(1)
    view = pool.get_buffers({'x': ((2, 3), np.dtype(np.float32))})['x']
    arena = pool.claim_pending()
    np.copyto(view, np.full((2, 3), 3.0, np.float32))
    tensor = torch.from_numpy(view)
    assert not isinstance(tensor, np.ndarray)
    arena.add_hold(tensor)
    arena.retire()
    assert arena.view_epoch == 0
    assert float(tensor.sum()) == 18.0
    assert view.sum() == 18.0           # still live: nothing was reclaimed
    del tensor
    gc.collect()
    assert arena.view_epoch == 1
    assert (arena.buffers['x'].view(np.uint8) == 0xCB).all()
    with pytest.raises(StaleViewError):
        view.sum()


def test_loader_batches_from_arenas_equal_unarmed_and_poison_on_reclaim(monkeypatch, tmp_path):
    """Armed end to end on the CPU: a row reader collates into arenas, the
    batches equal the unarmed ones, and arenas are poisoned as they come
    back."""
    from petastorm_tpu_torch import (NdarrayCodec, ScalarCodec, TorchLoader, Unischema,
                                     UnischemaField, make_reader, write_dataset)
    schema = Unischema('S', [UnischemaField('id', np.int32, (), ScalarCodec(np.int32)),
                             UnischemaField('vec', np.float32, (3,), NdarrayCodec())])
    url = 'file://' + str(tmp_path / 'store')
    write_dataset(url, schema, ({'id': i, 'vec': np.full(3, i, np.float32)} for i in range(48)),
                  rows_per_row_group=8)

    def epoch(prefetch):
        with make_reader(url, workers_count=1, shuffle_row_groups=False,
                         reader_pool_type='thread') as reader:
            with TorchLoader(reader, 8, device='cpu', prefetch=prefetch, arena_depth=2,
                             watchdog=True, stall_timeout_s=60) as loader:
                out = [{name: getattr(b, name).clone() for name in ('id', 'vec')}
                       for b in loader]
        gc.collect()
        return out

    monkeypatch.delenv(ENV, raising=False)
    unarmed = epoch(2)
    for prefetch in (2, 0):
        monkeypatch.setenv(ENV, '1')
        sanitize_mod.reset_counters()
        armed = epoch(prefetch)
        assert len(armed) == len(unarmed) == 6
        for a, u in zip(armed, unarmed):
            assert all(torch.equal(a[k], u[k]) for k in a)
        counts = sanitize_mod.counters()
        assert counts['poisoned'] > 0, counts
        assert counts['acquisitions'] > 0 and counts['violations'] == 0, counts


def _run_engine(pool, spec, n_batches=4):
    """Drive the port's StagingEngine (holds_mode=False: a retire reclaims
    at once) and return everything delivered before the end sentinel."""
    def host_iter():
        for i in range(n_batches):
            bufs = pool.get_buffers(spec)
            np.copyto(bufs['x'], np.full((2, 3), i, np.float32))
            yield {'x': bufs['x']}

    out = queue.Queue(maxsize=16)
    stop = threading.Event()
    engine = StagingEngine(iter(host_iter()), lambda b, arena: b, out, stop, _END,
                           pool=pool, inflight=1, holds_mode=False).start()
    delivered = []
    try:
        while True:
            item = out.get(timeout=30)
            delivered.append(item)
            if item is _END or isinstance(item, Exception):
                break
    finally:
        engine.stop()
    return delivered


def _engine_pool():
    return _pool(2)


def test_seeded_use_after_reclaim_raises_when_armed(monkeypatch):
    monkeypatch.setenv(ENV, '1')
    monkeypatch.setenv(faults.ENV_VAR, 'arena-stale-view:max=1')
    delivered = _run_engine(_engine_pool(), {'x': ((2, 3), np.dtype(np.float32))})
    assert isinstance(delivered[-1], StaleViewError), delivered[-1]


def test_seeded_use_after_reclaim_silent_when_unarmed(monkeypatch):
    monkeypatch.delenv(ENV, raising=False)
    monkeypatch.setenv(faults.ENV_VAR, 'arena-stale-view:max=1')
    delivered = _run_engine(_engine_pool(), {'x': ((2, 3), np.dtype(np.float32))})
    assert delivered[-1] is _END
    assert len(delivered) == 5


# ---------------------------------------------------------------------------
# runtime sanitizer: lock-order recorder
# ---------------------------------------------------------------------------

_NESTED = '''
    import threading

    class C(object):
        def __init__(self):
            self._outer_lock = threading.Lock()
            self._inner_lock = threading.Lock()

        def nested(self):
            with self._outer_lock:
                with self._inner_lock:
                    pass
'''


def test_recorder_flags_inversion_and_matches_static_graph(tmp_path):
    _, edges = _both(tmp_path, {'m.py': _NESTED}, lock_order, jax_lock_order)
    assert ('pkg.m:C._outer_lock', 'pkg.m:C._inner_lock') in edges
    outer, inner = 'pkg.m:C._outer_lock', 'pkg.m:C._inner_lock'
    for recorder_cls, violation_cls in ((LockOrderRecorder, LockOrderViolation),
                                        (JaxLockOrderRecorder, JaxLockOrderViolation)):
        recorder = recorder_cls(static_edges=edges)
        for _ in range(2):
            recorder.on_acquire(outer)
            recorder.on_acquire(inner)
            recorder.on_release(inner)
            recorder.on_release(outer)
        assert recorder.violations() == []
        recorder.on_acquire(inner)
        with pytest.raises(violation_cls):
            recorder.on_acquire(outer)
        assert recorder.violations()


def test_tracked_lock_records_edges_when_armed(monkeypatch):
    monkeypatch.setenv(ENV, '1')
    recorder = LockOrderRecorder()
    a = tracked_lock('t-lock-a', recorder=recorder)
    b = tracked_lock('t-lock-b', recorder=recorder)
    with a:
        with b:
            pass
    assert ('t-lock-a', 't-lock-b') in recorder.edges()
    b.acquire()
    with pytest.raises(LockOrderViolation):
        a.acquire()
    b.release()
    assert not b.locked()


def test_recorder_transitive_and_deep_stack_inversions():
    for cls in (LockOrderRecorder, JaxLockOrderRecorder):
        recorder = cls(mode='record')
        for name in ('a', 'b', 'c'):
            recorder.on_acquire(name)
        for name in ('c', 'b', 'a'):
            recorder.on_release(name)
        assert recorder.violations() == []
        recorder.on_acquire('c')
        recorder.on_acquire('a')
        assert recorder.violations(), 'transitive inversion missed'
        recorder2 = cls(mode='record', static_edges=[('d', 'a')])
        recorder2.on_acquire('a')
        recorder2.on_acquire('unrelated')
        recorder2.on_acquire('d')
        assert recorder2.violations(), 'non-top-of-stack inversion missed'


def test_tracked_lock_trylock_never_raises(monkeypatch):
    monkeypatch.setenv(ENV, '1')
    recorder = LockOrderRecorder()
    a = tracked_lock('try-a', recorder=recorder)
    b = tracked_lock('try-b', recorder=recorder)
    with a:
        with b:
            pass
    b.acquire()
    assert a.acquire(blocking=False)
    a.release()
    b.release()
    assert recorder.violations() == []
    b.acquire()
    with pytest.raises(LockOrderViolation):
        a.acquire()
    b.release()


def test_tracked_lock_under_a_condition(monkeypatch):
    """A Condition over a tracked lock waits and notifies through the
    recorder: the held stack is empty while waiting, and nothing is
    flagged."""
    monkeypatch.setenv(ENV, '1')
    recorder = LockOrderRecorder()
    lock = tracked_lock('cond-lock', recorder=recorder)
    cond = threading.Condition(lock)
    ready = []

    def producer():
        with cond:
            ready.append(1)
            cond.notify_all()

    with cond:
        assert cond._is_owned()
        t = threading.Thread(target=producer, name='pstt-test-producer', daemon=True)
        t.start()
        assert cond.wait_for(lambda: ready, timeout=10)
        assert recorder.held() == ('cond-lock',)
    t.join(10)
    assert not lock.locked() and recorder.held() == ()
    assert recorder.violations() == []


def test_canary_pair_tracks_armed_state_flips(monkeypatch):
    monkeypatch.setattr(sanitize_mod, '_inversion_pair', None)
    monkeypatch.setattr(sanitize_mod, '_recorder', None)
    monkeypatch.setenv(faults.ENV_VAR, 'lock-order-invert')
    monkeypatch.delenv(ENV, raising=False)
    sanitize_mod.maybe_inject_lock_inversion()
    monkeypatch.setenv(ENV, '1')
    with pytest.raises(LockOrderViolation):
        sanitize_mod.maybe_inject_lock_inversion()
    assert sanitize_mod.counters()['edges'] == 1
    monkeypatch.delenv(ENV, raising=False)
    sanitize_mod.maybe_inject_lock_inversion()


def test_tracked_lock_unarmed_is_plain_lock(monkeypatch):
    monkeypatch.delenv(ENV, raising=False)
    assert isinstance(tracked_lock('whatever'), type(threading.Lock()))


def test_the_four_tracked_sites_follow_the_arming(monkeypatch):
    """The JAX package's four tracked locks are tracked in the port too,
    under the static graph's node names."""
    from petastorm_tpu_torch import health, lineage, membudget, metrics
    monkeypatch.setenv(ENV, '1')
    built = {'health': health.HeartbeatRegistry()._lock,
             'metrics': metrics.MetricsRegistry()._lock,
             'lineage': lineage.LineageTracker({})._lock,
             'membudget': membudget.MemoryGovernor(budget=1 << 30)._lock}
    for module, lock in built.items():
        assert isinstance(lock, sanitize_mod.TrackedLock), module
        assert lock.name.startswith('petastorm_tpu_torch.{}:'.format(module))
    monkeypatch.delenv(ENV, raising=False)
    assert not isinstance(health.HeartbeatRegistry()._lock, sanitize_mod.TrackedLock)


def test_tracked_lock_disarming_mid_process_silences(monkeypatch):
    monkeypatch.setenv(ENV, '1')
    recorder = LockOrderRecorder()
    a = tracked_lock('disarm-a', recorder=recorder)
    b = tracked_lock('disarm-b', recorder=recorder)
    with a:
        with b:
            pass
    monkeypatch.delenv(ENV, raising=False)
    with b:
        with a:
            pass
    assert recorder.violations() == []


def test_seeded_lock_inversion_raises_when_armed(monkeypatch):
    monkeypatch.setenv(ENV, '1')
    monkeypatch.setenv(faults.ENV_VAR, 'lock-order-invert:max=1')
    monkeypatch.setattr(sanitize_mod, '_inversion_pair', None)
    monkeypatch.setattr(sanitize_mod, '_recorder', None)
    delivered = _run_engine(_engine_pool(), {'x': ((2, 3), np.dtype(np.float32))})
    assert isinstance(delivered[-1], LockOrderViolation), delivered[-1]


def test_seeded_lock_inversion_silent_when_unarmed(monkeypatch):
    monkeypatch.delenv(ENV, raising=False)
    monkeypatch.setenv(faults.ENV_VAR, 'lock-order-invert:max=1')
    monkeypatch.setattr(sanitize_mod, '_inversion_pair', None)
    delivered = _run_engine(_engine_pool(), {'x': ((2, 3), np.dtype(np.float32))})
    assert delivered[-1] is _END


# ---------------------------------------------------------------------------
# bounded-queues checker
# ---------------------------------------------------------------------------

def test_bounded_queues_flags_unbounded_constructions(tmp_path):
    findings = _both(tmp_path, {'m.py': '''
        import queue
        from queue import LifoQueue
        from queue import Queue as Q

        a = queue.Queue()
        b = LifoQueue()
        c = Q()
        d = queue.Queue(maxsize=0)      # the stdlib "infinite" spelling
        e = queue.Queue(maxsize=-1)     # ...and its negative spelling
        f = queue.SimpleQueue()         # can never be bounded
    '''}, bounded_queues, jax_bounded_queues)
    assert len(findings) == 6
    assert all(f.check == 'bounded-queues' for f in findings)
    assert any('SimpleQueue' in f.message for f in findings)


def test_bounded_queues_accepts_explicit_bounds(tmp_path):
    assert _both(tmp_path, {'m.py': '''
        import queue
        from queue import Queue

        DEPTH = 16
        a = queue.Queue(maxsize=5)
        b = queue.Queue(50)                  # positional counts too
        c = Queue(maxsize=DEPTH)             # named bound counts
        d = queue.Queue(maxsize=max(1, DEPTH))
        e = queue.PriorityQueue(maxsize=2)
        not_a_queue = dict(maxsize=0)
    '''}, bounded_queues, jax_bounded_queues) == []


def test_bounded_queues_suppression_needs_reason(tmp_path):
    project = _project(tmp_path, {'m.py': '''
        import queue
        a = queue.Queue()  # pstlint: disable=bounded-queues(drained every tick by the owner loop; growth bounded by tick items)
        b = queue.Queue()  # pstlint: disable=bounded-queues
    '''})
    findings = core.apply_suppressions(project, bounded_queues.check(project),
                                       {'bounded-queues', 'suppression'})
    assert sorted(f.check for f in findings) == ['bounded-queues', 'suppression']


def test_bounded_queues_in_driver_and_cli():
    from petastorm_tpu_torch import analysis
    assert 'bounded-queues' in analysis.CHECKS
    assert 'bounded-queues' in _run_cli('--list-checks').stdout


def test_thread_pool_ventilation_queue_sized_from_window():
    """The port's ThreadPool sizes its ventilation queue to the
    ventilator's in-flight window when it starts (before, it has none)."""
    from petastorm_tpu_torch.workers.thread_pool import ThreadPool
    from petastorm_tpu_torch.workers.ventilator import ConcurrentVentilator

    class _NopWorker(object):
        def __init__(self, worker_id, publish_func, args):
            self.worker_id = worker_id

        def initialize(self):
            pass

        def process(self, **kw):
            pass

        def shutdown(self):
            pass

    pool = ThreadPool(1)
    assert pool._ventilator_queue is None
    ventilator = ConcurrentVentilator(None, [{'value': i} for i in range(9)], iterations=1,
                                      max_ventilation_queue_size=3)
    pool.start(_NopWorker, None, ventilator)
    try:
        assert pool._ventilator_queue.maxsize == 3
        while True:
            try:
                pool.get_results()
            except Exception:  # noqa: BLE001 - EmptyResultError ends the epoch
                break
    finally:
        pool.stop()
        pool.join()
