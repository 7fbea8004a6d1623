"""Determinism-taint checker (``det-taint``).

``deterministic=True`` promises the batch stream is a pure function of
``(dataset, schema, seed, epoch, position)`` — the determinism tests hold it
bit-identical
across restarts, worker counts, and reshards. That proof survives only as
long as nothing nondeterministic leaks into the order-defining code:
wall-clock reads, RNG draws without pinned state, and set-iteration order
(randomized per process by PYTHONHASHSEED for str keys) would all desync
hosts that must agree.

Functions carrying the :func:`petastorm_tpu_torch.determinism.deterministic_safe`
marker (the Feistel permutation path, epoch ordering, shard striding,
digest computation) are therefore checked — **transitively through the
project call graph** — for taint sources:

* ``time.time`` / ``time.time_ns`` / ``datetime.now`` / ``time.monotonic``
* ``random.*`` module draws and ``np.random.*`` global-state draws
  (``np.random.default_rng(seed)`` / ``Generator`` methods on an explicit
  generator object are fine — state is pinned by the caller)
* ``os.urandom`` / ``uuid.uuid1`` / ``uuid.uuid4`` / ``secrets.*``
* iteration over a ``set`` literal, ``set()`` call, or set comprehension
  (``sorted(...)`` of one is fine — sorting launders the order)

A transitive report names the call chain so the fix site is obvious. An
intentional exception (e.g. a debug-only timestamp that never reaches the
order) needs a ``# pstlint: disable=det-taint(reason)`` on the source
line.
"""

import ast

from petastorm_tpu_torch.analysis.core import Finding

CHECK = 'det-taint'

MARKER_NAME = 'deterministic_safe'

_TIME_TAINT = {('time', 'time'), ('time', 'time_ns'), ('time', 'monotonic'),
               ('time', 'perf_counter'), ('datetime', 'now'),
               ('datetime', 'utcnow')}
_RANDOM_MODULES = {'random'}
_NP_ALIASES = {'numpy'}
_MISC_TAINT = {('os', 'urandom'), ('uuid', 'uuid1'), ('uuid', 'uuid4')}


def _marker_decorated(fn):
    for dec in fn.node.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        if isinstance(target, ast.Name) and target.id == MARKER_NAME:
            return True
        if isinstance(target, ast.Attribute) and target.attr == MARKER_NAME:
            return True
    return False


def _resolve_module_alias(source, name):
    return source.import_aliases.get(name, name)


def _direct_taints(fn):
    """[(line, description)] of taint sources used directly in ``fn``."""
    source = fn.source
    taints = []
    for node in ast.walk(fn.node):
        if isinstance(node, ast.Call):
            desc = _call_taint(node, source)
            if desc:
                taints.append((node.lineno, desc))
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            desc = _set_iter_taint(node.iter, source)
            if desc:
                taints.append((node.iter.lineno, desc))
        elif isinstance(node, ast.comprehension):
            desc = _set_iter_taint(node.iter, source)
            if desc:
                taints.append((node.iter.lineno, desc))
    return taints


def _call_taint(call, source):
    func = call.func
    if not isinstance(func, ast.Attribute):
        return None
    # one- and two-level receivers: time.time(), np.random.shuffle()
    if isinstance(func.value, ast.Name):
        mod = _resolve_module_alias(source, func.value.id)
        if (mod, func.attr) in _TIME_TAINT or (mod, func.attr) in _MISC_TAINT:
            return '{}.{}()'.format(mod, func.attr)
        if mod in _RANDOM_MODULES and not func.attr.startswith('_'):
            if func.attr in ('Random', 'SystemRandom'):
                # Seeded private stream construction is the sanctioned
                # pattern (state pinned by the caller's seed argument).
                return None if call.args or call.keywords else \
                    'random.{}() with no seed'.format(func.attr)
            return 'random.{}() (process-global RNG state)'.format(func.attr)
        if mod == 'secrets':
            return 'secrets.{}()'.format(func.attr)
        return None
    if isinstance(func.value, ast.Attribute) \
            and isinstance(func.value.value, ast.Name):
        mod = _resolve_module_alias(source, func.value.value.id)
        if mod in _NP_ALIASES and func.value.attr == 'random':
            if func.attr in ('default_rng', 'Generator', 'SeedSequence',
                             'PCG64'):
                return None   # explicit-state construction: caller pins it
            return 'np.random.{}() (global numpy RNG state)'.format(func.attr)
    return None


def _set_iter_taint(iter_expr, source):
    expr = iter_expr
    # enumerate(X) / list(X) wrappers do not launder order; sorted() does.
    while isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name) \
            and expr.func.id in ('enumerate', 'list', 'tuple', 'iter',
                                 'reversed') and expr.args:
        expr = expr.args[0]
    if isinstance(expr, (ast.Set, ast.SetComp)):
        return 'iteration over a set {} — order varies with '\
            'PYTHONHASHSEED; sort it first'.format(
                'literal' if isinstance(expr, ast.Set) else 'comprehension')
    if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name) \
            and expr.func.id in ('set', 'frozenset'):
        return 'iteration over set(...) — order varies with '\
            'PYTHONHASHSEED; sort it first'
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, (ast.BitOr,
                                                            ast.BitAnd,
                                                            ast.Sub)):
        left = _set_iter_taint_shallow(expr.left)
        right = _set_iter_taint_shallow(expr.right)
        if left or right:
            return 'iteration over a set expression — order varies with '\
                'PYTHONHASHSEED; sort it first'
    return None


def _set_iter_taint_shallow(expr):
    return isinstance(expr, (ast.Set, ast.SetComp)) or (
        isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name)
        and expr.func.id in ('set', 'frozenset'))


def check(project):
    findings = []
    direct = {qual: _direct_taints(fn)
              for qual, fn in project.functions.items()}
    # Call graph (resolved edges only) with call-site lines for reporting.
    callees = {}
    for qual, fn in project.functions.items():
        edges = {}
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Call):
                target = project.resolve_call(node, fn)
                if target is not None and target not in edges:
                    edges[target] = node.lineno
        callees[qual] = edges

    for qual, fn in project.functions.items():
        if not _marker_decorated(fn):
            continue
        # Direct taint.
        for line, desc in direct[qual]:
            findings.append(Finding(
                CHECK, fn.source.path, line,
                '@deterministic_safe function {} uses {} — the '
                'deterministic-mode stream must be a pure function of '
                '(dataset, schema, seed, epoch, position)'.format(
                    qual, desc)))
        # Transitive taint: BFS over resolved calls.
        seen = {qual}
        frontier = [(qual, [])]
        while frontier:
            current, chain = frontier.pop(0)
            for callee, line in sorted(callees.get(current, {}).items()):
                if callee in seen:
                    continue
                seen.add(callee)
                new_chain = chain + [(current, callee, line)]
                for taint_line, desc in direct.get(callee, ()):
                    hops = ' -> '.join(
                        [qual] + [edge[1] for edge in new_chain])
                    findings.append(Finding(
                        CHECK, fn.source.path, new_chain[0][2],
                        '@deterministic_safe function {} reaches {} (call '
                        'chain {}; taint at {}:{})'.format(
                            qual, desc, hops,
                            project.functions[callee].source.path,
                            taint_line)))
                frontier.append((callee, new_chain))
    return findings
