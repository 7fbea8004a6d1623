"""Thread-lifecycle checker (``thread-*``).

Every long-lived thread in this codebase follows one contract, and this
checker machine-enforces it at three points per ``threading.Thread``
construction site (including ``Thread`` subclasses calling
``super().__init__``):

``thread-name``
    The thread must be *named*, the name must be a statically resolvable
    ``pstt-*`` literal (constant, parameter default, ``'...'.format()``
    prefix, or f-string prefix). Anonymous ``Thread-N`` names make stall
    diagnoses (``dump_all_stacks``), flight-recorder dumps, and leak
    sweeps unreadable — by the time you need the name it is too late to
    add it.

``thread-registry``
    The name's prefix must resolve to an entry in the canonical leak-guard
    registry (:mod:`petastorm_tpu_torch.analysis.registry`). A new thread
    therefore cannot ship without declaring who joins it.

``thread-lifecycle``
    The thread must be ``daemon=True`` or provably joined: a non-daemon
    thread keeps the interpreter alive past main(), so it must be joined
    on a ``stop()``/``close()``/``shutdown()``/``join()`` path of its
    owning class (the checker looks for a ``.join(`` in those methods).
"""

import ast

from petastorm_tpu_torch.analysis.core import Finding
from petastorm_tpu_torch.analysis.registry import thread_prefixes

CHECK_NAME = 'thread-name'
CHECK_REGISTRY = 'thread-registry'
CHECK_LIFECYCLE = 'thread-lifecycle'

#: The port's thread namespace (the JAX package's is ``pst-``).
PREFIX = 'pstt-'

_STOP_METHOD_NAMES = ('stop', 'close', 'shutdown', 'join', '__exit__',
                      '_teardown', 'terminate')


def _module_constant(source, name):
    """The value node of a module-level ``NAME = ...`` in ``source``."""
    if source is None:
        return None
    for stmt in source.tree.body:
        if isinstance(stmt, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name for t in stmt.targets):
            return stmt.value
    return None


def _literal_prefix(node, fn, project, source=None):
    """Best-effort static resolution of a thread-name expression to its
    literal prefix. Returns (prefix, exact) or (None, False)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value, True
    # PREFIX + suffix -> the left operand's prefix (the port's
    # THREAD_PREFIX + 'assemble' pattern).
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        prefix, _exact = _literal_prefix(node.left, fn, project, source)
        return prefix, False
    # '...{}...'.format(...) -> leading literal up to the first brace.
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr == 'format' \
            and isinstance(node.func.value, ast.Constant) \
            and isinstance(node.func.value.value, str):
        return node.func.value.value.split('{')[0], False
    if isinstance(node, ast.JoinedStr):
        if node.values and isinstance(node.values[0], ast.Constant) \
                and isinstance(node.values[0].value, str):
            return node.values[0].value, False
        return None, False
    # A bare name: a parameter of the enclosing function with a string
    # default (the AutoTuner/Watchdog pattern: name='pstt-autotune').
    if isinstance(node, ast.Name) and fn is not None:
        args = fn.node.args
        params = args.args + args.kwonlyargs
        defaults = ([None] * (len(args.args) - len(args.defaults))
                    + list(args.defaults) + list(args.kw_defaults))
        for param, default in zip(params, defaults):
            if param.arg == node.id and isinstance(default, ast.Constant) \
                    and isinstance(default.value, str):
                return default.value, False
        # Or a local assigned a resolvable literal in the same function.
        for sub in ast.walk(fn.node):
            if isinstance(sub, ast.Assign) \
                    and any(isinstance(t, ast.Name) and t.id == node.id
                            for t in sub.targets):
                return _literal_prefix(sub.value, fn, project, source)
    # A module-level constant of the same file (THREAD_NAME = 'pstt-...'),
    # directly or as a parameter's default.
    if isinstance(node, ast.Name):
        if fn is not None:
            args = fn.node.args
            defaults = ([None] * (len(args.args) - len(args.defaults))
                        + list(args.defaults) + list(args.kw_defaults))
            for param, default in zip(args.args + args.kwonlyargs, defaults):
                if param.arg == node.id and isinstance(default, ast.Name):
                    node = default
                    break
        value = _module_constant(source, node.id)
        if value is not None and not isinstance(value, ast.Name):
            return _literal_prefix(value, None, project, source)
    return None, False


def _enclosing_function(project, source, lineno):
    best = None
    for fn in project.functions.values():
        if fn.source is not source:
            continue
        node = fn.node
        end = getattr(node, 'end_lineno', node.lineno)
        if node.lineno <= lineno <= end:
            if best is None or node.lineno > best.node.lineno:
                best = fn
    return best


def _class_joins_threads(project, source, class_name):
    cls = project.classes.get('{}:{}'.format(source.modname, class_name))
    if cls is None:
        return False
    for method_name in _STOP_METHOD_NAMES:
        method = cls.methods.get(method_name)
        if method is None:
            continue
        for node in ast.walk(method.node):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == 'join':
                return True
    return False


def _is_thread_ctor(call, source):
    """``threading.Thread(...)`` / ``Thread(...)`` (imported from
    threading)."""
    func = call.func
    if isinstance(func, ast.Attribute) and func.attr == 'Thread' \
            and isinstance(func.value, ast.Name) \
            and source.import_aliases.get(func.value.id, func.value.id) \
            == 'threading':
        return True
    if isinstance(func, ast.Name) \
            and source.import_aliases.get(func.id) == 'threading.Thread':
        return True
    return False


def _is_thread_subclass_super_init(call, source, project):
    """``super().__init__(...)`` inside a class whose bases include
    threading.Thread — the construction site for Thread subclasses."""
    func = call.func
    if not (isinstance(func, ast.Attribute) and func.attr == '__init__'
            and isinstance(func.value, ast.Call)
            and isinstance(func.value.func, ast.Name)
            and func.value.func.id == 'super'):
        return None
    return True


def _thread_base_class(project, source, lineno):
    """The ClassDef containing ``lineno`` if it subclasses Thread."""
    for node in ast.walk(source.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        end = getattr(node, 'end_lineno', node.lineno)
        if not (node.lineno <= lineno <= end):
            continue
        for base in node.bases:
            if isinstance(base, ast.Attribute) and base.attr == 'Thread':
                return node
            if isinstance(base, ast.Name) and source.import_aliases.get(
                    base.id) == 'threading.Thread':
                return node
    return None


def check(project):
    findings = []
    for source in project.files:
        for node in ast.walk(source.tree):
            if not isinstance(node, ast.Call):
                continue
            is_ctor = _is_thread_ctor(node, source)
            thread_cls = None
            if not is_ctor and _is_thread_subclass_super_init(node, source,
                                                              project):
                thread_cls = _thread_base_class(project, source, node.lineno)
                if thread_cls is None:
                    continue
            elif not is_ctor:
                continue
            findings.extend(
                _check_site(project, source, node, thread_cls))
    return findings


def _check_site(project, source, call, thread_cls):
    findings = []
    fn = _enclosing_function(project, source, call.lineno)
    kwargs = {kw.arg: kw.value for kw in call.keywords if kw.arg}

    # -- name ------------------------------------------------------------
    name_node = kwargs.get('name')
    if name_node is None:
        what = 'Thread subclass {} calls super().__init__'.format(
            thread_cls.name) if thread_cls is not None \
            else 'threading.Thread constructed'
        findings.append(Finding(
            CHECK_NAME, source.path, call.lineno,
            '{} without name= — anonymous Thread-N names make stack dumps, '
            'flight-recorder dumps, and leak sweeps unreadable; '
            'name it pstt-<component>'.format(what)))
    else:
        prefix, _exact = _literal_prefix(name_node, fn, project, source)
        if prefix is None:
            findings.append(Finding(
                CHECK_NAME, source.path, call.lineno,
                'thread name is not statically resolvable — use a literal, '
                'a parameter default, or a "pstt-...{}".format(...) prefix '
                'so pstlint and the leak-guard registry can see it'))
        elif not prefix.startswith(PREFIX):
            findings.append(Finding(
                CHECK_NAME, source.path, call.lineno,
                'thread name {!r} does not start with pstt- — the port namespace '
                'that stack dumps and leak sweeps key on'.format(
                    prefix)))
        elif not any(prefix.startswith(reg) for reg in thread_prefixes()):
            findings.append(Finding(
                CHECK_REGISTRY, source.path, call.lineno,
                'thread prefix {!r} is not in the leak-guard registry '
                '(petastorm_tpu_torch/analysis/registry.py THREAD_GUARDS) — '
                'register it with an owner and a join path'.format(prefix)))

    # -- daemon-or-joined -------------------------------------------------
    daemon_node = kwargs.get('daemon')
    is_daemon = isinstance(daemon_node, ast.Constant) \
        and daemon_node.value is True
    if not is_daemon:
        owner_class = thread_cls.name if thread_cls is not None \
            else (fn.class_name if fn is not None else None)
        joined = owner_class is not None and _class_joins_threads(
            project, source, owner_class)
        if not joined:
            findings.append(Finding(
                CHECK_LIFECYCLE, source.path, call.lineno,
                'thread is neither daemon=True nor provably joined on a '
                'stop()/close()/shutdown() path of its owning class — a '
                'non-daemon leak keeps the interpreter alive forever'))
    return findings
