"""Shared machinery for the pstlint static checkers.

Everything here is deliberately import-light and side-effect-free: the
analyzer parses the package *source* with :mod:`ast` (it never imports the
modules it checks, so a lint run cannot be perturbed by import-time state,
CUDA initialization, or env vars), and the individual checkers
(``lock_order``, ``threads``, ``determinism_taint``, ``registry_sync``)
share one :class:`Project` model built here:

* :class:`SourceFile` — one parsed module (path, text, AST, dotted module
  name, per-line suppression table).
* :class:`Project` — the analyzed file set plus a cross-module index of
  classes, functions, import aliases, and a best-effort ``self.attr`` type
  map (``self._pool = ArenaPool(...)`` makes ``self._pool`` resolve to
  ``ArenaPool``), which is what lets the lock-order checker follow calls
  across modules without executing anything.
* :class:`Finding` — one reported violation; renders as
  ``path:line: [check] message``.

Suppressions
------------

A finding is silenced by a trailing comment **on the flagged line** naming
the check and a reason::

    q.put(item)   # pstlint: disable=lock-order-blocking(bounded by X; see Y)

The reason is mandatory — ``disable=check`` without one is itself a
finding (``suppression``), as is a suppression that matched nothing on a
run that included its check. The full analyzer therefore exits zero only
when every exception in the tree is *explained*.
"""

import ast
import os
import re

#: Matches the suppression tail of a source line. The payload is parsed by
#: :func:`_parse_suppression_items` (reasons may contain commas).
_SUPPRESS_RE = re.compile(r'#\s*pstlint:\s*disable=(.+)$')

#: One suppression item: ``check-name`` optionally followed by ``(reason)``.
_ITEM_RE = re.compile(r'\s*([a-z][a-z0-9-]*)\s*(?:\(([^()]*(?:\([^()]*\)[^()]*)*)\))?\s*$')


class Finding(object):
    """One checker violation at a source location."""

    def __init__(self, check, path, line, message):
        self.check = check
        self.path = path
        self.line = line
        self.message = message

    def render(self, relative_to=None):
        path = self.path
        if relative_to:
            try:
                path = os.path.relpath(path, relative_to)
            except ValueError:  # pragma: no cover - windows drive mismatch
                pass
        return '{}:{}: [{}] {}'.format(path, self.line, self.check,
                                       self.message)

    def __repr__(self):
        return 'Finding({!r})'.format(self.render())

    def sort_key(self):
        return (self.path, self.line, self.check)


class Suppression(object):
    def __init__(self, path, line, check, reason):
        self.path = path
        self.line = line
        self.check = check
        self.reason = reason
        self.used = False


def _parse_suppression_items(payload):
    """Split ``check1(reason),check2(reason)`` on commas outside parens."""
    items, depth, start = [], 0, 0
    for i, ch in enumerate(payload):
        if ch == '(':
            depth += 1
        elif ch == ')':
            depth = max(0, depth - 1)
        elif ch == ',' and depth == 0:
            items.append(payload[start:i])
            start = i + 1
    items.append(payload[start:])
    return [item for item in items if item.strip()]


def _comment_tokens(text):
    """(lineno, comment_text) for every real COMMENT token — docstrings
    and string literals that merely *mention* the suppression syntax must
    not register as suppressions. Falls back to line-scanning if tokenize
    rejects the file (the AST parse would have failed first anyway)."""
    import io
    import tokenize
    try:
        for tok in tokenize.generate_tokens(io.StringIO(text).readline):
            if tok.type == tokenize.COMMENT:
                yield tok.start[0], tok.string
    except (tokenize.TokenError, IndentationError):  # pragma: no cover
        for lineno, line in enumerate(text.splitlines(), start=1):
            if '#' in line:
                yield lineno, line[line.index('#'):]


def parse_suppressions(path, text):
    """All ``pstlint: disable=...`` comments in ``text`` -> Suppressions.

    Malformed items come back as ``(line, raw_item)`` in the second list so
    the driver can report them (they never silence anything).
    """
    suppressions, malformed = [], []
    for lineno, comment in _comment_tokens(text):
        match = _SUPPRESS_RE.search(comment)
        if not match:
            continue
        for item in _parse_suppression_items(match.group(1)):
            m = _ITEM_RE.match(item)
            if not m:
                malformed.append((lineno, item.strip()))
                continue
            check, reason = m.group(1), (m.group(2) or '').strip()
            suppressions.append(Suppression(path, lineno, check, reason))
    return suppressions, malformed


class SourceFile(object):
    """One parsed python module of the analyzed tree."""

    def __init__(self, path, text, tree, modname):
        self.path = path
        self.text = text
        self.tree = tree
        self.modname = modname
        self.suppressions, self.malformed_suppressions = \
            parse_suppressions(path, text)
        #: import alias -> dotted module ('np' -> 'numpy',
        #: 'metrics_mod' -> 'petastorm_tpu_torch.metrics'); from-imports map the
        #: bound name to 'module.attr'.
        self.import_aliases = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    self.import_aliases[alias.asname or
                                        alias.name.split('.')[0]] = alias.name
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0:
                for alias in node.names:
                    self.import_aliases[alias.asname or alias.name] = \
                        '{}.{}'.format(node.module, alias.name)

    def suppressed(self, finding):
        """Mark-and-test: does a same-line suppression cover ``finding``?

        A suppression with an empty reason still *silences* nothing — it is
        reported by the driver instead."""
        for sup in self.suppressions:
            if sup.line == finding.line and sup.check == finding.check \
                    and sup.reason:
                sup.used = True
                return True
        return False


def iter_python_files(root):
    """Yield every ``.py`` path under ``root`` (or ``root`` itself),
    skipping caches, builds, and hidden dirs. Deterministic order."""
    if os.path.isfile(root):
        yield root
        return
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if not d.startswith('.')
                             and d not in ('__pycache__', 'build', 'dist',
                                           'node_modules'))
        for name in sorted(filenames):
            if name.endswith('.py'):
                yield os.path.join(dirpath, name)


def module_name_for(path, root):
    """Dotted module name of ``path`` relative to the tree that CONTAINS
    ``root`` — analyzing ``.../petastorm_tpu_torch`` yields names like
    ``petastorm_tpu_torch.staging`` so cross-references read like imports."""
    base = os.path.dirname(os.path.abspath(root)) if os.path.isdir(root) \
        else os.path.dirname(os.path.abspath(os.path.dirname(root)))
    rel = os.path.relpath(os.path.abspath(path), base)
    parts = rel.split(os.sep)
    if parts[-1] == '__init__.py':
        parts = parts[:-1]
    else:
        parts[-1] = parts[-1][:-3]
    return '.'.join(p for p in parts if p)


class FunctionInfo(object):
    """One function or method: its AST node plus resolution context."""

    def __init__(self, qualname, node, source, class_name=None):
        self.qualname = qualname      # 'pkg.mod:Class.method' / 'pkg.mod:f'
        self.node = node
        self.source = source
        self.class_name = class_name


class ClassInfo(object):
    def __init__(self, qualname, node, source):
        self.qualname = qualname      # 'pkg.mod:Class'
        self.node = node
        self.source = source
        self.methods = {}             # name -> FunctionInfo
        self.bases = []               # base-class name expressions (raw)
        #: self.<attr> -> class qualname, inferred from
        #: ``self.attr = ClassName(...)`` assignments anywhere in the class.
        self.attr_types = {}
        #: self.<attr> names assigned a lock/condition constructor.
        self.lock_attrs = set()
        #: self.<attr> names assigned a queue.Queue-like constructor.
        self.queue_attrs = set()


_LOCK_CTORS = {'Lock', 'RLock', 'Condition', 'Semaphore', 'BoundedSemaphore'}
_QUEUE_CTORS = {'Queue', 'LifoQueue', 'PriorityQueue', 'SimpleQueue',
                'JoinableQueue'}


def call_ctor_name(value):
    """``threading.Lock()`` -> 'Lock'; ``Queue()`` -> 'Queue'; else None.
    Also unwraps one level of ``sanitize.tracked_lock('...')``."""
    if not isinstance(value, ast.Call):
        return None
    func = value.func
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


class Project(object):
    """The analyzed file set plus cross-module indexes."""

    def __init__(self, root, files):
        self.root = root
        self.files = files
        self.modules = {f.modname: f for f in files}
        self.classes = {}     # 'mod:Class' -> ClassInfo
        self.functions = {}   # 'mod:Class.method' / 'mod:f' -> FunctionInfo
        # Two passes: structure first so attr-type inference in pass two
        # can resolve classes regardless of file ordering.
        for f in files:
            self._index_file(f)
        for info in list(self.classes.values()):
            self._infer_attrs(info)

    # -- indexing ---------------------------------------------------------

    def _index_file(self, source):
        for node in source.tree.body:
            if isinstance(node, ast.ClassDef):
                self._index_class(source, node)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = '{}:{}'.format(source.modname, node.name)
                self.functions[qual] = FunctionInfo(qual, node, source)

    def _index_class(self, source, node):
        cls_qual = '{}:{}'.format(source.modname, node.name)
        info = ClassInfo(cls_qual, node, source)
        info.bases = node.bases
        self.classes[cls_qual] = info
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = '{}:{}.{}'.format(source.modname, node.name, item.name)
                fn = FunctionInfo(qual, item, source, class_name=node.name)
                info.methods[item.name] = fn
                self.functions[qual] = fn

    def _infer_attrs(self, info):
        # self.<attr> type / lock / queue inference over the whole class.
        source, node = info.source, info.node
        for sub in ast.walk(node):
            targets = []
            if isinstance(sub, ast.Assign):
                targets, value = sub.targets, sub.value
            elif isinstance(sub, ast.AnnAssign) and sub.value is not None:
                targets, value = [sub.target], sub.value
            else:
                continue
            for target in targets:
                if not (isinstance(target, ast.Attribute)
                        and isinstance(target.value, ast.Name)
                        and target.value.id == 'self'):
                    continue
                ctor = call_ctor_name(value)
                if ctor in _LOCK_CTORS or ctor == 'tracked_lock':
                    info.lock_attrs.add(target.attr)
                elif ctor in _QUEUE_CTORS:
                    info.queue_attrs.add(target.attr)
                elif ctor is not None:
                    resolved = self._resolve_class_name(source, value.func)
                    if resolved is not None:
                        info.attr_types[target.attr] = resolved

    def _resolve_class_name(self, source, func):
        """Best-effort: a constructor expression -> project class qualname."""
        if isinstance(func, ast.Name):
            name = func.id
            local = '{}:{}'.format(source.modname, name)
            if local in self.classes:
                return local
            imported = source.import_aliases.get(name)
            if imported and '.' in imported:
                mod, _, attr = imported.rpartition('.')
                qual = '{}:{}'.format(mod, attr)
                if qual in self.classes:
                    return qual
        elif isinstance(func, ast.Attribute) and isinstance(func.value,
                                                            ast.Name):
            mod = source.import_aliases.get(func.value.id)
            if mod:
                qual = '{}:{}'.format(mod, func.attr)
                if qual in self.classes:
                    return qual
        return None

    # -- call resolution --------------------------------------------------

    def resolve_call(self, call, fn):
        """Resolve a Call made inside ``fn`` to a project FunctionInfo
        qualname, or None. Under-approximates on purpose: an edge we cannot
        prove is an edge we do not claim."""
        func = call.func
        source = fn.source
        if isinstance(func, ast.Name):
            name = func.id
            # Constructor of a project class -> its __init__.
            cls = self._resolve_class_name(source, func)
            if cls is not None:
                init = '{}.{}'.format(cls, '__init__')
                return init if init in self.functions else None
            local = '{}:{}'.format(source.modname, name)
            if local in self.functions:
                return local
            imported = source.import_aliases.get(name)
            if imported and '.' in imported:
                mod, _, attr = imported.rpartition('.')
                qual = '{}:{}'.format(mod, attr)
                if qual in self.functions:
                    return qual
                cls_qual = '{}:{}'.format(mod, attr)
                if cls_qual in self.classes:
                    init = '{}.{}'.format(cls_qual, '__init__')
                    return init if init in self.functions else None
            return None
        if not isinstance(func, ast.Attribute):
            return None
        # self.method(...)
        if isinstance(func.value, ast.Name) and func.value.id == 'self' \
                and fn.class_name is not None:
            cls = self.classes.get('{}:{}'.format(source.modname,
                                                  fn.class_name))
            method = self._lookup_method(cls, func.attr)
            if method is not None:
                return method.qualname
            return None
        # module.function(...)
        if isinstance(func.value, ast.Name):
            mod = source.import_aliases.get(func.value.id)
            if mod:
                qual = '{}:{}'.format(mod, func.attr)
                if qual in self.functions:
                    return qual
            return None
        # self._attr.method(...) via the inferred attr-type map.
        if isinstance(func.value, ast.Attribute) \
                and isinstance(func.value.value, ast.Name) \
                and func.value.value.id == 'self' \
                and fn.class_name is not None:
            cls = self.classes.get('{}:{}'.format(source.modname,
                                                  fn.class_name))
            if cls is not None:
                target_cls_qual = cls.attr_types.get(func.value.attr)
                if target_cls_qual is not None:
                    target_cls = self.classes.get(target_cls_qual)
                    method = self._lookup_method(target_cls, func.attr)
                    if method is not None:
                        return method.qualname
        return None

    def _lookup_method(self, cls, name, _depth=0):
        """Method lookup walking project-resolvable base classes."""
        if cls is None or _depth > 8:
            return None
        if name in cls.methods:
            return cls.methods[name]
        for base in cls.bases:
            base_qual = self._resolve_class_name(cls.source, base) \
                if isinstance(base, (ast.Name, ast.Attribute)) else None
            found = self._lookup_method(self.classes.get(base_qual), name,
                                        _depth + 1)
            if found is not None:
                return found
        return None


def load_project(roots):
    """Parse every python file under ``roots`` into one Project."""
    files = []
    roots = [roots] if isinstance(roots, str) else list(roots)
    seen = set()
    for root in roots:
        for path in iter_python_files(root):
            apath = os.path.abspath(path)
            if apath in seen:
                continue
            seen.add(apath)
            with open(path, 'r', encoding='utf-8') as f:
                text = f.read()
            try:
                tree = ast.parse(text, filename=path)
            except SyntaxError as e:
                # A file the analyzer cannot parse is itself a finding at
                # the driver level; record a stub so the path is visible.
                raise SyntaxError('pstlint cannot parse {}: {}'.format(path, e))
            files.append(SourceFile(path, text,
                                    tree, module_name_for(path, root)))
    return Project(roots[0], files)


def apply_suppressions(project, findings, checks_run):
    """Filter suppressed findings; add ``suppression`` findings for
    reason-less, malformed, and unused suppressions of the checks run."""
    kept = []
    for finding in findings:
        source = next((f for f in project.files if f.path == finding.path),
                      None)
        if source is not None and source.suppressed(finding):
            continue
        kept.append(finding)
    for source in project.files:
        for lineno, item in source.malformed_suppressions:
            kept.append(Finding(
                'suppression', source.path, lineno,
                'malformed pstlint suppression {!r} — expected '
                'check-name(reason)'.format(item)))
        for sup in source.suppressions:
            if not sup.reason:
                kept.append(Finding(
                    'suppression', source.path, sup.line,
                    'suppression for {!r} has no reason — write '
                    '# pstlint: disable={}(why this is safe)'.format(
                        sup.check, sup.check)))
            elif not sup.used and sup.check in checks_run:
                kept.append(Finding(
                    'suppression', source.path, sup.line,
                    'unused suppression for {!r} — the finding it silenced '
                    'is gone; delete the comment'.format(sup.check)))
    return sorted(kept, key=Finding.sort_key)
