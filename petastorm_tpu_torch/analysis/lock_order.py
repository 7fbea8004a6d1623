"""Lock-order graph + blocking-call-under-lock checker (``lock-order-*``).

The pipeline's hardest concurrency bugs are lock-order deadlocks between
long-lived control-plane threads (watchdog vs autotuner vs writer threads)
and slow operations performed while holding a mutex (a ``queue.put`` under
a lock serializes every thread that needs it behind a full queue). Both are
visible statically:

``lock-order-cycle``
    Extracts every lock acquisition (``with self._lock:`` /
    ``x.acquire()``) per function, identifies locks by *class attribute*
    (``petastorm_tpu_torch.staging:ArenaPool._cond``) so all instances of a class
    share one graph node, follows calls made while a lock is held through a
    best-effort cross-module call graph (``self.method``, ``Class()``,
    ``module.fn``, ``self._attr.method`` via constructor-assignment type
    inference), and flags any cycle in the resulting acquired-before
    relation — two threads walking a cycle's edges in opposite order is a
    deadlock waiting for load.

``lock-order-blocking``
    Flags potentially-unbounded operations inside a held-lock region:
    queue ``get``/``put``, thread/process ``join``, ``time.sleep``,
    ``open()``, ``device_put`` / ``block_until_ready``, socket
    ``send``/``recv``, and ``Event.wait`` (a ``Condition.wait`` on the
    innermost held lock is exempt — it releases it — but is flagged when an
    *outer* lock stays held across the wait).

The extracted edge set is also the input to the runtime lock-order
recorder (:mod:`petastorm_tpu_torch.analysis.sanitize`): the static graph is the
contract, the armed recorder asserts production traffic agrees with it.

Both checks are heuristic under-approximations — calls the resolver cannot
prove are simply not followed — so a clean report means "no deadlock the
analyzer can see", not a proof. Intentional exceptions carry a reasoned
``# pstlint: disable=lock-order-blocking(...)`` suppression.
"""

import ast
import re

from petastorm_tpu_torch.analysis.core import Finding

CHECK_CYCLE = 'lock-order-cycle'
CHECK_BLOCKING = 'lock-order-blocking'

_LOCKISH_NAME = re.compile(r'(lock|mutex|cond\b|_cond$|^cond$)', re.I)
_QUEUEISH_NAME = re.compile(r'(queue|(^|_)q$)', re.I)

_SOCKET_OPS = {'recv', 'send', 'recv_multipart', 'send_multipart',
               'recv_pyobj', 'send_pyobj', 'recv_json', 'send_json',
               'recv_string', 'send_string'}
_DEVICE_OPS = {'device_put', 'block_until_ready'}


def _attr_chain(node):
    """``self._pool._cond`` -> ['self', '_pool', '_cond'] (or None)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return list(reversed(parts))
    return None


class _ModuleLocks(object):
    """Module-level lock variables (``_x = threading.Lock()``)."""

    def __init__(self, source):
        from petastorm_tpu_torch.analysis.core import call_ctor_name, _LOCK_CTORS
        self.names = set()
        for node in source.tree.body:
            if isinstance(node, ast.Assign):
                ctor = call_ctor_name(node.value)
                if ctor in _LOCK_CTORS or ctor == 'tracked_lock':
                    for target in node.targets:
                        if isinstance(target, ast.Name):
                            self.names.add(target.id)


class LockAnalysis(object):
    """Cross-module lock graph + per-site blocking findings."""

    def __init__(self, project):
        self.project = project
        self.findings = []
        #: (lock_a, lock_b) -> list of (path, line, description) sites:
        #: "lock_b acquired while lock_a held".
        self.edges = {}
        self._module_locks = {f.modname: _ModuleLocks(f)
                              for f in project.files}
        self._direct_acquires = {}   # fn qualname -> set(lock ids)
        self._callees = {}           # fn qualname -> set(fn qualnames)
        self._may_acquire = {}
        #: fn qualname -> [(held lock, callee qualname, line)]
        self._call_sites = {}
        self._collect()
        self._fixpoint()
        self._emit_call_edges()
        self._emit_cycles()

    # -- lock identification ----------------------------------------------

    def _lock_id(self, expr, fn):
        """Resolve a lock-valued expression to a stable graph node id, or
        None when the expression is not provably/plausibly a lock."""
        source = fn.source
        chain = _attr_chain(expr)
        if not chain:
            return None
        if len(chain) == 1:
            name = chain[0]
            if name in self._module_locks[source.modname].names:
                return '{}:{}'.format(source.modname, name)
            if _LOCKISH_NAME.search(name):
                # Local lock variable: scoped to the function.
                return '{}.<local {}>'.format(fn.qualname, name)
            return None
        if chain[0] == 'self' and fn.class_name is not None:
            cls = self.project.classes.get(
                '{}:{}'.format(source.modname, fn.class_name))
            if len(chain) == 2:
                attr = chain[1]
                if cls is not None and (attr in cls.lock_attrs
                                        or _LOCKISH_NAME.search(attr)):
                    return '{}:{}.{}'.format(source.modname, fn.class_name,
                                             attr)
                return None
            if len(chain) == 3 and cls is not None:
                # self._attr._lock via the inferred attr-type map.
                target_qual = cls.attr_types.get(chain[1])
                target = self.project.classes.get(target_qual)
                if target is not None and (chain[2] in target.lock_attrs
                                           or _LOCKISH_NAME.search(chain[2])):
                    mod, _, cls_name = target_qual.partition(':')
                    return '{}:{}.{}'.format(mod, cls_name, chain[2])
            return None
        # module.LOCK for an imported project module.
        if len(chain) == 2:
            mod = source.import_aliases.get(chain[0])
            if mod in self._module_locks \
                    and chain[1] in self._module_locks[mod].names:
                return '{}:{}'.format(mod, chain[1])
        return None

    def _is_queueish(self, expr, fn):
        chain = _attr_chain(expr)
        if not chain:
            return False
        if chain[0] == 'self' and len(chain) == 2 \
                and fn.class_name is not None:
            cls = self.project.classes.get(
                '{}:{}'.format(fn.source.modname, fn.class_name))
            if cls is not None and chain[1] in cls.queue_attrs:
                return True
        return bool(_QUEUEISH_NAME.search(chain[-1]))

    # -- per-function extraction ------------------------------------------

    def _collect(self):
        for qual, fn in self.project.functions.items():
            self._direct_acquires[qual] = set()
            self._callees[qual] = set()
            self._walk_body(fn.node.body, fn, held=[])

    def _add_edge(self, a, b, path, line, how):
        if a == b:
            return   # re-entrant with on an RLock: not an order edge
        self.edges.setdefault((a, b), []).append((path, line, how))

    def _acquire(self, lock, fn, line, held):
        self._direct_acquires[fn.qualname].add(lock)
        if held:
            self._add_edge(held[-1], lock, fn.source.path, line,
                           'nested acquire in {}'.format(fn.qualname))

    def _walk_body(self, stmts, fn, held):
        """Walk a statement list tracking the held-lock stack. Handles
        ``with lock:`` nesting and linear ``x.acquire()``/``x.release()``
        pairs at this nesting level (try/finally release included)."""
        held = list(held)
        base_depth = len(held)
        for stmt in stmts:
            explicit = self._explicit_acquire(stmt, fn)
            if explicit is not None:
                lock, line, body = explicit
                self._acquire(lock, fn, line, held)
                if body is not None:
                    # `if x.acquire(blocking=False):` — held inside only.
                    self._walk_body(body, fn, held + [lock])
                    if isinstance(stmt, ast.If) and stmt.orelse:
                        self._walk_body(stmt.orelse, fn, held)
                    continue
                held.append(lock)
                continue
            released = self._explicit_release(stmt, fn)
            self._walk_stmt(stmt, fn, held)
            if released is not None and released in held:
                # try/finally-style release: the statement body above still
                # ran under the lock; it is free from here on.
                held.remove(released)
        del held[base_depth:]

    def _explicit_acquire(self, stmt, fn):
        """``x.acquire(...)`` as a bare statement or an if-test.
        Returns (lock, line, guarded_body_or_None) or None."""
        def acquire_target(expr):
            if isinstance(expr, ast.Call) \
                    and isinstance(expr.func, ast.Attribute) \
                    and expr.func.attr == 'acquire':
                return self._lock_id(expr.func.value, fn)
            return None

        if isinstance(stmt, ast.Expr):
            lock = acquire_target(stmt.value)
            if lock is not None:
                return lock, stmt.lineno, None
        if isinstance(stmt, ast.If):
            lock = acquire_target(stmt.test)
            if lock is not None:
                return lock, stmt.lineno, stmt.body
        return None

    def _explicit_release(self, stmt, fn):
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == 'release':
                return self._lock_id(node.func.value, fn)
        return None

    def _walk_stmt(self, stmt, fn, held):
        if isinstance(stmt, ast.With):
            locks = []
            for item in stmt.items:
                lock = self._lock_id(item.context_expr, fn)
                if lock is not None:
                    self._acquire(lock, fn, stmt.lineno, held + locks)
                    locks.append(lock)
                else:
                    self._scan_expr(item.context_expr, fn, held)
            self._walk_body(stmt.body, fn, held + locks)
            return
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return   # nested defs execute later, not under this lock
        if isinstance(stmt, ast.ClassDef):
            return
        # Recurse into compound statements, scanning their expressions.
        for field in ast.iter_fields(stmt):
            value = field[1]
            if isinstance(value, list) \
                    and value and isinstance(value[0], ast.stmt):
                self._walk_body(value, fn, held)
            elif isinstance(value, list):
                for item in value:
                    if isinstance(item, ast.stmt):
                        self._walk_body([item], fn, held)
                    elif isinstance(item, ast.expr):
                        self._scan_expr(item, fn, held)
                    elif isinstance(item, ast.excepthandler):
                        self._walk_body(item.body, fn, held)
            elif isinstance(value, ast.expr):
                self._scan_expr(value, fn, held)

    def _scan_expr(self, expr, fn, held):
        for node in ast.walk(expr):
            if not isinstance(node, ast.Call):
                continue
            callee = self.project.resolve_call(node, fn)
            if callee is not None:
                self._callees[fn.qualname].add(callee)
                if held:
                    self._call_sites.setdefault(fn.qualname, []).append(
                        (held[-1], callee, node.lineno))
            if held:
                self._check_blocking(node, fn, held)

    # -- blocking-call classification --------------------------------------

    def _check_blocking(self, call, fn, held):
        desc = self._blocking_desc(call, fn, held)
        if desc is None:
            return
        self.findings.append(Finding(
            CHECK_BLOCKING, fn.source.path, call.lineno,
            '{} while holding {} (in {}) — a slow or wedged operation here '
            'serializes every thread contending on that lock'.format(
                desc, held[-1], fn.qualname)))

    def _blocking_desc(self, call, fn, held):
        func = call.func
        if isinstance(func, ast.Name):
            if func.id == 'open':
                return 'filesystem open()'
            return None
        if not isinstance(func, ast.Attribute):
            return None
        attr = func.attr
        recv_chain = _attr_chain(func.value) or []
        if attr == 'sleep' and recv_chain[-1:] == ['time']:
            return 'time.sleep()'
        if attr in _DEVICE_OPS:
            return '{}()'.format(attr)
        if attr in _SOCKET_OPS and any(
                'sock' in part.lower() or 'socket' in part.lower()
                or part.lower().endswith('_sender')
                or part.lower().endswith('_receiver')
                for part in recv_chain):
            return 'socket {}()'.format(attr)
        if attr in ('get', 'put') and self._is_queueish(func.value, fn):
            # Non-blocking variants are exempt.
            for kw in call.keywords:
                if kw.arg == 'block' \
                        and isinstance(kw.value, ast.Constant) \
                        and kw.value.value is False:
                    return None
            return 'queue.{}()'.format(attr)
        if attr in ('get_nowait', 'put_nowait'):
            return None
        if attr == 'join':
            # Thread/process join: no positional args, or a single numeric
            # timeout (str.join takes one non-numeric positional).
            if not call.args or (len(call.args) == 1
                                 and isinstance(call.args[0], ast.Constant)
                                 and isinstance(call.args[0].value,
                                                (int, float))):
                return 'join()'
            return None
        if attr == 'wait':
            receiver = self._lock_id(func.value, fn)
            if receiver is not None and held and receiver == held[-1]:
                if len(held) > 1:
                    return ('Condition.wait() that releases only {} — '
                            'outer lock {} stays held'.format(receiver,
                                                              held[-2]))
                return None   # classic cond.wait inside its own lock
            return 'wait()'
        return None

    # -- interprocedural propagation ---------------------------------------

    def _fixpoint(self):
        may = {q: set(acq) for q, acq in self._direct_acquires.items()}
        changed = True
        while changed:
            changed = False
            for qual, callees in self._callees.items():
                for callee in callees:
                    extra = may.get(callee, ()) - may[qual]
                    if extra:
                        may[qual].update(extra)
                        changed = True
        self._may_acquire = may

    def _emit_call_edges(self):
        for caller, sites in self._call_sites.items():
            fn = self.project.functions[caller]
            for held_lock, callee, line in sites:
                for lock in sorted(self._may_acquire.get(callee, ())):
                    self._add_edge(held_lock, lock, fn.source.path, line,
                                   'call to {} while holding'.format(callee))

    # -- cycle detection ----------------------------------------------------

    def _emit_cycles(self):
        graph = {}
        for (a, b) in self.edges:
            graph.setdefault(a, set()).add(b)
            graph.setdefault(b, set())
        for scc in _tarjan(graph):
            if len(scc) < 2:
                continue
            scc = sorted(scc)
            cycle_edges = [(a, b) for (a, b) in sorted(self.edges)
                           if a in scc and b in scc]
            path, line = None, 0
            details = []
            for (a, b) in cycle_edges:
                site = sorted(self.edges[(a, b)])[0]
                if path is None:
                    path, line = site[0], site[1]
                details.append('{} -> {} at {}:{} ({})'.format(
                    a, b, site[0], site[1], site[2]))
            self.findings.append(Finding(
                CHECK_CYCLE, path, line,
                'lock-order cycle between {{{}}} — threads taking these in '
                'opposite orders can deadlock. Edges: {}'.format(
                    ', '.join(scc), '; '.join(details))))


def _tarjan(graph):
    """Iterative Tarjan SCC (the lock graph is tiny, but recursion limits
    are not the analyzer's to burn)."""
    index_counter = [0]
    index, lowlink, on_stack = {}, {}, set()
    stack, sccs = [], []

    for root in sorted(graph):
        if root in index:
            continue
        work = [(root, iter(sorted(graph[root])))]
        index[root] = lowlink[root] = index_counter[0]
        index_counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            node, it = work[-1]
            advanced = False
            for succ in it:
                if succ not in index:
                    index[succ] = lowlink[succ] = index_counter[0]
                    index_counter[0] += 1
                    stack.append(succ)
                    on_stack.add(succ)
                    work.append((succ, iter(sorted(graph[succ]))))
                    advanced = True
                    break
                if succ in on_stack:
                    lowlink[node] = min(lowlink[node], index[succ])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                lowlink[parent] = min(lowlink[parent], lowlink[node])
            if lowlink[node] == index[node]:
                scc = []
                while True:
                    member = stack.pop()
                    on_stack.discard(member)
                    scc.append(member)
                    if member == node:
                        break
                sccs.append(scc)
    return sccs


def check(project):
    """Entry point used by the pstlint driver: (findings, edge dict)."""
    analysis = LockAnalysis(project)
    return analysis.findings, analysis.edges


def static_edges(project):
    """Just the (a, b) acquired-before pairs — the contract the runtime
    lock-order recorder (analysis.sanitize) checks observed traffic
    against."""
    _, edges = check(project)
    return sorted(edges)
