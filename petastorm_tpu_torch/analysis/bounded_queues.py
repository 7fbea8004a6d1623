"""Bounded-queues checker (``bounded-queues``).

Every ``queue.Queue``-family construction in the package must pass an
explicit ``maxsize`` (positional or keyword) or carry a reasoned
``# pstlint: disable=bounded-queues(...)`` suppression. An unbounded
cross-thread queue is exactly the failure mode the host memory governor
(``petastorm_tpu_torch.membudget``) exists to prevent: items pile up invisibly
until the kernel OOM killer ends the process with no diagnosis — the
bound is what turns "queue grew" into backpressure or a counted drop.

``SimpleQueue`` is flagged unconditionally (it cannot be bounded: use
``queue.Queue(maxsize=...)`` or suppress with the reason that makes the
unboundedness safe). A ``maxsize`` of literal ``0`` (the stdlib's
"infinite" spelling) is flagged too — writing the bound down and writing
"unbounded" are different claims, and only the first one is allowed
implicitly.

Scope is the stdlib ``queue`` module (resolved through import aliases,
``from queue import Queue`` included). ``multiprocessing`` queues ride OS
pipe buffers with their own semantics and are owned by the process-pool
transport layer — out of scope here.
"""

import ast

from petastorm_tpu_torch.analysis.core import Finding

CHECK = 'bounded-queues'

#: queue-module constructors that accept a maxsize bound.
_BOUNDED_CTORS = ('Queue', 'LifoQueue', 'PriorityQueue')
#: queue-module constructors that cannot be bounded at all.
_UNBOUNDABLE_CTORS = ('SimpleQueue',)


def _queue_ctor(source, call):
    """The queue-module constructor name a Call resolves to, or None.

    Resolution goes through the file's import aliases so both
    ``queue.Queue()`` (module attribute) and ``from queue import Queue``
    styles are covered, along with aliased imports."""
    func = call.func
    if isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name):
        module = source.import_aliases.get(func.value.id)
        if module == 'queue' \
                and func.attr in _BOUNDED_CTORS + _UNBOUNDABLE_CTORS:
            return func.attr
        return None
    if isinstance(func, ast.Name):
        target = source.import_aliases.get(func.id)
        for ctor in _BOUNDED_CTORS + _UNBOUNDABLE_CTORS:
            if target == 'queue.{}'.format(ctor):
                return ctor
    return None


def _has_explicit_bound(call):
    """True when the construction passes a non-zero-literal maxsize."""
    bound = None
    if call.args:
        bound = call.args[0]
    for keyword in call.keywords:
        if keyword.arg == 'maxsize':
            bound = keyword.value
    if bound is None:
        return False
    # Literal 0 and negative literals are the stdlib's "infinite"
    # spellings (any maxsize <= 0 is unbounded) — an unbounded queue
    # dressed up as a bounded one; anything else (names, expressions,
    # positive literals) counts as a written-down bound.
    if isinstance(bound, ast.Constant) and isinstance(bound.value, (int, float)) \
            and bound.value <= 0:
        return False
    if isinstance(bound, ast.UnaryOp) and isinstance(bound.op, ast.USub) \
            and isinstance(bound.operand, ast.Constant):
        return False
    return True


def check(project):
    findings = []
    for source in project.files:
        for node in ast.walk(source.tree):
            if not isinstance(node, ast.Call):
                continue
            ctor = _queue_ctor(source, node)
            if ctor is None:
                continue
            if ctor in _UNBOUNDABLE_CTORS:
                findings.append(Finding(
                    CHECK, source.path, node.lineno,
                    'queue.{}() can never be bounded — use queue.Queue('
                    'maxsize=...) so backpressure/drops are possible, or '
                    'suppress with the reason that makes unbounded growth '
                    'safe here'.format(ctor)))
                continue
            if not _has_explicit_bound(node):
                findings.append(Finding(
                    CHECK, source.path, node.lineno,
                    'queue.{}() constructed without an explicit maxsize — '
                    'an unbounded cross-thread queue grows until the OOM '
                    'killer ends the process with no diagnosis; pass the '
                    'bound (and let membudget account it), or suppress '
                    'with the reason the growth is bounded '
                    'elsewhere'.format(ctor)))
    return findings
