"""pstlint: project-invariant static analysis + runtime sanitizer, the
port's own copy of ``petastorm_tpu/analysis`` pointed at
``petastorm_tpu_torch`` (its ``pstt-`` threads, its ``PSTT_*`` variables
and fault sites, tabled in ``docs/torch_guide.rst``).

The pipeline's correctness rests on invariants no general-purpose linter
knows: lock acquisition order across ~25 lock-owning modules, the
``pstt-*`` thread lifecycle contract, purity of the deterministic-mode
order path, and the string-keyed registries (env vars, fault sites,
pytest markers) whose drift reviews kept catching by hand. This package
machine-checks them:

* :mod:`~petastorm_tpu_torch.analysis.core` — shared AST project model,
  findings, ``# pstlint: disable=check(reason)`` suppressions.
* :mod:`~petastorm_tpu_torch.analysis.lock_order` — lock-order graph cycles +
  blocking calls under a held lock.
* :mod:`~petastorm_tpu_torch.analysis.threads` — thread naming / daemon-or-
  joined / leak-guard-registry coverage.
* :mod:`~petastorm_tpu_torch.analysis.determinism_taint` — nondeterminism
  reaching ``@deterministic_safe`` code.
* :mod:`~petastorm_tpu_torch.analysis.registry_sync` — env-var, fault-site and
  pytest-marker registries synced with source, both directions.
* :mod:`~petastorm_tpu_torch.analysis.bounded_queues` — every ``queue.Queue``
  construction carries an explicit ``maxsize`` (or a reasoned
  suppression): unbounded cross-thread queues are the OOM killer's
  favorite food, and the memory governor can only account what is
  bounded.
* :mod:`~petastorm_tpu_torch.analysis.registry` — the canonical leak-guard
  table of the port's threads.
* :mod:`~petastorm_tpu_torch.analysis.sanitize` — the opt-in
  (``PSTT_SANITIZE``) runtime layer: arena poison-on-reclaim +
  borrow-tagged views and the lock-order recorder.

CLI: ``python -m petastorm_tpu_torch.tools.pstlint [paths]`` — exits nonzero on
findings; ``tests/test_torch_pstlint.py::test_package_tree_is_clean`` is the
tier-1 gate pinning the shipped tree at zero.
"""

from petastorm_tpu_torch.analysis.core import (Finding,  # noqa: F401
                                               apply_suppressions, load_project)
from petastorm_tpu_torch.analysis.sanitize import (  # noqa: F401
    LockOrderRecorder, LockOrderViolation, StaleViewError, guard_view,
    sanitize_active, tracked_lock)

#: check-id prefix -> checker module; the driver runs these in order.
CHECKS = ('lock-order', 'threads', 'determinism', 'registry',
          'bounded-queues')


def run_checks(roots, checks=None):
    """Run the selected checkers over ``roots``.

    Returns ``(findings, lock_edges)``: post-suppression findings sorted
    by location, plus the static lock graph (for ``--emit-lock-graph``
    and the runtime recorder). ``checks`` is an iterable of entries from
    :data:`CHECKS`; None runs everything.
    """
    from petastorm_tpu_torch.analysis import (bounded_queues, determinism_taint,
                                              lock_order, registry_sync, threads)
    selected = set(CHECKS if checks is None else checks)
    unknown = selected - set(CHECKS)
    if unknown:
        raise ValueError('unknown checks: {} (known: {})'.format(
            sorted(unknown), list(CHECKS)))
    project = load_project(roots)
    findings = []
    lock_edges = {}
    checks_run = {'suppression'}
    if 'lock-order' in selected:
        lock_findings, lock_edges = lock_order.check(project)
        findings.extend(lock_findings)
        checks_run.update((lock_order.CHECK_CYCLE,
                           lock_order.CHECK_BLOCKING))
    if 'threads' in selected:
        findings.extend(threads.check(project))
        checks_run.update((threads.CHECK_NAME, threads.CHECK_REGISTRY,
                           threads.CHECK_LIFECYCLE))
    if 'determinism' in selected:
        findings.extend(determinism_taint.check(project))
        checks_run.add(determinism_taint.CHECK)
    if 'registry' in selected:
        findings.extend(registry_sync.check(project))
        checks_run.update((registry_sync.CHECK_ENV,
                           registry_sync.CHECK_FAULT,
                           registry_sync.CHECK_MARKER))
    if 'bounded-queues' in selected:
        findings.extend(bounded_queues.check(project))
        checks_run.add(bounded_queues.CHECK)
    return apply_suppressions(project, findings, checks_run), lock_edges
