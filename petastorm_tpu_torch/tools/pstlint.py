"""pstlint CLI: run the project-invariant static analyzers.

Usage::

    python -m petastorm_tpu_torch.tools.pstlint [paths...]
        [--check lock-order,threads,determinism,registry]
        [--list-checks] [--emit-lock-graph FILE] [--format text|json]

With no paths, analyzes the installed ``petastorm_tpu_torch`` package tree.
Exit status: 0 clean, 1 findings, 2 usage/parse error. The tier-1 CI gate
(``tests/test_torch_pstlint.py::test_package_tree_is_clean``) runs this over
``petastorm_tpu_torch/`` and fails on any finding.

Findings are silenced per line with a mandatory reason::

    q.put(item)   # pstlint: disable=lock-order-blocking(bounded; see stop())

A suppression without a reason, an unused one, or a malformed one is
itself a finding — the shipped tree has zero unexplained exceptions.

``--emit-lock-graph`` writes the static acquired-before edge set as JSON
(``[[a, b], ...]``), the seed for the runtime lock-order recorder
(:class:`petastorm_tpu_torch.analysis.sanitize.LockOrderRecorder`).
"""

import argparse
import json
import os
import sys


def _default_root():
    import petastorm_tpu_torch
    return os.path.dirname(os.path.abspath(petastorm_tpu_torch.__file__))


def main(argv=None):
    from petastorm_tpu_torch import analysis

    parser = argparse.ArgumentParser(
        prog='python -m petastorm_tpu_torch.tools.pstlint',
        description='Project-invariant static analyzer: lock-order graph, '
                    'thread lifecycle, determinism taint, registry sync.')
    parser.add_argument('paths', nargs='*',
                        help='files or directories to analyze '
                             '(default: the petastorm_tpu_torch package)')
    parser.add_argument('--check', default=None,
                        help='comma-separated subset of: {}'.format(
                            ','.join(analysis.CHECKS)))
    parser.add_argument('--list-checks', action='store_true',
                        help='list check groups and exit')
    parser.add_argument('--emit-lock-graph', metavar='FILE', default=None,
                        help='write the static lock-order edge set as JSON '
                             '(implies the lock-order check: the file '
                             'seeds the runtime recorder, so it must '
                             'never be a silently empty contract)')
    parser.add_argument('--format', choices=('text', 'json'), default='text')
    args = parser.parse_args(argv)

    if args.list_checks:
        for check in analysis.CHECKS:
            print(check)
        return 0

    roots = args.paths or [_default_root()]
    for root in roots:
        if not os.path.exists(root):
            print('pstlint: no such path: {}'.format(root), file=sys.stderr)
            return 2
    checks = None
    if args.check:
        checks = [c.strip() for c in args.check.split(',') if c.strip()]
        if args.emit_lock_graph and 'lock-order' not in checks:
            # The emitted file seeds LockOrderRecorder.load_static_edges;
            # a subset run must not silently write an empty contract.
            checks.append('lock-order')
    try:
        findings, lock_edges = analysis.run_checks(roots, checks=checks)
    except (SyntaxError, ValueError) as e:
        print('pstlint: {}'.format(e), file=sys.stderr)
        return 2

    if args.emit_lock_graph:
        with open(args.emit_lock_graph, 'w', encoding='utf-8') as f:
            json.dump(sorted(lock_edges), f, indent=1)

    cwd = os.getcwd()
    if args.format == 'json':
        print(json.dumps([{'check': f.check,
                           'path': os.path.relpath(f.path, cwd)
                           if f.path.startswith(cwd) else f.path,
                           'line': f.line,
                           'message': f.message} for f in findings],
                         indent=1))
    else:
        for finding in findings:
            print(finding.render(relative_to=cwd))
        if findings:
            print('pstlint: {} finding(s). Fix them, or silence an '
                  'intentional exception with '
                  '# pstlint: disable=<check>(reason).'.format(len(findings)))
        else:
            print('pstlint: clean ({} check group(s) over {}).'.format(
                len(checks) if checks else len(analysis.CHECKS),
                ', '.join(os.path.relpath(r, cwd) if r.startswith(cwd) else r
                          for r in roots)))
    return 1 if findings else 0


if __name__ == '__main__':
    sys.exit(main())
