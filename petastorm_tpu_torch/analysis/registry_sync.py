"""Registry-sync checker (``registry-env`` / ``registry-fault`` /
``registry-marker``).

Generalizes the metric-table lint (every ``pst_*`` instrument must
have a docs row, both directions) into one framework covering the other
three string-keyed surfaces that silently drift:

``registry-env``
    Every ``PSTT_*`` environment variable the package reads must
    have a row in the canonical table in ``docs/torch_guide.rst`` (between
    the ``.. begin-env-table`` / ``.. end-env-table`` sentinels), and
    every table row must correspond to a variable the source actually
    reads. An env knob you cannot find in the docs does not exist
    operationally; a documented knob the code ignores is worse.

``registry-fault``
    Every fault site injected via :func:`petastorm_tpu_torch.faults.maybe_inject`
    / ``should_fire`` / ``selected`` must be declared in
    ``faults.KNOWN_SITES`` (parsed statically) and documented in
    ``docs/torch_guide.rst``; every declared site must be referenced by
    at least one injection point or test.

``registry-marker``
    Every ``@pytest.mark.<name>`` used under ``tests/`` must be registered
    in ``pytest.ini`` (the fast CI lane runs warning-free), and every
    registered marker must still be used somewhere.

The checker needs the repo layout around the package (docs/, tests/,
pytest.ini next to the package root); when a piece is missing it reports
that as a finding rather than silently skipping — the CI gate runs from
the repo root where everything exists.
"""

import ast
import configparser
import os
import re

from petastorm_tpu_torch.analysis.core import Finding, iter_python_files

CHECK_ENV = 'registry-env'
CHECK_FAULT = 'registry-fault'
CHECK_MARKER = 'registry-marker'

_ENV_RE = re.compile(r'^PSTT_[A-Z0-9_]+$')
_ENV_DOC_RE = re.compile(r'``(PSTT_[A-Z0-9_]+)``')
_SITE_DOC_RE = re.compile(r'``([a-z][a-z0-9-]*-[a-z0-9-]+)``')
_INJECT_FUNCS = {'maybe_inject', 'should_fire', 'selected', 'inject'}
_BUILTIN_MARKERS = {'parametrize', 'skip', 'skipif', 'xfail', 'usefixtures',
                    'filterwarnings'}

ENV_TABLE_BEGIN = '.. begin-env-table'
ENV_TABLE_END = '.. end-env-table'


def _repo_root(project):
    root = project.root
    if os.path.isfile(root):
        root = os.path.dirname(root)
    return os.path.dirname(os.path.abspath(root))


def _line_of(text, needle):
    for lineno, line in enumerate(text.splitlines(), start=1):
        if needle in line:
            return lineno
    return 1


# -- env vars --------------------------------------------------------------

def _docstring_nodes(tree):
    """The Constant nodes that are module/class/function docstrings — a
    docstring *mentioning* a variable is not a reading site, and counting
    it would let a dead docs-table row survive the two-way check (same
    discrimination the suppression parser applies via COMMENT tokens)."""
    nodes = set()
    for scope in ast.walk(tree):
        if isinstance(scope, (ast.Module, ast.ClassDef, ast.FunctionDef,
                              ast.AsyncFunctionDef)):
            body = getattr(scope, 'body', [])
            if body and isinstance(body[0], ast.Expr) \
                    and isinstance(body[0].value, ast.Constant) \
                    and isinstance(body[0].value.value, str):
                nodes.add(id(body[0].value))
    return nodes


def _source_env_vars(project):
    """var -> first (path, line) site of a PSTT_* string literal
    in *code* (docstrings excluded)."""
    sites = {}
    for source in project.files:
        docstrings = _docstring_nodes(source.tree)
        for node in ast.walk(source.tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str)\
                    and _ENV_RE.match(node.value) \
                    and id(node) not in docstrings:
                sites.setdefault(node.value, (source.path, node.lineno))
    return sites


def _documented_env_vars(guide_path):
    with open(guide_path, 'r', encoding='utf-8') as f:
        text = f.read()
    if ENV_TABLE_BEGIN not in text or ENV_TABLE_END not in text:
        return None, text
    start = text.index(ENV_TABLE_BEGIN)
    end = text.index(ENV_TABLE_END, start)
    return set(_ENV_DOC_RE.findall(text[start:end])), text


def _check_env(project, repo, findings):
    guide = os.path.join(repo, 'docs', 'torch_guide.rst')
    source_vars = _source_env_vars(project)
    if not os.path.exists(guide):
        findings.append(Finding(
            CHECK_ENV, guide, 1,
            'docs/torch_guide.rst not found — the canonical '
            'PSTT_* environment table lives there'))
        return
    documented, text = _documented_env_vars(guide)
    if documented is None:
        findings.append(Finding(
            CHECK_ENV, guide, 1,
            'docs/torch_guide.rst has no {} / {} sentinels delimiting the '
            'canonical environment-variable table'.format(
                ENV_TABLE_BEGIN, ENV_TABLE_END)))
        return
    for var in sorted(set(source_vars) - documented):
        path, line = source_vars[var]
        findings.append(Finding(
            CHECK_ENV, path, line,
            'environment variable {} is read by the source but missing '
            'from the canonical table in docs/torch_guide.rst — an '
            'undocumented knob does not exist operationally'.format(var)))
    for var in sorted(documented - set(source_vars)):
        findings.append(Finding(
            CHECK_ENV, guide, _line_of(text, var),
            'docs table row {} has no reading source site — remove the '
            'row or re-add the variable'.format(var)))


# -- fault sites -----------------------------------------------------------

def _known_sites(project):
    """Parse ``KNOWN_SITES = (...)`` from faults.py statically."""
    for source in project.files:
        if not source.modname.endswith('faults'):
            continue
        for node in source.tree.body:
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == 'KNOWN_SITES'
                    for t in node.targets):
                if isinstance(node.value, (ast.Tuple, ast.List)):
                    return source, node.lineno, tuple(
                        elt.value for elt in node.value.elts
                        if isinstance(elt, ast.Constant)
                        and isinstance(elt.value, str))
        return source, 1, None
    return None, 1, None


def _injection_site_literals(project):
    """site -> first (path, line) of a literal passed to an inject-family
    call."""
    sites = {}
    for source in project.files:
        for node in ast.walk(source.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            func = node.func
            name = func.attr if isinstance(func, ast.Attribute) else (
                func.id if isinstance(func, ast.Name) else None)
            if name not in _INJECT_FUNCS:
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                sites.setdefault(arg.value, (source.path, node.lineno))
    return sites


def _all_string_literals(paths):
    found = set()
    for path in paths:
        try:
            with open(path, 'r', encoding='utf-8') as f:
                tree = ast.parse(f.read(), filename=path)
        except (OSError, SyntaxError):
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                found.add(node.value)
    return found


def _check_faults(project, repo, findings):
    faults_source, reg_line, known = _known_sites(project)
    if faults_source is None:
        return   # tree under analysis does not include faults.py
    if known is None:
        findings.append(Finding(
            CHECK_FAULT, faults_source.path, reg_line,
            'faults.py has no KNOWN_SITES literal tuple — the canonical '
            'fault-site registry the injection points are checked against'))
        return
    injected = _injection_site_literals(project)
    for site in sorted(set(injected) - set(known)):
        path, line = injected[site]
        findings.append(Finding(
            CHECK_FAULT, path, line,
            'fault site {!r} is injected but not declared in '
            'faults.KNOWN_SITES — declare it (and document it in '
            'docs/torch_guide.rst) or fix the typo'.format(site)))
    # Two-way: every declared site must be referenced somewhere real —
    # an injection point in the package or a test driving it.
    package_literals = set(injected)
    tests_dir = os.path.join(repo, 'tests')
    test_literals = _all_string_literals(iter_python_files(tests_dir)) \
        if os.path.isdir(tests_dir) else set()
    doc_path = os.path.join(repo, 'docs', 'torch_guide.rst')
    doc_text = ''
    if os.path.exists(doc_path):
        with open(doc_path, 'r', encoding='utf-8') as f:
            doc_text = f.read()
    documented = set(_SITE_DOC_RE.findall(doc_text))
    for site in known:
        if site not in package_literals and not any(
                site in lit for lit in test_literals):
            findings.append(Finding(
                CHECK_FAULT, faults_source.path, reg_line,
                'KNOWN_SITES entry {!r} has no injection point or test '
                'reference — dead registry rows hide real coverage '
                'gaps'.format(site)))
        if doc_text and site not in documented:
            findings.append(Finding(
                CHECK_FAULT, faults_source.path, reg_line,
                'fault site {!r} is not documented in '
                'docs/torch_guide.rst (expected a ``{}`` literal in the '
                'sites table)'.format(site, site)))
    if not doc_text:
        findings.append(Finding(
            CHECK_FAULT, doc_path, 1,
            'docs/torch_guide.rst not found — fault sites are '
            'documented there'))


# -- pytest markers --------------------------------------------------------

def _used_markers(tests_dir):
    """marker -> first (path, line) of a pytest.mark.<marker> use."""
    used = {}
    for path in iter_python_files(tests_dir):
        try:
            with open(path, 'r', encoding='utf-8') as f:
                tree = ast.parse(f.read(), filename=path)
        except (OSError, SyntaxError):
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) \
                    and isinstance(node.value, ast.Attribute) \
                    and node.value.attr == 'mark' \
                    and isinstance(node.value.value, ast.Name) \
                    and node.value.value.id == 'pytest':
                used.setdefault(node.attr, (path, node.lineno))
    return used


def _registered_markers(ini_path):
    parser = configparser.ConfigParser()
    parser.read(ini_path)
    if not parser.has_option('pytest', 'markers'):
        return {}
    registered = {}
    with open(ini_path, 'r', encoding='utf-8') as f:
        ini_text = f.read()
    for line in parser.get('pytest', 'markers').splitlines():
        line = line.strip()
        if not line:
            continue
        name = re.split(r'[(:]', line, 1)[0].strip()
        if name:
            registered[name] = _line_of(ini_text, line)
    return registered


def _check_markers(project, repo, findings):
    ini_path = os.path.join(repo, 'pytest.ini')
    tests_dir = os.path.join(repo, 'tests')
    if not os.path.exists(ini_path) or not os.path.isdir(tests_dir):
        findings.append(Finding(
            CHECK_MARKER, ini_path, 1,
            'pytest.ini / tests/ not found next to the analyzed package — '
            'marker registry cannot be checked'))
        return
    used = _used_markers(tests_dir)
    registered = _registered_markers(ini_path)
    for marker in sorted(set(used) - set(registered) - _BUILTIN_MARKERS):
        path, line = used[marker]
        findings.append(Finding(
            CHECK_MARKER, path, line,
            'pytest marker {!r} is used but not registered in pytest.ini — '
            'the fast CI lane (-m "not slow") must run '
            'warning-free'.format(marker)))
    for marker in sorted(set(registered) - set(used) - _BUILTIN_MARKERS):
        findings.append(Finding(
            CHECK_MARKER, ini_path, registered[marker],
            'pytest.ini registers marker {!r} but no test uses it — '
            'remove the registration or the tests that should carry it '
            'are missing'.format(marker)))


def check(project):
    findings = []
    repo = _repo_root(project)
    _check_env(project, repo, findings)
    _check_faults(project, repo, findings)
    _check_markers(project, repo, findings)
    return findings
