"""pintlint core: findings, suppression parsing, the rule registry,
and the file/project walker.

The runtime conventions this codebase depends on — lock discipline
on shared serving state and the process-wide module locks, a lock
order without cycles, fault-injection registry coverage, atomic
durable writes, one clock on the instrumented surface — are
invariants no generic linter knows about. pintlint turns them into
machine-checked rules: each rule is a small AST pass registered here,
findings carry a rule id that per-line comments can suppress, and a
project pass at the end lets cross-file rules (the fault registry) see
the whole tree.

Suppression syntax:

    t0 = time.perf_counter()  # pintlint: disable=timing-untraced
    # pintlint: disable=timing-untraced       <- alone: covers next line
    # pintlint: disable-file=timing-untraced  <- whole file

Every suppression should carry a justification in the surrounding
comment; the tree gate pins the suppressed count, so silent growth
fails a test.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field

SUPPRESS_RE = re.compile(
    r"#\s*pintlint:\s*(disable(?:-file)?)\s*=\s*([A-Za-z0-9_,\- ]+)")


@dataclass
class Finding:
    rule: str
    path: str
    line: int
    message: str
    suppressed: bool = False

    def as_dict(self):
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message, "suppressed": self.suppressed}

    def __str__(self):
        tag = " (suppressed)" if self.suppressed else ""
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}{tag}"


class Suppressions:
    """Per-file suppression map parsed from ``# pintlint:`` comments.

    A ``disable=`` comment suppresses its own line; when the comment is
    the only thing on its line it suppresses the NEXT line instead (so
    a long flagged expression can keep its own line short). ``all``
    matches every rule.
    """

    def __init__(self, source):
        self.line_rules = {}
        self.file_rules = set()
        for lineno, text in enumerate(source.splitlines(), start=1):
            m = SUPPRESS_RE.search(text)
            if not m:
                continue
            kind, raw = m.group(1), m.group(2)
            rules = {r.strip() for r in raw.split(",") if r.strip()}
            if kind == "disable-file":
                self.file_rules |= rules
            elif text.lstrip().startswith("#"):
                self.line_rules.setdefault(lineno + 1, set()).update(rules)
            else:
                self.line_rules.setdefault(lineno, set()).update(rules)

    def is_suppressed(self, rule, line):
        for rules in (self.file_rules, self.line_rules.get(line, ())):
            if rule in rules or "all" in rules:
                return True
        return False


class FileContext:
    """One parsed source file plus its findings."""

    def __init__(self, path, source, config, rel=None):
        self.path = path
        self.rel = rel or path
        self.source = source
        self.tree = ast.parse(source, filename=path)
        self.suppressions = Suppressions(source)
        self.config = config
        self.findings = []

    def report(self, rule_id, node, message):
        line = node if isinstance(node, int) else node.lineno
        self.findings.append(Finding(
            rule=rule_id, path=self.rel, line=line, message=message,
            suppressed=self.suppressions.is_suppressed(rule_id, line)))


class Project:
    """Whole-scan state for cross-file rules."""

    def __init__(self, config):
        self.config = config
        self.files = []          # FileContext per parsed file
        self.extra_findings = []  # parse failures etc.
        self.index = None        # ProjectIndex after the project pass
        self.lock_graph = None   # LockGraph from lock-order-cycle


class Rule:
    """Base class: subclasses set ``id``/``family``/``rationale`` and
    implement ``check_file`` (per file), ``finish`` (after every file
    was scanned — cross-file invariants), and/or ``check_project``
    (whole-program rules: runs with the cross-file ``ProjectIndex``
    after all files are parsed). Rules with ``whole_program = True``
    only run when the scan requests the project pass — the --changed
    inner loop skips them."""

    id = None
    family = None
    rationale = ""
    whole_program = False

    def check_file(self, ctx):
        pass

    def check_project(self, project, index):
        pass

    def finish(self, project):
        pass


RULES = {}


def register(cls):
    if cls.id in RULES:
        raise ValueError(f"duplicate rule id {cls.id!r}")
    RULES[cls.id] = cls
    return cls


def all_rules():
    """Fresh rule instances, id-sorted (stable output order)."""
    return [RULES[rid]() for rid in sorted(RULES)]


def iter_py_files(paths):
    for path in paths:
        if os.path.isfile(path):
            yield path
            continue
        for root, dirs, names in os.walk(path):
            dirs[:] = sorted(d for d in dirs
                             if d not in ("__pycache__", ".git"))
            for name in sorted(names):
                if name.endswith(".py"):
                    yield os.path.join(root, name)


def run(paths, config=None, rules=None, whole_program=True):
    """Lint ``paths`` (files or directory roots). Returns the full
    finding list — suppressed findings included, flagged — so callers
    can gate on unsuppressed ones while still counting the rest.
    ``whole_program=False`` skips the project-index pass and every
    whole-program rule (the fast inner-loop / --changed mode)."""
    findings, _ = run_project(paths, config=config, rules=rules,
                              whole_program=whole_program)
    return findings


def run_project(paths, config=None, rules=None, whole_program=True):
    """Like :func:`run` but also returns the ``Project`` — carrying
    the built ``ProjectIndex`` (``project.index``) and per-rule
    artifacts such as the lock-order graph (``project.lock_graph``)."""
    from .config import LintConfig

    config = config or LintConfig.default()
    rules = rules if rules is not None else all_rules()
    if not whole_program:
        rules = [r for r in rules if not r.whole_program]
    project = Project(config)
    base = os.path.commonpath([os.path.abspath(p) for p in paths]) \
        if paths else os.getcwd()
    if os.path.isfile(base):
        base = os.path.dirname(base)
    for path in iter_py_files(paths):
        with open(path, encoding="utf-8") as fh:
            source = fh.read()
        try:
            ctx = FileContext(path, source, config,
                              rel=os.path.relpath(path, base))
        except SyntaxError as e:
            project.extra_findings.append(Finding(
                rule="parse-error", path=path, line=e.lineno or 1,
                message=f"file does not parse: {e.msg}"))
            continue
        for rule in rules:
            rule.check_file(ctx)
        project.files.append(ctx)
    if whole_program and any(r.whole_program for r in rules):
        from .project import build_index

        project.index = build_index(project)
        for rule in rules:
            if rule.whole_program:
                rule.check_project(project, project.index)
    for rule in rules:
        rule.finish(project)
    findings = list(project.extra_findings)
    for ctx in project.files:
        findings.extend(ctx.findings)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings, project


def unsuppressed(findings):
    return [f for f in findings if not f.suppressed]


def counts_by_rule(findings):
    out = {}
    for f in findings:
        key = f.rule + (":suppressed" if f.suppressed else "")
        out[key] = out.get(key, 0) + 1
    return dict(sorted(out.items()))


# -- shared AST helpers used by several rule modules -------------------


def call_name(node):
    """Dotted name of a Call's callee: ``torch.func.vmap`` ->
    "torch.func.vmap",
    ``jit`` -> "jit"; None for computed callees."""
    return dotted_name(node.func)


def dotted_name(node):
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def self_attr_root(node):
    """Peel subscripts/attributes down to a root ``self.X`` access:
    ``self._slots[k]`` -> "_slots"; None when the root is not a direct
    self attribute."""
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            return node.attr
        node = node.value
    return None


def name_root(node):
    """Peel subscripts down to a plain Name: ``CACHE[k]`` -> "CACHE"."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return None


MUTATOR_METHODS = frozenset({
    "append", "appendleft", "add", "clear", "discard", "extend",
    "insert", "move_to_end", "pop", "popitem", "popleft", "remove",
    "setdefault", "update", "__setitem__", "__delitem__", "rotate",
})


def mentions(node, pattern):
    """True when any identifier inside ``node`` matches the compiled
    regex ``pattern`` (Name ids and Attribute attrs both count)."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and pattern.search(sub.id):
            return True
        if isinstance(sub, ast.Attribute) and pattern.search(sub.attr):
            return True
    return False
