"""Fault-injection coverage rule family.

- fault-point-unknown: a fire()/inject()/FaultPoint() site naming a
  point that is not in the registry (the site would silently never
  fire — chaos coverage that tests nothing).
- fault-point-unfired: a registered point with no fire() site in the
  scanned tree (a failure mode the registry promises deterministic
  coverage for, with no code path that can exercise it).
"""

from __future__ import annotations

import ast

from .config import FAULT_CALLS
from .core import Rule, call_name, register


def _parse_points(tree, name="POINTS"):
    """A string-tuple assignment of a registry module, or None."""
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == name:
                    if isinstance(node.value, (ast.Tuple, ast.List)):
                        vals = [el.value for el in node.value.elts
                                if isinstance(el, ast.Constant)]
                        return tuple(vals), node.lineno
    return None


def _find_registry(project, name="POINTS"):
    """(parsed tuple+lineno, FileContext) of the registry module in the
    scanned tree, or (None, None)."""
    suffix = project.config.fault_registry_suffix
    for ctx in project.files:
        path = ctx.path.replace("\\", "/")
        if path.endswith(suffix):
            parsed = _parse_points(ctx.tree, name)
            if parsed:
                return parsed, ctx
            break
    return None, None


def _point_sites(tree):
    """(name, node) for every call that names a fault point as its
    first string-literal argument."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node)
        if name not in FAULT_CALLS:
            continue
        if node.args and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            yield name, node.args[0].value, node


@register
class FaultPointCoverageRule(Rule):
    """The faultinject registry's value is that every failure mode has
    a NAMED, armable point. A typo'd name at a fire() site is a dead
    injection point (FaultPoint() raises, but fire('typo') just never
    fires); a registered point nobody fires is a failure mode the
    chaos suite believes is covered but cannot actually trigger. Both
    directions are checked against the POINTS tuple parsed from the
    registry module in the scanned tree."""

    id = "fault-point-unknown"
    family = "faults"
    rationale = ("a fire()/inject() site naming an unregistered point "
                 "never fires; the chaos coverage is imaginary")

    def finish(self, project):
        cfg = project.config
        registry, registry_ctx = _find_registry(project)
        if cfg.fault_points is not None:
            points = set(cfg.fault_points)
        elif registry is not None:
            points = set(registry[0])
        else:
            return  # no registry in scope: nothing to check against
        fired = set()
        for ctx in project.files:
            for call, point, node in _point_sites(ctx.tree):
                # only real fire() sites count as coverage; inject()/
                # FaultPoint() arm a point but exercise nothing
                if call.rsplit(".", 1)[-1] == "fire":
                    fired.add(point)
                if point not in points:
                    ctx.report(
                        self.id, node,
                        f"{call}({point!r}): unregistered fault point "
                        f"(known: {', '.join(sorted(points))})")
        if registry_ctx is not None:
            unfired = points - fired
            for point in sorted(unfired):
                registry_ctx.report(
                    "fault-point-unfired", registry[1],
                    f"registered fault point '{point}' has no fire() "
                    f"site in the scanned tree: the failure mode it "
                    f"names cannot be exercised")


@register
class FaultPointUnfiredRule(Rule):
    """Registry side of the coverage check; findings are emitted by
    FaultPointCoverageRule.finish (one scan of the tree serves both
    directions), registered separately so the id can be listed and
    suppressed on its own."""

    id = "fault-point-unfired"
    family = "faults"
    rationale = ("a registered point with no fire() site is promised "
                 "chaos coverage that cannot be triggered")


@register
class FaultPointUntestedRule(Rule):
    """Device-level fault points (the registry's DEVICE_POINTS tuple:
    device_loss, collective_timeout, straggler_delay) model failures
    of a whole chip, not of one request — a fire() site alone proves
    the code CAN inject them, not that the recovery ladder (lane
    quarantine, work stealing, checkpoint resume) is ever driven. Each
    device point must be ARMED — inject()/FaultPoint() with the point
    as its first argument — from at least one test file. Runs only
    when both the registry and at least one test file are in the scan,
    so a package-only lint stays quiet."""

    id = "fault-point-untested"
    family = "faults"
    rationale = ("a device-level fault point no test arms means the "
                 "quarantine/steal/resume path it exists to exercise "
                 "is never driven in CI")

    def finish(self, project):
        cfg = project.config
        if cfg.device_fault_points is not None:
            device_points = tuple(cfg.device_fault_points)
            registry, registry_ctx = _find_registry(project)
        else:
            registry, registry_ctx = _find_registry(
                project, "DEVICE_POINTS")
            if registry is None:
                return
            device_points = registry[0]
        if registry_ctx is None:
            return
        markers = tuple(cfg.test_path_markers)

        def _is_test(path):
            # dir markers ("/tests/") match anywhere in the path;
            # file markers ("/test_") match the basename only — a
            # "test_*" substring in a parent directory (pytest tmp
            # dirs are named after the test) must not count
            p = "/" + path.replace("\\", "/")
            base = p.rsplit("/", 1)[-1]
            return any(m in p if m.endswith("/")
                       else base.startswith(m.lstrip("/"))
                       for m in markers)

        test_ctxs = [ctx for ctx in project.files
                     if _is_test(ctx.path)]
        if not test_ctxs:
            return  # package-only scan: nothing to prove
        armed = set()
        for ctx in test_ctxs:
            for call, point, _node in _point_sites(ctx.tree):
                # arming is inject()/FaultPoint(); a bare fire() in a
                # test exercises nothing unless a point is armed, and
                # fire() in test helpers is rare enough to ignore
                if call.rsplit(".", 1)[-1] in ("inject", "FaultPoint"):
                    armed.add(point)
        line = registry[1] if registry is not None else 1
        for point in sorted(set(device_points) - armed):
            registry_ctx.report(
                self.id, line,
                f"device-level fault point '{point}' is never armed "
                f"(inject()/FaultPoint()) by any test in the scanned "
                f"tree: its quarantine/steal/resume recovery path is "
                f"untested")
