"""Bench-trajectory store + budget regression gate, held to the card's
own rounds.

A benchmark run leaves one file per round — ``BENCH_r0*.json`` /
``MULTICHIP_r0*.json`` — and ``budgets.json`` (next to this module)
carries the bounds those numbers must honor. This module makes the
comparison executable:

- :func:`load_history` ingests the round files into one trajectory
  (the headline metric plus every scalar ``detail`` key, flattened).
  It keeps only the rounds whose ``parsed.detail.platform`` names the
  card (``"gpu"``): a repo may also hold another platform's rounds
  (the JAX package's CPU/TPU trajectory), and the card must never be
  judged by them.
- ``budgets.json`` is the port's copy of the JAX package's budget
  file: absolute ``budgets`` (bind whenever the key is present in the
  latest round), curated ``regressions`` keys (gated against history
  with robust median+MAD tolerances), and a ``tracked`` allowlist
  (emitted, deliberately not gated). An absolute time bound taken on
  or for a TPU is not a bound of the card: those keys sit under
  ``tracked`` until a round of the card sets them (the file's
  ``_comment`` lists them). pintlint's ``meta-key-unbudgeted`` rule
  closes the loop: a ``measured_*``/``serve_*`` key a round writer
  emits must appear in one of the three sections.
- :func:`run_regress` is the gate: ``python -m pint_tpu_torch.obs
  regress`` exits nonzero on any budget violation or regression, and
  on a root holding no round of the card.

Regression detection: for each curated key with at least
``min_prior`` recorded rounds, the latest value must stay within
``max(rel_floor, k_mad * 1.4826 * MAD / |median|)`` of the prior
median, direction-aware (a *faster* wall or *higher* throughput is
never flagged). MAD (vs stddev) keeps one historic outlier round from
inflating the tolerance; the relative floor keeps a suspiciously
quiet history from flagging benign jitter.

A round the port writes carries ``platform: "gpu"`` and, beside it,
``device_kind`` and ``power_limit_w`` as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` gives them;
strings are not trajectory points, so :func:`_flatten` leaves them out.
"""

from __future__ import annotations

import glob
import json
import os
import re

BUDGETS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "budgets.json")

# the platform a round of the card names (``parsed.detail.platform``)
CARD_PLATFORM = "gpu"

_ROUND_RE = re.compile(r"_r(\d+)\.json$")


def load_budgets(path=None):
    """The machine-readable budget spec (see module docstring)."""
    with open(path or BUDGETS_PATH) as fh:
        return json.load(fh)


def registered_keys(spec=None):
    """Every meta key the budget file knows about — budgets,
    regression-gated, and tracked. The pintlint meta-key-unbudgeted
    rule checks a round writer's literal keys against this set."""
    if spec is None:
        spec = load_budgets()
    keys = set(spec.get("budgets", {}))
    keys.update(spec.get("regressions", {}))
    keys.update(spec.get("tracked", []))
    return keys


def _flatten(mapping, prefix=""):
    """Scalar numeric leaves of a nested dict, dotted keys. Bools and
    non-numerics are not trajectory points; lists are skipped (the
    per-program rollups are inspected by humans, not gated)."""
    out = {}
    for key, val in mapping.items():
        name = "%s%s" % (prefix, key)
        if isinstance(val, dict):
            out.update(_flatten(val, prefix=name + "."))
        elif isinstance(val, bool):
            continue
        elif isinstance(val, (int, float)):
            out[name] = float(val)
    return out


def _read(path):
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


def load_history(root):
    """The round-by-round trajectory: a sorted list of
    {"round", "path", "values"} where values maps metric key ->
    float. The headline parsed metric lands under its own name
    (``pta_gls_refit_toas_per_sec``); MULTICHIP round files
    contribute ``multichip_rc`` / ``multichip_ok`` /
    ``multichip_n_devices``.

    Only the card's rounds are kept: a BENCH round whose
    ``parsed.detail.platform`` is :data:`CARD_PLATFORM`, and a
    MULTICHIP file only beside a kept round."""
    rounds = {}
    for path in sorted(glob.glob(os.path.join(root, "BENCH_r*.json"))):
        m = _ROUND_RE.search(path)
        if not m:
            continue
        rnd = int(m.group(1))
        doc = _read(path)
        if doc is None:
            continue
        parsed = doc.get("parsed") or {}
        detail = parsed.get("detail") or {}
        if detail.get("platform") != CARD_PLATFORM:
            continue
        values = _flatten(detail)
        metric = parsed.get("metric")
        if metric and isinstance(parsed.get("value"), (int, float)):
            values[str(metric)] = float(parsed["value"])
        rounds.setdefault(rnd, {"round": "r%02d" % rnd, "values": {},
                                "null_reasons": {}})
        rounds[rnd]["values"].update(values)
        # the round writer's reason-coded nulls ride along so the
        # regression gate can tell a deliberate skip from missing history
        nulls = detail.get("null_reasons")
        if isinstance(nulls, dict):
            rounds[rnd]["null_reasons"].update(
                {str(k): str(v) for k, v in nulls.items()})
        rounds[rnd]["path"] = path
    for path in sorted(glob.glob(os.path.join(root,
                                              "MULTICHIP_r*.json"))):
        m = _ROUND_RE.search(path)
        if not m:
            continue
        rnd = int(m.group(1))
        if rnd not in rounds:
            continue
        doc = _read(path)
        if doc is None:
            continue
        entry = rounds[rnd]
        entry["values"]["multichip_ok"] = float(bool(doc.get("ok")))
        if isinstance(doc.get("rc"), (int, float)):
            entry["values"]["multichip_rc"] = float(doc["rc"])
        if isinstance(doc.get("n_devices"), (int, float)):
            entry["values"]["multichip_n_devices"] = float(
                doc["n_devices"])
    return [rounds[k] for k in sorted(rounds)]


def _median(vals):
    v = sorted(vals)
    n = len(v)
    if n == 0:
        return None
    mid = n // 2
    return v[mid] if n % 2 else 0.5 * (v[mid - 1] + v[mid])


def robust_tolerance(prior, rel_floor, k_mad):
    """Relative tolerance from the prior rounds: the MAD-derived
    robust sigma scaled by k_mad, floored at rel_floor."""
    med = _median(prior)
    if not med:
        return rel_floor, med
    mad = _median([abs(x - med) for x in prior])
    sigma = 1.4826 * mad
    return max(rel_floor, k_mad * sigma / abs(med)), med


def check_budgets(latest_values, spec):
    """Absolute-budget violations in the latest round. A budget binds
    only when its key is present (a stage that did not run leaves its
    keys out: an absent key is a skipped stage, not a violation)."""
    violations = []
    for key, bound in spec.get("budgets", {}).items():
        val = latest_values.get(key)
        if val is None:
            continue
        if "max" in bound and val > float(bound["max"]):
            violations.append({
                "key": key, "value": val, "budget_max": bound["max"],
                "source": bound.get("source"),
                "detail": "%s = %g exceeds budget max %g"
                          % (key, val, bound["max"])})
        if "min" in bound and val < float(bound["min"]):
            violations.append({
                "key": key, "value": val, "budget_min": bound["min"],
                "source": bound.get("source"),
                "detail": "%s = %g below budget min %g"
                          % (key, val, bound["min"])})
    return violations


def _regression(key, latest_val, med, ratio, tol, direction):
    return {"key": key, "latest": latest_val, "median": med,
            "ratio": round(ratio, 4), "tolerance": round(tol, 4),
            "direction": direction,
            "detail": "%s regressed: %g vs median %g (x%.3f, tol %.1f%%)"
                      % (key, latest_val, med, ratio, 100 * tol)}


def check_regressions(history, spec):
    """(regressions, checked_keys, skipped) over the curated
    regression keys. Direction-aware: "lower" keys flag only an
    increase, "higher" keys only a decrease."""
    defaults = spec.get("defaults", {})
    rel_floor = float(defaults.get("rel_floor", 0.10))
    k_mad = float(defaults.get("k_mad", 4.0))
    min_prior = int(defaults.get("min_prior", 3))
    regressions, checked, skipped = [], [], {}
    if not history:
        return regressions, checked, skipped
    latest = history[-1]["values"]
    latest_nulls = history[-1].get("null_reasons") or {}
    prior_rounds = history[:-1]
    for key, conf in spec.get("regressions", {}).items():
        direction = conf.get("direction", "lower")
        floor = float(conf.get("rel_floor", rel_floor))
        need = int(conf.get("min_prior", min_prior))
        latest_val = latest.get(key)
        if latest_val is None:
            # a reason-coded null is the round writer saying "skipped
            # on purpose" — record the reason, not a missing-history alarm
            reason = latest_nulls.get(key)
            skipped[key] = ("null: %s" % reason if reason
                            else "missing_in_latest")
            continue
        prior = [r["values"][key] for r in prior_rounds
                 if r["values"].get(key) is not None]
        if len(prior) < need:
            skipped[key] = "insufficient_history (%d < %d)" % (
                len(prior), need)
            continue
        tol, med = robust_tolerance(prior, floor, k_mad)
        checked.append(key)
        if med is None or med == 0:
            continue
        ratio = latest_val / med
        if (direction == "lower" and ratio > 1.0 + tol) or (
                direction == "higher" and ratio < 1.0 - tol):
            regressions.append(_regression(key, latest_val, med, ratio,
                                           tol, direction))
    return regressions, checked, skipped


def find_root(root=None):
    """Directory holding the BENCH_r*.json trajectory: the explicit
    argument, else the cwd when it has round files, else the repo
    root this package is installed from."""
    if root:
        return root
    cwd = os.getcwd()
    if glob.glob(os.path.join(cwd, "BENCH_r*.json")):
        return cwd
    return os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))


def run_regress(root=None, budgets_path=None, history=None, spec=None):
    """The full gate: load history (the card's rounds only; see
    :func:`load_history`) + budgets, check both, return the report.
    ``ok`` is False on any budget violation or regression, and when no
    round is left — the CLI keys its exit status off it."""
    if spec is None:
        spec = load_budgets(budgets_path)
    root = find_root(root)
    if history is None:
        history = load_history(root)
    report = {
        "root": root,
        "rounds": [h["round"] for h in history],
        "n_rounds": len(history),
        "latest": history[-1]["round"] if history else None,
    }
    if not history:
        report.update(ok=False,
                      error="no BENCH_r*.json round of platform %s in %s"
                      % (CARD_PLATFORM, root), regressions=[],
                      budget_violations=[], checked=[], skipped={})
        return report
    latest_values = history[-1]["values"]
    violations = check_budgets(latest_values, spec)
    regressions, checked, skipped = check_regressions(history, spec)
    report.update(
        ok=not violations and not regressions,
        budget_violations=violations,
        regressions=regressions,
        checked=checked,
        skipped=skipped,
    )
    return report
