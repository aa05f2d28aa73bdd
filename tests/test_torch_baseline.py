"""The port's regression gate (pint_tpu_torch/obs/baseline.py, its
budgets.json, ``python -m pint_tpu_torch.obs regress``/``doctor``) and
pintlint's budget rule (analysis/rules_budget.py), against the JAX
package's.

- Parity: seeded rounds (numpy, in ``tmp_path``) go through both
  packages' ``load_history``, ``robust_tolerance``, ``check_budgets``,
  ``check_regressions`` and ``run_regress`` under one spec, every round
  one of the card (``platform: "gpu"``, a string the JAX gate skips):
  the reports are equal, ``null_reasons`` and MULTICHIP rounds included. ``regress``/``doctor`` print the JAX
  package's output and exit with its code on rounds of the card.
- The JAX package's gate tests (tests/test_perf_observatory.py) on rounds
  of the card, the CLI in process.
- The card filter: a round of another platform is never loaded (the
  repo's own rounds are the JAX package's CPU/TPU ones), a MULTICHIP
  file follows its round, and a root without a round of the card fails.
- The port's budgets.json is the JAX one but for the time bounds taken
  for a TPU, which moved to ``tracked``.
- meta-key-unbudgeted as tests/test_perf_observatory.py tests it, bound
  to ``chip_smoke.py``, whose own keys are all registered; and
  ``chip_smoke.py``'s ``[regress]`` phase rehearsed on the host.

Everything runs in process (no subprocess), in a few seconds.
"""

import copy
import json
import os

import numpy as np
import pytest

from pint_tpu.obs import baseline as jbase
from pint_tpu_torch.obs import baseline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOVED_TO_TRACKED = ("measured_670k_store_warm_prep_pack_s",)


def _doc(detail, value=1e5):
    return {"parsed": {"metric": "pta_gls_refit_toas_per_sec",
                       "value": value, "detail": detail}}


def _write(root, name, doc):
    with open(os.path.join(str(root), name), "w") as fh:
        json.dump(doc, fh)


def _seeded_rounds(root, seed):
    """6 BENCH rounds and 2 MULTICHIP files from a numpy seed: the
    curated regression keys jittered about 1 (the latest round slowed,
    sped up or left by the seed), a budget key near its bound, nested,
    boolean, string and list values, a key missing from the latest
    round, reason-coded nulls and a MULTICHIP file beside a round."""
    rng = np.random.default_rng(seed)
    step = rng.choice([0.7, 1.0, 1.3])
    n = 6
    for i in range(1, n + 1):
        jit = 1.0 + 0.02 * rng.standard_normal(4)
        last = i == n
        detail = {
            "platform": "gpu",
            "wls_refit_wall_s": float(jit[0] * (step if last else 1.0)),
            "measured_670k_gls_refit_s": float(jit[1]),
            "gw_pairs_per_s": float(1e6 * jit[2] / (step if last else 1.0)),
            "measured_670k_plan_padding_ratio": float(
                1.0 + rng.uniform(0.0, 0.1)),
            "chaos_kill_lost": int(rng.integers(0, 2)),
            "nested": {"a": float(jit[3]), "flag": True, "name": "x"},
            "measured_670k_programs": [1, 2],
            "measured_670k_fleet_pipeline_bitwise": True,
        }
        if not last:
            detail["serve_p99_latency_ms"] = float(10.0 * jit[0])
        else:
            detail["null_reasons"] = {
                "htest_4M_photons_s": "stage_incomplete",
                "gls_mfu_pct": "skipped:PINT_TPU_BENCH_SKIP_FULL=1"}
        _write(root, "BENCH_r%02d.json" % i,
               _doc(detail, value=float(1e5 * jit[0])))
    _write(root, "MULTICHIP_r03.json", {"ok": True, "rc": 0,
                                        "n_devices": 8})
    return str(root)


@pytest.mark.parametrize("seed", range(6))
def test_gate_matches_jax_on_seeded_rounds(tmp_path, seed):
    """Every function of the gate gives the JAX package's result on the
    same rounds of the card and spec (the JAX budgets)."""
    root = _seeded_rounds(tmp_path, seed)
    spec = jbase.load_budgets()
    bench = baseline.load_history(root)
    assert bench == jbase.load_history(root)
    assert len(bench) == 6 and "multichip_ok" in bench[2]["values"]
    assert bench[-1]["null_reasons"]["htest_4M_photons_s"] == \
        "stage_incomplete"
    assert baseline.check_budgets(bench[-1]["values"], spec) == \
        jbase.check_budgets(bench[-1]["values"], spec)
    assert baseline.check_regressions(bench, spec) == \
        jbase.check_regressions(bench, spec)
    for key in ("wls_refit_wall_s", "gw_pairs_per_s"):
        prior = [r["values"][key] for r in bench[:-1]]
        assert baseline.robust_tolerance(prior, 0.1, 4.0) == \
            jbase.robust_tolerance(prior, 0.1, 4.0)
    assert baseline.run_regress(root, spec=spec) == \
        jbase.run_regress(root, spec=spec)
    assert baseline.run_regress(root, spec=spec, history=bench) == \
        jbase.run_regress(root, spec=spec, history=bench)


def _write_rounds(tmp_path, walls, key="wls_refit_wall_s",
                  extra_latest=None, platform="gpu"):
    """Synthetic BENCH_r0*.json trajectory of the card with one detail
    key (tests/test_perf_observatory.py's helper, with a platform)."""
    for i, wall in enumerate(walls, start=1):
        detail = {key: wall, "platform": platform}
        if extra_latest and i == len(walls):
            detail.update(extra_latest)
        _write(tmp_path, "BENCH_r%02d.json" % i, _doc(detail))
    return str(tmp_path)


def test_regress_fails_on_injected_20pct_slowdown(tmp_path):
    root = _write_rounds(tmp_path, [1.00, 1.002, 0.998, 1.001, 0.999, 1.20])
    report = baseline.run_regress(root=root)
    assert not report["ok"]
    (viol,) = [r for r in report["regressions"]
               if r["key"] == "wls_refit_wall_s"]
    assert viol["ratio"] > 1.15
    assert "regressed" in viol["detail"]


def test_regress_direction_aware(tmp_path):
    root = _write_rounds(tmp_path, [1.00, 1.002, 0.998, 1.001, 0.999, 0.50])
    report = baseline.run_regress(root=root)
    assert report["ok"], report["regressions"]


def test_regress_min_prior_gate(tmp_path):
    root = _write_rounds(tmp_path, [1.0, 1.0, 5.0])
    report = baseline.run_regress(root=root)
    assert report["ok"]
    assert "insufficient_history" in report["skipped"]["wls_refit_wall_s"]


def test_regress_budget_violation_binds_when_present(tmp_path):
    root = _write_rounds(
        tmp_path, [1.0, 1.0, 1.0, 1.0],
        extra_latest={"measured_670k_plan_padding_ratio": 1.50})
    report = baseline.run_regress(root=root)
    assert not report["ok"]
    (viol,) = report["budget_violations"]
    assert viol["key"] == "measured_670k_plan_padding_ratio"
    assert "exceeds budget max" in viol["detail"]
    # absent from the latest round: a skipped stage, not a violation
    (tmp_path / "one").mkdir()
    assert baseline.run_regress(
        root=_write_rounds(tmp_path / "one", [1.0]))["budget_violations"] \
        == []


def test_robust_tolerance_mad_beats_outlier():
    tol, med = baseline.robust_tolerance([1.0, 1.0, 1.0, 1.0, 10.0],
                                         rel_floor=0.10, k_mad=4.0)
    assert med == 1.0
    assert tol == 0.10


def test_registered_keys_cover_all_sections():
    keys = baseline.registered_keys()
    assert "measured_670k_mfu_pct" in keys        # regressions
    assert "measured_670k_padding_ratio" in keys  # budgets
    assert "serve_cache_hit_rate" in keys         # tracked
    assert set(MOVED_TO_TRACKED) <= keys          # moved, still known


def _main(capsys, *argv, pkg="pint_tpu_torch"):
    """(exit code, stdout, stderr) of ``pkg``'s obs CLI in process."""
    import importlib

    rc = importlib.import_module(pkg + ".obs.__main__").main(list(argv))
    out = capsys.readouterr()
    return rc, out.out, out.err


def _jmain(capsys, *argv):
    return _main(capsys, *argv, pkg="pint_tpu")


@pytest.mark.parametrize("walls,rc", [
    ([1.0, 1.001, 0.999, 1.0, 1.0], 0),
    ([1.0, 1.001, 0.999, 1.0, 1.3], 1),
])
def test_regress_cli_exit_codes_and_output_match_jax(tmp_path, capsys,
                                                     walls, rc):
    """In process, on rounds of the card: the exit code, the text and
    the --json report are the JAX package's."""
    root = _write_rounds(tmp_path, walls)
    for fmt in ((), ("--json",)):
        got = _main(capsys, "regress", "--root", root, *fmt)
        want = _jmain(capsys, "regress", "--root", root, *fmt)
        assert got == want
        assert got[0] == rc
    if rc:
        assert "wls_refit_wall_s" in got[1] + got[2]
    else:
        assert json.loads(got[1])["ok"] is True


def _snap(requests, ok):
    return {"requests": requests, "requests_ok": ok,
            "counters": {"shed_queue_full": 0, "rejected_circuit_open": 0,
                         "errors": 0},
            "total_s": {"p50": 0.005, "p99": 0.01, "max": 0.01},
            "devices": {"n_lanes": 4, "alive_lanes": 4, "lost_lanes": []}}


def _fitq(**over):
    snap = {"counters": {"fits": 100, "fallbacks": 1, "diverged": 0,
                         "drift_alarms": 0},
            "max_abs_chi2_z": 2.1, "max_condition": 5e4,
            "max_relres": 3e-9, "probe_wall_s": 0.001,
            "n_pulsars": 68, "pulsars": {}}
    snap.update(over)
    return snap


@pytest.mark.parametrize("case,rc,failures", [
    ("regress_only", 0, []),
    ("regress_fails", 1, ["regress"]),
    ("slo_quiet", 0, []),
    ("slo_alerting", 1, ["slo"]),
    ("fitq_ok", 0, []),
    ("fitq_inflated", 1, ["fitq"]),
])
def test_doctor_matches_jax(tmp_path, capsys, case, rc, failures):
    """doctor with and without --slo-snapshots / --fitq-snapshot on
    rounds of the card: the JAX package's exit code and output, text
    and --json."""
    walls = [1.0, 1.0, 1.0, 1.0, 1.3 if case == "regress_fails" else 1.0]
    root = _write_rounds(tmp_path, walls)
    extra = []
    if case.startswith("slo"):
        paths = []
        for i in range(40 if case == "slo_alerting" else 1):
            p = tmp_path / ("s%02d.json" % i)
            n = 100 * (i + 1)
            p.write_text(json.dumps(_snap(n, 0 if case == "slo_alerting"
                                          else n)))
            paths.append(str(p))
        extra = ["--slo-snapshots", *paths]
    elif case.startswith("fitq"):
        p = tmp_path / "fitq.json"
        p.write_text(json.dumps(_fitq(**({"max_abs_chi2_z": 42.0}
                                         if case == "fitq_inflated"
                                         else {}))))
        extra = ["--fitq-snapshot", str(p)]
    got = _main(capsys, "doctor", "--root", root, "--json", *extra)
    assert got == _jmain(capsys, "doctor", "--root", root, "--json", *extra)
    assert got[0] == rc
    assert json.loads(got[1])["failures"] == failures
    text = _main(capsys, "doctor", "--root", root, *extra)
    assert text == _jmain(capsys, "doctor", "--root", root, *extra)
    assert text[1].startswith("doctor: %s" % ("FAIL" if rc else "OK"))


@pytest.mark.parametrize("platform", ["cpu", "tpu", None])
def test_another_platforms_round_is_not_loaded(tmp_path, platform):
    """A round of another platform (or naming none) among the card's is
    never loaded, nor gated; the JAX gate loads and gates it."""
    root = _write_rounds(tmp_path, [1.0, 1.0, 1.0, 1.0])
    detail = {"wls_refit_wall_s": 5.0}
    if platform:
        detail["platform"] = platform
    _write(root, "BENCH_r05.json", _doc(detail))
    report = baseline.run_regress(root=root)
    assert report["rounds"] == ["r01", "r02", "r03", "r04"]
    assert report["ok"] and report["regressions"] == []
    every = jbase.run_regress(root=root)
    assert every["latest"] == "r05" and not every["ok"]


@pytest.mark.parametrize("platform", ["cpu", "tpu"])
def test_only_other_platforms_rounds_fail_the_gate(tmp_path, capsys,
                                                   platform):
    """A root holding only another platform's rounds has no history of
    the card: ok False with the platform named, and regress/doctor exit
    1 (never 0 on another platform's history, never 2)."""
    root = _write_rounds(tmp_path, [1.0, 1.0, 1.0, 1.0],
                         platform=platform)
    report = baseline.run_regress(root=root)
    assert not report["ok"] and report["n_rounds"] == 0
    assert report["error"] == (
        "no BENCH_r*.json round of platform gpu in %s" % root)
    assert jbase.run_regress(root=root)["ok"]
    for cmd in ("regress", "doctor"):
        rc, out, err = _main(capsys, cmd, "--root", root)
        assert rc == 1, (out, err)
    assert "platform gpu" in _main(capsys, "regress", "--root", root)[2]


def test_multichip_follows_its_round(tmp_path):
    """A MULTICHIP file joins the card's round of its number, and is
    dropped with another platform's round or with none."""
    _write_rounds(tmp_path, [1.0])
    _write(tmp_path, "BENCH_r02.json",
           _doc({"wls_refit_wall_s": 1.0, "platform": "tpu"}))
    for n in (1, 2, 3):
        _write(tmp_path, "MULTICHIP_r%02d.json" % n,
               {"ok": True, "rc": 0, "n_devices": 8})
    hist = baseline.load_history(str(tmp_path))
    assert [h["round"] for h in hist] == ["r01"]
    assert hist[0]["values"]["multichip_n_devices"] == 8.0
    every = jbase.load_history(str(tmp_path))
    assert [h["round"] for h in every] == ["r01", "r02", "r03"]


def test_repo_rounds_are_not_the_cards(monkeypatch, capsys):
    """The repo's BENCH_r*.json are the JAX package's CPU/TPU rounds:
    the JAX gate passes on them, the port's loads none and exits 1 from
    the repo root (find_root takes the cwd)."""
    assert jbase.run_regress(root=REPO)["n_rounds"] >= 3
    report = baseline.run_regress(root=REPO)
    assert report["n_rounds"] == 0 and not report["ok"]
    monkeypatch.chdir(REPO)
    rc, out, _ = _main(capsys, "regress")
    assert rc == 1 and out.startswith("regress: FAIL over 0 rounds")
    assert _main(capsys, "doctor")[0] == 1


def test_card_round_fields_are_not_trajectory_points(tmp_path):
    """platform, device_kind and power_limit_w (nvidia-smi's strings)
    ride in the detail without becoming values."""
    detail = {"platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3",
              "power_limit_w": "700.00 W", "wls_refit_wall_s": 1.0}
    _write(tmp_path, "BENCH_r01.json", _doc(detail))
    (h,) = baseline.load_history(str(tmp_path))
    assert h["values"] == {"wls_refit_wall_s": 1.0,
                           "pta_gls_refit_toas_per_sec": 1e5}


def test_budgets_are_the_jax_ones_less_tpu_time_bounds():
    """Same keys in the union of the three sections; every absolute
    time bound moved to ``tracked`` is listed in the ``_comment``;
    contracts (counts, ratios, parity, overhead percentages) kept, the
    kill matrix's cold/warm ratio at 2.0."""
    port, jax = baseline.load_budgets(), jbase.load_budgets()
    assert baseline.BUDGETS_PATH != jbase.BUDGETS_PATH
    assert baseline.registered_keys(port) == jbase.registered_keys(jax)
    assert port["defaults"] == jax["defaults"]
    assert port["regressions"] == jax["regressions"]
    moved = set(jax["budgets"]) - set(port["budgets"])
    assert moved == set(MOVED_TO_TRACKED)
    assert moved <= set(port["tracked"])
    comment = "\n".join(port["_comment"])
    assert "port" in comment
    for key in moved:
        assert key in comment
    def bounds(budgets):
        return {k: {m: v[m] for m in ("max", "min") if m in v}
                for k, v in budgets.items() if k not in moved}

    assert bounds(jax["budgets"]) == bounds(port["budgets"])
    assert all(v["source"] for v in port["budgets"].values())
    assert port["budgets"]["chaos_kill_cold_vs_warm_ratio"]["max"] == 2.0
    assert set(port["tracked"]) - moved == set(jax["tracked"])


# -- pintlint meta-key-unbudgeted ---------------------------------------


def _lint(tmp_path, rel, src, cfg, pkg="pint_tpu_torch"):
    import importlib
    import textwrap

    mod = importlib.import_module(pkg + ".analysis")
    p = tmp_path / pkg / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(src))
    return [f for f in mod.unsuppressed(mod.run([str(p)], config=cfg))
            if f.rule == "meta-key-unbudgeted"]


BAD = """
    meta.update({"measured_670k_shiny_new_s": 1.0,
                 "serve_known": 2.0,
                 "not_a_meta_key": 3.0,
                 "chaos_new": {"gw_inner": 1}})
"""


def test_meta_key_rule_flags_unregistered_key(tmp_path):
    from pint_tpu_torch.analysis import LintConfig

    cfg = LintConfig(budget_meta_modules=("/chip_smoke.py",),
                     budgeted_meta_keys=frozenset({"serve_known"}))
    found = _lint(tmp_path, "chip_smoke.py", BAD, cfg)
    assert [f.message.split("'")[1] for f in found] == [
        "measured_670k_shiny_new_s", "chaos_new", "gw_inner"]
    assert "pint_tpu_torch/obs/budgets.json" in found[0].message


def test_meta_key_rule_matches_jax(tmp_path):
    """The JAX rule on the same file under the same registries: the same
    keys at the same lines; the message names each package's file and
    gate."""
    import pint_tpu.analysis as ja
    import pint_tpu_torch.analysis as ta

    kw = dict(budget_meta_modules=("/bench.py",),
              budgeted_meta_keys=frozenset({"serve_known"}))
    got = _lint(tmp_path, "bench.py", BAD, ta.LintConfig(**kw))
    want = _lint(tmp_path, "bench.py", BAD, ja.LintConfig(**kw),
                 pkg="pint_tpu")
    assert [f.line for f in got] == [f.line for f in want] == [2, 5, 5]
    assert [f.message.replace("pint_tpu_torch/", "pint_tpu/")
            .replace("regression gate", "bench regression gate")
            for f in got] == [f.message for f in want]
    (rule,) = [r for r in ta.all_rules() if r.id == "meta-key-unbudgeted"]
    (jrule,) = [r for r in ja.all_rules() if r.id == "meta-key-unbudgeted"]
    assert (rule.family, rule.whole_program) == (jrule.family,
                                                 jrule.whole_program)


def test_meta_key_rule_ignores_reads_and_other_modules(tmp_path):
    from pint_tpu_torch.analysis import LintConfig

    cfg = LintConfig(budget_meta_modules=("/chip_smoke.py",),
                     budgeted_meta_keys=frozenset())
    ok = 'x = report["serve_p99_latency_s"]\n'
    assert _lint(tmp_path, "chip_smoke.py", ok, cfg) == []
    bad = 'meta = {"measured_rogue": 1}\n'
    assert _lint(tmp_path, "other.py", bad, cfg) == []


def test_meta_key_rule_inert_without_budget_file(tmp_path, monkeypatch):
    from pint_tpu_torch.analysis import LintConfig

    cfg = LintConfig(budget_meta_modules=("/chip_smoke.py",),
                     budgeted_meta_keys=None)
    bad = 'meta = {"measured_rogue": 1}\n'
    assert _lint(tmp_path, "chip_smoke.py", bad, cfg) == []
    # the default config goes inert when the file cannot be read
    monkeypatch.setattr(baseline, "BUDGETS_PATH", str(tmp_path / "none"))
    assert LintConfig.default().budgeted_meta_keys is None


def test_default_config_binds_the_ports_budget_registry():
    from pint_tpu_torch.analysis import LintConfig

    cfg = LintConfig.default()
    assert cfg.budget_meta_modules == ("/chip_smoke.py",)
    assert cfg.budgeted_meta_keys == frozenset(baseline.registered_keys())
    assert "measured_670k_mfu_pct" in cfg.budgeted_meta_keys


def test_real_chip_smoke_meta_keys_all_registered():
    """chip_smoke.py, the port's round writer, lints clean under the
    rule: every measured_*/chaos_*/... key it defines is in the port's
    budgets.json."""
    from pint_tpu_torch.analysis import LintConfig, run, unsuppressed

    findings = run([os.path.join(REPO, "chip_smoke.py")],
                   config=LintConfig.default(), whole_program=False)
    bad = [f for f in unsuppressed(findings)
           if f.rule == "meta-key-unbudgeted"]
    assert bad == [], [f.message for f in bad]


# -- chip_smoke.py's [regress] phase, rehearsed on the host ---------------


def _phase_inputs(ratio):
    main = {"f64_s": 0.485, "mixed_s": 0.526, "n_toa": 669488,
            "refit": False, "buckets": 4, "padding": 1.0352}
    lint = {"unsuppressed": 0, "suppressed": 3, "classes": {}}
    chaos = {"ok": True, "injected": 11, "healthy_failures": 0,
             "unexpected_recompiles": 0}
    kill = {"n_sites": 4, "lost": 0, "duplicated": 0,
            "digest_mismatches": 0, "cold_vs_warm_ratio": ratio}
    return main, lint, chaos, kill


@pytest.mark.parametrize("ratio,violations", [
    (121.7, ["chaos_kill_cold_vs_warm_ratio"]),
    (1.4, []),
])
def test_chip_smoke_regress_phase(capsys, ratio, violations):
    """The phase on a round like the card's: the gate's violations are
    the recomputed ones, each on its own BUDGET line, and do not fail
    the phase; the planted rounds, the tpu round, the CLI codes and the
    rule all check out."""
    import chip_smoke

    doc = chip_smoke.card_round("NVIDIA H100 80GB HBM3, 700.00 W",
                                *_phase_inputs(ratio))
    detail = doc["parsed"]["detail"]
    assert (detail["platform"], detail["device_kind"],
            detail["power_limit_w"]) == ("gpu", "NVIDIA H100 80GB HBM3",
                                         "700.00 W")
    assert set(detail["null_reasons"]) < baseline.registered_keys()
    assert set(k for k in detail if k not in (
        "platform", "device_kind", "power_limit_w", "null_reasons")) \
        <= baseline.registered_keys()
    before = copy.deepcopy(doc)
    report = chip_smoke.regress_phase(doc)
    assert doc == before
    assert [v["key"] for v in report["budget_violations"]] == violations
    assert report["ok"] == (not violations)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[regress] BUDGET ")]
    assert len(lines) == len(violations)


def test_chip_smoke_budget_recomputation_is_independent():
    """budget_breaches holds each present number to its max and min,
    and skips bools, strings and absent keys."""
    import chip_smoke

    budgets = {"a": {"max": 1.0}, "b": {"min": 10.0}, "c": {"max": 0},
               "d": {"max": 0}, "e": {"max": 1.0}}
    detail = {"a": 1.5, "b": 9.0, "c": True, "d": "0", "f": 99.0}
    assert chip_smoke.budget_breaches(detail, budgets) == {"a", "b"}
    spec = {"budgets": budgets}
    got = {v["key"] for v in baseline.check_budgets(
        baseline._flatten(detail), spec)}
    assert got == {"a", "b"}
