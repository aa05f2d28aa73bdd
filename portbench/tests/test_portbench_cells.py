"""The harness end to end on the CPU at a tiny size: new files found by
name, the result line's keys and units, the reference against the port
for each configuration, the control and the faults judged not correct,
and the exits without a card or with JAX loaded."""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from portbench import check, run
from portbench.spec import Spec

from .conftest import ROOT, make_copy

CELL = "tiny_ng15_binary_dmx.refit_f64"


def run_tiny(root, cell=CELL, seed=20231, seconds=1.0, trace=False):
    return run.run_cell(Spec(root), cell, seed, seconds, trace,
                        device="cpu")


def digests(root):
    out = {}
    for dirpath, _, files in os.walk(os.path.join(root, "portbench")):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    f.read()).hexdigest()
    return out


def test_new_config_cell_and_metric_are_new_files(tmp_path):
    root = make_copy(str(tmp_path))
    before = digests(root)
    pb = os.path.join(root, "portbench")
    with open(os.path.join(ROOT, "portbench", "configs",
                           "ng15_binary_dmx.json")) as f:
        cfg = json.load(f)
    cfg.update(n_pulsars=3, total_toas=900, min_toas=160, max_toas=500,
               cadence_days=90.0, schedule_seed=5)
    with open(os.path.join(pb, "configs", "tiny_other.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(pb, "traffic", "refit_f64.json")) as f:
        traffic = json.load(f)
    traffic["maxiter"] = 1
    with open(os.path.join(pb, "traffic", "refit_once.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(pb, "limits",
                           "tiny_ng15_binary_dmx.refit_f64.json")) as f:
        limits = f.read()
    with open(os.path.join(pb, "limits", "tiny_other.refit_once.json"),
              "w") as f:
        f.write(limits)
    with open(os.path.join(pb, "metrics", "refits_named.py"), "w") as f:
        f.write('"""Refits completed, times the names in its folder."""\n\n\n'
                "def read(ctx):\n"
                "    return ctx.completed * len(ctx.names('refits_named'))\n")
    os.makedirs(os.path.join(pb, "names", "refits_named"))
    for k in ("a", "b"):
        with open(os.path.join(pb, "names", "refits_named", f"{k}.txt"),
                  "w") as f:
            f.write(f"name_{k}\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny_other", "source": "tiny",
                             "file": "portbench/configs/tiny_other.json",
                             "reduced": [], "why": "tiny"})
    bench["workloads"].append({"name": "tiny_other.refit_once",
                               "config": "tiny_other",
                               "traffic": "refit_once", "chips": 1,
                               "why": "tiny"})
    bench["per_layer"].append({
        "name": "refits_named", "unit": "refits", "better": "higher",
        "source": "program_counter", "layer": "whole refit",
        "moves": "refit_toas_per_s", "workloads": ["tiny_other.refit_once"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    result, _, _, _ = run_tiny(root, "tiny_other.refit_once", trace=True)
    assert result["correct"]
    got = result["metrics"]["refits_named"]
    assert got["unit"] == "refits" and got["value"] == 2 * result["attempted"]
    after = digests(root)
    assert {k: v for k, v in after.items() if k in before} == before


def test_result_line(tiny_checkout):
    result, rows, bad, _ = run_tiny(tiny_checkout)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "compared"
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 1 and not bad
    bench = Spec(tiny_checkout).bench
    units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
    assert set(result["metrics"]) == set(units)
    for name, m in result["metrics"].items():
        assert m["unit"] == units[name] and m["value"] > 0
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert [r[0] for r in rows] == sorted(result["compared"])
    json.dumps(result)


@pytest.mark.parametrize("cell", [w["name"] for w in Spec(ROOT).bench[
    "workloads"]])
def test_reference_agrees_with_the_port(tiny_checkout, cell):
    """The reference's fits of the port's refits, at every tiny pulsar,
    within the real cell's limits of the fit numbers."""
    cell = f"tiny_{cell}"
    result, _, _, st = run_tiny(tiny_checkout, cell)
    limits = Spec(tiny_checkout).limits(cell)
    sample = [(j, i) for j in range(len(st.records))
              for i in range(len(st.refs))]
    numbers = check.compare(st.records, st.refs, st.names, sample,
                            st.maxiter)
    for k in check.FIT_NUMBERS:
        if "limit" in limits[k]:
            assert numbers[k] <= limits[k]["limit"], (k, numbers[k])


def test_control_is_not_correct(tiny_checkout):
    """The reference in float32 put in the port's place fails the f64
    cell's limits."""
    spec = Spec(tiny_checkout)
    for cell in (CELL,):
        _, _, _, st = run_tiny(tiny_checkout, cell)
        precision = spec.traffic(spec.cell(cell)["traffic"])["control"]
        ctrl = check.control(st.records, st.refs, st.names, st.sample,
                             st.maxiter, precision)
        limits = {k: v for k, v in spec.limits(cell).items()
                  if k in check.FIT_NUMBERS}
        ok, _ = check.judge(ctrl, limits)
        assert not ok, ctrl


def _patched_fit(monkeypatch, change):
    from pint_tpu_torch.parallel.pta import PTAFleet

    orig = PTAFleet.fit

    def fit(self, *a, **kw):
        return change(self, *orig(self, *a, **kw))

    monkeypatch.setattr(PTAFleet, "fit", fit)


def test_fault_state_unchanged(tiny_checkout, monkeypatch):
    """A refit that returns its start: not correct."""
    starts = {}
    orig = run.set_start

    def set_start(fleet, x):
        starts["x"] = x
        return orig(fleet, x)

    monkeypatch.setattr(run, "set_start", set_start)
    _patched_fit(monkeypatch, lambda fleet, xs, chi2, covs: (
        [np.array(v) for v in starts["x"]], chi2, covs))
    result, _, _, _ = run_tiny(tiny_checkout)
    assert result["correct"] is False


def test_fault_half_the_toas(tiny_checkout, monkeypatch):
    """Every pulsar fitted on half of its TOAs: not correct."""
    from pint_tpu_torch.parallel import pta

    orig = pta.PTAFleet.__init__

    def init(self, models, toas, *a, **kw):
        half = [t.mask(np.arange(len(t)) % 2 == 0) for t in toas]
        orig(self, models, half, *a, **kw)

    monkeypatch.setattr(pta.PTAFleet, "__init__", init)
    result, _, _, _ = run_tiny(tiny_checkout)
    assert result["correct"] is False


def test_fault_answer_altered(tiny_checkout, monkeypatch):
    """One parameter of every pulsar (its last) moved by a tenth of its
    sigma where the fit returns it: not correct."""
    def alter(fleet, xs, chi2, covs):
        out = [np.array(v, np.float64) for v in xs]
        for v, c in zip(out, covs):
            v[-1] += 0.1 * np.sqrt(c[-1][-1])
        return out, chi2, covs

    _patched_fit(monkeypatch, alter)
    result, _, _, _ = run_tiny(tiny_checkout)
    assert result["correct"] is False


def test_no_card_no_result():
    """Without a CUDA card the command exits non-zero and prints
    nothing on standard output."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "ng15_binary_dmx.refit_f64", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_forbidden_modules_are_found(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlib.xla", object())
    monkeypatch.setitem(sys.modules, "pint_tpu_torch_like", object())
    assert "jaxlib" in run.forbidden_modules()
    assert "pint_tpu_torch_like" not in run.forbidden_modules()
