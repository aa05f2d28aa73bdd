"""The port's exporters (obs/export.py), its observability CLI
(``python -m pint_tpu_torch.obs``, run in process through ``main``) and
pint_serve_bench's ``--trace-out`` / ``--arrival-sweep``, against the
JAX package's.

- ``chrome_trace`` of one span list is the JAX package's JSON, byte for
  byte; ``reqlife_spans`` and ``flight_spans`` give its span dicts; the
  default process name is the port's.
- ``arrival_schedule`` is bitwise the JAX package's.
- Each CLI subcommand that reads files (``convert``, ``prom``, ``slo``,
  ``fitq``, ``tail``) gives the JAX package's exit code and output on
  the same files; ``fleet`` writes a trace that loads (``regress`` and
  ``doctor``: tests/test_torch_baseline.py).
"""

import json

import numpy as np
import pytest


def _spans():
    return [
        {"name": "fleet.fit", "trace": "t000001", "span": 1, "parent": None,
         "t0": 10.0, "t1": 10.5, "thread": "MainThread", "status": "ok",
         "attrs": {"n_psr": 4, "method": "auto"}},
        {"name": "fleet.execute", "trace": "t000001", "span": 2,
         "parent": 1, "t0": 10.1, "t1": 10.3, "thread": "MainThread",
         "status": "ok", "attrs": {"bucket": ("k", ("plan", 64)),
                                   "mfu_pct": 1.5}},
        {"name": "fleet.host_prep", "trace": "t000001", "span": 3,
         "parent": None, "t0": 9.0, "t1": 9.75, "thread": "pool_0",
         "status": "error", "attrs": {"error": "ValueError"}},
        {"name": "open", "trace": "t000002", "span": 4, "parent": None,
         "t0": 11.0, "t1": None, "thread": "x", "status": "ok",
         "attrs": {}},
    ]


def test_chrome_trace_is_the_jax_json(tmp_path):
    from pint_tpu.obs import export as jexport
    from pint_tpu_torch.obs import export

    doc = export.chrome_trace(_spans(), process_name="pint")
    jdoc = jexport.chrome_trace(_spans(), process_name="pint")
    assert json.dumps(doc, default=str) == json.dumps(jdoc, default=str)
    assert len([e for e in doc["traceEvents"] if e["ph"] == "X"]) == 3
    assert export.chrome_trace([])["traceEvents"][0]["args"]["name"] == \
        "pint_tpu_torch"
    path = export.write_chrome_trace(str(tmp_path / "t.json"), _spans())
    assert json.loads(open(path).read()) == json.loads(json.dumps(
        export.chrome_trace(_spans()), default=str))


def test_reqlife_and_flight_spans_match_jax():
    from pint_tpu.obs import export as jexport
    from pint_tpu.obs.reqlife import LifecycleLedger as JLedger
    from pint_tpu_torch.obs import export
    from pint_tpu_torch.obs.reqlife import LifecycleLedger

    recs = []
    for cls in (LifecycleLedger, JLedger):
        t = [0.0]
        led = cls(clock=lambda: t[0])
        for i in range(3):
            led.submitted(f"r{i}", tenant="ten" if i else None)
            for st in ("queued", "packed", "executing", "delivered"):
                t[0] += 0.01 * (i + 1)
                led.transition(f"r{i}", st, flush_trace=f"f{i}")
        # trace ids come from each package's own tracer counter
        recs.append([dict(r, trace=f"t{i}")
                     for i, r in enumerate(led.export())])
    assert recs[0] == recs[1]
    assert export.reqlife_spans(recs[0]) == jexport.reqlife_spans(recs[1])
    doc = {"events": [dict(s, kind="span") for s in _spans()]
           + [{"kind": "event", "what": "x"}]}
    assert export.flight_spans(doc) == jexport.flight_spans(doc) == _spans()


def test_arrival_schedule_is_bitwise_jax():
    from pint_tpu.scripts import pint_serve_bench as jbench
    from pint_tpu_torch.scripts import pint_serve_bench as bench

    for rate, n, seed, idx in ((3.7, 50, 2, 3), (120.0, 96, 0, 0),
                               (0.5, 7, 11, 7)):
        assert np.array_equal(
            bench.arrival_schedule(rate, n, seed=seed, rate_index=idx),
            jbench.arrival_schedule(rate, n, seed=seed, rate_index=idx))


def _tail_artifact():
    from pint_tpu_torch.obs.reqlife import LifecycleLedger, tail_artifact

    t = [0.0]
    led = LifecycleLedger(clock=lambda: t[0])
    ex = []
    for i in range(4):
        t[0] = float(i)
        tr = led.submitted(f"r{i}", tenant="alice")
        for st, dt in (("queued", 0.01), ("packed", 0.02 * (i + 1)),
                       ("executing", 0.03), ("delivered", 0.01)):
            t[0] += dt
            led.transition(f"r{i}", st, flush_trace=f"f{i}")
        ex.append({"value": t[0] - i, "request_id": f"r{i}", "trace": tr})
    return tail_artifact({"total_s": {"p99": 0.1}, "exemplars": ex}, led)


def _files(tmp_path):
    from pint_tpu_torch.obs import FitQualityLedger, Registry

    p = {}
    spans = _spans()[:3]
    p["span_list"] = tmp_path / "spans.json"
    p["span_list"].write_text(json.dumps(spans, default=str))
    p["dump"] = tmp_path / "flight.json"
    reg = Registry()
    reg.counter("serve.requests").inc(7)
    reg.gauge("slo.availability.burn_fast").set(0.5)
    p["dump"].write_text(json.dumps(
        {"reason": "x", "events": [dict(s, kind="span") for s in spans],
         "metrics": reg.snapshot()}, default=str))
    p["chrome"] = tmp_path / "chrome.json"
    p["chrome"].write_text(json.dumps({"traceEvents": []}))
    p["metrics"] = tmp_path / "metrics.json"
    p["metrics"].write_text(json.dumps(reg.snapshot()))
    healthy, bad = [], []
    for k in range(6):
        snap = {"requests": 10 * (k + 1), "requests_ok": 10 * (k + 1),
                "total_s": {"p99": 0.05}, "walltime": 60.0 * k}
        healthy.append(tmp_path / f"ok{k}.json")
        healthy[-1].write_text(json.dumps({"snapshot": snap}))
        worse = dict(snap, requests_ok=5 * (k + 1), total_s={"p99": 0.9})
        bad.append(tmp_path / f"bad{k}.json")
        bad[-1].write_text(json.dumps(worse))
    p["healthy"], p["bad"] = healthy, bad
    led = FitQualityLedger()
    p["fitq_ok"] = tmp_path / "fitq_ok.json"
    p["fitq_ok"].write_text(json.dumps(led.snapshot()))
    snap = led.snapshot()
    snap["counters"]["fits"] = 3
    snap["max_abs_chi2_z"] = 40.0
    p["fitq_bad"] = tmp_path / "fitq_bad.json"
    p["fitq_bad"].write_text(json.dumps(snap))
    p["tail"] = tmp_path / "tail.json"
    art = _tail_artifact()
    p["tail"].write_text(json.dumps(art))
    p["tail_trace"] = art["lifecycle"][2]["trace"]
    return p


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr().out
    return rc, out


@pytest.mark.parametrize("case", [
    "convert_dump", "convert_list", "convert_chrome", "prom", "slo_ok",
    "slo_alerting", "fitq_ok", "fitq_bad", "tail", "tail_trace",
    "tail_unknown"])
def test_cli_subcommands_match_jax(tmp_path, capsys, case):
    from pint_tpu.obs.__main__ import main as jmain
    from pint_tpu_torch.obs.__main__ import main

    p = _files(tmp_path)
    argv = {
        "convert_dump": ["convert", str(p["dump"]), "--out",
                         str(tmp_path / "{pkg}.json")],
        "convert_list": ["convert", str(p["span_list"]), "--out",
                         str(tmp_path / "{pkg}.json")],
        "convert_chrome": ["convert", str(p["chrome"])],
        "prom": ["prom", str(p["metrics"])],
        "slo_ok": ["slo", *map(str, p["healthy"])],
        "slo_alerting": ["slo", *map(str, p["bad"]), "--step", "60"],
        "fitq_ok": ["fitq", str(p["fitq_ok"])],
        "fitq_bad": ["fitq", str(p["fitq_bad"])],
        "tail": ["tail", str(p["tail"])],
        "tail_trace": ["tail", str(p["tail"]), "--trace", p["tail_trace"]],
        "tail_unknown": ["tail", str(p["tail"]), "--trace", "nope"],
    }[case]
    got = _run(main, [a.format(pkg="torch") for a in argv], capsys)
    want = _run(jmain, [a.format(pkg="jax") for a in argv], capsys)
    assert got[0] == want[0]
    if case.startswith("convert") and got[0] == 0:
        a = json.loads((tmp_path / "torch.json").read_text())
        b = json.loads((tmp_path / "jax.json").read_text())
        assert a["traceEvents"][1:] == b["traceEvents"][1:]
        assert json.loads(got[1])["spans"] == json.loads(want[1])["spans"]
    else:
        assert got[1] == want[1]
    assert {"slo_ok": 0, "slo_alerting": 1, "fitq_bad": 1,
            "tail_unknown": 1, "convert_chrome": 1}.get(case, 0) == got[0]


def test_cli_fleet_writes_a_trace(tmp_path, capsys):
    from pint_tpu_torch.obs.__main__ import main

    out = tmp_path / "fleet.json"
    rc = main(["fleet", "--n-psr", "3", "--sizes", "16", "--maxiter", "1",
               "--method", "wls", "--bucket-floor", "16", "--device", "cpu",
               "--out", str(out)])
    rep = json.loads(capsys.readouterr().out)
    assert rc == 0 and rep["pulsars"] == 3
    assert {"fleet.fit", "fleet.execute", "fleet.host_prep"} <= \
        set(rep["phases"])
    events = json.loads(out.read_text())["traceEvents"]
    assert len([e for e in events if e["ph"] == "X"]) == rep["spans"]
    from pint_tpu_torch.obs import trace

    trace.reset()


def test_serve_bench_trace_out_and_arrival_sweep_wiring(tmp_path, capsys,
                                                        monkeypatch):
    """--trace-out traces the run and writes a trace that loads;
    --arrival-sweep passes its options through and gates on the knee
    (the sweep itself: test_arrival_sweep_report_keys_match_jax)."""
    from pint_tpu_torch.scripts import pint_serve_bench as bench

    seen = {}

    def fake_sweep(**kw):
        from pint_tpu_torch.obs import trace

        seen.update(kw)
        with trace.span("serve.flush"):
            pass
        return {"monotone_offered": True, "knee_rps": 3.0,
                "p99_at_knee_s": 0.1, "shed_onset_rps": 6.0,
                "null_reasons": {}}

    monkeypatch.setattr(bench, "run_arrival_sweep", fake_sweep)
    from pint_tpu_torch.obs import trace

    trace.reset()
    out = tmp_path / "t.json"
    rc = bench.main(["--arrival-sweep", "--n-per-rate", "8", "--producers",
                     "2", "--device", "cpu", "--trace-out", str(out)])
    assert rc == 0 and seen["n_per_rate"] == 8 and seen["producers"] == 2
    assert seen["device"] == "cpu"
    events = json.loads(out.read_text())["traceEvents"]
    assert [e["name"] for e in events if e["ph"] == "X"] == ["serve.flush"]
    assert not trace.enabled()
    trace.reset()
    capsys.readouterr()


def test_arrival_sweep_report_keys_match_jax():
    """The sweep on the CPU (two rungs, 12 requests each): the JAX
    package's report keys and row keys, a monotone offered ladder and
    every request terminal."""
    import inspect

    from pint_tpu.scripts import pint_serve_bench as jbench
    from pint_tpu_torch.scripts import pint_serve_bench as bench

    rep = bench.run_arrival_sweep(n_per_rate=12, fracs=(0.5, 2.0),
                                  sizes=(12,), bucket_floor=16, maxiter=1,
                                  producers=2, device="cpu")
    assert set(rep) == {
        "n_per_rate", "fracs", "producers", "engine", "base_rps",
        "base_p99_s", "ref_p99_s", "knee_factor", "max_queue",
        "offered_rps", "monotone_offered", "rows", "saturated",
        "knee_rps", "p99_at_knee_s", "shed_onset_rps", "null_reasons",
        "schedule_sha256", "reqlife_nonterminal", "wall_s"}
    assert set(rep["rows"][0]) == {"offered_rps", "achieved_rps",
                                   "delivered", "shed", "errors", "p50_s",
                                   "p99_s", "max_s"}
    assert rep["monotone_offered"] and rep["reqlife_nonterminal"] == 0
    assert all(r["delivered"] + r["shed"] + r["errors"] == 12
               for r in rep["rows"])
    params = list(inspect.signature(bench.run_arrival_sweep).parameters)
    assert params[:-1] == list(inspect.signature(
        jbench.run_arrival_sweep).parameters)
    assert params[-1] == "device"
