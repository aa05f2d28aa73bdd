"""pint_trace: the observability CLI (``python -m pint_tpu_torch.obs``;
the JAX package's ``python -m pint_tpu.obs``).

Subcommands (each with the JAX package's arguments and exit codes; the
ones that run a fleet or a serve stream take ``--device``, the card by
default):

- ``fleet``   — run a traced N-pulsar fleet refit and export the span
  timeline as Chrome trace-event JSON (open in ui.perfetto.dev): a
  68-pulsar traced refit whose span tree covers host prep, pack,
  compile, and execute per bucket.
- ``convert`` — turn a flight-recorder dump (or a raw span-list JSON)
  into a Chrome trace-event file.
- ``prom``    — render a metrics snapshot JSON (or the dump's embedded
  metrics block) as Prometheus text exposition format.
- ``regress`` — the perf-observatory gate. It waits for the port's own
  benchmark: the JAX package's gate reads that package's TPU rounds
  (BENCH_r*.json), and a gate of the port held to them would judge the
  card by the TPU's numbers. Exits 2 saying so.
- ``slo``     — replay serve snapshot JSON files through the
  dual-window burn-rate monitor and report per-SLO burn / alert state
  (exit 1 when any SLO is alerting at the end of the replay).
- ``fitq``    — the numerics observatory: check a fit-quality ledger /
  engine snapshot JSON against the probe limits, or (with no file)
  run a probed fleet refit and report the live ledger (exit 1 on any
  probe violation).
- ``doctor``  — regress + slo replay + fitq check in one gate; it runs
  ``regress`` first, so it waits with it (exit 2).
- ``tail``    — "why was this request slow" in one command: resolve a
  p99 tail-latency exemplar from a serve run (a ``--tail-out``
  artifact of pint_serve_bench, or a live mini serve stream when no
  file is given) to its request-lifecycle record — tenant, state
  timeline, queue-wait vs execute split, and the flush trace id.
"""

from __future__ import annotations

import argparse
import json
import sys

BENCHMARK_WAITS = ("waits for the port's own benchmark: the JAX "
                   "package's gate reads its TPU rounds "
                   "(BENCH_r*.json, budgets.json), and a gate of the "
                   "port held to them would judge the card by the "
                   "TPU's numbers")


def _cmd_fleet(args):
    import numpy as np

    from .. import obs
    from ..parallel import PTAFleet
    from ..scripts.pint_serve_bench import build_serve_fleet

    # 9 structure x size combos -> per_combo ~ n_psr / 9
    per_combo = max(1, -(-args.n_psr // 9))
    models, toas_list = build_serve_fleet(
        sizes=tuple(args.sizes), per_combo=per_combo, seed=args.seed,
        device=args.device)
    models, toas_list = models[:args.n_psr], toas_list[:args.n_psr]
    # trace from construction on so the timeline covers the whole
    # cold path — host prep, pack, compile — not just the refit
    obs.enable(capacity=args.capacity,
               jax_annotations=args.jax_annotations)
    obs.reset()
    print(f"[pint_trace] fleet of {len(models)} pulsars; traced cold "
          "fit (host prep + pack + compile + execute) ...",
          file=sys.stderr)
    fleet = PTAFleet(models, toas_list, bucket_floor=args.bucket_floor,
                     pipeline=not args.no_pipeline, device=args.device)
    fleet.fit(method=args.method, maxiter=args.maxiter)
    print("[pint_trace] traced warm refit ...", file=sys.stderr)
    xs, chi2, meta = fleet.fit(method=args.method, maxiter=args.maxiter)
    obs.disable()

    spans = obs.spans()
    out = obs.write_chrome_trace(args.out, spans)
    phases = sorted({s["name"] for s in spans})
    print(json.dumps({
        "pulsars": len(models),
        "buckets": len(fleet.batches),
        "chi2_total": float(np.sum([np.sum(c) for c in chi2])),
        "spans": len(spans),
        "phases": phases,
        "trace_out": out,
    }, indent=1))
    return 0


def _cmd_convert(args):
    from . import export

    with open(args.dump) as fh:
        doc = json.load(fh)
    if isinstance(doc, dict) and "events" in doc:      # flight dump
        spans = export.flight_spans(doc)
    elif isinstance(doc, dict) and "traceEvents" in doc:
        print("input is already a Chrome trace", file=sys.stderr)
        return 1
    else:                                              # raw span list
        spans = doc
    out = export.write_chrome_trace(args.out, spans)
    print(json.dumps({"spans": len(spans), "trace_out": out}))
    return 0


def _cmd_prom(args):
    from . import metricsreg

    with open(args.snapshot) as fh:
        doc = json.load(fh)
    if isinstance(doc, dict) and "metrics" in doc:     # flight dump
        doc = doc["metrics"]
    sys.stdout.write(metricsreg.prometheus_text(doc))
    return 0


def _cmd_waits(args):
    print(f"{args.cmd} {BENCHMARK_WAITS}", file=sys.stderr)
    return 2


def _cmd_slo(args):
    from . import slo

    mon = slo.BurnRateMonitor(
        specs=slo.serve_slos(latency_limit_s=args.latency_limit))
    for i, path in enumerate(args.snapshots):
        with open(path) as fh:
            doc = json.load(fh)
        if isinstance(doc, dict) and "snapshot" in doc:
            doc = doc["snapshot"]
        t = doc.get("walltime") if isinstance(doc, dict) else None
        mon.ingest(doc, t=t if t is not None else float(i * args.step))
    out = {"slos": mon.snapshot(), "alerting": mon.alerting()}
    print(json.dumps(out, indent=1))
    return 1 if out["alerting"] else 0


def _cmd_fitq(args):
    from . import fitquality

    if args.snapshot:
        with open(args.snapshot) as fh:
            snap = json.load(fh)
    else:
        # no snapshot: run a probed fleet refit and report the live
        # ledger (the fitq twin of the `fleet` demo)
        from ..parallel import PTAFleet
        from ..scripts.pint_serve_bench import build_serve_fleet

        per_combo = max(1, -(-args.n_psr // 9))
        models, toas_list = build_serve_fleet(
            sizes=tuple(args.sizes), per_combo=per_combo,
            seed=args.seed, device=args.device)
        models, toas_list = models[:args.n_psr], toas_list[:args.n_psr]
        print(f"[pint_trace] probed fleet refit of {len(models)} "
              "pulsars ...", file=sys.stderr)
        fitquality.reset()
        fitquality.enable()
        try:
            fleet = PTAFleet(models, toas_list,
                             bucket_floor=args.bucket_floor,
                             device=args.device)
            fleet.fit(method=args.method, maxiter=args.maxiter)
        finally:
            fitquality.disable()
        snap = fitquality.FITQ.snapshot()
    report = fitquality.check_report(
        snap, chi2_z_limit=args.chi2_z_limit,
        condition_limit=args.condition_limit)
    ledger = {k: v for k, v in fitquality._fq(snap).items()
              if k != "pulsars"}
    print(json.dumps({"report": report, "ledger": ledger}, indent=1,
                     default=float))
    return 0 if report["ok"] else 1


def _cmd_tail(args):
    from . import reqlife

    if args.artifact:
        with open(args.artifact) as fh:
            artifact = json.load(fh)
    else:
        # no artifact: run a small live serve stream and resolve its
        # own tail (the reqlife twin of the `fitq` live mode)
        from ..scripts.pint_serve_bench import run_serve_stream

        print("[pint_trace] live serve stream of %d requests ..."
              % args.n_requests, file=sys.stderr)
        rep = run_serve_stream(n_requests=args.n_requests,
                               sizes=tuple(args.sizes),
                               bucket_floor=args.bucket_floor,
                               seed=args.seed, compare_offline=False,
                               measure_overhead=False,
                               device=args.device)
        artifact = rep["tail_artifact"]
    if args.trace:
        # resolve a specific trace id instead of the p99 exemplar
        recs = [r for r in artifact.get("lifecycle", [])
                if r.get("trace") == args.trace]
        if not recs:
            print(json.dumps({"resolved": False,
                              "reason": "trace_not_in_ledger",
                              "trace": args.trace}, indent=1))
            return 1
        split = reqlife.phase_split(recs[0])
        out = {"resolved": True, "trace": args.trace,
               "request_id": recs[0].get("request_id"),
               "tenant": recs[0].get("tenant"),
               "states": [s["state"] for s in recs[0]["states"]],
               "queue_wait_s": split["queue_wait_s"],
               "execute_s": split["execute_s"],
               "per_state_s": split["per_state_s"],
               "flush_trace": (recs[0].get("attrs") or {})
               .get("flush_trace"),
               "record": recs[0]}
    else:
        out = reqlife.resolve_tail(artifact)
    print(json.dumps(out, indent=1, default=float))
    return 0 if out.get("resolved") else 1


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m pint_tpu_torch.obs",
        description="pint_trace: traced fleet timelines, flight-dump "
                    "conversion, Prometheus rendering")
    sub = p.add_subparsers(dest="cmd", required=True)

    f = sub.add_parser("fleet", help="traced fleet refit -> Chrome "
                                     "trace JSON")
    f.add_argument("--n-psr", type=int, default=68)
    f.add_argument("--sizes", type=int, nargs="+",
                   default=[48, 96, 180])
    f.add_argument("--seed", type=int, default=0)
    f.add_argument("--method", default="gls",
                   choices=("wls", "gls"))
    f.add_argument("--maxiter", type=int, default=2)
    f.add_argument("--bucket-floor", type=int, default=64)
    f.add_argument("--no-pipeline", action="store_true",
                   help="sequential fit (fewer phases in the trace)")
    f.add_argument("--capacity", type=int, default=65536)
    f.add_argument("--jax-annotations", action="store_true",
                   help="also open a torch.profiler range per span")
    f.add_argument("--out", default="pint_fleet_trace.json")
    f.add_argument("--device", default="cuda",
                   help="where the fleet runs (default: the card)")
    f.set_defaults(fn=_cmd_fleet)

    c = sub.add_parser("convert", help="flight dump / span list -> "
                                       "Chrome trace JSON")
    c.add_argument("dump")
    c.add_argument("--out", default="pint_trace.json")
    c.set_defaults(fn=_cmd_convert)

    m = sub.add_parser("prom", help="metrics snapshot -> Prometheus "
                                    "text format")
    m.add_argument("snapshot")
    m.set_defaults(fn=_cmd_prom)

    r = sub.add_parser("regress", help="bench-trajectory gate: waits "
                                       "for the port's own benchmark "
                                       "(exit 2)")
    r.add_argument("--root", default=None)
    r.add_argument("--budgets", default=None)
    r.add_argument("--json", action="store_true")
    r.set_defaults(fn=_cmd_waits)

    s = sub.add_parser("slo", help="replay serve snapshots through "
                                   "the burn-rate monitor")
    s.add_argument("snapshots", nargs="+",
                   help="serve snapshot JSON files, in time order")
    s.add_argument("--latency-limit", type=float, default=0.25,
                   help="p99 latency SLO limit in seconds")
    s.add_argument("--step", type=float, default=60.0,
                   help="assumed seconds between snapshots lacking a "
                        "walltime field")
    s.set_defaults(fn=_cmd_slo)

    q = sub.add_parser("fitq", help="fit-quality probe report / gate "
                                    "(numerics observatory)")
    q.add_argument("snapshot", nargs="?", default=None,
                   help="ledger or engine snapshot JSON; omitted -> "
                        "run a probed fleet refit")
    q.add_argument("--n-psr", type=int, default=27)
    q.add_argument("--sizes", type=int, nargs="+", default=[48])
    q.add_argument("--seed", type=int, default=0)
    q.add_argument("--method", default="gls", choices=("wls", "gls"))
    q.add_argument("--maxiter", type=int, default=2)
    q.add_argument("--bucket-floor", type=int, default=64)
    q.add_argument("--chi2-z-limit", type=float, default=6.0)
    q.add_argument("--condition-limit", type=float, default=1e12)
    q.add_argument("--device", default="cuda",
                   help="where the live refit runs (default: the card)")
    q.set_defaults(fn=_cmd_fitq)

    d = sub.add_parser("doctor", help="regress + slo + fitq gate: "
                                      "waits with regress (exit 2)")
    d.add_argument("--root", default=None)
    d.add_argument("--budgets", default=None)
    d.add_argument("--slo-snapshots", nargs="*", default=None)
    d.add_argument("--fitq-snapshot", default=None)
    d.add_argument("--json", action="store_true")
    d.set_defaults(fn=_cmd_waits)

    t = sub.add_parser("tail", help="resolve a p99 tail exemplar to "
                                    "its request-lifecycle record")
    t.add_argument("artifact", nargs="?", default=None,
                   help="tail artifact JSON (pint_serve_bench "
                        "--tail-out); omitted -> run a live mini "
                        "serve stream")
    t.add_argument("--trace", default=None,
                   help="resolve this trace id instead of the p99 "
                        "exemplar")
    t.add_argument("--n-requests", type=int, default=48)
    t.add_argument("--sizes", type=int, nargs="+", default=[48])
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--bucket-floor", type=int, default=64)
    t.add_argument("--device", default="cuda",
                   help="where the live stream runs (default: the card)")
    t.set_defaults(fn=_cmd_tail)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
