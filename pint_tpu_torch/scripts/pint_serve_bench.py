"""End-to-end driver for the online timing service (pint_tpu_torch.serve;
the JAX package's ``scripts/pint_serve_bench.py``, its default mode):
build a mixed fleet (several model structures x several TOA bucket
sizes), prewarm the executable cache, stream a few hundred requests
through ServeEngine, and report latency percentiles + cache counters,
optionally cross-checking every fit against the offline PTAFleet
path.

This is the serving acceptance harness: a mixed-shape stream must
complete with ZERO captures after warmup (cache hit rate ~100%) and
parameters matching the offline path to ~1e-12.

    python -m pint_tpu_torch.scripts.pint_serve_bench            # the card
    python -m pint_tpu_torch.scripts.pint_serve_bench --device cpu \\
        --requests 24 --bucket-floor 32

The JAX package's chaos, kill, device and arrival-sweep modes and its
``--trace-out`` export wait with ROADMAP §1 item 3 (the journal, the
trace exporter) and item 2 (device lanes).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from pint_tpu_torch.obs import clock as obs_clock

WAITING_MODES = {
    "chaos": "the chaos streams wait with the durability queue and "
             "multi-device (ROADMAP §1 items 3 and 2)",
    "arrival_sweep": "the open-loop arrival sweep waits with the "
                     "observability queue (ROADMAP §1 item 3)",
    "trace_out": "the Chrome trace exporter (obs/export.py) waits with "
                 "the observability queue (ROADMAP §1 item 3)",
}


def build_serve_fleet(sizes=(48, 96, 180), per_combo=3, seed=0,
                      device="cuda"):
    """(models, toas_list) spanning 3 model structures x len(sizes)
    TOA counts, per_combo pulsars each:

    - spin-only (F0/F1/DM free)            -> WLS route
    - + EFAC/EQUAD (ScaleToaError)         -> WLS route, new structure
    - + power-law red noise (TNREDC 10)    -> GLS route

    Red noise only (no ECORR) in the GLS structure: ECORR's epoch
    count varies with TOA clustering, which would key extra programs
    per dataset; the red-noise basis column count is fixed by TNREDC,
    so every request in a bucket shares one shape. The TOAs' phase
    runs on ``device``.
    """
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.simulation import make_fake_toas_fromMJDs

    rng = np.random.default_rng(seed)
    structures = (
        "",
        "EFAC -f L-wide 1.1\nEQUAD -f L-wide 0.4\n",
        "EFAC -f L-wide 1.1\nEQUAD -f L-wide 0.4\n"
        "RNAMP 1e-14\nRNIDX -3.1\nTNREDC 10\n",
    )
    models, toas_list = [], []
    i = 0
    for extra in structures:
        for n_toa in sizes:
            for _ in range(per_combo):
                par = (f"PSR SRV{i}\nRAJ {i % 24}:{(11 * i) % 60:02d}:00.0\n"
                       f"DECJ {(i * 5) % 60 - 30}:15:00.0\n"
                       f"F0 {200 + 3 * (i % 50)}.271 1\n"
                       f"F1 -{1 + i % 8}e-16 1\n"
                       f"PEPOCH 55500\nDM {6 + i}.37 1\n" + extra)
                m = get_model(par)
                mjds = np.sort(rng.uniform(54200, 56800, n_toa))
                t = make_fake_toas_fromMJDs(
                    mjds, m, error_us=1.0, freq_mhz=1400.0, obs="gbt",
                    add_noise=True, seed=100 + i, iterations=0,
                    device=device)
                if extra:
                    for f in t.flags:
                        f["f"] = "L-wide"
                models.append(m)
                toas_list.append(t)
                i += 1
    return models, toas_list


def run_serve_stream(n_requests=216, max_batch=8, max_latency_s=0.05,
                     bucket_floor=64, cache_capacity=32,
                     sizes=(48, 96, 180), per_combo=3, maxiter=3,
                     precision="f64", compare_offline=True, mesh=None,
                     seed=0, concurrent_prewarm=False,
                     measure_overhead=True, tenants=None, device="cuda"):
    """Prewarm + stream n_requests fit requests round-robin over the
    mixed fleet; returns a JSON-safe report with the engine snapshot,
    recompile count after warmup, and (optionally) the max relative
    parameter difference vs the offline PTAFleet fit of the same
    pulsars. concurrent_prewarm=True warms the cache through
    ServeEngine.prewarm_concurrent (the fleet executor's capture path)
    instead of serial flushes.

    The stream runs with a private request-lifecycle ledger attached
    (reqlife_* report keys: terminal-state census, lost records, the
    ``tail_artifact`` joining p99 exemplars to lifecycle records) and,
    when ``measure_overhead``, re-runs a short warm slice of the
    stream ledger-on vs ledger-detached to price the instrumentation
    (``reqlife_overhead_pct``) and digest-assert that it never touches
    results (``reqlife_bitwise_on_off``). tenants: optional tenant-id
    cycle assigned round-robin to requests (default: all ``anon``).

    Beyond the JAX package's keys the report carries ``stream_wall_s``
    and ``requests_per_s`` (the stream's host wall), ``execute_p99_s``,
    ``result_digests`` (``result_digest`` of every result, request
    order) and, with the offline check, ``max_param_sigma_diff_vs_offline``
    (|x - x_offline| over the offline fit's sigma)."""
    from pint_tpu_torch.obs.reqlife import LifecycleLedger, tail_artifact
    from pint_tpu_torch.serve import FitRequest, ServeEngine, result_digest

    models, toas_list = build_serve_fleet(sizes=sizes,
                                          per_combo=per_combo,
                                          seed=seed, device=device)
    n_pulsars = len(models)
    ledger = LifecycleLedger()
    eng = ServeEngine(max_batch=max_batch, max_latency_s=max_latency_s,
                      bucket_floor=bucket_floor,
                      cache_capacity=cache_capacity, mesh=mesh,
                      reqlife=ledger, device=device)

    def req(i):
        kw = {}
        if tenants:
            kw["tenant"] = tenants[i % len(tenants)]
        return FitRequest(models[i % n_pulsars],
                          toas_list[i % n_pulsars],
                          maxiter=maxiter, precision=precision, **kw)

    # one request per pulsar covers every (structure, bucket) slot
    t_warm = obs_clock.now()
    if concurrent_prewarm:
        warm_compiles = eng.prewarm_concurrent(
            [req(i) for i in range(n_pulsars)])
    else:
        warm_compiles = eng.prewarm([req(i) for i in range(n_pulsars)])
    prewarm_wall_s = obs_clock.now() - t_warm
    t_stream = obs_clock.now()
    results = eng.run_stream([req(i) for i in range(n_requests)])
    stream_wall_s = obs_clock.now() - t_stream
    snap = eng.snapshot()
    # lifecycle census for the steady-state stream (prewarm reset the
    # ledger): every request must sit in exactly one terminal state
    lsnap = ledger.snapshot()
    statuses = {}
    for r in results:
        statuses[r.status] = statuses.get(r.status, 0) + 1
    report = {
        "n_requests": n_requests,
        "n_pulsars": n_pulsars,
        "n_structures": 3,
        "toa_buckets": sorted({r.telemetry.get("bucket")
                               for r in results if r.telemetry}),
        "statuses": statuses,
        "warmup_executables": warm_compiles,
        "concurrent_prewarm": bool(concurrent_prewarm),
        "prewarm_wall_s": round(prewarm_wall_s, 3),
        "recompiles_after_warmup": (snap["executables_compiled"]
                                    - warm_compiles),
        "cache": snap["cache"],
        "serve_p50_latency_s": snap["total_s"]["p50"],
        "serve_p99_latency_s": snap["total_s"]["p99"],
        "queue_wait_p50_s": snap["queue_wait_s"]["p50"],
        "execute_p50_s": snap["execute_s"]["p50"],
        "execute_p99_s": snap["execute_s"]["p99"],
        "stream_wall_s": stream_wall_s,
        "requests_per_s": (n_requests / stream_wall_s
                           if stream_wall_s > 0 else None),
        "counters": snap["counters"],
        "reqlife_nonterminal": lsnap["non_terminal"],
        "reqlife_lost_records": lsnap["lost_records"],
        "reqlife_double_terminal": lsnap["double_terminal"],
        "reqlife_by_state": lsnap["by_state"],
        "reqlife_exactly_one_terminal": bool(
            lsnap["non_terminal"] == 0
            and lsnap["double_terminal"] == 0
            and lsnap["terminal"] == n_requests),
        "tenants": snap.get("tenants"),
        "tail_artifact": tail_artifact(snap, ledger),
        "result_digests": [result_digest(r.value) for r in results],
    }
    if measure_overhead:
        # price the ledger on an identical warm slice, alternating
        # ledger-on / ledger-detached so drift hits both sides alike;
        # min-of-3 walls, and digest-assert the results never differ
        n_over = min(n_requests, 72)
        walls_on, walls_off, dig_on, dig_off = [], [], None, None
        for _ in range(3):
            t0 = obs_clock.now()
            r_on = eng.run_stream([req(i) for i in range(n_over)])
            walls_on.append(obs_clock.now() - t0)
            eng.reqlife = None
            t0 = obs_clock.now()
            r_off = eng.run_stream([req(i) for i in range(n_over)])
            walls_off.append(obs_clock.now() - t0)
            eng.reqlife = ledger
            if dig_on is None:
                dig_on = [result_digest(r.value) for r in r_on
                          if r.status == "ok"]
                dig_off = [result_digest(r.value) for r in r_off
                           if r.status == "ok"]
        off = min(walls_off)
        report["reqlife_overhead_pct"] = (
            round(max(0.0, 100.0 * (min(walls_on) - off) / off), 3)
            if off > 0 else 0.0)
        report["reqlife_bitwise_on_off"] = bool(
            dig_on and dig_on == dig_off)
    if compare_offline:
        from pint_tpu_torch.parallel import PTAFleet

        fleet = PTAFleet(models, toas_list, device=device)
        xs, _, covs = fleet.fit(method="auto", maxiter=maxiter)
        # warm sequential-vs-pipelined executor comparison on the same
        # fleet: the programs are built now, so the delta is pure
        # scheduling (dispatch-all + overlapped host unpack)
        t0 = obs_clock.now()
        xs_s, chi_s, _ = fleet.fit(method="auto", maxiter=maxiter,
                                   pipeline=False)
        seq_s = obs_clock.now() - t0
        t0 = obs_clock.now()
        xs_p, chi_p, _ = fleet.fit(method="auto", maxiter=maxiter,
                                   pipeline=True)
        pipe_s = obs_clock.now() - t0
        report["fleet_fit_sequential_s"] = round(seq_s, 4)
        report["fleet_fit_pipelined_s"] = round(pipe_s, 4)
        report["fleet_pipeline_overlap_pct"] = round(
            100.0 * (1.0 - pipe_s / seq_s), 2) if seq_s > 0 else 0.0
        report["fleet_pipeline_bitwise"] = bool(
            np.array_equal(chi_s, chi_p)
            and all(np.array_equal(a, b) for a, b in zip(xs_s, xs_p)))
        worst = worst_sigma = 0.0
        for i, r in enumerate(results):
            if r.status != "ok":
                continue
            off = np.asarray(xs[i % n_pulsars])
            mine = np.asarray(r.value["x"])
            rel = np.max(np.abs(mine - off)
                         / np.maximum(np.abs(off), 1e-30))
            sig = np.sqrt(np.diag(np.asarray(covs[i % n_pulsars])))
            # np.maximum propagates NaN; builtin max() would silently
            # drop a NaN rel and report a clean worst-case
            worst = float(np.maximum(worst, rel))
            worst_sigma = float(np.maximum(
                worst_sigma, np.max(np.abs(mine - off) / sig)))
        report["max_param_rel_diff_vs_offline"] = worst
        report["max_param_sigma_diff_vs_offline"] = worst_sigma
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="pint_serve_bench",
        description="Stream fit requests through pint_tpu_torch.serve and "
                    "report latency/cache telemetry")
    p.add_argument("--requests", type=int, default=216)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-latency", type=float, default=0.05)
    p.add_argument("--bucket-floor", type=int, default=64)
    p.add_argument("--maxiter", type=int, default=3)
    p.add_argument("--precision", default="f64",
                   choices=("f64", "mixed"))
    p.add_argument("--no-offline-check", action="store_true",
                   help="skip the PTAFleet cross-check")
    p.add_argument("--concurrent-prewarm", action="store_true",
                   help="warm the executable cache via "
                        "prewarm_concurrent (program builds in a pool, "
                        "captures serial) instead of serial flushes")
    p.add_argument("--hit-threshold", type=float, default=0.9,
                   help="fail (rc 1) when the post-warmup cache hit "
                        "rate drops below this")
    p.add_argument("--tail-out", default=None, metavar="PATH",
                   help="write the run's tail artifact (p99 "
                        "exemplars + lifecycle records) as JSON")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="where the engine runs (default: the card)")
    for flag in ("--chaos", "--arrival-sweep"):
        p.add_argument(flag, action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--trace-out", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    for name, why in WAITING_MODES.items():
        if getattr(args, name):
            p.error(f"--{name.replace('_', '-')}: {why}")

    report = run_serve_stream(
        n_requests=args.requests, max_batch=args.max_batch,
        max_latency_s=args.max_latency, bucket_floor=args.bucket_floor,
        maxiter=args.maxiter, precision=args.precision,
        compare_offline=not args.no_offline_check,
        concurrent_prewarm=args.concurrent_prewarm, seed=args.seed,
        device=args.device)
    # the tail artifact and the digests are joinable sidecars, not
    # bench metrics — keep stdout lean
    artifact = report.pop("tail_artifact", None)
    report.pop("result_digests", None)
    if args.tail_out and artifact is not None:
        with open(args.tail_out, "w") as fh:
            json.dump(artifact, fh, default=float)
        print(f"tail artifact written to {args.tail_out}",
              file=sys.stderr)
    print(json.dumps(report, default=float))
    hit_rate = report["cache"]["hit_rate"] or 0.0
    ok = (report["recompiles_after_warmup"] == 0
          and hit_rate >= args.hit_threshold)
    if not ok:
        print(f"FAIL: recompiles_after_warmup="
              f"{report['recompiles_after_warmup']}, "
              f"hit_rate={hit_rate:.3f} "
              f"(threshold {args.hit_threshold})", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
