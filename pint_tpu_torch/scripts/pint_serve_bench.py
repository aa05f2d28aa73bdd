"""End-to-end driver for the online timing service (pint_tpu_torch.serve;
the JAX package's ``scripts/pint_serve_bench.py``): build a mixed fleet
(several model structures x several TOA bucket sizes), prewarm the
executable cache, stream a few hundred requests through ServeEngine,
and report latency percentiles + cache counters, optionally
cross-checking every fit against the offline PTAFleet path.

This is the serving acceptance harness: a mixed-shape stream must
complete with ZERO captures after warmup (cache hit rate ~100%) and
parameters matching the offline path to ~1e-12.

    python -m pint_tpu_torch.scripts.pint_serve_bench            # the card
    python -m pint_tpu_torch.scripts.pint_serve_bench --device cpu \\
        --requests 24 --bucket-floor 32
    python -m pint_tpu_torch.scripts.pint_serve_bench --chaos   # faults
    python -m pint_tpu_torch.scripts.pint_serve_bench --chaos \\
        --fault-point process_kill                   # the SIGKILL matrix

``--chaos`` runs the chaos acceptance stream (:func:`run_chaos_stream`:
low-rate intake faults against a fault-free reference);
``--fault-point process_kill`` the process-kill matrix
(:func:`run_kill_chaos`: a serving subprocess SIGKILLed at every named
durability site, restarted, and held to exactly-once bitwise replay);
``--arrival-sweep`` the open-loop saturation bench over the async front
door (:func:`run_arrival_sweep`: seeded Poisson arrivals through a
ladder of offered rates, the p99-vs-throughput knee and the shed
onset); ``--chaos --fault-point device_loss`` (or
``collective_timeout``, ``straggler_delay``) the device chaos
(:func:`run_device_chaos`: a device lost, hung or slow under a
``devices=`` engine and a ``FleetMesh`` fit, each held to its
fault-free run; ``--devices N`` lanes, repeating the available devices:
logical lanes on one card). ``--trace-out PATH`` traces any of them and
writes the span timeline as Chrome trace-event JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

from pint_tpu_torch.obs import clock as obs_clock

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


def arrival_schedule(rate_rps, n, seed=0, rate_index=0):
    """Deterministic open-loop Poisson arrivals: n cumulative offsets
    (seconds from stream start) with exponential inter-arrival gaps at
    ``rate_rps``, drawn from ``default_rng([seed, rate_index])`` so
    every (seed, ladder-rung) pair replays the same schedule
    bit-for-bit across processes."""
    rng = np.random.default_rng([int(seed), int(rate_index)])
    gaps = rng.exponential(1.0 / float(rate_rps), size=int(n))
    return np.cumsum(gaps)


def run_arrival_sweep(n_per_rate=96, fracs=(0.25, 0.5, 0.75, 1.0,
                                            1.25, 1.5, 2.0, 3.0),
                      max_batch=8, max_latency_s=0.01, max_queue=None,
                      bucket_floor=64, cache_capacity=32, sizes=(48,),
                      per_combo=1, maxiter=2, precision="f64",
                      knee_factor=3.0, seed=0, mesh=None, producers=4,
                      device="cuda"):
    """Open-loop saturation bench over the ASYNC front door: drive
    AsyncServeEngine with seeded Poisson arrivals from ``producers``
    concurrent submitter threads through a monotone ladder of offered
    rates and report the p99-vs-throughput curve with knee detection.

    Calibration first runs a closed-loop burst (a bounded in-flight
    window of ``max_batch`` outstanding requests) to measure the
    engine's service capacity (``base_rps``); the ladder offers
    ``fracs`` multiples of it. Each rung replays a deterministic
    :func:`arrival_schedule` — bit-reproducible per (seed, rung), the
    producer threads only PARTITION it (k = pid mod producers), they
    never re-draw it — and submits on schedule regardless of how far
    behind the engine has fallen: latency is measured from the
    SCHEDULED arrival (via the lifecycle ledger's terminal-state
    timestamp), so queue growth under overload is charged to the rung
    instead of being hidden by coordinated omission.

    Because intake is decoupled from flush (serve.frontdoor), the
    bounded queue genuinely fills when offered > service rate and the
    engine SHEDS: ``shed_onset_rps`` is the first offered rate that
    tripped the intake bound, and the knee is the last rung still
    "good" (p99 within ``knee_factor`` x the unloaded rung's p99 and
    zero sheds) before the first degraded rung. max_queue defaults to
    ``max(4 * max_batch, n_per_rate // 2)`` so overload rungs build a
    backlog that actually exceeds the bound within one rung. The
    engine runs a lenient HealthMonitor (draining disabled): overload
    rungs are SUPPOSED to shed heavily, and draining would poison
    every later rung with rejections. Returns a JSON-safe report with
    per-rung rows, the knee keys, and a schedule digest for
    determinism tests; null knee keys carry machine-readable
    ``null_reasons`` only for genuine skips (no saturation observed /
    degraded at the lowest rate). The engine and the fleet run on
    ``device``, or over ``mesh`` (``ServeEngine(mesh=)``)."""
    import hashlib
    import threading
    import time as _time

    from pint_tpu_torch.obs.metricsreg import percentile
    from pint_tpu_torch.obs.reqlife import TERMINAL_STATES, LifecycleLedger
    from pint_tpu_torch.resilience.health import HealthMonitor
    from pint_tpu_torch.serve import AsyncServeEngine, FitRequest

    t_sweep = obs_clock.now()
    if max_queue is None:
        max_queue = max(4 * max_batch, n_per_rate // 2)
    producers = max(1, int(producers))
    models, toas_list = build_serve_fleet(sizes=sizes,
                                          per_combo=per_combo,
                                          seed=seed, device=device)
    n_pulsars = len(models)
    ledger = LifecycleLedger()
    # shed_rate thresholds above 1.0 are unreachable: overload rungs
    # shed by design, and a draining health state would reject every
    # later rung's traffic at the door
    health = HealthMonitor(clock=_time.monotonic,
                           degraded_shed_rate=1.01,
                           draining_shed_rate=1.01)
    eng = AsyncServeEngine(max_batch=max_batch,
                           max_latency_s=max_latency_s,
                           max_queue=max_queue,
                           bucket_floor=bucket_floor,
                           cache_capacity=cache_capacity, mesh=mesh,
                           health=health, reqlife=ledger, device=device)

    def req(i):
        return FitRequest(models[i % n_pulsars],
                          toas_list[i % n_pulsars],
                          maxiter=maxiter, precision=precision)

    eng.prewarm([req(i) for i in range(n_pulsars)])

    # closed-loop calibration: a bounded window of max_batch
    # outstanding requests measures the service capacity the open-loop
    # ladder is scaled against, without ever overfilling the intake
    window = max(1, int(max_batch))
    cal = []
    head = 0
    t0 = obs_clock.now()
    for i in range(n_per_rate):
        cal.append(eng.submit(req(i)))
        while head < len(cal) and cal[head].done:
            head += 1
        while len(cal) - head >= window:
            _time.sleep(2e-4)
            while head < len(cal) and cal[head].done:
                head += 1
    eng.drain()
    cal_wall = max(obs_clock.now() - t0, 1e-9)
    base_rps = n_per_rate / cal_wall
    base_p99 = percentile([r.telemetry.get("total_s") for r in cal
                           if r.status == "ok"
                           and r.telemetry.get("total_s") is not None],
                          99)

    fracs = tuple(sorted(fracs))
    rates = [f * base_rps for f in fracs]
    sched_hash = hashlib.sha256()
    rows = []
    nonterminal_total = 0
    for idx, rate in enumerate(rates):
        sched = arrival_schedule(rate, n_per_rate, seed=seed,
                                 rate_index=idx)
        sched_hash.update(np.asarray(sched, np.float64).tobytes())
        ledger.reset()
        eng.telemetry.reset()
        # requests minted up front on the calling thread: ids (and the
        # schedule itself) stay deterministic, and producer threads do
        # nothing but pace and submit
        reqs = [req(k) for k in range(n_per_rate)]
        handles = [None] * n_per_rate

        def producer(pid, start):
            # offered load, open loop: every producer paces its
            # partition of the SHARED schedule against the shared
            # start time, so the merged arrival process is the same
            # Poisson draw regardless of the producer count
            for k in range(pid, n_per_rate, producers):
                target = start + sched[k]
                while True:
                    now = obs_clock.now()
                    if now >= target:
                        break
                    _time.sleep(min(target - now, 2e-4))
                handles[k] = eng.submit(reqs[k])

        start = obs_clock.now()
        threads = [threading.Thread(target=producer, args=(pid, start),
                                    name=f"sweep-producer-{pid}")
                   for pid in range(producers)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        eng.drain()
        end = obs_clock.now()
        lats, delivered, shed = [], 0, 0
        for k, h in enumerate(handles):
            rec = ledger.record(h.request.request_id)
            term_t = None
            for st in (rec or {}).get("states", ()):
                if st["state"] in TERMINAL_STATES:
                    term_t = st["t"]
            if h.status == "ok":
                delivered += 1
                lats.append((term_t if term_t is not None else end)
                            - (start + sched[k]))
            elif h.status == "shed":
                shed += 1
        nonterminal_total += len(ledger.nonterminal_ids())
        span_s = max(end - start, 1e-9)
        rows.append({
            "offered_rps": round(rate, 3),
            "achieved_rps": round(delivered / span_s, 3),
            "delivered": delivered,
            "shed": shed,
            "errors": n_per_rate - delivered - shed,
            "p50_s": percentile(lats, 50),
            "p99_s": percentile(lats, 99),
            "max_s": max(lats) if lats else None,
        })
    eng.close()

    # knee: last good rung before the first degraded one, measured
    # against the unloaded open-loop latency (rung 0 carries the
    # continuous-batching handoff that closed-loop calibration hides)
    ref_p99 = rows[0]["p99_s"] if rows else None

    def good(row):
        return (row["delivered"] > 0 and row["shed"] == 0
                and row["p99_s"] is not None and ref_p99 is not None
                and row["p99_s"] <= knee_factor * ref_p99)

    first_bad = next((i for i, row in enumerate(rows)
                      if not good(row)), None)
    if first_bad is None:
        knee_idx, saturated = len(rows) - 1, False
    elif first_bad == 0:
        knee_idx, saturated = None, True
    else:
        knee_idx, saturated = first_bad - 1, True
    shed_onset = next((row["offered_rps"] for row in rows
                       if row["shed"] > 0), None)
    null_reasons = {}
    if knee_idx is None:
        null_reasons["knee_rps"] = "degraded_at_lowest_rate"
        null_reasons["p99_at_knee_s"] = "degraded_at_lowest_rate"
    if shed_onset is None:
        # the inline-flush excuse (queue_bounded_by_inline_flush) is
        # retired with the async front door: a concurrent load that
        # never sheds simply never offered enough load
        null_reasons["shed_onset_rps"] = "no_saturation_observed"
    offered = [row["offered_rps"] for row in rows]
    return {
        "n_per_rate": n_per_rate,
        "fracs": list(fracs),
        "producers": producers,
        "engine": "async",
        "base_rps": round(base_rps, 3),
        "base_p99_s": base_p99,
        "ref_p99_s": ref_p99,
        "knee_factor": knee_factor,
        "max_queue": max_queue,
        "offered_rps": offered,
        "monotone_offered": bool(
            all(a < b for a, b in zip(offered, offered[1:]))),
        "rows": rows,
        "saturated": saturated,
        "knee_rps": (rows[knee_idx]["offered_rps"]
                     if knee_idx is not None else None),
        "p99_at_knee_s": (rows[knee_idx]["p99_s"]
                          if knee_idx is not None else None),
        "shed_onset_rps": shed_onset,
        "null_reasons": null_reasons,
        "schedule_sha256": sched_hash.hexdigest(),
        "reqlife_nonterminal": nonterminal_total,
        "wall_s": round(obs_clock.now() - t_sweep, 3),
    }


def run_chaos_stream(n_requests=216, fault_rate=0.05,
                     fault_point="toa_nan", max_batch=8,
                     max_latency_s=0.05, bucket_floor=64,
                     cache_capacity=32, sizes=(48, 96, 180),
                     per_combo=3, maxiter=3, precision="f64",
                     mesh=None, seed=0, rel_tol=1e-9, device="cuda"):
    """Chaos acceptance run: the serve stream with a low-rate fault
    schedule injected at intake, differenced against a fault-free run
    of the same stream.

    The contract being checked: every UNINJECTED request completes
    "ok" with results identical (to fp tolerance) to the fault-free run
    — a poisoned neighbor must cost nothing; every INJECTED request
    gets a structured rejection (or quarantine); the engine finishes
    the stream (no hang), ends in the "healthy" state, and performs
    zero unexpected recompiles. Returns a JSON-safe report with
    report["ok"] summarizing all of it. Beyond the JAX package's keys,
    ``digest_mismatches`` counts the uninjected results whose
    ``result_digest`` differs from the fault-free run's (the injected
    requests shift the flush compositions, so 0 means no lane's bits
    depend on its neighbours), and ``stream_wall_s`` the chaos
    stream's host wall."""
    from pint_tpu_torch.resilience import FaultPoint, inject
    from pint_tpu_torch.serve import FitRequest, ServeEngine, result_digest

    models, toas_list = build_serve_fleet(sizes=sizes, per_combo=per_combo,
                                          seed=seed, device=device)
    n_pulsars = len(models)

    def req(i):
        return FitRequest(models[i % n_pulsars],
                          toas_list[i % n_pulsars],
                          maxiter=maxiter, precision=precision)

    def engine():
        return ServeEngine(max_batch=max_batch,
                           max_latency_s=max_latency_s,
                           bucket_floor=bucket_floor,
                           cache_capacity=cache_capacity, mesh=mesh,
                           device=device)

    # fault-free reference stream
    eng0 = engine()
    eng0.prewarm([req(i) for i in range(n_pulsars)])
    clean = eng0.run_stream([req(i) for i in range(n_requests)])

    # chaos stream: prewarm UNARMED (warmup is part of deployment,
    # not of the fault schedule), then inject for the stream itself
    eng1 = engine()
    warm_compiles = eng1.prewarm([req(i) for i in range(n_pulsars)])
    pt = FaultPoint(fault_point, rate=fault_rate, seed=seed)
    t_stream = obs_clock.now()
    with inject(pt):
        chaos = eng1.run_stream([req(i) for i in range(n_requests)])
    stream_wall_s = obs_clock.now() - t_stream
    snap = eng1.snapshot()

    injected = [i for i, r in enumerate(chaos)
                if (r.telemetry.get("detail", {}) or {})
                .get("injected_point")]
    inj_structured = all(
        chaos[i].status == "rejected"
        and chaos[i].telemetry.get("rejected") is True
        for i in injected)
    worst = 0.0
    healthy_failures = 0
    digest_mismatches = 0
    for i, (rc, rf) in enumerate(zip(clean, chaos)):
        if i in injected:
            continue
        if rf.status != "ok" or rc.status != "ok":
            healthy_failures += 1
            continue
        if result_digest(rf.value) != result_digest(rc.value):
            digest_mismatches += 1
        rel = np.max(np.abs(np.asarray(rf.value["x"])
                            - np.asarray(rc.value["x"]))
                     / np.maximum(np.abs(np.asarray(rc.value["x"])),
                                  1e-30))
        if not np.isfinite(rel) or rel > rel_tol:
            healthy_failures += 1
        worst = float(np.maximum(worst, rel))
    counters = snap["counters"]
    report = {
        "n_requests": n_requests,
        "fault_point": fault_point,
        "fault_rate": fault_rate,
        "injected": len(injected),
        "fires": pt.fires,
        "injected_structured": bool(inj_structured),
        "healthy": n_requests - len(injected),
        "healthy_failures": healthy_failures,
        "max_rel_diff_vs_clean": worst,
        "digest_mismatches": digest_mismatches,
        "stream_wall_s": stream_wall_s,
        "all_done": all(r.done for r in chaos),
        "warmup_executables": warm_compiles,
        "recompiles_after_warmup": (snap["executables_compiled"]
                                    - warm_compiles),
        "unexpected_recompiles": counters.get("unexpected_recompiles",
                                              0),
        "health_state": snap["health"]["state"],
        "health": snap["health"],
        "breaker": snap["breaker"],
        "shed": sum(v for k, v in counters.items()
                    if k.startswith("shed_")),
        "retries": counters.get("retries", 0),
        "quarantined": counters.get("quarantined", 0),
        "counters": counters,
    }
    report["ok"] = bool(
        report["all_done"]
        and report["healthy_failures"] == 0
        and report["injected"] == report["fires"]
        and report["injected_structured"]
        and report["health_state"] == "healthy"
        and report["unexpected_recompiles"] == 0)
    return report


def device_lanes(n_devices=None, device="cuda"):
    """The lanes of a multi-device run: ``n_devices`` entries cycling
    over every device of ``device``'s type (all CUDA devices, or the
    CPU), so several lanes may name one device — logical lanes, each
    its own failure domain. At least two by default: a lost lane needs a
    survivor."""
    import torch

    from pint_tpu_torch import resolve_device

    dev = resolve_device(device)
    avail = ([torch.device("cuda", i)
              for i in range(torch.cuda.device_count())]
             if dev.type == "cuda" else [dev])
    n = n_devices if n_devices is not None else max(2, len(avail))
    return [avail[i % len(avail)] for i in range(n)]


def run_device_chaos(n_requests=96, fault_point="device_loss",
                     n_devices=None, max_batch=8, max_latency_s=0.05,
                     bucket_floor=64, cache_capacity=32,
                     sizes=(48, 96, 180), per_combo=3, maxiter=3,
                     precision="f64", seed=0, rel_tol=1e-9,
                     fleet_rel_tol=1e-15, device="cuda"):
    """Device-level chaos acceptance: both multi-device surfaces run with
    an injected device-level fault and are differenced against
    fault-free runs on the same lanes.

    Serve leg (always device_loss): the request stream on an N-lane
    ServeEngine loses one routed device mid-stream; the contract is that
    the lane is quarantined, its slots shed onto the next alive lane,
    every request still completes "ok", and results match the
    fault-free stream bitwise (same programs, another lane).

    Fleet leg (``fault_point``: device_loss / collective_timeout /
    straggler_delay): a FleetMesh fit takes the fault and must complete
    on the survivors with parameters within ``fleet_rel_tol`` of the
    healthy fit, stealing the dead lane's buckets deterministically.

    The lanes are :func:`device_lanes` of ``n_devices`` and ``device``.
    Returns a JSON-safe report; report["ok"] summarizes both legs. Keys
    are the JAX package's."""
    from pint_tpu_torch.parallel import FleetMesh
    from pint_tpu_torch.resilience import DEVICE_POINTS, FaultPoint, inject
    from pint_tpu_torch.serve import FitRequest, ServeEngine

    if fault_point not in DEVICE_POINTS:
        raise ValueError(f"fault_point must be one of {DEVICE_POINTS}, "
                         f"got {fault_point!r}")
    devices = device_lanes(n_devices, device)
    n_lanes = len(devices)
    models, toas_list = build_serve_fleet(
        sizes=sizes, per_combo=per_combo, seed=seed, device=device)
    n_pulsars = len(models)

    def req(i):
        return FitRequest(models[i % n_pulsars],
                          toas_list[i % n_pulsars],
                          maxiter=maxiter, precision=precision)

    def engine():
        return ServeEngine(max_batch=max_batch,
                           max_latency_s=max_latency_s,
                           bucket_floor=bucket_floor,
                           cache_capacity=cache_capacity,
                           devices=devices, device=devices[0])

    # -- serve leg: one device dies mid-stream ----------------------
    eng0 = engine()
    clean = eng0.run_stream([req(i) for i in range(n_requests)])
    eng1 = engine()
    # after=2: the loss lands mid-stream (a couple of flushes in),
    # small enough to fire even when slots batch efficiently
    with inject(FaultPoint("device_loss", rate=1.0, count=1,
                           after=2, seed=seed)):
        chaos = eng1.run_stream([req(i) for i in range(n_requests)])
    snap = eng1.snapshot()
    serve_failures = sum(1 for r in chaos if r.status != "ok")
    worst_serve = 0.0
    serve_bitwise = True
    for rc, rf in zip(clean, chaos):
        if rc.status != "ok" or rf.status != "ok":
            continue
        xc, xf = np.asarray(rc.value["x"]), np.asarray(rf.value["x"])
        serve_bitwise = serve_bitwise and bool(np.array_equal(xc, xf))
        rel = np.max(np.abs(xf - xc) / np.maximum(np.abs(xc), 1e-30))
        worst_serve = float(np.maximum(worst_serve, rel))
    dev = snap.get("devices", {})

    # -- fleet leg: FleetMesh fit through the injected fault --------
    fleet_kw = dict(devices=devices, toa_bucket="pow2",
                    bucket_floor=bucket_floor)
    if fault_point == "collective_timeout":
        # injected hangs advance a no-op sleep; the real watchdog
        # bound stays generous so genuine captures never trip it
        fleet_kw.update(collective_timeout_s=120.0,
                        sleep=lambda s: None)
    else:
        fleet_kw.update(collective_timeout_s=None)
    payloads = {"device_loss": {},
                "collective_timeout": {"hang_s": 240.0},
                "straggler_delay": {"delay_s": 0.0}}
    fm_h = FleetMesh(models, toas_list, **fleet_kw)
    hx, hc, _ = fm_h.fit(maxiter=maxiter)
    fm_c = FleetMesh(models, toas_list, **fleet_kw)
    with inject(FaultPoint(fault_point, rate=1.0, count=1, seed=seed,
                           payload=payloads[fault_point])):
        cx, cc, _ = fm_c.fit(maxiter=maxiter)
    worst_fleet = 0.0
    for i in range(n_pulsars):
        rel = np.max(np.abs(np.asarray(cx[i]) - np.asarray(hx[i]))
                     / np.maximum(np.abs(np.asarray(hx[i])), 1e-30))
        worst_fleet = float(np.maximum(worst_fleet, rel))
    fsnap = fm_c.snapshot()

    report = {
        "fault_point": fault_point,
        "n_lanes": n_lanes,
        "devices": [str(d) for d in devices],
        "n_requests": n_requests,
        "serve_failures": serve_failures,
        "serve_max_rel_diff_vs_clean": worst_serve,
        "serve_bitwise_vs_clean": serve_bitwise,
        "serve_lost_lanes": dev.get("lost_lanes", []),
        "serve_device_lost": snap["counters"].get("device_lost", 0),
        "fleet_max_rel_diff_vs_healthy": worst_fleet,
        "fleet_lost_lanes": fsnap["lost_lanes"],
        "fleet_stolen_buckets": fsnap["stolen_buckets"],
        "fleet_reassignments": fsnap["reassignments"],
        "all_done": all(r.done for r in chaos),
    }
    # device_loss must actually kill a lane on each leg; the other
    # fault points are absorbed (strike/delay) without lane loss
    expect_loss = fault_point == "device_loss"
    report["ok"] = bool(
        report["all_done"]
        and serve_failures == 0
        and worst_serve <= rel_tol
        and len(report["serve_lost_lanes"]) == 1
        and report["serve_device_lost"] == 1
        and worst_fleet <= fleet_rel_tol
        and (len(report["fleet_lost_lanes"]) == (1 if expect_loss
                                                 else 0))
        and (report["fleet_stolen_buckets"] >= 1) == expect_loss)
    return report


def _run_chaos_child(config):
    """One serving process of the process-kill chaos harness.

    ``mode: serve`` streams requests through a durable engine (the
    parent arms ``PINT_TPU_FAULTS=process_kill:at=<site>`` so the
    child SIGKILLs itself mid-flush; the unarmed variant is the
    fault-free reference that also warms the shared executable cache
    and records ground-truth result digests). ``mode: recover`` is the
    restarted process: it measures cold-start-to-first-result off the
    persisted caches, replays the journal, and reports exactly-once
    bookkeeping for the parent to assert on. Results land in
    ``config["out"]`` via an atomic write (a crashed child leaves no
    file, which the parent treats as the verdict). Everything the
    child journals is host data (serve/journal.py), so a restarted
    child reads the dead one's log before it touches the card."""

    from pint_tpu_torch.durable import atomic_write_json
    from pint_tpu_torch.serve import (AsyncServeEngine, FitRequest,
                                      ServeEngine, result_digest,
                                      save_serve_state)

    device = config.get("device", "cuda")
    mode = config["mode"]
    site = config.get("site", "")
    ntoa = int(config.get("ntoa", 8192))
    lanes = int(config.get("lanes", 4))
    maxiter = int(config.get("maxiter", 40))
    method = config.get("method", "gls")
    structure = int(config.get("structure", 2))
    n_requests = int(config.get("n_requests", 3 * lanes))
    seed = int(config.get("seed", 0))

    def engine():
        # max_latency_s high: slots flush when FULL (lanes requests),
        # so every kill strands a genuine committed/pending mixture
        # instead of single-request flushes. The flusher_take legs
        # run the ASYNC front door — that kill site only fires on the
        # flusher worker thread right after a dequeue, which is where
        # a real serving process dies; the other sites live in the
        # shared submit/journal/cache path, so they keep the sync
        # engine (no flusher/watchdog threads competing with the
        # child's capture work).
        kw = dict(max_batch=lanes, max_latency_s=600.0,
                  bucket_floor=ntoa,
                  durable_dir=config["durable_dir"],
                  excache_dir=config["excache_dir"],
                  store_dir=config.get("store_dir"), device=device)
        if site == "flusher_take":
            return AsyncServeEngine(**kw)
        return ServeEngine(**kw)

    def bringup(premade=None):
        """Restart sequence a real serving process follows: construct
        the engine FIRST (which kicks off the background re-capture
        from the persisted tier AND the pack-store CRC prewarm), then
        do the rest of the process bring-up — loading pulsar models
        and TOAs — while the re-capture runs off the critical path. By
        ready-to-serve the programs are warm; this overlap is what
        makes the 2x cold-start bound reachable. With an explicit
        ``store_dir``
        in the config (the store_write chaos legs), the fleet batch
        is additionally built THROUGH the pack store — a store hit
        skips host prep, a miss runs it live and writes back, and the
        armed ``store_write`` kill lands just before that write's
        atomic publish. Returns (engine, model, toas,
        bringup_wall)."""
        t0 = obs_clock.now()
        eng = premade if premade is not None else engine()
        models, toas_list = build_serve_fleet(sizes=(ntoa,),
                                              per_combo=1, seed=seed,
                                              device=device)
        # one structure, one bucket -> one program table, one .pex
        # file; the default (red-noise GLS, 8192 TOAs, maxiter 40) is
        # sized so a warm refit flush dominates the residual restart
        # tax, making the 2x cold-start bound a real constraint
        if config.get("store_dir") and eng.store is not None:
            from pint_tpu_torch.parallel.pta import PTAFleet

            PTAFleet([models[structure]], [toas_list[structure]],
                     store=eng.store, device=device)
        return (eng, models[structure], toas_list[structure],
                obs_clock.now() - t0)

    model = toas = None  # bound by bringup() below, used by req()

    def req(request_id=None):
        kw = {} if request_id is None else {"request_id": request_id}
        return FitRequest(model, toas, method=method, maxiter=maxiter,
                          **kw)

    def probe_batch(tag):
        # a full flush of `lanes` requests, so probes hit the same
        # (bucket, batch) executable the stream compiled
        return [req(f"probe-{tag}-{i}") for i in range(lanes)]

    def append_fixture():
        """Deterministic streaming-lane fixture shared by the
        append_delta_write legs ACROSS processes: same par file, same
        seeded TOAs in every child, so the lane key, base content
        signature, and per-append delta chain signatures agree
        between the reference, killed, and recovered runs."""
        from pint_tpu_torch.models import get_model
        from pint_tpu_torch.simulation import make_fake_toas_fromMJDs

        rng = np.random.default_rng(seed + 17)
        par = ("PSR KILL0\nRAJ 6:00:00.0\nDECJ 5:00:00.0\n"
               "F0 173.6 1\nF1 -3e-16 1\nPEPOCH 55400\nDM 21.0 1\n")
        lane_model = get_model(par)
        base_toas = make_fake_toas_fromMJDs(
            np.sort(rng.uniform(54800, 56000, 64)), lane_model,
            error_us=1.0, freq_mhz=1400.0, obs="gbt", add_noise=True,
            seed=seed + 17, device=device)
        chunks = []
        lo = 56000.0
        for i in range(int(config.get("n_appends", 4))):
            mj = np.sort(rng.uniform(lo, lo + 5.0, 8))
            lo += 5.0
            chunks.append(make_fake_toas_fromMJDs(
                mj, lane_model, error_us=1.0, freq_mhz=1400.0,
                obs="gbt", add_noise=True, seed=seed + 100 + i,
                device=device))
        return lane_model, base_toas, chunks

    if mode == "serve" and config.get("append_stream"):
        # the append_delta_write legs: stream AppendToasRequests
        # through a registered lane instead of fit flushes. The armed
        # child SIGKILLs itself inside a delta write (after=1 lets the
        # first append's segment publish, so the chain on disk holds
        # a real committed prefix when the kill lands); the unarmed
        # variant is the digest ground truth for replay.
        from pint_tpu_torch.serve import AppendToasRequest

        eng, model, toas, _ = bringup()
        lane_model, base_toas, chunks = append_fixture()
        eng.register_append_lane(lane_model, base_toas)
        results = [eng.submit(AppendToasRequest(lane_model, c))
                   for c in chunks]
        save_serve_state(eng)
        eng.journal.close()
        atomic_write_json(config["out"], {
            "mode": mode,
            "statuses": {r.request.request_id: r.status
                         for r in results},
            "digests": {r.request.request_id: result_digest(r.value)
                        for r in results},
            "deltas": (eng.deltas.scan()
                       if eng.deltas is not None else None),
        })
        return 0

    if mode == "serve":
        eng, model, toas, _ = bringup()
        results = eng.run_stream([req() for _ in range(n_requests)])
        # only reached when no kill fired (the fault-free reference)
        snap = eng.snapshot()
        save_serve_state(eng)
        if isinstance(eng, AsyncServeEngine):
            eng.close()
        eng.journal.close()
        atomic_write_json(config["out"], {
            "mode": mode,
            "statuses": {r.request.request_id: r.status
                         for r in results},
            "digests": {r.request.request_id: result_digest(r.value)
                        for r in results},
            "compiles": snap["executables_compiled"],
            "cache": snap["cache"],
        })
        return 0

    if mode != "recover":
        raise ValueError(f"unknown chaos-child mode {mode!r}")

    # -- restarted process: cold first result, then replay ----------
    # cold_first_result_s clocks ready-to-serve -> first delivered
    # result; the preceding bring-up (reported separately) is where
    # the persisted tier's re-capture overlaps, per bringup()'s note
    eng, model, toas, bringup_s = bringup()
    if config.get("append_stream"):
        # the lane MUST be registered before recover(): replayed
        # append_toas intakes resolve their lane by key, and
        # registration is also where the persisted delta chain (the
        # committed prefix the dead process left) folds back into the
        # fresh base state
        lane_model, base_toas, _chunks = append_fixture()
        eng.register_append_lane(lane_model, base_toas)
    t0 = obs_clock.now()
    cold_probe = eng.run_stream(probe_batch(f"cold-{site}"))
    cold_first_result_s = obs_clock.now() - t0
    rep = eng.recover()
    warm_walls = []
    warm_probes = []
    for k in range(3):
        t1 = obs_clock.now()
        warm_probes += eng.run_stream(probe_batch(f"warm-{site}-{k}"))
        warm_walls.append(obs_clock.now() - t1)
    snap = eng.snapshot()

    # exactly-once bookkeeping straight from the journal: stream rids
    # (req-*) with a commit are delivered; >1 commit is a double
    # delivery; an intake with no commit after recovery is a lost
    # request
    jrep = eng.journal.replay()
    commit_counts = {}
    for r in jrep.records:
        if r.get("t") == "commit" and str(r.get("rid", "")) \
                .startswith("req-"):
            commit_counts[r["rid"]] = commit_counts.get(r["rid"], 0) + 1
    committed = {rid: {"status": rec.get("status"),
                       "digest": result_digest(rec.get("value"))}
                 for rid, rec in jrep.committed.items()
                 if str(rid).startswith("req-")}
    # recovery must leave no request mid-machine: journal returns are
    # replayed_committed, replays ran to live terminal states, probes
    # delivered — anything still non-terminal is a leak
    reqlife_nonterminal = (len(eng.reqlife.nonterminal_ids())
                           if eng.reqlife is not None else None)
    store_rep = None
    if config.get("store_dir") and eng.store is not None:
        # scanned AFTER bringup's rebuild: a torn artifact from the
        # killed writer would have shown up as a corrupt-CRC load
        # (counters["corrupt"] > 0) during the store consult, and the
        # scan proves the re-put entry verifies end to end
        store_rep = {"scan": eng.store.scan(),
                     "counters": eng.store.counters()}
    deltas_rep = None
    if config.get("append_stream") and eng.deltas is not None:
        # scanned AFTER recovery replayed the pending appends: a torn
        # delta segment from the killed writer would surface as
        # corrupt_or_stale > 0, and the streaming counters witness the
        # committed prefix actually replaying through registration
        deltas_rep = {"scan": eng.deltas.scan(),
                      "counters": eng.streaming.counters()}
    if isinstance(eng, AsyncServeEngine):
        eng.close()
    eng.journal.close()
    atomic_write_json(config["out"], {
        "mode": mode,
        "site": site,
        "cold_first_result_s": cold_first_result_s,
        "bringup_s": bringup_s,
        "warm_refit_s": min(warm_walls),
        "warm_walls": warm_walls,
        "cold_probe_ok": all(r.status == "ok" for r in cold_probe),
        # a probe that came back without fitting cannot pass: every
        # warm probe must be ok, warm, and carry the digest the
        # fault-free reference's identical requests delivered
        "warm_probes_ok": all(
            r.status == "ok" and not r.telemetry.get("cold")
            for r in warm_probes),
        "probe_digests": sorted({result_digest(r.value)
                                 for r in cold_probe + warm_probes}),
        # count only stream rids: the cold probe above also committed
        # `lanes` probe-* requests into the journal before recover()
        "n_committed_before": sum(
            1 for rid in rep["committed"]
            if str(rid).startswith("req-")),
        "n_replayed": rep["n_replayed"],
        "replay_wall_s": rep["replay_wall_s"],
        "torn_truncated": rep["torn_truncated"],
        "state_restored": rep["state_restored"],
        "reqlife_nonterminal": reqlife_nonterminal,
        "lost": [rid for rid in
                 (r["rid"] for r in jrep.pending)
                 if str(rid).startswith("req-")],
        "duplicated": [rid for rid, n in commit_counts.items()
                       if n > 1],
        "committed": committed,
        "compiles": snap["executables_compiled"],
        "cache": snap["cache"],
        "store": store_rep,
        "deltas": deltas_rep,
    })
    return 0


def run_kill_chaos(sites=None, ntoa=8192, lanes=4, maxiter=40,
                   method="gls", structure=2, n_requests=None, seed=0,
                   workdir=None, ratio_bound=2.0,
                   child_timeout_s=600.0, device="cuda"):
    """Process-kill chaos acceptance: SIGKILL a serving process
    mid-flush at every named kill site, restart it, and assert the
    crash-safety contract:

    - zero lost requests: every journaled intake is committed after
      recovery (the restarted process replays pending work);
    - zero duplicated commits: a result committed before the kill is
      never re-run or re-delivered;
    - bitwise replay: every committed stream result matches the
      fault-free reference run's digest exactly;
    - warm restart: with the persisted program tier, the restarted
      process captures nothing on its request path (``recompiles ==
      0``) and its cold start to first result stays within
      ``ratio_bound`` x a warm refit flush (``excache_store`` runs
      against a private cold tier -- the kill lands mid-store -- so it
      checks capture-on-absence, ``recompiles >= 1``, instead);
    - no torn pack-store artifact: the ``store_write`` site kills just
      before the packed-TOA store's atomic publish during bring-up;
      the restarted process must see a clean miss (zero corrupt-CRC
      loads), rebuild live, and re-publish a verifying entry;
    - no torn delta segment: the ``append_delta_write`` site streams
      ``append_toas`` requests through a registered streaming lane
      and kills inside the SECOND append's delta write (the first
      segment is a committed on-disk prefix). The restarted process
      re-registers the lane (replaying the committed prefix), replays
      the pending append exactly once, its result digest matches the
      fault-free append reference bitwise, and the delta scan shows
      zero corrupt-or-stale segments.

    Each leg is a separate process, started with ``subprocess`` as
    ``python -m pint_tpu_torch.scripts.pint_serve_bench --chaos-child``
    (never forked: a forked CUDA context is unusable); the kill is a
    genuine ``os.kill(getpid(), SIGKILL)`` fired from inside the
    engine by the armed ``process_kill`` fault, whose
    ``PINT_TPU_FAULTS`` spec only the killed leg's environment
    carries. On the card the parent builds the kernels before the
    first child starts, so children only load them. The reference legs
    run together, then the kill legs (nothing of theirs is timed); the
    restarted legs run one at a time, so their cold/warm walls are not
    shared, unless ``ratio_bound`` is infinite (no wall is judged),
    when they run together too. Returns a JSON-safe report;
    report["ok"] summarizes all sites."""
    import tempfile

    from pint_tpu_torch.durable import atomic_write_json
    from pint_tpu_torch.resilience import faultinject

    sites = tuple(sites) if sites is not None else faultinject.KILL_SITES
    bad = [s for s in sites if s not in faultinject.KILL_SITES]
    if bad:
        raise ValueError(f"unknown kill sites {bad}; pick from "
                         f"{faultinject.KILL_SITES}")
    if n_requests is None:
        n_requests = 3 * lanes
    workdir = workdir or tempfile.mkdtemp(prefix="pint_kill_chaos_")
    os.makedirs(workdir, exist_ok=True)
    shared_excache = os.path.join(workdir, "excache")
    if str(device).startswith("cuda"):
        from pint_tpu_torch.kernels import build

        build.load_all(["gram"])
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

    def start(config, env_faults=None):
        """Start one child leg; returns its handle for :func:`wait`."""
        tag = config["tag"]
        cfg_path = os.path.join(workdir, f"cfg_{tag}.json")
        atomic_write_json(cfg_path, config)
        env = dict(os.environ)
        env.pop("PINT_TPU_FAULTS", None)
        if env_faults:
            env["PINT_TPU_FAULTS"] = env_faults
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (root, env.get("PYTHONPATH")) if p)
        err = open(os.path.join(workdir, f"stderr_{tag}.log"), "w+")
        proc = subprocess.Popen(
            [sys.executable, "-m", "pint_tpu_torch.scripts.pint_serve_bench",
             "--chaos-child", cfg_path],
            env=env, stdout=subprocess.DEVNULL, stderr=err)
        return proc, err, obs_clock.now()

    def wait(handle):
        """(returncode or None on timeout, stderr tail, wall)."""
        proc, err, t0 = handle
        try:
            rc = proc.wait(timeout=max(1.0, child_timeout_s
                                       - (obs_clock.now() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = None
        wall = obs_clock.now() - t0
        err.seek(0)
        tail = err.read()[-2000:]
        err.close()
        return rc, (tail if rc is not None else "timeout"), wall

    def run_all(jobs, parallel):
        """[(rc, stderr, wall)] of the (config, env_faults) jobs."""
        if parallel:
            return [wait(h) for h in [start(*job) for job in jobs]]
        return [wait(start(*job)) for job in jobs]

    def load_out(path):
        if not os.path.exists(path):
            return None
        with open(path, "rb") as fh:
            return json.load(fh)

    base = {"ntoa": ntoa, "lanes": lanes, "maxiter": maxiter,
            "method": method, "structure": structure,
            "n_requests": n_requests, "seed": seed, "device": device}

    # -- reference legs: fault-free, the first warms the shared tier -
    t0 = obs_clock.now()
    ref_out = os.path.join(workdir, "ref.json")
    jobs = [(dict(base, mode="serve", tag="ref",
                  durable_dir=os.path.join(workdir, "ref"),
                  excache_dir=shared_excache, out=ref_out), None)]
    aref_out = os.path.join(workdir, "append-ref.json")
    if "append_delta_write" in sites:
        # the streaming-lane digests; it runs no fit, so it neither
        # reads nor writes the shared tier's entry
        jobs.append((dict(base, mode="serve", tag="append-ref",
                          append_stream=True,
                          durable_dir=os.path.join(workdir, "append-ref"),
                          excache_dir=os.path.join(workdir,
                                                   "excache-append"),
                          store_dir=os.path.join(workdir,
                                                 "append-store-ref"),
                          out=aref_out), None))
    legs = run_all(jobs, True)
    ref_rc, ref_err, ref_wall = legs[0]
    ref = load_out(ref_out)
    report = {"sites": {}, "n_sites": len(sites),
              "n_requests": n_requests, "ntoa": ntoa, "lanes": lanes,
              "workdir": workdir, "reference_wall_s": ref_wall,
              "reference_ok": bool(ref_rc == 0 and ref is not None)}
    if not report["reference_ok"]:
        report.update(ok=False, reference_rc=ref_rc,
                      reference_stderr=ref_err)
        return report
    ref_digests = ref["digests"]
    append_ref = None
    if "append_delta_write" in sites:
        aref_rc, aref_err, _ = legs[1]
        append_ref = load_out(aref_out)
        report["append_reference_ok"] = bool(aref_rc == 0
                                             and append_ref is not None)
        if not report["append_reference_ok"]:
            report["append_reference_rc"] = aref_rc
            report["append_reference_stderr"] = aref_err

    # -- kill legs ---------------------------------------------------
    plans = {}
    for site in sites:
        ddir = os.path.join(workdir, f"kill-{site}")
        # excache_store kills mid-store, so it needs a cold private
        # tier (a warm shared tier never stores); after=1 elsewhere
        # lets the first flush commit so the kill strands real
        # committed-vs-pending mixtures
        if site == "excache_store":
            exdir = os.path.join(workdir, "excache-store-private")
            spec = f"process_kill:at={site},after=0"
        elif site == "store_write":
            # store_write kills just before the pack-store's atomic
            # publish during bring-up: a cold private store so the
            # put actually fires, but the warm shared tier so the
            # standard no-recapture/ratio criteria still apply
            exdir = shared_excache
            spec = f"process_kill:at={site},after=0"
        else:
            exdir = shared_excache
            spec = f"process_kill:at={site},after=1"
        if site == "store_write":
            sdir = os.path.join(workdir, "store-private")
        elif site == "append_delta_write":
            # kill and recover legs share the delta store: the
            # committed chain prefix the dead writer left IS the
            # artifact under test
            sdir = os.path.join(workdir, "append-store")
        else:
            sdir = None
        extra = ({"append_stream": True}
                 if site == "append_delta_write" else {})
        if site == "append_delta_write" and append_ref is None:
            report["sites"][site] = {"ok": False,
                                     "reason": "append_ref_missing"}
            continue
        kill_cfg = dict(base, mode="serve", tag=f"kill-{site}",
                        site=site, durable_dir=ddir, excache_dir=exdir,
                        store_dir=sdir,
                        out=os.path.join(workdir, f"kill-{site}.json"),
                        **extra)
        rec_cfg = dict(base, mode="recover", tag=f"recover-{site}",
                       site=site, durable_dir=ddir, excache_dir=exdir,
                       store_dir=sdir,
                       out=os.path.join(workdir, f"recover-{site}.json"),
                       **extra)
        plans[site] = (kill_cfg, spec, rec_cfg)
    kills = dict(zip(plans, run_all(
        [(cfg, spec) for cfg, spec, _ in plans.values()], True)))
    recs = dict(zip(plans, run_all(
        [(cfg, None) for _, _, cfg in plans.values()],
        ratio_bound == float("inf"))))

    totals = {"lost": 0, "duplicated": 0, "replayed": 0,
              "digest_mismatches": 0}
    ratios, colds, warms = [], [], []
    for site, (_, _, rec_cfg) in plans.items():
        kill_rc, _, kill_wall = kills[site]
        rec_rc, rec_err, rec_wall = recs[site]
        rec = load_out(rec_cfg["out"])
        entry = {"kill_rc": kill_rc, "recover_rc": rec_rc,
                 "killed": kill_rc == -9,
                 "kill_wall_s": round(kill_wall, 3),
                 "recover_wall_s": round(rec_wall, 3)}
        if rec is None:
            entry.update(ok=False, recover_stderr=rec_err)
            report["sites"][site] = entry
            continue
        digest_truth = (append_ref["digests"]
                        if site == "append_delta_write" else ref_digests)
        mismatches = [
            rid for rid, c in rec["committed"].items()
            if c["status"] == "ok"
            and c["digest"] != digest_truth.get(rid)]
        # every probe fits the reference stream's (identical) request
        probes_match = bool(rec["probe_digests"]) and set(
            rec["probe_digests"]) <= set(ref_digests.values())
        warm_cache = site != "excache_store"
        store_ok = True
        if site == "store_write":
            srep = rec.get("store") or {}
            scan = srep.get("scan") or {}
            cnt = srep.get("counters") or {}
            entry["store_scan"] = scan
            entry["store_counters"] = cnt
            # torn-artifact contract: the killed writer left nothing
            # behind (the recover leg's store consult was a clean
            # miss, not a corrupt-CRC hit), the rebuild re-put the
            # entry, and the published artifact verifies end to end
            store_ok = bool(scan.get("corrupt_or_stale") == 0
                            and scan.get("valid", 0) >= 1
                            and cnt.get("corrupt") == 0
                            and cnt.get("puts", 0) >= 1)
            entry["store_ok"] = store_ok
        if site == "append_delta_write":
            drep = rec.get("deltas") or {}
            dscan = drep.get("scan") or {}
            dcnt = drep.get("counters") or {}
            entry["delta_scan"] = dscan
            entry["streaming_counters"] = dcnt
            # torn-delta contract: the kill inside the second delta
            # write left no corrupt/stale segment behind; the chain
            # after recovery holds the committed prefix PLUS the
            # replayed append (>= 2 valid segments), and registration
            # demonstrably replayed the committed prefix rather than
            # re-deriving it
            store_ok = store_ok and bool(
                dscan.get("corrupt_or_stale") == 0
                and dscan.get("valid", 0) >= 2
                and dcnt.get("replayed", 0) >= 1)
            entry["delta_ok"] = store_ok
        ratio = rec["cold_first_result_s"] / max(rec["warm_refit_s"],
                                                 1e-9)
        entry.update(
            lost=len(rec["lost"]), duplicated=len(rec["duplicated"]),
            replayed=rec["n_replayed"],
            committed_before_kill=rec["n_committed_before"],
            digest_mismatches=len(mismatches),
            torn_truncated=rec["torn_truncated"],
            cold_first_result_s=round(rec["cold_first_result_s"], 4),
            bringup_s=round(rec["bringup_s"], 4),
            warm_refit_s=round(rec["warm_refit_s"], 4),
            cold_vs_warm_ratio=round(ratio, 3),
            recompiles=rec["compiles"],
            cold_probe_ok=rec["cold_probe_ok"],
            warm_probes_ok=rec.get("warm_probes_ok"),
            probes_match_reference=probes_match,
            reqlife_nonterminal=rec.get("reqlife_nonterminal"),
            disk=(rec.get("cache") or {}).get("disk"),
        )
        entry["ok"] = bool(
            entry["killed"] and rec_rc == 0
            and entry["lost"] == 0 and entry["duplicated"] == 0
            and entry["digest_mismatches"] == 0
            and rec["cold_probe_ok"]
            and rec.get("warm_probes_ok", False) and probes_match
            # None = ledger disabled in the child env; 0 = the
            # recovered machine reached a terminal state everywhere
            and rec.get("reqlife_nonterminal") in (0, None)
            # a warm shared tier must serve the restart without a
            # single capture on the request path AND inside the
            # cold-start bound; the cold-tier site must instead
            # capture (its store died)
            and ((entry["recompiles"] == 0 and ratio <= ratio_bound)
                 if warm_cache else entry["recompiles"] >= 1)
            and store_ok)
        totals["lost"] += entry["lost"]
        totals["duplicated"] += entry["duplicated"]
        totals["replayed"] += entry["replayed"]
        totals["digest_mismatches"] += entry["digest_mismatches"]
        if warm_cache:
            ratios.append(ratio)
            colds.append(rec["cold_first_result_s"])
            warms.append(rec["warm_refit_s"])
        report["sites"][site] = entry

    report.update(totals)
    report["cold_start_recovered_s"] = (round(max(colds), 4)
                                        if colds else None)
    report["warm_refit_s"] = round(min(warms), 4) if warms else None
    report["cold_vs_warm_ratio"] = (round(max(ratios), 3)
                                    if ratios else None)
    report["wall_s"] = round(obs_clock.now() - t0, 1)
    report["ok"] = bool(report["sites"]
                        and all(e.get("ok")
                                for e in report["sites"].values()))
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
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="enable obs tracing for the run and export "
                        "the span timeline as Chrome trace-event "
                        "JSON (chrome://tracing / Perfetto)")
    p.add_argument("--tail-out", default=None, metavar="PATH",
                   help="write the run's tail artifact (p99 "
                        "exemplars + lifecycle records) as JSON for "
                        "`python -m pint_tpu_torch.obs tail`")
    p.add_argument("--arrival-sweep", action="store_true",
                   help="run the open-loop saturation bench (seeded "
                        "Poisson arrivals through a ladder of "
                        "offered rates, p99-vs-throughput knee) "
                        "instead of the plain serve bench")
    p.add_argument("--n-per-rate", type=int, default=96,
                   help="arrival-sweep: requests per ladder rung")
    p.add_argument("--producers", type=int, default=4,
                   help="arrival-sweep: concurrent submitter threads "
                        "partitioning each rung's shared schedule")
    p.add_argument("--max-queue", type=int, default=None,
                   help="arrival-sweep: intake bound (default: "
                        "max(4*max_batch, n_per_rate//2))")
    p.add_argument("--knee-factor", type=float, default=3.0,
                   help="arrival-sweep: p99 degradation factor vs "
                        "the unloaded rung that marks the knee")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="where the engine runs (default: the card)")
    p.add_argument("--chaos", action="store_true",
                   help="run the chaos acceptance stream (low-rate "
                        "fault injection vs a fault-free reference) "
                        "instead of the plain serve bench")
    p.add_argument("--fault-rate", type=float, default=0.05)
    p.add_argument("--fault-point", default="toa_nan",
                   help="request-level point for the chaos stream, or "
                        "process_kill for the SIGKILL/restart "
                        "crash-recovery acceptance")
    p.add_argument("--kill-sites", default=None,
                   help="process_kill only: comma-separated subset of "
                        "the kill sites (default: all of them)")
    p.add_argument("--chaos-child", default=None, metavar="CONFIG",
                   help=argparse.SUPPRESS)  # internal harness entry
    p.add_argument("--devices", type=int, default=None,
                   help="device chaos: lane count, cycling over the "
                        "devices of --device (default: every device, at "
                        "least 2)")
    args = p.parse_args(argv)

    if args.chaos_child:
        with open(args.chaos_child, "rb") as fh:
            return _run_chaos_child(json.load(fh))
    if args.trace_out:
        from pint_tpu_torch import obs
        obs.enable()

    def _finish(rc):
        # export whatever the run traced (serve flush/pack/compile
        # spans, retry attempts) before exiting
        if args.trace_out:
            from pint_tpu_torch import obs
            from pint_tpu_torch.obs.export import write_chrome_trace

            write_chrome_trace(args.trace_out)
            obs.disable()
            print(f"trace written to {args.trace_out}",
                  file=sys.stderr)
        return rc

    if args.arrival_sweep:
        report = run_arrival_sweep(
            n_per_rate=args.n_per_rate, max_batch=args.max_batch,
            max_queue=args.max_queue,
            bucket_floor=args.bucket_floor, maxiter=args.maxiter,
            precision=args.precision, knee_factor=args.knee_factor,
            seed=args.seed, producers=args.producers, device=args.device)
        print(json.dumps(report, default=float))
        ok = (report["monotone_offered"]
              and report["knee_rps"] is not None
              and report["p99_at_knee_s"] is not None
              and report["shed_onset_rps"] is not None)
        if not ok:
            print("FAIL: saturation sweep found no knee/shed onset "
                  f"(null_reasons={report['null_reasons']})",
                  file=sys.stderr)
        return _finish(0 if ok else 1)

    if args.chaos:
        from pint_tpu_torch.resilience import DEVICE_POINTS

        if args.fault_point == "process_kill":
            sites = (args.kill_sites.split(",") if args.kill_sites
                     else None)
            # the generic --maxiter default (3) is sized for the
            # latency stages; the kill fixture keeps its own heavier
            # default, so it is deliberately not passed through here
            report = run_kill_chaos(sites=sites,
                                    lanes=min(args.max_batch, 4),
                                    device=args.device)
            print(json.dumps(report, default=float))
            if not report["ok"]:
                print("FAIL: crash-recovery contract violated "
                      f"(lost={report.get('lost')}, "
                      f"duplicated={report.get('duplicated')}, "
                      f"digest_mismatches="
                      f"{report.get('digest_mismatches')}, "
                      f"cold_vs_warm_ratio="
                      f"{report.get('cold_vs_warm_ratio')})",
                      file=sys.stderr)
            return _finish(0 if report["ok"] else 1)
        if args.fault_point in DEVICE_POINTS:
            report = run_device_chaos(
                n_requests=args.requests,
                fault_point=args.fault_point,
                n_devices=args.devices, max_batch=args.max_batch,
                max_latency_s=args.max_latency,
                bucket_floor=args.bucket_floor, maxiter=args.maxiter,
                precision=args.precision, device=args.device)
            print(json.dumps(report, default=float))
            if not report["ok"]:
                print("FAIL: device-chaos contract violated "
                      f"(serve_failures={report['serve_failures']}, "
                      f"fleet_rel="
                      f"{report['fleet_max_rel_diff_vs_healthy']})",
                      file=sys.stderr)
            return _finish(0 if report["ok"] else 1)
        report = run_chaos_stream(
            n_requests=args.requests, fault_rate=args.fault_rate,
            fault_point=args.fault_point, max_batch=args.max_batch,
            max_latency_s=args.max_latency,
            bucket_floor=args.bucket_floor, maxiter=args.maxiter,
            precision=args.precision, seed=args.seed, device=args.device)
        print(json.dumps(report, default=float))
        if not report["ok"]:
            print(f"FAIL: chaos contract violated "
                  f"(healthy_failures={report['healthy_failures']}, "
                  f"health={report['health_state']}, "
                  f"unexpected_recompiles="
                  f"{report['unexpected_recompiles']})",
                  file=sys.stderr)
        return _finish(0 if report["ok"] else 1)

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
    return _finish(0 if ok else 1)


if __name__ == "__main__":
    sys.exit(main())
