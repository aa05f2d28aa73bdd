"""The port's benchmark: one cell, one run, one JSON line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs a cell of ``BENCHMARK.json`` on the card: set-up (the
configuration's fleet from its cached TOA schedule, the seed's noise
realisation, ``PTAFleet`` with the traffic's options, ``precompile``
and warm fits), the window (the traffic's closed loop of
``PTAFleet.fit`` refits for ``--seconds``), the check against the plain
reference (``check.py``), and the report: the last line of standard
output is one JSON object with ``correct``, ``attempted``, ``failed``,
``metrics``, ``device`` (and ``breakdown`` when traced), and the numbers
compared, each with its limit, come last in it and on standard error.

``--trace 1`` turns on the port's spans as profiler ranges, profiles a
few refits of the window with torch.profiler and reports the cell's
per-layer metrics instead of its end-to-end ones.

It exits non-zero with no result when no CUDA card is present (or fewer
than the cell asks for), and when JAX, jaxlib, flax or the JAX package
pint_tpu is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
import warnings  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "pint_tpu")
# every cell: one analyst's closed loop, each refit from a start
# START_OFFSET_SIGMA sigma off the truth (random signs), sent when the
# last returns; WARM_FITS refits of set-up after the first fit (a fresh
# process on the card refits ~7% slower for its first 2-11 fits, and
# that ramp belongs in set-up, not in the window's tail); in a traced
# run PROFILE_REFITS refits profiled; the check's sample over
# CHECK_REFITS refits
START_OFFSET_SIGMA = 3.0
WARM_FITS = 16
PROFILE_REFITS = 2
CHECK_REFITS = 3


def cache_env(root=ROOT):
    """The kernel cache at a fixed path inside the checkout (the port
    builds its CUDA sources into its own ``csrc/build/``), and no JAX
    loaded by a library on the way."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, ".portbench_cache",
                                                  "triton")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules():
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def _union_s(intervals):
    from portbench.profiling import merged

    return sum(e - s for s, e in merged(intervals))


def set_start(fleet, x):
    """Start every pulsar's next fit at its vector in the list ``x``."""
    import numpy as np

    for key, idxs in fleet.group_indices.items():
        fleet.batches[key].set_start_vector(np.array([x[i] for i in idxs]))


def truth(refs, names):
    """Each pulsar's free parameters as its par file states them, in
    the port's fit order ``names``."""
    import numpy as np

    from portbench.reference.par import MASKED

    out = []
    for r, nm in zip(refs, names):
        values = dict(r.par.values)
        for kind in MASKED:
            for i, m in enumerate(r.par.mask_params(kind)):
                values[f"{kind}{i + 1}"] = m.value
        out.append(np.array([values[k] for k in nm], dtype=np.float64))
    return out


def run_cell(spec, name, seed, seconds, trace, device="cuda"):
    """One run of cell ``name``: (the result dict of the report's line,
    the rows compared [(number, value, limit)], the forbidden modules
    loaded, and the state the check read: the refits' records, the
    reference's pulsars, the parameter names and the sample)."""
    import numpy as np
    import torch

    from pint_tpu_torch.obs import trace as obs_trace
    from pint_tpu_torch.parallel.pta import PTAFleet

    from portbench import check, costs, fleet as fleet_mod

    seed = int(seed) % (1 << 64)
    cell = spec.cell(name)
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    limits = spec.limits(name)
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    rng = np.random.default_rng([seed, 1])

    if trace:
        obs_trace.enable(capacity=1 << 20, jax_annotations=True)

    # ---- set-up ----
    pars, paths, models, toas = fleet_mod.load(spec.root, config, device)
    refs = fleet_mod.reference_pulsars(pars, paths, toas)
    fleet_mod.add_noise(seed, toas, refs)
    method, maxiter = traffic["method"], int(traffic["maxiter"])
    precision = traffic["precision"]
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="no clock files")
        fleet = PTAFleet(models, toas, toa_bucket=traffic["toa_bucket"],
                         pipeline=bool(traffic["pipeline"]), device=device)
        fleet.precompile(method=method, maxiter=maxiter, precision=precision)
    names = [[k for k, _, _ in fm] for fm in fleet.free_maps()]
    x_true = truth(refs, names)
    fit_kw = dict(method=method, maxiter=maxiter, precision=precision)
    n_toas = int(sum(len(t) for t in toas))

    def start_vectors(sig):
        return [xt + START_OFFSET_SIGMA * s * rng.choice([-1.0, 1.0],
                                                         size=len(xt))
                for xt, s in zip(x_true, sig)]

    set_start(fleet, x_true)
    xs, _, covs = fleet.fit(**fit_kw)
    sig = [np.sqrt(np.diag(c)) for c in covs]
    for _ in range(WARM_FITS):
        set_start(fleet, start_vectors(sig))
        fleet.fit(**fit_kw)
    sync()
    setup_s = time.perf_counter() - T_START
    setup_end = time.perf_counter()

    # ---- window ----
    check_pulsars = sample_pulsars(refs, fleet.group_indices,
                                   np.random.default_rng([seed, 2]))
    walls, records, refits = [], [], []
    attempted = failed = 0
    n_prof = PROFILE_REFITS if trace and cuda else 0
    prof_first = 1
    profile = None
    t_w0 = time.perf_counter()

    def one_refit():
        nonlocal attempted, failed
        start = start_vectors(sig)
        set_start(fleet, start)
        attempted += 1
        t0 = time.perf_counter()
        try:
            xs, chi2, covs = fleet.fit(**fit_kw)
        except Exception:  # noqa: BLE001 - a failed refit counts, the loop goes on
            print(f"refit {attempted} raised:\n{traceback.format_exc()}",
                  file=sys.stderr)
            failed += 1
            return None
        t1 = time.perf_counter()
        x = _vectors(xs)
        chi2 = np.asarray(chi2, np.float64)
        bad = (fleet.diverged or not all(np.all(np.isfinite(v)) for v in x)
               or not np.all(np.isfinite(chi2)))
        if bad:
            failed += 1
            return None
        records.append({"start": start, "x": x, "chi2": chi2,
                        "cov": {i: np.asarray(covs[i], np.float64)
                                for i in check_pulsars}})
        return t0, t1

    while time.perf_counter() - t_w0 < seconds:
        if n_prof and len(refits) == prof_first and profile is None:
            from portbench import profiling

            spans = []

            def profiled():
                for _ in range(n_prof):
                    spans.append(one_refit())

            wall, prof = profiling.run(torch, profiled)
            done = [s for s in spans if s is not None]
            # exported and reduced once the window has closed, so that
            # the window goes on refitting meanwhile
            profile = {"wall_s": wall, "n": len(done), "prof": prof}
            refits.extend((t0, t1, True) for t0, t1 in done)
            continue
        out = one_refit()
        if out is not None:
            walls.append(out[1] - out[0])
            refits.append((out[0], out[1], False))
    t_w1 = time.perf_counter()
    window_s = (max(t1 for _, t1, _ in refits) - t_w0) if refits else (
        t_w1 - t_w0)
    memory_peak = (torch.cuda.max_memory_allocated() if cuda else 0)
    if profile is not None:
        from portbench import profiling

        profile["reduced"] = profiling.reduce(profiling.trace_events(
            profile.pop("prof"), os.path.join(spec.root, ".portbench_cache",
                                              "profile", "trace.json")))
    spans_all = obs_trace.spans() if trace else []
    if trace:
        obs_trace.disable()
    # the program's state is freed before the reference runs
    del fleet, xs, covs
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    bad_modules = forbidden_modules()

    # ---- check ----
    sample = sample_refits(len(records), check_pulsars, CHECK_REFITS,
                           np.random.default_rng([seed, 3]))
    numbers = (check.compare(records, refs, names, sample, maxiter, device)
               if sample else {})
    correct, rows = check.judge(numbers, limits)
    correct = bool(correct and failed == 0 and attempted > 0)

    # ---- metrics ----
    shapes = [(len(r.error_us), costs.pulsar_columns(r.par.values, len(nm)))
              for r, nm in zip(refs, names)]
    ctx = SimpleNamespace(
        walls=walls, completed=len(records), n_toas=n_toas,
        window_s=window_s, setup_s=setup_s, setup_end=setup_end,
        spans=spans_all, refits=refits, profile=profile,
        refit_flops=costs.refit_flops(shapes, maxiter),
        peaks=spec.peaks(), names=spec.names, union_s=_union_s)
    metrics = {}
    for m in spec.metrics(name, trace):
        value = spec.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": int(cell["chips"]), "memory_peak_bytes": int(memory_peak)}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and profile is not None and profile["reduced"] is not None:
        dev["busy_s"] = profile["reduced"]["busy_s"]
        dev["window_s"] = profile["wall_s"]
        result["breakdown"] = {
            "device_ops": profile["reduced"]["device_ops"],
            "idle_gaps": profile["reduced"]["idle_gaps"]}
    result["compared"] = {k: {"value": v, "limit": lim}
                          for k, v, lim in rows}
    state = SimpleNamespace(records=records, refs=refs, names=names,
                            sample=sample, maxiter=maxiter, numbers=numbers,
                            device=device)
    return result, rows, bad_modules, state


def _vectors(vectors):
    import numpy as np

    return [np.asarray(v, np.float64) for v in vectors]


def sample_pulsars(refs, groups, rng):
    """One pulsar of each of the fleet's buckets (``groups``: bucket ->
    pulsar indices), drawn from the seed, and always the one with the
    most TOAs."""
    import numpy as np

    sizes = np.array([len(r.error_us) for r in refs])
    pick = {int(np.argmax(sizes))}
    for key in sorted(groups, key=lambda k: min(groups[k])):
        pick.add(int(rng.choice(list(groups[key]))))
    return sorted(pick)


def sample_refits(n, pulsars, k, rng):
    """(refit, pulsar) pairs: the first and the last refit of the window
    and ``k - 2`` more drawn from the seed, each over the sampled
    pulsars."""
    if n == 0:
        return []
    chosen = {0, n - 1}
    rest = [j for j in range(1, n - 1)]
    if rest and k > 2:
        chosen |= set(map(int, rng.choice(rest, size=min(k - 2, len(rest)),
                                          replace=False)))
    return [(j, i) for j in sorted(chosen) for i in pulsars]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env()
    from portbench.spec import Spec

    spec = Spec(ROOT)
    try:
        cell = spec.cell(args.workload)
    except KeyError as exc:
        print(exc, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < int(cell["chips"])):
        print(f"no CUDA card for {args.workload} (needs {cell['chips']}, "
              f"available: {torch.cuda.device_count()})", file=sys.stderr)
        return 3
    result, rows, bad, _ = run_cell(spec, args.workload, args.seed,
                                    args.seconds, bool(args.trace))
    if bad:
        print(f"modules of JAX or the JAX package loaded: {bad}",
              file=sys.stderr)
        return 4
    for k, v, lim in rows:
        print(f"compared {k}: {v!r} (limit {lim!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
