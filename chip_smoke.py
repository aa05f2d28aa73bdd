#!/usr/bin/env python3
"""Chip smoke test of pint_tpu_torch, the PyTorch/CUDA port, on one card.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It drives the port's main path — the noise-marginalised GLS refit of a
68-pulsar timing array (~670k TOAs, NANOGrav-15yr-like ragged counts)
through ``PTAFleet(toa_bucket="plan").fit(method="gls", maxiter=2,
precision="mixed")`` — then the GW detection stage on the fitted fleet,
and checks both, in these phases:

1. build the hand-written CUDA kernels from ``pint_tpu_torch/csrc``
   (``gram.cu`` and ``paircorr.cu``, one nvcc each, started together);
2. host prep: 68 pulsars of zero-residual geocentric TOAs (the bench
   par template: EFAC/EQUAD/ECORR, power-law red noise with 30
   harmonics, 4 TOAs per epoch at 800/1400 MHz), then the fleet's host
   pack, both timed;
3. an f64 fit at the true parameters gives each pulsar's sigma; every
   start vector is then moved 3 sigma off the truth;
4. the main path: the mixed-precision fit, cold then warm, with the
   kernels' launch counts set to 0 just before the cold fit and read
   just after; then the f64 fit from the same start. Checks: both
   kernels launched, no refinement failure (max relres <= 1e-8, no f64
   refit taken), |x_mixed - x_f64| <= 1e-6 sigma, |x_fit - x_true| <=
   0.01 sigma for all 68 pulsars, finite chi2;
5. the kernel phase: each GLS kernel on the inputs the main path gave
   it (recorded in one more mixed fit), held against its plain f32
   version (max |G_kernel - G_plain| <= 1e-5 max|G| over the entries the
   fit reads) and against the f64 plain version; CUDA-event times of
   the kernel, the plain version and one ``torch.bmm`` in f32 (TF32
   off) as the library yardstick, beside the least time the card could
   take;
6. ``[gw] fleet``: the GW stage on the main path's fleet at its warm
   mixed-fit vectors: assemble and regrid at 30 days (timed), then the
   optimal statistic with the pair products in mixed (the K3 kernel;
   its count set to 0 just before and read just after) and in f64.
   Checks: K3 launched in mixed and not in f64, 2,278 pairs, finite
   amp2 / snr / sigma_amp2, |snr_mixed - snr_f64| <= 1e-3 and
   |amp2_mixed - amp2_f64| <= 1e-3 sigma_amp2. The main path's TOAs are
   zero-residual, so this S/N checks the plumbing at full scale and is
   not a science number;
7. ``[gw] injected``: bench.py's fixture (68 pulsars x 128 cells, an
   HD background of amplitude 0.5, seed 0) in mixed: the amplitude is
   recovered within a factor 2, HD S/N > 5 and beats the monopole and
   dipole templates, and a 100-draw sky-scramble null runs;
8. ``[gw] sweep``: the pair sweep at 3,000 pulsars x 512 cells in
   256-pulsar tiles (78 K3 launches per mixed sweep) with a no-op fold,
   warm, best of 3, in mixed and f64, then once through the HD optimal
   statistic's host fold;
9. ``[kernel] pair_products``: K3 at the fleet's shape, at one 256 x 256
   x 512 sweep tile and at the whole 3000 x 3000 x 512 product, held
   against its plain f32 version (1e-5 of max|.| of each product) and
   timed beside the plain version, two ``torch.matmul`` calls in f32
   and the bound.

It prints the card's name and power limit, a ``{"kernels": [...]}``
line, and as its last line ``{"ok": true, "device": {...}}``. Any
failed check exits non-zero without that line; so does a machine with
no CUDA card, or a directory without the rest of the repository.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): HBM
# bandwidth and f32 FMA rate outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
TOL_KERNEL = 1e-5  # kernel vs plain f32, relative to max|G|
TOL_RELRES = 1e-8  # refinement contraction (fitter.relres_failed)
TOL_MIXED = 1e-6  # |x_mixed - x_f64| / sigma
TOL_RECOVER = 0.01  # |x_fit - x_true| / sigma
START_OFFSET_SIGMA = 3.0
TOL_GW_SNR = 1e-3  # |snr_mixed - snr_f64| on the fleet, S/N units
TOL_GW_AMP2 = 1e-3  # |amp2_mixed - amp2_f64| / sigma_amp2 on the fleet
GW_LATTICE_DAYS = 30.0  # PTAFleet.gw_stage's default lattice
SWEEP_PSR, SWEEP_CELLS, SWEEP_BLOCK = 3000, 512, 256
INJ_PSR, INJ_CELLS, INJ_AMP, INJ_DRAWS = 68, 128, 0.5, 100


def log(msg):
    print(msg, flush=True)


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"


def ragged_counts(n_psr=68, total=670_000, seed=7):
    """NANOGrav-15yr-like ragged TOA counts: lognormal spread over
    ~600..30000, scaled to the target total (bench.py's
    ``_ragged_counts``)."""
    rng = np.random.default_rng(seed)
    c = rng.lognormal(np.log(8000.0), 0.9, n_psr)
    for _ in range(3):
        c = np.clip(c * (total / c.sum()), 600, 30000)
    return np.sort(c.astype(int))[::-1]


def par_text(i):
    """bench.py's par template (build_batch, with noise)."""
    return (f"PSR BEN{i}\nRAJ {i % 24}:{(7 * i) % 60:02d}:00.0\n"
            f"DECJ {(i * 3) % 60 - 30}:30:00.0\n"
            f"F0 {150 + 5 * (i % 40)}.318 1\nF1 -{2 + i % 7}e-16 1\n"
            f"PEPOCH 55500\nDM {8 + i}.21 1\n"
            "EFAC -f L-wide 1.1\nEQUAD -f L-wide 0.4\n"
            "ECORR -f L-wide 0.8\n"
            "RNAMP 1e-14\nRNIDX -3.1\nTNREDC 30\n")


def build_pta(counts, device, seed=0, iterations=2):
    """Models and zero-residual TOAs: epochs uniform over MJD
    54000-57000, 4 TOAs per epoch 0.5 s apart, 1 us errors,
    alternating 800/1400 MHz, all flagged -f L-wide."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.simulation import make_fake_toas_fromMJDs

    rng = np.random.default_rng(seed)
    models, toas = [], []
    for i, n in enumerate(counts):
        m = get_model(par_text(i))
        days = np.sort(rng.uniform(54000, 57000, max(1, int(n) // 4)))
        mjds = (days[:, None] + np.arange(4) * 0.5 / 86400.0).reshape(-1)
        freqs = np.where(np.arange(len(mjds)) % 2, 1400.0, 800.0)
        toas.append(make_fake_toas_fromMJDs(
            mjds, m, error_us=1.0, freq_mhz=freqs, flags={"f": "L-wide"},
            iterations=iterations, device=device))
        models.append(m)
    return models, toas


def truth_vectors(fleet, models):
    """Each pulsar's true free-parameter vector, in fit order."""
    return np.array([[getattr(m, name).value for name, _, _ in
                      fleet.batches[next(iter(fleet.batches))].free_map()]
                     for m in models], dtype=np.float64)


def set_start(fleet, x):
    for key, idxs in fleet.group_indices.items():
        fleet.batches[key].set_start_vector(x[idxs])


def timed_fit(fleet, torch, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as wl:
        warnings.simplefilter("always")
        xs, chi2, covs = fleet.fit(method="gls", maxiter=2, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    refit = any("refitting in f64" in str(w.message) for w in wl)
    return np.array(xs), np.asarray(chi2), covs, wall, refit


def cuda_ms(torch, fn, reps=20, warmup=3):
    """Mean time of fn() in ms by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def kernel_record(torch, name, replaces, kern, plain, inp, block, whiten,
                  launches):
    """Hold one kernel against its plain versions on ``inp`` and time
    all three; returns the JSON entry (raises on disagreement)."""
    n, ka = inp.shape
    nb = n // block
    out = kern(inp, block)
    torch.cuda.synchronize()
    ref32 = plain(inp, block)
    ref64 = plain(inp.double(), block)
    used = ka - 1 if whiten else ka  # the winv row/column is never read
    d32 = (out - ref32)[:, :used, :used].abs().max().item()
    scale = ref32[:, :used, :used].abs().max().item()
    d64 = (out.double() - ref64)[:, :used, :used].abs().max().item()
    rel32, rel64 = d32 / scale, d64 / ref64[:, :used, :used].abs().max().item()
    log(f"[kernel] {name}: in ({n}, {ka}) f32, block {block} -> out "
        f"({nb}, {ka}, {ka}); vs plain f32 max|d| {d32:.3e} "
        f"({rel32:.3e} of max|G|), vs plain f64 {rel64:.3e} of max|G|")
    if not rel32 <= TOL_KERNEL:
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"{rel32:.3e} > {TOL_KERNEL}")
    if whiten:
        xb = (inp * inp[:, -1:]).reshape(nb, block, ka)
    else:
        xb = inp.reshape(nb, block, ka)
    ms = cuda_ms(torch, lambda: kern(inp, block))
    plain_ms = cuda_ms(torch, lambda: plain(inp, block))
    library_ms = cuda_ms(torch, lambda: torch.bmm(xb.mT, xb))
    nbytes = 4.0 * (n * ka + nb * ka * ka)
    flops = n * ka * (ka + 1) + (n * ka if whiten else 0)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_F32_FLOP_S * 1e3
    log(f"[kernel] {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"torch.bmm {library_ms:.4f} ms, bound {max(t_bytes, t_ops):.4f} ms "
        f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP)")
    return {"name": name, "route": "cuda",
            "source": "pint_tpu_torch/csrc/gram.cu", "replaces": replaces,
            "launches": int(launches), "max_abs_err": d32, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


def profile_fit(fleet, torch, top=10):
    """Where the warm mixed fit's time goes: one fit under
    torch.profiler; prints the device-busy share of the host wall and
    the ops with the most device time. Diagnostic only: prints "not
    measured" when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fleet.fit(method="gls", maxiter=2, precision="mixed")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events()
              if e.device_type.name == "CUDA" and e.device_time_total > 0]
    if not events:
        log(f"[profile] warm mixed fit {wall:.3f} s under the profiler; "
            "device time not measured (no CUDA events recorded)")
        return
    # busy time = union of kernel intervals on the device timeline
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, -1.0
    for s, e in spans:
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    busy_s = busy * 1e-6
    log(f"[profile] warm mixed fit {wall:.3f} s under the profiler: device "
        f"busy {busy_s:.3f} s ({100 * busy_s / wall:.1f}%), idle "
        f"{100 * (1 - busy_s / wall):.1f}%; {len(events)} device ops")
    by_name = {}
    for e in events:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.device_time_total * 1e-3)
    for name, (n, ms) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        log(f"[profile]   {ms:9.3f} ms  {n:5d}x  {name[:90]}")


def capture_inputs(fleet, torch):
    """One more mixed fit that records the first input each kernel
    wrapper receives (the main path's real tensors)."""
    from pint_tpu_torch.kernels import fusedgls, seggram

    seen = {}
    orig = (fusedgls.fused_block_gls_f32, seggram.block_grams_f32)

    def rec(key, fn):
        def wrapper(x, block):
            seen.setdefault(key, (x.to(torch.float32).contiguous().clone(),
                                  block))
            return fn(x, block)
        return wrapper

    fusedgls.fused_block_gls_f32 = rec("K1", orig[0])
    seggram.block_grams_f32 = rec("K2", orig[1])
    try:
        fleet.fit(method="gls", maxiter=2, precision="mixed")
    finally:
        fusedgls.fused_block_gls_f32, seggram.block_grams_f32 = orig
    return seen


def check(phase, checks):
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{phase} checks failed: {failed}")


def gw_fleet(fleet, xs):
    """The GW stage on the fitted main-path fleet: assemble, regrid, and
    the optimal statistic in mixed (K3 counted) and in f64. Returns the
    lattice and K3's launches in the mixed run."""
    from pint_tpu_torch import gw
    from pint_tpu_torch.kernels.paircorr import pair_products_cuda

    t0 = time.perf_counter()
    inputs = gw.assemble(fleet, xs)
    asm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lat = gw.regrid(inputs, lattice_days=GW_LATTICE_DAYS)
    regrid_s = time.perf_counter() - t0
    runs = {}
    for precision in ("mixed", "f64"):
        pair_products_cuda.launches = 0
        t0 = time.perf_counter()
        out = gw.optimal_statistic(lat, precision=precision)
        runs[precision] = (out, pair_products_cuda.launches,
                           time.perf_counter() - t0)
    (om, k3_mixed, _), (o64, k3_f64, _) = runs["mixed"], runs["f64"]
    log(f"[gw] fleet: P {lat.n_pulsars}, M {lat.n_cells} cells of "
        f"{GW_LATTICE_DAYS:g} d, pairs kept {om['n_pairs']} of "
        f"{om['sweep']['n_pairs']}; assemble {asm_s:.3f} s, regrid "
        f"{regrid_s:.3f} s (host clock)")
    for name, (o, k3, wall) in runs.items():
        s = o["sweep"]
        log(f"[gw] fleet {name}: optimal statistic {wall:.4f} s, sweep "
            f"{s['wall_s']:.4f} s ({s['pairs_per_s']:.0f} pairs/s), K3 "
            f"launches {k3}; amp2 {o['amp2']!r}, sigma_amp2 "
            f"{o['sigma_amp2']!r}, snr {o['snr']!r}")
    log("[gw] fleet: the main path's TOAs are zero-residual, so this S/N "
        "checks the plumbing at full scale; it is not a science number")
    finite = all(o[k] is not None and np.isfinite(o[k])
                 for o in (om, o64) for k in ("amp2", "snr", "sigma_amp2"))
    check("[gw] fleet", {
        "K3 launched in the mixed run": k3_mixed > 0,
        "K3 not launched in the f64 run": k3_f64 == 0,
        "2278 pairs swept": om["sweep"]["n_pairs"] == 2278,
        "finite amp2 / snr / sigma_amp2": finite,
        "|snr_mixed - snr_f64| <= 1e-3":
            finite and abs(om["snr"] - o64["snr"]) <= TOL_GW_SNR,
        "|amp2_mixed - amp2_f64| <= 1e-3 sigma_amp2":
            finite and abs(om["amp2"] - o64["amp2"])
            <= TOL_GW_AMP2 * o64["sigma_amp2"],
    })
    return lat, k3_mixed


def gw_injected():
    """bench.py's injected-GWB fixture through the mixed sweep."""
    from pint_tpu_torch import gw

    lat = gw.inject_gwb(gw.isotropic_positions(INJ_PSR, seed=0), INJ_CELLS,
                        INJ_AMP, seed=0)
    t0 = time.perf_counter()
    os_ = {orf: gw.optimal_statistic(lat, orf=orf, precision="mixed")
           for orf in ("hd", "monopole", "dipole")}
    t1 = time.perf_counter()
    null = gw.scramble_null(lat, n_draws=INJ_DRAWS, seed=0, mode="sky",
                            precision="mixed", snr_obs=os_["hd"]["snr"])
    t2 = time.perf_counter()
    hd = os_["hd"]
    ratio = (float(np.sqrt(hd["amp2"]) / INJ_AMP)
             if hd["amp2"] is not None and hd["amp2"] > 0 else float("nan"))
    log(f"[gw] injected: {INJ_PSR} pulsars x {INJ_CELLS} cells, amplitude "
        f"{INJ_AMP}: sqrt(amp2)/A {ratio:.4f}, S/N hd {hd['snr']:.3f} "
        f"monopole {os_['monopole']['snr']:.3f} dipole "
        f"{os_['dipole']['snr']:.3f} ({t1 - t0:.3f} s for the three); "
        f"{INJ_DRAWS}-draw sky-scramble null p = {null['p_value']!r} "
        f"(max |S/N| {np.max(np.abs(null['snr_null'])):.3f}, "
        f"{t2 - t1:.3f} s)")
    check("[gw] injected", {
        "0.5 < sqrt(amp2)/A < 2": 0.5 < ratio < 2.0,
        "HD S/N > 5": hd["snr"] > 5.0,
        "HD S/N beats monopole and dipole":
            hd["snr"] > abs(os_["monopole"]["snr"])
            and hd["snr"] > abs(os_["dipole"]["snr"]),
        "null ran its draws": null["n_draws"] == INJ_DRAWS
            and null["p_value"] is not None,
    })


def gw_sweep():
    """The 3,000-pulsar pair sweep with a no-op fold, warm, best of 3,
    in mixed and f64. Returns the lattice and K3's launches per mixed
    sweep."""
    from pint_tpu_torch import gw
    from pint_tpu_torch.kernels.paircorr import pair_products_cuda

    t0 = time.perf_counter()
    lat = gw.inject_gwb(gw.isotropic_positions(SWEEP_PSR, seed=1),
                        SWEEP_CELLS, 0.0, seed=1)
    log(f"[gw] sweep: {SWEEP_PSR} pulsars x {SWEEP_CELLS} cells made in "
        f"{time.perf_counter() - t0:.2f} s (host)")
    launches = {}
    for precision in ("mixed", "f64"):
        gw.correlation_sweep(lat.z, lat.w, lambda *a: None,
                             block=SWEEP_BLOCK, precision=precision)
        walls = []
        for _ in range(3):
            pair_products_cuda.launches = 0
            s = gw.correlation_sweep(lat.z, lat.w, lambda *a: None,
                                     block=SWEEP_BLOCK, precision=precision)
            walls.append(s["wall_s"])
            launches[precision] = pair_products_cuda.launches
        best = min(walls)
        log(f"[gw] sweep {precision}: {s['n_pairs']} pairs in "
            f"{s['n_blocks']} tiles of {SWEEP_BLOCK}; best of 3 {best:.4f} s "
            f"({s['n_pairs'] / best:.0f} pairs/s), runs "
            f"{', '.join(f'{w:.4f}' for w in walls)} s; K3 launches per "
            f"sweep {launches[precision]}")
        # the same sweep through the HD optimal statistic's host fold
        # (hd_curve on every pair): how much of a real sweep the fold is
        hd = gw.optimal_statistic(lat, precision=precision,
                                  block=SWEEP_BLOCK)["sweep"]["wall_s"]
        log(f"[gw] sweep {precision}: with the HD optimal-statistic fold "
            f"{hd:.4f} s ({hd - best:.4f} s, {100 * (hd - best) / hd:.1f}% "
            f"of it, beyond the no-op sweep)")
    n_tiles = s["n_blocks"]
    check("[gw] sweep", {
        "K3 launched once per tile in mixed": launches["mixed"] == n_tiles,
        "K3 not launched in f64": launches["f64"] == 0,
    })
    return lat, launches["mixed"]


def pair_record(torch, fleet_lat, sweep_lat, launches, sweep_launches):
    """K3 against its plain f32 version (and the f64 reference) at the
    fleet's shape, one 256 x 256 sweep tile and the whole 3000 x 3000
    product; CUDA-event times of each. Returns the JSON entry, at the
    whole shape, with the other two shapes as fields."""
    from pint_tpu_torch.kernels.paircorr import (pair_products_cuda,
                                                 pair_products_plain,
                                                 pair_products_ref)

    def upload(lat, dtype):
        u = torch.as_tensor(lat.w * lat.z, device="cuda").to(dtype)
        return u, torch.as_tensor(lat.w, device="cuda").to(dtype)

    fu, fw = upload(fleet_lat, torch.float32)
    fu64, fw64 = upload(fleet_lat, torch.float64)
    su, sw = upload(sweep_lat, torch.float32)
    su64, sw64 = upload(sweep_lat, torch.float64)
    a, b = slice(0, SWEEP_BLOCK), slice(SWEEP_BLOCK, 2 * SWEEP_BLOCK)
    shapes = {
        "fleet": ((fu, fw, fu, fw), (fu64, fw64, fu64, fw64)),
        "tile": ((su[a], sw[a], su[b], sw[b]),
                 (su64[a], sw64[a], su64[b], sw64[b])),
        "whole": ((su, sw, su, sw), (su64, sw64, su64, sw64)),
    }
    rec = {}
    for label, (ins, ins64) in shapes.items():
        ins = tuple(t.contiguous() for t in ins)
        out = pair_products_cuda(*ins)
        torch.cuda.synchronize()
        ref32 = pair_products_plain(*ins)
        ref64 = pair_products_ref(*ins64)
        d32, rel32, rel64 = [], [], []
        for o, r32, r64 in zip(out, ref32, ref64):
            d = (o - r32).abs().max().item()
            scale = r32.abs().max().item()
            d32.append(d)
            rel32.append(d / scale if scale else d)
            scale64 = r64.abs().max().item()
            d64 = (o.double() - r64).abs().max().item()
            rel64.append(d64 / scale64 if scale64 else d64)
        ba, m = ins[0].shape
        bb = ins[2].shape[0]
        ua, wa, ub, wb = ins
        ms = cuda_ms(torch, lambda: pair_products_cuda(*ins))
        plain_ms = cuda_ms(torch, lambda: pair_products_plain(*ins))
        library_ms = cuda_ms(torch, lambda: (torch.matmul(ua, ub.mT),
                                             torch.matmul(wa, wb.mT)))
        nbytes = 4.0 * (2 * (ba + bb) * m + 2 * ba * bb)
        flops = 4.0 * ba * bb * m
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        t_ops = flops / PEAK_F32_FLOP_S * 1e3
        log(f"[kernel] pair_products {label} ({ba}, {m}) x ({bb}, {m}) f32: "
            f"vs plain f32 max|d| num {d32[0]:.3e} den {d32[1]:.3e} "
            f"({rel32[0]:.3e}, {rel32[1]:.3e} of max|.|), vs f64 "
            f"{rel64[0]:.3e}, {rel64[1]:.3e} of max|.|")
        log(f"[kernel] pair_products {label}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, 2x torch.matmul {library_ms:.4f} ms, bound "
            f"{max(t_bytes, t_ops):.4f} ms ({nbytes / 1e6:.2f} MB, "
            f"{flops / 1e9:.4f} GFLOP)")
        if not max(rel32) <= TOL_KERNEL:
            raise AssertionError(f"pair_products disagrees with its plain "
                                 f"version at the {label} shape: "
                                 f"{max(rel32):.3e} > {TOL_KERNEL}")
        rec[label] = {"shape": [ba, bb, m], "max_abs_err": max(d32),
                      "max_rel_err": max(rel32), "ms": ms,
                      "plain_ms": plain_ms,
                      "bound_ms": max(t_bytes, t_ops),
                      "bound_by": "bytes" if t_bytes >= t_ops
                      else "operations", "library_ms": library_ms}
    whole = rec.pop("whole")
    return {"name": "pair_products", "route": "cuda",
            "source": "pint_tpu_torch/csrc/paircorr.cu",
            "replaces": "pint_tpu/kernels/paircorr.py:65",
            "launches": int(launches), **whole, "tile": rec["tile"],
            "fleet": rec["fleet"], "sweep_launches": int(sweep_launches)}


def run():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pint_tpu_torch.kernels import build
    from pint_tpu_torch.kernels.fusedgls import (fused_block_gls_cuda,
                                                 fused_block_gls_plain)
    from pint_tpu_torch.kernels.seggram import (block_grams_cuda,
                                                block_grams_plain)
    from pint_tpu_torch.parallel.pta import PTAFleet

    card = gpu_line()
    log(f"[card] {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; tf32 matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}")

    t0 = time.perf_counter()
    build.load_all(["gram", "paircorr"])
    log(f"[build] csrc/gram.cu and csrc/paircorr.cu built (one nvcc each, "
        f"started together) and loaded in {time.perf_counter() - t0:.2f} s")
    for name, tag in (("gram", "[build]"), ("paircorr", "[gw] build")):
        info = build.BUILD_INFO[name]
        log(f"{tag} csrc/{name}.cu: nvcc {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"{tag} {line.strip()}")

    counts = ragged_counts()
    t0 = time.perf_counter()
    models, toas = build_pta(counts, "cuda")
    host_s = time.perf_counter() - t0
    n_toa = sum(len(t) for t in toas)
    log(f"[host] {len(models)} pulsars, {n_toa} TOAs of zero-residual "
        f"geocentric TOAs in {host_s:.2f} s")
    t0 = time.perf_counter()
    fleet = PTAFleet(models, toas, toa_bucket="plan", device="cuda")
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    log(f"[host] fleet pack in {pack_s:.2f} s, padding x"
        f"{fleet.padding_ratio:.4f}, {len(fleet.batches)} buckets:")
    for key, b in fleet.batches.items():
        desc = (f"packed R={b._pack['n_rows']} S={b._pack['n_slots']} "
                f"Q={b._pack['quantum']} NE={b._pack['n_epochs']}"
                if b._pack else f"unpacked B={b.n_pulsars}")
        log(f"[host]   width {key[1][1]}: {b.n_pulsars} pulsars, "
            f"{int(np.sum(b.n_toas))} TOAs, {desc}")

    x_true = truth_vectors(fleet, models)
    xs, chi2, covs, wall, _ = timed_fit(fleet, torch, precision="f64")
    sig = np.sqrt(np.array([np.diag(c) for c in covs]))
    log(f"[fit] f64 at the truth (first fit of the process): {wall:.3f} s, "
        f"max |x - x_true|/sigma {np.max(np.abs(xs - x_true) / sig):.3e}")
    signs = np.where(np.arange(x_true.size).reshape(x_true.shape) % 2, 1, -1)
    x_start = x_true + START_OFFSET_SIGMA * sig * signs
    set_start(fleet, x_start)

    fused_block_gls_cuda.launches = 0
    block_grams_cuda.launches = 0
    xm, cm, cov_m, cold, refit_cold = timed_fit(fleet, torch,
                                                precision="mixed")
    launches = {"K1": fused_block_gls_cuda.launches,
                "K2": block_grams_cuda.launches}
    relres = max(m["relres_max"] for m in fleet.fit_metrics.values())
    refit = refit_cold or any(m["refit_f64"]
                              for m in fleet.fit_metrics.values())
    xm2, _, _, warm, refit_warm = timed_fit(fleet, torch, precision="mixed")
    warm_metrics = dict(fleet.fit_metrics)
    x64, c64, _, wall64, _ = timed_fit(fleet, torch, precision="f64")
    sig_m = np.sqrt(np.array([np.diag(c) for c in cov_m]))
    d_mixed = np.max(np.abs(xm - x64) / sig_m)
    d_true = np.max(np.abs(xm - x_true) / sig_m)
    log(f"[main] mixed cold {cold:.3f} s ({n_toa / cold:.0f} TOAs/s), warm "
        f"{warm:.3f} s ({n_toa / warm:.0f} TOAs/s); f64 {wall64:.3f} s "
        f"({n_toa / wall64:.0f} TOAs/s)")
    log(f"[main] launches in the cold mixed fit: {launches}; max relres "
        f"{relres:.3e}; f64 refit taken: {refit or refit_warm}")
    log(f"[main] max |x_mixed - x_f64|/sigma {d_mixed:.3e}; max |x_fit - "
        f"x_true|/sigma {d_true:.3e} (start {START_OFFSET_SIGMA} sigma off)")
    for key, m in warm_metrics.items():
        log(f"[main]   width {key[1][1]}: {m['fit_wall_s']:.3f} s (warm "
            f"mixed, host clock), relres {m['relres_max']:.2e}")
    checks = {
        "K1 launched on the main path": launches["K1"] > 0,
        "K2 launched on the main path": launches["K2"] > 0,
        "refinement contracted (relres <= 1e-8)": relres <= TOL_RELRES,
        "no f64 refit taken": not (refit or refit_warm),
        "mixed vs f64 <= 1e-6 sigma": d_mixed <= TOL_MIXED,
        "recovery <= 0.01 sigma": d_true <= TOL_RECOVER,
        "warm mixed fit reproduces the cold one":
            np.max(np.abs(xm2 - xm) / sig_m) <= TOL_MIXED,
        "finite chi2": bool(np.all(np.isfinite(cm)) and np.all(np.isfinite(c64))),
    }
    check("main path", checks)

    profile_fit(fleet, torch)
    seen = capture_inputs(fleet, torch)
    entries = [
        kernel_record(torch, "fused_block_gls",
                      "pint_tpu/kernels/fusedgls.py:109",
                      fused_block_gls_cuda, fused_block_gls_plain,
                      *seen["K1"], True, launches["K1"]),
        kernel_record(torch, "block_grams",
                      "pint_tpu/kernels/seggram.py:66",
                      block_grams_cuda, block_grams_plain, *seen["K2"],
                      False, launches["K2"]),
    ]

    fleet_lat, k3_launches = gw_fleet(fleet, xm2)
    gw_injected()
    sweep_lat, sweep_launches = gw_sweep()
    entries.append(pair_record(torch, fleet_lat, sweep_lat, k3_launches,
                               sweep_launches))
    log(json.dumps({"kernels": entries}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main():
    try:
        return run()
    except Exception as exc:  # noqa: BLE001 - the smoke test's boundary
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(exc).__name__}: {exc}",
              file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
