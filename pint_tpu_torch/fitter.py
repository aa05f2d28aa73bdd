"""Fitters (torch counterpart of the JAX package's ``fitter.py``):
the solve core — column norms, whitening, the thresholded eigh and SVD
solves, the mixed-precision refinement and their per-segment forms —
and the single-pulsar fitter classes WLSFitter, DownhillWLSFitter,
GLSFitter, DownhillGLSFitter, PowellFitter and the wideband (time + DM)
WidebandTOAFitter, WidebandDownhillFitter and WidebandLMFitter, with
auto_fitter.

(reference: src/pint/fitter.py — Fitter base, WLSFitter, GLSFitter,
DownhillFitter family.) The design matrix comes from
``torch.func.jacfwd`` over the phase, the SVD and eigh solves run on
the fit's device, and the outer iteration is a host loop (few steps)
exactly like the reference's maxiter loop; each iteration brings one
chi2 scalar to the host, as the JAX package's does.

Every solve function takes optional leading batch dimensions: rows are
the second-to-last axis of a design matrix, parameters the last. What
the JAX package writes per pulsar and vmaps, the port writes once over
the batch (``A`` (..., k, k), ``b`` (..., k), ``Mn`` (..., n, k)).

The AOT helpers (``aot_lower``, ``aot_backend_compile``,
``aot_serialize``, ``aot_deserialize``) build a fleet bucket's fit
program and capture it into CUDA graphs (``graphs.py``); a capture has
no serialized form.

With ``obs.fitquality.enable()`` the GLS-family fitters record the
fit-quality probes (chi2 z-score, conditioning, residual moments) of
each fit into ``fitquality.FITQ``, as the JAX package's do; the probes
read host copies and leave the fit bitwise unchanged.
``Fitter.plot`` draws the post-fit residuals (``plot_utils.py``).
"""

from __future__ import annotations

import copy
import time
import warnings

import numpy as np
import torch

from . import autodiff, graphs
from .residuals import (Residuals, WidebandDMResiduals,
                        WidebandTOAResiduals, wideband_dm_model)
from .segment import block_segment_sum, segment_max

# eigh backward-error floor for the GLS eigenvalue threshold: a
# symmetric eigensolver perturbs eigenvalues by O(||A|| * n * eps)
# (Golub & Van Loan sec. 8.1); with n <= ~500 columns n*eps ~ 1e-13,
# and 3e-14 sits at the small-n end of that bound. Relative cuts below
# it would "keep" pure-noise eigenvalues of exactly-degenerate
# directions and inject O(1/noise) garbage into dx. Same constant as
# the JAX package.
GLS_EIG_FLOOR = 3e-14


def _mv(A, v):
    """Batched matrix-vector product A @ v over leading dims."""
    return (A @ v[..., None])[..., 0]


def _mtv(A, v):
    """Batched A^T @ v over leading dims."""
    return (A.mT @ v[..., None])[..., 0]


def column_norms(Mw):
    """Exponent-range-safe L2 column norms (..., n, k) -> (..., k):
    peak-scale each column first so the squared terms stay <= 1
    (reference analog: utils.py::normalize_designmatrix)."""
    amax = torch.amax(torch.abs(Mw), dim=-2)
    amax = torch.where(amax == 0, 1.0, amax)
    n = torch.sqrt(torch.sum(torch.square(Mw / amax[..., None, :]), dim=-2))
    return amax * torch.where(n == 0, 1.0, n)


def _eig_cut(evals, threshold):
    """Kept-eigenvalue mask and thresholded inverse (shared by the solve
    and the refinement)."""
    cut = max(threshold**2, GLS_EIG_FLOOR)
    good = evals > cut * torch.amax(evals, dim=-1, keepdim=True)
    einv = torch.where(good, 1.0 / torch.where(good, evals, 1.0), 0.0)
    return good, einv


def gls_eigh_solve(A, b, threshold=1e-12):
    """Thresholded eigendecomposition solve of normal equations
    A dxn = b: returns (dxn, covn) with degenerate directions (relative
    eigenvalue below max(threshold^2, GLS_EIG_FLOOR)) given zero update.

    ``torch.linalg.eigh`` may order or sign eigenvectors differently
    from LAPACK as called by the JAX package; dxn and covn are invariant
    to both, so they agree to rounding."""
    evals, evecs = graphs.eager(torch.linalg.eigh, A)
    _, einv = _eig_cut(evals, threshold)
    dxn = _mv(evecs, einv * _mtv(evecs, b))
    covn = (evecs * einv[..., None, :]) @ evecs.mT
    return dxn, covn


def check_precision(precision, allow_auto=False):
    """Validate the GLS precision-mode argument. ``allow_auto=True``
    also admits "auto", the per-bucket measured choice of PTABatch."""
    allowed = ("f64", "mixed", "auto") if allow_auto else ("f64", "mixed")
    if precision not in allowed:
        raise ValueError(
            f"precision must be one of {allowed}, got {precision!r}")


def aot_lower(fn, *args, trace_id=None):
    """Build a fit program, timing the build: ``fn(*args)`` returns it
    (for a batch, a function of the start vectors and the batch's device
    tensors, ``graphs.py``). Torch traces nothing, so
    ``trace_s``, the JAX package's trace time, is the build's host wall,
    inside an ``aot.trace`` span; a pool thread passes its caller's
    ``trace_id`` so the span joins the caller's trace. Returns
    {"lowered", "trace_s"}; :func:`aot_backend_compile` takes the
    "lowered" program."""
    from .obs import clock as obs_clock
    from .obs import trace as obs_trace

    with obs_trace.span("aot.trace", trace_id=trace_id):
        t0 = obs_clock.now()
        lowered = fn(*args)
        trace_s = obs_clock.now() - t0
    return {"lowered": lowered, "trace_s": trace_s}


def aot_backend_compile(lowered, x0, *data, label=None):
    """Make a built program ``lowered(x0, *data)`` ready to dispatch at
    its start vectors ``x0`` and its batch's tensors ``data``: on the
    card, warm it up on a side stream and capture it into CUDA graphs
    (``graphs.GraphProgram``; the eighs and SVDs run eagerly between
    the graphs), ``backend_compile_s`` the capture's wall; on
    the CPU nothing is captured (``backend_compile_s`` 0.0, the eager
    ``graphs.Program``). A failed capture raises. Returns the JAX
    package's dict {"compiled", "backend_compile_s", "flops",
    "bytes_accessed", "memory", "intensity_flops_per_byte",
    "roofline_ceiling_flops", "bound"} plus "captured" and "pieces"
    (the program's graphs and eager ops in order).

    The cost fields are the counts recorded on ``lowered`` when the
    program was built (``obs.costmodel.executable_cost``; None where
    none were recorded), attributed on the platform of ``x0``'s device. They
    are attached to the ``aot.backend_compile`` span and, with a
    ``label``, recorded in ``costmodel.LEDGER``, so execute-time spans
    can attribute a wall time back to the program."""
    from .obs import costmodel
    from .obs import trace as obs_trace

    with obs_trace.span("aot.backend_compile") as sp:
        if x0.device.type == "cuda":
            compiled = graphs.GraphProgram(lowered, x0, *data)
            backend_s = compiled.capture_s
        else:
            compiled, backend_s = graphs.Program(lowered), 0.0
        cost = costmodel.executable_cost(lowered)
        attr = costmodel.attribute(
            cost["flops"], cost["bytes_accessed"],
            platform=costmodel.platform_of(x0.device))
        if obs_trace.enabled():
            sp.set(flops=cost["flops"],
                   bytes_accessed=cost["bytes_accessed"],
                   intensity_flops_per_byte=attr[
                       "intensity_flops_per_byte"],
                   roofline_ceiling_flops=attr["roofline_ceiling_flops"],
                   bound=attr["bound"], captured=compiled.captured)
            if label is not None:
                sp.set(program=label)
            if cost["memory"] is not None:
                sp.set(**{"memory_" + k: v
                          for k, v in cost["memory"].items()})
    if label is not None:
        costmodel.LEDGER.record(label, cost)
    return {"compiled": compiled, "backend_compile_s": backend_s,
            "flops": cost["flops"],
            "bytes_accessed": cost["bytes_accessed"],
            "memory": cost["memory"],
            "intensity_flops_per_byte": attr["intensity_flops_per_byte"],
            "roofline_ceiling_flops": attr["roofline_ceiling_flops"],
            "bound": attr["bound"],
            "captured": compiled.captured, "pieces": compiled.layout}


def aot_serialize(compiled):
    """None: a captured CUDA graph has no serialized form. Its kernels'
    arguments are device addresses of one process's allocations and
    torch offers no way to write a graph out (the JAX package returns
    None too for anything that is not a serializable executable). The
    persisted tier (``serve/excache.py``) stores the batch and the
    ``aot_compile`` options instead and captures again in a fresh
    process."""
    return None


def aot_deserialize(doc):
    """Raises, inside an ``aot.deserialize`` span: there is no
    serialized program to rehydrate (:func:`aot_serialize` writes none).
    The JAX package's callers treat a raise as a cache miss and compile
    again."""
    from .obs import trace as obs_trace

    with obs_trace.span("aot.deserialize"):
        raise RuntimeError(
            "aot_deserialize: pint_tpu_torch programs are CUDA graphs of "
            "one process's device allocations and have no serialized "
            "form; capture the program again (PTABatch.aot_compile)")


def gls_gram(Mn, q, precision="f64"):
    """Normal-equation matrix A = Mn^T Mn + diag(q^2).

    ``precision="mixed"``: the O(n k^2) Gram product runs in float32
    (TF32 off, see the package docstring) and is promoted back to f64;
    the ~1e-6-relative Gram error is then removed by gls_eigh_refine's
    f64-residual iterations. The prior fold keeps diag(A) = 1, so the
    f32 rounding is a RELATIVE perturbation and refinement contracts
    whenever the kept spectrum spans < ~1e6.
    """
    if precision == "mixed":
        M32 = Mn.to(torch.float32)
        A = (M32.mT @ M32).to(torch.float64)
    else:
        A = Mn.mT @ Mn
    return A + torch.diag_embed(q * q)


def gls_fused_normal(Mn, z, q, precision="f64"):
    """(A, b, rNr) of the normal equations from ONE augmented Gram
    ``[Mn | z]^T [Mn | z]``. ``precision="mixed"`` keeps b and rNr
    exact (f64, O(n k)) and takes only the f32 Gram from gls_gram — an
    f32 RHS would poison the refinement fixed point."""
    k = Mn.shape[-1]
    if precision == "mixed":
        A = gls_gram(Mn, q, "mixed")
        b = _mtv(Mn, z)
        rNr = torch.sum(torch.square(z), dim=-1)
    else:
        aug = torch.cat([Mn, z[..., None]], dim=-1)
        G = aug.mT @ aug
        A = G[..., :k, :k] + torch.diag_embed(q * q)
        b = G[..., :k, k]
        rNr = G[..., k, k]
    return A, b, rNr


def relres_failed(rel_resid, tol=1e-8):
    """NaN-aware check of the refinement's convergence diagnostic:
    accept only when every entry is finite and <= tol."""
    r = np.asarray(rel_resid, dtype=np.float64)
    return not bool(np.all(r <= tol))


def gls_eigh_refine(A_approx, b, matvec, threshold=1e-12, iters=2):
    """Thresholded-eigh solve of A dxn = b where ``A_approx`` is an
    approximate (f32-accumulated) Gram and ``matvec`` applies the EXACT
    f64 normal operator. ``iters`` iterative-refinement steps recover
    f64 solution accuracy: dxn <- dxn + Ã^-1 (b - A dxn), contraction
    ||Ã^-1 (A - Ã)|| ~ κ_kept(A) * 1e-7 per step. The covariance comes
    from the approximate factorization (~1e-6 relative).

    Batched over leading dims (one system per pulsar or per packed
    segment). Returns (dxn, covn, rel_resid): rel_resid is the final
    projected relative residual ||P(b - A dxn)|| / ||P b|| — ~1e-14 when
    refinement converged, O(1) when the kept spectrum was too wide for
    an f32 preconditioner. Callers MUST check it (relres_failed) and
    fall back to precision="f64" when it exceeds ~1e-8.
    """
    evals, evecs = graphs.eager(torch.linalg.eigh, A_approx)
    good, einv = _eig_cut(evals, threshold)
    keep = good.to(b.dtype)

    def apply_inv(v):
        return _mv(evecs, einv * _mtv(evecs, v))

    def project(v):
        return _mv(evecs, keep * _mtv(evecs, v))

    dxn = apply_inv(b)
    for _ in range(iters):
        dxn = dxn + apply_inv(b - matvec(dxn))
    pb = project(b)
    pr = project(b - matvec(dxn))
    rel_resid = (torch.linalg.norm(pr, dim=-1)
                 / (torch.linalg.norm(pb, dim=-1) + 1e-300))
    covn = (evecs * einv[..., None, :]) @ evecs.mT
    return dxn, covn, rel_resid


def seg_gls_eigh_refine(A_approx, b, matvec, threshold=1e-12, iters=5):
    """gls_eigh_refine per packed segment: segments are the leading
    dimension of A (S, k, k) and b (S, k). Five steps where the JAX
    package takes two: a NANOGrav-style design (FD1/FD2, DMX windows
    and a receiver JUMP over sub-banded receivers, binary orbits) keeps
    a condition number of ~5e4 or more, so a step from the packed f32
    Gram contracts only ~1e-2. On an H100 the 68-pulsar zoo fleet's
    relres fell ~100x a step, to the f64 floor (~1e-14) at five; after
    two its fit sat 1.26e-6 sigma from the f64 one, after five 6.8e-8,
    where more steps change nothing (``refine_sweep.py``). A step is
    one f64 matvec, O(n k): ~1 ms of the zoo fleet's ~2.5 s fit."""
    return gls_eigh_refine(A_approx, b, matvec, threshold, iters)


def gls_whiten(Mfull, sigma, sqrt_phi_inv):
    """(Mn, norm, q): whitened, prior-folded, column-normalized design.
    The prior enters through its square root; folding it into the
    normalization (norm_j^2 = ||col_j||^2 + phi_inv_j) makes diag(A) = 1,
    so the relative eigenvalue cut measures parameter degeneracy."""
    Mw = Mfull / sigma[..., None]
    norm = torch.hypot(column_norms(Mw), sqrt_phi_inv)
    Mn = Mw / norm[..., None, :]
    return Mn, norm, sqrt_phi_inv / norm


def seg_column_norms(Mw, seg_id, n_seg, block):
    """Per-segment exponent-range-safe L2 column norms, (n_seg, k):
    each packed pulsar's columns normalized by its own rows only.
    ``seg_id`` is constant on each ``block``-row chunk (the packed
    layout's Q-row blocks), and each chunk is reduced first, so the
    segment reduction sees ``block``-fold fewer rows (on CUDA it sorts
    them: see segment.py)."""
    bseg = seg_id[::block]
    amax = segment_max(torch.abs(Mw).reshape(
        (-1, block) + Mw.shape[1:]).amax(dim=1), bseg, n_seg)
    # empty segments reduce to -inf; zero columns to 0 — both guard to 1
    amax = torch.where(amax > 0, amax, 1.0)
    ssq = block_segment_sum(torch.square(Mw / amax[seg_id]), bseg, n_seg,
                            block)
    n = torch.sqrt(ssq)
    return amax * torch.where(n == 0, 1.0, n)


def seg_gls_whiten(Mfull, sigma, sqrt_phi_inv, seg_id, n_seg, block):
    """Segment-masked gls_whiten: (Mn, norm, q) with norm/q (n_seg, k),
    each row normalized by its own segment's norms (``block``: see
    seg_column_norms)."""
    Mw = Mfull / sigma[:, None]
    norm = torch.hypot(seg_column_norms(Mw, seg_id, n_seg, block),
                       sqrt_phi_inv)
    return Mw / norm[seg_id], norm, sqrt_phi_inv / norm


def seg_gls_norm(Mfull, sigma, sqrt_phi_inv, seg_id, n_seg, block):
    """(norm, q) of seg_gls_whiten WITHOUT materializing Mn — the fused
    packed path whitens inside the kernel and needs only the norms to
    pre-scale the raw design."""
    Mw = Mfull / sigma[:, None]
    norm = torch.hypot(seg_column_norms(Mw, seg_id, n_seg, block),
                       sqrt_phi_inv)
    return norm, sqrt_phi_inv / norm


def seg_gls_gram(Mn, q, block_seg, n_seg, block, precision="f64"):
    """Segment-masked gls_gram: A_s = sum_{rows of s} Mn^T Mn +
    diag(q_s^2), (n_seg, k, k), rows block-aligned per segment."""
    from .kernels.seggram import segment_gram

    A = segment_gram(Mn, block_seg, n_seg, block, precision=precision)
    return A + torch.diag_embed(q * q)


def stack_noise_bases(M, bases):
    """(Mfull, sqrt_phi_inv, nparam): append noise-basis columns with
    their prior sqrt-inverse-variances (us^2 weights -> 1/s prior
    sqrts; zero-weight padded columns get 0 = dropped as degenerate)."""
    B, w_us2 = bases
    nparam = M.shape[-1]
    zeros = M.new_zeros(M.shape[:-2] + (nparam,))
    if B is None:
        return M, zeros, nparam
    Mfull = torch.cat([M, B], dim=-1)
    sqrt_phi_inv = torch.cat([
        zeros,
        torch.where(w_us2 > 0, 1.0 / (torch.sqrt(torch.where(w_us2 > 0, w_us2, 1.0))
                                      * 1e-6), 0.0),
    ], dim=-1)
    return Mfull, sqrt_phi_inv, nparam


def _host(a):
    """Host numpy f64 of a tensor (any device) or array-like."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy().astype(np.float64, copy=False)
    return np.asarray(a, dtype=np.float64)


def cov_from_normalized(covn, norm) -> np.ndarray:
    """Covariance in physical units, formed on the host in f64 from the
    normalized-space covariance and the column norms."""
    norm = _host(norm)
    return _host(covn) / np.outer(norm, norm)


def gls_normal(Mfull, r, sigma, sqrt_phi_inv):
    """(A, b, norm): whitened, prior-folded, column-normalized normal
    equations (the JAX package's ``gls_normal``; see gls_whiten for the
    normalization that makes diag(A) = 1)."""
    Mn, norm, q = gls_whiten(Mfull, sigma, sqrt_phi_inv)
    A = Mn.mT @ Mn + torch.diag_embed(q * q)
    b = _mtv(Mn, r / sigma)
    return A, b, norm


def gls_solve(Mfull, r, sigma, sqrt_phi_inv, threshold=1e-12,
              precision="f64"):
    """Whitened, column-normalized, prior-weighted normal-equation
    solve — the one GLS step of GLSFitter (reference:
    fitter.py::GLSFitter's Woodbury solve).

    ``Mfull`` may carry noise-basis columns after the parameter
    columns; ``sqrt_phi_inv`` holds 0 for parameters (infinite prior
    variance) and 1/sqrt(prior variance) for basis amplitudes.
    ``precision="mixed"`` forms the Gram in f32 (TF32 off) and recovers
    f64 accuracy by refinement (gls_gram / gls_eigh_refine); if the
    refinement does not contract it warns and solves in f64.
    Returns (dx_all, (covn, norm), whitened_chi2) with whitened_chi2 =
    r^T C^-1 r by the Woodbury identity (rw2 - b.dxn), a host float.
    """
    Mn, norm, q = gls_whiten(Mfull, sigma, sqrt_phi_inv)
    z = r / sigma
    b = _mtv(Mn, z)
    A = gls_gram(Mn, q, precision)
    if precision == "mixed":
        def matvec(v):
            return _mtv(Mn, _mv(Mn, v)) + (q * q) * v

        dxn, covn, rel_resid = gls_eigh_refine(A, b, matvec, threshold)
        rel = rel_resid.item()
        if relres_failed(rel):
            # the f32 preconditioner could not contract (kept spectrum
            # too wide): redo in f64 — correctness first
            warnings.warn(
                f"mixed-precision GLS refinement did not converge "
                f"(rel resid {rel:.2e}); refitting in f64")
            if _fitquality_enabled():
                # count at the decision: the f64 redo re-records these
                # probes, so this is the fallback numerator's one home
                # on the single-pulsar path
                from .obs import fitquality as obs_fitq

                obs_fitq.FITQ.note_fallback(["gls_solve"])
            A = gls_gram(Mn, q, "f64")
            dxn, covn = gls_eigh_solve(A, b, threshold)
    else:
        dxn, covn = gls_eigh_solve(A, b, threshold)
    dx = dxn / norm
    chi2 = float(torch.sum(torch.square(z)) - b @ dxn)
    return dx, (covn, norm), chi2


def _fitquality_enabled():
    """One attribute check when the probes are off — call sites guard
    on this before materializing anything (e.g. whitened residuals)."""
    from .obs import fitquality as obs_fitq

    return obs_fitq.enabled()


def _record_fit_quality(fitter, chi2, n_toa, nparam, cov=None, rw=None,
                        method="gls", precision="f64", maxiter=None):
    """Single-pulsar fit-quality probes (the JAX package's
    ``_record_fit_quality``): chi2 z-score, conditioning from the
    normalized covariance, and — unique to this path, where whitened
    residuals exist — residual moments. Host post-processing of the
    fit's arrays (``cov`` = (covn, norm), ``rw`` a host array); the fit
    result is untouched. Callers gate on :func:`_fitquality_enabled`."""
    from .obs import fitquality as obs_fitq

    if not obs_fitq.enabled():
        return None
    psr = getattr(fitter.model, "PSR", None)
    label = (psr.value if psr is not None and getattr(psr, "value", None)
             else type(fitter).__name__)
    covn = None if cov is None else _host(cov[0])[None]
    summary = obs_fitq.record_fit_batch(
        [label], [float(chi2)], [float(n_toa - nparam)], covn=covn,
        method=method, precision=precision, maxiter=maxiter,
        source="fitter." + method)
    if rw is not None:
        obs_fitq.FITQ.annotate(
            label,
            residual_moments=obs_fitq.residual_moments(
                np.asarray(rw, dtype=np.float64)))
    return summary


def marginalized_chi2(r, sigma_s, bases, threshold=1e-12):
    """Whitened chi2 of a residual vector at fixed parameters, with any
    correlated-noise basis amplitudes marginalized (Woodbury:
    r^T C^-1 r = |rw|^2 - b.dxn over the noise columns alone) — the GLS
    objective the safeguarded fitters compare between iterates. It
    involves no parameter step, so a corrupted projection cannot make it
    look better than it is."""
    rw2 = float(torch.sum(torch.square(r / sigma_s)))
    B = bases[0] if bases is not None else None
    if B is None or not B.shape[1]:
        return rw2
    Mfull, sqrt_phi_inv, _ = stack_noise_bases(
        r.new_zeros((r.shape[0], 0)), bases)
    A, b, _ = gls_normal(Mfull, r, sigma_s, sqrt_phi_inv)
    dxn, _ = gls_eigh_solve(A, b, threshold)
    return rw2 - float(b @ dxn)


# cuSOLVER routine for the tall, thin SVD of wls_step on CUDA tensors
# (torch.linalg.svd's ``driver``): Jacobi, the fastest of the true SVDs
# on the fleet's WLS fit (chip_smoke.py's [fleet] modes times each on an
# H100; gesvda, faster still, works from the Gram matrix, which is the
# normal-equations design the threshold semantics rule out)
SVD_DRIVER = "gesvdj"


def wls_step(Mw, rw, threshold=1e-12):
    """Column-normalized whitened SVD solve: returns (dx, covn, norm),
    batched over leading dimensions.

    Column normalization before the SVD (reference:
    utils.py::normalize_designmatrix) is essential: raw columns span
    ~20 decades (F1 vs DM), and a relative singular-value threshold on
    the unnormalized matrix silently deletes the small-scale
    parameters. The covariance is returned in normalized space; rescale
    on the host with cov_from_normalized. On CUDA tensors the SVD runs
    the cuSOLVER routine ``SVD_DRIVER``."""
    norm = column_norms(Mw)
    Mn = Mw / norm[..., None, :]
    kw = {"driver": SVD_DRIVER} if Mn.is_cuda else {}
    U, s, Vh = graphs.eager(torch.linalg.svd, Mn, full_matrices=False, **kw)
    smax = torch.amax(s, dim=-1, keepdim=True)
    sinv = torch.where(s > threshold * smax, 1.0 / s, 0.0)
    dx = _mtv(Vh, sinv * _mtv(U, rw)) / norm
    covn = (Vh.mT * torch.square(sinv)[..., None, :]) @ Vh
    return dx, covn, norm


def degraded_f64() -> bool:
    """False: CUDA and CPU float64 are IEEE binary64 with correct
    rounding. (The JAX package probes here for the TPU's emulated f64,
    whose ~47-bit significand loses 2^-50 in 1 + 2^-50; nothing the
    port runs on has that.)"""
    return False


def device_memory_stats(device):
    """Bytes allocated on the fit's CUDA device
    (``torch.cuda.memory_stats``), or None on the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return int(torch.cuda.memory_stats(dev).get(
        "allocated_bytes.all.current", 0))


def _wall(device):
    """Host clock, read after the device's queued work has finished."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def fit_metrics(t_start, prep_s, iter_s, toas, model, device):
    """The per-fit metrics dict of the single-pulsar fitters (the JAX
    package's ``fit_metrics``)."""
    return {
        "backend": torch.device(device).type,
        "prepare_s": round(prep_s, 4),
        "iteration_s": [round(s, 4) for s in iter_s],
        "total_s": round(_wall(device) - t_start, 4),
        "n_toas": len(toas),
        "n_free": len(model.free_params),
        "device_bytes_in_use": device_memory_stats(device),
    }


def _reject_free_dmjump(model):
    """Narrowband fitters refuse free DMJUMPs: their time-domain design
    column is identically zero (the JAX package's check)."""
    comp = model.components.get("DispersionJump")
    if comp is None:
        return
    free = [p for p in comp.params if not getattr(comp, p).frozen]
    if free:
        raise ValueError(
            f"free DMJUMP parameters {free} affect only wideband DM "
            "measurements; use a wideband fitter or freeze them")


def _reject_free_dm_noise(model):
    """Wideband fitters refuse free DMEFAC/DMEQUAD: the DM-error scaling
    is applied once at the start-of-fit values, so a fitted value would
    never feed back into the weights (the JAX package's check)."""
    comp = model.components.get("ScaleToaError")
    free = ([] if comp is None else
            [p for p in comp.params if p.startswith(("DMEFAC", "DMEQUAD"))
             and not getattr(comp, p).frozen])
    if free:
        raise ValueError(
            f"free DMEFAC/DMEQUAD parameters {free} scale wideband DM "
            "uncertainties, which are fixed at their start-of-fit "
            "values; freeze them, or refit with updated values between "
            "fits")



class ConvergenceFailure(RuntimeError):
    pass


def _maybe_inject_solver_diverge(method):
    """Resilience hook at the single-pulsar solve entries: the armed
    ``solver_diverge`` fault point makes fit_toas raise the same
    ConvergenceFailure a real blow-up would. One falsy check when
    nothing is armed."""
    from .resilience import faultinject

    fault = faultinject.fire("solver_diverge", method=method)
    if fault:
        raise ConvergenceFailure(
            f"injected solver divergence (fault point solver_diverge, "
            f"method={method}, fire={fault['fire']})")


class MaxiterReached(ConvergenceFailure):
    """Downhill loop hit maxiter before the tolerance was met
    (reference: fitter.py::MaxiterReached). Carries the best state."""

    def __init__(self, iterations, chi2):
        super().__init__(
            f"no convergence after {iterations} iterations (chi2={chi2:.6g})")
        self.iterations = iterations
        self.chi2 = chi2


class StepProblem(ConvergenceFailure):
    """A fit step failed to improve chi2 even after step halving
    (reference: fitter.py::StepProblem)."""


class CorrelatedErrors(ValueError):
    """A fitter that assumes uncorrelated errors was given a model with
    correlated-noise components (reference: fitter.py::CorrelatedErrors)."""

    def __init__(self, components):
        names = [type(c).__name__ for c in components]
        super().__init__(
            f"model has correlated-noise components {names}; use a GLS "
            "fitter (GLSFitter/DownhillGLSFitter) instead")
        self.noise_components = names


def _correlated_noise_components(model):
    return [c for c in model.components.values()
            if getattr(c, "basis_weight", None) is not None]


def _n_offset(labels):
    """Count of leading non-parameter columns (the implicit 'Offset')."""
    return 1 if labels and labels[0] == "Offset" else 0


class Fitter:
    """(reference: fitter.py::Fitter base). ``device`` is where the
    model is evaluated and solved: the card unless the caller asks for
    ``"cpu"``."""

    def __init__(self, toas, model, residuals=None, device="cuda"):
        self.toas = toas
        self.device = device
        self.model_init = model
        self.model = copy.deepcopy(model)
        self.resids_init = residuals or Residuals(toas, self.model,
                                                  device=device)
        self.resids = self.resids_init
        self.converged = False
        self.noise_ampls = None  # set by GLS-family fits with bases

    def _track_mode(self):
        tm = getattr(self.model, "TRACK", None)
        return ("use_pulse_numbers"
                if tm is not None and tm.value == "-2" else "nearest")

    def _prepare(self):
        return self.model.prepare(self.toas, device=self.device)

    def _residuals(self):
        return Residuals(self.toas, self.model, device=self.device)

    def get_fitparams(self):
        return {p: getattr(self.model, p) for p in self.model.free_params}

    def fit_toas(self, maxiter=1):
        raise NotImplementedError

    # -- shared plumbing --

    def _sync_model_from_vector(self, prepared, x):
        """Write the fitted vector back into the host Parameters."""
        for (pname, _, _), val in zip(prepared.free_param_map(), _host(x)):
            getattr(self.model, pname).set_fitted_value(float(val))

    def _set_uncertainties(self, prepared, cov):
        from .pint_matrix import CovarianceMatrix

        cov = _host(cov)
        sig = np.sqrt(np.diag(cov))
        names = []
        for (pname, _, _), s in zip(prepared.free_param_map(), sig):
            getattr(self.model, pname).uncertainty = float(s)
            names.append(pname)
        self.parameter_covariance_matrix = cov
        units = [getattr(self.model, p).units or "" for p in names]
        self.covariance_matrix = CovarianceMatrix(cov, names, units)
        self.correlation_matrix = self.covariance_matrix.to_correlation()

    def _capture_noise_bases(self, prepared):
        """Store the per-component basis matrices (TOA rows, host) of
        the fit's own ``prepared``, so get_noise_resids pairs the
        fitted amplitudes with the bases they were solved against."""
        segs = []
        # the order of GLSFitter._noise_bases (model.components order)
        for name, comp in self.model.components.items():
            bw = getattr(comp, "basis_weight", None)
            if bw is None:
                continue
            B, _ = bw(prepared.params0, prepared.prep)
            if B.shape[1]:
                segs.append((name, _host(B)))
        self._noise_basis_segments = segs

    def get_noise_resids(self):
        """Per-component noise realizations [s] from the last GLS-family
        fit: {component name: basis @ fitted amplitudes} over the TOA
        rows (reference: Residuals.noise_resids populated by
        GLSFitter)."""
        if self.noise_ampls is None:
            raise ValueError(
                "no fitted noise amplitudes — run fit_toas() on a "
                "GLS-family fitter with ECORR/red-noise components first")
        if getattr(self, "_noise_basis_segments", None) is None:
            self._capture_noise_bases(self._prepare())
        out = {}
        k0 = 0
        for name, B in self._noise_basis_segments:
            k = B.shape[1]
            out[name] = B @ np.asarray(self.noise_ampls[k0:k0 + k])
            k0 += k
        if k0 != len(self.noise_ampls):
            raise RuntimeError(
                f"noise basis layout changed since the fit "
                f"({k0} columns vs {len(self.noise_ampls)} amplitudes)")
        return out

    def _attach_noise_resids(self):
        """Set resids.noise_resids from the captured fit state."""
        self.resids.noise_resids = (self.get_noise_resids()
                                    if self.noise_ampls is not None else {})

    def _update_model_stats(self):
        """Write fit bookkeeping into the model's top-level params so
        post-fit par files carry START/FINISH/NTOA/TRES/CHI2
        (reference: fitter.py::Fitter.update_model)."""
        from .models.parameter import MJDParameter, floatParameter

        mjds = self.toas.get_mjds()

        def set_top(name, cls, value):
            if name in self.model.top_params:
                getattr(self.model, name).value = value
            else:
                p = cls(name)
                p.value = value
                self.model.add_top_param(p)

        set_top("START", MJDParameter, float(mjds.min()))
        set_top("FINISH", MJDParameter, float(mjds.max()))
        set_top("NTOA", floatParameter, float(len(self.toas)))
        set_top("TRES", floatParameter,
                float(self.resids.rms_weighted() * 1e6))
        chi2 = getattr(self, "chi2_whitened", None)
        chi2 = float(chi2 if chi2 is not None else self.resids.chi2)
        set_top("CHI2", floatParameter, chi2)
        if self.resids.dof > 0:
            set_top("CHI2R", floatParameter, chi2 / self.resids.dof)

    def get_designmatrix(self):
        """Labeled time-residual design matrix [s/param-unit]
        (reference: pint_matrix.py::DesignMatrix from
        TimingModel.designmatrix)."""
        from .pint_matrix import DesignMatrix

        return DesignMatrix.from_prepared(self._prepare(), self.model)

    def print_summary(self):
        print(self.get_summary())

    def plot(self, plotfile=None, title=None):
        """Post-fit residual plot with error bars (reference:
        fitter.py::Fitter.plot); delegates to
        plot_utils.plot_residuals, returns the figure (or the saved
        path when ``plotfile`` is given)."""
        from .plot_utils import plot_residuals

        return plot_residuals(self, plotfile=plotfile, title=title)

    def get_summary(self) -> str:
        """(reference: fitter.py::Fitter.get_summary)"""
        r = self.resids
        lines = [
            f"Fitted model using {type(self).__name__}",
            f"Number of TOAs: {len(self.toas)}",
            f"Chi2: {r.chi2:.2f}  dof: {r.dof}  reduced chi2: {r.reduced_chi2:.3f}",
            f"Weighted RMS residual: {r.rms_weighted() * 1e6:.4f} us",
            "",
            f"{'PARAM':<12}{'VALUE':>24}{'UNCERTAINTY':>16}",
        ]
        for p in self.model.free_params:
            par = getattr(self.model, p)
            unc = f"{par.uncertainty:.3g}" if par.uncertainty else "-"
            lines.append(f"{p:<12}{par.value:>24.14g}{unc:>16}")
        corr = getattr(self, "correlation_matrix", None)
        if corr is not None:
            strong = []
            names = corr.labels(0)
            c = np.asarray(corr.matrix)
            for i in range(len(names)):
                for j in range(i + 1, len(names)):
                    if abs(c[i, j]) > 0.5:
                        strong.append((abs(c[i, j]),
                                       f"  {names[i]:<10} {names[j]:<10} "
                                       f"{c[i, j]:+.3f}"))
            if strong:
                lines.append("")
                lines.append("Strong parameter correlations (|r| > 0.5):")
                lines.extend(s for _, s in
                             sorted(strong, reverse=True)[:12])
        return "\n".join(lines)

    def ftest(self, other_chi2, other_dof):
        from .utils import ftest

        return ftest(other_chi2, other_dof, self.resids.chi2, self.resids.dof)

    def ftest_add_params(self, names, maxiter=None):
        """Significance of freeing extra parameters (reference:
        fitter.py::Fitter.ftest with remove=False): refit a model copy
        with ``names`` unfrozen using this fitter's class, and return
        {"p_value", "chi2", "dof", "fitter"} for the augmented fit. The
        named parameters must already exist as frozen component
        parameters; ``maxiter=None`` keeps the class's default."""
        if not self.converged:
            raise ValueError(
                "run fit_toas() first: the F-test baseline must be the "
                "fitted chi2, not the prefit residuals")
        if isinstance(names, str):
            names = [names]
        # the constructor deep-copies the model: unfreeze on the new
        # fitter's private copy
        f2 = type(self)(self.toas, self.model, device=self.device)
        for name in names:
            if name not in f2.model.params or name in f2.model.top_params:
                raise KeyError(
                    f"{name!r} is not a fittable component parameter — "
                    "add the component/prefix member first")
            par = getattr(f2.model, name)
            if not par.frozen:
                raise ValueError(f"{name} is already free")
            par.frozen = False
        if maxiter is None:
            f2.fit_toas()
        else:
            f2.fit_toas(maxiter=maxiter)

        # GLS-family fits compare the marginalized chi2 on both sides
        def _chi2(f):
            c = getattr(f, "chi2_whitened", None)
            return float(c) if c is not None else float(f.resids.chi2)

        from .utils import ftest as _ftest

        p = _ftest(_chi2(self), self.resids.dof, _chi2(f2), f2.resids.dof)
        return {"p_value": p, "chi2": _chi2(f2),
                "dof": f2.resids.dof, "fitter": f2}

    def get_derived_params(self) -> dict:
        """Post-fit derived quantities with first-order propagated
        uncertainties (reference: fitter.py::Fitter.get_derived_params):
        P0/P1, and when F1 < 0 AGE [yr], BSURF [G], EDOT [erg/s]; PMTOT
        [mas/yr] with proper motion; the mass function and companion
        masses with a binary. Values are (value, uncertainty-or-None)."""
        from . import derived_quantities as dq

        out = {}
        f0 = self.model.F0.value
        f0e = self.model.F0.uncertainty or 0.0
        f1 = getattr(self.model, "F1", None)
        f1v = f1.value if f1 is not None and f1.value is not None else 0.0
        f1e = (f1.uncertainty or 0.0) if f1 is not None else 0.0
        p0 = 1.0 / f0
        p0e = f0e / f0**2
        p1 = -f1v / f0**2
        p1e = np.sqrt((f1e / f0**2) ** 2 + (2 * f1v * f0e / f0**3) ** 2)
        out["P0"] = (p0, p0e or None)
        out["P1"] = (p1, p1e or None)
        if f1v < 0:
            out["AGE_yr"] = (float(dq.pulsar_age(f0, f1v)), None)
            out["BSURF_G"] = (float(dq.pulsar_B(f0, f1v)), None)
            out["EDOT_erg_s"] = (float(dq.pulsar_edot(f0, f1v)), None)
        pm_names = (("PMRA", "PMDEC") if "PMRA" in self.model.params
                    else ("PMELONG", "PMELAT"))
        if all(n in self.model.params for n in pm_names):
            a = getattr(self.model, pm_names[0]).value
            b = getattr(self.model, pm_names[1]).value
            if a is not None and b is not None:
                out["PMTOT_masyr"] = (float(dq.pmtot(a, b)), None)
        pb = (self.model.PB.value if "PB" in self.model.params else None)
        if pb is None and "FB0" in self.model.params \
                and self.model.FB0.value:
            pb = 1.0 / self.model.FB0.value / 86400.0  # FB0 [Hz] -> PB [d]
        a1 = (self.model.A1.value if "A1" in self.model.params else None)
        if pb is not None and a1 is not None:
            fm = float(dq.mass_function(pb, a1))
            out["MASSFN_Msun"] = (fm, None)
            out["MC_MIN_Msun"] = (float(dq.companion_mass(pb, a1, 1.0)), None)
            out["MC_MED_Msun"] = (float(dq.companion_mass(pb, a1, 0.866)),
                                  None)
            m2 = getattr(self.model, "M2", None)
            sini = getattr(self.model, "SINI", None)
            if (m2 is not None and m2.value and sini is not None
                    and sini.value):
                out["MP_Msun"] = (float(dq.pulsar_mass(pb, a1, m2.value,
                                                       sini.value)), None)
        return out


def _wls_fused_fns(prepared, threshold=1e-12, track_mode="nearest",
                   subtract_mean=True, use_weighted_mean=True,
                   incoffset=True):
    """The WLS iteration as two functions of the free-parameter vector
    (the JAX package's ``_wls_fused_fns``, there two jitted programs):

    - eval: x -> (rw, sigma_s, chi2), the pre-loop evaluation;
    - step: (x, rw, sigma_s) -> (x', rw', sigma_s', chi2', covn, norm):
      residuals, EFAC/EQUAD sigmas, the jacfwd design matrix, the
      column-normalized SVD step and chi2 at the new iterate.

    Returns (eval, step, noff), noff the leading offset-column count.
    The whitened residuals are carried across the iteration boundary,
    and the tensors stay on the device: the caller brings chi2 alone to
    the host, once per iteration, for the best-iterate safeguard."""
    from .models.timing_model import _overlay_params, _phase_impl, _sigma_impl
    from .utils import weighted_mean

    model, prep, batch = prepared.model, prepared.prep, prepared.batch
    params0 = prepared.params0
    free_map = tuple(prepared.free_param_map())
    labels = [n for n, _, _ in free_map]
    if incoffset and "PHOFF" in labels:
        incoffset = False
    noff = 1 if incoffset else 0
    f0 = params0["F"][0]

    def resid_and_sigma(x):
        # residual_vector_fn's body, also returning sigma [s]
        p = _overlay_params(x, params0, free_map)
        frac = _phase_impl(model, p, batch, prep)
        if track_mode == "use_pulse_numbers":
            pn = batch.pulse_number
            tracked = (prep["phi_ref_int"] - pn) + frac
            wrapped = frac - torch.floor(frac + 0.5)
            resid = torch.where(torch.isnan(pn), wrapped, tracked)
        else:
            resid = frac - torch.floor(frac + 0.5)
        sigma = _sigma_impl(model, p, batch, prep)
        if subtract_mean:
            if use_weighted_mean:
                resid = resid - weighted_mean(resid, sigma)
            else:
                resid = resid - torch.mean(resid)
        return resid / p["F"][0], sigma * 1e-6

    def eval_fn(x):
        r, sigma_s = resid_and_sigma(x)
        rw = r / sigma_s
        return rw, sigma_s, torch.sum(torch.square(rw))

    def phase_of(xx):
        return _phase_impl(model, _overlay_params(xx, params0, free_map),
                           batch, prep)

    def step_fn(x, rw, sigma_s):
        M = autodiff.jacfwd(phase_of)(x)
        if incoffset:
            M = torch.cat([M.new_ones((M.shape[0], 1)), M], dim=1)
        Mw = (M / f0) / sigma_s[:, None]
        dx_all, covn, norm = wls_step(Mw, rw, threshold)
        x2 = x - dx_all[noff:]
        r2, sigma2 = resid_and_sigma(x2)
        rw2 = r2 / sigma2
        return (x2, rw2, sigma2, torch.sum(torch.square(rw2)), covn, norm)

    return eval_fn, step_fn, noff


class WLSFitter(Fitter):
    """Weighted least squares via SVD (reference: fitter.py::WLSFitter).

    Prepares once, then iterates the free-parameter vector on the
    device — the exact-delta phase formulation needs no host re-pack
    between iterations."""

    def fit_toas(self, maxiter=2, threshold=1e-12):
        _maybe_inject_solver_diverge("wls")
        corr = _correlated_noise_components(self.model)
        if corr:
            raise CorrelatedErrors(corr)
        _reject_free_dmjump(self.model)
        t_start = time.perf_counter()
        prepared = self._prepare()
        prep_s = time.perf_counter() - t_start
        eval_fn, step_fn, noff = _wls_fused_fns(
            prepared, threshold=threshold, track_mode=self._track_mode())
        iter_s = []

        x = prepared.vector_from_params()
        rw, sigma_s, chi2 = eval_fn(x)
        chi2 = float(chi2)
        # best-iterate safeguard: a plain Gauss-Newton step can raise
        # chi2 (strong nonlinearity); never hand back an iterate worse
        # than one already evaluated
        best = (chi2, x, None)
        first_cov = None
        for _ in range(maxiter):
            t_it = time.perf_counter()
            x, rw, sigma_s, chi2, covn, norm = step_fn(x, rw, sigma_s)
            chi2 = float(chi2)  # the iteration's one host sync
            if first_cov is None:
                first_cov = (covn, norm)
            iter_s.append(time.perf_counter() - t_it)
            if chi2 < best[0]:
                best = (chi2, x, (covn, norm))
        if chi2 - best[0] > 1e-6 * max(1.0, best[0]):
            warnings.warn(
                f"WLS iteration increased chi2 ({best[0]:.6g} -> "
                f"{chi2:.6g}); keeping the best evaluated iterate")
        chi2, x, cov = best
        self._sync_model_from_vector(prepared, x)
        cov = cov or first_cov
        if cov is not None:
            cov_all = cov_from_normalized(*cov)
            self._set_uncertainties(prepared, cov_all[noff:, noff:])
        self.resids = self._residuals()
        self._update_model_stats()
        self.converged = True
        self.metrics = fit_metrics(t_start, prep_s, iter_s, self.toas,
                                   self.model, prepared.device)
        return self.resids.chi2


class DownhillWLSFitter(WLSFitter):
    """Step-halving line search on chi2 (reference:
    fitter.py::DownhillWLSFitter)."""

    def fit_toas(self, maxiter=20, threshold=1e-12, min_lambda=1e-3,
                 tol=1e-10, raise_maxiter=False):
        corr = _correlated_noise_components(self.model)
        if corr:
            raise CorrelatedErrors(corr)
        _reject_free_dmjump(self.model)
        t_start = time.perf_counter()
        prepared = self._prepare()
        prep_s = time.perf_counter() - t_start
        resid_fn = prepared.residual_vector_fn(track_mode=self._track_mode())
        dm_fn, labels = prepared.designmatrix_fn()
        noff = _n_offset(labels)
        f0 = prepared.params0["F"][0]
        iter_s = []

        def sigma_of(x):
            return prepared.scaled_sigma_us(
                prepared.params_with_vector(x)) * 1e-6

        def chi2_of(x):
            return float(torch.sum(torch.square(resid_fn(x) / sigma_of(x))))

        x = prepared.vector_from_params()
        best_chi2 = chi2_of(x)
        covn = norm = None
        for _ in range(maxiter):
            t_it = time.perf_counter()
            sigma_s = sigma_of(x)
            Mw = (dm_fn(x) / f0) / sigma_s[:, None]
            rw = resid_fn(x) / sigma_s
            dx_all, covn, norm = wls_step(Mw, rw, threshold)
            dx = dx_all[noff:]
            lam = 1.0
            improved = False
            while lam >= min_lambda:
                chi2 = chi2_of(x - lam * dx)
                if chi2 <= best_chi2 + 1e-12:
                    improved = chi2 < best_chi2 - tol * max(1.0, best_chi2)
                    best_chi2 = min(best_chi2, chi2)
                    x = x - lam * dx
                    break
                lam *= 0.5
            iter_s.append(time.perf_counter() - t_it)
            if lam < min_lambda or not improved:
                break
        else:
            # every iteration still improved: maxiter exhausted without
            # reaching tol; the best state is kept on the model
            if raise_maxiter:
                self._sync_model_from_vector(prepared, x)
                self.metrics = fit_metrics(t_start, prep_s, iter_s,
                                           self.toas, self.model,
                                           prepared.device)
                raise MaxiterReached(maxiter, best_chi2)
        self._sync_model_from_vector(prepared, x)
        if covn is not None:
            cov_all = cov_from_normalized(covn, norm)
            self._set_uncertainties(prepared, cov_all[noff:, noff:])
        self.resids = self._residuals()
        self._update_model_stats()
        self.converged = True
        self.metrics = fit_metrics(t_start, prep_s, iter_s, self.toas,
                                   self.model, prepared.device)
        return self.resids.chi2


class GLSFitter(Fitter):
    """Generalized least squares with correlated noise (reference:
    fitter.py::GLSFitter).

    Solves the Woodbury-extended normal equations: the noise bases
    (ECORR's dense epoch columns U, red noise's Fourier columns F) are
    appended to the design matrix with their prior weights, and one
    thresholded eigh solve runs on the device. The bases are fixed per
    prepare, so they stay outside the jacfwd-traced phase."""

    def _noise_bases(self, prepared, params=None):
        p = prepared.params0 if params is None else params
        bases, weights = [], []
        for comp in self.model.components.values():
            bw = getattr(comp, "basis_weight", None)
            if bw is None:
                continue
            B, w = bw(p, prepared.prep)
            if B.shape[1]:
                bases.append(B)
                weights.append(w)
        if bases:
            return torch.cat(bases, dim=1), torch.cat(weights)
        return None, None

    def fit_toas(self, maxiter=2, threshold=1e-12, tol=0.0,
                 precision="f64"):
        _maybe_inject_solver_diverge("gls")
        _reject_free_dmjump(self.model)
        check_precision(precision)
        t_start = time.perf_counter()
        prepared = self._prepare()
        prep_s = time.perf_counter() - t_start
        resid_fn = prepared.residual_vector_fn(track_mode=self._track_mode())
        dm_fn, labels = prepared.designmatrix_fn()
        noff = _n_offset(labels)
        f0 = prepared.params0["F"][0]
        iter_s = []

        def state_at(x):
            p = prepared.params_with_vector(x)
            r = resid_fn(x)
            sigma_s = prepared.scaled_sigma_us(p) * 1e-6
            return r, sigma_s, self._noise_bases(prepared, p)

        x = prepared.vector_from_params()
        r, sigma_s, bases = state_at(x)
        chi2 = marginalized_chi2(r, sigma_s, bases, threshold)
        # best-iterate safeguard on the marginalized chi2: never return
        # a worse iterate than one already evaluated
        best = (chi2, x, None, None)
        first_cov = first_na = None
        nparam = None
        last_chi2 = None
        for _ in range(maxiter):
            t_it = time.perf_counter()
            M = dm_fn(x) / f0
            Mfull, sqrt_phi_inv, nparam = stack_noise_bases(M, bases)
            dx, cov, _ = gls_solve(Mfull, r, sigma_s, sqrt_phi_inv,
                                   threshold, precision=precision)
            noise_ampls = dx[nparam:] if bases[0] is not None else None
            if first_cov is None:
                # the first solve is evaluated at x0: the covariance and
                # amplitudes of the start, used when no step improves
                first_cov, first_na = cov, noise_ampls
            x = x - dx[noff:nparam]
            r, sigma_s, bases = state_at(x)
            chi2 = marginalized_chi2(r, sigma_s, bases, threshold)
            iter_s.append(time.perf_counter() - t_it)
            if chi2 < best[0]:
                best = (chi2, x, cov, noise_ampls)
            if (tol and last_chi2 is not None
                    and abs(last_chi2 - chi2) < tol * max(1.0, abs(last_chi2))):
                break
            last_chi2 = chi2
        if chi2 - best[0] > 1e-6 * max(1.0, best[0]):
            warnings.warn(
                f"GLS iteration increased chi2 ({best[0]:.6g} -> "
                f"{chi2:.6g}); keeping the best evaluated iterate")
        chi2, x, cov, na = best
        na = na if na is not None else first_na
        self.noise_ampls = None if na is None else _host(na)
        if self.noise_ampls is not None:
            self._capture_noise_bases(prepared)
        self._sync_model_from_vector(prepared, x)
        cov = cov if cov is not None else first_cov
        if cov is not None:
            cov_host = cov_from_normalized(*cov)
            self._set_uncertainties(prepared,
                                    cov_host[noff:nparam, noff:nparam])
        self.resids = self._residuals()
        self._attach_noise_resids()
        self.converged = True
        self.chi2_whitened = chi2
        if _fitquality_enabled() and nparam is not None:
            # r/sigma_s hold the latest evaluated state (the best
            # iterate except in the warned chi2-increase case)
            _record_fit_quality(
                self, chi2, int(r.shape[0]), nparam, cov=cov,
                rw=_host(r) / _host(sigma_s), method="gls",
                precision=precision, maxiter=maxiter)
        self._update_model_stats()
        self.metrics = fit_metrics(t_start, prep_s, iter_s, self.toas,
                                   self.model, prepared.device)
        return chi2


class DownhillGLSFitter(GLSFitter):
    """Iterate GLS to chi2 convergence (reference:
    fitter.py::DownhillGLSFitter): GLSFitter's loop (one prepare) with a
    convergence tolerance."""

    def fit_toas(self, maxiter=10, threshold=1e-12, tol=1e-8,
                 precision="f64"):
        return super().fit_toas(maxiter=maxiter, threshold=threshold,
                                tol=tol, precision=precision)


class WidebandTOAFitter(GLSFitter):
    """Joint time + DM fit (reference: fitter.py::WidebandTOAFitter).

    The residual vector is [time resids; DM resids]; the design matrix
    is assembled from labeled per-quantity DesignMatrix blocks by
    combine_design_matrices_by_quantity (pint_matrix.py), so the time
    and DM blocks carry their own units and the column union (the time
    block's Offset has no DM rows) is explicit. Each iteration prepares
    the model again on the host, as the JAX package does."""

    def _dm_designmatrix(self, prepared, valid):
        """Labeled d(DM_resid)/d(param) block [pc cm^-3 / param-unit],
        by ``torch.func.jacfwd`` over wideband_dm_model."""
        from .pint_matrix import DesignMatrix

        idx = torch.as_tensor(np.flatnonzero(valid), device=prepared.device)

        def dm_model(x):
            p = prepared.params_with_vector(x)
            dm = wideband_dm_model(self.model, p, prepared.prep,
                                   batch=prepared.batch)
            return dm[idx]

        x0 = prepared.vector_from_params()
        M_dm = -autodiff.jacfwd(dm_model)(x0)  # resid = measured - model
        names = [n for n, _, _ in prepared.free_param_map()]
        units = [f"pc cm^-3/({getattr(self.model, n).units or '1'})"
                 for n in names]
        return DesignMatrix(M_dm, "dm", "pc cm^-3", names, units)

    def _wideband_rstate(self):
        """(prepared, valid, r, sigma, (B, w_us2)) at the current model
        state: the residual/noise half of _wideband_system (no design
        matrices), enough for the final safeguard evaluation."""
        prepared = self._prepare()
        wb = WidebandTOAResiduals(self.toas, self.model, prepared=prepared)
        valid = wb.dm.valid
        dev = prepared.device
        r_t = wb.toa.calc_time_resids()
        r_dm = torch.as_tensor(wb.dm.calc_dm_resids()[valid], device=dev)
        sigma_t = prepared.scaled_sigma_us() * 1e-6
        sigma_dm = torch.as_tensor(wb.dm.dm_error[valid], device=dev)
        r = torch.cat([r_t, r_dm])
        sigma = torch.cat([sigma_t, sigma_dm])
        bases = self._noise_bases_padded(prepared, int(valid.sum()))
        return prepared, valid, r, sigma, bases

    def _wideband_system(self):
        """(prepared, combined design, r, sigma, noff, x0, (B, w_us2))
        at the current model state. B holds the TOA-noise basis columns
        (ECORR/red noise) zero-padded over the DM rows: the DM
        measurements are uncorrelated with the TOA noise processes."""
        from .pint_matrix import (DesignMatrix,
                                  combine_design_matrices_by_quantity)

        prepared, valid, r, sigma, bases = self._wideband_rstate()
        dm_time = DesignMatrix.from_prepared(prepared, self.model)
        dm_dm = self._dm_designmatrix(prepared, valid)
        combined = combine_design_matrices_by_quantity([dm_time, dm_dm])
        self.design_matrix = combined
        noff = _n_offset(combined.param_names)
        return (prepared, combined, r, sigma, noff,
                prepared.vector_from_params(), bases)

    def _noise_bases_padded(self, prepared, n_dm_rows):
        """TOA-noise bases zero-padded over the DM rows."""
        B, w_us2 = self._noise_bases(prepared)
        if B is not None:
            B = torch.cat([B, B.new_zeros((n_dm_rows, B.shape[1]))], dim=0)
        return (B, w_us2)

    def _wideband_chi2_fn(self, prepared, bases=(None, None),
                          threshold=1e-12):
        """The GLS objective chi2(x) over [time; DM] rows: the whitened
        chi2 with any noise-basis amplitudes marginalized at fixed x
        (Woodbury: |rw|^2 - b.dxn), one function per outer iteration,
        so line-search probes pay no host re-prepare. ``threshold``
        must match the solve's, or the two chi2 measures disagree on
        near-degenerate noise directions."""
        wb = WidebandDMResiduals(self.toas, self.model, prepared=prepared)
        valid = wb.valid
        dev = prepared.device
        idx = torch.as_tensor(np.flatnonzero(valid), device=dev)
        dm_meas = torch.as_tensor(wb.dm_observed[valid], device=dev)
        sigma_dm = torch.as_tensor(wb.dm_error[valid], device=dev)
        resid_fn = prepared.residual_vector_fn(track_mode=self._track_mode())
        B, w_us2 = bases
        if B is not None:
            _, sqrt_phi_inv, _ = stack_noise_bases(B[:, :0], bases)

        def chi2_of(x):
            p = prepared.params_with_vector(x)
            r_t = resid_fn(x)
            sig_t = prepared.scaled_sigma_us(p) * 1e-6
            dm = wideband_dm_model(self.model, p, prepared.prep,
                                   batch=prepared.batch)[idx]
            r = torch.cat([r_t, dm_meas - dm])
            sigma = torch.cat([sig_t, sigma_dm])
            rw2 = torch.sum(torch.square(r / sigma))
            if B is None:
                return float(rw2)
            A, b, _ = gls_normal(B, r, sigma, sqrt_phi_inv)
            dxn, _ = gls_eigh_solve(A, b, threshold)
            return float(rw2 - b @ dxn)

        return chi2_of

    def _wideband_chi2(self, threshold=1e-12):
        """The GLS objective at the CURRENT model state."""
        prepared = self._prepare()
        valid = WidebandDMResiduals(self.toas, self.model,
                                    prepared=prepared).valid
        bases = self._noise_bases_padded(prepared, int(valid.sum()))
        fn = self._wideband_chi2_fn(prepared, bases, threshold)
        return fn(prepared.vector_from_params())

    def _wideband_resids(self):
        return WidebandTOAResiduals(self.toas, self.model,
                                    device=self.device)

    def fit_toas(self, maxiter=2, threshold=1e-12, precision="f64"):
        check_precision(precision)
        _reject_free_dm_noise(self.model)
        t_start = _wall(self.device)
        iter_s = []
        chi2 = None
        best = None  # (marginalized chi2, prepared, x0) of the best state
        for _ in range(maxiter):
            t_it = time.perf_counter()
            prepared, combined, r, sigma, noff, x0, bases = \
                self._wideband_system()
            chi2_act = marginalized_chi2(r, sigma, bases, threshold)
            if best is None or chi2_act < best[0]:
                best = (chi2_act, prepared, x0)
            Mfull, sqrt_phi_inv, nparam = stack_noise_bases(
                combined.matrix, bases)
            dx_all, cov, chi2 = gls_solve(Mfull, r, sigma, sqrt_phi_inv,
                                          threshold, precision=precision)
            self._sync_model_from_vector(prepared, x0 - dx_all[noff:nparam])
            self.noise_ampls = (_host(dx_all[nparam:])
                                if bases[0] is not None else None)
            cov_all = cov_from_normalized(*cov)
            self._set_uncertainties(prepared, cov_all[noff:nparam,
                                                      noff:nparam])
            iter_s.append(time.perf_counter() - t_it)
        # best-iterate safeguard (see GLSFitter.fit_toas): the final
        # state's marginalized chi2, at the in-loop threshold, against
        # the best one; revert if an iteration diverged
        _, _, r, sigma, bases = self._wideband_rstate()
        final_chi2 = marginalized_chi2(r, sigma, bases, threshold)
        if (best is not None
                and final_chi2 - best[0] > 1e-6 * max(1.0, best[0])):
            warnings.warn(
                f"wideband GLS iteration increased chi2 ({best[0]:.6g} "
                f"-> {final_chi2:.6g}); reverting to the best evaluated "
                "iterate (reported uncertainties are from the last "
                "solve; noise amplitudes are cleared)")
            chi2, prepared, x0 = best
            self._sync_model_from_vector(prepared, x0)
            # the amplitudes solved at the diverged state do not belong
            # to the reverted parameters
            self.noise_ampls = None
        else:
            chi2 = final_chi2
            if self.noise_ampls is not None:
                # the loop's last prepared is the one the amplitudes
                # were solved against
                self._capture_noise_bases(prepared)
        self.resids = self._wideband_resids()
        self._attach_noise_resids()
        self.converged = True
        self.chi2_whitened = chi2
        if _fitquality_enabled() and iter_s:
            _record_fit_quality(
                self, chi2, int(r.shape[0]), nparam, cov=cov,
                rw=_host(r) / _host(sigma), method="wideband_gls",
                precision=precision, maxiter=maxiter)
        self._update_model_stats()
        # each iteration prepares again, so the prepare time is in
        # iteration_s and prepare_s is 0, as in the JAX package
        self.metrics = fit_metrics(t_start, 0.0, iter_s, self.toas,
                                   self.model, self.device)
        # the whitened/marginalized value, like GLSFitter's
        return chi2


class WidebandDownhillFitter(WidebandTOAFitter):
    """Step-halving wideband fit (reference:
    fitter.py::WidebandDownhillFitter)."""

    def fit_toas(self, maxiter=15, threshold=1e-12, min_lambda=1e-3,
                 tol=1e-9, raise_maxiter=False, precision="f64"):
        check_precision(precision)
        _reject_free_dm_noise(self.model)
        t_start = _wall(self.device)
        iter_s = []
        best_chi2 = None
        for _ in range(maxiter):
            t_it = time.perf_counter()
            prepared, combined, r, sigma, noff, x0, bases = \
                self._wideband_system()
            # one objective per outer iteration; line-search probes
            # marginalize the (fixed) bases on the device
            chi2_of = self._wideband_chi2_fn(prepared, bases, threshold)
            if best_chi2 is None:
                best_chi2 = chi2_of(x0)
            Mfull, sqrt_phi_inv, nparam = stack_noise_bases(
                combined.matrix, bases)
            dx_all, cov, _ = gls_solve(Mfull, r, sigma, sqrt_phi_inv,
                                       threshold, precision=precision)
            self.noise_ampls = (_host(dx_all[nparam:])
                                if bases[0] is not None else None)
            dx = dx_all[noff:nparam]
            lam = 1.0
            improved = False
            x_new = x0
            while lam >= min_lambda:
                chi2 = chi2_of(x0 - lam * dx)
                if chi2 <= best_chi2 + 1e-12:
                    improved = chi2 < best_chi2 - tol * max(1.0, best_chi2)
                    best_chi2 = min(best_chi2, chi2)
                    x_new = x0 - lam * dx
                    break
                lam *= 0.5
            self._sync_model_from_vector(prepared, x_new)
            cov_all = cov_from_normalized(*cov)
            self._set_uncertainties(prepared, cov_all[noff:nparam,
                                                      noff:nparam])
            iter_s.append(time.perf_counter() - t_it)
            if lam < min_lambda or not improved:
                break
        else:
            if raise_maxiter:
                self.metrics = fit_metrics(t_start, 0.0, iter_s, self.toas,
                                           self.model, self.device)
                raise MaxiterReached(maxiter, best_chi2)
        if self.noise_ampls is not None:
            self._capture_noise_bases(prepared)
        self.resids = self._wideband_resids()
        self._attach_noise_resids()
        self.converged = True
        self.chi2_whitened = best_chi2
        if _fitquality_enabled():
            _record_fit_quality(
                self, best_chi2, int(r.shape[0]), nparam, cov=cov,
                method="wideband_downhill", precision=precision,
                maxiter=maxiter)
        self._update_model_stats()
        self.metrics = fit_metrics(t_start, 0.0, iter_s, self.toas,
                                   self.model, self.device)
        return best_chi2


class WidebandLMFitter(WidebandTOAFitter):
    """Levenberg-Marquardt wideband fit (reference:
    fitter.py::WidebandLMFitter): the normalized normal matrix is
    damped by lm_lambda * diag, the damping adapted on chi2 acceptance
    and rejection; the covariance and the noise amplitudes come from
    one undamped solve at the accepted solution."""

    def fit_toas(self, maxiter=20, threshold=1e-12, lm_lambda0=1e-3,
                 tol=1e-9, precision="f64"):
        check_precision(precision)
        _reject_free_dm_noise(self.model)
        t_start = _wall(self.device)
        iter_s = []
        lm = lm_lambda0
        best_chi2 = self._wideband_chi2(threshold)
        for _ in range(maxiter):
            t_it = time.perf_counter()
            prepared, combined, r, sigma, noff, x0, bases = \
                self._wideband_system()
            Mfull, sqrt_phi_inv, nparam = stack_noise_bases(
                combined.matrix, bases)
            if precision == "mixed":
                # f32 Gram + refinement against the DAMPED f64 operator
                Mn, norm, q = gls_whiten(Mfull, sigma, sqrt_phi_inv)
                b = _mtv(Mn, r / sigma)
                A = gls_gram(Mn, q, "mixed")
                dA = torch.diagonal(A)
                A_damped = A + lm * torch.diag(dA)

                def damped_mv(v, _Mn=Mn, _q=q, _dA=dA, _lm=lm):
                    return (_mtv(_Mn, _mv(_Mn, v)) + (_q * _q) * v
                            + _lm * _dA * v)

                dxn = torch.linalg.solve(A_damped, b)
                for _r in range(2):
                    dxn = dxn + torch.linalg.solve(A_damped,
                                                   b - damped_mv(dxn))
                relres = (torch.linalg.norm(b - damped_mv(dxn))
                          / (torch.linalg.norm(b) + 1e-300)).item()
                if relres_failed(relres):
                    # gls_eigh_refine's contract on the damped system:
                    # the f32 Gram failed to precondition this step, so
                    # redo it with the f64 Gram (A also feeds the
                    # covariance below)
                    warnings.warn(
                        f"mixed-precision LM refinement did not "
                        f"converge (rel resid {relres:.2e}); solving "
                        "this step with the f64 Gram")
                    if _fitquality_enabled():
                        from .obs import fitquality as obs_fitq

                        obs_fitq.FITQ.note_fallback(["wideband_lm"])
                    A = gls_gram(Mn, q, "f64")
                    A_damped = A + lm * torch.diag(torch.diagonal(A))
                    dxn = torch.linalg.solve(A_damped, b)
            else:
                A, b, norm = gls_normal(Mfull, r, sigma, sqrt_phi_inv)
                A_damped = A + lm * torch.diag(torch.diagonal(A))
                dxn = torch.linalg.solve(A_damped, b)
            dx = (dxn / norm)[noff:nparam]
            self._sync_model_from_vector(prepared, x0 - dx)
            chi2 = self._wideband_chi2(threshold)
            iter_s.append(time.perf_counter() - t_it)
            if chi2 <= best_chi2 + 1e-12:
                accepted = chi2 < best_chi2 - tol * max(1.0, best_chi2)
                best_chi2 = min(best_chi2, chi2)
                lm = max(lm / 9.0, 1e-12)
                self._lm_cov = (A, norm, noff, nparam)
                if not accepted:
                    break
            else:
                self._sync_model_from_vector(prepared, x0)
                lm *= 11.0
                if lm > 1e6:
                    break
        if getattr(self, "_lm_cov", None) is not None:
            A, norm, noff, nparam = self._lm_cov
            covn = np.linalg.pinv(_host(A))
            cov_all = cov_from_normalized(covn, norm)
            prepared, combined, r, sigma, _, _, bases = \
                self._wideband_system()
            Mfull, sqrt_phi_inv, nparam2 = stack_noise_bases(
                combined.matrix, bases)
            dx_all, _, _ = gls_solve(Mfull, r, sigma, sqrt_phi_inv)
            self.noise_ampls = (_host(dx_all[nparam2:])
                                if bases[0] is not None else None)
            if self.noise_ampls is not None:
                self._capture_noise_bases(prepared)
            self._set_uncertainties(prepared, cov_all[noff:nparam,
                                                      noff:nparam])
        self.resids = self._wideband_resids()
        self._attach_noise_resids()
        self.converged = True
        self.chi2_whitened = best_chi2
        if _fitquality_enabled():
            # (covn, norm) exist exactly when a step was accepted
            _record_fit_quality(
                self, best_chi2, int(r.shape[0]), nparam,
                cov=((covn, norm)
                     if getattr(self, "_lm_cov", None) is not None
                     else None),
                method="wideband_lm", precision=precision,
                maxiter=maxiter)
        self._update_model_stats()
        self.metrics = fit_metrics(t_start, 0.0, iter_s, self.toas,
                                   self.model, self.device)
        return best_chi2


class PowellFitter(Fitter):
    """Derivative-free Powell minimization of chi2 (reference:
    fitter.py::PowellFitter): scipy's Powell drives from the host, the
    whitened chi2 is evaluated on the device."""

    def fit_toas(self, maxiter=2000, xtol=1e-8):
        from scipy.optimize import minimize

        _reject_free_dmjump(self.model)
        t_start = time.perf_counter()
        prepared = self._prepare()
        prep_s = time.perf_counter() - t_start
        resid_fn = prepared.residual_vector_fn(track_mode=self._track_mode())
        dm_fn, labels = prepared.designmatrix_fn()
        noff = _n_offset(labels)
        dev = prepared.device
        x0 = _host(prepared.vector_from_params())
        # scale each direction by its rough 1-sigma from the whitened
        # design matrix, so unit steps in z move chi2 by O(1)
        x0_t = torch.as_tensor(x0, device=dev)
        sigma_s0 = _host(prepared.scaled_sigma_us(
            prepared.params_with_vector(x0_t))) * 1e-6
        M = _host(dm_fn(x0_t))[:, noff:]
        f0 = float(prepared.params0["F"][0])
        colnorm = np.linalg.norm((M / f0) / sigma_s0[:, None], axis=0)
        scale = 1.0 / np.where(colnorm > 0, colnorm, 1.0)

        def chi2_of(z):
            x = torch.as_tensor(x0 + z * scale, device=dev)
            r = resid_fn(x)
            sig = prepared.scaled_sigma_us(
                prepared.params_with_vector(x)) * 1e-6
            return float(torch.sum(torch.square(r / sig)))

        res = minimize(chi2_of, np.zeros_like(x0), method="Powell",
                       options={"maxiter": maxiter, "xtol": xtol})
        self._sync_model_from_vector(prepared, x0 + res.x * scale)
        self.resids = self._residuals()
        self.converged = bool(res.success)
        self.metrics = fit_metrics(t_start, prep_s, [], self.toas,
                                   self.model, dev)
        self.metrics["n_evaluations"] = int(res.nfev)
        return self.resids.chi2


def auto_fitter(toas, model, device="cuda"):
    """Pick a fitter like the reference's Fitter.auto():
    WidebandDownhill for wideband TOAs (-pp_dm flags), else DownhillGLS
    with correlated noise and DownhillWLS without."""
    has_noise = any(c.kind == "noise" and c.category != "scale_toa_error"
                    for c in model.components.values())
    wideband = (toas.has_flags()
                and any("pp_dm" in f for f in toas.flags))
    if wideband:
        return WidebandDownhillFitter(toas, model, device=device)
    if has_noise:
        return DownhillGLSFitter(toas, model, device=device)
    return DownhillWLSFitter(toas, model, device=device)
