"""TOA-axis sharding: one long pulsar's TOAs split over a mesh
(counterpart of the JAX package's ``parallel/toa_shard.py``).

Delays and phases are pointwise per TOA, so each shard evaluates its own
rows on its own device with no communication. The only cross-TOA
couplings are the weighted mean of the residuals, the exponent-safe
column norms and the normal equations A = sum MnᵀMn, b = sum Mnᵀz.
Where the JAX package ``psum``s them inside one ``shard_map`` program,
the port runs one program per shard and adds the partials in shard
order on the first shard's device (``mesh.ordered_sum``): a fixed
reduction order, no atomics, so a sharded fit repeats bitwise. The
small (k x k) prior-folded eigh solve then runs there, and the new
parameter vector goes back to every shard.

The design of a shard is the jacobian of its residuals, which hold the
GLOBAL weighted mean: each shard differentiates its own pieces (the
phase fractions, its partial sums sum(frac w) and sum(w), and F0), and
the chain rule through the mean and the division by F0 is applied after
the partial jacobians are summed, in the order of JAX's
forward-mode rules for a quotient.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import DTYPE, autodiff
from ..models.timing_model import _overlay_params, host_to_device
from ..toa import TOABatch
from .mesh import ordered_max, ordered_sum


def _data_spec(x, n_rows, key=None):
    """Which dimension of ``x`` carries the TOA axis (None: none, the
    array is copied whole to every shard). A prep array's dimension
    comes from its known layout (``pta._toa_axis``) when ``key`` is
    given; otherwise the first dimension of length ``n_rows``, the JAX
    package's by-shape rule."""
    from .pta import _toa_axis

    shape = tuple(getattr(x, "shape", np.shape(x)))
    if not shape:
        return None
    if key is not None:
        dim = _toa_axis(key)
        return dim if dim is not None and shape[dim] == n_rows else None
    for i, s in enumerate(shape):
        if s == n_rows:
            return i
    return None


def _shard_devices(mesh, axis):
    """The devices a TOA axis is split over: the mesh's ``axis``, or
    every device of a mesh without one."""
    if axis in mesh.shape and mesh.devices.ndim == 1:
        return list(mesh.devices)
    return list(mesh.devices.reshape(-1))


def _split(fields, arrays, n_rows, devices):
    """Cut one pulsar's TOA fields (a TOABatch or a dict of its fields)
    and prep arrays (numpy or tensors) into contiguous equal row
    blocks, one per device: [(batch, prep)] on those devices."""
    if n_rows % len(devices):
        raise ValueError(f"{n_rows} TOA rows do not split evenly over "
                         f"{len(devices)} shards; pad them first")
    if isinstance(fields, TOABatch):
        fields = fields._asdict()
    w = n_rows // len(devices)
    out = []
    for j, dev in enumerate(devices):
        rows = slice(j * w, (j + 1) * w)

        def cut(a, dim):
            if dim is None:
                return a
            idx = [slice(None)] * len(a.shape)
            idx[dim] = rows
            return a[tuple(idx)]

        batch = TOABatch(**{
            f: torch.as_tensor(cut(fields[f], 1 if f == "planet_pos_ls"
                                   else 0), dtype=DTYPE).to(dev)
            for f in TOABatch._fields})
        prep = host_to_device(
            {k: cut(v, _data_spec(v, n_rows, key=k))
             for k, v in arrays.items()}, dev)
        out.append((batch, prep))
    return out


def _pull(tensors, watchdog_s, what):
    """Device->host copy of the fit results, bounded by the watchdog
    (None: a plain blocking copy). The copy is where a wedged device
    blocks the caller, so it is the one site that needs the bound."""
    def get():
        return [t.detach().cpu().numpy() for t in tensors]

    if watchdog_s is None:
        return get()
    from .fleetmesh import run_watched

    return run_watched(get, watchdog_s, what=what)


class _Shards:
    """One pulsar's rows over the shard devices (``parts``, from
    :func:`_split`), with the per-shard pieces every entry point
    needs."""

    def __init__(self, model, static, params, fmap, parts):
        from .pta import pure_phase_fn, pure_sigma_fn

        self.parts = parts
        self.devices = [b.tdb_sec.device for b, _ in parts]
        self.dev0 = self.devices[0]
        self.static = static
        self.phase = pure_phase_fn(model, static)
        self.sigma = pure_sigma_fn(model, static)
        self.fmap = tuple(fmap)
        self.params = [{k: torch.as_tensor(v).to(dev)
                        for k, v in params.items()} for dev in self.devices]

    def overlay(self, j, x):
        return _overlay_params(x.to(self.devices[j]), self.params[j],
                               self.fmap)

    def pieces(self, j, x):
        """Shard j's (frac, sum(frac w), sum(w), F0, sigma [s])."""
        batch, prep = self.parts[j]
        p = self.overlay(j, x)
        ph = self.phase(p, batch, prep)
        frac = ph - torch.floor(ph + 0.5)
        sig = self.sigma(p, batch, prep) * 1e-6
        w = 1.0 / torch.square(sig)
        return frac, torch.sum(frac * w), torch.sum(w), p["F"][0], sig

    def mean(self, parts):
        """Global weighted mean of the phase fractions (on dev0)."""
        sw = ordered_sum([p[1] for p in parts], self.dev0)
        tw = ordered_sum([p[2] for p in parts], self.dev0)
        return sw / tw

    def residuals(self, x):
        """Per-shard (residual seconds, sigma [s]) at x."""
        parts = [self.pieces(j, x) for j in range(len(self.devices))]
        mean = self.mean(parts)
        return [((frac - mean.to(frac.device)) / f0, sig)
                for frac, _, _, f0, sig in parts]

    def design(self, x):
        """Per-shard (r, M with its offset column, sigma) at x: each
        shard's partial jacobians, then the chain rule through the
        global mean and the division by F0."""
        outs = []
        for j in range(len(self.devices)):
            xj = x.to(self.devices[j])
            vals = self.pieces(j, xj)
            jac = autodiff.jacfwd(lambda xv, j=j: self.pieces(j, xv)[:4])(xj)
            outs.append((vals, jac))
        S = ordered_sum([v[1] for v, _ in outs], self.dev0)
        T = ordered_sum([v[2] for v, _ in outs], self.dev0)
        dS = ordered_sum([jac[1] for _, jac in outs], self.dev0)
        dT = ordered_sum([jac[2] for _, jac in outs], self.dev0)
        mean = S / T
        dmean = dS / T - dT * S / torch.square(T)
        shards = []
        for (frac, _, _, f0, sig), (dfrac, _, _, df0) in outs:
            dev = frac.device
            num = frac - mean.to(dev)
            dnum = dfrac - dmean.to(dev)[None, :]
            M = dnum / f0 - df0[None, :] * num[:, None] / torch.square(f0)
            M = torch.cat([torch.ones_like(M[:, :1]), M], dim=1)
            shards.append((num / f0, M, sig))
        return shards


def _global_colnorms(Mws, dev0):
    """Exponent-safe column norms over every shard's rows (see
    fitter.column_norms): the peak scale by an ordered max, then the
    ordered sum of squares."""
    amax = ordered_max([torch.amax(torch.abs(m), dim=0) for m in Mws], dev0)
    amax = torch.where(amax == 0, 1.0, amax)
    ss = ordered_sum([torch.sum(torch.square(m / amax.to(m.device)), dim=0)
                      for m in Mws], dev0)
    return amax * torch.where(ss == 0, 1.0, torch.sqrt(ss))


def sharded_residuals(template_model, static, mesh, params, batch, prep,
                      axis="toa"):
    """Residual seconds with the TOA axis sharded over ``mesh`` (the JAX
    package's signature: one pulsar's params, TOABatch and prep, static
    config apart). The TOA arrays are cut into one row block per device
    (the row count must split evenly); params go whole to every shard.
    The weighted mean over every shard's rows is subtracted (two ordered
    sums). Returns the residuals gathered in row order on the first
    shard's device."""
    n_toa = int(batch.tdb_sec.shape[0])
    parts = _split(batch, prep, n_toa, _shard_devices(mesh, axis))
    sh = _Shards(template_model, static, params, (), parts)
    with torch.no_grad():
        parts = sh.residuals(torch.zeros(0, dtype=DTYPE))
        return torch.cat([r.to(sh.dev0) for r, _ in parts])


def sharded_chi2(template_model, static, mesh, params, batch, prep,
                 axis="toa"):
    """Whitened chi2 with the TOA-sharded residuals: sigma is evaluated
    on the original (unsharded) inputs and the sum runs on the host, as
    in the JAX package."""
    from .pta import pure_sigma_fn

    r = sharded_residuals(template_model, static, mesh, params, batch, prep,
                          axis)
    with torch.no_grad():
        sig = pure_sigma_fn(template_model, static)(params, batch, prep)
    sig = sig.detach().cpu().numpy() * 1e-6
    return float(np.sum(np.square(r.cpu().numpy() / sig)))


def sharded_gls_fit(model, toas, mesh, maxiter=2, threshold=1e-12,
                    axis="toa", precision="f64", compile_timings=None,
                    watchdog_s=None):
    """Single-pulsar GLS fit with the TOA axis sharded over ``mesh`` —
    the path for a pulsar whose TOA count outgrows one device.

    Per shard: local residuals, the local design block (see the module
    docstring for the mean's chain rule) and the local noise-basis rows
    (ECORR epochs enter as basis columns, whose sums are exact wherever
    an epoch's rows fall, so epochs may straddle shards). Cross-shard:
    the weighted mean, the column norms (ordered max + sum) and A =
    sum MnᵀMn, b = sum Mnᵀz in shard order; the prior-folded eigh solve
    runs on the first shard's device.

    ``precision="mixed"`` forms each shard's Gram block in f32 (a plain
    f32 ``torch.matmul``, TF32 off; the JAX package computes it with
    ``jnp``, not a Pallas kernel), sums the blocks in f64, and recovers
    f64 accuracy by iterative refinement against the exact f64 matvec
    (two products per shard and one ordered sum a step), falling back
    to f64 with a warning when the refinement does not contract.

    Hoist guard, as in the JAX package: in f64, with a noise model and
    every noise / sigma-scaling parameter frozen, the whitened basis
    columns, their Gram, the norms and sigma are constants of the fit:
    one pass computes them, and each iteration rebuilds only the
    timing-parameter block. Mixed keeps the unhoisted step.

    ``compile_timings``: a dict that receives, per step program
    ("pre_step", "step_h" or "step"), {trace_s, backend_compile_s}: the
    host wall of building the per-shard closures, and 0.0, since the
    sharded steps run eagerly (nothing is captured). ``watchdog_s``
    bounds the final device->host pull (``fleetmesh.run_watched``),
    raising ``fleetmesh.CollectiveTimeout`` instead of blocking on a
    wedged device.

    Returns (x, whitened_chi2, cov) as numpy, matching
    ``fitter.GLSFitter`` on the same data.
    """
    import warnings

    from ..fitter import (_reject_free_dmjump, check_precision,
                          cov_from_normalized, gls_eigh_refine,
                          gls_eigh_solve, relres_failed)

    from .pta import _pad_single

    check_precision(precision)
    _reject_free_dmjump(model)
    devices = _shard_devices(mesh, axis)
    t_build = time.perf_counter()
    prepared = model.prepare(toas, device="cpu")
    n = prepared.batch.n_toas
    n_pad = ((n + len(devices) - 1) // len(devices)) * len(devices)
    fields, arrays, static = _pad_single(prepared, n_pad)
    sh = _Shards(model, static, prepared.params0,
                 prepared.free_param_map(),
                 _split(fields, arrays, n_pad, devices))
    dev0 = sh.dev0
    noise_comps = [c for c in model.components.values()
                   if getattr(c, "basis_weight", None) is not None]
    nparam = len(sh.fmap) + 1  # + offset column
    x0 = prepared.vector_from_params().to(dev0)
    free_names = {n for n, _, _ in sh.fmap}
    noise_param_names = set()
    for c in model.components.values():
        if (getattr(c, "basis_weight", None) is not None
                or getattr(c, "scale_sigma", None) is not None):
            noise_param_names.update(c.params)
    hoist = (precision == "f64" and bool(noise_comps)
             and not (free_names & noise_param_names))

    def noise_bases(j, x):
        """Shard j's noise-basis rows and the columns' prior sqrt
        inverses (None when the model has no basis columns)."""
        batch, prep = sh.parts[j]
        p = sh.overlay(j, x)
        full = {**prep, **sh.static}
        Bs, ws = [], []
        for c in noise_comps:
            B, w_us2 = c.basis_weight(p, full)
            if B.shape[1]:
                Bs.append(B)
                ws.append(w_us2)
        if not Bs:
            return None, None
        w = torch.cat(ws)
        spi = torch.where(w > 0, 1.0 / (torch.sqrt(torch.where(w > 0, w, 1.0))
                                        * 1e-6), 0.0)
        return torch.cat(Bs, dim=1), spi

    def finish(x, A, b, rw2, norm, solve):
        dxn, covn, relres = solve(A, b)
        chi2 = rw2 - b @ dxn
        dx = dxn / norm
        return (x - dx[1:nparam], chi2, covn[1:nparam, 1:nparam],
                norm[1:nparam], relres)

    def step(x):
        shards = sh.design(x)
        bases = [noise_bases(j, x) for j in range(len(devices))]
        Ms, sigs, rs = [], [], []
        spi = torch.zeros(nparam, dtype=DTYPE, device=dev0)
        for (r, M, sig), (B, s) in zip(shards, bases):
            if B is not None:
                M = torch.cat([M, B], dim=1)
            Ms.append(M / sig[:, None])
            sigs.append(sig)
            rs.append(r)
        if bases[0][1] is not None:
            spi = torch.cat([spi, bases[0][1].to(dev0)])
        norm = torch.hypot(_global_colnorms(Ms, dev0), spi)
        q = spi / norm
        Mns = [m / norm.to(m.device) for m in Ms]
        zs = [r / s for r, s in zip(rs, sigs)]
        b = ordered_sum([m.mT @ z for m, z in zip(Mns, zs)], dev0)
        rw2 = ordered_sum([torch.sum(torch.square(z)) for z in zs], dev0)
        if precision == "mixed":
            # per-shard Gram in f32, the blocks summed in f64
            A = ordered_sum([(m.float().mT @ m.float()).double()
                             for m in Mns], dev0) + torch.diag(q * q)

            def matvec(v):
                return ordered_sum(
                    [m.mT @ (m @ v.to(m.device)) for m in Mns],
                    dev0) + (q * q) * v

            return finish(x, A, b, rw2, norm,
                          lambda A, b: gls_eigh_refine(A, b, matvec,
                                                       threshold))
        A = ordered_sum([m.mT @ m for m in Mns], dev0) + torch.diag(q * q)
        return finish(x, A, b, rw2, norm,
                      lambda A, b: (*gls_eigh_solve(A, b, threshold),
                                    torch.zeros((), dtype=DTYPE,
                                                device=dev0)))

    def pre_step():
        """One sharded pass for the x-independent pieces (hoist)."""
        sigs = [sh.pieces(j, x0)[4] for j in range(len(devices))]
        bases = [noise_bases(j, x0) for j in range(len(devices))]
        Bw = [B / s[:, None] for (B, _), s in zip(bases, sigs)]
        spi = bases[0][1].to(dev0)
        normB = torch.hypot(_global_colnorms(Bw, dev0), spi)
        Bn = [b_ / normB.to(b_.device) for b_ in Bw]
        FtF = ordered_sum([b_.mT @ b_ for b_ in Bn], dev0)
        return Bn, sigs, FtF, normB, spi / normB

    def step_hoisted(x, Bn, sigs, FtF, normB, qB):
        shards = sh.design(x)
        # sigma is constant under the hoist: the pre-pass's
        Ms = [M / s[:, None] for (_, M, _), s in zip(shards, sigs)]
        normM = _global_colnorms(Ms, dev0)
        Mps = [m / normM.to(m.device) for m in Ms]
        zs = [r / s for (r, _, _), s in zip(shards, sigs)]
        b = torch.cat([ordered_sum([m.mT @ z for m, z in zip(Mps, zs)], dev0),
                       ordered_sum([b_.mT @ z for b_, z in zip(Bn, zs)],
                                   dev0)])
        rw2 = ordered_sum([torch.sum(torch.square(z)) for z in zs], dev0)
        App = ordered_sum([m.mT @ m for m in Mps], dev0)
        ApB = ordered_sum([m.mT @ b_ for m, b_ in zip(Mps, Bn)], dev0)
        q = torch.cat([torch.zeros(nparam, dtype=DTYPE, device=dev0), qB])
        A = torch.cat([torch.cat([App, ApB], dim=1),
                       torch.cat([ApB.mT, FtF], dim=1)]) + torch.diag(q * q)
        norm = torch.cat([normM, normB])
        return finish(x, A, b, rw2, norm,
                      lambda A, b: (*gls_eigh_solve(A, b, threshold),
                                    torch.zeros((), dtype=DTYPE,
                                                device=dev0)))

    build_s = time.perf_counter() - t_build
    x = x0
    relres_hist = []
    with torch.no_grad():
        if hoist:
            if compile_timings is not None:
                for name in ("pre_step", "step_h"):
                    compile_timings[name] = {"trace_s": build_s,
                                             "backend_compile_s": 0.0}
            pre = pre_step()
            for _ in range(maxiter):
                x, chi2, covn, norm, _ = step_hoisted(x, *pre)
            what = "sharded_gls_fit hoisted"
        else:
            if compile_timings is not None:
                compile_timings["step"] = {"trace_s": build_s,
                                           "backend_compile_s": 0.0}
            for _ in range(maxiter):
                x, chi2, covn, norm, relres = step(x)
                # every iteration's residual is checked: an early
                # non-contraction corrupts x even when the final solve
                # happens to converge
                relres_hist.append(float(relres))
            what = "sharded_gls_fit"
        x, chi2, covn, norm = _pull((x, chi2, covn, norm), watchdog_s, what)
    if precision == "mixed" and relres_failed(relres_hist):
        warnings.warn(
            f"mixed-precision sharded GLS refinement did not converge "
            f"(worst rel resid {np.max(relres_hist):.2e}); "
            "refitting in f64")
        return sharded_gls_fit(model, toas, mesh, maxiter=maxiter,
                               threshold=threshold, axis=axis,
                               precision="f64",
                               compile_timings=compile_timings,
                               watchdog_s=watchdog_s)
    return x, float(chi2), cov_from_normalized(covn, norm)
