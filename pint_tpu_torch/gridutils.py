"""Grid search over fixed parameter values with a refit of the rest
(counterpart of the JAX package's ``gridutils.py``).

(reference: src/pint/gridutils.py — grid_chisq, grid_chisq_derived.)

The reference farms grid points out to a process pool; here a fixed
count of WLS steps (``fitter.wls_step``) is one function of the grid
point, and ``torch.func.vmap`` runs it over a chunk of points at once
on the fitter's device. The chunk has a fixed size (``GRID_CHUNK``
points): one vmap over a whole grid at full TOA counts would hold
points x columns x TOAs for every intermediate of the ``jacfwd``. Each
point's arithmetic is the same in any chunk, so the result does not
depend on the chunk size.
"""

from __future__ import annotations

import numpy as np
import torch

from . import DTYPE

GRID_CHUNK = 32  # grid points per vmap call


def _grid_fit_fn(fitter, parnames, maxiter=3, threshold=1e-12):
    """(grid values (k,) -> chi2) for one grid point, vmap-safe."""
    from .fitter import wls_step

    model = fitter.model
    # the grid parameters must be in the free-parameter vector to be
    # set per point: unfreeze them while preparing (they are pinned,
    # not refit)
    refrozen = []
    try:
        for p in parnames:
            par = getattr(model, p)
            if par.frozen:
                par.frozen = False
                refrozen.append(par)
        prepared = model.prepare(fitter.toas, device=fitter.device)
        # free_param_map reads the frozen flags live: keep the map of
        # the unfrozen model
        fpm_snapshot = prepared.free_param_map()
        fmap = [n for n, _, _ in fpm_snapshot]
        prepared.free_param_map = lambda: fpm_snapshot
    finally:
        for par in refrozen:
            par.frozen = True
    missing = set(parnames) - set(fmap)
    if missing:
        raise KeyError(f"parameters not in model free set: {missing}")
    grid_pos = {fmap.index(p): k for k, p in enumerate(parnames)}
    free_cols = [i for i in range(len(fmap)) if fmap[i] not in parnames]
    free_pos = {j: k for k, j in enumerate(free_cols)}
    resid_fn = prepared.residual_vector_fn()
    dm_fn, labels = prepared.designmatrix_fn()
    noff = 1 if labels and labels[0] == "Offset" else 0
    # design columns kept: the offset and the non-grid free parameters
    keep_cols = torch.as_tensor(
        np.concatenate([np.arange(noff), noff + np.asarray(free_cols, int)]
                       ).astype(np.int64), device=prepared.device)
    x0 = prepared.vector_from_params()
    f0 = prepared.params0["F"][0]

    def fit_point(gridvals):
        x = torch.stack([gridvals[grid_pos[j]] if j in grid_pos else x0[j]
                         for j in range(len(fmap))])
        for _ in range(maxiter):
            r = resid_fn(x)
            sigma = prepared.scaled_sigma_us(
                prepared.params_with_vector(x)) * 1e-6
            M = dm_fn(x)[:, keep_cols] / f0
            dx, _, _ = wls_step(M / sigma[:, None], r / sigma, threshold)
            x = torch.stack([x[j] - dx[noff + free_pos[j]] if j in free_pos
                             else x[j] for j in range(len(fmap))])
        r = resid_fn(x)
        sigma = prepared.scaled_sigma_us(prepared.params_with_vector(x)) * 1e-6
        return torch.sum(torch.square(r / sigma))

    return fit_point, prepared.device


def _chi2_over(fit_point, device, pts):
    """fit_point over the rows of pts, GRID_CHUNK rows per vmap call."""
    pts = torch.as_tensor(pts, dtype=DTYPE, device=device)
    v = torch.func.vmap(fit_point)
    out = [v(pts[i:i + GRID_CHUNK])
           for i in range(0, pts.shape[0], GRID_CHUNK)]
    return torch.cat(out).cpu().numpy()


def grid_chisq(fitter, parnames, parvalues, maxiter=3, threshold=1e-12):
    """chi2 over the outer-product grid of parvalues.

    parnames: sequence of free-parameter names to hold fixed;
    parvalues: same-length sequence of 1-D arrays. Returns an array of
    shape (len(v0), len(v1), ...) of chi2 with all OTHER free params
    refit at each point (reference: gridutils.py::grid_chisq; the
    'ncpu' knob is gone — vmap covers GRID_CHUNK points per call).
    """
    grids = np.meshgrid(*[np.asarray(v, float) for v in parvalues],
                        indexing="ij")
    shape = grids[0].shape
    pts = np.stack([g.ravel() for g in grids], axis=-1)
    fit_point, dev = _grid_fit_fn(fitter, list(parnames), maxiter, threshold)
    return _chi2_over(fit_point, dev, pts).reshape(shape)


def grid_chisq_derived(fitter, parnames, parfuncs, gridnames, gridvalues,
                       maxiter=3, threshold=1e-12):
    """Grid over derived quantities: parfuncs map grid coordinates to
    the model parameters in parnames
    (reference: gridutils.py::grid_chisq_derived).

    parfuncs[i](*gridpoint) -> value of parnames[i].
    """
    grids = np.meshgrid(*[np.asarray(v, float) for v in gridvalues],
                        indexing="ij")
    shape = grids[0].shape
    coords = np.stack([g.ravel() for g in grids], axis=-1)
    # the derived -> parameter map runs on the host (Python functions)
    pts = np.stack([[f(*c) for f in parfuncs] for c in coords],
                   axis=0).astype(float)
    fit_point, dev = _grid_fit_fn(fitter, list(parnames), maxiter, threshold)
    return _chi2_over(fit_point, dev, pts).reshape(shape)
