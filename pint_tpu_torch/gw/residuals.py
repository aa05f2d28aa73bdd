"""GW input assembly: fleet fit outputs -> common-lattice arrays
(counterpart of the JAX package's ``gw/residuals.py``; host numpy).

The detection statistic consumes three things per pulsar: post-fit
residual seconds, their per-TOA weights, and the sky unit vector.
:func:`assemble` pulls all three from a fitted
:class:`~pint_tpu_torch.parallel.pta.PTAFleet` (``PTABatch.gw_arrays``
evaluates the fitted parameter vectors through the same phase/sigma
programs the fit used, for both regular and segment-packed buckets),
and :func:`regrid` bins every pulsar onto one shared epoch lattice so
the pair sweep becomes dense matrix products:

    W[p, m] = sum of 1/sigma^2 over pulsar p's TOAs in cell m
    z[p, m] = weighted mean residual of pulsar p in cell m

Cells a pulsar never observed carry W = 0 and drop out of every pair
product naturally (gw/correlate.py multiplies by W before summing),
so irregular cadences and disjoint observing spans need no masking
logic downstream.
"""

from __future__ import annotations

import numpy as np


class GWInputs:
    """Per-pulsar GW inputs in original fleet order: ``labels`` (P),
    ``pos`` (P, 3) sky unit vectors, and ragged per-pulsar ``times``
    (MJD), ``resid`` (seconds), ``weights`` (1/s^2) lists."""

    def __init__(self, labels, pos, times, resid, weights):
        self.labels = list(labels)
        self.pos = np.asarray(pos, np.float64)
        self.times = [np.asarray(t, np.float64) for t in times]
        self.resid = [np.asarray(r, np.float64) for r in resid]
        self.weights = [np.asarray(w, np.float64) for w in weights]

    @property
    def n_pulsars(self):
        return len(self.labels)


class GWLattice:
    """Common-lattice arrays the pair sweep consumes: ``z`` (P, M)
    weighted-mean residual per cell, ``w`` (P, M) total weight per
    cell (0 = pulsar never observed the cell), ``pos`` (P, 3),
    ``t_cells`` (M,) cell-center MJDs."""

    def __init__(self, labels, pos, z, w, t_cells):
        self.labels = list(labels)
        self.pos = np.asarray(pos, np.float64)
        self.z = np.asarray(z, np.float64)
        self.w = np.asarray(w, np.float64)
        self.t_cells = np.asarray(t_cells, np.float64)

    @property
    def n_pulsars(self):
        return self.z.shape[0]

    @property
    def n_cells(self):
        return self.z.shape[1]


def _unit_vector_equatorial(ra, dec):
    cd = np.cos(dec)
    return np.array([cd * np.cos(ra), cd * np.sin(ra), np.sin(dec)])


def sky_positions(models):
    """(P, 3) ICRS unit vectors from the timing models' astrometry
    (host-side par values, not fitted params: the GW geometry needs
    ~arcminute accuracy, far below any timing-fit position update).
    Ecliptic models rotate to equatorial with the model's own
    obliquity convention, matching ``ssb_to_psb_xyz``."""
    from ..models.astrometry import AstrometryEcliptic, AstrometryEquatorial

    out = np.empty((len(models), 3), np.float64)
    for i, model in enumerate(models):
        comp = None
        for c in model.components.values():
            if isinstance(c, (AstrometryEquatorial, AstrometryEcliptic)):
                comp = c
                break
        if comp is None:
            raise ValueError(
                f"model {i} has no astrometry component; GW "
                "correlations need sky positions (pass positions= "
                "explicitly to assemble/gw_stage)")
        if isinstance(comp, AstrometryEquatorial):
            out[i] = _unit_vector_equatorial(model.RAJ.value,
                                             model.DECJ.value)
        else:
            lon, lat = model.ELONG.value, model.ELAT.value
            cb = np.cos(lat)
            x, y, z = cb * np.cos(lon), cb * np.sin(lon), np.sin(lat)
            eps = comp.obliquity_rad()
            ce, se = np.cos(eps), np.sin(eps)
            out[i] = [x, ce * y - se * z, se * y + ce * z]
    return out


def assemble(fleet, xs, positions=None):
    """Per-pulsar GW inputs from a fitted fleet: evaluate each
    bucket's post-fit residuals/sigmas at the fitted vectors ``xs``
    (the ``fleet.fit()`` per-pulsar list) and collect sky positions.
    ``positions`` (P, 3) overrides the model astrometry."""
    n = fleet.n
    labels = [None] * n
    times = [None] * n
    resid = [None] * n
    weights = [None] * n
    pos = (np.asarray(positions, np.float64)
           if positions is not None else np.empty((n, 3)))
    if pos.shape != (n, 3):
        raise ValueError(f"positions shape {pos.shape} != ({n}, 3)")
    for key, idxs in fleet.group_indices.items():
        batch = fleet.batches[key]
        xb = np.stack([np.asarray(xs[i], np.float64) for i in idxs])
        arrays = batch.gw_arrays(xb)
        blabels = batch._pulsar_labels()
        if positions is None:
            pos[idxs] = sky_positions(batch.models)
        mask = arrays["mask"]
        sig_s = arrays["sigma_us"] * 1e-6
        for j, i in enumerate(idxs):
            m = mask[j]
            labels[i] = blabels[j]
            times[i] = arrays["mjd"][j][m]
            resid[i] = arrays["resid"][j][m]
            weights[i] = 1.0 / np.square(sig_s[j][m])
    return GWInputs(labels, pos, times, resid, weights)


def regrid(inputs, lattice_days=30.0, t0=None, t1=None):
    """Bin every pulsar onto one shared epoch lattice of
    ``lattice_days``-wide cells spanning the fleet's joint observing
    window. Weighted mean per cell: the zero-lag pair products then
    compare simultaneous residuals without per-pair interpolation."""
    if t0 is None:
        t0 = min(float(t[0]) for t in inputs.times if t.size)
    if t1 is None:
        t1 = max(float(t[-1]) for t in inputs.times if t.size)
    dt = float(lattice_days)
    n_cells = max(1, int(np.floor((t1 - t0) / dt)) + 1)
    P = inputs.n_pulsars
    w = np.zeros((P, n_cells))
    u = np.zeros((P, n_cells))
    for p in range(P):
        t, r, wt = inputs.times[p], inputs.resid[p], inputs.weights[p]
        cells = np.floor((t - t0) / dt).astype(np.int64)
        ok = (cells >= 0) & (cells < n_cells)
        np.add.at(w[p], cells[ok], wt[ok])
        np.add.at(u[p], cells[ok], wt[ok] * r[ok])
    with np.errstate(invalid="ignore"):
        z = np.where(w > 0, u / np.where(w > 0, w, 1.0), 0.0)
    t_cells = t0 + dt * (np.arange(n_cells) + 0.5)
    lat = GWLattice(inputs.labels, inputs.pos, z, w, t_cells)
    # raw weighted-residual accumulators, kept beside the derived z:
    # regrid_append updates (w, u) additively and re-derives z, which
    # is what makes an appended lattice bitwise-identical to a full
    # regrid of the concatenated inputs (z = u/w would not survive a
    # round-trip through z*w)
    lat.u = u
    return lat


def regrid_append(lattice, label, times, resid, weights):
    """Fold one pulsar's appended TOAs into an existing lattice: one
    row of the (P, M) lattice is updated in O(r) instead of re-running
    :func:`assemble` + :func:`regrid` over all P pulsars.

    Exact additive update: ``w' = w + dw``, ``u' = u + du`` with the
    per-cell ``np.add.at`` accumulation order identical to a full
    regrid of base-then-appended concatenated inputs, so the returned
    lattice's (w, u, z) are bitwise what :func:`regrid` would produce
    from scratch. Appended epochs past the current window GROW the
    lattice to the right (new cells start at zero weight for every
    other pulsar); epochs before the window raise — TOA streams append
    forward in time.

    Returns a NEW GWLattice (the input is not mutated: pair-sweep
    consumers may still hold it)."""
    if label not in lattice.labels:
        raise KeyError(f"unknown lattice pulsar {label!r}")
    p = lattice.labels.index(label)
    t = np.asarray(times, np.float64)
    r = np.asarray(resid, np.float64)
    wt = np.asarray(weights, np.float64)
    if lattice.t_cells.size > 1:
        dt = float(lattice.t_cells[1] - lattice.t_cells[0])
    else:
        raise ValueError("cannot infer cell width from a single-cell "
                         "lattice; re-run regrid")
    t0 = float(lattice.t_cells[0]) - dt / 2
    cells = np.floor((t - t0) / dt).astype(np.int64)
    if t.size and cells.min() < 0:
        raise ValueError("appended TOAs precede the lattice window; "
                         "streams append forward in time")
    n_cells = max(lattice.n_cells, (int(cells.max()) + 1) if t.size else 0)
    P = lattice.n_pulsars
    w = np.zeros((P, n_cells))
    u = np.zeros((P, n_cells))
    w[:, :lattice.n_cells] = lattice.w
    u[:, :lattice.n_cells] = getattr(lattice, "u", lattice.z * lattice.w)
    np.add.at(w[p], cells, wt)
    np.add.at(u[p], cells, wt * r)
    with np.errstate(invalid="ignore"):
        z = np.where(w > 0, u / np.where(w > 0, w, 1.0), 0.0)
    t_cells = t0 + dt * (np.arange(n_cells) + 0.5)
    out = GWLattice(lattice.labels, lattice.pos, z, w, t_cells)
    out.u = u
    return out
