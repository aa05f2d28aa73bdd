"""Plotting helpers for photon data and residuals (Agg-safe).

(reference: src/pint/plot_utils.py — phaseogram, phaseogram_binned,
plot_priors; the JAX package's ``plot_utils.py``.) matplotlib is
imported when a function draws, never with the module, and the Agg
backend is chosen unless one is already in use. Tensors (on any
device) come to the host at each function's entry; the drawing is host
numpy.
"""

from __future__ import annotations

import numpy as np


def _host(a):
    """Host f64 numpy of a tensor or array-like (None stays None)."""
    if a is None:
        return None
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a, float)


def _plt():
    import matplotlib

    if matplotlib.get_backend().lower() not in ("agg",):
        try:
            matplotlib.use("Agg", force=False)
        except Exception:
            pass
    import matplotlib.pyplot as plt

    return plt


def phaseogram(mjds, phases, weights=None, bins=64, rotate=0.0, size=5,
               alpha=0.3, plotfile=None, title=None):
    """Photon phase vs time scatter with summed profile on top
    (reference: plot_utils.py::phaseogram). Phases are doubled to
    [0, 2) as is conventional."""
    plt = _plt()
    mjds, phases, weights = _host(mjds), _host(phases), _host(weights)
    ph = (phases + rotate) % 1.0
    fig, (ax0, ax1) = plt.subplots(
        2, 1, figsize=(6, 8), sharex=True,
        gridspec_kw={"height_ratios": [1, 3]})
    h, edges = np.histogram(ph, bins=bins, range=(0, 1), weights=weights)
    centers = 0.5 * (edges[:-1] + edges[1:])
    ax0.step(np.concatenate([centers, centers + 1.0]),
             np.concatenate([h, h]), where="mid")
    ax0.set_ylabel("Counts")
    if title:
        ax0.set_title(title)
    ph2 = np.concatenate([ph, ph + 1.0])
    t2 = np.concatenate([mjds, mjds])
    w2 = None if weights is None else np.concatenate([weights, weights])
    if w2 is None:
        ax1.scatter(ph2, t2, s=size, alpha=alpha)
    else:
        ax1.scatter(ph2, t2, s=size, alpha=alpha, c=w2, cmap="viridis")
    ax1.set_xlim(0, 2)
    ax1.set_xlabel("Pulse Phase")
    ax1.set_ylabel("MJD")
    fig.tight_layout()
    if plotfile:
        fig.savefig(plotfile, dpi=120)
        plt.close(fig)
        return plotfile
    return fig


def phaseogram_binned(mjds, phases, weights=None, bins=64, ntimebins=32,
                      plotfile=None, title=None):
    """2-D binned phaseogram (reference: plot_utils.py::phaseogram_binned)."""
    plt = _plt()
    mjds, phases, weights = _host(mjds), _host(phases), _host(weights)
    ph = phases % 1.0
    ph2 = np.concatenate([ph, ph + 1.0])
    t2 = np.concatenate([mjds, mjds])
    w2 = None if weights is None else np.concatenate([weights, weights])
    H, xe, ye = np.histogram2d(ph2, t2, bins=[2 * bins, ntimebins],
                               range=[[0, 2], [mjds.min(), mjds.max()]],
                               weights=w2)
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.imshow(H.T, origin="lower", aspect="auto",
              extent=[0, 2, mjds.min(), mjds.max()], cmap="magma")
    ax.set_xlabel("Pulse Phase")
    ax.set_ylabel("MJD")
    if title:
        ax.set_title(title)
    fig.tight_layout()
    if plotfile:
        fig.savefig(plotfile, dpi=120)
        plt.close(fig)
        return plotfile
    return fig


def plot_residuals(fitter, plotfile=None, title=None):
    """Pre/post-style residual plot for a fitted model."""
    plt = _plt()
    toas = fitter.toas
    r_us = _host(fitter.resids.time_resids) * 1e6
    mjd = toas.day + toas.sec / 86400.0
    fig, ax = plt.subplots(figsize=(8, 4.5))
    ax.errorbar(mjd, r_us, yerr=toas.error_us, fmt=".", ms=4)
    ax.axhline(0.0, color="0.6", lw=0.8)
    ax.set_xlabel("MJD")
    ax.set_ylabel("Residual (us)")
    if title:
        ax.set_title(title)
    fig.tight_layout()
    if plotfile:
        fig.savefig(plotfile, dpi=120)
        plt.close(fig)
        return plotfile
    return fig
