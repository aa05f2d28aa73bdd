"""Gravitational-wave detection over fleet fit outputs (counterpart of
the JAX package's ``gw/``).

The PTA end product is evidence for a gravitational-wave background in
the *inter-pulsar correlations* of post-fit timing residuals: an
isotropic GWB imprints the Hellings–Downs curve Gamma(xi) on the
cross-correlation of every pulsar pair as a function of their angular
separation xi.

Pipeline (host-orchestrated, the pair products on the card):

1. :mod:`residuals` — assemble per-pulsar post-fit residual/sigma
   arrays from a :class:`~pint_tpu_torch.parallel.pta.PTAFleet`
   (``PTABatch.gw_arrays``), sky unit vectors from the timing models,
   and regrid everything onto a common epoch lattice.
2. :mod:`correlate` — the O(P^2) all-pairs sweep as tiled matrix
   products over the lattice (kernels/paircorr.py: the f64 reference,
   or the hand-written Hopper kernel under ``precision="mixed"``),
   streamed through an upper-triangle pair-block fold.
3. :mod:`hd` — the Hellings–Downs curve and the frequentist optimal
   statistic, with significance calibrated by seeded sky-scramble /
   phase-shift null draws (``np.random.default_rng([seed, draw])``).

Entry points: ``PTAFleet.gw_stage()`` for fleets and ``python -m
pint_tpu_torch.gw`` for a synthetic injected demo.
"""

from . import correlate, hd, residuals  # noqa: F401
from .correlate import correlation_matrix, correlation_sweep  # noqa: F401
from .hd import (hd_curve, inject_gwb, isotropic_positions,  # noqa: F401
                 optimal_statistic, scramble_null)
from .residuals import (GWInputs, GWLattice, assemble, regrid,  # noqa: F401
                        regrid_append, sky_positions)

__all__ = [
    "GWInputs", "GWLattice", "assemble", "correlate", "correlation_matrix",
    "correlation_sweep", "hd", "hd_curve", "inject_gwb",
    "isotropic_positions", "optimal_statistic", "regrid", "regrid_append",
    "residuals", "scramble_null", "sky_positions",
]
