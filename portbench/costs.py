"""The benchmark's own count of the work: the FLOP count of one refit
over each pulsar's real TOAs and its own columns.

Refit (the arithmetic of pint_tpu_torch/obs/costmodel.py's
``normal_equations_cost``, over real rows): per iteration and pulsar of
n TOAs and k columns (the offset, the free parameters and the red-noise
basis; ECORR is marginalised, not a column): the Gram 2 n k^2, the
right-hand side 2 n k, chi2 2 n, the eigendecomposition 9 k^3.
"""

from __future__ import annotations

EIGH_FLOPS_PER_K3 = 9


def pulsar_columns(par_values, n_free):
    """A pulsar's columns: the offset, its free parameters and its
    red-noise basis, two per harmonic."""
    red = "RNAMP" in par_values or "TNREDAMP" in par_values
    return 1 + n_free + (2 * int(par_values.get("TNREDC", 30)) if red else 0)


def refit_flops(shapes, maxiter):
    """FLOPs of one refit: ``shapes`` [(n TOAs, k columns)] per pulsar."""
    per_iter = sum(2 * n * k * k + 2 * n * k + 2 * n
                   + EIGH_FLOPS_PER_K3 * k ** 3 for n, k in shapes)
    return float(maxiter * per_iter)
