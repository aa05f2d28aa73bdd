"""TCB <-> TDB timing-model conversion (the JAX package's
``models/tcb_conversion.py``, which has no JAX in it, copied for the
port).

(reference: src/pint/models/tcb_conversion.py — convert_tcb_tdb,
scale_parameter, transform_mjd_parameter; CLI script tcb2tdb.)

TCB ticks faster than TDB by 1/(1-L_B), L_B = 1.550519768e-8 (IAU
2006 resolution B3). A par file fitted in TCB units converts to TDB
by scaling every parameter with net time dimension d by K^d
(K = 1/(1-L_B)) and mapping epochs through the linear relation pinned
at the IFTE epoch MJD 43144.0003725 (TAI 1977-01-01.0).

This is the same "multiply by K^d" rule tempo2's TRANSFORM and the
reference implement; like them, it does not re-fit — second-order
effects (e.g. DM vs frequency-scale coupling) are below the fit
uncertainties they are compared against.
"""

from __future__ import annotations

L_B = 1.550519768e-8
IFTE_MJD0 = 43144.0003725
IFTE_K = 1.0 / (1.0 - L_B)

# net time-dimension of each convertible parameter family:
# value_tdb = value_tcb * K**dim   (K = 1/(1-L_B) > 1)
# A frequency (s^-1) gets dim=+1; an interval (s) gets dim=-1.
_DIMS = {
    "F": lambda idx: idx + 1,     # F0 s^-1, F1 s^-2, ...
    "FB": lambda idx: idx + 1,    # FB0 s^-1, ...
    "PB": lambda idx: -1,
    "A1": lambda idx: -1,         # light-seconds
    "GAMMA": lambda idx: -1,
    "M2": lambda idx: -1,         # enters timing as TSUN*M2 seconds
    "MTOT": lambda idx: -1,
    "DM": lambda idx: 1 + idx,    # DMconst*DM has units of s*MHz^2 => +1;
                                  # DM1 (per-time derivative) one more
    "DMX_": lambda idx: 1,
    "NE_SW": lambda idx: +1,
    "PX": lambda idx: 0,
}

_EPOCHS = ("PEPOCH", "POSEPOCH", "DMEPOCH", "T0", "TASC", "TZRMJD",
           "WAVEEPOCH", "GLEP")


def scale_parameter(model, pname, dim, backwards=False):
    par = getattr(model, pname, None)
    if par is None or par.value is None:
        return
    k = IFTE_K ** (-dim if backwards else dim)
    par.value = par.value * k
    if par.uncertainty is not None:
        par.uncertainty = par.uncertainty * k


def transform_mjd_parameter(model, pname, backwards=False):
    par = getattr(model, pname, None)
    if par is None or par.value is None:
        return
    # MJD(TDB) = MJD0 + (MJD(TCB) - MJD0) / K
    f = IFTE_K if backwards else 1.0 / IFTE_K
    par.value = IFTE_MJD0 + (par.value - IFTE_MJD0) * f
    if par.uncertainty is not None:
        par.uncertainty = par.uncertainty * f


def convert_tcb_tdb(model, backwards=False):
    """In-place convert a TimingModel between TCB and TDB units
    (reference: tcb_conversion.py::convert_tcb_tdb). backwards=True
    goes TDB -> TCB."""
    from ..utils import split_prefixed_name

    for pname in list(model.params):
        if pname in _EPOCHS or (pname[:4] == "GLEP"):
            transform_mjd_parameter(model, pname, backwards)
            continue
        # exact name first: A1/M2 would otherwise be split into
        # ("A", 1)/("M", 2) and silently skipped
        if pname in _DIMS:
            prefix, idx = pname, 0
        else:
            try:
                prefix, idx = split_prefixed_name(pname)
            except ValueError:
                prefix, idx = pname, 0
        if prefix in _DIMS:
            scale_parameter(model, pname, _DIMS[prefix](idx), backwards)
    units = getattr(model, "UNITS", None)
    if units is not None:
        units.value = "TCB" if backwards else "TDB"
    return model
