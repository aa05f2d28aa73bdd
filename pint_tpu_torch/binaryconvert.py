"""Binary-model conversion (ELL1 <-> DD/BT families, DD -> DDS/DDH).

(reference: src/pint/binaryconvert.py::convert_binary — transforms
parameters between binary parameterizations including uncertainty
propagation through the analytic Jacobians; the JAX package's
``binaryconvert.py``.) Host parameter arithmetic over the port's
``models.binary.add_binary_component``: nothing here touches a device.

ELL1 <-> DD mapping (Lange et al. 2001):
    ECC = sqrt(EPS1^2 + EPS2^2),  OM = atan2(EPS1, EPS2)
    T0  = TASC + OM/(2 pi) * PB
and inverse. The ELL1 expansion is valid for x e^2 << timing
precision; conversion outside that regime is allowed, as in the
reference, and the converted model then differs by O(x e^2).
"""

from __future__ import annotations

import copy

import numpy as np

from .constants import SECS_PER_JULIAN_YEAR
from .models.binary import add_binary_component

_TWO_PI = 2.0 * np.pi


def _strip_binary(model):
    out = copy.deepcopy(model)
    name = next(n for n in out.components if n.startswith("Binary"))
    comp = out.components[name]
    vals = {p: (getattr(comp, p).value, getattr(comp, p).uncertainty,
                getattr(comp, p).frozen) for p in comp.params}
    out.remove_component(name)
    return out, vals, type(comp).binary_model_name


def _apply(comp, vals, skip=()):
    for p, (v, u, fr) in vals.items():
        if p in skip or p not in comp.params or v is None:
            continue
        par = getattr(comp, p)
        par.value = v
        par.uncertainty = u
        par.frozen = fr


def convert_binary(model, output: str):
    """Return a new model with the binary component converted to the
    ``output`` parameterization (reference: binaryconvert.py::convert_binary)."""
    output = output.upper()
    out, vals, current = _strip_binary(model)
    keys = {}  # no prefix params carried through conversion by default
    for i in range(20):
        if f"FB{i}" in vals and vals[f"FB{i}"][0] is not None:
            keys[f"FB{i}"] = [repr(vals[f"FB{i}"][0])]
    comp = add_binary_component(out, output, keys)
    ell1_like = {"ELL1", "ELL1H", "ELL1K"}

    def _pb_days():
        pb = vals.get("PB", (None,))[0]
        if pb is not None:
            return pb
        fb0 = vals.get("FB0", (None,))[0]
        if fb0:
            return 1.0 / (fb0 * 86400.0)
        raise ValueError("binary model has neither PB nor FB0")

    if current in ell1_like and output not in ell1_like:
        e1, u1, _ = vals.get("EPS1", (0.0, None, True))
        e2, u2, _ = vals.get("EPS2", (0.0, None, True))
        e1, e2 = e1 or 0.0, e2 or 0.0
        ecc = float(np.hypot(e1, e2))
        om = float(np.arctan2(e1, e2) % _TWO_PI)
        pb = _pb_days()
        tasc = vals["TASC"][0]
        t0 = tasc + (om / _TWO_PI) * pb
        _apply(comp, vals, skip=("EPS1", "EPS2", "EPS1DOT", "EPS2DOT", "TASC"))
        comp.ECC.value = ecc
        comp.OM.value = np.rad2deg(om)
        comp.T0.value = t0
        # eccentricity-evolution terms map through the polar transform:
        # edot = (e1 e1dot + e2 e2dot)/e, omdot = (e2 e1dot - e1 e2dot)/e^2
        e1d = vals.get("EPS1DOT", (None,))[0]
        e2d = vals.get("EPS2DOT", (None,))[0]
        if (e1d or e2d) and ecc > 0:
            e1d, e2d = e1d or 0.0, e2d or 0.0
            comp.EDOT.value = (e1 * e1d + e2 * e2d) / ecc
            omdot_rad_s = (e2 * e1d - e1 * e2d) / ecc**2
            comp.OMDOT.value = np.rad2deg(omdot_rad_s) * SECS_PER_JULIAN_YEAR
        comp.ECC.frozen = vals.get("EPS1", (None, None, True))[2]
        comp.OM.frozen = comp.ECC.frozen
        comp.T0.frozen = vals.get("TASC", (None, None, True))[2]
        # uncertainty propagation (Jacobian of the polar transform)
        if u1 is not None or u2 is not None:
            u1, u2 = u1 or 0.0, u2 or 0.0
            if ecc > 0:
                comp.ECC.uncertainty = float(
                    np.hypot(e1 * u1, e2 * u2) / ecc)
                s_om = float(np.hypot(e2 * u1, e1 * u2) / ecc**2)
                comp.OM.uncertainty = np.rad2deg(s_om)
                ut = vals.get("TASC", (None, None, None))[1]
                comp.T0.uncertainty = float(np.hypot(
                    ut or 0.0, (s_om / _TWO_PI) * pb)) or None
    elif current not in ell1_like and output in ell1_like:
        ecc, ue, _ = vals.get("ECC", (0.0, None, True))
        om_deg, uo, _ = vals.get("OM", (0.0, None, True))
        ecc, om_deg = ecc or 0.0, om_deg or 0.0
        om = np.deg2rad(om_deg)
        eps1, eps2 = ecc * np.sin(om), ecc * np.cos(om)
        pb = _pb_days()
        t0 = vals["T0"][0]
        tasc = t0 - (om % _TWO_PI) / _TWO_PI * pb
        _apply(comp, vals, skip=("ECC", "OM", "EDOT", "OMDOT", "T0",
                                 "GAMMA", "DR", "DTH", "A0", "B0"))
        comp.EPS1.value = float(eps1)
        comp.EPS2.value = float(eps2)
        comp.TASC.value = float(tasc)
        # inverse mapping of eccentricity-evolution terms
        edot = vals.get("EDOT", (None,))[0]
        omdot = vals.get("OMDOT", (None,))[0]
        if (edot or omdot) and "EPS1DOT" in comp.params:
            edot = edot or 0.0
            omdot_rad_s = np.deg2rad(omdot or 0.0) / SECS_PER_JULIAN_YEAR
            comp.EPS1DOT.value = float(edot * np.sin(om)
                                       + ecc * np.cos(om) * omdot_rad_s)
            comp.EPS2DOT.value = float(edot * np.cos(om)
                                       - ecc * np.sin(om) * omdot_rad_s)
        comp.EPS1.frozen = comp.EPS2.frozen = vals.get("ECC", (None, None, True))[2]
        comp.TASC.frozen = vals.get("T0", (None, None, True))[2]
        if ue is not None or uo is not None:
            ue = ue or 0.0
            uo_r = np.deg2rad(uo or 0.0)
            comp.EPS1.uncertainty = float(np.hypot(np.sin(om) * ue,
                                                   ecc * np.cos(om) * uo_r))
            comp.EPS2.uncertainty = float(np.hypot(np.cos(om) * ue,
                                                   ecc * np.sin(om) * uo_r))
            ut = vals.get("T0", (None, None, None))[1]
            comp.TASC.uncertainty = float(np.hypot(
                ut or 0.0, (uo_r / _TWO_PI) * pb)) or None
    else:
        # within-family conversion (DD->DDS/DDK/DDGR, ELL1->ELL1H, ...):
        # shared params carry over, and reparameterized Shapiro terms are
        # DERIVED, not dropped (reference: binaryconvert.py computes
        # SHAPMAX / orthometric H3-H4-STIGMA in-family):
        #   DDS:   SHAPMAX = -ln(1 - SINI)
        #   ELL1H: STIGMA = SINI/(1 + cos i), H3 = Tsun*M2*STIGMA^3
        # and the inverses when leaving those parameterizations.
        skip = ()
        if output == "DDS":
            skip = ("SINI",)
        elif output in ("ELL1H", "DDH"):
            skip = ("M2", "SINI")
        _apply(comp, vals, skip=skip)
    # Shapiro reparameterizations apply across ALL branches (e.g.
    # ELL1H -> DD derives M2/SINI; DD -> ELL1H derives H3/STIGMA)
    _derive_shapiro_reparam(comp, vals, current, output)
    out.setup()
    return out


_TSUN_S = 4.925490947e-6  # GM_sun/c^3 [s]


def _shapiro_m2_sini(vals, current):
    """(m2, sini, u_m2, u_sini) in the source model's own terms, or None."""
    if current == "DDS":
        sm, us, _ = vals.get("SHAPMAX", (None, None, True))
        if sm is None:
            return None
        sini = 1.0 - np.exp(-sm)
        u_sini = (np.exp(-sm) * us) if us else None
        m2, um, _ = vals.get("M2", (None, None, True))
        return m2, sini, um, u_sini
    if current in ("ELL1H", "DDH"):
        h3, uh3, _ = vals.get("H3", (None, None, True))
        if not h3:
            return None
        st, ust, _ = vals.get("STIGMA", (None, None, True))
        if not st:  # unset OR placeholder 0.0: try the H4/H3 route
            h4, uh4, _ = vals.get("H4", (None, None, True))
            if not h4:
                return None
            st = h4 / h3
            if not st:
                return None
            ust = (np.hypot(uh4 or 0.0, st * (uh3 or 0.0)) / h3
                   if (uh4 or uh3) else None)
        sini = 2 * st / (1 + st**2)
        u_sini = (2 * (1 - st**2) / (1 + st**2) ** 2 * ust) if ust else None
        m2 = h3 / (_TSUN_S * st**3)
        um = (m2 * np.hypot((uh3 or 0.0) / h3, 3 * (ust or 0.0) / st)
              if (uh3 or ust) else None)
        return m2, sini, um, u_sini
    m2, um, _ = vals.get("M2", (None, None, True))
    sini, us, _ = vals.get("SINI", (None, None, True))
    if sini is None:
        return None
    return m2, sini, um, us


def _derive_shapiro_reparam(comp, vals, current, output):
    ms = _shapiro_m2_sini(vals, current)
    if ms is None:
        return
    m2, sini, um, usini = ms
    # frozen state follows whichever Shapiro parameter was actually SET
    # in the source model (DDS/ELL1H inherit an unset SINI whose default
    # frozen=True would otherwise always win)
    shap_frozen = True
    for cand in ("SINI", "SHAPMAX", "H3"):
        v = vals.get(cand)
        if v is not None and v[0] is not None:
            shap_frozen = v[2]
            break
    if output == "DDS":
        if sini is not None and sini < 1.0:
            comp.SHAPMAX.value = float(-np.log(1.0 - sini))
            comp.SHAPMAX.uncertainty = (
                float(usini / (1.0 - sini)) if usini else None)
            comp.SHAPMAX.frozen = shap_frozen
        # an orthometric source (DDH/ELL1H) carries no literal M2 for
        # _apply to copy — write the derived companion mass or the DDS
        # Shapiro range is silently zero
        if m2 is not None and "M2" in comp.params and comp.M2.value is None:
            comp.M2.value = float(m2)
            comp.M2.uncertainty = float(um) if um else None
            comp.M2.frozen = shap_frozen
    elif output in ("ELL1H", "DDH"):
        if sini is not None and m2 is not None and 0 < sini < 1.0:
            cosi = np.sqrt(1.0 - sini**2)
            st = sini / (1.0 + cosi)
            comp.STIGMA.value = float(st)
            comp.H3.value = float(_TSUN_S * m2 * st**3)
            comp.H3.frozen = comp.STIGMA.frozen = shap_frozen
            dst_dsini = 1.0 / (cosi * (1.0 + cosi)) if cosi > 0 else 0.0
            ust = (usini * dst_dsini) if usini else None
            comp.STIGMA.uncertainty = float(ust) if ust else None
            if um or ust:
                comp.H3.uncertainty = float(_TSUN_S * st**3 * np.hypot(
                    um or 0.0, 3 * m2 / st * (ust or 0.0)))
    elif current in ("DDS", "ELL1H", "DDH"):
        # leaving a reparameterized model: write plain M2/SINI if present
        if "SINI" in comp.params and sini is not None:
            comp.SINI.value = float(sini)
            comp.SINI.uncertainty = float(usini) if usini else None
            comp.SINI.frozen = shap_frozen
        if "M2" in comp.params and m2 is not None:
            comp.M2.value = float(m2)
            comp.M2.uncertainty = float(um) if um else None
