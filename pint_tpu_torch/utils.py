"""Cross-cutting helpers (torch counterpart of the JAX package's
``utils.py``).

(reference: src/pint/utils.py — taylor_horner, split_prefixed_name,
weighted_mean, FTest, PosVel algebra, dmx_ranges/dmxparse,
p_to_f/pferrs, ELL1_check, the WaveX helpers, the information criteria
and list_parameters.) ``taylor_horner``, ``taylor_horner_deriv`` and
``weighted_mean`` are torch; the rest is host numpy/str code as in the
JAX package. The functions that evaluate a model take ``device``.
"""

from __future__ import annotations

import re

import numpy as np
import torch

def taylor_horner(dt, coeffs):
    """sum_i coeffs[i] * dt^i / i! in plain f64, a tensor (reference:
    src/pint/utils.py::taylor_horner). The precision-critical spindown
    phase does not use it."""
    fact = 1.0
    facts = []
    for i in range(len(coeffs)):
        facts.append(fact)
        fact *= i + 1
    dt = torch.as_tensor(dt, dtype=torch.float64)
    result = torch.zeros_like(dt)
    for i in reversed(range(len(coeffs))):
        result = coeffs[i] / facts[i] + dt * result
    return result


def taylor_horner_deriv(dt, coeffs, deriv_order=1):
    """k-th derivative of taylor_horner (reference:
    utils.py::taylor_horner_deriv)."""
    if deriv_order >= len(coeffs):
        return torch.zeros_like(torch.as_tensor(dt, dtype=torch.float64))
    return taylor_horner(dt, coeffs[deriv_order:])


_PREFIX_RE = re.compile(r"^([A-Za-z_][A-Za-z0-9_]*?)(\d+)$")


def split_prefixed_name(name: str):
    """'F12' -> ('F', 12); 'DMX_0003' -> ('DMX_', 3). Raises ValueError otherwise.

    (reference: src/pint/utils.py::split_prefixed_name)
    """
    m = _PREFIX_RE.match(name)
    if not m:
        raise ValueError(f"{name!r} has no numeric suffix")
    return m.group(1), int(m.group(2))


def weighted_mean(x, sigma, axis=None):
    """Inverse-variance weighted mean (reference: utils.py::weighted_mean)."""
    w = 1.0 / torch.square(sigma)
    if axis is None:
        return torch.sum(x * w) / torch.sum(w)
    return torch.sum(x * w, dim=axis) / torch.sum(w, dim=axis)


def ftest(chi2_1, dof_1, chi2_2, dof_2):
    """F-test probability that the parameter addition is NOT needed.

    (reference: src/pint/utils.py::FTest). Returns the p-value of the
    F statistic for nested models; small p => added params significant.
    """
    from scipy.stats import f as fdist

    delta_chi2 = chi2_1 - chi2_2
    delta_dof = dof_1 - dof_2
    if delta_chi2 <= 0 or delta_dof <= 0 or dof_2 <= 0:
        return 1.0
    fstat = (delta_chi2 / delta_dof) / (chi2_2 / dof_2)
    return float(fdist.sf(fstat, delta_dof, dof_2))


class PosVel:
    """Position+velocity 3-vectors with frame bookkeeping.

    (reference: src/pint/utils.py::PosVel). Host-side numpy; device code
    consumes the raw arrays. pos/vel have shape (..., 3).
    """

    def __init__(self, pos, vel, origin=None, obj=None):
        self.pos = np.asarray(pos, dtype=np.float64)
        self.vel = np.asarray(vel, dtype=np.float64)
        self.origin = origin
        self.obj = obj

    def __add__(self, other: "PosVel") -> "PosVel":
        if self.obj is not None and other.origin is not None and self.obj != other.origin:
            if self.origin == other.obj:
                return other.__add__(self)
            raise ValueError(f"cannot chain {self.origin}->{self.obj} with {other.origin}->{other.obj}")
        return PosVel(self.pos + other.pos, self.vel + other.vel,
                      origin=self.origin, obj=other.obj)

    def __sub__(self, other: "PosVel") -> "PosVel":
        if (self.origin is not None and other.origin is not None
                and self.origin != other.origin):
            raise ValueError(
                f"cannot subtract vectors with origins {self.origin!r} and {other.origin!r}")
        return PosVel(self.pos - other.pos, self.vel - other.vel,
                      origin=other.obj, obj=self.obj)

    def __neg__(self):
        return PosVel(-self.pos, -self.vel, origin=self.obj, obj=self.origin)

    def __repr__(self):
        return f"PosVel({self.origin}->{self.obj}, pos~{self.pos.ravel()[:3]})"


# upstream spelling (reference: src/pint/utils.py::FTest)
FTest = ftest


def interesting_lines(lines, comments=("#", "C ")):
    """Strip blank/comment lines (reference: utils.py::interesting_lines)."""
    for line in lines:
        ls = line.strip()
        if not ls:
            continue
        if any(ls.startswith(c) for c in comments):
            continue
        yield ls


def compute_hash(*chunks) -> str:
    """Stable content hash for cache invalidation (reference: utils.py::compute_hash)."""
    import hashlib

    h = hashlib.sha256()
    for c in chunks:
        if isinstance(c, str):
            c = c.encode()
        h.update(c)
    return h.hexdigest()


def dmx_ranges(toas, binwidth_days=6.5):
    """Propose DMX windows covering the TOAs (reference:
    utils.py::dmx_ranges — greedy epoch binning; a window closes when
    the next TOA is more than binwidth away)."""
    if len(toas) == 0:
        raise ValueError("cannot propose DMX ranges for empty TOAs")
    mjds = np.sort(toas.get_mjds())
    ranges = []
    lo = hi = mjds[0]
    for m in mjds[1:]:
        if m - lo > binwidth_days:
            ranges.append((lo - 0.01, hi + 0.01))
            lo = hi = m
        else:
            hi = m
    ranges.append((lo - 0.01, hi + 0.01))
    return ranges


def dmxparse(fitter, save=None):
    """Collect fitted DMX values/uncertainties/epochs into arrays
    (reference: utils.py::dmxparse; the NANOGrav dmxparse.out
    convention).

    Returns a dict with keys dmxs, dmx_verrs, dmxeps, r1s, r2s, bins,
    mean_dmx. With ``save`` (a path, or True for "dmxparse.out"), also
    writes the text file: a header with the mean DMX, then one line per
    bin (epoch, value, error, R1, R2, label).
    """
    model = fitter.model
    comp = model.components.get("DispersionDMX")
    if comp is None:
        raise ValueError("model has no DispersionDMX component")
    dmxs, verrs, eps, r1s, r2s, bins = [], [], [], [], [], []
    for i in comp.dmx_ids:
        p = getattr(model, f"DMX_{i:04d}")
        r1 = getattr(model, f"DMXR1_{i:04d}").value
        r2 = getattr(model, f"DMXR2_{i:04d}").value
        dmxs.append(p.value or 0.0)
        verrs.append(p.uncertainty if p.uncertainty is not None else np.nan)
        r1s.append(r1)
        r2s.append(r2)
        eps.append(0.5 * ((r1 or 0.0) + (r2 or 0.0)))
        bins.append(f"DMX_{i:04d}")
    out = {
        "dmxs": np.array(dmxs),
        "dmx_verrs": np.array(verrs),
        "dmxeps": np.array(eps),
        "r1s": np.array(r1s, dtype=float),
        "r2s": np.array(r2s, dtype=float),
        "bins": bins,
        "mean_dmx": float(np.mean(dmxs)) if dmxs else np.nan,
    }
    if save:
        path = "dmxparse.out" if save is True else save
        with open(path, "w") as fh:
            fh.write("# Mean DMX value = %+.8e\n" % out["mean_dmx"])
            fh.write("# Columns: DMXEP DMX_value DMX_var_err DMXR1 "
                     "DMXR2 DMX_bin\n")
            for i in range(len(bins)):
                fh.write("%.4f %+.7e %.7e %.4f %.4f %s\n" % (
                    out["dmxeps"][i], out["dmxs"][i] - out["mean_dmx"],
                    out["dmx_verrs"][i], out["r1s"][i], out["r2s"][i],
                    bins[i]))
    return out


def p_to_f(p, pd=None, pdd=None):
    """Period (derivatives) -> frequency (derivatives); an involution
    (reference: utils.py::p_to_f). The arithmetic is
    derived_quantities.p_to_f's; with pd omitted it returns the 1-tuple
    (f,), so ``f, = p_to_f(p)`` unpacks."""
    from .derived_quantities import p_to_f as _p2f

    if pd is None:
        return (_p2f(p, 0.0)[0],)
    return _p2f(p, pd, pdd)


def pferrs(porf, porferr, pdorfd=None, pdorfderr=None):
    """Propagate uncertainties through the period<->frequency transform
    (reference: utils.py::pferrs; derived_quantities.pferrs's
    arithmetic)."""
    from .derived_quantities import pferrs as _pf

    return _pf(porf, porferr, pdorfd, pdorfderr)


def ELL1_check(A1, ECC, TRES_us, NTOA, outstring=True):
    """Is the ELL1 low-eccentricity approximation adequate? (reference:
    utils.py::ELL1_check). The neglected O(e^2) Roemer term has
    amplitude ~ (A1/c) e^2; ELL1 is fine when that is at most the
    weighted timing precision TRES/sqrt(NTOA). A1 in light-seconds,
    TRES in us."""
    lhs_us = A1 * ECC**2 * 1e6
    rhs_us = TRES_us / np.sqrt(max(NTOA, 1))
    ok = lhs_us <= rhs_us
    if not outstring:
        return ok
    rel = "<=" if ok else ">"
    return (f"ELL1 is {'ok' if ok else 'NOT ok'}: asini/c * ecc^2 = "
            f"{lhs_us:.3g} us {rel} TRES/sqrt(NTOA) = {rhs_us:.3g} us")


def _wavex_like_setup(model, comp_name, add_method, freq_prefix, T_span_days,
                      n_freqs=None, freqs=None):
    if (n_freqs is None) == (freqs is None):
        raise ValueError("give exactly one of n_freqs or freqs")
    if freqs is None:
        freqs = [(k + 1) / float(T_span_days) for k in range(n_freqs)]
    comp = model.components[comp_name]
    # continue after the HIGHEST existing index: a par file may define
    # a non-contiguous family (ids [2, 3]), and add_param overwrites on
    # a collision
    start = max(comp.wx_ids, default=0)
    for j, f in enumerate(freqs, start=start + 1):
        getattr(comp, add_method)(j, freq_per_day=float(f))
    model.setup()
    return [getattr(model, f"{freq_prefix}_{i:04d}").value
            for i in comp.wx_ids]


def wavex_setup(model, T_span_days, n_freqs=None, freqs=None):
    """Attach or extend a WaveX component with harmonics of 1/T_span
    (or explicit frequencies, 1/day) (reference: utils.py::wavex_setup).
    Returns the component's frequency list."""
    from .models.wave import WaveX

    if "WaveX" not in model.components:
        model.add_component(WaveX())
    return _wavex_like_setup(model, "WaveX", "add_wavex", "WXFREQ",
                             T_span_days, n_freqs, freqs)


def dmwavex_setup(model, T_span_days, n_freqs=None, freqs=None):
    """DMWaveX analog of wavex_setup (reference: utils.py::dmwavex_setup)."""
    from .models.wave import DMWaveX

    if "DMWaveX" not in model.components:
        model.add_component(DMWaveX())
    return _wavex_like_setup(model, "DMWaveX", "add_dmwavex", "DMWXFREQ",
                             T_span_days, n_freqs, freqs)


def cmwavex_setup(model, T_span_days, n_freqs=None, freqs=None):
    """CMWaveX analog of wavex_setup (reference: utils.py::cmwavex_setup);
    ChromaticCM rides along as the home of TNCHROMIDX."""
    from .models.chromatic import ChromaticCM, CMWaveX

    if "ChromaticCM" not in model.components:
        cm = ChromaticCM()
        cm.CM.value = 0.0
        model.add_component(cm)
    if "CMWaveX" not in model.components:
        model.add_component(CMWaveX())
    return _wavex_like_setup(model, "CMWaveX", "add_cmwavex", "CMWXFREQ",
                             T_span_days, n_freqs, freqs)


def translate_wave_to_wavex(model):
    """Convert a Wave component (harmonic pairs of WAVE_OM) into an
    equivalent WaveX component (reference:
    utils.py::translate_wave_to_wavex).

    Wave adds PHASE F0*sum[A sin(k w t) + B cos(k w t)] while WaveX adds
    DELAY sum[WXSIN sin + WXCOS cos] (phase -= F0*delay), so the
    amplitudes transfer with a sign flip; WXFREQ_k = k*WAVE_OM/(2 pi)
    per day.
    """
    from .models.wave import WaveX

    wave = model.components.get("Wave")
    if wave is None:
        raise ValueError("model has no Wave component")
    om = wave.WAVE_OM.value
    epoch = wave.WAVEEPOCH.value
    if "WaveX" in model.components:
        raise ValueError("model already has WaveX")
    wx = WaveX()
    model.add_component(wx)
    if epoch is not None:
        model.WXEPOCH.set_mjd(int(epoch), (epoch % 1) * 86400.0)
    for k, i in enumerate(wave.wave_ids, start=1):
        a, b = getattr(wave, f"WAVE{i}").value
        j = wx.add_wavex(freq_per_day=k * om / (2.0 * np.pi))
        getattr(model, f"WXSIN_{j:04d}").value = -a
        getattr(model, f"WXCOS_{j:04d}").value = -b
    model.remove_component("Wave")
    model.setup()
    return model


def translate_wavex_to_wave(model):
    """Inverse of translate_wave_to_wavex (reference:
    utils.py::translate_wavex_to_wave). The WaveX frequencies must be
    consecutive harmonics of the lowest one."""
    from .models.wave import Wave

    wx = model.components.get("WaveX")
    if wx is None:
        raise ValueError("model has no WaveX component")
    freqs = [getattr(model, f"WXFREQ_{i:04d}").value for i in wx.wx_ids]
    if not freqs:
        raise ValueError("WaveX has no terms")
    base = freqs[0]
    for k, f in enumerate(freqs, start=1):
        if abs(f - k * base) > 1e-9 * base:
            raise ValueError(
                "WaveX frequencies are not consecutive harmonics; "
                "cannot express as Wave")
    epoch = model.WXEPOCH.value
    if "Wave" in model.components:
        raise ValueError("model already has Wave")
    amps = [(-getattr(model, f"WXSIN_{i:04d}").value,
             -getattr(model, f"WXCOS_{i:04d}").value) for i in wx.wx_ids]
    model.remove_component("WaveX")
    wave = Wave()
    model.add_component(wave)
    model.WAVE_OM.value = 2.0 * np.pi * base
    if epoch is not None:
        model.WAVEEPOCH.set_mjd(int(epoch), (epoch % 1) * 86400.0)
    for a, b in amps:
        i = wave.add_wave()
        getattr(model, f"WAVE{i}").value = (a, b)
    model.setup()
    return model


def get_wavex_freqs(model, prefix="WXFREQ"):
    """Frequencies (1/day) of a WaveX-family component in index order
    (reference: utils.py::get_wavex_freqs)."""
    comp = {"WXFREQ": "WaveX", "DMWXFREQ": "DMWaveX",
            "CMWXFREQ": "CMWaveX"}[prefix]
    c = model.components[comp]
    return [getattr(model, f"{prefix}_{i:04d}").value for i in c.wx_ids]


def get_wavex_amps(model, sin_prefix="WXSIN", cos_prefix="WXCOS"):
    """(sin, cos) amplitude arrays of a WaveX-family component
    (reference: utils.py::get_wavex_amps)."""
    comp = {"WXSIN": "WaveX", "DMWXSIN": "DMWaveX",
            "CMWXSIN": "CMWaveX"}[sin_prefix]
    c = model.components[comp]
    s = np.array([getattr(model, f"{sin_prefix}_{i:04d}").value
                  for i in c.wx_ids])
    co = np.array([getattr(model, f"{cos_prefix}_{i:04d}").value
                   for i in c.wx_ids])
    return s, co


def plrednoise_to_wavex(model, toas=None, t_span_days=None):
    """Replace a PLRedNoise component by a WaveX with the same number
    of harmonics over the data span, amplitudes free (reference:
    utils.py::plrednoise_to_wavex).

    Give either ``toas`` (span from the data, + 1 day like the noise
    Fourier basis) or ``t_span_days``. Returns the model.
    """
    comp = model.components.get("PLRedNoise")
    if comp is None:
        raise ValueError("model has no PLRedNoise component")
    if (toas is None) == (t_span_days is None):
        raise ValueError("give exactly one of toas or t_span_days")
    if "WaveX" in model.components:
        raise ValueError(
            "model already has a WaveX component; merging the red-noise "
            "harmonics into it would mix frequency sets — remove one "
            "first")
    if toas is not None:
        mjds = toas.get_mjds()
        t_span_days = float(mjds.max() - mjds.min() + 1.0)
    n_harm = comp.n_harmonics()
    model.remove_component("PLRedNoise")
    wavex_setup(model, t_span_days, n_freqs=n_harm)
    for i in model.components["WaveX"].wx_ids:
        getattr(model, f"WXSIN_{i:04d}").frozen = False
        getattr(model, f"WXCOS_{i:04d}").frozen = False
    model.setup()
    return model


def wavex_to_plrednoise(model, t_span_days=None):
    """Fit a power law to a WaveX component's per-harmonic power and
    replace it by PLRedNoise (reference: utils.py::wavex_to_plrednoise).

    The per-harmonic variance phi_k = (WXSIN_k^2 + WXCOS_k^2)/2 [s^2]
    is matched to the enterprise-convention PSD integral
    phi(f) = A^2/(12 pi^2) (f/f_yr)^(-gamma) yr^3 / T_span by weighted
    least squares in log space (uncertainty-weighted when the
    amplitudes carry uncertainties). The WaveX frequencies must be
    consecutive harmonics of 1/T_span; T_span is inferred from the
    lowest frequency when not given.
    """
    wx = model.components.get("WaveX")
    if wx is None:
        raise ValueError("model has no WaveX component")
    ids = wx.wx_ids
    if len(ids) < 2:
        raise ValueError("need >= 2 WaveX harmonics to fit a power law")
    freqs_pd = np.array([getattr(model, f"WXFREQ_{i:04d}").value
                         for i in ids])
    # the power-law amplitude convention is defined over consecutive
    # harmonics k/T_span; a sparse or non-harmonic set would bias
    # TNREDAMP by the inferred-span factor
    base = freqs_pd[0]
    if not np.allclose(freqs_pd, np.arange(1, len(ids) + 1) * base,
                       rtol=1e-6):
        raise ValueError(
            "WaveX frequencies are not consecutive harmonics of the "
            "lowest one; cannot convert to PLRedNoise")
    if t_span_days is None:
        t_span_days = 1.0 / base
    f_hz = freqs_pd / 86400.0
    phi = np.empty(len(ids))
    wgt = np.ones(len(ids))
    for k, i in enumerate(ids):
        s = getattr(model, f"WXSIN_{i:04d}")
        c = getattr(model, f"WXCOS_{i:04d}")
        phi[k] = 0.5 * (s.value**2 + c.value**2)
        if s.uncertainty is not None and c.uncertainty is not None:
            # var of log phi ~ (2 s ds)^2 + (2 c dc)^2 over (2 phi)^2
            num = (s.value * s.uncertainty)**2 + (c.value * c.uncertainty)**2
            wgt[k] = (phi[k]**2) / num if num > 0 else 1.0
    good = phi > 0
    if good.sum() < 2:
        raise ValueError("WaveX amplitudes are all zero; nothing to fit")
    fyr = 1.0 / (365.25 * 86400.0)
    tspan_s = t_span_days * 86400.0
    # log phi = log[A^2/(12 pi^2) f_yr^gamma yr^3 / tspan] - gamma log f
    y = np.log(phi[good])
    xlg = np.log(f_hz[good] / fyr)
    w = wgt[good]
    W = np.sum(w)
    xm = np.sum(w * xlg) / W
    ym = np.sum(w * y) / W
    slope = np.sum(w * (xlg - xm) * (y - ym)) / np.sum(w * (xlg - xm)**2)
    gamma = -slope
    const = ym - slope * xm  # log phi at f = f_yr
    A2 = np.exp(const) * 12.0 * np.pi**2 * tspan_s * fyr**3
    log10_A = 0.5 * np.log10(A2)
    from .models.noise import PLRedNoise

    model.remove_component("WaveX")
    pl = PLRedNoise()
    model.add_component(pl)
    model.TNREDAMP.value = float(log10_A)
    model.TNREDGAM.value = float(gamma)
    model.TNREDC.value = len(ids)
    model.setup()
    return model


def _white_noise_lnlikelihood(model, toas, device="cuda"):
    """ln L for the information criteria, white noise only: a model
    with correlated noise (ECORR/red noise) is refused rather than
    mis-ranked (reference: utils.py::akaike_information_criterion's
    guard). The residuals run on ``device``."""
    from .fitter import CorrelatedErrors, _correlated_noise_components
    from .residuals import Residuals

    corr = _correlated_noise_components(model)
    if corr:
        raise CorrelatedErrors(corr)
    return Residuals(toas, model, device=device).lnlikelihood()


def akaike_information_criterion(model, toas, device="cuda"):
    """AIC = 2k - 2 ln L over the white-noise likelihood, k = free
    params + 1 (the implicit phase offset) (reference:
    utils.py::akaike_information_criterion)."""
    k = len(model.free_params) + 1
    return 2.0 * k - 2.0 * _white_noise_lnlikelihood(model, toas, device)


def bayesian_information_criterion(model, toas, device="cuda"):
    """BIC = k ln n - 2 ln L (reference:
    utils.py::bayesian_information_criterion)."""
    k = len(model.free_params) + 1
    return (k * float(np.log(len(toas)))
            - 2.0 * _white_noise_lnlikelihood(model, toas, device))


def list_parameters():
    """Catalog of every parameter of every registered component:
    [{name, component, kind, units, description, aliases}] (reference:
    utils.py::list_parameters).

    Every component module is imported first, so the registry is full;
    components whose parameter families are made per par-file line
    (glitches, jumps, EFAC/EQUAD masks, DMX windows, WaveX terms...)
    get one exemplar member, so the family appears in the catalog."""
    import importlib

    for mod in ("spindown", "astrometry", "dispersion", "chromatic",
                "solar_wind", "solar_system_shapiro", "troposphere",
                "glitch", "wave", "frequency_dependent", "ifunc",
                "piecewise", "jump", "phase_offset", "absolute_phase",
                "noise", "binary.bt", "binary.bt_piecewise", "binary.dd",
                "binary.ell1"):
        importlib.import_module(f"pint_tpu_torch.models.{mod}")
    from .models.timing_model import Component

    family_setup = {
        "Glitch": lambda c: c.add_glitch(1),
        "PhaseJump": lambda c: c.add_jump(),
        "DelayJump": lambda c: c.add_jump(),
        "DispersionJump": lambda c: c.add_dmjump(),
        "ScaleToaError": lambda c: [c.add_mask_param(k, ["1.0"])
                                    for k in ("EFAC", "EQUAD",
                                              "DMEFAC", "DMEQUAD")],
        "EcorrNoise": lambda c: c.add_mask_param(["0.5"]),
        "FD": lambda c: c.add_fd(1),
        "FDJump": lambda c: c.add_fdjump(1),
        "IFunc": lambda c: c.add_ifunc(1),
        "PiecewiseSpindown": lambda c: c.add_segment(1),
        "DispersionDMX": lambda c: c.add_dmx_range(1, 50000, 50001),
        "ChromaticCMX": lambda c: c.add_cmx_range(1, 50000, 50001),
        "SolarWindDispersionX": lambda c: c.add_swx_range(1, 50000, 50001),
        "Wave": lambda c: c.add_wave(1),
        "WaveX": lambda c: c.add_wavex(1),
        "DMWaveX": lambda c: c.add_dmwavex(1),
        "CMWaveX": lambda c: c.add_cmwavex(1),
        "ChromaticCM": lambda c: c.add_cmterm(1),
        "BinaryBTPiecewise": lambda c: c.add_piece(1, 50000, 50001),
    }
    rows = []
    for cname in sorted(Component.component_types):
        comp = Component.component_types[cname]()
        setup = family_setup.get(cname)
        if setup is not None:
            setup(comp)
        for pname in comp.params:
            par = getattr(comp, pname)
            rows.append({
                "name": pname, "component": cname, "kind": par.kind,
                "units": par.units, "description": par.description,
                "aliases": list(par.aliases),
            })
    return rows
