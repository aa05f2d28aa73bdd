"""Par file -> TimingModel construction (the JAX package's
``models/builder.py``).

(reference: src/pint/models/model_builder.py — parse par lines, resolve
aliases, choose components from content (BINARY line, DMX_* ->
DispersionDMX, GLEP_* -> Glitch, ...), report unrecognized lines.)

The tempo1 P0/P1/P2 spin spelling is converted to F0/F1/F2 on load
with a warning, in the JAX package's plain-float arithmetic.
"""

from __future__ import annotations

import io
import math
import os
import re
import warnings

from ..utils import interesting_lines, split_prefixed_name
from .absolute_phase import AbsPhase
from .astrometry import AstrometryEcliptic, AstrometryEquatorial
from .binary import add_binary_component, choose_t2_model
from .chromatic import ChromaticCM, ChromaticCMX, CMWaveX
from .dispersion import DispersionDM, DispersionDMX, DispersionJump
from .frequency_dependent import FD, FDJump
from .glitch import Glitch
from .ifunc import IFunc
from .jump import PhaseJump
from .noise import (EcorrNoise, PLChromNoise, PLDMNoise, PLRedNoise,
                    PLSWNoise, ScaleToaError)
from .parameter import MJDParameter, floatParameter, strParameter
from .phase_offset import PhaseOffset
from .piecewise import PiecewiseSpindown
from .solar_system_shapiro import SolarSystemShapiro
from .solar_wind import SolarWindDispersion, SolarWindDispersionX
from .spindown import Spindown
from .timing_model import TimingModel
from .troposphere import TroposphereDelay
from .wave import DMWaveX, Wave, WaveX

# par-file key aliases -> canonical names (reference: each Parameter's aliases)
ALIASES = {
    "E": "ECC", "PSRJ": "PSR", "PSRB": "PSR", "DEC": "DECJ", "RA": "RAJ",
    "LAMBDA": "ELONG", "BETA": "ELAT", "PMLAMBDA": "PMELONG", "PMBETA": "PMELAT",
    "CLK": "CLOCK", "T2EFAC": "EFAC", "T2EQUAD": "EQUAD", "NE1AU": "NE_SW",
    "SOLARN0": "NE_SW",
    "TNEF": "EFAC", "TNECORR": "ECORR", "TNGLOBALEF": "EFAC",
}

# FD1JUMP (canonical) or FDJUMP1 (tempo2 alias); order 0 is not an FD
# term and falls through to the unrecognized-line report
_FDJUMP_RE = re.compile(r"^FD([1-9]\d*)JUMP$|^FDJUMP([1-9]\d*)$")

TOP_LEVEL_STR = ("PSR", "EPHEM", "CLOCK", "UNITS", "TIMEEPH", "T2CMETHOD",
                 "TZRSITE", "INFO", "DCOVFILE", "TRACK", "MODE", "EPHVER",
                 "DMDATA", "NITS", "IBOOT", "DILATEFREQ")
TOP_LEVEL_FLOAT = ("NTOA", "TRES", "TZRFRQ", "DMRES", "CHI2", "CHI2R")
TOP_LEVEL_MJD = ("START", "FINISH", "TZRMJD")

_REPEATED = ("JUMP", "EFAC", "EQUAD", "ECORR", "DMEFAC", "DMEQUAD",
             "DMJUMP", "TNEQ", "TNGLOBALEQ")


def _value_fit_unc(fields):
    """(value, fit flag, uncertainty or None) of a par line's fields."""
    val = float(fields[0])
    fit, unc = "0", None
    rest = list(fields[1:])
    if rest and rest[0] in ("0", "1"):
        fit = rest.pop(0)
    if rest:
        unc = float(rest[0])
    return val, fit, unc


def _convert_period_keys(keys):
    """tempo1-style P0/P1/P2 spin parameters -> F0/F1/F2 in ``keys``,
    with the uncertainties propagated (the JAX package's builder, with
    its plain f64 arithmetic, so the values are bitwise the same; the
    F1 uncertainty is written as a plain float, ROADMAP §3)."""
    from ..utils import p_to_f, pferrs

    p0, fit0, u0 = _value_fit_unc(keys.pop("P0"))
    keys["F0"] = [repr(1.0 / p0), fit0] + (
        [repr(u0 / p0**2)] if u0 is not None else [])
    had_p1 = "P1" in keys
    p1, fit1, u1 = (_value_fit_unc(keys.pop("P1")) if had_p1
                    else (0.0, "0", None))
    if had_p1 or "P2" in keys:
        keys["F1"] = [repr(-p1 / p0**2), fit1]
        if u0 is not None or u1 is not None:
            _, _, _, f1err = pferrs(p0, u0 or 0.0, p1, u1 or 0.0)
            # float(): numpy 2 reprs its scalars as "np.float64(...)",
            # which the par line reader refuses (the JAX package's F1
            # keeps no uncertainty for that)
            keys["F1"].append(repr(float(f1err)))
    if "P2" in keys:
        p2, fit2, u2 = _value_fit_unc(keys.pop("P2"))
        f2 = p_to_f(p0, p1, p2)[2]
        keys["F2"] = [repr(f2), fit2] + (
            [repr(u2 / p0**2)] if u2 is not None else [])
    warnings.warn("converted P0/P1/P2 spin parameters to F0/F1/F2")


def parse_parfile(parfile) -> list[tuple[str, list[str]]]:
    """par file path or content string -> [(KEY, fields)] preserving order."""
    if isinstance(parfile, str) and ("\n" in parfile or not os.path.exists(parfile)):
        if "\n" not in parfile and not os.path.exists(parfile):
            raise FileNotFoundError(parfile)
        fh = io.StringIO(parfile)
    else:
        fh = open(parfile)
    out = []
    with fh:
        for line in interesting_lines(fh, comments=("#", "C ", "c ")):
            parts = line.split()
            out.append((parts[0].upper(), parts[1:]))
    return out


def _window_ids(keys, *stems):
    """Sorted window indices of the keys starting with any of ``stems``."""
    return sorted({int(k.split("_")[1]) for k in keys if k.startswith(stems)})


def _add_components(model, keys, repeats):
    """Choose the components from the par file's content, in the JAX
    package's order."""
    rep = {c for c, _ in repeats}
    model.add_component(Spindown())
    if "RAJ" in keys or "DECJ" in keys:
        model.add_component(AstrometryEquatorial())
    elif "ELONG" in keys or "ELAT" in keys:
        model.add_component(AstrometryEcliptic())
    if "DM" in keys or "DM1" in keys:
        model.add_component(DispersionDM())
    if "DMX" in keys or any(k.startswith("DMX_") for k in keys):
        model.add_component(DispersionDMX())
    model.add_component(SolarSystemShapiro())
    has_tnsw = any(k.startswith("TNSW") for k in keys)
    if "NE_SW" in keys or "SWM" in keys or has_tnsw:
        model.add_component(SolarWindDispersion())
    if has_tnsw:
        model.add_component(PLSWNoise())
    if "CORRECT_TROPOSPHERE" in keys:
        model.add_component(TroposphereDelay())
    if any(k.startswith("GLEP_") for k in keys):
        model.add_component(Glitch())
    if "WAVE_OM" in keys or any(k.startswith("WAVE") and k[4:].isdigit()
                                for k in keys):
        model.add_component(Wave())
    if any(k.startswith("WXFREQ_") for k in keys):
        model.add_component(WaveX())
    if any(k.startswith("FD") and k[2:].isdigit() for k in keys):
        model.add_component(FD())
    if "SIFUNC" in keys or any(k.startswith("IFUNC") and k[5:].isdigit()
                               for k in keys):
        model.add_component(IFunc())
    if "PHOFF" in keys:
        model.add_component(PhaseOffset())
    if "JUMP" in rep:
        model.add_component(PhaseJump())
    if any(_FDJUMP_RE.match(c) for c in rep):
        model.add_component(FDJump())
    if "DMJUMP" in rep:
        model.add_component(DispersionJump())
    if "BINARY" in keys:
        if keys["BINARY"][0].upper() == "T2":
            # tempo2's universal container: pick the concrete model
            # from the par keys present
            chosen = choose_t2_model(set(keys))
            warnings.warn(
                f"BINARY T2 is a tempo2 container model; selected "
                f"BINARY {chosen} from the parameters present")
            keys["BINARY"] = [chosen]
        add_binary_component(model, keys["BINARY"][0], keys)
    if "TZRMJD" in keys:
        model.add_component(AbsPhase())
    if rep & {"EFAC", "EQUAD", "DMEFAC", "DMEQUAD", "TNEQ", "TNGLOBALEQ"}:
        model.add_component(ScaleToaError())
    if "ECORR" in rep:
        model.add_component(EcorrNoise())
    if any(k.startswith(("RNAMP", "RNIDX", "TNRED")) for k in keys):
        model.add_component(PLRedNoise())
    if any(k.startswith("TNDM") for k in keys):
        model.add_component(PLDMNoise())
    if any(k.startswith("DMWXFREQ_") for k in keys):
        model.add_component(DMWaveX())
    chrom_noise = any(k in ("TNCHROMAMP", "TNCHROMGAM", "TNCHROMC")
                      for k in keys)
    if ("CM" in keys or "CM1" in keys or "TNCHROMIDX" in keys
            or any(k.startswith(("CMX_", "CMWXFREQ_")) for k in keys)
            or chrom_noise):
        # ChromaticCM always rides along: it owns TNCHROMIDX, the one
        # home of the chromatic index CMX/CMWaveX/PLChromNoise read
        cm_comp = ChromaticCM()
        if "CM" not in keys:
            cm_comp.CM.value = 0.0
        model.add_component(cm_comp)
        if any(k.startswith("CMX_") for k in keys):
            model.add_component(ChromaticCMX())
        if any(k.startswith("CMWXFREQ_") for k in keys):
            model.add_component(CMWaveX())
    if chrom_noise:
        model.add_component(PLChromNoise())
    if any(k.startswith(("SWXDM_", "SWX_")) for k in keys):
        # SWX_#### is tempo2's value spelling of SWXDM_####; the piecewise
        # wind replaces the plain one
        if "SolarWindDispersion" in model.components:
            model.remove_component("SolarWindDispersion")
        model.add_component(SolarWindDispersionX())
    if any(k.startswith("PWEP_") for k in keys):
        model.add_component(PiecewiseSpindown())


def _add_prefix_families(model, keys):
    """Create the numbered and windowed parameter families the par file
    names, before values are assigned."""
    comps = model.components

    def run(prefix, add):
        i = 1
        while f"{prefix}{i}" in keys:
            add(i)
            i += 1

    run("F", comps["Spindown"].add_fterm)
    if "DispersionDM" in comps:
        run("DM", comps["DispersionDM"].add_dmterm)
    if "Glitch" in comps:
        for idx in _window_ids(keys, "GLEP_"):
            comps["Glitch"].add_glitch(idx)
    if "Wave" in comps:
        run("WAVE", comps["Wave"].add_wave)
    if "WaveX" in comps:
        for idx in _window_ids(keys, "WXFREQ_"):
            comps["WaveX"].add_wavex(idx)
    if "DMWaveX" in comps:
        for idx in _window_ids(keys, "DMWXFREQ_"):
            comps["DMWaveX"].add_dmwavex(idx)
    if "ChromaticCM" in comps:
        run("CM", comps["ChromaticCM"].add_cmterm)
    if "ChromaticCMX" in comps:
        for idx in _window_ids(keys, "CMX_"):
            lo = float(keys.get(f"CMXR1_{idx:04d}", ["0"])[0])
            hi = float(keys.get(f"CMXR2_{idx:04d}", ["0"])[0])
            comps["ChromaticCMX"].add_cmx_range(idx, lo, hi)
    if "CMWaveX" in comps:
        for idx in _window_ids(keys, "CMWXFREQ_"):
            comps["CMWaveX"].add_cmwavex(idx)
    if "SolarWindDispersionX" in comps:
        # SWX_#### must create the window too, or its R1/R2 companions
        # fall through to `unrecognized`
        for idx in _window_ids(keys, "SWXDM_", "SWX_"):
            lo = float(keys.get(f"SWXR1_{idx:04d}", ["0"])[0])
            hi = float(keys.get(f"SWXR2_{idx:04d}", ["0"])[0])
            p = float(keys.get(f"SWXP_{idx:04d}", ["2"])[0])
            comps["SolarWindDispersionX"].add_swx_range(idx, lo, hi, p=p)
    if "PiecewiseSpindown" in comps:
        for idx in _window_ids(keys, "PWEP_"):
            comps["PiecewiseSpindown"].add_segment(idx)
    if "FD" in comps:
        run("FD", comps["FD"].add_fd)
    if "IFunc" in comps:
        run("IFUNC", comps["IFunc"].add_ifunc)
    if "DispersionDMX" in comps:
        ids = sorted({split_prefixed_name(k)[1] for k in keys
                      if k.startswith("DMX_")})
        for idx in ids:
            lo = float(keys.get(f"DMXR1_{idx:04d}", ["0"])[0])
            hi = float(keys.get(f"DMXR2_{idx:04d}", ["0"])[0])
            comps["DispersionDMX"].add_dmx_range(idx, lo, hi)


def _add_repeated(model, repeats):
    """The repeated mask lines: JUMP, FD<n>JUMP, DMJUMP, EFAC/EQUAD
    (and their DM and temponest forms) and ECORR."""
    comps = model.components
    jump_comp = comps.get("PhaseJump")
    dmjump_comp = comps.get("DispersionJump")
    noise_comp = comps.get("ScaleToaError")
    ecorr_comp = comps.get("EcorrNoise")
    fdjump_comp = comps.get("FDJump")
    for canon, fields in repeats:
        # canon is already the canonical FD<n>JUMP here
        m_fdj = _FDJUMP_RE.match(canon)
        if m_fdj and fdjump_comp is not None:
            fdjump_comp.add_fdjump(int(m_fdj.group(1))).from_parfile_fields(fields)
        elif canon == "JUMP" and jump_comp is not None:
            jump_comp.add_jump().from_parfile_fields(fields)
        elif canon == "DMJUMP" and dmjump_comp is not None:
            dmjump_comp.add_dmjump().from_parfile_fields(fields)
        elif canon in ("EFAC", "EQUAD", "DMEFAC", "DMEQUAD") and noise_comp is not None:
            noise_comp.add_mask_param(canon, fields)
        elif canon in ("TNEQ", "TNGLOBALEQ") and noise_comp is not None:
            # temponest EQUAD: log10(equad / s) -> us
            p = noise_comp.add_mask_param("EQUAD", fields)
            if p.value is not None:
                p.value = 10.0**p.value * 1e6
                if p.uncertainty is not None:
                    p.uncertainty = math.log(10.0) * p.value * p.uncertainty
        elif canon == "ECORR" and ecorr_comp is not None:
            ecorr_comp.add_mask_param(fields)


def get_model(parfile, allow_name_mixing=False, allow_tcb=False) -> TimingModel:
    """(reference: model_builder.py::get_model)

    ``allow_tcb``: a par file with UNITS TCB raises by default (the
    package computes in TDB); ``True`` converts it to TDB on load with
    a warning; ``"raw"`` keeps the TCB values untouched."""
    entries = parse_parfile(parfile)
    keys = {}
    repeats = []
    for k, fields in entries:
        canon = ALIASES.get(k, k)
        m_fdj = _FDJUMP_RE.match(canon)
        if m_fdj:
            canon = f"FD{m_fdj.group(1) or m_fdj.group(2)}JUMP"
        if canon in _REPEATED or m_fdj:
            repeats.append((canon, fields))
        else:
            keys[canon] = fields
    if "P0" in keys and "F0" not in keys:
        _convert_period_keys(keys)

    model = TimingModel(name=str(parfile)
                        if isinstance(parfile, (str, os.PathLike)) else "")
    _add_components(model, keys, repeats)
    _add_prefix_families(model, keys)

    param_index = {}
    for comp in model.components.values():
        for pname in comp.params:
            par = getattr(comp, pname)
            param_index[pname.upper()] = par
            for a in par.aliases:
                param_index[a.upper()] = par

    unrecognized = {}
    for key, fields in keys.items():
        if key == "BINARY":
            continue
        if key in TOP_LEVEL_STR:
            p = strParameter(key)
            p.value = fields[0] if fields else ""
            model.add_top_param(p)
        elif key in TOP_LEVEL_FLOAT:
            p = floatParameter(key)
            if fields:
                p.from_parfile_fields(fields)
            model.add_top_param(p)
        elif key in TOP_LEVEL_MJD:
            p = MJDParameter(key)
            if fields:
                p.from_parfile_fields(fields)
            model.add_top_param(p)
        elif key == "PLANET_SHAPIRO":
            model.PLANET_SHAPIRO.from_parfile_fields(fields)
        elif key in param_index:
            try:
                param_index[key].from_parfile_fields(fields)
            except (ValueError, IndexError) as e:
                warnings.warn(f"bad par line {key} {fields}: {e}")
        else:
            unrecognized[key] = fields

    _add_repeated(model, repeats)
    model.unrecognized = unrecognized
    if unrecognized:
        warnings.warn(f"unrecognized par lines: {sorted(unrecognized)}")
    model.setup()
    model.validate()
    units = ((model.UNITS.value or "").upper()
             if "UNITS" in model.params else "")
    if units in ("TCB", "SI"):  # tempo2 'UNITS SI' = TCB timescale
        if allow_tcb == "raw":
            pass
        elif allow_tcb:
            warnings.warn("par file is in TCB units; converting to TDB "
                          "on load (reference: model_builder.py allow_tcb)")
            from .tcb_conversion import convert_tcb_tdb

            convert_tcb_tdb(model)
        else:
            raise ValueError(
                "par file has UNITS TCB but the package computes in "
                "TDB. Pass allow_tcb=True to convert on load, "
                "allow_tcb='raw' to keep TCB values, or convert the "
                "file with the tcb2tdb script.")
    elif units not in ("", "TDB"):
        raise ValueError(f"unrecognized UNITS {units!r} in par file "
                         "(expected TDB, TCB, or SI)")
    return model


def get_model_and_toas(parfile, timfile, allow_tcb=False, **kw):
    """(reference: model_builder.py::get_model_and_toas): the model,
    and the TOAs of ``timfile`` read by ``get_TOAs`` with the model's
    EPHEM and PLANET_SHAPIRO; ``**kw`` goes to ``get_TOAs``."""
    from ..toa import get_TOAs

    model = get_model(parfile, allow_tcb=allow_tcb)
    ephem = "de440s"
    if "EPHEM" in model.params and model.EPHEM.value:
        ephem = model.EPHEM.value.lower()
    planets = (bool(model.PLANET_SHAPIRO.value)
               if "PLANET_SHAPIRO" in model.params else False)
    toas = get_TOAs(timfile, ephem=ephem, planets=planets, **kw)
    return model, toas
