"""Par file -> TimingModel construction (the JAX package's
``models/builder.py``, for the components this package has ported).

(reference: src/pint/models/model_builder.py — parse par lines, resolve
aliases, choose components from content.)

A par file that needs a component the port does not have yet raises
``NotImplementedError`` naming it: no line is silently dropped into a
model that would then fit the wrong physics.
"""

from __future__ import annotations

import io
import math
import os
import re
import warnings

from ..utils import interesting_lines
from .absolute_phase import AbsPhase
from .astrometry import AstrometryEcliptic, AstrometryEquatorial
from .dispersion import DispersionDM
from .noise import EcorrNoise, PLRedNoise, ScaleToaError
from .parameter import MJDParameter, floatParameter, strParameter
from .solar_system_shapiro import SolarSystemShapiro
from .solar_wind import SolarWindDispersion
from .spindown import Spindown
from .timing_model import TimingModel
from .troposphere import TroposphereDelay

# par-file key aliases -> canonical names (reference: each Parameter's aliases)
ALIASES = {
    "E": "ECC", "PSRJ": "PSR", "PSRB": "PSR", "DEC": "DECJ", "RA": "RAJ",
    "LAMBDA": "ELONG", "BETA": "ELAT", "PMLAMBDA": "PMELONG", "PMBETA": "PMELAT",
    "CLK": "CLOCK", "T2EFAC": "EFAC", "T2EQUAD": "EQUAD", "NE1AU": "NE_SW",
    "SOLARN0": "NE_SW",
    "TNEF": "EFAC", "TNECORR": "ECORR", "TNGLOBALEF": "EFAC",
}

_FDJUMP_RE = re.compile(r"^FD([1-9]\d*)JUMP$|^FDJUMP([1-9]\d*)$")

TOP_LEVEL_STR = ("PSR", "EPHEM", "CLOCK", "UNITS", "TIMEEPH", "T2CMETHOD",
                 "TZRSITE", "INFO", "DCOVFILE", "TRACK", "MODE", "EPHVER",
                 "DMDATA", "NITS", "IBOOT", "DILATEFREQ")
TOP_LEVEL_FLOAT = ("NTOA", "TRES", "TZRFRQ", "DMRES", "CHI2", "CHI2R")
TOP_LEVEL_MJD = ("START", "FINISH", "TZRMJD")

_REPEATED = ("JUMP", "EFAC", "EQUAD", "ECORR", "DMEFAC", "DMEQUAD",
             "DMJUMP", "TNEQ", "TNGLOBALEQ")


def _unported_components(keys, repeats):
    """Components of the JAX package's builder that this par file would
    need and the port does not have yet, by the same key tests."""
    need = []

    def has(pred):
        return any(pred(k) for k in keys)

    rep = {c for c, _ in repeats}
    checks = [
        ("DispersionDMX", "DMX" in keys or has(lambda k: k.startswith("DMX_"))),
        ("PLSWNoise", has(lambda k: k.startswith("TNSW"))),
        ("Glitch", has(lambda k: k.startswith("GLEP_"))),
        ("Wave", "WAVE_OM" in keys
         or has(lambda k: k.startswith("WAVE") and k[4:].isdigit())),
        ("WaveX", has(lambda k: k.startswith("WXFREQ_"))),
        ("FD", has(lambda k: k.startswith("FD") and k[2:].isdigit())),
        ("IFunc", "SIFUNC" in keys
         or has(lambda k: k.startswith("IFUNC") and k[5:].isdigit())),
        ("PhaseOffset", "PHOFF" in keys),
        ("PhaseJump", "JUMP" in rep),
        ("FDJump", any(_FDJUMP_RE.match(c) for c in rep)),
        ("DispersionJump", "DMJUMP" in rep),
        ("binary model", "BINARY" in keys),
        ("PLDMNoise", has(lambda k: k.startswith("TNDM"))),
        ("DMWaveX", has(lambda k: k.startswith("DMWXFREQ_"))),
        ("ChromaticCM", "CM" in keys or "CM1" in keys or "TNCHROMIDX" in keys
         or has(lambda k: k.startswith(("CMX_", "CMWXFREQ_", "TNCHROM")))),
        ("SolarWindDispersionX", has(lambda k: k.startswith(("SWXDM_", "SWX_")))),
        ("PiecewiseSpindown", has(lambda k: k.startswith("PWEP_"))),
        ("P0/P1 spin conversion", "P0" in keys and "F0" not in keys),
    ]
    return [name for name, hit in checks if hit]


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


def get_model(parfile) -> TimingModel:
    """(reference: model_builder.py::get_model) for the ported
    components: Spindown, AstrometryEquatorial/Ecliptic, DispersionDM,
    SolarSystemShapiro, SolarWindDispersion, TroposphereDelay, AbsPhase,
    ScaleToaError, EcorrNoise and PLRedNoise."""
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
    missing = _unported_components(keys, repeats)
    if missing:
        raise NotImplementedError(
            f"par file needs {', '.join(missing)}, not ported to "
            "pint_tpu_torch yet")

    model = TimingModel(name=str(parfile) if "\n" not in str(parfile) else "")
    model.add_component(Spindown())
    if "RAJ" in keys or "DECJ" in keys:
        model.add_component(AstrometryEquatorial())
    elif "ELONG" in keys or "ELAT" in keys:
        model.add_component(AstrometryEcliptic())
    if "DM" in keys or "DM1" in keys:
        model.add_component(DispersionDM())
    model.add_component(SolarSystemShapiro())
    if "NE_SW" in keys or "SWM" in keys:
        model.add_component(SolarWindDispersion())
    if "CORRECT_TROPOSPHERE" in keys:
        model.add_component(TroposphereDelay())
    if "TZRMJD" in keys:
        model.add_component(AbsPhase())
    rep = {c for c, _ in repeats}
    if rep & {"EFAC", "EQUAD", "DMEFAC", "DMEQUAD", "TNEQ", "TNGLOBALEQ"}:
        model.add_component(ScaleToaError())
    if "ECORR" in rep:
        model.add_component(EcorrNoise())
    if any(k.startswith(("RNAMP", "RNIDX", "TNRED")) for k in keys):
        model.add_component(PLRedNoise())

    # dynamic prefix families before value assignment
    sd = model.components["Spindown"]
    i = 1
    while f"F{i}" in keys:
        sd.add_fterm(i)
        i += 1
    if "DispersionDM" in model.components:
        dd = model.components["DispersionDM"]
        i = 1
        while f"DM{i}" in keys:
            dd.add_dmterm(i)
            i += 1

    param_index = {}
    for comp in model.components.values():
        for pname in comp.params:
            par = getattr(comp, pname)
            param_index[pname.upper()] = par
            for a in par.aliases:
                param_index[a.upper()] = par

    unrecognized = {}
    for key, fields in keys.items():
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

    noise_comp = model.components.get("ScaleToaError")
    ecorr_comp = model.components.get("EcorrNoise")
    for canon, fields in repeats:
        if canon in ("EFAC", "EQUAD", "DMEFAC", "DMEQUAD"):
            noise_comp.add_mask_param(canon, fields)
        elif canon in ("TNEQ", "TNGLOBALEQ"):
            # temponest EQUAD: log10(equad / s) -> us
            p = noise_comp.add_mask_param("EQUAD", fields)
            if p.value is not None:
                p.value = 10.0**p.value * 1e6
                if p.uncertainty is not None:
                    p.uncertainty = math.log(10.0) * p.value * p.uncertainty
        elif canon == "ECORR":
            ecorr_comp.add_mask_param(fields)

    model.unrecognized = unrecognized
    if unrecognized:
        warnings.warn(f"unrecognized par lines: {sorted(unrecognized)}")
    model.setup()
    model.validate()
    units = ((model.UNITS.value or "").upper()
             if "UNITS" in model.params else "")
    if units in ("TCB", "SI"):
        raise NotImplementedError(
            "par file has UNITS TCB; TCB->TDB conversion is not ported "
            "to pint_tpu_torch yet")
    if units not in ("", "TDB"):
        raise ValueError(f"unrecognized UNITS {units!r} in par file "
                         "(expected TDB, TCB, or SI)")
    return model


def get_model_and_toas(parfile, timfile, allow_tcb=False, **kw):
    """(reference: model_builder.py::get_model_and_toas): the model,
    and the TOAs of ``timfile`` read by ``get_TOAs`` with the model's
    EPHEM and PLANET_SHAPIRO; ``**kw`` goes to ``get_TOAs``. UNITS TCB
    is not ported, so ``allow_tcb`` must stay False."""
    from ..toa import get_TOAs

    if allow_tcb:
        raise NotImplementedError(
            "allow_tcb: TCB->TDB conversion is not ported to "
            "pint_tpu_torch yet")
    model = get_model(parfile)
    ephem = "de440s"
    if "EPHEM" in model.params and model.EPHEM.value:
        ephem = model.EPHEM.value.lower()
    planets = (bool(model.PLANET_SHAPIRO.value)
               if "PLANET_SHAPIRO" in model.params else False)
    toas = get_TOAs(timfile, ephem=ephem, planets=planets, **kw)
    return model, toas
