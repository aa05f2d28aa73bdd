"""Chromatic (variable-index) dispersion-like delays (torch counterpart
of the JAX package's ``models/chromatic.py``).

(reference: src/pint/models/chromatic_model.py — ChromaticCM with
Taylor-series CM/CM1/... at CMEPOCH and chromatic index TNCHROMIDX,
ChromaticCMX piecewise windows CMX_####/CMXR1_####/CMXR2_####;
src/pint/models/cmwavex.py::CMWaveX — explicit-frequency Fourier
amplitudes in CM units.)

delay = DMconst * CM(t) / nu_MHz^alpha with alpha = TNCHROMIDX
(default 4, the expected scattering index); at alpha = 2 every formula
reduces exactly to the corresponding DM component.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import DMconst, SECS_PER_DAY, SECS_PER_JULIAN_YEAR
from .parameter import MJDParameter, floatParameter, prefixParameter
from .timing_model import DelayComponent, MissingParameter
from .wave import _epoch_dt_day, _fourier_sum

DEFAULT_CHROM_IDX = 4.0


def _chromatic_delay(cm, alpha, freq_mhz):
    falpha = torch.pow(freq_mhz, alpha)
    return torch.where(torch.isfinite(falpha), DMconst * cm / falpha, 0.0)


class ChromaticCM(DelayComponent):
    """Taylor-series chromatic measure (reference: ChromaticCM)."""

    category = "chromatic"
    order = 32

    def __init__(self):
        super().__init__()
        self.add_param(prefixParameter(
            "CM", "CM", 0, units="pc cm^-3 MHz^(alpha-2)",
            description="Chromatic measure"))
        self.add_param(MJDParameter("CMEPOCH", units="MJD",
                                    description="Epoch of CM measurement"))
        p = floatParameter("TNCHROMIDX", units="",
                           description="Chromatic index alpha (delay ~ nu^-alpha)")
        p.value = DEFAULT_CHROM_IDX
        self.add_param(p)

    def validate(self):
        if self.CM.value is None:
            raise MissingParameter("ChromaticCM", "CM")

    def n_terms(self):
        n = 0
        while f"CM{n + 1}" in self.params:
            n += 1
        return n + 1

    def add_cmterm(self, index, value=0.0, frozen=True):
        p = prefixParameter(f"CM{index}", "CM", index,
                            units=f"pc cm^-3 MHz^(alpha-2)/yr^{index}",
                            frozen=frozen)
        p.value = value
        self.add_param(p)

    def device_slot(self, pname):
        if pname == "CM":
            return "CM", 0
        if pname == "TNCHROMIDX":
            return "TNCHROMIDX", None
        return "CM", int(pname[2:])

    def pack(self, model, toas, prep, params0, device=None):
        params0["CM"] = np.array([getattr(self, f"CM{i}" if i else "CM").value
                                  or 0.0 for i in range(self.n_terms())],
                                 dtype=np.float64)
        params0["TNCHROMIDX"] = self.TNCHROMIDX.value or DEFAULT_CHROM_IDX
        ce = self.CMEPOCH
        if ce is not None and ce.day is not None:
            day, sec = ce.day, ce.sec
        else:
            day, sec = prep["pepoch_day"], prep["pepoch_sec"]
        prep["cmepoch_dt"] = ((toas.tdb.day - day).astype(np.float64)
                              * SECS_PER_DAY + (toas.tdb.sec - sec))

    def cm_value(self, params, prep):
        """CM(t) Taylor series; CM1, CM2, ... per Julian year like the
        DM derivatives."""
        cm = params["CM"]
        dt = prep["cmepoch_dt"] / SECS_PER_JULIAN_YEAR
        out = 0.0 * dt
        fact = 1.0
        tp = 1.0
        for i in range(cm.shape[-1]):
            if i > 0:
                fact *= i
            out = out + cm[..., i] * tp / fact
            tp = tp * dt
        return out

    def delay(self, params, batch, prep, delay_accum):
        return _chromatic_delay(self.cm_value(params, prep),
                                params["TNCHROMIDX"], batch.freq_mhz)


class ChromaticCMX(DelayComponent):
    """Piecewise-constant CM offsets in MJD windows (reference:
    ChromaticCMX). Uses the chromatic index of the model's ChromaticCM
    component (the builder always adds one, so TNCHROMIDX has exactly
    one home)."""

    category = "chromatic_cmx"
    order = 33

    def __init__(self):
        super().__init__()
        self.cmx_ids: list[int] = []

    def add_cmx_range(self, index, mjd_start, mjd_end, value=0.0, frozen=True):
        p = prefixParameter(f"CMX_{index:04d}", "CMX_", index,
                            units="pc cm^-3 MHz^(alpha-2)", frozen=frozen)
        p.value = value
        self.add_param(p)
        r1 = MJDParameter(f"CMXR1_{index:04d}", units="MJD")
        r1.set_mjd(int(mjd_start), (mjd_start % 1) * SECS_PER_DAY)
        self.add_param(r1)
        r2 = MJDParameter(f"CMXR2_{index:04d}", units="MJD")
        r2.set_mjd(int(mjd_end), (mjd_end % 1) * SECS_PER_DAY)
        self.add_param(r2)
        self.cmx_ids.append(index)

    def device_slot(self, pname):
        if pname.startswith("CMX_"):
            return "CMX", self.cmx_ids.index(int(pname[4:]))
        raise KeyError(pname)

    def validate(self):
        super().validate()
        # a missing CMXR1/CMXR2 pair would be the empty window [0, 0]
        # and an identically-zero design column
        for i in self.cmx_ids:
            r1 = getattr(self, f"CMXR1_{i:04d}").value
            r2 = getattr(self, f"CMXR2_{i:04d}").value
            if r1 is None or r2 is None or not r1 < r2:
                raise MissingParameter(
                    "ChromaticCMX", f"CMXR1_{i:04d}/CMXR2_{i:04d}",
                    f"CMX_{i:04d} needs a non-empty MJD window "
                    f"(got [{r1}, {r2}])")

    def pack(self, model, toas, prep, params0, device=None):
        params0["CMX"] = np.array([getattr(self, f"CMX_{i:04d}").value or 0.0
                                   for i in self.cmx_ids], dtype=np.float64)
        mjds = toas.get_mjds()
        masks = np.zeros((len(self.cmx_ids), len(toas)))
        for k, i in enumerate(self.cmx_ids):
            lo = getattr(self, f"CMXR1_{i:04d}").value
            hi = getattr(self, f"CMXR2_{i:04d}").value
            masks[k] = (mjds >= lo) & (mjds <= hi)
        prep["cmx_masks"] = masks

    def delay(self, params, batch, prep, delay_accum):
        return _chromatic_delay(params["CMX"] @ prep["cmx_masks"],
                                params.get("TNCHROMIDX", DEFAULT_CHROM_IDX),
                                batch.freq_mhz)


class CMWaveX(DelayComponent):
    """WaveX in CM space (reference: cmwavex.py::CMWaveX): explicit
    frequencies CMWXFREQ_#### with CMWXSIN_####/CMWXCOS_#### amplitudes
    in CM units; delay = DMconst * CM_wave / nu^alpha."""

    category = "cmwavex"
    order = 38

    def __init__(self):
        super().__init__()
        self.add_param(MJDParameter("CMWXEPOCH", units="MJD",
                                    description="Reference epoch of CMWaveX terms"))
        self.wx_ids: list[int] = []

    def add_cmwavex(self, index=None, freq_per_day=None):
        index = index if index is not None else len(self.wx_ids) + 1
        f = prefixParameter(f"CMWXFREQ_{index:04d}", "CMWXFREQ_", index,
                            units="1/d")
        f.value = freq_per_day if freq_per_day is not None else 0.0
        self.add_param(f)
        for stem in ("CMWXSIN", "CMWXCOS"):
            p = prefixParameter(f"{stem}_{index:04d}", f"{stem}_", index,
                                units="pc cm^-3 MHz^(alpha-2)")
            p.value = 0.0
            self.add_param(p)
        self.wx_ids.append(index)
        return index

    def device_slot(self, pname):
        stem, idx = pname.rsplit("_", 1)
        if stem in ("CMWXSIN", "CMWXCOS", "CMWXFREQ"):
            return stem, self.wx_ids.index(int(idx))
        raise KeyError(pname)

    def pack(self, model, toas, prep, params0, device=None):
        for stem in ("CMWXFREQ", "CMWXSIN", "CMWXCOS"):
            params0[stem] = np.array(
                [getattr(self, f"{stem}_{i:04d}").value or 0.0
                 for i in self.wx_ids], dtype=np.float64)
        prep["cmwavex_dt_day"] = _epoch_dt_day(self.CMWXEPOCH, toas, prep)

    def delay(self, params, batch, prep, delay_accum):
        cm = _fourier_sum(params["CMWXFREQ"], params["CMWXSIN"],
                          params["CMWXCOS"], prep["cmwavex_dt_day"])
        return _chromatic_delay(cm, params.get("TNCHROMIDX", DEFAULT_CHROM_IDX),
                                batch.freq_mhz)
