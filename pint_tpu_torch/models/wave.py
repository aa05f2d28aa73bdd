"""Harmonic whitening terms: Wave, WaveX and DMWaveX (torch counterpart
of the JAX package's ``models/wave.py``).

(reference: src/pint/models/wave.py::Wave — WAVEEPOCH, WAVE_OM
[rad/day], WAVEn pair parameters (sin, cos amplitudes in seconds);
phase += F0 * sum_k [A_k sin(k w t) + B_k cos(k w t)].
reference: src/pint/models/wavex.py::WaveX — WXEPOCH, explicit
per-term frequencies WXFREQ_#### [1/day] with WXSIN_####/WXCOS_####
delay amplitudes in seconds; dmwavex.py::DMWaveX, the same in DM.)
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..constants import DMconst, SECS_PER_DAY
from .parameter import MJDParameter, floatParameter, pairParameter, prefixParameter
from .timing_model import DelayComponent, MissingParameter, PhaseComponent


def _epoch_dt_day(epoch, toas, prep):
    """TDB days since ``epoch`` (PEPOCH when unset) at each TOA."""
    if epoch is not None and epoch.day is not None:
        day, sec = epoch.day, epoch.sec
    else:
        day, sec = prep["pepoch_day"], prep["pepoch_sec"]
    return ((toas.tdb.day - day).astype(np.float64)
            + (toas.tdb.sec - sec) / SECS_PER_DAY)


def _fourier_sum(freq_per_day, sin_amp, cos_amp, t_day):
    """sum_k [S_k sin(2 pi f_k t) + C_k cos(2 pi f_k t)] per TOA."""
    arg = 2.0 * math.pi * freq_per_day * t_day[..., :, None]
    return torch.sum(sin_amp * torch.sin(arg) + cos_amp * torch.cos(arg),
                     dim=-1)


class Wave(PhaseComponent):
    category = "wave"
    order = 35

    def __init__(self):
        super().__init__()
        self.add_param(floatParameter("WAVE_OM", units="rad/day",
                                      description="Fundamental wave frequency"))
        self.add_param(MJDParameter("WAVEEPOCH", units="MJD",
                                    description="Reference epoch of wave terms"))
        self.wave_ids: list[int] = []

    def add_wave(self, index=None):
        index = index if index is not None else len(self.wave_ids) + 1
        p = pairParameter(f"WAVE{index}", "WAVE", index, units="s",
                          description=f"Wave harmonic {index} (sin, cos) [s]")
        p.value = (0.0, 0.0)
        self.add_param(p)
        self.wave_ids.append(index)
        return index

    def validate(self):
        if self.wave_ids and self.WAVE_OM.value is None:
            raise MissingParameter("Wave", "WAVE_OM")

    def device_slot(self, pname):
        if pname == "WAVE_OM":
            return "WAVE_OM", None
        raise KeyError(pname)

    def pack(self, model, toas, prep, params0, device=None):
        params0["WAVE_OM"] = self.WAVE_OM.value or 0.0
        params0["WAVEA"] = np.array([getattr(self, f"WAVE{i}").value[0]
                                     for i in self.wave_ids])
        params0["WAVEB"] = np.array([getattr(self, f"WAVE{i}").value[1]
                                     for i in self.wave_ids])
        prep["wave_dt_day"] = _epoch_dt_day(self.WAVEEPOCH, toas, prep)

    def phase(self, params, batch, prep, delay_total):
        t = prep["wave_dt_day"] - delay_total / SECS_PER_DAY
        k = torch.arange(1, params["WAVEA"].shape[-1] + 1, dtype=t.dtype,
                         device=t.device)
        arg = params["WAVE_OM"] * t[..., :, None] * k
        wave_s = torch.sum(params["WAVEA"] * torch.sin(arg)
                           + params["WAVEB"] * torch.cos(arg), dim=-1)
        return params["F"][..., 0] * wave_s


class WaveX(DelayComponent):
    """Explicit-frequency harmonic delays (reference: wavex.py::WaveX)."""

    category = "wavex"
    order = 36

    def __init__(self):
        super().__init__()
        self.add_param(MJDParameter("WXEPOCH", units="MJD",
                                    description="Reference epoch of WaveX terms"))
        self.wx_ids: list[int] = []

    def add_wavex(self, index=None, freq_per_day=None):
        index = index if index is not None else len(self.wx_ids) + 1
        f = prefixParameter(f"WXFREQ_{index:04d}", "WXFREQ_", index, units="1/d")
        f.value = freq_per_day if freq_per_day is not None else 0.0
        self.add_param(f)
        for stem in ("WXSIN", "WXCOS"):
            p = prefixParameter(f"{stem}_{index:04d}", f"{stem}_", index, units="s")
            p.value = 0.0
            self.add_param(p)
        self.wx_ids.append(index)
        return index

    def device_slot(self, pname):
        stem, idx = pname.rsplit("_", 1)
        if stem in ("WXSIN", "WXCOS", "WXFREQ"):
            return stem, self.wx_ids.index(int(idx))
        raise KeyError(pname)

    def pack(self, model, toas, prep, params0, device=None):
        for stem in ("WXFREQ", "WXSIN", "WXCOS"):
            params0[stem] = np.array(
                [getattr(self, f"{stem}_{i:04d}").value or 0.0
                 for i in self.wx_ids], dtype=np.float64)
        prep["wavex_dt_day"] = _epoch_dt_day(self.WXEPOCH, toas, prep)

    def delay(self, params, batch, prep, delay_accum):
        return _fourier_sum(params["WXFREQ"], params["WXSIN"],
                            params["WXCOS"], prep["wavex_dt_day"])


class DMWaveX(DelayComponent):
    """WaveX in DM space (reference: dmwavex.py::DMWaveX): explicit
    frequencies DMWXFREQ_#### with DMWXSIN/DMWXCOS amplitudes in
    pc cm^-3; delay = DMconst * DM_wave / nu^2."""

    category = "dmwavex"
    order = 37

    def __init__(self):
        super().__init__()
        self.add_param(MJDParameter("DMWXEPOCH", units="MJD",
                                    description="Reference epoch of DMWaveX terms"))
        self.wx_ids: list[int] = []

    def add_dmwavex(self, index=None, freq_per_day=None):
        index = index if index is not None else len(self.wx_ids) + 1
        f = prefixParameter(f"DMWXFREQ_{index:04d}", "DMWXFREQ_", index,
                            units="1/d")
        f.value = freq_per_day if freq_per_day is not None else 0.0
        self.add_param(f)
        for stem in ("DMWXSIN", "DMWXCOS"):
            p = prefixParameter(f"{stem}_{index:04d}", f"{stem}_", index,
                                units="pc/cm^3")
            p.value = 0.0
            self.add_param(p)
        self.wx_ids.append(index)
        return index

    def device_slot(self, pname):
        stem, idx = pname.rsplit("_", 1)
        if stem in ("DMWXSIN", "DMWXCOS", "DMWXFREQ"):
            return stem, self.wx_ids.index(int(idx))
        raise KeyError(pname)

    def pack(self, model, toas, prep, params0, device=None):
        for stem in ("DMWXFREQ", "DMWXSIN", "DMWXCOS"):
            params0[stem] = np.array(
                [getattr(self, f"{stem}_{i:04d}").value or 0.0
                 for i in self.wx_ids], dtype=np.float64)
        prep["dmwavex_dt_day"] = _epoch_dt_day(self.DMWXEPOCH, toas, prep)

    def dm_value(self, params, prep):
        """Fourier DM contribution [pc cm^-3] (shared by delay and
        TimingModel.total_dm)."""
        return _fourier_sum(params["DMWXFREQ"], params["DMWXSIN"],
                            params["DMWXCOS"], prep["dmwavex_dt_day"])

    def delay(self, params, batch, prep, delay_accum):
        dm = self.dm_value(params, prep)
        f2 = torch.square(batch.freq_mhz)
        return torch.where(torch.isfinite(f2), DMconst * dm / f2, 0.0)
