"""Spindown phase component (torch counterpart of the JAX package's
``models/spindown.py``).

(reference: src/pint/models/spindown.py::Spindown — params F0..Fn via
prefixParameter, PEPOCH; phase = taylor_horner(dt, [0, F0, F1, ...])).

The host packs phi_ref = taylor(F_ref, T) in longdouble as (int, frac);
the device adds only exact small deltas — the dF Taylor terms and the
-delay * instantaneous-frequency divided-difference term — in f64.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mjd import LD
from .parameter import MJDParameter, prefixParameter
from .timing_model import MissingParameter, PhaseComponent


class Spindown(PhaseComponent):
    category = "spindown"
    order = 10

    def __init__(self):
        super().__init__()
        self.add_param(prefixParameter("F0", "F", 0, units="Hz",
                                       description="Spin frequency"))
        self.add_param(MJDParameter("PEPOCH", units="MJD",
                                    description="Epoch of spin parameters"))

    def setup(self):
        pass

    def validate(self):
        if self.F0.value is None:
            raise MissingParameter("Spindown", "F0")

    def n_fterms(self):
        n = 0
        while f"F{n + 1}" in self.params:
            n += 1
        return n + 1

    def add_fterm(self, index, value=0.0, frozen=True):
        p = prefixParameter(f"F{index}", "F", index, units=f"Hz/s^{index}",
                            frozen=frozen)
        p.value = value
        self.add_param(p)

    def fvalues(self):
        return np.array([getattr(self, f"F{i}").value or 0.0
                         for i in range(self.n_fterms())], dtype=np.float64)

    def device_slot(self, pname):
        if pname.startswith("F"):
            return "F", int(pname[1:])
        raise KeyError(pname)

    # ---- host pack ----

    def pack(self, model, toas, prep, params0, device=None):
        F_ref = self.fvalues()
        params0["F"] = F_ref.copy()
        prep["F_ref"] = F_ref.copy()
        T = prep["T_ld"]  # longdouble seconds since PEPOCH
        phi = np.zeros_like(T)
        fact = LD(1.0)
        for i, f in enumerate(F_ref):
            fact = fact * LD(i + 1)
            phi = phi + LD(f) * T ** (i + 1) / fact
        phi_int = np.floor(phi + LD(0.5))
        prep["phi_ref_int"] = phi_int.astype(np.float64)
        prep["phi_ref_frac"] = (phi - phi_int).astype(np.float64)

    # ---- device phase ----

    def phase(self, params, batch, prep, delay_total):
        F = params["F"]
        F_ref = prep["F_ref"]
        T = prep["T_hi"] + prep["T_lo"]
        d = delay_total
        n = F_ref.shape[0]
        ph = prep["phi_ref_frac"]
        # delta-F Taylor terms: sum_i (F_i - F_ref_i) T^(i+1)/(i+1)!
        fact = 1.0
        Tp = T  # T^(i+1)
        for i in range(n):
            fact *= i + 1
            ph = ph + (F[i] - F_ref[i]) * Tp / fact
            Tp = Tp * T
        # exact delay term: phi(T-d) - phi(T)
        #   = -d * sum_i F_i/(i+1)! * sum_{j<=i} T^(i-j) (T-d)^j
        Tm = T - d
        fact = 1.0
        B = torch.zeros_like(T)
        for i in range(n):
            fact *= i + 1
            s = torch.zeros_like(T)
            Tmj = torch.ones_like(T)  # (T-d)^j
            for j in range(i + 1):
                # T^(i-j) * (T-d)^j
                s = s + T ** (i - j) * Tmj
                Tmj = Tmj * Tm
            B = B + F[i] / fact * s
        return ph - d * B

    def d_phase_d_toa_freq(self, params, batch, prep, delay_total):
        """Instantaneous spin frequency at emission [Hz] (for resid->time):
        sum_i F_i T^i / i! at T = T_hi + T_lo - delay_total."""
        F = params["F"]
        T = prep["T_hi"] + prep["T_lo"] - delay_total
        freq = 0.0 * T
        fact = 1.0
        Tp = 1.0
        for i in range(prep["F_ref"].shape[0]):
            if i > 0:
                fact *= i
            freq = freq + F[i] * Tp / fact
            Tp = Tp * T
        return freq
