"""Phase and delay jumps over TOA subsets (torch counterpart of the JAX
package's ``models/jump.py``).

(reference: src/pint/models/jump.py::PhaseJump — JUMP maskParameters;
jump_phase = -F0 * JUMP over the selected TOAs.)
"""

from __future__ import annotations

from .parameter import maskParameter, pack_mask_values
from .timing_model import DelayComponent, PhaseComponent


class PhaseJump(PhaseComponent):
    category = "phase_jump"
    order = 40

    def __init__(self):
        super().__init__()
        self.jump_ids: list[int] = []

    def add_jump(self, key="", key_value=(), value=0.0, frozen=False, index=None):
        index = index if index is not None else len(self.jump_ids) + 1
        p = maskParameter(f"JUMP{index}", "JUMP", index, units="s", frozen=frozen)
        p.key = key
        p.key_value = list(key_value)
        p.value = value
        self.add_param(p)
        self.jump_ids.append(index)
        return p

    def device_slot(self, pname):
        return "JUMP", self.jump_ids.index(int(pname[4:]))

    def pack(self, model, toas, prep, params0, device=None):
        vals, masks = pack_mask_values(
            self, [f"JUMP{i}" for i in self.jump_ids], toas)
        params0["JUMP"] = vals
        prep["jump_masks"] = masks

    def phase(self, params, batch, prep, delay_total):
        # jump in seconds of time; phase shift = -F0 * jump on masked TOAs
        jump_per_toa = params["JUMP"] @ prep["jump_masks"]
        return -params["F"][..., 0] * jump_per_toa


class DelayJump(DelayComponent):
    """Per-subset constant time offsets applied as delays
    (reference: jump.py::DelayJump; tempo2 'JUMP' semantics)."""

    category = "delay_jump"
    order = 45

    def __init__(self):
        super().__init__()
        self.jump_ids: list[int] = []

    def add_jump(self, key="", key_value=(), value=0.0, frozen=False, index=None):
        index = index if index is not None else len(self.jump_ids) + 1
        p = maskParameter(f"DJUMP{index}", "DJUMP", index, units="s", frozen=frozen)
        p.key = key
        p.key_value = list(key_value)
        p.value = value
        self.add_param(p)
        self.jump_ids.append(index)
        return p

    def device_slot(self, pname):
        return "DJUMP", self.jump_ids.index(int(pname[5:]))

    def pack(self, model, toas, prep, params0, device=None):
        vals, masks = pack_mask_values(
            self, [f"DJUMP{i}" for i in self.jump_ids], toas)
        params0["DJUMP"] = vals
        prep["djump_masks"] = masks

    def delay(self, params, batch, prep, delay_accum):
        return params["DJUMP"] @ prep["djump_masks"]


def jump_flags_to_params(toas, model) -> list[str]:
    """One free JUMP parameter per distinct tim-file JUMP block
    (reference: jump.py::PhaseJump tim-jump handling — tim JUMP
    commands mark TOAs with -tim_jump N flags). Returns the new
    parameter names; groups that already have a JUMP are skipped."""
    values = sorted({f["tim_jump"] for f in toas.flags if "tim_jump" in f},
                    key=lambda v: (len(v), v))
    if not values:
        return []
    if "PhaseJump" not in model.components:
        model.add_component(PhaseJump())
    comp = model.components["PhaseJump"]
    existing = {tuple(getattr(comp, p).key_value)
                for p in comp.params
                if getattr(comp, p).key == "-tim_jump"}
    created = []
    for v in values:
        if (v,) in existing:
            continue
        p = comp.add_jump(key="-tim_jump", key_value=[v], value=0.0,
                          frozen=False)
        created.append(p.name)
    return created
