"""Binary pulsar components (torch counterpart of the JAX package's
``models/binary/``).

(reference: src/pint/models/pulsar_binary.py +
stand_alone_psr_binaries/.) ELL1/ELL1H/ELL1k (closed form), BT/BTX and
BT_piecewise, DD/DDS/DDH/DDGR/DDK (fixed-count Kepler solve).
"""

from __future__ import annotations


def choose_t2_model(keys: set) -> str:
    """Pick the concrete binary model for a tempo2 "BINARY T2"
    parameter set (T2 is a universal container; what's present decides):
    KIN/KOM -> DDK, EPS1/EPS2 (+H3/H4/STIG) -> ELL1/ELL1H,
    H3/STIG alone -> DDH, SHAPMAX -> DDS, ECC/OM + M2/SINI -> DD,
    else BT. Expects UPPERCASE par keys; only meaningful for par-file
    key sets (``add_binary_component`` still rejects 'T2')."""
    if "KIN" in keys or "KOM" in keys:
        return "DDK"
    if "EPS1" in keys or "EPS2" in keys:
        if "H3" in keys or "H4" in keys or "STIGMA" in keys or "STIG" in keys:
            return "ELL1H"
        return "ELL1"
    if "H3" in keys or "STIGMA" in keys or "STIG" in keys:
        return "DDH"  # eccentric orbit with orthometric Shapiro
    if "SHAPMAX" in keys:
        return "DDS"  # SHAPMAX defines DDS; DD would drop the Shapiro shape
    if "M2" in keys or "SINI" in keys:
        return "DD"
    return "BT"


def add_binary_component(model, binary_name: str, keys: dict):
    """Add the binary component ``binary_name`` (a par file's BINARY
    value) to ``model`` with the FBn/piece members ``keys`` names."""
    name = binary_name.upper()
    if name in ("ELL1", "ELL1H", "ELL1K"):
        from .ell1 import BinaryELL1, BinaryELL1H, BinaryELL1k

        comp = {"ELL1": BinaryELL1, "ELL1H": BinaryELL1H,
                "ELL1K": BinaryELL1k}[name]()
    elif name in ("BT", "BTX"):
        from .bt import BinaryBT, BinaryBTX

        comp = BinaryBTX() if name == "BTX" else BinaryBT()
    elif name == "BT_PIECEWISE":
        from .bt_piecewise import BinaryBTPiecewise

        comp = BinaryBTPiecewise()
    elif name in ("DD", "DDS", "DDGR", "DDK", "DDH"):
        from .dd import (BinaryDD, BinaryDDGR, BinaryDDH, BinaryDDK,
                         BinaryDDS)

        comp = {"DD": BinaryDD, "DDS": BinaryDDS, "DDK": BinaryDDK,
                "DDGR": BinaryDDGR, "DDH": BinaryDDH}[name]()
    else:
        raise ValueError(f"unsupported BINARY model {binary_name!r}")
    model.add_component(comp)
    comp.add_prefix_members(keys)
    return comp
