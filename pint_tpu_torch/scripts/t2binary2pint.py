"""Convert a tempo2 "BINARY T2" par file to the closest native binary
model (reference: src/pint/scripts/t2binary2pint.py; the JAX package's
``scripts/t2binary2pint.py``).

Tempo2's T2 model is a universal container; the parameters present
pick the concrete model (``models.binary.choose_t2_model``):

    KIN/KOM                  -> DDK   (Kopeikin geometry)
    EPS1/EPS2 (+H3/H4/STIG)  -> ELL1 / ELL1H
    ECC/OM + M2/SINI         -> DD
    ECC/OM                   -> BT

The converted text is validated by building a model from it before it
is written. Host work only: no ``--device``.

    python -m pint_tpu_torch.scripts.t2binary2pint <t2.par> <out.par>
"""

from __future__ import annotations

import argparse
import re
import sys

from ..models.binary import choose_t2_model as choose_model


def convert_t2_par(text: str) -> tuple[str, str]:
    """(converted par text, chosen model). Raises if no BINARY line."""
    lines = text.splitlines()
    keys = set()
    binary_idx = None
    for i, line in enumerate(lines):
        parts = line.split()
        if not parts:
            continue
        key = parts[0].upper()
        keys.add(key)
        if key == "BINARY":
            binary_idx = i
    if binary_idx is None:
        raise ValueError("par file has no BINARY line")
    target = choose_model(keys)
    lines[binary_idx] = re.sub(r"(?i)^(\s*BINARY\s+)\S+",
                               lambda m: m.group(1) + target,
                               lines[binary_idx])
    # tempo2 spells STIGMA as STIG in some files
    out = [re.sub(r"(?i)^(\s*)STIG(\s)", r"\1STIGMA\2", ln) for ln in lines]
    return "\n".join(out) + "\n", target


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="t2binary2pint")
    p.add_argument("input_par")
    p.add_argument("output_par")
    args = p.parse_args(argv)

    from ..models import get_model

    with open(args.input_par) as f:
        text = f.read()
    converted, target = convert_t2_par(text)
    model = get_model(converted)  # validate before writing
    model.write_parfile(args.output_par)
    print(f"Converted BINARY T2 -> {target}; wrote {args.output_par}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
