"""Convert a TCB par file to TDB units.

(reference: src/pint/scripts/tcb2tdb.py -> models/tcb_conversion.py;
the JAX package's ``scripts/tcb2tdb.py``.) Host work only: no
``--device``.

    python -m pint_tpu_torch.scripts.tcb2tdb <tcb.par> <tdb.par>
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tcb2tdb")
    p.add_argument("input_par")
    p.add_argument("output_par")
    args = p.parse_args(argv)

    from ..models import get_model
    from ..models.tcb_conversion import convert_tcb_tdb

    model = get_model(args.input_par, allow_tcb="raw")
    units = (model.UNITS.value or "").upper() if "UNITS" in model.params else ""
    if units not in ("TCB", "SI"):
        print(f"input par file is not in TCB units (UNITS "
              f"{units or 'TDB'}); refusing to convert", file=sys.stderr)
        return 1
    convert_tcb_tdb(model)
    model.write_parfile(args.output_par)
    print(f"Wrote TDB par file {args.output_par}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
