"""Read any supported par file and write it in a chosen output format.

(reference: src/pint/scripts/convert_parfile.py — load with get_model,
emit as_parfile(format=...), optionally converting TCB input; the JAX
package's ``scripts/convert_parfile.py``.) Host text work only: the
script evaluates no model, so it takes no ``--device``.

    python -m pint_tpu_torch.scripts.convert_parfile <par> -f tempo2 -o out.par
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="convert_parfile",
        description="Convert a par file between pint/tempo/tempo2 "
                    "output conventions")
    p.add_argument("input_par")
    p.add_argument("-f", "--format", default="pint",
                   choices=("pint", "tempo", "tempo2"),
                   help="output format (default: pint)")
    p.add_argument("-o", "--out", default=None,
                   help="output par file (default: stdout)")
    p.add_argument("--allow-tcb", action="store_true",
                   help="convert a TCB par file to TDB on load")
    args = p.parse_args(argv)

    from ..models import get_model

    model = get_model(args.input_par, allow_tcb=args.allow_tcb)
    text = model.as_parfile(format=args.format)
    if args.out is None:
        sys.stdout.write(text)
    else:
        with open(args.out, "w") as fh:
            fh.write(text)
        print(f"Wrote {args.format} par file {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
