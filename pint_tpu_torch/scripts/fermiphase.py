"""Fermi-LAT photon phases (weighted H-test).

(reference: src/pint/scripts/fermiphase.py — FT1 + par ->
weighted phases; a thin wrapper over photonphase with the Fermi
weight-column convention, as the JAX package's ``fermiphase.py``.)
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="fermiphase")
    p.add_argument("ft1file")
    p.add_argument("parfile")
    p.add_argument("--weightcol", default=None,
                   help="photon-probability column from gtsrcprob")
    p.add_argument("--outfile")
    p.add_argument("--device", default="cuda",
                   help="torch device of the phase and H-test (default cuda)")
    args = p.parse_args(argv)

    from .photonphase import main as pp_main

    argv2 = [args.ft1file, args.parfile, "--mission", "fermi",
             "--device", args.device]
    if args.weightcol:
        argv2 += ["--weightcol", args.weightcol]
    if args.outfile:
        argv2 += ["--outfile", args.outfile]
    return pp_main(argv2)


if __name__ == "__main__":
    sys.exit(main())
