"""Compare two par files parameter by parameter.

(reference: src/pint/scripts/compare_parfiles.py ->
TimingModel.compare(); the JAX package's
``scripts/compare_parfiles.py``.) Host work only: no ``--device``.

    python -m pint_tpu_torch.scripts.compare_parfiles <par1> <par2> [--sigma 3]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="compare_parfiles")
    p.add_argument("par1")
    p.add_argument("par2")
    p.add_argument("--sigma", type=float, default=None,
                   help="only show parameters differing by more than "
                        "this many combined uncertainties")
    args = p.parse_args(argv)

    from ..models import get_model

    m1 = get_model(args.par1)
    m2 = get_model(args.par2)
    print(m1.compare(m2, sigma=args.sigma))
    return 0


if __name__ == "__main__":
    sys.exit(main())
