"""A LaTeX table of a fitted timing model.

(reference: src/pint/scripts/pintpublish.py — par -> LaTeX parameter
table with measured and fixed sections; the JAX package's
``scripts/pintpublish.py``.) Host work only: no ``--device``.

    python -m pint_tpu_torch.scripts.pintpublish <par> [--outfile t.tex]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="pintpublish")
    p.add_argument("parfile")
    p.add_argument("--outfile", help="write .tex here (default stdout)")
    args = p.parse_args(argv)

    from ..models import get_model

    model = get_model(args.parfile)
    rows_fit, rows_fixed = [], []
    for pname in model.params:
        par = getattr(model, pname)
        if par.value is None:
            continue
        if getattr(par, "frozen", True) or par.uncertainty is None:
            rows_fixed.append(f"{pname} & {par.value} \\\\")
        else:
            rows_fit.append(
                f"{pname} & ${par.value:.12g} \\pm {par.uncertainty:.2g}$ \\\\")
    name = getattr(model, "PSR", None)
    title = name.value if name is not None and name.value else "pulsar"
    tex = "\n".join(
        ["\\begin{table}", f"\\caption{{Timing parameters for {title}}}",
         "\\begin{tabular}{ll}", "\\hline",
         "\\multicolumn{2}{c}{Measured parameters} \\\\", "\\hline"]
        + rows_fit
        + ["\\hline", "\\multicolumn{2}{c}{Fixed parameters} \\\\", "\\hline"]
        + rows_fixed
        + ["\\hline", "\\end{tabular}", "\\end{table}", ""])
    if args.outfile:
        with open(args.outfile, "w") as f:
            f.write(tex)
        print(f"Wrote {args.outfile}")
    else:
        print(tex)
    return 0


if __name__ == "__main__":
    sys.exit(main())
