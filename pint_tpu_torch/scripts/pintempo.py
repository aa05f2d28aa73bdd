"""Fit a timing model to TOAs: the tempo/tempo2 command-line equivalent.

(reference: src/pint/scripts/pintempo.py — par + tim -> fit -> summary,
optional output par; the JAX package's ``scripts/pintempo.py``.)

    python -m pint_tpu_torch.scripts.pintempo <par> <tim> \\
        [--fitter auto|wls|gls|downhill_wls|downhill_gls|wideband] \\
        [--outfile post.par] [--plot [--plotfile resid.png]] \\
        [--device cuda]

The fit runs on ``--device`` (default ``cuda``). ``--fitter auto``
picks WidebandDownhillFitter for wideband TOAs (-pp_dm flags),
DownhillGLSFitter with correlated noise and DownhillWLSFitter without.
``--plot`` saves the post-fit residuals with their error bars to
``--plotfile`` (matplotlib's Agg backend, on the host).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="pintempo",
        description="Fit a pulsar timing model (pint_tpu_torch)")
    p.add_argument("parfile")
    p.add_argument("timfile")
    p.add_argument("--fitter", default="auto",
                   choices=("auto", "wls", "gls", "downhill_wls",
                            "downhill_gls", "wideband"))
    p.add_argument("--outfile", help="write the post-fit par file here")
    p.add_argument("--plot", action="store_true", help="save resid plot")
    p.add_argument("--plotfile", default="pintempo_resids.png")
    p.add_argument("--maxiter", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="torch device of the fit (default cuda)")
    args = p.parse_args(argv)

    from .. import fitter as F
    from .. import resolve_device
    from ..models import get_model
    from ..toa import get_TOAs

    device = resolve_device(args.device)
    model = get_model(args.parfile)
    toas = get_TOAs(args.timfile, model=model)
    print(f"Read {len(toas)} TOAs from {args.timfile}")
    kinds = {"wls": F.WLSFitter, "gls": F.GLSFitter,
             "downhill_wls": F.DownhillWLSFitter,
             "downhill_gls": F.DownhillGLSFitter,
             "wideband": F.WidebandTOAFitter}
    if args.fitter == "auto":
        fit = F.auto_fitter(toas, model, device=device)
    else:
        fit = kinds[args.fitter](toas, model, device=device)
    print(f"Fitting with {type(fit).__name__} ...")
    fit.fit_toas(maxiter=args.maxiter)
    print(fit.get_summary())
    if args.outfile:
        fit.model.write_parfile(args.outfile)
        print(f"Wrote {args.outfile}")
    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import numpy as np

        r_us = np.asarray(fit.resids.time_resids) * 1e6
        mjd = toas.day + toas.sec / 86400.0
        plt.figure(figsize=(8, 4.5))
        plt.errorbar(mjd, r_us, yerr=toas.error_us, fmt=".", ms=3)
        plt.xlabel("MJD")
        plt.ylabel("Residual (us)")
        plt.title(f"{getattr(model, 'PSR').value or args.parfile} post-fit")
        plt.tight_layout()
        plt.savefig(args.plotfile, dpi=120)
        print(f"Wrote {args.plotfile}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
