"""Fit a timing model to TOAs: the tempo/tempo2 command-line equivalent.

(reference: src/pint/scripts/pintempo.py — par + tim -> fit -> summary,
optional output par; the JAX package's ``scripts/pintempo.py``.)

    python -m pint_tpu_torch.scripts.pintempo <par> <tim> \\
        [--fitter auto|wls|gls|downhill_wls|downhill_gls|wideband] \\
        [--outfile post.par] [--device cuda]

The fit runs on ``--device`` (default ``cuda``). ``--fitter auto``
picks WidebandDownhillFitter for wideband TOAs (-pp_dm flags),
DownhillGLSFitter with correlated noise and DownhillWLSFitter without.
``--plot`` raises ``NotImplementedError``, as ``Fitter.plot`` does:
``plot_utils.py`` is not ported (ROADMAP §1 item 1).
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
    p.add_argument("--plot", action="store_true",
                   help="save a residual plot (not ported)")
    p.add_argument("--plotfile", default="pintempo_resids.png")
    p.add_argument("--maxiter", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="torch device of the fit (default cuda)")
    args = p.parse_args(argv)

    from .. import fitter as F
    from .. import resolve_device
    from ..models import get_model
    from ..toa import get_TOAs

    if args.plot:
        raise NotImplementedError(
            "--plot needs plot_utils.py, which is not ported to "
            "pint_tpu_torch yet (ROADMAP §1 item 1)")
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
