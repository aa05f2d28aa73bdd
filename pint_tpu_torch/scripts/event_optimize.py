"""MCMC optimization of a timing model against photon events.

(reference: src/pint/scripts/event_optimize.py — FT1/event FITS + par
+ template -> emcee over the timing parameters with the binned
template likelihood; the JAX package's ``scripts/event_optimize.py``.)

    python -m pint_tpu_torch.scripts.event_optimize <events> <par> \\
        [--weightcol PSRPROB] [--nbins 64] [--nsteps 500] \\
        [--template tpl.txt] [--outfile post.par] [--device cuda]

The ensemble sampler and the photons' phases run on ``--device``
(default ``cuda``), through MCMCFitterBinnedTemplate.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="event_optimize")
    p.add_argument("eventfile")
    p.add_argument("parfile")
    p.add_argument("--mission", default="nicer")
    p.add_argument("--weightcol")
    p.add_argument("--nbins", type=int, default=64,
                   help="template phase bins (fit from the data when no "
                   "--template given)")
    p.add_argument("--template", help="two-column text file (phase, rate) "
                   "or produced by a previous run")
    p.add_argument("--nsteps", type=int, default=500)
    p.add_argument("--outfile", help="post-fit par file")
    p.add_argument("--device", default="cuda",
                   help="torch device of the phases and the sampler "
                   "(default cuda)")
    args = p.parse_args(argv)

    import numpy as np

    from .. import resolve_device
    from ..event_toas import get_event_weights, load_event_TOAs
    from ..mcmc_fitter import MCMCFitterBinnedTemplate
    from ..models import get_model
    from ._event_common import default_priors, empirical_template, report_fit

    device = resolve_device(args.device)
    model = get_model(args.parfile)
    toas = load_event_TOAs(args.eventfile, args.mission,
                           weightcolumn=args.weightcol)
    weights = get_event_weights(toas)
    print(f"Read {len(toas)} photons")
    if args.template:
        tpl = np.loadtxt(args.template)
        template = tpl[:, 1] if tpl.ndim == 2 else tpl
        # the fitter normalizes templates itself (_normalized_template)
    else:
        template = empirical_template(model, toas, weights, args.nbins,
                                      device=device)
    fit = MCMCFitterBinnedTemplate(toas, model, template, weights=weights,
                                   prior_info=default_priors(model, [toas]),
                                   device=device)
    fit.fit_toas(n_steps=args.nsteps)
    report_fit(fit, args.outfile)
    return 0


if __name__ == "__main__":
    sys.exit(main())
