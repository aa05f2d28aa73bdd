"""Joint MCMC optimization of one timing model against several photon
event files.

(reference: src/pint/scripts/event_optimize_multiple.py — multiple
FT1/event FITS lists + par, each dataset with its own template and
weights, sampled jointly via CompositeMCMCFitter; the JAX package's
``scripts/event_optimize_multiple.py``.)

Each line of the input text file names one dataset:

    eventfile [mission] [template_file_or_-] [weightcol_or_-]

missing trailing fields default to --mission / empirical template /
unweighted. Spacecraft-frame files need their mission's satellite
observatory registered first (``observatory.satellite_obs``). The
sampler and every dataset's phases run on ``--device`` (default
``cuda``).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="event_optimize_multiple")
    p.add_argument("eventfiles",
                   help="text file: one 'eventfile [mission] [template|-] "
                        "[weightcol|-]' per line")
    p.add_argument("parfile")
    p.add_argument("--mission", default="nicer",
                   help="default mission for lines that omit it")
    p.add_argument("--nbins", type=int, default=64)
    p.add_argument("--nsteps", type=int, default=500)
    p.add_argument("--outfile", help="post-fit par file")
    p.add_argument("--device", default="cuda",
                   help="torch device of the phases and the sampler "
                   "(default cuda)")
    args = p.parse_args(argv)

    import numpy as np

    from .. import resolve_device
    from ..event_toas import get_event_weights, load_event_TOAs
    from ..mcmc_fitter import CompositeMCMCFitter
    from ..models import get_model
    from ._event_common import default_priors, empirical_template, report_fit

    device = resolve_device(args.device)
    model = get_model(args.parfile)
    toas_list, templates, weights_list = [], [], []
    with open(args.eventfiles) as fh:
        for line in fh:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            evt = parts[0]
            mission = parts[1] if len(parts) > 1 else args.mission
            tplspec = parts[2] if len(parts) > 2 else "-"
            wcol = parts[3] if len(parts) > 3 else "-"
            toas = load_event_TOAs(evt, mission,
                                   weightcolumn=None if wcol == "-" else wcol)
            w = get_event_weights(toas)
            if tplspec != "-":
                tpl = np.loadtxt(tplspec)
                template = tpl[:, 1] if tpl.ndim == 2 else tpl
            else:
                template = empirical_template(model, toas, w, args.nbins,
                                              device=device)
            print(f"Read {len(toas)} photons from {evt} ({mission})")
            toas_list.append(toas)
            templates.append(template)
            weights_list.append(w)
    if not toas_list:
        print("no datasets in input file", file=sys.stderr)
        return 1

    fit = CompositeMCMCFitter(toas_list, model, templates,
                              weights_list=weights_list,
                              prior_info=default_priors(model, toas_list),
                              device=device)
    fit.fit_toas(n_steps=args.nsteps)
    report_fit(fit, args.outfile)
    return 0


if __name__ == "__main__":
    sys.exit(main())
