"""Compute pulse phases for photon events; report the H-test.

(reference: src/pint/scripts/photonphase.py — event FITS + par
[+ orbit file] -> per-photon phases, H-test significance, optional
phase column written back and polyco mode; the JAX package's
``scripts/photonphase.py``.)

    python -m pint_tpu_torch.scripts.photonphase <events> <par> \\
        [--orbfile orbit.fits] [--polycos] [--weightcol COL|CALC] \\
        [--device cuda] [--outfile out.fits] [--absphase]

``--orbfile`` registers the mission's satellite observatory, so
spacecraft-frame (TT) events are barycentred through the orbit;
``--polycos`` evaluates the phases from polycos generated over the
photons' span instead of the full model; ``--weightcol CALC`` computes
Fermi-LAT weights about the par file's position, converting an
ecliptic par file to equatorial first. The model phase (and the
polycos' node phases) and the H-test run on ``--device`` (default
``cuda``; the H-test's harmonic sums go through the hand-written
kernel there).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="photonphase",
                                description="Photon phases (pint_tpu_torch)")
    p.add_argument("eventfile")
    p.add_argument("parfile")
    p.add_argument("--mission", default=None,
                   help="nicer/nustar/rxte/xmm/swift/fermi (default: "
                   "TELESCOP header keyword)")
    p.add_argument("--orbfile", help="spacecraft orbit FITS (needed unless "
                   "the events are barycentered)")
    p.add_argument("--weightcol", help="photon-weight column (Fermi)")
    p.add_argument("--minMJD", type=float, default=float("-inf"))
    p.add_argument("--maxMJD", type=float, default=float("inf"))
    p.add_argument("--outfile", help="write an event FITS copy with a "
                   "PULSE_PHASE column here")
    p.add_argument("--absphase", action="store_true",
                   help="include absolute pulse numbers (needs TZR*)")
    p.add_argument("--polycos", action="store_true",
                   help="evaluate phases via generated polycos instead "
                        "of the full pipeline (reference: photonphase "
                        "--polycos fast path)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the phase and H-test (default cuda)")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from .. import resolve_device
    from ..event_toas import get_event_weights, load_event_TOAs
    from ..eventstats import h2sig, hm, hmw
    from ..io.fits import get_table
    from ..models import get_model

    device = resolve_device(args.device)
    model = get_model(args.parfile)
    mission = args.mission
    if mission is None:
        header, _ = get_table(args.eventfile, "EVENTS")
        mission = str(header.get("TELESCOP", "generic")).strip()
    mission = mission.lower()
    if mission == "glast":  # Fermi FT1 files carry the old name
        mission = "fermi"
    if args.orbfile:
        from ..observatory.satellite_obs import get_satellite_observatory

        get_satellite_observatory(mission, args.orbfile)
    if args.weightcol == "CALC" and mission != "fermi":
        print("--weightcol CALC is only supported for Fermi FT1 files "
              f"(mission here: {mission}); pass a real weight column",
              file=sys.stderr)
        return 1
    if args.weightcol == "CALC":
        # heuristic PSF weights from the par-file position
        # (reference: photonphase --weightcol CALC behavior); an
        # ecliptic par file is converted so ELONG/ELAT pulsars work too
        from ..event_toas import load_Fermi_TOAs

        if not hasattr(model, "RAJ"):
            from ..modelutils import model_ecliptic_to_equatorial

            model_eq = model_ecliptic_to_equatorial(model)
        else:
            model_eq = model
        target = (np.degrees(model_eq.RAJ.value),
                  np.degrees(model_eq.DECJ.value))
        toas = load_Fermi_TOAs(args.eventfile, weightcolumn="CALC",
                               targetcoord=target,
                               minmjd=args.minMJD, maxmjd=args.maxMJD)
    else:
        toas = load_event_TOAs(args.eventfile, mission,
                               weightcolumn=args.weightcol,
                               minmjd=args.minMJD, maxmjd=args.maxMJD)
    print(f"Read {len(toas)} photons from {args.eventfile} ({mission})")
    if len(toas) == 0:
        print("no photons in the MJD window", file=sys.stderr)
        return 1
    if args.polycos:
        from types import SimpleNamespace

        from ..polycos import Polycos

        mjds = toas.get_mjds()
        pcs = Polycos.generate_polycos(
            model, float(mjds.min()) - 0.02, float(mjds.max()) + 0.02,
            obs=str(toas.obs[0]), obsFreq=float(np.median(toas.freq_mhz)),
            device=device)
        pi_, pf = pcs.eval_abs_phase(mjds)
        print(f"Generated {len(pcs.entries)} polyco segments")
        # pf is in [0, 1): int_ + frac is the absolute phase, and the
        # writer's negative-frac borrow does nothing
        ph_obj = SimpleNamespace(
            int_=torch.as_tensor(pi_.astype(np.float64), device=device),
            frac=torch.as_tensor(pf, device=device))
    else:
        ph_obj = model.phase(toas, device=device)
    phases = torch.remainder(ph_obj.frac, 1.0)
    w = get_event_weights(toas)
    h = float(hmw(phases, w, device=device) if w is not None
              else hm(phases, device=device))
    print(f"Htest : {h:.2f}  ({h2sig(h):.2f} sigma)")
    print(f"H = {h!r}")
    if args.outfile:
        header, cols = get_table(args.eventfile, "EVENTS")
        from ..event_toas import _mjdref_days, met_to_day_sec
        from ..io.fits import write_fits_table

        # apply the same MJD window the loader applied, so the phase
        # column lines up with the written rows
        tcol = next(k for k in cols if k.upper() == "TIME")
        day, sec = met_to_day_sec(np.asarray(cols[tcol], np.float64),
                                  _mjdref_days(header, mission))
        mjd_f = day + sec / 86400.0
        keep = (mjd_f >= args.minMJD) & (mjd_f <= args.maxMJD)
        out_cols = {k: np.asarray(v)[keep] for k, v in cols.items()}
        out_cols["PULSE_PHASE"] = phases.cpu().numpy()
        if args.absphase:
            # Phase.frac is in [-0.5, 0.5) but PULSE_PHASE is frac % 1,
            # so borrow a cycle where frac went negative to keep
            # NUMBER + PHASE == int_ + frac exactly
            frac = ph_obj.frac.cpu().numpy()
            out_cols["PULSE_NUMBER"] = (ph_obj.int_.cpu().numpy()
                                        - (frac < 0))
        keep = {k: header[k] for k in ("MJDREFI", "MJDREFF", "MJDREF",
                                       "TIMESYS", "TELESCOP") if k in header}
        write_fits_table(args.outfile, out_cols, keep, extname="EVENTS")
        print(f"Wrote {args.outfile}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
