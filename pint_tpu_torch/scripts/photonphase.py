"""Compute pulse phases for photon events; report the H-test.

(reference: src/pint/scripts/photonphase.py — event FITS + par ->
per-photon phases, H-test significance, optional phase column written
back; the JAX package's ``scripts/photonphase.py``.)

    python -m pint_tpu_torch.scripts.photonphase <events> <par> \\
        [--device cuda] [--outfile out.fits] [--absphase]

The timing model's phase of every photon and the H-test run on
``--device`` (default ``cuda``; the H-test's harmonic sums go through
the hand-written kernel there). Not ported, each raising
``NotImplementedError``: ``--orbfile`` (satellite observatories, ROADMAP
item 7), ``--polycos`` (item 16) and ``--weightcol CALC`` with an
ecliptic par file (``modelutils``, item 16).
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
    p.add_argument("--orbfile", help="spacecraft orbit FITS (not ported: "
                   "only barycentred events are)")
    p.add_argument("--weightcol", help="photon-weight column (Fermi)")
    p.add_argument("--minMJD", type=float, default=float("-inf"))
    p.add_argument("--maxMJD", type=float, default=float("inf"))
    p.add_argument("--outfile", help="write an event FITS copy with a "
                   "PULSE_PHASE column here")
    p.add_argument("--absphase", action="store_true",
                   help="include absolute pulse numbers (needs TZR*)")
    p.add_argument("--polycos", action="store_true",
                   help="evaluate phases via generated polycos (not ported)")
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

    if args.orbfile:
        raise NotImplementedError(
            "--orbfile: satellite observatories (observatory/satellite_obs."
            "py) are host ingest, ROADMAP item 7, not ported")
    if args.polycos:
        raise NotImplementedError(
            "--polycos: polycos (polycos.py) are ROADMAP item 16, not "
            "ported")
    device = resolve_device(args.device)
    model = get_model(args.parfile)
    mission = args.mission
    if mission is None:
        header, _ = get_table(args.eventfile, "EVENTS")
        mission = str(header.get("TELESCOP", "generic")).strip()
    mission = mission.lower()
    if mission == "glast":  # Fermi FT1 files carry the old name
        mission = "fermi"
    if args.weightcol == "CALC" and mission != "fermi":
        print("--weightcol CALC is only supported for Fermi FT1 files "
              f"(mission here: {mission}); pass a real weight column",
              file=sys.stderr)
        return 1
    if args.weightcol == "CALC":
        # heuristic PSF weights from the par-file position
        # (reference: photonphase --weightcol CALC behavior)
        from ..event_toas import load_Fermi_TOAs

        if not hasattr(model, "RAJ"):
            raise NotImplementedError(
                "--weightcol CALC with an ecliptic par file needs "
                "modelutils.model_ecliptic_to_equatorial, ROADMAP item "
                "16, not ported")
        target = (np.degrees(model.RAJ.value), np.degrees(model.DECJ.value))
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
