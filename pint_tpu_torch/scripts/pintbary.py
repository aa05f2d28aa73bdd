"""Quick barycentring: topocentric MJD(UTC) -> barycentric TDB.

(reference: src/pint/scripts/pintbary.py — time + site + sky position
-> SSB arrival time through the full delay chain; the JAX package's
``scripts/pintbary.py``.)

    python -m pint_tpu_torch.scripts.pintbary 56000.0 56000.5 \\
        --ra 12:00:00 --dec 15:00:00 [--obs gbt] [--device cuda]

The clock chain, TDB and posvels run on the host; the model's delay
runs on ``--device`` (default ``cuda``).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="pintbary",
                                description="Barycenter times (pint_tpu_torch)")
    p.add_argument("time", nargs="+", help="MJD(UTC) values")
    p.add_argument("--parfile", help="par file for sky position/DM")
    p.add_argument("--ra", help="RAJ hh:mm:ss.s (if no par)")
    p.add_argument("--dec", help="DECJ dd:mm:ss.s (if no par)")
    p.add_argument("--obs", default="geocenter")
    p.add_argument("--freq", type=float, default=float("inf"), help="MHz")
    p.add_argument("--dm", type=float, default=0.0)
    p.add_argument("--ephem", default="de440s")
    p.add_argument("--device", default="cuda",
                   help="torch device of the delay (default cuda)")
    args = p.parse_args(argv)

    from .. import resolve_device
    from ..mjd import Epochs, format_mjd, parse_mjd_string
    from ..models import get_model
    from ..toa import TOA, TOAs

    device = resolve_device(args.device)
    if args.parfile:
        model = get_model(args.parfile)
    else:
        if not (args.ra and args.dec):
            p.error("need --parfile or --ra/--dec")
        model = get_model(f"PSR BARY\nRAJ {args.ra}\nDECJ {args.dec}\n"
                          f"F0 1.0\nPEPOCH 55000\nDM {args.dm}\n")
    toalist = []
    for s in args.time:
        day, sec = parse_mjd_string(s)
        toalist.append(TOA(day, sec, error_us=0.0, freq_mhz=args.freq,
                           obs=args.obs))
    toas = TOAs(toalist, ephem=args.ephem)
    toas.apply_clock_corrections()
    toas.compute_TDBs()
    toas.compute_posvels()
    delay = model.delay(toas, device=device).cpu().numpy()
    bat = Epochs(toas.tdb.day, toas.tdb.sec - delay, "tdb").normalized()
    for i in range(len(toas)):
        print(format_mjd(int(bat.day[i]), float(bat.sec[i]), ndigits=13))
    return 0


if __name__ == "__main__":
    sys.exit(main())
