"""Simulate fake TOAs from a timing model.

(reference: src/pint/scripts/zima.py — par -> zero-residual TOAs +
optional noise -> tim file; the JAX package's ``scripts/zima.py``.)

    python -m pint_tpu_torch.scripts.zima <par> <out.tim> \\
        [--ntoa 100] [--addnoise] [--wideband] [--inputtim in.tim] \\
        [--device cuda]

The model's phase (and, with ``--wideband``, its DM) is evaluated on
``--device`` (default ``cuda``); the noise draws come from
``numpy.random.default_rng(--seed)`` in the JAX package's order.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="zima",
                                description="Simulate TOAs (pint_tpu_torch)")
    p.add_argument("parfile")
    p.add_argument("timfile", help="output tim file")
    p.add_argument("--startMJD", type=float, default=56000.0)
    p.add_argument("--duration", type=float, default=400.0, help="days")
    p.add_argument("--ntoa", type=int, default=100)
    p.add_argument("--error", type=float, default=1.0, help="TOA sigma (us)")
    p.add_argument("--freq", type=float, default=1400.0, help="MHz")
    p.add_argument("--obs", default="gbt")
    p.add_argument("--addnoise", action="store_true")
    p.add_argument("--addcorrnoise", action="store_true",
                   help="also draw the model's correlated-noise "
                        "realizations (ECORR/red/DM/chromatic noise)")
    p.add_argument("--wideband", action="store_true",
                   help="attach per-TOA wideband DM measurements "
                        "(-pp_dm/-pp_dme flags) at the model DM")
    p.add_argument("--dmerror", type=float, default=1e-4,
                   help="wideband DM uncertainty, pc cm^-3")
    p.add_argument("--fuzzdays", type=float, default=0.0,
                   help="jitter the uniform epochs by up to +/-this/2 days")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--inputtim", help="take MJDs/freqs/errors from this tim"
                   " file instead of a uniform grid")
    p.add_argument("--device", default="cuda",
                   help="torch device of the model evaluations "
                        "(default cuda)")
    args = p.parse_args(argv)

    from .. import resolve_device
    from ..models import get_model
    from ..simulation import make_fake_toas_fromtim, make_fake_toas_uniform

    device = resolve_device(args.device)
    model = get_model(args.parfile)
    if args.inputtim:
        toas = make_fake_toas_fromtim(
            args.inputtim, model, add_noise=args.addnoise,
            add_correlated_noise=args.addcorrnoise, seed=args.seed,
            wideband=args.wideband, dm_error_pccm3=args.dmerror,
            device=device)
    else:
        toas = make_fake_toas_uniform(
            args.startMJD, args.startMJD + args.duration, args.ntoa, model,
            error_us=args.error, freq_mhz=args.freq, obs=args.obs,
            add_noise=args.addnoise,
            add_correlated_noise=args.addcorrnoise, seed=args.seed,
            wideband=args.wideband, dm_error_pccm3=args.dmerror,
            fuzz_days=args.fuzzdays, device=device)
    toas.write_TOA_file(args.timfile, name="zima")
    print(f"Wrote {len(toas)} simulated TOAs to {args.timfile}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
