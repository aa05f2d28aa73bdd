"""Regenerate the synthetic NGC6440E example .tim from NGC6440E.par.

The example mirrors PINT's tutorial dataset layout (62 GBT TOAs, two
frequencies, ~2005-2008) but is synthesized in-repo: no reference data
exists offline, so the .tim is zero-residual + seeded Gaussian noise
under the full precision chain. The port's copy of the JAX package's
generator, on the port's ``get_model``, ``simulation`` and
``get_TOAs`` (the host chain in numpy, the phase of the zero-residual
passes on ``--device``, the card by default). Its epochs match the JAX
package's to ~1e-12 s: each package's own phase moves the zero-residual
pass by ulps. Regenerate after any intentional physics change, then
justify the delta in the commit message:

    python pint_tpu_torch/data/examples/generate_ngc6440e.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", ".."))

import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

_HEADER = """FORMAT 1
C Synthetic NGC6440E example (62 TOAs, GBT) regenerated with the
C current precision chain (see git log); zero-residual + seeded
C Gaussian noise from per-TOA errors. Mirrors PINT's tutorial
C example layout.
"""


def main(device="cuda"):
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.simulation import make_fake_toas_fromMJDs
    from pint_tpu_torch.toa import get_TOAs

    par = os.path.join(HERE, "NGC6440E.par")
    tim = os.path.join(HERE, "NGC6440E.tim")
    m = get_model(par)
    # keep the existing observing layout (epochs, freqs, errors)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        old = get_TOAs(tim, usepickle=False)
        mjds = old.day + old.sec / 86400.0
        t = make_fake_toas_fromMJDs(mjds, m, error_us=old.error_us,
                                    freq_mhz=old.freq_mhz, obs="gbt",
                                    add_noise=True, seed=6440,
                                    device=device)
    t.compute_posvels()
    lines = []
    for i in range(len(t)):
        day, frac = int(t.day[i]), int(round(t.sec[i] / 86400.0 * 1e16))
        if frac == 10**16:  # rounding carried into the next day
            day, frac = day + 1, 0
        mjd_str = f"{day}.{frac:016d}"
        lines.append(f"pint_tpu {t.freq_mhz[i]:.6f} {mjd_str} "
                     f"{t.error_us[i]:.3f} gbt -name ngc6440e")
    with open(tim, "w") as fh:
        fh.write(_HEADER)
        fh.write("\n".join(lines) + "\n")
    print(f"wrote {tim}: {len(t)} TOAs (provider {t.ephem_provider})")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
