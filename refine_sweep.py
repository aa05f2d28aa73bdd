"""Step count of the packed mixed refinement on the ``[zoo] fleet``.

Builds chip_smoke.py's zoo fleet (68 pulsars, 669,488 GBT TOAs,
isolated/ELL1/ELL1H/DD with DMX, FD and a receiver JUMP) on the card,
fits it in f64 from 3 sigma off the truth, then in mixed precision with
``fitter.seg_gls_eigh_refine`` taking 2, 3, 4, 5, 6 and 8 steps. Prints
per step count the fit's wall, the worst refinement relres and
``max |x_mixed - x_f64| / sigma`` overall and per structure.

    python3 refine_sweep.py      # needs a CUDA card; ~75 s on an H100
"""

import functools
import time
import warnings

import numpy as np
import torch

import chip_smoke as cs
from pint_tpu_torch.parallel import pta

STEPS = (2, 3, 4, 5, 6, 8)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("refine_sweep: no CUDA card")
    print(cs.gpu_line(), flush=True)
    warnings.simplefilter("ignore")
    models, toas = cs.build_pta(cs.ragged_counts(), "cuda",
                                par_fn=cs.zoo_par_text,
                                freq_fn=cs.zoo_freqs, flag_fn=cs.zoo_flags)
    fleet = pta.PTAFleet(models, toas, toa_bucket="plan", device="cuda")
    names = {i: [n for n, _, _ in fleet.batches[k].free_map()]
             for k, idx in fleet.group_indices.items() for i in idx}
    x_true = [np.array([getattr(models[i], n).value for n in names[i]])
              for i in range(len(models))]
    _, _, covs = fleet.fit(method="gls", maxiter=2, precision="f64")
    sig = [np.sqrt(np.diag(c)) for c in covs]
    x0 = [x + cs.START_OFFSET_SIGMA * s * np.where(np.arange(len(x)) % 2,
                                                   1, -1)
          for x, s in zip(x_true, sig)]
    for k, idx in fleet.group_indices.items():
        fleet.batches[k].set_start_vector(np.array([x0[i] for i in idx]))
    x64, _, _ = fleet.fit(method="gls", maxiter=2, precision="f64")
    refine = pta.seg_gls_eigh_refine
    try:
        for steps in STEPS:
            pta.seg_gls_eigh_refine = functools.partial(refine, iters=steps)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            xm, _, covm = fleet.fit(method="gls", maxiter=2,
                                    precision="mixed")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            d = [np.abs(np.asarray(a) - b) / np.sqrt(np.diag(c))
                 for a, b, c in zip(xm, x64, covm)]
            w = int(np.argmax([v.max() for v in d]))
            per = {s: max(d[i].max() for i in range(len(d)) if i % 4 == j)
                   for j, s in enumerate(cs.ZOO_STRUCTURES)}
            relres = max(m["relres_max"] for m in fleet.fit_metrics.values())
            print(f"steps {steps}: wall {wall:.3f} s, relres {relres:.3e}, "
                  f"mixed vs f64 {d[w].max():.3e} sigma (pulsar {w}, "
                  f"{len(toas[w])} TOAs, {names[w][int(np.argmax(d[w]))]}); "
                  + ", ".join(f"{k} {v:.2e}" for k, v in per.items()),
                  flush=True)
    finally:
        pta.seg_gls_eigh_refine = refine


if __name__ == "__main__":
    main()
