"""The port's top-level helpers and the red-noise basis padding of its
batches.

- ``pint_tpu_torch.get_model(parfile)`` / ``get_TOAs(timfile)``, the
  JAX package's ``pint_tpu.get_model`` / ``get_TOAs``: both packages'
  top-level helpers on the NGC6440E example give prefit time residuals
  within 1e-12 s.
- ``parallel/pta.py::_toa_dim_pad``: a pulsar whose TOA count equals
  its red-noise basis width (20 TOAs, TNREDC 10: an (n, 2 TNREDC) basis
  with n == 2 TNREDC) padded into a bucket beside a larger pulsar. The
  padding axis comes from the array's layout, not from which dimension
  equals the TOA count; the bucket's fit of that pulsar matches its
  unpadded fit within 1e-6 sigma (ERRORBUDGET.md's batched-fit tier).
"""

import numpy as np
import pytest

from test_torch_ingest import NGC_PAR, NGC_TIM, ROOT

JAX_PAR = ROOT / "pint_tpu" / "data" / "examples" / "NGC6440E.par"
JAX_TIM = ROOT / "pint_tpu" / "data" / "examples" / "NGC6440E.tim"

TOL_RESID_S = 1e-12
TOL_SIGMA = 1e-6


def test_top_level_get_model_get_toas_match_jax():
    import pint_tpu
    import pint_tpu_torch
    from pint_tpu.residuals import Residuals as JResiduals
    from pint_tpu_torch.residuals import Residuals

    m = pint_tpu_torch.get_model(str(NGC_PAR))
    t = pint_tpu_torch.get_TOAs(str(NGC_TIM), model=m)
    jm = pint_tpu.get_model(str(JAX_PAR))
    jt = pint_tpu.get_TOAs(str(JAX_TIM), model=jm)
    assert list(m.components) == list(jm.components)
    assert len(t) == len(jt) == 62
    r = Residuals(t, m, device="cpu").time_resids
    jr = np.asarray(JResiduals(jt, jm).time_resids)
    assert np.abs(r - jr).max() <= TOL_RESID_S


def _pulsar(i, n_toa):
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.simulation import make_fake_toas_fromMJDs

    par = (f"PSR PAD{i}\nRAJ 0{i}:30:00.0\nDECJ 1{i}:00:00.0\n"
           f"F0 {250 + 7 * i}.125 1\nF1 -{2 + i}e-16 1\nPEPOCH 55500\n"
           f"DM {9 + i}.5 1\nEFAC -f L-wide 1.1\n"
           "TNREDAMP -13.5\nTNREDGAM 3.2\nTNREDC 10\n")
    m = get_model(par)
    mjds = np.sort(np.random.default_rng(i).uniform(55000, 56500, n_toa))
    t = make_fake_toas_fromMJDs(mjds, m, error_us=1.0,
                                freq_mhz=np.where(np.arange(n_toa) % 2,
                                                  800.0, 1400.0),
                                obs="gbt", add_noise=True, seed=10 + i,
                                flags={"f": "L-wide"}, device="cpu")
    return m, t


def test_toa_axis_from_layout():
    from pint_tpu_torch.parallel.pta import _toa_axis, _toa_dim_pad

    F = np.arange(400.0).reshape(20, 20)  # (n, 2 TNREDC), n == 20
    padded = _toa_dim_pad(F, 20, 36, _toa_axis("rn_F"))
    assert padded.shape == (36, 20) and not padded[20:].any()
    masks = np.ones((20, 20))
    assert _toa_dim_pad(masks, 20, 36, _toa_axis("efac_masks")).shape \
        == (20, 36)
    assert _toa_axis("pw_dts") == 1 and _toa_axis("ecorr_U") == 0
    freqs = np.arange(20.0)  # (2 TNREDC,): no TOA axis, never padded
    assert _toa_dim_pad(freqs, 20, 36, _toa_axis("rn_freqs")).shape == (20,)


def test_square_red_noise_basis_pads_along_toas():
    from pint_tpu_torch.parallel import PTABatch

    small, big = _pulsar(1, 20), _pulsar(2, 36)
    bucket = PTABatch([small[0], big[0]], [small[1], big[1]], device="cpu")
    assert bucket.prep["rn_F"].shape == (2, 36, 20)
    assert bucket.prep["rn_freqs"].shape == (2, 20)
    alone = PTABatch([small[0]], [small[1]], device="cpu")
    xb, cb, covb = bucket.gls_fit(maxiter=2)
    xa, ca, cova = alone.gls_fit(maxiter=2)
    sig = np.sqrt(np.diag(cova[0]))
    assert np.max(np.abs(xb[0] - xa[0]) / sig) <= TOL_SIGMA
    assert abs(cb[0] - ca[0]) <= 1e-9 * ca[0]


if __name__ == "__main__":
    pytest.main([__file__, "-q"])
