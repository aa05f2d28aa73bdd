"""The port's TOA-axis sharding (pint_tpu_torch/parallel/toa_shard.py):
``sharded_gls_fit`` (f64 with the noise hoist, f64 unhoisted, mixed),
``sharded_residuals`` and ``sharded_chi2`` over meshes of repeated
``cpu`` entries, against the port's single-device GLSFitter and the JAX
package's sharded fit on its eight forced host devices
(tests/test_parallel.py's TSHARD pulsar: 122 TOAs, ECORR epochs
straddling shard boundaries, 122 % 8 != 0 so the padding is active).

Tolerances: the sharded fit against the port's GLSFitter at the JAX
test's tiers (parameters 1e-9 relative, uncertainties 1e-6; the
hoisted fit meets 1e-12 / 1e-10); mixed against f64 as in the JAX test
(1e-9, chi2 1e-9, uncertainties 1e-4); against
the JAX package 1e-6 sigma, and chi2 to 5e-8 relative (its 1e-9 tier is
out of reach: 2.10e-9 measured, the port's GLSFitter alike; ROADMAP §3).
"""

import warnings

import numpy as np
import pytest

from test_torch_pta import port_toas

PAR = ("PSR TSHARD\nRAJ 11:00:00\nDECJ 05:00:00\nF0 301.2 1\n"
       "F1 -3e-16 1\nPEPOCH 55400\nDM 21.0 1\n"
       "EFAC -f L 1.15\nECORR -f L 0.7\n"
       "RNAMP 8e-15\nRNIDX -3.2\nTNREDC 6\n")
PAR_WHITE = ("PSR TWHITE\nRAJ 11:00:00\nDECJ 05:00:00\nF0 301.2 1\n"
             "F1 -3e-16 1\nPEPOCH 55400\nDM 21.0 1\nEFAC -f L 1.15\n")
PAR_SPIN = ("PSR TSPIN\nRAJ 11:00:00\nDECJ 05:00:00\nF0 301.2 1\n"
            "F1 -3e-16 1\nPEPOCH 55400\nDM 21.0 1\n")
MESH8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def pulsar():
    """(JAX TOAs, port TOAs) of the TSHARD pulsar (the JAX test's)."""
    from pint_tpu.models import get_model as jax_model
    from pint_tpu.simulation import make_fake_toas_fromMJDs

    rng = np.random.default_rng(3)
    days = np.sort(rng.uniform(55000, 55800, 61))
    mjds = np.sort(np.concatenate([days, days + 1.0 / 86400.0]))
    freqs = np.where(np.arange(len(mjds)) % 2, 1400.0, 800.0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jt = make_fake_toas_fromMJDs(mjds, jax_model(PAR), error_us=1.0,
                                     freq_mhz=freqs, obs="gbt",
                                     add_noise=True, seed=3, iterations=1)
    for fl in jt.flags:
        fl["f"] = "L"
    return jt, port_toas(jt)


def _fitter_ref(par, toas):
    from pint_tpu_torch.fitter import GLSFitter
    from pint_tpu_torch.models import get_model

    f = GLSFitter(toas, get_model(par), device="cpu")
    f.fit_toas(maxiter=2)
    names = [n for n, _, _ in get_model(par).prepare(
        toas, device="cpu").free_param_map()]
    x = np.array([float(getattr(f.model, n).value) for n in names])
    unc = np.array([float(getattr(f.model, n).uncertainty) for n in names])
    return x, unc


@pytest.fixture(scope="module")
def fits(pulsar):
    """The port's sharded fits over 8 shards: f64 (hoisted) and mixed,
    with their compile timings."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.parallel import make_mesh
    from pint_tpu_torch.parallel.toa_shard import sharded_gls_fit

    _, tt = pulsar
    mesh = make_mesh(devices=MESH8)
    timings = {"f64": {}, "mixed": {}}
    out = {p: sharded_gls_fit(get_model(PAR), tt, mesh, maxiter=2,
                              precision=p, compile_timings=timings[p],
                              watchdog_s=60.0)
           for p in ("f64", "mixed")}
    return out, timings


def test_sharded_gls_matches_fitter(pulsar, fits):
    """8 shards against the port's single-device GLSFitter; mixed against
    f64; the hoisted f64 fit timed as pre_step + step_h, mixed as the
    unhoisted step; one shard against eight."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.parallel import make_mesh
    from pint_tpu_torch.parallel.toa_shard import sharded_gls_fit

    _, tt = pulsar
    (out, timings) = fits
    x, chi2, cov = out["f64"]
    x_ref, unc_ref = _fitter_ref(PAR, tt)
    np.testing.assert_allclose(x, x_ref, rtol=1e-12, atol=0)
    np.testing.assert_allclose(np.sqrt(np.diag(cov)), unc_ref, rtol=1e-10)
    xm, chi2m, covm = out["mixed"]
    np.testing.assert_allclose(xm, x, rtol=1e-9, atol=1e-18)
    assert abs(chi2m - chi2) <= 1e-9 * abs(chi2)
    np.testing.assert_allclose(np.sqrt(np.diag(covm)),
                               np.sqrt(np.diag(cov)), rtol=1e-4)
    assert set(timings["f64"]) == {"pre_step", "step_h"}
    assert set(timings["mixed"]) == {"step"}
    assert all(t["backend_compile_s"] == 0.0 and t["trace_s"] >= 0
               for t in timings["f64"].values())
    x1, chi21, _ = sharded_gls_fit(get_model(PAR), tt,
                                   make_mesh(devices=["cpu"]), maxiter=2)
    np.testing.assert_allclose(x1, x, rtol=1e-12, atol=0)
    assert abs(chi21 - chi2) <= 1e-12 * chi2


def test_sharded_gls_matches_jax(pulsar, fits):
    """The port's 8-shard fits against the JAX package's on its 8 host
    devices, f64 and mixed: 1e-6 sigma; chi2 to 5e-8 (ROADMAP §3)."""
    import jax
    from jax.sharding import Mesh

    from pint_tpu.models import get_model as jax_model
    from pint_tpu.parallel.toa_shard import sharded_gls_fit as jax_fit

    jt, _ = pulsar
    mesh = Mesh(np.array(jax.devices()[:8]), axis_names=("toa",))
    out, _ = fits
    for precision in ("f64", "mixed"):
        jx, jc, jcov = jax_fit(jax_model(PAR), jt, mesh, maxiter=2,
                               precision=precision)
        x, chi2, cov = out[precision]
        sig = np.sqrt(np.diag(np.asarray(jcov)))
        assert np.max(np.abs(x - np.asarray(jx)) / sig) <= 1e-6
        assert abs(chi2 - float(jc)) <= 5e-8 * abs(float(jc))
        np.testing.assert_allclose(np.sqrt(np.diag(cov)), sig, rtol=1e-5)


def test_unhoisted_f64_and_uneven_shards(pulsar):
    """A white-noise model (no basis columns: the unhoisted f64 step) over
    3 uneven-padded shards against the port's GLSFitter; a watchdog
    bound on the pull."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.parallel import make_mesh
    from pint_tpu_torch.parallel.toa_shard import sharded_gls_fit

    _, tt = pulsar
    timings = {}
    x, chi2, cov = sharded_gls_fit(get_model(PAR_WHITE), tt,
                                   make_mesh(devices=["cpu"] * 3),
                                   maxiter=2, compile_timings=timings,
                                   watchdog_s=60.0)
    assert set(timings) == {"step"}
    x_ref, unc_ref = _fitter_ref(PAR_WHITE, tt)
    np.testing.assert_allclose(x, x_ref, rtol=1e-9, atol=1e-18)
    np.testing.assert_allclose(np.sqrt(np.diag(cov)), unc_ref, rtol=1e-6)
    assert np.isfinite(chi2)


def test_sharded_residuals_and_chi2(pulsar):
    """sharded_residuals / sharded_chi2 with the JAX package's signature
    (params, TOABatch and prep of one pulsar; a spin-only model, as the
    JAX test's): the residuals equal the unsharded Residuals' and chi2
    the JAX package's Residuals chi2, the quantity the JAX test holds
    its sharded chi2 to; rows that do not split evenly raise."""
    from pint_tpu.models import get_model as jax_model
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.parallel import make_mesh
    from pint_tpu_torch.parallel.toa_shard import (sharded_chi2,
                                                   sharded_residuals)
    from pint_tpu_torch.residuals import Residuals

    jt, tt = pulsar
    m = get_model(PAR_SPIN)
    prepared = m.prepare(tt, device="cpu")
    static = {k: v for k, v in prepared.prep.items()
              if isinstance(v, (bool, str))
              or k in ("planet_shapiro", "orb_mode_fb")}
    prep = {k: v for k, v in prepared.prep.items()
            if k not in ("T_ld", "pepoch_day", "pepoch_sec")
            and k not in static}
    mesh = make_mesh(devices=["cpu"] * 2)
    r = sharded_residuals(m, static, mesh, prepared.params0,
                          prepared.batch, prep)
    ref = Residuals(tt, m, device="cpu")
    np.testing.assert_allclose(r.numpy(), np.asarray(ref.time_resids),
                               rtol=0, atol=1e-15)
    chi2 = sharded_chi2(m, static, mesh, prepared.params0, prepared.batch,
                        prep)
    from pint_tpu.residuals import Residuals as JaxResiduals

    jc = float(JaxResiduals(jt, jax_model(PAR_SPIN)).chi2)
    assert abs(chi2 - jc) <= 5e-8 * jc
    from pint_tpu_torch.parallel.toa_shard import _data_spec

    # the TOA dimension: by length (the JAX package's rule), or by a
    # prep array's layout, which also settles a square (n, n) array
    assert _data_spec(np.zeros((3, 8)), 8) == 1
    assert _data_spec(np.zeros(()), 8) is None
    assert _data_spec(np.zeros((8, 8)), 8, key="pw_dts") == 1
    assert _data_spec(np.zeros(8), 8, key="ecorr_owner") is None
    with pytest.raises(ValueError, match="split evenly"):
        sharded_chi2(m, static, make_mesh(devices=["cpu"] * 5),
                     prepared.params0, prepared.batch, prep)


def _formulation_gaps(n_toa=30000):
    """The gaps ROADMAP §3 logs, on the CPU: the TSHARD pulsar's chi2
    (8 shards) against the JAX package's sharded fit, and each
    package's GLSFitter chi2 against the other's; then ``chip_smoke``'s
    ``[mesh] toa`` pulsar (``par_text(0)``, build_pta's MJDs for
    ``n_toa`` zero-residual TOAs, seed 0): in each package, the sharded
    fit (4 shards, f64 and mixed) against its GLSFitter's returned
    iterate and against each of its Gauss-Newton iterates x0, x1, x2, in
    sigma, with the iterates' chi2; the port's sharded fit against the
    JAX package's. 30,000 TOAs take ~25 min and ~15 GB on an 8-core CPU."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import jax
    from jax.sharding import Mesh

    import pint_tpu.fitter as jax_fitter
    import pint_tpu_torch.fitter as port_fitter
    from chip_smoke import alternating_freqs, fitter_iterates, par_text
    from pint_tpu.models import get_model as jax_model
    from pint_tpu.parallel.toa_shard import sharded_gls_fit as jax_fit
    from pint_tpu.simulation import make_fake_toas_fromMJDs
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.parallel import make_mesh
    from pint_tpu_torch.parallel.toa_shard import sharded_gls_fit

    def jax_mesh(k):
        return Mesh(np.array(jax.devices()[:k]), axis_names=("toa",))

    jt, tt = pulsar.__wrapped__()
    _, jc, _ = jax_fit(jax_model(PAR), jt, jax_mesh(8), maxiter=2)
    _, tc, _ = sharded_gls_fit(get_model(PAR), tt,
                               make_mesh(devices=MESH8), maxiter=2)
    jf = jax_fitter.GLSFitter(jt, jax_model(PAR))
    jf.fit_toas(maxiter=2)
    tf = port_fitter.GLSFitter(tt, get_model(PAR), device="cpu")
    tf.fit_toas(maxiter=2)
    print(f"TSHARD chi2: sharded port vs JAX {abs(tc - jc) / jc:.3e}; "
          f"GLSFitter port vs JAX "
          f"{abs(tf.resids.chi2 - jf.resids.chi2) / jf.resids.chi2:.3e}")
    par = par_text(0)
    days = np.sort(np.random.default_rng(0).uniform(54000, 57000,
                                                    n_toa // 4))
    mjds = (days[:, None] + np.arange(4) * 0.5 / 86400.0).reshape(-1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jt = make_fake_toas_fromMJDs(
            mjds, jax_model(par), error_us=1.0,
            freq_mhz=alternating_freqs(len(mjds)), flags={"f": "L-wide"},
            iterations=2)
    tt = port_toas(jt)
    names = [n for n, _, _ in jax_model(par).prepare(jt).free_param_map()]

    def fitter_gaps(label, module, make, shard_fit, mesh, get):
        f = make()
        x0 = np.array([float(getattr(f.model, n).value) for n in names])
        chi2s, steps = fitter_iterates(module, lambda: f.fit_toas(maxiter=2))
        x_ret = np.array([float(getattr(f.model, n).value) for n in names])
        sig = np.array([float(getattr(f.model, n).uncertainty)
                        for n in names])
        its = [x0]
        for dx in steps:
            its.append(its[-1] - dx[1:1 + len(names)])
        print(f"{n_toa} TOAs, {label} GLSFitter: chi2 of x0, x1, x2 "
              f"{chi2s}; returned iterate off x0, x1, x2 by "
              f"{[float(np.max(np.abs(x - x_ret) / sig)) for x in its]} sigma")
        out = {}
        for precision in ("f64", "mixed"):
            x = np.asarray(shard_fit(get(par), mesh, maxiter=2,
                                     precision=precision)[0])
            out[precision] = x
            print(f"  {label} sharded {precision}, 4 shards: vs returned "
                  f"{np.max(np.abs(x - x_ret) / sig):.3e}; vs x0, x1, x2 "
                  + ", ".join(f"{np.max(np.abs(x - xk) / sig):.3e}"
                              for xk in its))
        return out, sig

    jx, sig = fitter_gaps(
        "JAX", jax_fitter, lambda: jax_fitter.GLSFitter(jt, jax_model(par)),
        lambda m, mesh, **kw: jax_fit(m, jt, mesh, **kw), jax_mesh(4),
        jax_model)
    tx, _ = fitter_gaps(
        "port", port_fitter,
        lambda: port_fitter.GLSFitter(tt, get_model(par), device="cpu"),
        lambda m, mesh, **kw: sharded_gls_fit(m, tt, mesh, **kw),
        make_mesh(devices=["cpu"] * 4), get_model)
    for precision in ("f64", "mixed"):
        print(f"  port vs JAX sharded {precision}: "
              f"{np.max(np.abs(tx[precision] - jx[precision]) / sig):.3e}")


if __name__ == "__main__":
    # XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    #     python tests/test_torch_toa_shard.py [n_toa]   # ROADMAP §3's gaps
    import sys

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    _formulation_gaps(*map(int, sys.argv[1:2]))
