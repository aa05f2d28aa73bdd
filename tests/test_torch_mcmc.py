"""The port's inference (priors.py, bayesian.py, sampler.py,
mcmc_fitter.py and the event_optimize scripts) against the JAX
package's, on the CPU.

Inputs are made with numpy from seeds, or are the NGC6440E example, and
are handed to both packages.

Tolerances:
- priors: logpdf to 1e-14 relative; sample and ppf bitwise (host
  numpy/scipy in both packages);
- BayesianTiming on NGC6440E: lnprior, lnlikelihood, lnposterior (one
  vector and vmapped over a batch) and prior_transform to 1e-9
  relative (the packages' phases differ by ulps);
- the sampler fed the JAX package's own draws (rebuilt from its key
  sequence): chain and lnprob within 1e-10 of ``run_ensemble``'s,
  relative to the scale of each, over 20 steps;
- the binned-template likelihoods on 20,000 photons: 1e-9 relative at
  five parameter vectors;
- tests/test_mcmc.py's eight tests, mirrored with the port's own
  torch.Generator, at their own tolerances.
"""

import contextlib
import io
import math
import warnings

import numpy as np
import pytest
import torch

from test_torch_fitter import JAX_PAR, JAX_TIM
from test_torch_ingest import NGC_PAR, NGC_TIM

warnings.simplefilter("ignore")

PAR = """
PSR MCMCTEST
RAJ 06:30:00.0
DECJ -28:00:00.0
F0 300.0 1
F1 -1e-15 1
PEPOCH 55100
DM 20.0
"""
PHOTON_PAR = """
PSR TESTEV
RAJ 10:00:00.0
DECJ 15:00:00.0
F0 29.946923 1 1e-9
F1 -3.77e-10 1 1e-16
PEPOCH 56700
DM 0.0
"""
NICER_REF = 56658.000777592593


# ---------------- tests/test_mcmc.py, mirrored ----------------

def test_ensemble_sampler_gaussian_target():
    from pint_tpu_torch.sampler import run_ensemble

    inv = torch.tensor([1.0, 4.0, 0.25], dtype=torch.float64)

    def logpost(x):
        return -0.5 * torch.sum(x**2 / inv)

    x0 = np.random.default_rng(0).standard_normal((32, 3))
    chain, lp, acc = run_ensemble(logpost, x0, 1500, seed=1, device="cpu")
    assert 0.2 < acc < 0.9
    flat = chain[500:].reshape(-1, 3)
    assert np.abs(flat.mean(axis=0)).max() < 0.25
    assert flat[:, 1].std() == pytest.approx(2.0, rel=0.2)
    assert flat[:, 2].std() == pytest.approx(0.5, rel=0.2)


@pytest.fixture(scope="module")
def fitted():
    from pint_tpu_torch.fitter import WLSFitter
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.simulation import make_fake_toas_fromMJDs

    model = get_model(PAR)
    toas = make_fake_toas_fromMJDs(np.linspace(54800, 55400, 25), model,
                                   error_us=2.0, obs="gbt", add_noise=True,
                                   seed=11, device="cpu")
    f = WLSFitter(toas, model, device="cpu")
    f.fit_toas()
    return f


def test_bayesian_timing_posterior_peak(fitted):
    from pint_tpu_torch.bayesian import BayesianTiming

    bt = BayesianTiming(fitted.model, fitted.toas, device="cpu")
    x0 = bt.initial_position()
    lp0 = float(bt.lnposterior(torch.as_tensor(x0)))
    dx = np.zeros_like(x0)
    dx[bt.param_labels.index("F0")] = 20 * fitted.model.F0.uncertainty
    assert float(bt.lnposterior(torch.as_tensor(x0 + dx))) < lp0 - 3.0


def test_bayesian_prior_gates(fitted):
    from pint_tpu_torch.bayesian import BayesianTiming

    bt = BayesianTiming(fitted.model, fitted.toas, device="cpu",
                        prior_info={"F0": {"min": 299.9, "max": 300.1}})
    x = bt.initial_position()
    x[bt.param_labels.index("F0")] = 300.2
    assert np.isneginf(float(bt.lnposterior(torch.as_tensor(x))))


def test_prior_transform(fitted):
    from pint_tpu_torch.bayesian import BayesianTiming

    bt = BayesianTiming(fitted.model, fitted.toas, device="cpu")
    lo = bt.prior_transform(np.zeros(bt.nparams))
    hi = bt.prior_transform(np.ones(bt.nparams))
    mid = bt.prior_transform(0.5 * np.ones(bt.nparams))
    assert np.all(lo < mid) and np.all(mid < hi)
    np.testing.assert_allclose(mid, bt.initial_position(), rtol=1e-10)


def test_mcmc_fitter_recovers(fitted):
    from pint_tpu_torch.mcmc_fitter import MCMCFitter

    mf = MCMCFitter(fitted.toas, fitted.model, seed=3, device="cpu")
    mf.fit_toas(n_steps=300)
    for p in ("F0", "F1"):
        wls = getattr(fitted.model, p)
        assert abs(getattr(mf.model, p).value - wls.value) < 5 * wls.uncertainty
    samples = mf.get_posterior_samples(burn=75)
    assert set(samples) == set(mf.bt.param_labels)
    s = samples["F0"].std()
    unc = fitted.model.F0.uncertainty
    assert 0.2 * unc < s < 5 * unc
    assert mf.converged and mf.parameter_covariance_matrix.shape == (2, 2)


def test_gaussian_prior_logpdf():
    from pint_tpu_torch.priors import GaussianPrior

    expected = -0.5 * 0.25 - math.log(2.0 * math.sqrt(2 * math.pi))
    assert float(GaussianPrior(1.0, 2.0).logpdf(2.0)) == pytest.approx(
        expected, rel=1e-12)


def test_uniform_prior_bounds():
    from pint_tpu_torch.priors import UniformBoundedPrior

    pr = UniformBoundedPrior(0.0, 2.0)
    assert np.isneginf(float(pr.logpdf(2.5)))
    assert float(pr.logpdf(1.0)) == pytest.approx(-np.log(2.0))
    assert pr.ppf(0.25) == 0.5


def test_composite_mcmc_fitter():
    """Two photon sets sharing one model: the composite likelihood is
    the sum of the per-set template likelihoods, and a short chain
    runs (tests/test_mcmc.py's composite test)."""
    from pint_tpu_torch.mcmc_fitter import (CompositeMCMCFitter,
                                            MCMCFitterBinnedTemplate)
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.simulation import make_fake_toas_fromMJDs

    par = ("PSR TCOMP\nRAJ 12:00:00\nDECJ 10:00:00\nF0 2.0 1\n"
           "F1 0.0\nPEPOCH 55000\nDM 0.0\n")
    m = get_model(par)
    rng = np.random.default_rng(0)
    sets, templates = [], []
    for _ in range(2):
        mjds = np.sort(rng.uniform(55000, 55002, 400))
        sets.append(make_fake_toas_fromMJDs(
            mjds, m, error_us=1.0, freq_mhz=np.inf, obs="@",
            add_noise=False, device="cpu"))
        templates.append(1.0 + 0.8 * np.cos(
            2 * np.pi * (np.arange(32) + 0.5) / 32))
    prior = {"F0": {"min": 1.9999, "max": 2.0001}}
    f = CompositeMCMCFitter(sets, m, templates, n_walkers=16, seed=1,
                            prior_info=prior, device="cpu")
    x0 = torch.as_tensor(f.bt.initial_position())
    lnl = float(f.bt._lnlike_raw(x0))
    assert np.isfinite(lnl)
    parts = 0.0
    for t, tpl in zip(sets, templates):
        fb = MCMCFitterBinnedTemplate(t, get_model(par), tpl, n_walkers=16,
                                      prior_info=prior, device="cpu")
        parts += float(fb.bt._lnlike_raw(
            torch.as_tensor(fb.bt.initial_position())))
    assert lnl == pytest.approx(parts, rel=1e-9)
    f.fit_toas(n_steps=60)
    assert np.isfinite(f.maxpost)


# ---------------- against the JAX package ----------------

def test_priors_match_jax():
    from scipy.stats import norm

    from pint_tpu import priors as jp
    from pint_tpu_torch import priors as tp

    pairs = [(tp.UniformBoundedPrior(-1.0, 3.0), jp.UniformBoundedPrior(-1.0, 3.0)),
             (tp.GaussianPrior(0.5, 2.0), jp.GaussianPrior(0.5, 2.0)),
             (tp.GaussianBoundedPrior(0.5, 2.0, -1.0, 3.0),
              jp.GaussianBoundedPrior(0.5, 2.0, -1.0, 3.0)),
             (tp.GaussianBoundedPrior(0.0, 1.0, 9.0, 12.0),
              jp.GaussianBoundedPrior(0.0, 1.0, 9.0, 12.0)),
             (tp.ScipyPrior(norm(1.0, 3.0)), jp.ScipyPrior(norm(1.0, 3.0)))]
    x = np.linspace(-2.0, 13.0, 61)
    u = np.linspace(0.01, 0.99, 25)
    for a, b in pairs:
        la = a.logpdf(torch.as_tensor(x)).numpy()
        lb = np.asarray(b.logpdf(x))
        assert np.array_equal(np.isneginf(la), np.isneginf(lb))
        fin = np.isfinite(lb)
        np.testing.assert_allclose(la[fin], lb[fin], rtol=1e-14, atol=0)
        np.testing.assert_array_equal(
            a.sample(np.random.default_rng(5), size=40),
            b.sample(np.random.default_rng(5), size=40))
        np.testing.assert_array_equal(a.ppf(u), b.ppf(u))
    assert float(tp.Prior().logpdf(3.0)) == 0.0
    with pytest.raises(ValueError):
        tp.Prior().ppf(0.5)
    # vmap-safe: a batch of values through torch.func.vmap
    g = tp.GaussianBoundedPrior(0.5, 2.0, -1.0, 3.0)
    v = torch.func.vmap(g.logpdf)(torch.as_tensor(x))
    np.testing.assert_array_equal(v.numpy(), g.logpdf(torch.as_tensor(x)))


@pytest.fixture(scope="module")
def ngc_bt():
    """(port BayesianTiming, JAX BayesianTiming) on NGC6440E, the free
    parameters given the JAX package's WLS uncertainties
    (NGC6440E_postfit.json) so the default priors exist and agree."""
    import json

    import pint_tpu
    import pint_tpu_torch
    from pint_tpu.bayesian import BayesianTiming as JBT
    from pint_tpu_torch.bayesian import BayesianTiming

    from test_torch_fitter import POSTFIT

    unc = json.loads(POSTFIT.read_text())["fitters"]["WLSFitter"][
        "uncertainties"]
    m, t = pint_tpu_torch.get_model_and_toas(str(NGC_PAR), str(NGC_TIM))
    jm, jt = pint_tpu.get_model_and_toas(str(JAX_PAR), str(JAX_TIM))
    for model in (m, jm):
        for p in model.free_params:
            getattr(model, p).uncertainty = unc[p]
    return BayesianTiming(m, t, device="cpu"), JBT(jm, jt)


def test_bayesian_timing_matches_jax(ngc_bt):
    bt, jbt = ngc_bt
    assert bt.param_labels == jbt.param_labels
    np.testing.assert_array_equal(bt.initial_position(),
                                  jbt.initial_position())
    np.testing.assert_array_equal(bt.scales(), jbt.scales())
    x0 = bt.initial_position()
    xs = x0 + bt.scales() * np.random.default_rng(6).standard_normal(
        (6, bt.nparams))
    xs[-1, 0] = bt.priors[0].upper + 1.0  # outside the prior: -inf
    for x in xs:
        xt = torch.as_tensor(x)
        for name in ("lnprior", "lnlikelihood", "lnposterior"):
            a = float(getattr(bt, name)(xt))
            b = float(getattr(jbt, name)(x))
            assert a == b or abs(a - b) <= 1e-9 * abs(b), (name, a, b)
    batch = torch.func.vmap(bt.lnposterior)(torch.as_tensor(xs)).numpy()
    ref = np.array([float(jbt.lnposterior(x)) for x in xs])
    assert np.isneginf(batch[-1]) and np.isneginf(ref[-1])
    np.testing.assert_allclose(batch[:-1], ref[:-1], rtol=1e-9, atol=0)
    u = np.random.default_rng(7).random((4, bt.nparams))
    for ui in u:
        np.testing.assert_allclose(bt.prior_transform(ui),
                                   jbt.prior_transform(ui), rtol=1e-9)


def _jax_draws(seed, n_steps, n_w):
    """The JAX package's draws of run_ensemble(seed, thin=1), rebuilt
    from its key sequence: split(PRNGKey(seed), n_steps); per step
    split -> (ka, kb); per half split(., 3) -> uniform / randint /
    uniform."""
    import jax

    half = n_w // 2
    out = []
    for key in jax.random.split(jax.random.PRNGKey(seed), n_steps):
        for k in jax.random.split(key):
            k1, k2, k3 = jax.random.split(k, 3)
            out.append((np.asarray(jax.random.uniform(k1, (half,))),
                        np.asarray(jax.random.randint(k2, (half,), 0, half)),
                        np.asarray(jax.random.uniform(k3, (half,)))))
    return out


def _replay(draws):
    it = iter(draws)

    def draw(n_movers, n_others):
        u, idx, v = next(it)
        assert len(u) == n_movers and n_others == n_movers
        return (torch.as_tensor(u, dtype=torch.float64),
                torch.as_tensor(idx, dtype=torch.int64),
                torch.as_tensor(v, dtype=torch.float64))
    return draw


def _chain_gap(a, b):
    scale = np.maximum(np.abs(b), 1.0)
    return float(np.max(np.abs(a - b) / scale))


def test_sampler_replays_jax_draws_gaussian():
    import jax.numpy as jnp

    from pint_tpu.sampler import run_ensemble as jrun
    from pint_tpu_torch.sampler import run_ensemble

    w = np.array([1.0, 4.0, 0.25])
    wt = torch.as_tensor(w)
    x0 = np.random.default_rng(0).standard_normal((16, 3))
    jc, jl, ja = jrun(lambda x: -0.5 * jnp.sum(x**2 / jnp.asarray(w)),
                      x0, 20, seed=4)
    tc, tl, ta = run_ensemble(lambda x: -0.5 * torch.sum(x**2 / wt), x0,
                              20, seed=4, device="cpu",
                              _draws=_replay(_jax_draws(4, 20, 16)))
    assert _chain_gap(tc, jc) <= 1e-10
    assert _chain_gap(tl, jl) <= 1e-10
    assert ta == ja


def test_sampler_replays_jax_draws_bayesian_timing(ngc_bt):
    from pint_tpu.sampler import run_ensemble as jrun
    from pint_tpu_torch.sampler import run_ensemble

    bt, jbt = ngc_bt
    n_w = 16
    x0 = bt.initial_position() + 0.1 * bt.scales() * np.random.default_rng(
        1).standard_normal((n_w, bt.nparams))
    jc, jl, ja = jrun(jbt.lnposterior, x0, 20, seed=2)
    tc, tl, ta = run_ensemble(bt.lnposterior, x0, 20, seed=2, device="cpu",
                              _draws=_replay(_jax_draws(2, 20, n_w)))
    # parameters relative to each one's prior scale
    scale = bt.scales()
    assert float(np.max(np.abs(tc - jc) / scale)) <= 1e-10
    assert _chain_gap(tl, jl) <= 1e-10
    assert ta == ja


def _photon_file(path, n, seed):
    """n barycentred NICER photons over 2 d, pulsed (von Mises at
    phase 0.3) by the first-order spindown inversion, with weights."""
    from pint_tpu_torch.io.fits import write_fits_table

    rng = np.random.default_rng(seed)
    f0, f1 = 29.946923, -3.77e-10
    pulse = rng.integers(0, int(2 * 86400 * f0), n)
    ph = (rng.vonmises(2 * np.pi * 0.3, 4.0, n) / (2 * np.pi)) % 1.0
    dt = (pulse + ph) / f0
    dt = dt - 0.5 * f1 * dt**2 / f0
    met = np.sort(dt + (56700 - NICER_REF) * 86400)
    write_fits_table(path, {"TIME": met, "PSRPROB": rng.random(n)},
                     {"MJDREFI": int(NICER_REF),
                      "MJDREFF": NICER_REF - int(NICER_REF),
                      "TIMESYS": "TDB", "TELESCOP": "NICER"})


@pytest.fixture(scope="module")
def photon_sets(tmp_path_factory):
    d = tmp_path_factory.mktemp("photons")
    paths = [d / "a.fits", d / "b.fits"]
    _photon_file(paths[0], 20_000, 3)
    _photon_file(paths[1], 10_000, 4)
    return paths


def test_binned_template_likelihoods_match_jax(photon_sets):
    """MCMCFitterBinnedTemplate and CompositeMCMCFitter: the template
    likelihood at five parameter vectors, 1e-9 relative."""
    from pint_tpu.event_toas import get_event_weights as jweights
    from pint_tpu.event_toas import load_event_TOAs as jload
    from pint_tpu.mcmc_fitter import (CompositeMCMCFitter as JComp,
                                      MCMCFitterBinnedTemplate as JBin)
    from pint_tpu.models import get_model as jget
    from pint_tpu_torch.event_toas import get_event_weights, load_event_TOAs
    from pint_tpu_torch.mcmc_fitter import (CompositeMCMCFitter,
                                            MCMCFitterBinnedTemplate)
    from pint_tpu_torch.models import get_model

    tpl = [1.0 + 0.9 * np.cos(2 * np.pi * ((np.arange(64) + 0.5) / 64 - 0.3)),
           1.0 + 0.5 * np.cos(2 * np.pi * ((np.arange(32) + 0.5) / 32 - 0.3))]
    tt = [load_event_TOAs(p, "nicer", weightcolumn="PSRPROB")
          for p in photon_sets]
    jt = [jload(p, "nicer", weightcolumn="PSRPROB") for p in photon_sets]
    tw = [get_event_weights(t) for t in tt]
    jw = [jweights(t) for t in jt]
    fits = [(MCMCFitterBinnedTemplate(tt[0], get_model(PHOTON_PAR), tpl[0],
                                      weights=tw[0], device="cpu"),
             JBin(jt[0], jget(PHOTON_PAR), tpl[0], weights=jw[0])),
            (CompositeMCMCFitter(tt, get_model(PHOTON_PAR), tpl,
                                 weights_list=tw, device="cpu"),
             JComp(jt, jget(PHOTON_PAR), tpl, weights_list=jw))]
    rng = np.random.default_rng(9)
    for f, jf in fits:
        x0 = f.bt.initial_position()
        np.testing.assert_array_equal(x0, jf.bt.initial_position())
        for k in range(5):
            x = x0 + k * f.bt.scales() * rng.standard_normal(x0.shape)
            a = float(f.bt._lnlike_raw(torch.as_tensor(x)))
            b = float(jf.bt._lnlike_raw(x))
            assert abs(a - b) <= 1e-9 * abs(b), (k, a, b)
            a = float(f.bt.lnposterior(torch.as_tensor(x)))
            b = float(jf.bt.lnposterior(x))
            assert a == b or abs(a - b) <= 1e-9 * abs(b), (k, a, b)


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def test_event_optimize_scripts_run_on_the_cpu(tmp_path):
    """Both event scripts end to end on the CPU, --nsteps 20, on small
    photon sets (3,000 and 2,000 photons)."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.scripts.event_optimize import main as eo
    from pint_tpu_torch.scripts.event_optimize_multiple import main as eom

    photon_sets = [tmp_path / "a.fits", tmp_path / "b.fits"]
    _photon_file(photon_sets[0], 3_000, 3)
    _photon_file(photon_sets[1], 2_000, 4)
    par = tmp_path / "p.par"
    par.write_text(PHOTON_PAR)
    post = tmp_path / "post.par"
    rc, out = _run(eo, [str(photon_sets[0]), str(par), "--weightcol",
                        "PSRPROB", "--nbins", "32", "--nsteps", "20",
                        "--device", "cpu", "--outfile", str(post)])
    assert rc == 0 and "max posterior" in out
    m = get_model(str(post))
    assert abs(m.F0.value - 29.946923) < 5e-9
    lst = tmp_path / "sets.txt"
    lst.write_text(f"{photon_sets[0]} nicer - PSRPROB\n# a comment\n"
                   f"{photon_sets[1]}\n")
    rc, out = _run(eom, [str(lst), str(par), "--nsteps", "20", "--nbins",
                         "16", "--device", "cpu"])
    assert rc == 0 and out.count("Read ") == 2 and "accept" in out
    (tmp_path / "empty.txt").write_text("# nothing\n")
    rc, _ = _run(eom, [str(tmp_path / "empty.txt"), str(par), "--device",
                       "cpu"])
    assert rc == 1


def test_mcmc_needs_a_card_unless_asked(monkeypatch, fitted):
    from pint_tpu_torch.mcmc_fitter import MCMCFitter
    from pint_tpu_torch.sampler import run_ensemble

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_ensemble(lambda x: -torch.sum(x**2), np.zeros((4, 1)), 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MCMCFitter(fitted.toas, fitted.model)


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(),
                    reason="needs an NVIDIA card: the sampler's CUDA "
                    "generator and sync checks run only there")
def test_step_loop_makes_no_host_sync_on_the_card():
    """On the card the sampler's step loop (sampler._walk) calls
    nothing that synchronizes with the host."""
    import warnings as w

    from pint_tpu_torch import sampler

    walk, found = sampler._walk, []

    def watched(*a, **k):
        with w.catch_warnings(record=True) as caught:
            w.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = walk(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        found.extend(str(c.message) for c in caught
                     if "called a synchronizing CUDA operation"
                     in str(c.message))
        return out

    sampler._walk = watched
    try:
        chain, lp, acc = sampler.run_ensemble(
            lambda x: -0.5 * torch.sum(x * x),
            np.random.default_rng(0).standard_normal((16, 3)), 30,
            device="cuda")
    finally:
        sampler._walk = walk
    assert not found and np.isfinite(chain).all() and 0 < acc < 1
