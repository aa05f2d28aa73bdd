"""The port's pulse-profile templates and photon-template fit
(pint_tpu_torch/templates/) against the JAX package's, on the CPU.

Both packages get the same numpy phases, weights and energies, and the
same template parameters (``LCTemplate.get_parameters`` /
``set_parameters`` vectors).

Tolerances:
- densities of every primitive and of mixtures: 1e-12 relative (the
  same f64 expressions in torch and XLA);
- gradients of the log-likelihood, torch.autograd vs jax.grad: 1e-10
  relative to the largest component;
- fitted parameters after the same projected Adam loop: 1e-8 absolute;
  log-likelihood 1e-10 relative;
- Hessian-based parameter and phase-shift uncertainties: 1e-8
  relative.
"""

import numpy as np
import pytest
import torch

import pint_tpu.templates as jt
import pint_tpu_torch.templates as tt

DEV = "cpu"


def _photons(n=4000, seed=0, loc=0.3, width=0.04, frac=0.5):
    rng = np.random.default_rng(seed)
    k = int(frac * n)
    ph = np.concatenate([(loc + width * rng.standard_normal(k)) % 1.0,
                         rng.random(n - k)])
    return ph, rng.uniform(0.2, 1.0, n), rng.uniform(2.0, 4.5, n)


def _kde(mod):
    ph, w, _ = _photons(3000, seed=4)
    return mod.LCKernelDensity(ph, weights=w, nbins=256, loc=0.05)


# (class name, params); every primitive of the package
PRIMS = [("LCGaussian", [0.03, 0.4]), ("LCLorentzian", [0.02, 0.7]),
         ("LCSkewGaussian", [0.02, 0.05, 0.45]),
         ("LCGaussian2", [0.04, 0.01, 0.9]),
         ("LCLorentzian2", [0.01, 0.03, 0.2]),
         ("LCVonMises", [0.05, 0.7]), ("LCTopHat", [0.2, 0.95]),
         ("LCHarmonic", [3, 0.1]), ("LCKernelDensity", None)]
EPRIMS = [("LCEGaussian", [0.03, 0.4], [0.01, -0.02]),
          ("LCEVonMises", [0.05, 0.6], [0.005, 0.03]),
          ("LCELorentzian", [0.02, 0.2], [-0.003, 0.01])]


def _make(mod, name, p):
    return _kde(mod) if p is None else getattr(mod, name)(p)


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("name,p", PRIMS)
def test_primitive_densities_match(name, p):
    ph, _, _ = _photons(2000, seed=1)
    ph = np.concatenate([ph, [0.0, 0.5, 0.999999, -0.2, 1.3]])
    jp, tp = _make(jt, name, p), _make(tt, name, p)
    out = tp(torch.as_tensor(ph))
    assert out.dtype == torch.float64 and out.shape == ph.shape
    assert _rel(out.numpy(), jp(ph)) <= 1e-12
    assert abs(float(tp.integrate(device=DEV))
               - float(jp.integrate())) <= 1e-12
    if p is not None:
        assert float(tp.loc) == float(jp.loc)


@pytest.mark.parametrize("name,p,slopes", EPRIMS)
def test_energy_dependent_primitives_match(name, p, slopes):
    ph, _, ens = _photons(2000, seed=2)
    jp, tp = getattr(jt, name)(p, slopes), getattr(tt, name)(p, slopes)
    assert tp.n_params == jp.n_params == 4
    a = tp(torch.as_tensor(ph), log10_ens=torch.as_tensor(ens))
    assert _rel(a.numpy(), jp(ph, log10_ens=ens)) <= 1e-12
    assert _rel(tp(torch.as_tensor(ph)).numpy(), jp(ph)) <= 1e-12
    assert float(tp.loc) == float(jp.loc)


def _mixture(mod):
    return mod.LCTemplate([mod.LCGaussian([0.03, 0.3]),
                           mod.LCVonMises([0.08, 0.65]),
                           mod.LCLorentzian2([0.01, 0.02, 0.85])],
                          [0.3, 0.2, 0.1])


def test_template_mixture_matches():
    ph, _, _ = _photons(3000, seed=3)
    jm, tm = _mixture(jt), _mixture(tt)
    tph = torch.as_tensor(ph)
    assert _rel(tm(tph).numpy(), jm(ph)) <= 1e-12
    vec = jm.get_parameters()
    np.testing.assert_array_equal(tm.get_parameters(), vec)
    v2 = vec * (1 + 0.01 * np.arange(len(vec)))
    assert _rel(tm(tph, vec=torch.as_tensor(v2)).numpy(),
                jm(ph, vec=v2)) <= 1e-12
    assert abs(float(tm.integrate(device=DEV)) - float(jm.integrate())) \
        <= 1e-12
    assert tm.max_location(device=DEV) == pytest.approx(jm.max_location(),
                                                        abs=1e-12)
    assert _rel(tm.as_binned(64, device=DEV), jm.as_binned(64)) <= 1e-12
    tm.set_parameters(v2)
    assert _rel(tm.get_parameters(), v2) == 0
    # the second and third primitives' norms reach the density (the
    # JAX package's norms-by-primitive-number fix)
    for j in range(3):
        v3 = vec.copy()
        v3[j] += 0.05
        assert _rel(tm(tph, vec=torch.as_tensor(v3)).numpy(),
                    jm(ph, vec=v3)) <= 1e-12
        assert not np.allclose(jm(ph, vec=v3), jm(ph, vec=vec))
    ef = dict(profile=np.exp(-0.5 * ((np.arange(64) / 64 - 0.4) / 0.05) ** 2)
              + 0.2)
    for kw in (ef, dict(phases=ph, nharm=5)):
        je, te_ = jt.LCEmpiricalFourier(**kw), tt.LCEmpiricalFourier(**kw)
        np.testing.assert_array_equal(te_.alpha, je.alpha)
        assert _rel(te_(tph).numpy(), je(ph)) <= 1e-12
        assert te_.max_location(device=DEV) == pytest.approx(
            je.max_location(), abs=1e-12)


def test_norm_angles_match():
    norms = np.array([0.2, 0.35, 0.1, 0.05])
    a_t, a_j = tt.angles_from_norms(norms), jt.angles_from_norms(norms)
    np.testing.assert_array_equal(a_t, a_j)
    assert _rel(tt.norms_from_angles(a_t).numpy(),
                jt.norms_from_angles(a_j)) <= 1e-12
    assert _rel(tt.NormAngles(norms)(), norms) <= 1e-12
    one = tt.NormAngles([0.4])
    one.set_total(0.7)
    assert _rel(one(), [0.7]) <= 1e-12


def _negll_grads(template_j, template_t, ph, w, ens):
    import jax
    import jax.numpy as jnp

    fj, v0 = template_j.gradient_ready()
    ft, _ = template_t.gradient_ready()

    def lj(v):
        return jt.photon_loglike(fj(v, jnp.asarray(ph), log10_ens=ens),
                                 None if w is None else jnp.asarray(w))
    gj = np.asarray(jax.grad(lj)(jnp.asarray(v0)))
    v = torch.tensor(v0, requires_grad=True)
    lt = tt.photon_loglike(ft(v, torch.as_tensor(ph), log10_ens=None
                              if ens is None else torch.as_tensor(ens)),
                           None if w is None else torch.as_tensor(w))
    (gt,) = torch.autograd.grad(lt, v)
    return gt.numpy(), gj


@pytest.mark.parametrize("weighted", [False, True])
def test_loglike_gradients_match(weighted):
    ph, w, ens = _photons(3000, seed=5)
    w = w if weighted else None
    gt, gj = _negll_grads(_mixture(jt), _mixture(tt), ph, w, None)
    assert _rel(gt, gj) <= 1e-10
    for name, p in PRIMS:
        gt, gj = _negll_grads(jt.LCTemplate([_make(jt, name, p)], [0.4]),
                              tt.LCTemplate([_make(tt, name, p)], [0.4]),
                              ph, w, None)
        assert _rel(gt, gj) <= 1e-10, name
    for name, p, s in EPRIMS:
        gt, gj = _negll_grads(jt.LCTemplate([getattr(jt, name)(p, s)], [0.4]),
                              tt.LCTemplate([getattr(tt, name)(p, s)], [0.4]),
                              ph, w, ens)
        assert _rel(gt, gj) <= 1e-10, name


def _fit_pair(make, ph, w=None, ens=None, **kw):
    jm, tm = make(jt), make(tt)
    jf = jt.LCFitter(jm, ph, weights=w, log10_ens=ens)
    tf = tt.LCFitter(tm, ph, weights=w, log10_ens=ens, device=DEV)
    ll_j, ll_t = jf.fit(**kw), tf.fit(**kw)
    return jf, tf, ll_j, ll_t


@pytest.mark.parametrize("mode", ["unbinned", "binned", "weighted",
                                  "energy"])
def test_lcfitter_matches(mode):
    """The same projected Adam loop from the same start: parameters to
    1e-8, log-likelihood to 1e-10 relative, uncertainties to 1e-8."""
    ph, w, ens = _photons(3000, seed=6)

    def one(mod):
        return mod.LCTemplate([mod.LCGaussian([0.06, 0.27])], [0.4])

    def two(mod):
        return mod.LCTemplate([mod.LCGaussian([0.06, 0.27]),
                               mod.LCVonMises([0.1, 0.7])], [0.3, 0.1])

    def energy(mod):
        return mod.LCTemplate([mod.LCEGaussian([0.06, 0.27])], [0.4])

    kw = {"unbinned": (two, {}), "binned": (two, {"unbinned": False,
                                                  "nbins": 128}),
          "weighted": (one, {"w": w}), "energy": (energy, {"ens": ens})}
    make, opts = kw[mode]
    opts = dict(opts)
    fw, fe = opts.pop("w", None), opts.pop("ens", None)
    jf, tf, ll_j, ll_t = _fit_pair(make, ph, w=fw, ens=fe, steps=150, **opts)
    pj, pt = jf.template.get_parameters(), tf.template.get_parameters()
    assert np.abs(pt - pj).max() <= 1e-8
    assert abs(ll_t - ll_j) <= 1e-10 * abs(ll_j)
    loc = 3 if make is two else 2  # [norms..., sigma, loc, ...]
    assert abs(pt[loc] - 0.3) < 0.02  # the fit found the peak
    assert _rel(tf.param_uncertainties(), jf.param_uncertainties()) <= 1e-8
    assert abs(tf.phase_shift_uncertainty()
               - jf.phase_shift_uncertainty()) \
        <= 1e-8 * jf.phase_shift_uncertainty()
    assert abs(float(tf.loglikelihood()) - float(jf.loglikelihood())) \
        <= 1e-10 * abs(ll_j)


def test_binned_fit_refuses_weights_and_energies():
    ph, w, ens = _photons(500, seed=7)
    tm = tt.LCTemplate([tt.LCGaussian([0.06, 0.27])], [0.4])
    with pytest.raises(ValueError, match="weights"):
        tt.LCFitter(tm, ph, weights=w, device=DEV).fit(unbinned=False)
    with pytest.raises(ValueError, match="energy"):
        tt.LCFitter(tm, ph, log10_ens=ens, device=DEV).fit(unbinned=False)


def test_gauss_template_files_round_trip(tmp_path):
    """Each package reads the other's gauss template file to the same
    template; other primitives are refused by the writer."""
    tm = tt.LCTemplate([tt.LCGaussian([0.02, 0.25]),
                        tt.LCGaussian([0.05, 0.6])], [0.5, 0.3])
    tt.write_gauss_template(tm, tmp_path / "t.gauss")
    jt.write_gauss_template(jt.LCTemplate([jt.LCGaussian([0.02, 0.25]),
                                           jt.LCGaussian([0.05, 0.6])],
                                          [0.5, 0.3]), tmp_path / "j.gauss")
    assert (tmp_path / "t.gauss").read_text() == \
        (tmp_path / "j.gauss").read_text()
    for path in (tmp_path / "t.gauss", tmp_path / "j.gauss"):
        a, b = tt.gauss_template_from_file(path), jt.gauss_template_from_file(path)
        np.testing.assert_array_equal(a.get_parameters(), b.get_parameters())
        assert _rel(a.get_parameters(), tm.get_parameters()) <= 1e-5
    with pytest.raises(ValueError, match="LCGaussian"):
        tt.write_gauss_template(tt.LCTemplate([tt.LCVonMises([0.1, 0.2])],
                                              [0.3]), tmp_path / "x")
    (tmp_path / "empty").write_text("# nothing\n")
    with pytest.raises(ValueError, match="no gaussian"):
        tt.gauss_template_from_file(tmp_path / "empty")
