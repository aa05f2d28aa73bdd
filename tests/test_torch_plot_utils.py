"""The port's ``plot_utils`` (phaseogram, phaseogram_binned,
plot_residuals), ``Fitter.plot`` and ``pintempo --plot`` against the JAX
package's, on the CPU under matplotlib's Agg backend.

The artists' data are compared: the summed profile (step line) and the
scatter offsets and colours of ``phaseogram``, the image array of
``phaseogram_binned`` bitwise (the same numpy histograms of the same
inputs; the port's inputs arrive as tensors), and the error-bar data of
``plot_residuals`` for each package's WLS fit of the same TOAs, within
1e-6 us (the fitted residuals' 1e-12 s tier).
"""

import warnings

import numpy as np
import pytest
import torch

warnings.simplefilter("ignore")

PAR = ("PSR TPLOT\nRAJ 6:00:00\nDECJ 10:00:00\nF0 200.0 1\n"
       "PEPOCH 55000\nDM 10.0\n")
TOL_RESID_US = 1e-6


@pytest.fixture(scope="module")
def photons():
    rng = np.random.default_rng(0)
    mjds = rng.uniform(55000, 55010, 500)
    ph = rng.vonmises(np.pi, 3.0, 500) / (2 * np.pi) % 1.0
    w = rng.uniform(0, 1, 500)
    return mjds, ph, w


def _close(*figs):
    import matplotlib.pyplot as plt

    for f in figs:
        plt.close(f)


@pytest.mark.parametrize("weighted", [False, True])
def test_phaseogram_artists_match_jax(photons, weighted):
    from pint_tpu.plot_utils import phaseogram as jphaseogram
    from pint_tpu_torch.plot_utils import phaseogram

    mjds, ph, w = photons
    w = w if weighted else None
    fig = phaseogram(torch.as_tensor(mjds), torch.as_tensor(ph),
                     weights=None if w is None else torch.as_tensor(w),
                     rotate=0.25, title="t")
    jfig = jphaseogram(mjds, ph, weights=w, rotate=0.25, title="t")
    for ax, jax_ in zip(fig.axes, jfig.axes):
        assert [ln.get_xydata().tolist() for ln in ax.lines] \
            == [ln.get_xydata().tolist() for ln in jax_.lines]
        assert len(ax.collections) == len(jax_.collections)
        for c, jc in zip(ax.collections, jax_.collections):
            assert np.array_equal(c.get_offsets(), jc.get_offsets())
            assert np.array_equal(c.get_facecolors(), jc.get_facecolors())
        assert ax.get_title() == jax_.get_title()
    _close(fig, jfig)


def test_phaseogram_binned_image_matches_jax(photons, tmp_path):
    from pint_tpu.plot_utils import phaseogram_binned as jbinned
    from pint_tpu_torch.plot_utils import phaseogram, phaseogram_binned

    mjds, ph, w = photons
    fig = phaseogram_binned(torch.as_tensor(mjds), torch.as_tensor(ph),
                            weights=torch.as_tensor(w), ntimebins=16)
    jfig = jbinned(mjds, ph, weights=w, ntimebins=16)
    im, jim = fig.axes[0].images[0], jfig.axes[0].images[0]
    assert np.array_equal(im.get_array(), jim.get_array())
    assert im.get_extent() == jim.get_extent()
    _close(fig, jfig)
    for fn, name in ((phaseogram, "pg.png"), (phaseogram_binned, "pgb.png")):
        out = tmp_path / name
        assert fn(mjds, ph, plotfile=str(out)) == str(out)
        assert out.stat().st_size > 1000


@pytest.fixture(scope="module")
def fits():
    """(JAX WLSFitter, port WLSFitter) fitted on the same 25 TOAs."""
    from pint_tpu.fitter import WLSFitter as JWLS
    from pint_tpu.models import get_model as jget
    from pint_tpu.simulation import make_fake_toas_fromMJDs
    from pint_tpu_torch.fitter import WLSFitter
    from pint_tpu_torch.models import get_model
    from test_torch_pta import port_toas

    jt = make_fake_toas_fromMJDs(np.linspace(54900, 55100, 25), jget(PAR),
                                 error_us=1.0, freq_mhz=1400.0, obs="gbt",
                                 add_noise=True, seed=2)
    jf = JWLS(jt, jget(PAR))
    jf.fit_toas()
    f = WLSFitter(port_toas(jt), get_model(PAR), device="cpu")
    f.fit_toas()
    return jf, f


def test_plot_residuals_and_fitter_plot_match_jax(fits, tmp_path):
    from pint_tpu.plot_utils import plot_residuals as jplot
    from pint_tpu_torch.plot_utils import plot_residuals

    jf, f = fits
    fig, jfig = plot_residuals(f, title="r"), jplot(jf, title="r")
    (line,), (jline,) = fig.axes[0].lines[:1], jfig.axes[0].lines[:1]
    np.testing.assert_allclose(line.get_xydata(), jline.get_xydata(),
                               rtol=0, atol=TOL_RESID_US)
    segs = fig.axes[0].collections[0].get_segments()
    jsegs = jfig.axes[0].collections[0].get_segments()
    np.testing.assert_allclose(np.array(segs), np.array(jsegs), rtol=0,
                               atol=TOL_RESID_US)
    _close(fig, jfig)
    out = tmp_path / "resid.png"
    assert f.plot(plotfile=str(out)) == str(out)
    assert out.stat().st_size > 1000


def test_pintempo_plot_writes_its_file(fits, tmp_path, capsys):
    from pint_tpu_torch.scripts import pintempo

    jf, _ = fits
    par, tim = tmp_path / "p.par", tmp_path / "p.tim"
    par.write_text(PAR)
    jf.toas.write_TOA_file(str(tim))
    out = tmp_path / "pintempo.png"
    assert pintempo.main([str(par), str(tim), "--fitter", "wls",
                          "--maxiter", "1", "--plot", "--plotfile",
                          str(out), "--device", "cpu"]) == 0
    assert f"Wrote {out}" in capsys.readouterr().out
    assert out.stat().st_size > 1000
