"""The port's command-line tools (pint_tpu_torch/scripts) against the
JAX package's, in-process on the CPU (``--device cpu`` where a script
evaluates a model): each ``main()``'s exit code, output and written
files. Also: the wideband pack and ``WB_postfit.json`` rebuilt through
the JAX package equal the committed files, the new modules import
neither JAX nor the JAX package in a fresh interpreter, and the scripts
that evaluate a model refuse to run on the CPU unasked.

Tolerances: the host-only tools (compare_parfiles, pintpublish,
t2binary2pint's conversion) and pintbary print the same text; zima's
tim files carry bitwise the same flags (-pp_dm included) and epochs
within 1e-12 s (each package's zero-residual iteration,
tests/test_torch_ingest.py) plus one written digit (8.64e-12 s); pintempo's fits meet
tests/test_torch_fitter.py's and tests/test_torch_wideband.py's tiers
(values 1e-6 sigma, chi2 1e-7 on the wideband pack), its post-fit par
file's uncertainties as printed (5 digits: 1e-4 relative); written par
files are compared as each package's get_model reads them back
(tests/test_torch_utils.py's rules).
"""

import contextlib
import io
import json
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

from test_torch_wideband import (WB_PAR, WB_POSTFIT, WB_TIM, make_pack,
                                 postfit_fixture)

ROOT = Path(__file__).resolve().parent.parent
NGC_PAR = ROOT / "pint_tpu" / "data" / "examples" / "NGC6440E.par"
NGC_TIM = ROOT / "pint_tpu" / "data" / "examples" / "NGC6440E.tim"
PORT_NGC_PAR = ROOT / "pint_tpu_torch" / "data" / "examples" / "NGC6440E.par"
PORT_NGC_TIM = ROOT / "pint_tpu_torch" / "data" / "examples" / "NGC6440E.tim"
T2_PAR = """PSR J1012+5307
RAJ 10:12:33.43
DECJ 53:07:02.5
F0 190.2678376 1
F1 -6.2e-16
PEPOCH 55000
DM 9.02
BINARY T2
PB 0.60467 1
A1 0.58181 1
TASC 50700.08 1
EPS1 1.3e-7 1
EPS2 -4.0e-7 1
H3 2.1e-7 1
STIG 0.4
"""
TCB_PAR = ("PSR J1744-1134\nRAJ 17:44:29.4\nDECJ -11:34:54.7\n"
           "F0 245.4261196 1\nF1 -5.38e-16 1\nPEPOCH 55000\n"
           "POSEPOCH 55000\nDM 3.139 1\nUNITS TCB\n")


def _run(main, argv):
    """(exit code, stdout, stderr) of one in-process run."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _scripts(name):
    import importlib

    return (importlib.import_module(f"pint_tpu.scripts.{name}"),
            importlib.import_module(f"pint_tpu_torch.scripts.{name}"))


def _same_numbers(a, b, rtol):
    """Two texts with the same words, numbers within ``rtol``."""
    la, lb = a.splitlines(), b.splitlines()
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        wa, wb = x.split(), y.split()
        assert len(wa) == len(wb), (x, y)
        for u, v in zip(wa, wb):
            try:
                fu, fv = float(u), float(v)
            except ValueError:
                assert u == v, (x, y)
            else:
                assert abs(fu - fv) <= rtol * max(abs(fu), 1e-300), (x, y)


def _models(path_or_text):
    from pint_tpu.models import get_model as jget
    from pint_tpu_torch.models import get_model

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return jget(str(path_or_text)), get_model(str(path_or_text))


def test_pintempo_matches_jax(tmp_path):
    """pintempo on NGC6440E with each narrowband fitter: the same
    printed lines (numbers to the 1e-6 relative the summary's printed
    digits carry at the fitters' tiers) and post-fit par files that read
    back alike (values 1e-6 sigma, an angle to its written tick,
    uncertainties to their 5 printed digits)."""
    jscript, tscript = _scripts("pintempo")
    for fitter in ("wls", "downhill_wls", "gls"):
        rj, oj, _ = _run(jscript.main, [str(NGC_PAR), str(NGC_TIM),
                                        "--fitter", fitter, "--maxiter", "2",
                                        "--outfile", str(tmp_path / "j.par")])
        rt, ot, _ = _run(tscript.main, [str(PORT_NGC_PAR), str(PORT_NGC_TIM),
                                        "--fitter", fitter, "--maxiter", "2",
                                        "--outfile", str(tmp_path / "t.par"),
                                        "--device", "cpu"])
        assert rj == rt == 0
        _same_numbers(oj.replace(str(NGC_TIM), "TIM").replace(
            str(tmp_path / "j.par"), "OUT"), ot.replace(
            str(PORT_NGC_TIM), "TIM").replace(str(tmp_path / "t.par"), "OUT"),
            1e-6)
        jm, _ = _models(tmp_path / "j.par")
        _, tm = _models(tmp_path / "t.par")
        for p in jm.free_params:
            a, b = getattr(jm, p), getattr(tm, p)
            # an angle is written to 1e-10 sexagesimal seconds: one tick
            tick = (1e-10 / 3600 * np.pi / 180 * (
                15.0 if a.angle_unit == "hourangle" else 1.0)
                if a.kind == "angle" else 0.0)
            unc = a.uncertainty
            if a.kind == "angle":
                # the JAX package writes an angle's uncertainty in
                # radians, which its reader takes as seconds (ROADMAP §3;
                # the port writes seconds): undo that scale
                unc = unc / (np.pi / 180 / 3600 * (
                    15.0 if a.angle_unit == "hourangle" else 1.0))
            assert abs(a.value - b.value) <= 1e-6 * unc + tick, p
            assert b.uncertainty == pytest.approx(unc, rel=1e-4), p
    plot = tmp_path / "resid.png"
    rt, ot, _ = _run(tscript.main, [str(PORT_NGC_PAR), str(PORT_NGC_TIM),
                                    "--fitter", "wls", "--maxiter", "1",
                                    "--plot", "--plotfile", str(plot),
                                    "--device", "cpu"])
    assert rt == 0 and f"Wrote {plot}" in ot
    assert plot.stat().st_size > 1000


def test_pintempo_auto_on_the_wideband_pack(tmp_path):
    """pintempo --fitter auto on the wideband pack fits through
    WidebandDownhillFitter and writes a par file whose values, 5-digit
    uncertainties and CHI2 match the JAX package's run in
    WB_postfit.json (values 1e-6 sigma, uncertainties 1e-4, CHI2
    1e-7)."""
    _, tscript = _scripts("pintempo")
    post = tmp_path / "post.par"
    rc, out, _ = _run(tscript.main, [str(WB_PAR), str(WB_TIM), "--fitter",
                                     "auto", "--outfile", str(post),
                                     "--device", "cpu"])
    assert rc == 0
    assert "Fitting with WidebandDownhillFitter" in out
    assert "Fitted model using WidebandDownhillFitter" in out
    fx = json.loads(WB_POSTFIT.read_text())["pintempo_auto"]
    _, pm = _models(post)
    assert pm.free_params == list(fx["values"])
    for p, v in fx["values"].items():
        assert abs(getattr(pm, p).value - v) <= 1e-6 * fx["uncertainties"][p]
        assert getattr(pm, p).uncertainty == pytest.approx(
            fx["uncertainties"][p], rel=1e-4)
    assert pm.CHI2.value == pytest.approx(fx["chi2"], rel=1e-7)


def _tim_rows(path):
    from pint_tpu_torch.toa import read_tim_file

    toas, _ = read_tim_file(str(path))
    return toas


@pytest.mark.parametrize("args", [
    ["--inputtim", str(WB_TIM), "--wideband", "--addnoise", "--seed", "3"],
    ["--ntoa", "40", "--startMJD", "55100", "--duration", "900", "--wideband",
     "--dmerror", "3e-4", "--addnoise", "--addcorrnoise", "--seed", "4",
     "--fuzzdays", "2.0", "--freq", "820"],
], ids=["inputtim", "uniform"])
def test_zima_matches_jax(tmp_path, args):
    """zima with --wideband: the same rows (flags bitwise, -pp_dm and
    -pp_dme included; epochs within 1e-12 s plus one written digit,
    16 decimals of a day = 8.64e-12 s) as the JAX package's zima for
    the same seed."""
    jscript, tscript = _scripts("zima")
    rj, oj, _ = _run(jscript.main, [str(WB_PAR), str(tmp_path / "j.tim"),
                                    *args])
    rt, ot, _ = _run(tscript.main, [str(WB_PAR), str(tmp_path / "t.tim"),
                                    *args, "--device", "cpu"])
    assert rj == rt == 0
    assert ot.replace("t.tim", "j.tim") == oj
    a, b = _tim_rows(tmp_path / "j.tim"), _tim_rows(tmp_path / "t.tim")
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.flags == y.flags and "pp_dm" in y.flags
        assert x.freq_mhz == y.freq_mhz and x.obs == y.obs
        # 1e-12 s apart before writing, then 16 decimals of a day each
        assert abs((x.day - y.day) * 86400.0 + (x.sec - y.sec)) <= \
            1e-12 + 8.64e-12


def _read_back(ref, back, mjd_tol_s):
    from test_torch_utils import _read_back_equal

    _read_back_equal(ref, back, mjd_tol_s)


def test_convert_parfile_matches_jax(tmp_path):
    """convert_parfile in each format, to a file and to stdout: the same
    keys in the same order as the JAX package's, and each package's
    get_model reads the other's file back to the input's values."""
    jscript, tscript = _scripts("convert_parfile")
    jm, tm = _models(WB_PAR)
    for fmt in ("pint", "tempo", "tempo2"):
        jo, to = tmp_path / f"j_{fmt}.par", tmp_path / f"t_{fmt}.par"
        rj, _, ej = _run(jscript.main, [str(WB_PAR), "-f", fmt, "-o", str(jo)])
        rt, _, et = _run(tscript.main, [str(WB_PAR), "-f", fmt, "-o", str(to)])
        assert rj == rt == 0 and et.replace(str(to), str(jo)) == ej
        keys = [[ln.split()[0] for ln in p.read_text().splitlines()]
                for p in (jo, to)]
        assert keys[0] == keys[1]
        if fmt == "tempo2":
            assert "T2EFAC" in keys[1] and "EFAC" not in keys[1]
        _read_back(tm, _models(jo)[1], 4.32e-7)
        _read_back(jm, _models(to)[0], 4e-12)
    rt, out, _ = _run(tscript.main, [str(WB_PAR), "-f", "tempo"])
    assert rt == 0 and out.splitlines()[0].split() == ["MODE", "1"]
    assert out == tm.as_parfile(format="tempo")


def test_compare_parfiles_and_pintpublish_match_jax(tmp_path):
    """compare_parfiles (with and without --sigma) and pintpublish (to
    stdout and to a file) print the JAX package's text."""
    fx = json.loads(WB_POSTFIT.read_text())["fitters"]["WidebandTOAFitter"]
    _, tm = _models(WB_PAR)
    for p, v in fx["values"].items():
        getattr(tm, p).value = v
        getattr(tm, p).uncertainty = fx["uncertainties"][p]
    post = tmp_path / "post.par"
    tm.write_parfile(post)
    jscript, tscript = _scripts("compare_parfiles")
    for extra in ([], ["--sigma", "1"]):
        rj, oj, _ = _run(jscript.main, [str(WB_PAR), str(post), *extra])
        rt, ot, _ = _run(tscript.main, [str(WB_PAR), str(post), *extra])
        assert rj == rt == 0 and ot == oj and len(ot.splitlines()) > 3
    jscript, tscript = _scripts("pintpublish")
    rj, oj, _ = _run(jscript.main, [str(post)])
    rt, ot, _ = _run(tscript.main, [str(post)])
    assert rj == rt == 0 and ot == oj and "DMJUMP1" in ot
    rt, ot, _ = _run(tscript.main, [str(post), "--outfile",
                                    str(tmp_path / "t.tex")])
    assert rt == 0 and (tmp_path / "t.tex").read_text() == oj[:-1]


def test_tcb2tdb_and_t2binary2pint_match_jax(tmp_path):
    """tcb2tdb converts a TCB par file (and refuses a TDB one) and
    t2binary2pint picks ELL1H for a BINARY T2 file with H3, as the JAX
    package's scripts do: the same converted text before it is built,
    and written par files that read back alike."""
    src = tmp_path / "tcb.par"
    src.write_text(TCB_PAR)
    jscript, tscript = _scripts("tcb2tdb")
    rj, oj, _ = _run(jscript.main, [str(src), str(tmp_path / "j.par")])
    rt, ot, _ = _run(tscript.main, [str(src), str(tmp_path / "t.par")])
    assert rj == rt == 0 and ot.replace("t.par", "j.par") == oj
    jm, _ = _models(tmp_path / "j.par")
    _, tm = _models(tmp_path / "t.par")
    assert tm.UNITS.value == jm.UNITS.value == "TDB"
    _read_back(jm, _models(tmp_path / "t.par")[0], 4.32e-7)
    assert tm.F0.value == jm.F0.value != 245.4261196
    rt, _, et = _run(tscript.main, [str(tmp_path / "t.par"),
                                    str(tmp_path / "x.par")])
    assert rt == 1 and "refusing to convert" in et
    src = tmp_path / "t2.par"
    src.write_text(T2_PAR)
    jscript, tscript = _scripts("t2binary2pint")
    assert tscript.convert_t2_par(T2_PAR) == jscript.convert_t2_par(T2_PAR)
    assert tscript.convert_t2_par(T2_PAR)[1] == "ELL1H"
    rj, oj, _ = _run(jscript.main, [str(src), str(tmp_path / "j2.par")])
    rt, ot, _ = _run(tscript.main, [str(src), str(tmp_path / "t2o.par")])
    assert rj == rt == 0 and ot.replace("t2o.par", "j2.par") == oj
    jm, _ = _models(tmp_path / "j2.par")
    _, tm = _models(tmp_path / "t2o.par")
    assert "BinaryELL1H" in tm.components
    _read_back(tm, _models(tmp_path / "t2o.par")[0], 4e-12)
    with pytest.raises(ValueError, match="no BINARY line"):
        tscript.convert_t2_par("PSR X\nF0 1.0\n")


@pytest.mark.parametrize("args", [
    ["56000.0", "56000.5", "58000.25", "--ra", "10:00:00", "--dec",
     "15:00:00", "--obs", "gbt", "--freq", "1400", "--dm", "20.0"],
    ["55000.123456789", "--parfile", str(WB_PAR), "--obs", "geocenter"],
], ids=["ra_dec_gbt", "parfile_geocenter"])
def test_pintbary_matches_jax(args):
    jscript, tscript = _scripts("pintbary")
    rj, oj, _ = _run(jscript.main, args)
    rt, ot, _ = _run(tscript.main, [*args, "--device", "cpu"])
    assert rj == rt == 0 and ot == oj and len(ot.splitlines()) >= 1


@pytest.mark.parametrize("name,argv", [
    ("pintempo", [str(WB_PAR), str(WB_TIM)]),
    ("zima", [str(WB_PAR), "out.tim"]),
    ("pintbary", ["56000.0", "--ra", "1:00:00", "--dec", "2:00:00"]),
])
def test_scripts_need_a_card_unless_asked(monkeypatch, name, argv):
    """With no card, a script that evaluates a model raises at its
    default --device cuda instead of running on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tscript = _scripts(name)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tscript.main(argv)


def test_new_modules_import_neither_jax_nor_the_jax_package():
    """In a fresh interpreter: the scripts, config, logging_setup, the
    wideband fitters, residuals and simulation, the fleet executor
    (graphs, parallel, resilience), and the satellite observatories,
    polycos, modelutils, fftfit and the inference modules load without
    JAX or the JAX package."""
    mods = ["pint_tpu_torch.scripts." + s for s in (
        "pintempo", "zima", "convert_parfile", "compare_parfiles",
        "tcb2tdb", "t2binary2pint", "pintbary", "pintpublish")]
    mods += ["pint_tpu_torch.config", "pint_tpu_torch.logging_setup",
             "pint_tpu_torch.fitter", "pint_tpu_torch.residuals",
             "pint_tpu_torch.simulation", "pint_tpu_torch.utils",
             "pint_tpu_torch.graphs", "pint_tpu_torch.parallel",
             "pint_tpu_torch.resilience"]
    # the photon-timing remainder and inference
    mods += ["pint_tpu_torch." + m for m in (
        "observatory.satellite_obs", "modelutils", "polycos", "profile",
        "profile.fftfit", "priors", "bayesian", "sampler", "mcmc_fitter",
        "gridutils", "dd", "scripts.photonphase", "scripts._event_common",
        "scripts.event_optimize", "scripts.event_optimize_multiple")]
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "import pint_tpu_torch.utils as u\nu.list_parameters()\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'pint_tpu')]\n"
            "assert not bad, bad\nprint('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_wb_postfit_fixture_regenerates(tmp_path):
    """The committed wideband pack and WB_postfit.json are what the JAX
    package makes now: the same par and tim text, the same prefit
    residuals (bitwise), and the same fits (chi2, values, uncertainties
    to 1e-12 relative: the numpy host path on one CPU)."""
    par, tim = make_pack(tmp_path)
    assert par.read_text() == WB_PAR.read_text()
    assert tim.read_text() == WB_TIM.read_text()
    fresh = postfit_fixture(par, tim)
    committed = json.loads(WB_POSTFIT.read_text())
    assert fresh["source"] == committed["source"]
    assert fresh["prefit"] == committed["prefit"]
    assert fresh["fitters"].keys() == committed["fitters"].keys()
    for key, rec in committed["fitters"].items():
        new = fresh["fitters"][key]
        assert new["class"] == rec["class"] and new["kwargs"] == rec["kwargs"]
        assert new["chi2"] == pytest.approx(rec["chi2"], rel=1e-12)
        assert new["values"] == pytest.approx(rec["values"], rel=1e-12)
        assert new["uncertainties"] == pytest.approx(rec["uncertainties"],
                                                     rel=1e-9)
    new, rec = fresh["pintempo_auto"], committed["pintempo_auto"]
    assert new["rc"] == rec["rc"] == 0
    assert new["chi2"] == pytest.approx(rec["chi2"], rel=1e-12)
    assert new["values"] == pytest.approx(rec["values"], rel=1e-12)
    assert new["uncertainties"] == pytest.approx(rec["uncertainties"],
                                                 rel=1e-12)
