"""The port's ephemeris-building modules against the JAX package's, on
the host (both run numpy and scipy): ``io/spk_write.py``, ``ephemeris/nbody.py``,
``ephemeris/numeph.py``, ``data/generate_tdb_ext.py`` and
``data/examples/generate_ngc6440e.py``.

Tiers: the SPK writer's bytes, the N-body accelerations, conserved
quantities and batched integration, and a short-span ``numeph.build``'s
kernel and sidecar are identical to the JAX package's; the kernel's
positions through each package's ``_kernel_posvel`` are bitwise alike;
``generate_tdb_ext`` prints the same literals; ``generate_ngc6440e``
writes the JAX generator's bytes, 1.2e-9 s from the committed tim file
in both packages (ROADMAP §3).
"""

import contextlib
import importlib
import io
import os
import shutil

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAN = (51817.0, 52183.0)  # one year around numeph's CENTER_MJD
FIT = dict(n_epochs=30, iters=1, rtol_jac=1e-9, rtol_res=1e-10)


def _mods(name):
    return (importlib.import_module("pint_tpu." + name),
            importlib.import_module("pint_tpu_torch." + name))


def test_spk_write_bytes_match_jax(tmp_path):
    """write_spk_type2 of the same segments (two centres, unequal
    record counts and degrees) writes the same file in both packages,
    and the port's SPKKernel reads it back."""
    from pint_tpu_torch.io.spk import SPKKernel

    jw, tw = _mods("io.spk_write")
    rng = np.random.default_rng(18)
    segs = [{"target": 3, "center": 0, "init_et": -4.0e6, "intlen_s": 1.6e6,
             "coeffs": rng.normal(size=(5, 3, 9))},
            {"target": 301, "center": 3, "init_et": -4.0e6,
             "intlen_s": 4.0e5, "coeffs": rng.normal(size=(20, 3, 13))}]
    jw.write_spk_type2(str(tmp_path / "j.bsp"), segs)
    tw.write_spk_type2(str(tmp_path / "t.bsp"), segs)
    assert (tmp_path / "j.bsp").read_bytes() == (tmp_path / "t.bsp").read_bytes()
    kern = SPKKernel(str(tmp_path / "t.bsp"))
    assert kern.segment_for(301, 3) is not None


def test_nbody_bitwise_jax():
    """accel (batched and not), energy_momentum and integrate_batch
    (both directions from the centre) are bitwise the JAX package's."""
    jn, tn = _mods("ephemeris.nbody")
    assert np.array_equal(jn.GM, tn.GM)
    _, tnum = _mods("ephemeris.numeph")
    pos0, vel0 = tnum.initial_state()
    rng = np.random.default_rng(5)
    pb = pos0[None] + rng.normal(scale=1e3, size=(3,) + pos0.shape)
    vb = vel0[None] + rng.normal(scale=1e-3, size=(3,) + vel0.shape)
    assert np.array_equal(jn.accel(pos0, vel0), tn.accel(pos0, vel0))
    assert np.array_equal(jn.accel(pb, vb), tn.accel(pb, vb))
    for a, b in zip(jn.energy_momentum(pos0, vel0),
                    tn.energy_momentum(pos0, vel0)):
        assert np.array_equal(a, b)
    t_eval = np.array([-20.0, -3.0, 0.0, 7.0, 30.0]) * 86400.0
    assert np.array_equal(jn.integrate_batch(pb, vb, 0.0, t_eval, rtol=1e-9),
                          tn.integrate_batch(pb, vb, 0.0, t_eval, rtol=1e-9))


def test_numeph_build_matches_jax(tmp_path):
    """A one-year build() (no injection, a small fit) in both packages
    into two directories: identical .bsp bytes and JSON sidecars; the
    port's SPKKernel serves the kernel through its _kernel_posvel chain
    bitwise as the JAX package's does."""
    from pint_tpu.ephemeris import _kernel_posvel as jax_posvel
    from pint_tpu.io.spk import SPKKernel as JaxKernel
    from pint_tpu.mjd import Epochs as JaxEpochs
    from pint_tpu_torch.ephemeris import _CHAIN_TO_SSB, _kernel_posvel
    from pint_tpu_torch.io.spk import SPKKernel
    from pint_tpu_torch.mjd import Epochs

    jnum, tnum = _mods("ephemeris.numeph")
    out = {}
    for tag, mod in (("jax", jnum), ("torch", tnum)):
        d = tmp_path / tag
        d.mkdir()
        out[tag] = mod.build(out_dir=str(d), span=SPAN, with_injection=False,
                             fit_kwargs=FIT)
    assert ((tmp_path / "jax" / "numeph_v1.bsp").read_bytes()
            == (tmp_path / "torch" / "numeph_v1.bsp").read_bytes())
    assert ((tmp_path / "jax" / "numeph_v1.json").read_bytes()
            == (tmp_path / "torch" / "numeph_v1.json").read_bytes())
    assert out["jax"]["fit"] == out["torch"]["fit"]
    mjd = np.linspace(SPAN[0] + 2, SPAN[1] - 2, 37)
    day = np.floor(mjd).astype(np.int64)
    sec = (mjd - day) * 86400.0
    path = str(tmp_path / "torch" / "numeph_v1.bsp")
    tk, jk = SPKKernel(path), JaxKernel(path)
    for body in _CHAIN_TO_SSB:
        a = _kernel_posvel(tk, body, Epochs(day, sec, "tdb"))
        b = jax_posvel(jk, body, JaxEpochs(day, sec, "tdb"))
        assert np.array_equal(a.pos, np.asarray(b.pos)), body
        assert np.array_equal(a.vel, np.asarray(b.vel)), body


def test_generate_tdb_ext_prints_jax_literals():
    """main(max_terms=3) of both generators prints the same text."""
    texts = []
    for pkg in ("pint_tpu", "pint_tpu_torch"):
        mod = importlib.import_module(pkg + ".data.generate_tdb_ext")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main(max_terms=3)
        texts.append(buf.getvalue())
    assert texts[0] == texts[1]
    assert "_TDB_POLY = (" in texts[1] and "_TDB_T_TERMS_EXT" in texts[1]


def _tim_epochs(path):
    """(day, 1e-16-day units) of each TOA line of a tim file."""
    out = []
    for line in open(path):
        f = line.split()
        if len(f) > 3 and not line.startswith(("C ", "FORMAT")):
            day, frac = f[2].split(".")
            out.append((int(day), int(frac)))
    return out


def _gap_s(a, b):
    return max(abs((x[0] - y[0]) * 86400.0 + (x[1] - y[1]) * 86400e-16)
               for x, y in zip(a, b))


def test_generate_ngc6440e_matches_committed_tim(tmp_path, monkeypatch):
    """The port's generator (on the CPU) and the JAX package's, each run
    into a copy of the example directory: the same bytes, the committed
    file untouched. Against the committed file both move the epochs
    alike, by 1.2e-9 s: it predates the current chain, so its 1e-12 s
    tier is out of reach for both packages (ROADMAP §3); held to 2e-9
    s."""
    import importlib.util

    src = os.path.join(REPO, "pint_tpu_torch", "data", "examples")
    before = open(os.path.join(src, "NGC6440E.tim")).read()
    outs = {}
    for pkg in ("pint_tpu", "pint_tpu_torch"):
        d = tmp_path / pkg
        d.mkdir()
        for name in ("NGC6440E.par", "NGC6440E.tim"):
            shutil.copy(os.path.join(src, name), d / name)
        spec = importlib.util.spec_from_file_location(
            "generate_ngc6440e_" + pkg,
            os.path.join(REPO, pkg, "data", "examples", "generate_ngc6440e.py"))
        gen = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(gen)
        monkeypatch.setattr(gen, "HERE", str(d))
        gen.main(device="cpu") if pkg == "pint_tpu_torch" else gen.main()
        outs[pkg] = (d / "NGC6440E.tim").read_bytes()
    assert open(os.path.join(src, "NGC6440E.tim")).read() == before
    assert outs["pint_tpu"] == outs["pint_tpu_torch"]
    old = _tim_epochs(os.path.join(src, "NGC6440E.tim"))
    new = _tim_epochs(tmp_path / "pint_tpu_torch" / "NGC6440E.tim")
    assert len(new) == len(old) == 62
    assert _gap_s(new, old) <= 2e-9
    head = [ln for ln in before.splitlines() if ln.startswith(("C ", "FORMAT"))]
    assert outs["pint_tpu_torch"].decode().splitlines()[:len(head)] == head


@pytest.mark.parametrize("pkg", ["pint_tpu_torch"])
def test_ephemeris_modules_import_no_jax(pkg):
    """The ephemeris-building modules import nothing of JAX or the JAX
    package."""
    import ast

    for rel in ("io/spk_write.py", "ephemeris/nbody.py",
                "ephemeris/numeph.py", "data/generate_tdb_ext.py",
                "data/examples/generate_ngc6440e.py"):
        tree = ast.parse(open(os.path.join(REPO, pkg, rel)).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] not in ("jax", "pint_tpu"), (rel, n)
