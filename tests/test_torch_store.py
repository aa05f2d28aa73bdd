"""The port's packed-TOA store (pint_tpu_torch/store/packstore.py) and
``PTAFleet(store=)`` against the JAX package's, on the CPU.

The contract (the JAX package's tests/test_store.py): a store entry can
cost TIME, never CORRECTNESS. Every failure mode — bitrot, truncation,
a stale identity, a mismatched content signature — warns, deletes the
entry and rebuilds from live prep; a SIGKILL at the ``store_write``
fault point leaves no torn artifact. Within the port a store-built
fleet fits bitwise as the live-built one (a packed plan bucket
included); across packages the store-built fleet's fit holds the JAX
package's fleet fit at 1e-6 sigma (ERRORBUDGET's batched-fit tier).
The file format (magic, header, alignment) is the JAX package's, but
the identities differ (torch and CUDA versions against the jax
version), so each package refuses the other's entries as stale.
"""

import copy
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

from test_torch_pta import port_toas

warnings.simplefilter("ignore")

TOL_SIGMA = 1e-6
NOISE = "RNAMP 1e-14\nRNIDX -3.1\nTNREDC 4\n"


def _fleet_inputs(n_psr=3, base_toas=30, extra=""):
    """(par texts, JAX models, JAX TOAs, port models, port TOAs): the
    JAX package's test fleet, its TOAs also in the port's form."""
    from pint_tpu.models import get_model as jax_model
    from pint_tpu.simulation import make_fake_toas_fromMJDs
    from pint_tpu_torch.models import get_model

    rng = np.random.default_rng(0)
    pars, jms, jts = [], [], []
    for i in range(n_psr):
        par = (f"PSR ST{i}\nRAJ 1{i % 10}:00:00.0\n"
               f"DECJ {5 + i}:30:00.0\nF0 {200 + 10 * i}.5 1\n"
               f"F1 -{3 + i}e-16 1\nPEPOCH 55500\nDM {10 + i}.5 1\n"
               + extra)
        m = jax_model(par)
        n = base_toas + 5 * i
        mjds = np.sort(rng.uniform(55000, 56000, n))
        freqs = np.where(np.arange(n) % 2, 1400.0, 800.0)
        jts.append(make_fake_toas_fromMJDs(mjds, m, error_us=1.0,
                                           freq_mhz=freqs, obs="gbt",
                                           add_noise=True, seed=i))
        pars.append(par)
        jms.append(m)
    return (pars, jms, jts, [get_model(p) for p in pars],
            [port_toas(t) for t in jts])


@pytest.fixture(scope="module")
def fleet_inputs():
    return _fleet_inputs()


def _fit(models, toas_list, store=None, **kw):
    from pint_tpu_torch.parallel import PTAFleet

    fleet = PTAFleet([copy.deepcopy(m) for m in models], toas_list,
                     store=store, device="cpu", **kw.pop("fleet", {}))
    x, chi2, cov = fleet.fit(**({"method": "wls", "maxiter": 2} | kw))
    return np.asarray(x), np.asarray(chi2), np.asarray(cov)


def _synthetic_state():
    # pack_state-shaped tree: dict/list/tuple nodes, numeric numpy
    # leaves, and non-array scalars/strings in the meta region
    return {
        "params": np.linspace(0.0, 1.0, 7),
        "batch": {"day": np.arange(10, dtype=np.int64),
                  "freq": np.full((2, 5), 1400.0, np.float32)},
        "free_map": [("F0", 0), ("DM", 2)],
        "n_toas": np.array([10, 10]),
        "static": {"ephem": "de440", "planets": True},
        "ld": np.array([1.25, 2.5], np.longdouble),
    }


def test_format_is_the_jax_packages():
    from pint_tpu.store import packstore as jps
    from pint_tpu_torch.store import packstore as ps

    assert ps.STORE_MAGIC == jps.STORE_MAGIC == b"PTPK"
    assert ps._STORE_HEADER.format == jps._STORE_HEADER.format
    assert ps._ALIGN == jps._ALIGN
    assert ps.STORE_FORMAT_VERSION == jps.STORE_FORMAT_VERSION
    assert ps._COL_KEY == jps._COL_KEY


def test_synthetic_roundtrip_and_mmap_views(tmp_path):
    from pint_tpu_torch.store import PackStore

    store = PackStore(tmp_path)
    state = _synthetic_state()
    sig = "pack-" + "a" * 40
    nbytes = store.put(sig, (0, 256), state)
    out = store.load(sig, (0, 256))
    np.testing.assert_array_equal(out["params"], state["params"])
    np.testing.assert_array_equal(out["batch"]["day"],
                                  state["batch"]["day"])
    np.testing.assert_array_equal(out["ld"], state["ld"])
    assert out["ld"].dtype == np.longdouble
    assert out["batch"]["freq"].dtype == np.float32
    assert out["batch"]["freq"].shape == (2, 5)
    assert out["free_map"] == [("F0", 0), ("DM", 2)]
    assert isinstance(out["free_map"][0], tuple)
    assert out["static"] == {"ephem": "de440", "planets": True}
    # array leaves are read-only views over the pinned mmap
    assert not out["params"].flags.writeable
    c = store.counters()
    assert c["puts"] == 1 and c["hits"] == 1 and c["misses"] == 0
    assert c["bytes_written"] == nbytes and c["bytes_mapped"] > 0
    # every column starts 64-byte aligned in the file
    assert out["params"].ctypes.data % 64 == 0


def test_entries_of_the_other_package_are_stale(tmp_path):
    """Same framing, different identity: each package warns, deletes
    and rebuilds an entry the other wrote."""
    from pint_tpu.store import PackStore as JaxStore
    from pint_tpu_torch.store import PackStore

    sig = "pack-" + "b" * 40
    state = {"a": np.arange(8.0), "s": {"k": 1}}
    for writer, reader in ((JaxStore, PackStore), (PackStore, JaxStore)):
        d = tmp_path / writer.__module__.split(".")[0]
        writer(d).put(sig, (0, 256), state)
        r = reader(d)
        with pytest.warns(UserWarning, match="stale"):
            assert r.load(sig, (0, 256)) is None
        assert r.counters()["stale"] == 1
        assert os.listdir(d) == []


def test_identity_and_signature(fleet_inputs):
    from pint_tpu_torch.store import content_signature, store_identity

    _, _, _, models, toas_list = fleet_inputs
    sig = content_signature(models, toas_list, bucket_floor=256)
    assert content_signature([copy.deepcopy(m) for m in models],
                             toas_list, bucket_floor=256) == sig
    m2 = copy.deepcopy(models[0])
    m2.F0.value += 1e-6
    assert content_signature([m2] + models[1:], toas_list,
                             bucket_floor=256) != sig
    assert content_signature(models, toas_list[:1],
                             bucket_floor=256) != sig
    assert content_signature(models, toas_list,
                             bucket_floor=512) != sig
    assert sig.startswith("pack-")
    ident = store_identity()
    assert set(ident) == {"format", "torch_version", "cuda_version",
                          "capability", "pack_geometry"}


def test_cold_miss_counts_rebuild(tmp_path):
    from pint_tpu_torch.store import PackStore

    store = PackStore(tmp_path)
    assert store.load("pack-" + "b" * 40, (0, 256)) is None
    c = store.counters()
    assert c["misses"] == 1 and c["rebuilds"] == 1 and c["hits"] == 0


@pytest.fixture(scope="module")
def live_fit(fleet_inputs):
    _, _, _, models, toas_list = fleet_inputs
    return _fit(models, toas_list)


def test_fleet_store_hit_is_bitwise_and_matches_jax(tmp_path, fleet_inputs,
                                                    live_fit):
    from pint_tpu.parallel import PTAFleet as JaxFleet
    from pint_tpu_torch.store import PackStore

    _, jms, jts, models, toas_list = fleet_inputs
    cold = PackStore(tmp_path)
    x_cold = _fit(models, toas_list, store=cold)
    cc = cold.counters()
    assert cc["misses"] >= 1 and cc["puts"] >= 1 and cc["hits"] == 0
    warm = PackStore(tmp_path)  # fresh process-equivalent
    x_warm = _fit(models, toas_list, store=warm)
    wc = warm.counters()
    assert wc["hits"] == cc["puts"] and wc["misses"] == 0 \
        and wc["puts"] == 0
    for live, a, b in zip(live_fit, x_cold, x_warm):
        assert np.array_equal(a, live) and np.array_equal(b, live)
    jx, jchi2, jcov = JaxFleet([copy.deepcopy(m) for m in jms], jts) \
        .fit(method="wls", maxiter=2)
    for i in range(len(models)):
        sig = np.sqrt(np.diag(np.asarray(jcov[i])))
        assert np.max(np.abs(x_warm[0][i] - np.asarray(jx[i])) / sig) \
            < TOL_SIGMA


def test_packed_plan_bucket_store_hit_is_bitwise(tmp_path):
    """The main path's layout: red-noise pulsars packed several to a
    row by the shape planner, fitted GLS mixed (the kernels' plain
    versions on the CPU), pipelined build included."""
    from pint_tpu_torch.store import PackStore

    _, _, _, models, toas_list = _fleet_inputs(4, 40, extra=NOISE)
    plan = {"toa_bucket": "plan", "plan_quantum": 32,
            "plan_min_width": 128, "plan_max_pack": 4,
            "plan_compile_budget": 1}
    fit = {"method": "gls", "maxiter": 2, "precision": "mixed"}
    live = _fit(models, toas_list, fleet=dict(plan), **fit)
    _fit(models, toas_list, store=PackStore(tmp_path), fleet=dict(plan),
         **fit)
    warm = PackStore(tmp_path)
    hit = _fit(models, toas_list, store=warm,
               fleet=dict(plan, pipeline=True), **fit)
    assert warm.counters()["hits"] >= 1 and warm.counters()["puts"] == 0
    for a, b in zip(live, hit):
        assert np.array_equal(a, b)


def test_byte_flip_warns_deletes_rebuilds(tmp_path, fleet_inputs,
                                          live_fit):
    from pint_tpu_torch.store import PackStore

    _, _, _, models, toas_list = fleet_inputs
    cold = PackStore(tmp_path)
    _fit(models, toas_list, store=cold)
    names = sorted(k for k in os.listdir(tmp_path) if k.endswith(".ptpk"))
    path = os.path.join(tmp_path, names[0])
    # the file ends exactly at the final column's payload: its last
    # byte is real column data, so some CRC check must catch it
    size = os.path.getsize(path)
    with open(path, "r+b") as fh:
        fh.seek(size - 1)
        b = fh.read(1)
        fh.seek(size - 1)
        fh.write(bytes([b[0] ^ 0xFF]))
    hurt = PackStore(tmp_path)
    with pytest.warns(UserWarning, match="unusable"):
        x2 = _fit(models, toas_list, store=hurt)
    hc = hurt.counters()
    assert hc["corrupt"] == 1 and hc["rebuilds"] == 1 and hc["puts"] == 1
    for a, live in zip(x2, live_fit):
        assert np.array_equal(a, live)
    scan = hurt.scan()
    assert scan["valid"] == len(names) and scan["corrupt_or_stale"] == 0


def test_truncation_and_signature_mismatch(tmp_path):
    from pint_tpu_torch.store import PackStore

    store = PackStore(tmp_path)
    sig = "pack-" + "c" * 40
    store.put(sig, (0, 256), _synthetic_state())
    path = store._path(sig, (0, 256))
    os.truncate(path, os.path.getsize(path) // 2)
    with pytest.warns(UserWarning, match="unusable"):
        assert store.load(sig, (0, 256)) is None
    assert not os.path.exists(path)  # deleted, not left to re-fail
    # a file whose EMBEDDED signature disagrees with the requested one
    # is stale, not corrupt
    sig_b = "pack-" + "e" * 40
    store.put(sig, (0, 256), _synthetic_state())
    os.rename(store._path(sig, (0, 256)), store._path(sig_b, (0, 256)))
    with pytest.warns(UserWarning, match="stale"):
        assert store.load(sig_b, (0, 256)) is None
    c = store.counters()
    assert c["corrupt"] == 1 and c["stale"] == 1 and c["rebuilds"] == 2


def test_geometry_bump_invalidates_visibly(tmp_path, monkeypatch,
                                           fleet_inputs, live_fit):
    from pint_tpu_torch.parallel import shapeplan
    from pint_tpu_torch.store import PackStore

    _, _, _, models, toas_list = fleet_inputs
    _fit(models, toas_list, store=PackStore(tmp_path))
    n = len(os.listdir(tmp_path))
    monkeypatch.setattr(shapeplan, "PACK_GEOMETRY_VERSION",
                        shapeplan.PACK_GEOMETRY_VERSION + 1)
    bumped = PackStore(tmp_path)
    with pytest.warns(UserWarning, match="stale"):
        x2 = _fit(models, toas_list, store=bumped)
    bc = bumped.counters()
    assert bc["stale"] == n and bc["rebuilds"] == n and bc["puts"] == n
    for a, live in zip(x2, live_fit):
        assert np.array_equal(a, live)
    # rewritten under the new identity at the same paths: no orphans
    assert len(os.listdir(tmp_path)) == n
    assert bumped.scan()["valid"] == n


def test_prewarm_stages_and_scan_is_a_pure_probe(tmp_path):
    from pint_tpu_torch.store import PackStore

    sig = "pack-" + "f" * 40
    PackStore(tmp_path).put(sig, (0, 256), _synthetic_state())
    store = PackStore(tmp_path)
    assert store.prewarm(background=True) is not None
    assert store.load(sig, (0, 256)) is not None  # joins the worker
    c = store.counters()
    assert c["prewarm_hits"] == 1 and c["hits"] == 1
    store2 = PackStore(tmp_path)
    assert store2.prewarm(background=False) is None
    assert store2.load(sig, (0, 256)) is not None
    assert store2.counters()["prewarm_hits"] == 1
    assert PackStore(tmp_path / "empty").prewarm() is None

    sigb = "pack-" + "2" * 40
    store.put(sigb, (1, 512), _synthetic_state())
    rep = store.scan()
    assert rep["entries"] == 2 and rep["valid"] == 2
    store._damage(sigb, (1, 512), offset=3)
    with pytest.warns(UserWarning):
        rep2 = store.scan()
    assert rep2["corrupt_or_stale"] == 1 and rep2["valid"] == 1
    # telemetry-neutral: the corruption counters only move for traffic
    c = store.counters()
    assert c["corrupt"] == 0 and c["stale"] == 0


_KILL_CHILD = """
import os, warnings
warnings.simplefilter("ignore")
import numpy as np
from pint_tpu_torch.store import PackStore
store = PackStore({d!r})
store.put("pack-" + "9" * 40, (0, 256),
          {{"a": np.arange(64.0), "s": {{"k": 1}}}})
print("SURVIVED", len(os.listdir({d!r})))
"""


def test_sigkill_at_store_write_leaves_no_torn_artifact(tmp_path):
    """``store_write`` fires immediately before the atomic publish: the
    killed writer leaves an empty directory (no entry, no temp file),
    and an unfaulted retry publishes a verifying entry."""
    from pint_tpu_torch.store import PackStore

    d = str(tmp_path / "store")
    code = _KILL_CHILD.format(d=d)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root,
               PINT_TPU_FAULTS="process_kill:at=store_write,after=0")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == -9, proc.stderr[-1000:]
    assert "SURVIVED" not in proc.stdout
    assert (os.listdir(d) if os.path.isdir(d) else []) == []
    env.pop("PINT_TPU_FAULTS")
    proc2 = subprocess.run([sys.executable, "-c", code], env=env,
                           capture_output=True, text=True, timeout=300)
    assert proc2.returncode == 0, proc2.stderr[-1000:]
    assert "SURVIVED 1" in proc2.stdout
    rep = PackStore(d).scan()
    assert rep == {"entries": 1, "valid": 1, "corrupt_or_stale": 0,
                   "bytes": rep["bytes"]} and rep["bytes"] > 0
