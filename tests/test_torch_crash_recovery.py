"""The port's durable serving stack (pint_tpu_torch/durable.py,
serve/journal.py, serve/recovery.py, the persisted program tier of
serve/excache.py, ServeEngine.recover and the SIGKILL matrix of
scripts/pint_serve_bench.py) against the JAX package's, on the CPU.

The layers bottom-up: the atomic-write helpers; the journal's frames,
held byte for byte to the JAX package's (the frame layout is the
contract, so either package replays the other's log), its commit
point, the dedup of re-taken intakes and torn-tail truncation; the
persisted tier's magic, CRC, stale and prewarm handling; the serve
state snapshot (read back by the JAX package too); in-process recovery
— bitwise a fault-free run within the port (the replay packs the
pending requests into other flushes than the dead process did), and
the JAX engine's replay of the same journal at the cross-package tiers
(parameters 1e-6 sigma, chi2 1e-9 relative); and a real SIGKILL matrix
over subprocesses at three of the kill sites (``mid_commit``,
``store_write``, ``append_delta_write``), at the JAX package's test
size. The whole eight-site matrix runs on the card (the ``cuda``-marked
test below and ``chip_smoke.py``'s ``[durable] kill``).
"""

import os
import pickle
import types
import warnings
import zlib

import numpy as np
import pytest
import torch

from test_torch_serve import pulsar, side

warnings.simplefilter("ignore")

TOL_SIGMA = 1e-6
TOL_CHI2 = 1e-9


@pytest.fixture(autouse=True)
def _disarm_everything():
    yield
    from pint_tpu.resilience import disarm as jax_disarm
    from pint_tpu_torch.resilience import disarm

    disarm()
    jax_disarm()


def _req(rid):
    """A picklable stand-in request for journal-only tests."""
    return types.SimpleNamespace(request_id=rid)


# -- atomic write helpers --------------------------------------------


def test_atomic_write_bytes_publishes_whole_or_nothing(tmp_path):
    from pint_tpu_torch.durable import atomic_write_bytes

    dst = tmp_path / "artifact.bin"
    assert atomic_write_bytes(dst, b"generation-1") == str(dst)
    atomic_write_bytes(dst, b"generation-2")
    assert dst.read_bytes() == b"generation-2"
    with pytest.raises(TypeError):
        atomic_write_bytes(dst, "not-bytes")
    assert dst.read_bytes() == b"generation-2"
    assert [p.name for p in tmp_path.iterdir()] == ["artifact.bin"]


def test_atomic_write_json_and_replace_match_jax(tmp_path):
    from pint_tpu.durable import atomic_write_json as jax_json
    from pint_tpu_torch.durable import (atomic_replace, atomic_write_json,
                                        fsync_dir)

    doc = {"a": [1, 2], "b": "héllo"}
    atomic_write_json(tmp_path / "p.json", doc, sort_keys=True)
    jax_json(tmp_path / "j.json", doc, sort_keys=True)
    assert (tmp_path / "p.json").read_bytes() \
        == (tmp_path / "j.json").read_bytes()
    new, cur = tmp_path / "snap.new", tmp_path / "snap"
    cur.write_bytes(b"old")
    new.write_bytes(b"new")
    atomic_replace(new, cur)
    assert cur.read_bytes() == b"new" and not new.exists()
    fsync_dir(tmp_path / "gone")  # a missing dir degrades silently


# -- request journal -------------------------------------------------


def _journal_pair(tmp_path):
    from pint_tpu.serve import RequestJournal as JaxJournal
    from pint_tpu_torch.serve import RequestJournal

    return (RequestJournal(tmp_path / "torch"),
            JaxJournal(tmp_path / "jax"))


def test_journal_frames_are_the_jax_packages(tmp_path):
    """The same records make the same bytes in both packages: magic,
    u32 length, u32 crc32 of the pickled payload. Each package replays
    the other's log."""
    from pint_tpu.serve import RequestJournal as JaxJournal
    from pint_tpu.serve import journal as jax_journal
    from pint_tpu_torch.serve import RequestJournal
    from pint_tpu_torch.serve import journal

    assert journal.MAGIC == jax_journal.MAGIC == b"PTJR"
    assert journal._HEADER.format == jax_journal._HEADER.format
    mine, theirs = _journal_pair(tmp_path)
    for j in (mine, theirs):
        j.record_intake(_req("a"))
        j.record_commit("a", "ok", value={"x": 1.5})
        j.record_intake(_req("b"))
        j.close()
    data = open(mine.path, "rb").read()
    assert data == open(theirs.path, "rb").read()
    # walk the frames by their headers
    off, n = 0, 0
    while off < len(data):
        assert data[off:off + 4] == b"PTJR"
        length, crc = journal._HEADER.unpack(data[off + 4:off + 12])
        payload = data[off + 12:off + 12 + length]
        assert zlib.crc32(payload) == crc
        off += 12 + length
        n += 1
    assert n == 3
    for cls, d in ((JaxJournal, mine.directory),
                   (RequestJournal, theirs.directory)):
        rep = cls(d).replay()
        assert set(rep.committed) == {"a"}
        assert rep.committed["a"]["value"] == {"x": 1.5}
        assert [r["rid"] for r in rep.pending] == ["b"]


def test_journal_replay_dedups_reintaken_requests(tmp_path):
    from pint_tpu_torch.serve import RequestJournal

    j = RequestJournal(tmp_path)
    j.record_intake(_req("a"))
    j.record_intake(_req("a"))  # a replayed request re-journals intake
    j.close()
    assert [r["rid"] for r in RequestJournal(tmp_path).replay().pending] \
        == ["a"]


def test_journal_torn_tail_truncated_like_jax(tmp_path):
    """A half-written frame: both packages warn, truncate the same
    bytes, and replay the valid prefix; the log is writable again."""
    mine, theirs = _journal_pair(tmp_path)
    from pint_tpu_torch.serve import journal

    payload = pickle.dumps({"t": "intake", "rid": "c"})
    frame = (journal.MAGIC
             + journal._HEADER.pack(len(payload), zlib.crc32(payload))
             + payload)
    reps = []
    for j in (mine, theirs):
        j.record_intake(_req("a"))
        j.record_commit("a", "ok", value=None)
        j.record_intake(_req("b"))
        j.close()
        good = os.path.getsize(j.path)
        with open(j.path, "ab") as fh:
            fh.write(frame[:len(frame) // 2])
        j2 = type(j)(j.directory)
        with pytest.warns(UserWarning, match="torn"):
            rep = j2.replay()
        assert os.path.getsize(j2.path) == good
        j2.record_intake(_req("d"))
        j2.close()
        reps.append((rep.torn_truncated, set(rep.committed),
                     [r["rid"] for r in rep.pending],
                     [r["rid"] for r in type(j)(j.directory)
                      .replay().pending]))
    assert reps[0] == reps[1] == (len(frame) // 2, {"a"}, ["b"],
                                  ["b", "d"])


def test_journal_torn_write_fault_point(tmp_path):
    from pint_tpu_torch.resilience import FaultPoint, inject
    from pint_tpu_torch.serve import RequestJournal

    j = RequestJournal(tmp_path)
    j.record_intake(_req("a"))
    with inject(FaultPoint("journal_torn_write", count=1,
                           payload={"frac": 0.4})):
        j.record_intake(_req("torn"))  # only 40% of the frame lands
    j.close()
    with pytest.warns(UserWarning, match="torn"):
        rep = RequestJournal(tmp_path).replay()
    assert rep.torn_truncated > 0
    assert [r["rid"] for r in rep.pending] == ["a"]


def test_journal_pickles_tensors_as_host_copies(tmp_path):
    """A record's tensors are written as host tensors, so a fresh
    process unpickles the log before it touches a card."""
    from pint_tpu_torch.serve import RequestJournal

    t = torch.arange(3.0)
    j = RequestJournal(tmp_path)
    j.record_commit("a", "ok", value={"x": t})
    j.close()
    got = RequestJournal(tmp_path).replay().committed["a"]["value"]["x"]
    assert got.device.type == "cpu" and torch.equal(got, t)


# -- persisted program tier ------------------------------------------


def _write_pex(pc, key, doc=None, identity=None):
    """Hand-build a framed .pex file the way store() would."""
    from pint_tpu_torch.durable import atomic_write_bytes
    from pint_tpu_torch.serve import excache as ex

    payload = pickle.dumps(dict(
        doc or {"programs": {}, "template_par": "", "pack": b""},
        identity=identity if identity is not None else pc.identity(key)))
    blob = (ex.PERSIST_MAGIC
            + ex._PERSIST_HEADER.pack(len(payload), zlib.crc32(payload))
            + payload)
    path = pc._path(key)
    atomic_write_bytes(path, blob)
    return path


def test_excache_framing_is_the_jax_packages():
    from pint_tpu.serve import excache as jex
    from pint_tpu_torch.serve import excache as ex

    assert ex.PERSIST_MAGIC == jex.PERSIST_MAGIC == b"PTEX"
    assert ex._PERSIST_HEADER.format == jex._PERSIST_HEADER.format
    assert ex.PERSIST_FORMAT_VERSION == jex.PERSIST_FORMAT_VERSION


def test_excache_bad_magic_and_crc_warn_delete(tmp_path):
    from pint_tpu_torch.durable import atomic_write_bytes
    from pint_tpu_torch.serve import PersistentExecutableCache

    pc = PersistentExecutableCache(tmp_path, device="cpu")
    path = pc._path("k")
    atomic_write_bytes(path, b"JUNKJUNKJUNKJUNK")
    with pytest.warns(UserWarning, match="unusable"):
        assert pc.load("k") is None
    assert not os.path.exists(path)
    path = _write_pex(pc, "k")
    pc._damage(path)  # the on-disk bitrot the CRC exists to catch
    with pytest.warns(UserWarning, match="CRC mismatch"):
        assert pc.load("k") is None
    assert not os.path.exists(path)
    assert pc.counters()["corrupt"] == 2


@pytest.mark.parametrize("field", ["torch_version", "cuda_version",
                                   "device_name", "capability",
                                   "pack_geometry", "format"])
def test_excache_stale_identity_refused(tmp_path, field):
    from pint_tpu_torch.serve import PersistentExecutableCache

    pc = PersistentExecutableCache(tmp_path, device="cpu")
    ident = pc.identity("k")
    ident[field] = "other"  # an upgrade happened
    path = _write_pex(pc, "k", identity=ident)
    with pytest.warns(UserWarning, match="stale"):
        assert pc.load("k") is None
    assert not os.path.exists(path)
    assert pc.counters()["stale"] == 1


@pytest.fixture(scope="module")
def wls_table():
    """(port pulsar, lane-padded batch, fit program table, options) of
    a captured (on the CPU: installed) WLS program."""
    from pint_tpu_torch.parallel import PTABatch

    p = pulsar(0, 24)
    m, t = side(p, "torch")
    pta = PTABatch([m, m], [t, t], pad_toas=32, device="cpu")
    opts = {"method": "wls", "maxiter": 2, "precision": "f64"}
    pta.aot_compile(**opts)
    return p, pta, dict(pta._fns), {pta.program_key(**opts): opts}


def test_excache_prewarm_recaptures_and_discards_corrupt(tmp_path,
                                                         wls_table):
    from pint_tpu_torch.serve import PersistentExecutableCache

    _, pta, fns, progs = wls_table
    pc = PersistentExecutableCache(tmp_path, device="cpu")
    for key in ("good", "bad"):
        pc.stage(key, pta, progs)
        assert pc.store(key, fns) == 1
    # nothing to re-capture: no file
    pc.stage("none", pta, None)
    assert pc.store("none", fns) == 0
    assert pc.store("unstaged", fns) == 0
    bad = pc._path("bad")
    pc._damage(bad)
    fresh = PersistentExecutableCache(tmp_path, device="cpu")
    with pytest.warns(UserWarning, match="CRC mismatch"):
        fresh.prewarm(background=False)
    assert not os.path.exists(bad)
    out = fresh.load("good")
    assert set(out) == set(progs)
    c = fresh.counters()
    assert c["prewarm_hits"] == 1 and c["recaptures"] == 1
    assert fresh.load("bad") is None
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(
        pc._path("good"))]


def test_excache_recaptured_program_fits_bitwise(tmp_path, wls_table):
    """A table re-captured from disk in a fresh tier fits a new batch
    bitwise as the original table does; the corrupt fault point's
    entry degrades to a warned miss."""
    from pint_tpu_torch.parallel import PTABatch
    from pint_tpu_torch.resilience import FaultPoint, inject
    from pint_tpu_torch.serve import PersistentExecutableCache

    p, pta, fns, progs = wls_table
    damaged = PersistentExecutableCache(tmp_path / "damaged", device="cpu")
    damaged.stage("k", pta, progs)
    with inject(FaultPoint("executable_cache_corrupt")):
        damaged.store("k", fns)
    with pytest.warns(UserWarning, match="CRC mismatch"):
        assert PersistentExecutableCache(tmp_path / "damaged",
                                         device="cpu").load("k") is None
    clean = PersistentExecutableCache(tmp_path / "clean", device="cpu")
    clean.stage("k", pta, progs)
    clean.store("k", fns)
    table = PersistentExecutableCache(tmp_path / "clean",
                                      device="cpu").load("k")
    q = pulsar(1, 20)
    m, t = side(q, "torch")
    outs = []
    for tab in (fns, table):
        b = PTABatch([m, m], [t, t], pad_toas=32, device="cpu")
        b._fns = tab
        outs.append(b.wls_fit(maxiter=2))
    for a, b in zip(*outs):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_jacfwd_shared_by_threads():
    """torch's forward-AD levels are process-global, so a re-capture on
    the persisted tier's prewarm thread beside lane registrations on the
    engine's thread broke on the card ("a forward AD level with an
    invalid index"). Every jacfwd of the port holds ``autodiff.LOCK``:
    threads fitting their own batches (each fit traces its design with
    jacfwd) under a short switch interval all finish, bitwise their
    batches' lone fits."""
    import sys
    import threading

    from pint_tpu_torch.parallel import PTABatch

    pts = [side(pulsar(i, 24 + 4 * i, seed=11), "torch") for i in range(4)]

    def fit(k):
        m, t = pts[k]
        x, chi2, cov = PTABatch([m, m], [t, t], pad_toas=48,
                                device="cpu").wls_fit(maxiter=2)
        return np.asarray(x), np.asarray(chi2), np.asarray(cov)

    alone = [fit(k) for k in range(len(pts))]
    out, errors = {}, []

    def work(k):
        try:
            out[k] = [fit(k) for _ in range(3)]
        except Exception as e:  # reported by the assert below
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(len(pts))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert errors == []
    for k, runs in out.items():
        for run in runs:
            assert all(np.array_equal(a, b) for a, b in zip(run, alone[k]))


# -- serve state snapshot --------------------------------------------


def test_serve_state_roundtrip_and_jax_reads_it(tmp_path):
    from pint_tpu.serve import ServeEngine as JaxEngine
    from pint_tpu.serve import restore_serve_state as jax_restore
    from pint_tpu_torch.serve import (ServeEngine, restore_serve_state,
                                      save_serve_state)

    kw = dict(max_batch=1, max_latency_s=1e9, bucket_floor=32)
    eng = ServeEngine(durable_dir=tmp_path, device="cpu", **kw)
    eng.breaker.trip(("fit", 32, "gls"))
    save_serve_state(eng)
    eng.journal.close()
    assert os.listdir(tmp_path / "state") == ["serve.npz"]

    fresh = ServeEngine(durable_dir=tmp_path, device="cpu", **kw)
    restored = restore_serve_state(fresh, tmp_path)
    assert {"breaker", "health", "engine"} <= restored
    assert fresh.breaker.open_count() == 1
    assert fresh.breaker.state(("fit", 32, "gls")) != "closed"
    fresh.journal.close()
    jeng = JaxEngine(**kw)
    assert {"breaker", "health", "engine"} <= jax_restore(jeng, tmp_path)
    assert jeng.breaker.open_count() == 1
    # a fresh start has nothing to restore
    assert restore_serve_state(
        ServeEngine(device="cpu", **kw), tmp_path / "none") is None


# -- in-process recovery ---------------------------------------------


@pytest.fixture(scope="module")
def recovery_runs(tmp_path_factory):
    """Three pending fits and one pending append of a dead process,
    recovered by each package. The dead process's journal: r0
    committed with a sentinel value, r1..r3 accepted but never
    delivered (fits of three different pulsars), a1 an append on a
    registered lane. The fault-free port run flushed (r0, r1), (r2,
    r3); the replay flushes (r1, r2), (r3 + a padding lane)."""
    import pint_tpu.serve as jserve
    import pint_tpu_torch.serve as tserve
    from pint_tpu_torch.serve import result_digest
    from pint_tpu_torch.simulation import make_fake_toas_fromMJDs

    ps = [pulsar(i, 24 + 2 * i, seed=5) for i in range(4)]
    out = {}
    for pkg, mod in (("torch", tserve), ("jax", jserve)):
        dev = {"device": "cpu"} if pkg == "torch" else {}

        def req(i, rid, mod=mod, pkg=pkg):
            m, t = side(ps[i], pkg)
            return mod.FitRequest(m, t, method="wls", maxiter=2,
                                  request_id=rid)

        ddir = tmp_path_factory.mktemp(f"durable-{pkg}")
        j = mod.RequestJournal(ddir)
        j.record_intake(req(0, "r0"))
        j.record_commit("r0", "ok", value={"marker": 1.0})
        for i in (1, 2, 3):
            j.record_intake(req(i, f"r{i}"))
        chunk = None
        if pkg == "torch":
            lane_m, lane_t = side(ps[0], "torch")
            rng = np.random.default_rng(9)
            chunk = make_fake_toas_fromMJDs(
                np.sort(rng.uniform(56600, 56610, 6)), lane_m,
                error_us=1.0, freq_mhz=1400.0, obs="gbt", add_noise=True,
                seed=9, iterations=0, device="cpu")
            j.record_intake(mod.AppendToasRequest(lane_m, chunk,
                                                  request_id="a1"))
        j.close()
        eng = mod.ServeEngine(max_batch=2, max_latency_s=1e9,
                              bucket_floor=32, durable_dir=ddir, **dev)
        if pkg == "torch":
            eng.register_append_lane(lane_m, lane_t, precision="mixed")
        rep = eng.recover()
        rep2 = eng.recover()
        eng.journal.close()
        out[pkg] = (rep, rep2)
        if pkg == "torch":
            # durable too: an append's value names its delta chain
            clean = mod.ServeEngine(
                max_batch=2, max_latency_s=1e9, bucket_floor=32,
                device="cpu",
                durable_dir=tmp_path_factory.mktemp("clean"))
            res = clean.run_stream([req(i, f"c{i}") for i in range(4)])
            clean.register_append_lane(lane_m, lane_t, precision="mixed")
            res.append(clean.submit(mod.AppendToasRequest(
                lane_m, chunk, request_id="a1")))
            out["clean"] = {f"r{i}": result_digest(r.value)
                            for i, r in enumerate(res[:4])}
            out["clean"]["a1"] = result_digest(res[4].value)
    return out


def test_recover_returns_committed_and_replays_pending(recovery_runs):
    rep, rep2 = recovery_runs["torch"]
    assert rep["n_committed"] == 1
    assert rep["committed"]["r0"]["value"] == {"marker": 1.0}
    assert rep["n_replayed"] == 4
    assert all(r.status == "ok" for r in rep["replayed"].values())
    # idempotent: a second recover finds everything committed
    assert rep2["n_replayed"] == 0
    assert set(rep2["committed"]) == {"r0", "r1", "r2", "r3", "a1"}


def test_recover_is_bitwise_the_fault_free_run(recovery_runs):
    """Replayed in other flush compositions than the fault-free run,
    every pending result keeps its bits."""
    from pint_tpu_torch.serve import result_digest

    rep, _ = recovery_runs["torch"]
    clean = recovery_runs["clean"]
    for rid, res in rep["replayed"].items():
        assert result_digest(res.value) == clean[rid], rid


def test_recover_matches_the_jax_engines_replay(recovery_runs):
    rep, _ = recovery_runs["torch"]
    jrep, jrep2 = recovery_runs["jax"]
    assert jrep["n_replayed"] == 3 and jrep2["n_replayed"] == 0
    for rid in ("r1", "r2", "r3"):
        mine = rep["replayed"][rid].value
        theirs = jrep["replayed"][rid].value
        assert mine["free_names"] == list(theirs["free_names"])
        sig = np.sqrt(np.diag(np.asarray(theirs["cov"])))
        gap = np.max(np.abs(np.asarray(mine["x"])
                            - np.asarray(theirs["x"])) / sig)
        assert gap < TOL_SIGMA, (rid, gap)
        assert abs(mine["chi2"] - theirs["chi2"]) \
            <= TOL_CHI2 * abs(theirs["chi2"])


# -- the SIGKILL matrix ----------------------------------------------


def _assert_matrix(report, sites):
    assert report["reference_ok"], report
    assert set(report["sites"]) == set(sites)
    for site, entry in report["sites"].items():
        assert entry["killed"], (site, entry)  # SIGKILL landed
        assert entry["ok"], (site, entry)
        assert entry["lost"] == 0 and entry["duplicated"] == 0
        assert entry["digest_mismatches"] == 0
        # every warm probe fitted, warm, to the reference's bits
        assert entry["warm_probes_ok"] and entry["probes_match_reference"]
        if site == "excache_store":
            assert entry["recompiles"] >= 1  # its store died: capture
        else:
            assert entry["recompiles"] == 0  # re-captured from disk
    if "mid_commit" in sites:
        assert report["sites"]["mid_commit"]["torn_truncated"] > 0
    if "store_write" in sites:
        sw = report["sites"]["store_write"]
        assert sw["store_ok"], sw
        assert sw["store_counters"]["corrupt"] == 0
        assert sw["store_scan"]["corrupt_or_stale"] == 0
        assert sw["store_scan"]["valid"] >= 1
    if "append_delta_write" in sites:
        ad = report["sites"]["append_delta_write"]
        assert ad["delta_ok"], ad
        assert ad["delta_scan"]["corrupt_or_stale"] == 0
    assert report["replayed"] > 0
    assert report["ok"], report


def test_sigkill_matrix_three_sites(tmp_path):
    """SIGKILL a real serving subprocess at three durability sites (a
    torn commit frame, the pack store's publish, a delta segment's
    publish), restart it, and hold recovery to exactly once: nothing
    lost, nothing delivered twice, every replayed result bitwise the
    fault-free reference's. The JAX package's test size (128 TOAs, two
    lanes, WLS); the timing bound is the card's (``[durable] kill``)."""
    from pint_tpu_torch.scripts.pint_serve_bench import run_kill_chaos

    sites = ("mid_commit", "store_write", "append_delta_write")
    report = run_kill_chaos(
        sites=sites, ntoa=128, lanes=2, maxiter=2, method="wls",
        structure=0, seed=3, workdir=str(tmp_path),
        ratio_bound=float("inf"), child_timeout_s=300.0, device="cpu")
    _assert_matrix(report, sites)


@pytest.mark.cuda
def test_sigkill_matrix_every_site_on_the_card(tmp_path):
    """The whole matrix on the card at the JAX package's bench size
    (8192 TOAs, four lanes, 40-iteration red-noise GLS): all eight
    sites, held to exactly-once bitwise replay. As in the JAX package's
    test only the correctness half is bounded here; ``chip_smoke.py``'s
    ``[durable] kill`` times the restarts one at a time against the 2x
    cold/warm bound (ROADMAP §3 logs the gap)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from pint_tpu_torch.resilience.faultinject import KILL_SITES
    from pint_tpu_torch.scripts.pint_serve_bench import run_kill_chaos

    report = run_kill_chaos(sites=KILL_SITES, workdir=str(tmp_path),
                            ratio_bound=float("inf"), device="cuda")
    _assert_matrix(report, KILL_SITES)
