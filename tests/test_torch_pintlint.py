"""pintlint retargeted at the port (pint_tpu_torch/analysis): the rule
families that carry over, held finding for finding to the JAX
package's on tests/test_pintlint.py's fixtures, then the gate over the
port's tree. The torch counterparts of the precision, retrace,
signature, kernel-fallback and bench families are held to the JAX rules
on translated fixtures in tests/test_torch_lint_counterparts.py.

Parity: every fixture goes through both packages' ``run`` under the
same fixture ``LintConfig``; the JAX package's findings are filtered to
the ported rules (it also runs the families not ported yet), and the
port's messages name ``pint_tpu_torch.`` where the JAX package's name
``pint_tpu.`` (the one difference allowed). Both must give the same
(rule, path, line, message, suppressed), and the JAX test's expected
counts. The suppression, report and CLI fixtures use ported rules
where the JAX test uses nan-guard.

The gate: zero unsuppressed findings over ``pint_tpu_torch/``, the
device fault points armed by the port's tests, a pinned suppression
count, a clean index, and an acyclic lock DAG with its expected edges.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "pint_tpu_torch")

PORTED = ("lock-discipline", "locked-helper-call", "lock-order-cycle",
          "registry-drift", "durable-write-unatomic", "fault-point-unknown",
          "fault-point-unfired", "fault-point-untested",
          "request-state-leak", "timing-untraced", "quality-signal-dropped",
          "bucket-hardcoded", "nan-guard", "serve-unpadded-batch")

# The torch counterparts of the JAX package's precision, retrace,
# signature, kernel-fallback and bench rules: the same ids and families,
# held to the JAX rules on torch translations of their fixtures
# (tests/test_torch_lint_counterparts.py).
COUNTERPARTS = ("f32-in-f64", "precision-flow", "host-sync-in-jit",
                "static-unhashable", "signature-incomplete",
                "kernel-silent-fallback", "timing-no-block")

# The budget rule: the JAX package's id and family over the port's own
# budget file (tests/test_torch_baseline.py holds it to the JAX rule).
BUDGET = ("meta-key-unbudgeted",)


def _pkg(name):
    import importlib

    return importlib.import_module(name + ".analysis")


def _key(f):
    return (f.rule, f.path.replace(os.sep, "/"), f.line,
            f.message.replace("pint_tpu_torch.", "pint_tpu."), f.suppressed)


def _write(tmp_path, sources):
    paths = []
    for rel, src in sources.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
        paths.append(str(p))
    return paths


def both(tmp_path, sources, **cfg):
    """(JAX findings on the ported rules, the port's findings), as
    comparable tuples, for ``sources`` under ``LintConfig(**cfg)``."""
    paths = _write(tmp_path, sources)
    out = []
    for name in ("pint_tpu", "pint_tpu_torch"):
        mod = _pkg(name)
        fs = mod.run(paths, config=mod.LintConfig(**cfg))
        out.append(sorted(_key(f) for f in fs if f.rule in PORTED))
    return out


# -- fixtures: tests/test_pintlint.py's, as (config, sources, counts) --

LOCK_CFG = dict(locked_classes={"Cache": {"lock": "_lock", "attrs": None}},
                locked_globals={"CACHE": "CACHE_LOCK"})
BUCKET_CFG = dict(
    bucket_allowed_modules=("parallel/shapeplan.py", "serve/batcher.py"))
FAULT_CFG = dict(fault_registry_suffix="faultreg.py")
OBS_CFG = dict(obs_instrumented_modules=("/engine.py",))
QUALITY_CFG = dict(quality_signal_modules=("/fitter.py",))
RSL_CFG = dict(serve_state_modules=("/engine.py",))
DURABLE_CFG = dict(
    durable_artifact_modules=("/checkpoint.py", "/serve/journal.py"))

CACHE_BAD = """
    import threading

    class Cache:
        def __init__(self):
            self._lock = threading.RLock()
            self.hits = 0
            self._d = {}

        def bump(self):
            self.hits += 1

        def put(self, key, value):
            self._d[key] = value

        def drop(self, key):
            self._d.pop(key, None)
"""
CACHE_GOOD = """
    import threading

    class Cache:
        def __init__(self):
            self._lock = threading.RLock()
            self.hits = 0
            self._d = {}

        def bump(self):
            with self._lock:
                self.hits += 1

        def put(self, key, value):
            with self._lock:
                self._d[key] = value
"""
GLOBAL_BAD = """
    import threading

    CACHE = {}
    CACHE_LOCK = threading.RLock()

    def put(key, value):
        CACHE[key] = value
"""
GLOBAL_GOOD = """
    import threading

    CACHE = {}
    CACHE_LOCK = threading.RLock()

    def put(key, value):
        with CACHE_LOCK:
            CACHE[key] = value
"""
HELPER_BAD = """
    import threading

    class Cache:
        def __init__(self):
            self._lock = threading.RLock()
            self._d = {}

        def _entry_locked(self, key):
            return self._d.setdefault(key, {"n": 0})

        def bump(self, key):
            e = self._entry_locked(key)
            e["n"] += 1
"""
HELPER_GOOD = """
    import threading

    class Cache:
        def __init__(self):
            self._lock = threading.RLock()
            self._d = {}

        def _entry_locked(self, key):
            return self._d.setdefault(key, {"n": 0})

        def bump(self, key):
            with self._lock:
                e = self._entry_locked(key)
                e["n"] += 1
"""
FAULT_REGISTRY = """
    POINTS = ("toa_nan", "compile_fail")

    def fire(point):
        return point in POINTS
"""
DEVICE_FAULT_REGISTRY = """
    POINTS = ("toa_nan", "device_loss", "straggler_delay")
    DEVICE_POINTS = ("device_loss", "straggler_delay")

    def fire(point):
        return point in POINTS
"""
DEVICE_FAULT_USER = """
    from faultreg import fire

    def go():
        fire("toa_nan")
        fire("device_loss")
        fire("straggler_delay")
"""
RAW_TIMER = """
    import time

    def probe():
        return time.perf_counter()
"""
OPEN_W = """
    def export(path, text):
        with open(path, "w") as fh:
            fh.write(text)
"""
TWO_LOCKS = """
    import threading

    A = threading.Lock()
    B = threading.Lock()

    def f1():
        with A:
            with B:
                pass

    def f2():
        with A, B:
            pass
"""

SERVE_CFG = dict(serve_pad_modules=("serve/",))

CASES = {
    "nan_gt_on_diagnostic": ({}, {"m.py": """
        import numpy as np

        def finalize(relres):
            if np.max(relres) > 1e-8:  # the pta.py:937 bug
                return "fallback"
            return "ok"
    """}, {"nan-guard": 1}),
    "nan_float_cast_gt": ({}, {"m.py": """
        def check(rel_resid):
            return float(rel_resid) > 1e-8  # the fitter.py bug
    """}, {"nan-guard": 1}),
    "nan_builtin_max_fold": ({}, {"m.py": """
        def worst_of(rels):
            worst = 0.0
            for rel in rels:
                worst = max(worst, float(rel.relres))
            return worst
    """}, {"nan-guard": 1}),
    "nan_sanctioned_forms": ({}, {"m.py": """
        import numpy as np

        from pint_tpu.fitter import relres_failed

        def finalize(relres):
            if relres_failed(relres, tol=1e-8):
                return "fallback"
            return "ok"

        def check(rel_resid):
            return not np.all(rel_resid <= 1e-8)

        def worst_of(rels):
            worst = 0.0
            for rel in rels:
                worst = float(np.maximum(worst, rel.relres))
            return worst
    """}, {}),
    "serve_unpadded_missing_pad": (SERVE_CFG, {"serve/eng.py": """
        def flush(models, toas_list, bucket):
            pta = PTABatch(models, toas_list)
            return pta
    """}, {"serve-unpadded-batch": 1}),
    "serve_unpadded_with_pad": (SERVE_CFG, {"serve/eng.py": """
        def flush(models, toas_list, bucket):
            pta = PTABatch(models, toas_list, pad_toas=bucket)
            return pta
    """}, {}),
    "bucket_direct_call": (BUCKET_CFG, {"parallel/grouping.py": """
        from pint_tpu.serve.batcher import pow2_bucket

        def group(toas_list, floor):
            return {pow2_bucket(len(t), floor) for t in toas_list}
    """}, {"bucket-hardcoded": 1}),
    "bucket_attribute_call": (BUCKET_CFG, {"serve/eng.py": """
        from pint_tpu.serve import batcher

        def width(n):
            return batcher.pow2_bucket(n)
    """}, {"bucket-hardcoded": 1}),
    "bucket_allowed_modules": (BUCKET_CFG, {"serve/batcher.py": """
        def pow2_bucket(n, floor=256):
            b = int(floor)
            while b < n:
                b *= 2
            return b

        def slot(n):
            return pow2_bucket(n)
    """, "parallel/shapeplan.py": """
        def pow2_width(n, floor=256):
            from ..serve.batcher import pow2_bucket

            return pow2_bucket(n, floor)
    """}, {}),
    "bucket_planner_api": (BUCKET_CFG, {"serve/eng.py": """
        from pint_tpu.parallel.shapeplan import ladder_width, pow2_width

        def width(n, plan):
            if plan is not None:
                return ladder_width(n, plan.widths)
            return pow2_width(n)
    """}, {}),
    "lock_unlocked_mutations": (LOCK_CFG, {"m.py": CACHE_BAD},
                                {"lock-discipline": 3}),
    "lock_quiet_under_lock": (LOCK_CFG, {"m.py": CACHE_GOOD}, {}),
    "lock_module_global_bad": (LOCK_CFG, {"a/m.py": GLOBAL_BAD},
                               {"lock-discipline": 1}),
    "lock_module_global_good": (LOCK_CFG, {"b/m.py": GLOBAL_GOOD}, {}),
    "locked_helper_bad": (LOCK_CFG, {"a/m.py": HELPER_BAD},
                          {"locked-helper-call": 1}),
    "locked_helper_good": (LOCK_CFG, {"b/m.py": HELPER_GOOD}, {}),
    "fault_unknown_typo": (FAULT_CFG, {"faultreg.py": FAULT_REGISTRY,
                                       "user.py": """
        from faultreg import fire

        def go():
            fire("toa_nan")
            fire("compile_fial")  # typo'd point: never fires
            fire("compile_fail")
    """}, {"fault-point-unknown": 1}),
    "fault_unfired": (FAULT_CFG, {"faultreg.py": FAULT_REGISTRY,
                                  "user.py": """
        from faultreg import fire

        def go():
            fire("toa_nan")
    """}, {"fault-point-unfired": 1}),
    "fault_untested": (FAULT_CFG, {"faultreg.py": DEVICE_FAULT_REGISTRY,
                                   "user.py": DEVICE_FAULT_USER,
                                   "tests/test_chaos.py": """
        from faultreg import FaultPoint, inject

        def test_device_loss():
            with inject(FaultPoint("device_loss", rate=1.0)):
                pass
    """}, {"fault-point-untested": 1}),
    "fault_all_armed": (FAULT_CFG, {"faultreg.py": DEVICE_FAULT_REGISTRY,
                                    "user.py": DEVICE_FAULT_USER,
                                    "tests/test_chaos.py": """
        from faultreg import FaultPoint, inject

        def test_chaos():
            with inject(FaultPoint("device_loss", rate=1.0),
                        FaultPoint("straggler_delay", rate=1.0)):
                pass
    """}, {}),
    "fault_no_tests_in_scope": (FAULT_CFG, {
        "faultreg.py": DEVICE_FAULT_REGISTRY, "user.py": DEVICE_FAULT_USER},
        {}),
    "timing_raw_reads": (OBS_CFG, {"engine.py": """
        import time

        def flush():
            t0 = time.perf_counter()
            wall = time.time()
            return time.perf_counter() - t0, wall
    """}, {"timing-untraced": 3}),
    "timing_obs_clock_and_sleep": (OBS_CFG, {"engine.py": """
        import time

        from pint_tpu.obs import clock as obs_clock

        def flush(clock=time.monotonic):  # reference, not a call
            t0 = obs_clock.now()
            time.sleep(0.0)  # a delay, not a measurement
            return obs_clock.now() - t0
    """}, {}),
    "timing_outside_instrumented": (OBS_CFG, {"other.py": """
        import time

        def helper():
            return time.perf_counter()
    """}, {}),
    "timing_obs_package_and_tests": (
        dict(obs_instrumented_modules=("/clock.py", "/test_engine.py")),
        {"obs/clock.py": RAW_TIMER, "tests/test_engine.py": RAW_TIMER}, {}),
    "quality_unrecorded_verdict": (QUALITY_CFG, {"fitter.py": """
        def gls_solve(relres):
            if relres_failed(relres):
                return "f64"
            return "mixed"
    """}, {"quality-signal-dropped": 1}),
    "quality_unrecorded_chi2": (QUALITY_CFG, {"fitter.py": """
        class F:
            def fit_toas(self, chi2):
                self.chi2_whitened = chi2
                return chi2
    """}, {"quality-signal-dropped": 1}),
    "quality_recorded": (QUALITY_CFG, {"fitter.py": """
        from pint_tpu.obs import fitquality as obs_fitq

        def gls_solve(relres):
            if relres_failed(relres):
                obs_fitq.FITQ.note_fallback(["gls_solve"])
                return "f64"
            return "mixed"

        class F:
            def fit_toas(self, chi2):
                self.chi2_whitened = chi2
                self._record_fit_quality(chi2)
                return chi2
    """}, {}),
    "quality_guard_def_and_reads": (QUALITY_CFG, {"fitter.py": """
        def relres_failed(rel, tol=1e-8):
            return not (rel <= tol)

        def report(fitter):
            return getattr(fitter, "chi2_whitened", None)
    """}, {}),
    "quality_scoped": (QUALITY_CFG, {"other.py": """
        def gls_solve(relres):
            return relres_failed(relres)
    """}, {}),
    "quality_suppressed": (QUALITY_CFG, {"fitter.py": """
        def gls_solve(relres):
            # probe diagnostic, recorded by the caller
            # pintlint: disable=quality-signal-dropped
            return relres_failed(relres)
    """}, {}),
    "rsl_unrecorded_status": (RSL_CFG, {"engine.py": """
        def shed(res):
            res.status = "shed"
            res.reason = "queue_full"
            return res
    """}, {"request-state-leak": 1}),
    "rsl_recorded": (RSL_CFG, {"engine.py": """
        class Engine:
            def shed_one(self, req, res):
                res.status = "shed"
                self.telemetry.incr("shed_queue_full")
                return res

            def error_one(self, req, res):
                res.status = "error"
                self._lc(req, "error")
                return res
    """}, {}),
    "rsl_self_state": (RSL_CFG, {"engine.py": """
        class Engine:
            def note(self):
                self.status = "healthy"
    """}, {}),
    "rsl_scoped": (RSL_CFG, {"other.py": """
        def shed(res):
            res.status = "shed"
    """}, {}),
    "rsl_suppressed": (RSL_CFG, {"engine.py": """
        def touch(res):
            # outcome recorded by the caller
            # pintlint: disable=request-state-leak
            res.reason = None
    """}, {}),
    "durable_truncating_open": (DURABLE_CFG, {"checkpoint.py": """
        import json

        def save_meta(path, meta):
            with open(path, "w") as fh:   # tears on a crash mid-write
                json.dump(meta, fh)
    """}, {"durable-write-unatomic": 1}),
    "durable_mode_kwarg_and_exclusive": (DURABLE_CFG, {
        "serve/journal.py": """
        def a(path):
            return open(path, mode="wb")

        def b(path):
            return open(path, "x")
    """, "anchor.py": "x = 1\n"}, {"durable-write-unatomic": 2}),
    "durable_reads_appends_patches": (DURABLE_CFG, {"serve/journal.py": """
        def scan(path):
            with open(path, "rb") as fh:
                return fh.read()

        def append_frame(path, frame):
            with open(path, "ab") as fh:
                fh.write(frame)

        def damage(path):
            with open(path, "r+b") as fh:
                fh.write(b"x")
    """, "anchor.py": "x = 1\n"}, {}),
    "durable_pack_store": (
        dict(durable_artifact_modules=("/checkpoint.py", "/obs/recorder.py",
                                       "/serve/journal.py",
                                       "/serve/excache.py",
                                       "/store/packstore.py",
                                       "/store/deltas.py")),
        {"store/packstore.py": """
        def save_entry(path, blob):
            with open(path, "wb") as fh:   # tears on a crash mid-write
                fh.write(blob)
    """, "anchor.py": "x = 1\n"}, {"durable-write-unatomic": 1}),
    "durable_scoped": (DURABLE_CFG, {"report.py": OPEN_W}, {}),
    "durable_suppressed": (DURABLE_CFG, {"checkpoint.py": """
        def debug_dump(path, text):
            # throwaway debug artifact, loss is fine
            # pintlint: disable=durable-write-unatomic
            with open(path, "w") as fh:
                fh.write(text)
    """}, {}),
    "lockorder_two_lock_inversion": ({}, {"m.py": """
        import threading

        A = threading.Lock()
        B = threading.Lock()

        def ab():
            with A:
                with B:
                    pass

        def ba():
            with B:
                with A:
                    pass
    """}, {"lock-order-cycle": 1}),
    "lockorder_three_locks_call_mediated": ({}, {"one.py": """
        import threading

        from two import mid

        A = threading.Lock()

        def start():
            with A:
                mid()

        def use_a():
            with A:
                pass
    """, "two.py": """
        import threading

        from one import use_a

        B = threading.Lock()
        C = threading.Lock()

        def mid():
            with B:
                tail()

        def tail():
            with C:
                use_a()
    """}, {"lock-order-cycle": 1}),
    "lockorder_locked_helper_mediated": ({}, {"pair.py": """
        import threading

        class A:
            def __init__(self):
                self._lock = threading.Lock()
                self.buddy = B()

            def poke(self):
                with self._lock:
                    self.buddy.grab()

        class B:
            def __init__(self):
                self._lock = threading.Lock()
                self.peer = A()

            def grab(self):
                with self._lock:
                    pass

            def sync_locked(self):
                self.peer.poke()
    """}, {"lock-order-cycle": 1}),
    "lockorder_quiet": ({}, {"m.py": TWO_LOCKS}, {}),
    "registry_unregistered_owner": (
        dict(locked_classes={"Known": {"lock": "_lock", "attrs": None}}),
        {"m.py": """
        import threading

        class Known:
            def __init__(self):
                self._lock = threading.Lock()

        class Rogue:
            def __init__(self):
                self._lock = threading.RLock()
                self.hits = 0
    """}, {"registry-drift": 1}),
    "registry_inert_on_empty": ({}, {"m.py": """
        import threading

        class Rogue:
            def __init__(self):
                self._lock = threading.Lock()
    """}, {}),
    "registry_stale_entries": (
        dict(locked_classes={"Ghost": {"lock": "_lock", "attrs": None}},
             serve_state_modules=("serve/engine.py",),
             registry_anchor_suffix="reg.py"),
        {"reg.py": "X = 1\n", "m.py": "class NotGhost:\n    pass\n"},
        {"registry-drift": 2}),
    "registry_stale_needs_anchor": (
        dict(serve_state_modules=("serve/engine.py",),
             registry_anchor_suffix="reg.py"),
        {"m.py": "class C:\n    pass\n"}, {}),
    "suppression_inline_next_line": (OBS_CFG, {"engine.py": """
        import time

        def a():
            return time.perf_counter()  # pintlint: disable=timing-untraced

        def b():
            # a raw read the caller folds into its own span
            # pintlint: disable=timing-untraced
            return time.perf_counter()

        def c():
            return time.perf_counter()
    """}, {"timing-untraced": 1}),
    "suppression_file_and_all": (OBS_CFG, {"engine.py": """
        # pintlint: disable-file=timing-untraced
        import time

        def a():
            return time.perf_counter()

        def b():
            return time.time()  # pintlint: disable=all
    """}, {}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_fixture_parity_with_jax(tmp_path, name):
    """Each fixture: the same findings (rule, path, line, message,
    suppressed) in both packages, and the JAX test's expected counts of
    unsuppressed findings."""
    cfg, sources, counts = CASES[name]
    jax_f, port_f = both(tmp_path, sources, **cfg)
    assert port_f == jax_f
    live = {}
    for rule, _, _, _, suppressed in port_f:
        if not suppressed:
            live[rule] = live.get(rule, 0) + 1
    assert live == counts


def test_suppressed_findings_still_reported(tmp_path):
    """A suppressed finding is reported with suppressed=True, in both
    packages alike (the suppression fixtures above)."""
    for name in ("suppression_inline_next_line", "suppression_file_and_all",
                 "durable_suppressed", "quality_suppressed",
                 "rsl_suppressed"):
        cfg, sources, _ = CASES[name]
        _, port_f = both(tmp_path / name, sources, **cfg)
        assert any(f[4] for f in port_f), name


def test_lock_dag_artifact_matches_jax(tmp_path):
    """lock_order_graph on the two-lock fixture: the same nodes, edges
    and witness paths in both packages."""
    from pint_tpu.analysis.rules_lockorder import lock_order_graph as jg
    from pint_tpu_torch.analysis.rules_lockorder import lock_order_graph

    paths = _write(tmp_path, {"m.py": TWO_LOCKS})
    import pint_tpu.analysis as ja
    import pint_tpu_torch.analysis as ta

    dag = lock_order_graph(paths, config=ta.LintConfig())
    assert dag == jg(paths, config=ja.LintConfig())
    assert set(dag["nodes"]) == {"m.A", "m.B"}
    assert {(e["held"], e["acquired"]) for e in dag["edges"]} == {
        ("m.A", "m.B")}


def test_reports_match_jax(tmp_path):
    """text_report and json_report of the same findings: equal text,
    and JSON equal in every field."""
    import pint_tpu.analysis as ja
    import pint_tpu_torch.analysis as ta

    cfg, sources, _ = CASES["suppression_inline_next_line"]
    paths = _write(tmp_path, sources)
    jf = [f for f in ja.run(paths, config=ja.LintConfig(**cfg))
          if f.rule in PORTED]
    tf = ta.run(paths, config=ta.LintConfig(**cfg))
    norm = lambda s: s.replace("pint_tpu_torch.", "pint_tpu.")  # noqa: E731
    assert norm(ta.text_report(tf)) == ja.text_report(jf)
    assert norm(ta.text_report(tf, show_suppressed=True)) == ja.text_report(
        jf, show_suppressed=True)
    assert json.loads(norm(ta.json_report(tf))) == json.loads(
        ja.json_report(jf))
    assert "[timing-untraced]" in ta.text_report(tf)


def _cli(pkg, *argv, cwd=REPO, env=None):
    env = dict(env or os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", pkg + ".analysis", *argv],
                          capture_output=True, text=True, cwd=cwd, env=env)


def _main(pkg, capsys, *argv):
    """(exit status, stdout) of ``pkg``'s CLI main in this process."""
    import importlib

    rc = importlib.import_module(pkg + ".analysis.__main__").main(list(argv))
    return rc, capsys.readouterr().out


def test_cli_exit_codes_list_rules_and_lock_dag(tmp_path, capsys):
    """Exit 1 on a finding (--format json, as the JAX CLI reports it),
    0 on a clean file, 2 on a usage error; --list-rules prints the JAX
    CLI's rule ids, each carried-over rule as the JAX CLI does; --lock-dag
    writes the graph; and
    ``python -m pint_tpu_torch.analysis`` exits 1 from a process."""
    bad = tmp_path / "checkpoint.py"
    bad.write_text('def f(p):\n    return open(p, "w")\n')
    good = tmp_path / "good.py"
    good.write_text("def f(x):\n    return x\n")
    norm = lambda s: s.replace("pint_tpu_torch.", "pint_tpu.")  # noqa: E731
    rc, out = _main("pint_tpu_torch", capsys, str(bad), "--format", "json")
    assert rc == 1
    payload = json.loads(norm(out))
    assert payload["counts_by_rule"] == {"durable-write-unatomic": 1}
    _, jout = _main("pint_tpu", capsys, str(bad), "--format", "json")
    assert [f for f in json.loads(jout)["findings"]
            if f["rule"] in PORTED] == payload["findings"]
    assert _main("pint_tpu_torch", capsys, str(good))[0] == 0
    with pytest.raises(SystemExit) as usage:
        _main("pint_tpu_torch", capsys, "--changed", str(good))
    assert usage.value.code == 2
    rc, out = _main("pint_tpu_torch", capsys, "--list-rules")
    jr = _main("pint_tpu", capsys, "--list-rules")[1].splitlines()
    lines = norm(out).splitlines()
    # the JAX package's 22 ids
    assert rc == 0 and len(lines) == 22
    assert sorted(ln.split()[0] for ln in lines) == sorted(
        ln.split()[0] for ln in jr)
    assert sorted(PORTED + COUNTERPARTS + BUDGET) == sorted(
        ln.split()[0] for ln in lines)
    # rules carried over print the JAX line; counterparts and the budget
    # rule its id, family and whole-program tag, with their own rationale
    head = {ln.split()[0]: ln.split()[1:3] for ln in jr}
    for ln in lines:
        rid = ln.split()[0]
        if rid in PORTED:
            assert ln in jr
        else:
            assert ln.split()[1] == head[rid][0], ln
            assert ("(whole-program)" in ln) == ("(whole-program)" in head[rid])
    src = tmp_path / "src"
    _write(src, {"m.py": TWO_LOCKS})
    out_path = tmp_path / "dag.json"
    rc, _ = _main("pint_tpu_torch", capsys, str(src), "--lock-dag",
                  str(out_path))
    assert rc == 0
    dag = json.loads(out_path.read_text())
    assert {"m.A", "m.B"} <= set(dag["nodes"]) and dag["edges"]
    r = _cli("pint_tpu_torch", str(bad))
    assert r.returncode == 1 and "durable-write-unatomic" in r.stdout


def test_cli_changed_mode(tmp_path):
    """--changed lints only the git diff (the staged set with
    --cached), exits 0 on a clean tree and 1 on a staged finding."""
    repo = tmp_path / "wt"
    repo.mkdir()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""),
               GIT_AUTHOR_NAME="t", GIT_AUTHOR_EMAIL="t@t",
               GIT_COMMITTER_NAME="t", GIT_COMMITTER_EMAIL="t@t")

    def git(*argv):
        r = subprocess.run(["git"] + list(argv), cwd=repo, env=env,
                           capture_output=True, text=True)
        assert r.returncode == 0, r.stderr

    git("init", "-q")
    (repo / "ok.py").write_text("def f(x):\n    return x\n")
    git("add", "ok.py")
    git("commit", "-q", "-m", "seed")
    r = _cli("pint_tpu_torch", "--changed", cwd=repo, env=env)
    assert r.returncode == 0 and "no changed python files" in r.stdout
    (repo / "checkpoint.py").write_text('def f(p):\n    return open(p, "w")\n')
    git("add", "checkpoint.py")
    r = _cli("pint_tpu_torch", "--changed", "--cached", cwd=repo, env=env)
    assert r.returncode == 1 and "durable-write-unatomic" in r.stdout


# -- the gate over the port's tree ------------------------------------

_TREE_SCAN = None


def tree_scan():
    """One whole-program scan of pint_tpu_torch/ per pytest run (~16 s)."""
    global _TREE_SCAN
    if _TREE_SCAN is None:
        from pint_tpu_torch.analysis import LintConfig, run_project

        _TREE_SCAN = run_project([PKG], config=LintConfig.default())
    return _TREE_SCAN


def test_tree_has_zero_unsuppressed_findings():
    """pintlint over pint_tpu_torch/ with the port's registries (what
    ``python -m pint_tpu_torch.analysis pint_tpu_torch/`` runs) finds
    nothing unsuppressed."""
    from pint_tpu_torch.analysis import text_report, unsuppressed

    findings, _ = tree_scan()
    assert unsuppressed(findings) == [], text_report(findings)


def test_tree_counterparts_quiet_at_the_port_idioms():
    """The JAX package's rules copied onto the port's tree (only their
    registries swapped) flag five sites of parallel/pta.py that are the
    port's idioms: precision-flow twice in the packed program's mixed
    branch (K1's f32 Gram, cast back by ``.to(torch.float64)`` in
    kernels/fusedgls.py and kernels/seggram.py), signature-incomplete
    at ``time_residuals`` and ``phases`` (``*self._leaves()`` passes the
    method's value), host-sync-in-jit in ``PTAFleet.fit`` (a host method
    named like the builders' ``fit`` closures). The counterparts flag
    none of pta.py, suppressed or not."""
    findings, _ = tree_scan()
    assert [f for f in findings
            if f.path.replace(os.sep, "/") == "parallel/pta.py"
            and f.rule in ("precision-flow", "signature-incomplete",
                           "host-sync-in-jit")] == []


def test_tree_device_faults_are_armed_by_port_tests():
    """Every device fault point of the port's registry is armed by one
    of the port's tests (tests/test_torch_*.py)."""
    import glob

    from pint_tpu_torch.analysis import LintConfig, run, unsuppressed

    tests = sorted(glob.glob(os.path.join(REPO, "tests", "test_torch_*.py")))
    findings = run([PKG] + tests, config=LintConfig.default(),
                   whole_program=False)
    assert [f for f in unsuppressed(findings)
            if f.rule.startswith("fault-point")] == []


def test_tree_suppressions_stay_bounded():
    """The port's suppressions, pinned: the JAX package's set — the two
    quality-signal-dropped ones (the precision-auto probe in
    ``PTABatch._resolve_precision``, the single-pulsar
    ``toa_shard.sharded_gls_fit``) and the serve-unpadded-batch one of
    the engine's oversize spill path (``ServeEngine._execute_solo``),
    each justified in place."""
    from pint_tpu_torch.analysis import text_report

    findings, _ = tree_scan()
    by_rule = {}
    for f in findings:
        if f.suppressed:
            by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    assert by_rule == {"quality-signal-dropped": 2,
                       "serve-unpadded-batch": 1}, text_report(
        findings, show_suppressed=True)
    assert sorted((f.path, f.rule) for f in findings if f.suppressed) == [
        ("parallel/pta.py", "quality-signal-dropped"),
        ("parallel/toa_shard.py", "quality-signal-dropped"),
        ("serve/engine.py", "serve-unpadded-batch")]


def test_tree_index_builds_cleanly():
    """The whole-program pass indexes every module of the port."""
    from pint_tpu_torch.analysis.core import iter_py_files

    _, project = tree_scan()
    idx = project.index
    assert len(idx.modules) == len(list(iter_py_files([PKG])))
    assert not project.extra_findings, project.extra_findings
    assert idx.functions and idx.classes


def _cycle(edges):
    """A cycle in the directed graph ``edges``, or None."""
    adj = {}
    for a, b in edges:
        adj.setdefault(a, set()).add(b)
    state = {}

    def visit(v, path):
        state[v] = 1
        for w in sorted(adj.get(v, ())):
            if state.get(w) == 1:
                return path + [w]
            if w not in state:
                found = visit(w, path + [w])
                if found:
                    return found
        state[v] = 2
        return None

    for v in sorted(adj):
        if v not in state:
            found = visit(v, [v])
            if found:
                return found
    return None


def test_tree_lock_dag_acyclic_with_expected_edges():
    """The port's acquired-while-held graph is a DAG with the serve
    path's edges (the engine's work mutex over its collaborators'
    locks, telemetry over its histograms, the memory tier over the
    persistent one). The three process-wide module locks are in it by
    their own names with no static edge: ``graphs._LOCK`` is taken in
    ``GraphProgram``'s capture and call and ``autodiff.LOCK`` in the
    closure ``autodiff.jacfwd`` returns, both reached through callables
    held in dicts and closures, which the call graph does not follow;
    under them the analysis sees no other lock taken."""
    _, project = tree_scan()
    dag = project.lock_graph.as_dict()
    edges = {(e["held"], e["acquired"]) for e in dag["edges"]}
    assert _cycle(edges) is None
    expected = {
        ("ServeEngine._work_mutex", "IntakeQueue._lock"),
        ("ServeEngine._work_mutex", "ServeTelemetry._lock"),
        ("ServeEngine._work_mutex", "ExecutableCache._lock"),
        ("ServeEngine._work_mutex", "StreamingRefitter._lock"),
        ("ServeEngine._work_mutex", "parallel.pta._PRECISION_AUTO_LOCK"),
        ("ServeTelemetry._lock", "Histogram._lock"),
        ("ExecutableCache._lock", "PersistentExecutableCache._lock"),
    }
    assert expected <= edges, sorted(edges)
    module_locks = {"graphs._LOCK", "autodiff.LOCK", "kernels.build._LOCK"}
    assert module_locks <= set(dag["nodes"])
    assert not [e for e in edges if set(e) & module_locks]


def test_precision_auto_cache_holds_its_lock(tmp_path):
    """The port's precision="auto" cache is read and written under
    ``_PRECISION_AUTO_LOCK`` (it was not: lock-discipline flags the
    unlocked form, which the fleet's build pool and a concurrent
    prewarm reach from two threads)."""
    import threading

    from pint_tpu_torch.analysis import LintConfig, run, unsuppressed
    from pint_tpu_torch.parallel import pta

    assert isinstance(pta._PRECISION_AUTO_LOCK, type(threading.RLock()))
    src = open(os.path.join(PKG, "parallel", "pta.py")).read()
    unlocked = src.replace("        with _PRECISION_AUTO_LOCK:\n            choice",
                           "        if True:\n            choice")
    assert unlocked != src
    cfg = LintConfig(locked_globals={
        "_PRECISION_AUTO_CACHE": "_PRECISION_AUTO_LOCK"})
    for text, n in ((src, 0), (unlocked, 1)):  # the setdefault
        p = tmp_path / f"{n}" / "pta.py"
        p.parent.mkdir()
        p.write_text(text)
        hits = [f for f in unsuppressed(run([str(p)], config=cfg))
                if f.rule == "lock-discipline"]
        assert len(hits) == n, hits
