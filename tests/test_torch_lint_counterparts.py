"""pintlint's precision, precision-flow, retrace, signature,
kernel-fallback and bench-timing rules as torch counterparts
(pint_tpu_torch/analysis), held to the JAX package's rules.

Each fixture of tests/test_pintlint.py that covers one of these rule
ids runs through the JAX rule as it is there, and its torch translation
through the port's rule: both give the same (rule, path, line) for the
counterpart ids, and the JAX test's counts. A translation keeps the
fixture's lines and swaps the idiom: ``jax.jit(f)`` becomes
``graphs.Program(f)`` / ``graphs.GraphProgram(f, x0)``, a ``*_pallas``
kernel a ``*_cuda`` wrapper, ``.astype(jnp.float32)``
``.to(torch.float32)``, a jit static argument an ``lru_cache``
argument, ``block_until_ready`` a host pull, ``note_pallas_fallback`` a
re-raise (the port has no fallback), and a traced closure takes the
batch's data as arguments (a captured closure reading ``self`` replays
the building batch's tensors). Then the torch-only fixtures, and
hazards seeded into copies of the port's own modules.
"""

import ast
import os
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "pint_tpu_torch")

RULES = ("nan-guard", "f32-in-f64", "precision-flow", "host-sync-in-jit",
         "static-unhashable", "serve-unpadded-batch", "signature-incomplete",
         "kernel-silent-fallback", "timing-no-block")


def _write(root, sources):
    paths = []
    for rel, src in sources.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
        paths.append(str(p))
    return paths


def lint(pkg, root, sources, **cfg):
    """All findings of ``pkg``'s analysis on ``sources`` written under
    ``root``, with ``LintConfig(**cfg)``."""
    import importlib

    mod = importlib.import_module(pkg + ".analysis")
    return mod.run(_write(root, sources), config=mod.LintConfig(**cfg))


def hits(findings, live_only=True):
    return sorted((f.rule, f.path.replace(os.sep, "/"), f.line)
                  for f in findings
                  if f.rule in RULES and not (live_only and f.suppressed))


# -- tests/test_pintlint.py's fixtures and their torch translations ---

F32 = dict(f64_critical={"crit.py": {"gls_whiten"}})
FLOW_JAX = dict(F32, f32_source_patterns=(r"_pallas$",))
FLOW_PORT = dict(F32, f32_source_patterns=(r"_cuda$",))
SERVE = dict(serve_pad_modules=("serve/",))
KERNEL = dict(kernel_dispatch_modules=("/kernels/",))
SIG = dict(signature_classes={
    "Batch": {"signature": "shape_signature", "exempt": set()}})
# host-only metadata goes in the exempt set, not the signature
SIG_LABEL = dict(signature_classes={
    "Batch": {"signature": "shape_signature", "exempt": {"label"}}})

NAN_SOURCES = {
    "gt_on_diagnostic": """
        import numpy as np

        def finalize(relres):
            if np.max(relres) > 1e-8:  # the pta.py:937 bug
                return "fallback"
            return "ok"
    """,
    "float_cast_gt": """
        def check(rel_resid):
            return float(rel_resid) > 1e-8  # the fitter.py bug
    """,
    "builtin_max_fold": """
        def worst_of(rels):
            worst = 0.0
            for rel in rels:
                worst = max(worst, float(rel.relres))
            return worst
    """,
}
NAN_QUIET = """
    import numpy as np

    from {pkg}.fitter import relres_failed

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
"""

FLOW_CRIT = """
    def gls_whiten(r, w):
        return r - w
"""
FLOW_DRIVE = """
    from crit import gls_whiten
    from mid import prep

    def solve(r):
        w = prep(r)
        return gls_whiten(r, w)
"""

SIG_BAD_JAX = """
    import jax

    class Batch:
        def __init__(self, x, scale):
            self.x = x
            self.scale = scale
            self.extra = scale
            self._fns = {}

        def shape_signature(self):
            return (self.x.shape,)

        def compile(self, key):
            def run(v):
                return v * self.scale + self.x
            self._fns[key] = jax.jit(run)

        def dispatch(self, key, v):
            return self._fns[key](v, self.extra)
"""
SIG_BAD_PORT = """
    from pint_tpu_torch import graphs

    class Batch:
        def __init__(self, x, scale):
            self.x = x
            self.scale = scale
            self.extra = scale
            self._fns = {}

        def shape_signature(self):
            return (self.x.shape,)

        def compile(self, key):
            def run(v, x):
                return v * self.scale + x
            self._fns[key] = graphs.Program(run)

        def dispatch(self, key, v):
            return self._fns[key](v, self.x, self.extra)
"""
SIG_QUIET_JAX = """
    import jax

    class Batch:
        def __init__(self, x, scale, label):
            self.x = x
            self.scale = scale
            self.label = label
            self._fns = {}

        def shape_signature(self):
            return (self.x.shape, self.scale)

        def compile(self, key):
            def run(v):
                return v * self.scale + self.x
            self._fns[key] = jax.jit(run)
"""
SIG_QUIET_PORT = """
    from pint_tpu_torch import graphs

    class Batch:
        def __init__(self, x, scale, label):
            self.x = x
            self.scale = scale
            self.label = label
            self._fns = {}

        def shape_signature(self):
            return (self.x.shape, self.scale)

        def compile(self, key):
            def run(v, x, scale):
                return v * scale + x
            self._fns[key] = graphs.Program(run)

        def dispatch(self, key, v):
            return self._fns[key](v, self.x, self.scale)
"""
SIG_MISSING = """
    class Batch:
        def __init__(self):
            self._fns = {}
"""

# name -> (JAX config, port config, JAX sources, port sources,
#          the JAX test's counts of live findings)
CASES = {
    **{f"nan_{k}": ({}, {}, {"m.py": v}, {"m.py": v}, {"nan-guard": 1})
       for k, v in NAN_SOURCES.items()},
    "nan_sanctioned_forms": (
        {}, {}, {"m.py": NAN_QUIET.format(pkg="pint_tpu")},
        {"m.py": NAN_QUIET.format(pkg="pint_tpu_torch")}, {}),
    "f32_flags_cast": (F32, F32, {"crit.py": """
        import jax.numpy as jnp

        def gls_whiten(M, sigma):
            Mw = (M / sigma[:, None]).astype(jnp.float32)
            return Mw
    """}, {"crit.py": """
        import torch

        def gls_whiten(M, sigma):
            Mw = (M / sigma[:, None]).to(torch.float32)
            return Mw
    """}, {"f32-in-f64": 1}),
    "f32_quiet_outside_registry": (F32, F32, {"crit.py": """
        import jax.numpy as jnp

        def gls_whiten(M, sigma):
            return M / sigma[:, None]

        def photon_kernel(x):
            # not registered: deliberately-f32 kernels stay legal
            return x.astype(jnp.float32)
    """}, {"crit.py": """
        import torch

        def gls_whiten(M, sigma):
            return M / sigma[:, None]

        def photon_kernel(x):
            # not registered: deliberately-f32 kernels stay legal
            return x.to(torch.float32)
    """}, {}),
    "host_sync_flags_float": ({}, {}, {"m.py": """
        import jax

        def fit_one(x):
            return float(x) + 1.0

        fit = jax.jit(fit_one)
    """}, {"m.py": """
        from pint_tpu_torch import graphs

        def fit_one(x):
            return float(x) + 1.0

        fit = graphs.Program(fit_one)
    """}, {"host-sync-in-jit": 1}),
    "host_sync_same_name_other_scope": ({}, {}, {"m.py": """
        import jax

        def device_side():
            @jax.jit
            def chi2_of(x):
                return x * x
            return chi2_of

        def host_side(vals):
            def chi2_of(x):
                return float(x) * 2.0
            return [chi2_of(v) for v in vals]
    """}, {"m.py": """
        import torch

        def device_side():
            @torch.func.vmap
            def chi2_of(x):
                return x * x
            return chi2_of

        def host_side(vals):
            def chi2_of(x):
                return float(x) * 2.0
            return [chi2_of(v) for v in vals]
    """}, {}),
    "static_flags_list_literal": ({}, {}, {"m.py": """
        import jax

        def solve(x, opts):
            return x

        solve = jax.jit(solve, static_argnames=("opts",))
        y = solve(1.0, opts=["a", "b"])
    """}, {"m.py": """
        import functools

        def solve(x, opts):
            return x

        solve = functools.lru_cache(solve)
        y = solve(1.0, opts=["a", "b"])
    """}, {"static-unhashable": 1}),
    "static_quiet_on_tuple": ({}, {}, {"m.py": """
        import jax

        def solve(x, opts):
            return x

        solve = jax.jit(solve, static_argnames=("opts",))
        y = solve(1.0, opts=("a", "b"))
    """}, {"m.py": """
        import functools

        def solve(x, opts):
            return x

        solve = functools.lru_cache(solve)
        y = solve(1.0, opts=("a", "b"))
    """}, {}),
    "serve_missing_pad": (SERVE, SERVE, *[{"serve/eng.py": """
        def flush(models, toas_list, bucket):
            pta = PTABatch(models, toas_list)
            return pta
    """}] * 2, {"serve-unpadded-batch": 1}),
    "serve_quiet_with_pad": (SERVE, SERVE, *[{"serve/eng.py": """
        def flush(models, toas_list, bucket):
            pta = PTABatch(models, toas_list, pad_toas=bucket)
            return pta
    """}] * 2, {}),
    "timing_flags_async_window": ({}, {}, {"m.py": """
        import time

        import jax

        def bench():
            def step(x):
                return x * 2.0

            g = jax.jit(step)
            t0 = time.perf_counter()
            out = g(1.0)  # async enqueue; nothing waits for the device
            dt = time.perf_counter() - t0
            return out, dt
    """}, {"m.py": """
        import time

        from pint_tpu_torch import graphs

        def bench(x0):
            def step(x):
                return x * 2.0

            g = graphs.GraphProgram(step, x0)
            t0 = time.perf_counter()
            out = g(x0)  # async replay; nothing waits for the device
            dt = time.perf_counter() - t0
            return out, dt
    """}, {"timing-no-block": 1}),
    "timing_quiet_with_block": ({}, {}, {"m.py": """
        import time

        import jax

        def bench():
            def step(x):
                return x * 2.0

            g = jax.jit(step)
            t0 = time.perf_counter()
            out = jax.block_until_ready(g(1.0))
            dt = time.perf_counter() - t0
            return out, dt
    """}, {"m.py": """
        import time

        from pint_tpu_torch import graphs

        def bench(x0):
            def step(x):
                return x * 2.0

            g = graphs.GraphProgram(step, x0)
            t0 = time.perf_counter()
            out = g(x0).cpu()  # the host pull waits for the replay
            dt = time.perf_counter() - t0
            return out, dt
    """}, {}),
    "timing_obs_clock_window": ({}, {}, {"m.py": """
        import jax

        from pint_tpu.obs import clock as obs_clock

        def bench():
            def step(x):
                return x * 2.0

            g = jax.jit(step)
            t0 = obs_clock.now()
            out = g(1.0)  # async enqueue, nothing waits
            dt = obs_clock.now() - t0
            return out, dt
    """}, {"m.py": """
        from pint_tpu_torch import graphs

        from pint_tpu_torch.obs import clock as obs_clock

        def bench(x0):
            def step(x):
                return x * 2.0

            g = graphs.GraphProgram(step, x0)
            t0 = obs_clock.now()
            out = g(x0)  # async replay, nothing waits
            dt = obs_clock.now() - t0
            return out, dt
    """}, {"timing-no-block": 1}),
    "kernel_bare_pass": (KERNEL, KERNEL, {"kernels/seggram.py": """
        def segment_gram(x, seg, n_seg, block, precision="f64"):
            if precision == "mixed":
                try:
                    return segment_gram_pallas(x, seg, n_seg, block)
                except Exception:
                    pass
            return segment_gram_jnp(x, seg, n_seg, block)
    """, "anchor.py": "x = 1\n"}, {"kernels/seggram.py": """
        def segment_gram(x, seg, n_seg, block, precision="f64"):
            if precision == "mixed":
                try:
                    return segment_gram_cuda(x, seg, n_seg, block)
                except Exception:
                    pass
            return segment_gram_plain(x, seg, n_seg, block)
    """, "anchor.py": "x = 1\n"}, {"kernel-silent-fallback": 1}),
    "kernel_silent_return": (KERNEL, KERNEL, {"kernels/harmonics.py": """
        def harmonic_sums(ph, m):
            try:
                return harmonic_sums_pallas(ph, m)
            except Exception:
                return harmonic_sums_jnp(ph, m)
    """, "anchor.py": "x = 1\n"}, {"kernels/harmonics.py": """
        def harmonic_sums(ph, m):
            try:
                return harmonic_sums_cuda(ph, m)
            except Exception:
                return harmonic_sums_plain(ph, m)
    """, "anchor.py": "x = 1\n"}, {"kernel-silent-fallback": 1}),
    "kernel_quiet_noted_or_reraised": (KERNEL, KERNEL, {
        "kernels/seggram.py": """
        from .fallback import note_pallas_fallback

        def segment_gram(x, seg, n_seg, block, precision="f64"):
            if precision == "mixed":
                try:
                    return segment_gram_pallas(x, seg, n_seg, block)
                except Exception as exc:
                    note_pallas_fallback("seggram.segment_gram", exc)
            return segment_gram_jnp(x, seg, n_seg, block)

        def strict(x, seg, n_seg, block):
            try:
                return segment_gram_pallas(x, seg, n_seg, block)
            except Exception:
                raise
    """, "anchor.py": "x = 1\n"}, {"kernels/seggram.py": """
        from .build import KernelError

        def segment_gram(x, seg, n_seg, block, precision="f64"):
            if precision == "mixed":
                try:
                    return segment_gram_cuda(x, seg, n_seg, block)
                except Exception as exc:
                    raise KernelError("seggram.segment_gram") from exc
            return segment_gram_ref(x, seg, n_seg, block)

        def strict(x, seg, n_seg, block):
            try:
                return segment_gram_cuda(x, seg, n_seg, block)
            except Exception:
                raise
    """, "anchor.py": "x = 1\n"}, {}),
    "kernel_scoped_to_kernel_modules": (KERNEL, KERNEL, {
        "kernels/seggram.py": """
        def _tpu_backend():
            import jax
            try:
                return jax.devices()[0].platform == "tpu"
            except Exception:
                return False
    """, "other.py": """
        def helper(x):
            try:
                return run_pallas(x)
            except Exception:
                pass
    """}, {"kernels/seggram.py": """
        def _hopper():
            import torch
            try:
                return torch.cuda.get_device_capability()[0] >= 9
            except Exception:
                return False
    """, "other.py": """
        def helper(x):
            try:
                return run_cuda(x)
            except Exception:
                pass
    """}, {}),
    "kernel_suppressible": (KERNEL, KERNEL, {"kernels/probe.py": """
        def probe(x):
            try:
                return run_pallas_probe(x)
            # a capability probe: failure IS the answer, not a
            # degradation worth counting
            # pintlint: disable=kernel-silent-fallback
            except Exception:
                return None
    """, "anchor.py": "x = 1\n"}, {"kernels/probe.py": """
        def probe(x):
            try:
                return run_probe_cuda(x)
            # a capability probe: failure IS the answer, not a
            # degradation worth counting
            # pintlint: disable=kernel-silent-fallback
            except Exception:
                return None
    """, "anchor.py": "x = 1\n"}, {}),
    "flow_cross_module_chain": (FLOW_JAX, FLOW_PORT, {
        "kern.py": """
        def whiten_pallas(x):
            return x * 2
    """, "mid.py": """
        from kern import whiten_pallas

        def prep(x):
            y = whiten_pallas(x)
            return y
    """, "crit.py": FLOW_CRIT, "drive.py": FLOW_DRIVE}, {
        "kern.py": """
        def whiten_cuda(x):
            return x * 2
    """, "mid.py": """
        from kern import whiten_cuda

        def prep(x):
            y = whiten_cuda(x)
            return y
    """, "crit.py": FLOW_CRIT, "drive.py": FLOW_DRIVE},
        {"precision-flow": 1}),
    "flow_quiet_when_sanitized_midway": (FLOW_JAX, FLOW_PORT, {
        "kern.py": """
        def whiten_pallas(x):
            return x * 2
    """, "mid.py": """
        import jax.numpy as jnp

        from kern import whiten_pallas

        def prep(x):
            y = whiten_pallas(x)
            return (y * 2).astype(jnp.float64)
    """, "crit.py": FLOW_CRIT, "drive.py": FLOW_DRIVE}, {
        "kern.py": """
        def whiten_cuda(x):
            return x * 2
    """, "mid.py": """
        import torch

        from kern import whiten_cuda

        def prep(x):
            y = whiten_cuda(x)
            return (y * 2).to(torch.float64)
    """, "crit.py": FLOW_CRIT, "drive.py": FLOW_DRIVE}, {}),
    "flow_cast_source_suppressed": (FLOW_JAX, FLOW_PORT, {
        "crit.py": FLOW_CRIT, "drive.py": """
        import jax.numpy as jnp

        from crit import gls_whiten

        def solve(r):
            w = r.astype(jnp.float32)
            return gls_whiten(r, w)  # pintlint: disable=precision-flow
    """}, {"crit.py": FLOW_CRIT, "drive.py": """
        import torch

        from crit import gls_whiten

        def solve(r):
            w = r.to(torch.float32)
            return gls_whiten(r, w)  # pintlint: disable=precision-flow
    """}, {}),
    "signature_flags_uncovered": (SIG, SIG, {"m.py": SIG_BAD_JAX},
                                  {"m.py": SIG_BAD_PORT},
                                  {"signature-incomplete": 2}),
    "signature_quiet_covered_or_exempt": (
        SIG_LABEL, SIG_LABEL,
        {"m.py": SIG_QUIET_JAX,
         "n.py": SIG_QUIET_JAX.replace("return v * self.scale + self.x",
                                       "return v * self.scale + "
                                       "len(self.label)")},
        {"m.py": SIG_QUIET_PORT,
         "n.py": SIG_QUIET_PORT.replace("return v * scale + x",
                                        "return v * scale + "
                                        "len(self.label)")}, {}),
    "signature_missing_method": (SIG, SIG, {"m.py": SIG_MISSING},
                                 {"m.py": SIG_MISSING},
                                 {"signature-incomplete": 1}),
}

TRANSLATED = {  # the ported rule ids: 26 fixtures, as tests/test_pintlint.py
    "nan-guard": 4, "f32-in-f64": 2, "host-sync-in-jit": 2,
    "static-unhashable": 2, "serve-unpadded-batch": 2, "timing-no-block": 3,
    "kernel-silent-fallback": 5, "precision-flow": 3,
    "signature-incomplete": 3,
}


def test_translations_cover_every_ported_fixture():
    """26 fixtures, as many per rule as tests/test_pintlint.py has."""
    prefix = {"nan": "nan-guard", "f32": "f32-in-f64",
              "host": "host-sync-in-jit", "static": "static-unhashable",
              "serve": "serve-unpadded-batch", "timing": "timing-no-block",
              "kernel": "kernel-silent-fallback", "flow": "precision-flow",
              "signature": "signature-incomplete"}
    per = {}
    for name in CASES:
        rule = prefix[name.split("_")[0]]
        per[rule] = per.get(rule, 0) + 1
    assert per == TRANSLATED and len(CASES) == 26


@pytest.mark.parametrize("name", sorted(CASES))
def test_translated_fixture_matches_jax_rule(tmp_path, name):
    """The JAX rule on the JAX fixture and the port's rule on its torch
    translation: the same rule ids at the same lines (suppressed ones
    too), and the JAX test's live counts."""
    jcfg, pcfg, jsrc, psrc, counts = CASES[name]
    jax_f = lint("pint_tpu", tmp_path / "jax", jsrc, **jcfg)
    port_f = lint("pint_tpu_torch", tmp_path / "port", psrc, **pcfg)
    assert hits(port_f, False) == hits(jax_f, False)
    live = {}
    for rule, _, _ in hits(port_f):
        live[rule] = live.get(rule, 0) + 1
    assert live == counts
    if name == "flow_cross_module_chain":
        (msg,) = [f.message for f in port_f if f.rule == "precision-flow"]
        assert "whiten_cuda" in msg and "gls_whiten" in msg
        assert "mid.py" in msg


# -- torch-only fixtures ------------------------------------------------

TORCH_ONLY = {
    "default_dtype_factory_in_critical": (F32, {"crit.py": """
        import torch

        def gls_whiten(M, sigma):
            pad = torch.zeros(M.shape[-1])  # torch's float32 default
            ok = torch.zeros(M.shape[-1], dtype=torch.float64)
            eps = torch.tensor(1e-300)
            idx = torch.arange(M.shape[0])  # int64: fine
            grid = torch.arange(0.0, 1.0, 0.25)
            return M / sigma[:, None] + pad + ok + eps + idx[:, None] + grid
    """}, [("f32-in-f64", 5), ("f32-in-f64", 7), ("f32-in-f64", 9)]),
    "tf32_switches": ({}, {"setup.py": """
        import torch

        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("high")
        torch.set_float32_matmul_precision("highest")
        torch.set_default_dtype(torch.float32)
        torch.set_default_dtype(torch.float64)
    """}, [("f32-in-f64", 4), ("f32-in-f64", 6), ("f32-in-f64", 8)]),
    "flow_sanitized_by_to_float64": (FLOW_PORT, {"kern.py": """
        import torch

        def whiten_cuda(x):
            return x * 2

        def prep_to(x):
            return whiten_cuda(x).to(torch.float64)

        def prep_kw(x):
            return whiten_cuda(x).to(dtype=torch.float64, copy=True)

        def prep_double(x):
            return whiten_cuda(x).double()

        def prep_device(x, dev):
            return whiten_cuda(x).to(dev)
    """, "crit.py": FLOW_CRIT, "drive.py": """
        from crit import gls_whiten
        from kern import prep_double, prep_device, prep_kw, prep_to

        def solve(r, dev):
            a = gls_whiten(r, prep_to(r))
            b = gls_whiten(r, prep_kw(r))
            c = gls_whiten(r, prep_double(r))
            return a + b + c + gls_whiten(r, prep_device(r, dev))
    """}, [("precision-flow", 9)]),
    "leaves_star_at_dispatch": (
        dict(signature_classes={"PTABatch": {
            "signature": "shape_signature", "exempt": set()}}), {"m.py": """
        from pint_tpu_torch import graphs

        class PTABatch:
            def __init__(self, params, prep, batch):
                self.params, self.prep, self.batch = params, prep, batch
                self._fns = {}

            def shape_signature(self):
                return tuple(v.shape for v in (self.params, self.prep,
                                               self.batch))

            def _leaves(self):
                return self.params, self.prep, self.batch

            def _build(self):
                def fit(x0, params, prep, batch):
                    return x0 + params + prep + batch
                return ("gls",), fit

            def gls_fit(self, x0):
                key, fit = self._build()
                self._fns.setdefault(key, graphs.Program(fit))
                return self._fns[key](x0, *self._leaves())
    """}, []),
    "host_method_named_like_closure": ({}, {"m.py": """
        from pint_tpu_torch import graphs

        class Batch:
            def _build(self):
                def fit(x0):
                    return x0 * 2
                return ("k",), fit

            def run(self, x0):
                key, fit = self._build()
                return graphs.Program(fit)(x0)

        class Fleet:
            def fit(self, pipeline=None):
                return bool(pipeline)
    """}, []),
    "cpu_in_vmapped_function": ({}, {"m.py": """
        import torch

        def per_row(r):
            return r.cpu() * 2

        def rows(x):
            return torch.func.vmap(per_row)(x)
    """}, [("host-sync-in-jit", 5)]),
    "item_in_program_and_under_eager": ({}, {"m.py": """
        import torch

        from pint_tpu_torch import graphs

        def body(x):
            n = x.sum().item()
            return x * n

        def count(t):
            return torch.as_tensor(t.sum().item())

        def body_eager(x):
            n = graphs.eager(count, x)
            m = graphs.eager(lambda t: torch.as_tensor(t.max().item()), x)
            return x * n * m

        progs = [graphs.Program(body), graphs.Program(body_eager)]
    """}, [("host-sync-in-jit", 7)]),
    "closure_reads_self_batch": (
        dict(signature_classes={"PTABatch": {
            "signature": "shape_signature", "exempt": set()}}), {"m.py": """
        from pint_tpu_torch import graphs

        class PTABatch:
            def __init__(self, params, batch):
                self.params, self.batch = params, batch
                self._fns = {}

            def shape_signature(self):
                return tuple(v.shape for v in (self.params, self.batch))

            def _leaves(self):
                return self.params, self.batch

            def _build(self):
                def fit(x0, params, batch):
                    # the building batch's TOAs, replayed for every
                    # batch the program is handed to
                    return x0 + params.sum() + self.batch.sum()
                return ("gls",), fit

            def gls_fit(self, x0):
                key, fit = self._build()
                prog = self._fns.setdefault(key, graphs.Program(fit))
                return prog(x0, *self._leaves())
    """}, [("signature-incomplete", 19)]),
    "tensor_in_program_key": ({}, {"m.py": """
        import torch

        class Batch:
            def run(self, x, width):
                key = ("fit", torch.tensor(width))
                return self._fns[key](x)

            def run_ok(self, x, width):
                key = ("fit", int(width), tuple(x.shape), str(x.dtype))
                return self._fns[key](x)

            def lookup(self, cache, x):
                return cache.lookup(("fit", [x.shape[0]]))
    """}, [("static-unhashable", 6), ("static-unhashable", 14)]),
    "try_around_kernel_returns_plain": (KERNEL, {"kernels/fusedgls.py": """
        def fused_block_gls_f32(aug, block):
            try:
                return fused_block_gls_cuda(aug, block)
            except RuntimeError:
                return fused_block_gls_plain(aug, block)
    """, "anchor.py": "x = 1\n"}, [("kernel-silent-fallback", 5)]),
    "handler_reraises_on_one_path_only": (KERNEL, {"kernels/fusedgls.py": """
        def fused_block_gls_f32(aug, block):
            try:
                return fused_block_gls_cuda(aug, block)
            except RuntimeError as e:
                if "out of memory" in str(e):
                    raise
                return fused_block_gls_plain(aug, block)

        def fused_block_gls_oom(aug, block):
            try:
                return fused_block_gls_cuda(aug, block)
            except RuntimeError as e:
                if "out of memory" in str(e):
                    raise MemoryError("K1") from e
                raise
    """, "anchor.py": "x = 1\n"}, [("kernel-silent-fallback", 5)]),
    "reraising_try_beside_plain_branch": (KERNEL, {"kernels/seggram.py": """
        def block_grams_f32(x, block):
            if x.shape[0] < 4096:  # a CUDA tensor can take it
                return block_grams_plain(x, block)
            try:
                return block_grams_cuda(x, block)
            except RuntimeError as e:
                raise RuntimeError("K2 failed") from e

        def block_grams_dev(x, block, precision="mixed"):
            if precision == "mixed":
                try:
                    return block_grams_cuda(x, block)
                except RuntimeError:
                    raise
            return block_grams_plain(x, block)
    """, "anchor.py": "x = 1\n"}, [("kernel-silent-fallback", 4)]),
    "plain_branch_without_device_test":(KERNEL, {"kernels/seggram.py": """
        KERNEL_MIN_ROWS = 4096

        def block_grams_f32(x, block):
            if x.shape[0] < 4096:  # a CUDA tensor can take it
                return block_grams_plain(x, block)
            return block_grams_cuda(x, block)

        def block_grams_dev(x, block):
            if x.device.type == "cpu":
                return block_grams_plain(x, block)
            return block_grams_cuda(x, block)

        def block_grams_min(x, block, precision="f64"):
            if precision == "f64":
                return block_grams_ref(x, block)
            if x.is_cuda and x.shape[0] >= KERNEL_MIN_ROWS:
                return block_grams_cuda(x, block)
            return block_grams_plain(x, block)
    """, "anchor.py": "x = 1\n"}, [("kernel-silent-fallback", 6)]),
    "graph_program_timed_without_sync": ({}, {"m.py": """
        import time

        import torch

        from pint_tpu_torch import fitter, graphs

        def bench(fit, x0, data):
            prog = graphs.GraphProgram(fit, x0, *data)
            t0 = time.perf_counter()
            out = prog(x0, *data)
            dt = time.perf_counter() - t0
            return out, dt

        def bench_aot(fit, x0, data):
            prog = fitter.aot_backend_compile(fit, x0, *data)["compiled"]
            t0 = time.perf_counter()
            out = prog(x0, *data)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            return out, dt

        def bench_kernel(aug, block, graph):
            t0 = time.perf_counter()
            fused_block_gls_cuda(aug, block)
            graph.replay()
            return time.perf_counter() - t0
    """}, [("timing-no-block", 11), ("timing-no-block", 25)]),
}


@pytest.mark.parametrize("name", sorted(TORCH_ONLY))
def test_torch_only_fixture(tmp_path, name):
    """Each torch-only hazard is flagged at its line, each sanctioned
    torch form stays quiet."""
    cfg, sources, expected = TORCH_ONLY[name]
    found = [(rule, line) for rule, _, line in hits(
        lint("pint_tpu_torch", tmp_path, sources, **cfg))]
    assert found == expected


def test_jax_rules_misfire_where_counterparts_do_not(tmp_path):
    """The JAX rules read ``*self._leaves()`` as an attribute and
    resolve ``fit`` through a class body to a host method; the port's
    do neither (the torch-only fixtures above stay quiet there)."""
    sig = dict(signature_classes={"PTABatch": {
        "signature": "shape_signature", "exempt": set()}})
    src = TORCH_ONLY["leaves_star_at_dispatch"][1]
    jax_f = lint("pint_tpu", tmp_path / "a", src, **sig)
    assert [f.rule for f in jax_f if f.rule in RULES] == [
        "signature-incomplete"]
    src = TORCH_ONLY["host_method_named_like_closure"][1]
    jax_f = lint("pint_tpu", tmp_path / "b",
                 {"m.py": src["m.py"].replace("graphs.Program(fit)",
                                              "jax.jit(fit)")})
    assert [f.rule for f in jax_f if f.rule in RULES] == ["host-sync-in-jit"]


# -- hazards seeded into copies of the port's modules -----------------

def _seeded(tmp_path, rel, old, new):
    """Lint ``rel`` of the port, and a copy with ``old`` replaced by
    ``new``, under the port's registries (the copies sit at the same
    path below tmp_path, with an anchor file beside the package)."""
    from pint_tpu_torch.analysis import LintConfig, run, unsuppressed

    src = open(os.path.join(PKG, rel)).read()
    assert src.count(old) == 1, old
    out = []
    for tag, text in (("clean", src), ("seeded", src.replace(old, new))):
        root = tmp_path / tag
        p = root / "pint_tpu_torch" / rel
        p.parent.mkdir(parents=True)
        p.write_text(text)
        (root / "anchor.py").write_text("x = 1\n")
        fs = unsuppressed(run([str(root)], config=LintConfig.default(),
                              whole_program=False))
        out.append([(f.rule, f.line) for f in fs])
    return out


def _line_of(rel, text):
    src = open(os.path.join(PKG, rel)).read()
    return src[:src.index(text)].count("\n") + 1


def test_seeded_default_dtype_factory_in_gls_whiten(tmp_path):
    """``torch.zeros(n)`` in fitter.gls_whiten: f32-in-f64."""
    old = "    Mw = Mfull / sigma[..., None]\n"
    src = open(os.path.join(PKG, "fitter.py")).read()
    assert old in src[src.index("def gls_whiten"):][:600]
    clean, seeded = _seeded(tmp_path, "fitter.py", old,
                            old + "    _ = torch.zeros(Mw.shape[-1])\n")
    assert clean == []
    assert seeded == [("f32-in-f64", _line_of("fitter.py", old) + 1)]


def test_seeded_item_in_packed_fit(tmp_path):
    """``.item()`` in the packed program's ``fit``: host-sync-in-jit (the
    program reaches ``graphs.Program`` through ``_dispatch``'s
    parameter and the builders' returned tuples)."""
    rel = os.path.join("parallel", "pta.py")
    old = "            sl = _slot_machinery(pack, (R, W), params, prep)\n"
    clean, seeded = _seeded(tmp_path, rel, old,
                            old + "            _n = x0.sum().item()\n")
    assert clean == []
    assert seeded == [("host-sync-in-jit", _line_of(rel, old) + 1)]


def test_seeded_handler_around_fused_block_gls_cuda(tmp_path):
    """A handler that falls back to the plain Gram around
    ``fused_block_gls_cuda`` in kernels/fusedgls.py:
    kernel-silent-fallback."""
    rel = os.path.join("kernels", "fusedgls.py")
    old = "    return fused_block_gls_cuda(aug.contiguous(), block)\n"
    new = ("    try:\n"
           "        return fused_block_gls_cuda(aug.contiguous(), block)\n"
           "    except RuntimeError:\n"
           "        return fused_block_gls_plain(aug, block)\n")
    clean, seeded = _seeded(tmp_path, rel, old, new)
    assert clean == []
    assert seeded == [("kernel-silent-fallback", _line_of(rel, old) + 2)]


def test_device_code_index_of_the_packed_program():
    """``rules_retrace.device_code_index`` (what chip_smoke.py's
    ``[lint]`` holds the card's syncs against): the builders' fit
    closures, the vmap'd lambdas and the packed program's matvec are
    device code; ``PTAFleet.fit`` and the finalize are not."""
    from pint_tpu_torch.analysis.rules_retrace import device_code_index

    path = os.path.join(PKG, "parallel", "pta.py")
    spans = device_code_index([path])[path]
    src = open(path).read()
    tree = ast.parse(src)

    def inside(line):
        return any(a <= line <= b for a, b, _ in spans)

    def defs(cls, meth):
        c = next(n for n in tree.body
                 if isinstance(n, ast.ClassDef) and n.name == cls)
        return next(n for n in c.body
                    if isinstance(n, ast.FunctionDef) and n.name == meth)

    packed = defs("PTABatch", "_build_gls_packed")
    inner = {n.name: n for n in ast.walk(packed)
             if isinstance(n, ast.FunctionDef)}
    assert inside(inner["fit"].lineno) and inside(inner["matvec"].lineno)
    lams = [n.lineno for n in ast.walk(defs("PTABatch", "_build_gls"))
            if isinstance(n, ast.Lambda)]
    assert lams and all(inside(ln) for ln in lams)
    assert not inside(defs("PTAFleet", "fit").lineno)
    assert not inside(defs("PTABatch", "_finalize_gls").lineno)
    assert not inside(defs("PTABatch", "_dispatch").lineno)


def test_packed_program_converts_no_host_scalar(tmp_path):
    """The packed GLS program builds its slot machinery inside the
    captured ``fit`` from the layout's host scalars, resolved before the
    build (``pta._slot_pack``): Python ints whatever the pack's own
    types. Converting them inside the program, as the port once did,
    is a host-sync-in-jit finding."""
    import numpy as np

    from pint_tpu_torch.parallel.pta import _slot_pack

    lay = _slot_pack({"n_slots": np.int64(3), "quantum": np.int64(32),
                      "slot_keys": ["DM", "F0"], "width": 96})
    assert lay == {"n_slots": 3, "quantum": 32,
                   "slot_keys": frozenset({"DM", "F0"})}
    assert type(lay["n_slots"]) is int and type(lay["quantum"]) is int
    rel = os.path.join("parallel", "pta.py")
    old = '    S = pack["n_slots"]\n'
    clean, seeded = _seeded(tmp_path, rel, old,
                            '    S = int(pack["n_slots"])\n')
    assert clean == []
    assert seeded == [("host-sync-in-jit", _line_of(rel, old))]


def test_sync_class_sees_a_cross_file_callee_of_a_program():
    """chip_smoke.py's ``[lint]`` classes each sync the card reports by
    its port frames against the device-code index: a sync in a fitter.py
    function (not device code in its own file) reached from the packed
    program's ``fit`` is device code through ``fit``'s frame; under
    ``graphs.eager`` it is an eager piece; from the finalize, host code."""
    import chip_smoke
    from pint_tpu_torch.analysis.rules_retrace import device_code_index

    pta = os.path.join(PKG, "parallel", "pta.py")
    fit_py = os.path.join(PKG, "fitter.py")
    graphs_py = os.path.join(PKG, "graphs.py")
    spans = device_code_index([pta, fit_py])

    def func(path, name, within=None):
        tree = ast.parse(open(path).read())
        if within is not None:
            tree = next(n for n in ast.walk(tree)
                        if isinstance(n, ast.FunctionDef)
                        and n.name == within)
        return next(n for n in ast.walk(tree)
                    if isinstance(n, ast.FunctionDef) and n.name == name)

    step = func(pta, "one_step", within="_build_gls_packed")
    call = next(n for n in ast.walk(step) if isinstance(n, ast.Call)
                and getattr(n.func, "id", "") == "seg_gls_eigh_refine")
    refine = func(fit_py, "seg_gls_eigh_refine")
    gls_fit = func(pta, "gls_fit")
    eager = func(graphs_py, "eager")
    finalize = func(pta, "_finalize_gls")
    host = (pta, gls_fit.lineno + 1, "gls_fit")
    in_fit = (pta, call.lineno, "one_step")  # the packed fit's step
    callee = (fit_py, refine.body[-1].lineno, "seg_gls_eigh_refine")
    assert not any(a <= callee[1] <= b for a, b, _ in spans.get(fit_py, ()))
    assert chip_smoke.sync_class([host, in_fit, callee], spans) == (
        "device code", in_fit)
    piece = (graphs_py, eager.body[-1].lineno, "eager")
    assert chip_smoke.sync_class([host, in_fit, callee, piece], spans) == (
        "eager piece", piece)
    pull = (pta, finalize.body[-1].lineno, "_finalize_gls")
    assert chip_smoke.sync_class([host, pull], spans) == ("host code", pull)
    assert chip_smoke.sync_class([], spans) == ("host code", None)
