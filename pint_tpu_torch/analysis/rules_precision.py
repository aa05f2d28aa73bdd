"""Precision rule family.

- nan-guard: NaN-unsafe failure guards on convergence diagnostics.
- f32-in-f64: float32 introduced inside an f64-critical function —
  a float32 dtype, ``.float()``/``.half()``/``.bfloat16()``, or a torch
  factory left at torch's float32 default dtype — and, anywhere in the
  package, a switch that turns TF32 back on or makes float32 the
  default dtype.
"""

from __future__ import annotations

import ast
import re

from .core import Rule, call_name, dotted_name, mentions, register


@register
class NanGuardRule(Rule):
    """``max(relres) > tol`` is False when relres is NaN, so the very
    failure the diagnostic exists to signal (an f32 overflow / eigh
    NaN propagating through refinement) silently passes the guard.
    The sanctioned forms are ``fitter.relres_failed(...)`` or
    ``not np.all(x <= tol)`` — NaN fails a ``<=`` comparison, so NaN
    means failure. Python's builtin ``max`` is equally unsafe:
    ``max(0.0, nan)`` is 0.0 (comparison False keeps the first arg), so
    folding a diagnostic through ``max`` erases the NaN;
    ``np.maximum`` / ``torch.maximum`` propagate it.
    """

    id = "nan-guard"
    family = "precision"
    rationale = ("'diag > tol' and builtin max() both treat NaN as "
                 "success; use relres_failed()/not np.all(diag <= tol)")

    def check_file(self, ctx):
        diag = re.compile(ctx.config.nan_diag_pattern)
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Compare):
                for op, comparator in zip(node.ops, node.comparators):
                    if not isinstance(op, (ast.Gt, ast.GtE)):
                        continue
                    if mentions(node.left, diag):
                        ctx.report(self.id, node,
                                   "NaN-unsafe failure guard on a "
                                   "convergence diagnostic ('> tol' is "
                                   "False under NaN); use "
                                   "fitter.relres_failed() or "
                                   "'not np.all(x <= tol)'")
                        break
            elif isinstance(node, ast.Call):
                if (call_name(node) == "max" and len(node.args) >= 2
                        and any(mentions(a, diag) for a in node.args)):
                    ctx.report(self.id, node,
                               "builtin max() on a convergence "
                               "diagnostic returns the non-NaN "
                               "argument (max(0.0, nan) == 0.0); use "
                               "np.maximum, which propagates NaN")


# dtype attributes that are float32 or narrower on any module (torch.,
# np., a fixture's jnp.)
F32_DTYPE_ATTRS = frozenset({"float32", "float16", "bfloat16"})
# torch's own short names for them
F32_TORCH_ALIASES = frozenset({"torch.float", "torch.half"})
# tensor methods that cast to them
F32_CAST_METHODS = frozenset({"float", "half", "bfloat16"})
F32_STRINGS = frozenset({"float32", "f32"})

# torch factories that take torch's default dtype (float32) when given
# no dtype= and no tensor to copy
FLOAT_FACTORIES = frozenset({
    "zeros", "ones", "empty", "rand", "randn", "linspace", "logspace",
    "eye",
})


def f32_marker(node):
    """A description of the float32 ``node`` introduces by itself, or
    None: a float32 dtype (``torch.float32``, ``torch.float``, ...), a
    float32 cast method call (``x.float()``), or the string
    ``"float32"``/``"f32"``."""
    if isinstance(node, ast.Attribute):
        if node.attr in F32_DTYPE_ATTRS:
            return dotted_name(node) or node.attr
        if dotted_name(node) in F32_TORCH_ALIASES:
            return dotted_name(node)
    elif isinstance(node, ast.Call):
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in F32_CAST_METHODS
                and not node.args and not node.keywords
                and dotted_name(node.func) not in F32_TORCH_ALIASES):
            return f".{node.func.attr}()"
    elif isinstance(node, ast.Constant) and node.value in F32_STRINGS:
        return repr(node.value)
    return None


def _float_literal(node):
    if isinstance(node, ast.UnaryOp):
        return _float_literal(node.operand)
    if isinstance(node, ast.Constant):
        return isinstance(node.value, float)
    if isinstance(node, (ast.List, ast.Tuple)):
        return any(_float_literal(e) for e in node.elts)
    return False


def default_dtype_factory(node):
    """A description when ``node`` is a torch factory call that takes
    torch's float32 default dtype: ``torch.zeros/ones/empty/rand/randn/
    linspace/logspace/eye`` with no ``dtype=``, ``torch.full`` of a
    float fill, ``torch.tensor``/``torch.as_tensor`` of a Python float
    literal, ``torch.arange`` with a float argument; else None."""
    if not isinstance(node, ast.Call):
        return None
    name = call_name(node) or ""
    if not name.startswith("torch.") or name.count(".") != 1:
        return None
    if any(kw.arg == "dtype" for kw in node.keywords):
        return None
    tail = name.split(".", 1)[1]
    if tail in FLOAT_FACTORIES:
        hit = True
    elif tail == "full":
        hit = len(node.args) >= 2 and not (
            isinstance(node.args[1], ast.Constant)
            and isinstance(node.args[1].value, (bool, int)))
    elif tail in ("tensor", "as_tensor"):
        hit = bool(node.args) and _float_literal(node.args[0])
    elif tail == "arange":
        hit = any(_float_literal(a) for a in node.args)
    else:
        hit = False
    return f"{name}() at the float32 default dtype" if hit else None


def _tf32_switch(node):
    """A description when ``node`` turns TF32 back on or makes a
    float32-or-narrower dtype torch's default, else None."""
    if isinstance(node, ast.Assign):
        if (isinstance(node.value, ast.Constant)
                and node.value.value is True
                and any(isinstance(t, ast.Attribute)
                        and t.attr == "allow_tf32"
                        for t in node.targets)):
            return "allow_tf32 = True turns TF32 matmuls back on"
    elif isinstance(node, ast.Call):
        tail = (call_name(node) or "").rsplit(".", 1)[-1]
        if tail == "set_float32_matmul_precision":
            arg = node.args[0] if node.args else None
            if not (isinstance(arg, ast.Constant)
                    and arg.value == "highest"):
                return ("set_float32_matmul_precision with anything "
                        "but 'highest' turns TF32 matmuls back on")
        elif tail == "set_default_dtype" and node.args:
            if f32_marker(node.args[0]) is not None:
                return ("set_default_dtype makes a float32 dtype the "
                        "default of every factory in the process")
    return None


@register
class F32InF64Rule(Rule):
    """The paper's contract is f64-critical residuals: the whitening /
    normal-equation chain must stay f64 end to end. The ONLY sanctioned
    f32 is the explicitly-guarded mixed-precision Gram (gls_gram, the
    kernels' f32 passes), which is registry-excluded. Everywhere else
    in a registered f64-critical function, a float32 dtype, a
    ``.float()`` cast, or a torch factory left at torch's float32
    default (``torch.zeros(n)``) silently costs ~9 decimal digits on
    values (TOAs) that need ~16. TF32 matmuls (off in the package's
    ``__init__``) and a float32 default dtype would do the same to
    every product and factory of the process, so a switch of either
    is flagged anywhere."""

    id = "f32-in-f64"
    family = "precision"
    rationale = ("float32 introduced inside a function registered as "
                 "f64-critical loses the precision the residual "
                 "contract requires")

    def _critical_names(self, ctx):
        for suffix, names in ctx.config.f64_critical.items():
            if ctx.path.endswith(suffix) or ctx.rel.endswith(suffix):
                return names
        return None

    def check_file(self, ctx):
        for node in ast.walk(ctx.tree):
            what = _tf32_switch(node)
            if what is not None:
                ctx.report(self.id, node,
                           f"{what}: the residual chain's f64 products "
                           f"would run at ~10 bits of mantissa")
        names = self._critical_names(ctx)
        if names is None:
            return
        whole_module = "*" in names
        seen = set()  # nested defs are walked twice; report once
        for func in ast.walk(ctx.tree):
            if not isinstance(func, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            if not whole_module and func.name not in names:
                continue
            for node in ast.walk(func):
                what = f32_marker(node) or default_dtype_factory(node)
                if what is None:
                    continue
                key = (node.lineno, node.col_offset)
                if key in seen:
                    continue
                seen.add(key)
                ctx.report(
                    self.id, node,
                    f"float32 introduced inside f64-critical "
                    f"function '{func.name}' ({what}); the residual "
                    f"chain requires f64 (mixed precision belongs in "
                    f"the guarded gls_gram path only)")
