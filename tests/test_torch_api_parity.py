"""Every public name and parameter of the JAX package has a counterpart
in the port, file against file.

Read with ``ast`` only (neither package is imported): for each
``pint_tpu/**/*.py``, the file of the same path in ``pint_tpu_torch/``
must exist, define each public top-level function and class of the
reference (as a function or a class again), each public method and
``__init__`` of those classes in the class's own body, and accept each
parameter name of the reference, ``*args`` and ``**kwargs`` included. A
counterpart's ``**kwargs`` does not stand in for a named parameter: the
name must be spelt. The allow-lists below are the only departures, each
with its reason; an entry that no longer matches a gap fails
``test_allow_lists_hold_only_live_entries``.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_api_parity.py -q
"""

import ast
import functools
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
REF = ROOT / "pint_tpu"
PORT = ROOT / "pint_tpu_torch"

# reference files with no file of the same path in the port
FILES = {
    "kernels/fallback.py": "a kernel's fallback to another path; the port "
                           "launches its hand-written kernel or raises",
    "native/__init__.py": "the C++ host library's loader, a package in the "
                          "reference and the module native.py in the port",
}

# the kernels' jnp references and Pallas entries: their counterparts are
# the port's plain, reference and CUDA functions, named here
RENAMED = {
    ("kernels/fusedgls.py", "fused_block_gls_jnp"): "fused_block_gls_plain",
    ("kernels/fusedgls.py", "fused_segment_gls_jnp"): "fused_segment_gls_ref",
    ("kernels/fusedgls.py", "fused_block_gls_pallas"): "fused_block_gls_cuda",
    ("kernels/fusedgls.py", "fused_segment_gls_pallas"):
        "fused_segment_gls_f32",
    ("kernels/fusedgls.py", "fused_segment_gls_f32_jnp"):
        "fused_segment_gls_f32",
    ("kernels/harmonics.py", "harmonic_sums_jnp"): "harmonic_sums_ref",
    ("kernels/harmonics.py", "harmonic_sums_pallas"): "harmonic_sums_cuda",
    ("kernels/incremental.py", "delta_gram_jnp"): "delta_gram_ref",
    ("kernels/incremental.py", "delta_gram_pallas"): "delta_gram_cuda",
    ("kernels/incremental.py", "delta_gram_f32_jnp"): "delta_gram_f32",
    ("kernels/paircorr.py", "pair_products_jnp"): "pair_products_ref",
    ("kernels/paircorr.py", "pair_products_pallas"): "pair_products_cuda",
    ("kernels/seggram.py", "block_grams_jnp"): "block_grams_plain",
    ("kernels/seggram.py", "segment_gram_jnp"): "segment_gram_ref",
    ("kernels/seggram.py", "block_grams_pallas"): "block_grams_cuda",
    ("kernels/seggram.py", "segment_gram_pallas"): "segment_gram_f32",
}

# reference names with no counterpart
ABSENT = {
    ("models/timing_model.py", "device_put_staged"):
        "JAX's one batched device_put of a pytree staged on the host CPU "
        "backend; the port moves its packed tree with host_to_device",
    ("templates/lcprimitives.py", "jax_sigmoid"):
        "a stable sigmoid for jax.numpy; the port calls torch.sigmoid",
}

_INTERPRET = ("Pallas's interpret mode; a CUDA kernel has none, and the "
              "port's entry points run the plain version on a CPU tensor")
# reference parameters the counterpart does not take
DROPPED = {
    ("gw/correlate.py", "correlation_sweep", "interpret"): _INTERPRET,
    ("gw/correlate.py", "correlation_matrix", "interpret"): _INTERPRET,
    ("gw/hd.py", "optimal_statistic", "interpret"): _INTERPRET,
    ("gw/hd.py", "scramble_null", "interpret"): _INTERPRET,
    ("kernels/fusedgls.py", "fused_segment_gls", "interpret"): _INTERPRET,
    ("kernels/incremental.py", "delta_gram", "interpret"): _INTERPRET,
    ("kernels/incremental.py", "IncrementalNormal.append", "interpret"):
        _INTERPRET,
    ("kernels/paircorr.py", "pair_products", "interpret"): _INTERPRET,
    ("parallel/pta.py", "PTAFleet.gw_stage", "interpret"): _INTERPRET,
    ("obs/costmodel.py", "executable_cost", "compiled"):
        "XLA's compiled executable; the port's takes the built program, "
        "as executable_cost(program)",
}


def _public(name):
    return not name.startswith("_")


_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)


def _defs(nodes):
    """The definitions among ``nodes``, and under their if/try blocks."""
    for n in nodes:
        if isinstance(n, _DEFS):
            yield n
        elif isinstance(n, (ast.If, ast.Try, ast.ExceptHandler)):
            yield from _defs(ast.iter_child_nodes(n))


@functools.lru_cache(maxsize=None)
def top_level(path):
    """{name: FunctionDef | ClassDef} of a file's top level."""
    out = {}
    for n in _defs(ast.parse(Path(path).read_text()).body):
        out.setdefault(n.name, n)
    return out


def methods(cls):
    return {n.name: n for n in _defs(cls.body)
            if not isinstance(n, ast.ClassDef)}


def param_names(fn):
    """Each parameter of ``fn``: its name, ``*name`` or ``**name``."""
    a = fn.args
    out = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg is not None:
        out.append("*" + a.vararg.arg)
    if a.kwarg is not None:
        out.append("**" + a.kwarg.arg)
    return out


def accepts(fn, name):
    a = fn.args
    if name.startswith("**"):
        return a.kwarg is not None
    if name.startswith("*"):
        return a.vararg is not None
    return name in {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs}


def gaps(rel):
    """The reference file ``rel``'s names and parameters that the port's
    file of the same path lacks: ("file", rel), ("name", rel, qualname)
    and ("param", rel, qualname, parameter) tuples."""
    port = PORT / rel
    if not port.exists():
        return [("file", rel)]
    ref_defs, port_defs = top_level(REF / rel), top_level(port)
    out = []

    def check_params(qual, fn, counterpart):
        out.extend(("param", rel, qual, p) for p in param_names(fn)
                   if not accepts(counterpart, p))

    for name, node in ref_defs.items():
        if not _public(name):
            continue
        twin = port_defs.get(name)
        if twin is None or isinstance(twin, ast.ClassDef) != isinstance(
                node, ast.ClassDef):
            out.append(("name", rel, name))
        elif not isinstance(node, ast.ClassDef):
            check_params(name, node, twin)
        else:
            twin_methods = methods(twin)
            for m, fn in methods(node).items():
                if not (_public(m) or m == "__init__"):
                    continue
                if m not in twin_methods:
                    out.append(("name", rel, f"{name}.{m}"))
                else:
                    check_params(f"{name}.{m}", fn, twin_methods[m])
    return out


def allowed(gap):
    if gap[0] == "file":
        return gap[1] in FILES
    if gap[0] == "name":
        return gap[1:] in RENAMED or gap[1:] in ABSENT
    return gap[1:] in DROPPED


REF_FILES = sorted(p.relative_to(REF).as_posix() for p in REF.rglob("*.py"))


def test_reference_tree_is_read():
    assert len(REF_FILES) > 150
    assert {"models/spindown.py", "store/deltas.py",
            "models/timing_model.py"} <= set(REF_FILES)


@pytest.mark.parametrize("rel", REF_FILES)
def test_file_has_every_public_name_and_parameter(rel):
    if rel in FILES:
        assert not (PORT / rel).exists(), rel
        if rel == "native/__init__.py":
            assert (PORT / "native.py").exists()
        return
    missing = [g for g in gaps(rel) if not allowed(g)]
    assert missing == [], missing


def test_allow_lists_hold_only_live_entries():
    """Each allow-list entry matches a gap, and each renamed kernel name
    has its port counterpart in the same file."""
    found = {g for rel in REF_FILES for g in gaps(rel)}
    stale = ([("file", f) for f in FILES if ("file", f) not in found]
             + [k for k in list(RENAMED) + list(ABSENT)
                if ("name", *k) not in found]
             + [k for k in DROPPED if ("param", *k) not in found])
    assert stale == []
    for (rel, _), twin in RENAMED.items():
        assert twin in top_level(PORT / rel), (rel, twin)
    reasons = [*FILES.values(), *ABSENT.values(), *DROPPED.values()]
    assert all(len(r) > 20 for r in reasons)
