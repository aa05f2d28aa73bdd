"""Program cost model: recorded FLOP/byte counts + roofline MFU (the
JAX package's ``obs/costmodel.py``).

This is the *judging* half of the telemetry the AOT build/capture split
already produces: :func:`executable_cost` reads the FLOP and byte counts
a program carries from its build, and :func:`attribute` turns (flops,
bytes, wall) into the roofline verdict — arithmetic intensity, the
ceiling ``min(peak_flops, intensity * peak_bandwidth)``, compute- vs
memory-bound, MFU against peak and against the attributed ceiling.

Torch has no counterpart of XLA's cost analysis, so a program's counts
are not read from a compiled executable: the code that builds a program
computes them from the batch's shapes (:func:`normal_equations_cost`,
the formula of every fit program) and records them on the program as
``.cost``. The counts
describe the work the fit asks for, not the work one implementation
does: the hand kernel, its plain version and the f64 reference are held
to one yardstick, so a faster kernel never changes the count.

The per-platform peak table lives HERE, so every consumer — fleet
execute spans, the GW sweep, the CLI — shares one denominator. A
platform is ``"cpu"`` or a card's name as ``torch.cuda.get_device_name``
gives it. The table never returns None: a card it does not record gets
the nominal fallback spec (flagged ``nominal=True``) rather than nulling
every MFU figure.

Env overrides (floats, applied to every platform; the JAX package's
names, so one setting drives both packages):

- ``PINT_TPU_PEAK_FLOPS``       — peak FLOP/s denominator
- ``PINT_TPU_PEAK_BYTES_PER_S`` — peak memory bandwidth (bytes/s)
"""

from __future__ import annotations

import os
import threading

H100_SXM = "NVIDIA H100 80GB HBM3"


def _cpu_peak_flops():
    """Nominal vector-f64 CPU peak: cores x 2.5 GHz x 16 f64
    FLOP/cycle (one AVX-512 FMA per cycle, or two AVX2 FMAs — the
    same number either way). An order-of-magnitude denominator so CPU
    runs report a real MFU instead of null."""
    return (os.cpu_count() or 1) * 2.5e9 * 16


# Per-platform peak FLOP/s and memory bandwidth. CPU: the nominal
# vector peak above and a nominal ~50 GB/s DDR stream bandwidth per
# socket. H100 SXM: NVIDIA's data-sheet figures for the card at 700 W,
# 67 TFLOP/s of FP32 outside the tensor cores (the FFMA rate the hand
# kernels accumulate at; TF32 stays off) and 3.35 TB/s of HBM3.
DEVICE_SPECS = {
    "cpu": {"peak_flops": _cpu_peak_flops(),
            "peak_bytes_per_s": 5.0e10},
    H100_SXM: {"peak_flops": 6.7e13, "peak_bytes_per_s": 3.35e12},
}

# Fallback for platforms not in the table: MFU must degrade to a
# clearly-nominal number, never to None (null MFU is unactionable).
NOMINAL_SPEC = {"peak_flops": 1.0e12, "peak_bytes_per_s": 1.0e11,
                "nominal": True}


def _env_float(name):
    val = os.environ.get(name)
    if val:
        try:
            return float(val)
        except ValueError:
            pass  # fall through to the table rather than die mid-run
    return None


def device_spec(platform=None):
    """The peak-rate spec dict for ``platform`` (default: the current
    card, else the CPU), env overrides applied. Always returns both
    rates."""
    if platform is None:
        platform = default_platform()
    spec = dict(DEVICE_SPECS.get(platform, NOMINAL_SPEC))
    env_fl = _env_float("PINT_TPU_PEAK_FLOPS")
    if env_fl is not None:
        spec["peak_flops"] = env_fl
    env_bw = _env_float("PINT_TPU_PEAK_BYTES_PER_S")
    if env_bw is not None:
        spec["peak_bytes_per_s"] = env_bw
    spec["platform"] = platform
    return spec


def platform_of(device):
    """The platform of a torch device: ``"cpu"``, or the card's name
    (``torch.cuda.get_device_name``), which keys its row of
    :data:`DEVICE_SPECS`."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    return torch.cuda.get_device_name(device)


def default_platform():
    """The current card's name when torch sees one, else ``"cpu"``."""
    try:
        import torch

        if torch.cuda.is_available():
            return torch.cuda.get_device_name()
    except Exception:
        pass
    return "cpu"


def peak_flops(platform=None):
    return device_spec(platform)["peak_flops"]


def peak_bytes_per_s(platform=None):
    return device_spec(platform)["peak_bytes_per_s"]


def mfu_pct(flops, wall_s, platform=None):
    """Model FLOPs utilization [%] against the platform peak. None
    only when flops/wall are unknown — the peak itself always
    resolves (table, env override, or nominal fallback)."""
    if not flops or not wall_s:
        return None
    return round(100.0 * flops / wall_s / peak_flops(platform), 4)


def arithmetic_intensity(flops, bytes_accessed):
    """FLOPs per byte moved, or None when either input is unknown."""
    if not flops or not bytes_accessed:
        return None
    return flops / bytes_accessed


def roofline_ceiling_flops(intensity, platform=None):
    """Attainable FLOP/s under the naive roofline: the compute peak,
    capped by bandwidth x intensity when the program is memory-bound."""
    spec = device_spec(platform)
    if not intensity:
        return spec["peak_flops"]
    return min(spec["peak_flops"],
               intensity * spec["peak_bytes_per_s"])


def attribute(flops, bytes_accessed, wall_s=None, platform=None):
    """Full roofline attribution of one executed program.

    Returns a JSON-safe dict: flops / bytes_accessed echoed back,
    ``intensity_flops_per_byte``, the per-platform peaks, the
    attributed ``roofline_ceiling_flops``, ``bound`` ("compute" |
    "memory" | None when intensity is unknown), and — when a wall
    time is given — ``achieved_flops_per_s``, ``mfu_pct`` (vs peak)
    and ``roofline_pct`` (vs the attributed ceiling, i.e. how much of
    the *attainable* rate the program reached). ``nominal`` is present
    (True) only when the platform has no row of its own."""
    spec = device_spec(platform)
    intensity = arithmetic_intensity(flops, bytes_accessed)
    ceiling = roofline_ceiling_flops(intensity, platform=spec["platform"])
    bound = None
    if intensity is not None:
        knee = spec["peak_flops"] / spec["peak_bytes_per_s"]
        bound = "compute" if intensity >= knee else "memory"
    out = {
        "flops": flops,
        "bytes_accessed": bytes_accessed,
        "intensity_flops_per_byte": (round(intensity, 4)
                                     if intensity is not None else None),
        "peak_flops": spec["peak_flops"],
        "peak_bytes_per_s": spec["peak_bytes_per_s"],
        "roofline_ceiling_flops": ceiling,
        "bound": bound,
        "platform": spec["platform"],
    }
    if spec.get("nominal"):
        out["nominal"] = True
    if wall_s and flops:
        achieved = flops / wall_s
        out["achieved_flops_per_s"] = achieved
        out["mfu_pct"] = round(100.0 * achieved / spec["peak_flops"], 4)
        out["roofline_pct"] = (round(100.0 * achieved / ceiling, 4)
                               if ceiling else None)
    else:
        out["achieved_flops_per_s"] = None
        out["mfu_pct"] = None
        out["roofline_pct"] = None
    return out


# Symmetric eigendecomposition with vectors (the symmetric QR
# algorithm): ~9 k^3 FLOPs (Golub & Van Loan, Matrix Computations,
# section 8.3).
EIGH_FLOPS_PER_K3 = 9


def normal_equations_cost(n_rows, n_lanes, k, maxiter, in_bytes,
                          out_bytes):
    """The count of one fit program, from its batch's shapes.

    A fit program builds and solves the normal equations of ``n_lanes``
    lanes (pulsars, or segments of packed rows) whose ``k`` columns run
    over ``n_rows`` padded TOA rows in all, ``maxiter`` times. Per
    iteration it counts, summed over the lanes:

    - the Gram MᵀM of the whitened design, 2 n k² (a multiply and an
      add per entry, the whole square);
    - the right-hand side Mᵀr, 2 n k, and χ² = rᵀr, 2 n;
    - the solve, one symmetric eigendecomposition of each lane's k x k
      matrix, :data:`EIGH_FLOPS_PER_K3` k³.

    Bytes are each input byte read once (``in_bytes``: the start
    vectors and every tensor of the batch) and each output byte written
    once (``out_bytes``). The same numbers hold at every precision and
    for every implementation of the work. Returns the
    {"flops", "bytes_accessed", "memory"} record
    :func:`executable_cost` reads back."""
    n_rows, n_lanes, k = int(n_rows), int(n_lanes), int(k)
    per_iter = (2 * n_rows * k * k + 2 * n_rows * k + 2 * n_rows
                + EIGH_FLOPS_PER_K3 * n_lanes * k ** 3)
    return {"flops": float(int(maxiter) * per_iter),
            "bytes_accessed": float(int(in_bytes) + int(out_bytes)),
            "memory": {"argument_size_in_bytes": int(in_bytes),
                       "output_size_in_bytes": int(out_bytes)}}


def executable_cost(program):
    """Cost record of a built program: {"flops", "bytes_accessed",
    "memory": {...} | None}, the counts recorded on it when it was built, as
    ``.cost`` (:func:`normal_equations_cost`). Every field is None for
    a program that carries no counts — the build/capture timing split
    never depends on the cost model."""
    rec = getattr(program, "cost", None) or {}
    flops = rec.get("flops")
    bytes_ac = rec.get("bytes_accessed")
    return {"flops": float(flops) if flops is not None else None,
            "bytes_accessed": (float(bytes_ac) if bytes_ac is not None
                               else None),
            "memory": dict(rec["memory"]) if rec.get("memory") else None}


def device_memory_stats(device=None):
    """Live device-memory watermark {bytes_in_use, peak_bytes_in_use,
    bytes_limit} of a card (``torch.cuda.memory_stats``,
    ``max_memory_allocated`` and the card's total memory); None on the
    CPU. Best-effort: telemetry, not control flow."""
    try:
        import torch

        if device is None:
            if not torch.cuda.is_available():
                return None
            device = torch.device("cuda", torch.cuda.current_device())
        device = torch.device(device)
        if device.type != "cuda":
            return None
        stats = torch.cuda.memory_stats(device)
        return {"bytes_in_use": int(stats.get("allocated_bytes.all.current",
                                              0)),
                "peak_bytes_in_use": int(
                    torch.cuda.max_memory_allocated(device)),
                "bytes_limit": int(torch.cuda.get_device_properties(
                    device).total_memory)}
    except Exception:
        return None


class ProgramLedger:
    """Thread-safe label -> cost record map: every AOT backend
    compile registers its program's cost here, so execute-time
    consumers (fleet execute spans, the CLI) can attribute a wall time
    to the program that produced it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._programs = {}

    def record(self, label, cost):
        with self._lock:
            self._programs[label] = dict(cost)
        return self

    def get(self, label):
        with self._lock:
            rec = self._programs.get(label)
        return dict(rec) if rec is not None else None

    def attribute(self, label, wall_s=None, platform=None):
        """Roofline attribution of a recorded program (None when the
        label was never compiled through the AOT split)."""
        rec = self.get(label)
        if rec is None:
            return None
        return attribute(rec.get("flops"), rec.get("bytes_accessed"),
                         wall_s=wall_s, platform=platform)

    def snapshot(self):
        with self._lock:
            return {k: dict(v) for k, v in self._programs.items()}

    def reset(self):
        with self._lock:
            self._programs.clear()


LEDGER = ProgramLedger()
