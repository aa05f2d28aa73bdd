"""ctypes loader for the port's native host library.

Counterpart of the JAX package's ``native/__init__.py``. The library is
the port's own copy of the C++ host kernels, ``csrc/host_kernels.cpp``
(the Earth-rotation chain, the TDB-TT series, the SPK Chebyshev
evaluation and the FORMAT-1 tim parser). It is built at first use with the host
compiler that nvcc needs anyway (``g++ -O3 -fPIC -shared -std=c++17``)
into ``csrc/build/``, under a name keyed by the hash of the source and
the flags, and loaded with ctypes. This is a host mirror, not a device
kernel: every call site keeps its numpy path, which runs when the
library cannot be built or ``PINT_TPU_NO_NATIVE`` is set.
:func:`loaded` says which path ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_LIB: ctypes.CDLL | None | bool = None  # False = tried and failed
BUILD_ERROR = ""  # the compiler's message when a build failed

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
SOURCE = os.path.join(CSRC, "host_kernels.cpp")
FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def library_path() -> str:
    """Where the library of this checkout's source and flags lives."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SOURCE, "rb") as fh:
        h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libpint_host_{h.hexdigest()[:16]}.so")


def _build(so) -> bool:
    # compile to a temporary name and rename atomically: an interrupted
    # or concurrent build never leaves a truncated library in place
    global BUILD_ERROR
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *FLAGS, "-o", tmp, SOURCE], check=True,
                       capture_output=True, text=True, timeout=300)
        os.replace(tmp, so)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        BUILD_ERROR = getattr(e, "stderr", None) or str(e)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def _setup(lib: ctypes.CDLL) -> None:
    """Declare the signatures and push the port's own series tables
    into the library: the IAU2000B nutation table and planetary bias
    from ``earth/erfa_lite.py`` and the TDB-TT terms from
    ``timescales.py`` (one source of truth for both paths)."""
    lib.pt_tdb_minus_tt.argtypes = [ctypes.c_int64, _i64p, _f64p, _f64p]
    lib.pt_tdb_minus_tt.restype = None
    lib.pt_itrf_to_gcrs.argtypes = [
        ctypes.c_int64, _i64p, _f64p, _i64p,
        _f64p, _f64p, _f64p, _f64p, _f64p, _f64p]
    lib.pt_itrf_to_gcrs.restype = None
    lib.pt_cheby_posvel.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        _f64p, _f64p, _f64p, _f64p]
    lib.pt_cheby_posvel.restype = None
    _u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    _i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.pt_parse_tim_t2.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, _i64p, _f64p, _f64p, _f64p,
        _i32p, _u8p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        _u8p, ctypes.c_int64, _i64p, ctypes.POINTER(ctypes.c_int64)]
    lib.pt_parse_tim_t2.restype = ctypes.c_int64
    lib.pt_set_nut_table.argtypes = [ctypes.c_int64, _f64p,
                                     ctypes.c_double, ctypes.c_double]
    lib.pt_set_nut_table.restype = None
    lib.pt_set_tdb_terms.argtypes = [ctypes.c_int64, _f64p,
                                     ctypes.c_int64, _f64p, _f64p,
                                     ctypes.c_int64, ctypes.c_double,
                                     ctypes.c_double]
    lib.pt_set_tdb_terms.restype = None
    from . import timescales as _ts
    from .earth import erfa_lite as _el

    nut = np.ascontiguousarray(_el._NUT_TERMS, np.float64)
    lib.pt_set_nut_table(nut.shape[0], nut,
                         _el._NUT_PLANETARY_BIAS_PSI,
                         _el._NUT_PLANETARY_BIAS_EPS)
    terms = np.ascontiguousarray(_ts._TDB_TERMS_ALL, np.float64)
    t_terms = np.ascontiguousarray(_ts._TDB_T_TERMS, np.float64)
    poly = np.ascontiguousarray(_ts._TDB_POLY, np.float64)
    lib.pt_set_tdb_terms(terms.shape[0], terms,
                         t_terms.shape[0], t_terms, poly,
                         _ts._N_T_TERMS_PUBLISHED,
                         _ts._TDB_T_CLAMP_LO, _ts._TDB_T_CLAMP_HI)


def get_lib() -> ctypes.CDLL | None:
    """The loaded library, built if needed; None when it is switched
    off (``PINT_TPU_NO_NATIVE``) or cannot be built or loaded (callers
    then take their numpy paths)."""
    global _LIB
    if _LIB is False:
        return None
    if _LIB is not None:
        return _LIB
    if os.environ.get("PINT_TPU_NO_NATIVE"):
        _LIB = False
        return None
    so = library_path()
    if not os.path.exists(so) and not _build(so):
        _LIB = False
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        _LIB = False
        return None
    _setup(lib)
    _LIB = lib
    return lib


def loaded() -> bool:
    """True when the C++ library serves the host chain (the numpy
    mirrors run otherwise)."""
    return get_lib() is not None


# ---- typed wrappers (None when the library is not loaded) ----

def tdb_minus_tt(tt_day, tt_sec) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    day = np.ascontiguousarray(tt_day, np.int64)
    sec = np.ascontiguousarray(tt_sec, np.float64)
    out = np.empty(day.shape, np.float64)
    lib.pt_tdb_minus_tt(day.size, day, sec, out)
    return out


def itrf_to_gcrs(tt_day, tt_sec, ut1_day, ut1_sec, xp, yp, itrf_xyz):
    lib = get_lib()
    if lib is None:
        return None
    n = len(tt_day)
    ttd = np.ascontiguousarray(tt_day, np.int64)
    tts = np.ascontiguousarray(tt_sec, np.float64)
    u1d = np.ascontiguousarray(ut1_day, np.int64)
    u1s = np.ascontiguousarray(ut1_sec, np.float64)
    xpa = np.ascontiguousarray(np.broadcast_to(xp, (n,)), np.float64)
    ypa = np.ascontiguousarray(np.broadcast_to(yp, (n,)), np.float64)
    itrf = np.ascontiguousarray(itrf_xyz, np.float64)
    pos = np.empty((n, 3), np.float64)
    vel = np.empty((n, 3), np.float64)
    lib.pt_itrf_to_gcrs(n, ttd, tts, u1d, u1s, xpa, ypa, itrf, pos, vel)
    return pos, vel


def cheby_posvel(et, rec, ncoef, data_type):
    """SPK type 2/3 Chebyshev position [km] and velocity [km/s] at ET
    seconds over the gathered records ``rec`` (n, rsize), as
    ``io/spk.py::SPKKernel.posvel`` folds them; None when the library is
    not loaded or ``ncoef`` exceeds its stack buffer of 32."""
    lib = get_lib()
    if lib is None or ncoef > 32:
        return None
    et = np.ascontiguousarray(et, np.float64)
    rec = np.ascontiguousarray(rec, np.float64)
    n, rsize = rec.shape
    pos = np.empty((n, 3), np.float64)
    vel = np.empty((n, 3), np.float64)
    lib.pt_cheby_posvel(n, ncoef, data_type, rsize, et, rec, pos, vel)
    return pos, vel


def parse_tim_t2(data: bytes):
    """Parse a FORMAT-1 tim buffer in one pass.

    Returns ``(day, sec, freq, err, obs, flags_blob, flag_off, n_bad)``,
    or None when the library is not loaded or the buffer needs the
    stateful Python parser (INCLUDE/TIME/EFAC/... commands, lines that
    are not tempo2 lines). ``flags_blob``/``flag_off`` pack the per-TOA
    flag dicts for the lazy decode of ``toa._decode_flags``.
    """
    lib = get_lib()
    if lib is None:
        return None
    nbytes = len(data)
    # the parser splits on \n, \r\n and a bare \r (Python's universal
    # newlines), so the capacity counts both terminators
    cap = data.count(b"\n") + data.count(b"\r") + 2
    day = np.empty(cap, np.int64)
    sec = np.empty(cap, np.float64)
    freq = np.empty(cap, np.float64)
    err = np.empty(cap, np.float64)
    obs_id = np.empty(cap, np.int32)
    obs_tab = np.empty(4096, np.uint8)
    flags_blob = np.empty(nbytes + 16 * cap + 64, np.uint8)
    flag_off = np.empty(cap + 1, np.int64)
    obs_tab_len = ctypes.c_int64(0)
    n_bad = ctypes.c_int64(0)
    n = lib.pt_parse_tim_t2(
        data, nbytes, day, sec, freq, err, obs_id, obs_tab,
        obs_tab.size, ctypes.byref(obs_tab_len), flags_blob,
        flags_blob.size, flag_off, ctypes.byref(n_bad))
    if n < 0:
        return None
    names = obs_tab[:obs_tab_len.value].tobytes().decode().split("\n")[:-1]
    obs = (np.array(names, dtype=object)[obs_id[:n]] if n
           else np.empty(0, dtype=object))
    # the blob stays bytes: its offsets are byte positions
    blob = flags_blob[:flag_off[n]].tobytes()
    return (day[:n].copy(), sec[:n].copy(), freq[:n].copy(),
            err[:n].copy(), obs, blob, flag_off[:n + 1].copy(),
            int(n_bad.value))
