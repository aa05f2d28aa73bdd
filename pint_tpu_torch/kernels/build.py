"""Build and load the package's hand-written CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface; it is compiled with
``nvcc`` for ``sm_90a`` into a shared library at first use and loaded
with ``ctypes`` (no PyTorch headers, so a build takes seconds). The
library lands in ``csrc/build/`` under a name keyed by the hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header rebuilds and an unchanged one loads as is.
:func:`load_all` starts one ``nvcc`` per missing library, all at once,
so several sources build in the time of the slowest. Nothing is
compiled or loaded at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# per source: {"seconds": build wall time (0 when loaded from disk),
# "log": nvcc's output (registers, shared memory, spills)}
BUILD_INFO: dict[str, dict] = {}


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (needed to build the CUDA "
                           "kernels in pint_tpu_torch/csrc)")
    return path


def _library_path(name):
    src = os.path.join(CSRC, name + ".cu")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src] + sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                               if f.endswith(".cuh")):
        with open(path, "rb") as fh:
            h.update(fh.read())
    digest = h.hexdigest()[:16]
    return src, os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def load_all(names) -> list:
    """The loaded libraries of ``csrc/<name>.cu`` for every name, each
    built on first use; the missing ones build concurrently."""
    with _LOCK:
        todo = [n for n in dict.fromkeys(names) if n not in _LIBS]
        started = {}
        for name in todo:
            src, so = _library_path(name)
            if os.path.exists(so):
                started[name] = (so, None)
                continue
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            # nvcc's output goes to a file: two builds writing to pipes
            # that are read one after the other could block each other
            log = open(f"{tmp}.log", "w+")
            proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                    stdout=log, stderr=subprocess.STDOUT)
            started[name] = (so, (proc, tmp, log, src, time.perf_counter()))
        try:
            for name in todo:
                so, build = started[name]
                info = {"seconds": 0.0, "log": ""}
                if build is not None:
                    proc, tmp, log, src, t0 = build
                    proc.wait()
                    log.seek(0)
                    info = {"seconds": time.perf_counter() - t0,
                            "log": log.read()}
                    if proc.returncode != 0:
                        raise RuntimeError(f"nvcc failed on {src}:\n"
                                           f"{info['log']}")
                    os.replace(tmp, so)  # atomic: concurrent builders agree
                _LIBS[name] = ctypes.CDLL(so)
                BUILD_INFO[name] = info
        finally:
            for so, build in started.values():
                if build is not None:
                    proc, tmp, log = build[:3]
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
                    log.close()
                    os.remove(log.name)
        return [_LIBS[n] for n in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    return load_all([name])[0]
