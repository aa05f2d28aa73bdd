"""One-call durable serve state: save/restore everything restartable
(the JAX package's ``serve/recovery.py``).

The engine already exposes versioned ``state_dict`` surfaces piecemeal
— CircuitBreaker and HealthMonitor (resilience), the engine's own
state (``ServeEngine.state_dict``: the drift board's baselines in the
JAX package; ``None`` here, where the drift board waits with the
observability queue, as the JAX package writes it when no board is
attached), and the process fit-quality ledger
(obs.fitquality.FITQ). This module unifies them
under a single snapshot riding the journal directory
(``<durable_dir>/state``), through FitCheckpointer — so the snapshot
inherits the CRC32 integrity record, the atomic ``.prev`` rotation,
and the corrupt-fallback restore for free, exactly like the
resilience-state checkpoint it generalizes.

``ServeEngine.recover`` calls :func:`restore_serve_state` before
replaying the journal, so policy decisions (tripped breakers, drain
standing, drift baselines, quality counters) resume where the dead
process left them instead of resetting — no alarm storm, no
forgotten quarantines.

Every component restore is tolerant: a missing snapshot, foreign
layout version, or a component state its ``load_state_dict`` rejects
warns and skips that component; recovery proceeds with whatever is
valid (a stale policy state must never block replaying requests).
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import warnings

import numpy as np

from ..checkpoint import FitCheckpointer

SERVE_STATE_VERSION = 1
_STATE_SUBDIR = "state"


def _checkpointer(directory):
    if isinstance(directory, FitCheckpointer):
        return directory
    return FitCheckpointer(os.path.join(os.fspath(directory),
                                        _STATE_SUBDIR))


def save_serve_state(engine, directory=None, tag="serve"):
    """Snapshot every restartable component of a serving process into
    ``<directory>/state`` (directory defaults to the engine's
    durable_dir). Returns the FitCheckpointer used.

    The JSON-encoded state rides as a uint8 byte array so the
    checkpoint CRC covers it (see checkpoint.save_resilience_state
    for why a sidecar string would dodge the integrity check).
    """
    directory = directory if directory is not None else engine.durable_dir
    if directory is None:
        raise ValueError("no directory: construct the engine with "
                         "durable_dir= or pass one explicitly")
    from ..obs import fitquality as obs_fitq

    state = {"breaker": engine.breaker.state_dict(),
             "health": engine.health.state_dict(),
             "engine": engine.state_dict(),
             "fit_quality": obs_fitq.FITQ.state_dict()}
    # default=float coerces stray numpy scalars a probe dict may carry
    blob = np.frombuffer(
        json.dumps(state, sort_keys=True, default=float).encode(),
        dtype=np.uint8)
    ckpt = _checkpointer(directory)
    ckpt.save(tag, {"serve_json": blob.copy(),
                    "serve_version": SERVE_STATE_VERSION})
    return ckpt


def restore_serve_state(engine, directory=None, tag="serve"):
    """Load a :func:`save_serve_state` snapshot and apply it to the
    engine's components. Returns the set of component names actually
    restored, or None when no snapshot exists at all (the fresh-start
    case — not an error)."""
    directory = directory if directory is not None else engine.durable_dir
    if directory is None:
        raise ValueError("no directory: construct the engine with "
                         "durable_dir= or pass one explicitly")
    ckpt = _checkpointer(directory)
    state = ckpt.restore(tag)
    if state is None or "serve_json" not in state:
        return None
    version = int(np.asarray(state.get("serve_version", -1)))
    if version != SERVE_STATE_VERSION:
        warnings.warn(
            f"serve state snapshot {tag!r} has layout version "
            f"{version}, this build writes {SERVE_STATE_VERSION}; "
            "starting from reset state")
        return None
    try:
        blob = np.asarray(state["serve_json"], dtype=np.uint8)
        decoded = json.loads(blob.tobytes().decode())
    except (ValueError, UnicodeDecodeError) as e:
        warnings.warn(f"serve state snapshot {tag!r} is undecodable "
                      f"({type(e).__name__}: {e}); starting from "
                      "reset state")
        return None
    from ..obs import fitquality as obs_fitq

    restored = set()
    if "breaker" in decoded:
        if engine.breaker.load_state_dict(decoded["breaker"]):
            restored.add("breaker")
    if "health" in decoded:
        if engine.health.load_state_dict(decoded["health"]):
            restored.add("health")
    for name, target in (("engine", engine),
                         ("fit_quality", obs_fitq.FITQ)):
        comp = decoded.get(name)
        if comp is None:
            continue
        try:
            target.load_state_dict(comp)
            restored.add(name)
        except ValueError as e:
            warnings.warn(f"serve state component {name!r} rejected "
                          f"({e}); keeping its reset state")
    return restored


def result_digest(value):
    """Canonical byte digest of a ServeResult value dict — the
    bit-identity witness the serve contracts are asserted with (replay
    idempotence, async vs sync, traced vs untraced, ledger on vs off).
    Arrays contribute their exact buffer bytes, floats their IEEE-754
    encoding: two digests match iff the results are bitwise identical,
    not merely close."""
    if value is None:
        return None
    h = hashlib.sha256()
    for k in sorted(value):
        v = value[k]
        h.update(str(k).encode())
        if isinstance(v, np.ndarray):
            h.update(str(v.dtype).encode())
            h.update(repr(v.shape).encode())
            h.update(np.ascontiguousarray(v).tobytes())
        elif isinstance(v, float):
            h.update(struct.pack("<d", v))
        else:
            h.update(repr(v).encode())
    return h.hexdigest()
