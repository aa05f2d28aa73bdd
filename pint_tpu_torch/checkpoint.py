"""Fit-state checkpointing for long batch fits (the JAX package's
``checkpoint.py``, its numpy ``.npz`` path).

(reference analog: the reference's checkpoint is the par file itself
plus the TOA pickle cache; for batch fits this module snapshots the
numeric fit state between outer iterations, so a preempted multi-hour
PTA run resumes instead of restarting.) The JAX package writes through
orbax when it can import it and falls back to ``.npz``; torch has no
orbax, so every snapshot here is one ``.npz`` file — the JAX package's
fallback format, readable by either package.

Integrity: every save records a CRC32 over the packed numeric arrays
(key + dtype + shape + raw bytes, keys sorted) EMBEDDED in the
snapshot itself (a ``__meta_json__`` uint8 array riding the saved
tree), and every save first rotates the existing snapshot to
``<tag>.prev``. Embedding makes a snapshot ONE artifact — one npz file
written through ``durable.atomic_write_bytes`` — so the rotation is a
single ``os.replace`` and a process kill can never leave ``.prev``
mixing a sidecar from one generation with data from another.
restore() verifies the checksum and, when the latest snapshot is
unreadable or fails verification, falls back to the rotated previous
one — a torn write at preemption time costs one checkpoint interval,
not the whole run. Snapshots written before this scheme (sidecar
``.meta.json``, or no checksum record at all) restore as before.
"""

from __future__ import annotations

import os
import shutil
import warnings
import zlib

import numpy as np

from .durable import atomic_write_bytes
from .resilience import faultinject

# reserved meta key carrying the snapshot checksum (never a state
# key: save() would have stringified it)
INTEGRITY_KEY = "__integrity__"
# reserved tree key carrying the JSON-encoded meta (string-valued
# state + the integrity record) as a uint8 array, so the whole
# snapshot — data AND checksum — is one atomic write unit
META_EMBED_KEY = "__meta_json__"


def _integrity_crc(numeric: dict) -> int:
    """CRC32 over the packed arrays, order-independent via sorted
    keys; dtype and shape are folded in so a reinterpreted buffer
    (same bytes, different view) fails verification too."""
    crc = 0
    for k in sorted(numeric):
        v = np.ascontiguousarray(np.asarray(numeric[k]))
        crc = zlib.crc32(str(k).encode(), crc)
        crc = zlib.crc32(str(v.dtype).encode(), crc)
        crc = zlib.crc32(repr(v.shape).encode(), crc)
        crc = zlib.crc32(v.tobytes(), crc)
    return int(crc)


class FitCheckpointer:
    """Save/restore (param-vector, iteration, chi2) snapshots, one
    ``<tag>.npz`` per tag in ``directory`` (plus ``<tag>.prev.npz``,
    the previous generation)."""

    def __init__(self, directory):
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, tag):
        return os.path.join(self.directory, str(tag))

    def has_snapshot(self, tag) -> bool:
        """Any on-disk trace of ``tag`` (valid or not)? A directory is
        the JAX package's orbax layout, which this package cannot
        read but still rotates and reports."""
        return (os.path.isdir(self._path(tag))
                or os.path.exists(self._path(tag) + ".npz")
                or os.path.exists(self._path(tag) + ".meta.json"))

    def _rotate(self, tag):
        """Move the current snapshot of ``tag`` (all backends' files)
        to ``<tag>.prev``, replacing any older .prev — the fallback
        restore() reaches for when the latest snapshot is damaged.

        The old .prev is cleared as a UNIT before anything moves: a
        kill mid-rotation must never leave .prev mixing generations
        (a stale legacy sidecar next to newer data would fail the CRC
        check and poison the fallback). New-style snapshots are a
        single artifact, so their rotation is one atomic
        ``os.replace``; the multi-file window only ever applies to
        legacy sidecar snapshots."""
        prev = f"{tag}.prev"
        for suffix in ("", ".npz", ".meta.json"):
            dst = self._path(prev) + suffix
            if os.path.isdir(dst):
                shutil.rmtree(dst)
            elif os.path.exists(dst):
                os.remove(dst)
        for suffix in ("", ".npz", ".meta.json"):
            src = self._path(tag) + suffix
            present = (os.path.isdir(src) if suffix == ""
                       else os.path.exists(src))
            if present:
                os.replace(src, self._path(prev) + suffix)

    def save(self, tag, state: dict):
        """state: dict of arrays/scalars (e.g. {"x": ..., "iter": i,
        "chi2": ...}). String-valued entries (parameter names) ride a
        JSON-encoded uint8 array inside the saved tree, as the JAX
        package writes them, alongside the CRC32 of the numeric
        arrays, so the snapshot is one atomic unit rather than a data
        file plus a sidecar that can tear apart."""
        import io
        import json

        state = {k: np.asarray(v) for k, v in state.items()}
        meta = {k: np.asarray(v).tolist() for k, v in state.items()
                if np.asarray(v).dtype.kind in "US"}
        numeric = {k: v for k, v in state.items()
                   if np.asarray(v).dtype.kind not in "US"}
        meta[INTEGRITY_KEY] = _integrity_crc(numeric)
        tree = dict(numeric)
        tree[META_EMBED_KEY] = np.frombuffer(
            json.dumps(meta, sort_keys=True).encode(),
            dtype=np.uint8).copy()
        self._rotate(tag)
        path = self._path(tag) + ".npz"
        buf = io.BytesIO()
        np.savez(buf, **tree)
        atomic_write_bytes(path, buf.getvalue())
        fault = faultinject.fire("checkpoint_corrupt", tag=str(tag))
        if fault:
            self._corrupt_snapshot(tag)
        return path

    def _corrupt_snapshot(self, tag):
        """checkpoint_corrupt fault effect: flip one byte mid-file in
        the snapshot just written, modeling a torn/bit-rotted write
        that the integrity check must catch."""
        with open(self._path(tag) + ".npz", "r+b") as f:
            data = f.read()
            pos = len(data) // 2
            f.seek(pos)
            f.write(bytes([data[pos] ^ 0xFF]))

    def _load_raw(self, tag):
        """(state-dict-with-meta-merged, recorded-crc-or-None), or
        (None, None) when nothing readable exists. A corrupted zip
        raises all sorts (BadZipFile, zlib.error, KeyError, ...) — any
        load failure means 'no snapshot here'."""
        import json

        out = None
        path = self._path(tag) + ".npz"
        if os.path.exists(path):
            try:
                with np.load(path) as z:
                    out = {k: z[k] for k in z.files}
            except Exception:
                out = None
        if out is None:
            return None, None
        crc = None
        embedded = out.pop(META_EMBED_KEY, None)
        if embedded is not None:
            # new-style snapshot: meta + CRC ride inside the tree.
            # An unreadable embedded record means the snapshot is
            # damaged as a whole (it was written as one unit), so it
            # counts as 'no snapshot here', not 'restore unverified'.
            try:
                meta = json.loads(np.asarray(embedded, dtype=np.uint8)
                                  .tobytes().decode())
                crc = meta.pop(INTEGRITY_KEY, None)
                out.update({k: np.asarray(v) for k, v in meta.items()})
            except (ValueError, UnicodeDecodeError):
                return None, None
            return out, crc
        meta_path = self._path(tag) + ".meta.json"
        if os.path.exists(meta_path):
            try:
                with open(meta_path) as f:
                    meta = json.load(f)
                crc = meta.pop(INTEGRITY_KEY, None)
                out.update({k: np.asarray(v) for k, v in meta.items()})
            except (OSError, json.JSONDecodeError):
                pass
        return out, crc

    def _restore_verified(self, tag):
        out, crc = self._load_raw(tag)
        if out is None:
            return None
        if crc is not None:
            numeric = {k: v for k, v in out.items()
                       if np.asarray(v).dtype.kind not in "US"}
            if _integrity_crc(numeric) != int(crc):
                warnings.warn(
                    f"checkpoint {tag!r} failed its CRC32 integrity "
                    "check (torn or corrupted write); discarding it")
                return None
        # a pre-integrity snapshot (crc is None) restores unverified
        return out

    def restore(self, tag, fallback=True) -> dict | None:
        """Load the ``.npz`` snapshot of ``tag`` (this package's or the
        JAX package's fallback format).

        Verifies the CRC32 recorded at save time; an unreadable or
        corrupt snapshot falls back (fallback=True) to the rotated
        ``<tag>.prev`` — the most recent valid snapshot — and returns
        None only when nothing valid survives."""
        out = self._restore_verified(tag)
        if out is None and fallback:
            prev = f"{tag}.prev"
            if self.has_snapshot(prev):
                out = self._restore_verified(prev)
                if out is not None:
                    warnings.warn(
                        f"checkpoint {tag!r} was unreadable or corrupt; "
                        f"restored the previous snapshot {prev!r}")
        return out

    def latest_iteration(self, tag) -> int:
        state = self.restore(tag)
        if state is None or "iter" not in state:
            return -1
        return int(state["iter"])


# version stamp of the resilience-state checkpoint LAYOUT (the
# breaker/health dicts inside carry their own per-component versions,
# checked by the load_state_dict methods)
RESILIENCE_STATE_VERSION = 1


def save_resilience_state(directory, tag="resilience", breaker=None,
                          health=None):
    """Persist CircuitBreaker / HealthMonitor state through
    FitCheckpointer so a restarted process does not forget tripped
    breakers or a draining health standing.

    The JSON-encoded state rides as a uint8 byte array, NOT a sidecar
    string: the save path's CRC32 integrity record only covers
    numeric arrays, and breaker state is exactly the kind of small
    blob a torn write corrupts silently. Rotation to ``<tag>.prev``
    and corrupt-fallback come with FitCheckpointer for free.
    ``directory`` may be a path or an existing FitCheckpointer."""
    import json

    ckpt = (directory if isinstance(directory, FitCheckpointer)
            else FitCheckpointer(directory))
    state = {}
    if breaker is not None:
        state["breaker"] = breaker.state_dict()
    if health is not None:
        state["health"] = health.state_dict()
    blob = np.frombuffer(
        json.dumps(state, sort_keys=True).encode(), dtype=np.uint8)
    ckpt.save(tag, {"resilience_json": blob.copy(),
                    "resilience_version": RESILIENCE_STATE_VERSION})
    return ckpt


def restore_resilience_state(directory, tag="resilience", breaker=None,
                             health=None):
    """Load a save_resilience_state snapshot and apply it to the given
    breaker/health objects. Any mismatch — missing snapshot, foreign
    layout version, undecodable blob, or a per-component version the
    load_state_dict methods reject — warns and leaves the objects in
    their reset state rather than guessing. Returns the set of
    component names actually restored."""
    import json

    ckpt = (directory if isinstance(directory, FitCheckpointer)
            else FitCheckpointer(directory))
    state = ckpt.restore(tag)
    if state is None or "resilience_json" not in state:
        return set()
    version = int(np.asarray(state.get("resilience_version", -1)))
    if version != RESILIENCE_STATE_VERSION:
        warnings.warn(
            f"resilience checkpoint {tag!r} has layout version "
            f"{version}, this build writes {RESILIENCE_STATE_VERSION}; "
            "resetting breaker/health state")
        return set()
    try:
        blob = np.asarray(state["resilience_json"], dtype=np.uint8)
        decoded = json.loads(blob.tobytes().decode())
    except (ValueError, UnicodeDecodeError) as e:
        warnings.warn(f"resilience checkpoint {tag!r} is undecodable "
                      f"({type(e).__name__}: {e}); resetting state")
        return set()
    restored = set()
    if breaker is not None and "breaker" in decoded:
        if breaker.load_state_dict(decoded["breaker"]):
            restored.add("breaker")
    if health is not None and "health" in decoded:
        if health.load_state_dict(decoded["health"]):
            restored.add("health")
    return restored


def _warn_restart(tag, ckpt):
    """Shared 'nothing valid survives' report of checkpointed_fit and
    checkpointed_pta_fit: on-disk snapshot(s) exist but none restored."""
    if ckpt.has_snapshot(tag) or ckpt.has_snapshot(f"{tag}.prev"):
        warnings.warn(
            f"checkpoint {tag!r}: no valid snapshot survives "
            "(all copies unreadable or corrupt); restarting the fit "
            "from scratch")


def checkpointed_fit(fitter, directory, tag="fit", every=1, maxiter=20,
                     **fit_kw):
    """Run fitter.fit_toas with snapshots between outer iterations.

    Resumes from the saved parameter vector when a snapshot exists
    (per-pulsar failure isolation for batch runs lives in
    parallel/pta.py; this wrapper covers the single-pulsar fitters).
    Snapshots store parameter NAMES alongside values; on resume the
    values are matched by name, and a snapshot whose free-parameter
    set differs from the current model raises instead of silently
    mis-assigning. "iter" counts completed fit iterations. A corrupt
    snapshot falls back to the previous one; when no valid snapshot
    survives the fit restarts cleanly from iteration 0 (with a
    warning)."""
    ckpt = FitCheckpointer(directory)
    state = ckpt.restore(tag)
    if state is None:
        _warn_restart(tag, ckpt)
    chi2 = None
    if state is not None and "param_values" in state:
        names = [str(n) for n in np.asarray(state["param_names"])]
        current = list(fitter.model.free_params)
        if set(names) != set(current):
            raise ValueError(
                f"checkpoint {tag!r} was taken with free params {names}, "
                f"model has {current}; refusing positional restore")
        vals = dict(zip(names, np.asarray(state["param_values"], float)))
        for name in current:
            getattr(fitter.model, name).value = float(vals[name])
        chi2 = float(state["chi2"])
    done = (int(state["iter"])
            if state is not None and "iter" in state else 0)
    while done < maxiter:
        n = min(every, maxiter - done)
        chi2 = fitter.fit_toas(maxiter=n, **fit_kw)
        done += n
        names = list(fitter.model.free_params)
        vals = np.array([getattr(fitter.model, p).value for p in names])
        ckpt.save(tag, {"param_values": vals,
                        "param_names": np.array(names),
                        "iter": done, "chi2": chi2})
    return chi2


def checkpointed_pta_fit(pta, directory, tag="pta", every=1, maxiter=4,
                         method="gls", **fit_kw):
    """Batched analogue of checkpointed_fit on a PTABatch: snapshot the
    (n_psr, k) parameter vectors between fit chunks so an interrupted
    PTA refit resumes where it stopped (per-pulsar divergence isolation
    already lives inside PTABatch; this adds the between-iterations
    snapshot). Each chunk is ``gls_fit``/``wls_fit(maxiter=<chunk>,
    **fit_kw)`` from the previous chunk's vectors, so a resumed run is
    bitwise the uninterrupted one over the same chunks. Returns (x,
    chi2, cov); cov is None when the snapshot already covered maxiter.
    Corrupt snapshots fall back to the previous one, then to a clean
    (warned) restart."""
    if method not in ("gls", "wls"):
        raise ValueError(f"method must be 'gls' or 'wls', got {method!r}")
    ckpt = FitCheckpointer(directory)
    names = [n for n, _, _ in pta.free_map()]
    state = ckpt.restore(tag)
    if state is None:
        _warn_restart(tag, ckpt)
    if state is not None and not all(
            k in state for k in ("param_names", "x", "chi2", "iter")):
        # partial/foreign snapshot (e.g. a single-pulsar checkpointed_fit
        # tag, or a damaged sidecar): restart cleanly rather than crash
        warnings.warn(f"checkpoint {tag!r} is not a PTA snapshot "
                      f"(keys {sorted(state)}); restarting the fit")
        state = None
    if state is not None:
        saved = [str(n) for n in np.asarray(state["param_names"])]
        if saved != names:
            raise ValueError(
                f"checkpoint {tag!r} was taken with params {saved}, "
                f"batch has {names}; refusing positional restore")
        pta.set_start_vector(np.asarray(state["x"], float))
    done = int(state["iter"]) if state is not None else 0
    fit = pta.gls_fit if method == "gls" else pta.wls_fit
    x = np.asarray(state["x"], float) if state is not None else None
    chi2 = np.asarray(state["chi2"], float) if state is not None else None
    cov = None
    while done < maxiter:
        n = min(every, maxiter - done)
        x, chi2, cov = fit(maxiter=n, **fit_kw)
        done += n
        pta.set_start_vector(x)
        ckpt.save(tag, {"x": np.asarray(x), "chi2": np.asarray(chi2),
                        "param_names": np.array(names), "iter": done})
    return x, chi2, cov
