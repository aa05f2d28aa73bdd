"""Streaming refits: cached per-lane GLS state under TOA appends (torch
counterpart of the JAX package's ``serve/streaming.py``).

Observatories upload a handful of new TOAs per pulsar per epoch; they
must be folded in WITHOUT paying a full O(N K^2) repack-and-refit. Each
registered lane (one pulsar) freezes a linearization — the model's free
parameters, the column normalization of the whitened design — and
caches the fused-tile normal state (kernels/incremental.py). An append
then costs: evaluate the new rows' design / residual / weight columns
at the frozen linearization (a small padded single-pulsar batch on the
card), one additive (K+2)x(K+2) Gram delta (K1′ on the card under
``precision="mixed"``), a rank-r Cholesky factor update and a K x K
solve on the host.

Parity is the contract that makes the shortcut safe: the lane folds its
accumulators through the same sequential left-fold block partition a
from-scratch pass uses, so after any f64 append sequence the
incremental normal state is bitwise the state rebuilt from the
concatenated rows, and escalation (below) reproduces a fresh
registration on the final dataset exactly.

Escalation — when the lane goes stale, the incremental shortcut is
surrendered, never stretched:

- drift sentinels (obs/drift.py EWMA+CUSUM) watch the standardized mean
  whitened residual of each appended batch; an alarm marks the model
  stale and triggers a full refit over the merged dataset;
- a ``solver_diverge`` fault (or a genuinely non-finite incremental
  solve) quarantines the incremental result and escalates the same way;
- models with correlated-noise (basis_weight) components never get an
  incremental lane: their red-noise Fourier basis columns are a function
  of the batch's full time span, so appended rows cannot be evaluated
  against a frozen basis — every append on such a lane is a full refit
  by policy.

Durability: each append is persisted as a content-chained delta segment
(store/deltas.py) BEFORE its result is visible, keyed by the request
id, so a replayed request re-derives the identical chain exactly once
instead of forking or double-applying. On registration a lane replays
any persisted chain into its state. An escalation that merges
in-process chunks into a new base re-roots the chain
(DeltaStore.reset_lane); lanes that escalated after a chain replay keep
their chain instead — their accumulators are refreshed in place,
because the replayed rows exist only as accumulators and a merge would
silently drop them.

``mesh=`` (a ``parallel.mesh.Mesh``) puts every lane's batches on the
mesh's first device, as the JAX package's single-pulsar batches on a
mesh are: a lane's rows and its appends' Grams (K1′ on the card) run
there.

Difference from the JAX package: there is no per-lane compiled
evaluator — torch runs eagerly, so a lane's rows are evaluated by a
function built on the batch at hand; registration builds the lane's
base batch once and reuses it for its linearization sweeps (the batch
does not depend on the linearization point, so the numbers are those
of a rebuild). ``clock`` is the owning engine's (monotonic) clock, as
in the JAX package (``ServeEngine`` hands it its own).
"""

from __future__ import annotations

import threading
import warnings

import numpy as np
import torch

from .. import autodiff
from ..obs import drift as obs_drift
from ..resilience import faultinject
from . import policy

__all__ = ["StreamingRefitter", "lane_key", "APPEND_PAD", "BASE_BLOCK"]

# every append chunk is padded to this many TOAs (winv=0 beyond the
# real rows, which whiten to nothing): the "<= 64 appended TOAs per
# pulsar" traffic profile
APPEND_PAD = 64

# base rows stream through the fused tile at this block granularity —
# the left-fold partition the bit-identity contract folds over
BASE_BLOCK = 1024

# normalized-space ridge prior on every lane column. Real pulsar normal
# matrices are near-singular (F0/F1/offset are nearly collinear over a
# finite span), which is why the batch GLS path solves by THRESHOLDED
# eigh. The incremental fast path needs a Cholesky-factorable A, so
# lanes carry diag(q^2)=1e-12 — damping only directions the eigh floor
# (fitter.GLS_EIG_FLOOR=3e-14) would truncate anyway. The from-scratch
# comparator (a fresh registration / escalation) carries the same ridge.
LANE_RIDGE = 1e-6

# one-step GLS re-linearization sweeps at registration, so the frozen x0
# appends linearize against is a CONVERGED solution rather than the raw
# par-file values
REGISTER_ITERS = 2

# iterative-refinement sweeps per lane solve: each contracts the
# factor-solve error by ~eps*kappa, and the ridged kappa can reach
# ~1e12, so four sweeps pull relres under the 1e-12 acceptance tol
SOLVE_REFINE = 4


def lane_key(model):
    """Stable lane id: the PSR name when the model has one, the object
    id otherwise."""
    psr = getattr(model, "PSR", None)
    val = getattr(psr, "value", None) if psr is not None else None
    return str(val) if val else f"model-{id(model):x}"


def _pad_len(n, multiple):
    return max(multiple, -(-n // multiple) * multiple)


class StreamingLane:
    """One pulsar's cached incremental state. After the lane is
    published in the refitter's registry, every field is mutated under
    the lane's own ``_lock`` (registration mutates the not-yet-published
    lane from the constructing thread), so appends on independent lanes
    run concurrently."""

    def __init__(self, key, model, toas, precision, incremental):
        self._lock = threading.RLock()
        self.key = key
        self.model = model
        self.base_toas = toas
        self.chunks = []  # appended TOA tables, arrival order
        self.precision = precision
        self.incremental = incremental
        self.x = None  # frozen linearization (free-parameter vector)
        self.norm = None  # frozen column normalization
        self.free_names = None
        self.state = None  # kernels.incremental.IncrementalNormal
        self.base_signature = None
        self.tip = None  # delta-chain tip signature
        self.sentinel = None
        self.stale = False
        self.escalations = 0
        self.n_appended = 0
        # segments folded in from the persisted chain at registration:
        # rows the lane holds only as accumulators, with no TOA table
        # to rebuild from (see _rebuild's escalation policy)
        self.replayed_segments = 0


class StreamingRefitter:
    """Registry + math of the append lanes.

    Thread-safe: ``_lock`` covers only the lane REGISTRY and the
    refitter counters; each lane's math and delta IO runs under the
    lane's own lock, so appends on independent lanes proceed
    concurrently. Lock ordering is one-way — StreamingLane._lock ->
    {StreamingRefitter._lock, DeltaStore._lock} — and nothing acquires a
    lane lock while holding the refitter lock. The optional ``deltas``
    store (store/deltas.py) persists each append before its result is
    visible; ``clock`` follows the owning engine's (monotonic) clock.
    Row evaluation and the appended rows' Grams run on ``device`` (the
    card unless the caller asks for the CPU), or on ``mesh``'s first
    device."""

    def __init__(self, deltas=None, clock=None, mesh=None, device="cuda"):
        import time

        from ..parallel.pta import _mesh_device

        self._lock = threading.RLock()
        self.lanes = {}
        self.deltas = deltas
        self.clock = clock or time.monotonic
        self.mesh = mesh
        self.device = _mesh_device(mesh, device)
        self.appends = 0
        self.escalated = 0
        self.replayed = 0

    # -- lane math ----------------------------------------------------

    def _batch(self, model, toas, pad):
        """One pulsar's TOAs as a PTABatch padded to ``pad`` rows."""
        from ..parallel.pta import PTABatch

        return PTABatch([model], [toas], pad_toas=pad, device=self.device,
                        mesh=self.mesh)

    @staticmethod
    def _make_rows_fn(pta):
        """x (1, k) -> (M, r, winv) rows of the single-pulsar batch
        ``pta`` at that free-parameter vector: the design by
        ``torch.func.vmap`` over ``torch.func.jacfwd`` of the batch's
        phase function (over F0, with the offset column), the residual
        seconds and 1/sigma [1/s]."""
        from ..parallel.pta import _tensor_tree

        resid_fn = pta._resid_fn()
        phase_fn = pta._phase_fn()
        prep = _tensor_tree(pta.prep)

        def phase_of(xv, ps, b, pr):
            return phase_fn(pta._overlay(ps, xv), b, pr)

        jac = torch.func.vmap(autodiff.jacfwd(phase_of))

        def rows(x):
            p = pta._overlay(pta.params, x)
            r, sig = resid_fn(p, pta.batch, prep)
            M = jac(x, pta.params, pta.batch, prep) / p["F"][:, 0, None, None]
            M = torch.cat([torch.ones_like(M[..., :1]), M], dim=-1)
            return M, r, 1.0 / (sig * 1e-6)

        return rows

    def _eval_rows(self, lane, pta):
        """Evaluate the batch's rows at the lane's frozen linearization
        (host numpy out); padded rows come back zeroed, winv=0."""
        if lane.x is None:
            lane.x = pta._x0()[0].cpu().numpy()
            lane.free_names = [n for n, _, _ in pta.free_map()]
        x = torch.as_tensor(lane.x, device=self.device)[None, :]
        with torch.no_grad():
            M, r, winv = (a[0].cpu().numpy()
                          for a in self._make_rows_fn(pta)(x))
        # zero the padded rows OUTRIGHT (not just their weights): a
        # padded row whose design/residual evaluated non-finite would
        # otherwise poison the Gram through 0 * nan
        valid = np.arange(M.shape[0]) < int(pta.n_toas[0])
        M = np.where(valid[:, None], M, 0.0)
        r = np.where(valid, r, 0.0)
        winv = np.where(valid, winv, 0.0)
        return M, r, winv

    def _build_state(self, lane, pta):
        """(Re)build the lane's cached normal state from its base rows
        (``pta``, the base batch): frozen normalization from the base
        whitened design, left-folded f64 block Grams, ridge prior (see
        LANE_RIDGE)."""
        from ..fitter import column_norms
        from ..kernels import incremental as inc

        M, r, winv = self._eval_rows(lane, pta)
        norm = column_norms(torch.as_tensor(M * winv[:, None])).numpy()
        lane.norm = norm
        X = M / norm[None, :]
        lane.state = inc.build_normal(
            X, r, winv, q=np.full(X.shape[1], LANE_RIDGE),
            block=min(BASE_BLOCK, _pad_len(X.shape[0], 8)),
            device=self.device)
        lane.n_appended = 0

    def _linearize(self, lane, iters=REGISTER_ITERS):
        """Converge the lane's frozen linearization: ``iters`` one-step
        GLS sweeps (build state at x, solve, move x), then a final state
        build at the converged x. Registration AND escalation both run
        exactly this loop — the bit-identity contract between an
        escalated lane and a fresh registration on the merged dataset is
        a consequence."""
        pta = self._batch(lane.model, lane.base_toas,
                          _pad_len(len(lane.base_toas), APPEND_PAD))
        for _ in range(int(iters)):
            self._build_state(lane, pta)
            x, _, _ = self._solve(lane)
            if not np.all(np.isfinite(x)):
                break  # keep the last finite linearization point
            lane.x = np.asarray(x, np.float64)
        self._build_state(lane, pta)

    def _chunk_arrays(self, lane, toas):
        """The persisted/foldable arrays for one append chunk."""
        M, r, winv = self._eval_rows(lane,
                                     self._batch(lane.model, toas, APPEND_PAD))
        X = M / lane.norm[None, :]
        return {"X": X, "r": r, "winv": winv}

    def _solve(self, lane):
        dxn, chi2, info = lane.state.solve(refine=SOLVE_REFINE)
        dx_all = dxn.numpy() / lane.norm
        x = lane.x - dx_all[1:]
        return x, chi2, info

    # -- public API ---------------------------------------------------

    def register(self, model, toas, precision="f64", sentinel=None):
        """Register one lane: freeze the linearization, build the cached
        normal state, replay any persisted delta chain into it.
        Correlated-noise models register as NON-incremental lanes (every
        append escalates to a full refit by policy). Returns the lane
        key."""
        key = lane_key(model)
        incremental = not policy.has_correlated_noise(model)
        lane = StreamingLane(key, model, toas, precision, incremental)
        lane.sentinel = sentinel or obs_drift.DriftSentinel()
        # build before publication: the lane is invisible until the
        # registry insert, so its registration and chain replay never
        # stall append traffic on OTHER lanes
        if incremental:
            self._linearize(lane)
            lane.base_signature = self._base_signature(model, toas)
            lane.tip = lane.base_signature
            self._replay_chain(lane)
        with self._lock:
            self.lanes[key] = lane
        return key

    @staticmethod
    def _base_signature(model, toas):
        from ..store.packstore import content_signature

        return content_signature([model], [toas], lane="stream")

    def _replay_chain(self, lane):
        """Fold a recovered process's persisted delta chain back into
        the freshly built base state — appends survive restarts without
        re-evaluating the already-appended rows."""
        if self.deltas is None:
            return
        chain = self.deltas.load_chain(lane.key, lane.base_signature)
        for chain_sig, arrays in chain:
            lane.state.append(arrays["X"], arrays["r"], arrays["winv"],
                              precision=lane.precision)
            lane.n_appended += int(np.count_nonzero(arrays["winv"]))
            lane.tip = chain_sig
            lane.replayed_segments += 1
            with self._lock:
                self.replayed += 1

    def lane(self, model):
        with self._lock:
            return self.lanes.get(lane_key(model))

    def append(self, model, toas, rid=""):
        """Fold one appended TOA table into the model's lane.

        Returns the result payload dict (params at the refreshed solve,
        chi2, solver/escalation provenance). Raises KeyError for an
        unregistered lane.

        The refitter lock covers only the registry lookup and the append
        counter; the per-lane work — row evaluation, delta publish,
        solve, even a full-refit escalation — runs under the lane's own
        lock."""
        key = lane_key(model)
        with self._lock:
            lane = self.lanes.get(key)
            if lane is None:
                raise KeyError(f"no streaming lane registered for "
                               f"{key!r}")
            self.appends += 1
        with lane._lock:
            if not lane.incremental:
                # correlated-noise tier: every append is a full refit
                lane.chunks.append(toas)
                return self._full_refit(lane, reason="correlated_noise")
            arrays = self._chunk_arrays(lane, toas)
            replayed = False
            if self.deltas is not None:
                # durable BEFORE visible: the chain link lands (or is
                # recognized as already landed — a replayed request)
                # before any result is computed from it
                tip, replayed = self.deltas.append(
                    lane.key, lane.tip, arrays, rid=rid)
                lane.tip = tip
            if replayed:
                with self._lock:
                    self.replayed += 1
            else:
                lane.chunks.append(toas)
                lane.state.append(arrays["X"], arrays["r"],
                                  arrays["winv"],
                                  precision=lane.precision)
                lane.n_appended += int(np.count_nonzero(arrays["winv"]))
            fault = faultinject.fire("solver_diverge", lane=key,
                                     path="incremental")
            x, chi2, info = self._solve(lane)
            diverged = (fault is not None
                        or not np.all(np.isfinite(x)))
            alarm = None
            if not diverged:
                alarm = lane.sentinel.observe(self._drift_stat(arrays))
            if diverged or alarm is not None:
                reason = ("solver_diverge" if diverged
                          else "drift_alarm")
                lane.stale = True
                return self._escalate(lane, reason=reason, alarm=alarm)
            return {"x": x, "chi2": chi2,
                    "free_names": list(lane.free_names),
                    "solver": info["solver"],
                    "relres": info["relres"],
                    "refactors": info["refactors"],
                    "escalated": False, "replayed": replayed,
                    "chain": lane.tip,
                    "n_appended": lane.n_appended}

    @staticmethod
    def _drift_stat(arrays):
        """Standardized mean whitened residual of one appended batch —
        ~N(0,1) while the frozen model still describes the new TOAs,
        drifting away as the model goes stale. The drift sentinel's
        EWMA+CUSUM watches this series."""
        z = arrays["r"] * arrays["winv"]
        n = max(1, int(np.count_nonzero(arrays["winv"])))
        return float(np.sum(z) / np.sqrt(n))

    def _escalate(self, lane, reason, alarm=None):
        """Full refit over the merged dataset: rebuild the lane exactly
        as a fresh registration on base+appended TOAs would — the
        bit-identity contract — then solve."""
        with self._lock:
            self.escalated += 1
        lane.escalations += 1
        warnings.warn(
            f"streaming lane {lane.key!r} escalated to full refit "
            f"({reason}); incremental state rebuilt from the merged "
            f"dataset")
        self._rebuild(lane)
        x, chi2, info = self._solve(lane)
        lane.stale = False
        return {"x": x, "chi2": chi2,
                "free_names": list(lane.free_names),
                "solver": "full_refit", "relres": info["relres"],
                "refactors": info["refactors"], "escalated": True,
                "escalation_reason": reason,
                "drift_alarm": alarm, "replayed": False,
                "chain": lane.tip, "n_appended": lane.n_appended}

    def _rebuild(self, lane):
        """Merge base + appended TOA tables into a new base and rebuild
        the cached state from scratch (the code path of a fresh
        registration on the final dataset), re-rooting the persisted
        delta chain at the merged base's signature: the old segments are
        rooted at the surrendered base, so left on disk they would fail
        the parent guard on the very next append.

        When any appended rows are not in-process as TOA tables —
        post-restart lanes whose chain replay folded accumulators the
        lane cannot re-evaluate — merging only ``lane.chunks`` would
        silently DROP the replayed rows. Such lanes (and chunk-less
        ones) keep their exact accumulators and their on-disk chain and
        only refactor the cached factor."""
        from ..toa import merge_TOAs

        if lane.chunks and not lane.replayed_segments:
            merged = merge_TOAs([lane.base_toas] + list(lane.chunks))
            lane.base_toas = merged
            lane.chunks = []
            lane.x = None  # re-linearize from the model params, as a
            lane.norm = None  # fresh registration would
            self._linearize(lane)
            if self.deltas is not None:
                self.deltas.reset_lane(lane.key)
            lane.base_signature = self._base_signature(lane.model, merged)
            lane.tip = lane.base_signature
        else:
            lane.state.L = lane.state._refactor()
            lane.state.refactors += 1

    def _full_refit(self, lane, reason):
        """The non-incremental (correlated-noise) tier: a straight
        PTABatch GLS refit over the merged dataset."""
        from ..toa import merge_TOAs

        with self._lock:
            self.escalated += 1
        lane.escalations += 1
        merged = merge_TOAs([lane.base_toas] + list(lane.chunks))
        pta = self._batch(lane.model, merged,
                          _pad_len(len(merged), APPEND_PAD))
        x, chi2, _ = pta.gls_fit(maxiter=2, precision=lane.precision)
        return {"x": np.asarray(x)[0],
                "chi2": float(np.asarray(chi2)[0]),
                "free_names": [n for n, _, _ in pta.free_map()],
                "solver": "full_refit",
                "escalated": True, "escalation_reason": reason,
                "replayed": False, "chain": None,
                "n_appended": 0}

    def counters(self):
        with self._lock:
            return {"lanes": len(self.lanes), "appends": self.appends,
                    "escalated": self.escalated,
                    "replayed": self.replayed}
