"""Incremental GLS: additive Gram deltas + rank-r factor updates (torch
counterpart of the JAX package's ``kernels/incremental.py``).

The GLS normal equations are ONE Gram of the whitened augmented rows
``[X | r | winv]`` (kernels/fusedgls.py), and a Gram is additive over
rows. Appending rows therefore contributes

    dG = xw_new^T xw_new        ((K+2, K+2), rank <= r_new)

to the cached accumulators::

    A' = A + dG[:K, :K]    b' = b + dG[:K, K]    rNr' = rNr + dG[K, K]

(the prior diagonal ``diag(q^2)`` is row-count independent and is
applied once, at factor/solve time).

Three paths for the appended rows' Gram, as for every kernel of the
port:

- :func:`delta_gram_ref` — f64 torch reference (JAX ``delta_gram_jnp``);
- :func:`delta_gram_plain` — the same Gram in f32 (the kernel's plain
  version, used for CPU tensors and as the card's yardstick);
- :func:`delta_gram_cuda` — K1′, the hand-written Hopper kernel: the
  padded rows as ONE block of ``csrc/gram.cu::fused_block_gls_f32``
  (grid 1, Q = padded row count, Ka = K+2), replacing the TPU kernel
  ``pint_tpu/kernels/incremental.py::delta_gram_pallas``.

:func:`delta_gram` dispatches on ``precision``; ``"mixed"`` on a CUDA
tensor launches K1′ or raises — there is no fallback.

Where each piece runs: the rows and their Grams live on the rows'
device (the card on the streaming path). The K x K state — the
accumulators, the Cholesky factor, its rank-r update and the solve —
lives on the HOST in f64. It is a few dozen numbers: on the card the
rank-r update is r * K sequential column steps of a few tiny launches
each (thousands per append), on the host each step is a few float
operations. One device-to-host copy of the (K+2)^2 delta per append
replaces them. ``chip_smoke.py`` ``[stream] kernel`` times
both placements of :func:`chol_update`.

Parity is by CONSTRUCTION, not by tolerance: the incremental path and
the from-scratch comparator accumulate through the same sequential left
fold (:func:`fold_grams`, an explicit host loop — never ``torch.sum``,
whose reduction order on the card is not fixed) over the same blocks
computed by the same function (:func:`block_grams`, on equal shapes),
so in f64 the incremental ``(A, b, rNr)`` is bitwise the from-scratch
state. Under ``precision="mixed"`` the f32-widened delta is added to the
exact accumulators, exactly as in the JAX package, so a mixed lane is
not bitwise its f64 scratch comparator.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import DTYPE, resolve_device
from .fusedgls import augment, fused_block_gls_plain
from .gram import launch_gram

# appended-row counts (typically <= 64) are padded up to a multiple of
# this with winv=0 rows that whiten to zero (the JAX package's TPU
# sublane width; kept so both packages pad alike)
_SUBLANE = 8

# refinement-residual acceptance for the factored solve: above this
# the cached factor is declared stale and the solve re-routes through
# the exact thresholded eigh
_RELRES_TOL = 1e-12

# diagonal-collapse trigger for the rank-r factor update: if the
# updated factor's min/max diagonal ratio degrades below this
# fraction of the pre-update ratio, refactor from the exact A'.
_DIAG_DEGRADE = 1e-3


def _rows(X, r, winv, device=None):
    """(X, r, winv) as f64 tensors (on ``device`` when given, else where
    they are; numpy arrays, read-only ones included, are copied to the
    CPU first)."""
    def t(a):
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.array(a, dtype=np.float64))
        return a.to(device=device, dtype=DTYPE)

    return t(X), t(r), t(winv)


def pad_append_rows(X, r, winv, multiple=_SUBLANE):
    """Zero-pad appended rows up to ``multiple``. Padding rows carry
    ``winv=0`` so they whiten to zero and drop out of the Gram."""
    npad = (-X.shape[0]) % multiple
    if npad:
        X = torch.cat([X, X.new_zeros((npad, X.shape[1]))])
        r = torch.cat([r, r.new_zeros(npad)])
        winv = torch.cat([winv, winv.new_zeros(npad)])
    return X, r, winv


def delta_gram_ref(X, r, winv):
    """f64 reference: (K+2, K+2) whitened Gram of the appended rows
    ``[X | r | winv]`` (same augmented layout as fusedgls), on the
    rows' device."""
    X, r, winv = pad_append_rows(*_rows(X, r, winv))
    aug = augment(X, r, winv)
    return fused_block_gls_plain(aug, aug.shape[0])[0]


def delta_gram_plain(aug):
    """Plain version of K1′: the whitened Gram of the padded augmented
    rows (n_pad, K+2) as one block, in aug's dtype."""
    return fused_block_gls_plain(aug, aug.shape[0])[0]


def delta_gram_cuda(aug):
    """K1′ on the card: (n_pad, K+2) f32 contiguous CUDA rows -> their
    (K+2, K+2) f32 whitened Gram, one launch of csrc/gram.cu's fused
    kernel with the whole padded row set as its single block. Counts
    its launches in ``delta_gram_cuda.launches``, apart from K1's."""
    out = launch_gram("fused_block_gls_f32", aug, aug.shape[0])
    delta_gram_cuda.launches += 1
    return out[0]


delta_gram_cuda.launches = 0


def delta_gram_f32(X, r, winv):
    """The f32 Gram of the appended rows, widened to f64: the plain
    version for CPU rows, K1′ for CUDA rows."""
    X, r, winv = pad_append_rows(*_rows(X, r, winv))
    aug = augment(X, r, winv).to(torch.float32)
    if aug.device.type == "cpu":
        G = delta_gram_plain(aug)
    else:
        G = delta_gram_cuda(aug.contiguous())
    return G.to(DTYPE)


def delta_gram(X, r, winv, precision="f64"):
    """Dispatch the appended-rows Gram delta: ``"f64"`` takes the
    reference (the parity tier), ``"mixed"`` the f32 Gram (K1′ on the
    card)."""
    if precision == "mixed":
        return delta_gram_f32(X, r, winv)
    return delta_gram_ref(X, r, winv)


def chol_update(L, V):
    """Rank-r Cholesky update: returns ``L'`` with
    ``L' L'^T = L L^T + V V^T`` via r sequential rank-1 updates
    (Givens-style, Golub & Van Loan sec. 12.5). ``L`` (K, K) lower
    triangular, ``V`` (K, r). O(r K^2); never touches the N rows.

    Runs on the host in plain Python floats whatever the inputs' device
    (see the module docstring; at K <= 12 a numpy call per K-vector
    costs more than the arithmetic) and returns a tensor on L's device.
    Each column step is the JAX package's arithmetic, in the same IEEE
    f64 operations, on the entries below the diagonal (the others it
    leaves as they are)."""
    Ln = L.detach().cpu().tolist()
    K = len(Ln)
    for v in V.detach().cpu().mT.tolist():
        for j in range(K):
            ljj, vj = Ln[j][j], v[j]
            if ljj == 0.0:
                # the JAX arithmetic divides by zero here and leaves
                # non-finite entries, which the caller treats as a
                # degraded factor
                return torch.full_like(L, float("nan"))
            rad = math.sqrt(ljj * ljj + vj * vj)
            c = rad / ljj
            s = vj / ljj
            for i in range(j + 1, K):
                col = (Ln[i][j] + s * v[i]) / c
                v[i] = c * v[i] - s * col
                Ln[i][j] = col
            Ln[j][j] = rad
    return torch.tensor(Ln, dtype=L.dtype, device=L.device)


def _chol_solve(L, b):
    """Two triangular solves through the cached factor."""
    y = torch.linalg.solve_triangular(L, b[:, None], upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)[:, 0]


class IncrementalNormal:
    """Cached GLS normal state ``(A0, b, rNr, L)`` under row appends.

    ``A0`` is the accumulated design Gram WITHOUT the prior diagonal;
    ``q`` holds the prior weights and ``diag(q^2)`` is applied once, at
    factor/solve time, which keeps the addition sequence the one the
    from-scratch fold performs.

    ``L`` is the lower Cholesky factor of the full normal matrix,
    refreshed per append by the rank-r update with a condition-triggered
    full refactor. The exact accumulators are always carried alongside
    the factor, so a refactor (or the eigh fallback in :meth:`solve`)
    never loses information.

    The state is f64 on the host; ``device`` is where the appended rows'
    Grams run (the card by default)."""

    def __init__(self, A0, b, rNr, q=None, device="cuda"):
        self.device = resolve_device(device)

        def host(a):
            return torch.as_tensor(a, dtype=DTYPE).cpu()

        self.A0 = host(A0)
        self.b = host(b)
        self.rNr = host(rNr)
        k = self.A0.shape[0]
        self.q = torch.zeros(k, dtype=DTYPE) if q is None else host(q)
        self.n_appended = 0
        self.appends = 0
        self.refactors = 0
        self.L = self._refactor()

    @property
    def A(self):
        """The full normal matrix (prior applied once, here)."""
        return self.A0 + torch.diag(self.q * self.q)

    def _refactor(self):
        # torch.linalg.cholesky raises on a matrix that is not positive
        # definite; the JAX package's returns NaNs, which the callers
        # test for, so the port returns NaNs too
        L, info = torch.linalg.cholesky_ex(self.A)
        return L if int(info) == 0 else torch.full_like(L, float("nan"))

    @staticmethod
    def _diag_ratio(L):
        d = torch.abs(torch.diag(L))
        return float(torch.min(d) / torch.max(d))

    def append(self, X, r, winv, precision="f64"):
        """Fold appended rows in: additive Gram delta on the exact
        accumulators (computed on ``self.device``), rank-r update on the
        factor. Returns the (K+2, K+2) Gram delta (host f64)."""
        k = self.A0.shape[0]
        X, r, winv = _rows(X, r, winv, device="cpu")  # host, for V below
        G = delta_gram(X.to(self.device), r.to(self.device),
                       winv.to(self.device), precision=precision).cpu()
        self.A0 = self.A0 + G[:k, :k]
        self.b = self.b + G[:k, k]
        self.rNr = self.rNr + G[k, k]
        self.n_appended += int(X.shape[0])
        self.appends += 1
        if self.L is None:
            # a previous append left no usable factor (eigh regime);
            # try a fresh factorization of the exact updated A before
            # giving up on the fast path again
            L = self._refactor()
            self.refactors += 1
            self.L = L if bool(torch.all(torch.isfinite(L))) else None
            return G
        before = self._diag_ratio(self.L)
        # the factor update needs the whitened rows themselves, not the
        # Gram: dA = V V^T with V the (K, r) whitened design
        Xp, _, wp = pad_append_rows(X, r, winv)
        L = chol_update(self.L, (Xp * wp[:, None]).mT)
        after = self._diag_ratio(L)
        degraded = (not bool(torch.all(torch.isfinite(L)))
                    or after < _DIAG_DEGRADE * before)
        if degraded:
            L = self._refactor()
            self.refactors += 1
            if not bool(torch.all(torch.isfinite(L))):
                # exact A' itself is not SPD-factorable — the eigh
                # fallback in solve() owns this regime
                L = None
        self.L = L
        return G

    def solve(self, threshold=1e-12, refine=2):
        """Solve the accumulated normal equations.

        Fast path: triangular solves through the updated factor plus
        ``refine`` iterative-refinement sweeps against the exact ``A``.
        If the final relative residual exceeds the acceptance tol —
        stale or indefinite factor — solve with ``fitter.gls_eigh_solve``
        on the exact accumulators, the solver the from-scratch f64 fit
        uses. Returns ``(dx, chi2, info)``, dx a host f64 tensor."""
        from ..fitter import gls_eigh_solve

        A = self.A
        dx = None
        relres = float("inf")
        if self.L is not None:
            dx = _chol_solve(self.L, self.b)
            for _ in range(refine):
                dx = dx + _chol_solve(self.L, self.b - A @ dx)
            bnorm = float(torch.linalg.norm(self.b))
            resid = float(torch.linalg.norm(self.b - A @ dx))
            relres = resid / bnorm if bnorm > 0 else resid
        solver = "chol_update"
        if dx is None or not bool(torch.all(torch.isfinite(dx))) \
                or not relres <= _RELRES_TOL:
            dx, _ = gls_eigh_solve(A, self.b, threshold=threshold)
            solver = "eigh_refresh"
        chi2 = float(self.rNr) - float(self.b @ dx)
        return dx, chi2, {"solver": solver, "relres": relres,
                          "refactors": self.refactors,
                          "appends": self.appends,
                          "n_appended": self.n_appended}


def block_grams(X, r, winv, block):
    """(nb, K+2, K+2) f64 per-block Grams over rows padded (with winv=0)
    to a ``block`` multiple, on the rows' device — the canonical
    partition both the incremental base state and the from-scratch
    comparator fold over."""
    X, r, winv = pad_append_rows(X, r, winv, multiple=block)
    return fused_block_gls_plain(augment(X, r, winv), block)


def fold_grams(grams):
    """Sequential LEFT fold of per-block Grams, on the host. This is the
    single accumulation-order authority for the bit-identity contract:
    the fold over ``[base blocks..., d1, d2, ...]`` performs the exact
    addition sequence ``((fold(base) + d1) + d2) + ...`` that per-append
    delta application performs, so a reduction whose order is not fixed
    must never replace it."""
    grams = grams.cpu()
    G = grams[0]
    for g in grams[1:]:
        G = G + g
    return G


def scratch_normal(chunks, block, device="cuda"):
    """From-scratch fused comparator over ``chunks`` — a list of
    ``(X, r, winv)`` row groups: the base rows first, then one chunk
    per append in arrival order. The base streams through at ``block``
    granularity; each append chunk is its own sublane-padded block
    (exactly what :func:`delta_gram_ref` computed at append time).
    Returns ``(A0, b0, rNr)`` WITHOUT the prior diagonal, on the host."""
    dev = resolve_device(device)
    base = _rows(*chunks[0], device=dev)
    grams = [block_grams(*base, block=block)]
    for chunk in chunks[1:]:
        X, r, winv = pad_append_rows(*_rows(*chunk, device=dev))
        grams.append(block_grams(X, r, winv, block=X.shape[0]))
    G = fold_grams(torch.cat(grams))
    k = base[0].shape[1]
    return G[:k, :k], G[:k, k], G[k, k]


def build_normal(X, r, winv, q, block=1024, device="cuda"):
    """Build the cached :class:`IncrementalNormal` base state from a
    full row set: f64 per-block Grams on ``device``, left-folded on the
    host, prior diagonal ``diag(q^2)`` added once at factor time."""
    dev = resolve_device(device)
    X, r, winv = _rows(X, r, winv, device=dev)
    G = fold_grams(block_grams(X, r, winv, block=block))
    k = X.shape[1]
    return IncrementalNormal(G[:k, :k], G[:k, k], G[k, k], q=q, device=dev)


def scratch_refit(chunks, q, block=1024, threshold=1e-12, refine=2,
                  device="cuda"):
    """The full from-scratch refit the incremental path is held to:
    :func:`scratch_normal` over all chunks, prior diagonal, the SAME
    deterministic solve."""
    A0, b0, rNr = scratch_normal(chunks, block, device=device)
    state = IncrementalNormal(A0, b0, rNr, q=q, device=device)
    dx, chi2, info = state.solve(threshold=threshold, refine=refine)
    return dx, chi2, state, info
