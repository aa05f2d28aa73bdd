"""Fit programs captured as CUDA graphs: the port's counterpart of the
JAX package's compiled executables (``fitter.aot_*``, the fleet's
``precompile`` and pipelined executor).

A fit program is a closure ``fit(x0)`` over a batch's device tensors.
:class:`Program` runs it eagerly, as every fit did before the executor
was ported. :class:`GraphProgram` warms it up on a side stream, then
captures it into CUDA graphs, so a fit becomes a few graph launches
instead of thousands of kernel launches from Python.

What runs in a graph and what runs eagerly is fixed here, not decided
at run time. ATen checks the ``info`` tensor of ``torch.linalg.eigh``
and ``torch.linalg.svd`` on the host after every call (a device->host
read of the LAPACK status), and a host read is illegal while a stream
captures. So the solve core calls these two through :func:`eager`: in a
capture, :func:`eager` closes the current graph, replays it so its
outputs hold real values, runs the factorization eagerly, and opens the
next graph, which reads the factorization's outputs. A program is thus
``graph, eager op, graph, ..., graph``; a replay runs the pieces in
that order on the current stream and copies each eager op's fresh
outputs into the tensors the next graph reads. Each eager op still
waits for the device once, as it does in an eager fit.

Bookkeeping that the capture changes:

- Launch counts: the kernel wrappers count launches in Python, and a
  replay calls no Python. The capture subtracts what the wrappers
  counted while capturing (nothing launched then) and a replay adds
  each graph's captured launches back, once per replay.
- Outputs: a replay rewrites the same static tensors, so a call
  returns clones.
- Memory: every graph draws on the pool of the programs alive on its
  device (:func:`pool`; the first capture after all of them are freed
  opens a new one, since a pool dies with its last graph). Two programs
  may then share memory for their intermediates, which is safe while
  replays run one at a time on one stream — the fleet dispatches from
  the caller's thread only.
"""

from __future__ import annotations

import threading
import time
import weakref

import torch

_STATE = threading.local()
_LIVE = weakref.WeakSet()  # captured GraphPrograms


def pool(device):
    """The graph memory pool that the live programs on ``device`` share,
    or None when there is none (the next capture opens one)."""
    for prog in list(_LIVE):
        if prog.device == device:
            return prog.pool
    return None


def counters():
    """The kernel wrappers whose ``launches`` a capture must keep
    honest."""
    from .kernels import (fused_block_gls_cuda, block_grams_cuda,
                          harmonic_sums_cuda, pair_products_cuda)
    from .kernels.incremental import delta_gram_cuda

    return (fused_block_gls_cuda, block_grams_cuda, pair_products_cuda,
            delta_gram_cuda, harmonic_sums_cuda)


def eager(fn, *args, **kw):
    """``fn(*args, **kw)``; inside a capture, run it eagerly between two
    graphs (see the module docstring). Its tensor arguments must come
    from the program (the graph before it) and it must return a tensor
    or a tuple of tensors."""
    rec = getattr(_STATE, "recording", None)
    if rec is None:
        return fn(*args, **kw)
    return rec.eager(fn, args, kw)


def _tree_map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    return fn(tree)


class Program:
    """A fit program run eagerly: what a bucket's program table holds
    until it is captured, and always on the CPU."""

    captured = False
    launches = {}
    layout = []

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, x0):
        with torch.no_grad():
            return self.fn(x0)


class _Recording:
    """The capture of one program: its graphs and eager ops in order."""

    def __init__(self, mempool):
        self.pool = mempool
        self.pieces = []  # ("graph", CUDAGraph, counts) | ("eager", ...)
        self.wrappers = counters()
        self.graph = None

    def begin(self):
        self.before = [w.launches for w in self.wrappers]
        self.graph = torch.cuda.CUDAGraph()
        self.graph.capture_begin(pool=self.pool)

    def end(self):
        self.graph.capture_end()
        if self.pool is None:  # the first graph opened a pool
            self.pool = self.graph.pool()
        counts = []
        for w, b in zip(self.wrappers, self.before):
            counts.append(w.launches - b)
            w.launches = b  # nothing ran while capturing
        piece = ("graph", self.graph, tuple(counts))
        self.pieces.append(piece)
        self.graph = None
        _run(piece, self.wrappers)  # the next piece reads real values

    def eager(self, fn, args, kw):
        self.end()
        out = fn(*args, **kw)
        self.pieces.append(("eager", fn, args, kw, out))
        self.begin()
        return out


def _run(piece, wrappers):
    if piece[0] == "graph":
        piece[1].replay()
        for w, n in zip(wrappers, piece[2]):
            w.launches += n
    else:
        _, fn, args, kw, out = piece
        fresh = fn(*args, **kw)
        for o, f in zip(_as_tuple(out), _as_tuple(fresh)):
            o.copy_(f)


def _as_tuple(out):
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


class GraphProgram:
    """A fit program captured at ``x0``'s shape as CUDA graphs with its
    eager ops between them (see the module docstring). ``capture_s`` is
    the capture's host wall, warm-up included. A call copies ``x0``
    into the captured input, replays the pieces in order and returns
    clones of the outputs. A failed capture raises: there is no eager
    fallback."""

    captured = True

    def __init__(self, fn, x0):
        dev = x0.device
        if dev.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA tensor, got {dev}")
        t0 = time.perf_counter()
        self.device = dev
        main = torch.cuda.current_stream(dev)
        self.x0 = x0.clone()
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(main)
        with torch.no_grad(), torch.cuda.stream(side):
            # warm-up: library handles and workspaces, the Gram wrappers'
            # occupancy query and launch plans, all before the capture
            fn(self.x0)
        torch.cuda.synchronize(dev)
        rec = _Recording(pool(dev))
        _STATE.recording = rec
        try:
            with torch.no_grad(), torch.cuda.stream(side):
                rec.begin()
                self.out = fn(self.x0)
                rec.end()
        finally:
            _STATE.recording = None
            if rec.graph is not None:
                # the capture raised: end it and let its error propagate
                try:
                    rec.graph.capture_end()
                except Exception:  # noqa: BLE001
                    pass
        main.wait_stream(side)
        torch.cuda.synchronize(dev)
        self.pieces = rec.pieces
        self.wrappers = rec.wrappers
        self.pool = rec.pool
        _LIVE.add(self)
        self.launches = {}
        for p in self.pieces:
            if p[0] == "graph":
                for w, n in zip(self.wrappers, p[2]):
                    if n:
                        self.launches[w.__name__] = (
                            self.launches.get(w.__name__, 0) + n)
        self.capture_s = time.perf_counter() - t0

    @property
    def layout(self):
        """The pieces in order: "graph", or the name of an eager op."""
        return ["graph" if p[0] == "graph"
                else getattr(p[1], "__name__", repr(p[1]))
                for p in self.pieces]

    def __call__(self, x0):
        if x0 is not self.x0:
            self.x0.copy_(x0)
        for p in self.pieces:
            _run(p, self.wrappers)
        return _tree_map(torch.clone, self.out)
