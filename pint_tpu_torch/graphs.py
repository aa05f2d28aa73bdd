"""Fit programs captured as CUDA graphs: the port's counterpart of the
JAX package's compiled executables (``fitter.aot_*``, the fleet's
``precompile`` and pipelined executor).

A fit program is a function ``fit(x0, *data)`` of the start vectors
and the device tensors of the batch that runs it (``PTABatch._leaves``:
params, prep, TOA fields), the torch counterpart of a jitted function
called with ``(params, batch, prep)``. :class:`Program` runs it
eagerly, as every fit did before the executor was ported.
:class:`GraphProgram` warms it up on a side stream, then captures it
into CUDA graphs, so a fit becomes a few graph launches instead of
thousands of kernel launches from Python. A captured program reads
private copies of the data it was captured on; a call with another
batch's tensors copies them in first, so a program cached for one
batch and handed to another (the serve engine's executable cache)
fits the batch that calls it.

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
  may then share memory for their intermediates.
- Threads: a call writes the program's private inputs, replays graphs
  whose intermediates may share memory with another program's, and
  clones the outputs, so no two may overlap. Every capture and every
  call holds one lock of the process (``_LOCK``) from its first copy to
  its last clone, and its device work first waits for the event that
  the one before it recorded (``_after_last``), so that the work of
  callers on different streams runs in turn on the card too. A fleet
  fitting on one thread and a serve engine flushing on another thus
  each get their own batch's fit. A capture runs in ``thread_local``
  mode: another thread's eager work (an uncaptured program, a K1′
  append) may go on while it captures.
"""

from __future__ import annotations

import threading
import time
import weakref

import torch

_STATE = threading.local()
_LIVE = weakref.WeakSet()  # captured GraphPrograms
_LOCK = threading.RLock()  # held by every capture and every call
_DONE = {}  # device -> event recorded after the last capture or call


def _after_last(stream):
    """Make ``stream`` wait for the device work of the last capture or
    call on its device (hold ``_LOCK``)."""
    done = _DONE.get(stream.device)
    if done is not None:
        stream.wait_event(done)


def _done_event(stream):
    """An event recorded after the work queued on ``stream``: a capture
    or call stores it in ``_DONE`` under ``_LOCK``."""
    done = torch.cuda.Event()
    done.record(stream)
    return done


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


def _data_map(fn, tree):
    """``fn`` over the tensors of a data tree (dicts, tuples, lists and
    namedtuples of tensors), keeping its structure."""
    if isinstance(tree, dict):
        return {k: _data_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_data_map(fn, t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_data_map(fn, t) for t in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _data_leaves(tree):
    """The tensors of a data tree in a fixed order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _data_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _data_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def capturable(x0, data):
    """True when a program of ``x0`` and the data tree ``data`` can be
    captured: ``x0`` on a CUDA device and every tensor of ``data`` on
    it (a CUDA graph records one device's stream)."""
    dev = x0.device
    return dev.type == "cuda" and all(t.device == dev
                                      for t in _data_leaves(data))


class Program:
    """A program run eagerly on the arguments of each call: what a
    bucket's program table holds until it is captured, and always on
    the CPU."""

    captured = False
    launches = {}
    layout = []

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, *args):
        with torch.no_grad():
            return self.fn(*args)


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
        self.graph.capture_begin(pool=self.pool,
                                 capture_error_mode="thread_local")

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
    """A program ``fn(x0, *data)`` captured at the shapes of ``x0`` and
    ``data`` as CUDA graphs with its eager ops between them (see the
    module docstring). The graphs read private copies of ``x0`` and of
    every tensor of ``data``. ``capture_s`` is the capture's host wall,
    warm-up included. A call copies ``x0`` into its copy, and each data
    tensor unless it is the tensor last copied in (or captured on) and
    has not been written since; it then replays the pieces in order and
    returns clones of the outputs. ``copied_bytes`` counts the data
    bytes the calls copied. Captures and calls run one at a time in the
    process (the module docstring's threads). A failed capture raises:
    there is no eager fallback."""

    captured = True

    def __init__(self, fn, x0, *data):
        dev = x0.device
        if dev.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA tensor, got {dev}")
        with _LOCK:
            main = self._capture(fn, x0, data)
            _DONE[dev] = _done_event(main)
            _LIVE.add(self)

    def _capture(self, fn, x0, data):
        dev = x0.device
        t0 = time.perf_counter()
        self.device = dev
        main = torch.cuda.current_stream(dev)
        _after_last(main)
        self.x0 = x0.clone()
        self.data = _data_map(torch.clone, data)
        self._inputs = _data_leaves(self.data)
        self._loaded = [(weakref.ref(t), t._version)
                        for t in _data_leaves(data)]
        self.copied_bytes = 0
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(main)
        with torch.no_grad(), torch.cuda.stream(side):
            # warm-up: library handles and workspaces, the Gram wrappers'
            # occupancy query and launch plans, all before the capture
            fn(self.x0, *self.data)
        torch.cuda.synchronize(dev)
        rec = _Recording(pool(dev))
        _STATE.recording = rec
        try:
            with torch.no_grad(), torch.cuda.stream(side):
                rec.begin()
                self.out = fn(self.x0, *self.data)
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
        self.launches = {}
        for p in self.pieces:
            if p[0] == "graph":
                for w, n in zip(self.wrappers, p[2]):
                    if n:
                        self.launches[w.__name__] = (
                            self.launches.get(w.__name__, 0) + n)
        self.capture_s = time.perf_counter() - t0
        return main

    @property
    def layout(self):
        """The pieces in order: "graph", or the name of an eager op."""
        return ["graph" if p[0] == "graph"
                else getattr(p[1], "__name__", repr(p[1]))
                for p in self.pieces]

    def load(self, x0, *data):
        """Copy a call's inputs into the captured ones (see the class
        docstring); returns the data bytes copied. Hold ``_LOCK`` until
        the replay that reads them has been queued."""
        if x0 is not self.x0:
            self.x0.copy_(x0)
        leaves = _data_leaves(data)
        if len(leaves) != len(self._inputs):
            raise ValueError(f"program captured on {len(self._inputs)} "
                             f"data tensors, called with {len(leaves)}")
        copied = 0
        for i, (dst, src) in enumerate(zip(self._inputs, leaves)):
            ref, version = self._loaded[i]
            if ref() is src and src._version == version:
                continue
            dst.copy_(src)
            self._loaded[i] = (weakref.ref(src), src._version)
            copied += src.numel() * src.element_size()
        self.copied_bytes += copied
        return copied

    def __call__(self, x0, *data):
        with _LOCK:
            stream = torch.cuda.current_stream(self.device)
            _after_last(stream)
            self.load(x0, *data)
            for p in self.pieces:
                _run(p, self.wrappers)
            out = _tree_map(torch.clone, self.out)
            _DONE[stream.device] = _done_event(stream)
        return out
