"""Multi-process initialization for PTA fleets (counterpart of the JAX
package's ``parallel/distributed.py``), on ``torch.distributed``.

A pulsar-axis fleet needs one collective: the gather of the fit
results. Per-pulsar fits do not couple, so each process packs and fits
its own contiguous slice of the pulsars on its own device, and the
finalize's pull gathers every rank's rows in rank order
(:func:`gather_rows`, an ``all_gather_object`` of host arrays). gloo
carries that gather on any machine; NCCL needs one card per rank, so a
caller asks for it by name (``backend="nccl"``).

- :func:`initialize_distributed`: ``torch.distributed.init_process_group``
  with environment defaults and a handshake watchdog, safe to call in a
  single process (world size 1).
- :func:`process_pulsar_slice`: which pulsars THIS process loads and
  packs.
- :func:`global_pulsar_mesh`: the 1-D 'pulsar' mesh of this process's
  device — its part of the fleet's mesh (torch sees no other process's
  devices).
- :func:`assemble_global_batch`: turn this process's ``PTABatch`` into
  its part of the fleet-global batch: every rank checks that the ranks
  agree (pulsar count, ECORR mode, padded shapes), and the batch's fits
  return the global rows on every rank.

Recipe: initialize on every process, slice the pulsar list with
process_pulsar_slice, build the local PTABatch (padded to a common
fleet-wide TOA count), assemble it, fit.
"""

from __future__ import annotations

import datetime
import os
import threading
import time
import zlib

import numpy as np
import torch
import torch.distributed as dist

_ENV = {"address": "PINT_TPU_COORDINATOR_ADDRESS",
        "num_processes": "PINT_TPU_NUM_PROCESSES",
        "process_id": "PINT_TPU_PROCESS_ID",
        "timeout_s": "PINT_TPU_COORDINATOR_TIMEOUT_S"}


def _rank_world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, local_device_ids=None,
                           timeout_s=None, backend="gloo"):
    """Initialize the default process group; idempotent. Returns
    (process_id, num_processes).

    Arguments left as None fall back to the environment:
    ``PINT_TPU_COORDINATOR_ADDRESS`` ("host:port", or a ``tcp://`` /
    ``file://`` URL), ``PINT_TPU_NUM_PROCESSES``,
    ``PINT_TPU_PROCESS_ID``, ``PINT_TPU_COORDINATOR_TIMEOUT_S``; with no
    address at all torch's own ``env://`` rendezvous reads MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE and RANK, so a launcher's settings keep
    working. ``local_device_ids`` picks this process's CUDA device.

    ``timeout_s`` bounds the handshake: an unreachable coordinator
    otherwise blocks for torch's own long default. On timeout a
    TimeoutError names the address, this process's id and the wait;
    the watchdog's worker is a daemon thread, so a worker stuck in the
    rendezvous cannot keep the interpreter alive."""
    if dist.is_initialized():
        return _rank_world()
    env = os.environ
    if num_processes is None and _ENV["num_processes"] in env:
        num_processes = int(env[_ENV["num_processes"]])
    if process_id is None and _ENV["process_id"] in env:
        process_id = int(env[_ENV["process_id"]])
    if coordinator_address is None:
        coordinator_address = env.get(_ENV["address"])
    if timeout_s is None and _ENV["timeout_s"] in env:
        timeout_s = float(env[_ENV["timeout_s"]])
    if local_device_ids:
        torch.cuda.set_device(int(local_device_ids[0]))
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = "tcp://" + coordinator_address
    kw = {"backend": backend, "init_method": init_method}
    if num_processes is not None:
        kw["world_size"] = int(num_processes)
    if process_id is not None:
        kw["rank"] = int(process_id)
    if timeout_s is not None:
        # the group's own bound, past the watchdog's, so ours fires
        # first with a message that names the rendezvous
        kw["timeout"] = datetime.timedelta(seconds=float(timeout_s) + 30)

    if timeout_s is None:
        dist.init_process_group(**kw)
        return _rank_world()
    outcome = {}

    def _worker():
        try:
            dist.init_process_group(**kw)
            outcome["ok"] = True
        except Exception as e:  # surfaced in the caller below
            outcome["error"] = e

    t0 = time.monotonic()
    worker = threading.Thread(target=_worker, daemon=True,
                              name="pint-tpu-dist-init")
    worker.start()
    worker.join(timeout_s)
    elapsed = time.monotonic() - t0
    if worker.is_alive():
        raise TimeoutError(
            f"torch.distributed.init_process_group did not complete "
            f"within {timeout_s:.1f}s (waited {elapsed:.1f}s): "
            f"coordinator {coordinator_address!r} unreachable or not "
            f"every process joined (this process_id={process_id}, "
            f"num_processes={num_processes}). Check the address/port and "
            "that all processes launched; raise "
            "PINT_TPU_COORDINATOR_TIMEOUT_S if the cluster is just slow.")
    if "error" in outcome:
        raise outcome["error"]
    return _rank_world()


def process_pulsar_slice(n_pulsars, process_id=None, num_processes=None):
    """Contiguous slice of pulsar indices THIS process loads and packs:
    ceil(n / num_processes) each, in rank order, so the ranks' rows
    concatenate into the global pulsar order."""
    pid, nproc = _rank_world()
    pid = pid if process_id is None else process_id
    nproc = nproc if num_processes is None else num_processes
    per = -(-n_pulsars // nproc)  # ceil
    lo = min(pid * per, n_pulsars)
    hi = min(lo + per, n_pulsars)
    return slice(lo, hi)


def global_pulsar_mesh(device="cuda"):
    """1-D 'pulsar' mesh of this process's device: its part of the
    fleet's mesh (the process group joins the parts). ``device`` is the
    card unless the caller names the CPU; with CUDA it is the current
    device (``local_device_ids``)."""
    from .. import resolve_device
    from .mesh import make_mesh

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return make_mesh(devices=[dev])


def gather_rows(arrays):
    """Every rank's host arrays, concatenated along axis 0 in rank order
    on every rank (the fleet's one collective). Identity at world size
    1."""
    _, world = _rank_world()
    if world == 1:
        return list(arrays)
    parts = [None] * world
    dist.all_gather_object(parts, [np.asarray(a) for a in arrays])
    return [np.concatenate(a) for a in zip(*parts)]


def assemble_global_batch(local_pta, mesh=None):
    """Make this process's ``PTABatch`` its part of the fleet-global
    batch.

    Every process builds a PTABatch for ITS pulsars (the contiguous
    ``process_pulsar_slice`` block, in global order) and calls this.
    The ranks then agree on what the fit programs depend on: the same
    pulsar count on every rank, one ECORR treatment (any rank with
    overlapping masks densifies the others; any rank that cannot
    marginalize makes all take the dense solve) and the same padded
    array shapes (a CRC of every leaf's shape) — a mismatch raises
    here, not as a wrong result later. ``n_toas`` becomes the global
    per-pulsar counts, and the batch's fits return every rank's rows in
    global order on every rank (:func:`gather_rows` in the finalize's
    pull); ``models`` stays local, labelled from ``_pulsar_offset``.

    Requirements: the same model structure everywhere (as within any
    PTABatch) and the same padded shapes: pad ragged fleets to a common
    fleet-wide TOA count (``pad_toas``) before packing.

    Returns the same PTABatch, changed in place.
    """
    from .sharded import ShardedBatch

    if local_pta._pack or isinstance(local_pta, ShardedBatch):
        raise ValueError("assemble_global_batch takes an unpacked, "
                         "unsharded batch")
    _, world = _rank_world()
    ok_local = bool("ecorr_eidx" in local_pta.prep
                    and local_pta.prep["ecorr_owner"].shape[-1] > 0)
    if world > 1:
        n_local = local_pta.n_pulsars
        has_dense = "ecorr_U" in local_pta.prep
        counts = [None] * world
        dist.all_gather_object(counts, (n_local, ok_local, has_dense))
        if any(c[0] != n_local for c in counts):
            raise ValueError(
                "assemble_global_batch needs the same pulsar count on "
                f"every process (even 'pulsar'-axis shards); got "
                f"{[c[0] for c in counts]} — pad the fleet to a multiple "
                "of the process count")
        # every rank must run the SAME program: if any slice packed the
        # dense ECORR basis (overlapping masks), sparse slices densify
        if any(c[2] for c in counts) and "ecorr_eidx" in local_pta.prep:
            prep = dict(local_pta.prep)
            k = prep["ecorr_owner"].shape[-1]
            eidx = prep.pop("ecorr_eidx")
            prep["ecorr_U"] = (eidx[..., None] == torch.arange(
                k, device=eidx.device)).to(torch.float64)
            local_pta.prep = prep
        local_pta._ecorr_marg_ok = all(c[1] for c in counts)
        # differing padded shapes would mean different programs per
        # rank: compare a shape signature up front and fail loud
        sig = zlib.crc32(repr(local_pta.shape_signature()).encode())
        sigs = [None] * world
        dist.all_gather_object(sigs, sig)
        if any(s != sig for s in sigs):
            raise ValueError(
                "assemble_global_batch: packed array shapes differ "
                "across processes (ragged TOA/epoch/basis maxima) — "
                "pad every process's pack to common fleet-wide maxima")
        rank = dist.get_rank()
        local_pta._pulsar_offset = rank * n_local
        local_pta.n_toas = np.concatenate(
            gather_rows([np.asarray(local_pta.n_toas)]))
        local_pta._world = world
    else:
        local_pta._ecorr_marg_ok = ok_local
    local_pta.mesh = mesh if mesh is not None else global_pulsar_mesh(
        local_pta.device)
    local_pta._x0_cache = None
    local_pta._fns = {}
    return local_pta
