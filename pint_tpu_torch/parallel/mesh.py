"""Device meshes for PTA-scale fits (counterpart of the JAX package's
``parallel/mesh.py``).

Torch has no GSPMD, so a mesh here is data: an array of
``torch.device`` entries with axis names ("pulsar", "toa"). A sharded
program runs once per shard on that shard's device, and partial sums
cross devices by an explicit reduction in a fixed shard order
(:func:`ordered_sum`, the port's ``psum``; no atomics, so a result
repeats bitwise). Per-pulsar fits ride the "pulsar" axis with no
reduction at all; the TOA axis of a long single-pulsar dataset
(``toa_shard.py``) reduces the few cross-TOA couplings. Devices may
repeat: four logical lanes on one card, or on the CPU, are a valid
mesh.
"""

from __future__ import annotations

import numpy as np
import torch


class Mesh:
    """An n-D grid of torch devices with named axes. ``devices`` is a
    numpy object array; ``shape`` maps axis name -> size."""

    def __init__(self, devices, axis_names):
        grid = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if grid.ndim != len(self.axis_names):
            raise ValueError(f"{grid.ndim}-D device grid for axes "
                             f"{self.axis_names}")
        self.devices = np.empty(grid.shape, dtype=object)
        for idx in np.ndindex(grid.shape):
            self.devices[idx] = torch.device(grid[idx])
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    def axis_size(self, name):
        """Size of axis ``name`` (1 when the mesh has no such axis)."""
        return int(self.shape.get(name, 1))

    def __repr__(self):
        return (f"Mesh({[str(d) for d in self.devices.flat]}, "
                f"shape={self.shape})")


def _default_devices():
    """Every CUDA device of this process (the JAX package's
    ``jax.devices()``); raises without a card, as every entry point
    does unless the caller names the CPU."""
    from .. import resolve_device

    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_pulsar_shards=None, devices=None) -> Mesh:
    """1-D 'pulsar' mesh over ``devices`` (default: every CUDA device)."""
    devices = list(devices) if devices is not None else _default_devices()
    n = n_pulsar_shards or len(devices)
    return Mesh(devices[:n], axis_names=("pulsar",))


def lane_meshes(devices=None):
    """One single-device 1-D 'pulsar' mesh PER device, in device order:
    the per-device failure domains ``fleetmesh.DeviceLane`` wraps. A
    bucket fit placed on one of them touches exactly one device, so
    losing it poisons that lane's buckets and nothing else."""
    devices = list(devices) if devices is not None else _default_devices()
    return [Mesh([d], axis_names=("pulsar",)) for d in devices]


def make_mesh2d(n_pulsar_shards, n_toa_shards, devices=None) -> Mesh:
    """2-D ('pulsar', 'toa') mesh: pulsar data parallelism combined with
    TOA-axis sharding inside each pulsar shard."""
    devices = list(devices) if devices is not None else _default_devices()
    n = n_pulsar_shards * n_toa_shards
    if len(devices) < n:
        raise ValueError(f"mesh {n_pulsar_shards}x{n_toa_shards} needs "
                         f"{n} devices, have {len(devices)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices[:n]
    return Mesh(grid.reshape(n_pulsar_shards, n_toa_shards),
                axis_names=("pulsar", "toa"))


def pulsar_slices(n, n_shards):
    """Contiguous slices of ``n`` pulsars over ``n_shards`` shards:
    ceil(n / n_shards) each in order, the last one short, empty shards
    dropped (``distributed.process_pulsar_slice``'s rule)."""
    per = -(-int(n) // max(int(n_shards), 1))
    return [slice(lo, min(lo + per, n)) for lo in range(0, int(n), per)]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _put(x, device, index=None):
    if isinstance(x, np.ndarray):
        x = torch.as_tensor(x)
    if not isinstance(x, torch.Tensor):
        return x
    if index is not None:
        x = x[index]
    return x.to(device)


def shard_batch(tree, mesh: Mesh, n_toa=None):
    """Split a stacked per-pulsar tree (dicts, tuples, NamedTuples of
    tensors or numpy arrays) over ``mesh``: contiguous pulsar shards
    (:func:`pulsar_slices`) along axis 0. On a 2-D ('pulsar', 'toa')
    mesh, leaves whose SECOND axis is the padded TOA axis (length
    ``n_toa``, divisible by the toa mesh size) are split along it too;
    every other leaf is copied whole to each toa shard. Returns
    ``[(pulsar_slice, [subtree per toa shard])]``, each subtree on its
    mesh device."""
    n_p = mesh.axis_size("pulsar")
    n_t = mesh.axis_size("toa")
    grid = mesh.devices.reshape(n_p, n_t)
    leaves = []
    _map(lambda x: leaves.append(x), tree)
    n = next(int(np.shape(x)[0]) for x in leaves if np.ndim(x) >= 1)
    out = []
    for i, ps in enumerate(pulsar_slices(n, n_p)):
        subs = []
        for j in range(n_t):
            def put(x, ps=ps, j=j, dev=grid[i, j]):
                if np.ndim(x) < 1:
                    return _put(x, dev)
                if (n_t > 1 and n_toa and np.ndim(x) >= 2
                        and np.shape(x)[1] == n_toa and n_toa % n_t == 0):
                    w = n_toa // n_t
                    return _put(x, dev, (ps, slice(j * w, (j + 1) * w)))
                return _put(x, dev, ps)

            subs.append(_map(put, tree))
        out.append((ps, subs))
    return out


def replicate(tree, mesh: Mesh):
    """A copy of ``tree`` on every device of ``mesh``, in flat order."""
    return [_map(lambda x, d=d: _put(x, d), tree) for d in mesh.devices.flat]


def ordered_sum(parts, device=None):
    """Sum of per-shard partials in shard order on one device (the
    first part's unless given): the port's ``psum``, with a fixed
    reduction order so a sharded result repeats bitwise."""
    device = parts[0].device if device is None else torch.device(device)
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total


def ordered_max(parts, device=None):
    """Element-wise maximum of per-shard partials (the port's
    ``pmax``), gathered on one device."""
    device = parts[0].device if device is None else torch.device(device)
    total = parts[0].to(device)
    for p in parts[1:]:
        total = torch.maximum(total, p.to(device))
    return total
