"""Distributed failure domains: the shape-planned fleet spread over
device lanes, with per-device health and recovery (counterpart of the
JAX package's ``parallel/fleetmesh.py``).

Each device is wrapped in a :class:`DeviceLane` owning its OWN
``HealthMonitor`` and ``CircuitBreaker``, and every shape-plan bucket is
dispatched to exactly one lane: its ``PTABatch`` is built on the lane's
device, so a bucket program touches one device and a lost, hung or
straggling device poisons that lane's buckets and nothing else. A PTA
fit needs no cross-device coupling (per-pulsar fits do not couple; the
TOA-axis reduction path lives in ``toa_shard`` and gets the same
watchdog through :func:`run_watched`). Lanes may name the same device:
four logical lanes on one card are four failure domains of the
bookkeeping, not four cards.

Failure handling, in order of escalation:

- ``straggler_delay`` (injected) / a genuinely slow lane: the bucket is
  late, the lane's health notes the flush, nothing fails.
- ``collective_timeout`` / a hung result pull: :func:`run_watched`
  bounds every blocking pull (the finalize's ``.cpu()`` copy) with a
  daemon-thread watchdog, so a hang surfaces as a catchable
  :class:`CollectiveTimeout`; the lane's breaker records the strike and
  the bucket retries (a tripped breaker quarantines the lane).
- ``device_loss`` / :class:`DeviceLost`: the lane is quarantined at
  once, its pending buckets are re-assigned to the surviving lanes in a
  deterministic order (canonical bucket order round-robined over the
  surviving lane indices: a pure function of the completed set and the
  survivor set), and the failed bucket re-runs on a survivor.
- a bucket that fails on a HEALTHY lane (poisoned pulsar, persistent
  solver fault): bisected down to singletons as the serve engine's lane
  quarantine does; the pathological pulsars are quarantined with NaN
  results, their neighbours complete.

Progress is checkpointable per bucket (``checkpoint.FitCheckpointer``,
CRC + rotation): an interrupted fleet fit resumes from the last
completed bucket with bit-identical final parameters.

A bucket's batch is cached per (bucket, lane index), not per device: a
stolen bucket is rebuilt (and, on the card, captured again) on its new
lane even when that lane names the same device, as a second card would
need.
"""

from __future__ import annotations

import threading
import time
import warnings
import zlib

import numpy as np

from ..obs import trace as obs_trace
from ..obs.recorder import RECORDER as _flight
from ..resilience import faultinject
from ..resilience.faultinject import FaultInjected
from ..resilience.health import HealthMonitor
from ..resilience.retry import CircuitBreaker


class DeviceLost(RuntimeError):
    """A device in the fleet mesh died (injected through the
    ``device_loss`` fault point, or raised by a caller that detected a
    real device loss). Never retryable on the SAME lane: the handling
    is quarantine + work stealing, not backoff."""


class CollectiveTimeout(TimeoutError):
    """A cross-device reduction or device result pull exceeded the
    watchdog bound. A TimeoutError, so ``retry.is_retryable`` treats it
    as transient: the bucket retries on a (possibly different) lane
    while the breaker counts the lane's strikes."""


def run_watched(fn, timeout_s, what="collective"):
    """Run ``fn()`` under a watchdog: a wedged device pull cannot be
    interrupted from Python, so the call runs in a daemon worker thread
    and the caller bounds the join. On timeout a catchable
    :class:`CollectiveTimeout` names the site; the abandoned worker is a
    daemon and cannot keep the interpreter alive."""
    if timeout_s is None:
        return fn()
    out = {}

    def _worker():
        try:
            out["value"] = fn()
        except Exception as e:  # surfaced in the caller below
            out["error"] = e

    worker = threading.Thread(target=_worker, daemon=True,
                              name="pint-tpu-collective-watchdog")
    worker.start()
    worker.join(timeout_s)
    if worker.is_alive():
        raise CollectiveTimeout(
            f"{what} did not complete within {timeout_s:.1f}s "
            "(hung collective or wedged device); the lane's breaker "
            "records this and the bucket is re-dispatched")
    if "error" in out:
        raise out["error"]
    return out["value"]


class DeviceLane:
    """One device of the fleet as an independent failure domain: the
    device, its single-device 'pulsar' mesh, and its OWN HealthMonitor +
    CircuitBreaker (keyed by ``self.key``). The fleet quarantines a lane,
    and steals its pending buckets, when the breaker trips or health
    reaches draining."""

    def __init__(self, index, device, clock=time.monotonic,
                 breaker=None, health=None, breaker_threshold=2,
                 breaker_cooldown_s=30.0):
        import torch

        self.index = int(index)
        self.device = torch.device(device)
        self.key = ("lane", self.index)
        self.clock = clock
        self.breaker = breaker or CircuitBreaker(
            threshold=breaker_threshold, cooldown_s=breaker_cooldown_s,
            clock=clock)
        self.health = health or HealthMonitor(clock=clock)
        self.lost = False
        self.completed = []  # canonical bucket order-indices
        self.stolen = 0  # buckets this lane took over from dead lanes
        self._mesh = None

    @property
    def mesh(self):
        """Single-device 1-D 'pulsar' mesh, built on first use."""
        if self._mesh is None:
            from .mesh import make_mesh

            self._mesh = make_mesh(devices=[self.device])
        return self._mesh

    def alive(self):
        return (not self.lost
                and self.breaker.state(self.key) != "open"
                and self.health.state != "draining")

    def quarantine(self):
        """Mark the lane dead and force its breaker open; idempotent.
        Returns True when this call newly quarantined it."""
        was = self.lost
        self.lost = True
        tripped = self.breaker.trip(self.key)
        self.health.note_breakers(self.breaker.open_count(), tripped)
        return not was

    def snapshot(self):
        return {"index": self.index, "device": str(self.device),
                "lost": bool(self.lost), "alive": self.alive(),
                "completed_buckets": list(self.completed),
                "stolen": int(self.stolen),
                "health": self.health.snapshot(),
                "breaker": self.breaker.snapshot()}


class FleetMesh:
    """Shape-planned fleet fitting across :class:`DeviceLane` failure
    domains (the module docstring has the failure-handling contract).

    Buckets come from ``PTAFleet.plan_groups`` (the grouping PTAFleet
    uses, "plan" packed buckets included) and are assigned to lanes
    deterministically: canonical bucket order (sorted by repr)
    round-robined over lane indices. A bucket's PTABatch is built when
    the bucket is first dispatched on a lane, on that lane's device, so
    stealing a bucket rebuilds it on the survivor. A packed bucket keeps
    its plan, so its mixed fit launches the hand-written Gram kernels on
    its lane's device.

    ``devices`` defaults to every CUDA device; repeated entries are
    logical lanes. clock/sleep are injectable (tests drive fault delays
    with a fake clock); ``collective_timeout_s=None`` disables the
    watchdog.
    """

    def __init__(self, models, toas_list, devices=None, toa_bucket=None,
                 bucket_floor=256, clock=time.monotonic,
                 sleep=time.sleep, breaker_threshold=2,
                 breaker_cooldown_s=30.0, collective_timeout_s=60.0,
                 bisect_depth=4, **plan_kw):
        from .mesh import _default_devices
        from .pta import PTAFleet

        groups, build_kwargs, plans = PTAFleet.plan_groups(
            models, toas_list, toa_bucket=toa_bucket,
            bucket_floor=bucket_floor, **plan_kw)
        self.models = models
        self.toas_list = toas_list
        self.group_indices = groups
        self.build_kwargs = build_kwargs
        self.plans = plans
        self.n = len(models)
        if devices is None:
            devices = _default_devices()
        if not devices:
            raise ValueError("FleetMesh needs at least one device")
        self.clock = clock
        self._sleep = sleep
        self.collective_timeout_s = collective_timeout_s
        self.bisect_depth = int(bisect_depth)
        self.lanes = [
            DeviceLane(i, d, clock=clock,
                       breaker_threshold=breaker_threshold,
                       breaker_cooldown_s=breaker_cooldown_s)
            for i, d in enumerate(devices)]
        # canonical bucket order: sorted by repr so assignment — and
        # every re-assignment after a lane loss — is a pure function of
        # the (bucket set, survivor set), never of dict order
        self.bucket_order = sorted(groups, key=repr)
        self.assignment = {key: i % len(self.lanes)
                           for i, key in enumerate(self.bucket_order)}
        self._built = {}  # (order_idx, lane_idx) -> PTABatch
        self.reassignments = []  # (bucket_repr, from_lane, to_lane)
        self.stolen = 0
        self.diverged = []
        self.quarantined = []  # pulsar indices bisected out
        self.fit_quality = {}  # bucket repr -> fitquality summary

    # -- lane selection / work stealing -----------------------------

    def _survivors(self):
        return [ln for ln in self.lanes if ln.alive()]

    def _steal_from(self, lane, completed):
        """Re-assign ``lane``'s pending buckets to surviving lanes:
        pending buckets in canonical order, round-robined over the
        surviving lane indices in ascending order — deterministic and
        bitwise-reproducible (the stolen bucket's program re-runs
        identically on the new lane)."""
        survivors = self._survivors()
        if not survivors:
            return
        with obs_trace.span("mesh.steal", from_lane=lane.index):
            pending = [k for k in self.bucket_order
                       if k not in completed
                       and self.assignment[k] == lane.index]
            tid = obs_trace.current_trace_id()
            for j, key in enumerate(pending):
                to = survivors[j % len(survivors)]
                self.reassignments.append((repr(key), lane.index,
                                           to.index))
                self.assignment[key] = to.index
                to.stolen += 1
                self.stolen += 1
                _flight.note("work_steal", bucket=repr(key),
                             from_lane=lane.index, to_lane=to.index,
                             trace=tid)

    def _lane_for(self, key, completed):
        """The bucket's assigned lane, stealing first when the owner is
        dead. Returns None when no lane survives."""
        lane = self.lanes[self.assignment[key]]
        if lane.alive():
            return lane
        self._steal_from(lane, completed)
        lane = self.lanes[self.assignment[key]]
        return lane if lane.alive() else None

    # -- bucket execution -------------------------------------------

    def _use_gls(self, batch, method):
        return (method == "gls"
                or (method == "auto"
                    and batch._noise_bw_fn() is not None))

    def _split_kw(self, use_gls, kw):
        allowed = ({"threshold", "ecorr_mode", "precision", "fused"}
                   if use_gls else {"threshold"})
        extra = set(kw) - allowed
        if extra:
            raise TypeError(
                f"{'gls' if use_gls else 'wls'}_fit() got unexpected "
                f"keyword arguments {sorted(extra)}")
        return {k: v for k, v in kw.items() if k in allowed}

    def _batch_for(self, oi, key, lane):
        """The bucket's PTABatch on ``lane``'s device (built per lane: a
        stolen bucket must not read tensors off a dead device)."""
        from .pta import PTABatch

        cached = self._built.get((oi, lane.index))
        if cached is not None:
            return cached
        idxs = self.group_indices[key]
        batch = PTABatch([self.models[i] for i in idxs],
                         [self.toas_list[i] for i in idxs],
                         device=lane.device,
                         **self.build_kwargs.get(key, {}))
        self._built[(oi, lane.index)] = batch
        return batch

    def _watched(self, fn, lane, what):
        """The watchdog around one blocking device pull, with the
        ``collective_timeout`` fault point simulating the hang
        deterministically: an injected hang >= the watchdog bound times
        out (the fleet pays the full watchdog wait, as it would for a
        real hang); a shorter one is just a late pull."""
        fault = faultinject.fire("collective_timeout", site=what)
        timeout = self.collective_timeout_s
        if fault and int(fault.get("lane", lane.index)) == lane.index:
            hang = float(fault.get("hang_s", (timeout or 0.0) + 1.0))
            if timeout is not None and hang >= timeout:
                self._sleep(timeout)
                raise CollectiveTimeout(
                    f"{what} hung past the {timeout:.1f}s watchdog "
                    f"(injected hang {hang:.1f}s on lane {lane.index})")
            self._sleep(hang)
        return run_watched(fn, timeout, what=what)

    def _run_bucket(self, lane, oi, key, method, maxiter, **kw):
        """One bucket fit on one lane. Raises DeviceLost /
        CollectiveTimeout for device-level failures (the caller
        quarantines and steals); other exceptions mean the bucket
        itself is bad (the caller bisects)."""
        with obs_trace.span("mesh.bucket", bucket=oi, lane=lane.index,
                            method=method) as sp:
            out = self._run_bucket_traced(lane, oi, key, method,
                                          maxiter, **kw)
            q = self.fit_quality.get(repr(key))
            if q:
                sp.set(**q)
            return out

    def _run_bucket_traced(self, lane, oi, key, method, maxiter, **kw):
        t0 = self.clock()
        fault = faultinject.fire("straggler_delay", bucket=oi)
        if fault and int(fault.get("lane", lane.index)) == lane.index:
            delay = float(fault.get("delay_s", 0.0))
            self._sleep(delay)
            lane.health.note_flush(delay)
        fault = faultinject.fire("device_loss", bucket=oi)
        if fault and int(fault.get("lane", lane.index)) == lane.index:
            raise DeviceLost(
                f"injected device loss on lane {lane.index} "
                f"(device {lane.device}, bucket {oi})")
        batch = self._batch_for(oi, key, lane)
        use_gls = self._use_gls(batch, method)
        bkw = self._split_kw(use_gls, kw)
        fit = batch.gls_fit if use_gls else batch.wls_fit

        def pull():
            # the fit's finalize is its one blocking device->host pull
            return fit(maxiter=maxiter, **bkw)

        x, chi2, cov = self._watched(
            pull, lane, what=f"bucket {oi} fit on lane {lane.index}")
        idxs = self.group_indices[key]
        self.diverged.extend(idxs[j] for j in batch.diverged)
        if batch.quality:
            self.fit_quality[repr(key)] = batch.quality
        lane.health.note_flush(self.clock() - t0)
        lane.health.note_request("ok")
        lane.breaker.record_success(lane.key)
        lane.completed.append(oi)
        return x, chi2, cov

    def _lane_failed(self, lane, exc, completed):
        """Bookkeeping for a device-level lane failure: DeviceLost
        quarantines at once (a lost device stays lost); a
        CollectiveTimeout is a breaker strike that quarantines once the
        threshold trips. Either way a dead lane's pending buckets are
        re-assigned."""
        lane.health.note_request("error")
        if isinstance(exc, DeviceLost):
            lane.quarantine()
        else:
            tripped = lane.breaker.record_failure(lane.key)
            lane.health.note_breakers(lane.breaker.open_count(), tripped)
            if tripped:
                lane.lost = True
        n_before = len(self.reassignments)
        if not lane.alive():
            self._steal_from(lane, completed)
            # lane census for the SLO monitor and Prometheus scrapes
            from ..obs import metricsreg

            metricsreg.REGISTRY.counter("mesh.lanes_lost").inc()
            metricsreg.REGISTRY.gauge("mesh.alive_lanes").set(
                sum(1 for ln in self.lanes if ln.alive()))
            # post-mortem artifact: which lane died, which fault point
            # killed it, and where its pending buckets went
            lost = isinstance(exc, DeviceLost)
            _flight.dump(
                "device_lost" if lost else "collective_timeout",
                source="fleetmesh", lane=lane.index,
                fault_point="device_loss" if lost else "collective_timeout",
                error=str(exc),
                resharded=[list(r)
                           for r in self.reassignments[n_before:]],
                trace=obs_trace.current_trace_id())

    def _fit_bucket_isolated(self, lane, oi, key, idxs, method, maxiter,
                             depth, **kw):
        """Bisection for a bucket that fails on a HEALTHY lane: split its
        pulsars until the pathological ones are singletons, quarantine
        those (NaN results), fit the rest. Returns {pulsar_index: (x,
        chi2, cov) or None}."""
        from .pta import PTABatch

        sub_kw = dict(self.build_kwargs.get(key, {}))
        if "plan" in sub_kw:
            # a subset cannot reuse the packed plan; pad rows to the
            # plan width so shapes stay bucketed
            sub_kw = {"pad_toas": sub_kw["plan"].width}
        try:
            batch = PTABatch([self.models[i] for i in idxs],
                             [self.toas_list[i] for i in idxs],
                             device=lane.device, **sub_kw)
            use_gls = self._use_gls(batch, method)
            bkw = self._split_kw(use_gls, kw)
            fit = batch.gls_fit if use_gls else batch.wls_fit
            x, chi2, cov = self._watched(
                lambda: fit(maxiter=maxiter, **bkw), lane,
                what=f"bucket {oi} bisect fit on lane {lane.index}")
        except (DeviceLost, CollectiveTimeout):
            raise  # device-level: _fit_bucket_resilient handles it
        except Exception:
            if len(idxs) == 1 or depth >= self.bisect_depth:
                self.quarantined.extend(idxs)
                return {i: None for i in idxs}
            mid = len(idxs) // 2
            out = self._fit_bucket_isolated(
                lane, oi, key, idxs[:mid], method, maxiter,
                depth + 1, **kw)
            out.update(self._fit_bucket_isolated(
                lane, oi, key, idxs[mid:], method, maxiter,
                depth + 1, **kw))
            return out
        self.diverged.extend(idxs[j] for j in batch.diverged)
        return {i: (x[j], chi2[j], cov[j]) for j, i in enumerate(idxs)}

    def _fit_bucket_resilient(self, oi, key, method, maxiter,
                              completed, **kw):
        """Drive one bucket to completion through lane failures:
        device-level errors quarantine/strike the lane and retry on a
        survivor (work stealing); a bucket that then fails on a healthy
        lane is bisected. Bounded by the total breaker budget, so an
        unrecoverable fleet raises instead of spinning."""
        max_attempts = len(self.lanes) * max(
            2, self.lanes[0].breaker.threshold)
        last = None
        for _ in range(max_attempts):
            lane = self._lane_for(key, completed)
            if lane is None:
                raise last or DeviceLost(
                    f"no surviving lanes for bucket {oi} "
                    f"({len(self.lanes)} quarantined)")
            try:
                return self._run_bucket(lane, oi, key, method,
                                        maxiter, **kw)
            except (DeviceLost, CollectiveTimeout) as e:
                last = e
                self._lane_failed(lane, e, completed)
                continue
            except FaultInjected as e:
                if e.retryable:
                    last = e
                    lane.health.note_request("error")
                    continue
                # persistent bucket-level fault on a healthy lane:
                # isolate the pathological pulsars
                idxs = self.group_indices[key]
                rows = self._fit_bucket_isolated(
                    lane, oi, key, list(idxs), method, maxiter, 0,
                    **kw)
                lane.completed.append(oi)
                return self._assemble_rows(key, rows)
        raise last or RuntimeError(
            f"bucket {oi} failed after {max_attempts} attempts")

    def _assemble_rows(self, key, rows):
        """Stack per-pulsar bisect rows back into bucket-shaped (x,
        chi2, cov) arrays; quarantined pulsars carry NaNs."""
        idxs = self.group_indices[key]
        good = next((v for v in rows.values() if v is not None), None)
        k = (good[0].shape[-1] if good is not None
             else len(self.models[idxs[0]].free_params))
        x = np.full((len(idxs), k), np.nan)
        chi2 = np.full(len(idxs), np.nan)
        cov = np.full((len(idxs), k, k), np.nan)
        for j, i in enumerate(idxs):
            if rows.get(i) is not None:
                x[j], chi2[j], cov[j] = rows[i]
        return x, chi2, cov

    # -- checkpointed fleet fit -------------------------------------

    def _fleet_signature(self, method, maxiter):
        """CRC pinning a progress snapshot to THIS fleet + fit config; a
        foreign snapshot (other buckets, pulsar count or fit settings)
        warns and restarts instead of mis-scattering rows."""
        src = repr((self.n, [repr(k) for k in self.bucket_order],
                    {repr(k): list(v)
                     for k, v in self.group_indices.items()},
                    str(method), int(maxiter)))
        return zlib.crc32(src.encode())

    def fit(self, method="auto", maxiter=3, checkpoint_dir=None,
            tag="fleetmesh", **kw):
        """Fit every bucket across the lanes; returns per-pulsar (xs,
        chi2s, covs) in original pulsar order, like PTAFleet.fit.

        checkpoint_dir: persist per-bucket progress through
        FitCheckpointer (CRC + <tag>.prev rotation) after every
        completed bucket; an interrupted fit re-run with the same
        directory resumes from the last completed bucket, and its final
        parameters are bit-identical to an uninterrupted run's
        (completed buckets restore bitwise from the snapshot, the rest
        re-run the same programs in the same canonical order).
        """
        with obs_trace.span("mesh.fit", n_psr=self.n,
                            n_buckets=len(self.bucket_order),
                            n_lanes=len(self.lanes), method=method):
            return self._fit_traced(method, maxiter, checkpoint_dir,
                                    tag, **kw)

    def _fit_traced(self, method, maxiter, checkpoint_dir, tag, **kw):
        xs = [None] * self.n
        chi2s = np.zeros(self.n)
        covs = [None] * self.n
        self.diverged = []
        self.quarantined = []
        self.fit_quality = {}
        ckpt = None
        state = {}
        completed = {}
        sig = self._fleet_signature(method, maxiter)
        if checkpoint_dir is not None:
            from ..checkpoint import FitCheckpointer

            ckpt = FitCheckpointer(checkpoint_dir)
            saved = ckpt.restore(tag)
            if saved is not None:
                if int(np.asarray(saved.get("sig", -1))) != sig:
                    warnings.warn(
                        f"fleet checkpoint {tag!r} was taken for a "
                        "different fleet/fit configuration; "
                        "restarting from scratch")
                else:
                    for oi in np.asarray(saved.get("done", []),
                                         dtype=int):
                        oi = int(oi)
                        completed[self.bucket_order[oi]] = oi
                        for part in ("x", "chi2", "cov"):
                            state[f"b{oi}_{part}"] = saved[f"b{oi}_{part}"]
                    # a resume IS a recovery event: leave the ring's
                    # recent history in a dump before it scrolls away
                    _flight.dump(
                        "checkpoint_restart", source="fleetmesh",
                        tag=tag,
                        restored_buckets=sorted(completed.values()),
                        trace=obs_trace.current_trace_id())
        for oi, key in enumerate(self.bucket_order):
            idxs = self.group_indices[key]
            if key in completed:
                self._scatter(xs, chi2s, covs, idxs,
                              state[f"b{oi}_x"], state[f"b{oi}_chi2"],
                              state[f"b{oi}_cov"])
                continue
            x, chi2, cov = self._fit_bucket_resilient(
                oi, key, method, maxiter, completed, **kw)
            self._scatter(xs, chi2s, covs, idxs, x, chi2, cov)
            completed[key] = oi
            if ckpt is not None:
                state[f"b{oi}_x"] = np.asarray(x)
                state[f"b{oi}_chi2"] = np.asarray(chi2)
                state[f"b{oi}_cov"] = np.asarray(cov)
                ckpt.save(tag, {
                    "sig": sig,
                    "done": np.asarray(sorted(completed.values()),
                                       dtype=np.int64), **state})
        return xs, chi2s, covs

    @staticmethod
    def _scatter(xs, chi2s, covs, idxs, x, chi2, cov):
        x, chi2, cov = np.asarray(x), np.asarray(chi2), np.asarray(cov)
        for j, i in enumerate(idxs):
            xs[i] = x[j]
            chi2s[i] = chi2[j]
            covs[i] = cov[j]

    # -- export ------------------------------------------------------

    def snapshot(self):
        """JSON-safe fleet state: per-lane health/breaker blocks plus the
        work-stealing ledger (the multi-device analog of
        ServeEngine.snapshot())."""
        return {
            "n_lanes": len(self.lanes),
            "alive_lanes": sum(1 for ln in self.lanes if ln.alive()),
            "lost_lanes": [ln.index for ln in self.lanes if ln.lost],
            "stolen_buckets": int(self.stolen),
            "reassignments": [list(r) for r in self.reassignments],
            "quarantined_pulsars": list(self.quarantined),
            "fit_quality": {k: dict(v)
                            for k, v in self.fit_quality.items()},
            "lanes": [ln.snapshot() for ln in self.lanes],
        }
