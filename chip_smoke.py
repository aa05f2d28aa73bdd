#!/usr/bin/env python3
"""Chip smoke test of pint_tpu_torch, the PyTorch/CUDA port, on one card.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It drives the port's main path — GBT TOAs read from tim files by
``get_TOAs``, then the noise-marginalised GLS refit of a 68-pulsar
timing array (~670k TOAs, NANOGrav-15yr-like ragged counts) through
``PTAFleet(toa_bucket="plan").fit(method="gls", maxiter=2,
precision="mixed")`` — then the GW detection stage on the fitted fleet,
the streaming append lanes, the serving engine (fit, residual, phase and
append requests, sync and async) and its durability (the pack store, a
checkpointed fit, journal recovery, the chaos stream and the SIGKILL
matrix), the multi-device surface on logical lanes of the card (the
fleet mesh, TOA sharding, two-rank fleets, device chaos), the photon
path with its satellite, polyco
and CALC variants, fftfit, the photon MCMC and a chi2 grid, and checks
each, in these phases (with, after the main path, the fit-quality probes
on it, an interactive pintk session and binary conversions):

1. build the hand-written CUDA kernels from ``pint_tpu_torch/csrc``
   (``gram.cu``, ``paircorr.cu`` and ``harmonics.cu``, one nvcc each)
   and the C++ host library (``host_kernels.cpp``, g++), all started
   together;
2. ``[ingest]``: 68 pulsars of zero-residual TOAs at GBT (the bench par
   template: EFAC/EQUAD/ECORR, power-law red noise with 30 harmonics,
   4 TOAs per epoch at 800/1400 MHz; each of 2 passes runs clock chain
   -> UTC->TDB with the GCRS products -> posvels on the host and the
   phase on the card), each written with ``write_TOA_file`` and read
   back by ``get_TOAs(path, model=m, usepickle=True)``, then once more
   from the pickle; each step timed. Checks: the read-back day, flags
   and errors equal the written ones, |d sec| and |d TDB| <= 1e-11 s,
   the TDB seconds the card is given within one ulp (1.46e-11 s),
   the pickle hit equals the miss bitwise, the C++ host library served
   the chain, and the zero-clock warning was given once. The fleet is
   built from the read-back TOAs; its host pack is timed;
   ``[ingest] ngc6440e``: the port's copy of the NGC6440E example as it
   is (SolarWindDispersion and TroposphereDelay at zero delay) through
   ``get_model`` -> ``get_TOAs`` -> ``Residuals`` on the card with
   AbsPhase, held to the golden prefit residuals within 1e-3 us;
3. an f64 fit at the true parameters gives each pulsar's sigma; every
   start vector is then moved 3 sigma off the truth;
4. the main path: the mixed-precision fit, cold then warm, with the
   kernels' launch counts set to 0 just before the cold fit and read
   just after; then the f64 fit from the same start. Checks: both
   kernels launched, no refinement failure (max relres <= 1e-8, no f64
   refit taken), |x_mixed - x_f64| <= 1e-6 sigma, |x_fit - x_true| <=
   0.01 sigma for all 68 pulsars, finite chi2;
4a. ``[fitq] main``: the fit-quality probes (``obs.fitquality``) on the
   same fleet and program: three warm fits with the probes off, three
   probed (K1/K2 counted), then ``precompile`` and pipelined replays off
   and on, then a GLSFitter mixed fit of the median-count pulsar off and
   on. Checks: every probed fit bitwise the unprobed one (x, chi2,
   covariances), 68 x 3 fits of 68 pulsars recorded, finite worst
   |chi2 z| and condition, no fallback, K1 and K2 launched under the
   probes, the min probe wall under 1% of the min warm refit (eager and
   replayed), one ``fit_quality`` entry per bucket from both executors,
   the residual moments annotated on the single pulsar (:func:`fitq_phase`);
4b. ``[pintk]``: an ``InteractivePulsar`` on the card over the
   median-count pulsar from the 3-sigma start: fit vs a direct
   ``auto_fitter`` fit bitwise, undo/reset, 100 random models against
   the fit covariance, a JUMP on the 800 MHz TOAs of one MJD third,
   delete/restore, whitened residuals, par/tim written and read back,
   a phase wrap; each operation's wall and the peak device memory
   (:func:`pintk_phase`);
4c. ``[apps] binaryconvert``: ``convert_binary`` on the zoo fleet's
   largest ELL1, ELL1H and DD pulsars (ELL1 <-> DD, ELL1H -> ELL1/DD,
   DD -> DDS/DDH and back, DD -> BT), residuals of each pair on the card
   within the bound of the two parameterizations, round trips within
   1e-10, and a WLS refit of the DDS conversion within 1e-6 sigma of the
   DD one (:func:`apps_binaryconvert`);
4d. right after the main path, on its models, TOAs and fleet (at its
   3-sigma start): ``[durable] store``: ``PTAFleet(toa_bucket="plan",
   store=PackStore(tmp))`` twice — the miss writes one entry per bucket
   (put wall, bytes), the hit rebuilds every bucket through
   ``PTABatch.from_packed`` (hit wall against the live fleet pack,
   ``scan()`` counts); its mixed fit (K1/K2 counts set to 0 just before
   and read just after) bitwise the live fleet's (x, chi2, covariances)
   with the live fit's launches; one flipped byte in the packed bucket's
   entry warns, deletes and rebuilds, and that fleet's fit is bitwise
   too (:func:`durable_store`); ``[durable] checkpoint``:
   ``checkpointed_pta_fit`` on the packed bucket (``method="gls"``,
   ``precision="mixed"``, ``every=1``, ``maxiter=2``): stopped after
   one chunk and resumed, bitwise the uninterrupted run; the
   uninterrupted run's latest snapshot damaged, the resume falls back
   to ``.prev`` and is bitwise again; K1 and K2 launch in every chunk
   (:func:`durable_checkpoint`);
5. the kernel phase: each GLS kernel on the inputs the main path gave
   it (recorded in one more mixed fit; the ``[zoo] fleet``'s shapes
   under the record's ``zoo`` key), held against its plain f32
   version (max |G_kernel - G_plain| <= 1e-5 max|G| over the entries the
   fit reads) and against the f64 plain version; CUDA-event times of
   the kernel, the plain version and one ``torch.bmm`` in f32 (TF32
   off) as the library yardstick, beside the least time the card could
   take;
5a. ``[fitter] ngc6440e``: the README quick start on the unmodified
   example on the card — ``get_model_and_toas`` -> WLSFitter,
   DownhillWLSFitter, GLSFitter (f64) and PowellFitter, each timed with
   its ``get_summary()`` printed, and ``as_parfile()`` — held to the
   JAX package's fits in ``NGC6440E_postfit.json`` (values 1e-6 sigma,
   uncertainties 1e-5, chi2 1e-9; Powell by its own stopping rule), the
   par file read back to the same values, and zero solar-wind and
   troposphere delays;
5b. ``[fitter] pulsar``: GLSFitter on the main path's model over the
   median-count pulsar's read-back TOAs (ECORR's epochs and the red
   noise as dense columns) from phase 3's start, ``maxiter=2`` in mixed
   and f64, cold then warm, then DownhillGLSFitter and its noise
   realizations; mixed vs f64 <= 1e-6 sigma, recovery <= 0.01 sigma,
   and the fleet's row within 1e-2 sigma; then the largest pulsar once
   in mixed (wall, peak device memory);
5c. ``[fleet] modes`` on the read-back pulsars: pow2 and split4 buckets
   in mixed and f64 and ``precision="auto"`` on the plan fleet (held to
   the plan fit within 1e-6 sigma, verdicts printed), ``method="auto"``
   on the noise-free ``lane_par_text`` models through WLS with each
   cuSOLVER SVD driver timed (held to GLS within 1e-6 sigma), and
   dense against marginalized ECORR on the 8 smallest pulsars (rtol
   1e-9 on the updates, 1e-12 on chi2), each cold then warm;
5d. ``[zoo] b1855``: the repo's second golden pack (ELL1H + DMX +
   EFAC/EQUAD/ECORR + red noise, 300 Arecibo TOAs; the port's copy)
   through ``get_model_and_toas`` -> ``Residuals`` on the card (golden
   prefit residuals within 1e-3 us), then GLSFitter (f64, mixed),
   DownhillGLSFitter and WLSFitter (without the correlated noise, which
   it must refuse), held to the JAX package's fits in
   ``B1855SIM_postfit.json`` (values 1e-6 sigma, uncertainties 1e-5,
   mixed 3e-4, chi2 1e-7) and chi2_whitened within 0.01 of 207.511488;
   ``[zoo] components``: one small par per zoo class (``ZOO_COMPONENTS``,
   from the JAX package's tests) on 200 noisy TOAs from the port's
   maker, card vs CPU: delay 1e-12 s, phase 1e-9 cycles, design columns
   1e-9 of their max, chi2 2e-7 relative;
   ``[zoo] fleet``: the main path's counts and epochs (669,488 GBT TOAs
   made on the card) with ``zoo_par_text``: DMX_0001..0017 (180-day
   windows), FD1/FD2 and a JUMP on the 800 MHz receiver free, and by
   ``i % 4`` isolated, ELL1 (J1909-BENCH), ELL1H (b1855sim) or DD
   orbits; TOAs on three sub-bands per receiver with ``-fe`` flags.
   ``PTAFleet(toa_bucket="plan")`` mixed cold (K1/K2 counts set to 0
   just before and read just after, per bucket), warm (profiled), f64,
   from 3 sigma off; checks a packed bucket per structure with K1 and
   K2 launched in each, relres <= 1e-8 with no refit, mixed vs f64 <=
   1e-6 sigma, recovery <= 0.01 sigma, and one single-pulsar
   GLSFitter per structure within 1e-4 sigma of its fleet row; the
   kernels' inputs of each bucket shape are recorded for the kernel
   line; then ``[pipeline] zoo`` on this fleet (5f);
5e. ``[wideband] pack``: the port's wideband pack (``wb_sim.par/.tim``,
   300 wideband GBT TOAs at two receivers written by the JAX package:
   ELL1, DM and 3 DMX windows, EFAC/EQUAD/ECORR, red noise, DMEFAC/
   DMEQUAD, a free DMJUMP) through ``get_model_and_toas`` ->
   ``WidebandTOAResiduals`` on the card, then WidebandTOAFitter (f64 and
   mixed), WidebandDownhillFitter and WidebandLMFitter, each timed with
   its summary, held to the JAX package's fits in ``WB_postfit.json``
   (values 1e-6 sigma, LM by its stopping rule; uncertainties 1e-10,
   mixed 1e-4, LM 1e-5; chi2 1e-7; DM residuals 1e-12 of the DM), and
   ``auto_fitter`` picks WidebandDownhillFitter;
   ``[wideband] pulsar``: the main path's largest pulsar's 7,500 epochs
   with one wideband TOA per GBT receiver (820/1500 MHz): 15,000 TOAs
   and 15,000 DM rows made on the card by ``make_fake_toas_fromMJDs(...,
   wideband=True)``, ``wb_pulsar_par()`` (zoo_par_text(1) without ECORR,
   FD frozen, DMEFAC/DMEQUAD, a free DMJUMP at 2e-4): an f64 fit at the
   truth for sigma, then from 3 sigma off WidebandTOAFitter mixed (cold,
   warm) and f64 (cold, warm), WidebandDownhillFitter and
   WidebandLMFitter; recovery <= 0.01 sigma, mixed vs f64 <= 1e-6
   sigma, no f64 Gram fallback, finite chi2; walls, the warm mixed
   fit's peak device memory and profile, and where an f64 fit's time
   goes;
   ``[cli]``: zima --wideband, pintempo --fitter auto (through
   WidebandDownhillFitter, DM and DMJUMP within 5 sigma of the truth),
   convert_parfile -f tempo2/-f tempo (read back alike, T2EFAC and
   UNITS), compare_parfiles, tcb2tdb, t2binary2pint, pintbary (three
   MJDs) and pintpublish, each ``main([...])`` in-process, exit 0;
5f. ``[pipeline] main`` (after 5c, on the main path's fleet) and
   ``[pipeline] zoo`` (in 5d, on the zoo fleet): the fleet executor
   (:func:`pipeline_phase`) in mixed from each fleet's 3-sigma start:
   the synchronizing calls of a warm eager fit of a packed bucket
   (``torch.cuda.set_sync_debug_mode``), the warm sequential eager fit,
   ``fleet_pipeline_metrics`` (``precompile`` captures each bucket's
   program as CUDA graphs with the eighs run eagerly between them, then
   sequential and pipelined replays) with the graph memory reserved,
   each program's pieces and launches, K1/K2 counted per packed bucket
   in a pipelined replay, the three fits profiled (walls, busy share,
   the Gram kernel's device time), the host time of a replay's graphs
   and of its eager eighs, and the synchronizing calls of a replayed
   fit. Checks: every program captured, pipelined bitwise the
   sequential replay, K1 and K2 launched in every packed bucket under
   replay, relres <= 1e-8 with no f64 refit, mixed vs f64 <= 1e-6
   sigma, replay vs eager <= 1e-6 sigma;
5g. ``[lint]``, right after ``[pipeline] main``: pintlint over the
   port as a subprocess (``python -m pint_tpu_torch.analysis
   pint_tpu_torch/ --format json``, timed; it starts beside the kernel
   build and runs on the host while the card works, so the phase only
   collects it, and logs when it ended against the start of
   ``[host]``'s ingest), the rule count from the analyser's registry,
   then the analyser's static model of device code
   (``analysis.rules_retrace.device_code_index``) held to the card:
   every synchronizing call the card reported in ``[pipeline] main``'s
   warm eager fit of the packed bucket is classed by its port frames as
   an eager piece (through ``graphs.eager``), device code (any port
   frame inside a device function, so a callee in another file of a
   program's ``fit`` counts), or host code. Checks: the analyser exits
   0 with 22 rules and 3 suppressed findings, syncs were recorded, and
   none lies in device code;
6. ``[gw] fleet``: the GW stage on the main path's fleet at its warm
   mixed-fit vectors: assemble and regrid at 30 days (timed), then the
   optimal statistic with the pair products in mixed (the K3 kernel;
   its count set to 0 just before and read just after) and in f64.
   Checks: K3 launched in mixed and not in f64, 2,278 pairs, finite
   amp2 / snr / sigma_amp2, |snr_mixed - snr_f64| <= 1e-3 and
   |amp2_mixed - amp2_f64| <= 1e-3 sigma_amp2. The main path's TOAs are
   zero-residual, so this S/N checks the plumbing at full scale and is
   not a science number;
7. ``[gw] injected``: bench.py's fixture (68 pulsars x 128 cells, an
   HD background of amplitude 0.5, seed 0) in mixed: the amplitude is
   recovered within a factor 2, HD S/N > 5 and beats the monopole and
   dipole templates, and a 100-draw sky-scramble null runs;
8. ``[gw] sweep``: the pair sweep at 3,000 pulsars x 512 cells in
   256-pulsar tiles (78 K3 launches per mixed sweep) with a no-op fold,
   warm, best of 3, in mixed and f64, then once through the HD optimal
   statistic's host fold;
9. ``[kernel] pair_products``: K3 at the fleet's shape, at one 256 x 256
   x 512 sweep tile and at the whole 3000 x 3000 x 512 product, held
   against its plain f32 version (1e-5 of max|.| of each product) and
   timed beside the plain version, two ``torch.matmul`` calls in f32
   and the bound;
10. ``[stream] lanes``: the streaming append path
   (``serve.StreamingRefitter.register`` / ``.append``) over 68 lanes,
   one per pulsar of the main path's TOAs (669,488 base TOAs), each
   model ``par_text(i)`` without ECORR and red noise (F0/F1/DM free,
   K+2 = 6), every append in mixed with a delta store in a temporary
   directory: 4 rounds of one 64-TOA chunk per lane (272 appends, K1′'s
   count set to 0 before registration and read after the last round).
   Prints the registration and append walls and where an append's time
   goes; checks K1′ launched once per append, finite results, no
   escalation, relres <= 1e-12 on chol_update solves, and on the two
   smallest and two largest lanes |x_mixed - x_f64| <= 1e-6 sigma over
   the same appends in f64;
11. ``[stream] restart``, ``escalation``, ``correlated``: a second
   refitter over the same delta store replays those 4 lanes' chains
   (16 links) to bitwise the first one's x and chi2; one lane's fifth
   append under an injected ``solver_diverge`` escalates to bitwise a
   fresh registration on the merged TOAs, and its next append chains
   onto the re-rooted chain; a main-path model (ECORR + red noise)
   gets a full refit per append;
12. ``[stream] kernel``: bench.py's kernel scenario (670,000 base rows
   on the card, K = 10, 64 appended rows, seed 42): scratch refit vs
   clone + append + solve, best of 3, in f64 (parity <= 1e-15 floored
   relative) and mixed (K1′ once per append, its delta Gram within
   1e-5 of the f64 one), and chol_update on the host vs eager on the
   card; then ``[kernel] delta_gram``: K1′ at the lane shape (64 x 6)
   and the scenario's (64 x 12) against its plain version, timed beside
   one f32 ``torch.mm`` and the bound;
12a. ``[serve]``: the in-process serving engine (``serve/``) over
   ``pint_serve_bench``'s fleet at NANOGrav-sized counts
   (``build_serve_fleet(sizes=(1000, 4000, 12000), per_combo=8)``: 72
   pulsars, spin-only / EFAC-EQUAD / + TNREDC 10 red noise, one-pass
   TOAs at 1400 MHz), ``max_batch=8``, ``bucket_floor=256``, f64 fits
   with ``maxiter=3`` (:func:`serve_phase`). ``[serve] stream``:
   ``run_serve_stream`` (216 fit requests, 9 slots in buckets 1024 /
   4096 / 16384, concurrent prewarm): every status ok, no capture after
   warm-up, hit rate >= 0.9, exactly one terminal lifecycle state, the
   ledger bitwise neutral, served vs the offline fleet <= 1e-12
   relative and <= 1e-6 sigma; ``[serve] trace``: the stream again on
   another engine untraced and traced, bitwise, spans by name, then one
   warm flush taken apart (pack, copy into the program, replay, pull);
   ``[serve] mixed``: the 24 red-noise pulsars in mixed vs their f64
   fleet fit <= 1e-6 sigma, no degraded_mixed; ``[serve] cache reuse``:
   disjoint pulsars through one warm slot (spin-only and red-noise at
   16384) and through a pow2 fleet's program adopted by
   ``prefill_from_fleet``, each equal to its own offline fit; ``[serve]
   resid/phase``: one residual and one phase request per structure and
   bucket and the main path's 30,000-TOA pulsar (spilled solo) vs an
   unpadded batch, 1e-12 s and 1e-9 cycles; ``[serve] append``: 8 mixed
   lanes (the 12,000-TOA spin-only and EFAC pulsars over converged TOAs
   at their epochs, two receivers) registered through the engine, 4
   appends of 64 TOAs each: exactly 32 K1′ launches (counted in the
   kernel line's ``launches_new_paths``), bitwise a refitter fed the
   same appends, <= 1e-6 sigma of an f64 WLS fit of base + appended
   TOAs that shares no code with the refitter (``serve_fresh_fit``);
   ``[serve] async``: ``AsyncServeEngine`` with 4 producer threads,
   bitwise the sync engine;
12b. ``[durable]`` on the ``[serve]`` fleet. ``restart`` (in process):
   a durable engine (``max_batch=8``, no flush timer) that served one
   warm-up flush of the 8 red-noise 4,000-TOA pulsars in mixed
   (capturing the slot and persisting it) journals those fits again
   as r0..r7 — r0..r3 committed with sentinel values — and one
   64-TOA mixed append per ``[serve] append`` lane, saves its state
   and dies; a fresh engine on the directory re-captures the slot in
   the background while the 8 lanes register, then ``recover()``.
   Checks: the sentinels come back from the journal; r4..r7 (replayed
   in lanes 0..3 of a new flush, where the fault-free run had them in
   lanes 4..7 beside r0..r3) and the appends bitwise a fault-free
   durable engine's; K1′ once per replayed append (counted just around
   the recovery, the kernel line's ``launches_new_paths``); a second
   ``recover()`` replays nothing; the slot came from the persisted tier
   (no capture on the request path) (:func:`durable_restart`).
   ``chaos``: ``run_chaos_stream`` at bench.py's parameters (216
   requests, ``toa_nan`` at rate 0.05, ``bucket_floor=64``) on this
   fleet: every uninjected request ok with the fault-free run's digest,
   every injected one a structured rejection, health healthy, no
   unexpected recompile (:func:`durable_chaos`). ``kill`` (after
   ``[mesh]``): ``run_kill_chaos()`` at its defaults (bench.py's: 8,192
   TOAs, 4 lanes, 40-iteration red-noise GLS) over 4 of the 8
   ``KILL_SITES`` (``KILL_SMOKE_SITES``: ``mid_commit`` and
   ``excache_store``, which carry checks of their own,
   ``append_delta_write`` and ``pre_commit``; the CPU tests kill at the
   rest), each leg a subprocess on the card: every site killed, 0
   lost, 0 duplicated, 0 digest mismatches, every probe ok, warm and
   bitwise the reference's, no capture at the warm sites and a new one
   at ``excache_store``, torn bytes at ``mid_commit``, 0
   corrupt-or-stale delta segments at ``append_delta_write``; each
   site's cold / warm walls and their ratio against the 2.0 bound are
   printed (:func:`durable_kill`);
12c. ``[obs]``, after ``[durable] restart`` and ``chaos``, on the
   objects the earlier phases built (``obs/``: spans, the cost model,
   SLO burn rates, the drift board, the exporters). ``fleet``: a cold
   traced build (``pipeline=True``) and ``precompile`` of the main
   fleet, then its mixed fit (``maxiter=2``) sequential and pipelined,
   each untraced and traced. Checks: traced bitwise untraced (x, chi2,
   cov); ``fleet.fit`` holds one ``fleet.execute`` per bucket (4), plus
   one ``fleet.dispatch`` each when pipelined; the cold build shows
   ``fleet.host_prep``, ``fleet.pack``, ``fleet.compile``, ``aot.trace``
   and ``aot.backend_compile``; every ``fleet.execute`` carries an MFU
   and 0 < roofline share <= 100% on the card's row of
   ``costmodel.DEVICE_SPECS``; K1 and K2 launch 2 + 2 under tracing
   (the kernel line's ``launches_new_paths``); the Chrome trace loads
   with one event per span; a disabled span's cost times the spans of a
   traced fit stays under 1% of the warm refit (:func:`obs_fleet`).
   ``gw``: a traced ``gw_stage`` on the fitted fleet (``gw.stage`` holds
   ``gw.assemble`` and ``gw.os``, ``gw.os`` holds ``gw.correlate``;
   the statistic bitwise the untraced one) and the traced 3,000-pulsar
   mixed sweep (an MFU, a roofline share <= 100% and a bound on the
   card's row; K3 launched 78 times) (:func:`obs_gw`). ``serve``: the
   ``[serve]`` fleet's 216-request stream on one engine, plain, then
   with ``attach_slo()`` and ``attach_fit_quality()``: bitwise the
   plain digests, no SLO alert, a drift baseline per pulsar (72); a
   spin-only lane refitted on its TOAs with a 20 us step in their
   second half trips ``fit_anomaly`` with a flight dump; the drift
   state round-trips ``save_serve_state`` / ``restore_serve_state``;
   ``pint_serve_bench --tail-out --trace-out`` on the fleet writes a
   trace that loads, and ``python -m pint_tpu_torch.obs tail`` (in
   process) resolves the artifact's p99 exemplar (:func:`obs_serve`).
   ``arrival``: ``run_arrival_sweep`` on the fleet at the JAX package's
   ladder (0.25 ... 3 x the closed-loop rate, 96 requests a rung):
   base rate, each rung's offered and achieved rates, p99 and sheds,
   the knee, the shed onset and the schedule digest
   (:func:`obs_arrival`);
12d. ``[mesh]`` (``parallel/mesh.py``, ``fleetmesh.py``, ``toa_shard.py``,
   ``distributed.py``), after ``[obs]``. Lanes and shards are logical:
   every entry names the one card, so this proves correctness and
   failure handling, not scaling. ``fleet``: the main path's 68
   pulsars through ``FleetMesh`` over 4 lanes (``toa_bucket="plan"``,
   mixed, maxiter 2): bitwise ``PTAFleet.fit`` with the same options,
   K1/K2 2 + 2 on the packed bucket's lane (cold and warm);
   ``device_loss`` on that lane (traced): the bucket is stolen, rebuilt
   on a survivor (its wall), K1/K2 2 + 2 again, bitwise the healthy
   fit, and ``mesh.fit`` / ``mesh.bucket`` / ``mesh.steal`` spans;
   ``collective_timeout`` past a 4 s watchdog twice on lane 0 trips its
   breaker and the fit completes bitwise; the whole fleet lost after
   one checkpointed bucket resumes bitwise (:func:`mesh_fleet`).
   ``toa``: ``sharded_gls_fit`` on the largest pulsar (30,000 TOAs,
   its ECORR epochs and red noise) over 4 shards, f64 and mixed, each
   within 1e-6 sigma of the same fit on one shard and of the card's
   ``GLSFitter``'s last Gauss-Newton iterate (the iterate GLSFitter
   returns is its least-chi2 one, logged: ROADMAP §3); walls and peak
   memory (:func:`mesh_toa`). ``dist``: two gloo ranks as subprocesses
   on the card fit their halves of an 8-pulsar fleet (``par_text``,
   2,000 TOAs each) through ``assemble_global_batch``, and one NCCL
   rank of world size 1 the whole: ranks bitwise alike, within 1e-6
   sigma of a single-process fit, the f64 fits at 1e-12
   (:func:`mesh_dist`). ``serve``: ``run_device_chaos`` on two lanes of
   the card (32 requests, 12 pulsars): every request ok and bitwise the
   fault-free stream, one lane lost and re-routed; one
   ``StreamingRefitter(mesh=make_mesh(1))`` append launches K1′ once
   (:func:`mesh_serve`). The kernel line's ``launches_new_paths`` gain
   the lane's and the steal's K1/K2 and the mesh append's K1′;
12e. ``[mesh] 2d`` (``parallel/sharded.py::ToaRowBatch``), right after
   ``[mesh]``: the main path's 68 pulsars and par template (64 columns)
   in pow2 buckets on a 2 x 2 ("pulsar", "toa") mesh of four logical
   entries of the card, GLS maxiter 2 in f64 and mixed from the
   3-sigma-off start, twice each: within 1e-6 sigma of the same fleet
   without a mesh and chi2 within 1e-9 of each pulsar's dof (the
   TOAs are zero-residual, so a fitted chi2 sits at the rounding floor
   and its relative gap, logged, means nothing), mixed within 1e-6
   sigma of f64, the
   second fit bitwise the first; walls and peak memory
   (:func:`mesh_2d`). Pow2 buckets are unpacked: no kernel launches
   here, and the kernel line does not change;
13. ``[photon]``: bench.py's photon stage (4,000,000 photons, 1,000,000
   pulsed at phase 0.3 with sigma 0.04, seed 0) over one year as a
   barycentred NICER event file with a PSRPROB weight column, written
   with the port's FITS writer (event times invert the par's spindown
   phase to < 1 ns), then loaded (``load_event_TOAs``), given its
   barycentre posvels (the Sun from the numeph tier, as in the JAX
   package; the phase checks the tier) and folded by the timing model on
   the card.
   ``hm``, ``hmw`` and ``z2m(m=4)`` each launch K4 once (counts set to
   0 just before each) and agree with the f64 reference sums on the
   card within 1e-5 relative; H > 1e5 with a finite significance;
   4,000,000 uniform phases give H < 50; ``hm_scan`` over 32 F0 trials
   1/(4T) apart is one K4 launch with its maximum at the true F0; an
   ``LCFitter`` Gaussian fit finds the pulse within 0.01 cycles and
   its width within 5%; the photonphase CLI on the card prints the
   same weighted H (1e-9) and writes the same PULSE_PHASE column;
14. ``[kernel] harmonic_sums``: K4 at (4,000,000, m = 20) unweighted
   and weighted and on the scan's (32, 4,000,000) phases against its
   plain f32 version (max(4e-8 n, 1e-4) absolute) and the f64
   reference, a bitwise repeat, and the times of the kernel, the plain
   version and the reference beside the bound (no library call
   computes these sums), with each shape's launch geometry and the
   per-photon SASS counts of the m = 20 photon loop (``cuobjdump``);
15. ``[photon] satellite``: bench.py's photon stage drawn again with
   seed 1 as NICER events in the spacecraft frame (TIMESYS TT, PSRPROB
   weights) beside an FPorbit-style orbit file of a circular ISS-like
   orbit (6.78e6 m, 51.6 deg, 5,556 s) sampled every 60 s over the year
   and 3 h beyond each end; the event times invert the port's own
   barycentring (computed on the orbit grid, the spacecraft's Roemer
   term through the orbit's Hermite, the rest by a cubic Hermite), with
   the largest residual on 20,000 photons < 1 ns. photonphase
   --orbfile on the card: exit 0, K4 once, every photon's PULSE_PHASE
   within 1e-6 cycles of its drawn phase, H > 1e5, with the walls of
   its load, posvels, phase and H-test;
16. ``[photon] polycos``: photonphase --polycos on the barycentred file
   of 13 and on the spacecraft file: >= 8,760 segments each, K4 once
   per run, the polyco phases within 1e-7 (barycentred) / 1e-6
   (spacecraft) cycles of the model's at the same f64 MJDs on 20,000
   photons and within F0 x half an MJD ulp of the direct run's on every
   photon, H within 1e-6 relative of the direct run's; generation and
   evaluation walls;
17. ``[photon] calc``: 1,000,000 photons (seed 2) as a barycentred
   Fermi FT1 file (TIME, RA, DEC, ENERGY): photonphase --weightcol CALC
   with PHOTON_PAR and with its ecliptic copy
   (``modelutils.model_equatorial_to_ecliptic``), K4 once per run, the
   two H within 1e-9;
18. ``[profile] fftfit``: the phases of 13 folded into a 256-bin weighted
   profile on the card against that profile rotated by 0.1234 cycles:
   fftfit_full and fftfit_cc recover the rotation within 1e-4 cycles
   and agree, with a finite positive uncertainty;
19. ``[mcmc]``: event_optimize on the file of 13 (F0/F1 free with 3x
   their Cramer-Rao widths as uncertainties, 16 walkers, 64 bins, 200
   steps) and event_optimize_multiple over that file and the spacecraft
   file (50 steps), on the card: exit 0, the maximum posterior within 3
   posterior sigma of the truth, accept fraction in (0.1, 0.9), finite
   chains, no synchronizing CUDA call inside either step loop
   (``torch.cuda.set_sync_debug_mode``); wall per step, walker
   evaluations per second, peak memory and a profile's busy share;
20. ``[grid]``: ``grid_chisq`` over (M2, SINI), 16 x 16 over +-3 sigma of
   a WLSFitter fit, maxiter 3, for the zoo fleet's DD pulsar with the
   most TOAs (30,000; its correlated noise dropped for WLS) on its
   fleet TOAs: the minimum at a corner of the cell holding the fit, and
   three points within 1e-6 of a WLSFitter fit with M2/SINI frozen
   there; wall, points/s, chunk size and peak memory;
21. ``[regress]``: the card's own benchmark round, built from this
   run's phases under bench.py's definitions (``[main]``'s warm refit
   walls, padding and buckets, ``[lint]``'s counts, ``[durable]
   chaos`` and ``kill``; the keys whose scope differs, bench.py's
   fit-quality stage among them, carry a reason in ``null_reasons``)
   with ``platform:
   "gpu"`` and the card's name and power limit, written as
   ``BENCH_r01.json`` into a temporary directory, through the port's
   gate (``obs/baseline.py`` with the port's ``budgets.json``):
   its budget violations equal an independent recomputation, each
   printed on a ``[regress] BUDGET`` line (they do not fail the
   phase); copies of the round with a planted 1.25x refit wall are
   flagged and with 0.8x are not; a ``"tpu"`` round and the repo's own
   rounds are not loaded; ``python -m pint_tpu_torch.obs regress`` and
   ``doctor`` in process exit 0 exactly when the report is ok;
   pintlint's ``meta-key-unbudgeted`` finds nothing in this file; the
   phase under 5 s (:func:`regress_phase`).

It prints the card's name and power limit, a ``{"kernels": [...]}``
line (each record, and each per-shape record in it, with ``bound_share``
= ``bound_ms / ms``; every record with its launch geometry: grid,
threads, dynamic shared bytes or photons per thread, tile or harmonics
per chunk), and as its
last line ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --compare OLD_DIR`` instead builds an earlier
design's ``gram.cu``, ``paircorr.cu`` and ``harmonics.cu`` (whichever
``OLD_DIR`` holds) beside the checkout's and times both in turns at the
kernel records' shapes (see :func:`compare_designs`). Any
failed check exits non-zero without that line; so does a machine with
no CUDA card, or a directory without the rest of the repository.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import pickle
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np

# the checkout's pint_tpu_torch, whatever the working directory
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): HBM
# bandwidth and f32 FMA rate outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
TOL_KERNEL = 1e-5  # kernel vs plain f32, relative to max|G|
TOL_RELRES = 1e-8  # refinement contraction (fitter.relres_failed)
TOL_MIXED = 1e-6  # |x_mixed - x_f64| / sigma
TOL_RECOVER = 0.01  # |x_fit - x_true| / sigma
START_OFFSET_SIGMA = 3.0
TOL_GW_SNR = 1e-3  # |snr_mixed - snr_f64| on the fleet, S/N units
TOL_GW_AMP2 = 1e-3  # |amp2_mixed - amp2_f64| / sigma_amp2 on the fleet
GW_LATTICE_DAYS = 30.0  # PTAFleet.gw_stage's default lattice
SWEEP_PSR, SWEEP_CELLS, SWEEP_BLOCK = 3000, 512, 256
INJ_PSR, INJ_CELLS, INJ_AMP, INJ_DRAWS = 68, 128, 0.5, 100
# streaming: appends of 64 TOAs (serve/streaming.py APPEND_PAD), 4
# rounds over every lane; 2 more on the escalation lane
STREAM_ROUNDS, STREAM_CHUNK, STREAM_EXTRA = 4, 64, 2
TOL_RELRES_CHOL = 1e-12  # kernels/incremental.py's factored-solve gate
TOL_PARITY = 1e-15  # incremental vs scratch, floored relative (f64)
# photons: bench.py's photon stage (bench.py:995-1012) with the par file
# of tests/test_events.py, over one year of barycentred NICER events
PHOTON_N, PHOTON_PULSED = 4_000_000, 1_000_000
PHOTON_LOC, PHOTON_SIGMA = 0.3, 0.04
PHOTON_F0, PHOTON_F1, PHOTON_PEPOCH = 29.946923, -3.77e-10, 56700
PHOTON_SPAN_DAYS = 365.0
PHOTON_TRIALS = 32  # hm_scan trials, 1/(4T) apart
PHOTON_PAR = (f"PSR TESTEV\nRAJ 10:00:00.0\nDECJ 15:00:00.0\n"
              f"F0 {PHOTON_F0} 1\nF1 {PHOTON_F1} 1\n"
              f"PEPOCH {PHOTON_PEPOCH}\nDM 0.0\n")
TOL_H = 1e-5  # |H_K4 - H_f64| / H_f64 (and each Z^2_k)


def log(msg):
    print(msg, flush=True)


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"


def ragged_counts(n_psr=68, total=670_000, seed=7):
    """NANOGrav-15yr-like ragged TOA counts: lognormal spread over
    ~600..30000, scaled to the target total (bench.py's
    ``_ragged_counts``)."""
    rng = np.random.default_rng(seed)
    c = rng.lognormal(np.log(8000.0), 0.9, n_psr)
    for _ in range(3):
        c = np.clip(c * (total / c.sum()), 600, 30000)
    return np.sort(c.astype(int))[::-1]


def par_text(i):
    """bench.py's par template (build_batch, with noise)."""
    return (f"PSR BEN{i}\nRAJ {i % 24}:{(7 * i) % 60:02d}:00.0\n"
            f"DECJ {(i * 3) % 60 - 30}:30:00.0\n"
            f"F0 {150 + 5 * (i % 40)}.318 1\nF1 -{2 + i % 7}e-16 1\n"
            f"PEPOCH 55500\nDM {8 + i}.21 1\n"
            "EFAC -f L-wide 1.1\nEQUAD -f L-wide 0.4\n"
            "ECORR -f L-wide 0.8\n"
            "RNAMP 1e-14\nRNIDX -3.1\nTNREDC 30\n")


# [zoo] fleet: 17 disjoint 180-day DMX windows over MJD 54000-57060 and
# the orbits of the four structures (i % 4): isolated; J1909-BENCH's
# ELL1 (benchmarks/baseline_configs.py); b1855sim's ELL1H (H3/STIGMA
# frozen); the DD orbit of tests/test_binary_variants.py
ZOO_DMX_EDGES = [54000.0 + 180.0 * k for k in range(18)]
ZOO_ORBITS = (
    "",
    "BINARY ELL1\nPB 1.533449 1\nA1 1.89799 1\nTASC 55001.0 1\n"
    "EPS1 2e-8 1\nEPS2 -8e-8 1\nM2 0.21\nSINI 0.998\n",
    "BINARY ELL1H\nPB 12.32717 1\nA1 9.230780 1\nTASC 53601.0 1\n"
    "EPS1 -2.15e-5 1\nEPS2 -3.1e-6 1\nH3 2.7e-7\nSTIGMA 0.72\n",
    "BINARY DD\nPB 8.0 1\nA1 12.0 1\nT0 55300 1\nECC 0.12 1\nOM 45.0 1\n"
    "M2 0.35\nSINI 0.92\n")
ZOO_STRUCTURES = ("isolated", "ELL1", "ELL1H", "DD")
# three sub-bands in each GBT receiver of the main path's two (Rcvr_800:
# 720-920 MHz, Rcvr1_2: 1150-1880 MHz), as NANOGrav's GBT TOAs are
# split in frequency. Two frequencies alone span only two functions of
# frequency, so FD1, FD2, the receiver JUMP and the DMX windows' common
# 1/f^2 mode would be degenerate with the offset.
ZOO_BANDS = {"Rcvr_800": (730.0, 820.0, 910.0),
             "Rcvr1_2": (1150.0, 1500.0, 1850.0)}


def zoo_par_text(i):
    """The zoo fleet's pulsar i: par_text's spin, position, noise and
    flags, DM frozen, DMX_0001..0017 free, FD1/FD2 free, a free JUMP on
    the 800 MHz receiver (true value 0) and structure i % 4's orbit."""
    dm = f"DM {8 + i}.21 1\n"
    text = par_text(i).replace(dm, dm[:-3] + "\n")
    edges = ZOO_DMX_EDGES
    text += "".join(f"DMX_{k + 1:04d} 0.0 1\nDMXR1_{k + 1:04d} {edges[k]}\n"
                    f"DMXR2_{k + 1:04d} {edges[k + 1] - 0.001}\n"
                    for k in range(len(edges) - 1))
    text += "FD1 1.5e-5 1\nFD2 -4e-6 1\nJUMP -fe Rcvr_800 0.0 1\n"
    return text + ZOO_ORBITS[i % 4]


def zoo_freqs(n):
    """Frequencies of n TOAs, 4 per epoch 0.5 s apart: the TOAs
    alternate between the receivers (800 MHz, 1400 MHz), as build_pta's
    do, and at each pair step to the next sub-band."""
    j = np.arange(n)
    bands = np.array([ZOO_BANDS["Rcvr_800"], ZOO_BANDS["Rcvr1_2"]])
    return bands[j % 2, (j // 2) % 3]


def zoo_flags(freq_mhz):
    """par_text's -f flag and the GBT receiver of a TOA's frequency."""
    fe = next(name for name, sub in ZOO_BANDS.items()
              if sub[0] - 100.0 <= freq_mhz <= sub[-1] + 100.0)
    return {"f": "L-wide", "fe": fe}


def alternating_freqs(n):
    """build_pta's frequencies: 800 and 1400 MHz in turn."""
    return np.where(np.arange(n) % 2, 1400.0, 800.0)


def build_pta(counts, device, seed=0, iterations=2, par_fn=None,
              freq_fn=alternating_freqs, flag_fn=None, rng=None):
    """Models and zero-residual TOAs at GBT (bench.py's site, the fake
    maker's default): epochs uniform over MJD 54000-57000 (drawn from
    ``rng``, default ``default_rng(seed)``), 4 TOAs per epoch 0.5 s
    apart, 1 us errors, frequencies ``freq_fn(n)`` (alternating
    800/1400 MHz), all flagged -f L-wide plus ``flag_fn(freq)``; pulsar
    i's par file is ``par_fn(i)`` (``par_text``)."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.simulation import make_fake_toas_fromMJDs

    rng = np.random.default_rng(seed) if rng is None else rng
    models, toas = [], []
    for i, n in enumerate(counts):
        m = get_model((par_fn or par_text)(i))
        days = np.sort(rng.uniform(54000, 57000, max(1, int(n) // 4)))
        mjds = (days[:, None] + np.arange(4) * 0.5 / 86400.0).reshape(-1)
        freqs = freq_fn(len(mjds))
        t = make_fake_toas_fromMJDs(
            mjds, m, error_us=1.0, freq_mhz=freqs, flags={"f": "L-wide"},
            iterations=iterations, device=device)
        if flag_fn is not None:
            for f, nu in zip(t.flags, freqs):
                f.update(flag_fn(nu))
        toas.append(t)
        models.append(m)
    return models, toas


INGEST_STEPS = (  # (owner module, attribute, label) timed in [ingest]
    ("pint_tpu_torch.toa", "_read_tim_native", "parse (C++)"),
    ("pint_tpu_torch.toa", "read_tim_file", "parse (Python)"),
    ("pint_tpu_torch.toa:TOAs", "apply_clock_corrections", "clock chain"),
    ("pint_tpu_torch.toa:TOAs", "compute_TDBs", "compute_TDBs"),
    ("pint_tpu_torch.timescales", "utc_to_tdb", "  UTC->TDB"),
    ("pint_tpu_torch.earth.erfa_lite", "gcrs_posvel_from_itrf",
     "  GCRS products"),
    ("pint_tpu_torch.toa:TOAs", "compute_posvels", "compute_posvels"),
    ("pint_tpu_torch.toa", "save_pickle", "save_pickle"),
)
TOL_READBACK_S = 1e-11  # |d sec|, |d TDB| after the 16-digit MJD format
TDB_SEC_ULP_S = 2.0 ** -36  # one ulp of f64 seconds in [65536, 86400)


def ingest_timers():
    """Timers over the host chain's steps (``INGEST_STEPS``)."""
    import importlib

    timers = Timers()
    for owner, attr, label in INGEST_STEPS:
        mod, _, cls = owner.partition(":")
        obj = importlib.import_module(mod)
        timers.patch(getattr(obj, cls) if cls else obj, attr, label)
    return timers


def log_steps(tag, timers):
    for _, _, label in INGEST_STEPS:
        if label in timers.total:
            log(f"{tag}   {label}: {timers.total[label]:.3f} s "
                f"({timers.calls[label]} calls)")


def ingest(counts, tmp, device="cuda"):
    """``[ingest]``: the main path's TOAs made, written and read back
    through the normal entry point. 68 pulsars of zero-residual GBT
    TOAs (``build_pta``), each written with ``write_TOA_file`` into
    ``tmp``, then read by ``get_TOAs(path, model=m, usepickle=True)``
    (parse, clock chain, TDB with the GCRS products, posvels, the pickle
    written) and once more from the pickle. Prints each step's wall and
    checks the read-back against what was written, the pickle hit
    against the miss, the C++ host library in use and the zero-clock
    warning given once. Returns the models and the read-back TOAs."""
    from pint_tpu_torch import native
    from pint_tpu_torch.toa import get_TOAs

    with warnings.catch_warnings(record=True) as wl:
        warnings.simplefilter("always")
        timers = ingest_timers()
        t0 = time.perf_counter()
        try:
            models, made = build_pta(counts, device)
        finally:
            timers.restore()
        make_s = time.perf_counter() - t0
        n_toa = sum(len(t) for t in made)
        log(f"[ingest] fake TOAs: {len(models)} pulsars, {n_toa} "
            f"zero-residual GBT TOAs (2 phase passes on the card, 3 host "
            f"chains) in {make_s:.2f} s; host chain:")
        log_steps("[ingest]", timers)
        t0 = time.perf_counter()
        paths = []
        for i, t in enumerate(made):
            paths.append(os.path.join(tmp, f"psr{i:02d}.tim"))
            t.write_TOA_file(paths[-1])
        write_s = time.perf_counter() - t0
        size = sum(os.path.getsize(p) for p in paths)
        log(f"[ingest] write_TOA_file: {len(paths)} tim files, "
            f"{size / 1e6:.1f} MB in {write_s:.2f} s")
        timers = ingest_timers()
        t0 = time.perf_counter()
        try:
            toas = [get_TOAs(p, model=m, usepickle=True)
                    for p, m in zip(paths, models)]
        finally:
            timers.restore()
        read_s = time.perf_counter() - t0
        log(f"[ingest] get_TOAs(usepickle=True), a miss: {read_s:.2f} s:")
        log_steps("[ingest]", timers)
        t0 = time.perf_counter()
        for t in toas:
            t.flags
        flags_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        hits = [get_TOAs(p, model=m, usepickle=True)
                for p, m in zip(paths, models)]
        hit_s = time.perf_counter() - t0
    n_warn = sum("no clock files found" in str(w.message) for w in wl)
    log(f"[ingest] flags decoded in {flags_s:.2f} s; get_TOAs pickle hit "
        f"{hit_s:.2f} s; C++ host library loaded: {native.loaded()} "
        f"({native.library_path()}); zero-clock warnings: {n_warn}")

    def same_flags(written, read):
        return (all(f.get("name") == "pint_tpu" for f in read)
                and [{k: v for k, v in f.items() if k != "name"}
                     for f in read] == written)

    dsec = max(float(np.abs(a.sec - b.sec).max()) for a, b in zip(made, toas))

    def dtdb(a, b, lo):
        d = (a.tdb.day - b.tdb.day) * 86400.0 + (a.tdb.sec - b.tdb.sec)
        return float(np.abs(d + (a.tdb.lo - b.tdb.lo if lo else 0.0)).max())

    # the TDB instant is day + sec + lo (mjd.Epochs); its f64 seconds
    # alone, which to_batch ships to the card, sit on a grid of 1.46e-11 s
    # above 65536 s, coarser than the 16-digit MJD format, and may move
    # by one ulp
    dtdb_lo = max(dtdb(a, b, True) for a, b in zip(made, toas))
    dtdb_sec = max(dtdb(a, b, False) for a, b in zip(made, toas))
    log(f"[ingest] read-back vs written: max |d sec| {dsec:.3e} s, max "
        f"|d TDB| {dtdb_lo:.3e} s (the instant, sec + lo; the f64 "
        f"seconds alone {dtdb_sec:.3e} s); ephemeris tier "
        f"{sorted({t.ephem_provider for t in toas})}")

    def same(a, b):
        cols = ("day", "sec", "error_us", "freq_mhz", "clock_corr_s")
        return (all(np.array_equal(getattr(a, c), getattr(b, c))
                    for c in cols)
                and all(np.array_equal(getattr(a.tdb, c), getattr(b.tdb, c))
                        for c in ("day", "sec", "lo"))
                and np.array_equal(a.ssb_obs.pos, b.ssb_obs.pos)
                and np.array_equal(a.ssb_obs.vel, b.ssb_obs.vel)
                and np.array_equal(a.obs_sun.pos, b.obs_sun.pos)
                and list(a.obs) == list(b.obs) and a.flags == b.flags)

    check("ingest", {
        "read-back day equals the written": all(
            np.array_equal(a.day, b.day) for a, b in zip(made, toas)),
        "read-back errors equal the written": all(
            np.array_equal(a.error_us, b.error_us)
            for a, b in zip(made, toas)),
        "read-back flags equal the written": all(
            same_flags(a.flags, b.flags) for a, b in zip(made, toas)),
        "|d sec| <= 1e-11 s": dsec <= TOL_READBACK_S,
        "|d TDB| <= 1e-11 s": dtdb_lo <= TOL_READBACK_S,
        "|d TDB seconds| <= one ulp (1.46e-11 s)": dtdb_sec <= TDB_SEC_ULP_S,
        "all GBT": all(set(t.obs) == {"gbt"} for t in toas),
        "pickle hit equals the miss": all(
            h is not t and same(h, t) for h, t in zip(hits, toas)),
        "C++ host library loaded": native.loaded(),
        "zero-clock warning given once": n_warn == 1,
    })
    return models, toas


EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "pint_tpu_torch", "data", "examples")
NGC_PAR = os.path.join(EXAMPLES, "NGC6440E.par")
NGC_TIM = os.path.join(EXAMPLES, "NGC6440E.tim")


def ingest_ngc6440e(device="cuda"):
    """``[ingest] ngc6440e``: the port's copy of the NGC6440E example
    as it is (62 GBT TOAs, AbsPhase at TZRSITE 1, SolarWindDispersion
    and TroposphereDelay at zero delay) through get_model -> get_TOAs
    -> Residuals on the card, held to the port's copy of the prefit
    golden residuals within 1e-3 us."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.residuals import Residuals
    from pint_tpu_torch.toa import get_TOAs

    golden = np.load(os.path.join(EXAMPLES, "NGC6440E_prefit_resids_us.npy"))
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m = get_model(NGC_PAR)
        t = get_TOAs(NGC_TIM, model=m)
        r = Residuals(t, m, device=device)
        resid_us = r.time_resids * 1e6
    wall = time.perf_counter() - t0
    dev = float(np.abs(resid_us - golden).max()) if (
        resid_us.shape == golden.shape) else np.inf
    log(f"[ingest] ngc6440e: {len(t)} TOAs, components "
        f"{list(m.components)}, residuals on {r.prepared.device} in "
        f"{wall:.2f} s; weighted rms {r.rms_weighted() * 1e6:.6f} us; max "
        f"|resid - golden| {dev:.3e} us; chi2 {r.chi2:.6f}, dof {r.dof}")
    check("ingest ngc6440e", {
        "AbsPhase in the model": "AbsPhase" in m.components,
        "SolarWindDispersion and TroposphereDelay in the model":
            {"SolarWindDispersion", "TroposphereDelay"} <= set(m.components),
        "residuals on the requested device":
            r.prepared.device.type == device,
        "finite residuals of the golden's shape":
            resid_us.shape == golden.shape
            and bool(np.all(np.isfinite(resid_us))),
        "|resid - golden| <= 1e-3 us": dev <= 1e-3,
    })


def truth_vectors(fleet, models):
    """Each pulsar's true free-parameter vector, in fit order."""
    return np.array([[getattr(m, name).value for name, _, _ in
                      fleet.batches[next(iter(fleet.batches))].free_map()]
                     for m in models], dtype=np.float64)


def set_start(fleet, x):
    for key, idxs in fleet.group_indices.items():
        fleet.batches[key].set_start_vector(x[idxs])


def timed_fit(fleet, torch, method="gls", **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as wl:
        warnings.simplefilter("always")
        xs, chi2, covs = fleet.fit(method=method, maxiter=2, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    refit = any("refitting in f64" in str(w.message) for w in wl)
    return np.array(xs), np.asarray(chi2), covs, wall, refit


TOL_FREQ = 1e-12  # spin frequency at emission vs longdouble (f64 tier)


def main_freq(models, toas, device="cuda"):
    """``[main] freq``: ``Spindown.d_phase_d_toa_freq`` on the card for
    each pulsar of the main path, at its params0 with the card's
    ``delay()``, held to a host evaluation of sum_i F_i (T - d)^i / i!
    in longdouble (T from the prep's longdouble copy, d the same delay
    pulled to the host). Returns the phase's wall."""
    import torch

    from pint_tpu_torch.mjd import LD

    t0 = time.perf_counter()
    prep_s, worst, where, n, ok = 0.0, 0.0, None, 0, True
    for m, t in zip(models, toas):
        t1 = time.perf_counter()
        p = m.prepare(t, device=device)
        prep_s += time.perf_counter() - t1
        d = p.delay()
        f = m.components["Spindown"].d_phase_d_toa_freq(
            p.params0, p.batch, p.prep, d)
        ok &= (f.dtype == torch.float64 and f.device == d.device
               and tuple(f.shape) == (len(t),))
        f = f.cpu().numpy()
        T = p.prep["T_ld"] - LD(1.0) * d.cpu().numpy()
        ref, fact, Tp = np.zeros_like(T), LD(1.0), np.ones_like(T)
        for i, fi in enumerate(p.params0["F"].cpu().numpy()):
            fact = fact * LD(max(i, 1))
            ref = ref + LD(fi) * Tp / fact
            Tp = Tp * T
        gap = float(np.max(np.abs(f - ref) / np.abs(ref)))
        ok &= bool(np.all(np.isfinite(f)))
        n += len(f)
        if gap >= worst:
            worst, where = gap, f"{m.PSR.value} ({len(t)} TOAs)"
        del p, d
    wall = time.perf_counter() - t0
    log(f"[main] freq: d_phase_d_toa_freq on {device} for {len(models)} "
        f"pulsars, {n} TOAs, in {wall:.3f} s (of which prepare "
        f"{prep_s:.3f} s; host clock); worst |f - f_longdouble|/f "
        f"{worst!r} at {where}")
    check("[main] freq", {
        "float64 on the card, one value per TOA": ok,
        f"<= {TOL_FREQ} relative on every TOA": worst <= TOL_FREQ,
        "every TOA of the main path": n == sum(len(t) for t in toas),
    })
    return wall


def cuda_ms(torch, fn, reps=20, warmup=3):
    """Mean time of fn() in ms by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(torch, fn, n=20):
    """Time per launch of n launches of fn captured in one CUDA graph and
    replayed: the device's time without the host's launch path (which
    sets the back-to-back times of the small shapes)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    ms = cuda_ms(torch, graph.replay, reps=10, warmup=2) / n
    del graph
    return ms


def kernel_record(torch, name, replaces, kern, plain, inp, block, whiten,
                  launches):
    """Hold one kernel against its plain versions on ``inp`` and time
    all three; returns the JSON entry (raises on disagreement)."""
    n, ka = inp.shape
    nb = n // block
    out = kern(inp, block)
    torch.cuda.synchronize()
    ref32 = plain(inp, block)
    ref64 = plain(inp.double(), block)
    used = ka - 1 if whiten else ka  # the winv row/column is never read
    d32 = (out - ref32)[:, :used, :used].abs().max().item()
    scale = ref32[:, :used, :used].abs().max().item()
    d64 = (out.double() - ref64)[:, :used, :used].abs().max().item()
    rel32, rel64 = d32 / scale, d64 / ref64[:, :used, :used].abs().max().item()
    log(f"[kernel] {name}: in ({n}, {ka}) f32, block {block} -> out "
        f"({nb}, {ka}, {ka}); vs plain f32 max|d| {d32:.3e} "
        f"({rel32:.3e} of max|G|), vs plain f64 {rel64:.3e} of max|G|")
    if not rel32 <= TOL_KERNEL:
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"{rel32:.3e} > {TOL_KERNEL}")
    if whiten:
        xb = (inp * inp[:, -1:]).reshape(nb, block, ka)
    else:
        xb = inp.reshape(nb, block, ka)
    ms = cuda_ms(torch, lambda: kern(inp, block))
    plain_ms = cuda_ms(torch, lambda: plain(inp, block))
    library_ms = cuda_ms(torch, lambda: torch.bmm(xb.mT, xb))
    nbytes = 4.0 * (n * ka + nb * ka * ka)
    flops = n * ka * (ka + 1) + (n * ka if whiten else 0)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_F32_FLOP_S * 1e3
    log(f"[kernel] {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"torch.bmm {library_ms:.4f} ms, bound {max(t_bytes, t_ops):.4f} ms "
        f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP)")
    geometry = gram_geometry(inp, out, block, whiten)
    log(f"[kernel] {name}: launch {geometry}")
    return {"name": name, "route": "cuda",
            "source": "pint_tpu_torch/csrc/gram.cu", "replaces": replaces,
            "launches": int(launches), "max_abs_err": d32, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "launch": geometry}


def gram_geometry(x, out, block, whiten):
    """The launch shape csrc/gram.cu gets for rows x (out its output) at
    Q = block: the persistent grid, threads, dynamic shared bytes, the
    4 x 4 tile of a thread, the rows of a ring chunk, the bytes of each
    row copy, whether the products read the ring directly and whether
    the output leaves by one bulk store."""
    from pint_tpu_torch.kernels import gram

    n, ka = x.shape
    shape = gram.gram_shape(block, ka, whiten)
    grid_x, threads, chunk, vec, bulk, smem = gram.gram_plan(
        n // block, block, ka, whiten, x.data_ptr(), out.data_ptr(),
        gram.resident_blocks(x.device.index, shape.threads,
                             shape.smem_bytes))
    return {"grid": [grid_x, shape.grid_y], "threads": threads,
            "smem_bytes": smem, "tile": [gram.TILE, gram.TILE],
            "chunk_rows": chunk, "copy_bytes": 16 if vec else 4,
            "direct": shape.direct, "bulk_store": bool(bulk)}


def pair_geometry(ua, wa, ub, wb):
    """The launch shape csrc/paircorr.cu gets for these operands: grid,
    threads,
    dynamic shared bytes, output tile, outputs per thread and the bytes
    of each row copy."""
    from pint_tpu_torch.kernels import paircorr

    (ba, m), bb = ua.shape, ub.shape[0]
    vec = paircorr.copies_16_bytes(m, *(t.data_ptr()
                                        for t in (ua, wa, ub, wb)))
    return {"grid": list(paircorr.pair_grid(ba, bb)),
            "threads": paircorr.THREADS, "smem_bytes": paircorr.SMEM_BYTES,
            "tile": [paircorr.TILE, paircorr.TILE],
            "per_thread": list(paircorr.PER_THREAD),
            "copy_bytes": 16 if vec else 4}


def add_bound_share(rec):
    """bound_share = bound_ms / ms on a kernel record and on each of its
    per-shape records."""
    if "bound_ms" in rec and "ms" in rec:
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    for v in rec.values():
        if isinstance(v, dict):
            add_bound_share(v)
    return rec


def profile_run(torch, tag, fn, top=10):
    """One run of ``fn`` under torch.profiler, recording the device's
    activity alone (the report reads only the CUDA events); prints the
    device-busy share of the host wall and the ops with the most device
    time; returns the wall, the busy seconds and {op: (count, device
    ms)}. Diagnostic only: prints "not measured" and returns None when
    the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events()
              if e.device_type.name == "CUDA" and e.device_time_total > 0]
    if not events:
        log(f"{tag} {wall:.3f} s under the profiler; device time not "
            "measured (no CUDA events recorded)")
        return
    # busy time = union of kernel intervals on the device timeline
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, -1.0
    for s, e in spans:
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    busy_s = busy * 1e-6
    log(f"{tag} {wall:.3f} s under the profiler: device "
        f"busy {busy_s:.3f} s ({100 * busy_s / wall:.1f}%), idle "
        f"{100 * (1 - busy_s / wall):.1f}%; {len(events)} device ops")
    by_name = {}
    for e in events:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.device_time_total * 1e-3)
    for name, (n, ms) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        log(f"{tag.split()[0]}   {ms:9.3f} ms  {n:5d}x  {name[:90]}")
    return {"wall_s": wall, "busy_s": busy_s, "ops": by_name}


def capture_inputs(fleet, torch, tag=None):
    """One more mixed fit that records the first input each GLS kernel
    wrapper receives (the main path's real tensors): {"K1": (x, block),
    "K2": ...}. With ``tag`` (a label of a bucket's key), one mixed fit
    per bucket, recording the first input of each distinct shape:
    {"K1": {f"{tag(key)} {shape}": (x, block)}, "K2": ...}."""
    from pint_tpu_torch.kernels import fusedgls, seggram

    seen = {"K1": {}, "K2": {}}
    orig = (fusedgls.fused_block_gls_f32, seggram.block_grams_f32)
    current = [""]

    def rec(key, fn):
        def wrapper(x, block):
            seen[key].setdefault(f"{current[0]} {tuple(x.shape)}",
                                 (x.to(torch.float32).contiguous().clone(),
                                  block))
            return fn(x, block)
        return wrapper

    fusedgls.fused_block_gls_f32 = rec("K1", orig[0])
    seggram.block_grams_f32 = rec("K2", orig[1])
    try:
        if tag is None:
            fleet.fit(method="gls", maxiter=2, precision="mixed")
        else:
            for key, b in fleet.batches.items():
                current[0] = tag(key)
                b.gls_fit(maxiter=2, precision="mixed")
    finally:
        fusedgls.fused_block_gls_f32, seggram.block_grams_f32 = orig
    if tag is None:
        return {k: next(iter(v.values())) for k, v in seen.items()}
    return seen


def check(phase, checks):
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{phase} checks failed: {failed}")


FITTER_NGC = ("WLSFitter", "DownhillWLSFitter", "GLSFitter", "PowellFitter")
TOL_FIT_UNC = 1e-5  # uncertainties vs the JAX fixture (safeguarded fits)
TOL_POWELL_CHI2 = 1e-4  # Powell's stopping rule (scipy ftol), relative chi2
TOL_SINGLE_FLEET = 1e-2  # single-pulsar GLS vs the fleet's row, sigma
# torch.linalg.svd's cuSOLVER drivers, each timed on the fleet's WLS;
# gesvda works from the Gram matrix (normal equations), so it is timed
# for the record but is not a candidate for fitter.SVD_DRIVER
SVD_DRIVERS = (None, "gesvd", "gesvdj", "gesvda")


def fitter_ngc6440e(device="cuda"):
    """``[fitter] ngc6440e``: the README quick start on the port's
    unmodified NGC6440E example — ``get_model_and_toas`` -> WLSFitter,
    DownhillWLSFitter, GLSFitter (f64) and PowellFitter on ``device`` —
    each fit timed, its summary printed, held to the JAX package's fits
    in ``NGC6440E_postfit.json`` (values 1e-6 sigma, uncertainties 1e-5
    relative, chi2 1e-9 relative; Powell by its stopping rule: chi2
    within 1e-4 relative of the WLS optimum's, each value within the
    sqrt(1e-4 chi2) sigma that allows), the post-fit par file read
    back by ``get_model`` to the same values (angles to their written
    1e-10 s), and the solar-wind and
    troposphere delays zero at the par file's settings."""
    import pint_tpu_torch
    from pint_tpu_torch import fitter as tfit
    from pint_tpu_torch.models import get_model

    with open(os.path.join(EXAMPLES, "NGC6440E_postfit.json")) as f:
        fx = json.load(f)["fitters"]
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m, t = pint_tpu_torch.get_model_and_toas(NGC_PAR, NGC_TIM)
    load_s = time.perf_counter() - t0
    p = m.prepare(t, device=device)
    zero = {name: float(m.components[name].delay(
        p.params0, p.batch, p.prep, None).abs().max())
        for name in ("SolarWindDispersion", "TroposphereDelay")}
    log(f"[fitter] ngc6440e: get_model_and_toas {load_s:.2f} s, {len(t)} "
        f"TOAs, components {list(m.components)}; max |delay| on "
        f"{p.device}: {zero}")
    gaps, fitted = {}, {}
    wls = fx["WLSFitter"]
    for key in FITTER_NGC:
        ref = fx[key]
        sync()
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            f = getattr(tfit, ref["class"])(t, m, device=device)
            chi2 = float(f.fit_toas(**ref["kwargs"]))
        sync()
        wall = time.perf_counter() - t0
        vals = {n: getattr(f.model, n).value for n in ref["values"]}
        uncs = {n: getattr(f.model, n).uncertainty for n in ref["values"]}
        sig = {n: u if u else wls["uncertainties"][n]
               for n, u in ref["uncertainties"].items()}
        gap = {"dx_sigma": max(abs(vals[n] - v) / sig[n]
                               for n, v in ref["values"].items()),
               "chi2_rel": abs(chi2 - ref["chi2"]) / ref["chi2"]}
        if key == "PowellFitter":
            gap["dx_wls_sigma"] = max(
                abs(vals[n] - v) / wls["uncertainties"][n]
                for n, v in wls["values"].items())
            gap["chi2_excess_rel"] = (chi2 - wls["chi2"]) / wls["chi2"]
        else:
            gap["unc_rel"] = max(abs(uncs[n] / u - 1)
                                 for n, u in ref["uncertainties"].items())
        gaps[key] = gap
        fitted[key] = f
        log(f"[fitter] ngc6440e {key}: {wall:.3f} s on {device} "
            f"({f.metrics['n_free']} free, iterations "
            f"{f.metrics['iteration_s']}); chi2 {chi2:.9f}; vs the JAX "
            f"fixture: {gap}")
        for line in f.get_summary().splitlines():
            log(f"[fitter] ngc6440e {key} | {line}")
    quick = fitted["DownhillWLSFitter"]
    par = quick.model.as_parfile()
    for line in par.splitlines():
        log(f"[fitter] ngc6440e as_parfile | {line}")
    back = get_model(par)

    def same_value(a, b):
        if a.kind != "angle":
            return a.value == b.value
        # written to 1e-10 sexagesimal seconds: one tick
        tick = 1e-10 / 3600 * np.pi / 180 * (
            15.0 if a.angle_unit == "hourangle" else 1.0)
        return abs(a.value - b.value) <= tick

    same = all(same_value(getattr(quick.model, n), getattr(back, n))
               for n in quick.model.free_params)
    check("fitter ngc6440e", {
        "solar-wind and troposphere delays zero":
            all(v == 0.0 for v in zero.values()),
        "values within 1e-6 sigma of the JAX fixture": all(
            g["dx_sigma"] <= TOL_MIXED for k, g in gaps.items()
            if k != "PowellFitter"),
        "uncertainties within 1e-5 of the JAX fixture": all(
            g["unc_rel"] <= TOL_FIT_UNC for k, g in gaps.items()
            if k != "PowellFitter"),
        "chi2 within 1e-9 of the JAX fixture": all(
            g["chi2_rel"] <= 1e-9 for k, g in gaps.items()
            if k != "PowellFitter"),
        "Powell chi2 within its ftol of the WLS optimum's":
            gaps["PowellFitter"]["chi2_excess_rel"] <= TOL_POWELL_CHI2,
        "Powell values within sqrt(ftol chi2) sigma of the WLS optimum":
            gaps["PowellFitter"]["dx_wls_sigma"]
            <= np.sqrt(TOL_POWELL_CHI2 * wls["chi2"]),
        "as_parfile read back gives the same values": same,
        "fits on the requested device": all(
            f.metrics["backend"] == device for f in fitted.values()),
    })


def fitter_pulsar(toas, names, x_true, x_start, x_fleet, device="cuda"):
    """``[fitter] pulsar``: the single-pulsar GLSFitter on the main
    path's model (``par_text``: EFAC/EQUAD/ECORR, 30-harmonic red noise,
    F0/F1/DM free) over the read-back GBT TOAs of the fleet's
    median-count pulsar, from phase 3's 3-sigma-off start:
    ``fit_toas(maxiter=2)`` in mixed and f64, cold then warm, then
    DownhillGLSFitter and its noise realizations; then the largest
    pulsar once in mixed (wall, peak device memory). Checks mixed vs
    f64 <= 1e-6 sigma, recovery <= 0.01 sigma, finite realizations, and
    the single-pulsar fit against that pulsar's row of the warm mixed
    fleet fit within 1e-2 sigma (tests/test_parallel.py's tier)."""
    import torch

    from pint_tpu_torch.fitter import DownhillGLSFitter, GLSFitter
    from pint_tpu_torch.models import get_model

    order = np.argsort([len(t) for t in toas], kind="stable")
    i_med, i_big = int(order[len(order) // 2]), int(order[-1])

    def start_model(i):
        m = get_model(par_text(i))
        for n, v in zip(names, x_start[i]):
            getattr(m, n).value = float(v)
        return m

    def timed(cls, i, **kw):
        sync()
        t0 = time.perf_counter()
        f = cls(toas[i], start_model(i), device=device)
        f.fit_toas(**kw)
        sync()
        x = np.array([getattr(f.model, n).value for n in names])
        s = np.array([getattr(f.model, n).uncertainty for n in names])
        return f, x, s, time.perf_counter() - t0

    walls = {}
    _, _, _, walls["mixed cold"] = timed(GLSFitter, i_med, maxiter=2,
                                         precision="mixed")
    fm, xm, sm, walls["mixed warm"] = timed(GLSFitter, i_med, maxiter=2,
                                            precision="mixed")
    _, _, _, walls["f64 cold"] = timed(GLSFitter, i_med, maxiter=2)
    f64, x64, s64, walls["f64 warm"] = timed(GLSFitter, i_med, maxiter=2)
    fd, xd, sd, walls["DownhillGLSFitter"] = timed(DownhillGLSFitter, i_med)
    t0 = time.perf_counter()
    noise = fd.get_noise_resids()
    walls["get_noise_resids"] = time.perf_counter() - t0
    n_med = len(toas[i_med])
    n_epochs = int(fm._noise_basis_segments[0][1].shape[1])
    d_mixed = float(np.max(np.abs(xm - x64) / s64))
    d_true = float(max(np.max(np.abs(x - x_true[i_med]) / s)
                       for x, s in ((xm, sm), (x64, s64), (xd, sd))))
    d_fleet = float(np.max(np.abs(xm - x_fleet[i_med]) / sm))
    log(f"[fitter] pulsar BEN{i_med} (median count): {n_med} GBT TOAs, "
        f"{n_epochs} ECORR epochs + 60 red-noise columns dense; walls "
        + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items())
        + f"; Downhill iterations {len(fd.metrics['iteration_s'])}")
    log(f"[fitter] pulsar: max |x_mixed - x_f64|/sigma {d_mixed:.3e}; max "
        f"|x_fit - x_true|/sigma {d_true:.3e}; max |x_single - "
        f"x_fleet|/sigma {d_fleet:.3e}; chi2 mixed {fm.chi2_whitened:.6f} "
        f"f64 {f64.chi2_whitened:.6f}; noise realizations "
        + ", ".join(f"{k} rms {np.std(v) * 1e6:.4f} us"
                    for k, v in noise.items()))
    if device == "cuda":
        profile_run(torch, "[fitter] profile: the median pulsar's warm mixed "
                    "GLSFitter", lambda: timed(GLSFitter, i_med, maxiter=2,
                                               precision="mixed"), top=8)
        torch.cuda.reset_peak_memory_stats()
    fb, xb, sb, big_s = timed(GLSFitter, i_big, maxiter=2, precision="mixed")
    peak = (torch.cuda.max_memory_allocated() if device == "cuda" else None)
    big_epochs = int(fb._noise_basis_segments[0][1].shape[1])
    d_big = float(np.max(np.abs(xb - x_true[i_big]) / sb))
    log(f"[fitter] pulsar BEN{i_big} (largest): {len(toas[i_big])} TOAs, "
        f"{big_epochs} ECORR epochs, Mfull {len(toas[i_big])} x "
        f"{3 + 1 + big_epochs + 60}; GLSFitter mixed maxiter=2 "
        f"{big_s:.3f} s (cold), max_memory_allocated "
        f"{peak if peak is None else f'{peak / 2**30:.3f} GiB'}; "
        f"|x_fit - x_true|/sigma {d_big:.3e}")
    check("fitter pulsar", {
        "mixed vs f64 <= 1e-6 sigma": d_mixed <= TOL_MIXED,
        "recovery <= 0.01 sigma": d_true <= TOL_RECOVER,
        "single pulsar vs the fleet's row <= 1e-2 sigma":
            d_fleet <= TOL_SINGLE_FLEET,
        "finite noise realizations": set(noise) == {
            "EcorrNoise", "PLRedNoise"} and all(
            v.shape == (n_med,) and np.all(np.isfinite(v))
            for v in noise.values()),
        "largest pulsar finite and recovered": np.all(np.isfinite(xb))
            and d_big <= TOL_RECOVER,
    })


def fleet_modes(models, toas, plan_fleet, x_start, x_plan, sig, device="cuda"):
    """``[fleet] modes`` on the read-back pulsars already in memory:
    ``toa_bucket="pow2"`` and ``"split4"`` in mixed and f64 held to the
    plan fleet's warm mixed fit within 1e-6 sigma; ``precision="auto"``
    on the plan fleet (verdicts printed); ``method="auto"`` on the
    noise-free ``lane_par_text`` models, which routes through WLS
    (each cuSOLVER SVD driver timed and held to the GLS fit of the same
    models within 1e-6 sigma); ``ecorr_mode="dense"`` against "auto"
    on the 8 smallest pulsars (rtol 1e-9 on the updates, 1e-12 on
    chi2). Every fit from the 3-sigma-off start, cold then warm."""
    import torch

    from pint_tpu_torch import fitter as tfit
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.parallel.pta import PTABatch, PTAFleet

    def cold_warm(fleet, method="gls", **kw):
        x, c, cov, cold, r1 = timed_fit(fleet, torch, method=method, **kw)
        x2, c2, cov2, warm, r2 = timed_fit(fleet, torch, method=method, **kw)
        return x2, c2, cov2, cold, warm, r1 or r2

    gaps, refits = {}, False
    for mode in ("pow2", "split4"):
        t0 = time.perf_counter()
        fl = PTAFleet(models, toas, toa_bucket=mode, device=device)
        sync()
        pack_s = time.perf_counter() - t0
        set_start(fl, x_start)
        widths = sorted(int(np.max(b.n_toas)) for b in fl.batches.values())
        for prec in ("mixed", "f64"):
            x, _, _, cold, warm, refit = cold_warm(fl, precision=prec)
            refits |= refit
            gaps[f"{mode} {prec}"] = float(np.max(np.abs(x - x_plan) / sig))
            log(f"[fleet] {mode} {prec}: cold {cold:.3f} s, warm "
                f"{warm:.3f} s; max |x - x_plan|/sigma "
                f"{gaps[f'{mode} {prec}']:.3e}")
        log(f"[fleet] {mode}: {len(fl.batches)} buckets (max counts "
            f"{widths}), padding x{fl.padding_ratio:.4f}, pack "
            f"{pack_s:.2f} s")
        del fl
    x, _, _, cold, warm, refit = cold_warm(plan_fleet, precision="auto")
    refits |= refit
    gaps["plan auto"] = float(np.max(np.abs(x - x_plan) / sig))
    verdicts = {str(k[1][1]): getattr(b, "precision_auto", None)
                for k, b in plan_fleet.batches.items()}
    log(f"[fleet] precision=auto on the plan fleet: cold (probes "
        f"included) {cold:.3f} s, warm {warm:.3f} s; max |x - "
        f"x_plan|/sigma {gaps['plan auto']:.3e}; verdicts by width "
        f"{verdicts}")

    nf_models = [get_model(lane_par_text(i)) for i in range(len(toas))]
    t0 = time.perf_counter()
    nf = PTAFleet(nf_models, toas, toa_bucket="plan", device=device)
    sync()
    log(f"[fleet] noise-free lane models: {len(nf.batches)} buckets, pack "
        f"{time.perf_counter() - t0:.2f} s")
    set_start(nf, x_start)
    xg, _, covg, gcold, gwarm, _ = cold_warm(nf, method="gls")
    sig_nf = np.sqrt(np.array([np.diag(c) for c in covg]))
    drivers = {}
    default = tfit.SVD_DRIVER
    for drv in (SVD_DRIVERS if device == "cuda" else (default,)):
        tfit.SVD_DRIVER = drv
        try:
            xw, cw, _, cold, warm, _ = cold_warm(nf, method="auto")
        finally:
            tfit.SVD_DRIVER = default
        drivers[str(drv)] = {
            "cold_s": cold, "warm_s": warm,
            "dx_gls_sigma": float(np.max(np.abs(xw - xg) / sig_nf)),
            "finite": bool(np.all(np.isfinite(xw)) and np.all(np.isfinite(cw)))}
        log(f"[fleet] method=auto (WLS), svd driver {drv}: cold "
            f"{cold:.3f} s, warm {warm:.3f} s; max |x_wls - x_gls|/sigma "
            f"{drivers[str(drv)]['dx_gls_sigma']:.3e}")
    routed = {m["method"] for m in nf.fit_metrics.values()}
    log(f"[fleet] same models by method=gls: cold {gcold:.3f} s, warm "
        f"{gwarm:.3f} s; method=auto ran {sorted(routed)}; the default "
        f"driver is {default}")
    del nf

    small = [int(i) for i in np.argsort([len(t) for t in toas],
                                        kind="stable")[:8]]
    b = PTABatch([get_model(par_text(i)) for i in small],
                 [toas[i] for i in small], device=device)
    b.set_start_vector(x_start[small])
    out = {}
    for mode in ("auto", "dense"):
        walls = []
        for _ in range(2):
            sync()
            t0 = time.perf_counter()
            out[mode] = b.gls_fit(maxiter=2, ecorr_mode=mode)
            sync()
            walls.append(time.perf_counter() - t0)
        log(f"[fleet] ecorr_mode={mode}, the 8 smallest pulsars "
            f"({int(np.sum(b.n_toas))} TOAs): cold {walls[0]:.3f} s, warm "
            f"{walls[1]:.3f} s")
    x0 = x_start[small]
    (xa, ca, _), (xd, cd, _) = out["auto"], out["dense"]
    upd = np.abs((xa - x0) - (xd - x0)) / (np.abs(xd - x0) + 1e-300)
    log(f"[fleet] dense vs auto: max relative update gap {upd.max():.3e}; "
        f"max chi2 gap {np.max(np.abs(ca - cd) / np.abs(cd)):.3e}")
    check("fleet modes", {
        "pow2/split4/auto within 1e-6 sigma of the plan fit": all(
            g <= TOL_MIXED for g in gaps.values()),
        "no f64 refit taken": not refits,
        "method=auto routed the noise-free buckets through WLS":
            routed == {"wls"},
        "WLS (default driver) within 1e-6 sigma of GLS":
            drivers[str(default)]["dx_gls_sigma"] <= TOL_MIXED
            and drivers[str(default)]["finite"],
        "dense vs auto ECORR updates (rtol 1e-9) and chi2 (1e-12)":
            np.allclose(xa - x0, xd - x0, rtol=1e-9, atol=1e-18)
            and np.allclose(ca, cd, rtol=1e-12, atol=0),
    })
    return drivers


# ---- [zoo]: the model zoo on the card ----

B1855_PAR = os.path.join(EXAMPLES, "b1855sim.par")
B1855_TIM = os.path.join(EXAMPLES, "b1855sim.tim")
B1855_CHI2_WHITENED = 207.511488  # tests/test_golden.py's frozen value
TOL_B1855_CHI2W = 0.01  # ... and its tier
TOL_GOLDEN_US = 1e-3  # prefit residuals vs the golden, us
TOL_B1855_CHI2 = 1e-7  # chi2 vs the JAX fixture, relative (1 us errors)
TOL_MIXED_UNC = 3e-4  # mixed uncertainties vs the JAX fixture (ROADMAP §3)
TOL_CROSS_CHI2 = 2e-7  # card vs CPU chi2, relative (test_torch_fleet_modes.py)
TOL_CROSS_DELAY_S = 1e-12  # card vs CPU delay, s
TOL_CROSS_PHASE = 1e-9  # card vs CPU phase, cycles
TOL_CROSS_COL = 1e-9  # card vs CPU design column, of its max |entry|
TOL_ZOO_SINGLE = 1e-4  # single-pulsar GLSFitter row vs the fleet's, sigma
B1855_FITTERS = (("GLSFitter", False), ("GLSFitter_mixed", False),
                 ("DownhillGLSFitter", False), ("WLSFitter_white", True))


def zoo_b1855(device="cuda"):
    """``[zoo] b1855``: the repo's second golden pack (ELL1H + DMX +
    EFAC/EQUAD/ECORR + red noise, 300 Arecibo TOAs) from the port's copy
    through ``get_model_and_toas`` -> ``Residuals`` on ``device`` (held
    to the golden prefit residuals within 1e-3 us), then GLSFitter
    (maxiter=2, f64 and mixed), DownhillGLSFitter and WLSFitter (on the
    model without ECORR and red noise; with them it must refuse),
    each timed and held to the JAX package's fits in
    ``B1855SIM_postfit.json``: values 1e-6 sigma, uncertainties 1e-5
    relative (3e-4 in mixed, ROADMAP §3), chi2 1e-7 relative, and the
    f64 GLS chi2_whitened within 0.01 of 207.511488."""
    import pint_tpu_torch
    from pint_tpu_torch import fitter as tfit
    from pint_tpu_torch.residuals import Residuals

    with open(os.path.join(EXAMPLES, "B1855SIM_postfit.json")) as f:
        fx = json.load(f)["fitters"]
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m, t = pint_tpu_torch.get_model_and_toas(B1855_PAR, B1855_TIM,
                                                 usepickle=False)
    load_s = time.perf_counter() - t0
    golden = np.load(os.path.join(EXAMPLES, "b1855sim_prefit_resids_us.npy"))
    r = Residuals(t, m, device=device)
    d_golden = float(np.max(np.abs(
        r.calc_time_resids().cpu().numpy() * 1e6 - golden)))
    log(f"[zoo] b1855: get_model_and_toas {load_s:.2f} s, {len(t)} TOAs, "
        f"components {list(m.components)}; prefit residuals on {device} vs "
        f"the golden: max |d| {d_golden:.3e} us")
    gaps, refused = {}, False
    for key, white in B1855_FITTERS:
        ref = fx[key]
        mm = copy.deepcopy(m)
        if white:
            try:
                tfit.WLSFitter(t, mm, device=device).fit_toas()
            except tfit.CorrelatedErrors:
                refused = True
            for name in ("EcorrNoise", "PLRedNoise"):
                mm.remove_component(name)
        sync()
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            f = getattr(tfit, ref["class"])(t, mm, device=device)
            chi2 = float(f.fit_toas(**ref["kwargs"]))
        sync()
        wall = time.perf_counter() - t0
        unc = ref["uncertainties"]
        gap = {"dx_sigma": max(abs(getattr(f.model, n).value - v) / unc[n]
                               for n, v in ref["values"].items()),
               "unc_rel": max(abs(getattr(f.model, n).uncertainty / u - 1)
                              for n, u in unc.items()),
               "chi2_rel": abs(chi2 - ref["chi2"]) / ref["chi2"]}
        cw = getattr(f, "chi2_whitened", None)
        if key == "GLSFitter":
            gap["chi2_whitened"] = cw
        gaps[key] = gap
        log(f"[zoo] b1855 {key}: {wall:.3f} s on {device} "
            f"({f.metrics['n_free']} free); chi2 {chi2:.9f}; vs the JAX "
            f"fixture: {gap}")
    check("zoo b1855", {
        "prefit residuals within 1e-3 us of the golden":
            d_golden <= TOL_GOLDEN_US,
        "GLS chi2_whitened within 0.01 of 207.511488":
            abs(gaps["GLSFitter"]["chi2_whitened"] - B1855_CHI2_WHITENED)
            <= TOL_B1855_CHI2W,
        "values within 1e-6 sigma of the JAX fixture":
            all(g["dx_sigma"] <= TOL_MIXED for g in gaps.values()),
        "uncertainties within their tiers of the JAX fixture": all(
            g["unc_rel"] <= (TOL_MIXED_UNC if k.endswith("mixed")
                             else TOL_FIT_UNC) for k, g in gaps.items()),
        "chi2 within 1e-7 of the JAX fixture":
            all(g["chi2_rel"] <= TOL_B1855_CHI2 for g in gaps.values()),
        "WLSFitter refuses ECORR and red noise": refused,
    })


# one small par per component class, each from the JAX package's tests
# (file::test in the comment); the TOAs come from the port's maker
_TB = ("PSR TESTB\nRAJ 10:22:57.9\nDECJ 10:01:52.8\nF0 100.5 1\n"
       "F1 -5e-16 1\nPEPOCH 55000\nDM 20.0\n")  # tests/test_binary.py BASE
_TC = ("PSR TESTC\nRAJ 05:00:00.0\nDECJ 15:00:00.0\nF0 100.0 1\n"
       "F1 -1e-14 1\nPEPOCH 55500\nDM 20.0\n")  # tests/test_components.py
_TC2 = ("PSR TESTC2\nRAJ 12:10:00.0\nDECJ 09:00:00.0\nF0 218.8 1\n"
        "F1 -4e-16 1\nPEPOCH 55300\nDM 15.0 1\n")  # tests/test_components2.py
_TCH = ("PSR TESTCHROM\nRAJ 16:00:51.9\nDECJ -30:53:49.3\nF0 277.94 1\n"
        "F1 -7.3e-16 1\nPEPOCH 55300\nDM 52.33 1\n")  # tests/test_chromatic.py
_TBV = ("PSR TESTBV\nRAJ 06:30:00.0\nDECJ -05:00:00.0\nF0 315.4 1\n"
        "F1 -6e-16 1\nPEPOCH 55500\nDM 12.4 1\n")  # test_binary_variants.py
ZOO_COMPONENTS = (
    ("BinaryELL1", _TB + "BINARY ELL1\nPB 1.53 1\nA1 1.898 1\n"  # ell1_fit_recovery
     "TASC 55001.0 1\nEPS1 2e-8 1\nEPS2 -8e-8 1\nM2 0.21\nSINI 0.998\n", {}),
    ("BinaryELL1H", _TB + "BINARY ELL1H\nPB 1.5 1\nA1 2.0 1\nTASC 55001.0\n"
     "EPS1 1e-7\nEPS2 2e-7\nH3 3.638e-07\nSTIGMA 0.62679\n", {}),  # ell1h_shapiro
    ("BinaryELL1k", _TB + "BINARY ELL1K\nPB 1.5 1\nA1 2.0 1\nTASC 55001.0\n"
     "EPS1 1e-7\nEPS2 2e-7\nOMDOT 1.0\n", {}),  # ell1k_matches_ell1
    ("BinaryBT", _TB + "BINARY BT\nPB 10.5 1\nA1 12.3 1\nT0 55005.5 1\n"
     "ECC 0.21 1\nOM 75.3 1\nGAMMA 0.002\n", {}),  # bt_fit_recovery
    ("BinaryBTX", _TB + "BINARY BTX\nFB0 1.102292768959436e-06 1\n"
     "A1 12.3 1\nT0 55005.5\nECC 0.21\nOM 75.3\nGAMMA 0.002\n", {}),  # btx
    ("BinaryBTPiecewise", _TC2 + "BINARY BT_piecewise\nPB 8.0\nA1 12.0\n"
     "T0 55300\nECC 0.12\nOM 45.0\nT0X_0001 55300.0002 1\nA1X_0001 12.05 1\n"
     "XR1_0001 55350\nXR2_0001 55400\n", {}),  # bt_piecewise_matches_bt
    ("BinaryDD", _TB + "BINARY DD\nPB 0.40 1\nA1 2.34 1\nT0 55005.5 1\n"
     "ECC 0.17 1\nOM 120.0 1\nOMDOT 4.22 1\nGAMMA 0.004\nM2 1.3\n"
     "SINI 0.95\n", {}),  # dd_fit_recovery
    ("BinaryDDS", _TB + "BINARY DDS\nPB 0.4 1\nA1 2.34 1\nT0 55005.5 1\n"
     "ECC 0.01 1\nOM 120.0 1\nM2 1.3\nSHAPMAX 3.0\n", {}),  # dds_shapmax
    ("BinaryDDH", _TC2 + "BINARY DDH\nPB 8.0\nA1 12.0\nT0 55300\nECC 0.12\n"
     "OM 45.0\nH3 2.8685e-07 1\nSTIGMA 0.55 1\n", {}),  # ddh_h4_fallback
    ("BinaryDDGR", _TB + "BINARY DDGR\nPB 0.323 1\nA1 2.34 1\nT0 55005.0 1\n"
     "ECC 0.617 1\nOM 226.0 1\nMTOT 2.83 1\nM2 1.39\n", {}),  # ddgr_fit
    ("BinaryDDK", _TBV + "PMDEC 30.0\nPX 1.0\nBINARY DDK\nPB 10.0 1\n"
     "A1 20.0 1\nT0 55500.0 1\nECC 0.01 1\nOM 45.0 1\nM2 0.2\nKIN 60.0\n"
     "KOM 0.0\nK96 1\n", {}),  # ddk_proper_motion / annual_orbital_parallax
    ("BINARY T2", _TB + "BINARY T2\nPB 10.0\nA1 5.0\nTASC 55000\nEPS1 1e-5\n"
     "EPS2 1e-5\nH3 1e-7\nSTIG 0.5\n", {}),  # binary_t2_container
    ("DispersionDMX", _TC2 + "DMX 14.0\nDMX_0001 1e-3 1\nDMXR1_0001 55000\n"
     "DMXR2_0001 55300\nDMX_0002 -2e-3 1\nDMXR1_0002 55300.5\n"
     "DMXR2_0002 55600\n", {}),  # test_breadth.py::dmxparse_and_ranges
    ("DispersionJump", _TC2 + "DMJUMP -fe Rcvr_800 0.002\n", {}),
    ("PhaseJump", _TC + "JUMP -fe Rcvr_800 1e-4 1\n", {}),
    ("FD", _TC + "FD1 1e-5 1\nFD2 -2e-6\n", {}),  # test_components.py fd
    ("FDJump", _TC + "FD1JUMP freq 1000 1500 3e-5 1\n", {}),  # fdjump
    ("PhaseOffset", _TC + "PHOFF 0.1 1\n", {}),  # phase_offset
    ("Glitch", _TC + "GLEP_1 55400\nGLPH_1 0.3 1\nGLF0_1 3e-9 1\n"
     "GLF0D_1 1e-9 1\nGLTD_1 30 1\n", {}),  # glitch
    ("PiecewiseSpindown", _TC2 + "PWEP_0001 55100\nPWSTART_0001 55000\n"
     "PWSTOP_0001 55200\nPWPH_0001 0.0\nPWF0_0001 1e-8 1\nPWF1_0001 0\n",
     {}),  # test_components2.py piecewise
    ("IFunc", _TC + "SIFUNC 2\nIFUNC1 55000 0\nIFUNC2 55500 1e-4\n"
     "IFUNC3 56000 0\n", {}),  # ifunc
    ("Wave", _TC + "WAVEEPOCH 55500\nWAVE_OM 0.01 1\nWAVE1 1e-5 -2e-5\n"
     "WAVE2 5e-6 0\n", {}),  # wave
    ("WaveX", _TCH + "WXEPOCH 55300\nWXFREQ_0001 0.004\nWXSIN_0001 1e-6 1\n"
     "WXCOS_0001 2e-6 1\n", {}),
    ("DMWaveX", _TCH + "DMWXEPOCH 55300\nDMWXFREQ_0001 0.004\n"
     "DMWXSIN_0001 1e-4 1\nDMWXCOS_0001 -1e-4 1\n", {}),
    ("ChromaticCM", _TCH + "CM 0.5 1\nCM1 0.05 1\nCMEPOCH 55300\n"
     "TNCHROMIDX 4\n", {}),  # test_chromatic.py cm_taylor_term
    ("ChromaticCMX", _TCH + "CM 0.0\nTNCHROMIDX 4\nCMX_0001 0.02 1\n"
     "CMXR1_0001 55100\nCMXR2_0001 55300\n", {}),  # cmx window
    ("CMWaveX", _TCH + "CMWXEPOCH 55300\nCMWXFREQ_0001 0.004\n"
     "CMWXSIN_0001 0.01 1\nTNCHROMIDX 4\n", {}),  # cmwavex
    ("PLDMNoise", _TC2 + "EFAC -f L-wide 1.1\nTNDMAMP -13.0\nTNDMGAM 3.0\n"
     "TNDMC 10\n", {}),  # test_components2.py pldm
    ("PLChromNoise", _TCH + "TNCHROMIDX 4\nTNCHROMAMP -13.2\nTNCHROMGAM 3.0\n"
     "TNCHROMC 8\n", {}),  # test_chromatic.py plchrom
    ("PLSWNoise", _TC2 + "NE_SW 8.0\nTNSWAMP -5.5\nTNSWGAM 2.0\nTNSWC 8\n",
     {}),  # test_noise_gls.py plsw
    ("SolarWindDispersionX", _TC2 + "NE_SW 7.9\nSWXDM_0001 2.5e-4 1\n"
     "SWXR1_0001 54990\nSWXR2_0001 55300\n", {}),  # test_components2.py swx
    ("UNITS TCB", "PSR TCB1\nRAJ 05:00:00\nDECJ 10:00:00\nF0 100.0 1\n"
     "F1 -1e-15 1\nPEPOCH 55000\nDM 10.0 1\nUNITS TCB\n",
     {"allow_tcb": True}),  # test_edge_cases.py TestTCBConversion
)


def zoo_components(device="cuda"):
    """``[zoo] components``: each zoo class on ``device`` against the
    port on the CPU, on the same 200 noisy TOAs from the port's maker
    (MJD 54990-56990, 800/1400 MHz with -f L-wide and the GBT receiver
    -fe flags): the total delay (1e-12 s), the phase (1e-9 cycles), the
    design matrix (1e-9 of each column's max |entry|) and the prefit
    chi2 (2e-7 relative, the cross-device tier of
    tests/test_torch_fleet_modes.py); the largest gap of
    each over all classes is printed beside its tier."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.residuals import Residuals
    from pint_tpu_torch.simulation import make_fake_toas_fromMJDs

    mjds = np.linspace(54990.0, 56990.0, 200)
    freqs = np.where(np.arange(len(mjds)) % 2, 1400.0, 800.0)
    worst = {"delay_s": 0.0, "phase": 0.0, "column": 0.0, "chi2_rel": 0.0}
    t0 = time.perf_counter()
    for name, par, kw in ZOO_COMPONENTS:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            m = get_model(par, **kw)
            t = make_fake_toas_fromMJDs(mjds, m, error_us=1.0,
                                        freq_mhz=freqs, add_noise=True,
                                        seed=1, flags={"f": "L-wide"},
                                        device="cpu")
        for f, nu in zip(t.flags, freqs):
            f.update(zoo_flags(nu))
        got = {}
        for dev in ("cpu", device):
            p = m.prepare(t, device=dev)
            M, labels = p.designmatrix()
            got[dev] = (p.delay().cpu(), p.phase_frac_and_int()[0].cpu(),
                        M.cpu(), Residuals(t, m, device=dev).chi2)
        (dc, pc, Mc, cc), (dg, pg, Mg, cg) = got["cpu"], got[device]
        gap = {"delay_s": float((dg - dc).abs().max()),
               "phase": float((pg - pc).abs().max()),
               "column": float(((Mg - Mc).abs().amax(0)
                                / Mc.abs().amax(0).clamp(min=1e-300)).max()),
               "chi2_rel": abs(cg - cc) / cc}
        worst = {k: max(v, gap[k]) for k, v in worst.items()}
        log(f"[zoo] components {name}: {list(m.components)[-1]} "
            f"({len(labels)} columns) on {device} vs cpu: {gap}")
    log(f"[zoo] components: {len(ZOO_COMPONENTS)} classes in "
        f"{time.perf_counter() - t0:.2f} s; largest gaps {worst} against "
        f"tiers delay {TOL_CROSS_DELAY_S} s, phase {TOL_CROSS_PHASE}, "
        f"column {TOL_CROSS_COL}, chi2 {TOL_CROSS_CHI2}")
    check("zoo components", {
        "delays within 1e-12 s": worst["delay_s"] <= TOL_CROSS_DELAY_S,
        "phases within 1e-9 cycles": worst["phase"] <= TOL_CROSS_PHASE,
        "design columns within 1e-9": worst["column"] <= TOL_CROSS_COL,
        "chi2 within 2e-7": worst["chi2_rel"] <= TOL_CROSS_CHI2,
    })


def zoo_structure(key):
    """The structure name of a fleet bucket key."""
    comps = key[0][0]
    for name, binary in (("ELL1H", "BinaryELL1H"), ("ELL1", "BinaryELL1"),
                         ("DD", "BinaryDD")):
        if binary in comps:
            return name
    return "isolated"


def zoo_fleet(torch, counts, device="cuda"):
    """``[zoo] fleet``: the zoo fleet at the main path's counts through
    ``PTAFleet(toa_bucket="plan")`` and ``fit(method="gls", maxiter=2,
    precision="mixed")``, cold then warm, then "f64", from a start 3
    sigma off the truth; K1/K2 launches counted per bucket in the cold
    mixed fit; one single-pulsar GLSFitter per structure against its
    fleet row; the K1/K2 inputs of one more mixed fit recorded per
    shape. Returns {"K1": {structure: (x, block)}, "K2": ...} and the
    launch totals of the cold mixed fit."""
    from pint_tpu_torch.fitter import GLSFitter
    from pint_tpu_torch.kernels import fusedgls, seggram
    from pint_tpu_torch.parallel.pta import PTAFleet

    k1, k2 = fusedgls.fused_block_gls_cuda, seggram.block_grams_cuda
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        models, toas = build_pta(counts, device, par_fn=zoo_par_text,
                                 freq_fn=zoo_freqs, flag_fn=zoo_flags)
    sync()
    make_s = time.perf_counter() - t0
    n_toa = sum(len(t) for t in toas)
    t0 = time.perf_counter()
    fleet = PTAFleet(models, toas, toa_bucket="plan", device=device)
    sync()
    pack_s = time.perf_counter() - t0
    log(f"[zoo] fleet: {len(models)} pulsars, {n_toa} GBT TOAs made on "
        f"{device} in {make_s:.2f} s; plan pack {pack_s:.2f} s, padding "
        f"x{fleet.padding_ratio:.4f}, {len(fleet.batches)} buckets:")
    for key, b in fleet.batches.items():
        k = len(b.free_map())
        desc = (f"packed R={b._pack['n_rows']} S={b._pack['n_slots']} "
                f"Q={b._pack['quantum']} NE={b._pack['n_epochs']}"
                if b._pack else f"unpacked B={b.n_pulsars}")
        log(f"[zoo]   {zoo_structure(key)} width {key[1][1]}: "
            f"{b.n_pulsars} pulsars, {int(np.sum(b.n_toas))} TOAs, {k} free "
            f"+ offset, {desc}")

    names = {i: [n for n, _, _ in fleet.batches[key].free_map()]
             for key, idxs in fleet.group_indices.items() for i in idxs}
    x_true = [np.array([getattr(models[i], n).value for n in names[i]])
              for i in range(len(models))]

    def fit(precision):
        sync()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as wl:
            warnings.simplefilter("always")
            xs, chi2, covs = fleet.fit(method="gls", maxiter=2,
                                       precision=precision)
        sync()
        refit = any("refitting in f64" in str(w.message) for w in wl)
        return ([np.asarray(x) for x in xs], np.asarray(chi2), covs,
                time.perf_counter() - t0, refit)

    xs, _, covs, wall_truth, _ = fit("f64")
    sig = [np.sqrt(np.diag(c)) for c in covs]
    x_start = [x + START_OFFSET_SIGMA * s * np.where(np.arange(len(x)) % 2,
                                                     1, -1)
               for x, s in zip(x_true, sig)]
    for key, idxs in fleet.group_indices.items():
        fleet.batches[key].set_start_vector(np.array([x_start[i]
                                                      for i in idxs]))
    log(f"[zoo] fleet: f64 at the truth {wall_truth:.3f} s, max "
        f"|x - x_true|/sigma {max(np.max(np.abs(a - b) / s) for a, b, s in zip(xs, x_true, sig)):.3e}")

    per_bucket = {}
    for key, b in fleet.batches.items():
        def counted(*a, _fit=b.gls_fit, _key=key, **kw):
            before = (k1.launches, k2.launches)
            out = _fit(*a, **kw)
            per_bucket[_key] = (k1.launches - before[0],
                                k2.launches - before[1])
            return out
        b.gls_fit = counted
    k1.launches = 0
    k2.launches = 0
    xm, cm, cov_m, cold, refit_cold = fit("mixed")
    launches = {"K1": k1.launches, "K2": k2.launches}
    bucket_launches = dict(per_bucket)
    relres = max(m["relres_max"] for m in fleet.fit_metrics.values())
    refit = refit_cold or any(m["refit_f64"]
                              for m in fleet.fit_metrics.values())
    xm2, _, _, warm, refit_warm = fit("mixed")
    for b in fleet.batches.values():
        del b.gls_fit  # the class's method again
    x64, c64, _, wall64, _ = fit("f64")
    sig_m = [np.sqrt(np.diag(c)) for c in cov_m]
    d_mixed = max(np.max(np.abs(a - b) / s) for a, b, s in zip(xm, x64, sig_m))
    d_true = max(np.max(np.abs(a - b) / s) for a, b, s in zip(xm, x_true, sig_m))
    d_warm = max(np.max(np.abs(a - b) / s) for a, b, s in zip(xm2, xm, sig_m))
    log(f"[zoo] fleet: mixed cold {cold:.3f} s ({n_toa / cold:.0f} TOAs/s), "
        f"warm {warm:.3f} s ({n_toa / warm:.0f} TOAs/s); f64 {wall64:.3f} s "
        f"({n_toa / wall64:.0f} TOAs/s)")
    log(f"[zoo] fleet: launches in the cold mixed fit {launches}, per "
        f"bucket (K1, K2): "
        + ", ".join(f"{zoo_structure(k)} {k[1][1]}: {v}"
                    for k, v in bucket_launches.items())
        + f"; max relres {relres:.3e}; f64 refit taken: {refit or refit_warm}")
    worst = max(range(len(models)),
                key=lambda i: np.max(np.abs(xm[i] - x64[i]) / sig_m[i]))
    log(f"[zoo] fleet: max |x_mixed - x_f64|/sigma {d_mixed:.3e} (pulsar "
        f"{worst}, {ZOO_STRUCTURES[worst % 4]}, {len(toas[worst])} TOAs, "
        f"{names[worst][int(np.argmax(np.abs(xm[worst] - x64[worst]) / sig_m[worst]))]}"
        f"); max |x_fit - x_true|/sigma {d_true:.3e} (start "
        f"{START_OFFSET_SIGMA} sigma off)")
    t0 = time.perf_counter()
    profile_run(torch, "[zoo] profile: warm mixed fit",
                lambda: fleet.fit(method="gls", maxiter=2, precision="mixed"))
    log(f"[zoo] fleet: the profiled fit and its report took "
        f"{time.perf_counter() - t0:.2f} s")

    # one single-pulsar GLSFitter (f64) per structure, the median-count
    # pulsar of each, from the fleet's start, against its f64 fleet row
    d_single = {}
    for s_idx, s_name in enumerate(ZOO_STRUCTURES):
        idxs = [i for i in range(len(models)) if i % 4 == s_idx]
        i = sorted(idxs, key=lambda j: len(toas[j]))[len(idxs) // 2]
        m = copy.deepcopy(models[i])
        for n, v in zip(names[i], x_start[i]):
            getattr(m, n).value = float(v)
        sync()
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            f = GLSFitter(toas[i], m, device=device)
            f.fit_toas(maxiter=2)
        sync()
        xf = np.array([getattr(f.model, n).value for n in names[i]])
        sf = np.array([getattr(f.model, n).uncertainty for n in names[i]])
        d_single[s_name] = float(np.max(np.abs(xf - x64[i]) / sf))
        log(f"[zoo] fleet: {s_name} pulsar {i} ({len(toas[i])} TOAs) "
            f"GLSFitter f64 {time.perf_counter() - t0:.3f} s, max |x_single "
            f"- x_fleet|/sigma {d_single[s_name]:.3e}")
    packed = [k for k, b in fleet.batches.items() if b._pack]
    check("zoo fleet", {
        "four structures": {zoo_structure(k) for k in fleet.batches}
            == set(ZOO_STRUCTURES),
        "a packed bucket per structure":
            {zoo_structure(k) for k in packed} == set(ZOO_STRUCTURES),
        "K1 and K2 launched in every packed bucket": all(
            bucket_launches.get(k, (0, 0))[0] > 0
            and bucket_launches.get(k, (0, 0))[1] > 0 for k in packed),
        "refinement contracted (relres <= 1e-8)": relres <= TOL_RELRES,
        "no f64 refit taken": not (refit or refit_warm),
        "mixed vs f64 <= 1e-6 sigma": d_mixed <= TOL_MIXED,
        "recovery <= 0.01 sigma": d_true <= TOL_RECOVER,
        "warm mixed fit reproduces the cold one": d_warm <= TOL_MIXED,
        "finite chi2": bool(np.all(np.isfinite(cm))
                            and np.all(np.isfinite(c64))),
        "single-pulsar GLSFitter within 1e-4 sigma of the fleet's row":
            max(d_single.values()) <= TOL_ZOO_SINGLE,
    })
    t0 = time.perf_counter()
    seen = capture_inputs(fleet, torch, tag=zoo_structure)
    log(f"[zoo] fleet: kernel inputs of {sum(map(len, seen.values()))} "
        f"shapes recorded in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    pipeline_phase(torch, "[pipeline] zoo", fleet, x64, sig_m,
                   lambda k: f"{zoo_structure(k)} {k[1][1]}")
    log(f"[pipeline] zoo took {time.perf_counter() - t0:.2f} s")
    del fleet
    return seen, launches


TOL_REPLAY = 1e-6  # |x_replay - x_eager| / sigma
# the port frames of every sync in [pipeline] main's warm eager fit:
# [[(path, line, function), ...innermost last], ...] ([lint] reads them)
SYNC_STACKS = []


def sync_sites(torch, fn, stacks=None):
    """The synchronizing CUDA calls of ``fn()`` under
    ``torch.cuda.set_sync_debug_mode("warn")``, counted by the port's
    innermost three frames: {"file:line function <- ...": count}. With
    ``stacks`` (a list), each sync's port frames, innermost last, are
    appended to it as [(path, line, function)]."""
    import traceback

    root = os.path.dirname(os.path.abspath(__file__))
    sites = {}

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()[:-1]
                  if "pint_tpu_torch" in f.filename]
        if stacks is not None:
            stacks.append([(os.path.abspath(f.filename), f.lineno, f.name)
                           for f in frames])
        here = [f"{os.path.relpath(f.filename, root)}:{f.lineno} {f.name}"
                for f in frames][-3:]
        key = " <- ".join(reversed(here)) or "(outside the port)"
        sites[key] = sites.get(key, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sites


def piece_times(torch, fn):
    """Host seconds of ``fn()``'s replayed programs by piece kind (each
    piece closed by a device synchronize, so an eager op's time is its
    own): {"graph": s, "<eager op>": s}."""
    from pint_tpu_torch import graphs

    run, total = graphs._run, {}

    def timed(piece, wrappers):
        sync()
        t0 = time.perf_counter()
        run(piece, wrappers)
        sync()
        kind = ("graph" if piece[0] == "graph"
                else getattr(piece[1], "__name__", "eager"))
        total[kind] = total.get(kind, 0.0) + time.perf_counter() - t0

    graphs._run = timed
    try:
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        total["wall"] = time.perf_counter() - t0
    finally:
        graphs._run = run
    return total


def pipeline_phase(torch, tag, fleet, x64, sig, label, stacks=None):
    """``[pipeline]``: the fleet executor on a fleet an earlier phase
    built and fitted (``label(key)`` names a bucket), in mixed,
    ``maxiter=2``, from the fleet's start vectors: the synchronizing
    calls of a warm eager fit of a packed bucket; the warm sequential
    eager fit (timed, profiled); ``fleet_pipeline_metrics`` (precompile
    captures every bucket's program as CUDA graphs with the eighs eager
    between them; sequential and pipelined replays, best of 2, and the
    bitwise flag), logged whole with the graph memory reserved; each
    program's pieces and launches; K1/K2 counted per packed bucket in a
    pipelined replay; the sequential and pipelined replays profiled; the
    host time of the replay's graphs and of its eager eighs; the
    synchronizing calls of a replayed fit. Checks: every program
    captured, pipelined bitwise the sequential replay, K1 and K2 in
    every packed bucket under replay and the Gram kernel in the
    profile, relres <= 1e-8 and no f64 refit, mixed vs f64 <= 1e-6
    sigma, replay vs eager <= 1e-6 sigma (its bitwise flag logged).
    ``x64`` and ``sig`` are per-pulsar lists; ``stacks`` (a list) takes
    the port frames of the warm eager fit's syncs (:func:`sync_sites`).
    Frees the programs."""
    from pint_tpu_torch.kernels import block_grams_cuda, fused_block_gls_cuda
    from pint_tpu_torch.parallel import fleet_pipeline_metrics

    k1, k2 = fused_block_gls_cuda, block_grams_cuda
    kw = dict(method="gls", maxiter=2, precision="mixed")
    packed = [k for k, b in fleet.batches.items() if b._pack]
    b0 = fleet.batches[packed[0]]
    b0.gls_fit(maxiter=2, precision="mixed")
    for site, n in sync_sites(
            torch, lambda: b0.gls_fit(maxiter=2, precision="mixed"),
            stacks).items():
        log(f"{tag} sync, warm eager fit of {label(packed[0])}: {n}x {site}")

    def fit(pipeline):
        sync()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as wl:
            warnings.simplefilter("always")
            xs, chi2, _ = fleet.fit(pipeline=pipeline, **kw)
        sync()
        refit = any("refitting in f64" in str(w.message) for w in wl)
        return ([np.asarray(x) for x in xs], np.asarray(chi2),
                time.perf_counter() - t0, refit)

    xe, ce, eager_s, _ = fit(False)  # warm: the phase before fitted it
    p_eager = profile_run(torch, f"{tag} profile: sequential eager",
                          lambda: fleet.fit(pipeline=False, **kw))
    sync()
    reserved0 = torch.cuda.memory_reserved()
    rep = fleet_pipeline_metrics(fleet, repeats=2, **kw)
    sync()
    reserved1 = torch.cuda.memory_reserved()
    log(f"{tag} fleet_pipeline_metrics: {json.dumps(rep)}")
    log(f"{tag} sequential eager {eager_s:.4f} s, sequential "
        f"replay {rep['fleet_fit_sequential_s']:.4f} s, pipelined replay "
        f"{rep['fleet_fit_pipelined_s']:.4f} s; memory reserved "
        f"{reserved0 / 2**30:.3f} -> {reserved1 / 2**30:.3f} GiB across "
        f"precompile (+{(reserved1 - reserved0) / 2**30:.3f} GiB); "
        f"{gpu_line()}")
    progs = {}
    for key, b in fleet.batches.items():
        prog = b._fns[b.program_key(**kw)]
        progs[key] = prog
        log(f"{tag}   {label(key)}: captured {prog.captured}, "
            f"{len(prog.layout)} pieces {prog.layout}, capture "
            f"{getattr(prog, 'capture_s', 0.0):.3f} s, launches per replay "
            f"{prog.launches}")

    per_bucket = {}
    for key, b in fleet.batches.items():
        def counted(*a, _d=b._dispatch_gls, _key=key, **k):
            before = (k1.launches, k2.launches)
            out = _d(*a, **k)
            per_bucket[_key] = (k1.launches - before[0],
                                k2.launches - before[1])
            return out
        b._dispatch_gls = counted
    k1.launches = k2.launches = 0
    try:
        xr, cr, _, refit = fit(True)
    finally:
        for b in fleet.batches.values():
            del b._dispatch_gls  # the class's method again
    launches = {"K1": k1.launches, "K2": k2.launches}
    metrics = dict(fleet.fit_metrics)
    relres = max(m["relres_max"] for m in metrics.values())
    refit = refit or any(m["refit_f64"] for m in metrics.values())
    log(f"{tag} K1/K2 launches in a pipelined replay {launches}, per packed "
        f"bucket: " + ", ".join(f"{label(k)}: {per_bucket.get(k)}"
                                for k in packed)
        + f"; max relres {relres:.3e}; f64 refit taken: {refit}")
    p_seq = profile_run(torch, f"{tag} profile: sequential replay",
                        lambda: fleet.fit(pipeline=False, **kw))
    p_pipe = profile_run(torch, f"{tag} profile: pipelined replay",
                         lambda: fleet.fit(pipeline=True, **kw))
    gram = {n: v for n, v in (p_pipe or {"ops": {}})["ops"].items()
            if "block_gram_kernel" in n}
    log(f"{tag} Gram kernels in the pipelined replay's profile: "
        + (", ".join(f"{n[:60]} {c}x {ms:.4f} ms" for n, (c, ms) in gram.items())
           or "none"))
    for name, prof in (("sequential eager", p_eager),
                       ("sequential replay", p_seq),
                       ("pipelined replay", p_pipe)):
        if prof:
            log(f"{tag} {name}: wall {prof['wall_s']:.4f} s under the "
                f"profiler, busy {prof['busy_s']:.4f} s "
                f"({100 * prof['busy_s'] / prof['wall_s']:.1f}%)")
    pieces = piece_times(torch, lambda: fleet.fit(pipeline=False, **kw))
    eager_op_s = sum(v for k, v in pieces.items()
                     if k not in ("graph", "wall"))
    log(f"{tag} a sequential replay with every piece synchronized: "
        f"{pieces['wall']:.4f} s, graphs {pieces.get('graph', 0.0):.4f} s, "
        + ", ".join(f"eager {k} {v:.4f} s" for k, v in pieces.items()
                    if k not in ("graph", "wall"))
        + f"; the eager ops keep {100 * eager_op_s / pieces['wall']:.1f}% of "
        "the host wall")
    for site, n in sync_sites(
            torch, lambda: b0.gls_fit(maxiter=2, precision="mixed")).items():
        log(f"{tag} sync, replayed fit of {label(packed[0])}: {n}x {site}")
    d_replay = max(float(np.max(np.abs(a - b) / s))
                   for a, b, s in zip(xr, xe, sig))
    bitwise_replay = (all(np.array_equal(a, b) for a, b in zip(xr, xe))
                      and np.array_equal(cr, ce))
    d_mixed = max(float(np.max(np.abs(a - b) / s))
                  for a, b, s in zip(xr, x64, sig))
    log(f"{tag} replay vs eager: bitwise {bitwise_replay}, max |dx|/sigma "
        f"{d_replay:.3e}; replayed mixed vs f64 max |dx|/sigma "
        f"{d_mixed:.3e}")
    check(tag, {
        "every bucket program captured": all(p.captured
                                             for p in progs.values()),
        "every fit replayed": all(m["replayed"] for m in metrics.values()),
        "pipelined bitwise the sequential replay":
            rep["fleet_pipeline_bitwise"],
        "K1 and K2 launched in every packed bucket under replay": all(
            min(per_bucket.get(k, (0, 0))) > 0 for k in packed),
        "the Gram kernel in the replayed fit's profile":
            p_pipe is None or bool(gram),
        "refinement contracted (relres <= 1e-8)": relres <= TOL_RELRES,
        "no f64 refit taken": not refit,
        "mixed vs f64 <= 1e-6 sigma": d_mixed <= TOL_MIXED,
        "replay vs eager <= 1e-6 sigma": d_replay <= TOL_REPLAY,
        "finite chi2": bool(np.all(np.isfinite(cr))),
    })
    for b in fleet.batches.values():
        b._fns.clear()
    torch.cuda.empty_cache()


LINT_RULES = 22  # the JAX package's rule ids
LINT_SUPPRESSED = 3  # quality-signal-dropped 2, serve-unpadded-batch 1
LINT_TAG = "[lint]"
LINT_STACKS_OF = "[pipeline] main"  # the warm eager fit [lint] classes


def sync_class(frames, device_spans):
    """(class, frame) of one sync from its port frames, innermost last:
    "eager piece" when they pass through ``graphs.eager`` (that frame);
    else "device code" when any of them lies in a device function of
    ``device_spans`` (``rules_retrace.device_code_index``; the innermost
    such frame: a callee in another file of a program's ``fit`` is
    device code through ``fit``'s frame, which the per-file index cannot
    see statically); else "host code" (the innermost frame, None when
    no port frame)."""
    for f in reversed(frames):
        if (f[0].endswith(os.path.join("pint_tpu_torch", "graphs.py"))
                and f[2] == "eager"):
            return "eager piece", f
    for f in reversed(frames):
        if any(a <= f[1] <= b for a, b, _ in device_spans.get(f[0], ())):
            return "device code", f
    return "host code", frames[-1] if frames else None


def lint_start():
    """``[lint]``'s scan, ``python -m pint_tpu_torch.analysis
    pint_tpu_torch/ --format json`` from the checkout's root, started in
    the background (the host is idle while the kernels build). The
    returned thread's ``.result`` is (CompletedProcess, wall s, end
    time on ``time.perf_counter``) once it is joined; the process is
    killed at exit if it still runs."""
    import atexit

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "pint_tpu_torch.analysis", "pint_tpu_torch/",
         "--format", "json"], cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    atexit.register(proc.kill)

    def work():
        out, err = proc.communicate(timeout=600)
        end = time.perf_counter()
        thread.result = (subprocess.CompletedProcess(
            proc.args, proc.returncode, out, err), end - t0, end)

    thread = threading.Thread(target=work, daemon=True)
    thread.start()
    return thread


def lint_phase(scan, host_t0):
    """``[lint]``: pintlint over the port (``scan`` from
    :func:`lint_start`: the CLI a developer runs, in a subprocess),
    its wall and when it ended against ``host_t0`` (the start of the
    first timed host phase, ``[host]``'s ingest), the rule count from
    the analyser's registry; then its device-code index against the
    syncs the card reported in ``[pipeline] main``'s warm eager fit
    (``SYNC_STACKS``): each sync's class logged with the frame that
    decided it, the counts per class. Checks: exit 0, 22 rules, 3
    suppressed findings, syncs recorded, none in device code."""
    from pint_tpu_torch.analysis import all_rules
    from pint_tpu_torch.analysis.rules_retrace import device_code_index

    root = os.path.dirname(os.path.abspath(__file__))
    pkg = os.path.join(root, "pint_tpu_torch")
    scan.join()
    proc, scan_s, end = scan.result
    report = json.loads(proc.stdout) if proc.returncode in (0, 1) else {}
    n_rules = len(all_rules())
    log(f"{LINT_TAG} python -m pint_tpu_torch.analysis pint_tpu_torch/ "
        f"--format json: rc {proc.returncode} in {scan_s:.2f} s, ended "
        f"{end - host_t0:+.2f} s from the start of [host] ingest; "
        f"{report.get('unsuppressed')} unsuppressed, "
        f"{report.get('suppressed')} suppressed "
        f"{report.get('counts_by_rule')}; {n_rules} rules registered")
    if proc.returncode != 0:
        log(f"{LINT_TAG} analyser stderr: {proc.stderr[-2000:]}")
        for f in report.get("findings", []):
            if not f["suppressed"]:
                log(f"{LINT_TAG}   {f['path']}:{f['line']} [{f['rule']}] "
                    f"{f['message']}")
    t0 = time.perf_counter()
    spans = device_code_index([pkg])
    index_s = time.perf_counter() - t0
    classes = {"eager piece": 0, "host code": 0, "device code": 0}
    sites = {}
    for frames in SYNC_STACKS:
        cls, f = sync_class(frames, spans)
        classes[cls] += 1
        at = (f"{os.path.relpath(f[0], root)}:{f[1]} {f[2]}" if f
              else "(outside the port)")
        sites[(cls, at)] = sites.get((cls, at), 0) + 1
    log(f"{LINT_TAG} device-code index: "
        f"{sum(len(v) for v in spans.values())} device functions in "
        f"{len(spans)} files, built in {index_s:.2f} s; {LINT_STACKS_OF}'s "
        f"warm eager fit synced {len(SYNC_STACKS)} times: "
        + ", ".join(f"{k} {v}" for k, v in classes.items()))
    for (cls, at), n in sorted(sites.items()):
        log(f"{LINT_TAG}   {cls}: {n}x at {at}")
    check(LINT_TAG, {
        "the analyser exits 0 over the port": proc.returncode == 0,
        f"{LINT_RULES} rules registered": n_rules == LINT_RULES,
        f"{LINT_SUPPRESSED} suppressed findings":
            report.get("suppressed") == LINT_SUPPRESSED,
        "syncs recorded in the warm eager fit": len(SYNC_STACKS) > 0,
        "no sync inside device code": classes["device code"] == 0,
    })
    return {"classes": classes, "unsuppressed": report.get("unsuppressed"),
            "suppressed": report.get("suppressed")}


WB_PAR = os.path.join(EXAMPLES, "wb_sim.par")
WB_TIM = os.path.join(EXAMPLES, "wb_sim.tim")
WB_FITTERS = ("WidebandTOAFitter", "WidebandTOAFitter_mixed",
              "WidebandDownhillFitter", "WidebandLMFitter")
TOL_WB_CHI2 = 1e-7  # chi2 vs the JAX fixture, relative (ROADMAP §3)
TOL_WB_COV = 1e-10  # f64 uncertainties vs the JAX fixture, relative
TOL_WB_LM_UNC = 1e-5  # LM at its default maxiter (its stopping rule)
TOL_WB_DM = 1e-12  # DM residuals vs the JAX fixture, of the DM
WB_LM_TOL = 1e-9  # WidebandLMFitter.fit_toas's default tol
# [wideband] pulsar: zoo_par_text(1) (J1909-BENCH's ELL1, 17 DMX windows,
# EFAC/EQUAD, 30-harmonic red noise, a free JUMP on Rcvr_800) without
# ECORR, FD1/FD2 frozen, DMEFAC per receiver and DMEQUAD on Rcvr_800
# frozen, and a free DMJUMP on Rcvr_800 (true value 2e-4; selected by its
# band, 720-920 MHz, so the fake maker sees it when it draws the DM flags,
# before the -fe flags are set); one wideband TOA per receiver per epoch
WB_BANDS = (820.0, 1500.0)  # the middle sub-bands of ZOO_BANDS
WB_DMJUMP = 2e-4
WB_DM_ERROR = 1e-4


def wb_pulsar_par():
    text = zoo_par_text(1).replace("ECORR -f L-wide 0.8\n", "")
    text = text.replace("FD1 1.5e-5 1\nFD2 -4e-6 1\n", "FD1 1.5e-5\nFD2 -4e-6\n")
    return text + ("DMEFAC -fe Rcvr_800 1.1\nDMEFAC -fe Rcvr1_2 1.05\n"
                   "DMEQUAD -fe Rcvr_800 2e-5\n"
                   f"DMJUMP freq 720 920 {WB_DMJUMP} 1\n")


def wideband_pack(device="cuda"):
    """``[wideband] pack``: the port's wideband pack (``wb_sim.par/.tim``,
    a J1909-like ELL1 pulsar with DMX, EFAC/EQUAD/ECORR, red noise,
    DMEFAC/DMEQUAD and a free DMJUMP; 300 wideband GBT TOAs written by
    the JAX package) through ``get_model_and_toas`` ->
    ``WidebandTOAResiduals`` on ``device`` (DM residuals within 1e-12 of
    the DM of the JAX package's, time residuals within 1e-3 us), then
    WidebandTOAFitter in f64 and mixed, WidebandDownhillFitter and
    WidebandLMFitter, each timed with its summary printed and held to
    the JAX package's fits in ``WB_postfit.json``: values 1e-6 sigma (LM
    within sqrt(tol chi2) sigma, its stopping rule), uncertainties 1e-10
    (mixed 1e-4, LM 1e-5), chi2 1e-7 (ROADMAP §3); and ``auto_fitter``
    picks WidebandDownhillFitter."""
    import pint_tpu_torch
    from pint_tpu_torch import fitter as tfit
    from pint_tpu_torch.residuals import WidebandTOAResiduals

    with open(os.path.join(EXAMPLES, "WB_postfit.json")) as f:
        fx = json.load(f)
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m, t = pint_tpu_torch.get_model_and_toas(WB_PAR, WB_TIM,
                                                 usepickle=False)
    load_s = time.perf_counter() - t0
    sync()
    t0 = time.perf_counter()
    wb = WidebandTOAResiduals(t, m, device=device)
    d_dm = float(np.max(np.abs(wb.dm.resids - fx["prefit"]["dm_resids"])))
    d_t = float(np.max(np.abs(wb.time_resids
                              - fx["prefit"]["time_resids_s"]))) * 1e6
    resid_s = time.perf_counter() - t0
    log(f"[wideband] pack: get_model_and_toas {load_s:.2f} s, {len(t)} TOAs "
        f"with {int(wb.dm.valid.sum())} DM measurements, components "
        f"{list(m.components)}; WidebandTOAResiduals on {device} "
        f"{resid_s:.3f} s; vs the JAX package's: DM max |d| {d_dm:.3e} "
        f"pc cm^-3, time {d_t:.3e} us, chi2 {wb.chi2:.9f} (JAX "
        f"{fx['prefit']['chi2']:.9f})")
    gaps = {}
    for key in WB_FITTERS:
        ref = fx["fitters"][key]
        sync()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as wl:
            warnings.simplefilter("always")
            f = getattr(tfit, ref["class"])(t, copy.deepcopy(m),
                                            device=device)
            chi2 = float(f.fit_toas(**ref["kwargs"]))
        sync()
        wall = time.perf_counter() - t0
        unc = ref["uncertainties"]
        gaps[key] = {
            "dx_sigma": max(abs(getattr(f.model, n).value - v) / unc[n]
                            for n, v in ref["values"].items()),
            "unc_rel": max(abs(getattr(f.model, n).uncertainty / u - 1)
                           for n, u in unc.items()),
            "chi2_rel": abs(chi2 - ref["chi2"]) / ref["chi2"],
            "f64 fallback": any("f64" in str(w.message) for w in wl)}
        log(f"[wideband] pack {key}: {wall:.3f} s on {device} "
            f"({f.metrics['n_free']} free, iterations "
            f"{f.metrics['iteration_s']}); chi2 {chi2:.9f}; vs the JAX "
            f"fixture: {gaps[key]}")
        for line in f.get_summary().splitlines():
            log(f"[wideband] pack {key} | {line}")
    auto = type(tfit.auto_fitter(t, m, device=device)).__name__
    lm_tol = np.sqrt(WB_LM_TOL * fx["fitters"]["WidebandLMFitter"]["chi2"])
    check("wideband pack", {
        "DM residuals within 1e-12 of the DM of the JAX package's":
            d_dm <= TOL_WB_DM * m.DM.value,
        "time residuals within 1e-3 us of the JAX package's":
            d_t <= TOL_GOLDEN_US,
        "values within 1e-6 sigma of the JAX fixture (LM: its rule)": all(
            g["dx_sigma"] <= (lm_tol if k == "WidebandLMFitter"
                              else TOL_MIXED) for k, g in gaps.items()),
        "uncertainties within their tiers of the JAX fixture": all(
            g["unc_rel"] <= (TOL_MIXED_UNC if k.endswith("mixed")
                             else TOL_WB_LM_UNC if k == "WidebandLMFitter"
                             else TOL_WB_COV) for k, g in gaps.items()),
        "chi2 within 1e-7 of the JAX fixture":
            all(g["chi2_rel"] <= TOL_WB_CHI2 for g in gaps.values()),
        "no f64 fallback in the mixed fit":
            not gaps["WidebandTOAFitter_mixed"]["f64 fallback"],
        "auto_fitter picks WidebandDownhillFitter":
            auto == "WidebandDownhillFitter",
    })


def wideband_pulsar(torch, counts, device="cuda"):
    """``[wideband] pulsar`` at full size: the epochs of the main path's
    largest pulsar (``counts[0]`` TOAs' worth, 7,500 epochs, build_pta's
    draw), one wideband TOA per GBT receiver per epoch at 820 and 1500
    MHz (15,000 TOAs, 15,000 DM rows), made on ``device`` by
    ``make_fake_toas_fromMJDs(..., wideband=True, dm_error_pccm3=1e-4)``
    with ``wb_pulsar_par()``. An f64 WidebandTOAFitter at the truth
    gives sigma; every start is moved 3 sigma off; then
    WidebandTOAFitter mixed cold and warm and f64 (maxiter=2),
    WidebandDownhillFitter and WidebandLMFitter, each timed, with where
    one f64 fit's time goes (host prepare, the two jacfwd blocks, the
    solve) and the warm mixed fit under the profiler. Checks recovery
    <= 0.01 sigma (the DMJUMP included), mixed vs f64 <= 1e-6 sigma, no
    fallback to an f64 Gram, finite chi2."""
    from pint_tpu_torch import fitter as tfit
    from pint_tpu_torch import pint_matrix
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.simulation import make_fake_toas_fromMJDs

    rng = np.random.default_rng(0)  # build_pta's draw for pulsar 0
    days = np.sort(rng.uniform(54000, 57000, max(1, int(counts[0]) // 4)))
    mjds = (days[:, None] + np.array([0.0, 0.5 / 86400.0])).reshape(-1)
    freqs = np.tile(WB_BANDS, len(days))
    truth = get_model(wb_pulsar_par())
    sync()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t = make_fake_toas_fromMJDs(mjds, truth, error_us=1.0,
                                    freq_mhz=freqs, flags={"f": "L-wide"},
                                    iterations=2, wideband=True,
                                    dm_error_pccm3=WB_DM_ERROR,
                                    device=device)
    for f, nu in zip(t.flags, freqs):
        f.update(zoo_flags(nu))
    make_s = time.perf_counter() - t0
    names = list(truth.free_params)
    x_true = np.array([getattr(truth, n).value for n in names])

    def fit(cls, model, **kw):
        sync()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as wl:
            warnings.simplefilter("always")
            f = getattr(tfit, cls)(t, model, device=device)
            chi2 = float(f.fit_toas(**kw))
        sync()
        x = np.array([getattr(f.model, n).value for n in names])
        s = np.array([getattr(f.model, n).uncertainty for n in names])
        fallback = any("f64" in str(w.message) for w in wl)
        return f, x, s, chi2, time.perf_counter() - t0, fallback

    f0, _, sig, _, truth_s, _ = fit("WidebandTOAFitter", copy.deepcopy(truth),
                                    maxiter=1)
    n_rows, n_cols = f0.design_matrix.shape
    n_noise = sum(B.shape[1] for _, B in f0._noise_basis_segments)
    signs = np.where(np.arange(len(names)) % 2, 1.0, -1.0)
    x_start = x_true + START_OFFSET_SIGMA * sig * signs

    def start():
        m = copy.deepcopy(truth)
        for n, v in zip(names, x_start):
            getattr(m, n).value = float(v)
        return m

    runs = {}
    for label, cls, kw in (
            ("mixed cold", "WidebandTOAFitter",
             {"maxiter": 2, "precision": "mixed"}),
            ("mixed warm", "WidebandTOAFitter",
             {"maxiter": 2, "precision": "mixed"}),
            ("f64 cold", "WidebandTOAFitter", {"maxiter": 2}),
            ("f64 warm", "WidebandTOAFitter", {"maxiter": 2}),
            ("WidebandDownhillFitter", "WidebandDownhillFitter", {}),
            ("WidebandLMFitter", "WidebandLMFitter", {})):
        if label == "mixed warm" and device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        runs[label] = fit(cls, start(), **kw)
        if label == "mixed warm" and device == "cuda":
            runs[label] += (torch.cuda.max_memory_allocated(),)
    timers = Timers()
    for owner, attr, label in (
            (tfit.Fitter, "_prepare", "prepare (host pack)"),
            (pint_matrix.DesignMatrix, "from_prepared",
             "time block (jacfwd)"),
            (tfit.WidebandTOAFitter, "_dm_designmatrix", "DM block (jacfwd)"),
            (tfit, "marginalized_chi2", "marginalized chi2"),
            (tfit, "gls_solve", "GLS solve")):
        timers.patch(owner, attr, label)
    try:
        breakdown = fit("WidebandTOAFitter", start(), maxiter=2)
    finally:
        timers.restore()
    xm, xf = runs["mixed warm"][1], runs["f64 warm"][1]
    d_mixed = float(np.max(np.abs(xm - xf) / sig))
    d_true = {k: float(np.max(np.abs(r[1] - x_true) / sig))
              for k, r in runs.items()}
    j = names.index("DMJUMP1")
    log(f"[wideband] pulsar: {len(t)} wideband TOAs + {len(t)} DM rows at "
        f"GBT ({len(days)} epochs x {WB_BANDS} MHz) made on {device} in "
        f"{make_s:.2f} s; combined design {n_rows} x {n_cols} + {n_noise} "
        f"red-noise columns; free {names}; f64 fit at the truth "
        f"{truth_s:.3f} s")
    for k, r in runs.items():
        log(f"[wideband] pulsar {k}: {r[4]:.3f} s ({len(r[0].metrics['iteration_s'])} "
            f"iterations), chi2 {r[3]:.6e}, max |x - x_true|/sigma "
            f"{d_true[k]:.3e} (DMJUMP {abs(r[1][j] - WB_DMJUMP) / sig[j]:.3e}), "
            f"f64 fallback {r[5]}")
    if device == "cuda":
        log(f"[wideband] pulsar mixed warm: max_memory_allocated "
            f"{runs['mixed warm'][6] / 2**30:.3f} GiB")
    log(f"[wideband] pulsar: max |x_mixed - x_f64|/sigma {d_mixed:.3e}")
    log(f"[wideband] pulsar breakdown of one f64 WidebandTOAFitter "
        f"(maxiter=2) {breakdown[4]:.3f} s: " + ", ".join(
            f"{k} {timers.total[k]:.3f} s x{timers.calls[k]}"
            for k in timers.total))
    if device == "cuda":
        profile_run(torch, "[wideband] profile: warm mixed WidebandTOAFitter",
                    lambda: fit("WidebandTOAFitter", start(), maxiter=2,
                                precision="mixed"), top=8)
    check("wideband pulsar", {
        "recovery <= 0.01 sigma, the DMJUMP included":
            max(d_true.values()) <= TOL_RECOVER,
        "mixed vs f64 <= 1e-6 sigma": d_mixed <= TOL_MIXED,
        "no fallback to an f64 Gram": not any(r[5] for r in runs.values()),
        "finite chi2": all(np.isfinite(r[3]) for r in runs.values()),
        "the offset, every free parameter and 60 red-noise columns":
            n_cols == len(names) + 1 and n_noise == 60,
    })


def cli_tools(tmp, device="cuda"):
    """``[cli]``: each command-line tool's ``main([...])`` in-process on
    a temporary directory, as a user runs it: ``zima --wideband`` (with
    noise, on the wideband pack's epochs and receivers) writes a tim
    file; ``pintempo --fitter auto --outfile`` fits it through
    WidebandDownhillFitter on ``--device``; ``convert_parfile -f tempo2``
    and ``-f tempo`` convert the post-fit par, each read back by
    ``get_model`` to the same values; ``compare_parfiles`` on the input
    and output pars; ``tcb2tdb`` on a TCB par; ``t2binary2pint`` on a
    BINARY T2 par; ``pintbary`` at three MJDs; ``pintpublish``. Checks:
    every tool exits with 0, the post-fit DM and DMJUMP within 5 sigma
    of the truth, the tempo2 text uses T2EFAC and has the UNITS line."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.scripts import (compare_parfiles, convert_parfile,
                                        pintbary, pintempo, pintpublish,
                                        t2binary2pint, tcb2tdb, zima)

    def run(tag, main, argv):
        out = io.StringIO()
        sync()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            rc = main(argv)
        sync()
        wall = time.perf_counter() - t0
        text = out.getvalue()
        log(f"[cli] {tag}: exit {rc}, {wall:.3f} s; " + " | ".join(
            text.strip().splitlines()[:3]))
        return rc, text

    tim = os.path.join(tmp, "zima.tim")
    post = os.path.join(tmp, "post.par")
    rcs = {}
    rcs["zima"], _ = run("zima --wideband", zima.main, [
        WB_PAR, tim, "--inputtim", WB_TIM, "--wideband", "--addnoise",
        "--seed", "7", "--device", device])
    rcs["pintempo"], fit_out = run("pintempo --fitter auto", pintempo.main, [
        WB_PAR, tim, "--fitter", "auto", "--outfile", post,
        "--device", device])
    truth, fitted = get_model(WB_PAR), get_model(post)
    pulls = {n: abs(getattr(fitted, n).value - getattr(truth, n).value)
             / getattr(fitted, n).uncertainty for n in ("DM", "DMJUMP1")}
    texts = {}
    for fmt in ("tempo2", "tempo"):
        out = os.path.join(tmp, f"post_{fmt}.par")
        rcs[f"convert_parfile {fmt}"], _ = run(
            f"convert_parfile -f {fmt}", convert_parfile.main,
            [post, "-f", fmt, "-o", out])
        with open(out) as fh:
            texts[fmt] = fh.read()
        back = get_model(out)
        texts[fmt + " read back"] = all(
            getattr(back, n).value == getattr(fitted, n).value
            for n in fitted.free_params)
    rcs["compare_parfiles"], cmp_out = run(
        "compare_parfiles", compare_parfiles.main, [WB_PAR, post])
    tcb = os.path.join(tmp, "tcb.par")
    with open(tcb, "w") as fh:
        fh.write("PSR J1744-1134\nRAJ 17:44:29.4\nDECJ -11:34:54.7\n"
                 "F0 245.4261196 1\nF1 -5.38e-16 1\nPEPOCH 55000\n"
                 "POSEPOCH 55000\nDM 3.139 1\nUNITS TCB\n")
    rcs["tcb2tdb"], _ = run("tcb2tdb", tcb2tdb.main,
                            [tcb, os.path.join(tmp, "tdb.par")])
    t2 = os.path.join(tmp, "t2.par")
    with open(t2, "w") as fh:
        fh.write("PSR J1012+5307\nRAJ 10:12:33.43\nDECJ 53:07:02.5\n"
                 "F0 190.2678376 1\nF1 -6.2e-16\nPEPOCH 55000\nDM 9.02\n"
                 "BINARY T2\nPB 0.60467 1\nA1 0.58181 1\nTASC 50700.08 1\n"
                 "EPS1 1.3e-7 1\nEPS2 -4.0e-7 1\n")
    rcs["t2binary2pint"], _ = run("t2binary2pint", t2binary2pint.main,
                                  [t2, os.path.join(tmp, "ell1.par")])
    rcs["pintbary"], bary = run("pintbary", pintbary.main, [
        "56000.0", "56000.5", "58000.25", "--parfile", WB_PAR, "--obs", "gbt",
        "--freq", "1400", "--device", device])
    rcs["pintpublish"], tex = run("pintpublish", pintpublish.main, [post])
    log(f"[cli] post-fit DM and DMJUMP1 vs the truth: {pulls} sigma")
    check("cli", {
        "every tool exits with 0": all(rc == 0 for rc in rcs.values()),
        "pintempo fits through WidebandDownhillFitter":
            "Fitting with WidebandDownhillFitter" in fit_out,
        "post-fit DM and DMJUMP within 5 sigma of the truth":
            max(pulls.values()) <= 5.0,
        "tempo2 text uses T2EFAC and has a UNITS line":
            "\nT2EFAC " in texts["tempo2"] and "\nUNITS " in texts["tempo2"]
            and "\nEFAC " not in texts["tempo2"],
        "tempo text starts with MODE 1":
            texts["tempo"].splitlines()[0].split() == ["MODE", "1"],
        "both conversions read back to the same values":
            texts["tempo2 read back"] and texts["tempo read back"],
        "compare_parfiles, pintbary and pintpublish printed":
            "DMJUMP1" in cmp_out and len(bary.splitlines()) == 3
            and "\\begin{table}" in tex,
    })


def gw_fleet(fleet, xs):
    """The GW stage on the fitted main-path fleet: assemble, regrid, and
    the optimal statistic in mixed (K3 counted) and in f64. Returns the
    lattice and K3's launches in the mixed run."""
    from pint_tpu_torch import gw
    from pint_tpu_torch.kernels.paircorr import pair_products_cuda

    t0 = time.perf_counter()
    inputs = gw.assemble(fleet, xs)
    asm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lat = gw.regrid(inputs, lattice_days=GW_LATTICE_DAYS)
    regrid_s = time.perf_counter() - t0
    runs = {}
    for precision in ("mixed", "f64"):
        pair_products_cuda.launches = 0
        t0 = time.perf_counter()
        out = gw.optimal_statistic(lat, precision=precision)
        runs[precision] = (out, pair_products_cuda.launches,
                           time.perf_counter() - t0)
    (om, k3_mixed, _), (o64, k3_f64, _) = runs["mixed"], runs["f64"]
    log(f"[gw] fleet: P {lat.n_pulsars}, M {lat.n_cells} cells of "
        f"{GW_LATTICE_DAYS:g} d, pairs kept {om['n_pairs']} of "
        f"{om['sweep']['n_pairs']}; assemble {asm_s:.3f} s, regrid "
        f"{regrid_s:.3f} s (host clock)")
    for name, (o, k3, wall) in runs.items():
        s = o["sweep"]
        log(f"[gw] fleet {name}: optimal statistic {wall:.4f} s, sweep "
            f"{s['wall_s']:.4f} s ({s['pairs_per_s']:.0f} pairs/s), K3 "
            f"launches {k3}; amp2 {o['amp2']!r}, sigma_amp2 "
            f"{o['sigma_amp2']!r}, snr {o['snr']!r}")
    log("[gw] fleet: the main path's TOAs are zero-residual, so this S/N "
        "checks the plumbing at full scale; it is not a science number")
    finite = all(o[k] is not None and np.isfinite(o[k])
                 for o in (om, o64) for k in ("amp2", "snr", "sigma_amp2"))
    check("[gw] fleet", {
        "K3 launched in the mixed run": k3_mixed > 0,
        "K3 not launched in the f64 run": k3_f64 == 0,
        "2278 pairs swept": om["sweep"]["n_pairs"] == 2278,
        "finite amp2 / snr / sigma_amp2": finite,
        "|snr_mixed - snr_f64| <= 1e-3":
            finite and abs(om["snr"] - o64["snr"]) <= TOL_GW_SNR,
        "|amp2_mixed - amp2_f64| <= 1e-3 sigma_amp2":
            finite and abs(om["amp2"] - o64["amp2"])
            <= TOL_GW_AMP2 * o64["sigma_amp2"],
    })
    return lat, k3_mixed


def gw_injected():
    """bench.py's injected-GWB fixture through the mixed sweep."""
    from pint_tpu_torch import gw

    lat = gw.inject_gwb(gw.isotropic_positions(INJ_PSR, seed=0), INJ_CELLS,
                        INJ_AMP, seed=0)
    t0 = time.perf_counter()
    os_ = {orf: gw.optimal_statistic(lat, orf=orf, precision="mixed")
           for orf in ("hd", "monopole", "dipole")}
    t1 = time.perf_counter()
    null = gw.scramble_null(lat, n_draws=INJ_DRAWS, seed=0, mode="sky",
                            precision="mixed", snr_obs=os_["hd"]["snr"])
    t2 = time.perf_counter()
    hd = os_["hd"]
    ratio = (float(np.sqrt(hd["amp2"]) / INJ_AMP)
             if hd["amp2"] is not None and hd["amp2"] > 0 else float("nan"))
    log(f"[gw] injected: {INJ_PSR} pulsars x {INJ_CELLS} cells, amplitude "
        f"{INJ_AMP}: sqrt(amp2)/A {ratio:.4f}, S/N hd {hd['snr']:.3f} "
        f"monopole {os_['monopole']['snr']:.3f} dipole "
        f"{os_['dipole']['snr']:.3f} ({t1 - t0:.3f} s for the three); "
        f"{INJ_DRAWS}-draw sky-scramble null p = {null['p_value']!r} "
        f"(max |S/N| {np.max(np.abs(null['snr_null'])):.3f}, "
        f"{t2 - t1:.3f} s)")
    check("[gw] injected", {
        "0.5 < sqrt(amp2)/A < 2": 0.5 < ratio < 2.0,
        "HD S/N > 5": hd["snr"] > 5.0,
        "HD S/N beats monopole and dipole":
            hd["snr"] > abs(os_["monopole"]["snr"])
            and hd["snr"] > abs(os_["dipole"]["snr"]),
        "null ran its draws": null["n_draws"] == INJ_DRAWS
            and null["p_value"] is not None,
    })


def gw_sweep():
    """The 3,000-pulsar pair sweep with a no-op fold, warm, best of 3,
    in mixed and f64. Returns the lattice and K3's launches per mixed
    sweep."""
    from pint_tpu_torch import gw
    from pint_tpu_torch.kernels.paircorr import pair_products_cuda

    t0 = time.perf_counter()
    lat = gw.inject_gwb(gw.isotropic_positions(SWEEP_PSR, seed=1),
                        SWEEP_CELLS, 0.0, seed=1)
    log(f"[gw] sweep: {SWEEP_PSR} pulsars x {SWEEP_CELLS} cells made in "
        f"{time.perf_counter() - t0:.2f} s (host)")
    launches = {}
    for precision in ("mixed", "f64"):
        gw.correlation_sweep(lat.z, lat.w, lambda *a: None,
                             block=SWEEP_BLOCK, precision=precision)
        walls = []
        for _ in range(3):
            pair_products_cuda.launches = 0
            s = gw.correlation_sweep(lat.z, lat.w, lambda *a: None,
                                     block=SWEEP_BLOCK, precision=precision)
            walls.append(s["wall_s"])
            launches[precision] = pair_products_cuda.launches
        best = min(walls)
        log(f"[gw] sweep {precision}: {s['n_pairs']} pairs in "
            f"{s['n_blocks']} tiles of {SWEEP_BLOCK}; best of 3 {best:.4f} s "
            f"({s['n_pairs'] / best:.0f} pairs/s), runs "
            f"{', '.join(f'{w:.4f}' for w in walls)} s; K3 launches per "
            f"sweep {launches[precision]}")
        # the same sweep through the HD optimal statistic's host fold
        # (hd_curve on every pair): how much of a real sweep the fold is
        hd = gw.optimal_statistic(lat, precision=precision,
                                  block=SWEEP_BLOCK)["sweep"]["wall_s"]
        log(f"[gw] sweep {precision}: with the HD optimal-statistic fold "
            f"{hd:.4f} s ({hd - best:.4f} s, {100 * (hd - best) / hd:.1f}% "
            f"of it, beyond the no-op sweep)")
    n_tiles = s["n_blocks"]
    check("[gw] sweep", {
        "K3 launched once per tile in mixed": launches["mixed"] == n_tiles,
        "K3 not launched in f64": launches["f64"] == 0,
    })
    return lat, launches["mixed"]


def pair_record(torch, fleet_lat, sweep_lat, launches, sweep_launches):
    """K3 against its plain f32 version (and the f64 reference) at the
    fleet's shape, one 256 x 256 sweep tile and the whole 3000 x 3000
    product; CUDA-event times of each. Returns the JSON entry, at the
    whole shape, with the other two shapes as fields."""
    from pint_tpu_torch.kernels.paircorr import (pair_products_cuda,
                                                 pair_products_plain,
                                                 pair_products_ref)

    def upload(lat, dtype):
        u = torch.as_tensor(lat.w * lat.z, device="cuda").to(dtype)
        return u, torch.as_tensor(lat.w, device="cuda").to(dtype)

    fu, fw = upload(fleet_lat, torch.float32)
    fu64, fw64 = upload(fleet_lat, torch.float64)
    su, sw = upload(sweep_lat, torch.float32)
    su64, sw64 = upload(sweep_lat, torch.float64)
    a, b = slice(0, SWEEP_BLOCK), slice(SWEEP_BLOCK, 2 * SWEEP_BLOCK)
    shapes = {
        "fleet": ((fu, fw, fu, fw), (fu64, fw64, fu64, fw64)),
        "tile": ((su[a], sw[a], su[b], sw[b]),
                 (su64[a], sw64[a], su64[b], sw64[b])),
        "whole": ((su, sw, su, sw), (su64, sw64, su64, sw64)),
    }
    rec = {}
    for label, (ins, ins64) in shapes.items():
        ins = tuple(t.contiguous() for t in ins)
        out = pair_products_cuda(*ins)
        torch.cuda.synchronize()
        ref32 = pair_products_plain(*ins)
        ref64 = pair_products_ref(*ins64)
        d32, rel32, rel64 = [], [], []
        for o, r32, r64 in zip(out, ref32, ref64):
            d = (o - r32).abs().max().item()
            scale = r32.abs().max().item()
            d32.append(d)
            rel32.append(d / scale if scale else d)
            scale64 = r64.abs().max().item()
            d64 = (o.double() - r64).abs().max().item()
            rel64.append(d64 / scale64 if scale64 else d64)
        ba, m = ins[0].shape
        bb = ins[2].shape[0]
        ua, wa, ub, wb = ins
        ms = cuda_ms(torch, lambda: pair_products_cuda(*ins))
        plain_ms = cuda_ms(torch, lambda: pair_products_plain(*ins))
        library_ms = cuda_ms(torch, lambda: (torch.matmul(ua, ub.mT),
                                             torch.matmul(wa, wb.mT)))
        nbytes = 4.0 * (2 * (ba + bb) * m + 2 * ba * bb)
        flops = 4.0 * ba * bb * m
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        t_ops = flops / PEAK_F32_FLOP_S * 1e3
        log(f"[kernel] pair_products {label} ({ba}, {m}) x ({bb}, {m}) f32: "
            f"vs plain f32 max|d| num {d32[0]:.3e} den {d32[1]:.3e} "
            f"({rel32[0]:.3e}, {rel32[1]:.3e} of max|.|), vs f64 "
            f"{rel64[0]:.3e}, {rel64[1]:.3e} of max|.|")
        log(f"[kernel] pair_products {label}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, 2x torch.matmul {library_ms:.4f} ms, bound "
            f"{max(t_bytes, t_ops):.4f} ms ({nbytes / 1e6:.2f} MB, "
            f"{flops / 1e9:.4f} GFLOP)")
        if not max(rel32) <= TOL_KERNEL:
            raise AssertionError(f"pair_products disagrees with its plain "
                                 f"version at the {label} shape: "
                                 f"{max(rel32):.3e} > {TOL_KERNEL}")
        rec[label] = {"shape": [ba, bb, m], "max_abs_err": max(d32),
                      "max_rel_err": max(rel32), "ms": ms,
                      "plain_ms": plain_ms,
                      "bound_ms": max(t_bytes, t_ops),
                      "bound_by": "bytes" if t_bytes >= t_ops
                      else "operations", "library_ms": library_ms,
                      "launch": pair_geometry(*ins)}
        log(f"[kernel] pair_products {label}: launch {rec[label]['launch']}")
    whole = rec.pop("whole")
    return {"name": "pair_products", "route": "cuda",
            "source": "pint_tpu_torch/csrc/paircorr.cu",
            "replaces": "pint_tpu/kernels/paircorr.py:65",
            "launches": int(launches), **whole, "tile": rec["tile"],
            "fleet": rec["fleet"], "sweep_launches": int(sweep_launches)}


def lane_par_text(i):
    """par_text(i) without its correlated noise (ECORR and red noise):
    EFAC/EQUAD kept, F0/F1/DM free — a model that gets an incremental
    streaming lane."""
    return "".join(line + "\n" for line in par_text(i).splitlines()
                   if not line.startswith(("ECORR", "RN", "TNRED")))


def sync():
    import torch

    torch.cuda.synchronize()


def stream_traffic(models, device, extra_lane, seed=11):
    """Each lane's append chunks: STREAM_ROUNDS chunks of 64 TOAs (16
    epochs x 4 TOAs 0.5 s apart, alternating 800/1400 MHz, flagged -f
    L-wide, epochs uniform after MJD 57000, white noise at the lane
    model's EFAC/EQUAD-scaled 1 us errors), and STREAM_EXTRA more for
    ``extra_lane``. One simulation per lane, cut into chunks."""
    from pint_tpu_torch.simulation import make_fake_toas_fromMJDs

    out = []
    for i, m in enumerate(models):
        n = STREAM_ROUNDS + (STREAM_EXTRA if i == extra_lane else 0)
        rng = np.random.default_rng([seed, i])
        days = np.sort(rng.uniform(57000, 57000 + 30 * n, 16 * n))
        mjds = (days[:, None] + np.arange(4) * 0.5 / 86400.0).reshape(-1)
        freqs = np.where(np.arange(len(mjds)) % 2, 1400.0, 800.0)
        t = make_fake_toas_fromMJDs(mjds, m, error_us=1.0, freq_mhz=freqs,
                                    flags={"f": "L-wide"}, add_noise=True,
                                    seed=seed * 1000 + i, iterations=2,
                                    device=device)
        which = np.arange(len(t)) // STREAM_CHUNK
        out.append([t.mask(which == k) for k in range(n)])
    return out


class Timers:
    """Host-clock time per labelled call, each call closed by a device
    synchronize: where an append's time goes. ``patch`` wraps
    ``owner.attr`` (a module function, a class method or an instance's
    bound method); ``restore`` puts every original back."""

    def __init__(self):
        self.total = {}
        self.calls = {}
        self._orig = []

    def patch(self, owner, attr, label):
        fn = getattr(owner, attr)
        self._orig.append((owner, attr, owner.__dict__.get(attr, fn)))

        def timed(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            sync()
            self.total[label] = self.total.get(label, 0.0) \
                + time.perf_counter() - t0
            self.calls[label] = self.calls.get(label, 0) + 1
            return out

        setattr(owner, attr, timed)

    def restore(self):
        for owner, attr, fn in reversed(self._orig):
            setattr(owner, attr, fn)
        self._orig = []


def lane_sigma(lane):
    """Un-normalized parameter sigmas of a lane from its (ridged) normal
    matrix, offset dropped."""
    covn = np.linalg.inv(lane.state.A.numpy())
    return (np.sqrt(np.diag(covn)) / lane.norm)[1:]


def stream_lanes(main_models, toas, tmp, device="cuda"):
    """The streaming slice over the main path's TOAs: ``[stream] lanes``,
    ``restart``, ``escalation`` and ``correlated``. Returns K1′'s
    launches in the lanes' run and a lane's persisted chunk arrays (the
    input K1′ got there)."""
    from pint_tpu_torch.kernels import incremental as inc
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.resilience import faultinject
    from pint_tpu_torch.serve import StreamingRefitter
    from pint_tpu_torch.store import DeltaStore
    from pint_tpu_torch.toa import merge_TOAs

    n_lanes = len(toas)
    models = [get_model(lane_par_text(i)) for i in range(n_lanes)]
    order = list(np.argsort([len(t) for t in toas], kind="stable"))
    pick = [order[0], order[1], order[-2], order[-1]]
    esc, cor = order[2], order[0]
    t0 = time.perf_counter()
    traffic = stream_traffic(models, device, extra_lane=esc)
    log(f"[stream] traffic: {n_lanes} lanes x {STREAM_ROUNDS} chunks of "
        f"{STREAM_CHUNK} TOAs made in {time.perf_counter() - t0:.2f} s "
        f"(host)")

    # -- [stream] lanes: the streaming main path, K1′ counted --
    sr = StreamingRefitter(deltas=DeltaStore(tmp), device=device)
    inc.delta_gram_cuda.launches = 0
    reg = []
    for m, t in zip(models, toas):
        sync()
        t0 = time.perf_counter()
        sr.register(m, t, precision="mixed")
        sync()
        reg.append(time.perf_counter() - t0)
    timers = Timers()
    timers.patch(sr, "_chunk_arrays", "rows (batch build + device eval)")
    timers.patch(sr.deltas, "append", "delta store write (fsync)")
    timers.patch(inc.IncrementalNormal, "append", "state append")
    timers.patch(inc, "delta_gram", "  of which delta Gram (K1')")
    timers.patch(inc, "chol_update", "  of which chol_update (host)")
    timers.patch(sr, "_solve", "solve (host)")
    walls, res = [], {i: [] for i in range(n_lanes)}
    try:
        for k in range(STREAM_ROUNDS):
            for i, m in enumerate(models):
                sync()
                t0 = time.perf_counter()
                res[i].append(sr.append(m, traffic[i][k], rid=f"{i}-{k}"))
                sync()
                walls.append(time.perf_counter() - t0)
    finally:
        timers.restore()
    launches = inc.delta_gram_cuda.launches
    outs = [o for i in res for o in res[i]]
    solvers = {}
    for o in outs:
        solvers[o["solver"]] = solvers.get(o["solver"], 0) + 1
    relres = max(o["relres"] for o in outs if o["solver"] == "chol_update")
    n_app = n_lanes * STREAM_ROUNDS
    wall_ms = np.array(walls) * 1e3
    log(f"[stream] lanes: {n_lanes} lanes over {sum(len(t) for t in toas)} "
        f"base TOAs registered in {sum(reg):.3f} s (slowest lane "
        f"{max(reg):.3f} s, {len(toas[int(np.argmax(reg))])} TOAs; host "
        f"clock)")
    log(f"[stream] lanes: {n_app} mixed appends of {STREAM_CHUNK} TOAs: "
        f"append wall p50 {np.percentile(wall_ms, 50):.3f} ms, p99 "
        f"{np.percentile(wall_ms, 99):.3f} ms, max {wall_ms.max():.3f} ms, "
        f"total {wall_ms.sum() / 1e3:.3f} s (host clock after synchronize); "
        f"K1' launches {launches}; solvers {solvers}, max chol_update "
        f"relres {relres:.3e}; escalations {sr.counters()['escalated']}")
    for label, tot in timers.total.items():
        log(f"[stream]   {label}: {1e3 * tot / timers.calls[label]:.3f} ms "
            f"per call x {timers.calls[label]} ({100 * tot / (wall_ms.sum() / 1e3):.1f}% "
            f"of the append wall)")
    check("[stream] lanes", {
        "K1' launched once per append": launches == n_app,
        "every x and chi2 finite": all(
            np.all(np.isfinite(o["x"])) and np.isfinite(o["chi2"])
            for o in outs),
        "no escalation": sr.counters()["escalated"] == 0
            and not any(o["escalated"] for o in outs),
        "relres <= 1e-12 on chol_update solves": relres <= TOL_RELRES_CHOL,
    })

    # mixed vs f64 on the two smallest and the two largest lanes
    sr64 = StreamingRefitter(device=device)
    gap = {}
    for i in pick:
        sr64.register(models[i], toas[i], precision="f64")
        lane64 = sr64.lane(models[i])
        for k in range(STREAM_ROUNDS):
            o64 = sr64.append(models[i], traffic[i][k], rid=f"{i}-{k}")
            gap[i] = max(gap.get(i, 0.0), float(np.max(
                np.abs(res[i][k]["x"] - o64["x"]) / lane_sigma(lane64))))
    worst = max(gap.values())
    log(f"[stream] lanes: mixed vs f64, {STREAM_ROUNDS} appends on each of "
        f"the lanes of {[len(toas[i]) for i in pick]} TOAs: max "
        f"|x_mixed - x_f64|/sigma {[f'{gap[i]:.3e}' for i in pick]}")
    check("[stream] lanes mixed vs f64", {
        "|x_mixed - x_f64| <= 1e-6 sigma": worst <= TOL_MIXED})

    # -- [stream] restart: a second process over the same delta store --
    sr2 = StreamingRefitter(deltas=DeltaStore(tmp), device=device)
    gaps = []
    t0 = time.perf_counter()
    for i in pick:
        sr2.register(models[i], toas[i], precision="mixed")
        x2, chi2_2, _ = sr2._solve(sr2.lane(models[i]))
        last = res[i][-1]
        gaps.append((float(np.max(np.abs(x2 - last["x"]))),
                     abs(chi2_2 - last["chi2"])))
    log(f"[stream] restart: 4 lanes re-registered in "
        f"{time.perf_counter() - t0:.3f} s, {sr2.counters()['replayed']} "
        f"links replayed; max |x - x_first|, |chi2 - chi2_first| "
        f"{max(g[0] for g in gaps)!r}, {max(g[1] for g in gaps)!r}")
    # the chain tips on disk, read by the second process's store, against
    # the first process's lanes; a fresh lane with no delta gives its base
    t0 = time.perf_counter()
    tips = [(sr2.deltas.tip(sr2.lane(models[i]).key,
                            sr2.lane(models[i]).base_signature),
             sr.lane(models[i]).tip) for i in pick]
    fresh_model = get_model(lane_par_text(order[0]).replace(
        "PSR BEN", "PSR FRESH"))
    sr2.register(fresh_model, toas[order[0]], precision="mixed")
    fresh_lane = sr2.lane(fresh_model)
    fresh_tip = sr2.deltas.tip(fresh_lane.key, fresh_lane.base_signature)
    tip_s = time.perf_counter() - t0
    log(f"[stream] restart: DeltaStore.tip of the 4 lanes == the first "
        f"process's lane.tip: {[a == b for a, b in tips]}; a fresh lane "
        f"({len(toas[order[0]])} TOAs, registered) gives its base "
        f"signature: {fresh_tip == fresh_lane.base_signature}; "
        f"{tip_s:.3f} s")
    check("[stream] restart", {
        "16 links replayed": sr2.counters()["replayed"] == 4 * STREAM_ROUNDS,
        "x and chi2 bitwise the first process's":
            all(g == (0.0, 0.0) for g in gaps),
        "tips bitwise the first process's lane.tip":
            all(a == b for a, b in tips),
        "a lane with no delta: its base signature":
            fresh_tip == fresh_lane.base_signature == fresh_lane.tip,
    })

    # -- [stream] escalation: a fifth append diverges --
    m = models[esc]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with faultinject.inject("solver_diverge"):
            t0 = time.perf_counter()
            out5 = sr.append(m, traffic[esc][STREAM_ROUNDS], rid="esc-5")
            esc_s = time.perf_counter() - t0
    fresh = StreamingRefitter(device=device)
    fresh.register(m, merge_TOAs([toas[esc]]
                                 + traffic[esc][:STREAM_ROUNDS + 1]),
                   precision="mixed")
    x_f, chi2_f, _ = fresh._solve(fresh.lane(m))
    out6 = sr.append(m, traffic[esc][STREAM_ROUNDS + 1], rid="esc-6")
    lane = sr.lane(m)
    chain = sr.deltas.load_chain(lane.key, lane.base_signature)
    dx = float(np.max(np.abs(out5["x"] - x_f)))
    log(f"[stream] escalation: lane of {len(toas[esc])} TOAs, 5th append "
        f"under solver_diverge escalated ({out5.get('escalation_reason')}) "
        f"in {esc_s:.3f} s; vs a fresh registration on the merged TOAs "
        f"max |dx| {dx!r}, |dchi2| {abs(out5['chi2'] - chi2_f)!r}; next "
        f"append escalated={out6['escalated']}, chain links {len(chain)}")
    check("[stream] escalation", {
        "escalated on solver_diverge": out5["escalated"]
            and out5["escalation_reason"] == "solver_diverge",
        "bitwise a fresh registration": dx == 0.0 and out5["chi2"] == chi2_f,
        "chain re-rooted, next append on it": not out6["escalated"]
            and [c for c, _ in chain] == [out6["chain"]],
    })

    # -- [stream] correlated: a main-path model (ECORR + red noise) --
    src = StreamingRefitter(device=device)
    src.register(main_models[cor], toas[cor], precision="mixed")
    t0 = time.perf_counter()
    oc = src.append(main_models[cor], traffic[cor][0], rid="cor-0")
    log(f"[stream] correlated: lane of {len(toas[cor])} TOAs with ECORR + "
        f"red noise: append -> {oc['solver']} "
        f"({oc.get('escalation_reason')}) in "
        f"{time.perf_counter() - t0:.3f} s")
    check("[stream] correlated", {
        "full refit for correlated noise":
            oc["escalated"] and oc["escalation_reason"] == "correlated_noise",
        "finite x": bool(np.all(np.isfinite(oc["x"]))),
    })
    arrays = sr.deltas.load_chain(sr.lane(models[pick[-1]]).key,
                                  sr.lane(models[pick[-1]]).base_signature)
    return launches, arrays[-1][1], tip_s


def chol_update_eager(torch, L, V):
    """The JAX package's rank-r update as eager torch ops on L's device
    (a yardstick for the host placement in kernels/incremental.py)."""
    K = L.shape[0]
    idx = torch.arange(K, device=L.device)
    L = L.clone()
    for v in V.mT:
        for j in range(K):
            ljj, vj = L[j, j], v[j]
            rad = torch.sqrt(ljj * ljj + vj * vj)
            c, s = rad / ljj, vj / ljj
            below = idx > j
            newcol = torch.where(below, (L[:, j] + s * v) / c, L[:, j])
            newcol[j] = rad
            L[:, j] = newcol
            v = torch.where(below, c * v - s * newcol, v)
    return L


def best_of(n, fn):
    walls = []
    for _ in range(n):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        walls.append(time.perf_counter() - t0)
    return min(walls), out


def stream_kernel(torch, device="cuda", n_base=670_000):
    """``[stream] kernel``: bench.py's kernel scenario (670,000 base rows
    resident on the card, K = 10, 64 appended rows from the host, seed
    42): the scratch refit and clone + append + solve, best of 3, in f64
    and mixed; parity; the placement of chol_update. Returns the
    appended rows."""
    from pint_tpu_torch.kernels import incremental as inc

    rng = np.random.default_rng(42)
    n_app, K = 64, 10
    Xb = rng.standard_normal((n_base, K))
    rb = rng.standard_normal(n_base) * 1e-6
    wb = rng.uniform(0.5, 2.0, n_base) * 1e6
    Xa = rng.standard_normal((n_app, K))
    ra = rng.standard_normal(n_app) * 1e-6
    wa = rng.uniform(0.5, 2.0, n_app) * 1e6
    q = np.full(K, 1e-6)
    base_dev = tuple(torch.as_tensor(a, device=device) for a in (Xb, rb, wb))
    chunks = [base_dev, (Xa, ra, wa)]
    base = inc.build_normal(*base_dev, q=q, device=device)
    scratch_s, (dx_sc, _, _, info_sc) = best_of(
        3, lambda: inc.scratch_refit(chunks, q=q, device=device))
    times, dxs, k1p = {}, {}, {}
    for precision in ("f64", "mixed"):
        def clone_append_solve():
            st = inc.IncrementalNormal(base.A0, base.b, base.rNr, q=base.q,
                                       device=device)
            st.append(Xa, ra, wa, precision=precision)
            return st.solve()

        inc.delta_gram_cuda.launches = 0
        times[precision], (dxs[precision], _, info) = best_of(
            3, clone_append_solve)
        k1p[precision] = inc.delta_gram_cuda.launches
        log(f"[stream] kernel {precision}: clone + append + solve best of 3 "
            f"{1e3 * times[precision]:.3f} ms ({info['solver']}), scratch "
            f"refit {1e3 * scratch_s:.3f} ms ({info_sc['solver']}): "
            f"{scratch_s / times[precision]:.1f}x; K1' launches "
            f"{k1p[precision]}")
    ref = dx_sc.numpy()
    den = np.maximum(np.abs(ref),
                     np.finfo(np.float64).eps * np.abs(ref).max())
    parity = float(np.max(np.abs(dxs["f64"].numpy() - ref) / den))
    g64 = inc.delta_gram(Xa, ra, wa, precision="f64").numpy()
    rows = [torch.as_tensor(a, device=device) for a in (Xa, ra, wa)]
    gmx = inc.delta_gram(*rows, precision="mixed").cpu().numpy()
    used = slice(0, K + 1)
    dg = float(np.abs(gmx - g64)[used, used].max()
               / np.abs(g64)[used, used].max())
    # where chol_update runs: host numpy (the port) vs eager torch on the
    # card, on this scenario's factor (K = 10) and rows
    V = torch.as_tensor(Xa * wa[:, None]).mT.contiguous()
    host_s, Lh = best_of(3, lambda: inc.chol_update(base.L, V))
    Ld, Vd = base.L.to(device), V.to(device)
    dev_s, Lc = best_of(3, lambda: chol_update_eager(torch, Ld, Vd))
    lgap = float((Lc.cpu() - Lh).abs().max() / Lh.abs().max())
    log(f"[stream] kernel: f64 parity vs scratch {parity:.3e} "
        f"(floored relative); mixed delta Gram vs f64 {dg:.3e} of max|dG| "
        f"over the entries read; chol_update (K={K}, r={n_app}) host "
        f"{1e3 * host_s:.3f} ms vs eager on the card {1e3 * dev_s:.3f} ms "
        f"(gap {lgap:.1e})")
    check("[stream] kernel", {
        "f64 parity <= 1e-15": parity <= TOL_PARITY,
        "K1' launched once per mixed append": k1p["mixed"] == 3,
        "mixed delta Gram within 1e-5 of f64": dg <= TOL_KERNEL,
    })
    return Xa, ra, wa


def delta_record(torch, lane_arrays, scenario_rows, launches):
    """K1′ at the lane shape (a lane's persisted 64-row chunk, Ka = 6)
    and at the kernel scenario's (64 x 12), held against its plain f32
    version and f64, timed beside one f32 ``torch.mm`` and the bound.
    Returns the JSON entry at the lane shape, the other as a field."""
    from pint_tpu_torch.kernels import incremental as inc
    from pint_tpu_torch.kernels.fusedgls import augment

    rec = {}
    for label, (X, r, winv) in (("lane", (lane_arrays["X"],
                                          lane_arrays["r"],
                                          lane_arrays["winv"])),
                                ("scenario", scenario_rows)):
        rows = [torch.as_tensor(np.array(a), device="cuda")
                for a in (X, r, winv)]
        aug64 = augment(*inc.pad_append_rows(*rows))
        aug = aug64.float().contiguous()
        n, ka = aug.shape
        out = inc.delta_gram_cuda(aug)
        sync()
        ref32 = inc.delta_gram_plain(aug)
        ref64 = inc.delta_gram_plain(aug64)
        u = ka - 1  # the winv row/column is never read
        d32 = (out - ref32)[:u, :u].abs().max().item()
        rel32 = d32 / ref32[:u, :u].abs().max().item()
        rel64 = ((out.double() - ref64)[:u, :u].abs().max().item()
                 / ref64[:u, :u].abs().max().item())
        xw = aug * aug[:, -1:]
        ms = cuda_ms(torch, lambda: inc.delta_gram_cuda(aug))
        plain_ms = cuda_ms(torch, lambda: inc.delta_gram_plain(aug))
        library_ms = cuda_ms(torch, lambda: torch.mm(xw.mT, xw))
        nbytes = 4.0 * (n * ka + ka * ka)
        flops = n * ka * (ka + 1) + n * ka
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        t_ops = flops / PEAK_F32_FLOP_S * 1e3
        log(f"[kernel] delta_gram {label} ({n}, {ka}) f32: vs plain f32 "
            f"max|d| {d32:.3e} ({rel32:.3e} of max|G|), vs f64 {rel64:.3e}; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.mm "
            f"{library_ms:.4f} ms, bound {max(t_bytes, t_ops):.7f} ms "
            f"({nbytes:.0f} B, {flops:.0f} FLOP)")
        if not rel32 <= TOL_KERNEL:
            raise AssertionError(f"delta_gram disagrees with its plain "
                                 f"version at the {label} shape: "
                                 f"{rel32:.3e} > {TOL_KERNEL}")
        rec[label] = {"shape": [n, ka], "max_abs_err": d32, "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                      "bound_by": "bytes" if t_bytes >= t_ops
                      else "operations", "library_ms": library_ms}
    lane = rec.pop("lane")
    return {"name": "delta_gram", "route": "cuda",
            "source": "pint_tpu_torch/csrc/gram.cu",
            "replaces": "pint_tpu/kernels/incremental.py:109",
            "launches": int(launches), **lane, "scenario": rec["scenario"]}


# -- [photon]: event file -> phases -> H-test / Z^2_m -> template fit --

def photon_draws(seed, n=None, n_pulsed=None):
    """bench.py's photon stage drawn with ``seed``: ``n_pulsed`` photons
    at phase 0.3 with a Gaussian sigma of 0.04, the rest uniform, over
    one year from MJD 56700, with PSRPROB-like weights (pulsed
    U(0.5, 1), background U(0, 0.5)); n and n_pulsed default to
    PHOTON_N and PHOTON_PULSED. Times invert PHOTON_PAR's spindown
    phase phi(t) = F0 t + F1 t^2 / 2 exactly (Newton in longdouble to
    < 1 ns). Returns {"t": barycentric TDB seconds since PEPOCH, "phi":
    the drawn phases, "w": the weights, "pulsed": the pulsed mask},
    sorted by time (t and phi in longdouble), and the last Newton
    step's largest size [s]."""
    n = PHOTON_N if n is None else n
    n_pulsed = PHOTON_PULSED if n_pulsed is None else n_pulsed
    rng = np.random.default_rng(seed)
    f0, f1 = np.longdouble(PHOTON_F0), np.longdouble(PHOTON_F1)
    span = np.longdouble(PHOTON_SPAN_DAYS * 86400.0)
    cycles = float(f0 * span + f1 * span * span / 2)
    phi = np.empty(n, np.longdouble)
    phi[:n_pulsed] = (np.floor(rng.uniform(0.0, cycles - 1.0, n_pulsed))
                      + PHOTON_LOC + PHOTON_SIGMA
                      * rng.standard_normal(n_pulsed))
    phi[n_pulsed:] = rng.uniform(0.0, cycles, n - n_pulsed)
    w = np.concatenate([rng.uniform(0.5, 1.0, n_pulsed),
                        rng.uniform(0.0, 0.5, n - n_pulsed)])
    t = phi / f0
    for _ in range(6):
        step = (f0 * t + f1 * t * t / 2 - phi) / (f0 + f1 * t)
        t = t - step
    worst = float(np.max(np.abs(step)))
    if not worst < 1e-9:
        raise AssertionError(f"photon times did not converge: {worst} s")
    order = np.argsort(t, kind="stable")
    pulsed = np.arange(n) < n_pulsed
    return {"t": t[order], "phi": phi[order], "w": w[order],
            "pulsed": pulsed[order]}, worst


def photon_events(path, seed=0):
    """``photon_draws(seed)`` as a barycentred NICER event file: TIMESYS
    TDB, a PSRPROB weight column. Returns the draws and the inversion's
    last Newton step [s]."""
    from pint_tpu_torch.event_toas import MISSION_MJDREF
    from pint_tpu_torch.io.fits import write_fits_table

    draws, worst = photon_draws(seed)
    ref = MISSION_MJDREF["nicer"]
    met = (np.longdouble(PHOTON_PEPOCH) - np.longdouble(ref)) * 86400 \
        + draws["t"]
    write_fits_table(path, {"TIME": np.asarray(met, np.float64),
                            "PSRPROB": draws["w"]},
                     {"MJDREFI": int(ref), "MJDREFF": ref - int(ref),
                      "TIMESYS": "TDB", "TELESCOP": "NICER"})
    return draws, worst


def h_f64(torch, phases, m, weights=None):
    """The H-test of ``phases`` from the f64 reference sums on the same
    device (eventstats.hm's formula over harmonic_sums_ref)."""
    from pint_tpu_torch.eventstats import _h_of

    return _h_of(z_f64(torch, phases, m, weights))


def z_f64(torch, phases, m, weights=None):
    """Z^2_1..m from the f64 reference sums (eventstats.z2m's formula)."""
    from pint_tpu_torch.kernels.harmonics import harmonic_sums_ref

    c, s = harmonic_sums_ref(phases, m, weights)
    norm = (phases.shape[-1] / 2.0 if weights is None
            else torch.sum(weights.double() ** 2) / 2.0)
    return torch.cumsum((c ** 2 + s ** 2) / norm, dim=-1)


def photon_path(torch, tmp, device="cuda"):
    """The ``[photon]`` phases: write and load the event file, fill the
    barycentre posvels, the timing model's phase on the card, H-test /
    weighted H-test / Z^2_4 (K4 counted per statistic, held to the f64
    reference), a uniform-photon null, the 32-trial hm_scan, the
    template fit and the photonphase CLI. Returns K4's launches per
    step and the inputs K4 got: the folded phases, the weights and the
    scan's (32, n) phases in f32; and the CLI's run: {"events": the
    event file, "phased": its PULSE_PHASE copy, "H": the printed H,
    "draws": photon_draws' arrays}."""
    from pint_tpu_torch import eventstats, native
    from pint_tpu_torch.event_toas import get_event_weights, load_event_TOAs
    from pint_tpu_torch.kernels.harmonics import harmonic_sums_cuda
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.scripts.photonphase import main as photonphase
    from pint_tpu_torch.templates import LCFitter, LCGaussian, LCTemplate

    walls = {}
    path = os.path.join(tmp, "photons.fits")
    t0 = time.perf_counter()
    draws, worst = photon_events(path)
    walls["write"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    toas = load_event_TOAs(path, "nicer", weightcolumn="PSRPROB")
    walls["load"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    toas.compute_posvels()
    walls["posvels"] = time.perf_counter() - t0
    # the same posvels with io/spk.py's numpy Chebyshev fold in place
    # of the C++ library's (native.cheby_posvel, bound since PR 12)
    ssb, sun = toas.ssb_obs.pos, toas.obs_sun.pos
    bound = native.cheby_posvel
    native.cheby_posvel = lambda *a: None
    try:
        t0 = time.perf_counter()
        toas.compute_posvels()
        walls["posvels_numpy"] = time.perf_counter() - t0
    finally:
        native.cheby_posvel = bound
    log(f"[photon] ephemeris {toas.ephem}: the Sun from the "
        f"{toas.ephem_provider!r} tier; barycentre posvels with the C++ "
        f"Chebyshev {walls['posvels']:.3f} s, with the numpy fold "
        f"{walls['posvels_numpy']:.3f} s")
    check("[photon] ephemeris", {
        "the Sun comes from the numeph kernel (the JAX package's tier)":
            toas.ephem_provider == "numeph",
        "C++ and numpy Chebyshev posvels bitwise equal": bool(
            np.array_equal(ssb, toas.ssb_obs.pos)
            and np.array_equal(sun, toas.obs_sun.pos)),
    })
    model = get_model(PHOTON_PAR)
    sync()
    t0 = time.perf_counter()
    prepared = model.prepare(toas, device=device)
    sync()
    walls["prepare"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ph_obj = prepared.phase()
    phases = torch.remainder(ph_obj.frac, 1.0)
    sync()
    walls["phase"] = time.perf_counter() - t0
    w = torch.as_tensor(get_event_weights(toas), device=device)
    log(f"[photon] {len(toas)} photons over {PHOTON_SPAN_DAYS:g} d written "
        f"({walls['write']:.2f} s; inversion to {worst:.1e} s), loaded "
        f"{walls['load']:.2f} s, barycentre posvels {walls['posvels']:.2f} "
        f"s (host); prepare {walls['prepare']:.2f} s (host pack + upload), "
        f"phase {walls['phase']:.4f} s (device)")

    stats, launches = {}, {}
    for name, fn in (("hm", lambda: eventstats.hm(phases)),
                     ("hmw", lambda: eventstats.hmw(phases, w)),
                     ("z2m", lambda: eventstats.z2m(phases, m=4))):
        harmonic_sums_cuda.launches = 0
        sync()
        t0 = time.perf_counter()
        stats[name] = fn()
        sync()
        walls[name] = time.perf_counter() - t0
        launches[name] = harmonic_sums_cuda.launches
    ref = {"hm": h_f64(torch, phases, 20), "hmw": h_f64(torch, phases, 20, w),
           "z2m": z_f64(torch, phases, 4)}
    rel = {k: float(((stats[k] - ref[k]).abs() / ref[k].abs()).max())
           for k in stats}
    h, hw = float(stats["hm"]), float(stats["hmw"])
    sig = eventstats.h2sig(h)
    urng = np.random.default_rng(1)
    uniform = torch.as_tensor(urng.random(PHOTON_N), device=device)
    harmonic_sums_cuda.launches = 0
    h_null = float(eventstats.hm(uniform))
    launches["null"] = harmonic_sums_cuda.launches
    log(f"[photon] H {h!r} ({sig:.1f} sigma, {walls['hm']:.4f} s), weighted "
        f"H {hw!r} ({walls['hmw']:.4f} s), Z^2_1..4 "
        f"{[round(float(z), 3) for z in stats['z2m']]} "
        f"({walls['z2m']:.4f} s); vs the f64 reference: relative "
        f"{rel['hm']:.2e} / {rel['hmw']:.2e} / {rel['z2m']:.2e}; K4 "
        f"launches {launches}; H of {PHOTON_N} uniform phases {h_null:.3f}")
    check("[photon] statistics", {
        "K4 launched once per statistic": all(
            v == 1 for v in launches.values()),
        "|H_K4 - H_f64| / H_f64 <= 1e-5 (hm, hmw, each Z^2_k)":
            max(rel.values()) <= TOL_H,
        "H > 1e5 and h2sig finite": h > 1e5 and hw > 0 and np.isfinite(sig),
        "H of uniform phases < 50": h_null < 50.0,
    })

    # hm_scan: 32 trials 1/(4T) apart about the true F0, one K4 launch
    dt = torch.as_tensor((toas.tdb.day - PHOTON_PEPOCH) * 86400.0
                         + toas.tdb.sec, device=device)
    span = float(dt.max() - dt.min())
    df = 1.0 / (4.0 * span)
    grid = PHOTON_F0 + (np.arange(PHOTON_TRIALS) - PHOTON_TRIALS // 2) * df
    frac = ph_obj.frac

    def phases_at(f):
        return torch.remainder(frac + (f - PHOTON_F0) * dt, 1.0)

    harmonic_sums_cuda.launches = 0
    sync()
    t0 = time.perf_counter()
    scan = eventstats.hm_scan(phases_at, torch.as_tensor(grid, device=device))
    sync()
    walls["scan"] = time.perf_counter() - t0
    scan_rows = torch.func.vmap(phases_at)(
        torch.as_tensor(grid, device=device)).to(torch.float32)
    launches["scan"] = harmonic_sums_cuda.launches
    best = int(torch.argmax(scan))
    log(f"[photon] hm_scan: {PHOTON_TRIALS} trials x {PHOTON_N} photons, "
        f"df {df:.3e} Hz, {walls['scan']:.4f} s; K4 launches "
        f"{launches['scan']}; max H {float(scan[best]):.1f} at trial {best} "
        f"(true F0 at {PHOTON_TRIALS // 2}); neighbours "
        f"{float(scan[best - 1]):.1f}, {float(scan[best + 1]):.1f}")
    check("[photon] hm_scan", {
        "one K4 launch over (32, n)": launches["scan"] == 1,
        "max H at the true F0": best == PHOTON_TRIALS // 2,
    })

    # the template fit of the folded photons
    template = LCTemplate([LCGaussian([0.06, 0.25])], [0.3])
    fitter = LCFitter(template, phases, device=device)
    sync()
    t0 = time.perf_counter()
    ll = fitter.fit()
    sync()
    walls["fit"] = time.perf_counter() - t0
    norm, width, loc = template.get_parameters()
    log(f"[photon] LCFitter (one LCGaussian, unbinned, 400 Adam steps): "
        f"{walls['fit']:.3f} s; norm {norm:.5f}, width {width:.6f}, loc "
        f"{loc:.6f}, logL {ll:.3f}")
    check("[photon] template fit", {
        "loc within 0.01 of 0.3": abs(loc - PHOTON_LOC) <= 0.01,
        "width within 5% of 0.04": abs(width / PHOTON_SIGMA - 1) <= 0.05,
    })

    # the photonphase CLI, in-process on the card
    par = os.path.join(tmp, "photon.par")
    with open(par, "w") as fh:
        fh.write(PHOTON_PAR)
    out = os.path.join(tmp, "photons_phased.fits")
    harmonic_sums_cuda.launches = 0
    rc, text, walls["cli"] = run_cli(photonphase, [
        path, par, "--weightcol", "PSRPROB", "--device", device,
        "--outfile", out])
    launches["cli"] = harmonic_sums_cuda.launches
    h_cli = printed_h(text)
    from pint_tpu_torch.io.fits import get_table

    col = get_table(out, "EVENTS")[1]["PULSE_PHASE"]
    d_phase = float(np.max(np.abs(col - phases.cpu().numpy())))
    log(f"[photon] photonphase --device {device}: rc {rc}, "
        f"{walls['cli']:.2f} s, K4 launches {launches['cli']}; "
        f"{text.splitlines()[-3].strip()!r}; H {h_cli!r} vs weighted H "
        f"{hw!r}; max |PULSE_PHASE - phase| {d_phase:.3e}")
    check("[photon] photonphase", {
        "exit code 0": rc == 0,
        "printed H equals the weighted H to 1e-9": abs(h_cli - hw)
            <= 1e-9 * hw,
        "PULSE_PHASE equals the phases": d_phase == 0.0,
    })
    direct = {"events": path, "phased": out, "H": h_cli, "draws": draws}
    return launches, phases, w, scan_rows, direct


def harmonics_record(torch, phases, w, scan_rows, launches):
    """K4 at (4,000,000, m = 20) unweighted and weighted and at (32,
    4,000,000, m = 20): against its plain f32 version and the f64
    reference (max |d| over sum|w|), a bitwise repeat, and CUDA-event
    times of the kernel (back to back, and replayed from a CUDA graph,
    without the host's launch path), the plain version and the
    reference beside the bound, each shape's launch geometry, and the per-photon SASS
    counts of the m = 20 photon loop, unweighted and weighted. No single
    PyTorch call computes these sums, so the library column is null.
    Returns the JSON entry."""
    from pint_tpu_torch.kernels.harmonics import (harmonic_sums_cuda,
                                                  harmonic_sums_plain,
                                                  harmonic_sums_ref)

    m = 20
    p32 = phases.to(torch.float32).contiguous()
    w32 = w.to(torch.float32).contiguous()
    shapes = {"photons": (p32, None), "weighted": (p32, w32),
              "scan": (scan_rows, None)}
    rec = {}
    for label, (ph, wt) in shapes.items():
        out = harmonic_sums_cuda(ph, m, wt)
        again = harmonic_sums_cuda(ph, m, wt)
        torch.cuda.synchronize()
        plain = harmonic_sums_plain(ph, m, wt)
        ref = harmonic_sums_ref(ph, m, wt)
        g = 1 if ph.ndim == 1 else ph.shape[0]
        n = ph.shape[-1]
        scale = float(n * g if wt is None else wt.abs().sum() * g)
        d32 = max(float((a - b).abs().max()) for a, b in zip(out, plain))
        d64 = max(float((a - b).abs().max()) for a, b in zip(out, ref))
        same = all(torch.equal(a, b) for a, b in zip(out, again))
        ms = cuda_ms(torch, lambda: harmonic_sums_cuda(ph, m, wt))
        dev_ms = graph_ms(torch, lambda: harmonic_sums_cuda(ph, m, wt))
        plain_ms = cuda_ms(torch, lambda: harmonic_sums_plain(ph, m, wt))
        ref_ms = cuda_ms(torch, lambda: harmonic_sums_ref(ph, m, wt), reps=3,
                         warmup=1)
        nbytes = 4.0 * g * n * (1 if wt is None else 2) + 8.0 * g * 2 * m
        # per photon 2 (theta = phi 2 pi, 2 cos theta); per harmonic 4 for
        # the recurrence and 4 for the weighted sums (2 FMAs), 2 unweighted
        flops = g * n * (2.0 + (8.0 if wt is not None else 6.0) * m)
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        t_ops = flops / PEAK_F32_FLOP_S * 1e3
        log(f"[kernel] harmonic_sums {label} {tuple(ph.shape)} m {m}: vs "
            f"plain f32 max|d| {d32:.3e} ({d32 / scale:.3e} of sum|w|), vs "
            f"f64 {d64:.3e} ({d64 / scale:.3e}); bitwise repeat {same}; "
            f"kernel {ms:.4f} ms (replayed from a CUDA graph {dev_ms:.4f} "
            f"ms), plain {plain_ms:.4f} ms, f64 reference "
            f"{ref_ms:.4f} ms, bound {max(t_bytes, t_ops):.4f} ms "
            f"({nbytes / 1e6:.1f} MB, {flops / 1e6:.0f} MFLOP)")
        if not (d32 < max(4e-8 * n, 1e-4) and same):
            raise AssertionError(f"harmonic_sums at the {label} shape: "
                                 f"|d| {d32:.3e} vs plain, bitwise repeat "
                                 f"{same}")
        geometry = harmonic_geometry(ph, wt, m)
        log(f"[kernel] harmonic_sums {label}: launch {geometry}")
        rec[label] = {"shape": list(ph.shape) + [m], "max_abs_err": d32,
                      "max_err_f64_of_sum_w": d64 / scale, "ms": ms,
                      "graph_ms": dev_ms,
                      "plain_ms": plain_ms, "f64_ms": ref_ms,
                      "bound_ms": max(t_bytes, t_ops),
                      "bound_by": "bytes" if t_bytes >= t_ops
                      else "operations", "library_ms": None,
                      "launch": geometry}
    weighted = rec.pop("weighted")
    from pint_tpu_torch.kernels import build
    from pint_tpu_torch.kernels.harmonics import PHOTONS

    sass = {}
    for label, kernel in (("unweighted", "harmonic_partials_kernelILi20ELb0E"),
                          ("weighted", "harmonic_partials_kernelILi20ELb1E")):
        sass[label] = sass_loop_counts(build._library_path("harmonics")[1],
                                       kernel, PHOTONS)
        log(f"[kernel] harmonic_sums m = 20 {label}: SASS of the partials "
            f"kernel's photon loop, per photon: {sass[label]}")
    return {"name": "harmonic_sums", "route": "cuda",
            "source": "pint_tpu_torch/csrc/harmonics.cu",
            "replaces": "pint_tpu/kernels/harmonics.py:81",
            "launches": int(sum(launches.values())), **weighted,
            "unweighted": rec["photons"], "scan": rec["scan"],
            "launches_per_statistic": int(max(
                launches[k] for k in ("hm", "hmw", "z2m"))),
            "scan_launches": int(launches["scan"]), "sass_per_photon": sass}


def harmonic_geometry(ph, wt, m):
    """The launch csrc/harmonics.cu gets for phases ``ph`` and weights
    ``wt`` at m harmonics: grid (blocks per row, rows, chunks), threads,
    photons a thread takes per iteration, harmonics per chunk, the bytes
    of each load, and the blocks of that instantiation resident on the
    card."""
    from pint_tpu_torch.kernels import harmonics

    rows = ph.reshape(1, -1) if ph.ndim == 1 else ph
    g, n = rows.shape
    w_ptr = None if wt is None else wt.data_ptr()
    w_stride = n if wt is not None and wt.ndim == 2 else 0
    dev = ph.device.index
    plan = tuple(harmonics.launch_plan(dev, g, n, m, rows.data_ptr(), w_ptr,
                                       w_stride))
    kc, nchunks, nb, vec = plan[3:7]
    return {"grid": [nb, g, nchunks], "threads": harmonics.THREADS,
            "photons_per_iteration": harmonics.PHOTONS, "chunk": kc,
            "copy_bytes": 16 if vec else 4,
            "resident_blocks": harmonics.resident_blocks(dev, kc,
                                                         wt is not None)}


# SASS opcode classes, and the issue slots of one warp instruction of
# each relative to an FP32 one on an H100 SM sub-partition (32 FP32
# lanes; 16 FP64 lanes; 4 lanes for the f32<->f64 conversions, 16 per SM)
SASS_CLASSES = {"fp32": ("FFMA", "FADD", "FMUL"),
                "fp64": ("DFMA", "DADD", "DMUL"),
                "convert": ("F2F", "F2I", "I2F", "F2IP", "I2FP", "FRND"),
                "load": ("LDG", "LD", "LDS")}
SASS_SLOTS = {"fp64": 2, "convert": 8}


def sass_loop_counts(so, kernel, photons):
    """Per-photon SASS instruction counts of the photon loop of the
    function whose mangled name contains ``kernel`` in the library
    ``so`` (``cuobjdump -sass``): the backward branch whose body holds
    the most f64 operations (the loop with the sincos), counted
    statically over its body, by class, divided by the photons one
    iteration takes; ``slots`` weighs each class by SASS_SLOTS (1 for
    the rest). None, with the reason logged, where cuobjdump is missing
    or its output has no such loop."""
    import re
    import shutil

    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(exe):
        log(f"[kernel] SASS of {kernel}: not measured (no cuobjdump)")
        return None
    text = subprocess.run([exe, "-sass", so], capture_output=True, text=True,
                          check=True).stdout
    code, labels, pending, name = [], {}, [], None
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1)
            continue
        if name is None or kernel not in name:
            continue
        label = re.match(r"\s*(\.L_x_\d+):", line)
        if label:
            pending.append(label.group(1))
            continue
        ins = re.match(r"\s*/\*([0-9a-f]+)\*/\s+([^;]*);", line)
        if ins:
            addr = int(ins.group(1), 16)
            for lab in pending:
                labels[lab] = addr
            pending = []
            words = [w for w in ins.group(2).split() if not w.startswith("@")]
            if words:
                code.append((addr, words[0].split(".")[0], ins.group(2)))
    best = None
    for addr, op, body in code:
        if op != "BRA":
            continue
        tgt = re.search(r"`\((\.L_x_\d+)\)", body)
        target = (labels.get(tgt.group(1)) if tgt else
                  int(re.search(r"0x([0-9a-f]+)", body).group(1), 16)
                  if re.search(r"0x([0-9a-f]+)", body) else None)
        if target is None or target > addr:
            continue
        ops = [o for a, o, _ in code if target <= a <= addr]
        n64 = sum(o in SASS_CLASSES["fp64"] for o in ops)
        if best is None or (n64, -len(ops)) > (best[0], -len(best[1])):
            best = (n64, ops)
    if best is None or best[0] == 0:
        log(f"[kernel] SASS of {kernel}: not measured (no loop with f64 "
            f"operations found in {so})")
        return None
    ops = best[1]
    counts = {c: sum(o in names for o in ops)
              for c, names in SASS_CLASSES.items()}
    counts["other"] = len(ops) - sum(counts.values())
    per = {c: v / photons for c, v in counts.items()}
    per["total"] = len(ops) / photons
    per["slots"] = sum(v * SASS_SLOTS.get(c, 1)
                       for c, v in counts.items()) / photons
    return per


# -- the photon-timing remainder: [photon] satellite / polycos / calc,
# [profile] fftfit, [mcmc]; and [grid] --

# an ISS-like circular orbit (NICER's host) sampled every 60 s over the
# photon year, FPorbit-style; 3 h more at each end cover photons whose
# spacecraft time leads or lags the barycentric year by the Roemer
# delay (+-500 s) and the polyco segments' end nodes
ORBIT_RADIUS_M, ORBIT_INC_DEG, ORBIT_PERIOD_S = 6.78e6, 51.6, 5556.0
ORBIT_STEP_S, ORBIT_ROWS, ORBIT_MARGIN_ROWS = 60.0, 525_600, 180
SAT_SEED, CALC_SEED = 1, 2
SAT_SAMPLE = 20_000  # photons the inversion is checked on
TOL_INVERSION_S = 1e-9
TOL_SAT_PHASE = 1e-6  # cycles, |PULSE_PHASE - drawn phase|
CALC_N = 1_000_000  # Fermi photons of [photon] calc
FERMI_MJDREF = 51910.00074287037
POLYCO_SAMPLE = 20_000  # photons the polyco phases are held on
TOL_POLYCO = {"barycentred": 1e-7, "satellite": 1e-6}  # cycles
TOL_POLYCO_H = 1e-6  # relative, polyco vs direct H
TOL_CALC_H = 1e-9  # relative, ecliptic vs equatorial par
PROFILE_BINS, PROFILE_SHIFT = 256, 0.1234
TOL_FFTFIT = 1e-4  # cycles
MCMC_STEPS, MCMC_MULTI_STEPS, MCMC_BINS = 200, 50, 64
GRID_SIDE, GRID_SIGMA = 16, 3.0
TOL_GRID_CHI2 = 1e-6  # relative, grid point vs a frozen WLSFitter fit


def iss_orbit(met):
    """Position [m] and velocity [m/s] of a circular orbit of radius
    6.78e6 m, inclination 51.6 deg and period 5,556 s at MET seconds."""
    w = 2 * np.pi / ORBIT_PERIOD_S
    inc = np.radians(ORBIT_INC_DEG)
    ang = w * met
    c, s = np.cos(ang), np.sin(ang)
    r = ORBIT_RADIUS_M
    pos = np.stack([r * c, r * s * np.cos(inc), r * s * np.sin(inc)], -1)
    vel = np.stack([-r * w * s, r * w * c * np.cos(inc),
                    r * w * c * np.sin(inc)], -1)
    return pos, vel


def hermite_uniform(xg, yg, x):
    """Cubic Hermite of yg on the uniform grid xg at x, the slopes by
    second-order differences."""
    h = xg[1] - xg[0]
    d = np.gradient(yg, h, edge_order=2)
    i = np.clip(((x - xg[0]) // h).astype(np.int64), 0, len(xg) - 2)
    u = (x - xg[i]) / h
    return ((2 * u**3 - 3 * u**2 + 1) * yg[i] + (u**3 - 2 * u**2 + u) * h
            * d[i] + (-2 * u**3 + 3 * u**2) * yg[i + 1]
            + (u**3 - u**2) * h * d[i + 1])


def tt_epochs(met_ld, ref):
    """TT (day, sec) of longdouble MET seconds past ``ref``, to the
    longdouble's precision."""
    x = (np.longdouble(ref) - PHOTON_PEPOCH) * 86400 + met_ld
    dday = np.floor(x / 86400)
    return (PHOTON_PEPOCH + dday.astype(np.int64),
            np.asarray(x - dday * 86400, np.float64))


def barycentric_offset(model, day, sec, device):
    """The port's barycentring of TT epochs at the registered
    spacecraft: seconds from the TT epoch to tdb - delay (the time the
    spindown phase reads), and the TDB epochs' offset from PEPOCH."""
    from pint_tpu_torch.toa import TOAs

    toas = TOAs.from_arrays(day, sec, obs="nicer")
    toas.compute_posvels()
    delay = model.delay(toas, device=device).cpu().numpy()
    g = (toas.tdb.day - day) * 86400.0 + (toas.tdb.sec - sec) - delay
    return g, delay, toas


def satellite_files(tmp, device="cuda"):
    """``[photon] satellite``'s data: photon_draws(seed 1) as NICER
    events in the spacecraft frame (TIMESYS TT, PSRPROB weights) with an
    FPorbit-style orbit file (TIME, POSITION, VELOCITY in m) of
    ``iss_orbit``. The spacecraft times invert the port's own
    barycentring of the drawn barycentric times: G(met) = (tdb - delay)
    - tt is computed by the port on the orbit grid, split into the
    spacecraft's Roemer term (r_sc . n / c, with the orbit file's own
    Hermite interpolant) and a smooth rest (cubic Hermite), and
    met = met_bary - G(met) is iterated to convergence. Returns the
    paths, the drawn phases and weights in file order, the inversion's
    largest residual on a sample [s] and the walls."""
    from pint_tpu_torch.constants import C_M_S
    from pint_tpu_torch.event_toas import MISSION_MJDREF, met_to_day_sec
    from pint_tpu_torch.io.fits import write_fits_table
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.observatory.satellite_obs import (
        get_satellite_observatory)

    walls = {}
    t0 = time.perf_counter()
    draws, _ = photon_draws(SAT_SEED)
    walls["draw"] = time.perf_counter() - t0
    ref = MISSION_MJDREF["nicer"]
    hdr = {"MJDREFI": int(ref), "MJDREFF": ref - int(ref), "TIMESYS": "TT",
           "TELESCOP": "NICER"}
    met_pepoch = (np.longdouble(PHOTON_PEPOCH) - np.longdouble(ref)) * 86400
    met_grid = (float(met_pepoch) - ORBIT_MARGIN_ROWS * ORBIT_STEP_S
                + ORBIT_STEP_S * np.arange(ORBIT_ROWS + 2 * ORBIT_MARGIN_ROWS))
    pos, vel = iss_orbit(met_grid)
    orbit = os.path.join(tmp, "nicer_orbit.fits")
    write_fits_table(orbit, {"TIME": met_grid, "POSITION": pos,
                             "VELOCITY": vel}, hdr, extname="ORBIT")
    ob = get_satellite_observatory("nicer", orbit)
    model = get_model(PHOTON_PAR)
    ra, dec = model.RAJ.value, model.DECJ.value
    n_hat = np.array([np.cos(dec) * np.cos(ra), np.cos(dec) * np.sin(ra),
                      np.sin(dec)])

    def g_sat(met):
        return ob._interp(met)[0] @ n_hat / C_M_S

    t0 = time.perf_counter()
    day, sec = met_to_day_sec(met_grid, ref)
    g_grid, _, _ = barycentric_offset(model, day, sec, device)
    g_rest = g_grid - g_sat(met_grid)
    walls["grid"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    met_b = met_pepoch + draws["t"]
    met = np.asarray(met_b, np.float64)
    for _ in range(5):
        met_ld = met_b - (hermite_uniform(met_grid, g_rest, met) + g_sat(met))
        met = np.asarray(met_ld, np.float64)
    walls["invert"] = time.perf_counter() - t0
    order = np.argsort(met_ld, kind="stable")
    met_ld = met_ld[order]
    phi, w, t_b = draws["phi"][order], draws["w"][order], draws["t"][order]
    # the inversion on a sample, through the port's whole barycentring
    pick = np.sort(np.random.default_rng(SAT_SEED).choice(
        len(met_ld), SAT_SAMPLE, replace=False))
    sd, ss = tt_epochs(met_ld[pick], ref)
    _, delay, st = barycentric_offset(model, sd, ss, device)
    b = ((st.tdb.day - PHOTON_PEPOCH) * 86400 + np.longdouble(1) * st.tdb.sec
         - delay)
    resid = float(np.max(np.abs(np.asarray(b - t_b[pick], np.float64))))
    events = os.path.join(tmp, "nicer_spacecraft.fits")
    write_fits_table(events, {"TIME": np.asarray(met_ld, np.float64),
                              "PSRPROB": w}, hdr)
    return {"events": events, "orbit": orbit, "phi": phi, "w": w,
            "t": t_b, "resid_s": resid, "walls": walls,
            "rows": len(met_grid), "span_days": float(
                (met_grid[-1] - met_grid[0]) / 86400)}


def run_cli(main, argv):
    """A script's main in-process: (rc, stdout text, wall)."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue(), time.perf_counter() - t0


def printed_h(text):
    return float(next(line.split("=", 1)[1] for line in text.splitlines()
                      if line.startswith("H = ")))


def wrap_gap(a, b):
    """max |a - b| over the circle of unit phase."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)) % 1.0
    return float(np.max(np.minimum(d, 1.0 - d)))


PHOTON_CLI_STEPS = (  # (owner module[:class], attribute, label)
    ("pint_tpu_torch.event_toas", "load_event_TOAs", "load"),
    ("pint_tpu_torch.toa:TOAs", "compute_posvels", "posvels"),
    ("pint_tpu_torch.models.timing_model:TimingModel", "phase",
     "phase (prepare and posvels inside)"),
    ("pint_tpu_torch.polycos:Polycos", "generate_polycos",
     "polyco generation"),
    ("pint_tpu_torch.polycos:Polycos", "eval_abs_phase",
     "polyco evaluation"),
    ("pint_tpu_torch.eventstats", "hmw", "H-test"),
)


def photonphase_timed(argv):
    """photonphase in-process with its steps timed (PHOTON_CLI_STEPS)
    and K4's launches counted: (rc, text, wall, {step: s}, launches)."""
    import importlib

    from pint_tpu_torch.kernels.harmonics import harmonic_sums_cuda
    from pint_tpu_torch.scripts.photonphase import main as photonphase

    timers = Timers()
    for owner, attr, label in PHOTON_CLI_STEPS:
        mod, _, cls = owner.partition(":")
        obj = importlib.import_module(mod)
        timers.patch(getattr(obj, cls) if cls else obj, attr, label)
    harmonic_sums_cuda.launches = 0
    try:
        rc, text, wall = run_cli(photonphase, argv)
    finally:
        timers.restore()
    return rc, text, wall, dict(timers.total), harmonic_sums_cuda.launches


def photon_satellite(torch, tmp, device="cuda"):
    """``[photon] satellite``: photonphase --orbfile on the spacecraft-
    frame year (satellite_files), K4 counted; every photon's phase held
    to its drawn phase. Returns the files, the drawn phases, the phased
    copy and the printed H."""
    from pint_tpu_torch.io.fits import get_table

    t0 = time.perf_counter()
    sat = satellite_files(tmp, device=device)
    made = time.perf_counter() - t0
    log(f"[photon] satellite: {len(sat['phi'])} photons of seed "
        f"{SAT_SEED} in the spacecraft frame ({made:.2f} s: draw "
        f"{sat['walls']['draw']:.2f} s, the port's barycentring on the "
        f"{sat['rows']}-row orbit grid ({sat['span_days']:.3f} d) "
        f"{sat['walls']['grid']:.2f} s, inversion "
        f"{sat['walls']['invert']:.2f} s); inversion residual on "
        f"{SAT_SAMPLE} photons {sat['resid_s']:.3e} s")
    par = os.path.join(tmp, "photon.par")
    with open(par, "w") as fh:
        fh.write(PHOTON_PAR)
    out = os.path.join(tmp, "nicer_spacecraft_phased.fits")
    rc, text, wall, steps, launches = photonphase_timed(
        [sat["events"], par, "--orbfile", sat["orbit"], "--weightcol",
         "PSRPROB", "--device", device, "--outfile", out])
    h = printed_h(text)
    col = get_table(out, "EVENTS")[1]["PULSE_PHASE"]
    gap = wrap_gap(col, sat["phi"] % 1)
    log(f"[photon] satellite: photonphase --orbfile --device {device}: rc "
        f"{rc}, {wall:.2f} s (" + ", ".join(
            f"{k} {v:.3f} s" for k, v in steps.items()) + f"); K4 launches "
        f"{launches}; H {h!r}; max |PULSE_PHASE - drawn phase| "
        f"{gap:.3e} cycles")
    check("[photon] satellite", {
        "inversion residual < 1 ns": sat["resid_s"] < TOL_INVERSION_S,
        "exit code 0": rc == 0,
        "K4 launched once": launches == 1,
        "every photon's phase within 1e-6 cycles of its drawn phase":
            gap <= TOL_SAT_PHASE,
        "H > 1e5": h > 1e5,
    })
    sat.update(phased=out, H=h, par=par, launches=launches)
    return sat


def photon_polycos(torch, tmp, direct, sat, device="cuda"):
    """``[photon] polycos``: photonphase --polycos on the [photon]
    barycentred file and on the spacecraft file. The polyco phases are
    held to the model's at the same f64 MJDs on a sample (the polyco
    tier), and to the direct run's PULSE_PHASE over every photon (then
    the f64 MJDs the polycos are evaluated at bound the gap: F0 x half
    an ulp of an MJD, 9.4e-6 cycles); H to the direct run's."""
    from pint_tpu_torch.event_toas import load_event_TOAs
    from pint_tpu_torch.io.fits import get_table
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.polycos import _model_abs_phase

    model = get_model(PHOTON_PAR)
    launches = {}
    for tag, path, extra, phased, h_direct in (
            ("barycentred", direct["events"], [], direct["phased"],
             direct["H"]),
            ("satellite", sat["events"], ["--orbfile", sat["orbit"]],
             sat["phased"], sat["H"])):
        out = os.path.join(tmp, f"polyco_{tag}.fits")
        rc, text, wall, steps, launches[tag] = photonphase_timed(
            [path, sat["par"], "--polycos", "--weightcol", "PSRPROB",
             "--device", device, "--outfile", out, *extra])
        n_seg = int(next(line.split()[1] for line in text.splitlines()
                         if line.startswith("Generated")))
        h = printed_h(text)
        col = get_table(out, "EVENTS")[1]["PULSE_PHASE"]
        gap_direct = wrap_gap(col, get_table(phased, "EVENTS")[1][
            "PULSE_PHASE"])
        toas = load_event_TOAs(path, "nicer")
        pick = np.sort(np.random.default_rng(3).choice(
            len(toas), POLYCO_SAMPLE, replace=False))
        _, pf = _model_abs_phase(model, toas.get_mjds()[pick],
                                 str(toas.obs[0]), np.inf, device=device)
        gap_model = wrap_gap(col[pick], pf)
        rel_h = abs(h - h_direct) / h_direct
        log(f"[photon] polycos {tag}: rc {rc}, {n_seg} segments, {wall:.2f}"
            f" s (" + ", ".join(f"{k} {v:.3f} s" for k, v in steps.items())
            + f"); K4 launches {launches[tag]}; max |polyco - model| at the "
            f"same MJDs on {POLYCO_SAMPLE} photons {gap_model:.3e} cycles; "
            f"max |polyco - direct run| {gap_direct:.3e} cycles; H {h!r} vs "
            f"{h_direct!r} (relative {rel_h:.3e})")
        check(f"[photon] polycos {tag}", {
            "exit code 0": rc == 0,
            ">= 8,760 segments": n_seg >= 8760,
            "K4 launched once": launches[tag] == 1,
            f"polyco vs model <= {TOL_POLYCO[tag]:g} cycles":
                gap_model <= TOL_POLYCO[tag],
            "polyco vs direct within F0 x half an MJD ulp + tier":
                gap_direct <= 9.4e-6 + TOL_POLYCO[tag],
            "H within 1e-6 relative of the direct run": rel_h <= TOL_POLYCO_H,
        })
    return launches


def fermi_events(path, seed=CALC_SEED, n=CALC_N):
    """photon_draws(seed) at n photons (a quarter pulsed) as a
    barycentred Fermi-LAT FT1 file (TIMESYS TDB; TIME, RA, DEC, ENERGY):
    energies log-uniform over 0.1-100 GeV; pulsed photons scattered about
    PHOTON_PAR's position by the LAT PSF of their energy (the 68% radius
    of calc_lat_weights' parameterization), the background uniform over
    a 5-degree disk."""
    from pint_tpu_torch.io.fits import write_fits_table

    draws, _ = photon_draws(seed, n=n, n_pulsed=n // 4)
    rng = np.random.default_rng(seed + 10)
    energy = 10 ** rng.uniform(2.0, 5.0, n)
    psf = np.sqrt(5.445**2 * (100.0 / energy) ** (2 * 0.848) + 0.084**2) / 3
    radius = np.where(draws["pulsed"],
                      np.abs(rng.standard_normal(n)) * psf,
                      5.0 * np.sqrt(rng.random(n)))
    angle = rng.uniform(0, 2 * np.pi, n)
    ra0, dec0 = 150.0, 15.0  # PHOTON_PAR's RAJ/DECJ [deg]
    met = ((np.longdouble(PHOTON_PEPOCH) - np.longdouble(FERMI_MJDREF))
           * 86400 + draws["t"])
    write_fits_table(path, {
        "TIME": np.asarray(met, np.float64),
        "RA": ra0 + radius * np.cos(angle) / np.cos(np.radians(dec0)),
        "DEC": dec0 + radius * np.sin(angle), "ENERGY": energy},
        {"MJDREFI": int(FERMI_MJDREF),
         "MJDREFF": FERMI_MJDREF - int(FERMI_MJDREF), "TIMESYS": "TDB",
         "TELESCOP": "GLAST"}, extname="EVENTS")


def photon_calc(torch, tmp, device="cuda"):
    """``[photon] calc``: photonphase --weightcol CALC on a 1,000,000-
    photon FT1 file with PHOTON_PAR and with its ecliptic copy
    (modelutils.model_equatorial_to_ecliptic); the H-tests agree."""
    from pint_tpu_torch.modelutils import model_equatorial_to_ecliptic
    from pint_tpu_torch.models import get_model

    path = os.path.join(tmp, "fermi_ft1.fits")
    t0 = time.perf_counter()
    fermi_events(path)
    made = time.perf_counter() - t0
    eq = os.path.join(tmp, "photon.par")
    ecl = os.path.join(tmp, "photon_ecliptic.par")
    with open(ecl, "w") as fh:
        fh.write(model_equatorial_to_ecliptic(
            get_model(PHOTON_PAR)).as_parfile())
    res = {}
    for tag, par in (("equatorial", eq), ("ecliptic", ecl)):
        res[tag] = photonphase_timed([path, par, "--weightcol", "CALC",
                                      "--device", device])
    h = {k: printed_h(r[1]) for k, r in res.items()}
    rel = abs(h["ecliptic"] - h["equatorial"]) / h["equatorial"]
    log(f"[photon] calc: {CALC_N} FT1 photons written in {made:.2f} s; "
        + "; ".join(f"{k} par: rc {r[0]}, {r[2]:.2f} s (" + ", ".join(
            f"{s} {v:.3f} s" for s, v in r[3].items()) + f"), K4 launches "
            f"{r[4]}, H {h[k]!r}" for k, r in res.items())
        + f"; relative H gap {rel:.3e}")
    check("[photon] calc", {
        "exit codes 0": all(r[0] == 0 for r in res.values()),
        "K4 launched once per run": all(r[4] == 1 for r in res.values()),
        "ecliptic H equals the equatorial H to 1e-9": rel <= TOL_CALC_H,
    })
    return {k: r[4] for k, r in res.items()}


def profile_fftfit(torch, phases, weights, device="cuda"):
    """``[profile] fftfit``: the [photon] phases folded into a 256-bin
    weighted profile on the card; the template is that profile rotated
    later by 0.1234 cycles (a Fourier rotation); fftfit_full and
    fftfit_cc must recover -0.1234 (the template's rotation onto the
    profile)."""
    from pint_tpu_torch.profile import fftfit_cc, fftfit_full

    nb = PROFILE_BINS
    idx = torch.clamp((phases * nb).long(), 0, nb - 1)
    prof = torch.zeros(nb, dtype=torch.float64, device=device).index_add_(
        0, idx, weights.double())
    k = torch.arange(nb // 2 + 1, device=device)
    tpl = torch.fft.irfft(torch.fft.rfft(prof) * torch.exp(
        -2j * np.pi * k * PROFILE_SHIFT), nb)
    walls = {}
    for run in ("cold", "warm"):  # the first call plans the FFTs
        sync()
        t0 = time.perf_counter()
        full = fftfit_full(tpl, prof, device=device)
        walls[f"full {run}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cc = fftfit_cc(tpl, prof, device=device)
        walls[f"cc {run}"] = time.perf_counter() - t0
    d_full = abs(full.shift + PROFILE_SHIFT)
    d_cc = abs(cc + PROFILE_SHIFT)
    log(f"[profile] fftfit: {nb}-bin weighted profile of the [photon] "
        f"phases, template rotated by {PROFILE_SHIFT}; fftfit_full shift "
        f"{full.shift!r} +- {full.uncertainty:.3e} (scale {full.scale:.6g}, "
        f"offset {full.offset:.6g}, S/N {full.snr:.6g}); fftfit_cc {cc!r}; "
        f"|error| {d_full:.3e} / {d_cc:.3e} cycles; walls " + ", ".join(
            f"{k} {v * 1e3:.2f} ms" for k, v in walls.items()))
    check("[profile] fftfit", {
        "fftfit_full recovers the shift to 1e-4": d_full <= TOL_FFTFIT,
        "fftfit_cc recovers the shift to 1e-4": d_cc <= TOL_FFTFIT,
        "the backends agree to 1e-4": abs(full.shift - cc) <= TOL_FFTFIT,
        "uncertainty finite and positive":
            np.isfinite(full.uncertainty) and full.uncertainty > 0,
    })


def cramer_rao_widths(draws):
    """Cramer-Rao widths of F0 and F1 for the [photon] draws under
    event_optimize's weighted template likelihood: each photon's score
    for a phase shift is w T'(phi) / (w T(phi) + 1 - w), with T the
    expected weighted profile (1 - p) + p g(phi), g the pulse's wrapped
    Gaussian (mean 1 over a cycle) and p its weighted share; the Fisher
    matrix sums score^2 (t, t^2/2)(t, t^2/2)^T over the photons (t the
    barycentric seconds since PEPOCH, dphi/dF0 = t, dphi/dF1 = t^2/2)."""
    t = np.asarray(draws["t"], np.float64)
    phi = np.asarray(draws["phi"] % 1, np.float64)
    w = draws["w"]
    p = w[draws["pulsed"]].sum() / w.sum()
    x = phi[:, None] - PHOTON_LOC + np.array([-1.0, 0.0, 1.0])
    g = np.exp(-0.5 * (x / PHOTON_SIGMA) ** 2) / (
        PHOTON_SIGMA * np.sqrt(2 * np.pi))
    tmpl = (1 - p) + p * g.sum(axis=1)
    dtmpl = p * np.sum(-x / PHOTON_SIGMA**2 * g, axis=1)
    score = w * dtmpl / (w * tmpl + 1 - w)
    jac = np.stack([t, 0.5 * t * t], axis=1)
    fisher = (jac * score[:, None] ** 2).T @ jac
    return np.sqrt(np.diag(np.linalg.inv(fisher)))


def mcmc_phase(torch, tmp, direct, sat, device="cuda"):
    """``[mcmc]``: event_optimize on the [photon] file (F0/F1 free with
    3x their Cramer-Rao widths as uncertainties, so default_priors'
    +-5 sigma box is +-15 widths; 16 walkers, 200 steps), the step loop
    run with CUDA's sync debug mode on; then event_optimize_multiple
    over the [photon] file and the spacecraft file (its observatory
    registered by [photon] satellite), 50 steps."""
    from pint_tpu_torch import mcmc_fitter, sampler
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.scripts.event_optimize import main as eo
    from pint_tpu_torch.scripts.event_optimize_multiple import main as eom

    cr = cramer_rao_widths(direct["draws"])
    par = os.path.join(tmp, "photon_mcmc.par")
    with open(par, "w") as fh:
        fh.write(PHOTON_PAR.replace(
            f"F0 {PHOTON_F0} 1\n", f"F0 {PHOTON_F0} 1 {3 * cr[0]:.6e}\n")
            .replace(f"F1 {PHOTON_F1} 1\n",
                     f"F1 {PHOTON_F1} 1 {3 * cr[1]:.6e}\n"))
    start = get_model(par)
    if not (start.F0.uncertainty == float(f"{3 * cr[0]:.6e}")
            and start.F1.uncertainty == float(f"{3 * cr[1]:.6e}")):
        raise AssertionError("[mcmc] the par file lost the F0/F1 widths")
    fits, loops = [], []
    walk = sampler._walk

    def watched_walk(*a, **k):
        sync()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = walk(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        sync()
        syncs = [f"{os.path.basename(c.filename)}:{c.lineno}: "
                 f"{str(c.message)[:120]}" for c in caught
                 if "called a synchronizing CUDA operation"
                 in str(c.message)]
        loops.append({"wall": time.perf_counter() - t0,
                      "syncs": len(syncs), "where": syncs})
        return out

    def keep(cls):
        fit_toas = cls.fit_toas

        def recorded(self, *a, **k):
            fits.append(self)
            return fit_toas(self, *a, **k)
        return fit_toas, recorded

    saved = {}
    for cls in (mcmc_fitter.MCMCFitterBinnedTemplate,
                mcmc_fitter.CompositeMCMCFitter):
        saved[cls], cls.fit_toas = keep(cls)
    sampler._walk = watched_walk
    try:
        torch.cuda.reset_peak_memory_stats()
        post = os.path.join(tmp, "photon_mcmc_post.par")
        rc, text, wall = run_cli(eo, [
            direct["events"], par, "--weightcol", "PSRPROB", "--nbins",
            str(MCMC_BINS), "--nsteps", str(MCMC_STEPS), "--device", device,
            "--outfile", post])
        peak = torch.cuda.max_memory_allocated() / 2**30
        fit = fits[-1]
        lst = os.path.join(tmp, "mcmc_sets.txt")
        with open(lst, "w") as fh:
            fh.write(f"{direct['events']} nicer - PSRPROB\n"
                     f"{sat['events']} nicer - PSRPROB\n")
        rc_m, text_m, wall_m = run_cli(eom, [
            lst, par, "--nbins", str(MCMC_BINS), "--nsteps",
            str(MCMC_MULTI_STEPS), "--device", device])
        fit_m = fits[-1]
    finally:
        sampler._walk = walk
        for cls, fn in saved.items():
            cls.fit_toas = fn
    busy = profile_run(torch, "[mcmc] profile (5 steps of the same chain)",
                       lambda: sampler.run_ensemble(
                           fit.bt.lnposterior, fit.sampler.chain[-1], 5,
                           seed=1, device=device))
    post_m = get_model(post)
    sig = np.array([post_m.F0.uncertainty, post_m.F1.uncertainty])
    pull = np.abs(np.array([post_m.F0.value - PHOTON_F0,
                            post_m.F1.value - PHOTON_F1])) / sig
    loop, loop_m = loops[0], loops[1]
    n_w = fit.n_walkers
    log(f"[mcmc] event_optimize: {len(fit.toas)} photons, {n_w} walkers x "
        f"{MCMC_STEPS} steps: rc {rc}, {wall:.2f} s in all, the step loop "
        f"{loop['wall']:.2f} s ({loop['wall'] / MCMC_STEPS * 1e3:.2f} ms per "
        f"step, {n_w * MCMC_STEPS / loop['wall']:.1f} walker-evaluations/s),"
        f" {loop['syncs']} host syncs inside it; peak device memory "
        f"{peak:.3f} GiB; accept {fit.sampler.accept_frac:.4f}; Cramer-Rao "
        f"widths F0 {cr[0]:.3e} Hz, F1 {cr[1]:.3e} Hz/s; max posterior F0 "
        f"{post_m.F0.value!r} +- {sig[0]:.3e}, F1 {post_m.F1.value!r} +- "
        f"{sig[1]:.3e}; |x - truth| / sigma {pull[0]:.3f}, {pull[1]:.3f}")
    for where in loop["where"] + loop_m["where"]:
        log(f"[mcmc] host sync in a step loop: {where}")
    log(f"[mcmc] event_optimize_multiple: "
        f"{sum(len(t) for t in fit_m.toas_list)} photons in "
        f"{len(fit_m.toas_list)} sets, {fit_m.n_walkers} walkers x "
        f"{MCMC_MULTI_STEPS} steps: rc {rc_m}, {wall_m:.2f} s, the step loop "
        f"{loop_m['wall']:.2f} s ({loop_m['wall'] / MCMC_MULTI_STEPS * 1e3:.2f}"
        f" ms per step), {loop_m['syncs']} host syncs inside it; accept "
        f"{fit_m.sampler.accept_frac:.4f}")
    check("[mcmc]", {
        "exit codes 0": rc == 0 and rc_m == 0,
        "max posterior F0/F1 within 3 posterior sigma of the truth":
            bool(np.all(pull <= 3.0)),
        "accept fraction in (0.1, 0.9)":
            0.1 < fit.sampler.accept_frac < 0.9,
        "finite chains": bool(np.isfinite(fit.sampler.chain).all()
                              and np.isfinite(fit_m.sampler.chain).all()),
        "no host sync inside the step loops":
            loop["syncs"] == 0 and loop_m["syncs"] == 0,
    })
    return busy


def zoo_pulsar_toas(i, counts, device="cuda"):
    """The zoo fleet's pulsar i and its TOAs as build_pta makes them for
    the fleet (the seed-0 epoch draws of pulsars 0..i-1 skipped)."""
    rng = np.random.default_rng(0)
    for n in counts[:i]:
        rng.uniform(54000, 57000, max(1, int(n) // 4))
    models, toas = build_pta([counts[i]], device, rng=rng,
                             par_fn=lambda j: zoo_par_text(i),
                             freq_fn=zoo_freqs, flag_fn=zoo_flags)
    return models[0], toas[0]


def grid_par_text(i):
    """zoo_par_text(i) with M2 and SINI free and without the correlated
    noise (ECORR, red noise), which a WLS fit refuses."""
    text = zoo_par_text(i).replace("M2 0.35\n", "M2 0.35 1\n").replace(
        "SINI 0.92\n", "SINI 0.92 1\n")
    return "".join(line + "\n" for line in text.splitlines()
                   if line.split()[:1] not in (["ECORR"], ["RNAMP"],
                                               ["RNIDX"], ["TNREDC"]))


def grid_phase(torch, counts, device="cuda"):
    """``[grid]``: grid_chisq over (M2, SINI) for the zoo fleet's DD
    pulsar with the most TOAs (grid_par_text), on its fleet TOAs: a
    16 x 16 grid over +-3 sigma of a WLSFitter fit with them free,
    maxiter=3, walked in chunks of gridutils.GRID_CHUNK points; the
    minimum's cell, and three points against a WLSFitter fit with M2 and
    SINI frozen there."""
    from pint_tpu_torch import gridutils
    from pint_tpu_torch.fitter import WLSFitter
    from pint_tpu_torch.models import get_model

    i = next(j for j in range(len(counts)) if j % 4 == 3)
    t0 = time.perf_counter()
    _, toas = zoo_pulsar_toas(i, counts, device=device)
    made = time.perf_counter() - t0
    model = get_model(grid_par_text(i))
    fitter = WLSFitter(toas, model, device=device)
    t0 = time.perf_counter()
    fitter.fit_toas()
    fit_s = time.perf_counter() - t0
    fm = fitter.model
    centre = np.array([fm.M2.value, fm.SINI.value])
    sig = np.array([fm.M2.uncertainty, fm.SINI.uncertainty])
    axes = [c + GRID_SIGMA * s * np.linspace(-1, 1, GRID_SIDE)
            for c, s in zip(centre, sig)]
    torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    chi2 = gridutils.grid_chisq(fitter, ["M2", "SINI"], axes, maxiter=3)
    sync()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    best = tuple(int(b) for b in np.unravel_index(np.argmin(chi2),
                                                   chi2.shape))
    # the grid cell holding the fit: its corner points on each axis
    pos = [(c - a[0]) / (a[1] - a[0]) for a, c in zip(axes, centre)]
    cell = [{int(np.floor(p)), int(np.ceil(p))} for p in pos]
    gaps = {}
    for a, b in ((0, 0), (GRID_SIDE - 1, GRID_SIDE - 1), (0, GRID_SIDE - 1)):
        m = copy.deepcopy(fm)
        m.M2.value, m.SINI.value = float(axes[0][a]), float(axes[1][b])
        m.M2.frozen = m.SINI.frozen = True
        ref = float(WLSFitter(toas, m, device=device).fit_toas(maxiter=3))
        gaps[(a, b)] = abs(chi2[a, b] - ref) / ref
    log(f"[grid] DD pulsar {i}: {len(toas)} TOAs made on the card in "
        f"{made:.2f} s, {len(fm.free_params)} free parameters; WLSFitter "
        f"with M2/SINI free {fit_s:.2f} s: M2 {centre[0]:.6f} +- "
        f"{sig[0]:.3e}, SINI {centre[1]:.6f} +- {sig[1]:.3e}")
    log(f"[grid] grid_chisq {GRID_SIDE}x{GRID_SIDE} over +-{GRID_SIGMA:g} "
        f"sigma, maxiter 3, chunks of {gridutils.GRID_CHUNK} points: "
        f"{wall:.3f} s ({chi2.size / wall:.1f} points/s), peak device "
        f"memory {peak:.3f} GiB; chi2 {chi2.min():.6g} .. {chi2.max():.6g},"
        f" minimum at point {best} (the fit at grid index "
        f"({pos[0]:.3f}, {pos[1]:.3f})); vs WLSFitter frozen at three "
        f"points: relative "
        + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items()))
    check("[grid]", {
        "finite chi2": bool(np.isfinite(chi2).all()),
        "minimum at a corner of the grid cell holding the fit":
            all(b in c for b, c in zip(best, cell)),
        "three points match a frozen WLSFitter fit to 1e-6":
            max(gaps.values()) <= TOL_GRID_CHI2,
    })


TOL_PROBE_SHARE = 0.01  # probe wall / warm refit wall (fitquality contract)
TOL_PINTK_JUMP_SIGMA = 3.0  # |JUMP - 0| / sigma of a session's JUMP fit
TOL_SPREAD = 0.25  # random models' spread vs sqrt(diag(M C M^T)), relative
TOL_WRAP_S = 1e-9  # a phase wrap's residual step vs 1/F0
# a session's par/tim written and read back: its TOAs came from a tim
# file, so the 16-decimal MJDs are written again as they were read
TOL_PINTK_READBACK_S = 1e-12
TOL_CONVERT_PAR = 1e-10  # round-trip binary parameters, relative
TOL_CONVERT_S = 1e-12  # residual gap of one delay in two parameterizations
TOL_CONVERT_SIGMA = 1e-6  # WLS refit, converted vs original, sigma


def bitwise_fit(a, b):
    """Two fleet fits' (xs, chi2, covs) bitwise equal."""
    return (all(np.array_equal(x, y) for x, y in zip(a[0], b[0]))
            and np.array_equal(a[1], b[1])
            and all(np.array_equal(x, y) for x, y in zip(a[2], b[2])))


def fitq_phase(torch, fleet, toas, names, x_start, device="cuda"):
    """``[fitq] main``: the fit-quality probes (``obs.fitquality``) on the
    main path's plan fleet, packed mixed program, ``maxiter=2``, from its
    3-sigma start: three warm fits with the probes off (min wall), then
    three probed fits (K1/K2 counts set to 0 just before and read just
    after); then ``precompile`` and the pipelined replay, unprobed twice
    and probed twice; then a GLSFitter mixed fit of the median-count
    pulsar probed and not. Checks: probed fits bitwise the unprobed one
    (x, chi2, covariances) sequential and pipelined, 68 x 3 fits of 68
    pulsars recorded, finite worst |chi2 z| and condition, no fallback,
    K1 and K2 launched under the probes, the min probe wall under 1% of
    the min warm refit (eager and replayed), one ``fit_quality`` entry
    per bucket with the same keys from both executors, and the single
    pulsar bitwise with its residual moments annotated. Frees the
    captured programs and leaves the probes off."""
    from pint_tpu_torch.fitter import GLSFitter
    from pint_tpu_torch.kernels import block_grams_cuda, fused_block_gls_cuda
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.obs import fitquality

    kw = dict(method="gls", maxiter=2, precision="mixed")

    def fit(pipeline=False):
        sync()
        t0 = time.perf_counter()
        probe0 = fitquality.FITQ.snapshot()["probe_wall_s"]
        out = fleet.fit(pipeline=pipeline, **kw)
        sync()
        wall = time.perf_counter() - t0
        probe = fitquality.FITQ.snapshot()["probe_wall_s"] - probe0
        return ([np.asarray(x) for x in out[0]], np.asarray(out[1]),
                [np.asarray(c) for c in out[2]]), wall, probe

    fitquality.disable()
    fitquality.reset()
    runs = [fit() for _ in range(3)]
    off = min(w for _, w, _ in runs)
    ref = runs[-1][0]
    fitquality.enable()
    fused_block_gls_cuda.launches = block_grams_cuda.launches = 0
    probed = [fit() for _ in range(3)]
    launches = {"K1": fused_block_gls_cuda.launches,
                "K2": block_grams_cuda.launches}
    snap = fitquality.FITQ.snapshot()
    seq_quality = dict(fleet.fit_quality)
    probe = min(p for _, _, p in probed)
    log(f"[fitq] main: unprobed warm fits {[round(w, 4) for _, w, _ in runs]}"
        f" s, probed {[round(w, 4) for _, w, _ in probed]} s; probe walls "
        f"{[f'{p * 1e3:.3f}' for _, _, p in probed]} ms, min "
        f"{probe * 1e3:.3f} ms = {100 * probe / off:.3f}% of the min warm "
        f"refit {off:.4f} s; K1/K2 launches under the probes {launches}")
    log(f"[fitq] main snapshot: counters {snap['counters']}, n_pulsars "
        f"{snap['n_pulsars']}, max |chi2 z| {snap['max_abs_chi2_z']}, max "
        f"condition {snap['max_condition']}, max relres "
        f"{snap['max_relres']}, probe wall {snap['probe_wall_s']:.6f} s")
    for key, q in seq_quality.items():
        log(f"[fitq]   width {key[1][1]}: {q}")

    sync()
    t0 = time.perf_counter()
    fleet.precompile(**kw)
    sync()
    compile_s = time.perf_counter() - t0
    fitquality.disable()
    replays = [fit(True) for _ in range(2)]
    fitquality.enable()
    fits0 = fitquality.FITQ.snapshot()["counters"]["fits"]
    piped = [fit(True) for _ in range(2)]
    pipe_fits = fitquality.FITQ.snapshot()["counters"]["fits"] - fits0
    replay_off = min(w for _, w, _ in replays)
    pipe_probe = min(p for _, _, p in piped)
    log(f"[fitq] pipelined: precompile {compile_s:.2f} s; replays unprobed "
        f"{[round(w, 4) for _, w, _ in replays]} s, probed "
        f"{[round(w, 4) for _, w, _ in piped]} s; min probe wall "
        f"{pipe_probe * 1e3:.3f} ms = {100 * pipe_probe / replay_off:.3f}% "
        f"of the min replay {replay_off:.4f} s")
    pipe_quality = dict(fleet.fit_quality)
    for b in fleet.batches.values():
        b._fns.clear()
    torch.cuda.empty_cache()

    order = np.argsort([len(t) for t in toas], kind="stable")
    i_med = int(order[len(order) // 2])

    def single(probed):
        (fitquality.enable if probed else fitquality.disable)()
        m = get_model(par_text(i_med))
        for n, v in zip(names, x_start[i_med]):
            getattr(m, n).value = float(v)
        sync()
        t0 = time.perf_counter()
        f = GLSFitter(toas[i_med], m, device=device)
        chi2 = f.fit_toas(maxiter=2, precision="mixed")
        sync()
        return f, chi2, time.perf_counter() - t0

    f0, c0, w0 = single(False)
    f1, c1, w1 = single(True)
    rec = fitquality.FITQ.get(f"BEN{i_med}")
    same_single = (c0 == c1 and np.array_equal(
        f0.parameter_covariance_matrix, f1.parameter_covariance_matrix)
        and all(getattr(f0.model, n).value == getattr(f1.model, n).value
                for n in names))
    log(f"[fitq] GLSFitter mixed BEN{i_med}: unprobed {w0:.3f} s, probed "
        f"{w1:.3f} s, bitwise {same_single}; record {rec}")
    fitquality.disable()
    fitquality.reset()
    check("[fitq] main", {
        "probed fits bitwise the unprobed one": all(
            bitwise_fit(p, ref) for p, _, _ in probed),
        "pipelined probed replays bitwise the sequential probed fit": all(
            bitwise_fit(p, probed[-1][0]) for p, _, _ in piped + replays),
        "68 x 3 fits of 68 pulsars recorded":
            snap["counters"]["fits"] == 68 * 3 and snap["n_pulsars"] == 68,
        "68 fits per pipelined replay": pipe_fits == 68 * len(piped),
        "finite max |chi2 z| and condition": all(
            snap[k] is not None and np.isfinite(snap[k])
            for k in ("max_abs_chi2_z", "max_condition")),
        "no fallback": snap["counters"]["fallbacks"] == 0,
        "K1 and K2 launched under the probes": min(launches.values()) > 0,
        "probe wall < 1% of the warm refit": probe < TOL_PROBE_SHARE * off,
        "probe wall < 1% of the warm replay":
            pipe_probe < TOL_PROBE_SHARE * replay_off,
        "one fit_quality entry per bucket":
            set(seq_quality) == set(fleet.batches),
        "the pipelined executor's fit_quality keys":
            set(pipe_quality) == set(seq_quality),
        "single-pulsar probed fit bitwise": same_single,
        "residual moments annotated": rec is not None
            and rec.get("residual_moments", {}).get("n") == len(toas[i_med]),
    })


def pintk_phase(torch, toas, names, x_true, x_start, device="cuda"):
    """``[pintk]``: an ``InteractivePulsar`` on the card over the
    median-count pulsar of the main path (``par_text``: EFAC/EQUAD/ECORR
    and 30-harmonic red noise) from phase 3's 3-sigma start;
    ``auto_fitter`` gives DownhillGLSFitter. Checks: the session's fit
    bitwise a direct ``auto_fitter(...).fit_toas()``; undo and reset give
    back the prefit par text; random_models(100, seed 0) is (100, n),
    finite, and its per-TOA spread averaged over TOAs within 25% of the
    averaged sqrt(diag(M C M^T)) at the fitted point (M the Jacobian of
    the mean-subtracted residuals); a JUMP on the 800 MHz TOAs of the
    first MJD third fits within 3 sigma of 0 (the truth) and remove_jump
    restores the free parameters; delete / fit / undo / restore gives
    back the TOAs and, bitwise, the residuals; whitened residuals are
    finite; the written par and tim files read back to residuals within
    1e-12 s; add_phase_wrap(1) moves the selected tracked residuals by
    1/F0 within 1e-9 s."""
    from pint_tpu_torch.fitter import auto_fitter
    from pint_tpu_torch.models import get_model_and_toas, get_model
    from pint_tpu_torch.pintk import InteractivePulsar
    from pint_tpu_torch.residuals import Residuals

    order = np.argsort([len(t) for t in toas], kind="stable")
    i = int(order[len(order) // 2])
    m = get_model(par_text(i))
    for n, v in zip(names, x_start[i]):
        getattr(m, n).value = float(v)
    t = copy.deepcopy(toas[i])
    n_toa = len(t)
    walls, calls = {}, {}

    def timed(label, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        walls[label] = walls.get(label, 0.0) + time.perf_counter() - t0
        calls[label] = calls.get(label, 0) + 1
        return out

    def fitted(f):
        return ([getattr(f.model, n).value for n in names],
                [getattr(f.model, n).uncertainty for n in names],
                f.chi2_whitened)

    torch.cuda.reset_peak_memory_stats()
    s = timed("session", lambda: InteractivePulsar(m, t, device=device))
    pre_par = s.model.as_parfile()
    r_pre = timed("resids_us", s.resids_us)
    f = timed("fit", s.fit)
    direct = timed("direct auto_fitter fit", lambda: auto_fitter(
        t, copy.deepcopy(m), device=device))
    timed("direct auto_fitter fit", direct.fit_toas)
    same_fit = fitted(f) == fitted(direct)
    x_fit = np.array(fitted(f)[0])
    sig = np.array(fitted(f)[1])
    timed("undo", s.undo)
    undo_ok = s.model.as_parfile() == pre_par
    timed("fit", s.fit)
    timed("fit", s.fit)
    timed("reset", s.reset)
    reset_ok = s.model.as_parfile() == pre_par and not s.fitted

    f = timed("fit", s.fit)
    spread = timed("random_models(100)",
                   lambda: s.random_models(n_models=100, seed=0))
    prepared = f.model.prepare(t, device=device)
    M, _ = prepared.designmatrix(incoffset=False)
    M = (M / prepared.params0["F"][0]).cpu().numpy()  # s per unit
    w = 1.0 / np.square(prepared.scaled_sigma_us().cpu().numpy())
    M = M - (w @ M) / np.sum(w)  # the weighted-mean subtraction's Jacobian
    C = f.parameter_covariance_matrix
    predicted = np.sqrt(np.einsum("ij,jk,ik->i", M, C, M))
    drawn = spread.std(axis=0)
    ratio = float(np.mean(drawn) / np.mean(predicted))

    mjd = t.get_mjds()
    lo, hi = mjd.min(), mjd.min() + (mjd.max() - mjd.min()) / 3
    free0 = list(s.model.free_params)
    s.select((t.freq_mhz < 1000.0) & (mjd >= lo) & (mjd <= hi))
    n_jumped = int(s.selected.sum())
    jump = timed("add_jump_to_selection", s.add_jump_to_selection)
    fj = timed("fit", s.fit)
    jump_val = getattr(fj.model, jump).value
    jump_sig = getattr(fj.model, jump).uncertainty
    timed("remove_jump", lambda: s.remove_jump(jump))
    jump_ok = s.model.free_params == free0
    s.reset()
    s.clear_selection()

    r_all = s.resids_us()
    s.select(mjd > mjd.min() + 0.9 * (mjd.max() - mjd.min()))
    n_del = int(s.selected.sum())
    timed("delete_selected", s.delete_selected)
    n_kept = len(s.toas)
    timed("fit", s.fit)
    s.undo()
    timed("restore_all_toas", s.restore_all_toas)
    restored = len(s.toas) == n_toa and np.array_equal(s.resids_us(), r_all)

    timed("fit", s.fit)
    white = timed("whitened_resids", s.whitened_resids)
    with tempfile.TemporaryDirectory() as tmp:
        par, tim = os.path.join(tmp, "s.par"), os.path.join(tmp, "s.tim")
        timed("write_par/write_tim", lambda: (s.write_par(par),
                                              s.write_tim(tim)))
        m2, t2 = timed("read back", lambda: get_model_and_toas(par, tim))
    r2 = Residuals(t2, m2, device=device).calc_time_resids().cpu().numpy()
    readback = float(np.max(np.abs(r2 - s.resids_us() * 1e-6)))

    def tracked():
        return Residuals(s.toas, s.model, track_mode="use_pulse_numbers",
                         subtract_mean=False,
                         device=device).calc_time_resids().cpu().numpy()

    s.select((mjd > lo) & (mjd <= hi))
    sel = s.selected.copy()
    timed("compute_pulse_numbers", s.compute_pulse_numbers)
    before = tracked()
    timed("add_phase_wrap", lambda: s.add_phase_wrap(1))
    step = tracked() - before
    inv_f0 = 1.0 / s.model.F0.value
    wrap_gap = max(float(np.max(np.abs(np.abs(step[sel]) - inv_f0))),
                   float(np.max(np.abs(step[~sel]))))
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[pintk] BEN{i} (median count): {n_toa} TOAs, {type(f).__name__} "
        f"from {START_OFFSET_SIGMA} sigma off; session fit bitwise a direct "
        f"auto_fitter fit: {same_fit}; max |x_fit - x_true|/sigma "
        f"{np.max(np.abs(x_fit - x_true[i]) / sig):.3e}; undo/reset restore "
        f"the prefit par: {undo_ok}/{reset_ok}")
    log(f"[pintk] random_models: {spread.shape}, mean per-TOA spread "
        f"{np.mean(drawn) * 1e6:.6f} us vs sqrt(diag(M C M^T)) "
        f"{np.mean(predicted) * 1e6:.6f} us (ratio {ratio:.4f}); JUMP on "
        f"{n_jumped} Rcvr_800 TOAs of the first third {jump_val:.3e} +- "
        f"{jump_sig:.3e} s; delete {n_del} -> {n_kept} TOAs -> restore, "
        f"residuals bitwise {restored}; read-back max |dr| {readback:.3e} s;"
        f" phase wrap step vs 1/F0 max gap {wrap_gap:.3e} s")
    log("[pintk] walls: " + ", ".join(
        f"{k} {v:.3f} s" + (f" ({calls[k]}x)" if calls[k] > 1 else "")
        for k, v in walls.items())
        + f"; {calls['fit']} session fits; peak device memory {peak:.3f} GiB")
    check("[pintk]", {
        "DownhillGLSFitter chosen": type(f).__name__ == "DownhillGLSFitter",
        "session fit bitwise a direct auto_fitter fit": same_fit,
        "undo restores the prefit par text": undo_ok,
        "reset restores the prefit par text": reset_ok,
        "random_models (100, n), finite": spread.shape == (100, n_toa)
            and bool(np.all(np.isfinite(spread))),
        "random-model spread within 25% of sqrt(diag(M C M^T))":
            abs(ratio - 1.0) <= TOL_SPREAD,
        "JUMP within 3 sigma of 0": n_jumped > 0
            and abs(jump_val) <= TOL_PINTK_JUMP_SIGMA * jump_sig,
        "remove_jump restores the free parameters": jump_ok,
        "delete/restore gives back the TOAs and the residuals": restored
            and n_kept == n_toa - n_del > 0,
        "finite whitened residuals": white.shape == (n_toa,)
            and bool(np.all(np.isfinite(white))),
        "written par/tim read back within 1e-12 s":
            len(t2) == n_toa and readback <= TOL_PINTK_READBACK_S,
        "a phase wrap moves the selected residuals by 1/F0":
            sel.any() and wrap_gap <= TOL_WRAP_S,
    })


APPS_CONVERSIONS = (  # (structure, chain, how the two delays relate)
    ("ELL1", ("DD",), "ell1"), ("ELL1", ("DD", "ELL1"), "same"),
    ("ELL1H", ("ELL1",), "same"), ("ELL1H", ("DD",), "ell1"),
    ("DD", ("DDS",), "same"), ("DD", ("DDS", "DD"), "same"),
    ("DD", ("DDH",), "same"), ("DD", ("DDH", "DD"), "same"),
    ("DD", ("BT",), "bt"))
TSUN_S = 4.925490947e-6  # GM_sun / c^3


def conversion_bound(model, kind):
    """The residual gap a conversion may leave, s (see
    :func:`apps_binaryconvert`), and how it was formed."""
    x = model.A1.value
    n = 2.0 * np.pi / (model.PB.value * 86400.0)
    if kind == "same":
        return TOL_CONVERT_S, "one delay"
    if kind == "ell1":
        e = float(np.hypot(model.EPS1.value, model.EPS2.value)
                  if "EPS1" in model.params else model.ECC.value)
        return (x * e * (e + 2.0 * x * n) + TOL_CONVERT_S,
                f"x e (e + 2 x n) + 1e-12 s, x {x:.6f} lt-s, e {e:.4e}, "
                f"x n {x * n:.4e}")
    r, s = TSUN_S * model.M2.value, model.SINI.value
    shapiro = 2.0 * r * np.log((1.0 + s) / (1.0 - s))
    return (shapiro + x * (x * n) ** 2,
            f"Shapiro range {shapiro:.4e} s + x (x n)^2 "
            f"{x * (x * n) ** 2:.4e} s")


def apps_binaryconvert(torch, counts, device="cuda"):
    """``[apps] binaryconvert``: ``convert_binary`` on the zoo fleet's
    pulsar with the most TOAs of each orbit (ELL1, ELL1H, DD; their
    fleet TOAs made on the card), each conversion of
    ``APPS_CONVERSIONS``, the residuals of the original and of the
    converted model on the card. Checks: round-trip parameters within
    1e-10 relative; residual gaps within 1e-12 s where both forms
    describe one delay (DDS, DDH, ELL1H -> ELL1, the round trips);
    within the ELL1 truncation for ELL1 -> DD: ELL1 keeps the Roemer
    delay to first order in e (x = A1, e the eccentricity), which drops
    O(x e^2) from the delay and O(x e . x n) from the inverse timing
    formula's products n D D' (n = 2 pi / PB; their e-parts carry
    coefficients up to 2), so x e (e + 2 x n) + 1e-12 s; for DD -> BT,
    which has no Shapiro delay and a first-order inversion, the Shapiro
    range 2 r ln((1 + s) / (1 - s)) (r = Tsun M2, s = SINI) + x (x n)^2.
    Then a WLSFitter refit
    of the DD pulsar converted to DDS against the original's, without
    the correlated noise (as ``grid_par_text``), within 1e-6 sigma on
    the shared parameters."""
    from pint_tpu_torch.binaryconvert import convert_binary
    from pint_tpu_torch.fitter import WLSFitter
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.residuals import Residuals

    def resid(model, toas):
        return Residuals(toas, model,
                         device=device).calc_time_resids().cpu().numpy()

    pulsars, checks, walls = {}, {}, {}
    for k, name in enumerate(ZOO_STRUCTURES):
        if k == 0:
            continue
        i = next(j for j in range(len(counts)) if j % 4 == k)
        sync()
        t0 = time.perf_counter()
        model, toas = zoo_pulsar_toas(i, counts, device=device)
        sync()
        walls[f"make {name}"] = time.perf_counter() - t0
        pulsars[name] = (i, model, toas, resid(model, toas))
    for name, chain, same in APPS_CONVERSIONS:
        i, model, toas, r0 = pulsars[name]
        t0 = time.perf_counter()
        m = model
        for out in chain:
            m = convert_binary(m, out)
        conv_s = time.perf_counter() - t0
        sync()
        t0 = time.perf_counter()
        gap = float(np.max(np.abs(resid(m, toas) - r0)))
        sync()
        tag = f"{name} -> {' -> '.join(chain)}"
        walls[tag] = conv_s + time.perf_counter() - t0
        bound, how = conversion_bound(model, same)
        line = (f"[apps] BEN{i} {tag}: {len(toas)} TOAs, max |dr| "
                f"{gap:.3e} s, bound {bound:.3e} s ({how}); convert + "
                f"residuals {walls[tag]:.3f} s")
        checks[f"{tag} residual gap <= {bound:.3e} s"] = gap <= bound
        if chain[-1] == name:
            rel = max(abs(getattr(m, p).value - getattr(model, p).value)
                      / abs(getattr(model, p).value)
                      for p in model.components[f"Binary{name}"].params
                      if isinstance(getattr(model, p).value, float)
                      and getattr(model, p).value)
            line += f"; round-trip parameters max relative {rel:.3e}"
            checks[f"{tag} round-trip parameters <= 1e-10"] = \
                rel <= TOL_CONVERT_PAR
        log(line)

    i, model, toas, _ = pulsars["DD"]
    text = "".join(line + "\n" for line in zoo_par_text(i).splitlines()
                   if line.split()[:1] not in (["ECORR"], ["RNAMP"],
                                               ["RNIDX"], ["TNREDC"]))
    fits = {}
    for tag, m in (("DD", get_model(text)),
                   ("DDS", convert_binary(get_model(text), "DDS"))):
        sync()
        t0 = time.perf_counter()
        f = WLSFitter(toas, m, device=device)
        f.fit_toas()
        sync()
        fits[tag] = (f, time.perf_counter() - t0)
    fd, fs = fits["DD"][0], fits["DDS"][0]
    shared = [p for p in fd.model.free_params if p in fs.model.free_params]
    d_sigma = max(abs(getattr(fd.model, p).value - getattr(fs.model, p).value)
                  / getattr(fd.model, p).uncertainty for p in shared)
    log(f"[apps] WLSFitter refit of BEN{i}, DD vs converted DDS (no "
        f"correlated noise): {len(shared)} shared free parameters, max "
        f"|dx|/sigma {d_sigma:.3e}; walls DD {fits['DD'][1]:.3f} s, DDS "
        f"{fits['DDS'][1]:.3f} s; pulsars made "
        + ", ".join(f"{k[5:]} {v:.2f} s" for k, v in walls.items()
                    if k.startswith("make")))
    checks["WLS refit of the DDS conversion within 1e-6 sigma"] = (
        len(shared) == len(fd.model.free_params)
        and d_sigma <= TOL_CONVERT_SIGMA)
    check("[apps] binaryconvert", checks)


# -- [serve]: the in-process serving engine over a NANOGrav-sized fleet --

# pint_serve_bench's fleet at NANOGrav-sized TOA counts: 3 structures
# (spin-only, EFAC/EQUAD, + TNREDC 10 red noise) x 3 sizes x 8 pulsars
SERVE_SIZES, SERVE_PER_COMBO, SERVE_REQUESTS = (1000, 4000, 12000), 8, 216
SERVE_MAX_BATCH, SERVE_FLOOR, SERVE_MAXITER = 8, 256, 3
SERVE_APPENDS, SERVE_APPEND_TOAS = 4, 64
SERVE_OVERSIZE_TOAS = 30_000  # the main path's largest pulsar
SERVE_ASYNC_WAIT_S = 300.0  # bound on the async phase's wait for results
TOL_SERVE_REL = 1e-12  # served vs offline parameters, relative


def serve_buckets():
    """The slots' TOA buckets of SERVE_SIZES (pow2 from SERVE_FLOOR)."""
    from pint_tpu_torch.serve import pow2_bucket

    return [pow2_bucket(n, SERVE_FLOOR) for n in SERVE_SIZES]


def load_ms(torch, prog, data):
    """CUDA-event mean of one full copy of a batch's data into a
    captured program (``GraphProgram.load`` with its loaded record
    cleared, so every tensor is copied)."""
    def load():
        prog._loaded = [(lambda: None, -1)] * len(prog._loaded)
        prog.load(*data)

    return cuda_ms(torch, load, reps=5, warmup=1)


def serve_index(structure, size, k):
    """Index in build_serve_fleet's order of pulsar k of (structure,
    size index)."""
    return (structure * len(SERVE_SIZES) + size) * SERVE_PER_COMBO + k


def serve_gaps(results, x, cov):
    """Max relative and max sigma gap of served fits to reference
    per-request (x, cov)."""
    rel = sig = 0.0
    for res, xr, cr in zip(results, x, cov):
        mine, xr = np.asarray(res.value["x"]), np.asarray(xr)
        rel = float(np.maximum(rel, np.max(np.abs(mine - xr) / np.maximum(
            np.abs(xr), 1e-30))))
        sig = float(np.maximum(sig, np.max(np.abs(mine - xr) / np.sqrt(
            np.diag(np.asarray(cr))))))
    return rel, sig


def serve_offline(models, toas, bucket, method, device="cuda"):
    """The offline fit of the given pulsars in one batch padded to the
    slot's bucket (eager; a fresh PTABatch)."""
    from pint_tpu_torch.parallel import PTABatch

    b = PTABatch(models, toas, pad_toas=bucket, device=device)
    if method == "gls":
        return b.gls_fit(maxiter=SERVE_MAXITER)
    return b.wls_fit(maxiter=SERVE_MAXITER)


def serve_lane_base(model, toas, device="cuda", seed=6):
    """A lane's base TOAs: the fleet pulsar's epochs again, as converged
    (``iterations=2``) noisy TOAs of its model alternating between 800
    and 1400 MHz (``alternating_freqs``, as the main path's). The
    fleet's one-pass 1400 MHz TOAs keep a ~ms systematic that a lane's
    two registration sweeps do not absorb (on the CPU the lane's next
    solve still moved F1 by 45 sigma) and leave DM degenerate with the
    offset; a mixed lane's f32 delta Grams then err in proportion
    (6e-3 sigma on the CPU)."""
    from pint_tpu_torch.simulation import make_fake_toas_fromMJDs

    mjds = np.asarray(toas.day, np.float64) + np.asarray(toas.sec) / 86400.0
    t = make_fake_toas_fromMJDs(mjds, model, error_us=1.0,
                                freq_mhz=alternating_freqs(len(mjds)),
                                obs="gbt", add_noise=True, seed=seed,
                                iterations=2, device=device)
    for f in t.flags:
        f["f"] = "L-wide"
    return t


def serve_append_traffic(models, lanes, device="cuda", seed=5):
    """SERVE_APPENDS chunks of SERVE_APPEND_TOAS TOAs per lane, after the
    fleet's span (MJD 56810-57100): converged noisy TOAs alternating
    between 800 and 1400 MHz, flagged as build_serve_fleet flags its
    EFAC pulsars, from the lane's model at the lane's registered fit
    (``lanes``: StreamingLane), as an observatory's new TOAs follow the
    current ephemeris."""
    from pint_tpu_torch.simulation import make_fake_toas_fromMJDs

    out = []
    n = SERVE_APPENDS * SERVE_APPEND_TOAS
    for i, (m, lane) in enumerate(zip(models, lanes)):
        m = copy.deepcopy(m)
        for name, v in zip(lane.free_names, lane.x):
            getattr(m, name).value = float(v)
        rng = np.random.default_rng([seed, i])
        mjds = np.sort(rng.uniform(56810, 57100, n))
        t = make_fake_toas_fromMJDs(mjds, m, error_us=1.0,
                                    freq_mhz=alternating_freqs(n),
                                    obs="gbt", add_noise=True,
                                    seed=seed * 1000 + i, iterations=2,
                                    device=device)
        for f in t.flags:
            f["f"] = "L-wide"
        which = np.arange(len(t)) // SERVE_APPEND_TOAS
        out.append([t.mask(which == k) for k in range(SERVE_APPENDS)])
    return out


def serve_fresh_fit(model, lane, chunks, device="cuda"):
    """An f64 WLS fit of a lane's base TOAs and its appended ``chunks``
    that shares none of the refitter's code: one PTABatch whose rows are
    the pieces (the base, then each chunk, so each keeps its own
    weighted mean residual removed, as the lane's rows do), its design
    (``_design_fn``) and residuals (``_resid_fn``) at the lane's frozen
    ``x``, then one Gauss-Newton step from ``x`` by a least-squares
    solve of the whitened, column-normalized rows with the lane's ridge
    prior (``streaming.LANE_RIDGE``) as extra rows. Returns (x,
    sigma)."""
    import torch

    from pint_tpu_torch.parallel import PTABatch
    from pint_tpu_torch.serve import streaming

    pieces = [lane.base_toas] + list(chunks)
    pta = PTABatch([model] * len(pieces), pieces, device=device)
    params, prep, batch = pta._leaves()
    x = torch.as_tensor(np.tile(lane.x, (len(pieces), 1)), device=device)
    with torch.no_grad():
        p = pta._overlay(params, x)
        r, sig = pta._resid_fn()(p, batch, prep)
        M = pta._design_fn()(x, p, params, batch, prep)
    valid = np.arange(r.shape[1])[None, :] < np.asarray(pta.n_toas)[:, None]
    winv = 1.0 / (sig.cpu().numpy()[valid] * 1e-6)
    Mw = M.cpu().numpy()[valid] * winv[:, None]
    rw = r.cpu().numpy()[valid] * winv
    norm = np.linalg.norm(Mw, axis=0)
    k = Mw.shape[1]
    A = np.concatenate([Mw / norm, streaming.LANE_RIDGE * np.eye(k)])
    dxn = np.linalg.lstsq(A, np.concatenate([rw, np.zeros(k)]),
                          rcond=None)[0]
    covn = np.linalg.inv(A.T @ A)
    return (np.asarray(lane.x) - (dxn / norm)[1:],
            (np.sqrt(np.diag(covn)) / norm)[1:])


@contextlib.contextmanager
def bench_fleet(bench, models, toas):
    """pint_serve_bench's runs inside stream over ``models``/``toas``
    (the fleet ``[serve]`` built once) instead of building their own."""
    made = bench.build_serve_fleet
    bench.build_serve_fleet = lambda **kw: (models, toas)
    try:
        yield
    finally:
        bench.build_serve_fleet = made


def serve_phase(torch, device="cuda"):
    """The ``[serve]`` phases (module docstring, phase 12a). Returns
    {"k1p": K1′'s launches in ``[serve] append``, "models", "toas": the
    fleet, "lanes": the append lanes' pulsar indices, "lane_base":
    their base TOAs} for the ``[durable]`` phases."""
    from pint_tpu_torch.kernels.incremental import delta_gram_cuda
    from pint_tpu_torch.obs import trace as obs_trace
    from pint_tpu_torch.parallel import PTABatch, PTAFleet
    from pint_tpu_torch.scripts import pint_serve_bench as bench
    from pint_tpu_torch.serve import (AppendToasRequest, AsyncServeEngine,
                                      FitRequest, PhasePredictRequest,
                                      ResidualRequest, ServeEngine,
                                      StreamingRefitter, policy,
                                      result_digest)

    t_phase = time.perf_counter()
    buckets = serve_buckets()
    t0 = time.perf_counter()
    models, toas = bench.build_serve_fleet(
        sizes=SERVE_SIZES, per_combo=SERVE_PER_COMBO, device=device)
    build_s = time.perf_counter() - t0
    n_psr = len(models)
    log(f"[serve] fleet: {n_psr} pulsars, {sum(len(t) for t in toas)} TOAs "
        f"(pint_serve_bench's structures at sizes {SERVE_SIZES}) made in "
        f"{build_s:.2f} s")

    def req(i, **kw):
        return FitRequest(models[i % n_psr], toas[i % n_psr],
                          maxiter=SERVE_MAXITER, **kw)

    # [serve] stream: the bench's stream on this fleet (built once)
    with bench_fleet(bench, models, toas):
        t0 = time.perf_counter()
        rep = bench.run_serve_stream(
            n_requests=SERVE_REQUESTS, max_batch=SERVE_MAX_BATCH,
            bucket_floor=SERVE_FLOOR, sizes=SERVE_SIZES,
            per_combo=SERVE_PER_COMBO, maxiter=SERVE_MAXITER,
            concurrent_prewarm=True, device=device)
        stream_s = time.perf_counter() - t0
    digests = rep.pop("result_digests")
    rep.pop("tail_artifact")
    log(f"[serve] stream report: {json.dumps(rep, default=float)}")
    log(f"[serve] stream: prewarm (capture of {rep['warmup_executables']} "
        f"programs) {rep['prewarm_wall_s']:.3f} s; {SERVE_REQUESTS} fits in "
        f"{rep['stream_wall_s']:.3f} s ({rep['requests_per_s']:.1f} "
        f"requests/s); total p50 / p99 {rep['serve_p50_latency_s'] * 1e3:.2f}"
        f" / {rep['serve_p99_latency_s'] * 1e3:.2f} ms, execute p50 / p99 "
        f"{rep['execute_p50_s'] * 1e3:.2f} / {rep['execute_p99_s'] * 1e3:.2f}"
        f" ms; max |x - x_offline| {rep['max_param_rel_diff_vs_offline']:.3e}"
        f" relative, {rep['max_param_sigma_diff_vs_offline']:.3e} sigma; the "
        f"whole call {stream_s:.2f} s; {gpu_line()}")
    check("[serve] stream", {
        "every status ok": rep["statuses"] == {"ok": SERVE_REQUESTS},
        "9 slots in buckets 1024/4096/16384":
            rep["toa_buckets"] == buckets and rep["warmup_executables"] == 9,
        "no recompile after warm-up": rep["recompiles_after_warmup"] == 0,
        "cache hit rate >= 0.9": (rep["cache"]["hit_rate"] or 0.0) >= 0.9,
        "exactly one terminal lifecycle state":
            rep["reqlife_exactly_one_terminal"],
        "ledger on/off bitwise": rep["reqlife_bitwise_on_off"],
        "offline fleet <= 1e-12 relative":
            rep["max_param_rel_diff_vs_offline"] <= TOL_SERVE_REL,
        "offline fleet <= 1e-6 sigma":
            rep["max_param_sigma_diff_vs_offline"] <= TOL_MIXED,
        "fleet pipelined bitwise sequential": rep["fleet_pipeline_bitwise"],
    })

    # the phase's own engine: concurrent prewarm, the stream untraced
    # and traced, a warm flush taken apart
    eng = ServeEngine(max_batch=SERVE_MAX_BATCH, bucket_floor=SERVE_FLOOR,
                      device=device)
    t0 = time.perf_counter()
    n_warm = eng.prewarm_concurrent([req(i) for i in range(n_psr)])
    warm_s = time.perf_counter() - t0
    plain = eng.run_stream([req(i) for i in range(SERVE_REQUESTS)])
    obs_trace.reset()
    obs_trace.enable(jax_annotations=True)
    try:
        t0 = time.perf_counter()
        traced = eng.run_stream([req(i) for i in range(SERVE_REQUESTS)])
        traced_s = time.perf_counter() - t0
    finally:
        obs_trace.disable()
    spans = {}
    for sp in obs_trace.spans():
        spans[sp["name"]] = spans.get(sp["name"], 0) + 1
    obs_trace.reset()
    d_plain = [result_digest(r.value) for r in plain]
    d_traced = [result_digest(r.value) for r in traced]
    log(f"[serve] trace: prewarm_concurrent captured {n_warm} programs in "
        f"{warm_s:.3f} s; the traced stream {traced_s:.3f} s; spans "
        f"{json.dumps(dict(sorted(spans.items())))}")
    check("[serve] trace", {
        "9 programs captured": n_warm == 9,
        "traced results bitwise the untraced": d_traced == d_plain,
        "this engine bitwise the stream's engine": d_plain == digests,
        "27 flush, pack and run spans": spans.get("serve.flush") == 27
            and spans.get("serve.pack") == 27
            and spans.get("serve.run") == 27,
        "no capture while serving": "serve.compile" not in spans
            and eng.executables_compiled == 9,
    })

    # where a warm flush's time goes: pack, copy, run, pull (the red-
    # noise 16384 slot, its 8 largest pulsars)
    idx = [serve_index(2, 2, k) for k in range(SERVE_PER_COMBO)]
    t0 = time.perf_counter()
    pta = eng._padded_batch(buckets[2], [models[i] for i in idx],
                            [toas[i] for i in idx])
    sync()
    pack_s = time.perf_counter() - t0
    slot = eng.batcher.slot_key(req(idx[0]), policy.resolve(req(idx[0])))
    pta._fns = eng.cache.lookup(eng._exec_key(slot, SERVE_MAX_BATCH, pta))
    prog = pta._fns[pta.program_key("gls", SERVE_MAXITER)]
    copied, copy_s, copy_ms = 0, 0.0, 0.0
    if prog.captured:  # an eager program (the CPU) copies nothing
        t0 = time.perf_counter()
        copied = prog.load(pta._x0(), *pta._leaves())
        sync()
        copy_s = time.perf_counter() - t0
        copy_ms = load_ms(torch, prog, (pta._x0(),) + pta._leaves())
    t0 = time.perf_counter()
    handle = pta._dispatch_gls(SERVE_MAXITER)
    sync()
    run_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pta._finalize_gls(handle)
    pull_s = time.perf_counter() - t0
    log(f"[serve] a warm flush of the red-noise {buckets[2]} slot: pack "
        f"{pack_s * 1e3:.2f} ms, copy of {copied / 2**20:.2f} MiB into the "
        f"program {copy_s * 1e3:.3f} ms (the copy alone by CUDA events "
        f"{copy_ms:.3f} ms), run (replay) {run_s * 1e3:.2f} ms, pull + "
        f"finalize {pull_s * 1e3:.2f} ms")
    del pta, prog

    # [serve] mixed: the 24 red-noise pulsars in mixed vs their f64 fit
    rn = [serve_index(2, s, k) for s in range(len(SERVE_SIZES))
          for k in range(SERVE_PER_COMBO)]
    t0 = time.perf_counter()
    mixed = eng.run_stream([req(i, method="gls", precision="mixed")
                            for i in rn])
    mixed_s = time.perf_counter() - t0
    xs64, _, covs64 = PTAFleet([models[i] for i in rn], [toas[i] for i in rn],
                               device=device).fit(method="gls",
                                                  maxiter=SERVE_MAXITER)
    _, d_mixed = serve_gaps(mixed, xs64, covs64)
    log(f"[serve] mixed: 24 red-noise fits (3 slots captured in their first "
        f"flush) {mixed_s:.3f} s, max |x_mixed - x_f64| {d_mixed:.3e} sigma, "
        f"degraded {eng.telemetry.counters.get('degraded_mixed', 0)}")
    check("[serve] mixed", {
        "every status ok": all(r.status == "ok" for r in mixed),
        "mixed vs f64 <= 1e-6 sigma": d_mixed <= TOL_MIXED,
        "no degraded_mixed": not eng.telemetry.counters.get(
            "degraded_mixed"),
    })

    # [serve] cache reuse: disjoint pulsars through one warm slot each
    reuse = {}
    for name, structure, method in (("spin-only", 0, "wls"),
                                    ("red-noise", 2, "gls")):
        idx = [serve_index(structure, 2, k) for k in range(SERVE_PER_COMBO)]
        before = eng.executables_compiled
        runs = [eng.run_stream([req(i) for i in part])
                for part in (idx[:4], idx[4:], idx[:4])]
        for part, out in zip((idx[:4], idx[4:]), runs):
            x, _, cov = serve_offline([models[i] for i in part],
                                      [toas[i] for i in part], buckets[2],
                                      method, device)
            reuse[f"{name} {part[0]}-{part[-1]}"] = serve_gaps(out, x, cov)
        reuse[f"{name} repeat bitwise"] = all(
            np.array_equal(a.value["x"], b.value["x"])
            for a, b in zip(runs[0], runs[2]))
        reuse[f"{name} no capture"] = eng.executables_compiled == before
        reuse[f"{name} other pulsars differ"] = not np.allclose(
            runs[1][0].value["x"], runs[0][0].value["x"], rtol=1e-9)
    # a pow2 fleet's program adopted by an engine: the fleet's batch is
    # as wide as the slot's bucket (1024 TOAs) so its entry can hit
    pm, pt = bench.build_serve_fleet(sizes=(buckets[0],),
                                     per_combo=SERVE_PER_COMBO, seed=1,
                                     device=device)
    fleet = PTAFleet(pm[-SERVE_PER_COMBO:], pt[-SERVE_PER_COMBO:],
                     toa_bucket="pow2", bucket_floor=SERVE_FLOOR,
                     device=device)
    fleet.precompile(method="auto", maxiter=SERVE_MAXITER)
    first = fleet.fit(method="auto", maxiter=SERVE_MAXITER)
    pf = ServeEngine(max_batch=SERVE_MAX_BATCH, bucket_floor=SERVE_FLOOR,
                     device=device)
    n_pf = pf.prefill_from_fleet(fleet, maxiter=SERVE_MAXITER)
    idx = [serve_index(2, 0, k) for k in range(SERVE_PER_COMBO)]
    for part in (idx[:4], idx[4:]):
        out = pf.run_stream([req(i) for i in part])
        x, _, cov = serve_offline([models[i] for i in part],
                                  [toas[i] for i in part], buckets[0], "gls",
                                  device)
        reuse[f"prefill {part[0]}-{part[-1]}"] = serve_gaps(out, x, cov)
    again = fleet.fit(method="auto", maxiter=SERVE_MAXITER)
    reuse["prefill fleet refit bitwise"] = all(
        np.array_equal(a, b) for a, b in zip(first[0], again[0]))
    log(f"[serve] cache reuse: {json.dumps(reuse, default=float)}; prefill "
        f"hits {pf.cache.hits}, captures {pf.executables_compiled}")
    check("[serve] cache reuse", {
        **{f"{k} <= 1e-12 relative and 1e-6 sigma":
           v[0] <= TOL_SERVE_REL and v[1] <= TOL_MIXED
           for k, v in reuse.items() if isinstance(v, tuple)},
        **{k: v for k, v in reuse.items() if isinstance(v, bool)},
        "prefill adopted 1 entry, 2 hits, no capture":
            n_pf == 1 and pf.cache.hits == 2
            and pf.executables_compiled == 0,
    })
    del fleet, pf

    # [serve] resid/phase: one request of each per structure and bucket,
    # and the main path's largest pulsar spilled solo
    big_m, big_t = build_pta([SERVE_OVERSIZE_TOAS], device)
    rp_models = [models[serve_index(s, j, 0)] for s in range(3)
                 for j in range(len(SERVE_SIZES))] + big_m
    rp_toas = [toas[serve_index(s, j, 0)] for s in range(3)
               for j in range(len(SERVE_SIZES))] + big_t
    t0 = time.perf_counter()
    resid = [eng.submit(ResidualRequest(m, t))
             for m, t in zip(rp_models, rp_toas)]
    phase = [eng.submit(PhasePredictRequest(m, t))
             for m, t in zip(rp_models, rp_toas)]
    eng.drain()
    rp_s = time.perf_counter() - t0
    d_r = d_p = 0.0
    for m, t, rr, pp in zip(rp_models, rp_toas, resid, phase):
        b = PTABatch([m], [t], device=device)
        r_off = b.time_residuals()[0].cpu().numpy()[0]
        p_off = b.phases()[0].cpu().numpy()[0]
        d_r = max(d_r, float(np.max(np.abs(rr.value["resid_s"] - r_off))))
        d_p = max(d_p, float(np.max(np.abs(pp.value["phase"] - p_off))))
    log(f"[serve] resid/phase: 20 requests in {rp_s:.3f} s, max |resid - "
        f"unpadded| {d_r:.3e} s, |phase - unpadded| {d_p:.3e} cycles; the "
        f"{SERVE_OVERSIZE_TOAS}-TOA pulsar spilled: "
        f"{resid[-1].telemetry['spilled']}, {phase[-1].telemetry['spilled']}")
    check("[serve] resid/phase", {
        "every status ok": all(r.status == "ok" for r in resid + phase),
        "residuals <= 1e-12 s": d_r <= 1e-12,
        "phases <= 1e-9 cycles": d_p <= 1e-9,
        "the oversize pulsar spilled solo":
            resid[-1].telemetry["spilled"] and phase[-1].telemetry["spilled"]
            and len(big_t[0]) > policy.DEFAULT_OVERSIZE_TOAS,
        "the rest batched": not any(r.telemetry["spilled"]
                                    for r in resid[:-1] + phase[:-1]),
    })

    # [serve] append: 8 mixed lanes (the 12,000-TOA spin-only and EFAC
    # pulsars, no correlated noise: K1′ runs) over converged TOAs at
    # their epochs, 4 appends each
    lanes = ([serve_index(0, 2, k) for k in range(4)]
             + [serve_index(1, 2, k) for k in range(4)])
    lane_base = [serve_lane_base(models[i], toas[i], device, seed=i)
                 for i in lanes]
    t0 = time.perf_counter()
    for i, base in zip(lanes, lane_base):
        eng.register_append_lane(models[i], base, precision="mixed")
    sync()
    register_s = time.perf_counter() - t0
    traffic = serve_append_traffic(
        [models[i] for i in lanes],
        [eng.streaming.lane(models[i]) for i in lanes], device)
    delta_gram_cuda.launches = 0
    appended = []
    for k in range(SERVE_APPENDS):
        for i, chunks in zip(lanes, traffic):
            appended.append(eng.submit(AppendToasRequest(
                models[i], chunks[k], precision="mixed")))
    k1p = delta_gram_cuda.launches
    lat = np.array([r.telemetry["total_s"] for r in appended]) * 1e3
    direct = StreamingRefitter(device=device)
    bit = True
    d_fresh = 0.0
    for j, (i, chunks) in enumerate(zip(lanes, traffic)):
        direct.register(models[i], lane_base[j], precision="mixed")
        for k in range(SERVE_APPENDS):
            ref = direct.append(models[i], chunks[k],
                                rid=appended[k * len(lanes) + j]
                                .request.request_id)
            got = appended[k * len(lanes) + j].value
            bit = bit and np.array_equal(got["x"], ref["x"]) \
                and got["chi2"] == ref["chi2"]
        x_f, sig = serve_fresh_fit(models[i], eng.streaming.lane(models[i]),
                                   chunks, device)
        d_fresh = max(d_fresh, float(np.max(np.abs(got["x"] - x_f) / sig)))
    log(f"[serve] append: 8 lanes registered in {register_s:.3f} s; "
        f"{len(appended)} appends of {SERVE_APPEND_TOAS} TOAs, p50 / p99 "
        f"{np.percentile(lat, 50):.2f} / {np.percentile(lat, 99):.2f} ms; "
        f"K1′ launches {k1p}; vs an independent f64 WLS fit of base + "
        f"appended TOAs at the lanes' linearization "
        f"{d_fresh:.3e} sigma; escalated "
        f"{eng.telemetry.counters.get('append_escalated', 0)}")
    check("[serve] append", {
        "every status ok": all(r.status == "ok" for r in appended),
        "K1′ launched exactly 32 times through the engine": k1p == 32,
        "bitwise the refitter fed directly": bit,
        "independent f64 fit of base + appended TOAs <= 1e-6 sigma":
            d_fresh <= TOL_MIXED,
        "no escalation": not eng.telemetry.counters.get("append_escalated"),
    })

    # [serve] async: 4 producer threads submit the stream's requests
    aeng = AsyncServeEngine(max_batch=SERVE_MAX_BATCH,
                            bucket_floor=SERVE_FLOOR, device=device)
    try:
        aeng.prewarm_concurrent([req(i) for i in range(n_psr)])
        handles = [None] * SERVE_REQUESTS

        def producer(p):
            for i in range(p, SERVE_REQUESTS, 4):
                handles[i] = aeng.submit(req(i))

        t0 = time.perf_counter()
        threads = [threading.Thread(target=producer, args=(p,))
                   for p in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=SERVE_ASYNC_WAIT_S)
        # a dead flusher would leave drain() waiting forever: bound it
        deadline = time.perf_counter() + SERVE_ASYNC_WAIT_S
        while not all(h is not None and h.done for h in handles):
            if time.perf_counter() > deadline:
                raise AssertionError(
                    f"[serve] async: requests pending after "
                    f"{SERVE_ASYNC_WAIT_S} s (flusher restarts "
                    f"{aeng.telemetry.counters.get('flusher_restarts', 0)})")
            time.sleep(0.01)
        aeng.drain()
        async_s = time.perf_counter() - t0
        snap = aeng.snapshot()
    finally:
        aeng.close()
    d_async = [result_digest(h.value) for h in handles]
    log(f"[serve] async: {SERVE_REQUESTS} requests from 4 producers in "
        f"{async_s:.3f} s ({SERVE_REQUESTS / async_s:.1f} requests/s), "
        f"{snap['counters'].get('flushes')} flushes, p50 / p99 "
        f"{snap['total_s']['p50'] * 1e3:.2f} / "
        f"{snap['total_s']['p99'] * 1e3:.2f} ms, flusher restarts "
        f"{snap['counters'].get('flusher_restarts', 0)}")
    check("[serve] async", {
        "every status ok": all(h.status == "ok" for h in handles),
        "bitwise the sync engine": d_async == digests,
        "no capture after warm-up": snap["executables_compiled"] == 9,
    })
    del eng, aeng
    torch.cuda.empty_cache()
    log(f"[serve] took {time.perf_counter() - t_phase:.2f} s; {gpu_line()}")
    return {"k1p": k1p, "models": models, "toas": toas, "lanes": lanes,
            "lane_base": lane_base}


def durable_fit(torch, fleet, x_start):
    """One mixed fit of ``fleet`` from ``x_start`` with K1/K2's counts set
    to 0 just before and read just after: ((xs, chi2, covs), launches)."""
    from pint_tpu_torch.kernels.fusedgls import fused_block_gls_cuda
    from pint_tpu_torch.kernels.seggram import block_grams_cuda

    set_start(fleet, x_start)
    fused_block_gls_cuda.launches = 0
    block_grams_cuda.launches = 0
    xs, chi2, covs = fleet.fit(method="gls", maxiter=2, precision="mixed")
    sync()
    return ((np.array(xs), np.asarray(chi2), [np.asarray(c) for c in covs]),
            {"K1": fused_block_gls_cuda.launches,
             "K2": block_grams_cuda.launches})


def durable_store(torch, models, toas, fleet, x_start, pack_s, tmp,
                  device="cuda"):
    """``[durable] store`` (module docstring, phase 4d) on the main path's
    models, TOAs and fleet. Returns K1 and K2's launches in the
    store-built fleet's fit."""
    from pint_tpu_torch.parallel.pta import PTAFleet
    from pint_tpu_torch.store import PackStore

    d = os.path.join(tmp, "store")

    def build(store):
        t0 = time.perf_counter()
        built = PTAFleet(models, toas, toa_bucket="plan", store=store,
                         device=device)
        sync()
        return built, time.perf_counter() - t0

    cold = PackStore(d)
    _, put_s = build(cold)
    warm = PackStore(d)
    hit_fleet, hit_s = build(warm)
    scan = warm.scan()
    ref, ref_launches = durable_fit(torch, fleet, x_start)
    hit, launches = durable_fit(torch, hit_fleet, x_start)
    key = next((k for k, b in hit_fleet.batches.items() if b._pack),
               next(iter(hit_fleet.batches)))
    warm._damage(hit_fleet._store_sig, key)
    del hit_fleet
    hurt = PackStore(d)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        re_fleet, re_s = build(hurt)
    rebuilt, _ = durable_fit(torch, re_fleet, x_start)
    del re_fleet
    cc, wc, hc = cold.counters(), warm.counters(), hurt.counters()
    log(f"[durable] store: put (live pack + write) {put_s:.3f} s, "
        f"{cc['puts']} entries, {cc['bytes_written'] / 2**20:.1f} MiB "
        f"written; hit {hit_s:.3f} s against the live fleet pack "
        f"{pack_s:.3f} s ({wc['hits']} hits, "
        f"{wc['bytes_mapped'] / 2**20:.1f} MiB mapped); scan {scan}; "
        f"K1/K2 in the hit fleet's mixed fit {launches} (live "
        f"{ref_launches}); one flipped byte in the width {key[1][1]} "
        f"entry: rebuild {re_s:.3f} s, counters {hc}; {gpu_line()}")
    check("[durable] store", {
        "the miss wrote one entry per bucket": cc["puts"] == len(
            fleet.batches) and cc["misses"] == cc["puts"],
        "the hit ran no host prep": wc["hits"] == len(fleet.batches)
            and wc["misses"] == 0 and wc["puts"] == 0,
        "scan: every entry valid": scan["valid"] == scan["entries"]
            == len(fleet.batches) and scan["corrupt_or_stale"] == 0,
        "hit fleet's mixed fit bitwise the live fleet's": bitwise_fit(
            hit, ref),
        "K1 and K2 launched in the hit fleet's fit":
            launches["K1"] > 0 and launches["K2"] > 0
            and launches == ref_launches,
        "a flipped byte warns, deletes and rebuilds": any(
            "unusable" in str(w.message) for w in caught)
            and hc["corrupt"] == 1 and hc["rebuilds"] == 1
            and hc["puts"] == 1,
        "the rebuilt fleet's fit bitwise the live fleet's": bitwise_fit(
            rebuilt, ref),
    })
    return launches["K1"], launches["K2"]


def durable_checkpoint(torch, fleet, x_start, tmp):
    """``[durable] checkpoint`` (module docstring, phase 4d). Returns K1
    and K2's launches in the uninterrupted two-chunk fit."""
    from pint_tpu_torch.checkpoint import FitCheckpointer, checkpointed_pta_fit
    from pint_tpu_torch.kernels.fusedgls import fused_block_gls_cuda
    from pint_tpu_torch.kernels.seggram import block_grams_cuda

    key = next(k for k, b in fleet.batches.items() if b._pack)
    batch = fleet.batches[key]
    start = x_start[fleet.group_indices[key]]
    kw = dict(method="gls", precision="mixed", every=1)

    def run(d, maxiter):
        fused_block_gls_cuda.launches = 0
        block_grams_cuda.launches = 0
        t0 = time.perf_counter()
        out = checkpointed_pta_fit(batch, os.path.join(tmp, d),
                                   maxiter=maxiter, **kw)
        sync()
        return out, time.perf_counter() - t0, (
            fused_block_gls_cuda.launches, block_grams_cuda.launches)

    batch.set_start_vector(start)
    full, full_s, full_l = run("full", 2)
    batch.set_start_vector(start)
    _, chunk1_s, chunk1_l = run("resumed", 1)  # stopped after chunk 1
    batch.set_start_vector(start)  # a restart begins from the par file
    resumed, resume_s, chunk2_l = run("resumed", 2)
    # a torn write of the last snapshot: the resume reads .prev
    FitCheckpointer(os.path.join(tmp, "full"))._corrupt_snapshot("pta")
    batch.set_start_vector(start)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fallback, fallback_s, fallback_l = run("full", 2)
    batch.set_start_vector(start)
    log(f"[durable] checkpoint: the packed bucket (width {key[1][1]}, "
        f"{batch.n_pulsars} pulsars), gls mixed every=1 maxiter=2: "
        f"uninterrupted {full_s:.3f} s, K1/K2 {full_l}; chunk 1 "
        f"{chunk1_s:.3f} s, K1/K2 {chunk1_l}; resumed chunk 2 "
        f"{resume_s:.3f} s, K1/K2 {chunk2_l}; from .prev after a torn "
        f"latest snapshot {fallback_s:.3f} s, K1/K2 {fallback_l}")
    same = [all(np.array_equal(np.asarray(a), np.asarray(b))
                for a, b in zip(full, other))
            for other in (resumed, fallback)]
    check("[durable] checkpoint", {
        "resumed bitwise uninterrupted": same[0],
        "a corrupted latest snapshot falls back to .prev":
            any("previous snapshot" in str(w.message) for w in caught),
        "the .prev resume bitwise uninterrupted": same[1],
        "K1 and K2 launched in every chunk": min(
            chunk1_l + chunk2_l + fallback_l) > 0
            and full_l == tuple(2 * n for n in chunk1_l),
    })
    return full_l


def durable_restart(torch, serve, tmp, device="cuda"):
    """``[durable] restart`` (module docstring, phase 12b). Returns K1′'s
    launches in the recovery."""
    from pint_tpu_torch.kernels.incremental import delta_gram_cuda
    from pint_tpu_torch.serve import (AppendToasRequest, FitRequest,
                                      ServeEngine, result_digest,
                                      save_serve_state)

    models, toas = serve["models"], serve["toas"]
    lanes, lane_base = serve["lanes"], serve["lane_base"]
    fits = [serve_index(2, 1, k) for k in range(SERVE_PER_COMBO)]
    n_done = len(fits) // 2
    # no flush timer: a slot flushes when full or at drain, so the
    # flush compositions are the ones described above
    kw = dict(max_batch=SERVE_MAX_BATCH, bucket_floor=SERVE_FLOOR,
              max_latency_s=1e9, device=device)

    def fit_req(i, rid):
        return FitRequest(models[i], toas[i], method="gls",
                          maxiter=SERVE_MAXITER, precision="mixed",
                          request_id=rid)

    def register(eng):
        for i, base in zip(lanes, lane_base):
            eng.register_append_lane(models[i], base, precision="mixed")

    # the fault-free run: all eight fits in one flush, then the appends
    clean = ServeEngine(durable_dir=os.path.join(tmp, "clean"), **kw)
    register(clean)
    chunks = [c[0] for c in serve_append_traffic(
        [models[i] for i in lanes],
        [clean.streaming.lane(models[i]) for i in lanes], device)]
    truth = {r.request.request_id: result_digest(r.value)
             for r in clean.run_stream([fit_req(i, f"r{j}")
                                        for j, i in enumerate(fits)])}
    for j, (i, c) in enumerate(zip(lanes, chunks)):
        res = clean.submit(AppendToasRequest(models[i], c,
                                             precision="mixed",
                                             request_id=f"a{j}"))
        truth[f"a{j}"] = result_digest(res.value)
    clean.journal.close()
    del clean

    # the dead process: it served a warm-up flush (capturing the slot's
    # program and persisting it), committed r0..r3 (sentinel values),
    # and died with r4..r7 and eight appends journaled, not delivered
    ddir = os.path.join(tmp, "dead")
    dead = ServeEngine(durable_dir=ddir, **kw)
    t0 = time.perf_counter()
    dead.run_stream([fit_req(i, f"w{j}") for j, i in enumerate(fits)])
    dead_s = time.perf_counter() - t0
    disk = dead.cache.persistent.counters()
    for j, i in enumerate(fits):
        dead.journal.record_intake(fit_req(i, f"r{j}"))
        if j < n_done:
            dead.journal.record_commit(f"r{j}", "ok",
                                       value={"marker": float(j)})
    for j, (i, c) in enumerate(zip(lanes, chunks)):
        dead.journal.record_intake(AppendToasRequest(
            models[i], c, precision="mixed", request_id=f"a{j}"))
    save_serve_state(dead)
    dead.journal.sync()
    del dead
    torch.cuda.empty_cache()

    # the restarted process: the engine's prewarm re-captures while the
    # lanes register, then recover() replays
    t0 = time.perf_counter()
    eng = ServeEngine(durable_dir=ddir, **kw)
    register(eng)
    bringup_s = time.perf_counter() - t0
    delta_gram_cuda.launches = 0
    rep = eng.recover()
    k1p = delta_gram_cuda.launches
    recover_s = time.perf_counter() - t0 - bringup_s
    rep2 = eng.recover()
    pex = eng.cache.persistent.counters()
    replayed = {rid: result_digest(r.value)
                for rid, r in rep["replayed"].items()}
    log(f"[durable] restart: the dead process's warm-up flush {dead_s:.3f}"
        f" s (capture + persisted entry: {disk['bytes_written'] / 2**20:.2f}"
        f" MiB written in {disk['store_s']:.3f} s); restart bring-up "
        f"(engine + 8 lane registrations, the re-capture beside them) "
        f"{bringup_s:.3f} s, re-capture {pex['recapture_s']:.3f} s; "
        f"recover {recover_s:.3f} s ({rep['replay_wall_s']:.3f} s by the "
        f"engine's clock): {rep['n_committed']} committed, "
        f"{rep['n_replayed']} replayed, K1′ {k1p}; second recover "
        f"{rep2['n_replayed']} replayed; captures on the request path "
        f"{eng.executables_compiled}")
    check("[durable] restart", {
        "committed sentinels come back from the journal": all(
            rep["committed"][f"r{j}"]["value"] == {"marker": float(j)}
            for j in range(n_done)),
        "every pending request replayed ok": rep["n_replayed"]
            == len(fits) - n_done + len(lanes)
            and all(r.status == "ok" for r in rep["replayed"].values()),
        "replayed fits bitwise the fault-free run (other lanes)": all(
            replayed[f"r{j}"] == truth[f"r{j}"]
            for j in range(n_done, len(fits))),
        "replayed appends bitwise the fault-free run": all(
            replayed[f"a{j}"] == truth[f"a{j}"] for j in range(len(lanes))),
        "K1′ launched once per replayed append": k1p == len(lanes),
        "a second recover replays nothing": rep2["n_replayed"] == 0,
        "the program came from the persisted tier, no capture":
            eng.executables_compiled == 0 and eng.cache.disk_hits == 1
            and pex["recaptures"] == 1,
    })
    eng.journal.close()
    del eng
    torch.cuda.empty_cache()
    return k1p


def durable_chaos(torch, serve, device="cuda"):
    """``[durable] chaos`` (module docstring, phase 12b)."""
    from pint_tpu_torch.scripts import pint_serve_bench as bench

    with bench_fleet(bench, serve["models"], serve["toas"]):
        t0 = time.perf_counter()
        rep = bench.run_chaos_stream(
            n_requests=SERVE_REQUESTS, fault_rate=0.05,
            fault_point="toa_nan", max_batch=SERVE_MAX_BATCH,
            bucket_floor=64, sizes=SERVE_SIZES, per_combo=SERVE_PER_COMBO,
            maxiter=SERVE_MAXITER, device=device)
        wall = time.perf_counter() - t0
    log(f"[durable] chaos: {rep['injected']} of {rep['n_requests']} "
        f"requests injected ({rep['fault_point']} at "
        f"{rep['fault_rate']}), healthy failures "
        f"{rep['healthy_failures']}, digest mismatches vs the fault-free "
        f"run {rep['digest_mismatches']}, max rel diff "
        f"{rep['max_rel_diff_vs_clean']:.3e}, health "
        f"{rep['health_state']}, unexpected recompiles "
        f"{rep['unexpected_recompiles']}; chaos stream "
        f"{rep['stream_wall_s']:.3f} s, the whole call {wall:.2f} s")
    check("[durable] chaos", {
        "every uninjected request ok and equal to the fault-free run":
            rep["healthy_failures"] == 0 and rep["digest_mismatches"] == 0,
        "every injected request a structured rejection":
            rep["injected_structured"] and rep["injected"] == rep["fires"]
            and rep["injected"] > 0,
        "health ends healthy": rep["health_state"] == "healthy",
        "no unexpected recompile": rep["unexpected_recompiles"] == 0,
        "the stream finished": rep["all_done"],
    })
    return rep


# [durable] kill's sites: the two with checks of their own, and one
# each of the append and the commit legs (the CPU tests cover the rest)
KILL_SMOKE_SITES = ("mid_commit", "excache_store", "append_delta_write",
                    "pre_commit")


def durable_kill(torch, tmp, device="cuda"):
    """``[durable] kill`` (module docstring, phase 12b): the SIGKILL
    matrix at its defaults over ``KILL_SMOKE_SITES``."""
    from pint_tpu_torch.scripts import pint_serve_bench as bench

    t0 = time.perf_counter()
    rep = bench.run_kill_chaos(sites=list(KILL_SMOKE_SITES),
                               workdir=os.path.join(tmp, "kill"),
                               device=device)
    wall = time.perf_counter() - t0
    sites = rep.get("sites", {})
    for site, e in sites.items():
        log(f"[durable] kill {site}: killed {e.get('killed')}, lost "
            f"{e.get('lost')}, duplicated {e.get('duplicated')}, replayed "
            f"{e.get('replayed')}, digest mismatches "
            f"{e.get('digest_mismatches')}, recompiles "
            f"{e.get('recompiles')}, torn {e.get('torn_truncated')} B; "
            f"cold first result {e.get('cold_first_result_s')} s, warm "
            f"refit {e.get('warm_refit_s')} s, ratio "
            f"{e.get('cold_vs_warm_ratio')}; bring-up "
            f"{e.get('bringup_s')} s; legs {e.get('kill_wall_s')} / "
            f"{e.get('recover_wall_s')} s")
    log(f"[durable] kill: {len(sites)} sites in {wall:.1f} s (reference "
        f"leg {rep.get('reference_wall_s', 0.0):.1f} s); max cold/warm "
        f"ratio {rep.get('cold_vs_warm_ratio')} (bound 2.0), lost "
        f"{rep.get('lost')}, duplicated {rep.get('duplicated')}, digest "
        f"mismatches {rep.get('digest_mismatches')}; {gpu_line()}")
    if not rep.get("reference_ok") or set(sites) != set(KILL_SMOKE_SITES) \
            or any("lost" not in e for e in sites.values()):
        raise AssertionError(f"[durable] kill: a leg failed: "
                             f"{json.dumps(rep, default=str)[-4000:]}")
    warm = [s for s in sites if s != "excache_store"]
    ad = sites["append_delta_write"]
    check("[durable] kill", {
        "every site killed": all(e["killed"] for e in sites.values()),
        "every restart exited 0": all(e["recover_rc"] == 0
                                      for e in sites.values()),
        "0 lost, 0 duplicated, 0 digest mismatches": rep["lost"] == 0
            and rep["duplicated"] == 0 and rep["digest_mismatches"] == 0,
        "every probe ok, warm, and the reference's bits": all(
            e["cold_probe_ok"] and e["warm_probes_ok"]
            and e["probes_match_reference"] for e in sites.values()),
        "no capture at the warm sites": all(
            sites[s]["recompiles"] == 0 for s in warm),
        "excache_store captures anew": sites["excache_store"]["recompiles"]
            >= 1,
        "mid_commit left torn bytes": sites["mid_commit"]["torn_truncated"]
            > 0,
        "append_delta_write: 0 corrupt-or-stale segments": ad["delta_ok"]
            and ad["delta_scan"]["corrupt_or_stale"] == 0,
        "pending work replayed": rep["replayed"] > 0,
    })
    return rep


OBS_SPAN_SHARE = 0.01  # disabled spans x spans per traced fit / warm refit
OBS_STEP_S = 2e-5  # the step injected into half of a lane's TOAs
OBS_DRIFT_MIN_N = 3  # the board's warm-up: each pulsar is fit 3 times
OBS_ARRIVAL_N = 96  # requests per ladder rung (the JAX package's)
OBS_FRACS = (0.25, 0.5, 0.75, 1.0, 1.25, 1.5, 2.0, 3.0)


def span_links(spans):
    """[(name, parent name)] of a span list, in finish order."""
    by_id = {s["span"]: s["name"] for s in spans}
    return [(s["name"], by_id.get(s["parent"])) for s in spans]


def traced(fn):
    """(fn(), spans): fn run with tracing on, the ring reset around it."""
    from pint_tpu_torch.obs import trace

    trace.reset()
    trace.enable()
    try:
        out = fn()
    finally:
        trace.disable()
    spans = trace.spans()
    trace.reset()
    return out, spans


def obs_fleet(torch, fleet, models, toas, x_start, tmp, device="cuda"):
    """``[obs] fleet`` (module docstring, phase 12c). Returns K1's and
    K2's launches in the traced sequential and pipelined fits."""
    from pint_tpu_torch.kernels.fusedgls import fused_block_gls_cuda
    from pint_tpu_torch.kernels.seggram import block_grams_cuda
    from pint_tpu_torch.obs import costmodel, export, trace
    from pint_tpu_torch.parallel import PTAFleet

    opts = dict(method="gls", maxiter=2, precision="mixed")
    n_buckets = len(fleet.group_indices)

    def cold():
        f = PTAFleet(models, toas, toa_bucket="plan", pipeline=True,
                     device=device)
        infos, _ = f.precompile(**opts)
        sync()
        return len(infos)

    t0 = time.perf_counter()
    n_cold, cold_spans = traced(cold)
    cold_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    cold_names = {}
    for s in cold_spans:
        cold_names[s["name"]] = cold_names.get(s["name"], 0) + 1
    log(f"[obs] fleet: a cold traced build and precompile of the main fleet "
        f"(pipeline=True, {n_cold} programs captured) {cold_s:.2f} s, spans "
        f"{json.dumps(dict(sorted(cold_names.items())))}")

    set_start(fleet, x_start)
    fleet.precompile(**opts)
    runs = {}
    for pipeline in (False, True):
        sync()
        t0 = time.perf_counter()
        plain = fleet.fit(pipeline=pipeline, **opts)
        sync()
        plain_s = time.perf_counter() - t0
        fused_block_gls_cuda.launches = 0
        block_grams_cuda.launches = 0
        t0 = time.perf_counter()
        out, spans = traced(lambda: fleet.fit(pipeline=pipeline, **opts))
        sync()
        traced_s = time.perf_counter() - t0
        runs[pipeline] = dict(
            plain=plain, traced=out, spans=spans, plain_s=plain_s,
            traced_s=traced_s, k1=fused_block_gls_cuda.launches,
            k2=block_grams_cuda.launches)
    card = torch.cuda.get_device_name(0)
    execs_ok, bitwise = True, True
    for pipeline, r in runs.items():
        tag = "pipelined" if pipeline else "sequential"
        bitwise = bitwise and all(
            all(np.array_equal(a, b) for a, b in zip(pa, pb))
            for pa, pb in zip(r["plain"], r["traced"]))
        for s in r["spans"]:
            if s["name"] != "fleet.execute":
                continue
            a = s["attrs"]
            rp = a.get("roofline_pct")
            execs_ok = execs_ok and (
                a.get("mfu_pct") is not None and rp is not None
                and 0 < rp <= 100 and a.get("bound") in ("compute", "memory")
                and a.get("platform") == card
                and card in costmodel.DEVICE_SPECS and "nominal" not in a)
            log(f"[obs] fleet {tag}: execute bucket {s['attrs'].get('bucket')}"
                f" ({a.get('n')} pulsars): wall {a.get('wall_s')} s, flops "
                f"{a.get('flops')!r}, bytes {a.get('bytes_accessed')!r}, "
                f"intensity {a.get('intensity_flops_per_byte')} FLOP/B, "
                f"MFU {a.get('mfu_pct')}%, roofline {rp}%, bound "
                f"{a.get('bound')}, platform {a.get('platform')}")
        log(f"[obs] fleet {tag}: untraced {r['plain_s']:.4f} s, traced "
            f"{r['traced_s']:.4f} s, {len(r['spans'])} spans, K1 / K2 "
            f"launches under tracing {r['k1']} / {r['k2']}")
    seq, pipe = runs[False], runs[True]
    path = export.write_chrome_trace(os.path.join(tmp, "obs_fleet.json"),
                                     pipe["spans"])
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e["ph"] == "X"]
    # the disabled path: the shared no-op, per call, on this host
    n_calls = 200_000
    t0 = time.perf_counter()
    for _ in range(n_calls):
        with trace.span("fleet.execute", bucket=0, n=1):
            pass
    per_span = (time.perf_counter() - t0) / n_calls
    n_spans = max(len(seq["spans"]), len(pipe["spans"]))
    share = per_span * n_spans / seq["plain_s"]
    log(f"[obs] fleet: a disabled span costs {per_span * 1e9:.1f} ns; x "
        f"{n_spans} spans per traced fit = {100 * share:.5f}% of the warm "
        f"refit ({seq['plain_s']:.4f} s); the Chrome trace has "
        f"{len(events)} events for {len(pipe['spans'])} spans; {gpu_line()}")
    want = {False: [("fleet.execute", "fleet.fit")] * n_buckets
            + [("fleet.fit", None)],
            True: [("fleet.dispatch", "fleet.fit")] * n_buckets
            + [("fleet.execute", "fleet.fit")] * n_buckets
            + [("fleet.fit", None)]}
    check("[obs] fleet", {
        "traced fits bitwise the untraced (x, chi2, cov)": bitwise,
        "fleet.fit holds one fleet.execute per bucket (+ fleet.dispatch "
        "pipelined)": all(span_links(runs[p]["spans"]) == want[p]
                          for p in runs),
        "4 buckets": n_buckets == 4,
        "a cold build shows host_prep, pack, compile, backend_compile":
            all(cold_names.get(k) for k in (
                "fleet.host_prep", "fleet.pack", "fleet.compile",
                "aot.trace", "aot.backend_compile")),
        "every execute span: MFU and 0 < roofline <= 100 on the H100 row":
            execs_ok,
        "K1 and K2 launched 2 + 2 under tracing": all(
            r["k1"] == 2 and r["k2"] == 2 for r in runs.values()),
        "the Chrome trace loads with one event per span":
            len(events) == len(pipe["spans"]),
        "disabled spans < 1% of the warm refit": share < OBS_SPAN_SHARE,
    })
    return {"sequential": (seq["k1"], seq["k2"]),
            "pipelined": (pipe["k1"], pipe["k2"])}


def obs_gw(torch, fleet, xs, sweep_lat, device="cuda"):
    """``[obs] gw`` (module docstring, phase 12c). Returns K3's launches
    in the traced 3,000-pulsar sweep."""
    from pint_tpu_torch import gw
    from pint_tpu_torch.kernels.paircorr import pair_products_cuda
    from pint_tpu_torch.obs import costmodel

    xs = list(xs)
    plain = fleet.gw_stage(xs=xs, precision="mixed")
    stage, spans = traced(lambda: fleet.gw_stage(xs=xs, precision="mixed"))
    links = span_links(spans)
    gw.correlation_sweep(sweep_lat.z, sweep_lat.w, lambda *a: None,
                         block=SWEEP_BLOCK, precision="mixed", device=device)
    pair_products_cuda.launches = 0
    st, sweep_spans = traced(lambda: gw.correlation_sweep(
        sweep_lat.z, sweep_lat.w, lambda *a: None, block=SWEEP_BLOCK,
        precision="mixed", device=device))
    k3 = pair_products_cuda.launches
    card = torch.cuda.get_device_name(0)
    log(f"[obs] gw: traced gw_stage spans {links}; snr {stage['snr']!r} "
        f"(untraced {plain['snr']!r})")
    log(f"[obs] gw: the traced {SWEEP_PSR}-pulsar mixed sweep: "
        f"{st['n_blocks']} tiles, {st['wall_s']:.4f} s, flops "
        f"{st['flops']}, bytes {st['bytes_accessed']}, MFU "
        f"{st['mfu_pct']}%, roofline {st['roofline_pct']}%, bound "
        f"{st['bound']}, platform {st.get('platform')}; K3 launches {k3}")
    check("[obs] gw", {
        "gw.stage holds gw.assemble and gw.os, gw.os holds gw.correlate":
            {("gw.assemble", "gw.stage"), ("gw.os", "gw.stage"),
             ("gw.correlate", "gw.os"), ("gw.stage", None)} <= set(links),
        "traced statistic bitwise the untraced": all(
            stage[k] == plain[k] for k in ("amp2", "snr", "sigma_amp2",
                                            "n_pairs")),
        "sweep MFU, roofline and bound non-null, roofline <= 100":
            st["mfu_pct"] is not None and st["bound"] is not None
            and st["roofline_pct"] is not None
            and 0 < st["roofline_pct"] <= 100,
        "the sweep on the H100 row": st.get("platform") == card
            and card in costmodel.DEVICE_SPECS,
        "the sweep is one gw.correlate span": [s["name"] for s in
                                               sweep_spans] == ["gw.correlate"],
        "K3 launched 78 times": k3 == 78 == st["n_blocks"],
    })
    return k3


def obs_serve(torch, serve, tmp, device="cuda"):
    """``[obs] serve`` (module docstring, phase 12c)."""
    from pint_tpu_torch.obs import FlightRecorder, fitquality
    from pint_tpu_torch.obs.__main__ import main as obs_main
    from pint_tpu_torch.scripts import pint_serve_bench as bench
    from pint_tpu_torch.serve import (FitRequest, ServeEngine, result_digest,
                                      restore_serve_state, save_serve_state)

    models, toas = serve["models"], serve["toas"]
    n_psr = len(models)

    def req(i, t=None):
        return FitRequest(models[i % n_psr], toas[i % n_psr] if t is None
                          else t, maxiter=SERVE_MAXITER)

    t_phase = time.perf_counter()
    eng = ServeEngine(max_batch=SERVE_MAX_BATCH, bucket_floor=SERVE_FLOOR,
                      device=device)
    eng.prewarm_concurrent([req(i) for i in range(n_psr)])
    t0 = time.perf_counter()
    plain = eng.run_stream([req(i) for i in range(SERVE_REQUESTS)])
    plain_s = time.perf_counter() - t0
    rec = FlightRecorder(dump_dir=os.path.join(tmp, "flight"))
    mon = eng.attach_slo(recorder=rec)
    try:
        board = eng.attach_fit_quality(recorder=rec,
                                       min_n=OBS_DRIFT_MIN_N)
        t0 = time.perf_counter()
        watched = eng.run_stream([req(i) for i in range(SERVE_REQUESTS)])
        watched_s = time.perf_counter() - t0
        states = eng.slo_check()
        baselines = {p for p, _ in board._sentinels}
        alarms0 = board.alarms
        # a lane refitted on TOAs with a step in their second half
        lane = serve_index(0, 0, 0)
        step = toas[lane].mask(np.ones(len(toas[lane]), bool))
        step.adjust_times(np.where(np.arange(len(step)) >= len(step) // 2,
                                   OBS_STEP_S, 0.0))
        step.ensure_posvels()
        bad = eng.submit(req(lane, step))
        eng.drain()
        anomalies = [p for p in rec.dumps if "fit_anomaly" in p]
        state = eng.state_dict()
        save_serve_state(eng, os.path.join(tmp, "state"))
        fresh = ServeEngine(max_batch=SERVE_MAX_BATCH,
                            bucket_floor=SERVE_FLOOR, device=device)
        restore_serve_state(fresh, os.path.join(tmp, "state"))
        restored = fresh.state_dict()
    finally:
        fitquality.disable()
        fitquality.FITQ.reset()
    d_plain = [result_digest(r.value) for r in plain]
    d_watched = [result_digest(r.value) for r in watched]
    log(f"[obs] serve: {SERVE_REQUESTS} requests plain {plain_s:.3f} s, "
        f"with attach_slo + attach_fit_quality {watched_s:.3f} s; SLOs "
        f"{[s['name'] for s in states]} alerting {mon.alerting()}; drift "
        f"baselines for {len(baselines)} pulsars ({board.snapshot()}); "
        f"the stepped lane ({OBS_STEP_S * 1e6:g} us on half its "
        f"{len(step)} TOAs): status {bad.status}, alarms "
        f"{board.alarms - alarms0}, flight dumps {len(anomalies)}")
    # pint_serve_bench --tail-out / --trace-out on this fleet, then the
    # obs CLI's tail on its artifact
    tail, trace_out = (os.path.join(tmp, "tail.json"),
                       os.path.join(tmp, "serve_trace.json"))
    with bench_fleet(bench, models, toas), \
            contextlib.redirect_stdout(io.StringIO()):
        t0 = time.perf_counter()
        rc_bench = bench.main([
            "--requests", str(SERVE_REQUESTS), "--max-batch",
            str(SERVE_MAX_BATCH), "--bucket-floor", str(SERVE_FLOOR),
            "--maxiter", str(SERVE_MAXITER), "--no-offline-check",
            "--concurrent-prewarm", "--device", device, "--tail-out", tail,
            "--trace-out", trace_out])
        bench_s = time.perf_counter() - t0
    with open(trace_out) as fh:
        n_events = len([e for e in json.load(fh)["traceEvents"]
                        if e["ph"] == "X"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc_tail = obs_main(["tail", tail])
    resolved = json.loads(out.getvalue())
    log(f"[obs] serve: pint_serve_bench --tail-out --trace-out rc {rc_bench}"
        f" in {bench_s:.2f} s, {n_events} trace events; obs tail rc "
        f"{rc_tail}: exemplar {resolved.get('exemplar')}, queue wait "
        f"{resolved.get('queue_wait_s')} s, execute "
        f"{resolved.get('execute_s')} s; [obs] serve took "
        f"{time.perf_counter() - t_phase:.2f} s")
    check("[obs] serve", {
        "monitored stream bitwise the plain one": d_watched == d_plain
            and all(r.status == "ok" for r in watched),
        "no SLO alert on the healthy stream": not any(
            s["alerting"] for s in states) and not mon.alerting(),
        "a drift baseline per committed pulsar": len(baselines) == n_psr,
        "the stepped lane trips fit_anomaly with a flight dump":
            bad.status == "ok" and board.alarms > alarms0
            and len(anomalies) > 0,
        "drift state round-trips save/restore_serve_state":
            state["drift"] is not None and restored["drift"]
            == json.loads(json.dumps(state["drift"])),
        "pint_serve_bench --trace-out writes a trace that loads":
            rc_bench == 0 and n_events > 0,
        "obs tail resolves the p99 exemplar": rc_tail == 0
            and resolved.get("resolved"),
    })
    del eng, fresh
    torch.cuda.empty_cache()


def obs_arrival(torch, serve, device="cuda"):
    """``[obs] arrival`` (module docstring, phase 12c)."""
    from pint_tpu_torch.scripts import pint_serve_bench as bench

    with bench_fleet(bench, serve["models"], serve["toas"]):
        t0 = time.perf_counter()
        rep = bench.run_arrival_sweep(
            n_per_rate=OBS_ARRIVAL_N, fracs=OBS_FRACS,
            max_batch=SERVE_MAX_BATCH, bucket_floor=SERVE_FLOOR,
            sizes=SERVE_SIZES, per_combo=SERVE_PER_COMBO, device=device)
        wall = time.perf_counter() - t0
    log(f"[obs] arrival: base_rps {rep['base_rps']} (closed loop, p99 "
        f"{rep['base_p99_s']} s), max_queue {rep['max_queue']}, "
        f"{rep['producers']} producers, {rep['n_per_rate']} requests a rung")
    for row in rep["rows"]:
        log(f"[obs] arrival: offered {row['offered_rps']} rps, achieved "
            f"{row['achieved_rps']} rps, p50 {row['p50_s']} s, p99 "
            f"{row['p99_s']} s, delivered {row['delivered']}, shed "
            f"{row['shed']}, errors {row['errors']}")
    log(f"[obs] arrival: knee_rps {rep['knee_rps']} (p99 "
        f"{rep['p99_at_knee_s']} s), shed_onset_rps {rep['shed_onset_rps']}"
        f", null_reasons {rep['null_reasons']}, schedule sha256 "
        f"{rep['schedule_sha256']}; the sweep took {wall:.2f} s; "
        f"{gpu_line()}")
    check("[obs] arrival", {
        "monotone offered ladder": rep["monotone_offered"],
        "every request terminal": rep["reqlife_nonterminal"] == 0,
        "every rung accounted, no errors": all(
            r["delivered"] + r["shed"] == rep["n_per_rate"]
            and r["errors"] == 0 for r in rep["rows"]),
        "8 rungs": len(rep["rows"]) == len(OBS_FRACS),
    })


MESH_LANES = 4  # FleetMesh lanes, all on the one card
MESH_WATCHDOG_S = 4.0  # [mesh] fleet's collective_timeout leg
MESH_SHARDS = 4  # [mesh] toa's TOA shards
MESH_DIST_COUNTS = [2000] * 8  # [mesh] dist's fleet (main par template)
MESH_DIST_TIMEOUT_S = 600.0  # per rank subprocess
MESH_SERVE = dict(n_requests=32, sizes=(48, 96), per_combo=2)


def mesh_fleet(torch, models, toas, tmp, device="cuda"):
    """``[mesh] fleet`` (module docstring, phase 12d): the main path
    through ``FleetMesh`` over 4 logical lanes; returns the K1/K2
    launches of the healthy and the stolen-bucket fits."""
    from pint_tpu_torch import obs
    from pint_tpu_torch.checkpoint import FitCheckpointer
    from pint_tpu_torch.kernels.fusedgls import fused_block_gls_cuda
    from pint_tpu_torch.kernels.seggram import block_grams_cuda
    from pint_tpu_torch.obs import trace as obs_trace
    from pint_tpu_torch.parallel import DeviceLost, FleetMesh, PTAFleet
    from pint_tpu_torch.resilience import FaultPoint, inject
    from pint_tpu_torch.scripts.pint_serve_bench import device_lanes

    lanes = device_lanes(MESH_LANES, device)
    kw = dict(method="gls", maxiter=2, precision="mixed")

    def fleetmesh(**extra):
        extra.setdefault("collective_timeout_s", None)
        return FleetMesh(models, toas, devices=lanes, toa_bucket="plan",
                         **extra)

    def k12():
        return [fused_block_gls_cuda.launches, block_grams_cuda.launches]

    def reset():
        fused_block_gls_cuda.launches = 0
        block_grams_cuda.launches = 0

    def timed(fm, **extra):
        sync()
        t0 = time.perf_counter()
        out = fm.fit(**kw, **extra)
        sync()
        return out, time.perf_counter() - t0

    same = bitwise_fit
    ref_fleet = PTAFleet(models, toas, toa_bucket="plan", device=device)
    ref = ref_fleet.fit(**kw)
    del ref_fleet

    fm = fleetmesh()
    n_buckets = len(fm.bucket_order)
    packed = [oi for oi, key in enumerate(fm.bucket_order)
              if "plan" in fm.build_kwargs.get(key, {})]
    packed_lane = fm.assignment[fm.bucket_order[packed[0]]]
    reset()
    healthy, cold_s = timed(fm)
    k_healthy = k12()
    reset()
    warm, warm_s = timed(fm)
    k_warm = k12()
    del fm
    torch.cuda.empty_cache()

    # device_loss on the packed bucket's lane, traced
    fm_c = fleetmesh()
    builds = {}
    build = fm_c._batch_for

    def timed_build(oi, key, lane):
        t0 = time.perf_counter()
        b = build(oi, key, lane)
        builds.setdefault((oi, lane.index), time.perf_counter() - t0)
        return b

    fm_c._batch_for = timed_build
    obs.enable()
    try:
        obs_trace.reset()
        reset()
        with inject(FaultPoint("device_loss", rate=1.0,
                               payload={"lane": packed_lane})):
            chaos, chaos_s = timed(fm_c)
        k_chaos = k12()
        names = [s["name"] for s in obs_trace.spans()]
    finally:
        obs.disable()
    snap_c = fm_c.snapshot()
    to_lane = fm_c.assignment[fm_c.bucket_order[packed[0]]]
    rebuild_s = builds.get((packed[0], to_lane))
    del fm_c
    torch.cuda.empty_cache()

    # a hung pull on lane 0 past a 4 s watchdog, twice: breaker trips
    fm_t = fleetmesh(collective_timeout_s=MESH_WATCHDOG_S,
                     breaker_threshold=2)
    with inject(FaultPoint("collective_timeout", rate=1.0, count=2,
                           payload={"lane": 0,
                                    "hang_s": 2 * MESH_WATCHDOG_S})):
        hung, hung_s = timed(fm_t)
    snap_t = fm_t.snapshot()
    del fm_t
    torch.cuda.empty_cache()

    # the whole fleet lost after one checkpointed bucket, resumed
    ck = os.path.join(tmp, "mesh_ckpt")
    fm1 = fleetmesh()
    lost = False
    with inject(FaultPoint("device_loss", rate=1.0, after=1)):
        try:
            fm1.fit(**kw, checkpoint_dir=ck)
        except DeviceLost:
            lost = True
    done = FitCheckpointer(ck).restore("fleetmesh")
    del fm1
    fm2 = fleetmesh()
    resumed, resume_s = timed(fm2, checkpoint_dir=ck)
    snap_r = fm2.snapshot()
    del fm2
    torch.cuda.empty_cache()

    log(f"[mesh] fleet: {MESH_LANES} lanes on {lanes[0]}, "
        f"{len(packed)} packed bucket(s) (lane {packed_lane}); healthy "
        f"cold (bucket builds included) {cold_s:.3f} s, warm "
        f"{warm_s:.3f} s; K1/K2 {k_healthy} cold, {k_warm} warm")
    log(f"[mesh] fleet device_loss on lane {packed_lane}: {chaos_s:.3f} s "
        f"(stolen bucket rebuilt on lane {to_lane} in "
        f"{rebuild_s if rebuild_s is None else f'{rebuild_s:.3f}'} s); "
        f"K1/K2 {k_chaos}; reassignments {snap_c['reassignments']}; spans "
        f"mesh.fit {names.count('mesh.fit')}, mesh.bucket "
        f"{names.count('mesh.bucket')}, mesh.steal "
        f"{names.count('mesh.steal')}")
    log(f"[mesh] fleet collective_timeout ({MESH_WATCHDOG_S} s watchdog): "
        f"{hung_s:.3f} s, lost lanes {snap_t['lost_lanes']}, stolen "
        f"{snap_t['stolen_buckets']}; whole-fleet loss: checkpointed "
        f"{None if done is None else len(done['done'])} bucket(s), resumed "
        f"in {resume_s:.3f} s")
    check("[mesh] fleet", {
        "healthy bitwise PTAFleet.fit": same(healthy, ref),
        "warm bitwise the cold": same(warm, healthy),
        "K1/K2 2 + 2 on the packed bucket's lane": k_healthy == [2, 2]
            and k_warm == [2, 2],
        "device_loss: stolen, rebuilt, bitwise": same(chaos, healthy)
            and snap_c["lost_lanes"] == [packed_lane]
            and to_lane != packed_lane and rebuild_s is not None,
        "K1/K2 2 + 2 again on the survivor": k_chaos == [2, 2],
        "mesh.fit > mesh.bucket + mesh.steal spans": names.count(
            "mesh.fit") == 1 and names.count("mesh.bucket") > n_buckets
            and "mesh.steal" in names,
        "collective_timeout trips the breaker, fit completes":
            snap_t["lost_lanes"] == [0] and snap_t["stolen_buckets"] >= 1
            and same(hung, healthy),
        "whole-fleet loss resumes bitwise": lost and done is not None
            and len(done["done"]) == 1 and same(resumed, healthy)
            and snap_r["lost_lanes"] == [],
    })
    return {"healthy": k_healthy, "steal": k_chaos}, {
        "cold_s": cold_s, "warm_s": warm_s, "device_loss_s": chaos_s,
        "rebuild_s": rebuild_s, "timeout_s": hung_s, "resume_s": resume_s}


def fitter_iterates(fitter_module, fit):
    """Run ``fit()`` (a GLSFitter.fit_toas of ``fitter_module``, this
    package's or the JAX package's) and return the marginalized chi2 of
    every iterate it evaluated (x0, x1, ...) and its solves' full steps
    on the host, read by wrapping the module's ``marginalized_chi2`` and
    ``gls_solve`` for the call."""
    chi2s, steps = [], []
    mc, gs = fitter_module.marginalized_chi2, fitter_module.gls_solve

    def chi2_of(*a, **kw):
        chi2s.append(float(mc(*a, **kw)))
        return chi2s[-1]

    def solve(*a, **kw):
        out = gs(*a, **kw)
        steps.append(np.array(out[0].tolist()))
        return out

    fitter_module.marginalized_chi2, fitter_module.gls_solve = chi2_of, solve
    try:
        fit()
    finally:
        fitter_module.marginalized_chi2, fitter_module.gls_solve = mc, gs
    return chi2s, steps


def mesh_toa(torch, toas, device="cuda"):
    """``[mesh] toa``: sharded_gls_fit on the main path's largest pulsar
    over 4 TOA shards of the card, f64 and mixed, each within 1e-6 sigma
    of the same function on one shard and of the card's GLSFitter's last
    Gauss-Newton iterate. GLSFitter returns the iterate of least chi2;
    on these zero-residual TOAs the iterates' chi2 agree to four digits
    and the choice moves x by a few 1e-6 sigma, in the JAX package alike
    (ROADMAP §3), so the returned iterate is logged, not held."""
    from pint_tpu_torch import fitter
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.parallel import make_mesh
    from pint_tpu_torch.parallel.toa_shard import sharded_gls_fit
    from pint_tpu_torch.scripts.pint_serve_bench import device_lanes

    i_big = int(np.argmax([len(t) for t in toas]))
    t = toas[i_big]
    prepared = get_model(par_text(i_big)).prepare(t, device=device)
    names = [n for n, _, _ in prepared.free_param_map()]
    x0 = prepared.vector_from_params().cpu().numpy()
    del prepared
    sync()
    t0 = time.perf_counter()
    f = fitter.GLSFitter(t, get_model(par_text(i_big)), device=device)
    chi2s, steps = fitter_iterates(fitter, lambda: f.fit_toas(maxiter=2))
    sync()
    ref_s = time.perf_counter() - t0
    x_ret = np.array([float(getattr(f.model, n).value) for n in names])
    unc = np.array([float(getattr(f.model, n).uncertainty) for n in names])
    del f
    # x_k = x_{k-1} - step[offset column + 1 : + parameters] (no PHOFF)
    iterates = [x0]
    for dx in steps:
        iterates.append(iterates[-1] - dx[1:1 + len(names)])
    x_ref = iterates[-1]
    off_ret = [float(np.max(np.abs(xk - x_ret) / unc)) for xk in iterates]
    returned = int(np.argmin(off_ret))
    torch.cuda.empty_cache()
    mesh = make_mesh(devices=device_lanes(MESH_SHARDS, device))
    sync()
    t0 = time.perf_counter()
    x1, _, _ = sharded_gls_fit(get_model(par_text(i_big)), t,
                               make_mesh(devices=device_lanes(1, device)),
                               maxiter=2)
    sync()
    one_s = time.perf_counter() - t0
    rows, gaps, gaps1, gaps_ret = {}, {}, {}, {}
    for precision in ("f64", "mixed"):
        torch.cuda.reset_peak_memory_stats()
        timings = {}
        with warnings.catch_warnings(record=True) as wl:
            warnings.simplefilter("always")
            sync()
            t0 = time.perf_counter()
            x, chi2, cov = sharded_gls_fit(
                get_model(par_text(i_big)), t, mesh, maxiter=2,
                precision=precision, compile_timings=timings,
                watchdog_s=600.0)
            sync()
            wall = time.perf_counter() - t0
        refit = any("refitting in f64" in str(w.message) for w in wl)
        gaps[precision] = float(np.max(np.abs(x - x_ref) / unc))
        gaps1[precision] = float(np.max(np.abs(x - x1) / unc))
        gaps_ret[precision] = float(np.max(np.abs(x - x_ret) / unc))
        rows[precision] = (wall, torch.cuda.max_memory_allocated(), chi2,
                           refit, sorted(timings))
        torch.cuda.empty_cache()
    for precision, (wall, peak, chi2, refit, progs) in rows.items():
        log(f"[mesh] toa {precision}: BEN{i_big} {len(t)} TOAs over "
            f"{MESH_SHARDS} shards, sharded_gls_fit maxiter=2 {wall:.3f} s, "
            f"max_memory_allocated {peak / 2**30:.3f} GiB, chi2 {chi2:.9e}, "
            f"programs {progs}, f64 refit {refit}; max |x - x_1 shard|/"
            f"sigma {gaps1[precision]:.3e}, max |x - x_2 GLSFitter|/sigma "
            f"{gaps[precision]:.3e}, max |x - x_returned|/sigma "
            f"{gaps_ret[precision]:.3e}")
    log(f"[mesh] toa: GLSFitter f64 maxiter=2 on the card {ref_s:.3f} s, "
        f"chi2 of x0, x1, x2 {chi2s}, returned x{returned}; "
        f"sharded_gls_fit f64 on 1 shard {one_s:.3f} s")
    check("[mesh] toa", {
        "f64 vs 1 shard <= 1e-6 sigma": gaps1["f64"] <= TOL_MIXED,
        "mixed vs 1 shard <= 1e-6 sigma": gaps1["mixed"] <= TOL_MIXED,
        "f64 vs GLSFitter's x_2 <= 1e-6 sigma": gaps["f64"] <= TOL_MIXED,
        "mixed vs GLSFitter's x_2 <= 1e-6 sigma": gaps["mixed"] <= TOL_MIXED,
        "GLSFitter returned one of its iterates":
            off_ret[returned] <= 1e-12,
        "no f64 refit": not rows["mixed"][3],
        "finite chi2": all(np.isfinite(r[2]) for r in rows.values()),
    })
    return {p: r[0] for p, r in rows.items()}


MESH_RANK = r'''
import os, pickle, sys, warnings
warnings.simplefilter("ignore")
sys.path.insert(0, sys.argv[5])
rank, world, store, fleet, repo, backend, device = (int(sys.argv[1]),
    int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5], sys.argv[6],
    sys.argv[7])
import numpy as np
import torch
import torch.distributed as dist
from pint_tpu_torch.models import get_model
from pint_tpu_torch.parallel import PTABatch
from pint_tpu_torch.parallel.distributed import (
    assemble_global_batch, global_pulsar_mesh, initialize_distributed,
    process_pulsar_slice)
assert initialize_distributed(coordinator_address="file://" + store,
                              num_processes=world, process_id=rank,
                              backend=backend, timeout_s=300) == (rank, world)
if backend == "nccl":
    one = torch.ones(1, device="cuda")
    dist.all_reduce(one)
    assert float(one) == world
with open(fleet, "rb") as fh:
    pars, toas, n_pad = pickle.load(fh)
sl = process_pulsar_slice(len(pars))
b = PTABatch([get_model(p) for p in pars[sl]], toas[sl], pad_toas=n_pad,
             device=device)
b = assemble_global_batch(b, mesh=global_pulsar_mesh(device))
out = {}
for prec in ("f64", "mixed"):
    x, chi2, cov = b.gls_fit(maxiter=2, precision=prec)
    out.update({"x_" + prec: x, "chi2_" + prec: chi2, "cov_" + prec: cov})
np.savez(fleet + f".{backend}{rank}.npz", **out)
dist.destroy_process_group()
print("RANK-OK", backend, rank, flush=True)
'''


def mesh_dist(torch, tmp, device="cuda",
              groups=(("gloo", 2), ("nccl", 1))):
    """``[mesh] dist``: two ranks as subprocesses on the card joined by
    gloo, each fitting its half of an 8-pulsar fleet of the main par
    template, against a single-process fit; and one NCCL rank of world
    size 1."""
    from pint_tpu_torch.parallel import PTABatch

    models, toas = build_pta(MESH_DIST_COUNTS, device, seed=17)
    pars = [par_text(i) for i in range(len(models))]
    n_pad = max(len(t) for t in toas)
    fleet = os.path.join(tmp, "mesh_fleet.pkl")
    with open(fleet, "wb") as fh:
        pickle.dump((pars, toas, n_pad), fh)
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    runs = [(backend, world, r) for backend, world in groups
            for r in range(world)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", MESH_RANK, str(rank), str(world),
         os.path.join(tmp, f"store_{backend}"), fleet, repo, backend,
         device],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for backend, world, rank in runs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=MESH_DIST_TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    ranks_s = time.perf_counter() - t0
    for (backend, _, rank), (out, err) in zip(runs, outs):
        if f"RANK-OK {backend} {rank}" not in out:
            raise AssertionError(f"[mesh] dist {backend} rank {rank} "
                                 f"failed: {out[-1000:]} {err[-3000:]}")
    got = {(b, r): dict(np.load(f"{fleet}.{b}{r}.npz")) for b, _, r in runs}
    ref = PTABatch(models, toas, pad_toas=n_pad, device=device)
    gaps = {}
    for prec in ("f64", "mixed"):
        x, chi2, cov = ref.gls_fit(maxiter=2, precision=prec)
        sig = np.sqrt(np.diagonal(cov, axis1=1, axis2=2))
        for (b, r), g in got.items():
            gaps[(prec, b, r)] = (
                float(np.max(np.abs(g["x_" + prec] - x) / sig)),
                float(np.max(np.abs(g["x_" + prec] - x)
                             / np.maximum(np.abs(x), 1e-300))),
                float(np.max(np.abs(g["chi2_" + prec] - chi2)
                             / np.abs(chi2))))
    log(f"[mesh] dist: {len(models)} pulsars, {sum(MESH_DIST_COUNTS)} TOAs; "
        f"2 gloo ranks + 1 NCCL rank (world size 1) on the card, "
        f"subprocesses {ranks_s:.2f} s; gaps to the single-process fit "
        "(sigma, relative x, relative chi2): "
        + "; ".join(f"{p} {b}{r} {g[0]:.3e} {g[1]:.3e} {g[2]:.3e}"
                    for (p, b, r), g in gaps.items()))
    check("[mesh] dist", {
        "ranks agree bitwise": all(
            np.array_equal(got[("gloo", 0)][k], got[("gloo", 1)][k])
            for k in got[("gloo", 0)]),
        "<= 1e-6 sigma of the single-process fit": all(
            g[0] <= TOL_MIXED for g in gaps.values()),
        "f64 at the 1e-12 tier": all(
            g[1] <= 1e-12 and g[2] <= 1e-12
            for (p, _, _), g in gaps.items() if p == "f64"),
    })
    return ranks_s


def mesh_serve(torch, device="cuda"):
    """``[mesh] serve``: run_device_chaos on two logical lanes of the
    card, and one StreamingRefitter(mesh=make_mesh(1)) append; returns
    K1′'s launches in that append."""
    from pint_tpu_torch.kernels.incremental import delta_gram_cuda
    from pint_tpu_torch.parallel import make_mesh
    from pint_tpu_torch.scripts import pint_serve_bench as bench
    from pint_tpu_torch.serve import StreamingRefitter

    t0 = time.perf_counter()
    rep = bench.run_device_chaos(n_devices=2, device=device, **MESH_SERVE)
    chaos_s = time.perf_counter() - t0
    models, toas = build_pta([4000], device, seed=31, par_fn=lane_par_text)
    chunk = stream_traffic(models, device, extra_lane=-1, seed=32)[0][0]
    ref = StreamingRefitter(
        mesh=make_mesh(devices=bench.device_lanes(1, device)))
    ref.register(models[0], toas[0], precision="mixed")
    delta_gram_cuda.launches = 0
    sync()
    t1 = time.perf_counter()
    out = ref.append(models[0], chunk, rid="mesh0")
    sync()
    append_s = time.perf_counter() - t1
    k1p = delta_gram_cuda.launches
    log(f"[mesh] serve: run_device_chaos on {rep['devices']}: "
        f"{rep['n_requests']} requests, failures {rep['serve_failures']}, "
        f"bitwise the fault-free stream {rep['serve_bitwise_vs_clean']}, "
        f"lost lanes {rep['serve_lost_lanes']}, device_lost "
        f"{rep['serve_device_lost']}; fleet leg stolen "
        f"{rep['fleet_stolen_buckets']}, max rel diff "
        f"{rep['fleet_max_rel_diff_vs_healthy']:.3e}; {chaos_s:.2f} s")
    log(f"[mesh] serve: StreamingRefitter(mesh=make_mesh(1)) on "
        f"{ref.device}: one {len(chunk)}-TOA mixed append {append_s * 1e3:.2f}"
        f" ms, solver {out['solver']}, K1′ launches {k1p}")
    check("[mesh] serve", {
        "device chaos ok": rep["ok"],
        "every request ok, bitwise the fault-free stream":
            rep["serve_failures"] == 0 and rep["serve_bitwise_vs_clean"],
        "lost lane quarantined, its slots re-routed":
            len(rep["serve_lost_lanes"]) == 1
            and rep["serve_device_lost"] == 1,
        "K1′ once in the mesh refitter's append": k1p == 1,
    })
    return k1p, chaos_s


def mesh_phase(torch, models, toas, device="cuda"):
    """``[mesh]`` (module docstring, phase 12d): fleet, toa, dist, serve."""
    walls = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        k12, walls["fleet"] = mesh_fleet(torch, models, toas, tmp, device)
        walls["fleet_phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        walls["toa"] = mesh_toa(torch, toas, device)
        walls["toa_phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        walls["dist_ranks_s"] = mesh_dist(torch, tmp, device)
        walls["dist_phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    k1p, walls["serve_chaos_s"] = mesh_serve(torch, device)
    walls["serve_phase_s"] = time.perf_counter() - t0
    log(f"[mesh] walls: {json.dumps(walls, default=float)}; {gpu_line()}")
    return k12, k1p


MESH2D_SHAPE = (2, 2)  # [mesh] 2d: (pulsar, toa) shards, logical lanes
TOL_CHI2_2D = 1e-9  # 2-D vs plain chi2, relative (mixed: refined solve)
# f64's unrefined eigh solve leaves its chi2 (rᵀC⁻¹r - bᵀA⁻¹b, at the
# rounding floor on zero-residual TOAs) up to ~eps x cond(A) off the
# refined one: on the card the plain fleet's f64 chi2 lies 1.52e-7
# from its own mixed (refined) chi2, the 2-D fleet's 0.0, so the two
# f64 chi2 differ by 1.52e-7 (the largest reading, 6.6x under this)
TOL_CHI2_2D_F64 = 1e-6
TOL_COV_2D = {"f64": 1e-9, "mixed": 1e-5}  # of sqrt(C_ii C_jj); f32 Gram
TOL_RESID_2D = 1e-12  # residuals at the start, of max|r|; white chi2 rel


def mesh_2d(torch, models, toas, x_start, device="cuda"):
    """``[mesh] 2d``: the main path's pulsars and par template at full
    width (EFAC/EQUAD/ECORR, 30 red-noise harmonics, 64 columns) in
    pow2 buckets on a 2 x 2 ("pulsar", "toa") mesh of four logical
    entries of the card (``parallel/sharded.py::ToaRowBatch``: each
    bucket's pulsar halves split their TOA axis in two), GLS maxiter=2
    in f64 and mixed from the 3-sigma-off start, twice each, against
    the same fleet without a mesh: parameters, chi2 and covariance, and
    the residuals at the start (``gw_arrays``: every TOA block and the
    weighted mean over blocks, away from the fitted rounding floor).
    The lanes share one card, so the rows' programs capture: the 2-D
    fleet fits once more pipelined (captured replays), bitwise its
    sequential fit. Pow2 buckets are unpacked, so no kernel lies on
    this path; no scaling figure is printed. Returns the walls."""
    from pint_tpu_torch.parallel import PTAFleet, make_mesh2d
    from pint_tpu_torch.parallel.sharded import ToaRowBatch

    card = torch.device(device, 0) if device == "cuda" else torch.device(
        device)
    mesh = make_mesh2d(*MESH2D_SHAPE,
                       devices=[card] * (MESH2D_SHAPE[0] * MESH2D_SHAPE[1]))
    fits, walls, peaks, refits, starts, piped = {}, {}, {}, [], {}, {}
    for tag, kw in (("plain", dict(device=device)), ("2d", dict(mesh=mesh))):
        t0 = time.perf_counter()
        fleet = PTAFleet(models, toas, toa_bucket="pow2", **kw)
        sync()
        walls[f"{tag} pack_s"] = time.perf_counter() - t0
        set_start(fleet, x_start)
        starts[tag] = {key: fleet.batches[key].gw_arrays(x_start[idxs])
                       for key, idxs in fleet.group_indices.items()}
        for prec in ("f64", "mixed"):
            torch.cuda.reset_peak_memory_stats()
            runs = []
            for i in range(2):
                x, c, cov, wall, refit = timed_fit(fleet, torch,
                                                   precision=prec)
                runs.append((x, c, cov))
                refits.append(refit)
                walls[f"{tag} {prec} {'cold' if i == 0 else 'warm'} s"] = wall
            fits[(tag, prec)] = runs
            peaks[f"{tag} {prec}"] = torch.cuda.max_memory_allocated() / 2**30
        if tag == "2d":
            torch.cuda.reset_peak_memory_stats()
            for prec in ("f64", "mixed"):
                for i in range(2):
                    x, c, cov, wall, refit = timed_fit(
                        fleet, torch, precision=prec, pipeline=True)
                    refits.append(refit)
                    walls[f"2d {prec} pipelined {'cold' if i == 0 else 'warm'}"
                          f" s"] = wall
                piped[prec] = (x, c, cov)
            peaks["2d pipelined"] = torch.cuda.max_memory_allocated() / 2**30
            rows = [s for b in fleet.batches.values()
                    for s in getattr(b, "_shards", [])]
            blocks = sorted({tuple(int(t.tdb_sec.shape[1])
                                   for t in s._leaves()[2]) for s in rows})
            captured = [p.captured for b in fleet.batches.values()
                        if hasattr(b, "_shards") for progs in b._fns.values()
                        if isinstance(progs, list) for p in progs]
        n_buckets = len(fleet.batches)
        del fleet
        torch.cuda.empty_cache()
    sig = np.sqrt(np.array([np.diag(c) for c in fits[("plain", "f64")][1][2]]))
    gaps = {"chi2 range": [float(np.min(fits[("plain", "f64")][1][1])),
                           float(np.max(fits[("plain", "f64")][1][1]))]}
    for prec in ("f64", "mixed"):
        x, c, cov = fits[("2d", prec)][1]
        x0, c0, cov0 = fits[("plain", prec)][1]
        gaps[f"{prec} vs plain sigma"] = float(np.max(np.abs(x - x0) / sig))
        gaps[f"{prec} vs plain chi2 rel"] = float(np.max(np.abs(c - c0)
                                                         / np.abs(c0)))
        gaps[f"{prec} vs plain cov"] = max(float(np.max(np.abs(a - b) / np.sqrt(
            np.outer(np.diag(b), np.diag(b))))) for a, b in zip(cov, cov0))
    for tag in ("plain", "2d"):  # the f64 solve's own chi2 floor
        c64, cm = fits[(tag, "f64")][1][1], fits[(tag, "mixed")][1][1]
        gaps[f"{tag} f64 vs mixed chi2 rel"] = float(np.max(
            np.abs(c64 - cm) / np.abs(cm)))
    r_gap = w_gap = 0.0
    for key, a0 in starts["plain"].items():
        a = starts["2d"][key]
        m = a0["mask"]
        scale = np.max(np.abs(np.where(m, a0["resid"], 0.0)), axis=1)
        r_gap = max(r_gap, float(np.max(np.max(np.abs(np.where(
            m, a["resid"] - a0["resid"], 0.0)), axis=1) / scale)))
        w0, w = (np.sum(np.where(m, (b["resid"] / b["sigma_us"]) ** 2, 0.0),
                        axis=1) for b in (a0, a))
        w_gap = max(w_gap, float(np.max(np.abs(w - w0) / w0)))
    gaps["start resid of max|r|"] = r_gap
    gaps["start white chi2 rel"] = w_gap
    x_m = fits[("2d", "mixed")][1][0]
    x_f = fits[("2d", "f64")][1][0]
    gaps["mixed vs f64 sigma"] = float(np.max(np.abs(x_m - x_f) / sig))
    log(f"[mesh] 2d: {len(models)} pulsars in {n_buckets} pow2 buckets on a "
        f"{MESH2D_SHAPE[0]} x {MESH2D_SHAPE[1]} mesh of {card} (logical "
        f"lanes, no scaling figure); {len(rows)} TOA-split rows, TOA "
        f"blocks per row {blocks}; {sum(captured)} of {len(captured)} row "
        f"programs captured")
    log(f"[mesh] 2d walls: {json.dumps(walls, default=float)}; peak "
        f"memory GiB {json.dumps(peaks)}")
    log(f"[mesh] 2d gaps: {json.dumps(gaps)}; {gpu_line()}")
    check("[mesh] 2d", {
        "every multi-pulsar bucket TOA-split": rows and all(
            isinstance(s, ToaRowBatch) for s in rows),
        "TOA blocks within one row of each other": all(
            max(b) - min(b) <= 1 for b in blocks),
        "row programs captured on the one card": (
            captured and all(captured)) or device != "cuda",
        "pipelined (replayed) fits bitwise the sequential ones": all(
            bitwise_fit(fits[("2d", p)][0], piped[p])
            for p in ("f64", "mixed")),
        "start residuals and white chi2 as the plain fleet's":
            r_gap <= TOL_RESID_2D and w_gap <= TOL_RESID_2D,
        "f64 vs plain <= 1e-6 sigma, cov, chi2 at f64's floor": gaps[
            "f64 vs plain sigma"] <= 1e-6
            and gaps["f64 vs plain cov"] <= TOL_COV_2D["f64"]
            and gaps["f64 vs plain chi2 rel"] <= TOL_CHI2_2D_F64,
        "mixed vs plain <= 1e-6 sigma, cov, chi2 1e-9": gaps[
            "mixed vs plain sigma"] <= 1e-6
            and gaps["mixed vs plain cov"] <= TOL_COV_2D["mixed"]
            and gaps["mixed vs plain chi2 rel"] <= TOL_CHI2_2D,
        "mixed vs f64 <= 1e-6 sigma": gaps["mixed vs f64 sigma"] <= 1e-6,
        "second fit bitwise": all(bitwise_fit(*fits[("2d", p)])
                                  for p in ("f64", "mixed")),
        "no f64 refit": not any(refits),
    })
    return walls


REGRESS_TAG = "[regress]"
REGRESS_KEY = "measured_670k_gls_refit_s"  # the planted regressions' key
REGRESS_PLANTED = {1.25: True, 0.8: False}  # r04's factor: flagged?
REGRESS_PHASE_S = 5.0  # the phase's wall limit
# the JAX package's round of the full kill matrix has 8 sites
KILL_SUBSET = f"kill_sites_subset:{len(KILL_SMOKE_SITES)}_of_8"
# bench.py's fit-quality stage and its fleet, which [fitq] does not run
FITQ_KEYS = tuple("measured_670k_fitq_" + k for k in (
    "overhead_pct", "probe_wall_s", "bitwise", "fits", "fallbacks",
    "diverged", "max_abs_chi2_z", "max_condition"))
FITQ_DIFFERS = "definition_differs:bench_fleet_18x48_pow2_auto_maxiter3"


def card_round(card, main, lint, chaos, kill):
    """The card's own benchmark round, in the JAX package's round format
    (``BENCH_r*.json``: ``parsed.detail`` with flat keys and
    ``null_reasons``), holding the keys of the port's ``budgets.json``
    that a phase of this run measures under bench.py's definition:

    - ``[main]``: ``measured_670k_gls_refit_s`` (the warm f64 GLS refit,
      maxiter 2, of the 68-pulsar plan fleet, bench.py:355-369) and
      the mixed one, TOAs, buckets, padding (bench.py:538-541,749-753);
    - ``[lint]``: ``pintlint_unsuppressed`` / ``_suppressed`` (the
      port's tree, bench.py:1401-1417's counts);
    - ``[durable] chaos``: ``chaos_*`` of ``run_chaos_stream`` at
      bench.py:1128's parameters, on the ``[serve]`` fleet's sizes;
    - ``[durable] kill``: ``chaos_kill_*`` of ``run_kill_chaos`` at its
      defaults over ``KILL_SMOKE_SITES``: the per-site contracts (0
      lost, 0 duplicated, 0 digest mismatches, the worst cold/warm
      ratio) and the site count.

    A key whose scope differs from bench.py's is left out with a
    reason in ``null_reasons``: the headline rate (bench.py:1852
    refits 68 x 1,000 equal-count TOAs in one batch), the fit-quality
    stage's keys (bench.py:1572-1612 probes an 18-pulsar, 48-TOA pow2
    fleet at method auto, maxiter 3; ``[fitq] main`` probes the 670k
    plan fleet and logs its own overhead), and the kill matrix's
    totals and walls over 4 of its 8 sites. ``card`` is the
    ``nvidia-smi --query-gpu=name,power.limit`` line."""
    kind, _, power = card.rpartition(", ")
    detail = {
        "platform": "gpu",
        "device_kind": kind or card,
        "power_limit_w": power,
        "measured_670k_gls_refit_s": main["f64_s"],
        "measured_670k_mixed_refit_s": main["mixed_s"],
        "measured_670k_mixed_fell_back_f64": main["refit"],
        "measured_670k_total_toas": main["n_toa"],
        "measured_670k_buckets": main["buckets"],
        "measured_670k_bucket_mode": "plan",
        "measured_670k_padding_ratio": main["padding"],
        "measured_670k_plan_padding_ratio": main["padding"],
        "measured_670k_plan_n_programs": main["buckets"],
        "pintlint_unsuppressed": lint["unsuppressed"],
        "pintlint_suppressed": lint["suppressed"],
        "chaos_ok": chaos["ok"],
        "chaos_injected": chaos["injected"],
        "chaos_healthy_failures": chaos["healthy_failures"],
        "chaos_unexpected_recompiles": chaos["unexpected_recompiles"],
        "chaos_kill_sites": kill["n_sites"],
        "chaos_kill_lost": kill["lost"],
        "chaos_kill_duplicated": kill["duplicated"],
        "chaos_kill_digest_mismatches": kill["digest_mismatches"],
        "chaos_kill_cold_vs_warm_ratio": kill["cold_vs_warm_ratio"],
        "null_reasons": {
            "pta_gls_refit_toas_per_sec":
                "definition_differs:68x1000_equal_counts_in_bench",
            "chaos_kill_ok": KILL_SUBSET,
            "chaos_kill_replayed": KILL_SUBSET,
            "cold_start_recovered_s": KILL_SUBSET,
            **{key: FITQ_DIFFERS for key in FITQ_KEYS},
        },
    }
    return {"n": 1, "cmd": "python3 chip_smoke.py", "rc": 0, "parsed": {
        "metric": "pta_gls_refit_toas_per_sec", "value": None,
        "unit": "TOA/s", "detail": detail}}


def budget_breaches(detail, budgets):
    """The budget keys a round's ``detail`` breaks, recomputed without
    ``obs/baseline.py``: each key held as a number against its max and
    min."""
    out = set()
    for key, bound in budgets.items():
        v = detail.get(key)
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        if v > bound.get("max", np.inf) or v < bound.get("min", -np.inf):
            out.add(key)
    return out


def write_round(root, n, doc, **detail):
    """``doc`` as ``root/BENCH_r<n>.json``, its detail updated."""
    doc = copy.deepcopy(doc)
    doc["n"] = n
    doc["parsed"]["detail"].update(detail)
    with open(os.path.join(root, "BENCH_r%02d.json" % n), "w") as fh:
        json.dump(doc, fh)


def regress_phase(round_doc):
    """``[regress]``: the port's gate (``obs/baseline.py``,
    ``python -m pint_tpu_torch.obs regress``/``doctor``) on the card's
    own round (:func:`card_round`), written as ``BENCH_r01.json`` into a
    temporary directory. Checks: the gate's budget violations are the
    keys :func:`budget_breaches` finds; over copies of the round as
    r01-r03 and an r04 with ``measured_670k_gls_refit_s`` at 1.25x the
    gate names it, at 0.8x it does not; an r05 with ``platform: "tpu"``
    is not loaded, nor are the repo's own (the JAX package's) rounds;
    ``regress`` and ``doctor`` run in process exit 0 exactly when the
    report is ok; pintlint's ``meta-key-unbudgeted`` finds nothing in
    this file; the phase under 5 s. A budget the card's round breaks
    is printed on a ``[regress] BUDGET`` line and does not fail the
    phase."""
    from pint_tpu_torch.analysis import LintConfig, all_rules
    from pint_tpu_torch.analysis import run as lint_run
    from pint_tpu_torch.obs import baseline
    from pint_tpu_torch.obs.__main__ import main as obs_main

    t0 = time.perf_counter()
    spec = baseline.load_budgets()
    detail = round_doc["parsed"]["detail"]
    want = budget_breaches(detail, spec["budgets"])
    planted = {}
    codes = {}
    with tempfile.TemporaryDirectory() as own, \
            tempfile.TemporaryDirectory() as trail:
        write_round(own, 1, round_doc)
        report = baseline.run_regress(root=own)
        for cmd in ("regress", "doctor"):
            out, err = io.StringIO(), io.StringIO()
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                codes[cmd] = obs_main([cmd, "--root", own])
            log(f"{REGRESS_TAG} python -m pint_tpu_torch.obs {cmd}: exit "
                f"{codes[cmd]}; {out.getvalue().splitlines()[0]}")
        for factor in REGRESS_PLANTED:
            for n in (1, 2, 3):
                write_round(trail, n, round_doc)
            write_round(trail, 4, round_doc,
                        **{REGRESS_KEY: detail[REGRESS_KEY] * factor})
            rep = baseline.run_regress(root=trail)
            planted[factor] = [r["key"] for r in rep["regressions"]]
            log(f"{REGRESS_TAG} r01-r03 the card's round, r04 with "
                f"{REGRESS_KEY} x{factor}: regressions {planted[factor]}, "
                f"checked {len(rep['checked'])} keys")
        write_round(trail, 5, round_doc, platform="tpu",
                    **{REGRESS_KEY: detail[REGRESS_KEY] * 10})
        tpu = baseline.run_regress(root=trail)
    repo = baseline.run_regress(root=os.path.dirname(
        os.path.abspath(__file__)))
    rule = [r for r in all_rules() if r.id == "meta-key-unbudgeted"]
    config = LintConfig.default()
    findings = lint_run([os.path.abspath(__file__)], config=config,
                        rules=rule, whole_program=False)
    wall = time.perf_counter() - t0
    got = {v["key"] for v in report["budget_violations"]}
    numbers = sum(1 for v in detail.values()
                  if isinstance(v, (int, float)) and not isinstance(v, bool))
    log(f"{REGRESS_TAG} the card's round ({detail['device_kind']}, "
        f"{detail['power_limit_w']}): {numbers} numbers, "
        f"{len(detail['null_reasons'])} reason-coded nulls; gate ok "
        f"{report['ok']}, {len(got)} budget violations (recomputed: "
        f"{len(want)}), checked {report['checked']}, skipped "
        f"{len(report['skipped'])}")
    for v in report["budget_violations"]:
        log(f"{REGRESS_TAG} BUDGET {v['detail']} ({v['source']})")
    log(f"{REGRESS_TAG} with a tpu r05: rounds {tpu['rounds']}, latest "
        f"{tpu['latest']}; the repo's own rounds: {repo.get('error')}; "
        f"meta-key-unbudgeted over chip_smoke.py: {len(findings)} "
        f"findings; {wall:.2f} s")
    for f in findings:
        log(f"{REGRESS_TAG}   {f.path}:{f.line} {f.message}")
    check(REGRESS_TAG, {
        "the gate's budget violations are the recomputed ones": got == want,
        "the card's round is the one round": report["rounds"] == ["r01"],
        "a 1.25x refit wall is flagged, 0.8x is not": all(
            (REGRESS_KEY in planted[f]) == flag
            for f, flag in REGRESS_PLANTED.items()),
        "no other key flagged on equal rounds": all(
            set(planted[f]) <= {REGRESS_KEY} for f in REGRESS_PLANTED),
        "a tpu round is not loaded": tpu["rounds"] == [
            "r01", "r02", "r03", "r04"] and tpu["regressions"] == [],
        "the repo's JAX-package rounds are not loaded":
            repo["n_rounds"] == 0 and not repo["ok"],
        "regress exits 0 exactly when the report is ok":
            codes["regress"] == (0 if report["ok"] else 1),
        "doctor exits 0 exactly when the report is ok":
            codes["doctor"] == (0 if report["ok"] else 1),
        "meta-key-unbudgeted is bound to the budget file":
            config.budgeted_meta_keys is not None,
        "meta-key-unbudgeted finds nothing in chip_smoke.py":
            findings == [],
        "the phase under 5 s": wall < REGRESS_PHASE_S,
    })
    return report


def run():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs an NVIDIA card", file=sys.stderr)
        return 1
    from pint_tpu_torch import native
    from pint_tpu_torch.kernels import build
    from pint_tpu_torch.kernels.fusedgls import (fused_block_gls_cuda,
                                                 fused_block_gls_plain)
    from pint_tpu_torch.kernels.seggram import (block_grams_cuda,
                                                block_grams_plain)
    from pint_tpu_torch.parallel.pta import PTAFleet

    card = gpu_line()
    log(f"[card] {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; tf32 matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}")
    lint_scan = lint_start()  # host only: read by [lint]

    t0 = time.perf_counter()
    host_build = []
    host = threading.Thread(target=lambda: host_build.append(
        (native.get_lib(), time.perf_counter() - t0)))
    host.start()  # g++ beside the three nvcc builds
    build.load_all(["gram", "paircorr", "harmonics"])
    host.join()
    log(f"[build] csrc/gram.cu, csrc/paircorr.cu and csrc/harmonics.cu "
        f"(one nvcc each) and csrc/host_kernels.cpp (g++), all started "
        f"together, built and loaded in {time.perf_counter() - t0:.2f} s")
    log(f"[build] csrc/host_kernels.cpp: g++ {host_build[0][1]:.2f} s, "
        f"loaded: {host_build[0][0] is not None} "
        f"{native.BUILD_ERROR}".rstrip())
    for name, tag in (("gram", "[build]"), ("paircorr", "[gw] build"),
                      ("harmonics", "[photon] build")):
        info = build.BUILD_INFO[name]
        log(f"{tag} csrc/{name}.cu: nvcc {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if ("registers" in line or "spill" in line
                    or "Compiling entry" in line):
                log(f"{tag} {line.strip()}")

    counts = ragged_counts()
    t0 = host_t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        models, toas = ingest(counts, tmp)
    ingest_s = time.perf_counter() - t0
    n_toa = sum(len(t) for t in toas)
    log(f"[host] {len(models)} pulsars, {n_toa} GBT TOAs made, written "
        f"and read back by get_TOAs in {ingest_s:.2f} s")
    ingest_ngc6440e()
    t0 = time.perf_counter()
    fleet = PTAFleet(models, toas, toa_bucket="plan", device="cuda")
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    log(f"[host] fleet pack in {pack_s:.2f} s, padding x"
        f"{fleet.padding_ratio:.4f}, {len(fleet.batches)} buckets:")
    for key, b in fleet.batches.items():
        desc = (f"packed R={b._pack['n_rows']} S={b._pack['n_slots']} "
                f"Q={b._pack['quantum']} NE={b._pack['n_epochs']}"
                if b._pack else f"unpacked B={b.n_pulsars}")
        log(f"[host]   width {key[1][1]}: {b.n_pulsars} pulsars, "
            f"{int(np.sum(b.n_toas))} TOAs, {desc}")

    x_true = truth_vectors(fleet, models)
    xs, chi2, covs, wall, _ = timed_fit(fleet, torch, precision="f64")
    sig = np.sqrt(np.array([np.diag(c) for c in covs]))
    log(f"[fit] f64 at the truth (first fit of the process): {wall:.3f} s, "
        f"max |x - x_true|/sigma {np.max(np.abs(xs - x_true) / sig):.3e}")
    signs = np.where(np.arange(x_true.size).reshape(x_true.shape) % 2, 1, -1)
    x_start = x_true + START_OFFSET_SIGMA * sig * signs
    set_start(fleet, x_start)

    fused_block_gls_cuda.launches = 0
    block_grams_cuda.launches = 0
    xm, cm, cov_m, cold, refit_cold = timed_fit(fleet, torch,
                                                precision="mixed")
    launches = {"K1": fused_block_gls_cuda.launches,
                "K2": block_grams_cuda.launches}
    relres = max(m["relres_max"] for m in fleet.fit_metrics.values())
    refit = refit_cold or any(m["refit_f64"]
                              for m in fleet.fit_metrics.values())
    xm2, _, _, warm, refit_warm = timed_fit(fleet, torch, precision="mixed")
    warm_metrics = dict(fleet.fit_metrics)
    x64, c64, _, wall64, _ = timed_fit(fleet, torch, precision="f64")
    sig_m = np.sqrt(np.array([np.diag(c) for c in cov_m]))
    d_mixed = np.max(np.abs(xm - x64) / sig_m)
    d_true = np.max(np.abs(xm - x_true) / sig_m)
    log(f"[main] mixed cold {cold:.3f} s ({n_toa / cold:.0f} TOAs/s), warm "
        f"{warm:.3f} s ({n_toa / warm:.0f} TOAs/s); f64 {wall64:.3f} s "
        f"({n_toa / wall64:.0f} TOAs/s)")
    log(f"[main] launches in the cold mixed fit: {launches}; max relres "
        f"{relres:.3e}; f64 refit taken: {refit or refit_warm}")
    log(f"[main] max |x_mixed - x_f64|/sigma {d_mixed:.3e}; max |x_fit - "
        f"x_true|/sigma {d_true:.3e} (start {START_OFFSET_SIGMA} sigma off)")
    for key, m in warm_metrics.items():
        log(f"[main]   width {key[1][1]}: {m['fit_wall_s']:.3f} s (warm "
            f"mixed, host clock), relres {m['relres_max']:.2e}")
    checks = {
        "K1 launched on the main path": launches["K1"] > 0,
        "K2 launched on the main path": launches["K2"] > 0,
        "refinement contracted (relres <= 1e-8)": relres <= TOL_RELRES,
        "no f64 refit taken": not (refit or refit_warm),
        "mixed vs f64 <= 1e-6 sigma": d_mixed <= TOL_MIXED,
        "recovery <= 0.01 sigma": d_true <= TOL_RECOVER,
        "warm mixed fit reproduces the cold one":
            np.max(np.abs(xm2 - xm) / sig_m) <= TOL_MIXED,
        "finite chi2": bool(np.all(np.isfinite(cm)) and np.all(np.isfinite(c64))),
    }
    check("main path", checks)
    main_round = {"f64_s": wall64, "mixed_s": warm, "n_toa": n_toa,
                  "refit": bool(refit or refit_warm),
                  "buckets": len(fleet.batches),
                  "padding": fleet.padding_ratio}
    freq_s = main_freq(models, toas)
    log(f"[main] freq took {freq_s:.2f} s; {card}")

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        store_launches = durable_store(torch, models, toas, fleet, x_start,
                                       pack_s, tmp)
        ckpt_launches = durable_checkpoint(torch, fleet, x_start, tmp)
        torch.cuda.empty_cache()
        log(f"[durable] store and checkpoint took "
            f"{time.perf_counter() - t0:.2f} s")

    names = [n for n, _, _ in
             fleet.batches[next(iter(fleet.batches))].free_map()]
    t0 = time.perf_counter()
    fitq_phase(torch, fleet, toas, names, x_start)
    log(f"[fitq] main took {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    pintk_phase(torch, toas, names, x_true, x_start)
    log(f"[pintk] took {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    apps_binaryconvert(torch, counts)
    torch.cuda.empty_cache()
    log(f"[apps] binaryconvert took {time.perf_counter() - t0:.2f} s")

    profile_run(torch, "[profile] warm mixed fit",
                lambda: fleet.fit(method="gls", maxiter=2, precision="mixed"))
    seen = capture_inputs(fleet, torch)
    entries = [
        kernel_record(torch, "fused_block_gls",
                      "pint_tpu/kernels/fusedgls.py:109",
                      fused_block_gls_cuda, fused_block_gls_plain,
                      *seen["K1"], True, launches["K1"]),
        kernel_record(torch, "block_grams",
                      "pint_tpu/kernels/seggram.py:66",
                      block_grams_cuda, block_grams_plain, *seen["K2"],
                      False, launches["K2"]),
    ]
    for entry, k in ((entries[0], 0), (entries[1], 1)):
        entry["launches_new_paths"] = {
            "durable store": store_launches[k],
            "durable checkpoint": ckpt_launches[k]}

    t0 = time.perf_counter()
    fitter_ngc6440e()
    fitter_pulsar(toas, names, x_true, x_start, xm2)
    log(f"[fitter] phases took {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    fleet_modes(models, toas, fleet, x_start, xm2, sig_m)
    log(f"[fleet] modes took {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    pipeline_phase(torch, LINT_STACKS_OF, fleet, x64, sig_m,
                   lambda k: f"width {k[1][1]}", SYNC_STACKS)
    log(f"[pipeline] main took {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    lint = lint_phase(lint_scan, host_t0)
    log(f"[lint] took {time.perf_counter() - t0:.2f} s; {card}")

    t0 = time.perf_counter()
    zoo_b1855()
    zoo_components()
    log(f"[zoo] b1855 and components took {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    zoo_seen, zoo_launches = zoo_fleet(torch, counts)
    torch.cuda.empty_cache()
    log(f"[zoo] fleet took {time.perf_counter() - t0:.2f} s")
    for entry, key, kern, plain, whiten in (
            (entries[0], "K1", fused_block_gls_cuda, fused_block_gls_plain,
             True),
            (entries[1], "K2", block_grams_cuda, block_grams_plain, False)):
        entry["zoo"] = {
            tag: kernel_record(torch, f"{entry['name']} [zoo] {tag}",
                               entry["replaces"], kern, plain, x, block,
                               whiten, zoo_launches[key])
            for tag, (x, block) in zoo_seen[key].items()}

    t0 = time.perf_counter()
    wideband_pack()
    wideband_pulsar(torch, counts)
    with tempfile.TemporaryDirectory() as tmp:
        cli_tools(tmp)
    torch.cuda.empty_cache()
    log(f"[wideband] pack and pulsar and [cli] took "
        f"{time.perf_counter() - t0:.2f} s")

    fleet_lat, k3_launches = gw_fleet(fleet, xm2)
    gw_injected()
    sweep_lat, sweep_launches = gw_sweep()
    entries.append(pair_record(torch, fleet_lat, sweep_lat, k3_launches,
                               sweep_launches))

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        k1p_launches, lane_arrays, tip_s = stream_lanes(models, toas, tmp)
        log(f"[stream] lanes, restart, escalation and correlated phases "
            f"took {time.perf_counter() - t0:.2f} s")
    log(f"[stream] restart tips took {tip_s:.2f} s; {card}")
    scenario_rows = stream_kernel(torch)
    entries.append(delta_record(torch, lane_arrays, scenario_rows,
                                k1p_launches))
    serve = serve_phase(torch)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        k1p_restart = durable_restart(torch, serve, tmp)
        chaos = durable_chaos(torch, serve)
        log(f"[durable] restart and chaos took "
            f"{time.perf_counter() - t0:.2f} s")
    entries[-1]["launches_new_paths"] = {"serve append": serve["k1p"],
                                         "durable restart": k1p_restart}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        obs_k12 = obs_fleet(torch, fleet, models, toas, x_start, tmp)
        obs_k3 = obs_gw(torch, fleet, xm2, sweep_lat)
        obs_serve(torch, serve, tmp)
        obs_arrival(torch, serve)
        log(f"[obs] took {time.perf_counter() - t0:.2f} s")
    for k, entry in enumerate(entries[:2]):
        for tag, k12 in obs_k12.items():
            entry["launches_new_paths"][f"obs fleet {tag} traced"] = k12[k]
    entries[2]["launches_new_paths"] = {"obs gw traced sweep": obs_k3}
    del serve
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh_k12, mesh_k1p = mesh_phase(torch, models, toas)
    torch.cuda.empty_cache()
    log(f"[mesh] took {time.perf_counter() - t0:.2f} s")
    for k, entry in enumerate(entries[:2]):
        entry["launches_new_paths"]["mesh fleet lane"] = mesh_k12[
            "healthy"][k]
        entry["launches_new_paths"]["mesh fleet after a steal"] = mesh_k12[
            "steal"][k]
    entries[3]["launches_new_paths"][
        "mesh StreamingRefitter(mesh=)"] = mesh_k1p
    t0 = time.perf_counter()
    mesh_2d(torch, models, toas, x_start)
    log(f"[mesh] 2d took {time.perf_counter() - t0:.2f} s")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        kill = durable_kill(torch, tmp)
        log(f"[durable] kill took {time.perf_counter() - t0:.2f} s")

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        k4_launches, phases, weights, scan_rows, direct = photon_path(
            torch, tmp)
        log(f"[photon] event file to template fit and CLI took "
            f"{time.perf_counter() - t0:.2f} s")
        entries.append(harmonics_record(torch, phases, weights, scan_rows,
                                        k4_launches))
        log(f"[photon] phases with the kernel record took "
            f"{time.perf_counter() - t0:.2f} s in all")
        t0 = time.perf_counter()
        sat = photon_satellite(torch, tmp)
        k4_paths = {"photonphase --orbfile": sat["launches"]}
        for tag, n in photon_polycos(torch, tmp, direct, sat).items():
            k4_paths[f"photonphase --polycos {tag}"] = n
        for tag, n in photon_calc(torch, tmp).items():
            k4_paths[f"photonphase --weightcol CALC {tag}"] = n
        entries[-1]["launches_new_paths"] = k4_paths
        log(f"[photon] satellite, polycos and calc took "
            f"{time.perf_counter() - t0:.2f} s")
        profile_fftfit(torch, phases, weights)
        del phases, weights, scan_rows
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        mcmc_phase(torch, tmp, direct, sat)
        torch.cuda.empty_cache()
        log(f"[mcmc] took {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    grid_phase(torch, counts)
    log(f"[grid] took {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    regress_phase(card_round(card, main_round, lint, chaos, kill))
    log(f"[regress] took {time.perf_counter() - t0:.2f} s")
    log(json.dumps({"kernels": [add_bound_share(e) for e in entries]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def compare_designs(old_dir):
    """``--compare OLD_DIR``: the kernels of an earlier design's
    ``gram.cu``, ``paircorr.cu`` and ``harmonics.cu`` (whichever
    ``OLD_DIR`` holds, each with its earlier C interface) against the
    checkout's, on one card in turns (old, new, new, old), at the shapes
    the kernel records use, on inputs made from a seed: K1 (460800, 66)
    at Q = 256, K2 (115200, 64) at Q = 32, K1′ at 64 x 6 and 64 x 12; K3
    at the fleet's 68 x 68 x 100, a 256 x 256 x 512 sweep tile and the
    whole 3000 x 3000 x 512 product; K4 at 4,000,000 photons and m = 20,
    unweighted and weighted, and on (32, 4,000,000) scan rows. Each
    design is held to the plain f32 version first (K1-K3: 1e-5 of
    max|.|; K4: max(4e-8 n, 1e-4) absolute); the library yardstick is
    timed in the same call where there is one. Each design is timed
    twice: back to back as a caller launches it (CUDA events), and
    replayed from a CUDA graph, which leaves out the host's launch path.
    K4's record also holds the per-photon SASS counts of both designs'
    photon loops."""
    import ctypes

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from pint_tpu_torch.kernels import build, harmonics, paircorr
    from pint_tpu_torch.kernels.fusedgls import (fused_block_gls_cuda,
                                                 fused_block_gls_plain)
    from pint_tpu_torch.kernels.harmonics import (harmonic_sums_cuda,
                                                  harmonic_sums_plain)
    from pint_tpu_torch.kernels.paircorr import (pair_products_cuda,
                                                 pair_products_plain)
    from pint_tpu_torch.kernels.seggram import (block_grams_cuda,
                                                block_grams_plain)

    card = gpu_line()
    names = [n for n in ("gram", "paircorr", "harmonics")
             if os.path.exists(os.path.join(old_dir, n + ".cu"))]
    if not names:
        print(f"chip_smoke: {old_dir} holds none of gram.cu, paircorr.cu "
              "and harmonics.cu", file=sys.stderr)
        return 1
    log(f"[compare] {card}; old sources from {old_dir}: {names}")
    procs = {}
    for name in names:
        src = os.path.join(old_dir, name + ".cu")
        so = os.path.join(old_dir, f"lib{name}_old.so")
        procs[name] = (so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    build.load_all(names)
    old = {}
    for name, (so, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the old {name}.cu:\n{out}")
        old[name] = ctypes.CDLL(so)
        old[name + "_so"] = so
        for design, text in (("old", out), ("new",
                                            build.BUILD_INFO[name]["log"])):
            for line in text.splitlines():
                if ("registers" in line or "spill" in line
                        or "Compiling entry" in line):
                    log(f"[compare] {design} {name}.cu: "
                        f"{line.strip()}")

    dev = torch.device("cuda", torch.cuda.current_device())

    # the earlier design's Python wrappers as they were (checks, output
    # allocation, stream, ctypes call), so that each design is timed with
    # the host path it shipped with
    def old_gram(entry):
        fn = getattr(old["gram"], entry)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def call(x, block):
            if x.device.type != "cuda":
                raise ValueError(f"{entry}: x must be a CUDA tensor")
            if x.dtype != torch.float32:
                raise TypeError(f"{entry}: x must be float32")
            if x.ndim != 2 or not x.is_contiguous():
                raise ValueError(f"{entry}: x must be a contiguous 2-D "
                                 "tensor")
            n, k = x.shape
            if block < 1 or n % block:
                raise ValueError(f"{entry}: rows not a multiple of block")
            nb = n // block
            out = torch.empty((nb, k, k), dtype=torch.float32,
                              device=x.device)
            if nb == 0 or k == 0:
                return out
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = fn(x.data_ptr(), out.data_ptr(), nb, block, k,
                    x.device.index, stream)
            if rc:
                raise RuntimeError(f"old {entry}: CUDA error {rc}")
            return out
        return call

    def old_pair(ua, wa, ub, wb):
        fn_pair = old["paircorr"].pair_products_f32
        fn_pair.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn_pair.restype = ctypes.c_int
        check = paircorr._check
        check("ua", ua, ua.device)
        ba, m = ua.shape
        bb = ub.shape[0]
        for name, t in (("wa", wa), ("ub", ub), ("wb", wb)):
            check(name, t, ua.device, m)
        if wa.shape[0] != ba or wb.shape[0] != bb:
            raise ValueError("old pair_products: row counts differ")
        if max(ba, bb, m) > 2**31 - 1:
            raise ValueError("old pair_products: dimensions exceed int32")
        num = torch.empty((ba, bb), dtype=torch.float32, device=ua.device)
        den = torch.empty_like(num)
        if ba == 0 or bb == 0:
            return num, den
        stream = torch.cuda.current_stream(ua.device).cuda_stream
        rc = fn_pair(ua.data_ptr(), wa.data_ptr(), ub.data_ptr(),
                     wb.data_ptr(), num.data_ptr(), den.data_ptr(), ba, bb,
                     m, ua.device.index, stream)
        if rc:
            raise RuntimeError(f"old pair_products_f32: CUDA error {rc}")
        return num, den

    def old_harmonics(phases, m, weights=None):
        """PR 4's ``harmonic_sums_cuda`` host path over the old library
        (harmonic_chunk / harmonic_blocks looked up per call)."""
        lib = old["harmonics"]
        fn = lib.harmonic_sums_f32
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int,
                                                  ctypes.c_longlong]
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.harmonic_chunk.argtypes = [ctypes.c_int]
        lib.harmonic_chunk.restype = ctypes.c_int
        lib.harmonic_blocks.argtypes = [ctypes.c_longlong]
        lib.harmonic_blocks.restype = ctypes.c_int
        rows = phases.reshape(1, -1) if phases.ndim == 1 else phases
        g, n = rows.shape
        w_ptr, w_stride = None, 0
        if weights is not None:
            w_ptr, w_stride = weights.data_ptr(), (n if weights.ndim == 2
                                                   else 0)
        kc, nb = lib.harmonic_chunk(m), lib.harmonic_blocks(n)
        partial = torch.empty(g * -(-m // kc) * nb * 2 * kc,
                              dtype=torch.float32, device=phases.device)
        out = torch.empty((g, 2, m), dtype=torch.float64,
                          device=phases.device)
        stream = torch.cuda.current_stream(phases.device).cuda_stream
        rc = fn(rows.data_ptr(), w_ptr, w_stride, partial.data_ptr(),
                out.data_ptr(), g, n, m, phases.device.index, stream)
        if rc:
            raise RuntimeError(f"old harmonic_sums_f32: CUDA error {rc}")
        if phases.ndim == 1:
            out = out[0]
        return out[..., 0, :], out[..., 1, :]

    rng = np.random.default_rng(5)

    def rows(n, ka, whiten):
        a = rng.normal(size=(n, ka))
        if whiten:
            a[:, -1] = 1.0 / rng.uniform(0.5, 2.0, n)
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    def gram_case(label, entry, new, plain, x, block, whiten):
        xw = x * x[:, -1:] if whiten else x
        xb = xw.reshape(-1, block, x.shape[1])
        prev = old_gram(entry)
        return (label, lambda: new(x, block), lambda: prev(x, block),
                lambda: plain(x, block), lambda: torch.bmm(xb.mT, xb), None)

    lat = torch.as_tensor(rng.normal(size=(3000, 512)), dtype=torch.float32,
                          device=dev)
    wts = torch.as_tensor(rng.uniform(0.5, 2.0, (3000, 512)),
                          dtype=torch.float32, device=dev)
    fleet = (lat[:68, :100].contiguous(), wts[:68, :100].contiguous())
    tile_a = (lat[:256].contiguous(), wts[:256].contiguous())
    tile_b = (lat[256:512].contiguous(), wts[256:512].contiguous())

    def pair_case(label, ua, wa, ub, wb):
        ins = (ua, wa, ub, wb)
        return (label, lambda: pair_products_cuda(*ins),
                lambda: old_pair(*ins), lambda: pair_products_plain(*ins),
                lambda: (torch.matmul(ua, ub.mT), torch.matmul(wa, wb.mT)),
                None)

    cases = []
    if "gram" in names:
        cases += [
            gram_case("K1 (460800, 66) Q=256", "fused_block_gls_f32",
                      fused_block_gls_cuda, fused_block_gls_plain,
                      rows(460800, 66, True), 256, True),
            gram_case("K2 (115200, 64) Q=32", "block_grams_f32",
                      block_grams_cuda, block_grams_plain,
                      rows(115200, 64, False), 32, False),
            gram_case("K1' (64, 6)", "fused_block_gls_f32",
                      fused_block_gls_cuda, fused_block_gls_plain,
                      rows(64, 6, True), 64, True),
            gram_case("K1' (64, 12)", "fused_block_gls_f32",
                      fused_block_gls_cuda, fused_block_gls_plain,
                      rows(64, 12, True), 64, True),
        ]
    if "paircorr" in names:
        cases += [
            pair_case("K3 fleet 68x68x100", *fleet, *fleet),
            pair_case("K3 tile 256x256x512", *tile_a, *tile_b),
            pair_case("K3 whole 3000x3000x512", lat, wts, lat, wts),
        ]
    if "harmonics" in names:
        k4_ph = torch.as_tensor(rng.random(PHOTON_N), dtype=torch.float32,
                                device=dev)
        k4_w = torch.as_tensor(rng.random(PHOTON_N), dtype=torch.float32,
                               device=dev)
        k4_scan = torch.as_tensor(rng.random((PHOTON_TRIALS, PHOTON_N)),
                                  dtype=torch.float32, device=dev)

        def k4_case(label, ph, wt):
            tol = max(4e-8 * ph.shape[-1], 1e-4)
            return (label, lambda: harmonic_sums_cuda(ph, 20, wt),
                    lambda: old_harmonics(ph, 20, wt),
                    lambda: harmonic_sums_plain(ph, 20, wt), None, tol)

        cases += [k4_case(f"K4 ({PHOTON_N},) m=20", k4_ph, None),
                  k4_case(f"K4 ({PHOTON_N},) m=20 weighted", k4_ph, k4_w),
                  k4_case(f"K4 scan ({PHOTON_TRIALS}, {PHOTON_N}) m=20",
                          k4_scan, None)]
    results = []
    for label, new, prev, plain, library, abs_tol in cases:
        ref = plain()
        ref = ref if isinstance(ref, tuple) else (ref,)
        for design, fn in (("new", new), ("old", prev)):
            got = fn()
            got = got if isinstance(got, tuple) else (got,)
            torch.cuda.synchronize()
            for g, r in zip(got, ref):
                d = (g - r).abs().max().item()
                ok = (d <= abs_tol if abs_tol is not None
                      else d / r.abs().max().item() <= TOL_KERNEL)
                if not ok:
                    raise AssertionError(f"{label}: the {design} design is "
                                         f"{d:.3e} from plain f32")
        turns = [cuda_ms(torch, fn) for fn in (prev, new, new, prev)]
        device = [graph_ms(torch, fn) for fn in (prev, new, new, prev)]
        library_ms = None if library is None else cuda_ms(torch, library)
        rec = {"case": label, "old_ms": [turns[0], turns[3]],
               "new_ms": [turns[1], turns[2]], "library_ms": library_ms,
               "old_graph_ms": [device[0], device[3]],
               "new_graph_ms": [device[1], device[2]]}
        results.append(rec)
        lib_text = ("none" if library_ms is None
                    else f"{library_ms:.4f} ms")
        log(f"[compare] {label}: old {turns[0]:.4f} / {turns[3]:.4f} ms, "
            f"new {turns[1]:.4f} / {turns[2]:.4f} ms, library "
            f"{lib_text}; replayed from a CUDA graph: old "
            f"{device[0]:.4f} / {device[3]:.4f} ms, new {device[1]:.4f} / "
            f"{device[2]:.4f} ms")
    if "harmonics" in names:
        sass = {
            "old": sass_loop_counts(old["harmonics_so"],
                                    "harmonic_partials_kernelILi24E", 1),
            "new": sass_loop_counts(build._library_path("harmonics")[1],
                                    "harmonic_partials_kernelILi20ELb0E",
                                    harmonics.PHOTONS)}
        log(f"[compare] K4 m = 20 unweighted, SASS of the photon loop per "
            f"photon: old {sass['old']}; new {sass['new']}")
        results.append({"case": "K4 SASS per photon, m = 20 unweighted",
                        **sass})
    log(json.dumps({"compare": results}))
    log(card)
    return 0


def main():
    if sys.argv[1:2] == ["--compare"] and len(sys.argv) == 3:
        return compare_designs(sys.argv[2])
    try:
        return run()
    except Exception as exc:  # noqa: BLE001 - the smoke test's boundary
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(exc).__name__}: {exc}",
              file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
