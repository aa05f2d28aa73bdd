"""Where a fresh process's first capture of a fit program goes, on the
card: the program of ``pint_serve_bench.run_kill_chaos``'s fixture (4
lanes of the 8,192-TOA red-noise pulsar, GLS, 40 iterations), which a
restarted serving process re-captures from its persisted tier before
its first result.

Prints, beside the card's name and power limit, one JSON object with
the walls of: ``import torch``, importing the port, the CUDA context,
the fixture fleet (``build_serve_fleet(sizes=(8192,), per_combo=1)``),
the first lane-padded batch, a first ``eigh`` and a first ``vmap``, the first
capture (``aot_compile``) and its pieces, a replay, a second batch and
its capture in the same process, a warm flush (a third batch through
the first table) and an eager fit.

    python3 capture_probe.py      # needs a CUDA card; ~30 s on an H100
"""

import json
import time

T0 = time.perf_counter()

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def timed(fn):
    """(fn()'s result, its wall in s with the card synchronized)."""
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def main():
    t_import = time.perf_counter() - T0
    if not torch.cuda.is_available():
        raise SystemExit("capture_probe: needs a CUDA card")
    t = time.perf_counter()
    from pint_tpu_torch.parallel import PTABatch
    from pint_tpu_torch.scripts.pint_serve_bench import build_serve_fleet
    t_pkg = time.perf_counter() - t

    _, t_init = timed(lambda: torch.zeros(1, device="cuda"))
    (models, toas), t_fleet = timed(lambda: build_serve_fleet(
        sizes=(8192,), per_combo=1, seed=0, device="cuda"))
    model, tim = models[2], toas[2]  # the red-noise structure

    def batch():
        return PTABatch([model] * 4, [tim] * 4, pad_toas=8192,
                        device="cuda")

    first, t_pack1 = timed(batch)
    a = torch.randn(4, 30, 30, device="cuda", dtype=torch.float64)
    _, t_eigh = timed(lambda: torch.linalg.eigh(a @ a.mT))
    _, t_vmap = timed(lambda: torch.func.vmap(lambda x: x * 2)(a))
    info, t_cap1 = timed(lambda: first.aot_compile("gls", maxiter=40))
    _, t_replay = timed(lambda: first.gls_fit(maxiter=40))
    second, t_pack2 = timed(batch)
    _, t_cap2 = timed(lambda: second.aot_compile("gls", maxiter=40))

    def warm():
        b = batch()
        b._fns = first._fns
        return b.gls_fit(maxiter=40)

    _, t_warm = timed(warm)
    _, t_eager = timed(lambda: batch().gls_fit(maxiter=40))
    print(cs.gpu_line())
    print(json.dumps({
        "import_torch_s": t_import, "import_port_s": t_pkg,
        "cuda_init_s": t_init,
        "fixture_fleet_s": t_fleet, "first_batch_s": t_pack1,
        "first_eigh_s": t_eigh, "first_vmap_s": t_vmap,
        "first_capture_s": t_cap1, "pieces": len(info["pieces"]),
        "replay_s": t_replay, "second_batch_s": t_pack2,
        "second_capture_s": t_cap2, "warm_flush_s": t_warm,
        "eager_fit_s": t_eager, "total_s": time.perf_counter() - T0}))


if __name__ == "__main__":
    main()
