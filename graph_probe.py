"""What a CUDA graph can capture of the fit programs, and which segment
sums repeat bitwise, on the card.

Prints, beside the card's name and power limit:

- the synchronizing calls of ``torch.linalg.eigh`` on a (100, 64, 64)
  f64 batch and of ``torch.linalg.svd`` (gesvdj) on (8, 3000, 7), under
  ``torch.cuda.set_sync_debug_mode("warn")``;
- how often ``index_add_`` and ``index_put_(accumulate=True)`` of a
  460,800 x 90 f64 array into 100 sorted segments repeat the first
  result bitwise (5 repeats each), and their CUDA-event times, also at
  1,800 x 90 (the Q-block partial sums of the main path's packed
  bucket);
- last, whether ``torch.linalg.eigh`` can be captured in a CUDA graph.
  A failed capture poisons the process's CUDA context, so nothing runs
  after it.

    python3 graph_probe.py      # needs a CUDA card; ~15 s on an H100
"""

import warnings

import torch

import chip_smoke as cs


def sync_calls(fn):
    with warnings.catch_warnings(record=True) as wl:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # the mode's own first warning is a notice, not a synchronizing call
    return sum("called a synchronizing" in str(w.message) for w in wl)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("graph_probe: no CUDA card")
    print(cs.gpu_line(), flush=True)
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    A = torch.randn(100, 64, 64, dtype=torch.float64, device=dev,
                    generator=g)
    A = A @ A.mT + torch.eye(64, dtype=torch.float64, device=dev)
    M = torch.randn(8, 3000, 7, dtype=torch.float64, device=dev,
                    generator=g)
    torch.linalg.eigh(A)
    torch.linalg.svd(M, full_matrices=False, driver="gesvdj")
    print(f"eigh (100, 64, 64): {sync_calls(lambda: torch.linalg.eigh(A))} "
          f"synchronizing calls; svd gesvdj (8, 3000, 7): "
          f"{sync_calls(lambda: torch.linalg.svd(M, full_matrices=False, driver='gesvdj'))}",
          flush=True)
    for n in (460_800, 1_800):
        x = torch.randn(n, 90, dtype=torch.float64, device=dev, generator=g)
        seg = torch.sort(torch.randint(0, 100, (n,), device=dev,
                                       generator=g)).values

        def add():
            return torch.zeros(100, 90, dtype=torch.float64,
                               device=dev).index_add_(0, seg, x)

        def put():
            return torch.zeros(100, 90, dtype=torch.float64,
                               device=dev).index_put_((seg,), x,
                                                      accumulate=True)

        for name, fn in (("index_add_", add),
                         ("index_put_(accumulate=True)", put)):
            first = fn()
            same = sum(torch.equal(first, fn()) for _ in range(5))
            print(f"{n} x 90 f64 -> 100 segments, {name}: {same} of 5 "
                  f"repeats bitwise, {cs.cuda_ms(torch, fn):.4f} ms",
                  flush=True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph, errors = torch.cuda.CUDAGraph(), []
    try:
        with torch.cuda.graph(graph, stream=side):
            try:
                torch.linalg.eigh(A)
            except Exception as exc:  # noqa: BLE001 - the finding
                errors.append(exc)
                raise
    except Exception as exc:  # noqa: BLE001 - ending the capture
        errors.append(exc)
    print("eigh (100, 64, 64) under capture: " + (
        f"{type(errors[0]).__name__}: {str(errors[0]).splitlines()[0][:160]}"
        if errors else "captured"), flush=True)


if __name__ == "__main__":
    main()
