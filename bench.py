"""Factorization benchmark: supernodal sparse Cholesky GFLOP/s on the GPU.

3-D Poisson 7-point grid, nested-dissection ordering, blocked supernodal
factorization on one GPU, float32 pool (+ f64-refined solve check).
Prints ONE JSON line: {"metric", "value", "unit"}; device and timings go
to stderr.  Exits non-zero when JAX finds no GPU or the refined solve
misses bwd_err <= 1e-10.

Timing excludes compilation (the first factor() compiles, the next ones
are timed; each ends in ``block_until_ready``) — the analyse/plan/compile
products are reusable across refactorizations of the same pattern,
matching the reference's akeep-reuse workflow.

    python bench.py          # BENCH_M / BENCH_NB / BENCH_NEMIN / BENCH_REPS
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

M = int(os.environ.get("BENCH_M", "32"))
NB = int(os.environ.get("BENCH_NB", "128"))
NEMIN = int(os.environ.get("BENCH_NEMIN", "192"))
PRECISION = os.environ.get("BENCH_PRECISION", "highest")
REPS = int(os.environ.get("BENCH_REPS", "10"))
# refinement steps: 2 for f32-highest, 6 for the reduced-precision points
REFINE = int(os.environ.get(
    "BENCH_REFINE", "2" if PRECISION == "highest" else "6"))


def main() -> int:
    import jax

    from spllt_tpu import Options, analyse, factor, make_rhs, poisson3d, solve
    from spllt_tpu.utils.jaxconfig import (device_platform,
                                           enable_compilation_cache)

    dev = jax.devices()[0]
    if device_platform(dev) != "gpu":
        print(f"bench.py: no GPU visible to JAX (platform "
              f"{dev.platform!r})", file=sys.stderr)
        return 1
    print(f"# device: {dev.platform} {dev.device_kind} "
          f"x{len(jax.devices())}", file=sys.stderr)
    enable_compilation_cache()
    a = poisson3d(M)
    opts = Options(ordering="nd-grid", grid_shape=(M, M, M), nb=NB,
                   nemin=NEMIN, mode="batched", dtype="float32",
                   refine=REFINE, precision=PRECISION, prune_tree=False)
    t0 = time.perf_counter()
    symb = analyse(a, opts)
    t_an = time.perf_counter() - t0
    print(f"# analyse: n={symb.n} nnzL={symb.inform.num_factor} "
          f"flops={symb.inform.num_flops:.3e} time={t_an:.2f}s",
          file=sys.stderr)

    t0 = time.perf_counter()
    num = factor(symb)
    print(f"# first factor (compile+exec): {time.perf_counter()-t0:.1f}s",
          file=sys.stderr)
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        num = factor(symb)
        times.append(time.perf_counter() - t0)
    t_fact = float(np.median(times))
    gflops = symb.inform.num_flops / t_fact / 1e9

    xt, b = make_rhs(a, nrhs=1)
    x = solve(num, b[:, 0])
    bwd = float(np.linalg.norm(a.matvec(x) - b[:, 0])
                / np.linalg.norm(b[:, 0]))
    print(f"# factor {t_fact*1e3:.2f} ms (median of {REPS})  "
          f"{gflops:.1f} GFLOP/s  bwd_err {bwd:.2e}", file=sys.stderr)
    print(json.dumps({"metric": "factorization_gflops",
                      "value": round(gflops, 2), "unit": "GFLOP/s"}))
    return 0 if bwd <= 1e-10 else 1


if __name__ == "__main__":
    sys.exit(main())
