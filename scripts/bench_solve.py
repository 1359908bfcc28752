"""Solve-phase bandwidth benchmark (GB/s, nrhs sweep).

Solve GB/s at nrhs=1 and nrhs=64.  A forward+backward
solve streams every factor block once in each direction; the effective
bandwidth is (2 · pool_bytes + rhs traffic) / time — the solve is
memory-bound, so GB/s against the HBM roofline is the right lens (the
reference measures repeated fwd/bwd solve wall-time,
drivers/spllt_omp_bench.F90:159-443).

    python scripts/bench_solve.py [--m 32] [--nb 128] [--nrhs 1,4,16,64]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=32)
    ap.add_argument("--nb", type=int, default=128)
    ap.add_argument("--nemin", type=int, default=64)
    ap.add_argument("--nrhs", default="1,4,16,64")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from spllt_tpu import Options, analyse, factor, make_rhs, poisson3d
    from spllt_tpu.numeric.solve_scan import ScanSolveExecutor
    from spllt_tpu.utils.jaxconfig import enable_compilation_cache

    enable_compilation_cache()
    m = args.m
    a = poisson3d(m)
    opts = Options(ordering="nd-grid", grid_shape=(m,) * 3, nb=args.nb,
                   nemin=args.nemin, dtype="float32", refine=0,
                   prune_tree=False)
    symb = analyse(a, opts)
    num = factor(symb)
    pool = num.pool
    pool_bytes = int(np.prod(pool.shape)) * 4
    dev = jax.devices()[0]
    print(f"# {dev.platform} {dev.device_kind} x{len(jax.devices())} "
          f"n={symb.n} nnzL={symb.inform.num_factor} "
          f"pool={pool_bytes/1e6:.0f} MB", file=sys.stderr)

    for nrhs in (int(x) for x in args.nrhs.split(",")):
        ex = ScanSolveExecutor(num.splan, nrhs, dtype=jnp.float32)
        xt, b = make_rhs(a, nrhs)
        x0 = np.zeros((symb.n + 1, nrhs), dtype=np.float32)
        x0[:symb.n] = b[symb.perm]
        ex.full(pool, jnp.asarray(x0)).block_until_ready()   # compile
        xd = jnp.asarray(x0)
        t0 = time.perf_counter()
        for _ in range(args.reps):
            xd = ex.full(pool, xd)
        xd.block_until_ready()
        t = (time.perf_counter() - t0) / args.reps
        y = ex.full(pool, jnp.asarray(x0))
        rhs_bytes = 2 * symb.n * nrhs * 4
        gbs = (2 * pool_bytes + rhs_bytes) / t / 1e9
        # correctness
        xs = np.asarray(y)[:symb.n].astype(np.float64)
        x = np.empty_like(xs)
        x[symb.perm] = xs
        bwd = float(np.linalg.norm(a.matvec(x) - b)
                    / np.linalg.norm(b))
        print(json.dumps({
            "metric": "solve_bandwidth", "nrhs": nrhs,
            "t_solve_ms": round(t * 1e3, 3),
            "value": round(gbs, 1), "unit": "GB/s",
            "bwd_err_f32": bwd,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
