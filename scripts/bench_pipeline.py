"""Repeated factorize + solve pipeline benchmark (PDE time-stepping loop).

Simulates the time-stepping production workload the reference's
akeep-reuse API exists for (doc/source/subroutines.rst:37-75): one
analyse, then every iteration re-assembles new values with the SAME
pattern, refactorizes, and solves nrhs right-hand sides.  Steady-state
ms/iteration is the metric — plans, executors, and compiled programs are
all cached on the symbolic object (api._plans / the executor caches), so
an iteration is assembly + device factorization + solve only.

    python scripts/bench_pipeline.py [--m 32] [--nrhs 64] [--iters 5]
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
    ap.add_argument("--nemin", type=int, default=192)
    ap.add_argument("--nrhs", type=int, default=64)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--refine", type=int, default=2)
    args = ap.parse_args(argv)

    from spllt_tpu import CscMatrix, Options, analyse, factor, make_rhs, \
        poisson3d, solve
    from spllt_tpu.utils.jaxconfig import enable_compilation_cache

    enable_compilation_cache()
    m = args.m
    a = poisson3d(m)
    opts = Options(ordering="nd-grid", grid_shape=(m,) * 3, nb=args.nb,
                   nemin=args.nemin, dtype="float32", refine=args.refine,
                   prune_tree=False)
    t0 = time.perf_counter()
    symb = analyse(a, opts)
    t_an = time.perf_counter() - t0

    xt, b = make_rhs(a, args.nrhs)
    # warm: compile factor + solve programs once
    t0 = time.perf_counter()
    num = factor(symb)
    x = solve(num, b)
    t_warm = time.perf_counter() - t0

    # steady state: new values each iteration (same pattern)
    t0 = time.perf_counter()
    bwd = 0.0
    for it in range(args.iters):
        vals = a.values * (1.0 + 0.1 * (it + 1))
        a2 = CscMatrix(a.n, a.colptr, a.rowind, vals)
        num = factor(symb, a=a2)
        x = solve(num, b)
        bwd = float(np.linalg.norm(a2.matvec(x) - b)
                    / np.linalg.norm(b))
    t_iter = (time.perf_counter() - t0) / args.iters

    print(json.dumps({
        "metric": "pipeline", "m": m, "nrhs": args.nrhs,
        "analyse_s": round(t_an, 2),
        "first_iter_s": round(t_warm, 2),
        "steady_ms_per_iter": round(t_iter * 1e3, 1),
        "bwd_err": bwd,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
