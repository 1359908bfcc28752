"""Matrix-suite benchmark.

The reference sweeps 37 SuiteSparse SPD matrices through analyse /
factorize / solve (aux/list.matrix, run_tests.sh:41-96).  This
environment has no network access, so the suite is built from generated
matrices in the same structural classes as the reference's list
(3-D scalar PDE grids ~ thermal*, 3-D vector FEM ~ bcsstk/pwtk-class
structural problems, 2-D plates ~ s3dkq4m2-class shells), written to and
re-read from MatrixMarket/Rutherford-Boeing files so the full reader
path is exercised at realistic sizes.

Per matrix: analyse seconds (host), nnz(L), predicted flops, factor ms
(public factor(), which waits for the device), fwd+bwd solve ms at
nrhs=1, refined backward
error.  One JSON line per matrix.

    python scripts/bench_matrices.py [--nb 128] [--set quick|full]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def suite(which: str):
    from spllt_tpu import poisson2d, poisson3d
    from spllt_tpu.sparse.generators import fem3d

    if which == "tiny":          # plumbing validation (CPU-runnable)
        return [
            ("poisson2d-24", lambda: poisson2d(24), "amd", None),
            ("fem3d-6", lambda: fem3d(6, dofs=1, seed=1), "amd", None),
        ]
    mats = [
        # (name, builder, ordering, grid_shape)
        ("poisson3d-32", lambda: poisson3d(32), "nd-grid", (32,) * 3),
        ("poisson2d-180", lambda: poisson2d(180), "amd", None),
        ("fem3d-16-dof3", lambda: fem3d(16, dofs=3, seed=1), "amd", None),
        ("fem3d-24", lambda: fem3d(24, dofs=1, seed=2), "amd", None),
        ("poisson3d-24-amd", lambda: poisson3d(24), "amd", None),
    ]
    if which == "full":
        mats += [
            ("poisson3d-48", lambda: poisson3d(48), "nd-grid", (48,) * 3),
            ("fem3d-20-dof3", lambda: fem3d(20, dofs=3, seed=3), "amd",
             None),
            ("poisson2d-360", lambda: poisson2d(360), "amd", None),
        ]
    return mats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nb", type=int, default=128)
    ap.add_argument("--nemin", type=int, default=192)
    ap.add_argument("--set", default="quick",
                    choices=["tiny", "quick", "full"])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--io", default="mm", choices=["mm", "rb", "none"],
                    help="round-trip each matrix through this file "
                         "format before benchmarking")
    args = ap.parse_args(argv)

    from spllt_tpu import Options, analyse, factor, make_rhs, solve
    from spllt_tpu.sparse.io import (read_matrix_market,
                                     read_rutherford_boeing,
                                     write_matrix_market,
                                     write_rutherford_boeing)
    from spllt_tpu.utils.jaxconfig import enable_compilation_cache

    enable_compilation_cache()

    for name, build, ordering, grid in suite(args.set):
        a = build()
        if args.io != "none":
            with tempfile.TemporaryDirectory() as td:
                if args.io == "mm":
                    p = os.path.join(td, "m.mtx")
                    t0 = time.perf_counter()
                    write_matrix_market(p, a)
                    a = read_matrix_market(p, force_posdef=False)
                else:
                    p = os.path.join(td, "m.rb")
                    t0 = time.perf_counter()
                    write_rutherford_boeing(p, a)
                    a = read_rutherford_boeing(p)
                io_s = time.perf_counter() - t0
        else:
            io_s = 0.0

        opts = Options(ordering=ordering, grid_shape=grid, nb=args.nb,
                       nemin=args.nemin, dtype="float32", refine=2,
                       prune_tree=False)
        t0 = time.perf_counter()
        symb = analyse(a, opts)
        t_an = time.perf_counter() - t0

        num = factor(symb)            # compile + warm
        t0 = time.perf_counter()
        for _ in range(args.reps):
            num = factor(symb)
        t_fac = (time.perf_counter() - t0) / args.reps

        xt, b = make_rhs(a, 1)
        x = solve(num, b)              # compile + warm
        t0 = time.perf_counter()
        for _ in range(args.reps):
            x = solve(num, b)
        t_sol = (time.perf_counter() - t0) / args.reps
        bwd = float(np.linalg.norm(a.matvec(x) - b)
                    / np.linalg.norm(b))

        print(json.dumps({
            "matrix": name, "n": symb.n, "nnz": a.nnz,
            "nnz_L": int(symb.inform.num_factor),
            "flops": float(symb.inform.num_flops),
            "io_s": round(io_s, 2),
            "analyse_s": round(t_an, 2),
            "factor_ms": round(t_fac * 1e3, 1),
            "solve_ms": round(t_sol * 1e3, 1),
            "gflops": round(symb.inform.num_flops / t_fac / 1e9, 1),
            "bwd_err": bwd,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
