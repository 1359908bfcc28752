"""Factor-phase time split via phase skipping.

Times the scan executor with each phase (updbt / syrk / potrf / trsm)
dropped in turn; the delta against the full run attributes wall time per
phase.  Each rep ends in ``block_until_ready``.

    python scripts/profile_factor.py [--m 32] [--nb 128] [--nemin 128]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=32)
    ap.add_argument("--nb", type=int, default=128)
    ap.add_argument("--nemin", type=int, default=128)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--precision", default="highest")
    ap.add_argument("--full-only", action="store_true")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from spllt_tpu import Options, analyse, poisson3d
    from spllt_tpu.api import _plans
    from spllt_tpu.numeric.assemble import assemble_jax
    from spllt_tpu.numeric.factor_scan import ScanFactorExecutor
    from spllt_tpu.utils.jaxconfig import enable_compilation_cache

    enable_compilation_cache()
    m = args.m
    a = poisson3d(m)
    opts = Options(ordering="nd-grid", grid_shape=(m,) * 3, nb=args.nb,
                   nemin=args.nemin, mode="batched", dtype="float32",
                   refine=2, precision=args.precision, prune_tree=False)
    symb = analyse(a, opts)
    plan, fplan, _ = _plans(symb, opts)
    dev = jax.devices()[0]
    print(f"# {dev.platform} {dev.device_kind} x{len(jax.devices())} "
          f"n={symb.n} nnzL={symb.inform.num_factor} "
          f"flops={symb.inform.num_flops:.3e} levels={fplan.nlevels} "
          f"tasks={fplan.num_tasks}", file=sys.stderr)
    values = jnp.asarray(symb.a_perm.values)

    def timed(skip):
        ex = ScanFactorExecutor(fplan, dtype=jnp.float32,
                                matmul_precision=args.precision,
                                _skip=frozenset(skip))

        @jax.jit
        def step(v):
            return ex._fn(assemble_jax(plan, v, jnp.float32), ex.maps,
                          ex.blk_n, ex.srcvec, ex._bucket_tables)[0]

        step(values).block_until_ready()   # compile + first exec
        t0 = time.perf_counter()
        for _ in range(args.reps):
            step(values).block_until_ready()
        return (time.perf_counter() - t0) / args.reps

    t_full = timed(())
    print(f"full: {t_full*1e3:8.1f} ms "
          f"({symb.inform.num_flops/t_full/1e9:.1f} GFLOP/s)")
    if args.full_only:
        return 0
    for ph in ("updbt", "syrk", "potrf", "trsm"):
        t = timed((ph,))
        print(f"w/o {ph:7s}: {t*1e3:8.1f} ms   -> {ph} ~ "
              f"{(t_full-t)*1e3:7.1f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
