"""Batched block-kernel benchmarks on the GPU, and the potrf choice.

Analogue of the reference's ``bench_kernels/`` (dpotrf/dtrsm/dsyrk/dgemm
GFLOP/s vs MKL/MAGMA/cuSOLVER, N-sweep -> CSV,
/root/reference/bench_kernels/bench_potrf/bench_MKL_potrf.cu:153-227).

1. Kernels: batched potrf (panel-blocked ``_potrf_batch_blocked`` and the
   direct ``_potrf_batch``), trsm and gemm-NT at tile size nb in {128,
   256} and at the batch widths the Poisson 3-D ``--m``^3 plan produces.
2. End to end (``--e2e``): steady public ``factor()`` time with each
   potrf variant, and the factor time with the between-node update
   (updbt) dropped, whose difference estimates the update's share.
3. ``--trace DIR``: one steady factor under ``jax.profiler``, device
   time summed per named scope (updbt / syrk / potrf / trsm).

Times are host wall clock around ``block_until_ready`` (per call, mean
of ``--reps`` back-to-back calls).  One JSON line per row on stdout.

    python bench_kernels/bench_kernels.py [--m 64] [--e2e] [--trace DIR]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

SCOPES = ("updbt", "syrk", "potrf", "trsm")


def time_call(fn, args, reps: int) -> float:
    """Seconds per call: ``reps`` back-to-back calls, then one wait."""
    fn(*args).block_until_ready()            # compile + first run
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    out.block_until_ready()
    return (time.perf_counter() - t0) / reps


def plan_widths(symb, nb: int) -> dict:
    """Distinct per-level task counts (batch widths) of each kind in the
    bucketed factor plan at tile size nb."""
    import dataclasses

    from spllt_tpu.api import _plans
    from spllt_tpu.plan.buckets import make_buckets

    _, fp, _ = _plans(symb, dataclasses.replace(symb.options, nb=nb))
    out = {}
    for kind in ("potrf", "trsm"):
        ptr = getattr(fp, f"{kind}_ptr")
        counts = np.diff(ptr)[:fp.nlevels + 1]
        spans = make_buckets({kind: counts}, fp.nlevels)
        out[kind] = sorted({int(counts[s:e + 1].max())
                            for s, e, _ in spans if counts[s:e + 1].max()})
    return out


def bench_kernels(symb, nbs, reps: int, emit) -> None:
    import jax
    import jax.numpy as jnp

    from spllt_tpu.numeric.factor import (_potrf_batch,
                                          _potrf_batch_blocked, _trsm_batch)

    rng = np.random.default_rng(0)
    for nb in nbs:
        widths = plan_widths(symb, nb)
        emit({"row": "plan_widths", "nb": nb, **widths})
        for B in widths["potrf"]:
            g = rng.standard_normal((B, nb, nb)).astype(np.float32)
            spd = jnp.asarray(g @ g.transpose(0, 2, 1) / nb
                              + np.eye(nb, dtype=np.float32))
            k = jnp.full((B,), nb, jnp.int32)
            fl = B * nb ** 3 / 3
            for name, f in (
                    ("potrf_direct", lambda x, kk, nb=nb:
                     _potrf_batch(x, kk, nb)),
                    ("potrf_blocked", lambda x, kk, nb=nb:
                     _potrf_batch_blocked(x, kk, nb))):
                t = time_call(jax.jit(f), (spd, k), reps)
                emit({"row": name, "nb": nb, "batch": B, "ms": t * 1e3,
                      "gflops": fl / t / 1e9})
        for B in widths["trsm"]:
            g = rng.standard_normal((B, nb, nb)).astype(np.float32)
            spd = g @ g.transpose(0, 2, 1) / nb + np.eye(nb)
            chol = jnp.asarray(np.linalg.cholesky(spd).astype(np.float32))
            b = jnp.asarray(g)
            k = jnp.full((B,), nb, jnp.int32)
            t = time_call(jax.jit(lambda d, x, kk, nb=nb:
                                  _trsm_batch(d, x, kk, nb)),
                          (chol, b, k), reps)
            emit({"row": "trsm", "nb": nb, "batch": B, "ms": t * 1e3,
                  "gflops": B * nb ** 3 / t / 1e9})
            t = time_call(jax.jit(lambda x, y: jax.lax.dot_general(
                x, y, (((2,), (2,)), ((0,), (0,))), precision="highest",
                preferred_element_type=x.dtype)), (b, b), reps)
            emit({"row": "gemm_nt", "nb": nb, "batch": B, "ms": t * 1e3,
                  "gflops": 2 * B * nb ** 3 / t / 1e9})


def steady_factor(a, opts, reps: int, skip=(), potrf=None,
                  chunk_bytes=None):
    """(first, median steady) seconds of one factorization as the public
    factor() runs it (device assembly, then the scan executor, then a
    wait); ``skip`` drops factor phases (timing attribution only: wrong
    results), ``potrf`` replaces the executor's batched potrf and
    ``chunk_bytes`` the updbt gather budget."""
    import jax.numpy as jnp

    import spllt_tpu.numeric.factor as fc
    import spllt_tpu.numeric.factor_scan as fs
    from spllt_tpu import analyse
    from spllt_tpu.api import _plans
    from spllt_tpu.numeric.assemble import assemble_jax

    symb = analyse(a, opts)
    plan, fplan, _ = _plans(symb, opts)
    ex = fs.ScanFactorExecutor(fplan, dtype=jnp.float32,
                               matmul_precision=opts.precision,
                               _skip=frozenset(skip))
    values = symb.a_perm.values

    def run():
        pool, notpos = ex(assemble_jax(plan, values, jnp.float32))
        pool.block_until_ready()

    saved = fs._potrf_batch_blocked, fc.UPDBT_CHUNK_BYTES
    if potrf is not None:
        fs._potrf_batch_blocked = potrf      # in effect while tracing
    if chunk_bytes is not None:
        fc.UPDBT_CHUNK_BYTES = chunk_bytes
    try:
        t0 = time.perf_counter()
        run()
        first = time.perf_counter() - t0
    finally:
        fs._potrf_batch_blocked, fc.UPDBT_CHUNK_BYTES = saved
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        ts.append(time.perf_counter() - t0)
    return first, float(np.median(ts)), symb


def scope_times(trace_dir: str) -> dict:
    """Device nanoseconds per named scope, summed over the kernel events
    of the GPU planes' compute streams in the newest trace under
    ``trace_dir``, plus the busy time (sum of kernel durations) and the
    window from first kernel start to last kernel end.  Writes the line
    names and the kernels with the most device time beside the trace."""
    import jax

    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    pd = jax.profiler.ProfileData.from_file(path)
    out = {s: 0 for s in SCOPES}
    out["busy"] = 0
    lines_seen, by_op = [], {}
    t_lo, t_hi = None, None
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            lines_seen.append(f"{plane.name}|{line.name}")
            if "Compute" not in line.name:
                continue
            for ev in line.events:
                st = dict(ev.stats)
                key = f"{ev.name} | {st.get('name', '')}"[:300]
                by_op[key] = by_op.get(key, 0) + ev.duration_ns
                out["busy"] += ev.duration_ns
                t_lo = ev.start_ns if t_lo is None else min(t_lo, ev.start_ns)
                t_hi = ev.end_ns if t_hi is None else max(t_hi, ev.end_ns)
                text = key
                for s in SCOPES:
                    if f"/{s}/" in text:
                        out[s] += ev.duration_ns
                        break
    # XLA names no fusion in the trace: unattributed time is mostly the
    # updbt gathers, GEMMs and scatter-adds
    out["unattributed"] = out["busy"] - sum(out[s] for s in SCOPES)
    out["window"] = (t_hi - t_lo) if t_lo is not None else 0
    with open(os.path.join(trace_dir, "events_sample.txt"), "w") as f:
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:60]
        f.write("\n".join(lines_seen + ["--"]
                          + [f"{v / 1e6:10.3f} ms  {k}" for k, v in top])
                + "\n")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=64)
    ap.add_argument("--nemin", type=int, default=192)
    ap.add_argument("--nbs", default="128,256")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--e2e", action="store_true")
    ap.add_argument("--trace", default=None, metavar="DIR")
    ap.add_argument("--no-kernels", action="store_true")
    args = ap.parse_args(argv)

    import dataclasses

    import jax

    from spllt_tpu import Options, analyse, poisson3d
    from spllt_tpu.numeric.factor import _potrf_batch
    from spllt_tpu.utils.jaxconfig import (device_platform,
                                           enable_compilation_cache)

    dev = jax.devices()[0]
    if device_platform(dev) != "gpu":
        sys.exit(f"bench_kernels: no GPU visible to JAX ({dev.platform})")
    enable_compilation_cache()
    jax.config.update("jax_enable_x64", True)

    def emit(rec):
        print(json.dumps({"device": dev.device_kind, **rec}), flush=True)

    m = args.m
    a = poisson3d(m)
    opts = Options(ordering="nd-grid", grid_shape=(m,) * 3, nb=128,
                   nemin=args.nemin, dtype="float32", precision="highest",
                   refine=2, prune_tree=False)
    nbs = [int(x) for x in args.nbs.split(",")]
    if not args.no_kernels:
        bench_kernels(analyse(a, opts), nbs, args.reps, emit)
    if args.e2e:
        for nb in nbs:
            o = dataclasses.replace(opts, nb=nb)
            direct = (lambda t, k, sp, precision:
                      _potrf_batch(t, k, sp))
            variants = [("blocked", None, (), None),
                        ("no_updbt", None, ("updbt",), None)]
            if nb > 128:
                variants.insert(1, ("direct", direct, (), None))
            else:
                variants.insert(1, ("unchunked", None, (), 1 << 62))
            for name, potrf, skip, cb in variants:
                first, t, symb = steady_factor(a, o, 5, skip=skip,
                                               potrf=potrf, chunk_bytes=cb)
                emit({"row": f"factor_{name}", "m": m, "nb": nb,
                      "first_s": first, "steady_ms": t * 1e3,
                      "gflops": symb.inform.num_flops / t / 1e9})
    if args.trace:
        from spllt_tpu import factor

        symb = analyse(a, opts)
        factor(symb)
        jax.profiler.start_trace(args.trace)
        factor(symb)
        jax.profiler.stop_trace()
        emit({"row": "trace_scopes", "m": m, "nb": opts.nb,
              **scope_times(args.trace)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
