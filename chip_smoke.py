"""On-card smoke test: analyse -> factor -> solve on one NVIDIA GPU.

Drives the public ``spllt_tpu`` API at a size users run and checks every
result against an independent reference.  Phases, in order:

0. environment: JAX sees a GPU (never falls back to the CPU); card name
   and power limit from ``nvidia-smi``; native analyse library built;
1. kernels at real widths (batched potrf / trsm at nb = 128 and 256)
   against float64 NumPy/SciPy, the precision modes of the matrix unit,
   and the scan-factor pool of a small matrix against the STF oracle;
2. first compile, short: Poisson 3-D 32^3, f32 + refine=2;
3. main path: Poisson 3-D ``--m``^3 (default 64^3): analyse, factor
   twice, refined solve at nrhs = 1 and 16;
4. float64 on the card: Poisson 3-D 32^3, refine=0.

``--four`` runs only the four-card path (``Options(ndevices=4)``) and its
comparison with a single-card solve of the same system.

    python chip_smoke.py [--m 64] [--seed 0]
    python chip_smoke.py --four

Every phase that fails raises, so the script exits non-zero; the last
line of stdout is one JSON object, printed only when all phases passed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

# tolerances (relative): f32 rounding times a tile-sized growth factor for
# the kernels; float64-level backward error for the refined solves
KERNEL_TOL = 1e-5
REFINED_TOL = 1e-12
F64_TOL = 1e-13
FOUR_DIFF_TOL = 1e-10

# the options of the main path (phases 2-3 and --four)
MAIN_OPTS = dict(ordering="nd-grid", nb=128, nemin=192, dtype="float32",
                 precision="highest", refine=2, prune_tree=False)

CARD = "?"          # "name, power limit" tag printed beside every number


def log(msg: str) -> None:
    print(f"[{CARD}] {msg}", flush=True)


def card_info() -> str:
    """``name, power.limit`` of the card(s), from nvidia-smi run as a
    child process that does not import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def require_gpu():
    """The JAX devices; exits non-zero when the first is not a GPU."""
    import jax

    from spllt_tpu.utils.jaxconfig import device_platform

    devs = jax.devices()
    if device_platform(devs[0]) != "gpu":
        sys.exit(f"chip_smoke: no GPU visible to JAX (platform "
                 f"{devs[0].platform!r}); this script needs an NVIDIA GPU")
    return devs


def rel(x, ref) -> float:
    return float(np.linalg.norm(np.asarray(x, np.float64) - ref)
                 / np.linalg.norm(ref))


def bwd_err(a, x, b) -> float:
    """max over columns of ||A x - b|| / ||b|| (float64, host)."""
    r = a.matvec(x) - b
    return float(np.max(np.linalg.norm(r, axis=0)
                        / np.linalg.norm(b, axis=0)))


def check(name: str, value: float, tol: float) -> None:
    ok = value <= tol
    log(f"{name} = {value:.3e} (limit {tol:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} = {value:.3e} exceeds {tol:.0e}")


def rhs(a, nrhs: int, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((a.n, nrhs))
    return x, a.matvec(x)


# ------------------------------------------------------------------------ #
def phase_environment() -> None:
    global CARD
    import jax

    from spllt_tpu.analyse.native import native_available
    from spllt_tpu.utils.jaxconfig import enable_compilation_cache

    devs = require_gpu()
    CARD = card_info().splitlines()[0]
    print(CARD, flush=True)
    jax.config.update("jax_enable_x64", True)
    enable_compilation_cache()
    if not native_available():
        raise RuntimeError("native/libspllt_symbolic.so did not build")
    log(f"phase 0: {devs[0].platform} {devs[0].device_kind} "
        f"x{len(devs)}, jax {jax.__version__}, native analyse ok")


def _spd_tiles(rng, batch: int, nb: int) -> np.ndarray:
    g = rng.standard_normal((batch, nb, nb))
    return g @ g.transpose(0, 2, 1) / nb + np.eye(nb)


def _potrf_ref(tiles: np.ndarray, kvec: np.ndarray) -> np.ndarray:
    """float64 reference of the partial-tile potrf: chol of the leading
    k x k block, rows below it solved against it, other columns zero."""
    import scipy.linalg as sla

    out = np.zeros_like(tiles)
    for i, k in enumerate(kvec):
        ld = np.linalg.cholesky(tiles[i, :k, :k])
        out[i, :k, :k] = ld
        out[i, k:, :k] = sla.solve_triangular(
            ld, tiles[i, k:, :k].T, lower=True).T
    return out


def phase_kernels(seed: int, nbs=(128, 256), batch: int = 32,
                  m2d: int = 48, nb2d: int = 64) -> dict:
    """Batched potrf / trsm at real widths against float64 references,
    the matmul precision modes, and the scan-factor pool against the
    STF oracle."""
    import jax
    import jax.numpy as jnp
    import scipy.linalg as sla

    from spllt_tpu import Options, analyse, factor, poisson2d
    from spllt_tpu.numeric.factor import _potrf_batch_blocked, _trsm_batch

    rng = np.random.default_rng(seed)
    errs = {}
    for nb in nbs:
        tiles = _spd_tiles(rng, batch, nb)
        # full tiles and rectangular diagonal blocks (k < nb)
        kvec = np.where(np.arange(batch) % 2 == 0, nb,
                        rng.integers(1, nb, batch))
        for k_i in np.nonzero(kvec < nb)[0]:
            tiles[k_i, :, kvec[k_i]:] = 0.0
        f = jax.jit(lambda t, k, nb=nb: _potrf_batch_blocked(
            t, k, nb, precision="highest"))
        out = f(jnp.asarray(tiles, jnp.float32), jnp.asarray(kvec, jnp.int32))
        e = rel(out, _potrf_ref(tiles, kvec))
        errs[f"potrf_nb{nb}"] = e
        check(f"phase 1: potrf nb={nb} batch={batch} rel err", e, KERNEL_TOL)

        lt = np.linalg.cholesky(tiles[kvec == nb])
        bt = rng.standard_normal(lt.shape)
        kf = np.full(len(lt), nb)
        t = jax.jit(lambda d, x, k, nb=nb: _trsm_batch(d, x, k, nb))
        out = t(jnp.asarray(lt, jnp.float32), jnp.asarray(bt, jnp.float32),
                jnp.asarray(kf, jnp.int32))
        ref = np.stack([sla.solve_triangular(l_, b_.T, lower=True).T
                        for l_, b_ in zip(lt, bt)])
        e = rel(out, ref)
        errs[f"trsm_nb{nb}"] = e
        check(f"phase 1: trsm nb={nb} batch={len(lt)} rel err", e,
              KERNEL_TOL)

    # what each lax precision does to a float32 product on this device
    x = rng.standard_normal((512, 512))
    y = rng.standard_normal((512, 512))
    for prec in ("highest", "high", "default"):
        z = jnp.dot(jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32),
                    precision=prec)
        e = rel(z, x @ y)
        errs[f"matmul_{prec}"] = e
        log(f"phase 1: f32 matmul precision={prec!r} rel err {e:.2e}")
    check("phase 1: f32 matmul precision='highest' rel err",
          errs["matmul_highest"], KERNEL_TOL)

    # the whole scan-factor pool against the float64 STF oracle
    a = poisson2d(m2d)
    base = dict(ordering="nd-grid", grid_shape=(m2d, m2d), nb=nb2d,
                nemin=16, precision="highest")
    symb = analyse(a, Options(mode="batched", dtype="float32", **base))
    pool = np.asarray(factor(symb).pool)
    ref = factor(analyse(a, Options(mode="stf", **base))).pool
    e = rel(pool[:len(ref)], ref)
    errs["pool"] = e
    check(f"phase 1: scan-factor pool poisson2d {m2d}^2 nb={nb2d} vs STF",
          e, KERNEL_TOL)
    return errs


def _factor_executor(symb):
    from spllt_tpu.numeric.factor_scan import ScanFactorExecutor

    return next(v for v in symb._cache.values()
                if isinstance(v, ScanFactorExecutor))


def phase_first_compile(m: int, seed: int) -> dict:
    """Poisson 3-D m^3 through the public API; prints the factor step's
    memory analysis and compile time."""
    import jax

    from spllt_tpu import Options, analyse, factor, poisson3d, solve

    a = poisson3d(m)
    symb = analyse(a, Options(grid_shape=(m,) * 3, **MAIN_OPTS))
    t0 = time.perf_counter()
    num = factor(symb)
    t_first = time.perf_counter() - t0
    ex = _factor_executor(symb)
    t0 = time.perf_counter()
    compiled = ex._fn.lower(
        jax.ShapeDtypeStruct(num.pool.shape, num.pool.dtype), ex.maps,
        ex.blk_n, ex.srcvec, ex._bucket_tables).compile()
    t_aot = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    log(f"phase 2: poisson3d {m}^3 n={symb.n} nnzL={symb.inform.num_factor}"
        f" first factor (compile+run) {t_first:.2f} s; factor step "
        f"lower+compile {t_aot:.2f} s (persistent cache on)")
    log(f"phase 2: factor step memory_analysis: {mem}")
    xt, b = rhs(a, 1, seed)
    e0 = bwd_err(a, solve(num, b, refine=0), b)
    log(f"phase 2: unrefined bwd_err {e0:.3e}")
    e = bwd_err(a, solve(num, b), b)
    check(f"phase 2: poisson3d {m}^3 refined bwd_err", e, REFINED_TOL)
    return {"bwd_err": e, "bwd_err_unrefined": e0, "t_first": t_first}


def phase_main(m: int, seed: int) -> dict:
    """Analyse, factor twice (second timed), refined solve at nrhs 1, 16."""
    import jax

    from spllt_tpu import Options, analyse, factor, poisson3d, solve

    a = poisson3d(m)
    t0 = time.perf_counter()
    symb = analyse(a, Options(grid_shape=(m,) * 3, **MAIN_OPTS))
    t_an = time.perf_counter() - t0
    log(f"phase 3: poisson3d {m}^3 n={symb.n} nnzL={symb.inform.num_factor}"
        f" flops={symb.inform.num_flops:.4e} analyse {t_an:.3f} s")
    t0 = time.perf_counter()
    num1 = factor(symb)
    t_f1 = time.perf_counter() - t0
    pool1 = np.asarray(num1.pool)
    del num1
    t0 = time.perf_counter()
    num = factor(symb)
    num.pool.block_until_ready()
    t_f2 = time.perf_counter() - t0
    dmax = float(np.max(np.abs(np.asarray(num.pool) - pool1)))
    del pool1
    log(f"phase 3: factor first (compile+run) {t_f1:.3f} s, steady "
        f"{t_f2 * 1e3:.3f} ms ({symb.inform.num_flops / t_f2 / 1e9:.1f} "
        f"GFLOP/s); pool {num.pool.nbytes / 1e9:.3f} GB; max |dpool| "
        f"between the two factorizations {dmax:.3e}")
    out = {"t_analyse": t_an, "t_factor_first": t_f1,
           "t_factor": t_f2, "pool_diff": dmax}
    for nrhs in (1, 16):
        xt, b = rhs(a, nrhs, seed + nrhs)
        t0 = time.perf_counter()
        x = solve(num, b)
        t_s1 = time.perf_counter() - t0
        t0 = time.perf_counter()
        x = solve(num, b)
        t_s2 = time.perf_counter() - t0
        log(f"phase 3: refined solve nrhs={nrhs} first {t_s1:.3f} s, "
            f"steady {t_s2 * 1e3:.3f} ms")
        e = bwd_err(a, x, b)
        check(f"phase 3: poisson3d {m}^3 nrhs={nrhs} refined bwd_err",
              e, REFINED_TOL)
        out[f"t_solve_{nrhs}"] = t_s2
        out[f"bwd_err_{nrhs}"] = e
    stats = jax.devices()[0].memory_stats() or {}
    out["peak_bytes"] = stats.get("peak_bytes_in_use")
    log(f"phase 3: peak_bytes_in_use {out['peak_bytes']}")
    return out


def phase_float64(m: int, seed: int) -> dict:
    from spllt_tpu import Options, analyse, factor, poisson3d, solve

    a = poisson3d(m)
    opts = dict(MAIN_OPTS, dtype="float64", refine=0)
    symb = analyse(a, Options(grid_shape=(m,) * 3, **opts))
    t0 = time.perf_counter()
    num = factor(symb)
    t_f = time.perf_counter() - t0
    xt, b = rhs(a, 1, seed)
    e = bwd_err(a, solve(num, b), b)
    log(f"phase 4: float64 poisson3d {m}^3 first factor {t_f:.2f} s")
    check(f"phase 4: float64 poisson3d {m}^3 bwd_err", e, F64_TOL)
    return {"bwd_err": e}


def phase_four(m: int, seed: int, ndev: int = 4) -> dict:
    """Options(ndevices=ndev) against a single-device solve of the same
    system in the same process."""
    import dataclasses

    from spllt_tpu import Options, analyse, factor, poisson3d, solve

    a = poisson3d(m)
    xt, b = rhs(a, 1, seed)
    opts = Options(grid_shape=(m,) * 3, **dict(MAIN_OPTS, prune_tree=True))
    x = {}
    for nd in (1, ndev):
        symb = analyse(a, dataclasses.replace(opts, ndevices=nd))
        t0 = time.perf_counter()
        num = factor(symb)
        t_f1 = time.perf_counter() - t0
        t0 = time.perf_counter()
        num = factor(symb)
        t_f2 = time.perf_counter() - t0
        x[nd] = solve(num, b)
        log(f"four: ndevices={nd} poisson3d {m}^3 first factor "
            f"{t_f1:.3f} s, steady {t_f2 * 1e3:.3f} ms")
        check(f"four: ndevices={nd} refined bwd_err", bwd_err(a, x[nd], b),
              REFINED_TOL)
        del num
    d = rel(x[ndev], x[1])
    check(f"four: ndevices={ndev} vs 1 relative solution difference", d,
          FOUR_DIFF_TOL)
    return {"diff": d}


# ------------------------------------------------------------------------ #
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--m", type=int, default=64,
                    help="grid edge of the main phase (default 64)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the four-device path and its check")
    args = ap.parse_args(argv)

    phase_environment()
    import jax

    if args.four:
        if len(jax.devices()) < 4:
            sys.exit(f"chip_smoke --four: needs 4 GPUs, JAX sees "
                     f"{len(jax.devices())}")
        phase_four(args.m, args.seed)
    else:
        phase_kernels(args.seed)
        phase_first_compile(32, args.seed)
        phase_main(args.m, args.seed)
        phase_float64(32, args.seed)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
