"""User API: analyse / factor / solve (+ wait / finalize no-ops).

Mirrors the reference's three-phase interface
(``spllt_analyse`` / ``spllt_factor`` / ``spllt_solve`` with the
akeep/fkeep split, /root/reference/src/spllt_mod.F90,
doc/source/subroutines.rst): the symbolic object is reusable across
repeated factorizations of the same pattern; the numeric object holds the
factor pool and compiled executors.

Jobs (reference job table, include/spllt_iface.h):
  job=0 both, job=1 forward only, job=2 backward only.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .analyse.analyse import SymbolicFactor, analyse
from .errors import NotPositiveDefiniteError
from .inform import Inform
from .options import Options
from .plan.blocking import BlockPlan, build_block_plan
from .plan.factor_tasks import FactorPlan, build_factor_plan
from .plan.solve_tasks import SolvePlan, build_solve_plan
from .sparse.csc import CscMatrix
from .utils.jaxconfig import device_platform

__all__ = ["analyse", "factor", "solve", "SymbolicFactor", "NumericFactor",
           "Options"]


@dataclasses.dataclass
class NumericFactor:
    """fkeep analogue: block plan + factor pool + compiled executors."""

    symb: SymbolicFactor
    plan: BlockPlan
    fplan: FactorPlan
    splan: SolvePlan
    pool: object                 # np.ndarray (stf) or jax array (batched)
    values_perm: np.ndarray      # permuted values actually factored
    options: Options
    inform: Inform
    _solve_execs: dict = dataclasses.field(default_factory=dict)
    # multi-device runs (Options.ndevices > 1): (MultiDeviceFactor,
    # mesh, {job: sharded solve step}); ``pool`` then holds the SHARDED
    # local pools [ndev, nlocal*nb, nb] (the reference's one entry point
    # likewise hides the runtime behind spllt_factor,
    # /root/reference/src/spllt_mod.F90:141-168)
    mdf: tuple | None = None

    @property
    def mode(self) -> str:
        return self.options.mode

    @property
    def trace_log(self):
        """TraceLog accumulated under Options(trace=True), else None."""
        return getattr(self.options, "_trace_log", None)


def _plans(symb: SymbolicFactor, options: Options):
    """Plans for (symb, blocking options) — cached on the symbolic object
    so repeated refactorizations (the reference's akeep-reuse pipeline,
    doc/source/subroutines.rst:37-75) pay the plan build once."""
    # coarse dense fronts run on the single-device executors; the forest
    # path partitions the FLAT task stream, so multi-device plans are
    # built without coarsening
    use_coarse = options.coarse_subtrees and options.ndevices == 1
    key = ("plans", options.nb, use_coarse,
           options.coarse_span, options.coarse_waste)
    cache = getattr(symb, "_cache", None)
    if cache is None:
        cache = symb._cache = {}
    if key in cache:
        return cache[key]
    plan = build_block_plan(symb, options.nb)
    coarse = None
    if use_coarse:
        from .analyse.coarsen import coarse_partition

        coarse = coarse_partition(symb.forest, symb.node_flops,
                                  max_span=options.coarse_span,
                                  waste=options.coarse_waste)
    fplan = build_factor_plan(symb, plan, coarse=coarse)
    splan = build_solve_plan(symb, plan)
    cache[key] = (plan, fplan, splan)
    return cache[key]


def _diag(options: Options, name: str, flops: float = 0.0):
    """Phase context for Options.timers/trace (ref timer_mod/trace_mod):
    timers feed the global registry (utils.timers.print_timers /
    timer_csv); trace events accumulate on the symbolic object's
    ``_trace`` TraceLog (dump via num.trace_log.dump/dump_paje)."""
    import contextlib

    if not (options.timers or options.trace):
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    if options.timers:
        from .utils.timers import timer

        stack.enter_context(timer(name, flops=flops))
    if options.trace:
        tl = getattr(options, "_trace_log", None)
        if tl is None:
            from .utils.tracing import TraceLog

            tl = TraceLog()
            object.__setattr__(options, "_trace_log", tl)
        stack.enter_context(tl.event(name))
    return stack


def trace_log(obj):
    """The TraceLog accumulated under Options(trace=True) for this
    Options/NumericFactor (None if tracing is off)."""
    opts = obj.options if hasattr(obj, "options") else obj
    return getattr(opts, "_trace_log", None)


def factor(symb: SymbolicFactor, a: CscMatrix | None = None,
           options: Options | None = None) -> NumericFactor:
    """Numeric factorization.  ``a`` defaults to the matrix captured at
    analyse time; passing a new matrix with the same pattern refactorizes
    (the akeep-reuse workflow of the reference)."""
    options = options or symb.options
    with _diag(options, "factor",
               flops=float(getattr(symb.inform, "num_flops", 0) or 0)):
        return _factor_impl(symb, a, options)


def _factor_impl(symb: SymbolicFactor, a: CscMatrix | None,
                 options: Options) -> NumericFactor:
    values = (symb.a_perm.values if a is None
              else symb.a_perm_values_of(a) if hasattr(
                  symb, "a_perm_values_of") else _permuted_values(symb, a))
    plan, fplan, splan = _plans(symb, options)

    inform = dataclasses.replace(symb.inform)
    inform.num_blocks = plan.nblocks
    inform.num_levels = fplan.nlevels
    inform.num_tasks = fplan.num_tasks

    if options.mode == "batched" and options.ndevices > 1:
        return _factor_multidevice(symb, values, options, plan, fplan,
                                   splan, inform)

    if options.mode == "stf":
        from .numeric.assemble import assemble_np
        from .numeric.stf import factorize_np

        pool = assemble_np(plan, values, dtype=np.float64)
        if fplan.dense:
            from .numeric.subtree import subtree_np

            pool = subtree_np(pool, np.asarray(values, np.float64), fplan)
        pool = factorize_np(pool, fplan)
    else:
        import jax.numpy as jnp

        from .numeric.assemble import assemble_jax
        from .utils.jaxconfig import ensure_x64

        if options.dtype == "float64":
            ensure_x64()
        dtype = jnp.float64 if options.dtype == "float64" else jnp.float32
        pool = assemble_jax(plan, values, dtype)
        if fplan.dense:
            from .numeric.subtree import DenseSubtreeExecutor

            pool = DenseSubtreeExecutor(fplan, dtype=dtype)(pool, values)
        # executors are values-independent: cache per (symb, options) so
        # the refactorization pipeline skips table/chunk rebuilds
        ekey = ("fex", options.nb, options.schedule, options.dtype,
                options.precision, options.coarse_subtrees)
        ex = symb._cache.get(ekey)
        if ex is None:
            if options.schedule == "scan":
                from .numeric.factor_scan import ScanFactorExecutor as Ex
            else:
                from .numeric.factor import FactorExecutor as Ex
            ex = symb._cache[ekey] = Ex(fplan, dtype=dtype,
                                        matmul_precision=options.precision)
        pool, notpos = ex(pool)
        pool.block_until_ready()
        # positive-definiteness flag computed in-graph (tiny transfer)
        if bool(notpos):
            raise NotPositiveDefiniteError()

    sekey = ("sex", options.nb, options.schedule, options.dtype,
             options.precision)
    solve_execs = (symb._cache.setdefault(sekey, {})
                   if getattr(symb, "_cache", None) is not None else {})
    return NumericFactor(symb=symb, plan=plan, fplan=fplan, splan=splan,
                         pool=pool, values_perm=np.asarray(values),
                         options=options, inform=inform,
                         _solve_execs=solve_execs)


def _multidevice_setup(symb: SymbolicFactor, options: Options, plan,
                       fplan, splan):
    """Cached (md, mesh, jitted factor step, {job: solve step}) for
    ``Options.ndevices > 1`` — the user-API gateway to the forest
    executors (reference: the single ``spllt_factor`` entry selects its
    runtime including the distributed one,
    /root/reference/src/spllt_mod.F90:141-168)."""
    import jax
    from jax.sharding import Mesh

    from .parallel.forest import (build_multidevice_factor,
                                  make_sharded_factorize,
                                  make_sharded_solve)

    key = ("mdf", options.nb, options.ndevices, options.dtype,
           options.precision)
    hit = symb._cache.get(key)
    if hit is not None:
        return hit
    ndev = options.ndevices
    devs = jax.devices()
    if len(devs) < ndev:
        raise ValueError(
            f"Options(ndevices={ndev}) but only {len(devs)} "
            f"{devs[0].platform} devices are visible")
    mesh = Mesh(np.array(devs[:ndev]), ("tree",))
    md = build_multidevice_factor(symb, plan, fplan, ndev, splan=splan)
    fstep = jax.jit(make_sharded_factorize(md, mesh, options.dtype,
                                           precision=options.precision))
    solve_steps: dict = {}

    def solve_step(job: int):
        """Per-job sharded solve step (jit retraces per nrhs)."""
        s = solve_steps.get(job)
        if s is None:
            s = solve_steps[job] = jax.jit(make_sharded_solve(
                md, mesh, precision=options.precision, job=job))
        return s

    hit = (md, mesh, fstep, solve_step)
    symb._cache[key] = hit
    return hit


def _factor_multidevice(symb: SymbolicFactor, values, options: Options,
                        plan, fplan, splan, inform) -> NumericFactor:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from .utils.jaxconfig import ensure_x64

    if options.dtype == "float64":
        ensure_x64()
    md, mesh, fstep, solve_step = _multidevice_setup(symb, options, plan,
                                                     fplan, splan)
    dtype = np.float64 if options.dtype == "float64" else np.float32
    pools_np, top_np = md.local_pools(values, dtype=dtype)
    pools = jax.device_put(jnp.asarray(pools_np),
                           NamedSharding(mesh, P("tree")))
    top = jax.device_put(jnp.asarray(top_np), NamedSharding(mesh, P()))
    pools = fstep(pools, top)
    pools.block_until_ready()
    if bool(jnp.isnan(jnp.sum(pools))):
        raise NotPositiveDefiniteError()
    return NumericFactor(symb=symb, plan=plan, fplan=fplan, splan=splan,
                         pool=pools, values_perm=np.asarray(values),
                         options=options, inform=inform,
                         mdf=(md, mesh, solve_step))


def _permuted_values(symb: SymbolicFactor, a: CscMatrix) -> np.ndarray:
    """Re-permute values of a new matrix with the analysed pattern."""
    ap = a.permute(symb.perm)
    if (not np.array_equal(ap.colptr, symb.a_perm.colptr)
            or not np.array_equal(ap.rowind, symb.a_perm.rowind)):
        raise ValueError("matrix pattern differs from analysed pattern")
    return ap.values


def solve(num: NumericFactor, b: np.ndarray, job: int = 0,
          refine: int | None = None) -> np.ndarray:
    """Solve A x = b (job=0), L y = Pb (job=1) or Lᵀ(Px) = y (job=2).

    ``b`` is [n] or [n, nrhs] in user ordering.  For job=0 with
    ``refine`` > 0 steps (default from options), runs f64 iterative
    refinement — restoring double-precision backward error from the f32
    factor (in place of the reference's all-double arithmetic).
    """
    with _diag(num.options, f"solve(job={job})"):
        return _solve_impl(num, b, job, refine)


def _solve_impl(num: NumericFactor, b: np.ndarray, job: int,
                refine: int | None) -> np.ndarray:
    symb = num.symb
    n = symb.n
    one_d = b.ndim == 1
    bb = b.reshape(n, -1).astype(np.float64)
    nrhs = bb.shape[1]
    refine = num.options.refine if refine is None else refine
    if job != 0:
        refine = 0

    if (job == 0 and refine > 0 and num.options.refine_device
            and num.options.mode == "batched" and num.mdf is None
            and num.options.schedule == "scan"
            and device_platform() == "gpu"):
        x = _solve_refined_device(num, bb, refine)
        return x[:, 0] if one_d else x

    x = _solve_once(num, bb, job)
    if job == 0 and refine > 0:
        for _ in range(refine):
            r = bb - _user_matvec(num, x)
            dx = _solve_once(num, r, 0)
            x = x + dx
    return x[:, 0] if one_d else x


def _solve_refined_device(num: NumericFactor, bb: np.ndarray,
                          refine: int) -> np.ndarray:
    """Refined solve as one device program (f32 solves + f64 ELL-SpMV
    residuals on device; see numeric/spmv.py)."""
    import jax.numpy as jnp

    from .numeric.spmv import build_ell, ell_vals
    from .utils.jaxconfig import ensure_x64

    ensure_x64()
    symb = num.symb
    n = symb.n
    nrhs = bb.shape[1]
    ell = getattr(symb, "_ell", None)
    if ell is None:
        ell = build_ell(symb.a_perm)
        symb._ell = ell
    # cached on the NumericFactor (NOT the shared executor cache: the
    # ELL values change with every refactorization)
    dev = getattr(num, "_ell_dev", None)
    if dev is None:
        dev = (jnp.asarray(ell_vals(ell, num.values_perm)),
               jnp.asarray(ell.idx))
        num._ell_dev = dev
    vals64, idx = dev

    ex = _solve_executor(num, nrhs)
    xp = np.zeros((n + 1, nrhs), dtype=np.float64)
    xp[:n] = bb[symb.perm]
    x64 = np.asarray(ex.full_refined(num.pool, xp, vals64, idx, refine))
    out = np.empty((n, nrhs), dtype=np.float64)
    out[symb.perm] = x64[:n]
    return out


def _solve_executor(num: NumericFactor, nrhs: int):
    """Compiled solve executor for ``nrhs`` (cached): the bucketed scan
    executor for schedule='scan', the unrolled one otherwise."""
    import jax.numpy as jnp

    key = (nrhs,)
    ex = num._solve_execs.get(key)
    if ex is None:
        if num.options.schedule == "scan":
            from .numeric.solve_scan import ScanSolveExecutor as Ex
        else:
            from .numeric.solve import SolveExecutor as Ex
        dtype = (jnp.float64 if num.options.dtype == "float64"
                 else jnp.float32)
        ex = num._solve_execs[key] = Ex(
            num.splan, nrhs, dtype=dtype,
            matmul_precision=num.options.precision)
    return ex


def _user_matvec(num: NumericFactor, x: np.ndarray) -> np.ndarray:
    """A·x in user ordering with the factored values (float64)."""
    symb = num.symb
    ap = CscMatrix(symb.n, symb.a_perm.colptr, symb.a_perm.rowind,
                   num.values_perm)
    xp = x[symb.perm]
    yp = ap.matvec(xp)
    y = np.empty_like(yp)
    y[symb.perm] = yp
    return y


def _solve_once(num: NumericFactor, bb: np.ndarray, job: int) -> np.ndarray:
    symb = num.symb
    n = symb.n
    nrhs = bb.shape[1]
    # permute into factor ordering, pad dump row
    xp = np.zeros((n + 1, nrhs), dtype=np.float64)
    xp[:n] = bb[symb.perm]

    if num.mdf is not None:
        import jax.numpy as jnp

        _, _, solve_step = num.mdf
        dt = (jnp.float64 if num.options.dtype == "float64"
              else jnp.float32)
        xd = solve_step(job)(num.pool, jnp.asarray(xp, dt))
        out_p = np.asarray(xd)[:n].astype(np.float64)
    elif num.options.mode == "stf":
        from .numeric.solve import solve_bwd_np, solve_fwd_np

        if job in (0, 1):
            xp = solve_fwd_np(num.pool, num.splan, xp)
        if job in (0, 2):
            xp = solve_bwd_np(num.pool, num.splan, xp)
        out_p = xp[:n]
    else:
        ex = _solve_executor(num, nrhs)
        xd = xp
        if job == 0 and hasattr(ex, "full"):
            xd = ex.full(num.pool, xd)
        else:
            if job in (0, 1):
                xd = ex.fwd(num.pool, xd)
            if job in (0, 2):
                xd = ex.bwd(num.pool, xd)
        out_p = np.asarray(xd)[:n].astype(np.float64)

    out = np.empty((n, nrhs), dtype=np.float64)
    out[symb.perm] = out_p
    return out
