"""Multi-RHS solve sharded over the rhs axis (data parallelism).

Analogue of the reference's multi-RHS blocking
(/root/reference/src/spllt_solve_kernels_mod.F90:128-133,200-204 — BLAS-3
nrhs panels): with the factor pool replicated on every device, the rhs
panel is sharded column-wise over a ``rhs`` mesh axis and each device runs
the identical level-scheduled fwd/bwd program on its slice.  The solve is
embarrassingly parallel along nrhs — zero collectives; scaling is limited
only by the per-device pool bandwidth.

Entered via ``shard_map`` (not the automatic partitioner) so each device
runs the single-device solve program on local shapes.
"""

from __future__ import annotations

import numpy as np

__all__ = ["make_sharded_solve", "solve_rhs_sharded"]


def make_sharded_solve(ex, mesh, axis: str = "rhs"):
    """Jitted fwd+bwd solve with ``x`` sharded on its rhs axis.

    ``ex`` is a built :class:`ScanSolveExecutor`; its compiled program is
    reused per shard.  Returns ``fn(pool_ext, x) -> x`` where ``x`` is
    [n+1, nrhs] with nrhs divisible by the mesh axis size.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    fwd_run = ex._build(True)
    bwd_run = ex._build(False)
    ftabs, btabs = ex._fwd_tables, ex._bwd_tables

    def local(pool_ext, x, ft, bt):
        return bwd_run(pool_ext, fwd_run(pool_ext, x, ft), bt)

    sharded = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(None, axis), P(), P()),
        out_specs=P(None, axis))
    jfn = jax.jit(sharded, donate_argnums=(1,))

    def fn(pool_ext, x):
        return jfn(pool_ext, x, ftabs, btabs)

    xsh = NamedSharding(mesh, P(None, axis))
    return fn, xsh


def solve_rhs_sharded(num, b: np.ndarray, mesh=None, ndev: int | None = None,
                      refine: int | None = None) -> np.ndarray:
    """A x = b (job=0) with the rhs panel sharded over devices.

    ``b`` is [n, nrhs] in user ordering.  nrhs is padded up to a multiple
    of the mesh size.  Host-side f64 refinement as in :func:`solve`.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from ..api import _user_matvec
    from ..numeric.solve_scan import ScanSolveExecutor

    symb = num.symb
    n = symb.n
    bb = np.asarray(b, dtype=np.float64).reshape(n, -1)
    nrhs = bb.shape[1]
    if mesh is None:
        devs = jax.devices()[: (ndev or len(jax.devices()))]
        mesh = Mesh(np.array(devs), ("rhs",))
    ndev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    nrhs_pad = -(-nrhs // ndev) * ndev

    key = ("rhs_sharded", nrhs_pad, ndev)
    cached = num._solve_execs.get(key)
    if cached is None:
        dtype = (jnp.float64 if num.options.dtype == "float64"
                 else jnp.float32)
        ex = ScanSolveExecutor(num.splan, nrhs_pad, dtype=dtype,
                               matmul_precision=num.options.precision)
        fn, xsh = make_sharded_solve(ex, mesh)
        cached = (ex, fn, xsh)
        num._solve_execs[key] = cached
    ex, fn, xsh = cached

    def run_once(rhs_np):
        xp = np.zeros((n + 1, nrhs_pad), dtype=np.float64)
        xp[:n, :nrhs] = rhs_np[symb.perm]
        xd = jax.device_put(jnp.asarray(xp, ex.dtype), xsh)
        out = np.asarray(fn(num.pool, xd))[:n, :nrhs].astype(np.float64)
        res = np.empty_like(out)
        res[symb.perm] = out
        return res

    refine = num.options.refine if refine is None else refine
    x = run_once(bb)
    for _ in range(refine):
        r = bb - _user_matvec(num, x)
        x = x + run_once(r)
    return x
