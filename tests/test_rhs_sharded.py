"""rhs-axis sharded multi-RHS solve vs single-device solve."""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from spllt_tpu import Options, analyse, factor, poisson2d, solve
from spllt_tpu.parallel.rhs import solve_rhs_sharded


@pytest.mark.parametrize("ndev", [2, 4])
def test_rhs_sharded_matches_single(ndev):
    devs = jax.devices("cpu")
    if len(devs) < ndev:
        pytest.skip("not enough virtual devices")
    m = 16
    a = poisson2d(m)
    opts = Options(ordering="nd-grid", grid_shape=(m, m), nb=16, nemin=8,
                   mode="batched", dtype="float32", prune_tree=False)
    symb = analyse(a, opts)
    num = factor(symb)

    rng = np.random.default_rng(0)
    nrhs = 8
    x_true = rng.standard_normal((symb.n, nrhs))
    b = np.stack([a.matvec(x_true[:, j]) for j in range(nrhs)], axis=1)

    x_ref = solve(num, b)
    mesh = Mesh(np.array(devs[:ndev]), ("rhs",))
    x_sh = solve_rhs_sharded(num, b, mesh=mesh)

    assert np.allclose(x_sh, x_ref, atol=1e-8)
    assert np.max(np.abs(x_sh - x_true)) < 1e-6


def test_rhs_sharded_pads_odd_nrhs():
    devs = jax.devices("cpu")
    if len(devs) < 4:
        pytest.skip("not enough virtual devices")
    m = 8
    a = poisson2d(m)
    opts = Options(ordering="nd-grid", grid_shape=(m, m), nb=8, nemin=4,
                   mode="batched", dtype="float32", prune_tree=False)
    num = factor(analyse(a, opts))
    rng = np.random.default_rng(1)
    nrhs = 5          # not divisible by 4 -> padded internally
    x_true = rng.standard_normal((a.n, nrhs))
    b = np.stack([a.matvec(x_true[:, j]) for j in range(nrhs)], axis=1)
    mesh = Mesh(np.array(devs[:4]), ("rhs",))
    x = solve_rhs_sharded(num, b, mesh=mesh)
    assert x.shape == (a.n, nrhs)
    assert np.max(np.abs(x - x_true)) < 1e-6
