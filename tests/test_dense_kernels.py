"""Batched dense kernels against NumPy/SciPy, and the scan factor + solve
against an independent sparse solver (scipy.sparse.linalg.spsolve)."""

import numpy as np
import pytest
import scipy.linalg as sla
import scipy.sparse as sp
import scipy.sparse.linalg as spla

import jax.numpy as jnp

from spllt_tpu import Options, analyse, factor, fem3d, poisson2d, solve
from spllt_tpu.numeric.factor import (_potrf_batch, _potrf_batch_blocked,
                                      _trsm_batch)


def _spd(rng, batch, nb):
    g = rng.standard_normal((batch, nb, nb))
    return g @ g.transpose(0, 2, 1) / nb + np.eye(nb)


def _potrf_ref(tiles, kvec):
    out = np.zeros_like(tiles)
    for i, k in enumerate(kvec):
        if k == 0:
            continue
        ld = np.linalg.cholesky(tiles[i, :k, :k])
        out[i, :k, :k] = ld
        out[i, k:, :k] = sla.solve_triangular(ld, tiles[i, k:, :k].T,
                                              lower=True).T
    return out


_KPATTERNS = {"full": lambda nb: [nb] * 4,
              "partial": lambda nb: [nb - 1, nb // 2, 1, nb // 3 + 1],
              "mixed": lambda nb: [nb, 0, nb // 2, nb]}


@pytest.mark.parametrize("kpat", sorted(_KPATTERNS))
@pytest.mark.parametrize("nb", [8, 32])
def test_potrf_batch_matches_numpy(nb, kpat):
    rng = np.random.default_rng(nb)
    kvec = np.asarray(_KPATTERNS[kpat](nb), np.int32)
    tiles = _spd(rng, len(kvec), nb)
    ref = _potrf_ref(tiles, kvec)
    t = jnp.asarray(tiles, jnp.float32)
    k = jnp.asarray(kvec)
    for got in (_potrf_batch(t, k, nb),
                _potrf_batch_blocked(t, k, nb, panel=8)):
        np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("nb", [8, 32])
def test_trsm_batch_matches_scipy(nb):
    rng = np.random.default_rng(7)
    kvec = np.asarray([nb, nb // 2, 1], np.int32)
    lt = np.linalg.cholesky(_spd(rng, len(kvec), nb))
    b = rng.standard_normal(lt.shape)
    got = np.asarray(_trsm_batch(jnp.asarray(lt, jnp.float32),
                                 jnp.asarray(b, jnp.float32),
                                 jnp.asarray(kvec), nb))
    for i, k in enumerate(kvec):
        ref = sla.solve_triangular(lt[i, :k, :k], b[i, :, :k].T,
                                   lower=True).T
        np.testing.assert_allclose(got[i, :, :k], ref, rtol=1e-4,
                                   atol=1e-5)
        assert not np.any(got[i, :, k:])


def _full_scipy(a):
    """The full symmetric scipy.sparse matrix of a lower-CSC CscMatrix."""
    low = sp.csc_matrix((a.values, a.rowind, a.colptr), shape=(a.n, a.n))
    return (low + sp.tril(low, -1).T).tocsc()


_CASES = {
    "amd": (lambda: fem3d(4, dofs=2, seed=1), dict(ordering="amd")),
    "nd": (lambda: poisson2d(14), dict(ordering="nd")),
    "nd-grid": (lambda: poisson2d(14),
                dict(ordering="nd-grid", grid_shape=(14, 14))),
}


@pytest.mark.parametrize("prec", ["float32+refine", "float64"])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_scan_factor_solve_matches_spsolve(case, prec):
    build, kw = _CASES[case]
    a = build()
    dtype, refine = (("float32", 2) if prec == "float32+refine"
                     else ("float64", 0))
    symb = analyse(a, Options(nb=16, nemin=8, dtype=dtype, refine=refine,
                              schedule="scan", **kw))
    rng = np.random.default_rng(5)
    b = rng.standard_normal((a.n, 2))
    x = solve(factor(symb), b)
    ref = spla.spsolve(_full_scipy(a), b)
    np.testing.assert_allclose(x, ref, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("schedule", ["scan", "unrolled"])
def test_updbt_chunking_matches_one_chunk(schedule, monkeypatch):
    """Between-node updates split into many small chunks give the same
    factor as one chunk per level."""
    import spllt_tpu.numeric.factor as fc

    a = poisson2d(12)
    opts = Options(ordering="nd-grid", grid_shape=(12, 12), nb=8, nemin=4,
                   dtype="float64", refine=0, schedule=schedule)
    whole = np.asarray(factor(analyse(a, opts)).pool)
    monkeypatch.setattr(fc, "UPDBT_CHUNK_BYTES", 1)   # one task per chunk
    chunked = np.asarray(factor(analyse(a, opts)).pool)
    np.testing.assert_allclose(chunked, whole, rtol=1e-12, atol=1e-12)
