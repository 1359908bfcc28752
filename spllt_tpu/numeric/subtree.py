"""Batched dense subtree factorization (coarse-leaf phase).

Executes the plan's dense phase (plan/factor_tasks._build_dense_phase):
per spad bucket, assemble the fronts from the user values, run ONE batched
partial Cholesky (`_potrf_batch` — chol of the leading |V| columns plus
the boundary-row solve), and scatter the factored columns back into the
block pool.  Replaces the reference's per-subtree sequential
``spllt_subtree_factorize`` tasks (SURVEY §2.5) with a single batched op per
size bucket.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as sla

import jax
import jax.numpy as jnp

from ..errors import NotPositiveDefiniteError
from .factor import _potrf_batch_blocked

__all__ = ["subtree_np", "DenseSubtreeExecutor"]


# ===================================================================== #
# NumPy oracle
# ===================================================================== #
def subtree_np(pool: np.ndarray, values: np.ndarray, fp) -> np.ndarray:
    nb = fp.nb
    for b in fp.dense or []:
        sp = b["spad"]
        ns = b["nsub"]
        f = np.zeros((ns, sp, sp))
        np.add.at(f, (b["asm_sub"], b["asm_r"], b["asm_c"]),
                  values[b["asm_vidx"]])
        for i in range(ns):
            k = int(b["kvec"][i])
            d = f[i][:k, :k]
            d = np.tril(d) + np.tril(d, -1).T
            try:
                ld = np.linalg.cholesky(d)
            except np.linalg.LinAlgError as e:
                raise NotPositiveDefiniteError(
                    f"dense front {i} not positive definite") from e
            below = f[i][k:, :k]
            out = np.zeros((sp, sp))
            out[:k, :k] = ld
            out[k:, :k] = sla.solve_triangular(ld, below.T, lower=True).T
            f[i] = out
        for j in range(len(b["sc_blk"])):
            rp, rv = b["sc_rpos"][j], b["sc_rval"][j]
            cp, cv = b["sc_cpos"][j], b["sc_cval"][j]
            tile = np.zeros((nb, nb))
            tile[np.ix_(rv, cv)] = f[b["sc_sub"][j]][rp[rv]][:, cp[cv]]
            pool[b["sc_blk"][j]] = tile
    return pool


# ===================================================================== #
# JAX batched executor
# ===================================================================== #
def _dotx(a, b, dims, f32):
    """Exact data-movement contraction: a one-hot product moves values
    bit-exactly only in true float32, so precision=HIGHEST (a reduced
    precision such as TF32 would drop mantissa bits of the moved
    values)."""
    return jax.lax.dot_general(a, b, dims, precision=jax.lax.Precision.HIGHEST,
                               preferred_element_type=f32)


class DenseSubtreeExecutor:
    """Batched dense coarse-leaf phase, block-level data movement.

    Front assembly and factored-column scatter-back run as chunked
    one-hot contractions between POOL TILES and fronts, in place of
    element-granular advanced indexing.  Assembly reads the
    already-assembled pool (assemble_jax runs first in the factor
    pipeline), so no value gather exists at all:

        F[sub]  = Σ_blocks P_rᵀ · tile · P_c      (assembly)
        tile    = P_r · F[sub] · P_cᵀ             (scatter-back)

    with P_r/P_c the per-block one-hot position maps (sc_rpos/sc_cpos)
    and every contraction at precision=HIGHEST (exact movement).
    """

    _CHUNK_ELEMS = 128 * 128 * 128   # gathered fronts per chunk ~8 MB

    def __init__(self, fp, dtype=jnp.float32):
        self.fp = fp
        self.nb = fp.nb
        self.dtype = dtype
        i32 = lambda x: jnp.asarray(x, dtype=jnp.int32)
        self._tabs = []
        for b in fp.dense or []:
            ns, sp = int(b["nsub"]), int(b["spad"])
            self._tabs.append(dict(
                spad=sp, nsub=ns,
                kvec=i32(b["kvec"]),
                sc_blk=i32(b["sc_blk"]), sc_sub=i32(b["sc_sub"]),
                sc_rpos=i32(b["sc_rpos"]),
                sc_rval=jnp.asarray(b["sc_rval"]),
                sc_cpos=i32(b["sc_cpos"]),
                sc_cval=jnp.asarray(b["sc_cval"]),
            ))
        self._fn = jax.jit(self._build(), donate_argnums=(0,))

    def _build(self):
        nb = self.nb
        metas = [(t["spad"], t["nsub"], int(t["sc_blk"].shape[0]))
                 for t in self._tabs]

        def run(pool, values, tabs):
            f32 = pool.dtype
            pdt = f32     # one-hots in the pool dtype; HIGHEST dots

            def onehots(t, sl, sp):
                # P_r [C, nb, sp], P_c [C, nb, sp] — exact one-hots
                iot = jax.lax.broadcasted_iota(jnp.int32, (1, 1, sp), 2)
                pr = ((iot == t["sc_rpos"][sl][:, :, None])
                      & t["sc_rval"][sl][:, :, None]).astype(pdt)
                pc = ((iot == t["sc_cpos"][sl][:, :, None])
                      & t["sc_cval"][sl][:, :, None]).astype(pdt)
                return pr, pc
            for (sp, ns, nblk), t in zip(metas, tabs):
                chunk = max(1, self._CHUNK_ELEMS // (sp * sp))
                # ---- assembly: fronts from pool tiles ----------------- #
                f = jnp.zeros((ns, sp, sp), f32)
                for c0 in range(0, nblk, chunk):
                    sl = slice(c0, min(nblk, c0 + chunk))
                    pr, pc = onehots(t, sl, sp)
                    tiles = pool[t["sc_blk"][sl]]          # [C, nb, nb]
                    # contrib = P_rᵀ tile P_c  (exact 3-pass movement)
                    h = _dotx(tiles, pc,
                              (((2,), (1,)), ((0,), (0,))), f32)
                    # h [C, nb, sp]; contrib = P_rᵀ h -> [C, sp, sp]
                    contrib = _dotx(
                        h, pr, (((1,), (1,)), ((0,), (0,))), f32)
                    # contrib dims: [C, sp(c), sp(r)] -> transpose r,c
                    contrib = jnp.swapaxes(contrib, 1, 2)
                    f = f.at[t["sc_sub"][sl]].add(contrib)
                # ---- batched partial Cholesky ------------------------- #
                f = _potrf_batch_blocked(f, t["kvec"], sp)
                # ---- scatter-back: tiles from fronts ------------------ #
                for c0 in range(0, nblk, chunk):
                    sl = slice(c0, min(nblk, c0 + chunk))
                    pr, pc = onehots(t, sl, sp)
                    fg = f[t["sc_sub"][sl]]                # [C, sp, sp]
                    # tile = P_r F P_cᵀ
                    h = _dotx(fg, pc,
                              (((2,), (2,)), ((0,), (0,))), f32)
                    # h [C, sp, nb]; tile = P_r h -> [C, nb, nb]
                    tiles = _dotx(h, pr,
                                  (((1,), (2,)), ((0,), (0,))), f32)
                    tiles = jnp.swapaxes(tiles, 1, 2)
                    pool = pool.at[t["sc_blk"][sl]].set(tiles)
            return pool

        return run

    def __call__(self, pool, values):
        if not self._tabs:
            return pool
        return self._fn(jnp.asarray(pool, self.dtype),
                        jnp.asarray(values, self.dtype), self._tabs)
