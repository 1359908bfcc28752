"""Batched level-scheduled factorization under one jit (the device runtime).

Each DAG level becomes at most four batched device ops over the block pool:

  updbt : gather rows via position maps → batched GEMM → scatter-add
  syrk  : gather tiles → batched GEMM → scatter-add
  potrf : gather diag tiles → masked+padded batched Cholesky + trailing
          triangular solve (rectangular diagonal blocks handled in-tile,
          reference ``spllt_factor_diag_block``,
          /root/reference/src/spllt_kernels_mod.F90:1168-1189)
  trsm  : gather tiles → batched right triangular solve

The whole schedule is traced once and compiled by XLA; there is no runtime
scheduler (this replaces OMP `task depend` / StarPU handles / PaRSEC flows,
SURVEY §2.10).  Padding invariant: kernel outputs are masked to
``col < blk_n`` so padded columns stay exactly zero and updates can consume
full tiles.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["FactorExecutor"]

# bytes of each gathered updbt operand per chunk: a level's full
# [K, nb, cmax*nb] gathers exceed an 80 GB card at nb=256 on Poisson 64^3
UPDBT_CHUNK_BYTES = 1 << 30


def _bmm_nt(a, b, precision):
    """Batched a @ bᵀ over the leading axis."""
    return jax.lax.dot_general(a, b, (((2,), (2,)), ((0,), (0,))),
                               precision=precision,
                               preferred_element_type=a.dtype)


def _updbt(pool, maps, blk_n, srcvec, dst, mr, mc, svp, cv, cmax,
           precision):
    """Width-fused between-node updates (``spllt_update_between``).

    Task t gathers, through the position maps ``maps[mr[t]]`` (rows) and
    ``maps[mc[t]]`` (cols), the source node's rows from all of its ``cv[t]``
    column tiles (flat row bases ``srcvec[svp[t]:]``) into [nb, cmax·nb]
    panels, multiplies them NT in one batched GEMM and scatter-adds the
    negated product into tile ``dst[t]``.  Tasks run in chunks whose
    gathers stay under ``UPDBT_CHUNK_BYTES``; chunking is exact because an
    update's sources are factored blocks, never destinations of the same
    level."""
    nb = pool.shape[1]
    ntask = dst.shape[0]
    per_task = nb * cmax * nb * np.dtype(pool.dtype).itemsize
    kc = max(1, UPDBT_CHUNK_BYTES // per_task)
    iota = jax.lax.broadcasted_iota(jnp.int32, (1, nb), 1)
    iot_c = jax.lax.broadcasted_iota(jnp.int32, (1, cmax), 1)
    for c0 in range(0, ntask, kc):
        sl = slice(c0, min(ntask, c0 + kc))
        d = dst[sl]
        pr = maps[mr[sl]]
        pc = maps[mc[sl]]
        svi = jnp.minimum(svp[sl][:, None] + iot_c, srcvec.shape[0] - 1)
        sv = srcvec[svi]                              # [k, cmax]
        kbm = iot_c < cv[sl][:, None]
        vr = pr >= 0
        vc = (pc >= 0) & (iota < blk_n[d][:, None])
        poolf = pool.reshape(-1, nb)

        def gathw(p, v):
            val = v[:, :, None] & kbm[:, None, :]
            fr = jnp.where(val, sv[:, None, :] * nb + p[:, :, None], 0)
            g = poolf[fr] * val[..., None].astype(pool.dtype)
            return g.reshape(g.shape[0], nb, cmax * nb)

        pool = pool.at[d].add(-_bmm_nt(gathw(pr, vr), gathw(pc, vc),
                                       precision))
    return pool


def _potrf_batch(tiles, kvec, nb):
    """Batched potrf of (possibly rectangular) diagonal tiles.

    tiles: [B, nb, nb]; kvec: [B] number of factor columns.
    Returns [[chol(D), 0], [B·chol(D)^{-T}, 0]].
    """
    f32 = tiles.dtype
    k = kvec[:, None, None]
    rowi = jax.lax.broadcasted_iota(jnp.int32, (1, nb, nb), 1)
    coli = jax.lax.broadcasted_iota(jnp.int32, (1, nb, nb), 2)
    in_d = (rowi < k) & (coli < k)
    low = jnp.where(in_d & (rowi >= coli), tiles, jnp.zeros((), f32))
    sym = low + jnp.where(in_d & (rowi > coli), tiles,
                          jnp.zeros((), f32)).swapaxes(-1, -2)
    pad_eye = ((rowi == coli) & (rowi >= k)).astype(f32)
    c = jax.lax.linalg.cholesky(sym + pad_eye)
    below = jnp.where(rowi >= k, tiles, jnp.zeros((), f32))
    bp = jax.lax.linalg.triangular_solve(
        c, below, left_side=False, lower=True, transpose_a=True)
    out = jnp.where(rowi < k, c, bp)
    return out * (coli < k).astype(f32)


def _potrf_batch_blocked(tiles, kvec, sp, panel: int = 128,
                         precision="highest"):
    """Blocked right-looking batched potrf for wide tiles.

    Runs sp/panel panel steps — panel-wide masked Cholesky (via
    :func:`_potrf_batch`), a trailing triangular solve of the rows below
    the panel, and a rank-``panel`` GEMM update of the trailing square.
    On the H100 this beats one batched cholesky of the whole tile by
    about 1.5x at sp=256 and batch >= 512 (PERF.md); for sp <= panel it
    is that one call.
    Semantics match ``_potrf_batch(tiles, kvec, sp)`` exactly: columns
    >= kvec are zeroed, rows >= kvec (boundary rows of a dense front)
    are solved like any below-rows.
    """
    if sp <= panel:
        return _potrf_batch(tiles, kvec, sp)
    f32 = tiles.dtype
    out = tiles
    for p0 in range(0, sp, panel):
        w = min(panel, sp - p0)
        kloc = jnp.clip(kvec - p0, 0, w)
        dfac = _potrf_batch(out[:, p0:p0 + w, p0:p0 + w], kloc, w)
        out = out.at[:, p0:p0 + w, p0:p0 + w].set(dfac)
        if p0 + w >= sp:
            break
        ke = kloc[:, None, None]
        rowi = jax.lax.broadcasted_iota(jnp.int32, (1, w, w), 1)
        coli = jax.lax.broadcasted_iota(jnp.int32, (1, w, w), 2)
        # identity on padded diagonal so the solve stays non-singular;
        # the sub-diagonal below-rows of dfac only feed masked columns
        cc = dfac + ((rowi == coli) & (rowi >= ke)).astype(f32)
        below = out[:, p0 + w:, p0:p0 + w]
        sol = jax.lax.linalg.triangular_solve(
            cc, below, left_side=False, lower=True, transpose_a=True)
        colm = (jax.lax.broadcasted_iota(jnp.int32, (1, 1, w), 2)
                < ke).astype(f32)
        sol = sol * colm
        out = out.at[:, p0 + w:, p0:p0 + w].set(sol)
        out = out.at[:, p0 + w:, p0 + w:].add(-_bmm_nt(sol, sol, precision))
    # zero the strict upper triangle / padded columns (panel steps never
    # touch the above-panel rows of later columns)
    ke = kvec[:, None, None]
    rowi = jax.lax.broadcasted_iota(jnp.int32, (1, sp, sp), 1)
    coli = jax.lax.broadcasted_iota(jnp.int32, (1, sp, sp), 2)
    return out * ((coli <= rowi) & (coli < ke)).astype(f32)


def _trsm_batch(diag_tiles, dst_tiles, kvec, nb):
    """dst ← dst · L^{-T} restricted to the first k columns."""
    f32 = dst_tiles.dtype
    k = kvec[:, None, None]
    rowi = jax.lax.broadcasted_iota(jnp.int32, (1, nb, nb), 1)
    coli = jax.lax.broadcasted_iota(jnp.int32, (1, nb, nb), 2)
    c = diag_tiles + ((rowi == coli) & (rowi >= k)).astype(f32)
    x = jax.lax.linalg.triangular_solve(
        c, dst_tiles, left_side=False, lower=True, transpose_a=True)
    return x * (coli < k).astype(f32)


class FactorExecutor:
    """Compiles and runs the level schedule for one FactorPlan."""

    def __init__(self, fp, dtype=jnp.float32, matmul_precision="highest"):
        self.fp = fp
        self.dtype = dtype
        self.precision = matmul_precision
        self.nb = fp.nb
        self._args = self._device_arrays()
        self._fn = jax.jit(self._build(), donate_argnums=(0,))

    # ------------------------------------------------------------------ #
    def _device_arrays(self):
        fp = self.fp
        i32 = lambda x: jnp.asarray(x, dtype=jnp.int32)
        return dict(
            potrf_blk=i32(fp.potrf_blk), potrf_k=i32(fp.potrf_k),
            trsm_diag=i32(fp.trsm_diag), trsm_dst=i32(fp.trsm_dst),
            trsm_k=i32(fp.trsm_k),
            syrk_src_i=i32(fp.syrk_src_i), syrk_src_j=i32(fp.syrk_src_j),
            syrk_dst=i32(fp.syrk_dst),
            updbt_dst=i32(fp.updbt_dst), updbt_mr=i32(fp.updbt_mr),
            updbt_mc=i32(fp.updbt_mc), updbt_svp=i32(fp.updbt_svp),
            updbt_c=i32(fp.updbt_c), srcvec=i32(fp.srcvec),
            maps=i32(fp.maps), blk_n=i32(fp.blk_n),
        )

    # ------------------------------------------------------------------ #
    def _build(self):
        fp = self.fp
        nb = self.nb
        prec = self.precision

        def run(pool, args):
            for lvl in range(1, fp.nlevels + 1):
                # ---- inter-node updates (width-fused) -------------------- #
                s, e = int(fp.updbt_ptr[lvl]), int(fp.updbt_ptr[lvl + 1])
                if e > s:
                    pool = _updbt(
                        pool, args["maps"], args["blk_n"], args["srcvec"],
                        args["updbt_dst"][s:e], args["updbt_mr"][s:e],
                        args["updbt_mc"][s:e], args["updbt_svp"][s:e],
                        args["updbt_c"][s:e], int(fp.updbt_c[s:e].max()),
                        prec)
                # ---- intra-node updates ---------------------------------- #
                s, e = int(fp.syrk_ptr[lvl]), int(fp.syrk_ptr[lvl + 1])
                if e > s:
                    si = args["syrk_src_i"][s:e]
                    sj = args["syrk_src_j"][s:e]
                    dst = args["syrk_dst"][s:e]
                    u = _bmm_nt(pool[si], pool[sj], prec)
                    pool = pool.at[dst].add(-u)
                # ---- potrf ----------------------------------------------- #
                s, e = int(fp.potrf_ptr[lvl]), int(fp.potrf_ptr[lvl + 1])
                if e > s:
                    blk = args["potrf_blk"][s:e]
                    out = _potrf_batch_blocked(pool[blk],
                                               args["potrf_k"][s:e], nb,
                                               precision=prec)
                    pool = pool.at[blk].set(out)
                # ---- trsm ------------------------------------------------ #
                s, e = int(fp.trsm_ptr[lvl]), int(fp.trsm_ptr[lvl + 1])
                if e > s:
                    diag = args["trsm_diag"][s:e]
                    dst = args["trsm_dst"][s:e]
                    out = _trsm_batch(pool[diag], pool[dst],
                                      args["trsm_k"][s:e], nb)
                    pool = pool.at[dst].set(out)
            notpos = jnp.isnan(jnp.sum(pool[:, 0, 0]))
            return pool, notpos

        return run

    # ------------------------------------------------------------------ #
    def __call__(self, pool):
        return self._fn(jnp.asarray(pool, dtype=self.dtype), self._args)
