"""Forward/backward substitution executors (NumPy oracle + batched JAX).

Counterpart of the reference solve phase
(/root/reference/src/spllt_solve_mod.F90, spllt_solve_kernels_mod.F90):
level-scheduled batched gather → triangular-solve / GEMM → scatter over a
padded right-hand-side panel x[n+1, nrhs] (row n is the dump row for
masked slots).  Supports job = fwd (Lx=b), bwd (Lᵀx=b) or both, and any
number of right-hand sides (the nrhs axis becomes the GEMM width).
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as sla

import jax
import jax.numpy as jnp

__all__ = ["solve_fwd_np", "solve_bwd_np", "SolveExecutor"]


# ===================================================================== #
# NumPy oracle
# ===================================================================== #
def _tile_with_pad_eye(tile, k):
    t = tile.copy()
    idx = np.arange(k, tile.shape[0])
    t[idx, idx] = 1.0
    return t


def solve_fwd_np(pool, sp, x):
    """x: [n+1, r] padded rhs (modified in place); row n is the dump row."""
    for lvl in range(1, sp.nlevels_fwd + 1):
        for t in range(sp.fsol_ptr[lvl], sp.fsol_ptr[lvl + 1]):
            rows = sp.fsol_rows[t]
            k = sp.fsol_k[t]
            valid = rows < sp.n
            z = x[np.minimum(rows, sp.n)].copy()
            z[~valid] = 0.0
            m = _tile_with_pad_eye(pool[sp.fsol_blk[t]], k)
            y = sla.solve_triangular(m, z, lower=True)
            x[rows[:k]] = y[:k]                       # exclusive cols write
            sel = valid.copy()
            sel[:k] = False
            np.add.at(x, rows[sel], (y - z)[sel])     # commutative below add
        for t in range(sp.fupd_ptr[lvl], sp.fupd_ptr[lvl + 1]):
            k = sp.fupd_k[t]
            c0 = sp.fupd_c0[t]
            y = x[c0:c0 + k]
            rows = sp.fupd_rows[t]
            u = pool[sp.fupd_blk[t]][:, :k] @ y
            valid = rows < sp.n
            np.add.at(x, rows[valid], -u[valid])
    return x


def solve_bwd_np(pool, sp, x):
    for lvl in range(1, sp.nlevels_bwd + 1):
        for t in range(sp.bupd_ptr[lvl], sp.bupd_ptr[lvl + 1]):
            k = sp.bupd_k[t]
            c0 = sp.bupd_c0[t]
            rows = sp.bupd_rows[t]
            z = np.where((rows < sp.n)[:, None], x[np.minimum(rows, sp.n)],
                         0.0)
            x[c0:c0 + k] -= pool[sp.bupd_blk[t]][:, :k].T @ z
        for t in range(sp.bsol_ptr[lvl], sp.bsol_ptr[lvl + 1]):
            rows = sp.bsol_rows[t]
            k = sp.bsol_k[t]
            valid = rows < sp.n
            z = x[np.minimum(rows, sp.n)].copy()
            z[~valid] = 0.0
            m = _tile_with_pad_eye(pool[sp.bsol_blk[t]], k)
            y = sla.solve_triangular(m, z, lower=True, trans="T")
            x[rows[:k]] = y[:k]                       # exclusive cols write
    return x


# ===================================================================== #
# JAX batched executor
# ===================================================================== #
class SolveExecutor:
    """Compiles fwd/bwd level schedules for one SolvePlan and rhs width."""

    def __init__(self, sp, nrhs: int, dtype=jnp.float32,
                 matmul_precision="highest"):
        self.sp = sp
        self.nrhs = nrhs
        self.dtype = dtype
        self.precision = matmul_precision
        i32 = lambda x: jnp.asarray(x, dtype=jnp.int32)
        self._args = dict(
            fsol_blk=i32(sp.fsol_blk), fsol_rows=i32(sp.fsol_rows),
            fsol_k=i32(sp.fsol_k),
            fupd_blk=i32(sp.fupd_blk), fupd_rows=i32(sp.fupd_rows),
            fupd_c0=i32(sp.fupd_c0), fupd_k=i32(sp.fupd_k),
            bupd_blk=i32(sp.bupd_blk), bupd_rows=i32(sp.bupd_rows),
            bupd_c0=i32(sp.bupd_c0), bupd_k=i32(sp.bupd_k),
            bsol_blk=i32(sp.bsol_blk), bsol_rows=i32(sp.bsol_rows),
            bsol_k=i32(sp.bsol_k),
        )
        self._fwd = jax.jit(self._build(True), donate_argnums=(1,))
        self._bwd = jax.jit(self._build(False), donate_argnums=(1,))

    # ------------------------------------------------------------------ #
    def _build(self, forward: bool):
        sp = self.sp
        nb = sp.nb
        prec = self.precision

        def solve_batch(pool, args, x, blk, rows, kvec, transpose):
            tiles = pool[blk]                          # [B, nb, nb]
            rowi = jax.lax.broadcasted_iota(jnp.int32, (1, nb, nb), 1)
            coli = jax.lax.broadcasted_iota(jnp.int32, (1, nb, nb), 2)
            slot = jax.lax.broadcasted_iota(jnp.int32, (1, nb), 1)
            k = kvec[:, None, None]
            m = tiles + ((rowi == coli) & (rowi >= k)).astype(tiles.dtype)
            rvalid = (rows < sp.n)[..., None].astype(x.dtype)
            z = x[rows] * rvalid                       # [B, nb, r]
            y = jax.lax.linalg.triangular_solve(
                m, z, left_side=True, lower=True, transpose_a=transpose)
            colmask = slot < kvec[:, None]             # [B, nb]
            rows_set = jnp.where(colmask, rows, sp.n)
            x = x.at[rows_set].set(y * colmask[..., None].astype(x.dtype),
                                   mode="drop")
            if not transpose:
                # forward: within-tile below rows get the commutative delta
                # y_b - z_b = -(B · L^{-1} z_c)
                bmask = (~colmask)[..., None].astype(x.dtype) * rvalid
                rows_add = jnp.where(colmask, sp.n, rows)
                x = x.at[rows_add].add((y - z) * bmask, mode="drop")
            return x

        def run(pool, x, args):
            if forward:
                nlev = sp.nlevels_fwd
                sol_ptr, upd_ptr = sp.fsol_ptr, sp.fupd_ptr
            else:
                nlev = sp.nlevels_bwd
                sol_ptr, upd_ptr = sp.bsol_ptr, sp.bupd_ptr
            iota = jax.lax.broadcasted_iota(jnp.int32, (1, nb), 1)
            for lvl in range(1, nlev + 1):
                if forward:
                    s, e = int(sol_ptr[lvl]), int(sol_ptr[lvl + 1])
                    if e > s:
                        x = solve_batch(pool, args, x,
                                        args["fsol_blk"][s:e],
                                        args["fsol_rows"][s:e],
                                        args["fsol_k"][s:e], False)
                    s, e = int(upd_ptr[lvl]), int(upd_ptr[lvl + 1])
                    if e > s:
                        blk = args["fupd_blk"][s:e]
                        rows = args["fupd_rows"][s:e]
                        c0 = args["fupd_c0"][s:e][:, None]
                        kv = args["fupd_k"][s:e][:, None]
                        cmask = iota < kv
                        cidx = jnp.where(cmask, c0 + iota, sp.n)
                        y = x[cidx] * cmask[..., None].astype(x.dtype)
                        u = jax.lax.dot_general(
                            pool[blk], y, (((2,), (1,)), ((0,), (0,))),
                            precision=self.precision,
                            preferred_element_type=x.dtype)
                        rmask = (rows < sp.n)[..., None].astype(x.dtype)
                        x = x.at[rows].add(-u * rmask, mode="drop")
                else:
                    s, e = int(upd_ptr[lvl]), int(upd_ptr[lvl + 1])
                    if e > s:
                        blk = args["bupd_blk"][s:e]
                        rows = args["bupd_rows"][s:e]
                        c0 = args["bupd_c0"][s:e][:, None]
                        kv = args["bupd_k"][s:e][:, None]
                        rmask = (rows < sp.n)[..., None].astype(x.dtype)
                        z = x[rows] * rmask              # [B, nb, r]
                        u = jax.lax.dot_general(
                            pool[blk], z, (((1,), (1,)), ((0,), (0,))),
                            precision=self.precision,
                            preferred_element_type=x.dtype)
                        cmask = iota < kv
                        cidx = jnp.where(cmask, c0 + iota, sp.n)
                        x = x.at[cidx].add(
                            -u * cmask[..., None].astype(x.dtype),
                            mode="drop")
                    s, e = int(sol_ptr[lvl]), int(sol_ptr[lvl + 1])
                    if e > s:
                        x = solve_batch(pool, args, x,
                                        args["bsol_blk"][s:e],
                                        args["bsol_rows"][s:e],
                                        args["bsol_k"][s:e], True)
            return x

        return run

    # ------------------------------------------------------------------ #
    def fwd(self, pool, x):
        return self._fwd(pool, jnp.asarray(x, self.dtype), self._args)

    def bwd(self, pool, x):
        return self._bwd(pool, jnp.asarray(x, self.dtype), self._args)
