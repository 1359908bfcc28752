"""Scan-based solve executor (bucketed fwd/bwd level schedules).

Same math as :class:`spllt_tpu.numeric.solve.SolveExecutor` but executed
as a few ``lax.scan`` loops over level buckets — one triangular-solve call
site per bucket instead of per level (compile time independent of tree
depth).  Padded tasks hit the scratch block (pool id nblocks) and the rhs
dump row (x row n) with zero values.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..plan.buckets import make_buckets, pad_tables

__all__ = ["ScanSolveExecutor"]


class ScanSolveExecutor:
    def __init__(self, sp, nrhs: int, dtype=jnp.float32,
                 matmul_precision="highest", alpha: float = 1.6,
                 _skip: frozenset = frozenset()):
        self._skip = _skip      # phase names to drop (timing diagnostics)
        self.sp = sp
        self.nb = sp.nb
        self.n = sp.n
        self.nrhs = nrhs
        self.dtype = dtype
        self.precision = matmul_precision
        nb = sp.nb
        pad_rows = np.full(nb, sp.n, dtype=np.int64)

        def prep(direction):
            if direction == "fwd":
                counts = {"sol": np.diff(sp.fsol_ptr),
                          "upd": np.diff(sp.fupd_ptr)}
                nlev = sp.nlevels_fwd
                fields = {
                    "sol": {"blk": sp.fsol_blk, "rows": sp.fsol_rows,
                            "k": sp.fsol_k},
                    "upd": {"blk": sp.fupd_blk, "rows": sp.fupd_rows,
                            "c0": sp.fupd_c0, "k": sp.fupd_k},
                }
                ptrs = {"sol": sp.fsol_ptr, "upd": sp.fupd_ptr}
            else:
                counts = {"sol": np.diff(sp.bsol_ptr),
                          "upd": np.diff(sp.bupd_ptr)}
                nlev = sp.nlevels_bwd
                fields = {
                    "sol": {"blk": sp.bsol_blk, "rows": sp.bsol_rows,
                            "k": sp.bsol_k},
                    "upd": {"blk": sp.bupd_blk, "rows": sp.bupd_rows,
                            "c0": sp.bupd_c0, "k": sp.bupd_k},
                }
                ptrs = {"sol": sp.bsol_ptr, "upd": sp.bupd_ptr}
            # scratch tile: blocks are indexed into pool_ext [nblocks+1]
            pad_values = {
                "sol": {"blk": -1, "rows": pad_rows, "k": 0},
                "upd": {"blk": -1, "rows": pad_rows, "c0": 0, "k": 0},
            }
            spans = make_buckets(counts, nlev, alpha=alpha)
            return [pad_tables(s, fields, ptrs, pad_values) for s in spans]

        self._fwd_buckets = prep("fwd")
        self._bwd_buckets = prep("bwd")

        def to_dev(buckets):
            return [{k: jnp.asarray(np.maximum(v, -1), dtype=jnp.int32)
                     for k, v in b.tables.items()} for b in buckets]

        self._fwd_tables = to_dev(self._fwd_buckets)
        self._bwd_tables = to_dev(self._bwd_buckets)
        self._fwd_fn = jax.jit(self._build(True), donate_argnums=(1,))
        self._bwd_fn = jax.jit(self._build(False), donate_argnums=(1,))
        # fused fwd+bwd (job=0): one device program
        fwd_run, bwd_run = self._build(True), self._build(False)

        def full_run(pool_ext, x, ftabs, btabs):
            return bwd_run(pool_ext, fwd_run(pool_ext, x, ftabs), btabs)

        self._full_fn = jax.jit(full_run, donate_argnums=(1,))

    # ------------------------------------------------------------------ #
    def _build(self, forward: bool):
        sp = self.sp
        nb = self.nb
        n = self.n
        prec = self.precision

        def sol_op(pool, x, tb):
            blk = tb["sol_blk"]           # [K], -1 = pad → scratch
            rows = tb["sol_rows"]         # [K, nb]
            kvec = tb["sol_k"]
            tiles = pool[blk]             # pad: pool[-1] = scratch zeros
            rowi = jax.lax.broadcasted_iota(jnp.int32, (1, nb, nb), 1)
            coli = jax.lax.broadcasted_iota(jnp.int32, (1, nb, nb), 2)
            slot = jax.lax.broadcasted_iota(jnp.int32, (1, nb), 1)
            k = kvec[:, None, None]
            rvalid = (rows < n)[..., None].astype(x.dtype)
            z = x[rows] * rvalid
            m = tiles + ((rowi == coli) & (rowi >= k)).astype(tiles.dtype)
            y = jax.lax.linalg.triangular_solve(
                m, z, left_side=True, lower=True, transpose_a=not forward)
            colmask = slot < kvec[:, None]
            rows_set = jnp.where(colmask, rows, n)
            x = x.at[rows_set].set(y * colmask[..., None].astype(x.dtype),
                                   mode="drop")
            if forward:
                bmask = (~colmask)[..., None].astype(x.dtype) * rvalid
                rows_add = jnp.where(colmask, n, rows)
                x = x.at[rows_add].add((y - z) * bmask, mode="drop")
            return x

        def upd_op(pool, x, tb, iota):
            blk = tb["upd_blk"]
            rows = tb["upd_rows"]
            c0 = tb["upd_c0"][:, None]
            kv = tb["upd_k"][:, None]
            cmask = iota < kv
            cidx = jnp.where(cmask, c0 + iota, n)
            if forward:
                y = x[cidx] * cmask[..., None].astype(x.dtype)
                u = jax.lax.dot_general(
                    pool[blk], y, (((2,), (1,)), ((0,), (0,))),
                    precision=prec, preferred_element_type=x.dtype)
                rmask = (rows < n)[..., None].astype(x.dtype)
                x = x.at[rows].add(-u * rmask, mode="drop")
            else:
                rmask = (rows < n)[..., None].astype(x.dtype)
                z = x[rows] * rmask
                u = jax.lax.dot_general(
                    pool[blk], z, (((1,), (1,)), ((0,), (0,))),
                    precision=prec, preferred_element_type=x.dtype)
                x = x.at[cidx].add(-u * cmask[..., None].astype(x.dtype),
                                   mode="drop")
            return x

        def run(pool_ext, x, bucket_tables):
            iota = jax.lax.broadcasted_iota(jnp.int32, (1, nb), 1)
            for bt in bucket_tables:
                has_sol = "sol_blk" in bt and bt["sol_blk"].shape[1] > 0 \
                    and "sol" not in self._skip
                has_upd = "upd_blk" in bt and bt["upd_blk"].shape[1] > 0 \
                    and "upd" not in self._skip
                tb_used = {k: v for k, v in bt.items()
                           if v.shape[1] > 0}

                def body(x, tb):
                    if forward:
                        if has_sol:
                            x = sol_op(pool_ext, x, tb)
                        if has_upd:
                            x = upd_op(pool_ext, x, tb, iota)
                    else:
                        if has_upd:
                            x = upd_op(pool_ext, x, tb, iota)
                        if has_sol:
                            x = sol_op(pool_ext, x, tb)
                    return x, None

                x, _ = jax.lax.scan(body, x, tb_used)
            return x

        return run

    # ------------------------------------------------------------------ #
    def _build_refined(self, refine: int):
        """Whole refined solve as ONE device program: f32 fwd+bwd solve,
        float64 ELL-SpMV residual (numeric/spmv.py), f32 correction solve,
        f64 accumulation — replaces `refine` host round-trip pairs."""
        from .spmv import spmv

        fwd_run, bwd_run = self._build(True), self._build(False)
        n = self.n

        # the refinement loop is a lax.fori_loop starting from x=0 (the
        # first iteration's residual is b, i.e. the plain solve), so the
        # fwd+bwd solve body is traced and compiled exactly ONCE —
        # unrolling `refine+1` copies made XLA:CPU compile times explode
        # (>15 min at refine=3 on a 500-task plan)
        def run(pool_ext, b64, ftabs, btabs, vals64, idx):
            def full(z):
                return bwd_run(pool_ext,
                               fwd_run(pool_ext, z, ftabs), btabs)

            def body(_, x64):
                r = b64[:n] - spmv(vals64, idx, x64)
                rp = jnp.concatenate(
                    [r, jnp.zeros((1, r.shape[1]), r.dtype)])
                return x64 + full(rp.astype(self.dtype)).astype(
                    jnp.float64)

            return jax.lax.fori_loop(
                0, refine + 1, body,
                jnp.zeros(b64.shape, jnp.float64))

        return jax.jit(run)

    def full_refined(self, pool, b64, vals64, idx, refine: int):
        """Refined A x = b; requires jax x64 mode.  ``b64`` is the
        permuted rhs [n+1, nrhs] float64; returns float64 [n+1, nrhs]."""
        fn = getattr(self, "_refined_fns", None)
        if fn is None:
            self._refined_fns = {}
        f = self._refined_fns.get(refine)
        if f is None:
            f = self._build_refined(refine)
            self._refined_fns[refine] = f
        return f(jnp.asarray(pool, self.dtype), jnp.asarray(b64),
                 self._fwd_tables, self._bwd_tables, vals64, idx)

    # ------------------------------------------------------------------ #
    # pool must include the trailing scratch block ([nblocks+1, nb, nb],
    # see assemble_*); pad tasks index it as block -1 — no copies made.

    def fwd(self, pool, x):
        return self._fwd_fn(jnp.asarray(pool, self.dtype),
                            jnp.asarray(x, self.dtype), self._fwd_tables)

    def bwd(self, pool, x):
        return self._bwd_fn(jnp.asarray(pool, self.dtype),
                            jnp.asarray(x, self.dtype), self._bwd_tables)

    def full(self, pool, x):
        """Fused L y = x; Lᵀ z = y (job=0) in one compiled program."""
        return self._full_fn(jnp.asarray(pool, self.dtype),
                             jnp.asarray(x, self.dtype),
                             self._fwd_tables, self._bwd_tables)
