"""Scan-based factorization executor (bucketed level schedule).

Functionally identical to :mod:`spllt_tpu.numeric.factor` but executes the
level schedule as a handful of ``lax.scan`` loops over level buckets (see
plan/buckets.py), giving O(#buckets) XLA call sites instead of
O(#levels) — compile time becomes independent of tree depth.  This is the
production executor; the unrolled one remains for debugging.

The pool carries one extra scratch block (id = nblocks) absorbing padded
no-op tasks.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..plan.buckets import make_buckets, pad_tables
from .factor import _bmm_nt, _potrf_batch_blocked, _trsm_batch, _updbt

__all__ = ["ScanFactorExecutor"]

_I32MAX = np.int64(2**31 - 1)


class ScanFactorExecutor:
    """Compiles the bucketed level schedule for one FactorPlan."""

    def __init__(self, fp, dtype=jnp.float32, matmul_precision="highest",
                 alpha: float = 1.6, _skip: frozenset = frozenset()):
        self._skip = _skip      # phase names to drop (timing diagnostics)
        self.fp = fp
        self.nb = fp.nb
        self.dtype = dtype
        self.precision = matmul_precision
        self.scratch = fp.nblocks           # extra block id
        counts = {
            "potrf": np.diff(fp.potrf_ptr)[:fp.nlevels + 1],
            "trsm": np.diff(fp.trsm_ptr)[:fp.nlevels + 1],
            "syrk": np.diff(fp.syrk_ptr)[:fp.nlevels + 1],
            "updbt": np.diff(fp.updbt_ptr)[:fp.nlevels + 1],
        }
        spans = make_buckets(counts, fp.nlevels, alpha=alpha)
        fields = {
            "potrf": {"blk": fp.potrf_blk, "k": fp.potrf_k},
            "trsm": {"diag": fp.trsm_diag, "dst": fp.trsm_dst,
                     "k": fp.trsm_k},
            "syrk": {"i": fp.syrk_src_i, "j": fp.syrk_src_j,
                     "dst": fp.syrk_dst},
            "updbt": {"dst": fp.updbt_dst, "mr": fp.updbt_mr,
                      "mc": fp.updbt_mc, "svp": fp.updbt_svp,
                      "c": fp.updbt_c},
        }
        ptrs = {"potrf": fp.potrf_ptr, "trsm": fp.trsm_ptr,
                "syrk": fp.syrk_ptr, "updbt": fp.updbt_ptr}
        s = self.scratch
        pad_values = {
            "potrf": {"blk": s, "k": 0},
            "trsm": {"diag": s, "dst": s, "k": 0},
            "syrk": {"i": s, "j": s, "dst": s},
            "updbt": {"dst": s, "mr": 0, "mc": 0, "svp": 0, "c": 0},
        }
        self.buckets = [pad_tables(sp, fields, ptrs, pad_values)
                        for sp in spans]
        maps_ext = np.concatenate(
            [fp.maps, np.full((1, fp.nb), -1, fp.maps.dtype)], axis=0)
        self._bucket_tables = [
            {k: jnp.asarray(np.minimum(v, _I32MAX), dtype=jnp.int32)
             for k, v in b.tables.items()}
            for b in self.buckets
        ]
        self.maps = jnp.asarray(maps_ext, dtype=jnp.int32)
        blk_n_ext = np.concatenate([fp.blk_n, [fp.nb]])
        self.blk_n = jnp.asarray(blk_n_ext, dtype=jnp.int32)
        self.srcvec = jnp.asarray(fp.srcvec, dtype=jnp.int32)
        # static per-bucket max source width of the width-fused updbt gather
        self._bucket_cmax = [
            int(b.tables["updbt_c"].max()) if "updbt_c" in b.tables
            and b.tables["updbt_c"].size else 0
            for b in self.buckets
        ]
        self._fn = jax.jit(self._build(), donate_argnums=(0,))

    # ------------------------------------------------------------------ #
    def _build(self):
        nb = self.nb
        prec = self.precision

        def level_body(carry, tb, cmax):
            pool, maps, blk_n, srcvec = carry
            # each phase runs under a stable named scope ("updbt", "syrk",
            # "potrf", "trsm") so profiler traces attribute device time
            if "updbt_dst" in tb and tb["updbt_dst"].shape[0] > 0 \
                    and cmax > 0 and "updbt" not in self._skip:
                with jax.named_scope("updbt"):
                    pool = _updbt(pool, maps, blk_n, srcvec,
                                  tb["updbt_dst"], tb["updbt_mr"],
                                  tb["updbt_mc"], tb["updbt_svp"],
                                  tb["updbt_c"], cmax, prec)
            if "syrk_i" in tb and tb["syrk_i"].shape[0] > 0 \
                    and "syrk" not in self._skip:
                with jax.named_scope("syrk"):
                    u = _bmm_nt(pool[tb["syrk_i"]], pool[tb["syrk_j"]],
                                prec)
                    pool = pool.at[tb["syrk_dst"]].add(-u)
            if "potrf_blk" in tb and tb["potrf_blk"].shape[0] > 0 \
                    and "potrf" not in self._skip:
                with jax.named_scope("potrf"):
                    blk = tb["potrf_blk"]
                    out = _potrf_batch_blocked(pool[blk], tb["potrf_k"], nb,
                                               precision=prec)
                    pool = pool.at[blk].set(out)
            if "trsm_diag" in tb and tb["trsm_diag"].shape[0] > 0 \
                    and "trsm" not in self._skip:
                with jax.named_scope("trsm"):
                    out = _trsm_batch(pool[tb["trsm_diag"]],
                                      pool[tb["trsm_dst"]], tb["trsm_k"], nb)
                    pool = pool.at[tb["trsm_dst"]].set(out)
            return (pool, maps, blk_n, srcvec), None

        def run(pool_ext, maps, blk_n, srcvec, bucket_tables):
            carry = (pool_ext, maps, blk_n, srcvec)
            for bi, bt in enumerate(bucket_tables):
                # drop zero-width kinds for this bucket (static)
                tb = {k: v for k, v in bt.items() if v.shape[1] > 0}
                if not tb:
                    continue  # bucket fully absorbed (e.g. by coarse phase)
                cmax = self._bucket_cmax[bi]
                carry, _ = jax.lax.scan(
                    lambda c, t, _cm=cmax: level_body(c, t, _cm),
                    carry, tb)
            pool = carry[0]
            # in-graph positive-definiteness flag (NaNs appear on failure);
            # an eager post-hoc check on the big pool is host-round-trip
            # heavy, so compute the tiny flag here
            notpos = jnp.isnan(jnp.sum(pool[:, 0, 0]))
            return pool, notpos

        return run

    # ------------------------------------------------------------------ #
    def __call__(self, pool):
        """pool: [nblocks+1, nb, nb] with trailing scratch block (see
        assemble_*); factored in place, scratch kept zero.  Returns
        (pool, not_posdef_flag)."""
        pool = jnp.asarray(pool, dtype=self.dtype)
        assert pool.shape[0] == self.fp.nblocks + 1, \
            "pool must include the trailing scratch block"
        return self._fn(pool, self.maps, self.blk_n, self.srcvec,
                        self._bucket_tables)
