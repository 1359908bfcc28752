"""Sequential NumPy execution of the factorization plan (the "STF mode").

The reference's STF build runs every task inline in submission order and is
the de-facto deterministic oracle used to debug the parallel runtimes
(/root/reference/src/spllt_stf_mod.F90, SURVEY §4).  This module plays the
same role: it executes the *same* FactorPlan level by level with float64
NumPy kernels, so the batched device path can be validated task-for-task.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as sla

from ..errors import NotPositiveDefiniteError

__all__ = ["factorize_np"]


def factorize_np(pool: np.ndarray, fp) -> np.ndarray:
    """Factorize the assembled pool in place (float64).  Returns pool."""
    nb = fp.nb
    poolf = pool.reshape(-1, nb)
    iota = np.arange(nb)
    for lvl in range(1, fp.nlevels + 1):
        # ---- intra-node updates (update_block: dsyrk/dgemm analogue) ---- #
        for t in range(fp.syrk_ptr[lvl], fp.syrk_ptr[lvl + 1]):
            si, sj, dst = fp.syrk_src_i[t], fp.syrk_src_j[t], fp.syrk_dst[t]
            pool[dst] -= pool[si] @ pool[sj].T
        # ---- inter-node updates (update_between analogue, width-fused) -- #
        for t in range(fp.updbt_ptr[lvl], fp.updbt_ptr[lvl + 1]):
            dst = fp.updbt_dst[t]
            pr = fp.maps[fp.updbt_mr[t]]
            pc = fp.maps[fp.updbt_mc[t]]
            svp = fp.updbt_svp[t]
            cw = fp.updbt_c[t]
            vr = pr >= 0
            vc = (pc >= 0) & (iota < fp.blk_n[dst])
            r = np.zeros((nb, cw * nb))
            c = np.zeros((nb, cw * nb))
            for kb in range(cw):
                base = fp.srcvec[svp + kb] * nb
                r[vr, kb * nb:(kb + 1) * nb] = poolf[base + pr[vr]]
                c[vc, kb * nb:(kb + 1) * nb] = poolf[base + pc[vc]]
            pool[dst] -= r @ c.T
        # ---- potrf (factor_diag_block: potrf + trailing trsm) ----------- #
        for t in range(fp.potrf_ptr[lvl], fp.potrf_ptr[lvl + 1]):
            blk, k = fp.potrf_blk[t], fp.potrf_k[t]
            tile = pool[blk]
            d = tile[:k, :k]
            d = np.tril(d) + np.tril(d, -1).T
            try:
                ld = np.linalg.cholesky(d)
            except np.linalg.LinAlgError as e:
                raise NotPositiveDefiniteError(
                    f"cholesky failed on block {blk}") from e
            out = np.zeros_like(tile)
            out[:k, :k] = ld
            b = tile[k:, :k]
            out[k:, :k] = sla.solve_triangular(ld, b.T, lower=True).T
            pool[blk] = out
        # ---- trsm (solve_block analogue) -------------------------------- #
        for t in range(fp.trsm_ptr[lvl], fp.trsm_ptr[lvl + 1]):
            diag, dst, k = fp.trsm_diag[t], fp.trsm_dst[t], fp.trsm_k[t]
            ld = pool[diag][:k, :k]
            out = np.zeros_like(pool[dst])
            out[:, :k] = sla.solve_triangular(
                ld, pool[dst][:, :k].T, lower=True).T
            pool[dst] = out
    return pool
