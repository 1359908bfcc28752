"""Uniform nb-tiling of the supernodal factor into a flat block pool.

Replaces the reference's block partition (per-node nb blocking,
/root/reference/src/spllt_analyse_mod.F90:305-469) and value map
(``spllt_make_map``/``spllt_lcol_map``, :1033-1171) with a device layout: every
block is an nb×nb tile of a flat pool ``pool[nblocks, nb, nb]`` (static
shape).  Node rows are tiled with the SAME nb partition as
columns, so the diagonal tile of block-column jb is row-tile jb and holds
[[chol(D), 0], [B·chol(D)^{-T}, 0]] after factorization — rectangular diag
blocks (reference ``spllt_factor_diag_block`` potrf+trsm,
/root/reference/src/spllt_kernels_mod.F90:1168-1189) need no special tile.

Padding invariant: for every tile, columns >= blk_n and rows >= blk_m are
kept zero by the numeric kernels (masked), so updates may consume full
tiles without validity bookkeeping.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["BlockPlan", "build_block_plan", "blk_id"]


@dataclasses.dataclass
class BlockPlan:
    nb: int
    nnodes: int
    nblocks: int
    # per node ------------------------------------------------------------
    node_sa: np.ndarray       # first column
    node_en: np.ndarray       # last column (inclusive)
    node_rptr: np.ndarray     # [nnodes+1] into rows
    rows: np.ndarray          # concatenated sorted global row lists
    node_ntiles: np.ndarray   # number of row tiles
    node_nctiles: np.ndarray  # number of column tiles
    node_blk_ptr: np.ndarray  # [nnodes+1] first block id of node
    # per block -----------------------------------------------------------
    blk_node: np.ndarray
    blk_ib: np.ndarray        # row-tile index within node
    blk_jb: np.ndarray        # col-tile index within node
    blk_m: np.ndarray         # valid rows
    blk_n: np.ndarray         # valid cols
    # assembly map (lmap analogue): one entry per nonzero of permuted lower A
    asm_rowflat: np.ndarray   # blk*nb + local row   (int32, fits 2^31 rows)
    asm_col: np.ndarray       # local col            (int32)

    def blk_of(self, nd: int, ib: int, jb: int) -> int:
        return blk_id(self, nd, ib, jb)


def blk_id(plan: BlockPlan, nd: int, ib, jb):
    """Global block id of tile (ib, jb) of node nd (vectorized ok).

    Blocks of a node are stored column-major by block-column: bcol jb holds
    tiles jb..ntiles-1 (mirrors the reference's contiguous per-node block
    ids, spllt_analyse_mod.F90:404-469).
    """
    t = plan.node_ntiles[nd]
    off = jb * t - (jb * (jb - 1)) // 2
    return plan.node_blk_ptr[nd] + off + (ib - jb)


def build_block_plan(symb, nb: int) -> BlockPlan:
    """Tile the supernode forest and build the assembly map."""
    forest = symb.forest
    nnodes = forest.nnodes
    node_sa = forest.sa.copy()
    node_en = forest.en.copy()
    node_rptr = forest.rptr.copy()
    rows = forest.rows.copy()

    m_per = np.diff(node_rptr)
    w_per = node_en - node_sa + 1
    node_ntiles = (m_per + nb - 1) // nb
    node_nctiles = (w_per + nb - 1) // nb
    blocks_per_node = (
        node_nctiles * node_ntiles
        - (node_nctiles * (node_nctiles - 1)) // 2
    )
    node_blk_ptr = np.zeros(nnodes + 1, dtype=np.int64)
    node_blk_ptr[1:] = np.cumsum(blocks_per_node)
    nblocks = int(node_blk_ptr[-1])

    blk_node = np.empty(nblocks, dtype=np.int64)
    blk_ib = np.empty(nblocks, dtype=np.int64)
    blk_jb = np.empty(nblocks, dtype=np.int64)
    blk_m = np.empty(nblocks, dtype=np.int64)
    blk_n = np.empty(nblocks, dtype=np.int64)
    for nd in range(nnodes):
        t = int(node_ntiles[nd])
        c = int(node_nctiles[nd])
        m = int(m_per[nd])
        w = int(w_per[nd])
        b = int(node_blk_ptr[nd])
        for jb in range(c):
            kn = min(nb, w - jb * nb)
            for ib in range(jb, t):
                blk_node[b] = nd
                blk_ib[b] = ib
                blk_jb[b] = jb
                blk_m[b] = min(nb, m - ib * nb)
                blk_n[b] = kn
                b += 1

    plan = BlockPlan(
        nb=nb, nnodes=nnodes, nblocks=nblocks,
        node_sa=node_sa, node_en=node_en, node_rptr=node_rptr, rows=rows,
        node_ntiles=node_ntiles, node_nctiles=node_nctiles,
        node_blk_ptr=node_blk_ptr,
        blk_node=blk_node, blk_ib=blk_ib, blk_jb=blk_jb,
        blk_m=blk_m, blk_n=blk_n,
        asm_rowflat=np.empty(0, np.int32), asm_col=np.empty(0, np.int32),
    )

    # ------------------- assembly map (lmap analogue) -------------------- #
    a = symb.a_perm
    n = a.n
    col_node = np.empty(n, dtype=np.int64)
    for nd in range(nnodes):
        col_node[node_sa[nd]:node_en[nd] + 1] = nd
    cols_of = np.repeat(np.arange(n, dtype=np.int64), np.diff(a.colptr))
    r = a.rowind
    c = cols_of
    nd_of = col_node[c]
    lc = c - node_sa[nd_of]
    jb = lc // nb
    cc = lc % nb
    # position of r within the owner node's row list; nd_of is
    # non-decreasing (columns sorted, nodes ordered by sa) so entries of a
    # node form one contiguous slice — no per-node masking
    p = np.empty(len(r), dtype=np.int64)
    bounds = np.searchsorted(nd_of, np.arange(nnodes + 1, dtype=np.int64))
    for nd in range(nnodes):
        s_, e_ = bounds[nd], bounds[nd + 1]
        if e_ == s_:
            continue
        nrows = rows[node_rptr[nd]:node_rptr[nd + 1]]
        pos = np.searchsorted(nrows, r[s_:e_])
        if __debug__:
            assert np.all(nrows[pos] == r[s_:e_]), \
                "row missing from structure"
        p[s_:e_] = pos
    ib = p // nb
    rr = p % nb
    blk = blk_id(plan, nd_of, ib, jb)
    plan.asm_rowflat = (blk * nb + rr).astype(np.int32)
    plan.asm_col = cc.astype(np.int32)
    return plan
