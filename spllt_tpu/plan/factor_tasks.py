"""Static factorization DAG: task construction + ASAP level schedule.

This module replaces the reference's dynamic task runtimes.  Where SpLLT
submits ``factorize_block`` / ``solve_block`` / ``update_block`` /
``update_between`` tasks to OpenMP/StarPU/PaRSEC with data dependencies
(/root/reference/src/spllt_factorization_task_mod.F90, factorize.jdf), we
enumerate the same four task kinds at plan time, compute an ASAP level for
every task from the block dependence structure, and bucket tasks by
(level, kind).  Execution is then a statically compiled sequence of batched
same-shape kernels — one batch per (level, kind) — under a single jit.

Level rule (phase-aware): within a level the executor applies the kinds in
the fixed order update → potrf → trsm, so a dependency that follows this
phase order may share a level — only update tasks (which consume trsm
outputs) must start a new level:
  update(… → t):   lvl = max(fact[sources]) + 1;       upd_level[t] ⊔= lvl
  potrf(d):        lvl = max(upd_level[d], 1);         fact_level[d] = lvl
  trsm(d → i):     lvl = max(fact[d], upd[i], 1);      fact_level[i] = lvl
(updates into the same target commute — executed as scatter-adds).  This
collapses the naive 3-levels-per-block-column chain to ~1 level per block
column along the critical path.

Inter-node updates (``update_between``) use deduplicated position-map
tables: for (source node s, ancestor a, tile tb of a) one int32[nb] vector
``map[t] = position of a.rows[tb·nb+t] in s.rows (or -1)`` — the analogue
of the reference's row/col scatter lists
(``spllt_update_between_compute_map``,
/root/reference/src/spllt_kernels_mod.F90:1606-1723) at a fraction of the
memory.  Because every between-update source row lies below the source
node's diagonal (position p >= ncols > kb·nb for every block column kb),
the per-block-column tasks of the reference fuse into ONE task per
(source node → destination tile pair) contracting over the node's full
column width: a task stores (dest, map_row_id, map_col_id, srcvec offset,
ncoltiles), where the srcvec table gives the per-block-column flat row
bases.  This cuts task and scatter counts by the node width and feeds
[nb, C·nb] × [C·nb, nb] GEMMs.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .blocking import BlockPlan, blk_id

__all__ = ["FactorPlan", "build_factor_plan"]


@dataclasses.dataclass
class FactorPlan:
    nb: int
    nblocks: int
    nlevels: int
    # potrf ---------------------------------------------------------------
    potrf_ptr: np.ndarray
    potrf_blk: np.ndarray
    potrf_k: np.ndarray
    # trsm ----------------------------------------------------------------
    trsm_ptr: np.ndarray
    trsm_diag: np.ndarray
    trsm_dst: np.ndarray
    trsm_k: np.ndarray
    # intra-node update (syrk/gemm) ---------------------------------------
    syrk_ptr: np.ndarray
    syrk_src_i: np.ndarray
    syrk_src_j: np.ndarray
    syrk_dst: np.ndarray
    # inter-node update (update_between, width-fused) ---------------------
    updbt_ptr: np.ndarray
    updbt_dst: np.ndarray
    updbt_mr: np.ndarray
    updbt_mc: np.ndarray
    updbt_svp: np.ndarray     # offset into srcvec (per-node col-tile bases)
    updbt_c: np.ndarray       # number of column tiles of the source node
    srcvec: np.ndarray        # flat row base per (node, kb): srcbase values
    srcvec_node: np.ndarray   # source node of each srcvec entry
    maps: np.ndarray          # [nmaps, nb] int32, -1 = invalid slot
    # masks ---------------------------------------------------------------
    blk_n: np.ndarray         # int32[nblocks]
    num_tasks: int = 0
    # dense coarse-subtree phase (see analyse/coarsen.py); list of per-
    # spad-bucket dicts or None when coarsening is off
    dense: list | None = None

    def level_counts(self) -> dict:
        return {
            "potrf": np.diff(self.potrf_ptr),
            "trsm": np.diff(self.trsm_ptr),
            "syrk": np.diff(self.syrk_ptr),
            "updbt": np.diff(self.updbt_ptr),
        }


def _bucket(levels, nlevels, *fields):
    """Sort task tuples by level; return (ptr, sorted fields)."""
    levels = np.asarray(levels, dtype=np.int64)
    order = np.argsort(levels, kind="stable")
    ptr = np.zeros(nlevels + 2, dtype=np.int64)
    np.add.at(ptr, levels + 1, 1)
    ptr = np.cumsum(ptr)
    out = [np.asarray(f)[order] if len(order) else np.asarray(f)
           for f in fields]
    return ptr, out


def build_factor_plan(symb, plan: BlockPlan, coarse=None) -> FactorPlan:
    nb = plan.nb
    # native fast path (non-coarse): the per-node Python loops below
    # dominate plan build at scale (128³ Poisson: minutes); the C++
    # twin in native/symbolic.cpp emits identical task arrays
    if coarse is None:
        from ..analyse.native import native_factor_plan_or_none
        res = native_factor_plan_or_none(symb.forest.sparent, plan)
        if res is not None:
            maps = (res["maps"] if len(res["maps"])
                    else np.empty((1, nb), np.int32))
            return _finish_plan(
                plan, res["potrf"], res["trsm"], res["syrk"],
                res["updbt"][:, 0], [res["updbt"][:, j]
                                     for j in range(1, 6)],
                res["srcvec"], res["srcvec_node"], maps, None)
    nnodes = plan.nnodes
    fact_level = np.zeros(plan.nblocks, dtype=np.int64)
    upd_level = np.zeros(plan.nblocks, dtype=np.int64)
    sub_of = (coarse.sub_of_node if coarse is not None
              else np.full(nnodes, -1, dtype=np.int64))

    potrf = []   # (lvl, blk, k)
    trsm = []    # (lvl, diag, dst, k)
    syrk = []    # (lvl, src_i, src_j, dst)
    # updbt accumulated as per-(node, ancestor) ARRAYS (vectorized pair
    # emission — the per-task python tuples dominated plan build at 64³)
    updbt_lvl, updbt_dst, updbt_mr = [], [], []
    updbt_mc, updbt_svp, updbt_cc = [], [], []
    srcvec: list[int] = []    # per (node, kb) source row base, node-major
    srcvec_node: list[int] = []

    map_registry: dict[bytes, int] = {}
    map_list: list[np.ndarray] = []

    def register_map(vec: np.ndarray) -> int:
        key = vec.tobytes()
        mid = map_registry.get(key)
        if mid is None:
            mid = len(map_list)
            map_registry[key] = mid
            map_list.append(vec)
        return mid

    sparent = symb.forest.sparent
    rows_all = plan.rows
    rptr = plan.node_rptr

    for nd in range(nnodes):
        T = int(plan.node_ntiles[nd])
        C = int(plan.node_nctiles[nd])
        b0 = int(plan.node_blk_ptr[nd])

        def bid(ib, jb, _b0=b0, _T=T):
            return _b0 + jb * _T - (jb * (jb - 1)) // 2 + (ib - jb)

        in_coarse = sub_of[nd] != -1
        # ---- intra-node right-looking factorization ---------------------- #
        if in_coarse:
            # blocks are produced by the batched dense subtree phase
            # (scatter-back completes before level 1)
            fact_level[plan.node_blk_ptr[nd]:plan.node_blk_ptr[nd + 1]] = 1
        else:
            for kb in range(C):
                d = bid(kb, kb)
                kcols = int(plan.blk_n[d])
                lvl = max(upd_level[d], 1)
                fact_level[d] = lvl
                potrf.append((lvl, d, kcols))
                for ib in range(kb + 1, T):
                    t = bid(ib, kb)
                    lvl = max(fact_level[d], upd_level[t], 1)
                    fact_level[t] = lvl
                    trsm.append((lvl, d, t, kcols))
                for jb2 in range(kb + 1, C):
                    sj = bid(jb2, kb)
                    for ib2 in range(jb2, T):
                        si = bid(ib2, kb)
                        dst = bid(ib2, jb2)
                        lvl = max(fact_level[si], fact_level[sj]) + 1
                        syrk.append((lvl, si, sj, dst))
                        upd_level[dst] = max(upd_level[dst], lvl)

        # ---- inter-node updates into ancestors --------------------------- #
        # All between-update source rows are below the node's diagonal
        # (position >= ncols), so the contraction runs over the node's full
        # column width: one task per (node → ancestor dest tile).
        svp0 = len(srcvec)
        for kb in range(C):
            srcvec.append(b0 + kb * T - (kb * (kb - 1)) // 2 - kb)
            srcvec_node.append(nd)
        nrows = rows_all[rptr[nd]:rptr[nd + 1]]
        anc = int(sparent[nd])
        while anc != -1:
            lo = int(np.searchsorted(nrows, plan.node_sa[anc]))
            if lo >= len(nrows):
                break
            if in_coarse and sub_of[anc] == sub_of[nd]:
                # destination lives inside the same dense subtree front
                anc = int(sparent[anc])
                continue
            hi = int(np.searchsorted(nrows, plan.node_en[anc] + 1))
            if hi > lo:
                s_glob = nrows[lo:]
                a_rows = rows_all[rptr[anc]:rptr[anc + 1]]
                pos_a = np.searchsorted(a_rows, s_glob)
                if __debug__:
                    assert np.all(a_rows[pos_a] == s_glob), \
                        "ancestor row structure violated"
                p_src = np.arange(lo, len(nrows), dtype=np.int64)
                tiles_a = pos_a // nb
                slots_a = pos_a % nb
                # tiles_a is non-decreasing (sorted positions) — find
                # the touched tiles by run boundaries, not np.unique
                cuts = np.flatnonzero(np.diff(tiles_a)) + 1
                tb_bounds = np.concatenate(
                    [[0], cuts, [len(tiles_a)]]).astype(np.int64)
                touched = tiles_a[tb_bounds[:-1]]
                ntt = len(touched)
                map_arr = np.empty(ntt, dtype=np.int64)
                # deepest source level feeding each dest tile: the used
                # source tiles' last-column trsms
                src_tile = p_src // nb
                flev = fact_level[bid(src_tile,
                                      np.minimum(src_tile, C - 1))]
                fmax_arr = np.maximum.reduceat(flev, tb_bounds[:-1])
                vecs = np.full((ntt, nb), -1, dtype=np.int32)
                seg_idx = np.repeat(np.arange(ntt),
                                    np.diff(tb_bounds))
                vecs[seg_idx, slots_a] = p_src
                for i_t in range(ntt):
                    map_arr[i_t] = register_map(vecs[i_t])
                # column-role tiles: touched tiles whose segment starts
                # before the ancestor-column part ends
                ncols_part = hi - lo
                ncol_t = int(np.searchsorted(tb_bounds[:-1], ncols_part,
                                             side="left"))
                aT = int(plan.node_ntiles[anc])
                a0 = int(plan.node_blk_ptr[anc])
                # vectorized (jbt <= ibt) pair emission
                jj, ii = np.meshgrid(np.arange(ncol_t), np.arange(ntt),
                                     indexing="ij")
                sel = ii >= jj
                jj, ii = jj[sel], ii[sel]
                jbt = touched[jj]
                ibt = touched[ii]
                lvl_v = 1 + np.maximum(fmax_arr[ii], fmax_arr[jj])
                dst_v = a0 + jbt * aT - (jbt * (jbt - 1)) // 2 \
                    + (ibt - jbt)
                updbt_lvl.append(lvl_v)
                updbt_dst.append(dst_v)
                updbt_mr.append(map_arr[ii])
                updbt_mc.append(map_arr[jj])
                updbt_svp.append(np.full(len(dst_v), svp0, np.int64))
                updbt_cc.append(np.full(len(dst_v), C, np.int64))
                np.maximum.at(upd_level, dst_v, lvl_v)
            anc = int(sparent[anc])

    ub_lvl = (np.concatenate(updbt_lvl) if updbt_lvl
              else np.empty(0, np.int64))
    ub = [np.concatenate(x) if x else np.empty(0, np.int64)
          for x in (updbt_dst, updbt_mr, updbt_mc, updbt_svp, updbt_cc)]
    pt = np.asarray(potrf, np.int64).reshape(-1, 3)
    tr = np.asarray(trsm, np.int64).reshape(-1, 4)
    sy = np.asarray(syrk, np.int64).reshape(-1, 4)
    maps = (np.stack(map_list) if map_list
            else np.empty((1, nb), dtype=np.int32))
    dense = (_build_dense_phase(symb, plan, coarse)
             if coarse is not None and coarse.nsub > 0 else None)
    return _finish_plan(plan, pt, tr, sy, ub_lvl, ub,
                        np.asarray(srcvec if srcvec else [0], np.int64),
                        np.asarray(srcvec_node if srcvec_node else [0],
                                   np.int64),
                        maps, dense)


def _finish_plan(plan, pt, tr, sy, ub_lvl, ub, srcvec, srcvec_node,
                 maps, dense) -> FactorPlan:
    """Shared tail: level count, kv sorting, level bucketing."""
    nb = plan.nb
    nlevels = 0
    for lv in (pt[:, 0], tr[:, 0], sy[:, 0], ub_lvl):
        if len(lv):
            nlevels = max(nlevels, int(lv.max()))

    # order potrf/trsm within each level by column count (descending):
    # a fixed, deterministic task order within each level
    if len(pt):
        pt = pt[np.lexsort((-pt[:, 2], pt[:, 0]))]
    if len(tr):
        tr = tr[np.lexsort((-tr[:, 3], tr[:, 0]))]

    p_ptr, (p_blk, p_k) = _bucket(pt[:, 0], nlevels, pt[:, 1], pt[:, 2])
    t_ptr, (t_diag, t_dst, t_k) = _bucket(tr[:, 0], nlevels, tr[:, 1],
                                          tr[:, 2], tr[:, 3])
    s_ptr, (s_i, s_j, s_dst) = _bucket(sy[:, 0], nlevels, sy[:, 1],
                                       sy[:, 2], sy[:, 3])
    u_ptr, (u_dst, u_mr, u_mc, u_svp, u_c) = _bucket(
        ub_lvl, nlevels, *ub)
    return FactorPlan(
        nb=nb, nblocks=plan.nblocks, nlevels=nlevels,
        potrf_ptr=p_ptr, potrf_blk=np.asarray(p_blk, np.int64),
        potrf_k=np.asarray(p_k, np.int64),
        trsm_ptr=t_ptr, trsm_diag=np.asarray(t_diag, np.int64),
        trsm_dst=np.asarray(t_dst, np.int64),
        trsm_k=np.asarray(t_k, np.int64),
        syrk_ptr=s_ptr, syrk_src_i=np.asarray(s_i, np.int64),
        syrk_src_j=np.asarray(s_j, np.int64),
        syrk_dst=np.asarray(s_dst, np.int64),
        updbt_ptr=u_ptr, updbt_dst=np.asarray(u_dst, np.int64),
        updbt_mr=np.asarray(u_mr, np.int64),
        updbt_mc=np.asarray(u_mc, np.int64),
        updbt_svp=np.asarray(u_svp, np.int64),
        updbt_c=np.asarray(u_c, np.int64),
        srcvec=(srcvec if len(srcvec)
                else np.zeros(1, np.int64)),
        srcvec_node=(srcvec_node if len(srcvec_node)
                     else np.zeros(1, np.int64)),
        maps=maps,
        blk_n=plan.blk_n.astype(np.int32),
        num_tasks=len(pt) + len(tr) + len(sy) + len(ub_lvl),
        dense=dense,
    )


_SPADS = (64, 128, 256, 512, 1024)


def _build_dense_phase(symb, plan: BlockPlan, coarse) -> list:
    """Per-spad-bucket tables for the batched dense subtree phase."""
    nb = plan.nb
    a = symb.a_perm
    n = a.n
    nnodes = plan.nnodes
    col_node = np.repeat(np.arange(nnodes),
                         (plan.node_en - plan.node_sa + 1))
    sub_of_col = np.full(n, -1, dtype=np.int64)
    sub_of_col[:len(col_node)] = coarse.sub_of_node[col_node]

    def spad_of(span):
        for s in _SPADS:
            if span <= s:
                return s
        raise ValueError(f"subtree span {span} exceeds {_SPADS[-1]}")

    buckets: dict[int, dict] = {}
    sub_local = np.empty(coarse.nsub, dtype=np.int64)
    sub_bucket = np.empty(coarse.nsub, dtype=np.int64)
    for s in range(coarse.nsub):
        sp = spad_of(int(coarse.span[s]))
        b = buckets.setdefault(sp, {
            "spad": sp, "subs": [], "kvec": [],
            "asm_sub": [], "asm_r": [], "asm_c": [], "asm_vidx": [],
            "sc_blk": [], "sc_sub": [], "sc_rpos": [], "sc_rval": [],
            "sc_cpos": [], "sc_cval": [],
        })
        sub_local[s] = len(b["subs"])
        sub_bucket[s] = sp
        b["subs"].append(s)
        b["kvec"].append(int(coarse.v_hi[s] - coarse.v_lo[s] + 1))

    def pos_in_span(s, rows):
        vlen = int(coarse.v_hi[s] - coarse.v_lo[s] + 1)
        bs = coarse.boundary(s)
        return np.where(rows <= coarse.v_hi[s], rows - coarse.v_lo[s],
                        vlen + np.searchsorted(bs, rows))

    # ---- dense assembly map (A entries with column inside a front) ------ #
    cols_of = np.repeat(np.arange(n, dtype=np.int64), np.diff(a.colptr))
    entry_sub = sub_of_col[cols_of]
    sel = np.nonzero(entry_sub != -1)[0]
    # vectorized per subtree (entries of one subtree are contiguous in the
    # CSC order since its columns are contiguous)
    order = np.argsort(entry_sub[sel], kind="stable")
    sel = sel[order]
    esub = entry_sub[sel]
    starts = np.searchsorted(esub, np.arange(coarse.nsub))
    ends = np.searchsorted(esub, np.arange(coarse.nsub) + 1)
    for s in range(coarse.nsub):
        idx = sel[starts[s]:ends[s]]
        if len(idx) == 0:
            continue
        b = buckets[int(sub_bucket[s])]
        b["asm_sub"].extend([int(sub_local[s])] * len(idx))
        b["asm_r"].extend(pos_in_span(s, a.rowind[idx]).tolist())
        b["asm_c"].extend((cols_of[idx] - coarse.v_lo[s]).tolist())
        b["asm_vidx"].extend(idx.tolist())

    # ---- scatter-back maps (front -> pool blocks) ----------------------- #
    for nd in range(nnodes):
        s = int(coarse.sub_of_node[nd])
        if s == -1:
            continue
        b = buckets[int(sub_bucket[s])]
        T = int(plan.node_ntiles[nd])
        C = int(plan.node_nctiles[nd])
        b0 = int(plan.node_blk_ptr[nd])
        w = int(plan.node_en[nd] - plan.node_sa[nd] + 1)
        nrows = plan.rows[plan.node_rptr[nd]:plan.node_rptr[nd + 1]]
        blk = b0
        for jb in range(C):
            kcols = min(nb, w - jb * nb)
            cpos = np.zeros(nb, dtype=np.int64)
            cval = np.zeros(nb, dtype=bool)
            cpos[:kcols] = (plan.node_sa[nd] + jb * nb
                            + np.arange(kcols)) - coarse.v_lo[s]
            cval[:kcols] = True
            for ib in range(jb, T):
                g = nrows[ib * nb:(ib + 1) * nb]
                rpos = np.zeros(nb, dtype=np.int64)
                rval = np.zeros(nb, dtype=bool)
                rpos[:len(g)] = pos_in_span(s, g)
                rval[:len(g)] = True
                b["sc_blk"].append(blk)
                b["sc_sub"].append(int(sub_local[s]))
                b["sc_rpos"].append(rpos)
                b["sc_rval"].append(rval)
                b["sc_cpos"].append(cpos)
                b["sc_cval"].append(cval)
                blk += 1

    out = []
    for sp in sorted(buckets):
        b = buckets[sp]
        out.append({
            "spad": sp,
            "nsub": len(b["subs"]),
            "kvec": np.asarray(b["kvec"], np.int64),
            "asm_sub": np.asarray(b["asm_sub"], np.int64),
            "asm_r": np.asarray(b["asm_r"], np.int64),
            "asm_c": np.asarray(b["asm_c"], np.int64),
            "asm_vidx": np.asarray(b["asm_vidx"], np.int64),
            "sc_blk": np.asarray(b["sc_blk"], np.int64),
            "sc_sub": np.asarray(b["sc_sub"], np.int64),
            "sc_rpos": (np.stack(b["sc_rpos"]) if b["sc_blk"]
                        else np.empty((0, nb), np.int64)),
            "sc_rval": (np.stack(b["sc_rval"]) if b["sc_blk"]
                        else np.empty((0, nb), bool)),
            "sc_cpos": (np.stack(b["sc_cpos"]) if b["sc_blk"]
                        else np.empty((0, nb), np.int64)),
            "sc_cval": (np.stack(b["sc_cval"]) if b["sc_blk"]
                        else np.empty((0, nb), bool)),
        })
    return out
