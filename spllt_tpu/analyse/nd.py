"""General-graph multilevel nested dissection (the METIS role).

The reference obtains its ordering from METIS through SPRAL SSIDS
(``ssids_opt%ordering = 1``, /root/reference/src/spllt_analyse_mod.F90:
109,129-131).  We own the pipeline; this module supplies the
nested-dissection ordering for matrices with no grid structure, using
the standard multilevel recipe:

  1. coarsen by heavy-edge matching until the graph is small,
  2. bisect the coarsest graph by BFS from a pseudo-peripheral vertex,
  3. uncoarsen, refining the edge cut at every level with
     boundary-gain passes (simplified Fiduccia–Mattheyses),
  4. turn the refined edge separator into a minimal vertex separator
     via König's theorem (maximum bipartite matching on the boundary),
  5. recurse on the two parts; separator vertices are numbered last;
     small leaves are ordered by AMD (METIS uses MMD similarly).

For a level-scheduled factorization, ND matters beyond fill: it
produces balanced, shallow elimination trees, which widen the level
schedule (more independent tasks per batched device call).  See
scripts/ordering_quality.py for the fill/level-balance evaluation.
"""

from __future__ import annotations

import numpy as np

__all__ = ["nd_ordering"]


def _full_graph(a):
    """Symmetric adjacency (no self loops) of a CscMatrix, CSR."""
    import scipy.sparse as sp

    g = sp.csc_matrix(
        (np.ones(len(a.rowind)), a.rowind, a.colptr), shape=(a.n, a.n))
    g = g + g.T
    g.setdiag(0)
    g.eliminate_zeros()
    g = g.tocsr()
    g.data[:] = 1.0
    return g


def nd_ordering(a, leaf: int = 96, seed: int = 0) -> np.ndarray:
    """Multilevel nested-dissection permutation of a CscMatrix.

    Returns ``perm`` with perm[i] = original index placed at position i
    (same convention as ordering.compute_ordering).
    """
    g = _full_graph(a)
    rng = np.random.default_rng(seed)
    out = np.empty(a.n, dtype=np.int64)
    pos = 0
    # explicit work stack: (vertex ids, emit_after) — children first,
    # separator numbered after both parts (postorder of the ND tree)
    stack = [(np.arange(a.n, dtype=np.int64), None)]
    while stack:
        item = stack.pop()
        verts, sep = item
        if verts is None:
            out[pos:pos + sep.size] = sep
            pos += sep.size
            continue
        if verts.size <= leaf:
            order = _leaf_order(g, verts)
            out[pos:pos + verts.size] = verts[order]
            pos += verts.size
            continue
        sub = _subgraph(g, verts)
        part, sep_mask = _bisect_vertex(sub, rng)
        if sep_mask is None:          # disconnected / degenerate split
            order = _leaf_order(g, verts)
            out[pos:pos + verts.size] = verts[order]
            pos += verts.size
            continue
        sep_v = verts[sep_mask]
        a_v = verts[(part == 0) & ~sep_mask]
        b_v = verts[(part == 1) & ~sep_mask]
        # emit order: A, B, then separator
        stack.append((None, sep_v))
        stack.append((b_v, None))
        stack.append((a_v, None))
    assert pos == a.n
    return out


def _leaf_order(g, verts):
    """AMD on the subgraph (local positions)."""
    sub = _subgraph(g, verts).tocsc()
    from .ordering import _amd_python

    class _A:  # minimal CscMatrix-shaped view for the AMD routines
        n = verts.size
        colptr = sub.indptr.astype(np.int64)
        rowind = sub.indices.astype(np.int64)

    from .native import native_amd_or_none

    perm = native_amd_or_none(_A)
    if perm is None:
        perm = _amd_python(_A.n, _A.colptr, _A.rowind)
    return perm


def _subgraph(g, verts):
    return g[verts][:, verts]


# ------------------------------------------------------------------ #
# multilevel edge bisection
# ------------------------------------------------------------------ #

def _bisect_vertex(g, rng):
    """Bisect graph g; returns (part[n] in {0,1}, sep_mask[n]) or
    (None, None) when no meaningful separator exists."""
    n = g.shape[0]
    part = _multilevel_edge_bisect(g, rng)
    if part is None:
        return None, None
    sep_mask = _vertex_separator(g, part)
    if sep_mask is None or sep_mask.all() or not sep_mask.any():
        return None, None
    # everything in the separator keeps its part label for bookkeeping
    na = int(((part == 0) & ~sep_mask).sum())
    nb = int(((part == 1) & ~sep_mask).sum())
    if na == 0 or nb == 0:
        return None, None
    return part, sep_mask


def _multilevel_edge_bisect(g, rng, coarse_n: int = 160):
    """Heavy-edge-matching coarsening + BFS split + FM refinement."""
    import scipy.sparse as sp

    n = g.shape[0]
    vwgt = np.ones(n, dtype=np.int64)
    levels = []              # (graph, vwgt, coarse_map)
    cur, cw = g, vwgt
    while cur.shape[0] > coarse_n:
        cmap, nc = _heavy_edge_matching(cur, cw, rng)
        if nc >= cur.shape[0] * 0.95:       # matching stalled
            break
        p = sp.csr_matrix(
            (np.ones(cur.shape[0]), (np.arange(cur.shape[0]), cmap)),
            shape=(cur.shape[0], nc))
        nxt = (p.T @ cur @ p).tocsr()
        nxt.setdiag(0)
        nxt.eliminate_zeros()
        nw = np.zeros(nc, dtype=np.int64)
        np.add.at(nw, cmap, cw)
        levels.append((cur, cw, cmap))
        cur, cw = nxt, nw
    # several BFS starts at the coarsest level; keep the best refined cut
    # (the GGGP idea from the multilevel literature, cheap at coarse_n)
    best, best_cut = None, np.inf
    for _ in range(4):
        part = _bfs_split(cur, cw, rng)
        if part is None:
            continue
        part = _fm_refine(cur, cw, part, passes=8)
        cut = _cut_weight(cur, part)
        if cut < best_cut:
            best, best_cut = part, cut
    part = best
    if part is None:
        return None
    for gg, ww, cmap in reversed(levels):
        part = part[cmap]
        part = _fm_refine(gg, ww, part, passes=4)
    return part


def _cut_weight(g, part):
    coo = g.tocoo()
    return float(coo.data[part[coo.row] != part[coo.col]].sum())


def _heavy_edge_matching(g, vwgt, rng):
    """Random-order heavy-edge matching; returns (coarse_map, nc).

    The C++ twin (native/symbolic.cpp spllt_hem) follows the identical
    traversal, so results match exactly; this loop is the fallback."""
    n = g.shape[0]
    indptr, indices, data = g.indptr, g.indices, g.data
    order = rng.permutation(n)
    from .native import native_hem_or_none
    res = native_hem_or_none(indptr, indices, data, order)
    if res is not None:
        return res
    match = np.full(n, -1, dtype=np.int64)
    for v in order:
        if match[v] >= 0:
            continue
        best, bw = -1, -1.0
        for k in range(indptr[v], indptr[v + 1]):
            u = indices[k]
            if match[u] < 0 and u != v and data[k] > bw:
                best, bw = u, data[k]
        if best >= 0:
            match[v] = best
            match[best] = v
        else:
            match[v] = v
    cmap = np.full(n, -1, dtype=np.int64)
    nc = 0
    for v in range(n):
        if cmap[v] < 0:
            cmap[v] = nc
            cmap[match[v]] = nc
            nc += 1
    return cmap, nc


def _bfs_split(g, vwgt, rng):
    """BFS from a pseudo-peripheral vertex; split at half total weight."""
    import scipy.sparse.csgraph as cg

    n = g.shape[0]
    if n < 2:
        return None
    src = int(rng.integers(n))
    # two BFS sweeps approximate a pseudo-peripheral pair
    d = cg.breadth_first_order(g, src, directed=False,
                               return_predecessors=False)
    src = int(d[-1])
    order = cg.breadth_first_order(g, src, directed=False,
                                   return_predecessors=False)
    part = np.ones(n, dtype=np.int8)       # unreachable → side B
    half = vwgt.sum() / 2
    acc = 0
    for v in order:
        part[v] = 0 if acc < half else 1
        acc += vwgt[v]
    if part.all() or not part.any():
        return None
    return part


def _fm_refine(g, vwgt, part, passes: int = 4, balance: float = 1.12):
    """Greedy boundary refinement of an edge bisection.

    Each pass computes every boundary vertex's gain (external − internal
    edge weight) vectorized, then greedily applies positive-gain moves in
    descending order under the balance constraint, with local gain
    updates.  Not full FM (no bucket lists / hill climbing), but it
    captures most of the cut reduction at NumPy speed.
    """
    indptr, indices, data = g.indptr, g.indices, g.data
    w = vwgt.astype(np.int64)
    tot = w.sum()
    maxside = tot / 2 * balance
    side_w = np.array([w[part == 0].sum(), w[part == 1].sum()],
                      dtype=np.int64)
    part = part.astype(np.int8).copy()
    for _ in range(passes):
        # ext/int edge weights per vertex (vectorized over CSR)
        neigh_part = part[indices]
        same = (neigh_part == np.repeat(part, np.diff(indptr)))
        wdata = data
        intw = np.zeros(len(part))
        extw = np.zeros(len(part))
        rows = np.repeat(np.arange(len(part)), np.diff(indptr))
        np.add.at(intw, rows[same], wdata[same])
        np.add.at(extw, rows[~same], wdata[~same])
        gain = extw - intw
        cand = np.where(gain > 0)[0]
        if len(cand) == 0:
            break
        cand = cand[np.argsort(-gain[cand])]
        moved = 0
        for v in cand:
            s = part[v]
            if side_w[1 - s] + w[v] > maxside:
                continue
            # recompute v's gain locally (earlier moves may stale it)
            nb = indices[indptr[v]:indptr[v + 1]]
            nw = data[indptr[v]:indptr[v + 1]]
            ext = nw[part[nb] != s].sum()
            ints = nw[part[nb] == s].sum()
            if ext - ints <= 0:
                continue
            part[v] = 1 - s
            side_w[s] -= w[v]
            side_w[1 - s] += w[v]
            moved += 1
        if moved == 0:
            break
    return part


def _vertex_separator(g, part):
    """Minimal vertex separator from an edge cut via König's theorem.

    The cut edges form a bipartite graph between boundary vertices of A
    and B; a minimum vertex cover of that bipartite graph (= maximum
    matching size, König) is a minimum vertex separator contained in the
    boundary.  Uses scipy's Hopcroft–Karp.
    """
    import scipy.sparse as sp
    from scipy.sparse.csgraph import maximum_bipartite_matching

    n = g.shape[0]
    coo = g.tocoo()
    cut = part[coo.row] != part[coo.col]
    if not cut.any():
        return None
    arow, acol = coo.row[cut], coo.col[cut]
    # orient: a in A, b in B
    swap = part[arow] == 1
    arow2 = np.where(swap, acol, arow)
    bcol2 = np.where(swap, arow, acol)
    averts = np.unique(arow2)
    bverts = np.unique(bcol2)
    amap = {v: i for i, v in enumerate(averts)}
    bmap = {v: i for i, v in enumerate(bverts)}
    ai = np.fromiter((amap[v] for v in arow2), np.int64, len(arow2))
    bi = np.fromiter((bmap[v] for v in bcol2), np.int64, len(bcol2))
    bip = sp.csr_matrix(
        (np.ones(len(ai)), (ai, bi)), shape=(len(averts), len(bverts)))
    mb = maximum_bipartite_matching(bip, perm_type="column")
    # König: cover = (A \ Z_A) ∪ (B ∩ Z_B), where Z = vertices reachable
    # from unmatched A-vertices by alternating paths
    matched_a = mb != -1
    match_of_b = np.full(len(bverts), -1, dtype=np.int64)
    match_of_b[mb[matched_a]] = np.where(matched_a)[0]
    visited_a = np.zeros(len(averts), bool)
    visited_b = np.zeros(len(bverts), bool)
    queue = list(np.where(~matched_a)[0])
    visited_a[queue] = True
    badj_ptr = bip.indptr
    badj_ind = bip.indices
    while queue:
        va = queue.pop()
        for k in range(badj_ptr[va], badj_ptr[va + 1]):
            vb = badj_ind[k]
            if visited_b[vb]:
                continue
            visited_b[vb] = True
            vm = match_of_b[vb]
            if vm >= 0 and not visited_a[vm]:
                visited_a[vm] = True
                queue.append(vm)
    cover_a = averts[~visited_a]
    cover_b = bverts[visited_b]
    sep = np.zeros(n, bool)
    sep[cover_a] = True
    sep[cover_b] = True
    return sep
