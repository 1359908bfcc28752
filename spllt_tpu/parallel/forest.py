"""Multi-device forest-parallel factorization + solve (shard_map).

Replacement for the reference's distributed-memory path.  SpLLT
distributes blocks over MPI ranks via PaRSEC's ``blk_rank_of`` map and lets
the dataflow runtime generate point-to-point block transfers
(/root/reference/src/PaRSEC/spllt_parsec_blk_data.c:33-64, factorize.jdf);
the solve is not distributed at all.  Here the elimination forest itself is
partitioned: the flop-balanced L0 layer from the tree pruning
(``spllt_prune_tree`` analogue) assigns whole subtrees to devices; each
device factors its subtrees locally with the SAME bucketed lax.scan level
schedule as the single-chip production executor (numeric/factor_scan.py) —
per-device task tables padded to SPMD-uniform shapes — ancestor
contribution blocks are reduced with one ``psum`` per bucket, and the (small)
top of the forest is factored replicated.  Communication is a single
deterministic collective per phase — no runtime scheduler, no
point-to-point messaging, and bitwise-reproducible results for a fixed
configuration (the reference's STARPU_COMMUTE updates are run-to-run
non-deterministic; SURVEY §7 'hard parts').

Factorization phases:
  A. local: factor the device's subtrees (bucketed scan over sharded
     tables); ``update_between`` contributions into top ancestors
     accumulate in a zero-initialized replica of the top blocks.
  B. reduce: top = assembled_top + psum(contributions, 'tree').
  C. replicated: factor the top subforest (identical on every device).

Distributed solve (the reference has no analogue — its solve is
shared-memory only, spllt_solve_mod.F90): the right-hand side panel
x[n+1, nrhs] is replicated; each device runs its subtrees' solve tasks
locally (writes to its own subtree's rows are exclusive, adds into top
rows commute), the per-device deltas are psum-merged
(x = x_in + psum(x_local - x_in)), and the top subforest solve runs
replicated.  Backward mirrors: replicated top first, local subtrees
after, one more delta-psum.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["ForestPartition", "partition_forest", "MultiDeviceFactor",
           "build_multidevice_factor", "make_sharded_factorize",
           "make_sharded_solve", "reconstruct_global_pool", "dryrun"]


@dataclasses.dataclass
class ForestPartition:
    ndev: int
    part_of_node: np.ndarray    # device id per node, -1 = top (replicated)
    ntop: int                   # top blocks (local ids 0..ntop-1)
    ppart: int                  # padded per-device subtree block count
    nlocal: int                 # ntop + ppart + 1 (scratch)
    blk_local: np.ndarray       # global blk -> local id (within its region)
    blk_dev: np.ndarray         # global blk -> device id or -1 (top)


def partition_forest(symb, plan, ndev: int) -> ForestPartition:
    """Assign pruned subtrees to devices (LPT bin packing on flop weight)."""
    from ..analyse.prune import prune_tree, subtree_list

    nnodes = plan.nnodes
    small = prune_tree(symb.forest, symb.weight, ndev)
    subtrees = subtree_list(symb.forest, small)
    part_of_node = np.full(nnodes, -1, dtype=np.int64)
    # LPT: heaviest subtree first onto least-loaded device
    loads = np.zeros(ndev)
    order = np.argsort([-symb.weight[t[-1]] for t in subtrees])
    for si in order:
        t = subtrees[si]
        d = int(np.argmin(loads))
        loads[d] += float(symb.weight[t[-1]])
        part_of_node[t] = d

    blk_dev = part_of_node[plan.blk_node]
    ntop = int(np.sum(blk_dev == -1))
    blk_local = np.empty(plan.nblocks, dtype=np.int64)
    top_sel = blk_dev == -1
    blk_local[top_sel] = np.arange(ntop)
    ppart = 0
    for d in range(ndev):
        sel = blk_dev == d
        cnt = int(np.sum(sel))
        blk_local[sel] = ntop + np.arange(cnt)
        ppart = max(ppart, cnt)
    return ForestPartition(
        ndev=ndev, part_of_node=part_of_node, ntop=ntop, ppart=ppart,
        nlocal=ntop + ppart + 1, blk_local=blk_local, blk_dev=blk_dev)


# ------------------------------------------------------------------------- #
# SPMD bucket tables: per-device task lists -> [ndev, nlev_b, K] arrays
# ------------------------------------------------------------------------- #

def _bucket_flat(tl, nlevels, field_dims):
    """Level-bucket one device's task list [(lvl, f0, f1, ...)].

    field_dims: per field, None (scalar) or the row width (2-D field).
    """
    nfields = len(field_dims)
    ptr = np.zeros(nlevels + 2, dtype=np.int64)
    for t in tl:
        ptr[t[0] + 1] += 1
    ptr = np.cumsum(ptr)
    fields = [np.empty(len(tl), dtype=object) for _ in range(nfields)]
    fill = np.zeros(nlevels + 2, dtype=np.int64)
    for t in tl:
        pos = int(ptr[t[0]] + fill[t[0]])
        fill[t[0]] += 1
        for f in range(nfields):
            fields[f][pos] = t[1 + f]
    out = []
    for f in range(nfields):
        w = field_dims[f]
        if w is None:
            out.append(fields[f].astype(np.int64) if len(tl)
                       else np.empty(0, np.int64))
        else:
            out.append(np.stack(list(fields[f])).astype(np.int64)
                       if len(tl) else np.empty((0, w), np.int64))
    return ptr, out


def _spmd_bucket_tables(per_dev_tasks, nlevels, kind_fields, pad_values,
                        alpha: float = 1.6):
    """Shared bucket spans from per-level MAX counts across devices, then
    per-device padded tables stacked to [ndev, nlev_b, K(, nb)].

    per_dev_tasks: {kind: [list of (lvl, f...) per device]}.
    kind_fields: {kind: [field names]}.  Returns list of per-bucket dicts
    {kind_field: np.ndarray[ndev, nlev_b, K(, nb)]}.
    """
    from ..plan.buckets import make_buckets, pad_tables

    ndev = len(next(iter(per_dev_tasks.values())))
    kinds = list(per_dev_tasks.keys())
    counts = {}
    flat = {k: [] for k in kinds}          # per device (ptr, fields)
    for k in kinds:
        dims = [len(pad_values[k][nm])
                if isinstance(pad_values[k][nm], np.ndarray) else None
                for nm in kind_fields[k]]
        cmax = np.zeros(nlevels + 2, dtype=np.int64)
        for d in range(ndev):
            ptr, fields = _bucket_flat(per_dev_tasks[k][d], nlevels,
                                       dims)
            flat[k].append((ptr, fields))
            cmax = np.maximum(cmax, np.diff(np.append(ptr, ptr[-1])))
        counts[k] = cmax[:nlevels + 1]
    spans = make_buckets(counts, nlevels, alpha=alpha)
    out = []
    for span in spans:
        per_dev = []
        for d in range(ndev):
            fields = {k: {nm: flat[k][d][1][i]
                          for i, nm in enumerate(kind_fields[k])}
                      for k in kinds}
            ptrs = {k: flat[k][d][0] for k in kinds}
            b = pad_tables(span, fields, ptrs, pad_values)
            per_dev.append(b.tables)
        stacked = {nm: np.stack([per_dev[d][nm] for d in range(ndev)])
                   for nm in per_dev[0]}
        out.append(stacked)
    return out, [(s, e) for s, e, _ in spans]


@dataclasses.dataclass
class MultiDeviceFactor:
    """Compiled multi-device factorization+solve plan for (symb, plan,
    ndev)."""

    part: ForestPartition
    nlevels: int
    a_buckets: list              # factor phase A: [ndev, ...] tables
    a_spans: list                # phase A bucket level ranges [(s, e)]
    c_buckets: list              # factor phase C: [1, ...] tables
    fsolve: dict                 # solve tables (fwd/bwd x A/C buckets)
    srcvec_local: np.ndarray     # [ndev, S]
    maps: np.ndarray
    blk_n_local: np.ndarray      # [ndev, nlocal]
    cmax: int
    n: int
    # assembly
    asm_rowflat: np.ndarray      # [ndev, max_asm]
    asm_col: np.ndarray
    asm_val_idx: np.ndarray      # index into permuted values, -1 pad
    top_rowflat: np.ndarray      # top assembly (host, replicated)
    top_col: np.ndarray
    top_val_idx: np.ndarray
    nb: int
    # raw per-device/per-kind phase-A task lists (local ids); they place
    # the overlapped ancestor psums (_top_psum_slices)
    a_tasks: dict | None = None

    def local_pools(self, values: np.ndarray, dtype=np.float32):
        """Host-side assembly of the sharded local pools
        [ndev, nlocal*nb, nb] (subtree blocks only; top region zero) and
        the replicated assembled top [ntop*nb, nb]."""
        p = self.part
        nb = self.nb
        ndev = p.ndev
        pools = np.zeros((ndev, p.nlocal * nb, nb), dtype=dtype)
        vals = values.astype(dtype)
        for d in range(ndev):
            sel = self.asm_val_idx[d] >= 0
            np.add.at(pools[d], (self.asm_rowflat[d][sel],
                                 self.asm_col[d][sel]),
                      vals[self.asm_val_idx[d][sel]])
        top = np.zeros((max(1, p.ntop) * nb, nb), dtype=dtype)
        np.add.at(top, (self.top_rowflat, self.top_col),
                  vals[self.top_val_idx])
        return pools, top


def build_multidevice_factor(symb, plan, fplan, ndev: int, splan=None
                             ) -> MultiDeviceFactor:
    """Partition the global factor (+solve) plans into per-device phase-A
    and replicated phase-C bucket-scan tables with SPMD-uniform shapes."""
    part = partition_forest(symb, plan, ndev)
    nb = plan.nb
    L = part.blk_local
    scratch = part.nlocal - 1      # local scratch block id

    node_dev = part.part_of_node
    node_shift = (L[plan.node_blk_ptr[:-1]]
                  - plan.node_blk_ptr[:-1]).astype(np.int64)

    def owner_of_blk(b):
        return int(node_dev[plan.blk_node[b]])

    def unbucket(ptr, *fields):
        out = []
        nlev = len(ptr) - 2
        for lvl in range(nlev + 1):
            for t in range(int(ptr[lvl]), int(ptr[lvl + 1])):
                out.append((lvl,) + tuple(
                    f[t] if isinstance(f[t], np.ndarray) else int(f[t])
                    for f in fields))
        return out

    # ---------------- factor task split ------------------------------- #
    potrf = unbucket(fplan.potrf_ptr, fplan.potrf_blk, fplan.potrf_k)
    trsm = unbucket(fplan.trsm_ptr, fplan.trsm_diag, fplan.trsm_dst,
                    fplan.trsm_k)
    syrk = unbucket(fplan.syrk_ptr, fplan.syrk_src_i, fplan.syrk_src_j,
                    fplan.syrk_dst)
    updbt = unbucket(fplan.updbt_ptr, fplan.updbt_dst, fplan.updbt_mr,
                     fplan.updbt_mc, fplan.updbt_svp, fplan.updbt_c)

    nlevels = fplan.nlevels
    a = {k: [[] for _ in range(ndev)]
         for k in ("potrf", "trsm", "syrk", "updbt")}
    c = {k: [[]] for k in ("potrf", "trsm", "syrk", "updbt")}
    for lvl, blk, k in potrf:
        d = owner_of_blk(blk)
        tt = (lvl, int(L[blk]), k)
        (c["potrf"][0] if d == -1 else a["potrf"][d]).append(tt)
    for lvl, diag, dst, k in trsm:
        d = owner_of_blk(diag)
        tt = (lvl, int(L[diag]), int(L[dst]), k)
        (c["trsm"][0] if d == -1 else a["trsm"][d]).append(tt)
    for lvl, si, sj, dst in syrk:
        d = owner_of_blk(si)
        tt = (lvl, int(L[si]), int(L[sj]), int(L[dst]))
        (c["syrk"][0] if d == -1 else a["syrk"][d]).append(tt)
    for lvl, dst, mr, mc, svp, cw in updbt:
        src_node = int(fplan.srcvec_node[svp])
        d = int(node_dev[src_node])
        tt = (lvl, int(L[dst]), mr, mc, svp, cw)
        (c["updbt"][0] if d == -1 else a["updbt"][d]).append(tt)
    # srcvec with local shifts: phase-A tasks of device d only reference
    # entries of d's nodes; the top entries are correct on every device
    srcvec_local = (fplan.srcvec
                    + node_shift[fplan.srcvec_node]).astype(np.int64)
    srcvec_local = np.tile(srcvec_local, (ndev, 1))

    kind_fields = {
        "potrf": ["blk", "k"],
        "trsm": ["diag", "dst", "k"],
        "syrk": ["i", "j", "dst"],
        "updbt": ["dst", "mr", "mc", "svp", "c"],
    }
    pad_values = {
        "potrf": {"blk": scratch, "k": 0},
        "trsm": {"diag": scratch, "dst": scratch, "k": 0},
        "syrk": {"i": scratch, "j": scratch, "dst": scratch},
        "updbt": {"dst": scratch, "mr": 0, "mc": 0, "svp": 0, "c": 0},
    }
    a_buckets, a_spans = _spmd_bucket_tables(a, nlevels, kind_fields,
                                             pad_values)
    c_buckets, _ = _spmd_bucket_tables(c, nlevels, kind_fields,
                                       pad_values)

    # local blk_n per device (for updbt col masks); scratch gets nb
    blk_n_local = np.full((ndev, part.nlocal), nb, dtype=np.int64)
    for b in range(plan.nblocks):
        d = owner_of_blk(b)
        if d == -1:
            blk_n_local[:, L[b]] = plan.blk_n[b]
        else:
            blk_n_local[d, L[b]] = plan.blk_n[b]

    # ---------------- solve task split -------------------------------- #
    fsolve = {}
    if splan is not None:
        n = symb.n
        pad_rows = np.full(nb, n, dtype=np.int64)
        sp = splan

        def split_dir(sol_ptr, sol_blk, sol_rows, sol_k,
                      upd_ptr, upd_blk, upd_rows, upd_c0, upd_k, nlev):
            """One direction: sol+upd kinds bucketed with SHARED spans
            (level alignment between the kinds is what orders the solve
            phases; see _solve_scan_phase)."""
            av = {"sol": [[] for _ in range(ndev)],
                  "upd": [[] for _ in range(ndev)]}
            cv = {"sol": [[]], "upd": [[]]}
            for t in unbucket(sol_ptr, sol_blk, sol_rows, sol_k):
                d = owner_of_blk(t[1])
                tt = (t[0], int(L[t[1]])) + t[2:]
                (cv["sol"][0] if d == -1 else av["sol"][d]).append(tt)
            for t in unbucket(upd_ptr, upd_blk, upd_rows, upd_c0, upd_k):
                d = owner_of_blk(t[1])
                tt = (t[0], int(L[t[1]])) + t[2:]
                (cv["upd"][0] if d == -1 else av["upd"][d]).append(tt)
            fields = {"sol": ["blk", "rows", "k"],
                      "upd": ["blk", "rows", "c0", "k"]}
            pads = {"sol": {"blk": scratch, "rows": pad_rows, "k": 0},
                    "upd": {"blk": scratch, "rows": pad_rows, "c0": 0,
                            "k": 0}}
            return (_spmd_bucket_tables(av, nlev, fields, pads)[0],
                    _spmd_bucket_tables(cv, nlev, fields, pads)[0])

        fsolve["fwd_a"], fsolve["fwd_c"] = split_dir(
            sp.fsol_ptr, sp.fsol_blk, sp.fsol_rows, sp.fsol_k,
            sp.fupd_ptr, sp.fupd_blk, sp.fupd_rows, sp.fupd_c0,
            sp.fupd_k, sp.nlevels_fwd)
        fsolve["bwd_a"], fsolve["bwd_c"] = split_dir(
            sp.bsol_ptr, sp.bsol_blk, sp.bsol_rows, sp.bsol_k,
            sp.bupd_ptr, sp.bupd_blk, sp.bupd_rows, sp.bupd_c0,
            sp.bupd_k, sp.nlevels_bwd)

    # ---------------- assembly split ----------------------------------- #
    asm_blk = plan.asm_rowflat.astype(np.int64) // nb
    asm_r = plan.asm_rowflat.astype(np.int64) % nb
    asm_dev = np.array([owner_of_blk(int(b)) for b in asm_blk])
    top_sel = asm_dev == -1
    top_rowflat = (L[asm_blk[top_sel]] * nb
                   + asm_r[top_sel]).astype(np.int64)
    top_col = plan.asm_col[top_sel].astype(np.int64)
    top_val_idx = np.nonzero(top_sel)[0]
    max_asm = max([int(np.sum(asm_dev == d)) for d in range(ndev)] + [1])
    asm_rowflat = np.full((ndev, max_asm), scratch * nb, dtype=np.int64)
    asm_col = np.zeros((ndev, max_asm), dtype=np.int64)
    asm_val_idx = np.full((ndev, max_asm), -1, dtype=np.int64)
    for d in range(ndev):
        sel = np.nonzero(asm_dev == d)[0]
        asm_rowflat[d, :len(sel)] = L[asm_blk[sel]] * nb + asm_r[sel]
        asm_col[d, :len(sel)] = plan.asm_col[sel]
        asm_val_idx[d, :len(sel)] = sel

    return MultiDeviceFactor(
        part=part, nlevels=nlevels, a_buckets=a_buckets, a_spans=a_spans,
        c_buckets=c_buckets, fsolve=fsolve, srcvec_local=srcvec_local,
        maps=fplan.maps, blk_n_local=blk_n_local,
        cmax=int(fplan.updbt_c.max()) if len(fplan.updbt_c) else 0,
        n=symb.n,
        asm_rowflat=asm_rowflat, asm_col=asm_col, asm_val_idx=asm_val_idx,
        top_rowflat=top_rowflat, top_col=top_col, top_val_idx=top_val_idx,
        nb=nb, a_tasks=a,
    )


# ------------------------------------------------------------------------- #
# scan bodies (XLA; shared by phases A and C inside shard_map)
# ------------------------------------------------------------------------- #

def _factor_scan_phase(pool, buckets_dev, maps, blk_n, srcvec, cmax, nb,
                       prec):
    """Run one phase's bucket list (device-local slices, leading axis
    peeled) with lax.scan per bucket — the multi-device twin of
    ScanFactorExecutor._build's level body (numeric/factor_scan.py)."""
    import jax

    from ..numeric.factor import (_bmm_nt, _potrf_batch_blocked,
                                  _trsm_batch, _updbt)

    cmax = max(1, cmax)

    def level_body(pool, tb):
        if "updbt_dst" in tb:
            pool = _updbt(pool, maps, blk_n, srcvec, tb["updbt_dst"],
                          tb["updbt_mr"], tb["updbt_mc"], tb["updbt_svp"],
                          tb["updbt_c"], cmax, prec)
        if "syrk_i" in tb:
            u = _bmm_nt(pool[tb["syrk_i"]], pool[tb["syrk_j"]], prec)
            pool = pool.at[tb["syrk_dst"]].add(-u)
        if "potrf_blk" in tb:
            blk = tb["potrf_blk"]
            out = _potrf_batch_blocked(pool[blk], tb["potrf_k"], nb,
                                       precision=prec)
            pool = pool.at[blk].set(out)
        if "trsm_diag" in tb:
            out = _trsm_batch(pool[tb["trsm_diag"]], pool[tb["trsm_dst"]],
                              tb["trsm_k"], nb)
            pool = pool.at[tb["trsm_dst"]].set(out)
        return pool, None

    for bt in buckets_dev:
        tb = {k: v for k, v in bt.items() if v.shape[1] > 0}
        if not tb:
            continue
        pool, _ = jax.lax.scan(level_body, pool, tb)
    return pool


def _solve_scan_phase(pool, x, buckets_dev, n, nb, prec, forward):
    """Level-scan solve phase (XLA path of solve_scan.ScanSolveExecutor)."""
    import jax
    import jax.numpy as jnp

    iota = jax.lax.broadcasted_iota(jnp.int32, (1, nb), 1)

    def sol_op(x, tb):
        blk = tb["sol_blk"]
        rows = tb["sol_rows"]
        kvec = tb["sol_k"]
        tiles = pool[blk]
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

    def upd_op(x, tb):
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

    # sol and upd share bucket spans (built together), so one scan per
    # bucket preserves the global level order with the fixed phase order
    # inside a level (fwd: sol then upd; bwd: upd then sol)
    for bt in buckets_dev:
        tb = {k: v for k, v in bt.items() if v.shape[1] > 0}
        has_sol = "sol_blk" in tb
        has_upd = "upd_blk" in tb
        if not (has_sol or has_upd):
            continue

        def body(x, tb2):
            ts = {k: v for k, v in tb2.items() if k.startswith("sol_")}
            tu = {k: v for k, v in tb2.items() if k.startswith("upd_")}
            if forward:
                if ts:
                    x = sol_op(x, ts)
                if tu:
                    x = upd_op(x, tu)
            else:
                if tu:
                    x = upd_op(x, tu)
                if ts:
                    x = sol_op(x, ts)
            return x, None

        x, _ = jax.lax.scan(body, x, tb)
    return x


# ------------------------------------------------------------------------- #
def make_sharded_factorize(md: MultiDeviceFactor, mesh, dtype,
                           precision="highest"):
    """Jittable SPMD factorization step over mesh axis 'tree'.

    step(pools, top_init) -> factored pools (sharded); pools
    [ndev, nlocal*nb, nb] sharded, top_init [ntop*nb, nb] replicated.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    nb = md.nb
    part = md.part
    ntop = part.ntop

    def dev_tables(buckets):
        return [{k: jnp.asarray(np.minimum(v, 2**31 - 1), jnp.int32)
                 for k, v in b.items()} for b in buckets]

    a_tabs = dev_tables(md.a_buckets)
    c_tabs = dev_tables(md.c_buckets)
    maps = jnp.asarray(md.maps, jnp.int32)
    srcvec = jnp.asarray(md.srcvec_local, jnp.int32)
    blk_n = jnp.asarray(md.blk_n_local, jnp.int32)
    psum_slices = _top_psum_slices(md)

    def step(pools, top_init):
        def inner(pool_shard, top_init, blk_n_shard, srcvec_shard,
                  a_shard):
            pool = pool_shard[0].reshape(part.nlocal, nb, nb)
            bn = blk_n_shard[0]
            sv = srcvec_shard[0]
            a_local = [{k: v[0] for k, v in bt.items()} for bt in a_shard]
            # phase A with OVERLAPPED ancestor reduction: after each
            # bucket scan, psum only the top blocks whose LAST phase-A
            # contribution lies in that bucket — the collective for
            # bucket i has no consumer before phase C, so XLA can run
            # it concurrently with bucket i+1's local compute (the
            # reduce-scatter/compute overlap of SURVEY §7 step 7; the
            # single blocking whole-top psum was round-3 weak #3)
            top = top_init.reshape(max(1, ntop), nb, nb)
            for bi, bt in enumerate(a_local):
                pool = _factor_scan_phase(pool, [bt], maps, bn, sv,
                                          md.cmax, nb, precision)
                idx = psum_slices[bi]
                if len(idx):
                    contrib = jax.lax.psum(pool[idx], "tree")
                    top = top.at[idx].add(contrib)
            pool = pool.at[:ntop].set(top[:ntop])
            c_local = [{k: v[0] for k, v in bt.items()} for bt in c_tabs]
            pool = _factor_scan_phase(pool, c_local, maps, bn, sv,
                                      md.cmax, nb, precision)
            return pool.reshape(1, part.nlocal * nb, nb)

        fn = shard_map(
            inner, mesh=mesh,
            in_specs=(P("tree"), P(), P("tree"), P("tree"),
                      [{k: P("tree") for k in bt} for bt in a_tabs]),
            out_specs=P("tree"), check_vma=False)
        return fn(pools, top_init, blk_n, srcvec, a_tabs)

    return step


def _top_psum_slices(md: MultiDeviceFactor):
    """Per phase-A bucket, the top-block ids whose LAST contribution from
    any device lands in that bucket (host-side; drives the overlapped
    ancestor reduction).  Blocks no device writes go in bucket 0 (their
    contribution is the replicated zero — psum'ing them there keeps the
    assembled-top add uniform)."""
    ntop = md.part.ntop
    nbuckets = len(md.a_spans)
    if ntop == 0 or nbuckets == 0:
        return [np.empty(0, np.int64)] * max(1, nbuckets)
    last_lvl = np.zeros(ntop, dtype=np.int64)
    for kind, tasks_per_dev in md.a_tasks.items():
        di = 1 if kind != "trsm" else 2   # dst field position
        if kind == "potrf":
            continue                      # potrf never targets the top
        for tl in tasks_per_dev:
            for t in tl:
                dst = t[di] if kind != "syrk" else t[3]
                if dst < ntop:
                    last_lvl[dst] = max(last_lvl[dst], t[0])
    bucket_of = np.zeros(ntop, dtype=np.int64)
    for bi, (s, e) in enumerate(md.a_spans):
        sel = (last_lvl >= s) & (last_lvl <= e)
        bucket_of[sel] = bi
    return [np.nonzero(bucket_of == bi)[0] for bi in range(nbuckets)]


def make_sharded_solve(md: MultiDeviceFactor, mesh, precision="highest",
                       job: int = 0):
    """Jittable SPMD fwd+bwd solve over mesh axis 'tree'.

    step(pools, x) with pools sharded [ndev, nlocal*nb, nb] (factored)
    and x replicated [n+1, nrhs]; returns the replicated solution panel.
    ``job`` follows the reference job table (include/spllt_iface.h):
    0 = fwd+bwd, 1 = forward only, 2 = backward only.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    nb = md.nb
    part = md.part
    n = md.n

    def dev_tables(buckets):
        return [{k: jnp.asarray(np.minimum(v, 2**31 - 1), jnp.int32)
                 for k, v in b.items()} for b in buckets]

    tabs = {k: dev_tables(v) for k, v in md.fsolve.items()}

    def peel(buckets):
        return [{k: v[0] for k, v in bt.items()} for bt in buckets]

    # replicated top tables are captured as constants ([1, ...] peeled)
    fwd_c = peel(tabs["fwd_c"])
    bwd_c = peel(tabs["bwd_c"])

    def step(pools, x):
        def inner(pool_shard, x, fwd_a, bwd_a):
            pool = pool_shard[0].reshape(part.nlocal, nb, nb)
            fa = [{k: v[0] for k, v in bt.items()} for bt in fwd_a]
            ba = [{k: v[0] for k, v in bt.items()} for bt in bwd_a]
            if job in (0, 1):
                # ---- forward: local subtrees -> psum -> replicated top
                x0 = x
                xl = _solve_scan_phase(pool, x, fa, n, nb, precision,
                                       True)
                x = x0 + jax.lax.psum(xl - x0, "tree")
                x = _solve_scan_phase(pool, x, fwd_c, n, nb, precision,
                                      True)
            if job in (0, 2):
                # ---- backward: replicated top -> local subtrees -> psum
                x = _solve_scan_phase(pool, x, bwd_c, n, nb, precision,
                                      False)
                x0 = x
                xl = _solve_scan_phase(pool, x, ba, n, nb, precision,
                                       False)
                x = x0 + jax.lax.psum(xl - x0, "tree")
            return x

        specs_a = [[{k: P("tree") for k in bt} for bt in tabs["fwd_a"]],
                   [{k: P("tree") for k in bt} for bt in tabs["bwd_a"]]]
        fn = shard_map(
            inner, mesh=mesh,
            in_specs=tuple([P("tree"), P()] + specs_a),
            out_specs=P(), check_vma=False)
        return fn(pools, x, tabs["fwd_a"], tabs["bwd_a"])

    return step


def reconstruct_global_pool(md: MultiDeviceFactor, pools, plan):
    """Gather the sharded factored pools back into the global block pool
    layout (host side; the gather.jdf analogue)."""
    nb = md.nb
    part = md.part
    pools = np.asarray(pools)
    out = np.zeros((plan.nblocks, nb, nb), dtype=pools.dtype)
    for b in range(plan.nblocks):
        d = part.blk_dev[b]
        lb = int(part.blk_local[b])
        src = pools[0 if d == -1 else d].reshape(part.nlocal, nb, nb)
        out[b] = src[lb]
    return out


# ------------------------------------------------------------------------- #
def dryrun(n_devices: int, m: int = 16, nb: int = 8, nemin: int = 4,
           grid3d: bool = False, check: bool = True) -> None:
    """Create an n-device mesh of virtual CPU devices, jit the full
    multi-device factorization + solve step with real tree shardings, run
    it, and (optionally) check factor and solution against the sequential
    oracle."""
    import os

    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count="
            f"{max(8, n_devices)}").strip()

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from .. import Options, analyse, poisson2d, poisson3d
    from ..plan.blocking import build_block_plan
    from ..plan.factor_tasks import build_factor_plan
    from ..plan.solve_tasks import build_solve_plan

    devs = jax.devices("cpu")[:n_devices]
    assert len(devs) == n_devices, (
        f"need {n_devices} devices, have {len(devs)}")
    mesh = Mesh(np.array(devs), ("tree",))

    if grid3d:
        a = poisson3d(m)
        opts = Options(ordering="nd-grid", grid_shape=(m,) * 3, nb=nb,
                       nemin=nemin, ndevices=n_devices, prune_tree=True)
    else:
        a = poisson2d(m)
        opts = Options(ordering="nd-grid", grid_shape=(m, m), nb=nb,
                       nemin=nemin, ndevices=n_devices, prune_tree=True)
    symb = analyse(a, opts)
    plan = build_block_plan(symb, opts.nb)
    fplan = build_factor_plan(symb, plan)
    splan = build_solve_plan(symb, plan)
    md = build_multidevice_factor(symb, plan, fplan, n_devices,
                                  splan=splan)

    dtype = np.float32
    pools_np, top_np = md.local_pools(symb.a_perm.values, dtype=dtype)
    fstep = make_sharded_factorize(md, mesh, dtype)
    sstep = make_sharded_solve(md, mesh)

    pools = jax.device_put(
        jnp.asarray(pools_np), NamedSharding(mesh, P("tree")))
    top_init = jax.device_put(
        jnp.asarray(top_np), NamedSharding(mesh, P()))
    n = symb.n
    rng = np.random.default_rng(0)
    xt = rng.standard_normal((n, 2))
    b = a.matvec(xt)
    x0 = np.zeros((n + 1, 2), dtype=np.float32)
    x0[:n] = b[symb.perm]

    def full(pools, top_init, x0):
        fp = fstep(pools, top_init)
        return fp, sstep(fp, x0)

    jfull = jax.jit(full)
    out, xs = jfull(pools, top_init, jnp.asarray(x0))
    out.block_until_ready()

    x = np.empty((n, 2))
    x[symb.perm] = np.asarray(xs)[:n]
    res = float(np.linalg.norm(a.matvec(x) - b)
                / np.linalg.norm(b))
    assert res < 1e-4, f"multi-device solve residual too large: {res}"
    if check:
        from ..numeric.assemble import assemble_np
        from ..numeric.stf import factorize_np

        g = reconstruct_global_pool(md, out, plan)
        pool_ref = assemble_np(plan, symb.a_perm.values, dtype=np.float64)
        pool_ref = factorize_np(pool_ref, fplan)
        err = float(np.max(np.abs(g - pool_ref[:plan.nblocks])))
        assert err < 1e-3, f"multi-device factor mismatch: {err}"
        print(f"dryrun_multichip({n_devices}): max |Δpool| = {err:.2e}, "
              f"solve residual = {res:.2e} ok")
    else:
        print(f"dryrun_multichip({n_devices}): solve residual = "
              f"{res:.2e} ok")
