"""Level bucketing: compress the level schedule into a few lax.scan loops.

The unrolled executor emits one XLA call site per (level, kind) — compile
time grows linearly with tree depth.  Here
consecutive levels with similar task-count profiles are grouped into
*buckets*; within a bucket every level is padded to the bucket's per-kind
maximum width and the bucket executes as ONE ``lax.scan`` over levels, so
each kernel has a single call site per bucket.  Padding tasks are no-ops
against a scratch block (the analogue of the reference executing nothing —
SpLLT's runtimes simply have idle workers near the root, SURVEY §2.10).

Bucket boundaries are chosen greedily: a level joins the current bucket
unless doing so would push the bucket's padding overhead (padded work /
real work, weighted per kind) above ``alpha``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Bucket", "make_buckets", "pad_tables"]


@dataclasses.dataclass
class Bucket:
    lvl_start: int            # first level (inclusive)
    lvl_end: int              # last level (inclusive)
    widths: dict              # kind -> K (padded width)
    tables: dict              # kind_field -> [nlev_b, K] int32 array


# relative cost of one padded task per kind (triangular solves dominate)
_W = {"potrf": 2.0, "trsm": 1.0, "syrk": 1.0, "updbt": 1.5, "sol": 2.0,
      "upd": 1.0}


def _weight(kind: str) -> float:
    return _W.get(kind, 1.0)


def make_buckets(counts: dict, nlevels: int, alpha: float = 1.6,
                 max_buckets: int = 12) -> list[tuple[int, int, dict]]:
    """counts: kind -> int array of per-level task counts (index 0 unused).
    Returns [(lvl_start, lvl_end, {kind: K})].

    Greedy with a per-bucket *absolute* padding budget: a level joins the
    current bucket while the bucket's padded-minus-real work stays under a
    share of the whole plan's work.  The budget is escalated until at most
    ``max_buckets`` buckets result (near the tree root levels are narrow,
    so padding them is cheap in absolute terms and deep chains collapse
    into one scan).
    """
    kinds = list(counts.keys())
    total = sum(_weight(k) * float(np.sum(counts[k][1:nlevels + 1]))
                for k in kinds)
    total = max(total, 1.0)

    def build(budget: float):
        out = []
        s = 1
        while s <= nlevels:
            e = s
            cur_max = {k: int(counts[k][s]) for k in kinds}
            real = {k: int(counts[k][s]) for k in kinds}
            while e + 1 <= nlevels:
                cand_max = {k: max(cur_max[k], int(counts[k][e + 1]))
                            for k in kinds}
                cand_real = {k: real[k] + int(counts[k][e + 1])
                             for k in kinds}
                nlev = e + 1 - s + 1
                padded = sum(_weight(k) * cand_max[k] * nlev
                             for k in kinds)
                actual = sum(_weight(k) * cand_real[k] for k in kinds)
                if padded - actual > budget:
                    break
                cur_max, real = cand_max, cand_real
                e += 1
            out.append((s, e, cur_max))
            s = e + 1
        return out

    budget = (alpha - 1.0) * total / max(1, max_buckets)
    for _ in range(20):
        out = build(budget)
        if len(out) <= max_buckets:
            return out
        budget *= 2.0
    return out


def pad_tables(span: tuple[int, int, dict], fields: dict, ptrs: dict,
               pad_values: dict) -> Bucket:
    """Build per-bucket padded tables.

    fields: kind -> {name: flat array} (level-bucketed by ptrs[kind]).
    pad_values: kind -> {name: pad scalar or pad row (for 2-D fields)}.
    """
    s, e, widths = span
    nlev = e - s + 1
    tables = {}
    for kind, fd in fields.items():
        k = widths[kind]
        ptr = ptrs[kind]
        for name, arr in fd.items():
            if arr.ndim == 1:
                buf = np.full((nlev, k), pad_values[kind][name],
                              dtype=np.int64)
            else:
                buf = np.tile(np.asarray(pad_values[kind][name],
                                         dtype=np.int64),
                              (nlev, k, 1))
            for li, lvl in enumerate(range(s, e + 1)):
                a, b = int(ptr[lvl]), int(ptr[lvl + 1])
                if b > a:
                    buf[li, : b - a] = arr[a:b]
            tables[f"{kind}_{name}"] = buf
    return Bucket(lvl_start=s, lvl_end=e, widths=widths, tables=tables)
