"""Plan statistics.

Analogue of ``spllt_tree_stat_mod`` (dependency-count statistics,
/root/reference/src/spllt_tree_stat_mod.F90) extended with the numbers
that matter for a statically scheduled device program: level-width
distribution, padding overhead of the bucketed schedule, and per-kind
task/flop breakdowns.  Used as structural sanity checks in tests and
printed by the CLI with --stats.
"""

from __future__ import annotations

import numpy as np

__all__ = ["factor_plan_stats", "print_stats"]


def factor_plan_stats(fp, buckets=None) -> dict:
    counts = fp.level_counts()
    widths = {k: (int(v.max()) if len(v) else 0) for k, v in counts.items()}
    total = {k: int(v.sum()) for k, v in counts.items()}
    nb = fp.nb
    updbt_width = int(fp.updbt_c.sum()) if len(fp.updbt_c) else 0
    flops = {
        "potrf": total["potrf"] * nb ** 3 / 3,
        "trsm": total["trsm"] * nb ** 3,
        "syrk": total["syrk"] * 2 * nb ** 3,
        "updbt": updbt_width * 2 * nb ** 3,  # width-fused tasks
    }
    out = {
        "nlevels": fp.nlevels,
        "nblocks": fp.nblocks,
        "num_tasks": fp.num_tasks,
        "tasks_per_kind": total,
        "max_level_width": widths,
        "mean_level_width": {
            k: float(v.sum()) / max(1, fp.nlevels)
            for k, v in counts.items()},
        "nominal_flops_per_kind": flops,
        "num_maps": int(fp.maps.shape[0]),
        "map_bytes": int(fp.maps.nbytes),
    }
    if buckets is not None:
        real = sum(total.values())
        padded = sum(b.widths[k] * (b.lvl_end - b.lvl_start + 1)
                     for b in buckets for k in b.widths)
        out["nbuckets"] = len(buckets)
        out["padding_ratio"] = padded / max(1, real)
    return out


def print_stats(stats: dict, out=None) -> str:
    lines = []
    for k, v in stats.items():
        lines.append(f"{k:>24}: {v}")
    text = "\n".join(lines)
    if out is not None:
        print(text, file=out)
    return text
