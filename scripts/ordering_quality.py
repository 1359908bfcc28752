"""Ordering quality: fill, flops AND level-schedule balance per ordering.

The reference delegates ordering to METIS via SPRAL SSIDS; we own the
orderings, so this sweep documents their quality on the fixture families
on the fixture families.  For a level-scheduled design the tree SHAPE
matters beyond fill: fewer, wider levels = more independent tasks per
batched device call, so the table reports the factor-plan level
count and mean/max level width too.  Host-only (symbolic), no device.

    python scripts/ordering_quality.py
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from spllt_tpu import (Options, analyse, fem3d, poisson2d, poisson3d,  # noqa
                       random_spd)
from spllt_tpu.plan.blocking import build_block_plan  # noqa: E402
from spllt_tpu.plan.factor_tasks import build_factor_plan  # noqa: E402


def main() -> int:
    mats = [
        ("poisson2d_64", poisson2d(64), (64, 64)),
        ("poisson3d_20", poisson3d(20), (20, 20, 20)),
        ("fem3d_12", fem3d(12), None),
        ("fem3d_10_dof3", fem3d(10, dofs=3), None),
        ("randspd_5000", random_spd(5000, density=0.002, seed=7), None),
    ]
    print(f"{'matrix':16s} {'n':>7s} {'ordering':>8s} {'nnz(L)':>12s} "
          f"{'flops':>12s} {'nodes':>7s} {'levels':>7s} {'w_mean':>7s} "
          f"{'w_max':>7s}")
    for name, a, gs in mats:
        for ordering in ("amd", "nd", "nd-grid", "rcm", "natural"):
            if ordering == "nd-grid" and gs is None:
                continue
            try:
                s = analyse(a, Options(ordering=ordering, grid_shape=gs,
                                       nemin=32, prune_tree=False))
                plan = build_block_plan(s, 64)
                fp = build_factor_plan(s, plan)
                # per-level task counts = schedule width profile
                widths = np.array([
                    (fp.potrf_ptr[l + 1] - fp.potrf_ptr[l])
                    + (fp.trsm_ptr[l + 1] - fp.trsm_ptr[l])
                    + (fp.syrk_ptr[l + 1] - fp.syrk_ptr[l])
                    for l in range(1, fp.nlevels + 1)])
            except Exception as e:  # pragma: no cover
                print(f"{name:16s} {a.n:7d} {ordering:>8s}  FAILED: {e}")
                continue
            wmean = f"{widths.mean():7.1f}" if widths.size else "      -"
            wmax = f"{widths.max():7d}" if widths.size else "      -"
            print(f"{name:16s} {a.n:7d} {ordering:>8s} "
                  f"{s.inform.num_factor:12d} {s.inform.num_flops:12d} "
                  f"{s.nnodes:7d} {fp.nlevels:7d} {wmean} {wmax}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
