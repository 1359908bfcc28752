"""Generate the matrix-suite SPD fixtures (Rutherford-Boeing).

The reference sweeps 37 SuiteSparse SPD matrices (aux/list.matrix,
run_tests.sh:41-96); this environment has no network egress, so we
generate structurally similar families natively and store them as .rb
files — the same interchange format the reference reads via SPRAL
rb_read.

    python scripts/make_fixtures.py [--out fixtures] [--big]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from spllt_tpu import fem3d, poisson2d, poisson3d, random_spd  # noqa: E402
from spllt_tpu.sparse.io import write_rutherford_boeing  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="fixtures")
    ap.add_argument("--big", action="store_true",
                    help="also generate the larger matrices")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    suite = [
        # (name, ctor) — classes mirroring the reference's list.matrix mix
        ("poisson2d_64", lambda: poisson2d(64)),
        ("poisson3d_20", lambda: poisson3d(20)),
        ("fem3d_12", lambda: fem3d(12)),            # bcsstk-class (27-pt)
        ("fem3d_10_dof3", lambda: fem3d(10, dofs=3)),  # shell/dof class
        ("randspd_5000", lambda: random_spd(5000, density=0.002, seed=7)),
    ]
    if args.big:
        suite += [
            ("poisson3d_48", lambda: poisson3d(48)),
            ("fem3d_24", lambda: fem3d(24)),
            ("fem3d_16_dof3", lambda: fem3d(16, dofs=3)),
        ]
    for name, ctor in suite:
        a = ctor()
        path = os.path.join(args.out, f"{name}.rb")
        write_rutherford_boeing(path, a, title=name)
        print(f"{path}: n={a.n} nnz={a.colptr[-1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
