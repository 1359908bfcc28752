"""Statistics returned by analyse/factor/solve.

Analogue of ``spllt_inform`` (/root/reference/src/spllt_data_mod.F90:301-309):
flag, maxdepth, num_factor (nnz L), num_flops, num_nodes.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Inform:
    flag: int = 0
    maxdepth: int = 0
    num_factor: int = 0      # entries in L (supernodal, incl. explicit zeros)
    num_flops: int = 0       # flops for the factorization
    num_nodes: int = 0
    # planning statistics (level schedule)
    num_blocks: int = 0
    num_levels: int = 0
    num_tasks: int = 0
