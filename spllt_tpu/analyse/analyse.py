"""Top-level symbolic analyse phase.

Counterpart of ``spllt_analyse``
(/root/reference/src/spllt_analyse_mod.F90:23-157): ordering → elimination
tree → postorder → supernodes/amalgamation → flop weights → tree pruning
marks.  The result (:class:`SymbolicFactor`) plays the role of
``spllt_akeep`` + the node/tree part of ``spllt_fkeep``
(/root/reference/src/spllt_data_mod.F90:315-327, 333-388).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..inform import Inform
from ..options import Options
from ..sparse.csc import CscMatrix
from .etree import depth as tree_depth
from .etree import etree, postorder
from .ordering import compute_ordering
from .supernodes import SupernodeForest, find_supernodes

__all__ = ["SymbolicFactor", "analyse"]


@dataclasses.dataclass
class SymbolicFactor:
    """Symbolic factorization (akeep analogue).  All structure indices refer
    to the final permuted ordering; ``perm`` maps back to user indices."""

    n: int
    perm: np.ndarray               # perm[i] = user index at permuted pos i
    a_perm: CscMatrix              # permuted lower-CSC pattern+values holder
    forest: SupernodeForest
    weight: np.ndarray             # flops per subtree (spllt_symbolic analogue)
    node_flops: np.ndarray         # flops per node (excl. descendants)
    small: np.ndarray              # pruning marks (spllt_prune_tree analogue)
    inform: Inform = dataclasses.field(default_factory=Inform)
    options: Options = dataclasses.field(default_factory=Options)

    @property
    def nnodes(self) -> int:
        return self.forest.nnodes


def _node_stats(forest: SupernodeForest) -> tuple[np.ndarray, int, int]:
    """Per-node flops and global nnz(L)/flop counts.

    Mirrors ``spllt_symbolic``: weight(node) = Σ_{j=1..n} (m-n+j)² for an
    m×n nodal matrix (/root/reference/src/spllt_analyse_mod.F90:990-1029);
    num_factor = Σ_j (m-j+1) per node.
    """
    m = np.diff(forest.rptr)                       # rows per node
    w = forest.en - forest.sa + 1                  # cols per node
    # Σ_{j=0..w-1} (m-j)² = Σ_{t=m-w+1..m} t²  via  S(x)=x(x+1)(2x+1)/6
    s2 = lambda x: x * (x + 1) * (2 * x + 1) // 6
    flops = s2(m) - s2(m - w)
    nfact = m * w - w * (w - 1) // 2               # Σ_{j=0..w-1} (m-j)
    return flops, int(nfact.sum()), int(flops.sum())


def _subtree_weights(forest: SupernodeForest,
                     node_flops: np.ndarray) -> np.ndarray:
    w = node_flops.astype(np.float64).copy()
    for nd in range(forest.nnodes):  # children have smaller ids (postorder)
        p = forest.sparent[nd]
        if p != -1:
            w[p] += w[nd]
    return w


def analyse(a: CscMatrix, options: Options | None = None) -> SymbolicFactor:
    """Symbolic analysis of a symmetric positive-definite CSC matrix."""
    options = options or Options()
    a.verify()

    perm0 = compute_ordering(a, options.ordering, options.grid_shape)
    a1 = a.permute(perm0)
    parent1 = etree(a1.n, a1.colptr, a1.rowind)
    post = postorder(parent1)
    # compose permutations: position i finally holds user index perm0[post[i]]
    perm = perm0[post]
    a2 = a1.permute(post)
    parent2 = etree(a2.n, a2.colptr, a2.rowind)

    forest = find_supernodes(a2.n, a2.colptr, a2.rowind, parent2,
                             nemin=options.nemin)
    node_flops, num_factor, num_flops = _node_stats(forest)
    weight = _subtree_weights(forest, node_flops)

    from .prune import prune_tree

    small = (prune_tree(forest, weight, options.ndevices)
             if options.prune_tree else
             np.zeros(forest.nnodes, dtype=np.int64))

    inform = Inform(
        flag=0,
        maxdepth=tree_depth(parent2),
        num_factor=num_factor,
        num_flops=num_flops,
        num_nodes=forest.nnodes,
    )
    return SymbolicFactor(
        n=a.n, perm=perm, a_perm=a2, forest=forest, weight=weight,
        node_flops=node_flops, small=small, inform=inform, options=options,
    )
