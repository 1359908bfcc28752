"""Elimination tree and postorder.

Replacement for the tree construction SpLLT outsources to SPRAL
SSIDS (``ssids_analyse`` returns sptr/sparent/rptr/rlist,
/root/reference/src/spllt_analyse_mod.F90:129-131).  Host-side NumPy; a C++
fast path lives in native/symbolic.cpp (bound via spllt_tpu.analyse.native).
"""

from __future__ import annotations

import numpy as np

__all__ = ["etree", "postorder", "depth"]


def etree(n: int, colptr: np.ndarray, rowind: np.ndarray) -> np.ndarray:
    """Elimination tree of a symmetric matrix given its lower-triangle CSC.

    Liu's algorithm with path-compression ancestors.  The classic formulation
    consumes upper-triangle columns; a lower-triangle column c with rows r>=c
    supplies exactly the upper entries (c, r) of columns r, so we iterate the
    lower structure transposed (row-grouped), which is what ``np.argsort`` of
    rowind provides.

    Returns parent[n] with -1 for roots.
    """
    from .native import native_etree_or_none

    nat = native_etree_or_none(n, colptr, rowind)
    if nat is not None:
        return nat
    parent = np.full(n, -1, dtype=np.int64)
    ancestor = np.full(n, -1, dtype=np.int64)
    cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(colptr))
    # group entries by row r ascending → for each j (=r) the i's (=c) with i<j
    order = np.argsort(rowind, kind="stable")
    rs = rowind[order]
    cs = cols[order]
    for k in range(len(rs)):
        j = rs[k]
        i = cs[k]
        while i != -1 and i < j:
            inext = ancestor[i]
            ancestor[i] = j
            if inext == -1:
                parent[i] = j
            i = inext
    return parent


def postorder(parent: np.ndarray) -> np.ndarray:
    """Postorder permutation of a forest.

    Children are visited in ascending order (deterministic).  Returns
    ``post`` with post[k] = k-th node in postorder.
    """
    n = len(parent)
    from .native import native_postorder_or_none

    nat = native_postorder_or_none(parent)
    if nat is not None:
        return nat
    # children linked lists, built so iteration yields ascending child order
    head = np.full(n, -1, dtype=np.int64)
    nxt = np.full(n, -1, dtype=np.int64)
    roots = []
    for v in range(n - 1, -1, -1):
        p = parent[v]
        if p == -1:
            roots.append(v)
        else:
            nxt[v] = head[p]
            head[p] = v
    roots.reverse()  # ascending roots
    post = np.empty(n, dtype=np.int64)
    k = 0
    # iterative DFS emitting nodes after their children
    stack: list[int] = list(reversed(roots))
    state = np.full(n, -2, dtype=np.int64)  # next child to visit
    while stack:
        v = stack[-1]
        if state[v] == -2:
            state[v] = head[v]
        c = state[v]
        if c == -1:
            post[k] = v
            k += 1
            stack.pop()
        else:
            state[v] = nxt[c]
            stack.append(c)
    assert k == n
    return post


def depth(parent: np.ndarray) -> int:
    """Maximum depth of the forest (reference reports ``maxdepth`` in
    spllt_inform, /root/reference/src/spllt_data_mod.F90:301-309)."""
    n = len(parent)
    maxd = 0
    children: list[list[int]] = [[] for _ in range(n)]
    roots = []
    for v in range(n):
        p = parent[v]
        if p == -1:
            roots.append(v)
        else:
            children[p].append(v)
    stack = [(r, 1) for r in roots]
    while stack:
        v, dv = stack.pop()
        maxd = max(maxd, dv)
        for c in children[v]:
            stack.append((c, dv + 1))
    return maxd
