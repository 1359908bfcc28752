"""On-device sparse matvec (ELL format) for iterative refinement.

The reference solves entirely in float64 and needs no refinement
(utils_mod.F90 residual checks only).  This package factors in float32
and restores double-precision backward error with iterative refinement.
Computing the residual ``r = b - A x`` on the host costs two device
transfers of the rhs panel per step; here the permuted matrix is kept on
device in padded ELL rows and the residual is a gather + float64
elementwise reduction, so the whole refined solve runs as ONE device
program.

ELL layout: for row i of the FULL (symmetrized) permuted pattern,
``idx[i, :] `` holds column ids (padded with n → the x dump row, which is
kept zero) and ``vals[i, :]`` the float64 values (padded with 0).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["EllMatrix", "build_ell", "ell_vals"]


@dataclasses.dataclass
class EllMatrix:
    n: int
    kmax: int
    idx: np.ndarray        # int32 [n, kmax], pad = n
    # per-slot source position in the lower-CSC values array (for cheap
    # per-factorization value refresh); -1 = pad
    src: np.ndarray        # int64 [n, kmax]


def _full_pattern(a):
    """(rows, cols, src) triplets of the symmetrized pattern; src indexes
    the lower-CSC values array."""
    n = a.n
    colptr = np.asarray(a.colptr, dtype=np.int64)
    r = np.asarray(a.rowind, dtype=np.int64)
    c = np.repeat(np.arange(n, dtype=np.int64), np.diff(colptr))
    src = np.arange(len(r), dtype=np.int64)
    off = r != c
    rows = np.concatenate([r, c[off]])
    cols = np.concatenate([c, r[off]])
    srcs = np.concatenate([src, src[off]])
    return rows, cols, srcs


def build_ell(a) -> EllMatrix:
    """Build the ELL index structure from a lower-CSC matrix (pattern
    only; values are refreshed per factorization via :func:`ell_vals`)."""
    n = a.n
    rows, cols, srcs = _full_pattern(a)
    order = np.argsort(rows, kind="stable")
    rows, cols, srcs = rows[order], cols[order], srcs[order]
    counts = np.bincount(rows, minlength=n)
    kmax = int(counts.max(initial=1))
    start = np.concatenate([[0], np.cumsum(counts)])
    slot = np.arange(len(rows)) - start[rows]
    idx = np.full((n, kmax), n, dtype=np.int32)
    src = np.full((n, kmax), -1, dtype=np.int64)
    idx[rows, slot] = cols.astype(np.int32)
    src[rows, slot] = srcs
    return EllMatrix(n=n, kmax=kmax, idx=idx, src=src)


def ell_vals(ell: EllMatrix, values: np.ndarray) -> np.ndarray:
    """float64 [n, kmax] ELL values from the lower-CSC values array."""
    v = np.zeros(ell.src.shape, dtype=np.float64)
    sel = ell.src >= 0
    v[sel] = np.asarray(values, dtype=np.float64)[ell.src[sel]]
    return v


def spmv(vals, idx, x):
    """y = A x on device.  ``x`` is [n+1, nrhs] (dump row zero); returns
    [n, nrhs] in x.dtype (use float64 inputs for refinement residuals)."""
    g = x[idx]                               # [n, kmax, nrhs]
    return (vals[..., None] * g).sum(axis=1)
