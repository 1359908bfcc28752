"""Compressed-sparse-column symmetric matrix container.

Analogue of the reference's matrix handling (SpLLT keeps the user's
lower-triangle CSC ``ptr/row/val`` and verifies it with SPRAL ``cscl_verify``;
see /root/reference/test/test_solve_phasis.F90:158-163 and
/root/reference/src/spllt_mod.F90:426-495).  We store the lower triangle
(diagonal included) of a symmetric positive-definite matrix in CSC form with
0-based indices, sorted rows per column.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["CscMatrix", "CscError"]


class CscError(ValueError):
    """Raised when a CSC structure fails verification."""


@dataclasses.dataclass
class CscMatrix:
    """Lower-triangle CSC storage of a symmetric matrix.

    Attributes:
      n: matrix dimension.
      colptr: int64[n+1] column pointers.
      rowind: int64[nnz] row indices (>= column index, sorted per column).
      values: float64[nnz] numerical values (may be None for pattern-only).
    """

    n: int
    colptr: np.ndarray
    rowind: np.ndarray
    values: np.ndarray | None = None

    # ------------------------------------------------------------------ #
    @property
    def nnz(self) -> int:
        return int(self.colptr[-1])

    # ------------------------------------------------------------------ #
    @classmethod
    def from_coo(
        cls,
        n: int,
        rows: np.ndarray,
        cols: np.ndarray,
        vals: np.ndarray | None = None,
        *,
        sum_duplicates: bool = True,
    ) -> "CscMatrix":
        """Build from COO triplets.  Entries are mapped to the lower triangle
        (entries with r < c are transposed); duplicates are summed."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        lo_r = np.maximum(rows, cols)
        lo_c = np.minimum(rows, cols)
        key = lo_c * n + lo_r
        order = np.argsort(key, kind="stable")
        key = key[order]
        lo_r, lo_c = lo_r[order], lo_c[order]
        if vals is not None:
            vals = np.asarray(vals, dtype=np.float64)[order]
        uniq_mask = np.ones(len(key), dtype=bool)
        uniq_mask[1:] = key[1:] != key[:-1]
        if sum_duplicates and vals is not None:
            seg = np.cumsum(uniq_mask) - 1
            vsum = np.zeros(int(seg[-1]) + 1 if len(seg) else 0)
            np.add.at(vsum, seg, vals)
            vals = vsum
        elif vals is not None:
            vals = vals[uniq_mask]
        lo_r, lo_c = lo_r[uniq_mask], lo_c[uniq_mask]
        colptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(colptr, lo_c + 1, 1)
        colptr = np.cumsum(colptr)
        return cls(n=n, colptr=colptr, rowind=lo_r, values=vals)

    # ------------------------------------------------------------------ #
    @classmethod
    def from_scipy(cls, mat) -> "CscMatrix":
        """Build from any scipy.sparse matrix (symmetric; lower kept)."""
        coo = mat.tocoo()
        mask = coo.row >= coo.col
        return cls.from_coo(
            mat.shape[0], coo.row[mask], coo.col[mask], coo.data[mask],
            sum_duplicates=False,
        )

    def to_scipy(self):
        """Return the full symmetric matrix as scipy.sparse.csc_matrix."""
        import scipy.sparse as sp

        lower = sp.csc_matrix(
            (self.values, self.rowind, self.colptr), shape=(self.n, self.n)
        )
        strict = sp.tril(lower, k=-1)
        return (lower + strict.T).tocsc()

    # ------------------------------------------------------------------ #
    def verify(self) -> None:
        """Structural verification (analogue of SPRAL ``cscl_verify``).

        Checks: monotone colptr, in-range sorted row indices, rows >= col
        (lower triangle), diagonal entry present in every column.
        """
        n, colptr, rowind = self.n, self.colptr, self.rowind
        if len(colptr) != n + 1 or colptr[0] != 0:
            raise CscError("bad colptr")
        if np.any(np.diff(colptr) < 0):
            raise CscError("colptr not monotone")
        if len(rowind) != colptr[-1]:
            raise CscError("rowind length mismatch")
        if self.values is not None and len(self.values) != colptr[-1]:
            raise CscError("values length mismatch")
        # vectorized per-entry checks (the per-column Python loop dominated
        # analyse time on ~100k-row matrices)
        counts = np.diff(colptr)
        empty = counts == 0
        diag_ok = np.zeros(n, dtype=bool)
        diag_ok[~empty] = (rowind[colptr[:-1][~empty]]
                           == np.nonzero(~empty)[0])
        if not diag_ok.all():
            j = int(np.nonzero(~diag_ok)[0][0])
            raise CscError(f"missing diagonal in column {j}")
        cols = np.repeat(np.arange(n, dtype=np.int64), counts)
        bad = (rowind < cols) | (rowind >= n)
        if bad.any():
            j = int(cols[np.nonzero(bad)[0][0]])
            raise CscError(f"row index out of range in column {j}")
        if len(rowind) > 1:
            nondec = np.diff(rowind) <= 0
            nondec[colptr[1:-1] - 1] = False   # column boundaries
            if nondec.any():
                j = int(cols[np.nonzero(nondec)[0][0]])
                raise CscError(f"unsorted/duplicate rows in column {j}")

    # ------------------------------------------------------------------ #
    def permute(self, perm: np.ndarray) -> "CscMatrix":
        """Symmetric permutation: returns B with B[i,j] = A[perm[i], perm[j]].

        ``perm[i]`` is the original index placed at position ``i`` (the
        reference keeps the inverse as ``fkeep%porder``,
        /root/reference/src/spllt_analyse_mod.F90:555-558).
        """
        iperm = np.empty(self.n, dtype=np.int64)
        iperm[perm] = np.arange(self.n, dtype=np.int64)
        cols = np.repeat(np.arange(self.n), np.diff(self.colptr))
        new_r = iperm[self.rowind]
        new_c = iperm[cols]
        return CscMatrix.from_coo(self.n, new_r, new_c, self.values,
                                  sum_duplicates=False)

    # ------------------------------------------------------------------ #
    def matvec(self, x: np.ndarray) -> np.ndarray:
        """y = A x using the symmetric structure (host-side, for residuals)."""
        cols = np.repeat(np.arange(self.n), np.diff(self.colptr))
        r, c, v = self.rowind, cols, self.values
        x = np.asarray(x, dtype=np.float64)
        if x.ndim == 1:
            y = np.zeros(self.n)
            np.add.at(y, r, v * x[c])
            off = r != c
            np.add.at(y, c[off], v[off] * x[r[off]])
        else:
            y = np.zeros_like(x)
            np.add.at(y, r, v[:, None] * x[c])
            off = r != c
            np.add.at(y, c[off], v[off][:, None] * x[r[off]])
        return y
