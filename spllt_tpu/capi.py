"""Python side of the C ABI (called from native/capi.cpp via CPython).

The reference ships a C interface over opaque akeep/fkeep handles
(/root/reference/include/spllt_iface.h:14-47,
interfaces/C/spllt_data_ciface.F90); this is its analogue: a
C caller links ``libspllt_tpu_c.so`` (built from native/capi.cpp, which
embeds CPython) and drives analyse/factor/solve on raw CSC arrays.  Raw
pointers cross the boundary as integers and are wrapped here with
ctypes + numpy without copying (inputs are copied once into the symbolic
object, results are written back through the caller's buffer).

Handles are integers into a process-global registry — the C side owns
their lifetime through spllt_tpu_free().
"""

from __future__ import annotations

import ctypes

import numpy as np

_registry: dict[int, object] = {}
_next_id = [1]


def _wrap(ptr: int, n: int, ctype):
    """numpy view of a raw C pointer (no copy)."""
    if n == 0:
        return np.empty(0, dtype=np.ctypeslib.as_ctypes_type(ctype))
    buf = (ctype * n).from_address(ptr)
    return np.ctypeslib.as_array(buf)


def _put(obj) -> int:
    h = _next_id[0]
    _next_id[0] += 1
    _registry[h] = obj
    return h


def analyse_c(n: int, nptr: int, ptr_addr: int, row_addr: int,
              nb: int, nemin: int, ordering: str, schedule: str,
              precision: str, refine: int) -> tuple[int, int, float, int]:
    """Returns (handle, num_factor, num_flops, num_nodes); handle 0 on
    error (error text is printed to stderr by the C wrapper's except
    hook)."""
    from . import Options, analyse
    from .sparse.csc import CscMatrix

    colptr = _wrap(ptr_addr, nptr, ctypes.c_int64).astype(np.int64).copy()
    nnz = int(colptr[-1])
    rowind = _wrap(row_addr, nnz, ctypes.c_int64).astype(np.int64).copy()
    a = CscMatrix(n, colptr, rowind, np.zeros(nnz))
    opts = Options(nb=nb, nemin=nemin, ordering=ordering,
                   schedule=schedule, precision=precision, refine=refine,
                   mode="batched", dtype="float32")
    symb = analyse(a, opts)
    h = _put({"symb": symb, "opts": opts, "a_pattern": a, "num": None})
    inf = symb.inform
    return h, int(inf.num_factor), float(inf.num_flops), int(symb.nnodes)


def factor_c(h: int, val_addr: int) -> int:
    """Numeric factorization of the analysed pattern with new values.
    Returns 0 ok, -1 not positive definite."""
    from . import factor
    from .errors import NotPositiveDefiniteError
    from .sparse.csc import CscMatrix

    st = _registry[h]
    symb = st["symb"]
    pat = st["a_pattern"]
    vals = _wrap(val_addr, pat.nnz, ctypes.c_double).copy()
    a = CscMatrix(pat.n, pat.colptr, pat.rowind, vals)
    try:
        st["num"] = factor(symb, a=a, options=st["opts"])
    except NotPositiveDefiniteError:
        return -1
    return 0


def solve_c(h: int, nrhs: int, x_addr: int, job: int) -> int:
    """In-place solve: x [n*nrhs, column-major] holds rhs on entry and
    the solution on return.  job: 0 both, 1 forward, 2 backward."""
    from . import solve

    st = _registry[h]
    num = st["num"]
    if num is None:
        return -2
    n = st["symb"].n
    xbuf = _wrap(x_addr, n * nrhs, ctypes.c_double)
    b = np.asarray(xbuf).reshape(nrhs, n).T.copy()   # col-major view
    out = solve(num, b, job=job)
    xbuf[:] = np.asarray(out).T.reshape(-1)
    return 0


def free_c(h: int) -> int:
    _registry.pop(h, None)
    return 0
