"""ctypes binding to the C++ symbolic-analysis fast paths.

The reference's analyse phase leans on native code (SPRAL SSIDS + METIS,
/root/reference/src/spllt_analyse_mod.F90:26-28).  Our native component is
native/symbolic.cpp, built into native/libspllt_symbolic.so on first use
(``make -C native``) and rebuilt when the source is newer; every entry
point has a NumPy fallback so the package works without a C++ compiler.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_TRIED = False
_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "native")
_LIB_NAME = "libspllt_symbolic.so"


def _build(lib: str, src: str) -> None:
    """Build ``lib`` from ``src`` unless it is up to date.  Concurrent
    processes each build under their own temporary name and rename it
    into place atomically, so a reader never sees a partial library."""
    if (os.path.exists(lib)
            and os.path.getmtime(lib) >= os.path.getmtime(src)):
        return
    tmp = f"{_LIB_NAME}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(["make", "-s", "-C", _NATIVE_DIR,
                               f"TARGET={tmp}"],
                              capture_output=True, text=True)
        if proc.returncode == 0:
            os.replace(os.path.join(_NATIVE_DIR, tmp), lib)
    except OSError:
        pass        # no make / compiler: the NumPy fallbacks run
    finally:
        if os.path.exists(os.path.join(_NATIVE_DIR, tmp)):
            os.remove(os.path.join(_NATIVE_DIR, tmp))


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    lib = os.path.join(_NATIVE_DIR, _LIB_NAME)
    src = os.path.join(_NATIVE_DIR, "symbolic.cpp")
    if os.path.exists(src):
        _build(lib, src)
    if os.path.exists(lib):
        try:
            _LIB = ctypes.CDLL(lib)
        except OSError:
            pass
    return _LIB


def native_available() -> bool:
    return _load() is not None


def native_amd_or_none(a) -> np.ndarray | None:
    """AMD ordering via the native library, or None if unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "spllt_amd"):
        return None
    n = a.n
    colptr = np.ascontiguousarray(a.colptr, dtype=np.int64)
    rowind = np.ascontiguousarray(a.rowind, dtype=np.int64)
    perm = np.empty(n, dtype=np.int64)
    lib.spllt_amd.restype = ctypes.c_int
    rc = lib.spllt_amd(
        ctypes.c_int64(n),
        colptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        rowind.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rc != 0:
        return None
    return perm


def native_etree_or_none(n, colptr, rowind) -> np.ndarray | None:
    """Elimination tree via the native library, or None if unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "spllt_etree"):
        return None
    colptr = np.ascontiguousarray(colptr, dtype=np.int64)
    rowind = np.ascontiguousarray(rowind, dtype=np.int64)
    parent = np.empty(n, dtype=np.int64)
    lib.spllt_etree.restype = ctypes.c_int
    rc = lib.spllt_etree(
        ctypes.c_int64(n),
        colptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        rowind.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        parent.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rc != 0:
        return None
    return parent


def native_postorder_or_none(parent) -> np.ndarray | None:
    """Postorder via the native library, or None if unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "spllt_postorder"):
        return None
    n = len(parent)
    parent = np.ascontiguousarray(parent, dtype=np.int64)
    post = np.empty(n, dtype=np.int64)
    lib.spllt_postorder.restype = ctypes.c_int
    rc = lib.spllt_postorder(
        ctypes.c_int64(n),
        parent.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        post.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rc != 0:
        return None
    return post


def native_supernodes_or_none(n, colptr, rowind, parent, nemin):
    """Supernode detection + nemin amalgamation + row lists via the
    native library.  Returns (sa, en, sparent, rptr, rows) or None.

    Two-call protocol: the first call computes sizes (nnodes, len(rows));
    the second fills the caller-allocated arrays.
    """
    lib = _load()
    if lib is None or not hasattr(lib, "spllt_supernodes"):
        return None
    colptr = np.ascontiguousarray(colptr, dtype=np.int64)
    rowind = np.ascontiguousarray(rowind, dtype=np.int64)
    parent = np.ascontiguousarray(parent, dtype=np.int64)
    p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    sizes = np.zeros(2, dtype=np.int64)
    lib.spllt_supernodes.restype = ctypes.c_int
    rc = lib.spllt_supernodes(
        ctypes.c_int64(n), p(colptr), p(rowind), p(parent),
        ctypes.c_int64(nemin), p(sizes),
        None, None, None, None, None)
    if rc != 0:
        return None
    nnodes, nrows = int(sizes[0]), int(sizes[1])
    sa = np.empty(nnodes, dtype=np.int64)
    en = np.empty(nnodes, dtype=np.int64)
    sparent = np.empty(nnodes, dtype=np.int64)
    rptr = np.empty(nnodes + 1, dtype=np.int64)
    rows = np.empty(nrows, dtype=np.int64)
    rc = lib.spllt_supernodes(
        ctypes.c_int64(n), p(colptr), p(rowind), p(parent),
        ctypes.c_int64(nemin), p(sizes),
        p(sa), p(en), p(sparent), p(rptr), p(rows))
    if rc != 0:
        return None
    return sa, en, sparent, rptr, rows


class _PlanOut(ctypes.Structure):
    _fields_ = [
        ("potrf", ctypes.POINTER(ctypes.c_int64)),
        ("n_potrf", ctypes.c_int64),
        ("trsm", ctypes.POINTER(ctypes.c_int64)),
        ("n_trsm", ctypes.c_int64),
        ("syrk", ctypes.POINTER(ctypes.c_int64)),
        ("n_syrk", ctypes.c_int64),
        ("updbt", ctypes.POINTER(ctypes.c_int64)),
        ("n_updbt", ctypes.c_int64),
        ("srcvec", ctypes.POINTER(ctypes.c_int64)),
        ("srcvec_node", ctypes.POINTER(ctypes.c_int64)),
        ("n_srcvec", ctypes.c_int64),
        ("maps", ctypes.POINTER(ctypes.c_int32)),
        ("n_maps", ctypes.c_int64),
    ]


def native_factor_plan_or_none(sparent, plan):
    """Factor-plan task enumeration via the native library, or None.

    Returns a dict of UNSORTED task arrays in emission order, exactly
    matching the Python loops of plan.factor_tasks.build_factor_plan
    (non-coarse path): potrf [n,3] (lvl, blk, k), trsm [n,4]
    (lvl, diag, dst, k), syrk [n,4] (lvl, si, sj, dst), updbt [n,6]
    (lvl, dst, mr, mc, svp, c), srcvec, srcvec_node, maps [nmaps, nb].
    """
    lib = _load()
    if lib is None or not hasattr(lib, "spllt_factor_plan"):
        return None
    i64 = lambda a: np.ascontiguousarray(a, dtype=np.int64)
    p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    sparent = i64(sparent)
    ntiles = i64(plan.node_ntiles)
    nctiles = i64(plan.node_nctiles)
    blk_ptr = i64(plan.node_blk_ptr)
    sa = i64(plan.node_sa)
    en = i64(plan.node_en)
    rptr = i64(plan.node_rptr)
    rows = i64(plan.rows)
    blk_n = i64(plan.blk_n)
    out = ctypes.POINTER(_PlanOut)()
    lib.spllt_factor_plan.restype = ctypes.c_int
    rc = lib.spllt_factor_plan(
        ctypes.c_int64(plan.nnodes), ctypes.c_int64(plan.nb),
        ctypes.c_int64(plan.nblocks), p(sparent),
        p(ntiles), p(nctiles), p(blk_ptr), p(sa), p(en),
        p(rptr), p(rows), p(blk_n), ctypes.byref(out))
    if rc != 0 or not out:
        return None
    o = out.contents

    def arr64(ptr, shape):
        k = int(np.prod(shape)) if shape else 0
        if k == 0:
            return np.empty(shape, dtype=np.int64)
        return np.ctypeslib.as_array(ptr, shape=(k,)).astype(
            np.int64, copy=True).reshape(shape)

    res = {
        "potrf": arr64(o.potrf, (int(o.n_potrf), 3)),
        "trsm": arr64(o.trsm, (int(o.n_trsm), 4)),
        "syrk": arr64(o.syrk, (int(o.n_syrk), 4)),
        "updbt": arr64(o.updbt, (int(o.n_updbt), 6)),
        "srcvec": arr64(o.srcvec, (int(o.n_srcvec),)),
        "srcvec_node": arr64(o.srcvec_node, (int(o.n_srcvec),)),
        "maps": (np.ctypeslib.as_array(
            o.maps, shape=(int(o.n_maps) * plan.nb,)).astype(
                np.int32, copy=True).reshape(int(o.n_maps), plan.nb)
            if o.n_maps else np.empty((0, plan.nb), np.int32)),
    }
    lib.spllt_plan_free.restype = None
    lib.spllt_plan_free(out)
    return res


def native_hem_or_none(indptr, indices, data, order):
    """Heavy-edge matching via the native library, or None.

    Returns (cmap, nc) identical to the Python loop in analyse.nd
    (same traversal order, same tie-breaking)."""
    lib = _load()
    if lib is None or not hasattr(lib, "spllt_hem"):
        return None
    n = len(indptr) - 1
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    data = np.ascontiguousarray(data, dtype=np.float64)
    order = np.ascontiguousarray(order, dtype=np.int64)
    cmap = np.empty(n, dtype=np.int64)
    nc = np.zeros(1, dtype=np.int64)
    p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    lib.spllt_hem.restype = ctypes.c_int
    rc = lib.spllt_hem(
        ctypes.c_int64(n), p(indptr), p(indices),
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        p(order), p(cmap), p(nc))
    if rc != 0:
        return None
    return cmap, int(nc[0])
