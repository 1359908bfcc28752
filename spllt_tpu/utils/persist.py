"""Persistence of symbolic and numeric factors (checkpoint/resume).

The reference has no checkpointing (SURVEY §5: 'none; the closest
analogue is the persistent akeep/fkeep split').  Here both objects
serialize to a single ``.npz``: the symbolic factor (pattern analysis is
expensive for large problems) and, optionally, the numeric factor pool —
so a service can analyse once, checkpoint, and refactor/solve from the
checkpoint across processes.
"""

from __future__ import annotations

import numpy as np

__all__ = ["save_symbolic", "load_symbolic", "save_factor", "load_factor"]

_OPT_FIELDS = ("nb", "nemin", "ordering", "grid_shape", "prune_tree",
               "mode", "schedule", "dtype", "precision", "refine",
               "ndevices")


def save_symbolic(path: str, symb) -> None:
    opt = {"options": np.array(
        [{k: getattr(symb.options, k) for k in _OPT_FIELDS}], dtype=object)}
    np.savez_compressed(
        path,
        n=symb.n, perm=symb.perm,
        a_colptr=symb.a_perm.colptr, a_rowind=symb.a_perm.rowind,
        a_values=(symb.a_perm.values if symb.a_perm.values is not None
                  else np.empty(0)),
        f_nnodes=symb.forest.nnodes, f_sa=symb.forest.sa,
        f_en=symb.forest.en, f_sparent=symb.forest.sparent,
        f_rptr=symb.forest.rptr, f_rows=symb.forest.rows,
        weight=symb.weight, node_flops=symb.node_flops, small=symb.small,
        inform_maxdepth=symb.inform.maxdepth,
        inform_num_factor=symb.inform.num_factor,
        inform_num_flops=symb.inform.num_flops,
        inform_num_nodes=symb.inform.num_nodes,
        **opt,
    )


def load_symbolic(path: str):
    from ..analyse.analyse import SymbolicFactor
    from ..analyse.supernodes import SupernodeForest
    from ..inform import Inform
    from ..options import Options
    from ..sparse.csc import CscMatrix

    z = np.load(path, allow_pickle=True)
    opts = dict(z["options"][0])
    if opts.get("grid_shape") is not None:
        opts["grid_shape"] = tuple(int(x) for x in opts["grid_shape"])
    # drop fields saved by older versions that no longer exist (e.g.
    # solve_group)
    known = {f.name for f in __import__("dataclasses").fields(Options)}
    opts = {k: v for k, v in opts.items() if k in known}
    options = Options(**opts)
    vals = z["a_values"]
    a = CscMatrix(int(z["n"]), z["a_colptr"], z["a_rowind"],
                  vals if len(vals) else None)
    forest = SupernodeForest(
        nnodes=int(z["f_nnodes"]), sa=z["f_sa"], en=z["f_en"],
        sparent=z["f_sparent"], rptr=z["f_rptr"], rows=z["f_rows"])
    inform = Inform(
        maxdepth=int(z["inform_maxdepth"]),
        num_factor=int(z["inform_num_factor"]),
        num_flops=int(z["inform_num_flops"]),
        num_nodes=int(z["inform_num_nodes"]))
    return SymbolicFactor(
        n=int(z["n"]), perm=z["perm"], a_perm=a, forest=forest,
        weight=z["weight"], node_flops=z["node_flops"], small=z["small"],
        inform=inform, options=options)


def save_factor(path: str, num) -> None:
    """Checkpoint the numeric factor (symbolic + factored pool)."""
    import tempfile

    save_symbolic(path + ".symb.npz", num.symb)
    np.savez_compressed(
        path, pool=np.asarray(num.pool),
        values_perm=num.values_perm)


def load_factor(path: str):
    """Rebuild a solvable NumericFactor from a checkpoint."""
    import dataclasses

    from ..api import NumericFactor, _plans

    symb = load_symbolic(path + ".symb.npz")
    z = np.load(path)
    plan, fplan, splan = _plans(symb, symb.options)
    inform = dataclasses.replace(symb.inform)
    inform.num_blocks = plan.nblocks
    inform.num_levels = fplan.nlevels
    inform.num_tasks = fplan.num_tasks
    return NumericFactor(
        symb=symb, plan=plan, fplan=fplan, splan=splan,
        pool=z["pool"], values_perm=z["values_perm"],
        options=symb.options, inform=inform)
