"""User options.

Analogue of ``spllt_options``
(/root/reference/src/spllt_data_mod.F90:260-286) and the C options struct
(/root/reference/include/spllt_iface.h:14-47).  Compile-time CMake switches
of the reference (RUNTIME, WITH_TRACE, ...) become runtime fields here —
the "runtime" choice maps to ``mode``: 'stf' (sequential NumPy oracle,
the reference's STF build) or 'batched' (level-scheduled jit program,
replacing OMP/StarPU/PaRSEC).
"""

from __future__ import annotations

import dataclasses

__all__ = ["Options"]


@dataclasses.dataclass
class Options:
    # blocking --------------------------------------------------------------
    # The reference exposes an independent solve tile size ``snb``
    # (get_solve_blocks, /root/reference/src/spllt_solve_dep_mod.F90:1861-2030)
    # because its solve blocks are re-cut over the lfact storage; in this
    # design solve tasks address the SAME nb-tiled pool (panel windows are
    # nb rows by construction), so solve granularity is controlled by
    # ``nb`` alone — there is deliberately no snb.  Likewise the reference's
    # ``chunk`` (OMP dep combining) and ``min_width_blas`` have no analogue:
    # the static schedule has no runtime dependency engine to throttle.
    nb: int = 256            # factorization tile size (ref default nb=256)
    nemin: int = 32          # supernode amalgamation threshold (ref nemin=32)
    # symbolic --------------------------------------------------------------
    ordering: str = "amd"    # 'amd' | 'nd' | 'nd-grid' | 'rcm' | 'natural'
    grid_shape: tuple | None = None  # for 'nd-grid'
    prune_tree: bool = True  # subtree coarsening (ref prune_tree)
    coarse_subtrees: bool = False  # batched dense leaf-subtree phase
    coarse_span: int = 256   # max dense front size |V|+|B|
    coarse_waste: float = 8.0  # dense/sparse flop waste bound
    # execution -------------------------------------------------------------
    mode: str = "batched"    # 'batched' (jit level schedule) | 'stf' (oracle)
    schedule: str = "scan"   # 'scan' (bucketed lax.scan) | 'unrolled'
    precision: str = "highest"  # lax precision of every float32 product:
    #   'highest' = true float32 (FFMA GEMMs); on the H100 both 'high' and
    #   'default' run float32 products as one TF32 tensor-core pass
    #   (relative error ~3e-4, PERF.md) — pair them with refine>=2
    dtype: str = "float32"   # pool dtype: 'float32' | 'float64'
    refine: int = 2          # iterative-refinement steps in solve (f64 resid)
    refine_device: bool = True  # on the GPU, run the whole refined solve
    #   as one device program (f64 ELL SpMV residuals); the host loop is
    #   used on the CPU backend and for stf/unrolled modes
    ndevices: int = 1        # target device count (ref ncpu/nworker)
    # diagnostics -----------------------------------------------------------
    trace: bool = False      # event tracing (ref WITH_TRACE / trace_mod)
    timers: bool = False     # step timers (ref timer_mod)

    def __post_init__(self):
        if self.nb < 1:
            raise ValueError(f"nb must be >= 1, got {self.nb}")
        if self.nemin < 1:
            raise ValueError(f"nemin must be >= 1, got {self.nemin}")
        if self.mode not in ("batched", "stf"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.schedule not in ("scan", "unrolled"):
            raise ValueError(f"unknown schedule {self.schedule!r}")
        if self.precision not in ("highest", "high", "default"):
            raise ValueError(f"unknown precision {self.precision!r}")
        if self.dtype not in ("float32", "float64"):
            raise ValueError(f"unknown dtype {self.dtype!r}")
        if self.ndevices < 1:
            raise ValueError(f"ndevices must be >= 1, got {self.ndevices}")
