"""spllt_tpu — supernodal sparse Cholesky solver in JAX.

A from-scratch JAX/XLA framework with the capabilities of
NLAFET/SpLLT (task-based supernodal sparse Cholesky): host-side symbolic
analyse (ordering, elimination tree, supernode amalgamation, nb-blocking),
a statically level-scheduled batched factorization replacing the
reference's OMP/StarPU/PaRSEC dynamic runtimes, and a dependency-driven
blocked forward/backward solve for one or many right-hand sides.

Public API::

    from spllt_tpu import analyse, factor, solve, Options
    symb = analyse(a, Options(nb=256, nemin=32))
    num  = factor(symb)
    x    = solve(num, b)
"""

from .api import NumericFactor, SymbolicFactor, analyse, factor, solve
from .errors import NotPositiveDefiniteError, SpLLTError
from .inform import Inform
from .options import Options
from .sparse.csc import CscMatrix
from .sparse.generators import (fem3d, make_rhs, poisson2d,
                                poisson3d, random_spd)

__version__ = "0.1.0"

__all__ = [
    "analyse", "factor", "solve", "Options", "Inform",
    "SymbolicFactor", "NumericFactor", "CscMatrix",
    "poisson2d", "poisson3d", "random_spd", "fem3d", "make_rhs",
    "SpLLTError", "NotPositiveDefiniteError",
]
