"""Adaptive multigrid on pair arrays, as in quda_tpu/mg/: the Wilson
hierarchy of mg/pair.py (transfer, Galerkin coarse stencil, V-cycle).
The complex hierarchy, the staggered and Kaehler-Dirac levels and the
jit cache of mg/opstate.py are not ported (ROADMAP A12)."""

from .mg import MG, MGLevelParam  # noqa: F401
from .pair import (PairCoarseOperator, PairMG, PairTransfer,  # noqa: F401
                   PairWilsonLevelOp, mg_solve_pairs)
