"""Conjugate gradient, as in quda_tpu/solvers/cg.py.

The iteration runs in solvers/fused_iter.py: a Python loop whose tail is
one CUDA kernel and whose convergence check reads |r|^2 to the host every
``check_every`` iterations.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class SolverResult(NamedTuple):
    x: torch.Tensor
    iters: int
    r2: torch.Tensor        # final |r|^2 (0-d, on the solve's device)
    converged: bool
    history: Optional[object] = None
    breakdown: Optional[object] = None
    # reliable updates made (solvers/mixed.py); 0 for the other solvers.
    # The JAX package reports them only in its traced history.
    reliable_updates: int = 0


def cg(matvec: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
       tol: float = 1e-10, maxiter: int = 1000,
       precond: Optional[Callable] = None, tol_hq: float = 0.0,
       check_every: Optional[int] = None,
       record: bool = False) -> SolverResult:
    """Solve matvec(x) = b for Hermitian positive-definite matvec, to
    |r|^2 <= tol^2 |b|^2."""
    from .fused_iter import fused_cg
    return fused_cg(matvec, b, x0=x0, tol=tol, maxiter=maxiter,
                    precond=precond, tol_hq=tol_hq,
                    check_every=check_every, record=record)
