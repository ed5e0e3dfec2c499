"""Conjugate gradient, as in quda_tpu/solvers/cg.py.

The iteration runs in solvers/fused_iter.py: a Python loop whose tail is
one CUDA kernel and whose convergence check reads |r|^2 to the host every
``check_every`` iterations.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..ops import blas


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


def cg_fixed_iters(matvec: Callable, b: torch.Tensor, x0, n_iters: int):
    """Fixed-iteration CG with no convergence test (the JAX package's
    ``lax.scan`` form; a multigrid set-up smoother).  Returns
    (SolverResult, history): history holds |r|^2 after each iteration.
    The denominators are guarded by the smallest normal number, so a
    residual that reaches zero does not turn the iterate into NaN."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x) if x0 is not None else b
    p = r
    r2 = blas.norm2(r)
    tiny = torch.finfo(r2.dtype).tiny
    hist = []
    for _ in range(n_iters):
        Ap = matvec(p)
        alpha = r2 / (blas.redot(p, Ap) + tiny)
        x = x + alpha.to(x.dtype) * p
        r = r - alpha.to(x.dtype) * Ap
        r2_new = blas.norm2(r)
        beta = r2_new / (r2 + tiny)
        p = r + beta.to(x.dtype) * p
        r2 = r2_new
        hist.append(r2)
    hist = torch.stack(hist) if hist else r2.new_zeros((0,))
    return SolverResult(x, n_iters, r2, bool(r2 >= 0)), hist
