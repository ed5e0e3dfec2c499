"""GCR (flexible, restarted), MR and SD, as in quda_tpu/solvers/gcr.py.

GCR is flexible: the preconditioner K may change between iterations (a
multigrid V-cycle).  One restart cycle of ``nkrylov`` steps keeps its
(p, Ap) basis in lists; the cycles run in a Python loop that reads |r|^2
to the host once per cycle, as the JAX package's host loop does, so
``iters`` counts whole cycles (a multiple of ``nkrylov``).  MR and SD
read |r|^2 once per iteration; ``gcr_fixed`` and ``mr_fixed`` run a
fixed count with no read (the multigrid coarse solve and smoother).
Every coefficient stays a 0-d tensor on the solve's device.  On real
(pair) fields the dots are real: a real-coefficient Krylov method on the
realified operator, as in the JAX package.  The breakdown sentinel waits
for ROADMAP A5, as on the other ported solvers; the ``inv_type`` routes
"gcr", "mr" and "sd" of ``invert_quda`` wait for ROADMAP A11.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops import blas
from .cg import SolverResult


def _axpy(y, a, x):
    """y + a x with a a 0-d tensor, in one pass (no a x temporary)."""
    return torch.addcmul(y, a, x)


def _gcr_cycle(matvec, K, x, r, nkrylov: int, tiny: float = 0.0):
    ps, aps, ap2s = [], [], []
    dt = x.dtype
    for _ in range(nkrylov):
        z = K(r)
        az = matvec(z)
        # modified Gram-Schmidt of az against the previous Ap's
        for p_i, ap_i, ap2_i in zip(ps, aps, ap2s):
            c = blas.cdot(ap_i, az) / (ap2_i + tiny).to(dt)
            az = _axpy(az, -c, ap_i)
            z = _axpy(z, -c, p_i)
        ap2 = blas.norm2(az)
        ps.append(z)
        aps.append(az)
        ap2s.append(ap2)
        alpha = blas.cdot(az, r) / (ap2 + tiny).to(dt)
        x = _axpy(x, alpha, z)
        r = _axpy(r, -alpha, az)
    return x, r


def gcr(matvec: Callable, b: torch.Tensor, precond: Optional[Callable] = None,
        x0: Optional[torch.Tensor] = None, tol: float = 1e-10,
        nkrylov: int = 10, max_restarts: int = 50) -> SolverResult:
    """Restarted flexible GCR(nkrylov) to |r|^2 <= tol^2 |b|^2, checked
    between cycles."""
    stop = float((tol ** 2) * blas.norm2(b))
    K = precond if precond is not None else (lambda v: v)
    x = torch.zeros_like(b) if x0 is None else x0
    r = b if x0 is None else b - matvec(x)
    total = 0
    r2 = blas.norm2(r)
    for _ in range(max_restarts):
        if float(r2) <= stop:
            break
        x, r = _gcr_cycle(matvec, K, x, r, nkrylov)
        r2 = blas.norm2(r)
        total += nkrylov
    return SolverResult(x, total, r2, float(r2) <= stop)


def gcr_fixed(matvec: Callable, b: torch.Tensor, nkrylov: int = 8,
              cycles: int = 1, x0=None) -> torch.Tensor:
    """Fixed-work GCR, no convergence test and no preconditioner: the
    coarsest-level solver of the multigrid V-cycle."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b if x0 is None else b - matvec(x)
    for _ in range(cycles):
        x, r = _gcr_cycle(matvec, lambda v: v, x, r, nkrylov, tiny=1e-30)
    return x


def mr(matvec: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
       tol: float = 1e-10, maxiter: int = 100,
       omega: float = 1.0) -> SolverResult:
    """Minimal residual iteration (omega = relaxation)."""
    stop = float((tol ** 2) * blas.norm2(b))
    x = torch.zeros_like(b) if x0 is None else x0
    r = b if x0 is None else b - matvec(x)
    r2 = blas.norm2(r)
    tiny = torch.finfo(r2.dtype).tiny
    k = 0
    while float(r2) > stop and k < maxiter:
        ar = matvec(r)
        alpha = blas.cdot(ar, r) / torch.clamp(blas.norm2(ar),
                                               min=tiny).to(b.dtype)
        x = x + omega * alpha * r
        r = r - omega * alpha * ar
        r2 = blas.norm2(r)
        k += 1
    return SolverResult(x, k, r2, float(r2) <= stop)


def mr_fixed(matvec: Callable, b: torch.Tensor, n_iters: int,
             omega: float = 1.0, x0=None) -> torch.Tensor:
    """Fixed-iteration MR: the multigrid smoother."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b if x0 is None else b - matvec(x)
    for _ in range(n_iters):
        ar = matvec(r)
        alpha = omega * blas.cdot(ar, r) / torch.clamp(
            blas.norm2(ar), min=1e-30).to(b.dtype)
        x = _axpy(x, alpha, r)
        r = _axpy(r, -alpha, ar)
    return x


def sd(matvec: Callable, b: torch.Tensor, x0=None, tol: float = 1e-10,
       maxiter: int = 100) -> SolverResult:
    """Steepest descent for a Hermitian positive-definite matvec."""
    stop = float((tol ** 2) * blas.norm2(b))
    x = torch.zeros_like(b) if x0 is None else x0
    r = b if x0 is None else b - matvec(x)
    r2 = blas.norm2(r)
    k = 0
    while float(r2) > stop and k < maxiter:
        ar = matvec(r)
        alpha = (r2 / blas.redot(r, ar)).to(b.dtype)
        x = x + alpha * r
        r = r - alpha * ar
        r2 = blas.norm2(r)
        k += 1
    return SolverResult(x, k, r2, float(r2) <= stop)
