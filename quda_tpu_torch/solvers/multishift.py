"""Multi-shift CG: solve (A + sigma_i) x_i = b for every shift at once.

Port of quda_tpu/solvers/multishift.py (lib/inv_multi_cg_quda.cpp in
QUDA): the RHMC rational-approximation solver of staggered/HISQ.  One
Krylov space serves every shift through the shifted-CG zeta recurrences
(one matvec per iteration); shift i has converged when its analytically
known residual zeta_i^2 |r|^2 falls to tol^2 |b|^2.

The JAX ``lax.while_loop`` becomes a Python loop that reads the largest
shifted residual to the host once every ``check_every`` iterations
(default 1), as ``fused_cg`` does; the scalars stay 0-d (or (n_shifts,))
tensors on the device.  The shifted iterates are a stacked leading axis.
On float32 real (pair) fields the base residual update and its norm are
one launch of kernel B3 (ops/blas_pallas.axpy_norm2_pallas).  No breakdown
sentinel, fault injection or ``record``, as on the other ported routes.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import torch

from ..ops import blas
from ..ops import blas_pallas as bpl


class MultiShiftResult(NamedTuple):
    x: torch.Tensor          # (n_shifts, ...) solutions
    iters: int
    r2: torch.Tensor         # base-system final |r|^2 (0-d, on the device)
    converged: list          # per shift, bool
    history: Optional[object] = None
    breakdown: Optional[object] = None


def multishift_cg(matvec: Callable, b: torch.Tensor,
                  shifts: Sequence[float], tol: float = 1e-10,
                  maxiter: int = 2000,
                  check_every: Optional[int] = None) -> MultiShiftResult:
    """Solve (matvec + shift_i) x_i = b, matvec Hermitian positive
    semi-definite and every shift >= 0 (the RHMC setting).

    The BASE system carries the smallest shift (QUDA orders shifts
    ascending and iterates the zeroth); the results keep the caller's
    order.  Checks (and maxiter) fall on multiples of ``check_every``;
    ``r2`` is the base system's."""
    check_every = 1 if check_every is None else max(1, int(check_every))
    # the base system must carry the smallest shift, whatever the
    # caller's order: the JAX loop iterates shifts[0] and diverges
    # when that is not the minimum (ROADMAP C), so the port moves the
    # minimum to the front and restores the caller's order at the end
    given = tuple(float(s) for s in shifts)
    i0 = min(range(len(given)), key=given.__getitem__)
    order = [i0] + [i for i in range(len(given)) if i != i0]
    shifts = tuple(given[i] for i in order)
    ns = len(shifts)
    s0 = shifts[0]
    b2 = blas.norm2(b)
    rdt = b2.dtype
    dev = b.device
    sig = torch.tensor([s - s0 for s in shifts], dtype=rdt, device=dev)

    def base(v):
        return matvec(v) + s0 * v if s0 != 0.0 else matvec(v)

    # the base residual update r -= alpha Ap with its norm: kernel B3 on
    # float32 pairs, plain arithmetic otherwise
    fused = not b.is_complex() and b.dtype == torch.float32

    def update(alpha, Ap, r):
        if fused:
            return bpl.axpy_norm2_pallas(-alpha, Ap, r)
        r = r - alpha.to(b.dtype) * Ap
        return r, blas.norm2(r).to(rdt)

    def expand(a):
        """(ns,) scalars -> broadcastable over the stacked fields."""
        return a.reshape((ns,) + (1,) * b.ndim).to(b.dtype)

    def guarded_div(num, den):
        """num / den where den != 0, else 0 (the JAX zero guards)."""
        nz = den != 0
        return torch.where(nz, num / torch.where(nz, den,
                                                 torch.ones_like(den)),
                           torch.zeros_like(num))

    stop = (tol ** 2) * float(b2)
    x = torch.zeros((ns,) + tuple(b.shape), dtype=b.dtype, device=dev)
    p = b.expand((ns,) + tuple(b.shape)).clone()
    r = b
    r2 = b2
    zeta = torch.ones((ns,), dtype=rdt, device=dev)
    zeta_old = torch.ones((ns,), dtype=rdt, device=dev)
    alpha_old = torch.ones((), dtype=rdt, device=dev)
    beta_old = torch.zeros((), dtype=rdt, device=dev)
    k = 0
    worst = float(((zeta ** 2) * r2).max())
    while worst > stop and k < maxiter:
        for _ in range(check_every):
            Ap = base(p[0])
            pAp = blas.redot(p[0], Ap).to(rdt)
            alpha = r2 / pAp
            # zeta recurrence (Frommer / van der Vorst shifted CG)
            zn = zeta * zeta_old * alpha_old
            zd = (alpha * beta_old * (zeta_old - zeta)
                  + zeta_old * alpha_old * (1.0 + sig * alpha))
            zeta_new = guarded_div(zn, zd)
            ratio = guarded_div(zeta_new, zeta)
            alpha_s = alpha * ratio
            x = x + expand(alpha_s) * p
            r, r2_new = update(alpha, Ap, r)
            r2_new = r2_new.to(rdt)
            beta = r2_new / r2
            beta_s = beta * ratio ** 2
            p = expand(zeta_new) * r[None] + expand(beta_s) * p
            zeta_old, zeta = zeta, zeta_new
            alpha_old, beta_old = alpha, beta
            r2 = r2_new
        k += check_every
        worst = float(((zeta ** 2) * r2).max())
    shift_r2 = ((zeta ** 2) * r2).tolist()
    back = [order.index(i) for i in range(ns)]
    return MultiShiftResult(x[back], k, r2,
                            [shift_r2[j] <= stop for j in back])
