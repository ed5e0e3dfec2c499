"""Multi-RHS solvers on pair batches, as in quda_tpu/solvers/block.py.

Every Krylov iterate is a batch (N, 4, 3, 2, T, Z, Y*Xh) of packed pair
arrays, and each solver takes a matvec over the whole batch (the
``*_pairs_mrhs`` operators of models/wilson.py), so one launch of the
multi-RHS stencil serves all N right-hand sides and loads each link once
per chunk of them.  CG coefficients on the realified Hermitian normal
operator are real, so the pair representation is exact.

* ``batched_cg_pairs``: N independent CG recurrences in (N,) scalar
  lanes; each lane follows the trajectory of a solo ``fused_cg`` solve.
* ``block_cg_pairs``: block CG (O'Leary), one Krylov space shared by the
  N right-hand sides, with (N x N) Gram matrices as real matmuls over the
  flattened site axis.

JAX's ``lax.while_loop`` becomes a Python loop that reads the (N,) lane
residuals to the host once per convergence check; everything else stays
on the device.  The iteration tail is plain PyTorch (in JAX it is XLA,
outside any kernel).  The breakdown sentinel, fault injection and
``record`` wait for ROADMAP A5 and A17, as on the single-source routes;
``batched_cg``/``block_cg`` (the complex, per-RHS-matvec forms) wait for
A11.

* ``batched_bicgstab_pairs``: N independent BiCGStab recurrences on a
  direct (non-Hermitian) system, two batched matvecs per iteration: the
  multigrid set-up's null-vector solver.  It updates its iterates in
  place (a 24-RHS batch at 32^3 x 64 is 4.8 GB per Krylov vector).
"""

from __future__ import annotations

import warnings
from typing import Callable, NamedTuple, Optional

import torch

from ..utils import config


def _check_nrhs(n: int) -> None:
    """QUDA_TORCH_MAX_MULTI_RHS advisory cap: the reference's
    QUDA_MAX_MULTI_RHS bounds template instances, not user batches, so a
    larger batch warns (device memory may not hold it) and runs."""
    cap = config.get("QUDA_TORCH_MAX_MULTI_RHS")
    if n > cap:
        warnings.warn(
            f"{n} right-hand sides exceeds QUDA_TORCH_MAX_MULTI_RHS={cap}; "
            "device memory may not hold the batch: raise the knob to "
            "silence this warning or chunk the sources", stacklevel=3)


class BlockCGResult(NamedTuple):
    x: torch.Tensor
    iters: int               # shared by every right-hand side
    r2: torch.Tensor         # (N,) final |r|^2
    converged: torch.Tensor  # (N,) bool
    history: Optional[object] = None
    breakdown: Optional[object] = None


class BatchedCGResult(NamedTuple):
    x: torch.Tensor
    iters: torch.Tensor      # (N,) iterations to convergence per RHS
    r2: torch.Tensor         # (N,) final |r|^2
    converged: torch.Tensor  # (N,) bool
    history: Optional[object] = None
    breakdown: Optional[object] = None


def _per_rhs_dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(N,) real per-RHS inner products Re<u_i, v_i>; the conjugation
    makes the same lanes serve Hermitian complex batches."""
    n = u.shape[0]
    prod = torch.conj(u) * v if u.is_complex() else u * v
    return torch.sum(torch.real(prod).reshape(n, -1), dim=1)


def _bcast(s: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(N,) scalars broadcast over the per-RHS field axes."""
    return s.reshape((s.shape[0],) + (1,) * (like.ndim - 1))


def _reject_record(record: bool) -> None:
    if record:
        raise NotImplementedError(
            "convergence history recording is not ported yet (ROADMAP A17)")


def batched_cg_pairs(matvec_batch: Callable, B: torch.Tensor,
                     tol: float = 1e-10, maxiter: int = 1000,
                     check_every: Optional[int] = None,
                     record: bool = False) -> BatchedCGResult:
    """Batched CG on pair arrays: each lane to |r|^2 <= tol^2 |b|^2.

    Independent CG recurrences in (N,) lanes, one batched matvec per
    iteration.  As in solvers/fused_iter.py, convergence is checked every
    ``check_every`` iterations (default 1), with one host read of the lane
    residuals per check; the loop runs until every lane converges
    (converged lanes keep iterating harmlessly), and ``iters`` holds each
    lane's first converged check boundary (the total for a lane that never
    converged)."""
    _reject_record(record)
    n = B.shape[0]
    _check_nrhs(n)
    check_every = 1 if check_every is None else max(1, int(check_every))
    rdt = torch.float32 if B.dtype == torch.bfloat16 else B.dtype
    b2 = _per_rhs_dot(B.to(rdt), B.to(rdt))
    stop = (tol ** 2) * b2
    tiny = torch.finfo(b2.dtype).tiny

    x = torch.zeros_like(B)
    r = B
    p = B
    rz = b2
    k = 0
    stop_h = stop.cpu()
    it_conv = torch.full((n,), -1, dtype=torch.int64)
    rz_h = rz.cpu()
    while bool((rz_h > stop_h).any()) and k < maxiter:
        for _ in range(check_every):
            Ap = matvec_batch(p)
            pAp = _per_rhs_dot(p.to(rdt), Ap.to(rdt))
            alpha = rz / torch.clamp(pAp, min=tiny)
            a = _bcast(alpha, x).to(x.dtype)
            x = x + a * p
            r = r - a * Ap
            r2 = _per_rhs_dot(r.to(rdt), r.to(rdt))
            beta = r2 / torch.clamp(rz, min=tiny)
            p = r + _bcast(beta, p).to(p.dtype) * p
            rz = r2
        k += check_every
        rz_h = rz.cpu()
        it_conv = torch.where((it_conv < 0) & (rz_h <= stop_h),
                              torch.full_like(it_conv, k), it_conv)
    it_conv = torch.where(it_conv < 0, torch.full_like(it_conv, k), it_conv)
    return BatchedCGResult(x, it_conv, rz, rz_h <= stop_h)


def batched_bicgstab_pairs(matvec_batch: Callable, B: torch.Tensor,
                           tol: float = 1e-10,
                           maxiter: int = 1000) -> BatchedCGResult:
    """Batched BiCGStab with independent per-RHS scalar lanes on a real
    (pair) batch, each lane to |r|^2 <= tol^2 |b|^2.

    Real arithmetic throughout: pair arrays realify complex systems, and
    the real dots are Re<.,.> of the underlying complex vectors.  The loop
    reads the (N,) lane residuals to the host once per iteration and runs
    until every lane converged, a lane is not finite or ``maxiter``;
    converged lanes keep iterating harmlessly, and ``iters`` holds each
    lane's first converged iteration (the total for one that never
    converged).  ``B`` itself is not modified."""
    if B.is_complex() or B.dtype not in (torch.float32, torch.float64):
        raise TypeError(
            "batched_bicgstab_pairs needs a real (pair/realified) float32 "
            "or float64 batch; realify complex systems around the call")
    n = B.shape[0]
    _check_nrhs(n)
    b2 = _per_rhs_dot(B, B)
    stop_h = ((tol ** 2) * b2).cpu()
    tiny = torch.finfo(b2.dtype).tiny

    def safe(d):
        # magnitude-preserving guard: BiCGStab scalars may be negative
        return torch.where(d.abs() > tiny, d,
                           torch.where(d < 0, torch.full_like(d, -tiny),
                                       torch.full_like(d, tiny)))

    def lanes(s):
        return _bcast(s, B).to(B.dtype)

    x = torch.zeros_like(B)
    r = B.clone()
    r0 = B
    p = B.clone()
    rho = b2
    k = 0
    it_conv = torch.full((n,), -1, dtype=torch.int64)
    r2_h = b2.cpu()
    while (bool((r2_h > stop_h).any()) and bool(torch.isfinite(r2_h).all())
           and k < maxiter):
        Av = matvec_batch(p)
        alpha = rho / safe(_per_rhs_dot(r0, Av))
        s = r.addcmul_(Av, lanes(alpha), value=-1.0)      # s = r - alpha Av
        At = matvec_batch(s)
        tt = _per_rhs_dot(At, At)
        ts = _per_rhs_dot(At, s)
        omega = ts / torch.clamp(tt, min=tiny)
        x.addcmul_(p, lanes(alpha)).addcmul_(s, lanes(omega))
        r = s.addcmul_(At, lanes(omega), value=-1.0)      # r = s - omega At
        del At
        r2 = _per_rhs_dot(r, r)
        rho_new = _per_rhs_dot(r0, r)
        beta = (rho_new / safe(rho)) * (alpha / safe(omega))
        # p = r + beta (p - omega Av)
        p.addcmul_(Av, lanes(omega), value=-1.0).mul_(lanes(beta)).add_(r)
        del Av
        rho = rho_new
        k += 1
        r2_h = r2.cpu()
        it_conv = torch.where((it_conv < 0) & (r2_h <= stop_h),
                              torch.full_like(it_conv, k), it_conv)
    it_conv = torch.where(it_conv < 0, torch.full_like(it_conv, k), it_conv)
    return BatchedCGResult(x, it_conv, r2_h.to(b2.device), r2_h <= stop_h)


def _solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^-1 b, NaN where the factorisation fails (a singular Gram
    matrix): the caller's finiteness exit then reports the breakdown."""
    out, info = torch.linalg.solve_ex(a, b)
    return torch.where(info == 0, out, torch.full_like(out, float("nan")))


def block_cg_pairs(matvec_batch: Callable, B: torch.Tensor,
                   tol: float = 1e-10, maxiter: int = 1000,
                   record: bool = False) -> BlockCGResult:
    """Block CG (O'Leary) on pair arrays: one shared Krylov space.

    The realified Hermitian system is real SPD, so block CG runs in real
    arithmetic: the (N x N) Gram matrices are real matmuls over the
    flattened site axis.  The iteration count is shared.  Linearly
    dependent sources (duplicates) make the Gram matrices singular: the
    loop stops as soon as a lane residual is not finite and reports those
    lanes unconverged, never NaN as a solution that converged."""
    _reject_record(record)
    n = B.shape[0]
    _check_nrhs(n)
    rdt = torch.float32 if B.dtype == torch.bfloat16 else B.dtype
    b2 = _per_rhs_dot(B.to(rdt), B.to(rdt))
    stop_h = ((tol ** 2) * b2).cpu()

    def gram(U, V):
        return torch.matmul(U.reshape(n, -1).to(rdt),
                            V.reshape(n, -1).to(rdt).T)

    def comb(M, U):
        # X_j <- sum_i M[i, j] U_i over the flattened site axis
        return torch.matmul(M.T.to(rdt),
                            U.reshape(n, -1).to(rdt)).reshape(U.shape)

    X = torch.zeros_like(B)
    R = B
    P = B
    r2 = b2
    k = 0
    r2_h = r2.cpu()
    while (bool((r2_h > stop_h).any()) and bool(torch.isfinite(r2_h).all())
           and k < maxiter):
        AP = matvec_batch(P)
        pap = gram(P, AP)
        rr = gram(R, R)
        alpha = _solve(pap, gram(P, R))
        X = X + comb(alpha, P).to(X.dtype)
        R = R - comb(alpha, AP).to(R.dtype)
        rr_new = gram(R, R)
        beta = _solve(rr, rr_new)
        P = R + comb(beta, P).to(P.dtype)
        r2 = torch.diagonal(rr_new)
        k += 1
        r2_h = r2.cpu()
    return BlockCGResult(X, k, r2, r2_h <= stop_h)
