"""CG with a fused iteration tail, as in quda_tpu/solvers/fused_iter.py.

Each iteration is one operator apply, one reduction p.Ap, and the tail
x += alpha p; r -= alpha Ap; |r|^2 as ONE kernel
(ops/blas_pallas.cg_update_norm2_pallas).  The tail's |r|^2 is reused as
the next rz, and alpha and beta stay 0-d tensors on the device, so the
loop waits on the card only at a convergence check: once every
``check_every`` iterations (default 1), which reads |r|^2 to the host.
JAX's ``lax.while_loop`` becomes this Python loop.  As in the JAX
package, checks (and maxiter) fall on multiples of ``check_every``, so a
solve may run up to ``check_every - 1`` iterations past convergence;
``iters`` reports those executed.  On a mesh (b a ShardedField,
parallel/mesh.py) the same loop runs block by block: the hop exchanges
faces, the reductions add per-block partials, and no global field is
gathered.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops import blas
from ..ops import blas_pallas as bpl
from .cg import SolverResult


def fused_cg(matvec: Callable, b: torch.Tensor,
             x0: Optional[torch.Tensor] = None, tol: float = 1e-10,
             maxiter: int = 1000, precond: Optional[Callable] = None,
             tol_hq: float = 0.0, check_every: Optional[int] = None,
             record: bool = False) -> SolverResult:
    """CG to |r|^2 <= tol^2 |b|^2.

    Real (pair-form) fields run the tail through the kernel wrapper;
    complex fields, which the kernel does not take, the plain
    ``blas.triple_cg_update``.  ``precond``, ``tol_hq`` and ``record``
    are not ported yet and raise when set."""
    if precond is not None:
        raise NotImplementedError(
            "preconditioned CG is not ported yet (ROADMAP A11)")
    if tol_hq > 0.0:
        raise NotImplementedError(
            "the heavy-quark residual stop (tol_hq) is not ported yet "
            "(ROADMAP A5)")
    if record:
        raise NotImplementedError(
            "convergence history recording is not ported yet (ROADMAP A17)")
    check_every = 1 if check_every is None else max(1, int(check_every))
    tail = blas.triple_cg_update if b.is_complex() \
        else bpl.cg_update_norm2_pallas

    b2 = blas.norm2(b)
    stop = (tol ** 2) * float(b2)
    tiny = torch.finfo(b2.dtype).tiny

    x = blas.zeros_like(b) if x0 is None else x0
    r = b - matvec(x) if x0 is not None else b
    p = r
    rz = blas.norm2(r)
    r2 = rz
    k = 0
    r2_host = float(r2)
    while r2_host > stop and k < maxiter:
        for _ in range(check_every):
            Ap = matvec(p)
            pAp = blas.redot(p, Ap)
            alpha = rz / torch.clamp(pAp, min=tiny)
            x, r, r2 = tail(alpha, p, Ap, x, r)
            beta = r2 / torch.clamp(rz, min=tiny)
            rz = r2
            p = r + beta * p
        k += check_every
        r2_host = float(r2)
    return SolverResult(x, k, r2, r2_host <= stop)
