"""Mixed-precision CG with reliable updates, as in quda_tpu/solvers/mixed.py.

QUDA threads sloppy/precise operator pairs through its solvers
(include/invert_quda.h; reliable updates include/reliable_updates.h and
lib/inv_cg_quda.cpp).  Here:

* ``cg_reliable``: iterate in the sloppy storage; when the sloppy residual
  falls below ``delta`` times the largest since the last update (or below
  the stop), recompute the true residual with the precise operator and
  restart from it.
* ``cg_reliable_df``: the same loop with a df64 (float32-pair) precise
  side, judged on the direct system's df64 residual: the route to
  1e-10-class true residuals without f64 (ops/df64.py, ops/wilson_df64.py).

The JAX ``lax.while_loop`` + ``lax.cond`` becomes a Python loop.  Each
iteration reads the new sloppy |r|^2 to the host once; that one read
decides both the stop and the reliable update, so the loop keeps
fused_cg's default cadence of one host read per iteration (a reliable
update adds one more, for the true residual).  Everything else stays on
the device: alpha and beta are 0-d tensors, and the residual update with
its norm is one kernel (ops/blas_pallas.axpy_norm2_pallas, B3).  The
breakdown sentinel and fault injection of the JAX package are not ported
(as under its QUDA_TPU_ROBUST=off); ``solve_refined`` waits for ROADMAP
A11.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..ops import blas
from ..ops import blas_pallas as bpl
from ..ops import pair as pops
from .cg import SolverResult

F32 = torch.float32


class StorageCodec(NamedTuple):
    """How the sloppy iterates are stored and operated on.

    ``down``/``up`` convert between the precise representation and the
    sloppy storage; ``norm2``/``redot`` reduce in storage (f32
    accumulation); ``axpy(a, x, y) = y + a*x`` for a real 0-d tensor a,
    computed in f32 and rounded back to storage; ``axpy_norm2(a, x, y) =
    (y + a*x, |..|^2)`` is the fused update and reduce (one kernel)."""
    down: Callable
    up: Callable
    norm2: Callable
    redot: Callable
    axpy: Callable
    axpy_norm2: Callable


def _make_pair_codec(down, up, store_dtype) -> StorageCodec:
    """Reductions and axpy shared by every pair-storage layout: ONE home
    for the f32-accumulate rounding policy the reliable updates rely on.
    The fused update and reduce is kernel B3's wrapper, which takes the
    norm of the rounded stored value (its plain version on CPU tensors)."""
    def axpy(a, x, y):
        return (y.to(F32) + a.to(F32) * x.to(F32)).to(store_dtype)

    return StorageCodec(
        down=down, up=up,
        norm2=pops.pair_norm2,
        redot=pops.pair_redot,
        axpy=axpy,
        axpy_norm2=bpl.axpy_norm2_pallas)


def packed_pair_codec(store_dtype, precise_dtype) -> StorageCodec:
    """Complex packed fields <-> pair storage with re/im on axis 2 of
    (4,3,2,T,Z,YX) (the packed pair stencils)."""
    from ..ops import wilson_packed as wpk
    return _make_pair_codec(
        lambda x: wpk.to_packed_pairs(x, store_dtype).contiguous(),
        lambda x: wpk.from_packed_pairs(x, precise_dtype), store_dtype)


def pair_inplace_codec(store_dtype, precise_dtype=F32) -> StorageCodec:
    """Codec for a precise representation that is itself a pair array on
    the sloppy storage's layout (the complex-free solve path): float32,
    or float64 on the native double route with float32 sloppy storage.
    down/up are plain dtype casts."""
    return _make_pair_codec(lambda x: x.to(store_dtype),
                            lambda x: x.to(precise_dtype), store_dtype)


def _reliable_result(x, k, r2_fin, stop, n_rel):
    return SolverResult(x, k, r2_fin, float(r2_fin) <= stop,
                        reliable_updates=n_rel)


def _sloppy_step(codec, matvec_lo, p, x_lo, r_lo, r2_lo):
    """One CG iteration in sloppy storage: returns the new (x_lo, r_lo,
    p, r2_new) with r2_new a 0-d float32 tensor on the device."""
    Ap = matvec_lo(p)
    pAp = codec.redot(p, Ap).to(F32)
    alpha = r2_lo / torch.clamp(pAp, min=torch.finfo(F32).tiny)
    x_lo = codec.axpy(alpha, p, x_lo)
    r_lo, r2_new = codec.axpy_norm2(-alpha, Ap, r_lo)
    r2_new = r2_new.to(F32)
    beta = r2_new / r2_lo
    p = codec.axpy(beta, p, r_lo)
    return x_lo, r_lo, p, r2_new


def cg_reliable(matvec_hi: Callable, matvec_lo: Callable, b: torch.Tensor,
                codec: StorageCodec, tol: float = 1e-10, maxiter: int = 2000,
                delta: float = 0.1) -> SolverResult:
    """Mixed-precision CG with reliable updates.

    matvec_hi acts on the precise representation, matvec_lo on the
    sloppy storage.  Convergence is judged on the true residual kept
    through the reliable updates, and the returned r2 is the float64-
    accumulated |b - A x|^2 of the final x, so it is trustworthy at the precise
    level.  ``reliable_updates`` on the result counts the updates.
    A ShardedField (a mesh) is refused: the compensated reductions and
    the storage codec are not sharded yet (ROADMAP A15)."""
    from ..parallel.mesh import ShardedField
    if isinstance(b, ShardedField):
        raise NotImplementedError(
            "cg_reliable on a mesh is not ported yet (ROADMAP A15): solve "
            "the sharded operator with fused_cg")
    b2 = blas.norm2(b)
    stop = (tol ** 2) * float(b2)

    x = torch.zeros_like(b)        # precise accumulated solution
    r_lo = codec.down(b)
    p = r_lo
    x_lo = torch.zeros_like(r_lo)  # sloppy partial solution since the update
    # the sloppy loop's scalars are float32 whatever the precise dtype
    # (B3 takes a float32 coefficient)
    r2_lo = b2.to(F32)
    r2 = r2max = float(b2)
    k = n_rel = 0
    while r2 > stop and k < maxiter:
        x_lo, r_lo, p, r2_new = _sloppy_step(codec, matvec_lo, p, x_lo,
                                             r_lo, r2_lo)
        k += 1
        r2_new_h = float(r2_new)           # the iteration's one host read
        r2max = max(r2max, r2_new_h)
        if r2_new_h < (delta ** 2) * r2max or r2_new_h < stop:
            x = x + codec.up(x_lo)
            r_true = b - matvec_hi(x)
            # f64 accumulation: the residual must be trustworthy below
            # the plain-f32 accumulation floor
            r2_lo = blas.norm2_comp(r_true).to(F32)
            # restart the direction at the true residual
            r_lo = codec.down(r_true)
            p = r_lo
            x_lo = torch.zeros_like(x_lo)
            r2 = r2max = float(r2_lo)
            n_rel += 1
        else:
            r2_lo = r2_new
            r2 = r2_new_h
    x_fin = x + codec.up(x_lo)
    r2_fin = blas.norm2_comp(b - matvec_hi(x_fin))
    return _reliable_result(x_fin, k, r2_fin, stop, n_rel)


def cg_reliable_df(op_df, matvec_lo: Callable, rhs_df, codec: StorageCodec,
                   tol: float = 1e-10, maxiter: int = 4000,
                   delta: float = 0.1) -> SolverResult:
    """Extended-precision reliable-update CG on the normal equations.

    * ``op_df``: df64 operator (ops/wilson_df64.WilsonPCDF64): ``M``,
      ``Mdag`` and ``residual_df`` on df64 fields.
    * ``matvec_lo``: the sloppy normal operator (MdagM) on the storage
      representation (f32 or bf16 pair arrays, the df64 hi word's layout).
    * ``rhs_df``: df64 rhs of the PC system M x = b.

    The loop iterates on Mdag M x = Mdag b in sloppy storage; convergence
    is judged on the df64 DIRECT residual |b - M x|^2, recomputed at every
    reliable update, so the returned r2 certifies the direct system.  When
    the normal system looks converged but the direct one is not, the
    normal-residual trigger tightens itself (x 1/16)."""
    from ..ops import df64 as dfm
    d2 = float(dfm.to_f32(dfm.norm2(rhs_df)))
    stop_d = (tol ** 2) * d2

    rn = dfm.to_f32(op_df.Mdag(rhs_df))       # normal residual at x = 0
    stop_n = (tol ** 2) * float(dfm.to_f32(dfm.norm2_f32(rn)))

    x = (torch.zeros_like(rhs_df[0]), torch.zeros_like(rhs_df[1]))
    r_lo = codec.down(rn)
    p = r_lo
    x_lo = torch.zeros_like(r_lo)
    r2_lo = codec.norm2(r_lo).to(F32)
    r2max = float(r2_lo)
    k = n_rel = 0
    while d2 > stop_d and k < maxiter:
        x_lo, r_lo, p, r2_new = _sloppy_step(codec, matvec_lo, p, x_lo,
                                             r_lo, r2_lo)
        k += 1
        r2_new_h = float(r2_new)           # the iteration's one host read
        r2max = max(r2max, r2_new_h)
        if r2_new_h < (delta ** 2) * r2max or r2_new_h < stop_n:
            x = dfm.add(x, dfm.promote(codec.up(x_lo)))
            d_df = op_df.residual_df(rhs_df, x)
            d2 = float(dfm.to_f32(dfm.norm2(d_df)))
            rn = dfm.to_f32(op_df.Mdag(d_df))
            r2_lo = dfm.to_f32(dfm.norm2_f32(rn))
            rn2_true = float(r2_lo)
            if d2 > stop_d and rn2_true <= stop_n:
                # the normal target was met but not the direct one
                stop_n /= 16.0
            r_lo = codec.down(rn)
            p = r_lo
            x_lo = torch.zeros_like(x_lo)
            r2max = rn2_true
            n_rel += 1
        else:
            r2_lo = r2_new
    x_fin = dfm.add(x, dfm.promote(codec.up(x_lo)))
    d2_fin = dfm.to_f32(dfm.norm2(op_df.residual_df(rhs_df, x_fin)))
    return _reliable_result(x_fin, k, d2_fin, stop_d, n_rel)
