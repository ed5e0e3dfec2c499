"""Site-wise BLAS and reductions, as in quda_tpu/ops/blas.py.

Plain PyTorch; on the solve path the reductions stay here while the CG
tail and the reliable-update residual update run as kernels
(ops/blas_pallas.py), whose plain versions are ``triple_cg_update`` and
``blas_pallas.axpy_norm2_plain``.  Works on real (pair-form) and complex
tensors.  The compensated sums (``norm2_comp``, ``cdot_comp``) accumulate
in float64.

``norm2``, ``redot`` and ``zeros_like`` also take a ShardedField
(parallel/mesh.py): the reduction runs per block and
``parallel/halo.psum_scalar`` adds the partials in sub-domain order, so
a solver loop on a mesh moves only scalars (and the hop's faces).
"""

from __future__ import annotations

import torch

from ..parallel.halo import psum_scalar
from ..parallel.mesh import ShardedField


def _r(x: torch.Tensor) -> torch.Tensor:
    """|x|^2 elementwise, without complex multiplies."""
    if x.is_complex():
        return x.real * x.real + x.imag * x.imag
    return x * x


def norm2(x: torch.Tensor) -> torch.Tensor:
    if isinstance(x, ShardedField):
        return psum_scalar([norm2(b) for b in x.blocks])
    return torch.sum(_r(x))


def cdot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """<x, y> = sum conj(x) y; the real dot for real (pair) tensors."""
    if x.is_complex():
        return torch.sum(torch.conj(x) * y)
    return torch.sum(x * y)


def redot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Re<x, y>."""
    if isinstance(x, ShardedField):
        return psum_scalar([redot(a, b) for a, b in zip(x.blocks, y.blocks)])
    if x.is_complex():
        return torch.sum(x.real * y.real + x.imag * y.imag)
    return torch.sum(x * y)


def zeros_like(x):
    """A zero field of x's shape, dtype and placement (blocks too)."""
    if isinstance(x, ShardedField):
        return x.zeros_like()
    return torch.zeros_like(x)


# -- compensated reductions -------------------------------------------------
# Wherever a reported residual must be trusted below the f32 accumulation
# floor (reliable updates, the df64 route's epilogue), the sum runs in
# float64: the square of an f32 value is exact in f64, and an f64 sum of
# n terms is off by O(n 2^-53), far below the f32 floor.  The card has
# native f64, so this is one reduction; the JAX package emulates it with
# df64 (ops/df64.py) for want of f64 on a TPU.

def _f64(x: torch.Tensor) -> torch.Tensor:
    return (torch.view_as_real(x) if x.is_complex() else x).to(torch.float64)


def norm2_comp(x: torch.Tensor) -> torch.Tensor:
    """|x|^2 accumulated in float64 (a float64 0-d tensor)."""
    v = _f64(x)
    return torch.sum(v * v)


def cdot_comp(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """<x, y> = sum conj(x) y accumulated in complex128."""
    return torch.sum(torch.conj(x.to(torch.complex128))
                     * y.to(torch.complex128))


def triple_cg_update(a, p, Ap, x, r):
    """x += a p; r -= a Ap; return (x, r, |r|^2) — the CG iteration tail
    (plain version of ops/blas_pallas.cg_update_norm2_pallas)."""
    xn = x + a * p
    rn = r - a * Ap
    return xn, rn, norm2(rn)
