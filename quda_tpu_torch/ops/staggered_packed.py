"""Staggered / improved-staggered dslash on the packed pair layout.

Port of quda_tpu/ops/staggered_packed.py (the pair-form stencils and the
pack helpers).  Packed order keeps every colour component its own
lattice plane, with re/im an axis of its own before T:

    staggered spinor  (3, 2, T, Z, Y*X[h])
    links             (4, 3, 3, 2, T, Z, Y*X[h])   [direction, row, col]

Shifts are ops/wilson_packed's ``shift_packed`` (full lattice) and
``shift_eo_packed`` (half lattice), both nhop-aware.  Every sum is
float32; the output is cast to ``out_dtype`` at the end.
``dslash_staggered_eo_packed_pairs`` is the XLA pair stencil of the JAX
package, the reference both kernels' plain versions are held to.
"""

from __future__ import annotations

import torch

from .wilson_packed import pack_gauge as pack_links  # (4,3,3,T,Z,Y*X)
from .wilson_packed import shift_eo_packed, shift_packed

__all__ = ["pack_links", "pack_staggered", "unpack_staggered",
           "hopset_pairs", "dslash_staggered_packed_pairs",
           "dslash_staggered_eo_packed_pairs"]

F32 = torch.float32


def pack_staggered(psi: torch.Tensor) -> torch.Tensor:
    """(..., T,Z,Y,X,1,3) -> (..., 3,T,Z,Y*X); leading axes stay."""
    lead = tuple(psi.shape[:-6])
    T, Z, Y, X = psi.shape[-6:-2]
    k = len(lead)
    perm = tuple(range(k)) + (k + 4, k, k + 1, k + 2, k + 3)
    return psi[..., 0, :].permute(perm).reshape(lead + (3, T, Z, Y * X))


def unpack_staggered(pp: torch.Tensor, lattice_shape) -> torch.Tensor:
    """(..., 3,T,Z,Y*X) -> (..., T,Z,Y,X,1,3)."""
    T, Z, Y, X = lattice_shape
    lead = tuple(pp.shape[:-4])
    k = len(lead)
    perm = tuple(range(k)) + (k + 1, k + 2, k + 3, k + 4, k)
    return pp.reshape(lead + (3, T, Z, Y, X)).permute(perm)[..., None, :]


def _mat_vec(u: torch.Tensor, v: torch.Tensor, adjoint: bool):
    """u (3,3,2,*site), v (3,2,*site), both f32 -> (3,2,*site): U v, or
    U^dag v with U^dag[a][b] = conj(U[b][a])."""
    ur, ui = u[:, :, 0], u[:, :, 1]                  # (3(a),3(b),*site)
    if adjoint:
        ur, ui = ur.transpose(0, 1), -ui.transpose(0, 1)
    vr, vi = v[None, :, 0], v[None, :, 1]            # (1,3(b),*site)
    re = (ur * vr - ui * vi).sum(dim=1)
    im = (ur * vi + ui * vr).sum(dim=1)
    return torch.stack([re, im], dim=1)


def hopset_pairs(u_here: torch.Tensor, u_bw: torch.Tensor,
                 psi_pp: torch.Tensor, shift_fn, nhop: int) -> torch.Tensor:
    """One hop set, float32: sum_mu 1/2 [U_mu(x) psi(x + n mu) -
    U_bw,mu(x)^dag psi(x - n mu)], with U_bw,mu(x) = U_mu(x - n mu) given
    pre-shifted and ``shift_fn(arr, mu, sign, nhop)`` the site shift."""
    psi = psi_pp.to(F32)
    acc = None
    for mu in range(4):
        fwd = _mat_vec(u_here[mu].to(F32), shift_fn(psi, mu, +1, nhop),
                       adjoint=False)
        bwd = _mat_vec(u_bw[mu].to(F32), shift_fn(psi, mu, -1, nhop),
                       adjoint=True)
        term = 0.5 * (fwd - bwd)
        acc = term if acc is None else acc + term
    return acc


def dslash_staggered_packed_pairs(fat_pp: torch.Tensor, psi_pp: torch.Tensor,
                                  X: int, Y: int,
                                  long_pp: torch.Tensor | None = None,
                                  out_dtype=None) -> torch.Tensor:
    """Full-lattice pair-form D psi (phases folded).  fat_pp/long_pp:
    (4,3,3,2,T,Z,Y*X); psi_pp (3,2,T,Z,Y*X) f32 or bf16."""
    out_dtype = out_dtype or psi_pp.dtype

    def sh(a, mu, sign, nhop):
        return shift_packed(a, mu, sign, X, Y, nhop)

    acc = None
    for links, nhop in (((fat_pp, 1),) if long_pp is None
                        else ((fat_pp, 1), (long_pp, 3))):
        u_bw = [sh(links[mu], mu, -1, nhop) for mu in range(4)]
        term = hopset_pairs(links, u_bw, psi_pp, sh, nhop)
        acc = term if acc is None else acc + term
    return acc.to(out_dtype)


def dslash_staggered_eo_packed_pairs(fat_eo_pp, psi_pp: torch.Tensor, dims,
                                     target_parity: int, long_eo_pp=None,
                                     out_dtype=None) -> torch.Tensor:
    """Checkerboarded pair-form staggered hop (mirrors
    ops/staggered.dslash_eo).  fat_eo_pp/long_eo_pp: (even, odd) of
    (4,3,3,2,T,Z,Y*Xh) links, phases folded; psi_pp: (3,2,T,Z,Y*Xh) of
    parity 1-p.  Both hop counts are odd, so the forward links live at
    the target parity and the backward links are the opposite parity's,
    shifted back nhop sites.  The fat and Naik sets are summed at the
    end, each in float32."""
    out_dtype = out_dtype or psi_pp.dtype
    p = target_parity

    def sh(a, mu, sign, nhop):
        return shift_eo_packed(a, dims, mu, sign, p, nhop)

    acc = None
    for links_eo, nhop in (((fat_eo_pp, 1),) if long_eo_pp is None
                           else ((fat_eo_pp, 1), (long_eo_pp, 3))):
        u_there = links_eo[1 - p]
        u_bw = [sh(u_there[mu], mu, -1, nhop) for mu in range(4)]
        term = hopset_pairs(links_eo[p], u_bw, psi_pp, sh, nhop)
        acc = term if acc is None else acc + term
    return acc.to(out_dtype)
