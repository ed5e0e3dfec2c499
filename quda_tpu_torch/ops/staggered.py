"""Staggered and improved-staggered (asqtad/HISQ) dslash, canonical layout.

Port of quda_tpu/ops/staggered.py (complex path): the reference stencil
and the full-lattice operator of the staggered true-residual check.  The
KS phases and the antiperiodic t boundary are folded into the links
beforehand (ops/boundary.py), so the stencil is purely

    D psi(x) = sum_mu 1/2 [ U_mu(x) psi(x+mu) - U_mu^dag(x-mu) psi(x-mu) ]
             ( + the same with the long links and 3-hop shifts )

D is anti-Hermitian and M = 2m + D (MILC convention), so
M^dag M = 4m^2 - D^2 is block diagonal over parity.  Fields carry a spin
axis of extent 1: psi (T, Z, Y, X, 1, 3).  Flops per site: 570, or 1146
with the Naik term.
"""

from __future__ import annotations

import torch

from ..fields.geometry import LatticeGeometry
from .shift import shift, shift_eo
from .su3 import dagger


def _color_mul(u, psi):
    """(..., a, b) x (..., s, b) -> (..., s, a)."""
    return torch.einsum("...ab,...sb->...sa", u, psi)


def dslash_full(fat: torch.Tensor, psi: torch.Tensor,
                long: torch.Tensor | None = None) -> torch.Tensor:
    """Full-lattice staggered D psi; ``long`` adds the 3-hop Naik term.
    fat/long: (4,T,Z,Y,X,3,3) phase-folded links; psi: (T,Z,Y,X,1,3)."""
    out = torch.zeros_like(psi)
    for mu in range(4):
        u = fat[mu]
        out = out + 0.5 * _color_mul(u, shift(psi, mu, +1))
        ub = shift(dagger(u), mu, -1)
        out = out - 0.5 * _color_mul(ub, shift(psi, mu, -1))
        if long is not None:
            ul = long[mu]
            out = out + 0.5 * _color_mul(ul, shift(psi, mu, +1, 3))
            ulb = shift(dagger(ul), mu, -1, 3)
            out = out - 0.5 * _color_mul(ulb, shift(psi, mu, -1, 3))
    return out


def hop_term(links: torch.Tensor, psi: torch.Tensor, mu: int,
             sign: int) -> torch.Tensor:
    """One direction of the 1-hop stencil (D = sum of the eight)."""
    if sign > 0:
        return 0.5 * _color_mul(links[mu], shift(psi, mu, +1))
    ub = shift(dagger(links[mu]), mu, -1)
    return -0.5 * _color_mul(ub, shift(psi, mu, -1))


def dslash_eo(fat_eo, psi: torch.Tensor, geom: LatticeGeometry,
              target_parity: int, long_eo=None) -> torch.Tensor:
    """Checkerboarded staggered hop: a parity-(1-p) field (T,Z,Y,Xh,1,3)
    to parity-p sites.  fat_eo/long_eo: (even, odd) (4,T,Z,Y,Xh,3,3).
    Both hop counts are odd, so both flip parity."""
    p = target_parity
    u_here = fat_eo[p]
    u_there = fat_eo[1 - p]
    out = None
    for mu in range(4):
        term = 0.5 * _color_mul(u_here[mu], shift_eo(psi, geom, mu, +1, p))
        ub = shift_eo(dagger(u_there[mu]), geom, mu, -1, p)
        term = term - 0.5 * _color_mul(ub, shift_eo(psi, geom, mu, -1, p))
        if long_eo is not None:
            ul = long_eo[p][mu]
            term = term + 0.5 * _color_mul(
                ul, shift_eo(psi, geom, mu, +1, p, nhop=3))
            ulb = shift_eo(dagger(long_eo[1 - p][mu]), geom, mu, -1, p,
                           nhop=3)
            term = term - 0.5 * _color_mul(
                ulb, shift_eo(psi, geom, mu, -1, p, nhop=3))
        out = term if out is None else out + term
    return out
