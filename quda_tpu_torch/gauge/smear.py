"""Staples of the link field, as in quda_tpu/gauge/smear.py.

``staple`` and ``staple_sum`` are what the heatbath (gauge/heatbath.py)
needs.  APE, stout, HYP and the gradient flows wait for ROADMAP A14.
Links (4, T, Z, Y, X, 3, 3) complex, in the precision they come in.
"""

from __future__ import annotations

import torch

from ..ops.shift import shift
from ..ops.su3 import dagger, mat_mul_fma


def staple(gauge: torch.Tensor, mu: int, nu: int) -> torch.Tensor:
    """Upper + lower staple of U_mu in the (mu, nu) plane."""
    u_mu, u_nu = gauge[mu], gauge[nu]
    up = mat_mul_fma(mat_mul_fma(u_nu, shift(u_mu, nu, +1)),
                     dagger(shift(u_nu, mu, +1)))
    u_nu_dn = shift(u_nu, nu, -1)
    dn = mat_mul_fma(dagger(u_nu_dn),
                     mat_mul_fma(shift(u_mu, nu, -1),
                                 shift(u_nu_dn, mu, +1)))
    return up + dn


def staple_sum(gauge: torch.Tensor, mu: int, dirs=None) -> torch.Tensor:
    """Sum of the staples of U_mu over ``dirs`` (default: every nu != mu)."""
    dirs = [nu for nu in range(4) if nu != mu] if dirs is None else dirs
    s = None
    for nu in dirs:
        t = staple(gauge, mu, nu)
        s = t if s is None else s + t
    return s
