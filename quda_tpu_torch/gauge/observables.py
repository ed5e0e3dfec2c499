"""Gauge observables, as in quda_tpu/gauge/observables.py: the plaquette.

The Polyakov loop, topological charge and energy wait for ROADMAP A14.
"""

from __future__ import annotations

import torch

from ..ops.fmunu import PLANES
from ..ops.shift import shift
from ..ops.su3 import dagger, mat_mul_fma, trace


def plaquette_field(gauge: torch.Tensor, mu: int, nu: int) -> torch.Tensor:
    """P_{mu nu}(x) = U_mu(x) U_nu(x+mu) U_mu(x+nu)^dag U_nu(x)^dag."""
    u_mu, u_nu = gauge[mu], gauge[nu]
    return mat_mul_fma(mat_mul_fma(u_mu, shift(u_nu, mu, +1)),
                       dagger(mat_mul_fma(u_nu, shift(u_mu, nu, +1))))


def plaquette(gauge: torch.Tensor):
    """(mean, spatial, temporal) of Re tr P / 3 over sites and planes, as
    0-d real tensors (plaqQuda's order)."""
    sp, tm = [], []
    for mu, nu in PLANES:
        p = torch.mean(trace(plaquette_field(gauge, mu, nu)).real) / 3.0
        (tm if nu == 3 else sp).append(p)
    s = sum(sp) / len(sp)
    t = sum(tm) / len(tm)
    return (s + t) / 2.0, s, t
