"""Fermion boundary conditions and staggered phases folded into the links.

Port of quda_tpu/ops/boundary.py (complex links).  The antiperiodic t
phase multiplies the t-links of the last time slice (the last three for
the staggered long links), and the MILC staggered phases eta_mu(x)
multiply every link, so every stencil (the CUDA hop kernels included) is
purely periodic and carries no sign of its own.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields.geometry import LatticeGeometry


def apply_t_boundary(gauge: torch.Tensor, geom: LatticeGeometry,
                     sign: int = -1, depth: int = 1) -> torch.Tensor:
    """Multiply the t-links on the last ``depth`` time slices by ``sign``.
    gauge: (4, T, Z, Y, X, 3, 3).  ``depth`` is the hop length the links
    serve: 1 for ordinary links, 3 for the staggered long (Naik) links (a
    3-hop from t in {T-3, T-2, T-1} crosses the boundary once).  Returns
    a new tensor (or ``gauge`` itself for sign == 1)."""
    if sign == 1:
        return gauge
    out = gauge.clone()
    out[3, geom.T - depth:] *= sign
    return out


def staggered_phases_milc(geom: LatticeGeometry) -> np.ndarray:
    """MILC-convention staggered phases eta_mu(x) (lib/gauge_phase.cu):
    eta_x = 1, eta_y = (-1)^x, eta_z = (-1)^(x+y), eta_t = (-1)^(x+y+z).
    Returns a (4, T, Z, Y, X) float array of +-1."""
    T, Z, Y, X = geom.lattice_shape
    z = np.arange(Z)[None, :, None, None]
    y = np.arange(Y)[None, None, :, None]
    x = np.arange(X)[None, None, None, :]
    ones = np.ones((T, Z, Y, X))
    return np.stack([ones, (-1.0) ** x * ones, (-1.0) ** (x + y) * ones,
                     (-1.0) ** (x + y + z) * ones])


def apply_staggered_phases(gauge: torch.Tensor, geom: LatticeGeometry,
                           antiperiodic_t: bool = True,
                           nhop: int = 1) -> torch.Tensor:
    """Fold the MILC staggered phases (and the antiperiodic t boundary,
    ``depth=nhop``) into complex links (4, T, Z, Y, X, 3, 3).  eta_mu(x)
    does not depend on x_mu, so the same site phase serves the nhop = 3
    long links; only the boundary depth differs."""
    eta = torch.as_tensor(staggered_phases_milc(geom), device=gauge.device)
    out = gauge * eta.reshape(eta.shape + (1, 1)).to(gauge.dtype)
    if antiperiodic_t:
        out = apply_t_boundary(out, geom, -1, depth=nhop)
    return out
