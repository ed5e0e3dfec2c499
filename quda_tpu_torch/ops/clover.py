"""Clover term: construction, application, inversion.

Port of quda_tpu/ops/clover.py (``clover_trlog`` waits for HMC, ROADMAP
A14).  In the DeGrand-Rossi chiral basis sigma_{mu nu} is
block-diagonal over chirality, so the clover matrix
A(x) = 1 + coeff * sum_{mu<nu} sigma_p F_p(x) splits into two Hermitian
6x6 blocks ((spin within chirality) x color).  Storage is exactly those
blocks: (..., 2, 6, 6), the uncompressed form of QUDA's 72-real layout.

coeff = kappa * csw / 2 with the conventions of models/clover.py.
"""

from __future__ import annotations

import numpy as np
import torch

from . import gamma as g
from .fmunu import PLANES, field_strength


class CloverNotPositiveDefinite(ValueError):
    """Some clover blocks have no Cholesky factor, so A^-1 does not exist
    in this form (csw too large for the gauge field)."""

    def __init__(self, bad_blocks: int, total: int):
        super().__init__(
            f"{bad_blocks} of {total} clover 6x6 blocks are not positive "
            "definite: no Cholesky factor, no clover inverse")
        self.bad_blocks = bad_blocks
        self.total = total


def _sigma_blocks(dtype, device=None) -> torch.Tensor:
    """sigma_{mu nu} chiral blocks for the 6 planes: (6, 2, 2, 2) —
    [plane, chirality, s, s']."""
    blocks = np.zeros((6, 2, 2, 2), dtype=np.complex128)
    for p, (mu, nu) in enumerate(PLANES):
        s = g.SIGMA[mu, nu]
        if not (np.allclose(s[:2, 2:], 0) and np.allclose(s[2:, :2], 0)):
            raise AssertionError("sigma must be chiral-block-diagonal in "
                                 "this basis")
        blocks[p, 0] = s[:2, :2]
        blocks[p, 1] = s[2:, 2:]
    return torch.as_tensor(blocks, dtype=dtype, device=device)


def clover_blocks(gauge: torch.Tensor, coeff: float) -> torch.Tensor:
    """A(x) chiral blocks from complex links (4,T,Z,Y,X,3,3):
    (T,Z,Y,X,2,6,6), Hermitian.

    A = 1 + coeff * sum_p sigma_p (x) F_p   (spin (x) color -> 6x6)."""
    f = field_strength(gauge)                              # (6,T,Z,Y,X,3,3)
    sig = _sigma_blocks(gauge.dtype, gauge.device)         # (6,2,2,2)
    # (T,Z,Y,X, chir, s, a, s', b) so the reshape groups (s,a) x (s',b)
    sf = torch.einsum("pcij,p...ab->...ciajb", sig, f)
    lat = sf.shape[:4]
    a = coeff * sf.reshape(lat + (2, 6, 6))
    return a + torch.eye(6, dtype=gauge.dtype, device=gauge.device)


def apply_clover(blocks: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
    """A psi with psi (..., 4, 3): chirality split, 6x6 matvec, rejoin."""
    lat = psi.shape[:-2]
    chi = psi.reshape(lat + (2, 6))
    out = torch.einsum("...cij,...cj->...ci", blocks, chi)
    return out.reshape(lat + (4, 3))


def invert_clover(blocks: torch.Tensor) -> torch.Tensor:
    """Per-site inverse of the Hermitian 6x6 blocks: a Cholesky factor
    L L^H = A and two triangular solves (QUDA: lib/clover_invert.cu).
    Set-up work, left to the library as the JAX package leaves it to
    XLA.  Raises ``CloverNotPositiveDefinite`` if any block has no
    Cholesky factor, instead of returning NaNs."""
    chol, info = torch.linalg.cholesky_ex(blocks)
    bad = int((info != 0).sum())
    if bad:
        raise CloverNotPositiveDefinite(bad, info.numel())
    eye = torch.eye(6, dtype=blocks.dtype,
                    device=blocks.device).expand(blocks.shape)
    # solve L L^H X = I  ->  X = A^-1
    y = torch.linalg.solve_triangular(chol, eye, upper=False)
    return torch.linalg.solve_triangular(chol.mH, y, upper=True)
