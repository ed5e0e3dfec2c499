"""Fifth-dimension (Ls) operator algebra for domain-wall / Möbius fermions.

Port of quda_tpu/ops/dwf.py.  Every fifth-dimension operator of
DWF/Möbius (the diagonal-plus-hop M5, the kappa-weight M5', their
inverses and adjoints) is chirality-block-diagonal and site-independent:
a pair of dense (Ls, Ls) matrices acting on the s axis per chirality.
They are built in NumPy at set-up and applied as einsum contractions
(plain PyTorch: the JAX package leaves them to XLA, and they carry no
gauge traffic for a kernel to save).

With P+- = (1 +- gamma5)/2 (diagonal in the DeGrand-Rossi basis) and the
-mf boundary wrap,

    chi(s) = P_- psi(s+1) + P_+ psi(s-1)          (hop5(mf))
    M5[alpha, beta] psi = alpha psi + beta chi

acts per chirality as  A_+ = alpha I + beta S^-(mf),
                       A_- = alpha I + beta S^+(mf),
where S^+-(mf) are cyclic shifts with the wrap entry scaled by -mf.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class SOp(NamedTuple):
    """Chirality-block s-operator: (Ls,Ls) matrices for (+,-) chirality."""
    ap: np.ndarray
    am: np.ndarray

    def __matmul__(self, other: "SOp") -> "SOp":
        return SOp(self.ap @ other.ap, self.am @ other.am)

    def adj(self) -> "SOp":
        return SOp(self.ap.conj().T, self.am.conj().T)

    def inv(self) -> "SOp":
        return SOp(np.linalg.inv(self.ap), np.linalg.inv(self.am))


def s_shift(ls: int, mf: float, direction: int) -> np.ndarray:
    """S^+ (direction=+1: out(s) = in(s-1)) or S^- (out(s) = in(s+1)),
    with the boundary wrap scaled by -mf."""
    m = np.zeros((ls, ls))
    for s in range(ls):
        sp = s - direction
        w = 1.0
        if sp < 0:
            sp += ls
            w = -mf
        elif sp >= ls:
            sp -= ls
            w = -mf
        m[s, sp] = w
    return m


def identity_sop(ls: int) -> SOp:
    return SOp(np.eye(ls), np.eye(ls))


def m5_sop(ls: int, alpha: float, beta: float, mf: float) -> SOp:
    """alpha + beta * [P_- shift(+) + P_+ shift(-)] as chirality blocks.

    + chirality picks up the P_+ term (in(s-1)), - chirality the P_- term.
    """
    eye = np.eye(ls)
    return SOp(alpha * eye + beta * s_shift(ls, mf, +1),
               alpha * eye + beta * s_shift(ls, mf, -1))


def apply_sop(sop: SOp, psi: torch.Tensor) -> torch.Tensor:
    """Apply to psi of shape (Ls, ..., 4, 3); chirality = spin pairs."""
    dt, dev = psi.dtype, psi.device
    up = torch.einsum("st,t...->s...", torch.as_tensor(sop.ap, dtype=dt,
                                                       device=dev),
                      psi[..., :2, :])
    dn = torch.einsum("st,t...->s...", torch.as_tensor(sop.am, dtype=dt,
                                                       device=dev),
                      psi[..., 2:, :])
    return torch.cat([up, dn], dim=-2)
