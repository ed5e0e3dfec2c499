"""HISQ / asqtad link fattening: fat7, U(3) reunitarisation, the
level-2 fat links (asqtad staples and Lepage) and the Naik links.

Port of quda_tpu/gauge/hisq.py (complex path), the construction behind
``compute_ks_link_quda`` (computeKSLinkQuda, lib/llfat_quda.cu and
lib/unitarize_links_quda.cu in QUDA).  The reunitarisation uses the closed-form inverse square root,
in double (``unitarize_links``).  Path coefficients follow the MILC
convention (one-link, Naik, 3-staple, 5-staple, 7-staple, Lepage), and
the JAX package's convention factors are kept exactly: the Lepage term
x 0.5, each 5-staple x 0.5 and each 7-staple / 6 (every staple pair
already holds both orientations).  Every staple is the same nested
``_staple_pair``: 5- and 7-link paths are staples of staples, the Lepage
term a same-direction double staple.  Links (4, T, Z, Y, X, 3, 3)
complex, in the precision they come in.  ``two_link`` (quark smearing)
waits for ROADMAP A14.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.shift import shift
from ..ops.su3 import dagger, inv_sqrt_herm3, mat_mul


class HisqCoeffs(NamedTuple):
    one_link: float
    naik: float
    three: float
    five: float
    seven: float
    lepage: float


# MILC fat7 (first HISQ level) and asqtad (second level) coefficient sets
FAT7_COEFFS = HisqCoeffs(1.0 / 8.0, 0.0, 1.0 / 16.0, 1.0 / 64.0,
                         1.0 / 384.0, 0.0)
ASQTAD_COEFFS = HisqCoeffs(1.0 / 8.0 + 3.0 / 8.0 + 1.0 / 8.0, -1.0 / 24.0,
                           1.0 / 16.0, 1.0 / 64.0, 1.0 / 384.0, -1.0 / 8.0)
# second HISQ level; its Naik correction enters through eps in
# hisq_fattening
HISQ_L2_COEFFS = HisqCoeffs(1.0, -1.0 / 24.0, 1.0 / 16.0, 1.0 / 64.0,
                            1.0 / 384.0, -1.0 / 8.0)


def _staple_pair(x_mu: torch.Tensor, u_nu: torch.Tensor, mu: int, nu: int):
    """Up + down staple of the link field x_mu decorated by u_nu."""
    up = mat_mul(mat_mul(u_nu, shift(x_mu, nu, +1)),
                 dagger(shift(u_nu, mu, +1)))
    u_dn = shift(u_nu, nu, -1)
    dn = mat_mul(dagger(u_dn), mat_mul(shift(x_mu, nu, -1),
                                       shift(u_dn, mu, +1)))
    return up + dn


def fat_links(gauge: torch.Tensor, c: HisqCoeffs) -> torch.Tensor:
    """Fattening for one coefficient set:
    3-staple sum_nu staple_nu(U_mu); 5-staple sum_{nu != rho}
    staple_nu(staple_rho(U_mu)); 7-staple the fully nested
    three-direction one; Lepage staple_nu(staple_nu(U_mu))."""
    fat = []
    for mu in range(4):
        acc = c.one_link * gauge[mu]
        for nu in range(4):
            if nu == mu:
                continue
            s3 = _staple_pair(gauge[mu], gauge[nu], mu, nu)
            acc = acc + c.three * s3
            if c.lepage != 0.0:
                # both orientations are in s3 already: halve
                acc = acc + c.lepage * _staple_pair(s3, gauge[nu], mu,
                                                    nu) * 0.5
            for rho in range(4):
                if rho in (mu, nu):
                    continue
                s5 = _staple_pair(_staple_pair(gauge[mu], gauge[rho],
                                               mu, rho), gauge[nu], mu, nu)
                acc = acc + c.five * s5 * 0.5
                for sg in range(4):
                    if sg in (mu, nu, rho):
                        continue
                    s7 = _staple_pair(
                        _staple_pair(
                            _staple_pair(gauge[mu], gauge[sg], mu, sg),
                            gauge[rho], mu, rho), gauge[nu], mu, nu)
                    acc = acc + c.seven * s7 / 6.0
        fat.append(acc)
    return torch.stack(fat)


def naik_links(gauge: torch.Tensor) -> torch.Tensor:
    """The straight 3-link field U_mu(x) U_mu(x+mu) U_mu(x+2mu)."""
    return torch.stack([
        mat_mul(mat_mul(gauge[mu], shift(gauge[mu], mu, +1)),
                shift(gauge[mu], mu, 2)) for mu in range(4)])


def unitarize_links(v: torch.Tensor) -> torch.Tensor:
    """U(3) projection W = V (V^dag V)^{-1/2}, computed in complex128 and
    returned in v's dtype.  The inverse square root is the closed
    Cayley-Hamilton/Cardano form (ops/su3.inv_sqrt_herm3, the JAX
    package's pair-path algorithm), not the batched eigh of its complex
    path: cuSOLVER refuses a batched eigh of the 4.2 M links of a 32^4
    lattice, and the closed form is a few dozen elementwise passes.  In
    double because a fat7 link of a hot gauge can be nearly singular
    (V^dag V with condition numbers of 1e3-1e4), where a complex64
    inverse square root leaves |W^dag W - 1| near 1e-3 (QUDA falls back
    to a double-precision SVD there, include/svd_quda.h)."""
    v64 = v.to(torch.complex128)
    return mat_mul(v64, inv_sqrt_herm3(mat_mul(dagger(v64), v64))).to(
        v.dtype)


def unitarity_violation(w: torch.Tensor) -> float:
    """max |W^dag W - 1| over every link: how far the projection is
    from U(3)."""
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return float((mat_mul(dagger(w), w) - eye).abs().max())


class HisqLinks(NamedTuple):
    fat: torch.Tensor
    long: torch.Tensor
    w_unitarized: torch.Tensor


def hisq_fattening(gauge: torch.Tensor, naik_eps: float = 0.0) -> HisqLinks:
    """The two-level HISQ construction (computeKSLinkQuda): fat7, U(3)
    reunitarisation, the level-2 fat links (with Lepage) and the Naik
    links of the reunitarised field, -(1 + eps)/24 W W W."""
    v = fat_links(gauge, FAT7_COEFFS)
    w = unitarize_links(v)
    fat = fat_links(w, HISQ_L2_COEFFS)
    lng = (1.0 + naik_eps) * (-1.0 / 24.0) * naik_links(w)
    return HisqLinks(fat, lng, w)
