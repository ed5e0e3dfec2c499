"""Twisted-mass and twisted-clover Dirac operators (degenerate and
non-degenerate doublet).

Port of quda_tpu/models/twisted.py.  Kappa normalisation with the twist
folded into the diagonal:

    degenerate:      M = (1 + i a gamma5) - kappa D,    a = 2 kappa mu
    non-degenerate:  M = (1 + i a gamma5 tau3 - b tau1) - kappa D,
                     a = 2 kappa mu, b = 2 kappa epsilon   (flavor doublet)
    twisted clover:  M = (A + i a gamma5) - kappa D       (A = clover term)

gamma5 is diag(+1,+1,-1,-1) in the DeGrand-Rossi basis, so the twist is a
per-chirality complex scale.  The twisted operators obey
gamma5 M(mu) gamma5 = M(-mu)^dag, so Mdag uses the explicit twist sign
flip rather than the g5 trick.

Pair companions: the degenerate operators (``DiracTwistedMassPCPairs``,
``DiracTwistedCloverPCPairs``) run every apply of M as two launches of
the fused hop (ops/clover_pallas K1/K2, or K1/K2-mrhs for a batch) with
the twist epilogues: twisted mass block-free, twisted clover on the dense
twisted inverse blocks (K1) and the clover blocks plus the twist (K2).
The full-lattice companions (the operator API's ``mat_quda`` and
``mat_dag_mat_quda``): twisted clover on the full-lattice clover operator
with the twist (models/clover.DiracCloverPackedPairs, ``diag_twist`` = a),
one launch an M; twisted mass (``DiracTwistedMassPackedPairs``) on B4 with
the twist added in the storage's precision, float32 or float64.
The flavour doublets (``DiracNdeg*PCPairs``) keep the staged composition,
as the JAX package does (its formsel.resolve_ndeg never fuses them): the
-b tau1 term couples the flavour planes, which no per-plane epilogue
expresses.  Their hop runs B1 once per flavour, so the doublet serves the
float32 and the bfloat16 (sloppy) storage alike; the flavour mixing and
the closed-form inverses are plain PyTorch.
"""

from __future__ import annotations

import torch

from ..fields.geometry import EVEN, LatticeGeometry
from ..fields.spinor import even_odd_split
from ..ops import wilson as wops
from ..ops import wilson_packed as wpk
from ..ops.boundary import apply_t_boundary
from ..ops.clover import apply_clover, clover_blocks
from .clover import (DiracCloverPackedPairs, apply_clover_pairs,
                     pack_clover_pairs)
from .dirac import MATPC_EVEN_EVEN, Dirac, DiracPC, apply_gamma5
from .wilson import (DiracWilsonPackedPairs, _g5_sign, _PairSloppyBase,
                     _SchurPairOpBase)


def _twist_apply(psi, a: float, sign: int = +1):
    """(1 + i sign a gamma5) psi."""
    return psi + (1j * sign * a) * apply_gamma5(psi)


def _twist_inv(psi, a: float, sign: int = +1):
    """(1 + i sign a gamma5)^{-1} psi = (1 - i sign a gamma5)/(1+a^2) psi."""
    return (psi - (1j * sign * a) * apply_gamma5(psi)) / (1.0 + a * a)


class DiracTwistedMass(Dirac):
    """Degenerate twisted-mass operator on the full lattice."""

    g5_hermitian = False

    def __init__(self, gauge: torch.Tensor, geom: LatticeGeometry,
                 kappa: float, mu: float, antiperiodic_t: bool = True):
        self.geom = geom
        self.kappa = kappa
        self.mu = mu
        self.a = 2.0 * kappa * mu
        self.gauge = apply_t_boundary(gauge, geom, -1 if antiperiodic_t else 1)
        self.antiperiodic_t = antiperiodic_t

    def D(self, psi):
        return wops.dslash_full(self.gauge, psi)

    def M(self, psi):
        return _twist_apply(psi, self.a) - self.kappa * self.D(psi)

    def Mdag(self, psi):
        # gamma5 M(mu) gamma5 = M(-mu)^dag  =>  Mdag = g5 M(-mu) g5
        return _twist_apply(psi, self.a, -1) - self.kappa * apply_gamma5(
            self.D(apply_gamma5(psi)))

    def flops_per_site_M(self) -> int:
        return 1320 + 96  # dslash + twist scale + axpy

    def pairs(self, store_dtype=torch.float32,
              precision_form: str = "full") -> "DiracTwistedMassPackedPairs":
        """Pair companion on the full packed lattice, every M one launch
        of B4 plus the twist: float32 (full or recon-12 links) or float64
        (full)."""
        return DiracTwistedMassPackedPairs(self, store_dtype, precision_form)


class DiracTwistedMassPC(DiracPC):
    """Even/odd preconditioned degenerate twisted mass.

    M_pc x = (1 + i a g5) x - kappa^2 D (1 + i a g5)^{-1} D x
    """

    g5_hermitian = False

    def __init__(self, gauge: torch.Tensor, geom: LatticeGeometry,
                 kappa: float, mu: float, antiperiodic_t: bool = True,
                 matpc: int = MATPC_EVEN_EVEN):
        self.geom = geom
        self.kappa = kappa
        self.mu = mu
        self.a = 2.0 * kappa * mu
        self.matpc = matpc
        g = apply_t_boundary(gauge, geom, -1 if antiperiodic_t else 1)
        self.antiperiodic_t = antiperiodic_t
        self.gauge_eo = wops.split_gauge_eo(g, geom)

    def D_to(self, psi, target_parity):
        return wops.dslash_eo(self.gauge_eo, psi, self.geom, target_parity)

    def _M_sign(self, x_p, sign):
        p = self.matpc
        tmp = _twist_inv(self.D_to(x_p, 1 - p), self.a, sign)
        return (_twist_apply(x_p, self.a, sign)
                - (self.kappa ** 2) * self.D_to(tmp, p))

    def M(self, x_p):
        return self._M_sign(x_p, +1)

    def Mdag(self, x_p):
        return apply_gamma5(self._M_sign(apply_gamma5(x_p), -1))

    def prepare(self, b_even, b_odd):
        p = self.matpc
        b_p, b_q = (b_even, b_odd) if p == EVEN else (b_odd, b_even)
        return b_p + self.kappa * self.D_to(_twist_inv(b_q, self.a), p)

    def reconstruct(self, x_p, b_even, b_odd):
        p = self.matpc
        b_q = b_odd if p == EVEN else b_even
        x_q = _twist_inv(b_q + self.kappa * self.D_to(x_p, 1 - p), self.a)
        return (x_p, x_q) if p == EVEN else (x_q, x_p)

    def flops_per_site_M(self) -> int:
        return 2 * 1320 + 192  # two hops + twist apply/inverse + axpy

    def pairs(self, store_dtype=torch.float32,
              precision_form: str = "full") -> "DiracTwistedMassPCPairs":
        """Pair companion on the fused hop's block-free twist forms:
        float32 (the precise operator) or bfloat16 (the sloppy one),
        full or recon-12 links."""
        return DiracTwistedMassPCPairs(self, store_dtype, precision_form)


def _ig5_rot_pairs(x_pp: torch.Tensor, c: float,
                   dtype=torch.float32) -> torch.Tensor:
    """i c gamma5 on packed pair arrays (..., 4, 3, 2, T, Z, YXh) in
    ``dtype`` (f32 unless asked): i*gamma5 rotates (re,im) -> (-g5*im,
    g5*re) with g5 = (+,+,-,-).  Leading (flavour or right-hand-side)
    axes broadcast."""
    f = x_pp.to(dtype)
    g5c = _g5_sign(f.device, 5, 0).to(dtype) * c  # (4,1,1,1,1): +-c/spin
    xr, xi = f.unbind(-4)
    return torch.stack([-g5c * xi, g5c * xr], dim=-4)


def _twist_pairs(x_pp: torch.Tensor, a: float, sign: int,
                 out_dtype=None) -> torch.Tensor:
    """(1 + i sign a gamma5) on packed pair arrays."""
    out = x_pp.to(torch.float32) + _ig5_rot_pairs(x_pp, sign * a)
    return out.to(out_dtype or x_pp.dtype)


def _twist_inv_pairs(x_pp: torch.Tensor, a: float, sign: int,
                     out_dtype=None) -> torch.Tensor:
    """(1 + i sign a gamma5)^{-1} on packed pair arrays (the staged form:
    a division by 1 + a^2, where the fused K1 multiplies by its
    reciprocal)."""
    inv = _twist_pairs(x_pp, a, -sign, out_dtype=torch.float32)
    return (inv / (1.0 + a * a)).to(out_dtype or x_pp.dtype)


class DiracTwistedMassPackedPairs(DiracWilsonPackedPairs):
    """Pair companion of the full-lattice twisted-mass operator
    M = (1 + i a g5) - kappa D on the packed layout: B4 for the hop
    (``DiracWilsonPackedPairs``' links and backward copy), the twist in the
    storage's precision.  Mdag = g5 M(-a) g5, so M, Mdag and each half of
    MdagM are one B4 launch each."""

    def __init__(self, dtm: DiracTwistedMass, store_dtype=torch.float32,
                 precision_form: str = "full"):
        super().__init__(dtm, store_dtype, precision_form)
        self.a = float(dtm.a)

    def _M_sign(self, x, sign):
        cdt = wpk.compute_dtype(x.dtype)
        tw = x.to(cdt) + _ig5_rot_pairs(x, sign * self.a, cdt)
        return (tw - self.kappa * self.D_pairs(x)).to(self.store_dtype)

    def M_pairs(self, x):
        return self._M_sign(x, +1)

    def Mdag_pairs(self, x):
        g5 = _PairSloppyBase._g5_on
        return g5(self._M_sign(g5(x, 0), -1), 0)


class DiracTwistedMassPCPairs(_SchurPairOpBase):
    """Pair-form DiracTwistedMassPC: the twist (1 + i a g5) is a (re,im)
    rotation per chirality.  The Schur operator runs K1/K2's block-free
    twist forms; prepare and reconstruct the staged inverse twist on B1
    (B5-eo for a batch).  Mdag = g5 M(-s) g5 is the twisted dagger."""

    def __init__(self, dpc: DiracTwistedMassPC, store_dtype=torch.float32,
                 precision_form: str = "full"):
        self._setup_hop(dpc.geom, wpk.pack_gauge_eo(dpc.gauge_eo),
                        store_dtype, tb_sign=dpc.antiperiodic_t,
                        precision_form=precision_form)
        self.kappa = float(dpc.kappa)
        self.a = float(dpc.a)
        self.matpc = dpc.matpc

    def _diag_sign_pairs(self, x, sign, out_dtype):
        return _twist_pairs(x, self.a, sign, out_dtype)

    def _Ainv_q_sign_pairs(self, x, sign, out_dtype):
        return _twist_inv_pairs(x, self.a, sign, out_dtype)

    # K1 applies (1 + i s a g5)^{-1} = (v + i(-s a) g5 v)/(1+a^2) after the
    # hop, K2 adds i (s a) g5 x to the original x (no blocks)
    def _fused_k1_params(self, sign):
        a = self.a
        return None, (-sign * a, 1.0 / (1.0 + a * a))

    def _fused_k2_params(self, sign):
        return None, sign * self.a


class DiracTwistedCloverPCPairs(_SchurPairOpBase):
    """Pair-form DiracTwistedCloverPC: the clover blocks A_p and the
    +-sign dense twisted inverses (A_q + i s a g5)^{-1} live as resident
    pair-form chiral blocks (models/clover.pack_clover_pairs, which reads
    them as general complex matrices)."""

    def __init__(self, dpc: "DiracTwistedCloverPC",
                 store_dtype=torch.float32, precision_form: str = "full"):
        self._setup_hop(dpc.geom, wpk.pack_gauge_eo(dpc.gauge_eo),
                        store_dtype, tb_sign=dpc.antiperiodic_t,
                        precision_form=precision_form)
        self.kappa = float(dpc.kappa)
        self.a = float(dpc.a)
        self.matpc = dpc.matpc
        self.clover_p_pp = pack_clover_pairs(dpc.clover[dpc.matpc],
                                             store_dtype)
        self.tw_inv_q_pp = {s: pack_clover_pairs(dpc.tw_inv_q[s], store_dtype)
                            for s in (+1, -1)}

    def _diag_sign_pairs(self, x, sign, out_dtype):
        # A + i s a g5: clover matvec plus the direct twist rotation
        out = (apply_clover_pairs(self.clover_p_pp, x, torch.float32)
               + _ig5_rot_pairs(x, sign * self.a))
        return out.to(out_dtype)

    def _Ainv_q_sign_pairs(self, x, sign, out_dtype):
        return apply_clover_pairs(self.tw_inv_q_pp[sign], x, out_dtype)

    # K1 = the dense (A_q + i s a g5)^{-1} blocks (the twist is folded into
    # them), K2 = A_p blocks plus the i (s a) g5 rotation of the original x
    def _fused_k1_params(self, sign):
        return self.tw_inv_q_pp[sign], None

    def _fused_k2_params(self, sign):
        return self.clover_p_pp, sign * self.a


class _NdegPairsBase(_SchurPairOpBase):
    """Flavour-doublet pair-form base: spinors (2, 4, 3, 2, T, Z, Y*Xh)
    with the flavour axis leading; the hop is B1 once per flavour, and
    gamma5 acts on spin axis 1.  models/formsel.fused_capable refuses
    the doublet, so the Schur operator is the base's staged composition
    (no fused form, as in the JAX package)."""

    _spin_axis = 1

    def _d_to(self, psi_pp, target_parity, out_dtype):
        hop = super()._d_to
        return torch.stack([hop(psi_pp[f].contiguous(), target_parity,
                                out_dtype) for f in (0, 1)])

    def _to_pairs(self, x):
        """Canonical (T,Z,Y,Xh,2,4,3) complex -> flavour-leading pairs."""
        return super()._to_pairs(x.movedim(-3, 0))

    def _from_pairs(self, x, dtype):
        return super()._from_pairs(x, dtype).movedim(0, -3)


class DiracNdegTwistedMassPCPairs(_NdegPairsBase):
    """Pair-form DiracNdegTwistedMassPC: the flavour 2x2 diagonal
    (1 + i a g5 tau3 - b tau1) and its closed-form inverse are (re,im)
    rotations plus a real flavour swap."""

    def __init__(self, dpc: "DiracNdegTwistedMassPC",
                 store_dtype=torch.float32, precision_form: str = "full"):
        self._setup_hop(dpc.geom, wpk.pack_gauge_eo(dpc.gauge_eo),
                        store_dtype, tb_sign=dpc.antiperiodic_t,
                        precision_form=precision_form)
        self.kappa = float(dpc.kappa)
        self.a = float(dpc.a)
        self.b = float(dpc.b)
        self.matpc = dpc.matpc

    def _diag_sign_pairs(self, x, sign, out_dtype):
        f = x.to(torch.float32)
        up, dn = f[0], f[1]
        out = torch.stack(
            [up + _ig5_rot_pairs(up, sign * self.a) - self.b * dn,
             dn + _ig5_rot_pairs(dn, -sign * self.a) - self.b * up])
        return out.to(out_dtype)

    def _Ainv_q_sign_pairs(self, x, sign, out_dtype):
        f = x.to(torch.float32)
        up, dn = f[0], f[1]
        det = 1.0 + self.a ** 2 - self.b ** 2
        out = torch.stack(
            [up + _ig5_rot_pairs(up, -sign * self.a) + self.b * dn,
             self.b * up + dn + _ig5_rot_pairs(dn, sign * self.a)]) / det
        return out.to(out_dtype)


class DiracNdegTwistedCloverPCPairs(_NdegPairsBase):
    """Pair-form DiracNdegTwistedCloverPC: the clover term and the
    commuting-6x6-block closed-form flavour inverse
    (A^2 + a^2 - b^2)^{-1} [[A - i s a g5, b], [b, A + i s a g5]] live as
    resident pair-form chiral blocks."""

    def __init__(self, dpc: "DiracNdegTwistedCloverPC",
                 store_dtype=torch.float32, precision_form: str = "full"):
        self._setup_hop(dpc.geom, wpk.pack_gauge_eo(dpc.gauge_eo),
                        store_dtype, tb_sign=dpc.antiperiodic_t,
                        precision_form=precision_form)
        self.kappa = float(dpc.kappa)
        self.a = float(dpc.a)
        self.b = float(dpc.b)
        self.matpc = dpc.matpc
        self.clover_p_pp = pack_clover_pairs(dpc.clover[dpc.matpc],
                                             store_dtype)
        self.clover_q_pp = pack_clover_pairs(dpc.clover[1 - dpc.matpc],
                                             store_dtype)
        self.dinv_q_pp = pack_clover_pairs(dpc.dinv_q, store_dtype)

    def _diag_sign_pairs(self, x, sign, out_dtype):
        f = x.to(torch.float32)
        up, dn = f[0], f[1]
        f32 = torch.float32
        out = torch.stack(
            [apply_clover_pairs(self.clover_p_pp, up, f32)
             + _ig5_rot_pairs(up, sign * self.a) - self.b * dn,
             apply_clover_pairs(self.clover_p_pp, dn, f32)
             + _ig5_rot_pairs(dn, -sign * self.a) - self.b * up])
        return out.to(out_dtype)

    def _Ainv_q_sign_pairs(self, x, sign, out_dtype):
        f = x.to(torch.float32)
        up, dn = f[0], f[1]
        f32 = torch.float32
        nu = (apply_clover_pairs(self.clover_q_pp, up, f32)
              + _ig5_rot_pairs(up, -sign * self.a) + self.b * dn)
        nd = (self.b * up + apply_clover_pairs(self.clover_q_pp, dn, f32)
              + _ig5_rot_pairs(dn, sign * self.a))
        out = torch.stack([apply_clover_pairs(self.dinv_q_pp, nu, f32),
                           apply_clover_pairs(self.dinv_q_pp, nd, f32)])
        return out.to(out_dtype)


def _flavour_hop(hop, psi):
    """``hop`` on each flavour plane of (..., 2, 4, 3) doublet fields."""
    return torch.stack([hop(psi[..., f, :, :]) for f in (0, 1)], dim=-3)


class DiracNdegTwistedMass(Dirac):
    """Non-degenerate twisted doublet; fields carry a flavour axis:
    (T,Z,Y,X, flavour=2, 4, 3).

    M = (1 + i a g5 tau3 - b tau1) - kappa D   (D flavour-diagonal).
    """

    g5_hermitian = False

    def __init__(self, gauge: torch.Tensor, geom: LatticeGeometry,
                 kappa: float, mu: float, epsilon: float,
                 antiperiodic_t: bool = True):
        self.geom = geom
        self.kappa = kappa
        self.a = 2.0 * kappa * mu
        self.b = 2.0 * kappa * epsilon
        self.gauge = apply_t_boundary(gauge, geom, -1 if antiperiodic_t else 1)
        self.antiperiodic_t = antiperiodic_t

    def D(self, psi):
        return _flavour_hop(lambda v: wops.dslash_full(self.gauge, v), psi)

    def _diag(self, psi, sign=+1):
        up = psi[..., 0, :, :]
        dn = psi[..., 1, :, :]
        up_out = up + (1j * sign * self.a) * apply_gamma5(up) - self.b * dn
        dn_out = dn - (1j * sign * self.a) * apply_gamma5(dn) - self.b * up
        return torch.stack([up_out, dn_out], dim=-3)

    def M(self, psi):
        return self._diag(psi) - self.kappa * self.D(psi)

    def Mdag(self, psi):
        d5 = apply_gamma5(self.D(apply_gamma5(psi)))
        return self._diag(psi, -1) - self.kappa * d5


class DiracTwistedClover(Dirac):
    """Twisted clover: M = (A + i a gamma5) - kappa D."""

    g5_hermitian = False

    def __init__(self, gauge: torch.Tensor, geom: LatticeGeometry,
                 kappa: float, mu: float, csw: float,
                 antiperiodic_t: bool = True):
        self.geom = geom
        self.kappa = kappa
        self.a = 2.0 * kappa * mu
        self.gauge = apply_t_boundary(gauge, geom, -1 if antiperiodic_t else 1)
        self.antiperiodic_t = antiperiodic_t
        self.clover = clover_blocks(gauge, kappa * csw / 2.0)

    def D(self, psi):
        return wops.dslash_full(self.gauge, psi)

    def _A_tw(self, psi, sign=+1):
        return apply_clover(self.clover, psi) + (
            1j * sign * self.a) * apply_gamma5(psi)

    def M(self, psi):
        return self._A_tw(psi) - self.kappa * self.D(psi)

    def Mdag(self, psi):
        return self._A_tw(psi, -1) - self.kappa * apply_gamma5(
            self.D(apply_gamma5(psi)))

    def flops_per_site_M(self) -> int:
        return 1320 + 504 + 96

    def pairs(self, store_dtype=torch.float32,
              precision_form: str = "full") -> DiracCloverPackedPairs:
        """Pair companion on the full packed lattice, every M one launch
        of the full-lattice clover operator with the twist a: float32,
        full or recon-12 links."""
        return DiracCloverPackedPairs(self, store_dtype, precision_form,
                                      diag_twist=self.a)


def twisted_clover_blocks(clover, a: float, sign: int = +1):
    """Chiral blocks of A + i sign a gamma5: gamma5 = +-1 per chirality."""
    eye = torch.eye(6, dtype=clover.dtype, device=clover.device)
    up = clover[..., 0, :, :] + (1j * sign * a) * eye
    dn = clover[..., 1, :, :] - (1j * sign * a) * eye
    return torch.stack([up, dn], dim=-3)


def _inv_c128(blocks: torch.Tensor) -> torch.Tensor:
    """Per-site general (not Hermitian) 6x6 inverse, computed in
    complex128 at set-up and returned in the blocks' dtype."""
    return torch.linalg.inv(blocks.to(torch.complex128)).to(blocks.dtype)


class DiracTwistedCloverPC(DiracPC):
    """Even/odd preconditioned twisted clover (asymmetric):
    M_pc = (A_p + i a g5) - kappa^2 D (A_q + i a g5)^{-1} D.

    The twisted diagonal is not Hermitian, so its inverse is the general
    6x6 inverse (``torch.linalg.inv``), not the clover term's Cholesky
    path."""

    g5_hermitian = False

    def __init__(self, gauge: torch.Tensor, geom: LatticeGeometry,
                 kappa: float, mu: float, csw: float,
                 antiperiodic_t: bool = True, matpc: int = MATPC_EVEN_EVEN):
        self.geom = geom
        self.kappa = kappa
        self.a = 2.0 * kappa * mu
        self.matpc = matpc
        g = apply_t_boundary(gauge, geom, -1 if antiperiodic_t else 1)
        self.antiperiodic_t = antiperiodic_t
        self.gauge_eo = wops.split_gauge_eo(g, geom)
        blocks = clover_blocks(gauge, kappa * csw / 2.0)
        self.clover = even_odd_split(blocks, geom)
        self._set_tw_inv()

    def _set_tw_inv(self):
        q = 1 - self.matpc
        self.tw_inv_q = {s: _inv_c128(twisted_clover_blocks(self.clover[q],
                                                            self.a, s))
                         for s in (+1, -1)}

    def D_to(self, psi, target_parity):
        return wops.dslash_eo(self.gauge_eo, psi, self.geom, target_parity)

    def _A_p(self, x, sign=+1):
        return apply_clover(self.clover[self.matpc], x) + (
            1j * sign * self.a) * apply_gamma5(x)

    def _Ainv_q(self, x, sign=+1):
        return apply_clover(self.tw_inv_q[sign], x)

    def _M_sign(self, x_p, sign):
        p = self.matpc
        tmp = self._Ainv_q(self.D_to(x_p, 1 - p), sign)
        return self._A_p(x_p, sign) - (self.kappa ** 2) * self.D_to(tmp, p)

    def M(self, x_p):
        return self._M_sign(x_p, +1)

    def Mdag(self, x_p):
        return apply_gamma5(self._M_sign(apply_gamma5(x_p), -1))

    def prepare(self, b_even, b_odd):
        p = self.matpc
        b_p, b_q = (b_even, b_odd) if p == EVEN else (b_odd, b_even)
        return b_p + self.kappa * self.D_to(self._Ainv_q(b_q), p)

    def reconstruct(self, x_p, b_even, b_odd):
        p = self.matpc
        b_q = b_odd if p == EVEN else b_even
        x_q = self._Ainv_q(b_q + self.kappa * self.D_to(x_p, 1 - p))
        return (x_p, x_q) if p == EVEN else (x_q, x_p)

    def flops_per_site_M(self) -> int:
        # as the JAX multi-source route counts it (quda_api.py:1549-1556)
        return 2 * 1320 + 2 * 504 + 48

    def pairs(self, store_dtype=torch.float32,
              precision_form: str = "full") -> DiracTwistedCloverPCPairs:
        """Pair companion on the fused hop: K1 on the twisted inverse
        blocks, K2 on the clover blocks with the twist."""
        return DiracTwistedCloverPCPairs(self, store_dtype, precision_form)


class DiracNdegTwistedClover(Dirac):
    """Non-degenerate twisted clover on flavour-doublet fields
    (T,Z,Y,X,2,4,3):  M = (A + i a g5 tau3 - b tau1) - kappa D."""

    g5_hermitian = False

    def __init__(self, gauge: torch.Tensor, geom: LatticeGeometry,
                 kappa: float, mu: float, epsilon: float, csw: float,
                 antiperiodic_t: bool = True):
        self.geom = geom
        self.kappa = kappa
        self.a = 2.0 * kappa * mu
        self.b = 2.0 * kappa * epsilon
        self.gauge = apply_t_boundary(gauge, geom, -1 if antiperiodic_t else 1)
        self.antiperiodic_t = antiperiodic_t
        self.clover = clover_blocks(gauge, kappa * csw / 2.0)

    def D(self, psi):
        return _flavour_hop(lambda v: wops.dslash_full(self.gauge, v), psi)

    def _diag(self, psi, sign=+1):
        up = psi[..., 0, :, :]
        dn = psi[..., 1, :, :]
        up_out = (apply_clover(self.clover, up)
                  + (1j * sign * self.a) * apply_gamma5(up) - self.b * dn)
        dn_out = (apply_clover(self.clover, dn)
                  - (1j * sign * self.a) * apply_gamma5(dn) - self.b * up)
        return torch.stack([up_out, dn_out], dim=-3)

    def M(self, psi):
        return self._diag(psi) - self.kappa * self.D(psi)

    def Mdag(self, psi):
        # M(mu)^dag = g5 M(-mu) g5 flavour-wise (A Hermitian, tau1 real)
        d5 = apply_gamma5(self.D(apply_gamma5(psi)))
        return self._diag(psi, -1) - self.kappa * d5

    def flops_per_site_M(self) -> int:
        return 2 * (1320 + 504) + 144  # per flavour: dslash + clover


class DiracNdegTwistedCloverPC(DiracPC):
    """Even/odd preconditioned non-degenerate twisted clover (asymmetric):

        M_pc = Diag_p - kappa^2 D Diag_q^{-1} D

    with Diag = A + i a g5 tau3 - b tau1.  A commutes with g5, so the
    flavour 2x2 inverse closes over commuting 6x6 blocks:

        Diag^{-1} = [[A_s - i s a, b], [b, A_s + i s a]] (A_s^2 + a^2 - b^2)^{-1}
    """

    g5_hermitian = False

    def __init__(self, gauge: torch.Tensor, geom: LatticeGeometry,
                 kappa: float, mu: float, epsilon: float, csw: float,
                 antiperiodic_t: bool = True, matpc: int = MATPC_EVEN_EVEN):
        self.geom = geom
        self.kappa = kappa
        self.a = 2.0 * kappa * mu
        self.b = 2.0 * kappa * epsilon
        self.matpc = matpc
        g = apply_t_boundary(gauge, geom, -1 if antiperiodic_t else 1)
        self.antiperiodic_t = antiperiodic_t
        self.gauge_eo = wops.split_gauge_eo(g, geom)
        blocks = clover_blocks(gauge, kappa * csw / 2.0)
        self.clover = even_odd_split(blocks, geom)
        aq = self.clover[1 - matpc]
        eye = torch.eye(6, dtype=aq.dtype, device=aq.device)
        self.dinv_q = _inv_c128(aq @ aq + (self.a ** 2 - self.b ** 2) * eye)

    def D_to(self, psi, target_parity):
        return _flavour_hop(lambda v: wops.dslash_eo(
            self.gauge_eo, v, self.geom, target_parity), psi)

    def _diag_p(self, x, sign=+1):
        up = x[..., 0, :, :]
        dn = x[..., 1, :, :]
        ap = self.clover[self.matpc]
        up_out = (apply_clover(ap, up)
                  + (1j * sign * self.a) * apply_gamma5(up) - self.b * dn)
        dn_out = (apply_clover(ap, dn)
                  - (1j * sign * self.a) * apply_gamma5(dn) - self.b * up)
        return torch.stack([up_out, dn_out], dim=-3)

    def _diag_inv_q(self, x, sign=+1):
        """Diag_q^{-1}(sign * a) on a flavour-doublet parity field."""
        aq = self.clover[1 - self.matpc]
        up = x[..., 0, :, :]
        dn = x[..., 1, :, :]
        nu = (apply_clover(aq, up)
              - (1j * sign * self.a) * apply_gamma5(up) + self.b * dn)
        nd = (self.b * up + apply_clover(aq, dn)
              + (1j * sign * self.a) * apply_gamma5(dn))
        return torch.stack([apply_clover(self.dinv_q, nu),
                            apply_clover(self.dinv_q, nd)], dim=-3)

    def _M_sign(self, x_p, sign):
        p = self.matpc
        tmp = self._diag_inv_q(self.D_to(x_p, 1 - p), sign)
        return self._diag_p(x_p, sign) - (self.kappa ** 2) * self.D_to(tmp, p)

    def M(self, x_p):
        return self._M_sign(x_p, +1)

    def Mdag(self, x_p):
        return apply_gamma5(self._M_sign(apply_gamma5(x_p), -1))

    def prepare(self, b_even, b_odd):
        p = self.matpc
        b_p, b_q = (b_even, b_odd) if p == EVEN else (b_odd, b_even)
        return b_p + self.kappa * self.D_to(self._diag_inv_q(b_q), p)

    def reconstruct(self, x_p, b_even, b_odd):
        p = self.matpc
        b_q = b_odd if p == EVEN else b_even
        x_q = self._diag_inv_q(b_q + self.kappa * self.D_to(x_p, 1 - p))
        return (x_p, x_q) if p == EVEN else (x_q, x_p)

    def flops_per_site_M(self) -> int:
        # the degenerate twisted-clover PC count, once per flavour
        return 2 * (2 * 1320 + 2 * 504 + 48)

    def pairs(self, store_dtype=torch.float32, precision_form: str = "full"
              ) -> DiracNdegTwistedCloverPCPairs:
        """Pair companion: the staged composition, B1 per flavour."""
        return DiracNdegTwistedCloverPCPairs(self, store_dtype,
                                             precision_form)


class DiracNdegTwistedMassPC(DiracPC):
    """Even/odd preconditioned non-degenerate twisted mass (asymmetric):
    the flavour-diagonal inverse is closed-form elementwise,

        Diag^{-1} = [[1 - i a g5, b], [b, 1 + i a g5]] / (1 + a^2 - b^2)
    """

    g5_hermitian = False

    def __init__(self, gauge: torch.Tensor, geom: LatticeGeometry,
                 kappa: float, mu: float, epsilon: float,
                 antiperiodic_t: bool = True, matpc: int = MATPC_EVEN_EVEN):
        self.geom = geom
        self.kappa = kappa
        self.a = 2.0 * kappa * mu
        self.b = 2.0 * kappa * epsilon
        self.matpc = matpc
        g = apply_t_boundary(gauge, geom, -1 if antiperiodic_t else 1)
        self.antiperiodic_t = antiperiodic_t
        self.gauge_eo = wops.split_gauge_eo(g, geom)

    def D_to(self, psi, target_parity):
        return _flavour_hop(lambda v: wops.dslash_eo(
            self.gauge_eo, v, self.geom, target_parity), psi)

    def _diag(self, x, sign=+1):
        up = x[..., 0, :, :]
        dn = x[..., 1, :, :]
        return torch.stack(
            [up + (1j * sign * self.a) * apply_gamma5(up) - self.b * dn,
             dn - (1j * sign * self.a) * apply_gamma5(dn) - self.b * up],
            dim=-3)

    def _diag_inv(self, x, sign=+1):
        up = x[..., 0, :, :]
        dn = x[..., 1, :, :]
        det = 1.0 + self.a ** 2 - self.b ** 2
        nu = up - (1j * sign * self.a) * apply_gamma5(up) + self.b * dn
        nd = self.b * up + dn + (1j * sign * self.a) * apply_gamma5(dn)
        return torch.stack([nu, nd], dim=-3) / det

    def _M_sign(self, x_p, sign):
        p = self.matpc
        tmp = self._diag_inv(self.D_to(x_p, 1 - p), sign)
        return self._diag(x_p, sign) - (self.kappa ** 2) * self.D_to(tmp, p)

    def M(self, x_p):
        return self._M_sign(x_p, +1)

    def Mdag(self, x_p):
        return apply_gamma5(self._M_sign(apply_gamma5(x_p), -1))

    def prepare(self, b_even, b_odd):
        p = self.matpc
        b_p, b_q = (b_even, b_odd) if p == EVEN else (b_odd, b_even)
        return b_p + self.kappa * self.D_to(self._diag_inv(b_q), p)

    def reconstruct(self, x_p, b_even, b_odd):
        p = self.matpc
        b_q = b_odd if p == EVEN else b_even
        x_q = self._diag_inv(b_q + self.kappa * self.D_to(x_p, 1 - p))
        return (x_p, x_q) if p == EVEN else (x_q, x_p)

    def flops_per_site_M(self) -> int:
        return 2 * (2 * 1320) + 384  # two flavour hops each parity + twist

    def pairs(self, store_dtype=torch.float32, precision_form: str = "full"
              ) -> DiracNdegTwistedMassPCPairs:
        """Pair companion: the staged composition, B1 per flavour."""
        return DiracNdegTwistedMassPCPairs(self, store_dtype, precision_form)
