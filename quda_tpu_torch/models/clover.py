"""Wilson-clover Dirac operator (full and even/odd preconditioned).

Port of quda_tpu/models/clover.py.  Conventions:

    A(x) = 1 + (kappa * csw / 2) * sum_{mu<nu} sigma_{mu nu} F_{mu nu}(x)
    M = A - kappa * D

so csw=0 reduces exactly to Wilson.  PC operator on parity p:

    M_pc x = A_p x - kappa^2 D_{p q} A_q^{-1} D_{q p} x     (q = 1-p)
    prepare:      b_pc = b_p + kappa * D_{p q} A_q^{-1} b_q
    reconstruct:  x_q  = A_q^{-1} (b_q + kappa * D_{q p} x_p)

As in the JAX package, F_munu uses the PHYSICAL links: the clover term is
built before the t boundary phase is applied.  The pair companion
(``DiracCloverPCPairs``) runs each apply of M as two launches of the
fused clover hop (ops/clover_pallas, K1 and K2).  The full-lattice pair
companion (``DiracCloverPackedPairs``, ``DiracClover.pairs``: the
operator API's ``mat_quda`` and ``mat_dag_mat_quda``) runs each M as one
launch of the full-lattice clover operator (``clover_pallas_packed``).
"""

from __future__ import annotations

import torch

from ..fields.geometry import EVEN, LatticeGeometry
from ..fields.spinor import even_odd_split
from ..ops import wilson as wops
from ..ops import wilson_packed as wpk
from ..ops.boundary import apply_t_boundary
from ..ops.clover import apply_clover, clover_blocks, invert_clover
from .dirac import MATPC_EVEN_EVEN, Dirac, DiracPC
from .wilson import DiracWilsonPackedPairs, _PairSloppyBase, _SchurPairOpBase


class DiracClover(Dirac):
    """Full-lattice Wilson-clover operator M = A - kappa D."""

    def __init__(self, gauge: torch.Tensor, geom: LatticeGeometry,
                 kappa: float, csw: float, antiperiodic_t: bool = True):
        self.geom = geom
        self.kappa = kappa
        self.csw = csw
        self.gauge = apply_t_boundary(gauge, geom, -1 if antiperiodic_t else 1)
        self.antiperiodic_t = antiperiodic_t
        self.clover = clover_blocks(gauge, kappa * csw / 2.0)

    def D(self, psi):
        return wops.dslash_full(self.gauge, psi)

    def A(self, psi):
        return apply_clover(self.clover, psi)

    def M(self, psi):
        return self.A(psi) - self.kappa * self.D(psi)

    def flops_per_site_M(self) -> int:
        return 1320 + 504 + 48  # dslash + clover (2x 6x6 matvec) + axpy

    def pairs(self, store_dtype=torch.float32,
              precision_form: str = "full") -> "DiracCloverPackedPairs":
        """Pair companion on the full packed lattice, every M one launch
        of the full-lattice clover operator: float32, full or recon-12
        links."""
        return DiracCloverPackedPairs(self, store_dtype, precision_form)


class DiracCloverPC(DiracPC):
    """Asymmetric even/odd preconditioned clover operator."""

    def __init__(self, gauge: torch.Tensor, geom: LatticeGeometry,
                 kappa: float, csw: float, antiperiodic_t: bool = True,
                 matpc: int = MATPC_EVEN_EVEN):
        self.geom = geom
        self.kappa = kappa
        self.csw = csw
        self.matpc = matpc
        g = apply_t_boundary(gauge, geom, -1 if antiperiodic_t else 1)
        self.antiperiodic_t = antiperiodic_t
        self.gauge_eo = wops.split_gauge_eo(g, geom)
        blocks = clover_blocks(gauge, kappa * csw / 2.0)
        self.clover = even_odd_split(blocks, geom)
        self.clover_inv_q = invert_clover(self.clover[1 - matpc])

    def D_to(self, psi, target_parity):
        return wops.dslash_eo(self.gauge_eo, psi, self.geom, target_parity)

    def A_p(self, x):
        return apply_clover(self.clover[self.matpc], x)

    def Ainv_q(self, x):
        return apply_clover(self.clover_inv_q, x)

    def M(self, x_p):
        p = self.matpc
        tmp = self.Ainv_q(self.D_to(x_p, 1 - p))
        return self.A_p(x_p) - (self.kappa ** 2) * self.D_to(tmp, p)

    def prepare(self, b_even, b_odd):
        p = self.matpc
        b_p, b_q = (b_even, b_odd) if p == EVEN else (b_odd, b_even)
        return b_p + self.kappa * self.D_to(self.Ainv_q(b_q), p)

    def reconstruct(self, x_p, b_even, b_odd):
        p = self.matpc
        b_q = b_odd if p == EVEN else b_even
        x_q = self.Ainv_q(b_q + self.kappa * self.D_to(x_p, 1 - p))
        return (x_p, x_q) if p == EVEN else (x_q, x_p)

    def flops_per_site_M(self) -> int:
        return 2 * 1320 + 2 * 504 + 48

    def pairs(self, store_dtype=torch.float32,
              precision_form: str = "full") -> "DiracCloverPCPairs":
        """Pair-storage companion on the packed layout: float32 is the
        precise operator, bfloat16 the sloppy one of mixed solves.
        ``precision_form``: "full" or "r12" links."""
        return DiracCloverPCPairs(self, store_dtype, precision_form)


def pack_clover_pairs(blocks: torch.Tensor, store_dtype) -> torch.Tensor:
    """Chiral 6x6 blocks (T,Z,Y,Xh,2,6,6) -> packed pairs
    (2,6,6,2,T,Z,Y*Xh): block indices leading, re/im split, fused minor
    site axes — the clover analog of wilson_packed.pack_gauge."""
    T, Z, Y, Xh = blocks.shape[:4]
    packed = blocks.permute(4, 5, 6, 0, 1, 2, 3).reshape(2, 6, 6, T, Z,
                                                         Y * Xh)
    return wpk.to_packed_pairs(packed, store_dtype).contiguous()


def apply_clover_pairs(blk_pp: torch.Tensor, x_pp: torch.Tensor,
                       out_dtype=None) -> torch.Tensor:
    """A psi on pair arrays: blk_pp (2,6,6,2,T,Z,YXh), x_pp
    (4,3,2,T,Z,YXh), or (N,4,3,2,T,Z,YXh) with a leading RHS axis, which
    moves beside the site axes so the blocks broadcast over it.  The (4,3)
    spin-color axes reshape to (2,6) chirality blocks (spins 0,1 ->
    chirality 0 in DeGrand-Rossi); complex matvec as four real einsums in
    float32."""
    odt = out_dtype or x_pp.dtype
    f = x_pp.to(torch.float32)
    batched = f.ndim == 7
    if batched:
        f = f.movedim(0, 3)                          # (4,3,2,N,T,Z,YXh)
    chi = f.reshape((2, 6) + tuple(f.shape[2:]))     # (2,6,2,[N],T,Z,YXh)
    ar = blk_pp[:, :, :, 0].to(torch.float32)        # (2,6,6,T,Z,YXh)
    ai = blk_pp[:, :, :, 1].to(torch.float32)
    xr, xi = chi[:, :, 0], chi[:, :, 1]              # (2,6,[N],T,Z,YXh)
    outr = (torch.einsum("cij...,cj...->ci...", ar, xr)
            - torch.einsum("cij...,cj...->ci...", ai, xi))
    outi = (torch.einsum("cij...,cj...->ci...", ar, xi)
            + torch.einsum("cij...,cj...->ci...", ai, xr))
    out = torch.stack([outr, outi], dim=2)           # (2,6,2,[N],T,Z,YXh)
    out = out.reshape((4, 3) + tuple(out.shape[2:]))
    if batched:
        out = out.movedim(3, 0).contiguous()
    return out.reshape(x_pp.shape).to(odt)


class DiracCloverPCPairs(_SchurPairOpBase):
    """Pair-form packed DiracCloverPC: the precise clover operator of the
    solve (float32) and the sloppy one of mixed solves (bfloat16), with
    full or recon-12 links.  The hop, Schur composition, prepare and
    reconstruct are _SchurPairOpBase's; this class supplies the clover
    term A_p and its opposite-parity inverse as resident pair-form chiral
    blocks.  The PC operator is gamma5-hermitian, so the sign argument is
    ignored."""

    def __init__(self, dpc: DiracCloverPC, store_dtype=torch.float32,
                 precision_form: str = "full"):
        self._setup_hop(dpc.geom, wpk.pack_gauge_eo(dpc.gauge_eo),
                        store_dtype, tb_sign=dpc.antiperiodic_t,
                        precision_form=precision_form)
        self.kappa = float(dpc.kappa)
        self.matpc = dpc.matpc
        self.clover_p_pp = pack_clover_pairs(dpc.clover[dpc.matpc],
                                             store_dtype)
        self.clover_inv_q_pp = pack_clover_pairs(dpc.clover_inv_q,
                                                 store_dtype)

    def _Ainv_q_sign_pairs(self, x, sign, out_dtype):
        return apply_clover_pairs(self.clover_inv_q_pp, x, out_dtype)

    # K1 = Ainv_q blocks after the hop, K2 = A_p blocks on the original x;
    # both sign-independent (the clover PC operator is g5-hermitian)
    def _fused_k1_params(self, sign):
        return self.clover_inv_q_pp, None

    def _fused_k2_params(self, sign):
        return self.clover_p_pp, None


class DiracCloverPackedPairs(DiracWilsonPackedPairs):
    """Pair companion of the full-lattice clover operator M = A - kappa D
    (and, with ``diag_twist=a``, the twisted clover M = A + i a g5 -
    kappa D) on the packed layout: the full-lattice twin of
    ``DiracWilsonPackedPairs``, whose links, backward copy, layout
    conversions and hop ``D`` (B4) it shares, with the blocks of A
    (``pack_clover_pairs`` on the full lattice) beside them.  Every M is
    one launch of ``clover_pallas_packed``; Mdag = g5 M(-a) g5 another
    (a = 0 without the twist: the clover operator is g5-hermitian).
    float32 only."""

    def __init__(self, dc, store_dtype=torch.float32,
                 precision_form: str = "full", diag_twist=None):
        if store_dtype != torch.float32:
            raise NotImplementedError(
                f"pair storage {store_dtype}: the full-lattice clover "
                "operator has float32 forms only (ROADMAP A7)")
        super().__init__(dc, store_dtype, precision_form)
        self.blk_pl = pack_clover_pairs(dc.clover, store_dtype)
        self.diag_twist = None if diag_twist is None else float(diag_twist)

    def _M_twist(self, x, c):
        from ..ops.clover_pallas import clover_pallas_packed
        return clover_pallas_packed(self.gauge_pl, self.blk_pl, x,
                                    self.dims[3], self.kappa, diag_twist=c,
                                    gauge_bw=self.gauge_bw,
                                    tb_sign=self._tb_sign)

    def M_pairs(self, x):
        return self._M_twist(x, self.diag_twist)

    def Mdag_pairs(self, x):
        g5 = _PairSloppyBase._g5_on
        c = None if self.diag_twist is None else -self.diag_twist
        return g5(self._M_twist(g5(x, 0), c), 0)
