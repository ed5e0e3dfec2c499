"""Domain-wall (Shamir) and Möbius Dirac operators, full, 4d- and
5d-even/odd preconditioned, and Möbius EOFA.

Port of quda_tpu/models/domain_wall.py.  Formulation (b5, c5 Möbius
parameters; Shamir is b5=1, c5=0):

    M psi = D_W (b5 psi + c5 chi) + psi - chi
          = M5 psi - 1/2 hop( M5' psi )

with chi(s) the P-+ s-hop with -mf boundary (ops/dwf.py), D_W the 4-d
Wilson operator at mass -M5 (diagonal 4 - M5 folded in), and

    M5  = [alpha = b5 (4 - M5) + 1,  beta = c5 (4 - M5) - 1]
    M5' = [alpha = b5,               beta = c5]

4d-PC (symmetric) Schur system on parity p:

    M_pc = 1 - 1/4 M5i hop_pq M5" hop_qp M5'       (M5" = M5' M5^{-1})
    prepare:      b' = M5i b_p + 1/2 M5i hop_pq M5" b_q
    reconstruct:  x_q = M5i (b_q + 1/2 hop_qp M5' x_p)

where all s-operators are dense (Ls,Ls) chirality blocks (ops/dwf.py) and
hop is the parity-changing 4-d Wilson hop applied per s-slice.  Adjoints
of the s-operators are conj-transposes and hop^dag = gamma5 hop gamma5.

The pair companions (``DiracMobiusPCPairs``, EOFA included, and
``DiracDomainWall5DPCPairs``) carry 5d fields as (Ls, 4, 3, 2, T, Z,
Y*Xh) float32 pairs and run the 4d hop of every s plane in one launch of
the multi-RHS eo hop B5-eo with Ls as the batch (ops/dwf_pallas); the 5d
checkerboard hops its two parity groups of s planes, one launch each.
No single-RHS hop runs per s plane.  The (Ls, Ls) algebra is plain
PyTorch.  B5-eo has float32 forms only, so these operators are float32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields.geometry import EVEN, LatticeGeometry
from ..fields.spinor import even_odd_join, even_odd_split
from ..ops import dwf_pallas as dwp
from ..ops import wilson as wops
from ..ops import wilson_packed as wpk
from ..ops.boundary import apply_t_boundary
from ..ops.dwf import SOp, apply_sop, m5_sop
from .dirac import MATPC_EVEN_EVEN, Dirac, DiracPC, apply_gamma5
from .wilson import _PackedHopMixin, _PairSloppyBase


def _per_slice(fn, psi5):
    """``fn`` on each s slice of a 5d field (Ls, ...)."""
    return torch.stack([fn(v) for v in psi5])


class DiracMobius(Dirac):
    """Full (unpreconditioned) Möbius operator on (Ls,T,Z,Y,X,4,3) fields."""

    g5_hermitian = False  # Gamma5 = gamma5 * R (s-reflection) instead

    def __init__(self, gauge: torch.Tensor, geom: LatticeGeometry, ls: int,
                 m5: float, mf: float, b5: float = 1.0, c5: float = 0.0,
                 antiperiodic_t: bool = True):
        self.geom = geom
        self.ls = ls
        self.m5 = m5
        self.mf = mf
        self.b5 = b5
        self.c5 = c5
        self.gauge = apply_t_boundary(gauge, geom, -1 if antiperiodic_t else 1)
        self.antiperiodic_t = antiperiodic_t
        dw_diag = 4.0 - m5
        self.s_m5 = m5_sop(ls, b5 * dw_diag + 1.0, c5 * dw_diag - 1.0, mf)
        self.s_m5p = m5_sop(ls, b5, c5, mf)

    def _hop(self, psi):
        """The 4-d Wilson hop on every s slice."""
        return _per_slice(lambda v: wops.dslash_full(self.gauge, v), psi)

    def M(self, psi):
        return apply_sop(self.s_m5, psi) - 0.5 * self._hop(
            apply_sop(self.s_m5p, psi))

    def Mdag(self, psi):
        # M^dag = M5^dag - 1/2 M5'^dag hop^dag;  hop^dag = g5 hop g5
        hop_dag = apply_gamma5(self._hop(apply_gamma5(psi)))
        return (apply_sop(self.s_m5.adj(), psi)
                - 0.5 * apply_sop(self.s_m5p.adj(), hop_dag))

    def flops_per_site_M(self) -> int:
        # per (s, 4d-site): Wilson hop + two dense (Ls,Ls) s-contractions
        return 1320 + 2 * 96 * self.ls


class DiracDomainWall(DiracMobius):
    """Shamir domain wall: Möbius with b5=1, c5=0."""

    def __init__(self, gauge, geom, ls, m5, mf, antiperiodic_t=True):
        super().__init__(gauge, geom, ls, m5, mf, 1.0, 0.0, antiperiodic_t)


def _check_store(store_dtype):
    if store_dtype != torch.float32:
        raise NotImplementedError(
            f"pair storage {store_dtype}: the domain-wall operators run "
            "their 4d hop on B5-eo, whose bf16 forms wait for ROADMAP B5 "
            "(A7); they are float32")


class DiracMobiusPC(DiracPC):
    """Symmetric 4d-even/odd preconditioned Möbius operator."""

    g5_hermitian = False

    def __init__(self, gauge: torch.Tensor, geom: LatticeGeometry, ls: int,
                 m5: float, mf: float, b5: float = 1.0, c5: float = 0.0,
                 antiperiodic_t: bool = True, matpc: int = MATPC_EVEN_EVEN):
        self.geom = geom
        self.ls = ls
        self.mf = mf
        self.matpc = matpc
        g = apply_t_boundary(gauge, geom, -1 if antiperiodic_t else 1)
        self.antiperiodic_t = antiperiodic_t
        self.gauge_eo = wops.split_gauge_eo(g, geom)
        dw_diag = 4.0 - m5
        self.s_m5 = m5_sop(ls, b5 * dw_diag + 1.0, c5 * dw_diag - 1.0, mf)
        self.s_m5p = m5_sop(ls, b5, c5, mf)
        self._set_inverses()

    def _set_inverses(self):
        self.s_m5i = self.s_m5.inv()
        self.s_mix = self.s_m5p @ self.s_m5i   # M5" = M5' M5^{-1} (commute)

    def _hop_to(self, psi, target_parity):
        return _per_slice(lambda v: wops.dslash_eo(
            self.gauge_eo, v, self.geom, target_parity), psi)

    def _hop_to_dag(self, psi, target_parity):
        return apply_gamma5(self._hop_to(apply_gamma5(psi), target_parity))

    # M_pc = 1 - 1/4 M5i . hop_to(.,p) . M5" . hop_to(.,1-p) . M5'
    def M(self, x_p):
        p = self.matpc
        t = self._hop_to(apply_sop(self.s_m5p, x_p), 1 - p)
        t = self._hop_to(apply_sop(self.s_mix, t), p)
        return x_p - 0.25 * apply_sop(self.s_m5i, t)

    def Mdag(self, x_p):
        p = self.matpc
        t = apply_sop(self.s_m5i.adj(), x_p)
        t = apply_sop(self.s_mix.adj(), self._hop_to_dag(t, 1 - p))
        t = apply_sop(self.s_m5p.adj(), self._hop_to_dag(t, p))
        return x_p - 0.25 * t

    def prepare(self, b_even, b_odd):
        p = self.matpc
        b_p, b_q = (b_even, b_odd) if p == EVEN else (b_odd, b_even)
        t = self._hop_to(apply_sop(self.s_mix, b_q), p)
        return apply_sop(self.s_m5i, b_p + 0.5 * t)

    def reconstruct(self, x_p, b_even, b_odd):
        p = self.matpc
        b_q = b_odd if p == EVEN else b_even
        t = self._hop_to(apply_sop(self.s_m5p, x_p), 1 - p)
        x_q = apply_sop(self.s_m5i, b_q + 0.5 * t)
        return (x_p, x_q) if p == EVEN else (x_q, x_p)

    def flops_per_site_M(self) -> int:
        return 2 * 1320 + 3 * 96 * self.ls

    def pairs(self, store_dtype=torch.float32,
              precision_form: str = "full") -> "DiracMobiusPCPairs":
        """Pair companion (EOFA included, whose corrected s-blocks it
        reads), the 4d hop on B5-eo with N = Ls; float32, full or
        recon-12 links."""
        return DiracMobiusPCPairs(self, store_dtype, precision_form)


def _real_blocks(sop: SOp, device):
    ap, am = np.asarray(sop.ap), np.asarray(sop.am)
    if not (np.allclose(np.imag(ap), 0) and np.allclose(np.imag(am), 0)):
        raise ValueError("pair-form s-operators need real chirality blocks")
    return (torch.as_tensor(np.real(ap), dtype=torch.float32, device=device),
            torch.as_tensor(np.real(am), dtype=torch.float32, device=device))


class _LsPairOps(_PackedHopMixin):
    """What the Möbius and 5d-PC pair operators share: gamma5 on
    Ls-leading pair fields (Ls, 4, 3, 2, T, Z, Y*Xh), and the complex
    wrappers over their pair forms (the mixin's converters keep the
    leading Ls axis in front)."""

    hermitian = False

    def _g5(self, x):
        return _PairSloppyBase._g5_on(x, 1)

    def MdagM_pairs(self, x):
        return self.Mdag_pairs(self.M_pairs(x))

    def _on_complex(self, fn, x):
        return self._from_pairs(fn(self._to_pairs(x)), x.dtype)

    def M(self, x):
        return self._on_complex(self.M_pairs, x)

    def Mdag(self, x):
        return self._on_complex(self.Mdag_pairs, x)

    def MdagM(self, x):
        return self._on_complex(self.MdagM_pairs, x)


class DiracMobiusPCPairs(_LsPairOps):
    """Pair-form DiracMobiusPC (incl. EOFA): spinors (Ls, 4, 3, 2, T, Z,
    Y*Xh) float32, per-parity links (4, R, 3, 2, T, Z, Y*Xh).  The 4d hop
    of all Ls planes is one B5-eo launch (ops/dwf_pallas); the
    s-operators are the real dense (Ls, Ls) chirality blocks of
    ops/dwf.py applied as float32 einsums."""

    def __init__(self, dpc: DiracMobiusPC, store_dtype=torch.float32,
                 precision_form: str = "full"):
        _check_store(store_dtype)
        self._setup_hop(dpc.geom, wpk.pack_gauge_eo(dpc.gauge_eo),
                        store_dtype, tb_sign=dpc.antiperiodic_t,
                        precision_form=precision_form)
        self.ls = dpc.ls
        self.matpc = dpc.matpc
        dev = self.gauge_eo_pp[0].device
        self._m5p = _real_blocks(dpc.s_m5p, dev)
        self._mix = _real_blocks(dpc.s_mix, dev)
        self._m5i = _real_blocks(dpc.s_m5i, dev)

    def _apply_blocks(self, blk, x, adjoint=False, out_dtype=None):
        """Real (Ls,Ls) chirality blocks on (Ls,4,3,2,T,Z,YXh): spins 0,1
        through ap, spins 2,3 through am."""
        ap, am = blk
        if adjoint:
            ap, am = ap.T, am.T
        f = x.to(torch.float32)
        up = torch.einsum("st,t...->s...", ap, f[:, :2])
        dn = torch.einsum("st,t...->s...", am, f[:, 2:])
        return torch.cat([up, dn], dim=1).to(out_dtype or self.store_dtype)

    def _hop_to_pairs(self, x, target_parity, out_dtype=None):
        """The 4d hop on every s plane: one B5-eo launch, N = Ls."""
        return dwp.dslash_eo_pallas_packed_ls(
            self.gauge_eo_pp[target_parity], self._u_bw[target_parity], x,
            self.dims, target_parity, out_dtype=out_dtype or self.store_dtype,
            tb_sign=self._tb_sign)

    def _hop_to_dag_pairs(self, x, target_parity, out_dtype=None):
        return self._g5(self._hop_to_pairs(self._g5(x), target_parity,
                                           out_dtype))

    def M_pairs(self, x):
        p = self.matpc
        f32 = torch.float32
        t = self._hop_to_pairs(self._apply_blocks(self._m5p, x), 1 - p)
        t = self._hop_to_pairs(self._apply_blocks(self._mix, t), p,
                               out_dtype=f32)
        out = (x.to(f32)
               - 0.25 * self._apply_blocks(self._m5i, t, out_dtype=f32))
        return out.to(self.store_dtype)

    def Mdag_pairs(self, x):
        p = self.matpc
        t = self._apply_blocks(self._m5i, x, adjoint=True)
        t = self._apply_blocks(self._mix, self._hop_to_dag_pairs(t, 1 - p),
                               adjoint=True)
        t = self._apply_blocks(self._m5p, self._hop_to_dag_pairs(t, p),
                               adjoint=True, out_dtype=torch.float32)
        out = x.to(torch.float32) - 0.25 * t
        return out.to(self.store_dtype)

    def prepare_pairs(self, b_even, b_odd):
        """Canonical complex parity-split 5d sources (Ls,T,Z,Y,Xh,4,3) ->
        pair-form PC rhs (mirrors DiracMobiusPC.prepare)."""
        p = self.matpc
        f32 = torch.float32
        b_p, b_q = (b_even, b_odd) if p == EVEN else (b_odd, b_even)
        bp_pp, bq_pp = self._to_pairs(b_p), self._to_pairs(b_q)
        t = self._hop_to_pairs(self._apply_blocks(self._mix, bq_pp), p,
                               out_dtype=f32)
        rhs = self._apply_blocks(self._m5i, bp_pp.to(f32) + 0.5 * t,
                                 out_dtype=f32)
        return rhs.to(self.store_dtype)

    def reconstruct_pairs(self, x_pp, b_even, b_odd):
        """Pair-form PC solution -> canonical complex (x_even, x_odd)."""
        p = self.matpc
        f32 = torch.float32
        b_q = b_odd if p == EVEN else b_even
        t = self._hop_to_pairs(self._apply_blocks(self._m5p, x_pp), 1 - p,
                               out_dtype=f32)
        xq_pp = self._apply_blocks(
            self._m5i, self._to_pairs(b_q).to(f32) + 0.5 * t, out_dtype=f32)
        x_p = self._from_pairs(x_pp, b_q.dtype)
        x_q = self._from_pairs(xq_pp, b_q.dtype)
        return (x_p, x_q) if p == EVEN else (x_q, x_p)


# ---------------------------------------------------------------------------
# Möbius EOFA (exact one-flavor algorithm)
# ---------------------------------------------------------------------------

def eofa_rank_one(ls: int, b5: float, c5: float, m5: float,
                  mq1: float, mq2: float, mq3: float, eofa_pm: bool,
                  eofa_shift: float) -> np.ndarray:
    """EOFA rank-one s-space correction in this module's normalisation:
    the u-vector of the one-flavor shift term Delta_pm = u (x) e_j on the
    pm chirality (j = Ls-1 for plus, 0 for minus), scaled by alpha =
    b5 (4 - m5) + 1 into the M5 block.  The (Ls,Ls) blocks are inverted
    densely, so no Sherman-Morrison form is needed."""
    dw = 4.0 - m5
    al = b5 + c5
    eofa_norm = (al * (mq3 - mq2) * (al + 1.0) ** (2 * ls)
                 / ((al + 1.0) ** ls + mq2 * (al - 1.0) ** ls)
                 / ((al + 1.0) ** ls + mq3 * (al - 1.0) ** ls))
    N = ((+1.0 if eofa_pm else -1.0) * (2.0 * eofa_shift * eofa_norm)
         * ((al + 1.0) ** ls + mq1 * (al - 1.0) ** ls) / (b5 * dw + 1.0))
    u = np.zeros(ls)
    for s in range(ls):
        u[s if eofa_pm else ls - 1 - s] = (
            N * (-1.0) ** s * (al - 1.0) ** s / (al + 1.0) ** (ls + s + 1))
    alpha_m5 = b5 * dw + 1.0
    rank1 = np.zeros((ls, ls))
    j = ls - 1 if eofa_pm else 0
    rank1[:, j] = alpha_m5 * u
    return rank1


def _eofa_corrected_m5(obj, ls, b5, c5, m5, mf, mq1, mq2, mq3, eofa_pm,
                       eofa_shift) -> SOp:
    """Shared EOFA setup: default the mq's to mf, record the eofa params
    on ``obj``, and return obj.s_m5 with the rank-one correction added on
    the eofa_pm chirality block."""
    mq1 = mf if mq1 is None else mq1
    mq2 = mf if mq2 is None else mq2
    mq3 = mf if mq3 is None else mq3
    obj.eofa_pm = eofa_pm
    obj.eofa_shift = eofa_shift
    r1 = eofa_rank_one(ls, b5, c5, m5, mq1, mq2, mq3, eofa_pm, eofa_shift)
    if eofa_pm:
        return SOp(obj.s_m5.ap + r1, obj.s_m5.am)
    return SOp(obj.s_m5.ap, obj.s_m5.am + r1)


class DiracMobiusEofa(DiracMobius):
    """Full Möbius EOFA operator: Möbius at mass mf plus the one-flavor
    rank-one shift term on the eofa_pm chirality."""

    def __init__(self, gauge, geom, ls, m5, mf, b5=1.0, c5=0.0,
                 mq1=None, mq2=None, mq3=None, eofa_pm=True,
                 eofa_shift=0.0, antiperiodic_t=True):
        super().__init__(gauge, geom, ls, m5, mf, b5, c5, antiperiodic_t)
        self.s_m5 = _eofa_corrected_m5(self, ls, b5, c5, m5, mf, mq1, mq2,
                                       mq3, eofa_pm, eofa_shift)


class DiracMobiusEofaPC(DiracMobiusPC):
    """4d-even/odd preconditioned Möbius EOFA (symmetric form): the
    Möbius PC composition with every M5 / M5^{-1} replaced by the
    EOFA-corrected block (its inverse dense)."""

    def __init__(self, gauge, geom, ls, m5, mf, b5=1.0, c5=0.0,
                 mq1=None, mq2=None, mq3=None, eofa_pm=True,
                 eofa_shift=0.0, antiperiodic_t=True,
                 matpc: int = MATPC_EVEN_EVEN):
        super().__init__(gauge, geom, ls, m5, mf, b5, c5, antiperiodic_t,
                         matpc)
        self.s_m5 = _eofa_corrected_m5(self, ls, b5, c5, m5, mf, mq1, mq2,
                                       mq3, eofa_pm, eofa_shift)
        self._set_inverses()


# ---------------------------------------------------------------------------
# 5d-preconditioned (Shamir) domain wall
# ---------------------------------------------------------------------------

def _shop_masks(ls: int, mf: float, ndim: int, spin_axis: int, dtype,
                device):
    """The s-hop's masks on a 5d field (s leading): the -mf wrap of
    psi(s+1) and of psi(s-1), and P_- (spins 2, 3)."""
    sh = (ls,) + (1,) * (ndim - 1)
    wrap_up = torch.tensor([1.0] * (ls - 1) + [-mf], dtype=dtype,
                           device=device).reshape(sh)
    wrap_dn = torch.tensor([-mf] + [1.0] * (ls - 1), dtype=dtype,
                           device=device).reshape(sh)
    ssh = [1] * ndim
    ssh[spin_axis] = 4
    lo = torch.tensor([0.0, 0.0, 1.0, 1.0], dtype=dtype,
                      device=device).reshape(ssh)
    return wrap_up, wrap_dn, lo


def _shop(psi5, masks, swap_pm: bool):
    """2 (P_- S^- + P_+ S^+) psi (swap_pm: the adjoint's P-swap) on a
    5d field with s leading; ``masks`` from ``_shop_masks``."""
    wrap_up, wrap_dn, lo = masks
    hi = 1.0 - lo                                          # P_+
    up = torch.roll(psi5, -1, dims=0) * wrap_up            # psi(s+1)
    dn = torch.roll(psi5, +1, dims=0) * wrap_dn            # psi(s-1)
    if swap_pm:
        return 2.0 * (hi * up + lo * dn)
    return 2.0 * (lo * up + hi * dn)


class DiracDomainWall5DPC(DiracPC):
    """5d-even/odd preconditioned Shamir domain wall: the checkerboard
    parity includes the 5th coordinate, so both the 4-d hops and the
    s-hops flip parity and the single hop operator

        D_5d = hop4 + 2 (P_- S^-(mf) + P_+ S^+(mf))

    appears in the Schur complement M_pc = 1 - kappa5^2 D_eo D_oe,
    kappa5 = 1/(2(5 - m5)).

    Layout: a 5d-parity-p field is stored (Ls, T, Z, Y, X//2, 4, 3) where
    slice s holds the 4d-parity (p + s) % 2 half-lattice, so the s-hop is
    elementwise."""

    g5_hermitian = False

    def __init__(self, gauge: torch.Tensor, geom: LatticeGeometry, ls: int,
                 m5: float, mf: float, antiperiodic_t: bool = True,
                 matpc: int = MATPC_EVEN_EVEN):
        self.geom = geom
        self.ls = ls
        self.mf = mf
        self.matpc = matpc
        self.kappa5 = 0.5 / (5.0 - m5)
        self.m5 = m5
        g = apply_t_boundary(gauge, geom, -1 if antiperiodic_t else 1)
        self.antiperiodic_t = antiperiodic_t
        self.gauge_eo = wops.split_gauge_eo(g, geom)

    def _hop4(self, psi5, target_p5: int):
        return torch.stack([
            wops.dslash_eo(self.gauge_eo, psi5[s], self.geom,
                           (target_p5 + s) % 2) for s in range(self.ls)])

    def _shop(self, psi5, swap_pm: bool):
        masks = _shop_masks(self.ls, self.mf, psi5.ndim, -2,
                            psi5.real.dtype, psi5.device)
        return _shop(psi5, masks, swap_pm)

    def D_to(self, psi5, target_p5: int):
        """D_5d from 5d-parity (1-p) to p."""
        return self._hop4(psi5, target_p5) + self._shop(psi5, False)

    def _Ddag_to(self, chi5, target_p5: int):
        h4 = apply_gamma5(self._hop4(apply_gamma5(chi5), target_p5))
        return h4 + self._shop(chi5, True)

    def M(self, x_p):
        p = self.matpc
        return x_p - (self.kappa5 ** 2) * self.D_to(
            self.D_to(x_p, 1 - p), p)

    def Mdag(self, x_p):
        p = self.matpc
        return x_p - (self.kappa5 ** 2) * self._Ddag_to(
            self._Ddag_to(x_p, 1 - p), p)

    def flops_per_site_M(self) -> int:
        return 2 * (1320 + 96) + 48  # two 5d hops (4d + s-hop) + axpy

    def split5(self, psi5_full):
        """Full 5d field -> (even5, odd5) in the slice-aligned layout."""
        ev, od = [], []
        for s in range(self.ls):
            e4, o4 = even_odd_split(psi5_full[s], self.geom)
            ev.append(e4 if s % 2 == 0 else o4)
            od.append(o4 if s % 2 == 0 else e4)
        return torch.stack(ev), torch.stack(od)

    def join5(self, x_even5, x_odd5):
        return torch.stack([
            even_odd_join(x_even5[s], x_odd5[s], self.geom) if s % 2 == 0
            else even_odd_join(x_odd5[s], x_even5[s], self.geom)
            for s in range(self.ls)])

    def prepare(self, b_even5, b_odd5):
        """Schur rhs for the normalised system (1 - kappa5 D) x = b/(5-m5):
        src = b_p/(5-m5) + kappa5 D_pq b_q/(5-m5)."""
        p = self.matpc
        b_p, b_q = ((b_even5, b_odd5) if p == EVEN
                    else (b_odd5, b_even5))
        scale = 1.0 / (5.0 - self.m5)
        return scale * (b_p + self.kappa5 * self.D_to(b_q, p))

    def reconstruct(self, x_p, b_even5, b_odd5):
        p = self.matpc
        b_q = b_odd5 if p == EVEN else b_even5
        scale = 1.0 / (5.0 - self.m5)
        x_q = scale * b_q + self.kappa5 * self.D_to(x_p, 1 - p)
        return (x_p, x_q) if p == EVEN else (x_q, x_p)

    def pairs(self, store_dtype=torch.float32, precision_form: str = "full"
              ) -> "DiracDomainWall5DPCPairs":
        """Pair companion: each 4d hop is two B5-eo launches, one per
        parity group of s planes; float32, full or recon-12 links."""
        return DiracDomainWall5DPCPairs(self, store_dtype, precision_form)


class DiracDomainWall5DPCPairs(_LsPairOps):
    """Pair-form DiracDomainWall5DPC on the slice-aligned 5d checkerboard,
    carried as (Ls, 4, 3, 2, T, Z, Y*Xh) float32 pairs: the s-hop stays
    elementwise, and the 4d hop of slice s targets 4d parity
    (p5 + s) % 2.  The slices of each target parity, x[r::2], are one
    B5-eo launch: two launches per 4d hop.  Those slices are strided
    views, so they are made contiguous before the launch (the kernel
    reads raw pointers)."""

    def __init__(self, dpc: DiracDomainWall5DPC, store_dtype=torch.float32,
                 precision_form: str = "full"):
        _check_store(store_dtype)
        self._setup_hop(dpc.geom, wpk.pack_gauge_eo(dpc.gauge_eo),
                        store_dtype, tb_sign=dpc.antiperiodic_t,
                        precision_form=precision_form)
        self._dpc = dpc
        self.ls = dpc.ls
        self.mf = float(dpc.mf)
        self.m5 = float(dpc.m5)
        self.kappa5 = float(dpc.kappa5)
        self.matpc = dpc.matpc
        self._masks = _shop_masks(self.ls, self.mf, 7, 1, torch.float32,
                                  self.gauge_eo_pp[0].device)

    def _hop4_pairs(self, x, target_p5: int, out_dtype):
        out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
        for r in (0, 1):
            tp = (target_p5 + r) % 2
            out[r::2] = dwp.dslash_eo_pallas_packed_ls(
                self.gauge_eo_pp[tp], self._u_bw[tp], x[r::2].contiguous(),
                self.dims, tp, out_dtype=out_dtype, tb_sign=self._tb_sign)
        return out

    def D_to_pairs(self, x, target_p5: int, out_dtype=None):
        out = (self._hop4_pairs(x, target_p5, torch.float32)
               + _shop(x.to(torch.float32), self._masks, False))
        return out.to(out_dtype or self.store_dtype)

    def _Ddag_to_pairs(self, x, target_p5: int, out_dtype=None):
        h4 = self._g5(self._hop4_pairs(self._g5(x), target_p5,
                                       torch.float32))
        out = h4 + _shop(x.to(torch.float32), self._masks, True)
        return out.to(out_dtype or self.store_dtype)

    def M_pairs(self, x):
        p = self.matpc
        dd = self.D_to_pairs(self.D_to_pairs(x, 1 - p), p,
                             out_dtype=torch.float32)
        out = x.to(torch.float32) - (self.kappa5 ** 2) * dd
        return out.to(self.store_dtype)

    def Mdag_pairs(self, x):
        p = self.matpc
        dd = self._Ddag_to_pairs(self._Ddag_to_pairs(x, 1 - p), p,
                                 out_dtype=torch.float32)
        out = x.to(torch.float32) - (self.kappa5 ** 2) * dd
        return out.to(self.store_dtype)

    def prepare_pairs(self, b_even5, b_odd5):
        """Slice-aligned complex 5d-parity sources -> pair-form rhs."""
        p = self.matpc
        b_p, b_q = ((b_even5, b_odd5) if p == EVEN
                    else (b_odd5, b_even5))
        scale = 1.0 / (5.0 - self.m5)
        t = self.D_to_pairs(self._to_pairs(b_q), p, out_dtype=torch.float32)
        rhs = scale * (self._to_pairs(b_p).to(torch.float32)
                       + self.kappa5 * t)
        return rhs.to(self.store_dtype)

    def reconstruct_pairs(self, x_pp, b_even5, b_odd5):
        p = self.matpc
        b_q = b_odd5 if p == EVEN else b_even5
        scale = 1.0 / (5.0 - self.m5)
        t = self.D_to_pairs(x_pp, 1 - p, out_dtype=torch.float32)
        xq_pp = (scale * self._to_pairs(b_q).to(torch.float32)
                 + self.kappa5 * t)
        x_p = self._from_pairs(x_pp, b_q.dtype)
        x_q = self._from_pairs(xq_pp, b_q.dtype)
        return (x_p, x_q) if p == EVEN else (x_q, x_p)

    def split5(self, psi5_full):
        return self._dpc.split5(psi5_full)

    def join5(self, x_even5, x_odd5):
        return self._dpc.join5(x_even5, x_odd5)
