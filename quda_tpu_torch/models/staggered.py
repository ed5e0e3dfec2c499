"""Staggered and improved-staggered (asqtad/HISQ) Dirac operators.

Port of the single-device part of quda_tpu/models/staggered.py.
M = 2m + D with anti-Hermitian D (MILC mass convention).  The even/odd
operator on parity p is the Hermitian positive definite

    M_pc x_p = 4m^2 x_p - D_pq D_qp x_p

so CG runs on it directly: no normal equations.  prepare/reconstruct of
the PC solve of M x = b:

    rhs_p = 2m b_p - D_pq b_q,      x_q = (b_q - D_qp x_p) / 2m

The full-lattice pair operator ``DiracStaggeredPackedPairs``
(``DiracStaggered.pairs``, the operator API's ``mat_quda`` and
``mat_dag_mat_quda``) runs D on the full-lattice kernels: improved
staggered on S1-full, fat-only on S2-full, float32 only (their float64
forms wait for ROADMAP A7).

The pair operator ``DiracStaggeredPCPairs`` (``DiracStaggeredPC.pairs``)
runs every hop through a CUDA kernel's wrapper: improved staggered on the
fused fat + Naik hop S1 (form ``fused``), fat-only staggered on the
gather pass S2 (form ``two_pass``; the improved two-pass form runs the
fat and Naik passes and sums them), or either on the copy-free v3 pass
(form ``v3``: no backward copy; the improved hop is the fat pass and the
Naik pass adding it, S1's output bit for bit).  ``precision_form="fold"``
keeps the links folded (``to_fold``) and runs the fused form on S1-fold;
on the two_pass and v3 forms and on a fat-only operator it becomes
"full", as the JAX package's downgrade does.  The ``_mrhs`` forms act on
a leading axis of N right-hand sides, (N,3,2,T,Z,Y*Xh): every hop is one
call of the multi-RHS gather pass S2-mrhs (the fat pass, then the Naik
pass added into it), on the ``two_pass`` form only.  On CPU tensors the
wrappers run their plain versions.  Storage float32 (the precise
operator) or bfloat16 (the sloppy operator of mixed precision); full
links only.  The JAX package's form race, its mesh route and its r12
precision form are not ported (ROADMAP A15, A17, C).
"""

from __future__ import annotations

import logging

import torch

from ..fields.geometry import EVEN, LatticeGeometry
from ..ops import staggered as sops
from ..ops import staggered_packed as spk
from ..ops import staggered_pallas as spl
from ..ops import wilson_packed as wpk
from ..ops import wilson_pallas_packed as wpp
from ..ops.boundary import apply_staggered_phases
from ..ops.wilson import split_gauge_eo
from .dirac import MATPC_EVEN_EVEN, Dirac, DiracPC

log = logging.getLogger("quda_tpu_torch")

STORE_DTYPES = (torch.float32, torch.bfloat16)
STAGGERED_FORMS = ("fused", "two_pass", "v3")
STAGGERED_PRECISION_FORMS = ("full", "fold")
# the Wilson-only precision forms, which the JAX package serves as "full"
# on the staggered family
WILSON_ONLY_FORMS = ("r12f", "bzfull", "int8")
# forms of the JAX package's staggered pair operator that are not ported
QUEUED_FORMS = {"auto": "ROADMAP A17 (the tuner)"}
QUEUED_PRECISION_FORMS = {
    "r12": "ROADMAP C: HISQ long links are not +-SU(3), so a rebuilt "
           "row 2 is wrong",
    "auto": "ROADMAP A17 (the tuner)"}


def _fold(fat, long_links, geom, antiperiodic_t):
    """KS phases (and the t boundary, depth 3 for the long links) folded
    into the links."""
    fat = apply_staggered_phases(fat, geom, antiperiodic_t)
    if long_links is not None:
        long_links = apply_staggered_phases(long_links, geom,
                                            antiperiodic_t, nhop=3)
    return fat, long_links


class DiracStaggered(Dirac):
    """Full-lattice staggered operator M = 2m + D (nspin = 1 fields):
    ``fat`` and ``long`` are the phase-folded links the multigrid's fine
    level reads (``long`` None unless improved)."""

    g5_hermitian = False   # staggered uses epsilon(x) = (-1)^(x+y+z+t)
    nspin = 1

    def __init__(self, gauge: torch.Tensor, geom: LatticeGeometry,
                 mass: float, improved: bool = False,
                 long_links: torch.Tensor | None = None,
                 fold_phases: bool = True, antiperiodic_t: bool = True):
        self.geom = geom
        self.mass = mass
        self.improved = improved
        if fold_phases:
            gauge, long_links = _fold(gauge, long_links, geom,
                                      antiperiodic_t)
        self.fat = gauge
        self.long = long_links if improved else None

    def D(self, psi):
        return sops.dslash_full(self.fat, psi, self.long)

    def M(self, psi):
        return 2.0 * self.mass * psi + self.D(psi)

    def Mdag(self, psi):
        # D anti-Hermitian: Mdag = 2m - D
        return 2.0 * self.mass * psi - self.D(psi)

    def flops_per_site_M(self) -> int:
        return (1146 if self.improved else 570) + 24

    def pairs(self, store_dtype=torch.float32) -> "DiracStaggeredPackedPairs":
        """Pair companion on the full packed lattice, D on S1-full
        (improved) or S2-full (fat-only), float32."""
        return DiracStaggeredPackedPairs(self, store_dtype)


class DiracStaggeredPackedPairs:
    """Pair companion of the full-lattice staggered M = 2m + D on the
    packed layout: spinors (3,2,T,Z,Y*X), links (4,3,3,2,T,Z,Y*X) in
    float32.  Improved staggered runs D as one S1-full launch on the fat
    and long links (no backward copy); fat-only as one S2-full launch on
    the fat links and their resident pre-shifted backward copy.  ``D``,
    ``M``, ``Mdag`` and ``MdagM`` take and give canonical complex
    (T,Z,Y,X,1,3) fields."""

    def __init__(self, ds: DiracStaggered, store_dtype=torch.float32):
        if store_dtype != torch.float32:
            raise NotImplementedError(
                f"pair storage {store_dtype}: the full-lattice staggered "
                "kernels (S1-full, S2-full) have float32 forms only; their "
                "float64 forms wait for ROADMAP A7")
        self.geom = ds.geom
        self.mass = float(ds.mass)
        self.dims = tuple(ds.geom.lattice_shape)
        self.store_dtype = store_dtype
        X = self.dims[3]

        def packed(links):
            return wpk.to_packed_pairs(spk.pack_links(links),
                                       store_dtype).contiguous()

        self.fat_pl = packed(ds.fat)
        self.long_pl = packed(ds.long) if ds.long is not None else None
        self.fat_bw = (None if self.long_pl is not None else
                       spl.backward_links(self.fat_pl, X, 1).contiguous())

    def D_pairs(self, psi_pl):
        """The hop sum D psi: S1-full (improved) or S2-full (fat-only)."""
        X = self.dims[3]
        if self.long_pl is not None:
            return spl.dslash_staggered_pallas_fused(self.fat_pl, psi_pl, X,
                                                     self.long_pl)
        return spl.dslash_staggered_pallas(self.fat_pl, self.fat_bw, psi_pl,
                                           X)

    def M_pairs(self, x):
        return torch.add(self.D_pairs(x), x, alpha=2.0 * self.mass)

    def Mdag_pairs(self, x):
        """D is anti-Hermitian: M^dag = 2m - D."""
        return torch.add(-self.D_pairs(x), x, alpha=2.0 * self.mass)

    def MdagM_pairs(self, x):
        return self.Mdag_pairs(self.M_pairs(x))

    def _to_pairs(self, x):
        """Canonical (..., T,Z,Y,X,1,3) complex -> (..., 3,2,T,Z,Y*X)."""
        return wpk.to_packed_pairs(spk.pack_staggered(x),
                                   self.store_dtype).contiguous()

    def _from_pairs(self, x, dtype):
        return spk.unpack_staggered(wpk.from_packed_pairs(x, dtype),
                                    self.dims)

    def _on_canonical(self, fn, psi):
        return self._from_pairs(fn(self._to_pairs(psi)), psi.dtype)

    def D(self, psi):
        return self._on_canonical(self.D_pairs, psi)

    def M(self, psi):
        return self._on_canonical(self.M_pairs, psi)

    def Mdag(self, psi):
        return self._on_canonical(self.Mdag_pairs, psi)

    def MdagM(self, psi):
        return self._on_canonical(self.MdagM_pairs, psi)


class DiracStaggeredPC(DiracPC):
    """The parity-p staggered normal operator 4m^2 - D_pq D_qp, complex
    canonical fields (T,Z,Y,Xh,1,3).  It IS the solver operator
    (Hermitian positive definite)."""

    hermitian = True
    g5_hermitian = False

    def __init__(self, gauge: torch.Tensor, geom: LatticeGeometry,
                 mass: float, improved: bool = False,
                 long_links: torch.Tensor | None = None,
                 matpc: int = MATPC_EVEN_EVEN, fold_phases: bool = True,
                 antiperiodic_t: bool = True):
        self.geom = geom
        self.mass = mass
        self.matpc = matpc
        self.improved = improved
        if fold_phases:
            gauge, long_links = _fold(gauge, long_links, geom,
                                      antiperiodic_t)
        self.fat_eo = split_gauge_eo(gauge, geom)
        self.long_eo = (split_gauge_eo(long_links, geom)
                        if improved and long_links is not None else None)

    def D_to(self, psi, target_parity):
        return sops.dslash_eo(self.fat_eo, psi, self.geom, target_parity,
                              self.long_eo)

    def M(self, x_p):
        p = self.matpc
        return (4.0 * self.mass ** 2) * x_p - self.D_to(
            self.D_to(x_p, 1 - p), p)

    def Mdag(self, x_p):
        return self.M(x_p)

    def flops_per_site_M(self) -> int:
        # two half-lattice hops and the shifted axpy, per updated site
        return 2 * (1146 if self.improved else 570) + 24

    def prepare(self, b_even, b_odd):
        p = self.matpc
        b_p, b_q = (b_even, b_odd) if p == EVEN else (b_odd, b_even)
        return 2.0 * self.mass * b_p - self.D_to(b_q, p)

    def reconstruct(self, x_p, b_even, b_odd):
        p = self.matpc
        b_q = b_odd if p == EVEN else b_even
        x_q = (b_q - self.D_to(x_p, 1 - p)) / (2.0 * self.mass)
        return (x_p, x_q) if p == EVEN else (x_q, x_p)

    def pairs(self, store_dtype=torch.float32, form: str | None = None,
              mesh=None, precision_form: str | None = None
              ) -> "DiracStaggeredPCPairs":
        """Pair-storage companion: float32 storage is the precise
        operator, bfloat16 the sloppy one.  ``form``: "fused" (improved
        only), "two_pass" or "v3"; default fused for improved and two_pass
        for fat-only.  ``precision_form``: "full" (default) or "fold" (the
        fused form only; elsewhere full, with a notice)."""
        return DiracStaggeredPCPairs(self, store_dtype, form=form,
                                     mesh=mesh,
                                     precision_form=precision_form)


class DiracStaggeredPCPairs:
    """Pair-form DiracStaggeredPC on the packed layout: half-lattice
    links (4,3,3,2,T,Z,Y*Xh) and spinors (3,2,T,Z,Y*Xh) in
    ``store_dtype``, sums in float32, every hop on a kernel wrapper.
    ``prepare_pairs``/``reconstruct_pairs`` take and give canonical
    complex parity fields."""

    hermitian = True

    def __init__(self, dpc: DiracStaggeredPC, store_dtype=torch.float32,
                 form: str | None = None, mesh=None,
                 precision_form: str | None = None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh-sharded staggered operators are not ported yet "
                "(ROADMAP A15)")
        pform = precision_form or "full"
        if pform in QUEUED_PRECISION_FORMS:
            raise NotImplementedError(
                f"staggered precision_form {pform!r} is not ported: "
                f"{QUEUED_PRECISION_FORMS[pform]}; the port serves "
                f"{STAGGERED_PRECISION_FORMS}")
        if pform in WILSON_ONLY_FORMS:
            log.info("staggered precision_form: %s is a Wilson-only form; "
                     "the staggered operator runs full", pform)
            pform = "full"
        if pform not in STAGGERED_PRECISION_FORMS:
            raise ValueError(f"unknown precision_form {pform!r}")
        if store_dtype not in STORE_DTYPES:
            raise NotImplementedError(
                f"pair storage {store_dtype}: float32 and bfloat16 are "
                "ported (ROADMAP A7 for int8)")
        improved = dpc.long_eo is not None
        if form is None:
            form = "fused" if improved else "two_pass"
        if form in QUEUED_FORMS:
            raise NotImplementedError(
                f"staggered form {form!r} is not ported yet "
                f"({QUEUED_FORMS[form]}); the port serves "
                f"{STAGGERED_FORMS}")
        if form not in STAGGERED_FORMS:
            raise ValueError(f"staggered form must be one of "
                             f"{STAGGERED_FORMS}, got {form!r}")
        if form == "fused" and not improved:
            # the fused kernel IS the fat + Naik fusion: a fat-only
            # operator has one hop set
            log.info("staggered form: fused needs fat+Naik links; the "
                     "fat-only operator runs two_pass")
            form = "two_pass"
        if pform == "fold" and form != "fused":
            # the fold kernel is the fused fat + Naik hop's (S1-fold)
            log.info("staggered precision_form: fold runs on the fused "
                     "form only; the %s form serves full storage", form)
            pform = "full"
        self.geom = dpc.geom
        self.mass = float(dpc.mass)
        self.matpc = dpc.matpc
        self.dims = tuple(dpc.geom.lattice_shape)
        self.store_dtype = store_dtype
        self.form = form
        self._precision_form = pform

        def packed(links_eo):
            return tuple(wpk.to_packed_pairs(spk.pack_links(g),
                                             store_dtype).contiguous()
                         for g in links_eo)

        self.fat_eo_pp = packed(dpc.fat_eo)
        self.long_eo_pp = packed(dpc.long_eo) if improved else None
        self._fat_bw = self._long_bw = None
        if form == "two_pass":
            # resident pre-shifted backward links, one set per target
            # parity, built once per link load
            def bw(links_pp, nhop):
                return tuple(spl.backward_links_eo(
                    links_pp[1 - p], self.dims, p, nhop).contiguous()
                    for p in (0, 1))
            self._fat_bw = bw(self.fat_eo_pp, 1)
            if improved:
                self._long_bw = bw(self.long_eo_pp, 3)
        if pform == "fold":
            # S1-fold's layout (re/im interleaved into z), folded once here
            self.fat_eo_pp = tuple(wpp.to_fold(g) for g in self.fat_eo_pp)
            self.long_eo_pp = tuple(wpp.to_fold(g) for g in self.long_eo_pp)

    def D_to_pairs(self, psi_pp, target_parity, out_dtype=None):
        """The hop D_{p <- 1-p} on pair arrays, out in ``out_dtype``
        (default the storage dtype).  The fold form folds psi in and the
        hop out, both as contiguous copies."""
        out_dtype = out_dtype or self.store_dtype
        p = target_parity
        lng = self.long_eo_pp
        if self.form == "fused" and self._precision_form == "fold":
            out = spl.dslash_staggered_eo_pallas_fused_fold(
                self.fat_eo_pp[p], self.fat_eo_pp[1 - p],
                wpp.to_fold(psi_pp), self.dims, p, long_here_f=lng[p],
                long_there_f=lng[1 - p], out_dtype=out_dtype)
            return wpp.from_fold(out).contiguous()
        if self.form == "fused":
            return spl.dslash_staggered_eo_pallas_fused(
                self.fat_eo_pp[p], self.fat_eo_pp[1 - p], psi_pp, self.dims,
                p, long_here_pl=lng[p], long_there_pl=lng[1 - p],
                out_dtype=out_dtype)
        if self.form == "v3":
            return spl.dslash_staggered_eo_pallas_v3(
                self.fat_eo_pp[p], self.fat_eo_pp[1 - p], psi_pp, self.dims,
                p, long_here_pl=lng[p] if lng is not None else None,
                long_there_pl=lng[1 - p] if lng is not None else None,
                out_dtype=out_dtype)
        return spl.dslash_staggered_eo_pallas(
            self.fat_eo_pp[p], self._fat_bw[p], psi_pp, self.dims, p,
            long_here_pl=lng[p] if lng is not None else None,
            long_bw_pl=(self._long_bw[p] if self._long_bw is not None
                        else None),
            out_dtype=out_dtype)

    def M_pairs(self, x_pp):
        """(4m^2 - D_pq D_qp) x on pair arrays: the first hop rounded to
        storage, the second in float32, the axpy in float32."""
        p = self.matpc
        dd = self.D_to_pairs(self.D_to_pairs(x_pp, 1 - p), p,
                             out_dtype=torch.float32)
        out = (4.0 * self.mass ** 2) * x_pp.to(torch.float32) - dd
        return out.to(self.store_dtype)

    Mdag_pairs = M_pairs

    def MdagM_pairs(self, x_pp):
        return self.M_pairs(self.M_pairs(x_pp))

    # -- multi-RHS forms: a leading axis of N right-hand sides ------------
    def _d_to_mrhs(self, psi_b, target_parity, out_dtype=None):
        """The hop D_{p <- 1-p} on a batch psi_b (N,3,2,T,Z,Y*Xh): the
        fat and (improved) Naik passes of S2-mrhs, links loaded once per
        chunk of right-hand sides.  The two_pass form's: the batched route
        runs the gather kernel only, as the JAX package's does."""
        if self.form != "two_pass":
            raise NotImplementedError(
                f"the multi-RHS staggered hop runs on the two_pass form "
                f"(S2-mrhs), not {self.form!r}: build the operator with "
                f"pairs(form='two_pass')")
        p = target_parity
        lng = self.long_eo_pp
        return spl.dslash_staggered_eo_pallas_mrhs(
            self.fat_eo_pp[p], self._fat_bw[p], psi_b, self.dims, p,
            long_here_pl=lng[p] if lng is not None else None,
            long_bw_pl=(self._long_bw[p] if self._long_bw is not None
                        else None),
            out_dtype=out_dtype or self.store_dtype)

    def M_pairs_mrhs(self, x_b):
        """(4m^2 - D_pq D_qp) per lane: Hermitian positive definite, so
        the batched CG runs it directly (one apply per iteration)."""
        p = self.matpc
        tmp = self._d_to_mrhs(x_b, 1 - p, self.store_dtype)
        dd = self._d_to_mrhs(tmp, p, torch.float32)
        out = (4.0 * self.mass ** 2) * x_b.to(torch.float32) - dd
        return out.to(self.store_dtype)

    Mdag_pairs_mrhs = M_pairs_mrhs

    def MdagM_pairs_mrhs(self, x_b):
        return self.M_pairs_mrhs(self.M_pairs_mrhs(x_b))

    # -- canonical complex <-> pairs --------------------------------------
    def _to_pairs(self, x):
        """Canonical (..., T,Z,Y,Xh,1,3) complex -> (..., 3,2,T,Z,Y*Xh),
        contiguous (the kernels read raw pointers)."""
        return wpk.to_packed_pairs(spk.pack_staggered(x),
                                   self.store_dtype).contiguous()

    def _from_pairs(self, x_pp, dtype):
        T, Z, Y, X = self.dims
        return spk.unpack_staggered(wpk.from_packed_pairs(x_pp, dtype),
                                    (T, Z, Y, X // 2))

    def prepare_pairs(self, b_even, b_odd):
        """Canonical complex parity sources -> pair-form PC rhs
        2m b_p - D_pq b_q, in the storage dtype."""
        p = self.matpc
        b_p, b_q = (b_even, b_odd) if p == EVEN else (b_odd, b_even)
        bp = self._to_pairs(b_p).to(torch.float32)
        dq = self.D_to_pairs(self._to_pairs(b_q), p,
                             out_dtype=torch.float32)
        return ((2.0 * self.mass) * bp - dq).to(self.store_dtype)

    def reconstruct_pairs(self, x_pp, b_even, b_odd):
        """Pair-form PC solution -> canonical complex (x_even, x_odd),
        x_q = (b_q - D_qp x_p) / 2m with the hop on pair arrays."""
        p = self.matpc
        b_q = b_odd if p == EVEN else b_even
        dq = self.D_to_pairs(x_pp, 1 - p, out_dtype=torch.float32)
        x_q_pp = (self._to_pairs(b_q).to(torch.float32) - dq) / (
            2.0 * self.mass)
        x_p = self._from_pairs(x_pp, b_q.dtype)
        x_q = self._from_pairs(x_q_pp, b_q.dtype)
        return (x_p, x_q) if p == EVEN else (x_q, x_p)

    def prepare_pairs_mrhs(self, b_even_b, b_odd_b):
        """Batched prepare_pairs: (N,T,Z,Y,Xh,1,3) complex parity sources
        in, the (N,3,2,T,Z,Y*Xh) rhs 2m b_p - D_pq b_q out, the hop on
        S2-mrhs."""
        p = self.matpc
        b_p, b_q = ((b_even_b, b_odd_b) if p == EVEN
                    else (b_odd_b, b_even_b))
        bp = self._to_pairs(b_p).to(torch.float32)
        dq = self._d_to_mrhs(self._to_pairs(b_q), p, torch.float32)
        return ((2.0 * self.mass) * bp - dq).to(self.store_dtype)

    def solution_from_pairs_mrhs(self, x_b, dtype=torch.complex64):
        """Batched pair solutions -> canonical complex (N,T,Z,Y,Xh,1,3)."""
        return self._from_pairs(x_b, dtype)

    def reconstruct_pairs_mrhs(self, x_b, b_even_b, b_odd_b):
        """Batched reconstruct_pairs: x_q = (b_q - D_qp x_p) / 2m on
        S2-mrhs; canonical complex (even, odd) batches out."""
        p = self.matpc
        b_q = b_odd_b if p == EVEN else b_even_b
        dq = self._d_to_mrhs(x_b, 1 - p, torch.float32)
        xq_b = (self._to_pairs(b_q).to(torch.float32) - dq) / (
            2.0 * self.mass)
        x_p = self.solution_from_pairs_mrhs(x_b, b_q.dtype)
        x_q = self.solution_from_pairs_mrhs(xq_b, b_q.dtype)
        return (x_p, x_q) if p == EVEN else (x_q, x_p)
