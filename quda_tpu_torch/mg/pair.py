"""Complex-free multigrid on re/im pair arrays, as in quda_tpu/mg/pair.py:
the Wilson and the staggered (fat-only, improved by defect correction)
hierarchies.

Every object is realified:

* chiral fields   (lat, 2, K)     complex -> (lat, 2, K, 2)     real
* transfer V      (latc, 2, D, N) complex -> (latc, 2, D, N, 2) real
* coarse links    (latc, Nc, Nc)  complex -> (latc, Nc, Nc, 2)  real

Complex products are four real einsums (``_pair_ein``).  The block
orthonormalisation of the null vectors is Cholesky-QR on the interleaved
real embedding (``cholqr2``, two passes for f32-grade orthonormality).
The Krylov pieces run the real solvers on the realified operators.

Kernels: the fine Wilson level's hop runs on B4
(``PairWilsonLevelOp._d_std``) and its multi-RHS form, the null-vector
block solve's matvec, on B5 (``M_mrhs_pl``); the fine staggered level's
fat hop on S2-full and S2-mrhs-full, and the outer solve's fat + Naik
operator (``PairStaggeredLevelOp.M_std_full``) on S1-full; every coarse
operator apply runs B8
(``PairCoarseOperator.M``, ops/coarse_pallas.py).  On CPU tensors the
wrappers run their plain versions.  The coarse operator keeps the JAX
package's einsum and embedding forms for its ``diag``/``hop`` (the
probes of the coarse build) and for ``M`` with ``use_kernel=False``; the
JAX package's race between the three forms and its
QUDA_TPU_MG_COARSE_FORM/_EMBED knobs wait for ROADMAP A17.

Fields may carry leading batch axes: the lattice axes are located from
the end, so every operator here serves a batch where the JAX package
vmaps.  The Kaehler-Dirac composition of the staggered level
(mg/staggered_kd.py) is refused, as the JAX package's pair hierarchy
refuses it (ROADMAP A12).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..fields.geometry import axis_of_mu
from ..ops import gamma as g
from ..ops import staggered_packed as spk
from ..ops import staggered_pallas as spl
from ..ops import wilson_packed as wpk
from ..ops import wilson_pallas_packed as wpp
from ..ops.coarse_pallas import coarse_apply_pallas, coarse_apply_pallas_mrhs
from ..ops.pair import (color_mul_pairs, dagger_pairs, deinterleave_mat,
                        interleave_mat, spin_mul_pairs, to_pairs)
from .coarse import DIRS
from .mg import MG, MGLevelParam, parity_eps

F32 = torch.float32


def _roll(v: torch.Tensor, mu: int, sign: int, ndim_after: int):
    """result[x] = v[x + sign*mu] on lattice axes that end ``ndim_after``
    axes before the last (periodic)."""
    return torch.roll(v, -sign, dims=axis_of_mu(mu) - 4 - ndim_after)


# -- chiral pair layout -----------------------------------------------------

def to_chiral_pairs(psi: torch.Tensor) -> torch.Tensor:
    """(..., 4, 3, 2) -> (..., 2, 6, 2)."""
    return psi.reshape(psi.shape[:-3] + (2, 6, 2))


def from_chiral_pairs(psi: torch.Tensor) -> torch.Tensor:
    return psi.reshape(psi.shape[:-3] + (4, 3, 2))


# -- pair linear algebra ----------------------------------------------------

def _pair_ein(spec: str, a: torch.Tensor, b: torch.Tensor,
              conj_a: bool = False) -> torch.Tensor:
    """Complex einsum on (..., 2) pair arrays: one spec, four real
    einsums."""
    ar, ai = a[..., 0], a[..., 1]
    if conj_a:
        ai = -ai
    br, bi = b[..., 0], b[..., 1]
    re = torch.einsum(spec, ar, br) - torch.einsum(spec, ai, bi)
    im = torch.einsum(spec, ar, bi) + torch.einsum(spec, ai, br)
    return torch.stack([re, im], dim=-1)


def _cholqr_pass(cols: torch.Tensor) -> torch.Tensor:
    """One Cholesky-QR pass on (..., D, N, 2) pair columns: the real
    Cholesky of the embedded Gram matrix is the embedding of the complex
    one (Cholesky uniqueness), so L^-dag comes back as pairs."""
    n = cols.shape[-2]
    gram = _pair_ein("...dn,...dm->...nm", cols, cols, conj_a=True)
    chol = torch.linalg.cholesky(interleave_mat(gram))
    eye = torch.eye(2 * n, dtype=chol.dtype,
                    device=chol.device).expand(chol.shape)
    linv = torch.linalg.solve_triangular(chol, eye, upper=False)
    w = dagger_pairs(deinterleave_mat(linv))        # (..., N, N, 2)
    return _pair_ein("...dn,...nm->...dm", cols, w)


def cholqr2(cols: torch.Tensor) -> torch.Tensor:
    """Orthonormalise complex columns given as (..., D, N, 2) pairs: two
    Cholesky-QR passes (CholQR2)."""
    return _cholqr_pass(_cholqr_pass(cols))


# -- transfer ---------------------------------------------------------------

def _block_fields_pairs(fields: torch.Tensor, block):
    """(B, T,Z,Y,X, 2, K, 2) -> (B, Tc,Zc,Yc,Xc, 2, D, 2)."""
    from .transfer import _block_fields
    return _block_fields(fields, block)


def _unblock_fields_pairs(blocked: torch.Tensor, block, fine_shape, K):
    from .transfer import _unblock_fields
    return _unblock_fields(blocked, block, fine_shape, K)


@dataclasses.dataclass
class PairTransfer:
    """Block transfer on pair arrays.

    v: (Tc,Zc,Yc,Xc, 2, D, N, 2) orthonormal complex aggregates as pairs.
    """

    v: torch.Tensor
    block: Tuple[int, int, int, int]
    fine_shape: Tuple[int, int, int, int]
    k_fine: int
    n_vec: int

    @classmethod
    def from_null_vectors(cls, null_vecs: torch.Tensor,
                          block) -> "PairTransfer":
        """null_vecs: (N, T,Z,Y,X, 2, K, 2) pair chiral fields."""
        n, T, Z, Y, X, _, K, _ = null_vecs.shape
        bt, bz, by, bx = block
        if T % bt or Z % bz or Y % by or X % bx:
            raise ValueError(f"block {tuple(block)} does not tile the "
                             f"lattice {(T, Z, Y, X)}")
        blocked = _block_fields_pairs(null_vecs, block)
        cols = blocked.movedim(0, -2)               # (latc, 2, D, N, 2)
        return cls(cholqr2(cols).contiguous(), tuple(block), (T, Z, Y, X),
                   K, n)

    @property
    def coarse_shape(self):
        T, Z, Y, X = self.fine_shape
        bt, bz, by, bx = self.block
        return (T // bt, Z // bz, Y // by, X // bx)

    def _parts(self):
        """(Re V, Im V), each contiguous (latc, 2, D, N), built once: the
        restriction and prolongation are then two real batched GEMMs each,
        reading V once."""
        cache = self.__dict__.setdefault("_cache", {})
        if "parts" not in cache:
            cache["parts"] = (self.v[..., 0].contiguous(),
                              self.v[..., 1].contiguous())
        return cache["parts"]

    def restrict(self, fine: torch.Tensor) -> torch.Tensor:
        """(T,Z,Y,X,2,K,2) -> (Tc,Zc,Yc,Xc,2,N,2): R = V^dag aggregate."""
        blocked = _block_fields_pairs(fine[None], self.block)[0]
        vr, vi = self._parts()
        # p = Re V^T [b_re, b_im], q = Im V^T [b_re, b_im]
        p = torch.matmul(vr.transpose(-1, -2), blocked)
        q = torch.matmul(vi.transpose(-1, -2), blocked)
        return torch.stack([p[..., 0] + q[..., 1], p[..., 1] - q[..., 0]],
                           dim=-1)

    def prolong(self, coarse: torch.Tensor) -> torch.Tensor:
        """(Tc,Zc,Yc,Xc,2,N,2) -> (T,Z,Y,X,2,K,2)."""
        vr, vi = self._parts()
        p = torch.matmul(vr, coarse)
        q = torch.matmul(vi, coarse)
        blocked = torch.stack([p[..., 0] - q[..., 1], p[..., 1] + q[..., 0]],
                              dim=-1)
        return _unblock_fields_pairs(blocked[None], self.block,
                                     self.fine_shape, self.k_fine)[0]


# -- coarse operator --------------------------------------------------------

@dataclasses.dataclass
class PairCoarseOperator:
    """Nearest-neighbour coarse stencil on (..., latc, 2, N, 2) pair
    fields.

    ``M`` runs B8 over the stack of the 9 embedded links (``use_kernel``,
    the default): one launch for a field, one launch of its multi-RHS form
    for a batch (the null-vector solves); with
    ``use_kernel=False`` it is diag + the 8 hops, each link applied as four
    (Nc, Nc) einsums or, with ``use_embedding``, as one real (2Nc, 2Nc)
    matvec on the interleaved embedding.  ``diag`` and ``hop`` (the probes
    of the next level's build) always take the einsum or embedding form.
    """

    x_diag: torch.Tensor                      # (latc, Nc, Nc, 2)
    y: Dict[Tuple[int, int], torch.Tensor]    # (mu,sign) -> (latc, Nc, Nc, 2)
    n_vec: int
    g5_hermitian: bool = True
    use_embedding: bool = False
    use_kernel: bool = True

    dtype = F32

    @property
    def nc(self):
        return 2 * self.n_vec

    @property
    def device(self):
        return self.x_diag.device

    def _flat(self, v):
        return v.reshape(v.shape[:-3] + (self.nc, 2))

    def _unflat(self, v):
        return v.reshape(v.shape[:-2] + (2, self.n_vec, 2))

    def _emb(self, key):
        cache = self.__dict__.setdefault("_emb_cache", {})
        if key not in cache:
            m = self.x_diag if key == "diag" else self.y[key]
            cache[key] = interleave_mat(m)        # (latc, 2Nc, 2Nc)
        return cache[key]

    def _apply(self, key, f):
        """One coarse link on the flat (..., latc, Nc, 2) field."""
        if self.use_embedding:
            # vector pairs -> interleaved (re0, im0, re1, ...)
            fi = f.reshape(f.shape[:-2] + (self.nc * 2,))
            out = torch.einsum("...ab,...b->...a", self._emb(key), fi)
            return out.reshape(f.shape)
        m = self.x_diag if key == "diag" else self.y[key]
        return _pair_ein("...ab,...b->...a", m, f)

    def diag(self, v):
        return self._unflat(self._apply("diag", self._flat(v)))

    def hop(self, v, mu, sign):
        nbr = _roll(self._flat(v), mu, sign, 2)
        return self._unflat(self._apply((mu, sign), nbr))

    def links9(self) -> torch.Tensor:
        """(9, S, E, E) embedded link stack [diag, *DIRS] that B8 reads,
        built once and cached."""
        cache = self.__dict__.setdefault("_emb_cache", {})
        if "links9" not in cache:
            e = 2 * self.nc
            mats = [interleave_mat(self.x_diag)] + \
                [interleave_mat(self.y[d]) for d in DIRS]
            cache["links9"] = torch.stack(mats).reshape(9, -1, e,
                                                        e).contiguous()
        return cache["links9"]

    def psi9(self, v: torch.Tensor) -> torch.Tensor:
        """(..., latc, 2, N, 2) -> the (..., 9, S, E) stack B8 reads: the
        interleaved input and its 8 neighbour copies, in DIRS order."""
        e = 2 * self.nc
        fi = v.reshape(v.shape[:-3] + (e,))
        rolls = [fi] + [_roll(fi, mu, sign, 1) for mu, sign in DIRS]
        return torch.stack(rolls, dim=-6).reshape(v.shape[:-7] + (9, -1, e))

    def M(self, v):
        if not self.use_kernel:
            out = self.diag(v)
            for mu, sign in DIRS:
                out = out + self.hop(v, mu, sign)
            return out
        if v.ndim == 7:
            return coarse_apply_pallas(self.links9(),
                                       self.psi9(v)).reshape(v.shape)
        batch = v.reshape((-1,) + v.shape[-7:])
        out = coarse_apply_pallas_mrhs(self.links9(), self.psi9(batch))
        return out.reshape(v.shape)

    def gamma5(self, v):
        sign = torch.tensor([1.0, -1.0], dtype=v.dtype, device=v.device)
        return v * sign[:, None, None]

    def Mdag(self, v):
        if not self.g5_hermitian:
            raise NotImplementedError
        return self.gamma5(self.M(self.gamma5(v)))

    def MdagM(self, v):
        return self.Mdag(self.M(v))


def _check_extents(latc):
    for mu in range(4):
        ext = latc[axis_of_mu(mu)]
        if ext != 1 and ext % 2 != 0:
            raise ValueError(
                f"coarse extent {ext} along mu={mu} must be even or 1")


def build_coarse_pairs(fine_parts, transfer: PairTransfer,
                       g5_hermitian: bool = True) -> PairCoarseOperator:
    """Probing construction of the coarse stencil (the JAX package's
    legacy construction, kept as the reference of mg/gemm.py's): per coarse
    unit column, R diag P, and each direction's R hop P probed twice with
    the coarse sites masked by their parity along mu (unlit sites give
    the link column, lit sites the intra-block diagonal part)."""
    latc = transfer.coarse_shape
    n = transfer.n_vec
    nc = 2 * n
    dev = transfer.v.device
    _check_extents(latc)

    def probe_diag(vc):
        return transfer.restrict(fine_parts.diag(transfer.prolong(vc)))

    def probe_hop(vc, mu, sign):
        return transfer.restrict(
            fine_parts.hop(transfer.prolong(vc), mu, sign))

    def coord_parity(mu):
        ax = axis_of_mu(mu)
        shape = [1, 1, 1, 1]
        shape[ax] = latc[ax]
        c = np.arange(latc[ax]).reshape(shape) % 2
        return torch.as_tensor(np.broadcast_to(c, latc).copy(), device=dev)

    def as_col(out):                  # (latc, 2, n, 2) -> (latc, nc, 2)
        return out.reshape(tuple(latc) + (nc, 2))

    diag_cols = []
    hop_cols = {d: [] for d in DIRS}
    for chir in range(2):
        for b in range(n):
            e = torch.zeros(tuple(latc) + (2, n, 2), dtype=F32, device=dev)
            e[..., chir, b, 0] = 1.0
            dcol = as_col(probe_diag(e))
            for mu, sign in DIRS:
                if latc[axis_of_mu(mu)] == 1:
                    hop_cols[(mu, sign)].append(
                        as_col(probe_hop(e, mu, sign)))
                    continue
                par = coord_parity(mu)
                ycol = torch.zeros(tuple(latc) + (nc, 2), dtype=F32,
                                   device=dev)
                for p in (0, 1):
                    mask = (par == p).to(F32)[..., None, None, None]
                    out = as_col(probe_hop(e * mask, mu, sign))
                    lit = (par == p)[..., None, None]
                    ycol = torch.where(lit, ycol, out)
                    dcol = dcol + torch.where(lit, out,
                                              torch.zeros_like(out))
                hop_cols[(mu, sign)].append(ycol)
            diag_cols.append(dcol)
    x_diag = torch.stack(diag_cols, dim=-2)         # (latc, Nc, Nc, 2)
    y = {d: torch.stack(hop_cols[d], dim=-2) for d in DIRS}
    return PairCoarseOperator(x_diag, y, n, g5_hermitian)


# -- the fine Wilson level --------------------------------------------------

def wilson_hop_pairs(gauge_pairs, psi, mu, sign, kappa):
    """-kappa * the single-direction Wilson hop on (..., T,Z,Y,X, 4,3,2)
    pair arrays (the pair mirror of DiracWilson.hop)."""
    if sign > 0:
        u = gauge_pairs[mu]
        proj = g.PROJ_MINUS[mu]
        h = color_mul_pairs(u, _roll(psi, mu, +1, 3))
    else:
        u = _roll(dagger_pairs(gauge_pairs[mu]), mu, -1, 3)
        proj = g.PROJ_PLUS[mu]
        h = color_mul_pairs(u, _roll(psi, mu, -1, 3))
    return -kappa * spin_mul_pairs(proj, h)


_G5 = {}


def _g5_spin(device) -> torch.Tensor:
    """gamma5 signs over the spin axis of (..., 4, 3, 2) fields."""
    s = _G5.get(str(device))
    if s is None:
        s = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=F32,
                         device=device)[:, None, None]
        _G5[str(device)] = s
    return s


class PairWilsonLevelOp:
    """The fine Wilson level on pair arrays (K = 6 chiral components,
    gamma5 = the chirality sign).

    The standard layout is canonical pair spinors (..., T,Z,Y,X,4,3,2);
    the gauge, its t-boundary phase folded in by the wrapped DiracWilson,
    is converted once: f32 pairs for the probes' single-direction hops,
    and the kernel layout with its pre-shifted backward copy for the hop
    sum, which every apply runs through B4 (one transpose of the field
    into the kernel layout (4,3,2,T,Z,Y*X) and one back) and, for a
    batch, through B5 (``M_mrhs_pl``, ``MdagM_mrhs_pl``: the null-vector
    block solve, in the kernel layout, every link read once per chunk of
    right-hand sides).
    """

    k_fine = 6
    dtype = F32

    def __init__(self, dirac):
        self.dirac = dirac
        self.kappa = float(dirac.kappa)
        self.gauge_pairs = to_pairs(dirac.gauge, F32)
        self.device = dirac.gauge.device
        self._X = int(dirac.geom.lattice_shape[-1])
        self.gauge_pl = wpp.to_pallas_layout(
            wpk.pack_gauge(dirac.gauge)).contiguous()
        self.gauge_bw = wpp.backward_gauge(self.gauge_pl,
                                           self._X).contiguous()

    def to_chiral(self, v):
        return to_chiral_pairs(v)

    def from_chiral(self, v):
        return from_chiral_pairs(v)

    # -- kernel-layout shuttles ----------------------------------------
    @staticmethod
    def _pl_of(v):
        """canonical pairs (..., T,Z,Y,X,4,3,2) -> kernel layout
        (..., 4,3,2,T,Z,YX), contiguous."""
        k = v.ndim - 7
        T, Z, Y, X = v.shape[k:k + 4]
        lead = tuple(range(k))
        perm = lead + tuple(k + i for i in (4, 5, 6, 0, 1, 2, 3))
        return v.permute(perm).reshape(
            v.shape[:k] + (4, 3, 2, T, Z, Y * X)).contiguous()

    @staticmethod
    def _pl_back(out, lat):
        T, Z, Y, X = lat
        k = out.ndim - 6
        o = out.reshape(out.shape[:k] + (4, 3, 2, T, Z, Y, X))
        lead = tuple(range(k))
        perm = lead + tuple(k + i for i in (3, 4, 5, 6, 0, 1, 2))
        return o.permute(perm).contiguous()

    # -- standard (canonical pair) layout ------------------------------
    def _d_std(self, v):
        d = wpp.dslash_pallas_packed(self.gauge_pl, self._pl_of(v), self._X,
                                     gauge_bw=self.gauge_bw)
        return self._pl_back(d, v.shape[-7:-3])

    def M_std(self, v):
        return torch.add(v, self._d_std(v), alpha=-self.kappa)

    def Mdag_std(self, v):
        sgn = _g5_spin(v.device)
        return sgn * self.M_std(sgn * v)

    # -- batched forms (the null-vector block solve's matvec) ----------
    # The block solve runs in the kernel layout (N,4,3,2,T,Z,Y*X): its
    # batch is moved there once, so each matvec is one B5 launch and an
    # axpy, with no transpose (mg/mg.py, ``mrhs_layout``).
    def to_mrhs_layout(self, Vc):
        """(N, lat, 2, 6, 2) chiral batch -> (N, 4,3,2, T,Z,YX)."""
        return self._pl_of(from_chiral_pairs(Vc))

    def from_mrhs_layout(self, P):
        lat = self.dirac.geom.lattice_shape
        return to_chiral_pairs(self._pl_back(P, lat))

    def _d_mrhs_pl(self, P):
        return wpp.dslash_pallas_packed_mrhs(self.gauge_pl, P, self._X,
                                             gauge_bw=self.gauge_bw)

    def M_mrhs_pl(self, P):
        """M per RHS of a kernel-layout batch, one B5 launch."""
        return torch.add(P, self._d_mrhs_pl(P), alpha=-self.kappa)

    def MdagM_mrhs_pl(self, P):
        """MdagM = g5 M g5 M per RHS of a kernel-layout batch, two B5
        launches."""
        g5 = _g5_spin(P.device)[..., None, None, None]
        gm = g5 * self.M_mrhs_pl(P)
        return g5 * self.M_mrhs_pl(gm)

    def M_mrhs(self, Vc):
        """(N, lat, 2, 6, 2) chiral batch -> M per RHS, one B5 launch."""
        return self.from_mrhs_layout(self.M_mrhs_pl(self.to_mrhs_layout(Vc)))

    def MdagM_mrhs(self, Vc):
        """(N, lat, 2, 6, 2) chiral batch -> MdagM per RHS, two B5
        launches."""
        return self.from_mrhs_layout(
            self.MdagM_mrhs_pl(self.to_mrhs_layout(Vc)))

    # -- chiral layout (the hierarchy's view) --------------------------
    def M(self, v):
        return to_chiral_pairs(self.M_std(from_chiral_pairs(v)))

    def MdagM(self, v):
        s = from_chiral_pairs(v)
        return to_chiral_pairs(self.Mdag_std(self.M_std(s)))

    def diag(self, v):
        return v

    def hop(self, v, mu, sign):
        s = from_chiral_pairs(v)
        return to_chiral_pairs(
            wilson_hop_pairs(self.gauge_pairs, s, mu, sign, self.kappa))


# -- the fine staggered level -----------------------------------------------

def staggered_hop_pairs(links_pairs, psi, mu, sign):
    """The single-direction staggered hop on (..., T,Z,Y,X, 1,3,2) pair
    arrays (the pair mirror of ops/staggered.hop_term): +1/2 U_mu(x)
    psi(x + mu), or -1/2 U_mu(x - mu)^dag psi(x - mu)."""
    if sign > 0:
        return 0.5 * color_mul_pairs(links_pairs[mu], _roll(psi, mu, +1, 3))
    ub = _roll(dagger_pairs(links_pairs[mu]), mu, -1, 3)
    return -0.5 * color_mul_pairs(ub, _roll(psi, mu, -1, 3))


class PairStaggeredLevelOp:
    """The fine staggered level on pair arrays: K = 3 colours, the
    chirality is the site parity epsilon(x) (mg/mg.parity_eps), chiral
    fields (..., lat, 2, 3, 2) with the even-site part in component 0.

    The hierarchy represents the fat-link stencil M = 2m + D_fat (QUDA's
    coarse construction, lib/staggered_coarse_op.in.cu); with long links
    ``M_std_full`` applies the full fat + Naik operator, which the outer
    solve runs, so the fat-only V-cycle defect-corrects the Naik term
    (mg_solve_pairs).  Standard layout: (..., T,Z,Y,X, 1,3,2) pairs.  The
    fat links go resident in the kernel layout with their pre-shifted
    backward copy: the fat hop sum is one S2-full launch (one transpose of
    the field in and one out), a batch in the kernel layout one
    S2-mrhs-full launch (``M_mrhs_pl``: the null-vector block solve,
    transposed once); the fat + Naik D is one S1-full launch on the
    unshifted fat and long links.  The probes' single-direction hops and
    ``diag`` run plain PyTorch, as in the JAX package.

    The chiral space (lat, 2, 3) is twice the image of ``to_chiral``: a
    field whose two components cancel under ``from_chiral`` is
    annihilated by M.  ``project_null_source`` maps a field onto the
    image; the set-up projects its random initial guesses with it."""

    k_fine = 3
    dtype = F32
    nspin = 1

    def __init__(self, dirac):
        self.dirac = dirac
        self.mass = float(dirac.mass)
        self.device = dirac.fat.device
        self._X = int(dirac.geom.lattice_shape[-1])
        self.fat_pairs = to_pairs(dirac.fat, F32)

        def packed(links):
            return wpk.to_packed_pairs(spk.pack_links(links),
                                       F32).contiguous()

        self.fat_pl = packed(dirac.fat)
        self.fat_bw = spl.backward_links(self.fat_pl, self._X,
                                         1).contiguous()
        lng = getattr(dirac, "long", None)
        self.long_pl = packed(lng) if lng is not None else None
        eps = torch.as_tensor(parity_eps(dirac.geom.lattice_shape, 2),
                              device=self.device)
        self._even = eps == 0                       # (T,Z,Y,X,1,1)

    # -- kernel-layout shuttles ----------------------------------------
    @staticmethod
    def _pl_of(v):
        """canonical pairs (..., T,Z,Y,X,1,3,2) -> kernel layout
        (..., 3,2,T,Z,YX), contiguous."""
        s = v[..., 0, :, :]
        k = s.ndim - 6
        T, Z, Y, X = s.shape[k:k + 4]
        perm = tuple(range(k)) + tuple(k + i for i in (4, 5, 0, 1, 2, 3))
        return s.permute(perm).reshape(
            s.shape[:k] + (3, 2, T, Z, Y * X)).contiguous()

    @staticmethod
    def _pl_back(out, lat):
        T, Z, Y, X = lat
        k = out.ndim - 5
        o = out.reshape(out.shape[:k] + (3, 2, T, Z, Y, X))
        perm = tuple(range(k)) + tuple(k + i for i in (2, 3, 4, 5, 0, 1))
        return o.permute(perm).unsqueeze(-3).contiguous()

    # -- standard layout (..., lat, 1, 3, 2) ----------------------------
    def _d_std(self, v):
        """The fat hop sum, one S2-full launch."""
        d = spl.dslash_staggered_pallas(self.fat_pl, self.fat_bw,
                                        self._pl_of(v), self._X)
        return self._pl_back(d, v.shape[-7:-3])

    def M_std(self, v):
        return torch.add(self._d_std(v), v, alpha=2.0 * self.mass)

    def _mdag_std(self, v):
        return torch.add(-self._d_std(v), v, alpha=2.0 * self.mass)

    def _d_std_full(self, v):
        """The fat + Naik hop sum, one S1-full launch."""
        d = spl.dslash_staggered_pallas_fused(self.fat_pl, self._pl_of(v),
                                              self._X, self.long_pl)
        return self._pl_back(d, v.shape[-7:-3])

    def M_std_full(self, v):
        """The operator the outer solve targets: fat + Naik when long
        links exist, else ``M_std``."""
        if self.long_pl is None:
            return self.M_std(v)
        return torch.add(self._d_std_full(v), v, alpha=2.0 * self.mass)

    def Mdag_std_full(self, v):
        if self.long_pl is None:
            return self._mdag_std(v)
        return torch.add(-self._d_std_full(v), v, alpha=2.0 * self.mass)

    # -- batched forms in the kernel layout (N, 3,2,T,Z,YX) -------------
    def to_mrhs_layout(self, Vc):
        """(N, lat, 2, 3, 2) chiral batch -> (N, 3,2,T,Z,YX)."""
        return self._pl_of(self.from_chiral(Vc))

    def from_mrhs_layout(self, P):
        lat = self.dirac.geom.lattice_shape
        return self.to_chiral(self._pl_back(P, lat))

    def _d_mrhs_pl(self, P):
        return spl.dslash_staggered_pallas_mrhs(self.fat_pl, self.fat_bw, P,
                                                self._X)

    def M_mrhs_pl(self, P):
        """2m + D_fat per RHS of a kernel-layout batch, one S2-mrhs-full
        launch."""
        return torch.add(self._d_mrhs_pl(P), P, alpha=2.0 * self.mass)

    def MdagM_mrhs_pl(self, P):
        """(2m - D)(2m + D) per RHS, two S2-mrhs-full launches."""
        ms = self.M_mrhs_pl(P)
        return torch.add(-self._d_mrhs_pl(ms), ms, alpha=2.0 * self.mass)

    def M_mrhs(self, Vc):
        return self.from_mrhs_layout(self.M_mrhs_pl(self.to_mrhs_layout(Vc)))

    def MdagM_mrhs(self, Vc):
        return self.from_mrhs_layout(
            self.MdagM_mrhs_pl(self.to_mrhs_layout(Vc)))

    # -- chiral layout (the hierarchy's view) --------------------------
    def to_chiral(self, v):
        s = v[..., 0, :, :]
        zero = torch.zeros((), dtype=s.dtype, device=s.device)
        even = torch.where(self._even, s, zero)
        odd = torch.where(self._even, zero, s)
        return torch.stack([even, odd], dim=-3)

    def from_chiral(self, vc):
        return (vc[..., 0, :, :] + vc[..., 1, :, :]).unsqueeze(-3)

    def M(self, v):
        return self.to_chiral(self.M_std(self.from_chiral(v)))

    def MdagM(self, v):
        s = self.from_chiral(v)
        return self.to_chiral(self._mdag_std(self.M_std(s)))

    def diag(self, v):
        # through the chiral round trip, as the JAX adapter: M = diag +
        # sum(hop) must hold as chiral-space operators for the probes
        return self.to_chiral(2.0 * self.mass * self.from_chiral(v))

    def hop(self, v, mu, sign):
        return self.to_chiral(staggered_hop_pairs(
            self.fat_pairs, self.from_chiral(v), mu, sign))

    def project_null_source(self, bs):
        """The image of ``to_chiral``: the part of a chiral field that M
        sees (the rest is annihilated by M)."""
        return self.to_chiral(self.from_chiral(bs))


# -- the hierarchy ----------------------------------------------------------

class PairMG(MG):
    """Complex-free multigrid hierarchy: the V-cycle, set-up and verify of
    mg/mg.MG on pair arrays.  Set-up: batched BiCGStab (or CG) on the
    realified fine operator, CholQR2 block orthonormalisation, the GEMM
    probes of mg/gemm.py."""

    _transfer_from_nulls = staticmethod(PairTransfer.from_null_vectors)

    @staticmethod
    def _build_coarse_gemm(parts, transfer):
        from .gemm import build_coarse_pairs_gemm
        return build_coarse_pairs_gemm(parts, transfer)

    def _example_field(self, lat_shape, k, dtype, device):
        """Zero chiral pair field (lat, 2, k, 2)."""
        return torch.zeros(tuple(lat_shape) + (2, k, 2), dtype=dtype,
                           device=device)

    @staticmethod
    def _adapt(fine_dirac, kd: bool = False):
        """The fine level of ``fine_dirac``, by its ``nspin``: staggered
        (1) or Wilson."""
        from ..models.wilson import DiracWilson
        if getattr(fine_dirac, "nspin", 4) == 1:
            if kd:
                raise NotImplementedError(
                    "pair staggered MG: the Kaehler-Dirac composition "
                    "(mg/staggered_kd.py) is not ported, and the JAX "
                    "package's pair hierarchy refuses it too (ROADMAP A12)")
            return PairStaggeredLevelOp(fine_dirac)
        if type(fine_dirac) is not DiracWilson:
            raise NotImplementedError(
                f"pair multigrid for {type(fine_dirac).__name__}: the port "
                "serves Wilson and the staggered family; clover and the "
                "other families wait for the complex hierarchy (ROADMAP "
                "A12)")
        return PairWilsonLevelOp(fine_dirac)

    @classmethod
    def from_arrays(cls, dirac, params: Sequence[MGLevelParam],
                    levels: Sequence[dict]) -> "PairMG":
        """A hierarchy from arrays instead of a set-up: for each level,
        ``{"v": (latc,2,D,N,2), "x_diag": (latc,Nc,Nc,2),
        "y": {(mu, sign): (latc,Nc,Nc,2)}}``, numpy or tensors (for
        instance read out of another implementation's hierarchy), put on
        the Dirac operator's device in float32."""
        self = object.__new__(cls)
        self.geom = dirac.geom
        self.params = list(params)
        self.adapter = cls._adapt(dirac)
        self.levels = []
        self.null_fallbacks = []
        self.setup_breakdown = []
        self.setup_seconds = 0.0
        dev = self.adapter.device

        def t(a):
            if isinstance(a, torch.Tensor):
                return a.to(device=dev, dtype=F32)
            return torch.as_tensor(np.array(a, dtype=np.float32),
                                   device=dev)

        op = self.adapter
        lat = tuple(self.geom.lattice_shape)
        k = op.k_fine
        for p, lv in zip(self.params, levels):
            transfer = PairTransfer(t(lv["v"]).contiguous(), tuple(p.block),
                                    lat, k, p.n_vec)
            coarse = PairCoarseOperator(t(lv["x_diag"]),
                                        {d: t(lv["y"][d]) for d in DIRS},
                                        p.n_vec)
            self.levels.append(dict(op=op, transfer=transfer, coarse=coarse,
                                    param=p))
            op, lat, k = coarse, transfer.coarse_shape, p.n_vec
        return self


def outer_operator(level_op):
    """The operator the outer solve applies: the fat + Naik
    ``M_std_full`` of an improved staggered level, else ``M_std``."""
    return getattr(level_op, "M_std_full", level_op.M_std)


def mg_solve_pairs(fine_dirac, geom, b_pairs, params: Sequence[MGLevelParam],
                   tol: float = 1e-6, nkrylov: int = 16,
                   max_restarts: int = 100, generator=None,
                   mg: Optional[PairMG] = None):
    """Outer GCR on canonical pair spinors, (T,Z,Y,X,4,3,2) Wilson or
    (T,Z,Y,X,1,3,2) staggered, of ``fine_dirac``'s system (a DiracWilson,
    a DiracStaggered or their level operator), preconditioned by the pair
    MG V-cycle of ``mg`` (set up on ``fine_dirac`` when None; a given
    hierarchy may have been built on another operator, as after a change
    of kappa or mass).  Improved staggered runs the outer GCR on the full
    fat + Naik operator while the fat-only hierarchy preconditions
    (flexible-Krylov defect correction of the Naik term, the JAX package's
    and QUDA's improved-staggered MG wiring).  Returns (SolverResult with
    pair x, mg)."""
    from ..solvers.gcr import gcr
    if mg is None:
        mg = PairMG(fine_dirac, geom, params, generator)
    if hasattr(fine_dirac, "k_fine"):
        outer = fine_dirac
    elif fine_dirac is mg.adapter.dirac:
        outer = mg.adapter
    else:
        outer = PairMG._adapt(fine_dirac)
    res = gcr(outer_operator(outer), b_pairs, precond=mg.precondition,
              tol=tol, nkrylov=nkrylov, max_restarts=max_restarts)
    return res, mg
