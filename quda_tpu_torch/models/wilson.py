"""Wilson Dirac operator (full and even/odd preconditioned).

Port of the single-device, full-storage part of quda_tpu/models/wilson.py.
Kappa normalisation M = 1 - kappa D; the PC operator on parity p is

    M_pc x_p = x_p - kappa^2 D_{p,1-p} D_{1-p,p} x_p

with b_pc = b_p + kappa D_{p,1-p} b_{1-p} and
x_{1-p} = b_{1-p} + kappa D_{1-p,p} x_p.

The packed pair operator (``DiracWilsonPCPackedSloppy``, reached through
``DiracWilsonPCPacked.pairs``) runs every hop through the CUDA kernel's
wrapper (ops/wilson_pallas_packed.dslash_eo_pallas_packed): on the card
the kernel, on CPU tensors its plain version.  Its storage is float32
(the precise operator), bfloat16 (the sloppy operator of mixed
precision) or float64 (the precise operator of the native double
routes, full links, sums in float64), with full or reconstruct-12 links.
Its link forms (``precision_form``, and ``pallas_version``) follow the
JAX package's: "full" and "r12" keep a resident pre-shifted backward
copy and run B1 (``pallas_version`` 2) or read the opposite parity's
links directly on the copy-free hop v3 (3); "r12f" is recon-12 on the
copy-free hop; "int8" stores int8 block-float links (QUDA "quarter") and
runs the int8 hop; "fold" keeps full links and their backward copy in the
folded layout (``to_fold``: re/im interleaved into z) and runs the fold
hop, each call folding psi in and the hop out.
``DiracWilsonPCPacked.D_to/M/Mdag/MdagM`` act on complex packed fields
through it.  The full-lattice operator's pair companion
(``DiracWilsonPackedPairs``, ``DiracWilson.pairs``) runs the full-lattice
hop B4 (``dslash_pallas_packed``): the operator API's ``mat_quda`` and
``mat_dag_mat_quda``.  ``_SchurPairOpBase``
is the same hop under a Schur operator with a diagonal (the clover and
twisted families, models/clover.py and models/twisted.py), whose two
hops per apply run the fused clover kernel.  Every pair operator also has ``_mrhs`` forms on a leading axis of
N right-hand sides, (N,4,3,2,T,Z,Y*Xh): the same composition, each hop one
launch of a multi-RHS kernel (B5-eo, or the fused clover B7-mrhs), the
glue broadcast over that axis.

On a mesh (``DiracWilsonPCPacked.pairs(..., mesh=, sharded_policy=)``,
parallel/mesh.py) the pair operator shards its links once and every hop
is the sharded eo hop of parallel/pallas_dslash.py in the same kernel
form, on ShardedFields (``shard``, ``gather``); the Schur glue runs block
by block, so ``fused_cg`` solves on the mesh unchanged.
"""

from __future__ import annotations

import logging

import torch

from ..fields.geometry import EVEN, LatticeGeometry
from ..ops import wilson as wops
from ..ops import wilson_packed as wpk
from ..ops import wilson_pallas_packed as wpp
from ..ops.blockfloat import to_int8_links
from ..ops.boundary import apply_t_boundary
from .dirac import MATPC_EVEN_EVEN, Dirac, DiracPC

log = logging.getLogger("quda_tpu_torch")

STORE_DTYPES = (torch.float32, torch.bfloat16)
# the Wilson pair operators also take float64 (B1 and B4's double form)
WILSON_STORE_DTYPES = STORE_DTYPES + (torch.float64,)
PRECISION_FORMS = ("full", "r12", "r12f", "int8", "fold")
# the link forms with a resident pre-shifted backward copy: all that the
# fused clover and twist hops (K1/K2), the domain-wall hop and B4 serve
RESIDENT_FORMS = ("full", "r12")
# forms of the JAX package's packed operator that wait, and for what
QUEUED_FORMS = {
    "auto": "ROADMAP A17 (the tuner's race of the forms)",
    "bzfull": "ROADMAP A17 (a TPU block admission the tuner races)"}
PALLAS_VERSIONS = (2, 3)
# the link forms the sharded eo hops serve on a mesh (parallel/pallas_dslash)
MESH_FORMS = ("full", "r12")

# gamma5 sign tensors, one per (device, ndim, spin axis): built once, so
# an apply makes no host-to-device copy
_G5_SIGNS: dict = {}


def _g5_sign(device, ndim: int, spin_axis: int) -> torch.Tensor:
    key = (device, ndim, spin_axis)
    sign = _G5_SIGNS.get(key)
    if sign is None:
        shape = [1] * ndim
        shape[spin_axis] = 4
        sign = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=torch.float32,
                            device=device).reshape(shape)
        _G5_SIGNS[key] = sign
    return sign


def _check_double_form(store_dtype, precision_form: str,
                       pallas_version: int = 2) -> None:
    if store_dtype == torch.float64 and (precision_form != "full"
                                         or pallas_version != 2):
        raise NotImplementedError(
            f"precision_form {precision_form!r} (pallas_version "
            f"{pallas_version}) in float64: the double forms of B1 and B4 "
            "take full pre-shifted links; recon-12, the copy-free, the "
            "int8 and the fold forms under double wait for ROADMAP A7")


def _mesh_version(mesh, precision_form: str, store_dtype,
                  pallas_version: int) -> int:
    """What the sharded eo hops serve: full and r12 links, float32 and
    bfloat16 storage; the pallas_version, clamped to 2 (with a notice, as
    the JAX package does) on a y- or x-partitioned mesh, where the v3
    scatter exterior has no face fix."""
    if precision_form not in MESH_FORMS:
        raise NotImplementedError(
            f"precision_form {precision_form!r} on a mesh: the sharded eo "
            f"hops serve {MESH_FORMS}; the copy-free, int8 and fold forms "
            "on a mesh wait for ROADMAP A15")
    if store_dtype not in STORE_DTYPES:
        raise NotImplementedError(
            f"pair storage {store_dtype} on a mesh: the sharded eo hops "
            f"take {STORE_DTYPES}; float64 waits for ROADMAP A7")
    if pallas_version == 3 and (mesh.shape["y"] > 1 or mesh.shape["x"] > 1):
        log.info("mesh dslash: the pallas v3 exterior shards t/z only; the "
                 "y/x-partitioned mesh %s clamps to the v2 gather form",
                 mesh.grid)
        return 2
    return pallas_version


class DiracWilson(Dirac):
    """Full-lattice Wilson operator M = 1 - kappa D."""

    def __init__(self, gauge: torch.Tensor, geom: LatticeGeometry,
                 kappa: float, antiperiodic_t: bool = True):
        self.geom = geom
        self.kappa = kappa
        self.antiperiodic_t = antiperiodic_t
        self.gauge = apply_t_boundary(gauge, geom, -1 if antiperiodic_t else 1)

    def D(self, psi):
        return wops.dslash_full(self.gauge, psi)

    def M(self, psi):
        return psi - self.kappa * self.D(psi)

    # --- diag + per-direction hop decomposition (MG coarsening probes) ---
    def diag(self, psi):
        return psi

    def hop(self, psi, mu: int, sign: int):
        """-kappa * the single-direction Wilson hop (M = diag + sum hops)."""
        from ..ops.gamma import PROJ_MINUS, PROJ_PLUS
        from ..ops.shift import shift
        from ..ops.su3 import dagger
        if sign > 0:
            u = self.gauge[mu]
            proj = PROJ_MINUS[mu]
            h = torch.einsum("...ab,...sb->...sa", u, shift(psi, mu, +1))
        else:
            u = shift(dagger(self.gauge[mu]), mu, -1)
            proj = PROJ_PLUS[mu]
            h = torch.einsum("...ab,...sb->...sa", u, shift(psi, mu, -1))
        proj = torch.as_tensor(proj, dtype=psi.dtype, device=psi.device)
        return -self.kappa * torch.einsum("st,...tc->...sc", proj, h)

    def flops_per_site_M(self) -> int:
        return 1320 + 48

    def pairs(self, store_dtype=torch.float32,
              precision_form: str = "full") -> "DiracWilsonPackedPairs":
        """Pair companion on the full packed lattice, every hop on B4:
        float32 (full or recon-12 links) or float64 (full)."""
        return DiracWilsonPackedPairs(self, store_dtype, precision_form)


class DiracWilsonPC(DiracPC):
    """Even/odd preconditioned Wilson operator on parity ``matpc``."""

    def __init__(self, gauge: torch.Tensor, geom: LatticeGeometry,
                 kappa: float, antiperiodic_t: bool = True,
                 matpc: int = MATPC_EVEN_EVEN):
        self.geom = geom
        self.kappa = kappa
        self.matpc = matpc
        self.antiperiodic_t = antiperiodic_t
        g = apply_t_boundary(gauge, geom, -1 if antiperiodic_t else 1)
        self.gauge_eo = wops.split_gauge_eo(g, geom)

    @classmethod
    def from_eo(cls, gauge_eo, geom: LatticeGeometry, kappa: float,
                matpc: int = MATPC_EVEN_EVEN):
        """Construct from pre-split (even, odd) links, boundary phase
        already folded in."""
        self = object.__new__(cls)
        self.geom = geom
        self.kappa = kappa
        self.matpc = matpc
        self.antiperiodic_t = True
        self.gauge_eo = gauge_eo
        return self

    def D_to(self, psi, target_parity):
        """Hop from parity (1-target) into target parity."""
        return wops.dslash_eo(self.gauge_eo, psi, self.geom, target_parity)

    def M(self, x_p):
        p = self.matpc
        tmp = self.D_to(x_p, 1 - p)
        return x_p - (self.kappa ** 2) * self.D_to(tmp, p)

    def prepare(self, b_even, b_odd):
        p = self.matpc
        b_p, b_q = (b_even, b_odd) if p == EVEN else (b_odd, b_even)
        return b_p + self.kappa * self.D_to(b_q, p)

    def reconstruct(self, x_p, b_even, b_odd):
        p = self.matpc
        b_q = b_odd if p == EVEN else b_even
        x_q = b_q + self.kappa * self.D_to(x_p, 1 - p)
        return (x_p, x_q) if p == EVEN else (x_q, x_p)

    def flops_per_site_M(self) -> int:
        return 2 * 1320 + 48

    def packed(self, precision_form: str = "full") -> "DiracWilsonPCPacked":
        return DiracWilsonPCPacked(self, precision_form)


class _PairSloppyBase:
    """Schur composition on pair storage, written once for every layout.

    Subclasses supply ``_d_to`` (the stencil) and ``_spin_axis``."""

    store_dtype = torch.float32
    _spin_axis: int

    def _d_to(self, psi_pairs, target_parity, out_dtype):
        raise NotImplementedError

    def _d_to_mrhs(self, psi_b, target_parity, out_dtype):
        """The stencil on a batch (N, ...) of right-hand sides."""
        raise NotImplementedError

    @property
    def _acc(self):
        """The glue's arithmetic: float32, float64 for float64 storage."""
        return wpk.compute_dtype(self.store_dtype)

    def _M_with(self, x, d_to):
        """x - kappa^2 D_p D_{1-p} x, on hop ``d_to``."""
        p = self.matpc
        tmp = d_to(x, 1 - p, self.store_dtype)
        dd = d_to(tmp, p, self._acc)
        out = x.to(self._acc) - (self.kappa ** 2) * dd
        return out.to(self.store_dtype)

    def M_pairs(self, x):
        return self._M_with(x, self._d_to)

    @staticmethod
    def _g5_on(x, spin_axis):
        """gamma5 = diag(+1,+1,-1,-1) on ``spin_axis``, computed in f32
        (f64 for f64 x) and cast back to x's dtype."""
        cdt = wpk.compute_dtype(x.dtype)
        sign = _g5_sign(x.device, x.ndim, spin_axis).to(cdt)
        return (x.to(cdt) * sign).to(x.dtype)

    def _g5_pairs(self, x):
        return self._g5_on(x, self._spin_axis % x.ndim)

    def Mdag_pairs(self, x):
        return self._g5_pairs(self.M_pairs(self._g5_pairs(x)))

    def MdagM_pairs(self, x):
        return self.Mdag_pairs(self.M_pairs(x))

    # -- multi-RHS forms: a leading axis of N right-hand sides ------------
    def _g5_pairs_mrhs(self, x):
        return self._g5_on(x, self._spin_axis % (x.ndim - 1) + 1)

    def M_pairs_mrhs(self, x):
        return self._M_with(x, self._d_to_mrhs)

    def Mdag_pairs_mrhs(self, x):
        return self._g5_pairs_mrhs(self.M_pairs_mrhs(self._g5_pairs_mrhs(x)))

    def MdagM_pairs_mrhs(self, x):
        return self.Mdag_pairs_mrhs(self.M_pairs_mrhs(x))


class _PackedHopMixin:
    """The packed eo Wilson hop on pair arrays: gauge setup, the stencil
    dispatch, and the canonical <-> packed spinor converters.  Single
    device; float32 or bfloat16 storage (float64 for Wilson); the link
    forms of ``PRECISION_FORMS``."""

    _spin_axis = 0

    def _setup_hop(self, geom: LatticeGeometry, gauge_eo_packed,
                   store_dtype, tb_sign: bool = True,
                   precision_form: str = "full",
                   store_dtypes=STORE_DTYPES, pallas_version: int = 2,
                   forms=RESIDENT_FORMS, mesh=None,
                   sharded_policy="auto"):
        """gauge_eo_packed: (even, odd) complex packed (4,3,3,T,Z,Y*Xh)
        links (wilson_packed.pack_gauge_eo), boundary phase folded in.
        ``precision_form``: "full" (18 reals per link), "r12" (two rows,
        row 2 rebuilt in the hop), "r12f" (r12 on the copy-free hop),
        "int8" (block-float links, ops/blockfloat.to_int8_links of the
        storage-dtype links) or "fold" (full links and their backward copy
        folded, wilson_pallas_packed.to_fold); ``forms`` names those the
        operator serves.  ``pallas_version`` 2 keeps a resident pre-shifted
        backward copy (B1), 3 reads the opposite parity's links on the
        copy-free hop; r12f and int8 build no backward copy and fold keeps
        one whatever it says, as in the JAX package.  ``tb_sign``: the t
        boundary is antiperiodic, so the recon-12 hop negates the rebuilt
        row of the boundary t links.  ``mesh`` (parallel/mesh.LatticeMesh
        of more than one sub-domain) shards the links once here and runs
        every hop as the sharded eo hop (``_setup_mesh``)."""
        if store_dtype not in store_dtypes:
            raise NotImplementedError(
                f"pair storage {store_dtype}: {store_dtypes} are ported "
                "here; the clover and staggered double forms wait for "
                "ROADMAP A7")
        form = precision_form
        if form in QUEUED_FORMS:
            raise NotImplementedError(
                f"precision_form {form!r} is not ported yet: "
                f"{QUEUED_FORMS[form]}; the port serves {PRECISION_FORMS}")
        if form not in PRECISION_FORMS:
            raise ValueError(f"unknown precision_form {form!r}")
        if pallas_version not in PALLAS_VERSIONS:
            raise ValueError(f"pallas_version must be 2 or 3, got "
                             f"{pallas_version}")
        if form not in forms:
            raise NotImplementedError(
                f"precision_form {form!r} for {type(self).__name__}: its "
                f"hop reads pre-shifted backward links, forms {forms}; the "
                "copy-free, int8 and fold forms of the other families wait "
                "for ROADMAP A7")
        _check_double_form(store_dtype, form, pallas_version)
        if mesh is not None and mesh.size == 1:
            mesh = None          # one sub-domain shards nothing
        if mesh is not None:
            pallas_version = _mesh_version(mesh, form, store_dtype,
                                           pallas_version)
        self._mesh = None
        self._setup_links(geom, gauge_eo_packed, store_dtype, tb_sign, form,
                          pallas_version)
        if mesh is not None:
            self._setup_mesh(mesh, sharded_policy)

    def _setup_links(self, geom, gauge_eo_packed, store_dtype, tb_sign,
                     form, pallas_version):
        """The resident links of ``form`` (and the backward copy where the
        form keeps one), on the global lattice."""
        self.geom = geom
        self.dims = tuple(geom.lattice_shape)
        self.store_dtype = store_dtype
        self._precision_form = form
        self._pallas_version = pallas_version
        self._tb_sign = bool(tb_sign)
        pp = tuple(wpk.to_packed_pairs(g, store_dtype) for g in
                   gauge_eo_packed)
        if form in ("r12", "r12f"):
            pp = tuple(wpp.to_recon12(g) for g in pp)
        if form == "int8":
            # int8 mantissas + one f32 scale per (direction, site) of the
            # storage-dtype links, decoded in the hop
            qs = [to_int8_links(g.to(torch.float32)) for g in pp]
            self._gauge_q = tuple(q.contiguous() for q, _ in qs)
            self._gauge_s = tuple(sc.contiguous() for _, sc in qs)
            self.gauge_eo_pp = None
            return
        self.gauge_eo_pp = tuple(g.contiguous() for g in pp)
        if form == "r12f" or (pallas_version == 3 and form != "fold"):
            return
        # resident pre-shifted backward links, one set per target parity
        self._u_bw = tuple(
            wpp.backward_gauge_eo(self.gauge_eo_pp[1 - p], self.dims,
                                  p).contiguous()
            for p in (0, 1))
        if form == "fold":
            # the fold hop's layout (re/im interleaved into z), links and
            # backward copy folded once here; to_fold copies contiguously
            self.gauge_eo_pp = tuple(wpp.to_fold(g) for g in self.gauge_eo_pp)
            self._u_bw = tuple(wpp.to_fold(g) for g in self._u_bw)

    def _d_to(self, psi_pp, target_parity, out_dtype):
        """The hop D_{p <- 1-p} in the operator's link form, with the
        JAX package's precedence: int8, r12f and fold whatever
        pallas_version says, then pallas_version 3 (v3), then B1.  The fold
        hop takes psi folded and gives its output back unfolded, both as
        contiguous copies (the glue the JAX package's route has too).  On a
        mesh, the sharded eo hop (``_sharded_d_to``)."""
        if getattr(self, "_mesh", None) is not None:
            return self._sharded_d_to(psi_pp, target_parity, out_dtype)
        p = target_parity
        form = self._precision_form
        if form == "int8":
            return wpp.dslash_eo_pallas_packed_int8(
                self._gauge_q[p], self._gauge_s[p], self._gauge_q[1 - p],
                self._gauge_s[1 - p], psi_pp, self.dims, p,
                out_dtype=out_dtype)
        if form == "fold":
            out = wpp.dslash_eo_pallas_packed_fold(
                self.gauge_eo_pp[p], self._u_bw[p], wpp.to_fold(psi_pp),
                self.dims, p, out_dtype=out_dtype, tb_sign=self._tb_sign)
            return wpp.from_fold(out).contiguous()
        if form == "r12f" or self._pallas_version == 3:
            fn = (wpp.dslash_eo_pallas_packed_r12f if form == "r12f"
                  else wpp.dslash_eo_pallas_packed_v3)
            return fn(self.gauge_eo_pp[p], self.gauge_eo_pp[1 - p], psi_pp,
                      self.dims, p, out_dtype=out_dtype,
                      tb_sign=self._tb_sign)
        return wpp.dslash_eo_pallas_packed(
            self.gauge_eo_pp[p], self._u_bw[p], psi_pp, self.dims, p,
            out_dtype=out_dtype, tb_sign=self._tb_sign)

    def _d_to_mrhs(self, psi_b, target_parity, out_dtype):
        """The hop on psi_b (N,4,3,2,T,Z,Y*Xh): one launch of the
        multi-RHS hop (B5-eo; the multi-RHS r12f for r12f, the multi-RHS
        fold hop for fold), each link loaded once per chunk of right-hand
        sides.  The int8 and v3 forms have no multi-RHS kernel: the
        single-RHS hop runs on each right-hand side in turn, as the JAX
        package vmaps it."""
        if getattr(self, "_mesh", None) is not None:
            raise NotImplementedError(
                "multi-RHS hops on a mesh are not ported yet (ROADMAP A15): "
                "solve each right-hand side on the sharded operator")
        p = target_parity
        form = self._precision_form
        if form == "fold":
            out = wpp.dslash_eo_pallas_packed_fold_mrhs(
                self.gauge_eo_pp[p], self._u_bw[p], wpp.to_fold(psi_b),
                self.dims, p, out_dtype=out_dtype, tb_sign=self._tb_sign)
            return wpp.from_fold(out).contiguous()
        if form == "r12f":
            return wpp.dslash_eo_pallas_packed_r12f_mrhs(
                self.gauge_eo_pp[p], self.gauge_eo_pp[1 - p], psi_b,
                self.dims, p, out_dtype=out_dtype, tb_sign=self._tb_sign)
        if form == "int8" or self._pallas_version == 3:
            return torch.stack([self._d_to(x, p, out_dtype) for x in psi_b])
        return wpp.dslash_eo_pallas_packed_mrhs(
            self.gauge_eo_pp[p], self._u_bw[p], psi_b, self.dims, p,
            out_dtype=out_dtype, tb_sign=self._tb_sign)

    # -- the mesh (parallel/mesh.py, parallel/pallas_dslash.py) -----------
    def _setup_mesh(self, mesh, sharded_policy) -> None:
        """Validate the mesh against the lattice, shard the resident links
        once (an x-partitioned mesh re-lays the fused Y*Xh axis out
        block-contiguously first, as the JAX package's _setup_hop does)
        and resolve the halo policy (``_resolve_sharded_policy``)."""
        from ..parallel import mesh as qmesh
        from ..parallel import pallas_dslash as pds
        if mesh.n_src != 1:
            raise NotImplementedError(
                "a mesh with a src axis (the split grid) waits for ROADMAP "
                "A15: it needs distinct cards")
        T, Z, Y, X = self.dims
        _, _, n_y, n_x = pds._mesh_counts(mesh)
        t_l, z_l, y_l, xh_l = qmesh.local_extents(mesh, (T, Z, Y, X // 2))
        pds._check_eo_mesh(type(self).__name__, mesh,
                           (4, 3, 2, t_l, z_l, y_l * xh_l), self.dims,
                           False, tz_only=self._pallas_version == 3)
        self._mesh = mesh
        self._mesh_yx = (n_y, n_x)
        self.gauge_eo_pp = tuple(self.shard(g) for g in self.gauge_eo_pp)
        if self._pallas_version == 2:
            self._u_bw = tuple(self.shard(g) for g in self._u_bw)
        self._sharded_policy = self._resolve_sharded_policy(sharded_policy)

    def shard(self, x: torch.Tensor):
        """A global packed pair array (..., T, Z, Y*Xh) -> a ShardedField
        on the operator's mesh (block-contiguous on an x-partitioned
        mesh)."""
        from ..parallel import mesh as qmesh
        n_y, n_x = self._mesh_yx
        _, _, Y, X = self.dims
        x = qmesh.fuse_block_layout(x, n_y, n_x, Y, X // 2)
        return qmesh.shard(x, self._mesh, qmesh.pair_pspec(x.dim()))

    def gather(self, field) -> torch.Tensor:
        """Inverse of ``shard``: the global array, on the first
        sub-domain's device.  Outside a solve only."""
        from ..parallel import mesh as qmesh
        n_y, n_x = self._mesh_yx
        _, _, Y, X = self.dims
        return qmesh.unfuse_block_layout(qmesh.gather(field), n_y, n_x, Y,
                                         X // 2)

    def _hop_on_mesh(self, u_here, u_other, psi, target_parity, out_dtype,
                     policy):
        from ..parallel import pallas_dslash as pds
        fn = (pds.dslash_eo_pallas_sharded if self._pallas_version == 2
              else pds.dslash_eo_pallas_sharded_v3)
        return fn(u_here, u_other, psi, self.dims, target_parity,
                  self._mesh, out_dtype=out_dtype, tb_sign=self._tb_sign,
                  policy=policy)

    def _sharded_d_to(self, psi, target_parity, out_dtype):
        """The sharded eo hop (v2: B1 with the sharded pre-shifted
        backward links; v3: the copy-free B10-eo) under the resolved halo
        policy.  A ShardedField in, a ShardedField out; a global array in
        (prepare, reconstruct) is sharded and the result gathered."""
        from ..parallel.mesh import ShardedField
        p = target_parity
        glob = not isinstance(psi, ShardedField)
        x = self.shard(psi) if glob else psi
        other = (self._u_bw[p] if self._pallas_version == 2
                 else self.gauge_eo_pp[1 - p])
        out = self._hop_on_mesh(self.gauge_eo_pp[p], other, x, p, out_dtype,
                                self._sharded_policy)
        return self.gather(out) if glob else out

    def _resolve_sharded_policy(self, policy) -> dict:
        """The per-axis halo policy: a bare name, per-axis spec or dict
        (parallel/pallas_dslash.resolve_axis_policies).  ``"auto"`` is
        ``fused_halo``: the exchange kernel on every contiguous t/z/y face
        (its plain version on CPU blocks) and xla_facefix on x, the only
        transport of its strided column faces.  The JAX package races the
        two per axis; they move the same bytes to the same places (the hop
        is bit for bit the same under either), so the port runs the
        kernel and races nothing."""
        from ..parallel import pallas_dslash as pds
        counts = pds._mesh_counts(self._mesh)
        live = [a for a, n in zip(pds.AXIS_NAMES, counts) if n > 1]
        pols = pds.resolve_axis_policies(
            "fused_halo" if policy == "auto" else policy)
        log.info("mesh dslash: grid %s, eo interior v%d, halo policy %s",
                 self._mesh.grid, self._pallas_version,
                 pds._policy_label(pols, live))
        return pols

    def _to_pairs(self, x):
        """Canonical (..., T,Z,Y,Xh,4,3) complex -> packed pairs; leading
        (RHS) axes stay in front; contiguous (the kernels read raw
        pointers)."""
        return wpk.to_packed_pairs(wpk.pack_spinor(x),
                                   self.store_dtype).contiguous()

    def _from_pairs(self, x, dtype):
        """Packed pairs -> canonical (..., T,Z,Y,Xh,4,3) complex."""
        T, Z, Y, X = self.dims
        return wpk.unpack_spinor(wpk.from_packed_pairs(x, dtype),
                                 (T, Z, Y, X // 2))

    def solution_from_pairs_mrhs(self, x_b, dtype=torch.complex64):
        """Batched pair solutions -> canonical complex (N,T,Z,Y,Xh,4,3)."""
        return self._from_pairs(x_b, dtype)


class _SchurPairOpBase(_PackedHopMixin, _PairSloppyBase):
    """Template for clover-type Schur pair operators (single RHS)

        M_pc(s) = diag_p(s) - kappa^2 D Ainv_q(s) D
        prepare:      b_p + kappa D Ainv_q b_q
        reconstruct:  x_q = Ainv_q (b_q + kappa D x_p)

    written once over the ``_Ainv_q_sign_pairs`` hook (prepare and
    reconstruct) and the fused-epilogue hooks ``_fused_k1_params`` /
    ``_fused_k2_params``.  Each apply of M runs two launches of the fused
    hop (ops/clover_pallas): K1 = Ainv_q(D_{q<-p} x), K2 =
    diag_p(x) - kappa^2 D_{p<-q} t; on CPU tensors their plain versions.
    An operator the fused kernels cannot host (models/formsel.
    fused_capable: the flavour doublets) runs the staged composition on
    its ``_d_to`` and the ``_diag_sign_pairs`` hook instead.
    Mdag = g5 M(-s) g5; the twist sign s is ignored by the g5-hermitian
    clover family.  The ``_mrhs`` forms run the fused composition on a
    batch: K1 and K2 become the multi-RHS fused hops (B7-mrhs), prepare
    and reconstruct the multi-RHS hop (B5-eo).

    ``_Ainv_q_sign_pairs`` serves both: it must broadcast over a leading
    RHS axis (the clover term's ``apply_clover_pairs`` does)."""

    def _Ainv_q_sign_pairs(self, x, sign, out_dtype):
        raise NotImplementedError

    def _diag_sign_pairs(self, x, sign, out_dtype):
        """diag_p(s) x of the staged composition."""
        raise NotImplementedError

    @property
    def _fused(self) -> bool:
        from .formsel import fused_capable
        return fused_capable(self) is None

    def _fused_k1_params(self, sign):
        """-> (blk_pl, twist (c, scale) or None) of K1's epilogue."""
        raise NotImplementedError

    def _fused_k2_params(self, sign):
        """-> (blk_pl, diag_twist c or None) of K2's diagonal."""
        raise NotImplementedError

    def _schur_with(self, x, sign, k1, k2):
        """diag_p(x) - kappa^2 D Ainv_q(s) D x through the fused hops
        ``k1`` (K1 or K1-mrhs) and ``k2`` (K2 or K2-mrhs)."""
        p = self.matpc
        k1_blk, k1_twist = self._fused_k1_params(sign)
        k2_blk, k2_twist = self._fused_k2_params(sign)
        # K1: Ainv_q(D_{q<-p} x), the hop rounded to store_dtype first
        t = k1(self.gauge_eo_pp[1 - p], self._u_bw[1 - p], x, self.dims,
               1 - p, blk_pl=k1_blk, twist=k1_twist,
               out_dtype=self.store_dtype, tb_sign=self._tb_sign)
        # K2: diag_p(x) - kappa^2 D_{p<-q} t in float32, cast to storage
        out = k2(self.gauge_eo_pp[p], self._u_bw[p], t, x, self.dims, p,
                 hop_coeff=-(self.kappa ** 2), blk_pl=k2_blk,
                 diag_twist=k2_twist, out_dtype=torch.float32,
                 tb_sign=self._tb_sign)
        return out.to(self.store_dtype)

    def _M_sign_pairs(self, x, sign):
        from ..ops import clover_pallas as clp
        if self._fused:
            return self._schur_with(x, sign, clp.dslash_eo_pallas_post,
                                    clp.dslash_eo_pallas_diag_hop)
        p = self.matpc
        t = self._d_to(x, 1 - p, self.store_dtype)
        t = self._Ainv_q_sign_pairs(t, sign, self.store_dtype)
        dd = self._d_to(t, p, torch.float32)
        out = (self._diag_sign_pairs(x, sign, torch.float32)
               - (self.kappa ** 2) * dd)
        return out.to(self.store_dtype)

    def _M_sign_pairs_mrhs(self, x, sign):
        from ..ops import clover_pallas as clp
        if not self._fused:
            raise NotImplementedError(
                f"{type(self).__name__} has no batched form: "
                "invert_multi_src_quda solves it source by source")
        return self._schur_with(x, sign, clp.dslash_eo_pallas_post_mrhs,
                                clp.dslash_eo_pallas_diag_hop_mrhs)

    def M_pairs(self, x):
        return self._M_sign_pairs(x, +1)

    def Mdag_pairs(self, x):
        return self._g5_pairs(self._M_sign_pairs(self._g5_pairs(x), -1))

    def M_pairs_mrhs(self, x):
        return self._M_sign_pairs_mrhs(x, +1)

    def Mdag_pairs_mrhs(self, x):
        return self._g5_pairs_mrhs(
            self._M_sign_pairs_mrhs(self._g5_pairs_mrhs(x), -1))

    def _prepare_with(self, b_even, b_odd, d_to):
        p = self.matpc
        b_p, b_q = (b_even, b_odd) if p == EVEN else (b_odd, b_even)
        t = self._Ainv_q_sign_pairs(self._to_pairs(b_q), +1,
                                    self.store_dtype)
        t = d_to(t, p, torch.float32)
        rhs = self._to_pairs(b_p).to(torch.float32) + self.kappa * t
        return rhs.to(self.store_dtype)

    def _reconstruct_with(self, x_pp, b_even, b_odd, d_to):
        p = self.matpc
        b_q = b_odd if p == EVEN else b_even
        t = d_to(x_pp, 1 - p, torch.float32)
        xq_pp = self._Ainv_q_sign_pairs(
            self._to_pairs(b_q).to(torch.float32) + self.kappa * t, +1,
            torch.float32)
        x_p = self._from_pairs(x_pp, b_q.dtype)
        x_q = self._from_pairs(xq_pp, b_q.dtype)
        return (x_p, x_q) if p == EVEN else (x_q, x_p)

    def prepare_pairs(self, b_even, b_odd):
        """Canonical complex parity sources -> pair-form PC rhs
        b_p + kappa D Ainv_q b_q, in the storage dtype."""
        return self._prepare_with(b_even, b_odd, self._d_to)

    def reconstruct_pairs(self, x_pp, b_even, b_odd):
        """x_q = Ainv_q (b_q + kappa D x_p); canonical complex parity
        fields out."""
        return self._reconstruct_with(x_pp, b_even, b_odd, self._d_to)

    def prepare_pairs_mrhs(self, b_even_b, b_odd_b):
        """Batched prepare_pairs: (N,T,Z,Y,Xh,4,3) complex parity sources
        in, (N,4,3,2,T,Z,Y*Xh) out, the hop on the multi-RHS kernel."""
        return self._prepare_with(b_even_b, b_odd_b, self._d_to_mrhs)

    def reconstruct_pairs_mrhs(self, x_b, b_even_b, b_odd_b):
        """Batched reconstruct_pairs: canonical complex (even, odd)
        batches out."""
        return self._reconstruct_with(x_b, b_even_b, b_odd_b,
                                      self._d_to_mrhs)


class DiracWilsonPCPacked:
    """PC Wilson operator with its links in the packed half-lattice
    layout.  The Krylov loop runs on its pair companion (``pairs``);
    ``D_to``, ``M``, ``Mdag`` and ``MdagM`` act on complex packed fields
    (4,3,T,Z,Y*Xh) through the pair companion of their precision (float32
    for complex64, float64 for complex128) and ``precision_form`` ("full"
    or "r12" links), every hop on B1."""

    def __init__(self, dpc: DiracWilsonPC, precision_form: str = "full"):
        self.geom = dpc.geom
        self.kappa = dpc.kappa
        self.matpc = dpc.matpc
        self._dpc = dpc
        self.dims = tuple(dpc.geom.lattice_shape)
        self.gauge_eo_p = wpk.pack_gauge_eo(dpc.gauge_eo)
        self.precision_form = precision_form
        self._pair_ops: dict = {}

    def _pair_op(self, dtype) -> "DiracWilsonPCPackedSloppy":
        store = wpk.compute_dtype(torch.empty((), dtype=dtype).real.dtype)
        op = self._pair_ops.get(store)
        if op is None:
            op = self._pair_ops[store] = self.pairs(store,
                                                    self.precision_form)
        return op

    def D_to(self, psi_p, target_parity):
        """Hop from parity (1-target) into target parity on complex packed
        (4,3,T,Z,Y*Xh) fields."""
        op = self._pair_op(psi_p.dtype)
        out = op._d_to(wpk.to_packed_pairs(psi_p, op.store_dtype),
                       target_parity, op.store_dtype)
        return wpk.from_packed_pairs(out, psi_p.dtype)

    def M(self, x_p):
        p = self.matpc
        tmp = self.D_to(x_p, 1 - p)
        return x_p - (self.kappa ** 2) * self.D_to(tmp, p)

    def Mdag(self, x_p):
        g5 = _g5_sign(x_p.device, x_p.ndim, 0).to(x_p.real.dtype)
        return g5 * self.M(g5 * x_p)

    def MdagM(self, x_p):
        return self.Mdag(self.M(x_p))

    def flops_per_site_M(self) -> int:
        return self._dpc.flops_per_site_M()

    def pairs(self, store_dtype=torch.float32, precision_form: str = "full",
              pallas_version: int = 2, mesh=None,
              sharded_policy="auto") -> "DiracWilsonPCPackedSloppy":
        """Pair-storage companion, every hop on an eo kernel: with
        float32 storage the precise operator in a complex-free
        representation, with bfloat16 the sloppy operator of the mixed
        solve, with float64 the precise operator of the double routes.
        ``precision_form``: "full", "r12", "r12f", "int8" or "fold"
        links; ``pallas_version`` 2 (B1, resident backward copy) or 3 (the
        copy-free hop) for full and r12 (float64: full, 2).

        ``mesh`` (parallel/mesh.make_lattice_mesh): the links are sharded
        over its sub-domains once and every hop is the sharded eo hop
        (parallel/pallas_dslash) in the same kernel form, on ShardedFields
        (``shard``/``gather``); ``sharded_policy`` selects the halo
        transport per axis: ``"xla_facefix"``, ``"fused_halo"`` (the
        exchange kernel B12), a per-axis spec such as
        ``"t=fused_halo,z=fused_halo,y=fused_halo"``, or ``"auto"``
        (``fused_halo``: the kernel on t/z/y, x on xla_facefix).  A mesh serves
        float32 and bfloat16, full and r12, v2 and v3 (v3 on t/z meshes;
        a y/x-partitioned mesh clamps to v2)."""
        return DiracWilsonPCPackedSloppy(self, store_dtype, precision_form,
                                         pallas_version, mesh=mesh,
                                         sharded_policy=sharded_policy)


class DiracWilsonPCPackedSloppy(_PackedHopMixin, _PairSloppyBase):
    """Pair-storage PC Wilson operator on the packed layout: spinors
    (4,3,2,T,Z,Y*Xh), links likewise.  ``prepare_pairs`` and
    ``reconstruct_pairs`` take canonical complex parity sources."""

    def __init__(self, dpk: DiracWilsonPCPacked, store_dtype=torch.float32,
                 precision_form: str = "full", pallas_version: int = 2,
                 mesh=None, sharded_policy="auto"):
        self._setup_hop(dpk.geom, dpk.gauge_eo_p, store_dtype,
                        tb_sign=dpk._dpc.antiperiodic_t,
                        precision_form=precision_form,
                        store_dtypes=WILSON_STORE_DTYPES,
                        pallas_version=pallas_version,
                        forms=PRECISION_FORMS, mesh=mesh,
                        sharded_policy=sharded_policy)
        self.kappa = float(dpk.kappa)
        self.matpc = dpk.matpc

    def _prepare_with(self, b_even, b_odd, d_to):
        p = self.matpc
        b_p, b_q = (b_even, b_odd) if p == EVEN else (b_odd, b_even)
        return (self._to_pairs(b_p).to(self._acc)
                + self.kappa * d_to(self._to_pairs(b_q), p, self._acc))

    def _reconstruct_with(self, x_pp, b_even, b_odd, d_to):
        p = self.matpc
        b_q = b_odd if p == EVEN else b_even
        t = d_to(x_pp, 1 - p, self._acc)
        xq_pp = self._to_pairs(b_q).to(self._acc) + self.kappa * t
        x_p = self._from_pairs(x_pp, b_q.dtype)
        x_q = self._from_pairs(xq_pp, b_q.dtype)
        return (x_p, x_q) if p == EVEN else (x_q, x_p)

    def prepare_pairs(self, b_even, b_odd):
        """Canonical complex parity sources -> pair-form PC rhs
        b_p + kappa D b_q."""
        return self._prepare_with(b_even, b_odd, self._d_to)

    def reconstruct_pairs(self, x_pp, b_even, b_odd):
        """Pair-form PC solution + canonical complex sources -> canonical
        complex parity fields, x_q = b_q + kappa D x_p on the same hop."""
        return self._reconstruct_with(x_pp, b_even, b_odd, self._d_to)

    def prepare_pairs_mrhs(self, b_even_b, b_odd_b):
        """Batched prepare_pairs: (N,T,Z,Y,Xh,4,3) complex parity sources
        in, the f32 (N,4,3,2,T,Z,Y*Xh) rhs out; the multi-RHS hop serves
        source preparation too."""
        return self._prepare_with(b_even_b, b_odd_b, self._d_to_mrhs)

    def reconstruct_pairs_mrhs(self, x_b, b_even_b, b_odd_b):
        """Batched reconstruct_pairs: x_q = b_q + kappa D x_p on the
        multi-RHS hop; canonical complex (even, odd) batches out."""
        return self._reconstruct_with(x_b, b_even_b, b_odd_b,
                                      self._d_to_mrhs)


class DiracWilsonPackedPairs:
    """Pair companion of the full-lattice Wilson operator M = 1 - kappa D
    on the packed layout: spinors (4,3,2,T,Z,Y*X), links and their
    pre-shifted backward copy (4,R,3,2,T,Z,Y*X), every hop one launch of
    the full-lattice kernel B4 (its plain version on CPU tensors).
    float32 (full or recon-12 links) or float64 (full); the glue in the
    storage's precision.  ``D``, ``M``, ``Mdag`` and ``MdagM`` take and
    give canonical complex (T,Z,Y,X,4,3) fields."""

    def __init__(self, dw: DiracWilson, store_dtype=torch.float32,
                 precision_form: str = "full"):
        if store_dtype not in (torch.float32, torch.float64):
            raise NotImplementedError(
                f"pair storage {store_dtype}: B4 takes float32 and float64 "
                "(its bf16 forms wait for ROADMAP A7)")
        if precision_form not in RESIDENT_FORMS:
            raise NotImplementedError(
                f"precision_form {precision_form!r} is not ported for the "
                f"full-lattice hop (ROADMAP A7); it serves "
                f"{RESIDENT_FORMS}")
        _check_double_form(store_dtype, precision_form)
        self.geom = dw.geom
        self.kappa = float(dw.kappa)
        self.dims = tuple(dw.geom.lattice_shape)
        self.store_dtype = store_dtype
        self._tb_sign = bool(dw.antiperiodic_t)
        gp = wpk.to_packed_pairs(wpk.pack_gauge(dw.gauge), store_dtype)
        if precision_form == "r12":
            gp = wpp.to_recon12(gp)
        self.gauge_pl = gp.contiguous()
        self.gauge_bw = wpp.backward_gauge(self.gauge_pl,
                                           self.dims[3]).contiguous()

    def D_pairs(self, psi_pl):
        """The hop sum D psi (B4), in the storage dtype."""
        return wpp.dslash_pallas_packed(self.gauge_pl, psi_pl, self.dims[3],
                                        gauge_bw=self.gauge_bw,
                                        tb_sign=self._tb_sign)

    def M_pairs(self, x):
        return (x - self.kappa * self.D_pairs(x)).to(self.store_dtype)

    def Mdag_pairs(self, x):
        g5 = _PairSloppyBase._g5_on
        return g5(self.M_pairs(g5(x, 0)), 0)

    def MdagM_pairs(self, x):
        return self.Mdag_pairs(self.M_pairs(x))

    def _to_pairs(self, x):
        """Canonical (..., T,Z,Y,X,4,3) complex -> (..., 4,3,2,T,Z,Y*X)."""
        return wpk.to_packed_pairs(wpk.pack_spinor(x),
                                   self.store_dtype).contiguous()

    def _from_pairs(self, x, dtype):
        return wpk.unpack_spinor(wpk.from_packed_pairs(x, dtype), self.dims)

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
