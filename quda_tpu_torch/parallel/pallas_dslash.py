"""The sharded Wilson hop: the single-device kernel on every sub-domain,
then the boundary faces fixed — port of the Wilson half of
quda_tpu/parallel/pallas_dslash.py.

Reference behavior: QUDA's interior/exterior kernel split
(lib/dslash_policy.hpp: interior kernel overlapped with halo comms,
then exterior kernels fix the boundary faces; NVSHMEM variant in
include/dslash_shmem.h).  The design, as in the JAX package:

1. run the single-device hop kernel (B1, B10-eo, B4 or B10;
   ops/wilson_pallas_packed) on each sub-domain's LOCAL block with its
   periodic wraps: every interior site is final, the boundary faces carry
   a wrong-wrap term;
2. exchange the psi boundary faces with the neighbouring sub-domains
   (backward links need no exchange: ``backward_gauge`` /
   ``backward_gauge_eo`` run on the GLOBAL field before sharding, so the
   cross-boundary links already sit in each sub-domain's pre-shifted
   block);
3. fix the faces in plain PyTorch: subtract the wrong-wrap hop term, add
   the halo hop term — O(surface) work.

Fields are ShardedFields (parallel/mesh.py) of the packed pair layouts,
psi (4,3,2,T,Z,Y*X[h]) and links (4,R,3,2,T,Z,Y*X[h]) cut by
``mesh.pair_pspec``: the t and z mesh axes cut the T and Z array axes
(whole-plane slab faces), y and x the fused Y*X axis (a y face is a
contiguous row strip, an x face a strided column gather; ``_FaceIO``
owns the three geometries).  x-partitioned blocks are block-contiguous
(mesh.fuse_block_layout).  The interiors run with
``tb_sign and n_t == 1``: along a partitioned t the local boundary plane
is not the global one, and the face fixes re-apply the true edge sign
to reconstruct-12 rows (``_full_rows``, ``_t_edge_signs``).

Halo transport per partitioned axis (``resolve_axis_policies``):
``xla_facefix`` — the plain transport (pallas_halo.slab_exchange_plain:
two parallel/halo._permute_slice copies per sub-domain); ``fused_halo``
— one launch per card of the exchange kernel
(pallas_halo.slab_exchange_bidir), which reads each face in place, for
the faces made of contiguous runs only (``FUSED_HALO_AXES``: t/z slabs
and y row strips; x columns stay on xla_facefix, and an explicit
``x=fused_halo`` is an error).  On CUDA blocks ``fused_halo`` launches
the kernel or raises.  The two policies move the same bytes to the same
places, so the hop is bit for bit the same under either.  The operator's
``"auto"`` (models/wilson.py) is ``fused_halo``.

The four entries: ``dslash_pallas_sharded`` (full lattice, B4 interior),
``dslash_eo_pallas_sharded`` (checkerboarded, B1), ``dslash_eo_pallas_
sharded_v3`` (checkerboarded copy-free, B10-eo, t/z only) and
``dslash_pallas_sharded_v3`` (full lattice copy-free, B10).  The
staggered half of the JAX module waits for ROADMAP A15.  The comms
ledger scopes of the JAX package (``obs/comms.scope``) have no
counterpart until A17.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..ops import wilson_packed as wpk
from ..ops import wilson_pallas_packed as wpp
from ..ops.wilson_pallas import TABLES
from . import pallas_halo as ph
from .mesh import LatticeMesh, ShardedField, _norm_spec, pair_pspec

AXIS_NAMES = ("t", "z", "y", "x")


def _hop_term(psi_slab, u_slab, table, adjoint):
    """Single hop-direction contribution on a boundary slab (f32)."""
    return wpk._hop_packed_pairs(psi_slab.to(torch.float32),
                                 u_slab.to(torch.float32), table, adjoint)


def _face_n(arr, axis, lo: bool, n: int = 1):
    """n boundary planes (one slab; n=1 for Wilson)."""
    L = arr.shape[axis]
    return arr.narrow(axis, 0 if lo else L - n, n)


def _add_face_n(out, corr, axis, lo: bool, n: int = 1):
    """out's face += corr, in f32, rounded back to out's dtype (in place
    on ``out``, a hop's fresh output)."""
    face = _face_n(out, axis, lo, n)
    face.copy_((face.to(torch.float32) + corr).to(out.dtype))
    return out


# -- per-direction face geometry --------------------------------------------

class _FaceIO:
    """Boundary-face gather/scatter for ONE partitioned lattice direction
    on the packed layouts (..., T, Z, Y·X):

    * ``plane`` — t/z: n whole planes of array axis -3/-2 (slabs);
    * ``rows``  — y: the fused axis is row-major (y outer, x inner), so an
      n-row face is the CONTIGUOUS first/last n*xcols entries;
    * ``cols``  — x: an n-column face is a STRIDED gather — the trailing
      axis viewed as (rows, xcols), n columns sliced, the (rows, n)
      trailing shape kept (every fix is elementwise over the trailing
      dims, so slab and column faces share the hop/fix code).

    ``xcols`` is the LOCAL row width: X//n_x on the full lattice, Xh//n_x
    checkerboarded."""

    __slots__ = ("kind", "axis", "xcols")

    def __init__(self, kind: str, axis: int = 0, xcols: int = 0):
        self.kind, self.axis, self.xcols = kind, axis, xcols

    def _unfused(self, arr):
        xc = self.xcols
        return arr.reshape(arr.shape[:-1] + (arr.shape[-1] // xc, xc))

    def face(self, arr, lo: bool, n: int = 1):
        if self.kind == "plane":
            return _face_n(arr, self.axis, lo, n)
        if self.kind == "rows":
            return _face_n(arr, -1, lo, n * self.xcols)
        return _face_n(self._unfused(arr), -1, lo, n)

    def add(self, out, corr, lo: bool, n: int = 1):
        if self.kind == "plane":
            return _add_face_n(out, corr, self.axis, lo, n)
        if self.kind == "rows":
            return _add_face_n(out, corr, -1, lo, n * self.xcols)
        _add_face_n(self._unfused(out), corr, -1, lo, n)
        return out


def _axis_plan(counts, xcols: int):
    """(fio, mesh-axis name, sub-domain count, mu) per lattice direction,
    outermost first."""
    n_t, n_z, n_y, n_x = counts
    return ((_FaceIO("plane", axis=-3), "t", n_t, 3),
            (_FaceIO("plane", axis=-2), "z", n_z, 2),
            (_FaceIO("rows", xcols=xcols), "y", n_y, 1),
            (_FaceIO("cols", xcols=xcols), "x", n_x, 0))


def _mesh_counts(mesh: LatticeMesh):
    return tuple(int(mesh.shape[a]) for a in AXIS_NAMES)


# -- halo-exchange policies -------------------------------------------------
#
# Every face fix needs exactly two transfers per partitioned direction:
# one face travelling towards the LOWER sub-domain (the receiver splices
# it into its HIGH face) and one towards the UPPER (spliced into the LOW
# face).  ``exchange(send_down, send_up, name)`` returns (from_up,
# from_down), lists over the sub-domains, and is the seam where the
# policy plugs in.

SHARDED_POLICIES = ("xla_facefix", "fused_halo")

# axes whose faces are contiguous strips — the only ones the exchange
# kernel serves (x faces are strided column gathers)
FUSED_HALO_AXES = ("t", "z", "y")


def resolve_axis_policies(policy) -> dict:
    """Normalize a halo-policy spec into {axis: policy} over t/z/y/x.

    Accepts a bare policy name (applied to every axis; ``fused_halo``
    keeps ``xla_facefix`` on x, whose strided column face has no
    contiguous strip), a per-axis spec string
    ``"t=fused_halo,z=fused_halo,y=xla_facefix"`` (unlisted axes get
    xla_facefix; an EXPLICIT x=fused_halo is an error), or an
    already-resolved dict."""
    if isinstance(policy, dict):
        items = list(policy.items())
    elif isinstance(policy, str) and "=" in policy:
        items = []
        for part in policy.split(","):
            part = part.strip()
            if not part:
                continue
            ax, _, val = part.partition("=")
            items.append((ax.strip(), val.strip()))
    else:
        if policy not in SHARDED_POLICIES:
            raise ValueError(f"unknown sharded halo policy {policy!r}; "
                             f"known: {SHARDED_POLICIES}")
        return {ax: (policy if policy != "fused_halo"
                     or ax in FUSED_HALO_AXES else "xla_facefix")
                for ax in AXIS_NAMES}
    pols = {ax: "xla_facefix" for ax in AXIS_NAMES}
    for ax, val in items:
        if ax not in AXIS_NAMES:
            raise ValueError(f"unknown mesh axis {ax!r} in sharded halo "
                             f"policy spec; known: {AXIS_NAMES}")
        if val not in SHARDED_POLICIES:
            raise ValueError(f"unknown sharded halo policy {val!r}; "
                             f"known: {SHARDED_POLICIES}")
        if val == "fused_halo" and ax not in FUSED_HALO_AXES:
            raise ValueError(
                "x faces are strided column gathers (no contiguous "
                f"strip): fused_halo serves {FUSED_HALO_AXES} only")
        pols[ax] = val
    return pols


def _policy_label(pols: dict, live_axes) -> str:
    """ONE policy label: the plain name when every partitioned axis
    agrees, else the per-axis spec string."""
    live = tuple(live_axes)
    vals = {pols[a] for a in live} if live else {pols["t"]}
    if len(vals) == 1:
        return vals.pop()
    return ",".join(f"{a}={pols[a]}" for a in live)


def _make_exchange(policy, mesh: LatticeMesh):
    """Per-axis halo-transport dispatch: ``policy`` is anything
    ``resolve_axis_policies`` accepts; the returned
    ``exchange(send_down, send_up, name)`` routes each partitioned
    direction through its own policy."""
    pols = resolve_axis_policies(policy)

    def exchange(send_down, send_up, name):
        if pols.get(name) == "fused_halo":
            return ph.slab_exchange_bidir(send_down, send_up, mesh, name)
        return ph.slab_exchange_plain(send_down, send_up, mesh, name)
    return exchange


# -- reconstruct-12 face slabs ----------------------------------------------

def _full_rows(u_slab, row2_sign=None):
    """Full 3x3 link slab from a face slab of either storage: row extent 3
    passes through; extent 2 (reconstruct-12) rebuilds row 2 =
    conj(row0 x row1) in f32.  ``row2_sign`` re-applies the folded
    antiperiodic-t phase (the two -1s of V = -U cancel in the cross
    product, so the boundary-plane row must be re-negated)."""
    if u_slab.shape[0] == 3:
        return u_slab
    u = u_slab.to(torch.float32)
    r0, r1 = u[0], u[1]                     # (3, 2, ...) each
    rows2 = []
    for b in range(3):
        b1, b2 = (b + 1) % 3, (b + 2) % 3
        re = ((r0[b1, 0] * r1[b2, 0] - r0[b1, 1] * r1[b2, 1])
              - (r0[b2, 0] * r1[b1, 0] - r0[b2, 1] * r1[b1, 1]))
        im = ((r0[b1, 0] * r1[b2, 1] + r0[b1, 1] * r1[b2, 0])
              - (r0[b2, 0] * r1[b1, 1] + r0[b2, 1] * r1[b1, 0]))
        re, im = re, -im                    # conjugate the cross product
        if row2_sign is not None:
            re, im = re * row2_sign, im * row2_sign
        rows2.append(torch.stack([re, im]))
    return torch.cat([u, torch.stack(rows2)[None]], dim=0)


def _face_links(u_mu_slab, edge_sign):
    """(true, kernel) full-row slabs for one face: ``true`` carries the
    physically correct rebuilt row (edge_sign applied on the
    global-boundary sub-domain), ``kernel`` the interior kernel's
    convention (unsigned along a partitioned t)."""
    true = _full_rows(u_mu_slab, edge_sign)
    if u_mu_slab.shape[0] == 3 or edge_sign is None:
        return true, true
    return true, _full_rows(u_mu_slab, None)


def _t_edge_signs(idx: int, n: int, mu: int, R: int, tb_sign: bool):
    """(sign_hi, sign_lo) of the reconstruct-12 t-boundary row on the two
    faces of sub-domain ``idx`` (of ``n``) along a partitioned direction:
    the HIGH face of the last sub-domain holds the global t = T-1 link
    plane; the pre-shifted backward LOW face of sub-domain 0 holds the
    same plane.  None everywhere except recon-12 t links with a folded
    boundary."""
    if mu != 3 or R == 3 or not tb_sign:
        return None, None
    return (-1.0 if idx == n - 1 else 1.0), (-1.0 if idx == 0 else 1.0)


def _wilson_fix_faces_v2(outs, links_fwd, links_bwd_sh, psis, fio, name,
                         mu, exchange, signs):
    """Both face fixes for one partitioned direction, v2 gather-form
    conventions (pre-shifted backward links resident per sub-domain):

    * forward hop, HIGH face: psi(x+mu) from the next sub-domain's first
      face against the local forward links;
    * backward hop, LOW face: the LOCAL block of the GLOBALLY pre-shifted
      backward links already holds U_mu(x-mu), so only psi(x-mu) comes
      from the previous sub-domain's last face.

    Both halos ride ONE ``exchange`` call.  Lists over the sub-domains;
    ``signs`` holds each one's (sign_hi, sign_lo)."""
    lo_first = [fio.face(p, lo=True) for p in psis]
    hi_last = [fio.face(p, lo=False) for p in psis]
    halo_hi, halo_lo = exchange(lo_first, hi_last, name)
    tf, tb = TABLES[(mu, +1)], TABLES[(mu, -1)]
    new = []
    for i, out in enumerate(outs):
        sign_hi, sign_lo = signs[i]
        u_true, u_kern = _face_links(fio.face(links_fwd[i][mu], lo=False),
                                     sign_hi)
        corr = (_hop_term(halo_hi[i], u_true, tf, False)
                - _hop_term(lo_first[i], u_kern, tf, False))
        out = fio.add(out, corr, lo=False)
        u_true, u_kern = _face_links(fio.face(links_bwd_sh[i][mu], lo=True),
                                     sign_lo)
        corr = (_hop_term(halo_lo[i], u_true, tb, True)
                - _hop_term(hi_last[i], u_kern, tb, True))
        new.append(fio.add(out, corr, lo=True))
    return new


def _wilson_fix_faces_v3(outs, links_fwd, links_bwd, psis, fio, name, mu,
                         exchange, signs_hi):
    """Both face fixes for one partitioned direction, v3 scatter-form
    conventions (full-lattice and eo alike):

    * forward hop, HIGH face: psi(x+mu) from the next sub-domain's first
      face against ``links_fwd``;
    * backward hop, LOW face: the kernel wrapped the locally computed
      product U^dag psi of the last face (built from ``links_bwd``);
      the product itself is sent — linear in the face, no link exchange.

    Both transfers ride ONE ``exchange`` call."""
    lo_first = [fio.face(p, lo=True) for p in psis]
    hi_last = [fio.face(p, lo=False) for p in psis]
    tb, tf = TABLES[(mu, -1)], TABLES[(mu, +1)]
    prod_true, prod_kern = [], []
    for i, last in enumerate(hi_last):
        u_true, u_kern = _face_links(fio.face(links_bwd[i][mu], lo=False),
                                     signs_hi[i])
        # the product SENT upward is the physically correct one (spliced
        # in as it is); the one SUBTRACTED locally is the interior
        # kernel's own wrong-wrap product
        pt = _hop_term(last, u_true, tb, True)
        prod_true.append(pt)
        prod_kern.append(pt if u_kern is u_true
                         else _hop_term(last, u_kern, tb, True))
    halo_hi, prod_in = exchange(lo_first, prod_true, name)
    new = []
    for i, out in enumerate(outs):
        u_true, u_kern = _face_links(fio.face(links_fwd[i][mu], lo=False),
                                     signs_hi[i])
        corr = (_hop_term(halo_hi[i], u_true, tf, False)
                - _hop_term(lo_first[i], u_kern, tf, False))
        out = fio.add(out, corr, lo=False)
        new.append(fio.add(out, prod_in[i] - prod_kern[i], lo=True))
    return new


# -- mesh checks ------------------------------------------------------------

def _fields(name: str, mesh, *fields):
    """The mesh of ShardedFields cut as the packed pair layouts; refuses
    plain tensors, other cuts and a split (src) mesh."""
    for f in fields:
        if not isinstance(f, ShardedField):
            raise TypeError(f"{name} takes ShardedFields (parallel/mesh."
                            f"shard), got {type(f).__name__}")
    mesh = mesh or fields[0].mesh
    for f in fields:
        if f.mesh != mesh:
            raise ValueError(f"{name}: fields on another mesh")
        if f.spec != _norm_spec(pair_pspec(f.ndim), f.ndim):
            raise ValueError(f"{name}: fields cut {f.spec}, the sharded "
                             "hops take mesh.pair_pspec")
    if mesh.n_src != 1:
        raise NotImplementedError(
            f"{name} on a mesh with a src axis of {mesh.n_src}: the split "
            "grid waits for ROADMAP A15 (it needs distinct cards)")
    return mesh


def _check_sharded_mesh(name: str, psi_shape, X: int, mesh):
    """Guards of the full-lattice sharded hops: the x mesh axis must
    split X evenly and the local fused extent must be whole rows of the
    LOCAL row width (block-contiguous layout, fuse_block_layout).
    Returns ((n_t, n_z, n_y, n_x), x_loc)."""
    counts = _mesh_counts(mesh)
    n_x = counts[3]
    if X % n_x:
        raise ValueError(f"{name}: X={X} must divide evenly over the x "
                         f"mesh axis ({n_x})")
    x_loc = X // n_x
    if psi_shape[-1] % x_loc:
        raise ValueError(
            f"{name}: local fused extent {psi_shape[-1]} is not a whole "
            f"number of local rows of width {x_loc} (x-partitioned arrays "
            "must be block-contiguous — see parallel/mesh."
            "fuse_block_layout)")
    return counts, x_loc


def _check_eo_mesh(name: str, mesh, psi_shape, dims, with_long: bool,
                   tz_only: bool = False):
    """Guards of the checkerboarded sharded hops:

    * partitioned t/z/y axes need EVEN local extents (the in-kernel parity
      masks use local coordinates; the x mesh axis splits xh SLOTS,
      which never enter the parity);
    * the x mesh axis must divide Xh = X//2 evenly (block-contiguous
      layout with the HALF row width);
    * Naik (with_long) needs local extent >= 3 on partitioned t/z/y and
      local Xh >= 2 on a partitioned x.

    Returns ((n_t, n_z, n_y, n_x), dims_local, xh_loc)."""
    counts = _mesh_counts(mesh)
    n_t, n_z, n_y, n_x = counts
    if tz_only and (n_y != 1 or n_x != 1):
        raise ValueError(f"{name} shards t/z only (y/x mesh axes must "
                         "be 1)")
    T, Z, Y, X = dims
    Xh = X // 2
    if Y % n_y or Xh % n_x:
        raise ValueError(
            f"{name}: Y={Y} / Xh={Xh} must divide evenly over the y/x "
            f"mesh axes ({n_y}/{n_x})")
    y_loc, xh_loc = Y // n_y, Xh // n_x
    t_loc, z_loc = int(psi_shape[-3]), int(psi_shape[-2])
    if psi_shape[-1] != y_loc * xh_loc:
        raise ValueError(
            f"{name}: local fused extent {psi_shape[-1]} != local "
            f"Y*Xh = {y_loc}*{xh_loc} (x-partitioned arrays must be "
            "block-contiguous — see parallel/mesh.fuse_block_layout)")
    for nn, ext, nm in ((n_t, t_loc, "T"), (n_z, z_loc, "Z"),
                        (n_y, y_loc, "Y")):
        if nn > 1 and ext % 2 != 0:
            raise ValueError(
                f"local {nm} extent {ext} must be even on a partitioned "
                f"axis (the checkerboard masks use local coordinates)")
        if nn > 1 and with_long and ext < 3:
            raise ValueError(
                "local extent < 3 on a partitioned axis: the Naik slab "
                "fix needs the 3-hop to cross at most one boundary")
    if n_x > 1 and with_long and xh_loc < 2:
        raise ValueError(
            "local Xh extent < 2 on a partitioned x axis: the Naik column "
            "fix needs the 3-hop to cross at most one boundary")
    dims_local = (t_loc, z_loc, y_loc, 2 * xh_loc)
    return counts, dims_local, xh_loc


@lru_cache(maxsize=None)
def _eo_r0_mask(T: int, Z: int, Y: int, parity: int):
    """(T, Z, Y, 1) numpy bool over LOCAL coordinates: True where the
    parity-p half-site occupies the even x slot (r = (t+z+y+p) % 2 == 0),
    broadcast over the column window.  Valid locally because partitioned
    t/z/y have even local extents."""
    t = np.arange(T)[:, None, None]
    z = np.arange(Z)[None, :, None]
    y = np.arange(Y)[None, None, :]
    return (((t + z + y + parity) % 2) == 0)[..., None]


_R0_ON: dict = {}


def _r0_on(dims_local, parity: int, device) -> torch.Tensor:
    key = (tuple(dims_local[:3]), parity, device)
    m = _R0_ON.get(key)
    if m is None:
        m = _R0_ON[key] = torch.from_numpy(
            _eo_r0_mask(*dims_local[:3], parity)).to(device)
    return m


def _eo_x_psi_sources(psis, xh_loc: int, exchange, name, w: int, r0s):
    """True/kernel psi source column stacks for the checkerboarded x
    fixes.

    The eo x hop is a SLOT-SELECT, not a roll: a target half-site at slot
    xh with slot parity r reads slot xh + k + r forward and xh + r - (k+1)
    backward, k = (nhop-1)//2.  With the fused axis split into rows of
    width ``xh_loc``, only the last/first w = k+1 columns can reach across
    the boundary: per window, the TRUE source (local edge columns
    extended by the neighbour's halo) and the KERNEL source (extended by
    the local same-row wrap), the (k + r)-th window of each per site.
    Sites whose hop stays local select identical columns in both, so
    their correction cancels exactly.  Returns lists over the
    sub-domains of (hi_true, hi_kern, lo_true, lo_kern), each (..., Y_loc,
    w) in the unfused view; the two halo stacks ride ONE exchange."""
    ufs = [p.reshape(p.shape[:-1] + (p.shape[-1] // xh_loc, xh_loc))
           for p in psis]
    firsts = [u.narrow(-1, 0, w) for u in ufs]
    lasts = [u.narrow(-1, xh_loc - w, w) for u in ufs]
    halo_hi, halo_lo = exchange(firsts, lasts, name)
    k = w - 1
    out = []
    for i, r0 in enumerate(r0s):
        first, last = firsts[i], lasts[i]

        def sel_hi(ext):
            return torch.where(r0, ext.narrow(-1, k, w),
                               ext.narrow(-1, k + 1, w))

        def sel_lo(ext):
            return torch.where(r0, ext.narrow(-1, 0, w), ext.narrow(-1, 1, w))

        wrap = torch.cat([last, first], dim=-1)
        out.append((sel_hi(torch.cat([last, halo_hi[i]], dim=-1)),
                    sel_hi(wrap),
                    sel_lo(torch.cat([halo_lo[i], first], dim=-1)),
                    sel_lo(wrap)))
    return out


def _wilson_eo_fix_x(outs, u_here, u_bw, psis, fio, name, exchange,
                     dims_local, target_parity: int):
    """Checkerboarded x-direction fixes, v2 gather form: the halo column a
    target needs depends on its slot parity (_eo_x_psi_sources); the hop
    algebra is the usual subtract-wrong/add-true pair against the local
    forward links (HIGH window) and the globally pre-shifted backward
    links (LOW window).  Window w=1.  x never carries the folded
    antiperiodic-t sign, so recon-12 faces rebuild unsigned."""
    w = 1
    r0s = [_r0_on(dims_local, target_parity, p.device) for p in psis]
    srcs = _eo_x_psi_sources(psis, fio.xcols, exchange, name, w, r0s)
    tf, tb = TABLES[(0, +1)], TABLES[(0, -1)]
    new = []
    for i, out in enumerate(outs):
        hi_true, hi_kern, lo_true, lo_kern = srcs[i]
        u_hi = _full_rows(fio.face(u_here[i][0], lo=False, n=w))
        corr = (_hop_term(hi_true, u_hi, tf, False)
                - _hop_term(hi_kern, u_hi, tf, False))
        out = fio.add(out, corr, lo=False, n=w)
        u_lo = _full_rows(fio.face(u_bw[i][0], lo=True, n=w))
        corr = (_hop_term(lo_true, u_lo, tb, True)
                - _hop_term(lo_kern, u_lo, tb, True))
        new.append(fio.add(out, corr, lo=True, n=w))
    return new


def _signs(mesh, name, n, mu, R, tb_sign):
    return [_t_edge_signs(mesh.coord(i, name), n, mu, R, tb_sign)
            for i in range(mesh.size)]


# -- the four entries -------------------------------------------------------

def dslash_pallas_sharded(gauge_pl: ShardedField, gauge_bw_pl: ShardedField,
                          psi_pl: ShardedField, X: int, mesh=None,
                          tb_sign: bool = True,
                          policy="xla_facefix") -> ShardedField:
    """Full-lattice Wilson hop sum on a mesh: B4 on every sub-domain, then
    the face fixes.  ``gauge_bw_pl`` is the sharded
    ``backward_gauge(gauge, X)`` of the GLOBAL field; row extent 2
    selects reconstruct-12; ``X`` is the GLOBAL x extent (the interior
    runs on the local row width X//n_x)."""
    mesh = _fields("dslash_pallas_sharded", mesh, gauge_pl, gauge_bw_pl,
                   psi_pl)
    counts, x_loc = _check_sharded_mesh("dslash_pallas_sharded",
                                        psi_pl.local_shape, X, mesh)
    n_t = counts[0]
    R = gauge_pl.local_shape[1]
    exchange = _make_exchange(policy, mesh)
    outs = [wpp.dslash_pallas_packed(g, p, x_loc, gauge_bw=gb,
                                     tb_sign=tb_sign and n_t == 1)
            for g, gb, p in zip(gauge_pl.blocks, gauge_bw_pl.blocks,
                                psi_pl.blocks)]
    for fio, name, n, mu in _axis_plan(counts, x_loc):
        if n == 1:
            continue                  # the periodic wrap is correct
        outs = _wilson_fix_faces_v2(outs, gauge_pl.blocks,
                                    gauge_bw_pl.blocks, psi_pl.blocks, fio,
                                    name, mu, exchange,
                                    _signs(mesh, name, n, mu, R, tb_sign))
    return ShardedField(outs, mesh, psi_pl.spec)


def dslash_eo_pallas_sharded(u_here_pl: ShardedField, u_bw_pl: ShardedField,
                             psi_pl: ShardedField, dims, target_parity: int,
                             mesh=None, out_dtype=None, tb_sign: bool = True,
                             policy="xla_facefix") -> ShardedField:
    """Checkerboarded Wilson hop D_{p <- 1-p} on a mesh, v2 gather form:
    B1 on every sub-domain, then the face fixes; all four directions
    partitionable.  ``u_bw_pl`` is the sharded ``backward_gauge_eo`` of
    the GLOBAL links (its shifts carry the cross-boundary links, so only
    psi faces move).  Row extent 2 selects reconstruct-12.  t/z/y hops
    keep the checkerboarded x-slot layout; the x direction is a
    slot-select with its own column fix (_wilson_eo_fix_x).  Partitioned
    t/z/y need EVEN local extents; the x mesh axis splits Xh slots
    block-contiguously.  ``dims`` is the GLOBAL (T, Z, Y, X)."""
    mesh = _fields("dslash_eo_pallas_sharded", mesh, u_here_pl, u_bw_pl,
                   psi_pl)
    counts, dims_local, xh_loc = _check_eo_mesh(
        "dslash_eo_pallas_sharded", mesh, psi_pl.local_shape, dims, False)
    n_t = counts[0]
    R = u_here_pl.local_shape[1]
    exchange = _make_exchange(policy, mesh)
    outs = [wpp.dslash_eo_pallas_packed(
                uh, ub, p, dims_local, target_parity, out_dtype=out_dtype,
                tb_sign=tb_sign and n_t == 1)
            for uh, ub, p in zip(u_here_pl.blocks, u_bw_pl.blocks,
                                 psi_pl.blocks)]
    for fio, name, n, mu in _axis_plan(counts, xh_loc):
        if n == 1:
            continue
        if name == "x":
            outs = _wilson_eo_fix_x(outs, u_here_pl.blocks, u_bw_pl.blocks,
                                    psi_pl.blocks, fio, name, exchange,
                                    dims_local, target_parity)
            continue
        outs = _wilson_fix_faces_v2(outs, u_here_pl.blocks, u_bw_pl.blocks,
                                    psi_pl.blocks, fio, name, mu, exchange,
                                    _signs(mesh, name, n, mu, R, tb_sign))
    return ShardedField(outs, mesh, psi_pl.spec)


def dslash_eo_pallas_sharded_v3(u_here_pl: ShardedField,
                                u_there_pl: ShardedField,
                                psi_pl: ShardedField, dims,
                                target_parity: int, mesh=None,
                                out_dtype=None, tb_sign: bool = True,
                                policy="xla_facefix") -> ShardedField:
    """Checkerboarded Wilson hop on a mesh, v3 scatter form: the copy-free
    eo hop (B10-eo) on every sub-domain, t/z mesh axes only (the scatter
    exterior sends products, which have no slot-select column fix).
    Forward hops read the target-parity links (u_here) against the next
    sub-domain's first psi plane; the backward hop sends the locally
    computed product U^dag psi built from the opposite-parity links
    (u_there).  ``dims`` is the GLOBAL (T, Z, Y, X)."""
    mesh = _fields("dslash_eo_pallas_sharded_v3", mesh, u_here_pl,
                   u_there_pl, psi_pl)
    counts, dims_local, xh_loc = _check_eo_mesh(
        "dslash_eo_pallas_sharded_v3", mesh, psi_pl.local_shape, dims,
        False, tz_only=True)
    n_t = counts[0]
    R = u_here_pl.local_shape[1]
    exchange = _make_exchange(policy, mesh)
    outs = [wpp.dslash_eo_pallas_packed_v3(
                uh, ut, p, dims_local, target_parity, out_dtype=out_dtype,
                tb_sign=tb_sign and n_t == 1)
            for uh, ut, p in zip(u_here_pl.blocks, u_there_pl.blocks,
                                 psi_pl.blocks)]
    for fio, name, n, mu in _axis_plan(counts, xh_loc):
        if n == 1:
            continue
        signs = [s for s, _ in _signs(mesh, name, n, mu, R, tb_sign)]
        outs = _wilson_fix_faces_v3(outs, u_here_pl.blocks,
                                    u_there_pl.blocks, psi_pl.blocks, fio,
                                    name, mu, exchange, signs)
    return ShardedField(outs, mesh, psi_pl.spec)


def dslash_pallas_sharded_v3(gauge_pl: ShardedField, psi_pl: ShardedField,
                             X: int, mesh=None, tb_sign: bool = True,
                             policy="xla_facefix") -> ShardedField:
    """Full-lattice Wilson hop on a mesh, v3: the copy-free B10 on every
    sub-domain, no backward-gauge copy anywhere.  The fix sends the
    backward PRODUCT once per face — one f32 spinor face per partitioned
    direction, no link exchange.  All four directions partition; row
    extent 2 selects reconstruct-12.  ``X`` is the GLOBAL x extent."""
    mesh = _fields("dslash_pallas_sharded_v3", mesh, gauge_pl, psi_pl)
    counts, x_loc = _check_sharded_mesh("dslash_pallas_sharded_v3",
                                        psi_pl.local_shape, X, mesh)
    n_t = counts[0]
    R = gauge_pl.local_shape[1]
    exchange = _make_exchange(policy, mesh)
    outs = [wpp.dslash_pallas_packed_v3(g, p, x_loc,
                                        tb_sign=tb_sign and n_t == 1)
            for g, p in zip(gauge_pl.blocks, psi_pl.blocks)]
    for fio, name, n, mu in _axis_plan(counts, x_loc):
        if n == 1:
            continue
        signs = [s for s, _ in _signs(mesh, name, n, mu, R, tb_sign)]
        outs = _wilson_fix_faces_v3(outs, gauge_pl.blocks, gauge_pl.blocks,
                                    psi_pl.blocks, fio, name, mu, exchange,
                                    signs)
    return ShardedField(outs, mesh, psi_pl.spec)
