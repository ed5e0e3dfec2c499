"""The fused clover / twisted eo hop (B7, K1 and K2) and its plain versions.

Replaces quda_tpu/ops/clover_pallas.py::_fused_eo_call (the Pallas TPU
kernel: the B1 hop with the family diagonal in its epilogue) with the
hand-written CUDA kernel ``csrc/clover_eo.cu``.  Two shapes serve the
Schur operators M_pc = diag_p - kappa^2 D_{p<-q} Ainv_q D_{q<-p} of the
clover, twisted-mass and twisted-clover families:

* K1 ``dslash_eo_pallas_post``: out = B v, or with ``twist=(c, scale)``
  and no blocks out = scale (v + i c g5 v), v = D_{p<-q} psi rounded to
  the output dtype before the epilogue (the staged rounding of the
  composition hop -> store dtype -> Ainv_q it replaces).
* K2 ``dslash_eo_pallas_diag_hop``: out = B x (or x) + i c g5 x (with
  ``diag_twist=c``) + hop_coeff * D_{p<-q} psi, x a sixth spinor operand
  at the target sites, float32 out.  The twist rotates the original x.

An epilogue needs blocks or a twist: the block-free forms (``blk_pl=None``)
are the twisted-mass ones.  The twist's scale is a multiply, as in the
TPU kernel; the staged composition divides by 1 + a^2 instead.

Layouts are the JAX package's pallas layout (ops/wilson_pallas_packed);
the blocks are models/clover.pack_clover_pairs' (2,6,6,2,T,Z,Y*Xh):
spins (0,1) -> chirality 0, (2,3) -> 1, block row i = 3*(s%2) + c.
Storage forms, each a kernel instance: psi, links and blocks all float32
or all bfloat16; R = 3 link rows or R = 2 (recon-12, ``tb_sign``); K1
writes the storage dtype, K2 float32; epilogues blocks or twist (K1),
blocks, twist or both (K2).

The multi-RHS forms (B7-mrhs) ``dslash_eo_pallas_post_mrhs`` and
``dslash_eo_pallas_diag_hop_mrhs`` replace the JAX module's
``_fused_eo_call_mrhs`` with ``csrc/clover_eo_mrhs.cu``: psi, x and out
carry a leading axis of N right-hand sides; a block stages its tile's
links and blocks in shared memory once for all N (``k_mrhs_plan``) and
each right-hand side sees K1's or K2's arithmetic.  Their forms are
float32 with full or recon-12 links and the same three epilogues; bf16
storage waits for ROADMAP B5.

The full-lattice operator ``clover_pallas_packed`` (B7 full) replaces the
JAX module's function of that name with ``csrc/clover_full.cu``:
M psi = A psi - kappa D psi (+ i c g5 psi with ``diag_twist=c``) in one
pass, the diagonal read at the centre site of psi itself.  Links and the
pre-shifted ``backward_gauge`` as B4 takes them, blocks (2,6,6,2,T,Z,Y*X)
on the full lattice (A = 1 + the clover term); forms ``full:f32->f32``
and ``r12:f32->f32``, with ``:blk+twist`` after a twisted one.

The wrappers dispatch on the tensors' device: CPU tensors run the plain
versions (``dslash_eo_post_plain``, ``dslash_eo_diag_hop_plain``, their
``_mrhs`` twins and ``clover_packed_plain``), CUDA tensors launch the
kernel or raise.  Each
wrapper counts its launches in ``.launches`` and per form in
``.launches_by_form`` (``"full:f32->f32"``, ``"r12:bf16->bf16"``, with
``":twist"`` or ``":blk+twist"`` after a twisted epilogue).
"""

from __future__ import annotations

import ctypes

import torch

from ..models.clover import apply_clover_pairs
from ..models.twisted import _ig5_rot_pairs
from ..utils import kernels
from . import wilson_pallas_packed as wpp

# Kernel vs plain version, max |kernel - plain| / max |plain|, for float32
# output: the same f32 terms summed in another order and with fused
# multiply-adds on the card.
TOLERANCE = 1e-6
# The same for bfloat16 output (K1 from bf16 storage): one bf16 ulp, at
# most 2^-7 of max |plain|, as for the eo hop.
TOLERANCE_BF16 = 2.0 ** -7
# The full-lattice operator: its hop is B4's, held to B4's tolerance.
FULL_TOLERANCE = wpp.TOLERANCE
# flops per target site: the hop, the two 6x6 complex block mat-vecs, and
# (K2) the axpy that adds the scaled hop
FLOPS_PER_SITE = {"post": wpp.FLOPS_PER_SITE + 504,
                  "diag_hop": wpp.FLOPS_PER_SITE + 504 + 48}
BLOCK_FLOPS_PER_SITE = 504
# the full-lattice operator per site: the hop and the block mat-vecs (R = 2
# adds the row rebuild, the twist TWIST_FLOPS_PER_SITE)
FULL_FLOPS_PER_SITE = wpp.FLOPS_PER_SITE + BLOCK_FLOPS_PER_SITE
# the twist epilogue: i c g5 v and the scale (K1) or the add (K2)
TWIST_FLOPS_PER_SITE = 72
_STORE_BYTES = {torch.float32: 4, torch.bfloat16: 2}

# K1/K2-mrhs's plan, as csrc/clover_eo_mrhs.cu's k_mrhs_plan makes it:
# B5-eo's tile plan (wpp.tile_plan), a block owning K_MRHS_TILE half-sites
# of one (t, z) plane, K_MRHS_LANES threads a half-site, the tile's links
# and, in the forms with blocks, its clover blocks in shared memory;
# tile and lanes keyed by whether the form has blocks (the block-free
# forms are the twisted-mass ones); K_MRHS_MIN_BLOCKS blocks an SM (the
# kernel's launch bound).  A thread takes its right-hand sides one at a
# time: K_MRHS_CHUNK, the only chunk width the kernel has.  All chosen by
# timing variants on the card (PERF.md); fold-mrhs and r12f-mrhs keep
# wpp.MRHS_CHUNK.
K_MRHS_TILE = {True: 64, False: 128}
K_MRHS_LANES = {True: 4, False: 2}
K_MRHS_MIN_BLOCKS = 2
K_MRHS_CHUNK = 1
SMEM_PER_BLOCK = 232448        # an H100 block's opt-in shared memory


def epilogue_name(with_blk: bool = True, twist: bool = False) -> str:
    """Suffix of an epilogue in ``launches_by_form``: "" (the clover
    blocks), ":twist" (block-free twist), ":blk+twist"."""
    if not twist:
        return ""
    return ":blk+twist" if with_blk else ":twist"


def bytes_per_site(kind: str, rows: int = 3,
                   store_dtype=torch.float32, with_blk: bool = True) -> int:
    """Floor of the device-memory traffic per target half-site, each
    input read once and the output written once: psi 24 numbers, links
    8 x rows x 3 complex, blocks 2 x 6 x 6 complex (none without blocks),
    out 24 (K1 in the storage dtype, K2 in float32) and, for K2, x 24.
    The twist adds no bytes."""
    sb = _STORE_BYTES[store_dtype]
    hop_in = 24 * sb + 8 * rows * 3 * 2 * sb + (144 * sb if with_blk else 0)
    if kind == "post":
        return hop_in + 24 * sb
    return hop_in + 24 * 4 + 24 * sb


def bytes_per_site_full(rows: int = 3) -> int:
    """Floor of the full-lattice operator's traffic per site in float32:
    psi 24 numbers, links and their backward copy 8 x rows x 3 complex,
    blocks 2 x 6 x 6 complex, out 24: 1344 B (R = 2: 1152)."""
    return 48 * 4 + 8 * rows * 3 * 2 * 4 + 144 * 4


def flops_per_site_full(rows: int = 3, twist: bool = False) -> int:
    return (FULL_FLOPS_PER_SITE + (TWIST_FLOPS_PER_SITE if twist else 0)
            + (wpp.RECON_FLOPS_PER_SITE if rows == 2 else 0))


def bytes_per_site_mrhs(kind: str, n: int, rows: int = 3,
                        with_blk: bool = True) -> int:
    """Floor of B7-mrhs's traffic per target half-site for ``n``
    right-hand sides in float32: the links and blocks once, each spinor
    (and for K2 each x) read once and each output written once."""
    per_rhs = 192 if kind == "post" else 288
    return (per_rhs * n + 8 * rows * 3 * 2 * 4
            + (144 * 4 if with_blk else 0))


def _epilogue_flops(kind: str, with_blk: bool, twist: bool) -> int:
    return (FLOPS_PER_SITE[kind] - (0 if with_blk else BLOCK_FLOPS_PER_SITE)
            + (TWIST_FLOPS_PER_SITE if twist else 0))


def flops_per_site(kind: str, rows: int = 3, with_blk: bool = True,
                   twist: bool = False) -> int:
    return (_epilogue_flops(kind, with_blk, twist)
            + (wpp.RECON_FLOPS_PER_SITE if rows == 2 else 0))


def flops_per_site_mrhs(kind: str, n: int, rows: int = 3,
                        with_blk: bool = True, twist: bool = False) -> int:
    return (_epilogue_flops(kind, with_blk, twist) * n
            + (wpp.RECON_FLOPS_PER_SITE if rows == 2 else 0))


def out_dtype_of(kind: str, store_dtype):
    """The output dtype of each kernel instance."""
    return store_dtype if kind == "post" else torch.float32


def _post_epilogue(hop, blk_pl, twist, out_dtype):
    """K1's epilogue on the hop, already rounded to ``out_dtype``: the
    blocks and the twist in float32, rounded once more."""
    v = (apply_clover_pairs(blk_pl, hop, torch.float32) if blk_pl is not None
         else hop.to(torch.float32))
    if twist is not None:
        c, scale = twist
        v = (v + _ig5_rot_pairs(v, c)) * scale
    return v.to(out_dtype)


def _diag_epilogue(hop, xc_pl, blk_pl, diag_twist, hop_coeff, out_dtype):
    """K2's epilogue: B x (or x) + i c g5 x + hop_coeff * hop in float32."""
    d = (apply_clover_pairs(blk_pl, xc_pl, torch.float32)
         if blk_pl is not None else xc_pl.to(torch.float32))
    if diag_twist is not None:
        d = d + _ig5_rot_pairs(xc_pl, diag_twist)
    return (d + hop_coeff * hop).to(out_dtype)


def dslash_eo_post_plain(u_here_pl, u_bw_pl, psi_pl, blk_pl, dims,
                         target_parity: int, out_dtype=None,
                         tb_sign: bool = True, twist=None) -> torch.Tensor:
    """Plain version of K1: the B1 hop rounded to ``out_dtype`` (default
    psi's), then the blocks and the twist in float32, rounded once more."""
    odt = out_dtype or psi_pl.dtype
    hop = wpp.dslash_eo_packed_plain(u_here_pl, u_bw_pl, psi_pl, dims,
                                     target_parity, odt, tb_sign)
    return _post_epilogue(hop, blk_pl, twist, odt)


def dslash_eo_diag_hop_plain(u_here_pl, u_bw_pl, psi_pl, xc_pl, blk_pl,
                             dims, target_parity: int, hop_coeff: float,
                             out_dtype=None, tb_sign: bool = True,
                             diag_twist=None) -> torch.Tensor:
    """Plain version of K2: B x + i c g5 x + hop_coeff * hop, all in
    float32."""
    hop = wpp.dslash_eo_packed_plain(u_here_pl, u_bw_pl, psi_pl, dims,
                                     target_parity, torch.float32, tb_sign)
    return _diag_epilogue(hop, xc_pl, blk_pl, diag_twist, hop_coeff,
                          out_dtype or psi_pl.dtype)


def dslash_eo_post_mrhs_plain(u_here_pl, u_bw_pl, psi_pl, blk_pl, dims,
                              target_parity: int, out_dtype=None,
                              tb_sign: bool = True,
                              twist=None) -> torch.Tensor:
    """Plain version of K1-mrhs: ``dslash_eo_post_plain`` broadcast over
    the leading RHS axis of psi."""
    odt = out_dtype or psi_pl.dtype
    hop = wpp.dslash_eo_packed_mrhs_plain(u_here_pl, u_bw_pl, psi_pl, dims,
                                          target_parity, odt, tb_sign)
    return _post_epilogue(hop, blk_pl, twist, odt)


def dslash_eo_diag_hop_mrhs_plain(u_here_pl, u_bw_pl, psi_pl, xc_pl, blk_pl,
                                  dims, target_parity: int,
                                  hop_coeff: float, out_dtype=None,
                                  tb_sign: bool = True,
                                  diag_twist=None) -> torch.Tensor:
    """Plain version of K2-mrhs: ``dslash_eo_diag_hop_plain`` broadcast
    over the leading RHS axis of psi and x."""
    hop = wpp.dslash_eo_packed_mrhs_plain(u_here_pl, u_bw_pl, psi_pl, dims,
                                          target_parity, torch.float32,
                                          tb_sign)
    return _diag_epilogue(hop, xc_pl, blk_pl, diag_twist, hop_coeff,
                          out_dtype or psi_pl.dtype)


def k_mrhs_plan(rows: int, with_blk: bool, T: int, Z: int, Y: int,
                Xh: int) -> dict:
    """K1/K2-mrhs's launch on T x Z x Y x Xh half-sites with R = ``rows``,
    for a form with or without blocks (``wpp.tile_plan``)."""
    return wpp.tile_plan(T, Z, Y * Xh, K_MRHS_TILE[with_blk],
                         K_MRHS_LANES[with_blk],
                         2 * 24 * rows + (144 if with_blk else 0))


def k_mrhs_chunk(chunk, nrhs: int, rows: int, with_blk: bool, T: int,
                 Z: int, Y: int, Xh: int) -> int:
    """K1/K2-mrhs's chunk width, ``K_MRHS_CHUNK`` (``chunk`` may be None
    or that); raises ValueError, naming the limit, for another width, no
    right-hand side, a grid beyond 2^31 - 1 blocks or a plan above a
    block's 227 KB of shared memory."""
    if chunk is not None and int(chunk) != K_MRHS_CHUNK:
        raise ValueError(f"chunk {chunk}: K1/K2-mrhs take one right-hand "
                         f"side a thread at a time (chunk {K_MRHS_CHUNK})")
    plan = wpp.check_tile_grid("K1/K2-mrhs", nrhs,
                               k_mrhs_plan(rows, with_blk, T, Z, Y, Xh))
    if plan["smem"] > SMEM_PER_BLOCK:
        raise ValueError(f"K1/K2-mrhs: {plan['smem']} bytes of shared "
                         "memory a block, beyond the card's 227 KB "
                         f"({SMEM_PER_BLOCK})")
    return K_MRHS_CHUNK


def k_mrhs_info(kind: str, rows: int, T: int, Z: int, Y: int, Xh: int,
                with_blk: bool = True, twist: bool = False) -> dict:
    """K1/K2-mrhs's resources on the card for one form
    (``wpp.tile_info``)."""
    return wpp.tile_info("qtt_clover_eo_mrhs_info", T, Z, Y, Xh, rows,
                         int(kind == "diag_hop"), int(with_blk), int(twist))


def _check_args(target_parity, blk_pl, twist, kind="diag_hop"):
    if blk_pl is None and twist is None:
        raise ValueError(
            "the fused hop's epilogue needs blocks (blk_pl) or a twist; "
            "the bare hop is dslash_eo_pallas_packed")
    if kind == "post" and blk_pl is not None and twist is not None:
        raise ValueError(
            "K1 takes blocks or a twist, not both: its twist is the "
            "block-free twisted-mass form, and the twisted clover folds its "
            "twist into the blocks")
    if target_parity not in (0, 1):
        raise ValueError(f"target_parity must be 0 or 1, got {target_parity}")


def _twist_args(kind, twist):
    """(twist flag, c, scale) of the C entry: K1's ``twist=(c, scale)``,
    K2's ``diag_twist=c``."""
    if twist is None:
        return 0, 0.0, 1.0
    if kind == "post":
        c, scale = twist
        return 1, float(c), float(scale)
    return 1, float(twist), 1.0


def _launch(wrapper, kind, u_here_pl, u_bw_pl, psi_pl, xc_pl, blk_pl, dims,
            target_parity, out_dtype, hop_coeff, tb_sign, rows, twist):
    """Check the operands and launch one kernel instance on the card."""
    T, Z, Y, X = dims
    Xh = X // 2
    store = psi_pl.dtype
    if store not in _STORE_BYTES:
        raise TypeError(f"psi {store}: the kernel takes float32 or bfloat16")
    if out_dtype != out_dtype_of(kind, store):
        raise TypeError(f"{kind}: {store} storage with {out_dtype} output "
                        "has no kernel instance")
    sites = (T, Z, Y * Xh)
    kernels.require(psi_pl, "psi_pl", (4, 3, 2) + sites, store)
    kernels.require(u_here_pl, "u_here_pl", (4, rows, 3, 2) + sites, store)
    kernels.require(u_bw_pl, "u_bw_pl", (4, rows, 3, 2) + sites, store)
    if blk_pl is not None:
        kernels.require(blk_pl, "blk_pl", (2, 6, 6, 2) + sites, store)
    if xc_pl is not None:
        kernels.require(xc_pl, "xc_pl", (4, 3, 2) + sites, store)
    tw, tw_c, tw_scale = _twist_args(kind, twist)
    lib = kernels.library()
    out = torch.empty(psi_pl.shape, dtype=out_dtype, device=psi_pl.device)
    rc = lib.qtt_clover_eo(
        out.data_ptr(), psi_pl.data_ptr(), u_here_pl.data_ptr(),
        u_bw_pl.data_ptr(), None if blk_pl is None else blk_pl.data_ptr(),
        None if xc_pl is None else xc_pl.data_ptr(), T, Z, Y, Xh,
        int(target_parity), int(store == torch.bfloat16), rows,
        int(bool(tb_sign)), int(kind == "diag_hop"),
        ctypes.c_float(hop_coeff), int(blk_pl is not None), tw,
        ctypes.c_float(tw_c), ctypes.c_float(tw_scale),
        kernels.stream_of(psi_pl))
    kernels.check_launch(rc, "qtt_clover_eo")
    wpp._count(wrapper, wpp.form_name(rows, store, out_dtype)
               + epilogue_name(blk_pl is not None, bool(tw)))
    return out


def dslash_eo_pallas_post(u_here_pl, u_bw_pl, psi_pl, dims,
                          target_parity: int, *, blk_pl=None, twist=None,
                          out_dtype=None, tb_sign: bool = True):
    """K1: E(D_{p<-q} psi) in one pass, E the resident chiral blocks
    ``blk_pl`` (e.g. the clover inverse A_q^-1, or the dense twisted-clover
    inverse) or the twist ``twist=(c, scale)``: v -> scale (v + i c g5 v).
    Output in ``out_dtype`` (default psi's; the kernel writes the storage
    dtype)."""
    _check_args(target_parity, blk_pl, twist, "post")
    rows = wpp.link_rows(u_here_pl)
    kind = kernels.dispatch_device(
        *[t for t in (u_here_pl, u_bw_pl, psi_pl, blk_pl) if t is not None])
    out_dtype = out_dtype or psi_pl.dtype
    if kind == "cpu":
        return dslash_eo_post_plain(u_here_pl, u_bw_pl, psi_pl, blk_pl, dims,
                                    target_parity, out_dtype, tb_sign, twist)
    return _launch(dslash_eo_pallas_post, "post", u_here_pl, u_bw_pl, psi_pl,
                   None, blk_pl, dims, target_parity, out_dtype, 0.0,
                   tb_sign, rows, twist)


def dslash_eo_pallas_diag_hop(u_here_pl, u_bw_pl, psi_pl, xc_pl, dims,
                              target_parity: int, *, hop_coeff: float,
                              blk_pl=None, diag_twist=None, out_dtype=None,
                              tb_sign: bool = True):
    """K2: B x (+ i c g5 x with ``diag_twist=c``) + hop_coeff *
    D_{p<-q} psi in one pass, x = ``xc_pl`` at the target sites (e.g. A_p
    x - kappa^2 D t), B optional.  Pass ``out_dtype=torch.float32``, the
    kernel's output."""
    _check_args(target_parity, blk_pl, diag_twist)
    rows = wpp.link_rows(u_here_pl)
    kind = kernels.dispatch_device(
        *[t for t in (u_here_pl, u_bw_pl, psi_pl, xc_pl, blk_pl)
          if t is not None])
    out_dtype = out_dtype or psi_pl.dtype
    if kind == "cpu":
        return dslash_eo_diag_hop_plain(u_here_pl, u_bw_pl, psi_pl, xc_pl,
                                        blk_pl, dims, target_parity,
                                        hop_coeff, out_dtype, tb_sign,
                                        diag_twist)
    return _launch(dslash_eo_pallas_diag_hop, "diag_hop", u_here_pl, u_bw_pl,
                   psi_pl, xc_pl, blk_pl, dims, target_parity, out_dtype,
                   float(hop_coeff), tb_sign, rows, diag_twist)


def _check_mrhs_plan(chunk, psi_pl, u_here_pl, blk_pl, dims) -> None:
    """The launch's chunk width and plan, checked before any launch."""
    T, Z, Y, X = dims
    k_mrhs_chunk(chunk, psi_pl.shape[0], wpp.link_rows(u_here_pl),
                 blk_pl is not None, T, Z, Y, X // 2)


def _launch_mrhs(wrapper, kind, u_here_pl, u_bw_pl, psi_pl, xc_pl, blk_pl,
                 dims, target_parity, out_dtype, hop_coeff, tb_sign, rows,
                 twist):
    """Check the operands and launch one multi-RHS kernel instance."""
    T, Z, Y, X = dims
    Xh = X // 2
    f32 = torch.float32
    if psi_pl.dtype != f32 or out_dtype != f32:
        raise TypeError(f"{kind}_mrhs: psi {psi_pl.dtype} -> out "
                        f"{out_dtype}: the multi-RHS clover hop has float32 "
                        "forms only; bf16 storage waits for ROADMAP B5")
    sites = (T, Z, Y * Xh)
    nrhs = psi_pl.shape[0]
    kernels.require(psi_pl, "psi_pl", (nrhs, 4, 3, 2) + sites, f32)
    kernels.require(u_here_pl, "u_here_pl", (4, rows, 3, 2) + sites, f32)
    kernels.require(u_bw_pl, "u_bw_pl", (4, rows, 3, 2) + sites, f32)
    if blk_pl is not None:
        kernels.require(blk_pl, "blk_pl", (2, 6, 6, 2) + sites, f32)
    if xc_pl is not None:
        kernels.require(xc_pl, "xc_pl", (nrhs, 4, 3, 2) + sites, f32)
    tw, tw_c, tw_scale = _twist_args(kind, twist)
    lib = kernels.library()
    out = torch.empty(psi_pl.shape, dtype=f32, device=psi_pl.device)
    rc = lib.qtt_clover_eo_mrhs(
        out.data_ptr(), psi_pl.data_ptr(), u_here_pl.data_ptr(),
        u_bw_pl.data_ptr(), None if blk_pl is None else blk_pl.data_ptr(),
        None if xc_pl is None else xc_pl.data_ptr(), T, Z, Y, Xh,
        int(target_parity), rows, int(bool(tb_sign)),
        int(kind == "diag_hop"), ctypes.c_float(hop_coeff),
        int(blk_pl is not None), tw, ctypes.c_float(tw_c),
        ctypes.c_float(tw_scale), nrhs, kernels.stream_of(psi_pl))
    kernels.check_launch(rc, "qtt_clover_eo_mrhs")
    wpp._count(wrapper, wpp.form_name(rows, f32, f32)
               + epilogue_name(blk_pl is not None, bool(tw)))
    return out


def dslash_eo_pallas_post_mrhs(u_here_pl, u_bw_pl, psi_pl, dims,
                               target_parity: int, *, blk_pl=None,
                               twist=None, out_dtype=None,
                               tb_sign: bool = True, chunk=None):
    """K1 over a batch: E(D_{p<-q} psi_r) for psi (N,4,3,2,T,Z,Y*Xh), E
    as for ``dslash_eo_pallas_post``, the links and blocks read from
    device memory once for all N; a thread works through its right-hand
    sides one at a time (``chunk``: None or ``K_MRHS_CHUNK``)."""
    _check_args(target_parity, blk_pl, twist, "post")
    rows = wpp.link_rows(u_here_pl)
    wpp.check_batch(psi_pl)
    _check_mrhs_plan(chunk, psi_pl, u_here_pl, blk_pl, dims)
    kind = kernels.dispatch_device(
        *[t for t in (u_here_pl, u_bw_pl, psi_pl, blk_pl) if t is not None])
    out_dtype = out_dtype or psi_pl.dtype
    if kind == "cpu":
        return dslash_eo_post_mrhs_plain(u_here_pl, u_bw_pl, psi_pl, blk_pl,
                                         dims, target_parity, out_dtype,
                                         tb_sign, twist)
    return _launch_mrhs(dslash_eo_pallas_post_mrhs, "post", u_here_pl,
                        u_bw_pl, psi_pl, None, blk_pl, dims, target_parity,
                        out_dtype, 0.0, tb_sign, rows, twist)


def dslash_eo_pallas_diag_hop_mrhs(u_here_pl, u_bw_pl, psi_pl, xc_pl, dims,
                                   target_parity: int, *, hop_coeff: float,
                                   blk_pl=None, diag_twist=None,
                                   out_dtype=None, tb_sign: bool = True,
                                   chunk=None):
    """K2 over a batch: B x_r (+ i c g5 x_r) + hop_coeff * D_{p<-q} psi_r,
    x batched like psi, ``chunk`` as for ``dslash_eo_pallas_post_mrhs``.
    Pass ``out_dtype=torch.float32``, the kernel's output."""
    _check_args(target_parity, blk_pl, diag_twist)
    rows = wpp.link_rows(u_here_pl)
    wpp.check_batch(psi_pl)
    _check_mrhs_plan(chunk, psi_pl, u_here_pl, blk_pl, dims)
    kind = kernels.dispatch_device(
        *[t for t in (u_here_pl, u_bw_pl, psi_pl, xc_pl, blk_pl)
          if t is not None])
    out_dtype = out_dtype or psi_pl.dtype
    if kind == "cpu":
        return dslash_eo_diag_hop_mrhs_plain(u_here_pl, u_bw_pl, psi_pl,
                                             xc_pl, blk_pl, dims,
                                             target_parity, hop_coeff,
                                             out_dtype, tb_sign, diag_twist)
    return _launch_mrhs(dslash_eo_pallas_diag_hop_mrhs, "diag_hop",
                        u_here_pl, u_bw_pl, psi_pl, xc_pl, blk_pl, dims,
                        target_parity, out_dtype, float(hop_coeff), tb_sign,
                        rows, diag_twist)


def clover_packed_plain(gauge_pl, gauge_bw, blk_pl, psi_pl, X: int,
                        kappa: float, diag_twist=None,
                        tb_sign: bool = True) -> torch.Tensor:
    """Plain version of the full-lattice operator: B4's plain hop, then
    K2's epilogue with x = psi and coeff = -kappa (A psi + i c g5 psi -
    kappa hop, float32)."""
    hop = wpp.dslash_packed_plain(gauge_pl, gauge_bw, psi_pl, X, tb_sign)
    return _diag_epilogue(hop, psi_pl, blk_pl, diag_twist, -float(kappa),
                          psi_pl.dtype)


def clover_pallas_packed(gauge_pl, blk_pl, psi_pl, X: int, kappa: float,
                         diag_twist=None, interpret: bool = False,
                         block_z=None, gauge_bw=None,
                         tb_sign: bool = True) -> torch.Tensor:
    """Full-lattice fused M psi = A psi - kappa D psi (+ i c g5 psi with
    ``diag_twist=c``) in one pass (B7 full).  gauge_pl (4,R,3,2,T,Z,YX),
    boundary phase folded in, R = 3 or 2 (``tb_sign`` as B4's); blk_pl
    (2,6,6,2,T,Z,YX) the blocks of A; psi_pl (4,3,2,T,Z,YX); float32.
    ``gauge_bw`` is ``backward_gauge(gauge_pl, X)`` (built here when not
    given).  ``interpret`` and ``block_z`` (the TPU kernel's) are accepted
    and ignored."""
    rows = wpp.link_rows(gauge_pl)
    if gauge_bw is None:
        gauge_bw = wpp.backward_gauge(gauge_pl, X)
    kind = kernels.dispatch_device(gauge_pl, gauge_bw, blk_pl, psi_pl)
    if kind == "cpu":
        return clover_packed_plain(gauge_pl, gauge_bw, blk_pl, psi_pl, X,
                                   kappa, diag_twist, tb_sign)
    f32 = torch.float32
    if psi_pl.dtype != f32:
        raise TypeError(f"psi {psi_pl.dtype}: the full-lattice clover "
                        "operator has float32 forms only; its bf16 and "
                        "float64 forms wait for ROADMAP A7")
    T, Z, YX = psi_pl.shape[-3:]
    if YX % X:
        raise ValueError(f"fused axis {YX} is not a multiple of X = {X}")
    sites = (T, Z, YX)
    kernels.require(psi_pl, "psi_pl", (4, 3, 2) + sites, f32)
    kernels.require(gauge_pl, "gauge_pl", (4, rows, 3, 2) + sites, f32)
    kernels.require(gauge_bw, "gauge_bw", (4, rows, 3, 2) + sites, f32)
    kernels.require(blk_pl, "blk_pl", (2, 6, 6, 2) + sites, f32)
    twist = diag_twist is not None
    out = torch.empty(psi_pl.shape, dtype=f32, device=psi_pl.device)
    rc = kernels.library().qtt_clover_full(
        out.data_ptr(), psi_pl.data_ptr(), gauge_pl.data_ptr(),
        gauge_bw.data_ptr(), blk_pl.data_ptr(), T, Z, YX // X, X, rows,
        int(bool(tb_sign)), ctypes.c_float(-float(kappa)), int(twist),
        ctypes.c_float(float(diag_twist) if twist else 0.0),
        kernels.stream_of(psi_pl))
    kernels.check_launch(rc, "qtt_clover_full")
    wpp._count(clover_pallas_packed,
               wpp.form_name(rows, f32, f32) + epilogue_name(True, twist))
    return out


def reset_launches() -> None:
    """Zero the launch counts of K1 and K2, single- and multi-RHS, and of
    the full-lattice operator."""
    for fn in (dslash_eo_pallas_post, dslash_eo_pallas_diag_hop,
               dslash_eo_pallas_post_mrhs, dslash_eo_pallas_diag_hop_mrhs,
               clover_pallas_packed):
        fn.launches = 0
        fn.launches_by_form = {}


reset_launches()
