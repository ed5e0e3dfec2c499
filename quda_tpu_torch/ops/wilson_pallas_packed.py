"""The even/odd Wilson hop kernel (B1), its other forms, and their plain
versions.

Replaces quda_tpu/ops/wilson_pallas_packed.py::dslash_eo_pallas_packed
(the Pallas TPU kernel, ``_make_kernel(eo=...)``) with the hand-written
CUDA kernel ``csrc/wilson_eo.cu``.  Layouts are the JAX package's pallas
layout:

    psi, out    (4, 3, 2, T, Z, Y*Xh)
    u_here      (4, R, 3, 2, T, Z, Y*Xh)   forward links at target sites
    u_bw        (4, R, 3, 2, T, Z, Y*Xh)   backward_gauge_eo: U_mu(x - mu)

Storage forms, each a kernel instance: psi and links both float32 or both
bfloat16; out float32, or bfloat16 from bf16 storage; R = 3 link rows
(``full``) or R = 2 (``r12``, ``to_recon12``: row 2 = conj(row0 x row1)
rebuilt at use, with ``tb_sign`` negating it on the antiperiodic t
boundary planes).  Sums are float32 in every form.

The native double form ``full:f64->f64`` (psi, links and out float64,
R = 3, sums in float64) is the precise operator of the double routes; it
has no TPU twin (a TPU has no f64), and its oracle is the complex128
plain version.

The full-lattice hop (B4) ``dslash_pallas_packed`` replaces
dslash_pallas_packed of the same JAX module (``_make_kernel`` with no eo)
with ``csrc/wilson_full.cu``: psi and out (4, 3, 2, T, Z, Y*X), links and
the pre-shifted ``backward_gauge`` (4, R, 3, 2, T, Z, Y*X); forms
``full:f32->f32``, ``r12:f32->f32`` and ``full:f64->f64``.

The multi-RHS hop (B5-eo) ``dslash_eo_pallas_packed_mrhs`` replaces
dslash_eo_pallas_packed_mrhs of the same JAX module with
``csrc/wilson_eo_mrhs.cu``: psi and out carry a leading axis of N
right-hand sides, (N, 4, 3, 2, T, Z, Y*Xh).  A block copies its tile's
links into shared memory once and loops over all N right-hand sides,
``chunk`` a thread at a time (``eo_mrhs_plan``), so each link leaves
device memory once; each right-hand side gets B1's arithmetic in B1's
order.  Its forms are ``full:f32->f32`` and ``r12:f32->f32``; the bf16
forms wait for ROADMAP B5.

The multi-RHS full-lattice hop (B5) ``dslash_pallas_packed_mrhs``
replaces dslash_pallas_packed_mrhs of the same JAX module with the
second entry of ``csrc/wilson_full.cu``: psi and out (N, 4, 3, 2, T, Z,
Y*X), links as for B4; forms ``full:f32->f32`` and ``r12:f32->f32``.  A
block copies its tile's links into shared memory once and loops over all
N right-hand sides, ``chunk`` a thread at a time (``full_mrhs_plan``), so
each link leaves device memory once.  Each right-hand side gets B4's
arithmetic in B4's order.  The multigrid
set-up's null-vector block solve runs it (mg/pair.py).

The copy-free full-lattice hop (B10) ``dslash_pallas_packed_v3`` replaces
dslash_pallas_packed_v3 of the same JAX module with the third entry of
``csrc/wilson_full.cu``: B4's layouts with no ``backward_gauge`` copy (the
backward hop reads U_mu(x - mu) unshifted at the neighbour); forms
``full:f32->f32`` and ``r12:f32->f32``, each output B4's on
``backward_gauge(gauge_pl)`` bit for bit.

The copy-free eo hops ``dslash_eo_pallas_packed_v3`` (B10-eo) and
``dslash_eo_pallas_packed_r12f`` (B9) replace the JAX module's
functions of those names with ``csrc/wilson_eo_there.cu``: they take the
opposite parity's links ``u_there`` unshifted in place of ``u_bw`` and
read U_mu(x - mu) there, so no resident backward copy exists.  On the
card the two are one function (one C entry, B1's six f32/bf16 forms, R
= 3 or 2), each wrapper with its own launch count; each output is B1's
on ``backward_gauge_eo(u_there)`` bit for bit.
``dslash_eo_pallas_packed_r12f_mrhs`` is its multi-RHS form (float32,
chunk as B5-eo's).

The int8 hop ``dslash_eo_pallas_packed_int8`` (B9) replaces the JAX
function of that name with ``csrc/wilson_eo_int8.cu``: links as int8
mantissas (4,3,3,2,T,Z,Y*Xh) and one float32 scale per (direction,
site) (4,T,Z,Y*Xh) (ops/blockfloat.to_int8_links), decoded at load
exactly as ``from_int8_links``; forms ``int8:f32->f32``,
``int8:bf16->bf16`` and ``int8:bf16->f32`` (psi -> out).

The fold hops ``dslash_eo_pallas_packed_fold`` and
``dslash_eo_pallas_packed_fold_mrhs`` (B9) replace the JAX module's
functions of those names with ``csrc/wilson_eo_fold.cu``: B1 and B5-eo on
the folded layout of ``to_fold`` (the re/im axis interleaved into z:
psi (4,3,T,2Z,Y*Xh), links (4,R,3,T,2Z,Y*Xh), a batch (N,4,3,T,2Z,Y*Xh)),
each output B1's on the unfolded operands bit for bit.  The fold hop
takes B1's f32/bf16 forms (R = 3 or 2); the multi-RHS fold hop float32
(R = 3 or 2) on B5-eo's design, its tile's links copied in the order
``TileShifted`` reads (``fold_mrhs_plan``, ``fold_tile_sources``); its
bf16 forms wait for ROADMAP A7.

The wrappers dispatch on the tensors' device: CPU tensors run the plain
versions (``dslash_eo_packed_plain``, ``dslash_packed_plain``,
``dslash_packed_v3_plain``, ``dslash_eo_packed_mrhs_plain``,
``dslash_packed_mrhs_plain``, ``dslash_eo_there_plain``, ``dslash_eo_there_mrhs_plain``,
``dslash_eo_int8_plain``, ``dslash_eo_fold_plain``,
``dslash_eo_fold_mrhs_plain``), CUDA tensors launch the kernel or raise.
Each wrapper counts its launches in ``.launches`` and per form in
``.launches_by_form`` (``"full:f32->f32"``, ``"r12:bf16->bf16"``,
``"int8:bf16->bf16"``, ...).
"""

from __future__ import annotations

import torch

from ..utils import kernels
from . import wilson_packed as wpk

# Kernel vs plain version, max |kernel - plain| / max |plain|, for float32
# output (from f32 or bf16 storage: the same inputs, f32 sums in another
# order and with fused multiply-adds on the card).
TOLERANCE = 1e-5
# The same for bfloat16 output: both round f32 sums once, so an element
# whose sums differ near a rounding boundary moves by one bf16 ulp, at most
# 2^-7 of max |plain|.
TOLERANCE_BF16 = 2.0 ** -7
# Floor of the kernel's device-memory traffic per half-site in bytes, each
# input read once and the output written once (psi 24 numbers, links
# 8 x 9 or 8 x 6 complex, out 24), by (rows, storage bytes, out bytes).
FLOPS_PER_SITE = 1320
RECON_FLOPS_PER_SITE = 8 * 3 * 14
_STORE_BYTES = {torch.float32: 4, torch.bfloat16: 2, torch.float64: 8}
# the C entry points' storage codes
_STORE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
_SHORT = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float64: "f64"}


# Right-hand sides per thread of the multi-RHS kernels (the template
# argument NB of csrc/wilson_eo_mrhs.cu, wilson_full.cu, wilson_eo_there.cu
# and wilson_eo_fold.cu), and the default of r12f-mrhs (B5, B5-eo and
# fold-mrhs have their own; K1/K2-mrhs takes one at a time), chosen from
# ptxas' registers and the card's times (PERF.md):
# 2 is the fastest multi-RHS width (4 needs 206-240 registers and ran
# 1.3-2.4x slower); 1 gives each right-hand side its own thread, the
# single-RHS kernels' arithmetic, which the card tests hold them to.
MRHS_CHUNKS = (1, 2)
MRHS_CHUNK = 2
MRHS_THREADS = 128                 # threads per block of those kernels
_MAX_BLOCKS = 2 ** 31 - 1


def bytes_per_site(rows: int = 3, store_dtype=torch.float32,
                   out_dtype=None) -> int:
    sb = _STORE_BYTES[store_dtype]
    ob = _STORE_BYTES[out_dtype or store_dtype]
    return 24 * sb + 8 * rows * 3 * 2 * sb + 24 * ob


BYTES_PER_SITE = bytes_per_site()          # 768, the f32 full form


def bytes_per_site_v3(rows: int = 3, store_dtype=torch.float32) -> int:
    """Floor of a copy-free full-lattice hop's traffic per site (B10, and
    B11 with R = 3): psi and out 24 numbers each and the links once
    (4 x rows x 3 complex), no backward copy: 480 B f32 (R = 2: 384), 960
    B f64."""
    sb = _STORE_BYTES[store_dtype]
    return 48 * sb + 4 * rows * 3 * 2 * sb


def bytes_per_site_int8(store_dtype=torch.bfloat16, out_dtype=None) -> int:
    """Floor of the int8 hop's traffic per half-site: psi and out 24
    numbers each, 8 links of 18 one-byte mantissas and a 4-byte scale
    (272 B bf16 -> bf16, 320 bf16 -> f32, 368 f32 -> f32)."""
    sb = _STORE_BYTES[store_dtype]
    ob = _STORE_BYTES[out_dtype or store_dtype]
    return 24 * sb + 8 * (18 + 4) + 24 * ob


# the int8 hop's decode: one multiply per link element
INT8_FLOPS_PER_SITE = FLOPS_PER_SITE + 8 * 18


def bytes_per_site_mrhs(n: int, rows: int = 3) -> int:
    """Floor of B5-eo's traffic per target half-site for ``n`` right-hand
    sides in float32: each spinor read and written once (192 n), the
    links once (8 x rows x 3 complex)."""
    return 192 * n + 8 * rows * 3 * 2 * 4


def flops_per_site(rows: int = 3) -> int:
    return FLOPS_PER_SITE + (RECON_FLOPS_PER_SITE if rows == 2 else 0)


def flops_per_site_mrhs(n: int, rows: int = 3) -> int:
    """The hop's flops for ``n`` right-hand sides; recon-12 rebuilds each
    link once."""
    return FLOPS_PER_SITE * n + (RECON_FLOPS_PER_SITE if rows == 2 else 0)


def link_rows(u_here_pl) -> int:
    """R of links (4, R, 3, 2, T, Z, Y*Xh): 3 (full) or 2 (recon-12)."""
    rows = u_here_pl.shape[1] if u_here_pl.ndim == 7 else 0
    if rows not in (2, 3):
        raise ValueError(f"links of shape {tuple(u_here_pl.shape)}: "
                         "expected (4, R, 3, 2, T, Z, Y*Xh) with R = 3 "
                         "(full) or 2 (recon-12)")
    return rows


def check_batch(psi_pl) -> None:
    """Raise unless psi carries a leading RHS axis, (N,4,3,2,T,Z,Y*Xh)."""
    if psi_pl.ndim != 7:
        raise ValueError(f"psi of shape {tuple(psi_pl.shape)}: expected "
                         "(N, 4, 3, 2, T, Z, Y*Xh)")


def mrhs_chunk(chunk, nrhs: int, sites: int) -> int:
    """The chunk width of a multi-RHS launch (``MRHS_CHUNK`` unless given);
    raises for a width without a kernel instance or a batch whose grid
    (site blocks x chunks) exceeds 2^31 - 1 blocks."""
    nb = MRHS_CHUNK if chunk is None else int(chunk)
    if nb not in MRHS_CHUNKS:
        raise ValueError(f"chunk {nb}: the multi-RHS kernels have "
                         f"instances for {MRHS_CHUNKS}")
    check_mrhs_grid(nrhs, sites, nb)
    return nb


def check_mrhs_grid(nrhs: int, sites: int, nb: int) -> None:
    """Raise unless a batch of ``nrhs`` right-hand sides in chunks of
    ``nb`` at ``sites`` half-sites fits the multi-RHS kernels' grid
    (1 .. 2^31 - 1 blocks of MRHS_THREADS)."""
    blocks = -(-sites // MRHS_THREADS) * -(-nrhs // nb)
    if nrhs < 1 or blocks > _MAX_BLOCKS:
        raise ValueError(f"{nrhs} right-hand sides at {sites} half-sites: "
                         f"{blocks} blocks, outside the kernel's grid "
                         f"(1 .. {_MAX_BLOCKS})")


def tile_plan(T: int, Z: int, plane: int, tile: int, lanes: int,
              link_floats: int) -> dict:
    """The launch of a multi-RHS hop that stages its links in shared
    memory (csrc/mrhs_tile.cuh's tile_plan: B5, B5-eo, S2-mrhs-full) on T
    x Z planes of ``plane`` sites, ``tile`` sites and ``lanes`` threads a
    site a block, ``link_floats`` floats of the two link sets a site:
    ``tiles`` a (t, z) plane, ``blocks``, ``threads`` a block and dynamic
    shared memory ``smem`` a block in bytes."""
    tiles = -(-plane // tile)
    return {"tiles": tiles, "blocks": T * Z * tiles, "threads": lanes * tile,
            "smem": 4 * link_floats * tile}


def check_tile_grid(kernel: str, nrhs: int, plan: dict) -> dict:
    """Raise ValueError, naming the limit, for no right-hand side or a
    tiled grid beyond 2^31 - 1 blocks; else return ``plan``."""
    if nrhs < 1:
        raise ValueError(f"{nrhs} right-hand sides: {kernel} takes N >= 1")
    if plan["blocks"] > _MAX_BLOCKS:
        raise ValueError(f"{kernel}: {plan['blocks']} blocks "
                         f"({plan['tiles']} tiles a plane), beyond the "
                         "grid's 2^31 - 1")
    return plan


def tile_info(entry: str, *args: int) -> dict:
    """A tiled multi-RHS hop's resources on the card from its C query
    entry: ptxas ``registers``, ``smem_bytes`` a block, resident
    ``blocks_per_sm``, and ``threads``, ``tiles``, ``blocks`` of the plan
    it launches."""
    info = kernels.kernel_info(entry, *args)
    threads, tiles, blocks = info.pop("extra")
    return {**info, "threads": threads, "tiles": tiles, "blocks": blocks}


def _staged_chunk(chunk, default: int) -> int:
    nb = default if chunk is None else int(chunk)
    if nb not in MRHS_CHUNKS:
        raise ValueError(f"chunk {nb}: the multi-RHS kernels have "
                         f"instances for {MRHS_CHUNKS}")
    return nb


# B5's plan, as csrc/wilson_full.cu's full_mrhs_plan makes it: a block owns
# FULL_MRHS_TILE sites of one (t, z) plane, FULL_MRHS_LANES threads a site,
# and the tile's links (forward and backward) in shared memory.  Its
# default chunk is 1 right-hand side a thread, the faster width of the
# redesigned kernel on the card (PERF.md); 2 stays available.
FULL_MRHS_TILE = 128
FULL_MRHS_LANES = 2
FULL_MRHS_CHUNK = 1


def full_mrhs_plan(rows: int, T: int, Z: int, Y: int, X: int) -> dict:
    """B5's launch on a T x Z x Y x X lattice with R = ``rows``
    (``tile_plan``)."""
    return tile_plan(T, Z, Y * X, FULL_MRHS_TILE, FULL_MRHS_LANES,
                     2 * 24 * rows)


def full_mrhs_chunk(chunk, nrhs: int, rows: int, T: int, Z: int, Y: int,
                    X: int) -> int:
    """B5's chunk width (``FULL_MRHS_CHUNK`` unless given); raises
    ValueError for a width without a kernel instance (``MRHS_CHUNKS``),
    no right-hand side or a grid (T Z tiles of a plane) beyond 2^31 - 1
    blocks."""
    nb = _staged_chunk(chunk, FULL_MRHS_CHUNK)
    check_tile_grid("B5", nrhs, full_mrhs_plan(rows, T, Z, Y, X))
    return nb


def full_mrhs_info(rows: int, nb: int, T: int, Z: int, Y: int,
                   X: int) -> dict:
    """B5's resources on the card (``tile_info``)."""
    return tile_info("qtt_wilson_full_mrhs_info", T, Z, Y, X, rows, nb)


# B5-eo's plan, as csrc/wilson_eo_mrhs.cu's eo_mrhs_plan makes it: B5's on
# the half lattice, a block owns EO_MRHS_TILE half-sites of one (t, z)
# plane, EO_MRHS_LANES threads a half-site, the tile's links (forward and
# backward) in shared memory, EO_MRHS_MIN_BLOCKS blocks an SM at chunk 1
# (the kernel's launch bound).  Its default chunk is the faster width on
# the card (PERF.md).
EO_MRHS_TILE = 128
EO_MRHS_LANES = 2
EO_MRHS_MIN_BLOCKS = 2
EO_MRHS_CHUNK = 1


def eo_mrhs_plan(rows: int, T: int, Z: int, Y: int, Xh: int) -> dict:
    """B5-eo's launch on T x Z x Y x Xh half-sites with R = ``rows``
    (``tile_plan``)."""
    return tile_plan(T, Z, Y * Xh, EO_MRHS_TILE, EO_MRHS_LANES,
                     2 * 24 * rows)


def eo_mrhs_chunk(chunk, nrhs: int, rows: int, T: int, Z: int, Y: int,
                  Xh: int) -> int:
    """B5-eo's chunk width (``EO_MRHS_CHUNK`` unless given); raises
    ValueError for a width without a kernel instance (``MRHS_CHUNKS``),
    no right-hand side or a grid (T Z tiles of a plane) beyond 2^31 - 1
    blocks."""
    nb = _staged_chunk(chunk, EO_MRHS_CHUNK)
    check_tile_grid("B5-eo", nrhs, eo_mrhs_plan(rows, T, Z, Y, Xh))
    return nb


def eo_mrhs_info(rows: int, nb: int, T: int, Z: int, Y: int,
                 Xh: int) -> dict:
    """B5-eo's resources on the card (``tile_info``)."""
    return tile_info("qtt_wilson_eo_mrhs_info", T, Z, Y, Xh, rows, nb)


# fold-mrhs's plan, as csrc/wilson_eo_fold.cu's fold_mrhs_plan makes it:
# B5-eo's on the fold layout, a block owns FOLD_MRHS_TILE half-sites of one
# (t, z) row, FOLD_MRHS_LANES threads a half-site, the tile's links
# (forward and backward) in shared memory, FOLD_MRHS_MIN_BLOCKS blocks an
# SM (the kernel's launch bound).  A thread takes one right-hand side at a
# time, FOLD_MRHS_CHUNK, the faster width on the card (PERF.md), and the
# kernel's only one.
FOLD_MRHS_TILE = 128
FOLD_MRHS_LANES = 2
FOLD_MRHS_MIN_BLOCKS = 2
FOLD_MRHS_CHUNK = 1


def fold_mrhs_plan(rows: int, T: int, Z: int, Y: int, Xh: int) -> dict:
    """fold-mrhs's launch on T x Z x Y x Xh half-sites with R = ``rows``
    (``tile_plan``)."""
    return tile_plan(T, Z, Y * Xh, FOLD_MRHS_TILE, FOLD_MRHS_LANES,
                     2 * 24 * rows)


def fold_mrhs_chunk(chunk, nrhs: int, rows: int, T: int, Z: int, Y: int,
                    Xh: int) -> int:
    """fold-mrhs's chunk width, ``FOLD_MRHS_CHUNK`` (``chunk`` may be None
    or that); raises ValueError, naming the limit, for another width, no
    right-hand side or a grid (T Z tiles of a row) beyond 2^31 - 1
    blocks."""
    if chunk is not None and int(chunk) != FOLD_MRHS_CHUNK:
        raise ValueError(f"chunk {chunk}: fold-mrhs takes one right-hand "
                         f"side a thread at a time (chunk {FOLD_MRHS_CHUNK})")
    check_tile_grid("fold-mrhs", nrhs, fold_mrhs_plan(rows, T, Z, Y, Xh))
    return FOLD_MRHS_CHUNK


def fold_mrhs_info(rows: int, T: int, Z: int, Y: int, Xh: int) -> dict:
    """fold-mrhs's resources on the card (``tile_info``)."""
    return tile_info("qtt_wilson_eo_fold_mrhs_info", T, Z, Y, Xh, rows)


def fold_tile_sources(rows: int, T: int, Z: int, Y: int, Xh: int, t: int,
                      z: int, j: int, tile: int = FOLD_MRHS_TILE):
    """Where fold-mrhs's copy (csrc/mrhs_tile.cuh's copy_sets with the
    FoldPlanes hook) reads tile j of row (t, z) of a folded link set
    (4, R, 3, T, 2Z, Y*Xh): a (2 * 12 R, len) array of flat offsets whose
    plane q = 2c + p lands at tile plane q, component c's real (p = 0) and
    imaginary (p = 1) run.  ``len`` is the tile's half-sites (the row's
    last tile may be partial)."""
    yxh = Y * Xh
    n = T * Z * yxh
    row = t * Z + z
    start = row * yxh + j * tile
    length = min(tile, yxh - j * tile)
    fold_start = start + row * yxh          # FoldLayout.at(start, row)
    q = torch.arange(2 * 12 * rows)
    plane = (q // 2) * 2 * n + (q % 2) * yxh
    return plane[:, None] + fold_start + torch.arange(length)[None, :]


def form_name(rows: int, store_dtype, out_dtype) -> str:
    """``"full:f32->f32"``-style key of ``launches_by_form``."""
    return (f"{'r12' if rows == 2 else 'full'}:{_SHORT[store_dtype]}->"
            f"{_SHORT[out_dtype]}")


def _checked_forms(store, out_dtype, rows: int):
    """Raise for a (storage, out, rows) form without a kernel instance of
    B1/B4: f32 -> f32, bf16 -> bf16 or f32, and f64 -> f64 with R = 3."""
    if store not in _STORE_BYTES or out_dtype not in _STORE_BYTES:
        raise TypeError(f"psi {store} -> out {out_dtype}: the kernel takes "
                        "float32, bfloat16 or float64")
    f64 = torch.float64
    if (store == f64) != (out_dtype == f64) or (store == f64 and rows != 3):
        raise TypeError(f"psi {store} -> out {out_dtype}, R = {rows}: the "
                        "double form is full:f64->f64 only")
    if store == torch.float32 and out_dtype == torch.bfloat16:
        raise TypeError("float32 storage with bfloat16 output has no kernel "
                        "instance")


def int8_form_name(store_dtype, out_dtype) -> str:
    """``"int8:bf16->bf16"``-style key of the int8 hop's launches."""
    return f"int8:{_SHORT[store_dtype]}->{_SHORT[out_dtype]}"


def _count(fn, form: str) -> None:
    fn.launches += 1
    fn.launches_by_form[form] = fn.launches_by_form.get(form, 0) + 1


# -- layout conversion and the full-lattice backward links ----------------

def to_pallas_layout(arr: torch.Tensor) -> torch.Tensor:
    """complex packed (..., T, Z, YX) -> f32 pairs (..., 2, T, Z, YX)."""
    return wpk.to_packed_pairs(arr, torch.float32)


def from_pallas_layout(arr: torch.Tensor,
                       dtype=torch.complex64) -> torch.Tensor:
    return wpk.from_packed_pairs(arr, dtype)


def to_fold(pp: torch.Tensor) -> torch.Tensor:
    """Pair layout (..., 2, T, Z, YX) -> folded (..., T, 2Z, YX): the re/im
    axis interleaved into z, row 2k = re of z = k, row 2k+1 = im.  Spinors
    (4,3,2,T,Z,YX), links (4,R,3,2,T,Z,YX) and staggered fields alike
    (axis -4 is the pair axis in each).  A contiguous copy."""
    *lead, two, T, Z, YX = pp.shape
    if two != 2:
        raise ValueError(f"axis -4 must be the re/im pair axis, got {two}")
    return pp.movedim(-4, -2).reshape(*lead, T, 2 * Z, YX)


def from_fold(fp: torch.Tensor) -> torch.Tensor:
    """Inverse of ``to_fold``: (..., T, 2Z, YX) -> (..., 2, T, Z, YX), a
    view (``.contiguous()`` before a kernel reads it)."""
    *lead, T, Z2, YX = fp.shape
    if Z2 % 2:
        raise ValueError(f"folded z extent {Z2} is odd")
    return fp.reshape(*lead, T, Z2 // 2, 2, YX).movedim(-2, -4)


def backward_gauge(gauge_pl: torch.Tensor, X: int) -> torch.Tensor:
    """Links shifted one site backward in their own direction on the full
    lattice: out[mu](x) = U_mu(x - mu), on the pair layout
    (4,R,3,2,T,Z,YX).  Computed once per gauge load."""
    Y = gauge_pl.shape[-1] // X
    return torch.stack([wpk.shift_packed(gauge_pl[mu], mu, -1, X, Y)
                        for mu in range(4)])


def to_recon12(gauge_pl: torch.Tensor) -> torch.Tensor:
    """Packed links -> reconstruct-12 storage: keep rows 0-1 only.
    (4, 3, 3, 2, T, Z, YX) -> (4, 2, 3, 2, T, Z, YX); 192 B/site f32
    instead of 288.  Valid for SU(3) links, boundary phase folded in
    included: the hop re-applies the sign to the rebuilt row."""
    return gauge_pl[:, :2].contiguous()


def backward_gauge_eo(u_there_pl: torch.Tensor, dims,
                      target_parity: int) -> torch.Tensor:
    """Pre-shifted backward links on the half lattice:
    out[mu](x) = U_mu(x - mu) for parity-``target_parity`` sites x, from
    the opposite-parity links ``u_there_pl`` (4,R,3,2,T,Z,Y*Xh).
    Computed once per gauge load."""
    return torch.stack([
        wpk.shift_eo_packed(u_there_pl[mu], dims, mu, -1, target_parity)
        for mu in range(4)])


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def recon12_rows(u_pl: torch.Tensor, row2_sign=None) -> torch.Tensor:
    """R = 2 links (..., 2, 3, 2, *site) -> full (..., 3, 3, 2, *site) in
    f32, row 2 = conj(row0 x row1) * ``row2_sign`` (the arithmetic of the
    JAX package's ``_recon12_wrap``)."""
    u = u_pl.to(torch.float32)
    r0r, r0i = u[..., 0, :, 0, :, :, :], u[..., 0, :, 1, :, :, :]
    r1r, r1i = u[..., 1, :, 0, :, :, :], u[..., 1, :, 1, :, :, :]
    cols = []
    for b in range(3):
        b1, b2 = (b + 1) % 3, (b + 2) % 3
        pr, pi = _cmul(r0r[..., b1, :, :, :], r0i[..., b1, :, :, :],
                       r1r[..., b2, :, :, :], r1i[..., b2, :, :, :])
        qr, qi = _cmul(r0r[..., b2, :, :, :], r0i[..., b2, :, :, :],
                       r1r[..., b1, :, :, :], r1i[..., b1, :, :, :])
        re, im = pr - qr, -(pi - qi)
        if row2_sign is not None:
            re, im = re * row2_sign, im * row2_sign
        cols.append(torch.stack([re, im], dim=-4))
    row2 = torch.stack(cols, dim=-5)
    return torch.cat([u, row2.unsqueeze(-6)], dim=-6)


def _t_boundary_sign(T: int, t_plane: int, device) -> torch.Tensor:
    """(T, 1, 1) f32: -1 on plane ``t_plane``, +1 elsewhere."""
    s = torch.ones((T, 1, 1), dtype=torch.float32, device=device)
    s[t_plane] = -1.0
    return s


def _full_links(u_here_pl, u_bw_pl, dims, tb_sign: bool):
    """R = 2 links rebuilt to full f32 links (row 2 of the t links negated
    on t = T-1 forward and t = 0 backward when ``tb_sign``); R = 3 links
    as they are."""
    if u_here_pl.shape[1] != 2:
        return u_here_pl, u_bw_pl
    T = dims[0]
    dev = u_here_pl.device
    sf = _t_boundary_sign(T, T - 1, dev) if tb_sign else None
    sb = _t_boundary_sign(T, 0, dev) if tb_sign else None
    return (torch.cat([recon12_rows(u_here_pl[:3]),
                       recon12_rows(u_here_pl[3:], sf)]),
            torch.cat([recon12_rows(u_bw_pl[:3]),
                       recon12_rows(u_bw_pl[3:], sb)]))


def dslash_eo_packed_plain(u_here_pl, u_bw_pl, psi_pl, dims,
                           target_parity: int, out_dtype=None,
                           tb_sign: bool = True):
    """Plain PyTorch version of the kernel, on the kernel's inputs.  R = 2
    links are rebuilt to full f32 links first, then the full-link stencil
    runs."""
    u_here_pl, u_bw_pl = _full_links(u_here_pl, u_bw_pl, dims, tb_sign)
    return wpk.dslash_eo_packed_pairs_bw(u_here_pl, u_bw_pl, psi_pl, dims,
                                         target_parity, out_dtype)


def dslash_packed_plain(gauge_pl, gauge_bw, psi_pl, X: int,
                        tb_sign: bool = True):
    """Plain PyTorch version of B4 on its inputs: R = 2 links rebuilt to
    full links first (row 2 of the t links negated on t = T-1 forward and
    t = 0 backward when ``tb_sign``), then the full-lattice stencil with
    the pre-shifted backward links, sums in float32 (float64 for float64
    input), out in psi's dtype."""
    dims = (psi_pl.shape[-3], psi_pl.shape[-2], psi_pl.shape[-1] // X, X)
    u, u_bw = _full_links(gauge_pl, gauge_bw, dims, tb_sign)
    return wpk.dslash_packed_pairs_bw(u, u_bw, psi_pl, X, dims[2])


def dslash_eo_packed_mrhs_plain(u_here_pl, u_bw_pl, psi_pl, dims,
                                target_parity: int, out_dtype=None,
                                tb_sign: bool = True):
    """Plain version of the multi-RHS kernel: the single-RHS plain stencil
    broadcast over the leading RHS axis of psi (N,4,3,2,T,Z,Y*Xh), which
    moves beside the site axes while the links gain a size-1 axis there."""
    u_here_pl, u_bw_pl = _full_links(u_here_pl, u_bw_pl, dims, tb_sign)
    out = wpk.dslash_eo_packed_pairs_bw(
        u_here_pl.unsqueeze(-4), u_bw_pl.unsqueeze(-4), psi_pl.movedim(0, 3),
        dims, target_parity, out_dtype)
    return out.movedim(3, 0).contiguous()


def dslash_packed_mrhs_plain(gauge_pl, gauge_bw, psi_pl, X: int,
                             tb_sign: bool = True):
    """Plain version of B5: B4's plain version broadcast over the leading
    RHS axis of psi (N,4,3,2,T,Z,Y*X), which moves beside the site axes
    while the links gain a size-1 axis there."""
    dims = (psi_pl.shape[-3], psi_pl.shape[-2], psi_pl.shape[-1] // X, X)
    u, u_bw = _full_links(gauge_pl, gauge_bw, dims, tb_sign)
    out = wpk.dslash_packed_pairs_bw(u.unsqueeze(-4), u_bw.unsqueeze(-4),
                                     psi_pl.movedim(0, 3), X, dims[2])
    return out.movedim(3, 0).contiguous()


def dslash_eo_pallas_packed(u_here_pl: torch.Tensor, u_bw_pl: torch.Tensor,
                            psi_pl: torch.Tensor, dims, target_parity: int,
                            out_dtype=None,
                            tb_sign: bool = True) -> torch.Tensor:
    """Checkerboarded Wilson hop D_{p <- 1-p} on pair arrays: the solver
    hot loop's stencil.  Returns the hop sum indexed by
    parity-``target_parity`` sites, same layout as ``psi_pl``, in
    ``out_dtype`` (default: psi's dtype)."""
    T, Z, Y, X = dims
    Xh = X // 2
    rows = link_rows(u_here_pl)
    if target_parity not in (0, 1):
        raise ValueError(f"target_parity must be 0 or 1, got {target_parity}")
    kind = kernels.dispatch_device(u_here_pl, u_bw_pl, psi_pl)
    if kind == "cpu":
        return dslash_eo_packed_plain(u_here_pl, u_bw_pl, psi_pl, dims,
                                      target_parity, out_dtype, tb_sign)
    store = psi_pl.dtype
    out_dtype = out_dtype or store
    _checked_forms(store, out_dtype, rows)
    sites = (T, Z, Y * Xh)
    kernels.require(psi_pl, "psi_pl", (4, 3, 2) + sites, store)
    kernels.require(u_here_pl, "u_here_pl", (4, rows, 3, 2) + sites, store)
    kernels.require(u_bw_pl, "u_bw_pl", (4, rows, 3, 2) + sites, store)
    lib = kernels.library()
    out = torch.empty(psi_pl.shape, dtype=out_dtype, device=psi_pl.device)
    rc = lib.qtt_wilson_eo(
        out.data_ptr(), psi_pl.data_ptr(), u_here_pl.data_ptr(),
        u_bw_pl.data_ptr(), T, Z, Y, Xh, int(target_parity),
        _STORE_CODE[store], _STORE_CODE[out_dtype], rows,
        int(bool(tb_sign)), kernels.stream_of(psi_pl))
    kernels.check_launch(rc, "qtt_wilson_eo")
    _count(dslash_eo_pallas_packed, form_name(rows, store, out_dtype))
    return out


def dslash_pallas_packed(gauge_pl: torch.Tensor, psi_pl: torch.Tensor,
                         X: int, gauge_bw: torch.Tensor | None = None,
                         tb_sign: bool = True) -> torch.Tensor:
    """Full-lattice Wilson hop sum D psi (B4) on pair arrays.

    gauge_pl: (4,R,3,2,T,Z,YX), boundary phase folded in, R = 3 or 2
    (``to_recon12``; ``tb_sign`` re-applies the folded antiperiodic t
    phase to the rebuilt row); psi_pl: (4,3,2,T,Z,YX).  ``gauge_bw`` is
    ``backward_gauge(gauge_pl, X)``: pass it when the gauge is applied
    many times (it is built here otherwise).  float32 (R = 3 or 2) or
    float64 (R = 3); the output has psi's dtype and layout."""
    rows = link_rows(gauge_pl)
    if gauge_bw is None:
        gauge_bw = backward_gauge(gauge_pl, X)
    kind = kernels.dispatch_device(gauge_pl, gauge_bw, psi_pl)
    if kind == "cpu":
        return dslash_packed_plain(gauge_pl, gauge_bw, psi_pl, X, tb_sign)
    store = psi_pl.dtype
    if store not in (torch.float32, torch.float64):
        raise TypeError(f"psi {store}: B4 takes float32 or float64")
    _checked_forms(store, store, rows)
    T, Z, YX = psi_pl.shape[-3:]
    if YX % X:
        raise ValueError(f"fused axis {YX} is not a multiple of X = {X}")
    sites = (T, Z, YX)
    kernels.require(psi_pl, "psi_pl", (4, 3, 2) + sites, store)
    kernels.require(gauge_pl, "gauge_pl", (4, rows, 3, 2) + sites, store)
    kernels.require(gauge_bw, "gauge_bw", (4, rows, 3, 2) + sites, store)
    lib = kernels.library()
    out = torch.empty(psi_pl.shape, dtype=store, device=psi_pl.device)
    rc = lib.qtt_wilson_full(
        out.data_ptr(), psi_pl.data_ptr(), gauge_pl.data_ptr(),
        gauge_bw.data_ptr(), T, Z, YX // X, X, rows,
        int(store == torch.float64), int(bool(tb_sign)),
        kernels.stream_of(psi_pl))
    kernels.check_launch(rc, "qtt_wilson_full")
    _count(dslash_pallas_packed, form_name(rows, store, store))
    return out


def dslash_eo_pallas_packed_mrhs(u_here_pl: torch.Tensor,
                                 u_bw_pl: torch.Tensor, psi_pl: torch.Tensor,
                                 dims, target_parity: int, out_dtype=None,
                                 tb_sign: bool = True,
                                 chunk=None) -> torch.Tensor:
    """Multi-RHS checkerboarded Wilson hop D_{p <- 1-p} (B5-eo): the
    batched solvers' stencil.  psi_pl (N,4,3,2,T,Z,Y*Xh) of parity 1-p;
    links as for ``dslash_eo_pallas_packed``, each read from device memory
    once for all N; a thread works through its right-hand sides ``chunk``
    at a time (default ``EO_MRHS_CHUNK``).  float32 in and out."""
    T, Z, Y, X = dims
    Xh = X // 2
    rows = link_rows(u_here_pl)
    if target_parity not in (0, 1):
        raise ValueError(f"target_parity must be 0 or 1, got {target_parity}")
    check_batch(psi_pl)
    nrhs = psi_pl.shape[0]
    nb = eo_mrhs_chunk(chunk, nrhs, rows, T, Z, Y, Xh)
    kind = kernels.dispatch_device(u_here_pl, u_bw_pl, psi_pl)
    if kind == "cpu":
        return dslash_eo_packed_mrhs_plain(u_here_pl, u_bw_pl, psi_pl, dims,
                                           target_parity, out_dtype, tb_sign)
    f32 = torch.float32
    out_dtype = out_dtype or psi_pl.dtype
    if psi_pl.dtype != f32 or out_dtype != f32:
        raise TypeError(f"psi {psi_pl.dtype} -> out {out_dtype}: the "
                        "multi-RHS hop has float32 forms only; its bf16 "
                        "forms wait for ROADMAP B5")
    sites = (T, Z, Y * Xh)
    kernels.require(psi_pl, "psi_pl", (nrhs, 4, 3, 2) + sites, f32)
    kernels.require(u_here_pl, "u_here_pl", (4, rows, 3, 2) + sites, f32)
    kernels.require(u_bw_pl, "u_bw_pl", (4, rows, 3, 2) + sites, f32)
    lib = kernels.library()
    out = torch.empty(psi_pl.shape, dtype=f32, device=psi_pl.device)
    rc = lib.qtt_wilson_eo_mrhs(
        out.data_ptr(), psi_pl.data_ptr(), u_here_pl.data_ptr(),
        u_bw_pl.data_ptr(), T, Z, Y, Xh, int(target_parity), rows,
        int(bool(tb_sign)), nrhs, nb, kernels.stream_of(psi_pl))
    kernels.check_launch(rc, "qtt_wilson_eo_mrhs")
    _count(dslash_eo_pallas_packed_mrhs, form_name(rows, f32, f32))
    return out


def dslash_pallas_packed_mrhs(gauge_pl: torch.Tensor, psi_pl: torch.Tensor,
                              X: int, gauge_bw: torch.Tensor | None = None,
                              tb_sign: bool = True,
                              chunk=None) -> torch.Tensor:
    """Multi-RHS full-lattice Wilson hop sum (B5): psi_pl
    (N,4,3,2,T,Z,Y*X), links as for ``dslash_pallas_packed``, each read
    from device memory once for all N; a thread works through its
    right-hand sides ``chunk`` at a time (default ``FULL_MRHS_CHUNK``).
    float32 in and out."""
    rows = link_rows(gauge_pl)
    check_batch(psi_pl)
    T, Z, YX = psi_pl.shape[-3:]
    if YX % X:
        raise ValueError(f"fused axis {YX} is not a multiple of X = {X}")
    nrhs = psi_pl.shape[0]
    nb = full_mrhs_chunk(chunk, nrhs, rows, T, Z, YX // X, X)
    if gauge_bw is None:
        gauge_bw = backward_gauge(gauge_pl, X)
    kind = kernels.dispatch_device(gauge_pl, gauge_bw, psi_pl)
    if kind == "cpu":
        return dslash_packed_mrhs_plain(gauge_pl, gauge_bw, psi_pl, X,
                                        tb_sign)
    f32 = torch.float32
    if psi_pl.dtype != f32:
        raise TypeError(f"psi {psi_pl.dtype}: the multi-RHS full-lattice "
                        "hop has float32 forms only; its bf16 forms wait "
                        "for ROADMAP A7")
    sites = (T, Z, YX)
    kernels.require(psi_pl, "psi_pl", (nrhs, 4, 3, 2) + sites, f32)
    kernels.require(gauge_pl, "gauge_pl", (4, rows, 3, 2) + sites, f32)
    kernels.require(gauge_bw, "gauge_bw", (4, rows, 3, 2) + sites, f32)
    lib = kernels.library()
    out = torch.empty(psi_pl.shape, dtype=f32, device=psi_pl.device)
    rc = lib.qtt_wilson_full_mrhs(
        out.data_ptr(), psi_pl.data_ptr(), gauge_pl.data_ptr(),
        gauge_bw.data_ptr(), T, Z, YX // X, X, rows, int(bool(tb_sign)),
        nrhs, nb, kernels.stream_of(psi_pl))
    kernels.check_launch(rc, "qtt_wilson_full_mrhs")
    _count(dslash_pallas_packed_mrhs, form_name(rows, f32, f32))
    return out


# -- the copy-free forms (v3, r12f) and the int8 block-float form ----------

def dslash_packed_v3_plain(gauge_pl, psi_pl, X: int, tb_sign: bool = True):
    """Plain version of the copy-free full-lattice hop (B10): the backward
    links shifted once (``backward_gauge``), then B4's plain version."""
    return dslash_packed_plain(gauge_pl, backward_gauge(gauge_pl, X), psi_pl,
                               X, tb_sign)


def dslash_pallas_packed_v3(gauge_pl: torch.Tensor, psi_pl: torch.Tensor,
                            X: int, interpret: bool = False,
                            block_z: int | None = None,
                            tb_sign: bool = True) -> torch.Tensor:
    """Full-lattice Wilson hop sum D psi, v3 (B10): no backward-gauge
    copy, the backward hop reads U_mu(x - mu) unshifted.  gauge_pl
    (4,R,3,2,T,Z,YX), boundary phase folded in, R = 3 or 2 (``tb_sign`` as
    B4's); psi_pl (4,3,2,T,Z,YX); float32.  ``interpret`` and ``block_z``
    (the TPU kernel's) are accepted and ignored."""
    rows = link_rows(gauge_pl)
    kind = kernels.dispatch_device(gauge_pl, psi_pl)
    if kind == "cpu":
        return dslash_packed_v3_plain(gauge_pl, psi_pl, X, tb_sign)
    f32 = torch.float32
    if psi_pl.dtype != f32:
        raise TypeError(f"psi {psi_pl.dtype}: the copy-free full-lattice "
                        "hop has float32 forms only (float64 is B4's)")
    T, Z, YX = psi_pl.shape[-3:]
    if YX % X:
        raise ValueError(f"fused axis {YX} is not a multiple of X = {X}")
    sites = (T, Z, YX)
    kernels.require(psi_pl, "psi_pl", (4, 3, 2) + sites, f32)
    kernels.require(gauge_pl, "gauge_pl", (4, rows, 3, 2) + sites, f32)
    lib = kernels.library()
    out = torch.empty(psi_pl.shape, dtype=f32, device=psi_pl.device)
    rc = lib.qtt_wilson_full_there(
        out.data_ptr(), psi_pl.data_ptr(), gauge_pl.data_ptr(), T, Z,
        YX // X, X, rows, int(bool(tb_sign)), kernels.stream_of(psi_pl))
    kernels.check_launch(rc, "qtt_wilson_full_there")
    _count(dslash_pallas_packed_v3, form_name(rows, f32, f32))
    return out


def dslash_eo_there_plain(u_here_pl, u_there_pl, psi_pl, dims,
                          target_parity: int, out_dtype=None,
                          tb_sign: bool = True):
    """Plain version of the copy-free hops (v3, r12f): the backward links
    shifted from ``u_there_pl`` (``backward_gauge_eo``), then B1's plain
    version."""
    u_bw = backward_gauge_eo(u_there_pl, dims, target_parity)
    return dslash_eo_packed_plain(u_here_pl, u_bw, psi_pl, dims,
                                  target_parity, out_dtype, tb_sign)


def dslash_eo_there_mrhs_plain(u_here_pl, u_there_pl, psi_pl, dims,
                               target_parity: int, out_dtype=None,
                               tb_sign: bool = True):
    """Plain version of the multi-RHS r12f hop: ``backward_gauge_eo``,
    then B5-eo's plain version."""
    u_bw = backward_gauge_eo(u_there_pl, dims, target_parity)
    return dslash_eo_packed_mrhs_plain(u_here_pl, u_bw, psi_pl, dims,
                                       target_parity, out_dtype, tb_sign)


def dslash_eo_int8_plain(q_here, s_here, q_there, s_there, psi_pl, dims,
                         target_parity: int, out_dtype=None):
    """Plain version of the int8 hop: the links decoded by
    ``from_int8_links`` (float32), then the copy-free hop's plain
    version; psi's storage, f32 sums."""
    from .blockfloat import from_int8_links
    return dslash_eo_there_plain(from_int8_links(q_here, s_here),
                                 from_int8_links(q_there, s_there), psi_pl,
                                 dims, target_parity, out_dtype)


def _check_parity(target_parity: int) -> None:
    if target_parity not in (0, 1):
        raise ValueError(f"target_parity must be 0 or 1, got {target_parity}")


def _eo_there(fn, u_here_pl, u_there_pl, psi_pl, dims, target_parity,
              out_dtype, tb_sign):
    """v3 and r12f: the same function, the same C entry; ``fn`` is the
    wrapper whose launches count."""
    T, Z, Y, X = dims
    rows = link_rows(u_here_pl)
    _check_parity(target_parity)
    kind = kernels.dispatch_device(u_here_pl, u_there_pl, psi_pl)
    if kind == "cpu":
        return dslash_eo_there_plain(u_here_pl, u_there_pl, psi_pl, dims,
                                     target_parity, out_dtype, tb_sign)
    store = psi_pl.dtype
    out_dtype = out_dtype or store
    if store == torch.float64 or out_dtype == torch.float64:
        raise TypeError(f"psi {store} -> out {out_dtype}: the copy-free hop "
                        "has float32 and bfloat16 forms; float64 waits for "
                        "ROADMAP A7")
    _checked_forms(store, out_dtype, rows)
    sites = (T, Z, Y * (X // 2))
    kernels.require(psi_pl, "psi_pl", (4, 3, 2) + sites, store)
    kernels.require(u_here_pl, "u_here_pl", (4, rows, 3, 2) + sites, store)
    kernels.require(u_there_pl, "u_there_pl", (4, rows, 3, 2) + sites, store)
    lib = kernels.library()
    out = torch.empty(psi_pl.shape, dtype=out_dtype, device=psi_pl.device)
    rc = lib.qtt_wilson_eo_there(
        out.data_ptr(), psi_pl.data_ptr(), u_here_pl.data_ptr(),
        u_there_pl.data_ptr(), T, Z, Y, X // 2, int(target_parity),
        _STORE_CODE[store], _STORE_CODE[out_dtype], rows,
        int(bool(tb_sign)), kernels.stream_of(psi_pl))
    kernels.check_launch(rc, "qtt_wilson_eo_there")
    _count(fn, form_name(rows, store, out_dtype))
    return out


def dslash_eo_pallas_packed_v3(u_here_pl: torch.Tensor,
                               u_there_pl: torch.Tensor,
                               psi_pl: torch.Tensor, dims,
                               target_parity: int, out_dtype=None,
                               tb_sign: bool = True) -> torch.Tensor:
    """Checkerboarded Wilson hop D_{p <- 1-p}, v3 (B10-eo): the backward
    links read unshifted from the opposite parity.  u_here_pl
    (4,R,3,2,T,Z,Y*Xh) at parity-p sites, u_there_pl the same at parity
    1-p, psi_pl (4,3,2,T,Z,Y*Xh) of parity 1-p; R = 3 or 2 (``tb_sign``
    as B1's); float32 or bfloat16 storage, out as B1's."""
    return _eo_there(dslash_eo_pallas_packed_v3, u_here_pl, u_there_pl,
                     psi_pl, dims, target_parity, out_dtype, tb_sign)


def dslash_eo_pallas_packed_r12f(u_here_pl: torch.Tensor,
                                 u_there_pl: torch.Tensor,
                                 psi_pl: torch.Tensor, dims,
                                 target_parity: int, out_dtype=None,
                                 tb_sign: bool = True) -> torch.Tensor:
    """Checkerboarded Wilson hop, r12f form (B9): recon-12 links with no
    resident backward copy; arguments as ``dslash_eo_pallas_packed_v3``
    (on the card the same kernel)."""
    return _eo_there(dslash_eo_pallas_packed_r12f, u_here_pl, u_there_pl,
                     psi_pl, dims, target_parity, out_dtype, tb_sign)


def dslash_eo_pallas_packed_r12f_mrhs(u_here_pl: torch.Tensor,
                                      u_there_pl: torch.Tensor,
                                      psi_pl: torch.Tensor, dims,
                                      target_parity: int, out_dtype=None,
                                      tb_sign: bool = True,
                                      chunk=None) -> torch.Tensor:
    """Multi-RHS r12f hop: psi_pl (N,4,3,2,T,Z,Y*Xh) of parity 1-p, links
    as for ``dslash_eo_pallas_packed_r12f``, each loaded once per chunk of
    ``chunk`` (default ``MRHS_CHUNK``) right-hand sides.  float32 in and
    out; the bf16 forms wait for ROADMAP A7."""
    T, Z, Y, X = dims
    rows = link_rows(u_here_pl)
    _check_parity(target_parity)
    check_batch(psi_pl)
    kind = kernels.dispatch_device(u_here_pl, u_there_pl, psi_pl)
    if kind == "cpu":
        return dslash_eo_there_mrhs_plain(u_here_pl, u_there_pl, psi_pl,
                                          dims, target_parity, out_dtype,
                                          tb_sign)
    f32 = torch.float32
    out_dtype = out_dtype or psi_pl.dtype
    if psi_pl.dtype != f32 or out_dtype != f32:
        raise TypeError(f"psi {psi_pl.dtype} -> out {out_dtype}: the "
                        "multi-RHS r12f hop has float32 forms only; its "
                        "bf16 forms wait for ROADMAP A7")
    sites = (T, Z, Y * (X // 2))
    nrhs = psi_pl.shape[0]
    nb = mrhs_chunk(chunk, nrhs, T * Z * Y * (X // 2))
    kernels.require(psi_pl, "psi_pl", (nrhs, 4, 3, 2) + sites, f32)
    kernels.require(u_here_pl, "u_here_pl", (4, rows, 3, 2) + sites, f32)
    kernels.require(u_there_pl, "u_there_pl", (4, rows, 3, 2) + sites, f32)
    lib = kernels.library()
    out = torch.empty(psi_pl.shape, dtype=f32, device=psi_pl.device)
    rc = lib.qtt_wilson_eo_there_mrhs(
        out.data_ptr(), psi_pl.data_ptr(), u_here_pl.data_ptr(),
        u_there_pl.data_ptr(), T, Z, Y, X // 2, int(target_parity), rows,
        int(bool(tb_sign)), nrhs, nb, kernels.stream_of(psi_pl))
    kernels.check_launch(rc, "qtt_wilson_eo_there_mrhs")
    _count(dslash_eo_pallas_packed_r12f_mrhs, form_name(rows, f32, f32))
    return out


def dslash_eo_pallas_packed_int8(q_here: torch.Tensor, s_here: torch.Tensor,
                                 q_there: torch.Tensor,
                                 s_there: torch.Tensor,
                                 psi_pl: torch.Tensor, dims,
                                 target_parity: int,
                                 out_dtype=None) -> torch.Tensor:
    """Checkerboarded Wilson hop on int8 block-float links (B9): q_here /
    q_there (4,3,3,2,T,Z,Y*Xh) int8 mantissas at the target / opposite
    parity, s_here / s_there (4,T,Z,Y*Xh) float32 scales
    (``blockfloat.to_int8_links``); psi_pl (4,3,2,T,Z,Y*Xh) of parity
    1-p, float32 or bfloat16; out float32, or bfloat16 from bf16 psi.
    Equals the copy-free hop on ``from_int8_links(q, s)``."""
    T, Z, Y, X = dims
    _check_parity(target_parity)
    kind = kernels.dispatch_device(q_here, s_here, q_there, s_there, psi_pl)
    if kind == "cpu":
        return dslash_eo_int8_plain(q_here, s_here, q_there, s_there, psi_pl,
                                    dims, target_parity, out_dtype)
    store = psi_pl.dtype
    out_dtype = out_dtype or store
    if store not in (torch.float32, torch.bfloat16) or out_dtype not in (
            torch.float32, torch.bfloat16) or (
            store == torch.float32 and out_dtype == torch.bfloat16):
        raise TypeError(f"psi {store} -> out {out_dtype}: the int8 hop's "
                        "forms are f32->f32, bf16->bf16 and bf16->f32")
    sites = (T, Z, Y * (X // 2))
    kernels.require(psi_pl, "psi_pl", (4, 3, 2) + sites, store)
    for name, q in (("q_here", q_here), ("q_there", q_there)):
        kernels.require(q, name, (4, 3, 3, 2) + sites, torch.int8)
    for name, sc in (("s_here", s_here), ("s_there", s_there)):
        kernels.require(sc, name, (4,) + sites, torch.float32)
    lib = kernels.library()
    out = torch.empty(psi_pl.shape, dtype=out_dtype, device=psi_pl.device)
    rc = lib.qtt_wilson_eo_int8(
        out.data_ptr(), psi_pl.data_ptr(), q_here.data_ptr(),
        s_here.data_ptr(), q_there.data_ptr(), s_there.data_ptr(), T, Z, Y,
        X // 2, int(target_parity), _STORE_CODE[store],
        _STORE_CODE[out_dtype], kernels.stream_of(psi_pl))
    kernels.check_launch(rc, "qtt_wilson_eo_int8")
    _count(dslash_eo_pallas_packed_int8, int8_form_name(store, out_dtype))
    return out


# -- the fold layout (B9 fold, fold-mrhs) -------------------------------------

def dslash_eo_fold_plain(u_here_f, u_bw_f, psi_f, dims, target_parity: int,
                         out_dtype=None, tb_sign: bool = True):
    """Plain version of the fold hop: B1's plain version on the unfolded
    operands (``from_fold``), the result folded again."""
    return to_fold(dslash_eo_packed_plain(
        from_fold(u_here_f), from_fold(u_bw_f), from_fold(psi_f), dims,
        target_parity, out_dtype, tb_sign))


def dslash_eo_fold_mrhs_plain(u_here_f, u_bw_f, psi_f, dims,
                              target_parity: int, out_dtype=None,
                              tb_sign: bool = True):
    """Plain version of the multi-RHS fold hop: B5-eo's plain version on
    the unfolded operands, the result folded again."""
    return to_fold(dslash_eo_packed_mrhs_plain(
        from_fold(u_here_f), from_fold(u_bw_f), from_fold(psi_f), dims,
        target_parity, out_dtype, tb_sign))


def _fold_rows(u_f) -> int:
    """R of folded links (4, R, 3, T, 2Z, Y*Xh): 3 or 2."""
    rows = u_f.shape[1] if u_f.ndim == 6 else 0
    if rows not in (2, 3):
        raise ValueError(f"folded links of shape {tuple(u_f.shape)}: "
                         "expected (4, R, 3, T, 2Z, Y*Xh) with R = 3 or 2")
    return rows


def dslash_eo_pallas_packed_fold(u_here_f: torch.Tensor,
                                 u_bw_f: torch.Tensor, psi_f: torch.Tensor,
                                 dims, target_parity: int, out_dtype=None,
                                 tb_sign: bool = True) -> torch.Tensor:
    """Checkerboarded Wilson hop D_{p <- 1-p} on folded arrays (B9 fold):
    u_here_f / u_bw_f (4,R,3,T,2Z,Y*Xh) forward and pre-shifted backward
    links (``to_fold`` of B1's), psi_f (4,3,T,2Z,Y*Xh) of parity 1-p.
    Returns the folded hop in ``out_dtype`` (default psi's): B1's forms,
    and B1's output on the unfolded operands bit for bit."""
    T, Z, Y, X = dims
    rows = _fold_rows(u_here_f)
    _check_parity(target_parity)
    kind = kernels.dispatch_device(u_here_f, u_bw_f, psi_f)
    if kind == "cpu":
        return dslash_eo_fold_plain(u_here_f, u_bw_f, psi_f, dims,
                                    target_parity, out_dtype, tb_sign)
    store = psi_f.dtype
    out_dtype = out_dtype or store
    if store == torch.float64 or out_dtype == torch.float64:
        raise TypeError(f"psi {store} -> out {out_dtype}: the fold hop has "
                        "float32 and bfloat16 forms; float64 waits for "
                        "ROADMAP A7")
    _checked_forms(store, out_dtype, rows)
    fsites = (T, 2 * Z, Y * (X // 2))
    kernels.require(psi_f, "psi_f", (4, 3) + fsites, store)
    kernels.require(u_here_f, "u_here_f", (4, rows, 3) + fsites, store)
    kernels.require(u_bw_f, "u_bw_f", (4, rows, 3) + fsites, store)
    lib = kernels.library()
    out = torch.empty(psi_f.shape, dtype=out_dtype, device=psi_f.device)
    rc = lib.qtt_wilson_eo_fold(
        out.data_ptr(), psi_f.data_ptr(), u_here_f.data_ptr(),
        u_bw_f.data_ptr(), T, Z, Y, X // 2, int(target_parity),
        _STORE_CODE[store], _STORE_CODE[out_dtype], rows,
        int(bool(tb_sign)), kernels.stream_of(psi_f))
    kernels.check_launch(rc, "qtt_wilson_eo_fold")
    _count(dslash_eo_pallas_packed_fold, form_name(rows, store, out_dtype))
    return out


def dslash_eo_pallas_packed_fold_mrhs(u_here_f: torch.Tensor,
                                      u_bw_f: torch.Tensor,
                                      psi_f: torch.Tensor, dims,
                                      target_parity: int, out_dtype=None,
                                      tb_sign: bool = True,
                                      chunk=None) -> torch.Tensor:
    """Multi-RHS fold hop (B9 fold-mrhs): psi_f (N,4,3,T,2Z,Y*Xh) of
    parity 1-p, links as for ``dslash_eo_pallas_packed_fold``, each read
    from device memory once for all N; a thread works through its
    right-hand sides one at a time (``chunk``: None or FOLD_MRHS_CHUNK).
    float32 in and out; the bf16 forms wait for ROADMAP A7."""
    T, Z, Y, X = dims
    Xh = X // 2
    rows = _fold_rows(u_here_f)
    _check_parity(target_parity)
    if psi_f.ndim != 6:
        raise ValueError(f"psi of shape {tuple(psi_f.shape)}: expected "
                         "(N, 4, 3, T, 2Z, Y*Xh)")
    nrhs = psi_f.shape[0]
    fold_mrhs_chunk(chunk, nrhs, rows, T, Z, Y, Xh)
    kind = kernels.dispatch_device(u_here_f, u_bw_f, psi_f)
    if kind == "cpu":
        return dslash_eo_fold_mrhs_plain(u_here_f, u_bw_f, psi_f, dims,
                                         target_parity, out_dtype, tb_sign)
    f32 = torch.float32
    out_dtype = out_dtype or psi_f.dtype
    if psi_f.dtype != f32 or out_dtype != f32:
        raise TypeError(f"psi {psi_f.dtype} -> out {out_dtype}: the "
                        "multi-RHS fold hop has float32 forms only; its "
                        "bf16 forms wait for ROADMAP A7")
    fsites = (T, 2 * Z, Y * Xh)
    kernels.require(psi_f, "psi_f", (nrhs, 4, 3) + fsites, f32)
    kernels.require(u_here_f, "u_here_f", (4, rows, 3) + fsites, f32)
    kernels.require(u_bw_f, "u_bw_f", (4, rows, 3) + fsites, f32)
    lib = kernels.library()
    out = torch.empty(psi_f.shape, dtype=f32, device=psi_f.device)
    rc = lib.qtt_wilson_eo_fold_mrhs(
        out.data_ptr(), psi_f.data_ptr(), u_here_f.data_ptr(),
        u_bw_f.data_ptr(), T, Z, Y, Xh, int(target_parity), rows,
        int(bool(tb_sign)), nrhs, kernels.stream_of(psi_f))
    kernels.check_launch(rc, "qtt_wilson_eo_fold_mrhs")
    _count(dslash_eo_pallas_packed_fold_mrhs, form_name(rows, f32, f32))
    return out


def reset_launches() -> None:
    """Zero the launch counts of the eo hop (B1), its multi-RHS form
    (B5-eo), the full-lattice hop (B4), its multi-RHS form (B5) and its
    copy-free form (B10), and of the copy-free (v3, r12f, r12f-mrhs), int8
    and fold (fold, fold-mrhs) eo hops."""
    for fn in (dslash_eo_pallas_packed, dslash_eo_pallas_packed_mrhs,
               dslash_pallas_packed, dslash_pallas_packed_mrhs,
               dslash_pallas_packed_v3,
               dslash_eo_pallas_packed_v3, dslash_eo_pallas_packed_r12f,
               dslash_eo_pallas_packed_r12f_mrhs,
               dslash_eo_pallas_packed_int8, dslash_eo_pallas_packed_fold,
               dslash_eo_pallas_packed_fold_mrhs):
        fn.launches = 0
        fn.launches_by_form = {}


reset_launches()
