"""The multigrid coarse stencil in one launch (B8) and its plain version.

Replaces quda_tpu/ops/coarse_pallas.py::coarse_apply_pallas (the Pallas
TPU kernel) with the hand-written CUDA kernel ``csrc/coarse.cu``.  The
coarse operator lives on the interleaved real embedding (mg/pair.py: a
complex entry g becomes [[re, -im], [im, re]], so a complex Nc x Nc
matvec is one real E x E matvec with E = 2 Nc):

    links  (9, S, E, E) float32   [diag, then the 8 hop directions]
    psi9   (9, S, E)    float32   the input and its 8 pre-rolled
                                  neighbour copies, in the same order
    out    (S, E)                 out[s] = sum_k links[k, s] @ psi9[k, s]

The wrapper dispatches on the tensors' device: CPU tensors run the plain
version ``coarse_apply_ref`` (the einsum "ksab,ksb->sa", the JAX
package's reference), CUDA tensors launch the kernel or raise.  Its
launches are counted in ``coarse_apply_pallas.launches``, and by (S, E)
in ``coarse_apply_pallas.launches_by_shape`` ("8192x96": one count a
coarse level).  A block of the kernel streams its (site, tile of link
rows) item's 9 link blocks through a ring of shared-memory stages
(``coarse_plan``); its sums run in a blocked order (per-block chains, a
lane tree), within ``TOLERANCE`` of the einsum.

``coarse_apply_pallas_mrhs`` (B8-mrhs) applies the same links to N
right-hand sides, psi9 (N, 9, S, E) -> (N, S, E): the coarse levels'
null-vector block solves, where the JAX package vmaps its kernel (every
lane re-reading the links).  Per site it is a GEMM, Out_s = P_s . L_s^T,
register-tiled on the CUDA cores with the links streamed through shared
memory, so each link is read once for up to ``mrhs_plan(E, N)["nc"]``
right-hand sides (all of them at the multigrid's widths).  Its sums run in
another order than the single form's, so its lanes agree with single
launches within ``TOLERANCE``, not bit for bit.  Plain version:
``coarse_apply_mrhs_ref``.
"""

from __future__ import annotations

import torch

from ..utils import kernels

# Kernel vs plain version, max |kernel - plain| / max |plain|: the same
# 9 E products per output, summed in another order (strided lane partial
# sums and a shuffle tree, or the multi-RHS form's FMA chains of 32
# products added tile by tile, against the einsum's order).
TOLERANCE = 1e-5
MAX_E = 1024                # coarse_plan's ring fits 227 KB up to E = 1024

# The single form's plan, as csrc/coarse.cu's coarse_plan makes it: a block
# of COARSE_THREADS threads an item (a site's tile of ``rows`` link rows), a
# ring of COARSE_STAGES stages, each one link block's tile rows and the
# site's psi9 numbers; a row belongs to ``lanes`` lanes (COARSE_LANES_MID at
# 8 .. 63 copies a row, 4 below, 32 above), each lane group holding
# COARSE_ROWS_PER_GROUP rows of a tile.
COARSE_THREADS = 256
COARSE_STAGES = 3
COARSE_ROWS_PER_GROUP = 1
COARSE_LANES_MID = 8
COARSE_MIN_BLOCKS = 4       # the kernel's launch bound

MAX_E_MRHS = 160            # the multi-RHS kernel's widest link block

# The multi-RHS kernel's plan, as csrc/coarse.cu's mrhs_plan makes it: a
# thread holds MRHS_TA output rows x MRHS_TN right-hand sides; a block at
# most MRHS_MAX_THREADS threads and MRHS_STAGES stages of MRHS_BK columns
# (rows padded to MRHS_BK + 4 floats) within MRHS_SMEM_BUDGET bytes, two
# blocks an SM.
MRHS_TA, MRHS_TN = 4, 6
MRHS_BK = 32
MRHS_STAGES = 4
MRHS_MAX_THREADS = 256
MRHS_SMEM_BUDGET = 115712
_MAX_BLOCKS = 2 ** 31 - 1

_SPEC = "ksab,ksb->sa"


def coarse_apply_ref(links: torch.Tensor, psi9: torch.Tensor) -> torch.Tensor:
    """The plain version: einsum "ksab,ksb->sa", float32."""
    return torch.einsum(_SPEC, links, psi9)


def coarse_apply_mrhs_ref(links: torch.Tensor,
                          psi9: torch.Tensor) -> torch.Tensor:
    """The plain multi-RHS version: einsum "ksab,nksb->nsa", float32."""
    return torch.einsum("ksab,nksb->nsa", links, psi9)


def coarse_plan(S: int, E: int, vec4: bool = True) -> dict:
    """The single form's launch at S sites and width E (csrc/coarse.cu::
    coarse_plan): ``lanes`` a link row, link ``rows`` a tile, ``tiles`` a
    site, floats a ``stage`` (rows x E links, then E psi9 numbers, padded
    to 4), dynamic shared memory ``smem`` a block in bytes, ``threads`` a
    block and ``items`` (S x tiles, 9 stages each: the grid, one block an
    item).  ``vec4``: the 16-byte copies (E % 4 == 0, aligned inputs)."""
    per_row = E // 4 if vec4 else E
    lanes = 32 if per_row >= 64 else COARSE_LANES_MID if per_row >= 8 else 4
    rows = min(E, COARSE_THREADS // lanes * COARSE_ROWS_PER_GROUP)
    tiles = -(-E // rows)
    stage = -(-(rows * E + E) // 4) * 4
    return {"lanes": lanes, "rows": rows, "tiles": tiles, "stage": stage,
            "smem": 4 * COARSE_STAGES * stage, "items": S * tiles,
            "threads": COARSE_THREADS}


def coarse_info(S: int, E: int, vec4: bool = True) -> dict:
    """The single form's resources on the card at (S, E): ptxas
    ``registers``, ``smem_bytes`` a block, resident ``blocks_per_sm``, and
    ``rows``, ``lanes``, ``grid`` (blocks) of the plan it launches."""
    info = kernels.kernel_info("qtt_coarse_apply_info", S, E, int(vec4))
    rows, lanes, grid = info.pop("extra")
    return {**info, "rows": rows, "lanes": lanes, "grid": grid}


def check_single(E: int, S: int) -> dict:
    """Raise ValueError naming the limit unless the single kernel takes
    width E and S sites (a grid of at most 2^31 - 1 blocks on either copy
    width: the 4-byte copies' plan has the most); its plan (16-byte
    copies) otherwise."""
    if not 1 <= E <= MAX_E or S < 1:
        raise ValueError(f"E = {E}, S = {S}: the kernel takes 1 <= E <= "
                         f"{MAX_E} and S >= 1")
    items = coarse_plan(S, E, vec4=False)["items"]
    if items > _MAX_BLOCKS:
        raise ValueError(f"S = {S}, E = {E}: {items} blocks, beyond the "
                         "grid's 2^31 - 1")
    return coarse_plan(S, E)


def mrhs_plan(E: int, N: int) -> dict:
    """The multi-RHS kernel's launch at width E and N right-hand sides
    (csrc/coarse.cu::mrhs_plan): row groups ``ag`` (ceil(E / MRHS_TA)),
    right-hand sides a chunk ``nc`` (N_max(E) when N exceeds it),
    ``chunks`` (how often each link is read), ``threads`` a block and
    dynamic shared memory ``smem`` a block in bytes."""
    ldk = MRHS_BK + 4
    ag = -(-E // MRHS_TA)
    rows_l = ag * MRHS_TA
    max_rows = MRHS_SMEM_BUDGET // (MRHS_STAGES * ldk * 4)
    ng = min(-(-N // MRHS_TN), MRHS_MAX_THREADS // ag,
             (max_rows - rows_l) // MRHS_TN)
    nc = ng * MRHS_TN
    return {"ag": ag, "nc": nc, "chunks": -(-N // nc),
            "threads": -(-(ag * ng) // 32) * 32,
            "smem": 4 * MRHS_STAGES * (rows_l + nc) * ldk}


def check_mrhs(E: int, N: int, S: int) -> dict:
    """Raise ValueError naming the limit unless the multi-RHS kernel takes
    width E, N right-hand sides and S sites; its plan otherwise."""
    if not 1 <= E <= MAX_E_MRHS:
        raise ValueError(f"E = {E}: the multi-RHS kernel takes 1 <= E <= "
                         f"MAX_E_MRHS = {MAX_E_MRHS}")
    if N < 1:
        raise ValueError(f"N = {N}: the multi-RHS kernel takes N >= 1 "
                         "right-hand sides")
    plan = mrhs_plan(E, N)
    if S * plan["chunks"] > _MAX_BLOCKS:
        raise ValueError(f"S = {S}, {plan['chunks']} chunks: the grid "
                         f"exceeds 2^31 - 1 blocks")
    return plan


def mrhs_info(E: int, N: int, vec4: bool = True) -> dict:
    """The multi-RHS kernel's resources on the card at (E, N): ptxas
    ``registers``, ``smem_bytes`` a block, resident ``blocks_per_sm``,
    and ``threads``, ``nc``, ``chunks`` of the plan it launched."""
    info = kernels.kernel_info("qtt_coarse_apply_mrhs_info", E, N,
                               int(vec4))
    threads, nc, chunks = info.pop("extra")
    return {**info, "threads": threads, "nc": nc, "chunks": chunks}


def coarse_model(nc: int) -> dict:
    """Per-coarse-site flops and bytes of the apply at Nc colours
    (E = 2 Nc): 9 real E x E matvecs; links once, the 9 psi reads and the
    output, float32."""
    e = 2 * nc
    return {"flops_per_site": 18 * e * e,
            "bytes_per_site": 36 * e * e + 40 * e}


def coarse_apply_pallas(links: torch.Tensor,
                        psi9: torch.Tensor) -> torch.Tensor:
    """Fused coarse M: links (9, S, E, E), psi9 (9, S, E) -> (S, E)."""
    if psi9.ndim != 3 or psi9.shape[0] != 9:
        raise ValueError(f"psi9 of shape {tuple(psi9.shape)}: expected "
                         "(9, S, E)")
    _, S, E = psi9.shape
    if tuple(links.shape) != (9, S, E, E):
        raise ValueError(f"links of shape {tuple(links.shape)}: expected "
                         f"{(9, S, E, E)} for psi9 {tuple(psi9.shape)}")
    check_single(E, S)
    kind = kernels.dispatch_device(links, psi9)
    if kind == "cpu":
        return coarse_apply_ref(links, psi9)
    f32 = torch.float32
    kernels.require(links, "links", (9, S, E, E), f32)
    kernels.require(psi9, "psi9", (9, S, E), f32)
    lib = kernels.library()
    out = torch.empty((S, E), dtype=f32, device=psi9.device)
    rc = lib.qtt_coarse_apply(out.data_ptr(), links.data_ptr(),
                              psi9.data_ptr(), S, E,
                              kernels.stream_of(psi9))
    kernels.check_launch(rc, "qtt_coarse_apply")
    coarse_apply_pallas.launches += 1
    shape = f"{S}x{E}"
    by_shape = coarse_apply_pallas.launches_by_shape
    by_shape[shape] = by_shape.get(shape, 0) + 1
    return out


def coarse_apply_pallas_mrhs(links: torch.Tensor,
                             psi9: torch.Tensor) -> torch.Tensor:
    """Fused coarse M on N right-hand sides: links (9, S, E, E), psi9
    (N, 9, S, E) -> (N, S, E)."""
    if psi9.ndim != 4 or psi9.shape[1] != 9:
        raise ValueError(f"psi9 of shape {tuple(psi9.shape)}: expected "
                         "(N, 9, S, E)")
    N, _, S, E = psi9.shape
    if tuple(links.shape) != (9, S, E, E):
        raise ValueError(f"links of shape {tuple(links.shape)}: expected "
                         f"{(9, S, E, E)} for psi9 {tuple(psi9.shape)}")
    check_mrhs(E, N, S)
    kind = kernels.dispatch_device(links, psi9)
    if kind == "cpu":
        return coarse_apply_mrhs_ref(links, psi9)
    f32 = torch.float32
    kernels.require(links, "links", (9, S, E, E), f32)
    kernels.require(psi9, "psi9", (N, 9, S, E), f32)
    lib = kernels.library()
    out = torch.empty((N, S, E), dtype=f32, device=psi9.device)
    rc = lib.qtt_coarse_apply_mrhs(out.data_ptr(), links.data_ptr(),
                                   psi9.data_ptr(), S, E, N,
                                   kernels.stream_of(psi9))
    kernels.check_launch(rc, "qtt_coarse_apply_mrhs")
    coarse_apply_pallas_mrhs.launches += 1
    return out


def reset_launches() -> None:
    coarse_apply_pallas.launches = 0
    coarse_apply_pallas.launches_by_shape = {}
    coarse_apply_pallas_mrhs.launches = 0


reset_launches()
