"""The launch plans of the kernels that stage operands in shared memory:
B8 and B8-mrhs (ops/coarse_pallas.py::coarse_plan, mrhs_plan), B5 and
B5-eo (ops/wilson_pallas_packed.py::full_mrhs_plan, eo_mrhs_plan),
fold-mrhs (wilson_pallas_packed.fold_mrhs_plan, and its tile copy's index
map fold_tile_sources), K1/K2-mrhs (ops/clover_pallas.py::k_mrhs_plan)
and S2-mrhs-full (ops/staggered_pallas.py::full_mrhs_plan), which mirror
the C planners in csrc/coarse.cu, csrc/wilson_full.cu,
csrc/wilson_eo_mrhs.cu, csrc/wilson_eo_fold.cu, csrc/clover_eo_mrhs.cu
and csrc/staggered_full.cu (the card tests hold each pair to each other
through the kernels' query entries); and the wrappers' refusals, which
run before any launch, on the CPU path too.  Pure Python: no card, no
JAX.
"""

import numpy as np
import pytest
import torch

from quda_tpu_torch.ops import clover_pallas as clp
from quda_tpu_torch.ops import coarse_pallas as cop
from quda_tpu_torch.ops import staggered_pallas as spl
from quda_tpu_torch.ops import wilson_pallas_packed as wpp

SMEM_PER_BLOCK = 232448     # the H100's opt-in shared memory of a block
SMEM_PER_SM = 233472        # an SM's shared memory, 1 KB of it per block
MAX_BLOCKS = 2 ** 31 - 1    # the grid's x extent


def test_coarse_mrhs_plan_fits_every_accepted_width():
    """Every (E, N) the wrapper accepts (E 1 .. MAX_E_MRHS, N >= 1) plans
    a block within 227 KB of shared memory, within the two-blocks-an-SM
    budget, of at most 256 threads holding at least one right-hand side,
    and chunks that cover N."""
    for e in range(1, cop.MAX_E_MRHS + 1):
        for n in (1, 2, 5, 6, 7, 24, 25, 36, 37, 40, 64, 100, 1000, 10 ** 5):
            p = cop.mrhs_plan(e, n)
            assert p["smem"] <= cop.MRHS_SMEM_BUDGET <= SMEM_PER_BLOCK
            assert 32 <= p["threads"] <= cop.MRHS_MAX_THREADS
            assert p["threads"] % 32 == 0
            assert p["ag"] * cop.MRHS_TA >= e
            assert p["nc"] >= 1 and p["nc"] % cop.MRHS_TN == 0
            assert p["chunks"] * p["nc"] >= n > (p["chunks"] - 1) * p["nc"]


def test_coarse_mrhs_plan_reads_links_once_at_the_multigrid_width():
    """At the smoke's level-1 shape (E 96, N 24) one chunk holds every
    right-hand side, so each link is read once; N_max(E) (nc when N is
    large) is 60 at E 96 and 36 at E 160, where N = 40 takes two
    chunks."""
    p = cop.mrhs_plan(96, 24)
    assert (p["nc"], p["chunks"], p["threads"]) == (24, 1, 96)
    assert p["smem"] == 4 * 4 * (96 + 24) * 36
    assert cop.mrhs_plan(96, 10 ** 4)["nc"] == 60
    assert cop.mrhs_plan(160, 10 ** 4)["nc"] == 36
    assert cop.mrhs_plan(160, 40)["chunks"] == 2


@pytest.mark.parametrize("rows", [3, 2])
def test_full_mrhs_plan_fits_every_accepted_lattice(rows):
    """B5's block (the tile's forward and backward links) fits 227 KB of
    shared memory, two blocks to an SM, for every lattice; its tiles
    cover each (t, z) plane."""
    for X in range(1, 80):
        for Y in (1, 2, 5, 8, 32):
            p = wpp.full_mrhs_plan(rows, 3, 5, Y, X)
            assert 2 * (p["smem"] + 1024) <= 233472
            assert p["smem"] <= SMEM_PER_BLOCK
            assert (p["tiles"] - 1) * wpp.FULL_MRHS_TILE < Y * X \
                <= p["tiles"] * wpp.FULL_MRHS_TILE
            assert p["blocks"] == 3 * 5 * p["tiles"]
            assert p["threads"] == wpp.FULL_MRHS_LANES * wpp.FULL_MRHS_TILE


def test_full_mrhs_plan_at_the_smoke_lattice():
    """32^3 x 64: 8 tiles a plane, 16384 blocks of 256 threads; the tile's
    links take 73,728 bytes (R = 3) and 49,152 (R = 2); B5's default
    chunk is 1."""
    p3 = wpp.full_mrhs_plan(3, 64, 32, 32, 32)
    p2 = wpp.full_mrhs_plan(2, 64, 32, 32, 32)
    assert (p3["tiles"], p3["blocks"], p3["threads"]) == (8, 16384, 256)
    assert (p3["smem"], p2["smem"]) == (73728, 49152)
    assert wpp.full_mrhs_chunk(None, 24, 3, 64, 32, 32, 32) == 1


def test_coarse_mrhs_refusals_name_the_limit_before_any_launch():
    """B8-mrhs refuses E outside 1 .. MAX_E_MRHS and N = 0 with a
    ValueError naming the limit, on the CPU path too; nothing is
    counted."""
    n0 = cop.coarse_apply_pallas_mrhs.launches
    e = cop.MAX_E_MRHS + 1
    with pytest.raises(ValueError, match="MAX_E_MRHS = 160"):
        cop.coarse_apply_pallas_mrhs(torch.zeros((9, 2, e, e)),
                                     torch.zeros((3, 9, 2, e)))
    with pytest.raises(ValueError, match="N >= 1"):
        cop.coarse_apply_pallas_mrhs(torch.zeros((9, 2, 8, 8)),
                                     torch.zeros((0, 9, 2, 8)))
    with pytest.raises(ValueError, match="MAX_E_MRHS"):
        cop.check_mrhs(0, 3, 2)
    assert cop.check_mrhs(cop.MAX_E_MRHS, 3, 2)["chunks"] == 1
    assert cop.coarse_apply_pallas_mrhs.launches == n0


def test_full_mrhs_refusals_name_the_limit_before_any_launch():
    """B5 refuses a chunk without an instance, N = 0 and a fused axis that
    is not a multiple of X with a ValueError naming the limit, on the CPU
    path too; nothing is counted."""
    n0 = wpp.dslash_pallas_packed_mrhs.launches
    sites = (2, 2, 3 * 4)
    u = torch.zeros((4, 3, 3, 2) + sites)
    psi = torch.zeros((2, 4, 3, 2) + sites)
    with pytest.raises(ValueError, match=r"chunk 3.*\(1, 2\)"):
        wpp.dslash_pallas_packed_mrhs(u, psi, 4, gauge_bw=u, chunk=3)
    with pytest.raises(ValueError, match="N >= 1"):
        wpp.dslash_pallas_packed_mrhs(u, psi[:0], 4, gauge_bw=u)
    with pytest.raises(ValueError, match="multiple of X = 5"):
        wpp.dslash_pallas_packed_mrhs(u, psi, 5, gauge_bw=u)
    with pytest.raises(ValueError, match="2\\^31 - 1"):
        wpp.full_mrhs_chunk(None, 1, 3, 2 ** 16, 2 ** 16, 1, 2 ** 10)
    assert wpp.full_mrhs_chunk(None, 5, 3, 2, 2, 3, 4) == \
        wpp.FULL_MRHS_CHUNK
    assert wpp.full_mrhs_chunk(2, 5, 3, 2, 2, 3, 4) == 2
    assert wpp.dslash_pallas_packed_mrhs.launches == n0


def _assert_tiles_cover(plan, T, Z, plane, tile):
    assert (plan["tiles"] - 1) * tile < plane <= plan["tiles"] * tile
    assert plan["blocks"] == T * Z * plan["tiles"]


@pytest.mark.parametrize("rows", [3, 2])
def test_eo_mrhs_plan_fits_every_accepted_lattice(rows):
    """B5-eo's block (the tile's forward and backward links) fits 227 KB of
    shared memory, EO_MRHS_MIN_BLOCKS blocks to an SM (its launch bound),
    for every half lattice; its tiles cover each (t, z) plane of Y*Xh
    half-sites."""
    for xh in range(1, 80):
        for y in (1, 2, 5, 8, 32):
            p = wpp.eo_mrhs_plan(rows, 3, 5, y, xh)
            assert p["smem"] <= SMEM_PER_BLOCK
            assert wpp.EO_MRHS_MIN_BLOCKS * (p["smem"] + 1024) <= \
                SMEM_PER_SM
            _assert_tiles_cover(p, 3, 5, y * xh, wpp.EO_MRHS_TILE)
            assert p["threads"] == wpp.EO_MRHS_LANES * wpp.EO_MRHS_TILE
            assert p["threads"] <= 1024 and p["threads"] % 32 == 0


def test_stag_full_mrhs_plan_fits_every_accepted_lattice():
    """S2-mrhs-full's block (the tile's two link sets) fits 227 KB of
    shared memory, FULL_MRHS_MIN_BLOCKS blocks to an SM (its launch
    bound), for every lattice; its tiles cover each (t, z) plane."""
    for x in range(1, 80):
        for y in (1, 2, 5, 8, 32):
            p = spl.full_mrhs_plan(3, 5, y, x)
            assert p["smem"] <= SMEM_PER_BLOCK
            assert spl.FULL_MRHS_MIN_BLOCKS * (p["smem"] + 1024) <= \
                SMEM_PER_SM
            _assert_tiles_cover(p, 3, 5, y * x, spl.FULL_MRHS_TILE)
            assert p["threads"] == spl.FULL_MRHS_LANES * spl.FULL_MRHS_TILE
            assert p["threads"] <= 1024 and p["threads"] % 32 == 0


def test_eo_mrhs_plan_at_the_smoke_lattice():
    """32^3 x 64 (planes of 512 half-sites): 4 tiles a plane, 8192 blocks
    of 256 threads; the tile's links take 73,728 bytes (R = 3) and 49,152
    (R = 2); the default chunk takes N = 12 (the 12-source and Möbius
    batches) and the 5d PC's N = 6 (Ls / 2), each lane 6 and 3 right-hand
    sides."""
    p3 = wpp.eo_mrhs_plan(3, 64, 32, 32, 16)
    p2 = wpp.eo_mrhs_plan(2, 64, 32, 32, 16)
    assert (p3["tiles"], p3["blocks"], p3["threads"]) == (4, 8192, 256)
    assert (p2["tiles"], p2["blocks"], p2["threads"]) == (4, 8192, 256)
    assert (p3["smem"], p2["smem"]) == (73728, 49152)
    for n, per_lane in ((12, 6), (6, 3)):
        nb = wpp.eo_mrhs_chunk(None, n, 3, 64, 32, 32, 16)
        assert nb == wpp.EO_MRHS_CHUNK == 1
        assert -(-n // wpp.EO_MRHS_LANES) == per_lane


def test_stag_full_mrhs_plan_at_the_smoke_lattice():
    """32^3 x 64 (planes of 1024 sites): 16 tiles a plane, 32768 blocks of
    256 threads, 36,864 bytes of links a block; at the multigrid's N = 24
    each of a site's 4 lanes takes 6 right-hand sides, one at a time."""
    p = spl.check_full_mrhs(24, 64, 32, 32, 32)
    assert p == spl.full_mrhs_plan(64, 32, 32, 32)
    assert (p["tiles"], p["blocks"], p["threads"], p["smem"]) == (
        16, 32768, 256, 36864)
    assert spl.FULL_MRHS_CHUNK == 1
    assert -(-24 // (spl.FULL_MRHS_LANES * spl.FULL_MRHS_CHUNK)) == 6


def test_eo_mrhs_refusals_name_the_limit_before_any_launch():
    """B5-eo refuses a chunk without an instance, N = 0 and a grid beyond
    2^31 - 1 blocks with a ValueError naming the limit, on the CPU path
    too; every MRHS_CHUNKS width is taken; nothing is counted."""
    n0 = wpp.dslash_eo_pallas_packed_mrhs.launches
    dims = (2, 2, 3, 4)
    sites = (2, 2, 3 * 2)
    u = torch.zeros((4, 3, 3, 2) + sites)
    psi = torch.zeros((2, 4, 3, 2) + sites)
    with pytest.raises(ValueError, match=r"chunk 3.*\(1, 2\)"):
        wpp.dslash_eo_pallas_packed_mrhs(u, u, psi, dims, 0, chunk=3)
    with pytest.raises(ValueError, match="N >= 1"):
        wpp.dslash_eo_pallas_packed_mrhs(u, u, psi[:0], dims, 1)
    with pytest.raises(ValueError, match="2\\^31 - 1"):
        wpp.eo_mrhs_chunk(None, 1, 3, 2 ** 16, 2 ** 16, 1, 2 ** 10)
    one_tile = wpp.EO_MRHS_TILE            # a plane of one tile
    assert wpp.eo_mrhs_plan(3, 2 ** 16, 2 ** 15 - 1, 1,
                            one_tile)["blocks"] <= MAX_BLOCKS
    assert wpp.eo_mrhs_chunk(None, 1, 3, 2 ** 16, 2 ** 15 - 1, 1,
                             one_tile) == wpp.EO_MRHS_CHUNK
    for nb in wpp.MRHS_CHUNKS:
        assert wpp.eo_mrhs_chunk(nb, 5, 2, 2, 2, 3, 2) == nb
        out = wpp.dslash_eo_pallas_packed_mrhs(u, u, psi, dims, 0, chunk=nb)
        assert out.shape == psi.shape
    assert wpp.dslash_eo_pallas_packed_mrhs.launches == n0


def test_stag_full_mrhs_refusals_name_the_limit_before_any_launch():
    """S2-mrhs-full refuses N = 0, a grid beyond 2^31 - 1 blocks and a
    fused axis that is not a multiple of X with a ValueError naming the
    limit, on the CPU path too; nothing is counted."""
    n0 = spl.dslash_staggered_pass_mrhs.launches
    sites = (2, 2, 3 * 4)
    u = torch.zeros((4, 3, 3, 2) + sites)
    psi = torch.zeros((2, 3, 2) + sites)
    with pytest.raises(ValueError, match="N >= 1"):
        spl.dslash_staggered_pass_mrhs(u, u, psi[:0], 4, 1)
    with pytest.raises(ValueError, match="multiple of X = 5"):
        spl.dslash_staggered_pass_mrhs(u, u, psi, 5, 3)
    with pytest.raises(ValueError, match="2\\^31 - 1"):
        spl.check_full_mrhs(1, 2 ** 16, 2 ** 16, 1, 2 ** 10)
    one_tile = spl.FULL_MRHS_TILE          # a plane of one tile
    assert spl.check_full_mrhs(1, 2 ** 16, 2 ** 15 - 1, 1,
                               one_tile)["blocks"] <= MAX_BLOCKS
    assert spl.dslash_staggered_pass_mrhs(u, u, psi, 4, 1).shape == psi.shape
    assert spl.dslash_staggered_pass_mrhs.launches == n0


@pytest.mark.parametrize("with_blk", [True, False],
                         ids=["blocks", "block-free"])
@pytest.mark.parametrize("rows", [3, 2])
def test_k_mrhs_plan_fits_every_accepted_lattice(rows, with_blk):
    """K1/K2-mrhs's block (the tile's links and, with blocks, its clover
    blocks) fits 227 KB of shared memory, K_MRHS_MIN_BLOCKS blocks to an
    SM (its launch bound), for every half lattice; its tiles cover each
    (t, z) plane of Y*Xh half-sites."""
    tile = clp.K_MRHS_TILE[with_blk]
    for xh in range(1, 80):
        for y in (1, 2, 5, 8, 32):
            p = clp.k_mrhs_plan(rows, with_blk, 3, 5, y, xh)
            assert p["smem"] <= clp.SMEM_PER_BLOCK == SMEM_PER_BLOCK
            assert clp.K_MRHS_MIN_BLOCKS * (p["smem"] + 1024) <= SMEM_PER_SM
            _assert_tiles_cover(p, 3, 5, y * xh, tile)
            assert p["threads"] == clp.K_MRHS_LANES[with_blk] * tile
            assert p["threads"] <= 1024 and p["threads"] % 32 == 0


def test_k_mrhs_plan_at_the_smoke_lattice():
    """32^3 x 64 (planes of 512 half-sites), the smoke's N = 12: the forms
    with blocks stage 64-half-site tiles' links and blocks, 73,728 bytes
    a block (R = 3) and 61,440 (R = 2), 8 tiles a plane, 16384 blocks of
    256 threads, 3 right-hand sides a lane; the block-free forms take
    B5-eo's plan; the default chunk is 1."""
    dims = (64, 32, 32, 16)
    b3, b2 = (clp.k_mrhs_plan(r, True, *dims) for r in (3, 2))
    f3, f2 = (clp.k_mrhs_plan(r, False, *dims) for r in (3, 2))
    assert (b3["tiles"], b3["blocks"], b3["threads"]) == (8, 16384, 256)
    assert (b3["smem"], b2["smem"]) == (73728, 61440)
    assert (f3, f2) == (wpp.eo_mrhs_plan(3, *dims),
                        wpp.eo_mrhs_plan(2, *dims))
    for with_blk, per_lane in ((True, 3), (False, 6)):
        nb = clp.k_mrhs_chunk(None, 12, 3, with_blk, *dims)
        assert nb == clp.K_MRHS_CHUNK == 1
        assert -(-12 // (clp.K_MRHS_LANES[with_blk] * nb)) == per_lane


def _k_mrhs_args(n=2):
    dims = (2, 2, 3, 4)
    sites = (2, 2, 3 * 2)
    u = torch.zeros((4, 3, 3, 2) + sites)
    psi = torch.zeros((n, 4, 3, 2) + sites)
    blk = torch.zeros((2, 6, 6, 2) + sites)
    return dims, u, psi, blk


def test_k_mrhs_refusals_name_the_limit_before_any_launch(monkeypatch):
    """K1/K2-mrhs refuse a chunk other than K_MRHS_CHUNK, N = 0, a grid
    beyond 2^31 - 1 blocks and a plan above 227 KB of shared memory a
    block with a ValueError naming the limit, on the CPU path too; None
    and K_MRHS_CHUNK are taken; nothing is counted."""
    counts = [(f.launches, dict(f.launches_by_form)) for f in
              (clp.dslash_eo_pallas_post_mrhs,
               clp.dslash_eo_pallas_diag_hop_mrhs)]
    dims, u, psi, blk = _k_mrhs_args()
    for nb in (2, 3):
        with pytest.raises(ValueError, match=rf"chunk {nb}.*\(chunk 1\)"):
            clp.dslash_eo_pallas_post_mrhs(u, u, psi, dims, 0, blk_pl=blk,
                                           chunk=nb)
    with pytest.raises(ValueError, match="N >= 1"):
        clp.dslash_eo_pallas_diag_hop_mrhs(u, u, psi[:0], psi[:0], dims, 1,
                                           hop_coeff=-0.01, diag_twist=0.1)
    for with_blk in (True, False):
        with pytest.raises(ValueError, match="2\\^31 - 1"):
            clp.k_mrhs_chunk(None, 1, 3, with_blk, 2 ** 16, 2 ** 16, 1,
                             2 ** 10)
        one_tile = clp.K_MRHS_TILE[with_blk]        # a plane of one tile
        assert clp.k_mrhs_plan(3, with_blk, 2 ** 16, 2 ** 15 - 1, 1,
                               one_tile)["blocks"] <= MAX_BLOCKS
    for nb in (None, clp.K_MRHS_CHUNK):
        assert clp.k_mrhs_chunk(nb, 5, 2, True, 2, 2, 3, 2) == \
            clp.K_MRHS_CHUNK
        out = clp.dslash_eo_pallas_diag_hop_mrhs(
            u, u, psi, psi, dims, 0, hop_coeff=-0.01, blk_pl=blk,
            diag_twist=0.1, chunk=nb)
        assert out.shape == psi.shape
    monkeypatch.setitem(clp.K_MRHS_TILE, True, 1024)
    with pytest.raises(ValueError, match="227 KB"):
        clp.dslash_eo_pallas_post_mrhs(u, u, psi, dims, 0, blk_pl=blk)
    with pytest.raises(ValueError, match="227 KB"):
        clp.k_mrhs_chunk(None, 12, 2, True, 64, 32, 32, 16)
    assert clp.k_mrhs_chunk(None, 12, 3, False, 64, 32, 32, 16) == \
        clp.K_MRHS_CHUNK
    assert [(f.launches, dict(f.launches_by_form)) for f in
            (clp.dslash_eo_pallas_post_mrhs,
             clp.dslash_eo_pallas_diag_hop_mrhs)] == counts


def test_k_mrhs_chunk_is_the_clover_default(monkeypatch):
    """K1/K2-mrhs take K_MRHS_CHUNK (1), whatever wpp.MRHS_CHUNK says, and
    wpp.MRHS_CHUNK (2) stays the default of r12f-mrhs (wpp.mrhs_chunk;
    fold-mrhs has FOLD_MRHS_CHUNK)."""
    dims = (64, 32, 32, 16)
    assert clp.K_MRHS_CHUNK == 1
    assert wpp.mrhs_chunk(None, 12, 64 * 32 * 32 * 16) == \
        wpp.MRHS_CHUNK == 2
    for other in wpp.MRHS_CHUNKS:
        monkeypatch.setattr(wpp, "MRHS_CHUNK", other)
        for with_blk in (True, False):
            assert clp.k_mrhs_chunk(None, 12, 3, with_blk, *dims) == \
                clp.K_MRHS_CHUNK
        assert wpp.mrhs_chunk(None, 12, 64 * 32 * 32 * 16) == other


# -- B8 (the single-RHS coarse stencil) ---------------------------------------

def test_coarse_plan_fits_every_accepted_width():
    """Every width the kernel takes (E 1 .. MAX_E, the 16-byte copies where
    E % 4 == 0, the 4-byte ones always) plans a ring within 227 KB of
    shared memory a block, lane groups that divide a warp and fill the
    block, tiles of link rows that cover E, stages that hold a tile's rows
    and the site's psi9 numbers 16-byte aligned, and, at S = 1 and up, a
    grid of one block an item, S x tiles."""
    for e in range(1, cop.MAX_E + 1):
        for vec4 in ((True, False) if e % 4 == 0 else (False,)):
            p = cop.coarse_plan(1, e, vec4)
            assert p["smem"] == 4 * cop.COARSE_STAGES * p["stage"]
            assert p["smem"] <= SMEM_PER_BLOCK
            assert p["lanes"] in (4, 8, 16, 32) and 32 % p["lanes"] == 0
            groups = cop.COARSE_THREADS // p["lanes"]
            assert p["rows"] == min(e, groups * cop.COARSE_ROWS_PER_GROUP)
            assert (p["tiles"] - 1) * p["rows"] < e <= p["tiles"] * p["rows"]
            assert p["stage"] >= p["rows"] * e + e and p["stage"] % 4 == 0
            for S in (1, 2, 7, 512, 8192, 10 ** 6):
                assert cop.coarse_plan(S, e, vec4)["items"] == \
                    S * p["tiles"]


def test_coarse_plan_at_the_multigrid_widths():
    """E 96 (n_vec 24): groups of 8 lanes, 32 rows a tile, 3 tiles a site,
    stages of 3168 floats, 38,016 bytes of ring a block (within the
    launch bound's COARSE_MIN_BLOCKS blocks an SM); the 4^3 x 8 level (S
    512) has 1536 blocks, the 8^3 x 16 level (S 8192) 24,576.  E 16 (n_vec
    4) takes groups of 4 lanes and one tile; E 96 on the 4-byte copies (an
    unaligned view) warp-wide rows."""
    p = cop.coarse_plan(512, 96)
    assert (p["lanes"], p["rows"], p["tiles"], p["stage"]) == (8, 32, 3,
                                                               3168)
    assert (p["smem"], p["threads"], p["items"]) == (38016, 256, 1536)
    assert cop.COARSE_MIN_BLOCKS * (p["smem"] + 1024) <= SMEM_PER_SM
    assert cop.coarse_plan(8192, 96)["items"] == 24576
    q = cop.coarse_plan(7, 16)
    assert (q["lanes"], q["rows"], q["tiles"]) == (4, 16, 1)
    assert cop.coarse_plan(7, 96, vec4=False)["lanes"] == 32


def test_coarse_refusals_name_the_limit_before_any_launch():
    """B8 refuses E outside 1 .. MAX_E with a ValueError naming the limit,
    on the CPU path too, and counts nothing; at MAX_E the plain version
    runs."""
    n0 = cop.coarse_apply_pallas.launches
    shapes = dict(cop.coarse_apply_pallas.launches_by_shape)
    e = cop.MAX_E + 1
    with pytest.raises(ValueError, match=f"E <= {cop.MAX_E}"):
        cop.coarse_apply_pallas(torch.zeros((9, 1, e, e)),
                                torch.zeros((9, 1, e)))
    with pytest.raises(ValueError, match="1 <= E"):
        cop.check_single(0, 3)
    with pytest.raises(ValueError, match="2\\^31 - 1"):
        cop.check_single(96, 2 ** 31 // 12 + 1)
    assert cop.check_single(96, 2 ** 31 // 12)["items"] == 3 * (2 ** 31 // 12)
    assert cop.check_single(cop.MAX_E, 1)["tiles"] >= 1
    out = cop.coarse_apply_pallas(torch.zeros((9, 1, 4, 4)),
                                  torch.zeros((9, 1, 4)))
    assert out.shape == (1, 4)
    assert cop.coarse_apply_pallas.launches == n0
    assert cop.coarse_apply_pallas.launches_by_shape == shapes


# -- fold-mrhs (the multi-RHS fold hop) ---------------------------------------

@pytest.mark.parametrize("rows", [3, 2])
def test_fold_mrhs_plan_fits_every_accepted_lattice(rows):
    """fold-mrhs's block (the tile's forward and backward links) fits
    227 KB of shared memory, FOLD_MRHS_MIN_BLOCKS (2) blocks to an SM (its
    launch bound), for every half lattice at R = 3 and 2; its tiles cover
    each (t, z) row of Y*Xh half-sites; it is B5-eo's plan."""
    assert wpp.FOLD_MRHS_MIN_BLOCKS == 2
    for xh in range(1, 80):
        for y in (1, 2, 5, 8, 32):
            p = wpp.fold_mrhs_plan(rows, 3, 5, y, xh)
            assert p == wpp.tile_plan(3, 5, y * xh, wpp.FOLD_MRHS_TILE,
                                      wpp.FOLD_MRHS_LANES, 2 * 24 * rows)
            assert p["smem"] <= SMEM_PER_BLOCK
            assert wpp.FOLD_MRHS_MIN_BLOCKS * (p["smem"] + 1024) <= \
                SMEM_PER_SM
            _assert_tiles_cover(p, 3, 5, y * xh, wpp.FOLD_MRHS_TILE)
            assert p["threads"] == wpp.FOLD_MRHS_LANES * wpp.FOLD_MRHS_TILE
            assert p["threads"] <= 1024 and p["threads"] % 32 == 0


def test_fold_mrhs_plan_at_the_smoke_lattice():
    """32^3 x 64 (rows of 512 half-sites): B5-eo's plan, 4 tiles a row,
    8192 blocks of 256 threads, 73,728 bytes of links a block (R = 3) and
    49,152 (R = 2); the default chunk is 1, FOLD_MRHS_CHUNK, whatever
    wpp.MRHS_CHUNK (r12f-mrhs's) says."""
    dims = (64, 32, 32, 16)
    p3, p2 = (wpp.fold_mrhs_plan(r, *dims) for r in (3, 2))
    assert (p3, p2) == (wpp.eo_mrhs_plan(3, *dims),
                        wpp.eo_mrhs_plan(2, *dims))
    assert (p3["tiles"], p3["blocks"], p3["threads"]) == (4, 8192, 256)
    assert (p3["smem"], p2["smem"]) == (73728, 49152)
    assert wpp.FOLD_MRHS_CHUNK == 1 != wpp.MRHS_CHUNK
    assert wpp.fold_mrhs_chunk(None, 12, 3, *dims) == wpp.FOLD_MRHS_CHUNK


def test_fold_mrhs_refusals_name_the_limit_before_any_launch():
    """fold-mrhs refuses a chunk other than FOLD_MRHS_CHUNK, N = 0 and a
    grid beyond 2^31 - 1 blocks with a ValueError naming the limit, on the
    CPU path too; None and FOLD_MRHS_CHUNK are taken; nothing is
    counted."""
    fn = wpp.dslash_eo_pallas_packed_fold_mrhs
    n0 = (fn.launches, dict(fn.launches_by_form))
    dims = (2, 2, 3, 4)
    fsites = (2, 2 * 2, 3 * 2)
    u = torch.zeros((4, 3, 3) + fsites)
    psi = torch.zeros((2, 4, 3) + fsites)
    for nb in (2, 3):
        with pytest.raises(ValueError, match=rf"chunk {nb}.*\(chunk 1\)"):
            fn(u, u, psi, dims, 0, chunk=nb)
    with pytest.raises(ValueError, match="N >= 1"):
        fn(u, u, psi[:0], dims, 1)
    with pytest.raises(ValueError, match="2\\^31 - 1"):
        wpp.fold_mrhs_chunk(None, 1, 3, 2 ** 16, 2 ** 16, 1, 2 ** 10)
    for nb in (None, wpp.FOLD_MRHS_CHUNK):
        assert wpp.fold_mrhs_chunk(nb, 5, 2, 2, 2, 3, 2) == \
            wpp.FOLD_MRHS_CHUNK
        assert fn(u, u, psi, dims, 0, chunk=nb).shape == psi.shape
    assert (fn.launches, dict(fn.launches_by_form)) == n0


@pytest.mark.parametrize("tile", [wpp.FOLD_MRHS_TILE, 6])
@pytest.mark.parametrize("rows", [3, 2])
def test_fold_tile_copy_places_components(rows, tile):
    """The fold tile copy's index map (fold_tile_sources, the FoldPlanes
    hook of csrc/mrhs_tile.cuh's copy_sets) on a 4x6x4x8 (T, Z, Y, X)
    folded link set made from a numpy-seeded pair field: tile plane 2c is
    component c's real run and plane 2c + 1 its imaginary run, the same
    numbers the pair layout's tile copy reads, for every tile of every
    (t, z) row (tile 6 leaves a partial tile of 4 on each row of 16)."""
    T, Z, Y, X = 4, 6, 4, 8
    Xh = X // 2
    yxh = Y * Xh
    rng = np.random.default_rng(401 + rows)
    pair = torch.from_numpy(rng.standard_normal(
        (4, rows, 3, 2, T, Z, yxh)).astype(np.float32))
    flat = wpp.to_fold(pair).reshape(-1)
    comps = pair.reshape(4 * rows * 3, 2, T, Z, yxh)
    tiles = -(-yxh // tile)
    for t in range(T):
        for z in range(Z):
            for j in range(tiles):
                src = wpp.fold_tile_sources(rows, T, Z, Y, Xh, t, z, j, tile)
                run = slice(j * tile, min((j + 1) * tile, yxh))
                assert src.shape == (2 * 12 * rows, run.stop - run.start)
                staged = flat[src]
                for c in range(12 * rows):
                    assert torch.equal(staged[2 * c], comps[c, 0, t, z, run])
                    assert torch.equal(staged[2 * c + 1],
                                       comps[c, 1, t, z, run])
