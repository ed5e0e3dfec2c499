"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA card and nvcc (``cuda`` marker) and skips
without one: a CUDA kernel has no interpret mode.  The file imports no JAX,
so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances are the ones the kernel modules state (``TOLERANCE``).
"""

import numpy as np
import pytest
import torch

import quda_tpu_torch as qt
from quda_tpu_torch.ops import blas
from quda_tpu_torch.ops import blas_pallas as bpl
from quda_tpu_torch.ops import clover_pallas as clp
from quda_tpu_torch.ops import coarse_pallas as cop
from quda_tpu_torch.ops import staggered_pallas as spl
from quda_tpu_torch.ops import wilson_pallas_packed as wpp

from tests.torch_inputs import (ASYM, SMALL, gaussian, lattice_shape,
                                noisy_gauge, pair_spinor_shape, rel_err,
                                require_cuda, su3_gauge)

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("parity", [0, 1])
def test_eo_kernel_matches_plain(parity):
    dev = require_cuda()
    dims = lattice_shape(ASYM)
    gen = torch.Generator(device=dev).manual_seed(parity)
    sites = pair_spinor_shape(ASYM)[3:]
    psi = torch.randn((4, 3, 2) + sites, generator=gen, device=dev)
    u_here = torch.randn((4, 3, 3, 2) + sites, generator=gen, device=dev)
    u_bw = wpp.backward_gauge_eo(
        torch.randn((4, 3, 3, 2) + sites, generator=gen, device=dev), dims,
        parity).contiguous()
    n0 = wpp.dslash_eo_pallas_packed.launches
    got = wpp.dslash_eo_pallas_packed(u_here, u_bw, psi, dims, parity)
    want = wpp.dslash_eo_packed_plain(u_here, u_bw, psi, dims, parity)
    torch.cuda.synchronize()
    assert wpp.dslash_eo_pallas_packed.launches == n0 + 1
    assert rel_err(got.cpu().numpy(), want.cpu().numpy()) < wpp.TOLERANCE


# (rows, storage, out) of each eo-hop instance beyond full f32
FORMS = [(3, torch.bfloat16, torch.bfloat16), (3, torch.bfloat16, torch.float32),
         (2, torch.float32, torch.float32), (2, torch.bfloat16, torch.bfloat16),
         (2, torch.bfloat16, torch.float32)]


@pytest.mark.parametrize("tb_sign", [True, False],
                         ids=["antiperiodic", "periodic"])
@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("form", FORMS,
                         ids=lambda f: wpp.form_name(*f))
def test_eo_kernel_forms_match_plain(form, parity, tb_sign):
    """bf16 storage and recon-12 on 4x6x8x10 (T=10: both t boundary
    planes hold sites of each parity): f32 output within TOLERANCE,
    bf16 output within TOLERANCE_BF16 (one bf16 ulp of max |plain|)."""
    dev = require_cuda()
    rows, store, out = form
    dims = lattice_shape(ASYM)
    gen = torch.Generator(device=dev).manual_seed(7 + parity)
    sites = pair_spinor_shape(ASYM)[3:]
    psi = torch.randn((4, 3, 2) + sites, generator=gen, device=dev).to(store)
    u_here = torch.randn((4, rows, 3, 2) + sites, generator=gen,
                         device=dev).to(store)
    u_bw = wpp.backward_gauge_eo(
        torch.randn((4, rows, 3, 2) + sites, generator=gen, device=dev),
        dims, parity).to(store).contiguous()
    name = wpp.form_name(rows, store, out)
    n0 = wpp.dslash_eo_pallas_packed.launches_by_form.get(name, 0)
    got = wpp.dslash_eo_pallas_packed(u_here, u_bw, psi, dims, parity,
                                      out_dtype=out, tb_sign=tb_sign)
    want = wpp.dslash_eo_packed_plain(u_here, u_bw, psi, dims, parity,
                                      out_dtype=out, tb_sign=tb_sign)
    torch.cuda.synchronize()
    assert got.dtype == out
    assert wpp.dslash_eo_pallas_packed.launches_by_form[name] == n0 + 1
    tol = wpp.TOLERANCE if out == torch.float32 else wpp.TOLERANCE_BF16
    assert rel_err(got.float().cpu().numpy(), want.float().cpu().numpy()) \
        <= tol


# (kernel, rows, storage) of each fused clover hop instance
CLOVER_FORMS = [(k, r, s) for k in ("post", "diag_hop") for r in (3, 2)
                for s in (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("form", CLOVER_FORMS, ids=lambda f: f"{f[0]}:" + (
    wpp.form_name(f[1], f[2], clp.out_dtype_of(f[0], f[2]))))
def test_clover_kernel_forms_match_plain(form, parity):
    """K1 and K2 on 4x6x8x10 (both t boundary planes hold sites of each
    parity), blocks 1 + 0.1 Gaussian: f32 output within TOLERANCE, bf16
    output within TOLERANCE_BF16 of max |plain|."""
    dev = require_cuda()
    kind, rows, store = form
    out = clp.out_dtype_of(kind, store)
    dims = lattice_shape(ASYM)
    gen = torch.Generator(device=dev).manual_seed(11 + parity)
    sites = pair_spinor_shape(ASYM)[3:]

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    psi, xc = (randn(4, 3, 2, *sites).to(store) for _ in range(2))
    u_here = randn(4, rows, 3, 2, *sites).to(store)
    u_bw = wpp.backward_gauge_eo(randn(4, rows, 3, 2, *sites), dims,
                                 parity).to(store).contiguous()
    eye = torch.eye(6, device=dev).reshape(1, 6, 6, 1, 1, 1)
    blk = 0.1 * randn(2, 6, 6, 2, *sites)
    blk[:, :, :, 0] += eye
    blk = blk.to(store)
    wrapper = (clp.dslash_eo_pallas_post if kind == "post"
               else clp.dslash_eo_pallas_diag_hop)
    name = wpp.form_name(rows, store, out)
    n0 = wrapper.launches_by_form.get(name, 0)
    if kind == "post":
        got = wrapper(u_here, u_bw, psi, dims, parity, blk_pl=blk)
        want = clp.dslash_eo_post_plain(u_here, u_bw, psi, blk, dims, parity)
    else:
        got = wrapper(u_here, u_bw, psi, xc, dims, parity, hop_coeff=-0.0144,
                      blk_pl=blk, out_dtype=torch.float32)
        want = clp.dslash_eo_diag_hop_plain(u_here, u_bw, psi, xc, blk, dims,
                                            parity, -0.0144, torch.float32)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == out
    assert wrapper.launches_by_form[name] == n0 + 1
    tol = clp.TOLERANCE if out == torch.float32 else clp.TOLERANCE_BF16
    assert rel_err(got.float().cpu().numpy(), want.float().cpu().numpy()) \
        <= tol


@pytest.mark.parametrize("sloppy,rec", [("single", 18), ("half", 18),
                                        ("half", 12)],
                         ids=["single", "half", "half-r12"])
def test_clover_invert_on_card_matches_cpu(sloppy, rec):
    """invert_quda(clover) on 4^3x8 SU(3) links, csw 1: the card (K1 and
    K2 each launched once per M apply, twice per iteration) against the
    CPU's plain path, iterations within 2 (single) or 10% (half),
    solutions within 1e-4 (single) or 1e-3 (half)."""
    dev = require_cuda()
    g = su3_gauge(SMALL, seed=33)
    b = gaussian(lattice_shape(SMALL) + (4, 3), seed=34)
    kw = dict(dslash_type="clover", csw=1.0, cuda_prec_sloppy=sloppy,
              reconstruct=rec)
    clp.reset_launches()
    xg, pg = _solve(g, b, dev, **kw)
    k1 = clp.dslash_eo_pallas_post.launches
    k2 = clp.dslash_eo_pallas_diag_hop.launches
    assert k1 >= 2 * pg.iter_count and k2 >= 2 * pg.iter_count
    xc, pc = _solve(g, b, "cpu", **kw)
    assert pg.converged and pg.true_res <= 1e-5
    assert (pg.reliable_updates >= 1) == (sloppy == "half")
    it_tol = 2 if sloppy == "single" else 0.1 * pc.iter_count
    sol_tol = 1e-4 if sloppy == "single" else 1e-3
    assert abs(pg.iter_count - pc.iter_count) <= it_tol
    assert np.linalg.norm(xg - xc) / np.linalg.norm(xc) < sol_tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_axpy_norm2_kernel_matches_plain(dtype):
    """B3: y' equal to the plain version's (both round a x and y + a x
    separately), |y'|^2 within TOLERANCE, the same bits on a second run."""
    dev = require_cuda()
    x, y = (torch.from_numpy(gaussian(pair_spinor_shape(SMALL), seed=43 + i,
                                      dtype=np.float32)).to(dev).to(dtype)
            for i in range(2))
    a = torch.tensor(-0.37, device=dev)
    n0 = bpl.axpy_norm2_pallas.launches
    ky, kn2 = bpl.axpy_norm2_pallas(a, x, y)
    ky2, kn22 = bpl.axpy_norm2_pallas(a, x, y)
    py, pn2 = bpl.axpy_norm2_plain(a, x, y)
    torch.cuda.synchronize()
    assert bpl.axpy_norm2_pallas.launches == n0 + 2
    assert ky.dtype == dtype and torch.equal(ky, py)
    assert abs(float(kn2) - float(pn2)) <= bpl.TOLERANCE * float(pn2)
    assert torch.equal(kn2, kn22) and torch.equal(ky, ky2)


@pytest.mark.parametrize("form", ["full", "r12"])
def test_invert_half_on_card_matches_cpu(form):
    """single/half on 4^3x8 SU(3) links: the card (bf16 hop and B3
    launches) against the CPU's plain path, iterations within 10%,
    solutions within 1e-3."""
    dev = require_cuda()
    rec = 12 if form == "r12" else 18
    g = su3_gauge(SMALL, seed=29)
    b = gaussian(lattice_shape(SMALL) + (4, 3), seed=30)
    wpp.reset_launches()
    n3 = bpl.axpy_norm2_pallas.launches
    xg, pg = _solve(g, b, dev, cuda_prec_sloppy="half", reconstruct=rec)
    bf16 = sum(v for k, v in wpp.dslash_eo_pallas_packed.launches_by_form
               .items() if ":bf16->" in k)
    rows = sum(v for k, v in wpp.dslash_eo_pallas_packed.launches_by_form
               .items() if k.startswith("r12:"))
    assert bf16 >= 4 * pg.iter_count
    assert bpl.axpy_norm2_pallas.launches - n3 >= pg.iter_count
    assert (rows >= 4 * pg.iter_count) == (form == "r12")
    xc, pc = _solve(g, b, "cpu", cuda_prec_sloppy="half", reconstruct=rec)
    assert pg.converged and pg.true_res <= 1e-5 and pg.reliable_updates >= 1
    assert abs(pg.iter_count - pc.iter_count) <= 0.1 * pc.iter_count
    assert np.linalg.norm(xg - xc) / np.linalg.norm(xc) < 1e-3


def test_df64_invert_on_card():
    """The df64 route on the card, 4^4 at tol 1e-10: true_res < 1e-10."""
    dev = require_cuda()
    dims = (4, 4, 4, 4)
    g = noisy_gauge(dims, seed=31)
    b = gaussian(lattice_shape(dims) + (4, 3), seed=32)
    _, p = _solve(g, b, dev, dims=dims, tol=1e-10)
    assert p.converged and p.true_res < 1e-10 and p.x_df64_lo is not None


def test_cg_tail_kernel_matches_plain():
    dev = require_cuda()
    tin = [torch.from_numpy(gaussian(pair_spinor_shape(SMALL), seed=41 + i,
                                     dtype=np.float32)).to(dev)
           for i in range(4)]
    alpha = torch.tensor(0.37, device=dev)
    n0 = bpl.cg_update_norm2_pallas.launches
    kx, kr, kr2 = bpl.cg_update_norm2_pallas(alpha, *tin)
    px, pr, pr2 = blas.triple_cg_update(alpha, *tin)
    torch.cuda.synchronize()
    assert bpl.cg_update_norm2_pallas.launches == n0 + 1
    assert rel_err(kx.cpu().numpy(), px.cpu().numpy()) < bpl.TOLERANCE
    assert rel_err(kr.cpu().numpy(), pr.cpu().numpy()) < bpl.TOLERANCE
    assert abs(float(kr2) - float(pr2)) <= bpl.TOLERANCE * float(pr2)


def _solve(g, b, device, dims=SMALL, reconstruct=18, **kw):
    qt.init_quda(device=device)
    try:
        qt.load_gauge_quda(g, qt.GaugeParam(X=dims, cuda_prec="single",
                                            reconstruct=reconstruct))
        base = dict(dslash_type="wilson", inv_type="cg",
                    solve_type="normop-pc", kappa=0.12, tol=1e-6,
                    maxiter=1000, cuda_prec="single")
        base.update(kw)
        p = qt.InvertParam(**base)
        x = qt.invert_quda(b, p)
    finally:
        qt.end_quda()
    return x.cpu().numpy(), p


def test_invert_on_card_matches_cpu():
    dev = require_cuda()
    g = noisy_gauge(SMALL, seed=27)
    b = gaussian(lattice_shape(SMALL) + (4, 3), seed=28)
    n1 = wpp.dslash_eo_pallas_packed.launches
    n2 = bpl.cg_update_norm2_pallas.launches
    xg, pg = _solve(g, b, dev)
    assert wpp.dslash_eo_pallas_packed.launches - n1 >= 4 * pg.iter_count
    assert bpl.cg_update_norm2_pallas.launches - n2 == pg.iter_count
    xc, pc = _solve(g, b, "cpu")
    assert pg.converged and pg.true_res <= 1e-5
    assert abs(pg.iter_count - pc.iter_count) <= 2
    assert np.linalg.norm(xg - xc) / np.linalg.norm(xc) < 1e-4


# -- the multi-RHS kernels (B5-eo, B7-mrhs) -------------------------------

def _mrhs_inputs(dev, rows, parity, n, seed):
    """4x6x8x10 links (forward, pre-shifted backward), an n-RHS psi and
    x batch, and blocks 1 + 0.1 Gaussian."""
    dims = lattice_shape(ASYM)
    gen = torch.Generator(device=dev).manual_seed(seed)
    sites = pair_spinor_shape(ASYM)[3:]

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    u_here = randn(4, rows, 3, 2, *sites)
    u_bw = wpp.backward_gauge_eo(randn(4, rows, 3, 2, *sites), dims,
                                 parity).contiguous()
    psi, xc = randn(n, 4, 3, 2, *sites), randn(n, 4, 3, 2, *sites)
    blk = 0.1 * randn(2, 6, 6, 2, *sites)
    blk[:, :, :, 0] += torch.eye(6, device=dev).reshape(1, 6, 6, 1, 1, 1)
    return dims, u_here, u_bw, psi, xc, blk


def _mrhs_call(kind, args, parity, plain=False, single=False, chunk=None):
    """One multi-RHS call (kernel or plain), or the batch through N
    single-RHS kernel launches."""
    dims, u_here, u_bw, psi, xc, blk = args
    if single:
        fn = {"hop": wpp.dslash_eo_pallas_packed,
              "post": clp.dslash_eo_pallas_post,
              "diag_hop": clp.dslash_eo_pallas_diag_hop}[kind]
        outs = []
        for r in range(psi.shape[0]):
            if kind == "hop":
                outs.append(fn(u_here, u_bw, psi[r], dims, parity))
            elif kind == "post":
                outs.append(fn(u_here, u_bw, psi[r], dims, parity,
                               blk_pl=blk))
            else:
                outs.append(fn(u_here, u_bw, psi[r], xc[r], dims, parity,
                               hop_coeff=-0.0144, blk_pl=blk,
                               out_dtype=torch.float32))
        return torch.stack(outs)
    if kind == "hop":
        if plain:
            return wpp.dslash_eo_packed_mrhs_plain(u_here, u_bw, psi, dims,
                                                   parity)
        return wpp.dslash_eo_pallas_packed_mrhs(u_here, u_bw, psi, dims,
                                                parity, chunk=chunk)
    if kind == "post":
        if plain:
            return clp.dslash_eo_post_mrhs_plain(u_here, u_bw, psi, blk,
                                                 dims, parity)
        return clp.dslash_eo_pallas_post_mrhs(u_here, u_bw, psi, dims,
                                              parity, blk_pl=blk,
                                              chunk=chunk)
    if plain:
        return clp.dslash_eo_diag_hop_mrhs_plain(u_here, u_bw, psi, xc, blk,
                                                 dims, parity, -0.0144,
                                                 torch.float32)
    return clp.dslash_eo_pallas_diag_hop_mrhs(u_here, u_bw, psi, xc, dims,
                                              parity, hop_coeff=-0.0144,
                                              blk_pl=blk,
                                              out_dtype=torch.float32,
                                              chunk=chunk)


_MRHS_WRAPPER = {"hop": wpp.dslash_eo_pallas_packed_mrhs,
                 "post": clp.dslash_eo_pallas_post_mrhs,
                 "diag_hop": clp.dslash_eo_pallas_diag_hop_mrhs}


# B5-eo's chunk widths, and K1/K2-mrhs's one
MRHS_KIND_CHUNKS = ([("hop", c) for c in wpp.MRHS_CHUNKS]
                    + [(k, clp.K_MRHS_CHUNK) for k in ("post", "diag_hop")])


@pytest.mark.parametrize("n", [1, 3, 12])
@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("rows", [3, 2], ids=["full", "r12"])
@pytest.mark.parametrize("kind,chunk", MRHS_KIND_CHUNKS,
                         ids=[f"{k}-{c}" for k, c in MRHS_KIND_CHUNKS])
def test_mrhs_kernels_match_plain_and_single_launches(kind, rows, parity,
                                                      chunk, n):
    """B5-eo on 4x6x8x10 at every chunk width, with a tail chunk where n
    is not a multiple of it, and K1/K2-mrhs at its one: within TOLERANCE
    of the plain version, and within TOLERANCE of n launches of the
    single-RHS kernel (each right-hand side sees the single kernel's
    arithmetic in its order); one launch counted."""
    dev = require_cuda()
    args = _mrhs_inputs(dev, rows, parity, n, seed=51 + parity)
    wrapper = _MRHS_WRAPPER[kind]
    n0 = wrapper.launches
    got = _mrhs_call(kind, args, parity, chunk=chunk)
    assert wrapper.launches == n0 + 1
    want = _mrhs_call(kind, args, parity, plain=True)
    single = _mrhs_call(kind, args, parity, single=True)
    torch.cuda.synchronize()
    assert got.shape == args[3].shape and got.dtype == torch.float32
    tol = wpp.TOLERANCE if kind == "hop" else clp.TOLERANCE
    got, want, single = (t.cpu().numpy() for t in (got, want, single))
    assert rel_err(got, want) <= tol
    assert rel_err(got, single) <= tol


@pytest.mark.parametrize("kind", ["hop", "post", "diag_hop"])
def test_mrhs_kernels_refuse_what_they_lack(kind):
    """bf16 storage (ROADMAP B5) and chunk widths without an instance
    raise; nothing launches."""
    dev = require_cuda()
    args = _mrhs_inputs(dev, 3, 0, 2, seed=55)
    wrapper = _MRHS_WRAPPER[kind]
    n0 = wrapper.launches
    with pytest.raises(ValueError, match="chunk"):
        _mrhs_call(kind, args, 0, chunk=3)
    dims, u_here, u_bw, psi, xc, blk = args
    bf = torch.bfloat16
    with pytest.raises(TypeError, match="ROADMAP B5"):
        _mrhs_call(kind, (dims, u_here.to(bf), u_bw.to(bf), psi.to(bf),
                          xc.to(bf), blk.to(bf)), 0)
    assert wrapper.launches == n0


def _solve_multi(g, B, device, reconstruct=18, **kw):
    qt.init_quda(device=device)
    try:
        qt.load_gauge_quda(g, qt.GaugeParam(X=SMALL, cuda_prec="single",
                                            reconstruct=reconstruct))
        base = dict(dslash_type="wilson", inv_type="cg",
                    solve_type="normop-pc", kappa=0.12, tol=1e-6,
                    maxiter=1000, cuda_prec="single")
        base.update(kw)
        p = qt.InvertParam(**base)
        x = qt.invert_multi_src_quda(B, p)
    finally:
        qt.end_quda()
    return x.cpu().numpy(), p


@pytest.mark.parametrize("family,rec", [("wilson", 18), ("wilson", 12),
                                        ("clover", 18)],
                         ids=["wilson", "wilson-r12", "clover"])
def test_invert_multi_src_on_card_matches_cpu(family, rec):
    """invert_multi_src_quda on 4^3x8 SU(3) links, 3 sources: the card
    (multi-RHS kernels only, no single-RHS hop) against the CPU's plain
    path, per-lane iterations within 2, solutions within 1e-4."""
    dev = require_cuda()
    g = su3_gauge(SMALL, seed=57)
    B = gaussian((3,) + lattice_shape(SMALL) + (4, 3), seed=58)
    kw = dict(dslash_type=family, reconstruct=rec)
    if family == "clover":
        kw["csw"] = 1.0
    wpp.reset_launches()
    clp.reset_launches()
    xg, pg = _solve_multi(g, B, dev, **kw)
    assert wpp.dslash_eo_pallas_packed.launches == 0
    assert clp.dslash_eo_pallas_post.launches == 0
    assert clp.dslash_eo_pallas_diag_hop.launches == 0
    it = max(pg.iter_count_multi)
    if family == "wilson":
        assert wpp.dslash_eo_pallas_packed_mrhs.launches >= 4 * it
    else:
        assert clp.dslash_eo_pallas_post_mrhs.launches >= 2 * it
        assert clp.dslash_eo_pallas_diag_hop_mrhs.launches >= 2 * it
    xc, pc = _solve_multi(g, B, "cpu", **kw)
    assert pg.converged and max(pg.true_res_multi) <= 1e-5
    assert all(abs(a - b) <= 2 for a, b in zip(pg.iter_count_multi,
                                                pc.iter_count_multi))
    assert np.linalg.norm(xg - xc) / np.linalg.norm(xc) < 1e-4


@pytest.mark.parametrize("kind", ["hop", "post", "diag_hop"])
def test_mrhs_chunk_one_is_the_single_kernel(kind):
    """At chunk width 1 the multi-RHS kernel runs the single-RHS
    kernel's hop and epilogue on each right-hand side: the same bits."""
    dev = require_cuda()
    args = _mrhs_inputs(dev, 3, 1, 3, seed=59)
    got = _mrhs_call(kind, args, 1, chunk=1)
    single = _mrhs_call(kind, args, 1, single=True)
    torch.cuda.synchronize()
    assert torch.equal(got, single)


# -- the staggered hops (S1 fused fat + Naik, S2 gather pass) ---------------

# (T, Z, Y, X): every extent >= 7 (a 3-hop aliases no shorter hop), all
# four different
STAG_DIMS = (14, 12, 10, 8)
STAG_FORMS = [(torch.float32, torch.float32),
              (torch.bfloat16, torch.bfloat16),
              (torch.bfloat16, torch.float32)]


def _stag_inputs(dev, store, seed):
    """Four link sets (fat and long, here and there; the long ones at
    1/24 the scale) and psi, random normal on the card, in ``store``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    sites = (STAG_DIMS[0], STAG_DIMS[1], STAG_DIMS[2] * STAG_DIMS[3] // 2)
    links = [torch.randn((4, 3, 3, 2) + sites, generator=gen, device=dev)
             * (1.0 if i < 2 else 1.0 / 24) for i in range(4)]
    psi = torch.randn((3, 2) + sites, generator=gen, device=dev)
    return [u.to(store).contiguous() for u in links], psi.to(store)


def _stag_tol(out):
    return spl.TOLERANCE if out == torch.float32 else spl.TOLERANCE_BF16


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("form", STAG_FORMS,
                         ids=lambda f: spl.form_name(*f))
def test_stag_fused_kernel_matches_plain(form, parity):
    dev = require_cuda()
    store, out = form
    (fh, ft, lh, lt), psi = _stag_inputs(dev, store, 60 + parity)
    name = spl.form_name(store, out)
    n0 = spl.dslash_staggered_eo_pallas_fused.launches_by_form.get(name, 0)
    got = spl.dslash_staggered_eo_pallas_fused(fh, ft, psi, STAG_DIMS,
                                               parity, lh, lt, out_dtype=out)
    want = spl.dslash_staggered_eo_fused_plain(fh, ft, psi, STAG_DIMS,
                                               parity, lh, lt, out_dtype=out)
    torch.cuda.synchronize()
    assert got.dtype == out
    assert spl.dslash_staggered_eo_pallas_fused.launches_by_form[name] == \
        n0 + 1
    assert rel_err(got.float().cpu().numpy(),
                   want.float().cpu().numpy()) < _stag_tol(out)


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("form", STAG_FORMS,
                         ids=lambda f: spl.form_name(*f).split(":")[1])
@pytest.mark.parametrize("nhop", [1, 3], ids=["fat", "naik"])
def test_stag_pass_kernel_matches_plain(nhop, form, parity):
    dev = require_cuda()
    store, out = form
    (fh, ft, _, _), psi = _stag_inputs(dev, store, 62 + parity)
    ubw = spl.backward_links_eo(ft, STAG_DIMS, parity, nhop).contiguous()
    name = spl.pass_form_name(nhop, store, out)
    n0 = spl.dslash_staggered_eo_pass.launches_by_form.get(name, 0)
    got = spl.dslash_staggered_eo_pass(fh, ubw, psi, STAG_DIMS, parity, nhop,
                                       out_dtype=out)
    want = spl.dslash_staggered_eo_pass_plain(fh, ubw, psi, STAG_DIMS,
                                              parity, nhop, out_dtype=out)
    torch.cuda.synchronize()
    assert got.dtype == out
    assert spl.dslash_staggered_eo_pass.launches_by_form[name] == n0 + 1
    assert rel_err(got.float().cpu().numpy(),
                   want.float().cpu().numpy()) < _stag_tol(out)


@pytest.mark.parametrize("parity", [0, 1])
def test_stag_fused_equals_two_passes(parity):
    """S1 = S2(fat) + S2(naik) on the card, float32, within 1e-6."""
    dev = require_cuda()
    (fh, ft, lh, lt), psi = _stag_inputs(dev, torch.float32, 64 + parity)
    fused = spl.dslash_staggered_eo_pallas_fused(fh, ft, psi, STAG_DIMS,
                                                 parity, lh, lt)
    fbw = spl.backward_links_eo(ft, STAG_DIMS, parity, 1).contiguous()
    lbw = spl.backward_links_eo(lt, STAG_DIMS, parity, 3).contiguous()
    two = spl.dslash_staggered_eo_pallas(fh, fbw, psi, STAG_DIMS, parity,
                                         lh, lbw)
    torch.cuda.synchronize()
    assert rel_err(fused.cpu().numpy(), two.cpu().numpy()) < 1e-6


def test_stag_kernels_refuse_what_they_lack():
    dev = require_cuda()
    (fh, ft, lh, lt), psi = _stag_inputs(dev, torch.float32, 66)
    with pytest.raises(TypeError, match="no kernel instance"):
        spl.dslash_staggered_eo_pallas_fused(fh, ft, psi, STAG_DIMS, 0, lh,
                                             lt, out_dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="ROADMAP C"):
        spl.dslash_staggered_eo_pallas_fused(fh, ft, psi, STAG_DIMS, 0,
                                             lh[:, :2].contiguous(), lt)
    strided = torch.zeros(psi.shape[:-1] + (2 * psi.shape[-1],),
                          device=dev)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        spl.dslash_staggered_eo_pass(fh, ft, strided, STAG_DIMS, 0, 1)
    with pytest.raises(ValueError, match="nhop"):
        spl.dslash_staggered_eo_pass(fh, ft, psi, STAG_DIMS, 0, 2)


@pytest.mark.parametrize("dslash,sloppy", [("hisq", "single"),
                                           ("hisq", "half"),
                                           ("staggered", "single")])
def test_staggered_invert_on_card_matches_cpu(dslash, sloppy):
    """invert_quda on the staggered family at 8^4 (SU(3) links, m 0.1):
    the card (S1 for hisq, twice per fused_cg iteration; S2 and no S1
    for fat-only) against the CPU's plain path, iterations within 2,
    solutions within 1e-4 (1e-3 at half)."""
    dev = require_cuda()
    dims = (8, 8, 8, 8)
    g = su3_gauge(dims, seed=67)
    b = gaussian(lattice_shape(dims) + (1, 3), seed=68)
    out = {}
    for where in (dev, "cpu"):
        qt.init_quda(device=where)
        try:
            qt.load_gauge_quda(g, qt.GaugeParam(X=dims, cuda_prec="single"))
            qt.compute_ks_link_quda()
            p = qt.InvertParam(dslash_type=dslash, inv_type="cg",
                               solve_type="direct-pc", mass=0.1, tol=1e-6,
                               maxiter=2000, cuda_prec="single",
                               cuda_prec_sloppy=sloppy)
            spl.reset_launches()
            x = qt.invert_quda(b, p)
            counts = (spl.dslash_staggered_eo_pallas_fused.launches,
                      spl.dslash_staggered_eo_pass.launches)
        finally:
            qt.end_quda()
        out[str(where)] = (x.cpu().numpy(), p, counts)
    xg, pg, (s1, s2) = out[str(dev)]
    xc, pc, _ = out["cpu"]
    assert pg.converged and pg.true_res <= 1e-5
    if dslash == "hisq":
        assert s2 == 0 and s1 >= 2 * pg.iter_count
        if sloppy == "single":
            assert s1 == 2 * pg.iter_count + 2
    else:
        assert s1 == 0 and s2 == 2 * pg.iter_count + 2
    di = abs(pg.iter_count - pc.iter_count)
    assert di <= (2 if sloppy == "single" else max(2, pc.iter_count // 10))
    tol = 1e-4 if sloppy == "single" else 1e-3
    assert np.linalg.norm(xg - xc) / np.linalg.norm(xc) < tol


# -- the multi-RHS staggered gather pass (S2-mrhs) ---------------------------

@pytest.mark.parametrize("n", [1, 3, 5, 12])
@pytest.mark.parametrize("parity", [0, 1])
def test_stag_mrhs_kernel_matches_plain_and_single_launches(parity, n):
    """S2-mrhs on 14x12x10x8, each hop count, with a tail chunk where n is
    not a multiple of MRHS_CHUNK: within TOLERANCE of its plain version,
    and each lane bit for bit S2 (fat, Naik); the fat + Naik composition
    bit for bit the two-pass S2 sum and S1, one launch per pass."""
    dev = require_cuda()
    (fh, ft, lh, lt), _ = _stag_inputs(dev, torch.float32, 70 + parity)
    gen = torch.Generator(device=dev).manual_seed(72 + n)
    psi = torch.randn((n, 3, 2) + tuple(fh.shape[-3:]), generator=gen,
                      device=dev)
    fbw = spl.backward_links_eo(ft, STAG_DIMS, parity, 1).contiguous()
    lbw = spl.backward_links_eo(lt, STAG_DIMS, parity, 3).contiguous()
    fn = spl.dslash_staggered_eo_pass_mrhs
    for here, bw, nhop in ((fh, fbw, 1), (lh, lbw, 3)):
        name = spl.pass_form_name(nhop, torch.float32, torch.float32)
        n0 = fn.launches_by_form.get(name, 0)
        got = fn(here, bw, psi, STAG_DIMS, parity, nhop)
        want = spl.dslash_staggered_eo_pass_mrhs_plain(here, bw, psi,
                                                       STAG_DIMS, parity,
                                                       nhop)
        torch.cuda.synchronize()
        assert fn.launches_by_form[name] == n0 + 1
        assert rel_err(got.cpu().numpy(), want.cpu().numpy()) < spl.TOLERANCE
        for r in range(n):
            assert torch.equal(got[r], spl.dslash_staggered_eo_pass(
                here, bw, psi[r], STAG_DIMS, parity, nhop))
    n0 = fn.launches
    both = spl.dslash_staggered_eo_pallas_mrhs(fh, fbw, psi, STAG_DIMS,
                                               parity, lh, lbw)
    assert fn.launches == n0 + 2
    for r in range(n):
        assert torch.equal(both[r], spl.dslash_staggered_eo_pallas(
            fh, fbw, psi[r], STAG_DIMS, parity, lh, lbw))
        assert torch.equal(both[r], spl.dslash_staggered_eo_pallas_fused(
            fh, ft, psi[r], STAG_DIMS, parity, lh, lt))


def test_stag_mrhs_kernel_refuses_what_it_lacks():
    dev = require_cuda()
    (fh, ft, _, _), _ = _stag_inputs(dev, torch.float32, 74)
    psi = torch.zeros((2, 3, 2) + tuple(fh.shape[-3:]), device=dev)
    fn = spl.dslash_staggered_eo_pass_mrhs
    with pytest.raises(TypeError, match="float32"):
        fn(fh.bfloat16(), ft.bfloat16(), psi.bfloat16(), STAG_DIMS, 0, 1)
    with pytest.raises(ValueError, match="right-hand sides"):
        fn(fh, ft, psi[:0], STAG_DIMS, 0, 1)
    with pytest.raises(NotImplementedError, match="ROADMAP C"):
        fn(fh[:, :2].contiguous(), ft, psi, STAG_DIMS, 0, 1)


@pytest.mark.parametrize("dslash", ["hisq", "staggered"])
def test_staggered_invert_multi_src_on_card_matches_cpu(dslash):
    """invert_multi_src_quda, 3 sources at 8^4: the card (S2-mrhs only: 4
    launches per hisq iteration, 2 fat-only, plus prepare and
    reconstruct; no single-RHS hop) against the CPU's plain path,
    iterations within 2 per lane, solutions within 1e-4."""
    dev = require_cuda()
    dims = (8, 8, 8, 8)
    g = su3_gauge(dims, seed=75)
    B = gaussian((3,) + lattice_shape(dims) + (1, 3), seed=76)
    out = {}
    for where in (dev, "cpu"):
        qt.init_quda(device=where)
        try:
            qt.load_gauge_quda(g, qt.GaugeParam(X=dims, cuda_prec="single"))
            qt.compute_ks_link_quda()
            p = qt.InvertParam(dslash_type=dslash, inv_type="cg",
                               solve_type="direct-pc", mass=0.1, tol=1e-6,
                               maxiter=2000, cuda_prec="single")
            spl.reset_launches()
            x = qt.invert_multi_src_quda(B, p)
            counts = (spl.dslash_staggered_eo_pass_mrhs.launches,
                      spl.dslash_staggered_eo_pallas_fused.launches
                      + spl.dslash_staggered_eo_pass.launches)
        finally:
            qt.end_quda()
        out[str(where)] = (x.cpu().numpy(), p, counts)
    xg, pg, (mrhs, single) = out[str(dev)]
    xc, pc, _ = out["cpu"]
    assert pg.converged and pg.true_res <= 1e-5 and single == 0
    per_hop = 2 if dslash == "hisq" else 1
    assert mrhs == 2 * per_hop * (max(pg.iter_count_multi) + 1)
    assert all(abs(a - b) <= 2 for a, b in zip(pg.iter_count_multi,
                                               pc.iter_count_multi))
    assert np.linalg.norm(xg - xc) / np.linalg.norm(xc) < 1e-4


# -- the full-lattice hop (B4) and the double forms (B1, B2, B4 f64) --------

# (T, Z, Y, X), all four different
FULL_DIMS = (14, 12, 10, 8)
B4_FORMS = [(3, torch.float32), (2, torch.float32), (3, torch.float64)]


def _full_inputs(dev, rows, dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    T, Z, Y, X = FULL_DIMS
    sites = (T, Z, Y * X)
    u = torch.randn((4, rows, 3, 2) + sites, generator=gen, device=dev,
                    dtype=torch.float64).to(dtype)
    psi = torch.randn((4, 3, 2) + sites, generator=gen, device=dev,
                      dtype=torch.float64).to(dtype)
    return u, wpp.backward_gauge(u, X).contiguous(), psi


@pytest.mark.parametrize("tb_sign", [True, False],
                         ids=["antiperiodic", "periodic"])
@pytest.mark.parametrize("form", B4_FORMS,
                         ids=lambda f: wpp.form_name(f[0], f[1], f[1]))
def test_full_hop_kernel_matches_plain(form, tb_sign):
    """B4 on 14x12x10x8: f32 forms within TOLERANCE of the plain version,
    the f64 form within 1e-12 (its sums are float64); one launch."""
    dev = require_cuda()
    rows, dtype = form
    u, ubw, psi = _full_inputs(dev, rows, dtype, 80 + rows)
    name = wpp.form_name(rows, dtype, dtype)
    n0 = wpp.dslash_pallas_packed.launches_by_form.get(name, 0)
    got = wpp.dslash_pallas_packed(u, psi, FULL_DIMS[3], gauge_bw=ubw,
                                   tb_sign=tb_sign)
    want = wpp.dslash_packed_plain(u, ubw, psi, FULL_DIMS[3], tb_sign)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert wpp.dslash_pallas_packed.launches_by_form[name] == n0 + 1
    tol = 1e-12 if dtype == torch.float64 else wpp.TOLERANCE
    assert rel_err(got.cpu().numpy(), want.cpu().numpy()) < tol


@pytest.mark.parametrize("parity", [0, 1])
def test_eo_kernel_f64_matches_plain(parity):
    """B1's full:f64->f64 on 4x6x8x10 within 1e-12 of its plain version."""
    dev = require_cuda()
    dims = lattice_shape(ASYM)
    gen = torch.Generator(device=dev).manual_seed(84 + parity)
    sites = pair_spinor_shape(ASYM)[3:]
    f64 = torch.float64
    psi = torch.randn((4, 3, 2) + sites, generator=gen, device=dev, dtype=f64)
    u_here = torch.randn((4, 3, 3, 2) + sites, generator=gen, device=dev,
                         dtype=f64)
    u_bw = wpp.backward_gauge_eo(
        torch.randn((4, 3, 3, 2) + sites, generator=gen, device=dev,
                    dtype=f64), dims, parity).contiguous()
    n0 = wpp.dslash_eo_pallas_packed.launches_by_form.get("full:f64->f64", 0)
    got = wpp.dslash_eo_pallas_packed(u_here, u_bw, psi, dims, parity)
    want = wpp.dslash_eo_packed_plain(u_here, u_bw, psi, dims, parity)
    torch.cuda.synchronize()
    assert got.dtype == f64
    assert wpp.dslash_eo_pallas_packed.launches_by_form["full:f64->f64"] == \
        n0 + 1
    assert rel_err(got.cpu().numpy(), want.cpu().numpy()) < 1e-12


def test_cg_tail_kernel_f64_matches_plain():
    dev = require_cuda()
    tin = [torch.from_numpy(gaussian(pair_spinor_shape(SMALL), seed=86 + i,
                                     dtype=np.float64)).to(dev)
           for i in range(4)]
    alpha = torch.tensor(0.37, dtype=torch.float64, device=dev)
    n0 = bpl.cg_update_norm2_pallas.launches_by_form.get("f64", 0)
    kx, kr, kr2 = bpl.cg_update_norm2_pallas(alpha, *tin)
    px, pr, pr2 = blas.triple_cg_update(alpha, *tin)
    torch.cuda.synchronize()
    assert kr2.dtype == torch.float64
    assert bpl.cg_update_norm2_pallas.launches_by_form["f64"] == n0 + 1
    assert rel_err(kx.cpu().numpy(), px.cpu().numpy()) < 1e-14
    assert rel_err(kr.cpu().numpy(), pr.cpu().numpy()) < 1e-14
    assert abs(float(kr2) - float(pr2)) <= 1e-12 * float(pr2)


@pytest.mark.parametrize("prec", ["single", "double"])
def test_operator_api_on_card_matches_cpu(prec):
    """dslash_quda (B1), mat_quda (B4, one launch) and mat_dag_mat_quda
    (B4, two launches) at 4x4x4x8 on the card against the CPU: 1e-6 in
    single, 1e-12 in double."""
    dev = require_cuda()
    dims = SMALL
    g = su3_gauge(dims, seed=88, dtype=np.complex128)
    psi = gaussian(lattice_shape(dims) + (4, 3), seed=89,
                   dtype=np.complex128)
    half = psi[:, :, :, : dims[0] // 2]
    out = {}
    for where in (dev, "cpu"):
        qt.init_quda(device=where)
        try:
            qt.load_gauge_quda(g, qt.GaugeParam(X=dims, cuda_prec=prec))
            p = qt.InvertParam(dslash_type="wilson", kappa=0.12,
                               cuda_prec=prec)
            wpp.reset_launches()
            res = [qt.dslash_quda(half, p, 1), qt.mat_quda(psi, p),
                   qt.mat_dag_mat_quda(psi, p)]
            n4 = wpp.dslash_pallas_packed.launches
        finally:
            qt.end_quda()
        out[str(where)] = ([r.cpu().numpy() for r in res], n4)
    (got, n4), (want, _) = out[str(dev)], out["cpu"]
    assert n4 == 3
    tol = 1e-6 if prec == "single" else 1e-12
    for a, b in zip(got, want):
        assert rel_err(a, b) < tol


@pytest.mark.parametrize("sloppy", ["double", "single"])
def test_double_invert_on_card(sloppy):
    """invert_quda(double) at 4x4x4x8, tol 1e-10: converged, true_res <=
    1e-10, against the CPU's plain path within 1e-9; double/double on B1
    and B2 in f64, double/single on B1 f32 with B1 f64 at the reliable
    updates."""
    dev = require_cuda()
    g = su3_gauge(SMALL, seed=90, dtype=np.complex128)
    b = gaussian(lattice_shape(SMALL) + (4, 3), seed=91, dtype=np.complex128)
    out = {}
    for where in (dev, "cpu"):
        qt.init_quda(device=where)
        try:
            qt.load_gauge_quda(g, qt.GaugeParam(X=SMALL, cuda_prec="double"))
            p = qt.InvertParam(dslash_type="wilson", inv_type="cg",
                               solve_type="normop-pc", kappa=0.12, tol=1e-10,
                               maxiter=1000, cuda_prec="double",
                               cuda_prec_sloppy=sloppy)
            wpp.reset_launches()
            bpl.cg_update_norm2_pallas.launches_by_form = {}
            x = qt.invert_quda(b, p)
            by = (dict(wpp.dslash_eo_pallas_packed.launches_by_form),
                  dict(bpl.cg_update_norm2_pallas.launches_by_form))
        finally:
            qt.end_quda()
        out[str(where)] = (x.cpu().numpy(), p, by)
    xg, pg, (hops, tails) = out[str(dev)]
    xc, pc, _ = out["cpu"]
    assert pg.converged and pg.true_res <= 1e-10
    assert np.linalg.norm(xg - xc) / np.linalg.norm(xc) < 1e-9
    if sloppy == "double":
        assert hops.get("full:f64->f64", 0) >= 4 * pg.iter_count
        assert tails.get("f64", 0) == pg.iter_count
    else:
        assert hops.get("full:f32->f32", 0) >= 4 * pg.iter_count
        assert hops.get("full:f64->f64", 0) >= 4 * pg.reliable_updates


# -- the twist epilogues of the fused hop (K1/K2 and K1/K2-mrhs) -----------

# (kernel, epilogue): K1 block-free twist (twisted mass); K2 block-free
# twist (twisted mass) and blocks + twist (twisted clover)
TWIST_EPILOGUES = [("post", "twist"), ("diag_hop", "twist"),
                   ("diag_hop", "blk+twist")]
TW_A = 0.0288                       # a = 2 kappa mu at kappa 0.12, mu 0.12


def _twist_inputs(dev, rows, store, parity, seed, n=None):
    """4x6x8x10 links, psi and x (an n-RHS batch when n is given) and
    blocks 1 + 0.1 Gaussian, in the storage dtype."""
    dims = lattice_shape(ASYM)
    gen = torch.Generator(device=dev).manual_seed(seed)
    sites = pair_spinor_shape(ASYM)[3:]

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    lead = () if n is None else (n,)
    psi, xc = (randn(*lead, 4, 3, 2, *sites).to(store) for _ in range(2))
    u_here = randn(4, rows, 3, 2, *sites).to(store)
    u_bw = wpp.backward_gauge_eo(randn(4, rows, 3, 2, *sites), dims,
                                 parity).to(store).contiguous()
    blk = 0.1 * randn(2, 6, 6, 2, *sites)
    blk[:, :, :, 0] += torch.eye(6, device=dev).reshape(1, 6, 6, 1, 1, 1)
    return dims, u_here, u_bw, psi, xc, blk.to(store)


def _twist_call(kind, epi, args, parity, how="kernel", mrhs=False):
    """One call of a twist form: the kernel, its plain version, or (mrhs)
    the batch through single-RHS kernel launches; sign s = -1's
    parameters, as an Mdag apply passes them."""
    dims, u_here, u_bw, psi, xc, blk = args
    b = blk if epi == "blk+twist" else None
    if how == "single":
        return torch.stack([_twist_call(kind, epi, (dims, u_here, u_bw,
                                                    psi[r], xc[r], blk),
                                        parity) for r in range(len(psi))])
    if kind == "post":
        tw = (TW_A, 1.0 / (1.0 + TW_A ** 2))
        if how == "plain":
            fn = (clp.dslash_eo_post_mrhs_plain if mrhs
                  else clp.dslash_eo_post_plain)
            return fn(u_here, u_bw, psi, None, dims, parity, twist=tw)
        fn = (clp.dslash_eo_pallas_post_mrhs if mrhs
              else clp.dslash_eo_pallas_post)
        return fn(u_here, u_bw, psi, dims, parity, twist=tw)
    if how == "plain":
        fn = (clp.dslash_eo_diag_hop_mrhs_plain if mrhs
              else clp.dslash_eo_diag_hop_plain)
        return fn(u_here, u_bw, psi, xc, b, dims, parity, -0.0144,
                  torch.float32, diag_twist=-TW_A)
    fn = (clp.dslash_eo_pallas_diag_hop_mrhs if mrhs
          else clp.dslash_eo_pallas_diag_hop)
    return fn(u_here, u_bw, psi, xc, dims, parity, hop_coeff=-0.0144,
              blk_pl=b, diag_twist=-TW_A, out_dtype=torch.float32)


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("store", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("rows", [3, 2], ids=["full", "r12"])
@pytest.mark.parametrize("kind,epi", TWIST_EPILOGUES,
                         ids=[f"{k}:{e}" for k, e in TWIST_EPILOGUES])
def test_twist_kernel_forms_match_plain(kind, epi, rows, store, parity):
    """Every twist form of K1/K2 on 4x6x8x10 against its plain version:
    f32 output within TOLERANCE, bf16 within TOLERANCE_BF16 (one bf16
    ulp of max |plain|); the launch counted under its epilogue's form."""
    dev = require_cuda()
    args = _twist_inputs(dev, rows, store, parity, seed=61 + parity)
    out = clp.out_dtype_of(kind, store)
    wrapper = (clp.dslash_eo_pallas_post if kind == "post"
               else clp.dslash_eo_pallas_diag_hop)
    name = wpp.form_name(rows, store, out) + f":{epi}"
    n0 = wrapper.launches_by_form.get(name, 0)
    got = _twist_call(kind, epi, args, parity)
    want = _twist_call(kind, epi, args, parity, "plain")
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == out
    assert wrapper.launches_by_form[name] == n0 + 1
    tol = clp.TOLERANCE if out == torch.float32 else clp.TOLERANCE_BF16
    assert rel_err(got.float().cpu().numpy(), want.float().cpu().numpy()) \
        <= tol


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("rows", [3, 2], ids=["full", "r12"])
@pytest.mark.parametrize("kind,epi", TWIST_EPILOGUES,
                         ids=[f"{k}:{e}" for k, e in TWIST_EPILOGUES])
def test_twist_mrhs_kernels_match_plain_and_single_launches(kind, epi, rows,
                                                            parity):
    """K1/K2-mrhs twist forms over 3 right-hand sides: within TOLERANCE of
    the plain version, and the same bits as 3 single-RHS launches."""
    dev = require_cuda()
    args = _twist_inputs(dev, rows, torch.float32, parity, seed=67 + parity,
                         n=3)
    got = _twist_call(kind, epi, args, parity, mrhs=True)
    want = _twist_call(kind, epi, args, parity, "plain", mrhs=True)
    single = _twist_call(kind, epi, args, parity, "single")
    torch.cuda.synchronize()
    assert got.shape == args[3].shape
    assert rel_err(got.cpu().numpy(), want.cpu().numpy()) <= clp.TOLERANCE
    assert torch.equal(got, single)


@pytest.mark.parametrize("matpc", [0, 1])
def test_dw5d_strided_groups_on_card(matpc):
    """The 5d-checkerboard operator hops the slices x[r::2] of each 5d
    parity, strided views: B5-eo refuses them as they are, and the
    operator makes them contiguous, two launches per 4d hop, so M and
    Mdag on the card agree with the CPU's plain path (1e-5) at both
    matpc parities."""
    from quda_tpu_torch.fields.geometry import LatticeGeometry
    from quda_tpu_torch.models.domain_wall import DiracDomainWall5DPC
    from quda_tpu_torch.ops import dwf_pallas as dwp
    dev = require_cuda()
    ls = 6
    g = torch.from_numpy(su3_gauge(ASYM, seed=71))
    x = torch.from_numpy(gaussian((ls,) + pair_spinor_shape(ASYM), seed=72,
                                  dtype=np.float32))
    ops = {d: DiracDomainWall5DPC(g.to(d), LatticeGeometry(ASYM), ls, 1.8,
                                  0.1, matpc=matpc).pairs(torch.float32)
           for d in ("cpu", dev)}
    op = ops[dev]
    with pytest.raises(ValueError, match="contiguous"):
        dwp.dslash_eo_pallas_packed_ls(op.gauge_eo_pp[0], op._u_bw[0],
                                       x.to(dev)[0::2], op.dims, 0)
    wpp.reset_launches()
    for fn in ("M_pairs", "Mdag_pairs"):
        got = getattr(op, fn)(x.to(dev))
        want = getattr(ops["cpu"], fn)(x)
        torch.cuda.synchronize()
        assert rel_err(got.cpu().numpy(), want.numpy()) < 1e-5
    assert wpp.dslash_eo_pallas_packed_mrhs.launches == 2 * 2 * 2
    assert wpp.dslash_eo_pallas_packed.launches == 0


@pytest.mark.parametrize("dslash", ["twisted-mass", "twisted-clover",
                                    "mobius"])
def test_zoo_invert_on_card_matches_cpu(dslash):
    """invert_quda on 4^3x8 SU(3) links: the card (K1/K2 twist forms, or
    B5-eo with N = Ls for Möbius, and no single-RHS hop in the Möbius
    solve) against the CPU's plain path, iterations within 2, solutions
    within 1e-4."""
    dev = require_cuda()
    g = su3_gauge(SMALL, seed=73)
    kw = dict(dslash_type=dslash, mu=0.12)
    shape = lattice_shape(SMALL) + (4, 3)
    if dslash == "twisted-clover":
        kw["csw"] = 1.0
    if dslash == "mobius":
        kw = dict(dslash_type=dslash, mass=0.1, Ls=6)
        shape = (6,) + shape
    b = gaussian(shape, seed=74)
    wpp.reset_launches()
    clp.reset_launches()
    xg, pg = _solve(g, b, dev, **kw)
    if dslash == "mobius":
        assert wpp.dslash_eo_pallas_packed_mrhs.launches >= 4 * pg.iter_count
        assert wpp.dslash_eo_pallas_packed.launches == 0
    else:
        assert clp.dslash_eo_pallas_post.launches >= 2 * pg.iter_count
        assert clp.dslash_eo_pallas_diag_hop.launches >= 2 * pg.iter_count
    xc, pc = _solve(g, b, "cpu", **kw)
    assert pg.converged and pg.true_res <= 1e-5
    assert abs(pg.iter_count - pc.iter_count) <= 2
    assert np.linalg.norm(xg - xc) / np.linalg.norm(xc) < 1e-4


# -- multigrid: B5 (the multi-RHS full-lattice hop) and B8 (the coarse
# stencil) ------------------------------------------------------------------

@pytest.mark.parametrize("tb_sign", [True, False],
                         ids=["antiperiodic", "periodic"])
@pytest.mark.parametrize("n", [1, 3, 12])
@pytest.mark.parametrize("chunk", list(wpp.MRHS_CHUNKS))
@pytest.mark.parametrize("rows", [3, 2], ids=["full", "r12"])
def test_full_hop_mrhs_kernel_matches_plain_and_b4(rows, chunk, n, tb_sign):
    """B5 on 14x12x10x8 (T, Z, Y, X): within TOLERANCE of its plain
    version, and each lane bit for bit a B4 launch (one hop body); one
    launch counted."""
    dev = require_cuda()
    T, Z, Y, X = 8, 10, 12, 14
    gen = torch.Generator(device=dev).manual_seed(81 + rows + n)
    sites = (T, Z, Y * X)
    u = torch.randn((4, rows, 3, 2) + sites, generator=gen, device=dev)
    ubw = wpp.backward_gauge(u, X).contiguous()
    psi = torch.randn((n, 4, 3, 2) + sites, generator=gen, device=dev)
    n0 = wpp.dslash_pallas_packed_mrhs.launches
    got = wpp.dslash_pallas_packed_mrhs(u, psi, X, gauge_bw=ubw,
                                        tb_sign=tb_sign, chunk=chunk)
    assert wpp.dslash_pallas_packed_mrhs.launches == n0 + 1
    want = wpp.dslash_packed_mrhs_plain(u, ubw, psi, X, tb_sign)
    lanes = torch.stack([wpp.dslash_pallas_packed(
        u, psi[i].contiguous(), X, gauge_bw=ubw, tb_sign=tb_sign)
        for i in range(n)])
    torch.cuda.synchronize()
    assert got.shape == psi.shape and got.dtype == torch.float32
    assert rel_err(got.cpu().numpy(), want.cpu().numpy()) <= wpp.TOLERANCE
    assert torch.equal(got, lanes)


@pytest.mark.parametrize("e", [8, 16, 20, 48, 96, 160])
@pytest.mark.parametrize("sites", [7, 64, 512, 2048, 8192])
def test_coarse_kernel_matches_plain(e, sites):
    """B8 at E = 8 .. 160 (20 is not a multiple of 8 or 32) and 7 .. 8192
    sites: a block an item (a site's tile of link rows; at E 160 a site's
    last tile is partial) streaming its 9 link blocks through a ring of
    shared-memory stages; within TOLERANCE (1e-5 relative) of the einsum;
    one launch counted."""
    dev = require_cuda()
    gen = torch.Generator(device=dev).manual_seed(91 + e + sites)
    links = torch.randn((9, sites, e, e), generator=gen, device=dev)
    psi9 = torch.randn((9, sites, e), generator=gen, device=dev)
    n0 = cop.coarse_apply_pallas.launches
    got = cop.coarse_apply_pallas(links, psi9)
    assert cop.coarse_apply_pallas.launches == n0 + 1
    want = cop.coarse_apply_ref(links, psi9)
    torch.cuda.synchronize()
    assert got.shape == (sites, e) and got.dtype == torch.float32
    assert rel_err(got.cpu().numpy(), want.cpu().numpy()) <= cop.TOLERANCE


@pytest.mark.parametrize("e", [1, 5, 8, 16, 20, 48, 96, 160])
@pytest.mark.parametrize("sites", [7, 512])
def test_coarse_kernel_unaligned_views_match_plain(e, sites):
    """B8 on its 4-byte copies: links and psi9 as views starting one float
    past a 16-byte boundary, and E not a multiple of 4 (1, 5): within
    TOLERANCE of the einsum; the launch counted under its (S, E)."""
    dev = require_cuda()
    gen = torch.Generator(device=dev).manual_seed(181 + e + sites)
    lbuf = torch.randn(9 * sites * e * e + 1, generator=gen, device=dev)
    pbuf = torch.randn(9 * sites * e + 1, generator=gen, device=dev)
    links = lbuf[1:].view(9, sites, e, e)
    psi9 = pbuf[1:].view(9, sites, e)
    key = f"{sites}x{e}"
    n0 = cop.coarse_apply_pallas.launches_by_shape.get(key, 0)
    got = cop.coarse_apply_pallas(links, psi9)
    assert cop.coarse_apply_pallas.launches_by_shape[key] == n0 + 1
    want = cop.coarse_apply_ref(links, psi9)
    torch.cuda.synchronize()
    assert rel_err(got.cpu().numpy(), want.cpu().numpy()) <= cop.TOLERANCE


@pytest.mark.parametrize("sites,e,vec4", [(512, 96, True), (8192, 96, True),
                                          (7, 16, True), (33, 160, True),
                                          (512, 96, False), (5, 1024, True),
                                          (3, 7, False)])
def test_coarse_kernel_resources_match_plan(sites, e, vec4):
    """B8's query entry: the shared memory, link rows a tile, lanes a row
    and grid (one block an item) of coarse_plan; at the multigrid's E 96
    COARSE_MIN_BLOCKS blocks an SM; at most 255 registers."""
    require_cuda()
    info = cop.coarse_info(sites, e, vec4)
    plan = cop.coarse_plan(sites, e, vec4)
    assert info["smem_bytes"] == plan["smem"] <= clp.SMEM_PER_BLOCK
    assert (info["rows"], info["lanes"], info["grid"]) == (
        plan["rows"], plan["lanes"], plan["items"])
    assert 0 < info["registers"] <= 255 and info["blocks_per_sm"] >= 1
    if e == 96 and vec4:
        assert info["blocks_per_sm"] >= cop.COARSE_MIN_BLOCKS


@pytest.mark.parametrize("e", [16, 20, 96])
@pytest.mark.parametrize("n", [1, 3, 8, 24])
def test_coarse_mrhs_kernel_matches_plain_and_single(n, e):
    """B8's multi-RHS form at N = 1 .. 24 (tail chunks at 3 and 24 mod 8 =
    0 both) within TOLERANCE of its plain version and of N single
    launches; one launch counted."""
    dev = require_cuda()
    gen = torch.Generator(device=dev).manual_seed(93 + n + e)
    links = torch.randn((9, 33, e, e), generator=gen, device=dev)
    psi9 = torch.randn((n, 9, 33, e), generator=gen, device=dev)
    n0 = cop.coarse_apply_pallas_mrhs.launches
    got = cop.coarse_apply_pallas_mrhs(links, psi9)
    assert cop.coarse_apply_pallas_mrhs.launches == n0 + 1
    want = cop.coarse_apply_mrhs_ref(links, psi9)
    single = torch.stack([cop.coarse_apply_pallas(links, psi9[i])
                          for i in range(n)])
    torch.cuda.synchronize()
    assert got.shape == (n, 33, e)
    g = got.cpu().numpy()
    assert rel_err(g, want.cpu().numpy()) <= cop.TOLERANCE
    assert rel_err(g, single.cpu().numpy()) <= cop.TOLERANCE


# (T, Z, Y, X) of the redesigned B5's tile edges: Y*X = 168 leaves a
# partial tile of 40 sites on each plane and Z = 5 a partial z-box; Y*X =
# 35 takes the 4-byte copies (Y*X not a multiple of 4); Y*X = 272 ends
# each plane in a tile of 16 sites, with T = 2 (a t neighbour both ways)
B5_TILE_EXTENTS = [(6, 5, 12, 14), (4, 3, 5, 7), (2, 3, 4, 68)]


@pytest.mark.parametrize("n", [1, 2, 3, 13, 24])
@pytest.mark.parametrize("chunk", list(wpp.MRHS_CHUNKS))
@pytest.mark.parametrize("rows", [3, 2], ids=["full", "r12"])
@pytest.mark.parametrize("extents", B5_TILE_EXTENTS,
                         ids=lambda e: "x".join(map(str, e)))
def test_full_hop_mrhs_tiles_match_b4(extents, rows, chunk, n):
    """B5 on lattices whose planes end in partial tiles (and a lattice
    that takes the 4-byte copies): each lane bit for bit a B4 launch,
    within TOLERANCE of the plain version; one launch counted."""
    dev = require_cuda()
    T, Z, Y, X = extents
    gen = torch.Generator(device=dev).manual_seed(141 + rows + n + X)
    sites = (T, Z, Y * X)
    u = torch.randn((4, rows, 3, 2) + sites, generator=gen, device=dev)
    ubw = wpp.backward_gauge(u, X).contiguous()
    psi = torch.randn((n, 4, 3, 2) + sites, generator=gen, device=dev)
    n0 = wpp.dslash_pallas_packed_mrhs.launches
    got = wpp.dslash_pallas_packed_mrhs(u, psi, X, gauge_bw=ubw, chunk=chunk)
    assert wpp.dslash_pallas_packed_mrhs.launches == n0 + 1
    lanes = torch.stack([wpp.dslash_pallas_packed(
        u, psi[i].contiguous(), X, gauge_bw=ubw) for i in range(n)])
    want = wpp.dslash_packed_mrhs_plain(u, ubw, psi, X)
    torch.cuda.synchronize()
    assert torch.equal(got, lanes)
    assert rel_err(got.cpu().numpy(), want.cpu().numpy()) <= wpp.TOLERANCE


@pytest.mark.parametrize("chunk", list(wpp.MRHS_CHUNKS))
@pytest.mark.parametrize("rows", [3, 2], ids=["full", "r12"])
def test_full_hop_mrhs_resources_match_plan(rows, chunk):
    """B5's query entry at 32^3 x 64: the shared memory, threads, tiles
    and blocks of full_mrhs_plan; two blocks an SM at chunk 1, at least
    one at chunk 2."""
    require_cuda()
    T, Z, Y, X = 64, 32, 32, 32
    info = wpp.full_mrhs_info(rows, chunk, T, Z, Y, X)
    plan = wpp.full_mrhs_plan(rows, T, Z, Y, X)
    assert info["smem_bytes"] == plan["smem"]
    assert (info["threads"], info["tiles"], info["blocks"]) == (
        plan["threads"], plan["tiles"], plan["blocks"])
    assert 0 < info["registers"] <= 255
    assert info["blocks_per_sm"] >= (2 if chunk == 1 else 1)


# (T, Z, Y, X) of the redesigned B5-eo's tile edges: Y*Xh = 168 leaves a
# partial tile of 40 half-sites on each plane and Z = 6 a partial z-box;
# Y*Xh = 30 takes the 4-byte copies (Y*Xh not a multiple of 4); Y*Xh = 272
# ends each plane in a tile of 16 half-sites, with T = 2 (a t neighbour
# both ways)
B5EO_TILE_EXTENTS = [(6, 6, 12, 28), (4, 2, 6, 10), (2, 4, 4, 136)]


@pytest.mark.parametrize("n", [1, 5, 6, 12, 13])
@pytest.mark.parametrize("chunk", list(wpp.MRHS_CHUNKS))
@pytest.mark.parametrize("tb_sign", [True, False],
                         ids=["antiperiodic", "periodic"])
@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("rows", [3, 2], ids=["full", "r12"])
@pytest.mark.parametrize("extents", B5EO_TILE_EXTENTS,
                         ids=lambda e: "x".join(map(str, e)))
def test_eo_mrhs_tiles_match_b1(extents, rows, parity, tb_sign, chunk, n):
    """B5-eo on half lattices whose planes end in partial tiles (and one
    that takes the 4-byte copies): each lane bit for bit a B1 launch,
    within TOLERANCE of the plain version; one launch counted."""
    dev = require_cuda()
    T, Z, Y, X = extents
    gen = torch.Generator(device=dev).manual_seed(611 + rows + n + X)
    sites = (T, Z, Y * X // 2)
    u = torch.randn((4, rows, 3, 2) + sites, generator=gen, device=dev)
    ubw = wpp.backward_gauge_eo(
        torch.randn((4, rows, 3, 2) + sites, generator=gen, device=dev),
        extents, parity).contiguous()
    psi = torch.randn((n, 4, 3, 2) + sites, generator=gen, device=dev)
    n0 = wpp.dslash_eo_pallas_packed_mrhs.launches
    got = wpp.dslash_eo_pallas_packed_mrhs(u, ubw, psi, extents, parity,
                                           tb_sign=tb_sign, chunk=chunk)
    assert wpp.dslash_eo_pallas_packed_mrhs.launches == n0 + 1
    lanes = torch.stack([wpp.dslash_eo_pallas_packed(
        u, ubw, psi[i].contiguous(), extents, parity, tb_sign=tb_sign)
        for i in range(n)])
    want = wpp.dslash_eo_packed_mrhs_plain(u, ubw, psi, extents, parity,
                                           tb_sign=tb_sign)
    torch.cuda.synchronize()
    assert torch.equal(got, lanes)
    assert rel_err(got.cpu().numpy(), want.cpu().numpy()) <= wpp.TOLERANCE


@pytest.mark.parametrize("chunk", list(wpp.MRHS_CHUNKS))
@pytest.mark.parametrize("rows", [3, 2], ids=["full", "r12"])
def test_eo_mrhs_resources_match_plan(rows, chunk):
    """B5-eo's query entry at 32^3 x 64: the shared memory, threads, tiles
    and blocks of eo_mrhs_plan; EO_MRHS_MIN_BLOCKS blocks an SM at chunk
    1, at least one at chunk 2; at most 255 registers."""
    require_cuda()
    T, Z, Y, Xh = 64, 32, 32, 16
    info = wpp.eo_mrhs_info(rows, chunk, T, Z, Y, Xh)
    plan = wpp.eo_mrhs_plan(rows, T, Z, Y, Xh)
    assert info["smem_bytes"] == plan["smem"]
    assert (info["threads"], info["tiles"], info["blocks"]) == (
        plan["threads"], plan["tiles"], plan["blocks"])
    assert 0 < info["registers"] <= 255
    assert info["blocks_per_sm"] >= (wpp.EO_MRHS_MIN_BLOCKS if chunk == 1
                                     else 1)


# The redesigned K1/K2-mrhs: its ten instances as (kernel, epilogue) x R.
# (T, Z, Y, X): 4x6x8x10 (a plane of 12 half-sites, one partial tile);
# Y*Xh = 168 ends each plane in a partial tile of 40 half-sites, with a
# partial z-box; Y*Xh = 15 is odd and takes the 4-byte copies
K_MRHS_EPILOGUES = [("post", "clover"), ("diag_hop", "clover"),
                    ("post", "twist"), ("diag_hop", "twist"),
                    ("diag_hop", "blk+twist")]
K_MRHS_TILE_EXTENTS = [(10, 8, 6, 4), (6, 6, 12, 28), (4, 6, 5, 6)]


def _k_mrhs_call(kind, epi, args, parity, plain=False):
    """One K1/K2-mrhs call (kernel or plain) of a form, or K1/K2 when psi
    holds one right-hand side; an Mdag apply's twist signs."""
    dims, u_here, u_bw, psi, xc, blk = args
    b = blk if epi != "twist" else None
    mrhs = psi.ndim == 7
    if kind == "post":
        tw = (TW_A, 1.0 / (1.0 + TW_A ** 2)) if epi == "twist" else None
        if plain:
            return clp.dslash_eo_post_mrhs_plain(u_here, u_bw, psi, b, dims,
                                                 parity, twist=tw)
        fn = (clp.dslash_eo_pallas_post_mrhs if mrhs
              else clp.dslash_eo_pallas_post)
        return fn(u_here, u_bw, psi, dims, parity, blk_pl=b, twist=tw)
    tw = -TW_A if epi != "clover" else None
    if plain:
        return clp.dslash_eo_diag_hop_mrhs_plain(
            u_here, u_bw, psi, xc, b, dims, parity, -0.0144, torch.float32,
            diag_twist=tw)
    fn = (clp.dslash_eo_pallas_diag_hop_mrhs if mrhs
          else clp.dslash_eo_pallas_diag_hop)
    return fn(u_here, u_bw, psi, xc, dims, parity, hop_coeff=-0.0144,
              blk_pl=b, diag_twist=tw, out_dtype=torch.float32)


@pytest.mark.parametrize("n", [1, 3, 5, 12])
@pytest.mark.parametrize("rows", [3, 2], ids=["full", "r12"])
@pytest.mark.parametrize("kind,epi", K_MRHS_EPILOGUES,
                         ids=[f"{k}:{e}" for k, e in K_MRHS_EPILOGUES])
@pytest.mark.parametrize("extents", K_MRHS_TILE_EXTENTS,
                         ids=lambda e: "x".join(map(str, e)))
def test_k_mrhs_tiles_match_k1_k2(extents, kind, epi, rows, n):
    """Every K1/K2-mrhs instance at both target parities, with tail and
    empty lanes (N = 1, 3, 5, 12), on half
    lattices whose planes end in partial tiles (one of them odd: the
    4-byte copies): each lane bit for bit a K1 or K2 launch, within
    TOLERANCE of the plain version; one launch counted a call under its
    form."""
    dev = require_cuda()
    T, Z, Y, X = extents
    sites = (T, Z, Y * X // 2)
    wrapper = (clp.dslash_eo_pallas_post_mrhs if kind == "post"
               else clp.dslash_eo_pallas_diag_hop_mrhs)
    name = (wpp.form_name(rows, torch.float32, torch.float32)
            + clp.epilogue_name(epi != "twist", epi != "clover"))
    for parity in (0, 1):
        gen = torch.Generator(device=dev).manual_seed(
            701 + 10 * rows + n + X + parity)

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)

        u_here = randn(4, rows, 3, 2, *sites)
        u_bw = wpp.backward_gauge_eo(randn(4, rows, 3, 2, *sites), extents,
                                     parity).contiguous()
        psi, xc = randn(n, 4, 3, 2, *sites), randn(n, 4, 3, 2, *sites)
        blk = 0.1 * randn(2, 6, 6, 2, *sites)
        blk[:, :, :, 0] += torch.eye(6, device=dev).reshape(1, 6, 6, 1, 1, 1)
        args = (extents, u_here, u_bw, psi, xc, blk)
        n0 = wrapper.launches_by_form.get(name, 0)
        got = _k_mrhs_call(kind, epi, args, parity)
        assert wrapper.launches_by_form[name] == n0 + 1
        lanes = torch.stack([_k_mrhs_call(
            kind, epi, (extents, u_here, u_bw, psi[r], xc[r], blk), parity)
            for r in range(n)])
        want = _k_mrhs_call(kind, epi, args, parity, plain=True)
        torch.cuda.synchronize()
        assert got.shape == psi.shape and got.dtype == torch.float32
        assert torch.equal(got, lanes)
        assert rel_err(got.cpu().numpy(), want.cpu().numpy()) <= \
            clp.TOLERANCE


@pytest.mark.parametrize("rows", [3, 2], ids=["full", "r12"])
@pytest.mark.parametrize("kind,epi", K_MRHS_EPILOGUES,
                         ids=[f"{k}:{e}" for k, e in K_MRHS_EPILOGUES])
def test_k_mrhs_resources_match_plan(kind, epi, rows):
    """K1/K2-mrhs's query entry at 32^3 x 64 for each instance: the
    shared memory, threads, tiles and blocks of k_mrhs_plan, at most 227
    KB a block; K_MRHS_MIN_BLOCKS blocks an SM; at most 255 registers."""
    require_cuda()
    T, Z, Y, Xh = 64, 32, 32, 16
    with_blk = epi != "twist"
    info = clp.k_mrhs_info(kind, rows, T, Z, Y, Xh, with_blk,
                           epi != "clover")
    plan = clp.k_mrhs_plan(rows, with_blk, T, Z, Y, Xh)
    assert info["smem_bytes"] == plan["smem"] <= clp.SMEM_PER_BLOCK
    assert (info["threads"], info["tiles"], info["blocks"]) == (
        plan["threads"], plan["tiles"], plan["blocks"])
    assert 0 < info["registers"] <= 255
    assert info["blocks_per_sm"] >= clp.K_MRHS_MIN_BLOCKS


@pytest.mark.parametrize("sites", [1, 33, 2048])
@pytest.mark.parametrize("e", [8, 16, 20, 96, 160])
@pytest.mark.parametrize("n", [1, 3, 8, 24, 25, 40])
def test_coarse_mrhs_gemm_matches_plain_and_single(n, e, sites):
    """The redesigned B8-mrhs at N = 1 .. 40, E = 8 .. 160 and 1 .. 2048
    sites: within TOLERANCE of its plain version and of N single
    launches, one launch counted.  (E, N) = (160, 40) exceeds N_max(160)
    = 36, so the links are read in two chunks."""
    dev = require_cuda()
    gen = torch.Generator(device=dev).manual_seed(151 + n + e + sites)
    links = torch.randn((9, sites, e, e), generator=gen, device=dev)
    psi9 = torch.randn((n, 9, sites, e), generator=gen, device=dev)
    n0 = cop.coarse_apply_pallas_mrhs.launches
    got = cop.coarse_apply_pallas_mrhs(links, psi9)
    assert cop.coarse_apply_pallas_mrhs.launches == n0 + 1
    want = cop.coarse_apply_mrhs_ref(links, psi9)
    single = torch.stack([cop.coarse_apply_pallas(links, psi9[i])
                          for i in range(n)])
    torch.cuda.synchronize()
    assert got.shape == (n, sites, e)
    g = got.cpu().numpy()
    assert rel_err(g, want.cpu().numpy()) <= cop.TOLERANCE
    assert rel_err(g, single.cpu().numpy()) <= cop.TOLERANCE
    if (e, n) == (160, 40):
        assert cop.mrhs_plan(e, n)["chunks"] == 2


@pytest.mark.parametrize("e", [1, 5, 7, 33, 96])
def test_coarse_mrhs_unaligned_inputs_match_plain(e):
    """B8-mrhs where the 16-byte copies do not apply: E not a multiple of
    4, or links and psi9 starting 4 bytes past a 16-byte boundary (views
    one float into larger buffers): within TOLERANCE of the plain
    version."""
    dev = require_cuda()
    gen = torch.Generator(device=dev).manual_seed(171 + e)
    n, sites = 10, 65
    lbuf = torch.randn(9 * sites * e * e + 1, generator=gen, device=dev)
    pbuf = torch.randn(n * 9 * sites * e + 1, generator=gen, device=dev)
    links = lbuf[1:].view(9, sites, e, e)
    psi9 = pbuf[1:].view(n, 9, sites, e)
    got = cop.coarse_apply_pallas_mrhs(links, psi9)
    want = cop.coarse_apply_mrhs_ref(links, psi9)
    torch.cuda.synchronize()
    assert rel_err(got.cpu().numpy(), want.cpu().numpy()) <= cop.TOLERANCE


@pytest.mark.parametrize("e,n", [(96, 24), (160, 40), (20, 3), (7, 5)])
def test_coarse_mrhs_resources_match_plan(e, n):
    """B8-mrhs's query entry: threads, right-hand sides a chunk, chunks
    and shared memory as mrhs_plan makes them; at least one block an
    SM."""
    require_cuda()
    plan = cop.mrhs_plan(e, n)
    info = cop.mrhs_info(e, n, vec4=e % 4 == 0)
    assert info["smem_bytes"] == plan["smem"]
    assert (info["threads"], info["nc"], info["chunks"]) == (
        plan["threads"], plan["nc"], plan["chunks"])
    assert 0 < info["registers"] <= 255 and info["blocks_per_sm"] >= 1


def test_mg_kernels_refuse_what_they_lack():
    """B5 without a float32 batch or a valid chunk, and B8 with float64
    links, an E above MAX_E or mismatched shapes, raise; nothing
    launches."""
    dev = require_cuda()
    sites = (4, 2, 2 * 4)
    u = torch.zeros((4, 3, 3, 2) + sites, device=dev)
    psi = torch.zeros((2, 4, 3, 2) + sites, device=dev)
    n5 = wpp.dslash_pallas_packed_mrhs.launches
    n8 = cop.coarse_apply_pallas.launches
    with pytest.raises(TypeError, match="float32"):
        wpp.dslash_pallas_packed_mrhs(u.double(), psi.double(), 4,
                                      gauge_bw=u.double())
    with pytest.raises(ValueError, match="chunk"):
        wpp.dslash_pallas_packed_mrhs(u, psi, 4, gauge_bw=u, chunk=3)
    links = torch.zeros((9, 3, 8, 8), device=dev)
    psi9 = torch.zeros((9, 3, 8), device=dev)
    with pytest.raises(TypeError, match="float32"):
        cop.coarse_apply_pallas(links.double(), psi9.double())
    with pytest.raises(ValueError, match="links of shape"):
        cop.coarse_apply_pallas(links[:, :2], psi9)
    big = cop.MAX_E + 4
    with pytest.raises(ValueError, match="E ="):
        cop.coarse_apply_pallas(torch.zeros((9, 1, big, big), device=dev),
                                torch.zeros((9, 1, big), device=dev))
    assert wpp.dslash_pallas_packed_mrhs.launches == n5
    assert cop.coarse_apply_pallas.launches == n8


def test_mg_hierarchy_on_card_matches_cpu():
    """A two-level Wilson hierarchy set up on the CPU (4^3x8 SU(3) links,
    blocks 2^4, n_vec 4) and carried to the card (PairMG.from_arrays): its
    V-cycle (B4, B8) within 1e-5 of the CPU's, verify within 1e-5 on the
    card, and the set-up on the card (B5) passes verify; the gcr-mg route
    on the card converges to true_res <= 5e-6, also at a kappa other than
    the hierarchy's."""
    from quda_tpu_torch.fields.geometry import LatticeGeometry
    from quda_tpu_torch.mg.mg import MGLevelParam
    from quda_tpu_torch.mg.pair import PairMG
    from quda_tpu_torch.models.wilson import DiracWilson
    dev = require_cuda()
    g = su3_gauge(SMALL, seed=95)
    geom = LatticeGeometry(SMALL)
    params = [MGLevelParam(block=(2, 2, 2, 2), n_vec=4, setup_iters=40)]
    cpu = PairMG(DiracWilson(torch.from_numpy(g), geom, 0.12), geom, params,
                 torch.Generator().manual_seed(96))
    arrays = [{"v": lv["transfer"].v, "x_diag": lv["coarse"].x_diag,
               "y": lv["coarse"].y} for lv in cpu.levels]
    card = PairMG.from_arrays(
        DiracWilson(torch.from_numpy(g).to(dev), geom, 0.12), params, arrays)
    b = torch.from_numpy(gaussian(lattice_shape(SMALL) + (4, 3, 2), seed=97,
                                  dtype=np.float32))
    want = cpu.precondition(b)
    n4 = wpp.dslash_pallas_packed.launches
    n8 = cop.coarse_apply_pallas.launches
    got = card.precondition(b.to(dev))
    torch.cuda.synchronize()
    assert wpp.dslash_pallas_packed.launches > n4
    assert cop.coarse_apply_pallas.launches > n8
    assert rel_err(got.cpu().numpy(), want.numpy()) < 1e-5
    assert card.verify(galerkin_tol=1e-5, pr_tol=1e-5)[0]["galerkin"] < 1e-5
    n5 = wpp.dslash_pallas_packed_mrhs.launches
    fresh = PairMG(card.adapter.dirac, geom, params,
                   torch.Generator(device=dev).manual_seed(98))
    assert wpp.dslash_pallas_packed_mrhs.launches > n5
    assert fresh.verify(galerkin_tol=1e-5, pr_tol=1e-5)[0]["galerkin"] < 1e-5
    qt.init_quda(device=dev)
    try:
        qt.load_gauge_quda(g, qt.GaugeParam(X=SMALL, cuda_prec="single"))
        ip = qt.InvertParam(dslash_type="wilson", inv_type="gcr-mg",
                            kappa=0.12, tol=1e-6, solve_type="direct",
                            cuda_prec="single", gcrNkrylov=6)
        qt.new_multigrid_quda(qt.MultigridParamAPI(
            geo_block_size=((2, 2, 2, 2),), n_vec=(4,), setup_iters=(40,)),
            ip)
        src = gaussian(lattice_shape(SMALL) + (4, 3), seed=99)
        qt.invert_quda(src, ip)
        assert ip.converged and ip.true_res <= 5e-6
        # another kappa: the outer GCR applies its operator, the resident
        # hierarchy preconditions
        ip.kappa = 0.11
        qt.invert_quda(src, ip)
    finally:
        qt.end_quda()
    assert ip.converged and ip.true_res <= 5e-6


# -- the full-lattice staggered forms (S2-full, S2-mrhs-full, S1-full) -------

STAG_FULL_DIMS = (14, 12, 10, 8)          # (T, Z, Y, X): every extent >= 7


def _stag_full_inputs(dev, seed, n=None):
    """Fat and long links (the long ones at 1/24 the scale) on the full
    lattice and psi (or an n-RHS batch), random normal on the card."""
    T, Z, Y, X = STAG_FULL_DIMS
    gen = torch.Generator(device=dev).manual_seed(seed)
    sites = (T, Z, Y * X)
    fat = torch.randn((4, 3, 3, 2) + sites, generator=gen, device=dev)
    lng = torch.randn((4, 3, 3, 2) + sites, generator=gen, device=dev) / 24
    lead = () if n is None else (n,)
    psi = torch.randn(lead + (3, 2) + sites, generator=gen, device=dev)
    return fat, lng, psi


@pytest.mark.parametrize("nhop", [1, 3], ids=["fat", "naik"])
def test_stag_full_pass_kernel_matches_plain(nhop):
    """S2-full against its plain version within TOLERANCE; one launch
    counted in its form."""
    dev = require_cuda()
    X = STAG_FULL_DIMS[3]
    fat, lng, psi = _stag_full_inputs(dev, 370 + nhop)
    u = fat if nhop == 1 else lng
    ubw = spl.backward_links(u, X, nhop).contiguous()
    name = spl.pass_form_name(nhop, torch.float32, torch.float32)
    n0 = spl.dslash_staggered_pass.launches_by_form.get(name, 0)
    got = spl.dslash_staggered_pass(u, ubw, psi, X, nhop)
    want = spl.dslash_staggered_pass_plain(u, ubw, psi, X, nhop)
    torch.cuda.synchronize()
    assert spl.dslash_staggered_pass.launches_by_form[name] == n0 + 1
    assert rel_err(got.cpu().numpy(), want.cpu().numpy()) < spl.TOLERANCE


def test_stag_full_fused_kernel_matches_plain_and_two_passes():
    """S1-full against its plain version within TOLERANCE, and bit for
    bit S2-full(fat) + S2-full(naik) (one hop body)."""
    dev = require_cuda()
    X = STAG_FULL_DIMS[3]
    fat, lng, psi = _stag_full_inputs(dev, 375)
    n0 = spl.dslash_staggered_pallas_fused.launches
    got = spl.dslash_staggered_pallas_fused(fat, psi, X, lng)
    want = spl.dslash_staggered_fused_plain(fat, lng, psi, X)
    fbw = spl.backward_links(fat, X, 1).contiguous()
    lbw = spl.backward_links(lng, X, 3).contiguous()
    two = spl.dslash_staggered_pallas(fat, fbw, psi, X, lng, lbw)
    torch.cuda.synchronize()
    assert spl.dslash_staggered_pallas_fused.launches == n0 + 1
    assert rel_err(got.cpu().numpy(), want.cpu().numpy()) < spl.TOLERANCE
    assert torch.equal(got, two)


@pytest.mark.parametrize("n", [1, 5, 24])
def test_stag_full_mrhs_kernel_matches_plain_and_single_launches(n):
    """S2-mrhs-full (fat, then Naik accumulating) against its plain
    version within TOLERANCE; each lane bit for bit the S2-full launches
    and the fat + Naik batch bit for bit S1-full."""
    dev = require_cuda()
    X = STAG_FULL_DIMS[3]
    fat, lng, psi = _stag_full_inputs(dev, 376, n)
    fbw = spl.backward_links(fat, X, 1).contiguous()
    lbw = spl.backward_links(lng, X, 3).contiguous()
    got_fat = spl.dslash_staggered_pass_mrhs(fat, fbw, psi, X, 1)
    want = spl.dslash_staggered_pass_mrhs_plain(fat, fbw, psi, X, 1)
    both = spl.dslash_staggered_pallas_mrhs(fat, fbw, psi, X, lng, lbw)
    torch.cuda.synchronize()
    assert rel_err(got_fat.cpu().numpy(), want.cpu().numpy()) < \
        spl.TOLERANCE
    for i in range(n):
        q = psi[i].contiguous()
        assert torch.equal(got_fat[i], spl.dslash_staggered_pass(
            fat, fbw, q, X, 1))
        assert torch.equal(both[i], spl.dslash_staggered_pallas_fused(
            fat, q, X, lng))


# (T, Z, Y, X) of the redesigned S2-mrhs-full's tile edges, every extent
# >= 7: Y*X = 168 leaves a partial tile of 40 sites on each plane and Z = 9
# a partial z-box; Y*X = 63 takes the 4-byte copies; Y*X = 272 ends each
# plane in a tile of 16 sites
S2MRHS_TILE_EXTENTS = [(8, 9, 12, 14), (7, 8, 7, 9), (7, 7, 8, 34)]


@pytest.mark.parametrize("nhop", [1, 3], ids=["fat", "naik"])
@pytest.mark.parametrize("n", [1, 5, 24, 25])
@pytest.mark.parametrize("extents", S2MRHS_TILE_EXTENTS,
                         ids=lambda e: "x".join(map(str, e)))
def test_stag_full_mrhs_tiles_match_s2_full(extents, n, nhop):
    """S2-mrhs-full on lattices whose planes end in partial tiles (and one
    that takes the 4-byte copies): each lane bit for bit an S2-full launch
    of its hop count, within TOLERANCE of the plain version, one launch
    counted in its form; the Naik pass accumulating into the fat pass
    bit for bit S1-full on each lane."""
    dev = require_cuda()
    T, Z, Y, X = extents
    gen = torch.Generator(device=dev).manual_seed(641 + n + X + nhop)
    sites = (T, Z, Y * X)
    fat = torch.randn((4, 3, 3, 2) + sites, generator=gen, device=dev)
    lng = torch.randn((4, 3, 3, 2) + sites, generator=gen, device=dev) / 24
    psi = torch.randn((n, 3, 2) + sites, generator=gen, device=dev)
    fbw = spl.backward_links(fat, X, 1).contiguous()
    lbw = spl.backward_links(lng, X, 3).contiguous()
    u, ubw = (fat, fbw) if nhop == 1 else (lng, lbw)
    name = spl.pass_form_name(nhop, torch.float32, torch.float32)
    n0 = spl.dslash_staggered_pass_mrhs.launches_by_form.get(name, 0)
    got = spl.dslash_staggered_pass_mrhs(u, ubw, psi, X, nhop)
    assert spl.dslash_staggered_pass_mrhs.launches_by_form[name] == n0 + 1
    want = spl.dslash_staggered_pass_mrhs_plain(u, ubw, psi, X, nhop)
    lanes = torch.stack([spl.dslash_staggered_pass(
        u, ubw, psi[i].contiguous(), X, nhop) for i in range(n)])
    torch.cuda.synchronize()
    assert torch.equal(got, lanes)
    assert rel_err(got.cpu().numpy(), want.cpu().numpy()) < spl.TOLERANCE
    if nhop == 3:
        both = spl.dslash_staggered_pass_mrhs(fat, fbw, psi, X, 1)
        spl.dslash_staggered_pass_mrhs(lng, lbw, psi, X, 3, acc=both)
        s1 = torch.stack([spl.dslash_staggered_pallas_fused(
            fat, psi[i].contiguous(), X, lng) for i in range(n)])
        torch.cuda.synchronize()
        assert torch.equal(both, s1)


@pytest.mark.parametrize("accum", [False, True], ids=["store", "accum"])
@pytest.mark.parametrize("nhop", [1, 3], ids=["fat", "naik"])
def test_stag_full_mrhs_resources_match_plan(nhop, accum):
    """S2-mrhs-full's query entry at 32^3 x 64: the shared memory, threads,
    tiles and blocks of full_mrhs_plan, FULL_MRHS_MIN_BLOCKS blocks an SM,
    at most 255 registers."""
    require_cuda()
    T, Z, Y, X = 64, 32, 32, 32
    info = spl.full_mrhs_info(nhop, accum, T, Z, Y, X)
    plan = spl.full_mrhs_plan(T, Z, Y, X)
    assert info["smem_bytes"] == plan["smem"]
    assert (info["threads"], info["tiles"], info["blocks"]) == (
        plan["threads"], plan["tiles"], plan["blocks"])
    assert 0 < info["registers"] <= 255
    assert info["blocks_per_sm"] >= spl.FULL_MRHS_MIN_BLOCKS


@pytest.mark.parametrize("parity", [0, 1])
def test_stag_full_forms_restricted_to_a_parity_match_eo_kernels(parity):
    """S1-full and S2-full read on the parity-p sites of a field living on
    parity 1-p equal the eo kernels S1 and S2 on the split fields, within
    TOLERANCE."""
    from quda_tpu_torch.fields.geometry import LatticeGeometry
    from quda_tpu_torch.fields.spinor import even_odd_join, even_odd_split
    from quda_tpu_torch.ops import staggered_packed as spk
    from quda_tpu_torch.ops import wilson_packed as wpk
    from quda_tpu_torch.ops.wilson import split_gauge_eo
    dev = require_cuda()
    T, Z, Y, X = STAG_FULL_DIMS
    geom = LatticeGeometry((X, Y, Z, T))
    fat, lng, psi = _stag_full_inputs(dev, 377 + parity)

    def canon(pl):
        return wpk.unpack_gauge(wpk.from_packed_pairs(pl), STAG_FULL_DIMS)

    def eo_links(pl):
        return [wpk.to_packed_pairs(spk.pack_links(g),
                                    torch.float32).contiguous()
                for g in split_gauge_eo(canon(pl), geom)]

    def pairs(x):
        return wpk.to_packed_pairs(spk.pack_staggered(x),
                                   torch.float32).contiguous()

    fat_eo, lng_eo = eo_links(fat), eo_links(lng)
    src = even_odd_split(spk.unpack_staggered(wpk.from_packed_pairs(psi),
                                              STAG_FULL_DIMS), geom)
    only = [torch.zeros_like(src[0]), torch.zeros_like(src[0])]
    only[1 - parity] = src[1 - parity]
    full_in = pairs(even_odd_join(only[0], only[1], geom))
    fbw = spl.backward_links(fat, X, 1).contiguous()
    ebw = spl.backward_links_eo(fat_eo[1 - parity], STAG_FULL_DIMS, parity,
                                1).contiguous()
    eo_in = pairs(only[1 - parity])
    for full_out, eo_out in (
            (spl.dslash_staggered_pallas_fused(fat, full_in, X, lng),
             spl.dslash_staggered_eo_pallas_fused(
                 fat_eo[parity], fat_eo[1 - parity], eo_in, STAG_FULL_DIMS,
                 parity, lng_eo[parity], lng_eo[1 - parity])),
            (spl.dslash_staggered_pass(fat, fbw, full_in, X, 1),
             spl.dslash_staggered_eo_pass(fat_eo[parity], ebw, eo_in,
                                          STAG_FULL_DIMS, parity, 1))):
        got = even_odd_split(spk.unpack_staggered(
            wpk.from_packed_pairs(full_out), STAG_FULL_DIMS), geom)[parity]
        want = spk.unpack_staggered(wpk.from_packed_pairs(eo_out),
                                    geom.half_lattice_shape)
        torch.cuda.synchronize()
        assert rel_err(got.cpu().numpy(), want.cpu().numpy()) < \
            spl.TOLERANCE


def test_staggered_mg_and_operator_api_on_card_match_cpu():
    """A staggered hierarchy set up on the CPU (8^4 SU(3) fat links,
    -1/24 SU(3) long links, m 0.3; blocks 4^4, n_vec 4) and carried to the
    card: its V-cycle (S2-full, B8) within 1e-5 of the CPU's; the set-up on
    the card runs S2-mrhs-full and passes verify; hisq gcr-mg on the card
    runs S1-full in the outer GCR and converges to true_res <= 5e-6;
    mat_quda for hisq within 1e-5 of the complex128 operator."""
    from quda_tpu_torch.fields.geometry import LatticeGeometry
    from quda_tpu_torch.mg.mg import MGLevelParam
    from quda_tpu_torch.mg.pair import PairMG
    from quda_tpu_torch.models.staggered import DiracStaggered
    dev = require_cuda()
    dims = (8, 8, 8, 8)
    geom = LatticeGeometry(dims)
    fat = su3_gauge(dims, seed=378)
    lng = (-su3_gauge(dims, seed=379, dtype=np.complex128) / 24).astype(
        np.complex64)
    params = [MGLevelParam(block=(4, 4, 4, 4), n_vec=4, setup_iters=20)]

    def dirac(where):
        return DiracStaggered(torch.from_numpy(fat).to(where), geom, 0.3,
                              improved=True,
                              long_links=torch.from_numpy(lng).to(where))
    cpu = PairMG(dirac("cpu"), geom, params,
                 torch.Generator().manual_seed(380))
    arrays = [{"v": lv["transfer"].v, "x_diag": lv["coarse"].x_diag,
               "y": lv["coarse"].y} for lv in cpu.levels]
    card = PairMG.from_arrays(dirac(dev), params, arrays)
    b = torch.from_numpy(gaussian(lattice_shape(dims) + (1, 3, 2), seed=381,
                                  dtype=np.float32))
    want = cpu.precondition(b)
    n2 = spl.dslash_staggered_pass.launches
    got = card.precondition(b.to(dev))
    torch.cuda.synchronize()
    assert spl.dslash_staggered_pass.launches > n2
    assert rel_err(got.cpu().numpy(), want.numpy()) < 1e-5
    nm = spl.dslash_staggered_pass_mrhs.launches
    fresh = PairMG(card.adapter.dirac, geom, params,
                   torch.Generator(device=dev).manual_seed(382))
    assert spl.dslash_staggered_pass_mrhs.launches > nm
    assert fresh.verify(galerkin_tol=1e-5, pr_tol=1e-5)[0]["galerkin"] < 1e-5
    qt.init_quda(device=dev)
    try:
        qt.load_gauge_quda(fat, qt.GaugeParam(X=dims, cuda_prec="single"))
        qt.load_fat_long_quda(fat, lng)
        ip = qt.InvertParam(dslash_type="hisq", inv_type="gcr-mg", mass=0.3,
                            tol=1e-6, solve_type="direct",
                            cuda_prec="single", gcrNkrylov=8)
        qt.new_multigrid_quda(qt.MultigridParamAPI(
            geo_block_size=((4, 4, 4, 4),), n_vec=(4,), setup_iters=(20,)),
            ip)
        src = gaussian(lattice_shape(dims) + (1, 3), seed=383)
        n1 = spl.dslash_staggered_pallas_fused.launches
        qt.invert_quda(src, ip)
        assert spl.dslash_staggered_pallas_fused.launches > n1
        assert ip.converged and ip.true_res <= 5e-6
        m = qt.mat_quda(src, qt.InvertParam(dslash_type="hisq", mass=0.3,
                                            cuda_prec="single"))
    finally:
        qt.end_quda()
    d128 = DiracStaggered(torch.from_numpy(fat).to(torch.complex128), geom,
                          0.3, improved=True,
                          long_links=torch.from_numpy(lng).to(
                              torch.complex128))
    ref = d128.M(torch.from_numpy(src).to(torch.complex128))
    assert rel_err(m.cpu().numpy(), ref.numpy()) < 1e-5


# -- the copy-free hops (v3, r12f, r12f-mrhs) and the int8 hop ---------------

# (rows, storage, out) of the copy-free hop's six instances
THERE_FORMS = [(3, torch.float32, torch.float32)] + FORMS


def _there_inputs(dev, rows, store, seed, n=None):
    """u_here, u_there (4,R,3,2,...) and psi (or an n-RHS batch) on
    4x6x8x10, random normal on the card, in ``store``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    sites = pair_spinor_shape(ASYM)[3:]
    lead = () if n is None else (n,)
    u_here, u_there = (torch.randn((4, rows, 3, 2) + sites, generator=gen,
                                   device=dev).to(store) for _ in range(2))
    psi = torch.randn(lead + (4, 3, 2) + sites, generator=gen,
                      device=dev).to(store)
    return u_here, u_there, psi


@pytest.mark.parametrize("tb_sign", [True, False],
                         ids=["antiperiodic", "periodic"])
@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("form", THERE_FORMS,
                         ids=lambda f: wpp.form_name(*f))
@pytest.mark.parametrize("fn", ["v3", "r12f"])
def test_copy_free_kernel_matches_plain_and_b1(fn, form, parity, tb_sign):
    """v3 and r12f (one kernel) on 4x6x8x10: within the module's
    tolerance of the plain version, and bit for bit B1 of the same form
    fed the backward_gauge_eo copy of u_there; one launch counted on the
    wrapper called."""
    dev = require_cuda()
    rows, store, out = form
    u_here, u_there, psi = _there_inputs(dev, rows, store, 61 + parity)
    dims = lattice_shape(ASYM)
    wrapper = getattr(wpp, f"dslash_eo_pallas_packed_{fn}")
    name = wpp.form_name(rows, store, out)
    n0 = wrapper.launches_by_form.get(name, 0)
    got = wrapper(u_here, u_there, psi, dims, parity, out_dtype=out,
                  tb_sign=tb_sign)
    assert wrapper.launches_by_form[name] == n0 + 1
    u_bw = wpp.backward_gauge_eo(u_there, dims, parity).contiguous()
    b1 = wpp.dslash_eo_pallas_packed(u_here, u_bw, psi, dims, parity,
                                     out_dtype=out, tb_sign=tb_sign)
    want = wpp.dslash_eo_there_plain(u_here, u_there, psi, dims, parity,
                                     out_dtype=out, tb_sign=tb_sign)
    torch.cuda.synchronize()
    assert got.dtype == out
    assert torch.equal(got, b1)
    tol = wpp.TOLERANCE if out == torch.float32 else wpp.TOLERANCE_BF16
    assert rel_err(got.float().cpu().numpy(), want.float().cpu().numpy()) \
        <= tol


INT8_FORMS = [(torch.float32, torch.float32),
              (torch.bfloat16, torch.bfloat16),
              (torch.bfloat16, torch.float32)]


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("form", INT8_FORMS,
                         ids=lambda f: wpp.int8_form_name(*f))
def test_int8_kernel_matches_plain_and_b1(form, parity):
    """The int8 hop on 4x6x8x10 (links of SU(3)-like scale quantised by
    to_int8_links): within tolerance of the plain version, and bit for
    bit B1 full:f32->f32 fed from_int8_links(q, s) and psi widened to
    f32 (a bf16 psi converts exactly, and every sum is f32), the bf16
    output that result rounded to nearest even."""
    from quda_tpu_torch.ops import blockfloat as tbf
    dev = require_cuda()
    store, out = form
    dims = lattice_shape(ASYM)
    u_here, u_there, psi = _there_inputs(dev, 3, torch.float32, 65 + parity)
    (qh, sh), (qt_, st) = (tbf.to_int8_links(u) for u in (u_here, u_there))
    psi = psi.to(store)
    name = wpp.int8_form_name(store, out)
    n0 = wpp.dslash_eo_pallas_packed_int8.launches_by_form.get(name, 0)
    got = wpp.dslash_eo_pallas_packed_int8(qh, sh, qt_, st, psi, dims,
                                           parity, out_dtype=out)
    assert wpp.dslash_eo_pallas_packed_int8.launches_by_form[name] == n0 + 1
    u_bw = wpp.backward_gauge_eo(tbf.from_int8_links(qt_, st), dims,
                                 parity).contiguous()
    b1 = wpp.dslash_eo_pallas_packed(tbf.from_int8_links(qh, sh), u_bw,
                                     psi.float(), dims, parity)
    want = wpp.dslash_eo_int8_plain(qh, sh, qt_, st, psi, dims, parity,
                                    out_dtype=out)
    torch.cuda.synchronize()
    assert got.dtype == out
    assert torch.equal(got, b1.to(out))
    tol = wpp.TOLERANCE if out == torch.float32 else wpp.TOLERANCE_BF16
    assert rel_err(got.float().cpu().numpy(), want.float().cpu().numpy()) \
        <= tol


@pytest.mark.parametrize("n", [1, 3, 12])
@pytest.mark.parametrize("chunk", list(wpp.MRHS_CHUNKS))
@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("rows", [3, 2], ids=["full", "r12"])
def test_r12f_mrhs_kernel_matches_plain_and_r12f(rows, parity, chunk, n):
    """The multi-RHS r12f hop at every chunk width (a tail chunk where n
    is odd): within TOLERANCE of its plain version, and each lane bit for
    bit a launch of the single-RHS r12f kernel."""
    dev = require_cuda()
    u_here, u_there, psi = _there_inputs(dev, rows, torch.float32,
                                         67 + parity, n)
    dims = lattice_shape(ASYM)
    fn = wpp.dslash_eo_pallas_packed_r12f_mrhs
    n0 = fn.launches
    got = fn(u_here, u_there, psi, dims, parity, chunk=chunk)
    assert fn.launches == n0 + 1
    want = wpp.dslash_eo_there_mrhs_plain(u_here, u_there, psi, dims, parity)
    lanes = torch.stack([wpp.dslash_eo_pallas_packed_r12f(
        u_here, u_there, psi[r], dims, parity) for r in range(n)])
    torch.cuda.synchronize()
    assert torch.equal(got, lanes)
    assert rel_err(got.cpu().numpy(), want.cpu().numpy()) <= wpp.TOLERANCE


def test_precision_form_wrappers_refuse_mixes_and_shapes():
    """The new wrappers raise on tensors split between the CPU and the
    card, on a wrong shape and on a form without an instance; nothing
    launches."""
    from quda_tpu_torch.ops import blockfloat as tbf
    dev = require_cuda()
    dims = lattice_shape(ASYM)
    u_here, u_there, psi = _there_inputs(dev, 2, torch.float32, 69)
    fns = (wpp.dslash_eo_pallas_packed_v3, wpp.dslash_eo_pallas_packed_r12f,
           wpp.dslash_eo_pallas_packed_r12f_mrhs,
           wpp.dslash_eo_pallas_packed_int8)
    before = [f.launches for f in fns]
    for fn in fns[:2]:
        with pytest.raises(ValueError, match="several devices"):
            fn(u_here, u_there.cpu(), psi, dims, 0)
        with pytest.raises(ValueError):
            fn(u_here, u_there[..., :4], psi, dims, 0)
        with pytest.raises(TypeError):
            fn(u_here, u_there, psi, dims, 0, out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="several devices"):
        fns[2](u_here, u_there, psi[None].cpu(), dims, 0)
    (qh, sh), (qt_, st) = (tbf.to_int8_links(
        torch.randn((4, 3, 3, 2) + psi.shape[3:], device=dev))
        for _ in range(2))
    with pytest.raises(ValueError, match="several devices"):
        fns[3](qh, sh.cpu(), qt_, st, psi, dims, 0)
    with pytest.raises(ValueError):
        fns[3](qh, sh, qt_[:, :, :, :, :2].contiguous(), st, psi, dims, 0)
    assert [f.launches for f in fns] == before


@pytest.mark.parametrize("tol", [1e-6, 1e-10])
def test_quarter_invert_on_card_matches_cpu(tol):
    """single/quarter on 4^4 SU(3) links: the card (int8 bf16 hop, at
    least 4 launches an iteration) against the CPU's plain path:
    converged, true_res <= 1e-5 (1e-10 on the df64 route), iterations
    within 10%, solutions within 1e-3."""
    dev = require_cuda()
    dims = (4, 4, 4, 4)
    g = su3_gauge(dims, seed=71)
    b = gaussian(lattice_shape(dims) + (4, 3), seed=72)
    wpp.reset_launches()
    xg, pg = _solve(g, b, dev, dims=dims, tol=tol, cuda_prec_sloppy="quarter")
    by = wpp.dslash_eo_pallas_packed_int8.launches_by_form
    assert by.get("int8:bf16->bf16", 0) + by.get("int8:bf16->f32", 0) >= \
        4 * pg.iter_count
    xc, pc = _solve(g, b, "cpu", dims=dims, tol=tol,
                    cuda_prec_sloppy="quarter")
    assert pg.converged and pg.reliable_updates >= 1
    assert pg.true_res <= (1e-5 if tol > 5e-8 else 1e-10)
    assert abs(pg.iter_count - pc.iter_count) <= max(2, 0.1 * pc.iter_count)
    assert np.linalg.norm(xg - xc) / np.linalg.norm(xc) < 1e-3


# -- the fold layout (B9 fold, fold-mrhs, S1-fold) and the v3 pass ------------

@pytest.mark.parametrize("tb_sign", [True, False],
                         ids=["antiperiodic", "periodic"])
@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("form", THERE_FORMS,
                         ids=lambda f: wpp.form_name(*f))
def test_fold_kernel_matches_plain_and_b1(form, parity, tb_sign):
    """The fold hop on 4x6x8x10, every form (R = 3, 2): bit for bit
    to_fold of B1's output on the unfolded operands, within the module's
    tolerance of its plain version; one launch counted."""
    dev = require_cuda()
    rows, store, out = form
    u_here, u_there, psi = _there_inputs(dev, rows, store, 381 + parity)
    dims = lattice_shape(ASYM)
    u_bw = wpp.backward_gauge_eo(u_there, dims, parity).contiguous()
    fh, fb, fp = (wpp.to_fold(t) for t in (u_here, u_bw, psi))
    name = wpp.form_name(rows, store, out)
    fn = wpp.dslash_eo_pallas_packed_fold
    n0 = fn.launches_by_form.get(name, 0)
    got = fn(fh, fb, fp, dims, parity, out_dtype=out, tb_sign=tb_sign)
    assert fn.launches_by_form[name] == n0 + 1
    b1 = wpp.dslash_eo_pallas_packed(u_here, u_bw, psi, dims, parity,
                                     out_dtype=out, tb_sign=tb_sign)
    want = wpp.dslash_eo_fold_plain(fh, fb, fp, dims, parity, out_dtype=out,
                                    tb_sign=tb_sign)
    torch.cuda.synchronize()
    assert got.dtype == out and got.shape == fp.shape
    assert torch.equal(got, wpp.to_fold(b1))
    tol = wpp.TOLERANCE if out == torch.float32 else wpp.TOLERANCE_BF16
    assert rel_err(got.float().cpu().numpy(), want.float().cpu().numpy()) \
        <= tol


@pytest.mark.parametrize("tb_sign", [True, False],
                         ids=["antiperiodic", "periodic"])
@pytest.mark.parametrize("n", [1, 3, 5, 12])
@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("rows", [3, 2], ids=["full", "r12"])
def test_fold_mrhs_kernel_matches_plain_and_fold(rows, parity, n, tb_sign):
    """The multi-RHS fold hop (B5-eo's staged design on the fold layout,
    one right-hand side a thread at a time) on 4x6x8x10: each lane bit
    for bit a launch of the fold hop, the batch within TOLERANCE of its
    plain version; one launch counted."""
    dev = require_cuda()
    u_here, u_bw, psi = _there_inputs(dev, rows, torch.float32,
                                      383 + parity, n)
    dims = lattice_shape(ASYM)
    fh, fb, fp = (wpp.to_fold(t) for t in (u_here, u_bw, psi))
    fn = wpp.dslash_eo_pallas_packed_fold_mrhs
    n0 = fn.launches
    got = fn(fh, fb, fp, dims, parity, tb_sign=tb_sign)
    assert fn.launches == n0 + 1
    want = wpp.dslash_eo_fold_mrhs_plain(fh, fb, fp, dims, parity,
                                         tb_sign=tb_sign)
    lanes = torch.stack([wpp.dslash_eo_pallas_packed_fold(
        fh, fb, fp[r], dims, parity, tb_sign=tb_sign) for r in range(n)])
    torch.cuda.synchronize()
    assert torch.equal(got, lanes)
    assert rel_err(got.cpu().numpy(), want.cpu().numpy()) <= wpp.TOLERANCE


@pytest.mark.parametrize("n", [1, 5, 12])
@pytest.mark.parametrize("tb_sign", [True, False],
                         ids=["antiperiodic", "periodic"])
@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("rows", [3, 2], ids=["full", "r12"])
@pytest.mark.parametrize("extents", B5EO_TILE_EXTENTS,
                         ids=lambda e: "x".join(map(str, e)))
def test_fold_mrhs_tiles_match_fold(extents, rows, parity, tb_sign, n):
    """fold-mrhs on B5-eo's tile-edge lattices (rows
    ending in partial tiles, a partial z-box, and Y*Xh = 30, whose fold
    runs take the 4-byte copies): each lane bit for bit the fold hop."""
    dev = require_cuda()
    T, Z, Y, X = extents
    gen = torch.Generator(device=dev).manual_seed(641 + rows + n + X)
    sites = (T, Z, Y * X // 2)
    u, ubw = (torch.randn((4, rows, 3, 2) + sites, generator=gen,
                          device=dev) for _ in range(2))
    psi = torch.randn((n, 4, 3, 2) + sites, generator=gen, device=dev)
    fh, fb, fp = (wpp.to_fold(t) for t in (u, ubw, psi))
    got = wpp.dslash_eo_pallas_packed_fold_mrhs(fh, fb, fp, extents, parity,
                                                tb_sign=tb_sign)
    lanes = torch.stack([wpp.dslash_eo_pallas_packed_fold(
        fh, fb, fp[r], extents, parity, tb_sign=tb_sign) for r in range(n)])
    torch.cuda.synchronize()
    assert torch.equal(got, lanes)


@pytest.mark.parametrize("rows", [3, 2], ids=["full", "r12"])
def test_fold_mrhs_resources_match_plan(rows):
    """fold-mrhs's query entry at 32^3 x 64: the shared memory, threads,
    tiles and blocks of fold_mrhs_plan; FOLD_MRHS_MIN_BLOCKS blocks an SM;
    at most 255 registers."""
    require_cuda()
    T, Z, Y, Xh = 64, 32, 32, 16
    info = wpp.fold_mrhs_info(rows, T, Z, Y, Xh)
    plan = wpp.fold_mrhs_plan(rows, T, Z, Y, Xh)
    assert info["smem_bytes"] == plan["smem"]
    assert (info["threads"], info["tiles"], info["blocks"]) == (
        plan["threads"], plan["tiles"], plan["blocks"])
    assert 0 < info["registers"] <= 255
    assert info["blocks_per_sm"] >= wpp.FOLD_MRHS_MIN_BLOCKS


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("form", STAG_FORMS,
                         ids=lambda f: spl.form_name(*f))
def test_stag_fused_fold_kernel_matches_plain_and_s1(form, parity):
    """S1-fold at 8x10x12x14: bit for bit to_fold of S1 on the unfolded
    operands, within tolerance of its plain version."""
    dev = require_cuda()
    store, out = form
    links, psi = _stag_inputs(dev, store, 385 + parity)
    folded = [wpp.to_fold(t) for t in links]
    fp = wpp.to_fold(psi)
    fn = spl.dslash_staggered_eo_pallas_fused_fold
    name = spl.form_name(store, out)
    n0 = fn.launches_by_form.get(name, 0)
    got = fn(folded[0], folded[1], fp, STAG_DIMS, parity, folded[2],
             folded[3], out_dtype=out)
    assert fn.launches_by_form[name] == n0 + 1
    s1 = spl.dslash_staggered_eo_pallas_fused(
        links[0], links[1], psi, STAG_DIMS, parity, links[2], links[3],
        out_dtype=out)
    want = spl.dslash_staggered_eo_fused_fold_plain(
        folded[0], folded[1], fp, STAG_DIMS, parity, folded[2], folded[3],
        out_dtype=out)
    torch.cuda.synchronize()
    assert got.dtype == out
    assert torch.equal(got, wpp.to_fold(s1))
    assert rel_err(got.float().cpu().numpy(),
                   want.float().cpu().numpy()) < _stag_tol(out)


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("form", STAG_FORMS,
                         ids=lambda f: spl.form_name(*f).split(":")[1])
@pytest.mark.parametrize("nhop", [1, 3], ids=["fat", "naik"])
def test_stag_v3_pass_matches_plain_and_s2(nhop, form, parity):
    """The v3 pass: bit for bit S2 on the backward_links_eo copy of
    u_there, within tolerance of its plain version."""
    dev = require_cuda()
    store, out = form
    links, psi = _stag_inputs(dev, store, 387 + parity)
    here, there = links[:2] if nhop == 1 else links[2:]
    fn = spl.dslash_staggered_eo_pass_v3
    name = spl.pass_form_name(nhop, store, out)
    n0 = fn.launches_by_form.get(name, 0)
    got = fn(here, there, psi, STAG_DIMS, parity, nhop, out_dtype=out)
    assert fn.launches_by_form[name] == n0 + 1
    ubw = spl.backward_links_eo(there, STAG_DIMS, parity, nhop).contiguous()
    s2 = spl.dslash_staggered_eo_pass(here, ubw, psi, STAG_DIMS, parity, nhop,
                                      out_dtype=out)
    want = spl.dslash_staggered_eo_pass_v3_plain(here, there, psi, STAG_DIMS,
                                                 parity, nhop, out_dtype=out)
    torch.cuda.synchronize()
    assert got.dtype == out
    assert torch.equal(got, s2)
    assert rel_err(got.float().cpu().numpy(),
                   want.float().cpu().numpy()) < _stag_tol(out)


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("form", STAG_FORMS,
                         ids=lambda f: spl.form_name(*f))
def test_stag_v3_improved_hop_equals_s1(form, parity):
    """The improved v3 hop (the f32 fat pass, then the Naik pass adding
    it): bit for bit S1, two v3 launches."""
    dev = require_cuda()
    store, out = form
    (fh, ft, lh, lt), psi = _stag_inputs(dev, store, 389 + parity)
    fn = spl.dslash_staggered_eo_pass_v3
    n0 = fn.launches
    got = spl.dslash_staggered_eo_pallas_v3(fh, ft, psi, STAG_DIMS, parity,
                                            lh, lt, out_dtype=out)
    assert fn.launches == n0 + 2
    s1 = spl.dslash_staggered_eo_pallas_fused(fh, ft, psi, STAG_DIMS, parity,
                                              lh, lt, out_dtype=out)
    torch.cuda.synchronize()
    assert got.dtype == out
    assert torch.equal(got, s1)


def test_fold_v3_wrappers_refuse_mixes_and_shapes():
    """The fold and v3 wrappers raise on tensors split between the CPU and
    the card, on a wrong shape and on a form without an instance (fold
    bf16 batches: A7); nothing launches."""
    dev = require_cuda()
    dims = lattice_shape(ASYM)
    u_here, u_bw, psi = (wpp.to_fold(t) for t in _there_inputs(
        dev, 3, torch.float32, 391))
    fns = (wpp.dslash_eo_pallas_packed_fold,
           wpp.dslash_eo_pallas_packed_fold_mrhs,
           spl.dslash_staggered_eo_pallas_fused_fold,
           spl.dslash_staggered_eo_pass_v3)
    before = [f.launches for f in fns]
    with pytest.raises(ValueError, match="several devices"):
        fns[0](u_here, u_bw.cpu(), psi, dims, 0)
    with pytest.raises(ValueError):
        fns[0](u_here, u_bw[..., :4], psi, dims, 0)
    with pytest.raises(TypeError):
        fns[0](u_here, u_bw, psi, dims, 0, out_dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="ROADMAP A7"):
        fns[1](u_here.bfloat16(), u_bw.bfloat16(), psi[None].bfloat16(),
               dims, 0)
    links, spsi = _stag_inputs(dev, torch.float32, 392)
    fl = [wpp.to_fold(t) for t in links]
    with pytest.raises(ValueError, match="Naik"):
        fns[2](fl[0], fl[1], wpp.to_fold(spsi), STAG_DIMS, 0)
    with pytest.raises(ValueError, match="several devices"):
        fns[2](fl[0], fl[1].cpu(), wpp.to_fold(spsi), STAG_DIMS, 0, fl[2],
               fl[3])
    with pytest.raises(ValueError, match="several devices"):
        fns[3](links[0], links[1], spsi.cpu(), STAG_DIMS, 0, 1)
    with pytest.raises(ValueError, match="acc"):
        fns[3](links[0], links[1], spsi, STAG_DIMS, 0, 1, acc=spsi)
    with pytest.raises(ValueError):
        fns[3](links[2], links[3], spsi, STAG_DIMS, 0, 3,
               acc=spsi[..., :4])
    assert [f.launches for f in fns] == before


def test_fold_and_v3_operators_on_card_equal_their_twins():
    """fused_cg on the Wilson fold operator (4^4 SU(3) links) and on the
    staggered fold and v3 operators (8x10x12x14 HISQ-scale links) on the
    card: their twins' iterations and solution bits, each running its own
    kernel only."""
    from quda_tpu_torch.fields.geometry import LatticeGeometry
    from quda_tpu_torch.fields.spinor import even_odd_split
    from quda_tpu_torch.models.staggered import DiracStaggeredPC
    from quda_tpu_torch.models.wilson import DiracWilsonPC
    from quda_tpu_torch.solvers.fused_iter import fused_cg
    dev = require_cuda()
    dims = (4, 4, 4, 4)
    geom = LatticeGeometry(dims)
    g = torch.from_numpy(su3_gauge(dims, 393)).to(dev)
    b = torch.from_numpy(gaussian(lattice_shape(dims) + (4, 3), 394)).to(dev)
    dpk = DiracWilsonPC(g, geom, 0.12).packed()
    be, bo = even_odd_split(b, geom)
    res = {}
    for form in ("full", "fold"):
        op = dpk.pairs(torch.float32, form)
        rhs = op.Mdag_pairs(op.prepare_pairs(be, bo))
        wpp.reset_launches()
        res[form] = fused_cg(op.MdagM_pairs, rhs, tol=1e-6, maxiter=500)
        torch.cuda.synchronize()
        if form == "fold":
            assert wpp.dslash_eo_pallas_packed.launches == 0
            assert wpp.dslash_eo_pallas_packed_fold.launches == \
                4 * res[form].iters
    assert res["fold"].iters == res["full"].iters
    assert torch.equal(res["fold"].x, res["full"].x)
    sd = (8, 10, 12, 14)
    sgeom = LatticeGeometry(sd)
    fat = torch.from_numpy(su3_gauge(sd, 395)).to(dev)
    lng = torch.from_numpy(su3_gauge(sd, 396)).to(dev) / 24
    sb = torch.from_numpy(gaussian(lattice_shape(sd) + (1, 3), 397)).to(dev)
    dpc = DiracStaggeredPC(fat, sgeom, 0.1, True, lng)
    sbe, sbo = even_odd_split(sb, sgeom)
    sres = {}
    for label, kw in (("fused", {}), ("fold", {"precision_form": "fold"}),
                      ("v3", {"form": "v3"})):
        op = dpc.pairs(torch.float32, **kw)
        rhs = op.prepare_pairs(sbe, sbo)
        spl.reset_launches()
        sres[label] = fused_cg(op.M_pairs, rhs, tol=1e-6, maxiter=500)
        torch.cuda.synchronize()
        if label != "fused":
            assert spl.dslash_staggered_eo_pallas_fused.launches == 0
            assert spl.dslash_staggered_eo_pass.launches == 0
    assert spl.dslash_staggered_eo_pass_v3.launches == \
        4 * sres["v3"].iters
    for label in ("fold", "v3"):
        assert sres[label].iters == sres["fused"].iters
        assert torch.equal(sres[label].x, sres["fused"].x)


# -- the full-lattice clover operator (B7 full), the copy-free full-lattice
# -- hop (B10), the canonical-layout hop (B11), the operator API of the
# -- clover and twisted families and the tuned dslash

@pytest.mark.parametrize("tb_sign", [True, False],
                         ids=["antiperiodic", "periodic"])
@pytest.mark.parametrize("rows", [3, 2], ids=["full", "r12"])
def test_v3_full_kernel_matches_plain_and_b4(rows, tb_sign):
    """B10 on 14x12x10x8: within TOLERANCE of its plain version and bit
    for bit B4 fed the backward_gauge copy; one launch counted."""
    dev = require_cuda()
    u, ubw, psi = _full_inputs(dev, rows, torch.float32, 90 + rows)
    X = FULL_DIMS[3]
    name = wpp.form_name(rows, torch.float32, torch.float32)
    n0 = wpp.dslash_pallas_packed_v3.launches_by_form.get(name, 0)
    got = wpp.dslash_pallas_packed_v3(u, psi, X, tb_sign=tb_sign)
    assert wpp.dslash_pallas_packed_v3.launches_by_form[name] == n0 + 1
    b4 = wpp.dslash_pallas_packed(u, psi, X, gauge_bw=ubw, tb_sign=tb_sign)
    want = wpp.dslash_packed_v3_plain(u, psi, X, tb_sign)
    torch.cuda.synchronize()
    assert torch.equal(got, b4)
    assert rel_err(got.cpu().numpy(), want.cpu().numpy()) < wpp.TOLERANCE


@pytest.mark.parametrize("cdt", [torch.complex64, torch.complex128])
def test_canonical_kernel_matches_plain_and_v3(cdt):
    """B11 on complex fields at 14x12x10x8: within its module's tolerance
    of the plain version (1e-5 complex64, 1e-12 complex128); in complex64
    bit for bit B10 on the same fields in the packed layout."""
    from quda_tpu_torch.ops import wilson_packed as wpk
    from quda_tpu_torch.ops import wilson_pallas as wpl
    dev = require_cuda()
    gen = torch.Generator(device=dev).manual_seed(95)
    T, Z, Y, X = FULL_DIMS
    g = torch.randn((4, T, Z, Y, X, 3, 3), generator=gen, device=dev,
                    dtype=cdt)
    psi = torch.randn((T, Z, Y, X, 4, 3), generator=gen, device=dev,
                      dtype=cdt)
    n0 = wpl.dslash_pallas.launches
    got = wpl.dslash_pallas(g, psi)
    assert wpl.dslash_pallas.launches == n0 + 1
    want = wpl.dslash_canonical_plain(g, psi)
    torch.cuda.synchronize()
    assert got.dtype == cdt and got.shape == psi.shape
    tol = wpl.TOLERANCE_F64 if cdt == torch.complex128 else wpl.TOLERANCE
    assert rel_err(got.cpu().numpy(), want.cpu().numpy()) < tol
    if cdt == torch.complex64:
        gp = wpk.to_packed_pairs(wpk.pack_gauge(g), torch.float32)
        pp = wpk.to_packed_pairs(wpk.pack_spinor(psi), torch.float32)
        v3 = wpp.dslash_pallas_packed_v3(gp.contiguous(), pp.contiguous(),
                                         X, tb_sign=False)
        canon = wpk.to_packed_pairs(wpk.pack_spinor(got), torch.float32)
        torch.cuda.synchronize()
        assert torch.equal(canon, v3)


@pytest.mark.parametrize("twist", [None, 0.17], ids=["clover", "twisted"])
@pytest.mark.parametrize("tb_sign", [True, False],
                         ids=["antiperiodic", "periodic"])
@pytest.mark.parametrize("rows", [3, 2], ids=["full", "r12"])
def test_clover_full_kernel_matches_plain(rows, tb_sign, twist):
    """B7 full on 14x12x10x8 with random blocks: within FULL_TOLERANCE of
    its plain version; one launch counted in its form."""
    dev = require_cuda()
    u, ubw, psi = _full_inputs(dev, rows, torch.float32, 97 + rows)
    gen = torch.Generator(device=dev).manual_seed(99)
    blk = torch.randn((2, 6, 6, 2) + tuple(psi.shape[-3:]), generator=gen,
                      device=dev)
    X = FULL_DIMS[3]
    name = (wpp.form_name(rows, torch.float32, torch.float32)
            + clp.epilogue_name(True, twist is not None))
    n0 = clp.clover_pallas_packed.launches_by_form.get(name, 0)
    got = clp.clover_pallas_packed(u, blk, psi, X, 0.12, diag_twist=twist,
                                   gauge_bw=ubw, tb_sign=tb_sign)
    assert clp.clover_pallas_packed.launches_by_form[name] == n0 + 1
    want = clp.clover_packed_plain(u, ubw, blk, psi, X, 0.12, twist, tb_sign)
    torch.cuda.synchronize()
    assert rel_err(got.cpu().numpy(), want.cpu().numpy()) < \
        clp.FULL_TOLERANCE


@pytest.mark.parametrize("rec", [18, 12])
@pytest.mark.parametrize("family", ["clover", "twisted-clover",
                                    "twisted-mass"])
def test_zoo_operator_api_on_card_matches_cpu(family, rec):
    """mat_quda and mat_dag_mat_quda of the clover and twisted families on
    the card within 1e-5 of the CPU route (the plain versions), with one
    and two launches of B7 full (clover, twisted clover; no B1 or B4) or
    of B4 (twisted mass); dslash_quda one B1 launch."""
    import quda_tpu_torch as qt
    dev = require_cuda()
    dims = (4, 4, 4, 8)
    g = su3_gauge(dims, 401)
    psi = gaussian(lattice_shape(dims) + (4, 3), 402)
    half = gaussian(lattice_shape(dims)[:3] + (2, 4, 3), 403)
    out = {}
    for device in ("cpu", dev):
        qt.init_quda(device=device)
        try:
            qt.load_gauge_quda(g, qt.GaugeParam(X=dims, cuda_prec="single",
                                                reconstruct=rec))
            p = qt.InvertParam(dslash_type=family, kappa=0.12, mu=0.1,
                               csw=1.0, cuda_prec="single")
            wpp.reset_launches()
            clp.reset_launches()
            res = {"mat": qt.mat_quda(psi, p)}
            n_mat = (clp.clover_pallas_packed.launches,
                     wpp.dslash_pallas_packed.launches,
                     wpp.dslash_eo_pallas_packed.launches)
            res["mdm"] = qt.mat_dag_mat_quda(psi, p)
            res["dslash"] = qt.dslash_quda(half, p, 0)
            n_all = (clp.clover_pallas_packed.launches,
                     wpp.dslash_pallas_packed.launches,
                     wpp.dslash_eo_pallas_packed.launches)
            out[str(device)] = {k: v.cpu().numpy() for k, v in res.items()}
        finally:
            qt.end_quda()
    for k, v in out[str(dev)].items():
        assert rel_err(v, out["cpu"][k]) < 1e-5, k
    if family == "twisted-mass":
        assert n_mat == (0, 1, 0) and n_all == (0, 3, 1)
    else:
        assert n_mat == (1, 0, 0) and n_all == (3, 0, 1)


def test_tuned_dslash_on_card_races_the_kernels(monkeypatch, tmp_path):
    """tuned_dslash on the card races xla, xla_packed, pallas_packed (B4)
    and pallas_v3 (B10); the B4 and B10 counters advance in the race; the
    winner is cached under tmp_path and its output is within 1e-5 of the
    complex stencil's."""
    from quda_tpu_torch.ops import wilson as wops
    from quda_tpu_torch.ops import wilson_pallas as wpl
    from quda_tpu_torch.utils import tune
    dev = require_cuda()
    monkeypatch.setenv("QUDA_TORCH_RESOURCE_PATH", str(tmp_path))
    monkeypatch.delenv("QUDA_TORCH_ENABLE_TUNING", raising=False)
    monkeypatch.setattr(tune, "_cache", {})
    monkeypatch.setattr(tune, "_loaded_path", None)
    dims = (4, 4, 4, 8)
    g = torch.from_numpy(su3_gauge(dims, 404)).to(dev)
    psi = torch.from_numpy(gaussian(lattice_shape(dims) + (4, 3),
                                    405)).to(dev)
    wpp.reset_launches()
    got = wpl.tuned_dslash(g, psi)
    lat = tuple(lattice_shape(dims))
    assert list(wpl._tuned_candidates(lat, str(psi.dtype), "cuda")) == [
        "xla", "xla_packed", "pallas_packed", "pallas_v3"]
    assert wpp.dslash_pallas_packed.launches > 0
    assert wpp.dslash_pallas_packed_v3.launches > 0
    winner = tune.cached_param("wilson_dslash", lat, f"{psi.dtype}/cuda")
    assert winner is not None
    assert (tmp_path / tune.CACHE_FILE).exists()
    want = wops.dslash_full(g, psi)
    torch.cuda.synchronize()
    assert rel_err(got.cpu().numpy(), want.cpu().numpy()) < 1e-5


# -- the multi-device Wilson path on a virtual mesh of one card ------------

def _vmesh(dev, grid):
    from quda_tpu_torch.parallel import mesh as qm
    n = int(np.prod(grid))
    return qm.make_lattice_mesh(grid, devices=[dev] * n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slab_exchange_kernel_is_the_plain_transport(dtype):
    """slab_exchange_bidir on 8 sub-domains of one card: one launch per
    call, bit for bit two _permute_slice transports, for slabs of a
    16-byte multiple and for odd byte counts (the kernel's byte copies),
    and for the strided faces the sharded hop hands it (t and z planes,
    y row strips of 16- and 8-byte runs, x columns), read in place."""
    from quda_tpu_torch.parallel import pallas_dslash as pds
    from quda_tpu_torch.parallel import pallas_halo as ph
    dev = require_cuda()
    mesh = _vmesh(dev, (2, 2, 2, 1))
    gen = torch.Generator(device=dev).manual_seed(501)

    def slabs(shape):
        return [torch.randn(shape, generator=gen, device=dev).to(dtype)
                for _ in range(8)]

    cases = [(name, slabs(shape), slabs(shape))
             for shape in ((4, 3, 2, 1, 4, 16), (3, 5, 7))
             for name in ("t", "z", "y")]
    for xcols in (8, 2):
        blocks = slabs((4, 3, 2, 4, 6, 4 * xcols))
        for fio, name, _, _ in pds._axis_plan((2, 2, 2, 2), xcols):
            cases.append((name if name != "x" else "y",
                          [fio.face(b, lo=True) for b in blocks],
                          [fio.face(b, lo=False) for b in blocks]))
    for name, down, up in cases:
        n0 = ph.slab_exchange_bidir.launches
        got = ph.slab_exchange_bidir(down, up, mesh, name)
        want = ph.slab_exchange_plain(down, up, mesh, name)
        torch.cuda.synchronize()
        assert ph.slab_exchange_bidir.launches == n0 + 1
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert torch.equal(a, b)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_fused_halo_kernels_match_plain_and_composed(n):
    """wilson_axis_fused_halo (z and t) and wilson_zbwd_fused_halo on n
    sub-domains of one card: within 1e-6 of the plain version and of the
    composed reference on the gathered field; one launch each."""
    from quda_tpu_torch.parallel import mesh as qm
    from quda_tpu_torch.parallel import pallas_halo as ph
    dev = require_cuda()
    gen = torch.Generator(device=dev).manual_seed(510 + n)
    for ax, grid, sites, mu in (("z", (1, n, 1, 1), (16, 24), 2),
                                ("t", (n, 1, 1, 1), (16, 4, 12), 3)):
        mesh = _vmesh(dev, grid)
        spec = (None, None, None, ax) + (None,) * (len(sites) - 1)
        psi = torch.randn((4, 3, 2) + sites, generator=gen, device=dev)
        u = torch.randn((3, 3, 2) + sites, generator=gen, device=dev)
        ps, us = qm.shard(psi, mesh, spec), qm.shard(u, mesh, spec)
        cases = [(ph.wilson_axis_fused_halo, True)]
        if ax == "z":
            cases.append((ph.wilson_zbwd_fused_halo, False))
        for fn, bidir in cases:
            n0 = fn.launches
            out = (fn(ps, us, mu, ax) if bidir else fn(ps, us, ax))
            got = qm.gather(out)
            plain = qm.gather(ph.wilson_axis_halo_plain(ps, us, mu, ax,
                                                        bidir))
            ref = (ph.wilson_axis_composed(psi, u, mu) if bidir
                   else ph.wilson_zbwd_composed(psi, u))
            torch.cuda.synchronize()
            assert fn.launches == n0 + 1
            assert rel_err(got.cpu().numpy(),
                           plain.cpu().numpy()) < ph.TOLERANCE
            assert rel_err(got.cpu().numpy(),
                           ref.cpu().numpy()) < ph.TOLERANCE


def test_fused_halo_kernel_takes_float32_only():
    from quda_tpu_torch.parallel import mesh as qm
    from quda_tpu_torch.parallel import pallas_halo as ph
    dev = require_cuda()
    mesh = _vmesh(dev, (1, 2, 1, 1))
    spec = (None, None, None, "z", None)
    psi = torch.zeros((4, 3, 2, 4, 8), device=dev, dtype=torch.bfloat16)
    u = torch.zeros((3, 3, 2, 4, 8), device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        ph.wilson_axis_fused_halo(qm.shard(psi, mesh, spec),
                                  qm.shard(u, mesh, spec))


@pytest.mark.parametrize("grid,version", [((2, 2, 2, 1), 2),
                                          ((2, 2, 1, 2), 2),
                                          ((2, 4, 1, 1), 3)])
@pytest.mark.parametrize("form", ["full", "r12"])
def test_sharded_eo_hop_on_card(grid, version, form):
    """The sharded eo hop on a virtual mesh: fused_halo (the exchange
    kernel on every contiguous axis) bit for bit xla_facefix, both within
    1e-6 (norm ratio) of the unsharded B1 / B10-eo, both parities."""
    from quda_tpu_torch.fields.geometry import LatticeGeometry
    from quda_tpu_torch.models.wilson import DiracWilsonPC
    from quda_tpu_torch.parallel import pallas_halo as ph
    dev = require_cuda()
    dims = (8, 4, 8, 8)
    geom = LatticeGeometry(dims)
    g = torch.from_numpy(su3_gauge(dims, 520)).to(dev)
    dpk = DiracWilsonPC(g, geom, 0.12).packed()
    ref_op = dpk.pairs(torch.float32, form, version)
    pol = "t=fused_halo,z=fused_halo" + (",y=fused_halo" if grid[2] > 1
                                         else "")
    op = dpk.pairs(torch.float32, form, version, mesh=_vmesh(dev, grid),
                   sharded_policy=pol)
    for parity in (0, 1):
        x = torch.from_numpy(gaussian(pair_spinor_shape(dims), 521 + parity,
                                      np.float32)).to(dev)
        xs = op.shard(x)
        other = (op._u_bw[parity] if version == 2
                 else op.gauge_eo_pp[1 - parity])
        n0 = ph.slab_exchange_bidir.launches
        a = op._hop_on_mesh(op.gauge_eo_pp[parity], other, xs, parity, None,
                            pol)
        assert ph.slab_exchange_bidir.launches > n0
        b = op._hop_on_mesh(op.gauge_eo_pp[parity], other, xs, parity, None,
                            "xla_facefix")
        want = ref_op._d_to(x, parity, None)
        torch.cuda.synchronize()
        assert all(torch.equal(p, q) for p, q in zip(a.blocks, b.blocks))
        got = op.gather(a)
        assert float((got - want).norm() / want.norm()) < 1e-6


def test_mesh_fused_cg_on_card():
    """fused_cg on the (2,2,2,1) virtual-mesh operator with the default
    sharded_policy ("auto": the exchange kernel on t/z/y): the unsharded
    solve's iterations +-1, the exchange kernel 3 launches a hop (12 an
    iteration), B1 8 a hop, B2 8 an iteration."""
    from quda_tpu_torch.fields.geometry import LatticeGeometry
    from quda_tpu_torch.fields.spinor import even_odd_split
    from quda_tpu_torch.models.wilson import DiracWilsonPC
    from quda_tpu_torch.parallel import pallas_halo as ph
    from quda_tpu_torch.solvers.fused_iter import fused_cg
    dev = require_cuda()
    dims = (8, 4, 8, 8)
    geom = LatticeGeometry(dims)
    g = torch.from_numpy(su3_gauge(dims, 530)).to(dev)
    psi = torch.from_numpy(gaussian(lattice_shape(dims) + (4, 3),
                                    531)).to(dev)
    dpk = DiracWilsonPC(g, geom, 0.12).packed()
    op0 = dpk.pairs(torch.float32)
    op = dpk.pairs(torch.float32, mesh=_vmesh(dev, (2, 2, 2, 1)))
    assert [op._sharded_policy[a] for a in "tzyx"] == [
        "fused_halo"] * 3 + ["xla_facefix"]
    be, bo = even_odd_split(psi, geom)
    rhs = op0.prepare_pairs(be, bo)
    ref = fused_cg(op0.MdagM_pairs, op0.Mdag_pairs(rhs), tol=1e-6,
                   maxiter=500)
    b = op.Mdag_pairs(op.shard(rhs))
    ph.reset_launches()
    wpp.reset_launches()
    bpl.cg_update_norm2_pallas.launches = 0
    res = fused_cg(op.MdagM_pairs, b, tol=1e-6, maxiter=500)
    torch.cuda.synchronize()
    assert res.converged and abs(res.iters - ref.iters) <= 1
    assert ph.slab_exchange_bidir.launches == 12 * res.iters
    assert wpp.dslash_eo_pallas_packed.launches == 32 * res.iters
    assert bpl.cg_update_norm2_pallas.launches == 8 * res.iters
    x = op.gather(res.x)
    assert float((x - ref.x).norm() / ref.x.norm()) < 1e-5
