"""The port stands alone, and its kernel wrappers never fall back.

* No module of quda_tpu_torch, and not chip_smoke.py, imports jax, jaxlib
  or the JAX package (AST scan).
* A request for the card that a wrapper cannot serve raises; it never
  reaches the plain version (single- and multi-RHS wrappers, and the
  staggered hops, alike).  The device check is mocked, since this host
  may have no card.
* chip_smoke.py exits non-zero and prints no result without a card, or
  alone in a directory without the package.
"""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from quda_tpu_torch.ops import blas
from quda_tpu_torch.ops import blas_pallas as bpl
from quda_tpu_torch.ops import clover_pallas as clp
from quda_tpu_torch.ops import coarse_pallas as cop
from quda_tpu_torch.ops import staggered_pallas as spl
from quda_tpu_torch.ops import wilson_pallas_packed as wpp
from quda_tpu_torch.parallel import halo as qhalo
from quda_tpu_torch.parallel import mesh as qmesh
from quda_tpu_torch.parallel import pallas_halo as qph
from quda_tpu_torch.utils import kernels

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "quda_tpu"}
DIMS = (4, 2, 2, 4)                      # (T, Z, Y, X)
SITES = (4, 2, 2 * 2)


def _absolute_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((REPO / "quda_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    scanned = {str(f.relative_to(REPO)) for f in files}
    assert {f"quda_tpu_torch/{m}.py" for m in (
        "models/twisted", "models/domain_wall", "models/hasenbusch",
        "models/formsel", "ops/dwf", "ops/dwf_pallas", "gauge/heatbath",
        "gauge/smear", "gauge/observables", "solvers/gcr", "mg/mg",
        "mg/pair", "mg/gemm", "mg/coarse", "mg/transfer",
        "ops/coarse_pallas", "utils/tune", "utils/config",
        "ops/wilson_pallas", "ops/clover_pallas", "parallel/mesh",
        "parallel/halo", "parallel/pallas_halo",
        "parallel/pallas_dslash")} <= scanned
    bad = [(str(f.relative_to(REPO)), m) for f in files
           for m in _absolute_imports(f) if m.split(".")[0] in FORBIDDEN]
    assert bad == []


@pytest.fixture
def card_request(monkeypatch):
    """Wrappers see these CPU tensors as card tensors; the kernel library
    cannot load, and reaching a plain version fails the test."""
    monkeypatch.setattr(kernels, "dispatch_device", lambda *t: "cuda")

    def no_library():
        raise RuntimeError("kernel library unavailable")

    def plain_reached(*args, **kwargs):
        raise AssertionError("plain version reached on a card request")

    monkeypatch.setattr(kernels, "library", no_library)
    monkeypatch.setattr(wpp, "dslash_eo_packed_plain", plain_reached)
    monkeypatch.setattr(blas, "triple_cg_update", plain_reached)
    monkeypatch.setattr(bpl, "axpy_norm2_plain", plain_reached)
    monkeypatch.setattr(clp, "dslash_eo_post_plain", plain_reached)
    monkeypatch.setattr(clp, "dslash_eo_diag_hop_plain", plain_reached)
    monkeypatch.setattr(wpp, "dslash_eo_packed_mrhs_plain", plain_reached)
    monkeypatch.setattr(clp, "dslash_eo_post_mrhs_plain", plain_reached)
    monkeypatch.setattr(clp, "dslash_eo_diag_hop_mrhs_plain", plain_reached)
    monkeypatch.setattr(spl, "dslash_staggered_eo_fused_plain",
                        plain_reached)
    monkeypatch.setattr(spl, "dslash_staggered_eo_pass_plain", plain_reached)
    monkeypatch.setattr(spl, "dslash_staggered_eo_pass_mrhs_plain",
                        plain_reached)
    monkeypatch.setattr(wpp, "dslash_packed_plain", plain_reached)
    monkeypatch.setattr(wpp, "dslash_packed_mrhs_plain", plain_reached)
    monkeypatch.setattr(cop, "coarse_apply_ref", plain_reached)
    monkeypatch.setattr(cop, "coarse_apply_mrhs_ref", plain_reached)
    monkeypatch.setattr(spl, "dslash_staggered_pass_plain", plain_reached)
    monkeypatch.setattr(spl, "dslash_staggered_pass_mrhs_plain",
                        plain_reached)
    monkeypatch.setattr(spl, "dslash_staggered_fused_plain", plain_reached)
    monkeypatch.setattr(qph, "slab_exchange_plain", plain_reached)
    monkeypatch.setattr(qph, "wilson_axis_halo_plain", plain_reached)
    monkeypatch.setattr(qph, "_permute_slice", plain_reached)
    monkeypatch.setattr(qhalo, "_permute_slice", plain_reached)


def _hop_args(dtype=torch.float32, rows=3):
    return (torch.zeros((4, rows, 3, 2) + SITES, dtype=dtype),
            torch.zeros((4, rows, 3, 2) + SITES, dtype=dtype),
            torch.zeros((4, 3, 2) + SITES, dtype=dtype))


def test_eo_hop_wrapper_raises_on_card_request(card_request):
    n0 = wpp.dslash_eo_pallas_packed.launches
    by_form = dict(wpp.dslash_eo_pallas_packed.launches_by_form)
    with pytest.raises(RuntimeError, match="unavailable"):
        wpp.dslash_eo_pallas_packed(*_hop_args(), DIMS, 0)
    # float64 has one instance, full:f64->f64: it reaches the kernel, and
    # the double forms without an instance raise
    with pytest.raises(RuntimeError, match="unavailable"):
        wpp.dslash_eo_pallas_packed(*_hop_args(torch.float64), DIMS, 0)
    with pytest.raises(TypeError, match="f64"):
        wpp.dslash_eo_pallas_packed(*_hop_args(torch.float64), DIMS, 0,
                                    out_dtype=torch.float32)
    with pytest.raises(TypeError, match="f64"):
        wpp.dslash_eo_pallas_packed(*_hop_args(torch.float64, rows=2),
                                    DIMS, 0)
    with pytest.raises(TypeError):
        wpp.dslash_eo_pallas_packed(*_hop_args(torch.float16), DIMS, 0)
    u, ubw, psi = _hop_args()
    with pytest.raises(ValueError):
        wpp.dslash_eo_pallas_packed(u, ubw, psi.transpose(-1, -2), DIMS, 0)
    with pytest.raises(RuntimeError, match="unavailable"):
        wpp.dslash_eo_pallas_packed(*_hop_args(torch.bfloat16, rows=2),
                                    DIMS, 0, out_dtype=torch.float32)
    with pytest.raises(ValueError, match="R = 3"):
        wpp.dslash_eo_pallas_packed(*_hop_args(rows=1), DIMS, 0)
    with pytest.raises(TypeError, match="no kernel instance"):
        wpp.dslash_eo_pallas_packed(*_hop_args(), DIMS, 0,
                                    out_dtype=torch.bfloat16)
    u, ubw, psi = _hop_args(torch.bfloat16)
    with pytest.raises(TypeError):
        wpp.dslash_eo_pallas_packed(u, ubw, psi.float(), DIMS, 0)
    assert wpp.dslash_eo_pallas_packed.launches == n0
    assert wpp.dslash_eo_pallas_packed.launches_by_form == by_form


def _counts():
    return [(f.launches, dict(f.launches_by_form)) for f in
            (clp.dslash_eo_pallas_post, clp.dslash_eo_pallas_diag_hop)]


def test_clover_hop_wrappers_raise_on_card_request(card_request):
    n0 = _counts()
    f32, bf16 = torch.float32, torch.bfloat16
    for dtype, rows in ((f32, 3), (f32, 2), (bf16, 3), (bf16, 2)):
        u, ubw, psi = _hop_args(dtype, rows)
        blk = torch.zeros((2, 6, 6, 2) + SITES, dtype=dtype)
        with pytest.raises(RuntimeError, match="unavailable"):
            clp.dslash_eo_pallas_post(u, ubw, psi, DIMS, 0, blk_pl=blk)
        with pytest.raises(RuntimeError, match="unavailable"):
            clp.dslash_eo_pallas_diag_hop(u, ubw, psi, psi, DIMS, 1,
                                          hop_coeff=-0.01, blk_pl=blk,
                                          out_dtype=f32)
    u, ubw, psi = _hop_args()
    blk = torch.zeros((2, 6, 6, 2) + SITES)
    with pytest.raises(TypeError, match="no kernel instance"):
        clp.dslash_eo_pallas_post(u, ubw, psi, DIMS, 0, blk_pl=blk,
                                  out_dtype=bf16)
    with pytest.raises(TypeError, match="no kernel instance"):
        clp.dslash_eo_pallas_diag_hop(*_hop_args(bf16), psi.to(bf16), DIMS,
                                      0, hop_coeff=-0.01,
                                      blk_pl=blk.to(bf16))
    with pytest.raises(ValueError, match="blk_pl"):
        clp.dslash_eo_pallas_post(u, ubw, psi, DIMS, 0, blk_pl=blk[:1])
    with pytest.raises(TypeError):
        clp.dslash_eo_pallas_post(u, ubw, psi, DIMS, 0,
                                  blk_pl=blk.to(bf16))
    with pytest.raises(ValueError, match="xc_pl"):
        clp.dslash_eo_pallas_diag_hop(u, ubw, psi, psi[:2], DIMS, 0,
                                      hop_coeff=-0.01, blk_pl=blk,
                                      out_dtype=f32)
    # the twist epilogues reach the kernel too (K1 block-free, K2 with and
    # without blocks); an epilogue with neither blocks nor a twist, and K1
    # with both, have no instance
    for dtype in (f32, bf16):
        u, ubw, psi = _hop_args(dtype)
        with pytest.raises(RuntimeError, match="unavailable"):
            clp.dslash_eo_pallas_post(u, ubw, psi, DIMS, 0,
                                      twist=(0.1, 0.99))
        for b in (blk.to(dtype), None):
            with pytest.raises(RuntimeError, match="unavailable"):
                clp.dslash_eo_pallas_diag_hop(u, ubw, psi, psi, DIMS, 1,
                                              hop_coeff=-0.01, blk_pl=b,
                                              diag_twist=0.1, out_dtype=f32)
    u, ubw, psi = _hop_args()
    with pytest.raises(ValueError, match="blocks .* or a twist"):
        clp.dslash_eo_pallas_post(u, ubw, psi, DIMS, 0, blk_pl=None)
    with pytest.raises(ValueError, match="blocks .* or a twist"):
        clp.dslash_eo_pallas_diag_hop(u, ubw, psi, psi, DIMS, 0,
                                      hop_coeff=-0.01, out_dtype=f32)
    with pytest.raises(ValueError, match="not both"):
        clp.dslash_eo_pallas_post(u, ubw, psi, DIMS, 0, blk_pl=blk,
                                  twist=(0.1, 0.99))
    assert _counts() == n0


def _mrhs_counts():
    return [(f.launches, dict(f.launches_by_form)) for f in
            (wpp.dslash_eo_pallas_packed_mrhs, clp.dslash_eo_pallas_post_mrhs,
             clp.dslash_eo_pallas_diag_hop_mrhs)]


def test_mrhs_wrappers_raise_on_card_request(card_request):
    """B5-eo and K1/K2-mrhs: a card request without the library raises
    (full and r12 links), and so do forms without a kernel instance
    (bf16, ROADMAP B5), chunk widths without one and wrong shapes; nothing
    is counted."""
    n0 = _mrhs_counts()
    f32, bf16 = torch.float32, torch.bfloat16
    blk = torch.zeros((2, 6, 6, 2) + SITES)
    for rows in (3, 2):
        u, ubw, psi = _hop_args(f32, rows)
        psi_b = torch.zeros((3,) + tuple(psi.shape))
        with pytest.raises(RuntimeError, match="unavailable"):
            wpp.dslash_eo_pallas_packed_mrhs(u, ubw, psi_b, DIMS, 1)
        with pytest.raises(RuntimeError, match="unavailable"):
            clp.dslash_eo_pallas_post_mrhs(u, ubw, psi_b, DIMS, 0,
                                           blk_pl=blk)
        with pytest.raises(RuntimeError, match="unavailable"):
            clp.dslash_eo_pallas_diag_hop_mrhs(u, ubw, psi_b, psi_b, DIMS, 1,
                                               hop_coeff=-0.01, blk_pl=blk,
                                               out_dtype=f32)
    u, ubw, psi = _hop_args(bf16)
    psi_b = psi[None]
    with pytest.raises(TypeError, match="ROADMAP B5"):
        wpp.dslash_eo_pallas_packed_mrhs(u, ubw, psi_b, DIMS, 0)
    with pytest.raises(TypeError, match="ROADMAP B5"):
        clp.dslash_eo_pallas_post_mrhs(u, ubw, psi_b, DIMS, 0,
                                       blk_pl=blk.to(bf16))
    u, ubw, psi = _hop_args()
    psi_b = psi[None]
    with pytest.raises(ValueError, match="chunk"):
        wpp.dslash_eo_pallas_packed_mrhs(u, ubw, psi_b, DIMS, 0, chunk=3)
    with pytest.raises(ValueError, match="psi_pl"):
        wpp.dslash_eo_pallas_packed_mrhs(u, ubw, psi_b[..., :2], DIMS, 0)
    with pytest.raises(ValueError, match="xc_pl"):
        clp.dslash_eo_pallas_diag_hop_mrhs(u, ubw, psi_b, psi_b[..., :2],
                                           DIMS, 0, hop_coeff=-0.01,
                                           blk_pl=blk, out_dtype=f32)
    with pytest.raises(TypeError, match="ROADMAP B5"):
        clp.dslash_eo_pallas_diag_hop_mrhs(u, ubw, psi_b, psi_b, DIMS, 0,
                                           hop_coeff=-0.01, blk_pl=blk,
                                           out_dtype=bf16)
    with pytest.raises(RuntimeError, match="unavailable"):
        clp.dslash_eo_pallas_post_mrhs(u, ubw, psi_b, DIMS, 0,
                                       twist=(0.1, 0.99))
    with pytest.raises(ValueError, match="not both"):
        clp.dslash_eo_pallas_post_mrhs(u, ubw, psi_b, DIMS, 0, blk_pl=blk,
                                       twist=(0.1, 0.99))
    for b in (blk, None):
        with pytest.raises(RuntimeError, match="unavailable"):
            clp.dslash_eo_pallas_diag_hop_mrhs(u, ubw, psi_b, psi_b, DIMS, 1,
                                               hop_coeff=-0.01, blk_pl=b,
                                               diag_twist=0.1, out_dtype=f32)
    with pytest.raises(ValueError, match="blocks .* or a twist"):
        clp.dslash_eo_pallas_post_mrhs(u, ubw, psi_b, DIMS, 0)
    assert _mrhs_counts() == n0


def test_mrhs_wrappers_reject_other_devices():
    u, ubw, psi = _hop_args()
    psi_b = psi[None]
    blk = torch.zeros((2, 6, 6, 2) + SITES)
    with pytest.raises(ValueError, match="meta"):
        wpp.dslash_eo_pallas_packed_mrhs(u.to("meta"), ubw.to("meta"),
                                         psi_b.to("meta"), DIMS, 0)
    with pytest.raises(ValueError, match="several devices"):
        clp.dslash_eo_pallas_post_mrhs(u, ubw, psi_b.to("meta"), DIMS, 0,
                                       blk_pl=blk)
    with pytest.raises(ValueError, match="several devices"):
        clp.dslash_eo_pallas_diag_hop_mrhs(u, ubw, psi_b, psi_b.to("meta"),
                                           DIMS, 0, hop_coeff=-0.01,
                                           blk_pl=blk)


def _stag_counts():
    return [(f.launches, dict(f.launches_by_form)) for f in
            (spl.dslash_staggered_eo_pallas_fused,
             spl.dslash_staggered_eo_pass)]


def test_staggered_wrappers_raise_on_card_request(card_request):
    """S1 and S2 (and the two-pass composition): a card request without
    the library raises for every form; forms without a kernel instance,
    recon-12 links, a wrong nhop and strided tensors raise before any
    launch; nothing is counted."""
    n0 = _stag_counts()
    f32, bf16 = torch.float32, torch.bfloat16
    for dtype in (f32, bf16):
        u = torch.zeros((4, 3, 3, 2) + SITES, dtype=dtype)
        psi = torch.zeros((3, 2) + SITES, dtype=dtype)
        for out in {dtype, f32}:
            with pytest.raises(RuntimeError, match="unavailable"):
                spl.dslash_staggered_eo_pallas_fused(u, u, psi, DIMS, 0, u, u,
                                                     out_dtype=out)
            for nhop in (1, 3):
                with pytest.raises(RuntimeError, match="unavailable"):
                    spl.dslash_staggered_eo_pass(u, u, psi, DIMS, 1, nhop,
                                                 out_dtype=out)
        with pytest.raises(RuntimeError, match="unavailable"):
            spl.dslash_staggered_eo_pallas(u, u, psi, DIMS, 0, u, u)
    u = torch.zeros((4, 3, 3, 2) + SITES)
    psi = torch.zeros((3, 2) + SITES)
    with pytest.raises(TypeError, match="no kernel instance"):
        spl.dslash_staggered_eo_pallas_fused(u, u, psi, DIMS, 0, u, u,
                                             out_dtype=bf16)
    with pytest.raises(NotImplementedError, match="ROADMAP C"):
        spl.dslash_staggered_eo_pallas_fused(u, u, psi, DIMS, 0, u[:, :2],
                                             u)
    with pytest.raises(ValueError, match="nhop"):
        spl.dslash_staggered_eo_pass(u, u, psi, DIMS, 0, 2)
    strided = torch.zeros((3, 2, SITES[0], SITES[2], SITES[1]))
    with pytest.raises(ValueError, match="contiguous"):
        spl.dslash_staggered_eo_pass(u, u, strided.transpose(-1, -2), DIMS,
                                     0, 1)
    with pytest.raises(ValueError, match="psi_pl"):
        spl.dslash_staggered_eo_pass(u, u, psi[..., :2], DIMS, 0, 1)
    with pytest.raises(TypeError):
        spl.dslash_staggered_eo_pallas_fused(u, u, psi.to(bf16), DIMS, 0,
                                             u, u)
    assert _stag_counts() == n0


def test_staggered_mrhs_wrapper_raises_on_card_request(card_request):
    """S2-mrhs (and its fat + Naik composition): a card request without
    the library raises for both hop counts, accumulating or not; bf16
    psi, recon-12 links, a missing RHS axis, an empty batch and a
    mis-shaped accumulator raise before any launch; nothing is counted."""
    fn = spl.dslash_staggered_eo_pass_mrhs
    n0 = (fn.launches, dict(fn.launches_by_form))
    u = torch.zeros((4, 3, 3, 2) + SITES)
    psi_b = torch.zeros((3, 3, 2) + SITES)
    for nhop in (1, 3):
        with pytest.raises(RuntimeError, match="unavailable"):
            fn(u, u, psi_b, DIMS, 0, nhop)
        with pytest.raises(RuntimeError, match="unavailable"):
            fn(u, u, psi_b, DIMS, 1, nhop, acc=torch.zeros_like(psi_b))
    with pytest.raises(RuntimeError, match="unavailable"):
        spl.dslash_staggered_eo_pallas_mrhs(u, u, psi_b, DIMS, 0, u, u)
    with pytest.raises(TypeError, match="float32"):
        fn(u.bfloat16(), u.bfloat16(), psi_b.bfloat16(), DIMS, 0, 1)
    with pytest.raises(NotImplementedError, match="ROADMAP C"):
        fn(u[:, :2].contiguous(), u, psi_b, DIMS, 0, 3)
    with pytest.raises(ValueError, match="N, 3, 2"):
        fn(u, u, psi_b[0], DIMS, 0, 1)
    with pytest.raises(ValueError, match="right-hand sides"):
        fn(u, u, psi_b[:0], DIMS, 0, 1)
    with pytest.raises(ValueError, match="acc"):
        fn(u, u, psi_b, DIMS, 0, 3, acc=torch.zeros_like(psi_b[:2]))
    assert (fn.launches, dict(fn.launches_by_form)) == n0


def test_full_hop_wrapper_raises_on_card_request(card_request):
    """B4: a card request without the library raises for full and r12
    float32 and full float64 links; bf16, recon-12 under float64, mixed
    dtypes and a fused axis that is not a multiple of X raise before any
    launch; nothing is counted."""
    fn = wpp.dslash_pallas_packed
    n0 = (fn.launches, dict(fn.launches_by_form))
    full = (4, 2, 2 * 4)                   # (T, Z, Y*X) of a 4x2x2x4 lattice
    for dtype, rows in ((torch.float32, 3), (torch.float32, 2),
                        (torch.float64, 3)):
        u = torch.zeros((4, rows, 3, 2) + full, dtype=dtype)
        psi = torch.zeros((4, 3, 2) + full, dtype=dtype)
        with pytest.raises(RuntimeError, match="unavailable"):
            fn(u, psi, 4, gauge_bw=u)
    u = torch.zeros((4, 3, 3, 2) + full)
    psi = torch.zeros((4, 3, 2) + full)
    with pytest.raises(TypeError):
        fn(u.bfloat16(), psi.bfloat16(), 4, gauge_bw=u.bfloat16())
    with pytest.raises(TypeError, match="f64"):
        u2 = torch.zeros((4, 2, 3, 2) + full, dtype=torch.float64)
        fn(u2, psi.double(), 4, gauge_bw=u2)
    with pytest.raises(TypeError):
        fn(u, psi.double(), 4, gauge_bw=u)
    with pytest.raises(ValueError, match="multiple of X"):
        fn(u, psi, 3, gauge_bw=u)
    assert (fn.launches, dict(fn.launches_by_form)) == n0


FULL_SITES = (4, 2, 2 * 4)                # (T, Z, Y*X) of a 4x2x2x4 lattice


def _stag_full_counts():
    return [(f.launches, dict(f.launches_by_form)) for f in
            (spl.dslash_staggered_pass, spl.dslash_staggered_pass_mrhs,
             spl.dslash_staggered_pallas_fused)]


def test_staggered_full_wrappers_raise_on_card_request(card_request):
    """S2-full, S2-mrhs-full and S1-full (and their fat + Naik
    compositions): a card request without the library raises for both hop
    counts, accumulating or not; bf16, recon-12 links, a wrong nhop, a
    fused axis that is not a multiple of X, a missing RHS axis, an empty
    batch, a mis-shaped accumulator and a missing long link set raise
    before any launch; nothing is counted and no plain version runs."""
    n0 = _stag_full_counts()
    u = torch.zeros((4, 3, 3, 2) + FULL_SITES)
    psi = torch.zeros((3, 2) + FULL_SITES)
    psi_b = torch.zeros((3, 3, 2) + FULL_SITES)
    for nhop in (1, 3):
        with pytest.raises(RuntimeError, match="unavailable"):
            spl.dslash_staggered_pass(u, u, psi, 4, nhop)
        with pytest.raises(RuntimeError, match="unavailable"):
            spl.dslash_staggered_pass_mrhs(u, u, psi_b, 4, nhop)
        with pytest.raises(RuntimeError, match="unavailable"):
            spl.dslash_staggered_pass_mrhs(u, u, psi_b, 4, nhop,
                                           acc=torch.zeros_like(psi_b))
    with pytest.raises(RuntimeError, match="unavailable"):
        spl.dslash_staggered_pallas_fused(u, psi, 4, u)
    with pytest.raises(RuntimeError, match="unavailable"):
        spl.dslash_staggered_pallas(u, u, psi, 4, u, u)
    with pytest.raises(RuntimeError, match="unavailable"):
        spl.dslash_staggered_pallas_mrhs(u, u, psi_b, 4, u, u)
    with pytest.raises(TypeError):
        spl.dslash_staggered_pass(u.bfloat16(), u.bfloat16(),
                                  psi.bfloat16(), 4, 1)
    with pytest.raises(TypeError, match="float32"):
        spl.dslash_staggered_pass_mrhs(u, u, psi_b.double(), 4, 1)
    with pytest.raises(TypeError):
        spl.dslash_staggered_pallas_fused(u.double(), psi.double(), 4,
                                          u.double())
    with pytest.raises(NotImplementedError, match="ROADMAP C"):
        spl.dslash_staggered_pallas_fused(u, psi, 4, u[:, :2].contiguous())
    with pytest.raises(NotImplementedError, match="ROADMAP C"):
        spl.dslash_staggered_pass(u[:, :2].contiguous(), u, psi, 4, 3)
    with pytest.raises(ValueError, match="nhop"):
        spl.dslash_staggered_pass(u, u, psi, 4, 2)
    with pytest.raises(ValueError, match="multiple of X"):
        spl.dslash_staggered_pass(u, u, psi, 3, 1)
    with pytest.raises(ValueError, match="N, 3, 2"):
        spl.dslash_staggered_pass_mrhs(u, u, psi, 4, 1)
    with pytest.raises(ValueError, match="right-hand sides"):
        spl.dslash_staggered_pass_mrhs(u, u, psi_b[:0], 4, 1)
    with pytest.raises(ValueError, match="acc"):
        spl.dslash_staggered_pass_mrhs(u, u, psi_b, 4, 3,
                                       acc=torch.zeros_like(psi_b[:2]))
    with pytest.raises(ValueError, match="fat\\+Naik"):
        spl.dslash_staggered_pallas_fused(u, psi, 4)
    assert _stag_full_counts() == n0


def test_staggered_operator_routes_never_fall_back(card_request):
    """The staggered full-lattice pair operator (mat_quda's) and the fine
    staggered MG level reach the kernels on a card request: their applies
    raise for the missing library instead of running a plain stencil; the
    operator refuses float64 storage (ROADMAP A7)."""
    from quda_tpu_torch.fields.geometry import LatticeGeometry
    from quda_tpu_torch.mg.pair import PairStaggeredLevelOp
    from quda_tpu_torch.models.staggered import DiracStaggered
    n0 = _stag_full_counts()
    geom = LatticeGeometry((4, 2, 2, 4))
    lat = geom.lattice_shape
    links = torch.zeros((4,) + tuple(lat) + (3, 3), dtype=torch.complex64)
    links[..., 0, 0] = links[..., 1, 1] = links[..., 2, 2] = 1.0
    field = torch.zeros(tuple(lat) + (1, 3), dtype=torch.complex64)
    for improved in (False, True):
        d = DiracStaggered(links, geom, 0.1, improved=improved,
                           long_links=links)
        op = d.pairs()
        with pytest.raises(RuntimeError, match="unavailable"):
            op.M(field)
        with pytest.raises(RuntimeError, match="unavailable"):
            op.MdagM(field)
        lv = PairStaggeredLevelOp(d)
        v = torch.view_as_real(field).contiguous()
        with pytest.raises(RuntimeError, match="unavailable"):
            lv.M_std(v)
        with pytest.raises(RuntimeError, match="unavailable"):
            lv.M_std_full(v)
        with pytest.raises(RuntimeError, match="unavailable"):
            lv.M_mrhs(torch.stack([lv.to_chiral(v)] * 2))
        with pytest.raises(NotImplementedError, match="ROADMAP A7"):
            d.pairs(torch.float64)
    assert _stag_full_counts() == n0


def test_staggered_wrappers_reject_other_devices():
    u = torch.zeros((4, 3, 3, 2) + SITES)
    psi = torch.zeros((3, 2) + SITES)
    with pytest.raises(ValueError, match="meta"):
        spl.dslash_staggered_eo_pass(u.to("meta"), u.to("meta"),
                                     psi.to("meta"), DIMS, 0, 1)
    with pytest.raises(ValueError, match="several devices"):
        spl.dslash_staggered_eo_pallas_fused(u, u, psi.to("meta"), DIMS, 0,
                                             u, u)


def test_invert_multi_src_defaults_to_the_card():
    """Without a card, the entry point's session cannot start unless the
    caller asks for the CPU."""
    import quda_tpu_torch as qt
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default is servable")
    qt.end_quda()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        qt.init_quda()
    with pytest.raises(RuntimeError, match="init_quda"):
        qt.invert_multi_src_quda(torch.zeros(1), qt.InvertParam())


def test_cg_tail_wrapper_raises_on_card_request(card_request):
    vecs = [torch.zeros(24) for _ in range(4)]
    n0 = bpl.cg_update_norm2_pallas.launches
    with pytest.raises(RuntimeError, match="unavailable"):
        bpl.cg_update_norm2_pallas(torch.tensor(0.5), *vecs)
    # the float64 form reaches the kernel too; mixed dtypes do not
    with pytest.raises(RuntimeError, match="unavailable"):
        bpl.cg_update_norm2_pallas(torch.tensor(0.5, dtype=torch.float64),
                                   *(v.double() for v in vecs))
    with pytest.raises(TypeError):
        bpl.cg_update_norm2_pallas(torch.tensor(0.5, dtype=torch.float64),
                                   *vecs)
    with pytest.raises(TypeError):
        bpl.cg_update_norm2_pallas(torch.tensor(0.5, dtype=torch.bfloat16),
                                   *(v.bfloat16() for v in vecs))
    with pytest.raises(ValueError):
        bpl.cg_update_norm2_pallas(torch.zeros(2), *vecs)
    with pytest.raises(ValueError):
        bpl.cg_update_norm2_pallas(torch.tensor(0.5), torch.zeros(12),
                                   *vecs[1:])
    assert bpl.cg_update_norm2_pallas.launches == n0


def test_axpy_norm2_wrapper_raises_on_card_request(card_request):
    n0 = bpl.axpy_norm2_pallas.launches
    a = torch.tensor(0.5)
    with pytest.raises(RuntimeError, match="unavailable"):
        bpl.axpy_norm2_pallas(a, torch.zeros(24), torch.zeros(24))
    with pytest.raises(RuntimeError, match="unavailable"):
        bpl.axpy_norm2_pallas(a, torch.zeros(24, dtype=torch.bfloat16),
                              torch.zeros(24, dtype=torch.bfloat16))
    with pytest.raises(TypeError):
        bpl.axpy_norm2_pallas(a, torch.zeros(24, dtype=torch.float64),
                              torch.zeros(24, dtype=torch.float64))
    with pytest.raises(TypeError):
        bpl.axpy_norm2_pallas(a, torch.zeros(24),
                              torch.zeros(24, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        bpl.axpy_norm2_pallas(torch.zeros(2), torch.zeros(24),
                              torch.zeros(24))
    with pytest.raises(ValueError):
        bpl.axpy_norm2_pallas(a, torch.zeros(24)[1:13],
                              torch.zeros(24).reshape(2, 12).t())
    assert bpl.axpy_norm2_pallas.launches == n0


def test_wrappers_reject_other_devices():
    meta = [t.to("meta") for t in _hop_args()]
    with pytest.raises(ValueError, match="meta"):
        wpp.dslash_eo_pallas_packed(*meta, DIMS, 0)
    with pytest.raises(ValueError, match="several devices"):
        bpl.cg_update_norm2_pallas(torch.tensor(0.5), torch.zeros(4),
                                   torch.zeros(4), torch.zeros(4),
                                   torch.zeros(4, device="meta"))


def test_clover_wrappers_reject_other_devices():
    u, ubw, psi = _hop_args()
    blk = torch.zeros((2, 6, 6, 2) + SITES)
    with pytest.raises(ValueError, match="meta"):
        clp.dslash_eo_pallas_post(u.to("meta"), ubw.to("meta"),
                                  psi.to("meta"), DIMS, 0,
                                  blk_pl=blk.to("meta"))
    with pytest.raises(ValueError, match="several devices"):
        clp.dslash_eo_pallas_diag_hop(u, ubw, psi, psi.to("meta"), DIMS, 0,
                                      hop_coeff=-0.01, blk_pl=blk)


def test_chip_smoke_without_card_or_package_prints_no_result(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        try:
            assert not json.loads(line).get("ok")
        except (ValueError, AttributeError):
            continue


def test_full_hop_mrhs_and_coarse_wrappers_raise_on_card_request(
        card_request):
    """B5 (full and r12 links) and B8 (single and multi-RHS): a card
    request without the library raises and never reaches the plain
    version; bf16 or f64, chunk widths without an instance and wrong
    shapes raise; nothing is counted."""
    n_b5 = wpp.dslash_pallas_packed_mrhs.launches
    n_b8 = cop.coarse_apply_pallas.launches
    n_b8m = cop.coarse_apply_pallas_mrhs.launches
    sites = (4, 2, 2 * 4)
    X = 4
    for rows in (3, 2):
        u = torch.zeros((4, rows, 3, 2) + sites)
        psi = torch.zeros((3, 4, 3, 2) + sites)
        with pytest.raises(RuntimeError, match="unavailable"):
            wpp.dslash_pallas_packed_mrhs(u, psi, X, gauge_bw=u.clone())
    u = torch.zeros((4, 3, 3, 2) + sites)
    psi = torch.zeros((3, 4, 3, 2) + sites)
    with pytest.raises(TypeError, match="float32"):
        wpp.dslash_pallas_packed_mrhs(u.bfloat16(), psi.bfloat16(), X,
                                      gauge_bw=u.bfloat16())
    with pytest.raises(ValueError, match="chunk"):
        wpp.dslash_pallas_packed_mrhs(u, psi, X, gauge_bw=u, chunk=4)
    with pytest.raises(ValueError, match="gauge_pl"):
        wpp.dslash_pallas_packed_mrhs(u[..., :4], psi, X,
                                      gauge_bw=u[..., :4])
    with pytest.raises(ValueError, match="N, 4, 3, 2"):
        wpp.dslash_pallas_packed_mrhs(u, psi[0], X, gauge_bw=u)
    links = torch.zeros((9, 5, 20, 20))
    psi9 = torch.zeros((9, 5, 20))
    with pytest.raises(RuntimeError, match="unavailable"):
        cop.coarse_apply_pallas(links, psi9)
    with pytest.raises(TypeError, match="float32"):
        cop.coarse_apply_pallas(links.double(), psi9.double())
    with pytest.raises(ValueError, match="links of shape"):
        cop.coarse_apply_pallas(links[:, :, :19], psi9)
    with pytest.raises(ValueError, match="psi9 of shape"):
        cop.coarse_apply_pallas(links, psi9[:8])
    with pytest.raises(ValueError, match="contiguous"):
        cop.coarse_apply_pallas(links.transpose(-1, -2), psi9)
    psi9_b = torch.zeros((3, 9, 5, 20))
    with pytest.raises(RuntimeError, match="unavailable"):
        cop.coarse_apply_pallas_mrhs(links, psi9_b)
    with pytest.raises(TypeError, match="float32"):
        cop.coarse_apply_pallas_mrhs(links.double(), psi9_b.double())
    with pytest.raises(ValueError, match="psi9 of shape"):
        cop.coarse_apply_pallas_mrhs(links, psi9)
    big = cop.MAX_E_MRHS + 4
    with pytest.raises(ValueError, match="E ="):
        cop.coarse_apply_pallas_mrhs(torch.zeros((9, 1, big, big)),
                                     torch.zeros((2, 9, 1, big)))
    assert wpp.dslash_pallas_packed_mrhs.launches == n_b5
    assert cop.coarse_apply_pallas.launches == n_b8
    assert cop.coarse_apply_pallas_mrhs.launches == n_b8m


def test_fold_and_v3_wrappers_raise_on_card_request(card_request,
                                                    monkeypatch):
    """The fold hop, the multi-RHS fold hop, S1-fold and the v3 pass (and
    the improved v3 composition): a card request without the library
    raises for every form and never reaches a plain version; float64,
    bf16 batches (A7), recon-12 or missing Naik links on S1-fold, an acc
    on the fat pass and wrong shapes raise; nothing is counted."""
    def plain_reached(*args, **kwargs):
        raise AssertionError("plain version reached on a card request")

    for mod, name in ((wpp, "dslash_eo_fold_plain"),
                      (wpp, "dslash_eo_fold_mrhs_plain"),
                      (spl, "dslash_staggered_eo_fused_fold_plain"),
                      (spl, "dslash_staggered_eo_pass_v3_plain")):
        monkeypatch.setattr(mod, name, plain_reached)
    fns = (wpp.dslash_eo_pallas_packed_fold,
           wpp.dslash_eo_pallas_packed_fold_mrhs,
           spl.dslash_staggered_eo_pallas_fused_fold,
           spl.dslash_staggered_eo_pass_v3)
    n0 = [f.launches for f in fns]
    f32, bf16 = torch.float32, torch.bfloat16
    T, Z, YXh = SITES
    fsites = (T, 2 * Z, YXh)
    for rows in (3, 2):
        for store, out in ((f32, f32), (bf16, bf16), (bf16, f32)):
            u = torch.zeros((4, rows, 3) + fsites, dtype=store)
            psi = torch.zeros((4, 3) + fsites, dtype=store)
            with pytest.raises(RuntimeError, match="unavailable"):
                fns[0](u, u, psi, DIMS, 0, out_dtype=out)
        u = torch.zeros((4, rows, 3) + fsites)
        with pytest.raises(RuntimeError, match="unavailable"):
            fns[1](u, u, torch.zeros((3, 4, 3) + fsites), DIMS, 1)
    u = torch.zeros((4, 3, 3) + fsites)
    psi = torch.zeros((4, 3) + fsites)
    with pytest.raises(TypeError, match="ROADMAP A7"):
        fns[0](u.double(), u.double(), psi.double(), DIMS, 0)
    with pytest.raises(TypeError, match="no kernel instance"):
        fns[0](u, u, psi, DIMS, 0, out_dtype=bf16)
    with pytest.raises(ValueError, match="psi_f"):
        fns[0](u, u, psi[..., :2], DIMS, 0)
    with pytest.raises(ValueError, match="R = 3 or 2"):
        fns[0](u[:, :1], u[:, :1], psi, DIMS, 0)
    with pytest.raises(TypeError, match="ROADMAP A7"):
        fns[1](u.to(bf16), u.to(bf16), psi[None].to(bf16), DIMS, 0)
    with pytest.raises(ValueError, match="N, 4, 3, T, 2Z"):
        fns[1](u, u, psi, DIMS, 0)
    for store, out in ((f32, f32), (bf16, bf16), (bf16, f32)):
        ul = torch.zeros((4, 3, 3) + fsites, dtype=store)
        sp = torch.zeros((3,) + fsites, dtype=store)
        with pytest.raises(RuntimeError, match="unavailable"):
            fns[2](ul, ul, sp, DIMS, 1, ul, ul, out_dtype=out)
        up = torch.zeros((4, 3, 3, 2) + SITES, dtype=store)
        pp = torch.zeros((3, 2) + SITES, dtype=store)
        for nhop in (1, 3):
            with pytest.raises(RuntimeError, match="unavailable"):
                fns[3](up, up, pp, DIMS, 0, nhop, out_dtype=out)
        with pytest.raises(RuntimeError, match="unavailable"):
            spl.dslash_staggered_eo_pallas_v3(up, up, pp, DIMS, 0, up, up,
                                              out_dtype=out)
    ul = torch.zeros((4, 3, 3) + fsites)
    sp = torch.zeros((3,) + fsites)
    with pytest.raises(ValueError, match="Naik"):
        fns[2](ul, ul, sp, DIMS, 0)
    with pytest.raises(ValueError, match="full storage"):
        fns[2](ul, ul, sp, DIMS, 0, ul[:, :2], ul)
    with pytest.raises(ValueError, match="psi_f"):
        fns[2](ul, ul, sp[..., :2], DIMS, 0, ul, ul)
    up = torch.zeros((4, 3, 3, 2) + SITES)
    pp = torch.zeros((3, 2) + SITES)
    with pytest.raises(ValueError, match="acc"):
        fns[3](up, up, pp, DIMS, 0, 1, acc=pp)
    with pytest.raises(ValueError, match="acc"):
        fns[3](up, up, pp, DIMS, 0, 3, acc=pp[..., :2])
    with pytest.raises(NotImplementedError, match="ROADMAP C"):
        fns[3](up[:, :2], up, pp, DIMS, 0, 3)
    with pytest.raises(TypeError, match="no kernel instance"):
        fns[3](up, up, pp, DIMS, 0, 1, out_dtype=bf16)
    assert [f.launches for f in fns] == n0


def test_import_builds_nothing_and_pulls_in_no_jax(tmp_path):
    """Importing the package and the tuner, the canonical hop's and the
    full-lattice clover operator's modules (and running the tuner's
    warm start) pulls in no jax and no quda_tpu, loads no kernel library
    and builds nothing."""
    code = (
        "import sys\n"
        "import quda_tpu_torch\n"
        "from quda_tpu_torch.utils import kernels, tune\n"
        "from quda_tpu_torch.ops import clover_pallas, wilson_pallas\n"
        "from quda_tpu_torch.models import clover, twisted, domain_wall\n"
        "from quda_tpu_torch.interfaces import quda_api\n"
        "tune.warm_start()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'quda_tpu'))\n"
        "assert bad == [], bad\n"
        "assert kernels._loaded == {}\n"
        "print('clean')\n")
    root = REPO / "quda_tpu_torch" / "_build"
    before = sorted(root.iterdir()) if root.exists() else []
    env = dict(os.environ, PYTHONPATH=str(REPO),
               QUDA_TORCH_RESOURCE_PATH=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
    assert (sorted(root.iterdir()) if root.exists() else []) == before


def test_full_lattice_kernels_raise_on_card_request(card_request,
                                                    monkeypatch):
    """B10 (the copy-free full-lattice hop), B11 (the canonical-layout
    hop) and B7 full (the full-lattice clover operator): a card request
    without the library raises for every form and never reaches a plain
    version; float64 (B10, B7), mixed complex dtypes (B11), wrong shapes
    and a fused axis that is not a multiple of X raise; nothing is
    counted."""
    from quda_tpu_torch.ops import wilson_pallas as wpl

    def plain_reached(*args, **kwargs):
        raise AssertionError("plain version reached on a card request")

    for mod, name in ((wpp, "dslash_packed_v3_plain"),
                      (clp, "clover_packed_plain"),
                      (wpl, "dslash_canonical_plain")):
        monkeypatch.setattr(mod, name, plain_reached)
    fns = (wpp.dslash_pallas_packed_v3, clp.clover_pallas_packed,
           wpl.dslash_pallas)
    n0 = [(f.launches, dict(f.launches_by_form)) for f in fns]
    full = FULL_SITES
    blk = torch.zeros((2, 6, 6, 2) + full)
    for rows in (3, 2):
        u = torch.zeros((4, rows, 3, 2) + full)
        psi = torch.zeros((4, 3, 2) + full)
        with pytest.raises(RuntimeError, match="unavailable"):
            fns[0](u, psi, 4)
        for twist in (None, 0.1):
            with pytest.raises(RuntimeError, match="unavailable"):
                fns[1](u, blk, psi, 4, 0.12, diag_twist=twist, gauge_bw=u)
    u = torch.zeros((4, 3, 3, 2) + full)
    psi = torch.zeros((4, 3, 2) + full)
    with pytest.raises(TypeError, match="float32"):
        fns[0](u.double(), psi.double(), 4)
    with pytest.raises(ValueError, match="multiple of X"):
        fns[0](u, psi, 3)
    with pytest.raises(ValueError, match="psi_pl"):
        fns[0](u, psi[..., :4], 4)
    with pytest.raises(TypeError, match="ROADMAP A7"):
        fns[1](u.double(), blk.double(), psi.double(), 4, 0.12,
               gauge_bw=u.double())
    with pytest.raises(ValueError, match="blk_pl"):
        fns[1](u, blk[:1], psi, 4, 0.12, gauge_bw=u)
    lat = (4, 2, 2, 4)
    for cdt in (torch.complex64, torch.complex128):
        g = torch.zeros((4,) + lat + (3, 3), dtype=cdt)
        field = torch.zeros(lat + (4, 3), dtype=cdt)
        with pytest.raises(RuntimeError, match="unavailable"):
            fns[2](g, field)
    with pytest.raises(TypeError, match="one dtype"):
        fns[2](g, field.to(torch.complex64))
    with pytest.raises(TypeError, match="complex64 or complex128"):
        fns[2](g.real.contiguous(), field.real.contiguous())
    with pytest.raises(ValueError, match="psi"):
        fns[2](g, field[..., :2, :])
    assert [(f.launches, dict(f.launches_by_form)) for f in fns] == n0


def test_operator_api_new_families_never_fall_back(card_request):
    """The full-lattice pair companions of clover, twisted clover and
    twisted mass reach their kernels on a card request (the full-lattice
    clover operator, B4): their applies raise for the missing library;
    the clover companion refuses float64 (ROADMAP A7)."""
    from quda_tpu_torch.fields.geometry import LatticeGeometry
    from quda_tpu_torch.models.clover import DiracClover
    from quda_tpu_torch.models.twisted import (DiracTwistedClover,
                                               DiracTwistedMass)
    geom = LatticeGeometry((4, 2, 2, 4))
    lat = geom.lattice_shape
    links = torch.zeros((4,) + tuple(lat) + (3, 3), dtype=torch.complex64)
    links[..., 0, 0] = links[..., 1, 1] = links[..., 2, 2] = 1.0
    field = torch.zeros(tuple(lat) + (4, 3), dtype=torch.complex64)
    n0 = (clp.clover_pallas_packed.launches,
          wpp.dslash_pallas_packed.launches)
    for d in (DiracClover(links, geom, 0.12, 1.0),
              DiracTwistedClover(links, geom, 0.12, 0.1, 1.0),
              DiracTwistedMass(links, geom, 0.12, 0.1)):
        op = d.pairs()
        for apply in (op.M, op.Mdag, op.MdagM):
            with pytest.raises(RuntimeError, match="unavailable"):
                apply(field)
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        DiracClover(links, geom, 0.12, 1.0).pairs(torch.float64)
    assert (clp.clover_pallas_packed.launches,
            wpp.dslash_pallas_packed.launches) == n0


def _cpu_mesh(grid):
    return qmesh.make_lattice_mesh(grid, devices=["cpu"] * 8)


def test_halo_wrappers_raise_on_card_request(card_request):
    """The three B12 wrappers, asked for the card without the kernel
    library, raise; none reaches its plain version or the plain
    transport, and no launch is counted."""
    mesh = _cpu_mesh((2, 2, 2, 1))
    faces = [torch.zeros((4, 3, 2, 1, 2, 4)) for _ in range(8)]
    n0 = (qph.slab_exchange_bidir.launches,
          qph.wilson_axis_fused_halo.launches,
          qph.wilson_zbwd_fused_halo.launches)
    with pytest.raises(RuntimeError, match="unavailable"):
        qph.slab_exchange_bidir(faces, faces, mesh, "t")
    zmesh = _cpu_mesh((1, 8, 1, 1))
    spec = (None, None, None, "z", None)
    psi = qmesh.shard(torch.zeros((4, 3, 2, 16, 4)), zmesh, spec)
    u = qmesh.shard(torch.zeros((3, 3, 2, 16, 4)), zmesh, spec)
    with pytest.raises(RuntimeError, match="unavailable"):
        qph.wilson_axis_fused_halo(psi, u)
    with pytest.raises(RuntimeError, match="unavailable"):
        qph.wilson_zbwd_fused_halo(psi, u)
    tmesh = _cpu_mesh((8, 1, 1, 1))
    spec_t = (None, None, None, "t", None, None)
    with pytest.raises(RuntimeError, match="unavailable"):
        qph.wilson_t_fused_halo(
            qmesh.shard(torch.zeros((4, 3, 2, 16, 2, 4)), tmesh, spec_t),
            qmesh.shard(torch.zeros((3, 3, 2, 16, 2, 4)), tmesh, spec_t))
    assert (qph.slab_exchange_bidir.launches,
            qph.wilson_axis_fused_halo.launches,
            qph.wilson_zbwd_fused_halo.launches) == n0


def test_fused_halo_policy_never_runs_the_plain_transport(card_request,
                                                          monkeypatch):
    """Under fused_halo a card request of the sharded hop reaches the
    exchange kernel on every contiguous axis (and raises without the
    library); only the x column faces take the plain transport, and only
    on the xla_facefix policy."""
    from quda_tpu_torch.parallel import pallas_dslash as pds
    reached = []
    monkeypatch.setattr(wpp, "dslash_eo_pallas_packed",
                        lambda u, b, p, *a, **k: torch.zeros_like(p))
    real = qph.slab_exchange_bidir

    def exchange(down, up, mesh, name):
        reached.append(name)
        return real(down, up, mesh, name)

    monkeypatch.setattr(qph, "slab_exchange_bidir", exchange)
    mesh = _cpu_mesh((2, 2, 2, 1))
    dims = (4, 4, 4, 8)
    sites = (4, 4, 16)
    spec = qmesh.pair_pspec(7)
    links = qmesh.shard(torch.zeros((4, 3, 3, 2) + sites), mesh, spec)
    psi = qmesh.shard(torch.zeros((4, 3, 2) + sites), mesh,
                      qmesh.pair_pspec(6))
    with pytest.raises(RuntimeError, match="unavailable"):
        pds.dslash_eo_pallas_sharded(links, links, psi, dims, 0,
                                     policy="fused_halo")
    assert reached == ["t"]


def test_auto_policy_on_a_card_request_never_runs_the_plain_transport(
        card_request, monkeypatch):
    """An operator built with the default sharded_policy="auto", asked for
    the card, sends every t/z/y face of every hop through the exchange
    kernel's wrapper; the plain transport (_permute_slice) is never
    reached."""
    from quda_tpu_torch.fields.geometry import LatticeGeometry
    from quda_tpu_torch.models.wilson import DiracWilsonPC
    from tests.torch_inputs import su3_gauge
    reached = []
    monkeypatch.setattr(wpp, "dslash_eo_pallas_packed",
                        lambda u, b, p, *a, **k: torch.zeros_like(p))

    def exchange(down, up, mesh, name):
        reached.append(name)
        return ([down[mesh.neighbor(i, name, +1)].clone() for i in
                 range(mesh.size)],
                [up[mesh.neighbor(i, name, -1)].clone() for i in
                 range(mesh.size)])

    monkeypatch.setattr(qph, "slab_exchange_bidir", exchange)
    dims = (8, 4, 4, 4)
    op = DiracWilsonPC(torch.from_numpy(su3_gauge(dims, 597)),
                       LatticeGeometry(dims), 0.12).packed().pairs(
        torch.float32, mesh=_cpu_mesh((2, 2, 2, 1)))
    x = op.shard(torch.zeros((4, 3, 2, 4, 4, 16)))
    op.MdagM_pairs(x)
    assert reached == ["t", "z", "y"] * 4


def test_mixed_cpu_cuda_mesh_is_refused():
    with pytest.raises(ValueError, match="mix"):
        qmesh.make_lattice_mesh((2, 1, 1, 1), devices=["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="mix"):
        qmesh.make_lattice_mesh((1, 2, 1, 1), devices=["cuda:0", "cpu"])
