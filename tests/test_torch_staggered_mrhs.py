"""Port parity: staggered multi-source solves (the multi-RHS gather pass
S2-mrhs, the batched pair operator and invert_multi_src_quda on the
staggered family).

Numpy seeds 171-189.  The plain S2-mrhs is S2's plain version lane by
lane, so it equals S2 bit for bit; its fat + Naik composition (the Naik
pass added into the fat pass) equals the single-RHS two-pass sum and the
plain S1 bit for bit.  The batched pair operator's ``_mrhs`` forms equal
the single-RHS forms lane by lane, bit for bit.  invert_multi_src_quda
(hisq, asqtad, fat-only; batched CG and block CG) against invert_quda
per source: every lane converged with true_res <= 1e-5 at tol 1e-6 and
the same iterations, solutions within 1e-5.  The Naik hops are held on
lattices whose every extent is >= 7 (8^4 and 8x10x12x14), where a 3-hop
aliases no shorter hop.  The JAX comparisons (its Pallas kernel in
interpret mode, whole JAX multi-source solves) are ``slow``; the kernel
meets its plain version on the card in test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quda_tpu_torch as qt
from quda_tpu.interfaces import quda_api as japi
from quda_tpu.interfaces.params import GaugeParam as JGaugeParam
from quda_tpu.interfaces.params import InvertParam as JInvertParam
from quda_tpu.ops import staggered_pallas as jspl
from quda_tpu_torch.fields.geometry import LatticeGeometry
from quda_tpu_torch.fields.spinor import even_odd_split
from quda_tpu_torch.models import staggered as mstag
from quda_tpu_torch.ops import staggered_pallas as spl

from tests.torch_inputs import gaussian, lattice_shape, rel_err, su3_gauge
from tests.torch_inputs import one_torch_thread  # noqa: F401 (autouse)

HYPERCUBE = (4, 4, 4, 4)
CUBE8 = (8, 8, 8, 8)
WIDE = (8, 10, 12, 14)           # (X, Y, Z, T): every extent >= 7
MASS = 0.1
TOL = 1e-6
NRHS = 3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _fields(dims, seed, nrhs=NRHS):
    """f32 pair links (unit fat, 1/24 long; each parity) and an N-RHS
    psi batch (N,3,2,T,Z,Y*Xh)."""
    T, Z, Y, X = lattice_shape(dims)
    sites = (T, Z, Y * X // 2)
    rng = np.random.default_rng(seed)
    fat = tuple(_t(rng.standard_normal((4, 3, 3, 2) + sites)
                   .astype(np.float32)) for _ in range(2))
    lng = tuple(_t((rng.standard_normal((4, 3, 3, 2) + sites) / 24)
                   .astype(np.float32)) for _ in range(2))
    psi = _t(rng.standard_normal((nrhs, 3, 2) + sites).astype(np.float32))
    return lattice_shape(dims), fat, lng, psi


@pytest.mark.parametrize("dims", [CUBE8, WIDE], ids=["8^4", "8x10x12x14"])
@pytest.mark.parametrize("parity", [0, 1])
def test_plain_pass_mrhs_is_s2_lane_by_lane(dims, parity):
    """Each lane of the plain S2-mrhs (fat and Naik) is S2's plain version
    bit for bit; the accumulating Naik pass adds into the fat pass in
    place, giving the two-pass sum and the plain S1 bit for bit."""
    d, fat, lng, psi = _fields(dims, 171 + parity)
    q = 1 - parity
    fbw = spl.backward_links_eo(fat[q], d, parity, 1)
    lbw = spl.backward_links_eo(lng[q], d, parity, 3)
    for here, bw, nhop in ((fat[parity], fbw, 1), (lng[parity], lbw, 3)):
        out = spl.dslash_staggered_eo_pass_mrhs(here, bw, psi, d, parity,
                                                nhop)
        assert out.shape == psi.shape and out.dtype == torch.float32
        for r in range(NRHS):
            assert torch.equal(out[r], spl.dslash_staggered_eo_pass_plain(
                here, bw, psi[r], d, parity, nhop))
    acc = spl.dslash_staggered_eo_pass_mrhs(fat[parity], fbw, psi, d,
                                            parity, 1)
    got = spl.dslash_staggered_eo_pass_mrhs(lng[parity], lbw, psi, d, parity,
                                            3, acc=acc)
    assert got is acc
    both = spl.dslash_staggered_eo_pallas_mrhs(fat[parity], fbw, psi, d,
                                               parity, lng[parity], lbw)
    assert torch.equal(both, got)
    for r in range(NRHS):
        assert torch.equal(both[r], spl.dslash_staggered_eo_pallas(
            fat[parity], fbw, psi[r], d, parity, lng[parity], lbw))
        assert torch.equal(both[r], spl.dslash_staggered_eo_fused_plain(
            fat[parity], fat[q], psi[r], d, parity, lng[parity], lng[q]))
    fat_only = spl.dslash_staggered_eo_pallas_mrhs(fat[parity], fbw, psi, d,
                                                   parity)
    assert torch.equal(fat_only[0], spl.dslash_staggered_eo_pass_plain(
        fat[parity], fbw, psi[0], d, parity, 1))


def test_pass_mrhs_on_cpu_counts_no_launch_and_casts():
    d, fat, lng, psi = _fields(CUBE8, 173, nrhs=2)
    fbw = spl.backward_links_eo(fat[1], d, 0, 1)
    n0 = spl.dslash_staggered_eo_pass_mrhs.launches
    out = spl.dslash_staggered_eo_pallas_mrhs(fat[0], fbw, psi, d, 0,
                                              out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    assert spl.dslash_staggered_eo_pass_mrhs.launches == n0
    assert spl.pass_mrhs_bytes_per_site(12) == 48 * 12 + 576
    assert spl.pass_mrhs_bytes_per_site(12, True) == 72 * 12 + 576
    with pytest.raises(ValueError, match="nhop"):
        spl.dslash_staggered_eo_pass_mrhs(fat[0], fbw, psi, d, 0, 2)
    with pytest.raises(ValueError, match="N, 3, 2"):
        spl.dslash_staggered_eo_pass_mrhs(fat[0], fbw, psi[0], d, 0, 1)


# -- the batched pair operator ---------------------------------------------

@pytest.fixture(scope="module")
def stag_op():
    """Port complex DiracStaggeredPC (complex128), improved, on WIDE."""
    geom = LatticeGeometry(WIDE)
    fat = su3_gauge(WIDE, 174, dtype=np.complex128)
    lng = su3_gauge(WIDE, 175, dtype=np.complex128) / 24
    return mstag.DiracStaggeredPC(_t(fat), geom, MASS, True, _t(lng))


def _mrhs_sources(geom):
    B = _t(gaussian((NRHS,) + geom.lattice_shape + (1, 3), seed=176,
                    dtype=np.complex64))
    halves = [even_odd_split(B[i], geom) for i in range(NRHS)]
    be = torch.stack([h[0] for h in halves])
    bo = torch.stack([h[1] for h in halves])
    return halves, be, bo


def test_mrhs_operator_is_the_single_rhs_operator(stag_op):
    """On the two_pass form, M_pairs_mrhs, prepare_pairs_mrhs,
    reconstruct_pairs_mrhs and solution_from_pairs_mrhs equal the
    single-RHS forms lane by lane, bit for bit; Mdag and MdagM follow."""
    geom = stag_op.geom
    op = stag_op.pairs(torch.float32, form="two_pass")
    halves, be, bo = _mrhs_sources(geom)
    rhs = op.prepare_pairs_mrhs(be, bo)
    assert rhs.shape == (NRHS, 3, 2) + tuple(op.fat_eo_pp[0].shape[-3:])
    for i in range(NRHS):
        assert torch.equal(rhs[i], op.prepare_pairs(*halves[i]))
    m = op.M_pairs_mrhs(rhs)
    mm = op.MdagM_pairs_mrhs(rhs)
    assert op.Mdag_pairs_mrhs == op.M_pairs_mrhs
    for i in range(NRHS):
        assert torch.equal(m[i], op.M_pairs(rhs[i]))
        assert torch.equal(mm[i], op.MdagM_pairs(rhs[i]))
    xe, xo = op.reconstruct_pairs_mrhs(rhs, be, bo)
    for i in range(NRHS):
        ye, yo = op.reconstruct_pairs(rhs[i], *halves[i])
        assert torch.equal(xe[i], ye) and torch.equal(xo[i], yo)
    sol = op.solution_from_pairs_mrhs(rhs)
    assert sol.dtype == torch.complex64
    assert torch.equal(sol[1], op._from_pairs(rhs[1], torch.complex64))


def test_fused_form_refuses_the_mrhs_hop(stag_op):
    """The batched route builds the two_pass operator (the gather kernel
    S2-mrhs): the fused form's multi-RHS forms raise naming two_pass."""
    op = stag_op.pairs(torch.float32, form="fused")
    assert op.form == "fused"
    _, be, bo = _mrhs_sources(stag_op.geom)
    with pytest.raises(NotImplementedError, match="two_pass"):
        op.prepare_pairs_mrhs(be, bo)
    x = torch.zeros((NRHS, 3, 2) + tuple(op.fat_eo_pp[0].shape[-3:]))
    with pytest.raises(NotImplementedError, match="two_pass"):
        op.M_pairs_mrhs(x)


def test_mrhs_operator_matches_complex(stag_op):
    """The batched M against the complex128 PC operator, f32 within 1e-6."""
    op = stag_op.pairs(torch.float32, form="two_pass")
    geom = stag_op.geom
    x = _t(gaussian((2,) + geom.half_lattice_shape + (1, 3), seed=177,
                    dtype=np.complex128))
    got = op.solution_from_pairs_mrhs(op.M_pairs_mrhs(op._to_pairs(x)),
                                      torch.complex128)
    for i in range(2):
        assert rel_err(got[i].numpy(), stag_op.M(x[i]).numpy()) < 1e-6


# -- invert_multi_src_quda on the staggered family ---------------------------

@pytest.fixture(scope="module")
def multi_inputs():
    g = su3_gauge(HYPERCUBE, seed=178)
    B = gaussian((NRHS,) + lattice_shape(HYPERCUBE) + (1, 3), seed=179)
    return g, B


def _param(**kw):
    base = dict(dslash_type="hisq", inv_type="cg", solve_type="direct-pc",
                mass=MASS, tol=TOL, maxiter=1000, cuda_prec="single")
    base.update(kw)
    return qt.InvertParam(**base)


def _solve_both(g, B, dslash_type, monkeypatch, block=False):
    """(x_batched, param, single-RHS hop calls in the batched solve,
    [per-source (x, param)]) on one CPU session; the asqtad links are the
    hisq ones through load_fat_long_quda."""
    calls = {"n": 0}

    def counted(fn):
        def wrapped(*a, **k):
            calls["n"] += 1
            return fn(*a, **k)
        return wrapped

    qt.init_quda(device="cpu")
    try:
        qt.load_gauge_quda(g, qt.GaugeParam(X=HYPERCUBE, cuda_prec="single"))
        if dslash_type != "staggered":
            links = qt.compute_ks_link_quda()
            if dslash_type == "asqtad":
                qt.load_fat_long_quda(links.fat, links.long)
        with monkeypatch.context() as m:
            m.setenv("QUDA_TORCH_MULTI_SRC_BLOCK", "1" if block else "")
            for name in ("dslash_staggered_eo_pallas_fused",
                         "dslash_staggered_eo_pass"):
                m.setattr(spl, name, counted(getattr(spl, name)))
            p = _param(dslash_type=dslash_type)
            x = qt.invert_multi_src_quda(B, p)
        each = []
        for i in range(len(B)):
            pi = _param(dslash_type=dslash_type)
            each.append((qt.invert_quda(B[i], pi), pi))
    finally:
        qt.end_quda()
    return x, p, calls["n"], each


@pytest.mark.parametrize("dslash_type", ["hisq", "asqtad", "staggered"])
def test_invert_multi_src_matches_invert_quda_per_source(
        multi_inputs, dslash_type, monkeypatch):
    """The batched route: every lane converged with true_res <= 1e-5 and
    the iterations invert_quda takes on that source, solutions within
    1e-5; one M apply per iteration in the gflops; every hop on the
    multi-RHS pass (its plain version here), no single-RHS hop."""
    g, B = multi_inputs
    n0 = spl.dslash_staggered_eo_pass_mrhs.launches
    x, p, single_hops, each = _solve_both(g, B, dslash_type, monkeypatch)
    assert x.shape == (NRHS,) + lattice_shape(HYPERCUBE) + (1, 3)
    assert p.converged and p.converged_multi == [True] * NRHS
    assert max(p.true_res_multi) <= 10 * TOL
    assert p.iter_count_multi == [pi.iter_count for _, pi in each]
    assert p.iter_count == sum(p.iter_count_multi)
    for i, (xi, _) in enumerate(each):
        assert rel_err(x[i].numpy(), xi.numpy()) < 1e-5
    flops = 2 * (570 if dslash_type == "staggered" else 1146) + 24
    assert p.gflops == pytest.approx(p.iter_count * flops * 128 / 1e9)
    assert spl.dslash_staggered_eo_pass_mrhs.launches == n0  # CPU: plain
    assert single_hops == 0


def test_invert_multi_src_block_cg(multi_inputs, monkeypatch):
    """QUDA_TORCH_MULTI_SRC_BLOCK=1: block CG on the Hermitian PC batch;
    every lane converged, no more iterations than the worst source."""
    g, B = multi_inputs
    x, p, single_hops, each = _solve_both(g, B, "hisq", monkeypatch,
                                          block=True)
    assert single_hops == 0
    assert p.converged and max(p.true_res_multi) <= 10 * TOL
    assert len(set(p.iter_count_multi)) == 1
    assert p.iter_count_multi[0] <= max(pi.iter_count for _, pi in each)
    for i, (xi, _) in enumerate(each):
        assert rel_err(x[i].numpy(), xi.numpy()) < 1e-4


def test_deep_tol_and_double_take_the_per_source_route(multi_inputs,
                                                       monkeypatch):
    """Below tol 5e-8 the batch loops over invert_quda, as in JAX; a
    staggered double request raises there (ROADMAP A7)."""
    g, B = multi_inputs
    qt.init_quda(device="cpu")
    try:
        qt.load_gauge_quda(g, qt.GaugeParam(X=HYPERCUBE, cuda_prec="single"))
        qt.compute_ks_link_quda()
        p = _param(tol=1e-9, maxiter=3)
        n0 = spl.dslash_staggered_eo_pallas_fused.launches
        qt.invert_multi_src_quda(B[:1], p)
        assert p.iter_count_multi == [3] and not p.converged
        assert spl.dslash_staggered_eo_pallas_fused.launches == n0
        with pytest.raises(NotImplementedError, match="ROADMAP A7"):
            qt.invert_multi_src_quda(B[:1], _param(cuda_prec="double"))
    finally:
        qt.end_quda()


# -- slow: JAX's Pallas kernel in interpret mode, whole JAX solves ----------

@pytest.mark.slow
@pytest.mark.parametrize("improved", [False, True],
                         ids=["fat-only", "fat+naik"])
def test_plain_mrhs_matches_jax_pallas_interpret(improved):
    """The plain S2-mrhs composition against JAX's
    ``dslash_staggered_eo_pallas_mrhs`` (interpret mode), f32 within
    1e-6, both parities at 8^4."""
    d, fat, lng, psi = _fields(CUBE8, 180)
    for parity in (0, 1):
        q = 1 - parity
        fbw = spl.backward_links_eo(fat[q], d, parity, 1)
        lbw = spl.backward_links_eo(lng[q], d, parity, 3)
        want = np.asarray(jspl.dslash_staggered_eo_pallas_mrhs(
            jnp.asarray(fat[parity].numpy()), jnp.asarray(fbw.numpy()),
            jnp.asarray(psi.numpy()), d, parity,
            long_here_pl=(jnp.asarray(lng[parity].numpy()) if improved
                          else None),
            long_bw_pl=jnp.asarray(lbw.numpy()) if improved else None,
            interpret=True, out_dtype=jnp.float32))
        got = spl.dslash_staggered_eo_pallas_mrhs(
            fat[parity], fbw, psi, d, parity,
            lng[parity] if improved else None, lbw if improved else None)
        assert rel_err(got.numpy(), want) < 1e-6


@pytest.mark.slow
@pytest.mark.parametrize("dslash_type", ["hisq", "staggered"])
def test_invert_multi_src_matches_jax(multi_inputs, dslash_type,
                                      monkeypatch):
    """Whole JAX multi-source staggered solves on its batched pair route
    (QUDA_TPU_PACKED=1, QUDA_TPU_MULTI_SRC_SPLIT=0) on the same gauge,
    sources and HISQ links: per-lane iterations within 2, solutions
    within 1e-4."""
    monkeypatch.setenv("QUDA_TPU_PACKED", "1")
    monkeypatch.setenv("QUDA_TPU_MULTI_SRC_SPLIT", "0")
    from quda_tpu.utils import config as jconf
    jconf.reset_cache()
    g, B = multi_inputs
    japi.init_quda()
    try:
        japi.load_gauge_quda(g, JGaugeParam(X=HYPERCUBE, cuda_prec="single"))
        jlinks = (japi.compute_ks_link_quda() if dslash_type != "staggered"
                  else None)
        jp = JInvertParam(dslash_type=dslash_type, inv_type="cg",
                          solve_type="direct-pc", mass=MASS, tol=TOL,
                          maxiter=1000, cuda_prec="single")
        xj = np.asarray(japi.invert_multi_src_quda(B, jp))
    finally:
        japi.end_quda()
        jconf.reset_cache()
    qt.init_quda(device="cpu")
    try:
        qt.load_gauge_quda(g, qt.GaugeParam(X=HYPERCUBE, cuda_prec="single"))
        if jlinks is not None:
            qt.load_fat_long_quda(np.asarray(jlinks.fat),
                                  np.asarray(jlinks.long))
        p = _param(dslash_type=dslash_type)
        x = qt.invert_multi_src_quda(B, p).numpy()
    finally:
        qt.end_quda()
    assert p.converged
    assert all(abs(a - b) <= 2 for a, b in zip(
        p.iter_count_multi, np.asarray(jp.iter_count_multi)))
    assert rel_err(x, xj) < 1e-4
