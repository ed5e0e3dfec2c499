"""Port parity: the multi-source slice (the multi-RHS pair solvers, the
split routing, the multi-RHS hops' plain versions, the pair operators'
``_mrhs`` forms and invert_multi_src_quda).

quda_tpu_torch against quda_tpu on the same numpy inputs (numpy seeds
121-140), and against the port's own single-RHS forms.  Tolerances: the
solvers' iterates 1e-5 (f32) and 1e-12 (f64) relative, as both packages
run the same recurrences with sums in another order; the stencils and
operators 1e-6 relative in f32 (the same terms, summed in another order
by XLA); lane by lane against the port's single-RHS forms, exact (the
plain versions broadcast the same arithmetic over the RHS axis).  The
CUDA kernels meet their plain versions on the card in test_torch_cuda.py.
Comparisons with the JAX Pallas kernels in interpret mode and with whole
JAX solves are ``slow``; each has a fast port-only or XLA twin here.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quda_tpu_torch as qt
from quda_tpu.fields.geometry import LatticeGeometry as JGeom
from quda_tpu.interfaces import quda_api as japi
from quda_tpu.interfaces.params import GaugeParam as JGaugeParam
from quda_tpu.interfaces.params import InvertParam as JInvertParam
from quda_tpu.models import clover as jmcl
from quda_tpu.models.wilson import DiracWilsonPC as JDiracWilsonPC
from quda_tpu.models.wilson import DiracWilsonPCPacked as JDiracWilsonPCPacked
from quda_tpu.ops import clover_pallas as jclp
from quda_tpu.ops import wilson_pallas_packed as jwpp
from quda_tpu.parallel import split as jsplit
from quda_tpu.solvers import block as jblock
from quda_tpu_torch.fields.geometry import LatticeGeometry
from quda_tpu_torch.models import clover as tmcl
from quda_tpu_torch.models.wilson import DiracWilsonPC, DiracWilsonPCPacked
from quda_tpu_torch.ops import clover_pallas as clp
from quda_tpu_torch.ops import wilson_pallas_packed as wpp
from quda_tpu_torch.parallel import split as tsplit
from quda_tpu_torch.solvers import block as tblock
from quda_tpu_torch.utils import config

from tests.test_torch_clover import _JaxView
from tests.torch_inputs import (ASYM, SMALL, gaussian, lattice_shape,
                                rel_err, su3_gauge)
from tests.torch_inputs import one_torch_thread  # noqa: F401 (autouse)

KAPPA = 0.12
CSW = 1.0
TOL = 1e-6
HYPERCUBE = (4, 4, 4, 4)
NRHS = 3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- the multi-RHS pair solvers --------------------------------------------

def _spd_system(seed, dtype, n=NRHS, dim=48):
    """An SPD matrix (eigenvalues in about [0.5, 4.5]) and an (n, 4,
    dim/4) batch of right-hand sides; the matvec maps a batch row-wise."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((dim, dim))
    a = (q @ q.T / dim + 0.5 * np.eye(dim)).astype(dtype)
    b = rng.standard_normal((n, 4, dim // 4)).astype(dtype)
    return a, b


def _matvecs(a):
    at, aj = _t(a), jnp.asarray(a)

    def mv_t(x):
        return (x.reshape(x.shape[0], -1) @ at.T).reshape(x.shape)

    def mv_j(x):
        return (x.reshape(x.shape[0], -1) @ aj.T).reshape(x.shape)

    return mv_t, mv_j


@pytest.mark.parametrize("dtype,tol,xtol", [
    (np.float32, 1e-5, 1e-5), (np.float64, 1e-10, 1e-12)],
    ids=["f32", "f64"])
@pytest.mark.parametrize("check_every", [1, 4])
def test_batched_cg_pairs_matches_jax(dtype, tol, xtol, check_every):
    """Per-lane iterations equal to JAX's (each lane's first converged
    check boundary, a multiple of check_every), x within xtol."""
    a, b = _spd_system(121, dtype)
    mv_t, mv_j = _matvecs(a)
    got = tblock.batched_cg_pairs(mv_t, _t(b), tol=tol, maxiter=200,
                                  check_every=check_every)
    want = jblock.batched_cg_pairs(mv_j, jnp.asarray(b), tol=tol,
                                   maxiter=200, check_every=check_every)
    iters = [int(i) for i in got.iters]
    assert iters == [int(i) for i in np.asarray(want.iters)]
    assert all(i % check_every == 0 for i in iters)
    assert bool(got.converged.all()) and bool(np.asarray(want.converged).all())
    assert rel_err(got.x.numpy(), np.asarray(want.x)) < xtol
    # each lane is a solo CG: its residual meets tol
    r = _t(b) - mv_t(got.x)
    rel = torch.linalg.vector_norm(r.reshape(NRHS, -1), dim=1) / \
        torch.linalg.vector_norm(_t(b).reshape(NRHS, -1), dim=1)
    assert float(rel.max()) <= 2 * tol


@pytest.mark.parametrize("dtype,tol,xtol", [
    (np.float32, 1e-5, 1e-5), (np.float64, 1e-10, 1e-10)],
    ids=["f32", "f64"])
def test_block_cg_pairs_matches_jax(dtype, tol, xtol):
    """Shared iteration count equal to JAX's, x within xtol.  In f64 the
    two Gram solves (LAPACK's LU here, XLA's there) round differently and
    the shared Krylov basis carries that into x: the solutions agree to
    the solve's tol (measured 7.7e-12), not to batched CG's 1e-12."""
    a, b = _spd_system(122, dtype)
    mv_t, mv_j = _matvecs(a)
    got = tblock.block_cg_pairs(mv_t, _t(b), tol=tol, maxiter=200)
    want = jblock.block_cg_pairs(mv_j, jnp.asarray(b), tol=tol, maxiter=200)
    assert got.iters == int(want.iters)
    assert bool(got.converged.all()) and bool(np.asarray(want.converged).all())
    assert rel_err(got.x.numpy(), np.asarray(want.x)) < xtol


def test_duplicate_sources_break_block_cg_not_batched_cg():
    """Two equal sources make block CG's Gram matrices singular: it stops
    and reports unconverged lanes, as JAX's does, never NaN as a converged
    solution.  Independent lanes are immune."""
    a, b = _spd_system(123, np.float64)
    b[1] = b[0]
    mv_t, mv_j = _matvecs(a)
    got = tblock.block_cg_pairs(mv_t, _t(b), tol=1e-10, maxiter=200)
    want = jblock.block_cg_pairs(mv_j, jnp.asarray(b), tol=1e-10,
                                 maxiter=200)
    assert not bool(got.converged.all())
    assert got.converged.tolist() == np.asarray(want.converged).tolist()
    assert got.iters == int(want.iters) < 200
    assert not torch.isfinite(got.r2).all()
    batched = tblock.batched_cg_pairs(mv_t, _t(b), tol=1e-10, maxiter=200)
    assert bool(batched.converged.all())
    assert torch.equal(batched.x[0], batched.x[1])


def test_solvers_refuse_record_and_warn_past_the_cap(monkeypatch):
    a, b = _spd_system(124, np.float64)
    mv_t, _ = _matvecs(a)
    with pytest.raises(NotImplementedError, match="A17"):
        tblock.batched_cg_pairs(mv_t, _t(b), record=True)
    with pytest.raises(NotImplementedError, match="A17"):
        tblock.block_cg_pairs(mv_t, _t(b), record=True)
    monkeypatch.setenv("QUDA_TORCH_MAX_MULTI_RHS", "2")
    with pytest.warns(UserWarning, match="QUDA_TORCH_MAX_MULTI_RHS=2"):
        tblock.batched_cg_pairs(mv_t, _t(b), maxiter=2)


def test_config_registry(monkeypatch):
    """The three knobs, their defaults and their validation."""
    assert config.get("QUDA_TORCH_MAX_MULTI_RHS") == 32
    assert config.get("QUDA_TORCH_MULTI_SRC_SPLIT") == ""
    assert config.get("QUDA_TORCH_MULTI_SRC_BLOCK") == ""
    monkeypatch.setenv("QUDA_TORCH_MULTI_SRC_BLOCK", "1")
    assert config.get("QUDA_TORCH_MULTI_SRC_BLOCK") == "1"
    monkeypatch.setenv("QUDA_TORCH_MULTI_SRC_SPLIT", "2")
    with pytest.raises(ValueError, match="QUDA_TORCH_MULTI_SRC_SPLIT"):
        config.get("QUDA_TORCH_MULTI_SRC_SPLIT")
    monkeypatch.setenv("QUDA_TORCH_MAX_MULTI_RHS", "many")
    with pytest.raises(ValueError, match="integer"):
        config.get("QUDA_TORCH_MAX_MULTI_RHS")
    with pytest.raises(KeyError, match="unregistered"):
        config.get("QUDA_TORCH_NOPE")


# -- split routing ----------------------------------------------------------

def test_multi_src_route_matches_jax_on_one_device():
    """Route and split_gated as JAX's on one device (this host gives JAX 8
    virtual CPU devices, so it is handed one); a forced split with no
    usable mesh raises in both."""
    one = jax.devices()[:1]
    for n in (1, 3):
        assert tsplit.auto_split_mesh(n) is None
        assert jsplit.auto_split_mesh(n, devices=one) is None
        for mode in ("", "0"):
            for sg in (True, False):
                for bg in (True, False):
                    kw = dict(split_mode=mode, split_gate=sg,
                              batched_gate=bg)
                    got = tsplit.multi_src_route(n, **kw)
                    want = jsplit.multi_src_route(n, devices=one, **kw)
                    assert got == want
                    assert got[0] == ("batched" if bg else "per_source")
        with pytest.raises(ValueError, match="A15"):
            tsplit.multi_src_route(n, split_mode="1")
        with pytest.raises(ValueError):
            jsplit.multi_src_route(n, split_mode="1", devices=one)


# -- the multi-RHS hops' plain versions and the pair operators -------------
# Fast: lane by lane against the port's single-RHS forms, which
# test_torch_wilson.py and test_torch_clover.py hold to the JAX package.
# Slow: directly against JAX's vmapped XLA forms (JAX compiles each).

@pytest.fixture(scope="module")
def port_ops():
    """The port's f32 pair operators {"wilson", "clover"} x {"full",
    "r12"} and the complex128 DiracCloverPC, on one 4x6x8x10 SU(3) gauge
    each (recon-12 needs SU(3) links)."""
    geom = LatticeGeometry(ASYM)
    tpk = DiracWilsonPCPacked(DiracWilsonPC(_t(su3_gauge(ASYM, seed=125)),
                                            geom, KAPPA))
    td = tmcl.DiracCloverPC(_t(su3_gauge(ASYM, seed=126,
                                         dtype=np.complex128)),
                            geom, KAPPA, CSW)
    forms = ("full", "r12")
    return ({"wilson": {f: tpk.pairs(torch.float32, precision_form=f)
                        for f in forms},
             "clover": {f: td.pairs(torch.float32, precision_form=f)
                        for f in forms}}, td)


@pytest.fixture(scope="module")
def jax_ops(port_ops):
    """JAX's f32 XLA pair operators on the same gauges: Wilson from the
    links, clover from the port's complex128 clover term
    (tests/test_torch_clover.py holds the two terms together)."""
    g = su3_gauge(ASYM, seed=125)
    jpk = JDiracWilsonPCPacked(JDiracWilsonPC(jnp.asarray(g), JGeom(ASYM),
                                              KAPPA))
    return {"wilson": jpk.pairs(jnp.float32),
            "clover": jmcl.DiracCloverPCPairs(_JaxView(port_ops[1]),
                                              jnp.float32, form="xla")}


def _batch(seed, shape):
    return gaussian((NRHS,) + tuple(shape), seed=seed, dtype=np.float32)


def _pair_shape(dims):
    T, Z, Y, X = lattice_shape(dims)
    return (4, 3, 2, T, Z, Y * X // 2)


def _hop(top, psi, parity):
    """B5-eo's wrapper on the operator's links (a CPU call: the plain
    version)."""
    return wpp.dslash_eo_pallas_packed_mrhs(
        top.gauge_eo_pp[parity], top._u_bw[parity], psi, top.dims, parity,
        tb_sign=top._tb_sign)


def _clover_hops(top, psi, xc):
    """K1-mrhs (target parity 1 - matpc) and K2-mrhs (target matpc) on
    the operator's links and blocks, and their single-RHS twins."""
    p = top.matpc
    a1 = (top.gauge_eo_pp[1 - p], top._u_bw[1 - p])
    a2 = (top.gauge_eo_pp[p], top._u_bw[p])
    kw1 = dict(blk_pl=top.clover_inv_q_pp, out_dtype=torch.float32,
               tb_sign=top._tb_sign)
    kw2 = dict(hop_coeff=-KAPPA ** 2, blk_pl=top.clover_p_pp,
               out_dtype=torch.float32, tb_sign=top._tb_sign)
    k1 = clp.dslash_eo_pallas_post_mrhs(*a1, psi, top.dims, 1 - p, **kw1)
    k2 = clp.dslash_eo_pallas_diag_hop_mrhs(*a2, psi, xc, top.dims, p,
                                            **kw2)

    def single(r):
        return (clp.dslash_eo_pallas_post(*a1, psi[r], top.dims, 1 - p,
                                          **kw1),
                clp.dslash_eo_pallas_diag_hop(*a2, psi[r], xc[r], top.dims,
                                              p, **kw2))

    return k1, k2, single


@pytest.mark.parametrize("form", ["full", "r12"])
@pytest.mark.parametrize("parity", [0, 1])
def test_plain_mrhs_hop_matches_single_rhs(port_ops, parity, form):
    """B5-eo's plain version (no launch counted) lane by lane against the
    single-RHS hop's, exactly."""
    top = port_ops[0]["wilson"][form]
    psi = _t(_batch(127, _pair_shape(ASYM)))
    n0 = wpp.dslash_eo_pallas_packed_mrhs.launches
    got = _hop(top, psi, parity)
    assert wpp.dslash_eo_pallas_packed_mrhs.launches == n0
    assert got.shape == psi.shape and got.is_contiguous()
    for r in range(NRHS):
        assert torch.equal(got[r], top._d_to(psi[r], parity, torch.float32))


@pytest.mark.parametrize("form", ["full", "r12"])
def test_plain_mrhs_clover_hops_match_single_rhs(port_ops, form):
    """K1-mrhs (target parity 1) and K2-mrhs (target parity 0), plain
    versions, lane by lane against K1 and K2, exactly."""
    top = port_ops[0]["clover"][form]
    psi = _t(_batch(127, _pair_shape(ASYM)))
    xc = _t(_batch(128, _pair_shape(ASYM)))
    k1, k2, single = _clover_hops(top, psi, xc)
    for r in range(NRHS):
        s1, s2 = single(r)
        assert torch.equal(k1[r], s1) and torch.equal(k2[r], s2)


def _half_sources(dims, seed):
    half = LatticeGeometry(dims).half_lattice_shape
    return tuple(gaussian((NRHS,) + half + (4, 3), seed=seed + i)
                 for i in range(2))


def _mrhs_forms(top, x, be, bo):
    return (top.M_pairs_mrhs(x), top.Mdag_pairs_mrhs(x),
            top.MdagM_pairs_mrhs(x), top.prepare_pairs_mrhs(be, bo),
            top.reconstruct_pairs_mrhs(x, be, bo))


@pytest.mark.parametrize("form", ["full", "r12"])
@pytest.mark.parametrize("family", ["wilson", "clover"])
def test_pair_operator_mrhs_forms_match_single_rhs(port_ops, family, form):
    """M/Mdag/MdagM_pairs_mrhs, prepare_pairs_mrhs and
    reconstruct_pairs_mrhs lane by lane against the single-RHS forms,
    exactly."""
    top = port_ops[0][family][form]
    x = _t(_batch(129, _pair_shape(ASYM)))
    be, bo = (_t(b) for b in _half_sources(ASYM, 130))
    got = _mrhs_forms(top, x, be, bo)
    for r in range(NRHS):
        assert torch.equal(got[0][r], top.M_pairs(x[r]))
        assert torch.equal(got[1][r], top.Mdag_pairs(x[r]))
        assert torch.equal(got[2][r], top.MdagM_pairs(x[r]))
        assert torch.equal(got[3][r], top.prepare_pairs(be[r], bo[r]))
        rec = top.reconstruct_pairs(x[r], be[r], bo[r])
        assert torch.equal(got[4][0][r], rec[0])
        assert torch.equal(got[4][1][r], rec[1])
    sol = top.solution_from_pairs_mrhs(x)
    assert sol.shape == (NRHS,) + be.shape[1:] and sol.dtype == be.dtype
    assert torch.equal(sol[1], top._from_pairs(x[1], torch.complex64))


@pytest.mark.slow
def test_plain_mrhs_hops_match_jax_vmap(port_ops, jax_ops):
    """B5-eo's plain version against JAX's vmap of dslash_eo_packed_pairs
    (both target parities, full and r12 links), and K1/K2-mrhs against
    JAX's vmapped staged composition (A_q^-1 hop; A_p x - kappa^2 hop),
    1e-6 relative."""
    psi = _batch(127, _pair_shape(ASYM))
    xc = _batch(128, _pair_shape(ASYM))
    jw, jc = jax_ops["wilson"], jax_ops["clover"]
    f32 = jnp.float32
    pj, xj = jnp.asarray(psi), jnp.asarray(xc)
    hops = [np.asarray(jw._d_to_mrhs(pj, t, f32)) for t in (0, 1)]
    k1j = np.asarray(jc._Ainv_q_sign_pairs_mrhs(jc._d_to_mrhs(pj, 1, f32),
                                                +1, f32))
    k2j = np.asarray(jc._diag_sign_pairs_mrhs(xj, +1, f32)
                     - KAPPA ** 2 * jc._d_to_mrhs(pj, 0, f32))
    for form in ("full", "r12"):
        top = port_ops[0]["wilson"][form]
        for parity in (0, 1):
            assert rel_err(_hop(top, _t(psi), parity).numpy(),
                           hops[parity]) < 1e-6
        k1, k2, _ = _clover_hops(port_ops[0]["clover"][form], _t(psi),
                                 _t(xc))
        assert rel_err(k1.numpy(), k1j) < 1e-6
        assert rel_err(k2.numpy(), k2j) < 1e-6


@pytest.mark.slow
@pytest.mark.parametrize("family", ["wilson", "clover"])
def test_pair_operator_mrhs_forms_match_jax(port_ops, jax_ops, family):
    """The f32 full-link operator's _mrhs forms against JAX's (one
    jitted call), 1e-6 relative."""
    jop = jax_ops[family]
    x = _batch(129, _pair_shape(ASYM))
    be, bo = _half_sources(ASYM, 130)

    @jax.jit
    def run(x_b, e_b, o_b):
        return (jop.M_pairs_mrhs(x_b), jop.Mdag_pairs_mrhs(x_b),
                jop.MdagM_pairs_mrhs(x_b), jop.prepare_pairs_mrhs(e_b, o_b),
                jop.reconstruct_pairs_mrhs(x_b, e_b, o_b))

    want = jax.tree_util.tree_map(np.asarray, run(
        jnp.asarray(x), jnp.asarray(be), jnp.asarray(bo)))
    got = _mrhs_forms(port_ops[0][family]["full"], _t(x), _t(be), _t(bo))
    for g_, w_ in zip(got[:4], want[:4]):
        assert rel_err(g_.numpy(), w_) < 1e-6
    for g_, w_ in zip(got[4], want[4]):
        assert rel_err(g_.numpy(), w_) < 1e-6


def test_mrhs_wrappers_refuse_unbatched_psi():
    dims = lattice_shape(ASYM)
    sites = _pair_shape(ASYM)[3:]
    u = torch.zeros((4, 3, 3, 2) + sites)
    psi = torch.zeros((4, 3, 2) + sites)
    with pytest.raises(ValueError, match=r"\(N, 4, 3, 2"):
        wpp.dslash_eo_pallas_packed_mrhs(u, u, psi, dims, 0)
    blk = torch.zeros((2, 6, 6, 2) + sites)
    with pytest.raises(ValueError, match=r"\(N, 4, 3, 2"):
        clp.dslash_eo_pallas_post_mrhs(u, u, psi, dims, 0, blk_pl=blk)
    with pytest.raises(ValueError, match=r"\(N, 4, 3, 2"):
        clp.dslash_eo_pallas_diag_hop_mrhs(u, u, psi, psi, dims, 0,
                                           hop_coeff=-0.01, diag_twist=0.1)


def test_mrhs_chunk_and_grid_limits():
    """The chunk width must have a kernel instance; a batch whose grid
    exceeds 2^31 - 1 blocks is refused, not split."""
    assert wpp.mrhs_chunk(None, 12, 1 << 20) == wpp.MRHS_CHUNK
    assert wpp.mrhs_chunk(1, 3, 960) == 1
    with pytest.raises(ValueError, match="instances"):
        wpp.mrhs_chunk(4, 12, 960)
    with pytest.raises(ValueError, match="grid"):
        wpp.mrhs_chunk(1, 2 ** 20, 2 ** 20)
    with pytest.raises(ValueError, match="grid"):
        wpp.mrhs_chunk(None, 0, 960)
    assert wpp.bytes_per_site_mrhs(12) == 192 * 12 + 576
    assert wpp.bytes_per_site_mrhs(12, rows=2) == 192 * 12 + 384
    assert clp.bytes_per_site_mrhs("post", 12) == 192 * 12 + 1152
    assert clp.bytes_per_site_mrhs("diag_hop", 12, 2) == 288 * 12 + 960


# -- invert_multi_src_quda --------------------------------------------------

def _solve_multi(g, B, dims=SMALL, reconstruct=18, **kw):
    qt.init_quda(device="cpu")
    try:
        qt.load_gauge_quda(g, qt.GaugeParam(X=dims, cuda_prec="single",
                                            reconstruct=reconstruct))
        base = dict(dslash_type="wilson", inv_type="cg",
                    solve_type="normop-pc", kappa=KAPPA, tol=TOL,
                    maxiter=500, cuda_prec="single")
        base.update(kw)
        p = qt.InvertParam(**base)
        x = qt.invert_multi_src_quda(B, p)
    finally:
        qt.end_quda()
    return x.numpy(), p


def _solve_each(g, B, dims=SMALL, reconstruct=18, **kw):
    qt.init_quda(device="cpu")
    try:
        qt.load_gauge_quda(g, qt.GaugeParam(X=dims, cuda_prec="single",
                                            reconstruct=reconstruct))
        base = dict(dslash_type="wilson", inv_type="cg",
                    solve_type="normop-pc", kappa=KAPPA, tol=TOL,
                    maxiter=500, cuda_prec="single")
        base.update(kw)
        out = []
        for b in B:
            p = qt.InvertParam(**base)
            out.append((qt.invert_quda(b, p).numpy(), p))
    finally:
        qt.end_quda()
    return out


@pytest.fixture(scope="module")
def multi_system():
    return (su3_gauge(SMALL, seed=131),
            gaussian((NRHS,) + lattice_shape(SMALL) + (4, 3), seed=132))


@pytest.mark.parametrize("case", ["wilson", "wilson-block", "wilson-r12",
                                  "clover"])
def test_invert_multi_src_matches_invert_quda_per_source(multi_system, case,
                                                         monkeypatch):
    """The batched route (and block CG) on CPU tensors against the port's
    invert_quda per source: iterations within 1, solutions within 1e-5,
    every lane converged; the result fields filled as JAX's _finish
    fills them."""
    g, B = multi_system
    kw = {"reconstruct": 12} if case == "wilson-r12" else {}
    if case == "clover":
        kw.update(dslash_type="clover", csw=CSW)
    if case == "wilson-block":
        monkeypatch.setenv("QUDA_TORCH_MULTI_SRC_BLOCK", "1")
    x, p = _solve_multi(g, B, **kw)
    monkeypatch.delenv("QUDA_TORCH_MULTI_SRC_BLOCK", raising=False)
    each = _solve_each(g, B, **kw)
    assert x.shape == B.shape and x.dtype == np.complex64
    assert p.converged and p.converged_multi == [True] * NRHS
    assert len(p.iter_count_multi) == len(p.true_res_multi) == NRHS
    assert p.iter_count == sum(p.iter_count_multi)
    assert p.true_res == max(p.true_res_multi) <= 10 * TOL
    assert p.secs > 0 and p.x_df64_lo is None
    flops = 2 * 1320 + 48 if case != "clover" else 2 * 1320 + 2 * 504 + 48
    vol = int(np.prod(SMALL))
    assert p.gflops == pytest.approx(
        p.iter_count * 2 * flops * (vol // 2) / 1e9)
    for r, (xr, pr) in enumerate(each):
        assert abs(p.iter_count_multi[r] - pr.iter_count) <= 1
        assert np.linalg.norm(x[r] - xr) / np.linalg.norm(xr) < 1e-5
        assert p.true_res_multi[r] == pytest.approx(pr.true_res, rel=0.05)


def test_batched_route_hands_the_kernels_contiguous_operands(multi_system,
                                                             monkeypatch):
    """On the card a kernel wrapper refuses a non-contiguous operand; on
    the CPU the plain versions would take one.  Every operand the batched
    route gives the multi-RHS wrappers is contiguous, and no single-RHS
    hop is called."""
    g, B = multi_system
    seen = []

    def spy(fn):
        def wrapped(*args, **kwargs):
            tensors = [a for a in list(args) + list(kwargs.values())
                       if isinstance(a, torch.Tensor)]
            seen.append(all(t.is_contiguous() for t in tensors))
            return fn(*args, **kwargs)
        return wrapped

    def single(*args, **kwargs):
        raise AssertionError("single-RHS hop on the batched route")

    for mod, name in ((wpp, "dslash_eo_pallas_packed_mrhs"),
                      (clp, "dslash_eo_pallas_post_mrhs"),
                      (clp, "dslash_eo_pallas_diag_hop_mrhs")):
        monkeypatch.setattr(mod, name, spy(getattr(mod, name)))
    for mod, name in ((wpp, "dslash_eo_pallas_packed"),
                      (clp, "dslash_eo_pallas_post"),
                      (clp, "dslash_eo_pallas_diag_hop")):
        monkeypatch.setattr(mod, name, single)
    for family in ("wilson", "clover"):
        _solve_multi(g, B[:2], dslash_type=family, csw=CSW, maxiter=3)
    assert seen and all(seen)


def test_per_source_route_reaches_df64(monkeypatch):
    """tol 1e-10 is below the batched gate: each source takes invert_quda's
    df64 route, and the low words come back stacked."""
    g = su3_gauge(HYPERCUBE, seed=133)
    B = gaussian((2,) + lattice_shape(HYPERCUBE) + (4, 3), seed=134)
    x, p = _solve_multi(g, B, dims=HYPERCUBE, tol=1e-10)
    assert p.converged and max(p.true_res_multi) < 1e-10
    assert p.x_df64_lo.shape == B.shape and p.reliable_updates > 0
    assert p.iter_count == sum(p.iter_count_multi) > 0


@pytest.mark.parametrize("dslash_type", ["laplace", "staggered"])
def test_unported_operators_raise(multi_system, dslash_type):
    """The Laplace operator waits for ROADMAP A14 (twisted mass, served
    since the zoo slice, is in test_torch_twisted.py).  Staggered
    multi-source solves are served (test_torch_staggered_mrhs.py); on
    recon-12 links they raise (ROADMAP C)."""
    g, B = multi_system
    kw = {}
    if dslash_type == "staggered":
        B, kw = B[..., :1, :], {"reconstruct": 12, "mass": 0.1,
                                "solve_type": "direct-pc"}
    with pytest.raises(NotImplementedError, match="ROADMAP (A14|C)"):
        _solve_multi(g, B, dslash_type=dslash_type, **kw)


def test_forced_split_and_shape_errors(multi_system, monkeypatch):
    g, B = multi_system
    with pytest.raises(ValueError, match="sources of shape"):
        _solve_multi(g, B[0])
    monkeypatch.setenv("QUDA_TORCH_MULTI_SRC_SPLIT", "1")
    with pytest.raises(ValueError, match="ROADMAP A15"):
        _solve_multi(g, B)
    monkeypatch.setenv("QUDA_TORCH_MULTI_SRC_SPLIT", "0")
    _, p = _solve_multi(g, B[:1], maxiter=2)
    assert p.converged_multi == [False]


def test_unconverged_lane_warns_once(multi_system, caplog):
    """A batch with lanes short of tol flags them on the param, and warns
    once per session with the lane count."""
    g, B = multi_system
    qt.init_quda(device="cpu")
    try:
        qt.load_gauge_quda(g, qt.GaugeParam(X=SMALL, cuda_prec="single"))
        with caplog.at_level("WARNING", logger="quda_tpu_torch"):
            for _ in range(2):
                p = qt.InvertParam(dslash_type="wilson", kappa=KAPPA,
                                   tol=TOL, maxiter=2, cuda_prec="single")
                qt.invert_multi_src_quda(B, p)
    finally:
        qt.end_quda()
    assert p.converged is False and p.converged_multi == [False] * NRHS
    warned = [r for r in caplog.records if "sources" in r.getMessage()]
    assert len(warned) == 1 and "3 of 3 sources" in warned[0].getMessage()


# -- slow: the JAX Pallas kernels in interpret mode, whole JAX solves -------

@pytest.mark.slow
@pytest.mark.parametrize("form", ["full", "r12"])
def test_plain_mrhs_kernels_match_jax_pallas(port_ops, form):
    """JAX's MRHS Pallas kernels (interpret mode) against the port's plain
    B5-eo (both target parities) and K1/K2-mrhs on the same operands,
    1e-6 relative."""
    psi = _batch(135, _pair_shape(ASYM))
    xc = _batch(136, _pair_shape(ASYM))
    top = port_ops[0]["wilson"][form]
    dims = tuple(top.dims)

    def j(t):
        return jnp.asarray(t.numpy())

    for p in (0, 1):
        want = jwpp.dslash_eo_pallas_packed_mrhs(
            j(top.gauge_eo_pp[p]), j(top._u_bw[p]), jnp.asarray(psi), dims,
            p, interpret=True, tb_sign=top._tb_sign)
        assert rel_err(_hop(top, _t(psi), p).numpy(),
                       np.asarray(want)) < 1e-6
    cop = port_ops[0]["clover"][form]
    p = cop.matpc
    k1, k2, _ = _clover_hops(cop, _t(psi), _t(xc))
    want = jclp.dslash_eo_pallas_post_mrhs(
        j(cop.gauge_eo_pp[1 - p]), j(cop._u_bw[1 - p]), jnp.asarray(psi),
        dims, 1 - p, blk_pl=j(cop.clover_inv_q_pp), interpret=True,
        out_dtype=jnp.float32, tb_sign=cop._tb_sign)
    assert rel_err(k1.numpy(), np.asarray(want)) < 1e-6
    want = jclp.dslash_eo_pallas_diag_hop_mrhs(
        j(cop.gauge_eo_pp[p]), j(cop._u_bw[p]), jnp.asarray(psi),
        jnp.asarray(xc), dims, p, hop_coeff=-KAPPA ** 2,
        blk_pl=j(cop.clover_p_pp), interpret=True, out_dtype=jnp.float32,
        tb_sign=cop._tb_sign)
    assert rel_err(k2.numpy(), np.asarray(want)) < 1e-6


@pytest.mark.slow
@pytest.mark.parametrize("family", ["wilson", "clover"])
def test_invert_multi_src_matches_jax(multi_system, family, monkeypatch):
    """Both packages solve the same 3-source system on 4^3x8.  JAX takes
    its batched-pairs route (QUDA_TPU_PACKED=1, split forbidden on its 8
    virtual devices): per-lane iterations within 2, solutions within
    1e-4."""
    monkeypatch.setenv("QUDA_TPU_PACKED", "1")
    monkeypatch.setenv("QUDA_TPU_MULTI_SRC_SPLIT", "0")
    g, B = multi_system
    kw = dict(dslash_type=family, inv_type="cg", solve_type="normop-pc",
              kappa=KAPPA, tol=TOL, maxiter=500, cuda_prec="single")
    if family == "clover":
        kw["csw"] = CSW
    japi.init_quda()
    try:
        japi.load_gauge_quda(g, JGaugeParam(X=SMALL, cuda_prec="single"))
        jp = JInvertParam(**kw)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            xj = np.asarray(japi.invert_multi_src_quda(B, jp))
    finally:
        japi.end_quda()
    x, p = _solve_multi(g, B, **{k: v for k, v in kw.items()
                                 if k not in ("inv_type", "solve_type")})
    assert p.converged and all(np.asarray(jp.true_res_multi) <= 10 * TOL)
    assert all(abs(a - b) <= 2 for a, b in zip(p.iter_count_multi,
                                                jp.iter_count_multi))
    assert np.linalg.norm(x - xj) / np.linalg.norm(xj) < 1e-4
