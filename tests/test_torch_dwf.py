"""Port parity: the domain-wall slice (the (Ls, Ls) s-operator algebra, the
Möbius, Shamir, 4d- and 5d-preconditioned and EOFA operators, the
Ls-batched hop wrappers, and the domain-wall routes of invert_quda).

quda_tpu_torch against quda_tpu on the same numpy inputs, and against the
numpy site-loop oracle tests/host_reference/dwf_ref.py.  Tolerances:
exact for the NumPy s-operator algebra (the same code path), 1e-12 for
the complex128 operators, 1e-6 relative for the float32 pair operators
(whose 4d hop is B5-eo's plain version here, with Ls as the batch).
Whole JAX solves are ``slow``; each has a fast port-only twin.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quda_tpu_torch as qt
from quda_tpu.fields.geometry import LatticeGeometry as JGeom
from quda_tpu.interfaces import quda_api as japi
from quda_tpu.interfaces.params import GaugeParam as JGaugeParam
from quda_tpu.interfaces.params import InvertParam as JInvertParam
from quda_tpu.models import domain_wall as jdw
from quda_tpu.ops import dwf as jdwf
from quda_tpu_torch.fields.geometry import LatticeGeometry
from quda_tpu_torch.fields.spinor import even_odd_join, even_odd_split
from quda_tpu_torch.models import domain_wall as tdw
from quda_tpu_torch.ops import dwf as tdwf
from quda_tpu_torch.ops import dwf_pallas as dwp
from quda_tpu_torch.solvers import cg

from tests.host_reference.dwf_ref import mobius_mat_ref
from tests.torch_inputs import (ASYM, gaussian, pair_spinor_shape,
                                rel_err, su3_gauge)
from tests.torch_inputs import one_torch_thread  # noqa: F401 (autouse)

HYPERCUBE = (4, 4, 4, 4)
LS = 4
M5 = 1.8                  # this module's sign: InvertParam.m5 = -1.8
MF = 0.1
B5, C5 = 1.5, 0.5
EOFA = dict(mq1=0.04, mq2=0.5, mq3=1.0, eofa_shift=0.3)
TOL = 1e-6


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pc_pair(kind, g, geom, matpc=0, eofa_pm=True):
    """(port complex PC operator, JAX's twin) of a domain-wall kind."""
    jg, jgeom = jnp.asarray(g.numpy()), JGeom(geom.dims)
    if kind == "mobius":
        return (tdw.DiracMobiusPC(g, geom, LS, M5, MF, B5, C5, matpc=matpc),
                jdw.DiracMobiusPC(jg, jgeom, LS, M5, MF, B5, C5,
                                  matpc=matpc))
    if kind == "eofa":
        kw = dict(EOFA, eofa_pm=eofa_pm, matpc=matpc)
        return (tdw.DiracMobiusEofaPC(g, geom, LS, M5, MF, B5, C5, **kw),
                jdw.DiracMobiusEofaPC(jg, jgeom, LS, M5, MF, B5, C5, **kw))
    return (tdw.DiracDomainWall5DPC(g, geom, LS, M5, MF, matpc=matpc),
            jdw.DiracDomainWall5DPC(jg, jgeom, LS, M5, MF, matpc=matpc))


@pytest.fixture(scope="module")
def gauge128():
    return _t(su3_gauge(HYPERCUBE, seed=281, dtype=np.complex128))


def _five(geom, seed, half=True):
    site = geom.half_lattice_shape if half else geom.lattice_shape
    return gaussian((LS,) + site + (4, 3), seed=seed, dtype=np.complex128)


# -- the s-operator algebra (ops/dwf.py) -----------------------------------

def test_sop_algebra_matches_jax():
    """s_shift, m5_sop, identity_sop and SOp's product, adjoint and
    inverse are the JAX module's NumPy code: equal; apply_sop on a
    complex128 5d field within 1e-12."""
    for d in (+1, -1):
        np.testing.assert_array_equal(tdwf.s_shift(LS, MF, d),
                                      jdwf.s_shift(LS, MF, d))
    a, b = tdwf.m5_sop(LS, 4.3, -0.7, MF), jdwf.m5_sop(LS, 4.3, -0.7, MF)
    ap = tdwf.m5_sop(LS, B5, C5, MF)
    for got, want in ((a, b), (a.inv(), b.inv()), (a.adj(), b.adj()),
                      (ap @ a.inv(), jdwf.m5_sop(LS, B5, C5, MF) @ b.inv()),
                      (tdwf.identity_sop(LS), jdwf.identity_sop(LS))):
        np.testing.assert_array_equal(got.ap, want.ap)
        np.testing.assert_array_equal(got.am, want.am)
    psi = _five(LatticeGeometry(HYPERCUBE), 282)
    assert rel_err(tdwf.apply_sop(a, _t(psi)).numpy(), np.asarray(
        jdwf.apply_sop(b, jnp.asarray(psi)))) < 1e-12


def test_eofa_rank_one_matches_jax():
    for pm in (True, False):
        np.testing.assert_array_equal(
            tdw.eofa_rank_one(LS, B5, C5, M5, 0.04, 0.5, 1.0, pm, 0.3),
            jdw.eofa_rank_one(LS, B5, C5, M5, 0.04, 0.5, 1.0, pm, 0.3))


# -- the complex operators (complex128, 4^4, Ls 4) --------------------------

@pytest.mark.parametrize("b5,c5", [(1.0, 0.0), (B5, C5)],
                         ids=["shamir", "mobius"])
def test_mobius_matches_host_reference_and_jax(gauge128, b5, c5):
    """The full Möbius operator against the site-loop oracle dwf_ref and
    JAX's DiracMobius (1e-12), Mdag the adjoint of M."""
    geom = LatticeGeometry(HYPERCUBE)
    d = tdw.DiracMobius(gauge128, geom, LS, M5, MF, b5, c5)
    psi = _five(geom, 283, half=False)
    got = d.M(_t(psi)).numpy()
    assert rel_err(got, mobius_mat_ref(gauge128.numpy(), psi, M5, MF, b5,
                                       c5)) < 1e-12
    jd = jdw.DiracMobius(jnp.asarray(gauge128.numpy()), JGeom(HYPERCUBE),
                         LS, M5, MF, b5, c5)
    assert rel_err(got, np.asarray(jd.M(jnp.asarray(psi)))) < 1e-12
    y = _five(geom, 284, half=False)
    lhs = np.vdot(y, got)
    assert abs(lhs - np.vdot(d.Mdag(_t(y)).numpy(), psi)) < 1e-12 * abs(lhs)


@pytest.mark.parametrize("matpc", [0, 1])
@pytest.mark.parametrize("kind", ["mobius", "eofa", "dw5d"])
def test_pc_operators_match_jax(gauge128, kind, matpc):
    """M, Mdag, prepare and reconstruct of the 4d-PC Möbius, the EOFA
    and the 5d-PC operators against JAX's, 1e-12 in complex128."""
    geom = LatticeGeometry(HYPERCUBE)
    td, jd = _pc_pair(kind, gauge128, geom, matpc)
    x, be, bo = (_five(geom, 285 + i) for i in range(3))
    for fn in ("M", "Mdag"):
        assert rel_err(getattr(td, fn)(_t(x)).numpy(), np.asarray(
            getattr(jd, fn)(jnp.asarray(x)))) < 1e-12
    assert rel_err(td.prepare(_t(be), _t(bo)).numpy(), np.asarray(
        jd.prepare(jnp.asarray(be), jnp.asarray(bo)))) < 1e-12
    got = td.reconstruct(_t(x), _t(be), _t(bo))
    want = jd.reconstruct(jnp.asarray(x), jnp.asarray(be), jnp.asarray(bo))
    for g_, w_ in zip(got, want):
        assert rel_err(g_.numpy(), np.asarray(w_)) < 1e-12


def _split(kind, td, b, geom):
    if kind == "dw5d":
        return td.split5(b)
    e, o = zip(*(even_odd_split(v, geom) for v in b))
    return torch.stack(e), torch.stack(o)


@pytest.mark.parametrize("kind", ["mobius", "eofa", "dw5d"])
def test_pc_operator_is_the_schur_complement(gauge128, kind):
    """Port-only: with b = M x (the full operator: Möbius, EOFA, or
    Shamir for the 5d-PC one), M_pc x_p = prepare(b) and reconstruct
    gives x_q (1e-12); the 5d split and join are inverses."""
    geom = LatticeGeometry(HYPERCUBE)
    td, _ = _pc_pair(kind, gauge128, geom)
    if kind == "eofa":
        d = tdw.DiracMobiusEofa(gauge128, geom, LS, M5, MF, B5, C5, **EOFA)
    elif kind == "mobius":
        d = tdw.DiracMobius(gauge128, geom, LS, M5, MF, B5, C5)
    else:
        d = tdw.DiracDomainWall(gauge128, geom, LS, M5, MF)
    x = _t(_five(geom, 288, half=False))
    b = d.M(x)
    if kind == "dw5d":
        # the 5d-PC system is normalised: (1 - kappa5 D) x = b / (5 - m5)
        assert torch.equal(td.join5(*td.split5(x)), x)
    be, bo = _split(kind, td, b, geom)
    xe, xo = _split(kind, td, x, geom)
    assert rel_err(td.M(xe).numpy(), td.prepare(be, bo).numpy()) < 1e-12
    assert rel_err(td.reconstruct(xe, be, bo)[1].numpy(), xo.numpy()) \
        < 1e-12


# -- the pair operators (float32, 4x6x8x10, B5-eo with N = Ls) -------------

def _pair_setup(kind, matpc):
    g = _t(su3_gauge(ASYM, seed=289, dtype=np.complex128))
    geom = LatticeGeometry(ASYM)
    td, jd = _pc_pair(kind, g, geom, matpc)
    x = gaussian((LS,) + pair_spinor_shape(ASYM), seed=290 + matpc,
                 dtype=np.float32)
    return geom, td, jd, td.pairs(), x


@pytest.mark.parametrize("matpc", [0, 1])
@pytest.mark.parametrize("kind", ["mobius", "eofa", "dw5d"])
def test_pair_operators_match_complex(kind, matpc):
    """M_pairs and Mdag_pairs of the f32 pair operators (B5-eo's plain
    version with N = Ls) against the complex128 PC operator (held to
    JAX's above), 1e-6 relative; prepare and reconstruct likewise."""
    geom, td, _, top, x = _pair_setup(kind, matpc)
    xt = _t(x)
    xc = top._from_pairs(xt, torch.complex128)
    for fn in ("M", "Mdag"):
        got = getattr(top, fn + "_pairs")(xt)
        want = getattr(td, fn)(xc)
        assert rel_err(top._from_pairs(got, torch.complex128).numpy(),
                       want.numpy()) < 1e-6
    sh = (LS,) + geom.half_lattice_shape + (4, 3)
    be, bo = (_t(gaussian(sh, seed=292 + i)) for i in range(2))
    rhs = top.prepare_pairs(be, bo)
    want = td.prepare(be.to(torch.complex128), bo.to(torch.complex128))
    assert rel_err(top._from_pairs(rhs, torch.complex128).numpy(),
                   want.numpy()) < 1e-6
    got = top.reconstruct_pairs(rhs, be, bo)
    want = td.reconstruct(top._from_pairs(rhs, torch.complex128),
                          be.to(torch.complex128), bo.to(torch.complex128))
    for g_, w_ in zip(got, want):
        assert rel_err(g_.numpy(), w_.numpy()) < 1e-6


def test_ls_hop_wrappers():
    """dslash_eo_pallas_packed_ls is B5-eo on the Ls planes (its plain
    version here: each plane equals the single-RHS hop); the multi-source
    form flattens (N, Ls) into one batch; wrong layouts raise."""
    from quda_tpu_torch.ops import wilson_pallas_packed as wpp
    g = _t(su3_gauge(ASYM, seed=294))
    op = tdw.DiracMobiusPC(g, LatticeGeometry(ASYM), LS, M5, MF).pairs()
    x = _t(gaussian((2, LS) + pair_spinor_shape(ASYM), seed=295,
                    dtype=np.float32))
    args = (op.gauge_eo_pp[1], op._u_bw[1])
    one = dwp.dslash_eo_pallas_packed_ls(*args, x[0], op.dims, 1)
    for s in range(LS):
        assert torch.equal(one[s], wpp.dslash_eo_pallas_packed(
            *args, x[0, s], op.dims, 1))
    both = dwp.dslash_eo_pallas_packed_ls_mrhs(*args, x, op.dims, 1)
    assert torch.equal(both[0], one)
    with pytest.raises(ValueError, match="Ls-major"):
        dwp.dslash_eo_pallas_packed_ls(*args, x[0, 0], op.dims, 1)
    with pytest.raises(ValueError, match=r"\(N,Ls"):
        dwp.dslash_eo_pallas_packed_ls_mrhs(*args, x[0], op.dims, 1)


def test_dwf_pairs_are_float32():
    """B5-eo has float32 forms only: bf16 domain-wall pair operators
    raise, naming ROADMAP B5."""
    g = _t(su3_gauge(ASYM, seed=296))
    for td in (tdw.DiracMobiusPC(g, LatticeGeometry(ASYM), LS, M5, MF),
               tdw.DiracDomainWall5DPC(g, LatticeGeometry(ASYM), LS, M5, MF)):
        with pytest.raises(NotImplementedError, match="ROADMAP B5"):
            td.pairs(torch.bfloat16)


# -- invert_quda ----------------------------------------------------------

def _port_solve(g, b, dims=HYPERCUBE, reconstruct=18, **kw):
    qt.init_quda(device="cpu")
    try:
        qt.load_gauge_quda(g, qt.GaugeParam(X=dims, cuda_prec="single",
                                            reconstruct=reconstruct))
        base = dict(inv_type="cg", solve_type="normop-pc", mass=MF, m5=-M5,
                    Ls=LS, b5=B5, c5=C5, tol=TOL, maxiter=1000,
                    cuda_prec="single", eofa_mq1=EOFA["mq1"],
                    eofa_mq2=EOFA["mq2"], eofa_mq3=EOFA["mq3"],
                    eofa_shift=EOFA["eofa_shift"])
        base.update(kw)
        p = qt.InvertParam(**base)
        x = qt.invert_quda(b, p)
    finally:
        qt.end_quda()
    return x.numpy(), p


@pytest.fixture(scope="module")
def dwf_system():
    """A 4^4 SU(3) gauge and a 5d source (Ls 4)."""
    return (su3_gauge(HYPERCUBE, seed=297),
            _five(LatticeGeometry(HYPERCUBE), 298,
                  half=False).astype(np.complex64))


def _pc_of(dslash, g, geom):
    if dslash == "domain-wall":
        return tdw.DiracDomainWall5DPC(g, geom, LS, M5, MF)
    if dslash == "mobius-eofa":
        return tdw.DiracMobiusEofaPC(g, geom, LS, M5, MF, B5, C5, **EOFA)
    b5c5 = (B5, C5) if dslash == "mobius" else (1.0, 0.0)
    return tdw.DiracMobiusPC(g, geom, LS, M5, MF, *b5c5)


@pytest.fixture(scope="module")
def dwf_oracle(dwf_system):
    """The complex128 solution of each domain-wall system: CG on the
    normal equations of the port's complex PC operator to 1e-9, then
    reconstruct and join (computed once per dslash type)."""
    g, b = dwf_system
    geom = LatticeGeometry(HYPERCUBE)
    g128 = _t(g).to(torch.complex128)
    b128 = _t(b).to(torch.complex128)
    cache = {}

    def solve(dslash):
        if dslash not in cache:
            dpc = _pc_of(dslash, g128, geom)
            be, bo = _split("dw5d" if dslash == "domain-wall" else "", dpc,
                            b128, geom)
            res = cg(lambda v: dpc.Mdag(dpc.M(v)),
                     dpc.Mdag(dpc.prepare(be, bo)), tol=1e-9, maxiter=2000)
            assert res.converged
            xe, xo = dpc.reconstruct(res.x, be, bo)
            cache[dslash] = (dpc.join5(xe, xo) if dslash == "domain-wall"
                             else torch.stack([even_odd_join(e, o, geom)
                                               for e, o in zip(xe, xo)])
                             ).numpy(), dpc
        return cache[dslash]
    return solve


DWF_ROUTES = [("mobius", 18), ("mobius", 12), ("domain-wall-4d", 18),
              ("domain-wall", 18), ("domain-wall", 12), ("mobius-eofa", 18)]


@pytest.mark.parametrize("dslash,rec", DWF_ROUTES,
                         ids=[f"{d}-{r}" for d, r in DWF_ROUTES])
def test_invert_quda_dwf_matches_oracle(dwf_system, dwf_oracle, dslash, rec):
    """The domain-wall routes on CPU tensors (B5-eo's plain version):
    converged, true_res <= 10 tol, the residual of the solution held
    again by the site-loop oracle dwf_ref (Möbius and Shamir; the EOFA
    operator has none there), and the solution within 1e-4 of a
    complex128 solve; gflops at Ls x volume/2 sites."""
    g, b = dwf_system
    x, p = _port_solve(g, b, reconstruct=rec, dslash_type=dslash)
    assert x.shape == b.shape and x.dtype == np.complex64
    assert p.converged and p.true_res <= 10 * TOL
    want, dpc = dwf_oracle(dslash)
    x128, b128 = x.astype(np.complex128), b.astype(np.complex128)
    if dslash != "mobius-eofa":
        b5c5 = (B5, C5) if dslash == "mobius" else (1.0, 0.0)
        mx = mobius_mat_ref(g.astype(np.complex128), x128, M5, MF, *b5c5)
        assert np.linalg.norm(b128 - mx) / np.linalg.norm(b128) \
            <= 10 * TOL
    assert np.linalg.norm(x128 - want) / np.linalg.norm(want) < 1e-4
    vol = int(np.prod(HYPERCUBE))
    assert p.gflops == pytest.approx(
        p.iter_count * 2 * dpc.flops_per_site_M() * LS * vol // 2 / 1e9)


def test_dwf_multi_src_goes_source_by_source(dwf_system):
    """invert_multi_src_quda on 2 Möbius sources loops over invert_quda
    (the Ls axis already leads B5-eo's batch): each lane's iterations and
    solution are invert_quda's."""
    g, b = dwf_system
    B = np.stack([b, b[::-1].copy()])
    qt.init_quda(device="cpu")
    try:
        qt.load_gauge_quda(g, qt.GaugeParam(X=HYPERCUBE, cuda_prec="single"))
        kw = dict(dslash_type="mobius", mass=MF, m5=-M5, Ls=LS, b5=B5,
                  c5=C5, tol=TOL, maxiter=1000, cuda_prec="single")
        p = qt.InvertParam(**kw)
        xb = qt.invert_multi_src_quda(B, p).numpy()
        for i in range(2):
            pi = qt.InvertParam(**kw)
            xi = qt.invert_quda(B[i], pi).numpy()
            assert p.iter_count_multi[i] == pi.iter_count
            np.testing.assert_array_equal(xb[i], xi)
        with pytest.raises(ValueError, match="sources of shape"):
            qt.invert_multi_src_quda(B[:, 0], p)
    finally:
        qt.end_quda()


@pytest.mark.parametrize("kw", [{"cuda_prec_sloppy": "half"},
                                {"cuda_prec": "double"},
                                {"cuda_prec_sloppy": "quarter"}],
                         ids=["half", "double", "quarter"])
def test_dwf_routes_refused(dwf_system, kw):
    """Sloppy half, double and quarter raise, naming ROADMAP A7 (and B5
    for half: B5-eo has no bf16 form)."""
    g, b = dwf_system
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        _port_solve(g, b, dslash_type="mobius", **kw)


# -- slow: JAX's pair operators, whole JAX solves ---------------------------

@pytest.mark.slow
@pytest.mark.parametrize("kind", ["mobius", "eofa", "dw5d"])
def test_pair_operators_match_jax(kind):
    """M_pairs, Mdag_pairs and MdagM_pairs against JAX's pair operator
    (its xla form), 1e-6 relative (JAX's eager vmap of the pair stencil
    takes seconds per call)."""
    _, _, jd, top, x = _pair_setup(kind, 0)
    jcls = (jdw.DiracDomainWall5DPCPairs if kind == "dw5d"
            else jdw.DiracMobiusPCPairs)
    jop = jcls(jd, jnp.float32, form="xla")
    for fn in ("M_pairs", "Mdag_pairs", "MdagM_pairs"):
        assert rel_err(getattr(top, fn)(_t(x)).numpy(), np.asarray(
            getattr(jop, fn)(jnp.asarray(x)))) < 1e-6


@pytest.mark.slow
@pytest.mark.parametrize("dslash", ["mobius", "domain-wall-4d",
                                    "domain-wall", "mobius-eofa"])
def test_invert_quda_dwf_matches_jax(dwf_system, dslash, monkeypatch):
    """Both packages solve the same 5d system on 4^4 (JAX on its pair
    route, QUDA_TPU_PACKED=1): iterations within 2, solutions within
    1e-4."""
    monkeypatch.setenv("QUDA_TPU_PACKED", "1")
    g, b = dwf_system
    japi.init_quda()
    try:
        japi.load_gauge_quda(g, JGaugeParam(X=HYPERCUBE,
                                            cuda_prec="single"))
        jp = JInvertParam(dslash_type=dslash, inv_type="cg",
                          solve_type="normop-pc", mass=MF, m5=-M5, Ls=LS,
                          b5=B5, c5=C5, tol=TOL, maxiter=1000,
                          cuda_prec="single", cuda_prec_sloppy="single",
                          eofa_mq1=EOFA["mq1"], eofa_mq2=EOFA["mq2"],
                          eofa_mq3=EOFA["mq3"],
                          eofa_shift=EOFA["eofa_shift"])
        xj = np.asarray(japi.invert_quda(b, jp))
    finally:
        japi.end_quda()
    x, p = _port_solve(g, b, dslash_type=dslash)
    assert p.converged and jp.converged
    assert abs(p.iter_count - jp.iter_count) <= 2
    assert np.linalg.norm(x - xj) / np.linalg.norm(xj) < 1e-4
