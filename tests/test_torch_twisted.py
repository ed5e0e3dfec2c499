"""Port parity: the twisted slice (twisted mass, twisted clover, their
flavour doublets, the Hasenbusch twist), the twist epilogues' plain
versions, and the twisted routes of invert_quda and invert_multi_src_quda.

quda_tpu_torch against quda_tpu on the same numpy inputs.  Tolerances:
1e-12 for the complex128 operators (the same sums in another order),
1e-6 relative for the float32 pair operators.  The plain K1/K2 twist
forms (and their ``_mrhs`` twins) are held to the JAX package's staged
composition (``_Ainv_q_sign_pairs`` after the hop, ``_diag_sign_pairs``
minus kappa^2 times the hop) within 1e-6: the fused K1 multiplies by
1/(1 + a^2) where the staged inverse divides, and sums in another order.
JAX's pair and complex twisted-clover operators are built on the port's
complex128 clover term (held to JAX's in test_torch_clover.py), so no JAX
field strength is computed.  The CUDA kernels meet their plain versions
on the card in test_torch_cuda.py.  The JAX Pallas kernels in interpret
mode and whole JAX solves are ``slow``; each has a fast port-only twin.
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
from quda_tpu.models import twisted as jtw
from quda_tpu.ops import clover_pallas as jclp
from quda_tpu_torch.fields.geometry import LatticeGeometry
from quda_tpu_torch.fields.spinor import even_odd_join, even_odd_split
from quda_tpu_torch.models import clover as tmcl
from quda_tpu_torch.models import formsel
from quda_tpu_torch.models import hasenbusch as thb
from quda_tpu_torch.models import twisted as ttw
from quda_tpu_torch.models import wilson as twil
from quda_tpu_torch.ops import clover_pallas as clp
from quda_tpu_torch.solvers import cg

from tests.torch_inputs import (ASYM, gaussian, lattice_shape,
                                pair_spinor_shape, rel_err, su3_gauge)
from tests.torch_inputs import one_torch_thread  # noqa: F401 (autouse)

KAPPA = 0.12
MU = 0.12
EPS = 0.05
CSW = 1.0
HYPERCUBE = (4, 4, 4, 4)
TOL = 1e-6
FAMILIES = ("twisted-mass", "twisted-clover", "ndeg-twisted-mass",
            "ndeg-twisted-clover")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(t):
    return jnp.asarray(t.numpy())


def _port_pc(family, g, geom, matpc=0, mu=MU, eps=EPS):
    if family == "twisted-mass":
        return ttw.DiracTwistedMassPC(g, geom, KAPPA, mu, matpc=matpc)
    if family == "twisted-clover":
        return ttw.DiracTwistedCloverPC(g, geom, KAPPA, mu, CSW, matpc=matpc)
    if family == "ndeg-twisted-mass":
        return ttw.DiracNdegTwistedMassPC(g, geom, KAPPA, mu, eps,
                                          matpc=matpc)
    return ttw.DiracNdegTwistedCloverPC(g, geom, KAPPA, mu, eps, CSW,
                                        matpc=matpc)


def _port_full(family, g, geom, mu=MU, eps=EPS):
    if family == "twisted-mass":
        return ttw.DiracTwistedMass(g, geom, KAPPA, mu)
    if family == "twisted-clover":
        return ttw.DiracTwistedClover(g, geom, KAPPA, mu, CSW)
    if family == "ndeg-twisted-mass":
        return ttw.DiracNdegTwistedMass(g, geom, KAPPA, mu, eps)
    return ttw.DiracNdegTwistedClover(g, geom, KAPPA, mu, eps, CSW)


def _jax_twin(td, pc: bool):
    """The JAX package's operator of the same class as the port's ``td``,
    given the port's links and clover term: built without __init__, so
    JAX computes no field strength, but with JAX's own twisted inverses
    (the general 6x6 inverse, and the doublet's closed form)."""
    cls = getattr(jtw, type(td).__name__)
    jd = object.__new__(cls)
    jd.geom = JGeom(td.geom.dims)
    jd.kappa, jd.a = td.kappa, td.a
    jd.antiperiodic_t = td.antiperiodic_t
    if hasattr(td, "b"):
        jd.b = td.b
    if pc:
        jd.matpc = td.matpc
        jd.gauge_eo = tuple(_j(u) for u in td.gauge_eo)
    else:
        jd.gauge = _j(td.gauge)
    if hasattr(td, "clover"):
        cl = td.clover
        jd.clover = (tuple(_j(c) for c in cl) if isinstance(cl, tuple)
                     else _j(cl))
    q = 1 - getattr(td, "matpc", 0)
    if isinstance(td, ttw.DiracTwistedCloverPC):
        jd.tw_inv_q = {s: jnp.linalg.inv(jtw.twisted_clover_blocks(
            jd.clover[q], jd.a, s)) for s in (+1, -1)}
    if isinstance(td, ttw.DiracNdegTwistedCloverPC):
        aq = jd.clover[q]
        jd.dinv_q = jnp.linalg.inv(
            jnp.einsum("...ij,...jk->...ik", aq, aq)
            + (jd.a ** 2 - jd.b ** 2) * jnp.eye(6, dtype=aq.dtype))
    return jd


@pytest.fixture(scope="module")
def gauge128():
    return _t(su3_gauge(HYPERCUBE, seed=241, dtype=np.complex128))


def _field(geom, family, seed, half=True):
    site = geom.half_lattice_shape if half else geom.lattice_shape
    inner = (2, 4, 3) if family.startswith("ndeg") else (4, 3)
    return gaussian(site + inner, seed=seed, dtype=np.complex128)


# -- the complex operators (complex128, 4^4) -------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_full_operators_match_jax(gauge128, family):
    """M and Mdag of the full-lattice operators against JAX's, 1e-12;
    and <y, M x> = <Mdag y, x>."""
    geom = LatticeGeometry(HYPERCUBE)
    td = _port_full(family, gauge128, geom)
    jd = _jax_twin(td, pc=False)
    x = _field(geom, family, 242, half=False)
    y = _field(geom, family, 243, half=False)
    mx = td.M(_t(x)).numpy()
    assert rel_err(mx, np.asarray(jd.M(jnp.asarray(x)))) < 1e-12
    mdy = td.Mdag(_t(y)).numpy()
    assert rel_err(mdy, np.asarray(jd.Mdag(jnp.asarray(y)))) < 1e-12
    assert abs(np.vdot(y, mx) - np.vdot(mdy, x)) < 1e-12 * abs(np.vdot(y, mx))


@pytest.mark.parametrize("matpc", [0, 1])
@pytest.mark.parametrize("family", FAMILIES)
def test_pc_operators_match_jax(gauge128, family, matpc):
    """M, Mdag, prepare and reconstruct of the PC operators against
    JAX's, 1e-12 in complex128."""
    geom = LatticeGeometry(HYPERCUBE)
    td = _port_pc(family, gauge128, geom, matpc)
    jd = _jax_twin(td, pc=True)
    x, be, bo = (_field(geom, family, 244 + i) for i in range(3))
    assert rel_err(td.M(_t(x)).numpy(), np.asarray(jd.M(jnp.asarray(x)))) \
        < 1e-12
    assert rel_err(td.Mdag(_t(x)).numpy(),
                   np.asarray(jd.Mdag(jnp.asarray(x)))) < 1e-12
    assert rel_err(td.prepare(_t(be), _t(bo)).numpy(), np.asarray(
        jd.prepare(jnp.asarray(be), jnp.asarray(bo)))) < 1e-12
    got = td.reconstruct(_t(x), _t(be), _t(bo))
    want = jd.reconstruct(jnp.asarray(x), jnp.asarray(be), jnp.asarray(bo))
    for g_, w_ in zip(got, want):
        assert rel_err(g_.numpy(), np.asarray(w_)) < 1e-12


@pytest.mark.parametrize("family", FAMILIES)
def test_pc_operator_is_the_schur_complement(gauge128, family):
    """Port-only: M_pc x_p = prepare(M x) and reconstruct gives x_q, for
    the complex128 PC operator against the full one (1e-12), and for the
    f32 pair operator (1e-5)."""
    geom = LatticeGeometry(HYPERCUBE)
    d = _port_full(family, gauge128, geom)
    dpc = _port_pc(family, gauge128, geom)
    x = _t(_field(geom, family, 247, half=False))
    be, bo = even_odd_split(d.M(x), geom)
    xe, xo = even_odd_split(x, geom)
    assert rel_err(dpc.M(xe).numpy(), dpc.prepare(be, bo).numpy()) < 1e-12
    assert rel_err(dpc.reconstruct(xe, be, bo)[1].numpy(), xo.numpy()) \
        < 1e-12
    op = _port_pc(family, gauge128.to(torch.complex64), geom).pairs()
    c64 = [v.to(torch.complex64) for v in (be, bo, xe)]
    xe_pp = op._to_pairs(c64[2])
    assert rel_err(op.M_pairs(xe_pp).numpy(),
                   op.prepare_pairs(c64[0], c64[1]).numpy()) < 1e-5
    assert rel_err(op.reconstruct_pairs(xe_pp, c64[0], c64[1])[1].numpy(),
                   xo.numpy()) < 1e-5


def test_twisted_clover_inverse_blocks(gauge128):
    """The twisted inverse blocks are a general (non-Hermitian) 6x6
    inverse: within 1e-12 of JAX's jnp.linalg.inv of the same blocks,
    A A^-1 = 1, and far from Hermitian, so no Cholesky path applies."""
    td = ttw.DiracTwistedCloverPC(gauge128, LatticeGeometry(HYPERCUBE),
                                  KAPPA, MU, CSW)
    jd = _jax_twin(td, pc=True)
    for s in (+1, -1):
        inv = td.tw_inv_q[s].numpy()
        assert rel_err(inv, np.asarray(jd.tw_inv_q[s])) < 1e-12
        blk = ttw.twisted_clover_blocks(td.clover[1], td.a, s).numpy()
        assert np.abs(blk @ inv - np.eye(6)).max() < 1e-12
        assert np.abs(inv - np.conj(np.swapaxes(inv, -1, -2))).max() > 1e-2


# -- the pair operators and the plain twist forms (float32, 4x6x8x10) ------

@pytest.fixture(scope="module")
def pair_ops():
    """(JAX staged-XLA f32 pair operator, port f32 pair operator) per
    (family, matpc) on one 4x6x8x10 SU(3) gauge, the JAX side built on
    the port's complex128 operator (``_jax_twin``)."""
    g = _t(su3_gauge(ASYM, seed=248, dtype=np.complex128))
    geom = LatticeGeometry(ASYM)
    ops = {}
    for family in ("twisted-mass", "twisted-clover"):
        for matpc in (0, 1):
            td = _port_pc(family, g, geom, matpc)
            cls = getattr(jtw, type(td).__name__ + "Pairs")
            ops[family, matpc] = (cls(_jax_twin(td, pc=True), jnp.float32,
                                      form="xla"), td.pairs(torch.float32))
    return ops


@pytest.mark.parametrize("matpc", [0, 1])
@pytest.mark.parametrize("family", ["twisted-mass", "twisted-clover"])
def test_plain_twist_hops_match_jax_staged(pair_ops, family, matpc):
    """K1 and K2 with their twist epilogues (CPU tensors: the plain
    versions), both signs s, against the JAX package's staged
    composition: K1 = Ainv_q(s) after the hop, K2 = diag_p(s) x -
    kappa^2 hop, 1e-6 relative."""
    jop, top = pair_ops[family, matpc]
    p = matpc
    x = gaussian(pair_spinor_shape(ASYM), seed=249 + p, dtype=np.float32)
    xj, xt = jnp.asarray(x), _t(x)
    for s in (+1, -1):
        tj = jop._Ainv_q_sign_pairs(jop._d_to(xj, 1 - p, jnp.float32), s,
                                    jnp.float32)
        outj = (jop._diag_sign_pairs(xj, s, jnp.float32)
                - KAPPA ** 2 * jop._d_to(tj, p, jnp.float32))
        k1_blk, k1_tw = top._fused_k1_params(s)
        k2_blk, k2_tw = top._fused_k2_params(s)
        t = clp.dslash_eo_pallas_post(
            top.gauge_eo_pp[1 - p], top._u_bw[1 - p], xt, top.dims, 1 - p,
            blk_pl=k1_blk, twist=k1_tw, tb_sign=top._tb_sign)
        out = clp.dslash_eo_pallas_diag_hop(
            top.gauge_eo_pp[p], top._u_bw[p], t, xt, top.dims, p,
            hop_coeff=-KAPPA ** 2, blk_pl=k2_blk, diag_twist=k2_tw,
            out_dtype=torch.float32, tb_sign=top._tb_sign)
        assert rel_err(t.numpy(), np.asarray(tj)) < 1e-6
        assert rel_err(out.numpy(), np.asarray(outj)) < 1e-6


@pytest.mark.parametrize("matpc", [0, 1])
@pytest.mark.parametrize("family", ["twisted-mass", "twisted-clover"])
def test_pair_operators_match_jax(pair_ops, family, matpc):
    """M_pairs, Mdag_pairs and MdagM_pairs against JAX's (staged xla
    form), 1e-6 relative; the port's Mdag is the adjoint of its M."""
    jop, top = pair_ops[family, matpc]
    x = gaussian(pair_spinor_shape(ASYM), seed=251 + matpc,
                 dtype=np.float32)
    xj, xt = jnp.asarray(x), _t(x)
    m = top.M_pairs(xt)
    assert rel_err(m.numpy(), np.asarray(jop.M_pairs(xj))) < 1e-6
    assert rel_err(top.Mdag_pairs(xt).numpy(),
                   np.asarray(jop.Mdag_pairs(xj))) < 1e-6
    assert rel_err(top.MdagM_pairs(xt).numpy(),
                   np.asarray(jop.MdagM_pairs(xj))) < 1e-6
    y = _t(gaussian(pair_spinor_shape(ASYM), seed=253, dtype=np.float32))
    lhs = float(torch.sum(y.double() * m.double()))
    rhs = float(torch.sum(top.Mdag_pairs(y).double() * xt.double()))
    assert abs(lhs - rhs) < 1e-5 * abs(lhs)


@pytest.mark.parametrize("family", ["twisted-mass", "twisted-clover"])
def test_mrhs_forms_are_the_single_forms_lane_by_lane(pair_ops, family):
    """The batched operator (K1/K2-mrhs plain versions, B5-eo's for
    prepare and reconstruct) equals the single-RHS one on every lane,
    bit for bit; the plain multi-RHS twist hops likewise."""
    _, top = pair_ops[family, 0]
    xb = _t(gaussian((3,) + pair_spinor_shape(ASYM), seed=255,
                     dtype=np.float32))
    mb = top.M_pairs_mrhs(xb)
    mdb = top.Mdag_pairs_mrhs(xb)
    for r in range(3):
        assert torch.equal(mb[r], top.M_pairs(xb[r]))
        assert torch.equal(mdb[r], top.Mdag_pairs(xb[r]))
    geom = LatticeGeometry(ASYM)
    sh = (3,) + geom.half_lattice_shape + (4, 3)
    be, bo = (_t(gaussian(sh, seed=256 + i)) for i in range(2))
    rb = top.prepare_pairs_mrhs(be, bo)
    xe, xo = top.reconstruct_pairs_mrhs(rb, be, bo)
    for r in range(3):
        assert rel_err(rb[r].numpy(),
                       top.prepare_pairs(be[r], bo[r]).numpy()) < 1e-6
        assert rel_err(xo[r].numpy(), top.reconstruct_pairs(
            rb[r], be[r], bo[r])[1].numpy()) < 1e-6


def test_mu_zero_reduces_to_wilson_and_clover():
    """mu = 0: the twisted-mass pair operator (K1/K2 block-free forms
    with a zero twist) is the Wilson one, and the twisted-clover one
    (general inverse blocks) the clover one, 1e-6."""
    g = _t(su3_gauge(ASYM, seed=258))
    geom = LatticeGeometry(ASYM)
    x = _t(gaussian(pair_spinor_shape(ASYM), seed=259, dtype=np.float32))
    tm = ttw.DiracTwistedMassPC(g, geom, KAPPA, 0.0).pairs()
    wil = twil.DiracWilsonPC(g, geom, KAPPA).packed().pairs()
    assert rel_err(tm.MdagM_pairs(x).numpy(), wil.MdagM_pairs(x).numpy()) \
        < 1e-6
    tc = ttw.DiracTwistedCloverPC(g, geom, KAPPA, 0.0, CSW).pairs()
    cl = tmcl.DiracCloverPC(g, geom, KAPPA, CSW).pairs()
    assert rel_err(tc.MdagM_pairs(x).numpy(), cl.MdagM_pairs(x).numpy()) \
        < 1e-6


@pytest.mark.parametrize("family", ["twisted-mass", "twisted-clover"])
def test_epsilon_zero_doublet_is_two_twisted_operators(family):
    """epsilon = 0: the doublet (staged, B1 per flavour) acts on its up
    flavour as the twisted operator at +mu and on its down flavour as
    the one at -mu (both fused), 1e-6."""
    g = _t(su3_gauge(ASYM, seed=260))
    geom = LatticeGeometry(ASYM)
    nd = _port_pc("ndeg-" + family, g, geom, eps=0.0).pairs()
    up = _port_pc(family, g, geom, mu=MU).pairs()
    dn = _port_pc(family, g, geom, mu=-MU).pairs()
    x = _t(gaussian((2,) + pair_spinor_shape(ASYM), seed=261,
                    dtype=np.float32))
    for fn in ("M_pairs", "Mdag_pairs"):
        got = getattr(nd, fn)(x)
        assert rel_err(got[0].numpy(), getattr(up, fn)(x[0]).numpy()) < 1e-6
        assert rel_err(got[1].numpy(), getattr(dn, fn)(x[1]).numpy()) < 1e-6


def test_hasenbusch_twist_is_twisted_clover_with_direct_mu():
    """The Hasenbusch twist operator at mu is the twisted clover at
    mu / (2 kappa), full and PC, in complex128 (1e-12)."""
    g = _t(su3_gauge(HYPERCUBE, seed=262, dtype=np.complex128))
    geom = LatticeGeometry(HYPERCUBE)
    a = 0.05
    hb = thb.DiracCloverHasenbuschTwistPC(g, geom, KAPPA, a, CSW)
    tc = ttw.DiracTwistedCloverPC(g, geom, KAPPA, a / (2 * KAPPA), CSW)
    x = _t(_field(geom, "twisted-clover", 263))
    assert hb.a == a
    assert rel_err(hb.M(x).numpy(), tc.M(x).numpy()) < 1e-12
    full = thb.DiracCloverHasenbuschTwist(g, geom, KAPPA, a, CSW)
    xf = _t(_field(geom, "twisted-clover", 264, half=False))
    assert rel_err(full.M(xf).numpy(), ttw.DiracTwistedClover(
        g, geom, KAPPA, a / (2 * KAPPA), CSW).M(xf).numpy()) < 1e-12


def test_fused_capable_gate():
    """The degenerate operators host the fused kernels; the doublet does
    not (it runs the staged composition) and has no batched form."""
    g = _t(su3_gauge(ASYM, seed=265))
    geom = LatticeGeometry(ASYM)
    assert formsel.fused_capable(_port_pc("twisted-mass", g, geom).pairs(
        precision_form="r12")) is None
    nd = _port_pc("ndeg-twisted-mass", g, geom).pairs()
    assert "doublet" in formsel.fused_capable(nd)
    with pytest.raises(NotImplementedError, match="source by source"):
        nd.M_pairs_mrhs(torch.zeros((1, 2) + pair_spinor_shape(ASYM)))
    with pytest.raises(ValueError, match="not both"):
        top = _port_pc("twisted-clover", g, geom).pairs()
        clp.dslash_eo_pallas_post(
            top.gauge_eo_pp[1], top._u_bw[1],
            torch.zeros(pair_spinor_shape(ASYM)), top.dims, 1,
            blk_pl=top.tw_inv_q_pp[1], twist=(0.1, 1.0))


def test_twist_forms_bytes_and_flops():
    """The per-site floors of the twist forms (PERF.md): block-free K1
    768 B (f32) and 384 B (bf16), K2 864 B; the multi-RHS block-free
    forms 192 N + 576 and 288 N + 576; the twist adds 72 flop, no
    bytes."""
    bf16 = torch.bfloat16
    assert clp.bytes_per_site("post", with_blk=False) == 768
    assert clp.bytes_per_site("post", 3, bf16, with_blk=False) == 384
    assert clp.bytes_per_site("diag_hop", with_blk=False) == 864
    assert clp.bytes_per_site_mrhs("post", 12, with_blk=False) \
        == 192 * 12 + 576
    assert clp.bytes_per_site_mrhs("diag_hop", 12, with_blk=False) \
        == 288 * 12 + 576
    assert clp.flops_per_site("post", with_blk=False, twist=True) == 1392
    assert clp.flops_per_site("diag_hop", twist=True) == 1320 + 504 + 48 + 72
    assert clp.epilogue_name(False, True) == ":twist"


# -- invert_quda and invert_multi_src_quda ----------------------------------

def _port_solve(g, b, dims=HYPERCUBE, reconstruct=18, **kw):
    qt.init_quda(device="cpu")
    try:
        qt.load_gauge_quda(g, qt.GaugeParam(X=dims, cuda_prec="single",
                                            reconstruct=reconstruct))
        base = dict(inv_type="cg", solve_type="normop-pc", kappa=KAPPA,
                    mu=MU, epsilon=EPS, csw=CSW, tol=TOL, maxiter=500,
                    cuda_prec="single")
        base.update(kw)
        p = qt.InvertParam(**base)
        x = qt.invert_quda(b, p)
    finally:
        qt.end_quda()
    return x.numpy(), p


@pytest.fixture(scope="module")
def twisted_systems():
    """Per family: a 4^4 SU(3) gauge, a source, and the complex128
    solution: CG on the normal equations of the port's complex PC
    operator to 1e-12, then reconstruct."""
    g = su3_gauge(HYPERCUBE, seed=266)
    geom = LatticeGeometry(HYPERCUBE)
    out = {}
    for i, family in enumerate(FAMILIES):
        b = _field(geom, family, 267 + i, half=False).astype(np.complex64)
        dpc = _port_pc(family, _t(g).to(torch.complex128), geom)
        be, bo = even_odd_split(_t(b).to(torch.complex128), geom)
        res = cg(lambda v: dpc.Mdag(dpc.M(v)), dpc.Mdag(dpc.prepare(be, bo)),
                 tol=1e-12, maxiter=1000)
        assert res.converged
        out[family] = (g, b, even_odd_join(*dpc.reconstruct(res.x, be, bo),
                                           geom).numpy())
    return out


ROUTES = [("twisted-mass", "single", 18), ("twisted-mass", "half", 18),
          ("twisted-mass", "half", 12), ("twisted-clover", "single", 18),
          ("twisted-clover", "half", 12), ("ndeg-twisted-mass", "single", 18),
          ("ndeg-twisted-mass", "half", 18),
          ("ndeg-twisted-clover", "single", 12)]


@pytest.mark.parametrize("family,sloppy,rec", ROUTES,
                         ids=[f"{f}-{s}-{r}" for f, s, r in ROUTES])
def test_invert_quda_twisted_matches_oracle(twisted_systems, family, sloppy,
                                            rec):
    """The twisted routes on CPU tensors (plain versions of every
    kernel): converged, true_res <= 10 tol (the complex operator), the
    solution within 1e-4 of a complex128 solve; half takes reliable
    updates; gflops at the operator's flops per site."""
    g, b, want = twisted_systems[family]
    x, p = _port_solve(g, b, reconstruct=rec, dslash_type=family,
                       cuda_prec_sloppy=sloppy)
    assert x.shape == b.shape and x.dtype == np.complex64
    assert p.converged and p.true_res <= 10 * TOL
    assert (p.reliable_updates >= 1) == (sloppy == "half")
    assert np.linalg.norm(x - want) / np.linalg.norm(want) < 1e-4
    flops = {"twisted-mass": 2 * 1320 + 192,
             "twisted-clover": 2 * 1320 + 2 * 504 + 48,
             "ndeg-twisted-mass": 2 * 2 * 1320 + 384,
             "ndeg-twisted-clover": 2 * (2 * 1320 + 2 * 504 + 48)}[family]
    vol = int(np.prod(HYPERCUBE))
    assert p.gflops == pytest.approx(p.iter_count * 2 * flops * vol // 2
                                     / 1e9)


@pytest.mark.parametrize("family", FAMILIES)
def test_invert_multi_src_twisted_matches_invert_quda(family):
    """3 sources: twisted mass and twisted clover take the batched route
    (K1/K2-mrhs plain versions), the doublets go source by source; every
    lane takes invert_quda's iterations on its source, solutions within
    1e-5."""
    g = su3_gauge(HYPERCUBE, seed=271)
    geom = LatticeGeometry(HYPERCUBE)
    B = np.stack([_field(geom, family, 272 + i, half=False)
                  for i in range(3)]).astype(np.complex64)
    qt.init_quda(device="cpu")
    try:
        qt.load_gauge_quda(g, qt.GaugeParam(X=HYPERCUBE, cuda_prec="single"))
        kw = dict(dslash_type=family, inv_type="cg", solve_type="normop-pc",
                  kappa=KAPPA, mu=MU, epsilon=EPS, csw=CSW, tol=TOL,
                  maxiter=500, cuda_prec="single")
        p = qt.InvertParam(**kw)
        xb = qt.invert_multi_src_quda(B, p).numpy()
        singles = []
        for i in range(3):
            pi = qt.InvertParam(**kw)
            singles.append((qt.invert_quda(B[i], pi).numpy(), pi))
    finally:
        qt.end_quda()
    assert xb.shape == B.shape and p.converged
    for i, (xi, pi) in enumerate(singles):
        assert p.iter_count_multi[i] == pi.iter_count
        assert p.true_res_multi[i] <= 10 * TOL
        assert np.linalg.norm(xb[i] - xi) / np.linalg.norm(xi) < 1e-5


def test_twisted_routes_refused():
    """Double and quarter precision on the twisted families name
    ROADMAP A7; the operator API serves twisted clover: mat_quda on the
    full-lattice clover operator with the twist within 1e-6 of JAX's M
    (JAX's operator built on the port's clover term, ``_jax_twin``)."""
    g = su3_gauge(HYPERCUBE, seed=276)
    b = gaussian(lattice_shape(HYPERCUBE) + (4, 3), seed=277)
    for kw in ({"cuda_prec": "double"}, {"cuda_prec_sloppy": "quarter"}):
        with pytest.raises(NotImplementedError, match="ROADMAP A7"):
            _port_solve(g, b, dslash_type="twisted-mass", **kw)
    qt.init_quda(device="cpu")
    try:
        qt.load_gauge_quda(g, qt.GaugeParam(X=HYPERCUBE, cuda_prec="single"))
        got = qt.mat_quda(b, qt.InvertParam(
            dslash_type="twisted-clover", kappa=KAPPA, mu=MU, csw=CSW,
            cuda_prec="single")).numpy()
    finally:
        qt.end_quda()
    geom = LatticeGeometry(HYPERCUBE)
    jd = _jax_twin(_port_full("twisted-clover", _t(g), geom), pc=False)
    assert rel_err(got, np.asarray(jd.M(jnp.asarray(b)))) < 1e-6


# -- slow: the JAX Pallas kernels in interpret mode, whole JAX solves ------

@pytest.mark.slow
@pytest.mark.parametrize("store", ["f32", "bf16"])
def test_plain_twist_hops_match_jax_pallas_kernel(pair_ops, store):
    """JAX's fused kernels (interpret mode) with their twist epilogues
    against the port's plain K1/K2 on the same operands: f32 within
    1e-6, bf16 within one bf16 ulp of max |out|."""
    dt_t = torch.float32 if store == "f32" else torch.bfloat16
    dt_j = jnp.float32 if store == "f32" else jnp.bfloat16
    tol = 1e-6 if store == "f32" else 2.0 ** -7

    def both(t):
        t = t.to(dt_t).contiguous()
        return t, jnp.asarray(t.float().numpy()).astype(dt_j)

    for family in ("twisted-mass", "twisted-clover"):
        _, top = pair_ops[family, 0]
        x = gaussian(pair_spinor_shape(ASYM), seed=278, dtype=np.float32)
        xt, xj = both(_t(x))
        dims = tuple(top.dims)
        (uq, uqj), (bq, bqj) = both(top.gauge_eo_pp[1]), both(top._u_bw[1])
        (up, upj), (bp, bpj) = both(top.gauge_eo_pp[0]), both(top._u_bw[0])
        k1_blk, k1_tw = top._fused_k1_params(-1)
        k2_blk, k2_tw = top._fused_k2_params(-1)
        k1b, k1bj = both(k1_blk) if k1_blk is not None else (None, None)
        k2b, k2bj = both(k2_blk) if k2_blk is not None else (None, None)
        tj = jclp.dslash_eo_pallas_post(uqj, bqj, xj, dims, 1, blk_pl=k1bj,
                                        twist=k1_tw, interpret=True,
                                        out_dtype=dt_j)
        t = clp.dslash_eo_pallas_post(uq, bq, xt, dims, 1, blk_pl=k1b,
                                      twist=k1_tw, out_dtype=dt_t)
        assert rel_err(t.float().numpy(),
                       np.asarray(tj.astype(jnp.float32))) <= tol
        outj = jclp.dslash_eo_pallas_diag_hop(
            upj, bpj, tj, xj, dims, 0, hop_coeff=-KAPPA ** 2, blk_pl=k2bj,
            diag_twist=k2_tw, interpret=True, out_dtype=jnp.float32)
        out = clp.dslash_eo_pallas_diag_hop(
            up, bp, _t(np.asarray(tj.astype(jnp.float32))).to(dt_t), xt,
            dims, 0, hop_coeff=-KAPPA ** 2, blk_pl=k2b, diag_twist=k2_tw,
            out_dtype=torch.float32)
        assert rel_err(out.numpy(), np.asarray(outj)) < 1e-6


@pytest.mark.slow
@pytest.mark.parametrize("family,sloppy", [
    ("twisted-mass", "single"), ("twisted-mass", "half"),
    ("twisted-clover", "single"), ("ndeg-twisted-mass", "single"),
    ("ndeg-twisted-clover", "single")])
def test_invert_quda_twisted_matches_jax(twisted_systems, family, sloppy,
                                        monkeypatch):
    """Both packages solve the same system on 4^4; JAX takes its pair
    route (QUDA_TPU_PACKED=1): iterations within 2 (single) or 10%
    (half), solutions within 1e-4."""
    monkeypatch.setenv("QUDA_TPU_PACKED", "1")
    g, b, _ = twisted_systems[family]
    japi.init_quda()
    try:
        japi.load_gauge_quda(g, JGaugeParam(X=HYPERCUBE,
                                            cuda_prec="single"))
        jp = JInvertParam(dslash_type=family, inv_type="cg",
                          solve_type="normop-pc", kappa=KAPPA, mu=MU,
                          epsilon=EPS, csw=CSW, tol=TOL, maxiter=500,
                          cuda_prec="single", cuda_prec_sloppy=sloppy)
        xj = np.asarray(japi.invert_quda(b, jp))
    finally:
        japi.end_quda()
    x, p = _port_solve(g, b, dslash_type=family, cuda_prec_sloppy=sloppy)
    assert p.converged and jp.converged
    assert p.true_res <= 10 * TOL and jp.true_res <= 10 * TOL
    di = abs(p.iter_count - jp.iter_count)
    assert di <= (2 if sloppy == "single" else 0.1 * jp.iter_count + 1)
    assert np.linalg.norm(x - xj) / np.linalg.norm(xj) < 1e-4
