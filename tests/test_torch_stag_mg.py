"""Port parity: the staggered/HISQ multigrid slice and the staggered
operator API (the full-lattice staggered forms S2-full, S2-mrhs-full and
S1-full, ``PairStaggeredLevelOp``, the projected null-vector set-up, the
staggered ``gcr-mg`` route of invert_quda, and mat_quda /
mat_dag_mat_quda / dslash_quda for staggered, asqtad and hisq).

quda_tpu_torch against quda_tpu on the same numpy inputs (numpy seeds
351-379).  Tolerances: backward links exact (the same copies); the plain
full-lattice forms within 1e-6 relative in float32 of JAX's XLA pair
stencil (the same terms summed in another order; the plain versions take
float32 only, so there is no float64 comparison); S2-mrhs-full's lanes
and S1-full's fat + Naik sum bit for bit S2-full (one hop body); the
level operators and the complex operators within 1e-6 (f32); the coarse
links within 1e-5 of max |link| (sums of ~10^2 f32 products); the V-cycle
within 1e-5 (f32 through a level); the operator API within 1e-6 of JAX's
complex64 operators and 1e-5 of the complex128 ones; the gcr-mg route to
true_res < 5e-6 at tol 1e-6.  Naik hops need extents >= 7 (8^4 and
8x10x12x14); the fat-only hierarchy pieces run at 4^4.  The JAX
package's random streams cannot be reproduced, so the V-cycle tests share
one hierarchy's arrays (``PairMG.from_arrays``).  JAX's Pallas
full-lattice kernels in interpret mode, a JAX staggered set-up carried
across and a whole JAX staggered gcr-mg solve are ``slow``.  The CUDA
kernels meet their plain versions on the card in test_torch_cuda.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quda_tpu_torch as qt
from quda_tpu.fields.geometry import LatticeGeometry as JGeom
from quda_tpu.mg import pair as jpair
from quda_tpu.mg.gemm import build_coarse_pairs_gemm as jbuild_gemm
from quda_tpu.mg.mg import MGLevelParam as JLevelParam
from quda_tpu.models.staggered import DiracStaggered as JDiracStaggered
from quda_tpu.ops import staggered_packed as jspk
from quda_tpu.ops import staggered_pallas as jspl
from quda_tpu_torch.fields.geometry import LatticeGeometry
from quda_tpu_torch.fields.spinor import even_odd_split
from quda_tpu_torch.interfaces import quda_api as api
from quda_tpu_torch.mg import gemm, mg as mgm, pair
from quda_tpu_torch.mg.coarse import DIRS
from quda_tpu_torch.models.staggered import DiracStaggered
from quda_tpu_torch.ops import staggered_packed as spk
from quda_tpu_torch.ops import staggered_pallas as spl
from quda_tpu_torch.ops import wilson_packed as wpk

from tests.host_reference.staggered_ref import staggered_dslash_ref
from tests.torch_inputs import gaussian, lattice_shape, rel_err, su3_gauge
from tests.torch_inputs import one_torch_thread  # noqa: F401 (autouse)

CUBE8 = (8, 8, 8, 8)
WIDE = (8, 10, 12, 14)           # (X, Y, Z, T): every extent >= 7
HYPER = (4, 4, 4, 4)             # the fat-only hierarchy pieces
BLOCK = (2, 2, 2, 2)
NVEC = 4
MASS = 0.1
TOL = 1e-6


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _n(t):
    return t.detach().cpu().numpy()


def _links(dims, seed, scale=1.0, dtype=np.complex64):
    """SU(3) links of a hot gauge; ``scale`` multiplies them (HISQ long
    links are about 1/24 of unit size)."""
    return (scale * su3_gauge(dims, seed, dtype=np.complex128)).astype(dtype)


def _packed(links, dtype=torch.float32):
    return wpk.to_packed_pairs(spk.pack_links(_t(links)), dtype).contiguous()


# -- the plain full-lattice forms ---------------------------------------------

@pytest.fixture(scope="module", params=[CUBE8, WIDE], ids=["8^4", "wide"])
def stencil(request):
    """Packed fat and long links and a 3-RHS psi batch (float32)."""
    dims = request.param
    T, Z, Y, X = lattice_shape(dims)
    rng = np.random.default_rng(351)
    fat = rng.standard_normal((4, 3, 3, 2, T, Z, Y * X)).astype(np.float32)
    lng = (rng.standard_normal((4, 3, 3, 2, T, Z, Y * X)) / 24).astype(
        np.float32)
    psi = rng.standard_normal((3, 3, 2, T, Z, Y * X)).astype(np.float32)
    return dims, fat, lng, psi


def test_backward_links_match_jax(stencil):
    """``backward_links`` (full lattice, nhop 1 and 3) equals JAX's
    exactly: the same copies."""
    dims, fat, _, _ = stencil
    X = dims[0]
    for nhop in (1, 3):
        got = _n(spl.backward_links(_t(fat), X, nhop))
        want = np.asarray(jspl.backward_links(jnp.asarray(fat), X, nhop))
        assert np.array_equal(got, want)


def test_full_plain_forms_match_jax(stencil):
    """The plain S2-full (fat, and fat + Naik summed), S1-full and
    S2-mrhs-full against JAX's XLA pair stencil
    ``dslash_staggered_packed_pairs`` within 1e-6 (f32); S2-mrhs-full's
    lanes and S1-full bit for bit the S2-full passes."""
    dims, fat, lng, psi = stencil
    X, Y = dims[0], dims[1]
    tf, tl, tp = _t(fat), _t(lng), _t(psi)
    fbw = spl.backward_links(tf, X, 1)
    lbw = spl.backward_links(tl, X, 3)
    for i in range(psi.shape[0]):
        want_fat = np.asarray(jspk.dslash_staggered_packed_pairs(
            jnp.asarray(fat), jnp.asarray(psi[i]), X, Y))
        want_imp = np.asarray(jspk.dslash_staggered_packed_pairs(
            jnp.asarray(fat), jnp.asarray(psi[i]), X, Y, jnp.asarray(lng)))
        s2_fat = spl.dslash_staggered_pass(tf, fbw, tp[i], X, 1)
        s2_imp = spl.dslash_staggered_pallas(tf, fbw, tp[i], X, tl, lbw)
        s1 = spl.dslash_staggered_pallas_fused(tf, tp[i], X, tl)
        assert rel_err(_n(s2_fat), want_fat) < 1e-6
        assert rel_err(_n(s2_imp), want_imp) < 1e-6
        assert rel_err(_n(s1), want_imp) < 1e-6
        assert torch.equal(s1, s2_fat + spl.dslash_staggered_pass(
            tl, lbw, tp[i], X, 3))
    batch = spl.dslash_staggered_pallas_mrhs(tf, fbw, tp, X, tl, lbw)
    fat_b = spl.dslash_staggered_pass_mrhs(tf, fbw, tp, X, 1)
    for i in range(psi.shape[0]):
        assert torch.equal(fat_b[i],
                           spl.dslash_staggered_pass(tf, fbw, tp[i], X, 1))
        assert torch.equal(batch[i], spl.dslash_staggered_pallas_fused(
            tf, tp[i], X, tl))


def test_full_forms_restricted_to_a_parity_match_the_eo_forms(stencil):
    """Each full-lattice form, read on the parity-p sites of an input that
    lives on parity 1-p, equals the ported eo form (S1, S2) on the split
    fields within 1e-6: the hop sum maps parity 1-p to parity p."""
    dims, fat, lng, psi = stencil
    X = dims[0]
    geom = LatticeGeometry(dims)
    lat = lattice_shape(dims)

    def canon(links_pl):                   # packed pairs -> (4,T,Z,Y,X,3,3)
        c = wpk.from_packed_pairs(links_pl, torch.complex64)
        return wpk.unpack_gauge(c, lat)

    fat_c, lng_c = canon(_t(fat)), canon(_t(lng))
    fat_eo = [_packed_eo(g) for g in _split_links(fat_c, geom)]
    lng_eo = [_packed_eo(g) for g in _split_links(lng_c, geom)]
    psi_c = spk.unpack_staggered(wpk.from_packed_pairs(_t(psi[0])), lat)
    for p in (0, 1):
        src_e, src_o = even_odd_split(psi_c, geom)
        zero = torch.zeros_like(src_e)
        only = ((zero, src_o) if p == 0 else (src_e, zero))
        full_in = _packed_spinor(_join(*only, geom))
        got = spl.dslash_staggered_pallas_fused(_t(fat), full_in, X, _t(lng))
        got_p = even_odd_split(spk.unpack_staggered(
            wpk.from_packed_pairs(got), lat), geom)[p]
        eo_in = _packed_spinor(only[1 - p])
        want = spl.dslash_staggered_eo_pallas_fused(
            fat_eo[p], fat_eo[1 - p], eo_in, dims_t(dims), p,
            long_here_pl=lng_eo[p], long_there_pl=lng_eo[1 - p])
        want_c = spk.unpack_staggered(wpk.from_packed_pairs(want),
                                      geom.half_lattice_shape)
        assert rel_err(_n(got_p), _n(want_c)) < 1e-6


def dims_t(dims):
    return lattice_shape(dims)


def _split_links(g, geom):
    from quda_tpu_torch.ops.wilson import split_gauge_eo
    return split_gauge_eo(g, geom)


def _packed_eo(g):
    return wpk.to_packed_pairs(spk.pack_links(g), torch.float32).contiguous()


def _packed_spinor(x):
    return wpk.to_packed_pairs(spk.pack_staggered(x),
                               torch.float32).contiguous()


def _join(e, o, geom):
    from quda_tpu_torch.fields.spinor import even_odd_join
    return even_odd_join(e, o, geom)


# -- the fine staggered level ------------------------------------------------

@pytest.fixture(scope="module")
def level8():
    """Improved staggered on 8^4: SU(3) fat links, -1/24-scaled SU(3) long
    links (complex64), the port's and JAX's level operators (JAX on its
    XLA pair stencil) and a pair field."""
    fat = _links(CUBE8, 352)
    lng = _links(CUBE8, 353, scale=-1.0 / 24.0)
    geom = LatticeGeometry(CUBE8)
    d = DiracStaggered(_t(fat), geom, MASS, improved=True,
                       long_links=_t(lng))
    jd = JDiracStaggered(jnp.asarray(fat), JGeom(CUBE8), MASS, improved=True,
                         long_links=jnp.asarray(lng))
    op = pair.PairStaggeredLevelOp(d)
    jop = jpair.PairStaggeredLevelOp(jd, use_pallas=False)
    v = gaussian(lattice_shape(CUBE8) + (1, 3, 2), 354, dtype=np.float32)
    return fat, lng, d, op, jop, v


def test_level_op_matches_jax_and_the_complex_operator(level8):
    """PairStaggeredLevelOp's to_chiral/from_chiral, M, MdagM, diag, the
    single-direction hops, M_std_full and Mdag_std_full equal JAX's
    PairStaggeredLevelOp (XLA pair forms) within 1e-6; M_std_full equals
    the complex DiracStaggered.M (fat + Naik) and M_std the fat-only one,
    within 1e-6; the batched forms equal the single ones."""
    fat, _, d, op, jop, v = level8
    tv, jv = _t(v), jnp.asarray(v)
    c = op.to_chiral(tv)
    assert np.array_equal(_n(c), np.asarray(jop.to_chiral(jv)))
    assert torch.equal(op.from_chiral(c), tv)
    jc = jop.to_chiral(jv)
    for name in ("M", "MdagM", "diag"):
        assert rel_err(_n(getattr(op, name)(c)),
                       np.asarray(getattr(jop, name)(jc))) < 1e-6, name
    for mu, sign in ((0, 1), (1, -1), (2, 1), (3, -1)):
        assert rel_err(_n(op.hop(c, mu, sign)),
                       np.asarray(jop.hop(jc, mu, sign))) < 1e-6
    for name in ("M_std_full", "Mdag_std_full"):
        assert rel_err(_n(getattr(op, name)(tv)),
                       np.asarray(getattr(jop, name)(jv))) < 1e-6, name
    vc = torch.complex(tv[..., 0], tv[..., 1])
    assert rel_err(_n(torch.view_as_complex(op.M_std_full(tv).contiguous())),
                   _n(d.M(vc))) < 1e-6
    dfat = DiracStaggered(_t(fat), LatticeGeometry(CUBE8), MASS)
    assert rel_err(_n(torch.view_as_complex(op.M_std(tv).contiguous())),
                   _n(dfat.M(vc))) < 1e-6
    batch = torch.stack([c, 2 * c])
    mb = op.M_mrhs(batch)
    assert rel_err(_n(mb[1]), 2 * _n(op.M(c))) < 1e-6
    assert rel_err(_n(op.MdagM_mrhs(batch)[0]), _n(op.MdagM(c))) < 1e-6
    assert rel_err(_n(mb), np.asarray(jop.M_mrhs(jnp.asarray(_n(batch))))) \
        < 1e-6


def test_level_op_hop_decomposition_and_oracle(level8):
    """M = diag + the 8 single-direction hops as chiral operators (the
    probes' consistency) within 1e-6; the fat-only hop sum (S2-full's
    plain version) and the fat + Naik one (S1-full's) of the port, and
    JAX's, against tests/host_reference/staggered_ref.py (per-site loops,
    phases applied there) within 1e-5 (f32 against complex128)."""
    fat, lng, _, op, jop, v = level8
    c = op.to_chiral(_t(v))
    total = op.diag(c)
    for mu, sign in DIRS:
        total = total + op.hop(c, mu, sign)
    assert rel_err(_n(total), _n(op.M(c))) < 1e-6
    vc = (v[..., 0] + 1j * v[..., 1]).astype(np.complex128)
    f128, l128 = fat.astype(np.complex128), lng.astype(np.complex128)
    for d_port, d_jax, want in (
            (op._d_std, jop._d_std, staggered_dslash_ref(f128, vc)),
            (op._d_std_full, jop._d_std_full,
             staggered_dslash_ref(f128, vc, l128))):
        got = _n(d_port(_t(v)))
        jgot = np.asarray(d_jax(jnp.asarray(v)))
        assert rel_err(got[..., 0] + 1j * got[..., 1], want) < 1e-5
        assert rel_err(jgot[..., 0] + 1j * jgot[..., 1], want) < 1e-5


# -- the fat-only hierarchy pieces on 4^4 ------------------------------------

@pytest.fixture(scope="module")
def level4():
    """Fat-only staggered on 4^4 (the hierarchy's stencil): the port's and
    JAX's level operators and numpy chiral null vectors."""
    fat = _links(HYPER, 355)
    op = pair.PairStaggeredLevelOp(
        DiracStaggered(_t(fat), LatticeGeometry(HYPER), MASS))
    jop = jpair.PairStaggeredLevelOp(
        JDiracStaggered(jnp.asarray(fat), JGeom(HYPER), MASS),
        use_pallas=False)
    rng = np.random.default_rng(356)
    nulls = rng.standard_normal(
        (NVEC,) + lattice_shape(HYPER) + (2, 3, 2)).astype(np.float32)
    return fat, op, jop, nulls


def test_gemm_coarse_links_match_jax(level4):
    """The transfer (K = 3, parity chirality) and the GEMM-built coarse
    links from the same null vectors equal JAX's within 1e-6 and 1e-5 of
    max |link|, and the port's probe loop."""
    _, op, jop, nulls = level4
    jtr = jpair.PairTransfer.from_null_vectors(jnp.asarray(nulls), BLOCK)
    tr = pair.PairTransfer.from_null_vectors(_t(nulls), BLOCK)
    assert rel_err(_n(tr.v), np.asarray(jtr.v)) < 1e-6
    assert tr.k_fine == 3 and tr.v.shape[-3] == 16 * 3
    tr = pair.PairTransfer(_t(jtr.v), BLOCK, lattice_shape(HYPER), 3, NVEC)
    co = gemm.build_coarse_pairs_gemm(op, tr)
    jco = jbuild_gemm(jop, jtr)
    loop = pair.build_coarse_pairs(op, tr)
    assert rel_err(_n(co.x_diag), np.asarray(jco.x_diag)) < 1e-5
    assert rel_err(_n(co.x_diag), _n(loop.x_diag)) < 1e-5
    for dd in DIRS:
        assert rel_err(_n(co.y[dd]), np.asarray(jco.y[dd])) < 1e-5
        assert rel_err(_n(co.y[dd]), _n(loop.y[dd])) < 1e-5
    # Galerkin: the coarse operator is R M P of the fine level
    rng = np.random.default_rng(357)
    vc = _t(rng.standard_normal((2, 2, 2, 2, 2, NVEC, 2)).astype(np.float32))
    assert rel_err(_n(co.M(vc)), _n(tr.restrict(op.M(tr.prolong(vc))))) \
        < 1e-5


def _params(levels, **kw):
    base = dict(block=BLOCK, n_vec=NVEC, setup_iters=20, post_smooth=4,
                coarse_solver_iters=8)
    base.update(kw)
    return [mgm.MGLevelParam(**base) for _ in range(levels)]


def test_vcycle_matches_jax_on_shared_hierarchy(level4):
    """One port set-up's arrays, applied by both packages: the port's
    preconditioner (and the same arrays carried in with ``from_arrays``)
    equals JAX's V-cycle within 1e-5; verify holds on the port's."""
    fat, op, jop, _ = level4
    params = _params(1)
    mg = pair.PairMG(op, LatticeGeometry(HYPER), params,
                     torch.Generator().manual_seed(358))
    assert mg.verify(galerkin_tol=1e-5, pr_tol=1e-5)[0]["galerkin"] < 1e-5
    arrays = [{"v": _n(lv["transfer"].v), "x_diag": _n(lv["coarse"].x_diag),
               "y": {dd: _n(lv["coarse"].y[dd]) for dd in DIRS}}
              for lv in mg.levels]
    jmg = _jax_hierarchy(jop, params, arrays)
    carried = pair.PairMG.from_arrays(op.dirac, params, arrays)
    assert isinstance(carried.adapter, pair.PairStaggeredLevelOp)
    b = gaussian(lattice_shape(HYPER) + (1, 3, 2), 359, dtype=np.float32)
    want = np.asarray(jmg.precondition(jnp.asarray(b)))
    assert rel_err(_n(mg.precondition(_t(b))), want) < 1e-5
    assert rel_err(_n(carried.precondition(_t(b))), want) < 1e-5


def _jax_hierarchy(jop, params, arrays):
    """JAX's PairMG holding the given arrays (its einsum coarse form)."""
    mg = object.__new__(jpair.PairMG)
    mg.geom, mg.adapter, mg.levels = jop.geom, jop, []
    mg.params = [JLevelParam(**{f.name: getattr(p, f.name)
                                for f in dataclasses.fields(JLevelParam)})
                 for p in params]
    op, lat, k = jop, tuple(jop.geom.lattice_shape), 3
    for p, a in zip(mg.params, arrays):
        tr = jpair.PairTransfer(jnp.asarray(a["v"]), p.block, lat, k,
                                p.n_vec)
        co = jpair.PairCoarseOperator(
            jnp.asarray(a["x_diag"]),
            {dd: jnp.asarray(a["y"][dd]) for dd in DIRS}, p.n_vec)
        mg.levels.append(dict(op=op, transfer=tr, coarse=co, param=p))
        op, lat, k = co, tr.coarse_shape, p.n_vec
    return mg


def test_setup_projects_its_initial_guesses(level4):
    """The chiral space is twice the image of to_chiral: M annihilates a
    field whose components cancel.  A solve of M v = 0 from an
    unprojected random guess keeps the guess's part outside the image
    untouched (more than a third of each normalised vector is that
    garbage); the set-up projects its guesses, so its null vectors lie in
    the image, and are the unprojected vectors with the garbage removed."""
    _, op, _, nulls = level4
    bb = _t(nulls)

    def outside(v):
        n = v.shape[0]
        g = (v - op.project_null_source(v)).reshape(n, -1)
        return torch.linalg.vector_norm(g, dim=1) / torch.linalg.vector_norm(
            v.reshape(n, -1), dim=1)

    raw = mgm._null_solve_body(op.M_mrhs, bb.clone(), 5e-6, 20, False)
    proj = mgm._null_solve_body(op.M_mrhs, op.project_null_source(bb),
                                5e-6, 20, False)
    assert float(outside(raw).min()) > 0.3
    assert float(outside(proj).max()) < 1e-6
    # the same solve: the projected vectors are the unprojected ones'
    # image, renormalised
    img = mgm._normalized_batch(op.project_null_source(raw))
    assert rel_err(_n(img), _n(proj)) < 1e-4
    mg = pair.PairMG(op, LatticeGeometry(HYPER), _params(1),
                     torch.Generator().manual_seed(360))
    example = mg._example_field(lattice_shape(HYPER), 3, torch.float32,
                                torch.device("cpu"))
    nv = mg._generate_null_vectors(op, example, NVEC, _params(1)[0],
                                   torch.Generator().manual_seed(361))
    assert float(outside(nv).max()) < 1e-6


def test_refused_hierarchies(level4):
    """The Kaehler-Dirac composition is refused (ROADMAP A12), as JAX's
    pair hierarchy refuses it."""
    _, op, _, _ = level4
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        pair.PairMG(op.dirac, LatticeGeometry(HYPER), _params(1), kd=True)


# -- the API routes ------------------------------------------------------------

MG_MASS = 0.3                     # a heavy quark: few iterations on CPU


def _mg_api_params():
    return qt.MultigridParamAPI(geo_block_size=((4, 4, 4, 4),),
                                n_vec=(NVEC,), setup_iters=(20,))


def _session(dims, g, fat_long=None, reconstruct=18):
    qt.init_quda("cpu")
    qt.load_gauge_quda(g, qt.GaugeParam(X=dims, cuda_prec="single",
                                        reconstruct=reconstruct))
    if fat_long is not None:
        qt.load_fat_long_quda(*fat_long)


def _resid(dims, fat, lng, x, b, mass):
    """|b - M x| / |b| with the complex128 operator (fat + Naik)."""
    d = DiracStaggered(_t(fat).to(torch.complex128), LatticeGeometry(dims),
                       mass, improved=lng is not None,
                       long_links=(None if lng is None
                                   else _t(lng).to(torch.complex128)))
    bt = _t(b).to(torch.complex128)
    r = bt - d.M(x.to(torch.complex128))
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(bt))


@pytest.mark.parametrize("dslash_type", ["staggered", "asqtad", "hisq"])
def test_gcr_mg_route_converges_reuses_and_rebuilds(dslash_type):
    """invert_quda(gcr-mg) for the staggered family on the resident
    hierarchy converges to true_res < 5e-6 against the fat + Naik
    operator (also by the complex128 operator); a second solve at another
    mass reuses the hierarchy and solves that mass's system; new links
    (fat/long for asqtad/hisq, the gauge for fat-only staggered) make the
    next solve set the hierarchy up again."""
    fat = _links(CUBE8, 362)
    lng = None if dslash_type == "staggered" else _links(
        CUBE8, 363, scale=-1.0 / 24.0)
    b = gaussian(lattice_shape(CUBE8) + (1, 3), 364)
    _session(CUBE8, fat, None if lng is None else (fat, lng))
    try:
        ip = qt.InvertParam(dslash_type=dslash_type, inv_type="gcr-mg",
                            mass=MG_MASS, tol=TOL, solve_type="direct",
                            cuda_prec="single", gcrNkrylov=8)
        mg = qt.new_multigrid_quda(_mg_api_params(), ip)
        assert isinstance(mg.adapter, pair.PairStaggeredLevelOp)
        assert (mg.adapter.long_pl is None) == (lng is None)
        # the family's defaults: GCR smoothing, CG null vectors
        assert [(p.smoother, p.setup_solver) for p in mg.params] == \
            [("ca-gcr", "cg")]
        assert mg.null_fallbacks == []
        x = qt.invert_quda(b, ip)
        assert ip.converged and ip.true_res < 5e-6
        assert x.dtype == torch.complex64 and x.shape == b.shape
        assert _resid(CUBE8, fat, lng, x, b, MG_MASS) < 5e-6
        ip2 = dataclasses.replace(ip, mass=0.5)
        x2 = qt.invert_quda(b, ip2)
        assert api._ctx["mg"] is mg and mg.adapter.mass == MG_MASS
        assert ip2.converged and _resid(CUBE8, fat, lng, x2, b, 0.5) < 5e-6
        fat2 = _links(CUBE8, 365)
        if lng is None:
            qt.load_gauge_quda(fat2, qt.GaugeParam(X=CUBE8,
                                                   cuda_prec="single"))
        else:
            qt.load_fat_long_quda(fat2, lng)
        x3 = qt.invert_quda(b, ip)
        assert api._ctx["mg"] is not mg and ip.true_res < 5e-6
        assert _resid(CUBE8, fat2, lng, x3, b, MG_MASS) < 5e-6
        assert api._ctx["mg"].params[0].n_vec == NVEC
    finally:
        qt.end_quda()


def test_gcr_mg_rebuilds_for_another_family():
    """A resident Wilson hierarchy is set up again for a staggered solve
    (and a staggered one for Wilson): the family is part of what the
    hierarchy was built on."""
    g = _links(CUBE8, 366)
    _session(CUBE8, g)
    try:
        wp = qt.InvertParam(dslash_type="wilson", inv_type="gcr-mg",
                            kappa=0.1, tol=TOL, cuda_prec="single",
                            gcrNkrylov=8)
        mg = qt.new_multigrid_quda(_mg_api_params(), wp)
        assert (mg.params[0].smoother, mg.params[0].setup_solver) == \
            ("mr", "bicgstab")
        sp = qt.InvertParam(dslash_type="staggered", inv_type="gcr-mg",
                            mass=MG_MASS, tol=TOL, cuda_prec="single",
                            gcrNkrylov=8)
        qt.invert_quda(gaussian(lattice_shape(CUBE8) + (1, 3), 367), sp)
        assert api._ctx["mg"] is not mg and sp.true_res < 5e-6
        assert isinstance(api._ctx["mg"].adapter, pair.PairStaggeredLevelOp)
    finally:
        qt.end_quda()


def test_mg_level_solvers_by_family():
    """Every level of a staggered hierarchy smooths with GCR and solves
    its null vectors with CG on the normal equations (MR stalls and
    BiCGStab breaks down on the near anti-Hermitian operator); Wilson
    keeps MR and BiCGStab."""
    mp = qt.MultigridParamAPI(n_level=3, geo_block_size=(BLOCK, BLOCK),
                              n_vec=(NVEC, NVEC))
    for dt, want in (("hisq", ("ca-gcr", "cg")),
                     ("staggered", ("ca-gcr", "cg")),
                     ("wilson", ("mr", "bicgstab"))):
        got = api._mg_level_params(mp, dt)
        assert [(p.smoother, p.setup_solver) for p in got] == [want] * 2


@pytest.mark.parametrize("change,item", [
    ({"cuda_prec": "double"}, "A12/A7"),
    ({"reconstruct": 12}, "C")], ids=["double", "recon12"])
def test_refused_staggered_mg_routes(change, item):
    """Staggered gcr-mg at double (ROADMAP A12/A7) and on recon-12 links
    (C) raises through new_multigrid_quda and invert_quda."""
    g = _links(CUBE8, 368)
    b = gaussian(lattice_shape(CUBE8) + (1, 3), 368)
    _session(CUBE8, g, reconstruct=change.get("reconstruct", 18))
    try:
        ip = qt.InvertParam(dslash_type="staggered", inv_type="gcr-mg",
                            mass=MG_MASS, tol=TOL,
                            cuda_prec=change.get("cuda_prec", "single"))
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            qt.new_multigrid_quda(_mg_api_params(), ip)
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            qt.invert_quda(b, ip)
    finally:
        qt.end_quda()


# -- the operator API ------------------------------------------------------------

@pytest.fixture(scope="module")
def api_case():
    """8x10x12x14 links and fields, and JAX's complex64 operators on
    them."""
    fat = _links(WIDE, 369)
    lng = _links(WIDE, 370, scale=-1.0 / 24.0)
    lat = lattice_shape(WIDE)
    psi = gaussian(lat + (1, 3), 371)
    half = lat[:3] + (lat[3] // 2,)
    bo = gaussian(half + (1, 3), 372)
    jgeom = JGeom(WIDE)
    want = {}
    for dt in ("staggered", "hisq"):
        improved = dt != "staggered"
        jd = JDiracStaggered(jnp.asarray(fat), jgeom, MASS, improved=improved,
                             long_links=jnp.asarray(lng) if improved
                             else None)
        jp = jnp.asarray(psi)
        want[dt] = {"mat": np.asarray(jd.M(jp)),
                    "mdm": np.asarray(jd.Mdag(jd.M(jp)))}
    return fat, lng, psi, bo, want


@pytest.mark.parametrize("dslash_type", ["staggered", "asqtad", "hisq"])
def test_operator_api_matches_jax(api_case, dslash_type):
    """mat_quda and mat_dag_mat_quda for the staggered family (S1-full for
    asqtad/hisq, S2-full fat-only; their plain versions here) equal JAX's
    complex64 operators within 1e-6 and the port's complex128 operator
    within 1e-5; dslash_quda (S1/S2) equals the complex eo hop."""
    fat, lng, psi, bo, want = api_case
    improved = dslash_type != "staggered"
    _session(WIDE, fat, (fat, lng) if improved else None)
    try:
        p = qt.InvertParam(dslash_type=dslash_type, mass=MASS,
                           cuda_prec="single")
        got = {"mat": qt.mat_quda(psi, p), "mdm": qt.mat_dag_mat_quda(psi, p)}
        hop = qt.dslash_quda(bo, p, 0)
    finally:
        qt.end_quda()
    w = want["hisq" if improved else "staggered"]
    for name, t in got.items():
        assert t.dtype == torch.complex64 and tuple(t.shape) == psi.shape
        assert rel_err(_n(t), w[name]) < 1e-6, name
    geom = LatticeGeometry(WIDE)
    d = DiracStaggered(_t(fat).to(torch.complex128), geom, MASS,
                       improved=improved,
                       long_links=_t(lng).to(torch.complex128))
    assert rel_err(_n(got["mat"]), _n(d.M(_t(psi).to(torch.complex128)))) \
        < 1e-5
    from quda_tpu_torch.models.staggered import DiracStaggeredPC
    dpc = DiracStaggeredPC(_t(fat).to(torch.complex128), geom, MASS,
                           improved=improved,
                           long_links=_t(lng).to(torch.complex128))
    assert rel_err(_n(hop), _n(dpc.D_to(_t(bo).to(torch.complex128), 0))) \
        < 1e-5


def test_operator_api_refusals(api_case):
    """At double the staggered operator API raises naming ROADMAP A7;
    asqtad/hisq without resident fat/long links raise; a Wilson-shaped
    source is refused."""
    fat, lng, psi, _, _ = api_case
    _session(WIDE, fat)
    try:
        for api_fn in (qt.mat_quda, qt.mat_dag_mat_quda):
            with pytest.raises(NotImplementedError, match="ROADMAP A7"):
                api_fn(psi, qt.InvertParam(dslash_type="hisq", mass=MASS,
                                           cuda_prec="double"))
        with pytest.raises(RuntimeError, match="compute_ks_link_quda"):
            qt.mat_quda(psi, qt.InvertParam(dslash_type="hisq", mass=MASS,
                                            cuda_prec="single"))
        with pytest.raises(ValueError, match="trailing axes"):
            qt.mat_quda(np.zeros(lattice_shape(WIDE) + (4, 3), np.complex64),
                        qt.InvertParam(dslash_type="staggered", mass=MASS,
                                       cuda_prec="single"))
    finally:
        qt.end_quda()


# -- slow: JAX's Pallas kernels, a JAX set-up, a whole JAX solve ----------------

@pytest.mark.slow
def test_full_plain_forms_match_jax_pallas_interpret():
    """The plain S2-full, S2-mrhs-full and S1-full against JAX's Pallas
    full-lattice kernels in interpret mode (dslash_staggered_pallas,
    _mrhs, _fused) at 8^4, within 1e-6."""
    T, Z, Y, X = lattice_shape(CUBE8)
    rng = np.random.default_rng(373)
    fat = rng.standard_normal((4, 3, 3, 2, T, Z, Y * X)).astype(np.float32)
    lng = (rng.standard_normal((4, 3, 3, 2, T, Z, Y * X)) / 24).astype(
        np.float32)
    psi = rng.standard_normal((2, 3, 2, T, Z, Y * X)).astype(np.float32)
    jf, jl, jp = jnp.asarray(fat), jnp.asarray(lng), jnp.asarray(psi)
    jfb = jspl.backward_links(jf, X, 1)
    jlb = jspl.backward_links(jl, X, 3)
    tf, tl, tp = _t(fat), _t(lng), _t(psi)
    fbw, lbw = spl.backward_links(tf, X, 1), spl.backward_links(tl, X, 3)
    want = np.asarray(jspl.dslash_staggered_pallas(
        jf, jfb, jp[0], X, jl, jlb, interpret=True))
    assert rel_err(_n(spl.dslash_staggered_pallas(tf, fbw, tp[0], X, tl,
                                                  lbw)), want) < 1e-6
    want = np.asarray(jspl.dslash_staggered_pallas_fused(
        jf, jp[0], X, jl, interpret=True))
    assert rel_err(_n(spl.dslash_staggered_pallas_fused(tf, tp[0], X, tl)),
                   want) < 1e-6
    want = np.asarray(jspl.dslash_staggered_pallas_mrhs(
        jf, jfb, jp, X, jl, jlb, interpret=True))
    assert rel_err(_n(spl.dslash_staggered_pallas_mrhs(tf, fbw, tp, X, tl,
                                                       lbw)), want) < 1e-6


@pytest.mark.slow
def test_vcycle_matches_jax_hierarchy_carried_across():
    """A JAX staggered set-up's arrays carried into the port
    (``PairMG.from_arrays``): both V-cycles agree within 1e-5 and verify
    passes on the port's copy."""
    import jax
    fat = _links(HYPER, 374)
    jd = JDiracStaggered(jnp.asarray(fat), JGeom(HYPER), MASS)
    jparams = [JLevelParam(block=BLOCK, n_vec=NVEC, setup_iters=20)]
    jmg = jpair.PairMG(jd, JGeom(HYPER), jparams, key=jax.random.PRNGKey(375))
    arrays = [{"v": np.asarray(lv["transfer"].v),
               "x_diag": np.asarray(lv["coarse"].x_diag),
               "y": {dd: np.asarray(lv["coarse"].y[dd]) for dd in DIRS}}
              for lv in jmg.levels]
    d = DiracStaggered(_t(fat), LatticeGeometry(HYPER), MASS)
    params = _params(1, setup_iters=20)
    mg = pair.PairMG.from_arrays(d, params, arrays)
    assert mg.verify(galerkin_tol=1e-5, pr_tol=1e-5)[0]["galerkin"] < 1e-5
    b = gaussian(lattice_shape(HYPER) + (1, 3, 2), 376, dtype=np.float32)
    want = np.asarray(jmg.precondition(jnp.asarray(b)))
    assert rel_err(_n(mg.precondition(_t(b))), want) < 1e-5


@pytest.mark.slow
def test_gcr_mg_route_matches_jax(monkeypatch):
    """A whole hisq gcr-mg solve: the port's route and JAX's pair route
    (QUDA_TPU_PACKED=1) on the same links and source both converge, and
    their solutions agree within 1e-5 (each solves the fat + Naik system
    to true_res < 5e-6)."""
    from quda_tpu.interfaces import quda_api as japi
    from quda_tpu.interfaces.params import GaugeParam as JGaugeParam
    from quda_tpu.interfaces.params import InvertParam as JInvertParam
    from quda_tpu.interfaces.params import \
        MultigridParamAPI as JMultigridParamAPI
    monkeypatch.setenv("QUDA_TPU_PACKED", "1")
    fat = _links(CUBE8, 377)
    lng = _links(CUBE8, 378, scale=-1.0 / 24.0)
    b = gaussian(lattice_shape(CUBE8) + (1, 3), 379)
    kw = dict(dslash_type="hisq", inv_type="gcr-mg", mass=MG_MASS, tol=TOL,
              solve_type="direct", cuda_prec="single", gcrNkrylov=8)
    _session(CUBE8, fat, (fat, lng))
    try:
        ip = qt.InvertParam(**kw)
        qt.new_multigrid_quda(_mg_api_params(), ip)
        x = _n(qt.invert_quda(b, ip))
    finally:
        qt.end_quda()
    japi.init_quda()
    try:
        japi.load_gauge_quda(fat, JGaugeParam(X=CUBE8, cuda_prec="single"))
        japi.load_fat_long_quda(fat, lng)
        jp = JInvertParam(**kw)
        japi.new_multigrid_quda(
            JMultigridParamAPI(geo_block_size=((4, 4, 4, 4),),
                               n_vec=(NVEC,), setup_iters=(20,)), jp)
        jx = np.asarray(japi.invert_quda(b, jp))
    finally:
        japi.end_quda()
    assert ip.converged and ip.true_res < 5e-6
    assert jp.true_res < 5e-6
    assert rel_err(x, jx) < 1e-5
