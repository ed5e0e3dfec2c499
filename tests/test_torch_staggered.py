"""Port parity: the staggered / HISQ slice (KS phases, the staggered
stencils, the HISQ construction, the S1/S2 plain versions, the staggered
pair operator, multi-shift CG, and invert_quda / invert_multishift_quda on
the staggered family).

quda_tpu_torch against quda_tpu on the same numpy inputs (numpy seeds
141-170), against tests/host_reference/staggered_ref.py, and against the
port's own complex operators.  Tolerances: phases and backward links
exact (the same arithmetic); the complex stencil 1e-12 against the host
reference (complex128); the pair stencils and the kernels' plain versions
1e-6 relative in f32 against JAX's XLA pair stencil (the same terms,
summed in another order); multi-shift CG per-shift x within 1e-5 (f32)
and 1e-12 (f64), iterations equal; solves converged with true_res <=
1e-5 at tol 1e-6.  The Naik hops are held on lattices whose every extent
is >= 7 (8^4, and the non-cubic 8x10x12x14), where a 3-hop aliases no
shorter hop.  The CUDA kernels meet their plain versions on the card in
test_torch_cuda.py.  Comparisons that compile JAX (the HISQ construction,
the Pallas kernels in interpret mode, whole JAX solves) are ``slow``;
each has a fast twin here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quda_tpu_torch as qt
from quda_tpu.fields.geometry import LatticeGeometry as JGeom
from quda_tpu.gauge import hisq as jhisq
from quda_tpu.interfaces import quda_api as japi
from quda_tpu.interfaces.params import GaugeParam as JGaugeParam
from quda_tpu.interfaces.params import InvertParam as JInvertParam
from quda_tpu.ops import boundary as jbnd
from quda_tpu.ops import staggered_packed as jspk
from quda_tpu.ops import staggered_pallas as jspl
from quda_tpu.solvers import multishift as jms
from quda_tpu_torch.fields.gauge import GaugeField
from quda_tpu_torch.fields.geometry import LatticeGeometry
from quda_tpu_torch.fields.spinor import even_odd_split
from quda_tpu_torch.gauge import hisq
from quda_tpu_torch.models import staggered as mstag
from quda_tpu_torch.ops import boundary as bnd
from quda_tpu_torch.ops import staggered as sops
from quda_tpu_torch.ops import staggered_packed as spk
from quda_tpu_torch.ops import staggered_pallas as spl
from quda_tpu_torch.ops import wilson_packed as wpk
from quda_tpu_torch.ops.shift import shift
from quda_tpu_torch.ops.su3 import dagger, mat_mul
from quda_tpu_torch.solvers.multishift import multishift_cg
from quda_tpu_torch.utils.convert import fat_long_from_host

from tests.host_reference.staggered_ref import staggered_dslash_ref
from tests.torch_inputs import gaussian, lattice_shape, rel_err, su3_gauge
from tests.torch_inputs import one_torch_thread  # noqa: F401 (autouse)

HYPERCUBE = (4, 4, 4, 4)
CUBE8 = (8, 8, 8, 8)
WIDE = (8, 10, 12, 14)           # (X, Y, Z, T): every extent >= 7
MASS = 0.1
TOL = 1e-6
SHIFTS = (0.0, 5e-4, 2e-3, 8e-3, 3e-2, 0.12, 0.5, 2.0)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _links(dims, seed, dtype=np.complex128, scale=1.0):
    """SU(3) links of a hot gauge (Haar-like); ``scale`` multiplies them
    (the HISQ long links are about 1/24 of unit size)."""
    return (scale * su3_gauge(dims, seed, dtype=np.complex128)).astype(dtype)


# -- phases and the complex stencil ------------------------------------

@pytest.mark.parametrize("nhop", [1, 3])
def test_staggered_phases_bit_exact(nhop):
    geom = LatticeGeometry(WIDE)
    np.testing.assert_array_equal(bnd.staggered_phases_milc(geom),
                                  jbnd.staggered_phases_milc(JGeom(WIDE)))
    g = _links(WIDE, seed=141)
    for ap in (True, False):
        got = bnd.apply_staggered_phases(_t(g), geom, ap, nhop=nhop)
        want = jbnd.apply_staggered_phases(jnp.asarray(g), JGeom(WIDE), ap,
                                           nhop=nhop)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the boundary: all of the last nhop t planes (three for the long
    # links), no more
    t_links = bnd.apply_staggered_phases(_t(g), geom, True, nhop=nhop)[3]
    free = bnd.apply_staggered_phases(_t(g), geom, False, nhop=nhop)[3]
    T = geom.T
    assert torch.equal(t_links[:T - nhop], free[:T - nhop])
    assert torch.equal(t_links[T - nhop:], -free[T - nhop:])


@pytest.mark.parametrize("improved", [False, True])
def test_dslash_full_matches_host_reference(improved):
    dims = (4, 6, 4, 8)
    fat = _links(dims, seed=142)
    lng = _links(dims, seed=143) if improved else None
    psi = gaussian(lattice_shape(dims) + (1, 3), seed=144,
                   dtype=np.complex128)
    d = mstag.DiracStaggered(_t(fat), LatticeGeometry(dims), MASS,
                             improved, None if lng is None else _t(lng))
    want = staggered_dslash_ref(fat, psi, lng)
    assert rel_err(d.D(_t(psi)).numpy(), want) < 1e-12
    if not improved:
        # D is the sum of the eight single-direction hops
        hops = sum(sops.hop_term(d.fat, _t(psi), mu, sign)
                   for mu in range(4) for sign in (+1, -1))
        assert rel_err(hops.numpy(), want) < 1e-12
    # M = 2m + D, Mdag = 2m - D (D anti-Hermitian)
    np.testing.assert_allclose(d.M(_t(psi)).numpy(), 2 * MASS * psi + want,
                               atol=1e-12)
    np.testing.assert_allclose(d.Mdag(_t(psi)).numpy(),
                               2 * MASS * psi - want, atol=1e-12)


def test_dslash_eo_is_the_full_stencil_on_parities():
    """The checkerboarded hops are the full-lattice stencil restricted
    to a parity (improved, complex128, every extent >= 7)."""
    geom = LatticeGeometry(WIDE)
    fat = bnd.apply_staggered_phases(_t(_links(WIDE, 145)), geom)
    lng = bnd.apply_staggered_phases(_t(_links(WIDE, 146, scale=0.1)),
                                     geom, nhop=3)
    from quda_tpu_torch.ops.wilson import split_gauge_eo
    psi = _t(gaussian(lattice_shape(WIDE) + (1, 3), seed=147,
                      dtype=np.complex128))
    full = sops.dslash_full(fat, psi, lng)
    fe, le = split_gauge_eo(fat, geom), split_gauge_eo(lng, geom)
    pe, po = even_odd_split(psi, geom)
    de, do = even_odd_split(full, geom)
    for p, src, want in ((0, po, de), (1, pe, do)):
        got = sops.dslash_eo(fe, src, geom, p, le)
        assert rel_err(got.numpy(), want.numpy()) < 1e-13


# -- the pair stencils and the kernels' plain versions --------------------

def _pair_fields(dims, seed):
    """(fat_eo_pp, long_eo_pp, psi_pp): f32 pair arrays of random links
    (unit-size fat, 1/24-size long) and a Gaussian spinor."""
    T, Z, Y, X = lattice_shape(dims)
    sites = (T, Z, Y * X // 2)
    rng = np.random.default_rng(seed)
    fat = tuple(rng.standard_normal((4, 3, 3, 2) + sites).astype(np.float32)
                for _ in range(2))
    lng = tuple((rng.standard_normal((4, 3, 3, 2) + sites) / 24
                 ).astype(np.float32) for _ in range(2))
    psi = rng.standard_normal((3, 2) + sites).astype(np.float32)
    return fat, lng, psi


@pytest.fixture(scope="module", params=[CUBE8, WIDE],
                ids=["8^4", "8x10x12x14"])
def pair_case(request):
    dims = request.param
    fat, lng, psi = _pair_fields(dims, seed=148 if dims == CUBE8 else 149)
    jdims = lattice_shape(dims)
    jax_out = {}
    for p in (0, 1):
        for improved in (False, True):
            jax_out[(p, improved)] = np.asarray(
                jspk.dslash_staggered_eo_packed_pairs(
                    tuple(map(jnp.asarray, fat)), jnp.asarray(psi), jdims, p,
                    tuple(map(jnp.asarray, lng)) if improved else None,
                    out_dtype=jnp.float32))
    return dims, fat, lng, psi, jax_out


@pytest.mark.parametrize("improved", [False, True],
                         ids=["fat-only", "fat+naik"])
@pytest.mark.parametrize("parity", [0, 1])
def test_pair_stencil_and_plain_kernels_match_jax(pair_case, parity,
                                                  improved):
    """The port's XLA pair stencil, the plain S1 (improved) and S2 (fat
    only, and fat + Naik as two passes summed) against the JAX package's
    ``dslash_staggered_eo_packed_pairs``, 1e-6 relative."""
    dims, fat, lng, psi, jax_out = pair_case
    want = jax_out[(parity, improved)]
    d = lattice_shape(dims)
    f, lg, ps = tuple(map(_t, fat)), tuple(map(_t, lng)), _t(psi)
    got = spk.dslash_staggered_eo_packed_pairs(f, ps, d, parity,
                                               lg if improved else None)
    assert rel_err(got.numpy(), want) < 1e-6
    q = 1 - parity
    fbw = spl.backward_links_eo(f[q], d, parity, 1)
    if improved:
        s1 = spl.dslash_staggered_eo_fused_plain(f[parity], f[q], ps, d,
                                                 parity, lg[parity], lg[q])
        assert rel_err(s1.numpy(), want) < 1e-6
        lbw = spl.backward_links_eo(lg[q], d, parity, 3)
        two = spl.dslash_staggered_eo_pallas(f[parity], fbw, ps, d, parity,
                                             lg[parity], lbw)
        # the fused sum is the two passes' sum, term for term
        assert torch.equal(two, s1)
    else:
        s2 = spl.dslash_staggered_eo_pass_plain(f[parity], fbw, ps, d,
                                                parity, 1)
        assert rel_err(s2.numpy(), want) < 1e-6


@pytest.mark.parametrize("nhop", [1, 3])
def test_backward_links_eo_match_jax(nhop):
    fat, _, _ = _pair_fields(WIDE, seed=150)
    d = lattice_shape(WIDE)
    for p in (0, 1):
        got = spl.backward_links_eo(_t(fat[1 - p]), d, p, nhop)
        want = jspl.backward_links_eo(jnp.asarray(fat[1 - p]), d, p, nhop)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_full_pair_stencil_matches_complex():
    """The full-lattice pair stencil on packed links equals dslash_full
    (improved, every extent >= 7) within f32 rounding."""
    geom = LatticeGeometry(WIDE)
    fat = bnd.apply_staggered_phases(_t(_links(WIDE, 167)), geom)
    lng = bnd.apply_staggered_phases(_t(_links(WIDE, 168, scale=1 / 24)),
                                     geom, nhop=3)
    psi = _t(gaussian(lattice_shape(WIDE) + (1, 3), seed=169,
                      dtype=np.complex128))
    want = sops.dslash_full(fat, psi, lng)
    pairs = [wpk.to_packed_pairs(spk.pack_links(u), torch.float32)
             for u in (fat, lng)]
    got = spk.dslash_staggered_packed_pairs(
        pairs[0], wpk.to_packed_pairs(spk.pack_staggered(psi),
                                      torch.float32),
        geom.X, geom.Y, pairs[1])
    got = spk.unpack_staggered(wpk.from_packed_pairs(got, torch.complex128),
                               geom.lattice_shape)
    assert rel_err(got.numpy(), want.numpy()) < 1e-6


def test_pair_stencil_matches_complex_eo():
    """The pair stencil on packed links equals the complex dslash_eo
    (improved, complex128 in, f32 pairs) within f32 rounding; pack and
    unpack round-trip exactly."""
    geom = LatticeGeometry(WIDE)
    dpc = mstag.DiracStaggeredPC(_t(_links(WIDE, 151)), geom, MASS, True,
                                 _t(_links(WIDE, 152, scale=1 / 24)))
    op = dpc.pairs(torch.float32)
    psi = _t(gaussian(geom.half_lattice_shape + (1, 3), seed=153,
                      dtype=np.complex64))
    assert torch.equal(op._from_pairs(op._to_pairs(psi), psi.dtype), psi)
    for p in (0, 1):
        want = dpc.D_to(psi.to(torch.complex128), p)
        got = op._from_pairs(op.D_to_pairs(op._to_pairs(psi), p,
                                           torch.float32),
                             torch.complex128)
        assert rel_err(got.numpy(), want.numpy()) < 1e-6


# -- the pair operator ---------------------------------------------------

@pytest.fixture(scope="module")
def stag_ops():
    """Port complex DiracStaggeredPC (complex128) and its f32 pair
    operators, improved, on WIDE."""
    geom = LatticeGeometry(WIDE)
    dpc = mstag.DiracStaggeredPC(_t(_links(WIDE, 154)), geom, MASS, True,
                                 _t(_links(WIDE, 155, scale=1 / 24)))
    return dpc, {f: dpc.pairs(torch.float32, form=f)
                 for f in mstag.STAGGERED_FORMS}


def test_pair_operator_matches_complex(stag_ops):
    """M_pairs, prepare_pairs and reconstruct_pairs against the complex
    operator (f32 against complex128, 1e-6), both forms bit for bit."""
    dpc, ops = stag_ops
    geom = dpc.geom
    x = _t(gaussian(geom.half_lattice_shape + (1, 3), seed=156,
                    dtype=np.complex128))
    b = _t(gaussian(geom.lattice_shape + (1, 3), seed=157,
                    dtype=np.complex128))
    be, bo = even_odd_split(b, geom)
    op = ops["fused"]
    m = op._from_pairs(op.M_pairs(op._to_pairs(x)), torch.complex128)
    assert rel_err(m.numpy(), dpc.M(x).numpy()) < 1e-6
    rhs = op._from_pairs(op.prepare_pairs(be, bo), torch.complex128)
    assert rel_err(rhs.numpy(), dpc.prepare(be, bo).numpy()) < 1e-6
    xe, xo = op.reconstruct_pairs(op._to_pairs(x), be, bo)
    we, wo = dpc.reconstruct(x, be, bo)
    assert rel_err(xo.numpy(), wo.numpy()) < 1e-6
    xp = op._to_pairs(x)
    assert torch.equal(ops["two_pass"].M_pairs(xp), op.M_pairs(xp))
    assert ops["two_pass"]._fat_bw is not None and op._fat_bw is None


def test_pair_operator_forms_and_refusals(stag_ops):
    """The form follows the family (fused for improved, two_pass for
    fat-only) unless the caller names one; v3 is served (the copy-free
    pass: tests/test_torch_fold_v3.py)."""
    dpc, _ = stag_ops
    fat_only = mstag.DiracStaggeredPC(dpc.fat_eo[0].new_zeros(()).expand(
        (4,) + dpc.geom.lattice_shape + (3, 3)).clone(), dpc.geom, MASS)
    assert fat_only.pairs(torch.bfloat16).form == "two_pass"
    assert fat_only.pairs(torch.bfloat16, form="fused").form == "two_pass"
    assert dpc.pairs(torch.float32).form == "fused"
    assert dpc.pairs(torch.float32, form="two_pass").form == "two_pass"
    with pytest.raises(NotImplementedError, match="ROADMAP A15"):
        dpc.pairs(torch.float32, mesh=object())
    with pytest.raises(NotImplementedError, match="ROADMAP C"):
        dpc.pairs(torch.float32, precision_form="r12")
    assert dpc.pairs(torch.float32, form="v3").form == "v3"
    with pytest.raises(ValueError, match="fat\\+Naik"):
        spl.dslash_staggered_eo_pallas_fused(*([torch.zeros(1)] * 3),
                                             (2, 2, 2, 2), 0)


def test_jax_signed_recon12_misses_hisq_long_links():
    """Why the port refuses recon-12 staggered links (ROADMAP C): the JAX
    package's ``to_recon12_signed`` rebuilds row 2 as sign conj(r0 x r1),
    exact for +-SU(3) links only.  HISQ long links are -1/24 W W W with W
    in U(3), so the rebuilt row (of size (1/24)^2) misses the stored one
    (of size 1/24) by nearly all of it, on the KS-phased packed pair
    links of a random 4^4 gauge."""
    from quda_tpu.ops import su3 as jsu3
    geom = LatticeGeometry(HYPERCUBE)
    g = GaugeField.random(geom, np.random.default_rng(166), scale=0.7,
                          device="cpu").data
    links = hisq.hisq_fattening(g)
    op = mstag.DiracStaggeredPC(links.fat, geom, MASS, True,
                                links.long).pairs(torch.float32)
    lp = jnp.asarray(op.long_eo_pp[0].numpy())
    _, sign = jsu3.to_recon12_signed(lp)
    u = np.asarray(lp[..., 0, :, :, :] + 1j * lp[..., 1, :, :, :])
    r0, r1, r2 = u[:, 0], u[:, 1], u[:, 2]
    rebuilt = np.conj(np.stack([r0[:, 1] * r1[:, 2] - r0[:, 2] * r1[:, 1],
                                r0[:, 2] * r1[:, 0] - r0[:, 0] * r1[:, 2],
                                r0[:, 0] * r1[:, 1] - r0[:, 1] * r1[:, 0]],
                               axis=1)) * np.asarray(sign)[:, None]
    miss = np.abs(rebuilt - r2).max()
    assert miss > 0.9 * np.abs(r2).max()


# -- HISQ: the fast twins of the JAX comparison ----------------------------

def _gauge_transform(gauge, g):
    return torch.stack([mat_mul(mat_mul(g, gauge[mu]),
                                dagger(shift(g, mu, +1)))
                        for mu in range(4)])


@pytest.fixture(scope="module")
def hot4():
    """A random SU(3) gauge exp(i 0.4 H), H Gaussian in su(3) (the JAX
    package's HISQ test field), complex128."""
    return GaugeField.random(LatticeGeometry(HYPERCUBE),
                             np.random.default_rng(158), scale=0.4,
                             device="cpu").data


def test_unit_gauge_fattening():
    """On the unit gauge every staple is 1: the fat links are a uniform
    real multiple of 1, W = 1 and the long links -1/24."""
    u = torch.eye(3, dtype=torch.complex128).expand(
        (4,) + lattice_shape(HYPERCUBE) + (3, 3)).clone()
    fat = hisq.fat_links(u, hisq.FAT7_COEFFS)
    f0 = fat[0, 0, 0, 0, 0]
    assert torch.allclose(fat, f0.expand_as(fat), atol=1e-12)
    assert torch.allclose(f0, f0[0, 0].real * torch.eye(
        3, dtype=torch.complex128), atol=1e-12)
    # one-link 1/8 + 6 three-staples /16 + 12 five-staples * 2/2 /64
    # + 24 seven-staples * 4 /6/384... = 1 for the fat7 set
    links = hisq.hisq_fattening(u)
    eye = torch.eye(3, dtype=torch.complex128)
    assert torch.allclose(links.w_unitarized, eye.expand_as(u), atol=1e-12)
    assert torch.allclose(links.long, -eye.expand_as(u) / 24, atol=1e-12)


def test_fat_and_naik_links_gauge_covariant(hot4):
    g = _t(su3_gauge(HYPERCUBE, seed=159, dtype=np.complex128)[0])
    for c in (hisq.FAT7_COEFFS, hisq.HISQ_L2_COEFFS):
        got = hisq.fat_links(_gauge_transform(hot4, g), c)
        want = _gauge_transform(hisq.fat_links(hot4, c), g)
        assert torch.allclose(got, want, atol=1e-11)
    n0 = hisq.naik_links(hot4)
    n1 = hisq.naik_links(_gauge_transform(hot4, g))
    for mu in range(4):
        want = mat_mul(mat_mul(g, n0[mu]), dagger(shift(g, mu, +1, 3)))
        assert torch.allclose(n1[mu], want, atol=1e-11)


def test_unitarize_and_ks_links(hot4):
    v = hisq.fat_links(hot4, hisq.FAT7_COEFFS)
    w = hisq.unitarize_links(v)
    assert hisq.unitarity_violation(w) < 1e-10
    qt.init_quda("cpu")
    try:
        qt.load_gauge_quda(hot4, qt.GaugeParam(X=HYPERCUBE,
                                               cuda_prec="double"))
        links = qt.compute_ks_link_quda()
        assert torch.equal(links.w_unitarized, w)
        assert torch.allclose(links.long, -hisq.naik_links(w) / 24,
                              atol=1e-14)
        qt.load_fat_long_quda(links.fat.numpy(), links.long.numpy())
        assert torch.equal(qt.interfaces.quda_api._ctx["fat"], links.fat)
    finally:
        qt.end_quda()


@pytest.mark.slow
def test_hisq_fattening_matches_jax(hot4):
    """The whole construction against the JAX package's at 4^4,
    complex128, within 1e-12 (JAX compiles its checkpointed fattening:
    slow)."""
    want = jhisq.hisq_fattening(jnp.asarray(hot4.numpy()))
    got = hisq.hisq_fattening(hot4)
    for a, b in zip(got, want):
        assert rel_err(a.numpy(), np.asarray(b)) < 1e-12
    f, lg = fat_long_from_host(np.asarray(want.fat), np.asarray(want.long),
                               "cpu")
    assert rel_err(f.numpy(), np.asarray(want.fat)) == 0.0
    assert lg.dtype == torch.complex128


# -- multi-shift CG ------------------------------------------------------

def _spd(seed, dtype, dim=96):
    """An SPD matrix with eigenvalues in about [0.5, 4.5] and a (4,
    dim/4) right-hand side: CG meets tol 1e-10 well before ``dim``
    iterations, where both packages' iterates still agree to rounding
    (past ``dim`` the residual history is rounding-dominated)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((dim, dim))
    a = (q @ q.T / dim + 0.5 * np.eye(dim)).astype(dtype)
    b = rng.standard_normal((4, dim // 4)).astype(dtype)
    return a, b


@pytest.mark.parametrize("dtype, tol", [(np.float32, 1e-5),
                                        (np.float64, 1e-12)],
                         ids=["f32", "f64"])
def test_multishift_cg_matches_jax(dtype, tol):
    a, b = _spd(160, dtype)
    at, aj = _t(a), jnp.asarray(a)
    solve_tol = 1e-5 if dtype == np.float32 else 1e-10
    got = multishift_cg(lambda v: (at @ v.reshape(-1)).reshape(v.shape),
                        _t(b), SHIFTS, tol=solve_tol, maxiter=500)
    want = jax.jit(lambda rhs: jms.multishift_cg(
        lambda v: (aj @ v.reshape(-1)).reshape(v.shape), rhs, SHIFTS,
        tol=solve_tol, maxiter=500))(jnp.asarray(b))
    assert got.iters == int(want.iters)
    assert got.converged == [bool(c) for c in np.asarray(want.converged)]
    for i in range(len(SHIFTS)):
        assert rel_err(got.x[i].numpy(), np.asarray(want.x[i])) < tol


def test_multishift_cg_solves_each_shift():
    """Every shift solved to tol, the shifts in descending order and a
    check every 4 iterations: the port moves the smallest shift to the
    base, whatever the caller's order (ROADMAP C records that JAX's loop
    needs the smallest shift first)."""
    a, b = _spd(161, np.float64)
    at = _t(a)
    res = multishift_cg(lambda v: at @ v, _t(b.reshape(-1)), SHIFTS[::-1],
                        tol=1e-10, maxiter=500, check_every=4)
    assert all(res.converged) and res.iters % 4 == 0
    for i, s in enumerate(SHIFTS[::-1]):
        r = _t(b.reshape(-1)) - (at @ res.x[i] + s * res.x[i])
        assert float(r.norm() / np.linalg.norm(b)) < 1e-9


# -- the API --------------------------------------------------------------

def _session(gauge, dims=HYPERCUBE, reconstruct=18, device="cpu"):
    qt.init_quda(device)
    qt.load_gauge_quda(gauge, qt.GaugeParam(X=dims, cuda_prec="single",
                                            reconstruct=reconstruct))


def _param(**kw):
    base = dict(dslash_type="hisq", inv_type="cg", solve_type="direct-pc",
                mass=MASS, tol=TOL, maxiter=1000, cuda_prec="single")
    base.update(kw)
    return qt.InvertParam(**base)


@pytest.fixture(scope="module")
def api_inputs():
    g = su3_gauge(HYPERCUBE, seed=162)
    b = gaussian(lattice_shape(HYPERCUBE) + (1, 3), seed=163)
    return g, b


def _true_res(dt, b, x, links):
    geom = LatticeGeometry(HYPERCUBE)
    if dt == "staggered":
        fat, lng = links, None
    else:
        fat, lng = links
    d = mstag.DiracStaggered(fat.to(torch.complex128), geom, MASS,
                             dt != "staggered",
                             None if lng is None else lng.to(
                                 torch.complex128))
    bb = _t(b).to(torch.complex128)
    return float((bb - d.M(x.to(torch.complex128))).norm() / bb.norm())


def test_invert_quda_staggered_routes(api_inputs):
    """hisq (single, half, direct-pc and normop-pc), asqtad on the same
    links and fat-only staggered (single, half): converged, true_res <=
    1e-5 (the port's own check and an independent complex128 one);
    hisq and asqtad take the same iterations; no normal equations (the
    iterations of one M apply per step, gflops charged once)."""
    g, b = api_inputs
    _session(g)
    try:
        links = qt.compute_ks_link_quda()
        its = {}
        for dt, sloppy, st in (("hisq", "single", "direct-pc"),
                               ("hisq", "single", "normop-pc"),
                               ("hisq", "half", "direct-pc"),
                               ("staggered", "single", "direct-pc"),
                               ("staggered", "half", "direct-pc")):
            p = _param(dslash_type=dt, cuda_prec_sloppy=sloppy,
                       solve_type=st)
            x = qt.invert_quda(b, p)
            assert x.shape == lattice_shape(HYPERCUBE) + (1, 3)
            assert p.converged and p.true_res <= 10 * TOL
            ref = (links.fat, links.long) if dt == "hisq" else _t(g)
            assert _true_res(dt, b, x, ref) <= 10 * TOL
            assert (p.reliable_updates >= 1) == (sloppy == "half")
            its[(dt, sloppy, st)] = p.iter_count
            flops = 2 * (1146 if dt == "hisq" else 570) + 24
            assert p.gflops == pytest.approx(
                p.iter_count * flops * 128 / 1e9)
        assert its[("hisq", "single", "direct-pc")] == \
            its[("hisq", "single", "normop-pc")]
        qt.load_fat_long_quda(links.fat.numpy(), links.long.numpy())
        p = _param(dslash_type="asqtad")
        qt.invert_quda(b, p)
        assert p.iter_count == its[("hisq", "single", "direct-pc")]
    finally:
        qt.end_quda()


def test_invert_multishift_quda(api_inputs):
    """8 shifts at 4^4: every shift converged, and each x_i solves
    (M_pc + sigma_i) x_i = rhs with the complex PC operator (complex128)
    to 1e-5; the base residual is what ``true_res`` says."""
    g, b = api_inputs
    _session(g)
    try:
        links = qt.compute_ks_link_quda()
        p = _param(inv_type="multi-shift-cg", num_offset=len(SHIFTS),
                   offset=SHIFTS)
        xs = qt.invert_multishift_quda(b, p)
    finally:
        qt.end_quda()
    assert xs.shape == (len(SHIFTS),) + LatticeGeometry(
        HYPERCUBE).half_lattice_shape + (1, 3)
    assert p.converged and p.converged_multi == [True] * len(SHIFTS)
    assert p.true_res <= 10 * TOL
    geom = LatticeGeometry(HYPERCUBE)
    dpc = mstag.DiracStaggeredPC(links.fat.to(torch.complex128), geom,
                                 MASS, True,
                                 links.long.to(torch.complex128))
    be, bo = even_odd_split(_t(b).to(torch.complex128), geom)
    rhs = dpc.prepare(be, bo)
    for i, s in enumerate(SHIFTS):
        x = xs[i].to(torch.complex128)
        r = rhs - (dpc.M(x) + s * x)
        assert float(r.norm() / rhs.norm()) <= 10 * TOL, (i, s)


@pytest.mark.parametrize("case", ["reconstruct-12", "reconstruct-8",
                                  "multi-src", "wilson-multishift",
                                  "no-links", "bicgstab"])
def test_unported_staggered_routes_raise(api_inputs, case):
    g, b = api_inputs
    # staggered multi-source solves are served (test_torch_staggered_mrhs
    # .py); with recon-12 links they still raise (ROADMAP C)
    _session(g, reconstruct={"reconstruct-12": 12, "reconstruct-8": 8,
                             "multi-src": 12}.get(case, 18))
    try:
        if case.startswith("reconstruct"):
            with pytest.raises(NotImplementedError, match="ROADMAP C"):
                qt.invert_quda(b, _param(dslash_type="staggered"))
        elif case == "multi-src":
            with pytest.raises(NotImplementedError, match="ROADMAP C"):
                qt.invert_multi_src_quda(b[None], _param())
        elif case == "wilson-multishift":
            with pytest.raises(NotImplementedError, match="ROADMAP A18"):
                qt.invert_multishift_quda(
                    b, _param(dslash_type="wilson", num_offset=1,
                              offset=(0.1,)))
        elif case == "no-links":
            with pytest.raises(RuntimeError, match="compute_ks_link_quda"):
                qt.invert_quda(b, _param(dslash_type="asqtad"))
        else:
            with pytest.raises(NotImplementedError, match="ROADMAP A11"):
                qt.invert_quda(b, _param(inv_type="bicgstab"))
    finally:
        qt.end_quda()


# -- slow: the JAX Pallas kernels in interpret mode, whole JAX solves ------

@pytest.mark.slow
@pytest.mark.parametrize("parity", [0, 1])
def test_plain_kernels_match_jax_pallas_interpret(parity):
    """The plain S1 against ``dslash_staggered_eo_pallas_fused`` and the
    plain S2 passes against ``dslash_staggered_eo_pallas`` (fat only and
    fat + Naik), JAX in interpret mode, f32 within 1e-6."""
    dims = (8, 8, 8, 8)
    fat, lng, psi = _pair_fields(dims, seed=164 + parity)
    d = lattice_shape(dims)
    q = 1 - parity
    f, lg, ps = tuple(map(_t, fat)), tuple(map(_t, lng)), _t(psi)
    jf, jl, jp = (tuple(map(jnp.asarray, fat)), tuple(map(jnp.asarray, lng)),
                  jnp.asarray(psi))
    want = np.asarray(jspl.dslash_staggered_eo_pallas_fused(
        jf[parity], jf[q], jp, d, parity, long_here_pl=jl[parity],
        long_there_pl=jl[q], interpret=True, out_dtype=jnp.float32))
    got = spl.dslash_staggered_eo_fused_plain(f[parity], f[q], ps, d, parity,
                                              lg[parity], lg[q])
    assert rel_err(got.numpy(), want) < 1e-6
    fbw = spl.backward_links_eo(f[q], d, parity, 1)
    lbw = spl.backward_links_eo(lg[q], d, parity, 3)
    for improved in (False, True):
        want = np.asarray(jspl.dslash_staggered_eo_pallas(
            jf[parity], jnp.asarray(fbw.numpy()), jp, d, parity,
            long_here_pl=jl[parity] if improved else None,
            long_bw_pl=jnp.asarray(lbw.numpy()) if improved else None,
            interpret=True, out_dtype=jnp.float32))
        got = spl.dslash_staggered_eo_pallas(
            f[parity], fbw, ps, d, parity,
            lg[parity] if improved else None, lbw if improved else None)
        assert rel_err(got.numpy(), want) < 1e-6


@pytest.mark.slow
def test_staggered_solves_match_jax(api_inputs, monkeypatch):
    """invert_quda(hisq) and invert_multishift_quda against quda_tpu's
    complex-free pair routes (QUDA_TPU_PACKED=1; without it a CPU host
    takes JAX's canonical complex route) on the same 4^4 gauge, source
    and HISQ links: iterations within 2, solutions within 1e-4."""
    monkeypatch.setenv("QUDA_TPU_PACKED", "1")
    from quda_tpu.utils import config as jconf
    jconf.reset_cache()
    g, b = api_inputs
    japi.init_quda()
    japi.load_gauge_quda(g, JGaugeParam(X=HYPERCUBE, cuda_prec="single"))
    jlinks = japi.compute_ks_link_quda()
    jp = JInvertParam(dslash_type="hisq", inv_type="cg",
                      solve_type="direct-pc", mass=MASS, tol=TOL,
                      maxiter=1000, cuda_prec="single",
                      cuda_prec_sloppy="single")
    xj = np.asarray(japi.invert_quda(b, jp))
    jm = JInvertParam(dslash_type="hisq", inv_type="multi-shift-cg",
                      solve_type="direct-pc", mass=MASS, tol=TOL,
                      maxiter=1000, cuda_prec="single",
                      num_offset=len(SHIFTS), offset=SHIFTS)
    xmj = np.asarray(japi.invert_multishift_quda(b, jm))
    japi.end_quda()
    jconf.reset_cache()

    _session(g)
    try:
        qt.load_fat_long_quda(np.asarray(jlinks.fat), np.asarray(jlinks.long))
        p = _param(cuda_prec_sloppy="single")
        x = qt.invert_quda(b, p).numpy()
        pm = _param(inv_type="multi-shift-cg", num_offset=len(SHIFTS),
                    offset=SHIFTS)
        xm = qt.invert_multishift_quda(b, pm).numpy()
    finally:
        qt.end_quda()
    assert abs(p.iter_count - jp.iter_count) <= 2
    assert rel_err(x, xj) < 1e-4
    assert abs(pm.iter_count - jm.iter_count) <= 2
    assert xm.shape == xmj.shape
    assert rel_err(xm, xmj) < 1e-4
