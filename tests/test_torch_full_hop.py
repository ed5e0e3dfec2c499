"""Port parity: the full-lattice Wilson hop (B4's plain version and the
pair stencils around it), the pair link algebra, the Wilson operator
additions (diag/hop, from_eo, the packed operator's complex forms, the
full-lattice pair operator) and the operator API (dslash_quda, mat_quda,
mat_dag_mat_quda).

Numpy seeds 201-229.  Tolerances: float64 against the numpy site-loop
oracle tests/host_reference/wilson_ref.py and the JAX package within
1e-12 relative; float32 within 1e-6 (the same terms summed in another
order); layout conversions and backward links exact.  Lattices are
non-cubic (4x6x8x10), so a swapped axis shows.  JAX's Pallas kernel in
interpret mode is ``slow``; the CUDA kernel meets its plain version on
the card in test_torch_cuda.py.
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
from quda_tpu.models import wilson as jmw
from quda_tpu.ops import pair as jpair
from quda_tpu.ops import wilson_packed as jwpk
from quda_tpu.ops import wilson_pallas_packed as jwpp
from quda_tpu_torch.fields.geometry import LatticeGeometry
from quda_tpu_torch.fields.spinor import even_odd_join, even_odd_split
from quda_tpu_torch.models import wilson as mw
from quda_tpu_torch.ops import boundary as bnd
from quda_tpu_torch.ops import pair
from quda_tpu_torch.ops import wilson_packed as wpk
from quda_tpu_torch.ops import wilson_pallas_packed as wpp

from tests.host_reference.wilson_ref import (wilson_dslash_ref,
                                             wilson_mat_ref)
from tests.torch_inputs import (ASYM, gaussian, lattice_shape, rel_err,
                                su3_gauge)
from tests.torch_inputs import one_torch_thread  # noqa: F401 (autouse)

KAPPA = 0.12
C128, C64 = torch.complex128, torch.complex64


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def fields():
    """SU(3) links (complex128, boundary phase not folded) and a spinor
    on 4x6x8x10, with the folded packed pair links in float64."""
    g = su3_gauge(ASYM, 201, dtype=np.complex128)
    psi = gaussian(lattice_shape(ASYM) + (4, 3), 202, dtype=np.complex128)
    geom = LatticeGeometry(ASYM)
    folded = bnd.apply_t_boundary(_t(g), geom, -1)
    gp = wpk.to_packed_pairs(wpk.pack_gauge(folded), torch.float64)
    pp = wpk.to_packed_pairs(wpk.pack_spinor(_t(psi)), torch.float64)
    return g, psi, geom, gp.contiguous(), pp.contiguous()


def _unpack(pp, geom, dtype=C128):
    return wpk.unpack_spinor(wpk.from_packed_pairs(pp, dtype),
                             geom.lattice_shape)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_full_hop_plain_matches_pair_stencil_and_oracle(fields, dtype):
    """B4's plain version (pre-shifted backward links) equals the pair
    stencil ``dslash_packed_pairs`` bit for bit, and both the site-loop
    oracle: 1e-12 in float64, 1e-6 in float32; the output keeps psi's
    dtype."""
    g, psi, geom, gp, pp = fields
    T, Z, Y, X = geom.lattice_shape
    u, p = gp.to(dtype), pp.to(dtype)
    bw = wpp.backward_gauge(u, X)
    got = wpp.dslash_pallas_packed(u, p, X, gauge_bw=bw)
    assert got.dtype == dtype and got.shape == p.shape
    assert torch.equal(got, wpk.dslash_packed_pairs(u, p, X, Y))
    assert torch.equal(got, wpp.dslash_pallas_packed(u, p, X))
    want = wilson_dslash_ref(g, psi)
    tol = 1e-12 if dtype == torch.float64 else 1e-6
    assert rel_err(_unpack(got, geom).numpy(), want) < tol


def test_full_hop_recon12_and_t_boundary(fields):
    """R = 2 links: row 2 rebuilt, negated on the boundary t links by
    tb_sign (forward on t = T-1, backward on t = 0), equals the R = 3 hop
    within f32 rounding; without tb_sign it differs exactly on the
    t-boundary planes."""
    g, psi, geom, gp, pp = fields
    X = geom.lattice_shape[3]
    u, p = gp.float(), pp.float()
    full = wpp.dslash_pallas_packed(u, p, X)
    r12 = wpp.to_recon12(u)
    assert r12.shape[1] == 2
    got = wpp.dslash_pallas_packed(r12, p, X)
    assert rel_err(got.numpy(), full.numpy()) < 1e-6
    wrong = wpp.dslash_pallas_packed(r12, p, X, tb_sign=False)
    diff = (wrong - full).abs().amax(dim=(0, 1, 2, 4, 5))     # per t plane
    assert float(diff[0]) > 1e-3 and float(diff[-1]) > 1e-3
    assert float(diff[1:-1].max()) < 1e-5


def test_layout_and_backward_gauge_match_jax(fields):
    """to/from_pallas_layout and the full-lattice backward links against
    the JAX package's, exactly; the x wrap stays inside its row."""
    g, psi, geom, gp, pp = fields
    X = geom.lattice_shape[3]
    arr = wpk.pack_spinor(_t(psi))
    got = wpp.to_pallas_layout(arr)
    want = jwpp.to_pallas_layout(jnp.asarray(arr.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.float32
    back = wpp.from_pallas_layout(wpk.to_packed_pairs(arr, torch.float64),
                                  C128)
    np.testing.assert_array_equal(back.numpy(), arr.numpy())
    u = gp.float()
    np.testing.assert_array_equal(
        wpp.backward_gauge(u, X).numpy(),
        np.asarray(jwpp.backward_gauge(jnp.asarray(u.numpy()), X)))


def test_pair_stencil_matches_jax(fields):
    """The port's ``dslash_packed_pairs`` against JAX's (XLA) in float32,
    1e-6."""
    g, psi, geom, gp, pp = fields
    T, Z, Y, X = geom.lattice_shape
    got = wpk.dslash_packed_pairs(gp.float(), pp.float(), X, Y)
    want = jwpk.dslash_packed_pairs(jnp.asarray(gp.float().numpy()),
                                    jnp.asarray(pp.float().numpy()), X, Y)
    assert rel_err(got.numpy(), np.asarray(want)) < 1e-6


def test_pair_link_algebra_matches_jax(fields):
    """dagger_pairs, color_mul_pairs and dslash_full_pairs (canonical pair
    layout) against the JAX package's and the oracle, float64, 1e-12
    (1e-6 against JAX's f32-accumulating hop)."""
    g, psi, geom, gp, pp = fields
    folded = bnd.apply_t_boundary(_t(g), geom, -1)
    u = torch.view_as_real(folded).contiguous()
    p = torch.view_as_real(_t(psi)).contiguous()
    ju, jp = jnp.asarray(u.numpy()), jnp.asarray(p.numpy())
    np.testing.assert_array_equal(pair.dagger_pairs(u).numpy(),
                                  np.asarray(jpair.dagger_pairs(ju)))
    got = pair.color_mul_pairs(u[0], p, torch.float64)
    want = jpair.color_mul_pairs(ju[0], jp, jnp.float64)
    assert rel_err(got.numpy(), np.asarray(want)) < 1e-12
    out = pair.dslash_full_pairs(u, p)
    assert out.dtype == torch.float64
    got_c = torch.view_as_complex(out.contiguous()).numpy()
    assert rel_err(got_c, wilson_dslash_ref(g, psi)) < 1e-12
    # JAX's spin_mul_pairs accumulates in float32 whatever its input, so
    # its hop is an f32 result
    want = np.asarray(jpair.dslash_full_pairs(ju, jp))
    assert rel_err(out.numpy(), want) < 1e-6
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        pair.decode_gauge((u, u))


def test_wilson_diag_and_hops_sum_to_m(fields):
    """M = diag + sum over the 8 single-direction hops (float64), each
    hop equal to JAX's ``DiracWilson.hop`` within 1e-12."""
    g, psi, geom, gp, pp = fields
    dw = mw.DiracWilson(_t(g), geom, KAPPA)
    x = _t(psi)
    total = dw.diag(x)
    jdw = jmw.DiracWilson(jnp.asarray(g), JGeom(ASYM), KAPPA)
    for mu in range(4):
        for sign in (+1, -1):
            h = dw.hop(x, mu, sign)
            if mu == 3 and sign < 0 or mu == 0 and sign > 0:
                want = np.asarray(jdw.hop(jnp.asarray(psi), mu, sign))
                assert rel_err(h.numpy(), want) < 1e-12
            total = total + h
    assert rel_err(total.numpy(), dw.M(x).numpy()) < 1e-12


def test_from_eo_and_packed_complex_forms(fields):
    """DiracWilsonPC.from_eo equals the constructed operator; the packed
    operator's D_to/M/Mdag/MdagM on complex packed fields (through B1's
    plain version) equal the complex PC operator: complex128 1e-12,
    complex64 1e-6."""
    g, psi, geom, gp, pp = fields
    dpc = mw.DiracWilsonPC(_t(g), geom, KAPPA)
    twin = mw.DiracWilsonPC.from_eo(dpc.gauge_eo, geom, KAPPA)
    be, bo = even_odd_split(_t(psi), geom)
    assert torch.equal(twin.M(be), dpc.M(be))
    dpk = dpc.packed()
    T, Z, Y, X = geom.lattice_shape
    half = (T, Z, Y, X // 2)
    for dt, tol in ((C128, 1e-12), (C64, 1e-6)):
        x = be.to(dt)
        xp = wpk.pack_spinor(x)
        for name in ("M", "Mdag", "MdagM"):
            got = wpk.unpack_spinor(getattr(dpk, name)(xp), half)
            want = getattr(dpc, name)(be)
            assert got.dtype == dt
            assert rel_err(got.numpy(), want.numpy()) < tol, (name, dt)
        got = wpk.unpack_spinor(dpk.D_to(wpk.pack_spinor(bo.to(dt)), 0), half)
        assert rel_err(got.numpy(), dpc.D_to(bo, 0).numpy()) < tol


@pytest.mark.parametrize("store,form", [(torch.float64, "full"),
                                        (torch.float32, "full"),
                                        (torch.float32, "r12")])
def test_full_lattice_pair_operator(fields, store, form):
    """DiracWilson.pairs: D, M, Mdag and MdagM on canonical fields against
    the complex operator and the oracle (1e-12 in float64, 1e-6 in
    float32); recon-12 under float64 raises (ROADMAP A7)."""
    g, psi, geom, gp, pp = fields
    dw = mw.DiracWilson(_t(g), geom, KAPPA)
    op = dw.pairs(store, form)
    x = _t(psi)
    tol = 1e-12 if store == torch.float64 else 1e-6
    assert rel_err(op.M(x).numpy(), wilson_mat_ref(g, psi, KAPPA)) < tol
    assert rel_err(op.D(x).numpy(), wilson_dslash_ref(g, psi)) < tol
    for name in ("Mdag", "MdagM"):
        assert rel_err(getattr(op, name)(x).numpy(),
                       getattr(dw, name)(x).numpy()) < tol
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        dw.pairs(torch.float64, "r12")
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        dw.pairs(torch.bfloat16)


# -- the operator API against the JAX package's -----------------------------

@pytest.fixture(scope="module")
def api_case():
    """JAX's dslash_quda, mat_quda and mat_dag_mat_quda (CPU, complex
    route) at double and single on one gauge and spinor."""
    dims = (4, 4, 4, 8)
    g = su3_gauge(dims, 203, dtype=np.complex128)
    psi = gaussian(lattice_shape(dims) + (4, 3), 204, dtype=np.complex128)
    geom = LatticeGeometry(dims)
    be, bo = (t.numpy() for t in even_odd_split(_t(psi), geom))
    want = {}
    for prec in ("double", "single"):
        japi.init_quda()
        try:
            cast = np.complex128 if prec == "double" else np.complex64
            japi.load_gauge_quda(g.astype(cast),
                                 JGaugeParam(X=dims, cuda_prec=prec))
            p = JInvertParam(dslash_type="wilson", kappa=KAPPA,
                             cuda_prec=prec)
            want[prec] = {
                "dslash": np.asarray(japi.dslash_quda(bo, p, 0)),
                "mat": np.asarray(japi.mat_quda(psi, p)),
                "mdm": np.asarray(japi.mat_dag_mat_quda(psi, p))}
        finally:
            japi.end_quda()
    return dims, g, psi, bo, want


@pytest.mark.parametrize("prec", ["double", "single"])
def test_operator_api_matches_jax(api_case, prec):
    """The port's dslash_quda (B1's plain version), mat_quda and
    mat_dag_mat_quda (B4's) against the JAX package's on the same numpy
    inputs: 1e-12 relative in complex128, 1e-6 in complex64, dtypes and
    shapes as JAX's."""
    dims, g, psi, bo, want = api_case
    cast = np.complex128 if prec == "double" else np.complex64
    qt.init_quda(device="cpu")
    try:
        qt.load_gauge_quda(g.astype(cast), qt.GaugeParam(X=dims,
                                                         cuda_prec=prec))
        p = qt.InvertParam(dslash_type="wilson", kappa=KAPPA, cuda_prec=prec)
        got = {"dslash": qt.dslash_quda(bo, p, 0),
               "mat": qt.mat_quda(psi, p),
               "mdm": qt.mat_dag_mat_quda(psi, p)}
    finally:
        qt.end_quda()
    tol = 1e-12 if prec == "double" else 1e-6
    for name, t in got.items():
        w = want[prec][name]
        assert t.dtype == (C128 if prec == "double" else C64)
        assert tuple(t.shape) == w.shape
        assert rel_err(t.numpy(), w) < tol, name


def test_operator_api_routes_and_refusals(api_case):
    """Recon-12 single runs B4's R = 2 form; clover and twisted mass are
    served on these recon-12 links (the full-lattice clover operator, B4
    with the twist) within 1e-6 of JAX's mat_quda; the staggered family on
    these links names ROADMAP C, laplace A14; recon-12 under double raises
    (ROADMAP A7); shapes are checked."""
    dims, g, psi, bo, want = api_case
    c64 = np.complex64
    served = {"clover": dict(csw=1.0), "twisted-mass": dict(mu=0.1)}
    japi.init_quda()
    try:
        japi.load_gauge_quda(g.astype(c64),
                             JGaugeParam(X=dims, cuda_prec="single"))
        jax_mat = {dt: np.asarray(japi.mat_quda(psi.astype(c64), JInvertParam(
            dslash_type=dt, kappa=KAPPA, cuda_prec="single", **kw)))
            for dt, kw in served.items()}
    finally:
        japi.end_quda()
    qt.init_quda(device="cpu")
    try:
        qt.load_gauge_quda(g.astype(np.complex64),
                           qt.GaugeParam(X=dims, cuda_prec="single",
                                         reconstruct=12))
        p = qt.InvertParam(dslash_type="wilson", kappa=KAPPA,
                           cuda_prec="single")
        assert rel_err(qt.mat_quda(psi, p).numpy(),
                       want["single"]["mat"]) < 1e-6
        assert rel_err(qt.dslash_quda(bo, p, 0).numpy(),
                       want["single"]["dslash"]) < 1e-6
        for dt, kw in served.items():
            got = qt.mat_quda(psi.astype(c64), qt.InvertParam(
                dslash_type=dt, kappa=KAPPA, cuda_prec="single", **kw))
            assert rel_err(got.numpy(), jax_mat[dt]) < 1e-6, dt
        for dt, item in (("hisq", "C"), ("laplace", "A14")):
            with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
                qt.mat_quda(psi, qt.InvertParam(dslash_type=dt, kappa=KAPPA,
                                                cuda_prec="single"))
        with pytest.raises(NotImplementedError, match="ROADMAP A7"):
            qt.mat_quda(psi, qt.InvertParam(dslash_type="wilson",
                                            kappa=KAPPA, cuda_prec="double"))
        with pytest.raises(ValueError, match="source shape"):
            qt.dslash_quda(psi, p, 0)
    finally:
        qt.end_quda()
    with pytest.raises(RuntimeError, match="init_quda"):
        qt.mat_quda(psi, p)


# -- slow: JAX's Pallas kernel in interpret mode ----------------------------

@pytest.mark.slow
@pytest.mark.parametrize("rows", [3, 2])
def test_full_hop_plain_matches_jax_pallas_interpret(fields, rows):
    """B4's plain version against JAX's ``dslash_pallas_packed`` in
    interpret mode, float32 (full and recon-12 links), 1e-6."""
    g, psi, geom, gp, pp = fields
    X = geom.lattice_shape[3]
    u, p = gp.float(), pp.float()
    if rows == 2:
        u = wpp.to_recon12(u)
    got = wpp.dslash_pallas_packed(u, p, X)
    want = jwpp.dslash_pallas_packed(jnp.asarray(u.numpy()),
                                     jnp.asarray(p.numpy()), X,
                                     interpret=True)
    assert rel_err(got.numpy(), np.asarray(want)) < 1e-6


def test_even_odd_join_roundtrip_of_dslash(fields):
    """The eo hop of dslash_quda's operator and B4 agree: D psi on the
    full lattice restricted to parity 0 is D_{0<-1} of psi's odd half
    (float64, 1e-12)."""
    g, psi, geom, gp, pp = fields
    X = geom.lattice_shape[3]
    be, bo = even_odd_split(_t(psi), geom)
    odd_only = even_odd_join(torch.zeros_like(be), bo, geom)
    pk = wpk.to_packed_pairs(wpk.pack_spinor(odd_only), torch.float64)
    full = _unpack(wpp.dslash_pallas_packed(gp, pk, X), geom)
    dpc = mw.DiracWilsonPC(_t(g), geom, KAPPA).packed().pairs(torch.float64)
    half = dpc._from_pairs(dpc._d_to(dpc._to_pairs(bo), 0, torch.float64),
                           C128)
    assert rel_err(even_odd_split(full, geom)[0].numpy(),
                   half.numpy()) < 1e-12
