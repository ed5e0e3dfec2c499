"""Port parity: mixed precision and the df64 route.

quda_tpu_torch against quda_tpu on the same numpy inputs, for the pair
ops and codecs, the axpy_norm2 kernel's plain version (B3), the df64
arithmetic and stencil, the recon-12 and bf16 forms of the eo hop (B1),
cg_reliable and the new invert_quda routes.  Tolerances are stated at
each check; "bit-exact" where both packages do the same f32/bf16
operations in the same order.  The CUDA kernels meet their plain
versions on the card in test_torch_cuda.py.  The comparisons that
compile a whole JAX solve (20 s to 5 min on one CPU core) are ``slow``.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quda_tpu_torch as qt
from quda_tpu.fields.geometry import LatticeGeometry as JGeom
from quda_tpu.interfaces import quda_api as japi
from quda_tpu.interfaces.params import GaugeParam as JGaugeParam
from quda_tpu.interfaces.params import InvertParam as JInvertParam
from quda_tpu.models.wilson import DiracWilsonPC as JDiracWilsonPC
from quda_tpu.ops import blas_pallas as jbpl
from quda_tpu.ops import df64 as jdf
from quda_tpu.ops import pair as jpair
from quda_tpu.ops import wilson_df64 as jwdf
from quda_tpu.ops import wilson_pallas_packed as jwpp
from quda_tpu.solvers import mixed as jmixed
from quda_tpu_torch.fields.geometry import LatticeGeometry
from quda_tpu_torch.interfaces import quda_api as tapi
from quda_tpu_torch.interfaces.params import QudaError
from quda_tpu_torch.models import wilson as mwil
from quda_tpu_torch.models.wilson import DiracWilson, DiracWilsonPC
from quda_tpu_torch.ops import blas
from quda_tpu_torch.ops import blas_pallas as bpl
from quda_tpu_torch.ops import df64 as tdf
from quda_tpu_torch.ops import pair as tpair
from quda_tpu_torch.ops import wilson as twil
from quda_tpu_torch.ops import wilson_df64 as twdf
from quda_tpu_torch.ops import wilson_packed as twpk
from quda_tpu_torch.ops import wilson_pallas_packed as twpp
from quda_tpu_torch.solvers import mixed as tmixed

from tests.torch_inputs import (ASYM, SMALL, gaussian, lattice_shape,
                                noisy_gauge, pair_spinor_shape, rel_err,
                                su3_gauge)
from tests.torch_inputs import one_torch_thread  # noqa: F401 (autouse)

KAPPA = 0.12
TOL = 1e-6
HYPERCUBE = (4, 4, 4, 4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bf16_np(t: torch.Tensor) -> np.ndarray:
    """A bf16 tensor's values as float32 numpy (numpy has no bf16)."""
    return t.to(torch.float32).numpy()


# -- pair ops and codecs ------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pair_ops_match_jax(dtype):
    """Pair norm and redot on the JAX package's pair arrays (to_pairs):
    within 1e-6 (f32 sums in another order)."""
    x = gaussian((3, 5, 4), seed=51)
    y = gaussian((3, 5, 4), seed=52)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    jp = jpair.to_pairs(jnp.asarray(x), jdt)
    jq = jpair.to_pairs(jnp.asarray(y), jdt)
    tp = _t(np.array(jp, np.float32)).to(tdt)
    tq = _t(np.array(jq, np.float32)).to(tdt)
    assert float(tpair.pair_norm2(tp)) == pytest.approx(
        float(jpair.pair_norm2(jp)), rel=1e-6)
    assert float(tpair.pair_redot(tp, tq)) == pytest.approx(
        float(jpair.pair_redot(jp, jq)), rel=1e-6)


def test_codecs_match_jax():
    """The in-place and packed pair codecs: down/up and axpy bit-exact
    against the JAX package's (both compute y + a x in f32 with separate
    roundings, then round once to bf16)."""
    a = np.float32(-0.37)
    x = gaussian(pair_spinor_shape(SMALL), seed=53, dtype=np.float32)
    y = gaussian(pair_spinor_shape(SMALL), seed=54, dtype=np.float32)
    tc = tmixed.pair_inplace_codec(torch.bfloat16)
    jc = jmixed.pair_inplace_codec(jnp.bfloat16, use_pallas_tail=False)
    tx, ty = tc.down(_t(x)), tc.down(_t(y))
    jx, jy = jc.down(jnp.asarray(x)), jc.down(jnp.asarray(y))
    np.testing.assert_array_equal(_bf16_np(tx), np.asarray(jx, np.float32))
    got = tc.axpy(torch.tensor(a), tx, ty)
    want = jc.axpy(jnp.float32(a), jx, jy)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bf16_np(got), np.asarray(want, np.float32))
    np.testing.assert_array_equal(tc.up(got).numpy(),
                                  np.asarray(jc.up(want)))
    # the packed codec: complex packed (4,3,T,Z,YX) <-> pairs
    T, Z, Y, X = lattice_shape(SMALL)
    c = gaussian((4, 3, T, Z, Y * X // 2), seed=55)
    tpc = tmixed.packed_pair_codec(torch.bfloat16, torch.complex64)
    jpc = jmixed.packed_pair_codec(jnp.bfloat16, jnp.complex64)
    down = tpc.down(_t(c))
    np.testing.assert_array_equal(_bf16_np(down),
                                  np.asarray(jpc.down(jnp.asarray(c)),
                                             np.float32))
    np.testing.assert_array_equal(
        tpc.up(down).numpy(),
        np.asarray(jpc.up(jpc.down(jnp.asarray(c)))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_axpy_norm2_matches_jax_pallas_kernel(dtype):
    """B3's plain version (what the wrapper runs on CPU tensors) against
    the JAX package's Pallas kernel in interpret mode.  XLA contracts the
    kernel's y + a x into a fused multiply-add (one rounding fewer), so y'
    agrees to 1e-6 of max |y'| in f32, and to one bf16 ulp (2^-7 of
    max |y'|) where that flips a bf16 rounding; the norm of the rounded y'
    within 1e-6 (block sums in another order)."""
    a = np.float32(-0.41)
    x = gaussian(pair_spinor_shape(SMALL), seed=56, dtype=np.float32)
    y = gaussian(pair_spinor_shape(SMALL), seed=57, dtype=np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    jy, jn2 = jbpl.axpy_norm2_pallas(jnp.float32(a),
                                     jnp.asarray(x).astype(jdt),
                                     jnp.asarray(y).astype(jdt),
                                     interpret=True)
    n0 = bpl.axpy_norm2_pallas.launches
    ty, tn2 = bpl.axpy_norm2_pallas(torch.tensor(a), _t(x).to(tdt),
                                    _t(y).to(tdt))
    assert bpl.axpy_norm2_pallas.launches == n0      # CPU: no launch
    assert ty.dtype == tdt and ty.shape == y.shape
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7
    assert rel_err(ty.to(torch.float32).numpy(),
                   np.asarray(jy, np.float32)) <= tol
    assert float(tn2) == pytest.approx(float(jn2), rel=1e-6)
    yf = ty.to(torch.float64)
    assert float(tn2) == pytest.approx(float(torch.sum(yf * yf)), rel=1e-6)


# -- df64 ----------------------------------------------------------------------

def _df_inputs(n=129):
    rng = np.random.default_rng(58)
    a = (rng.standard_normal(n) * np.exp(rng.uniform(-20, 20, n))
         ).astype(np.float32)
    b = (rng.standard_normal(n) * np.exp(rng.uniform(-20, 20, n))
         ).astype(np.float32)
    return a, b


def test_df64_transforms_bit_exact():
    """two_sum, two_prod, df64 add/mul/mul_f32 and the halving tree sum:
    bit-exact against the JAX package (the same f32 operations in the
    same order); the error words really are exact (f64 check)."""
    a, b = _df_inputs()
    ta, tb = _t(a), _t(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for tfn, jfn in ((tdf.two_sum, jdf.two_sum), (tdf.two_prod, jdf.two_prod)):
        for tw, jw in zip(tfn(ta, tb), jfn(ja, jb)):
            np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    s, e = tdf.two_sum(ta, tb)
    np.testing.assert_array_equal(
        s.double().numpy() + e.double().numpy(),
        a.astype(np.float64) + b.astype(np.float64))
    p, e = tdf.two_prod(ta, tb)
    np.testing.assert_array_equal(
        p.double().numpy() + e.double().numpy(),
        a.astype(np.float64) * b.astype(np.float64))
    x = (ta, tdf.two_prod(ta, tb)[1] * 1e-3)
    y = (tb, tdf.two_sum(ta, tb)[1])
    jx = tuple(jnp.asarray(w.numpy()) for w in x)
    jy = tuple(jnp.asarray(w.numpy()) for w in y)
    for tfn, jfn in ((tdf.add, jdf.add), (tdf.mul, jdf.mul),
                     (tdf.sub, jdf.sub)):
        for tw, jw in zip(tfn(x, y), jfn(jx, jy)):
            np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    for tw, jw in zip(tdf.mul_f32(x, tb), jdf.mul_f32(jx, jb)):
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    # five terms: the odd-length halving in three levels
    for tw, jw in zip(tdf.tree_sum(tuple(w[:5] for w in x)),
                      jdf.tree_sum(tuple(w[:5] for w in jx))):
        assert float(tw) == float(jw)


def test_df64_reductions_are_compensated():
    """norm2/dot (df64 and f32 inputs) and the blas compensated sums
    (float64 accumulation) against float64 numpy: 1e-13 relative, where a
    plain f32 sum would be off by ~1e-7."""
    a, b = _df_inputs()
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    assert float(tdf.to_f64(tdf.norm2_f32(_t(a)))) == pytest.approx(
        float(np.sum(a64 * a64)), rel=1e-13)
    assert float(tdf.to_f64(tdf.dot_f32(_t(a), _t(b)))) == pytest.approx(
        float(np.sum(a64 * b64)), rel=1e-13)
    x = tdf.from_f64(torch.from_numpy(a64 * (1 + 1e-9)))
    want = np.sum((a64 * (1 + 1e-9)) ** 2)
    assert float(tdf.to_f64(tdf.norm2(x))) == pytest.approx(want, rel=1e-13)
    jd = jdf.norm2(tuple(jnp.asarray(w.numpy()) for w in x))
    assert float(tdf.to_f64(tdf.norm2(x))) == float(jdf.to_f64(jd))
    z = gaussian((7, 13), seed=59)
    w = gaussian((7, 13), seed=60)
    z128, w128 = z.astype(np.complex128), w.astype(np.complex128)
    assert float(blas.norm2_comp(_t(z))) == pytest.approx(
        float(np.sum(np.abs(z128) ** 2)), rel=1e-13)
    cd = complex(blas.cdot_comp(_t(z), _t(w)))
    assert abs(cd - np.vdot(z128, w128)) <= 1e-13 * abs(np.vdot(z128, w128))
    assert float(blas.norm2_comp(_t(z128))) == pytest.approx(
        float(np.sum(np.abs(z128) ** 2)), rel=1e-14)


def _df_hop_inputs():
    g = noisy_gauge(HYPERCUBE, seed=61)
    geom = LatticeGeometry(HYPERCUBE)
    tpk = DiracWilsonPC(_t(g), geom, KAPPA).packed()
    teo = tuple(twpk.to_packed_pairs(x, torch.float32)
                for x in tpk.gauge_eo_p)
    hi = gaussian(pair_spinor_shape(HYPERCUBE), seed=62, dtype=np.float32)
    lo = (1e-8 * gaussian(pair_spinor_shape(HYPERCUBE), seed=63,
                          dtype=np.float32)).astype(np.float32)
    return tpk, teo, hi, lo


@pytest.mark.slow
def test_dslash_eo_df_matches_jax():
    """The df64 stencil against the JAX package's, same f32 pair links
    and df64 spinor: bit-exact in both words."""
    _, teo, hi, lo = _df_hop_inputs()
    dims = lattice_shape(HYPERCUBE)
    parity = 1
    got = twdf.dslash_eo_df(teo, (_t(hi), _t(lo)), dims, parity)
    want = jwdf.dslash_eo_df(tuple(jnp.asarray(x.numpy()) for x in teo),
                             (jnp.asarray(hi), jnp.asarray(lo)), dims,
                             parity)
    for gw, ww in zip(got, want):
        np.testing.assert_array_equal(gw.numpy(), np.asarray(ww))


@pytest.mark.parametrize("parity", [0, 1])
def test_dslash_eo_df_matches_complex128(parity):
    """The df64 stencil against a complex128 oracle (the canonical
    stencil on the same f32 links) within 1e-13, both parities; a plain
    f32 hop would be off by ~1e-7."""
    tpk, teo, hi, lo = _df_hop_inputs()
    geom = LatticeGeometry(HYPERCUBE)
    dims = lattice_shape(HYPERCUBE)
    got = twdf.dslash_eo_df(teo, (_t(hi), _t(lo)), dims, parity)
    psi = (hi.astype(np.float64) + lo.astype(np.float64))
    psi_c = psi[:, :, 0] + 1j * psi[:, :, 1]           # packed complex
    T, Z, Y, X = dims
    psi_can = twpk.unpack_spinor(torch.from_numpy(psi_c), (T, Z, Y, X // 2))
    ref = twil.dslash_eo(tuple(u.to(torch.complex128)
                               for u in tpk._dpc.gauge_eo),
                         psi_can, geom, parity)
    ref_pp = twpk.to_packed_pairs(twpk.pack_spinor(ref), torch.float64)
    val = tdf.to_f64(got).numpy()
    assert rel_err(val, ref_pp.numpy()) < 1e-13


# -- the eo hop's new forms (B1) --------------------------------------------

@pytest.mark.parametrize("antiperiodic", [True, False],
                         ids=["antiperiodic", "periodic"])
@pytest.mark.parametrize("parity", [0, 1])
def test_recon12_hop_matches_full_links(parity, antiperiodic):
    """R=2 against R=3 on SU(3) links, 4x6x8x10 (T=10: the forward
    boundary plane t=9 and the backward one t=0 both hold sites of each
    parity): 1e-6 relative (f32 roundoff of the rebuilt row; the JAX
    package records ~3e-6).  With the boundary sign flipped the hop is off
    by O(1), so the check sees the sign."""
    g = su3_gauge(ASYM, seed=64)
    tpk = DiracWilsonPC(_t(g), LatticeGeometry(ASYM), KAPPA,
                        antiperiodic_t=antiperiodic).packed()
    full = tpk.pairs(torch.float32, precision_form="full")
    r12 = tpk.pairs(torch.float32, precision_form="r12")
    assert r12.gauge_eo_pp[0].shape[1] == 2 and r12._tb_sign == antiperiodic
    x = _t(gaussian(pair_spinor_shape(ASYM), seed=65, dtype=np.float32))
    want = full._d_to(x, parity, torch.float32).numpy()
    assert rel_err(r12._d_to(x, parity, torch.float32).numpy(), want) < 1e-6
    dims = lattice_shape(ASYM)
    wrong = twpp.dslash_eo_packed_plain(
        r12.gauge_eo_pp[parity], r12._u_bw[parity], x, dims, parity,
        tb_sign=not antiperiodic)
    assert rel_err(wrong.numpy(), want) > 0.1


@pytest.mark.slow
def test_sloppy_bf16_operator_matches_jax():
    """The bf16 sloppy operator against JAX's ``dpk.pairs(jnp.bfloat16)``:
    M bit-exact on 4x6x8x10 (bf16 storage, f32 sums, the same rounding
    points)."""
    g = noisy_gauge(ASYM, seed=66)
    jpk = JDiracWilsonPC(jnp.asarray(g), JGeom(ASYM), KAPPA).packed()
    tpk = DiracWilsonPC(_t(g), LatticeGeometry(ASYM), KAPPA).packed()
    x = gaussian(pair_spinor_shape(ASYM), seed=67, dtype=np.float32)
    got = tpk.pairs(torch.bfloat16).M_pairs(_t(x).to(torch.bfloat16))
    want = jpk.pairs(jnp.bfloat16).M_pairs(
        jnp.asarray(x).astype(jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bf16_np(got), np.asarray(want, np.float32))


def test_sloppy_bf16_operator_rounding_points():
    """The bf16 sloppy operator keeps the JAX package's rounding points:
    the first hop rounded to bf16, the second f32, the result rounded
    after x - kappa^2 dd.  On links whose values bf16 holds exactly, M is
    bit-exact against that composition of the f32 operator's hops on
    4x6x8x10.  gamma5 on bf16 (f32 compute, cast back) is exact, so Mdag
    and MdagM follow."""
    g = _t(noisy_gauge(ASYM, seed=66))
    g = torch.complex(g.real.to(torch.bfloat16).to(torch.float32),
                      g.imag.to(torch.bfloat16).to(torch.float32))
    tpk = DiracWilsonPC(g, LatticeGeometry(ASYM), KAPPA).packed()
    x = _t(gaussian(pair_spinor_shape(ASYM), seed=67,
                    dtype=np.float32)).to(torch.bfloat16)
    top, f32 = tpk.pairs(torch.bfloat16), tpk.pairs(torch.float32)
    got = top.M_pairs(x)
    p = top.matpc
    tmp = f32._d_to(x.to(torch.float32), 1 - p, torch.float32)
    dd = f32._d_to(tmp.to(torch.bfloat16).to(torch.float32), p,
                   torch.float32)
    want = (x.to(torch.float32) - KAPPA ** 2 * dd).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    g5g5 = top._g5_pairs(top._g5_pairs(got))
    assert g5g5.dtype == torch.bfloat16 and torch.equal(g5g5, got)
    # the gamma5 sign is built once per (device, ndim, axis) and reused
    key = (got.device, got.ndim, 0)
    sign = mwil._G5_SIGNS[key]
    top.Mdag_pairs(got)
    assert mwil._G5_SIGNS[key] is sign


@pytest.mark.slow
@pytest.mark.parametrize("store", ["float32", "bfloat16"])
def test_recon12_plain_matches_jax_pallas_kernel(store):
    """R=2 with tb_sign: the port's plain version against the JAX
    package's Pallas kernel in interpret mode, both parities, SU(3) links
    with the antiperiodic phase folded in.  f32 output within 1e-5 (f32
    sums in another order); from bf16 storage too."""
    g = su3_gauge(ASYM, seed=68)
    tpk = DiracWilsonPC(_t(g), LatticeGeometry(ASYM), KAPPA).packed()
    tdt, jdt = getattr(torch, store), getattr(jnp, store)
    r12 = tpk.pairs(tdt, precision_form="r12")
    dims = lattice_shape(ASYM)
    x = _t(gaussian(pair_spinor_shape(ASYM), seed=69,
                    dtype=np.float32)).to(tdt)
    for parity in (0, 1):
        ju = jnp.asarray(r12.gauge_eo_pp[parity].to(torch.float32).numpy()
                         ).astype(jdt)
        jb = jnp.asarray(r12._u_bw[parity].to(torch.float32).numpy()
                         ).astype(jdt)
        want = jwpp.dslash_eo_pallas_packed(
            ju, jb, jnp.asarray(x.to(torch.float32).numpy()).astype(jdt),
            dims, parity, interpret=True, out_dtype=jnp.float32,
            tb_sign=True)
        got = r12._d_to(x, parity, torch.float32)
        assert rel_err(got.numpy(), np.asarray(want)) < 1e-5


# -- cg_reliable and the invert_quda routes -----------------------------------

@pytest.fixture(scope="module")
def hpd_system():
    """A real symmetric positive-definite system, condition number 50:
    the solver alone, as test_torch_blas_cg.py does for fused_cg.  (At
    condition number 200 bf16 iterates stall above tol 1e-6 in both
    packages.)"""
    rng = np.random.default_rng(70)
    n = 192
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = (q * np.geomspace(1.0, 50.0, n)) @ q.T
    return a.astype(np.float32), rng.standard_normal(n).astype(np.float32)


def test_cg_reliable_matches_jax(hpd_system):
    """cg_reliable with bf16 pair storage against the JAX package's on the
    same system: both converge, iterations within 10%, solutions within
    1e-3 relative (bf16 rounding of the sloppy iterates moves the last
    digits; the reliable updates keep the true residual honest)."""
    a, b = hpd_system
    at, aj = _t(a), jnp.asarray(a)

    def lo_t(v):
        return (at @ v.to(torch.float32)).to(torch.bfloat16)

    def lo_j(v):
        return (aj @ v.astype(jnp.float32)).astype(jnp.bfloat16)

    res = tmixed.cg_reliable(lambda v: at @ v, lo_t, _t(b),
                             tmixed.pair_inplace_codec(torch.bfloat16),
                             tol=TOL, maxiter=500)
    jres = jmixed.cg_reliable(
        lambda v: aj @ v, lo_j, jnp.asarray(b), tol=TOL, maxiter=500,
        codec=jmixed.pair_inplace_codec(jnp.bfloat16,
                                        use_pallas_tail=False))
    assert res.converged and bool(jres.converged)
    assert res.reliable_updates >= 1
    assert abs(res.iters - int(jres.iters)) <= 0.1 * int(jres.iters)
    assert rel_err(res.x.numpy(), jres.x) < 1e-3
    b64 = b.astype(np.float64)
    r = b64 - a.astype(np.float64) @ res.x.numpy().astype(np.float64)
    assert float(np.sum(r * r)) <= TOL ** 2 * float(np.sum(b64 * b64))


def _port_solve(g, b, dims=SMALL, reconstruct=18, **kw):
    qt.init_quda(device="cpu")
    try:
        qt.load_gauge_quda(g, qt.GaugeParam(X=dims, cuda_prec="single",
                                            reconstruct=reconstruct))
        base = dict(dslash_type="wilson", inv_type="cg",
                    solve_type="normop-pc", kappa=KAPPA, tol=TOL,
                    maxiter=1000, cuda_prec="single")
        base.update(kw)
        p = qt.InvertParam(**base)
        x = qt.invert_quda(b, p)
    finally:
        qt.end_quda()
    return x.numpy(), p


@pytest.mark.parametrize("form", ["full", "r12"])
def test_invert_quda_half(form, monkeypatch):
    """single/half on 4^3x8 SU(3) links, full and recon-12 (through
    GaugeParam.reconstruct): converged, true_res <= 10 tol, at least one
    reliable update, every packed operator built in that form, and the
    solution within 1e-3 relative of the single/single route's (both
    solve the same system to tol 1e-6)."""
    g = su3_gauge(SMALL, seed=71)
    b = gaussian(lattice_shape(SMALL) + (4, 3), seed=72)
    x_ref, p_ref = _port_solve(g, b)
    built = []
    pairs = mwil.DiracWilsonPCPacked.pairs

    def spy(self, store_dtype=torch.float32, precision_form="full"):
        built.append((store_dtype, precision_form))
        return pairs(self, store_dtype, precision_form)

    monkeypatch.setattr(mwil.DiracWilsonPCPacked, "pairs", spy)
    x, p = _port_solve(g, b, cuda_prec_sloppy="half",
                       reconstruct=12 if form == "r12" else 18)
    assert sorted(built, key=str) == [(torch.bfloat16, form),
                                      (torch.float32, form)]
    assert p.converged and p.true_res <= 10 * TOL
    assert p.reliable_updates >= 1 and p_ref.reliable_updates == 0
    assert p.x_df64_lo is None
    assert np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref) < 1e-3


@pytest.mark.parametrize("sloppy,want", [("auto", "single"),
                                         ("single", "single"),
                                         ("half", "half")])
def test_sloppy_precision_resolution(sloppy, want):
    """cuda_prec_sloppy='auto' resolves to cuda_prec (the JAX package's
    non-TPU branch); an explicit value is honoured."""
    p = qt.InvertParam(cuda_prec="single", cuda_prec_sloppy=sloppy)
    assert tapi._resolve_sloppy(p) == want


@pytest.mark.parametrize("sloppy", ["single", "half"])
def test_df64_invert_reaches_1e10(sloppy):
    """The df64 route on 4^4 reaches true_res < 1e-10, and a complex128
    oracle agrees: |b - M (x + x_df64_lo)| / |b| < 1e-10 with the
    full-lattice complex128 operator on the same f32 links."""
    g = noisy_gauge(HYPERCUBE, seed=75)
    b = gaussian(lattice_shape(HYPERCUBE) + (4, 3), seed=76)
    x, p = _port_solve(g, b, dims=HYPERCUBE, tol=1e-10,
                       cuda_prec_sloppy=sloppy)
    assert p.converged and p.true_res < 1e-10 and p.reliable_updates >= 1
    x128 = x.astype(np.complex128) + p.x_df64_lo.numpy().astype(
        np.complex128)
    d = DiracWilson(_t(g).to(torch.complex128), LatticeGeometry(HYPERCUBE),
                    KAPPA)
    b128 = torch.from_numpy(b.astype(np.complex128))
    r = b128 - d.M(torch.from_numpy(x128))
    oracle = float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b128))
    assert oracle < 1e-10
    # without x_df64_lo the f32-rounded solution sits near the f32 floor
    r32 = b128 - d.M(torch.from_numpy(x.astype(np.complex128)))
    assert float(torch.linalg.vector_norm(r32)
                 / torch.linalg.vector_norm(b128)) > oracle


@pytest.mark.parametrize("tol,df64", [(1e-6, False), (5e-8, False),
                                      (4.9e-8, True), (1e-10, True)])
def test_df64_gate_follows_tol(tol, df64):
    """The df64 route is taken exactly below tol 5e-8, where an f32
    precise side cannot certify the residual."""
    assert tapi._df64_route(qt.InvertParam(cuda_prec="single",
                                           tol=tol)) is df64


def test_link_form_from_gauge_param():
    """GaugeParam.reconstruct selects the packed operators' link form
    (18 -> full, 12 -> r12, 8 queued); the operator's own
    ``precision_form`` defaults to full and rejects unknown values."""
    g = su3_gauge(HYPERCUBE, seed=79)
    tpk = DiracWilsonPC(_t(g), LatticeGeometry(HYPERCUBE), KAPPA).packed()
    assert tpk.pairs()._precision_form == "full"
    assert tpk.pairs(precision_form="r12")._precision_form == "r12"
    with pytest.raises(ValueError, match="r13"):
        tpk.pairs(precision_form="r13")
    with pytest.raises(QudaError, match="reconstruct"):
        qt.GaugeParam(X=HYPERCUBE, reconstruct=13).validate()
    qt.init_quda(device="cpu")
    try:
        for rec, form in ((18, "full"), (12, "r12")):
            qt.load_gauge_quda(g, qt.GaugeParam(X=HYPERCUBE,
                                                cuda_prec="single",
                                                reconstruct=rec))
            assert tapi._link_form() == form
        qt.load_gauge_quda(g, qt.GaugeParam(X=HYPERCUBE, cuda_prec="single",
                                            reconstruct=8))
        with pytest.raises(NotImplementedError, match="ROADMAP A7"):
            tapi._link_form()
    finally:
        qt.end_quda()


# -- the whole-solve comparisons with the JAX package (slow) -----------------

@pytest.mark.slow
def test_cg_reliable_wilson_matches_jax():
    """cg_reliable on the Wilson normal operator at 4^3x8: the JAX
    package's f32 and bf16 packed pair operators against the port's, same
    codec.  Iterations within 10%, solutions within 1e-3 relative."""
    g = noisy_gauge(SMALL, seed=80)
    b = gaussian(pair_spinor_shape(SMALL), seed=81, dtype=np.float32)
    jpk = JDiracWilsonPC(jnp.asarray(g), JGeom(SMALL), KAPPA).packed()
    tpk = DiracWilsonPC(_t(g), LatticeGeometry(SMALL), KAPPA).packed()
    jres = jmixed.cg_reliable(
        jpk.pairs(jnp.float32).MdagM_pairs,
        jpk.pairs(jnp.bfloat16).MdagM_pairs, jnp.asarray(b), tol=TOL,
        maxiter=500, codec=jmixed.pair_inplace_codec(jnp.bfloat16))
    res = tmixed.cg_reliable(
        tpk.pairs(torch.float32).MdagM_pairs,
        tpk.pairs(torch.bfloat16).MdagM_pairs, _t(b),
        tmixed.pair_inplace_codec(torch.bfloat16), tol=TOL, maxiter=500)
    assert res.converged and bool(jres.converged)
    assert abs(res.iters - int(jres.iters)) <= 0.1 * int(jres.iters)
    assert rel_err(res.x.numpy(), jres.x) < 1e-3


def _jax_solve(g, b, dims, **kw):
    old = os.environ.get("QUDA_TPU_PACKED")
    os.environ["QUDA_TPU_PACKED"] = "1"
    try:
        japi.init_quda()
        japi.load_gauge_quda(g, JGaugeParam(X=dims, cuda_prec="single"))
        base = dict(dslash_type="wilson", inv_type="cg",
                    solve_type="normop-pc", kappa=KAPPA, tol=TOL,
                    maxiter=1000, cuda_prec="single")
        base.update(kw)
        jp = JInvertParam(**base)
        x = np.asarray(japi.invert_quda(b, jp))
        japi.end_quda()
    finally:
        if old is None:
            os.environ.pop("QUDA_TPU_PACKED")
        else:
            os.environ["QUDA_TPU_PACKED"] = old
    return x, jp


@pytest.mark.slow
def test_invert_quda_half_matches_jax():
    """invert_quda(single/half) on the same 4^3x8 inputs as
    test_torch_invert.py, the JAX package on its packed route (on a CPU
    host that is the XLA pair stencil with a complex precise side, the same
    function up to f32 rounding): both converged with true_res <= 10 tol,
    iterations within 10%, solutions within 1e-3 relative."""
    g = noisy_gauge(SMALL, seed=21)
    b = gaussian(lattice_shape(SMALL) + (4, 3), seed=22)
    xj, jp = _jax_solve(g, b, SMALL, cuda_prec_sloppy="half")
    x, p = _port_solve(g, b, cuda_prec_sloppy="half")
    assert p.converged and jp.converged
    assert p.true_res <= 10 * TOL and jp.true_res <= 10 * TOL
    assert abs(p.iter_count - jp.iter_count) <= 0.1 * jp.iter_count
    assert np.linalg.norm(x - xj) / np.linalg.norm(xj) < 1e-3


@pytest.mark.slow
def test_df64_invert_matches_jax():
    """The df64 route against the JAX package's (single/single, tol 1e-10,
    4^4): both below 1e-10, solutions (hi + lo) within 1e-8 relative."""
    g = noisy_gauge(HYPERCUBE, seed=75)
    b = gaussian(lattice_shape(HYPERCUBE) + (4, 3), seed=76)
    xj, jp = _jax_solve(g, b, HYPERCUBE, tol=1e-10)
    x, p = _port_solve(g, b, dims=HYPERCUBE, tol=1e-10)
    assert p.true_res < 1e-10 and jp.true_res < 1e-10
    xj_full = xj.astype(np.complex128) + np.asarray(jp.x_df64_lo)
    xt_full = x.astype(np.complex128) + p.x_df64_lo.numpy()
    assert (np.linalg.norm(xt_full - xj_full) / np.linalg.norm(xj_full)
            < 1e-8)
