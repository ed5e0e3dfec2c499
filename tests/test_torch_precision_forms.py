"""Port parity: Wilson quarter precision and the copy-free link forms.

quda_tpu_torch against quda_tpu on the same numpy inputs (seeds 301-329,
4^4 and 4^3x8): the int8 block-float codec (ops/blockfloat.py, bit for
bit, round half to even included), the pair operator's link forms
``r12f``, ``int8`` and ``pallas_version=3`` (v3) with their plain hops,
the multi-RHS r12f hop, invert_quda(cuda_prec_sloppy="quarter") at tol
1e-6 (cg_reliable) and 1e-10 (df64), and the refusals that remain.

Tolerances: codecs and quantised links bit for bit; the copy-free forms
bit for bit the resident-copy forms on the same links (the same f32
arithmetic, only the backward link's address differs); float32 hops
within 1e-6 of the JAX package's (sums in another order); solves at
their tolerance.  The JAX Pallas kernels in interpret mode (20-35 s a
call on a CPU core) and whole JAX quarter solves are ``slow``; the CUDA
kernels meet their plain versions on the card in test_torch_cuda.py.
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
from quda_tpu.ops import blockfloat as jbf
from quda_tpu.ops import pair as jpair
from quda_tpu.ops import wilson_packed as jwpk
from quda_tpu_torch.fields.geometry import LatticeGeometry
from quda_tpu_torch.interfaces import quda_api as tapi
from quda_tpu_torch.models import wilson as mwil
from quda_tpu_torch.models.clover import DiracCloverPC
from quda_tpu_torch.models.wilson import DiracWilson, DiracWilsonPC
from quda_tpu_torch.ops import blockfloat as tbf
from quda_tpu_torch.ops import pair as tpair
from quda_tpu_torch.ops import wilson_pallas_packed as wpp
from quda_tpu_torch.utils import kernels
from quda_tpu_torch.utils.convert import int8_links_from_numpy

from tests.torch_inputs import (SMALL, gaussian, lattice_shape,
                                pair_spinor_shape, rel_err, su3_gauge)
from tests.torch_inputs import one_torch_thread  # noqa: F401 (autouse)

KAPPA = 0.12
HYPERCUBE = (4, 4, 4, 4)
F32, BF16 = torch.float32, torch.bfloat16


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _packed(dims, seed):
    g = su3_gauge(dims, seed)
    return g, DiracWilsonPC(_t(g), LatticeGeometry(dims), KAPPA).packed()


def _psi(dims, seed, store=F32, n=None):
    shape = pair_spinor_shape(dims) if n is None else (
        (n,) + pair_spinor_shape(dims))
    return _t(gaussian(shape, seed, dtype=np.float32)).to(store)


# -- the int8 block-float codec ----------------------------------------------

def test_int8_links_match_jax_bit_for_bit():
    """to_int8_links / from_int8_links on random packed links (and a
    link whose quotients land on half-integers: amax 127 makes the scale
    exactly 1, so 2.5, -3.5, 0.5 and -0.5 round half to even) equal the
    JAX package's bit for bit, mantissas, scales and decoded links."""
    rng = np.random.default_rng(301)
    g = rng.standard_normal((4, 3, 3, 2, 4, 4, 8)).astype(np.float32)
    g[0, :, :, :, 0, 0, 0] = 0.0
    g[0, 0, 0, 0, 0, 0, 0] = 127.0
    g[0, 0, 1, 0, 0, 0, 0] = 2.5
    g[0, 0, 1, 1, 0, 0, 0] = -3.5
    g[0, 1, 2, 0, 0, 0, 0] = 0.5
    g[0, 2, 2, 1, 0, 0, 0] = -0.5
    jq, js = (np.asarray(a) for a in jbf.to_int8_links(jnp.asarray(g)))
    tq, ts = tbf.to_int8_links(_t(g))
    assert tq.dtype == torch.int8 and ts.dtype == F32
    np.testing.assert_array_equal(tq.numpy(), jq)
    np.testing.assert_array_equal(ts.numpy(), js)
    assert ts[0, 0, 0, 0] == 1.0
    assert [int(tq[0, 0, 1, 0, 0, 0, 0]), int(tq[0, 0, 1, 1, 0, 0, 0]),
            int(tq[0, 1, 2, 0, 0, 0, 0]),
            int(tq[0, 2, 2, 1, 0, 0, 0])] == [2, -4, 0, 0]
    np.testing.assert_array_equal(
        tbf.from_int8_links(tq, ts).numpy(),
        np.asarray(jbf.from_int8_links(jnp.asarray(jq), jnp.asarray(js))))
    # the JAX package's quantised links carried across unchanged
    cq, cs = int8_links_from_numpy(jq, js, "cpu")
    assert torch.equal(cq, tq) and torch.equal(cs, ts)
    with pytest.raises(ValueError, match="int8"):
        int8_links_from_numpy(jq.astype(np.int16), js, "cpu")
    with pytest.raises(ValueError, match="float32"):
        int8_links_from_numpy(jq, js[:, :1], "cpu")


def test_int8_fields_and_gauge_codec_match_jax():
    """to_int8/from_int8 of a complex field (one scale per site), the
    pair codec's "quarter" encode/decode (decoded links rounded to bf16)
    and compression_ratio equal the JAX package's."""
    x = gaussian((2, 3, 5, 4, 3), 302)
    jf, tf = jbf.to_int8(jnp.asarray(x)), tbf.to_int8(_t(x))
    np.testing.assert_array_equal(tf.data.numpy(), np.asarray(jf.data))
    np.testing.assert_array_equal(tf.scale.numpy(), np.asarray(jf.scale))
    np.testing.assert_array_equal(tbf.from_int8(tf).numpy(),
                                  np.asarray(jbf.from_int8(jf)))
    g = su3_gauge(HYPERCUBE, 303)
    je = jpair.decode_gauge(jpair.encode_gauge(jnp.asarray(g), "quarter"))
    te = tpair.decode_gauge(tpair.encode_gauge(_t(g), "quarter"))
    assert te.dtype == BF16
    np.testing.assert_array_equal(te.float().numpy(),
                                  np.asarray(je.astype(jnp.float32)))
    hb = tpair.encode_gauge(_t(g), "half")
    np.testing.assert_array_equal(
        hb.float().numpy(), np.asarray(jpair.encode_gauge(
            jnp.asarray(g), "half").astype(jnp.float32)))
    for codec in ("bf16", "int8"):
        assert tbf.compression_ratio(_t(g), codec, 9) == \
            jbf.compression_ratio(jnp.asarray(g), codec, 9)


# -- the pair operator's link forms ------------------------------------------

# (form, pallas_version, the resident-copy form it must equal bit for bit)
COPY_FREE = [("full", 3, "full"), ("r12", 3, "r12"), ("r12f", 2, "r12")]


@pytest.mark.parametrize("store", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("form,version,twin", COPY_FREE,
                         ids=["v3-full", "v3-r12", "r12f"])
def test_copy_free_forms_equal_resident_forms(form, version, twin, parity,
                                              store):
    """The v3 and r12f operators' hops (``_d_to``, the copy-free wrappers'
    plain versions) equal B1's on the resident backward copy bit for bit,
    for f32 and bf16 storage and both outputs, at 4^3x8 (T = 8: both t
    boundary planes hold sites of each parity)."""
    _, tpk = _packed(SMALL, 304)
    op = tpk.pairs(store, form, pallas_version=version)
    ref = tpk.pairs(store, twin)
    psi = _psi(SMALL, 305 + parity, store)
    for out in (store, F32):
        np.testing.assert_array_equal(
            op._d_to(psi, parity, out).float().numpy(),
            ref._d_to(psi, parity, out).float().numpy())
    fn = (wpp.dslash_eo_pallas_packed_r12f if form == "r12f"
          else wpp.dslash_eo_pallas_packed_v3)
    got = fn(op.gauge_eo_pp[parity], op.gauge_eo_pp[1 - parity], psi,
             op.dims, parity)
    want = wpp.dslash_eo_pallas_packed(ref.gauge_eo_pp[parity],
                                       ref._u_bw[parity], psi, ref.dims,
                                       parity)
    assert torch.equal(got, want)


@pytest.mark.parametrize("store", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("parity", [0, 1])
def test_int8_operator_is_the_hop_on_decoded_links(parity, store):
    """The int8 operator quantises its storage-dtype links (to_int8_links
    of the f32-cast pairs) and its hop equals B1's plain version on the
    decoded links (from_int8_links, backward_gauge_eo) bit for bit, for
    f32 -> f32, bf16 -> bf16 and bf16 -> f32; the quantisation moves the
    hop by at most a few scale/2 against the full-link one."""
    _, tpk = _packed(HYPERCUBE, 307)
    op = tpk.pairs(store, "int8")
    full = tpk.pairs(store, "full")
    dims = op.dims
    psi = _psi(HYPERCUBE, 308 + parity, store)
    for p in (0, 1):
        q, s = tbf.to_int8_links(full.gauge_eo_pp[p].to(F32))
        assert torch.equal(op._gauge_q[p], q)
        assert torch.equal(op._gauge_s[p], s)
    u_here = tbf.from_int8_links(op._gauge_q[parity], op._gauge_s[parity])
    u_bw = wpp.backward_gauge_eo(
        tbf.from_int8_links(op._gauge_q[1 - parity], op._gauge_s[1 - parity]),
        dims, parity)
    outs = (F32,) if store == F32 else (BF16, F32)
    for out in outs:
        got = op._d_to(psi, parity, out)
        assert got.dtype == out
        want = wpp.dslash_eo_packed_plain(u_here, u_bw, psi, dims, parity,
                                          out_dtype=out)
        assert torch.equal(got, want)
    err = rel_err(op._d_to(psi, parity, F32).numpy(),
                  full._d_to(psi, parity, F32).numpy())
    assert 1e-5 < err < 2e-2


def test_int8_operator_from_jax_links_matches_jax():
    """The port's int8 operator on the JAX package's (q, scale) carried
    across by int8_links_from_numpy, against JAX's int8 operator (its XLA
    route: the same links decoded at set-up), both parities, 4^4: within
    1e-6 relative (f32 sums in another order)."""
    g, tpk = _packed(HYPERCUBE, 310)
    jpk = JDiracWilsonPC(jnp.asarray(g), JGeom(HYPERCUBE), KAPPA).packed()
    jop = jpk.pairs(jnp.float32, use_pallas=False, precision_form="int8")
    op = tpk.pairs(F32, "int8")
    qs = [jbf.to_int8_links(jwpk.to_packed_pairs(gp, jnp.float32))
          for gp in jpk.gauge_eo_p]
    carried = [int8_links_from_numpy(np.asarray(q), np.asarray(s), "cpu")
               for q, s in qs]
    op._gauge_q = tuple(q for q, _ in carried)
    op._gauge_s = tuple(s for _, s in carried)
    for parity in (0, 1):
        psi = gaussian(pair_spinor_shape(HYPERCUBE), 311 + parity,
                       dtype=np.float32)
        want = np.asarray(jop._d_to(jnp.asarray(psi), parity, jnp.float32))
        got = op._d_to(_t(psi), parity, F32).numpy()
        assert rel_err(got, want) < 1e-6


@pytest.mark.parametrize("form,version", [("r12f", 2), ("int8", 2),
                                          ("full", 3)],
                         ids=["r12f", "int8", "v3"])
def test_batched_forms_are_the_single_forms_lane_by_lane(form, version):
    """The multi-RHS hop of each form (r12f: the multi-RHS r12f hop's
    plain version; int8 and v3: the single-RHS hop on each right-hand
    side) and M^dag M on a batch of 3, lane by lane bit for bit the
    single-RHS forms."""
    _, tpk = _packed(SMALL, 313)
    op = tpk.pairs(F32, form, pallas_version=version)
    psi_b = _psi(SMALL, 314, n=3)
    for parity in (0, 1):
        got = op._d_to_mrhs(psi_b, parity, F32)
        for r in range(3):
            assert torch.equal(got[r], op._d_to(psi_b[r], parity, F32))
    mm = op.MdagM_pairs_mrhs(psi_b)
    for r in range(3):
        assert torch.equal(mm[r], op.MdagM_pairs(psi_b[r]))
    if form == "r12f":
        u_here, u_there = op.gauge_eo_pp[0], op.gauge_eo_pp[1]
        lanes = wpp.dslash_eo_pallas_packed_r12f_mrhs(u_here, u_there,
                                                      psi_b, op.dims, 0)
        for r in range(3):
            assert torch.equal(lanes[r], wpp.dslash_eo_pallas_packed_r12f(
                u_here, u_there, psi_b[r], op.dims, 0))


@pytest.mark.parametrize("form,version,has_copy", [
    ("full", 2, True), ("r12", 2, True), ("full", 3, False),
    ("r12", 3, False), ("r12f", 2, False), ("r12f", 3, False),
    ("int8", 2, False)])
def test_copy_free_forms_hold_no_backward_copy(form, version, has_copy):
    """r12f, int8 and v3 build no resident backward links (the JAX
    package builds none either); int8 keeps only its mantissas and
    scales."""
    _, tpk = _packed(HYPERCUBE, 315)
    op = tpk.pairs(F32, form, pallas_version=version)
    assert hasattr(op, "_u_bw") is has_copy
    assert op._precision_form == form and op._pallas_version == version
    if form == "int8":
        assert op.gauge_eo_pp is None
        assert [q.dtype for q in op._gauge_q] == [torch.int8] * 2
        assert tuple(op._gauge_s[0].shape) == (4, 4, 4, 8)
    else:
        assert op.gauge_eo_pp[0].shape[1] == (2 if "r12" in form else 3)


# -- invert_quda at quarter ---------------------------------------------------

def _port_solve(g, b, dims=HYPERCUBE, **kw):
    qt.init_quda(device="cpu")
    try:
        qt.load_gauge_quda(g, qt.GaugeParam(X=dims, cuda_prec="single"))
        base = dict(dslash_type="wilson", inv_type="cg",
                    solve_type="normop-pc", kappa=KAPPA, tol=1e-6,
                    maxiter=1000, cuda_prec="single",
                    cuda_prec_sloppy="quarter")
        base.update(kw)
        p = qt.InvertParam(**base)
        x = qt.invert_quda(b, p)
    finally:
        qt.end_quda()
    return x.numpy(), p


@pytest.mark.parametrize("tol", [1e-6, 1e-10])
def test_invert_quda_quarter(tol, monkeypatch):
    """invert_quda(single/quarter) on 4^4 SU(3) links: the sloppy
    operator is the bf16 int8 one (cg_reliable at 1e-6, the df64 route
    at 1e-10); converged, with reliable updates; true_res <= 1e-5 at
    1e-6, and at 1e-10 <= 1e-10 in df64 and in complex128 on x +
    x_df64_lo."""
    g = su3_gauge(HYPERCUBE, 316)
    b = gaussian(lattice_shape(HYPERCUBE) + (4, 3), 317)
    built = []
    pairs = mwil.DiracWilsonPCPacked.pairs

    def spy(self, store_dtype=F32, precision_form="full", pallas_version=2):
        built.append((store_dtype, precision_form))
        return pairs(self, store_dtype, precision_form, pallas_version)

    monkeypatch.setattr(mwil.DiracWilsonPCPacked, "pairs", spy)
    x, p = _port_solve(g, b, tol=tol)
    assert (BF16, "int8") in built
    assert p.converged and p.reliable_updates >= 1
    if tol > 5e-8:
        assert (F32, "full") in built
        assert p.true_res <= 1e-5 and p.x_df64_lo is None
        return
    assert p.true_res <= 1e-10
    x128 = x.astype(np.complex128) + p.x_df64_lo.numpy()
    d = DiracWilson(_t(g).to(torch.complex128), LatticeGeometry(HYPERCUBE),
                    KAPPA)
    b128 = _t(b.astype(np.complex128))
    r = b128 - d.M(_t(x128))
    assert float(torch.linalg.vector_norm(r)
                 / torch.linalg.vector_norm(b128)) <= 1e-10


def test_quarter_and_form_refusals():
    """What stays refused names its ROADMAP item: quarter for clover,
    twisted mass, hisq and Möbius, and through invert_multi_src_quda and
    invert_multishift_quda (A7); the copy-free and int8 forms on the
    clover operator and in float64 (A7); auto and bzfull (A17); an
    unknown pallas_version.  (fold is served: tests/test_torch_fold_v3.py.)"""
    g = su3_gauge(HYPERCUBE, 318)
    b = gaussian(lattice_shape(HYPERCUBE) + (4, 3), 319)
    for kw in ({"dslash_type": "clover", "csw": 1.0},
               {"dslash_type": "twisted-mass", "mu": 0.1},
               {"dslash_type": "hisq", "mass": 0.1},
               {"dslash_type": "mobius", "Ls": 4}):
        with pytest.raises(NotImplementedError, match="ROADMAP A7"):
            _port_solve(g, b, **kw)
    qt.init_quda(device="cpu")
    try:
        qt.load_gauge_quda(g, qt.GaugeParam(X=HYPERCUBE, cuda_prec="single"))
        p = qt.InvertParam(dslash_type="wilson", kappa=KAPPA,
                           cuda_prec="single", cuda_prec_sloppy="quarter")
        with pytest.raises(NotImplementedError, match="ROADMAP A7"):
            qt.invert_multi_src_quda(b[None], p)
        p = qt.InvertParam(dslash_type="staggered", mass=0.1,
                           cuda_prec="single", cuda_prec_sloppy="quarter",
                           num_offset=1, offset=[0.0])
        with pytest.raises(NotImplementedError, match="ROADMAP A7"):
            qt.invert_multishift_quda(b[..., :1, :], p)
    finally:
        qt.end_quda()
    _, tpk = _packed(HYPERCUBE, 318)
    for form, version in (("r12f", 2), ("int8", 2), ("full", 3)):
        with pytest.raises(NotImplementedError, match="ROADMAP A7"):
            tpk.pairs(torch.float64, form, pallas_version=version)
    dpc = DiracCloverPC(_t(g), LatticeGeometry(HYPERCUBE), KAPPA, 1.0)
    for form in ("r12f", "int8"):
        with pytest.raises(NotImplementedError, match="ROADMAP A7"):
            dpc.pairs(F32, precision_form=form)
    for form, item in (("auto", "A17"), ("bzfull", "A17")):
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            tpk.pairs(F32, form)
    with pytest.raises(ValueError, match="pallas_version"):
        tpk.pairs(F32, "full", pallas_version=4)


# -- the wrappers never fall back ----------------------------------------------

DIMS = (4, 2, 2, 4)                      # (T, Z, Y, X)
SITES = (4, 2, 4)


@pytest.fixture
def card_request(monkeypatch):
    """The wrappers see CPU tensors as card tensors; the kernel library
    cannot load, and reaching a plain version fails the test."""
    monkeypatch.setattr(kernels, "dispatch_device", lambda *t: "cuda")

    def no_library():
        raise RuntimeError("kernel library unavailable")

    def plain_reached(*args, **kwargs):
        raise AssertionError("plain version reached on a card request")

    monkeypatch.setattr(kernels, "library", no_library)
    for name in ("dslash_eo_there_plain", "dslash_eo_there_mrhs_plain",
                 "dslash_eo_int8_plain", "dslash_eo_packed_plain"):
        monkeypatch.setattr(wpp, name, plain_reached)


def _launch_counts():
    return [(f.launches, dict(f.launches_by_form)) for f in (
        wpp.dslash_eo_pallas_packed_v3, wpp.dslash_eo_pallas_packed_r12f,
        wpp.dslash_eo_pallas_packed_r12f_mrhs,
        wpp.dslash_eo_pallas_packed_int8)]


@pytest.mark.parametrize("fn", ["v3", "r12f"])
def test_copy_free_wrappers_raise_on_card_request(card_request, fn):
    """A card request reaches the kernel library or raises for a form
    without an instance (float64, f32 -> bf16) or a wrong shape or
    layout; nothing is counted."""
    wrapper = getattr(wpp, f"dslash_eo_pallas_packed_{fn}")
    before = _launch_counts()

    def args(dtype=F32, rows=3):
        return (torch.zeros((4, rows, 3, 2) + SITES, dtype=dtype),
                torch.zeros((4, rows, 3, 2) + SITES, dtype=dtype),
                torch.zeros((4, 3, 2) + SITES, dtype=dtype))

    for rows in (3, 2):
        for store, out in ((F32, F32), (BF16, BF16), (BF16, F32)):
            with pytest.raises(RuntimeError, match="unavailable"):
                wrapper(*args(store, rows), DIMS, 0, out_dtype=out)
    with pytest.raises(TypeError, match="A7"):
        wrapper(*args(torch.float64), DIMS, 0)
    with pytest.raises(TypeError, match="no kernel instance"):
        wrapper(*args(), DIMS, 0, out_dtype=BF16)
    u, v, psi = args()
    with pytest.raises(ValueError):
        wrapper(u, v[:, :, :, :, :2], psi, DIMS, 0)
    with pytest.raises(ValueError):
        wrapper(u, v, psi.transpose(-1, -2), DIMS, 0)
    with pytest.raises(TypeError):
        wrapper(u, v.to(BF16), psi, DIMS, 0)
    with pytest.raises(ValueError, match="target_parity"):
        wrapper(u, v, psi, DIMS, 2)
    batch = torch.zeros((3, 4, 3, 2) + SITES)
    with pytest.raises(RuntimeError, match="unavailable"):
        wpp.dslash_eo_pallas_packed_r12f_mrhs(u, v, batch, DIMS, 0)
    with pytest.raises(TypeError, match="A7"):
        wpp.dslash_eo_pallas_packed_r12f_mrhs(u.to(BF16), v.to(BF16),
                                              batch.to(BF16), DIMS, 0)
    with pytest.raises(ValueError, match="chunk"):
        wpp.dslash_eo_pallas_packed_r12f_mrhs(u, v, batch, DIMS, 0, chunk=3)
    assert _launch_counts() == before


def test_int8_wrapper_raises_on_card_request(card_request):
    """The int8 hop reaches the library for its three forms and raises
    for f32 -> bf16, float64, wrong mantissa or scale dtypes and
    shapes; nothing is counted."""
    before = _launch_counts()
    q = torch.zeros((4, 3, 3, 2) + SITES, dtype=torch.int8)
    s = torch.ones((4,) + SITES)
    psi = torch.zeros((4, 3, 2) + SITES)
    for store, out in ((F32, F32), (BF16, BF16), (BF16, F32)):
        with pytest.raises(RuntimeError, match="unavailable"):
            wpp.dslash_eo_pallas_packed_int8(q, s, q, s, psi.to(store), DIMS,
                                             1, out_dtype=out)
    for bad in (dict(out_dtype=BF16), dict(psi=psi.double())):
        with pytest.raises(TypeError, match="int8 hop"):
            wpp.dslash_eo_pallas_packed_int8(q, s, q, s,
                                             bad.get("psi", psi), DIMS, 0,
                                             out_dtype=bad.get("out_dtype"))
    with pytest.raises(TypeError):
        wpp.dslash_eo_pallas_packed_int8(q.to(torch.uint8), s, q, s, psi,
                                         DIMS, 0)
    with pytest.raises(TypeError):
        wpp.dslash_eo_pallas_packed_int8(q, s.double(), q, s, psi, DIMS, 0)
    with pytest.raises(ValueError):
        wpp.dslash_eo_pallas_packed_int8(q, s[:, :1], q, s, psi, DIMS, 0)
    with pytest.raises(ValueError):
        wpp.dslash_eo_pallas_packed_int8(q, s, q[:, :2], s, psi, DIMS, 0)
    assert _launch_counts() == before


def test_traffic_floors():
    """The bytes the timing rows hold each form to: int8 272 B a site
    bf16 -> bf16, 320 bf16 -> f32, 368 f32 -> f32; the copy-free forms
    B1's."""
    assert wpp.bytes_per_site_int8(BF16) == 272
    assert wpp.bytes_per_site_int8(BF16, F32) == 320
    assert wpp.bytes_per_site_int8(F32) == 368
    assert wpp.bytes_per_site(2, F32) == 576
    assert wpp.int8_form_name(BF16, F32) == "int8:bf16->f32"


# -- slow: JAX's Pallas kernels (interpret) and whole JAX solves --------------

@pytest.mark.slow
@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("form,version", [("full", 3), ("r12f", 2),
                                          ("int8", 2)],
                         ids=["v3", "r12f", "int8"])
def test_plain_forms_match_jax_pallas(form, version, parity):
    """The port's v3, r12f and int8 hops (their plain versions, through
    the pair operator) against the JAX package's Pallas kernels in
    interpret mode on the same 4^4 inputs (JAX's test_precision_forms
    set-up): within 1e-6 relative in f32."""
    g, tpk = _packed(HYPERCUBE, 320)
    jpk = JDiracWilsonPC(jnp.asarray(g), JGeom(HYPERCUBE), KAPPA).packed()
    jop = jpk.pairs(jnp.float32, use_pallas=True, pallas_interpret=True,
                    precision_form=form, pallas_version=version)
    op = tpk.pairs(F32, form, pallas_version=version)
    psi = gaussian(pair_spinor_shape(HYPERCUBE), 321 + parity,
                   dtype=np.float32)
    want = np.asarray(jop._d_to(jnp.asarray(psi), parity, jnp.float32))
    got = op._d_to(_t(psi), parity, F32).numpy()
    assert rel_err(got, want) < 1e-6
    if form == "int8":
        for p in (0, 1):
            np.testing.assert_array_equal(op._gauge_q[p].numpy(),
                                          np.asarray(jop._gauge_q[p]))
            np.testing.assert_array_equal(op._gauge_s[p].numpy(),
                                          np.asarray(jop._gauge_s[p]))


def _jax_solve(g, b, dims, **kw):
    old = os.environ.get("QUDA_TPU_PACKED")
    os.environ["QUDA_TPU_PACKED"] = "1"
    try:
        japi.init_quda()
        japi.load_gauge_quda(g, JGaugeParam(X=dims, cuda_prec="single"))
        base = dict(dslash_type="wilson", inv_type="cg",
                    solve_type="normop-pc", kappa=KAPPA, tol=1e-6,
                    maxiter=1000, cuda_prec="single",
                    cuda_prec_sloppy="quarter")
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
@pytest.mark.parametrize("dims,tol", [(SMALL, 1e-6), (HYPERCUBE, 1e-10)],
                         ids=["cg_reliable", "df64"])
def test_invert_quda_quarter_matches_jax(dims, tol, record_property):
    """Whole quarter solves against the JAX package's (QUDA_TPU_PACKED=1):
    at 1e-6 JAX takes its canonical int8 codec (links quantised from
    complex64, decoded links rounded to bf16), the port its int8 pair
    operator, so the two are compared at the solve's tolerance: both
    converged, solutions within 1e-5 relative; at 1e-10 both take the
    df64 route on the same int8 operator, solutions (hi + lo) within 1e-5
    too.  Both iteration counts are recorded."""
    g = su3_gauge(dims, 324)
    b = gaussian(lattice_shape(dims) + (4, 3), 325)
    xj, jp = _jax_solve(g, b, dims, tol=tol)
    x, p = _port_solve(g, b, dims=dims, tol=tol)
    record_property("iters_port", p.iter_count)
    record_property("iters_jax", jp.iter_count)
    assert p.converged and jp.converged
    if tol < 5e-8:
        xj = xj.astype(np.complex128) + np.asarray(jp.x_df64_lo)
        x = x.astype(np.complex128) + p.x_df64_lo.numpy()
    assert np.linalg.norm(x - xj) / np.linalg.norm(xj) < 1e-5
