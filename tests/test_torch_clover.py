"""Port parity: the Wilson-clover slice (field strength, clover term, the
fused clover hop's plain versions, the clover Schur operator and the
clover routes of invert_quda).

quda_tpu_torch against quda_tpu on the same numpy inputs, and against the
numpy site-loop oracle tests/host_reference/clover_ref.py.  Tolerances:
1e-12 (complex128 construction, the same sums in another order), 1e-10
(the Cholesky inverse), exact where both packages move the same numbers,
1e-6 relative in float32.  The CUDA kernel meets its plain versions on
the card in test_torch_cuda.py.  Comparisons with the JAX Pallas kernel
in interpret mode and with whole JAX solves are ``slow``; each has a fast
port-only twin here.
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
from quda_tpu.models import clover as jmcl
from quda_tpu.ops import clover as jcl
from quda_tpu.ops import clover_pallas as jclp
from quda_tpu.ops import fmunu as jfm
from quda_tpu_torch.fields.geometry import LatticeGeometry
from quda_tpu_torch.fields.spinor import even_odd_join, even_odd_split
from quda_tpu_torch.models import clover as tmcl
from quda_tpu_torch.models.dirac import apply_gamma5
from quda_tpu_torch.ops import clover as tcl
from quda_tpu_torch.ops import clover_pallas as clp
from quda_tpu_torch.ops import fmunu as tfm
from quda_tpu_torch.ops import wilson_packed as twpk
from quda_tpu_torch.solvers import cg

from tests.host_reference.clover_ref import (clover_matrix_ref,
                                             field_strength_ref)
from tests.torch_inputs import (ASYM, gaussian, lattice_shape,
                                pair_spinor_shape, rel_err, su3_gauge)
from tests.torch_inputs import one_torch_thread  # noqa: F401 (autouse)

KAPPA = 0.12
CSW = 1.0
COEFF = KAPPA * CSW / 2.0
HYPERCUBE = (4, 4, 4, 4)
TOL = 1e-6


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- field strength, clover term, inverse (complex128, 4^4) ----------------

@pytest.fixture(scope="module")
def gauge128():
    return su3_gauge(HYPERCUBE, seed=91, dtype=np.complex128)


def test_field_strength_matches_jax_and_host_reference(gauge128):
    got = tfm.field_strength(_t(gauge128)).numpy()
    assert got.shape == (6,) + lattice_shape(HYPERCUBE) + (3, 3)
    assert rel_err(got, np.asarray(jfm.field_strength(
        jnp.asarray(gauge128)))) < 1e-12
    assert rel_err(got, field_strength_ref(gauge128)) < 1e-12
    # Hermitian and traceless
    assert rel_err(got, np.conj(np.swapaxes(got, -1, -2))) < 1e-14
    assert np.abs(np.trace(got, axis1=-2, axis2=-1)).max() < 1e-14


def test_clover_blocks_match_jax_and_host_reference(gauge128):
    got = tcl.clover_blocks(_t(gauge128), COEFF).numpy()
    assert got.shape == lattice_shape(HYPERCUBE) + (2, 6, 6)
    assert rel_err(got, np.asarray(jcl.clover_blocks(
        jnp.asarray(gauge128), COEFF))) < 1e-12
    # the 12x12 oracle (spin-major s*3+c): chirality ch is the diagonal
    # 6x6 block at rows 6ch..6ch+5, and the off-chirality blocks vanish
    m12 = clover_matrix_ref(gauge128, COEFF)
    for ch in (0, 1):
        sl = slice(6 * ch, 6 * ch + 6)
        assert rel_err(got[..., ch, :, :], m12[..., sl, sl]) < 1e-12
    assert np.abs(m12[..., :6, 6:]).max() < 1e-14
    # apply_clover is the blocks' mat-vec on the (4,3) spinor
    psi = gaussian(lattice_shape(HYPERCUBE) + (4, 3), seed=92,
                   dtype=np.complex128)
    want = np.einsum("...ij,...j->...i", m12,
                     psi.reshape(psi.shape[:4] + (12,))).reshape(psi.shape)
    assert rel_err(tcl.apply_clover(_t(got), _t(psi)).numpy(), want) < 1e-12


def test_invert_clover_matches_jax(gauge128):
    blocks = tcl.clover_blocks(_t(gauge128), COEFF)
    got = tcl.invert_clover(blocks).numpy()
    assert rel_err(got, np.asarray(jcl.invert_clover(
        jnp.asarray(blocks.numpy())))) < 1e-10
    eye = np.broadcast_to(np.eye(6), got.shape)
    assert np.abs(got @ blocks.numpy() - eye).max() < 1e-12


def test_invert_clover_raises_on_blocks_not_positive_definite(gauge128):
    blocks = tcl.clover_blocks(_t(gauge128), COEFF)
    blocks[0, 1, 2, 3, 1] *= -1.0            # one negative-definite block
    with pytest.raises(tcl.CloverNotPositiveDefinite,
                       match="1 of 512 clover") as err:
        tcl.invert_clover(blocks)
    assert err.value.bad_blocks == 1


class _JaxView:
    """What the JAX package's DiracCloverPCPairs reads of a DiracCloverPC,
    taken from the port's complex128 operator (its clover term is held to
    JAX's above): the pair operators below then compare the hop and the
    Schur composition on the same blocks, and the JAX side skips its
    eager full-lattice construction."""

    def __init__(self, td):
        self.geom = JGeom(td.geom.dims)
        self.kappa, self.matpc = td.kappa, td.matpc
        self.antiperiodic_t = td.antiperiodic_t
        self.gauge_eo = tuple(jnp.asarray(g.numpy()) for g in td.gauge_eo)
        self.clover = tuple(jnp.asarray(b.numpy()) for b in td.clover)
        self.clover_inv_q = jnp.asarray(td.clover_inv_q.numpy())


@pytest.fixture(scope="module")
def clover_ops():
    """(JAX staged-XLA f32 pair operator, {port f32 full, port f32 r12},
    port complex128 DiracCloverPC) per matpc, on one 4x6x8x10 SU(3) gauge
    (recon-12 needs SU(3) links)."""
    g = _t(su3_gauge(ASYM, seed=94, dtype=np.complex128))
    ops = {}
    for matpc in (0, 1):
        td = tmcl.DiracCloverPC(g, LatticeGeometry(ASYM), KAPPA, CSW,
                                matpc=matpc)
        ops[matpc] = (jmcl.DiracCloverPCPairs(_JaxView(td), jnp.float32,
                                              form="xla"),
                      {f: td.pairs(torch.float32, precision_form=f)
                       for f in ("full", "r12")}, td)
    return ops


def test_pack_and_apply_clover_pairs_match_jax(clover_ops):
    """Packing is exact; the block mat-vec sums its six terms in another
    order than XLA's einsum, so it is held to 1e-6 relative."""
    jop, tops, td = clover_ops[0]
    top = tops["full"]
    np.testing.assert_array_equal(top.clover_inv_q_pp.numpy(),
                                  np.asarray(jop.clover_inv_q_pp))
    np.testing.assert_array_equal(top.clover_p_pp.numpy(),
                                  np.asarray(jop.clover_p_pp))
    x = gaussian(pair_spinor_shape(ASYM), seed=93, dtype=np.float32)
    got = tmcl.apply_clover_pairs(top.clover_inv_q_pp, _t(x))
    want = np.asarray(jmcl.apply_clover_pairs(jop.clover_inv_q_pp,
                                              jnp.asarray(x)))
    assert rel_err(got.numpy(), want) < 1e-6
    # against the complex blocks on the canonical layout
    half = LatticeGeometry(ASYM).half_lattice_shape
    xc = twpk.unpack_spinor(twpk.from_packed_pairs(_t(x), torch.complex128),
                            half)
    ref = tcl.apply_clover(td.clover_inv_q, xc)
    assert rel_err(twpk.unpack_spinor(twpk.from_packed_pairs(got), half)
                   .numpy(), ref.numpy()) < 1e-6


# -- the clover Schur operator on pairs (float32, 4x6x8x10) -----------------

@pytest.fixture(scope="module")
def jax_staged(clover_ops):
    """The JAX package's staged XLA composition per matpc, on one f32
    input x: t = A_q^-1 D_{q<-p} x (K1's function), out = A_p x -
    kappa^2 D_{p<-q} t (K2's; with the f32 cast it is JAX's M_pairs in
    its xla form) and Mdag_pairs(out).  Computed once: JAX compiles each
    eager op on first use."""
    refs = {}
    for p, (jop, _, _) in clover_ops.items():
        x = gaussian(pair_spinor_shape(ASYM), seed=95 + p, dtype=np.float32)
        xj = jnp.asarray(x)
        tj = jop._Ainv_q_sign_pairs(jop._d_to(xj, 1 - p, jnp.float32), +1,
                                    jnp.float32)
        outj = (jop._diag_sign_pairs(xj, +1, jnp.float32)
                - KAPPA ** 2 * jop._d_to(tj, p, jnp.float32))
        refs[p] = (x, np.asarray(tj), np.asarray(outj),
                   np.asarray(jop.Mdag_pairs(outj)))
    return refs


@pytest.mark.parametrize("form", ["full", "r12"])
@pytest.mark.parametrize("matpc", [0, 1])
def test_plain_fused_hops_match_jax_staged(clover_ops, jax_staged, matpc,
                                           form):
    """K1 (target parity 1-matpc) and K2 (target matpc) on CPU tensors
    run their plain versions: held to the JAX package's staged XLA
    composition hop -> A_q^-1 and A_p x - kappa^2 hop, 1e-6 relative."""
    top = clover_ops[matpc][1][form]
    x, tj, outj, _ = jax_staged[matpc]
    p, xt = matpc, _t(x)
    n1 = (clp.dslash_eo_pallas_post.launches,
          clp.dslash_eo_pallas_diag_hop.launches)
    t = clp.dslash_eo_pallas_post(
        top.gauge_eo_pp[1 - p], top._u_bw[1 - p], xt, top.dims, 1 - p,
        blk_pl=top.clover_inv_q_pp, tb_sign=top._tb_sign)
    out = clp.dslash_eo_pallas_diag_hop(
        top.gauge_eo_pp[p], top._u_bw[p], t, xt, top.dims, p,
        hop_coeff=-KAPPA ** 2, blk_pl=top.clover_p_pp,
        out_dtype=torch.float32, tb_sign=top._tb_sign)
    assert (clp.dslash_eo_pallas_post.launches,
            clp.dslash_eo_pallas_diag_hop.launches) == n1
    assert t.dtype == out.dtype == torch.float32
    assert rel_err(t.numpy(), tj) < 1e-6
    assert rel_err(out.numpy(), outj) < 1e-6


@pytest.mark.parametrize("matpc", [0, 1])
def test_clover_pair_operator_matches_jax(clover_ops, jax_staged, matpc):
    """M_pairs, Mdag_pairs and MdagM_pairs of the f32 full-link operator
    against JAX's (``jax_staged``: its M in the xla form, and Mdag of
    that), 1e-6 relative; and the port's gamma5-hermiticity."""
    top = clover_ops[matpc][1]["full"]
    x, _, mj, mdag_mj = jax_staged[matpc]
    xt = _t(x)
    m = top.M_pairs(xt)
    assert rel_err(m.numpy(), mj) < 1e-6
    assert rel_err(top.Mdag_pairs(m).numpy(), mdag_mj) < 1e-6
    assert rel_err(top.MdagM_pairs(xt).numpy(), mdag_mj) < 1e-6
    # gamma5-hermiticity: <y, M x> = <Mdag y, x>
    y = _t(gaussian(pair_spinor_shape(ASYM), seed=98, dtype=np.float32))
    lhs = float(torch.sum(y.double() * m.double()))
    rhs = float(torch.sum(top.Mdag_pairs(y).double() * xt.double()))
    assert abs(lhs - rhs) < 1e-5 * abs(lhs)
def test_clover_pair_operator_is_the_complex_schur_complement():
    """Port-only: the f32 pair operator, prepare and reconstruct against
    the complex128 DiracCloverPC (M_pc x_p = prepare(M x)) and the full
    DiracClover, on 4^4."""
    geom = LatticeGeometry(HYPERCUBE)
    g = _t(su3_gauge(HYPERCUBE, seed=99, dtype=np.complex128))
    d = tmcl.DiracClover(g, geom, KAPPA, CSW)
    dpc = tmcl.DiracCloverPC(g, geom, KAPPA, CSW)
    x = _t(gaussian(geom.spinor_shape(), seed=100, dtype=np.complex128))
    be, bo = even_odd_split(d.M(x), geom)
    xe, xo = even_odd_split(x, geom)
    assert rel_err(dpc.M(xe).numpy(), dpc.prepare(be, bo).numpy()) < 1e-12
    assert rel_err(dpc.reconstruct(xe, be, bo)[1].numpy(),
                   xo.numpy()) < 1e-12
    op = tmcl.DiracCloverPC(g.to(torch.complex64), geom, KAPPA,
                            CSW).pairs(torch.float32)
    be64, bo64 = (v.to(torch.complex64) for v in (be, bo))
    xe_pp = op._to_pairs(xe.to(torch.complex64))
    assert rel_err(op.M_pairs(xe_pp).numpy(),
                   op.prepare_pairs(be64, bo64).numpy()) < 1e-5
    rec = op.reconstruct_pairs(xe_pp, be64, bo64)
    assert rel_err(rec[1].numpy(), xo.numpy()) < 1e-5


def test_bf16_operator_matches_its_rounding_points():
    """Port-only: the bf16 M_pairs equals the f32 arithmetic on the same
    bf16 numbers, rounded to bf16 where the fused hop rounds (K1's hop
    and out, K2's out), bit for bit."""
    g = _t(su3_gauge(ASYM, seed=101))
    dpc = tmcl.DiracCloverPC(g, LatticeGeometry(ASYM), KAPPA, CSW)
    lo = dpc.pairs(torch.bfloat16)
    x = _t(gaussian(pair_spinor_shape(ASYM), seed=102,
                    dtype=np.float32)).to(torch.bfloat16)
    bf, f32 = torch.bfloat16, torch.float32
    p = dpc.matpc

    def hop(v, target):
        return twpk.dslash_eo_packed_pairs_bw(
            lo.gauge_eo_pp[target].float(), lo._u_bw[target].float(),
            v.float(), lo.dims, target, f32)

    t = tmcl.apply_clover_pairs(lo.clover_inv_q_pp.float(),
                                hop(x, 1 - p).to(bf).float(), f32).to(bf)
    want = (tmcl.apply_clover_pairs(lo.clover_p_pp.float(), x.float(), f32)
            - KAPPA ** 2 * hop(t, p)).to(bf)
    got = lo.M_pairs(x)
    assert got.dtype == bf
    assert torch.equal(got, want)
    # and within bf16 rounding of the f32 operator on the same input
    hi = dpc.pairs(torch.float32)
    assert rel_err(got.float().numpy(),
                   hi.M_pairs(x.float()).numpy()) < 2 ** -6


# -- invert_quda ----------------------------------------------------------

def _port_solve(g, b, dims=HYPERCUBE, reconstruct=18, **kw):
    qt.init_quda(device="cpu")
    try:
        qt.load_gauge_quda(g, qt.GaugeParam(X=dims, cuda_prec="single",
                                            reconstruct=reconstruct))
        base = dict(dslash_type="clover", inv_type="cg",
                    solve_type="normop-pc", kappa=KAPPA, csw=CSW, tol=TOL,
                    maxiter=500, cuda_prec="single")
        base.update(kw)
        p = qt.InvertParam(**base)
        x = qt.invert_quda(b, p)
    finally:
        qt.end_quda()
    return x.numpy(), p


@pytest.fixture(scope="module")
def clover_system():
    """A 4^4 SU(3) gauge, a source, and the complex128 solution of the
    clover system: CG on the normal equations of the complex
    DiracCloverPC to 1e-12, then reconstruct."""
    g = su3_gauge(HYPERCUBE, seed=103)
    b = gaussian(lattice_shape(HYPERCUBE) + (4, 3), seed=104)
    geom = LatticeGeometry(HYPERCUBE)
    dpc = tmcl.DiracCloverPC(_t(g).to(torch.complex128), geom, KAPPA, CSW)
    be, bo = even_odd_split(_t(b).to(torch.complex128), geom)
    rhs = apply_gamma5(dpc.M(apply_gamma5(dpc.prepare(be, bo))))
    res = cg(lambda v: apply_gamma5(dpc.M(apply_gamma5(dpc.M(v)))), rhs,
             tol=1e-12, maxiter=1000)
    assert res.converged
    return g, b, even_odd_join(*dpc.reconstruct(res.x, be, bo),
                               geom).numpy()


@pytest.mark.parametrize("sloppy,reconstruct", [
    ("single", 18), ("half", 18), ("half", 12)],
    ids=["single", "half", "half-r12"])
def test_invert_quda_clover_matches_oracle(clover_system, sloppy,
                                          reconstruct):
    """The clover routes on CPU tensors (plain versions of every kernel):
    converged, true_res <= 10 tol, the solution within 1e-4 of a
    complex128 solve; half takes reliable updates."""
    g, b, want = clover_system
    x, p = _port_solve(g, b, reconstruct=reconstruct,
                       cuda_prec_sloppy=sloppy)
    assert x.shape == b.shape and x.dtype == np.complex64
    assert p.converged and p.true_res <= 10 * TOL
    assert (p.reliable_updates >= 1) == (sloppy == "half")
    assert np.linalg.norm(x - want) / np.linalg.norm(want) < 1e-4
    vol = int(np.prod(HYPERCUBE))
    assert p.gflops == pytest.approx(
        p.iter_count * 2 * (2 * 1320 + 2 * 504 + 48) * (vol // 2) / 1e9)


def test_csw_zero_clover_route_equals_wilson_route():
    """csw 0: the clover term is the identity, and the clover route
    (K1/K2) solves the Wilson system in the Wilson route's iterations."""
    g = su3_gauge(HYPERCUBE, seed=105)
    b = gaussian(lattice_shape(HYPERCUBE) + (4, 3), seed=106)
    xc, pc = _port_solve(g, b, csw=0.0)
    xw, pw = _port_solve(g, b, dslash_type="wilson")
    assert pc.iter_count == pw.iter_count
    assert np.linalg.norm(xc - xw) / np.linalg.norm(xw) < 1e-6


def test_clover_below_df64_gate_takes_the_f32_route():
    """The df64 gate is Wilson-only (as in the JAX package): a clover
    solve at tol 1e-10 runs the f32 route and publishes no low word."""
    g = su3_gauge(HYPERCUBE, seed=107)
    b = gaussian(lattice_shape(HYPERCUBE) + (4, 3), seed=108)
    _, p = _port_solve(g, b, tol=1e-10, maxiter=10)
    assert p.x_df64_lo is None and p.iter_count > 0
    assert p.true_res > 1e-10       # f32 cannot certify 1e-10


# -- slow: the JAX Pallas kernel in interpret mode, whole JAX solves --------

@pytest.mark.slow
@pytest.mark.parametrize("store", ["f32", "bf16"])
def test_plain_fused_hops_match_jax_pallas_kernel(clover_ops, store):
    """The JAX package's fused kernels (interpret mode) against the port's
    plain K1/K2 on the same operands: f32 within 1e-6; bf16 storage
    within one bf16 ulp of max |out| (K1 rounds twice)."""
    jop, tops, _ = clover_ops[0]
    top = tops["full"]
    dt_t = torch.float32 if store == "f32" else torch.bfloat16
    dt_j = jnp.float32 if store == "f32" else jnp.bfloat16
    p = 0
    x = gaussian(pair_spinor_shape(ASYM), seed=109, dtype=np.float32)
    xt = _t(x).to(dt_t)
    xj = jnp.asarray(xt.float().numpy()).astype(dt_j)

    def both(t):
        return t.to(dt_t).contiguous(), jnp.asarray(
            t.to(dt_t).float().numpy()).astype(dt_j)

    (uq, uqj), (bq, bqj), (up, upj), (bp, bpj) = (
        both(top.gauge_eo_pp[1 - p]), both(top._u_bw[1 - p]),
        both(top.gauge_eo_pp[p]), both(top._u_bw[p]))
    (kq, kqj), (kp, kpj) = both(top.clover_inv_q_pp), both(top.clover_p_pp)
    dims = tuple(top.dims)
    tj = jclp.dslash_eo_pallas_post(uqj, bqj, xj, dims, 1 - p, blk_pl=kqj,
                                    interpret=True, out_dtype=dt_j)
    t = clp.dslash_eo_pallas_post(uq, bq, xt, dims, 1 - p, blk_pl=kq,
                                  out_dtype=dt_t)
    tol = 1e-6 if store == "f32" else 2.0 ** -7
    assert rel_err(t.float().numpy(),
                   np.asarray(tj.astype(jnp.float32))) <= tol
    outj = jclp.dslash_eo_pallas_diag_hop(
        upj, bpj, tj, xj, dims, p, hop_coeff=-KAPPA ** 2, blk_pl=kpj,
        interpret=True, out_dtype=jnp.float32)
    out = clp.dslash_eo_pallas_diag_hop(
        up, bp, _t(np.asarray(tj.astype(jnp.float32))).to(dt_t), xt, dims,
        p, hop_coeff=-KAPPA ** 2, blk_pl=kp, out_dtype=torch.float32)
    assert rel_err(out.numpy(), np.asarray(outj)) < 1e-6


@pytest.mark.slow
@pytest.mark.parametrize("sloppy", ["single", "half"])
def test_invert_quda_clover_matches_jax(clover_system, sloppy,
                                       monkeypatch):
    """Both packages solve the same clover system on 4^4.  JAX takes its
    pair route (QUDA_TPU_PACKED=1), so single/half is bf16 sloppy with
    reliable updates on both sides: iterations within 2 (single) or 10%
    (half), solutions within 1e-4."""
    monkeypatch.setenv("QUDA_TPU_PACKED", "1")
    g, b, _ = clover_system
    japi.init_quda()
    try:
        japi.load_gauge_quda(g, JGaugeParam(X=HYPERCUBE,
                                            cuda_prec="single"))
        jp = JInvertParam(dslash_type="clover", inv_type="cg",
                          solve_type="normop-pc", kappa=KAPPA, csw=CSW,
                          tol=TOL, maxiter=500, cuda_prec="single",
                          cuda_prec_sloppy=sloppy)
        xj = np.asarray(japi.invert_quda(b, jp))
    finally:
        japi.end_quda()
    x, p = _port_solve(g, b, cuda_prec_sloppy=sloppy)
    assert p.converged and jp.converged
    assert p.true_res <= 10 * TOL and jp.true_res <= 10 * TOL
    di = abs(p.iter_count - jp.iter_count)
    assert di <= (2 if sloppy == "single" else 0.1 * jp.iter_count + 1)
    assert np.linalg.norm(x - xj) / np.linalg.norm(xj) < 1e-4
