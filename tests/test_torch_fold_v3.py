"""Port parity: the fold layout (Wilson and staggered) and the staggered
copy-free v3 pass.

quda_tpu_torch against quda_tpu on the same numpy inputs (seeds 381-399):
``to_fold``/``from_fold`` bit for bit; the plain fold hop (B1's plain
version through the fold) against the JAX package's XLA pair stencil
``dslash_eo_packed_pairs`` (4^4, both parities); the plain staggered
fused-fold and v3 hops against ``dslash_staggered_eo_packed_pairs`` and
``tests/host_reference/staggered_ref.py`` at 8x10x12x14 (every extent
>= 7: a Naik 3-hop aliases no shorter hop); the fold and v3 pair
operators and their solves against the full forms; the staggered
downgrade and refusal rules.

Tolerances: the layout maps bit for bit; float32 hops within 1e-6 of JAX's
stencil and of the oracle (the same terms summed in another order),
bfloat16 outputs within one bf16 ulp of max |out| (2^-7, JAX's own bf16
bound); each fold or v3 form bit for bit its twin (B1, S1, S2 and their
operators), whose sums run in the same order.  The JAX package's own fold
and v3 kernels differ from its unfolded ones by one ulp of summation
order (ROADMAP C), so the port is held to them at f32 tolerance only: the
``slow`` tests run those Pallas kernels in interpret mode.  The CUDA
kernels meet their plain versions and twins on the card in
test_torch_cuda.py.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quda_tpu.ops import staggered_packed as jspk
from quda_tpu.ops import staggered_pallas as jspl
from quda_tpu.ops import wilson_packed as jwpk
from quda_tpu.ops import wilson_pallas_packed as jwpp
from quda_tpu_torch.fields.geometry import LatticeGeometry
from quda_tpu_torch.fields.spinor import even_odd_split
from quda_tpu_torch.models import staggered as mstag
from quda_tpu_torch.models.clover import DiracCloverPC
from quda_tpu_torch.models.wilson import DiracWilsonPC
from quda_tpu_torch.ops import staggered_pallas as spl
from quda_tpu_torch.ops import wilson_pallas_packed as wpp
from quda_tpu_torch.solvers.fused_iter import fused_cg
from quda_tpu_torch.solvers.mixed import cg_reliable, pair_inplace_codec

from tests.host_reference.staggered_ref import staggered_dslash_ref
from tests.torch_inputs import (gaussian, lattice_shape, pair_spinor_shape,
                                rel_err, su3_gauge)
from tests.torch_inputs import one_torch_thread  # noqa: F401 (autouse)

HYPERCUBE = (4, 4, 4, 4)
CUBE8 = (8, 8, 8, 8)
WIDE = (8, 10, 12, 14)           # (X, Y, Z, T): every extent >= 7
KAPPA = 0.12
MASS = 0.1
TOL = 1e-6
F32, BF16 = torch.float32, torch.bfloat16
BF16_TOL = 2.0 ** -7


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _sites(dims):
    T, Z, Y, X = lattice_shape(dims)
    return (T, Z, Y * X // 2)


def _fold_both(a):
    """(port, JAX) to_fold of one numpy array."""
    return wpp.to_fold(_t(a)).numpy(), np.asarray(jwpp.to_fold(
        jnp.asarray(a)))


# -- the layout --------------------------------------------------------------

def test_fold_layout_matches_jax_bit_for_bit():
    """to_fold and from_fold on a spinor, R = 3 and R = 2 links, a batch of
    spinors and a staggered field equal the JAX package's bit for bit, and
    from_fold inverts to_fold."""
    rng = np.random.default_rng(381)
    s = _sites(HYPERCUBE)
    for shape in ((4, 3, 2) + s, (4, 3, 3, 2) + s, (4, 2, 3, 2) + s,
                  (3, 4, 3, 2) + s, (3, 2) + s):
        a = rng.standard_normal(shape).astype(np.float32)
        got, want = _fold_both(a)
        np.testing.assert_array_equal(got, want)
        assert got.shape == shape[:-4] + (s[0], 2 * s[1], s[2])
        back = wpp.from_fold(_t(want))
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(jwpp.from_fold(jnp.asarray(want))))
        np.testing.assert_array_equal(back.numpy(), a)
    with pytest.raises(ValueError, match="pair axis"):
        wpp.to_fold(torch.zeros((4, 3, 3) + s))


# -- the Wilson fold hop ------------------------------------------------------

@pytest.fixture(scope="module")
def wilson_case():
    """f32 pair links of both parities and psi at 4^4, with the JAX XLA
    stencil's outputs (f32 and bf16 storage, both parities)."""
    rng = np.random.default_rng(382)
    s = _sites(HYPERCUBE)
    u = tuple(rng.standard_normal((4, 3, 3, 2) + s).astype(np.float32)
              for _ in range(2))
    psi = rng.standard_normal((4, 3, 2) + s).astype(np.float32)
    dims = lattice_shape(HYPERCUBE)
    jax_out = {}
    for store, jdt in ((F32, jnp.float32), (BF16, jnp.bfloat16)):
        for p in (0, 1):
            out = jwpk.dslash_eo_packed_pairs(
                tuple(jnp.asarray(g).astype(jdt) for g in u),
                jnp.asarray(psi).astype(jdt), dims, p)
            jax_out[(store, p)] = np.asarray(out.astype(jnp.float32))
    return dims, u, psi, jax_out


@pytest.mark.parametrize("store", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("parity", [0, 1])
def test_plain_fold_hop_matches_jax_xla_stencil(wilson_case, parity, store):
    """The fold hop (its plain version) on to_fold of the operands,
    unfolded, against JAX's XLA pair stencil on the unfolded ones: f32
    within 1e-6, bf16 storage and output within one bf16 ulp; and bit for
    bit B1's plain version."""
    dims, u, psi, jax_out = wilson_case
    uh = _t(u[parity]).to(store)
    ubw = wpp.backward_gauge_eo(_t(u[1 - parity]).to(store), dims, parity)
    ps = _t(psi).to(store)
    got = wpp.dslash_eo_pallas_packed_fold(
        wpp.to_fold(uh), wpp.to_fold(ubw), wpp.to_fold(ps), dims, parity)
    assert got.dtype == store
    got = wpp.from_fold(got)
    tol = 1e-6 if store == F32 else BF16_TOL
    assert rel_err(got.float().numpy(), jax_out[(store, parity)]) < tol
    assert torch.equal(got, wpp.dslash_eo_pallas_packed(uh, ubw, ps, dims,
                                                        parity))


@pytest.mark.parametrize("rows", [3, 2], ids=["full", "r12"])
def test_plain_fold_mrhs_is_the_fold_hop_lane_by_lane(rows):
    """The multi-RHS fold hop's plain version on a batch of 3 equals the
    fold hop lane by lane, bit for bit (R = 3 and 2, both parities, both
    t boundary signs), and the fold hop equals B1 on the unfolded
    operands."""
    rng = np.random.default_rng(383)
    s = _sites(HYPERCUBE)
    dims = lattice_shape(HYPERCUBE)
    uh, ubw = (_t(rng.standard_normal((4, rows, 3, 2) + s)
                  .astype(np.float32)) for _ in range(2))
    psi = _t(rng.standard_normal((3, 4, 3, 2) + s).astype(np.float32))
    fh, fb, fp = (wpp.to_fold(t) for t in (uh, ubw, psi))
    for parity in (0, 1):
        for tb in (True, False):
            got = wpp.dslash_eo_pallas_packed_fold_mrhs(fh, fb, fp, dims,
                                                        parity, tb_sign=tb)
            for r in range(3):
                lane = wpp.dslash_eo_pallas_packed_fold(
                    fh, fb, fp[r], dims, parity, tb_sign=tb)
                assert torch.equal(got[r], lane)
                assert torch.equal(lane, wpp.to_fold(
                    wpp.dslash_eo_pallas_packed(uh, ubw, psi[r], dims,
                                                parity, tb_sign=tb)))


# -- the staggered fused-fold and v3 hops -------------------------------------

@pytest.fixture(scope="module")
def stag_case():
    """f32 fat (unit size) and long (1/24) pair links of both parities and
    psi at 8x10x12x14, with the JAX XLA stencil's improved outputs."""
    rng = np.random.default_rng(384)
    s = _sites(WIDE)
    fat = tuple(rng.standard_normal((4, 3, 3, 2) + s).astype(np.float32)
                for _ in range(2))
    lng = tuple((rng.standard_normal((4, 3, 3, 2) + s) / 24)
                .astype(np.float32) for _ in range(2))
    psi = rng.standard_normal((3, 2) + s).astype(np.float32)
    dims = lattice_shape(WIDE)
    jax_out = {p: np.asarray(jspk.dslash_staggered_eo_packed_pairs(
        tuple(map(jnp.asarray, fat)), jnp.asarray(psi), dims, p,
        tuple(map(jnp.asarray, lng)), out_dtype=jnp.float32))
        for p in (0, 1)}
    return dims, fat, lng, psi, jax_out


@pytest.mark.parametrize("parity", [0, 1])
def test_plain_stag_fold_and_v3_match_jax_xla_stencil(stag_case, parity):
    """The plain S1-fold (unfolded) and the improved v3 hop against JAX's
    XLA pair stencil, 1e-6; each bit for bit S1's plain version; the v3
    passes bit for bit S2's on the backward_links_eo copies."""
    dims, fat, lng, psi, jax_out = stag_case
    q = 1 - parity
    f, lg, ps = tuple(map(_t, fat)), tuple(map(_t, lng)), _t(psi)
    s1 = spl.dslash_staggered_eo_pallas_fused(f[parity], f[q], ps, dims,
                                              parity, lg[parity], lg[q])
    fold = wpp.from_fold(spl.dslash_staggered_eo_pallas_fused_fold(
        wpp.to_fold(f[parity]), wpp.to_fold(f[q]), wpp.to_fold(ps), dims,
        parity, wpp.to_fold(lg[parity]), wpp.to_fold(lg[q])))
    v3 = spl.dslash_staggered_eo_pallas_v3(f[parity], f[q], ps, dims,
                                           parity, lg[parity], lg[q])
    for got in (fold, v3):
        assert rel_err(got.numpy(), jax_out[parity]) < 1e-6
        assert torch.equal(got, s1)
    for here, there, nhop in ((f[parity], f[q], 1), (lg[parity], lg[q], 3)):
        bw = spl.backward_links_eo(there, dims, parity, nhop)
        assert torch.equal(
            spl.dslash_staggered_eo_pass_v3(here, there, ps, dims, parity,
                                            nhop),
            spl.dslash_staggered_eo_pass(here, bw, ps, dims, parity, nhop))


@pytest.fixture(scope="module")
def stag_pc():
    """The complex staggered PC operator on SU(3) fat links and 1/24-size
    long links at 8^4 (phases folded in; the site-loop oracle costs a
    third of its 8x10x12x14 time), and the raw links."""
    geom = LatticeGeometry(CUBE8)
    fat = su3_gauge(CUBE8, 385, dtype=np.complex128)
    lng = su3_gauge(CUBE8, 386, dtype=np.complex128) / 24
    return mstag.DiracStaggeredPC(_t(fat), geom, MASS, True, _t(lng)), \
        fat, lng


def test_stag_fold_and_v3_operators_match_host_reference(stag_pc):
    """D_to_pairs of the fold and v3 pair operators (f32) against the
    numpy site-loop oracle's full-lattice D (fat + Naik) restricted to
    each parity, 1e-6."""
    dpc, fat, lng = stag_pc
    geom = dpc.geom
    psi = gaussian(lattice_shape(CUBE8) + (1, 3), 387, dtype=np.complex128)
    pe, po = even_odd_split(_t(psi), geom)
    we, wo = even_odd_split(_t(staggered_dslash_ref(fat, psi, lng)), geom)
    for kw in ({"precision_form": "fold"}, {"form": "v3"}):
        op = dpc.pairs(F32, **kw)
        for p, src, want in ((0, po, we), (1, pe, wo)):
            got = op._from_pairs(op.D_to_pairs(op._to_pairs(src), p, F32),
                                 torch.complex128)
            assert rel_err(got.numpy(), want.numpy()) < 1e-6


# -- the pair operators and their solves --------------------------------------

@pytest.fixture(scope="module")
def wilson_ops():
    g = su3_gauge(HYPERCUBE, 388)
    geom = LatticeGeometry(HYPERCUBE)
    dpk = DiracWilsonPC(_t(g), geom, KAPPA).packed()
    b = _t(gaussian(lattice_shape(HYPERCUBE) + (4, 3), 389))
    return dpk, even_odd_split(b, geom)


@pytest.mark.parametrize("store", [F32, BF16], ids=["f32", "bf16"])
def test_wilson_fold_operator_equals_full(wilson_ops, store):
    """The fold operator keeps folded links and a folded backward copy,
    and its M_pairs, Mdag_pairs, prepare and reconstruct equal the full
    operator's bit for bit; its batched forms (the multi-RHS fold hop)
    equal the full operator's lane by lane; pallas_version 3 stays
    fold."""
    dpk, (be, bo) = wilson_ops
    fold, full = dpk.pairs(store, "fold"), dpk.pairs(store, "full")
    T, Z, YXh = _sites(HYPERCUBE)
    assert fold.gauge_eo_pp[0].shape == (4, 3, 3, T, 2 * Z, YXh)
    assert fold._u_bw[1].shape == (4, 3, 3, T, 2 * Z, YXh)
    assert dpk.pairs(store, "fold", pallas_version=3)._u_bw is not None
    x = _t(gaussian(pair_spinor_shape(HYPERCUBE), 390,
                    dtype=np.float32)).to(store)
    for name in ("M_pairs", "Mdag_pairs", "MdagM_pairs"):
        assert torch.equal(getattr(fold, name)(x), getattr(full, name)(x))
    assert torch.equal(fold.prepare_pairs(be, bo), full.prepare_pairs(be, bo))
    for a, b in zip(fold.reconstruct_pairs(x, be, bo),
                    full.reconstruct_pairs(x, be, bo)):
        assert torch.equal(a, b)
    if store == F32:
        xb = torch.stack([x, 2 * x, -x])
        assert torch.equal(fold.MdagM_pairs_mrhs(xb),
                           full.MdagM_pairs_mrhs(xb))


def test_wilson_fold_solves_take_full_iterations(wilson_ops):
    """fused_cg on the f32 fold operator and cg_reliable with a bf16 fold
    sloppy operator: the full forms' iterations, reliable updates and
    solution bits."""
    dpk, (be, bo) = wilson_ops
    res = {}
    for form in ("full", "fold"):
        hi, lo = dpk.pairs(F32, form), dpk.pairs(BF16, form)
        rhs = hi.Mdag_pairs(hi.prepare_pairs(be, bo))
        res[form] = (fused_cg(hi.MdagM_pairs, rhs, tol=TOL, maxiter=500),
                     cg_reliable(hi.MdagM_pairs, lo.MdagM_pairs, rhs,
                                 pair_inplace_codec(BF16), tol=TOL,
                                 maxiter=500))
    for a, b in zip(res["fold"], res["full"]):
        assert a.converged and a.iters == b.iters
        assert torch.equal(a.x, b.x)
    assert res["fold"][1].reliable_updates == res["full"][1].reliable_updates


@pytest.mark.parametrize("store", [F32, BF16], ids=["f32", "bf16"])
def test_stag_fold_and_v3_operators_equal_their_twins(stag_pc, store):
    """The staggered fold operator (folded links) and the v3 operator (no
    backward copy) give the fused operator's M_pairs bit for bit, and
    prepare / reconstruct alike; fat-only v3 gives the two_pass one's."""
    dpc, fat, _ = stag_pc
    fused = dpc.pairs(store)
    fold = dpc.pairs(store, precision_form="fold")
    v3 = dpc.pairs(store, form="v3")
    T, Z, YXh = _sites(CUBE8)
    assert fold.form == "fused" and fold._precision_form == "fold"
    assert fold.long_eo_pp[1].shape == (4, 3, 3, T, 2 * Z, YXh)
    assert v3._fat_bw is None and v3._long_bw is None
    x = _t(gaussian((3, 2) + _sites(CUBE8), 391, dtype=np.float32)).to(store)
    b = _t(gaussian(lattice_shape(CUBE8) + (1, 3), 392))
    be, bo = even_odd_split(b, dpc.geom)
    for op in (fold, v3):
        assert torch.equal(op.M_pairs(x), fused.M_pairs(x))
        assert torch.equal(op.prepare_pairs(be, bo),
                           fused.prepare_pairs(be, bo))
        for a, c in zip(op.reconstruct_pairs(x, be, bo),
                        fused.reconstruct_pairs(x, be, bo)):
            assert torch.equal(a, c)
    fat_only = mstag.DiracStaggeredPC(_t(fat), dpc.geom, MASS)
    fv3 = fat_only.pairs(store, form="v3")
    assert fv3._fat_bw is None
    assert torch.equal(fv3.M_pairs(x), fat_only.pairs(store).M_pairs(x))


def test_stag_fold_and_v3_solves_take_their_twins_iterations():
    """fused_cg at 8x10x12x14 and m 0.5 (few iterations on a CPU) on the
    improved operator's fold and v3 forms and on fat-only v3: the fused
    (fat-only: two_pass) form's iterations and solution bits."""
    geom = LatticeGeometry(WIDE)
    fat = _t(su3_gauge(WIDE, 399, dtype=np.complex128))
    lng = fat.roll(1, 1) / 24
    b = _t(gaussian(lattice_shape(WIDE) + (1, 3), 393))
    be, bo = even_odd_split(b, geom)

    def solve(d, **kw):
        op = d.pairs(F32, **kw)
        return fused_cg(op.M_pairs, op.prepare_pairs(be, bo), tol=TOL,
                        maxiter=500)

    for d, kws in ((mstag.DiracStaggeredPC(fat, geom, 0.5, True, lng),
                    ({"precision_form": "fold"}, {"form": "v3"})),
                   (mstag.DiracStaggeredPC(fat, geom, 0.5),
                    ({"form": "v3"},))):
        twin = solve(d)
        assert twin.converged
        for kw in kws:
            got = solve(d, **kw)
            assert got.iters == twin.iters
            assert torch.equal(got.x, twin.x)


# -- what is served, downgraded and refused -----------------------------------

def test_staggered_fold_downgrades_and_refusals(stag_pc, caplog):
    """fold runs on the fused form only: on two_pass, on v3 and on a
    fat-only operator it becomes full with a notice, as the JAX package's
    downgrade; the Wilson-only forms become full too; r12 stays refused
    naming C, auto naming A17; an unknown form raises."""
    dpc, fat, _ = stag_pc
    fat_only = mstag.DiracStaggeredPC(_t(fat), dpc.geom, MASS)
    with caplog.at_level(logging.INFO, logger="quda_tpu_torch"):
        for d, kw in ((dpc, {"form": "two_pass"}), (dpc, {"form": "v3"}),
                      (fat_only, {})):
            caplog.clear()
            op = d.pairs(F32, precision_form="fold", **kw)
            assert op._precision_form == "full"
            assert op.fat_eo_pp[0].shape[3] == 2
            assert "fold" in caplog.text
        for form in mstag.WILSON_ONLY_FORMS:
            caplog.clear()
            assert dpc.pairs(F32, precision_form=form)._precision_form == \
                "full"
            assert form in caplog.text
    with pytest.raises(NotImplementedError, match="ROADMAP C"):
        dpc.pairs(F32, precision_form="r12")
    with pytest.raises(NotImplementedError, match="ROADMAP A17"):
        dpc.pairs(F32, precision_form="auto")
    with pytest.raises(ValueError, match="unknown"):
        dpc.pairs(F32, precision_form="r13")
    with pytest.raises(NotImplementedError, match="two_pass"):
        dpc.pairs(F32, form="v3")._d_to_mrhs(
            torch.zeros((2, 3, 2) + _sites(CUBE8)), 0)
    with pytest.raises(ValueError, match="Naik"):
        spl.dslash_staggered_eo_pallas_fused_fold(
            *([torch.zeros((4, 3, 3, 4, 4, 4))] * 2),
            torch.zeros((3, 4, 4, 4)), (4, 2, 2, 4), 0)


def test_wilson_fold_refusals(wilson_ops):
    """fold in float64 and on the clover operator waits for ROADMAP A7."""
    dpk, _ = wilson_ops
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        dpk.pairs(torch.float64, "fold")
    g = su3_gauge(HYPERCUBE, 394)
    dcl = DiracCloverPC(_t(g), LatticeGeometry(HYPERCUBE), KAPPA, 1.0)
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        dcl.pairs(F32, precision_form="fold")


# -- the JAX package's Pallas kernels, interpret mode (slow) ------------------

@pytest.mark.slow
@pytest.mark.parametrize("parity", [0, 1])
def test_plain_fold_hops_match_jax_pallas_interpret(parity):
    """The plain fold hop (R = 3 and 2) and its multi-RHS form against
    JAX's dslash_eo_pallas_packed_fold and _fold_mrhs in interpret mode on
    the same folded operands, 4^4, f32 within 1e-6."""
    rng = np.random.default_rng(395 + parity)
    s = _sites(HYPERCUBE)
    dims = lattice_shape(HYPERCUBE)
    for rows in (3, 2):
        uh, ubw = (rng.standard_normal((4, rows, 3, 2) + s)
                   .astype(np.float32) for _ in range(2))
        psi = rng.standard_normal((2, 4, 3, 2) + s).astype(np.float32)
        jf = [jwpp.to_fold(jnp.asarray(a)) for a in (uh, ubw, psi)]
        tf = [wpp.to_fold(_t(a)) for a in (uh, ubw, psi)]
        want = np.asarray(jwpp.dslash_eo_pallas_packed_fold(
            jf[0], jf[1], jf[2][0], dims, parity, interpret=True))
        got = wpp.dslash_eo_pallas_packed_fold(tf[0], tf[1], tf[2][0], dims,
                                               parity)
        assert rel_err(got.numpy(), want) < 1e-6
        want = np.asarray(jwpp.dslash_eo_pallas_packed_fold_mrhs(
            jf[0], jf[1], jf[2], dims, parity, interpret=True))
        got = wpp.dslash_eo_pallas_packed_fold_mrhs(tf[0], tf[1], tf[2],
                                                    dims, parity)
        assert rel_err(got.numpy(), want) < 1e-6


@pytest.mark.slow
@pytest.mark.parametrize("parity", [0, 1])
def test_plain_stag_fold_and_v3_match_jax_pallas_interpret(parity):
    """The plain S1-fold against JAX's dslash_staggered_eo_pallas_fused_fold
    and the plain v3 hop (fat only and improved) against
    dslash_staggered_eo_pallas_v3, interpret mode, 8^4, f32 within 1e-6."""
    dims4 = (8, 8, 8, 8)
    rng = np.random.default_rng(397 + parity)
    s = _sites(dims4)
    dims = lattice_shape(dims4)
    q = 1 - parity
    fat = [rng.standard_normal((4, 3, 3, 2) + s).astype(np.float32)
           for _ in range(2)]
    lng = [(rng.standard_normal((4, 3, 3, 2) + s) / 24).astype(np.float32)
           for _ in range(2)]
    psi = rng.standard_normal((3, 2) + s).astype(np.float32)
    jfold = [jwpp.to_fold(jnp.asarray(a)) for a in
             (fat[parity], fat[q], psi, lng[parity], lng[q])]
    want = np.asarray(jspl.dslash_staggered_eo_pallas_fused_fold(
        jfold[0], jfold[1], jfold[2], dims, parity, long_here_f=jfold[3],
        long_there_f=jfold[4], interpret=True, out_dtype=jnp.float32))
    tfold = [wpp.to_fold(_t(a)) for a in
             (fat[parity], fat[q], psi, lng[parity], lng[q])]
    got = spl.dslash_staggered_eo_pallas_fused_fold(
        tfold[0], tfold[1], tfold[2], dims, parity, tfold[3], tfold[4])
    assert rel_err(got.numpy(), want) < 1e-6
    for improved in (False, True):
        want = np.asarray(jspl.dslash_staggered_eo_pallas_v3(
            jnp.asarray(fat[parity]), jnp.asarray(fat[q]), jnp.asarray(psi),
            dims, parity,
            long_here_pl=jnp.asarray(lng[parity]) if improved else None,
            long_there_pl=jnp.asarray(lng[q]) if improved else None,
            interpret=True, out_dtype=jnp.float32))
        got = spl.dslash_staggered_eo_pallas_v3(
            _t(fat[parity]), _t(fat[q]), _t(psi), dims, parity,
            _t(lng[parity]) if improved else None,
            _t(lng[q]) if improved else None)
        assert rel_err(got.numpy(), want) < 1e-6
