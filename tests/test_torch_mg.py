"""Port parity: Wilson pair multigrid (mg/), its solvers (solvers/gcr.py,
cg_fixed_iters, batched_bicgstab_pairs), the plain versions of B5
(dslash_packed_mrhs_plain) and B8 (coarse_apply_ref), and the gcr-mg
route of invert_quda.

Numpy seeds 321-342.  Tolerances: the solvers against the JAX package's on
a small dense system within 1e-10 in float64 (the same recurrences, sums
in another order); CholQR2, the transfer and the V-cycle within 1e-6 or
1e-5 relative in float32 (f32 rounding through Cholesky factors, and
through the levels of a V-cycle); the coarse links within 1e-5 of max
|link| (sums of ~10^3 f32 products); B5's plain version lane by lane bit
for bit B4's, and within 1e-6 of JAX's vmapped XLA hop; ``verify`` within
1e-5; the gcr-mg route to true_res < 5e-6 at tol 1e-6.  The JAX
package's random streams cannot be reproduced, so the V-cycle tests share
one hierarchy's arrays (``PairMG.from_arrays``).  Whole JAX MG set-ups and
solves, and JAX's Pallas B5 and B8 in interpret mode, are ``slow``.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quda_tpu_torch as qt
from quda_tpu.fields.geometry import LatticeGeometry as JGeom
from quda_tpu.mg import pair as jpair
from quda_tpu.mg.gemm import build_coarse_pairs_gemm as jbuild_gemm
from quda_tpu.mg.mg import MGLevelParam as JLevelParam
from quda_tpu.models.wilson import DiracWilson as JDiracWilson
from quda_tpu.ops import coarse_pallas as jcp
from quda_tpu.ops import wilson_packed as jwpk
from quda_tpu_torch import solvers
from quda_tpu_torch.fields.geometry import LatticeGeometry
from quda_tpu_torch.mg import gemm, mg as mgm, pair
from quda_tpu_torch.mg.coarse import DIRS
from quda_tpu_torch.models.wilson import DiracWilson
from quda_tpu_torch.ops import coarse_pallas as cp
from quda_tpu_torch.ops import wilson_packed as wpk
from quda_tpu_torch.ops import wilson_pallas_packed as wpp

from tests.torch_inputs import (gaussian, lattice_shape, rel_err,
                                su3_gauge)
from tests.torch_inputs import one_torch_thread  # noqa: F401 (autouse)

DIMS = (4, 4, 4, 4)
BLOCK = (2, 2, 2, 2)
NVEC = 4
KAPPA = 0.12
# the JAX package's solver modules (its package exports functions of the
# same names)
jblock = importlib.import_module("quda_tpu.solvers.block")
jcg = importlib.import_module("quda_tpu.solvers.cg")
jgcr = importlib.import_module("quda_tpu.solvers.gcr")


def _t(a):
    return torch.from_numpy(np.array(a))


def _n(t):
    return t.detach().cpu().numpy()


# -- the Krylov pieces on a small dense system -----------------------------

@pytest.fixture(scope="module")
def dense():
    """A non-Hermitian well-conditioned 40 x 40 system, an SPD one, a
    right-hand side and a 4-column batch, float64."""
    rng = np.random.default_rng(321)
    n = 40
    a = np.eye(n) * 3.0 + rng.standard_normal((n, n)) / np.sqrt(n)
    q = rng.standard_normal((n, n))
    spd = q @ q.T / n + np.eye(n)
    b = rng.standard_normal(n)
    bb = rng.standard_normal((4, n))
    return a, spd, b, bb


def _mv(m):
    return (lambda v: _t(m) @ v), (lambda v: jnp.asarray(m) @ v)


SOLVERS = ["gcr", "gcr_fixed", "mr", "mr_fixed", "sd", "cg_fixed_iters",
           "batched_bicgstab_pairs"]


@pytest.mark.parametrize("name", SOLVERS)
def test_dense_solver_matches_jax(dense, name):
    """Each solver against the JAX package's on the same float64 system:
    iterates within 1e-10, iteration counts equal."""
    a, spd, b, bb = dense
    mt, mj = _mv(a)
    st, sj = _mv(spd)
    tb, jb = _t(b), jnp.asarray(b)
    if name == "gcr":
        got = solvers.gcr(mt, tb, tol=1e-9, nkrylov=5, max_restarts=20)
        want = jgcr.gcr(mj, jb, tol=1e-9, nkrylov=5, max_restarts=20)
        assert got.iters == int(want.iters) and got.converged
        x, wx = got.x, want.x
    elif name == "gcr_fixed":
        x = solvers.gcr_fixed(mt, tb, nkrylov=6, cycles=2)
        wx = jgcr.gcr_fixed(mj, jb, nkrylov=6, cycles=2)
    elif name == "mr":
        got = solvers.mr(mt, tb, tol=1e-8, maxiter=200, omega=0.9)
        want = jgcr.mr(mj, jb, tol=1e-8, maxiter=200, omega=0.9)
        assert got.iters == int(want.iters) and got.converged
        x, wx = got.x, want.x
    elif name == "mr_fixed":
        x = solvers.mr_fixed(mt, tb, 7, omega=0.85)
        wx = jgcr.mr_fixed(mj, jb, 7, omega=0.85)
    elif name == "sd":
        got = solvers.sd(st, tb, tol=1e-8, maxiter=300)
        want = jgcr.sd(sj, jb, tol=1e-8, maxiter=300)
        assert got.iters == int(want.iters) and got.converged
        x, wx = got.x, want.x
    elif name == "cg_fixed_iters":
        (got, hist) = solvers.cg_fixed_iters(st, tb, None, 12)
        (want, whist) = jcg.cg_fixed_iters(sj, jb, None, 12)
        assert rel_err(_n(hist), np.asarray(whist)) < 1e-10
        x, wx = got.x, want.x
    else:
        def bt(V):
            return V @ _t(a).T

        def bj(V):
            return V @ jnp.asarray(a).T
        got = solvers.batched_bicgstab_pairs(bt, _t(bb), tol=1e-9,
                                             maxiter=100)
        want = jblock.batched_bicgstab_pairs(bj, jnp.asarray(bb), tol=1e-9,
                                             maxiter=100)
        assert [int(i) for i in got.iters] == [int(i) for i in want.iters]
        assert bool(got.converged.all())
        x, wx = got.x, want.x
    assert rel_err(_n(x), np.asarray(wx)) < 1e-10


def test_batched_bicgstab_refuses_complex_and_keeps_its_input(dense):
    a, _, _, bb = dense
    B = _t(bb)
    keep = B.clone()
    solvers.batched_bicgstab_pairs(lambda V: V @ _t(a).T, B, tol=1e-6)
    assert torch.equal(B, keep)
    with pytest.raises(TypeError, match="real"):
        solvers.batched_bicgstab_pairs(lambda V: V, B.to(torch.complex128))


# -- transfer, coarse construction and the coarse stencil ------------------

@pytest.fixture(scope="module")
def fine():
    """SU(3) links on 4^4 (complex64), the port's and JAX's Wilson level
    operators (JAX on its XLA pair stencil), and numpy null vectors."""
    g = su3_gauge(DIMS, 322)
    geom = LatticeGeometry(DIMS)
    jgeom = JGeom(DIMS)
    op = pair.PairWilsonLevelOp(DiracWilson(_t(g), geom, KAPPA))
    jop = jpair.PairWilsonLevelOp(JDiracWilson(jnp.asarray(g), jgeom,
                                               kappa=KAPPA),
                                  use_pallas=False)
    rng = np.random.default_rng(323)
    nulls = rng.standard_normal(
        (NVEC,) + lattice_shape(DIMS) + (2, 6, 2)).astype(np.float32)
    return g, op, jop, nulls


@pytest.fixture(scope="module")
def transfers(fine):
    _, _, _, nulls = fine
    tr = pair.PairTransfer.from_null_vectors(_t(nulls), BLOCK)
    jtr = jpair.PairTransfer.from_null_vectors(jnp.asarray(nulls), BLOCK)
    return tr, jtr


def test_chiral_layout_blocking_and_parity_match_jax():
    """mg/transfer.py's chiral layout and block aggregation (complex and
    pair fields) and mg/mg.py's parity_eps equal JAX's exactly; blocking
    then unblocking is the identity."""
    from quda_tpu.mg import mg as jmg
    from quda_tpu.mg import transfer as jtr
    from quda_tpu_torch.mg import transfer as tr
    rng = np.random.default_rng(342)
    f = (rng.standard_normal((2, 4, 6, 2, 4, 4, 3))
         + 1j * rng.standard_normal((2, 4, 6, 2, 4, 4, 3)))
    c = tr.to_chiral(_t(f))
    assert np.array_equal(_n(c), np.asarray(jtr.to_chiral(jnp.asarray(f))))
    assert torch.equal(tr.from_chiral(c), _t(f))
    blk = (2, 3, 1, 2)
    b = tr._block_fields(c, blk)
    assert np.array_equal(_n(b), np.asarray(
        jtr._block_fields(jnp.asarray(_n(c)), blk)))
    assert torch.equal(tr._unblock_fields(b, blk, (4, 6, 2, 4), 6), c)
    cp2 = torch.view_as_real(c).contiguous()
    bp = pair._block_fields_pairs(cp2, blk)
    assert np.array_equal(_n(bp), np.asarray(jpair._block_fields_pairs(
        jnp.asarray(_n(cp2)), blk)))
    assert np.array_equal(mgm.parity_eps((4, 6, 2, 4), 2),
                          jmg.parity_eps((4, 6, 2, 4), 2))


def test_cholqr2_matches_jax():
    """CholQR2 equals JAX's within 1e-6 and gives orthonormal columns."""
    rng = np.random.default_rng(324)
    cols = rng.standard_normal((3, 2, 24, 5, 2)).astype(np.float32)
    got = _n(pair.cholqr2(_t(cols)))
    want = np.asarray(jpair.cholqr2(jnp.asarray(cols)))
    assert rel_err(got, want) < 1e-6
    qc = got[..., 0] + 1j * got[..., 1]
    gram = np.einsum("...dn,...dm->...nm", qc.conj(), qc)
    assert np.abs(gram - np.eye(5)).max() < 1e-5


def test_pair_transfer_matches_jax(fine, transfers):
    """The transfer built from the same null vectors, its restrict and its
    prolong equal JAX's within 1e-6; R P = 1 within 1e-6."""
    tr, jtr = transfers
    assert rel_err(_n(tr.v), np.asarray(jtr.v)) < 1e-6
    assert tr.coarse_shape == jtr.coarse_shape == (2, 2, 2, 2)
    rng = np.random.default_rng(325)
    f = rng.standard_normal(lattice_shape(DIMS) + (2, 6, 2)).astype(
        np.float32)
    c = rng.standard_normal((2, 2, 2, 2, 2, NVEC, 2)).astype(np.float32)
    assert rel_err(_n(tr.restrict(_t(f))),
                   np.asarray(jtr.restrict(jnp.asarray(f)))) < 1e-6
    assert rel_err(_n(tr.prolong(_t(c))),
                   np.asarray(jtr.prolong(jnp.asarray(c)))) < 1e-6
    assert rel_err(_n(tr.restrict(tr.prolong(_t(c)))), c) < 1e-6


@pytest.fixture(scope="module")
def coarse_ops(fine, transfers):
    """The coarse operator of the same transfer (JAX's V in both), built
    by the port's GEMM probes, its probe loop, and JAX's GEMM probes."""
    _, op, jop, _ = fine
    _, jtr = transfers
    tr = pair.PairTransfer(_t(jtr.v), BLOCK, lattice_shape(DIMS), 6, NVEC)
    co = gemm.build_coarse_pairs_gemm(op, tr)
    co_loop = pair.build_coarse_pairs(op, tr)
    jco = jbuild_gemm(jop, jtr)
    return tr, co, co_loop, jco


def test_gemm_coarse_build_matches_jax_and_probe_loop(coarse_ops):
    """X and the 8 links Y of build_coarse_pairs_gemm equal JAX's from the
    same gauge and transfer, and the port's probe loop, within 1e-5."""
    _, co, co_loop, jco = coarse_ops
    assert rel_err(_n(co.x_diag), np.asarray(jco.x_diag)) < 1e-5
    assert rel_err(_n(co.x_diag), _n(co_loop.x_diag)) < 1e-5
    for d in DIRS:
        assert rel_err(_n(co.y[d]), np.asarray(jco.y[d])) < 1e-5
        assert rel_err(_n(co.y[d]), _n(co_loop.y[d])) < 1e-5


def test_gemm_coarse_build_chunked_is_the_same(fine, coarse_ops):
    """Probe columns in chunks of 3 give the same links as all at once."""
    _, op, _, _ = fine
    tr, co, _, _ = coarse_ops
    chunked = gemm.build_coarse_pairs_gemm(op, tr, chunk=3)
    assert torch.equal(chunked.x_diag, co.x_diag)
    for d in DIRS:
        assert torch.equal(chunked.y[d], co.y[d])


def test_face_mask_matches_jax():
    from quda_tpu.mg.gemm import _face_mask as jface
    for mu in range(4):
        for sign in (1, -1):
            got = gemm._face_mask((4, 6, 8, 2), (2, 3, 4, 2), mu, sign)
            assert np.array_equal(got, jface((4, 6, 8, 2), (2, 3, 4, 2), mu,
                                             sign))


@pytest.mark.parametrize("e", [16, 20])
def test_coarse_plain_matches_jax_ref(e):
    """B8's plain version (einsum "ksab,ksb->sa") equals JAX's
    coarse_apply_ref within 1e-6, and coarse_model JAX's."""
    rng = np.random.default_rng(326 + e)
    links = rng.standard_normal((9, 12, e, e)).astype(np.float32)
    psi9 = rng.standard_normal((9, 12, e)).astype(np.float32)
    got = _n(cp.coarse_apply_pallas(_t(links), _t(psi9)))
    want = np.asarray(jcp.coarse_apply_ref(jnp.asarray(links),
                                           jnp.asarray(psi9)))
    assert rel_err(got, want) < 1e-6
    assert cp.coarse_model(e // 2) == jcp.coarse_model(e // 2)


def test_coarse_mrhs_plain_matches_lanes_and_jax():
    """B8's multi-RHS plain version equals the single form lane by lane
    (1e-6) and JAX's vmapped coarse_apply_ref (1e-6)."""
    rng = np.random.default_rng(329)
    links = rng.standard_normal((9, 10, 20, 20)).astype(np.float32)
    psi9 = rng.standard_normal((3, 9, 10, 20)).astype(np.float32)
    got = cp.coarse_apply_pallas_mrhs(_t(links), _t(psi9))
    for i in range(3):
        lane = cp.coarse_apply_pallas(_t(links), _t(psi9[i]))
        assert rel_err(_n(got[i]), _n(lane)) < 1e-6
    want = jax.vmap(lambda p: jcp.coarse_apply_ref(jnp.asarray(links), p))(
        jnp.asarray(psi9))
    assert rel_err(_n(got), np.asarray(want)) < 1e-6


def test_coarse_operator_forms_agree_with_jax(coarse_ops):
    """The coarse M through B8's wrapper (its plain version on CPU), the
    einsum form and the embedding form agree within 1e-6, and with JAX's
    einsum form of the same links; gamma5-hermiticity holds."""
    _, co, _, jco = coarse_ops
    rng = np.random.default_rng(330)
    v = rng.standard_normal((2, 2, 2, 2, 2, NVEC, 2)).astype(np.float32)
    tv = _t(v)
    k = co.M(tv)
    ein = dataclasses.replace(co, use_kernel=False).M(tv)
    emb = dataclasses.replace(co, use_kernel=False, use_embedding=True).M(tv)
    j = np.asarray(dataclasses.replace(jco, use_embedding=False,
                                       use_pallas=False).M(jnp.asarray(v)))
    for got in (k, ein, emb):
        assert rel_err(_n(got), j) < 1e-6
    batch = torch.stack([tv, 2 * tv])
    assert torch.allclose(co.M(batch)[1], 2 * k, rtol=1e-6, atol=1e-6)
    w = _t(rng.standard_normal(v.shape).astype(np.float32))
    lhs = float(torch.sum(w * co.M(tv)))
    rhs = float(torch.sum(co.Mdag(w) * tv))
    assert abs(lhs - rhs) < 1e-4 * abs(lhs)


def test_b5_plain_lanes_match_b4_and_jax():
    """B5's plain version: each lane bit for bit B4's plain version, and
    within 1e-6 of JAX's vmapped XLA full-lattice hop
    (dslash_packed_pairs)."""
    dims = (4, 6, 8, 10)
    T, Z, Y, X = lattice_shape(dims)
    rng = np.random.default_rng(331)
    u = rng.standard_normal((4, 3, 3, 2, T, Z, Y * X)).astype(np.float32)
    psi = rng.standard_normal((3, 4, 3, 2, T, Z, Y * X)).astype(np.float32)
    tu = _t(u)
    bw = wpp.backward_gauge(tu, X).contiguous()
    got = wpp.dslash_pallas_packed_mrhs(tu, _t(psi), X, gauge_bw=bw)
    for i in range(3):
        lane = wpp.dslash_pallas_packed(tu, _t(psi[i]), X, gauge_bw=bw)
        assert torch.equal(got[i], lane)
    want = jax.vmap(lambda p: jwpk.dslash_packed_pairs(
        jnp.asarray(u), p, X, Y))(jnp.asarray(psi))
    assert rel_err(_n(got), np.asarray(want)) < 1e-6
    assert wpk.to_packed_pairs is not None


def test_fine_level_op_matches_jax(fine):
    """The fine level's M (B4's wrapper, the kernel layout and back),
    M_mrhs and MdagM_mrhs (B5's wrapper) and the single-direction hops
    equal JAX's XLA pair forms within 1e-6."""
    _, op, jop, nulls = fine
    v = nulls[0]
    assert rel_err(_n(op.M(_t(v))), np.asarray(jop.M(jnp.asarray(v)))) \
        < 1e-6
    assert rel_err(_n(op.MdagM(_t(v))),
                   np.asarray(jop.MdagM(jnp.asarray(v)))) < 1e-6
    assert rel_err(_n(op.M_mrhs(_t(nulls))),
                   np.asarray(jop.M_mrhs(jnp.asarray(nulls)))) < 1e-6
    assert rel_err(_n(op.MdagM_mrhs(_t(nulls))),
                   np.asarray(jop.MdagM_mrhs(jnp.asarray(nulls)))) < 1e-6
    for mu, sign in ((0, 1), (3, -1)):
        assert rel_err(_n(op.hop(_t(v), mu, sign)),
                       np.asarray(jop.hop(jnp.asarray(v), mu, sign))) < 1e-6


# -- hierarchies -----------------------------------------------------------

def _params(levels):
    return [mgm.MGLevelParam(block=BLOCK, n_vec=NVEC, setup_iters=40,
                             post_smooth=4, coarse_solver_iters=10)
            for _ in range(levels)]


@pytest.mark.parametrize("dims,levels", [(DIMS, 1), ((8, 8, 8, 8), 2)],
                         ids=["two-level", "three-level"])
def test_verify_port_hierarchy(dims, levels):
    """A port set-up (BiCGStab null vectors, CholQR2, GEMM probes) passes
    verify on every level: R P = 1 and coarse M = R M P within 1e-5."""
    g = su3_gauge(dims, 332)
    geom = LatticeGeometry(dims)
    mg = pair.PairMG(DiracWilson(_t(g), geom, KAPPA), geom, _params(levels),
                     torch.Generator().manual_seed(333))
    rep = mg.verify(galerkin_tol=1e-5, pr_tol=1e-5)
    assert len(rep) == levels
    assert all(r["rp_identity"] < 1e-5 and r["galerkin"] < 1e-5
               for r in rep)
    phases = [(r["level"], r["phase"]) for r in mg.setup_breakdown]
    assert phases == [(li, ph) for li in range(levels)
                      for ph in ("null_vectors", "transfer_build",
                                 "coarse_probe")]
    assert mg.null_fallbacks == []


def _arrays(levels):
    """Per-level numpy arrays of a hierarchy (port or JAX)."""
    out = []
    for lv in levels:
        co = lv["coarse"]
        out.append({"v": np.asarray(_n(lv["transfer"].v)
                                    if isinstance(lv["transfer"].v,
                                                  torch.Tensor)
                                    else lv["transfer"].v),
                    "x_diag": np.asarray(_n(co.x_diag)
                                         if isinstance(co.x_diag,
                                                       torch.Tensor)
                                         else co.x_diag),
                    "y": {d: np.asarray(_n(co.y[d])
                                        if isinstance(co.y[d], torch.Tensor)
                                        else co.y[d]) for d in DIRS}})
    return out


def _jax_hierarchy(g, dims, params, arrays):
    """JAX's PairMG holding the given arrays (its einsum coarse form)."""
    jgeom = JGeom(dims)
    jop = jpair.PairWilsonLevelOp(JDiracWilson(jnp.asarray(g), jgeom,
                                               kappa=KAPPA),
                                  use_pallas=False)
    mg = object.__new__(jpair.PairMG)
    mg.geom, mg.adapter, mg.levels = jgeom, jop, []
    mg.params = [JLevelParam(**{f.name: getattr(p, f.name)
                                for f in dataclasses.fields(JLevelParam)})
                 for p in params]
    op, lat, k = jop, lattice_shape(dims), 6
    for p, a in zip(mg.params, arrays):
        tr = jpair.PairTransfer(jnp.asarray(a["v"]), p.block, lat, k,
                                p.n_vec)
        co = jpair.PairCoarseOperator(
            jnp.asarray(a["x_diag"]),
            {d: jnp.asarray(a["y"][d]) for d in DIRS}, p.n_vec)
        mg.levels.append(dict(op=op, transfer=tr, coarse=co, param=p))
        op, lat, k = co, tr.coarse_shape, p.n_vec
    return mg


def test_vcycle_matches_jax_on_shared_hierarchy(fine):
    """One hierarchy's arrays (a port set-up), applied by both packages:
    the port's preconditioner (B4/B8 wrappers) equals JAX's V-cycle within
    1e-5."""
    g, op, _, _ = fine
    params = _params(1)
    mg = pair.PairMG(op, LatticeGeometry(DIMS), params,
                     torch.Generator().manual_seed(334))
    arrays = _arrays(mg.levels)
    jmg = _jax_hierarchy(g, DIMS, params, arrays)
    carried = pair.PairMG.from_arrays(op.dirac, params, arrays)
    b = gaussian(lattice_shape(DIMS) + (4, 3, 2), 335, dtype=np.float32)
    want = np.asarray(jmg.precondition(jnp.asarray(b)))
    assert rel_err(_n(mg.precondition(_t(b))), want) < 1e-5
    assert rel_err(_n(carried.precondition(_t(b))), want) < 1e-5


def test_zero_source_null_vectors_are_near_null(fine):
    """The null-vector solve (QUDA's generateNullVectors: M v = 0 from a
    random guess, v = v0 - M^-1 M v0 after a capped solve) keeps the low
    modes: |M v| / |v| of its vectors is well below that of the random
    vectors it starts from; a hierarchy built on them passes verify."""
    _, op, _, nulls = fine
    P = op.to_mrhs_layout(_t(nulls))

    def ratio(v):
        return float(torch.mean(torch.sqrt(
            torch.sum((op.M_mrhs_pl(v) ** 2).reshape(NVEC, -1), 1)
            / torch.sum((v ** 2).reshape(NVEC, -1), 1))))
    zero = mgm._null_solve_body(op.M_mrhs_pl, P, 5e-6, 5, False)
    # this hot 4^4 gauge at kappa 0.12 has no near-null modes to keep,
    # so the margin is modest (0.71 against 1.11 for the start)
    assert ratio(zero) < 0.8 * ratio(P)
    mg = pair.PairMG(op, LatticeGeometry(DIMS), _params(1),
                     torch.Generator().manual_seed(341))
    assert mg.verify(galerkin_tol=1e-5, pr_tol=1e-5)[0]["galerkin"] < 1e-5


def test_null_vector_breakdown_falls_back_to_cg(fine, monkeypatch, caplog):
    """A BiCGStab null-vector solve that returns non-finite lanes makes the
    level fall back to CG on the normal equations, with a warning, and
    the hierarchy is still consistent."""
    _, op, _, _ = fine

    def broken(mv, B, tol, maxiter):
        return solvers.BatchedCGResult(torch.full_like(B, float("nan")),
                                       None, None, None)
    monkeypatch.setattr(solvers.block, "batched_bicgstab_pairs", broken)
    mg = pair.PairMG(op, LatticeGeometry(DIMS), _params(1),
                     torch.Generator().manual_seed(336))
    assert mg.null_fallbacks == [0]
    assert any("broke down" in r.message for r in caplog.records)
    assert mg.verify(galerkin_tol=1e-5, pr_tol=1e-5)[0]["galerkin"] < 1e-5


# -- the API route ---------------------------------------------------------

def _mg_params():
    return qt.MultigridParamAPI(geo_block_size=(BLOCK,), n_vec=(NVEC,),
                                setup_iters=(40,))


@pytest.mark.parametrize("kappa2", [KAPPA, 0.105],
                         ids=["same-kappa", "other-kappa"])
def test_gcr_mg_route_converges_reuses_and_rebuilds(kappa2):
    """invert_quda(gcr-mg) on the resident hierarchy converges to true_res
    < 5e-6 (also by the complex full-lattice operator); a second solve at
    ``kappa2`` (the hierarchy's kappa, or another) reuses the hierarchy
    and solves kappa2's system, the hierarchy only preconditioning it
    (its residual under the hierarchy's own kappa is large); and a new
    gauge makes the next solve set the hierarchy up again, with the same
    parameters and the solve's kappa."""
    from quda_tpu_torch.interfaces import quda_api as api
    g = su3_gauge(DIMS, 337)
    b = gaussian(lattice_shape(DIMS) + (4, 3), 338)
    bt = _t(b).to(torch.complex128)

    def resid(x, kappa):
        d = DiracWilson(_t(g).to(torch.complex128), LatticeGeometry(DIMS),
                        kappa)
        r = bt - d.M(x.to(torch.complex128))
        return float(torch.linalg.vector_norm(r)
                     / torch.linalg.vector_norm(bt))
    qt.init_quda("cpu")
    try:
        qt.load_gauge_quda(g, qt.GaugeParam(X=DIMS, cuda_prec="single"))
        ip = qt.InvertParam(dslash_type="wilson", inv_type="gcr-mg",
                            kappa=KAPPA, tol=1e-6, solve_type="direct",
                            cuda_prec="single", gcrNkrylov=6)
        mg = qt.new_multigrid_quda(_mg_params(), ip)
        assert isinstance(mg, pair.PairMG)
        x = qt.invert_quda(b, ip)
        assert ip.converged and ip.true_res < 5e-6
        assert ip.iter_count % 6 == 0 and ip.iter_count > 0
        assert resid(x, KAPPA) < 5e-6
        assert x.dtype == torch.complex64 and x.shape == bt.shape
        ip2 = dataclasses.replace(ip, kappa=kappa2)
        x2 = qt.invert_quda(b, ip2)
        assert api._ctx["mg"] is mg and mg.adapter.kappa == KAPPA
        assert ip2.converged and ip2.true_res < 5e-6
        assert resid(x2, kappa2) < 5e-6
        if kappa2 != KAPPA:
            assert resid(x2, KAPPA) > 1e-3
        qt.load_gauge_quda(su3_gauge(DIMS, 339),
                           qt.GaugeParam(X=DIMS, cuda_prec="single"))
        qt.invert_quda(b, ip2)
        assert api._ctx["mg"] is not mg and ip2.true_res < 5e-6
        assert api._ctx["mg"].params[0].n_vec == NVEC
        assert api._ctx["mg"].adapter.kappa == kappa2
        qt.destroy_multigrid_quda()
        assert api._ctx["mg"] is None
    finally:
        qt.end_quda()


@pytest.mark.parametrize("change,item", [
    ({"dslash_type": "clover", "csw": 1.0}, "A12"),
    ({"dslash_type": "staggered", "mass": 0.1, "cuda_prec": "double"},
     "A12"),
    ({"cuda_prec": "double"}, "A12")],
    ids=["clover", "staggered", "double"])
def test_refused_mg_routes(change, item):
    """gcr-mg for clover, staggered at double and Wilson at double raises,
    naming its ROADMAP item, through invert_quda and new_multigrid_quda."""
    g = su3_gauge(DIMS, 340)
    b = gaussian(lattice_shape(DIMS) + (4, 3), 340)
    qt.init_quda("cpu")
    try:
        qt.load_gauge_quda(g, qt.GaugeParam(X=DIMS, cuda_prec="single"))
        kw = dict(dslash_type="wilson", inv_type="gcr-mg", kappa=KAPPA,
                  tol=1e-6, cuda_prec="single")
        kw.update(change)
        ip = qt.InvertParam(**kw)
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            qt.new_multigrid_quda(_mg_params(), ip)
        if change.get("dslash_type") != "staggered":
            with pytest.raises(NotImplementedError,
                               match=f"ROADMAP {item}"):
                qt.invert_quda(b, ip)
    finally:
        qt.end_quda()


def test_refused_hierarchies(fine):
    """coarse_replicate waits for ROADMAP A15; a fine operator other than
    Wilson's (clover here) is refused by the pair hierarchy (A12)."""
    from quda_tpu_torch.models.clover import DiracClover
    g, op, _, _ = fine
    p = _params(1)
    p[0] = dataclasses.replace(p[0], coarse_replicate=True)
    with pytest.raises(NotImplementedError, match="ROADMAP A15"):
        pair.PairMG(op, LatticeGeometry(DIMS), p)
    cl = DiracClover(_t(g), LatticeGeometry(DIMS), KAPPA, 1.0)
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        pair.PairMG(cl, LatticeGeometry(DIMS), _params(1))


# -- slow: JAX set-ups, whole JAX solves, JAX's Pallas kernels --------------

@pytest.mark.slow
def test_vcycle_matches_jax_hierarchy_carried_across():
    """A JAX set-up's arrays carried into the port (PairMG.from_arrays):
    both V-cycles agree within 1e-5, and verify passes on the port's
    copy."""
    g = su3_gauge(DIMS, 332)
    jgeom = JGeom(DIMS)
    jd = JDiracWilson(jnp.asarray(g), jgeom, kappa=KAPPA)
    jparams = [JLevelParam(block=BLOCK, n_vec=NVEC, setup_iters=20)]
    jmg = jpair.PairMG(jd, jgeom, jparams, key=jax.random.PRNGKey(3))
    params = [mgm.MGLevelParam(block=BLOCK, n_vec=NVEC, setup_iters=20)]
    mg = pair.PairMG.from_arrays(
        DiracWilson(_t(g), LatticeGeometry(DIMS), KAPPA), params,
        _arrays(jmg.levels))
    b = gaussian(lattice_shape(DIMS) + (4, 3, 2), 335, dtype=np.float32)
    want = np.asarray(jmg.precondition(jnp.asarray(b)))
    assert rel_err(_n(mg.precondition(_t(b))), want) < 1e-5
    assert mg.verify(galerkin_tol=1e-5, pr_tol=1e-5)[0]["galerkin"] < 1e-5


@pytest.mark.slow
def test_gcr_mg_route_matches_jax(monkeypatch):
    """The gcr-mg API route against JAX's (QUDA_TPU_PACKED=1, its pair
    hierarchy): both converge to true_res < 5e-6 and their solutions agree
    within 1e-5 (their hierarchies differ: random null vectors, from
    M v = r in the JAX package and from M v = 0 in the port)."""
    from quda_tpu.interfaces import quda_api as japi
    from quda_tpu.interfaces.params import (GaugeParam as JGaugeParam,
                                            InvertParam as JInvertParam,
                                            MultigridParamAPI as JMGParam)
    monkeypatch.setenv("QUDA_TPU_PACKED", "1")
    g = su3_gauge(DIMS, 337)
    b = gaussian(lattice_shape(DIMS) + (4, 3), 338)
    kw = dict(dslash_type="wilson", inv_type="gcr-mg", kappa=KAPPA,
              tol=1e-7, solve_type="direct", cuda_prec="single",
              gcrNkrylov=6)
    japi.init_quda()
    try:
        japi.load_gauge_quda(g, JGaugeParam(X=DIMS, cuda_prec="single"))
        jp = JInvertParam(**kw)
        japi.new_multigrid_quda(JMGParam(geo_block_size=(BLOCK,),
                                         n_vec=(NVEC,), setup_iters=(40,)),
                                jp)
        want = np.asarray(japi.invert_quda(b, jp))
    finally:
        japi.destroy_multigrid_quda()
        japi.end_quda()
    qt.init_quda("cpu")
    try:
        qt.load_gauge_quda(g, qt.GaugeParam(X=DIMS, cuda_prec="single"))
        ip = qt.InvertParam(**kw)
        qt.new_multigrid_quda(_mg_params(), ip)
        got = _n(qt.invert_quda(b, ip))
    finally:
        qt.end_quda()
    assert jp.true_res < 5e-6 and ip.true_res < 5e-6
    assert rel_err(got, want) < 1e-5


@pytest.mark.slow
def test_b5_plain_matches_jax_pallas_interpret():
    """B5's plain version against JAX's Pallas B5 in interpret mode
    (1e-6)."""
    from quda_tpu.ops import wilson_pallas_packed as jwpp
    dims = (4, 4, 8, 8)
    T, Z, Y, X = lattice_shape(dims)
    rng = np.random.default_rng(339)
    u = rng.standard_normal((4, 3, 3, 2, T, Z, Y * X)).astype(np.float32)
    psi = rng.standard_normal((2, 4, 3, 2, T, Z, Y * X)).astype(np.float32)
    got = wpp.dslash_pallas_packed_mrhs(_t(u), _t(psi), X)
    want = jwpp.dslash_pallas_packed_mrhs(jnp.asarray(u), jnp.asarray(psi),
                                          X, interpret=True)
    assert rel_err(_n(got), np.asarray(want)) < 1e-6


@pytest.mark.slow
def test_b8_plain_matches_jax_pallas_interpret():
    """B8's plain version against JAX's Pallas B8 in interpret mode
    (1e-6)."""
    rng = np.random.default_rng(340)
    links = rng.standard_normal((9, 16, 16, 16)).astype(np.float32)
    psi9 = rng.standard_normal((9, 16, 16)).astype(np.float32)
    got = cp.coarse_apply_pallas(_t(links), _t(psi9))
    want = jcp.coarse_apply_pallas(jnp.asarray(links), jnp.asarray(psi9),
                                   interpret=True)
    assert rel_err(_n(got), np.asarray(want)) < 1e-6
