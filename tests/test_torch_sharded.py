"""The sharded Wilson hops (quda_tpu_torch/parallel/pallas_dslash.py) and
the mesh route of the Wilson pair operator (models/wilson.py) against the
JAX package's unsharded stencils and pair operator, and the port's own
unsharded hops.

The comparison is the one the JAX package's sharded tests make
(tests/test_pallas_sharded.py): the sharded hop on every grid equals the
single-device stencil within 1e-6 (norm ratio, f32).  On CPU blocks the
interiors run the plain versions of B1, B10-eo, B4 and B10, and both halo
policies the plain transport (bit for bit each other).  A 4^3 x 8
lattice (X 8) keeps every partitioned local extent even on the grids
(2,1,1,1), (2,2,1,1), (2,2,2,1), (1,1,1,2) and (2,1,1,2).  numpy seeds
581-599.  The JAX references are computed once (a module fixture); the
``slow`` tests run JAX's own sharded hops under shard_map in interpret
mode at the smallest size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quda_tpu.fields.geometry import LatticeGeometry as JGeom
from quda_tpu.models.wilson import DiracWilsonPC as JDiracWilsonPC
from quda_tpu.ops import wilson_packed as jwpk
from quda_tpu.parallel import pallas_dslash as jpds
from quda_tpu_torch.fields.geometry import LatticeGeometry
from quda_tpu_torch.fields.spinor import even_odd_split
from quda_tpu_torch.models.wilson import DiracWilson, DiracWilsonPC
from quda_tpu_torch.ops import wilson_packed as wpk
from quda_tpu_torch.ops import wilson_pallas_packed as wpp
from quda_tpu_torch.parallel import mesh as qm
from quda_tpu_torch.parallel import pallas_dslash as pds
from quda_tpu_torch.parallel import pallas_halo as ph
from quda_tpu_torch.solvers.fused_iter import fused_cg
from quda_tpu_torch.utils import tune

from tests.torch_inputs import (gaussian, lattice_shape,  # noqa: F401
                                one_torch_thread, su3_gauge)

DIMS = (8, 4, 4, 4)                       # (X, Y, Z, T)
LAT = lattice_shape(DIMS)                 # (T, Z, Y, X)
KAPPA = 0.12
GRIDS = [(2, 1, 1, 1), (2, 2, 1, 1), (2, 2, 2, 1), (1, 1, 1, 2),
         (2, 1, 1, 2)]
TZ_GRIDS = [g for g in GRIDS if g[2] == 1 and g[3] == 1]
TOL = 1e-6


def _mesh(grid):
    return qm.make_lattice_mesh(grid, devices=["cpu"] * int(np.prod(grid)))


def _nrel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def fields():
    """SU(3) links with the antiperiodic t phase folded in (so recon-12
    rebuilds them exactly), pair-form eo and full-lattice fields, and
    JAX's unsharded stencils on them."""
    geom = LatticeGeometry(DIMS)
    g = torch.from_numpy(su3_gauge(DIMS, 581))
    psi = torch.from_numpy(gaussian(LAT + (4, 3), 582))
    dpc = DiracWilsonPC(g, geom, KAPPA)
    dpk = dpc.packed()
    g_eo = tuple(wpk.to_packed_pairs(x, torch.float32).contiguous()
                 for x in dpk.gauge_eo_p)
    pe, po = even_odd_split(psi, geom)
    src = {p: wpk.to_packed_pairs(wpk.pack_spinor(po if p == 0 else pe),
                                  torch.float32).contiguous()
           for p in (0, 1)}
    dw = DiracWilson(g, geom, KAPPA)
    g_full = wpk.to_packed_pairs(wpk.pack_gauge(dw.gauge),
                                 torch.float32).contiguous()
    psi_full = wpk.to_packed_pairs(wpk.pack_spinor(psi),
                                   torch.float32).contiguous()
    jg = tuple(jnp.asarray(x.numpy()) for x in g_eo)
    ref_eo = {p: np.asarray(jwpk.dslash_eo_packed_pairs(
        jg, jnp.asarray(src[p].numpy()), LAT, p)) for p in (0, 1)}
    T, Z, Y, X = LAT
    ref_full = np.asarray(jwpk.dslash_packed_pairs(
        jnp.asarray(g_full.numpy()), jnp.asarray(psi_full.numpy()), X, Y))
    return dict(geom=geom, g=g, psi=psi, dpk=dpk, g_eo=g_eo, src=src,
                g_full=g_full, psi_full=psi_full, ref_eo=ref_eo,
                ref_full=ref_full)


def _form(links, form):
    return wpp.to_recon12(links) if form == "r12" else links


def _shard(x, mesh, xcols):
    """Natural packed layout -> ShardedField (block-contiguous on an x
    mesh)."""
    _, _, n_y, n_x = mesh.grid
    Y = LAT[2]
    return qm.shard(qm.fuse_block_layout(x, n_y, n_x, Y, xcols), mesh,
                    qm.pair_pspec(x.dim()))


def _gather(sf, xcols):
    _, _, n_y, n_x = sf.mesh.grid
    return qm.unfuse_block_layout(qm.gather(sf), n_y, n_x, LAT[2], xcols)


EO_CASES = ([(g, 2) for g in GRIDS] + [(g, 3) for g in TZ_GRIDS])


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("form", ["full", "r12"])
@pytest.mark.parametrize("grid,version", EO_CASES,
                         ids=[f"{'x'.join(map(str, g))}-v{v}"
                              for g, v in EO_CASES])
def test_sharded_eo_hop_matches_jax(fields, grid, version, form, parity):
    """dslash_eo_pallas_sharded (v2, B1 interior) and _v3 (B10-eo, t/z
    grids): fused_halo bit for bit xla_facefix, within 1e-6 of JAX's
    unsharded dslash_eo_packed_pairs and of the port's unsharded hop."""
    mesh = _mesh(grid)
    xh = LAT[3] // 2
    uh = _form(fields["g_eo"][parity], form)
    ut = _form(fields["g_eo"][1 - parity], form)
    psi = fields["src"][parity]
    if version == 2:
        other = wpp.backward_gauge_eo(ut, LAT, parity).contiguous()
        entry, single = pds.dslash_eo_pallas_sharded, \
            wpp.dslash_eo_pallas_packed
    else:
        other = ut
        entry, single = pds.dslash_eo_pallas_sharded_v3, \
            wpp.dslash_eo_pallas_packed_v3
    args = [_shard(x, mesh, xh) for x in (uh, other, psi)]
    a = entry(*args, LAT, parity, policy="fused_halo")
    b = entry(*args, LAT, parity, policy="xla_facefix")
    assert all(torch.equal(p, q) for p, q in zip(a.blocks, b.blocks))
    got = _gather(a, xh).numpy()
    assert _nrel(got, fields["ref_eo"][parity]) < TOL
    assert _nrel(got, single(uh, other, psi, LAT, parity).numpy()) < TOL


@pytest.mark.parametrize("form", ["full", "r12"])
@pytest.mark.parametrize("version", [2, 3])
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: "x".join(map(str, g)))
def test_sharded_full_hop_matches_jax(fields, grid, version, form):
    """dslash_pallas_sharded (B4 interior) and _v3 (B10) on every grid:
    within 1e-6 of JAX's dslash_packed_pairs and of the port's B4."""
    mesh = _mesh(grid)
    X = LAT[3]
    g = _form(fields["g_full"], form)
    psi = fields["psi_full"]
    gbw = wpp.backward_gauge(g, X).contiguous()
    if version == 2:
        out = pds.dslash_pallas_sharded(_shard(g, mesh, X),
                                        _shard(gbw, mesh, X),
                                        _shard(psi, mesh, X), X,
                                        policy="fused_halo")
    else:
        out = pds.dslash_pallas_sharded_v3(_shard(g, mesh, X),
                                           _shard(psi, mesh, X), X,
                                           policy="fused_halo")
    got = _gather(out, X).numpy()
    assert _nrel(got, fields["ref_full"]) < TOL
    want = wpp.dslash_pallas_packed(g, psi, X, gauge_bw=gbw).numpy()
    assert _nrel(got, want) < TOL


def test_mesh_operator_matches_jax_pair_operator(fields):
    """MdagM_pairs on the (2,2,2,1) mesh against JAX's unsharded packed
    pair operator, within 1e-5 (JAX's test_pallas_sharded.py:226-255
    makes the same comparison against its sharded operator)."""
    x = fields["src"][1]
    jgeom = JGeom(DIMS)
    jop = JDiracWilsonPC(jnp.asarray(fields["g"].numpy()), jgeom,
                         kappa=KAPPA).packed().pairs(jnp.float32)
    want = np.asarray(jop.MdagM_pairs(jnp.asarray(x.numpy())))
    op = fields["dpk"].pairs(torch.float32, mesh=_mesh((2, 2, 2, 1)),
                             sharded_policy="fused_halo")
    got = op.gather(op.MdagM_pairs(op.shard(x))).numpy()
    assert _nrel(got, want) < 1e-5


@pytest.mark.parametrize("grid,form,version", [((2, 2, 1, 1), "full", 2),
                                               ((1, 1, 1, 2), "r12", 2),
                                               ((2, 2, 1, 1), "r12", 3)])
def test_mesh_fused_cg_takes_the_unsharded_iterations(fields, grid, form,
                                                      version):
    """fused_cg on the mesh operator: converged at tol 1e-6 within one
    iteration of the unsharded solve, the solution within 1e-5 of its,
    and its normal-equation residual by the unsharded operator below
    1e-5; the loop never gathers (x and r stay ShardedFields)."""
    dpk = fields["dpk"]
    pe, po = even_odd_split(fields["psi"], fields["geom"])
    op0 = dpk.pairs(torch.float32, form, version)
    rhs = op0.prepare_pairs(pe, po)
    b0 = op0.Mdag_pairs(rhs)
    ref = fused_cg(op0.MdagM_pairs, b0, tol=1e-6, maxiter=300)
    op = dpk.pairs(torch.float32, form, version, mesh=_mesh(grid),
                   sharded_policy="fused_halo")
    b = op.Mdag_pairs(op.shard(rhs))
    res = fused_cg(op.MdagM_pairs, b, tol=1e-6, maxiter=300)
    assert isinstance(res.x, qm.ShardedField)
    assert res.converged and abs(res.iters - ref.iters) <= 1
    x = op.gather(res.x)
    assert _nrel(x.numpy(), ref.x.numpy()) < 1e-5
    assert _nrel(op0.MdagM_pairs(x).numpy(), b0.numpy()) < 1e-5


def test_mesh_prepare_and_reconstruct_take_global_fields(fields):
    """prepare_pairs/reconstruct_pairs on the mesh operator shard and
    gather around their hop: equal to the unsharded operator's."""
    dpk = fields["dpk"]
    pe, po = even_odd_split(fields["psi"], fields["geom"])
    op0 = dpk.pairs(torch.float32)
    op = dpk.pairs(torch.float32, mesh=_mesh((2, 1, 1, 2)),
                   sharded_policy="xla_facefix")
    a, b = op.prepare_pairs(pe, po), op0.prepare_pairs(pe, po)
    assert isinstance(a, torch.Tensor) and _nrel(a.numpy(), b.numpy()) < TOL
    for u, v in zip(op.reconstruct_pairs(b, pe, po),
                    op0.reconstruct_pairs(b, pe, po)):
        assert _nrel(torch.view_as_real(u).numpy(),
                     torch.view_as_real(v).numpy()) < TOL


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_mesh_bf16_storage(fields, out_dtype):
    """bf16 storage on a mesh: the sharded hop within one bf16 rounding of
    the unsharded bf16 hop (the face fix rounds the corrected face once
    more, as the JAX package's _add_face_n does)."""
    dpk = fields["dpk"]
    op0 = dpk.pairs(torch.bfloat16)
    op = dpk.pairs(torch.bfloat16, mesh=_mesh((2, 2, 1, 1)),
                   sharded_policy="fused_halo")
    x = fields["src"][1].to(torch.bfloat16)
    want = op0._d_to(x, 0, out_dtype).float()
    got = op.gather(op._d_to(op.shard(x), 0, out_dtype))
    assert got.dtype == out_dtype
    err = float((got.float() - want).abs().max() / want.abs().max())
    assert err < (wpp.TOLERANCE_BF16 if out_dtype == torch.bfloat16
                  else TOL)


# -- the policy seam and the mesh checks, against JAX's ---------------------

POLICY_SPECS = ["xla_facefix", "fused_halo", "t=fused_halo,z=fused_halo",
                "t=fused_halo, y=fused_halo,", "z=xla_facefix",
                {"t": "fused_halo", "z": "xla_facefix"}]
BAD_POLICY_SPECS = ["auto", "nope", "x=fused_halo", "w=fused_halo",
                    "t=ppermute"]


def test_policy_resolution_matches_jax():
    for spec in POLICY_SPECS:
        got = pds.resolve_axis_policies(spec)
        assert got == jpds.resolve_axis_policies(spec), spec
        for live in (("t",), ("t", "z"), ("t", "z", "y", "x"), ()):
            assert pds._policy_label(got, live) == \
                jpds._policy_label(got, live)
    for spec in BAD_POLICY_SPECS:
        with pytest.raises(ValueError):
            jpds.resolve_axis_policies(spec)
        with pytest.raises(ValueError):
            pds.resolve_axis_policies(spec)
    assert pds.SHARDED_POLICIES == jpds.SHARDED_POLICIES
    assert pds.FUSED_HALO_AXES == jpds.FUSED_HALO_AXES


class _JaxMeshShape:
    """What JAX's mesh checks read of a mesh: its axis sizes."""

    def __init__(self, grid):
        self.shape = dict(zip(("t", "z", "y", "x"), grid))


@pytest.mark.parametrize("tz_only", [False, True])
def test_eo_mesh_checks_match_jax(tz_only):
    """The port's mesh accepts and refuses what JAX's _check_eo_mesh does,
    with the same local extents."""
    cases = [((2, 2, 2, 1), (4, 4, 4, 8)), ((2, 1, 1, 2), (4, 4, 4, 8)),
             ((2, 1, 1, 1), (6, 4, 4, 8)), ((1, 2, 1, 1), (4, 6, 4, 8)),
             ((1, 1, 2, 1), (4, 4, 6, 8)), ((1, 1, 1, 4), (4, 4, 4, 8)),
             ((1, 1, 1, 3), (4, 4, 4, 8)), ((2, 2, 1, 1), (8, 4, 4, 8))]
    for grid, lat in cases:
        T, Z, Y, X = lat
        if T % grid[0] or Z % grid[1] or Y % grid[2] or (X // 2) % grid[3]:
            loc = (4, 3, 2, T // grid[0], Z // grid[1], 1)
        else:
            loc = (4, 3, 2, T // grid[0], Z // grid[1],
                   (Y // grid[2]) * (X // 2 // grid[3]))
        try:
            want = jpds._check_eo_mesh("hop", _JaxMeshShape(grid),
                                       np.zeros(loc), lat, False, tz_only)
        except ValueError:
            want = None
        mesh = _mesh(grid)
        if want is None:
            with pytest.raises(ValueError):
                pds._check_eo_mesh("hop", mesh, loc, lat, False, tz_only)
        else:
            assert pds._check_eo_mesh("hop", mesh, loc, lat, False,
                                      tz_only) == want


# -- what the mesh route refuses ---------------------------------------------

def test_mesh_route_refusals(fields):
    dpk = fields["dpk"]
    mesh = _mesh((2, 1, 1, 1))
    for form in ("r12f", "int8", "fold"):
        with pytest.raises(NotImplementedError, match="A15"):
            dpk.pairs(torch.float32, form, mesh=mesh)
    with pytest.raises(NotImplementedError, match="A7"):
        dpk.pairs(torch.float64, mesh=mesh)
    with pytest.raises(NotImplementedError, match="A15"):
        dpk.pairs(torch.float32,
                  mesh=qm.make_lattice_mesh((2, 1, 1, 1), 2,
                                            devices=["cpu"] * 4))
    with pytest.raises(ValueError, match="x faces"):
        dpk.pairs(torch.float32, mesh=_mesh((1, 1, 1, 2)),
                  sharded_policy="x=fused_halo")
    with pytest.raises(ValueError, match="even"):
        DiracWilsonPC(fields["g"], fields["geom"], KAPPA).packed().pairs(
            torch.float32, mesh=_mesh((4, 1, 1, 1)))
    op = dpk.pairs(torch.float32, mesh=mesh, sharded_policy="xla_facefix")
    x = op.shard(fields["src"][0])
    with pytest.raises(NotImplementedError, match="A15"):
        op.M_pairs_mrhs(fields["src"][0][None])
    from quda_tpu_torch.solvers.mixed import cg_reliable, pair_inplace_codec
    with pytest.raises(NotImplementedError, match="A15"):
        cg_reliable(op.MdagM_pairs, op.MdagM_pairs, x,
                    pair_inplace_codec(torch.float32))
    with pytest.raises(TypeError, match="ShardedField"):
        pds.dslash_eo_pallas_sharded(op.gauge_eo_pp[0], op._u_bw[0],
                                     fields["src"][0], LAT, 0)


def test_mesh_route_clamps_and_escapes(fields):
    """v3 on a y/x-partitioned mesh clamps to v2 (as the JAX package
    does); a mesh of one sub-domain shards nothing."""
    dpk = fields["dpk"]
    op = dpk.pairs(torch.float32, "full", 3, mesh=_mesh((1, 1, 2, 1)),
                   sharded_policy="xla_facefix")
    assert op._pallas_version == 2 and op._mesh is not None
    op1 = dpk.pairs(torch.float32, mesh=_mesh((1, 1, 1, 1)))
    assert op1._mesh is None


def test_auto_policy_races_each_partitioned_axis(fields, monkeypatch):
    """sharded_policy="auto" races nothing: it is fused_halo, the exchange
    kernel on every partitioned t/z/y axis (its plain version on CPU
    blocks) and xla_facefix on x; utils/tune.py caches no winner, the hop
    is bit for bit the pinned xla_facefix one, and an exchange kernel that
    raises fails the hop."""
    monkeypatch.setattr(tune, "_cache", {})
    dpk = fields["dpk"]
    want = {"t": "fused_halo", "z": "fused_halo", "y": "fused_halo",
            "x": "xla_facefix"}
    for grid in ((2, 1, 1, 2), (2, 2, 2, 1)):
        op = dpk.pairs(torch.float32, mesh=_mesh(grid))
        assert op._sharded_policy == want == pds.resolve_axis_policies(
            "fused_halo")
        pinned = dpk.pairs(torch.float32, mesh=_mesh(grid),
                           sharded_policy="xla_facefix")
        x = op.shard(fields["src"][0])
        a, b = op._d_to(x, 0, None), pinned._d_to(x, 0, None)
        assert all(torch.equal(p, q) for p, q in zip(a.blocks, b.blocks))
    assert tune._cache == {}

    def broken(*args, **kwargs):
        raise RuntimeError("exchange kernel failed")

    monkeypatch.setattr(ph, "slab_exchange_bidir", broken)
    op = dpk.pairs(torch.float32, mesh=_mesh((2, 1, 1, 1)))
    with pytest.raises(RuntimeError, match="exchange kernel failed"):
        op._d_to(op.shard(fields["src"][0]), 0, None)


# -- JAX's own sharded hops (shard_map, interpret mode) ---------------------

@pytest.mark.slow
@pytest.mark.parametrize("policy", ["xla_facefix", "fused_halo"])
def test_port_matches_jax_sharded_eo_hop(fields, policy):
    """JAX's dslash_eo_pallas_sharded under shard_map on 4 of its virtual
    CPU devices (the B1 interior in interpret mode; fused_halo runs its
    exchange kernel in the distributed interpreter) against the port's,
    on the (2,2,1,1) grid."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from quda_tpu.parallel import compat
    from quda_tpu.parallel.mesh import make_lattice_mesh
    if policy == "fused_halo" and not compat.has_dist_interpret():
        pytest.skip("no distributed Mosaic interpreter in this jax version")
    from quda_tpu.ops import wilson_pallas_packed as jwpp
    grid, parity = (2, 2, 1, 1), 1
    jm = make_lattice_mesh(grid=grid, devices=jax.devices()[:4])
    uh = jnp.asarray(fields["g_eo"][parity].numpy())
    ub = jwpp.backward_gauge_eo(jnp.asarray(fields["g_eo"][0].numpy()), LAT,
                                parity)
    x = jnp.asarray(fields["src"][parity].numpy())
    gspec = P(None, None, None, None, "t", "z", None)
    pspec = P(None, None, None, "t", "z", None)
    fn = compat.shard_map(
        lambda a, b, c: jpds.dslash_eo_pallas_sharded(
            a, b, c, LAT, parity, jm, interpret=True, policy=policy),
        mesh=jm, in_specs=(gspec, gspec, pspec), out_specs=pspec)
    want = np.asarray(jax.jit(fn)(
        jax.device_put(uh, NamedSharding(jm, gspec)),
        jax.device_put(ub, NamedSharding(jm, gspec)),
        jax.device_put(x, NamedSharding(jm, pspec))))
    mesh = _mesh(grid)
    xh = LAT[3] // 2
    ub_t = wpp.backward_gauge_eo(fields["g_eo"][0], LAT, parity).contiguous()
    got = pds.dslash_eo_pallas_sharded(
        _shard(fields["g_eo"][parity], mesh, xh), _shard(ub_t, mesh, xh),
        _shard(fields["src"][parity], mesh, xh), LAT, parity, policy=policy)
    assert _nrel(_gather(got, xh).numpy(), want) < TOL
