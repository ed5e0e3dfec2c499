"""The port's mesh of sub-domains (quda_tpu_torch/parallel/mesh.py) and
its halo module (parallel/halo.py), against the JAX package's
quda_tpu/parallel/mesh.py and the unsharded operations.

numpy seeds 541-559.  JAX's functions here are pure Python or numpy
(factor_devices, fuse_block_layout on numpy arrays, local_extents on
JAX's 8-device CPU mesh), so the file runs in seconds.
"""

import numpy as np
import pytest
import torch

from quda_tpu.parallel import mesh as jmesh
from quda_tpu_torch.ops import blas
from quda_tpu_torch.ops.shift import shift
from quda_tpu_torch.parallel import halo
from quda_tpu_torch.parallel import mesh as qm

from tests.torch_inputs import gaussian, one_torch_thread  # noqa: F401


def _cpu_mesh(grid, n_src=1):
    return qm.make_lattice_mesh(grid, n_src,
                                devices=["cpu"] * (n_src * int(np.prod(grid))))


@pytest.mark.parametrize("ndim", [2, 3, 4])
def test_factor_devices_matches_jax(ndim):
    for n in range(1, 65):
        assert qm.factor_devices(n, ndim) == jmesh.factor_devices(n, ndim), n


@pytest.mark.parametrize("n_y,n_x,Y,xcols", [(1, 2, 4, 8), (2, 2, 4, 8),
                                              (2, 4, 6, 8), (3, 2, 6, 4),
                                              (1, 1, 4, 4)])
def test_fuse_block_layout_matches_jax(n_y, n_x, Y, xcols):
    a = gaussian((3, 2, Y * xcols), 541, np.float32)
    want = jmesh.fuse_block_layout(a, n_y, n_x, Y, xcols)
    got = qm.fuse_block_layout(torch.from_numpy(a), n_y, n_x, Y, xcols)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(qm.fuse_block_layout(a, n_y, n_x, Y, xcols), want)
    back = qm.unfuse_block_layout(got, n_y, n_x, Y, xcols)
    assert np.array_equal(back.numpy(), a)
    assert np.array_equal(
        jmesh.unfuse_block_layout(want, n_y, n_x, Y, xcols), a)


def test_fuse_block_layout_blocks_are_rectangles():
    """Chunk (i, j) of the fused layout is rows i*Y_loc.. x columns
    j*X_loc.. of the natural layout, row-major in the local width."""
    Y, X, n_y, n_x = 4, 8, 2, 2
    a = torch.arange(Y * X)
    f = qm.fuse_block_layout(a, n_y, n_x, Y, X).reshape(n_y * n_x, -1)
    nat = a.reshape(Y, X)
    for i in range(n_y):
        for j in range(n_x):
            want = nat[i * 2:(i + 1) * 2, j * 4:(j + 1) * 4].reshape(-1)
            assert torch.equal(f[i * n_x + j], want)


@pytest.mark.parametrize("grid", [(2, 2, 2, 1), (1, 2, 2, 2), (8, 1, 1, 1),
                                  (2, 1, 1, 4)])
def test_local_extents_match_jax(grid):
    jm = jmesh.make_lattice_mesh(grid=grid)
    for lat in ((8, 8, 8, 8), (16, 8, 4, 8)):
        assert qm.local_extents(_cpu_mesh(grid), lat) == \
            jmesh.local_extents(jm, lat)
    with pytest.raises(ValueError):
        jmesh.local_extents(jm, (3, 3, 3, 3))
    with pytest.raises(ValueError):
        qm.local_extents(_cpu_mesh(grid), (3, 3, 3, 3))


def test_make_lattice_mesh():
    m = qm.make_lattice_mesh(devices=["cpu"] * 8)
    assert m.grid == jmesh.factor_devices(8) and m.n_src == 1
    assert m.size == 8 and m.device_type == "cpu"
    assert m.distinct_devices() == (torch.device("cpu"),)
    m2 = qm.make_lattice_mesh((2, 1, 1, 1), 2, devices=["cpu"] * 4)
    assert m2.dims == (2, 2, 1, 1, 1)
    assert m2.coords(3) == (1, 1, 0, 0, 0)
    assert m2.index((1, 1, 0, 0, 0)) == 3
    assert m2.neighbor(2, "t", +1) == 3 and m2.neighbor(3, "t", +1) == 2
    assert m2.neighbor(0, "src", -1) == 2
    with pytest.raises(ValueError, match="devices"):
        qm.make_lattice_mesh((2, 2, 1, 1), devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="grid"):
        qm.make_lattice_mesh((2, 2, 1), devices=["cpu"] * 4)


def test_mesh_refuses_mixed_and_unknown_devices():
    with pytest.raises(ValueError, match="mix"):
        qm.make_lattice_mesh((2, 1, 1, 1), devices=["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="unsupported"):
        qm.make_lattice_mesh((1, 1, 1, 1), devices=["meta"])


def test_default_mesh_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        qm.make_lattice_mesh((2, 1, 1, 1))


@pytest.mark.parametrize("grid,n_src", [((2, 2, 2, 1), 1), ((1, 2, 1, 2), 1),
                                        ((2, 1, 1, 1), 2)])
def test_shard_gather_round_trip(grid, n_src):
    """Shard then gather is exact for the canonical spinor and gauge specs,
    a batched spinor on the src axis and the packed pair spec with the
    block-contiguous y/x cut; blocks are contiguous and sized as
    local_extents says."""
    mesh = _cpu_mesh(grid, n_src)
    lat = (4, 4, 4, 8)
    loc = qm.local_extents(mesh, lat)
    psi = torch.from_numpy(gaussian(lat + (4, 3), 542))
    sf = qm.shard_spinor(psi, mesh)
    assert sf.local_shape == loc + (4, 3) and sf.shape == psi.shape
    assert all(b.is_contiguous() for b in sf.blocks)
    assert torch.equal(qm.gather(sf), psi)
    g = torch.from_numpy(gaussian((4,) + lat + (3, 3), 543))
    assert torch.equal(qm.gather(qm.shard_gauge(g, mesh)), g)
    batch = torch.from_numpy(gaussian((2 * n_src,) + lat + (4, 3), 544))
    assert torch.equal(qm.gather(qm.shard_spinor(batch, mesh, batched=True)),
                       batch)
    T, Z, Y, X = lat
    n_y, n_x = grid[2], grid[3]
    pp = torch.from_numpy(gaussian((4, 3, 2, T, Z, Y * X), 545, np.float32))
    fused = qm.fuse_block_layout(pp, n_y, n_x, Y, X)
    sp = qm.shard(fused, mesh, qm.pair_pspec(6))
    # each block holds whole local rows of its (y, x) rectangle
    c = mesh.coords(mesh.size - 1)
    t_l, z_l, y_l, x_l = loc
    want = pp.reshape(4, 3, 2, T, Z, Y, X)[
        ..., c[1] * t_l:(c[1] + 1) * t_l, c[2] * z_l:(c[2] + 1) * z_l,
        c[3] * y_l:(c[3] + 1) * y_l, c[4] * x_l:(c[4] + 1) * x_l]
    assert torch.equal(sp.blocks[-1], want.reshape(4, 3, 2, t_l, z_l, -1))
    assert torch.equal(qm.unfuse_block_layout(qm.gather(sp), n_y, n_x, Y, X),
                       pp)


def test_shard_refuses_an_uneven_cut_and_unknown_axes():
    mesh = _cpu_mesh((2, 1, 1, 1))
    with pytest.raises(ValueError, match="divisible"):
        qm.shard(torch.zeros(3, 4), mesh, ("t",))
    with pytest.raises(ValueError, match="unknown mesh axis"):
        qm.shard(torch.zeros(4, 4), mesh, ("w",))


def test_sharded_field_arithmetic_is_blockwise():
    mesh = _cpu_mesh((2, 2, 1, 1))
    a = torch.from_numpy(gaussian((4, 4, 3), 546, np.float32))
    b = torch.from_numpy(gaussian((4, 4, 3), 547, np.float32))
    spec = ("t", "z")
    sa, sb = qm.shard(a, mesh, spec), qm.shard(b, mesh, spec)
    s = torch.tensor(0.5)
    for got, want in ((sa + sb, a + b), (sa - sb, a - b), (s * sa, s * a),
                      (sa * 2.0, a * 2.0), (sb - s, b - s), (s + sa, s + a),
                      (s - sa, s - a),
                      (sa.to(torch.float64), a.to(torch.float64)),
                      (sa.zeros_like(), torch.zeros_like(a))):
        assert torch.equal(qm.gather(got), want)
    assert sa.shape == (4, 4, 3) and sa.local_shape == (2, 2, 3)
    assert sa.ndim == 3 and not sa.is_complex()
    with pytest.raises(ValueError, match="different"):
        _ = sa + qm.shard(a, mesh, ("z", "t"))
    with pytest.raises(ValueError, match="stay on"):
        sa.to("cpu")


def test_reductions_on_a_sharded_field():
    """norm2 and redot run per block and psum_scalar adds the partials in
    sub-domain order."""
    mesh = _cpu_mesh((2, 2, 2, 1))
    a = torch.from_numpy(gaussian((4, 3, 2, 4, 4, 8), 548, np.float64))
    b = torch.from_numpy(gaussian((4, 3, 2, 4, 4, 8), 549, np.float64))
    sa, sb = (qm.shard(x, mesh, qm.pair_pspec(6)) for x in (a, b))
    parts = [torch.sum(x * x) for x in sa.blocks]
    want = parts[0]
    for p in parts[1:]:
        want = want + p
    assert torch.equal(blas.norm2(sa), want)
    assert torch.equal(halo.psum_scalar(parts), want)
    assert abs(float(blas.redot(sa, sb)) - float(torch.sum(a * b))) < 1e-10
    assert abs(float(blas.norm2(sa)) - float(blas.norm2(a))) < 1e-10
    assert torch.equal(qm.gather(blas.zeros_like(sa)), torch.zeros_like(a))


@pytest.mark.parametrize("grid", [(2, 2, 1, 2), (1, 2, 2, 1)])
def test_sharded_shift_matches_the_global_shift(grid):
    """make_sharded_shift: local roll plus the neighbour's faces equals
    ops.shift.shift on the global field, every direction, both signs,
    nhop 1 and 2."""
    mesh = _cpu_mesh(grid)
    f = torch.from_numpy(gaussian((4, 4, 4, 4, 4, 3), 550))
    sf = qm.shard_spinor(f, mesh)
    sh = halo.make_sharded_shift(mesh)
    for mu in range(4):
        for sign in (+1, -1):
            for nhop in (1, 2):
                got = qm.gather(sh(sf, mu, sign, nhop))
                assert torch.equal(got, shift(f, mu, sign, nhop)), \
                    (mu, sign, nhop)


def test_permute_slice_rotates_along_one_axis():
    mesh = _cpu_mesh((2, 4, 1, 1))
    faces = [torch.full((2,), float(i)) for i in range(8)]
    down = halo._permute_slice(faces, mesh, "z", towards_lower=True)
    up = halo._permute_slice(faces, mesh, "z", towards_lower=False)
    for i in range(8):
        assert float(down[i][0]) == mesh.neighbor(i, "z", +1)
        assert float(up[i][0]) == mesh.neighbor(i, "z", -1)
        assert down[i] is not faces[mesh.neighbor(i, "z", +1)]
