"""The halo kernels' plain versions (quda_tpu_torch/parallel/pallas_halo.
py, B12) against the JAX package's composed references
(quda_tpu/parallel/pallas_halo.py), and the exchange's transport.

On the CPU the wrappers run their plain versions: the TPU kernels'
algorithm with the boundary strips carried by ``_permute_slice``.  numpy
seeds 561-579.  The JAX composed references are computed once per form
(a module fixture) and each mesh of 2, 4 and 8 sub-domains is held to
them within 1e-6 (f32).  The ``slow`` tests run JAX's own fused-halo
kernels in interpret mode with the distributed interpreter, at the
smallest size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quda_tpu.parallel import compat
from quda_tpu.parallel import pallas_halo as jph
from quda_tpu_torch.parallel import mesh as qm
from quda_tpu_torch.parallel import pallas_halo as ph

from tests.torch_inputs import gaussian, one_torch_thread, rel_err  # noqa: F401

F32 = np.float32
# (axis, mu, sites): the z form (4,3,2,Z,YX) and the t form (4,3,2,T,Z,YX)
FORMS = {"z": (2, (16, 12)), "t": (3, (16, 4, 6))}


def _grid(ax, n):
    return (1, n, 1, 1) if ax == "z" else (n, 1, 1, 1)


def _spec(ax, rank):
    return (None, None, None, ax) + (None,) * (rank - 4)


def _inputs(ax):
    mu, sites = FORMS[ax]
    psi = gaussian((4, 3, 2) + sites, 561 + mu, F32)
    u = gaussian((3, 3, 2) + sites, 563 + mu, F32)
    return mu, psi, u


@pytest.fixture(scope="module")
def jax_refs():
    """JAX's composed references, one per form: both hops (z and t) and
    the backward z hop."""
    out = {}
    for ax in FORMS:
        mu, psi, u = _inputs(ax)
        out[ax] = np.asarray(jph.wilson_axis_composed(jnp.asarray(psi),
                                                      jnp.asarray(u), mu))
    _, psi, u = _inputs("z")
    out["zbwd"] = np.asarray(jph.wilson_zbwd_composed(jnp.asarray(psi),
                                                      jnp.asarray(u)))
    return out


def _sharded(ax, n):
    mu, psi, u = _inputs(ax)
    mesh = qm.make_lattice_mesh(_grid(ax, n), devices=["cpu"] * n)
    spec = _spec(ax, psi.ndim)
    return (mu, qm.shard(torch.from_numpy(psi), mesh, spec),
            qm.shard(torch.from_numpy(u), mesh, spec))


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("ax", ["z", "t"])
def test_axis_fused_halo_plain_matches_jax_composed(jax_refs, ax, n):
    mu, ps, us = _sharded(ax, n)
    fn = ph.wilson_z_fused_halo if ax == "z" else ph.wilson_t_fused_halo
    got = qm.gather(fn(ps, us))
    assert rel_err(got.numpy(), jax_refs[ax]) < ph.TOLERANCE
    assert fn is ph.wilson_z_fused_halo or mu == 3


@pytest.mark.parametrize("n", [2, 4, 8])
def test_zbwd_fused_halo_plain_matches_jax_composed(jax_refs, n):
    _, ps, us = _sharded("z", n)
    got = qm.gather(ph.wilson_zbwd_fused_halo(ps, us))
    assert rel_err(got.numpy(), jax_refs["zbwd"]) < ph.TOLERANCE


def test_composed_references_match_jax(jax_refs):
    for ax in FORMS:
        mu, psi, u = _inputs(ax)
        got = ph.wilson_axis_composed(torch.from_numpy(psi),
                                      torch.from_numpy(u), mu)
        assert rel_err(got.numpy(), jax_refs[ax]) < 1e-6
    _, psi, u = _inputs("z")
    got = ph.wilson_zbwd_composed(torch.from_numpy(psi), torch.from_numpy(u))
    assert rel_err(got.numpy(), jax_refs["zbwd"]) < 1e-6
    assert torch.equal(
        ph.wilson_z_composed(torch.from_numpy(psi), torch.from_numpy(u)),
        ph.wilson_axis_composed(torch.from_numpy(psi), torch.from_numpy(u)))


def test_fused_halo_on_one_sub_domain_is_the_composed_hop():
    """A ring of one: both neighbours are the sub-domain itself, so the
    plain version is the periodic composed hop."""
    mu, psi, u = _inputs("t")
    mesh = qm.make_lattice_mesh((1, 1, 1, 1), devices=["cpu"])
    spec = _spec("t", psi.ndim)
    got = ph.wilson_t_fused_halo(qm.shard(torch.from_numpy(psi), mesh, spec),
                                 qm.shard(torch.from_numpy(u), mesh, spec))
    want = ph.wilson_t_composed(torch.from_numpy(psi), torch.from_numpy(u))
    assert rel_err(qm.gather(got).numpy(), want.numpy()) < 1e-6


def test_slab_exchange_is_two_permutes():
    """slab_exchange_bidir on CPU blocks: from_up[i] = send_down[i + 1],
    from_down[i] = send_up[i - 1] along the axis, each a fresh copy."""
    mesh = qm.make_lattice_mesh((2, 2, 2, 1), devices=["cpu"] * 8)
    down = [torch.full((3, 5), float(i)) for i in range(8)]
    up = [torch.full((3, 5), 100.0 + i) for i in range(8)]
    for ax in ("t", "z", "y"):
        from_up, from_down = ph.slab_exchange_bidir(down, up, mesh, ax)
        for i in range(8):
            assert torch.equal(from_up[i], down[mesh.neighbor(i, ax, +1)])
            assert torch.equal(from_down[i], up[mesh.neighbor(i, ax, -1)])
            assert from_up[i].data_ptr() != down[
                mesh.neighbor(i, ax, +1)].data_ptr()
    with pytest.raises(ValueError, match="one slab per sub-domain"):
        ph.slab_exchange_bidir(down[:4], up, mesh, "t")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_face_runs_read_every_face_in_place(dtype):
    """face_runs, the exchange kernel's view of a face: the runs it names,
    read from the block's bytes, are the face's bytes in row-major order,
    for the t and z planes, the y row strips and the x columns of a
    (2,2,2,2)-mesh block as the sharded hop cuts them; a view that is
    not evenly strided runs raises."""
    from quda_tpu_torch.parallel import pallas_dslash as pds
    block = torch.from_numpy(gaussian((4, 3, 2, 4, 6, 5 * 3), 571,
                                      F32)).to(dtype)
    raw = block.reshape(-1).view(torch.uint8).numpy()
    for fio, name, _, _ in pds._axis_plan((2, 2, 2, 2), 3):
        for lo in (True, False):
            face = fio.face(block, lo=lo)
            run, runs, stride = ph.face_runs(face)
            off = (face.data_ptr() - block.data_ptr())
            got = np.concatenate([raw[off + r * stride:off + r * stride + run]
                                  for r in range(runs)])
            want = face.contiguous().reshape(-1).view(torch.uint8).numpy()
            assert np.array_equal(got, want), (name, lo)
    assert ph.face_runs(block) == (block.numel() * block.element_size(),
                                   1, block.numel() * block.element_size())
    with pytest.raises(ValueError, match="evenly strided"):
        ph.face_runs(block.transpose(3, 4).narrow(3, 0, 2))


def test_fused_halo_entries_check_their_fields():
    mu, ps, us = _sharded("z", 2)
    with pytest.raises(ValueError, match="mu"):
        ph.wilson_axis_fused_halo(ps, us, mu=1)
    with pytest.raises(ValueError, match="rank"):
        ph.wilson_axis_fused_halo(ps, us, mu=3, axis_name="z")
    with pytest.raises(ValueError, match="axis 3"):
        ph.wilson_axis_fused_halo(ps, us, mu=2, axis_name="t")
    with pytest.raises(ValueError, match="links"):
        ph.wilson_axis_fused_halo(us, us)


# -- JAX's own kernels (interpret mode, distributed interpreter) -----------

needs_dist_interpret = pytest.mark.skipif(
    not compat.has_dist_interpret(),
    reason="no distributed Mosaic interpreter (pltpu.InterpretParams) in "
           "this jax version")


@pytest.mark.slow
@needs_dist_interpret
@pytest.mark.parametrize("kind", ["zbwd", "bidir"])
def test_plain_matches_jax_fused_halo_kernels(kind):
    """JAX's fused-halo Pallas kernels on its 8-device CPU mesh (interpret
    mode with cross-device DMA emulation) against the port's plain
    versions on 8 sub-domains, at the smallest size JAX's own tests use
    (Z 16, YX 16: a local z extent of 2, interior and ghost rows live)."""
    from jax.sharding import Mesh
    Z, YX = 16, 16
    psi = gaussian((4, 3, 2, Z, YX), 571, F32)
    uz = gaussian((3, 3, 2, Z, YX), 572, F32)
    jm = Mesh(np.array(jax.devices()[:8]).reshape(8), ("z",))
    if kind == "zbwd":
        want = jph.wilson_zbwd_fused_halo(jnp.asarray(psi), jnp.asarray(uz),
                                          jm, interpret=True)
    else:
        want = jph.wilson_z_fused_halo(jnp.asarray(psi), jnp.asarray(uz), jm,
                                       interpret=True)
    mesh = qm.make_lattice_mesh((1, 8, 1, 1), devices=["cpu"] * 8)
    spec = _spec("z", 5)
    ps = qm.shard(torch.from_numpy(psi), mesh, spec)
    us = qm.shard(torch.from_numpy(uz), mesh, spec)
    got = (ph.wilson_zbwd_fused_halo(ps, us) if kind == "zbwd"
           else ph.wilson_z_fused_halo(ps, us))
    assert rel_err(qm.gather(got).numpy(), np.asarray(want)) < ph.TOLERANCE
