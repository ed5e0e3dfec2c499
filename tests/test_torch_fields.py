"""Port parity: fields, layouts and conversions (quda_tpu vs quda_tpu_torch).

The same numpy inputs go through the JAX functions and their port; index
permutations must agree exactly.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quda_tpu.fields.geometry import LatticeGeometry as JGeom
from quda_tpu.fields import spinor as jsp
from quda_tpu.ops import shift as jshift
from quda_tpu.ops import wilson_packed as jwpk
from quda_tpu_torch.fields.gauge import GaugeField
from quda_tpu_torch.fields.geometry import LatticeGeometry
from quda_tpu_torch.fields import spinor as tsp
from quda_tpu_torch.ops import shift as tshift
from quda_tpu_torch.ops import su3 as tsu3
from quda_tpu_torch.ops import wilson as twil
from quda_tpu_torch.ops import wilson_packed as twpk
from quda_tpu_torch.utils import convert

from tests.torch_inputs import (ASYM, SMALL, gaussian, lattice_shape,
                                noisy_gauge, pair_spinor_shape)
from tests.torch_inputs import one_torch_thread  # noqa: F401 (autouse)


def test_geometry_orders():
    geom = LatticeGeometry((4, 4, 4, 8))
    assert geom.lattice_shape == (8, 4, 4, 4)
    assert geom.half_lattice_shape == (8, 4, 4, 2)
    assert geom.volume == JGeom((4, 4, 4, 8)).volume


def test_even_odd_split_join_matches_jax():
    psi = gaussian(lattice_shape(ASYM) + (4, 3), seed=1)
    je, jo = jsp.even_odd_split(jnp.asarray(psi), JGeom(ASYM))
    geom = LatticeGeometry(ASYM)
    te, to = tsp.even_odd_split(torch.from_numpy(psi), geom)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(
        tsp.even_odd_join(te, to, geom).numpy(), psi)


@pytest.mark.parametrize("dims", [SMALL, ASYM])
def test_even_odd_parity_layout(dims):
    """Element (t,z,y,xh) of the parity-p half holds x = 2xh + (t+z+y+p)%2,
    and the links split per direction the same way."""
    geom = LatticeGeometry(dims)
    T, Z, Y, X = geom.lattice_shape
    t, z, y, x = torch.meshgrid(*(torch.arange(n) for n in (T, Z, Y, X)),
                                indexing="ij")
    coords = torch.stack([t, z, y, x], dim=-1)
    halves = tsp.even_odd_split(coords, geom)
    for p, half in enumerate(halves):
        tt, zz, yy, xx = half.unbind(-1)
        assert torch.equal((tt + zz + yy + xx) % 2, torch.full_like(xx, p))
        xh = torch.arange(X // 2).expand_as(xx)
        assert torch.equal(xx, 2 * xh + (tt + zz + yy + p) % 2)
    g = torch.from_numpy(noisy_gauge(dims, seed=10))
    ge, go = twil.split_gauge_eo(g, geom)
    assert torch.equal(ge[2], tsp.even_odd_split(g[2], geom)[0])
    assert torch.equal(go[3], tsp.even_odd_split(g[3], geom)[1])


@pytest.mark.parametrize("dims", [SMALL, ASYM])
def test_pack_and_pairs_match_jax(dims):
    T, Z, Y, X = lattice_shape(dims)
    psi = gaussian((T, Z, Y, X // 2, 4, 3), seed=2)
    g = noisy_gauge(dims, seed=3)
    jp = jwpk.to_packed_pairs(jwpk.pack_spinor(jnp.asarray(psi)),
                              jnp.float32)
    tp = twpk.to_packed_pairs(twpk.pack_spinor(torch.from_numpy(psi)),
                              torch.float32)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert tuple(tp.shape) == pair_spinor_shape(dims)
    back = twpk.unpack_spinor(twpk.from_packed_pairs(tp),
                              (T, Z, Y, X // 2))
    np.testing.assert_array_equal(back.numpy(), psi)
    jg = jwpk.pack_gauge(jnp.asarray(g))
    tg = twpk.pack_gauge(torch.from_numpy(g))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(
        twpk.unpack_gauge(tg, (T, Z, Y, X)).numpy(), g)


@pytest.mark.parametrize("mu", [0, 1, 2, 3])
@pytest.mark.parametrize("sign", [+1, -1])
def test_shift_eo_packed_matches_jax(mu, sign):
    """One, two and three hops (the x slot roll and the slot-parity
    flip), both target parities, packed and canonical half layouts."""
    dims = lattice_shape(ASYM)
    arr = gaussian(pair_spinor_shape(ASYM), seed=4, dtype=np.float32)
    half = gaussian(JGeom(ASYM).half_spinor_shape(), seed=5)
    for parity, nhop in itertools.product((0, 1), (1, 2, 3)):
        ref = jwpk.shift_eo_packed(jnp.asarray(arr), dims, mu, sign, parity,
                                   nhop)
        got = twpk.shift_eo_packed(torch.from_numpy(arr), dims, mu, sign,
                                   parity, nhop)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        ref = jshift.shift_eo(jnp.asarray(half), JGeom(ASYM), mu, sign,
                              parity, nhop)
        got = tshift.shift_eo(torch.from_numpy(half), LatticeGeometry(ASYM),
                              mu, sign, parity, nhop)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_convert_round_trips():
    dims = ASYM
    g = noisy_gauge(dims, seed=5)
    tg = convert.gauge_from_host(g, device="cpu")
    assert tg.dtype == torch.complex64
    np.testing.assert_array_equal(tg.numpy(), g)
    psi = gaussian(lattice_shape(dims) + (4, 3), seed=6,
                   dtype=np.complex128)
    ts = convert.spinor_from_host(psi, device="cpu", dtype=torch.complex64)
    np.testing.assert_array_equal(ts.numpy(), psi.astype(np.complex64))
    pp = gaussian(pair_spinor_shape(dims), seed=7, dtype=np.float32)
    np.testing.assert_array_equal(
        convert.pairs_to_numpy(convert.pairs_from_numpy(pp, "cpu")), pp)
    with pytest.raises(ValueError):
        convert.gauge_from_host(psi, device="cpu")


def test_expm_and_random_su3():
    """exp(iH) against the eigendecomposition V exp(i diag) V^dag, and
    random links in SU(3)."""
    rng = np.random.default_rng(8)
    h = tsu3.random_hermitian_traceless(rng, (5,), device="cpu")
    w, v = np.linalg.eigh(0.7 * h.numpy())
    want = np.einsum("nab,nb,ncb->nac", v, np.exp(1j * w), v.conj())
    np.testing.assert_allclose(tsu3.expm_su3(0.7 * h).numpy(), want,
                               rtol=0, atol=1e-13)
    u = GaugeField.random(LatticeGeometry(SMALL), np.random.default_rng(9),
                          device="cpu").data
    eye = torch.eye(3, dtype=u.dtype)
    assert float((u @ tsu3.dagger(u) - eye).abs().max()) < 1e-12
    assert float((torch.linalg.det(u) - 1).abs().max()) < 1e-12


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    geom = LatticeGeometry(SMALL)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GaugeField.unit(geom)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.gauge_from_host(noisy_gauge(SMALL, seed=1))
    assert GaugeField.unit(geom, device="cpu").data.device.type == "cpu"
