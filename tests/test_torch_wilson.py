"""Port parity: the Wilson stencils and the Schur operator.

quda_tpu_torch against quda_tpu on the same numpy inputs (float32 pair
layout, rtol 1e-5: both sum the same f32 terms, possibly in another
order), and the canonical complex128 stencil against the numpy site-loop
oracle (1e-12).  The CUDA kernel is held to its plain version on the card
in test_torch_cuda.py, and through the spin tables it carries, here.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quda_tpu.fields.geometry import LatticeGeometry as JGeom
from quda_tpu.models.wilson import DiracWilsonPC as JDiracWilsonPC
from quda_tpu.models.wilson import DiracWilsonPCPacked as JDiracWilsonPCPacked
from quda_tpu.ops import wilson_packed as jwpk
from quda_tpu.ops import wilson_pallas_packed as jwpp
from quda_tpu_torch.fields.geometry import LatticeGeometry
from quda_tpu_torch.fields.spinor import even_odd_join, even_odd_split
from quda_tpu_torch.models.wilson import (DiracWilson, DiracWilsonPC,
                                          DiracWilsonPCPacked)
from quda_tpu_torch.ops import wilson as twil
from quda_tpu_torch.ops import wilson_packed as twpk
from quda_tpu_torch.ops import wilson_pallas_packed as twpp
from quda_tpu_torch.ops.boundary import apply_t_boundary
from quda_tpu_torch.ops.wilson_pallas import TABLES

from tests.host_reference.wilson_ref import wilson_dslash_ref
from tests.torch_inputs import (ASYM, gaussian, lattice_shape, noisy_gauge,
                                pair_spinor_shape, rel_err)
from tests.torch_inputs import one_torch_thread  # noqa: F401 (autouse)

KAPPA = 0.12
CSRC = Path(__file__).resolve().parent.parent / "quda_tpu_torch" / "csrc"


@pytest.fixture(scope="module")
def packed_ops():
    """(JAX, port) DiracWilsonPCPacked on the same 4x6x8x10 gauge."""
    g = noisy_gauge(ASYM, seed=11)
    jpk = JDiracWilsonPCPacked(
        JDiracWilsonPC(jnp.asarray(g), JGeom(ASYM), KAPPA))
    tpk = DiracWilsonPCPacked(
        DiracWilsonPC(torch.from_numpy(g), LatticeGeometry(ASYM), KAPPA))
    return jpk, tpk


def _pair_links(jpk, tpk):
    jeo = tuple(jwpk.to_packed_pairs(x, jnp.float32) for x in jpk.gauge_eo_p)
    teo = tuple(twpk.to_packed_pairs(x, torch.float32)
                for x in tpk.gauge_eo_p)
    return jeo, teo


@pytest.mark.parametrize("parity", [0, 1])
def test_dslash_eo_packed_pairs_matches_jax(packed_ops, parity):
    jpk, tpk = packed_ops
    dims = lattice_shape(ASYM)
    jeo, teo = _pair_links(jpk, tpk)
    for j, t in zip(jeo, teo):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    psi = gaussian(pair_spinor_shape(ASYM), seed=12, dtype=np.float32)
    ref = jwpk.dslash_eo_packed_pairs(jeo, jnp.asarray(psi), dims, parity)
    got = twpk.dslash_eo_packed_pairs(teo, torch.from_numpy(psi), dims,
                                      parity)
    assert rel_err(got.numpy(), ref) < 1e-5
    ubw_j = jwpp.backward_gauge_eo(jeo[1 - parity], dims, parity)
    ubw_t = twpp.backward_gauge_eo(teo[1 - parity], dims, parity)
    np.testing.assert_array_equal(ubw_t.numpy(), np.asarray(ubw_j))
    # on CPU tensors the kernel wrapper runs the plain version: no launch
    n0 = twpp.dslash_eo_pallas_packed.launches
    out = twpp.dslash_eo_pallas_packed(teo[parity], ubw_t,
                                       torch.from_numpy(psi), dims, parity)
    np.testing.assert_array_equal(out.numpy(), got.numpy())
    assert twpp.dslash_eo_pallas_packed.launches == n0


def test_dslash_full_matches_host_reference():
    dims = ASYM
    geom = LatticeGeometry(dims)
    g = noisy_gauge(dims, seed=13, dtype=np.complex128)
    psi = gaussian(lattice_shape(dims) + (4, 3), seed=14,
                   dtype=np.complex128)
    ref = wilson_dslash_ref(g, psi, antiperiodic_t=True)
    got = twil.dslash_full(apply_t_boundary(torch.from_numpy(g), geom),
                           torch.from_numpy(psi))
    assert rel_err(got.numpy(), ref) < 1e-12


@pytest.mark.parametrize("parity", [0, 1])
def test_dslash_eo_matches_full(parity):
    geom = LatticeGeometry(ASYM)
    g = apply_t_boundary(torch.from_numpy(
        noisy_gauge(ASYM, seed=15, dtype=np.complex128)), geom)
    src = torch.from_numpy(gaussian(geom.half_spinor_shape(), seed=16,
                                    dtype=np.complex128))
    zero = torch.zeros_like(src)
    full = (even_odd_join(zero, src, geom) if parity == 0
            else even_odd_join(src, zero, geom))
    want = even_odd_split(twil.dslash_full(g, full), geom)[parity]
    got = twil.dslash_eo(twil.split_gauge_eo(g, geom), src, geom, parity)
    assert rel_err(got.numpy(), want.numpy()) < 1e-12


def test_canonical_operators_schur_complement():
    """M_pc x_e = prepare(M x) and reconstruct recovers x_o, for the
    complex128 operators; Mdag is the adjoint of M."""
    geom = LatticeGeometry(ASYM)
    g = torch.from_numpy(noisy_gauge(ASYM, seed=20, dtype=np.complex128))
    x, y = (torch.from_numpy(gaussian(geom.spinor_shape(), seed=s,
                                      dtype=np.complex128)) for s in (21, 22))
    d = DiracWilson(g, geom, KAPPA)
    dpc = DiracWilsonPC(g, geom, KAPPA)
    be, bo = even_odd_split(d.M(x), geom)
    xe, xo = even_odd_split(x, geom)
    assert rel_err(dpc.M(xe).numpy(), dpc.prepare(be, bo).numpy()) < 1e-12
    assert rel_err(dpc.reconstruct(xe, be, bo)[1].numpy(), xo.numpy()) < 1e-12
    lhs = torch.vdot(y.flatten(), d.M(x).flatten())
    rhs = torch.vdot(d.Mdag(y).flatten(), x.flatten())
    assert abs(complex(lhs - rhs)) < 1e-12 * abs(complex(lhs))


def test_schur_operator_matches_jax(packed_ops):
    jpk, tpk = packed_ops
    jop = jpk.pairs(jnp.float32)
    top = tpk.pairs(torch.float32)
    x = gaussian(pair_spinor_shape(ASYM), seed=17, dtype=np.float32)
    xt = torch.from_numpy(x)
    m = top.M_pairs(xt)
    assert rel_err(m.numpy(), jop.M_pairs(jnp.asarray(x))) < 1e-5
    mdm = top.MdagM_pairs(xt)
    assert rel_err(mdm.numpy(), jop.MdagM_pairs(jnp.asarray(x))) < 1e-5
    # gamma5-hermiticity of the pair operator: <y, M x> = <Mdag y, x>
    y = torch.from_numpy(gaussian(pair_spinor_shape(ASYM), seed=18,
                                  dtype=np.float32))
    lhs = float(torch.sum(y.double() * m.double()))
    rhs = float(torch.sum(top.Mdag_pairs(y).double() * xt.double()))
    assert abs(lhs - rhs) < 1e-5 * abs(lhs)


def test_cuda_spin_tables_match_derived_tables():
    """The kernel carries the spin tables as compile-time constants; they
    must be the ones ops/wilson_pallas.py derives from the gamma
    matrices."""
    src = (CSRC / "wilson_hop.cuh").read_text()
    rows = re.findall(r"\{([-\d,\s]+)\},\s*// mu=(\d) sign=([+-]1)", src)
    assert len(rows) == 8
    for body, mu, sign in rows:
        j0, c0r, c0i, j1, c1r, c1i, k2, d2r, d2i, k3, d3r, d3i = map(
            int, body.split(","))
        t = TABLES[(int(mu), int(sign))]
        assert (j0, j1, k2, k3) == (t["j0"], t["j1"], t["k2"], t["k3"])
        for (re_, im_), key in (((c0r, c0i), "c0"), ((c1r, c1i), "c1"),
                                ((d2r, d2i), "d2"), ((d3r, d3i), "d3")):
            assert complex(re_, im_) == t[key], (mu, sign, key)


@pytest.mark.slow
def test_plain_stencil_matches_jax_pallas_kernel(packed_ops):
    """The JAX package's own Pallas kernel (interpret mode) on the same
    inputs: the port's plain version is held to the TPU kernel it
    replaces."""
    jpk, tpk = packed_ops
    dims = lattice_shape(ASYM)
    jeo, teo = _pair_links(jpk, tpk)
    psi = gaussian(pair_spinor_shape(ASYM), seed=19, dtype=np.float32)
    parity = 1
    ubw = jwpp.backward_gauge_eo(jeo[1 - parity], dims, parity)
    ref = jwpp.dslash_eo_pallas_packed(jeo[parity], ubw, jnp.asarray(psi),
                                       dims, parity, interpret=True)
    got = twpp.dslash_eo_packed_plain(
        teo[parity], twpp.backward_gauge_eo(teo[1 - parity], dims, parity),
        torch.from_numpy(psi), dims, parity)
    assert rel_err(got.numpy(), ref) < 1e-5
