"""Port parity: the plain versions of the full-lattice clover operator
(B7 full, ``clover_pallas_packed``), the copy-free full-lattice hop (B10,
``dslash_pallas_packed_v3``) and the canonical-layout hop (B11,
``dslash_pallas``) against the JAX package's XLA stencils and the numpy
site-loop oracle tests/host_reference/wilson_ref.py.

Numpy seeds 301-319.  Tolerances: float32 within 1e-6 relative (the same
terms summed in another order), float64 within 1e-12.  The lattice is
4x6x8x10 (a swapped axis shows; T = 10 puts both t boundary planes in
play).  The ``slow`` tests hold the plain versions to JAX's Pallas kernels
in interpret mode; the CUDA kernels meet their plain versions on the card
in test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quda_tpu.models import clover as jmc
from quda_tpu.models import twisted as jmt
from quda_tpu.ops import clover as jclover
from quda_tpu.ops import wilson as jwops
from quda_tpu.ops import wilson_packed as jwpk
from quda_tpu_torch.fields.geometry import LatticeGeometry
from quda_tpu_torch.models.clover import pack_clover_pairs
from quda_tpu_torch.ops import boundary as bnd
from quda_tpu_torch.ops import clover_pallas as clp
from quda_tpu_torch.ops import wilson_packed as wpk
from quda_tpu_torch.ops import wilson_pallas as wpl
from quda_tpu_torch.ops import wilson_pallas_packed as wpp
from quda_tpu_torch.ops.clover import clover_blocks

from tests.host_reference.wilson_ref import wilson_dslash_ref
from tests.torch_inputs import (ASYM, gaussian, lattice_shape,
                                rel_err, su3_gauge)
from tests.torch_inputs import one_torch_thread  # noqa: F401 (autouse)

KAPPA, CSW, TWIST = 0.12, 1.0, 0.17


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def fields():
    """SU(3) links (complex128, boundary phase not folded), a spinor, the
    folded links, and their packed pair forms in float64, on 4x6x8x10."""
    g = su3_gauge(ASYM, 301, dtype=np.complex128)
    psi = gaussian(lattice_shape(ASYM) + (4, 3), 302, dtype=np.complex128)
    geom = LatticeGeometry(ASYM)
    folded = bnd.apply_t_boundary(_t(g), geom, -1)
    gp = wpk.to_packed_pairs(wpk.pack_gauge(folded), torch.float64)
    pp = wpk.to_packed_pairs(wpk.pack_spinor(_t(psi)), torch.float64)
    return g, psi, geom, folded, gp.contiguous(), pp.contiguous()


@pytest.fixture(scope="module")
def oracle(fields):
    """D psi by the site-loop oracle, complex128."""
    g, psi = fields[:2]
    return wilson_dslash_ref(g, psi)


def _jax_packed(folded, psi):
    """JAX's float32 pair forms of the folded links and the spinor (JAX
    runs without x64 here, so its arrays are at most 32-bit)."""
    gp = jwpk.to_packed_pairs(jwpk.pack_gauge(
        jnp.asarray(folded.numpy(), jnp.complex64)), jnp.float32)
    pp = jwpk.to_packed_pairs(jwpk.pack_spinor(
        jnp.asarray(psi, jnp.complex64)), jnp.float32)
    return gp, pp


def _unpack(pp, geom):
    return wpk.unpack_spinor(wpk.from_packed_pairs(pp, torch.complex128),
                             geom.lattice_shape).numpy()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_v3_plain_matches_jax_pair_stencil_and_oracle(fields, oracle,
                                                      dtype):
    """B10's plain version (no backward copy passed) against the
    site-loop oracle (1e-12 in float64, 1e-6 in float32) and, in float32,
    JAX's ``dslash_packed_pairs`` (1e-6); bit for bit B4's plain version
    on the backward copy."""
    g, psi, geom, folded, gp, pp = fields
    T, Z, Y, X = geom.lattice_shape
    u, p = gp.to(dtype), pp.to(dtype)
    got = wpp.dslash_pallas_packed_v3(u, p, X)
    assert got.dtype == dtype
    assert torch.equal(got, wpp.dslash_pallas_packed(
        u, p, X, gauge_bw=wpp.backward_gauge(u, X)))
    tol = 1e-12 if dtype == torch.float64 else 1e-6
    assert rel_err(_unpack(got, geom), oracle) < tol
    if dtype == torch.float32:
        jgp, jpp = _jax_packed(folded, psi)
        want = np.asarray(jwpk.dslash_packed_pairs(jgp, jpp, X, Y))
        assert rel_err(got.numpy(), want) < tol


@pytest.mark.parametrize("tb_sign", [True, False],
                         ids=["antiperiodic", "periodic"])
def test_v3_plain_recon12_matches_full(fields, tb_sign):
    """B10's R = 2 form rebuilds row 2 of SU(3) links (the t boundary
    plane's sign with ``tb_sign``) to the R = 3 hop within 1e-6 (f32)."""
    g, psi, geom, _, _, pp = fields
    X = geom.lattice_shape[3]
    links = bnd.apply_t_boundary(_t(g), geom, -1 if tb_sign else 1)
    u = wpk.to_packed_pairs(wpk.pack_gauge(links), torch.float32)
    p = pp.float()
    full = wpp.dslash_pallas_packed_v3(u, p, X, tb_sign=tb_sign)
    r12 = wpp.dslash_pallas_packed_v3(wpp.to_recon12(u), p, X,
                                      tb_sign=tb_sign)
    assert rel_err(r12.numpy(), full.numpy()) < 1e-6


@pytest.mark.parametrize("cdt", [torch.complex128, torch.complex64])
def test_canonical_plain_matches_jax_and_oracle(fields, oracle, cdt):
    """B11's plain version (``dslash_pallas`` on CPU tensors) on complex
    canonical fields against the site-loop oracle (1e-12 complex128, 1e-6
    complex64) and, in complex64, JAX's ``ops/wilson.dslash_full``
    (1e-6); dtype and shape kept."""
    g, psi, geom, folded, _, _ = fields
    gc, pc = folded.to(cdt), _t(psi).to(cdt)
    got = wpl.dslash_pallas(gc, pc)
    assert got.dtype == cdt and got.shape == pc.shape
    tol = 1e-12 if cdt == torch.complex128 else 1e-6
    assert rel_err(got.numpy(), oracle) < tol
    if cdt == torch.complex64:
        want = np.asarray(jwops.dslash_full(jnp.asarray(gc.numpy()),
                                            jnp.asarray(pc.numpy())))
        assert rel_err(got.numpy(), want) < tol


def test_canonical_plain_equals_v3_plain_on_packed_fields(fields):
    """B11 and B10 compute one function: the canonical hop, packed,
    against B10 on the packed fields (float64, 1e-12)."""
    _, psi, geom, folded, gp, pp = fields
    X = geom.lattice_shape[3]
    canon = wpl.dslash_pallas(folded, _t(psi))
    packed = wpp.dslash_pallas_packed_v3(gp, pp, X)
    assert rel_err(canon.numpy(), _unpack(packed, geom)) < 1e-12


@pytest.fixture(scope="module")
def clover_case(fields):
    """The clover blocks A = 1 + clover term of the port (complex128,
    full lattice) in float32 pairs, with the float32 packed fields of
    both packages."""
    g, psi, geom, folded, gp, pp = fields
    blocks = clover_blocks(_t(g), KAPPA * CSW / 2.0)
    blk = pack_clover_pairs(blocks, torch.float32)
    jgp, jpp = _jax_packed(folded, psi)
    jblk = jmc.pack_clover_pairs(jnp.asarray(blocks.numpy(), jnp.complex64),
                                 jnp.float32)
    return blocks, blk, jgp, jpp, jblk


@pytest.mark.parametrize("diag_twist", [None, TWIST],
                         ids=["clover", "twisted"])
def test_clover_full_plain_matches_jax_composition(fields, clover_case,
                                                   diag_twist):
    """B7 full's plain version against the JAX package's staged XLA
    composition apply_clover_pairs - kappa dslash_packed_pairs
    (+ _ig5_rot_pairs), the reference of its clover_pallas_packed test:
    1e-6, float32."""
    _, _, geom, _, gp, pp = fields
    T, Z, Y, X = geom.lattice_shape
    _, blk, jgp, jpp, jblk = clover_case
    got = clp.clover_pallas_packed(gp.float(), blk, pp.float(), X, KAPPA,
                                   diag_twist=diag_twist)
    assert got.dtype == torch.float32
    want = (jmc.apply_clover_pairs(jblk, jpp)
            - KAPPA * jwpk.dslash_packed_pairs(jgp, jpp, X, Y))
    if diag_twist is not None:
        want = want + jmt._ig5_rot_pairs(jpp, diag_twist)
    assert rel_err(got.numpy(), np.asarray(want)) < 1e-6


@pytest.mark.parametrize("diag_twist", [None, TWIST],
                         ids=["clover", "twisted"])
def test_clover_full_plain_matches_complex128_operator(fields, oracle,
                                                       clover_case,
                                                       diag_twist):
    """B7 full's plain version against (A + i c g5) psi - kappa D psi in
    complex128 with JAX's clover application and the site-loop hop:
    1e-6 (the float32 operator); R = 2 links too (SU(3))."""
    g, psi, geom, _, gp, pp = fields
    X = geom.lattice_shape[3]
    blocks = clover_case[0]
    want = (np.asarray(jclover.apply_clover(jnp.asarray(blocks.numpy()),
                                            jnp.asarray(psi)))
            - KAPPA * oracle)
    if diag_twist is not None:
        g5 = np.array([1.0, 1.0, -1.0, -1.0])[:, None]
        want = want + 1j * diag_twist * g5 * psi
    for links in (gp.float(), wpp.to_recon12(gp.float())):
        got = clp.clover_pallas_packed(links, clover_case[1], pp.float(), X,
                                       KAPPA, diag_twist=diag_twist)
        assert rel_err(_unpack(got.double(), geom), want) < 1e-6


def test_full_kernel_byte_and_flop_models():
    """The floors the timing tables use: B10 480/384 B, B11 480 (f32) and
    960 (f64) B; B7 full 1344/1152 B, 1824 flop (+72 twist, +336 R = 2)."""
    assert wpp.bytes_per_site_v3(3) == 480
    assert wpp.bytes_per_site_v3(2) == 384
    assert wpp.bytes_per_site_v3(3, torch.float64) == 960
    assert clp.bytes_per_site_full(3) == 1344
    assert clp.bytes_per_site_full(2) == 1152
    assert clp.flops_per_site_full() == 1824
    assert clp.flops_per_site_full(3, twist=True) == 1896
    assert clp.flops_per_site_full(2) == 1824 + 336


def test_full_kernel_wrappers_count_no_cpu_launch(fields, clover_case):
    """On CPU tensors the wrappers run their plain versions and count no
    kernel launch."""
    _, psi, geom, folded, gp, pp = fields
    X = geom.lattice_shape[3]
    wpp.reset_launches()
    clp.reset_launches()
    wpl.reset_launches()
    wpp.dslash_pallas_packed_v3(gp.float(), pp.float(), X)
    clp.clover_pallas_packed(gp.float(), clover_case[1], pp.float(), X,
                             KAPPA)
    wpl.dslash_pallas(folded, _t(psi))
    assert (wpp.dslash_pallas_packed_v3.launches,
            clp.clover_pallas_packed.launches,
            wpl.dslash_pallas.launches) == (0, 0, 0)


# -- slow: JAX's Pallas kernels in interpret mode ---------------------------

@pytest.mark.slow
@pytest.mark.parametrize("rows", [3, 2])
def test_v3_plain_matches_jax_pallas_interpret(fields, rows):
    """B10's plain version against JAX's ``dslash_pallas_packed_v3`` in
    interpret mode, float32 (full and recon-12 links), 1e-6."""
    from quda_tpu.ops import wilson_pallas_packed as jwpp
    g, psi, geom, folded, gp, pp = fields
    X = geom.lattice_shape[3]
    u = gp.float() if rows == 3 else wpp.to_recon12(gp.float())
    got = wpp.dslash_pallas_packed_v3(u, pp.float(), X)
    jgp, jpp = _jax_packed(folded, psi)
    if rows == 2:
        jgp = jwpp.to_recon12(jgp)
    want = np.asarray(jwpp.dslash_pallas_packed_v3(jgp, jpp, X,
                                                   interpret=True))
    assert rel_err(got.numpy(), want) < 1e-6


@pytest.mark.slow
def test_canonical_plain_matches_jax_pallas_interpret(fields):
    """B11's plain version against JAX's ``dslash_pallas`` in interpret
    mode on complex64 fields, 1e-6."""
    from quda_tpu.ops import wilson_pallas as jwpl
    _, psi, _, folded, _, _ = fields
    gc, pc = folded.to(torch.complex64), _t(psi).to(torch.complex64)
    got = wpl.dslash_pallas(gc, pc)
    want = np.asarray(jwpl.dslash_pallas(jnp.asarray(gc.numpy()),
                                         jnp.asarray(pc.numpy()),
                                         interpret=True))
    assert rel_err(got.numpy(), want) < 1e-6


@pytest.mark.slow
@pytest.mark.parametrize("diag_twist", [None, TWIST],
                         ids=["clover", "twisted"])
def test_clover_full_plain_matches_jax_pallas_interpret(fields, clover_case,
                                                        diag_twist):
    """B7 full's plain version against JAX's ``clover_pallas_packed`` in
    interpret mode, float32, 1e-6."""
    from quda_tpu.ops.clover_pallas import clover_pallas_packed as jcpp
    _, _, geom, _, gp, pp = fields
    X = geom.lattice_shape[3]
    _, blk, jgp, jpp, jblk = clover_case
    got = clp.clover_pallas_packed(gp.float(), blk, pp.float(), X, KAPPA,
                                   diag_twist=diag_twist)
    want = np.asarray(jcpp(jgp, jblk, jpp, X, KAPPA, diag_twist=diag_twist,
                           interpret=True))
    assert rel_err(got.numpy(), want) < 1e-6

