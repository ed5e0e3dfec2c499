"""Port parity: the native double (float64) Wilson routes of invert_quda.

cuda_prec="double" with sloppy double runs ``fused_cg`` on the float64
pair operator (B1 and B2 in float64, their plain versions here); with
sloppy single ``cg_reliable`` with the float32 pair operator as sloppy
and reliable updates on the float64 one.  Held against the JAX package's
native complex128 CPU solve on the same numpy inputs (numpy seeds
231-239): solutions within 1e-10 relative, true_res <= 1e-10 at tol
1e-10, confirmed by the numpy site-loop oracle
(tests/host_reference/wilson_ref.py).  The df64 gate keeps the JAX
package's semantics: cuda_prec "single" below tol 5e-8 only.  The CUDA
forms meet their plain versions on the card in test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import quda_tpu_torch as qt
from quda_tpu.interfaces import quda_api as japi
from quda_tpu.interfaces.params import GaugeParam as JGaugeParam
from quda_tpu.interfaces.params import InvertParam as JInvertParam
from quda_tpu_torch.fields.geometry import LatticeGeometry
from quda_tpu_torch.fields.spinor import even_odd_split
from quda_tpu_torch.models.wilson import DiracWilsonPC
from quda_tpu_torch.ops import blas
from quda_tpu_torch.ops import blas_pallas as bpl
from quda_tpu_torch.ops import wilson_pallas_packed as wpp
from quda_tpu_torch.solvers import (cg_reliable, fused_cg,
                                    pair_inplace_codec)

from tests.host_reference.wilson_ref import wilson_mat_ref
from tests.torch_inputs import gaussian, lattice_shape, rel_err, su3_gauge
from tests.torch_inputs import one_torch_thread  # noqa: F401 (autouse)

DIMS = (4, 4, 4, 8)
KAPPA = 0.12
TOL = 1e-10


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def system():
    g = su3_gauge(DIMS, 231, dtype=np.complex128)
    b = gaussian(lattice_shape(DIMS) + (4, 3), 232, dtype=np.complex128)
    return g, b


def _param(**kw):
    base = dict(dslash_type="wilson", inv_type="cg", solve_type="normop-pc",
                kappa=KAPPA, tol=TOL, maxiter=1000, cuda_prec="double")
    base.update(kw)
    return qt.InvertParam(**base)


def _port_solve(g, b, reconstruct=18, **kw):
    qt.init_quda(device="cpu")
    try:
        qt.load_gauge_quda(g, qt.GaugeParam(X=DIMS, cuda_prec="double",
                                            reconstruct=reconstruct))
        p = _param(**kw)
        return qt.invert_quda(b, p), p
    finally:
        qt.end_quda()


@pytest.mark.parametrize("sloppy", ["double", "single"])
def test_double_invert_matches_jax_native(system, sloppy):
    """invert_quda(double) with sloppy double and single against the JAX
    package's native complex128 CPU solve: solutions within 1e-10
    relative, true_res <= 1e-10 by the port and by the site-loop oracle;
    double/single makes reliable updates, double/double none; the
    solution is complex128."""
    g, b = system
    japi.init_quda()
    try:
        japi.load_gauge_quda(g, JGaugeParam(X=DIMS, cuda_prec="double"))
        jp = JInvertParam(dslash_type="wilson", inv_type="cg",
                          solve_type="normop-pc", kappa=KAPPA, tol=TOL,
                          maxiter=1000, cuda_prec="double",
                          cuda_prec_sloppy=sloppy)
        xj = np.asarray(japi.invert_quda(b, jp))
    finally:
        japi.end_quda()
    x, p = _port_solve(g, b, cuda_prec_sloppy=sloppy)
    assert x.dtype == torch.complex128 and p.converged
    assert p.true_res <= TOL and p.x_df64_lo is None
    r = b - wilson_mat_ref(g, x.numpy(), KAPPA)
    assert np.linalg.norm(r) / np.linalg.norm(b) <= TOL
    assert np.linalg.norm(x.numpy() - xj) / np.linalg.norm(xj) <= TOL
    assert (p.reliable_updates > 0) == (sloppy == "single")
    assert abs(p.iter_count - jp.iter_count) <= 2
    assert p.gflops == pytest.approx(
        p.iter_count * 2 * (2 * 1320 + 48) * 256 / 1e9)


def test_double_routes_run_the_f64_forms(system, monkeypatch):
    """double/double: every hop on B1's float64 form and every CG tail on
    B2's (their plain versions on CPU tensors, counted here);
    double/single: the sloppy hops in float32, the reliable updates'
    hops in float64, the residual updates on B3 in float32."""
    g, b = system
    seen = {"hop": [], "tail": [], "axpy": []}

    def spy(key, fn, pick):
        def wrapped(*a, **k):
            seen[key].append(pick(a))
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(wpp, "dslash_eo_packed_plain", spy(
        "hop", wpp.dslash_eo_packed_plain, lambda a: a[2].dtype))
    monkeypatch.setattr(bpl.blas, "triple_cg_update", spy(
        "tail", blas.triple_cg_update, lambda a: a[1].dtype))
    monkeypatch.setattr(bpl, "axpy_norm2_plain", spy(
        "axpy", bpl.axpy_norm2_plain, lambda a: a[2].dtype))
    _, p = _port_solve(g, b, cuda_prec_sloppy="double")
    f64, f32 = torch.float64, torch.float32
    assert set(seen["hop"]) == {f64} and set(seen["tail"]) == {f64}
    assert len(seen["tail"]) == p.iter_count and not seen["axpy"]
    assert len(seen["hop"]) >= 4 * p.iter_count
    for v in seen.values():
        v.clear()
    _, p = _port_solve(g, b, cuda_prec_sloppy="single")
    assert seen["hop"].count(f32) >= 4 * p.iter_count
    assert seen["hop"].count(f64) >= 4 * p.reliable_updates
    assert set(seen["axpy"]) == {f32} and len(seen["axpy"]) == p.iter_count
    assert not seen["tail"]


def test_solvers_on_the_f64_pair_operator(system):
    """fused_cg entirely in float64 and cg_reliable with a float64 precise
    and float32 sloppy pair operator (pair_inplace_codec(f32, f64)) on the
    normal equations: both reach |r| <= 1e-10 |b| in float64."""
    g, b = system
    geom = LatticeGeometry(DIMS)
    dpk = DiracWilsonPC(_t(g), geom, KAPPA).packed()
    hi = dpk.pairs(torch.float64)
    lo = dpk.pairs(torch.float32)
    be, bo = even_odd_split(_t(b), geom)
    rhs = hi.Mdag_pairs(hi.prepare_pairs(be, bo))
    assert rhs.dtype == torch.float64
    codec = pair_inplace_codec(torch.float32, torch.float64)
    assert codec.up(codec.down(rhs)).dtype == torch.float64
    for res in (fused_cg(hi.MdagM_pairs, rhs, tol=TOL, maxiter=500),
                cg_reliable(hi.MdagM_pairs, lo.MdagM_pairs, rhs, codec,
                            tol=TOL, maxiter=500)):
        assert res.converged and res.x.dtype == torch.float64
        r = rhs - hi.MdagM_pairs(res.x)
        assert float(blas.norm2(r) / blas.norm2(rhs)) ** 0.5 <= TOL
    x_pp, alpha = torch.randn(24, dtype=torch.float64), torch.tensor(
        0.3, dtype=torch.float64)
    out = bpl.cg_update_norm2_pallas(alpha, x_pp, x_pp, x_pp, x_pp)
    assert all(t.dtype == torch.float64 for t in out)


def test_df64_gate_keeps_jax_semantics(system):
    """Below tol 5e-8 a single solve takes the df64 route (low words
    published), a double solve the native route (none); a double solve
    through the batched multi-source gate loops over invert_quda."""
    g, b = system
    x, p = _port_solve(g, b, cuda_prec_sloppy="double", tol=1e-9)
    assert p.x_df64_lo is None and p.true_res <= 1e-9
    qt.init_quda(device="cpu")
    try:
        qt.load_gauge_quda(g.astype(np.complex64),
                           qt.GaugeParam(X=DIMS, cuda_prec="single"))
        ps = _param(cuda_prec="single", cuda_prec_sloppy="single", tol=1e-9)
        qt.invert_quda(b.astype(np.complex64), ps)
        assert ps.x_df64_lo is not None
        pm = _param(cuda_prec_sloppy="double", tol=1e-9)
        xm = qt.invert_multi_src_quda(b[None], pm)
        assert xm.dtype == torch.complex128 and pm.converged
        assert pm.true_res_multi[0] <= 1e-9
    finally:
        qt.end_quda()


@pytest.mark.parametrize("change,item", [
    ({"dslash_type": "clover", "csw": 1.0}, "A7"),
    ({"dslash_type": "hisq", "mass": 0.1, "solve_type": "direct-pc"}, "A7"),
    ({"cuda_prec_sloppy": "half"}, "A7"),
    ({"reconstruct": 12}, "A7")])
def test_unserved_double_routes_raise(system, change, item):
    """Double clover, double staggered, half sloppy under double and
    recon-12 under double raise, naming ROADMAP A7."""
    g, b = system
    change = dict(change)
    rec = change.pop("reconstruct", 18)
    if change.get("dslash_type") == "hisq":
        b = b[..., :1, :]
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        _port_solve(g, b, reconstruct=rec, **change)
