"""Port parity: invert_quda end to end, and the routes it refuses.

Both packages solve the same 4^3x8 system (unit gauge plus 0.3 Gaussian
noise, kappa 0.12, tol 1e-6, single precision).  Both must converge with
true_res <= 10 tol (in f32 the true residual of M x = b sits above the
normal-equation tol); solutions agree to 1e-4 relative and iteration
counts within 2.
"""

import logging

import numpy as np
import pytest
import torch

import quda_tpu_torch as qt
from quda_tpu_torch.fields.geometry import LatticeGeometry
from quda_tpu_torch.models.wilson import DiracWilsonPC
from quda_tpu.interfaces import quda_api as japi
from quda_tpu.interfaces.params import GaugeParam as JGaugeParam
from quda_tpu.interfaces.params import InvertParam as JInvertParam
from quda_tpu_torch.ops import blas_pallas as bpl
from quda_tpu_torch.ops import wilson_pallas_packed as wpp

from tests.torch_inputs import SMALL, gaussian, lattice_shape, noisy_gauge
from tests.torch_inputs import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-6


def _param(cls, **kw):
    base = dict(dslash_type="wilson", inv_type="cg", solve_type="normop-pc",
                kappa=0.12, tol=TOL, maxiter=500, cuda_prec="single")
    base.update(kw)
    return cls(**base)


def _port_solve(g, b, device="cpu", reconstruct=18, **kw):
    qt.init_quda(device=device)
    try:
        qt.load_gauge_quda(g, qt.GaugeParam(X=SMALL, cuda_prec="single",
                                            reconstruct=reconstruct))
        p = _param(qt.InvertParam, **kw)
        x = qt.invert_quda(b, p)
    finally:
        qt.end_quda()
    return x, p


def test_invert_quda_matches_jax():
    g = noisy_gauge(SMALL, seed=21)
    b = gaussian(lattice_shape(SMALL) + (4, 3), seed=22)
    japi.init_quda()
    japi.load_gauge_quda(g, JGaugeParam(X=SMALL, cuda_prec="single"))
    jp = _param(JInvertParam)
    xj = np.asarray(japi.invert_quda(b, jp))
    japi.end_quda()

    n1, n2 = wpp.dslash_eo_pallas_packed.launches, \
        bpl.cg_update_norm2_pallas.launches
    x, p = _port_solve(g, b)
    assert (wpp.dslash_eo_pallas_packed.launches,
            bpl.cg_update_norm2_pallas.launches) == (n1, n2)
    xt = x.numpy()
    assert xt.shape == xj.shape and xt.dtype == np.complex64
    assert p.converged and jp.converged
    assert p.true_res <= 10 * TOL and jp.true_res <= 10 * TOL
    assert abs(p.iter_count - jp.iter_count) <= 2
    assert np.linalg.norm(xt - xj) / np.linalg.norm(xj) < 1e-4
    vol = int(np.prod(SMALL))
    assert p.gflops == pytest.approx(
        p.iter_count * 2 * (2 * 1320 + 48) * (vol // 2) / 1e9)
    assert p.secs > 0


def test_unconverged_solve_is_flagged_once(caplog):
    g = noisy_gauge(SMALL, seed=23)
    b = gaussian(lattice_shape(SMALL) + (4, 3), seed=24)
    qt.init_quda(device="cpu")
    try:
        qt.load_gauge_quda(g, qt.GaugeParam(X=SMALL, cuda_prec="single"))
        with caplog.at_level(logging.WARNING, logger="quda_tpu_torch"):
            for _ in range(2):
                p = _param(qt.InvertParam, maxiter=3)
                qt.invert_quda(b, p)
                assert not p.converged and p.iter_count == 3
    finally:
        qt.end_quda()
    assert sum("without meeting tol" in r.message
               for r in caplog.records) == 1


def test_init_quda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        qt.init_quda()
    qt.end_quda()


@pytest.mark.parametrize("change", [
    {"dslash_type": "laplace"}, {"inv_type": "bicgstab"},
    {"solve_type": "direct-pc"},
    # Wilson double is served now (test_torch_double.py); double clover
    # still waits for ROADMAP A7
    pytest.param({"cuda_prec": "double", "dslash_type": "clover",
                  "csw": 1.0}, id="cuda_prec=double"),
    # Wilson quarter and r12f are served now (test_torch_precision_forms.
    # py); quarter for clover and r12f in float64 still wait for A7
    pytest.param({"cuda_prec_sloppy": "quarter", "dslash_type": "clover",
                  "csw": 1.0}, id="cuda_prec_sloppy=quarter"),
    pytest.param({"precision_form": "r12f", "store": "float64"},
                 id="precision_form=r12f"),
    {"reconstruct": 8}],
    ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_unported_routes_raise(change):
    """Each route the port does not serve yet raises, naming its ROADMAP
    item: through invert_quda (with the resident gauge's ``reconstruct``)
    and through the packed operator's storage form (``precision_form``)."""
    g = noisy_gauge(SMALL, seed=25)
    b = gaussian(lattice_shape(SMALL) + (4, 3), seed=26)
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        if "precision_form" in change:
            DiracWilsonPC(torch.from_numpy(g), LatticeGeometry(SMALL),
                          0.12).packed().pairs(
                getattr(torch, change.get("store", "float32")),
                precision_form=change["precision_form"])
        else:
            _port_solve(g, b, **change)
