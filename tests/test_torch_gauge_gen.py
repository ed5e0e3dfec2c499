"""Port parity: gauge generation (gauge/smear.py staples, gauge/observables.py
plaquette, gauge/heatbath.py, plaq_quda).

Numpy seeds 301-319.  Tolerances: staples, plaquette, one overrelaxation
sweep (deterministic) and plaq_quda against the JAX package within 1e-12
in complex128 (the same products summed in another order); links unitary
within 1e-12 after sweeps in complex128; the Kennedy-Pendleton sampler's
mean against its analytic value I_2(a)/I_1(a) within 5 standard errors.
The heatbath's random streams cannot match JAX's (torch.Generator against
jax.random), so the heatbath is held to JAX's by its deterministic part
and by statistics.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quda_tpu_torch as qt
from quda_tpu.fields.geometry import LatticeGeometry as JGeom
from quda_tpu.gauge import heatbath as jhb
from quda_tpu.gauge import observables as jobs
from quda_tpu.gauge import smear as jsm
from quda_tpu.interfaces import quda_api as japi
from quda_tpu.interfaces.params import GaugeParam as JGaugeParam
from quda_tpu_torch.fields.geometry import LatticeGeometry
from quda_tpu_torch.gauge import heatbath as hb
from quda_tpu_torch.gauge import observables as obs
from quda_tpu_torch.gauge import smear

from tests.torch_inputs import rel_err, su3_gauge
from tests.torch_inputs import one_torch_thread  # noqa: F401 (autouse)

DIMS = (4, 4, 4, 4)
BETA = 6.0
TOL = 1e-12


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _unitarity(g: torch.Tensor) -> float:
    eye = torch.eye(3, dtype=g.dtype)
    return float((torch.matmul(g, g.conj().transpose(-1, -2))
                  - eye).abs().max())


def _wilson_action_density(g: torch.Tensor) -> float:
    """sum over sites and planes of Re tr P (the quantity an
    overrelaxation sweep keeps)."""
    m, _, _ = obs.plaquette(g)
    return float(m)


@pytest.fixture(scope="module")
def gauge():
    return su3_gauge(DIMS, 301, dtype=np.complex128)


def test_staples_and_plaquette_match_jax(gauge):
    """staple_sum for every direction and the (mean, spatial, temporal)
    plaquette equal JAX's within 1e-12."""
    g = _t(gauge)
    jg = jnp.asarray(gauge)
    for mu in range(4):
        assert rel_err(smear.staple_sum(g, mu).numpy(),
                       np.asarray(jsm.staple_sum(jg, mu))) < TOL
    assert rel_err(smear.staple(g, 1, 3).numpy(),
                   np.asarray(jsm.staple(jg, 1, 3))) < TOL
    got = [float(x) for x in obs.plaquette(g)]
    want = [float(x) for x in jobs.plaquette(jg)]
    assert np.allclose(got, want, rtol=TOL, atol=TOL)
    pf = obs.plaquette_field(g, 0, 2).numpy()
    assert rel_err(pf, np.asarray(jobs.plaquette_field(jg, 0, 2))) < TOL


def test_overrelaxation_sweep_matches_jax(gauge):
    """One overrelaxation sweep is deterministic: the port's (updating only
    the parity it keeps) equals JAX's (updating every site, then masking)
    within 1e-12, and leaves the gauge given to it untouched."""
    g = _t(gauge)
    keep = g.clone()
    got = hb.sweep(torch.Generator().manual_seed(0), g,
                   LatticeGeometry(DIMS), BETA, heatbath=False)
    want = jhb.sweep(jax.random.PRNGKey(0), jnp.asarray(gauge),
                     JGeom(DIMS), BETA, heatbath=False)
    assert rel_err(got.numpy(), np.asarray(want)) < TOL
    assert torch.equal(g, keep)


def test_overrelaxation_keeps_the_action(gauge):
    """Overrelaxation is microcanonical: the plaquette (the Wilson action)
    is unchanged within 1e-12 while the links move."""
    g = _t(gauge)
    geom = LatticeGeometry(DIMS)
    out = hb.sweep(torch.Generator().manual_seed(0), g, geom, BETA,
                   heatbath=False)
    assert abs(_wilson_action_density(out)
               - _wilson_action_density(g)) < TOL
    assert float((out - g).abs().max()) > 1e-2


@pytest.mark.parametrize("alpha", [1.5, 6.0])
def test_kp_sampler_mean_matches_analytic(alpha):
    """Kennedy-Pendleton draws x0 with density ~ sqrt(1 - x^2) exp(alpha
    x) on [-1, 1], whose mean is I_2(alpha) / I_1(alpha): the sample mean
    of the accepted draws (every draw accepted within 24 tries here) is
    within 5 standard errors of it."""
    from scipy.special import iv
    n = 200_000
    gen = torch.Generator().manual_seed(311)
    a = torch.full((n,), alpha, dtype=torch.float64)
    x0, ok = hb._kp_sample(gen, a, hb.N_TRIES)
    assert bool(ok.all())
    x = x0.numpy()
    assert x.min() >= -1.0 and x.max() <= 1.0
    want = iv(2, alpha) / iv(1, alpha)
    assert abs(x.mean() - want) < 5 * x.std() / math.sqrt(n)


def test_heatbath_keeps_links_unitary_and_thermalises():
    """From a cold start at beta 6.0, 10 compound sweeps (1 heatbath + 2
    overrelaxation) on 4^4 keep every link SU(3) within 1e-12 and bring
    the plaquette into [0.57, 0.62]: the quenched value at beta 6.0 is
    0.5937, and a 4^4 lattice fluctuates by about 0.005 around it (this
    seed gives 0.595).  hot_start gives unitary, disordered links
    exp(iH) with H Gaussian in su(3): plaquette below 0.2 (this seed
    0.052; not Haar, which would give 0)."""
    geom = LatticeGeometry(DIMS)
    gen = torch.Generator().manual_seed(312)
    g = hb.cold_start(geom, device="cpu")
    assert float(obs.plaquette(g)[0]) == pytest.approx(1.0, abs=1e-15)
    g = hb.heatbath_evolve(gen, g, geom, BETA, 10, n_or_per_hb=2)
    assert _unitarity(g) < TOL
    det = torch.linalg.det(g)
    assert float((det - 1).abs().max()) < TOL
    plaq = float(obs.plaquette(g)[0])
    assert 0.57 < plaq < 0.62
    hot = hb.hot_start(gen, geom, device="cpu")
    assert _unitarity(hot) < TOL
    assert abs(float(obs.plaquette(hot)[0])) < 0.2


def test_plaq_quda_matches_jax(gauge):
    """plaq_quda on the resident gauge equals JAX's within 1e-12."""
    qt.init_quda("cpu")
    try:
        qt.load_gauge_quda(gauge, qt.GaugeParam(X=DIMS,
                                                cuda_prec="double"))
        got = qt.plaq_quda()
    finally:
        qt.end_quda()
    japi.init_quda()
    try:
        japi.load_gauge_quda(gauge, JGaugeParam(X=DIMS, cuda_prec="double"))
        want = japi.plaq_quda()
    finally:
        japi.end_quda()
    assert np.allclose(got, want, rtol=TOL, atol=TOL)
    with pytest.raises(RuntimeError, match="init_quda"):
        qt.plaq_quda()
