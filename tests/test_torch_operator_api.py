"""Port parity: the operator API (dslash_quda, mat_quda, mat_dag_mat_quda)
of the clover, twisted-mass and twisted-clover families at single
precision against the JAX package's, on the same numpy inputs; the
refusals that remain.  (Twisted mass at double: test_torch_doublet_api.py;
the JAX calls of one file stay within ~15 s.)

Numpy seeds 321-329.  Tolerance: 1e-6 relative (the port's float32 pair
operators against JAX's complex64 ones: the same terms summed in another
order).  On CPU tensors the kernel wrappers run their plain versions (B1,
B4 and the full-lattice clover operator); the card tests
(test_torch_cuda.py) count the launches.
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

from tests.torch_inputs import (SMALL, gaussian, lattice_shape,
                                rel_err, su3_gauge)
from tests.torch_inputs import one_torch_thread  # noqa: F401 (autouse)

KW = dict(kappa=0.12, csw=1.0, mu=0.1)
FAMILIES = ["clover", "twisted-mass", "twisted-clover"]


def _ops(api, psi, bo, p):
    return {"dslash": api.dslash_quda(bo, p, 0),
            "mat": api.mat_quda(psi, p),
            "mdm": api.mat_dag_mat_quda(psi, p)}


@pytest.fixture(scope="module")
def api_case():
    """JAX's dslash_quda, mat_quda and mat_dag_mat_quda (CPU, its complex
    operators) at single for every family, on one SU(3) gauge and spinor
    at 4^3 x 8."""
    g = su3_gauge(SMALL, 321, dtype=np.complex128)
    psi = gaussian(lattice_shape(SMALL) + (4, 3), 322, dtype=np.complex128)
    geom = LatticeGeometry(SMALL)
    bo = even_odd_split(torch.from_numpy(psi), geom)[1].numpy()
    c64 = np.complex64
    want = {}
    japi.init_quda()
    try:
        japi.load_gauge_quda(g.astype(c64),
                             JGaugeParam(X=SMALL, cuda_prec="single"))
        for family in FAMILIES:
            p = JInvertParam(dslash_type=family, cuda_prec="single", **KW)
            want[family] = {k: np.asarray(v) for k, v in _ops(
                japi, psi.astype(c64), bo.astype(c64), p).items()}
    finally:
        japi.end_quda()
    return g, psi, bo, want


@pytest.mark.parametrize("family", FAMILIES)
def test_operator_api_matches_jax(api_case, family):
    """dslash_quda (B1's plain version), mat_quda and mat_dag_mat_quda
    (the full-lattice clover operator's, or B4's with the twist) against
    JAX's within 1e-6; complex64 out, shapes as JAX's."""
    g, psi, bo, want = api_case
    c64 = np.complex64
    qt.init_quda(device="cpu")
    try:
        qt.load_gauge_quda(g.astype(c64), qt.GaugeParam(X=SMALL,
                                                        cuda_prec="single"))
        p = qt.InvertParam(dslash_type=family, cuda_prec="single", **KW)
        got = _ops(qt, psi.astype(c64), bo.astype(c64), p)
    finally:
        qt.end_quda()
    for name, t in got.items():
        w = want[family][name]
        assert t.dtype == torch.complex64
        assert tuple(t.shape) == w.shape
        assert rel_err(t.numpy(), w) < 1e-6, name


@pytest.mark.parametrize("family", FAMILIES)
def test_operator_api_recon12_matches_full(api_case, family):
    """Recon-12 links (GaugeParam.reconstruct=12) give the full links'
    operator within 1e-6 (SU(3) links, antiperiodic t)."""
    g, psi, bo, want = api_case
    qt.init_quda(device="cpu")
    try:
        qt.load_gauge_quda(g.astype(np.complex64), qt.GaugeParam(
            X=SMALL, cuda_prec="single", reconstruct=12))
        p = qt.InvertParam(dslash_type=family, cuda_prec="single", **KW)
        got = _ops(qt, psi.astype(np.complex64), bo.astype(np.complex64), p)
    finally:
        qt.end_quda()
    for name, t in got.items():
        assert rel_err(t.numpy(), want[family][name]) < 1e-6, name


def test_pair_companions_adjoints(api_case):
    """The full-lattice pair companions' Mdag is M's adjoint: <x, M y> =
    <Mdag x, y> for clover (g5 M g5), twisted clover and twisted mass
    (g5 M(-a) g5), within 1e-6 of |x||M y| (float32)."""
    from quda_tpu_torch.models.clover import DiracClover
    from quda_tpu_torch.models.twisted import (DiracTwistedClover,
                                               DiracTwistedMass)
    g, psi, _, _ = api_case
    geom = LatticeGeometry(SMALL)
    gt = torch.from_numpy(g.astype(np.complex64))
    x = torch.from_numpy(psi.astype(np.complex64))
    y = torch.from_numpy(gaussian(lattice_shape(SMALL) + (4, 3), 323))
    for d in (DiracClover(gt, geom, 0.12, 1.0),
              DiracTwistedClover(gt, geom, 0.12, 0.1, 1.0),
              DiracTwistedMass(gt, geom, 0.12, 0.1)):
        op = d.pairs(torch.float32)
        lhs = torch.vdot(x.flatten(), op.M(y).flatten())
        rhs = torch.vdot(op.Mdag(x).flatten(), y.flatten())
        scale = x.norm() * op.M(y).norm()
        assert abs(lhs - rhs) / scale < 1e-6, type(d).__name__
        assert rel_err(op.M(y).numpy(), d.M(y).numpy()) < 1e-6


def test_operator_api_refusals(api_case):
    """What the operator API still refuses names its ROADMAP item:
    clover and twisted clover at double (A7, as their invert_quda),
    laplace (A14), the staggered family on recon-12 links (C), twisted
    mass on recon-12 links at double (A7); a source of the wrong shape
    raises."""
    g, psi, bo, _ = api_case
    qt.init_quda(device="cpu")
    try:
        qt.load_gauge_quda(g, qt.GaugeParam(X=SMALL, cuda_prec="double"))
        for family in ("clover", "twisted-clover"):
            p = qt.InvertParam(dslash_type=family, cuda_prec="double", **KW)
            for call in (lambda: qt.mat_quda(psi, p),
                         lambda: qt.mat_dag_mat_quda(psi, p),
                         lambda: qt.dslash_quda(bo, p, 0)):
                with pytest.raises(NotImplementedError, match="ROADMAP A7"):
                    call()
        with pytest.raises(NotImplementedError, match="ROADMAP A14"):
            qt.mat_quda(psi, qt.InvertParam(dslash_type="laplace"))
        qt.load_gauge_quda(g.astype(np.complex64), qt.GaugeParam(
            X=SMALL, cuda_prec="single", reconstruct=12))
        with pytest.raises(NotImplementedError, match="ROADMAP C"):
            qt.mat_quda(psi, qt.InvertParam(dslash_type="hisq",
                                            cuda_prec="single"))
        with pytest.raises(NotImplementedError, match="ROADMAP A7"):
            qt.mat_quda(psi, qt.InvertParam(dslash_type="twisted-mass",
                                            cuda_prec="double", **KW))
        p = qt.InvertParam(dslash_type="twisted-mass", cuda_prec="single",
                           **KW)
        with pytest.raises(ValueError, match="source shape"):
            qt.mat_quda(bo, p)
    finally:
        qt.end_quda()
