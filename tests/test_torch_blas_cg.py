"""Port parity: the CG tail and the CG solver.

The plain tail against quda_tpu.ops.blas.triple_cg_update (identical
elementwise arithmetic; the norm within 1e-5, summed in another order),
and fused_cg against the JAX package's fused_cg on the same operator
(solution rtol 1e-4, iterations within 2: f32 roundoff moves the last
iterations).  The Wilson normal operator's CG runs end to end in
test_torch_invert.py; the CUDA kernel meets its plain version in
test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quda_tpu.ops import blas as jblas
from quda_tpu.solvers.fused_iter import fused_cg as j_fused_cg
from quda_tpu_torch.ops import blas
from quda_tpu_torch.ops import blas_pallas as bpl
from quda_tpu_torch.solvers import create
from quda_tpu_torch.solvers.fused_iter import fused_cg

from tests.torch_inputs import SMALL, gaussian, pair_spinor_shape, rel_err
from tests.torch_inputs import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-6


def test_triple_cg_update_matches_jax():
    p, ap, x, r = (gaussian(pair_spinor_shape(SMALL), seed=31 + i,
                            dtype=np.float32) for i in range(4))
    alpha = np.float32(0.37)
    jx, jr, jr2 = jblas.triple_cg_update(
        jnp.float32(alpha), *(jnp.asarray(a) for a in (p, ap, x, r)))
    tin = [torch.from_numpy(a) for a in (p, ap, x, r)]
    a_t = torch.tensor(alpha)
    tx, tr, tr2 = blas.triple_cg_update(a_t, *tin)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert abs(float(tr2) - float(jr2)) <= 1e-5 * float(jr2)
    # on CPU tensors the kernel wrapper is the plain version: no launch
    n0 = bpl.cg_update_norm2_pallas.launches
    wx, wr, wr2 = bpl.cg_update_norm2_pallas(a_t, *tin)
    assert torch.equal(wx, tx) and torch.equal(wr, tr)
    assert float(wr2) == float(tr2)
    assert bpl.cg_update_norm2_pallas.launches == n0


@pytest.fixture(scope="module")
def hpd_system():
    """A real symmetric positive-definite system, condition number 200,
    as float32 numpy arrays (A, b): the solver on its own, with the
    operator out of the picture (test_torch_invert.py runs CG on the
    Wilson normal operator end to end)."""
    rng = np.random.default_rng(32)
    n = 192
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = (q * np.geomspace(1.0, 200.0, n)) @ q.T
    return a.astype(np.float32), rng.standard_normal(n).astype(np.float32)


def test_fused_cg_matches_jax(hpd_system):
    a, b = hpd_system
    at = torch.from_numpy(a)
    res = create("cg")(lambda v: at @ v, torch.from_numpy(b), tol=TOL,
                       maxiter=500)
    aj = jnp.asarray(a)
    jres = j_fused_cg(lambda v: aj @ v, jnp.asarray(b), tol=TOL,
                      maxiter=500)
    assert res.converged and bool(jres.converged)
    assert abs(res.iters - int(jres.iters)) <= 2
    assert rel_err(res.x.numpy(), jres.x) < 1e-4
    assert float(res.r2) <= TOL ** 2 * float(np.sum(b.astype(float) ** 2))


def test_fused_cg_check_cadence(hpd_system):
    a, b = (torch.from_numpy(v) for v in hpd_system)
    base = fused_cg(lambda v: a @ v, b, tol=TOL, maxiter=500)
    res = fused_cg(lambda v: a @ v, b, tol=TOL, maxiter=500, check_every=4)
    assert res.converged and res.iters % 4 == 0
    assert base.iters <= res.iters < base.iters + 4
    assert rel_err(res.x.numpy(), base.x.numpy()) < 1e-4
    capped = fused_cg(lambda v: a @ v, b, tol=TOL, maxiter=5)
    assert capped.iters == 5 and not capped.converged


@pytest.mark.parametrize("kwargs", [{"precond": lambda r: r},
                                    {"tol_hq": 1e-3}, {"record": True}],
                         ids=["precond", "tol_hq", "record"])
def test_fused_cg_unported_options_raise(kwargs):
    b = torch.ones(8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fused_cg(lambda v: v, b, **kwargs)


def test_create_unknown_solver_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        create("bicgstab")
