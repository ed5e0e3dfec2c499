"""Port parity: the operator API (dslash_quda, mat_quda, mat_dag_mat_quda)
of the twisted-mass doublet (ndeg-twisted-mass) at single and double
precision, and of twisted mass at double, against the JAX package's on
the same numpy inputs (tests/torch_api_cases.py).

The doublet runs its complex operators in both packages (complex64 or
complex128); twisted mass at double runs B4's float64 form with the twist
in float64 (B1 f64 for the PC hop).  Numpy seeds 331-339.  Tolerances:
1e-6 relative in complex64, 1e-12 in complex128.
"""

import numpy as np
import pytest

from tests import torch_api_cases as cases
from tests.torch_inputs import SMALL, su3_gauge
from tests.torch_inputs import one_torch_thread  # noqa: F401 (autouse)

KW = dict(kappa=0.12, mu=0.1, epsilon=0.05)
CASES = [("ndeg-twisted-mass", "single"), ("ndeg-twisted-mass", "double"),
         ("twisted-mass", "double")]


@pytest.fixture(scope="module")
def jax_out():
    g = su3_gauge(SMALL, 331, dtype=np.complex128)
    return g, {c: cases.jax_ops(g, *c, KW, 332, jit=True) for c in CASES}


@pytest.mark.parametrize("family,prec", CASES)
def test_operator_api_matches_jax(jax_out, family, prec):
    """dslash_quda, mat_quda and mat_dag_mat_quda against JAX's."""
    g, want = jax_out
    cases.check_port(g, family, prec, KW, 332, want[family, prec])
