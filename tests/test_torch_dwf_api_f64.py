"""Port parity: the operator API (dslash_quda, mat_quda, mat_dag_mat_quda)
of the domain-wall family (Möbius, Shamir domain-wall-4d, 5d-PC
domain-wall, Möbius EOFA) at double precision against the JAX package's
on the same numpy inputs (tests/torch_api_cases.py): the complex128
operators in both packages, Ls 4.  Single precision:
test_torch_dwf_api.py.

dslash_quda: the 5d-PC domain wall's D_to on (Ls,T,Z,Y,X/2,4,3); the
4d-PC Möbius operators have no PC hop in the JAX package (its call raises
AttributeError) and the port's raises NotImplementedError naming D_to.
Numpy seeds 361-369.  Tolerance: 1e-12 relative (complex128).
"""

import numpy as np
import pytest

from tests import torch_api_cases as cases
from tests.torch_inputs import SMALL, su3_gauge
from tests.torch_inputs import one_torch_thread  # noqa: F401 (autouse)

KW = dict(Ls=4, m5=-1.8, b5=1.5, c5=0.5, mass=0.1, eofa_mq1=0.04,
          eofa_mq2=0.5, eofa_mq3=1.0, eofa_shift=0.3)
CASES = [(f, "double") for f in cases.DWF]


@pytest.fixture(scope="module")
def jax_out():
    g = su3_gauge(SMALL, 361, dtype=np.complex128)
    return g, {c: cases.jax_ops(g, *c, KW, 362) for c in CASES}


@pytest.mark.parametrize("family,prec", CASES)
def test_operator_api_matches_jax(jax_out, family, prec):
    """dslash_quda, mat_quda and mat_dag_mat_quda against JAX's."""
    g, want = jax_out
    cases.check_port(g, family, prec, KW, 362, want[family, prec])
