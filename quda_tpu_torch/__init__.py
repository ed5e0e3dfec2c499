"""quda_tpu_torch — the PyTorch and CUDA port of quda_tpu.

The package mirrors ``quda_tpu``'s module paths and public names, so each
function has a counterpart a reader can find by path.  It imports
``torch`` and ``numpy`` only; the JAX package is its reference and is
never imported from here.

Device rule: every entry point takes a ``device``, defaulting to
``"cuda"``.  Without a card, and without an explicit ``device="cpu"``,
it raises (``utils/device.py``).  The hot loops run hand-written CUDA
kernels (``csrc/``), built at first use; on CPU tensors their wrappers
run the plain PyTorch versions that sit beside them.
"""

from .fields.geometry import EVEN, FULL, ODD, LatticeGeometry
from .interfaces.params import GaugeParam, InvertParam, MultigridParamAPI
from .interfaces.quda_api import (compute_ks_link_quda,
                                  destroy_multigrid_quda, dslash_quda,
                                  end_quda, free_gauge_quda, init_quda,
                                  invert_multi_src_quda,
                                  invert_multishift_quda, invert_quda,
                                  load_fat_long_quda, load_gauge_quda,
                                  mat_dag_mat_quda, mat_quda,
                                  new_multigrid_quda, plaq_quda,
                                  update_multigrid_quda)

__all__ = [
    "EVEN", "ODD", "FULL", "LatticeGeometry", "GaugeParam", "InvertParam",
    "init_quda", "end_quda", "load_gauge_quda", "free_gauge_quda",
    "invert_quda", "invert_multi_src_quda", "compute_ks_link_quda",
    "load_fat_long_quda", "invert_multishift_quda", "dslash_quda",
    "mat_quda", "mat_dag_mat_quda", "MultigridParamAPI",
    "new_multigrid_quda", "update_multigrid_quda", "destroy_multigrid_quda",
    "plaq_quda",
]
