"""Krylov solvers.  CG (ROADMAP A5), the mixed-precision reliable-update
CGs with their storage codecs (A7), the multi-RHS pair solvers
``batched_cg_pairs`` and ``block_cg_pairs`` (A8), the multi-shift CG
``multishift_cg`` (A9), and what the multigrid needs (A12):
``cg_fixed_iters``, ``batched_bicgstab_pairs`` and solvers/gcr.py (GCR,
MR, SD) are ported; ``create`` serves "cg", and the other ``inv_type``
routes and the rest of quda_tpu/solvers/ are queued under A11."""

from __future__ import annotations

from .block import (BatchedCGResult, BlockCGResult, batched_bicgstab_pairs,
                    batched_cg_pairs, block_cg_pairs)
from .cg import SolverResult, cg, cg_fixed_iters
from .fused_iter import fused_cg
from .gcr import gcr, gcr_fixed, mr, mr_fixed, sd
from .mixed import (StorageCodec, cg_reliable, cg_reliable_df,
                    packed_pair_codec, pair_inplace_codec)
from .multishift import MultiShiftResult, multishift_cg

_REGISTRY = {"cg": cg}


def create(name: str):
    """Look up a solver by (QUDA-style) name."""
    key = name.lower().replace("_", "-")
    if key not in _REGISTRY:
        raise NotImplementedError(
            f"solver '{name}' is not ported yet (ROADMAP A11 for the "
            f"remaining solvers); available: {sorted(_REGISTRY)}")
    return _REGISTRY[key]


__all__ = ["BatchedCGResult", "BlockCGResult", "MultiShiftResult",
           "SolverResult", "StorageCodec", "batched_bicgstab_pairs",
           "batched_cg_pairs", "block_cg_pairs", "cg", "cg_fixed_iters",
           "cg_reliable", "cg_reliable_df", "create", "fused_cg", "gcr",
           "gcr_fixed", "mr", "mr_fixed", "multishift_cg",
           "packed_pair_codec", "pair_inplace_codec", "sd"]
