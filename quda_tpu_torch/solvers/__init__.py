"""Krylov solvers.  CG (ROADMAP A5), the mixed-precision reliable-update
CGs with their storage codecs (A7), the multi-RHS pair solvers
``batched_cg_pairs`` and ``block_cg_pairs`` (A8) and the multi-shift CG
``multishift_cg`` (A9) are ported; the rest of quda_tpu/solvers/ is
queued under A11 and A12."""

from __future__ import annotations

from .block import (BatchedCGResult, BlockCGResult, batched_cg_pairs,
                    block_cg_pairs)
from .cg import SolverResult, cg
from .fused_iter import fused_cg
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
           "SolverResult", "StorageCodec", "batched_cg_pairs",
           "block_cg_pairs", "cg", "cg_reliable", "cg_reliable_df",
           "create", "fused_cg", "multishift_cg", "packed_pair_codec",
           "pair_inplace_codec"]
