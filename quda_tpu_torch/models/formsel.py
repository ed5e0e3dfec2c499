"""The fused-form capability gate of the operator zoo.

Port of ``fused_capable`` from quda_tpu/models/formsel.py.  The JAX
module also races the fused Pallas kernels against the staged XLA
composition and reads the ``QUDA_TPU_*_FORM`` knobs; in the port both
wait for ROADMAP A17, and the families' forms are fixed: the clover and
degenerate twisted operators always run the fused hop (K1/K2), the
flavour doublets always the staged composition.
"""

from __future__ import annotations

from typing import Optional


def fused_capable(op) -> Optional[str]:
    """None when ``op`` (a Schur pair operator on the packed eo hop) can
    host the fused epilogue kernels; otherwise the reason it cannot.
    Every pair operator of the port stores full or recon-12 links, which
    the fused kernels read (the JAX gate's other blockers, XLA stencils,
    v3 kernels, meshes and folded or int8 storage, do not exist here).
    The flavour doublet cannot: its -b tau1 term couples the two flavour
    planes, which no per-plane epilogue expresses."""
    from .twisted import _NdegPairsBase
    if isinstance(op, _NdegPairsBase):
        return "flavour doublet (the staged composition couples the planes)"
    return None
