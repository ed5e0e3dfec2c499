"""Pair-format complex fields, as in quda_tpu/ops/pair.py (the reductions
the storage codecs of solvers/mixed.py use).

Sloppy fields are real ``(..., 2)`` pair arrays (re, im last) in a
storage dtype: bfloat16 for QUDA "half".  All CG coefficients are real,
so the axpy family is plain real arithmetic on pairs, and Re<x, y> and
|x|^2 of a complex field are the real dot and sum of squares of its pair
array, accumulated in float32.
"""

from __future__ import annotations

import torch

F32 = torch.float32


def pair_norm2(x: torch.Tensor) -> torch.Tensor:
    f = x.to(F32)
    return torch.sum(f * f)


def pair_redot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.sum(x.to(F32) * y.to(F32))
