"""Precision ladder (QudaPrecision analog), as in quda_tpu/utils/precision.py.

| QUDA    | storage            | where                             |
|---------|--------------------|-----------------------------------|
| double  | complex128         | reference checks                  |
| single  | complex64 / f32    | the solve path                    |
| half    | bf16 pair          | sloppy fields and links           |
| quarter | int8 block-float   | sloppy Wilson links (bf16 fields) |
"""

from __future__ import annotations

import torch

DOUBLE = "double"
SINGLE = "single"
HALF = "half"
QUARTER = "quarter"

COMPLEX_DTYPE = {
    DOUBLE: torch.complex128,
    SINGLE: torch.complex64,
    # half/quarter are storage codecs, not complex dtypes; compute at c64
    HALF: torch.complex64,
    QUARTER: torch.complex64,
}


def complex_dtype(prec: str) -> torch.dtype:
    return COMPLEX_DTYPE[prec]
