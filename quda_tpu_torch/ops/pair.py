"""Pair-format complex fields, as in quda_tpu/ops/pair.py: the reductions
the storage codecs of solvers/mixed.py use, the link algebra on pairs
(``dagger_pairs``, ``color_mul_pairs``, ``spin_mul_pairs``), the real
embedding of pair matrices (``interleave_mat``, ``deinterleave_mat``,
which the multigrid's Cholesky-QR and coarse links use) and the
full-lattice Wilson hop on canonical pair arrays (``dslash_full_pairs``).

Sloppy fields are real ``(..., 2)`` pair arrays (re, im last) in a
storage dtype: bfloat16 for QUDA "half".  All CG coefficients are real,
so the axpy family is plain real arithmetic on pairs, and Re<x, y> and
|x|^2 of a complex field are the real dot and sum of squares of its pair
array, accumulated in float32.  The products accumulate in float32, or
float64 for float64 inputs.  ``encode_gauge``/``decode_gauge`` are the
link codecs: "half" bf16 pairs, "quarter" int8 block-float
(ops/blockfloat.py, one float32 scale per link), decoded to bf16 pairs.
"""

from __future__ import annotations

import numpy as np
import torch

from . import gamma as g
from .shift import shift

F32 = torch.float32


def pair_norm2(x: torch.Tensor) -> torch.Tensor:
    f = x.to(F32)
    return torch.sum(f * f)


def pair_redot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.sum(x.to(F32) * y.to(F32))


def _acc(*ts) -> torch.dtype:
    return (torch.float64 if any(t.dtype == torch.float64 for t in ts)
            else F32)


def to_pairs(x: torch.Tensor, dtype=F32) -> torch.Tensor:
    """complex (...) -> real pairs (..., 2) in ``dtype``."""
    return torch.view_as_real(x).to(dtype)


def interleave_mat(m_pairs: torch.Tensor) -> torch.Tensor:
    """(..., N, M, 2) pair matrix -> (..., 2N, 2M) real embedding with
    2x2 entry blocks [[re, -im], [im, re]].  The embedding is a ring
    homomorphism C -> R^{2x2}: products, inverses and Cholesky factors
    commute with it."""
    mr, mi = m_pairs[..., 0], m_pairs[..., 1]
    blocks = torch.stack([torch.stack([mr, -mi], dim=-1),
                          torch.stack([mi, mr], dim=-1)], dim=-2)
    blocks = blocks.movedim(-2, -3)          # (..., N, a, M, b)
    s = blocks.shape
    return blocks.reshape(s[:-4] + (2 * s[-4], 2 * s[-2]))


def deinterleave_mat(m: torch.Tensor) -> torch.Tensor:
    """(..., 2N, 2M) embedding -> (..., N, M, 2) pairs (the first column
    of each 2x2 block)."""
    return torch.stack([m[..., 0::2, 0::2], m[..., 1::2, 0::2]], dim=-1)


# -- link algebra -----------------------------------------------------------

def dagger_pairs(u: torch.Tensor) -> torch.Tensor:
    """(..., a, b, 2) -> (..., b, a, 2) with conjugation."""
    ut = u.transpose(-3, -2)
    return torch.stack([ut[..., 0], -ut[..., 1]], dim=-1)


def color_mul_pairs(u: torch.Tensor, p: torch.Tensor,
                    out_dtype=F32) -> torch.Tensor:
    """(..., a, b, 2) x (..., s, b, 2) -> (..., s, a, 2): four real
    einsums accumulated at float32 (float64 for float64 inputs)."""
    acc = _acc(u, p)
    ur, ui = u[..., 0].to(acc), u[..., 1].to(acc)
    pr, pi = p[..., 0].to(acc), p[..., 1].to(acc)

    def ein(a, b):
        return torch.einsum("...ab,...sb->...sa", a, b)
    re = ein(ur, pr) - ein(ui, pi)
    im = ein(ur, pi) + ein(ui, pr)
    return torch.stack([re, im], dim=-1).to(out_dtype)


def spin_mul_pairs(m, p: torch.Tensor, out_dtype=F32) -> torch.Tensor:
    """Constant complex (4,4) spin matrix on (..., s, c, 2) pairs."""
    acc = _acc(p)
    m = np.asarray(m)
    mr = torch.as_tensor(m.real, dtype=acc, device=p.device)
    mi = torch.as_tensor(m.imag, dtype=acc, device=p.device)
    pr, pi = p[..., 0].to(acc), p[..., 1].to(acc)

    def ein(a, b):
        return torch.einsum("st,...tc->...sc", a, b)
    re = ein(mr, pr) - ein(mi, pi)
    im = ein(mr, pi) + ein(mi, pr)
    return torch.stack([re, im], dim=-1).to(out_dtype)


def encode_gauge(gauge: torch.Tensor, prec: str):
    """complex links -> stored links: "half" bf16 pairs, "quarter" int8
    block-float (ops/blockfloat.to_int8, one scale per link over its
    colour matrix)."""
    if prec == "half":
        return to_pairs(gauge, torch.bfloat16)
    if prec == "quarter":
        from .blockfloat import to_int8
        return to_int8(gauge, n_internal=2)
    raise ValueError(prec)


def decode_gauge(stored) -> torch.Tensor:
    """Stored links as the pair stencils read them: pair arrays as they
    are, int8 block-float links decoded (float(q) * scale in float32) and
    rounded to bf16 pairs, as the JAX package's decode does.  Any other
    storage (reconstruct-8's compressed links) raises."""
    from .blockfloat import Int8Field
    if isinstance(stored, Int8Field):
        return (stored.data.to(F32) * stored.scale).to(torch.bfloat16)
    if not isinstance(stored, torch.Tensor):
        raise NotImplementedError(
            f"stored links of type {type(stored).__name__}: pair arrays and "
            "int8 block-float links are ported; other link storage "
            "(reconstruct 8) waits for ROADMAP A7")
    return stored


# -- Wilson stencils in pair form ------------------------------------------

def dslash_full_pairs(gauge_st, psi: torch.Tensor,
                      out_dtype=None) -> torch.Tensor:
    """Full-lattice Wilson hop term on pair arrays (mirrors
    ops/wilson.dslash_full).  gauge_st: (4,T,Z,Y,X,3,3,2) pair links,
    boundary phase folded; psi: (T,Z,Y,X,4,3,2) pairs."""
    out_dtype = out_dtype or psi.dtype
    acc = _acc(psi)
    gauge = decode_gauge(gauge_st)
    out = None
    for mu in range(4):
        u = gauge[mu]
        fwd = color_mul_pairs(u, shift(psi, mu, +1), acc)
        term = spin_mul_pairs(g.PROJ_MINUS[mu], fwd, acc)
        ub = shift(dagger_pairs(u), mu, -1)
        bwd = color_mul_pairs(ub, shift(psi, mu, -1), acc)
        term = term + spin_mul_pairs(g.PROJ_PLUS[mu], bwd, acc)
        out = term if out is None else out + term
    return out.to(out_dtype)
