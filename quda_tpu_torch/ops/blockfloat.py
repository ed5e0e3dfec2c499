"""Compressed field storage: bf16 pairs ("half") and int8 block-float
("quarter"), as in quda_tpu/ops/blockfloat.py.

QUDA's half and quarter fields store narrow components with a norm per
site (block-float).  bf16 keeps float32's exponent range, so "half" is a
cast of the (re, im) pairs with no norm.  "quarter" keeps the block-float
idea: int8 mantissas and one float32 scale per site (the max-abs of the
site's components / 127), or per (direction, site) for packed links
(``to_int8_links``), which the int8 eo hop (ops/wilson_pallas_packed.
dslash_eo_pallas_packed_int8) decodes at load.

Quantisation equals the JAX package's bit for bit: scale = max(amax,
1e-30) / 127 in float32, q = clip(round(x / scale), -127, 127) with a
float32 division (not a product with the reciprocal).  ``torch.round``
and ``jnp.round`` both round half to even, so a quotient that lands on
a half-integer goes to the same mantissa in both packages.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

F32 = torch.float32
EPS = 1e-30


class Bf16Field(NamedTuple):
    """complex field as bf16 (re, im) pairs."""
    data: torch.Tensor     # (..., 2) bfloat16


def to_bf16(x: torch.Tensor) -> Bf16Field:
    return Bf16Field(torch.view_as_real(x).to(torch.bfloat16))


def from_bf16(f: Bf16Field, dtype=torch.complex64) -> torch.Tensor:
    d = f.data.to(F32)
    return torch.complex(d[..., 0], d[..., 1]).to(dtype)


class Int8Field(NamedTuple):
    """int8 block-float: one scale per site over the internal dof."""
    data: torch.Tensor     # (..., site dims..., dof, 2) int8
    scale: torch.Tensor    # (..., site dims..., 1, 1) float32
    site_axes: int         # number of trailing internal axes folded


def _quantise(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    # a division, as the JAX package's; round() is half to even
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def to_int8(x: torch.Tensor, n_internal: int = 2) -> Int8Field:
    """Quantise a complex field with one scale per site: the max-abs over
    the last ``n_internal`` axes and re/im (spin and colour for
    fermions, the colour matrix for links)."""
    pairs = torch.view_as_real(x).to(F32)
    axes = tuple(range(pairs.ndim - n_internal - 1, pairs.ndim))
    amax = torch.amax(torch.abs(pairs), dim=axes, keepdim=True)
    scale = torch.clamp_min(amax, EPS) / 127.0
    return Int8Field(_quantise(pairs, scale), scale.to(F32), n_internal)


def from_int8(f: Int8Field, dtype=torch.complex64) -> torch.Tensor:
    d = f.data.to(F32) * f.scale
    return torch.complex(d[..., 0], d[..., 1]).to(dtype)


def to_int8_links(gauge_pl: torch.Tensor, eps: float = EPS):
    """Packed pair links (4, 3, 3, 2, T, Z, YX) -> int8 block-float
    resident storage: q (the same shape, int8 mantissas) and scale
    (4, T, Z, YX) float32, one per (direction, site): the max-abs over
    the link's 18 reals / 127 (QUDA's quarter gauge block, one norm per
    link matrix)."""
    g = gauge_pl.to(F32)
    amax = torch.amax(torch.abs(g), dim=(1, 2, 3))     # (4, T, Z, YX)
    scale = torch.clamp_min(amax, eps) / 127.0
    return _quantise(g, scale[:, None, None, None]), scale.to(F32)


def from_int8_links(q: torch.Tensor, scale: torch.Tensor,
                    dtype=F32) -> torch.Tensor:
    """Inverse of ``to_int8_links``: the decoded links (4, 3, 3, 2, T, Z,
    YX), each element float(q) * scale rounded once in float32 — what
    the int8 eo hop computes at load."""
    return (q.to(F32) * scale[:, None, None, None]).to(dtype)


def compression_ratio(x: torch.Tensor, codec: str,
                      dof_per_site: int = 12) -> float:
    """Bytes of the complex field / bytes compressed, the int8 codec's
    float32 scale per site included (``dof_per_site`` complex numbers
    share one scale: 12 for fermions, 9 per link)."""
    orig = x.element_size() * dof_per_site
    if codec == "bf16":
        return orig / (2 * 2 * dof_per_site)
    if codec == "int8":
        return orig / (2 * 1 * dof_per_site + 4)
    raise ValueError(codec)
