"""Double-word float32 ("df64") arithmetic, as in quda_tpu/ops/df64.py.

A df64 value is a (hi, lo) tuple of same-shaped float32 tensors with
|lo| <= ulp(hi)/2: about 49 mantissa bits, a relative floor near 1e-14,
below the 1e-10 contract of the deep-tolerance Wilson solve.  Built from
the error-free transformations two_sum (Knuth) and two_prod
(Dekker-Veltkamp split).

Every function here is a sequence of separate elementwise PyTorch ops in
the order the JAX module writes them.  That is load-bearing: the error
words are exact only if each add and multiply is rounded on its own.
Eager PyTorch launches one kernel per op, so nothing is contracted into a
fused multiply-add; keep it that way (no ``torch.compile``, no
``addcmul``/``lerp``/``addcdiv`` here or in ops/wilson_df64.py).

Global sums use a pairwise halving tree of df64 additions (log2(n) vector
steps): deterministic for a fixed shape, with error O(eps^2 log n).
"""

from __future__ import annotations

import numpy as np
import torch

F32 = torch.float32
_SPLIT = 4097.0  # 2^12 + 1: Veltkamp constant for the 24-bit f32 mantissa


# -- error-free transformations (f32 in, exact (result, error) out) ---------

def two_sum(a, b):
    """s + e == a + b exactly, s = fl(a + b) (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def quick_two_sum(a, b):
    """two_sum assuming |a| >= |b| (Dekker fast path)."""
    s = a + b
    return s, b - (s - a)


def _veltkamp(a):
    t = _SPLIT * a
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a, b):
    """p + e == a * b exactly, p = fl(a * b) (Dekker)."""
    p = a * b
    ah, al = _veltkamp(a)
    bh, bl = _veltkamp(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


# -- df64 construction / conversion -----------------------------------------

def promote(hi):
    """Plain f32 tensor -> exact df64."""
    hi = hi.to(F32)
    return hi, torch.zeros_like(hi)


def const(v: float, device=None):
    """Python float -> df64 scalar constant (0-d tensors), keeping ~49
    bits of v."""
    hi = np.float32(v)
    lo = np.float32(v - float(hi))
    return (torch.tensor(float(hi), dtype=F32, device=device),
            torch.tensor(float(lo), dtype=F32, device=device))


def to_f32(x):
    """Round df64 to nearest f32."""
    return x[0] + x[1]


def to_f64(x):
    """Exact value as f64 (oracle and test use only)."""
    return x[0].to(torch.float64) + x[1].to(torch.float64)


def from_f64(v):
    """f64 tensor -> df64 (exact to ~49 bits)."""
    hi = v.to(F32)
    lo = (v - hi.to(torch.float64)).to(F32)
    return hi, lo


# -- df64 arithmetic ---------------------------------------------------------

def neg(x):
    return -x[0], -x[1]


def add(x, y):
    s, e = two_sum(x[0], y[0])
    return quick_two_sum(s, e + (x[1] + y[1]))


def sub(x, y):
    return add(x, neg(y))


def mul(x, y):
    p, e = two_prod(x[0], y[0])
    return quick_two_sum(p, e + (x[0] * y[1] + x[1] * y[0]))


def mul_f32(x, b):
    """df64 * plain f32."""
    p, e = two_prod(x[0], b)
    return quick_two_sum(p, e + x[1] * b)


# -- compensated global reductions ------------------------------------------

def tree_sum(x):
    """Sum a df64 tensor to a df64 scalar via pairwise df64 halving:
    log2(n) vectorised df64 adds, deterministic for a fixed shape."""
    hi = x[0].reshape(-1)
    lo = x[1].reshape(-1)
    n = hi.numel()
    m = 1 << max(0, (n - 1)).bit_length()
    if m != n:
        pad = hi.new_zeros(m - n)
        hi = torch.cat([hi, pad])
        lo = torch.cat([lo, pad])
    while m > 1:
        m //= 2
        hi, lo = add((hi[:m], lo[:m]), (hi[m:], lo[m:]))
    return hi[0], lo[0]


def sum_f32(x):
    """Compensated sum of a plain f32 tensor -> df64 scalar."""
    return tree_sum(promote(x))


def dot_f32(x, y):
    """Compensated <x, y> of plain f32 tensors -> df64 scalar: every
    elementary product through two_prod, the accumulation through the
    df64 tree."""
    return tree_sum(two_prod(x.to(F32), y.to(F32)))


def norm2_f32(x):
    return dot_f32(x, x)


def dot(x, y):
    """Compensated <x, y> of df64 tensors -> df64 scalar."""
    return tree_sum(mul(x, y))


def norm2(x):
    """Compensated |x|^2 of a df64 tensor -> df64 scalar."""
    return tree_sum(mul(x, x))
