"""Pure-gauge Monte Carlo: SU(3) heatbath and overrelaxation, hot and cold
starts, as in quda_tpu/gauge/heatbath.py.

Cabibbo-Marinari pseudo-heatbath over the three SU(2) subgroups with
Kennedy-Pendleton sampling, and microcanonical overrelaxation, one
(parity, direction) checkerboard at a time, so a staple never holds a
link that is being updated.  The sampler keeps the JAX package's budget:
K = 24 candidate (delta, accept) pairs per site, the first accepted one
wins, and a site where all K are rejected keeps its link.

Randomness comes from a ``torch.Generator`` where JAX takes a PRNG key;
the two never give the same numbers, so the tests hold the heatbath to
JAX's by its deterministic part (overrelaxation) and by statistics.  The
JAX package updates every site and then keeps one parity; the port
gathers the sites of the parity it keeps and updates only those, which
gives the same links (overrelaxation bit for bit up to the order of
sums) at half the arithmetic and half the random numbers.  ``sweep``
works on a copy of the gauge it is given and updates that copy in place.
"""

from __future__ import annotations

import math

import torch

from ..fields.geometry import LatticeGeometry
from ..ops.su3 import dagger, mat_mul_fma, random_su3, unit_gauge
from .smear import staple_sum

# SU(2) subgroup index pairs within SU(3)
SUBGROUPS = ((0, 1), (0, 2), (1, 2))
N_TRIES = 24


def hot_start(generator, geom: LatticeGeometry, dtype=torch.complex128,
              device="cuda") -> torch.Tensor:
    return random_su3(generator, (4,) + geom.lattice_shape, dtype, 1.0,
                      device)


def cold_start(geom: LatticeGeometry, dtype=torch.complex128,
               device="cuda") -> torch.Tensor:
    return unit_gauge((4,) + geom.lattice_shape, dtype, device)


def _subgroup_quaternion(w, i, j):
    """b-vector of Re tr(g W) = a . b over the (i,j) SU(2) subgroup:
    b0 = Re(Wii + Wjj), b1 = -Im(Wij + Wji), b2 = -Re(Wij - Wji),
    b3 = -Im(Wii - Wjj)."""
    wii, wjj = w[..., i, i], w[..., j, j]
    wij, wji = w[..., i, j], w[..., j, i]
    return ((wii + wjj).real, -(wij + wji).imag, -(wij - wji).real,
            -(wii - wjj).imag)


def _embed_su2(a0, a1, a2, a3, i, j, dtype):
    """Quaternion a as an (i,j)-subgroup rotation in SU(3), batched over
    a0's shape."""
    g = torch.zeros(a0.shape + (3, 3), dtype=dtype, device=a0.device)
    for k in range(3):
        g[..., k, k] = 1.0
    g[..., i, i] = torch.complex(a0, a3)
    g[..., i, j] = torch.complex(a2, a1)
    g[..., j, i] = torch.complex(-a2, a1)
    g[..., j, j] = torch.complex(a0, -a3)
    return g


def _uniform(generator, shape, lo, hi, like):
    u = torch.rand(shape, generator=generator, dtype=like.dtype,
                   device=like.device)
    return lo + (hi - lo) * u


def _kp_sample(generator, alpha: torch.Tensor, n_tries: int = N_TRIES):
    """Kennedy-Pendleton: x0 in [-1, 1] with density ~ sqrt(1 - x0^2)
    exp(alpha x0), from ``n_tries`` candidates per site.  Returns
    (x0, ok); ok is False where every candidate was rejected."""
    shape = (n_tries,) + tuple(alpha.shape)
    eps = 1e-12
    r1 = _uniform(generator, shape, eps, 1.0, alpha)
    r2 = _uniform(generator, shape, 0.0, 1.0, alpha)
    r3 = _uniform(generator, shape, eps, 1.0, alpha)
    r4 = _uniform(generator, shape, 0.0, 1.0, alpha)
    a = torch.clamp(alpha, min=1e-10)
    delta = -(torch.log(r1)
              + torch.cos(2 * math.pi * r2) ** 2 * torch.log(r3)) / a
    accept = (r4 ** 2) <= torch.clamp(1.0 - 0.5 * delta, min=0.0)
    # the first accepted try per site
    idx = torch.argmax(accept.to(torch.int8), dim=0)
    ok = torch.any(accept, dim=0)
    d = torch.gather(delta, 0, idx.unsqueeze(0))[0]
    return 1.0 - d, ok


def _subgroup_update(generator, u, a_staple, beta: float, sg,
                     heatbath: bool, n_tries: int):
    """One SU(2)-subgroup update of every link of ``u`` (..., 3, 3)."""
    i, j = sg
    w = mat_mul_fma(u, dagger(a_staple))
    b0, b1, b2, b3 = _subgroup_quaternion(w, i, j)
    k = torch.sqrt(b0 ** 2 + b1 ** 2 + b2 ** 2 + b3 ** 2) + 1e-30
    q0, q1, q2, q3 = b0 / k, b1 / k, b2 / k, b3 / k
    if heatbath:
        x0, ok = _kp_sample(generator, (beta / 3.0) * k, n_tries)
        # a uniform direction on the 2-sphere for the perpendicular part
        ct = _uniform(generator, k.shape, -1.0, 1.0, k)
        ph = _uniform(generator, k.shape, 0.0, 2 * math.pi, k)
        st = torch.sqrt(torch.clamp(1.0 - ct ** 2, min=0.0))
        xr = torch.sqrt(torch.clamp(1.0 - x0 ** 2, min=0.0))
        # a = (x0, xr n) times bhat as quaternions: right translation on
        # S^3 sends e0 to bhat, so a . bhat = x0, perpendicular part
        # uniform.  (p0,p)(q0,q) = (p0 q0 - p.q, p0 q + q0 p + p x q)
        p0, p1, p2, p3 = x0, xr * ct, xr * st * torch.cos(ph), \
            xr * st * torch.sin(ph)
        a0 = p0 * q0 - p1 * q1 - p2 * q2 - p3 * q3
        a1 = p0 * q1 + q0 * p1 + p2 * q3 - p3 * q2
        a2 = p0 * q2 + q0 * p2 + p3 * q1 - p1 * q3
        a3 = p0 * q3 + q0 * p3 + p1 * q2 - p2 * q1
        # where every try was rejected: the identity, the link stays
        one, zero = torch.ones_like(a0), torch.zeros_like(a0)
        a0 = torch.where(ok, a0, one)
        a1 = torch.where(ok, a1, zero)
        a2 = torch.where(ok, a2, zero)
        a3 = torch.where(ok, a3, zero)
    else:
        # microcanonical overrelaxation: a = bhat * bhat (quaternion square)
        a0 = q0 * q0 - q1 * q1 - q2 * q2 - q3 * q3
        a1, a2, a3 = 2 * q0 * q1, 2 * q0 * q2, 2 * q0 * q3
    return mat_mul_fma(_embed_su2(a0, a1, a2, a3, i, j, u.dtype), u)


_SITES: dict = {}


def _parity_sites(geom: LatticeGeometry, parity: int, device):
    """Flat indices of the sites with (t+z+y+x) % 2 == parity."""
    key = (geom.lattice_shape, parity, str(device))
    idx = _SITES.get(key)
    if idx is None:
        T, Z, Y, X = geom.lattice_shape
        c = [torch.arange(n, device=device) for n in (T, Z, Y, X)]
        p = (c[0][:, None, None, None] + c[1][None, :, None, None]
             + c[2][None, None, :, None] + c[3][None, None, None, :]) % 2
        idx = torch.nonzero(p.reshape(-1) == parity).reshape(-1)
        _SITES[key] = idx
    return idx


def sweep(generator, gauge: torch.Tensor, geom: LatticeGeometry,
          beta: float, heatbath: bool = True,
          n_tries: int = N_TRIES) -> torch.Tensor:
    """One lattice sweep, 2 parities x 4 directions x 3 subgroups, on a
    copy of ``gauge``; returns the copy."""
    gauge = gauge.clone()
    vol = geom.volume
    for parity in (0, 1):
        idx = _parity_sites(geom, parity, gauge.device)
        for mu in range(4):
            a = staple_sum(gauge, mu).reshape(vol, 3, 3)[idx]
            u_mu = gauge[mu].reshape(vol, 3, 3)
            u = u_mu[idx]
            for sg in SUBGROUPS:
                u = _subgroup_update(generator, u, a, beta, sg, heatbath,
                                     n_tries)
            u_mu[idx] = u
    return gauge


def heatbath_evolve(generator, gauge: torch.Tensor, geom: LatticeGeometry,
                    beta: float, n_sweeps: int,
                    n_or_per_hb: int = 0) -> torch.Tensor:
    """``n_sweeps`` heatbath sweeps, each followed by ``n_or_per_hb``
    overrelaxation sweeps (the heatbath_test evolution pattern)."""
    for _ in range(n_sweeps):
        gauge = sweep(generator, gauge, geom, beta, heatbath=True)
        for _ in range(n_or_per_hb):
            gauge = sweep(generator, gauge, geom, beta, heatbath=False)
    return gauge
