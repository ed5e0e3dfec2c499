"""SU(3) matrix utilities for the port: what GaugeField needs.

Port of the complex-representation half of quda_tpu/ops/su3.py:
``dagger``, ``mat_mul``, ``mat_i`` and ``trace`` (what ops/fmunu.py
needs), ``mat_mul_fma`` (the gauge generation's product), the Gell-Mann
generators, the su(3) Gaussian, the scaling-and-squaring exponential,
random links, and the closed-form inverse square root ``inv_sqrt_herm3``
(HISQ reunitarisation).  Batched over any leading axes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device, standard_normal

_l = np.zeros((8, 3, 3), dtype=np.complex128)
_l[0, 0, 1] = _l[0, 1, 0] = 1
_l[1, 0, 1] = -1j
_l[1, 1, 0] = 1j
_l[2, 0, 0] = 1
_l[2, 1, 1] = -1
_l[3, 0, 2] = _l[3, 2, 0] = 1
_l[4, 0, 2] = -1j
_l[4, 2, 0] = 1j
_l[5, 1, 2] = _l[5, 2, 1] = 1
_l[6, 1, 2] = -1j
_l[6, 2, 1] = 1j
_l[7, 0, 0] = _l[7, 1, 1] = 1 / np.sqrt(3)
_l[7, 2, 2] = -2 / np.sqrt(3)
GELL_MANN = _l


def dagger(m: torch.Tensor) -> torch.Tensor:
    """Hermitian conjugate over the trailing (c,c) axes."""
    return torch.conj(m.transpose(-1, -2))


def mat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched matrix product over the trailing (c,c) axes."""
    return torch.matmul(a, b)


def mat_mul_fma(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``mat_mul`` as broadcast multiply-adds over the inner index:
    elementwise kernels, the gauge generation's product (gauge/smear.py,
    gauge/observables.py, gauge/heatbath.py).  On the card
    ``torch.matmul`` of millions of 3x3 complex matrices goes through a
    batched GEMM and runs many times slower (``chip_profile.py mg`` times
    the heatbath's staples both ways; PERF.md)."""
    out = a[..., :, 0:1] * b[..., 0:1, :]
    for j in range(1, a.shape[-1]):
        out = out + a[..., :, j:j + 1] * b[..., j:j + 1, :]
    return out


def trace(m: torch.Tensor) -> torch.Tensor:
    """Complex trace over the trailing (c,c) axes."""
    return torch.diagonal(m, dim1=-2, dim2=-1).sum(-1)


def mat_i(m: torch.Tensor) -> torch.Tensor:
    """i * m."""
    return 1j * m


def random_hermitian_traceless(generator, shape, dtype=torch.complex128,
                               device="cuda") -> torch.Tensor:
    """Gaussian traceless Hermitian matrices H = sum_a xi_a T_a,
    xi ~ N(0,1), T_a = lambda_a / 2."""
    dev = resolve_device(device)
    real = torch.empty((), dtype=dtype).real.dtype
    xi = standard_normal(generator, tuple(shape) + (8,), real, dev)
    gen = torch.as_tensor(GELL_MANN / 2.0, dtype=dtype, device=dev)
    return torch.einsum("...a,aij->...ij", xi.to(dtype), gen)


def expm_su3(h: torch.Tensor, order: int = 16) -> torch.Tensor:
    """exp(i h) for batched Hermitian h: 6 halvings, a Taylor series of
    ``order`` terms, 6 squarings (quda_tpu's fixed branch-free scheme)."""
    x = 1j * h / (2.0 ** 6)
    eye = torch.eye(3, dtype=h.dtype, device=h.device).expand(h.shape)
    term = eye
    acc = eye
    for k in range(1, order):
        term = torch.matmul(term, x) / k
        acc = acc + term
    for _ in range(6):
        acc = torch.matmul(acc, acc)
    return acc


def random_su3(generator, shape, dtype=torch.complex128, scale: float = 1.0,
               device="cuda") -> torch.Tensor:
    """Random SU(3) links exp(i * scale * H), H Gaussian in su(3)."""
    h = random_hermitian_traceless(generator, shape, dtype, device)
    return expm_su3(scale * h)


def unit_gauge(shape, dtype=torch.complex128, device="cuda") -> torch.Tensor:
    """Identity links of shape ``shape + (3, 3)``."""
    eye = torch.eye(3, dtype=dtype, device=resolve_device(device))
    return eye.expand(tuple(shape) + (3, 3)).clone()


def _det3(m: torch.Tensor) -> torch.Tensor:
    """det of batched 3x3 matrices by cofactors (elementwise: no batched
    LU, whatever the batch size)."""
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2]
                            - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2]
                              - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1]
                              - m[..., 1, 1] * m[..., 2, 0]))


def inv_sqrt_herm3(h: torch.Tensor) -> torch.Tensor:
    """H^{-1/2} of batched complex Hermitian positive definite 3x3 h, by
    Cayley-Hamilton, the JAX package's method (ops/su3.py::
    inv_sqrt_herm3_pairs, QUDA's lib/unitarize_links_quda.cu):

        f(H) = f(l0) + f[l0,l1] (H - l0) + f[l0,l1,l2] (H - l0)(H - l1)

    with the eigenvalues l_i from Cardano's trigonometric form.  Two
    changes keep float32 accurate where HISQ needs it (V^dag V of a fat7
    link is nearly a multiple of 1, so its eigenvalues nearly coincide):
    Cardano runs on K = H/s - 1, s = tr H / 3, whose invariants carry no
    cancellation, and the divided differences of f = l^{-1/2} take their
    closed forms in x_i = sqrt(l_i),

        f[a,b] = -1 / (x_a x_b (x_a + x_b))
        f[a,b,c] = (x_a + x_b + x_c) / (x_a x_b x_c (x_a + x_b)
                                         (x_b + x_c) (x_a + x_c)),

    exact at coincident eigenvalues, so no branch is needed.
    Elementwise arithmetic only: any batch size runs (a batched eigh of
    the 4.2 M links of a 32^4 lattice is refused by cuSOLVER on the
    card)."""
    rdt = h.real.dtype
    eye = torch.eye(3, dtype=h.dtype, device=h.device)
    s = torch.diagonal(h, dim1=-2, dim2=-1).real.sum(-1) / 3.0
    k = h / s[..., None, None].to(h.dtype) - eye
    t1 = torch.diagonal(k, dim1=-2, dim2=-1).real.sum(-1)
    t2 = (k.real * k.real + k.imag * k.imag).sum((-2, -1))  # tr K^2
    # characteristic polynomial of K: mu^3 + a mu^2 + b mu + c
    a = -t1
    b = 0.5 * (t1 * t1 - t2)
    c = -_det3(k).real
    # depressed cubic y^3 + p y + r, mu = y - a/3
    p = b - a * a / 3.0
    r = 2.0 * a ** 3 / 27.0 - a * b / 3.0 + c
    m = 2.0 * torch.sqrt(torch.clamp(-p / 3.0, min=0.0))
    pm = p * m
    arg = torch.clamp(3.0 * r / torch.where(pm == 0, torch.ones_like(pm),
                                            pm), -1.0, 1.0)
    theta = torch.arccos(arg) / 3.0
    tiny = torch.finfo(rdt).tiny
    x = [torch.sqrt(torch.clamp(
        s * (1.0 + m * torch.cos(theta - j * (2.0 * np.pi / 3.0)) - a / 3.0),
        min=tiny)) for j in range(3)]
    x0, x1, x2 = x
    f0 = 1.0 / x0
    d01 = -1.0 / (x0 * x1 * (x0 + x1))
    d012 = (x0 + x1 + x2) / (x0 * x1 * x2 * (x0 + x1) * (x1 + x2)
                             * (x0 + x2))

    def sc(v):
        return v[..., None, None].to(h.dtype)

    h_l0 = h - sc(x0 * x0) * eye
    h_l1 = h - sc(x1 * x1) * eye
    return sc(f0) * eye + sc(d01) * h_l0 + sc(d012) * mat_mul(h_l0, h_l1)
