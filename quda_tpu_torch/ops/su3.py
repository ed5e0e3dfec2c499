"""SU(3) matrix utilities for the port: what GaugeField needs.

Port of the complex-representation half of quda_tpu/ops/su3.py:
``dagger``, ``mat_mul``, ``mat_i`` and ``trace`` (what ops/fmunu.py
needs), the Gell-Mann generators, the su(3) Gaussian, the
scaling-and-squaring exponential and random links.  Batched over any
leading axes.
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
