"""Carry data across from the JAX package's host layouts.

The JAX package takes and returns numpy arrays in its host order; these
helpers turn them into the port's tensors (and back), so that the two
packages can be fed the same inputs and their intermediate arrays
compared directly.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device

_COMPLEX = {np.dtype(np.complex64): torch.complex64,
            np.dtype(np.complex128): torch.complex128}


def _complex_from_host(arr, device, dtype, trailing) -> torch.Tensor:
    a = np.asarray(arr)
    if a.ndim < len(trailing) or tuple(a.shape[-len(trailing):]) != trailing:
        raise ValueError(f"host array of shape {a.shape}: expected trailing "
                         f"axes {trailing}")
    if dtype is None:
        dtype = _COMPLEX.get(a.dtype, torch.complex128)
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        device=resolve_device(device), dtype=dtype)


def gauge_from_host(np_gauge, device="cuda", dtype=None) -> torch.Tensor:
    """(4,T,Z,Y,X,3,3) complex numpy links -> tensor on ``device``
    (``dtype`` default: the array's complex dtype)."""
    g = _complex_from_host(np_gauge, device, dtype, (3, 3))
    if g.ndim != 7 or g.shape[0] != 4:
        raise ValueError(f"gauge of shape {tuple(g.shape)}: expected "
                         "(4,T,Z,Y,X,3,3)")
    return g


def spinor_from_host(np_spinor, device="cuda", dtype=None,
                     nspin: int = 4) -> torch.Tensor:
    """(T,Z,Y,X[/2],nspin,3) complex numpy spinor -> tensor on ``device``
    (nspin 1 for the staggered family)."""
    return _complex_from_host(np_spinor, device, dtype, (nspin, 3))


def pairs_from_numpy(arr, device="cuda") -> torch.Tensor:
    """A packed pair array (real numpy, e.g. (4,3,2,T,Z,Y*Xh)) -> tensor."""
    a = np.asarray(arr)
    if np.iscomplexobj(a):
        raise TypeError("pair arrays are real; got a complex array")
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        resolve_device(device))


def pairs_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A packed pair tensor -> numpy array on the host (float32 for
    bf16 storage, which numpy lacks)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.cpu().numpy()


def fat_long_from_host(fat, long_links, device="cuda", dtype=None):
    """The fat and long links of the JAX package's ``HisqLinks`` (or of
    any host source), each (4,T,Z,Y,X,3,3) complex numpy, -> a
    (fat, long) pair of tensors on ``device``."""
    return (gauge_from_host(fat, device, dtype),
            gauge_from_host(long_links, device, dtype))


def int8_links_from_numpy(q, scale, device="cuda"):
    """The JAX package's int8 block-float links (ops/blockfloat.
    to_int8_links: numpy ``q`` int8 (4,3,3,2,T,Z,Y*Xh) and ``scale``
    float32 (4,T,Z,Y*Xh)) -> a (q, scale) pair of tensors on ``device``,
    the operands of the int8 eo hop."""
    qa, sa = np.asarray(q), np.asarray(scale)
    if qa.dtype != np.int8 or qa.ndim != 7 or qa.shape[:4] != (4, 3, 3, 2):
        raise ValueError(f"q of shape {qa.shape} and dtype {qa.dtype}: "
                         "expected int8 (4,3,3,2,T,Z,Y*Xh)")
    if sa.dtype != np.float32 or sa.shape != (4,) + qa.shape[4:]:
        raise ValueError(f"scale of shape {sa.shape} and dtype {sa.dtype}: "
                         f"expected float32 {(4,) + qa.shape[4:]}")
    dev = resolve_device(device)
    # copies: the JAX package's arrays are read-only views
    return (torch.from_numpy(np.array(qa)).to(dev),
            torch.from_numpy(np.array(sa)).to(dev))
