"""Shared inputs of the port's parity tests (tests/test_torch_*.py).

Every field is made with numpy from a seed and handed, as the same numpy
array, to the JAX package and to the port (quda_tpu_torch).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

# (X, Y, Z, T): all four extents different, and a 4^3 x 8 lattice
ASYM = (4, 6, 8, 10)
SMALL = (4, 4, 4, 8)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a module's tests on one PyTorch CPU thread, restoring the count
    after it.  The parity tests apply many small operators; with several
    pytest-xdist workers on one host, PyTorch's default of one OpenMP
    thread per core oversubscribes the cores and small operators slow down
    a hundredfold.  A module imports this fixture to use it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lattice_shape(dims):
    X, Y, Z, T = dims
    return (T, Z, Y, X)


def noisy_gauge(dims, seed: int, noise: float = 0.3,
                dtype=np.complex64) -> np.ndarray:
    """Unit links plus Gaussian noise, (4,T,Z,Y,X,3,3)."""
    rng = np.random.default_rng(seed)
    shape = (4,) + lattice_shape(dims) + (3, 3)
    g = np.broadcast_to(np.eye(3), shape) + noise * (
        rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    return g.astype(dtype)


def gaussian(shape, seed: int, dtype=np.complex64) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.complexfloating):
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


def pair_spinor_shape(dims):
    T, Z, Y, X = lattice_shape(dims)
    return (4, 3, 2, T, Z, Y * X // 2)


def rel_err(a, b) -> float:
    """max |a - b| / max |b|."""
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def require_cuda() -> torch.device:
    """Skip the calling test on a host without an NVIDIA card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no "
                    "interpret mode")
    return torch.device("cuda", 0)


def su3_gauge(dims, seed: int, dtype=np.complex64) -> np.ndarray:
    """Haar-like random SU(3) links, (4,T,Z,Y,X,3,3): QR of a complex
    Gaussian with the phases of R's diagonal folded in, scaled to unit
    determinant.  Recon-12 holds only for such links."""
    rng = np.random.default_rng(seed)
    shape = (4,) + lattice_shape(dims) + (3, 3)
    z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    q, r = np.linalg.qr(z)
    d = np.diagonal(r, axis1=-2, axis2=-1)
    q = q * (d / np.abs(d))[..., None, :]
    q = q / np.linalg.det(q)[..., None, None] ** (1.0 / 3.0)
    return q.astype(dtype)
