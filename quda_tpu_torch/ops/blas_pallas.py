"""The fused BLAS-with-norm kernels (B2, B3) and their plain versions.

Replace two Pallas TPU kernels of quda_tpu/ops/blas_pallas.py with the
hand-written CUDA kernels of ``csrc/blas_fused.cu``:

* B2 ``cg_update_norm2_pallas``: x' = x + alpha p, r' = r - alpha Ap and
  |r'|^2 in one pass (the fused_cg tail).  Plain version
  ``ops/blas.triple_cg_update``.  Forms ``f32`` and ``f64`` (the native
  double fused_cg; no TPU twin), counted in ``launches_by_form``.
* B3 ``axpy_norm2_pallas``: y' = y + a x rounded to y's storage dtype
  (float32 or bfloat16), and |y'|^2 of the rounded value (the residual
  update of cg_reliable).  Plain version ``axpy_norm2_plain``.

PyTorch runs eagerly and fuses nothing, so without the kernels these
would be several passes each; on the TPU XLA fused the jnp forms itself.
The scalar is a one-element float32 tensor on the card, read by the
kernel, so the solver loop never waits on the host for it.  The norm is
a 0-d float32 tensor, summed per block and then over blocks in a second
tiny pass: no float atomics, the same result on every run.  CPU tensors
take the plain version; CUDA tensors launch the kernel or raise.
``.launches`` counts launches; B3 also counts them per storage dtype in
``axpy_norm2_pallas.launches_by_form``.
"""

from __future__ import annotations

import torch

from ..parallel.halo import psum_scalar
from ..parallel.mesh import ShardedField
from ..utils import kernels
from . import blas

# Kernel vs plain version: x', r' agree to rounding (fused multiply-adds on
# the card); |r'|^2 to this relative tolerance, since the kernel sums in
# f64 per thread and block while torch.sum sums f32 in its own order.
TOLERANCE = 1e-5
THREADS = 256
BLOCKS_PER_SM = 8
# Floor of the traffic per element in bytes: read p, Ap, x, r; write x', r'
# (float32; 48 in float64).
BYTES_PER_ELEMENT = 24
CG_UPDATE_BYTES_PER_ELEMENT = {torch.float32: 24, torch.float64: 48}
# B3 against its plain version: y' is bit-identical (both round a*x and
# y + a*x separately, in f32); |y'|^2 agrees to TOLERANCE (f64 partial
# sums on the card against torch.sum's f32 order).  Its traffic per
# element: read x, y; write y' -- 12 B in float32, 6 B in bfloat16.
AXPY_BYTES_PER_ELEMENT = {torch.float32: 12, torch.bfloat16: 6}
_FORM = {torch.float32: "f32", torch.bfloat16: "bf16"}        # B3's forms
_CG_FORM = {torch.float32: "f32", torch.float64: "f64"}       # B2's forms


def _grid(t: torch.Tensor) -> int:
    sms = torch.cuda.get_device_properties(t.device).multi_processor_count
    return max(1, min(-(-t.numel() // THREADS), sms * BLOCKS_PER_SM))


def cg_update_norm2_pallas(alpha, p, Ap, x, r):
    """x' = x + alpha p; r' = r - alpha Ap; returns (x', r', |r'|^2), all
    float32 or all float64 (alpha a one-element tensor of that dtype).
    On ShardedFields: one call per block (alpha moved to the block's
    device), the block norms summed by ``psum_scalar``."""
    if isinstance(x, ShardedField):
        parts = [cg_update_norm2_pallas(alpha.to(xb.device), *blks)
                 for xb, blks in zip(x.blocks, zip(p.blocks, Ap.blocks,
                                                   x.blocks, r.blocks))]
        return (ShardedField([q[0] for q in parts], x.mesh, x.spec),
                ShardedField([q[1] for q in parts], x.mesh, x.spec),
                psum_scalar([q[2] for q in parts]))
    kind = kernels.dispatch_device(alpha, p, Ap, x, r)
    if kind == "cpu":
        return blas.triple_cg_update(alpha, p, Ap, x, r)
    dt = x.dtype
    if dt not in _CG_FORM:
        raise TypeError(f"x: dtype {dt}, the kernel takes float32 or "
                        "float64")
    shape = tuple(x.shape)
    for name, t in (("p", p), ("Ap", Ap), ("x", x), ("r", r)):
        kernels.require(t, name, shape, dt)
    kernels.require(alpha, "alpha", None, dt)
    if alpha.numel() != 1:
        raise ValueError(f"alpha: one element expected, got {alpha.numel()}")
    lib = kernels.library()
    n = x.numel()
    nblocks = _grid(x)
    x_out = torch.empty_like(x)
    r_out = torch.empty_like(r)
    partial = torch.empty(nblocks, dtype=torch.float64, device=x.device)
    r2 = torch.empty((), dtype=dt, device=x.device)
    fn = (lib.qtt_cg_update_norm2_f64 if dt == torch.float64
          else lib.qtt_cg_update_norm2_f32)
    rc = fn(alpha.data_ptr(), p.data_ptr(), Ap.data_ptr(), x.data_ptr(),
            r.data_ptr(), x_out.data_ptr(), r_out.data_ptr(),
            partial.data_ptr(), r2.data_ptr(), n, nblocks,
            kernels.stream_of(x))
    form = _CG_FORM[dt]
    kernels.check_launch(rc, "qtt_cg_update_norm2_" + form)
    cg_update_norm2_pallas.launches += 1
    by_form = cg_update_norm2_pallas.launches_by_form
    by_form[form] = by_form.get(form, 0) + 1
    return x_out, r_out, r2


cg_update_norm2_pallas.launches = 0
cg_update_norm2_pallas.launches_by_form = {}


def axpy_norm2_plain(a, x, y):
    """y' = y + a x computed in float32 and rounded to y's dtype; returns
    (y', |y'|^2) with the norm of the rounded y' (the codec semantics of
    quda_tpu/solvers/mixed.py::_make_pair_codec)."""
    f32 = torch.float32
    out = (y.to(f32) + a.to(f32) * x.to(f32)).to(y.dtype)
    f = out.to(f32)
    return out, torch.sum(f * f)


def axpy_norm2_pallas(a, x, y):
    """y' = y + a x; returns (y', |y'|^2), y' in y's dtype.  ``a`` is a
    one-element float32 tensor; x and y real arrays of one shape and
    dtype (float32 or bfloat16)."""
    kind = kernels.dispatch_device(a, x, y)
    if kind == "cpu":
        return axpy_norm2_plain(a, x, y)
    if y.dtype not in _FORM:
        raise TypeError(f"y: dtype {y.dtype}, the kernel takes float32 or "
                        "bfloat16")
    kernels.require(x, "x", tuple(y.shape), y.dtype)
    kernels.require(y, "y", None, y.dtype)
    kernels.require(a, "a")
    if a.numel() != 1:
        raise ValueError(f"a: one element expected, got {a.numel()}")
    if y.dtype == torch.bfloat16 and (x.data_ptr() % 4 or y.data_ptr() % 4):
        raise ValueError("bfloat16 x and y must start on a 4-byte boundary "
                         "(the kernel reads element pairs)")
    lib = kernels.library()
    nblocks = _grid(y)
    y_out = torch.empty_like(y)
    partial = torch.empty(nblocks, dtype=torch.float64, device=y.device)
    n2 = torch.empty((), dtype=torch.float32, device=y.device)
    rc = lib.qtt_axpy_norm2(
        a.data_ptr(), x.data_ptr(), y.data_ptr(), y_out.data_ptr(),
        partial.data_ptr(), n2.data_ptr(), y.numel(), nblocks,
        int(y.dtype == torch.bfloat16), kernels.stream_of(y))
    kernels.check_launch(rc, "qtt_axpy_norm2")
    axpy_norm2_pallas.launches += 1
    form = _FORM[y.dtype]
    by_form = axpy_norm2_pallas.launches_by_form
    by_form[form] = by_form.get(form, 0) + 1
    return y_out, n2


axpy_norm2_pallas.launches = 0
axpy_norm2_pallas.launches_by_form = {}
