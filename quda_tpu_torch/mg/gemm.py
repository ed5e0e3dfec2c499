"""The Galerkin coarse stencil from batched probes, as in
quda_tpu/mg/gemm.py (``build_coarse_pairs_gemm``).

Two facts make the build a few batched contractions instead of a probe
loop per coarse column:

1. The prolongation of the coarse unit vector e_{chir,b}, replicated over
   every coarse site, is the aggregate column V[..., chir, :, b]
   unblocked: all 2 n_vec probe inputs are one reshape of the transfer.
2. A single-direction hop couples an output site only to x + sign*mu, so
   its output on the whole column batch splits by a fixed fine-lattice
   face mask: sites whose source crossed an aggregate boundary carry the
   link column, the others the intra-block part of the coarse diagonal.

Per level the build is then one batched diag and 8 batched hop
applications over the 2 n_vec columns, each followed by one batched
restriction (the four real GEMMs of a pair product).  The columns are
applied in chunks sized to the device memory the process has free
(``_probe_chunk``: each column is a few live fine fields); the JAX
package reads the chunk from QUDA_TPU_MG_COARSE_CHUNK.  An extent of 1
along mu makes the neighbour aggregate the aggregate itself: the whole
direction output feeds the link.  The probes
are plain PyTorch, as they are XLA in the JAX package; the JAX package's
cached constant-free probe programs (mg/opstate.py) have no counterpart:
PyTorch runs eagerly.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..fields.geometry import axis_of_mu
from .coarse import DIRS


def _face_mask(fine_shape, block, mu: int, sign: int) -> np.ndarray:
    """(T,Z,Y,X) float mask of fine output sites whose hop source
    x + sign*mu lies in the neighbouring aggregate (1.0 on the outgoing
    face, 0.0 inside).  ``block`` is in array-axis order (bt,bz,by,bx)."""
    ax = axis_of_mu(mu)
    b = block[ax]
    coord = np.arange(fine_shape[ax]) % b
    face = (coord == (b - 1)) if sign > 0 else (coord == 0)
    shape = [1, 1, 1, 1]
    shape[ax] = fine_shape[ax]
    return np.broadcast_to(face.reshape(shape),
                           fine_shape).astype(np.float64)


def _mask_for(latc, fine_shape, block, mu, sign, ndim, device):
    """The face mask shaped to broadcast against a (cols, T,Z,Y,X, ...)
    batch of ``ndim`` axes (all ones where the coarse extent is 1)."""
    if latc[axis_of_mu(mu)] == 1:
        m = np.ones(fine_shape)
    else:
        m = _face_mask(fine_shape, block, mu, sign)
    return torch.as_tensor(m, dtype=torch.float32, device=device).reshape(
        (1,) + tuple(fine_shape) + (1,) * (ndim - 5))


def _check_extents(latc):
    for mu in range(4):
        ext = latc[axis_of_mu(mu)]
        if ext != 1 and ext % 2 != 0:
            raise ValueError(
                f"coarse extent {ext} along mu={mu} must be even or 1")


def _rcols_pr(vv, Hb, block, latc, nc):
    """Batched restriction on pair arrays: (cols, lat, 2, K, 2) ->
    (latc, nc, cols, 2), the realified complex product as four GEMMs."""
    from .pair import _block_fields_pairs, _pair_ein
    blocked = _block_fields_pairs(Hb, block).movedim(0, -2)
    out = _pair_ein("...dn,...dk->...nk", vv, blocked, conj_a=True)
    return out.reshape(tuple(latc) + (nc, Hb.shape[0], 2))


def _make_probes(fine_parts, block, latc, fine_shape, nc):
    """(probe_diag, probe_dir) on a column batch Wb of fine fields."""

    def probe_diag(vv, Wb):
        return _rcols_pr(vv, fine_parts.diag(Wb), block, latc, nc)

    def probe_dir(vv, Wb, mu, sign):
        H = fine_parts.hop(Wb, mu, sign)
        m = _mask_for(latc, fine_shape, block, mu, sign, H.ndim, H.device)
        ycol = _rcols_pr(vv, H * m, block, latc, nc)
        if latc[axis_of_mu(mu)] == 1:
            return ycol, torch.zeros_like(ycol)
        return ycol, _rcols_pr(vv, H * (1.0 - m), block, latc, nc)
    return probe_diag, probe_dir


# live fine fields per probe column at the peak of a chunk: the unblocked
# column, its hop, the two masked copies, the blocked copy the restriction
# reads, and the hop's shifted neighbour and product
_FIELDS_PER_COLUMN = 8


def _probe_chunk(transfer, nc: int) -> int:
    """Probe columns per chunk: all ``nc`` on the CPU; on the card as
    many as fit, at ``_FIELDS_PER_COLUMN`` fine fields each, in half the
    memory the process can still take (the device's free memory and what
    PyTorch's allocator holds unused)."""
    v = transfer.v
    if v.device.type != "cuda":
        return nc
    free, _ = torch.cuda.mem_get_info(v.device)
    free += (torch.cuda.memory_reserved(v.device)
             - torch.cuda.memory_allocated(v.device))
    field = (int(np.prod(transfer.fine_shape)) * 4 * transfer.k_fine
             * v.element_size())
    return max(1, min(nc, free // (2 * _FIELDS_PER_COLUMN * field)))


def _build_stencil(v, wb, unblock, probe_diag, probe_dir, nc, chunk,
                   cat_axis):
    """The chunked probe loop: per chunk of ``chunk`` columns, unblock
    only that chunk's probe columns to fine fields, run the diag and 8
    hop probes, and gather X and the 8 links Y."""
    x_parts, y_parts = [], {d: [] for d in DIRS}
    for c0 in range(0, nc, chunk):
        Wb = unblock(wb[c0:c0 + chunk])
        xacc = probe_diag(v, Wb)
        for d in DIRS:
            ycol, dcol = probe_dir(v, Wb, *d)
            y_parts[d].append(ycol)
            xacc = xacc + dcol
        x_parts.append(xacc)
        del Wb

    def cat(ps):
        return ps[0] if len(ps) == 1 else torch.cat(ps, dim=cat_axis)
    return cat(x_parts), {d: cat(y_parts[d]) for d in DIRS}


def build_coarse_pairs_gemm(fine_parts, transfer, g5_hermitian: bool = True,
                            chunk: Optional[int] = None):
    """The coarse operator R M P of ``fine_parts`` (a level operator with
    batch-aware ``diag`` and ``hop``) on pair arrays: the same
    PairCoarseOperator as mg/pair.build_coarse_pairs, to f32 rounding.
    ``chunk`` (probe columns at once) defaults to ``_probe_chunk``'s."""
    from .pair import PairCoarseOperator, _unblock_fields_pairs

    latc = transfer.coarse_shape
    fine_shape = transfer.fine_shape
    block = transfer.block
    n = transfer.n_vec
    nc = 2 * n
    v = transfer.v                             # (latc, 2, D, N, 2)
    _check_extents(latc)
    chunk = _probe_chunk(transfer, nc) if chunk is None else min(chunk, nc)

    # probe column c0*n + b: aggregate column b of V on chirality c0
    sel = torch.eye(2, dtype=v.dtype, device=v.device)
    cols = v.movedim(-2, 0)                    # (N, latc, 2, D, 2)
    wb = cols[None] * sel[:, None, None, None, None, None, :, None, None]
    wb = wb.reshape((nc,) + tuple(v.shape[:4]) + (2, v.shape[5], 2))

    probe_diag, probe_dir = _make_probes(fine_parts, block, latc,
                                         fine_shape, nc)
    x, y = _build_stencil(
        v, wb,
        lambda w: _unblock_fields_pairs(w, block, fine_shape,
                                        transfer.k_fine),
        probe_diag, probe_dir, nc, chunk, cat_axis=-2)
    return PairCoarseOperator(x.contiguous(),
                              {d: y[d].contiguous() for d in DIRS}, n,
                              g5_hermitian)
