"""The multigrid coarse stencil in one launch (B8) and its plain version.

Replaces quda_tpu/ops/coarse_pallas.py::coarse_apply_pallas (the Pallas
TPU kernel) with the hand-written CUDA kernel ``csrc/coarse.cu``.  The
coarse operator lives on the interleaved real embedding (mg/pair.py: a
complex entry g becomes [[re, -im], [im, re]], so a complex Nc x Nc
matvec is one real E x E matvec with E = 2 Nc):

    links  (9, S, E, E) float32   [diag, then the 8 hop directions]
    psi9   (9, S, E)    float32   the input and its 8 pre-rolled
                                  neighbour copies, in the same order
    out    (S, E)                 out[s] = sum_k links[k, s] @ psi9[k, s]

The wrapper dispatches on the tensors' device: CPU tensors run the plain
version ``coarse_apply_ref`` (the einsum "ksab,ksb->sa", the JAX
package's reference), CUDA tensors launch the kernel or raise.  Its
launches are counted in ``coarse_apply_pallas.launches``.

``coarse_apply_pallas_mrhs`` applies the same links to N right-hand
sides, psi9 (N, 9, S, E) -> (N, S, E), each link read once per chunk of
``MRHS_CHUNK``: the coarse levels' null-vector block solves, where the
JAX package vmaps its kernel (every lane re-reading the links).  Each
right-hand side gets the single form's sums in its order.  Plain
version: ``coarse_apply_mrhs_ref``.
"""

from __future__ import annotations

import torch

from ..utils import kernels

# Kernel vs plain version, max |kernel - plain| / max |plain|: the same
# 9 E products per output, summed in another order (strided lane partial
# sums and a shuffle tree against the einsum's order).
TOLERANCE = 1e-5
MAX_E = 1024                # the psi9 copy of a site fits 48 KB of shared memory

MRHS_CHUNK = 8              # right-hand sides per block (kMrhsChunk)
MAX_E_MRHS = 160            # their psi9 copies fit 48 KB of shared memory

_SPEC = "ksab,ksb->sa"


def coarse_apply_ref(links: torch.Tensor, psi9: torch.Tensor) -> torch.Tensor:
    """The plain version: einsum "ksab,ksb->sa", float32."""
    return torch.einsum(_SPEC, links, psi9)


def coarse_apply_mrhs_ref(links: torch.Tensor,
                          psi9: torch.Tensor) -> torch.Tensor:
    """The plain multi-RHS version: einsum "ksab,nksb->nsa", float32."""
    return torch.einsum("ksab,nksb->nsa", links, psi9)


def coarse_model(nc: int) -> dict:
    """Per-coarse-site flops and bytes of the apply at Nc colours
    (E = 2 Nc): 9 real E x E matvecs; links once, the 9 psi reads and the
    output, float32."""
    e = 2 * nc
    return {"flops_per_site": 18 * e * e,
            "bytes_per_site": 36 * e * e + 40 * e}


def coarse_apply_pallas(links: torch.Tensor,
                        psi9: torch.Tensor) -> torch.Tensor:
    """Fused coarse M: links (9, S, E, E), psi9 (9, S, E) -> (S, E)."""
    if psi9.ndim != 3 or psi9.shape[0] != 9:
        raise ValueError(f"psi9 of shape {tuple(psi9.shape)}: expected "
                         "(9, S, E)")
    _, S, E = psi9.shape
    if tuple(links.shape) != (9, S, E, E):
        raise ValueError(f"links of shape {tuple(links.shape)}: expected "
                         f"{(9, S, E, E)} for psi9 {tuple(psi9.shape)}")
    kind = kernels.dispatch_device(links, psi9)
    if kind == "cpu":
        return coarse_apply_ref(links, psi9)
    f32 = torch.float32
    kernels.require(links, "links", (9, S, E, E), f32)
    kernels.require(psi9, "psi9", (9, S, E), f32)
    if not 1 <= E <= MAX_E or S > 2 ** 31 - 1:
        raise ValueError(f"E = {E}, S = {S}: the kernel takes 1 <= E <= "
                         f"{MAX_E} and S < 2^31")
    lib = kernels.library()
    out = torch.empty((S, E), dtype=f32, device=psi9.device)
    rc = lib.qtt_coarse_apply(out.data_ptr(), links.data_ptr(),
                              psi9.data_ptr(), S, E,
                              kernels.stream_of(psi9))
    kernels.check_launch(rc, "qtt_coarse_apply")
    coarse_apply_pallas.launches += 1
    return out


def coarse_apply_pallas_mrhs(links: torch.Tensor,
                             psi9: torch.Tensor) -> torch.Tensor:
    """Fused coarse M on N right-hand sides: links (9, S, E, E), psi9
    (N, 9, S, E) -> (N, S, E)."""
    if psi9.ndim != 4 or psi9.shape[1] != 9:
        raise ValueError(f"psi9 of shape {tuple(psi9.shape)}: expected "
                         "(N, 9, S, E)")
    N, _, S, E = psi9.shape
    if tuple(links.shape) != (9, S, E, E):
        raise ValueError(f"links of shape {tuple(links.shape)}: expected "
                         f"{(9, S, E, E)} for psi9 {tuple(psi9.shape)}")
    kind = kernels.dispatch_device(links, psi9)
    if kind == "cpu":
        return coarse_apply_mrhs_ref(links, psi9)
    f32 = torch.float32
    kernels.require(links, "links", (9, S, E, E), f32)
    kernels.require(psi9, "psi9", (N, 9, S, E), f32)
    if not 1 <= E <= MAX_E_MRHS or N < 1 or \
            S * -(-N // MRHS_CHUNK) > 2 ** 31 - 1:
        raise ValueError(f"E = {E}, N = {N}, S = {S}: the multi-RHS kernel "
                         f"takes 1 <= E <= {MAX_E_MRHS} and N >= 1 within "
                         "2^31 - 1 blocks")
    lib = kernels.library()
    out = torch.empty((N, S, E), dtype=f32, device=psi9.device)
    rc = lib.qtt_coarse_apply_mrhs(out.data_ptr(), links.data_ptr(),
                                   psi9.data_ptr(), S, E, N,
                                   kernels.stream_of(psi9))
    kernels.check_launch(rc, "qtt_coarse_apply_mrhs")
    coarse_apply_pallas_mrhs.launches += 1
    return out


def reset_launches() -> None:
    coarse_apply_pallas.launches = 0
    coarse_apply_pallas_mrhs.launches = 0


reset_launches()
