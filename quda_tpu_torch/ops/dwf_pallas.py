"""Ls-batched 4d hop for domain-wall / Möbius fermions.

Port of quda_tpu/ops/dwf_pallas.py.  The 4d hop of a 5d operator is the
multi-RHS Wilson problem with Ls in the place of the right-hand sides:
the (Ls, 4, 3, 2, T, Z, Y*Xh) pair layout of models/domain_wall is the
(N, ...) layout of ops/wilson_pallas_packed.dslash_eo_pallas_packed_mrhs
(B5-eo, ``csrc/wilson_eo_mrhs.cu``), whose links are loaded once per
chunk of planes: 576/NB + 192 B per site and plane, against 768 for a
B1 launch per s plane.  These wrappers check the 5d layout and delegate;
they add no kernel.  B5-eo has float32 forms only (bf16: ROADMAP B5).
"""

from __future__ import annotations

from . import wilson_pallas_packed as wpp


def _check_psi5(psi_pl):
    if psi_pl.ndim != 7 or tuple(psi_pl.shape[1:4]) != (4, 3, 2):
        raise ValueError(
            "expected Ls-major packed pairs (Ls,4,3,2,T,Z,YXh), got "
            f"{tuple(psi_pl.shape)}")


def dslash_eo_pallas_packed_ls(u_here_pl, u_bw_pl, psi_pl, dims,
                               target_parity: int, out_dtype=None,
                               tb_sign: bool = True):
    """The eo 4d hop on every s plane of an (Ls,4,3,2,T,Z,YXh) spinor, one
    B5-eo launch with Ls as the batch.  On the card psi must be
    contiguous (the kernel reads raw pointers; a strided batch raises)."""
    _check_psi5(psi_pl)
    return wpp.dslash_eo_pallas_packed_mrhs(
        u_here_pl, u_bw_pl, psi_pl, tuple(dims), target_parity,
        out_dtype=out_dtype, tb_sign=tb_sign)


def dslash_eo_pallas_packed_ls_mrhs(u_here_pl, u_bw_pl, psi_pl, dims,
                                    target_parity: int, out_dtype=None,
                                    tb_sign: bool = True):
    """Multi-source variant: (N, Ls, 4,3,2,T,Z,YXh) flattened to an
    (N*Ls)-deep batch, sources and s planes sharing each link load."""
    if psi_pl.ndim != 8 or tuple(psi_pl.shape[2:5]) != (4, 3, 2):
        raise ValueError(
            "expected (N,Ls,4,3,2,T,Z,YXh) packed pairs, got "
            f"{tuple(psi_pl.shape)}")
    n, ls = psi_pl.shape[:2]
    flat = psi_pl.reshape((n * ls,) + tuple(psi_pl.shape[2:]))
    out = wpp.dslash_eo_pallas_packed_mrhs(
        u_here_pl, u_bw_pl, flat, tuple(dims), target_parity,
        out_dtype=out_dtype, tb_sign=tb_sign)
    return out.reshape(tuple(psi_pl.shape[:2]) + tuple(out.shape[1:]))
