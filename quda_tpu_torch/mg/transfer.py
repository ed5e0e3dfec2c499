"""Chiral layout and block aggregation, as in quda_tpu/mg/transfer.py.

A fine Wilson field enters the hierarchy as (lat..., 2, K): the gamma5
chirality (spins 0,1 -> 0 and 2,3 -> 1) and K = 6 components (2 spins x 3
colours) within it; a fine staggered field with K = 3 colours, the site
parity as chirality (mg/pair.PairStaggeredLevelOp).  The blocking is the
same for any K.  ``_block_fields`` gathers the sites of each
geometric block into one aggregate axis D = prod(block) * K, keeping the
chirality outside the aggregate.  The complex ``Transfer`` belongs to the
complex hierarchy, which is not ported (ROADMAP A12); mg/pair.py holds
the pair transfer.
"""

from __future__ import annotations

import torch


def to_chiral(psi: torch.Tensor) -> torch.Tensor:
    """(lat..., 4, 3) -> (lat..., 2, 6)."""
    lat = psi.shape[:-2]
    return psi.reshape(lat + (2, 6))


def from_chiral(psi: torch.Tensor) -> torch.Tensor:
    lat = psi.shape[:-2]
    return psi.reshape(lat + (4, 3))


def _block_fields(fields: torch.Tensor, block):
    """(B, T,Z,Y,X, 2, K, *tail) -> (B, Tc,Zc,Yc,Xc, 2, D, *tail) with
    D = bt*bz*by*bx*K; ``tail`` is () for complex fields and (2,) for
    pair fields."""
    Bn, T, Z, Y, X, two, K = fields.shape[:7]
    tail = tuple(fields.shape[7:])
    bt, bz, by, bx = block
    r = fields.reshape((Bn, T // bt, bt, Z // bz, bz, Y // by, by,
                        X // bx, bx, two, K) + tail)
    nt = len(tail)
    r = r.permute((0, 1, 3, 5, 7, 9, 2, 4, 6, 8, 10)
                  + tuple(range(11, 11 + nt)))
    return r.reshape((Bn, T // bt, Z // bz, Y // by, X // bx, two,
                      bt * bz * by * bx * K) + tail)


def _unblock_fields(blocked: torch.Tensor, block, fine_shape, K):
    """The inverse of ``_block_fields``."""
    Bn = blocked.shape[0]
    tail = tuple(blocked.shape[7:])
    T, Z, Y, X = fine_shape
    bt, bz, by, bx = block
    r = blocked.reshape((Bn, T // bt, Z // bz, Y // by, X // bx, 2,
                         bt, bz, by, bx, K) + tail)
    nt = len(tail)
    r = r.permute((0, 1, 6, 2, 7, 3, 8, 4, 9, 5, 10)
                  + tuple(range(11, 11 + nt)))
    return r.reshape((Bn, T, Z, Y, X, 2, K) + tail)
