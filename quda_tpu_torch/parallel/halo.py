"""Face transport between sub-domains, the sharded shift and the global
sum — port of quda_tpu/parallel/halo.py.

The JAX package moves a face with ``lax.ppermute`` inside ``shard_map``;
here one controller holds every block of a ``ShardedField``
(parallel/mesh.py), so a transfer is a list of faces, one per
sub-domain, each copied into a buffer of its receiver on the receiver's
device.  ``_permute_slice`` is that plain transport: the ``xla_facefix``
policy's exchange and the plain version of the exchange kernel
(parallel/pallas_halo.slab_exchange_bidir).  The JAX package's comms
ledger (``obs/comms.record_exchange``) has no counterpart until ROADMAP
A17.

``make_sharded_shift`` returns the shift of ops/shift.py for canonical
(T, Z, Y, X, ...) ShardedFields: a local roll plus the boundary faces
from the neighbour.  ``psum_scalar`` adds per-block partial sums in
sub-domain order on the first sub-domain's device, a fixed order, so
runs are reproducible.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..fields.geometry import axis_of_mu
from .mesh import AXES, LatticeMesh, ShardedField


def _permute_slice(faces: Sequence[torch.Tensor], mesh: LatticeMesh,
                   axis_name: str, towards_lower: bool) -> list:
    """Send each sub-domain's face to its neighbour along ``axis_name``.

    towards_lower: sub-domain i sends to i-1 (receives from i+1).  Each
    received face is a copy on the receiver's device."""
    step = 1 if towards_lower else -1
    return [faces[mesh.neighbor(i, axis_name, step)].to(dev, copy=True)
            for i, dev in enumerate(mesh.devices)]


def make_sharded_shift(mesh: LatticeMesh) -> Callable:
    """shift(field, mu, sign, nhop=1) on canonical ShardedFields.

    Semantics match ops.shift.shift on the GLOBAL array: result[x] =
    field[x + sign*nhop*mu_hat], periodic globally.  nhop <= local extent
    is required."""
    def shift(field: ShardedField, mu: int, sign: int, nhop: int = 1):
        ax = axis_of_mu(mu)
        name = AXES[ax]
        if field.spec[ax] not in ((), (name,)):
            raise ValueError(f"array axis {ax} is cut by {field.spec[ax]}, "
                             f"not by mesh axis {name!r}")
        rolled = [torch.roll(b, -sign * nhop, dims=ax) for b in field.blocks]
        if mesh.shape[name] == 1 or not field.spec[ax]:
            return ShardedField(rolled, mesh, field.spec)
        L = field.local_shape[ax]
        if nhop > L:
            raise ValueError(f"nhop {nhop} exceeds the local extent {L}")
        if sign > 0:
            faces = [b.narrow(ax, 0, nhop) for b in field.blocks]
            recv = _permute_slice(faces, mesh, name, towards_lower=True)
            start = L - nhop
        else:
            faces = [b.narrow(ax, L - nhop, nhop) for b in field.blocks]
            recv = _permute_slice(faces, mesh, name, towards_lower=False)
            start = 0
        for r, f in zip(rolled, recv):
            r.narrow(ax, start, nhop).copy_(f)
        return ShardedField(rolled, mesh, field.spec)

    return shift


def psum_scalar(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Global sum of per-sub-domain partials (comm_allreduce): added in
    sub-domain order on the first sub-domain's device."""
    parts = list(parts)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p.to(acc.device)
    return acc
