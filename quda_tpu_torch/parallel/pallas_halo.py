"""The halo kernels of the sharded Wilson path (B12), their plain versions
and the composed references — port of quda_tpu/parallel/pallas_halo.py.

The JAX package's three Pallas TPU kernels move faces between chips with
in-kernel remote copies behind a neighbour barrier.  Here the
sub-domains of a mesh (parallel/mesh.py) may share one card (a virtual
mesh) or sit on several cards of a host, and the hand-written CUDA
kernels of ``csrc/halo.cu`` read a neighbour's block through its
pointer:

* ``slab_exchange_bidir`` — the policy seam's transport: each
  sub-domain's ``send_down`` goes to its -1 neighbour and ``send_up`` to
  its +1 neighbour along one mesh axis; returns ``(from_up, from_down)``,
  the result of two ``_permute_slice`` transports.  One launch per card
  copies every face bound for that card, read in place from its block
  (16-byte vector copies), bit for bit its plain version
  ``slab_exchange_plain``.
* ``wilson_axis_fused_halo`` (and its z and t wrappers) — both hops of a
  partitioned direction mu (2: psi (4,3,2,Z,YX), links (3,3,2,Z,YX); 3:
  (4,3,2,T,Z,YX) and (3,3,2,T,Z,YX)), cut along array axis 3, with the
  boundary planes read from the neighbours inside the launch; equal to
  ``wilson_axis_composed`` on the gathered field.
* ``wilson_zbwd_fused_halo`` — the backward z hop alone.

Fields are ShardedFields; the fused hops take float32 (as the TPU
kernels).  CPU blocks run the plain versions (``slab_exchange_plain``,
``wilson_axis_halo_plain``: the TPU kernels' algorithm, with the product
and half-spinor strips carried by ``_permute_slice``); CUDA blocks launch
the kernel or raise.  Where sub-domains sit on several cards, peer
access is enabled once per pair of cards and a refusal raises: nothing
is staged through the host.  ``.launches`` counts kernel launches (one
per card per call).  The JAX package's comms ledger
(``obs/comms.record_exchange``) has no counterpart until ROADMAP A17.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch

from ..ops import wilson_packed as wpk
from ..ops.wilson_pallas import TABLES
from ..utils import kernels
from .halo import _permute_slice
from .mesh import LatticeMesh, ShardedField

MAX_ENTRIES = 64           # the kernels' tables (csrc/halo.cu kMaxEntries)
# Fused hop against its plain version and the composed reference, max
# |kernel - plain| / max |plain|: the same f32 arithmetic, in another
# order and with fused multiply-adds on the card.
TOLERANCE = 1e-6
# Floor of a fused hop's traffic per site in bytes: psi 24, links 18 and
# out 24 float32 numbers (the neighbours' planes are part of the inputs).
BYTES_PER_SITE = (24 + 18 + 24) * 4


# -- dispatch ---------------------------------------------------------------

def _kind(tensors: Sequence[torch.Tensor]) -> str:
    """'cpu' or 'cuda' for blocks that may lie on several devices of one
    type (each device's group through kernels.dispatch_device)."""
    groups: dict = {}
    for t in tensors:
        groups.setdefault(t.device, []).append(t)
    kinds = {kernels.dispatch_device(*g) for g in groups.values()}
    if len(kinds) != 1:
        raise ValueError(f"blocks on several device types: {sorted(kinds)}")
    return kinds.pop()


_PEERS: set = set()


def enable_peer_access(devices) -> None:
    """Let every card of ``devices`` read every other's memory (once per
    pair); raises where CUDA refuses a pair."""
    idx = sorted({d.index for d in devices if d.type == "cuda"})
    if len(idx) < 2:
        return
    lib = kernels.library()
    for a in idx:
        for b in idx:
            if a == b or (a, b) in _PEERS:
                continue
            rc = lib.qtt_enable_peer_access(a, b)
            if rc != 0:
                raise RuntimeError(
                    f"peer access from cuda:{a} to cuda:{b} refused (CUDA "
                    f"error {rc}): the halo kernels read a neighbour's "
                    "block through a peer pointer and never stage through "
                    "the host")
            _PEERS.add((a, b))


def _order_after(sources, dev: torch.device) -> torch.cuda.Stream:
    """The stream of ``dev``, made to wait for the work that wrote the
    ``sources`` lying on other cards (an event on their streams), and
    recorded on those sources so their memory outlives the read."""
    stream = torch.cuda.current_stream(dev)
    for t in sources:
        if t.device != dev:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(t.device))
            stream.wait_event(ev)
            t.record_stream(stream)
    return stream


def _ptrs(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _ints(values) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*values)


def _longs(values) -> ctypes.Array:
    return (ctypes.c_longlong * len(values))(*values)


def face_runs(t: torch.Tensor):
    """(run_bytes, runs, stride_bytes): the face ``t`` as ``runs``
    contiguous runs of ``run_bytes``, each ``stride_bytes`` after the last
    in memory, in row-major order, which is how the exchange kernel reads
    it in place.  A narrow of a contiguous block along one axis (a t or z
    plane, a y row strip, an x column) is such a pattern; any other view
    raises."""
    es = t.element_size()
    dims = [(n, st) for n, st in zip(t.shape, t.stride()) if n != 1]
    inner = 1
    while dims and dims[-1][1] == inner:
        inner *= dims.pop()[0]
    if not dims:
        return inner * es, 1, inner * es
    runs, step = dims.pop()
    while dims:
        n, st = dims.pop()
        if st != runs * step:
            raise ValueError(
                f"face of shape {tuple(t.shape)}, strides {t.stride()}: not "
                "evenly strided contiguous runs (a narrow of a contiguous "
                "block along one axis)")
        runs *= n
    return inner * es, runs, step * es


# -- the slab exchange ------------------------------------------------------

def slab_exchange_plain(send_down, send_up, mesh: LatticeMesh,
                        axis_name: str):
    """Plain version of ``slab_exchange_bidir``: two ``_permute_slice``
    transports."""
    return (_permute_slice(send_down, mesh, axis_name, towards_lower=True),
            _permute_slice(send_up, mesh, axis_name, towards_lower=False))


def slab_exchange_bidir(send_down: Sequence[torch.Tensor],
                        send_up: Sequence[torch.Tensor], mesh: LatticeMesh,
                        axis_name: str):
    """Exchange two boundary slabs of every sub-domain along ``axis_name``:
    returns ``(from_up, from_down)``, lists over the sub-domains,

      from_up[i]   = send_down[i + 1]   (the -1 transport)
      from_down[i] = send_up[i - 1]     (the +1 transport)

    each a buffer of its receiver on the receiver's device.  Any slab
    shape and dtype (one for all sub-domains); the kernel reads each face
    in place as evenly strided runs (``face_runs``)."""
    send_down, send_up = list(send_down), list(send_up)
    if len(send_down) != mesh.size or len(send_up) != mesh.size:
        raise ValueError(f"one slab per sub-domain ({mesh.size}) expected")
    if _kind(send_down + send_up) == "cpu":
        return slab_exchange_plain(send_down, send_up, mesh, axis_name)
    for name, faces in (("send_down", send_down), ("send_up", send_up)):
        f0 = faces[0]
        for f in faces:
            if f.shape != f0.shape or f.dtype != f0.dtype:
                raise ValueError(f"{name}: slabs of one shape and dtype "
                                 "expected")
    lib = kernels.library()
    enable_peer_access(mesh.devices)
    from_up, from_down, copies = [], [], {}
    for i, dev in enumerate(mesh.devices):
        a = send_down[mesh.neighbor(i, axis_name, +1)]
        b = send_up[mesh.neighbor(i, axis_name, -1)]
        from_up.append(torch.empty(a.shape, dtype=a.dtype, device=dev))
        from_down.append(torch.empty(b.shape, dtype=b.dtype, device=dev))
        copies.setdefault(dev, []).extend([(a, from_up[-1]),
                                           (b, from_down[-1])])
    for dev, pairs in copies.items():
        for k in range(0, len(pairs), MAX_ENTRIES):
            chunk = pairs[k:k + MAX_ENTRIES]
            with torch.cuda.device(dev):
                stream = _order_after([s for s, _ in chunk], dev)
                run, runs, stride = zip(*[face_runs(s) for s, _ in chunk])
                rc = lib.qtt_slab_exchange(
                    _ptrs([s for s, _ in chunk]), _ptrs([d for _, d in chunk]),
                    _longs(run), _longs(runs), _longs(stride), len(chunk),
                    stream.cuda_stream)
            kernels.check_launch(rc, "qtt_slab_exchange")
            slab_exchange_bidir.launches += 1
    return from_up, from_down


slab_exchange_bidir.launches = 0


# -- the fused-halo hops ----------------------------------------------------

def _check_axis_fields(psi: ShardedField, u: ShardedField, mu: int,
                       axis_name: str) -> None:
    if mu not in (2, 3):
        raise ValueError(f"mu must be 2 (z) or 3 (t), got {mu}")
    rank = 5 if mu == 2 else 6
    if psi.ndim != rank or u.ndim != rank:
        raise ValueError(f"mu={mu} takes rank-{rank} blocks (4,3,2,...) and "
                         f"(3,3,2,...), got {psi.local_shape} and "
                         f"{u.local_shape}")
    if psi.local_shape[:3] != (4, 3, 2) or u.local_shape[:3] != (3, 3, 2) \
            or psi.local_shape[3:] != u.local_shape[3:]:
        raise ValueError(f"blocks {psi.local_shape} and {u.local_shape} are "
                         "not a (4,3,2,...) spinor and its (3,3,2,...) links")
    want = ((), (), (), (axis_name,)) + ((),) * (rank - 4)
    for name, f in (("psi", psi), ("u", u)):
        if f.spec != want:
            raise ValueError(f"{name}: cut {f.spec}, the fused-halo hops "
                             f"take array axis 3 cut by {axis_name!r} alone")
    if u.mesh != psi.mesh:
        raise ValueError("psi and u on different meshes")


def wilson_axis_halo_plain(psi: ShardedField, u: ShardedField,
                           mu: int = 2, axis_name: str = "z",
                           bidir: bool = True) -> ShardedField:
    """Plain version of the fused-halo hops, the TPU kernels' algorithm:
    the backward products m = U^dag P+ psi of every local plane, rolled up
    one plane with the -mu neighbour's last product strip spliced in at
    plane 0; with ``bidir`` also the forward half spinors P- psi rolled
    down with the +mu neighbour's first strip at plane L-1, then
    multiplied by the local links.  The strips ride ``_permute_slice``."""
    mesh = psi.mesh
    tb, tf = TABLES[(mu, -1)], TABLES[(mu, +1)]
    psis = [p.to(torch.float32) for p in psi.blocks]
    us = [v.to(torch.float32) for v in u.blocks]
    m = [wpk.color_mul_pairs(v, wpk.half_pairs(p, tb), True)
         for p, v in zip(psis, us)]
    L = psi.local_shape[3]
    m_last = [x.narrow(3, L - 1, 1) for x in m]
    if bidir:
        h = [wpk.half_pairs(p, tf) for p in psis]
        h_first, m_in = slab_exchange_plain([x.narrow(3, 0, 1) for x in h],
                                            m_last, mesh, axis_name)
    else:
        m_in = _permute_slice(m_last, mesh, axis_name, towards_lower=False)
    outs = []
    for i, blk in enumerate(psi.blocks):
        uh_b = torch.roll(m[i], 1, dims=3)
        uh_b[:, :, :, 0:1] = m_in[i]
        out = wpk.recon_pairs(uh_b, tb)
        if bidir:
            h_sp = torch.roll(h[i], -1, dims=3)
            h_sp[:, :, :, L - 1:L] = h_first[i]
            out = out + wpk.recon_pairs(
                wpk.color_mul_pairs(us[i], h_sp, False), tf)
        outs.append(out.to(blk.dtype))
    return ShardedField(outs, mesh, psi.spec)


def _axis_halo(psi: ShardedField, u: ShardedField, mu: int, axis_name: str,
               bidir: bool, fn) -> ShardedField:
    """The dispatch of the fused-halo entries: CPU blocks -> the plain
    version, CUDA blocks -> one launch of qtt_wilson_axis_halo per card."""
    _check_axis_fields(psi, u, mu, axis_name)
    mesh = psi.mesh
    if _kind(list(psi.blocks) + list(u.blocks)) == "cpu":
        return wilson_axis_halo_plain(psi, u, mu, axis_name, bidir)
    if mesh.size > MAX_ENTRIES:
        raise ValueError(f"{mesh.size} sub-domains: the kernel's table "
                         f"holds {MAX_ENTRIES}")
    shape = psi.local_shape
    for p, v in zip(psi.blocks, u.blocks):
        kernels.require(p, "psi", shape)
        kernels.require(v, "u", (3, 3, 2) + shape[3:])
    lib = kernels.library()
    enable_peer_access(mesh.devices)
    outs = [torch.empty_like(p) for p in psi.blocks]
    n = mesh.size
    dn = [mesh.neighbor(i, axis_name, -1) for i in range(n)]
    up = [mesh.neighbor(i, axis_name, +1) for i in range(n)]
    L, S = shape[3], math.prod(shape[4:])
    tables = (_ptrs(psi.blocks), _ptrs(u.blocks), _ptrs(outs), _ints(dn),
              _ints(up))
    for dev in mesh.distinct_devices():
        sel = [i for i in range(n) if mesh.devices[i] == dev]
        with torch.cuda.device(dev):
            reads = [t for i in sel for j in (dn[i], up[i])
                     for t in (psi.blocks[j], u.blocks[j])]
            stream = _order_after(reads, dev)
            rc = lib.qtt_wilson_axis_halo(
                *tables, n, _ints(sel), len(sel), L, S, mu, int(bidir),
                stream.cuda_stream)
        kernels.check_launch(rc, "qtt_wilson_axis_halo")
        fn.launches += 1
    return ShardedField(outs, mesh, psi.spec)


def wilson_axis_fused_halo(psi: ShardedField, u: ShardedField, mu: int = 2,
                           axis_name: str = "z") -> ShardedField:
    """BOTH hops of one partitioned direction with the halo read inside one
    launch per card.  mu=2: psi (4,3,2,Z,YX) / u (3,3,2,Z,YX) cut along
    Z by ``axis_name``; mu=3: psi (4,3,2,T,Z,YX) / u (3,3,2,T,Z,YX) cut
    along T.  Matches ``wilson_axis_composed(psi, u, mu)`` on the gathered
    fields."""
    return _axis_halo(psi, u, mu, axis_name, True, wilson_axis_fused_halo)


wilson_axis_fused_halo.launches = 0


def wilson_z_fused_halo(psi: ShardedField, uz: ShardedField,
                        axis_name: str = "z") -> ShardedField:
    """BOTH z hops fused; matches ``wilson_z_composed``."""
    return wilson_axis_fused_halo(psi, uz, mu=2, axis_name=axis_name)


def wilson_t_fused_halo(psi: ShardedField, ut: ShardedField,
                        axis_name: str = "t") -> ShardedField:
    """BOTH t hops fused on (4,3,2,T,Z,YX); matches ``wilson_t_composed``."""
    return wilson_axis_fused_halo(psi, ut, mu=3, axis_name=axis_name)


def wilson_zbwd_fused_halo(psi: ShardedField, uz: ShardedField,
                           axis_name: str = "z") -> ShardedField:
    """The z-backward Wilson hop U_z(x-z)^dag P+z psi(x-z) with the halo
    read inside the launch: psi (4,3,2,Z,YX), uz (3,3,2,Z,YX) cut along Z
    by ``axis_name``.  Matches ``wilson_zbwd_composed``."""
    return _axis_halo(psi, uz, 2, axis_name, False, wilson_zbwd_fused_halo)


wilson_zbwd_fused_halo.launches = 0


def reset_launches() -> None:
    for fn in (slab_exchange_bidir, wilson_axis_fused_halo,
               wilson_zbwd_fused_halo):
        fn.launches = 0


# -- the composed references on global tensors -----------------------------

def _composed_hop(psi_pl: torch.Tensor, u_pl: torch.Tensor, sign: int,
                  mu: int = 2) -> torch.Tensor:
    """One hop of direction ``mu`` on GLOBAL tensors (torch.roll is the
    exchange).  sign=-1: backward (adjoint link, product rolled up one
    plane); sign=+1: forward (half spinor rolled down, then the local
    link).  The partitioned axis is array axis 3 in both the z (rank 5)
    and t (rank 6) forms."""
    t = TABLES[(mu, sign)]
    h = wpk.half_pairs(psi_pl.to(torch.float32), t)
    if sign > 0:
        h = torch.roll(h, -1, dims=3)
    m = wpk.color_mul_pairs(u_pl.to(torch.float32), h, sign < 0)
    if sign < 0:
        m = torch.roll(m, 1, dims=3)
    return wpk.recon_pairs(m, t).to(psi_pl.dtype)


def wilson_axis_composed(psi_pl: torch.Tensor, u_pl: torch.Tensor,
                         mu: int = 2) -> torch.Tensor:
    """Composed reference for BOTH mu hops on global tensors."""
    return (_composed_hop(psi_pl, u_pl, -1, mu)
            + _composed_hop(psi_pl, u_pl, +1, mu))


def wilson_z_composed(psi_pl: torch.Tensor,
                      uz_pl: torch.Tensor) -> torch.Tensor:
    return wilson_axis_composed(psi_pl, uz_pl, 2)


def wilson_t_composed(psi_pl: torch.Tensor,
                      ut_pl: torch.Tensor) -> torch.Tensor:
    return wilson_axis_composed(psi_pl, ut_pl, 3)


def wilson_zbwd_composed(psi_pl: torch.Tensor,
                         uz_pl: torch.Tensor) -> torch.Tensor:
    """Composed reference for the backward z term on global tensors."""
    return _composed_hop(psi_pl, uz_pl, -1)
