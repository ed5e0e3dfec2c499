"""The mesh of sub-domains and the sharded fields on it.

Port of quda_tpu/parallel/mesh.py.  The JAX package maps the lattice onto
a ``jax.sharding.Mesh`` with axes (src, t, z, y, x) and lets a
``PartitionSpec`` cut each array; one controller drives every device of
the mesh.  The port keeps that design without JAX: a ``LatticeMesh``
holds the (t, z, y, x) grid of sub-domains and one ``torch.device`` per
sub-domain, and a ``ShardedField`` holds one resident block per
sub-domain.  One process drives the whole mesh, as in the JAX package
(no ``torch.distributed``: NCCL refuses two ranks on one card).

Devices may repeat: ``make_lattice_mesh((2, 2, 2, 1), devices=["cuda:0"]
* 8)`` is a virtual mesh of eight sub-domains on one card, the port's
counterpart of the JAX package's eight virtual CPU devices.  Each
sub-domain keeps blocks of its own, and the halo kernels
(parallel/pallas_halo.py) move faces between them on the card.  A mesh
whose sub-domains sit on several cards reads a neighbour's face through
a peer pointer.  A mesh that mixes CPU and CUDA devices is refused.

Specs follow ``PartitionSpec``: one entry per array axis, ``None``
(whole), a mesh axis name, or a tuple of names (a fused axis cut
row-major, as ``("y", "x")`` cuts the packed layouts' Y*X axis).  Mesh
axes a spec does not name replicate the field.  x-partitioned packed
fields are first re-laid out with ``fuse_block_layout`` so each block
holds whole rows of the local row width.

Blocks are numbered in C order over (src, t, z, y, x).  Elementwise
arithmetic on a ``ShardedField`` runs block by block on each block's
device; ``ops/blas.py`` sums reductions over the blocks with
``parallel/halo.psum_scalar``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device

AXES = ("t", "z", "y", "x")
SRC_AXIS = "src"
MESH_AXES = (SRC_AXIS,) + AXES


def factor_devices(n: int, ndim: int = 4) -> Tuple[int, ...]:
    """Factor n devices into a near-balanced ndim grid (largest factors on
    the leading/t axis, like QUDA's default rank grids)."""
    dims = [1] * ndim
    remaining = n
    i = 0
    while remaining > 1:
        f = 2
        while remaining % f:
            f += 1
        dims[i % ndim] *= f
        remaining //= f
        i += 1
    dims.sort(reverse=True)
    return tuple(dims)


class LatticeMesh:
    """A grid of sub-domains: (n_src, n_t, n_z, n_y, n_x) and one
    ``torch.device`` per sub-domain, in C order over those axes."""

    def __init__(self, grid: Sequence[int], n_src: int, devices):
        self.grid = tuple(int(g) for g in grid)
        if len(self.grid) != 4 or min(self.grid) < 1:
            raise ValueError(f"grid must be 4 positive counts (t, z, y, x), "
                             f"got {grid}")
        self.n_src = int(n_src)
        self.dims = (self.n_src,) + self.grid
        devs = tuple(torch.device(d) for d in devices)
        kinds = {d.type for d in devs}
        if len(kinds) != 1:
            raise ValueError("a mesh cannot mix device types: "
                             f"{sorted(kinds)}")
        kind = kinds.pop()
        if kind not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device type {kind!r}")
        if kind == "cuda":
            devs = tuple(resolve_device(d) for d in devs)
            devs = tuple(torch.device("cuda", d.index if d.index is not None
                                      else torch.cuda.current_device())
                         for d in devs)
        if len(devs) != math.prod(self.dims):
            raise ValueError(f"mesh {self.dims} != {len(devs)} devices")
        self.devices = devs
        self.device_type = kind
        self._coords = [tuple(int(c) for c in np.unravel_index(i, self.dims))
                        for i in range(len(devs))]
        self._nbrs: dict = {}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return dict(zip(MESH_AXES, self.dims))

    def coords(self, i: int) -> Tuple[int, ...]:
        """(src, t, z, y, x) coordinates of sub-domain i."""
        return self._coords[i]

    def coord(self, i: int, axis: str) -> int:
        return self.coords(i)[MESH_AXES.index(axis)]

    def index(self, coords) -> int:
        return int(np.ravel_multi_index(tuple(coords), self.dims))

    def neighbor(self, i: int, axis: str, step: int) -> int:
        """The sub-domain ``step`` places along ``axis`` from i (periodic)."""
        table = self._nbrs.get((axis, step))
        if table is None:
            a = MESH_AXES.index(axis)
            table = []
            for c in self._coords:
                c = list(c)
                c[a] = (c[a] + step) % self.dims[a]
                table.append(self.index(c))
            table = self._nbrs[(axis, step)] = tuple(table)
        return table[i]

    def distinct_devices(self):
        return tuple(dict.fromkeys(self.devices))

    def __eq__(self, other):
        return other is self or (isinstance(other, LatticeMesh)
                                 and self.dims == other.dims
                                 and self.devices == other.devices)

    def __repr__(self):
        return (f"LatticeMesh(grid={self.grid}, n_src={self.n_src}, "
                f"devices={[str(d) for d in self.distinct_devices()]})")


def make_lattice_mesh(grid: Optional[Sequence[int]] = None, n_src: int = 1,
                      devices=None) -> LatticeMesh:
    """A mesh with axes (src, t, z, y, x).

    ``grid``: sub-domains per lattice direction in (T, Z, Y, X) order,
    inferred from the device count when omitted (initCommsGridQuda analog,
    quda.h:981).  ``devices``: one device per sub-domain, repeats allowed
    (a virtual mesh); every card of the host when omitted (raises without
    one)."""
    if devices is None:
        resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if grid is None:
        grid = factor_devices(len(devices) // n_src, 4)
    return LatticeMesh(grid, n_src, devices)


def _norm_spec(spec, ndim: int) -> tuple:
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    if len(spec) != ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} axes")
    out = []
    for e in spec:
        names = () if e is None else (e,) if isinstance(e, str) else tuple(e)
        for n in names:
            if n not in MESH_AXES:
                raise ValueError(f"unknown mesh axis {n!r}; known: "
                                 f"{MESH_AXES}")
        out.append(names)
    return tuple(out)


def _block_slices(mesh: LatticeMesh, spec, shape, i: int):
    """(axis, start, length) of sub-domain i's block on each cut axis."""
    c = mesh.coords(i)
    out = []
    for ax, names in enumerate(spec):
        if not names:
            continue
        n = math.prod(mesh.shape[nm] for nm in names)
        if shape[ax] % n:
            raise ValueError(f"array axis {ax} of extent {shape[ax]} is not "
                             f"divisible by the {n} sub-domains of {names}")
        k = 0
        for nm in names:
            k = k * mesh.shape[nm] + c[MESH_AXES.index(nm)]
        ln = shape[ax] // n
        out.append((ax, k * ln, ln))
    return out


class ShardedField:
    """One block per sub-domain of ``mesh``, cut from a global array by
    ``spec`` (a normalized PartitionSpec: a tuple of mesh-axis-name tuples,
    one per array axis)."""

    __slots__ = ("blocks", "mesh", "spec")

    def __init__(self, blocks, mesh: LatticeMesh, spec):
        self.blocks = tuple(blocks)
        self.mesh = mesh
        self.spec = _norm_spec(spec, self.blocks[0].dim())
        if len(self.blocks) != mesh.size:
            raise ValueError(f"{len(self.blocks)} blocks for a mesh of "
                             f"{mesh.size} sub-domains")

    # -- description ----------------------------------------------------
    @property
    def dtype(self):
        return self.blocks[0].dtype

    @property
    def device(self):
        return self.blocks[0].device

    @property
    def ndim(self) -> int:
        return self.blocks[0].dim()

    @property
    def local_shape(self) -> tuple:
        return tuple(self.blocks[0].shape)

    @property
    def shape(self) -> tuple:
        """The global shape."""
        s = list(self.local_shape)
        for ax, names in enumerate(self.spec):
            for nm in names:
                s[ax] *= self.mesh.shape[nm]
        return tuple(s)

    def is_complex(self) -> bool:
        return self.blocks[0].is_complex()

    def __repr__(self):
        return (f"ShardedField(shape={self.shape}, dtype={self.dtype}, "
                f"spec={self.spec}, {self.mesh!r})")

    # -- block-wise arithmetic --------------------------------------------
    def map(self, fn) -> "ShardedField":
        """fn applied to every block; the result keeps mesh and spec."""
        return ShardedField([fn(b) for b in self.blocks], self.mesh,
                            self.spec)

    def _zip(self, other, fn) -> "ShardedField":
        if isinstance(other, ShardedField):
            if (other.mesh != self.mesh or other.spec != self.spec
                    or other.local_shape != self.local_shape):
                raise ValueError("ShardedFields of different meshes, specs "
                                 "or block shapes")
            return ShardedField([fn(a, b) for a, b in
                                 zip(self.blocks, other.blocks)],
                                self.mesh, self.spec)
        if isinstance(other, torch.Tensor):
            return self.map(lambda a: fn(a, other.to(a.device)))
        return self.map(lambda a: fn(a, other))

    def __add__(self, o):
        return self._zip(o, lambda a, b: a + b)

    def __radd__(self, o):
        return self._zip(o, lambda a, b: b + a)

    def __sub__(self, o):
        return self._zip(o, lambda a, b: a - b)

    def __rsub__(self, o):
        return self._zip(o, lambda a, b: b - a)

    def __mul__(self, o):
        return self._zip(o, lambda a, b: a * b)

    def __rmul__(self, o):
        return self._zip(o, lambda a, b: b * a)

    def to(self, *args, **kwargs) -> "ShardedField":
        """``Tensor.to`` on every block (a dtype; blocks stay on their
        devices)."""
        for a in list(args) + list(kwargs.values()):
            if isinstance(a, (str, torch.device)):
                raise ValueError("a ShardedField's blocks stay on the mesh's "
                                 "devices; gather() it first")
        return self.map(lambda a: a.to(*args, **kwargs))

    def zeros_like(self) -> "ShardedField":
        return self.map(torch.zeros_like)


def shard(arr: torch.Tensor, mesh: LatticeMesh, spec) -> ShardedField:
    """Cut a global tensor into one resident, contiguous block per
    sub-domain of ``mesh`` (``jax.device_put`` with a NamedSharding)."""
    spec = _norm_spec(spec, arr.dim())
    blocks = []
    for i, dev in enumerate(mesh.devices):
        piece = arr
        for ax, start, ln in _block_slices(mesh, spec, arr.shape, i):
            piece = piece.narrow(ax, start, ln)
        blk = torch.empty(piece.shape, dtype=arr.dtype, device=dev)
        blocks.append(blk.copy_(piece))
    return ShardedField(blocks, mesh, spec)


def gather(field: ShardedField, device=None) -> torch.Tensor:
    """The global tensor of a ShardedField, on ``device`` (default: the
    first sub-domain's).  Replicated mesh axes give one copy: the blocks
    at coordinate 0 along them."""
    mesh, spec = field.mesh, field.spec
    dev = field.device if device is None else torch.device(device)
    out = torch.empty(field.shape, dtype=field.dtype, device=dev)
    named = {nm for names in spec for nm in names}
    for i, blk in enumerate(field.blocks):
        c = mesh.coords(i)
        if any(c[MESH_AXES.index(a)] for a in MESH_AXES if a not in named):
            continue
        piece = out
        for ax, start, ln in _block_slices(mesh, spec, out.shape, i):
            piece = piece.narrow(ax, start, ln)
        piece.copy_(blk)
    return out


def spinor_pspec(batched: bool = False) -> tuple:
    """Spec of (``[src,]`` T, Z, Y, X, spin, color) fields."""
    return (SRC_AXIS,) + AXES if batched else AXES


def gauge_pspec() -> tuple:
    """Spec of (mu, T, Z, Y, X, c, c): replicated over src."""
    return (None,) + AXES


def pair_pspec(ndim: int) -> tuple:
    """Spec of the packed pair layouts (..., T, Z, Y*X): t and z on their
    axes, y and x on the fused trailing axis (block-contiguous after
    ``fuse_block_layout``)."""
    return (None,) * (ndim - 3) + ("t", "z", ("y", "x"))


def shard_spinor(arr, mesh: LatticeMesh, batched: bool = False):
    return shard(arr, mesh, spinor_pspec(batched))


def shard_gauge(arr, mesh: LatticeMesh):
    return shard(arr, mesh, gauge_pspec())


def _moveaxis(a, src, dst):
    if isinstance(a, np.ndarray):
        return np.moveaxis(a, src, dst)
    return torch.movedim(a, src, dst)


def fuse_block_layout(arr, n_y: int, n_x: int, Y: int, xcols: int):
    """Re-order a packed array's trailing fused Y·X axis so that splitting
    it into n_y*n_x equal chunks yields BLOCK-contiguous (Y_loc, X_loc)
    rectangles: chunk (i, j) holds rows [i*Y_loc, (i+1)*Y_loc) x columns
    [j*X_loc, (j+1)*X_loc) stored row-major in the LOCAL width.  Identity
    when n_x == 1.  ``xcols`` is the GLOBAL row width of the fused axis: X
    full-lattice, Xh = X//2 checkerboarded.  numpy or torch arrays."""
    if n_x == 1:
        return arr
    y_l, x_l = Y // n_y, xcols // n_x
    lead = tuple(arr.shape[:-1])
    a = _moveaxis(arr.reshape(lead + (n_y, y_l, n_x, x_l)), -2, -3)
    return a.reshape(lead + (Y * xcols,))


def unfuse_block_layout(arr, n_y: int, n_x: int, Y: int, xcols: int):
    """Inverse of :func:`fuse_block_layout`."""
    if n_x == 1:
        return arr
    y_l, x_l = Y // n_y, xcols // n_x
    lead = tuple(arr.shape[:-1])
    a = _moveaxis(arr.reshape(lead + (n_y, n_x, y_l, x_l)), -2, -3)
    return a.reshape(lead + (Y * xcols,))


def local_extents(mesh: LatticeMesh, lattice_shape):
    """Per-sub-domain local (T, Z, Y, X) extents; validates divisibility
    the way QUDA validates comm grid dims against the lattice."""
    out = []
    for name, ext in zip(AXES, lattice_shape):
        n = mesh.shape[name]
        if ext % n:
            raise ValueError(f"lattice extent {ext} on axis {name} not "
                             f"divisible by mesh size {n}")
        out.append(ext // n)
    return tuple(out)
