"""Wilson dslash on the packed device layout — the plain PyTorch stencil.

Port of the pair-form half of quda_tpu/ops/wilson_packed.py.  Packed
order keeps every spin/colour component its own lattice plane:

    spinor  (4, 3, T, Z, Y*X)      complex
    gauge   (4, 3, 3, T, Z, Y*X)   complex   [direction, row, col, ...]

and the pair form splits re/im into an axis of its own, before T:

    spinor  (4, 3, 2, T, Z, Y*Xh)     float
    gauge   (4, 3, 3, 2, T, Z, Y*Xh)  float

Shifts: t and z roll their own axes; y rolls the fused Y*X axis by X
(exact, wrap included); x rolls by one with a column mask for the wrap.
On the half lattice the x shift is the slot-parity select of
ops/shift.shift_eo.

``dslash_eo_packed_pairs_bw`` is the plain version of the CUDA kernel B1
(ops/wilson_pallas_packed.dslash_eo_pallas_packed): the same hop sum on
the same inputs, pre-shifted backward links included;
``dslash_packed_pairs_bw`` that of the full-lattice kernel B4
(``dslash_pallas_packed``), and ``dslash_packed_pairs`` (JAX :335) the
full-lattice pair stencil B4 is held against.  The pair stencils sum in
float32 as the JAX package's do, and in float64 for float64 input (the
double forms, which the JAX package has no twin of).
"""

from __future__ import annotations

import torch

from .wilson_pallas import TABLES


# -- pack / unpack (host order <-> packed order) ---------------------------

def pack_spinor(psi: torch.Tensor) -> torch.Tensor:
    """(..., T,Z,Y,X,4,3) -> (..., 4,3,T,Z,Y*X); leading (RHS) axes stay
    in front."""
    lead = tuple(psi.shape[:-6])
    T, Z, Y, X = psi.shape[-6:-2]
    k = len(lead)
    perm = tuple(range(k)) + (k + 4, k + 5, k, k + 1, k + 2, k + 3)
    return psi.permute(perm).reshape(lead + (4, 3, T, Z, Y * X))


def unpack_spinor(pp: torch.Tensor, lattice_shape) -> torch.Tensor:
    """(..., 4,3,T,Z,Y*X) -> (..., T,Z,Y,X,4,3)."""
    T, Z, Y, X = lattice_shape
    lead = tuple(pp.shape[:-5])
    k = len(lead)
    perm = tuple(range(k)) + (k + 2, k + 3, k + 4, k + 5, k, k + 1)
    return pp.reshape(lead + (4, 3, T, Z, Y, X)).permute(perm)


def pack_gauge(gauge: torch.Tensor) -> torch.Tensor:
    """(4,T,Z,Y,X,3,3) -> (4,3,3,T,Z,Y*X)."""
    _, T, Z, Y, X = gauge.shape[:5]
    return gauge.permute(0, 5, 6, 1, 2, 3, 4).reshape(4, 3, 3, T, Z, Y * X)


def unpack_gauge(gp: torch.Tensor, lattice_shape) -> torch.Tensor:
    T, Z, Y, X = lattice_shape
    return gp.reshape(4, 3, 3, T, Z, Y, X).permute(0, 3, 4, 5, 6, 1, 2)


def pack_gauge_eo(gauge_eo) -> tuple:
    """((4,T,Z,Y,Xh,3,3) even, odd) -> packed ((4,3,3,T,Z,Y*Xh) x2)."""
    return tuple(pack_gauge(g) for g in gauge_eo)


def to_packed_pairs(arr: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """complex packed (..., T, Z, YX) -> pairs with re/im before T."""
    return torch.stack([arr.real, arr.imag], dim=-4).to(dtype)


def from_packed_pairs(p: torch.Tensor, dtype=torch.complex64) -> torch.Tensor:
    f = p.to(torch.float64 if p.dtype == torch.float64 else torch.float32)
    return torch.complex(f[..., 0, :, :, :], f[..., 1, :, :, :]).to(dtype)


# -- packed shifts ----------------------------------------------------------

def _x_wrap_masks(Y: int, X: int, nhop: int, device):
    """Masks over the fused Y*X axis marking the x columns whose +nhop
    (resp. -nhop) neighbour wraps around the x extent."""
    x = torch.arange(Y * X, device=device) % X
    return x >= X - nhop, x < nhop


def shift_packed(arr: torch.Tensor, mu: int, sign: int, X: int,
                 Y: int, nhop: int = 1) -> torch.Tensor:
    """result[site] = arr[site + sign*nhop*mu_hat] on the packed layout;
    lattice axes are the LAST three (T, Z, Y*X)."""
    if mu == 3:
        return torch.roll(arr, -sign * nhop, dims=-3)
    if mu == 2:
        return torch.roll(arr, -sign * nhop, dims=-2)
    if mu == 1:
        return torch.roll(arr, -sign * nhop * X, dims=-1)
    nhop = nhop % X
    if nhop == 0:
        return arr
    last, first = _x_wrap_masks(Y, X, nhop, arr.device)
    if sign > 0:
        interior = torch.roll(arr, -nhop, dims=-1)
        wrapped = torch.roll(arr, X - nhop, dims=-1)
        return torch.where(last, wrapped, interior)
    interior = torch.roll(arr, nhop, dims=-1)
    wrapped = torch.roll(arr, -(X - nhop), dims=-1)
    return torch.where(first, wrapped, interior)


def _slot_mask_packed(T: int, Z: int, Y: int, Xh: int, parity: int,
                      device="cpu") -> torch.Tensor:
    """(T, Z, Y*Xh) bool: True where the parity-p half-site occupies the
    even x slot (r == 0)."""
    t = torch.arange(T, device=device)[:, None, None]
    z = torch.arange(Z, device=device)[None, :, None]
    y = (torch.arange(Y * Xh, device=device) // Xh)[None, None, :]
    return (t + z + y + parity) % 2 == 0


def shift_eo_packed(arr: torch.Tensor, dims, mu: int, sign: int,
                    target_parity: int, nhop: int = 1) -> torch.Tensor:
    """Checkerboarded shift by nhop sites on the packed half lattice.

    arr: (..., T, Z, Y*Xh) of parity 1-p (odd nhop); the result, indexed
    by parity-p half-sites, is arr at x + sign*nhop*mu_hat.  ``dims`` is
    the full (T, Z, Y, X)."""
    T, Z, Y, X = dims
    Xh = X // 2
    if mu == 3:
        return torch.roll(arr, -sign * nhop, dims=-3)
    if mu == 2:
        return torch.roll(arr, -sign * nhop, dims=-2)
    if mu == 1:
        return torch.roll(arr, -sign * nhop * Xh, dims=-1)
    if nhop % 2 == 0:
        return (shift_packed(arr, 0, sign, Xh, Y, nhop // 2)
                if nhop else arr)
    k = (nhop - 1) // 2
    base = shift_packed(arr, 0, sign, Xh, Y, k) if k else arr
    moved = shift_packed(base, 0, sign, Xh, Y, 1)
    mask_r0 = _slot_mask_packed(T, Z, Y, Xh, target_parity, arr.device)
    if sign > 0:
        return torch.where(mask_r0, base, moved)
    return torch.where(mask_r0, moved, base)


# -- the pair-form stencil --------------------------------------------------

def compute_dtype(dtype) -> torch.dtype:
    """The pair stencils' arithmetic: float64 for float64 storage, float32
    for everything narrower."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _pp_cscale(c: complex, x: torch.Tensor) -> torch.Tensor:
    """c * x for x of shape (..., 2, *site) with re/im on axis 1 of the
    colour-major (3, 2, *site) block."""
    cr, ci = float(c.real), float(c.imag)
    xr, xi = x[:, 0], x[:, 1]
    if ci == 0.0:
        return torch.stack([cr * xr, cr * xi], dim=1)
    if cr == 0.0:
        return torch.stack([-ci * xi, ci * xr], dim=1)
    return torch.stack([cr * xr - ci * xi, cr * xi + ci * xr], dim=1)


def half_pairs(psi_s: torch.Tensor, table: dict) -> torch.Tensor:
    """The projected half spinor h_a = psi_a + c_a psi_{j_a}: (4,3,2,*site)
    -> (2,3,2,*site)."""
    t = table
    return torch.stack([psi_s[a] + _pp_cscale(t[f"c{a}"], psi_s[t[f"j{a}"]])
                        for a in (0, 1)])


def color_mul_pairs(u: torch.Tensor, h: torch.Tensor,
                    adjoint: bool) -> torch.Tensor:
    """U h (or U^dag h) in colour: u (3,3,2,*site), h (2,3,2,*site)."""
    hr, hi = h[:, None, :, 0], h[:, None, :, 1]            # (2,1,3(b),*site)
    if adjoint:
        # (U^dag)[a][b] = conj(U[b][a])
        ur = u[:, :, 0].transpose(0, 1)
        ui = -u[:, :, 1].transpose(0, 1)
    else:
        ur, ui = u[:, :, 0], u[:, :, 1]                    # (3(a),3(b),*site)
    re = (ur * hr - ui * hi).sum(dim=2)                    # (2,3(a),*site)
    im = (ur * hi + ui * hr).sum(dim=2)
    return torch.stack([re, im], dim=2)                    # (2,3,2,*site)


def recon_pairs(uh: torch.Tensor, table: dict) -> torch.Tensor:
    """The four spin rows from the half spinor: (2,3,2,*site) ->
    (4,3,2,*site)."""
    t = table
    return torch.stack([uh[0], uh[1], _pp_cscale(t["d2"], uh[t["k2"]]),
                        _pp_cscale(t["d3"], uh[t["k3"]])])


def _hop_packed_pairs(psi_s: torch.Tensor, u: torch.Tensor, table: dict,
                      adjoint: bool) -> torch.Tensor:
    """One direction on f32 pair planes: project to the half spinor,
    multiply by U (or U^dag) in colour, reconstruct.

    psi_s: (4,3,2,*site) neighbour spinor; u: (3,3,2,*site) links.
    Returns the (4,3,2,*site) contribution."""
    return recon_pairs(color_mul_pairs(u, half_pairs(psi_s, table), adjoint),
                       table)


def dslash_eo_packed_pairs_bw(u_here: torch.Tensor, u_bw, psi_pp: torch.Tensor,
                              dims, target_parity: int,
                              out_dtype=None) -> torch.Tensor:
    """Checkerboarded Wilson hop given PRE-SHIFTED backward links.

    u_here: (4,3,3,2,T,Z,Y*Xh) forward links at parity-p sites;
    u_bw[mu]: U_mu(x - mu) at parity-p sites x, read from the opposite
    parity (ops/wilson_pallas_packed.backward_gauge_eo); psi_pp:
    (4,3,2,T,Z,Y*Xh) of parity 1-p.  Computes at f32 (f64 for f64 psi);
    output cast to ``out_dtype`` (default: psi's dtype)."""
    def shifted(arr, mu, sign):
        return shift_eo_packed(arr, dims, mu, sign, target_parity)
    return _hop_sum_bw(u_here, u_bw, psi_pp, shifted, out_dtype)


def _hop_sum_bw(u_here, u_bw, psi_pp, shifted, out_dtype):
    """sum_mu fwd + bwd with the neighbour spinor from ``shifted(psi, mu,
    sign)`` and pre-shifted backward links, in ``compute_dtype``."""
    out_dtype = out_dtype or psi_pp.dtype
    cdt = compute_dtype(psi_pp.dtype)
    psi = psi_pp.to(cdt)
    acc = None
    for mu in range(4):
        fwd = _hop_packed_pairs(shifted(psi, mu, +1), u_here[mu].to(cdt),
                                TABLES[(mu, +1)], adjoint=False)
        bwd = _hop_packed_pairs(shifted(psi, mu, -1), u_bw[mu].to(cdt),
                                TABLES[(mu, -1)], adjoint=True)
        term = fwd + bwd
        acc = term if acc is None else acc + term
    return acc.to(out_dtype)


def dslash_packed_pairs_bw(gauge_pp, gauge_bw, psi_pp: torch.Tensor, X: int,
                           Y: int, out_dtype=None) -> torch.Tensor:
    """Full-lattice Wilson hop given PRE-SHIFTED backward links
    (gauge_bw[mu](x) = U_mu(x - mu), ops/wilson_pallas_packed.
    backward_gauge): the plain version of the kernel B4.  gauge_pp
    (4,3,3,2,T,Z,Y*X), psi_pp (4,3,2,T,Z,Y*X)."""
    def shifted(arr, mu, sign):
        return shift_packed(arr, mu, sign, X, Y)
    return _hop_sum_bw(gauge_pp, gauge_bw, psi_pp, shifted, out_dtype)


def dslash_packed_pairs(gauge_pp, psi_pp: torch.Tensor, X: int, Y: int,
                        out_dtype=None) -> torch.Tensor:
    """Full-lattice Wilson hop on pair-form packed arrays, no complex
    dtype anywhere (JAX ``dslash_packed_pairs``).

    gauge_pp: (4,3,3,2,T,Z,Y*X) storage, phases folded; psi_pp:
    (4,3,2,T,Z,Y*X).  The backward links U_mu(x - mu) are shifted here.
    Computes at f32 (f64 for f64 psi); output cast to ``out_dtype``
    (default: psi's dtype)."""
    u_bw = [shift_packed(gauge_pp[mu], mu, -1, X, Y) for mu in range(4)]
    return dslash_packed_pairs_bw(gauge_pp, u_bw, psi_pp, X, Y, out_dtype)


def dslash_eo_packed_pairs(gauge_eo_pp, psi_pp: torch.Tensor, dims,
                           target_parity: int,
                           out_dtype=None) -> torch.Tensor:
    """Checkerboarded Wilson hop on pair-form packed half-lattice arrays.

    gauge_eo_pp: (even, odd) of (4,3,3,2,T,Z,Y*Xh); psi_pp:
    (4,3,2,T,Z,Y*Xh) of parity 1-p.  The backward links U_mu(x - mu) are
    the opposite parity's, shifted here."""
    u_there = gauge_eo_pp[1 - target_parity]
    u_bw = [shift_eo_packed(u_there[mu], dims, mu, -1, target_parity)
            for mu in range(4)]
    return dslash_eo_packed_pairs_bw(gauge_eo_pp[target_parity], u_bw,
                                     psi_pp, dims, target_parity, out_dtype)
