"""Extended-precision (df64) Wilson even/odd stencil on the packed layout,
as in quda_tpu/ops/wilson_df64.py.

Why: near convergence |r| ~ tol |b|, so the residual recompute
r = b - M x of a reliable update cancels catastrophically, and an f32
apply's own rounding (~1e-7 |b|) floors the certifiable residual.  Here
every U * psi product goes through Dekker two_prod and every add through
the df64 two_sum chain (ops/df64.py), with the links held as plain f32:
the operator solved IS the f32-link operator, whose f64 embedding is
exact (what a complex128 oracle checks).

A df64 spinor is a (hi, lo) tuple of packed pair tensors
(4, 3, 2, T, Z, Y*Xh) f32, the layout of the pair stencils, so the sloppy
loop and the df64 operator share shifts and converters.  Shifts are
permutations, applied to both words.  The JAX module works plane by plane;
this one works on whole (spin, colour) blocks at a time with the same
elementwise operations in the same order.

The JAX package computes this outside any Pallas kernel, and it stays
plain PyTorch on the card: eager, op by op.  No ``torch.compile`` and no
fused ops (``addcmul``, ``lerp``): a contraction into a fused
multiply-add would make two_sum/two_prod inexact.  It runs once per
reliable update, not in the hot loop.
"""

from __future__ import annotations

import torch

from . import df64 as dfm
from .wilson_packed import shift_eo_packed
from .wilson_pallas import TABLES

F32 = torch.float32

# A complex df64 block is (re, im), each a df64 (hi, lo) pair of tensors.


def _dfc_add(a, b):
    return dfm.add(a[0], b[0]), dfm.add(a[1], b[1])


def _df_scale_unit(v, f: float):
    """Scale a df64 by +-1 (every Wilson table constant): exact."""
    if f == 1.0:
        return v
    if f == -1.0:
        return dfm.neg(v)
    raise ValueError(f"table factor {f} is not +-1")


def _dfc_cscale(c: complex, x):
    """Complex df64 x times c in {+-1, +-i}: a component swap and sign."""
    cr, ci = float(c.real), float(c.imag)
    if ci == 0.0:
        return _df_scale_unit(x[0], cr), _df_scale_unit(x[1], cr)
    if cr == 0.0:
        return _df_scale_unit(x[1], -ci), _df_scale_unit(x[0], ci)
    raise ValueError(f"table factor {c} is not +-1 or +-i")


def _dfc_cmul_f32(ur, ui, h, conj: bool):
    """(complex f32 u, or its conjugate) * (complex df64 h)."""
    hr, hi = h
    if conj:
        re = dfm.add(dfm.mul_f32(hr, ur), dfm.mul_f32(hi, ui))
        im = dfm.sub(dfm.mul_f32(hi, ur), dfm.mul_f32(hr, ui))
    else:
        re = dfm.sub(dfm.mul_f32(hr, ur), dfm.mul_f32(hi, ui))
        im = dfm.add(dfm.mul_f32(hi, ur), dfm.mul_f32(hr, ui))
    return re, im


def _index(x, idx):
    """Index every tensor of a complex df64 block."""
    return tuple(tuple(w[idx] for w in part) for part in x)


def _stack(xs, dim=0):
    return tuple(tuple(torch.stack([x[p][w] for x in xs], dim=dim)
                       for w in range(2)) for p in range(2))


def _hop_df(psi_c, u, table, adjoint: bool):
    """df64 analog of the pair hop: project, 3x3 colour multiply
    (two_prod products), reconstruct.  psi_c: complex df64 (4, 3, *site)
    at the neighbours; u: (3, 3, 2, *site) f32 links.  Returns the
    (4, 3, *site) complex df64 contribution."""
    t = table
    h = _stack([_dfc_add(_index(psi_c, a),
                         _dfc_cscale(t[f"c{a}"], _index(psi_c, t[f"j{a}"])))
                for a in (0, 1)])                      # (2[s], 3[b], *site)
    u = u.to(F32)
    ur, ui = u[:, :, 0], u[:, :, 1]                    # (3[a], 3[b], *site)
    if adjoint:                                        # U^dag[a][b] = conj(U[b][a])
        ur, ui = ur.transpose(0, 1), ui.transpose(0, 1)
    hb = _index(h, (slice(None), None))                # (2, 1, 3, *site)
    m = _dfc_cmul_f32(ur, ui, hb, conj=adjoint)        # (2, 3[a], 3[b], *site)
    uh = _index(m, (slice(None), slice(None), 0))
    for b in (1, 2):
        uh = _dfc_add(uh, _index(m, (slice(None), slice(None), b)))
    return _stack([_index(uh, 0), _index(uh, 1),
                   _dfc_cscale(t["d2"], _index(uh, t["k2"])),
                   _dfc_cscale(t["d3"], _index(uh, t["k3"]))])


def _complex_view(x_df):
    """df64 (4,3,2,*site) -> complex df64 (4,3,*site)."""
    h, l = x_df
    return (h[:, :, 0], l[:, :, 0]), (h[:, :, 1], l[:, :, 1])


def dslash_eo_df(gauge_eo_pp, psi_df, dims, target_parity: int):
    """Checkerboarded Wilson hop in df64.

    gauge_eo_pp: (even, odd) of (4,3,3,2,T,Z,Y*Xh) f32 pair links with the
    boundary phase folded in; psi_df: (hi, lo) packed pair spinor of
    parity 1-p; returns (hi, lo) indexed by parity-p sites."""
    u_here = gauge_eo_pp[target_parity]
    u_there = gauge_eo_pp[1 - target_parity]
    acc = None
    for mu in range(4):
        sh = [tuple(shift_eo_packed(w, dims, mu, s, target_parity)
                    for w in psi_df) for s in (+1, -1)]
        fwd = _hop_df(_complex_view(sh[0]), u_here[mu], TABLES[(mu, +1)],
                      adjoint=False)
        ub = shift_eo_packed(u_there[mu], dims, mu, -1, target_parity)
        bwd = _hop_df(_complex_view(sh[1]), ub, TABLES[(mu, -1)],
                      adjoint=True)
        term = _dfc_add(fwd, bwd)
        acc = term if acc is None else _dfc_add(acc, term)
    (rh, rl), (ih, il) = acc
    return torch.stack([rh, ih], dim=2), torch.stack([rl, il], dim=2)


class WilsonPCDF64:
    """df64 precise companion of DiracWilsonPCPacked (the fp64
    matPrecise of lib/inv_cg_quda.cpp with dbldbl reductions).

    Fields are (hi, lo) packed pair tensors; the links are the packed f32
    pair links of the sloppy operators.  M = 1 - kappa^2 D D on parity
    ``matpc``; Mdag by the exact gamma5 trick; prepare, reconstruct and
    the full-lattice residual all carried in df64."""

    def __init__(self, dpk):
        from . import wilson_packed as wpk
        self.dims = tuple(dpk.geom.lattice_shape)
        self.matpc = dpk.matpc
        self.gauge_eo_pp = tuple(wpk.to_packed_pairs(g, F32).contiguous()
                                 for g in dpk.gauge_eo_p)
        dev = self.gauge_eo_pp[0].device
        self.kappa = dfm.const(float(dpk.kappa), dev)
        self.kappa2 = dfm.const(float(dpk.kappa) ** 2, dev)
        self._sign = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=F32,
                                  device=dev).reshape(4, 1, 1, 1, 1, 1)

    # -- conversions --------------------------------------------------------
    def to_df(self, x):
        """Canonical complex half-lattice field -> df64 packed pairs
        (exact: complex64 components are f32)."""
        from . import wilson_packed as wpk
        return dfm.promote(wpk.to_packed_pairs(wpk.pack_spinor(x), F32))

    def from_df(self, x_df, dtype=torch.complex64):
        """df64 packed pairs -> (canonical complex hi, canonical complex
        lo): hi + lo is the full-precision field."""
        from . import wilson_packed as wpk
        T, Z, Y, X = self.dims
        return tuple(wpk.unpack_spinor(wpk.from_packed_pairs(w, dtype),
                                       (T, Z, Y, X // 2)) for w in x_df)

    # -- operator applications ----------------------------------------------
    def D_to(self, x_df, target_parity):
        return dslash_eo_df(self.gauge_eo_pp, x_df, self.dims,
                            target_parity)

    def M(self, x_df):
        p = self.matpc
        dd = self.D_to(self.D_to(x_df, 1 - p), p)
        return dfm.sub(x_df, dfm.mul(dd, self.kappa2))

    def _g5(self, x_df):
        return x_df[0] * self._sign, x_df[1] * self._sign

    def Mdag(self, x_df):
        return self._g5(self.M(self._g5(x_df)))

    def MdagM(self, x_df):
        return self.Mdag(self.M(x_df))

    # -- solve-boundary compositions ----------------------------------------
    def prepare_df(self, b_even, b_odd):
        """b_p + kappa D b_q carried in df64."""
        from ..fields.geometry import EVEN
        b_p, b_q = ((b_even, b_odd) if self.matpc == EVEN
                    else (b_odd, b_even))
        t = self.D_to(self.to_df(b_q), self.matpc)
        return dfm.add(self.to_df(b_p), dfm.mul(t, self.kappa))

    def reconstruct_df(self, x_df, b_even, b_odd):
        """x_q = b_q + kappa D x_p in df64; returns (x_even, x_odd)."""
        from ..fields.geometry import EVEN
        p = self.matpc
        b_q = b_odd if p == EVEN else b_even
        t = self.D_to(x_df, 1 - p)
        x_q = dfm.add(self.to_df(b_q), dfm.mul(t, self.kappa))
        return (x_df, x_q) if p == EVEN else (x_q, x_df)

    def residual_df(self, rhs_df, x_df):
        """rhs - M x in df64 (the PC direct residual)."""
        return dfm.sub(rhs_df, self.M(x_df))

    def full_residual_norm2(self, x_e_df, x_o_df, b_even, b_odd):
        """|b - M_full x|^2 in df64 over both parities -> df64 scalar, with
        (M_full x)_p = x_p - kappa D_{p,q} x_q."""
        out = None
        for par, x_p, x_q, b_p in ((0, x_e_df, x_o_df, b_even),
                                   (1, x_o_df, x_e_df, b_odd)):
            t = self.D_to(x_q, par)
            r = dfm.add(dfm.sub(self.to_df(b_p), x_p),
                        dfm.mul(t, self.kappa))
            n = dfm.norm2(r)
            out = n if out is None else dfm.add(out, n)
        return out
