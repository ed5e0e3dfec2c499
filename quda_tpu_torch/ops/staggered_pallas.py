"""The even/odd staggered hop kernels (S1, S2) and their plain versions.

Replace two Pallas TPU kernels of quda_tpu/ops/staggered_pallas.py with
the hand-written CUDA kernels of ``csrc/staggered_eo.cu``:

* S1 ``dslash_staggered_eo_pallas_fused`` (``_stag_fused_call``, eo
  form): the fat 1-hop and the Naik 3-hop sets in one launch, backward
  hops read from the unshifted opposite-parity links.  The improved
  (asqtad/HISQ) operator's hop.  Forms ``full:f32->f32``,
  ``full:bf16->bf16`` and ``full:bf16->f32`` (storage -> out; "full":
  18 reals per link).
* S2 ``dslash_staggered_eo_pass`` (``_stag_pass``, eo form): one hop set,
  nhop 1 (``fat``) or 3 (``naik``), with the pre-shifted backward links
  of ``backward_links_eo``.  ``dslash_staggered_eo_pallas`` composes it
  as the JAX function does: the fat pass alone (fat-only staggered), or
  the fat and Naik passes in float32 summed (the two-pass improved form).
  Forms ``fat:`` and ``naik:`` x ``f32->f32``, ``bf16->bf16``,
  ``bf16->f32``.
* S2-mrhs ``dslash_staggered_eo_pass_mrhs`` (``_stag_pass_mrhs``, eo
  form, ``csrc/staggered_eo_mrhs.cu``): S2 over a leading axis of N
  right-hand sides, psi and out (N, 3, 2, T, Z, Y*Xh), each link loaded
  once for a chunk of ``MRHS_CHUNK`` = 4 of them; with ``acc`` the pass adds
  into that float32 batch in place.  ``dslash_staggered_eo_pallas_mrhs``
  composes it as the JAX function does: the fat pass, then with long
  links the Naik pass added into it, so out = fat + naik bit for bit.
  Forms ``fat:f32->f32`` and ``naik:f32->f32``: float32 and full links
  only, as the JAX batched staggered route builds them.

Two more eo forms, both in ``csrc/staggered_eo.cu``:

* S1-fold ``dslash_staggered_eo_pallas_fused_fold``
  (``_stag_fused_fold_call``, eo form): S1 on the folded layout of
  ``wilson_pallas_packed.to_fold`` (psi (3,T,2Z,Y*Xh), links
  (4,3,3,T,2Z,Y*Xh)), full links and the Naik links required; S1's three
  forms, each output S1's on the unfolded operands bit for bit.
* The v3 pass ``dslash_staggered_eo_pass_v3`` (``_stag_pass_v3``, eo
  form): S2 with the backward links read unshifted from the opposite
  parity, so no ``backward_links_eo`` copy exists; S2's six forms.
  ``dslash_staggered_eo_pallas_v3`` composes it as the JAX function does:
  the fat pass alone, or the fat pass in float32 and the Naik pass adding
  it (``acc``) before its one rounding, which is S1's sum bit for bit.

Layouts are the JAX package's pallas layout:

    psi, out        (3, 2, T, Z, Y*Xh)
    links           (4, 3, 3, 2, T, Z, Y*Xh)   KS phases and the t
                                               boundary folded in

The full-lattice forms (``csrc/staggered_full.cu``, float32 and full
links only, as the multigrid and the operator API build them) run the same
hop body on the full lattice, layouts (3, 2, T, Z, Y*X) and (4, 3, 3, 2,
T, Z, Y*X):

* S2-full ``dslash_staggered_pass`` (``_stag_pass``, pallas_call at :204,
  through ``dslash_staggered_pallas`` at :219): one hop set with the
  pre-shifted backward links of ``backward_links``;
  ``dslash_staggered_pallas`` composes fat (+ Naik, summed in float32) as
  the JAX function does.  Forms ``fat:f32->f32`` and ``naik:f32->f32``.
* S2-mrhs-full ``dslash_staggered_pass_mrhs`` (``_stag_pass_mrhs``, :1106,
  through ``dslash_staggered_pallas_mrhs`` at :1121): S2-full over a
  leading axis of N right-hand sides; a block copies its tile's links
  into shared memory once and loops over all N (``full_mrhs_plan``), so
  each link leaves device memory once, and each lane is S2-full's bit for
  bit; ``acc`` adds the pass into a batch in place.
* S1-full ``dslash_staggered_pallas_fused`` (``_stag_fused_call``, :966,
  through :980): the fat and Naik hop sets in one launch, backward hops
  read from the unshifted links at the neighbour.  Form
  ``full:f32->f32``.

The wrappers dispatch on the tensors' device: CPU tensors run the plain
versions (``dslash_staggered_eo_fused_plain``,
``dslash_staggered_eo_pass_plain``, ``dslash_staggered_eo_pass_mrhs_plain``,
``dslash_staggered_eo_fused_fold_plain``,
``dslash_staggered_eo_pass_v3_plain``,
``dslash_staggered_fused_plain``, ``dslash_staggered_pass_plain``,
``dslash_staggered_pass_mrhs_plain``), CUDA tensors launch the kernel or
raise.  Each wrapper counts its launches in ``.launches`` and per form in
``.launches_by_form``.  Recon-12 long links are refused: HISQ long links
are not +-SU(3) (ROADMAP C).
"""

from __future__ import annotations

import torch

from ..utils import kernels
from . import staggered_packed as spk
from . import wilson_pallas_packed as wpp
from .wilson_packed import shift_eo_packed, shift_packed

# Kernel vs plain version, max |kernel - plain| / max |plain|: float32
# output within TOLERANCE (f32 sums in another order, fused multiply-adds
# on the card), bfloat16 output within one bf16 ulp of max |plain|.
TOLERANCE = 1e-5
TOLERANCE_BF16 = 2.0 ** -7
# flops per target half-site (QUDA's Dslash::flops: 570 a hop set)
FUSED_FLOPS_PER_SITE = 1146
PASS_FLOPS_PER_SITE = 570
# floor of S2-full's and S1-full's traffic per site in float32: two link
# sets read once (S2-full: the links and their pre-shifted copy; S1-full:
# the fat and the long links), psi read once, out written once
FULL_BYTES_PER_SITE = 2 * 72 * 4 + 6 * 4 + 6 * 4
_STORE_BYTES = {torch.float32: 4, torch.bfloat16: 2}
_SHORT = {torch.float32: "f32", torch.bfloat16: "bf16"}
HOPSET = {1: "fat", 3: "naik"}
# Right-hand sides per thread of S2-mrhs (kNB of csrc/staggered_eo_mrhs.cu,
# the fastest of 1, 2, 4 and 8 on the card at N = 12: PERF.md)
MRHS_CHUNK = 4
# S2-mrhs-full's plan, as csrc/staggered_full.cu's full_mrhs_plan makes it
# (kMrhs* there): a block owns FULL_MRHS_TILE sites of one (t, z) plane,
# FULL_MRHS_LANES threads a site, each FULL_MRHS_CHUNK right-hand sides at
# a time, the tile's two link sets in shared memory (2 x 72 floats a
# site), FULL_MRHS_MIN_BLOCKS blocks an SM (the kernel's launch bound);
# chosen by timing variants on the card (PERF.md).
FULL_MRHS_TILE = 64
FULL_MRHS_LANES = 4
FULL_MRHS_CHUNK = 1
FULL_MRHS_MIN_BLOCKS = 2


def fused_bytes_per_site(store_dtype=torch.float32, out_dtype=None) -> int:
    """Floor of S1's device-memory traffic per target half-site: four
    link sets (fat and long, here and there, 72 reals each), psi read
    once, out written once: 1200 B in f32."""
    sb = _STORE_BYTES[store_dtype]
    return 4 * 72 * sb + 6 * sb + 6 * _STORE_BYTES[out_dtype or store_dtype]


def pass_bytes_per_site(store_dtype=torch.float32, out_dtype=None,
                        accumulate: bool = False) -> int:
    """The same for S2 and the v3 pass: two link sets (the forward and
    the backward ones), psi and out: 624 B in f32; the accumulating v3
    Naik pass also reads the float32 fat pass (24 B)."""
    sb = _STORE_BYTES[store_dtype]
    return (2 * 72 * sb + 6 * sb + 6 * _STORE_BYTES[out_dtype or store_dtype]
            + (24 if accumulate else 0))


def pass_mrhs_bytes_per_site(n: int, accumulate: bool = False) -> int:
    """Floor of S2-mrhs's traffic per target half-site for ``n``
    right-hand sides in float32: psi read and out written once (48 n),
    the two link sets once (576); an accumulating pass reads out too."""
    return (72 if accumulate else 48) * n + 2 * 72 * 4


def form_name(store_dtype, out_dtype) -> str:
    """S1's ``launches_by_form`` key, ``"full:f32->f32"``-style."""
    return f"full:{_SHORT[store_dtype]}->{_SHORT[out_dtype]}"


def pass_form_name(nhop: int, store_dtype, out_dtype) -> str:
    """S2's key, ``"fat:f32->f32"`` or ``"naik:f32->f32"``-style."""
    return f"{HOPSET[nhop]}:{_SHORT[store_dtype]}->{_SHORT[out_dtype]}"


def backward_links_eo(u_there_pl: torch.Tensor, dims, target_parity: int,
                      nhop: int) -> torch.Tensor:
    """Pre-shifted backward links on the half lattice:
    out[mu](x) = U_mu(x - nhop*mu) for parity-``target_parity`` sites,
    from the opposite-parity links ``u_there_pl`` (4,3,3,2,T,Z,Y*Xh).
    Computed once per link load."""
    return torch.stack([
        shift_eo_packed(u_there_pl[mu], dims, mu, -1, target_parity, nhop)
        for mu in range(4)])


def _eo_shift(dims, target_parity):
    def sh(arr, mu, sign, nhop):
        return shift_eo_packed(arr, dims, mu, sign, target_parity, nhop)
    return sh


def dslash_staggered_eo_fused_plain(fat_here_pl, fat_there_pl, psi_pl,
                                    dims, target_parity: int, long_here_pl,
                                    long_there_pl, out_dtype=None):
    """Plain PyTorch version of S1 on its inputs: the fat and Naik hop
    sets in float32, each with the opposite-parity links shifted back,
    summed, cast to ``out_dtype`` (default: psi's dtype)."""
    sh = _eo_shift(dims, target_parity)
    acc = None
    for here, there, nhop in ((fat_here_pl, fat_there_pl, 1),
                              (long_here_pl, long_there_pl, 3)):
        u_bw = backward_links_eo(there, dims, target_parity, nhop)
        term = spk.hopset_pairs(here, u_bw, psi_pl, sh, nhop)
        acc = term if acc is None else acc + term
    return acc.to(out_dtype or psi_pl.dtype)


def dslash_staggered_eo_pass_plain(u_here_pl, u_bw_pl, psi_pl, dims,
                                   target_parity: int, nhop: int,
                                   out_dtype=None):
    """Plain PyTorch version of S2 on its inputs (pre-shifted backward
    links), float32 sums, cast to ``out_dtype``."""
    out = spk.hopset_pairs(u_here_pl, u_bw_pl, psi_pl,
                           _eo_shift(dims, target_parity), nhop)
    return out.to(out_dtype or psi_pl.dtype)


def dslash_staggered_eo_pass_mrhs_plain(u_here_pl, u_bw_pl, psi_b, dims,
                                        target_parity: int, nhop: int,
                                        out_dtype=None):
    """Plain version of S2-mrhs: S2's plain version, lane by lane over the
    leading RHS axis of psi_b (N,3,2,T,Z,Y*Xh)."""
    return torch.stack([
        dslash_staggered_eo_pass_plain(u_here_pl, u_bw_pl, q, dims,
                                       target_parity, nhop, out_dtype)
        for q in psi_b])


def _checked_form(psi_pl, out_dtype):
    """(storage, out) dtypes of a card launch; raises for forms without a
    kernel instance."""
    store = psi_pl.dtype
    out_dtype = out_dtype or store
    if store not in _STORE_BYTES or out_dtype not in _STORE_BYTES:
        raise TypeError(f"psi {store} -> out {out_dtype}: the kernels take "
                        "float32 or bfloat16")
    if store == torch.float32 and out_dtype == torch.bfloat16:
        raise TypeError("float32 storage with bfloat16 output has no kernel "
                        "instance")
    return store, out_dtype


def _require_links(name, t, sites, store):
    if t.ndim == 7 and t.shape[1] == 2:
        raise NotImplementedError(
            f"{name}: recon-12 staggered links (R = 2) are refused: HISQ "
            "long links are not +-SU(3), so a rebuilt row 2 is wrong "
            "(ROADMAP C)")
    kernels.require(t, name, (4, 3, 3, 2) + sites, store)


def _count(fn, form: str) -> None:
    fn.launches += 1
    fn.launches_by_form[form] = fn.launches_by_form.get(form, 0) + 1


def dslash_staggered_eo_pallas_fused(fat_here_pl, fat_there_pl, psi_pl,
                                     dims, target_parity: int,
                                     long_here_pl=None, long_there_pl=None,
                                     out_dtype=None) -> torch.Tensor:
    """Checkerboarded fused fat + Naik hop D_{p <- 1-p} (S1): the
    improved-staggered CG hot path in one launch.  fat/long here:
    target-parity links; there: the opposite parity's, unshifted.  psi
    (3,2,T,Z,Y*Xh) of parity 1-p.  Out in ``out_dtype`` (default psi's)."""
    if long_here_pl is None or long_there_pl is None:
        raise ValueError(
            "the fused kernel IS the fat+Naik fusion; fat-only staggered "
            "has a single hop set: use dslash_staggered_eo_pallas")
    if target_parity not in (0, 1):
        raise ValueError(f"target_parity must be 0 or 1, got {target_parity}")
    T, Z, Y, X = dims
    Xh = X // 2
    links = (fat_here_pl, fat_there_pl, long_here_pl, long_there_pl)
    kind = kernels.dispatch_device(*links, psi_pl)
    if kind == "cpu":
        return dslash_staggered_eo_fused_plain(
            fat_here_pl, fat_there_pl, psi_pl, dims, target_parity,
            long_here_pl, long_there_pl, out_dtype)
    store, out_dtype = _checked_form(psi_pl, out_dtype)
    sites = (T, Z, Y * Xh)
    kernels.require(psi_pl, "psi_pl", (3, 2) + sites, store)
    for name, t in zip(("fat_here_pl", "fat_there_pl", "long_here_pl",
                        "long_there_pl"), links):
        _require_links(name, t, sites, store)
    lib = kernels.library()
    out = torch.empty(psi_pl.shape, dtype=out_dtype, device=psi_pl.device)
    rc = lib.qtt_staggered_eo_fused(
        out.data_ptr(), psi_pl.data_ptr(), *(t.data_ptr() for t in links),
        T, Z, Y, Xh, int(target_parity), int(store == torch.bfloat16),
        int(out_dtype == torch.bfloat16), kernels.stream_of(psi_pl))
    kernels.check_launch(rc, "qtt_staggered_eo_fused")
    _count(dslash_staggered_eo_pallas_fused, form_name(store, out_dtype))
    return out


def dslash_staggered_eo_pass(u_here_pl, u_bw_pl, psi_pl, dims,
                             target_parity: int, nhop: int,
                             out_dtype=None) -> torch.Tensor:
    """One hop set of count ``nhop`` (1 fat, 3 Naik) on the half lattice
    (S2): u_here target-parity forward links, u_bw from
    ``backward_links_eo``; psi (3,2,T,Z,Y*Xh) of parity 1-p."""
    if nhop not in HOPSET:
        raise ValueError(f"nhop must be 1 or 3, got {nhop}")
    if target_parity not in (0, 1):
        raise ValueError(f"target_parity must be 0 or 1, got {target_parity}")
    T, Z, Y, X = dims
    Xh = X // 2
    kind = kernels.dispatch_device(u_here_pl, u_bw_pl, psi_pl)
    if kind == "cpu":
        return dslash_staggered_eo_pass_plain(u_here_pl, u_bw_pl, psi_pl,
                                              dims, target_parity, nhop,
                                              out_dtype)
    store, out_dtype = _checked_form(psi_pl, out_dtype)
    sites = (T, Z, Y * Xh)
    kernels.require(psi_pl, "psi_pl", (3, 2) + sites, store)
    _require_links("u_here_pl", u_here_pl, sites, store)
    _require_links("u_bw_pl", u_bw_pl, sites, store)
    lib = kernels.library()
    out = torch.empty(psi_pl.shape, dtype=out_dtype, device=psi_pl.device)
    rc = lib.qtt_staggered_eo_pass(
        out.data_ptr(), psi_pl.data_ptr(), u_here_pl.data_ptr(),
        u_bw_pl.data_ptr(), T, Z, Y, Xh, int(target_parity), int(nhop),
        int(store == torch.bfloat16), int(out_dtype == torch.bfloat16),
        kernels.stream_of(psi_pl))
    kernels.check_launch(rc, "qtt_staggered_eo_pass")
    _count(dslash_staggered_eo_pass, pass_form_name(nhop, store, out_dtype))
    return out


def dslash_staggered_eo_pass_mrhs(u_here_pl, u_bw_pl, psi_b, dims,
                                  target_parity: int, nhop: int,
                                  acc=None) -> torch.Tensor:
    """One hop set of count ``nhop`` over N right-hand sides (S2-mrhs):
    psi_b (N,3,2,T,Z,Y*Xh) float32 of parity 1-p, links as for S2.
    Returns the float32 batch; with ``acc`` (a float32 batch of psi_b's
    shape) the pass is added into ``acc`` in place, which is returned."""
    if nhop not in HOPSET:
        raise ValueError(f"nhop must be 1 or 3, got {nhop}")
    if target_parity not in (0, 1):
        raise ValueError(f"target_parity must be 0 or 1, got {target_parity}")
    if psi_b.ndim != 6:
        raise ValueError(f"psi of shape {tuple(psi_b.shape)}: expected "
                         "(N, 3, 2, T, Z, Y*Xh)")
    T, Z, Y, X = dims
    Xh = X // 2
    f32 = torch.float32
    tensors = (u_here_pl, u_bw_pl, psi_b) + ((acc,) if acc is not None
                                             else ())
    kind = kernels.dispatch_device(*tensors)
    if kind == "cpu":
        out = dslash_staggered_eo_pass_mrhs_plain(
            u_here_pl, u_bw_pl, psi_b, dims, target_parity, nhop, f32)
        return out if acc is None else acc.add_(out)
    sites = (T, Z, Y * Xh)
    nrhs = psi_b.shape[0]
    wpp.check_mrhs_grid(nrhs, T * Z * Y * Xh, MRHS_CHUNK)
    if psi_b.dtype != f32:
        raise TypeError(f"psi {psi_b.dtype}: S2-mrhs has float32 forms "
                        "only, as the JAX batched staggered route")
    kernels.require(psi_b, "psi_b", (nrhs, 3, 2) + sites, f32)
    _require_links("u_here_pl", u_here_pl, sites, f32)
    _require_links("u_bw_pl", u_bw_pl, sites, f32)
    if acc is None:
        out = torch.empty(psi_b.shape, dtype=f32, device=psi_b.device)
    else:
        kernels.require(acc, "acc", tuple(psi_b.shape), f32)
        out = acc
    lib = kernels.library()
    rc = lib.qtt_staggered_eo_pass_mrhs(
        out.data_ptr(), psi_b.data_ptr(), u_here_pl.data_ptr(),
        u_bw_pl.data_ptr(), T, Z, Y, Xh, int(target_parity), int(nhop),
        int(acc is not None), nrhs, kernels.stream_of(psi_b))
    kernels.check_launch(rc, "qtt_staggered_eo_pass_mrhs")
    _count(dslash_staggered_eo_pass_mrhs, pass_form_name(nhop, f32, f32))
    return out


def dslash_staggered_eo_pallas_mrhs(fat_here_pl, fat_bw_pl, psi_b, dims,
                                    target_parity: int, long_here_pl=None,
                                    long_bw_pl=None,
                                    out_dtype=None) -> torch.Tensor:
    """Multi-RHS checkerboarded staggered hop: the batched staggered
    solver's stencil, ``dslash_staggered_eo_pallas`` with a leading RHS
    axis on psi (N,3,2,T,Z,Y*Xh), parity 1-p.  The fat pass (nhop 1),
    then with long links the Naik pass (nhop 3) added into it, each one
    S2-mrhs launch with its links loaded once per chunk; cast to
    ``out_dtype`` (default psi's)."""
    out = dslash_staggered_eo_pass_mrhs(fat_here_pl, fat_bw_pl, psi_b, dims,
                                        target_parity, 1)
    if long_here_pl is not None:
        out = dslash_staggered_eo_pass_mrhs(long_here_pl, long_bw_pl, psi_b,
                                            dims, target_parity, 3, acc=out)
    return out.to(out_dtype or psi_b.dtype)


def dslash_staggered_eo_pallas(fat_here_pl, fat_bw_pl, psi_pl, dims,
                               target_parity: int, long_here_pl=None,
                               long_bw_pl=None,
                               out_dtype=None) -> torch.Tensor:
    """Checkerboarded staggered (fat only) or two-pass improved hop on
    S2: the fat pass, plus with long links the Naik pass, each written in
    float32 and summed (the JAX function's XLA sum), then cast to
    ``out_dtype`` (default psi's).  Fat only is one launch straight into
    ``out_dtype``."""
    if long_here_pl is None:
        return dslash_staggered_eo_pass(fat_here_pl, fat_bw_pl, psi_pl,
                                        dims, target_parity, 1, out_dtype)
    f32 = torch.float32
    out = dslash_staggered_eo_pass(fat_here_pl, fat_bw_pl, psi_pl, dims,
                                   target_parity, 1, f32)
    out = out + dslash_staggered_eo_pass(long_here_pl, long_bw_pl, psi_pl,
                                         dims, target_parity, 3, f32)
    return out.to(out_dtype or psi_pl.dtype)


# -- the full-lattice forms (S2-full, S2-mrhs-full, S1-full) -----------------

def backward_links(links_pl: torch.Tensor, X: int,
                   nhop: int) -> torch.Tensor:
    """Pre-shifted backward links on the full lattice:
    out[mu](x) = U_mu(x - nhop*mu), links (4,3,3,2,T,Z,Y*X).  Computed
    once per link load, as the JAX function does."""
    Y = links_pl.shape[-1] // X
    return torch.stack([shift_packed(links_pl[mu], mu, -1, X, Y, nhop)
                        for mu in range(4)])


def _full_shift(X: int, Y: int):
    def sh(arr, mu, sign, nhop):
        return shift_packed(arr, mu, sign, X, Y, nhop)
    return sh


def dslash_staggered_pass_plain(u_pl, u_bw_pl, psi_pl, X: int,
                                nhop: int) -> torch.Tensor:
    """Plain PyTorch version of S2-full on its inputs (pre-shifted
    backward links), float32 sums and output."""
    Y = psi_pl.shape[-1] // X
    return spk.hopset_pairs(u_pl, u_bw_pl, psi_pl, _full_shift(X, Y), nhop)


def dslash_staggered_pass_mrhs_plain(u_pl, u_bw_pl, psi_b, X: int,
                                     nhop: int) -> torch.Tensor:
    """Plain version of S2-mrhs-full: S2-full's, lane by lane over the
    leading RHS axis of psi_b (N,3,2,T,Z,Y*X)."""
    return torch.stack([dslash_staggered_pass_plain(u_pl, u_bw_pl, q, X,
                                                    nhop) for q in psi_b])


def dslash_staggered_fused_plain(fat_pl, long_pl, psi_pl,
                                 X: int) -> torch.Tensor:
    """Plain version of S1-full on its inputs: the fat and Naik hop sets
    in float32, each with its links shifted back, summed."""
    acc = None
    for links, nhop in ((fat_pl, 1), (long_pl, 3)):
        term = dslash_staggered_pass_plain(
            links, backward_links(links, X, nhop), psi_pl, X, nhop)
        acc = term if acc is None else acc + term
    return acc


def _full_sites(psi_pl, X: int):
    T, Z, YX = psi_pl.shape[-3:]
    if YX % X:
        raise ValueError(f"fused axis {YX} is not a multiple of X = {X}")
    return T, Z, YX // X


def _check_nhop(nhop: int) -> None:
    if nhop not in HOPSET:
        raise ValueError(f"nhop must be 1 or 3, got {nhop}")


def full_mrhs_plan(T: int, Z: int, Y: int, X: int) -> dict:
    """S2-mrhs-full's launch on a T x Z x Y x X lattice
    (``wilson_pallas_packed.tile_plan``: two link sets of 72 floats a
    site)."""
    return wpp.tile_plan(T, Z, Y * X, FULL_MRHS_TILE, FULL_MRHS_LANES,
                         2 * 72)


def check_full_mrhs(nrhs: int, T: int, Z: int, Y: int, X: int) -> dict:
    """S2-mrhs-full's plan; raises ValueError for no right-hand side or a
    grid (T Z tiles of a plane) beyond 2^31 - 1 blocks."""
    return wpp.check_tile_grid("S2-mrhs-full", nrhs,
                               full_mrhs_plan(T, Z, Y, X))


def full_mrhs_info(nhop: int, accum: bool, T: int, Z: int, Y: int,
                   X: int) -> dict:
    """S2-mrhs-full's resources on the card, the instance of hop count
    ``nhop``, accumulating or not (``wilson_pallas_packed.tile_info``)."""
    _check_nhop(nhop)
    return wpp.tile_info("qtt_staggered_full_pass_mrhs_info", T, Z, Y, X,
                         nhop, int(bool(accum)))


def dslash_staggered_pass(u_pl, u_bw_pl, psi_pl, X: int,
                          nhop: int) -> torch.Tensor:
    """One hop set of count ``nhop`` (1 fat, 3 Naik) on the full lattice
    (S2-full): u_pl the links (4,3,3,2,T,Z,Y*X), u_bw_pl from
    ``backward_links``; psi (3,2,T,Z,Y*X).  float32 in and out."""
    _check_nhop(nhop)
    kind = kernels.dispatch_device(u_pl, u_bw_pl, psi_pl)
    if kind == "cpu":
        return dslash_staggered_pass_plain(u_pl, u_bw_pl, psi_pl, X, nhop)
    f32 = torch.float32
    T, Z, Y = _full_sites(psi_pl, X)
    sites = (T, Z, Y * X)
    kernels.require(psi_pl, "psi_pl", (3, 2) + sites, f32)
    _require_links("u_pl", u_pl, sites, f32)
    _require_links("u_bw_pl", u_bw_pl, sites, f32)
    lib = kernels.library()
    out = torch.empty(psi_pl.shape, dtype=f32, device=psi_pl.device)
    rc = lib.qtt_staggered_full_pass(
        out.data_ptr(), psi_pl.data_ptr(), u_pl.data_ptr(),
        u_bw_pl.data_ptr(), T, Z, Y, X, int(nhop),
        kernels.stream_of(psi_pl))
    kernels.check_launch(rc, "qtt_staggered_full_pass")
    _count(dslash_staggered_pass, pass_form_name(nhop, f32, f32))
    return out


def dslash_staggered_pass_mrhs(u_pl, u_bw_pl, psi_b, X: int, nhop: int,
                               acc=None) -> torch.Tensor:
    """One hop set of count ``nhop`` over N right-hand sides on the full
    lattice (S2-mrhs-full): psi_b (N,3,2,T,Z,Y*X) float32, links as for
    S2-full.  Returns the float32 batch; with ``acc`` (a float32 batch of
    psi_b's shape) the pass is added into ``acc`` in place, which is
    returned."""
    _check_nhop(nhop)
    if psi_b.ndim != 6:
        raise ValueError(f"psi of shape {tuple(psi_b.shape)}: expected "
                         "(N, 3, 2, T, Z, Y*X)")
    T, Z, Y = _full_sites(psi_b, X)
    nrhs = psi_b.shape[0]
    check_full_mrhs(nrhs, T, Z, Y, X)
    f32 = torch.float32
    tensors = (u_pl, u_bw_pl, psi_b) + ((acc,) if acc is not None else ())
    kind = kernels.dispatch_device(*tensors)
    if kind == "cpu":
        out = dslash_staggered_pass_mrhs_plain(u_pl, u_bw_pl, psi_b, X, nhop)
        return out if acc is None else acc.add_(out)
    sites = (T, Z, Y * X)
    if psi_b.dtype != f32:
        raise TypeError(f"psi {psi_b.dtype}: S2-mrhs-full has a float32 "
                        "form only")
    kernels.require(psi_b, "psi_b", (nrhs, 3, 2) + sites, f32)
    _require_links("u_pl", u_pl, sites, f32)
    _require_links("u_bw_pl", u_bw_pl, sites, f32)
    if acc is None:
        out = torch.empty(psi_b.shape, dtype=f32, device=psi_b.device)
    else:
        kernels.require(acc, "acc", tuple(psi_b.shape), f32)
        out = acc
    lib = kernels.library()
    rc = lib.qtt_staggered_full_pass_mrhs(
        out.data_ptr(), psi_b.data_ptr(), u_pl.data_ptr(),
        u_bw_pl.data_ptr(), T, Z, Y, X, int(nhop), int(acc is not None),
        nrhs, kernels.stream_of(psi_b))
    kernels.check_launch(rc, "qtt_staggered_full_pass_mrhs")
    _count(dslash_staggered_pass_mrhs, pass_form_name(nhop, f32, f32))
    return out


def dslash_staggered_pallas_fused(fat_pl, psi_pl, X: int,
                                  long_pl=None) -> torch.Tensor:
    """Full-lattice fused fat + Naik hop D psi (S1-full): the improved
    operator in one launch.  fat_pl, long_pl (4,3,3,2,T,Z,Y*X), phases
    folded, read unshifted (no backward copy); psi (3,2,T,Z,Y*X).  float32
    in and out."""
    if long_pl is None:
        raise ValueError(
            "the fused kernel IS the fat+Naik fusion; fat-only staggered "
            "has a single hop set: use dslash_staggered_pallas")
    kind = kernels.dispatch_device(fat_pl, long_pl, psi_pl)
    if kind == "cpu":
        return dslash_staggered_fused_plain(fat_pl, long_pl, psi_pl, X)
    f32 = torch.float32
    T, Z, Y = _full_sites(psi_pl, X)
    sites = (T, Z, Y * X)
    kernels.require(psi_pl, "psi_pl", (3, 2) + sites, f32)
    _require_links("fat_pl", fat_pl, sites, f32)
    _require_links("long_pl", long_pl, sites, f32)
    lib = kernels.library()
    out = torch.empty(psi_pl.shape, dtype=f32, device=psi_pl.device)
    rc = lib.qtt_staggered_full_fused(
        out.data_ptr(), psi_pl.data_ptr(), fat_pl.data_ptr(),
        long_pl.data_ptr(), T, Z, Y, X, kernels.stream_of(psi_pl))
    kernels.check_launch(rc, "qtt_staggered_full_fused")
    _count(dslash_staggered_pallas_fused, form_name(f32, f32))
    return out


def dslash_staggered_pallas(fat_pl, fat_bw_pl, psi_pl, X: int,
                            long_pl=None, long_bw_pl=None) -> torch.Tensor:
    """Full-lattice staggered (fat only) or two-pass improved D psi on
    S2-full: the fat pass, plus with long links the Naik pass, each in
    float32, summed (the JAX function's XLA sum)."""
    out = dslash_staggered_pass(fat_pl, fat_bw_pl, psi_pl, X, 1)
    if long_pl is not None:
        out = out + dslash_staggered_pass(long_pl, long_bw_pl, psi_pl, X, 3)
    return out


def dslash_staggered_pallas_mrhs(fat_pl, fat_bw_pl, psi_b, X: int,
                                 long_pl=None,
                                 long_bw_pl=None) -> torch.Tensor:
    """Multi-RHS full-lattice D psi on S2-mrhs-full: the fat pass, then
    with long links the Naik pass added into it in place, each one launch
    with its links loaded once per chunk of right-hand sides."""
    out = dslash_staggered_pass_mrhs(fat_pl, fat_bw_pl, psi_b, X, 1)
    if long_pl is not None:
        out = dslash_staggered_pass_mrhs(long_pl, long_bw_pl, psi_b, X, 3,
                                         acc=out)
    return out


# -- S1 on the fold layout, and the copy-free v3 pass ------------------------

def dslash_staggered_eo_fused_fold_plain(fat_here_f, fat_there_f, psi_f, dims,
                                         target_parity: int, long_here_f,
                                         long_there_f, out_dtype=None):
    """Plain version of S1-fold: S1's plain version on the unfolded
    operands (``from_fold``), the result folded again."""
    return wpp.to_fold(dslash_staggered_eo_fused_plain(
        *(wpp.from_fold(t) for t in (fat_here_f, fat_there_f, psi_f)), dims,
        target_parity, wpp.from_fold(long_here_f),
        wpp.from_fold(long_there_f), out_dtype))


def dslash_staggered_eo_pass_v3_plain(u_here_pl, u_there_pl, psi_pl, dims,
                                      target_parity: int, nhop: int,
                                      out_dtype=None):
    """Plain version of the v3 pass: S2's plain version on
    ``backward_links_eo(u_there_pl)``, the same function."""
    u_bw = backward_links_eo(u_there_pl, dims, target_parity, nhop)
    return dslash_staggered_eo_pass_plain(u_here_pl, u_bw, psi_pl, dims,
                                          target_parity, nhop, out_dtype)


def dslash_staggered_eo_pallas_fused_fold(fat_here_f, fat_there_f, psi_f,
                                          dims, target_parity: int,
                                          long_here_f=None, long_there_f=None,
                                          out_dtype=None) -> torch.Tensor:
    """Checkerboarded fused fat + Naik hop on folded arrays (S1-fold): every
    operand ``to_fold`` of S1's (links (4,3,3,T,2Z,Y*Xh), psi (3,T,2Z,Y*Xh)
    of parity 1-p); returns the folded hop in ``out_dtype`` (default
    psi's).  Full links (R = 3) and the Naik links are required, as in the
    JAX package."""
    if long_here_f is None or long_there_f is None:
        raise ValueError("fused fold kernel needs the Naik links")
    links = (fat_here_f, fat_there_f, long_here_f, long_there_f)
    for t in links:
        if t.ndim != 6 or t.shape[1] != 3:
            raise ValueError(
                f"dslash_staggered_eo_pallas_fused_fold: folded links must "
                f"be full storage (4, 3, 3, T, 2Z, Y*Xh), got "
                f"{tuple(t.shape)}: fold and recon-12 are alternative "
                "precision forms, not composed")
    if target_parity not in (0, 1):
        raise ValueError(f"target_parity must be 0 or 1, got {target_parity}")
    T, Z, Y, X = dims
    Xh = X // 2
    kind = kernels.dispatch_device(*links, psi_f)
    if kind == "cpu":
        return dslash_staggered_eo_fused_fold_plain(
            fat_here_f, fat_there_f, psi_f, dims, target_parity, long_here_f,
            long_there_f, out_dtype)
    store, out_dtype = _checked_form(psi_f, out_dtype)
    fsites = (T, 2 * Z, Y * Xh)
    kernels.require(psi_f, "psi_f", (3,) + fsites, store)
    for name, t in zip(("fat_here_f", "fat_there_f", "long_here_f",
                        "long_there_f"), links):
        kernels.require(t, name, (4, 3, 3) + fsites, store)
    lib = kernels.library()
    out = torch.empty(psi_f.shape, dtype=out_dtype, device=psi_f.device)
    rc = lib.qtt_staggered_eo_fused_fold(
        out.data_ptr(), psi_f.data_ptr(), *(t.data_ptr() for t in links),
        T, Z, Y, Xh, int(target_parity), int(store == torch.bfloat16),
        int(out_dtype == torch.bfloat16), kernels.stream_of(psi_f))
    kernels.check_launch(rc, "qtt_staggered_eo_fused_fold")
    _count(dslash_staggered_eo_pallas_fused_fold, form_name(store, out_dtype))
    return out


def dslash_staggered_eo_pass_v3(u_here_pl, u_there_pl, psi_pl, dims,
                                target_parity: int, nhop: int,
                                out_dtype=None, acc=None) -> torch.Tensor:
    """One hop set of count ``nhop`` (1 fat, 3 Naik) on the half lattice,
    copy-free (the v3 pass): u_here target-parity forward links, u_there
    the opposite parity's links, unshifted; psi (3,2,T,Z,Y*Xh) of parity
    1-p.  With ``acc`` (Naik only: a float32 field of psi's shape, the fat
    pass) the result is acc + this pass, rounded once to ``out_dtype``."""
    if nhop not in HOPSET:
        raise ValueError(f"nhop must be 1 or 3, got {nhop}")
    if acc is not None and nhop != 3:
        raise ValueError("acc: only the Naik pass adds the fat pass")
    if target_parity not in (0, 1):
        raise ValueError(f"target_parity must be 0 or 1, got {target_parity}")
    T, Z, Y, X = dims
    Xh = X // 2
    tensors = (u_here_pl, u_there_pl, psi_pl) + ((acc,) if acc is not None
                                                 else ())
    kind = kernels.dispatch_device(*tensors)
    if kind == "cpu":
        if acc is None:
            return dslash_staggered_eo_pass_v3_plain(
                u_here_pl, u_there_pl, psi_pl, dims, target_parity, nhop,
                out_dtype)
        naik = dslash_staggered_eo_pass_v3_plain(
            u_here_pl, u_there_pl, psi_pl, dims, target_parity, nhop,
            torch.float32)
        return (acc + naik).to(out_dtype or psi_pl.dtype)
    store, out_dtype = _checked_form(psi_pl, out_dtype)
    sites = (T, Z, Y * Xh)
    kernels.require(psi_pl, "psi_pl", (3, 2) + sites, store)
    _require_links("u_here_pl", u_here_pl, sites, store)
    _require_links("u_there_pl", u_there_pl, sites, store)
    if acc is not None:
        kernels.require(acc, "acc", (3, 2) + sites, torch.float32)
    lib = kernels.library()
    out = torch.empty(psi_pl.shape, dtype=out_dtype, device=psi_pl.device)
    rc = lib.qtt_staggered_eo_pass_v3(
        out.data_ptr(), psi_pl.data_ptr(), u_here_pl.data_ptr(),
        u_there_pl.data_ptr(), acc.data_ptr() if acc is not None else None,
        T, Z, Y, Xh, int(target_parity), int(nhop),
        int(store == torch.bfloat16), int(out_dtype == torch.bfloat16),
        kernels.stream_of(psi_pl))
    kernels.check_launch(rc, "qtt_staggered_eo_pass_v3")
    _count(dslash_staggered_eo_pass_v3, pass_form_name(nhop, store,
                                                       out_dtype))
    return out


def dslash_staggered_eo_pallas_v3(fat_here_pl, fat_there_pl, psi_pl, dims,
                                  target_parity: int, long_here_pl=None,
                                  long_there_pl=None,
                                  out_dtype=None) -> torch.Tensor:
    """Checkerboarded copy-free staggered hop (v3): fat only, one v3 pass
    into ``out_dtype`` (default psi's); improved, the fat pass in float32,
    then the Naik pass adding it and rounding once to ``out_dtype``: the
    JAX function's f32 sum and single cast, and S1's output bit for bit.
    Links here (target parity) and there (opposite parity), unshifted."""
    if long_here_pl is None:
        return dslash_staggered_eo_pass_v3(fat_here_pl, fat_there_pl, psi_pl,
                                           dims, target_parity, 1, out_dtype)
    fat = dslash_staggered_eo_pass_v3(fat_here_pl, fat_there_pl, psi_pl,
                                      dims, target_parity, 1, torch.float32)
    return dslash_staggered_eo_pass_v3(long_here_pl, long_there_pl, psi_pl,
                                       dims, target_parity, 3, out_dtype,
                                       acc=fat)


def reset_launches() -> None:
    """Zero the launch counts of S1, S2, S2-mrhs, S1-fold and the v3 pass,
    and of the full-lattice forms."""
    for fn in (dslash_staggered_eo_pallas_fused, dslash_staggered_eo_pass,
               dslash_staggered_eo_pass_mrhs, dslash_staggered_pass,
               dslash_staggered_pass_mrhs, dslash_staggered_pallas_fused,
               dslash_staggered_eo_pallas_fused_fold,
               dslash_staggered_eo_pass_v3):
        fn.launches = 0
        fn.launches_by_form = {}


reset_launches()
