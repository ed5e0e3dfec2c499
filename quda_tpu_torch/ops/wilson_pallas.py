"""Spin-projection tables of the Wilson hop, the canonical-layout hop
kernel (B11) and the tuned dslash.

Port of quda_tpu/ops/wilson_pallas.py.  The tables (``_derive_tables`` and
``TABLES``) are DERIVED from ops/gamma.py and asserted: for
P = 1 - sign*gamma_mu, the half spinor is h_a = psi_a + c_a psi_{j_a}
(a = 0, 1) and the reconstructed rows are out_2 = d_2 h_{k_2},
out_3 = d_3 h_{k_3}.  Both the plain stencil (ops/wilson_packed.py) and
the CUDA kernels (csrc/wilson_hop.cuh, shared by every Wilson hop kernel,
carries them as compile-time constants) use these tables.

``dslash_pallas`` replaces the JAX module's Pallas kernel of that name
(``_kernel``) with ``csrc/wilson_canonical.cu``: the hop on complex fields
in the canonical layout, gauge (4,T,Z,Y,X,3,3) with the boundary phases
folded in and psi (T,Z,Y,X,4,3), complex64 or complex128.  The kernel
reads them as float pairs through ``torch.view_as_real`` (no copy), re/im
innermost.  CPU tensors run the plain version ``dslash_canonical_plain``
(the complex stencil ops/wilson.dslash_full); CUDA tensors launch the
kernel or raise.  ``dslash_pallas.launches`` counts its launches
(``launches_by_form``: ``"canonical:f32"``, ``"canonical:f64"``).

``tuned_dslash`` races the JAX package's candidate set through
utils/tune.py on canonical complex fields: the complex stencil (``xla``)
and the packed pair stencil (``xla_packed``) everywhere, and on the card
B4 (``pallas_packed``, with the layout conversions and the backward-link
shift charged to it) and B10 (``pallas_v3``).  ``dslash_pallas`` is not a
candidate, as it is not in the JAX package's set.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import kernels
from . import gamma as g


def _derive_tables():
    tables = {}
    for mu in range(4):
        for sign in (+1, -1):
            P = np.eye(4) - sign * np.asarray(g.GAMMAS[mu])
            entry = {}
            for a in (0, 1):
                row = P[a]
                assert row[a] == 1.0
                nz = [j for j in range(4) if j != a and abs(row[j]) > 1e-12]
                assert len(nz) == 1, (mu, sign, a, row)
                entry[f"j{a}"] = nz[0]
                entry[f"c{a}"] = complex(row[nz[0]])
            for b in (2, 3):
                row = P[b]
                found = False
                for a in (0, 1):
                    ra = P[a]
                    nz_b = np.nonzero(np.abs(row) > 1e-12)[0]
                    nz_a = np.nonzero(np.abs(ra) > 1e-12)[0]
                    if set(nz_b) == set(nz_a):
                        d = row[nz_b[0]] / ra[nz_b[0]]
                        assert np.allclose(row, d * ra), (mu, sign, b)
                        entry[f"k{b}"] = a
                        entry[f"d{b}"] = complex(d)
                        found = True
                        break
                assert found, (mu, sign, b)
            tables[(mu, sign)] = entry
    return tables


TABLES = _derive_tables()


# -- the canonical-layout hop (B11) ------------------------------------------

# Kernel vs plain version, max |kernel - plain| / max |plain|: float32 sums
# in another order and with fused multiply-adds on the card; float64 the
# same at double precision.
TOLERANCE = 1e-5
TOLERANCE_F64 = 1e-12
_REAL = {torch.complex64: torch.float32, torch.complex128: torch.float64}
_SHORT = {torch.complex64: "f32", torch.complex128: "f64"}


def dslash_canonical_plain(gauge: torch.Tensor,
                           psi: torch.Tensor) -> torch.Tensor:
    """Plain version of B11 on its inputs: the complex stencil
    ops/wilson.dslash_full, in psi's precision."""
    from .wilson import dslash_full
    return dslash_full(gauge, psi)


def dslash_pallas(gauge: torch.Tensor, psi: torch.Tensor,
                  interpret: bool = False) -> torch.Tensor:
    """Wilson hop sum D psi on canonical complex fields (B11): gauge
    (4,T,Z,Y,X,3,3) with the boundary phases folded in, psi (T,Z,Y,X,4,3),
    both complex64 or both complex128; the output has psi's dtype and
    shape.  ``interpret`` (the TPU kernel's) is accepted and ignored."""
    kind = kernels.dispatch_device(gauge, psi)
    if kind == "cpu":
        return dslash_canonical_plain(gauge, psi)
    if psi.dtype not in _REAL or gauge.dtype != psi.dtype:
        raise TypeError(f"gauge {gauge.dtype}, psi {psi.dtype}: the "
                        "canonical hop takes complex64 or complex128 fields "
                        "of one dtype")
    T, Z, Y, X = psi.shape[:4]
    real = _REAL[psi.dtype]
    kernels.require(psi, "psi", (T, Z, Y, X, 4, 3), psi.dtype)
    kernels.require(gauge, "gauge", (4, T, Z, Y, X, 3, 3), psi.dtype)
    psi_f, gauge_f = torch.view_as_real(psi), torch.view_as_real(gauge)
    align = 2 * real.itemsize
    if psi_f.data_ptr() % align or gauge_f.data_ptr() % align:
        raise ValueError(f"the canonical hop loads a complex number at "
                         f"once: the fields must be {align}-byte aligned")
    out = torch.empty(psi_f.shape, dtype=real, device=psi.device)
    rc = kernels.library().qtt_wilson_canonical(
        out.data_ptr(), psi_f.data_ptr(), gauge_f.data_ptr(), T, Z, Y, X,
        int(real == torch.float64), kernels.stream_of(psi))
    kernels.check_launch(rc, "qtt_wilson_canonical")
    dslash_pallas.launches += 1
    form = f"canonical:{_SHORT[psi.dtype]}"
    dslash_pallas.launches_by_form[form] = (
        dslash_pallas.launches_by_form.get(form, 0) + 1)
    return torch.view_as_complex(out)


def reset_launches() -> None:
    """Zero the launch counts of B11."""
    dslash_pallas.launches = 0
    dslash_pallas.launches_by_form = {}


reset_launches()


# -- the tuned dslash --------------------------------------------------------

_TUNED_CACHE: dict = {}


def _tuned_candidates(lat, dtype_str: str, backend: str) -> dict:
    """The candidate set per (lattice, dtype, backend), cached at module
    level: ``xla`` (the complex stencil) and ``xla_packed`` (the packed
    pair stencil) everywhere; on the card (``backend`` "cuda") also
    ``pallas_packed`` (B4) and ``pallas_v3`` (B10), each on canonical
    fields with its layout conversions (and B4's backward-link shift)
    inside, as the JAX package's set charges them."""
    key = (lat, dtype_str, backend)
    if key in _TUNED_CACHE:
        return _TUNED_CACHE[key]
    from . import wilson as wops
    from . import wilson_packed as wpk
    from . import wilson_pallas_packed as wpp
    T, Z, Y, X = lat

    def packed_xla(gauge, psi):
        cdt = wpk.compute_dtype(_REAL[psi.dtype])
        out = wpk.dslash_packed_pairs(
            wpk.to_packed_pairs(wpk.pack_gauge(gauge), cdt),
            wpk.to_packed_pairs(wpk.pack_spinor(psi), cdt), X, Y)
        return wpk.unpack_spinor(wpk.from_packed_pairs(out, psi.dtype), lat)

    candidates = {"xla": wops.dslash_full, "xla_packed": packed_xla}
    if backend == "cuda":
        def on_pallas_layout(hop):
            def run(gauge, psi):
                gp = wpp.to_pallas_layout(wpk.pack_gauge(gauge)).contiguous()
                pp = wpp.to_pallas_layout(wpk.pack_spinor(psi)).contiguous()
                out = wpp.from_pallas_layout(hop(gp, pp, X), psi.dtype)
                return wpk.unpack_spinor(out, lat)
            return run

        candidates["pallas_packed"] = on_pallas_layout(
            wpp.dslash_pallas_packed)
        candidates["pallas_v3"] = on_pallas_layout(
            wpp.dslash_pallas_packed_v3)
    _TUNED_CACHE[key] = candidates
    return candidates


def tuned_dslash(gauge: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
    """Autotuned Wilson hop on canonical complex fields (gauge with the
    boundary phases folded in): races the candidates of
    ``_tuned_candidates`` once per (platform, lattice, dtype, device
    type) through utils/tune.py and applies the cached winner.  A
    candidate that raises fails the call (utils/tune.py)."""
    from ..utils import tune
    lat = tuple(int(d) for d in psi.shape[:4])
    backend = psi.device.type
    candidates = _tuned_candidates(lat, str(psi.dtype), backend)
    winner = tune.tune("wilson_dslash", lat, candidates, (gauge, psi),
                       aux=f"{psi.dtype}/{backend}")
    return candidates[winner](gauge, psi)
