"""Adaptive multigrid, as in quda_tpu/mg/mg.py: the hierarchy's set-up (null
vectors, transfer, coarse operator), the recursive V-cycle and the
runtime check ``verify``.

Set-up per level: n_vec near-null vectors of the level operator (a loose
block solve of M v = 0 from random initial guesses, QUDA's
generateNullVectors), block-orthonormalised into a transfer, then the
Galerkin coarse stencil R M P built by batched probes (mg/gemm.py), and
the next level below it.  Apply: the V-cycle (optional
pre-smoothing, restrict the residual, recurse or solve the coarsest level
with fixed GCR, prolong and correct, post-smoothing) preconditions an
outer flexible GCR (mg/pair.mg_solve_pairs).

The layout hooks (``_example_field``, ``_random_like``,
``_transfer_from_nulls``, ``_build_coarse_gemm``, ``_adapt``) let the
hierarchy logic be written once; the port has one representation, the
pair arrays of mg/pair.PairMG.  The complex hierarchy behind them in the
JAX package (``_LevelOp``, ``_StaggeredLevelOp``, the Kaehler-Dirac
composition) is not ported (ROADMAP A12), nor are the ``legacy`` set-up
pipeline (fixed-iteration CG and the masked probe loop as the set-up's
default) and the cached constant-free programs of mg/opstate.py, which
exist to skip JAX's retracing and recompiling; PyTorch runs eagerly and
has nothing to cache.  ``coarse_replicate`` (a mesh of chips) waits for
ROADMAP A15.

Randomness comes from a ``torch.Generator`` where JAX takes a PRNG key;
tests that compare the two hierarchies carry JAX's arrays across
(``PairMG.from_arrays``).  The null-vector solve is QUDA's homogeneous
one, where the JAX package solves M v = r for random r: near kappa_c
those vectors do not make a hierarchy that beats CG (PERF.md).  The
probe columns the coarse build applies at once follow from the free
device memory (mg/gemm.py) where the JAX package reads an environment
knob; the null vectors of a level are solved in one batch (JAX's
QUDA_TPU_MG_NULL_CHUNK has no counterpart: 24 lanes at 32^3 x 64 fit the
card, PERF.md).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..ops import blas
from ..solvers.gcr import gcr_fixed, mr_fixed

log = logging.getLogger("quda_tpu_torch")


def parity_eps(lat, trailing):
    """Site-parity mask ``(t+z+y+x) % 2`` (numpy) with ``trailing``
    broadcast axes appended: the staggered chiral embedding's epsilon."""
    T, Z, Y, X = lat
    t = np.arange(T)[:, None, None, None]
    z = np.arange(Z)[None, :, None, None]
    y = np.arange(Y)[None, None, :, None]
    x = np.arange(X)[None, None, None, :]
    return ((t + z + y + x) % 2).reshape((T, Z, Y, X) + (1,) * trailing)


def _normalized_batch(xs: torch.Tensor) -> torch.Tensor:
    n = xs.shape[0]
    norms = torch.sum((xs * xs).reshape(n, -1), dim=1)
    scale = (1.0 / torch.sqrt(norms)).to(xs.dtype)
    return xs * scale.reshape((n,) + (1,) * (xs.ndim - 1))


def _null_solve_layout(op):
    """(to_layout, from_layout) of a level's null-vector block solve: the
    fine Wilson level solves in its kernel layout (``to_mrhs_layout``),
    the coarse operators in their own."""
    if hasattr(op, "to_mrhs_layout"):
        return op.to_mrhs_layout, op.from_mrhs_layout
    return (lambda v: v), (lambda v: v)


def _null_solve_mv(op, use_cg):
    """The batched matvec of that solve: the multi-RHS stencil B5 on the
    fine Wilson level (``M_mrhs_pl``), the batch-aware M (or MdagM) of a
    coarse operator."""
    if hasattr(op, "M_mrhs_pl"):
        return op.MdagM_mrhs_pl if use_cg else op.M_mrhs_pl
    return op.MdagM if use_cg else op.M


def _null_solve_body(mv, bb, tol, maxiter, use_cg):
    """Tolerance-stopped block solve of A v = 0 (A = M under BiCGStab,
    MdagM under CG) from the initial guesses bb, a real (pair) batch of
    random vectors, normalised, as QUDA's generateNullVectors: v = bb -
    A^-1 A bb, the components of bb the solve has not removed, which are
    the low modes."""
    from ..solvers.block import batched_bicgstab_pairs, batched_cg_pairs
    solve = batched_cg_pairs if use_cg else batched_bicgstab_pairs
    xs = solve(mv, mv(bb), tol=tol, maxiter=maxiter).x
    return _normalized_batch(xs.neg_().add_(bb))


def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


@dataclasses.dataclass
class MGLevelParam:
    """Per-level knobs (QudaMultigridParam analog): the JAX package's
    fields and defaults."""
    block: Tuple[int, int, int, int] = (2, 2, 2, 2)
    n_vec: int = 8
    setup_iters: int = 150          # iteration cap per null-vector solve
    setup_tol: float = 5e-6         # null-vector solve tolerance
    # 'bicgstab': batched BiCGStab on the direct system M v = 0 (QUDA's
    # generateNullVectors); 'cg': CG on MdagM v = 0
    setup_solver: str = "bicgstab"
    pre_smooth: int = 0             # QUDA default: no pre-smoothing
    post_smooth: int = 4
    smoother: str = "mr"            # "mr" | "ca-gcr"
    smoother_omega: float = 0.85
    coarse_solver_iters: int = 8    # GCR iterations on the bottom level
    coarse_solver_cycles: int = 2
    # all levels below run replicated on a mesh of chips (ROADMAP A15)
    coarse_replicate: bool = False


class MG:
    """Multigrid preconditioner hierarchy over the layout hooks below;
    mg/pair.PairMG supplies the pair representation."""

    _transfer_from_nulls = None     # layout hooks: mg/pair.PairMG's
    _build_coarse_gemm = None
    _example_field = None

    def __init__(self, fine_dirac, geom, params: Sequence[MGLevelParam],
                 generator=None, verbosity: int = 0, kd: bool = False):
        if any(p.coarse_replicate for p in params):
            raise NotImplementedError(
                "coarse_replicate (coarse levels replicated over a mesh "
                "of chips) is not ported yet (ROADMAP A15)")
        self.geom = geom
        self.params = list(params)
        self.levels: List[dict] = []
        self.null_fallbacks: List[int] = []
        self.adapter = (fine_dirac if hasattr(fine_dirac, "k_fine")
                        else self._adapt(fine_dirac, kd=kd))
        if generator is None:
            generator = torch.Generator(device=self.adapter.device)
            generator.manual_seed(2024)
        self._setup(self.adapter, generator, verbosity)

    @staticmethod
    def _adapt(fine_dirac, kd: bool = False):
        raise NotImplementedError(
            "the complex multigrid hierarchy is not ported (ROADMAP A12); "
            "mg/pair.PairMG serves Wilson and the staggered family")

    # -- layout hooks --------------------------------------------------
    def _random_like(self, example, generator):
        """Gaussian field(s) of ``example``'s shape."""
        return torch.randn(example.shape, generator=generator,
                           dtype=example.dtype, device=example.device)

    # -- set-up --------------------------------------------------------
    def _generate_null_vectors(self, level_op, example, n_vec, p,
                               generator):
        """Near-null vectors of one level, normalised: block solves of
        M v = 0 from n_vec random initial guesses (projected onto the
        operator's image where the level has ``project_null_source``, the
        staggered level), one batch through the
        level's multi-RHS matvec (the fine level in its kernel layout: the
        batch is transposed once, not per matvec).  If
        BiCGStab breaks down (a lane not finite, r0-orthogonality
        collapse near kappa critical), the level falls back to CG on the
        normal equations, which cannot break down, with a warning;
        ``self.null_fallbacks`` records the level."""
        use_cg = p.setup_solver == "cg"
        to_l, from_l = _null_solve_layout(level_op)
        bs = torch.stack([self._random_like(example, generator)
                          for _ in range(n_vec)])
        proj = getattr(level_op, "project_null_source", None)
        if proj is not None:
            # the staggered chiral space is twice the image of to_chiral:
            # the part of a guess outside the image is annihilated by M,
            # so a solve of M v = 0 would keep it untouched in v (JAX
            # quda_tpu/mg/mg.py projects its sources the same way)
            bs = proj(bs)
        bs = to_l(bs)

        def run_solve(cg_flag):
            return from_l(_null_solve_body(
                _null_solve_mv(level_op, cg_flag), bs, float(p.setup_tol),
                int(p.setup_iters), cg_flag))

        nulls = run_solve(use_cg)
        if not use_cg and not bool(torch.isfinite(nulls).all()):
            log.warning("MG set-up: the BiCGStab null-vector solve broke "
                        "down (lanes not finite); falling back to CG on "
                        "the normal equations for this level")
            self.null_fallbacks.append(len(self.levels))
            nulls = run_solve(True)
        return nulls

    def _phase(self, level: int, phase: str, t0: float, product) -> None:
        """Close one timed set-up phase: wait for the card so no phase is
        billed another's work, and append {level, phase, seconds} to
        ``setup_breakdown``."""
        _sync(product)
        self.setup_breakdown.append(
            {"level": level, "phase": phase,
             "seconds": time.perf_counter() - t0})

    def _setup(self, adapter, generator, verbosity):
        """Build every level; ``setup_breakdown`` holds one row per
        (level, phase) of null_vectors | transfer_build | coarse_probe,
        and ``setup_seconds`` the total, also when a level fails."""
        self.setup_breakdown = []
        self.setup_seconds = 0.0
        t0 = time.perf_counter()
        try:
            self._setup_levels(adapter, generator, verbosity)
        finally:
            self.setup_seconds = time.perf_counter() - t0

    def _setup_levels(self, adapter, generator, verbosity):
        level_op = adapter
        lat_shape = self.geom.lattice_shape
        k_fine = adapter.k_fine        # 6 on a Wilson level, n_vec coarse
        for li, p in enumerate(self.params):
            example = self._example_field(lat_shape, k_fine, level_op.dtype,
                                          level_op.device)
            t0 = time.perf_counter()
            nulls = self._generate_null_vectors(level_op, example, p.n_vec,
                                                p, generator)
            self._phase(li, "null_vectors", t0, nulls)
            t0 = time.perf_counter()
            transfer = self._transfer_from_nulls(nulls, p.block)
            del nulls
            self._phase(li, "transfer_build", t0, transfer.v)
            t0 = time.perf_counter()
            coarse = self._build_coarse_gemm(level_op, transfer)
            self._phase(li, "coarse_probe", t0, coarse.x_diag)
            self.levels.append(dict(op=level_op, transfer=transfer,
                                    coarse=coarse, param=p))
            if verbosity:
                log.info("MG level %d: lattice %s k=%d -> coarse %s "
                         "n_vec=%d", li, lat_shape, k_fine,
                         transfer.coarse_shape, p.n_vec)
            level_op = coarse
            lat_shape = transfer.coarse_shape
            k_fine = p.n_vec

    # -- apply ---------------------------------------------------------
    def vcycle(self, level: int, b, x0=None):
        """Approximately solve M_level x = b (chiral layout)."""
        lv = self.levels[level]
        op, tr, coarse, p = lv["op"], lv["transfer"], lv["coarse"], \
            lv["param"]

        def smooth(bb, n, x):
            if p.smoother == "ca-gcr":
                return gcr_fixed(op.M, bb, nkrylov=n, cycles=1, x0=x)
            return mr_fixed(op.M, bb, n, p.smoother_omega, x0=x)

        x = torch.zeros_like(b) if x0 is None else x0
        if p.pre_smooth:
            x = smooth(b, p.pre_smooth, x)
        # with no initial guess and no pre-smoothing x is 0 and r is b:
        # the apply of M on 0 that JAX traces is skipped
        r = b if (x0 is None and not p.pre_smooth) else b - op.M(x)
        rc = tr.restrict(r)
        if level + 1 < len(self.levels):
            ec = self.vcycle(level + 1, rc)
        else:
            ec = gcr_fixed(coarse.M, rc, nkrylov=p.coarse_solver_iters,
                           cycles=p.coarse_solver_cycles)
        x = x + tr.prolong(ec)
        if p.post_smooth:
            x = smooth(b, p.post_smooth, x)
        return x

    def precondition(self, r_std):
        """K(r) for an outer solver in the standard (canonical) layout."""
        a = self.adapter
        return a.from_chiral(self.vcycle(0, a.to_chiral(r_std)))

    # -- runtime verification (MG::verify, lib/multigrid.cpp:762) ------
    def verify(self, generator=None, galerkin_tol: float = 1e-10,
               pr_tol: float = 1e-10):
        """R P = 1 and Galerkin consistency (coarse M = R M P) on every
        level, with a random coarse vector; returns the per-level report
        and raises on a violation."""
        if generator is None:
            generator = torch.Generator(device=self.adapter.device)
            generator.manual_seed(17)
        report = []
        for li, lv in enumerate(self.levels):
            op, tr, coarse = lv["op"], lv["transfer"], lv["coarse"]
            vc = self._random_like(
                self._example_field(tr.coarse_shape, tr.n_vec, op.dtype,
                                    op.device), generator)
            rp = tr.restrict(tr.prolong(vc))
            e_rp = float(torch.sqrt(blas.norm2(rp - vc) / blas.norm2(vc)))
            lhs = coarse.M(vc)
            rhs = tr.restrict(op.M(tr.prolong(vc)))
            e_g = float(torch.sqrt(blas.norm2(lhs - rhs)
                                   / torch.clamp(blas.norm2(rhs),
                                                 min=1e-30)))
            report.append({"level": li, "rp_identity": e_rp,
                           "galerkin": e_g})
            if e_rp > pr_tol:
                raise RuntimeError(
                    f"MG verify level {li}: R P != I ({e_rp:.2e})")
            if e_g > galerkin_tol:
                raise RuntimeError(
                    f"MG verify level {li}: Galerkin violated ({e_g:.2e})")
        return report
