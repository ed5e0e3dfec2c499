"""Public parameter structs, as in quda_tpu/interfaces/params.py.

``GaugeParam``, ``InvertParam`` and ``MultigridParamAPI`` keep the JAX
package's field names, defaults and enum spellings, for the fields the
ported routes read.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

DSLASH_TYPES = ("wilson", "clover", "twisted-mass", "twisted-clover",
                "ndeg-twisted-mass", "ndeg-twisted-clover", "staggered",
                "asqtad", "hisq", "domain-wall", "domain-wall-4d", "mobius",
                "mobius-eofa", "laplace")
INVERTER_TYPES = ("cg", "cg3", "cgne", "cgnr", "pcg", "bicgstab",
                  "bicgstab-l", "gcr", "mr", "sd", "ca-cg", "ca-gcr",
                  "multi-shift-cg", "gcr-mg")
PRECISIONS = ("double", "single", "half", "quarter")
RECONSTRUCTS = (18, 12, 8)
MATPC_TYPES = ("even-even", "odd-odd")
SOLVE_TYPES = ("direct", "direct-pc", "normop", "normop-pc")


class QudaError(RuntimeError):
    """Invalid parameters (errorQuda analog)."""


def _check(cond, msg):
    if not cond:
        raise QudaError(msg)


@dataclasses.dataclass
class GaugeParam:
    """QudaGaugeParam."""
    X: Tuple[int, int, int, int] = (8, 8, 8, 8)   # (x,y,z,t)
    t_boundary: str = "antiperiodic"               # periodic|antiperiodic
    cuda_prec: str = "double"                      # device precision
    # link storage of every packed operator of a solve: 18 = full links,
    # 12 = two rows with the third rebuilt in the hop kernel
    reconstruct: int = 18
    anisotropy: float = 1.0

    def validate(self):
        _check(len(self.X) == 4 and all(d > 0 for d in self.X),
               f"bad lattice dims {self.X}")
        _check(self.t_boundary in ("periodic", "antiperiodic"),
               f"bad t_boundary {self.t_boundary}")
        _check(self.cuda_prec in PRECISIONS, f"bad prec {self.cuda_prec}")
        _check(self.reconstruct in RECONSTRUCTS,
               f"bad reconstruct {self.reconstruct}")
        _check(self.anisotropy > 0, f"bad anisotropy {self.anisotropy}")
        return self


@dataclasses.dataclass
class InvertParam:
    """QudaInvertParam; the result fields are filled by invert_quda."""
    dslash_type: str = "wilson"
    inv_type: str = "cg"
    solve_type: str = "normop-pc"
    matpc_type: str = "even-even"
    # staggered mass m of M = 2m + D (MILC convention); the domain-wall
    # quark mass mf
    mass: float = -0.9
    kappa: float = 0.12
    # twisted mass mu (a = 2 kappa mu) and the doublet's splitting epsilon
    mu: float = 0.0
    epsilon: float = 0.0
    # clover coefficient c_sw of dslash_type "clover" and "twisted-clover"
    csw: float = 0.0
    # domain wall: height m5 (QUDA sign convention), Ls, Möbius b5 and c5
    m5: float = -1.8
    Ls: int = 8
    b5: float = 1.5
    c5: float = 0.5
    # Möbius EOFA: chirality of the shift, the shift, and mq1-3 (None =
    # the quark mass)
    eofa_pm: bool = True
    eofa_shift: float = 0.0
    eofa_mq1: float = None
    eofa_mq2: float = None
    eofa_mq3: float = None
    tol: float = 1e-10
    tol_hq: float = 0.0
    maxiter: int = 10000
    reliable_delta: float = 0.1
    # invert_multishift_quda: the shifts sigma_i of (M + sigma_i) x_i = b
    num_offset: int = 0
    offset: Sequence[float] = ()
    cuda_prec: str = "double"
    # "auto" resolves to cuda_prec (the JAX package's non-TPU branch);
    # "half" is bfloat16 pair storage with reliable updates
    cuda_prec_sloppy: str = "auto"
    # restart length of the outer GCR of inv_type "gcr-mg"
    gcrNkrylov: int = 16
    # results
    true_res: float = 0.0
    iter_count: int = 0
    secs: float = 0.0
    gflops: float = 0.0
    converged: bool = True
    # the df64 route's low word: x + x_df64_lo is the full-precision
    # solution (None on the other routes)
    x_df64_lo: object = None
    # reliable updates made by the mixed-precision and df64 routes (a
    # result the JAX package reports only in its traced events)
    reliable_updates: int = 0
    # multi-source results (invert_multi_src_quda): per-RHS true
    # residuals, iteration counts and convergence claims; iter_count and
    # gflops then hold the per-RHS sums, true_res the worst lane and
    # converged whether every lane converged.  invert_multishift_quda
    # fills converged_multi per shift
    true_res_multi: Sequence[float] = ()
    iter_count_multi: Sequence[int] = ()
    converged_multi: Sequence[bool] = ()

    def validate(self):
        _check(self.dslash_type in DSLASH_TYPES,
               f"unknown dslash_type {self.dslash_type}")
        _check(self.inv_type in INVERTER_TYPES,
               f"unknown inv_type {self.inv_type}")
        _check(self.solve_type in SOLVE_TYPES,
               f"unknown solve_type {self.solve_type}")
        _check(self.matpc_type in MATPC_TYPES,
               f"unknown matpc_type {self.matpc_type}")
        _check(self.tol > 0 and self.maxiter > 0, "bad tol/maxiter")
        _check(self.cuda_prec in PRECISIONS, f"bad prec {self.cuda_prec}")
        _check(self.cuda_prec_sloppy in PRECISIONS + ("auto",),
               f"bad sloppy prec {self.cuda_prec_sloppy}")
        _check(0.0 < self.reliable_delta < 1.0,
               f"bad reliable_delta {self.reliable_delta}")
        if self.num_offset:
            _check(len(self.offset) == self.num_offset, "offset mismatch")
        _check(self.gcrNkrylov > 0, f"bad gcrNkrylov {self.gcrNkrylov}")
        return self


@dataclasses.dataclass
class MultigridParamAPI:
    """QudaMultigridParam (quda.h:616), per-level lists, with the JAX
    package's defaults.  ``vec_infile``/``vec_outfile`` are kept and, as
    in the JAX package's routes, not read."""
    n_level: int = 2
    geo_block_size: Sequence[Tuple[int, int, int, int]] = ((2, 2, 2, 2),)
    n_vec: Sequence[int] = (8,)
    setup_iters: Sequence[int] = (150,)
    # null-vector solve tolerance per level (the block solve of M v = 0
    # stops at |r| <= tol |M v0|, setup_iters being the cap)
    setup_tol: Sequence[float] = (5e-6,)
    nu_pre: Sequence[int] = (0,)
    nu_post: Sequence[int] = (4,)
    smoother_omega: float = 0.85
    coarse_solver_iters: int = 8
    vec_outfile: str = ""
    vec_infile: str = ""

    def validate(self):
        n = self.n_level - 1
        _check(n >= 1, f"bad n_level {self.n_level}")
        _check(len(self.geo_block_size) >= n, "need block size per level")
        _check(len(self.n_vec) >= n, "need n_vec per level")
        return self
