"""Public entry points: init_quda / load_gauge_quda / invert_quda / end_quda.

Port of the Wilson and Wilson-clover even/odd CG paths of
quda_tpu/interfaces/quda_api.py.  ``invert_quda`` serves
dslash_type="wilson" and "clover", inv_type="cg", solve_type="normop-pc"
with cuda_prec="single", on the packed pair representation (the float32
and bfloat16 pair operators that ``pairs`` builds, the same way for both
families):

* sloppy = single: ``fused_cg`` on the float32 pair operator (every hop
  on the eo kernel, or for clover on the fused clover hop; the CG tail on
  the fused tail kernel);
* sloppy = half: ``cg_reliable`` with a bfloat16 sloppy operator and
  reliable updates on the float32 one;
* Wilson only, tol < 5e-8, sloppy single or half: the df64 route,
  ``cg_reliable_df`` against a float32-pair precise operator
  (``_invert_wilson_df64``), which publishes ``param.x_df64_lo``.  As in
  the JAX package the gate is Wilson-only: a clover solve below 5e-8
  takes its float32 route; ``converged`` is the solver's own claim, as
  there, and ``true_res`` says how far the float32 solve got.

Links are full or recon-12 (``GaugeParam.reconstruct`` 18 or 12).  The
epilogue checks the true residual of M x = b with the full-lattice
complex operator (ops/wilson.py, models/clover.py), which no kernel
touches; the df64 route reports its df64 full-lattice residual.
Every other route raises ``NotImplementedError`` naming the ROADMAP item
that will bring it.

``invert_multi_src_quda`` solves N sources on one gauge field.  Wilson and
clover ``normop-pc`` CG-family solves at cuda_prec="single" and
tol >= 5e-8 take the batched pair route: every Krylov iterate is an
(N,4,3,2,T,Z,Y*Xh) batch and every hop one launch of a multi-RHS kernel
(B5-eo, B7-mrhs).  Every other request loops over ``invert_quda``.

Resident state (device, geometry, gauge) lives in a module-level context,
as interface_quda.cpp keeps it, between ``init_quda`` and ``end_quda``.
"""

from __future__ import annotations

import copy
import logging
import math
import time

import torch

from ..fields.geometry import EVEN, ODD, LatticeGeometry
from ..fields.spinor import even_odd_join, even_odd_split
from ..ops import blas
from ..utils.convert import gauge_from_host, spinor_from_host
from ..utils.device import resolve_device
from ..utils.precision import complex_dtype
from .params import GaugeParam, InvertParam

log = logging.getLogger("quda_tpu_torch")

_ctx = {
    "initialized": False,
    "device": None,
    "geom": None,
    "gauge": None,          # resident gauge (4,T,Z,Y,X,3,3) on the device
    "gauge_param": None,
    "warned": set(),        # one-time warning keys of this session
}


def init_quda(device="cuda"):
    """initQuda analog: pick the device every later call runs on.  The
    default is the card; with none present this raises unless the caller
    passes ``device='cpu'``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    _ctx.update(initialized=True, device=dev, geom=None, gauge=None,
                gauge_param=None, warned=set())
    log.debug("initialized on %s", dev)


def end_quda():
    _ctx.update(initialized=False, device=None, geom=None, gauge=None,
                gauge_param=None, warned=set())


def _require_init():
    if not _ctx["initialized"]:
        raise RuntimeError("call init_quda() first")


def load_gauge_quda(gauge, param: GaugeParam):
    """loadGaugeQuda: host layout (4,T,Z,Y,X,3,3) — a numpy array or a
    tensor — to the resident gauge on the session's device."""
    _require_init()
    param.validate()
    geom = LatticeGeometry(tuple(param.X))
    dtype = complex_dtype(param.cuda_prec)
    dev = _ctx["device"]
    if isinstance(gauge, torch.Tensor):
        g = gauge.to(device=dev, dtype=dtype)
    else:
        g = gauge_from_host(gauge, dev, dtype)
    if tuple(g.shape) != geom.gauge_shape():
        raise ValueError(f"gauge shape {tuple(g.shape)} != expected "
                         f"{geom.gauge_shape()} for X={param.X}")
    if not bool(torch.isfinite(torch.view_as_real(g)).all()):
        raise ValueError("load_gauge_quda: non-finite link values in the "
                         "input gauge field — rejected")
    if param.anisotropy != 1.0:
        scale = torch.ones((4, 1, 1, 1, 1, 1, 1), dtype=g.real.dtype,
                           device=dev)
        scale[:3] = 1.0 / param.anisotropy
        g = g * scale
    _ctx.update(geom=geom, gauge=g, gauge_param=param)


def free_gauge_quda():
    _ctx["gauge"] = None


def _antiperiodic() -> bool:
    return _ctx["gauge_param"].t_boundary == "antiperiodic"


def _build_dirac(p: InvertParam, pc: bool, dtype):
    from ..models import clover as mclover
    from ..models import wilson as mwil
    geom = _ctx["geom"]
    g = _ctx["gauge"].to(dtype)
    ap = _antiperiodic()
    matpc = EVEN if p.matpc_type == "even-even" else ODD
    if p.dslash_type == "clover":
        return (mclover.DiracCloverPC(g, geom, p.kappa, p.csw, ap, matpc)
                if pc else mclover.DiracClover(g, geom, p.kappa, p.csw, ap))
    return (mwil.DiracWilsonPC(g, geom, p.kappa, ap, matpc) if pc
            else mwil.DiracWilson(g, geom, p.kappa, ap))


def _resolve_sloppy(param: InvertParam) -> str:
    """cuda_prec_sloppy="auto" -> cuda_prec (the JAX package's non-TPU
    branch; its bf16 default exists only on a TPU)."""
    if param.cuda_prec_sloppy != "auto":
        return param.cuda_prec_sloppy
    return param.cuda_prec


def _link_form() -> str:
    """The packed operators' link form from the resident gauge's
    ``reconstruct``."""
    rec = _ctx["gauge_param"].reconstruct
    if rec == 8:
        raise NotImplementedError(
            "reconstruct 8 is not ported yet (ROADMAP A7/B9); the port "
            "serves 18 and 12")
    return "r12" if rec == 12 else "full"


def _check_route(param: InvertParam, sloppy: str):
    """Raise for every route this port does not serve yet."""
    if param.dslash_type not in ("wilson", "clover"):
        raise NotImplementedError(
            f"dslash_type {param.dslash_type!r} is not ported yet: twisted "
            "mass and twisted clover (ROADMAP A10), staggered/HISQ (A9), "
            "domain wall (A10)")
    if param.inv_type != "cg":
        raise NotImplementedError(
            f"inv_type {param.inv_type!r} is not ported yet (ROADMAP A11)")
    if param.solve_type != "normop-pc":
        raise NotImplementedError(
            f"solve_type {param.solve_type!r}: only normop-pc is ported; "
            "the direct and unpreconditioned routes come with the "
            "remaining solvers (ROADMAP A11)")
    if param.cuda_prec != "single":
        raise NotImplementedError(
            f"cuda_prec {param.cuda_prec!r}: only single is ported; native "
            "f64 against df64 on the card is a later, measured step of "
            "ROADMAP A7")
    if sloppy == "quarter":
        raise NotImplementedError(
            "cuda_prec_sloppy 'quarter' (int8 block-float links) is not "
            "ported yet (ROADMAP A7/B9)")
    if sloppy not in ("single", "half"):
        raise NotImplementedError(
            f"cuda_prec_sloppy {sloppy!r} above cuda_prec 'single' is not "
            "a mixed-precision route (ROADMAP A7)")


def _df64_route(param: InvertParam) -> bool:
    """The deep-tolerance gate (quda_api.py:1135-1147 of the JAX package):
    below tol 5e-8 an f32 precise side cannot certify the residual.
    Wilson only, as in the JAX package (``df64_able``)."""
    return param.dslash_type == "wilson" and param.tol < 5e-8


def _store_dtype(sloppy: str):
    return torch.bfloat16 if sloppy == "half" else torch.float32


def _solve_supervision(param: InvertParam, api: str, converged=None,
                       converged_multi=None) -> None:
    """``param.converged`` (and, for a batch, ``converged_multi``) from
    the solver's own claim; a solve that stops without meeting tol, or a
    batch with a lane that does, warns once per (api, solver) and
    session."""
    if converged_multi is not None:
        param.converged_multi = [bool(c) for c in converged_multi]
        param.converged = all(param.converged_multi)
    else:
        param.converged = bool(converged)
    if param.converged:
        return
    key = f"unconverged:{api}:{param.inv_type}"
    if key in _ctx["warned"]:
        return
    _ctx["warned"].add(key)
    lanes = ""
    if converged_multi is not None:
        lanes = (f"{param.converged_multi.count(False)} of "
                 f"{len(param.converged_multi)} sources: ")
    log.warning(
        "%s[%s/%s]: %ssolve exited without meeting tol %g (achieved "
        "true_res %.2e); InvertParam.converged=False — further "
        "occurrences are flagged silently on the param", api,
        param.dslash_type, param.inv_type, lanes, param.tol,
        param.true_res)


def _invert_wilson_df64(b, param: InvertParam, dpk, sloppy: str,
                        form: str):
    """Deep-tolerance Wilson PC CG with a df64 (float32-pair) precise
    side: 1e-10-class true residuals with no f64 (ops/wilson_df64.py).
    Returns the f32-rounded solution and publishes its low word as
    ``param.x_df64_lo``: x + x_df64_lo is the full-precision solution."""
    from .. import solvers
    from ..ops import df64 as dfm
    from ..ops import wilson_df64 as wdf

    geom = _ctx["geom"]
    op = wdf.WilsonPCDF64(dpk)
    be, bo = even_odd_split(b, geom)
    rhs_df = op.prepare_df(be, bo)
    store = _store_dtype(sloppy)
    sl = dpk.pairs(store, precision_form=form)
    res = solvers.cg_reliable_df(
        op, sl.MdagM_pairs, rhs_df, solvers.pair_inplace_codec(store),
        tol=param.tol, maxiter=param.maxiter, delta=param.reliable_delta)

    xe_df, xo_df = op.reconstruct_df(res.x, be, bo)
    fr2 = float(dfm.to_f32(op.full_residual_norm2(xe_df, xo_df, be, bo)))
    param.true_res = math.sqrt(fr2 / float(blas.norm2_comp(b)))
    xe_hi, xe_lo = op.from_df(xe_df, b.dtype)
    xo_hi, xo_lo = op.from_df(xo_df, b.dtype)
    param.x_df64_lo = even_odd_join(xe_lo, xo_lo, geom)
    return even_odd_join(xe_hi, xo_hi, geom), res


def invert_quda(source, param: InvertParam):
    """invertQuda: solve M x = b; returns x (T,Z,Y,X,4,3) on the session's
    device and fills param.true_res, iter_count, secs, gflops, converged
    and reliable_updates (and x_df64_lo on the df64 route)."""
    from .. import solvers

    _require_init()
    param.validate()
    if _ctx["gauge"] is None:
        raise RuntimeError("load_gauge_quda() first")
    sloppy = _resolve_sloppy(param)
    _check_route(param, sloppy)
    form = _link_form()
    dev = _ctx["device"]
    geom = _ctx["geom"]
    dtype = complex_dtype(param.cuda_prec)
    if isinstance(source, torch.Tensor):
        b = source.to(device=dev, dtype=dtype)
    else:
        b = spinor_from_host(source, dev, dtype)
    if tuple(b.shape) != geom.spinor_shape():
        raise ValueError(f"source shape {tuple(b.shape)} != "
                         f"{geom.spinor_shape()}")
    t0 = time.perf_counter()
    param.x_df64_lo = None

    # ``dirac.pairs`` builds every pair operator of the solve, for each
    # family: DiracWilsonPCPacked -> the eo hop kernel, DiracCloverPC ->
    # the fused clover hop
    dirac = _build_dirac(param, True, dtype)
    if param.dslash_type == "wilson":
        dirac = dirac.packed()
    # normal equations: MdagM x = Mdag b, two M applies per iteration
    mv_applies = 2.0
    if _df64_route(param):
        x_full, res = _invert_wilson_df64(b, param, dirac, sloppy, form)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        param.secs = time.perf_counter() - t0
    else:
        op = dirac.pairs(torch.float32, precision_form=form)
        be, bo = even_odd_split(b, geom)
        sys_rhs = op.Mdag_pairs(op.prepare_pairs(be, bo))
        if sloppy == param.cuda_prec:
            res = solvers.create(param.inv_type)(
                op.MdagM_pairs, sys_rhs, tol=param.tol,
                maxiter=param.maxiter, tol_hq=param.tol_hq)
        else:
            store = _store_dtype(sloppy)
            sl = dirac.pairs(store, precision_form=form)
            res = solvers.cg_reliable(
                op.MdagM_pairs, sl.MdagM_pairs, sys_rhs,
                solvers.pair_inplace_codec(store), tol=param.tol,
                maxiter=param.maxiter, delta=param.reliable_delta)
        xe, xo = op.reconstruct_pairs(res.x, be, bo)
        x_full = even_odd_join(xe, xo, geom)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        param.secs = time.perf_counter() - t0
        r = b - _build_dirac(param, False, dtype).M(x_full)
        param.true_res = math.sqrt(float(blas.norm2(r))
                                   / float(blas.norm2(b)))
    param.iter_count = int(res.iters)
    param.reliable_updates = int(res.reliable_updates)
    # flops_per_site_M counts per UPDATED site, and the PC operator
    # updates one parity: volume/2 sites
    sites = geom.volume // 2
    param.gflops = (param.iter_count * mv_applies
                    * dirac.flops_per_site_M() * sites) / 1e9
    _solve_supervision(param, "invert_quda", res.converged)
    log.info("invert_quda[%s/%s]: %d iters, true_res %.2e, %.2f s",
             param.dslash_type, param.inv_type, param.iter_count,
             param.true_res, param.secs)
    return x_full


def _split_batch(B, geom):
    """(N,T,Z,Y,X,4,3) -> (even, odd) (N,T,Z,Y,Xh,4,3) batches."""
    e, o = even_odd_split(B.movedim(0, 4), geom)
    return e.movedim(4, 0), o.movedim(4, 0)


def _join_batch(even, odd, geom):
    return even_odd_join(even.movedim(0, 4), odd.movedim(0, 4),
                         geom).movedim(4, 0)


def invert_multi_src_quda(sources, param: InvertParam):
    """invertMultiSrcQuda: solve M x_i = b_i for a batch of sources
    (N,T,Z,Y,X,4,3) on the resident gauge; returns the (N,...) solutions
    on the session's device.  Fills ``true_res_multi``,
    ``iter_count_multi`` and ``converged_multi`` per source,
    ``iter_count`` (their sum), ``true_res`` (the worst, NaN if any lane
    is NaN), ``converged`` (all lanes), ``secs`` and ``gflops`` (each
    source charged its own iterations).

    Routes, as the JAX package's (quda_api.py:1503-1820):

    * batched: dslash_type "wilson" or "clover", solve_type
      "normop-pc", inv_type in the CG family, cuda_prec "single",
      tol >= 5e-8.  Every iterate is an f32 pair batch (N,4,3,2,T,Z,Y*Xh)
      on the float32 pair operator, links full or recon-12 as
      ``GaugeParam.reconstruct`` says, whatever ``cuda_prec_sloppy`` says
      (it is ignored here, as in the JAX package).  CGNR, 2 M applies per
      iteration: ``batched_cg_pairs`` (independent lanes), or with
      QUDA_TORCH_MULTI_SRC_BLOCK=1 ``block_cg_pairs`` (one shared Krylov
      space).  Every hop is one launch of a multi-RHS kernel: B5-eo for
      Wilson, K1/K2-mrhs for clover.
    * per-source: everything else loops over ``invert_quda`` (so tol <
      5e-8 Wilson reaches the df64 route per source, and stacks its low
      words into ``param.x_df64_lo``); what ``invert_quda`` does not
      serve raises there.
    * split grid (QUDA_TORCH_MULTI_SRC_SPLIT=1): multi-device, ROADMAP
      A15; forcing it raises ValueError until then.

    Each lane's true residual is recomputed with the full-lattice complex
    operator, built once per call.  ``secs`` ends when the solutions
    are ready, before that check."""
    _require_init()
    param.validate()
    if _ctx["gauge"] is None:
        raise RuntimeError("load_gauge_quda() first")
    geom = _ctx["geom"]
    dtype = complex_dtype(param.cuda_prec)
    if isinstance(sources, torch.Tensor):
        B = sources.to(device=_ctx["device"], dtype=dtype)
    else:
        B = spinor_from_host(sources, _ctx["device"], dtype)
    if B.ndim != 7 or tuple(B.shape[1:]) != geom.spinor_shape():
        raise ValueError(f"sources of shape {tuple(B.shape)}: expected "
                         f"(N,) + {geom.spinor_shape()}")
    return _invert_multi_src_body(B, param)


def _invert_multi_src_body(B, param: InvertParam):
    from .. import solvers
    from ..parallel.split import multi_src_route
    from ..solvers.block import _check_nrhs
    from ..utils import config

    n_src = B.shape[0]
    _check_nrhs(n_src)
    t0 = time.perf_counter()
    pc = param.solve_type.endswith("-pc")
    cg_family = param.inv_type in ("cg", "pcg", "cgnr", "cgne")
    # f32 pairs cannot certify tolerances below the f32 floor: deep-tol
    # batches take the per-source route, whose invert_quda engages df64
    tol_ok = param.tol >= 5e-8
    batched_able = (pc and param.dslash_type in ("wilson", "clover")
                    and cg_family and tol_ok and param.cuda_prec == "single")
    route, _, _ = multi_src_route(
        n_src, split_mode=config.get("QUDA_TORCH_MULTI_SRC_SPLIT"),
        split_gate=(pc and param.dslash_type == "wilson" and cg_family
                    and tol_ok),
        batched_gate=batched_able)
    param.x_df64_lo = None
    param.reliable_updates = 0

    if route == "per_source":
        xs, lows = [], []
        iters, res_rhs, conv, gflops = [], [], [], 0.0
        for i in range(n_src):
            p_i = copy.copy(param)
            xs.append(invert_quda(B[i], p_i))
            iters.append(p_i.iter_count)
            res_rhs.append(p_i.true_res)
            conv.append(p_i.converged)
            gflops += p_i.gflops
            lows.append(p_i.x_df64_lo)
            param.reliable_updates += p_i.reliable_updates
        x_full = torch.stack(xs)
        if all(lo is not None for lo in lows):
            param.x_df64_lo = torch.stack(lows)
        param.secs = time.perf_counter() - t0
    else:
        geom = _ctx["geom"]
        dev = _ctx["device"]
        form = _link_form()
        dirac = _build_dirac(param, True, B.dtype)
        if param.dslash_type == "wilson":
            dirac = dirac.packed()
        op = dirac.pairs(torch.float32, precision_form=form)
        be, bo = _split_batch(B, geom)
        # CGNR on the batched normal equations: MdagM x = Mdag b
        sys_rhs = op.Mdag_pairs_mrhs(op.prepare_pairs_mrhs(be, bo))
        if config.get("QUDA_TORCH_MULTI_SRC_BLOCK") == "1":
            res = solvers.block_cg_pairs(op.MdagM_pairs_mrhs, sys_rhs,
                                         tol=param.tol,
                                         maxiter=param.maxiter)
            iters = [int(res.iters)] * n_src
        else:
            res = solvers.batched_cg_pairs(op.MdagM_pairs_mrhs, sys_rhs,
                                           tol=param.tol,
                                           maxiter=param.maxiter)
            iters = [int(i) for i in res.iters]
        conv = [bool(c) for c in res.converged]
        x_full = _join_batch(*op.reconstruct_pairs_mrhs(res.x, be, bo), geom)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        param.secs = time.perf_counter() - t0
        d_chk = _build_dirac(param, False, B.dtype)
        res_rhs = [math.sqrt(float(blas.norm2(B[i] - d_chk.M(x_full[i])))
                             / float(blas.norm2(B[i])))
                   for i in range(n_src)]
        # per UPDATED site (volume/2) and M apply, 2 applies per iteration;
        # each source is charged its own converged iterations
        gflops = (sum(iters) * 2.0 * dirac.flops_per_site_M()
                  * (geom.volume // 2)) / 1e9
    param.iter_count_multi = [int(i) for i in iters]
    param.true_res_multi = [float(r) for r in res_rhs]
    param.iter_count = sum(param.iter_count_multi)
    # max that propagates a NaN lane, as np.max does
    param.true_res = float(torch.tensor(param.true_res_multi,
                                        dtype=torch.float64).max())
    param.gflops = gflops
    _solve_supervision(param, "invert_multi_src_quda", converged_multi=conv)
    log.info("invert_multi_src_quda[%s/%s] (%s): %d sources, iters %s, "
             "worst true_res %.2e, %.2f s", param.dslash_type,
             param.inv_type, route, n_src, param.iter_count_multi,
             param.true_res, param.secs)
    return x_full
