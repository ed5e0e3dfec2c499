"""Public entry points: init_quda / load_gauge_quda / invert_quda / end_quda,
compute_ks_link_quda / load_fat_long_quda / invert_multishift_quda.

Port of the Wilson, Wilson-clover, twisted, domain-wall and staggered
even/odd CG paths of quda_tpu/interfaces/quda_api.py.  ``invert_quda``
serves dslash_type="wilson", "clover", "twisted-mass", "twisted-clover",
"ndeg-twisted-mass", "ndeg-twisted-clover", "mobius", "domain-wall-4d",
"domain-wall" (5d-checkerboard PC) and "mobius-eofa" (solve_type
"normop-pc") and "staggered", "asqtad" and "hisq" (solve_type
"normop-pc" or "direct-pc"), inv_type="cg", with cuda_prec="single" (and
"double" for Wilson), on the packed pair representation (the float32,
bfloat16 and float64 pair operators that ``pairs`` builds, the same way
for every family):

* sloppy = single: ``fused_cg`` on the float32 pair operator (every hop
  on the eo kernel; for clover and the degenerate twisted operators on
  the fused hop with its clover or twist epilogue; for the domain-wall
  family on the multi-RHS hop with Ls as the batch; the CG tail on the
  fused tail kernel);
* sloppy = half: ``cg_reliable`` with a bfloat16 sloppy operator and
  reliable updates on the float32 one (not the domain-wall family: its
  hop has float32 forms only, ROADMAP A7/B5);
* Wilson only, sloppy = quarter (QUDA's quarter precision): the sloppy
  operator is ``pairs(bfloat16, precision_form="int8")``, int8
  block-float links with bf16 spinors on the int8 eo hop, under
  ``cg_reliable`` with the float32 operator at the gauge's
  ``reconstruct`` (or, below tol 5e-8, under the df64 route).  This is
  the operator the JAX package's df64 route builds for quarter: links
  quantised from the bf16-rounded pairs and decoded in float32.  Its
  tol >= 5e-8 route is the JAX package's canonical int8 codec instead
  (links quantised from complex64, each decoded link rounded to bf16),
  so the two are compared at the solve's tolerance, not bit for bit.
  The other families' quarter (the JAX package runs them on bf16
  links) waits for ROADMAP A7;
* Wilson at cuda_prec="double" (native f64, as the JAX package's CPU
  route): sloppy double runs ``fused_cg`` on the float64 pair operator
  (B1 and B2 in f64), sloppy single ``cg_reliable`` with the float32 pair
  operator as sloppy and the float64 one for the reliable updates;
* Wilson only, cuda_prec="single", tol < 5e-8, sloppy single or half:
  the df64 route,
  ``cg_reliable_df`` against a float32-pair precise operator
  (``_invert_wilson_df64``), which publishes ``param.x_df64_lo``.  As in
  the JAX package the gate is Wilson-only: a clover solve below 5e-8
  takes its float32 route; ``converged`` is the solver's own claim, as
  there, and ``true_res`` says how far the float32 solve got.

Sources and solutions are (T,Z,Y,X,4,3), (T,Z,Y,X,2,4,3) for the
flavour doublets and (Ls,T,Z,Y,X,4,3) for the domain-wall family.

The staggered PC operator 4m^2 - D_pq D_qp is Hermitian positive
definite, so its CG runs on ``M_pairs`` itself (one apply per
iteration, no normal equations), on the fused fat + Naik hop kernel S1
(asqtad, hisq: the fat and long links of ``compute_ks_link_quda`` or
``load_fat_long_quda``) or the gather pass S2 (fat-only "staggered":
the gauge links are the fat links).  ``invert_multishift_quda`` runs
``multishift_cg`` on the same float32 pair operator.

Links are full or recon-12 (``GaugeParam.reconstruct`` 18 or 12; the
staggered family takes 18 only, ROADMAP C).  The epilogue checks the
true residual of M x = b with the full-lattice complex operator
(ops/wilson.py, models/clover.py, models/staggered.py), which no kernel
touches; the df64 route reports its df64 full-lattice residual.
Every other route raises ``NotImplementedError`` naming the ROADMAP item
that will bring it.

``dslash_quda``, ``mat_quda`` and ``mat_dag_mat_quda`` apply the
operator of ``dslash_type`` to canonical complex fields, as the JAX
package's do.  The PC hop of ``dslash_quda`` is the Wilson eo hop on B1
for Wilson, clover, twisted mass and twisted clover (their PC D_to is
the bare hop).  M and M^dag M: Wilson on the full-lattice hop B4 (one
launch an M), in float32 (cuda_prec "single") or float64 ("double");
clover and twisted clover on the full-lattice clover operator (B7 full,
one launch an M; single only, double waits for ROADMAP A7 as their
``invert_quda`` does); twisted mass on B4 plus the twist (single and
double).  The flavour doublets and the domain-wall family run their
complex operators (complex64 or complex128) as the JAX package does; a
PC operator without a PC hop (the 4d-PC Möbius and EOFA operators) has
no ``dslash_quda`` there either, and raises here.  For the staggered
family (single only; double waits for ROADMAP A7) the eo hop runs on S1
(asqtad, hisq) or S2 (fat-only), M = 2m + D and M^dag M on S1-full or
S2-full.  ``laplace`` waits for ROADMAP A14.

``invert_quda(inv_type="gcr-mg")`` solves the full Wilson or staggered
(staggered, asqtad, hisq) system at cuda_prec "single" with flexible GCR
preconditioned by the pair multigrid V-cycle (mg/pair.py).  Wilson: the
fine operator on the full-lattice hop B4, the set-up's null-vector block
solve on its multi-RHS form B5.  Staggered: the fat-link hierarchy's fine
operator on S2-full and S2-mrhs-full; for asqtad/hisq the outer GCR
applies the fat + Naik operator on S1-full (defect correction of the
Naik term).  Every coarse operator runs on the coarse stencil B8.  The
hierarchy is resident: ``new_multigrid_quda`` builds it, ``invert_quda``
reuses it, and rebuilds it once the gauge, the fat/long links or the
family has changed since its set-up.  Clover and the other families,
double precision, and the Kaehler-Dirac composition raise, naming
ROADMAP A12.  ``plaq_quda`` returns the resident gauge's plaquette.

``invert_multi_src_quda`` solves N sources on one gauge field.  Wilson,
clover, twisted-mass, twisted-clover and staggered-family PC CG-family
solves at cuda_prec="single" and tol >= 5e-8 take the batched pair route:
every Krylov iterate is an (N,4,3,2,T,Z,Y*Xh) (staggered
(N,3,2,T,Z,Y*Xh)) batch and every hop one launch of a multi-RHS kernel
(B5-eo, B7-mrhs, S2-mrhs).  Every other request, the flavour doublets and
the domain-wall family included, loops over ``invert_quda``.

Resident state (device, geometry, gauge, multigrid) lives in a module-level
context, as interface_quda.cpp keeps it, between ``init_quda`` and
``end_quda``.
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
from .params import GaugeParam, InvertParam, MultigridParamAPI

log = logging.getLogger("quda_tpu_torch")

_ctx = {
    "initialized": False,
    "device": None,
    "geom": None,
    "gauge": None,          # resident gauge (4,T,Z,Y,X,3,3) on the device
    "gauge_param": None,
    "fat": None,            # resident staggered fat links (4,T,Z,Y,X,3,3)
    "long": None,           # resident staggered long (Naik) links
    "warned": set(),        # one-time warning keys of this session
    "gauge_epoch": 0,       # counts gauge loads: a hierarchy's gauge
    "links_epoch": 0,       # counts fat/long loads: an improved hierarchy's
    "mg": None,             # resident multigrid hierarchy (mg/pair.PairMG)
    "mg_epoch": None,       # _mg_key of the operator it was built on
    "mg_param": None,       # the MultigridParamAPI it was built with
}

STAGGERED_TYPES = ("staggered", "asqtad", "hisq")
TWISTED_TYPES = ("twisted-mass", "twisted-clover")
NDEG_TYPES = ("ndeg-twisted-mass", "ndeg-twisted-clover")
DWF_TYPES = ("domain-wall", "domain-wall-4d", "mobius", "mobius-eofa")
# the PC families whose CG runs the normal equations of a pair operator
SCHUR_TYPES = ("wilson", "clover") + TWISTED_TYPES + NDEG_TYPES + DWF_TYPES


def init_quda(device="cuda"):
    """initQuda analog: pick the device every later call runs on and load
    the tuner's persistent cache (utils/tune.warm_start).  The default is
    the card; with none present this raises unless the caller passes
    ``device='cpu'``."""
    from ..utils import tune
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    _ctx.update(initialized=True, device=dev, geom=None, gauge=None,
                gauge_param=None, fat=None, long=None, warned=set(),
                mg=None, mg_epoch=None, mg_param=None)
    usable = tune.warm_start()
    log.debug("initialized on %s (tuner cache: %d entries usable here)",
              dev, usable)


def end_quda():
    _ctx.update(initialized=False, device=None, geom=None, gauge=None,
                gauge_param=None, fat=None, long=None, warned=set(),
                mg=None, mg_epoch=None, mg_param=None)


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
    _ctx.update(geom=geom, gauge=g, gauge_param=param,
                gauge_epoch=_ctx["gauge_epoch"] + 1)


def free_gauge_quda():
    _ctx["gauge"] = None


def compute_ks_link_quda(naik_eps: float = 0.0):
    """computeKSLinkQuda: HISQ-fatten the resident gauge (fat7, U(3)
    reunitarisation, level-2 fat links and Naik links, gauge/hisq.py) in
    its precision, and keep the fat and long links resident for the
    asqtad/hisq inverts.  Returns the ``HisqLinks``."""
    from ..gauge.hisq import hisq_fattening
    _require_init()
    if _ctx["gauge"] is None:
        raise RuntimeError("load_gauge_quda() first")
    links = hisq_fattening(_ctx["gauge"], naik_eps)
    _ctx["fat"] = links.fat
    _ctx["long"] = links.long
    _ctx["links_epoch"] += 1
    return links


def load_fat_long_quda(fat, long_links):
    """Make (fat, long) links (4,T,Z,Y,X,3,3), numpy (for instance the
    JAX package's HisqLinks) or tensors, the resident staggered links,
    in the resident gauge's precision."""
    from ..utils.convert import fat_long_from_host
    _require_init()
    dev = _ctx["device"]
    dtype = _ctx["gauge"].dtype if _ctx["gauge"] is not None else None
    if isinstance(fat, torch.Tensor) and isinstance(long_links,
                                                   torch.Tensor):
        f = fat.to(device=dev, dtype=dtype or fat.dtype)
        lg = long_links.to(device=dev, dtype=dtype or long_links.dtype)
    else:
        f, lg = fat_long_from_host(fat, long_links, dev, dtype)
    if tuple(f.shape) != tuple(lg.shape) or f.ndim != 7 or f.shape[0] != 4:
        raise ValueError(f"fat {tuple(f.shape)} and long "
                         f"{tuple(lg.shape)}: expected two "
                         "(4,T,Z,Y,X,3,3) link fields")
    _ctx["fat"], _ctx["long"] = f, lg
    _ctx["links_epoch"] += 1


def _antiperiodic() -> bool:
    return _ctx["gauge_param"].t_boundary == "antiperiodic"


def _build_zoo(p: InvertParam, pc: bool, g, geom, ap, matpc):
    """The twisted and domain-wall operators of ``p.dslash_type`` (JAX
    quda_api.py:411-462)."""
    from ..models import domain_wall as mdw
    from ..models import twisted as mtw
    t = p.dslash_type
    if t == "twisted-mass":
        return (mtw.DiracTwistedMassPC(g, geom, p.kappa, p.mu, ap, matpc)
                if pc else mtw.DiracTwistedMass(g, geom, p.kappa, p.mu, ap))
    if t == "twisted-clover":
        return (mtw.DiracTwistedCloverPC(g, geom, p.kappa, p.mu, p.csw, ap,
                                         matpc) if pc
                else mtw.DiracTwistedClover(g, geom, p.kappa, p.mu, p.csw,
                                            ap))
    if t == "ndeg-twisted-mass":
        return (mtw.DiracNdegTwistedMassPC(g, geom, p.kappa, p.mu,
                                           p.epsilon, ap, matpc) if pc
                else mtw.DiracNdegTwistedMass(g, geom, p.kappa, p.mu,
                                              p.epsilon, ap))
    if t == "ndeg-twisted-clover":
        return (mtw.DiracNdegTwistedCloverPC(g, geom, p.kappa, p.mu,
                                             p.epsilon, p.csw, ap, matpc)
                if pc else
                mtw.DiracNdegTwistedClover(g, geom, p.kappa, p.mu, p.epsilon,
                                           p.csw, ap))
    m5 = -p.m5  # QUDA passes m5 negative
    if t == "mobius-eofa":
        kw = dict(mq1=p.eofa_mq1, mq2=p.eofa_mq2, mq3=p.eofa_mq3,
                  eofa_pm=p.eofa_pm, eofa_shift=p.eofa_shift)
        if pc:
            return mdw.DiracMobiusEofaPC(g, geom, p.Ls, m5, p.mass, p.b5,
                                         p.c5, antiperiodic_t=ap,
                                         matpc=matpc, **kw)
        return mdw.DiracMobiusEofa(g, geom, p.Ls, m5, p.mass, p.b5, p.c5,
                                   antiperiodic_t=ap, **kw)
    b5, c5 = (p.b5, p.c5) if t == "mobius" else (1.0, 0.0)
    if not pc:
        return mdw.DiracMobius(g, geom, p.Ls, m5, p.mass, b5, c5, ap)
    if t == "domain-wall":
        # QUDA's plain "domain-wall" preconditions on the 5d checkerboard
        return mdw.DiracDomainWall5DPC(g, geom, p.Ls, m5, p.mass, ap, matpc)
    return mdw.DiracMobiusPC(g, geom, p.Ls, m5, p.mass, b5, c5, ap, matpc)


def _build_dirac(p: InvertParam, pc: bool, dtype):
    from ..models import clover as mclover
    from ..models import wilson as mwil
    geom = _ctx["geom"]
    g = _ctx["gauge"].to(dtype)
    ap = _antiperiodic()
    matpc = EVEN if p.matpc_type == "even-even" else ODD
    if p.dslash_type in TWISTED_TYPES + NDEG_TYPES + DWF_TYPES:
        return _build_zoo(p, pc, g, geom, ap, matpc)
    if p.dslash_type in STAGGERED_TYPES:
        from ..models import staggered as mstag
        improved = p.dslash_type != "staggered"
        fat, lng = g, None
        if improved:
            if _ctx["fat"] is None or _ctx["long"] is None:
                raise RuntimeError(
                    f"dslash_type {p.dslash_type!r} needs "
                    "compute_ks_link_quda() or load_fat_long_quda() first")
            fat, lng = _ctx["fat"].to(dtype), _ctx["long"].to(dtype)
        return (mstag.DiracStaggeredPC(fat, geom, p.mass, improved, lng,
                                       matpc, antiperiodic_t=ap) if pc
                else mstag.DiracStaggered(fat, geom, p.mass, improved, lng,
                                          antiperiodic_t=ap))
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


def _link_form(staggered: bool = False) -> str:
    """The packed operators' link form from the resident gauge's
    ``reconstruct``."""
    rec = _ctx["gauge_param"].reconstruct
    if staggered and rec != 18:
        raise NotImplementedError(
            f"reconstruct {rec} on the staggered family: HISQ/asqtad long "
            "links are -(1+eps)/24 W W W with W a U(3) projection, not "
            "+-SU(3), so a rebuilt row 2 applies a wrong operator "
            "(ROADMAP C); the port serves full (18) staggered links")
    if rec == 8:
        raise NotImplementedError(
            "reconstruct 8 is not ported yet (ROADMAP A7); the port "
            "serves 18 and 12")
    return "r12" if rec == 12 else "full"


def _check_mg_route(param: InvertParam):
    """Raise unless the multigrid route serves ``param``: the pair
    hierarchy, Wilson and the staggered family (staggered, asqtad, hisq;
    full links) at cuda_prec "single" (the JAX package's pair gate,
    ``_mg_pairs_enabled``)."""
    if param.dslash_type not in ("wilson",) + STAGGERED_TYPES:
        raise NotImplementedError(
            f"multigrid for dslash_type {param.dslash_type!r} is not ported "
            "yet (ROADMAP A12: clover and the other families on the "
            "complex hierarchy); the port serves Wilson and the staggered "
            "family")
    if param.dslash_type in STAGGERED_TYPES:
        if param.cuda_prec != "single":
            raise NotImplementedError(
                f"staggered multigrid at cuda_prec {param.cuda_prec!r}: the "
                "pair hierarchy and S1-full/S2-full run in float32; double "
                "needs the complex hierarchy and f64 kernel forms (ROADMAP "
                "A12/A7)")
        _link_form(True)
    if param.cuda_prec != "single":
        raise NotImplementedError(
            f"multigrid at cuda_prec {param.cuda_prec!r}: the pair "
            "hierarchy runs in float32; the JAX package's complex "
            "hierarchy for the other precisions is not ported (ROADMAP "
            "A12)")


def _check_route(param: InvertParam, sloppy: str):
    """Raise for every route this port does not serve yet."""
    if param.inv_type == "gcr-mg":
        _check_mg_route(param)
        return
    if param.dslash_type not in SCHUR_TYPES + STAGGERED_TYPES:
        raise NotImplementedError(
            f"dslash_type {param.dslash_type!r} is not ported yet (ROADMAP "
            "A14: the Laplace operator)")
    if param.inv_type != "cg":
        raise NotImplementedError(
            f"inv_type {param.inv_type!r} is not ported yet (ROADMAP A11; "
            "multi-shift CG through invert_multishift_quda)")
    if param.dslash_type in STAGGERED_TYPES:
        if param.solve_type not in ("normop-pc", "direct-pc"):
            raise NotImplementedError(
                f"solve_type {param.solve_type!r}: the staggered family "
                "serves the Hermitian PC operator (normop-pc, direct-pc); "
                "the unpreconditioned routes come with ROADMAP A11")
    elif param.solve_type != "normop-pc":
        raise NotImplementedError(
            f"solve_type {param.solve_type!r}: only normop-pc is ported; "
            "the direct and unpreconditioned routes come with the "
            "remaining solvers (ROADMAP A11)")
    if param.cuda_prec == "double":
        if param.dslash_type != "wilson" or sloppy not in ("double",
                                                           "single"):
            raise NotImplementedError(
                f"cuda_prec 'double' with dslash_type "
                f"{param.dslash_type!r} and sloppy {sloppy!r}: the native "
                "double route serves Wilson with sloppy double or single; "
                "the clover, staggered and half-sloppy double routes wait "
                "for ROADMAP A7")
        return
    if param.cuda_prec != "single":
        raise NotImplementedError(
            f"cuda_prec {param.cuda_prec!r}: single and (Wilson) double are "
            "ported (ROADMAP A7)")
    if sloppy == "quarter" and param.dslash_type != "wilson":
        raise NotImplementedError(
            f"cuda_prec_sloppy 'quarter' for {param.dslash_type!r}: the int8 "
            "block-float links serve the Wilson hop only; the other "
            "families' quarter (bf16 links in the JAX package) waits for "
            "ROADMAP A7")
    if sloppy not in ("single", "half", "quarter"):
        raise NotImplementedError(
            f"cuda_prec_sloppy {sloppy!r} above cuda_prec 'single' is not "
            "a mixed-precision route (ROADMAP A7)")
    if param.dslash_type in DWF_TYPES and sloppy != "single":
        raise NotImplementedError(
            f"cuda_prec_sloppy {sloppy!r} for {param.dslash_type!r}: the "
            "domain-wall hop runs on B5-eo, whose bf16 forms wait for "
            "ROADMAP A7/B5; the port serves sloppy single")


def _df64_route(param: InvertParam) -> bool:
    """The deep-tolerance gate (quda_api.py:1135-1147 of the JAX package):
    below tol 5e-8 an f32 precise side cannot certify the residual.
    Wilson at cuda_prec "single" only, as in the JAX package
    (``df64_able``): a double solve is native f64."""
    return (param.dslash_type == "wilson" and param.cuda_prec == "single"
            and param.tol < 5e-8)


# the spinor storage of each precision; quarter keeps bf16 spinors on
# int8 block-float links
_STORE = {"quarter": torch.bfloat16, "half": torch.bfloat16,
          "single": torch.float32, "double": torch.float64}


def _store_dtype(sloppy: str):
    return _STORE[sloppy]


def _sloppy_form(sloppy: str, form: str) -> str:
    """The sloppy operator's link form: int8 for quarter (whatever the
    resident ``reconstruct``, as the JAX package passes it), else the
    gauge's."""
    return "int8" if sloppy == "quarter" else form


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
    sl = dpk.pairs(store, precision_form=_sloppy_form(sloppy, form))
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
    """invertQuda: solve M x = b; returns x (T,Z,Y,X,4,3), or
    (T,Z,Y,X,1,3) for the staggered family, on the session's device and
    fills param.true_res, iter_count, secs, gflops, converged and
    reliable_updates (and x_df64_lo on the df64 route)."""
    from .. import solvers

    _require_init()
    param.validate()
    if _ctx["gauge"] is None:
        raise RuntimeError("load_gauge_quda() first")
    sloppy = _resolve_sloppy(param)
    _check_route(param, sloppy)
    if param.inv_type == "gcr-mg":
        return _invert_mg(source, param)
    form = _link_form(param.dslash_type in STAGGERED_TYPES)
    dev = _ctx["device"]
    geom = _ctx["geom"]
    dtype = complex_dtype(param.cuda_prec)
    b = _source_on_device(source, param, dtype)
    t0 = time.perf_counter()
    param.x_df64_lo = None

    # ``dirac.pairs`` builds every pair operator of the solve, for each
    # family: DiracWilsonPCPacked -> the eo hop kernel, DiracCloverPC ->
    # the fused clover hop, DiracStaggeredPC -> the staggered hops
    dirac = _build_dirac(param, True, dtype)
    if param.dslash_type == "wilson":
        dirac = dirac.packed()
    # normal equations: MdagM x = Mdag b, two M applies per iteration;
    # the Hermitian staggered PC operator is solved directly, one apply
    hermitian = getattr(dirac, "hermitian", False)
    mv_applies = 1.0 if hermitian else 2.0
    if _df64_route(param):
        x_full, res = _invert_wilson_df64(b, param, dirac, sloppy, form)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        param.secs = time.perf_counter() - t0
    else:
        op = dirac.pairs(_store_dtype(param.cuda_prec), precision_form=form)
        be, bo = _split(b, param, op)
        rhs = op.prepare_pairs(be, bo)
        sys_rhs = rhs if hermitian else op.Mdag_pairs(rhs)

        def system(o):
            return o.M_pairs if hermitian else o.MdagM_pairs

        if sloppy == param.cuda_prec:
            res = solvers.create(param.inv_type)(
                system(op), sys_rhs, tol=param.tol,
                maxiter=param.maxiter, tol_hq=param.tol_hq)
        else:
            store = _store_dtype(sloppy)
            sl = dirac.pairs(store, precision_form=_sloppy_form(sloppy, form))
            res = solvers.cg_reliable(
                system(op), system(sl), sys_rhs,
                solvers.pair_inplace_codec(store, op.store_dtype),
                tol=param.tol, maxiter=param.maxiter,
                delta=param.reliable_delta)
        xe, xo = op.reconstruct_pairs(res.x, be, bo)
        x_full = _join(xe, xo, param, op)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        param.secs = time.perf_counter() - t0
        r = b - _build_dirac(param, False, dtype).M(x_full)
        param.true_res = math.sqrt(float(blas.norm2(r))
                                   / float(blas.norm2(b)))
    param.iter_count = int(res.iters)
    param.reliable_updates = int(res.reliable_updates)
    param.gflops = (param.iter_count * mv_applies
                    * dirac.flops_per_site_M() * _pc_sites(dirac)) / 1e9
    _solve_supervision(param, "invert_quda", res.converged)
    log.info("invert_quda[%s/%s]: %d iters, true_res %.2e, %.2f s",
             param.dslash_type, param.inv_type, param.iter_count,
             param.true_res, param.secs)
    return x_full


# -- multigrid -------------------------------------------------------------

# (smoother, null-vector solver) of every level, by family: MR smoothing
# stalls on the near anti-Hermitian staggered operator (its real
# minimal-residual step is 2m |r|^2 / |M r|^2), and BiCGStab breaks down on
# it; GCR smoothing and CG on the normal equations do not (PERF.md)
_MG_SOLVERS = {"wilson": ("mr", "bicgstab"), "staggered": ("ca-gcr", "cg")}


def _mg_level_params(mp: MultigridParamAPI, dslash_type: str = "wilson"):
    """MultigridParamAPI -> the per-level MGLevelParam list (JAX
    quda_api.py:1840), the smoother and set-up solver by family
    (``_MG_SOLVERS``)."""
    from ..mg.mg import MGLevelParam
    smoother, setup_solver = _MG_SOLVERS[
        "staggered" if dslash_type in STAGGERED_TYPES else "wilson"]
    return [MGLevelParam(block=tuple(mp.geo_block_size[i]),
                         n_vec=mp.n_vec[i],
                         setup_iters=mp.setup_iters[i]
                         if i < len(mp.setup_iters) else 150,
                         setup_tol=mp.setup_tol[i]
                         if i < len(mp.setup_tol) else 5e-6,
                         pre_smooth=mp.nu_pre[i] if i < len(mp.nu_pre)
                         else 0,
                         post_smooth=mp.nu_post[i] if i < len(mp.nu_post)
                         else 4,
                         smoother_omega=mp.smoother_omega,
                         coarse_solver_iters=mp.coarse_solver_iters,
                         smoother=smoother, setup_solver=setup_solver)
            for i in range(mp.n_level - 1)]


def _build_mg(invert_param: InvertParam, mg_param: MultigridParamAPI):
    """Set up the pair hierarchy of the resident gauge and make it
    resident."""
    from ..mg.pair import PairMG
    _check_mg_route(invert_param)
    d = _build_dirac(invert_param, False, complex_dtype("single"))
    mg = PairMG(d, _ctx["geom"],
                _mg_level_params(mg_param, invert_param.dslash_type))
    _ctx.update(mg=mg, mg_epoch=_mg_key(invert_param), mg_param=mg_param)
    return mg


def _mg_key(param: InvertParam):
    """What a hierarchy was built on: the operator family (Wilson,
    fat-only staggered on the gauge, improved staggered on the fat/long
    links) and the loads of those links since ``init_quda``."""
    t = param.dslash_type
    if t in ("asqtad", "hisq"):
        return ("improved", _ctx["gauge_epoch"], _ctx["links_epoch"])
    return (t, _ctx["gauge_epoch"])


def new_multigrid_quda(mg_param: MultigridParamAPI,
                       invert_param: InvertParam):
    """newMultigridQuda: set up the multigrid hierarchy of the resident
    gauge for ``invert_param``'s operator and keep it resident for the
    ``gcr-mg`` solves.  Returns the hierarchy (mg/pair.PairMG): its
    ``setup_breakdown`` holds the seconds of each (level, phase), and
    ``verify()`` checks it."""
    _require_init()
    mg_param.validate()
    invert_param.validate()
    if _ctx["gauge"] is None:
        raise RuntimeError("load_gauge_quda() first")
    return _build_mg(invert_param, mg_param)


def update_multigrid_quda(mg_param: MultigridParamAPI,
                          invert_param: InvertParam):
    """updateMultigridQuda: set the hierarchy up again on the resident
    gauge (after a new configuration is loaded)."""
    _require_init()
    _ctx["mg"] = None
    return new_multigrid_quda(mg_param, invert_param)


def destroy_multigrid_quda():
    _ctx.update(mg=None, mg_epoch=None, mg_param=None)


def _invert_mg(source, param: InvertParam):
    """The gcr-mg route: flexible GCR(gcrNkrylov) on the full system of
    ``param`` in float32 pairs (Wilson M = 1 - kappa D, staggered M = 2m +
    D with the fat + Naik D for asqtad/hisq), preconditioned by the
    resident hierarchy.  A hierarchy built on another gauge, other
    fat/long links or another family is set up again, as the JAX package
    does (quda_api.py:1880-1888); where the JAX package then takes the
    default MultigridParamAPI, the port takes the one the stale hierarchy
    was built with.  A hierarchy built at another kappa or mass stays, as
    QUDA keeps it: only as the preconditioner, the outer GCR applying
    ``param``'s operator (the JAX package solves the hierarchy's own
    system then).  The true residual is computed in pair arithmetic
    against the operator the outer GCR applies (JAX
    quda_api.py:1912-1916: the fat + Naik operator for improved
    staggered)."""
    from ..mg.pair import PairMG, mg_solve_pairs, outer_operator
    from ..ops.pair import to_pairs
    dev = _ctx["device"]
    geom = _ctx["geom"]
    b = _source_on_device(source, param, complex_dtype("single"))
    t0 = time.perf_counter()
    mg = _ctx["mg"]
    if mg is not None and _ctx["mg_epoch"] != _mg_key(param):
        log.info("gauge, links or family changed since the MG set-up; "
                 "rebuilding the hierarchy")
        mg = None
    if mg is None:
        mg = _build_mg(param, _ctx["mg_param"] or MultigridParamAPI())
    outer = mg.adapter
    stag = param.dslash_type in STAGGERED_TYPES
    if float(param.mass if stag else param.kappa) != (
            outer.mass if stag else outer.kappa):
        outer = PairMG._adapt(_build_dirac(param, False,
                                           complex_dtype("single")))
    b_pairs = to_pairs(b, torch.float32)
    res, _ = mg_solve_pairs(outer, geom, b_pairs, mg.params,
                            tol=param.tol, nkrylov=param.gcrNkrylov, mg=mg)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    param.secs = time.perf_counter() - t0
    r = b_pairs - outer_operator(outer)(res.x)
    param.true_res = math.sqrt(float(blas.norm2(r))
                               / float(blas.norm2(b_pairs)))
    param.iter_count = int(res.iters)
    param.reliable_updates = 0
    param.x_df64_lo = None
    # fine-operator work of the outer solve only (V-cycle work not
    # charged, QUDA's convention for the outer solver's gflops)
    param.gflops = (param.iter_count * outer.dirac.flops_per_site_M()
                    * geom.volume) / 1e9
    _solve_supervision(param, "invert_quda", res.converged)
    log.info("invert_quda[%s/gcr-mg]: %d iters, true_res %.2e, %.2f s",
             param.dslash_type, param.iter_count, param.true_res,
             param.secs)
    return torch.view_as_complex(res.x.contiguous()).to(b.dtype)


def plaq_quda():
    """plaqQuda: (mean, spatial, temporal) plaquette of the resident
    gauge, Re tr P / 3, as floats."""
    from ..gauge.observables import plaquette
    _require_init()
    if _ctx["gauge"] is None:
        raise RuntimeError("load_gauge_quda() first")
    m, s, t = plaquette(_ctx["gauge"])
    return float(m), float(s), float(t)


def _pc_sites(dirac) -> int:
    """The sites a PC operator updates, which flops_per_site_M counts
    per: one parity, volume/2 (times Ls for a 5d operator)."""
    return _ctx["geom"].volume // 2 * getattr(dirac, "ls", 1)


def _source_shape(param: InvertParam):
    """A source's shape: (T,Z,Y,X,4,3); (T,Z,Y,X,1,3) for the staggered
    family, (T,Z,Y,X,2,4,3) for the flavour doublets and
    (Ls,T,Z,Y,X,4,3) for the domain-wall family."""
    lat = tuple(_ctx["geom"].lattice_shape)
    t = param.dslash_type
    if t in STAGGERED_TYPES:
        return lat + (1, 3)
    if t in NDEG_TYPES:
        return lat + (2, 4, 3)
    if t in DWF_TYPES:
        return (int(param.Ls),) + lat + (4, 3)
    return lat + (4, 3)


def _source_on_device(source, param: InvertParam, dtype, shape=None):
    """The source (a numpy array or a tensor) on the session's device,
    checked against ``shape`` (default ``_source_shape(param)``)."""
    dev = _ctx["device"]
    want = tuple(shape or _source_shape(param))
    if isinstance(source, torch.Tensor):
        b = source.to(device=dev, dtype=dtype)
    else:
        b = spinor_from_host(source, dev, dtype, want[-2])
    if tuple(b.shape) != want:
        raise ValueError(f"source shape {tuple(b.shape)} != {want}")
    return b


def _split(b, param: InvertParam, op):
    """Full-lattice source(s) -> (even, odd) halves: the 5d checkerboard's
    slice-aligned split where the operator has one, the 4d split of
    every s slice for the domain-wall family."""
    geom = _ctx["geom"]
    if hasattr(op, "split5"):
        return op.split5(b)
    if param.dslash_type in DWF_TYPES:
        return _split_batch(b, geom)
    return even_odd_split(b, geom)


def _join(xe, xo, param: InvertParam, op):
    geom = _ctx["geom"]
    if hasattr(op, "join5"):
        return op.join5(xe, xo)
    if param.dslash_type in DWF_TYPES:
        return _join_batch(xe, xo, geom)
    return even_odd_join(xe, xo, geom)


def invert_multishift_quda(source, param: InvertParam):
    """invertMultiShiftQuda: (M_pc + offset_i) x_i = rhs for every
    ``param.offset`` at once, on the staggered family's Hermitian PC
    operator (the RHMC rational-force solve), rhs = 2m b_p - D_pq b_q.
    Returns the ``num_offset`` parity-p solutions stacked,
    (n, T,Z,Y,Xh,1,3), as the JAX route does.

    ``multishift_cg`` runs on the float32 pair operator (the fused hop
    S1, or S2 for fat-only), whatever ``cuda_prec_sloppy`` says, as in
    the JAX package.  Fills ``iter_count``, ``secs``, ``gflops``,
    ``converged_multi`` (per shift), ``converged`` (all) and
    ``true_res``: the pair-space residual of the base (first) shift,
    |rhs - (M_pc + offset_0) x_0| / |rhs|."""
    from .. import solvers

    _require_init()
    param.validate()
    if _ctx["gauge"] is None:
        raise RuntimeError("load_gauge_quda() first")
    if param.dslash_type not in STAGGERED_TYPES:
        raise NotImplementedError(
            f"invert_multishift_quda for dslash_type "
            f"{param.dslash_type!r} is not ported yet (ROADMAP A18: "
            "Wilson and clover multishift); the port serves the "
            f"staggered family {STAGGERED_TYPES}")
    if param.inv_type not in ("cg", "multi-shift-cg"):
        raise NotImplementedError(
            f"inv_type {param.inv_type!r}: invert_multishift_quda runs "
            "multi-shift CG")
    if param.cuda_prec != "single":
        raise NotImplementedError(
            f"cuda_prec {param.cuda_prec!r}: only single is ported "
            "(ROADMAP A7)")
    _refuse_quarter(param, "invert_multishift_quda")
    if param.num_offset < 1:
        raise ValueError("invert_multishift_quda needs num_offset >= 1 "
                         "shifts in param.offset")
    form = _link_form(True)
    dev = _ctx["device"]
    geom = _ctx["geom"]
    dtype = complex_dtype(param.cuda_prec)
    b = _source_on_device(source, param, dtype)
    t0 = time.perf_counter()
    dirac = _build_dirac(param, True, dtype)
    op = dirac.pairs(torch.float32, precision_form=form)
    be, bo = even_odd_split(b, geom)
    rhs = op.prepare_pairs(be, bo)
    offsets = tuple(float(o) for o in param.offset)
    res = solvers.multishift_cg(op.M_pairs, rhs, offsets, tol=param.tol,
                                maxiter=param.maxiter)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    param.secs = time.perf_counter() - t0
    param.iter_count = int(res.iters)
    param.reliable_updates = 0
    param.x_df64_lo = None
    # per UPDATED site (volume/2), one M apply per iteration
    param.gflops = (param.iter_count * dirac.flops_per_site_M()
                    * (geom.volume // 2)) / 1e9
    x0 = res.x[0]
    r0 = rhs - (op.M_pairs(x0) + offsets[0] * x0)
    param.true_res = math.sqrt(float(blas.norm2(r0))
                               / float(blas.norm2(rhs)))
    _solve_supervision(param, "invert_multishift_quda",
                       converged_multi=res.converged)
    log.info("invert_multishift_quda[%s]: %d shifts, %d iters, base "
             "true_res %.2e, %.2f s", param.dslash_type, len(offsets),
             param.iter_count, param.true_res, param.secs)
    return torch.stack([op._from_pairs(res.x[i], b.dtype)
                        for i in range(len(offsets))])


def _refuse_quarter(param: InvertParam, api: str) -> None:
    """Quarter sloppy is served by ``invert_quda`` (Wilson) only."""
    if _resolve_sloppy(param) == "quarter":
        raise NotImplementedError(
            f"cuda_prec_sloppy 'quarter' in {api}: int8 block-float links "
            "serve invert_quda's Wilson route; the batched and multi-shift "
            "routes at quarter wait for ROADMAP A7")


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

    * batched: dslash_type "wilson", "clover", "twisted-mass",
      "twisted-clover" or the staggered family,
      a PC solve_type, inv_type in the CG family, cuda_prec "single",
      tol >= 5e-8.  Every iterate is an f32 pair batch (N,4,3,2,T,Z,Y*Xh),
      or (N,3,2,T,Z,Y*Xh) staggered, on the float32 pair operator, links
      full or recon-12 as ``GaugeParam.reconstruct`` says (staggered: full
      only), whatever ``cuda_prec_sloppy`` says (it is ignored here, as in
      the JAX package).  Wilson, clover and twisted run CGNR, 2 M applies per
      iteration; the Hermitian staggered PC operator runs CG directly, 1
      apply: ``batched_cg_pairs`` (independent lanes), or with
      QUDA_TORCH_MULTI_SRC_BLOCK=1 ``block_cg_pairs`` (one shared Krylov
      space).  Every hop is one launch of a multi-RHS kernel: B5-eo for
      Wilson, K1/K2-mrhs for clover and twisted (their twist forms), two
      S2-mrhs passes (fat, then Naik added) for asqtad/hisq and one for
      fat-only staggered.
    * per-source: everything else, the flavour doublets and the
      domain-wall family included, loops over ``invert_quda`` (so tol <
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
    _refuse_quarter(param, "invert_multi_src_quda")
    dtype = complex_dtype(param.cuda_prec)
    want = _source_shape(param)
    if isinstance(sources, torch.Tensor):
        B = sources.to(device=_ctx["device"], dtype=dtype)
    else:
        B = spinor_from_host(sources, _ctx["device"], dtype, want[-2])
    if tuple(B.shape[1:]) != want:
        raise ValueError(f"sources of shape {tuple(B.shape)}: expected "
                         f"(N,) + {want}")
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
    stag = param.dslash_type in STAGGERED_TYPES
    # the doublets and the domain-wall family stay per source, as in the
    # JAX package: their flavour and Ls axes already lead the batch
    batched_able = (pc and (param.dslash_type in ("wilson", "clover")
                            + TWISTED_TYPES or stag)
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
        form = _link_form(stag)
        dirac = _build_dirac(param, True, B.dtype)
        if param.dslash_type == "wilson":
            dirac = dirac.packed()
        # staggered: the gather form, as the JAX route pins it; every hop
        # of the batch is S2-mrhs
        kw = {"form": "two_pass"} if stag else {}
        op = dirac.pairs(torch.float32, precision_form=form, **kw)
        be, bo = _split_batch(B, geom)
        rhs_b = op.prepare_pairs_mrhs(be, bo)
        if stag:
            # the staggered PC operator is Hermitian positive definite:
            # CG on it directly, one M apply per iteration
            sys_rhs, mv_b, mv_applies = rhs_b, op.M_pairs_mrhs, 1.0
        else:
            # CGNR on the batched normal equations: MdagM x = Mdag b
            sys_rhs = op.Mdag_pairs_mrhs(rhs_b)
            mv_b, mv_applies = op.MdagM_pairs_mrhs, 2.0
        if config.get("QUDA_TORCH_MULTI_SRC_BLOCK") == "1":
            res = solvers.block_cg_pairs(mv_b, sys_rhs, tol=param.tol,
                                         maxiter=param.maxiter)
            iters = [int(res.iters)] * n_src
        else:
            res = solvers.batched_cg_pairs(mv_b, sys_rhs, tol=param.tol,
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
        # per UPDATED site (volume/2) and M apply (staggered: 2 * (1146
        # or 570) + 24; twisted mass 2 * 1320 + 192; twisted clover as
        # clover); each source is charged its own iterations
        gflops = (sum(iters) * mv_applies * dirac.flops_per_site_M()
                  * _pc_sites(dirac)) / 1e9
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


def _operator_route(param: InvertParam, api: str):
    """The operator of the operator API: (storage dtype, link form) of the
    pair operator that serves ``param.dslash_type`` at ``cuda_prec``, or
    (None, None) for the families that run their complex operators (the
    flavour doublets, the domain-wall family).  Wilson and twisted mass
    in float32 or float64 pairs, clover and twisted clover in float32,
    links full or recon-12 as the resident gauge says; the staggered
    family in float32 pairs on full links.  Raises for the families and
    precisions it does not serve yet."""
    _require_init()
    param.validate()
    if _ctx["gauge"] is None:
        raise RuntimeError("load_gauge_quda() first")
    t = param.dslash_type
    if t == "laplace":
        raise NotImplementedError(
            f"{api} for dslash_type 'laplace' is not ported yet: ROADMAP "
            "A14 (the Laplace operator)")
    if t in STAGGERED_TYPES:
        form = _link_form(True)
        if param.cuda_prec != "single":
            raise NotImplementedError(
                f"{api} for dslash_type {t!r} at cuda_prec "
                f"{param.cuda_prec!r}: the staggered kernels S1/S2 and "
                "S1-full/S2-full have float32 forms only; their float64 "
                "forms wait for ROADMAP A7")
        return torch.float32, form
    if param.cuda_prec not in ("single", "double"):
        raise NotImplementedError(
            f"{api} at cuda_prec {param.cuda_prec!r}: single and double "
            "are ported (ROADMAP A7)")
    if t in NDEG_TYPES + DWF_TYPES:
        return None, None
    if t in ("clover", "twisted-clover") and param.cuda_prec == "double":
        raise NotImplementedError(
            f"{api} for dslash_type {t!r} at cuda_prec 'double': the "
            "full-lattice clover operator has float32 forms only; the "
            "clover-type double routes wait for ROADMAP A7")
    return _store_dtype(param.cuda_prec), _link_form()


def dslash_quda(psi, param: InvertParam, parity: int):
    """dslashQuda: the PC hop D_{parity, 1-parity} on a canonical complex
    half-lattice field (T,Z,Y,Xh,4,3) of parity 1-parity: B1 for Wilson,
    clover, twisted mass and twisted clover; staggered (T,Z,Y,Xh,1,3) on
    S1 (asqtad, hisq) or S2; the doublets' (T,Z,Y,Xh,2,4,3) and the 5d-PC
    domain wall's (Ls,T,Z,Y,Xh,4,3) on their complex operators."""
    from ..models import wilson as mwil
    from ..ops import wilson_packed as wpk
    store, form = _operator_route(param, "dslash_quda")
    dtype = complex_dtype(param.cuda_prec)
    geom = _ctx["geom"]
    half = geom.half_lattice_shape
    t = param.dslash_type
    if t in STAGGERED_TYPES:
        op = _build_dirac(param, True, dtype).pairs(store)
        x = _source_on_device(psi, param, dtype, half + (1, 3))
        d = op.D_to_pairs(op._to_pairs(x), int(parity), out_dtype=store)
        return op._from_pairs(d, dtype)
    if store is None:
        d = _build_dirac(param, True, dtype)
        if not hasattr(d, "D_to"):
            raise NotImplementedError(
                f"dslash_quda for dslash_type {t!r}: its PC operator "
                f"{type(d).__name__} has no PC hop D_to, in the JAX package "
                "either (its 4d-PC Möbius operators expose M and Mdag only)")
        shape = ((int(param.Ls),) + half + (4, 3) if t in DWF_TYPES
                 else half + (2, 4, 3))
        return d.D_to(_source_on_device(psi, param, dtype, shape),
                      int(parity))
    # the Wilson-hop families: their PC hop is the bare Wilson eo hop
    dpc = mwil.DiracWilsonPC(_ctx["gauge"].to(dtype), geom, param.kappa,
                             _antiperiodic(),
                             EVEN if param.matpc_type == "even-even"
                             else ODD)
    dpk = dpc.packed(precision_form=form)
    x = _source_on_device(psi, param, dtype, half + (4, 3))
    return wpk.unpack_spinor(dpk.D_to(wpk.pack_spinor(x), int(parity)), half)


def _full_op(param: InvertParam, api: str):
    """The full-lattice operator of ``param``: the pair companion of the
    kernel families, else the complex operator."""
    store, form = _operator_route(param, api)
    dtype = complex_dtype(param.cuda_prec)
    d = _build_dirac(param, False, dtype)
    if store is None:
        return d, dtype
    op = (d.pairs(store) if param.dslash_type in STAGGERED_TYPES
          else d.pairs(store, precision_form=form))
    return op, dtype


def mat_quda(psi, param: InvertParam):
    """MatQuda: M on a canonical complex (T,Z,Y,X,4,3) field: Wilson
    1 - kappa D on B4; clover and twisted clover one B7-full launch;
    twisted mass B4 plus the twist; the doublets ((T,Z,Y,X,2,4,3)) and the
    domain-wall family ((Ls,T,Z,Y,X,4,3)) their complex operators;
    staggered M = 2m + D on (T,Z,Y,X,1,3), D on S1-full (asqtad, hisq) or
    S2-full."""
    op, dtype = _full_op(param, "mat_quda")
    return op.M(_source_on_device(psi, param, dtype))


def mat_dag_mat_quda(psi, param: InvertParam):
    """MatDagMatQuda: M^dag M, two launches of the kernel that serves M
    (g5 M(-a) g5 M for the twisted families), the complex operators'
    M^dag M for the doublets and the domain-wall family; staggered
    (2m - D)(2m + D), two S1-full or S2-full launches."""
    op, dtype = _full_op(param, "mat_dag_mat_quda")
    return op.MdagM(_source_on_device(psi, param, dtype))
