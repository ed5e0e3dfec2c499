#!/usr/bin/env python3
"""Where a CG iteration of the port spends its time on the card.

    python3 chip_profile.py [all|wilson|double|staggered|zoo|mg]  # default all
    python3 chip_profile.py stag_mg [MASS ...]   # default chip_smoke's mass
    python3 chip_profile.py mrhs     # B5, B8-mrhs, B5-eo, K1/K2-mrhs,
                                     # S2-mrhs-full alone
    python3 chip_profile.py mrhs_variants [PARENT_CSRC|-] [eo] [stag] [clover]
                                     [fold] [NB]
                                     # their variants, against the parent
                                     # (NB: the parent's chunk width where
                                     # its K1/K2- or fold-mrhs entry takes
                                     # one)
    python3 chip_profile.py mrhs_ab OTHER_CSRC [NB]
                                     # K1/K2-mrhs against another tree's
    python3 chip_profile.py coarse_variants [PARENT_CSRC|-]
                                     # B8's variants, against the parent
    python3 chip_profile.py sass OTHER_CSRC [SOURCE ...]
                                     # each kernel's SASS against another
                                     # tree's
    python3 chip_profile.py mg_seeds # MG iterations per null-vector seed
    python3 chip_profile.py fold     # a 12-source fold batched iteration

Builds the solves of chip_smoke.py's main paths at 32^3 x 64 (random
SU(3) gauge and Gaussian source from a seeded torch.Generator, kappa
0.12; csw 1.0 for clover), then profiles two solvers per operator
(Wilson, then Wilson-clover) under torch.profiler, 20 iterations each:

* ``fused_cg`` on the float32 pair operator (the single/single route);
* ``cg_reliable`` at single/half: the bfloat16 pair operator in the
  loop, reliable updates on the float32 one (the mixed route; the
  window's reliable updates are part of its cost).

* ``batched_cg_pairs`` on the float32 pair operator's multi-RHS forms
  with 12 Gaussian sources (the batched route of invert_multi_src_quda).

Then the double routes of invert_quda at 32^3 x 64 (tol 1e-10): the
Wilson ``fused_cg`` on the float64 pair operator (double/double: B1 and
B2 in f64), ``cg_reliable`` with a float32 sloppy and float64 precise
operator (double/single), and ``cg_reliable_df`` (the df64 route at
cuda_prec single).

Then the staggered family at 32^4 (HISQ links of a random SU(3) gauge
from compute_ks_link_quda's construction, m 0.1): ``fused_cg`` on the
float32 hisq pair operator (the fused fat + Naik hop S1), ``fused_cg`` on
the fat-only operator (the gather pass S2), an 8-shift
``multishift_cg`` (the invert_multishift_quda route) and a 12-source
``batched_cg_pairs`` on each operator's multi-RHS forms (the multi-RHS
gather pass S2-mrhs; the invert_multi_src_quda route).

Then the twisted and domain-wall families at 32^3 x 64 (``zoo``; kappa
0.12, mu 0.1, csw 1.0; Ls 12, m5 -1.8, b5 1.5, c5 0.5, mf 0.1): ``fused_cg``
on the twisted-mass and twisted-clover pair operators (K1/K2's twist
forms), a 12-source twisted-mass ``batched_cg_pairs`` (K1/K2-mrhs), and
``fused_cg`` on the Möbius and the 5d-PC domain-wall pair operators (the
4d hop on B5-eo with N = Ls; the (Ls, Ls) s-operator einsums run as
cuBLAS GEMMs, the ``m5_algebra`` group).

Then the Wilson multigrid (``mg``) at 32^3 x 64: a quenched gauge from
a cold start and MG_SWEEPS heatbath sweeps at beta 6.0 (each followed by
4 overrelaxation sweeps), kappa MG_KAPPA, chip_smoke.py's hierarchy (3
levels, blocks 4^4 then 2^4, n_vec 24, null vectors from M v = 0).  After the set-up (its phase
seconds printed), the profiler windows are the set-up's pieces (3
iterations of the level-0 null-vector BiCGStab on B5, 3 of the level-1
one on B8's multi-RHS form, one transfer build and one coarse build per level) and one
outer GCR cycle of 16 iterations, each preconditioned by a V-cycle: per
iteration, B4 (the fine M and smoother) and B8 (the coarse M, smoother
and bottom solve) against the plain PyTorch glue and the idle share.
Before them the seconds of a heatbath and an overrelaxation sweep and of
``staple_sum`` with its 3x3 products as ``su3.mat_mul_fma`` against
``torch.matmul``; after them whole solves: CG and ``gcr-mg``.

``fold`` (not part of ``all``) profiles one 12-source
``batched_cg_pairs`` iteration on the float32 Wilson pair operator's fold
form (the fold-mrhs hop, B9) and, for comparison, on its full form
(B5-eo), 20 iterations each.

``stag_mg`` (not part of ``all``) profiles the staggered/HISQ multigrid
at 32^3 x 64 on the same kind of heatbath gauge: compute_ks_link_quda,
chip_smoke.py's hierarchy (3 levels, blocks 4^4 then 2^4, n_vec 24, the
fat-link stencil; null vectors from CG on the normal equations with
projected guesses, GCR smoothing), then 3 iterations of the level-0
null-vector CG (S2-mrhs-full) and one
outer GCR cycle of 16 iterations on the fat + Naik operator (S1-full),
each preconditioned by a V-cycle (S2-full, B8), split into kernels and
glue; then whole hisq solves at each MASS given: ``gcr-mg`` (the
hierarchy set up at that mass) against CG (normop-pc, fused_cg).

For each it prints JSON lines: the device time by kernel (top 15), then
one summary line with the device time by group (the eo hop kernel, the
fused clover hop kernel, their multi-RHS forms, the staggered hops, the
CG tail kernel, the axpy_norm2 kernel, and the plain PyTorch kernels
around them), the wall
time per iteration and the device's idle share of the window.  Last, one
line with the wall time of the clover operator's set-up by part (F_munu,
the blocks, their inverse, the whole DiracCloverPC, its f32 pair
operator), after one warm-up build.  Needs one card.
"""

from __future__ import annotations

import json
import sys
import time

DIMS = (32, 32, 32, 64)     # (X, Y, Z, T)
STAG_DIMS = (32, 32, 32, 32)
STAG_SHIFTS = (0.0, 5e-4, 2e-3, 8e-3, 3e-2, 0.12, 0.5, 2.0)
ITERS = 20
SEED = 0
NRHS = 12                   # sources of the batched solve


def _profile(label, run, torch, dims=DIMS):
    """Run ``run()`` (returns a SolverResult) under the profiler and print
    its kernel table and summary."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)

    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0 and str(ev.device_type).endswith("CUDA"):
            rows.append((ev.key, ev.count, dev_us))
    rows.sort(key=lambda r: -r[2])
    busy_us = sum(r[2] for r in rows)
    groups = {"eo_hop_kernel": 0.0, "clover_hop_kernel": 0.0,
              "eo_hop_mrhs_kernel": 0.0, "clover_hop_mrhs_kernel": 0.0,
              "staggered_fused_kernel": 0.0, "staggered_pass_kernel": 0.0,
              "staggered_pass_mrhs_kernel": 0.0,
              "full_hop_kernel": 0.0, "full_hop_mrhs_kernel": 0.0,
              "fold_hop_kernel": 0.0, "fold_hop_mrhs_kernel": 0.0,
              "staggered_full_fused_kernel": 0.0,
              "staggered_full_pass_kernel": 0.0,
              "staggered_full_pass_mrhs_kernel": 0.0,
              "coarse_kernel": 0.0, "coarse_mrhs_kernel": 0.0,
              "cg_tail_kernel": 0.0, "axpy_norm2_kernel": 0.0,
              "m5_algebra": 0.0, "plain_torch": 0.0}
    # the partial-sum pass belongs to whichever norm kernel this solver ran
    partials = ("axpy_norm2_kernel"
                if label.endswith(("cg_reliable", "multishift_cg",
                                   "cg_reliable_df"))
                else "cg_tail_kernel")
    for name, _, us in rows:
        if "stag_full_pass_mrhs_kernel" in name:
            groups["staggered_full_pass_mrhs_kernel"] += us
        elif "stag_full_fused_kernel" in name:
            groups["staggered_full_fused_kernel"] += us
        elif "stag_full_pass_kernel" in name:
            groups["staggered_full_pass_kernel"] += us
        elif "stag_pass_mrhs_kernel" in name:
            groups["staggered_pass_mrhs_kernel"] += us
        elif "stag_fused_kernel" in name:
            groups["staggered_fused_kernel"] += us
        elif "stag_pass_kernel" in name:
            groups["staggered_pass_kernel"] += us
        elif "wilson_eo_fold_mrhs_kernel" in name:
            groups["fold_hop_mrhs_kernel"] += us
        elif "wilson_eo_fold_kernel" in name:
            groups["fold_hop_kernel"] += us
        elif "wilson_full_mrhs_kernel" in name:
            groups["full_hop_mrhs_kernel"] += us
        elif "wilson_full_kernel" in name:
            groups["full_hop_kernel"] += us
        elif "coarse_apply_kernel" in name:
            groups["coarse_kernel"] += us
        elif "coarse_apply_mrhs_kernel" in name:
            groups["coarse_mrhs_kernel"] += us
        elif "wilson_eo_mrhs_kernel" in name:
            groups["eo_hop_mrhs_kernel"] += us
        elif "clover_eo_mrhs_kernel" in name:
            groups["clover_hop_mrhs_kernel"] += us
        elif "wilson_eo_kernel" in name:
            groups["eo_hop_kernel"] += us
        elif "clover_eo_kernel" in name:
            groups["clover_hop_kernel"] += us
        elif "cg_update_norm2" in name:
            groups["cg_tail_kernel"] += us
        elif "axpy_norm2" in name:
            groups["axpy_norm2_kernel"] += us
        elif "sum_partials" in name:
            groups[partials] += us
        elif label.startswith(("mobius", "domain-wall")) and "gemm" in \
                name.lower():
            groups["m5_algebra"] += us
        else:
            groups["plain_torch"] += us
    n = int(max(res.iters)) if hasattr(res.iters, "max") else res.iters
    for name, count, us in rows[:15]:
        print(json.dumps({"solver": label, "kernel": name[:120],
                          "count": count, "device_us_per_iter": us / n}),
              flush=True)
    print(json.dumps({
        "solver": label, "dims_xyzt": list(dims), "iters": n,
        "reliable_updates": getattr(res, "reliable_updates", 0),
        "wall_ms_per_iter": wall_us / n / 1e3,
        "device_busy_ms_per_iter": busy_us / n / 1e3,
        "idle_share": max(0.0, 1.0 - busy_us / wall_us),
        "group_ms_per_iter": {k: v / n / 1e3 for k, v in groups.items()},
        "device": torch.cuda.get_device_name(0)}), flush=True)


def staggered(torch, dev) -> None:
    """Profile the staggered solvers at 32^4."""
    from quda_tpu_torch.fields.gauge import GaugeField
    from quda_tpu_torch.fields.geometry import LatticeGeometry
    from quda_tpu_torch.fields.spinor import ColorSpinorField, even_odd_split
    from quda_tpu_torch.gauge.hisq import hisq_fattening
    from quda_tpu_torch.models.staggered import DiracStaggeredPC
    from quda_tpu_torch.solvers.block import batched_cg_pairs
    from quda_tpu_torch.solvers.fused_iter import fused_cg
    from quda_tpu_torch.solvers.multishift import multishift_cg

    geom = LatticeGeometry(STAG_DIMS)
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    gauge = GaugeField.random(geom, gen, dtype=torch.complex64,
                              device=dev).data
    src = ColorSpinorField.gaussian(geom, gen, nspin=1,
                                    dtype=torch.complex64, device=dev).data
    links = hisq_fattening(gauge)
    be, bo = even_odd_split(src, geom)
    halves = [even_odd_split(ColorSpinorField.gaussian(
        geom, gen, nspin=1, dtype=torch.complex64, device=dev).data, geom)
        for _ in range(NRHS)]
    be_b = torch.stack([h[0] for h in halves])
    bo_b = torch.stack([h[1] for h in halves])
    del halves
    for label, dpc in (
            ("hisq", DiracStaggeredPC(links.fat, geom, 0.1, True,
                                      links.long)),
            ("staggered", DiracStaggeredPC(gauge, geom, 0.1))):
        op = dpc.pairs(torch.float32)
        rhs = op.prepare_pairs(be, bo)
        runs = [(f"{label}:fused_cg", lambda n: fused_cg(
            op.M_pairs, rhs, tol=1e-30, maxiter=n))]
        if label == "hisq":
            runs.append((f"{label}:multishift_cg", lambda n: multishift_cg(
                op.M_pairs, rhs, STAG_SHIFTS, tol=1e-30, maxiter=n)))
        op_b = dpc.pairs(torch.float32, form="two_pass")
        rhs_b = op_b.prepare_pairs_mrhs(be_b, bo_b)
        runs.append((f"{label}:batched_cg_pairs[{NRHS}]",
                     lambda n: batched_cg_pairs(op_b.M_pairs_mrhs, rhs_b,
                                                tol=1e-30, maxiter=n)))
        for name, run in runs:
            run(3)                                           # warm-up
            torch.cuda.synchronize()
            _profile(name, lambda: run(ITERS), torch, STAG_DIMS)
        del dpc, op, rhs, op_b, rhs_b


def double(torch, dev) -> None:
    """Profile the double routes' solvers and the df64 route at 32^3 x 64
    on the normal equations of the Wilson PC operator."""
    from quda_tpu_torch.fields.gauge import GaugeField
    from quda_tpu_torch.fields.geometry import LatticeGeometry
    from quda_tpu_torch.fields.spinor import ColorSpinorField, even_odd_split
    from quda_tpu_torch.models.wilson import DiracWilsonPC
    from quda_tpu_torch.ops import wilson_df64 as wdf
    from quda_tpu_torch.solvers.fused_iter import fused_cg
    from quda_tpu_torch.solvers.mixed import (cg_reliable, cg_reliable_df,
                                              pair_inplace_codec)

    geom = LatticeGeometry(DIMS)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    gauge = GaugeField.random(geom, gen, dtype=torch.complex128,
                              device=dev).data
    src = ColorSpinorField.gaussian(geom, gen, dtype=torch.complex128,
                                    device=dev).data
    be, bo = even_odd_split(src, geom)
    f32, f64 = torch.float32, torch.float64
    dpk = DiracWilsonPC(gauge, geom, 0.12).packed()
    hi, lo = dpk.pairs(f64), dpk.pairs(f32)
    rhs = hi.Mdag_pairs(hi.prepare_pairs(be, bo))
    codec = pair_inplace_codec(f32, f64)
    dpk32 = DiracWilsonPC(gauge.to(torch.complex64), geom, 0.12).packed()
    op_df = wdf.WilsonPCDF64(dpk32)
    rhs_df = op_df.prepare_df(be.to(torch.complex64), bo.to(torch.complex64))
    lo32 = dpk32.pairs(f32)
    runs = (("double/double:fused_cg", lambda n: fused_cg(
                hi.MdagM_pairs, rhs, tol=1e-30, maxiter=n)),
            ("double/single:cg_reliable", lambda n: cg_reliable(
                hi.MdagM_pairs, lo.MdagM_pairs, rhs, codec, tol=1e-30,
                maxiter=n)),
            ("df64:cg_reliable_df", lambda n: cg_reliable_df(
                op_df, lo32.MdagM_pairs, rhs_df, pair_inplace_codec(f32),
                tol=1e-30, maxiter=n)))
    for name, run in runs:
        run(3)                                               # warm-up
        torch.cuda.synchronize()
        _profile(name, lambda: run(ITERS), torch)


def zoo(torch, dev) -> None:
    """Profile the twisted and domain-wall solvers at 32^3 x 64."""
    from quda_tpu_torch.fields.gauge import GaugeField
    from quda_tpu_torch.fields.geometry import LatticeGeometry
    from quda_tpu_torch.fields.spinor import ColorSpinorField, even_odd_split
    from quda_tpu_torch.models.domain_wall import (DiracDomainWall5DPC,
                                                   DiracMobiusPC)
    from quda_tpu_torch.models.twisted import (DiracTwistedCloverPC,
                                               DiracTwistedMassPC)
    from quda_tpu_torch.solvers.block import batched_cg_pairs
    from quda_tpu_torch.solvers.fused_iter import fused_cg

    geom = LatticeGeometry(DIMS)
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    gauge = GaugeField.random(geom, gen, dtype=torch.complex64,
                              device=dev).data

    def source():
        return ColorSpinorField.gaussian(geom, gen, dtype=torch.complex64,
                                         device=dev).data

    be, bo = even_odd_split(source(), geom)
    halves = [even_odd_split(source(), geom) for _ in range(NRHS)]
    be_b = torch.stack([h[0] for h in halves])
    bo_b = torch.stack([h[1] for h in halves])
    del halves
    for label, dpc in (
            ("twisted-mass", DiracTwistedMassPC(gauge, geom, 0.12, 0.1)),
            ("twisted-clover", DiracTwistedCloverPC(gauge, geom, 0.12, 0.1,
                                                    1.0))):
        op = dpc.pairs(torch.float32)
        rhs = op.Mdag_pairs(op.prepare_pairs(be, bo))
        runs = [(f"{label}:fused_cg", lambda n: fused_cg(
            op.MdagM_pairs, rhs, tol=1e-30, maxiter=n))]
        if label == "twisted-mass":
            rhs_b = op.Mdag_pairs_mrhs(op.prepare_pairs_mrhs(be_b, bo_b))
            runs.append((f"{label}:batched_cg_pairs[{NRHS}]",
                         lambda n: batched_cg_pairs(
                             op.MdagM_pairs_mrhs, rhs_b, tol=1e-30,
                             maxiter=n)))
        for name, run in runs:
            run(3)                                           # warm-up
            torch.cuda.synchronize()
            _profile(name, lambda: run(ITERS), torch)
        del dpc, op, rhs
    del be, bo, be_b, bo_b, rhs_b
    ls = 12
    b5 = torch.stack([source() for _ in range(ls)])
    for label, dpc in (
            ("mobius", DiracMobiusPC(gauge, geom, ls, 1.8, 0.1, 1.5, 0.5)),
            ("domain-wall", DiracDomainWall5DPC(gauge, geom, ls, 1.8,
                                                0.1))):
        op = dpc.pairs(torch.float32)
        hb = (dpc.split5(b5) if label == "domain-wall" else
              tuple(torch.stack(h) for h in zip(
                  *(even_odd_split(v, geom) for v in b5))))
        rhs = op.Mdag_pairs(op.prepare_pairs(*hb))
        del hb

        def run(n):
            return fused_cg(op.MdagM_pairs, rhs, tol=1e-30, maxiter=n)

        run(3)                                               # warm-up
        torch.cuda.synchronize()
        _profile(f"{label}[Ls={ls}]:fused_cg", lambda: run(ITERS), torch)
        del dpc, op, rhs


MG_KAPPA = 0.155
MG_BETA = 6.0
MG_SWEEPS = 40              # heatbath sweeps, each with 4 overrelaxation ones
STAG_MG_MASS = 0.005        # chip_smoke.py's staggered-MG mass


class _Once:
    """A profiled piece of work counted as one iteration."""
    iters = 1


def mg(torch, dev) -> None:
    """Profile the Wilson multigrid's set-up pieces and one outer GCR
    cycle at 32^3 x 64 on a heatbath gauge."""
    import quda_tpu_torch as qt
    from quda_tpu_torch.fields.geometry import LatticeGeometry
    from unittest import mock

    from quda_tpu_torch.gauge import smear
    from quda_tpu_torch.gauge.heatbath import (cold_start, heatbath_evolve,
                                               sweep)
    from quda_tpu_torch.gauge.smear import staple_sum
    from quda_tpu_torch.mg.gemm import build_coarse_pairs_gemm
    from quda_tpu_torch.mg.pair import PairTransfer
    from quda_tpu_torch.ops.pair import to_pairs
    from quda_tpu_torch.solvers.block import batched_bicgstab_pairs
    from quda_tpu_torch.solvers.gcr import gcr

    geom = LatticeGeometry(DIMS)
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)

    def wall_s(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    # the heatbath's sweeps, and its staples with the 3x3 products as
    # su3.mat_mul_fma's broadcast multiply-adds against torch.matmul
    g = cold_start(geom, device=dev)
    g, hb_sweep_s = wall_s(lambda: sweep(gen, g, geom, MG_BETA, True))
    g, or_sweep_s = wall_s(lambda: sweep(gen, g, geom, MG_BETA, False))
    _, staple_s = wall_s(lambda: staple_sum(g, 0))
    with mock.patch.object(smear, "mat_mul_fma", torch.matmul):
        _, staple_matmul_s = wall_s(lambda: staple_sum(g, 0))
    print(json.dumps({"heatbath_sweep_s": hb_sweep_s,
                      "overrelaxation_sweep_s": or_sweep_s,
                      "staple_sum_s": staple_s,
                      "staple_sum_torch_matmul_s": staple_matmul_s,
                      "dims_xyzt": list(DIMS), "dtype": str(g.dtype),
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    t0 = time.perf_counter()
    g = heatbath_evolve(gen, g, geom, MG_BETA, MG_SWEEPS - 1,
                        n_or_per_hb=4).to(torch.complex64)
    torch.cuda.synchronize()
    hb_s = time.perf_counter() - t0 + hb_sweep_s + or_sweep_s
    src = torch.randn(geom.lattice_shape + (4, 3), generator=gen,
                      device=dev, dtype=torch.complex64)
    qt.init_quda(dev)
    qt.load_gauge_quda(g, qt.GaugeParam(X=DIMS, cuda_prec="single"))
    del g
    ip = qt.InvertParam(dslash_type="wilson", inv_type="gcr-mg",
                        solve_type="direct", kappa=MG_KAPPA, tol=1e-6,
                        cuda_prec="single")
    mp = qt.MultigridParamAPI(n_level=3,
                              geo_block_size=((4, 4, 4, 4), (2, 2, 2, 2)),
                              n_vec=(24, 24))
    hier = qt.new_multigrid_quda(mp, ip)
    print(json.dumps({"mg_setup_s": hier.setup_seconds,
                      "setup_breakdown": hier.setup_breakdown,
                      "heatbath_s": hb_s, "plaquette": qt.plaq_quda(),
                      "dims_xyzt": list(DIMS), "kappa": MG_KAPPA,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    op0 = hier.levels[0]["op"]
    op1 = hier.levels[1]["op"]
    for label, op, lat, k in (
            ("setup:null_bicgstab[level0,24]", op0, geom.lattice_shape, 6),
            ("setup:null_bicgstab[level1,24]", op1,
             hier.levels[0]["transfer"].coarse_shape, 24)):
        bs = torch.randn((24,) + tuple(lat) + (2, k, 2), generator=gen,
                         device=dev)
        to_l = getattr(op, "to_mrhs_layout", lambda v: v)
        mv = getattr(op, "M_mrhs_pl", op.M)
        bb = to_l(bs)
        del bs
        batched_bicgstab_pairs(mv, bb, tol=1e-30, maxiter=1)     # warm-up
        torch.cuda.synchronize()
        _profile(label, lambda: batched_bicgstab_pairs(
            mv, bb, tol=1e-30, maxiter=3), torch)
        del bb
    for li, lv in enumerate(hier.levels):
        tr = lv["transfer"]

        def build_transfer(tr=tr):
            lat = tr.fine_shape
            nv = torch.randn((tr.n_vec,) + tuple(lat) + (2, tr.k_fine, 2),
                             generator=gen, device=dev)
            PairTransfer.from_null_vectors(nv, tr.block)
            return _Once()

        def build_coarse(lv=lv):
            build_coarse_pairs_gemm(lv["op"], lv["transfer"])
            return _Once()

        _profile(f"setup:transfer_build[level{li}]", build_transfer, torch)
        _profile(f"setup:coarse_build[level{li}]", build_coarse, torch)
    b = to_pairs(src, torch.float32)

    def outer(n):
        return gcr(op0.M_std, b, precond=hier.precondition, tol=1e-30,
                   nkrylov=n, max_restarts=1)

    outer(2)                                                 # warm-up
    torch.cuda.synchronize()
    _profile("gcr-mg:outer_iteration", lambda: outer(16), torch)
    # whole solves: gcr-mg on the hierarchy above, against CG
    del op0, op1, b
    qt.invert_quda(src, ip)
    solves = {"gcr-mg": {"setup_s": hier.setup_seconds,
                         "outer_iters": ip.iter_count, "secs": ip.secs,
                         "true_res": ip.true_res,
                         "converged": ip.converged}}
    del hier
    qt.destroy_multigrid_quda()
    torch.cuda.empty_cache()
    p_cg = qt.InvertParam(dslash_type="wilson", kappa=MG_KAPPA, tol=1e-6,
                          maxiter=10000, cuda_prec="single")
    qt.invert_quda(src, p_cg)
    solves["cg"] = {"iters": p_cg.iter_count, "secs": p_cg.secs}
    print(json.dumps({"mg_solves": solves, "kappa": MG_KAPPA, "tol": 1e-6,
                      "dims_xyzt": list(DIMS),
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    qt.end_quda()


def _median_ms(fn, torch, repeats=15, batch=5) -> float:
    """Milliseconds a call: the median over ``repeats`` CUDA-event timings
    of ``batch`` back-to-back calls, after two warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return sorted(times)[len(times) // 2]


def _smi() -> str:
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


HBM_BYTES_PER_S, F32_FLOPS_PER_S = 3.35e12, 67e12


def _bound_ms(nbytes, nflop) -> float:
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, nflop / F32_FLOPS_PER_S)


def mrhs(torch, dev) -> None:
    """Time the multi-RHS kernels that stage their links in shared memory,
    each at its paths' shapes at 32^3 x 64 and against its bound: B5 (the
    full-lattice hop, N = 24 and 12, the Wilson multigrid set-up) against
    N B4 launches, lanes bit for bit B4; B8-mrhs (S 8192, E 96, N 24:
    level 1 of the smoke's hierarchy) against ``torch.einsum`` and N single
    launches; B5-eo (the eo hop, N = 12: the 12-source Wilson and Möbius
    batches, N = 6: the 5d-PC domain wall's) against N B1 launches, lanes
    bit for bit B1; K1/K2-mrhs (N = 12: the 12-source clover, twisted-mass
    and twisted-clover batches, each form on a path) against N K1/K2
    launches, lanes bit for bit K1/K2; S2-mrhs-full (N = 24, fat, and the
    Naik pass accumulating into it: the staggered multigrid's null
    vectors) against N S2-full launches, lanes bit for bit S2-full and
    fat + Naik bit for bit S1-full.  Full and r12 links, each chunk width;
    random fields from a seeded torch.Generator; each launch's registers,
    shared memory and resident blocks an SM where the kernel module
    reports them."""
    from quda_tpu_torch.ops import coarse_pallas as cop
    from quda_tpu_torch.ops import wilson_pallas_packed as wpp

    smi = _smi()
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    X, Y, Z, T = DIMS
    sites = (T, Z, Y * X)
    vol = T * Z * Y * X
    for rows in (3, 2):
        u = torch.randn((4, rows, 3, 2) + sites, generator=gen, device=dev)
        ubw = wpp.backward_gauge(u, X).contiguous()
        for n in (24, 12):
            psi = torch.randn((n, 4, 3, 2) + sites, generator=gen,
                              device=dev)
            singles = [psi[i].contiguous() for i in range(n)]
            lanes = torch.stack([wpp.dslash_pallas_packed(
                u, q, X, gauge_bw=ubw) for q in singles])
            bound = _bound_ms(wpp.bytes_per_site_mrhs(n, rows) * vol,
                              wpp.flops_per_site_mrhs(n, rows) * vol)
            rec = {"kernel": "b5", "rows": rows, "nrhs": n,
                   "dims_xyzt": list(DIMS), "bound_ms": bound,
                   "b4_launches_ms": _median_ms(lambda: [
                       wpp.dslash_pallas_packed(u, q, X, gauge_bw=ubw)
                       for q in singles], torch, repeats=5, batch=2)}
            for chunk in wpp.MRHS_CHUNKS:
                got = wpp.dslash_pallas_packed_mrhs(u, psi, X, gauge_bw=ubw,
                                                    chunk=chunk)
                ms = _median_ms(lambda: wpp.dslash_pallas_packed_mrhs(
                    u, psi, X, gauge_bw=ubw, chunk=chunk), torch)
                rec[f"chunk{chunk}"] = {
                    "ms": ms, "share_of_bound": bound / ms,
                    "lanes_bitwise_b4": bool(torch.equal(got, lanes))}
                if hasattr(wpp, "full_mrhs_info"):
                    rec[f"chunk{chunk}"].update(wpp.full_mrhs_info(
                        rows, chunk, T, Z, Y, X))
            rec["nvidia_smi"] = smi
            print(json.dumps(rec), flush=True)
            del psi, singles, lanes, got
        del u, ubw
    S, E, n = 8192, 96, 24
    links = torch.randn((9, S, E, E), generator=gen, device=dev)
    psi9 = torch.randn((n, 9, S, E), generator=gen, device=dev)
    got = cop.coarse_apply_pallas_mrhs(links, psi9)
    want = torch.einsum("ksab,nksb->nsa", links, psi9)
    singles = [psi9[i] for i in range(n)]
    lanes = torch.stack([cop.coarse_apply_pallas(links, q) for q in singles])
    scale = want.abs().max().item()
    bound = _bound_ms((36 * E * E + 40 * E * n) * S, 18 * E * E * n * S)
    ms = _median_ms(lambda: cop.coarse_apply_pallas_mrhs(links, psi9), torch)
    rec = {"kernel": "b8_mrhs", "sites": S, "E": E, "nrhs": n,
           "bound_ms": bound, "ms": ms, "share_of_bound": bound / ms,
           "einsum_ms": _median_ms(lambda: torch.einsum(
               "ksab,nksb->nsa", links, psi9), torch),
           "single_launches_ms": _median_ms(lambda: [
               cop.coarse_apply_pallas(links, q) for q in singles], torch,
               repeats=5, batch=2),
           "max_rel_err": (got - want).abs().max().item() / scale,
           "max_rel_err_vs_single": (got - lanes).abs().max().item() / scale,
           "tolerance": cop.TOLERANCE, "nvidia_smi": smi}
    if hasattr(cop, "mrhs_info"):
        rec.update(cop.mrhs_info(E, n))
    print(json.dumps(rec), flush=True)
    del links, psi9, got, want, singles, lanes
    _mrhs_eo(torch, dev, smi, gen)
    _mrhs_clover(torch, dev, smi, gen)
    _mrhs_stag_full(torch, dev, smi, gen)


def _mrhs_eo(torch, dev, smi, gen) -> None:
    """B5-eo at 32^3 x 64, N = 12 and 6, R = 3 and 2, each chunk width."""
    from quda_tpu_torch.ops import wilson_pallas_packed as wpp

    X, Y, Z, T = DIMS
    Xh = X // 2
    dims = (T, Z, Y, X)
    sites = (T, Z, Y * Xh)
    half = T * Z * Y * Xh
    for rows in (3, 2):
        u = torch.randn((4, rows, 3, 2) + sites, generator=gen, device=dev)
        ubw = torch.randn((4, rows, 3, 2) + sites, generator=gen,
                          device=dev)
        for n in (12, 6):
            psi = torch.randn((n, 4, 3, 2) + sites, generator=gen,
                              device=dev)
            singles = [psi[i].contiguous() for i in range(n)]
            lanes = torch.stack([wpp.dslash_eo_pallas_packed(
                u, ubw, q, dims, 0) for q in singles])
            bound = _bound_ms(wpp.bytes_per_site_mrhs(n, rows) * half,
                              wpp.flops_per_site_mrhs(n, rows) * half)
            rec = {"kernel": "b5eo", "rows": rows, "nrhs": n,
                   "dims_xyzt": list(DIMS), "bound_ms": bound,
                   "b1_launches_ms": _median_ms(lambda: [
                       wpp.dslash_eo_pallas_packed(u, ubw, q, dims, 0)
                       for q in singles], torch, repeats=5, batch=2)}
            for chunk in wpp.MRHS_CHUNKS:
                got = wpp.dslash_eo_pallas_packed_mrhs(u, ubw, psi, dims, 0,
                                                       chunk=chunk)
                ms = _median_ms(lambda: wpp.dslash_eo_pallas_packed_mrhs(
                    u, ubw, psi, dims, 0, chunk=chunk), torch)
                rec[f"chunk{chunk}"] = {
                    "ms": ms, "share_of_bound": bound / ms,
                    "lanes_bitwise_b1": bool(torch.equal(got, lanes))}
                if hasattr(wpp, "eo_mrhs_info"):
                    rec[f"chunk{chunk}"].update(wpp.eo_mrhs_info(
                        rows, chunk, T, Z, Y, Xh))
            rec["nvidia_smi"] = smi
            print(json.dumps(rec), flush=True)
            del psi, singles, lanes, got
        del u, ubw


# K1/K2-mrhs's forms on a path: (kind, epilogue), each at R = 3 and 2
CLOVER_FORMS = [("post", "clover"), ("diag_hop", "clover"),
                ("post", "twist"), ("diag_hop", "twist"),
                ("diag_hop", "blk+twist")]
TW_A = 0.024                # a = 2 kappa mu at kappa 0.12, mu 0.1
K2_COEFF = -0.12 ** 2


def _clover_inputs(torch, dev, gen, rows, n):
    """Links (forward, backward), an n-RHS psi and x batch and blocks
    1 + 0.1 Gaussian at 32^3 x 64, float32."""
    X, Y, Z, T = DIMS
    sites = (T, Z, Y * X // 2)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    blk = 0.1 * randn(2, 6, 6, 2, *sites)
    blk[:, :, :, 0] += torch.eye(6, device=dev).reshape(1, 6, 6, 1, 1, 1)
    return (randn(4, rows, 3, 2, *sites), randn(4, rows, 3, 2, *sites),
            randn(n, 4, 3, 2, *sites), randn(n, 4, 3, 2, *sites), blk)


def _clover_epilogue_args(kind, epi):
    """(with_blk, twist flag, c, scale) of a form, an Mdag apply's
    signs."""
    if epi == "clover":
        return True, 0, 0.0, 1.0
    if kind == "post":
        return False, 1, TW_A, 1.0 / (1.0 + TW_A ** 2)
    return epi == "blk+twist", 1, -TW_A, 1.0


def _clover_wrapper_call(kind, epi, args, dims):
    """One call of a form through its wrapper: K1/K2-mrhs on an N-RHS
    batch (psi of 7 axes), else K1/K2."""
    from quda_tpu_torch.ops import clover_pallas as clp

    u, ubw, psi, xc, blk = args
    with_blk, tw, c, scale = _clover_epilogue_args(kind, epi)
    b = blk if with_blk else None
    mrhs = psi.ndim == 7
    if kind == "post":
        fn = (clp.dslash_eo_pallas_post_mrhs if mrhs
              else clp.dslash_eo_pallas_post)
        return fn(u, ubw, psi, dims, 0, blk_pl=b,
                  twist=(c, scale) if tw else None)
    fn = (clp.dslash_eo_pallas_diag_hop_mrhs if mrhs
          else clp.dslash_eo_pallas_diag_hop)
    return fn(u, ubw, psi, xc, dims, 0, hop_coeff=K2_COEFF, blk_pl=b,
              diag_twist=c if tw else None, out_dtype=psi.dtype)


def _clover_singles(args):
    """The batch's right-hand sides as single-RHS arguments."""
    u, ubw, psi, xc, blk = args
    return [(u, ubw, psi[r], xc[r], blk) for r in range(psi.shape[0])]


def _mrhs_clover(torch, dev, smi, gen) -> None:
    """K1/K2-mrhs at 32^3 x 64, N = 12, every form on a path (clover,
    twisted mass, twisted clover's K2; R = 3 and 2), at the tree's default
    chunk."""
    from quda_tpu_torch.ops import clover_pallas as clp

    X, Y, Z, T = DIMS
    Xh = X // 2
    dims = (T, Z, Y, X)
    half = T * Z * Y * Xh
    n = NRHS
    for rows in (3, 2):
        args = _clover_inputs(torch, dev, gen, rows, n)
        for kind, epi in CLOVER_FORMS:
            with_blk, tw, _, _ = _clover_epilogue_args(kind, epi)
            singles = _clover_singles(args)
            lanes = torch.stack([_clover_wrapper_call(kind, epi, a, dims)
                                 for a in singles])
            bound = _bound_ms(
                clp.bytes_per_site_mrhs(kind, n, rows, with_blk) * half,
                clp.flops_per_site_mrhs(kind, n, rows, with_blk, bool(tw))
                * half)
            rec = {"kernel": "k_mrhs", "form": f"{kind}:{epi}", "rows": rows,
                   "nrhs": n, "dims_xyzt": list(DIMS), "bound_ms": bound,
                   "single_launches_ms": _median_ms(lambda: [
                       _clover_wrapper_call(kind, epi, a, dims)
                       for a in singles], torch, repeats=5, batch=2)}
            got = _clover_wrapper_call(kind, epi, args, dims)
            ms = _median_ms(lambda: _clover_wrapper_call(
                kind, epi, args, dims), torch)
            rec.update({"ms": ms, "share_of_bound": bound / ms,
                        "lanes_bitwise_single": bool(torch.equal(got,
                                                                 lanes))})
            if hasattr(clp, "k_mrhs_info"):
                rec.update(clp.k_mrhs_info(kind, rows, T, Z, Y, Xh,
                                           with_blk, bool(tw)))
            rec["nvidia_smi"] = smi
            print(json.dumps(rec), flush=True)
            del lanes, singles, got
        del args


def _mrhs_stag_full(torch, dev, smi, gen) -> None:
    """S2-mrhs-full at 32^3 x 64, N = 24: the fat pass, and the Naik pass
    accumulating into it."""
    from quda_tpu_torch.ops import staggered_pallas as spl

    X, Y, Z, T = DIMS
    sites = (T, Z, Y * X)
    vol = T * Z * Y * X
    n = 24
    fat = torch.randn((4, 3, 3, 2) + sites, generator=gen, device=dev)
    lng = torch.randn((4, 3, 3, 2) + sites, generator=gen, device=dev) / 24
    fbw = spl.backward_links(fat, X, 1).contiguous()
    lbw = spl.backward_links(lng, X, 3).contiguous()
    psi = torch.randn((n, 3, 2) + sites, generator=gen, device=dev)
    singles = [psi[i].contiguous() for i in range(n)]
    got = spl.dslash_staggered_pass_mrhs(fat, fbw, psi, X, 1)
    lanes = torch.stack([spl.dslash_staggered_pass(fat, fbw, q, X, 1)
                         for q in singles])
    both = got.clone()
    spl.dslash_staggered_pass_mrhs(lng, lbw, psi, X, 3, acc=both)
    s1 = torch.stack([spl.dslash_staggered_pallas_fused(fat, q, X, lng)
                      for q in singles])
    acc = got.clone()
    for nhop, accum in ((1, False), (3, True)):
        u, ubw = (fat, fbw) if nhop == 1 else (lng, lbw)
        bound = _bound_ms(spl.pass_mrhs_bytes_per_site(n, accum) * vol,
                          spl.PASS_FLOPS_PER_SITE * n * vol)
        ms = _median_ms(lambda: spl.dslash_staggered_pass_mrhs(
            u, ubw, psi, X, nhop, acc=acc if accum else None), torch)
        rec = {"kernel": "s2_mrhs_full", "hopset": spl.HOPSET[nhop],
               "accumulate": accum, "nrhs": n, "dims_xyzt": list(DIMS),
               "bound_ms": bound, "ms": ms, "share_of_bound": bound / ms,
               "s2_full_launches_ms": _median_ms(lambda: [
                   spl.dslash_staggered_pass(u, ubw, q, X, nhop)
                   for q in singles], torch, repeats=5, batch=2),
               "lanes_bitwise_s2_full": bool(torch.equal(got, lanes)),
               "fat_plus_naik_bitwise_s1_full": bool(torch.equal(both, s1)),
               "nvidia_smi": smi}
        if hasattr(spl, "full_mrhs_info"):
            rec.update(spl.full_mrhs_info(nhop, accum, T, Z, Y, X))
        print(json.dumps(rec), flush=True)


# Variants of the tiled multi-RHS hops, each a set of the kernel source's
# constexpr parameters (an empty set: the shipped source), built into
# their own libraries and timed against each other, and against the
# parent tree's kernel when its source directory is given.
EO_VARIANTS = {
    "shipped": {},
    "tile64": {"kTile": 64},
    "tile256": {"kTile": 256, "kLanes": 1},
    "lanes1": {"kLanes": 1},
    "lanes4_tile64": {"kTile": 64, "kLanes": 4},
    "box2": {"kBoxZ": 2},
    "box8": {"kBoxZ": 8},
    "tmajor": {"kBoxZ": 32},
    "minblocks1": {"kMinBlocks": 1},
    "minblocks3": {"kMinBlocks": 3},
}


def _stag_variant(tile, lanes, nb, box=4, min_blocks=2):
    return {"kMrhsTile": tile, "kMrhsLanes": lanes, "kMrhsNB": nb,
            "kMrhsBoxZ": box, "kMrhsMinBlocks": min_blocks}


# S2-mrhs-full's variants name every parameter (tile, lanes, chunk, box
# depth, blocks an SM), so they do not depend on the shipped values
STAG_VARIANTS = {
    "shipped": {},
    "t128_l2_nb4": _stag_variant(128, 2, 4),
    "t128_l2_nb2": _stag_variant(128, 2, 2),
    "t128_l2_nb8": _stag_variant(128, 2, 8),
    "t64_l4_nb1": _stag_variant(64, 4, 1),
    "t64_l4_nb2": _stag_variant(64, 4, 2),
    "t256_l1_nb4": _stag_variant(256, 1, 4),
    "t64_l2_nb4": _stag_variant(64, 2, 4),
    "t128_l2_nb4_box2": _stag_variant(128, 2, 4, box=2),
    "t128_l2_nb4_box8": _stag_variant(128, 2, 4, box=8),
    "t128_l2_nb4_tmajor": _stag_variant(128, 2, 4, box=32),
    "t128_l2_nb4_mb1": _stag_variant(128, 2, 4, min_blocks=1),
    "t128_l2_nb4_mb3": _stag_variant(128, 2, 4, min_blocks=3),
    "t32_l8_nb1": _stag_variant(32, 8, 1),
    "t32_l4_nb1": _stag_variant(32, 4, 1),
    "t16_l8_nb1": _stag_variant(16, 8, 1),
    "t64_l8_nb1": _stag_variant(64, 8, 1),
    "t64_l4_nb1_mb3": _stag_variant(64, 4, 1, min_blocks=3),
    "t32_l8_nb1_mb3": _stag_variant(32, 8, 1, min_blocks=3),
    "t64_l4_nb1_box2": _stag_variant(64, 4, 1, box=2),
    "t64_l4_nb1_box8": _stag_variant(64, 4, 1, box=8),
    "t64_l4_nb1_tmajor": _stag_variant(64, 4, 1, box=32),
    "t32_l8_nb1_box8": _stag_variant(32, 8, 1, box=8),
}


# K1/K2-mrhs's variants: the forms with blocks (tile, lanes, blocks an SM,
# blocks staged or read through L1) and the block-free ones (B5-eo's plan
# and two others), box depth for both
CLOVER_VARIANTS = {
    "shipped": {},
    "blk_t128_l2_mb1": {"kTileBlk": 128, "kLanesBlk": 2, "kMinBlocks": 1},
    "blk_t64_l2": {"kLanesBlk": 2},
    "blk_t32_l8": {"kTileBlk": 32, "kLanesBlk": 8},
    "mb1": {"kMinBlocks": 1},
    "mb3": {"kMinBlocks": 3},
    "free_t64_l4": {"kTileFree": 64, "kLanesFree": 4},
    "box2": {"kBoxZ": 2},
    "box8": {"kBoxZ": 8},
}


def _build_variants(source: str, variants: dict, parent_csrc=None) -> dict:
    """One shared library for each variant of ``csrc/<source>`` (and the
    parent's source as "parent"), all nvcc processes started together,
    under the git-ignored build directory; returns name -> (ctypes
    library, ptxas log)."""
    import ctypes
    import re
    import subprocess
    from pathlib import Path

    from quda_tpu_torch.utils import kernels

    root = kernels.BUILD_ROOT / "variants" / Path(source).stem
    text = (kernels.CSRC / source).read_text()
    jobs = {}
    for name, params in variants.items():
        src = text
        for key, val in params.items():
            src, hits = re.subn(rf"(constexpr int {key} = )\d+;",
                                rf"\g<1>{val};", src)
            if hits != 1:
                raise ValueError(f"{source}: {key} found {hits} times")
        jobs[name] = (src, kernels.CSRC)
    if parent_csrc is not None:
        jobs["parent"] = ((Path(parent_csrc) / source).read_text(),
                          Path(parent_csrc))
    procs = {}
    for name, (src, inc) in jobs.items():
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        (d / source).write_text(src)
        cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-shared",
               "-I", str(inc), "-o", str(d / "lib.so"), str(d / source)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} of {source}:\n{log}")
        libs[name] = (ctypes.CDLL(str(root / name / "lib.so")), log)
    return libs


def _variant_info(lib, entry, *args) -> dict:
    import ctypes

    fn = getattr(lib, entry, None)
    if fn is None:
        return {}
    info = (ctypes.c_int * 6)()
    fn.restype = ctypes.c_int
    rc = fn(*[ctypes.c_int(a) for a in args],
            ctypes.cast(info, ctypes.c_void_p))
    return {} if rc else {"registers": info[0], "smem_bytes": info[1],
                          "blocks_per_sm": info[2], "threads": info[3]}


def mrhs_variants(torch, dev, parent_csrc=None,
                  which=("eo", "stag", "clover", "fold"),
                  parent_nb=None) -> None:
    """Time variants of B5-eo (csrc/wilson_eo_mrhs.cu: tile, lanes, box
    depth, blocks an SM) at N = 12 and 6, R = 3 and 2, each chunk, of
    S2-mrhs-full (csrc/staggered_full.cu: chunk, lanes, tile, box depth,
    blocks an SM) at N = 24, fat and Naik accumulating, and of K1/K2-mrhs
    (csrc/clover_eo_mrhs.cu, CLOVER_VARIANTS) at N = 12, each form on a
    path, R = 3 and 2, and of fold-mrhs (csrc/wilson_eo_fold.cu, B5-eo's
    EO_VARIANTS on the fold layout) at N = 12, R = 3 and 2, at 32^3 x 64, through their C entries in libraries of their own; and the
    parent tree's kernels where ``parent_csrc`` (its csrc directory, whose
    entries take this tree's arguments, and ``parent_nb``, a chunk width,
    where the parent's K1/K2-mrhs or fold-mrhs entry takes one) is
    given.  Each shape's variants run in turns, forward then backward, and
    each output is checked bit
    for bit against single-RHS launches (B1, S2-full, K1/K2, the fold hop)
    of this tree."""
    import ctypes

    from quda_tpu_torch.ops import staggered_pallas as spl
    from quda_tpu_torch.ops import wilson_pallas_packed as wpp
    from quda_tpu_torch.utils import kernels

    smi = _smi()
    t0 = time.perf_counter()
    eo_libs = (_build_variants("wilson_eo_mrhs.cu", EO_VARIANTS, parent_csrc)
               if "eo" in which else {})
    st_libs = (_build_variants("staggered_full.cu", STAG_VARIANTS,
                               parent_csrc) if "stag" in which else {})
    cl_libs = (_build_variants("clover_eo_mrhs.cu", CLOVER_VARIANTS,
                               parent_csrc) if "clover" in which else {})
    fold_libs = (_build_variants("wilson_eo_fold.cu", EO_VARIANTS,
                                 parent_csrc) if "fold" in which else {})
    print(json.dumps({"variants_built_s": time.perf_counter() - t0}),
          flush=True)
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev).manual_seed(SEED + 43)
    X, Y, Z, T = DIMS
    Xh = X // 2
    dims = (T, Z, Y, X)

    def turns(names, run):
        """{name: (ms forward, ms backward)}: the variants in turns."""
        order = list(names)
        fwd = {k: _median_ms(lambda: run(k), torch, repeats=9) for k in order}
        bwd = {k: _median_ms(lambda: run(k), torch, repeats=9)
               for k in reversed(order)}
        return {k: (fwd[k], bwd[k]) for k in order}

    sites = (T, Z, Y * Xh)
    half = T * Z * Y * Xh
    for name, (lib, _) in eo_libs.items():
        getattr(lib, "qtt_wilson_eo_mrhs").argtypes = list(
            kernels.SIGNATURES["qtt_wilson_eo_mrhs"])
    for rows in (3, 2) if eo_libs else ():
        u = torch.randn((4, rows, 3, 2) + sites, generator=gen, device=dev)
        ubw = torch.randn((4, rows, 3, 2) + sites, generator=gen,
                          device=dev)
        for n in (12, 6):
            psi = torch.randn((n, 4, 3, 2) + sites, generator=gen,
                              device=dev)
            out = torch.empty_like(psi)
            lanes = torch.stack([wpp.dslash_eo_pallas_packed(
                u, ubw, psi[i].contiguous(), dims, 0) for i in range(n)])
            bound = _bound_ms(wpp.bytes_per_site_mrhs(n, rows) * half,
                              wpp.flops_per_site_mrhs(n, rows) * half)
            for chunk in wpp.MRHS_CHUNKS:
                def run(k):
                    rc = eo_libs[k][0].qtt_wilson_eo_mrhs(
                        out.data_ptr(), psi.data_ptr(), u.data_ptr(),
                        ubw.data_ptr(), T, Z, Y, Xh, 0, rows, 1, n, chunk,
                        stream)
                    kernels.check_launch(rc, f"B5-eo variant {k}")
                bits = {}
                for k in eo_libs:
                    out.zero_()
                    run(k)
                    bits[k] = bool(torch.equal(out, lanes))
                ms = turns(eo_libs, run)
                print(json.dumps({
                    "kernel": "b5eo_variants", "rows": rows, "nrhs": n,
                    "chunk": chunk, "bound_ms": bound,
                    "variants": {k: {"ms": v, "share_of_bound": [
                        bound / t for t in v], "lanes_bitwise_b1": bits[k],
                        **EO_VARIANTS.get(k, {}),
                        **_variant_info(eo_libs[k][0],
                                        "qtt_wilson_eo_mrhs_info", T, Z, Y,
                                        Xh, rows, chunk)}
                        for k, v in ms.items()},
                    "nvidia_smi": smi}), flush=True)
            del psi, out, lanes
        del u, ubw

    sites = (T, Z, Y * X)
    vol = T * Z * Y * X
    n = 24
    for name, (lib, _) in st_libs.items():
        getattr(lib, "qtt_staggered_full_pass_mrhs").argtypes = list(
            kernels.SIGNATURES["qtt_staggered_full_pass_mrhs"])
    fat = torch.randn((4, 3, 3, 2) + sites, generator=gen, device=dev)
    lng = torch.randn((4, 3, 3, 2) + sites, generator=gen, device=dev) / 24
    fbw = spl.backward_links(fat, X, 1).contiguous()
    lbw = spl.backward_links(lng, X, 3).contiguous()
    psi = torch.randn((n, 3, 2) + sites, generator=gen, device=dev)
    fat_lanes = torch.stack([spl.dslash_staggered_pass(
        fat, fbw, psi[i].contiguous(), X, 1) for i in range(n)])
    s1 = torch.stack([spl.dslash_staggered_pallas_fused(
        fat, psi[i].contiguous(), X, lng) for i in range(n)])
    out = torch.empty_like(psi)
    for nhop, accum in ((1, False), (3, True)) if st_libs else ():
        u, ubw = (fat, fbw) if nhop == 1 else (lng, lbw)

        def run(k):
            rc = st_libs[k][0].qtt_staggered_full_pass_mrhs(
                out.data_ptr(), psi.data_ptr(), u.data_ptr(), ubw.data_ptr(),
                T, Z, Y, X, nhop, int(accum), n, stream)
            kernels.check_launch(rc, f"S2-mrhs-full variant {k}")
        bits = {}
        for k in st_libs:
            out.copy_(fat_lanes) if accum else out.zero_()
            run(k)
            bits[k] = bool(torch.equal(out, s1 if accum else fat_lanes))
        out.copy_(fat_lanes)
        bound = _bound_ms(spl.pass_mrhs_bytes_per_site(n, accum) * vol,
                          spl.PASS_FLOPS_PER_SITE * n * vol)
        ms = turns(st_libs, run)
        print(json.dumps({
            "kernel": "s2_mrhs_full_variants", "hopset": spl.HOPSET[nhop],
            "accumulate": accum, "nrhs": n, "bound_ms": bound,
            "variants": {k: {"ms": v, "share_of_bound": [
                bound / t for t in v],
                "bitwise_" + ("s1_full" if accum else "s2_full"): bits[k],
                **STAG_VARIANTS.get(k, {}),
                **_variant_info(st_libs[k][0],
                                "qtt_staggered_full_pass_mrhs_info", T, Z,
                                Y, X, nhop, int(accum))}
                for k, v in ms.items()},
            "nvidia_smi": smi}), flush=True)
    _clover_variants(torch, dev, cl_libs, turns, smi, gen, parent_nb)
    _fold_variants(torch, dev, fold_libs, turns, smi, gen, parent_nb)
    print(json.dumps({"mrhs_variants_s": time.perf_counter() - t0,
                      "device": torch.cuda.get_device_name(0)}), flush=True)


def _clover_variants(torch, dev, libs, turns, smi, gen,
                     parent_nb=None) -> None:
    """K1/K2-mrhs's variant libraries ``libs`` in turns at 32^3 x 64,
    N = 12, each form on a path, R = 3 and 2, each output held bit for
    bit to K1/K2 launches of this tree; ``parent_nb``: the chunk width to
    pass to the "parent" library where its entry takes one."""
    import ctypes

    from quda_tpu_torch.ops import clover_pallas as clp
    from quda_tpu_torch.utils import kernels

    X, Y, Z, T = DIMS
    Xh = X // 2
    dims = (T, Z, Y, X)
    half = T * Z * Y * Xh
    n = NRHS
    stream = torch.cuda.current_stream(dev).cuda_stream
    sig = list(kernels.SIGNATURES["qtt_clover_eo_mrhs"])
    extra = {k: () for k in libs}
    if parent_nb is not None:
        extra["parent"] = (parent_nb,)
    for k, (lib, _) in libs.items():
        lib.qtt_clover_eo_mrhs.argtypes = (
            sig[:-1] + [ctypes.c_int] * len(extra[k]) + sig[-1:])
    for rows in (3, 2) if libs else ():
        args = _clover_inputs(torch, dev, gen, rows, n)
        u, ubw, psi, xc, blk = args
        out = torch.empty_like(psi)
        for kind, epi in CLOVER_FORMS:
            with_blk, tw, c, scale = _clover_epilogue_args(kind, epi)
            lanes = torch.stack([_clover_wrapper_call(kind, epi, a, dims)
                                 for a in _clover_singles(args)])
            bound = _bound_ms(
                clp.bytes_per_site_mrhs(kind, n, rows, with_blk) * half,
                clp.flops_per_site_mrhs(kind, n, rows, with_blk, bool(tw))
                * half)

            def run(k):
                rc = libs[k][0].qtt_clover_eo_mrhs(
                    out.data_ptr(), psi.data_ptr(), u.data_ptr(),
                    ubw.data_ptr(), blk.data_ptr() if with_blk else None,
                    xc.data_ptr(), T, Z, Y, Xh, 0, rows, 1,
                    int(kind == "diag_hop"), K2_COEFF, int(with_blk),
                    tw, c, scale, n, *extra[k], stream)
                kernels.check_launch(rc, f"K1/K2-mrhs variant {k}")
            bits = {}
            for k in libs:
                out.zero_()
                run(k)
                bits[k] = bool(torch.equal(out, lanes))
            ms = turns(libs, run)
            print(json.dumps({
                "kernel": "k_mrhs_variants", "form": f"{kind}:{epi}",
                "rows": rows, "nrhs": n, "bound_ms": bound,
                "variants": {k: {"ms": v, "share_of_bound": [
                    bound / t for t in v], "lanes_bitwise_single": bits[k],
                    **CLOVER_VARIANTS.get(k, {}),
                    **({} if extra[k] else _variant_info(
                        libs[k][0], "qtt_clover_eo_mrhs_info", T, Z, Y, Xh,
                        rows, int(kind == "diag_hop"), int(with_blk), tw))}
                    for k, v in ms.items()},
                "nvidia_smi": smi}), flush=True)
            del lanes
        del args, u, ubw, psi, xc, blk, out


def _fold_variants(torch, dev, libs, turns, smi, gen,
                   parent_nb=None) -> None:
    """fold-mrhs's variant libraries ``libs`` in turns at 32^3 x 64,
    N = 12, R = 3 and 2, each output held bit for bit to fold hop
    launches of this tree; ``parent_nb``: the chunk width to pass to the
    "parent" library where its entry takes one."""
    import ctypes

    from quda_tpu_torch.ops import wilson_pallas_packed as wpp
    from quda_tpu_torch.utils import kernels

    X, Y, Z, T = DIMS
    Xh = X // 2
    dims = (T, Z, Y, X)
    half = T * Z * Y * Xh
    n = NRHS
    stream = torch.cuda.current_stream(dev).cuda_stream
    sig = list(kernels.SIGNATURES["qtt_wilson_eo_fold_mrhs"])
    extra = {k: () for k in libs}
    if parent_nb is not None and "parent" in libs:
        extra["parent"] = (parent_nb,)
    for k, (lib, _) in libs.items():
        lib.qtt_wilson_eo_fold_mrhs.argtypes = (
            sig[:-1] + [ctypes.c_int] * len(extra[k]) + sig[-1:])
    fsites = (T, 2 * Z, Y * Xh)
    for rows in (3, 2) if libs else ():
        u, ubw = (torch.randn((4, rows, 3) + fsites, generator=gen,
                              device=dev) for _ in range(2))
        psi = torch.randn((n, 4, 3) + fsites, generator=gen, device=dev)
        out = torch.empty_like(psi)
        lanes = torch.stack([wpp.dslash_eo_pallas_packed_fold(
            u, ubw, psi[i], dims, 0) for i in range(n)])
        bound = _bound_ms(wpp.bytes_per_site_mrhs(n, rows) * half,
                          wpp.flops_per_site_mrhs(n, rows) * half)
        def run(k):
            rc = libs[k][0].qtt_wilson_eo_fold_mrhs(
                out.data_ptr(), psi.data_ptr(), u.data_ptr(), ubw.data_ptr(),
                T, Z, Y, Xh, 0, rows, 1, n, *extra[k], stream)
            kernels.check_launch(rc, f"fold-mrhs variant {k}")
        bits = {}
        for k in libs:
            out.zero_()
            run(k)
            bits[k] = bool(torch.equal(out, lanes))
        ms = turns(libs, run)
        print(json.dumps({
            "kernel": "fold_mrhs_variants", "rows": rows, "nrhs": n,
            "bound_ms": bound, "parent_chunk": parent_nb,
            "variants": {k: {"ms": v, "share_of_bound": [
                bound / t for t in v], "lanes_bitwise_fold": bits[k],
                **EO_VARIANTS.get(k, {}),
                **({} if extra[k] else _variant_info(
                    libs[k][0], "qtt_wilson_eo_fold_mrhs_info", T, Z, Y, Xh,
                    rows))}
                for k, v in ms.items()},
            "nvidia_smi": smi}), flush=True)
        del u, ubw, psi, out, lanes


# B8's variants: ring depth, rows a tile (lanes a row, rows a lane group,
# threads a block) and blocks an SM of the launch bound
COARSE_VARIANTS = {
    "shipped": {},
    "stages2": {"kCoarseStages": 2},
    "stages4": {"kCoarseStages": 4},
    "stages6": {"kCoarseStages": 6},
    "rows64": {"kCoarseRowsPerGroup": 2, "kCoarseMinBlocks": 2},
    "lanes16_rows16": {"kCoarseLanesMid": 16},
    "threads128": {"kCoarseThreads": 128, "kCoarseMinBlocks": 8},
}
COARSE_SHAPES = ((512, 96), (8192, 96))     # the 4^3 x 8 and 8^3 x 16 levels


def coarse_variants(torch, dev, parent_csrc=None, rounds=6) -> None:
    """Time variants of B8 (csrc/coarse.cu's constexpr ring, tile, lanes,
    launch bound and grid, COARSE_VARIANTS) and the parent tree's kernel
    (``parent_csrc``, its csrc directory) at the multigrid's two coarse
    levels (S 512 and 8192, E 96), on the same buffers in one process,
    in ``rounds`` rounds of alternating order (the median of each round's
    CUDA-event timings), beside ``torch.einsum("ksab,ksb->sa")``; each
    output within TOLERANCE of the einsum, and each variant's resources
    where its library has the query entry."""
    from quda_tpu_torch.ops import coarse_pallas as cop
    from quda_tpu_torch.utils import kernels

    smi = _smi()
    t0 = time.perf_counter()
    libs = _build_variants("coarse.cu", COARSE_VARIANTS, parent_csrc)
    print(json.dumps({"variants_built_s": time.perf_counter() - t0}),
          flush=True)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for lib, _ in libs.values():
        lib.qtt_coarse_apply.argtypes = list(
            kernels.SIGNATURES["qtt_coarse_apply"])
    gen = torch.Generator(device=dev).manual_seed(SEED + 53)
    for S, E in COARSE_SHAPES:
        links = torch.randn((9, S, E, E), generator=gen, device=dev)
        psi9 = torch.randn((9, S, E), generator=gen, device=dev)
        out = torch.empty((S, E), device=dev)
        want = torch.einsum("ksab,ksb->sa", links, psi9)
        scale = want.abs().max().item()

        def run(k):
            rc = libs[k][0].qtt_coarse_apply(out.data_ptr(), links.data_ptr(),
                                             psi9.data_ptr(), S, E, stream)
            kernels.check_launch(rc, f"B8 variant {k}")
        errs = {}
        for k in libs:
            out.zero_()
            run(k)
            errs[k] = (out - want).abs().max().item() / scale
        names = list(libs)
        ms = {k: [] for k in names}
        for r in range(rounds):
            for k in names if r % 2 == 0 else names[::-1]:
                ms[k].append(_median_ms(lambda: run(k), torch, repeats=9))
        einsum_ms = _median_ms(lambda: torch.einsum("ksab,ksb->sa", links,
                                                    psi9), torch)
        model = cop.coarse_model(E // 2)
        bound = _bound_ms(model["bytes_per_site"] * S,
                          model["flops_per_site"] * S)
        print(json.dumps({
            "kernel": "b8_variants", "sites": S, "E": E, "bound_ms": bound,
            "einsum_ms": einsum_ms, "tolerance": cop.TOLERANCE,
            "variants": {k: {"ms_rounds": v,
                             "ms_median": sorted(v)[len(v) // 2],
                             "share_of_bound":
                                 bound / sorted(v)[len(v) // 2],
                             "max_rel_err": errs[k],
                             **COARSE_VARIANTS.get(k, {}),
                             **_variant_info(libs[k][0],
                                             "qtt_coarse_apply_info", S, E,
                                             1)}
                         for k, v in ms.items()},
            "nvidia_smi": smi}), flush=True)
        del links, psi9, out, want
    print(json.dumps({"coarse_variants_s": time.perf_counter() - t0,
                      "device": torch.cuda.get_device_name(0)}), flush=True)


# the sources whose kernels another tree's must match instruction for
# instruction when this tree did not mean to change them
SASS_SOURCES = ("wilson_full.cu", "wilson_eo_mrhs.cu", "clover_eo_mrhs.cu",
                "staggered_full.cu", "coarse.cu")


def sass(other_csrc, sources=SASS_SOURCES) -> None:
    """Compile each source of this tree and of another (its csrc
    directory) to a cubin with the library's flags and compare each
    kernel's SASS (``cuobjdump -sass``), instruction by instruction, the
    kernels matched by name with the file-specific hash of their
    anonymous namespace masked; prints one line a source."""
    import re
    import subprocess
    from pathlib import Path

    from quda_tpu_torch.utils import kernels

    nvcc = kernels.nvcc_path()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    root = kernels.BUILD_ROOT / "sass"
    flags = [f for f in kernels.NVCC_FLAGS if f not in ("-Xptxas", "-v")]

    def functions(path) -> dict:
        text = subprocess.run([cuobjdump, "-sass", str(path)],
                              capture_output=True, text=True,
                              check=True).stdout
        funcs = {}
        for block in text.split("Function : ")[1:]:
            name, _, body = block.partition("\n")
            key = re.sub(r"[0-9a-f]{8,}", "H", name.strip())
            funcs[key] = [re.sub(r"/\*[0-9a-f]{4}\*/", "", ln).split(";")[0]
                          .strip() for ln in body.splitlines()
                          if re.match(r"\s*/\*[0-9a-f]{4}\*/", ln)]
        return funcs

    for source in sources:
        cubins = {}
        procs = {}
        for tree, csrc in (("this", kernels.CSRC), ("other",
                                                     Path(other_csrc))):
            d = root / tree
            d.mkdir(parents=True, exist_ok=True)
            cubins[tree] = d / (Path(source).stem + ".cubin")
            procs[tree] = subprocess.Popen(
                [nvcc, *flags, "-cubin", "-I", str(csrc), "-o",
                 str(cubins[tree]), str(csrc / source)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for tree, proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"{source} ({tree}):\n{log}")
        mine, theirs = functions(cubins["this"]), functions(cubins["other"])
        same = sorted(k for k in mine if mine[k] == theirs.get(k))
        print(json.dumps({
            "sass": source, "kernels": len(mine),
            "identical": len(same), "differ": sorted(
                k for k in mine if k in theirs and k not in same),
            "only_here": sorted(set(mine) - set(theirs)),
            "only_there": sorted(set(theirs) - set(mine))}), flush=True)


def fold(torch, dev) -> None:
    """Profile one 12-source ``batched_cg_pairs`` iteration on the float32
    Wilson pair operator's fold form (fold-mrhs) and its full form (B5-eo)
    at 32^3 x 64, kappa 0.12, 20 iterations each, in the order fold, full,
    full, fold."""
    from quda_tpu_torch.fields.gauge import GaugeField
    from quda_tpu_torch.fields.geometry import LatticeGeometry
    from quda_tpu_torch.fields.spinor import ColorSpinorField, even_odd_split
    from quda_tpu_torch.models.wilson import DiracWilsonPC
    from quda_tpu_torch.solvers.block import batched_cg_pairs

    geom = LatticeGeometry(DIMS)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    gauge = GaugeField.random(geom, gen, dtype=torch.complex64,
                              device=dev).data
    halves = [even_odd_split(ColorSpinorField.gaussian(
        geom, gen, dtype=torch.complex64, device=dev).data, geom)
        for _ in range(NRHS)]
    be_b = torch.stack([h[0] for h in halves])
    bo_b = torch.stack([h[1] for h in halves])
    del halves
    dpk = DiracWilsonPC(gauge, geom, 0.12).packed()
    ops = {f: dpk.pairs(torch.float32, f) for f in ("fold", "full")}
    rhs = ops["full"].Mdag_pairs_mrhs(ops["full"].prepare_pairs_mrhs(be_b,
                                                                     bo_b))
    for form in ("fold", "full", "full", "fold"):
        op = ops[form]

        def run(n):
            return batched_cg_pairs(op.MdagM_pairs_mrhs, rhs, tol=1e-30,
                                    maxiter=n)

        run(3)                                               # warm-up
        torch.cuda.synchronize()
        _profile(f"{form}:batched_cg_pairs[{NRHS}]", lambda: run(ITERS),
                 torch)


def mrhs_ab(torch, dev, other_csrc, other_nb=None, rounds=8) -> None:
    """K1/K2-mrhs of this tree ("this") against another tree's kernel
    ("parent": its csrc directory; ``other_nb``: the chunk width to pass
    where its C entry takes one) on the same buffers in one process, as
    ``_clover_variants`` times variants, in ``rounds`` rounds whose order
    alternates: separate processes place the buffers apart and can
    differ by more than the kernels do."""
    libs = _build_variants("clover_eo_mrhs.cu", {"this": {}}, other_csrc)

    def alternating(names, run):
        """{name: ms of each round}."""
        names = list(names)
        ms = {k: [] for k in names}
        for r in range(rounds):
            for k in names if r % 2 == 0 else names[::-1]:
                ms[k].append(_median_ms(lambda: run(k), torch, repeats=11))
        return ms

    _clover_variants(torch, dev, libs, alternating, _smi(),
                     torch.Generator(device=dev).manual_seed(SEED + 47),
                     other_nb)


def mg_seeds(torch, dev, seeds=(2024, 1, 2, 3, 4)) -> None:
    """How the Wilson multigrid's outer iterations vary with its
    hierarchy: on one heatbath gauge (32^3 x 64, beta 6.0, kappa
    MG_KAPPA, chip_smoke.py's 3-level parameters) the hierarchy is set
    up once per seed of the generator that draws its null vectors' random
    starts (2024 is the default), and a gcr-mg solve of one Gaussian
    source at tol 1e-6 runs on each: set-up seconds, the level-1
    null-vector B8-mrhs launches, outer iterations, solve seconds and the
    true residual."""
    import quda_tpu_torch as qt
    from quda_tpu_torch.fields.geometry import LatticeGeometry
    from quda_tpu_torch.interfaces import quda_api as api
    from quda_tpu_torch.mg.pair import PairMG
    from quda_tpu_torch.ops import coarse_pallas as cop

    geom = LatticeGeometry(DIMS)
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    g, hb_s = _heatbath_gauge(torch, dev, geom, gen)
    src = torch.randn(geom.lattice_shape + (4, 3), generator=gen,
                      device=dev, dtype=torch.complex64)
    qt.init_quda(dev)
    qt.load_gauge_quda(g, qt.GaugeParam(X=DIMS, cuda_prec="single"))
    del g
    ip = qt.InvertParam(dslash_type="wilson", inv_type="gcr-mg",
                        solve_type="direct", kappa=MG_KAPPA, tol=1e-6,
                        cuda_prec="single")
    mp = qt.MultigridParamAPI(n_level=3,
                              geo_block_size=((4, 4, 4, 4), (2, 2, 2, 2)),
                              n_vec=(24, 24))
    d = api._build_dirac(ip, False, api.complex_dtype("single"))
    params = api._mg_level_params(mp, "wilson")
    for seed in seeds:
        cop.reset_launches()
        mg = PairMG(d, geom, params,
                    torch.Generator(device=dev).manual_seed(seed))
        n8 = cop.coarse_apply_pallas_mrhs.launches
        api._ctx.update(mg=mg, mg_epoch=api._mg_key(ip), mg_param=mp)
        qt.invert_quda(src, ip)
        print(json.dumps({
            "seed": seed, "setup_s": mg.setup_seconds,
            "null_vectors_s": [b["seconds"] for b in mg.setup_breakdown
                               if b["phase"] == "null_vectors"],
            "b8_mrhs_launches": n8, "outer_iters": ip.iter_count,
            "secs": ip.secs, "true_res": ip.true_res,
            "converged": ip.converged, "heatbath_s": hb_s,
            "device": torch.cuda.get_device_name(0)}), flush=True)
        del mg
        qt.destroy_multigrid_quda()
        torch.cuda.empty_cache()
    qt.end_quda()


def _heatbath_gauge(torch, dev, geom, gen):
    """A quenched gauge at beta MG_BETA from a cold start, MG_SWEEPS
    heatbath sweeps each followed by 4 overrelaxation sweeps, complex64;
    and the seconds it took."""
    from quda_tpu_torch.gauge.heatbath import cold_start, heatbath_evolve
    t0 = time.perf_counter()
    g = heatbath_evolve(gen, cold_start(geom, device=dev), geom, MG_BETA,
                        MG_SWEEPS, n_or_per_hb=4).to(torch.complex64)
    torch.cuda.synchronize()
    return g, time.perf_counter() - t0


def stag_mg(torch, dev, masses=(STAG_MG_MASS,)) -> None:
    """Profile the staggered/HISQ multigrid's level-0 null-vector
    iteration and one outer GCR cycle at 32^3 x 64 on a heatbath gauge;
    then whole hisq solves, gcr-mg against CG, at each mass."""
    import quda_tpu_torch as qt
    from quda_tpu_torch.fields.geometry import LatticeGeometry
    from quda_tpu_torch.mg.pair import outer_operator
    from quda_tpu_torch.ops.pair import to_pairs
    from quda_tpu_torch.solvers.block import batched_cg_pairs
    from quda_tpu_torch.solvers.gcr import gcr

    geom = LatticeGeometry(DIMS)
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    g, hb_s = _heatbath_gauge(torch, dev, geom, gen)
    src = torch.randn(geom.lattice_shape + (1, 3), generator=gen,
                      device=dev, dtype=torch.complex64)
    qt.init_quda(dev)
    qt.load_gauge_quda(g, qt.GaugeParam(X=DIMS, cuda_prec="single"))
    del g
    t0 = time.perf_counter()
    qt.compute_ks_link_quda()
    torch.cuda.synchronize()
    ks_s = time.perf_counter() - t0
    mp = qt.MultigridParamAPI(n_level=3,
                              geo_block_size=((4, 4, 4, 4), (2, 2, 2, 2)),
                              n_vec=(24, 24))
    solves = {}
    for i, mass in enumerate(masses):
        ip = qt.InvertParam(dslash_type="hisq", inv_type="gcr-mg",
                            solve_type="direct", mass=mass, tol=1e-6,
                            cuda_prec="single")
        torch.cuda.reset_peak_memory_stats(dev)
        hier = qt.new_multigrid_quda(mp, ip)
        print(json.dumps({"mass": mass, "mg_setup_s": hier.setup_seconds,
                          "setup_breakdown": hier.setup_breakdown,
                          "heatbath_s": hb_s, "ks_link_s": ks_s,
                          "plaquette": qt.plaq_quda(),
                          "peak_mem_gb":
                              torch.cuda.max_memory_allocated(dev) / 1e9,
                          "dims_xyzt": list(DIMS),
                          "device": torch.cuda.get_device_name(0)}),
              flush=True)
        if i == 0:
            # the level-0 null-vector solve as the set-up runs it: CG on
            # the normal equations (the staggered default) in the kernel
            # layout, two S2-mrhs-full launches an iteration
            op0 = hier.levels[0]["op"]
            bb = op0.to_mrhs_layout(op0.project_null_source(torch.randn(
                (24,) + tuple(geom.lattice_shape) + (2, 3, 2),
                generator=gen, device=dev)))
            batched_cg_pairs(op0.MdagM_mrhs_pl, bb, tol=1e-30,
                             maxiter=1)                      # warm-up
            torch.cuda.synchronize()
            _profile("stag_setup:null_cg[level0,24]",
                     lambda: batched_cg_pairs(op0.MdagM_mrhs_pl, bb,
                                              tol=1e-30, maxiter=3), torch)
            del bb
            b = to_pairs(src, torch.float32)

            def outer(n):
                return gcr(outer_operator(op0), b,
                           precond=hier.precondition, tol=1e-30,
                           nkrylov=n, max_restarts=1)

            outer(2)                                         # warm-up
            torch.cuda.synchronize()
            _profile("stag_gcr-mg:outer_iteration", lambda: outer(16),
                     torch)
            del op0, b
        qt.invert_quda(src, ip)
        solves[str(mass)] = {"gcr-mg": {
            "setup_s": hier.setup_seconds, "outer_iters": ip.iter_count,
            "secs": ip.secs, "true_res": ip.true_res,
            "converged": ip.converged}}
        del hier
        qt.destroy_multigrid_quda()
        torch.cuda.empty_cache()
        p_cg = qt.InvertParam(dslash_type="hisq", mass=mass, tol=1e-6,
                              maxiter=20000, cuda_prec="single")
        qt.invert_quda(src, p_cg)
        solves[str(mass)]["cg"] = {"iters": p_cg.iter_count,
                                   "secs": p_cg.secs,
                                   "true_res": p_cg.true_res,
                                   "converged": p_cg.converged}
        print(json.dumps({"stag_mg_solves": solves[str(mass)],
                          "mass": mass, "tol": 1e-6,
                          "dims_xyzt": list(DIMS),
                          "device": torch.cuda.get_device_name(0)}),
              flush=True)
    qt.end_quda()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device available", file=sys.stderr)
        return 1
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    families = {"staggered": staggered, "double": double, "zoo": zoo,
                "mg": mg, "mrhs": mrhs, "mg_seeds": mg_seeds, "fold": fold}
    if which == "mrhs_variants":
        parent = sys.argv[2] if len(sys.argv) > 2 and sys.argv[2] != "-" \
            else None
        rest = sys.argv[3:]
        nbs = [int(a) for a in rest if a.isdigit()]
        mrhs_variants(torch, torch.device("cuda", 0), parent,
                      tuple(a for a in rest if not a.isdigit())
                      or ("eo", "stag", "clover", "fold"),
                      nbs[0] if nbs else None)
        return 0
    if which == "coarse_variants":
        parent = sys.argv[2] if len(sys.argv) > 2 and sys.argv[2] != "-" \
            else None
        coarse_variants(torch, torch.device("cuda", 0), parent)
        return 0
    if which == "sass":
        sass(sys.argv[2], tuple(sys.argv[3:]) or SASS_SOURCES)
        return 0
    if which == "mrhs_ab":
        mrhs_ab(torch, torch.device("cuda", 0), sys.argv[2],
                int(sys.argv[3]) if len(sys.argv) > 3 else None)
        return 0
    if which == "stag_mg":
        masses = tuple(float(m) for m in sys.argv[2:]) or (STAG_MG_MASS,)
        stag_mg(torch, torch.device("cuda", 0), masses)
        return 0
    if which not in ("all", "wilson") + tuple(families):
        print(f"chip_profile: unknown family {which!r}", file=sys.stderr)
        return 2
    if which in families:
        families[which](torch, torch.device("cuda", 0))
        return 0

    from quda_tpu_torch.fields.gauge import GaugeField
    from quda_tpu_torch.fields.geometry import LatticeGeometry
    from quda_tpu_torch.fields.spinor import ColorSpinorField, even_odd_split
    from quda_tpu_torch.models.clover import DiracCloverPC
    from quda_tpu_torch.models.wilson import DiracWilsonPC
    from quda_tpu_torch.ops import clover as qcl
    from quda_tpu_torch.ops import fmunu
    from quda_tpu_torch.solvers.block import batched_cg_pairs
    from quda_tpu_torch.solvers.fused_iter import fused_cg
    from quda_tpu_torch.solvers.mixed import cg_reliable, pair_inplace_codec

    dev = torch.device("cuda", 0)
    geom = LatticeGeometry(DIMS)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    gauge = GaugeField.random(geom, gen, dtype=torch.complex64,
                              device=dev).data
    src = ColorSpinorField.gaussian(geom, gen, dtype=torch.complex64,
                                    device=dev).data
    codec = pair_inplace_codec(torch.bfloat16)
    be, bo = even_odd_split(src, geom)
    halves = [even_odd_split(ColorSpinorField.gaussian(
        geom, gen, dtype=torch.complex64, device=dev).data, geom)
        for _ in range(NRHS)]
    be_b = torch.stack([h[0] for h in halves])
    bo_b = torch.stack([h[1] for h in halves])
    del halves
    for family, dirac in (
            ("", lambda: DiracWilsonPC(gauge, geom, 0.12).packed()),
            ("clover:", lambda: DiracCloverPC(gauge, geom, 0.12, 1.0))):
        d = dirac()
        op = d.pairs(torch.float32)
        lo = d.pairs(torch.bfloat16)
        rhs = op.Mdag_pairs(op.prepare_pairs(be, bo))

        def run_fused(n):
            return fused_cg(op.MdagM_pairs, rhs, tol=1e-30, maxiter=n)

        def run_reliable(n):
            return cg_reliable(op.MdagM_pairs, lo.MdagM_pairs, rhs,
                               tol=1e-30, maxiter=n, codec=codec)

        rhs_b = op.Mdag_pairs_mrhs(op.prepare_pairs_mrhs(be_b, bo_b))

        def run_batched(n):
            return batched_cg_pairs(op.MdagM_pairs_mrhs, rhs_b, tol=1e-30,
                                    maxiter=n)

        for label, run in (("fused_cg", run_fused),
                           ("cg_reliable", run_reliable),
                           (f"batched_cg_pairs[{NRHS}]", run_batched)):
            run(3)                                           # warm-up
            torch.cuda.synchronize()
            _profile(family + label, lambda: run(ITERS), torch)
        del d, op, lo, rhs, rhs_b

    def wall_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    DiracCloverPC(gauge, geom, 0.12, 1.0).pairs(torch.float32)  # warm-up
    _, f_ms = wall_ms(lambda: fmunu.field_strength(gauge))
    blocks, b_ms = wall_ms(lambda: qcl.clover_blocks(gauge, 0.06))
    _, inv_ms = wall_ms(lambda: qcl.invert_clover(
        even_odd_split(blocks, geom)[1]))
    d, pc_ms = wall_ms(lambda: DiracCloverPC(gauge, geom, 0.12, 1.0))
    _, pairs_ms = wall_ms(lambda: d.pairs(torch.float32))
    print(json.dumps({
        "clover_setup_ms": {"field_strength": f_ms,
                            "clover_blocks_with_field_strength": b_ms,
                            "invert_clover_half": inv_ms,
                            "DiracCloverPC": pc_ms, "pairs_f32": pairs_ms},
        "dims_xyzt": list(DIMS),
        "device": torch.cuda.get_device_name(0)}), flush=True)
    del gauge, src, be, bo, be_b, bo_b, d
    if which == "all":
        double(torch, dev)
        staggered(torch, dev)
        zoo(torch, dev)
        mg(torch, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
