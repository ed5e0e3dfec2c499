#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # 32^3 x 64, seed 0

Phases, one JSON line each (``"phase": ...``):

1. device  — the card, as torch and nvidia-smi name it.
2. build   — builds the CUDA kernels from quda_tpu_torch/csrc (nvcc, one
             process per source, in parallel) and reports the seconds and
             ptxas' register counts.
3. check   — each kernel against its plain PyTorch version on the card, on
             the same inputs: every form of the eo hop (B1: full/r12 links,
             f32/bf16 storage, f32/bf16 output) for both target parities at
             4x6x8x10 and at the production size, the CG tail (B2) and
             axpy_norm2 (B3, f32 and bf16) at the production half-lattice
             size, and every form of the fused clover hop (B7: K1 post and
             K2 diag_hop, full/r12 links, f32/bf16 storage) for both target
             parities at 4x6x8x10 and at the production size, and the
             multi-RHS kernels (B5-eo and K1/K2-mrhs, f32, full/r12 links)
             at N = 1, 3 and 12 on 4x6x8x10 (both parities) and at N = 12
             on the production size, against their plain versions and
             against N launches of the single-RHS kernel.  Fails above the
             tolerance the kernel's module states, or unless every lane of
             a multi-RHS kernel is its single-RHS launch (B1, K1, K2) bit
             for bit.
4. invert  — the main path at the production size: a random SU(3) gauge and
             a Gaussian source made on the card from a seeded
             torch.Generator, init_quda -> load_gauge_quda ->
             invert_quda(wilson, cg, normop-pc, single) -> end_quda.  Fails
             unless converged, true_res <= 1e-5, the eo hop kernel ran at
             least 4x and the tail kernel at least 1x per iteration (counts
             zeroed just before the call).
   invert_mixed — the same solve at single/half (bf16 sloppy, reliable
             updates), once with full links and once with recon-12
             (GaugeParam.reconstruct=12).  Fails unless converged,
             true_res <= 1e-5, bf16 eo-hop launches >= 4x and B3 launches
             >= 1x the iterations, at least one reliable update, and (r12)
             R=2 eo-hop launches >= 4x the iterations.
   invert_df64 — tol 1e-10 at single/single: the df64 route.  Fails unless
             its df64 full-lattice true_res <= 1e-10 and an independent
             complex128 residual of x + x_df64_lo, with the plain
             full-lattice operator (ops/wilson.py) on the card, agrees.
   invert_clover — dslash_type="clover", csw 1.0, on the same gauge and
             source: single/single, single/half with full links and with
             recon-12.  Fails unless converged, true_res <= 1e-5, every
             clover block positive definite (a block without a Cholesky
             factor is reported on this phase line first), K1 and K2 each
             launched >= 2x per iteration and, for half, B3 >= 1x per
             iteration with a reliable update.
   invert_multi_src — invert_multi_src_quda with 12 Gaussian sources (a
             generator of their own) on the same gauge: Wilson batched
             with full links, with recon-12, with block CG
             (QUDA_TORCH_MULTI_SRC_BLOCK=1); clover (csw 1.0) batched,
             full and recon-12.  Fails unless every lane converged with
             true_res <= 1e-5, lane 0 is within 2 iterations of
             invert_quda on source 0, B5-eo ran 4x (Wilson) or K1-mrhs and
             K2-mrhs 2x (clover) per iteration, and no single-RHS hop (B1,
             K1, K2) ran inside the batched solve.
5. reference — the same solves at 4x6x8x10 on the card and on the CPU (the
             plain path): single/single within 1e-4 and 2 iterations,
             single/half within 1e-3 and 10% of the iterations; the clover
             single/single solve (csw 1.0) within 1e-4 and 2 iterations;
             3-source invert_multi_src_quda, Wilson and clover, within
             1e-4 and 2 iterations per lane.
6. timing  — medians of 25 CUDA-event timings (each over 10 back-to-back
             calls) of each kernel form and its plain version at the
             production size, beside the bound (the larger of bytes over
             3.35 TB/s and flops over 67 TFLOP/s f32), and the seconds per
             iteration of fused_cg (f32) and of cg_reliable (single/half,
             full and r12 links; reliable updates included), for the Wilson
             and for the clover operator; each multi-RHS form at N = 12 at
             every chunk width, beside 12 launches of its single-RHS form
             and its bound from bytes_per_site_mrhs; and the milliseconds
             per 12-source batched_cg_pairs iteration against 12 fused_cg
             iterations.

6a. Wilson quarter precision and the copy-free link forms (ROADMAP A7,
   B9, B10-eo) on the main path's gauge and sources (fields of the
   checks from a generator of their own):
   check   — the copy-free hop (v3 and r12f wrappers, one kernel: B1's
             six f32/bf16 forms) against its plain version and bit for
             bit B1 on the backward_gauge_eo copy; the int8 hop
             (f32->f32, bf16->bf16, bf16->f32) against its plain version
             and bit for bit B1 f32 on from_int8_links(q, s); the
             multi-RHS r12f hop (R = 3, 2; N = 1, 3, 12 at 4x6x8x10, 12 at
             32^3 x 64) against its plain version and lane by lane r12f;
             at 4x6x8x10 and 32^3 x 64, both parities.
   invert_quarter — invert_quda(cuda_prec_sloppy="quarter") at tol 1e-6
             (cg_reliable, int8 bf16 sloppy links) and 1e-10 (df64).
             Fails unless converged, true_res <= 1e-5 (<= 1e-10, also in
             complex128 on x + x_df64_lo) and the int8 hop ran >= 4 times
             an iteration; iterations and reliable updates beside
             single/half's and df64 single's.
   precision_solve — fused_cg on the f32 pair operators full, r12, v3
             (full), r12f and int8; cg_reliable on full, r12, v3 and r12f
             with their bf16 twins; 12 sources batched on r12 (B5-eo) and
             r12f (multi-RHS r12f).  Fails unless v3 and r12f take their
             twins' iterations to the same solution bits, every lane of
             the r12f batch its r12 lane's, and each form runs its own
             kernel only (>= 4 launches an iteration).
   timing  ("family": "precision") — each form's ms, bound, share and
             plain ms, launches and launches per iteration on its path,
             the resident link bytes of each pair operator
             (torch.cuda.memory_allocated around its construction).

7. The full-lattice hop and native double (BASELINE configs 1 and 2;
   fields from a generator of their own):
   check   — B4 (full-lattice hop: full:f32->f32, r12:f32->f32,
             full:f64->f64) at 14x12x10x8 (both t boundary signs) and
             32^3 x 64, B1's full:f64->f64 at 4x6x8x10 and 32^3 x 64, and
             B2's f64 form, against their plain versions (f64 within 1e-12).
   dslash  — dslash_quda, mat_quda and mat_dag_mat_quda at 32^3 x 64
             (single full, single recon-12, double) and 8^4 (double, config
             1) against the complex128 operators on the card; each call
             runs B1 once and B4 three times; B4's ms, share of bound and
             GFLOPS at 1320 flop/site.
   invert_double — invert_quda at tol 1e-10, double/single and
             double/double at 32^3 x 64 and 16^4 (config 2), and the df64
             route at 32^3 x 64: true_res <= 1e-10 by the solve and by a
             complex128 recomputation; double/double on B1 and B2 in f64,
             double/single on B1 f32 with B1 f64 at the reliable updates;
             then a line comparing the three at 32^3 x 64.
   timing  — B4, B1 f64 and B2 f64 against their bounds (f64 flops at
             34 TFLOP/s).

7a. The operator API of the clover, twisted and domain-wall families, the
   full-lattice kernels and the tuned dslash (ROADMAP A19, A17's tuner;
   a hot gauge and a source of their own at 32^3 x 64, kappa 0.12, csw
   1.0, mu 0.1):
   check   — B10 (the copy-free full-lattice hop, full and r12) against
             its plain version and bit for bit B4 on the backward_gauge
             copy, at 14x12x10x8 (both t boundary signs) and 32^3 x 64;
             B7 full (the full-lattice clover operator, full and r12, with
             and without the twist) within 1e-5 of its plain version; B11
             (the canonical-layout hop, f32 and f64) against its plain
             version, f32 bit for bit B10 on the packed fields.
   dslash  ("family": "zoo") — mat_quda and mat_dag_mat_quda for clover,
             twisted clover and twisted mass (full and recon-12 links;
             twisted mass also at double) within 1e-5 (1e-12) of the
             complex128 operators, each call one and two launches of B7
             full (or B4) and no other hop; the doublets and the
             domain-wall family (Ls 12) on their complex operators, single
             against double, with their seconds (the 4d-PC Möbius
             dslash_quda refused: no PC hop, as in the JAX package).
   dslash_canonical — dslash_pallas (B11) on complex64 and complex128
             fields through its public entry: one launch each, within
             1e-5 (1e-12) of the complex128 stencil.
   tune    — tuned_dslash with tuning on and a fresh resource path: the
             four candidates' times, the winner, the cache file written,
             B4 and B10 launched in the race, the output within 1e-5.
   timing  ("family": "operator_zoo") — every new form's ms, plain ms,
             bound and share; B10 beside B4 in the same call.

8. The staggered family at 32^4 (BASELINE config 4; a random SU(3) gauge
   and a one-spin Gaussian source from a generator of their own, m 0.1):
   check   — every S1 (fused fat + Naik hop) and S2 (gather pass, fat and
             Naik) form against its plain version at 8x10x12x14 (every
             extent >= 7) and 32^4, both parities (1e-5 f32, one bf16 ulp
             bf16), and S1 = S2(fat) + S2(naik) within 1e-6; S2-mrhs (the
             multi-RHS gather pass, fat and Naik) at 8x10x12x14 (N = 3 and
             12) and 32^4 (N = 12), both parities, against its plain
             version, each lane bit for bit against single S2 launches,
             and its fat + Naik composition bit for bit S1, lane by lane.
   hisq    — compute_ks_link_quda: seconds, max |W^dag W - 1| (<= 1e-5),
             the norms of the fat and long links.
   invert_staggered — invert_quda at tol 1e-6: hisq single/single and
             single/half, asqtad (load_fat_long_quda of the same links),
             fat-only staggered single and half.  Fails unless converged
             with true_res <= 1e-5, hisq and asqtad take the same
             iterations, S1 runs exactly 2 per fused_cg iteration (+2) on
             hisq/asqtad, the fat-only path runs S2 and no S1, and no
             plain stencil runs.
   invert_multishift — invert_multishift_quda, 8 offsets: every shift
             converged, each with |rhs - (M_pc + s_i) x_i| / |rhs| <= 1e-5
             by the complex128 PC operator, through S1.
   invert_multi_src ("family": "staggered") — invert_multi_src_quda with
             12 one-spin sources (a generator of their own), hisq and
             fat-only: every lane converged with true_res <= 1e-5 and the
             iterations invert_quda takes on that source; S2-mrhs launched
             4 (hisq) or 2 (fat-only) times per iteration plus prepare and
             reconstruct, and no single-RHS hop or plain stencil.
   reference — an 8^4 hisq solve on the card and on the CPU.
   timing  — each S1/S2 form and its plain version beside its bound;
             S2-mrhs at N = 12 beside 12 single S2 launches; ms per iteration of fused_cg (hisq, fat-only),
             cg_reliable (hisq single/half), an 8-shift multishift_cg and
             a 12-source batched_cg_pairs (hisq, fat-only) against 12
             fused_cg iterations.

8a. The fold layout and the staggered copy-free v3 pass (ROADMAP A7, B9,
   B6) on the Wilson main path's gauge and sources (kappa 0.12, 32^3 x 64)
   and phase 8's 32^4 HISQ links (m 0.1); fields of the checks from a
   generator of their own:
   check   — the fold hop (B1's six forms, R = 3 and 2) bit for bit
             to_fold of B1 on the unfolded operands, the multi-RHS fold
             hop (N = 1, 3, 12; 12 at 32^3 x 64) lane by lane the fold
             hop, at 4x6x8x10 and 32^3 x 64; S1-fold (three forms) bit for
             bit to_fold of S1, the v3 pass (fat and Naik, six forms) bit
             for bit S2 on the backward_links_eo copy, the improved v3 hop
             bit for bit S1, at 8x10x12x14 and 32^4; both parities, each
             within its tolerance of its plain version.
   fold_solve — Wilson fused_cg on the f32 fold operator, cg_reliable with
             a bf16 fold sloppy operator and 12 sources batched on the
             multi-RHS fold hop; staggered fused_cg and cg_reliable (bf16
             sloppy) on hisq fold and v3 and on fat-only v3.  Fails unless
             each takes its twin's (full, fused or two_pass) iterations
             and reliable updates to the same solution bits, runs its own
             kernel (fold 4 an iteration, S1-fold 2, improved v3 4,
             fat-only v3 2 on fused_cg) and no B1, B5-eo, S1 or S2.
             Each row has the solve's seconds; the 12-source fold row
             also its full twin's, and both ms an iteration.
   timing  ("family": "fold_v3") — each form's ms, bound, share, plain ms
             and its twin's ms in the same call, its launches on its
             path; the multi-RHS fold hop's resources (R = 3 and 2), held
             to fold_mrhs_plan; the to_fold / from_fold copies of one fold
             hop; ms per fused_cg iteration of each form against its
             twin's.  The kernels line's fold-mrhs row carries the R = 2
             form's times beside its own.

8b. The multi-device Wilson path (ROADMAP A15, B12) on virtual meshes of
   MESH_N = 8 sub-domains, all on the card, with the main path's gauge
   and source (kappa 0.12, 32^3 x 64); fields of the checks from a
   generator of their own:
   check   — the exchange kernel (slab_exchange_bidir) on the t, z and y
             faces of the (2,2,2,1) mesh, f32 and bf16, bit for bit its
             plain transport, one launch a call; the fused-halo hops
             (wilson_axis_fused_halo z and t, wilson_zbwd_fused_halo) on
             8 sub-domains at the half-lattice volume within 1e-6 of their
             plain versions and of the composed references on the
             gathered fields; the sharded eo hop, both parities, v2
             (full, r12) on (2,2,2,1) with t,z,y on fused_halo, v2 on
             (2,2,1,2) (the x column fix), v3 on (2,4,1,1): fused_halo bit
             for bit xla_facefix, within 1e-6 (norm ratio) of the
             unsharded B1 / B10-eo.
   invert_mesh — fused_cg on the (2,2,2,1) operator with the default
             sharded_policy ("auto": t,z,y on the exchange kernel), beside the unsharded fused_cg on the same
             system.  Fails unless converged in the unsharded iterations
             +-1, true_res (the full operator, complex64) <= tol, and an
             iteration launched exactly 12 exchanges, 32 B1 and 8 B2; and
             unless sharded_policy "auto" is the exchange kernel on t/z/y.
   timing  ("family": "mesh") — each halo kernel's device time (the
             profiler's, the L2 flushed before each call; the exchange on
             the faces as the hop hands them, strided views of its
             blocks), its call time, its plain version's and (the
             exchange) the same transfers by Tensor.copy_, beside the
             bound; one sharded eo hop under each policy beside B1: wall
             time (interleaved), device time, device launches, busy share.

9. The twisted and domain-wall families at 32^3 x 64 (ROADMAP A10; a
   random SU(3) gauge and sources from a generator of their own; kappa
   0.12, mu 0.1, epsilon 0.05, csw 1.0; Ls 12, m5 -1.8, b5 1.5, c5 0.5,
   mf 0.1):
   check   — every twist form of K1/K2 (K1 block-free twist, K2 twist
             and blocks + twist; full/r12 links, f32/bf16 storage) and
             of K1/K2-mrhs (f32, N = 12) against its plain version at
             both target parities (1e-6 f32, one bf16 ulp bf16), each
             K1/K2-mrhs lane bit for bit its K1/K2 launch.
   invert_twisted — invert_quda, twisted-mass and twisted-clover,
             single and single/half, full and recon-12 links: converged,
             true_res <= 1e-5, K1 and K2 twice an iteration in their
             twist forms (twisted clover: K1 on its inverse blocks).
   invert_multi_src ("family": "twisted-*") — 12 sources batched on
             K1/K2-mrhs, full and recon-12: every lane converged, in the
             iterations invert_quda takes on its source, no single-RHS
             hop.
   invert_doublet — ndeg-twisted-mass and ndeg-twisted-clover: the
             staged composition, B1 once per flavour (8 an iteration).
   invert_dwf — mobius (full, r12), domain-wall-4d, domain-wall (5d PC)
             at Ls 12, mobius-eofa at 16^4: converged, true_res <= 1e-5,
             the 4d hop on B5-eo with N = Ls (4 an iteration; 8 for the
             5d PC, one per parity group), no B1.
   timing  — each twist form and B5-eo at N = Ls against its bound and
             plain version (K1/K2-mrhs and B5-eo with their query entries'
             resources, held to their wrappers' plans); ms per iteration
             of fused_cg and cg_reliable (twisted), 12-source
             batched_cg_pairs against 12 fused_cg iterations, and Möbius
             and 5d-PC fused_cg at Ls 12.

10. The Wilson multigrid at 32^3 x 64 (ROADMAP A12, A14; a generator of
   its own):
   gauge_gen — a quenched gauge from a cold start: MG_HB_SWEEPS heatbath
             sweeps at beta 6.0, each followed by MG_OR_PER_HB
             overrelaxation sweeps (complex128), the plaquette every 10
             sweeps.  Fails unless the plaquette is within 0.001 of the
             published 0.5937, its mean over the last 50 sweeps is within
             2e-4 of its mean over the 50 before (equilibrium: a gauge
             still falling from the cold start fails), and the links are
             unitary.
   invert_cg — load_gauge_quda, plaq_quda, and the baseline: Wilson
             invert_quda CG (normop-pc, fused_cg, tol 1e-6) at kappa
             0.155.  Fails unless it converges in >= 300 iterations.
   mg_setup — new_multigrid_quda: 3 levels, blocks 4^4 then 2^4, n_vec
             24, BiCGStab null vectors from M v = 0; the seconds per
             level and phase, verify(), launches.
             Fails unless R P = 1 and Galerkin hold to 1e-4 at every level.
   invert_mg — invert_quda(inv_type="gcr-mg", solve_type="direct") twice
             on the same source.  Fails unless converged with true_res <=
             1e-5 in fewer outer iterations than the CG, and the second
             solve reuses the hierarchy (no B5 launch).
   check   — B5 at N = 24 and 12 against its plain version and each lane
             bit for bit against B4; B8 at both coarse levels and its
             multi-RHS form at N = 24 against their plain versions.
   timing  — B5 against 24 B4 launches, B8 and B8-mrhs against the einsum
             (their library call) and their bounds; B8 at each coarse
             level with its launches on the main path (counted by (S, E)),
             share of bound and resources (registers, shared memory,
             blocks an SM, rows a tile, lanes a row, grid), held to
             coarse_plan.  The kernels line has one B8 row a level.

11. The staggered/HISQ multigrid at 32^3 x 64 on family 10's gauge
   (ROADMAP A12, B6; a generator of its own):
   hisq_mg — compute_ks_link_quda on the heatbath gauge: seconds, max
             |W^dag W - 1| (<= 1e-5).
   invert_stag_cg — the baseline: hisq invert_quda (PC CG, fused_cg,
             tol 1e-6) at the light mass STAG_MG_MASS.  Fails unless it
             converges in >= 500 iterations.
   stag_mg_setup — new_multigrid_quda for hisq: MG_PARAMS' 3 levels on
             the fat-link stencil (S2-mrhs-full for the level-0 null
             vectors: CG on the normal equations, projected guesses; GCR
             smoothing); seconds by level and phase, peak memory.  Fails
             unless verify <= 1e-4 at every level.
   invert_stag_mg — invert_quda(gcr-mg) twice on one source: the outer
             GCR on the fat + Naik operator (S1-full), the V-cycle on
             S2-full and B8.  Fails unless converged with true_res <= 1e-5
             (also by the complex128 operator) in fewer outer iterations
             than the CG, and the second solve reuses the hierarchy (no
             S2-mrhs-full launch).
   dslash  ("family": "staggered") — mat_quda and mat_dag_mat_quda for
             hisq (S1-full) and fat-only staggered (S2-full) within 1e-5
             of the complex128 operators, 3 launches each; double refused
             naming A7; S1-full and S2-full at 32^3 x 64 and 32^4: ms,
             share of bound, GFLOPS at 1146 and 570 flop/site.
   check   — S2-full (fat, Naik), S1-full and S2-mrhs-full (N = 3, 24)
             against their plain versions at 8x10x12x14 and 32^3 x 64
             (1e-6), S2-mrhs-full lanes and its fat + Naik composition bit
             for bit S2-full and S1-full, S1-full bit for bit S2-full(fat)
             + S2-full(naik), and S1-full and S2-full on one parity
             against the eo kernels S1 and S2.
   timing  — S2-mrhs-full at N = 24 against 24 S2-full launches; each
             form against its plain version and its bound.

Then the ``kernels`` line, the card's ``name, power limit`` as nvidia-smi
prints them, and ``{"ok": true, ...}`` last.  Without a card (or without
the quda_tpu_torch package beside it) the script exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

PROD_DIMS = (32, 32, 32, 64)     # (X, Y, Z, T)
SMALL_DIMS = (4, 6, 8, 10)
SEED = 0
KAPPA = 0.12
TOL = 1e-6
TRUE_RES_MAX = 1e-5
CSW = 1.0
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, published
F32_FLOPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
F64_FLOPS_PER_S = 34e12          # H100 SXM f64 outside the tensor cores
F64_TOLERANCE = 1e-12            # an f64 kernel against its plain version
# the full-lattice hop and the double routes: a non-cubic lattice (T, Z,
# Y, X = 14, 12, 10, 8), BASELINE config 1 (Wilson Dslash, 8^4, double)
# and config 2 (Wilson CG, 16^4, mixed double/single)
FULL_SMALL_DIMS = (8, 10, 12, 14)
CONFIG1_DIMS = (8, 8, 8, 8)
CONFIG2_DIMS = (16, 16, 16, 16)
REPEATS = 25
BATCH = 10                       # calls per timed CUDA-event interval
DF64_TOL = 1e-10
MIXED_ITER_TIMED = 30
MULTI_SRC_N = 12                 # sources of the multi-source phase
BATCHED_ITER_TIMED = 20
# the staggered phases: BASELINE config 4's volume, the JAX package's
# staggered solver mass (bench_suite.py), and 8 RHMC-like shifts
STAG_DIMS = (32, 32, 32, 32)
STAG_SMALL_DIMS = (8, 10, 12, 14)  # every extent >= 7: no aliased 3-hop
STAG_MASS = 0.1
STAG_SHIFTS = (0.0, 5e-4, 2e-3, 8e-3, 3e-2, 0.12, 0.5, 2.0)
STAG_ITER_TIMED = 30
# the twisted and domain-wall phases (ROADMAP A10): a = 2 kappa mu, b = 2
# kappa epsilon; the twist of the kernel checks is larger, so the
# epilogue moves the output well above the tolerance
ZOO_MU = 0.1
ZOO_EPS = 0.05
ZOO_CHECK_A = 0.3
ZOO_MAXITER = 5000
# Möbius / domain wall at full width: Ls 12, b5 1.5, c5 0.5, m5 -1.8 (QUDA
# sign), and a quark mass at which the hot gauge converges; EOFA on a
# smaller lattice, with the JAX package's test masses and shift
DWF_LS = 12
DWF_MASS = 0.1
DWF_M5 = -1.8
DWF_B5, DWF_C5 = 1.5, 0.5
EOFA_DIMS = (16, 16, 16, 16)
EOFA_MQ = (0.04, 0.5, 1.0)
EOFA_SHIFT = 0.3
# the multigrid family (ROADMAP A12, A14): a quenched gauge generated from
# a cold start at beta 6.0 (heatbath sweeps, each followed by
# overrelaxation sweeps), gated on the published plaquette; kappa near
# the quenched kappa_c ~ 0.157, where CG needs hundreds of iterations; 3
# levels, blocks 4^4 then 2^4 (coarse lattices 8^3 x 16 and 4^3 x 8),
# n_vec 24 at both, null vectors from M v = 0 and a random guess (QUDA's
# set-up)
MG_BETA = 6.0
MG_PLAQ = 0.5937                 # quenched <P> at beta 6.0, published
MG_PLAQ_TOL = 1e-3
MG_PLAQ_DRIFT = 2e-4             # last 50 sweeps' mean against the 50 before
MG_HB_SWEEPS = 40
MG_OR_PER_HB = 4
MG_KAPPA = 0.155
MG_CG_MIN_ITERS = 300
MG_NVEC = 24
MG_PARAMS = dict(n_level=3, geo_block_size=((4, 4, 4, 4), (2, 2, 2, 2)),
                 n_vec=(MG_NVEC, MG_NVEC), setup_iters=(150, 150))
MG_VERIFY_TOL = 1e-4
# the staggered/HISQ multigrid on multigrid()'s gauge (ROADMAP A12, B6):
# HISQ links of the beta 6.0 gauge, a light mass picked on the card (m <=
# 0.02; PERF.md), MG_PARAMS' hierarchy on the fat-link stencil, the outer
# GCR on the fat + Naik operator
STAG_MG_MASS = 0.005
STAG_MG_CG_MIN_ITERS = 500
STAG_FULL_TOL = 1e-6             # a full-lattice staggered form, f32
# the multi-device path (block 8b): virtual meshes of MESH_N sub-domains on
# one card, the CG mesh with every contiguous axis on the exchange kernel
MESH_N = 8
MESH_GRID = (2, 2, 2, 1)         # (t, z, y, x) sub-domains
MESH_GRID_X = (2, 2, 1, 2)       # the x column fix
MESH_GRID_TZ = (2, 4, 1, 1)      # v3: t/z meshes only
MESH_POLICY = "t=fused_halo,z=fused_halo,y=fused_halo"
MESH_POLICY_TZ = "t=fused_halo,z=fused_halo"
MESH_HOP_TOL = 1e-6              # sharded against unsharded, norm ratio


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def median_ms(fn, torch, repeats=REPEATS, batch=BATCH) -> float:
    """Milliseconds per call: the median over ``repeats`` CUDA-event
    timings, each of ``batch`` back-to-back calls divided by ``batch``,
    after two warm-up calls.  Back to back, the host enqueues the next
    call while the card runs this one, so the wrapper's host work does
    not count as kernel time.  The production-size inputs exceed the
    50 MB L2, so no call finds its operands cached."""
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
    return statistics.median(times)


def device_ms(fn, torch, calls=20, flush=None):
    """Device milliseconds per call: the CUDA time of every kernel and copy
    that ``fn`` runs, summed by torch.profiler (CUPTI) over ``calls`` calls
    after two warm-up calls (device events only: an aten op's own device
    time is its kernels', counted once).  Unlike ``median_ms`` it leaves
    out the host's time between launches, which rules a call of a few
    microseconds of device work.  ``flush`` runs before each call and its
    kernels are left out of the sum: a write larger than the L2 makes
    every call read its inputs from device memory.  Fails when the
    profiler sees no device time of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def profiled(f):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                if flush is not None:
                    flush()
                if f is not None:
                    f()
            torch.cuda.synchronize()
        return {e.key: e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA}

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    skip = set(profiled(None)) if flush is not None else set()
    total = sum(t for k, t in profiled(fn).items() if k not in skip)
    if total <= 0:
        fail("torch.profiler saw no device time: no kernel time can be "
             "reported")
    return total / 1e3 / calls


def l2_flush(torch, dev):
    """A callable that writes 256 MB on ``dev`` (five times the H100's
    50 MB L2), so the next call reads its inputs from device memory."""
    buf = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    return buf.zero_


def hop_profile(calls: dict, torch, rounds=10):
    """Each named call's wall milliseconds (synchronized before and after,
    so host time counts; the calls interleaved round by round, so drift
    of the host falls on all alike: the median), and per call the
    profiler's device milliseconds and device kernels and copies, and the
    device's busy share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    walls = {k: [] for k in calls}
    for fn in calls.values():
        fn()
    for _ in range(rounds):
        for k, fn in calls.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[k].append(1e3 * (time.perf_counter() - t0))
    out = {}
    for k, fn in calls.items():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
        dev_ms = sum(e.self_device_time_total for e in evs) / 1e3 / 3
        wall = statistics.median(walls[k])
        out[k] = {"wall_ms": wall, "wall_ms_min": min(walls[k]),
                  "wall_ms_max": max(walls[k]), "device_ms": dev_ms,
                  "device_launches": sum(e.count for e in evs) / 3,
                  "device_busy_share": dev_ms / wall}
    return out


def staggered(torch, dev, smi):
    """The staggered slice at BASELINE config 4's 32^4 (phases check,
    hisq, invert_staggered, invert_multishift, reference, timing); returns
    the kernels-line rows of S1 and S2, and the HISQ links, the fat-only
    gauge and the source (for the fold and v3 block)."""
    import numpy as np

    import quda_tpu_torch as qt
    from quda_tpu_torch.fields.gauge import GaugeField
    from quda_tpu_torch.fields.geometry import LatticeGeometry
    from quda_tpu_torch.fields.spinor import (ColorSpinorField,
                                              even_odd_split)
    from quda_tpu_torch.gauge import hisq
    from quda_tpu_torch.models.staggered import DiracStaggeredPC
    from quda_tpu_torch.ops import blas_pallas as bpl
    from quda_tpu_torch.ops import staggered_packed as spk
    from quda_tpu_torch.ops import staggered_pallas as spl
    from quda_tpu_torch.solvers.block import batched_cg_pairs
    from quda_tpu_torch.solvers.fused_iter import fused_cg
    from quda_tpu_torch.solvers.mixed import cg_reliable, pair_inplace_codec
    from quda_tpu_torch.solvers.multishift import multishift_cg

    f32, bf16 = torch.float32, torch.bfloat16
    forms = [(f32, f32), (bf16, bf16), (bf16, f32)]
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)

    # -- check: every S1 and S2 form against its plain version ----------
    def inputs(dims_xyzt, store, g=gen):
        """fat/long here/there (long at 1/24 the scale) and psi."""
        T, Z, Y, X = LatticeGeometry(dims_xyzt).lattice_shape
        sites = (T, Z, Y * X // 2)
        links = [torch.randn((4, 3, 3, 2) + sites, generator=g,
                             device=dev) * (1.0 if i < 2 else 1.0 / 24)
                 for i in range(4)]
        psi = torch.randn((3, 2) + sites, generator=g, device=dev)
        return ((T, Z, Y, X), [u.to(store).contiguous() for u in links],
                psi.to(store))

    def pass_args(links, dims, parity, nhop):
        here, there = (links[0], links[1]) if nhop == 1 else \
            (links[2], links[3])
        return here, spl.backward_links_eo(there, dims, parity,
                                           nhop).contiguous()

    errs = {}
    for store, out in forms:
        tol = spl.TOLERANCE if out == f32 else spl.TOLERANCE_BF16
        for dims_xyzt in (STAG_SMALL_DIMS, STAG_DIMS):
            for parity in (0, 1):
                dims, links, psi = inputs(dims_xyzt, store)
                cases = {spl.form_name(store, out): (
                    spl.dslash_staggered_eo_pallas_fused(
                        links[0], links[1], psi, dims, parity, links[2],
                        links[3], out_dtype=out),
                    spl.dslash_staggered_eo_fused_plain(
                        links[0], links[1], psi, dims, parity, links[2],
                        links[3], out_dtype=out))}
                for nhop in (1, 3):
                    here, bw = pass_args(links, dims, parity, nhop)
                    cases[spl.pass_form_name(nhop, store, out)] = (
                        spl.dslash_staggered_eo_pass(here, bw, psi, dims,
                                                     parity, nhop, out),
                        spl.dslash_staggered_eo_pass_plain(
                            here, bw, psi, dims, parity, nhop, out))
                torch.cuda.synchronize()
                row = {"phase": "check", "kernel": "staggered",
                       "dims_xyzt": list(dims_xyzt), "parity": parity,
                       "tolerance": tol}
                for name, (got, want) in cases.items():
                    abs_err = (got.float() - want.float()).abs().max().item()
                    rel = abs_err / want.float().abs().max().item()
                    errs[name] = max(errs.get(name, 0.0), abs_err)
                    row[name] = {"max_abs_err": abs_err, "max_rel_err": rel}
                    if not (rel <= tol and got.dtype == out):
                        emit(row)
                        fail(f"staggered kernel {name} disagrees with its "
                             f"plain version: {rel:.3e} > {tol:g}")
                if store == f32:
                    fused = cases[spl.form_name(f32, f32)][0]
                    two = (cases["fat:f32->f32"][0]
                           + cases["naik:f32->f32"][0])
                    rel = ((fused - two).abs().max()
                           / two.abs().max()).item()
                    row["s1_minus_s2_sum_rel"] = rel
                    if not rel <= 1e-6:
                        emit(row)
                        fail(f"S1 != S2(fat) + S2(naik): {rel:.3e}")
                emit(row)
                del links, psi, cases

    # -- check: S2-mrhs (fat, Naik, their composition) ------------------
    # against its plain version, each lane bit for bit against single S2
    # launches (fat, Naik) and its fat + Naik composition against S1
    mrhs_names = [spl.pass_form_name(nhop, f32, f32) for nhop in (1, 3)]
    for name in mrhs_names:
        errs[f"mrhs:{name}"] = 0.0
    # a generator of its own, so the later phases see the fields earlier
    # versions of this script made
    gen_m = torch.Generator(device=dev).manual_seed(SEED + 10)

    def mrhs_psi(dims, n):
        T, Z, Y, X = dims
        return torch.randn((n, 3, 2, T, Z, Y * X // 2), generator=gen_m,
                           device=dev)

    for dims_xyzt, n, parities in ((STAG_SMALL_DIMS, 3, (0, 1)),
                                   (STAG_SMALL_DIMS, MULTI_SRC_N, (0, 1)),
                                   (STAG_DIMS, MULTI_SRC_N, (0, 1))):
        for parity in parities:
            dims, links, _ = inputs(dims_xyzt, f32, gen_m)
            psi_b = mrhs_psi(dims, n)
            row = {"phase": "check", "kernel": "staggered_mrhs",
                   "dims_xyzt": list(dims_xyzt), "parity": parity,
                   "nrhs": n, "chunk": spl.MRHS_CHUNK,
                   "tolerance": spl.TOLERANCE}
            passes = {}
            for nhop, name in zip((1, 3), mrhs_names):
                here, bw = pass_args(links, dims, parity, nhop)
                got = spl.dslash_staggered_eo_pass_mrhs(here, bw, psi_b,
                                                        dims, parity, nhop)
                want = spl.dslash_staggered_eo_pass_mrhs_plain(
                    here, bw, psi_b, dims, parity, nhop)
                lanes = all(torch.equal(got[r], spl.dslash_staggered_eo_pass(
                    here, bw, psi_b[r], dims, parity, nhop)) for r in range(n))
                torch.cuda.synchronize()
                abs_err = (got - want).abs().max().item()
                rel = abs_err / want.abs().max().item()
                errs[f"mrhs:{name}"] = max(errs[f"mrhs:{name}"], abs_err)
                row[name] = {"max_abs_err": abs_err, "max_rel_err": rel,
                             "lanes_equal_single_s2": lanes}
                passes[nhop] = (here, bw)
                if not (rel <= spl.TOLERANCE and lanes):
                    emit(row)
                    fail(f"S2-mrhs {name} disagrees with its plain version "
                         f"({rel:.3e}) or with single S2 launches")
                del got, want
            both = spl.dslash_staggered_eo_pallas_mrhs(
                *passes[1], psi_b, dims, parity, *passes[3])
            s1_equal = all(torch.equal(both[r], spl.dslash_staggered_eo_pallas_fused(
                links[0], links[1], psi_b[r], dims, parity, links[2],
                links[3])) for r in range(n))
            torch.cuda.synchronize()
            row["fat_plus_naik_lanes_equal_s1"] = s1_equal
            emit(row)
            if not s1_equal:
                fail("S2-mrhs fat + Naik is not S1 lane by lane, bit for bit")
            del links, psi_b, passes, both

    # -- hisq: compute_ks_link_quda at 32^4 ------------------------------
    geom = LatticeGeometry(STAG_DIMS)
    gauge = GaugeField.random(geom, gen, dtype=torch.complex64,
                              device=dev).data
    src = ColorSpinorField.gaussian(geom, gen, nspin=1,
                                    dtype=torch.complex64, device=dev).data
    # the multi-source phase's sources: a generator of their own
    gen_src = torch.Generator(device=dev).manual_seed(SEED + 11)
    srcs_s = torch.stack([ColorSpinorField.gaussian(
        geom, gen_src, nspin=1, dtype=torch.complex64, device=dev).data
        for _ in range(MULTI_SRC_N)])
    multi_s = {}
    qt.init_quda(dev)
    qt.load_gauge_quda(gauge, qt.GaugeParam(X=STAG_DIMS, cuda_prec="single"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    links = qt.compute_ks_link_quda()
    torch.cuda.synchronize()
    ks_secs = time.perf_counter() - t0
    w_dev = hisq.unitarity_violation(links.w_unitarized)
    fat, lng = links.fat, links.long
    del links
    row = {"phase": "hisq", "dims_xyzt": list(STAG_DIMS),
           "seconds": ks_secs, "max_abs_WdagW_minus_1": w_dev,
           "fat_norm": torch.linalg.vector_norm(fat).item(),
           "long_norm": torch.linalg.vector_norm(lng).item(),
           "fat_max_abs": fat.abs().max().item(),
           "long_max_abs": lng.abs().max().item()}
    emit(row)
    if not (w_dev <= 1e-5 and bool(torch.isfinite(
            torch.view_as_real(fat)).all()) and bool(torch.isfinite(
            torch.view_as_real(lng)).all())):
        fail(f"compute_ks_link_quda: W not unitary ({w_dev:.3e}) or "
             "non-finite links")

    # -- invert_staggered ------------------------------------------------
    # every plain stencil of the staggered path counts its calls: none may
    # run on the card's main paths
    plain_calls = {"n": 0}

    def counting(fn):
        def wrapped(*a, **k):
            plain_calls["n"] += 1
            return fn(*a, **k)
        return wrapped

    originals = {(m, n): getattr(m, n) for m, n in (
        (spl, "dslash_staggered_eo_fused_plain"),
        (spl, "dslash_staggered_eo_pass_plain"),
        (spl, "dslash_staggered_eo_pass_mrhs_plain"), (spk, "hopset_pairs"),
        (spk, "dslash_staggered_eo_packed_pairs"))}
    for (m, n), fn in originals.items():
        setattr(m, n, counting(fn))

    def counts():
        return {"s1": dict(spl.dslash_staggered_eo_pallas_fused
                           .launches_by_form),
                "s2": dict(spl.dslash_staggered_eo_pass.launches_by_form),
                "s2_mrhs": dict(spl.dslash_staggered_eo_pass_mrhs
                                .launches_by_form),
                "b2": bpl.cg_update_norm2_pallas.launches,
                "b3": dict(bpl.axpy_norm2_pallas.launches_by_form),
                "plain_stencil_calls": plain_calls["n"]}

    def zero():
        spl.reset_launches()
        bpl.cg_update_norm2_pallas.launches = 0
        bpl.axpy_norm2_pallas.launches_by_form = {}
        plain_calls["n"] = 0

    def stag_param(**kw):
        base = dict(dslash_type="hisq", inv_type="cg",
                    solve_type="direct-pc", mass=STAG_MASS, tol=TOL,
                    maxiter=5000, cuda_prec="single",
                    cuda_prec_sloppy="single")
        base.update(kw)
        return qt.InvertParam(**base)

    launches, iters = {}, {}
    try:
        for label, kw in (
                ("hisq", {}),
                ("hisq:half", {"cuda_prec_sloppy": "half"}),
                ("asqtad", {"dslash_type": "asqtad"}),
                ("staggered", {"dslash_type": "staggered"}),
                ("staggered:half", {"dslash_type": "staggered",
                                    "cuda_prec_sloppy": "half"})):
            if label == "asqtad":
                qt.load_fat_long_quda(fat, lng)
            param = stag_param(**kw)
            torch.cuda.reset_peak_memory_stats(dev)
            zero()
            x = qt.invert_quda(src, param)
            torch.cuda.synchronize()
            c = counts()
            launches[label] = c
            iters[label] = (param.iter_count, param.secs)
            finite = bool(torch.isfinite(torch.view_as_real(x)).all())
            shape_ok = tuple(x.shape) == geom.spinor_shape(1)
            n_s1 = sum(c["s1"].values())
            n_s2 = sum(c["s2"].values())
            emit({"phase": "invert_staggered", "label": label,
                  "dims_xyzt": list(STAG_DIMS), "dslash_type":
                  param.dslash_type, "mass": STAG_MASS, "tol": TOL,
                  "cuda_prec_sloppy": param.cuda_prec_sloppy,
                  "iters": param.iter_count,
                  "reliable_updates": param.reliable_updates,
                  "secs": param.secs, "true_res": param.true_res,
                  "converged": param.converged, "gflop": param.gflops,
                  "launches_s1": c["s1"], "launches_s2": c["s2"],
                  "launches_b2": c["b2"], "launches_b3": c["b3"],
                  "plain_stencil_calls": c["plain_stencil_calls"],
                  "shape_ok": shape_ok, "finite": finite,
                  "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9})
            if not (param.converged and param.true_res <= TRUE_RES_MAX
                    and finite and shape_ok):
                fail(f"invert_quda ({label}) did not converge to a finite "
                     f"solution with true_res <= {TRUE_RES_MAX:g}")
            if c["plain_stencil_calls"]:
                fail(f"invert_quda ({label}) ran a plain stencil: {c}")
            it = param.iter_count
            improved = param.dslash_type != "staggered"
            if label in ("hisq", "asqtad") and not (
                    n_s1 == 2 * it + 2 and n_s2 == 0):
                fail(f"{label} path did not launch S1 exactly twice per "
                     f"fused_cg iteration (+ prepare, reconstruct): {c}")
            if label == "hisq:half" and not (
                    c["s1"].get("full:bf16->bf16", 0) >= it and n_s2 == 0):
                fail(f"hisq half path did not run the bf16 S1: {c}")
            if not improved and not (n_s1 == 0 and n_s2 >= 2 * it):
                fail(f"fat-only path ({label}) did not run S2 alone: {c}")
            del x
        if iters["hisq"][0] != iters["asqtad"][0]:
            fail(f"hisq ({iters['hisq'][0]}) and asqtad "
                 f"({iters['asqtad'][0]}) on the same links took different "
                 "iterations")

        # -- invert_multishift -------------------------------------------
        param = stag_param(inv_type="multi-shift-cg",
                           num_offset=len(STAG_SHIFTS), offset=STAG_SHIFTS)
        zero()
        xs = qt.invert_multishift_quda(src, param)
        torch.cuda.synchronize()
        c = counts()
        launches["multishift"] = c
        iters["multishift"] = (param.iter_count, param.secs)

        # -- invert_multi_src: 12 sources on S2-mrhs ---------------------
        for label, dt in (("hisq", "hisq"), ("staggered", "staggered")):
            lane_iters = []
            for i in range(MULTI_SRC_N):
                p_i = stag_param(dslash_type=dt)
                qt.invert_quda(srcs_s[i], p_i)
                lane_iters.append(p_i.iter_count)
            pmul = stag_param(dslash_type=dt)
            torch.cuda.reset_peak_memory_stats(dev)
            zero()
            x = qt.invert_multi_src_quda(srcs_s, pmul)
            torch.cuda.synchronize()
            cm = counts()
            launches[f"multi:{label}"] = cm
            multi_s[label] = (pmul.iter_count_multi, pmul.secs, lane_iters)
            finite = bool(torch.isfinite(torch.view_as_real(x)).all())
            shape_ok = tuple(x.shape) == (MULTI_SRC_N,) + geom.spinor_shape(1)
            n_it = max(pmul.iter_count_multi)
            per_apply = 4 if dt == "hisq" else 2
            mrhs_total = sum(cm["s2_mrhs"].values())
            emit({"phase": "invert_multi_src", "family": "staggered",
                  "label": label, "dims_xyzt": list(STAG_DIMS),
                  "nrhs": MULTI_SRC_N, "dslash_type": dt, "mass": STAG_MASS,
                  "tol": TOL, "chunk": spl.MRHS_CHUNK,
                  "iters_per_lane": pmul.iter_count_multi,
                  "invert_quda_iters_per_source": lane_iters,
                  "true_res_worst": pmul.true_res,
                  "true_res_multi": pmul.true_res_multi,
                  "converged_multi": pmul.converged_multi,
                  "secs": pmul.secs, "gflop": pmul.gflops,
                  "launches_s2_mrhs": cm["s2_mrhs"],
                  "launches_s2_mrhs_expected": per_apply * (n_it + 1),
                  "launches_single_rhs": {"s1": cm["s1"], "s2": cm["s2"]},
                  "plain_stencil_calls": cm["plain_stencil_calls"],
                  "shape_ok": shape_ok, "finite": finite,
                  "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9})
            if not (pmul.converged and all(pmul.converged_multi)
                    and pmul.true_res <= TRUE_RES_MAX and finite
                    and shape_ok):
                fail(f"staggered invert_multi_src_quda ({label}) did not "
                     "converge every lane to a finite solution with "
                     f"true_res <= {TRUE_RES_MAX:g}")
            if pmul.iter_count_multi != lane_iters:
                fail(f"staggered invert_multi_src_quda ({label}): lanes "
                     f"took {pmul.iter_count_multi} iterations, "
                     f"invert_quda per source {lane_iters}")
            if (mrhs_total != per_apply * (n_it + 1) or cm["s1"] or cm["s2"]
                    or cm["plain_stencil_calls"]):
                fail(f"staggered multi-source path ({label}) did not run "
                     f"S2-mrhs {per_apply} times per iteration (+ prepare, "
                     f"reconstruct) and nothing else: {cm}")
            del x
    finally:
        for (m, n), fn in originals.items():
            setattr(m, n, fn)
        qt.end_quda()
    c128 = torch.complex128
    dpc = DiracStaggeredPC(fat.to(c128), geom, STAG_MASS, True, lng.to(c128))
    be, bo = even_odd_split(src.to(c128), geom)
    rhs = dpc.prepare(be, bo)
    shift_res = []
    for i, sigma in enumerate(STAG_SHIFTS):
        xi = xs[i].to(c128)
        shift_res.append((torch.linalg.vector_norm(
            rhs - (dpc.M(xi) + sigma * xi))
            / torch.linalg.vector_norm(rhs)).item())
    del dpc, rhs, be, bo
    emit({"phase": "invert_multishift", "dims_xyzt": list(STAG_DIMS),
          "dslash_type": "hisq", "mass": STAG_MASS, "tol": TOL,
          "offsets": list(STAG_SHIFTS), "iters": param.iter_count,
          "secs": param.secs, "true_res_base_pairs": param.true_res,
          "true_res_per_shift_complex128": shift_res,
          "converged_multi": param.converged_multi,
          "launches_s1": c["s1"], "launches_b3": c["b3"],
          "plain_stencil_calls": c["plain_stencil_calls"],
          "shape": list(xs.shape)})
    if not (all(param.converged_multi) and max(shift_res) <= TRUE_RES_MAX
            and c["plain_stencil_calls"] == 0
            and sum(c["s1"].values()) >= param.iter_count):
        fail("invert_multishift_quda did not converge every shift with "
             f"true_res <= {TRUE_RES_MAX:g} through S1: {shift_res}, {c}")
    del xs

    # -- reference: an 8^4 hisq solve on the card and on the CPU --------
    small = (8, 8, 8, 8)
    rng = np.random.default_rng(SEED + 9)
    g_np = GaugeField.random(LatticeGeometry(small), rng, scale=0.7,
                             dtype=torch.complex64, device="cpu").data
    b_np = ColorSpinorField.gaussian(LatticeGeometry(small), rng, nspin=1,
                                     dtype=torch.complex64,
                                     device="cpu").data
    sols = {}
    for where in (dev, "cpu"):
        qt.init_quda(where)
        try:
            qt.load_gauge_quda(g_np, qt.GaugeParam(X=small,
                                                   cuda_prec="single"))
            qt.compute_ks_link_quda()
            p = stag_param(maxiter=1000)
            sols[str(where)] = (qt.invert_quda(b_np, p).cpu(), p)
        finally:
            qt.end_quda()
    (x_gpu, p_gpu), (x_cpu, p_cpu) = sols[str(dev)], sols["cpu"]
    sol_rel = (torch.linalg.vector_norm(x_gpu - x_cpu)
               / torch.linalg.vector_norm(x_cpu)).item()
    emit({"phase": "reference", "dims_xyzt": list(small),
          "dslash_type": "hisq", "iters_card": p_gpu.iter_count,
          "iters_cpu": p_cpu.iter_count, "true_res_card": p_gpu.true_res,
          "solution_rel_diff": sol_rel})
    if not (sol_rel <= 1e-4 and p_gpu.converged
            and abs(p_gpu.iter_count - p_cpu.iter_count) <= 2):
        fail("the card's small hisq solve disagrees with the CPU's plain "
             "path")

    # -- timing ----------------------------------------------------------
    half = geom.half_volume
    timing, bound_by = {}, {}

    def bound(nbytes, nflop):
        t_bytes = nbytes * half / HBM_BYTES_PER_S
        t_ops = nflop * half / F32_FLOPS_PER_S
        return (1e3 * max(t_bytes, t_ops),
                "bytes" if t_bytes >= t_ops else "operations")

    for store, out in forms:
        dims, lk, psi = inputs(STAG_DIMS, store)
        name = spl.form_name(store, out)
        k_ms = median_ms(lambda: spl.dslash_staggered_eo_pallas_fused(
            lk[0], lk[1], psi, dims, 0, lk[2], lk[3], out_dtype=out), torch)
        p_ms = median_ms(lambda: spl.dslash_staggered_eo_fused_plain(
            lk[0], lk[1], psi, dims, 0, lk[2], lk[3], out_dtype=out), torch,
            repeats=5, batch=2)
        b_ms, bound_by[name] = bound(spl.fused_bytes_per_site(store, out),
                                     spl.FUSED_FLOPS_PER_SITE)
        timing[name] = (k_ms, p_ms, b_ms)
        for nhop in (1, 3):
            name = spl.pass_form_name(nhop, store, out)
            here, bw = pass_args(lk, dims, 0, nhop)
            k_ms = median_ms(lambda: spl.dslash_staggered_eo_pass(
                here, bw, psi, dims, 0, nhop, out), torch)
            p_ms = median_ms(lambda: spl.dslash_staggered_eo_pass_plain(
                here, bw, psi, dims, 0, nhop, out), torch, repeats=5,
                batch=2)
            b_ms, bound_by[name] = bound(spl.pass_bytes_per_site(store, out),
                                         spl.PASS_FLOPS_PER_SITE)
            timing[name] = (k_ms, p_ms, b_ms)
            del here, bw
        del lk, psi

    # S2-mrhs at N = 12: each pass (the Naik pass accumulating, as on the
    # improved path), beside 12 single S2 launches
    dims, lk, _ = inputs(STAG_DIMS, f32, gen_m)
    psi_b = mrhs_psi(dims, MULTI_SRC_N)
    mrhs_timing = {}
    acc_b = torch.zeros_like(psi_b)
    for nhop, name in zip((1, 3), mrhs_names):
        here, bw = pass_args(lk, dims, 0, nhop)
        acc = acc_b if nhop == 3 else None
        k_ms = median_ms(lambda: spl.dslash_staggered_eo_pass_mrhs(
            here, bw, psi_b, dims, 0, nhop, acc=acc), torch)
        single_ms = median_ms(lambda: [spl.dslash_staggered_eo_pass(
            here, bw, psi_b[r], dims, 0, nhop) for r in range(MULTI_SRC_N)],
            torch, repeats=10, batch=2)
        p_ms = median_ms(lambda: spl.dslash_staggered_eo_pass_mrhs_plain(
            here, bw, psi_b, dims, 0, nhop), torch, repeats=3, batch=1)
        b_ms, bound_by[f"mrhs:{name}"] = bound(
            spl.pass_mrhs_bytes_per_site(MULTI_SRC_N, nhop == 3),
            spl.PASS_FLOPS_PER_SITE * MULTI_SRC_N)
        mrhs_timing[name] = (k_ms, p_ms, b_ms, single_ms)
        del here, bw
    del lk, psi_b, acc_b

    be, bo = even_odd_split(src, geom)

    def per_iter_ms(run, n=STAG_ITER_TIMED):
        run(2)                                                # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run(n)
        torch.cuda.synchronize()
        # a batched result counts per lane: its loop ran the most
        its = (int(res.iters.max()) if torch.is_tensor(res.iters)
               else res.iters)
        return 1e3 * (time.perf_counter() - t0) / its, its

    iter_ms = {}
    for label, improved in (("hisq", True), ("staggered", False)):
        dpc = DiracStaggeredPC(fat if improved else gauge, geom, STAG_MASS,
                               improved, lng if improved else None)
        op = dpc.pairs(f32)
        rhs = op.prepare_pairs(be, bo)
        iter_ms[f"{label}_fused_cg"] = per_iter_ms(
            lambda n: fused_cg(op.M_pairs, rhs, tol=1e-30, maxiter=n))
        if improved:
            lo = dpc.pairs(bf16)
            iter_ms["hisq_cg_reliable_half"] = per_iter_ms(
                lambda n: cg_reliable(op.M_pairs, lo.M_pairs, rhs,
                                      pair_inplace_codec(bf16), tol=1e-30,
                                      maxiter=n))
            iter_ms["hisq_multishift_8"] = per_iter_ms(
                lambda n: multishift_cg(op.M_pairs, rhs, STAG_SHIFTS,
                                        tol=1e-30, maxiter=n))
            del lo
        # one 12-source batched_cg_pairs iteration on S2-mrhs
        op = dpc.pairs(f32, form="two_pass")
        be_b, bo_b = (torch.stack(h).contiguous() for h in zip(
            *(even_odd_split(srcs_s[i], geom) for i in range(MULTI_SRC_N))))
        rhs_b = op.prepare_pairs_mrhs(be_b, bo_b)
        del be_b, bo_b
        iter_ms[f"{label}_batched_cg_12"] = per_iter_ms(
            lambda n: batched_cg_pairs(op.M_pairs_mrhs, rhs_b, tol=1e-30,
                                       maxiter=n))
        del dpc, op, rhs, rhs_b
    emit({"phase": "timing", "family": "staggered",
          "dims_xyzt": list(STAG_DIMS), "nvidia_smi": smi,
          "repeats": REPEATS, "calls_per_timing": BATCH,
          **{name: {"ms": k, "plain_ms": p, "bound_ms": b,
                    "share_of_bound": b / k}
             for name, (k, p, b) in timing.items()},
          **{f"mrhs:{name}": {
              "nrhs": MULTI_SRC_N, "chunk": spl.MRHS_CHUNK, "ms": k,
              "plain_ms": p, "bound_ms": b, "share_of_bound": b / k,
              "single_rhs_launches_ms": one, "amortisation": one / k}
             for name, (k, p, b, one) in mrhs_timing.items()},
          "iteration_ms": {k: v[0] for k, v in iter_ms.items()},
          "iterations_timed": {k: v[1] for k, v in iter_ms.items()},
          "batched_vs_single_iters": {
              label: iter_ms[f"{label}_batched_cg_12"][0]
              / (MULTI_SRC_N * iter_ms[f"{label}_fused_cg"][0])
              for label in ("hisq", "staggered")},
          "solve_secs": {k: v[1] for k, v in iters.items()},
          "solve_iters": {k: v[0] for k, v in iters.items()},
          "multi_src_secs": {k: v[1] for k, v in multi_s.items()},
          "multi_src_iters": {k: v[0] for k, v in multi_s.items()}})

    # launches of each form on its main path; S2's single-RHS Naik forms
    # run on no ported path (the improved single-source operator takes S1),
    # so they stay in the check and timing phases and have no row; the
    # multi-RHS Naik pass runs on the hisq multi-source path
    s1_path = {"full:f32->f32": "hisq", "full:bf16->bf16": "hisq:half",
               "full:bf16->f32": "hisq:half"}
    s2_path = {"fat:f32->f32": "staggered", "fat:bf16->bf16":
               "staggered:half", "fat:bf16->f32": "staggered:half"}
    rows = []
    for name, path in s1_path.items():
        k_ms, p_ms, b_ms = timing[name]
        rows.append({
            "name": f"dslash_staggered_eo_pallas_fused[{name}]",
            "route": "cuda", "source": "quda_tpu_torch/csrc/staggered_eo.cu",
            "replaces": "quda_tpu/ops/staggered_pallas.py:966",
            "launches": launches[path]["s1"].get(name, 0),
            "max_abs_err": errs[name], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": bound_by[name],
            "library_ms": None})
    for name, path in s2_path.items():
        k_ms, p_ms, b_ms = timing[name]
        rows.append({
            "name": f"dslash_staggered_eo_pass[{name}]",
            "route": "cuda", "source": "quda_tpu_torch/csrc/staggered_eo.cu",
            "replaces": "quda_tpu/ops/staggered_pallas.py:204",
            "launches": launches[path]["s2"].get(name, 0),
            "max_abs_err": errs[name], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": bound_by[name],
            "library_ms": None})
    for name in mrhs_names:
        k_ms, p_ms, b_ms, _ = mrhs_timing[name]
        rows.append({
            "name": f"dslash_staggered_eo_pass_mrhs[{name}]",
            "route": "cuda",
            "source": "quda_tpu_torch/csrc/staggered_eo_mrhs.cu",
            "replaces": "quda_tpu/ops/staggered_pallas.py:1106",
            "launches": launches["multi:hisq"]["s2_mrhs"].get(name, 0),
            "max_abs_err": errs[f"mrhs:{name}"], "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": bound_by[f"mrhs:{name}"], "library_ms": None})
    return rows, {"fat": fat, "long": lng, "gauge": gauge, "src": src}


def operator_and_double(torch, dev, smi) -> list:
    """The full-lattice hop B4 and the double forms (phases check, dslash,
    invert_double, timing; BASELINE configs 1 and 2); returns the
    kernels-line rows of B4, B1 f64 and B2 f64."""
    import quda_tpu_torch as qt
    from quda_tpu_torch.fields.gauge import GaugeField
    from quda_tpu_torch.fields.geometry import LatticeGeometry
    from quda_tpu_torch.fields.spinor import (ColorSpinorField,
                                              even_odd_split)
    from quda_tpu_torch.models.wilson import DiracWilson, DiracWilsonPC
    from quda_tpu_torch.ops import blas
    from quda_tpu_torch.ops import blas_pallas as bpl
    from quda_tpu_torch.ops import wilson_pallas_packed as wpp

    f32, f64 = torch.float32, torch.float64
    c64, c128 = torch.complex64, torch.complex128
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    errs, timing, bound_by = {}, {}, {}
    b4_forms = [(3, f32), (2, f32), (3, f64)]
    b4_names = [wpp.form_name(r, dt, dt) for r, dt in b4_forms]

    def bound(nbytes, nflop, dtype, sites):
        t_bytes = nbytes * sites / HBM_BYTES_PER_S
        peak = F64_FLOPS_PER_S if dtype == f64 else F32_FLOPS_PER_S
        t_ops = nflop * sites / peak
        return (1e3 * max(t_bytes, t_ops),
                "bytes" if t_bytes >= t_ops else "operations")

    def b4_inputs(dims_xyzt, rows, dtype):
        T, Z, Y, X = LatticeGeometry(dims_xyzt).lattice_shape
        sites = (T, Z, Y * X)
        u = torch.randn((4, rows, 3, 2) + sites, generator=gen, device=dev,
                        dtype=f64).to(dtype)
        psi = torch.randn((4, 3, 2) + sites, generator=gen, device=dev,
                          dtype=f64).to(dtype)
        return X, u, wpp.backward_gauge(u, X).contiguous(), psi

    def tolerance(dtype):
        return F64_TOLERANCE if dtype == f64 else wpp.TOLERANCE

    def compare(got, want):
        abs_err = (got - want).abs().max().item()
        return abs_err, abs_err / want.abs().max().item()

    # -- check: B4 (14x12x10x8 and 32^3 x 64), B1 f64, B2 f64 -------------
    for (rows, dt), name in zip(b4_forms, b4_names):
        errs[name] = 0.0
        for dims_xyzt, tb in ((FULL_SMALL_DIMS, True),
                              (FULL_SMALL_DIMS, False), (PROD_DIMS, True)):
            X, u, ubw, psi = b4_inputs(dims_xyzt, rows, dt)
            got = wpp.dslash_pallas_packed(u, psi, X, gauge_bw=ubw,
                                           tb_sign=tb)
            want = wpp.dslash_packed_plain(u, ubw, psi, X, tb)
            torch.cuda.synchronize()
            abs_err, rel = compare(got, want)
            errs[name] = max(errs[name], abs_err)
            emit({"phase": "check", "kernel": "dslash_pallas_packed",
                  "form": name, "dims_xyzt": list(dims_xyzt), "tb_sign": tb,
                  "max_abs_err": abs_err, "max_rel_err": rel,
                  "tolerance": tolerance(dt)})
            if not (rel <= tolerance(dt) and got.dtype == dt):
                fail(f"full-lattice hop {name} disagrees with its plain "
                     f"version: {rel:.3e} > {tolerance(dt):g}")
            del u, ubw, psi, got, want
    b1_f64 = wpp.form_name(3, f64, f64)
    errs[b1_f64] = 0.0

    def b1_inputs(dims_xyzt, parity):
        geom = LatticeGeometry(dims_xyzt)
        T, Z, Y, X = geom.lattice_shape
        sites = (T, Z, Y * X // 2)
        rnd = [torch.randn(shape + sites, generator=gen, device=dev,
                           dtype=f64) for shape in
               ((4, 3, 2), (4, 3, 3, 2), (4, 3, 3, 2))]
        u_bw = wpp.backward_gauge_eo(rnd[2], geom.lattice_shape,
                                     parity).contiguous()
        return geom.lattice_shape, rnd[1], u_bw, rnd[0]

    for dims_xyzt in (SMALL_DIMS, PROD_DIMS):
        for parity in (0, 1):
            dims, uh, ubw, psi = b1_inputs(dims_xyzt, parity)
            got = wpp.dslash_eo_pallas_packed(uh, ubw, psi, dims, parity)
            want = wpp.dslash_eo_packed_plain(uh, ubw, psi, dims, parity)
            torch.cuda.synchronize()
            abs_err, rel = compare(got, want)
            errs[b1_f64] = max(errs[b1_f64], abs_err)
            emit({"phase": "check", "kernel": "dslash_eo_pallas_packed",
                  "form": b1_f64, "dims_xyzt": list(dims_xyzt),
                  "parity": parity, "max_abs_err": abs_err,
                  "max_rel_err": rel, "tolerance": F64_TOLERANCE})
            if not (rel <= F64_TOLERANCE and got.dtype == f64):
                fail(f"eo hop {b1_f64} disagrees with its plain version: "
                     f"{rel:.3e}")
            del uh, ubw, psi, got, want
    geom_p = LatticeGeometry(PROD_DIMS)
    half_shape = (4, 3, 2, geom_p.T, geom_p.Z, geom_p.Y * geom_p.X // 2)
    tail = [torch.randn(half_shape, generator=gen, device=dev, dtype=f64)
            for _ in range(4)]
    alpha = torch.tensor(0.37, dtype=f64, device=dev)
    xk, rk, r2k = bpl.cg_update_norm2_pallas(alpha, *tail)
    xp, rp, r2p = blas.triple_cg_update(alpha, *tail)
    torch.cuda.synchronize()
    vec_err = max(compare(xk, xp)[0], compare(rk, rp)[0])
    vec_rel = vec_err / max(xp.abs().max().item(), rp.abs().max().item())
    r2_rel = abs(r2k.item() - r2p.item()) / r2p.item()
    errs["b2:f64"] = vec_err
    emit({"phase": "check", "kernel": "cg_update_norm2_pallas",
          "form": "f64", "elements": xk.numel(), "max_abs_err": vec_err,
          "max_rel_err": vec_rel, "r2_rel_err": r2_rel,
          "tolerance": F64_TOLERANCE})
    if not (vec_rel <= F64_TOLERANCE and r2_rel <= F64_TOLERANCE
            and r2k.dtype == f64):
        fail("the f64 CG tail kernel disagrees with its plain version")
    del xk, rk, xp, rp

    # -- dslash: dslash_quda, mat_quda, mat_dag_mat_quda -----------------
    def counts():
        return {"b1": dict(wpp.dslash_eo_pallas_packed.launches_by_form),
                "b4": dict(wpp.dslash_pallas_packed.launches_by_form),
                "b2": dict(bpl.cg_update_norm2_pallas.launches_by_form),
                "b3": dict(bpl.axpy_norm2_pallas.launches_by_form)}

    def zero():
        wpp.reset_launches()
        bpl.cg_update_norm2_pallas.launches_by_form = {}
        bpl.axpy_norm2_pallas.launches_by_form = {}

    fields = {}

    def gauge_and_source(dims_xyzt):
        if dims_xyzt not in fields:
            geom = LatticeGeometry(dims_xyzt)
            fields[dims_xyzt] = (
                geom, GaugeField.random(geom, gen, dtype=c128,
                                        device=dev).data,
                ColorSpinorField.gaussian(geom, gen, dtype=c128,
                                          device=dev).data)
        return fields[dims_xyzt]

    launches = {}
    for dims_xyzt, prec, rec in ((PROD_DIMS, "single", 18),
                                 (PROD_DIMS, "single", 12),
                                 (PROD_DIMS, "double", 18),
                                 (CONFIG1_DIMS, "double", 18)):
        geom, gauge, psi = gauge_and_source(dims_xyzt)
        cdt = c128 if prec == "double" else c64
        be, bo = even_odd_split(psi, geom)
        qt.init_quda(dev)
        try:
            qt.load_gauge_quda(gauge.to(cdt), qt.GaugeParam(
                X=dims_xyzt, cuda_prec=prec, reconstruct=rec))
            p = qt.InvertParam(dslash_type="wilson", kappa=KAPPA,
                               cuda_prec=prec)
            zero()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = {"dslash_quda": qt.dslash_quda(bo.to(cdt), p, 0),
                   "mat_quda": qt.mat_quda(psi.to(cdt), p),
                   "mat_dag_mat_quda": qt.mat_dag_mat_quda(psi.to(cdt), p)}
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            c = counts()
        finally:
            qt.end_quda()
        label = f"{prec}:{'r12' if rec == 12 else 'full'}:" + "x".join(
            map(str, dims_xyzt))
        launches[label] = c
        # the complex plain operators on the card, in complex128
        g128 = gauge.to(c128)
        want = {"dslash_quda": DiracWilsonPC(g128, geom, KAPPA).D_to(bo, 0),
                "mat_quda": DiracWilson(g128, geom, KAPPA).M(psi),
                "mat_dag_mat_quda": DiracWilson(g128, geom, KAPPA).MdagM(psi)}
        rel = {k: compare(out[k].to(c128), want[k])[1] for k in out}
        tol = F64_TOLERANCE if prec == "double" else wpp.TOLERANCE
        form = wpp.form_name(2 if rec == 12 else 3, *(
            (f64, f64) if prec == "double" else (f32, f32)))
        row = {"phase": "dslash", "dims_xyzt": list(dims_xyzt),
               "cuda_prec": prec, "reconstruct": rec, "kappa": KAPPA,
               "rel_err_vs_complex128": rel, "tolerance": tol,
               "dtypes": {k: str(v.dtype) for k, v in out.items()},
               "secs_three_calls": secs, "launches_b1": c["b1"],
               "launches_b4": c["b4"]}
        if dims_xyzt == PROD_DIMS:
            op = DiracWilson(gauge.to(cdt), geom, KAPPA).pairs(
                f64 if prec == "double" else f32,
                "r12" if rec == 12 else "full")
            x = op._to_pairs(psi.to(cdt))
            ms = median_ms(lambda: op.D_pairs(x), torch)
            b_ms = bound(wpp.bytes_per_site(
                2 if rec == 12 else 3, op.store_dtype),
                wpp.flops_per_site(2 if rec == 12 else 3),
                op.store_dtype, geom.volume)[0]
            row.update({"b4_form": form, "b4_ms": ms, "b4_bound_ms": b_ms,
                        "b4_share_of_bound": b_ms / ms,
                        "b4_gflops_1320": 1320 * geom.volume / ms / 1e6})
            del op, x
        emit(row)
        if not (all(r <= tol for r in rel.values())
                and all(v.dtype == cdt for v in out.values())):
            fail(f"operator API ({label}) disagrees with the complex "
                 f"operator: {rel}")
        if not (c["b4"].get(form, 0) == 3 and c["b1"].get(form, 0) == 1):
            fail(f"operator API ({label}) did not run B1 once and B4 "
                 f"three times: {c}")
        del out, want, g128

    # -- invert_double: native f64 (double/single, double/double) and df64
    rows_d = {}
    for dims_xyzt in (PROD_DIMS, CONFIG2_DIMS):
        geom, gauge, _ = gauge_and_source(dims_xyzt)
        src = ColorSpinorField.gaussian(geom, gen, dtype=c128,
                                        device=dev).data
        cases = [("double", "single"), ("double", "double")]
        if dims_xyzt == PROD_DIMS:
            cases.append(("single", "single"))            # the df64 route
        for prec, sloppy in cases:
            cdt = c128 if prec == "double" else c64
            qt.init_quda(dev)
            try:
                qt.load_gauge_quda(gauge.to(cdt), qt.GaugeParam(
                    X=dims_xyzt, cuda_prec=prec))
                p = qt.InvertParam(dslash_type="wilson", inv_type="cg",
                                   solve_type="normop-pc", kappa=KAPPA,
                                   tol=DF64_TOL, maxiter=4000,
                                   cuda_prec=prec, cuda_prec_sloppy=sloppy)
                torch.cuda.reset_peak_memory_stats(dev)
                zero()
                x = qt.invert_quda(src.to(cdt), p)
                torch.cuda.synchronize()
                c = counts()
            finally:
                qt.end_quda()
            x128 = x.to(c128)
            if p.x_df64_lo is not None:
                x128 = x128 + p.x_df64_lo.to(c128)
            # the system the solve was given (the df64 route's gauge and
            # source are complex64), applied in complex128
            d128 = DiracWilson(gauge.to(cdt).to(c128), geom, KAPPA)
            b128 = src.to(cdt).to(c128)
            oracle = (torch.linalg.vector_norm(b128 - d128.M(x128))
                      / torch.linalg.vector_norm(b128)).item()
            label = ("df64" if prec == "single" else
                     f"double/{sloppy}") + ":" + "x".join(map(str, dims_xyzt))
            launches[label] = c
            rows_d[label] = {"iters": p.iter_count, "secs": p.secs,
                             "true_res": p.true_res,
                             "true_res_complex128": oracle}
            emit({"phase": "invert_double", "label": label,
                  "dims_xyzt": list(dims_xyzt), "kappa": KAPPA,
                  "tol": DF64_TOL, "cuda_prec": prec,
                  "cuda_prec_sloppy": sloppy, "iters": p.iter_count,
                  "reliable_updates": p.reliable_updates, "secs": p.secs,
                  "true_res": p.true_res, "true_res_complex128": oracle,
                  "converged": p.converged, "launches_b1": c["b1"],
                  "launches_b2": c["b2"], "launches_b3": c["b3"],
                  "gflop": p.gflops,
                  "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9})
            if not (p.converged and p.true_res <= DF64_TOL
                    and oracle <= DF64_TOL):
                fail(f"invert_quda ({label}) missed true_res <= "
                     f"{DF64_TOL:g}: {p.true_res:.3e}, complex128 "
                     f"{oracle:.3e}")
            it = p.iter_count
            if prec == "double" and sloppy == "double" and not (
                    c["b1"].get(b1_f64, 0) >= 4 * it
                    and c["b2"].get("f64", 0) == it):
                fail(f"double/double ({label}) did not run B1 and B2 in "
                     f"f64: {c}")
            if prec == "double" and sloppy == "single" and not (
                    c["b1"].get("full:f32->f32", 0) >= 4 * it
                    and c["b1"].get(b1_f64, 0) >= 4 * p.reliable_updates
                    and c["b3"].get("f32", 0) >= it):
                fail(f"double/single ({label}) did not run B1 f32 with B1 "
                     f"f64 at the reliable updates: {c}")
            del x, x128, d128, b128
    prod = ":" + "x".join(map(str, PROD_DIMS))
    emit({"phase": "invert_double", "label": "native_f64_vs_df64",
          "dims_xyzt": list(PROD_DIMS), "tol": DF64_TOL,
          **{k[:-len(prod)]: v for k, v in rows_d.items()
             if k.endswith(prod)}})

    # -- timing: B4, B1 f64, B2 f64 against their bounds -------------------
    for (rows, dt), name in zip(b4_forms, b4_names):
        X, u, ubw, psi = b4_inputs(PROD_DIMS, rows, dt)
        k_ms = median_ms(lambda: wpp.dslash_pallas_packed(
            u, psi, X, gauge_bw=ubw), torch)
        p_ms = median_ms(lambda: wpp.dslash_packed_plain(u, ubw, psi, X),
                         torch, repeats=5, batch=2)
        b_ms, bound_by[name] = bound(wpp.bytes_per_site(rows, dt),
                                     wpp.flops_per_site(rows), dt,
                                     geom_p.volume)
        timing[name] = (k_ms, p_ms, b_ms)
        del u, ubw, psi
    dims, uh, ubw, psi = b1_inputs(PROD_DIMS, 0)
    k_ms = median_ms(lambda: wpp.dslash_eo_pallas_packed(uh, ubw, psi, dims,
                                                         0), torch)
    p_ms = median_ms(lambda: wpp.dslash_eo_packed_plain(uh, ubw, psi, dims,
                                                        0), torch,
                     repeats=5, batch=2)
    b_ms, bound_by[b1_f64] = bound(wpp.bytes_per_site(3, f64),
                                   wpp.FLOPS_PER_SITE, f64,
                                   geom_p.half_volume)
    timing["b1:" + b1_f64] = (k_ms, p_ms, b_ms)
    del uh, ubw, psi
    k_ms = median_ms(lambda: bpl.cg_update_norm2_pallas(alpha, *tail), torch)
    p_ms = median_ms(lambda: blas.triple_cg_update(alpha, *tail), torch)
    n_el = tail[0].numel()
    b_ms, bound_by["b2:f64"] = bound(
        bpl.CG_UPDATE_BYTES_PER_ELEMENT[f64], 6, f64, n_el)
    timing["b2:f64"] = (k_ms, p_ms, b_ms)
    del tail
    emit({"phase": "timing", "family": "operator_and_double",
          "dims_xyzt": list(PROD_DIMS), "nvidia_smi": smi,
          "repeats": REPEATS, "calls_per_timing": BATCH,
          **{name: {"ms": k, "plain_ms": pm, "bound_ms": b,
                    "share_of_bound": b / k}
             for name, (k, pm, b) in timing.items()},
          "b4_gflops_1320": {name: 1320 * geom_p.volume / timing[name][0]
                             / 1e6 for name in b4_names},
          "solves": rows_d})

    full = "x".join(map(str, PROD_DIMS))
    rows = []
    for (r, dt), name in zip(b4_forms, b4_names):
        path = (f"{'double' if dt == f64 else 'single'}:"
                f"{'r12' if r == 2 else 'full'}:{full}")
        k_ms, p_ms, b_ms = timing[name]
        rows.append({
            "name": f"dslash_pallas_packed[{name}]", "route": "cuda",
            "source": "quda_tpu_torch/csrc/wilson_full.cu",
            "replaces": "quda_tpu/ops/wilson_pallas_packed.py:441",
            "launches": launches[path]["b4"].get(name, 0),
            "max_abs_err": errs[name], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": bound_by[name],
            "library_ms": None})
    k_ms, p_ms, b_ms = timing["b1:" + b1_f64]
    rows.append({
        "name": f"dslash_eo_pallas_packed[{b1_f64}]", "route": "cuda",
        "source": "quda_tpu_torch/csrc/wilson_eo.cu",
        "replaces": "quda_tpu/ops/wilson_pallas_packed.py:1011",
        "launches": launches[f"double/double:{full}"]["b1"].get(b1_f64, 0),
        "max_abs_err": errs[b1_f64], "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": b_ms, "bound_by": bound_by[b1_f64], "library_ms": None})
    k_ms, p_ms, b_ms = timing["b2:f64"]
    rows.append({
        "name": "cg_update_norm2_pallas[f64]", "route": "cuda",
        "source": "quda_tpu_torch/csrc/blas_fused.cu",
        "replaces": "quda_tpu/ops/blas_pallas.py:104",
        "launches": launches[f"double/double:{full}"]["b2"].get("f64", 0),
        "max_abs_err": errs["b2:f64"], "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": b_ms, "bound_by": bound_by["b2:f64"],
        "library_ms": None})
    return rows


def zoo(torch, dev, smi) -> list:
    """The twisted and domain-wall families (ROADMAP A10) at 32^3 x 64 on
    a gauge of their own (phases check, invert_twisted, invert_multi_src,
    invert_doublet, invert_dwf, timing); returns the kernels-line rows of
    the twist forms of K1/K2 and K1/K2-mrhs and of B5-eo at N = Ls and
    Ls / 2."""
    import quda_tpu_torch as qt
    from quda_tpu_torch.fields.gauge import GaugeField
    from quda_tpu_torch.fields.geometry import LatticeGeometry
    from quda_tpu_torch.fields.spinor import (ColorSpinorField,
                                              even_odd_split)
    from quda_tpu_torch.models.domain_wall import (DiracDomainWall5DPC,
                                                   DiracMobiusPC)
    from quda_tpu_torch.models.twisted import (DiracTwistedCloverPC,
                                               DiracTwistedMassPC)
    from quda_tpu_torch.ops import blas_pallas as bpl
    from quda_tpu_torch.ops import clover_pallas as clp
    from quda_tpu_torch.ops import dwf_pallas as dwp
    from quda_tpu_torch.ops import wilson_pallas_packed as wpp
    from quda_tpu_torch.solvers.block import batched_cg_pairs
    from quda_tpu_torch.solvers.fused_iter import fused_cg
    from quda_tpu_torch.solvers.mixed import cg_reliable, pair_inplace_codec

    f32, bf16 = torch.float32, torch.bfloat16
    geom = LatticeGeometry(PROD_DIMS)
    half = geom.half_volume
    sites = (geom.T, geom.Z, geom.Y * geom.X // 2)
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    errs, timing, bound_by = {}, {}, {}

    def bound(nbytes, nflop):
        t_bytes = nbytes * half / HBM_BYTES_PER_S
        t_ops = nflop * half / F32_FLOPS_PER_S
        return (1e3 * max(t_bytes, t_ops),
                "bytes" if t_bytes >= t_ops else "operations")

    # -- check: every twist form against its plain version, full width ---
    # (kernel, epilogue): K1's block-free twist (twisted mass), K2's
    # block-free twist (twisted mass) and blocks + twist (twisted clover)
    epis = [("post", "twist"), ("diag_hop", "twist"),
            ("diag_hop", "blk+twist")]
    tw = (-ZOO_CHECK_A, 1.0 / (1.0 + ZOO_CHECK_A ** 2))
    wrapper = {"post": clp.dslash_eo_pallas_post,
               "diag_hop": clp.dslash_eo_pallas_diag_hop}
    mrhs_wrapper = {"post": clp.dslash_eo_pallas_post_mrhs,
                    "diag_hop": clp.dslash_eo_pallas_diag_hop_mrhs}

    def inputs(parity, rows, store, n=None):
        lead = () if n is None else (n,)

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)

        psi, xc = (randn(*lead, 4, 3, 2, *sites).to(store) for _ in "px")
        u_here = randn(4, rows, 3, 2, *sites).to(store)
        u_bw = wpp.backward_gauge_eo(randn(4, rows, 3, 2, *sites),
                                     geom.lattice_shape,
                                     parity).to(store).contiguous()
        blk = 0.1 * randn(2, 6, 6, 2, *sites)
        blk[:, :, :, 0] += torch.eye(6, device=dev).reshape(1, 6, 6, 1, 1, 1)
        return u_here, u_bw, psi, xc, blk.to(store)

    def call(kind, epi, args, parity, plain=False, mrhs=False):
        u_here, u_bw, psi, xc, blk = args
        dims = geom.lattice_shape
        b = blk if epi == "blk+twist" else None
        if kind == "post":
            if plain:
                fn = (clp.dslash_eo_post_mrhs_plain if mrhs
                      else clp.dslash_eo_post_plain)
                return fn(u_here, u_bw, psi, None, dims, parity, twist=tw)
            return (mrhs_wrapper if mrhs else wrapper)[kind](
                u_here, u_bw, psi, dims, parity, twist=tw)
        if plain:
            fn = (clp.dslash_eo_diag_hop_mrhs_plain if mrhs
                  else clp.dslash_eo_diag_hop_plain)
            return fn(u_here, u_bw, psi, xc, b, dims, parity,
                      -KAPPA ** 2, f32, diag_twist=-tw[0])
        return (mrhs_wrapper if mrhs else wrapper)[kind](
            u_here, u_bw, psi, xc, dims, parity, hop_coeff=-KAPPA ** 2,
            blk_pl=b, diag_twist=-tw[0], out_dtype=f32)

    def check(name, got, want, tol, **info):
        abs_err = (got.float() - want.float()).abs().max().item()
        rel = abs_err / want.float().abs().max().item()
        errs[name] = max(errs.get(name, 0.0), abs_err)
        emit({"phase": "check", "form": name, "dims_xyzt": list(PROD_DIMS),
              **info, "max_abs_err": abs_err, "max_rel_err": rel,
              "tolerance": tol})
        if not rel <= tol:
            fail(f"twist form {name} disagrees with its plain version: "
                 f"{rel:.3e} > {tol:g}")

    single_forms = [(k, e, r, st) for k, e in epis for r in (3, 2)
                    for st in (f32, bf16)]

    def single_name(kind, epi, rows, store):
        out = clp.out_dtype_of(kind, store)
        return f"{kind}:{wpp.form_name(rows, store, out)}:{epi}"

    for kind, epi, rows, store in single_forms:
        name = single_name(kind, epi, rows, store)
        out = clp.out_dtype_of(kind, store)
        tol = clp.TOLERANCE if out == f32 else clp.TOLERANCE_BF16
        for parity in (0, 1):
            args = inputs(parity, rows, store)
            got = call(kind, epi, args, parity)
            want = call(kind, epi, args, parity, plain=True)
            torch.cuda.synchronize()
            if got.dtype != out:
                fail(f"twist form {name} wrote {got.dtype}")
            check(name, got, want, tol, kernel=wrapper[kind].__name__,
                  parity=parity)
            del args, got, want
    mrhs_forms = [(k, e, r) for k, e in epis for r in (3, 2)]

    def mrhs_name(kind, epi, rows):
        return f"mrhs:{kind}:{wpp.form_name(rows, f32, f32)}:{epi}"

    def b5eo_ls_name(rows, n_ls):
        name = f"b5eo_ls:{wpp.form_name(rows, f32, f32)}"
        return name if n_ls == DWF_LS else f"{name}:n{n_ls}"

    for kind, epi, rows in mrhs_forms:
        name = mrhs_name(kind, epi, rows)
        for parity in (0, 1):
            args = inputs(parity, rows, f32, MULTI_SRC_N)
            got = call(kind, epi, args, parity, mrhs=True)
            want = call(kind, epi, args, parity, plain=True, mrhs=True)
            u_here, u_bw, psi, xc, blk = args
            lanes = torch.stack([call(kind, epi, (u_here, u_bw, psi[r],
                                                  xc[r], blk), parity)
                                 for r in range(MULTI_SRC_N)])
            torch.cuda.synchronize()
            bitwise = bool(torch.equal(got, lanes))
            check(name, got, want, clp.TOLERANCE,
                  kernel=mrhs_wrapper[kind].__name__, parity=parity,
                  nrhs=MULTI_SRC_N, chunk=clp.K_MRHS_CHUNK,
                  lanes_bitwise_single=bitwise)
            if not bitwise:
                fail(f"twist form {name}: a lane is not its single-RHS "
                     "launch bit for bit")
            del args, got, want, lanes, u_here, u_bw, psi, xc, blk
    torch.cuda.empty_cache()

    # -- the solves ------------------------------------------------------
    gauge = GaugeField.random(geom, gen, dtype=torch.complex64,
                              device=dev).data
    src = ColorSpinorField.gaussian(geom, gen, dtype=torch.complex64,
                                    device=dev).data
    launches = {}

    def zero_counts():
        wpp.reset_launches()
        clp.reset_launches()
        bpl.cg_update_norm2_pallas.launches = 0
        bpl.axpy_norm2_pallas.launches = 0
        bpl.axpy_norm2_pallas.launches_by_form = {}

    def read_counts():
        return {
            "b1": wpp.dslash_eo_pallas_packed.launches,
            "b1_by_form": dict(wpp.dslash_eo_pallas_packed.launches_by_form),
            "b5eo_by_form": dict(
                wpp.dslash_eo_pallas_packed_mrhs.launches_by_form),
            "b2": bpl.cg_update_norm2_pallas.launches,
            "b3": bpl.axpy_norm2_pallas.launches,
            "k1": clp.dslash_eo_pallas_post.launches,
            "k2": clp.dslash_eo_pallas_diag_hop.launches,
            "by_form": {f"{k}:{form}": n for k, fn in wrapper.items()
                        for form, n in fn.launches_by_form.items()},
            "mrhs_by_form": {f"mrhs:{k}:{form}": n
                             for k, fn in mrhs_wrapper.items()
                             for form, n in fn.launches_by_form.items()}}

    def session(g, dims, reconstruct, fn):
        qt.init_quda(dev)
        try:
            qt.load_gauge_quda(g, qt.GaugeParam(
                X=dims, cuda_prec="single", reconstruct=reconstruct))
            return fn()
        finally:
            qt.end_quda()

    def param(**kw):
        base = dict(inv_type="cg", solve_type="normop-pc", kappa=KAPPA,
                    mu=ZOO_MU, epsilon=ZOO_EPS, csw=CSW, tol=TOL,
                    maxiter=ZOO_MAXITER, cuda_prec="single")
        base.update(kw)
        return qt.InvertParam(**base)

    def zsolve(b, dims=PROD_DIMS, g=None, reconstruct=18, multi=False,
               **kw):
        """init -> load -> invert -> end, counts zeroed just before the
        invert call and read just after."""
        def run():
            p = param(**kw)
            torch.cuda.reset_peak_memory_stats(dev)
            zero_counts()
            x = (qt.invert_multi_src_quda if multi else qt.invert_quda)(b, p)
            torch.cuda.synchronize()
            return x, p, read_counts()
        x, p, counts = session(gauge if g is None else g, dims, reconstruct,
                               run)
        ok = (bool(torch.isfinite(torch.view_as_real(x)).all())
              and tuple(x.shape) == tuple(b.shape))
        return p, counts, ok, torch.cuda.max_memory_allocated(dev) / 1e9

    def need(cond, msg):
        if not cond:
            fail(msg)

    def epilogue_of(form):
        """':twist' of 'post:full:f32->f32:twist'; '' for the clover
        blocks."""
        parts = form.split(":")
        return ":" + ":".join(parts[3:]) if len(parts) > 3 else ""

    twisted = {}
    for family, k1_epi, k2_epi in (("twisted-mass", ":twist", ":twist"),
                                   ("twisted-clover", "", ":blk+twist")):
        for sloppy, rec in (("single", 18), ("single", 12), ("half", 18),
                            ("half", 12)):
            label = (f"{family}:{sloppy}" + (":r12" if rec == 12 else ""))
            p, counts, ok, mem = zsolve(src, reconstruct=rec,
                                        dslash_type=family,
                                        cuda_prec_sloppy=sloppy)
            launches[label] = counts
            twisted[label] = (p.iter_count, p.secs)
            by = counts["by_form"]
            k1_tw = sum(n for f, n in by.items() if f.startswith("post:")
                        and epilogue_of(f) == k1_epi)
            k2_tw = sum(n for f, n in by.items()
                        if f.startswith("diag_hop:")
                        and epilogue_of(f) == k2_epi)
            emit({"phase": "invert_twisted", "label": label,
                  "dims_xyzt": list(PROD_DIMS), "kappa": KAPPA, "mu": ZOO_MU,
                  "csw": CSW if family == "twisted-clover" else None,
                  "tol": TOL, "cuda_prec_sloppy": sloppy,
                  "reconstruct": rec, "iters": p.iter_count,
                  "reliable_updates": p.reliable_updates, "secs": p.secs,
                  "true_res": p.true_res, "converged": p.converged,
                  "launches_k1_k2": [counts["k1"], counts["k2"]],
                  "launches_by_form": by, "launches_b1": counts["b1"],
                  "launches_b3": counts["b3"], "finite_and_shape_ok": ok,
                  "peak_mem_gb": mem})
            need(p.converged and p.true_res <= TRUE_RES_MAX and ok,
                 f"{label}: no finite solution with true_res <= "
                 f"{TRUE_RES_MAX:g}")
            need(counts["k1"] >= 2 * p.iter_count
                 and counts["k2"] >= 2 * p.iter_count
                 and k1_tw >= 2 * p.iter_count
                 and k2_tw >= 2 * p.iter_count,
                 f"{label} did not run its K1/K2 epilogue forms twice per "
                 f"iteration: {counts}")
            need(sloppy == "single" or (counts["b3"] >= p.iter_count
                                        and p.reliable_updates >= 1),
                 f"{label}: no B3 per iteration or no reliable update")

    # 12 sources, batched (K1/K2-mrhs twist forms), every lane against
    # invert_quda on its source
    gen_src = torch.Generator(device=dev).manual_seed(SEED + 18)
    srcs = torch.stack([ColorSpinorField.gaussian(
        geom, gen_src, dtype=torch.complex64, device=dev).data
        for _ in range(MULTI_SRC_N)])
    multi = {}
    for family in ("twisted-mass", "twisted-clover"):
        for rec in (18, 12):
            label = f"multi:{family}" + (":r12" if rec == 12 else "")
            single_iters = []
            for i in range(MULTI_SRC_N):
                p_i, _, _, _ = zsolve(srcs[i], reconstruct=rec,
                                      dslash_type=family)
                single_iters.append(p_i.iter_count)
            p, counts, ok, mem = zsolve(srcs, reconstruct=rec, multi=True,
                                        dslash_type=family)
            launches[label] = counts
            multi[label] = (p.iter_count_multi, p.secs)
            n_it = max(p.iter_count_multi)
            by = counts["mrhs_by_form"]
            k2_epi = ":twist" if family == "twisted-mass" else ":blk+twist"
            k2m = sum(n for f, n in by.items()
                      if f.startswith("mrhs:diag_hop:") and f.endswith(k2_epi))
            k1m = sum(n for f, n in by.items() if f.startswith("mrhs:post:"))
            emit({"phase": "invert_multi_src", "family": family,
                  "label": label, "dims_xyzt": list(PROD_DIMS),
                  "nrhs": MULTI_SRC_N, "reconstruct": rec,
                  "iters_per_lane": p.iter_count_multi,
                  "invert_quda_iters_per_source": single_iters,
                  "true_res_worst": p.true_res,
                  "converged_multi": p.converged_multi, "secs": p.secs,
                  "launches_mrhs": by, "launches_b5eo": counts["b5eo_by_form"],
                  "launches_single_rhs": {"b1": counts["b1"],
                                          "k1": counts["k1"],
                                          "k2": counts["k2"]},
                  "finite_and_shape_ok": ok, "peak_mem_gb": mem})
            need(p.converged and p.true_res <= TRUE_RES_MAX and ok,
                 f"{label}: not every lane converged with true_res <= "
                 f"{TRUE_RES_MAX:g}")
            need(list(p.iter_count_multi) == single_iters,
                 f"{label}: lanes took {p.iter_count_multi} iterations, "
                 f"invert_quda {single_iters}")
            need(k1m >= 2 * n_it and k2m >= 2 * n_it,
                 f"{label} did not run K1/K2-mrhs: {counts}")
            need(counts["b1"] == counts["k1"] == counts["k2"] == 0,
                 f"{label} launched a single-RHS hop: {counts}")
    del srcs

    # the flavour doublets: the staged composition, B1 once per flavour
    src2 = torch.stack([src, ColorSpinorField.gaussian(
        geom, gen, dtype=torch.complex64, device=dev).data], dim=-3)
    for family in ("ndeg-twisted-mass", "ndeg-twisted-clover"):
        p, counts, ok, mem = zsolve(src2, dslash_type=family)
        launches[family] = counts
        emit({"phase": "invert_doublet", "label": family,
              "dims_xyzt": list(PROD_DIMS), "mu": ZOO_MU,
              "epsilon": ZOO_EPS, "iters": p.iter_count, "secs": p.secs,
              "true_res": p.true_res, "converged": p.converged,
              "launches_b1": counts["b1"], "launches_k1_k2":
              [counts["k1"], counts["k2"]], "finite_and_shape_ok": ok,
              "peak_mem_gb": mem})
        need(p.converged and p.true_res <= TRUE_RES_MAX and ok,
             f"{family}: no finite solution with true_res <= "
             f"{TRUE_RES_MAX:g}")
        need(counts["b1"] >= 8 * p.iter_count and counts["k1"] == 0,
             f"{family} did not run B1 per flavour: {counts}")
    del src2
    torch.cuda.empty_cache()

    # the domain-wall family, Ls = DWF_LS (EOFA at EOFA_DIMS)
    def src5(g_geom, ls):
        return torch.stack([ColorSpinorField.gaussian(
            g_geom, gen, dtype=torch.complex64, device=dev).data
            for _ in range(ls)])

    b5 = src5(geom, DWF_LS)
    geom_e = LatticeGeometry(EOFA_DIMS)
    gauge_e = GaugeField.random(geom_e, gen, dtype=torch.complex64,
                                device=dev).data
    b5_e = src5(geom_e, DWF_LS)
    dwf_kw = dict(mass=DWF_MASS, m5=DWF_M5, Ls=DWF_LS, b5=DWF_B5, c5=DWF_C5)
    dwf = {}
    for label, dslash, rec, per_iter in (
            ("mobius", "mobius", 18, 4), ("mobius:r12", "mobius", 12, 4),
            ("domain-wall-4d", "domain-wall-4d", 18, 4),
            ("domain-wall", "domain-wall", 18, 8),
            ("mobius-eofa", "mobius-eofa", 18, 4)):
        eofa = dslash == "mobius-eofa"
        kw = dict(dwf_kw, dslash_type=dslash)
        if eofa:
            kw.update(eofa_mq1=EOFA_MQ[0], eofa_mq2=EOFA_MQ[1],
                      eofa_mq3=EOFA_MQ[2], eofa_shift=EOFA_SHIFT)
        p, counts, ok, mem = zsolve(b5_e if eofa else b5,
                                    EOFA_DIMS if eofa else PROD_DIMS,
                                    gauge_e if eofa else None, rec, **kw)
        launches[f"dwf:{label}"] = counts
        dwf[label] = (p.iter_count, p.secs)
        b5eo = sum(counts["b5eo_by_form"].values())
        emit({"phase": "invert_dwf", "label": label,
              "dims_xyzt": list(EOFA_DIMS if eofa else PROD_DIMS),
              "Ls": DWF_LS, "mass": DWF_MASS, "m5": DWF_M5,
              "b5": DWF_B5 if dslash in ("mobius", "mobius-eofa") else 1.0,
              "c5": DWF_C5 if dslash in ("mobius", "mobius-eofa") else 0.0,
              "reconstruct": rec, "tol": TOL, "iters": p.iter_count,
              "secs": p.secs, "true_res": p.true_res,
              "converged": p.converged, "launches_b5eo":
              counts["b5eo_by_form"], "launches_b1": counts["b1"],
              "b5eo_per_iter": b5eo / p.iter_count,
              "finite_and_shape_ok": ok, "peak_mem_gb": mem})
        need(p.converged and p.true_res <= TRUE_RES_MAX and ok,
             f"{label}: no finite solution with true_res <= "
             f"{TRUE_RES_MAX:g}")
        need(b5eo >= per_iter * p.iter_count and counts["b1"] == 0,
             f"{label}: the 4d hop did not run on B5-eo with N = Ls (or a "
             f"single-RHS hop ran): {counts}")
    del b5_e, gauge_e
    torch.cuda.empty_cache()

    # -- timing ----------------------------------------------------------
    for kind, epi, rows, store in single_forms:
        name = single_name(kind, epi, rows, store)
        args = inputs(0, rows, store)
        k_ms = median_ms(lambda: call(kind, epi, args, 0), torch)
        p_ms = median_ms(lambda: call(kind, epi, args, 0, plain=True),
                         torch)
        with_blk = epi == "blk+twist"
        b_ms, bound_by[name] = bound(
            clp.bytes_per_site(kind, rows, store, with_blk),
            clp.flops_per_site(kind, rows, with_blk, twist=True))
        timing[name] = (k_ms, p_ms, b_ms)
        del args
    for kind, epi, rows in mrhs_forms:
        name = mrhs_name(kind, epi, rows)
        args = inputs(0, rows, f32, MULTI_SRC_N)
        k_ms = median_ms(lambda: call(kind, epi, args, 0, mrhs=True), torch)
        p_ms = median_ms(lambda: call(kind, epi, args, 0, plain=True,
                                      mrhs=True), torch, repeats=3, batch=1)
        with_blk = epi == "blk+twist"
        b_ms, bound_by[name] = bound(
            clp.bytes_per_site_mrhs(kind, MULTI_SRC_N, rows, with_blk),
            clp.flops_per_site_mrhs(kind, MULTI_SRC_N, rows, with_blk,
                                    twist=True))
        timing[name] = (k_ms, p_ms, b_ms)
        del args
    # B5-eo at N = Ls (Möbius, domain-wall-4d) and N = Ls / 2 (the 5d PC's
    # s-parity groups), with its query entry's resources held to its plan
    resources = {}
    for rows, n_ls in ((3, DWF_LS), (2, DWF_LS), (3, DWF_LS // 2),
                       (2, DWF_LS // 2)):
        name = b5eo_ls_name(rows, n_ls)
        u_here, u_bw, psi, _, _ = inputs(0, rows, f32, n_ls)
        k_ms = median_ms(lambda: dwp.dslash_eo_pallas_packed_ls(
            u_here, u_bw, psi, geom.lattice_shape, 0), torch)
        p_ms = median_ms(lambda: wpp.dslash_eo_packed_mrhs_plain(
            u_here, u_bw, psi, geom.lattice_shape, 0), torch, repeats=3,
            batch=1)
        b_ms, bound_by[name] = bound(wpp.bytes_per_site_mrhs(n_ls, rows),
                                     wpp.flops_per_site_mrhs(n_ls, rows))
        timing[name] = (k_ms, p_ms, b_ms)
        err = (dwp.dslash_eo_pallas_packed_ls(
            u_here, u_bw, psi, geom.lattice_shape, 0)
            - wpp.dslash_eo_packed_mrhs_plain(
                u_here, u_bw, psi, geom.lattice_shape, 0)).abs().max().item()
        errs[name] = err
        resources[name] = b5eo_resources(rows, geom.lattice_shape)
        del u_here, u_bw, psi
    torch.cuda.empty_cache()

    be, bo = even_odd_split(src, geom)

    def iter_ms(op, rhs, mv, solver=fused_cg, n=30, **kw):
        solver(mv, rhs, tol=1e-30, maxiter=2, **kw)          # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solver(mv, rhs, tol=1e-30, maxiter=n, **kw)
        torch.cuda.synchronize()
        it = int(res.iters.max()) if hasattr(res.iters, "max") else res.iters
        return 1e3 * (time.perf_counter() - t0) / it

    per_iter = {}
    codec = pair_inplace_codec(bf16)
    for family, dpc in (
            ("twisted-mass", DiracTwistedMassPC(gauge, geom, KAPPA, ZOO_MU)),
            ("twisted-clover", DiracTwistedCloverPC(gauge, geom, KAPPA,
                                                    ZOO_MU, CSW))):
        op, lo = dpc.pairs(f32), dpc.pairs(bf16)
        rhs = op.Mdag_pairs(op.prepare_pairs(be, bo))
        per_iter[f"{family}:fused_cg"] = iter_ms(op, rhs, op.MdagM_pairs)
        per_iter[f"{family}:cg_reliable_half"] = iter_ms(
            op, rhs, op.MdagM_pairs, solver=lambda hi, r, **kw: cg_reliable(
                hi, lo.MdagM_pairs, r, codec=codec, **kw),
            n=MIXED_ITER_TIMED)
        halves = [even_odd_split(ColorSpinorField.gaussian(
            geom, gen, dtype=torch.complex64, device=dev).data, geom)
            for _ in range(MULTI_SRC_N)]
        be_b = torch.stack([h[0] for h in halves])
        bo_b = torch.stack([h[1] for h in halves])
        del halves
        rhs_b = op.Mdag_pairs_mrhs(op.prepare_pairs_mrhs(be_b, bo_b))
        del be_b, bo_b
        per_iter[f"{family}:batched_cg_pairs_12"] = iter_ms(
            op, rhs_b, op.MdagM_pairs_mrhs, solver=batched_cg_pairs,
            n=BATCHED_ITER_TIMED)
        per_iter[f"{family}:batched_vs_12_single"] = (
            per_iter[f"{family}:batched_cg_pairs_12"]
            / (MULTI_SRC_N * per_iter[f"{family}:fused_cg"]))
        del op, lo, rhs, rhs_b, dpc
    torch.cuda.empty_cache()
    be5, bo5 = (torch.stack(h) for h in zip(
        *(even_odd_split(v, geom) for v in b5)))
    for label, dpc in (
            ("mobius", DiracMobiusPC(gauge, geom, DWF_LS, -DWF_M5, DWF_MASS,
                                     DWF_B5, DWF_C5)),
            ("domain-wall", DiracDomainWall5DPC(gauge, geom, DWF_LS, -DWF_M5,
                                                DWF_MASS))):
        op = dpc.pairs(f32)
        hb = (dpc.split5(b5) if label == "domain-wall" else (be5, bo5))
        rhs = op.Mdag_pairs(op.prepare_pairs(*hb))
        per_iter[f"{label}:fused_cg"] = iter_ms(op, rhs, op.MdagM_pairs,
                                                n=20)
        del op, rhs, hb, dpc
    del b5, be5, bo5
    torch.cuda.empty_cache()
    row = {"phase": "timing", "family": "zoo", "dims_xyzt": list(PROD_DIMS),
           "nvidia_smi": smi, "repeats": REPEATS, "calls_per_timing": BATCH,
           "iteration_ms": per_iter,
           "solve_secs": {k: v[1] for k, v in {**twisted, **dwf}.items()},
           "solve_iters": {k: v[0] for k, v in {**twisted, **dwf}.items()},
           "multi_src_secs": {k: v[1] for k, v in multi.items()}}
    for kind, epi, rows in mrhs_forms:
        resources[mrhs_name(kind, epi, rows)] = k_mrhs_resources(
            kind, epi, rows, geom.lattice_shape)
    for name, (k_ms, p_ms, b_ms) in timing.items():
        row[name] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                     "share_of_bound": b_ms / k_ms, **resources.get(name, {})}
    emit(row)

    # -- kernels-line rows: launches from the main path of each form -----
    rows_out = []

    def single_path(kind, epi, rows, store):
        family = "twisted-clover" if epi == "blk+twist" else "twisted-mass"
        sloppy = "single" if store == f32 else "half"
        return f"{family}:{sloppy}" + (":r12" if rows == 2 else "")

    for kind, epi, rows, store in single_forms:
        name = single_name(kind, epi, rows, store)
        form = name.split(":", 1)[1]
        k_ms, p_ms, b_ms = timing[name]
        rows_out.append({
            "name": f"{wrapper[kind].__name__}[{form}]", "route": "cuda",
            "source": "quda_tpu_torch/csrc/clover_eo.cu",
            "replaces": "quda_tpu/ops/clover_pallas.py:213",
            "launches": launches[single_path(kind, epi, rows, store)][
                "by_form"].get(name, 0),
            "max_abs_err": errs[name], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": bound_by[name],
            "library_ms": None})
    for kind, epi, rows in mrhs_forms:
        name = mrhs_name(kind, epi, rows)
        family = "twisted-clover" if epi == "blk+twist" else "twisted-mass"
        path = f"multi:{family}" + (":r12" if rows == 2 else "")
        k_ms, p_ms, b_ms = timing[name]
        rows_out.append({
            "name": f"{mrhs_wrapper[kind].__name__}"
                    f"[{name.split(':', 2)[2]}]",
            "route": "cuda", "source": "quda_tpu_torch/csrc/clover_eo_mrhs.cu",
            "replaces": "quda_tpu/ops/clover_pallas.py:283",
            "launches": launches[path]["mrhs_by_form"].get(name, 0),
            "max_abs_err": errs[name], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": bound_by[name],
            "library_ms": None, "resources": resources[name]})
    # launches at N = Ls from the Möbius solves, at N = Ls / 2 from the 5d
    # PC domain-wall solve (full links)
    for rows, n_ls, path, n_tag in (
            (3, DWF_LS, "dwf:mobius", f"N=Ls={DWF_LS}"),
            (2, DWF_LS, "dwf:mobius:r12", f"N=Ls={DWF_LS}"),
            (3, DWF_LS // 2, "dwf:domain-wall", f"N=Ls/2={DWF_LS // 2}")):
        form = wpp.form_name(rows, f32, f32)
        name = b5eo_ls_name(rows, n_ls)
        k_ms, p_ms, b_ms = timing[name]
        rows_out.append({
            "name": f"dslash_eo_pallas_packed_mrhs[{form}, {n_tag}]",
            "route": "cuda", "source": "quda_tpu_torch/csrc/wilson_eo_mrhs.cu",
            "replaces": "quda_tpu/ops/wilson_pallas_packed.py:613",
            "launches": launches[path]["b5eo_by_form"].get(form, 0),
            "max_abs_err": errs[name], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": bound_by[name],
            "library_ms": None})
    return rows_out


def tile_resources(kernel, info, plan, chunk):
    """A tiled multi-RHS kernel's resources at its default ``chunk`` from
    its query entry's ``info``, failing unless the launch is the ``plan``
    its wrapper mirrors."""
    if (info["smem_bytes"], info["threads"], info["tiles"],
            info["blocks"]) != (plan["smem"], plan["threads"], plan["tiles"],
                                plan["blocks"]):
        fail(f"{kernel} launched another plan than its wrapper mirrors: "
             f"{info} against {plan}")
    return {"chunk": chunk, "registers": info["registers"],
            "smem_bytes_per_block": info["smem_bytes"],
            "blocks_per_sm": info["blocks_per_sm"],
            "threads_per_block": info["threads"],
            "tiles_per_plane": info["tiles"], "blocks": info["blocks"]}


def b5eo_resources(rows, dims):
    """B5-eo's resources on the (T, Z, Y, X) lattice ``dims``."""
    from quda_tpu_torch.ops import wilson_pallas_packed as wpp

    T, Z, Y, X = dims
    return tile_resources(
        "B5-eo", wpp.eo_mrhs_info(rows, wpp.EO_MRHS_CHUNK, T, Z, Y, X // 2),
        wpp.eo_mrhs_plan(rows, T, Z, Y, X // 2), wpp.EO_MRHS_CHUNK)


def k_mrhs_resources(kind, epi, rows, dims):
    """K1/K2-mrhs's resources for one form (epilogue "clover", "twist" or
    "blk+twist") on the (T, Z, Y, X) lattice ``dims``."""
    from quda_tpu_torch.ops import clover_pallas as clp

    T, Z, Y, X = dims
    with_blk = epi != "twist"
    return tile_resources(
        "K1/K2-mrhs", clp.k_mrhs_info(kind, rows, T, Z, Y, X // 2, with_blk,
                                      epi != "clover"),
        clp.k_mrhs_plan(rows, with_blk, T, Z, Y, X // 2), clp.K_MRHS_CHUNK)


def multigrid(torch, dev, smi):
    """The Wilson multigrid at 32^3 x 64 on a quenched gauge the port
    generates (ROADMAP A12, A14; phases gauge_gen, invert_cg, mg_setup,
    invert_mg, check, timing); returns the kernels-line rows of B5 and
    B8, and the generated gauge (complex64) for the staggered
    multigrid."""
    import quda_tpu_torch as qt
    from quda_tpu_torch.fields.geometry import LatticeGeometry
    from quda_tpu_torch.gauge.heatbath import cold_start, sweep
    from quda_tpu_torch.interfaces import quda_api as api
    from quda_tpu_torch.gauge.observables import plaquette
    from quda_tpu_torch.ops import coarse_pallas as cop
    from quda_tpu_torch.ops import wilson_pallas_packed as wpp

    f32 = torch.float32
    geom = LatticeGeometry(PROD_DIMS)
    vol = geom.volume
    gen = torch.Generator(device=dev).manual_seed(SEED + 29)
    torch.cuda.empty_cache()

    def bound(nbytes, nflop, sites):
        t_bytes = nbytes * sites / HBM_BYTES_PER_S
        t_ops = nflop * sites / F32_FLOPS_PER_S
        return (1e3 * max(t_bytes, t_ops),
                "bytes" if t_bytes >= t_ops else "operations")

    # -- gauge_gen: cold start, heatbath + overrelaxation at beta 6.0 -----
    t0 = time.perf_counter()
    g = cold_start(geom, device=dev)
    n_sweeps, plaq_hist = 0, []
    for _ in range(MG_HB_SWEEPS):
        for hb in (True,) + (False,) * MG_OR_PER_HB:
            g = sweep(gen, g, geom, MG_BETA, heatbath=hb)
            n_sweeps += 1
            if n_sweeps % 10 == 0:
                plaq_hist.append([n_sweeps, float(plaquette(g)[0]),
                                  time.perf_counter() - t0])
    plaq = [float(x) for x in plaquette(g)]
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    hist = [p for _, p, _ in plaq_hist]
    drift = statistics.mean(hist[-5:]) - statistics.mean(hist[-10:-5])
    unit = (torch.matmul(g, g.conj().transpose(-1, -2))
            - torch.eye(3, dtype=g.dtype, device=dev)).abs().max().item()
    emit({"phase": "gauge_gen", "dims_xyzt": list(PROD_DIMS), "beta": MG_BETA,
          "start": "cold", "heatbath_sweeps": MG_HB_SWEEPS,
          "overrelaxation_per_heatbath": MG_OR_PER_HB, "sweeps": n_sweeps,
          "plaquette_every_10_sweeps": plaq_hist,
          "plaquette": plaq, "plaquette_published": MG_PLAQ,
          "plaquette_drift_last_50_sweeps": drift,
          "max_unitarity_err": unit, "seconds": gen_s, "dtype": str(g.dtype)})
    if not (abs(plaq[0] - MG_PLAQ) <= MG_PLAQ_TOL
            and abs(drift) <= MG_PLAQ_DRIFT and unit <= 1e-10):
        fail(f"heatbath plaquette {plaq[0]:.5f} not within {MG_PLAQ_TOL} of "
             f"{MG_PLAQ}, or drifting ({drift:.2e} over 50 sweeps, limit "
             f"{MG_PLAQ_DRIFT}), or links not unitary ({unit:.2e})")
    gauge = g.to(torch.complex64)
    del g
    src = torch.randn(geom.lattice_shape + (4, 3), generator=gen, device=dev,
                      dtype=torch.complex64)

    def counts():
        return {"b4": wpp.dslash_pallas_packed.launches,
                "b5": wpp.dslash_pallas_packed_mrhs.launches,
                "b8": cop.coarse_apply_pallas.launches,
                "b8_mrhs": cop.coarse_apply_pallas_mrhs.launches}

    def b8_by_shape():
        return dict(cop.coarse_apply_pallas.launches_by_shape)

    def zero():
        wpp.reset_launches()
        cop.reset_launches()

    qt.init_quda(dev)
    qt.load_gauge_quda(gauge, qt.GaugeParam(X=PROD_DIMS, cuda_prec="single"))
    plaq_api = qt.plaq_quda()
    # -- invert_cg: the baseline on the same system --------------------
    p_cg = qt.InvertParam(dslash_type="wilson", inv_type="cg",
                          solve_type="normop-pc", kappa=MG_KAPPA, tol=TOL,
                          maxiter=10000, cuda_prec="single")
    qt.invert_quda(src, p_cg)
    emit({"phase": "invert_cg", "dims_xyzt": list(PROD_DIMS),
          "kappa": MG_KAPPA, "tol": TOL, "iters": p_cg.iter_count,
          "secs": p_cg.secs, "true_res": p_cg.true_res,
          "converged": p_cg.converged, "plaq_quda": plaq_api})
    if not (p_cg.converged and p_cg.iter_count >= MG_CG_MIN_ITERS):
        fail(f"baseline CG at kappa {MG_KAPPA}: {p_cg.iter_count} "
             f"iterations, converged {p_cg.converged} (needs >= "
             f"{MG_CG_MIN_ITERS} and converged)")
    # -- mg_setup and invert_mg: the main path --------------------------
    ip = qt.InvertParam(dslash_type="wilson", inv_type="gcr-mg",
                        solve_type="direct", kappa=MG_KAPPA, tol=TOL,
                        cuda_prec="single")
    mp = qt.MultigridParamAPI(**MG_PARAMS)
    torch.cuda.reset_peak_memory_stats(dev)
    zero()
    hier = qt.new_multigrid_quda(mp, ip)
    c_setup = counts()
    b8_setup = b8_by_shape()
    report = hier.verify(galerkin_tol=MG_VERIFY_TOL, pr_tol=MG_VERIFY_TOL)
    emit({"phase": "mg_setup", "dims_xyzt": list(PROD_DIMS),
          "kappa": MG_KAPPA, "params": {k: v for k, v in MG_PARAMS.items()},
          "coarse_lattices": [list(lv["transfer"].coarse_shape)
                              for lv in hier.levels],
          "setup_seconds": hier.setup_seconds,
          "setup_breakdown": hier.setup_breakdown,
          "null_vector_cg_fallback_levels": hier.null_fallbacks,
          "verify": report, "launches": c_setup,
          "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9})
    solves = []
    for rep in range(2):
        zero()
        x = qt.invert_quda(src, ip)
        c = counts()
        if rep == 0:
            b8_solve = b8_by_shape()
        solves.append({"iters": ip.iter_count, "secs": ip.secs,
                       "true_res": ip.true_res, "converged": ip.converged,
                       "launches": c})
        emit({"phase": "invert_mg", "solve": rep, "kappa": MG_KAPPA,
              "tol": TOL, "gcr_nkrylov": ip.gcrNkrylov,
              "outer_iters": ip.iter_count, "secs": ip.secs,
              "true_res": ip.true_res, "converged": ip.converged,
              "hierarchy_reused": api._ctx["mg"] is hier,
              "launches": c, "cg_iters": p_cg.iter_count,
              "cg_secs": p_cg.secs,
              "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9})
        if not (ip.converged and ip.true_res <= TRUE_RES_MAX
                and ip.iter_count < p_cg.iter_count):
            fail(f"gcr-mg: converged {ip.converged}, true_res "
                 f"{ip.true_res:.3e}, {ip.iter_count} outer iterations "
                 f"against CG's {p_cg.iter_count}")
        if rep == 1 and not (api._ctx["mg"] is hier and c["b5"] == 0):
            fail("the second gcr-mg solve did not reuse the hierarchy")
    # the main path: new_multigrid_quda and the first invert_quda
    path = {k: c_setup[k] + solves[0]["launches"][k] for k in c_setup}
    if min(path.values()) < 1:
        fail(f"the multigrid path did not run B4, B5 and B8 (both forms): "
             f"{path}")
    coarse = [lv["coarse"] for lv in hier.levels]
    # B8's launches on the main path at each coarse level, by (S, E)
    b8_path = {k: b8_setup.get(k, 0) + b8_solve.get(k, 0)
               for k in set(b8_setup) | set(b8_solve)}
    b8_level_keys = [f"{math.prod(co.x_diag.shape[:4])}x{2 * co.nc}"
                     for co in coarse]
    if min(b8_path.get(k, 0) for k in b8_level_keys) < 1:
        fail(f"the multigrid path did not run B8 at every coarse level: "
             f"{b8_path} against the levels {b8_level_keys}")
    b4_gauge = (hier.adapter.gauge_pl, hier.adapter.gauge_bw)
    setup_s = hier.setup_seconds
    del x, hier
    qt.destroy_multigrid_quda()
    qt.end_quda()
    del src

    # -- check: B5 at N = 24 and 12, each lane against B4; B8 at both
    # coarse levels, on the main path's links --------------------------
    T, Z, Y, X = geom.lattice_shape
    u, ubw = b4_gauge
    errs, timing, bound_by = {}, {}, {}
    b5_rows = wpp.link_rows(u)
    for n in (MG_NVEC, MG_NVEC // 2):
        psi = torch.randn((n, 4, 3, 2, T, Z, Y * X), generator=gen,
                          device=dev)
        got = wpp.dslash_pallas_packed_mrhs(u, psi, X, gauge_bw=ubw)
        lanes_equal = all(torch.equal(got[i], wpp.dslash_pallas_packed(
            u, psi[i].contiguous(), X, gauge_bw=ubw)) for i in range(n))
        want = wpp.dslash_packed_mrhs_plain(u, ubw, psi, X)
        torch.cuda.synchronize()
        abs_err = (got - want).abs().max().item()
        rel = abs_err / want.abs().max().item()
        errs[f"b5:{n}"] = abs_err
        emit({"phase": "check", "kernel": "dslash_pallas_packed_mrhs",
              "form": "full:f32->f32", "dims_xyzt": list(PROD_DIMS),
              "nrhs": n, "max_abs_err": abs_err, "max_rel_err": rel,
              "tolerance": wpp.TOLERANCE, "lanes_bitwise_b4": lanes_equal})
        if not (rel <= wpp.TOLERANCE and lanes_equal):
            fail(f"B5 at N = {n} disagrees with its plain version "
                 f"({rel:.3e}) or a lane with B4 ({lanes_equal})")
        b5_ms = median_ms(lambda: wpp.dslash_pallas_packed_mrhs(
            u, psi, X, gauge_bw=ubw), torch)
        timing[f"b5:{n}:ms"] = b5_ms
        if n == MG_NVEC:
            singles = [psi[i].contiguous() for i in range(n)]
            b4x_ms = median_ms(lambda: [wpp.dslash_pallas_packed(
                u, q, X, gauge_bw=ubw) for q in singles], torch, batch=2)
            p_ms = median_ms(lambda: wpp.dslash_packed_mrhs_plain(
                u, ubw, psi, X), torch, repeats=3, batch=1)
            b_ms, bound_by["b5"] = bound(wpp.bytes_per_site_mrhs(n),
                                         wpp.flops_per_site_mrhs(n), vol)
            timing["b5"] = (b5_ms, p_ms, b_ms, b4x_ms)
            del singles
        del psi, got, want
    del u, ubw, b4_gauge
    b8_single = {}
    for li, co in enumerate(coarse):
        links = co.links9()
        v = torch.randn(co.x_diag.shape[:4] + (2, co.n_vec, 2),
                        generator=gen, device=dev)
        psi9 = co.psi9(v)
        got = cop.coarse_apply_pallas(links, psi9)
        want = cop.coarse_apply_ref(links, psi9)
        torch.cuda.synchronize()
        abs_err = (got - want).abs().max().item()
        rel = abs_err / want.abs().max().item()
        S, E = psi9.shape[1:]
        errs[f"b8:{li + 1}"] = abs_err
        emit({"phase": "check", "kernel": "coarse_apply_pallas",
              "level": li + 1, "coarse_lattice": list(co.x_diag.shape[:4]),
              "sites": S, "E": E, "max_abs_err": abs_err,
              "max_rel_err": rel, "tolerance": cop.TOLERANCE})
        if not rel <= cop.TOLERANCE:
            fail(f"B8 at level {li + 1} disagrees with its plain version: "
                 f"{rel:.3e}")
        k_ms = median_ms(lambda: cop.coarse_apply_pallas(links, psi9),
                         torch)
        lib_ms = median_ms(lambda: torch.einsum("ksab,ksb->sa", links, psi9),
                           torch)
        p_ms = median_ms(lambda: cop.coarse_apply_ref(links, psi9), torch,
                         repeats=5, batch=2)
        model = cop.coarse_model(E // 2)
        b_ms, bound_by[f"b8:{li + 1}"] = bound(model["bytes_per_site"],
                                               model["flops_per_site"], S)
        timing[f"b8:{li + 1}"] = (k_ms, p_ms, b_ms, lib_ms)
        # the launch B8 made: its resources from its query entry, held to
        # the plan its wrapper mirrors
        res = cop.coarse_info(S, E)
        plan = cop.coarse_plan(S, E)
        if (res["smem_bytes"], res["rows"], res["lanes"], res["grid"]) != (
                plan["smem"], plan["rows"], plan["lanes"], plan["items"]):
            fail(f"B8 at level {li + 1} launched another plan than its "
                 f"wrapper mirrors: {res} against {plan}")
        b8_single[li] = res
        if li == 0:
            # the multi-RHS form at the level-1 null-vector solves' width
            vb = torch.randn((MG_NVEC,) + tuple(v.shape), generator=gen,
                             device=dev)
            psi9_b = co.psi9(vb)
            got = cop.coarse_apply_pallas_mrhs(links, psi9_b)
            want = cop.coarse_apply_mrhs_ref(links, psi9_b)
            singles = [psi9_b[i] for i in range(MG_NVEC)]
            lanes = torch.stack([cop.coarse_apply_pallas(links, q)
                                 for q in singles])
            torch.cuda.synchronize()
            abs_err = (got - want).abs().max().item()
            rel = abs_err / want.abs().max().item()
            rel_lanes = ((got - lanes).abs().max() / lanes.abs().max()).item()
            errs["b8_mrhs"] = abs_err
            emit({"phase": "check", "kernel": "coarse_apply_pallas_mrhs",
                  "level": 1, "sites": S, "E": E, "nrhs": MG_NVEC,
                  "max_abs_err": abs_err, "max_rel_err": rel,
                  "max_rel_err_vs_single": rel_lanes,
                  "lanes_bitwise_single": bool(torch.equal(got, lanes)),
                  "tolerance": cop.TOLERANCE})
            if not (rel <= cop.TOLERANCE and rel_lanes <= cop.TOLERANCE):
                fail(f"B8's multi-RHS form disagrees with its plain version "
                     f"({rel:.3e}) or with single launches ({rel_lanes:.3e})")
            k_ms = median_ms(lambda: cop.coarse_apply_pallas_mrhs(
                links, psi9_b), torch)
            single_ms = median_ms(lambda: [cop.coarse_apply_pallas(links, q)
                                           for q in singles], torch, batch=2)
            lib_ms = median_ms(lambda: torch.einsum("ksab,nksb->nsa", links,
                                                    psi9_b), torch)
            p_ms = median_ms(lambda: cop.coarse_apply_mrhs_ref(links,
                                                               psi9_b),
                             torch, repeats=5, batch=2)
            n = MG_NVEC
            b_ms, bound_by["b8_mrhs"] = bound(
                (36 * E * E + 40 * E * n) / n, 18 * E * E, S * n)
            timing["b8_mrhs"] = (k_ms, p_ms, b_ms, lib_ms, single_ms)
            timing["b8_mrhs_E"] = E
            del vb, psi9_b, singles, lanes
        del links, psi9, got, want
    # the two multi-RHS kernels' resources at the shapes timed above, from
    # their query entries (cudaFuncGetAttributes, the occupancy API), held
    # to the plans their wrappers mirror
    b5_res = wpp.full_mrhs_info(b5_rows, wpp.FULL_MRHS_CHUNK, T, Z, Y, X)
    b5_plan = wpp.full_mrhs_plan(b5_rows, T, Z, Y, X)
    b8_res = cop.mrhs_info(timing["b8_mrhs_E"], MG_NVEC)
    b8_plan = cop.mrhs_plan(timing["b8_mrhs_E"], MG_NVEC)
    if (b5_res["smem_bytes"], b5_res["threads"], b5_res["blocks"]) != (
            b5_plan["smem"], b5_plan["threads"], b5_plan["blocks"]) or (
            b8_res["smem_bytes"], b8_res["threads"], b8_res["nc"],
            b8_res["chunks"]) != (b8_plan["smem"], b8_plan["threads"],
                                  b8_plan["nc"], b8_plan["chunks"]):
        fail(f"a multi-RHS kernel launched another plan than its wrapper "
             f"mirrors: B5 {b5_res} against {b5_plan}, B8-mrhs {b8_res} "
             f"against {b8_plan}")
    emit({"phase": "timing", "family": "multigrid",
          "dims_xyzt": list(PROD_DIMS), "nvidia_smi": smi,
          "repeats": REPEATS, "calls_per_timing": BATCH,
          "b5": {"nrhs": MG_NVEC, "chunk": wpp.FULL_MRHS_CHUNK,
                 "registers": b5_res["registers"],
                 "smem_bytes_per_block": b5_res["smem_bytes"],
                 "blocks_per_sm": b5_res["blocks_per_sm"],
                 "ms": timing["b5"][0], "plain_ms": timing["b5"][1],
                 "bound_ms": timing["b5"][2],
                 "share_of_bound": timing["b5"][2] / timing["b5"][0],
                 "b4_launches_ms": timing["b5"][3],
                 "amortisation": timing["b5"][3] / timing["b5"][0],
                 f"ms_at_n{MG_NVEC // 2}": timing[f"b5:{MG_NVEC // 2}:ms"],
                 f"bound_ms_at_n{MG_NVEC // 2}": bound(
                     wpp.bytes_per_site_mrhs(MG_NVEC // 2),
                     wpp.flops_per_site_mrhs(MG_NVEC // 2), vol)[0]},
          **{f"b8_level{li + 1}": {
              "sites_E": b8_level_keys[li],
              "launches": b8_path[b8_level_keys[li]],
              "ms": timing[f"b8:{li + 1}"][0],
              "plain_ms": timing[f"b8:{li + 1}"][1],
              "bound_ms": timing[f"b8:{li + 1}"][2],
              "share_of_bound": timing[f"b8:{li + 1}"][2]
              / timing[f"b8:{li + 1}"][0],
              "einsum_ms": timing[f"b8:{li + 1}"][3],
              "registers": b8_single[li]["registers"],
              "smem_bytes_per_block": b8_single[li]["smem_bytes"],
              "blocks_per_sm": b8_single[li]["blocks_per_sm"],
              "rows_per_tile": b8_single[li]["rows"],
              "lanes_per_row": b8_single[li]["lanes"],
              "grid": b8_single[li]["grid"]}
             for li in range(len(coarse))},
          "b8_mrhs_level1": {
              "nrhs": MG_NVEC, "registers": b8_res["registers"],
              "smem_bytes_per_block": b8_res["smem_bytes"],
              "blocks_per_sm": b8_res["blocks_per_sm"],
              "threads_per_block": b8_res["threads"],
              "nrhs_per_chunk": b8_res["nc"], "chunks": b8_res["chunks"],
              "ms": timing["b8_mrhs"][0],
              "plain_ms": timing["b8_mrhs"][1],
              "bound_ms": timing["b8_mrhs"][2],
              "share_of_bound": timing["b8_mrhs"][2] / timing["b8_mrhs"][0],
              "einsum_ms": timing["b8_mrhs"][3],
              "single_launches_ms": timing["b8_mrhs"][4],
              "amortisation": timing["b8_mrhs"][4] / timing["b8_mrhs"][0]},
          "cg": {"iters": p_cg.iter_count, "secs": p_cg.secs},
          "mg": {"setup_seconds": setup_s, "solves": solves}})
    k_ms, p_ms, b_ms, _ = timing["b5"]
    rows = [{"name": "dslash_pallas_packed_mrhs[full:f32->f32]",
             "route": "cuda", "source": "quda_tpu_torch/csrc/wilson_full.cu",
             "replaces": "quda_tpu/ops/wilson_pallas_packed.py:557",
             "launches": path["b5"], "max_abs_err": errs[f"b5:{MG_NVEC}"],
             "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
             "bound_by": bound_by["b5"], "library_ms": None}]
    # B8 once a coarse level: its launches on the main path at that
    # level's (S, E), its times at that level's shapes
    for li in range(len(coarse)):
        k_ms, p_ms, b_ms, lib_ms = timing[f"b8:{li + 1}"]
        rows.append({"name": f"coarse_apply_pallas[level{li + 1}]",
                     "route": "cuda",
                     "source": "quda_tpu_torch/csrc/coarse.cu",
                     "replaces": "quda_tpu/ops/coarse_pallas.py:99",
                     "launches": b8_path[b8_level_keys[li]],
                     "max_abs_err": errs[f"b8:{li + 1}"],
                     "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                     "bound_by": bound_by[f"b8:{li + 1}"],
                     "library_ms": lib_ms, "sites_E": b8_level_keys[li],
                     "share_of_bound": b_ms / k_ms})
    k_ms, p_ms, b_ms, lib_ms, _ = timing["b8_mrhs"]
    rows.append({"name": "coarse_apply_pallas_mrhs", "route": "cuda",
                 "source": "quda_tpu_torch/csrc/coarse.cu",
                 "replaces": "quda_tpu/ops/coarse_pallas.py:99",
                 "launches": path["b8_mrhs"],
                 "max_abs_err": errs["b8_mrhs"], "ms": k_ms,
                 "plain_ms": p_ms, "bound_ms": b_ms,
                 "bound_by": bound_by["b8_mrhs"], "library_ms": lib_ms})
    return rows, gauge


def staggered_mg(torch, dev, smi, gauge) -> list:
    """The staggered/HISQ multigrid at 32^3 x 64 on multigrid()'s
    generated beta 6.0 gauge and the staggered operator API (ROADMAP
    A12, B6; phases hisq_mg, invert_stag_cg, stag_mg_setup,
    invert_stag_mg, dslash, check, timing); returns the kernels-line rows
    of S2-full, S2-mrhs-full and S1-full."""
    import quda_tpu_torch as qt
    from quda_tpu_torch.fields.gauge import GaugeField
    from quda_tpu_torch.fields.geometry import LatticeGeometry
    from quda_tpu_torch.fields.spinor import even_odd_join, even_odd_split
    from quda_tpu_torch.gauge import hisq
    from quda_tpu_torch.interfaces import quda_api as api
    from quda_tpu_torch.models.staggered import DiracStaggered
    from quda_tpu_torch.ops import coarse_pallas as cop
    from quda_tpu_torch.ops import staggered_packed as spk
    from quda_tpu_torch.ops import staggered_pallas as spl
    from quda_tpu_torch.ops import wilson_packed as wpk
    from quda_tpu_torch.ops.wilson import split_gauge_eo

    f32, c128 = torch.float32, torch.complex128
    geom = LatticeGeometry(PROD_DIMS)
    vol = geom.volume
    T, Z, Y, X = geom.lattice_shape
    gen = torch.Generator(device=dev).manual_seed(SEED + 37)
    torch.cuda.empty_cache()
    fat_name = spl.pass_form_name(1, f32, f32)
    naik_name = spl.pass_form_name(3, f32, f32)
    s1_name = spl.form_name(f32, f32)

    def bound(nbytes, nflop, sites):
        t_bytes = nbytes * sites / HBM_BYTES_PER_S
        t_ops = nflop * sites / F32_FLOPS_PER_S
        return (1e3 * max(t_bytes, t_ops),
                "bytes" if t_bytes >= t_ops else "operations")

    def counts():
        return {"s2_full": dict(spl.dslash_staggered_pass.launches_by_form),
                "s2_mrhs_full":
                    dict(spl.dslash_staggered_pass_mrhs.launches_by_form),
                "s1_full":
                    dict(spl.dslash_staggered_pallas_fused.launches_by_form),
                "b8": cop.coarse_apply_pallas.launches,
                "b8_mrhs": cop.coarse_apply_pallas_mrhs.launches,
                "s1_eo": spl.dslash_staggered_eo_pallas_fused.launches}

    def zero():
        spl.reset_launches()
        cop.reset_launches()

    def rel_err(got, want):
        return ((got - want).abs().max() / want.abs().max()).item()

    # -- hisq_mg: HISQ links of the heatbath gauge -----------------------
    src = torch.randn(geom.lattice_shape + (1, 3), generator=gen, device=dev,
                      dtype=torch.complex64)
    qt.init_quda(dev)
    qt.load_gauge_quda(gauge, qt.GaugeParam(X=PROD_DIMS, cuda_prec="single"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    links = qt.compute_ks_link_quda()
    torch.cuda.synchronize()
    ks_secs = time.perf_counter() - t0
    w_dev = hisq.unitarity_violation(links.w_unitarized)
    fat, lng = links.fat, links.long
    del links
    emit({"phase": "hisq_mg", "dims_xyzt": list(PROD_DIMS),
          "gauge": "multigrid's heatbath gauge, beta 6.0",
          "plaq_quda": qt.plaq_quda(), "seconds": ks_secs,
          "max_unitarity_err": w_dev,
          "fat_norm": torch.linalg.vector_norm(fat).item(),
          "long_norm": torch.linalg.vector_norm(lng).item()})
    if not w_dev <= 1e-5:
        fail(f"HISQ on the heatbath gauge: |W^dag W - 1| = {w_dev:.2e}")

    # -- invert_stag_cg: the baseline at a light mass -------------------
    p_cg = qt.InvertParam(dslash_type="hisq", inv_type="cg",
                          solve_type="direct-pc", mass=STAG_MG_MASS, tol=TOL,
                          maxiter=20000, cuda_prec="single")
    qt.invert_quda(src, p_cg)
    emit({"phase": "invert_stag_cg", "dims_xyzt": list(PROD_DIMS),
          "mass": STAG_MG_MASS, "tol": TOL, "iters": p_cg.iter_count,
          "secs": p_cg.secs, "true_res": p_cg.true_res,
          "converged": p_cg.converged})
    if not (p_cg.converged and p_cg.iter_count >= STAG_MG_CG_MIN_ITERS):
        fail(f"baseline hisq CG at m {STAG_MG_MASS}: {p_cg.iter_count} "
             f"iterations, converged {p_cg.converged} (needs >= "
             f"{STAG_MG_CG_MIN_ITERS} and converged)")

    # -- stag_mg_setup and invert_stag_mg: the main path ----------------
    ip = qt.InvertParam(dslash_type="hisq", inv_type="gcr-mg",
                        solve_type="direct", mass=STAG_MG_MASS, tol=TOL,
                        cuda_prec="single")
    mp = qt.MultigridParamAPI(**MG_PARAMS)
    torch.cuda.reset_peak_memory_stats(dev)
    zero()
    hier = qt.new_multigrid_quda(mp, ip)
    c_setup = counts()
    report = hier.verify(galerkin_tol=MG_VERIFY_TOL, pr_tol=MG_VERIFY_TOL)
    emit({"phase": "stag_mg_setup", "dims_xyzt": list(PROD_DIMS),
          "mass": STAG_MG_MASS, "params": dict(MG_PARAMS),
          "smoother": [p.smoother for p in hier.params],
          "setup_solver": [p.setup_solver for p in hier.params],
          "coarse_lattices": [list(lv["transfer"].coarse_shape)
                              for lv in hier.levels],
          "setup_seconds": hier.setup_seconds,
          "setup_breakdown": hier.setup_breakdown,
          "null_vector_cg_fallback_levels": hier.null_fallbacks,
          "verify": report, "launches": c_setup,
          "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9})
    solves = []
    for rep in range(2):
        zero()
        x = qt.invert_quda(src, ip)
        c = counts()
        solves.append({"iters": ip.iter_count, "secs": ip.secs,
                       "true_res": ip.true_res, "converged": ip.converged,
                       "launches": c})
        row = {"phase": "invert_stag_mg", "solve": rep, "mass": STAG_MG_MASS,
               "tol": TOL, "gcr_nkrylov": ip.gcrNkrylov,
               "outer_iters": ip.iter_count, "secs": ip.secs,
               "true_res": ip.true_res, "converged": ip.converged,
               "hierarchy_reused": api._ctx["mg"] is hier, "launches": c,
               "cg_iters": p_cg.iter_count, "cg_secs": p_cg.secs,
               "fewer_outer_iters_than_cg":
                   ip.iter_count < p_cg.iter_count,
               "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
        if rep == 0:
            # the true residual once more, with the complex128 fat + Naik
            # operator (no kernel)
            d128 = DiracStaggered(fat.to(c128), geom, STAG_MG_MASS,
                                  improved=True, long_links=lng.to(c128))
            b128 = src.to(c128)
            r = b128 - d128.M(x.to(c128))
            row["true_res_complex128"] = (torch.linalg.vector_norm(r)
                                          / torch.linalg.vector_norm(
                                              b128)).item()
            del d128, b128, r
        emit(row)
        if not (ip.converged and ip.true_res <= TRUE_RES_MAX
                and row.get("true_res_complex128", 0.0) <= TRUE_RES_MAX):
            fail(f"staggered gcr-mg: converged {ip.converged}, true_res "
                 f"{ip.true_res:.3e} ({row.get('true_res_complex128')})")
        # the JAX package's criterion, fewer outer iterations than CG
        # (it held at STAG_MG_MASS: PERF.md)
        if not ip.iter_count < p_cg.iter_count:
            fail(f"staggered gcr-mg: {ip.iter_count} outer iterations "
                 f"against CG's {p_cg.iter_count}")
        if rep == 1 and not (api._ctx["mg"] is hier
                             and not c["s2_mrhs_full"]):
            fail("the second staggered gcr-mg solve did not reuse the "
                 "hierarchy")
    # the main path: new_multigrid_quda and the first invert_quda
    path = {"fat": c_setup["s2_full"].get(fat_name, 0)
            + solves[0]["launches"]["s2_full"].get(fat_name, 0),
            "mrhs": c_setup["s2_mrhs_full"].get(fat_name, 0)
            + solves[0]["launches"]["s2_mrhs_full"].get(fat_name, 0),
            "s1": c_setup["s1_full"].get(s1_name, 0)
            + solves[0]["launches"]["s1_full"].get(s1_name, 0)}
    if min(path.values()) < 1 or solves[0]["launches"]["s1_eo"]:
        fail(f"the staggered multigrid path did not run S2-full, "
             f"S2-mrhs-full and S1-full (or ran the eo S1): {path}")
    fat_pl = hier.adapter.fat_pl
    fat_bw = hier.adapter.fat_bw
    long_pl = hier.adapter.long_pl
    setup_s = hier.setup_seconds
    del x, hier
    qt.destroy_multigrid_quda()
    torch.cuda.empty_cache()

    # -- dslash: the operator API (hisq, fat-only) against complex128 ---
    def op_api(dt):
        p = qt.InvertParam(dslash_type=dt, mass=STAG_MG_MASS,
                           cuda_prec="single")
        zero()
        out = {"mat_quda": qt.mat_quda(src, p),
               "mat_dag_mat_quda": qt.mat_dag_mat_quda(src, p)}
        c = counts()
        improved = dt != "staggered"
        d = DiracStaggered((fat if improved else gauge).to(c128), geom,
                           STAG_MG_MASS, improved=improved,
                           long_links=lng.to(c128))
        s128 = src.to(c128)
        want = {"mat_quda": d.M(s128), "mat_dag_mat_quda": d.MdagM(s128)}
        rel = {k: rel_err(out[k].to(c128), want[k]) for k in out}
        del d, s128, want, out
        return rel, c
    dslash_rows = {}
    for dt in ("hisq", "staggered"):
        rel, c = op_api(dt)
        launched = (c["s1_full"].get(s1_name, 0) if dt == "hisq"
                    else c["s2_full"].get(fat_name, 0))
        dslash_rows[dt] = {"rel_err_vs_complex128": rel, "launches": launched}
        if not (max(rel.values()) <= TRUE_RES_MAX and launched == 3):
            fail(f"staggered operator API ({dt}) disagrees with the "
                 f"complex128 operator ({rel}) or ran {launched} launches, "
                 "not 3")
    try:
        qt.mat_quda(src, qt.InvertParam(dslash_type="hisq",
                                        mass=STAG_MG_MASS,
                                        cuda_prec="double"))
        fail("mat_quda for hisq at double did not raise")
    except NotImplementedError as exc:
        if "ROADMAP A7" not in str(exc):
            fail(f"mat_quda at double raised without naming A7: {exc}")
    qt.end_quda()
    # S1-full and S2-full at 32^3 x 64 (the heatbath HISQ links) and at
    # 32^4 (config 4; HISQ links of a random gauge)
    timing, bound_by = {}, {}
    psi = torch.randn((3, 2, T, Z, Y * X), generator=gen, device=dev)
    geom4 = LatticeGeometry(STAG_DIMS)
    T4, Z4, Y4, X4 = geom4.lattice_shape
    links4 = hisq.hisq_fattening(GaugeField.random(
        geom4, gen, dtype=torch.complex64, device=dev).data)
    d4 = DiracStaggered(links4.fat, geom4, STAG_MG_MASS, improved=True,
                        long_links=links4.long).pairs()
    del links4
    fat4_bw = spl.backward_links(d4.fat_pl, X4, 1).contiguous()
    psi4 = torch.randn((3, 2, T4, Z4, Y4 * X4), generator=gen, device=dev)
    for label, sites, args in (
            ("32^3x64", vol, (fat_pl, fat_bw, long_pl, psi, X)),
            ("32^4", geom4.volume, (d4.fat_pl, fat4_bw, d4.long_pl, psi4,
                                    X4))):
        u, ubw, ul, p, xx = args
        s1_ms = median_ms(lambda: spl.dslash_staggered_pallas_fused(
            u, p, xx, ul), torch)
        s2_ms = median_ms(lambda: spl.dslash_staggered_pass(u, ubw, p, xx,
                                                            1), torch)
        s1_b, bound_by["s1"] = bound(spl.FULL_BYTES_PER_SITE,
                                     spl.FUSED_FLOPS_PER_SITE, sites)
        s2_b, bound_by["s2"] = bound(spl.FULL_BYTES_PER_SITE,
                                     spl.PASS_FLOPS_PER_SITE, sites)
        timing[label] = {
            "s1_full_ms": s1_ms, "s1_full_bound_ms": s1_b,
            "s1_full_share_of_bound": s1_b / s1_ms,
            "s1_full_gflops_1146": spl.FUSED_FLOPS_PER_SITE * sites
            / s1_ms / 1e6,
            "s2_full_fat_ms": s2_ms, "s2_full_bound_ms": s2_b,
            "s2_full_share_of_bound": s2_b / s2_ms,
            "s2_full_gflops_570": spl.PASS_FLOPS_PER_SITE * sites
            / s2_ms / 1e6}
    emit({"phase": "dslash", "family": "staggered", "mass": STAG_MG_MASS,
          "operator_api": dslash_rows, "tolerance": TRUE_RES_MAX,
          "double_refused_naming": "A7", "timing": timing,
          "nvidia_smi": smi})
    del d4, fat4_bw, psi4

    # -- check: every full-lattice form against its plain version, at
    # 8x10x12x14 and at full width (the main path's links); lanes and
    # fat + Naik bit for bit; each form on one parity against the eo form
    errs = {fat_name: 0.0, naik_name: 0.0, s1_name: 0.0, "mrhs": 0.0}
    long_bw = spl.backward_links(long_pl, X, 3).contiguous()
    small = LatticeGeometry(STAG_SMALL_DIMS)
    Ts, Zs, Ys, Xs = small.lattice_shape
    small_links = [torch.randn((4, 3, 3, 2, Ts, Zs, Ys * Xs), generator=gen,
                               device=dev) * sc for sc in (1.0, 1.0 / 24)]
    for label, (u, ubw, ul, ulbw, xx, shape) in (
            ("8x10x12x14", (small_links[0],
                            spl.backward_links(small_links[0], Xs,
                                               1).contiguous(),
                            small_links[1],
                            spl.backward_links(small_links[1], Xs,
                                               3).contiguous(), Xs,
                            (Ts, Zs, Ys * Xs))),
            ("32^3x64", (fat_pl, fat_bw, long_pl, long_bw, X,
                         (T, Z, Y * X)))):
        for n in (3, MG_NVEC):
            pb = torch.randn((n, 3, 2) + shape, generator=gen, device=dev)
            q = pb[0].contiguous()
            got = {fat_name: spl.dslash_staggered_pass(u, ubw, q, xx, 1),
                   naik_name: spl.dslash_staggered_pass(ul, ulbw, q, xx, 3),
                   s1_name: spl.dslash_staggered_pallas_fused(u, q, xx, ul)}
            want = {fat_name: spl.dslash_staggered_pass_plain(u, ubw, q, xx,
                                                              1),
                    naik_name: spl.dslash_staggered_pass_plain(ul, ulbw, q,
                                                               xx, 3),
                    s1_name: spl.dslash_staggered_fused_plain(u, ul, q, xx)}
            mrhs = spl.dslash_staggered_pass_mrhs(u, ubw, pb, xx, 1)
            both = spl.dslash_staggered_pallas_mrhs(u, ubw, pb, xx, ul, ulbw)
            mrhs_want = spl.dslash_staggered_pass_mrhs_plain(u, ubw, pb, xx,
                                                             1)
            lanes = all(torch.equal(mrhs[i], spl.dslash_staggered_pass(
                u, ubw, pb[i].contiguous(), xx, 1)) for i in range(n))
            lanes_s1 = all(torch.equal(both[i],
                                       spl.dslash_staggered_pallas_fused(
                                           u, pb[i].contiguous(), xx, ul))
                           for i in range(n))
            torch.cuda.synchronize()
            row = {"phase": "check", "kernel": "staggered_full",
                   "dims": label, "nrhs": n, "tolerance": STAG_FULL_TOL,
                   "mrhs_lanes_bitwise_s2_full": lanes,
                   "mrhs_fat_plus_naik_bitwise_s1_full": lanes_s1,
                   "s1_full_bitwise_s2_full_sum": bool(torch.equal(
                       got[s1_name], got[fat_name] + got[naik_name]))}
            worst = 0.0
            for name in got:
                a = (got[name] - want[name]).abs().max().item()
                r = a / want[name].abs().max().item()
                errs[name] = max(errs[name], a)
                row[name] = {"max_abs_err": a, "max_rel_err": r}
                worst = max(worst, r)
            a = (mrhs - mrhs_want).abs().max().item()
            r = a / mrhs_want.abs().max().item()
            errs["mrhs"] = max(errs["mrhs"], a)
            row["mrhs:" + fat_name] = {"max_abs_err": a, "max_rel_err": r}
            worst = max(worst, r)
            emit(row)
            if not (worst <= STAG_FULL_TOL and lanes and lanes_s1
                    and row["s1_full_bitwise_s2_full_sum"]):
                fail(f"a full-lattice staggered form disagrees ({label}, N = "
                     f"{n}): {row}")
            del pb, q, got, want, mrhs, both, mrhs_want
    # one parity of the full-lattice forms against the eo kernels
    lat_full = geom.lattice_shape

    def canon(pl):
        return wpk.unpack_gauge(wpk.from_packed_pairs(pl), lat_full)

    def eo_links(pl):
        return [wpk.to_packed_pairs(spk.pack_links(g), f32).contiguous()
                for g in split_gauge_eo(canon(pl), geom)]

    def pairs(v):
        return wpk.to_packed_pairs(spk.pack_staggered(v), f32).contiguous()

    fat_eo, long_eo = eo_links(fat_pl), eo_links(long_pl)
    halves = even_odd_split(src, geom)
    parity_rel = {}
    for parity in (0, 1):
        only = [torch.zeros_like(halves[0]), torch.zeros_like(halves[0])]
        only[1 - parity] = halves[1 - parity]
        full_in = pairs(even_odd_join(only[0], only[1], geom))
        eo_in = pairs(only[1 - parity])
        ebw = spl.backward_links_eo(fat_eo[1 - parity], lat_full, parity,
                                    1).contiguous()
        for name, full_out, eo_out in (
                (s1_name, spl.dslash_staggered_pallas_fused(
                    fat_pl, full_in, X, long_pl),
                 spl.dslash_staggered_eo_pallas_fused(
                     fat_eo[parity], fat_eo[1 - parity], eo_in, lat_full,
                     parity, long_eo[parity], long_eo[1 - parity])),
                (fat_name, spl.dslash_staggered_pass(fat_pl, fat_bw, full_in,
                                                     X, 1),
                 spl.dslash_staggered_eo_pass(fat_eo[parity], ebw, eo_in,
                                              lat_full, parity, 1))):
            got = even_odd_split(spk.unpack_staggered(
                wpk.from_packed_pairs(full_out), lat_full), geom)[parity]
            want = spk.unpack_staggered(wpk.from_packed_pairs(eo_out),
                                        geom.half_lattice_shape)
            parity_rel[f"{name}:parity{parity}"] = rel_err(got, want)
    emit({"phase": "check", "kernel": "staggered_full_vs_eo",
          "dims_xyzt": list(PROD_DIMS), "rel_err": parity_rel,
          "tolerance": STAG_FULL_TOL})
    if max(parity_rel.values()) > STAG_FULL_TOL:
        fail(f"a full-lattice form on one parity disagrees with the eo "
             f"kernel: {parity_rel}")
    del fat_eo, long_eo, halves, small_links

    # -- timing: S2-mrhs-full at N = 24 against 24 S2-full launches, each
    # form against its plain version and its bound ---------------------
    n = MG_NVEC
    pb = torch.randn((n, 3, 2, T, Z, Y * X), generator=gen, device=dev)
    singles = [pb[i].contiguous() for i in range(n)]
    k_ms = median_ms(lambda: spl.dslash_staggered_pass_mrhs(
        fat_pl, fat_bw, pb, X, 1), torch)
    naik_mrhs_ms = median_ms(lambda: spl.dslash_staggered_pass_mrhs(
        long_pl, long_bw, pb, X, 3), torch)
    acc_b = spl.dslash_staggered_pass_mrhs(fat_pl, fat_bw, pb, X, 1)
    naik_acc_ms = median_ms(lambda: spl.dslash_staggered_pass_mrhs(
        long_pl, long_bw, pb, X, 3, acc=acc_b), torch)
    naik_acc_b_ms = bound(spl.pass_mrhs_bytes_per_site(n, True),
                          spl.PASS_FLOPS_PER_SITE * n, vol)[0]
    del acc_b
    # its resources from the query entry, held to the plan its wrapper
    # mirrors (the fat instance, and the accumulating Naik one)
    s2m_res = {}
    plan = spl.full_mrhs_plan(T, Z, Y, X)
    for key, nhop, accum in (("fat", 1, False), ("naik_accum", 3, True)):
        res = spl.full_mrhs_info(nhop, accum, T, Z, Y, X)
        if (res["smem_bytes"], res["threads"], res["tiles"],
                res["blocks"]) != (plan["smem"], plan["threads"],
                                   plan["tiles"], plan["blocks"]):
            fail(f"S2-mrhs-full launched another plan than its wrapper "
                 f"mirrors: {res} against {plan}")
        s2m_res[key] = {"registers": res["registers"],
                        "blocks_per_sm": res["blocks_per_sm"]}
    single_ms = median_ms(lambda: [spl.dslash_staggered_pass(
        fat_pl, fat_bw, q, X, 1) for q in singles], torch, batch=2)
    p_ms = median_ms(lambda: spl.dslash_staggered_pass_mrhs_plain(
        fat_pl, fat_bw, pb, X, 1), torch, repeats=3, batch=1)
    b_ms, bound_by["mrhs"] = bound(spl.pass_mrhs_bytes_per_site(n),
                                   spl.PASS_FLOPS_PER_SITE * n, vol)
    prod = timing["32^3x64"]
    s2_p_ms = median_ms(lambda: spl.dslash_staggered_pass_plain(
        fat_pl, fat_bw, psi, X, 1), torch, repeats=5, batch=2)
    naik_ms = median_ms(lambda: spl.dslash_staggered_pass(
        long_pl, long_bw, psi, X, 3), torch)
    s1_p_ms = median_ms(lambda: spl.dslash_staggered_fused_plain(
        fat_pl, long_pl, psi, X), torch, repeats=5, batch=2)
    emit({"phase": "timing", "family": "staggered_mg",
          "dims_xyzt": list(PROD_DIMS), "nvidia_smi": smi,
          "repeats": REPEATS, "calls_per_timing": BATCH,
          "s2_full": {"fat_ms": prod["s2_full_fat_ms"], "naik_ms": naik_ms,
                      "plain_ms": s2_p_ms,
                      "bound_ms": prod["s2_full_bound_ms"],
                      "share_of_bound": prod["s2_full_share_of_bound"]},
          "s1_full": {"ms": prod["s1_full_ms"], "plain_ms": s1_p_ms,
                      "bound_ms": prod["s1_full_bound_ms"],
                      "share_of_bound": prod["s1_full_share_of_bound"]},
          "s2_mrhs_full": {"nrhs": n, "chunk": spl.FULL_MRHS_CHUNK,
                           "lanes": spl.FULL_MRHS_LANES,
                           "fat_ms": k_ms, "naik_ms": naik_mrhs_ms,
                           "plain_ms": p_ms, "bound_ms": b_ms,
                           "share_of_bound": b_ms / k_ms,
                           "naik_accum_ms": naik_acc_ms,
                           "naik_accum_bound_ms": naik_acc_b_ms,
                           "naik_accum_share_of_bound":
                               naik_acc_b_ms / naik_acc_ms,
                           "s2_full_launches_ms": single_ms,
                           "amortisation": single_ms / k_ms,
                           "smem_bytes_per_block": plan["smem"],
                           "threads_per_block": plan["threads"],
                           "tiles_per_plane": plan["tiles"],
                           "blocks": plan["blocks"],
                           "resources": s2m_res},
          "cg": {"iters": p_cg.iter_count, "secs": p_cg.secs},
          "mg": {"setup_seconds": setup_s, "solves": solves}})
    del pb, singles, psi
    src_file = "quda_tpu_torch/csrc/staggered_full.cu"
    return [
        {"name": f"dslash_staggered_pass[{fat_name}]", "route": "cuda",
         "source": src_file,
         "replaces": "quda_tpu/ops/staggered_pallas.py:204",
         "launches": path["fat"], "max_abs_err": errs[fat_name],
         "ms": prod["s2_full_fat_ms"], "plain_ms": s2_p_ms,
         "bound_ms": prod["s2_full_bound_ms"], "bound_by": bound_by["s2"],
         "library_ms": None},
        {"name": f"dslash_staggered_pass_mrhs[{fat_name}]", "route": "cuda",
         "source": src_file,
         "replaces": "quda_tpu/ops/staggered_pallas.py:1106",
         "launches": path["mrhs"], "max_abs_err": errs["mrhs"], "ms": k_ms,
         "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": bound_by["mrhs"],
         "library_ms": None},
        {"name": f"dslash_staggered_pallas_fused[{s1_name}]",
         "route": "cuda", "source": src_file,
         "replaces": "quda_tpu/ops/staggered_pallas.py:966",
         "launches": path["s1"], "max_abs_err": errs[s1_name],
         "ms": prod["s1_full_ms"], "plain_ms": s1_p_ms,
         "bound_ms": prod["s1_full_bound_ms"], "bound_by": bound_by["s1"],
         "library_ms": None}]


def precision(torch, dev, smi, gauge, src, srcs, half_ref, df64_ref,
              multi_r12_iters) -> list:
    """Wilson quarter precision and the copy-free link forms (phases
    check, invert_quarter, precision_solve, timing with "family":
    "precision"); returns the kernels-line rows of v3, r12f, r12f-mrhs and
    int8.  ``gauge`` and ``src`` are the main path's hot gauge and
    source, ``srcs`` its 12 sources; ``half_ref`` the single/half route's
    (iterations, reliable updates) by link form, ``df64_ref`` the df64
    route's, ``multi_r12_iters`` the lanes' iterations of the 12-source
    r12 solve."""
    import quda_tpu_torch as qt
    from quda_tpu_torch.fields.geometry import LatticeGeometry
    from quda_tpu_torch.fields.spinor import even_odd_split
    from quda_tpu_torch.models.wilson import DiracWilson, DiracWilsonPC
    from quda_tpu_torch.ops import blockfloat as tbf
    from quda_tpu_torch.ops import wilson_pallas_packed as wpp
    from quda_tpu_torch.solvers.block import batched_cg_pairs
    from quda_tpu_torch.solvers.fused_iter import fused_cg
    from quda_tpu_torch.solvers.mixed import cg_reliable, pair_inplace_codec

    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    geom_p = LatticeGeometry(PROD_DIMS)
    half = geom_p.half_volume
    errs = {}
    there = {"v3": wpp.dslash_eo_pallas_packed_v3,
             "r12f": wpp.dslash_eo_pallas_packed_r12f}
    there_forms = [(3, f32, f32), (3, bf16, bf16), (3, bf16, f32),
                   (2, f32, f32), (2, bf16, bf16), (2, bf16, f32)]
    int8_forms = [(f32, f32), (bf16, bf16), (bf16, f32)]

    def inputs(dims_xyzt, rows, store, n=None):
        T, Z, Y, X = LatticeGeometry(dims_xyzt).lattice_shape
        sites = (T, Z, Y * X // 2)
        lead = () if n is None else (n,)
        u_here, u_there = (torch.randn((4, rows, 3, 2) + sites, generator=gen,
                                       device=dev).to(store)
                           for _ in range(2))
        psi = torch.randn(lead + (4, 3, 2) + sites, generator=gen,
                          device=dev).to(store)
        return (T, Z, Y, X), u_here, u_there, psi

    def check(kernel, name, dims_xyzt, parity, got, want, twin, tol,
              **info):
        """``got`` within ``tol`` of the plain ``want``, and bit for bit
        ``twin`` (the resident-copy kernel on the same links)."""
        torch.cuda.synchronize()
        abs_err = (got.float() - want.float()).abs().max().item()
        rel = abs_err / want.float().abs().max().item()
        same = bool(torch.equal(got, twin))
        key = f"{kernel}:{name}"
        errs[key] = max(errs.get(key, 0.0), abs_err)
        emit({"phase": "check", "kernel": kernel, "form": name,
              "dims_xyzt": list(dims_xyzt), "parity": parity,
              "max_abs_err": abs_err, "max_rel_err": rel, "tolerance": tol,
              "bit_for_bit_twin": same, **info})
        if not (rel <= tol and same):
            fail(f"{kernel} {name} disagrees with its plain version "
                 f"({rel:.3e} > {tol:g}) or with its twin (equal: {same})")

    # -- check: the copy-free hops against plain and B1, the int8 hop
    # against plain and B1 on the decoded links, r12f-mrhs lanes ---------
    for dims_xyzt in (SMALL_DIMS, PROD_DIMS):
        for parity in (0, 1):
            for rows, store, out in there_forms:
                dims, u_here, u_there, psi = inputs(dims_xyzt, rows, store)
                u_bw = wpp.backward_gauge_eo(u_there, dims,
                                             parity).contiguous()
                b1 = wpp.dslash_eo_pallas_packed(u_here, u_bw, psi, dims,
                                                 parity, out_dtype=out)
                want = wpp.dslash_eo_there_plain(u_here, u_there, psi, dims,
                                                 parity, out_dtype=out)
                tol = wpp.TOLERANCE if out == f32 else wpp.TOLERANCE_BF16
                for fname, fn in there.items():
                    got = fn(u_here, u_there, psi, dims, parity,
                             out_dtype=out)
                    check(fn.__name__, wpp.form_name(rows, store, out),
                          dims_xyzt, parity, got, want, b1, tol)
                del u_here, u_there, psi, u_bw, b1, want, got
            for store, out in int8_forms:
                dims, u_here, u_there, psi = inputs(dims_xyzt, 3, f32)
                (qh, sh), (qt_, st) = (tbf.to_int8_links(u)
                                       for u in (u_here, u_there))
                psi = psi.to(store)
                got = wpp.dslash_eo_pallas_packed_int8(
                    qh, sh, qt_, st, psi, dims, parity, out_dtype=out)
                want = wpp.dslash_eo_int8_plain(qh, sh, qt_, st, psi, dims,
                                                parity, out_dtype=out)
                u_bw = wpp.backward_gauge_eo(tbf.from_int8_links(qt_, st),
                                             dims, parity).contiguous()
                b1 = wpp.dslash_eo_pallas_packed(
                    tbf.from_int8_links(qh, sh), u_bw, psi.float(), dims,
                    parity).to(out)
                check("dslash_eo_pallas_packed_int8",
                      wpp.int8_form_name(store, out), dims_xyzt, parity, got,
                      want, b1,
                      wpp.TOLERANCE if out == f32 else wpp.TOLERANCE_BF16)
                del u_here, u_there, psi, qh, sh, qt_, st, u_bw, b1, want, got
            cases = ([(1, 1), (3, 2), (12, 2)] if dims_xyzt == SMALL_DIMS
                     else [(MULTI_SRC_N, wpp.MRHS_CHUNK)])
            for rows in (3, 2):
                for n, chunk in cases:
                    dims, u_here, u_there, psi = inputs(dims_xyzt, rows, f32,
                                                        n)
                    got = wpp.dslash_eo_pallas_packed_r12f_mrhs(
                        u_here, u_there, psi, dims, parity, chunk=chunk)
                    want = wpp.dslash_eo_there_mrhs_plain(u_here, u_there,
                                                          psi, dims, parity)
                    lanes = torch.stack([wpp.dslash_eo_pallas_packed_r12f(
                        u_here, u_there, psi[r], dims, parity)
                        for r in range(n)])
                    check("dslash_eo_pallas_packed_r12f_mrhs",
                          wpp.form_name(rows, f32, f32), dims_xyzt, parity,
                          got, want, lanes, wpp.TOLERANCE, nrhs=n,
                          chunk=chunk)
                    del u_here, u_there, psi, got, want, lanes

    # -- the main paths: counts zeroed just before each, read just after --
    def counts():
        return {f"{fn.__name__}": dict(fn.launches_by_form) for fn in (
            wpp.dslash_eo_pallas_packed, wpp.dslash_eo_pallas_packed_mrhs,
            wpp.dslash_eo_pallas_packed_v3, wpp.dslash_eo_pallas_packed_r12f,
            wpp.dslash_eo_pallas_packed_r12f_mrhs,
            wpp.dslash_eo_pallas_packed_int8)}

    launches, path_iters = {}, {}

    def run(label, fn):
        wpp.reset_launches()
        torch.cuda.synchronize()
        out = fn()
        torch.cuda.synchronize()
        launches[label] = counts()
        return out

    def by(label, fn, form=None):
        got = launches[label][fn.__name__]
        return sum(got.values()) if form is None else got.get(form, 0)

    # invert_quda at quarter: tol 1e-6 (cg_reliable) and 1e-10 (df64)
    quarter = {}
    for tol in (TOL, DF64_TOL):
        qt.init_quda(dev)
        try:
            qt.load_gauge_quda(gauge, qt.GaugeParam(X=PROD_DIMS,
                                                    cuda_prec="single"))
            param = qt.InvertParam(
                dslash_type="wilson", inv_type="cg", solve_type="normop-pc",
                kappa=KAPPA, tol=tol, maxiter=2000, cuda_prec="single",
                cuda_prec_sloppy="quarter")
            torch.cuda.reset_peak_memory_stats(dev)
            x = run(f"quarter:{tol:g}", lambda: qt.invert_quda(src, param))
        finally:
            qt.end_quda()
        label = f"quarter:{tol:g}"
        n_int8 = by(label, wpp.dslash_eo_pallas_packed_int8)
        finite = bool(torch.isfinite(torch.view_as_real(x)).all())
        shape_ok = tuple(x.shape) == geom_p.spinor_shape()
        row = {"phase": "invert_quarter", "dims_xyzt": list(PROD_DIMS),
               "kappa": KAPPA, "tol": tol, "cuda_prec_sloppy": "quarter",
               "iters": param.iter_count,
               "reliable_updates": param.reliable_updates,
               "secs": param.secs, "true_res": param.true_res,
               "converged": param.converged,
               "launches": launches[label],
               "int8_launches_per_iter": n_int8 / param.iter_count,
               "half_iters_reliable_updates": (half_ref["full"] if tol == TOL
                                               else None),
               "df64_single_iters_reliable_updates": (
                   df64_ref if tol != TOL else None),
               "shape_ok": shape_ok, "finite": finite,
               "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
        ok = (param.converged and finite and shape_ok
              and n_int8 >= 4 * param.iter_count)
        if tol == TOL:
            ok = ok and param.true_res <= TRUE_RES_MAX
        else:
            x128 = (x.to(torch.complex128)
                    + param.x_df64_lo.to(torch.complex128))
            d128 = DiracWilson(gauge.to(torch.complex128), geom_p, KAPPA)
            b128 = src.to(torch.complex128)
            oracle = float(torch.linalg.vector_norm(b128 - d128.M(x128))
                           / torch.linalg.vector_norm(b128))
            del x128, d128, b128
            row["true_res_complex128"] = oracle
            ok = ok and param.true_res <= DF64_TOL and oracle <= DF64_TOL
        emit(row)
        quarter[tol] = (param.iter_count, param.reliable_updates, param.secs)
        path_iters[label] = param.iter_count
        if not ok:
            fail(f"quarter invert_quda at tol {tol:g} missed its gates: "
                 f"{row}")
        del x

    # the pair operators' forms: fused_cg (f32) and cg_reliable (f32 /
    # bf16) on the same right-hand side; the copy-free forms against the
    # resident-copy forms they equal bit for bit
    dpk = DiracWilsonPC(gauge, geom_p, KAPPA).packed()
    be, bo = even_odd_split(src, geom_p)
    resident = {}

    def build(store, form, version=2):
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated(dev)
        op = dpk.pairs(store, form, pallas_version=version)
        torch.cuda.synchronize()
        resident[(str(store), form, version)] = \
            torch.cuda.memory_allocated(dev) - m0
        return op

    ops = {"full": build(f32, "full"), "r12": build(f32, "r12"),
           "v3": build(f32, "full", 3), "r12f": build(f32, "r12f"),
           "int8": build(f32, "int8")}
    rhs = ops["full"].Mdag_pairs(ops["full"].prepare_pairs(be, bo))
    solves = {}
    for name, op in ops.items():
        res = run(f"fused_cg:{name}", lambda: fused_cg(
            op.MdagM_pairs, rhs, tol=TOL, maxiter=2000))
        solves[name] = res
        path_iters[f"fused_cg:{name}"] = res.iters
        emit({"phase": "precision_solve", "solver": "fused_cg",
              "operator": name, "dims_xyzt": list(PROD_DIMS), "tol": TOL,
              "iters": res.iters, "converged": res.converged,
              "launches": launches[f"fused_cg:{name}"]})
    if not all(r.converged for r in solves.values()):
        fail(f"fused_cg on a pair operator did not converge: "
             f"{ {k: r.converged for k, r in solves.items()} }")
    for name, twin in (("v3", "full"), ("r12f", "r12")):
        if solves[name].iters != solves[twin].iters or not torch.equal(
                solves[name].x, solves[twin].x):
            fail(f"fused_cg on {name} took {solves[name].iters} iterations "
                 f"or another solution than on {twin} "
                 f"({solves[twin].iters})")
    for name, fn in (("v3", wpp.dslash_eo_pallas_packed_v3),
                     ("r12f", wpp.dslash_eo_pallas_packed_r12f),
                     ("int8", wpp.dslash_eo_pallas_packed_int8)):
        if by(f"fused_cg:{name}", fn) < 4 * solves[name].iters or by(
                f"fused_cg:{name}", wpp.dslash_eo_pallas_packed):
            fail(f"fused_cg on {name} did not run through its kernel only: "
                 f"{launches[f'fused_cg:{name}']}")
    del solves
    ops.update({"bf16:full": build(bf16, "full"),
                "bf16:r12": build(bf16, "r12"),
                "bf16:v3": build(bf16, "full", 3),
                "bf16:r12f": build(bf16, "r12f"),
                "bf16:int8": build(bf16, "int8")})
    codec = pair_inplace_codec(bf16)
    mixed = {}
    for name in ("full", "r12", "v3", "r12f"):
        res = run(f"cg_reliable:{name}", lambda: cg_reliable(
            ops[name].MdagM_pairs, ops[f"bf16:{name}"].MdagM_pairs, rhs,
            codec, tol=TOL, maxiter=2000))
        mixed[name] = res
        path_iters[f"cg_reliable:{name}"] = res.iters
        emit({"phase": "precision_solve", "solver": "cg_reliable",
              "operator": f"{name} / bf16 {name}",
              "dims_xyzt": list(PROD_DIMS), "tol": TOL, "iters": res.iters,
              "reliable_updates": res.reliable_updates,
              "converged": res.converged,
              "launches": launches[f"cg_reliable:{name}"]})
    for name, twin in (("v3", "full"), ("r12f", "r12")):
        if not (mixed[name].converged and mixed[name].iters ==
                mixed[twin].iters and torch.equal(mixed[name].x,
                                                  mixed[twin].x)):
            fail(f"cg_reliable on {name} differs from {twin}: "
                 f"{mixed[name].iters} against {mixed[twin].iters}")
    del mixed

    # 12 sources batched on the r12f operator (the multi-RHS r12f hop)
    # and on the r12 one (B5-eo), the same batch
    be_b, bo_b = (torch.stack(h).contiguous() for h in zip(
        *(even_odd_split(srcs[i], geom_p) for i in range(MULTI_SRC_N))))
    batched = {}
    for name in ("r12", "r12f"):
        op = ops[name]
        rhs_b = op.Mdag_pairs_mrhs(op.prepare_pairs_mrhs(be_b, bo_b))
        res_b = run(f"batched:{name}", lambda: batched_cg_pairs(
            op.MdagM_pairs_mrhs, rhs_b, tol=TOL, maxiter=2000))
        batched[name] = ([int(i) for i in res_b.iters],
                         all(bool(c) for c in res_b.converged))
        path_iters[f"batched:{name}"] = max(batched[name][0])
        emit({"phase": "precision_solve", "solver": "batched_cg_pairs",
              "operator": name, "nrhs": MULTI_SRC_N, "tol": TOL,
              "iters_per_lane": batched[name][0],
              "invert_multi_src_r12_iters": list(multi_r12_iters),
              "converged": batched[name][1],
              "launches": launches[f"batched:{name}"]})
        del rhs_b, res_b
    del be_b, bo_b
    lanes, converged = batched["r12f"]
    n_mrhs = by("batched:r12f", wpp.dslash_eo_pallas_packed_r12f_mrhs)
    if not (converged and lanes == batched["r12"][0]
            and n_mrhs >= 4 * max(lanes)
            and by("batched:r12f", wpp.dslash_eo_pallas_packed_r12f) == 0
            and by("batched:r12f", wpp.dslash_eo_pallas_packed_mrhs) == 0):
        fail(f"the 12-source r12f solve: lanes {lanes} against r12's "
             f"{batched['r12'][0]}, {n_mrhs} multi-RHS r12f launches")

    # -- timing: each new form against its bound and plain version ---------
    def bound(nbytes, nflop, sites=half):
        t_bytes = nbytes * sites / HBM_BYTES_PER_S
        t_ops = nflop * sites / F32_FLOPS_PER_S
        return (1e3 * max(t_bytes, t_ops),
                "bytes" if t_bytes >= t_ops else "operations")

    timing = {}
    for rows, store, out in there_forms:
        dims, u_here, u_there, psi = inputs(PROD_DIMS, rows, store)
        name = wpp.form_name(rows, store, out)
        k_ms = {f: median_ms(lambda: fn(u_here, u_there, psi, dims, 0,
                                        out_dtype=out), torch)
                for f, fn in there.items()}
        p_ms = median_ms(lambda: wpp.dslash_eo_there_plain(
            u_here, u_there, psi, dims, 0, out_dtype=out), torch, 5, 2)
        b_ms, b_by = bound(wpp.bytes_per_site(rows, store, out),
                           wpp.flops_per_site(rows))
        for f in there:
            timing[f"{f}:{name}"] = (k_ms[f], p_ms, b_ms, b_by)
        del u_here, u_there, psi
    for store, out in int8_forms:
        dims, u_here, u_there, psi = inputs(PROD_DIMS, 3, f32)
        (qh, sh), (qt_, st) = (tbf.to_int8_links(u)
                               for u in (u_here, u_there))
        psi = psi.to(store)
        del u_here, u_there
        k_ms = median_ms(lambda: wpp.dslash_eo_pallas_packed_int8(
            qh, sh, qt_, st, psi, dims, 0, out_dtype=out), torch)
        p_ms = median_ms(lambda: wpp.dslash_eo_int8_plain(
            qh, sh, qt_, st, psi, dims, 0, out_dtype=out), torch, 5, 2)
        b_ms, b_by = bound(wpp.bytes_per_site_int8(store, out),
                           wpp.INT8_FLOPS_PER_SITE)
        timing[f"int8:{wpp.int8_form_name(store, out)}"] = (k_ms, p_ms, b_ms,
                                                          b_by)
        del qh, sh, qt_, st, psi
    for rows in (3, 2):
        dims, u_here, u_there, psi = inputs(PROD_DIMS, rows, f32,
                                            MULTI_SRC_N)
        k_ms = median_ms(lambda: wpp.dslash_eo_pallas_packed_r12f_mrhs(
            u_here, u_there, psi, dims, 0), torch)
        p_ms = median_ms(lambda: wpp.dslash_eo_there_mrhs_plain(
            u_here, u_there, psi, dims, 0), torch, 3, 1)
        b_ms, b_by = bound(wpp.bytes_per_site_mrhs(MULTI_SRC_N, rows),
                           wpp.flops_per_site_mrhs(MULTI_SRC_N, rows))
        timing[f"r12f_mrhs:{wpp.form_name(rows, f32, f32)}"] = (
            k_ms, p_ms, b_ms, b_by)
        del u_here, u_there, psi

    # (kernel, form) -> the path its launches are read from
    on_path = [("v3", "full:f32->f32", "fused_cg:v3"),
               ("v3", "full:bf16->bf16", "cg_reliable:v3"),
               ("v3", "full:bf16->f32", "cg_reliable:v3"),
               ("r12f", "r12:f32->f32", "fused_cg:r12f"),
               ("r12f", "r12:bf16->bf16", "cg_reliable:r12f"),
               ("r12f", "r12:bf16->f32", "cg_reliable:r12f"),
               ("r12f_mrhs", "r12:f32->f32", "batched:r12f"),
               ("int8", "int8:f32->f32", "fused_cg:int8"),
               ("int8", "int8:bf16->bf16", f"quarter:{TOL:g}"),
               ("int8", "int8:bf16->f32", f"quarter:{TOL:g}")]
    fns = {"v3": wpp.dslash_eo_pallas_packed_v3,
           "r12f": wpp.dslash_eo_pallas_packed_r12f,
           "r12f_mrhs": wpp.dslash_eo_pallas_packed_r12f_mrhs,
           "int8": wpp.dslash_eo_pallas_packed_int8}
    on_path_launches = {(k, f): by(p, fns[k], f) for k, f, p in on_path}
    row = {"phase": "timing", "family": "precision",
           "dims_xyzt": list(PROD_DIMS), "nvidia_smi": smi,
           "repeats": REPEATS, "calls_per_timing": BATCH,
           "resident_link_bytes": {f"{s}:{f}:v{v}": b for (s, f, v), b
                                   in resident.items()},
           "quarter": {f"{t:g}": {"iters": q[0], "reliable_updates": q[1],
                                  "secs": q[2]}
                       for t, q in quarter.items()}}
    for name, (k_ms, p_ms, b_ms, _) in timing.items():
        row[name] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                     "share_of_bound": b_ms / k_ms}
    for kernel, form, path in on_path:
        n = on_path_launches[(kernel, form)]
        row[f"{kernel}:{form}"].update(
            path=path, launches=n, launches_per_iter=n / path_iters[path])
    emit(row)
    del ops, dpk, rhs

    # the kernels-line rows: each form with a path, launches from it
    rows_out = []
    sources = {"v3": "quda_tpu_torch/csrc/wilson_eo_there.cu",
               "r12f": "quda_tpu_torch/csrc/wilson_eo_there.cu",
               "r12f_mrhs": "quda_tpu_torch/csrc/wilson_eo_there.cu",
               "int8": "quda_tpu_torch/csrc/wilson_eo_int8.cu"}
    replaces = {"v3": "quda_tpu/ops/wilson_pallas_packed.py:1097",
                "r12f": "quda_tpu/ops/wilson_pallas_packed.py:1584",
                "r12f_mrhs": "quda_tpu/ops/wilson_pallas_packed.py:1649",
                "int8": "quda_tpu/ops/wilson_pallas_packed.py:1904"}
    for kernel, form, path in on_path:
        k_ms, p_ms, b_ms, b_by = timing[f"{kernel}:{form}"]
        check_key = f"{fns[kernel].__name__}:{form}"
        rows_out.append({
            "name": f"{fns[kernel].__name__}[{form}]", "route": "cuda",
            "source": sources[kernel], "replaces": replaces[kernel],
            "launches": on_path_launches[(kernel, form)],
            "max_abs_err": errs[check_key], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    return rows_out


def fold_v3(torch, dev, smi, gauge, src, srcs, stag) -> list:
    """The fold layout (Wilson and staggered) and the staggered copy-free
    v3 pass (phases check, fold_solve, timing with "family": "fold_v3");
    returns the kernels-line rows of the fold hop, the multi-RHS fold hop,
    S1-fold and the v3 pass.  ``gauge``, ``src`` and ``srcs`` are the
    Wilson main path's hot gauge and sources; ``stag`` phase 8's 32^4
    HISQ links ("fat", "long"), its fat-only gauge ("gauge") and its
    one-spin source ("src")."""
    from quda_tpu_torch.fields.geometry import LatticeGeometry
    from quda_tpu_torch.fields.spinor import even_odd_split
    from quda_tpu_torch.models.staggered import DiracStaggeredPC
    from quda_tpu_torch.models.wilson import DiracWilsonPC
    from quda_tpu_torch.ops import staggered_pallas as spl
    from quda_tpu_torch.ops import wilson_pallas_packed as wpp
    from quda_tpu_torch.solvers.block import batched_cg_pairs
    from quda_tpu_torch.solvers.fused_iter import fused_cg
    from quda_tpu_torch.solvers.mixed import cg_reliable, pair_inplace_codec

    f32, bf16 = torch.float32, torch.bfloat16
    fold = wpp.to_fold
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    errs = {}
    b1_forms = [(3, f32, f32), (3, bf16, bf16), (3, bf16, f32),
                (2, f32, f32), (2, bf16, bf16), (2, bf16, f32)]
    stag_forms = [(f32, f32), (bf16, bf16), (bf16, f32)]

    def check(kernel, name, dims_xyzt, parity, got, want, twin, tol,
              **info):
        """``got`` within ``tol`` of the plain ``want``, and bit for bit
        ``twin`` (the unfolded or resident-copy kernel on the same
        operands, folded where ``got`` is)."""
        torch.cuda.synchronize()
        abs_err = (got.float() - want.float()).abs().max().item()
        rel = abs_err / want.float().abs().max().item()
        same = bool(torch.equal(got, twin))
        key = f"{kernel}:{name}"
        errs[key] = max(errs.get(key, 0.0), abs_err)
        emit({"phase": "check", "kernel": kernel, "form": name,
              "dims_xyzt": list(dims_xyzt), "parity": parity,
              "max_abs_err": abs_err, "max_rel_err": rel, "tolerance": tol,
              "bit_for_bit_twin": same, **info})
        if not (rel <= tol and same):
            fail(f"{kernel} {name} disagrees with its plain version "
                 f"({rel:.3e} > {tol:g}) or with its twin (equal: {same})")

    def w_inputs(dims_xyzt, rows, store, n=None):
        T, Z, Y, X = LatticeGeometry(dims_xyzt).lattice_shape
        sites = (T, Z, Y * X // 2)
        lead = () if n is None else (n,)
        u_here, u_there = (torch.randn((4, rows, 3, 2) + sites, generator=gen,
                                       device=dev).to(store)
                           for _ in range(2))
        psi = torch.randn(lead + (4, 3, 2) + sites, generator=gen,
                          device=dev).to(store)
        return (T, Z, Y, X), u_here, u_there, psi

    def s_inputs(dims_xyzt, store):
        """fat/long here/there (long at 1/24 the scale) and psi."""
        T, Z, Y, X = LatticeGeometry(dims_xyzt).lattice_shape
        sites = (T, Z, Y * X // 2)
        links = [(torch.randn((4, 3, 3, 2) + sites, generator=gen, device=dev)
                  * (1.0 if i < 2 else 1.0 / 24)).to(store)
                 for i in range(4)]
        psi = torch.randn((3, 2) + sites, generator=gen, device=dev).to(store)
        return (T, Z, Y, X), links, psi

    # -- check: each kernel against its plain version and its twin --------
    fold_fn = wpp.dslash_eo_pallas_packed_fold
    fold_mrhs_fn = wpp.dslash_eo_pallas_packed_fold_mrhs
    sfold_fn = spl.dslash_staggered_eo_pallas_fused_fold
    v3_fn = spl.dslash_staggered_eo_pass_v3
    for dims_xyzt in (SMALL_DIMS, PROD_DIMS):
        for parity in (0, 1):
            for rows, store, out in b1_forms:
                dims, u_here, u_there, psi = w_inputs(dims_xyzt, rows, store)
                u_bw = wpp.backward_gauge_eo(u_there, dims,
                                             parity).contiguous()
                del u_there
                fh, fb, fp = fold(u_here), fold(u_bw), fold(psi)
                got = fold_fn(fh, fb, fp, dims, parity, out_dtype=out)
                want = wpp.dslash_eo_fold_plain(fh, fb, fp, dims, parity,
                                                out_dtype=out)
                twin = fold(wpp.dslash_eo_pallas_packed(
                    u_here, u_bw, psi, dims, parity, out_dtype=out))
                check(fold_fn.__name__, wpp.form_name(rows, store, out),
                      dims_xyzt, parity, got, want, twin,
                      wpp.TOLERANCE if out == f32 else wpp.TOLERANCE_BF16)
                del u_here, u_bw, psi, fh, fb, fp, got, want, twin
            cases = ((1, 3, 12) if dims_xyzt == SMALL_DIMS
                     else (MULTI_SRC_N,))
            for rows in (3, 2):
                for n in cases:
                    dims, u_here, u_bw, psi = w_inputs(dims_xyzt, rows, f32,
                                                       n)
                    fh, fb, fp = fold(u_here), fold(u_bw), fold(psi)
                    del u_here, u_bw, psi
                    got = fold_mrhs_fn(fh, fb, fp, dims, parity)
                    want = wpp.dslash_eo_fold_mrhs_plain(fh, fb, fp, dims,
                                                         parity)
                    lanes = torch.stack([fold_fn(fh, fb, fp[r], dims, parity)
                                         for r in range(n)])
                    check(fold_mrhs_fn.__name__, wpp.form_name(rows, f32, f32),
                          dims_xyzt, parity, got, want, lanes, wpp.TOLERANCE,
                          nrhs=n)
                    del fh, fb, fp, got, want, lanes
    for dims_xyzt in (STAG_SMALL_DIMS, STAG_DIMS):
        for parity in (0, 1):
            for store, out in stag_forms:
                tol = spl.TOLERANCE if out == f32 else spl.TOLERANCE_BF16
                dims, lk, psi = s_inputs(dims_xyzt, store)
                s1 = spl.dslash_staggered_eo_pallas_fused(
                    lk[0], lk[1], psi, dims, parity, lk[2], lk[3],
                    out_dtype=out)
                fl = [fold(t) for t in lk]
                got = sfold_fn(fl[0], fl[1], fold(psi), dims, parity, fl[2],
                               fl[3], out_dtype=out)
                want = spl.dslash_staggered_eo_fused_fold_plain(
                    fl[0], fl[1], fold(psi), dims, parity, fl[2], fl[3],
                    out_dtype=out)
                check(sfold_fn.__name__, spl.form_name(store, out),
                      dims_xyzt, parity, got, want, fold(s1), tol)
                del fl, got, want
                for nhop, (here, there) in ((1, lk[:2]), (3, lk[2:])):
                    got = v3_fn(here, there, psi, dims, parity, nhop,
                                out_dtype=out)
                    want = spl.dslash_staggered_eo_pass_v3_plain(
                        here, there, psi, dims, parity, nhop, out_dtype=out)
                    bw = spl.backward_links_eo(there, dims, parity,
                                               nhop).contiguous()
                    twin = spl.dslash_staggered_eo_pass(here, bw, psi, dims,
                                                        parity, nhop, out)
                    check(v3_fn.__name__, spl.pass_form_name(nhop, store,
                                                             out),
                          dims_xyzt, parity, got, want, twin, tol)
                    del got, want, bw, twin
                # the improved v3 hop: the f32 fat pass, the Naik pass
                # adding it, S1 bit for bit
                got = spl.dslash_staggered_eo_pallas_v3(
                    lk[0], lk[1], psi, dims, parity, lk[2], lk[3],
                    out_dtype=out)
                want = spl.dslash_staggered_eo_fused_plain(
                    lk[0], lk[1], psi, dims, parity, lk[2], lk[3],
                    out_dtype=out)
                check("dslash_staggered_eo_pallas_v3",
                      spl.form_name(store, out), dims_xyzt, parity, got,
                      want, s1, tol)
                del lk, psi, s1, got, want

    # -- fold_solve: counts zeroed just before each path, read after ------
    def counts():
        fns = (wpp.dslash_eo_pallas_packed, wpp.dslash_eo_pallas_packed_mrhs,
               fold_fn, fold_mrhs_fn, spl.dslash_staggered_eo_pallas_fused,
               spl.dslash_staggered_eo_pass, sfold_fn, v3_fn)
        return {fn.__name__: dict(fn.launches_by_form) for fn in fns}

    launches, path_iters, path_secs = {}, {}, {}

    def run(label, fn):
        wpp.reset_launches()
        spl.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        path_secs[label] = time.perf_counter() - t0
        launches[label] = counts()
        its = res.iters
        path_iters[label] = (max(int(i) for i in its) if torch.is_tensor(its)
                             else its)
        return res

    def by(label, fn, form=None):
        got = launches[label][fn.__name__]
        return sum(got.values()) if form is None else got.get(form, 0)

    def solve_row(label, solver, operator, res, twin, **info):
        same = bool(torch.equal(res.x, twin.x))
        emit({"phase": "fold_solve", "label": label, "solver": solver,
              "operator": operator, "tol": TOL,
              "iters": (res.iters.tolist() if torch.is_tensor(res.iters)
                        else res.iters),
              "twin_iters": (twin.iters.tolist()
                             if torch.is_tensor(twin.iters) else twin.iters),
              "reliable_updates": getattr(res, "reliable_updates", None),
              "twin_reliable_updates": getattr(twin, "reliable_updates",
                                               None),
              "solution_bits_equal_twin": same, "secs": path_secs[label],
              "launches": launches[label], **info})
        return same

    geom_p = LatticeGeometry(PROD_DIMS)
    dpk = DiracWilsonPC(gauge, geom_p, KAPPA).packed()
    be, bo = even_odd_split(src, geom_p)
    wops = {(s, f): dpk.pairs(s, f) for s in (f32, bf16)
            for f in ("full", "fold")}
    rhs = wops[(f32, "full")].Mdag_pairs(
        wops[(f32, "full")].prepare_pairs(be, bo))
    wres = {}
    for f in ("full", "fold"):
        op = wops[(f32, f)]
        wres[f] = run(f"fused_cg:{f}", lambda: fused_cg(
            op.MdagM_pairs, rhs, tol=TOL, maxiter=2000))
    same = solve_row("fused_cg:fold", "fused_cg", "wilson fold f32",
                     wres["fold"], wres["full"], dims_xyzt=list(PROD_DIMS))
    n_fold = by("fused_cg:fold", fold_fn)
    if not (wres["fold"].converged and same
            and wres["fold"].iters == wres["full"].iters
            and n_fold == 4 * wres["fold"].iters
            and by("fused_cg:fold", wpp.dslash_eo_pallas_packed) == 0):
        fail(f"Wilson fold fused_cg: {wres['fold'].iters} iterations "
             f"against full's {wres['full'].iters}, bits equal {same}, "
             f"{launches['fused_cg:fold']}")
    codec = pair_inplace_codec(bf16)
    for f in ("full", "fold"):
        hi, lo = wops[(f32, f)], wops[(bf16, f)]
        wres[f"mixed:{f}"] = run(f"cg_reliable:{f}", lambda: cg_reliable(
            hi.MdagM_pairs, lo.MdagM_pairs, rhs, codec, tol=TOL,
            maxiter=2000))
    a, b = wres["mixed:fold"], wres["mixed:full"]
    same = solve_row("cg_reliable:fold", "cg_reliable",
                     "wilson fold f32 / bf16 fold", a, b,
                     dims_xyzt=list(PROD_DIMS))
    if not (a.converged and same and a.iters == b.iters
            and a.reliable_updates == b.reliable_updates
            and by("cg_reliable:fold", fold_fn) >= 4 * a.iters
            and by("cg_reliable:fold", wpp.dslash_eo_pallas_packed) == 0):
        fail(f"Wilson fold cg_reliable: {a.iters}/{a.reliable_updates} "
             f"against full's {b.iters}/{b.reliable_updates}, bits equal "
             f"{same}, {launches['cg_reliable:fold']}")
    del rhs
    be_b, bo_b = (torch.stack(h).contiguous() for h in zip(
        *(even_odd_split(srcs[i], geom_p) for i in range(MULTI_SRC_N))))
    for f in ("full", "fold"):
        op = wops[(f32, f)]
        rhs_b = op.Mdag_pairs_mrhs(op.prepare_pairs_mrhs(be_b, bo_b))
        wres[f"batched:{f}"] = run(f"batched:{f}", lambda: batched_cg_pairs(
            op.MdagM_pairs_mrhs, rhs_b, tol=TOL, maxiter=2000))
        del rhs_b
    del be_b, bo_b
    a, b = wres["batched:fold"], wres["batched:full"]
    same = solve_row("batched:fold", "batched_cg_pairs",
                     "wilson fold f32, 12 sources", a, b,
                     nrhs=MULTI_SRC_N, twin_secs=path_secs["batched:full"],
                     ms_per_iteration=1e3 * path_secs["batched:fold"]
                     / path_iters["batched:fold"],
                     twin_ms_per_iteration=1e3 * path_secs["batched:full"]
                     / path_iters["batched:full"])
    n_mrhs = by("batched:fold", fold_mrhs_fn)
    if not (bool(a.converged.all()) and same and torch.equal(a.iters, b.iters)
            and n_mrhs >= 4 * path_iters["batched:fold"]
            and by("batched:fold", fold_fn) == 0
            and by("batched:fold", wpp.dslash_eo_pallas_packed_mrhs) == 0):
        fail(f"Wilson 12-source fold solve: lanes {a.iters.tolist()} "
             f"against full's {b.iters.tolist()}, bits equal {same}, "
             f"{launches['batched:fold']}")

    # staggered, on phase 8's links: hisq fused, fold and v3; fat-only
    # two_pass and v3; fused_cg (f32) and cg_reliable (bf16 sloppy)
    geom_s = LatticeGeometry(STAG_DIMS)
    hisq = DiracStaggeredPC(stag["fat"], geom_s, STAG_MASS, True,
                            stag["long"])
    fat_only = DiracStaggeredPC(stag["gauge"], geom_s, STAG_MASS)
    sbe, sbo = even_odd_split(stag["src"], geom_s)
    sops = {}
    for name, d, kw in (("hisq:fused", hisq, {}),
                        ("hisq:fold", hisq, {"precision_form": "fold"}),
                        ("hisq:v3", hisq, {"form": "v3"}),
                        ("fat:two_pass", fat_only, {}),
                        ("fat:v3", fat_only, {"form": "v3"})):
        sops[name] = (d.pairs(f32, **kw), d.pairs(bf16, **kw))
    if not (sops["hisq:fold"][0]._precision_form == "fold"
            and sops["hisq:v3"][0]._fat_bw is None
            and sops["fat:v3"][0]._fat_bw is None):
        fail("the staggered fold / v3 operators were not built as asked")
    sres = {}
    for fam, names in (("hisq", ("fused", "fold", "v3")),
                       ("fat", ("two_pass", "v3"))):
        rhs = sops[f"{fam}:{names[0]}"][0].prepare_pairs(sbe, sbo)
        for name in names:
            hi, lo = sops[f"{fam}:{name}"]
            sres[f"fused_cg:{fam}:{name}"] = run(
                f"fused_cg:{fam}:{name}", lambda: fused_cg(
                    hi.M_pairs, rhs, tol=TOL, maxiter=5000))
            sres[f"cg_reliable:{fam}:{name}"] = run(
                f"cg_reliable:{fam}:{name}", lambda: cg_reliable(
                    hi.M_pairs, lo.M_pairs, rhs, codec, tol=TOL,
                    maxiter=5000))
        del rhs
    twin_of = {"hisq:fold": "hisq:fused", "hisq:v3": "hisq:fused",
               "fat:v3": "fat:two_pass"}
    # per iteration: the form's own kernel, and no S1/S2 launch
    own = {"hisq:fold": (sfold_fn, 2), "hisq:v3": (v3_fn, 4),
           "fat:v3": (v3_fn, 2)}
    for name, twin in twin_of.items():
        for solver in ("fused_cg", "cg_reliable"):
            label = f"{solver}:{name}"
            a, b = sres[label], sres[f"{solver}:{twin}"]
            same = solve_row(label, solver, f"staggered {name}", a, b,
                             dims_xyzt=list(STAG_DIMS), mass=STAG_MASS)
            fn, per_iter = own[name]
            n_own = by(label, fn)
            twins_run = (by(label, spl.dslash_staggered_eo_pallas_fused)
                         + by(label, spl.dslash_staggered_eo_pass))
            ok = (a.converged and same and a.iters == b.iters
                  and twins_run == 0)
            if solver == "fused_cg":
                ok = ok and n_own == per_iter * a.iters
            else:
                ok = (ok and a.reliable_updates == b.reliable_updates
                      and n_own >= per_iter // 2 * a.iters)
            if not ok:
                fail(f"staggered {label}: {a.iters} iterations against "
                     f"{twin}'s {b.iters}, bits equal {same}, "
                     f"{launches[label]}")

    # -- timing: each form against its bound, its plain version and its
    # twin in the same call; the fold route's layout copies ---------------
    def bound(nbytes, nflop, sites):
        t_bytes = nbytes * sites / HBM_BYTES_PER_S
        t_ops = nflop * sites / F32_FLOPS_PER_S
        return (1e3 * max(t_bytes, t_ops),
                "bytes" if t_bytes >= t_ops else "operations")

    half_w = geom_p.half_volume
    half_s = geom_s.half_volume
    timing, twin_ms, copies, fold_res = {}, {}, {}, {}
    for rows, store, out in b1_forms:
        dims, u_here, u_bw, psi = w_inputs(PROD_DIMS, rows, store)
        fh, fb, fp = fold(u_here), fold(u_bw), fold(psi)
        name = wpp.form_name(rows, store, out)
        k_ms = median_ms(lambda: fold_fn(fh, fb, fp, dims, 0, out_dtype=out),
                         torch)
        twin_ms[f"fold:{name}"] = median_ms(
            lambda: wpp.dslash_eo_pallas_packed(u_here, u_bw, psi, dims, 0,
                                                out_dtype=out), torch)
        p_ms = median_ms(lambda: wpp.dslash_eo_fold_plain(
            fh, fb, fp, dims, 0, out_dtype=out), torch, 5, 2)
        timing[f"fold:{name}"] = (k_ms, p_ms) + bound(
            wpp.bytes_per_site(rows, store, out), wpp.flops_per_site(rows),
            half_w)
        if rows == 3 and out == store:
            o = fold_fn(fh, fb, fp, dims, 0, out_dtype=out)
            copies["f32" if store == f32 else "bf16"] = {
                "to_fold_psi_ms": median_ms(lambda: fold(psi), torch),
                "from_fold_out_ms": median_ms(
                    lambda: wpp.from_fold(o).contiguous(), torch)}
            del o
        del u_here, u_bw, psi, fh, fb, fp
    for rows in (3, 2):
        dims, u_here, u_bw, psi = w_inputs(PROD_DIMS, rows, f32, MULTI_SRC_N)
        fh, fb, fp = fold(u_here), fold(u_bw), fold(psi)
        name = wpp.form_name(rows, f32, f32)
        k_ms = median_ms(lambda: fold_mrhs_fn(fh, fb, fp, dims, 0), torch)
        twin_ms[f"fold_mrhs:{name}"] = median_ms(
            lambda: wpp.dslash_eo_pallas_packed_mrhs(u_here, u_bw, psi, dims,
                                                     0), torch)
        p_ms = median_ms(lambda: wpp.dslash_eo_fold_mrhs_plain(
            fh, fb, fp, dims, 0), torch, 3, 1)
        timing[f"fold_mrhs:{name}"] = (k_ms, p_ms) + bound(
            wpp.bytes_per_site_mrhs(MULTI_SRC_N, rows),
            wpp.flops_per_site_mrhs(MULTI_SRC_N, rows), half_w)
        half_dims = dims[:3] + (dims[3] // 2,)
        res = wpp.fold_mrhs_info(rows, *half_dims)
        plan = wpp.fold_mrhs_plan(rows, *half_dims)
        if (res["smem_bytes"], res["threads"], res["blocks"]) != (
                plan["smem"], plan["threads"], plan["blocks"]):
            fail(f"fold-mrhs launched another plan than its wrapper "
                 f"mirrors: {res} against {plan}")
        fold_res[name] = res
        del u_here, u_bw, psi, fh, fb, fp
    for store, out in stag_forms:
        dims, lk, psi = s_inputs(STAG_DIMS, store)
        fl, fp = [fold(t) for t in lk], fold(psi)
        name = spl.form_name(store, out)
        k_ms = median_ms(lambda: sfold_fn(fl[0], fl[1], fp, dims, 0, fl[2],
                                          fl[3], out_dtype=out), torch)
        twin_ms[f"stag_fold:{name}"] = median_ms(
            lambda: spl.dslash_staggered_eo_pallas_fused(
                lk[0], lk[1], psi, dims, 0, lk[2], lk[3], out_dtype=out),
            torch)
        p_ms = median_ms(lambda: spl.dslash_staggered_eo_fused_fold_plain(
            fl[0], fl[1], fp, dims, 0, fl[2], fl[3], out_dtype=out), torch,
            5, 2)
        timing[f"stag_fold:{name}"] = (k_ms, p_ms) + bound(
            spl.fused_bytes_per_site(store, out), spl.FUSED_FLOPS_PER_SITE,
            half_s)
        del fl, fp
        for nhop, (here, there) in ((1, lk[:2]), (3, lk[2:])):
            name = spl.pass_form_name(nhop, store, out)
            bw = spl.backward_links_eo(there, dims, 0, nhop).contiguous()
            k_ms = median_ms(lambda: v3_fn(here, there, psi, dims, 0, nhop,
                                           out_dtype=out), torch)
            twin_ms[f"v3:{name}"] = median_ms(
                lambda: spl.dslash_staggered_eo_pass(here, bw, psi, dims, 0,
                                                     nhop, out), torch)
            p_ms = median_ms(lambda: spl.dslash_staggered_eo_pass_v3_plain(
                here, there, psi, dims, 0, nhop, out_dtype=out), torch, 5, 2)
            timing[f"v3:{name}"] = (k_ms, p_ms) + bound(
                spl.pass_bytes_per_site(store, out), spl.PASS_FLOPS_PER_SITE,
                half_s)
            del bw
        # the improved v3 hop (two launches) against S1
        name = spl.form_name(store, out)
        k_ms = median_ms(lambda: spl.dslash_staggered_eo_pallas_v3(
            lk[0], lk[1], psi, dims, 0, lk[2], lk[3], out_dtype=out), torch)
        twin_ms[f"v3_improved:{name}"] = twin_ms[f"stag_fold:{name}"]
        b_fat, _ = bound(spl.pass_bytes_per_site(store, f32),
                         spl.PASS_FLOPS_PER_SITE, half_s)
        b_naik, _ = bound(spl.pass_bytes_per_site(store, out, True),
                          spl.PASS_FLOPS_PER_SITE, half_s)
        timing[f"v3_improved:{name}"] = (k_ms, None, b_fat + b_naik,
                                         "bytes")
        del lk, psi

    def per_iter_ms(matvec, rhs, n=STAG_ITER_TIMED):
        fused_cg(matvec, rhs, tol=1e-30, maxiter=2)            # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fused_cg(matvec, rhs, tol=1e-30, maxiter=n)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / res.iters

    iter_ms = {}
    rhs = wops[(f32, "full")].Mdag_pairs(
        wops[(f32, "full")].prepare_pairs(be, bo))
    for f in ("full", "fold", "fold", "full"):
        iter_ms.setdefault(f"wilson:{f}", []).append(per_iter_ms(
            wops[(f32, f)].MdagM_pairs, rhs))
    del rhs, wops, dpk
    for fam, names in (("hisq", ("fused", "fold", "v3")),
                       ("fat", ("two_pass", "v3"))):
        rhs = sops[f"{fam}:{names[0]}"][0].prepare_pairs(sbe, sbo)
        for name in names + names[::-1]:
            iter_ms.setdefault(f"{fam}:{name}", []).append(per_iter_ms(
                sops[f"{fam}:{name}"][0].M_pairs, rhs))
        del rhs
    del sops

    # (kernel, form) -> the path its launches are read from
    on_path = [("fold", "full:f32->f32", "fused_cg:fold"),
               ("fold", "full:bf16->bf16", "cg_reliable:fold"),
               ("fold", "full:bf16->f32", "cg_reliable:fold"),
               ("fold_mrhs", "full:f32->f32", "batched:fold"),
               ("stag_fold", "full:f32->f32", "fused_cg:hisq:fold"),
               ("stag_fold", "full:bf16->bf16", "cg_reliable:hisq:fold"),
               ("stag_fold", "full:bf16->f32", "cg_reliable:hisq:fold"),
               ("v3", "fat:f32->f32", "fused_cg:fat:v3"),
               ("v3", "naik:f32->f32", "fused_cg:hisq:v3"),
               ("v3", "fat:bf16->bf16", "cg_reliable:fat:v3"),
               ("v3", "fat:bf16->f32", "cg_reliable:hisq:v3"),
               ("v3", "naik:bf16->bf16", "cg_reliable:hisq:v3"),
               ("v3", "naik:bf16->f32", "cg_reliable:hisq:v3")]
    fns = {"fold": fold_fn, "fold_mrhs": fold_mrhs_fn, "stag_fold": sfold_fn,
           "v3": v3_fn}
    on_path_launches = {(k, f): by(p, fns[k], f) for k, f, p in on_path}
    row = {"phase": "timing", "family": "fold_v3", "nvidia_smi": smi,
           "dims_xyzt": list(PROD_DIMS), "stag_dims_xyzt": list(STAG_DIMS),
           "repeats": REPEATS, "calls_per_timing": BATCH,
           "fold_layout_copies": copies,
           "iteration_ms": {k: v for k, v in iter_ms.items()},
           "path_iters": path_iters}
    for name, (k_ms, p_ms, b_ms, _) in timing.items():
        row[name] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                     "share_of_bound": b_ms / k_ms,
                     "twin_ms": twin_ms.get(name)}
    for name, res in fold_res.items():
        row[f"fold_mrhs:{name}"].update(
            nrhs=MULTI_SRC_N, chunk=wpp.FOLD_MRHS_CHUNK,
            registers=res["registers"], smem_bytes_per_block=res["smem_bytes"],
            blocks_per_sm=res["blocks_per_sm"])
    for kernel, form, path in on_path:
        n = on_path_launches[(kernel, form)]
        row[f"{kernel}:{form}"].update(
            path=path, launches=n, launches_per_iter=n / path_iters[path])
    emit(row)

    # the kernels-line rows: each form with a path, launches from it
    sources = {"fold": "quda_tpu_torch/csrc/wilson_eo_fold.cu",
               "fold_mrhs": "quda_tpu_torch/csrc/wilson_eo_fold.cu",
               "stag_fold": "quda_tpu_torch/csrc/staggered_eo.cu",
               "v3": "quda_tpu_torch/csrc/staggered_eo.cu"}
    replaces = {"fold": "quda_tpu/ops/wilson_pallas_packed.py:1328",
                "fold_mrhs": "quda_tpu/ops/wilson_pallas_packed.py:1383",
                "stag_fold": "quda_tpu/ops/staggered_pallas.py:1364",
                "v3": "quda_tpu/ops/staggered_pallas.py:539"}
    rows_out = []
    for kernel, form, path in on_path:
        k_ms, p_ms, b_ms, b_by = timing[f"{kernel}:{form}"]
        rows_out.append({
            "name": f"{fns[kernel].__name__}[{form}]", "route": "cuda",
            "source": sources[kernel], "replaces": replaces[kernel],
            "launches": on_path_launches[(kernel, form)],
            "max_abs_err": errs[f"{fns[kernel].__name__}:{form}"],
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None})
        if kernel == "fold_mrhs":
            # the recon-12 form, on no path: its times beside the row's
            r12 = wpp.form_name(2, f32, f32)
            k2, p2, b2, _ = timing[f"fold_mrhs:{r12}"]
            rows_out[-1].update({"share_of_bound": b_ms / k_ms,
                                 f"ms[{r12}]": k2, f"plain_ms[{r12}]": p2,
                                 f"bound_ms[{r12}]": b2,
                                 f"share_of_bound[{r12}]": b2 / k2})
    return rows_out


def operator_zoo_tune(torch, dev, smi) -> list:
    """The full-lattice clover operator (B7 full), the copy-free
    full-lattice hop (B10), the canonical-layout hop (B11), the operator
    API of the clover, twisted and domain-wall families, and the tuned
    dslash (phases check, dslash with "family": "zoo", dslash_canonical,
    tune, timing with "family": "operator_zoo"); returns the kernels-line
    rows of B7 full, B10 and B11."""
    import tempfile

    import quda_tpu_torch as qt
    from quda_tpu_torch.fields.gauge import GaugeField
    from quda_tpu_torch.fields.geometry import LatticeGeometry
    from quda_tpu_torch.fields.spinor import ColorSpinorField
    from quda_tpu_torch.models.clover import DiracClover
    from quda_tpu_torch.models.twisted import (DiracTwistedClover,
                                               DiracTwistedMass)
    from quda_tpu_torch.ops import clover_pallas as clp
    from quda_tpu_torch.ops import wilson as wops
    from quda_tpu_torch.ops import wilson_packed as wpk
    from quda_tpu_torch.ops import wilson_pallas as wpl
    from quda_tpu_torch.ops import wilson_pallas_packed as wpp
    from quda_tpu_torch.ops.boundary import apply_t_boundary
    from quda_tpu_torch.utils import tune

    f32, f64 = torch.float32, torch.float64
    c64, c128 = torch.complex64, torch.complex128
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    geom = LatticeGeometry(PROD_DIMS)
    T, Z, Y, X = geom.lattice_shape
    sites = geom.volume
    a = 2.0 * KAPPA * ZOO_MU
    errs, timing, bound_by, launches = {}, {}, {}, {}
    b10 = wpp.dslash_pallas_packed_v3
    b7 = clp.clover_pallas_packed
    b11 = wpl.dslash_pallas

    def bound(nbytes, nflop, dtype=f32):
        t_bytes = nbytes * sites / HBM_BYTES_PER_S
        peak = F64_FLOPS_PER_S if dtype == f64 else F32_FLOPS_PER_S
        t_ops = nflop * sites / peak
        return (1e3 * max(t_bytes, t_ops),
                "bytes" if t_bytes >= t_ops else "operations")

    def compare(got, want):
        abs_err = (got - want).abs().max().item()
        return abs_err, abs_err / want.abs().max().item()

    def check(kernel, name, got, want, tol, twin=None, **info):
        torch.cuda.synchronize()
        abs_err, rel = compare(got, want)
        same = None if twin is None else bool(torch.equal(got, twin))
        key = f"{kernel}:{name}"
        errs[key] = max(errs.get(key, 0.0), abs_err)
        emit({"phase": "check", "kernel": kernel, "form": name,
              "max_abs_err": abs_err, "max_rel_err": rel, "tolerance": tol,
              "bit_for_bit_twin": same, **info})
        if not (rel <= tol and same is not False):
            fail(f"{kernel} {name} disagrees with its plain version "
                 f"({rel:.3e} > {tol:g}) or with its twin (equal: {same})")

    # the hot gauge (boundary phase folded in) and a Gaussian source
    gauge = GaugeField.random(geom, gen, dtype=c128, device=dev).data
    psi = ColorSpinorField.gaussian(geom, gen, dtype=c128, device=dev).data
    folded = apply_t_boundary(gauge, geom, -1)
    g_pl = wpk.to_packed_pairs(wpk.pack_gauge(folded), f32).contiguous()
    p_pl = wpk.to_packed_pairs(wpk.pack_spinor(psi), f32).contiguous()
    g_bw = wpp.backward_gauge(g_pl, X).contiguous()
    links = {3: (g_pl, g_bw),
             2: (wpp.to_recon12(g_pl), wpp.to_recon12(g_bw))}
    blk = DiracClover(gauge.to(c64), geom, KAPPA, CSW).pairs().blk_pl

    # -- check: B10 (both t boundaries at 14x12x10x8, and 32^3 x 64), B11,
    # -- B7 full, each against its plain version and its twin
    for rows in (3, 2):
        name = wpp.form_name(rows, f32, f32)
        small = LatticeGeometry(FULL_SMALL_DIMS)
        st = small.lattice_shape
        for tb in (True, False):
            u = torch.randn((4, rows, 3, 2, st[0], st[1], st[2] * st[3]),
                            generator=gen, device=dev)
            ps = torch.randn((4, 3, 2, st[0], st[1], st[2] * st[3]),
                             generator=gen, device=dev)
            got = b10(u, ps, st[3], tb_sign=tb)
            twin = wpp.dslash_pallas_packed(u, ps, st[3], tb_sign=tb)
            check(b10.__name__, name, got,
                  wpp.dslash_packed_v3_plain(u, ps, st[3], tb), wpp.TOLERANCE,
                  twin, dims_xyzt=list(FULL_SMALL_DIMS), tb_sign=tb)
        u, u_bw = links[rows]
        got = b10(u, p_pl, X)
        check(b10.__name__, name, got, wpp.dslash_packed_v3_plain(u, p_pl, X),
              wpp.TOLERANCE, wpp.dslash_pallas_packed(u, p_pl, X,
                                                      gauge_bw=u_bw),
              dims_xyzt=list(PROD_DIMS))
        for tw in (None, a):
            cname = name + clp.epilogue_name(True, tw is not None)
            got = b7(u, blk, p_pl, X, KAPPA, diag_twist=tw, gauge_bw=u_bw)
            check(b7.__name__, cname, got,
                  clp.clover_packed_plain(u, u_bw, blk, p_pl, X, KAPPA, tw),
                  clp.FULL_TOLERANCE, dims_xyzt=list(PROD_DIMS))
        del got
    canon = {c64: (folded.to(c64), psi.to(c64)), c128: (folded, psi)}
    for cdt, (gc, pc) in canon.items():
        got = b11(gc, pc)
        twin = None
        if cdt == c64:
            twin = wpk.unpack_spinor(wpk.from_packed_pairs(
                b10(g_pl, p_pl, X), c64), geom.lattice_shape)
        check(b11.__name__, f"canonical:{'f64' if cdt == c128 else 'f32'}",
              got, wpl.dslash_canonical_plain(gc, pc),
              wpl.TOLERANCE_F64 if cdt == c128 else wpl.TOLERANCE, twin,
              dims_xyzt=list(PROD_DIMS))
        del got, twin

    # -- dslash: the operator API of the clover and twisted families ------
    def zero():
        wpp.reset_launches()
        clp.reset_launches()
        wpl.reset_launches()

    def counts():
        return {"b7": dict(b7.launches_by_form),
                "b4": dict(wpp.dslash_pallas_packed.launches_by_form),
                "b1": dict(wpp.dslash_eo_pallas_packed.launches_by_form),
                "b10": dict(b10.launches_by_form)}

    ops128 = {"clover": DiracClover(gauge, geom, KAPPA, CSW),
              "twisted-clover": DiracTwistedClover(gauge, geom, KAPPA,
                                                   ZOO_MU, CSW),
              "twisted-mass": DiracTwistedMass(gauge, geom, KAPPA, ZOO_MU)}
    want = {fam: {"mat_quda": d.M(psi), "mat_dag_mat_quda": d.MdagM(psi)}
            for fam, d in ops128.items()}
    for fam in ops128:
        for prec, rec in (("single", 18), ("single", 12), ("double", 18)):
            if prec == "double" and fam != "twisted-mass":
                continue
            cdt = c128 if prec == "double" else c64
            qt.init_quda(dev)
            try:
                qt.load_gauge_quda(gauge.to(cdt), qt.GaugeParam(
                    X=PROD_DIMS, cuda_prec=prec, reconstruct=rec))
                p = qt.InvertParam(dslash_type=fam, kappa=KAPPA, mu=ZOO_MU,
                                   csw=CSW, cuda_prec=prec)
                out, c, secs = {}, {}, {}
                for api in ("mat_quda", "mat_dag_mat_quda"):
                    zero()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out[api] = getattr(qt, api)(psi.to(cdt), p)
                    torch.cuda.synchronize()
                    secs[api] = time.perf_counter() - t0
                    c[api] = counts()
            finally:
                qt.end_quda()
            rel = {k: compare(v.to(c128), want[fam][k])[1]
                   for k, v in out.items()}
            tol = F64_TOLERANCE if prec == "double" else wpp.TOLERANCE
            rows = 2 if rec == 12 else 3
            dt = f64 if prec == "double" else f32
            kern = "b4" if fam == "twisted-mass" else "b7"
            form = wpp.form_name(rows, dt, dt) + (
                "" if kern == "b4" else clp.epilogue_name(
                    True, fam == "twisted-clover"))
            label = f"{fam}:{prec}:{'r12' if rows == 2 else 'full'}"
            launches[label] = {k: v[kern].get(form, 0) for k, v in c.items()}
            emit({"phase": "dslash", "family": "zoo", "dslash_type": fam,
                  "cuda_prec": prec, "reconstruct": rec,
                  "dims_xyzt": list(PROD_DIMS), "kappa": KAPPA,
                  "mu": ZOO_MU, "csw": CSW, "rel_err_vs_complex128": rel,
                  "tolerance": tol, "secs": secs, "kernel_form": form,
                  "launches": c})
            expect = {"mat_quda": 1, "mat_dag_mat_quda": 2}
            for api, n in expect.items():
                others = sum(sum(v.values()) for k, v in c[api].items()
                             if k != kern)
                if not (c[api][kern] == {form: n} and others == 0):
                    fail(f"{label} {api} did not run {kern} {form} "
                         f"{n} time(s) and nothing else: {c[api]}")
            if not all(r <= tol for r in rel.values()):
                fail(f"operator API ({label}) disagrees with the complex128 "
                     f"operator: {rel}")
            del out
    del want, ops128

    # the other families' operator calls: their complex operators, single
    # against double
    ls = DWF_LS
    zoo_kw = dict(kappa=KAPPA, mu=ZOO_MU, csw=CSW, epsilon=ZOO_EPS, Ls=ls,
                  m5=DWF_M5, b5=DWF_B5, c5=DWF_C5, mass=DWF_MASS,
                  eofa_mq1=EOFA_MQ[0], eofa_mq2=EOFA_MQ[1],
                  eofa_mq3=EOFA_MQ[2], eofa_shift=EOFA_SHIFT)
    half = geom.half_lattice_shape
    for fam in ("ndeg-twisted-mass", "ndeg-twisted-clover", "mobius",
                "domain-wall-4d", "domain-wall", "mobius-eofa"):
        ndeg = fam.startswith("ndeg")
        full_shape = ((ls,) if not ndeg else ()) + geom.lattice_shape + (
            (2, 4, 3) if ndeg else (4, 3))
        half_shape = ((ls,) if not ndeg else ()) + half + (
            (2, 4, 3) if ndeg else (4, 3))
        x = torch.randn(full_shape, generator=gen, device=dev, dtype=c128)
        xh = torch.randn(half_shape, generator=gen, device=dev, dtype=c128)
        res, secs = {}, {}
        for prec, cdt in (("single", c64), ("double", c128)):
            qt.init_quda(dev)
            try:
                qt.load_gauge_quda(gauge.to(cdt), qt.GaugeParam(
                    X=PROD_DIMS, cuda_prec=prec))
                p = qt.InvertParam(dslash_type=fam, cuda_prec=prec,
                                   **zoo_kw)
                zero()
                calls = {"mat_quda": lambda: qt.mat_quda(x.to(cdt), p),
                         "mat_dag_mat_quda":
                             lambda: qt.mat_dag_mat_quda(x.to(cdt), p),
                         "dslash_quda": lambda: qt.dslash_quda(xh.to(cdt), p,
                                                               0)}
                for api, fn in calls.items():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    try:
                        res[prec, api] = fn()
                    except NotImplementedError as e:
                        if fam in ("mobius", "domain-wall-4d",
                                   "mobius-eofa") and api == "dslash_quda":
                            res[prec, api] = str(e)[:80]
                        else:
                            raise
                    torch.cuda.synchronize()
                    secs[f"{prec}:{api}"] = time.perf_counter() - t0
                c = counts()
            finally:
                qt.end_quda()
            if any(c[k] for k in c):
                fail(f"{fam} ({prec}) launched a hop kernel: {c}")
        rel = {api: compare(res["single", api].to(c128),
                            res["double", api])[1]
               for api in ("mat_quda", "mat_dag_mat_quda", "dslash_quda")
               if isinstance(res["single", api], torch.Tensor)}
        refused = {api: res["single", api]
                   for api in ("dslash_quda",)
                   if isinstance(res["single", api], str)}
        emit({"phase": "dslash", "family": "zoo", "dslash_type": fam,
              "dims_xyzt": list(PROD_DIMS), "Ls": None if ndeg else ls,
              "route": "complex operators", "secs": secs,
              "rel_err_single_vs_double": rel, "refused": refused})
        if not all(r <= wpp.TOLERANCE for r in rel.values()):
            fail(f"{fam}: single and double operators disagree: {rel}")
        del x, xh, res
        torch.cuda.empty_cache()

    # -- dslash_canonical: B11 through its public entry ---------------------
    for cdt, (gc, pc) in canon.items():
        zero()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = wpl.dslash_pallas(gc, pc)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        form = f"canonical:{'f64' if cdt == c128 else 'f32'}"
        launches[form] = dict(b11.launches_by_form)
        rel = compare(out.to(c128), wops.dslash_full(folded, psi))[1]
        tol = F64_TOLERANCE if cdt == c128 else wpp.TOLERANCE
        emit({"phase": "dslash_canonical", "form": form,
              "dims_xyzt": list(PROD_DIMS), "secs": secs,
              "rel_err_vs_complex128": rel, "tolerance": tol,
              "launches": launches[form]})
        if not (rel <= tol and launches[form] == {form: 1}):
            fail(f"dslash_pallas ({form}): {rel:.3e}, launches "
                 f"{launches[form]}")
        del out

    # -- tune: tuned_dslash races its candidates on the card ---------------
    saved = {k: os.environ.get(k) for k in ("QUDA_TORCH_RESOURCE_PATH",
                                            "QUDA_TORCH_ENABLE_TUNING")}
    gc, pc = canon[c64]
    with tempfile.TemporaryDirectory() as rpath:
        os.environ["QUDA_TORCH_RESOURCE_PATH"] = rpath
        os.environ["QUDA_TORCH_ENABLE_TUNING"] = "1"
        try:
            tune._cache.clear()
            tune._profile.clear()
            zero()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = wpl.tuned_dslash(gc, pc)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            c = counts()
            lat = tuple(geom.lattice_shape)
            aux = f"{pc.dtype}/{pc.device.type}"
            winner = tune.cached_param("wilson_dslash", lat, aux)
            prof = tune.profile_snapshot()
            cands = list(wpl._tuned_candidates(lat, str(pc.dtype),
                                               pc.device.type))
            times = {cand: 1e3 * prof[tune.tune_key(
                "wilson_dslash", lat, f"{aux}|{cand}")]["seconds"]
                for cand in cands}
            cached = os.path.exists(os.path.join(rpath, tune.CACHE_FILE))
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    rel = compare(out.to(c128), wops.dslash_full(folded, psi))[1]
    launches["tune"] = c
    emit({"phase": "tune", "kernel": "wilson_dslash",
          "dims_xyzt": list(PROD_DIMS), "dtype": str(pc.dtype),
          "candidates": cands, "candidate_ms": times, "winner": winner,
          "race_and_apply_secs": secs, "cache_written": cached,
          "launches": c, "rel_err_vs_complex128": rel,
          "platform": tune.platform_key(), "nvidia_smi": smi})
    if not (cands == ["xla", "xla_packed", "pallas_packed", "pallas_v3"]
            and winner in cands and cached and rel <= wpp.TOLERANCE
            and c["b4"].get("full:f32->f32", 0) > 0
            and c["b10"].get("full:f32->f32", 0) > 0):
        fail(f"tuned_dslash: candidates {cands}, winner {winner}, cache "
             f"{cached}, {rel:.3e}, launches {c}")
    del out

    # -- timing: every new form, B4 in the same call -----------------------
    for rows in (3, 2):
        u, u_bw = links[rows]
        name = wpp.form_name(rows, f32, f32)
        k_ms = median_ms(lambda: b10(u, p_pl, X), torch)
        b4_ms = median_ms(lambda: wpp.dslash_pallas_packed(
            u, p_pl, X, gauge_bw=u_bw), torch)
        p_ms = median_ms(lambda: wpp.dslash_packed_v3_plain(u, p_pl, X),
                         torch, repeats=5, batch=2)
        b_ms, bound_by[f"b10:{name}"] = bound(
            wpp.bytes_per_site_v3(rows), wpp.flops_per_site(rows))
        timing[f"b10:{name}"] = (k_ms, p_ms, b_ms, {"b4_ms": b4_ms})
        for tw in (None, a):
            cname = name + clp.epilogue_name(True, tw is not None)
            k_ms = median_ms(lambda: b7(u, blk, p_pl, X, KAPPA,
                                        diag_twist=tw, gauge_bw=u_bw), torch)
            p_ms = median_ms(lambda: clp.clover_packed_plain(
                u, u_bw, blk, p_pl, X, KAPPA, tw), torch, repeats=5, batch=2)
            b_ms, bound_by[f"b7:{cname}"] = bound(
                clp.bytes_per_site_full(rows),
                clp.flops_per_site_full(rows, tw is not None))
            timing[f"b7:{cname}"] = (k_ms, p_ms, b_ms, {})
    for cdt, (gc, pc) in canon.items():
        real = f64 if cdt == c128 else f32
        form = f"canonical:{'f64' if cdt == c128 else 'f32'}"
        k_ms = median_ms(lambda: b11(gc, pc), torch)
        p_ms = median_ms(lambda: wpl.dslash_canonical_plain(gc, pc), torch,
                         repeats=5, batch=2)
        b_ms, bound_by[f"b11:{form}"] = bound(
            wpp.bytes_per_site_v3(3, real), wpp.FLOPS_PER_SITE, real)
        timing[f"b11:{form}"] = (k_ms, p_ms, b_ms, {})
    emit({"phase": "timing", "family": "operator_zoo",
          "dims_xyzt": list(PROD_DIMS), "nvidia_smi": smi,
          "repeats": REPEATS, "calls_per_timing": BATCH,
          **{name: {"ms": k, "plain_ms": pm, "bound_ms": b,
                    "share_of_bound": b / k, **extra}
             for name, (k, pm, b, extra) in timing.items()}})

    rows_out = []

    def row(key, kernel, form, source, replaces, n):
        k_ms, p_ms, b_ms, _ = timing[key]
        rows_out.append({
            "name": f"{kernel}[{form}]", "route": "cuda", "source": source,
            "replaces": replaces, "launches": n,
            "max_abs_err": errs[f"{kernel}:{form}"], "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": bound_by[key],
            "library_ms": None})

    # B10's R = 3 form runs in the tuner's race (pallas_v3); its R = 2 form
    # runs on no path, checked and timed only, with no row
    name = wpp.form_name(3, f32, f32)
    row(f"b10:{name}", b10.__name__, name,
        "quda_tpu_torch/csrc/wilson_full.cu",
        "quda_tpu/ops/wilson_pallas_packed.py:938",
        launches["tune"]["b10"].get(name, 0))
    for cdt in (c64, c128):
        form = f"canonical:{'f64' if cdt == c128 else 'f32'}"
        row(f"b11:{form}", b11.__name__, form,
            "quda_tpu_torch/csrc/wilson_canonical.cu",
            "quda_tpu/ops/wilson_pallas.py:198", launches[form].get(form, 0))
    for rows in (3, 2):
        for fam in ("clover", "twisted-clover"):
            cname = wpp.form_name(rows, f32, f32) + clp.epilogue_name(
                True, fam == "twisted-clover")
            path = f"{fam}:single:{'r12' if rows == 2 else 'full'}"
            row(f"b7:{cname}", b7.__name__, cname,
                "quda_tpu_torch/csrc/clover_full.cu",
                "quda_tpu/ops/clover_pallas.py:394",
                sum(launches[path].values()))
    return rows_out


def mesh_path(torch, dev, smi, gauge, src, iters_main) -> list:
    """The multi-device Wilson path (ROADMAP A15, B12) on virtual meshes
    of MESH_N sub-domains, all on ``dev``: phases check, invert_mesh and
    timing ("family": "mesh"); returns the three B12 rows of the kernels
    line.  ``gauge`` and ``src`` are the main path's (phase 4) fields at
    32^3 x 64, ``iters_main`` its invert_quda iterations."""
    from quda_tpu_torch.fields.geometry import LatticeGeometry
    from quda_tpu_torch.fields.spinor import even_odd_join, even_odd_split
    from quda_tpu_torch.models.wilson import DiracWilson, DiracWilsonPC
    from quda_tpu_torch.ops import blas
    from quda_tpu_torch.ops import blas_pallas as bpl
    from quda_tpu_torch.ops import wilson_pallas_packed as wpp
    from quda_tpu_torch.parallel import mesh as qm
    from quda_tpu_torch.parallel import pallas_dslash as pds
    from quda_tpu_torch.parallel import pallas_halo as ph
    from quda_tpu_torch.solvers.fused_iter import fused_cg

    f32, bf16 = torch.float32, torch.bfloat16
    geom = LatticeGeometry(PROD_DIMS)
    T, Z, Y, X = geom.lattice_shape
    half = (4, 3, 2, T, Z, Y * X // 2)

    def vmesh(grid):
        return qm.make_lattice_mesh(grid, devices=[dev] * MESH_N)

    mesh8 = vmesh(MESH_GRID)
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    errs = {}

    def rel(a, b):
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max()).item()

    def nrel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    def faces(field, grid):
        """{axis: (send_down, send_up)}: each sub-domain's low and high
        face of every partitioned axis, the views of its block that the
        sharded hop hands the exchange (strided, read in place)."""
        out = {}
        for fio, name, n, _ in pds._axis_plan(grid, X // 2 // grid[3]):
            if n > 1:
                out[name] = ([fio.face(b, lo=True) for b in field.blocks],
                             [fio.face(b, lo=False) for b in field.blocks])
        return out

    # -- check: the exchange, bit for bit its plain transport ---------------
    psi_g = torch.randn(half, generator=gen, device=dev)
    for store in (f32, bf16):
        sf = qm.shard(psi_g.to(store), mesh8, qm.pair_pspec(6))
        for name, (down, up) in faces(sf, MESH_GRID).items():
            n0 = ph.slab_exchange_bidir.launches
            got = ph.slab_exchange_bidir(down, up, mesh8, name)
            want = ph.slab_exchange_plain(down, up, mesh8, name)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for g, w in zip(got, want)
                       for a, b in zip(g, w))
            launched = ph.slab_exchange_bidir.launches - n0
            emit({"phase": "check", "family": "mesh",
                  "kernel": "slab_exchange_bidir", "axis": name,
                  "dtype": str(store).replace("torch.", ""),
                  "grid": list(MESH_GRID), "slab_shape": list(down[0].shape),
                  "bit_equal": same, "launches": launched})
            if not (same and launched == 1):
                fail(f"slab_exchange_bidir ({name}, {store}) is not bit for "
                     f"bit its plain transport, or launched {launched}x")
        del sf, down, up, got, want
    errs["exchange"] = 0.0
    del psi_g

    # -- check: the fused-halo hops against plain and composed --------------
    # both forms at the production half-lattice volume (2^20 sites), cut
    # MESH_N ways along their partitioned axis (array axis 3)
    fused_cases = {"z": ((1, MESH_N, 1, 1), (2 * Z, T * Y * X // 4), 2),
                   "t": ((MESH_N, 1, 1, 1), (T, Z, Y * X // 2), 3)}
    fused = {}
    errs["axis"] = errs["zbwd"] = 0.0
    for ax, (grid, sites, mu) in fused_cases.items():
        m = vmesh(grid)
        spec = (None, None, None, ax) + (None,) * (len(sites) - 1)
        psi = torch.randn((4, 3, 2) + sites, generator=gen, device=dev)
        u = torch.randn((3, 3, 2) + sites, generator=gen, device=dev)
        ps, us = qm.shard(psi, m, spec), qm.shard(u, m, spec)
        fused[ax] = (ps, us, mu)
        kinds = [("axis", True)] + ([("zbwd", False)] if ax == "z" else [])
        for kind, bidir in kinds:
            fn = ph.wilson_axis_fused_halo if bidir \
                else ph.wilson_zbwd_fused_halo
            got = qm.gather(ph.wilson_axis_fused_halo(ps, us, mu, ax)
                            if bidir else fn(ps, us, ax))
            plain = qm.gather(ph.wilson_axis_halo_plain(ps, us, mu, ax,
                                                        bidir))
            ref = (ph.wilson_axis_composed(psi, u, mu) if bidir
                   else ph.wilson_zbwd_composed(psi, u))
            torch.cuda.synchronize()
            e_plain, e_ref = rel(got, plain), rel(got, ref)
            abs_err = (got - plain).abs().max().item()
            errs[kind] = max(errs[kind], abs_err)
            emit({"phase": "check", "family": "mesh", "kernel": fn.__name__,
                  "axis": ax, "mu": mu, "block_shape": list(ps.local_shape),
                  "sub_domains": MESH_N, "max_abs_err": abs_err,
                  "max_rel_err_plain": e_plain,
                  "max_rel_err_composed": e_ref, "tolerance": ph.TOLERANCE})
            if not (e_plain <= ph.TOLERANCE and e_ref <= ph.TOLERANCE):
                fail(f"{fn.__name__} ({ax}) disagrees with its plain version "
                     f"({e_plain:.3e}) or the composed reference "
                     f"({e_ref:.3e}) beyond {ph.TOLERANCE:g}")
            del got, plain, ref
        del psi, u
    # their path is their own entry (as in the JAX package, no solve calls
    # them): counts zeroed, each entry driven once
    launches_fused = {}
    for key, entry, (ps, us, _), fn in (
            ("axis:z", ph.wilson_z_fused_halo, fused["z"],
             ph.wilson_axis_fused_halo),
            ("axis:t", ph.wilson_t_fused_halo, fused["t"],
             ph.wilson_axis_fused_halo),
            ("zbwd:z", ph.wilson_zbwd_fused_halo, fused["z"],
             ph.wilson_zbwd_fused_halo)):
        ph.reset_launches()
        entry(ps, us)
        torch.cuda.synchronize()
        launches_fused[key] = fn.launches

    # -- check: the sharded eo hop: fused_halo = xla_facefix bit for bit,
    # within 1e-6 of the unsharded hop (B1, B10-eo) -------------------------
    dpk = DiracWilsonPC(gauge, geom, KAPPA).packed()
    hop_cases = [("full", 2, MESH_GRID, MESH_POLICY),
                 ("r12", 2, MESH_GRID, MESH_POLICY),
                 ("full", 2, MESH_GRID_X, MESH_POLICY_TZ),
                 ("full", 3, MESH_GRID_TZ, MESH_POLICY_TZ)]
    for form, ver, grid, pol in hop_cases:
        ref_op = dpk.pairs(f32, form, ver)
        op = dpk.pairs(f32, form, ver, mesh=vmesh(grid), sharded_policy=pol)
        for parity in (0, 1):
            x = torch.randn(half, generator=gen, device=dev)
            xs = op.shard(x)
            other = (op._u_bw[parity] if ver == 2
                     else op.gauge_eo_pp[1 - parity])
            by_kernel = op._hop_on_mesh(op.gauge_eo_pp[parity], other, xs,
                                        parity, None, pol)
            by_copy = op._hop_on_mesh(op.gauge_eo_pp[parity], other, xs,
                                      parity, None, "xla_facefix")
            want = ref_op._d_to(x, parity, None)
            got = op.gather(by_kernel)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in
                       zip(by_kernel.blocks, by_copy.blocks))
            err = nrel(got, want)
            emit({"phase": "check", "family": "mesh",
                  "kernel": "dslash_eo_pallas_sharded"
                            + ("_v3" if ver == 3 else ""),
                  "precision_form": form, "grid": list(grid), "policy": pol,
                  "parity": parity, "fused_halo_equals_xla_facefix": same,
                  "rel_err_unsharded": err, "tolerance": MESH_HOP_TOL})
            if not (same and err <= MESH_HOP_TOL):
                fail(f"sharded eo hop v{ver}/{form} on {grid}: fused_halo "
                     f"== xla_facefix {same}, {err:.3e} from the unsharded "
                     "hop")
            del x, xs, by_kernel, by_copy, want, got
        del ref_op, op

    # -- invert_mesh: fused_cg on the MESH_GRID operator at 32^3 x 64 -------
    be, bo = even_odd_split(src, geom)
    dw = DiracWilson(gauge, geom, KAPPA)
    op0 = dpk.pairs(f32)

    def true_res(x_pairs):
        xe, xo = op0.reconstruct_pairs(x_pairs, be, bo)
        r = src - dw.M(even_odd_join(xe, xo, geom))
        return float(torch.sqrt(blas.norm2(r) / blas.norm2(src)))

    rhs = op0.prepare_pairs(be, bo)
    sys0 = op0.Mdag_pairs(rhs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res0 = fused_cg(op0.MdagM_pairs, sys0, tol=TOL, maxiter=2000)
    torch.cuda.synchronize()
    secs0 = time.perf_counter() - t0
    iters0 = int(res0.iters)
    true0 = true_res(res0.x)

    # the default sharded_policy ("auto": the exchange kernel on t/z/y)
    op = dpk.pairs(f32, mesh=mesh8)
    auto = dict(op._sharded_policy)
    sys_s = op.Mdag_pairs(op.shard(rhs))
    torch.cuda.synchronize()
    wpp.reset_launches()
    ph.reset_launches()
    bpl.cg_update_norm2_pallas.launches = 0
    t0 = time.perf_counter()
    res = fused_cg(op.MdagM_pairs, sys_s, tol=TOL, maxiter=2000)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = {"slab_exchange_bidir": ph.slab_exchange_bidir.launches,
              "dslash_eo_pallas_packed": wpp.dslash_eo_pallas_packed.launches,
              "cg_update_norm2_pallas": bpl.cg_update_norm2_pallas.launches}
    iters, converged = int(res.iters), bool(res.converged)
    x = op.gather(res.x)
    x_true = true_res(x)
    normal_res = nrel(op0.MdagM_pairs(x), sys0)
    del x, res, res0, sys_s
    emit({"phase": "invert_mesh", "dims_xyzt": list(PROD_DIMS),
          "grid": list(MESH_GRID), "sub_domains": MESH_N,
          "devices": sorted({str(d) for d in mesh8.devices}),
          "policy": "auto", "kappa": KAPPA, "tol": TOL,
          "iters": iters, "iters_unsharded": iters0,
          "iters_invert_quda": iters_main, "converged": converged,
          "true_res": x_true, "true_res_unsharded": true0,
          "normal_eq_res_by_unsharded_op": normal_res,
          "secs": secs, "secs_unsharded": secs0,
          "ms_per_iter": 1e3 * secs / max(iters, 1),
          "ms_per_iter_unsharded": 1e3 * secs0 / max(iters0, 1),
          "auto_policy": auto,
          "launches": counts,
          "b12_launches_per_iter": counts["slab_exchange_bidir"]
          / max(iters, 1)})
    if not (converged and abs(iters - iters0) <= 1 and x_true <= TOL):
        fail(f"mesh CG: {iters} iterations against the unsharded {iters0}, "
             f"true_res {x_true:.3e} (tol {TOL:g})")
    live = sum(1 for n in MESH_GRID if n > 1)
    want = {"slab_exchange_bidir": 4 * live * iters,
            "dslash_eo_pallas_packed": 4 * MESH_N * iters,
            "cg_update_norm2_pallas": MESH_N * iters}
    if counts != want:
        fail(f"mesh CG launches {counts}, expected {want} (an iteration: "
             f"2 MdagM hops of 2 eo hops, each one exchange launch per "
             "partitioned axis and one B1 per sub-domain; one B2 per "
             "sub-domain)")
    if any(auto[a] != "fused_halo" for a in ("t", "z", "y")):
        fail(f"sharded_policy 'auto' resolved to {auto}, not the exchange "
             "kernel on t/z/y")

    # -- timing ---------------------------------------------------------------
    flush = l2_flush(torch, dev)

    def kernel_times(call, plain, library=None, **extra):
        """A B12 kernel's times: ``ms`` its device time per call (the
        profiler's, the L2 flushed before each call), ``call_ms`` the
        CUDA-event time of back-to-back calls (the wrapper's host work
        included, which rules a call of microseconds), ``plain_ms`` its
        plain version's, and ``library_ms`` the device time (L2 flushed)
        of the same transfers done with Tensor.copy_."""
        out = {"ms": device_ms(call, torch, flush=flush),
               "ms_source": "profiler, L2 flushed",
               "call_ms": median_ms(call, torch),
               "plain_ms": median_ms(plain, torch, repeats=5, batch=2)}
        if library is not None:
            out["library_ms"] = device_ms(library, torch, flush=flush)
            out["library_call_ms"] = median_ms(library, torch)
        out.update(extra)
        return out

    timing = {}
    sf = op.shard(torch.randn(half, generator=gen, device=dev))
    for name, (down, up) in faces(sf, MESH_GRID).items():
        srcs = ([down[mesh8.neighbor(i, name, 1)] for i in range(MESH_N)]
                + [up[mesh8.neighbor(i, name, -1)] for i in range(MESH_N)])
        dst = [torch.empty_like(s) for s in srcs]

        def by_copy():
            for d, s in zip(dst, srcs):
                d.copy_(s)

        nbytes = 2 * sum(s.numel() * s.element_size() for s in srcs)
        timing[f"slab_exchange_bidir:{name}"] = kernel_times(
            lambda: ph.slab_exchange_bidir(down, up, mesh8, name),
            lambda: ph.slab_exchange_plain(down, up, mesh8, name),
            library=by_copy, bound_ms=1e3 * nbytes / HBM_BYTES_PER_S,
            bytes=nbytes, slab_shape=list(down[0].shape), slabs=len(srcs))
    del sf
    for ax, (ps, us, mu) in fused.items():
        nsites = MESH_N * ps.blocks[0][0, 0, 0].numel()
        bound = 1e3 * ph.BYTES_PER_SITE * nsites / HBM_BYTES_PER_S
        kinds = [("wilson_axis_fused_halo", True)]
        if ax == "z":
            kinds.append(("wilson_zbwd_fused_halo", False))
        for kname, bidir in kinds:
            fn = getattr(ph, kname)
            call = ((lambda: fn(ps, us, mu, ax)) if bidir
                    else (lambda: fn(ps, us, ax)))
            timing[f"{kname}:{ax}"] = kernel_times(
                call, lambda: ph.wilson_axis_halo_plain(ps, us, mu, ax,
                                                        bidir),
                bound_ms=bound, sites=nsites,
                block_shape=list(ps.local_shape))
    # one sharded eo hop under each policy, beside the unsharded B1: wall
    # time (policies interleaved), device time, launches, busy share
    x = torch.randn(half, generator=gen, device=dev)
    xs = op.shard(x)

    def sharded_hop(pol):
        return lambda: op._hop_on_mesh(op.gauge_eo_pp[0], op._u_bw[0], xs,
                                       0, None, pol)
    hops = hop_profile({"unsharded_b1": lambda: op0._d_to(x, 0, None),
                        MESH_POLICY: sharded_hop(MESH_POLICY),
                        "xla_facefix": sharded_hop("xla_facefix")}, torch)
    emit({"phase": "timing", "family": "mesh", "nvidia_smi": smi,
          "dims_xyzt": list(PROD_DIMS), "grid": list(MESH_GRID),
          "sub_domains": MESH_N, "repeats": REPEATS,
          "calls_per_timing": BATCH, "kernels": timing,
          "sharded_eo_hop": hops})
    del x, xs, op, op0, fused, flush

    ex = timing["slab_exchange_bidir:t"]
    rows = [{"name": "slab_exchange_bidir[t]", "route": "cuda",
             "source": "quda_tpu_torch/csrc/halo.cu",
             "replaces": "quda_tpu/parallel/pallas_halo.py:394",
             "launches": counts["slab_exchange_bidir"],
             "max_abs_err": errs["exchange"], "ms": ex["ms"],
             "plain_ms": ex["plain_ms"], "bound_ms": ex["bound_ms"],
             "bound_by": "bytes", "library_ms": ex["library_ms"]}]
    for kname, key, err, replaces in (
            ("wilson_axis_fused_halo", "z", "axis", ":289"),
            ("wilson_axis_fused_halo", "t", "axis", ":289"),
            ("wilson_zbwd_fused_halo", "z", "zbwd", ":512")):
        tm = timing[f"{kname}:{key}"]
        rows.append({
            "name": f"{kname}[{key}]", "route": "cuda",
            "source": "quda_tpu_torch/csrc/halo.cu",
            "replaces": "quda_tpu/parallel/pallas_halo.py" + replaces,
            "launches": launches_fused[f"{err}:{key}"],
            "max_abs_err": errs[err], "ms": tm["ms"],
            "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
            "bound_by": "bytes", "library_ms": None})
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this script runs "
              "only on the card", file=sys.stderr)
        return 1
    import numpy as np

    import quda_tpu_torch as qt
    from quda_tpu_torch.fields.gauge import GaugeField
    from quda_tpu_torch.fields.geometry import LatticeGeometry
    from quda_tpu_torch.fields.spinor import (ColorSpinorField,
                                              even_odd_split)
    from quda_tpu_torch.models.clover import DiracCloverPC
    from quda_tpu_torch.models.wilson import DiracWilson, DiracWilsonPC
    from quda_tpu_torch.ops import blas
    from quda_tpu_torch.ops import blas_pallas as bpl
    from quda_tpu_torch.ops import clover_pallas as clp
    from quda_tpu_torch.ops import wilson_pallas_packed as wpp
    from quda_tpu_torch.ops.clover import CloverNotPositiveDefinite
    from quda_tpu_torch.solvers.block import batched_cg_pairs
    from quda_tpu_torch.solvers.fused_iter import fused_cg
    from quda_tpu_torch.solvers.mixed import cg_reliable, pair_inplace_codec
    from quda_tpu_torch.utils import kernels

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = smi_line()
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # -- 2. build ------------------------------------------------------
    info = kernels.build()
    ptxas = [ln.strip() for ln in info.log.splitlines()
             if "registers" in ln or "spill" in ln or "entry function" in ln]
    emit({"phase": "build", "seconds": info.seconds, "library":
          str(info.path.relative_to(kernels.BUILD_ROOT.parent.parent)),
          "ptxas": ptxas})

    # -- 3. kernels against their plain versions ------------------------
    f32, bf16 = torch.float32, torch.bfloat16
    # every eo-hop instance: (rows, storage dtype, output dtype)
    b1_forms = [(3, f32, f32), (3, bf16, bf16), (3, bf16, f32),
                (2, f32, f32), (2, bf16, bf16), (2, bf16, f32)]
    b1_names = [wpp.form_name(*f) for f in b1_forms]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    errs = {name: 0.0 for name in b1_names}

    def b1_inputs(dims_xyzt, parity, rows=3, store=f32, g=gen):
        geom = LatticeGeometry(dims_xyzt)
        T, Z, Y, X = geom.lattice_shape
        sites = (T, Z, Y * X // 2)
        psi = torch.randn((4, 3, 2) + sites, generator=g, device=dev)
        u_here = torch.randn((4, rows, 3, 2) + sites, generator=g,
                             device=dev)
        u_there = torch.randn((4, rows, 3, 2) + sites, generator=g,
                              device=dev)
        u_bw = wpp.backward_gauge_eo(u_there, geom.lattice_shape, parity)
        return (geom.lattice_shape, u_here.to(store).contiguous(),
                u_bw.to(store).contiguous(), psi.to(store))

    for (rows, store, out), name in zip(b1_forms, b1_names):
        tol = wpp.TOLERANCE if out == f32 else wpp.TOLERANCE_BF16
        for dims_xyzt in (SMALL_DIMS, PROD_DIMS):
            for parity in (0, 1):
                dims, u_here, u_bw, psi = b1_inputs(dims_xyzt, parity, rows,
                                                    store)
                out_k = wpp.dslash_eo_pallas_packed(
                    u_here, u_bw, psi, dims, parity, out_dtype=out)
                out_p = wpp.dslash_eo_packed_plain(
                    u_here, u_bw, psi, dims, parity, out_dtype=out)
                torch.cuda.synchronize()
                if out_k.dtype != out:
                    fail(f"eo hop {name} wrote {out_k.dtype}")
                abs_err = (out_k.float() - out_p.float()).abs().max().item()
                rel = abs_err / out_p.float().abs().max().item()
                errs[name] = max(errs[name], abs_err)
                emit({"phase": "check", "kernel": "dslash_eo_pallas_packed",
                      "form": name, "dims_xyzt": list(dims_xyzt),
                      "parity": parity, "max_abs_err": abs_err,
                      "max_rel_err": rel, "tolerance": tol})
                if not rel <= tol:
                    fail(f"eo hop kernel {name} disagrees with its plain "
                         f"version: {rel:.3e} > {tol:g}")
                del u_here, u_bw, psi, out_k, out_p

    # every fused clover hop instance: (kernel, rows, storage dtype); K1
    # (post) writes the storage dtype, K2 (diag_hop) float32
    b7_forms = [(k, r, st) for k in ("post", "diag_hop") for r in (3, 2)
                for st in (f32, bf16)]
    b7_names = [f"{k}:{wpp.form_name(r, st, clp.out_dtype_of(k, st))}"
                for k, r, st in b7_forms]
    b7_wrapper = {"post": clp.dslash_eo_pallas_post,
                  "diag_hop": clp.dslash_eo_pallas_diag_hop}
    hop_coeff = -KAPPA ** 2
    # a generator of its own, so the fields of the later phases stay the
    # ones earlier versions of this script made
    gen_b7 = torch.Generator(device=dev).manual_seed(SEED + 7)

    def b7_inputs(dims_xyzt, parity, rows, store):
        """B1's inputs plus the blocks (1 + 0.1 Gaussian, the size of a
        clover term) and K2's centre spinor x."""
        dims, u_here, u_bw, psi = b1_inputs(dims_xyzt, parity, rows, store,
                                            gen_b7)
        sites = tuple(psi.shape[3:])
        blk = 0.1 * torch.randn((2, 6, 6, 2) + sites, generator=gen_b7,
                                device=dev)
        blk[:, :, :, 0] += torch.eye(6, device=dev).reshape(1, 6, 6, 1, 1, 1)
        xc = torch.randn((4, 3, 2) + sites, generator=gen_b7, device=dev)
        return dims, u_here, u_bw, psi, blk.to(store), xc.to(store)

    def b7_call(kind, args, parity, plain=False):
        dims, u_here, u_bw, psi, blk, xc = args
        if kind == "post":
            if plain:
                return clp.dslash_eo_post_plain(u_here, u_bw, psi, blk, dims,
                                                parity)
            return clp.dslash_eo_pallas_post(u_here, u_bw, psi, dims, parity,
                                             blk_pl=blk)
        if plain:
            return clp.dslash_eo_diag_hop_plain(u_here, u_bw, psi, xc, blk,
                                                dims, parity, hop_coeff, f32)
        return clp.dslash_eo_pallas_diag_hop(u_here, u_bw, psi, xc, dims,
                                             parity, hop_coeff=hop_coeff,
                                             blk_pl=blk, out_dtype=f32)

    for (kind, rows, store), name in zip(b7_forms, b7_names):
        out = clp.out_dtype_of(kind, store)
        tol = clp.TOLERANCE if out == f32 else clp.TOLERANCE_BF16
        errs[name] = 0.0
        for dims_xyzt in (SMALL_DIMS, PROD_DIMS):
            for parity in (0, 1):
                args = b7_inputs(dims_xyzt, parity, rows, store)
                out_k = b7_call(kind, args, parity)
                out_p = b7_call(kind, args, parity, plain=True)
                torch.cuda.synchronize()
                if out_k.dtype != out:
                    fail(f"clover hop {name} wrote {out_k.dtype}")
                abs_err = (out_k.float() - out_p.float()).abs().max().item()
                rel = abs_err / out_p.float().abs().max().item()
                errs[name] = max(errs[name], abs_err)
                emit({"phase": "check", "kernel": b7_wrapper[kind].__name__,
                      "form": name, "dims_xyzt": list(dims_xyzt),
                      "parity": parity, "max_abs_err": abs_err,
                      "max_rel_err": rel, "tolerance": tol})
                if not rel <= tol:
                    fail(f"clover hop kernel {name} disagrees with its "
                         f"plain version: {rel:.3e} > {tol:g}")
                del args, out_k, out_p

    # the multi-RHS kernels (B5-eo, K1/K2-mrhs), float32, full and r12:
    # against their plain versions (tolerance of the single-RHS kernels)
    # and against N launches of the single-RHS kernel (each lane bit for
    # bit B1, K1 or K2)
    mrhs_forms = [(k, r) for k in ("hop", "post", "diag_hop") for r in (3, 2)]
    mrhs_names = [f"{k}:{wpp.form_name(r, f32, f32)}" for k, r in mrhs_forms]
    mrhs_wrapper = {"hop": wpp.dslash_eo_pallas_packed_mrhs,
                    "post": clp.dslash_eo_pallas_post_mrhs,
                    "diag_hop": clp.dslash_eo_pallas_diag_hop_mrhs}
    # the chunk widths of each (K1/K2-mrhs has one), and its default
    mrhs_widths = {"hop": wpp.MRHS_CHUNKS, "post": (clp.K_MRHS_CHUNK,),
                   "diag_hop": (clp.K_MRHS_CHUNK,)}
    mrhs_default = {"hop": wpp.EO_MRHS_CHUNK, "post": clp.K_MRHS_CHUNK,
                    "diag_hop": clp.K_MRHS_CHUNK}
    gen_mrhs = torch.Generator(device=dev).manual_seed(SEED + 5)

    def mrhs_inputs(dims_xyzt, parity, rows, n):
        """B7's inputs (float32) with n-RHS psi and x batches."""
        dims, u_here, u_bw, psi, blk, _ = b7_inputs(dims_xyzt, parity, rows,
                                                    f32)
        sites = tuple(psi.shape[3:])
        psi_b = torch.randn((n, 4, 3, 2) + sites, generator=gen_mrhs,
                            device=dev)
        xc_b = torch.randn((n, 4, 3, 2) + sites, generator=gen_mrhs,
                           device=dev)
        return dims, u_here, u_bw, psi_b, blk, xc_b

    def mrhs_call(kind, args, parity, how="kernel", chunk=None):
        """One multi-RHS call: the kernel, its plain version, or the batch
        through N launches of the single-RHS kernel (a list of the N
        outputs)."""
        dims, u_here, u_bw, psi, blk, xc = args
        if how == "single":
            outs = []
            for r in range(psi.shape[0]):
                if kind == "hop":
                    outs.append(wpp.dslash_eo_pallas_packed(
                        u_here, u_bw, psi[r], dims, parity))
                else:
                    outs.append(b7_call(kind, (dims, u_here, u_bw, psi[r],
                                               blk, xc[r]), parity))
            return outs
        plain = how == "plain"
        if kind == "hop":
            if plain:
                return wpp.dslash_eo_packed_mrhs_plain(u_here, u_bw, psi,
                                                       dims, parity)
            return wpp.dslash_eo_pallas_packed_mrhs(u_here, u_bw, psi, dims,
                                                    parity, chunk=chunk)
        if kind == "post":
            if plain:
                return clp.dslash_eo_post_mrhs_plain(u_here, u_bw, psi, blk,
                                                     dims, parity)
            return clp.dslash_eo_pallas_post_mrhs(u_here, u_bw, psi, dims,
                                                  parity, blk_pl=blk,
                                                  chunk=chunk)
        if plain:
            return clp.dslash_eo_diag_hop_mrhs_plain(
                u_here, u_bw, psi, xc, blk, dims, parity, hop_coeff, f32)
        return clp.dslash_eo_pallas_diag_hop_mrhs(
            u_here, u_bw, psi, xc, dims, parity, hop_coeff=hop_coeff,
            blk_pl=blk, out_dtype=f32, chunk=chunk)

    mrhs_vs_single = {}
    for (kind, rows), name in zip(mrhs_forms, mrhs_names):
        tol = wpp.TOLERANCE if kind == "hop" else clp.TOLERANCE
        errs[f"mrhs:{name}"] = 0.0
        mrhs_vs_single[name] = 0.0
        cases = [(SMALL_DIMS, parity, n) for parity in (0, 1)
                 for n in (1, 3, 12)] + [(PROD_DIMS, 0, MULTI_SRC_N)]
        for dims_xyzt, parity, n in cases:
            args = mrhs_inputs(dims_xyzt, parity, rows, n)
            out_k = mrhs_call(kind, args, parity)
            out_p = mrhs_call(kind, args, parity, "plain")
            out_s = torch.stack(mrhs_call(kind, args, parity, "single"))
            torch.cuda.synchronize()
            scale = out_p.abs().max().item()
            abs_err = (out_k - out_p).abs().max().item()
            rel = abs_err / scale
            rel_single = (out_k - out_s).abs().max().item() / scale
            errs[f"mrhs:{name}"] = max(errs[f"mrhs:{name}"], abs_err)
            mrhs_vs_single[name] = max(mrhs_vs_single[name], rel_single)
            # every lane is its single-RHS kernel's bit for bit
            bitwise = bool(torch.equal(out_k, out_s))
            emit({"phase": "check", "kernel": mrhs_wrapper[kind].__name__,
                  "form": name, "dims_xyzt": list(dims_xyzt),
                  "parity": parity, "nrhs": n, "chunk": mrhs_default[kind],
                  "max_abs_err": abs_err, "max_rel_err": rel,
                  "max_rel_diff_single_launches": rel_single,
                  "lanes_bitwise_single": bitwise, "tolerance": tol})
            if not (rel <= tol and rel_single <= tol and
                    out_k.shape == args[3].shape and bitwise):
                fail(f"multi-RHS kernel {name} disagrees with its plain "
                     f"version or with {n} single-RHS launches: {rel:.3e}, "
                     f"{rel_single:.3e} > {tol:g} (bit for bit: {bitwise})")
            del args, out_k, out_p, out_s

    geom_p = LatticeGeometry(PROD_DIMS)
    n_half = 24 * geom_p.half_volume
    half_shape = (4, 3, 2, geom_p.T, geom_p.Z, geom_p.Y * geom_p.X // 2)
    tail_in = [torch.randn(n_half, generator=gen, device=dev).reshape(
        half_shape) for _ in range(4)]
    alpha = torch.tensor(0.37, dtype=torch.float32, device=dev)
    xk, rk, r2k = bpl.cg_update_norm2_pallas(alpha, *tail_in)
    xk2, rk2, r2k2 = bpl.cg_update_norm2_pallas(alpha, *tail_in)
    xp, rp, r2p = blas.triple_cg_update(alpha, *tail_in)
    torch.cuda.synchronize()
    vec_err = max((xk - xp).abs().max().item(), (rk - rp).abs().max().item())
    vec_rel = vec_err / max(xp.abs().max().item(), rp.abs().max().item())
    r2_rel = abs(r2k.item() - r2p.item()) / r2p.item()
    deterministic = bool(torch.equal(r2k, r2k2) and torch.equal(rk, rk2))
    errs["b2"] = vec_err
    emit({"phase": "check", "kernel": "cg_update_norm2_pallas",
          "elements": n_half, "max_abs_err": vec_err, "max_rel_err": vec_rel,
          "r2_rel_err": r2_rel, "deterministic": deterministic,
          "tolerance": bpl.TOLERANCE})
    if not (vec_rel <= bpl.TOLERANCE and r2_rel <= bpl.TOLERANCE
            and deterministic):
        fail("CG tail kernel disagrees with its plain version or is not "
             "deterministic")
    del xk, rk, xk2, rk2, xp, rp

    a_b3 = torch.tensor(-0.37, dtype=torch.float32, device=dev)
    b3_in = {}
    for dt in (f32, bf16):
        name = "f32" if dt == f32 else "bf16"
        x3, y3 = (t.to(dt) for t in tail_in[:2])
        b3_in[name] = (x3, y3)
        yk, n2k = bpl.axpy_norm2_pallas(a_b3, x3, y3)
        yk2, n2k2 = bpl.axpy_norm2_pallas(a_b3, x3, y3)
        yp, n2p = bpl.axpy_norm2_plain(a_b3, x3, y3)
        torch.cuda.synchronize()
        abs_err = (yk.float() - yp.float()).abs().max().item()
        rel = abs_err / yp.float().abs().max().item()
        n2_rel = abs(n2k.item() - n2p.item()) / n2p.item()
        deterministic = bool(torch.equal(n2k, n2k2) and torch.equal(yk, yk2))
        errs[f"b3:{name}"] = abs_err
        emit({"phase": "check", "kernel": "axpy_norm2_pallas", "form": name,
              "elements": n_half, "max_abs_err": abs_err,
              "max_rel_err": rel, "n2_rel_err": n2_rel,
              "deterministic": deterministic, "tolerance": bpl.TOLERANCE})
        if not (rel <= bpl.TOLERANCE and n2_rel <= bpl.TOLERANCE
                and deterministic and yk.dtype == dt):
            fail(f"axpy_norm2 kernel ({name}) disagrees with its plain "
                 "version or is not deterministic")
        del yk, yk2, yp

    # -- 4. the main paths at production size ---------------------------
    t0 = time.perf_counter()
    gauge = GaugeField.random(geom_p, gen, dtype=torch.complex64,
                              device=dev).data
    src = ColorSpinorField.gaussian(geom_p, gen, dtype=torch.complex64,
                                    device=dev).data
    torch.cuda.synchronize()
    t_fields = time.perf_counter() - t0
    launches = {}

    def zero_counts():
        wpp.reset_launches()
        clp.reset_launches()
        bpl.cg_update_norm2_pallas.launches = 0
        bpl.axpy_norm2_pallas.launches = 0
        bpl.axpy_norm2_pallas.launches_by_form = {}

    def read_counts():
        return {"b1": wpp.dslash_eo_pallas_packed.launches,
                "b1_by_form": dict(
                    wpp.dslash_eo_pallas_packed.launches_by_form),
                "b2": bpl.cg_update_norm2_pallas.launches,
                "b3_by_form": dict(bpl.axpy_norm2_pallas.launches_by_form),
                "k1": clp.dslash_eo_pallas_post.launches,
                "k2": clp.dslash_eo_pallas_diag_hop.launches,
                "mrhs_by_form": {
                    f"{k}:{form}": n for k, fn in mrhs_wrapper.items()
                    for form, n in fn.launches_by_form.items()},
                "b7_by_form": {
                    f"{k}:{form}": n for k, fn in b7_wrapper.items()
                    for form, n in fn.launches_by_form.items()}}

    def solve(reconstruct=18, **kw):
        """init -> load -> invert -> end at production size, counts zeroed
        just before invert_quda and read just after."""
        qt.init_quda(dev)
        try:
            qt.load_gauge_quda(gauge, qt.GaugeParam(
                X=PROD_DIMS, cuda_prec="single", reconstruct=reconstruct))
            base = dict(dslash_type="wilson", inv_type="cg",
                        solve_type="normop-pc", kappa=KAPPA, tol=TOL,
                        maxiter=2000, cuda_prec="single")
            base.update(kw)
            param = qt.InvertParam(**base)
            torch.cuda.reset_peak_memory_stats(dev)
            zero_counts()
            x = qt.invert_quda(src, param)
            torch.cuda.synchronize()
            counts = read_counts()
        finally:
            qt.end_quda()
        finite = bool(torch.isfinite(torch.view_as_real(x)).all())
        shape_ok = tuple(x.shape) == geom_p.spinor_shape()
        return x, param, counts, finite, shape_ok

    x, param, counts, finite, shape_ok = solve()
    launches["default"] = counts
    emit({"phase": "invert", "dims_xyzt": list(PROD_DIMS), "kappa": KAPPA,
          "tol": TOL, "iters": param.iter_count, "secs": param.secs,
          "true_res": param.true_res, "converged": param.converged,
          "gflop": param.gflops, "field_setup_secs": t_fields,
          "launches_dslash_eo": counts["b1"],
          "launches_cg_tail": counts["b2"],
          "shape_ok": shape_ok, "finite": finite,
          "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9})
    if not (param.converged and param.true_res <= TRUE_RES_MAX and finite
            and shape_ok):
        fail("invert_quda did not converge to a finite solution with "
             f"true_res <= {TRUE_RES_MAX:g}")
    if counts["b1"] < 4 * param.iter_count or \
            counts["b2"] < param.iter_count:
        fail(f"main path did not run through the kernels: {counts}")
    iters_main = param.iter_count
    del x

    mixed, half_ref = {}, {}
    for form, rec in (("full", 18), ("r12", 12)):
        x, param, counts, finite, shape_ok = solve(rec,
                                                   cuda_prec_sloppy="half")
        launches[f"mixed:{form}"] = counts
        by = counts["b1_by_form"]
        bf16_hops = sum(v for k, v in by.items() if ":bf16->" in k)
        r12_hops = sum(v for k, v in by.items() if k.startswith("r12:"))
        b3 = counts["b3_by_form"].get("bf16", 0)
        mixed[form] = (param.iter_count, param.secs)
        half_ref[form] = (param.iter_count, param.reliable_updates)
        emit({"phase": "invert_mixed", "precision_form": form,
              "dims_xyzt": list(PROD_DIMS), "kappa": KAPPA, "tol": TOL,
              "cuda_prec_sloppy": "half", "iters": param.iter_count,
              "reliable_updates": param.reliable_updates,
              "secs": param.secs, "true_res": param.true_res,
              "converged": param.converged, "launches_dslash_eo": by,
              "launches_axpy_norm2": counts["b3_by_form"],
              "shape_ok": shape_ok, "finite": finite,
              "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9})
        if not (param.converged and param.true_res <= TRUE_RES_MAX
                and finite and shape_ok and param.reliable_updates >= 1):
            fail(f"mixed invert_quda ({form}) did not converge with "
                 f"true_res <= {TRUE_RES_MAX:g} and a reliable update")
        if bf16_hops < 4 * param.iter_count or b3 < param.iter_count or (
                form == "r12" and r12_hops < 4 * param.iter_count):
            fail(f"mixed path ({form}) did not run through the bf16 hop "
                 f"and B3 kernels: {counts}")
        del x

    x, param, counts, finite, shape_ok = solve(tol=DF64_TOL)
    launches["df64"] = counts
    df64_ref = (param.iter_count, param.reliable_updates)
    x128 = x.to(torch.complex128) + param.x_df64_lo.to(torch.complex128)
    d128 = DiracWilson(gauge.to(torch.complex128), geom_p, KAPPA)
    b128 = src.to(torch.complex128)
    oracle = float(torch.linalg.vector_norm(b128 - d128.M(x128))
                   / torch.linalg.vector_norm(b128))
    del x128, d128, b128
    emit({"phase": "invert_df64", "dims_xyzt": list(PROD_DIMS),
          "kappa": KAPPA, "tol": DF64_TOL, "cuda_prec_sloppy": "single",
          "iters": param.iter_count,
          "reliable_updates": param.reliable_updates, "secs": param.secs,
          "true_res": param.true_res, "true_res_complex128": oracle,
          "converged": param.converged, "launches_dslash_eo":
          counts["b1_by_form"], "launches_axpy_norm2": counts["b3_by_form"],
          "shape_ok": shape_ok, "finite": finite,
          "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9})
    if not (param.converged and param.true_res <= DF64_TOL
            and oracle <= DF64_TOL and finite and shape_ok):
        fail(f"df64 invert_quda missed true_res <= {DF64_TOL:g} "
             f"(df64 {param.true_res:.3e}, complex128 {oracle:.3e})")
    del x

    clover = {}
    for sloppy, form, rec in (("single", "full", 18), ("half", "full", 18),
                              ("half", "r12", 12)):
        label = f"clover:{sloppy}" + (":r12" if form == "r12" else "")
        row = {"phase": "invert_clover", "dims_xyzt": list(PROD_DIMS),
               "kappa": KAPPA, "csw": CSW, "tol": TOL,
               "cuda_prec_sloppy": sloppy, "precision_form": form}
        try:
            x, param, counts, finite, shape_ok = solve(
                rec, dslash_type="clover", csw=CSW, cuda_prec_sloppy=sloppy)
        except CloverNotPositiveDefinite as err:
            row.update(blocks_positive_definite=False,
                       blocks_not_positive_definite=err.bad_blocks,
                       blocks=err.total)
            emit(row)
            fail(f"clover term not positive definite at csw {CSW}: {err}")
        launches[label] = counts
        b3 = counts["b3_by_form"].get("bf16", 0)
        clover[label] = (param.iter_count, param.secs)
        row.update({
            "blocks_positive_definite": True, "iters": param.iter_count,
            "reliable_updates": param.reliable_updates, "secs": param.secs,
            "true_res": param.true_res, "converged": param.converged,
            "launches_k1": counts["k1"], "launches_k2": counts["k2"],
            "launches_k1_k2_per_iter": [counts["k1"] / param.iter_count,
                                        counts["k2"] / param.iter_count],
            "launches_clover_hop": counts["b7_by_form"],
            "launches_axpy_norm2": counts["b3_by_form"],
            "shape_ok": shape_ok, "finite": finite,
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9})
        emit(row)
        if not (param.converged and param.true_res <= TRUE_RES_MAX
                and finite and shape_ok):
            fail(f"clover invert_quda ({label}) did not converge to a "
                 f"finite solution with true_res <= {TRUE_RES_MAX:g}")
        if counts["k1"] < 2 * param.iter_count or \
                counts["k2"] < 2 * param.iter_count:
            fail(f"clover path ({label}) did not run K1 and K2 twice per "
                 f"iteration: {counts}")
        if sloppy == "half" and (b3 < param.iter_count
                                 or param.reliable_updates < 1):
            fail(f"clover mixed path ({label}) did not run B3 once per "
                 f"iteration with a reliable update: {counts}")
        del x

    # -- the multi-source path: invert_multi_src_quda, N sources ---------
    gen_src = torch.Generator(device=dev).manual_seed(SEED + 4)
    srcs = torch.stack([ColorSpinorField.gaussian(
        geom_p, gen_src, dtype=torch.complex64, device=dev).data
        for _ in range(MULTI_SRC_N)])
    lane0 = {}
    for family in ("wilson", "clover"):
        kw = {"csw": CSW} if family == "clover" else {}
        qt.init_quda(dev)
        try:
            qt.load_gauge_quda(gauge, qt.GaugeParam(X=PROD_DIMS,
                                                    cuda_prec="single"))
            p0 = qt.InvertParam(dslash_type=family, inv_type="cg",
                                solve_type="normop-pc", kappa=KAPPA, tol=TOL,
                                maxiter=2000, cuda_prec="single", **kw)
            qt.invert_quda(srcs[0], p0)
        finally:
            qt.end_quda()
        lane0[family] = p0.iter_count

    multi = {}
    for label, family, rec, block in (
            ("wilson", "wilson", 18, False), ("wilson:r12", "wilson", 12, False),
            ("wilson:block", "wilson", 18, True),
            ("clover", "clover", 18, False), ("clover:r12", "clover", 12, False)):
        kw = {"csw": CSW} if family == "clover" else {}
        qt.init_quda(dev)
        try:
            qt.load_gauge_quda(gauge, qt.GaugeParam(
                X=PROD_DIMS, cuda_prec="single", reconstruct=rec))
            param = qt.InvertParam(dslash_type=family, inv_type="cg",
                                   solve_type="normop-pc", kappa=KAPPA,
                                   tol=TOL, maxiter=2000, cuda_prec="single",
                                   **kw)
            os.environ["QUDA_TORCH_MULTI_SRC_BLOCK"] = "1" if block else ""
            torch.cuda.reset_peak_memory_stats(dev)
            zero_counts()
            x = qt.invert_multi_src_quda(srcs, param)
            torch.cuda.synchronize()
            counts = read_counts()
        finally:
            os.environ.pop("QUDA_TORCH_MULTI_SRC_BLOCK", None)
            qt.end_quda()
        launches[f"multi:{label}"] = counts
        finite = bool(torch.isfinite(torch.view_as_real(x)).all())
        shape_ok = tuple(x.shape) == (MULTI_SRC_N,) + geom_p.spinor_shape()
        iters = param.iter_count_multi
        multi[label] = (iters, param.secs)
        by = counts["mrhs_by_form"]
        emit({"phase": "invert_multi_src", "label": label,
              "dims_xyzt": list(PROD_DIMS), "nrhs": MULTI_SRC_N,
              "dslash_type": family, "kappa": KAPPA, "tol": TOL,
              "reconstruct": rec, "block_cg": block,
              "chunk": mrhs_default["hop" if family == "wilson" else "post"],
              "iters_per_lane": iters,
              "iter_count": param.iter_count,
              "invert_quda_iters_source0": lane0[family],
              "true_res_worst": param.true_res,
              "true_res_multi": param.true_res_multi,
              "converged_multi": param.converged_multi, "secs": param.secs,
              "gflop": param.gflops, "launches_mrhs": by,
              "launches_single_rhs": {"b1": counts["b1"], "k1": counts["k1"],
                                      "k2": counts["k2"]},
              "shape_ok": shape_ok, "finite": finite,
              "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9})
        if not (param.converged and all(param.converged_multi)
                and param.true_res <= TRUE_RES_MAX and finite and shape_ok):
            fail(f"invert_multi_src_quda ({label}) did not converge every "
                 f"lane to a finite solution with true_res <= "
                 f"{TRUE_RES_MAX:g}")
        if abs(iters[0] - lane0[family]) > 2:
            fail(f"invert_multi_src_quda ({label}): lane 0 took {iters[0]} "
                 f"iterations, invert_quda on source 0 {lane0[family]}")
        form = wpp.form_name(2 if rec == 12 else 3, f32, f32)
        hops = by.get(f"hop:{form}", 0)
        k1m, k2m = by.get(f"post:{form}", 0), by.get(f"diag_hop:{form}", 0)
        n_it = max(iters)
        if hops < 1 or (family == "wilson" and hops < 4 * n_it) or (
                family == "clover" and (k1m < 2 * n_it or k2m < 2 * n_it)):
            fail(f"multi-source path ({label}) did not run through the "
                 f"multi-RHS kernels: {counts}")
        if counts["b1"] or counts["k1"] or counts["k2"]:
            fail(f"multi-source path ({label}) launched a single-RHS hop: "
                 f"{counts}")
        del x

    # -- 5. small solves: card against the CPU's plain path -------------
    geom_s = LatticeGeometry(SMALL_DIMS)
    rng = np.random.default_rng(SEED)
    shp = geom_s.gauge_shape()
    g_np = (np.broadcast_to(np.eye(3), shp) + 0.3 * (
        rng.standard_normal(shp) + 1j * rng.standard_normal(shp))
            ).astype(np.complex64)
    sshp = geom_s.spinor_shape()
    b_np = (rng.standard_normal(sshp)
            + 1j * rng.standard_normal(sshp)).astype(np.complex64)
    for sloppy, sol_tol, it_tol in (("single", 1e-4, None),
                                    ("half", 1e-3, 0.1)):
        sols = {}
        for where in (dev, "cpu"):
            qt.init_quda(where)
            qt.load_gauge_quda(g_np, qt.GaugeParam(X=SMALL_DIMS,
                                                   cuda_prec="single"))
            p = qt.InvertParam(dslash_type="wilson", inv_type="cg",
                               solve_type="normop-pc", kappa=KAPPA,
                               tol=TOL, maxiter=500, cuda_prec="single",
                               cuda_prec_sloppy=sloppy)
            sols[str(where)] = (qt.invert_quda(b_np, p).cpu().numpy(), p)
            qt.end_quda()
        (x_gpu, p_gpu), (x_cpu, p_cpu) = sols[str(dev)], sols["cpu"]
        sol_rel = float(np.linalg.norm(x_gpu - x_cpu)
                        / np.linalg.norm(x_cpu))
        emit({"phase": "reference", "dims_xyzt": list(SMALL_DIMS),
              "cuda_prec_sloppy": sloppy, "iters_card": p_gpu.iter_count,
              "iters_cpu": p_cpu.iter_count,
              "true_res_card": p_gpu.true_res,
              "solution_rel_diff": sol_rel})
        di = abs(p_gpu.iter_count - p_cpu.iter_count)
        it_ok = di <= 2 if it_tol is None else di <= it_tol * p_cpu.iter_count
        if not (sol_rel <= sol_tol and it_ok and p_gpu.converged):
            fail(f"the card's small {sloppy}-sloppy solve disagrees with "
                 "the CPU's plain path")
    # clover on SU(3) links (a numpy-seeded field made on the CPU)
    g_su3 = GaugeField.random(geom_s, np.random.default_rng(SEED),
                              dtype=torch.complex64, device="cpu").data
    sols = {}
    for where in (dev, "cpu"):
        qt.init_quda(where)
        qt.load_gauge_quda(g_su3, qt.GaugeParam(X=SMALL_DIMS,
                                                cuda_prec="single"))
        p = qt.InvertParam(dslash_type="clover", inv_type="cg",
                           solve_type="normop-pc", kappa=KAPPA, csw=CSW,
                           tol=TOL, maxiter=500, cuda_prec="single")
        sols[str(where)] = (qt.invert_quda(b_np, p).cpu().numpy(), p)
        qt.end_quda()
    (x_gpu, p_gpu), (x_cpu, p_cpu) = sols[str(dev)], sols["cpu"]
    sol_rel = float(np.linalg.norm(x_gpu - x_cpu) / np.linalg.norm(x_cpu))
    emit({"phase": "reference", "dims_xyzt": list(SMALL_DIMS),
          "dslash_type": "clover", "csw": CSW, "cuda_prec_sloppy": "single",
          "iters_card": p_gpu.iter_count, "iters_cpu": p_cpu.iter_count,
          "true_res_card": p_gpu.true_res, "solution_rel_diff": sol_rel})
    if not (sol_rel <= 1e-4 and p_gpu.converged
            and abs(p_gpu.iter_count - p_cpu.iter_count) <= 2):
        fail("the card's small clover solve disagrees with the CPU's plain "
             "path")

    # the multi-source route on 3 sources (Wilson, clover)
    b_multi = np.stack([b_np] + [
        (rng.standard_normal(sshp) + 1j * rng.standard_normal(sshp)
         ).astype(np.complex64) for _ in range(2)])
    for family in ("wilson", "clover"):
        sols = {}
        for where in (dev, "cpu"):
            qt.init_quda(where)
            qt.load_gauge_quda(g_su3, qt.GaugeParam(X=SMALL_DIMS,
                                                    cuda_prec="single"))
            p = qt.InvertParam(dslash_type=family, inv_type="cg",
                               solve_type="normop-pc", kappa=KAPPA, csw=CSW,
                               tol=TOL, maxiter=500, cuda_prec="single")
            sols[str(where)] = (
                qt.invert_multi_src_quda(b_multi, p).cpu().numpy(), p)
            qt.end_quda()
        (x_gpu, p_gpu), (x_cpu, p_cpu) = sols[str(dev)], sols["cpu"]
        sol_rel = float(np.linalg.norm(x_gpu - x_cpu)
                        / np.linalg.norm(x_cpu))
        emit({"phase": "reference", "dims_xyzt": list(SMALL_DIMS),
              "api": "invert_multi_src_quda", "dslash_type": family,
              "nrhs": len(b_multi), "iters_card": p_gpu.iter_count_multi,
              "iters_cpu": p_cpu.iter_count_multi,
              "true_res_card": p_gpu.true_res_multi,
              "solution_rel_diff": sol_rel})
        if not (sol_rel <= 1e-4 and p_gpu.converged and all(
                abs(a - b) <= 2 for a, b in zip(p_gpu.iter_count_multi,
                                                p_cpu.iter_count_multi))):
            fail(f"the card's small {family} multi-source solve disagrees "
                 "with the CPU's plain path")

    # -- 6. timing at production size -----------------------------------
    dims = geom_p.lattice_shape
    half = geom_p.half_volume
    timing, bound_by = {}, {}
    for (rows, store, out), name in zip(b1_forms, b1_names):
        _, u_here, u_bw, psi = b1_inputs(PROD_DIMS, 0, rows, store)
        k_ms = median_ms(lambda: wpp.dslash_eo_pallas_packed(
            u_here, u_bw, psi, dims, 0, out_dtype=out), torch)
        p_ms = median_ms(lambda: wpp.dslash_eo_packed_plain(
            u_here, u_bw, psi, dims, 0, out_dtype=out), torch)
        t_bytes = wpp.bytes_per_site(rows, store, out) * half \
            / HBM_BYTES_PER_S
        t_ops = wpp.flops_per_site(rows) * half / F32_FLOPS_PER_S
        bound_by[name] = "bytes" if t_bytes >= t_ops else "operations"
        timing[name] = (k_ms, p_ms, 1e3 * max(t_bytes, t_ops))
        del u_here, u_bw, psi
    b1_nol2_ms = 1e3 * 1440 * half / HBM_BYTES_PER_S
    b2_ms = median_ms(lambda: bpl.cg_update_norm2_pallas(alpha, *tail_in),
                      torch)
    b2_plain_ms = median_ms(lambda: blas.triple_cg_update(alpha, *tail_in),
                            torch)
    b2_bound_ms = 1e3 * max(bpl.BYTES_PER_ELEMENT * n_half / HBM_BYTES_PER_S,
                            6 * n_half / F32_FLOPS_PER_S)
    timing["b2"] = (b2_ms, b2_plain_ms, b2_bound_ms)
    for name, (x3, y3) in b3_in.items():
        k_ms = median_ms(lambda: bpl.axpy_norm2_pallas(a_b3, x3, y3), torch)
        p_ms = median_ms(lambda: bpl.axpy_norm2_plain(a_b3, x3, y3), torch)
        nbytes = bpl.AXPY_BYTES_PER_ELEMENT[x3.dtype] * n_half
        bound = 1e3 * max(nbytes / HBM_BYTES_PER_S,
                          4 * n_half / F32_FLOPS_PER_S)
        timing[f"b3:{name}"] = (k_ms, p_ms, bound)
    del tail_in, b3_in
    for (kind, rows, store), name in zip(b7_forms, b7_names):
        args = b7_inputs(PROD_DIMS, 0, rows, store)
        k_ms = median_ms(lambda: b7_call(kind, args, 0), torch)
        p_ms = median_ms(lambda: b7_call(kind, args, 0, plain=True), torch)
        t_bytes = clp.bytes_per_site(kind, rows, store) * half \
            / HBM_BYTES_PER_S
        t_ops = clp.flops_per_site(kind, rows) * half / F32_FLOPS_PER_S
        bound_by[name] = "bytes" if t_bytes >= t_ops else "operations"
        timing[name] = (k_ms, p_ms, 1e3 * max(t_bytes, t_ops))
        del args

    # multi-RHS kernels at N = MULTI_SRC_N: each chunk width, the plain
    # version (a few calls: it takes ~N x a single plain call) and N
    # launches of the single-RHS kernel of the same form
    mrhs_timing, mrhs_chunks = {}, {}
    for (kind, rows), name in zip(mrhs_forms, mrhs_names):
        args = mrhs_inputs(PROD_DIMS, 0, rows, MULTI_SRC_N)
        by_chunk = {nb: median_ms(lambda: mrhs_call(kind, args, 0,
                                                    chunk=nb), torch)
                    for nb in mrhs_widths[kind]}
        single_ms = median_ms(lambda: mrhs_call(kind, args, 0, "single"),
                              torch, repeats=10, batch=2)
        p_ms = median_ms(lambda: mrhs_call(kind, args, 0, "plain"), torch,
                         repeats=3, batch=1)
        if kind == "hop":
            nbytes = wpp.bytes_per_site_mrhs(MULTI_SRC_N, rows)
            nflop = wpp.flops_per_site_mrhs(MULTI_SRC_N, rows)
        else:
            nbytes = clp.bytes_per_site_mrhs(kind, MULTI_SRC_N, rows)
            nflop = clp.flops_per_site_mrhs(kind, MULTI_SRC_N, rows)
        t_bytes = nbytes * half / HBM_BYTES_PER_S
        t_ops = nflop * half / F32_FLOPS_PER_S
        bound_by[f"mrhs:{name}"] = "bytes" if t_bytes >= t_ops else \
            "operations"
        k_ms = by_chunk[mrhs_default[kind]]
        mrhs_timing[name] = (k_ms, p_ms, 1e3 * max(t_bytes, t_ops),
                             single_ms)
        mrhs_chunks[name] = by_chunk
        del args

    be, bo = even_odd_split(src, geom_p)

    def iteration_ms(dirac):
        """ms per fused_cg iteration (f32) and per cg_reliable iteration
        (single/half, full and r12 links, reliable updates included) of
        the pair operators ``dirac.pairs`` builds."""
        op = dirac.pairs(torch.float32)
        rhs = op.Mdag_pairs(op.prepare_pairs(be, bo))
        fused_cg(op.MdagM_pairs, rhs, tol=1e-30, maxiter=2)   # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fused_cg(op.MdagM_pairs, rhs, tol=1e-30, maxiter=30)
        torch.cuda.synchronize()
        fused = (1e3 * (time.perf_counter() - t0) / res.iters, res.iters)
        del op
        mixed_ms = {}
        for form in ("full", "r12"):
            hi = dirac.pairs(torch.float32, precision_form=form)
            lo = dirac.pairs(torch.bfloat16, precision_form=form)
            codec = pair_inplace_codec(torch.bfloat16)
            cg_reliable(hi.MdagM_pairs, lo.MdagM_pairs, rhs, tol=1e-30,
                        maxiter=2, codec=codec)              # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res_m = cg_reliable(hi.MdagM_pairs, lo.MdagM_pairs, rhs,
                                tol=1e-30, maxiter=MIXED_ITER_TIMED,
                                codec=codec)
            torch.cuda.synchronize()
            mixed_ms[form] = (1e3 * (time.perf_counter() - t0)
                              / res_m.iters, res_m.iters,
                              res_m.reliable_updates)
            del hi, lo
        return fused, mixed_ms

    (iter_ms, n_timed), mixed_ms = iteration_ms(
        DiracWilsonPC(gauge, geom_p, KAPPA).packed())
    (cl_iter_ms, cl_n_timed), cl_mixed_ms = iteration_ms(
        DiracCloverPC(gauge, geom_p, KAPPA, CSW))

    def batched_iteration_ms(dirac):
        """ms per batched_cg_pairs iteration (N = MULTI_SRC_N lanes, f32
        pair operator, multi-RHS kernels)."""
        op = dirac.pairs(torch.float32)
        be_b, bo_b = (torch.stack(h).contiguous() for h in zip(
            *(even_odd_split(srcs[i], geom_p) for i in range(MULTI_SRC_N))))
        rhs_b = op.Mdag_pairs_mrhs(op.prepare_pairs_mrhs(be_b, bo_b))
        del be_b, bo_b
        batched_cg_pairs(op.MdagM_pairs_mrhs, rhs_b, tol=1e-30,
                         maxiter=2)                           # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = batched_cg_pairs(op.MdagM_pairs_mrhs, rhs_b, tol=1e-30,
                               maxiter=BATCHED_ITER_TIMED)
        torch.cuda.synchronize()
        n_it = int(res.iters.max())
        return 1e3 * (time.perf_counter() - t0) / n_it, n_it

    b_iter_ms, b_n_timed = batched_iteration_ms(
        DiracWilsonPC(gauge, geom_p, KAPPA).packed())
    cl_b_iter_ms, cl_b_n_timed = batched_iteration_ms(
        DiracCloverPC(gauge, geom_p, KAPPA, CSW))
    row = {"phase": "timing", "dims_xyzt": list(PROD_DIMS),
           "nvidia_smi": smi, "repeats": REPEATS, "calls_per_timing": BATCH}
    for name, (k_ms, p_ms, bound) in timing.items():
        row[name] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound}
    for (kind, rows), name in zip(mrhs_forms, mrhs_names):
        k_ms, p_ms, bound, single_ms = mrhs_timing[name]
        row[f"mrhs:{name}"] = {
            "nrhs": MULTI_SRC_N, "chunk": mrhs_default[kind], "ms": k_ms,
            "ms_by_chunk": mrhs_chunks[name], "plain_ms": p_ms,
            "bound_ms": bound, "share_of_bound": bound / k_ms,
            "single_rhs_launches_ms": single_ms,
            "amortisation": single_ms / k_ms,
            **(b5eo_resources(rows, geom_p.lattice_shape) if kind == "hop"
               else k_mrhs_resources(kind, "clover", rows,
                                     geom_p.lattice_shape))}
    row.update({
        "batched_cg_iter_ms": b_iter_ms, "batched_cg_iters_timed": b_n_timed,
        "batched_vs_single_cg_iters": b_iter_ms / (MULTI_SRC_N * iter_ms),
        "clover_batched_cg_iter_ms": cl_b_iter_ms,
        "clover_batched_cg_iters_timed": cl_b_n_timed,
        "clover_batched_vs_single_cg_iters":
            cl_b_iter_ms / (MULTI_SRC_N * cl_iter_ms),
        "multi_src_secs": {k: v[1] for k, v in multi.items()},
        "multi_src_iters": {k: v[0] for k, v in multi.items()}})
    row.update({
        "dslash_eo_ms": timing["full:f32->f32"][0],
        "dslash_eo_bound_no_l2_ms": b1_nol2_ms,
        "dslash_eo_GBps": 1e-6 * wpp.BYTES_PER_SITE * half
        / timing["full:f32->f32"][0],
        "cg_iter_ms": iter_ms, "cg_iter_secs": iter_ms / 1e3,
        "cg_iters_timed": n_timed, "main_path_iters": iters_main,
        "cg_reliable_half_iter_ms": {f: v[0] for f, v in mixed_ms.items()},
        "cg_reliable_half_iters_timed": {f: v[1]
                                         for f, v in mixed_ms.items()},
        "cg_reliable_half_reliable_updates": {
            f: v[2] for f, v in mixed_ms.items()},
        "mixed_solve_secs_per_iter": {f: v[1] / v[0]
                                      for f, v in mixed.items()},
        "clover_cg_iter_ms": cl_iter_ms, "clover_cg_iters_timed": cl_n_timed,
        "clover_cg_reliable_half_iter_ms": {
            f: v[0] for f, v in cl_mixed_ms.items()},
        "clover_cg_reliable_half_iters_timed": {
            f: v[1] for f, v in cl_mixed_ms.items()},
        "clover_cg_reliable_half_reliable_updates": {
            f: v[2] for f, v in cl_mixed_ms.items()},
        "clover_solve_secs_per_iter": {k: v[1] / v[0]
                                       for k, v in clover.items()}})
    emit(row)

    # which main path each kernel form's launches come from
    source_path = {"full:f32->f32": "default", "full:bf16->bf16": "mixed:full",
                   "full:bf16->f32": "mixed:full", "r12:f32->f32": "mixed:r12",
                   "r12:bf16->bf16": "mixed:r12",
                   "r12:bf16->f32": "mixed:r12"}
    rows_out = []
    for name in b1_names:
        n = launches[source_path[name]]["b1_by_form"].get(name, 0)
        k_ms, p_ms, bound = timing[name]
        rows_out.append({
            "name": f"dslash_eo_pallas_packed[{name}]", "route": "cuda",
            "source": "quda_tpu_torch/csrc/wilson_eo.cu",
            "replaces": "quda_tpu/ops/wilson_pallas_packed.py:1011",
            "launches": n, "max_abs_err": errs[name], "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": bound,
            "bound_by": bound_by[name], "library_ms": None})
    rows_out.append({
        "name": "cg_update_norm2_pallas", "route": "cuda",
        "source": "quda_tpu_torch/csrc/blas_fused.cu",
        "replaces": "quda_tpu/ops/blas_pallas.py:104",
        "launches": launches["default"]["b2"], "max_abs_err": errs["b2"],
        "ms": b2_ms, "plain_ms": b2_plain_ms, "bound_ms": b2_bound_ms,
        "bound_by": "bytes", "library_ms": None})
    for name, path in (("f32", "df64"), ("bf16", "mixed:full")):
        k_ms, p_ms, bound = timing[f"b3:{name}"]
        rows_out.append({
            "name": f"axpy_norm2_pallas[{name}]", "route": "cuda",
            "source": "quda_tpu_torch/csrc/blas_fused.cu",
            "replaces": "quda_tpu/ops/blas_pallas.py:151",
            "launches": launches[path]["b3_by_form"].get(name, 0),
            "max_abs_err": errs[f"b3:{name}"], "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": bound, "bound_by": "bytes",
            "library_ms": None})
    # the clover forms: f32 full from the single solve, bf16 full from the
    # half solve, and both r12 forms from the half r12 solve (its f32 r12
    # operator makes the reliable updates)
    for (kind, rows, store), name in zip(b7_forms, b7_names):
        path = ("clover:single" if store == f32 and rows == 3 else
                "clover:half" if rows == 3 else "clover:half:r12")
        k_ms, p_ms, bound = timing[name]
        rows_out.append({
            "name": f"{b7_wrapper[kind].__name__}[{name.split(':', 1)[1]}]",
            "route": "cuda", "source": "quda_tpu_torch/csrc/clover_eo.cu",
            "replaces": "quda_tpu/ops/clover_pallas.py:213",
            "launches": launches[path]["b7_by_form"].get(name, 0),
            "max_abs_err": errs[name], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": bound_by[name],
            "library_ms": None})
    # the multi-RHS forms: launches from the multi-source runs
    for (kind, rows), name in zip(mrhs_forms, mrhs_names):
        family = "wilson" if kind == "hop" else "clover"
        path = f"multi:{family}" + (":r12" if rows == 2 else "")
        k_ms, p_ms, bound, _ = mrhs_timing[name]
        rows_out.append({
            "name": f"{mrhs_wrapper[kind].__name__}"
                    f"[{name.split(':', 1)[1]}]",
            "route": "cuda",
            "source": ("quda_tpu_torch/csrc/wilson_eo_mrhs.cu"
                       if kind == "hop" else
                       "quda_tpu_torch/csrc/clover_eo_mrhs.cu"),
            "replaces": ("quda_tpu/ops/wilson_pallas_packed.py:613"
                         if kind == "hop" else
                         "quda_tpu/ops/clover_pallas.py:283"),
            "launches": launches[path]["mrhs_by_form"].get(name, 0),
            "max_abs_err": errs[f"mrhs:{name}"], "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": bound,
            "bound_by": bound_by[f"mrhs:{name}"], "library_ms": None,
            **({} if kind == "hop" else {"resources": k_mrhs_resources(
                kind, "clover", rows, geom_p.lattice_shape)})})
    rows_out.extend(precision(torch, dev, smi, gauge, src, srcs, half_ref,
                              df64_ref, multi["wilson:r12"][0]))
    rows_out.extend(operator_and_double(torch, dev, smi))
    rows_out.extend(operator_zoo_tune(torch, dev, smi))
    stag_rows, stag = staggered(torch, dev, smi)
    rows_out.extend(stag_rows)
    rows_out.extend(fold_v3(torch, dev, smi, gauge, src, srcs, stag))
    del stag
    rows_out.extend(mesh_path(torch, dev, smi, gauge, src, iters_main))
    rows_out.extend(zoo(torch, dev, smi))
    mg_rows, mg_gauge = multigrid(torch, dev, smi)
    rows_out.extend(mg_rows)
    rows_out.extend(staggered_mg(torch, dev, smi, mg_gauge))
    del mg_gauge
    unlaunched = [r["name"] for r in rows_out if r["launches"] < 1]
    if unlaunched:
        fail(f"kernels never launched on their main path: {unlaunched}")
    print(json.dumps({"kernels": rows_out}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
