// Even/odd staggered hops on the packed pair layout: the fused fat + Naik
// hop (kernel S1) and the one-hop-set gather pass (kernel S2); S1 on the
// folded layout (S1-fold) and S2 with the copy-free backward links (the
// v3 pass).
//
// S1 replaces quda_tpu/ops/staggered_pallas.py::_stag_fused_call, eo form
// (pallas_call at :966, reached through dslash_staggered_eo_pallas_fused;
// body _make_stag_kernel_fused and _accumulate_hopset).  Plain version:
// quda_tpu_torch/ops/staggered_pallas.py::dslash_staggered_eo_fused_plain.
//   out(x) = sum_mu sum_{n in 1,3} 1/2 [U^n_mu(x) psi(x + n mu)
//                                      - U^n_mu(x - n mu)^dag psi(x - n mu)]
// for the target-parity sites x, U^1 the fat and U^3 the long links.  The
// backward links are read unshifted from the opposite-parity arrays
// (fat_there, long_there) at the neighbour's index: both hop counts are
// odd, so both flip parity, and no backward copy exists.  The fat and Naik
// sets go into separate accumulators summed at the store, as the TPU
// kernel does.
//
// S2 replaces quda_tpu/ops/staggered_pallas.py::_stag_pass, eo form
// (pallas_call at :204, through dslash_staggered_eo_pallas; body
// _make_stag_kernel).  Plain version: ops/staggered_pallas.py::
// dslash_staggered_eo_pass_plain.  One hop set of count NHOP (1: fat,
// 3: Naik), with U_bw,mu(x) = U_mu(x - n mu) the pre-shifted backward links
// of backward_links_eo, built once per link load:
//   out(x) = sum_mu 1/2 [U_mu(x) psi(x + n mu) - U_bw,mu(x)^dag psi(x - n mu)]
//
// S1-fold replaces quda_tpu/ops/staggered_pallas.py::_stag_fused_fold_call,
// eo form (pallas_call at :1364, through
// dslash_staggered_eo_pallas_fused_fold; body _make_stag_kernel_fused_fold).
// Plain version: ops/staggered_pallas.py::dslash_staggered_eo_fused_fold_plain
// (S1's through from_fold / to_fold).  S1's function on to_fold of every
// operand: psi, out (3, T, 2Z, Y*Xh), links (4, 3, 3, T, 2Z, Y*Xh), row 2k
// of a (t, 2Z) plane the real parts of z = k and row 2k + 1 the imaginary
// ones.  Full links only (R = 3), the Naik links required, as in the JAX
// package.  The TPU kernel folds so that bf16 fills its (16, 128) tiles;
// here each component is still a plane of 2S elements and only a site's
// address changes (wilson_hop.cuh's FoldLayout), so S1-fold is S1's
// kernel, sum for sum, and equals S1 on the unfolded operands bit for bit.
//
// The v3 pass replaces quda_tpu/ops/staggered_pallas.py::_stag_pass_v3, eo
// form (pallas_call at :539, through dslash_staggered_eo_pallas_v3 at
// :618; body _make_stag_kernel_v3).  Plain version:
// ops/staggered_pallas.py::dslash_staggered_eo_pass_v3_plain (S2's on
// backward_links_eo(u_there)).  S2's pass with the backward links read
// unshifted from the opposite parity at the neighbour, as S1 reads them:
// no backward copy exists.  The improved v3 hop is the fat pass written
// in f32 and the Naik pass adding it (acc): out = fat + naik summed in f32
// and rounded once, S1's sum in S1's order, so bit for bit S1.
//
// Layout: psi, out (3, 2, T, Z, Y*Xh); links (4, 3, 3, 2, T, Z, Y*Xh).
// Forms (template arguments): psi and links both float32 or both bfloat16;
// out float32, or bfloat16 from bf16 storage.  Every load converts to f32,
// every sum is f32, and a bf16 out is rounded to nearest even once, at the
// store.  KS phases and the antiperiodic t boundary are in the links: no
// kernel applies a sign.
//
// What bounds them on an H100: device memory.  Per target half-site, S1
// reads four link sets (fat and long, here and there: 4 x 288 B) and psi
// (24 B) and writes out (24 B): 1200 B for 1146 flop in f32, about 1
// flop/B; S2 and the v3 pass read two link sets: 624 B for 570 flop (the
// accumulating Naik pass reads the f32 fat pass too).  Both are far under
// the ~20 flop/B where f32 arithmetic binds.
//
// Design: one thread per target half-site, three (S2) or six (S1) f32
// complex accumulators.  The thread computes each neighbour index directly
// (staggered_hop.cuh): an x hop by n moves to x' = (x +- n) mod X on the
// other parity, slot x'/2; a y, z or t hop keeps xh and moves its plane.
// The TPU kernel's z-block tiles, its 3-row boundary splices (_psi_z_rows,
// _u_z_rows) and its roll network have no counterpart: a CUDA thread just
// reads its neighbour.  The 16 neighbour spinors a site reads (8 per hop
// set) come through L1/L2: in device memory each psi plane is read about
// once.  Offsets are 64-bit.
#include "staggered_hop.cuh"

namespace {

using namespace qtt;

constexpr int kThreads = 128;

// Lay: PairLayout (S1) or FoldLayout (S1-fold)
template <typename S, typename O, typename Lay>
__global__ void __launch_bounds__(kThreads)
    stag_fused_kernel(O* __restrict__ out, const S* __restrict__ psi,
                      const S* __restrict__ fat_here,
                      const S* __restrict__ fat_there,
                      const S* __restrict__ long_here,
                      const S* __restrict__ long_there, int T, int Z, int Y,
                      int Xh, int parity) {
  const int64_t YXh = static_cast<int64_t>(Y) * Xh;
  const int64_t ZYXh = static_cast<int64_t>(Z) * YXh;
  const int64_t n = static_cast<int64_t>(T) * ZYXh;
  const int64_t site = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (site >= n) return;
  const Lay lay = make_layout<Lay>(YXh);
  const EoSite s = eo_site(site, Z, Y, Xh, YXh, ZYXh, parity, lay);

  float2 acc_fat[1][3], acc_lng[1][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    acc_fat[0][c] = make_float2(0.f, 0.f);
    acc_lng[0][c] = make_float2(0.f, 0.f);
  }
  stag_hopset<1>(acc_fat, psi, 0, 1, There<3, S>{fat_here, fat_there}, s,
                 T, Z, Y, Xh, YXh, ZYXh, n, lay);
  stag_hopset<3>(acc_lng, psi, 0, 1, There<3, S>{long_here, long_there}, s,
                 T, Z, Y, Xh, YXh, ZYXh, n, lay);
  float2 sum[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) sum[c] = cadd(acc_fat[0][c], acc_lng[0][c]);
  st_cvec(out, sum, n, s.site, lay.im(n));
}

// S2 (THERE false: u_bw the pre-shifted backward links, read at the target
// site) and the v3 pass (THERE true: u_bw the opposite parity's links,
// read unshifted at the backward neighbour).  With ACC the pass adds the
// float32 field acc_in (the fat pass) to its own sum before the store:
// acc_in + naik, the operand order of S1's sum.
template <typename S, typename O, int NHOP, bool THERE, bool ACC>
__global__ void __launch_bounds__(kThreads)
    stag_pass_kernel(O* __restrict__ out, const S* __restrict__ psi,
                     const S* __restrict__ u_here,
                     const S* __restrict__ u_bw,
                     const float* __restrict__ acc_in, int T, int Z, int Y,
                     int Xh, int parity) {
  const int64_t YXh = static_cast<int64_t>(Y) * Xh;
  const int64_t ZYXh = static_cast<int64_t>(Z) * YXh;
  const int64_t n = static_cast<int64_t>(T) * ZYXh;
  const int64_t site = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (site >= n) return;
  const EoSite s = eo_site(site, Z, Y, Xh, YXh, ZYXh, parity);

  float2 acc[1][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) acc[0][c] = make_float2(0.f, 0.f);
  if constexpr (THERE) {
    stag_hopset<NHOP>(acc, psi, 0, 1, There<3, S>{u_here, u_bw}, s, T, Z, Y,
                      Xh, YXh, ZYXh, n);
  } else {
    stag_hopset<NHOP>(acc, psi, 0, 1, Shifted<3, S>{u_here, u_bw}, s, T, Z,
                      Y, Xh, YXh, ZYXh, n);
  }
  if constexpr (ACC) {
    // one rounded add each, never contracted (as S2-mrhs accumulates)
    float2 prev[3];
    ld_cvec(prev, acc_in, n, site, n);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      acc[0][c] = make_float2(__fadd_rn(prev[c].x, acc[0][c].x),
                              __fadd_rn(prev[c].y, acc[0][c].y));
    }
  }
  st_cvec(out, acc[0], n, site);
}

// grid size, or -1 for arguments the kernels do not take
int64_t grid_blocks(int T, int Z, int Y, int Xh, int parity, int store_bf16,
                    int out_bf16) {
  const int64_t n = static_cast<int64_t>(T) * Z * Y * Xh;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (n <= 0 || blocks > 0x7fffffff || (parity != 0 && parity != 1) ||
      (out_bf16 && !store_bf16)) {
    return -1;
  }
  return blocks;
}

template <typename S, typename O, typename Lay>
cudaError_t launch_fused(void* out, const void* psi, const void* fh,
                         const void* ft, const void* lh, const void* lt,
                         int T, int Z, int Y, int Xh, int parity,
                         unsigned blocks, cudaStream_t stream) {
  stag_fused_kernel<S, O, Lay><<<blocks, kThreads, 0, stream>>>(
      static_cast<O*>(out), static_cast<const S*>(psi),
      static_cast<const S*>(fh), static_cast<const S*>(ft),
      static_cast<const S*>(lh), static_cast<const S*>(lt), T, Z, Y, Xh,
      parity);
  return cudaGetLastError();
}

template <typename S, typename O, int NHOP, bool THERE, bool ACC>
void launch_pass_as(void* out, const void* psi, const void* uh,
                    const void* ub, const void* acc, int T, int Z, int Y,
                    int Xh, int parity, unsigned blocks,
                    cudaStream_t stream) {
  stag_pass_kernel<S, O, NHOP, THERE, ACC><<<blocks, kThreads, 0, stream>>>(
      static_cast<O*>(out), static_cast<const S*>(psi),
      static_cast<const S*>(uh), static_cast<const S*>(ub),
      static_cast<const float*>(acc), T, Z, Y, Xh, parity);
}

// S2 (there false) or the v3 pass (there true); acc (the v3 Naik pass
// only) non-null for the accumulating instance
template <typename S, typename O>
cudaError_t launch_pass(void* out, const void* psi, const void* uh,
                        const void* ub, const void* acc, bool there,
                        int T, int Z, int Y, int Xh, int parity, int nhop,
                        unsigned blocks, cudaStream_t stream) {
  if (!there) {
    if (nhop == 1) {
      launch_pass_as<S, O, 1, false, false>(out, psi, uh, ub, acc, T, Z, Y,
                                            Xh, parity, blocks, stream);
    } else {
      launch_pass_as<S, O, 3, false, false>(out, psi, uh, ub, acc, T, Z, Y,
                                            Xh, parity, blocks, stream);
    }
  } else if (nhop == 1) {
    launch_pass_as<S, O, 1, true, false>(out, psi, uh, ub, acc, T, Z, Y, Xh,
                                         parity, blocks, stream);
  } else if (acc == nullptr) {
    launch_pass_as<S, O, 3, true, false>(out, psi, uh, ub, acc, T, Z, Y, Xh,
                                         parity, blocks, stream);
  } else {
    launch_pass_as<S, O, 3, true, true>(out, psi, uh, ub, acc, T, Z, Y, Xh,
                                        parity, blocks, stream);
  }
  return cudaGetLastError();
}

template <typename Lay>
int fused_entry(void* out, const void* psi, const void* fat_here,
                const void* fat_there, const void* long_here,
                const void* long_there, int T, int Z, int Y, int Xh,
                int parity, int store_bf16, int out_bf16, void* stream) {
  const int64_t blocks = grid_blocks(T, Z, Y, Xh, parity, store_bf16,
                                     out_bf16);
  if (blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned nb = static_cast<unsigned>(blocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  cudaError_t err;
  if (!store_bf16) {
    err = launch_fused<float, float, Lay>(out, psi, fat_here, fat_there,
                                          long_here, long_there, T, Z, Y, Xh,
                                          parity, nb, s);
  } else if (out_bf16) {
    err = launch_fused<bf, bf, Lay>(out, psi, fat_here, fat_there,
                                    long_here, long_there, T, Z, Y, Xh,
                                    parity, nb, s);
  } else {
    err = launch_fused<bf, float, Lay>(out, psi, fat_here, fat_there,
                                       long_here, long_there, T, Z, Y, Xh,
                                       parity, nb, s);
  }
  return static_cast<int>(err);
}

int pass_entry(void* out, const void* psi, const void* u_here,
               const void* u_bw, const void* acc, bool there, int T, int Z,
               int Y, int Xh, int parity, int nhop, int store_bf16,
               int out_bf16, void* stream) {
  const int64_t blocks = grid_blocks(T, Z, Y, Xh, parity, store_bf16,
                                     out_bf16);
  if (blocks < 0 || (nhop != 1 && nhop != 3) ||
      (acc != nullptr && !(there && nhop == 3))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned nb = static_cast<unsigned>(blocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  cudaError_t err;
  if (!store_bf16) {
    err = launch_pass<float, float>(out, psi, u_here, u_bw, acc, there, T,
                                    Z, Y, Xh, parity, nhop, nb, s);
  } else if (out_bf16) {
    err = launch_pass<bf, bf>(out, psi, u_here, u_bw, acc, there, T, Z, Y,
                              Xh, parity, nhop, nb, s);
  } else {
    err = launch_pass<bf, float>(out, psi, u_here, u_bw, acc, there, T, Z,
                                 Y, Xh, parity, nhop, nb, s);
  }
  return static_cast<int>(err);
}

}  // namespace

// S1.  store_bf16: psi and the four link arrays are bfloat16 (else
// float32); out_bf16: out is bfloat16 (else float32; bf16 out needs bf16
// storage).
extern "C" int qtt_staggered_eo_fused(void* out, const void* psi,
                                      const void* fat_here,
                                      const void* fat_there,
                                      const void* long_here,
                                      const void* long_there, int T, int Z,
                                      int Y, int Xh, int parity,
                                      int store_bf16, int out_bf16,
                                      void* stream) {
  return fused_entry<PairLayout>(out, psi, fat_here, fat_there, long_here,
                                 long_there, T, Z, Y, Xh, parity, store_bf16,
                                 out_bf16, stream);
}

// S1-fold: S1's arguments, every array folded (to_fold).
extern "C" int qtt_staggered_eo_fused_fold(void* out, const void* psi,
                                           const void* fat_here,
                                           const void* fat_there,
                                           const void* long_here,
                                           const void* long_there, int T,
                                           int Z, int Y, int Xh, int parity,
                                           int store_bf16, int out_bf16,
                                           void* stream) {
  return fused_entry<FoldLayout>(out, psi, fat_here, fat_there, long_here,
                                 long_there, T, Z, Y, Xh, parity, store_bf16,
                                 out_bf16, stream);
}

// S2.  nhop: 1 (fat) or 3 (Naik); storage and output as for S1.
extern "C" int qtt_staggered_eo_pass(void* out, const void* psi,
                                     const void* u_here, const void* u_bw,
                                     int T, int Z, int Y, int Xh, int parity,
                                     int nhop, int store_bf16, int out_bf16,
                                     void* stream) {
  return pass_entry(out, psi, u_here, u_bw, nullptr, false, T, Z, Y, Xh,
                    parity, nhop, store_bf16, out_bf16, stream);
}

// The v3 pass: S2's arguments with u_there (the opposite parity's links,
// unshifted) in place of u_bw; acc null, or (nhop 3 only) a float32 field
// of psi's shape that the pass adds before its store.
extern "C" int qtt_staggered_eo_pass_v3(void* out, const void* psi,
                                        const void* u_here,
                                        const void* u_there, const void* acc,
                                        int T, int Z, int Y, int Xh,
                                        int parity, int nhop, int store_bf16,
                                        int out_bf16, void* stream) {
  return pass_entry(out, psi, u_here, u_there, acc, true, T, Z, Y, Xh,
                    parity, nhop, store_bf16, out_bf16, stream);
}
