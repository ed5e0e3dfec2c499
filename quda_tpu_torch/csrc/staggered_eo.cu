// Even/odd staggered hops on the packed pair layout: the fused fat + Naik
// hop (kernel S1) and the one-hop-set gather pass (kernel S2).
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
// flop/B; S2 reads two link sets: 624 B for 570 flop.  Both are far under
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

template <typename S, typename O>
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
  const EoSite s = eo_site(site, Z, Y, Xh, YXh, ZYXh, parity);

  float2 acc_fat[1][3], acc_lng[1][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    acc_fat[0][c] = make_float2(0.f, 0.f);
    acc_lng[0][c] = make_float2(0.f, 0.f);
  }
  stag_hopset<1>(acc_fat, psi, 0, 1, fat_here, fat_there, true, s, T, Z, Y,
                 Xh, YXh, ZYXh, n);
  stag_hopset<3>(acc_lng, psi, 0, 1, long_here, long_there, true, s, T, Z,
                 Y, Xh, YXh, ZYXh, n);
  float2 sum[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) sum[c] = cadd(acc_fat[0][c], acc_lng[0][c]);
  st_cvec(out, sum, n, site);
}

template <typename S, typename O, int NHOP>
__global__ void __launch_bounds__(kThreads)
    stag_pass_kernel(O* __restrict__ out, const S* __restrict__ psi,
                     const S* __restrict__ u_here,
                     const S* __restrict__ u_bw, int T, int Z, int Y, int Xh,
                     int parity) {
  const int64_t YXh = static_cast<int64_t>(Y) * Xh;
  const int64_t ZYXh = static_cast<int64_t>(Z) * YXh;
  const int64_t n = static_cast<int64_t>(T) * ZYXh;
  const int64_t site = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (site >= n) return;
  const EoSite s = eo_site(site, Z, Y, Xh, YXh, ZYXh, parity);

  float2 acc[1][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) acc[0][c] = make_float2(0.f, 0.f);
  stag_hopset<NHOP>(acc, psi, 0, 1, u_here, u_bw, false, s, T, Z, Y, Xh,
                    YXh, ZYXh, n);
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

template <typename S, typename O>
cudaError_t launch_fused(void* out, const void* psi, const void* fh,
                         const void* ft, const void* lh, const void* lt,
                         int T, int Z, int Y, int Xh, int parity,
                         unsigned blocks, cudaStream_t stream) {
  stag_fused_kernel<S, O><<<blocks, kThreads, 0, stream>>>(
      static_cast<O*>(out), static_cast<const S*>(psi),
      static_cast<const S*>(fh), static_cast<const S*>(ft),
      static_cast<const S*>(lh), static_cast<const S*>(lt), T, Z, Y, Xh,
      parity);
  return cudaGetLastError();
}

template <typename S, typename O>
cudaError_t launch_pass(void* out, const void* psi, const void* uh,
                        const void* ub, int T, int Z, int Y, int Xh,
                        int parity, int nhop, unsigned blocks,
                        cudaStream_t stream) {
  if (nhop == 1) {
    stag_pass_kernel<S, O, 1><<<blocks, kThreads, 0, stream>>>(
        static_cast<O*>(out), static_cast<const S*>(psi),
        static_cast<const S*>(uh), static_cast<const S*>(ub), T, Z, Y, Xh,
        parity);
  } else {
    stag_pass_kernel<S, O, 3><<<blocks, kThreads, 0, stream>>>(
        static_cast<O*>(out), static_cast<const S*>(psi),
        static_cast<const S*>(uh), static_cast<const S*>(ub), T, Z, Y, Xh,
        parity);
  }
  return cudaGetLastError();
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
  const int64_t blocks = grid_blocks(T, Z, Y, Xh, parity, store_bf16,
                                     out_bf16);
  if (blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned nb = static_cast<unsigned>(blocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  cudaError_t err;
  if (!store_bf16) {
    err = launch_fused<float, float>(out, psi, fat_here, fat_there,
                                     long_here, long_there, T, Z, Y, Xh,
                                     parity, nb, s);
  } else if (out_bf16) {
    err = launch_fused<bf, bf>(out, psi, fat_here, fat_there, long_here,
                               long_there, T, Z, Y, Xh, parity, nb, s);
  } else {
    err = launch_fused<bf, float>(out, psi, fat_here, fat_there, long_here,
                                  long_there, T, Z, Y, Xh, parity, nb, s);
  }
  return static_cast<int>(err);
}

// S2.  nhop: 1 (fat) or 3 (Naik); storage and output as for S1.
extern "C" int qtt_staggered_eo_pass(void* out, const void* psi,
                                     const void* u_here, const void* u_bw,
                                     int T, int Z, int Y, int Xh, int parity,
                                     int nhop, int store_bf16, int out_bf16,
                                     void* stream) {
  const int64_t blocks = grid_blocks(T, Z, Y, Xh, parity, store_bf16,
                                     out_bf16);
  if (blocks < 0 || (nhop != 1 && nhop != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned nb = static_cast<unsigned>(blocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  cudaError_t err;
  if (!store_bf16) {
    err = launch_pass<float, float>(out, psi, u_here, u_bw, T, Z, Y, Xh,
                                    parity, nhop, nb, s);
  } else if (out_bf16) {
    err = launch_pass<bf, bf>(out, psi, u_here, u_bw, T, Z, Y, Xh, parity,
                              nhop, nb, s);
  } else {
    err = launch_pass<bf, float>(out, psi, u_here, u_bw, T, Z, Y, Xh,
                                 parity, nhop, nb, s);
  }
  return static_cast<int>(err);
}
