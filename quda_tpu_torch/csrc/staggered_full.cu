// Full-lattice staggered hops on the packed pair layout: the gather pass
// (kernel S2-full), its multi-RHS form (S2-mrhs-full) and the fused fat +
// Naik hop (S1-full).  They are the full-lattice forms of the even/odd
// kernels of staggered_eo.cu and staggered_eo_mrhs.cu, on the same hop
// body (staggered_hop.cuh) with the full-lattice site rule (full_site,
// FullSite), so every lane and every form keeps the eo forms' arithmetic
// in their order.
//
// S2-full replaces quda_tpu/ops/staggered_pallas.py::_stag_pass, full
// lattice (pallas_call at :204, through dslash_staggered_pallas at :219;
// body _make_stag_kernel with eo None).  Plain version:
// quda_tpu_torch/ops/staggered_pallas.py::dslash_staggered_pass_plain.
// One hop set of count NHOP (1: fat, 3: Naik), with U_bw,mu(x) =
// U_mu(x - n mu) the pre-shifted backward links of backward_links:
//   out(x) = sum_mu 1/2 [U_mu(x) psi(x + n mu) - U_bw,mu(x)^dag psi(x - n mu)]
//
// S2-mrhs-full replaces _stag_pass_mrhs, full lattice (pallas_call at
// :1106, through dslash_staggered_pallas_mrhs at :1121).  Plain version:
// ops/staggered_pallas.py::dslash_staggered_pass_mrhs_plain.  The pass
// above over N right-hand sides, each link loaded once for a chunk of kNB
// = 4 of them; with ACCUM it adds into out at the store (the improved
// operator's Naik pass on top of the fat pass: one IEEE addition, so fat +
// naik equals S1-full's sum bit for bit).
//
// S1-full replaces _stag_fused_call, full lattice (pallas_call at :966,
// through dslash_staggered_pallas_fused at :980; body
// _make_stag_kernel_fused).  Plain version:
// ops/staggered_pallas.py::dslash_staggered_fused_plain.
//   out(x) = sum_mu sum_{n in 1,3} 1/2 [U^n_mu(x) psi(x + n mu)
//                                      - U^n_mu(x - n mu)^dag psi(x - n mu)]
// with U^1 the fat and U^3 the long links.  The backward links are read
// unshifted at the backward neighbour's index of the same arrays: no
// backward copy exists.  The fat and Naik sets go into separate
// accumulators summed at the store, as the TPU kernel and S1 do.
//
// Layout: psi, out (3, 2, T, Z, Y*X), N of them (N, 3, 2, T, Z, Y*X) for
// the multi-RHS form; links (4, 3, 3, 2, T, Z, Y*X), KS phases and the
// antiperiodic t boundary folded in (the long links' on the last three t
// planes), so no kernel applies a sign.  All float32, full (18-real)
// links: the multigrid and the operator API build them so, and recon-12
// staggered links are refused (ROADMAP C).
//
// What bounds them on an H100: device memory.  Per site S2-full reads
// two link sets (576 B) and psi (24 B) and writes out (24 B): 624 B for
// 570 flop; S1-full reads each link set once (fat and long, 576 B): 624
// B for 1146 flop; S2-mrhs-full 48 N + 576 B for 570 N flop (an
// accumulating pass reads out too, + 24 N).  All are under 2 flop/B, far
// below the ~20 flop/B where f32 arithmetic binds.  At 32^3 x 64 the
// S2-full and S1-full floors are 0.391 ms, S2-mrhs-full at N = 24 1.082
// ms.
//
// Design: the eo kernels', on the full lattice.  One thread per site (S2,
// S1) or per site and chunk of kNB right-hand sides (S2-mrhs, the chunk
// index fastest across the grid, so the blocks that share a site block's
// links run side by side); three or six f32 complex accumulators per
// right-hand side.  Each thread computes its neighbour indices directly
// (site_neighbour): an x hop wraps inside its row of X sites of the fused
// Y*X axis, never into the next y; y, z and t move their own plane.  The
// TPU kernel's z-block tiles, boundary-row splices and roll network have
// no counterpart.  Neighbour spinors come through L1/L2.  Offsets are
// 64-bit.  Simple and correct first: shared neighbour tiles and TMA are
// later work.
#include "staggered_hop.cuh"

namespace {

using namespace qtt;

constexpr int kThreads = 128;
constexpr int kNB = 4;

struct FullDims {
  int T, Z, Y, X;
  int64_t YX, ZYX, n;
};

__device__ __forceinline__ FullDims full_dims(int T, int Z, int Y, int X) {
  FullDims d;
  d.T = T;
  d.Z = Z;
  d.Y = Y;
  d.X = X;
  d.YX = static_cast<int64_t>(Y) * X;
  d.ZYX = static_cast<int64_t>(Z) * d.YX;
  d.n = static_cast<int64_t>(T) * d.ZYX;
  return d;
}

template <int NHOP>
__global__ void __launch_bounds__(kThreads)
    stag_full_pass_kernel(float* __restrict__ out,
                          const float* __restrict__ psi,
                          const float* __restrict__ u,
                          const float* __restrict__ u_bw, int T, int Z,
                          int Y, int X) {
  const FullDims d = full_dims(T, Z, Y, X);
  const int64_t site = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (site >= d.n) return;
  const FullSite s = full_site(site, Z, Y, X, d.YX, d.ZYX);

  float2 acc[1][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) acc[0][c] = make_float2(0.f, 0.f);
  stag_hopset<NHOP>(acc, psi, 0, 1, u, u_bw, false, s, T, Z, Y, X, d.YX,
                    d.ZYX, d.n);
  st_cvec(out, acc[0], d.n, site);
}

__global__ void __launch_bounds__(kThreads)
    stag_full_fused_kernel(float* __restrict__ out,
                           const float* __restrict__ psi,
                           const float* __restrict__ fat,
                           const float* __restrict__ lng, int T, int Z,
                           int Y, int X) {
  const FullDims d = full_dims(T, Z, Y, X);
  const int64_t site = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (site >= d.n) return;
  const FullSite s = full_site(site, Z, Y, X, d.YX, d.ZYX);

  float2 acc_fat[1][3], acc_lng[1][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    acc_fat[0][c] = make_float2(0.f, 0.f);
    acc_lng[0][c] = make_float2(0.f, 0.f);
  }
  stag_hopset<1>(acc_fat, psi, 0, 1, fat, fat, true, s, T, Z, Y, X, d.YX,
                 d.ZYX, d.n);
  stag_hopset<3>(acc_lng, psi, 0, 1, lng, lng, true, s, T, Z, Y, X, d.YX,
                 d.ZYX, d.n);
  float2 sum[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) sum[c] = cadd(acc_fat[0][c], acc_lng[0][c]);
  st_cvec(out, sum, d.n, site);
}

template <int NHOP, bool ACCUM>
__global__ void __launch_bounds__(kThreads)
    stag_full_pass_mrhs_kernel(float* __restrict__ out,
                               const float* __restrict__ psi,
                               const float* __restrict__ u,
                               const float* __restrict__ u_bw, int T, int Z,
                               int Y, int X, int nrhs, int nchunks) {
  const FullDims d = full_dims(T, Z, Y, X);
  const int64_t b = blockIdx.x;
  const int chunk = static_cast<int>(b % nchunks);
  const int64_t site = (b / nchunks) * kThreads + threadIdx.x;
  if (site >= d.n) return;
  const FullSite s = full_site(site, Z, Y, X, d.YX, d.ZYX);
  const int r0 = chunk * kNB;
  const int nvalid = min(kNB, nrhs - r0);
  const int64_t rstride = 6 * d.n;

  float2 acc[kNB][3];
#pragma unroll
  for (int r = 0; r < kNB; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[r][c] = make_float2(0.f, 0.f);
  stag_hopset<NHOP>(acc, psi + r0 * rstride, rstride, nvalid, u, u_bw, false,
                    s, T, Z, Y, X, d.YX, d.ZYX, d.n);

#pragma unroll
  for (int r = 0; r < kNB; ++r) {
    if (r >= nvalid) break;
    float* o = out + (r0 + r) * rstride;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float* q = o + static_cast<int64_t>(2 * c) * d.n + site;
      if (ACCUM) {
        q[0] = __fadd_rn(q[0], acc[r][c].x);
        q[d.n] = __fadd_rn(q[d.n], acc[r][c].y);
      } else {
        q[0] = acc[r][c].x;
        q[d.n] = acc[r][c].y;
      }
    }
  }
}

// grid blocks for n sites (times nchunks), or -1 for arguments the
// kernels do not take
int64_t grid_blocks(int T, int Z, int Y, int X, int64_t nchunks) {
  const int64_t n = static_cast<int64_t>(T) * Z * Y * X;
  if (T <= 0 || Z <= 0 || Y <= 0 || X <= 0 || nchunks <= 0) return -1;
  const int64_t blocks = (n + kThreads - 1) / kThreads * nchunks;
  return blocks > 0x7fffffff ? -1 : blocks;
}

template <int NHOP, bool ACCUM>
cudaError_t launch_mrhs(void* out, const void* psi, const void* u,
                        const void* u_bw, int T, int Z, int Y, int X,
                        int nrhs, int nchunks, unsigned blocks,
                        cudaStream_t stream) {
  stag_full_pass_mrhs_kernel<NHOP, ACCUM><<<blocks, kThreads, 0, stream>>>(
      static_cast<float*>(out), static_cast<const float*>(psi),
      static_cast<const float*>(u), static_cast<const float*>(u_bw), T, Z, Y,
      X, nrhs, nchunks);
  return cudaGetLastError();
}

}  // namespace

// S2-full.  nhop: 1 (fat) or 3 (Naik); all float32.
extern "C" int qtt_staggered_full_pass(void* out, const void* psi,
                                       const void* u, const void* u_bw,
                                       int T, int Z, int Y, int X, int nhop,
                                       void* stream) {
  const int64_t blocks = grid_blocks(T, Z, Y, X, 1);
  if (blocks < 0 || (nhop != 1 && nhop != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned nb = static_cast<unsigned>(blocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nhop == 1) {
    stag_full_pass_kernel<1><<<nb, kThreads, 0, s>>>(
        static_cast<float*>(out), static_cast<const float*>(psi),
        static_cast<const float*>(u), static_cast<const float*>(u_bw), T, Z,
        Y, X);
  } else {
    stag_full_pass_kernel<3><<<nb, kThreads, 0, s>>>(
        static_cast<float*>(out), static_cast<const float*>(psi),
        static_cast<const float*>(u), static_cast<const float*>(u_bw), T, Z,
        Y, X);
  }
  return static_cast<int>(cudaGetLastError());
}

// S1-full: fat and long links unshifted; all float32.
extern "C" int qtt_staggered_full_fused(void* out, const void* psi,
                                        const void* fat, const void* lng,
                                        int T, int Z, int Y, int X,
                                        void* stream) {
  const int64_t blocks = grid_blocks(T, Z, Y, X, 1);
  if (blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  stag_full_fused_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), static_cast<const float*>(psi),
      static_cast<const float*>(fat), static_cast<const float*>(lng), T, Z,
      Y, X);
  return static_cast<int>(cudaGetLastError());
}

// S2-mrhs-full.  nhop: 1 or 3; accum: add into out (else overwrite it);
// nrhs right-hand sides in chunks of kNB = 4; all float32.
extern "C" int qtt_staggered_full_pass_mrhs(void* out, const void* psi,
                                            const void* u, const void* u_bw,
                                            int T, int Z, int Y, int X,
                                            int nhop, int accum, int nrhs,
                                            void* stream) {
  if (nrhs <= 0 || (nhop != 1 && nhop != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t nchunks = (nrhs + kNB - 1) / kNB;
  const int64_t blocks = grid_blocks(T, Z, Y, X, nchunks);
  if (blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned nblk = static_cast<unsigned>(blocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nc = static_cast<int>(nchunks);
  cudaError_t err;
  if (nhop == 1) {
    err = accum ? launch_mrhs<1, true>(out, psi, u, u_bw, T, Z, Y, X, nrhs,
                                       nc, nblk, s)
                : launch_mrhs<1, false>(out, psi, u, u_bw, T, Z, Y, X, nrhs,
                                        nc, nblk, s);
  } else {
    err = accum ? launch_mrhs<3, true>(out, psi, u, u_bw, T, Z, Y, X, nrhs,
                                       nc, nblk, s)
                : launch_mrhs<3, false>(out, psi, u, u_bw, T, Z, Y, X, nrhs,
                                        nc, nblk, s);
  }
  return static_cast<int>(err);
}
