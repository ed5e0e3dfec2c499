// Multi-RHS even/odd staggered gather pass on the packed pair layout
// (kernel S2-mrhs): the one-hop-set pass of S2 (staggered_eo.cu) over N
// right-hand sides, each link loaded once for a chunk of them.
//
// Replaces: quda_tpu/ops/staggered_pallas.py::_stag_pass_mrhs, the Pallas
// TPU kernel (pallas_call at :1106; S2's body _make_stag_kernel under
// _mrhs_wrap, on a (T, nzb, N) grid whose link index maps ignore n),
// reached through dslash_staggered_eo_pallas_mrhs (:1155).  Plain version:
// quda_tpu_torch/ops/staggered_pallas.py::dslash_staggered_eo_pass_mrhs_plain.
//   out_r(x) = sum_mu 1/2 [U_mu(x) psi_r(x + n mu) - U_bw,mu(x)^dag
//                          psi_r(x - n mu)]
// for each right-hand side r, hop count NHOP (1: fat, 3: Naik), with
// U_bw,mu(x) = U_mu(x - n mu) the pre-shifted backward links of
// backward_links_eo.  With ACCUM the pass adds its sum into out at the
// store (out_r += pass_r): the improved operator runs the fat pass, then
// the Naik pass accumulating, and since the fat pass's f32 output plus the
// Naik sum is one IEEE addition, the result is the JAX function's
// fat + naik bit for bit (and S1's cadd(acc_fat, acc_lng) at the store).
//
// Layout: psi, out (N, 3, 2, T, Z, Y*Xh), right-hand sides 6 * S elements
// apart (S = T*Z*Y*Xh half-sites); links (4, 3, 3, 2, T, Z, Y*Xh).  All
// float32, full (R = 3) links: the JAX batched staggered route builds its
// operator in float32, and recon-12 staggered links are refused.
//
// What bounds it on an H100: device memory.  Per target half-site and
// pass, N spinors in and out (48 N bytes, when L1/L2 serve the neighbour
// re-reads) and two link sets once (576 B); with ACCUM out is read too
// (+24 N).  570 N flop against (48 N + 576) B is under 12 flop/B, far
// below the ~20 flop/B where f32 arithmetic binds.  At N = 12 the floor
// is 1152 B a half-site, against 7488 B for twelve S2 launches.
//
// Design: one thread per target half-site and chunk of kNB = 4
// right-hand sides (a tail chunk reads and writes only the sides that
// exist).  For each of the 16 hops the thread loads the link once and
// applies it to the kNB colour vectors: stag_hopset<N, NB> of
// staggered_hop.cuh, the hop S1 and S2 run with NB = 1, so each
// right-hand side sees S2's arithmetic in S2's order.  A lane needs only 3
// complex accumulators (6 NB floats): at NB = 4 ptxas gives 96 registers
// and no spills, and the card ran NB = 4 fastest of 1, 2, 4 and 8 at N =
// 12 (PERF.md).  The chunk index varies fastest across the grid, so the
// blocks that serve one site block's chunks run side by side and share
// its links through L2.  Offsets are 64-bit.
#include "staggered_hop.cuh"

namespace {

using namespace qtt;

constexpr int kThreads = 128;
constexpr int kNB = 4;

template <int NHOP, bool ACCUM>
__global__ void __launch_bounds__(kThreads)
    stag_pass_mrhs_kernel(float* __restrict__ out,
                          const float* __restrict__ psi,
                          const float* __restrict__ u_here,
                          const float* __restrict__ u_bw, int T, int Z,
                          int Y, int Xh, int parity, int nrhs,
                          int nchunks) {
  const int64_t YXh = static_cast<int64_t>(Y) * Xh;
  const int64_t ZYXh = static_cast<int64_t>(Z) * YXh;
  const int64_t n = static_cast<int64_t>(T) * ZYXh;
  const int64_t b = blockIdx.x;
  const int chunk = static_cast<int>(b % nchunks);
  const int64_t site = (b / nchunks) * kThreads + threadIdx.x;
  if (site >= n) return;
  const EoSite s = eo_site(site, Z, Y, Xh, YXh, ZYXh, parity);
  const int r0 = chunk * kNB;
  const int nvalid = min(kNB, nrhs - r0);
  const int64_t rstride = 6 * n;

  float2 acc[kNB][3];
#pragma unroll
  for (int r = 0; r < kNB; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[r][c] = make_float2(0.f, 0.f);
  stag_hopset<NHOP>(acc, psi + r0 * rstride, rstride, nvalid,
                    Shifted<3, float>{u_here, u_bw}, s, T, Z, Y, Xh, YXh,
                    ZYXh, n);

#pragma unroll
  for (int r = 0; r < kNB; ++r) {
    if (kNB > 1 && r >= nvalid) break;
    float* o = out + (r0 + r) * rstride;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float* q = o + static_cast<int64_t>(2 * c) * n + site;
      if (ACCUM) {
        q[0] = __fadd_rn(q[0], acc[r][c].x);
        q[n] = __fadd_rn(q[n], acc[r][c].y);
      } else {
        q[0] = acc[r][c].x;
        q[n] = acc[r][c].y;
      }
    }
  }
}

template <int NHOP, bool ACCUM>
cudaError_t launch(void* out, const void* psi, const void* u_here,
                   const void* u_bw, int T, int Z, int Y, int Xh,
                   int parity, int nrhs, int nchunks, unsigned blocks,
                   cudaStream_t stream) {
  stag_pass_mrhs_kernel<NHOP, ACCUM><<<blocks, kThreads, 0, stream>>>(
      static_cast<float*>(out), static_cast<const float*>(psi),
      static_cast<const float*>(u_here), static_cast<const float*>(u_bw), T,
      Z, Y, Xh, parity, nrhs, nchunks);
  return cudaGetLastError();
}

}  // namespace

// All float32.  nhop: 1 (fat) or 3 (Naik); accum: add into out (else
// overwrite it); nrhs: the batch's right-hand sides, run in chunks of
// kNB = 4.  A grid of more than 2^31 - 1 blocks is refused.
extern "C" int qtt_staggered_eo_pass_mrhs(void* out, const void* psi,
                                          const void* u_here,
                                          const void* u_bw, int T, int Z,
                                          int Y, int Xh, int parity,
                                          int nhop, int accum, int nrhs,
                                          void* stream) {
  const int64_t n = static_cast<int64_t>(T) * Z * Y * Xh;
  if (n <= 0 || nrhs <= 0 || (parity != 0 && parity != 1) ||
      (nhop != 1 && nhop != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t nchunks = (nrhs + kNB - 1) / kNB;
  const int64_t blocks = (n + kThreads - 1) / kThreads * nchunks;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned nblk = static_cast<unsigned>(blocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nc = static_cast<int>(nchunks);
  cudaError_t err;
  if (nhop == 1) {
    err = accum ? launch<1, true>(out, psi, u_here, u_bw, T, Z, Y, Xh,
                                  parity, nrhs, nc, nblk, s)
                : launch<1, false>(out, psi, u_here, u_bw, T, Z, Y, Xh,
                                   parity, nrhs, nc, nblk, s);
  } else {
    err = accum ? launch<3, true>(out, psi, u_here, u_bw, T, Z, Y, Xh,
                                  parity, nrhs, nc, nblk, s)
                : launch<3, false>(out, psi, u_here, u_bw, T, Z, Y, Xh,
                                   parity, nrhs, nc, nblk, s);
  }
  return static_cast<int>(err);
}
