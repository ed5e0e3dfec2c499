// Multi-RHS even/odd Wilson hop D_{p <- 1-p} on the packed pair layout
// (kernel B5-eo): the hop of B1 (wilson_eo.cu) over N right-hand sides,
// each link loaded once for several of them.
//
// Replaces: quda_tpu/ops/wilson_pallas_packed.py::
// dslash_eo_pallas_packed_mrhs, the Pallas TPU kernel (pallas_call at :613;
// B1's body _make_kernel(eo=...) under _mrhs_wrap, :504, on a (T, nzb, N)
// grid whose gauge index maps ignore n).  Plain version:
// quda_tpu_torch/ops/wilson_pallas_packed.py::dslash_eo_packed_mrhs_plain.
//
// Layout: psi, out (N, 4, 3, 2, T, Z, Y*Xh), right-hand sides 24 * S
// elements apart (S = T*Z*Y*Xh half-sites); links as in wilson_hop.cuh.
// Storage forms: float32 psi, links and out; R = 3 link rows (full) or
// R = 2 (reconstruct-12, with tb_sign as in B1).  Sums are f32.
//
// What bounds it on an H100: device memory.  Per target half-site, N
// spinors in and out (192 N bytes in f32, when L2 serves the neighbour
// re-reads) and the links once (576 B, or 384 with R = 2): at N = 12 a
// third of what 12 launches of B1 move.  1320 N flop against
// (192 N + 576) B is at most 6.9 flop/B, far under the ~20 flop/B where f32
// arithmetic binds.
//
// Design: one thread per target half-site and chunk of NB right-hand
// sides (NB a compile-time 1 or 2; a tail chunk reads and writes only
// the sides that exist).  For each of the 8 directions the thread loads
// the link once (rebuilding row 2 once with R = 2) and applies it to the
// NB projected half spinors: eo_hop_sum<R, NB> of wilson_hop.cuh, the hop
// B1 and the fused clover hop run with NB = 1, so each right-hand side
// sees B1's arithmetic in B1's order.  24 NB f32 accumulators live in
// registers.  The chunk index varies fastest across the grid: the blocks
// that serve the chunks of one site block run side by side, so the links
// that the first of them loads are still in L2 when the others read them.
// Offsets are 64-bit (a 12-RHS batch at 32^3 x 64 is 302 M elements).
#include "wilson_hop.cuh"

namespace {

using namespace qtt;

constexpr int kThreads = 128;

template <int R, int NB>
__global__ void __launch_bounds__(kThreads)
    wilson_eo_mrhs_kernel(float* __restrict__ out,
                          const float* __restrict__ psi,
                          const float* __restrict__ u_here,
                          const float* __restrict__ u_bw, int T, int Z,
                          int Y, int Xh, int parity, int tb_sign, int nrhs,
                          int nchunks) {
  const int64_t YXh = static_cast<int64_t>(Y) * Xh;
  const int64_t ZYXh = static_cast<int64_t>(Z) * YXh;
  const int64_t n = static_cast<int64_t>(T) * ZYXh;
  const int64_t b = blockIdx.x;
  const int chunk = static_cast<int>(b % nchunks);
  const int64_t site = (b / nchunks) * kThreads + threadIdx.x;
  if (site >= n) return;
  const int r0 = chunk * NB;
  const int nvalid = min(NB, nrhs - r0);
  const int64_t rstride = 24 * n;

  float2 acc[NB][4][3];
  eo_hop_sum<R, NB>(acc, psi + r0 * rstride, rstride, nvalid, u_here, u_bw,
                    T, Z, Y, Xh, YXh, ZYXh, n, parity, tb_sign, site);

#pragma unroll
  for (int r = 0; r < NB; ++r) {
    if (NB > 1 && r >= nvalid) break;
    float* o = out + (r0 + r) * rstride;
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float* q = o + static_cast<int64_t>((s * 3 + c) * 2) * n + site;
        q[0] = acc[r][s][c].x;
        q[n] = acc[r][s][c].y;
      }
  }
}

template <int R, int NB>
cudaError_t launch(void* out, const void* psi, const void* u_here,
                   const void* u_bw, int T, int Z, int Y, int Xh,
                   int parity, int tb_sign, int nrhs, int nchunks,
                   unsigned blocks, cudaStream_t stream) {
  wilson_eo_mrhs_kernel<R, NB><<<blocks, kThreads, 0, stream>>>(
      static_cast<float*>(out), static_cast<const float*>(psi),
      static_cast<const float*>(u_here), static_cast<const float*>(u_bw), T,
      Z, Y, Xh, parity, tb_sign, nrhs, nchunks);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_nb(int nb, void* out, const void* psi, const void* u_here,
                      const void* u_bw, int T, int Z, int Y, int Xh,
                      int parity, int tb_sign, int nrhs, int nchunks,
                      unsigned blocks, cudaStream_t stream) {
  return nb == 1 ? launch<R, 1>(out, psi, u_here, u_bw, T, Z, Y, Xh, parity,
                                tb_sign, nrhs, nchunks, blocks, stream)
                 : launch<R, 2>(out, psi, u_here, u_bw, T, Z, Y, Xh, parity,
                                tb_sign, nrhs, nchunks, blocks, stream);
}

}  // namespace

// All float32.  rows: 3 or 2; nrhs: the batch's right-hand sides; nb: the
// chunk width, 1 or 2.  A grid of more than 2^31 - 1 blocks is refused.
extern "C" int qtt_wilson_eo_mrhs(void* out, const void* psi,
                                  const void* u_here, const void* u_bw,
                                  int T, int Z, int Y, int Xh, int parity,
                                  int rows, int tb_sign, int nrhs, int nb,
                                  void* stream) {
  const int64_t n = static_cast<int64_t>(T) * Z * Y * Xh;
  if (n <= 0 || nrhs <= 0 || (nb != 1 && nb != 2) ||
      (parity != 0 && parity != 1) || (rows != 2 && rows != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t nchunks = (nrhs + nb - 1) / nb;
  const int64_t blocks = (n + kThreads - 1) / kThreads * nchunks;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned nblk = static_cast<unsigned>(blocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nc = static_cast<int>(nchunks);
  const cudaError_t err =
      rows == 3 ? launch_nb<3>(nb, out, psi, u_here, u_bw, T, Z, Y, Xh,
                               parity, tb_sign, nrhs, nc, nblk, s)
                : launch_nb<2>(nb, out, psi, u_here, u_bw, T, Z, Y, Xh,
                               parity, tb_sign, nrhs, nc, nblk, s);
  return static_cast<int>(err);
}
