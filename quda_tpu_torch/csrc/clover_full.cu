// Full-lattice clover operator M psi = A psi - kappa D psi, and with the
// twist M psi = (A + i c g5) psi - kappa D psi, in one pass (kernel B7
// full).
//
// Replaces: quda_tpu/ops/clover_pallas.py::clover_pallas_packed, the Pallas
// TPU kernel (pallas_call at :394, body _epilogue_kernel at :109 with
// xc_mode="center", with_blk, hop_coeff=-kappa and the optional
// diag_twist).  Plain version: quda_tpu_torch/ops/clover_pallas.py::
// clover_packed_plain.  The clover and twisted-clover operator API
// (mat_quda, mat_dag_mat_quda: models/clover.py DiracCloverPackedPairs)
// runs it, one launch an M.
//
// Layout: psi, out (4, 3, 2, T, Z, Y*X); links u and the pre-shifted
// backward copy u_bw (4, R, 3, 2, T, Z, Y*X) as B4 takes them
// (wilson_full.cu); blocks (2, 6, 6, 2, T, Z, Y*X), A = 1 + the clover
// term, on the full lattice.  The diagonal's operand is psi itself at the
// centre site: no sixth operand.  Forms: full:f32->f32 and r12:f32->f32
// (R = 2 with tb_sign, as B4), each with and without the twist; c a
// runtime float, so one instance serves the twist a of M and -a of
// Mdag = g5 M(-a) g5.  Sums f32.
//
// What bounds it on an H100: device memory.  A site reads psi 96, the two
// link sets 576 (R = 2: 384) and the blocks 576 B and writes out 96: 1344 B
// (1152 with R = 2) against 1824 flop (+336 with R = 2, +72 with the
// twist), under 1.6 flop/B.  At 32^3 x 64 the floor is 0.841 ms (R = 3)
// and 0.721 ms (R = 2).  The blocks are 43% of the bytes.
//
// Design: B4's thread per site (full_hop_sum of wilson_hop.cuh) followed
// by K2's epilogue (clover_epilogue.cuh) with x = psi at the site and
// coeff = -kappa: the hop sum stays in registers, the centre spinor is
// re-read (one coalesced 96 B, in L2 from the hop's own x-neighbour
// reads), the blocks stream plane by plane.
#include "clover_epilogue.cuh"

namespace {

using namespace qtt;

constexpr int kThreads = 128;

template <int R, bool TWIST>
__global__ void __launch_bounds__(kThreads)
    clover_full_kernel(float* __restrict__ out, const float* __restrict__ psi,
                       const float* __restrict__ u,
                       const float* __restrict__ u_bw,
                       const float* __restrict__ blk, int T, int Z, int Y,
                       int X, int tb_sign, float coeff, float tw_c) {
  const int64_t YX = static_cast<int64_t>(Y) * X;
  const int64_t ZYX = static_cast<int64_t>(Z) * YX;
  const int64_t n = static_cast<int64_t>(T) * ZYX;
  const int64_t site = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (site >= n) return;

  float2 acc[1][4][3];
  full_hop_sum<R, 1>(acc, psi, 0, 1, u, u_bw, T, Z, Y, X, YX, ZYX, n,
                     tb_sign, site);
  clover_epilogue<float, float, true, true, TWIST>(
      out, acc[0], GlobalBlocks<float>{blk, n, site}, psi, n, site, coeff,
      tw_c, 1.f);
}

template <int R, bool TWIST>
cudaError_t launch(float* out, const float* psi, const float* u,
                   const float* u_bw, const float* blk, int T, int Z, int Y,
                   int X, int tb_sign, float coeff, float tw_c,
                   unsigned blocks, cudaStream_t stream) {
  clover_full_kernel<R, TWIST><<<blocks, kThreads, 0, stream>>>(
      out, psi, u, u_bw, blk, T, Z, Y, X, tb_sign, coeff, tw_c);
  return cudaGetLastError();
}

}  // namespace

// All float32; rows: 3 or 2; coeff = -kappa; twist: 0, or 1 to add
// i tw_c g5 psi.  Lattice (T, Z, Y, X) in full sites.
extern "C" int qtt_clover_full(void* out, const void* psi, const void* u,
                               const void* u_bw, const void* blk, int T,
                               int Z, int Y, int X, int rows, int tb_sign,
                               float coeff, int twist, float tw_c,
                               void* stream) {
  const int64_t n = static_cast<int64_t>(T) * Z * Y * X;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (n <= 0 || blocks > 0x7fffffff || (rows != 2 && rows != 3) ||
      blk == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned nb = static_cast<unsigned>(blocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  const float* p = static_cast<const float*>(psi);
  const float* g = static_cast<const float*>(u);
  const float* gb = static_cast<const float*>(u_bw);
  const float* b = static_cast<const float*>(blk);
  cudaError_t err;
  if (rows == 3) {
    err = twist ? launch<3, true>(o, p, g, gb, b, T, Z, Y, X, tb_sign, coeff,
                                  tw_c, nb, s)
                : launch<3, false>(o, p, g, gb, b, T, Z, Y, X, tb_sign,
                                   coeff, tw_c, nb, s);
  } else {
    err = twist ? launch<2, true>(o, p, g, gb, b, T, Z, Y, X, tb_sign, coeff,
                                  tw_c, nb, s)
                : launch<2, false>(o, p, g, gb, b, T, Z, Y, X, tb_sign,
                                   coeff, tw_c, nb, s);
  }
  return static_cast<int>(err);
}
