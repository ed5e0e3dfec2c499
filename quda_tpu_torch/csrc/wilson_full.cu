// Full-lattice Wilson hop D psi on the packed pair layout (kernel B4).
//
// Replaces: quda_tpu/ops/wilson_pallas_packed.py::dslash_pallas_packed, the
// Pallas TPU kernel (pallas_call at :441, body _make_kernel with no eo at
// :184-308).  Plain version: quda_tpu_torch/ops/wilson_pallas_packed.py::
// dslash_packed_plain.
//   out(x) = sum_mu [(1 - gamma_mu) U_mu(x) psi(x + mu)
//                    + (1 + gamma_mu) U_mu(x - mu)^dag psi(x - mu)]
//
// Layout; every spin/colour/re-im component is its own plane of
// S = T*Z*Y*X sites, so adjacent threads read adjacent addresses:
//   psi, out  (4, 3, 2, T, Z, Y*X)
//   u         (4, R, 3, 2, T, Z, Y*X)   U_mu(x), boundary phase folded in
//   u_bw      (4, R, 3, 2, T, Z, Y*X)   U_mu(x - mu): backward_gauge, shifted
//                                       once per gauge load
// Forms (template arguments): full:f32->f32 and r12:f32->f32 (R = 2, row 2
// = conj(row0 x row1) rebuilt in registers, negated with tb_sign on the t
// links of the antiperiodic boundary planes: forward on t = T-1, backward
// on t = 0), as the TPU kernel's f32 forms; and full:f64->f64, the native
// double form of mat_quda at cuda_prec "double", which has no TPU twin (a
// TPU has no f64; its oracle is the complex128 plain version).  Sums are in
// the storage's real type.
//
// What bounds it on an H100: device memory.  A site needs 1320 flop
// against at least 768 B in f32 with R = 3 (psi 96, two link sets 576, out
// 96, when L2 serves the neighbour re-reads of psi), 576 B with R = 2 and
// 1536 B in f64: at most 2.3 flop/B, against the ~20 (f32) and ~10 (f64)
// flop/B where the arithmetic binds.  At 32^3 x 64 the f32 floor is
// 0.481 ms and the f64 floor 0.962 ms.
//
// Design: B1's, on the full lattice.  One thread per site, 24 accumulators
// in registers; the hop is full_hop_sum of wilson_hop.cuh, the same hop
// code as B1 and the clover kernels with full-lattice neighbour indices.
// An x hop wraps inside its row of X slots of the fused Y*X axis (the TPU
// kernel's iota mask, wilson_packed._x_wrap_masks), never into the next y;
// y, z and t wrap on their own planes.  The TPU kernel's z-block tiles,
// neighbour tiles and lane rolls are gone: a CUDA thread reads its
// neighbour.  Offsets are 64-bit.
#include "wilson_hop.cuh"

namespace {

using namespace qtt;

constexpr int kThreads = 128;

template <typename S, int R>
__global__ void __launch_bounds__(kThreads)
    wilson_full_kernel(S* __restrict__ out, const S* __restrict__ psi,
                       const S* __restrict__ u, const S* __restrict__ u_bw,
                       int T, int Z, int Y, int X, int tb_sign) {
  const int64_t YX = static_cast<int64_t>(Y) * X;
  const int64_t ZYX = static_cast<int64_t>(Z) * YX;
  const int64_t n = static_cast<int64_t>(T) * ZYX;
  const int64_t site = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (site >= n) return;

  cplx_t<S> acc[1][4][3];
  full_hop_sum<R, 1>(acc, psi, 0, 1, u, u_bw, T, Z, Y, X, YX, ZYX, n,
                     tb_sign, site);

#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      S* q = out + static_cast<int64_t>((s * 3 + c) * 2) * n + site;
      st(q, acc[0][s][c].x);
      st(q + n, acc[0][s][c].y);
    }
}

template <typename S, int R>
cudaError_t launch(void* out, const void* psi, const void* u,
                   const void* u_bw, int T, int Z, int Y, int X, int tb_sign,
                   unsigned blocks, cudaStream_t stream) {
  wilson_full_kernel<S, R><<<blocks, kThreads, 0, stream>>>(
      static_cast<S*>(out), static_cast<const S*>(psi),
      static_cast<const S*>(u), static_cast<const S*>(u_bw), T, Z, Y, X,
      tb_sign);
  return cudaGetLastError();
}

}  // namespace

// f64: psi, links and out are float64 (rows 3 only), else float32; rows: 3
// or 2.  Lattice (T, Z, Y, X) in full sites.
extern "C" int qtt_wilson_full(void* out, const void* psi, const void* u,
                               const void* u_bw, int T, int Z, int Y, int X,
                               int rows, int f64, int tb_sign, void* stream) {
  const int64_t n = static_cast<int64_t>(T) * Z * Y * X;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (n <= 0 || blocks > 0x7fffffff || (rows != 2 && rows != 3) ||
      (f64 && rows != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned nb = static_cast<unsigned>(blocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (f64) {
    err = launch<double, 3>(out, psi, u, u_bw, T, Z, Y, X, tb_sign, nb, s);
  } else if (rows == 3) {
    err = launch<float, 3>(out, psi, u, u_bw, T, Z, Y, X, tb_sign, nb, s);
  } else {
    err = launch<float, 2>(out, psi, u, u_bw, T, Z, Y, X, tb_sign, nb, s);
  }
  return static_cast<int>(err);
}
