// Wilson hop D psi on the canonical layout (kernel B11).
//
// Replaces: quda_tpu/ops/wilson_pallas.py::dslash_pallas, the Pallas TPU
// kernel (pallas_call at :198, body _kernel at :133).  Plain version:
// quda_tpu_torch/ops/wilson_pallas.py::dslash_canonical_plain.  Its entry
// is the public ``dslash_pallas`` on complex fields (through
// torch.view_as_real, no copy: the complex arrays already are this layout).
//   out(x) = sum_mu [(1 - gamma_mu) U_mu(x) psi(x + mu)
//                    + (1 + gamma_mu) U_mu(x - mu)^dag psi(x - mu)]
//
// Layout, site-major with re and im innermost (wilson_hop.cuh's
// SiteLayout and SiteThere):
//   psi, out  (T, Z, Y, X, 4, 3, 2)       component k = 3s + c of site i
//                                         at i*24 + 2k
//   gauge     (4, T, Z, Y, X, 3, 3, 2)    link mu of site i at (mu*S + i)*18
// Boundary phases are folded into the gauge (no tb_sign).  Sites are
// numbered (t, z, y, x) as in the packed layout, so the hop is B10's
// (full_hop_sum_from with the backward link read unshifted at the
// neighbour) load for load, and its output is B10's on the same fields in
// the packed layout bit for bit.  Forms: f32 and f64 (complex64 and
// complex128 fields; sums in the storage's real type).
//
// What bounds it on an H100: device memory.  Its floor is 480 B a site in
// f32 (psi 96, gauge 288, out 96) and 960 B in f64, at 1320 flop: 0.300 ms
// and 0.601 ms at 32^3 x 64.
//
// Design: one thread per site, each complex number one 8-byte (16-byte in
// f64) load.  Neighbouring threads' sites lie 96 B (192 B) apart, so a
// warp's load of one component touches a quarter of the sectors it moves
// (an eighth in f64); the other components of the same sites arrive in
// the same lines, and L1 serves them to the loads that follow.  A
// staging of each block's sites through shared memory (a transpose to
// the plane layout) is left for later.
#include "wilson_hop.cuh"

namespace {

using namespace qtt;

constexpr int kThreads = 128;

__device__ __forceinline__ void st_cplx(float* q, float2 v) {
  *reinterpret_cast<float2*>(q) = v;
}
__device__ __forceinline__ void st_cplx(double* q, double2 v) {
  *reinterpret_cast<double2*>(q) = v;
}

template <typename S>
__global__ void __launch_bounds__(kThreads)
    wilson_canonical_kernel(S* __restrict__ out, const S* __restrict__ psi,
                            const S* __restrict__ gauge, int T, int Z, int Y,
                            int X) {
  const int64_t YX = static_cast<int64_t>(Y) * X;
  const int64_t ZYX = static_cast<int64_t>(Z) * YX;
  const int64_t n = static_cast<int64_t>(T) * ZYX;
  const int64_t site = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (site >= n) return;

  cplx_t<S> acc[1][4][3];
  full_hop_sum_from(acc, psi, 0, 1, SiteThere<S>{gauge}, T, Z, Y, X, YX, ZYX,
                    n, 0, site, SiteLayout{});
  S* o = out + site * 24;
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int c = 0; c < 3; ++c) st_cplx(o + (s * 3 + c) * 2, acc[0][s][c]);
}

}  // namespace

// f64: every array float64 (complex128 fields), else float32.  Lattice
// (T, Z, Y, X).  The arrays must be 8-byte (f32) or 16-byte (f64) aligned.
extern "C" int qtt_wilson_canonical(void* out, const void* psi,
                                    const void* gauge, int T, int Z, int Y,
                                    int X, int f64, void* stream) {
  const int64_t n = static_cast<int64_t>(T) * Z * Y * X;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (n <= 0 || blocks > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned nb = static_cast<unsigned>(blocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64) {
    wilson_canonical_kernel<double><<<nb, kThreads, 0, s>>>(
        static_cast<double*>(out), static_cast<const double*>(psi),
        static_cast<const double*>(gauge), T, Z, Y, X);
  } else {
    wilson_canonical_kernel<float><<<nb, kThreads, 0, s>>>(
        static_cast<float*>(out), static_cast<const float*>(psi),
        static_cast<const float*>(gauge), T, Z, Y, X);
  }
  return static_cast<int>(cudaGetLastError());
}
