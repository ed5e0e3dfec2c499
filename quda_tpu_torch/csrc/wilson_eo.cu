// Even/odd Wilson hop D_{p <- 1-p} on the packed pair layout (kernel B1).
//
// Replaces: quda_tpu/ops/wilson_pallas_packed.py::dslash_eo_pallas_packed,
// the Pallas TPU kernel (pallas_call at :1011, body _make_kernel(eo=...) at
// :184-308).  Plain version: quda_tpu_torch/ops/wilson_pallas_packed.py::
// dslash_eo_packed_plain.
//
// Layout; every spin/colour/re-im component is its own plane of
// S = T*Z*Y*Xh half-sites, so adjacent threads read adjacent addresses:
//   psi, out  (4, 3, 2, T, Z, Y*Xh)     parity 1-p in, parity p out
//   u_here    (4, R, 3, 2, T, Z, Y*Xh)  U_mu(x) at the target sites x
//   u_bw      (4, R, 3, 2, T, Z, Y*Xh)  U_mu(x - mu), taken from the opposite
//                                       parity and shifted once per gauge load
// Storage forms (template arguments): psi and links both float32 or both
// bfloat16; out float32 or (from bf16 storage) bfloat16; R = 3 link rows
// (full) or R = 2 (reconstruct-12: row 2 = conj(row0 x row1), rebuilt in
// registers).  Every load converts to f32 and every sum is f32; a bf16 out
// is rounded to nearest even once, at the store (__float2bfloat16_rn, what
// torch's .to(torch.bfloat16) does).  The native double form
// (full:f64->f64, R = 3) loads, sums and stores float64 throughout: the
// precise operator of the double routes.  It has no TPU twin (a TPU has no
// f64); its oracle is the complex128 plain version.
//
// Reconstruct-12 and the antiperiodic t boundary: the links carry the
// boundary phase folded in, so a t-link on the boundary plane is -U, and
// the cross product of its two stored rows gives +u2.  With tb_sign the
// rebuilt row is negated there: forward links on t = T-1, pre-shifted
// backward links on t = 0 (quda_tpu/ops/wilson_pallas_packed.py:196-198,
// :229-232, and _recon12_wrap).
//
// What bounds it on an H100: device memory.  A site needs 1320 flop (plus
// 8 x 3 x 14 = 336 for the rebuilt rows with R = 2) against at least
// 768 B in f32 (psi 96, links 576, out 96, when L2 serves the neighbour
// re-reads of psi), 384 B bf16 -> bf16 and 288 B bf16 R = 2 -> bf16: at
// most 5.7 flop/B, far under the ~20 flop/B where f32 arithmetic binds.
// In f64 it is 1536 B for the same 1320 flop, 0.86 flop/B against the
// card's ~10 f64 flop/B (34 TFLOP/s without tensor cores): memory too.
//
// Design: one thread per target half-site, 24 f32 accumulators in registers.
// The hop itself is eo_hop_sum of wilson_hop.cuh, shared with the fused
// clover hop (clover_eo.cu).  A thread computes its 8 neighbour indices
// directly: the TPU kernel's roll/splice shift network and z-block tiles
// are gone, a CUDA thread just reads its neighbour.  Each hop projects to a
// half spinor, multiplies by U (or U^dag) in colour and reconstructs, with
// the spin tables as compile-time constants so the +-1/+-i factors fold
// away.  The planar layout keeps the re and im parts of a number S elements
// apart, so a bf16 load is one 2-byte element per thread; a warp still reads
// 64 contiguous bytes per plane.  Offsets are 64-bit.
#include "wilson_hop.cuh"

namespace {

using namespace qtt;

constexpr int kThreads = 128;

template <typename S, typename O, int R>
__global__ void __launch_bounds__(kThreads)
    wilson_eo_kernel(O* __restrict__ out, const S* __restrict__ psi,
                     const S* __restrict__ u_here,
                     const S* __restrict__ u_bw, int T, int Z, int Y,
                     int Xh, int parity, int tb_sign) {
  const int64_t YXh = static_cast<int64_t>(Y) * Xh;
  const int64_t ZYXh = static_cast<int64_t>(Z) * YXh;
  const int64_t n = static_cast<int64_t>(T) * ZYXh;
  const int64_t site = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (site >= n) return;

  cplx_t<S> acc[1][4][3];
  eo_hop_sum<R, 1>(acc, psi, 0, 1, u_here, u_bw, T, Z, Y, Xh, YXh, ZYXh, n,
                   parity, tb_sign, site);

#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      O* q = out + static_cast<int64_t>((s * 3 + c) * 2) * n + site;
      st(q, acc[0][s][c].x);
      st(q + n, acc[0][s][c].y);
    }
}

template <typename S, typename O, int R>
cudaError_t launch(void* out, const void* psi, const void* u_here,
                   const void* u_bw, int T, int Z, int Y, int Xh,
                   int parity, int tb_sign, unsigned blocks,
                   cudaStream_t stream) {
  wilson_eo_kernel<S, O, R><<<blocks, kThreads, 0, stream>>>(
      static_cast<O*>(out), static_cast<const S*>(psi),
      static_cast<const S*>(u_here), static_cast<const S*>(u_bw), T, Z, Y,
      Xh, parity, tb_sign);
  return cudaGetLastError();
}

}  // namespace

// store: psi and links are float32 (0), bfloat16 (1) or float64 (2);
// out_store: out likewise (bf16 out needs bf16 storage; f64 goes with
// f64 only, and with rows 3); rows: 3 or 2.
extern "C" int qtt_wilson_eo(void* out, const void* psi, const void* u_here,
                             const void* u_bw, int T, int Z, int Y, int Xh,
                             int parity, int store, int out_store, int rows,
                             int tb_sign, void* stream) {
  const int64_t n = static_cast<int64_t>(T) * Z * Y * Xh;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  const bool forms_ok = (store == 0 && out_store == 0) ||
                        (store == 1 && (out_store == 0 || out_store == 1)) ||
                        (store == 2 && out_store == 2 && rows == 3);
  if (n <= 0 || blocks > 0x7fffffff || (parity != 0 && parity != 1) ||
      (rows != 2 && rows != 3) || !forms_ok) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned nb = static_cast<unsigned>(blocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  cudaError_t err;
  if (store == 2) {
    err = launch<double, double, 3>(out, psi, u_here, u_bw, T, Z, Y, Xh,
                                    parity, tb_sign, nb, s);
  } else if (store == 0) {
    err = rows == 3
              ? launch<float, float, 3>(out, psi, u_here, u_bw, T, Z, Y, Xh,
                                        parity, tb_sign, nb, s)
              : launch<float, float, 2>(out, psi, u_here, u_bw, T, Z, Y, Xh,
                                        parity, tb_sign, nb, s);
  } else if (out_store == 1) {
    err = rows == 3 ? launch<bf, bf, 3>(out, psi, u_here, u_bw, T, Z, Y, Xh,
                                        parity, tb_sign, nb, s)
                    : launch<bf, bf, 2>(out, psi, u_here, u_bw, T, Z, Y, Xh,
                                        parity, tb_sign, nb, s);
  } else {
    err = rows == 3
              ? launch<bf, float, 3>(out, psi, u_here, u_bw, T, Z, Y, Xh,
                                     parity, tb_sign, nb, s)
              : launch<bf, float, 2>(out, psi, u_here, u_bw, T, Z, Y, Xh,
                                     parity, tb_sign, nb, s);
  }
  return static_cast<int>(err);
}
