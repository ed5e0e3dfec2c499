// Even/odd Wilson hop D_{p <- 1-p} on int8 block-float links (kernel B9
// int8): QUDA's quarter-precision gauge field, the sloppy operator of
// invert_quda(cuda_prec_sloppy="quarter").
//
// Replaces: quda_tpu/ops/wilson_pallas_packed.py::
// dslash_eo_pallas_packed_int8 (pallas_call at :1904, body
// _make_kernel_int8 with _int8_link_getter).  Plain version:
// quda_tpu_torch/ops/wilson_pallas_packed.py::dslash_eo_int8_plain
// (from_int8_links, then the copy-free hop's plain version).
//
// Layout: psi, out (4, 3, 2, T, Z, Y*Xh); q_here, q_there (4, 3, 3, 2, T,
// Z, Y*Xh) int8 mantissas of the target and the opposite parity's links;
// s_here, s_there (4, T, Z, Y*Xh) float32, one scale per (direction,
// site) (ops/blockfloat.to_int8_links).  The backward links are read
// unshifted from the opposite parity at the neighbour x - mu (the
// Int8There link source of wilson_hop.cuh), so no backward copy exists.
//
// Forms: psi float32 -> out float32, psi bfloat16 -> out bfloat16 or
// float32; links int8 + f32 scales in every form; R = 3 (the JAX kernel
// has no int8 recon-12).  Each element is decoded as __fmul_rn(float(q),
// scale): one rounding, which nvcc does not contract with the colour
// product that follows, so the decoded link equals from_int8_links' and
// the hop is B1's on those links bit for bit.  Sums are f32.
//
// What bounds it on an H100: device memory.  A site moves psi 24 and out
// 24 numbers and 8 links of 18 B mantissas + 4 B scale: 272 B bf16 ->
// bf16 (B1 full: 384), 320 B bf16 -> f32, 368 B f32 -> f32, for 1320 +
// 144 (decode) flop.
//
// Design: B1's (one thread per target half-site, 24 f32 accumulators,
// the spin tables folded at compile time).  Each mantissa is a 1-byte
// load, so a warp reads 32 contiguous bytes a plane: narrow loads that
// leave this kernel well under its bound.  Wider loads (16 B vectors of
// a row of mantissas, shared tiles) are later work.
#include "wilson_hop.cuh"

namespace {

using namespace qtt;

constexpr int kThreads = 128;

template <typename S, typename O>
__global__ void __launch_bounds__(kThreads)
    wilson_eo_int8_kernel(O* __restrict__ out, const S* __restrict__ psi,
                          const int8_t* __restrict__ q_here,
                          const float* __restrict__ s_here,
                          const int8_t* __restrict__ q_there,
                          const float* __restrict__ s_there, int T, int Z,
                          int Y, int Xh, int parity) {
  const int64_t YXh = static_cast<int64_t>(Y) * Xh;
  const int64_t ZYXh = static_cast<int64_t>(Z) * YXh;
  const int64_t n = static_cast<int64_t>(T) * ZYXh;
  const int64_t site = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (site >= n) return;

  float2 acc[1][4][3];
  // R = 3 links: no rebuilt row, so no t-boundary sign
  eo_hop_sum_from(acc, psi, 0, 1, Int8There{q_here, s_here, q_there, s_there},
                  T, Z, Y, Xh, YXh, ZYXh, n, parity, 0, site);

#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      O* q = out + static_cast<int64_t>((s * 3 + c) * 2) * n + site;
      st(q, acc[0][s][c].x);
      st(q + n, acc[0][s][c].y);
    }
}

template <typename S, typename O>
cudaError_t launch(void* out, const void* psi, const void* q_here,
                   const void* s_here, const void* q_there,
                   const void* s_there, int T, int Z, int Y, int Xh,
                   int parity, unsigned blocks, cudaStream_t stream) {
  wilson_eo_int8_kernel<S, O><<<blocks, kThreads, 0, stream>>>(
      static_cast<O*>(out), static_cast<const S*>(psi),
      static_cast<const int8_t*>(q_here), static_cast<const float*>(s_here),
      static_cast<const int8_t*>(q_there), static_cast<const float*>(s_there),
      T, Z, Y, Xh, parity);
  return cudaGetLastError();
}

}  // namespace

// store: psi float32 (0) or bfloat16 (1); out_store: out likewise (bf16
// out needs bf16 psi).  Links: int8 mantissas and float32 scales.
extern "C" int qtt_wilson_eo_int8(void* out, const void* psi,
                                  const void* q_here, const void* s_here,
                                  const void* q_there, const void* s_there,
                                  int T, int Z, int Y, int Xh, int parity,
                                  int store, int out_store, void* stream) {
  const int64_t n = static_cast<int64_t>(T) * Z * Y * Xh;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  const bool forms_ok = (store == 0 && out_store == 0) ||
                        (store == 1 && (out_store == 0 || out_store == 1));
  if (n <= 0 || blocks > 0x7fffffff || (parity != 0 && parity != 1) ||
      !forms_ok) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned nb = static_cast<unsigned>(blocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  cudaError_t err;
  if (store == 0) {
    err = launch<float, float>(out, psi, q_here, s_here, q_there, s_there, T,
                               Z, Y, Xh, parity, nb, s);
  } else if (out_store == 1) {
    err = launch<bf, bf>(out, psi, q_here, s_here, q_there, s_there, T, Z, Y,
                         Xh, parity, nb, s);
  } else {
    err = launch<bf, float>(out, psi, q_here, s_here, q_there, s_there, T, Z,
                            Y, Xh, parity, nb, s);
  }
  return static_cast<int>(err);
}
