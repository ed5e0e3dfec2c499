// Even/odd Wilson hop D_{p <- 1-p} on the folded layout (kernel B9 fold)
// and its multi-RHS form (B9 fold-mrhs).
//
// Replaces: quda_tpu/ops/wilson_pallas_packed.py::
// dslash_eo_pallas_packed_fold (pallas_call at :1328, body
// _make_kernel_fold at :1172) and dslash_eo_pallas_packed_fold_mrhs
// (pallas_call at :1383: the same body under _mrhs_wrap, the links fetched
// once a tile for all N right-hand sides).  Plain versions:
// quda_tpu_torch/ops/wilson_pallas_packed.py::dslash_eo_fold_plain and
// dslash_eo_fold_mrhs_plain (B1's and B5-eo's plain versions through
// from_fold / to_fold).
//
// Layout (to_fold of B1's): the re/im axis interleaved into z,
//   psi, out  (4, 3, T, 2Z, Y*Xh)       parity 1-p in, parity p out
//   u_here    (4, R, 3, T, 2Z, Y*Xh)    U_mu(x) at the target sites x
//   u_bw      (4, R, 3, T, 2Z, Y*Xh)    U_mu(x - mu), pre-shifted
//   multi-RHS psi, out (N, 4, 3, T, 2Z, Y*Xh)
// Row 2k of a (t, 2Z) plane holds the real parts of z = k, row 2k + 1 the
// imaginary parts.  The TPU kernel folds so that a bf16 block fills its
// (16, 128) tile; on the card a component is still one plane of 2S
// elements (S = T*Z*Y*Xh), so only the address of a half-site's number
// changes (wilson_hop.cuh's FoldLayout: re of half-site i = r*YXh + yx,
// r = t*Z + z, at i + r*YXh, im YXh further on).
//
// Forms: B1's.  The single-RHS hop takes psi and links both float32 or
// both bfloat16, out float32 or (from bf16 storage) bfloat16, R = 3 or 2
// link rows (row 2 rebuilt, negated on the antiperiodic t boundary planes
// with tb_sign); the multi-RHS hop float32 with R = 3 or 2 and a chunk of
// NB = 1 or 2 right-hand sides a thread (B5-eo's).  Every sum is f32.
//
// What bounds them on an H100: device memory, as B1 and B5-eo: 768 B a
// half-site in f32 (384 bf16 -> bf16) for 1320 flop; (192 N + 576) B for
// 1320 N flop with N right-hand sides.
//
// Design: B1's and B5-eo's threads (one per target half-site and chunk)
// running wilson_hop.cuh's eo hop with the FoldLayout accessor: the hop
// body, its loads and its order of sums are B1's, so each output equals
// B1's on the unfolded operands bit for bit.  A thread places each
// neighbour from the neighbour's own row: x and y neighbours share the
// target's row, a z neighbour is two folded rows away and a t neighbour
// 2Z rows.  The real and imaginary parts of a number now lie YXh apart,
// in one row pair, where the pair layout puts them a plane apart.
// Offsets are 64-bit.
#include "wilson_hop.cuh"

namespace {

using namespace qtt;

constexpr int kThreads = 128;

template <typename S, typename O, int R>
__global__ void __launch_bounds__(kThreads)
    wilson_eo_fold_kernel(O* __restrict__ out, const S* __restrict__ psi,
                          const S* __restrict__ u_here,
                          const S* __restrict__ u_bw, int T, int Z, int Y,
                          int Xh, int parity, int tb_sign) {
  const int64_t YXh = static_cast<int64_t>(Y) * Xh;
  const int64_t ZYXh = static_cast<int64_t>(Z) * YXh;
  const int64_t n = static_cast<int64_t>(T) * ZYXh;
  const int64_t site = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (site >= n) return;

  cplx_t<S> acc[1][4][3];
  const int64_t a = eo_hop_sum_from(acc, psi, 0, 1,
                                    Shifted<R, S>{u_here, u_bw}, T, Z, Y,
                                    Xh, YXh, ZYXh, n, parity, tb_sign, site,
                                    FoldLayout{YXh});
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      O* q = out + static_cast<int64_t>((s * 3 + c) * 2) * n + a;
      st(q, acc[0][s][c].x);
      st(q + YXh, acc[0][s][c].y);
    }
}

template <int R, int NB>
__global__ void __launch_bounds__(kThreads)
    wilson_eo_fold_mrhs_kernel(float* __restrict__ out,
                               const float* __restrict__ psi,
                               const float* __restrict__ u_here,
                               const float* __restrict__ u_bw, int T, int Z,
                               int Y, int Xh, int parity, int tb_sign,
                               int nrhs, int nchunks) {
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
  const int64_t a = eo_hop_sum_from(acc, psi + r0 * rstride, rstride,
                                    nvalid, Shifted<R, float>{u_here, u_bw},
                                    T, Z, Y, Xh, YXh, ZYXh, n, parity,
                                    tb_sign, site, FoldLayout{YXh});
#pragma unroll
  for (int r = 0; r < NB; ++r) {
    if (NB > 1 && r >= nvalid) break;
    float* o = out + (r0 + r) * rstride;
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float* q = o + static_cast<int64_t>((s * 3 + c) * 2) * n + a;
        q[0] = acc[r][s][c].x;
        q[YXh] = acc[r][s][c].y;
      }
  }
}

template <typename S, typename O, int R>
cudaError_t launch(void* out, const void* psi, const void* u_here,
                   const void* u_bw, int T, int Z, int Y, int Xh,
                   int parity, int tb_sign, unsigned blocks,
                   cudaStream_t stream) {
  wilson_eo_fold_kernel<S, O, R><<<blocks, kThreads, 0, stream>>>(
      static_cast<O*>(out), static_cast<const S*>(psi),
      static_cast<const S*>(u_here), static_cast<const S*>(u_bw), T, Z, Y,
      Xh, parity, tb_sign);
  return cudaGetLastError();
}

template <typename S, typename O>
cudaError_t launch_rows(int rows, void* out, const void* psi,
                        const void* u_here, const void* u_bw, int T, int Z,
                        int Y, int Xh, int parity, int tb_sign,
                        unsigned blocks, cudaStream_t stream) {
  return rows == 3 ? launch<S, O, 3>(out, psi, u_here, u_bw, T, Z, Y, Xh,
                                     parity, tb_sign, blocks, stream)
                   : launch<S, O, 2>(out, psi, u_here, u_bw, T, Z, Y, Xh,
                                     parity, tb_sign, blocks, stream);
}

template <int R, int NB>
cudaError_t launch_mrhs(void* out, const void* psi, const void* u_here,
                        const void* u_bw, int T, int Z, int Y, int Xh,
                        int parity, int tb_sign, int nrhs, int nchunks,
                        unsigned blocks, cudaStream_t stream) {
  wilson_eo_fold_mrhs_kernel<R, NB><<<blocks, kThreads, 0, stream>>>(
      static_cast<float*>(out), static_cast<const float*>(psi),
      static_cast<const float*>(u_here), static_cast<const float*>(u_bw), T,
      Z, Y, Xh, parity, tb_sign, nrhs, nchunks);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_mrhs_nb(int nb, void* out, const void* psi,
                           const void* u_here, const void* u_bw, int T,
                           int Z, int Y, int Xh, int parity, int tb_sign,
                           int nrhs, int nchunks, unsigned blocks,
                           cudaStream_t stream) {
  return nb == 1
             ? launch_mrhs<R, 1>(out, psi, u_here, u_bw, T, Z, Y, Xh, parity,
                                 tb_sign, nrhs, nchunks, blocks, stream)
             : launch_mrhs<R, 2>(out, psi, u_here, u_bw, T, Z, Y, Xh, parity,
                                 tb_sign, nrhs, nchunks, blocks, stream);
}

}  // namespace

// store: psi and links float32 (0) or bfloat16 (1); out_store: out float32
// (0) or bfloat16 (1, from bf16 storage only); rows: 3 or 2.
extern "C" int qtt_wilson_eo_fold(void* out, const void* psi,
                                  const void* u_here, const void* u_bw,
                                  int T, int Z, int Y, int Xh, int parity,
                                  int store, int out_store, int rows,
                                  int tb_sign, void* stream) {
  const int64_t n = static_cast<int64_t>(T) * Z * Y * Xh;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  const bool forms_ok = (store == 0 && out_store == 0) ||
                        (store == 1 && (out_store == 0 || out_store == 1));
  if (n <= 0 || blocks > 0x7fffffff || (parity != 0 && parity != 1) ||
      (rows != 2 && rows != 3) || !forms_ok) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned nb = static_cast<unsigned>(blocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  cudaError_t err;
  if (store == 0) {
    err = launch_rows<float, float>(rows, out, psi, u_here, u_bw, T, Z, Y,
                                    Xh, parity, tb_sign, nb, s);
  } else if (out_store == 1) {
    err = launch_rows<bf, bf>(rows, out, psi, u_here, u_bw, T, Z, Y, Xh,
                              parity, tb_sign, nb, s);
  } else {
    err = launch_rows<bf, float>(rows, out, psi, u_here, u_bw, T, Z, Y, Xh,
                                 parity, tb_sign, nb, s);
  }
  return static_cast<int>(err);
}

// All float32.  rows: 3 or 2; nrhs: the batch's right-hand sides; nb: the
// chunk width, 1 or 2.  A grid of more than 2^31 - 1 blocks is refused.
extern "C" int qtt_wilson_eo_fold_mrhs(void* out, const void* psi,
                                       const void* u_here, const void* u_bw,
                                       int T, int Z, int Y, int Xh,
                                       int parity, int rows, int tb_sign,
                                       int nrhs, int nb, void* stream) {
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
      rows == 3 ? launch_mrhs_nb<3>(nb, out, psi, u_here, u_bw, T, Z, Y, Xh,
                                    parity, tb_sign, nrhs, nc, nblk, s)
                : launch_mrhs_nb<2>(nb, out, psi, u_here, u_bw, T, Z, Y, Xh,
                                    parity, tb_sign, nrhs, nc, nblk, s);
  return static_cast<int>(err);
}
