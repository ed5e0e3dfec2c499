// Copy-free even/odd Wilson hop D_{p <- 1-p} on the packed pair layout: the
// backward links are read unshifted from the opposite parity, so no
// resident pre-shifted copy exists (kernels B10-eo and B9 r12f, and the
// multi-RHS r12f).
//
// Replaces: quda_tpu/ops/wilson_pallas_packed.py::
//   dslash_eo_pallas_packed_v3 (pallas_call at :1097, body _make_kernel_v3
//   with eo), dslash_eo_pallas_packed_r12f (pallas_call at :1584, body
//   _make_kernel_r12f) and dslash_eo_pallas_packed_r12f_mrhs (pallas_call
//   at :1649, _make_kernel_r12f under _mrhs_wrap).  Plain versions:
//   quda_tpu_torch/ops/wilson_pallas_packed.py::dslash_eo_there_plain and
//   dslash_eo_there_mrhs_plain (backward_gauge_eo, then B1's and B5-eo's
//   plain versions).
//
// On the TPU, v3 and r12f differ in how whole z tiles or single boundary
// rows reach the kernel and whether the backward product is shifted
// after the multiply; a CUDA thread reads its neighbour's link directly,
// so both are one function here: the entry qtt_wilson_eo_there serves
// both wrappers.  It is B1's hop (eo_hop_sum of wilson_hop.cuh) with the
// There link source: U_mu(x - mu) is read from u_there at the neighbour
// half-site x - mu, the index psi is read at (the x hop's slot-parity
// select included).  The recon-12 row-2 sign of the backward t link is
// keyed to the target plane t = 0, as B1's pre-shifted link: that link
// lives at plane T-1 of u_there.  Each output element is therefore B1's
// on backward_gauge_eo(u_there) bit for bit.
//
// Layout: psi, out (4, 3, 2, T, Z, Y*Xh) (a leading N for the multi-RHS
// entry); u_here, u_there (4, R, 3, 2, T, Z, Y*Xh).  Forms: psi and links
// both float32 or both bfloat16, out float32 or (bf16 storage) bfloat16,
// R = 3 or 2: B1's six f32/bf16 instances.  The multi-RHS entry is float32
// with R = 3 or 2 and chunk NB = 1 or 2, as B5-eo's.
//
// What bounds it on an H100: device memory, as B1 (768 B a site f32
// full, 576 R = 2, 384 / 288 bf16 -> bf16): the same bytes, only the
// resident copy and its precompute are gone.  The multi-RHS form moves
// 192 N + 576 B a site (R = 2: 192 N + 384), as B5-eo.
#include "wilson_hop.cuh"

namespace {

using namespace qtt;

constexpr int kThreads = 128;

template <typename S, typename O, int R>
__global__ void __launch_bounds__(kThreads)
    wilson_eo_there_kernel(O* __restrict__ out, const S* __restrict__ psi,
                           const S* __restrict__ u_here,
                           const S* __restrict__ u_there, int T, int Z,
                           int Y, int Xh, int parity, int tb_sign) {
  const int64_t YXh = static_cast<int64_t>(Y) * Xh;
  const int64_t ZYXh = static_cast<int64_t>(Z) * YXh;
  const int64_t n = static_cast<int64_t>(T) * ZYXh;
  const int64_t site = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (site >= n) return;

  cplx_t<S> acc[1][4][3];
  eo_hop_sum_from(acc, psi, 0, 1, There<R, S>{u_here, u_there}, T, Z, Y, Xh,
                  YXh, ZYXh, n, parity, tb_sign, site);

#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      O* q = out + static_cast<int64_t>((s * 3 + c) * 2) * n + site;
      st(q, acc[0][s][c].x);
      st(q + n, acc[0][s][c].y);
    }
}

template <int R, int NB>
__global__ void __launch_bounds__(kThreads)
    wilson_eo_there_mrhs_kernel(float* __restrict__ out,
                                const float* __restrict__ psi,
                                const float* __restrict__ u_here,
                                const float* __restrict__ u_there, int T,
                                int Z, int Y, int Xh, int parity,
                                int tb_sign, int nrhs, int nchunks) {
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
  eo_hop_sum_from(acc, psi + r0 * rstride, rstride, nvalid,
                  There<R, float>{u_here, u_there}, T, Z, Y, Xh, YXh, ZYXh,
                  n, parity, tb_sign, site);

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

template <typename S, typename O, int R>
cudaError_t launch(void* out, const void* psi, const void* u_here,
                   const void* u_there, int T, int Z, int Y, int Xh,
                   int parity, int tb_sign, unsigned blocks,
                   cudaStream_t stream) {
  wilson_eo_there_kernel<S, O, R><<<blocks, kThreads, 0, stream>>>(
      static_cast<O*>(out), static_cast<const S*>(psi),
      static_cast<const S*>(u_here), static_cast<const S*>(u_there), T, Z,
      Y, Xh, parity, tb_sign);
  return cudaGetLastError();
}

template <typename S, typename O>
cudaError_t launch_rows(int rows, void* out, const void* psi,
                        const void* u_here, const void* u_there, int T,
                        int Z, int Y, int Xh, int parity, int tb_sign,
                        unsigned blocks, cudaStream_t stream) {
  return rows == 3 ? launch<S, O, 3>(out, psi, u_here, u_there, T, Z, Y, Xh,
                                     parity, tb_sign, blocks, stream)
                   : launch<S, O, 2>(out, psi, u_here, u_there, T, Z, Y, Xh,
                                     parity, tb_sign, blocks, stream);
}

template <int R, int NB>
cudaError_t launch_mrhs(void* out, const void* psi, const void* u_here,
                        const void* u_there, int T, int Z, int Y, int Xh,
                        int parity, int tb_sign, int nrhs, int nchunks,
                        unsigned blocks, cudaStream_t stream) {
  wilson_eo_there_mrhs_kernel<R, NB><<<blocks, kThreads, 0, stream>>>(
      static_cast<float*>(out), static_cast<const float*>(psi),
      static_cast<const float*>(u_here), static_cast<const float*>(u_there),
      T, Z, Y, Xh, parity, tb_sign, nrhs, nchunks);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_mrhs_nb(int nb, void* out, const void* psi,
                           const void* u_here, const void* u_there, int T,
                           int Z, int Y, int Xh, int parity, int tb_sign,
                           int nrhs, int nchunks, unsigned blocks,
                           cudaStream_t stream) {
  return nb == 1
             ? launch_mrhs<R, 1>(out, psi, u_here, u_there, T, Z, Y, Xh,
                                 parity, tb_sign, nrhs, nchunks, blocks,
                                 stream)
             : launch_mrhs<R, 2>(out, psi, u_here, u_there, T, Z, Y, Xh,
                                 parity, tb_sign, nrhs, nchunks, blocks,
                                 stream);
}

}  // namespace

// store: psi and links float32 (0) or bfloat16 (1); out_store: out
// likewise (bf16 out needs bf16 storage); rows: 3 or 2.
extern "C" int qtt_wilson_eo_there(void* out, const void* psi,
                                   const void* u_here, const void* u_there,
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
    err = launch_rows<float, float>(rows, out, psi, u_here, u_there, T, Z, Y,
                                    Xh, parity, tb_sign, nb, s);
  } else if (out_store == 1) {
    err = launch_rows<bf, bf>(rows, out, psi, u_here, u_there, T, Z, Y, Xh,
                              parity, tb_sign, nb, s);
  } else {
    err = launch_rows<bf, float>(rows, out, psi, u_here, u_there, T, Z, Y,
                                 Xh, parity, tb_sign, nb, s);
  }
  return static_cast<int>(err);
}

// All float32.  rows: 3 or 2; nrhs: the batch's right-hand sides; nb: the
// chunk width, 1 or 2.  A grid of more than 2^31 - 1 blocks is refused.
extern "C" int qtt_wilson_eo_there_mrhs(void* out, const void* psi,
                                        const void* u_here,
                                        const void* u_there, int T, int Z,
                                        int Y, int Xh, int parity, int rows,
                                        int tb_sign, int nrhs, int nb,
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
      rows == 3 ? launch_mrhs_nb<3>(nb, out, psi, u_here, u_there, T, Z, Y,
                                    Xh, parity, tb_sign, nrhs, nc, nblk, s)
                : launch_mrhs_nb<2>(nb, out, psi, u_here, u_there, T, Z, Y,
                                    Xh, parity, tb_sign, nrhs, nc, nblk, s);
  return static_cast<int>(err);
}
