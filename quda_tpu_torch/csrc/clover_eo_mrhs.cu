// Multi-RHS fused clover / twisted even/odd hop (kernel B7-mrhs, K1 and
// K2): the fused hop of clover_eo.cu over N right-hand sides, each link and
// each block entry loaded once for several of them.
//
// Replaces: quda_tpu/ops/clover_pallas.py::_fused_eo_call_mrhs, the Pallas
// TPU kernel (pallas_call at :283; _epilogue_kernel, :109, under
// wpp._mrhs_wrap on a (T, nzb, N) grid whose gauge and block index maps
// ignore n), in all its f32 forms (dslash_eo_pallas_post_mrhs,
// dslash_eo_pallas_diag_hop_mrhs): clover blocks, the twist epilogues and
// the block-free forms.  Plain versions: quda_tpu_torch/ops/
// clover_pallas.py::dslash_eo_post_mrhs_plain and
// dslash_eo_diag_hop_mrhs_plain.
//
//   K1 (post):     out_r = B hop_r, or out_r = scale (v + i c g5 v), v = hop_r
//   K2 (diag_hop): out_r = B x_r (or x_r) + i c g5 x_r + coeff * hop_r
//
// (each twist term only where the twist epilogue is chosen; see
// clover_eo.cu for the families' parameters).  Layouts: psi, x, out (N, 4,
// 3, 2, T, Z, Y*Xh), right-hand sides 24 * S elements apart; links as in
// wilson_hop.cuh; blocks B (2, 6, 6, 2, T, Z, Y*Xh) as in clover_eo.cu.
// Storage forms: all float32; R = 3 link rows, or R = 2 with tb_sign;
// epilogues (BLK, TWIST) = (1, 0) clover, (0, 1) twisted mass, (1, 1)
// twisted clover's K2: 10 instances per chunk width.
//
// What bounds it on an H100: device memory.  Per target half-site the
// links (576 B) and blocks (576 B, none without blocks) once, and N
// spinors in and out (192 N B; K2 reads x too, 288 N): at N = 12, K1's
// 3456 B against 12 x 1344 = 16128 B for 12 launches of K1.  (1320 + 504
// + 72) N flop against (192 N + 1152) B stays under 10 flop/B, far under
// f32's ~20.
//
// Design: one thread per target half-site and chunk of NB right-hand
// sides (NB = 1 or 2; a tail chunk skips the sides that do not exist).
// The hop is wilson_hop.cuh's eo_hop_sum<R, NB>, each link loaded once for
// the chunk.  The epilogue streams each block entry once into the NB 6x6
// complex mat-vecs, one output row at a time, in clover_eo.cu's order for
// every right-hand side, so each side sees the single-RHS arithmetic.  The
// chunk index varies fastest across the grid, so the chunks of one site
// block run side by side and share the links and blocks through L2.
// Offsets are 64-bit.
#include "wilson_hop.cuh"

namespace {

using namespace qtt;

constexpr int kThreads = 128;

template <int R, int NB, bool DIAG_HOP, bool BLK, bool TWIST>
__global__ void __launch_bounds__(kThreads)
    clover_eo_mrhs_kernel(float* __restrict__ out,
                          const float* __restrict__ psi,
                          const float* __restrict__ u_here,
                          const float* __restrict__ u_bw,
                          const float* __restrict__ blk,
                          const float* __restrict__ xc, int T, int Z, int Y,
                          int Xh, int parity, int tb_sign, float coeff,
                          float tw_c, float tw_scale, int nrhs,
                          int nchunks) {
  static_assert(BLK || TWIST, "an epilogue needs blocks or a twist");
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
  for (int ch = 0; ch < 2; ++ch) {
    // the six components of this chirality the epilogue acts on, per side
    float2 v[NB][6];
#pragma unroll
    for (int r = 0; r < NB; ++r)
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        if constexpr (DIAG_HOP) {
          v[r][j] = (NB == 1 || r < nvalid)
                        ? ld_psi(xc + (r0 + r) * rstride, 2 * ch + j / 3,
                                 j % 3, n, site)
                        : make_float2(0.f, 0.f);
        } else {
          v[r][j] = acc[r][2 * ch + j / 3][j % 3];
        }
      }
    // i c g5 w = (-c g5 w.im, c g5 w.re), g5 = +1 (ch 0), -1 (ch 1)
    const float g5c = ch == 0 ? tw_c : -tw_c;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      float2 o[NB];
      if constexpr (BLK) {
        {
          const float2 bij = ld_blk(blk, ch, i, 0, n, site);
#pragma unroll
          for (int r = 0; r < NB; ++r) o[r] = cmul(bij, v[r][0]);
        }
#pragma unroll
        for (int j = 1; j < 6; ++j) {
          const float2 bij = ld_blk(blk, ch, i, j, n, site);
#pragma unroll
          for (int r = 0; r < NB; ++r) o[r] = cadd(o[r], cmul(bij, v[r][j]));
        }
      } else {
#pragma unroll
        for (int r = 0; r < NB; ++r) o[r] = v[r][i];
      }
#pragma unroll
      for (int r = 0; r < NB; ++r) {
        if (NB > 1 && r >= nvalid) break;
        float2 w = o[r];
        if constexpr (TWIST) {
          if constexpr (DIAG_HOP) {
            w = make_float2(w.x + (-g5c * v[r][i].y), w.y + g5c * v[r][i].x);
          } else {
            w = make_float2(tw_scale * (w.x + (-g5c * w.y)),
                            tw_scale * (w.y + g5c * w.x));
          }
        }
        if constexpr (DIAG_HOP) {
          const float2 h = acc[r][2 * ch + i / 3][i % 3];
          w = make_float2(w.x + coeff * h.x, w.y + coeff * h.y);
        }
        float* q = out + (r0 + r) * rstride +
                   static_cast<int64_t>(((2 * ch + i / 3) * 3 + i % 3) * 2) *
                       n + site;
        q[0] = w.x;
        q[n] = w.y;
      }
    }
  }
}

struct Args {
  void* out;
  const void* psi;
  const void* u_here;
  const void* u_bw;
  const void* blk;
  const void* xc;
  int T, Z, Y, Xh, parity, tb_sign;
  float coeff, tw_c, tw_scale;
  int nrhs, nchunks;
  unsigned blocks;
  cudaStream_t stream;
};

template <int R, int NB, bool DIAG_HOP, bool BLK, bool TWIST>
cudaError_t launch(const Args& a) {
  clover_eo_mrhs_kernel<R, NB, DIAG_HOP, BLK, TWIST>
      <<<a.blocks, kThreads, 0, a.stream>>>(
          static_cast<float*>(a.out), static_cast<const float*>(a.psi),
          static_cast<const float*>(a.u_here),
          static_cast<const float*>(a.u_bw), static_cast<const float*>(a.blk),
          static_cast<const float*>(a.xc), a.T, a.Z, a.Y, a.Xh, a.parity,
          a.tb_sign, a.coeff, a.tw_c, a.tw_scale, a.nrhs, a.nchunks);
  return cudaGetLastError();
}

// K1's twist is block-free (twisted mass; the twisted clover folds its
// twist into K1's blocks), so K1 has no (blocks, twist) instance
template <int R, int NB, bool DIAG_HOP>
cudaError_t launch_epi(bool with_blk, bool twist, const Args& a) {
  if (!twist) return launch<R, NB, DIAG_HOP, true, false>(a);
  if (!with_blk) return launch<R, NB, DIAG_HOP, false, true>(a);
  if constexpr (DIAG_HOP) {
    return launch<R, NB, DIAG_HOP, true, true>(a);
  } else {
    return cudaErrorInvalidValue;
  }
}

template <int R, bool DIAG_HOP>
cudaError_t launch_nb(int nb, bool with_blk, bool twist, const Args& a) {
  return nb == 1 ? launch_epi<R, 1, DIAG_HOP>(with_blk, twist, a)
                 : launch_epi<R, 2, DIAG_HOP>(with_blk, twist, a);
}

}  // namespace

// All float32.  rows: 3 or 2; diag_hop: 0 = K1 (xc and coeff unused), 1 =
// K2 (xc required); with_blk, twist, tw_c, tw_scale: the epilogue, as for
// qtt_clover_eo; nrhs: the batch's right-hand sides; nb: the chunk width,
// 1 or 2.  A grid of more than 2^31 - 1 blocks is refused.
extern "C" int qtt_clover_eo_mrhs(void* out, const void* psi,
                                  const void* u_here, const void* u_bw,
                                  const void* blk, const void* xc, int T,
                                  int Z, int Y, int Xh, int parity, int rows,
                                  int tb_sign, int diag_hop, float coeff,
                                  int with_blk, int twist, float tw_c,
                                  float tw_scale, int nrhs, int nb,
                                  void* stream) {
  const int64_t n = static_cast<int64_t>(T) * Z * Y * Xh;
  if (n <= 0 || nrhs <= 0 || (nb != 1 && nb != 2) ||
      (parity != 0 && parity != 1) || (rows != 2 && rows != 3) ||
      (!with_blk && !twist) || (with_blk && blk == nullptr) ||
      (diag_hop && xc == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t nchunks = (nrhs + nb - 1) / nb;
  const int64_t blocks = (n + kThreads - 1) / kThreads * nchunks;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{out, psi, u_here, u_bw, blk, xc, T, Z, Y, Xh, parity,
               tb_sign, coeff, tw_c, tw_scale, nrhs,
               static_cast<int>(nchunks), static_cast<unsigned>(blocks),
               static_cast<cudaStream_t>(stream)};
  const bool wb = with_blk != 0, tw = twist != 0;
  cudaError_t err;
  if (rows == 3) {
    err = diag_hop ? launch_nb<3, true>(nb, wb, tw, a)
                   : launch_nb<3, false>(nb, wb, tw, a);
  } else {
    err = diag_hop ? launch_nb<2, true>(nb, wb, tw, a)
                   : launch_nb<2, false>(nb, wb, tw, a);
  }
  return static_cast<int>(err);
}
