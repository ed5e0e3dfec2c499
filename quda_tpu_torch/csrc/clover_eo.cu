// Fused clover / twisted even/odd hop (kernel B7, K1 and K2): the eo
// Wilson hop D_{p <- 1-p} psi with the family diagonal applied in its
// epilogue.
//
// Replaces: quda_tpu/ops/clover_pallas.py::_fused_eo_call, the Pallas TPU
// kernel (pallas_call at :213, body _epilogue_kernel at :109-155), in all
// its forms (dslash_eo_pallas_post, dslash_eo_pallas_diag_hop): the clover
// blocks, the twist epilogues ``twist`` and ``diag_twist``, and the
// block-free forms.  Plain versions: quda_tpu_torch/ops/clover_pallas.py::
// dslash_eo_post_plain and dslash_eo_diag_hop_plain.
//
//   K1 (post):     v = round_O(hop);  out = B v, or (twisted mass)
//                  out = scale (v + i c g5 v)            out in storage type
//   K2 (diag_hop): out = B x (or x) + i c g5 x (if twist) + coeff * hop,
//                  coeff = -kappa^2, out in f32
//
// The families: clover K1 = A_q^-1 blocks, K2 = A_p blocks; twisted mass
// K1 = no blocks, twist (c, scale) = (-s a, 1/(1+a^2)), K2 = no blocks,
// c = s a; twisted clover K1 = the dense (A_q + i s a g5)^-1 blocks, K2 =
// A_p blocks with c = s a.  The twist rotates the ORIGINAL x in K2 (not
// B x), as the TPU kernel does.  c and scale are runtime floats, so one
// instance serves both signs s of Mdag = g5 M(-s) g5.
//
// Layouts: psi, x, out (4, 3, 2, T, Z, Y*Xh); links as in wilson_hop.cuh;
// blocks B (2, 6, 6, 2, T, Z, Y*Xh): the chiral 6x6 blocks, chirality
// ch = s / 2, block row i = 3 * (s % 2) + c (_blk_mul of the JAX module),
// read as a general (not Hermitian) complex matrix.  g5 = +1 on chirality
// 0 and -1 on chirality 1, so the twist of component i of chirality ch
// needs that component alone.  Storage forms (template arguments): psi,
// links, blocks (and x) all float32 or all bfloat16; R = 3 link rows, or
// R = 2 with tb_sign; K1 writes the storage type, K2 float32.  The
// epilogue (BLK, TWIST) is a compile-time choice too, so the clover
// instances (BLK, no TWIST) compile to the code they had before the twist
// existed: K1 blocks or twist, K2 blocks, twist or both, over 4 storage
// forms each = 20 instances behind one C entry.
//
// Rounding: the TPU kernel writes the hop to its out tile at the out dtype
// and reads it back before the epilogue.  K1 does the same in registers:
// with bf16 storage each accumulator is rounded to bf16 and back
// (__float2bfloat16_rn / __bfloat162float) before the blocks and the
// twist; with f32 storage that is a no-op.  The twist's scale is a
// multiply (the staged path divides by 1 + a^2).  Every other sum is f32,
// and a bf16 out is rounded once at the store.
//
// What bounds it on an H100: device memory.  A site needs 1320 + 504 flop
// with blocks (+72 with the twist, +48 for K2's axpy, +336 with R = 2)
// against at least 1344 B in f32 (K1: psi 96, links 576, blocks 576, out
// 96; K2 adds x 96), 672 B for K1 bf16 -> bf16; without blocks 768 B (K1
// f32), 384 B (K1 bf16) and 864 B (K2 f32): under 2 flop/B, far below the
// ~20 flop/B where f32 arithmetic binds.  The blocks are half of the f32
// traffic.
//
// Design: one thread per target half-site; the hop is wilson_hop.cuh's
// eo_hop_sum (the B1 code), 24 f32 accumulators in registers.  The
// epilogue (clover_epilogue.cuh, shared with the full-lattice clover
// operator of clover_full.cu) streams the block entries plane by plane
// (coalesced across the warp, as the links are) into the 6x6 complex
// mat-vec, one output row at a time, twisted and stored as soon as it is
// summed: the 144 block numbers of a site are never held in registers at
// once.  K2 reads the six spinor
// components of x of one chirality at a time.  Hermitian compression of
// the clover blocks (72 reals), shared-memory reuse and wgmma/TMA are left
// for later.
#include "clover_epilogue.cuh"

namespace {

using namespace qtt;

constexpr int kThreads = 128;

template <typename S, typename O, int R, bool DIAG_HOP, bool BLK, bool TWIST>
__global__ void __launch_bounds__(kThreads)
    clover_eo_kernel(O* __restrict__ out, const S* __restrict__ psi,
                     const S* __restrict__ u_here,
                     const S* __restrict__ u_bw, const S* __restrict__ blk,
                     const S* __restrict__ xc, int T, int Z, int Y, int Xh,
                     int parity, int tb_sign, float coeff, float tw_c,
                     float tw_scale) {
  const int64_t YXh = static_cast<int64_t>(Y) * Xh;
  const int64_t ZYXh = static_cast<int64_t>(Z) * YXh;
  const int64_t n = static_cast<int64_t>(T) * ZYXh;
  const int64_t site = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (site >= n) return;

  float2 acc[1][4][3];
  eo_hop_sum<R, 1>(acc, psi, 0, 1, u_here, u_bw, T, Z, Y, Xh, YXh, ZYXh, n,
                   parity, tb_sign, site);
  clover_epilogue<S, O, DIAG_HOP, BLK, TWIST>(
      out, acc[0], GlobalBlocks<S>{blk, n, site}, xc, n, site, coeff, tw_c,
      tw_scale);
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
  unsigned blocks;
  cudaStream_t stream;
};

template <typename S, typename O, int R, bool DIAG_HOP, bool BLK, bool TWIST>
cudaError_t launch(const Args& a) {
  clover_eo_kernel<S, O, R, DIAG_HOP, BLK, TWIST>
      <<<a.blocks, kThreads, 0, a.stream>>>(
          static_cast<O*>(a.out), static_cast<const S*>(a.psi),
          static_cast<const S*>(a.u_here), static_cast<const S*>(a.u_bw),
          static_cast<const S*>(a.blk), static_cast<const S*>(a.xc), a.T,
          a.Z, a.Y, a.Xh, a.parity, a.tb_sign, a.coeff, a.tw_c, a.tw_scale);
  return cudaGetLastError();
}

// K1's twist is block-free (twisted mass; the twisted clover folds its
// twist into K1's blocks), so K1 has no (blocks, twist) instance
template <typename S, typename O, int R, bool DIAG_HOP>
cudaError_t launch_epi(bool with_blk, bool twist, const Args& a) {
  if (!twist) return launch<S, O, R, DIAG_HOP, true, false>(a);
  if (!with_blk) return launch<S, O, R, DIAG_HOP, false, true>(a);
  if constexpr (DIAG_HOP) {
    return launch<S, O, R, DIAG_HOP, true, true>(a);
  } else {
    return cudaErrorInvalidValue;
  }
}

template <typename S, typename O, bool DIAG_HOP>
cudaError_t launch_rows(int rows, bool with_blk, bool twist, const Args& a) {
  return rows == 3 ? launch_epi<S, O, 3, DIAG_HOP>(with_blk, twist, a)
                   : launch_epi<S, O, 2, DIAG_HOP>(with_blk, twist, a);
}

}  // namespace

// store_bf16: psi, links, blocks and x are bfloat16 (else float32); rows: 3
// or 2; diag_hop: 0 = K1 (out in the storage type, xc and coeff unused),
// 1 = K2 (out float32, xc required); with_blk: blk is read (else it may be
// null); twist: 0, or 1 for the twist epilogue (K1: scale (v + i c g5 v),
// block-free; K2: + i c g5 x), tw_c = c, tw_scale = scale (K1 only).  An
// epilogue needs blocks or a twist, and K1 not both.
extern "C" int qtt_clover_eo(void* out, const void* psi, const void* u_here,
                             const void* u_bw, const void* blk,
                             const void* xc, int T, int Z, int Y, int Xh,
                             int parity, int store_bf16, int rows,
                             int tb_sign, int diag_hop, float coeff,
                             int with_blk, int twist, float tw_c,
                             float tw_scale, void* stream) {
  const int64_t n = static_cast<int64_t>(T) * Z * Y * Xh;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (n <= 0 || blocks > 0x7fffffff || (parity != 0 && parity != 1) ||
      (rows != 2 && rows != 3) || (!with_blk && !twist) ||
      (with_blk && blk == nullptr) || (diag_hop && xc == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{out, psi, u_here, u_bw, blk, xc, T, Z, Y, Xh, parity,
               tb_sign, coeff, tw_c, tw_scale,
               static_cast<unsigned>(blocks),
               static_cast<cudaStream_t>(stream)};
  const bool wb = with_blk != 0, tw = twist != 0;
  using bf = __nv_bfloat16;
  cudaError_t err;
  if (!store_bf16) {
    err = diag_hop ? launch_rows<float, float, true>(rows, wb, tw, a)
                   : launch_rows<float, float, false>(rows, wb, tw, a);
  } else {
    err = diag_hop ? launch_rows<bf, float, true>(rows, wb, tw, a)
                   : launch_rows<bf, bf, false>(rows, wb, tw, a);
  }
  return static_cast<int>(err);
}
