// The family diagonal of the fused clover / twisted hops, applied to one
// site's hop sum: the epilogue of the eo kernels K1 and K2 (clover_eo.cu)
// and of the full-lattice clover operator (clover_full.cu).
//
//   K1 (post):     v = round_O(hop);  out = B v, or (twisted mass)
//                  out = scale (v + i c g5 v)            out in storage type
//   DIAG_HOP:      out = B x (or x) + i c g5 x (if TWIST) + coeff * hop,
//                  out in f32 (K2: x a sixth operand, coeff = -kappa^2;
//                  the full-lattice operator: x = psi at the centre site,
//                  coeff = -kappa)
//
// Blocks B (2, 6, 6, 2, <sites>): the chiral 6x6 blocks, chirality
// ch = s / 2, block row i = 3 * (s % 2) + c, read as a general complex
// matrix from a block source (device memory, or a block's copy of its
// tile in shared memory: the multi-RHS kernel, clover_eo_mrhs.cu),
// streamed entry by entry into the mat-vec one output row at a time,
// twisted and stored as soon as it is summed.  g5 = +1 on chirality 0 and
// -1 on chirality 1.  The twist rotates the ORIGINAL x (not B x).  The
// block source changes where an entry is read, never the arithmetic.
// Rounding: K1 rounds each hop sum to the output type O and back before
// the epilogue (a no-op for f32), as the TPU kernel's out tile does.
// BLK, TWIST and DIAG_HOP are compile-time, so each instance compiles to
// the code of its epilogue alone.
#pragma once

#include <type_traits>

#include "wilson_hop.cuh"

namespace qtt {

// v rounded to the storage type O and back to f32
template <typename O>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (std::is_same_v<O, __nv_bfloat16>) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

// Block sources: entry (ch, a, b) of the target site's chiral blocks.
//   GlobalBlocks<S>  the blocks (2, 6, 6, 2, <sites>) in device memory, at
//                    site i of planes of n sites (K1/K2, B7 full);
//   TileBlocks       a block's copy of its tile's blocks in shared memory,
//                    (2, 6, 6, 2) planes of ts sites, the target at slot
//                    ``local``: the same numbers the global array holds.
template <typename S>
struct GlobalBlocks {
  const S* blk;
  int64_t n;
  int64_t i;
  __device__ __forceinline__ cplx_t<S> at(int ch, int a, int b) const {
    return ld_blk(blk, ch, a, b, n, i);
  }
};

struct TileBlocks {
  const float* sh;
  int ts;
  int local;
  __device__ __forceinline__ float2 at(int ch, int a, int b) const {
    const float* q = sh + ((ch * 6 + a) * 6 + b) * 2 * ts + local;
    return make_float2(q[0], q[ts]);
  }
};

// The epilogue at ``site`` of planes of n sites: acc the hop sum, xc the
// diagonal's operand (DIAG_HOP), blks the block source (BLK); out in O.
template <typename S, typename O, bool DIAG_HOP, bool BLK, bool TWIST,
          typename BS>
__device__ __forceinline__ void clover_epilogue(
    O* __restrict__ out, const float2 (&acc)[4][3], const BS& blks,
    const S* __restrict__ xc, int64_t n, int64_t site, float coeff,
    float tw_c, float tw_scale) {
  static_assert(BLK || TWIST, "an epilogue needs blocks or a twist");
#pragma unroll
  for (int ch = 0; ch < 2; ++ch) {
    // the six components of this chirality the epilogue acts on
    float2 v[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      if constexpr (DIAG_HOP) {
        v[j] = ld_psi(xc, 2 * ch + j / 3, j % 3, n, site);
      } else {
        const float2 a = acc[2 * ch + j / 3][j % 3];
        v[j] = make_float2(round_to<O>(a.x), round_to<O>(a.y));
      }
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      float2 o;
      if constexpr (BLK) {
        o = cmul(blks.at(ch, i, 0), v[0]);
#pragma unroll
        for (int j = 1; j < 6; ++j) {
          o = cadd(o, cmul(blks.at(ch, i, j), v[j]));
        }
      } else {
        o = v[i];
      }
      if constexpr (TWIST) {
        // i c g5 w = (-c g5 w.im, c g5 w.re), g5 = +1 (ch 0), -1 (ch 1)
        const float g5c = ch == 0 ? tw_c : -tw_c;
        if constexpr (DIAG_HOP) {
          o = make_float2(o.x + (-g5c * v[i].y), o.y + g5c * v[i].x);
        } else {
          o = make_float2(tw_scale * (o.x + (-g5c * o.y)),
                          tw_scale * (o.y + g5c * o.x));
        }
      }
      if constexpr (DIAG_HOP) {
        const float2 h = acc[2 * ch + i / 3][i % 3];
        o = make_float2(o.x + coeff * h.x, o.y + coeff * h.y);
      }
      O* q = out + static_cast<int64_t>(((2 * ch + i / 3) * 3 + i % 3) * 2) *
                       n + site;
      st(q, o.x);
      st(q + n, o.y);
    }
  }
}

}  // namespace qtt
