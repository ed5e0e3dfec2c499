// Multi-RHS fused clover / twisted even/odd hop (kernel B7-mrhs, K1 and
// K2): the fused hop of clover_eo.cu over N right-hand sides, each link
// and each clover block entry read from device memory once for all of
// them.
//
// Replaces: quda_tpu/ops/clover_pallas.py::_fused_eo_call_mrhs, the Pallas
// TPU kernel (pallas_call at :283; _epilogue_kernel, :109, under
// wpp._mrhs_wrap on a (T, nzb, N) grid whose gauge and block index maps
// ignore n), in all its f32 forms (dslash_eo_pallas_post_mrhs,
// dslash_eo_pallas_diag_hop_mrhs): clover blocks, the twist epilogues and
// the block-free forms.  Plain versions: quda_tpu_torch/ops/
// clover_pallas.py::dslash_eo_post_mrhs_plain and
// dslash_eo_diag_hop_mrhs_plain.  The 12-source clover, twisted-mass and
// twisted-clover batched operators (models/wilson.py) run it.
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
// twisted clover's K2: 10 instances.
//
// What bounds it on an H100: device memory.  Per target half-site the
// links (576 B, 384 with R = 2) and blocks (576 B, none without blocks)
// once, and N spinors in and out (192 N B; K2 reads x too, 288 N): at
// 32^3 x 64 and N = 12 a floor of 1.082 ms (K1 clover), 1.442 (K2
// clover), 0.902 / 1.262 (K1 / K2 twisted mass) at 3.35 TB/s.
// (1320 + 504 + 72) N flop against (192 N + 1152) B stays under 10
// flop/B, far under f32's ~20.
//
// Design: B5-eo's (wilson_eo_mrhs.cu) with the clover epilogue.  A block
// owns a tile of half-sites of one (t, z) plane of Y*Xh (the plane's last
// tile may be partial) and copies the tile's forward and pre-shifted
// backward links into shared memory once with cp.async (mrhs_tile.cuh);
// the forms with blocks copy the tile's chiral blocks beside them (576 B a
// half-site), so both leave device memory once for all N.  The block then
// loops over all N right-hand sides itself: its lanes x tile threads are
// lanes of a thread a half-site, lane l taking right-hand sides l,
// l + lanes, ... one at a time.  The hop is eo_hop_sum_from with the links
// from the tile (TileShifted), psi gathered through L1 and L2; the
// epilogue is clover_epilogue.cuh's with the blocks from the tile
// (TileBlocks), x read and out written per right-hand side in device
// memory.  So each right-hand side sees K1's or K2's arithmetic in its
// order (clover_eo.cu) and matches a K1 or K2 launch bit for bit.  Blocks
// walk the planes in boxes of kBoxZ z-planes across all t.  The forms with
// blocks and the block-free (twisted-mass) ones keep their own tile and
// lanes: the blocks double the tile's shared memory.  These were chosen by
// timing variants on the card (chip_profile.py mrhs_variants clover;
// PERF.md), where two right-hand sides a thread (215-242 registers, one
// block an SM) and blocks read through L1 by each lane instead of staged
// ran slower.  The earlier design, a thread a half-site and chunk of 2
// with the chunk index fastest across the grid, read each link and block
// once a chunk and ran at 24-43% of the floor.  Offsets are 64-bit.
#include "clover_epilogue.cuh"
#include "mrhs_tile.cuh"

namespace {

using namespace qtt;

// the forms with blocks (clover K1/K2, twisted clover's K2): half-sites a
// tile and threads a half-site
constexpr int kTileBlk = 64;
constexpr int kLanesBlk = 4;
// the block-free forms (twisted mass): B5-eo's plan
constexpr int kTileFree = 128;
constexpr int kLanesFree = 2;
constexpr int kMinBlocks = 2;    // resident blocks an SM (launch bound)
constexpr int kBoxZ = 4;         // z-planes of a box of the block order
constexpr size_t kMaxSmemPerBlock = 232448;  // an H100 block's 227 KB

template <bool BLK>
struct Shape {
  static constexpr int tile = BLK ? kTileBlk : kTileFree;
  static constexpr int lanes = BLK ? kLanesBlk : kLanesFree;
  static constexpr int threads = lanes * tile;
};

// Mirrored by quda_tpu_torch/ops/clover_pallas.py::k_mrhs_plan: the
// tile's links are 2 * 24 R floats a half-site, its blocks 144 more
// (tile_plan's two sets of 24 R + 72 planes).
TilePlan k_mrhs_plan(int T, int Z, int Y, int Xh, int rows, bool with_blk) {
  return tile_plan(T, Z, static_cast<int64_t>(Y) * Xh,
                   with_blk ? kTileBlk : kTileFree,
                   24 * rows + (with_blk ? 72 : 0));
}

template <int R, int VEC, bool DIAG_HOP, bool BLK, bool TWIST>
__global__ void __launch_bounds__(Shape<BLK>::threads, kMinBlocks)
    clover_eo_mrhs_kernel(float* __restrict__ out,
                          const float* __restrict__ psi,
                          const float* __restrict__ u_here,
                          const float* __restrict__ u_bw,
                          const float* __restrict__ blk,
                          const float* __restrict__ xc, int T, int Z, int Y,
                          int Xh, int parity, int tb_sign, float coeff,
                          float tw_c, float tw_scale, int nrhs, int tiles) {
  static_assert(BLK || TWIST, "an epilogue needs blocks or a twist");
  using Sh = Shape<BLK>;
  extern __shared__ __align__(16) float sh[];
  constexpr int kP = 4 * R * 3 * 2;             // link planes of a set
  const int64_t YXh = static_cast<int64_t>(Y) * Xh;
  const int64_t ZYXh = static_cast<int64_t>(Z) * YXh;
  const int64_t n = static_cast<int64_t>(T) * ZYXh;
  const int64_t rstride = 24 * n;

  int t, z, j;
  block_tile<kBoxZ>(blockIdx.x, tiles, T, Z, t, z, j);
  const int64_t start = (static_cast<int64_t>(t) * Z + z) * YXh +
                        static_cast<int64_t>(j) * Sh::tile;
  const int len = static_cast<int>(min64(Sh::tile, YXh - j * Sh::tile));
  float* const sh_blk = sh + 2 * kP * Sh::tile;
  if constexpr (BLK) {  // the blocks' two chiralities, 72 planes each
    copy_sets<72, VEC, Sh::threads>(sh_blk, blk, blk + 72 * n, n, start,
                                    len, Sh::tile);
  }
  stage_links<kP, VEC, Sh::threads>(sh, u_here, u_bw, n, start, len,
                                    Sh::tile);

  const int i = threadIdx.x % Sh::tile;
  const int lane = threadIdx.x / Sh::tile;
  const int64_t site = start + i;
  const TileShifted<R> links{sh, sh + kP * Sh::tile, Sh::tile, i};
  const TileBlocks blocks{sh_blk, Sh::tile, i};
  // (no early return for i >= len: B5 spilled in that loop shape)
  for (int base = 0; base < nrhs; base += Sh::lanes) {
    const int r = base + lane;
    if (i >= len || r >= nrhs) continue;
    const int64_t off = r * rstride;
    float2 acc[1][4][3];
    eo_hop_sum_from(acc, psi + off, rstride, 1, links, T, Z, Y, Xh, YXh,
                    ZYXh, n, parity, tb_sign, site);
    clover_epilogue<float, float, DIAG_HOP, BLK, TWIST>(
        out + off, acc[0], blocks, DIAG_HOP ? xc + off : xc, n, site, coeff,
        tw_c, tw_scale);
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
  int nrhs;
  TilePlan plan;
  bool vec4;
  cudaStream_t stream;
};

template <int R, int VEC, bool DIAG_HOP, bool BLK, bool TWIST>
cudaError_t launch_vec(const Args& a) {
  const cudaError_t err =
      tile_smem(clover_eo_mrhs_kernel<R, VEC, DIAG_HOP, BLK, TWIST>, a.plan);
  if (err != cudaSuccess) return err;
  clover_eo_mrhs_kernel<R, VEC, DIAG_HOP, BLK, TWIST>
      <<<static_cast<unsigned>(a.plan.blocks), Shape<BLK>::threads,
         a.plan.smem, a.stream>>>(
      static_cast<float*>(a.out), static_cast<const float*>(a.psi),
      static_cast<const float*>(a.u_here), static_cast<const float*>(a.u_bw),
      static_cast<const float*>(a.blk), static_cast<const float*>(a.xc), a.T,
      a.Z, a.Y, a.Xh, a.parity, a.tb_sign, a.coeff, a.tw_c, a.tw_scale,
      a.nrhs, static_cast<int>(a.plan.tiles));
  return cudaGetLastError();
}

// The instance's launch (query: its resources at the 16-byte-copy
// instance).
template <int R, bool DIAG_HOP, bool BLK, bool TWIST>
cudaError_t launch(const Args& a, int* info) {
  if (info != nullptr) {
    return tile_info(clover_eo_mrhs_kernel<R, 4, DIAG_HOP, BLK, TWIST>,
                     Shape<BLK>::threads, a.plan, info);
  }
  return a.vec4 ? launch_vec<R, 4, DIAG_HOP, BLK, TWIST>(a)
                : launch_vec<R, 1, DIAG_HOP, BLK, TWIST>(a);
}

// K1's twist is block-free (twisted mass; the twisted clover folds its
// twist into K1's blocks), so K1 has no (blocks, twist) instance
template <int R, bool DIAG_HOP>
cudaError_t launch_epi(bool with_blk, bool twist, const Args& a, int* info) {
  if (!twist) return launch<R, DIAG_HOP, true, false>(a, info);
  if (!with_blk) return launch<R, DIAG_HOP, false, true>(a, info);
  if constexpr (DIAG_HOP) {
    return launch<R, DIAG_HOP, true, true>(a, info);
  } else {
    return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(int rows, bool diag_hop, bool with_blk, bool twist,
                     const Args& a, int* info) {
  if (rows == 3) {
    return diag_hop ? launch_epi<3, true>(with_blk, twist, a, info)
                    : launch_epi<3, false>(with_blk, twist, a, info);
  }
  return diag_hop ? launch_epi<2, true>(with_blk, twist, a, info)
                  : launch_epi<2, false>(with_blk, twist, a, info);
}

// the checks both entries share: the lattice, form and plan
bool valid(int T, int Z, int Y, int Xh, int rows, int with_blk, int twist,
           const TilePlan& p) {
  return T > 0 && Z > 0 && Y > 0 && Xh > 0 && (rows == 2 || rows == 3) &&
         (with_blk || twist) && p.blocks <= 0x7fffffff &&
         p.smem <= kMaxSmemPerBlock;
}

}  // namespace

// All float32.  rows: 3 or 2; diag_hop: 0 = K1 (xc and coeff unused), 1 =
// K2 (xc required); with_blk, twist, tw_c, tw_scale: the epilogue, as for
// qtt_clover_eo; nrhs: the batch's right-hand sides.  A grid of more than
// 2^31 - 1 blocks or a plan above a block's 227 KB of shared memory is
// refused.
extern "C" int qtt_clover_eo_mrhs(void* out, const void* psi,
                                  const void* u_here, const void* u_bw,
                                  const void* blk, const void* xc, int T,
                                  int Z, int Y, int Xh, int parity, int rows,
                                  int tb_sign, int diag_hop, float coeff,
                                  int with_blk, int twist, float tw_c,
                                  float tw_scale, int nrhs, void* stream) {
  const TilePlan p = k_mrhs_plan(T, Z, Y, Xh, rows, with_blk != 0);
  if (!valid(T, Z, Y, Xh, rows, with_blk, twist, p) || nrhs <= 0 ||
      (parity != 0 && parity != 1) || (with_blk && blk == nullptr) ||
      (diag_hop && xc == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t yxh = static_cast<int64_t>(Y) * Xh;
  const bool v4 = tile_vec4(u_here, u_bw, yxh) &&
                  (reinterpret_cast<uintptr_t>(blk) & 15) == 0;
  const Args a{out, psi, u_here, u_bw, blk, xc, T, Z, Y, Xh, parity,
               tb_sign, coeff, tw_c, tw_scale, nrhs, p, v4,
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(
      dispatch(rows, diag_hop != 0, with_blk != 0, twist != 0, a, nullptr));
}

// K1/K2-mrhs's resources at (T, Z, Y, Xh, rows) for the form (diag_hop,
// with_blk, twist), for a report (the 16-byte-copy instance): info[0]
// ptxas registers a thread, [1] dynamic shared memory a block (bytes), [2]
// resident blocks an SM, [3] threads a block, [4] tiles a (t, z) plane,
// [5] blocks.
extern "C" int qtt_clover_eo_mrhs_info(int T, int Z, int Y, int Xh,
                                       int rows, int diag_hop, int with_blk,
                                       int twist, int* info) {
  const TilePlan p = k_mrhs_plan(T, Z, Y, Xh, rows, with_blk != 0);
  if (!valid(T, Z, Y, Xh, rows, with_blk, twist, p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{};
  a.plan = p;
  return static_cast<int>(
      dispatch(rows, diag_hop != 0, with_blk != 0, twist != 0, a, info));
}
