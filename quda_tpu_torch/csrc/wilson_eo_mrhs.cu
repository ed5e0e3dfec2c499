// Multi-RHS even/odd Wilson hop D_{p <- 1-p} on the packed pair layout
// (kernel B5-eo): the hop of B1 (wilson_eo.cu) over N right-hand sides,
// each link read from device memory once for all of them.
//
// Replaces: quda_tpu/ops/wilson_pallas_packed.py::
// dslash_eo_pallas_packed_mrhs, the Pallas TPU kernel (pallas_call at :613;
// B1's body _make_kernel(eo=...) under _mrhs_wrap, :504, on a (T, nzb, N)
// grid whose gauge index maps ignore n).  Plain version:
// quda_tpu_torch/ops/wilson_pallas_packed.py::dslash_eo_packed_mrhs_plain.
// The 12-source Wilson and clover batched operators (models/wilson.py) and
// the domain-wall family's 4d hop, with Ls (Möbius) or Ls/2 (5d PC) as the
// batch (ops/dwf_pallas.py), run it.
//
// Layout: psi, out (N, 4, 3, 2, T, Z, Y*Xh), right-hand sides 24 * S
// elements apart (S = T*Z*Y*Xh half-sites); links as in wilson_hop.cuh.
// Storage forms: float32 psi, links and out; R = 3 link rows (full) or
// R = 2 (reconstruct-12, with tb_sign as in B1).  Sums are f32.
//
// What bounds it on an H100: device memory.  Per target half-site, N
// spinors in and out (192 N bytes in f32, when L2 serves the neighbour
// re-reads) and the links once (576 B, or 384 with R = 2): at 32^3 x 64 a
// floor of 0.902 ms at N = 12 and 0.541 ms at N = 6 (R = 3; 0.841 and
// 0.481 with R = 2) at 3.35 TB/s.  1320 N flop against (192 N + 576) B is
// at most 6.9 flop/B, far under the ~20 flop/B where f32 arithmetic binds.
//
// Design: B5's (wilson_full.cu) on the half lattice.  A block owns a tile
// of kTile half-sites of one (t, z) plane of Y*Xh (the plane's last tile
// may be partial), copies the tile's forward and pre-shifted backward
// links into shared memory once with cp.async (mrhs_tile.cuh: 576 B a
// half-site at R = 3, 384 at R = 2), and loops over all N right-hand
// sides itself.  Its kLanes x kTile threads are kLanes lanes of a thread a
// half-site: lane l takes right-hand sides l NB, l NB + kLanes NB, ... in
// chunks of NB (1 or 2; a tail chunk reads and writes only the sides that
// exist).  The hop is eo_hop_sum_from of wilson_hop.cuh with the links
// from the tile's copy (TileShifted) and psi gathered through L1 and L2,
// so each right-hand side sees B1's arithmetic in B1's order and matches
// a B1 launch bit for bit.  Blocks walk the planes in boxes of kBoxZ
// z-planes across all t (mrhs_tile.cuh).  The tile, lanes, box depth and
// default chunk were chosen by timing variants on the card
// (chip_profile.py mrhs_variants; PERF.md).  The earlier design, a thread
// a half-site and chunk with the chunk index fastest across the grid, read
// each link once a chunk and ran at 34% of the floor.  Offsets are 64-bit
// (a 12-RHS batch at 32^3 x 64 is 302 M elements).
#include "mrhs_tile.cuh"
#include "wilson_hop.cuh"

namespace {

using namespace qtt;

constexpr int kTile = 128;       // half-sites a block
constexpr int kLanes = 2;        // threads a half-site
constexpr int kBoxZ = 4;         // z-planes of a box of the block order
constexpr int kMinBlocks = 2;    // resident blocks an SM at NB = 1

// Mirrored by quda_tpu_torch/ops/wilson_pallas_packed.py::eo_mrhs_plan:
// the tile's links are 2 * 24 R floats a half-site.
TilePlan eo_mrhs_plan(int T, int Z, int Y, int Xh, int rows) {
  return tile_plan(T, Z, static_cast<int64_t>(Y) * Xh, kTile, 24 * rows);
}

// kMinBlocks blocks an SM at NB = 1 (at most 65536 / (kMinBlocks x 256)
// registers a thread), one at NB = 2
template <int R, int NB, int VEC>
__global__ void __launch_bounds__(kLanes * kTile, NB == 1 ? kMinBlocks : 1)
    wilson_eo_mrhs_kernel(float* __restrict__ out,
                          const float* __restrict__ psi,
                          const float* __restrict__ u_here,
                          const float* __restrict__ u_bw, int T, int Z,
                          int Y, int Xh, int parity, int tb_sign, int nrhs,
                          int tiles) {
  extern __shared__ __align__(16) float sh[];
  constexpr int kP = 4 * R * 3 * 2;             // link planes of a set
  const int64_t YXh = static_cast<int64_t>(Y) * Xh;
  const int64_t ZYXh = static_cast<int64_t>(Z) * YXh;
  const int64_t n = static_cast<int64_t>(T) * ZYXh;
  const int64_t rstride = 24 * n;

  int t, z, j;
  block_tile<kBoxZ>(blockIdx.x, tiles, T, Z, t, z, j);
  const int64_t start = (static_cast<int64_t>(t) * Z + z) * YXh +
                        static_cast<int64_t>(j) * kTile;
  const int len = static_cast<int>(min64(kTile, YXh - j * kTile));
  stage_links<kP, VEC, kLanes * kTile>(sh, u_here, u_bw, n, start, len,
                                       kTile);

  const int i = threadIdx.x % kTile;
  const int lane = threadIdx.x / kTile;
  const int64_t site = start + i;
  const TileShifted<R> links{sh, sh + kP * kTile, kTile, i};
  // (no early return for i >= len: B5 spilled in that loop shape)
  for (int base = 0; base < nrhs; base += kLanes * NB) {
    const int r0 = base + lane * NB;
    if (i >= len || r0 >= nrhs) continue;
    const int nvalid = min(NB, nrhs - r0);
    float2 acc[NB][4][3];
    eo_hop_sum_from(acc, psi + r0 * rstride, rstride, nvalid, links, T, Z, Y,
                    Xh, YXh, ZYXh, n, parity, tb_sign, site);
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
}

template <int R, int NB, int VEC>
cudaError_t launch(void* out, const void* psi, const void* u_here,
                   const void* u_bw, int T, int Z, int Y, int Xh, int parity,
                   int tb_sign, int nrhs, const TilePlan& p,
                   cudaStream_t stream) {
  const cudaError_t err = tile_smem(wilson_eo_mrhs_kernel<R, NB, VEC>, p);
  if (err != cudaSuccess) return err;
  wilson_eo_mrhs_kernel<R, NB, VEC>
      <<<static_cast<unsigned>(p.blocks), kLanes * kTile, p.smem, stream>>>(
          static_cast<float*>(out), static_cast<const float*>(psi),
          static_cast<const float*>(u_here), static_cast<const float*>(u_bw),
          T, Z, Y, Xh, parity, tb_sign, nrhs, static_cast<int>(p.tiles));
  return cudaGetLastError();
}

template <int R, int NB>
cudaError_t launch_vec(bool vec4, void* out, const void* psi,
                       const void* u_here, const void* u_bw, int T, int Z,
                       int Y, int Xh, int parity, int tb_sign, int nrhs,
                       const TilePlan& p, cudaStream_t stream) {
  return vec4 ? launch<R, NB, 4>(out, psi, u_here, u_bw, T, Z, Y, Xh, parity,
                                 tb_sign, nrhs, p, stream)
              : launch<R, NB, 1>(out, psi, u_here, u_bw, T, Z, Y, Xh, parity,
                                 tb_sign, nrhs, p, stream);
}

}  // namespace

// All float32.  rows: 3 or 2; nrhs: the batch's right-hand sides; nb: the
// chunk width, 1 or 2.  A grid of more than 2^31 - 1 blocks is refused.
extern "C" int qtt_wilson_eo_mrhs(void* out, const void* psi,
                                  const void* u_here, const void* u_bw,
                                  int T, int Z, int Y, int Xh, int parity,
                                  int rows, int tb_sign, int nrhs, int nb,
                                  void* stream) {
  const int64_t n = static_cast<int64_t>(T) * Z * Y * Xh;
  if (T <= 0 || Z <= 0 || Y <= 0 || Xh <= 0 || n <= 0 || nrhs <= 0 ||
      (nb != 1 && nb != 2) || (parity != 0 && parity != 1) ||
      (rows != 2 && rows != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const TilePlan p = eo_mrhs_plan(T, Z, Y, Xh, rows);
  if (p.blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const bool v4 = tile_vec4(u_here, u_bw, static_cast<int64_t>(Y) * Xh);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (rows == 3) {
    err = nb == 1 ? launch_vec<3, 1>(v4, out, psi, u_here, u_bw, T, Z, Y, Xh,
                                     parity, tb_sign, nrhs, p, s)
                  : launch_vec<3, 2>(v4, out, psi, u_here, u_bw, T, Z, Y, Xh,
                                     parity, tb_sign, nrhs, p, s);
  } else {
    err = nb == 1 ? launch_vec<2, 1>(v4, out, psi, u_here, u_bw, T, Z, Y, Xh,
                                     parity, tb_sign, nrhs, p, s)
                  : launch_vec<2, 2>(v4, out, psi, u_here, u_bw, T, Z, Y, Xh,
                                     parity, tb_sign, nrhs, p, s);
  }
  return static_cast<int>(err);
}

// B5-eo's resources at (T, Z, Y, Xh, rows, nb), for a report (the
// 16-byte-copy instance): info[0] ptxas registers a thread, [1] dynamic
// shared memory a block (bytes), [2] resident blocks an SM, [3] threads a
// block, [4] tiles a (t, z) plane, [5] blocks.
extern "C" int qtt_wilson_eo_mrhs_info(int T, int Z, int Y, int Xh,
                                       int rows, int nb, int* info) {
  if (T <= 0 || Z <= 0 || Y <= 0 || Xh <= 0 || (nb != 1 && nb != 2) ||
      (rows != 2 && rows != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const TilePlan p = eo_mrhs_plan(T, Z, Y, Xh, rows);
  constexpr int th = kLanes * kTile;
  cudaError_t err;
  if (rows == 3) {
    err = nb == 1 ? tile_info(wilson_eo_mrhs_kernel<3, 1, 4>, th, p, info)
                  : tile_info(wilson_eo_mrhs_kernel<3, 2, 4>, th, p, info);
  } else {
    err = nb == 1 ? tile_info(wilson_eo_mrhs_kernel<2, 1, 4>, th, p, info)
                  : tile_info(wilson_eo_mrhs_kernel<2, 2, 4>, th, p, info);
  }
  return static_cast<int>(err);
}
