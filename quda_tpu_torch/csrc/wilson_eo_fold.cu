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
// with tb_sign); the multi-RHS hop float32 with R = 3 or 2, one
// right-hand side a thread at a time.  Every sum is f32.
//
// What bounds them on an H100: device memory, as B1 and B5-eo: 768 B a
// half-site in f32 (384 bf16 -> bf16) for 1320 flop; (192 N + 576) B for
// 1320 N flop with N right-hand sides (0.902 ms at N = 12, 32^3 x 64, R =
// 3; 0.841 at R = 2).
//
// Design of the single-RHS hop: B1's threads (one per target half-site)
// running wilson_hop.cuh's eo hop with the FoldLayout accessor: the hop
// body, its loads and its order of sums are B1's, so each output equals
// B1's on the unfolded operands bit for bit.  A thread places each
// neighbour from the neighbour's own row: x and y neighbours share the
// target's row, a z neighbour is two folded rows away and a t neighbour
// 2Z rows.  The real and imaginary parts of a number now lie YXh apart,
// in one row pair, where the pair layout puts them a plane apart.
//
// Design of the multi-RHS hop: B5-eo's (wilson_eo_mrhs.cu) through
// mrhs_tile.cuh.  A block owns a tile of kTile half-sites of one (t, z)
// row, copies the tile's forward and pre-shifted backward links into
// shared memory once with cp.async, in the [2][24 R][tile] order that
// TileShifted reads (the copy's address hook FoldPlanes: component c's
// real run of the tile starts at c 2n + 2r YXh + j kTile, r = t Z + z, its
// imaginary run YXh further on), and loops over all N right-hand sides
// itself; its kLanes lanes of a thread a half-site take the right-hand
// sides one at a time.  psi is gathered through FoldLayout, so each lane
// is the single-RHS fold hop bit for bit.  Blocks walk the rows in boxes
// of kBoxZ z-planes across t.  The tile, lanes and box depth are B5-eo's,
// timed again on this layout (chip_profile.py mrhs_variants ... fold;
// PERF.md: two right-hand sides a thread ran 20% slower).  Offsets are
// 64-bit.
#include "mrhs_tile.cuh"
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

// The multi-RHS hop's plan: B5-eo's tile, lanes and box depth.
constexpr int kTile = 128;       // half-sites a block
constexpr int kLanes = 2;        // threads a half-site
constexpr int kBoxZ = 4;         // z-planes of a box of the block order
constexpr int kMinBlocks = 2;    // resident blocks an SM

// Mirrored by quda_tpu_torch/ops/wilson_pallas_packed.py::fold_mrhs_plan:
// the tile's links are 2 * 24 R floats a half-site.
TilePlan fold_mrhs_plan(int T, int Z, int Y, int Xh, int rows) {
  return tile_plan(T, Z, static_cast<int64_t>(Y) * Xh, kTile, 24 * rows);
}

template <int R, int VEC>
__global__ void __launch_bounds__(kLanes * kTile, kMinBlocks)
    wilson_eo_fold_mrhs_kernel(float* __restrict__ out,
                               const float* __restrict__ psi,
                               const float* __restrict__ u_here,
                               const float* __restrict__ u_bw, int T, int Z,
                               int Y, int Xh, int parity, int tb_sign,
                               int nrhs, int tiles) {
  extern __shared__ __align__(16) float sh[];
  constexpr int kP = 4 * R * 3 * 2;             // link planes of a set
  const int64_t YXh = static_cast<int64_t>(Y) * Xh;
  const int64_t ZYXh = static_cast<int64_t>(Z) * YXh;
  const int64_t n = static_cast<int64_t>(T) * ZYXh;
  const int64_t rstride = 24 * n;
  const FoldLayout lay{YXh};

  int t, z, j;
  block_tile<kBoxZ>(blockIdx.x, tiles, T, Z, t, z, j);
  const int64_t row = static_cast<int64_t>(t) * Z + z;
  const int64_t start = row * YXh + static_cast<int64_t>(j) * kTile;
  const int len = static_cast<int>(min64(kTile, YXh - j * kTile));
  stage_links<kP, VEC, kLanes * kTile>(sh, u_here, u_bw, FoldPlanes{n, YXh},
                                       lay.at(start, row), len, kTile);

  const int i = threadIdx.x % kTile;
  const int lane = threadIdx.x / kTile;
  const int64_t site = start + i;
  const TileShifted<R> links{sh, sh + kP * kTile, kTile, i};
  // (no early return for i >= len: B5 spilled in that loop shape)
  for (int base = 0; base < nrhs; base += kLanes) {
    const int r = base + lane;
    if (i >= len || r >= nrhs) continue;
    const int64_t off = r * rstride;
    float2 acc[1][4][3];
    const int64_t a = eo_hop_sum_from(acc, psi + off, rstride, 1, links, T,
                                      Z, Y, Xh, YXh, ZYXh, n, parity,
                                      tb_sign, site, lay);
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float* q = out + off + static_cast<int64_t>((s * 3 + c) * 2) * n + a;
        q[0] = acc[0][s][c].x;
        q[YXh] = acc[0][s][c].y;
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

template <int R, int VEC>
cudaError_t launch_mrhs(void* out, const void* psi, const void* u_here,
                        const void* u_bw, int T, int Z, int Y, int Xh,
                        int parity, int tb_sign, int nrhs, const TilePlan& p,
                        cudaStream_t stream) {
  const cudaError_t err = tile_smem(wilson_eo_fold_mrhs_kernel<R, VEC>, p);
  if (err != cudaSuccess) return err;
  wilson_eo_fold_mrhs_kernel<R, VEC>
      <<<static_cast<unsigned>(p.blocks), kLanes * kTile, p.smem, stream>>>(
          static_cast<float*>(out), static_cast<const float*>(psi),
          static_cast<const float*>(u_here), static_cast<const float*>(u_bw),
          T, Z, Y, Xh, parity, tb_sign, nrhs, static_cast<int>(p.tiles));
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_mrhs_vec(bool vec4, void* out, const void* psi,
                            const void* u_here, const void* u_bw, int T,
                            int Z, int Y, int Xh, int parity, int tb_sign,
                            int nrhs, const TilePlan& p,
                            cudaStream_t stream) {
  return vec4 ? launch_mrhs<R, 4>(out, psi, u_here, u_bw, T, Z, Y, Xh,
                                  parity, tb_sign, nrhs, p, stream)
              : launch_mrhs<R, 1>(out, psi, u_here, u_bw, T, Z, Y, Xh,
                                  parity, tb_sign, nrhs, p, stream);
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

// All float32.  rows: 3 or 2; nrhs: the batch's right-hand sides.  A grid
// of more than 2^31 - 1 blocks is refused.
extern "C" int qtt_wilson_eo_fold_mrhs(void* out, const void* psi,
                                       const void* u_here, const void* u_bw,
                                       int T, int Z, int Y, int Xh,
                                       int parity, int rows, int tb_sign,
                                       int nrhs, void* stream) {
  const int64_t n = static_cast<int64_t>(T) * Z * Y * Xh;
  if (T <= 0 || Z <= 0 || Y <= 0 || Xh <= 0 || n <= 0 || nrhs <= 0 ||
      (parity != 0 && parity != 1) || (rows != 2 && rows != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const TilePlan p = fold_mrhs_plan(T, Z, Y, Xh, rows);
  if (p.blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const bool v4 = tile_vec4(u_here, u_bw, static_cast<int64_t>(Y) * Xh);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      rows == 3 ? launch_mrhs_vec<3>(v4, out, psi, u_here, u_bw, T, Z, Y, Xh,
                                     parity, tb_sign, nrhs, p, s)
                : launch_mrhs_vec<2>(v4, out, psi, u_here, u_bw, T, Z, Y, Xh,
                                     parity, tb_sign, nrhs, p, s);
  return static_cast<int>(err);
}

// The multi-RHS hop's resources at (T, Z, Y, Xh, rows), for a report (the
// 16-byte-copy instance): info[0] ptxas registers a thread, [1] dynamic
// shared memory a block (bytes), [2] resident blocks an SM, [3] threads a
// block, [4] tiles a (t, z) row, [5] blocks.
extern "C" int qtt_wilson_eo_fold_mrhs_info(int T, int Z, int Y, int Xh,
                                            int rows, int* info) {
  if (T <= 0 || Z <= 0 || Y <= 0 || Xh <= 0 || (rows != 2 && rows != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const TilePlan p = fold_mrhs_plan(T, Z, Y, Xh, rows);
  constexpr int th = kLanes * kTile;
  const cudaError_t err =
      rows == 3 ? tile_info(wilson_eo_fold_mrhs_kernel<3, 4>, th, p, info)
                : tile_info(wilson_eo_fold_mrhs_kernel<2, 4>, th, p, info);
  return static_cast<int>(err);
}
