// Full-lattice staggered hops on the packed pair layout: the gather pass
// (kernel S2-full), its multi-RHS form (S2-mrhs-full) and the fused fat +
// Naik hop (S1-full).  They are the full-lattice forms of the even/odd
// kernels of staggered_eo.cu and staggered_eo_mrhs.cu, on the same hop
// body (staggered_hop.cuh) with the full-lattice site rule (full_site,
// FullSite), so every lane and every form keeps the eo forms' arithmetic
// in their order.
//
// S2-full replaces quda_tpu/ops/staggered_pallas.py::_stag_pass, full
// lattice (pallas_call at :204, through dslash_staggered_pallas at :219;
// body _make_stag_kernel with eo None).  Plain version:
// quda_tpu_torch/ops/staggered_pallas.py::dslash_staggered_pass_plain.
// One hop set of count NHOP (1: fat, 3: Naik), with U_bw,mu(x) =
// U_mu(x - n mu) the pre-shifted backward links of backward_links:
//   out(x) = sum_mu 1/2 [U_mu(x) psi(x + n mu) - U_bw,mu(x)^dag psi(x - n mu)]
//
// S2-mrhs-full replaces _stag_pass_mrhs, full lattice (pallas_call at
// :1106, through dslash_staggered_pallas_mrhs at :1121).  Plain version:
// ops/staggered_pallas.py::dslash_staggered_pass_mrhs_plain.  The pass
// above over N right-hand sides, each link read from device memory once
// for all of them; with ACCUM it adds into out at the store (the improved
// operator's Naik pass on top of the fat pass: one IEEE addition,
// __fadd_rn, so fat + naik equals S1-full's sum bit for bit).  The
// staggered multigrid's null-vector solve runs it (mg/pair.py).
//
// S1-full replaces _stag_fused_call, full lattice (pallas_call at :966,
// through dslash_staggered_pallas_fused at :980; body
// _make_stag_kernel_fused).  Plain version:
// ops/staggered_pallas.py::dslash_staggered_fused_plain.
//   out(x) = sum_mu sum_{n in 1,3} 1/2 [U^n_mu(x) psi(x + n mu)
//                                      - U^n_mu(x - n mu)^dag psi(x - n mu)]
// with U^1 the fat and U^3 the long links.  The backward links are read
// unshifted at the backward neighbour's index of the same arrays: no
// backward copy exists.  The fat and Naik sets go into separate
// accumulators summed at the store, as the TPU kernel and S1 do.
//
// Layout: psi, out (3, 2, T, Z, Y*X), N of them (N, 3, 2, T, Z, Y*X) for
// the multi-RHS form; links (4, 3, 3, 2, T, Z, Y*X), KS phases and the
// antiperiodic t boundary folded in (the long links' on the last three t
// planes), so no kernel applies a sign.  All float32, full (18-real)
// links: the multigrid and the operator API build them so, and recon-12
// staggered links are refused (ROADMAP C).
//
// What bounds them on an H100: device memory.  Per site S2-full reads
// two link sets (576 B) and psi (24 B) and writes out (24 B): 624 B for
// 570 flop; S1-full reads each link set once (fat and long, 576 B): 624
// B for 1146 flop; S2-mrhs-full 48 N + 576 B for 570 N flop (an
// accumulating pass reads out too, + 24 N).  All are under 2 flop/B, far
// below the ~20 flop/B where f32 arithmetic binds.  At 32^3 x 64 the
// S2-full and S1-full floors are 0.391 ms, S2-mrhs-full at N = 24 1.082
// ms.
//
// Design of S2-full and S1-full: the eo kernels', on the full lattice.
// One thread per site, three or six f32 complex accumulators.  Each
// thread computes its neighbour indices directly (site_neighbour): an x
// hop wraps inside its row of X sites of the fused Y*X axis, never into
// the next y; y, z and t move their own plane.  The TPU kernel's z-block
// tiles, boundary-row splices and roll network have no counterpart.
// Neighbour spinors come through L1/L2.  Offsets are 64-bit.
//
// Design of S2-mrhs-full: B5's (wilson_full.cu).  A block owns a tile of
// kMrhsTile sites of one (t, z) plane (the plane's last tile may be
// partial), copies the tile's forward and pre-shifted backward links (2 x
// 72 floats, 576 B a site) into shared memory once with cp.async
// (mrhs_tile.cuh) and loops over all N right-hand sides itself: kMrhsLanes
// lanes of a thread a site, each taking kMrhsNB right-hand sides at a time
// (a tail chunk reads and writes only the sides that exist).  The hop is
// stag_hopset with the TileShifted link source, so each lane is an
// S2-full launch bit for bit.  Blocks walk the planes in boxes of
// kMrhsBoxZ z-planes across all t (mrhs_tile.cuh).  The tile, lanes,
// chunk and box depth were chosen by timing variants on the card
// (chip_profile.py mrhs_variants; PERF.md): a 64-site tile and four
// lanes of one right-hand side each ran fastest; wider chunks (2, 4, 8),
// fewer lanes and 128- or 256-site tiles ran slower (a staggered spinor
// is 24 B a site, so the gathers of N of them, not the arithmetic, fill
// the SM, and a smaller link tile leaves more of its 256 KB to L1).  The
// earlier design, a thread a site and chunk of 4 with the chunk index
// fastest across the grid, read each link once a chunk and ran at 34% of
// the floor.
#include "mrhs_tile.cuh"
#include "staggered_hop.cuh"

namespace {

using namespace qtt;

constexpr int kThreads = 128;      // S2-full and S1-full: a thread a site
constexpr int kMrhsTile = 64;      // S2-mrhs-full: sites a block,
constexpr int kMrhsLanes = 4;      //   threads a site,
constexpr int kMrhsNB = 1;         //   right-hand sides a thread at a time,
constexpr int kMrhsBoxZ = 4;       //   z-planes of a box of the block order,
constexpr int kMrhsMinBlocks = 2;  //   resident blocks an SM

struct FullDims {
  int T, Z, Y, X;
  int64_t YX, ZYX, n;
};

__device__ __forceinline__ FullDims full_dims(int T, int Z, int Y, int X) {
  FullDims d;
  d.T = T;
  d.Z = Z;
  d.Y = Y;
  d.X = X;
  d.YX = static_cast<int64_t>(Y) * X;
  d.ZYX = static_cast<int64_t>(Z) * d.YX;
  d.n = static_cast<int64_t>(T) * d.ZYX;
  return d;
}

template <int NHOP>
__global__ void __launch_bounds__(kThreads)
    stag_full_pass_kernel(float* __restrict__ out,
                          const float* __restrict__ psi,
                          const float* __restrict__ u,
                          const float* __restrict__ u_bw, int T, int Z,
                          int Y, int X) {
  const FullDims d = full_dims(T, Z, Y, X);
  const int64_t site = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (site >= d.n) return;
  const FullSite s = full_site(site, Z, Y, X, d.YX, d.ZYX);

  float2 acc[1][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) acc[0][c] = make_float2(0.f, 0.f);
  stag_hopset<NHOP>(acc, psi, 0, 1, Shifted<3, float>{u, u_bw}, s, T, Z, Y,
                    X, d.YX, d.ZYX, d.n);
  st_cvec(out, acc[0], d.n, site);
}

__global__ void __launch_bounds__(kThreads)
    stag_full_fused_kernel(float* __restrict__ out,
                           const float* __restrict__ psi,
                           const float* __restrict__ fat,
                           const float* __restrict__ lng, int T, int Z,
                           int Y, int X) {
  const FullDims d = full_dims(T, Z, Y, X);
  const int64_t site = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (site >= d.n) return;
  const FullSite s = full_site(site, Z, Y, X, d.YX, d.ZYX);

  float2 acc_fat[1][3], acc_lng[1][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    acc_fat[0][c] = make_float2(0.f, 0.f);
    acc_lng[0][c] = make_float2(0.f, 0.f);
  }
  stag_hopset<1>(acc_fat, psi, 0, 1, There<3, float>{fat, fat}, s, T, Z, Y,
                 X, d.YX, d.ZYX, d.n);
  stag_hopset<3>(acc_lng, psi, 0, 1, There<3, float>{lng, lng}, s, T, Z, Y,
                 X, d.YX, d.ZYX, d.n);
  float2 sum[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) sum[c] = cadd(acc_fat[0][c], acc_lng[0][c]);
  st_cvec(out, sum, d.n, site);
}

// S2-mrhs-full: a block owns a tile of kMrhsTile sites of one (t, z)
// plane, stages the tile's forward and pre-shifted backward links in
// shared memory once (mrhs_tile.cuh) and loops over all N right-hand
// sides: kMrhsLanes lanes of a thread a site, each lane kMrhsNB of them
// at a time.  kMrhsMinBlocks blocks an SM (at most 65536 / (kMinBlocks x
// 256) registers a thread).
template <int NHOP, bool ACCUM, int VEC>
__global__ void __launch_bounds__(kMrhsLanes * kMrhsTile, kMrhsMinBlocks)
    stag_full_pass_mrhs_kernel(float* __restrict__ out,
                               const float* __restrict__ psi,
                               const float* __restrict__ u,
                               const float* __restrict__ u_bw, int T, int Z,
                               int Y, int X, int nrhs, int tiles) {
  extern __shared__ __align__(16) float sh[];
  constexpr int kP = 4 * 3 * 3 * 2;             // link planes of a set
  const FullDims d = full_dims(T, Z, Y, X);
  const int64_t rstride = 6 * d.n;

  int t, z, j;
  block_tile<kMrhsBoxZ>(blockIdx.x, tiles, T, Z, t, z, j);
  const int64_t start = (static_cast<int64_t>(t) * Z + z) * d.YX +
                        static_cast<int64_t>(j) * kMrhsTile;
  const int len = static_cast<int>(min64(kMrhsTile, d.YX - j * kMrhsTile));
  stage_links<kP, VEC, kMrhsLanes * kMrhsTile>(sh, u, u_bw, d.n, start, len,
                                               kMrhsTile);

  const int i = threadIdx.x % kMrhsTile;
  const int lane = threadIdx.x / kMrhsTile;
  const int64_t site = start + i;
  const FullSite s = full_site(site, Z, Y, X, d.YX, d.ZYX);
  const TileShifted<3> links{sh, sh + kP * kMrhsTile, kMrhsTile, i};
  for (int base = 0; base < nrhs; base += kMrhsLanes * kMrhsNB) {
    const int r0 = base + lane * kMrhsNB;
    if (i >= len || r0 >= nrhs) continue;
    const int nvalid = min(kMrhsNB, nrhs - r0);
    float2 acc[kMrhsNB][3];
#pragma unroll
    for (int r = 0; r < kMrhsNB; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) acc[r][c] = make_float2(0.f, 0.f);
    stag_hopset<NHOP>(acc, psi + r0 * rstride, rstride, nvalid, links, s, T,
                      Z, Y, X, d.YX, d.ZYX, d.n);
#pragma unroll
    for (int r = 0; r < kMrhsNB; ++r) {
      if (r >= nvalid) break;
      float* o = out + (r0 + r) * rstride;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float* q = o + static_cast<int64_t>(2 * c) * d.n + site;
        if (ACCUM) {
          q[0] = __fadd_rn(q[0], acc[r][c].x);
          q[d.n] = __fadd_rn(q[d.n], acc[r][c].y);
        } else {
          q[0] = acc[r][c].x;
          q[d.n] = acc[r][c].y;
        }
      }
    }
  }
}

// grid blocks for n sites, or -1 for arguments the kernels do not take
int64_t grid_blocks(int T, int Z, int Y, int X) {
  const int64_t n = static_cast<int64_t>(T) * Z * Y * X;
  if (T <= 0 || Z <= 0 || Y <= 0 || X <= 0) return -1;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  return blocks > 0x7fffffff ? -1 : blocks;
}

// Mirrored by quda_tpu_torch/ops/staggered_pallas.py::full_mrhs_plan: the
// tile's links are 2 * 72 floats a site.
TilePlan full_mrhs_plan(int T, int Z, int Y, int X) {
  return tile_plan(T, Z, static_cast<int64_t>(Y) * X, kMrhsTile, 72);
}

template <int NHOP, bool ACCUM, int VEC>
cudaError_t launch_mrhs(void* out, const void* psi, const void* u,
                        const void* u_bw, int T, int Z, int Y, int X,
                        int nrhs, const TilePlan& p, cudaStream_t stream) {
  const cudaError_t err =
      tile_smem(stag_full_pass_mrhs_kernel<NHOP, ACCUM, VEC>, p);
  if (err != cudaSuccess) return err;
  stag_full_pass_mrhs_kernel<NHOP, ACCUM, VEC>
      <<<static_cast<unsigned>(p.blocks), kMrhsLanes * kMrhsTile, p.smem,
         stream>>>(static_cast<float*>(out), static_cast<const float*>(psi),
                   static_cast<const float*>(u),
                   static_cast<const float*>(u_bw), T, Z, Y, X, nrhs,
                   static_cast<int>(p.tiles));
  return cudaGetLastError();
}

template <int NHOP, bool ACCUM>
cudaError_t launch_mrhs_vec(bool vec4, void* out, const void* psi,
                            const void* u, const void* u_bw, int T, int Z,
                            int Y, int X, int nrhs, const TilePlan& p,
                            cudaStream_t stream) {
  return vec4 ? launch_mrhs<NHOP, ACCUM, 4>(out, psi, u, u_bw, T, Z, Y, X,
                                            nrhs, p, stream)
              : launch_mrhs<NHOP, ACCUM, 1>(out, psi, u, u_bw, T, Z, Y, X,
                                            nrhs, p, stream);
}

}  // namespace

// S2-full.  nhop: 1 (fat) or 3 (Naik); all float32.
extern "C" int qtt_staggered_full_pass(void* out, const void* psi,
                                       const void* u, const void* u_bw,
                                       int T, int Z, int Y, int X, int nhop,
                                       void* stream) {
  const int64_t blocks = grid_blocks(T, Z, Y, X);
  if (blocks < 0 || (nhop != 1 && nhop != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned nb = static_cast<unsigned>(blocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nhop == 1) {
    stag_full_pass_kernel<1><<<nb, kThreads, 0, s>>>(
        static_cast<float*>(out), static_cast<const float*>(psi),
        static_cast<const float*>(u), static_cast<const float*>(u_bw), T, Z,
        Y, X);
  } else {
    stag_full_pass_kernel<3><<<nb, kThreads, 0, s>>>(
        static_cast<float*>(out), static_cast<const float*>(psi),
        static_cast<const float*>(u), static_cast<const float*>(u_bw), T, Z,
        Y, X);
  }
  return static_cast<int>(cudaGetLastError());
}

// S1-full: fat and long links unshifted; all float32.
extern "C" int qtt_staggered_full_fused(void* out, const void* psi,
                                        const void* fat, const void* lng,
                                        int T, int Z, int Y, int X,
                                        void* stream) {
  const int64_t blocks = grid_blocks(T, Z, Y, X);
  if (blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  stag_full_fused_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), static_cast<const float*>(psi),
      static_cast<const float*>(fat), static_cast<const float*>(lng), T, Z,
      Y, X);
  return static_cast<int>(cudaGetLastError());
}

// S2-mrhs-full.  nhop: 1 or 3; accum: add into out (else overwrite it);
// nrhs right-hand sides; all float32.  A grid of more than 2^31 - 1
// blocks is refused.
extern "C" int qtt_staggered_full_pass_mrhs(void* out, const void* psi,
                                            const void* u, const void* u_bw,
                                            int T, int Z, int Y, int X,
                                            int nhop, int accum, int nrhs,
                                            void* stream) {
  if (T <= 0 || Z <= 0 || Y <= 0 || X <= 0 || nrhs <= 0 ||
      (nhop != 1 && nhop != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const TilePlan p = full_mrhs_plan(T, Z, Y, X);
  if (p.blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const bool v4 = tile_vec4(u, u_bw, static_cast<int64_t>(Y) * X);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (nhop == 1) {
    err = accum ? launch_mrhs_vec<1, true>(v4, out, psi, u, u_bw, T, Z, Y, X,
                                           nrhs, p, s)
                : launch_mrhs_vec<1, false>(v4, out, psi, u, u_bw, T, Z, Y,
                                            X, nrhs, p, s);
  } else {
    err = accum ? launch_mrhs_vec<3, true>(v4, out, psi, u, u_bw, T, Z, Y, X,
                                           nrhs, p, s)
                : launch_mrhs_vec<3, false>(v4, out, psi, u, u_bw, T, Z, Y,
                                            X, nrhs, p, s);
  }
  return static_cast<int>(err);
}

// S2-mrhs-full's resources at (T, Z, Y, X, nhop, accum), for a report (the
// 16-byte-copy instance): info[0] ptxas registers a thread, [1] dynamic
// shared memory a block (bytes), [2] resident blocks an SM, [3] threads a
// block, [4] tiles a (t, z) plane, [5] blocks.
extern "C" int qtt_staggered_full_pass_mrhs_info(int T, int Z, int Y, int X,
                                                 int nhop, int accum,
                                                 int* info) {
  if (T <= 0 || Z <= 0 || Y <= 0 || X <= 0 || (nhop != 1 && nhop != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const TilePlan p = full_mrhs_plan(T, Z, Y, X);
  constexpr int th = kMrhsLanes * kMrhsTile;
  cudaError_t err;
  if (nhop == 1) {
    err = accum ? tile_info(stag_full_pass_mrhs_kernel<1, true, 4>, th, p,
                            info)
                : tile_info(stag_full_pass_mrhs_kernel<1, false, 4>, th, p,
                            info);
  } else {
    err = accum ? tile_info(stag_full_pass_mrhs_kernel<3, true, 4>, th, p,
                            info)
                : tile_info(stag_full_pass_mrhs_kernel<3, false, 4>, th, p,
                            info);
  }
  return static_cast<int>(err);
}
