// The tile plumbing of the multi-RHS hops that stage their links in shared
// memory: the full-lattice Wilson hop B5 (wilson_full.cu), its even/odd
// form B5-eo (wilson_eo_mrhs.cu), the fused clover / twisted hops
// K1/K2-mrhs (clover_eo_mrhs.cu, which stage their clover blocks too), the
// full-lattice staggered pass S2-mrhs-full (staggered_full.cu) and the
// even/odd hop on the fold layout B9 fold-mrhs (wilson_eo_fold.cu, whose
// copies place the planes with FoldPlanes).
//
// A block owns a tile of `tile` sites of one (t, z) plane of `plane` sites
// (the plane's last tile may be partial), copies the tile's forward and
// pre-shifted backward links into shared memory once with cp.async, and
// loops over all N right-hand sides itself, so each link byte leaves
// device memory once for all N.  Blocks walk the planes in boxes of BOXZ
// z-planes across all t, so the blocks resident at one time cover a 4-d
// box of the lattice and find most z and t neighbours' spinors in L2 (in
// t-major order the t neighbours of one wave are read again from device
// memory by the next).  Here: the launch plan, the block order and the
// link copy; each kernel keeps its own tile size, lanes and box depth.
#pragma once

#include <cstdint>

#include "async_copy.cuh"

namespace qtt {

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// The launch of a tiled multi-RHS hop on T x Z planes of `plane` sites,
// with `planes` link planes in each of its two link sets (forward and
// backward).  Mirrored by quda_tpu_torch/ops/wilson_pallas_packed.py::
// tile_plan, which the wrappers' planners call (full_mrhs_plan,
// eo_mrhs_plan, staggered_pallas.full_mrhs_plan).
struct TilePlan {
  int64_t tiles;   // tiles a (t, z) plane: ceil(plane / tile)
  int64_t blocks;  // T * Z * tiles; a grid beyond 2^31 - 1 is refused
  size_t smem;     // the tile's two link sets: 2 * planes * tile floats
};

inline TilePlan tile_plan(int T, int Z, int64_t plane, int tile,
                          int planes) {
  TilePlan p;
  p.tiles = (plane + tile - 1) / tile;
  p.blocks = static_cast<int64_t>(T) * Z * p.tiles;
  p.smem = sizeof(float) * 2 * static_cast<size_t>(planes) * tile;
  return p;
}

// the (t, z) plane and tile j of block b: z-boxes of BOXZ planes, t within
// a box, z within t (the last box may be thinner), tiles fastest
template <int BOXZ>
__device__ __forceinline__ void block_tile(int64_t b, int tiles, int T,
                                           int Z, int& t, int& z, int& j) {
  j = static_cast<int>(b % tiles);
  const int64_t p = b / tiles;
  const int zf = Z / BOXZ * BOXZ;
  const int64_t full = static_cast<int64_t>(zf) * T;
  if (p < full) {
    const int64_t q = p % (BOXZ * T);
    z = static_cast<int>(p / (BOXZ * T)) * BOXZ + static_cast<int>(q % BOXZ);
    t = static_cast<int>(q / BOXZ);
  } else {
    const int zr = Z - zf;
    const int64_t q = p - full;
    t = static_cast<int>(q / zr);
    z = zf + static_cast<int>(q % zr);
  }
}

// Where plane q of a link set starts, from the set's base: an address hook
// of copy_sets and stage_links.  The pair layout's planes lie n apart (an
// int64_t n is that hook); in the fold layout (wilson_hop.cuh's
// FoldLayout) the two planes of component c = q / 2 are one plane of 2n
// numbers whose rows hold the real parts of a (t, z) row, then its
// imaginary parts YXh further on, so plane q starts at c 2n (re) or
// c 2n + YXh (im), and the tile's `start` is the fold address of its first
// real part.
__device__ __forceinline__ int64_t plane_offset(int64_t n, int q) {
  return q * n;
}

struct FoldPlanes {
  int64_t n;
  int64_t yxh;
};

__device__ __forceinline__ int64_t plane_offset(const FoldPlanes& f, int q) {
  return (q >> 1) * 2 * f.n + (q & 1) * f.yxh;
}

// The copies of two sets of PLANES planes into sh[2][PLANES][tile]:
// PLANES planes of `a`, then PLANES of `b`, each the `len` sites from
// `start` of a plane placed by `planes` (plane_offset), VEC floats a
// copy, by all NTHREADS threads of the block: issued, not waited for.
template <int PLANES, int VEC, int NTHREADS, typename Planes>
__device__ __forceinline__ void copy_sets(float* __restrict__ sh,
                                          const float* __restrict__ a,
                                          const float* __restrict__ b,
                                          const Planes& planes,
                                          int64_t start, int len, int tile) {
  const int per = len / VEC;
  for (int i = threadIdx.x; i < 2 * PLANES * per; i += NTHREADS) {
    const int q = i / per;
    const int k = (i - q * per) * VEC;
    const float* src = (q < PLANES ? a + plane_offset(planes, q)
                                   : b + plane_offset(planes, q - PLANES)) +
                       start + k;
    cp_async_vec<VEC>(sh + q * tile + k, src);
  }
}

// The tile's links into shared memory, [2][PLANES][tile] floats: PLANES
// planes of `fwd`, then PLANES of `bw` (copy_sets, planes placed by
// `planes`).  On return every copy the block has issued, these and any
// before them, has landed and is visible to all its threads.
template <int PLANES, int VEC, int NTHREADS, typename Planes>
__device__ __forceinline__ void stage_links(float* __restrict__ sh,
                                            const float* __restrict__ fwd,
                                            const float* __restrict__ bw,
                                            const Planes& planes,
                                            int64_t start, int len,
                                            int tile) {
  copy_sets<PLANES, VEC, NTHREADS>(sh, fwd, bw, planes, start, len, tile);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// The dynamic shared memory of the plan, allowed for `kern` (above 48 KB
// only after this call).
template <typename K>
cudaError_t tile_smem(K* kern, const TilePlan& p) {
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(p.smem));
}

// A tiled kernel's resources at plan p and `threads` a block, for the
// query entries: info[0] ptxas registers a thread, [1] dynamic shared
// memory a block (bytes), [2] resident blocks an SM, [3] threads a block,
// [4] tiles a (t, z) plane, [5] blocks.
template <typename K>
cudaError_t tile_info(K* kern, int threads, const TilePlan& p, int* info) {
  cudaError_t err = tile_smem(kern, p);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern,
                                                      threads, p.smem);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(p.smem);
  info[2] = blocks;
  info[3] = threads;
  info[4] = static_cast<int>(min64(p.tiles, 0x7fffffff));
  info[5] = static_cast<int>(min64(p.blocks, 0x7fffffff));
  return err;
}

// 16-byte copies where every tile's link runs start 16-byte aligned:
// planes and tiles (of a multiple of 4 sites) start at multiples of 4
// sites when the plane's sites are one
inline bool tile_vec4(const void* fwd, const void* bw, int64_t plane) {
  return plane % 4 == 0 && ((reinterpret_cast<uintptr_t>(fwd) |
                             reinterpret_cast<uintptr_t>(bw)) & 15) == 0;
}

}  // namespace qtt
