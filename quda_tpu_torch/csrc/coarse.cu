// Multigrid coarse stencil in one launch (kernel B8):
//   out[s, a] = sum_k sum_b L[k, s, a, b] * psi9[k, s, b]
// over the 9 embedded link blocks k (the coarse diagonal, then the 8 hop
// directions) of each coarse site s.
//
// Replaces: quda_tpu/ops/coarse_pallas.py::coarse_apply_pallas, the Pallas
// TPU kernel (pallas_call at :99).  Plain version:
// quda_tpu_torch/ops/coarse_pallas.py::coarse_apply_ref, the einsum
// "ksab,ksb->sa".  mg/pair.py's PairCoarseOperator.M runs it for every
// coarse operator apply; its multi-RHS form (B8-mrhs, qtt_coarse_apply_mrhs
// below: N right-hand sides, a register-tiled GEMM per site that reads each
// link once for all of them; plain version coarse_apply_mrhs_ref) serves a
// batch, the coarse null-vector solves, where the JAX package vmaps the
// kernel.
//
// Layout, all float32: links (9, S, E, E), psi9 (9, S, E), out (S, E), with S
// the coarse sites and E = 2 Nc = 4 n_vec the interleaved real embedding of
// a complex Nc-vector (a complex Nc x Nc matvec is one real E x E matvec).
// The input and its 8 neighbour copies are rolled outside, as in the JAX
// package.  E is a runtime value (16 at n_vec 4, 96 at n_vec 24).
//
// What bounds it on an H100: device memory.  Per coarse site the links are
// 36 E^2 bytes, the psi9 reads 36 E and the output 4 E, against 18 E^2 flop:
// 0.5 flop/B.  At the 8^3 x 16 level of a 32^3 x 64 lattice (S = 8192,
// E = 96) that is 2.749 GB, 0.821 ms at 3.35 TB/s; at the 4^3 x 8 level
// (S = 512) 0.051 ms.  A site's links are 9 contiguous E x E blocks
// (36,864 B each at E = 96): the kernel's job is to keep enough of them in
// flight (Little's law at 3.35 TB/s asks for some tens of KB an SM).
//
// Design: the work is cut into items, one a (site, tile of `rows` link
// rows) and one a block, and each item into 9 stages, one a link block k:
// the tile's rows of L[k, s] (one contiguous run of rows x E floats) and
// psi9[k, s] (E floats).  A block streams its stages through a ring of
// kCoarseStages stages in shared memory with 16-byte cp.async (4-byte
// where E is not a multiple of 4 or a pointer is not 16-byte aligned), so
// kCoarseStages - 1 stages are in flight while one is summed; at 12.7 KB a
// stage (E = 96, 32 rows) and 4 blocks an SM that is ~100 KB in flight an
// SM, and the blocks resident at once overlap one another's loads and
// sums.  In a stage, each row belongs to a group of G
// lanes of one warp (coarse_plan: G = 8 at the multigrid's widths, 4
// below, 32 for rows of 64 or more copies); lane l reads the row's
// numbers l, l + G, ... as float4 from shared memory (bank-conflict free:
// a quarter-warp reads 8 consecutive float4 of one row), sums that k's
// products in one FMA chain and adds the chain to its running sum; after
// the item's 9 stages a shuffle tree adds the group's G sums and the
// group's first lane writes out[s, a].  That is a blocked order (per-k
// chains of E / G products, 9 of them added in order, a tree of G), never
// one chain over all 9 E products (the multi-RHS form's lesson below),
// and another order than the einsum's: the kernel agrees with the plain
// version to f32 rounding (TOLERANCE in coarse_pallas.py).  The stages,
// rows a tile, lanes and grid were chosen by timing variants on the card
// (chip_profile.py coarse_variants; PERF.md: a persistent grid walking
// the items ran 3-4% slower).
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "async_copy.cuh"

namespace {

using namespace qtt;

constexpr int kCoarseThreads = 256;     // threads a block
constexpr int kCoarseStages = 3;       // ring depth (at most 9)
constexpr int kCoarseRowsPerGroup = 1; // rows a lane group holds a tile
constexpr int kCoarseLanesMid = 8;     // lanes a row at 8 .. 63 copies a row
constexpr int kCoarseMinBlocks = 4;    // the launch bound's blocks an SM

struct CoarsePlan {
  int lanes;       // G: lanes a row group
  int rows;        // link rows a tile (an item)
  int tiles;       // tiles a site: ceil(E / rows)
  int stage;       // floats a stage: rows E links, then E psi9 (padded)
  size_t smem;     // dynamic shared memory a block, bytes
  int64_t items;   // S * tiles: the grid, one block an item
};

// Mirrored by quda_tpu_torch/ops/coarse_pallas.py::coarse_plan.
CoarsePlan coarse_plan(int S, int E, bool vec4) {
  CoarsePlan p;
  const int per_row = vec4 ? E / 4 : E;           // copies a link row
  p.lanes = per_row >= 64 ? 32 : per_row >= 8 ? kCoarseLanesMid : 4;
  p.rows = min(E, kCoarseThreads / p.lanes * kCoarseRowsPerGroup);
  p.tiles = (E + p.rows - 1) / p.rows;
  p.stage = (p.rows * E + E + 3) / 4 * 4;
  p.smem = sizeof(float) * kCoarseStages * static_cast<size_t>(p.stage);
  p.items = static_cast<int64_t>(S) * p.tiles;
  return p;
}

// part += the products of VEC numbers of a link row and psi9
template <int VEC>
__device__ __forceinline__ float dot_vec(const float* __restrict__ l,
                                         const float* __restrict__ p,
                                         float part) {
  if constexpr (VEC == 4) {
    const float4 a = *reinterpret_cast<const float4*>(l);
    const float4 b = *reinterpret_cast<const float4*>(p);
    part = fmaf(a.x, b.x, part);
    part = fmaf(a.y, b.y, part);
    part = fmaf(a.z, b.z, part);
    return fmaf(a.w, b.w, part);
  } else {
    return fmaf(*l, *p, part);
  }
}

template <int G, int VEC>
__global__ void __launch_bounds__(kCoarseThreads, kCoarseMinBlocks)
    coarse_apply_kernel(float* __restrict__ out,
                        const float* __restrict__ links,
                        const float* __restrict__ psi9, int S, int E,
                        int rows, int tiles, int stage) {
  static_assert(kCoarseStages >= 2 && kCoarseStages <= 9, "ring depth");
  extern __shared__ __align__(16) float sh[];
  constexpr int kGroups = kCoarseThreads / G;
  constexpr int kR = kCoarseRowsPerGroup;
  const int group = threadIdx.x / G;
  const int lane = threadIdx.x % G;
  const int per_row = E / VEC;
  const int64_t SE = static_cast<int64_t>(S) * E;
  const int64_t SEE = SE * E;
  // the block's item: the link rows a0 .. a0 + nr of site s
  const int64_t s = blockIdx.x / tiles;
  const int a0 = static_cast<int>(blockIdx.x - s * tiles) * rows;
  const int nr = min(rows, E - a0);
  const int nl = nr * per_row;
  const float* lk0 = links + (s * E + a0) * E;
  const float* pk0 = psi9 + s * E;

  // copy stage k (link block k) into dst: the nr link rows, then psi9[k, s]
  // at float rows * E
  auto load = [&](int k, float* dst) {
    const float* lk = lk0 + k * SEE;
    const float* pk = pk0 + k * SE;
    for (int i = threadIdx.x; i < nl + per_row; i += kCoarseThreads) {
      if (i < nl) {
        cp_async_vec<VEC>(dst + i * VEC, lk + i * VEC);
      } else {
        cp_async_vec<VEC>(dst + rows * E + (i - nl) * VEC,
                          pk + (i - nl) * VEC);
      }
    }
  };

#pragma unroll
  for (int k = 0; k < kCoarseStages - 1; ++k) {
    load(k, sh + k * stage);
    cp_async_commit();
  }
  float acc[kR];
#pragma unroll
  for (int j = 0; j < kR; ++j) acc[j] = 0.f;

#pragma unroll 1
  for (int k = 0; k < 9; ++k) {
    cp_async_wait<kCoarseStages - 2>();
    __syncthreads();                 // stage k landed; stage k - 1 is done
    const int next = k + kCoarseStages - 1;
    if (next < 9) load(next, sh + (next % kCoarseStages) * stage);
    cp_async_commit();
    const float* st = sh + (k % kCoarseStages) * stage;
    const float* p = st + rows * E;
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const int r = group + j * kGroups;
      if (r < nr) {
        const float* l = st + r * E;
        float part = 0.f;
        for (int c = lane; c < per_row; c += G) {
          part = dot_vec<VEC>(l + c * VEC, p + c * VEC, part);
        }
        acc[j] += part;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    float v = acc[j];
#pragma unroll
    for (int off = G / 2; off > 0; off /= 2) {
      v += __shfl_xor_sync(0xffffffffu, v, off, G);
    }
    const int r = group + j * kGroups;
    if (lane == 0 && r < nr) out[s * E + a0 + r] = v;
  }
}

template <int G, int VEC>
cudaError_t launch(float* out, const float* links, const float* psi9, int S,
                   int E, const CoarsePlan& p, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      coarse_apply_kernel<G, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p.smem));
  if (err != cudaSuccess) return err;
  coarse_apply_kernel<G, VEC>
      <<<static_cast<unsigned>(p.items), kCoarseThreads, p.smem, stream>>>(
          out, links, psi9, S, E, p.rows, p.tiles, p.stage);
  return cudaGetLastError();
}

template <int G, int VEC>
cudaError_t info_single(const CoarsePlan& p, int* info) {
  auto* kern = coarse_apply_kernel<G, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p.smem));
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern,
                                                      kCoarseThreads, p.smem);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(p.smem);
  info[2] = blocks;
  info[3] = p.rows;
  info[4] = p.lanes;
  info[5] = static_cast<int>(p.items);
  return err;
}

// f(G) for plan p's lane count G, a compile-time constant
template <typename F>
cudaError_t by_lanes(const CoarsePlan& p, F&& f) {
  if (p.lanes == 32) return f(std::integral_constant<int, 32>{});
  if (p.lanes == 4) return f(std::integral_constant<int, 4>{});
  return f(std::integral_constant<int, kCoarseLanesMid>{});
}

// ---------------------------------------------------------------------------
// The multi-RHS form (kernel B8-mrhs): the same links on N right-hand sides,
//   out[n, s, a] = sum_k sum_b L[k, s, a, b] * psi9[n, k, s, b].
// Per coarse site that is a small GEMM, Out_s (N x E) = P_s (N x 9E) .
// L_s^T (9E x E), whose reduction axis K = (k, b) runs over the 9 link
// blocks.
//
// What bounds it on an H100: device memory, when each link byte leaves it
// once for all N.  Per site 36 E^2 bytes of links, 36 E N of psi9 and 4 E N
// of output, against 18 E^2 N flop: at S = 8192, E = 96, N = 24 that is
// 3.47 GB, 1.037 ms at 3.35 TB/s, and 32.6 GFLOP, 0.49 ms at the 67 TFLOP/s
// of FP32 FMA outside the tensor cores.  So CUDA-core FFMA with register
// tiling can come near the memory floor; TF32 tensor cores would not keep
// the 1e-5 tolerance.
//
// Design: a block owns one coarse site and a chunk of up to NC = NG * kTN
// right-hand sides (all N where they fit; mrhs_plan below).  The K axis is
// cut into tiles of kBK columns of one link block k: the tile's E x kBK
// link columns and NC x kBK psi9 columns are copied with cp.async into a
// ring of kStages shared-memory stages, so tile t + kStages - 1 streams in
// while tile t is used.  Each thread holds a register tile of kTA output
// rows (a = ta, ta + AG, ...: consecutive lanes on consecutive rows) times
// kTN right-hand sides, and per 4 columns reads kTA + kTN float4 from shared
// memory for 4 kTA kTN FMAs.  Rows are padded to kLDK = kBK + 4 floats, so a
// quarter-warp's float4 loads of 8 consecutive rows hit 8 distinct bank
// groups.  Each link byte leaves device memory once per chunk: once for
// all N where N <= NC.  Where E is not a multiple of 4 (or a pointer is not
// 16-byte aligned) the copies are 4-byte and the tile's columns past E are
// zero.  Every output sums each tile's kBK products in one FMA chain and
// adds the tile sums in order: blocked summation, whose rounding grows like
// the single form's strided partial sums and shuffle tree, not like one
// chain of 9 E products (with one chain the coarse null vectors came out
// slightly worse: on 2 of 5 seeds the multigrid solve took a third outer
// GCR cycle; PERF.md).  That is another order than the einsum's and the
// single form's: the lanes agree with single launches to f32 rounding
// (TOLERANCE), not bit for bit.
constexpr int kTA = 4;                 // output rows per thread
constexpr int kTN = 6;                 // right-hand sides per thread
constexpr int kBK = 32;                // K columns per stage
constexpr int kLDK = kBK + 4;          // padded row, floats
constexpr int kStages = 4;             // ring depth
constexpr int kMrhsMaxThreads = 256;
// shared memory per block that leaves room for two blocks on an SM
// (228 KB per SM, 1 KB of it reserved per block)
constexpr int kMrhsSmemBudget = 115712;

struct MrhsPlan {
  int ag;         // row groups: ceil(E / kTA)
  int ng;         // right-hand-side groups: NC = ng * kTN
  int threads;    // ag * ng rounded up to a warp
  int chunks;     // ceil(N / NC): how often each link is read
  size_t smem;    // dynamic shared memory per block, bytes
};

// Mirrored by quda_tpu_torch/ops/coarse_pallas.py::mrhs_plan.
MrhsPlan mrhs_plan(int E, int nrhs) {
  MrhsPlan p;
  p.ag = (E + kTA - 1) / kTA;
  const int rows_l = p.ag * kTA;
  const int max_rows = kMrhsSmemBudget / (kStages * kLDK * 4);
  int ng = (nrhs + kTN - 1) / kTN;
  ng = min(ng, kMrhsMaxThreads / p.ag);
  ng = min(ng, (max_rows - rows_l) / kTN);
  p.ng = ng;
  p.threads = (p.ag * ng + 31) / 32 * 32;
  p.chunks = (nrhs + ng * kTN - 1) / (ng * kTN);
  p.smem = sizeof(float) * kStages * static_cast<size_t>(rows_l + ng * kTN) *
           kLDK;
  return p;
}

// acc += the products of 4 columns b .. b + 3 for the thread's kTA x kTN
// outputs: L holds its first link row (row i at i * ag * kLDK), P its first
// psi9 row (row j at j * kLDK)
__device__ __forceinline__ void fma4(float (&acc)[kTA][kTN],
                                     const float* __restrict__ L,
                                     const float* __restrict__ P, int ag,
                                     int b) {
  float4 l[kTA], p[kTN];
#pragma unroll
  for (int i = 0; i < kTA; ++i) {
    l[i] = *reinterpret_cast<const float4*>(L + i * ag * kLDK + b);
  }
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    p[j] = *reinterpret_cast<const float4*>(P + j * kLDK + b);
  }
#pragma unroll
  for (int i = 0; i < kTA; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      float a = acc[i][j];
      a = fmaf(l[i].x, p[j].x, a);
      a = fmaf(l[i].y, p[j].y, a);
      a = fmaf(l[i].z, p[j].z, a);
      acc[i][j] = fmaf(l[i].w, p[j].w, a);
    }
}

template <int VEC>
__global__ void __launch_bounds__(kMrhsMaxThreads)
    coarse_apply_mrhs_kernel(float* __restrict__ out,
                             const float* __restrict__ links,
                             const float* __restrict__ psi9, int S, int E,
                             int nrhs, int ag, int ng, int chunks) {
  extern __shared__ __align__(16) float sh[];
  const int nc = ng * kTN;
  const int rows_l = ag * kTA;
  const int stage = (rows_l + nc) * kLDK;
  const int64_t s = blockIdx.x / chunks;
  const int r0 = static_cast<int>(blockIdx.x % chunks) * nc;
  const int nvalid = min(nc, nrhs - r0);
  const int tpk = (E + kBK - 1) / kBK;          // tiles per link block
  const int ntiles = 9 * tpk;
  const int64_t SE = static_cast<int64_t>(S) * E;
  const int64_t EE = static_cast<int64_t>(E) * E;

  // stage tile ``tile`` (link block k, columns b0 ..) into dst: E link rows,
  // then nvalid psi9 rows at row rows_l
  auto load = [&](int tile, float* dst) {
    const int k = tile / tpk;
    const int b0 = (tile - k * tpk) * kBK;
    const int valid = min(kBK, E - b0);
    const int per_row = ((valid + 3) & ~3) / VEC;
    const float* lk = links + (k * static_cast<int64_t>(S) + s) * EE + b0;
    const float* pk = psi9 + (static_cast<int64_t>(r0) * 9 + k) * SE +
                      s * E + b0;
    const int total = (E + nvalid) * per_row;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int row = i / per_row;
      const int col = (i - row * per_row) * VEC;
      const bool is_l = row < E;
      float* d = dst + (is_l ? row : rows_l + row - E) * kLDK + col;
      if (VEC == 1 && col >= valid) {
        *d = 0.f;                    // the float4 past E reads zeros
        continue;
      }
      const float* src = is_l ? lk + static_cast<int64_t>(row) * E + col
                              : pk + static_cast<int64_t>(row - E) * 9 * SE +
                                    col;
      cp_async_vec<VEC>(d, src);
    }
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < ntiles) load(i, sh + i * stage);
    cp_async_commit();
  }

  const int tid = threadIdx.x;
  const bool active = tid < ag * ng;
  const int ta = tid % ag;
  const int tn = tid / ag;
  float acc[kTA][kTN];
#pragma unroll
  for (int i = 0; i < kTA; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                 // tile t landed; tile t - 1 is done
    const int next = t + kStages - 1;
    if (next < ntiles) load(next, sh + (next % kStages) * stage);
    cp_async_commit();
    if (active) {
      const float* L = sh + (t % kStages) * stage + ta * kLDK;
      const float* P = sh + (t % kStages) * stage + (rows_l + tn * kTN) * kLDK;
      const int b0 = (t % tpk) * kBK;
      const int w = (min(kBK, E - b0) + 3) & ~3;
      float part[kTA][kTN];
#pragma unroll
      for (int i = 0; i < kTA; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) part[i][j] = 0.f;
      if (w == kBK) {
#pragma unroll
        for (int b = 0; b < kBK; b += 4) fma4(part, L, P, ag, b);
      } else {
        for (int b = 0; b < w; b += 4) fma4(part, L, P, ag, b);
      }
#pragma unroll
      for (int i = 0; i < kTA; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] += part[i][j];
    }
  }

  if (!active) return;
#pragma unroll
  for (int i = 0; i < kTA; ++i) {
    const int a = ta + i * ag;
    if (a >= E) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = tn * kTN + j;
      if (n < nvalid) out[(r0 + n) * SE + s * E + a] = acc[i][j];
    }
  }
}

// 16-byte copies where every staged row starts 16-byte aligned (both
// forms)
bool mrhs_vec4(const void* links, const void* psi9, int E) {
  return E % 4 == 0 &&
         ((reinterpret_cast<uintptr_t>(links) |
           reinterpret_cast<uintptr_t>(psi9)) & 15) == 0;
}

template <int VEC>
cudaError_t launch_mrhs(float* out, const float* links, const float* psi9,
                        int S, int E, int nrhs, const MrhsPlan& p,
                        cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      coarse_apply_mrhs_kernel<VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(p.smem));
  if (err != cudaSuccess) return err;
  coarse_apply_mrhs_kernel<VEC>
      <<<static_cast<unsigned>(S) * p.chunks, p.threads, p.smem, stream>>>(
          out, links, psi9, S, E, nrhs, p.ag, p.ng, p.chunks);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t info_mrhs(const MrhsPlan& p, int* info) {
  cudaError_t err = cudaFuncSetAttribute(
      coarse_apply_mrhs_kernel<VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(p.smem));
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, coarse_apply_mrhs_kernel<VEC>);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, coarse_apply_mrhs_kernel<VEC>, p.threads, p.smem);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(p.smem);
  info[2] = blocks;
  info[3] = p.threads;
  info[4] = p.ng * kTN;
  info[5] = p.chunks;
  return err;
}
}  // namespace

// All float32.  S >= 1 coarse sites, E in 1 .. 1024 (coarse_plan's
// stages fit 227 KB of shared memory up to E = 1024); a grid (S times the
// row tiles of a site) beyond 2^31 - 1 blocks is refused.
extern "C" int qtt_coarse_apply(void* out, const void* links,
                                const void* psi9, int S, int E,
                                void* stream) {
  if (S <= 0 || E <= 0 || E > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* o = static_cast<float*>(out);
  const auto* l = static_cast<const float*>(links);
  const auto* ps = static_cast<const float*>(psi9);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool v4 = mrhs_vec4(links, psi9, E);
  const CoarsePlan p = coarse_plan(S, E, v4);
  if (p.items > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      v4 ? by_lanes(p, [&](auto g) {
             return launch<decltype(g)::value, 4>(o, l, ps, S, E, p, st);
           })
         : by_lanes(p, [&](auto g) {
             return launch<decltype(g)::value, 1>(o, l, ps, S, E, p, st);
           });
  return static_cast<int>(err);
}

// B8's resources at (S, E), for a report: info[0] ptxas registers a thread,
// [1] dynamic shared memory a block (bytes), [2] resident blocks an SM,
// [3] link rows a tile, [4] lanes a row, [5] blocks of the grid (items).
// vec4:
// the 16-byte-copy instances (aligned E % 4 == 0 inputs).
extern "C" int qtt_coarse_apply_info(int S, int E, int vec4, int* info) {
  if (S <= 0 || E <= 0 || E > 1024 || (vec4 && E % 4 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const CoarsePlan p = coarse_plan(S, E, vec4 != 0);
  if (p.items > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      vec4 ? by_lanes(p, [&](auto g) {
               return info_single<decltype(g)::value, 4>(p, info);
             })
           : by_lanes(p, [&](auto g) {
               return info_single<decltype(g)::value, 1>(p, info);
             });
  return static_cast<int>(err);
}

// The multi-RHS form: psi9 (nrhs, 9, S, E), out (nrhs, S, E), float32; E in
// 1 .. 160, nrhs >= 1; one block per (coarse site, chunk of right-hand
// sides), the chunk index fastest.
extern "C" int qtt_coarse_apply_mrhs(void* out, const void* links,
                                     const void* psi9, int S, int E,
                                     int nrhs, void* stream) {
  if (S <= 0 || E <= 0 || E > 160 || nrhs <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const MrhsPlan p = mrhs_plan(E, nrhs);
  if (static_cast<int64_t>(S) * p.chunks > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* o = static_cast<float*>(out);
  const auto* l = static_cast<const float*>(links);
  const auto* ps = static_cast<const float*>(psi9);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      mrhs_vec4(links, psi9, E)
          ? launch_mrhs<4>(o, l, ps, S, E, nrhs, p, st)
          : launch_mrhs<1>(o, l, ps, S, E, nrhs, p, st);
  return static_cast<int>(err);
}

// The multi-RHS form's resources at (E, nrhs), for a report: info[0]
// ptxas registers a thread, [1] dynamic shared memory a block (bytes), [2]
// resident blocks an SM, [3] threads a block, [4] right-hand sides a chunk,
// [5] chunks.  vec4: the 16-byte-copy instance (aligned E % 4 == 0 inputs).
extern "C" int qtt_coarse_apply_mrhs_info(int E, int nrhs, int vec4,
                                          int* info) {
  if (E <= 0 || E > 160 || nrhs <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const MrhsPlan p = mrhs_plan(E, nrhs);
  return static_cast<int>(vec4 ? info_mrhs<4>(p, info)
                               : info_mrhs<1>(p, info));
}
