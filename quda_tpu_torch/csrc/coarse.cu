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
// E = 96) that is 2.749 GB, 0.821 ms at 3.35 TB/s.
//
// Design: one block per coarse site, of 256 threads below 2048 sites
// (where 128-thread blocks, one per site, leave the card short of warps)
// and 128 above, the faster of the two on each side on the H100.  The block
// copies the site's 9 E psi9 numbers into shared memory once; then each row
// a of the output belongs to a group of G lanes of one warp (G = 32, or 16
// or 8 for small E, so a warp serves 32/G rows at once).  The lanes of a group walk the row's E link
// numbers b = lane, lane + G, ... for each of the 9 blocks: consecutive
// lanes read consecutive addresses, so every link row is read coalesced and
// once.  Each lane keeps one partial sum; a shuffle tree inside the group
// adds the G partials, and the group's first lane writes out[s, a].  The
// sums run in another order than the einsum's, so the kernel agrees with
// the plain version to f32 rounding (TOLERANCE in coarse_pallas.py).
#include <cuda_runtime.h>

#include <cstdint>

#include "async_copy.cuh"

namespace {

using namespace qtt;

template <int G, int kThreads>
__global__ void __launch_bounds__(kThreads)
    coarse_apply_kernel(float* __restrict__ out,
                        const float* __restrict__ links,
                        const float* __restrict__ psi9, int S, int E) {
  extern __shared__ float sh[];   // psi9[:, s, :], 9 E floats
  const int64_t s = blockIdx.x;
  const int64_t sE = s * E;
  const int64_t SE = static_cast<int64_t>(S) * E;
  for (int i = threadIdx.x; i < 9 * E; i += kThreads) {
    const int k = i / E;
    sh[i] = psi9[k * SE + sE + (i - k * E)];
  }
  __syncthreads();

  constexpr int kGroups = kThreads / G;
  const int group = threadIdx.x / G;
  const int lane = threadIdx.x % G;
  const int64_t EE = static_cast<int64_t>(E) * E;
  const int64_t SEE = static_cast<int64_t>(S) * EE;
  // every lane of a warp runs the same number of row steps, so the
  // shuffles below see the whole warp
  for (int a0 = 0; a0 < E; a0 += kGroups) {
    const int a = a0 + group;
    float acc = 0.f;
    if (a < E) {
      const float* row = links + s * EE + static_cast<int64_t>(a) * E;
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const float* lk = row + k * SEE;
        const float* pk = sh + k * E;
        for (int b = lane; b < E; b += G) acc += __ldg(lk + b) * pk[b];
      }
    }
#pragma unroll
    for (int off = G / 2; off > 0; off /= 2) {
      acc += __shfl_xor_sync(0xffffffffu, acc, off, G);
    }
    if (a < E && lane == 0) out[sE + a] = acc;
  }
}

template <int G, int kThreads>
cudaError_t launch(float* out, const float* links, const float* psi9, int S,
                   int E, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 9 * static_cast<size_t>(E);
  coarse_apply_kernel<G, kThreads><<<S, kThreads, smem, stream>>>(
      out, links, psi9, S, E);
  return cudaGetLastError();
}

template <int kThreads>
cudaError_t launch_g(float* out, const float* links, const float* psi9,
                     int S, int E, cudaStream_t stream) {
  if (E > 16) return launch<32, kThreads>(out, links, psi9, S, E, stream);
  if (E > 8) return launch<16, kThreads>(out, links, psi9, S, E, stream);
  return launch<8, kThreads>(out, links, psi9, S, E, stream);
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

// 16-byte copies where every staged row starts 16-byte aligned
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

// All float32.  S coarse sites (one block each), E in 1 .. 1024 (the psi9
// copy of a site fits the default 48 KB of shared memory).
extern "C" int qtt_coarse_apply(void* out, const void* links,
                                const void* psi9, int S, int E,
                                void* stream) {
  if (S <= 0 || E <= 0 || E > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* o = static_cast<float*>(out);
  const auto* l = static_cast<const float*>(links);
  const auto* p = static_cast<const float*>(psi9);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = S < 2048 ? launch_g<256>(o, l, p, S, E, st)
                                   : launch_g<128>(o, l, p, S, E, st);
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
