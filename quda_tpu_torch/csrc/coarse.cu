// Multigrid coarse stencil in one launch (kernel B8):
//   out[s, a] = sum_k sum_b L[k, s, a, b] * psi9[k, s, b]
// over the 9 embedded link blocks k (the coarse diagonal, then the 8 hop
// directions) of each coarse site s.
//
// Replaces: quda_tpu/ops/coarse_pallas.py::coarse_apply_pallas, the Pallas
// TPU kernel (pallas_call at :99).  Plain version:
// quda_tpu_torch/ops/coarse_pallas.py::coarse_apply_ref, the einsum
// "ksab,ksb->sa".  mg/pair.py's PairCoarseOperator.M runs it for every
// coarse operator apply; its multi-RHS form (qtt_coarse_apply_mrhs, N
// right-hand sides, each link read once per chunk of 8; plain version
// coarse_apply_mrhs_ref) serves a batch, the coarse null-vector solves,
// where the JAX package vmaps the kernel.
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

namespace {

// right-hand sides per block of the multi-RHS form: their psi9 copies,
// 8 x 9 E floats, fit 48 KB of shared memory up to E = 170
constexpr int kMrhsChunk = 8;

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

// The multi-RHS form: NR right-hand sides per block share each link load.
// Same row groups, lanes and shuffle tree as coarse_apply_kernel, so each
// right-hand side gets the single form's sums in its order.
template <int G, int kThreads, int NR>
__global__ void __launch_bounds__(kThreads)
    coarse_apply_mrhs_kernel(float* __restrict__ out,
                             const float* __restrict__ links,
                             const float* __restrict__ psi9, int S, int E,
                             int nrhs, int nchunks) {
  extern __shared__ float sh[];   // psi9[r0 + r, :, s, :], NR x 9 E floats
  const int64_t s = blockIdx.x / nchunks;
  const int r0 = static_cast<int>(blockIdx.x % nchunks) * NR;
  const int nvalid = min(NR, nrhs - r0);
  const int64_t sE = s * E;
  const int64_t SE = static_cast<int64_t>(S) * E;
  for (int i = threadIdx.x; i < NR * 9 * E; i += kThreads) {
    const int r = i / (9 * E);
    const int k = (i / E) % 9;
    sh[i] = r < nvalid ? psi9[((r0 + r) * 9LL + k) * SE + sE + (i % E)]
                       : 0.f;
  }
  __syncthreads();

  constexpr int kGroups = kThreads / G;
  const int group = threadIdx.x / G;
  const int lane = threadIdx.x % G;
  const int64_t EE = static_cast<int64_t>(E) * E;
  const int64_t SEE = static_cast<int64_t>(S) * EE;
  for (int a0 = 0; a0 < E; a0 += kGroups) {
    const int a = a0 + group;
    float acc[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) acc[r] = 0.f;
    if (a < E) {
      const float* row = links + s * EE + static_cast<int64_t>(a) * E;
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const float* lk = row + k * SEE;
        for (int b = lane; b < E; b += G) {
          const float l = __ldg(lk + b);
#pragma unroll
          for (int r = 0; r < NR; ++r) acc[r] += l * sh[(r * 9 + k) * E + b];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < NR; ++r) {
#pragma unroll
      for (int off = G / 2; off > 0; off /= 2) {
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off, G);
      }
    }
    if (a < E && lane == 0) {
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        if (r < nvalid) out[(r0 + r) * SE + sE + a] = acc[r];
      }
    }
  }
}

template <int G, int kThreads>
cudaError_t launch_mrhs(float* out, const float* links, const float* psi9,
                        int S, int E, int nrhs, cudaStream_t stream) {
  constexpr int NR = kMrhsChunk;
  const int nchunks = (nrhs + NR - 1) / NR;
  const size_t smem = sizeof(float) * NR * 9 * static_cast<size_t>(E);
  coarse_apply_mrhs_kernel<G, kThreads, NR>
      <<<static_cast<unsigned>(S) * nchunks, kThreads, smem, stream>>>(
          out, links, psi9, S, E, nrhs, nchunks);
  return cudaGetLastError();
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

// The multi-RHS form: psi9 (nrhs, 9, S, E), out (nrhs, S, E), float32; one
// block per (coarse site, chunk of 8 right-hand sides), the chunk index
// fastest, 128 threads each (256 ran slower on the H100); E in 1 .. 160.
extern "C" int qtt_coarse_apply_mrhs(void* out, const void* links,
                                     const void* psi9, int S, int E,
                                     int nrhs, void* stream) {
  const int64_t blocks =
      static_cast<int64_t>(S) * ((nrhs + kMrhsChunk - 1) / kMrhsChunk);
  if (S <= 0 || E <= 0 || E > 160 || nrhs <= 0 || blocks > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* o = static_cast<float*>(out);
  const auto* l = static_cast<const float*>(links);
  const auto* p = static_cast<const float*>(psi9);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (E > 16) {
    err = launch_mrhs<32, 128>(o, l, p, S, E, nrhs, st);
  } else if (E > 8) {
    err = launch_mrhs<16, 128>(o, l, p, S, E, nrhs, st);
  } else {
    err = launch_mrhs<8, 128>(o, l, p, S, E, nrhs, st);
  }
  return static_cast<int>(err);
}
