// Full-lattice Wilson hop D psi on the packed pair layout (kernel B4), its
// multi-RHS form (kernel B5) and its copy-free form (kernel B10, at the end
// of this file).
//
// Replaces: quda_tpu/ops/wilson_pallas_packed.py::dslash_pallas_packed, the
// Pallas TPU kernel (pallas_call at :441, body _make_kernel with no eo at
// :184-308).  Plain version: quda_tpu_torch/ops/wilson_pallas_packed.py::
// dslash_packed_plain.
//   out(x) = sum_mu [(1 - gamma_mu) U_mu(x) psi(x + mu)
//                    + (1 + gamma_mu) U_mu(x - mu)^dag psi(x - mu)]
//
// Layout; every spin/colour/re-im component is its own plane of
// S = T*Z*Y*X sites, so adjacent threads read adjacent addresses:
//   psi, out  (4, 3, 2, T, Z, Y*X)
//   u         (4, R, 3, 2, T, Z, Y*X)   U_mu(x), boundary phase folded in
//   u_bw      (4, R, 3, 2, T, Z, Y*X)   U_mu(x - mu): backward_gauge, shifted
//                                       once per gauge load
// Forms (template arguments): full:f32->f32 and r12:f32->f32 (R = 2, row 2
// = conj(row0 x row1) rebuilt in registers, negated with tb_sign on the t
// links of the antiperiodic boundary planes: forward on t = T-1, backward
// on t = 0), as the TPU kernel's f32 forms; and full:f64->f64, the native
// double form of mat_quda at cuda_prec "double", which has no TPU twin (a
// TPU has no f64; its oracle is the complex128 plain version).  Sums are in
// the storage's real type.
//
// What bounds it on an H100: device memory.  A site needs 1320 flop
// against at least 768 B in f32 with R = 3 (psi 96, two link sets 576, out
// 96, when L2 serves the neighbour re-reads of psi), 576 B with R = 2 and
// 1536 B in f64: at most 2.3 flop/B, against the ~20 (f32) and ~10 (f64)
// flop/B where the arithmetic binds.  At 32^3 x 64 the f32 floor is
// 0.481 ms and the f64 floor 0.962 ms.
//
// Design: B1's, on the full lattice.  One thread per site, 24 accumulators
// in registers; the hop is full_hop_sum of wilson_hop.cuh, the same hop
// code as B1 and the clover kernels with full-lattice neighbour indices.
// An x hop wraps inside its row of X slots of the fused Y*X axis (the TPU
// kernel's iota mask, wilson_packed._x_wrap_masks), never into the next y;
// y, z and t wrap on their own planes.  The TPU kernel's z-block tiles,
// neighbour tiles and lane rolls are gone: a CUDA thread reads its
// neighbour.  Offsets are 64-bit.
#include "mrhs_tile.cuh"
#include "wilson_hop.cuh"

namespace {

using namespace qtt;

constexpr int kThreads = 128;

// the 24 sums of acc[0] into the component planes of out at site
template <typename S>
__device__ __forceinline__ void st_planes(S* __restrict__ out,
                                          const cplx_t<S> (&acc)[1][4][3],
                                          int64_t n, int64_t site) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      S* q = out + static_cast<int64_t>((s * 3 + c) * 2) * n + site;
      st(q, acc[0][s][c].x);
      st(q + n, acc[0][s][c].y);
    }
}

template <typename S, int R>
__global__ void __launch_bounds__(kThreads)
    wilson_full_kernel(S* __restrict__ out, const S* __restrict__ psi,
                       const S* __restrict__ u, const S* __restrict__ u_bw,
                       int T, int Z, int Y, int X, int tb_sign) {
  const int64_t YX = static_cast<int64_t>(Y) * X;
  const int64_t ZYX = static_cast<int64_t>(Z) * YX;
  const int64_t n = static_cast<int64_t>(T) * ZYX;
  const int64_t site = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (site >= n) return;

  cplx_t<S> acc[1][4][3];
  full_hop_sum<R, 1>(acc, psi, 0, 1, u, u_bw, T, Z, Y, X, YX, ZYX, n,
                     tb_sign, site);
  st_planes(out, acc, n, site);
}

template <typename S, int R>
cudaError_t launch(void* out, const void* psi, const void* u,
                   const void* u_bw, int T, int Z, int Y, int X, int tb_sign,
                   unsigned blocks, cudaStream_t stream) {
  wilson_full_kernel<S, R><<<blocks, kThreads, 0, stream>>>(
      static_cast<S*>(out), static_cast<const S*>(psi),
      static_cast<const S*>(u), static_cast<const S*>(u_bw), T, Z, Y, X,
      tb_sign);
  return cudaGetLastError();
}

}  // namespace

// f64: psi, links and out are float64 (rows 3 only), else float32; rows: 3
// or 2.  Lattice (T, Z, Y, X) in full sites.
extern "C" int qtt_wilson_full(void* out, const void* psi, const void* u,
                               const void* u_bw, int T, int Z, int Y, int X,
                               int rows, int f64, int tb_sign, void* stream) {
  const int64_t n = static_cast<int64_t>(T) * Z * Y * X;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (n <= 0 || blocks > 0x7fffffff || (rows != 2 && rows != 3) ||
      (f64 && rows != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned nb = static_cast<unsigned>(blocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (f64) {
    err = launch<double, 3>(out, psi, u, u_bw, T, Z, Y, X, tb_sign, nb, s);
  } else if (rows == 3) {
    err = launch<float, 3>(out, psi, u, u_bw, T, Z, Y, X, tb_sign, nb, s);
  } else {
    err = launch<float, 2>(out, psi, u, u_bw, T, Z, Y, X, tb_sign, nb, s);
  }
  return static_cast<int>(err);
}

// ---------------------------------------------------------------------------
// Multi-RHS full-lattice hop (kernel B5): B4's hop over N right-hand sides,
// each link read from device memory once for all of them.
//
// Replaces: quda_tpu/ops/wilson_pallas_packed.py::dslash_pallas_packed_mrhs,
// the Pallas TPU kernel (pallas_call at :557; B4's body under _mrhs_wrap on a
// grid whose gauge index maps ignore the RHS index).  Plain version:
// quda_tpu_torch/ops/wilson_pallas_packed.py::dslash_packed_mrhs_plain.  The
// multigrid set-up's null-vector block solve runs it (mg/pair.py,
// PairWilsonLevelOp.M_mrhs_pl).
//
// Layout: psi, out (N, 4, 3, 2, T, Z, Y*X), right-hand sides 24 * S elements
// apart (S = T*Z*Y*X sites); links and backward links as for B4.  Forms:
// full:f32->f32 and r12:f32->f32 (R = 2 with tb_sign as in B4).  Sums f32.
//
// What bounds it on an H100: device memory.  Per site N spinors in and out
// (192 N bytes in f32, when L2 serves the neighbour re-reads) and the links
// once (576 B): at 32^3 x 64 and N = 24 a floor of 10.87 GB, 3.245 ms at
// 3.35 TB/s.  1320 N flop against (192 N + 576) B is at most 6.9 flop/B.
//
// Design: a block owns a tile of kTile sites of one (t, z) plane (the
// plane's last tile may be partial) and loops over all N right-hand sides
// itself.  It copies the tile's links, forward and pre-shifted backward
// (576 B a site at R = 3, 384 at R = 2), into shared memory once with
// cp.async, so each link byte leaves device memory once for all N.  Its
// kLanes x kTile threads are kLanes lanes of a thread a site: lane l takes
// right-hand sides l NB, l NB + kLanes NB, ... in chunks of NB (1 or 2; a
// tail chunk reads and writes only the sides that exist).  The hop is
// full_hop_sum_from of wilson_hop.cuh with the links from the tile's copy
// (TileShifted) and psi gathered through L1 and L2, so each right-hand side
// sees B4's arithmetic in B4's order and matches a B4 launch bit for bit.
// Blocks walk the planes in boxes of kBoxZ z-planes across all t
// (mrhs_tile.cuh, shared with B5-eo and S2-mrhs-full).  On the H100 a psi
// window staged in shared memory as well (x and y neighbours, double-
// buffered) ran slower, its copies and barriers costing more than the L1
// misses they save, and NB = 2 slower than NB = 1 (PERF.md).  Offsets are
// 64-bit.
namespace {

constexpr int kTile = 128;       // sites a block
constexpr int kLanes = 2;        // threads a site
constexpr int kBoxZ = 4;         // z-planes of a box of the block order

// Mirrored by quda_tpu_torch/ops/wilson_pallas_packed.py::full_mrhs_plan:
// the tile's links are 2 * 24 R floats a site.
TilePlan full_mrhs_plan(int T, int Z, int Y, int X, int rows) {
  return tile_plan(T, Z, static_cast<int64_t>(Y) * X, kTile, 24 * rows);
}

// two blocks an SM at NB = 1 (at most 128 registers a thread)
template <int R, int NB, int VEC>
__global__ void __launch_bounds__(kLanes * kTile, NB == 1 ? 2 : 1)
    wilson_full_mrhs_kernel(float* __restrict__ out,
                            const float* __restrict__ psi,
                            const float* __restrict__ u,
                            const float* __restrict__ u_bw, int T, int Z,
                            int Y, int X, int tb_sign, int nrhs, int tiles) {
  extern __shared__ __align__(16) float sh[];
  constexpr int kP = 4 * R * 3 * 2;             // link planes of a set
  const int64_t YX = static_cast<int64_t>(Y) * X;
  const int64_t ZYX = static_cast<int64_t>(Z) * YX;
  const int64_t n = static_cast<int64_t>(T) * ZYX;
  const int64_t rstride = 24 * n;

  int t, z, j;
  block_tile<kBoxZ>(blockIdx.x, tiles, T, Z, t, z, j);
  const int64_t start = (static_cast<int64_t>(t) * Z + z) * YX +
                        static_cast<int64_t>(j) * kTile;
  const int len = static_cast<int>(min64(kTile, YX - j * kTile));
  stage_links<kP, VEC, kLanes * kTile>(sh, u, u_bw, n, start, len, kTile);

  const int i = threadIdx.x % kTile;
  const int lane = threadIdx.x / kTile;
  const int64_t site = start + i;
  const TileShifted<R> links{sh, sh + kP * kTile, kTile, i};
  // (in this loop shape the NB = 1 instances fit 128 registers with no
  // spill; with an early return for i >= len they spilled)
  for (int base = 0; base < nrhs; base += kLanes * NB) {
    const int r0 = base + lane * NB;
    if (i >= len || r0 >= nrhs) continue;
    const int nvalid = min(NB, nrhs - r0);
    float2 acc[NB][4][3];
    full_hop_sum_from(acc, psi + r0 * rstride, rstride, nvalid, links, T, Z,
                      Y, X, YX, ZYX, n, tb_sign, site);
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
cudaError_t launch_mrhs(void* out, const void* psi, const void* u,
                        const void* u_bw, int T, int Z, int Y, int X,
                        int tb_sign, int nrhs, const TilePlan& p,
                        cudaStream_t stream) {
  auto kern = wilson_full_mrhs_kernel<R, NB, VEC>;
  const cudaError_t err = tile_smem(kern, p);
  if (err != cudaSuccess) return err;
  kern<<<static_cast<unsigned>(p.blocks), kLanes * kTile, p.smem, stream>>>(
      static_cast<float*>(out), static_cast<const float*>(psi),
      static_cast<const float*>(u), static_cast<const float*>(u_bw), T, Z, Y,
      X, tb_sign, nrhs, static_cast<int>(p.tiles));
  return cudaGetLastError();
}

template <int R, int NB>
cudaError_t launch_mrhs_vec(bool vec4, void* out, const void* psi,
                            const void* u, const void* u_bw, int T, int Z,
                            int Y, int X, int tb_sign, int nrhs,
                            const TilePlan& p, cudaStream_t stream) {
  return vec4 ? launch_mrhs<R, NB, 4>(out, psi, u, u_bw, T, Z, Y, X, tb_sign,
                                      nrhs, p, stream)
              : launch_mrhs<R, NB, 1>(out, psi, u, u_bw, T, Z, Y, X, tb_sign,
                                      nrhs, p, stream);
}

}  // namespace

// All float32.  rows: 3 or 2; nrhs: the batch's right-hand sides; nb: the
// chunk width, 1 or 2.  A grid of more than 2^31 - 1 blocks is refused.
extern "C" int qtt_wilson_full_mrhs(void* out, const void* psi, const void* u,
                                    const void* u_bw, int T, int Z, int Y,
                                    int X, int rows, int tb_sign, int nrhs,
                                    int nb, void* stream) {
  const int64_t n = static_cast<int64_t>(T) * Z * Y * X;
  if (n <= 0 || nrhs <= 0 || (nb != 1 && nb != 2) ||
      (rows != 2 && rows != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const TilePlan p = full_mrhs_plan(T, Z, Y, X, rows);
  if (p.blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const bool v4 = tile_vec4(u, u_bw, static_cast<int64_t>(Y) * X);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (rows == 3) {
    err = nb == 1 ? launch_mrhs_vec<3, 1>(v4, out, psi, u, u_bw, T, Z, Y, X,
                                          tb_sign, nrhs, p, s)
                  : launch_mrhs_vec<3, 2>(v4, out, psi, u, u_bw, T, Z, Y, X,
                                          tb_sign, nrhs, p, s);
  } else {
    err = nb == 1 ? launch_mrhs_vec<2, 1>(v4, out, psi, u, u_bw, T, Z, Y, X,
                                          tb_sign, nrhs, p, s)
                  : launch_mrhs_vec<2, 2>(v4, out, psi, u, u_bw, T, Z, Y, X,
                                          tb_sign, nrhs, p, s);
  }
  return static_cast<int>(err);
}

// B5's resources at (T, Z, Y, X, rows, nb), for a report (the 16-byte-copy
// instance): info[0] ptxas registers a thread, [1] dynamic shared memory a
// block (bytes), [2] resident blocks an SM, [3] threads a block, [4] tiles
// a (t, z) plane, [5] blocks.
extern "C" int qtt_wilson_full_mrhs_info(int T, int Z, int Y, int X,
                                         int rows, int nb, int* info) {
  if (T <= 0 || Z <= 0 || Y <= 0 || X <= 0 || (nb != 1 && nb != 2) ||
      (rows != 2 && rows != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const TilePlan p = full_mrhs_plan(T, Z, Y, X, rows);
  constexpr int th = kLanes * kTile;
  cudaError_t err;
  if (rows == 3) {
    err = nb == 1 ? tile_info(wilson_full_mrhs_kernel<3, 1, 4>, th, p, info)
                  : tile_info(wilson_full_mrhs_kernel<3, 2, 4>, th, p, info);
  } else {
    err = nb == 1 ? tile_info(wilson_full_mrhs_kernel<2, 1, 4>, th, p, info)
                  : tile_info(wilson_full_mrhs_kernel<2, 2, 4>, th, p, info);
  }
  return static_cast<int>(err);
}

// ---------------------------------------------------------------------------
// Copy-free full-lattice hop (kernel B10): B4 with no backward copy.
//
// Replaces: quda_tpu/ops/wilson_pallas_packed.py::dslash_pallas_packed_v3,
// the Pallas TPU kernel (pallas_call at :938, body _make_kernel_v3).  Plain
// version: quda_tpu_torch/ops/wilson_pallas_packed.py::
// dslash_packed_v3_plain.  The tuner's candidate ``pallas_v3``
// (ops/wilson_pallas.py::tuned_dslash) runs it.
//
// Layout: psi, out (4, 3, 2, T, Z, Y*X); u (4, R, 3, 2, T, Z, Y*X), boundary
// phase folded in, read twice: U_mu(x) at the target for the forward hop
// and U_mu(x - mu) unshifted at the neighbour x - mu for the backward hop
// (full_hop_sum_from with the There source, the links as both ``here`` and
// ``there``).  Forms: full:f32->f32 and r12:f32->f32 (R = 2 with tb_sign:
// the rebuilt row 2 of a t link negated on its antiperiodic plane, keyed to
// the target plane as B4 keys its backward copy, so the output is B4's on
// backward_gauge(u) bit for bit).  Sums f32.
//
// What bounds it on an H100: device memory.  Its floor is 480 B a site in
// f32 with R = 3 (psi 96, links 288, out 96: each input read once) and
// 384 B with R = 2, at 1320 flop (+336 with R = 2), 2.75 flop/B at most;
// at 32^3 x 64 the floor is 0.300 ms (R = 3) and 0.240 ms (R = 2).  B4
// reads the 288 B backward copy as well (768 B).
//
// Design: B4's thread per site.  The backward hop of direction mu reads
// the link at the neighbour index psi is read at, so a warp's backward link
// loads are the psi loads' pattern: coalesced along x and y, a plane away
// along z and t, and the rows L2 already holds from the forward hops of
// the neighbouring blocks.
namespace {

template <int R>
__global__ void __launch_bounds__(kThreads)
    wilson_full_there_kernel(float* __restrict__ out,
                             const float* __restrict__ psi,
                             const float* __restrict__ u, int T, int Z, int Y,
                             int X, int tb_sign) {
  const int64_t YX = static_cast<int64_t>(Y) * X;
  const int64_t ZYX = static_cast<int64_t>(Z) * YX;
  const int64_t n = static_cast<int64_t>(T) * ZYX;
  const int64_t site = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (site >= n) return;

  float2 acc[1][4][3];
  full_hop_sum_from(acc, psi, 0, 1, There<R, float>{u, u}, T, Z, Y, X, YX,
                    ZYX, n, tb_sign, site);
  st_planes(out, acc, n, site);
}

}  // namespace

// All float32; rows: 3 or 2.  Lattice (T, Z, Y, X) in full sites.
extern "C" int qtt_wilson_full_there(void* out, const void* psi,
                                     const void* u, int T, int Z, int Y,
                                     int X, int rows, int tb_sign,
                                     void* stream) {
  const int64_t n = static_cast<int64_t>(T) * Z * Y * X;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (n <= 0 || blocks > 0x7fffffff || (rows != 2 && rows != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned nb = static_cast<unsigned>(blocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  const float* p = static_cast<const float*>(psi);
  const float* g = static_cast<const float*>(u);
  if (rows == 3) {
    wilson_full_there_kernel<3><<<nb, kThreads, 0, s>>>(o, p, g, T, Z, Y, X,
                                                        tb_sign);
  } else {
    wilson_full_there_kernel<2><<<nb, kThreads, 0, s>>>(o, p, g, T, Z, Y, X,
                                                        tb_sign);
  }
  return static_cast<int>(cudaGetLastError());
}
