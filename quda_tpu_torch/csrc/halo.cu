// The halo kernels of the sharded Wilson path (B12): the slab exchange and
// the two fused-halo hops, on the sub-domains of a mesh
// (quda_tpu_torch/parallel/mesh.py) whose blocks may share a card (a
// virtual mesh) or sit on several cards of one host.
//
// Replaces: quda_tpu/parallel/pallas_halo.py, the three Pallas TPU kernels
// with in-kernel remote copies:
//   qtt_slab_exchange      slab_exchange_bidir (pallas_call at :394, body
//                          _make_exchange_kernel at :330);
//   qtt_wilson_axis_halo   wilson_axis_fused_halo (pallas_call at :289,
//                          body _make_fused_kernel_bidir at :154) with
//                          bidir = 1, and wilson_zbwd_fused_halo
//                          (pallas_call at :512, body _make_fused_kernel at
//                          :81) with bidir = 0, mu = 2.
// Plain versions: quda_tpu_torch/parallel/pallas_halo.py::
// slab_exchange_plain and wilson_axis_halo_plain.
//
// The TPU kernels signal the neighbour, wait on a barrier semaphore and
// start remote DMAs inside the kernel.  Here one launch on a card serves
// every sub-domain resident there: it gets a table of the blocks of all
// sub-domains (pointers, passed by value in the kernel's parameters) and
// reads a neighbour's data through its pointer, on the same card or
// through a peer mapping on another (the wrapper enables peer access once
// and raises if it is refused; nothing is staged through the host).  No
// kernel waits on a flag: the data it reads was written by work ordered
// before it, by stream order on one card and by a CUDA event between
// cards (cudaStreamWaitEvent, in the wrapper), so no launch can wait on
// work queued behind it.
//
// qtt_slab_exchange: a table of copies, the faces of one partitioned axis.
// Each source face is read in place: ``runs`` contiguous runs of ``run``
// bytes, each ``stride`` bytes after the last (a t or z plane, or a y row
// strip, of a contiguous block), written packed into its receiver's
// buffer.  blockIdx.y picks the copy, and the threads stride over it in
// 16-byte vectors (byte copies where a run, a stride or an end is not
// 16-byte aligned).  Bit for bit the plain transport.  Bound: device
// memory (each byte read once, written once).
//
// qtt_wilson_axis_halo: both hops of one partitioned direction mu (2: z on
// (4,3,2,Z,YX) blocks; 3: t on (4,3,2,T,Z,YX) blocks; either way the
// partitioned axis is the plane index r of (4,3,2,L,S), S the product of
// the trailing extents), or the backward hop alone.  One thread per local
// site computes U(x-mu)^dag P+ psi(x-mu) and, with bidir, U(x) P- psi(x+mu),
// reading psi(x-mu) and U(x-mu) from the -mu neighbour's last plane at
// r = 0 and psi(x+mu) from the +mu neighbour's first plane at r = L-1.
// The hop arithmetic is wilson_hop.cuh's (hop<MU, SIGN>), with a link
// source that reads the one direction's (3,3,2,L,S) links.  float32 only,
// as the TPU kernels.  Bound: device memory (psi 96 B, links 72 B, out
// 96 B a site; the neighbour planes add 1/L of that).
#include <cstdint>

#include "wilson_hop.cuh"

namespace {

using namespace qtt;

constexpr int kMaxEntries = 64;
constexpr int kCopyThreads = 256;
constexpr int kCopyMaxBlocksX = 4096;
constexpr int kHopThreads = 128;

struct CopyTable {
  const char* src[kMaxEntries];
  char* dst[kMaxEntries];
  int64_t run[kMaxEntries];     // bytes of one contiguous run of the face
  int64_t runs[kMaxEntries];    // runs of the face
  int64_t stride[kMaxEntries];  // bytes from one run's start to the next
};

__global__ void __launch_bounds__(kCopyThreads)
    slab_exchange_kernel(CopyTable tb) {
  const int e = blockIdx.y;
  const char* s = tb.src[e];
  char* d = tb.dst[e];
  const int64_t rb = tb.run[e];
  const int64_t st = tb.stride[e];
  // the host keeps every face under 2 GiB: in-face offsets fit 32 bits
  const uint32_t nb = static_cast<uint32_t>(rb * tb.runs[e]);
  const uint32_t stride = gridDim.x * kCopyThreads;
  const uint32_t t0 = blockIdx.x * kCopyThreads + threadIdx.x;
  const bool vec = ((reinterpret_cast<uintptr_t>(s) |
                     reinterpret_cast<uintptr_t>(d) |
                     static_cast<uintptr_t>(rb) |
                     static_cast<uintptr_t>(st)) & 15) == 0;
  if (vec) {
    const uint32_t rv = static_cast<uint32_t>(rb / 16);  // vectors a run
    int4* d4 = reinterpret_cast<int4*>(d);
    for (uint32_t i = t0; i < nb / 16; i += stride) {
      const uint32_t r = i / rv;
      d4[i] = *reinterpret_cast<const int4*>(s + r * st + 16 * (i - r * rv));
    }
  } else {
    const uint32_t rbb = static_cast<uint32_t>(rb);
    for (uint32_t i = t0; i < nb; i += stride) {
      const uint32_t r = i / rbb;
      d[i] = s[r * st + (i - r * rbb)];
    }
  }
}

// The (3,3,2,L,S) links of one direction: forward U(x) at the target site
// from ``here``, backward U(x - mu) at the neighbour from ``there`` (the
// target's own block, or the -mu neighbour's at the boundary plane).
struct OneDir {
  const float* here;
  const float* there;
  template <int MU, int SIGN, typename C>
  __device__ __forceinline__ void load(C (&u)[3][3], int64_t n, int64_t im,
                                       int64_t site, int64_t nb,
                                       float row2_sign) const {
    ld_link<3>(u, SIGN > 0 ? here : there, 0, n, SIGN > 0 ? site : nb,
               row2_sign, im);
  }
};

struct HopTable {
  const float* psi[kMaxEntries];
  const float* u[kMaxEntries];
  float* out[kMaxEntries];
  int dn[kMaxEntries];   // the -mu neighbour of each ring member
  int up[kMaxEntries];   // the +mu neighbour
  int sel[kMaxEntries];  // the ring members this launch computes
};

template <int MU, bool BIDIR>
__global__ void __launch_bounds__(kHopThreads)
    axis_halo_kernel(HopTable tb, int L, int64_t S) {
  const int k = tb.sel[blockIdx.y];
  const int64_t n = static_cast<int64_t>(L) * S;
  const int64_t site =
      static_cast<int64_t>(blockIdx.x) * kHopThreads + threadIdx.x;
  if (site >= n) return;
  const int64_t r = site / S;
  const int64_t s = site - r * S;

  float2 acc[1][4][3];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[0][a][c] = czero<float2>();

  // backward hop: psi and U at x - mu, from the -mu neighbour's last plane
  // on the boundary plane r = 0
  const bool edge_b = r == 0;
  const int kb = edge_b ? tb.dn[k] : k;
  const int64_t nb_b = edge_b ? (static_cast<int64_t>(L) - 1) * S + s
                              : site - S;
  hop<MU, -1, 1>(acc, tb.psi[kb], 0, 1, OneDir{tb.u[k], tb.u[kb]},
                 PairLayout{}, n, n, nb_b, site, 1.f);
  if constexpr (BIDIR) {
    // forward hop: psi at x + mu, from the +mu neighbour's first plane on
    // the boundary plane r = L - 1; the link is the target's own
    const bool edge_f = r == L - 1;
    const int kf = edge_f ? tb.up[k] : k;
    const int64_t nb_f = edge_f ? s : site + S;
    hop<MU, +1, 1>(acc, tb.psi[kf], 0, 1, OneDir{tb.u[k], tb.u[k]},
                   PairLayout{}, n, n, nb_f, site, 1.f);
  }
  float* out = tb.out[k];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float* q = out + static_cast<int64_t>((a * 3 + c) * 2) * n + site;
      st(q, acc[0][a][c].x);
      st(q + n, acc[0][a][c].y);
    }
}

template <int MU, bool BIDIR>
cudaError_t launch_hop(const HopTable& tb, int L, int64_t S, dim3 grid,
                       cudaStream_t stream) {
  axis_halo_kernel<MU, BIDIR><<<grid, kHopThreads, 0, stream>>>(tb, L, S);
  return cudaGetLastError();
}

}  // namespace

// n copies (host arrays, n <= 64), one launch on ``stream``: face e is
// runs[e] runs of run[e] bytes at src[e], each stride[e] bytes after the
// last, written packed to dst[e].
extern "C" int qtt_slab_exchange(const void* const* src, void* const* dst,
                                 const long long* run, const long long* runs,
                                 const long long* stride, int n,
                                 void* stream) {
  if (n <= 0 || n > kMaxEntries) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CopyTable tb;
  int64_t most = 0;
  for (int e = 0; e < n; ++e) {
    const int64_t nb = run[e] * runs[e];
    if (run[e] <= 0 || runs[e] <= 0 || stride[e] < run[e] ||
        nb >= (int64_t{1} << 31) || src[e] == nullptr ||
        dst[e] == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    tb.src[e] = static_cast<const char*>(src[e]);
    tb.dst[e] = static_cast<char*>(dst[e]);
    tb.run[e] = run[e];
    tb.runs[e] = runs[e];
    tb.stride[e] = stride[e];
    most = nb > most ? nb : most;
  }
  int64_t gx = (most / 16 + kCopyThreads - 1) / kCopyThreads;
  gx = gx < 1 ? 1 : (gx > kCopyMaxBlocksX ? kCopyMaxBlocksX : gx);
  slab_exchange_kernel<<<dim3(static_cast<unsigned>(gx), n), kCopyThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(tb);
  return static_cast<int>(cudaGetLastError());
}

// The fused-halo hop on the ring of n_ring sub-domains (host arrays psi,
// u, out, dn, up; n_ring <= 64), computing the n_sel members listed in
// sel; blocks (4,3,2,L,S) and (3,3,2,L,S) float32.  mu 2 or 3; bidir 1:
// both hops, 0: the backward hop alone.
extern "C" int qtt_wilson_axis_halo(const void* const* psi,
                                    const void* const* u,
                                    void* const* out, const int* dn,
                                    const int* up, int n_ring,
                                    const int* sel, int n_sel, int L,
                                    long long S, int mu, int bidir,
                                    void* stream) {
  const int64_t n = static_cast<int64_t>(L) * S;
  const int64_t blocks = (n + kHopThreads - 1) / kHopThreads;
  if (n_ring <= 0 || n_ring > kMaxEntries || n_sel <= 0 ||
      n_sel > n_ring || L <= 0 || S <= 0 || blocks > 0x7fffffff ||
      (mu != 2 && mu != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  HopTable tb;
  for (int k = 0; k < n_ring; ++k) {
    if (dn[k] < 0 || dn[k] >= n_ring || up[k] < 0 || up[k] >= n_ring) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    tb.psi[k] = static_cast<const float*>(psi[k]);
    tb.u[k] = static_cast<const float*>(u[k]);
    tb.out[k] = static_cast<float*>(out[k]);
    tb.dn[k] = dn[k];
    tb.up[k] = up[k];
  }
  for (int j = 0; j < n_sel; ++j) {
    if (sel[j] < 0 || sel[j] >= n_ring) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    tb.sel[j] = sel[j];
  }
  const dim3 grid(static_cast<unsigned>(blocks), n_sel);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (mu == 2) {
    err = bidir ? launch_hop<2, true>(tb, L, S, grid, s)
                : launch_hop<2, false>(tb, L, S, grid, s);
  } else {
    err = bidir ? launch_hop<3, true>(tb, L, S, grid, s)
                : launch_hop<3, false>(tb, L, S, grid, s);
  }
  return static_cast<int>(err);
}

// Let ``dev`` read ``peer``'s memory (once per pair; an already enabled
// pair is success).  Returns cudaErrorPeerAccessUnsupported where the
// pair cannot, and restores the calling thread's device.
extern "C" int qtt_enable_peer_access(int dev, int peer) {
  int can = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, dev, peer);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!can) return static_cast<int>(cudaErrorPeerAccessUnsupported);
  int prev = 0;
  err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    err = cudaSuccess;
  }
  const cudaError_t back = cudaSetDevice(prev);
  return static_cast<int>(err != cudaSuccess ? err : back);
}
