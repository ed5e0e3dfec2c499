// Device code of the Wilson hop on the packed pair layout, shared by the
// eo hop kernel (B1, wilson_eo.cu), the fused clover hop (B7,
// clover_eo.cu, and its full-lattice form, clover_full.cu), the
// full-lattice hops (B4 and the copy-free B10, wilson_full.cu; B11 on the
// canonical layout, wilson_canonical.cu) and the copy-free and int8 eo
// hops (wilson_eo_there.cu, wilson_eo_int8.cu): the spin tables, the
// f32/bf16/f64 loads and stores, the link load (R = 3 rows, or R = 2 with
// row 2 rebuilt), the link sources (pre-shifted backward links, their
// copy in a block's shared memory, backward links read unshifted at the
// neighbour, int8 block-float links, the canonical gauge), the clover block entry load, one hop direction, and
// the whole 8-direction hop at one target site: eo_hop_sum on the half
// lattice, full_hop_sum on the full one; and the layouts (the pair
// layout of component planes, the fold layout of wilson_eo_fold.cu, the
// site-major layout of the canonical arrays).  Both
// hop sums take a compile-time count NB of right-hand sides: each
// direction's link is loaded (and its row 2 rebuilt) once and applied to
// NB spinors, which is what the multi-RHS kernels (B5-eo,
// wilson_eo_mrhs.cu; B7-mrhs, clover_eo_mrhs.cu) are for.  The single-RHS
// kernels run NB = 1; every right-hand side sees the same arithmetic in
// the same order for any NB.
//
// Real type: the hop works in the accumulator type of its storage,
// cplx_t<S>: float2 for float32 and bfloat16 storage (every load converts
// to f32, every sum is f32), double2 for float64 storage (the native
// double forms; no float literal or float temporary touches a double
// value).
//
// Layout; every spin/colour/re-im component is its own plane of
// S = T*Z*Y*Xh half-sites (or T*Z*Y*X sites for the full-lattice hop), so
// adjacent threads read adjacent addresses:
//   psi       (4, 3, 2, T, Z, Y*Xh)     parity 1-p in
//   u_here    (4, R, 3, 2, T, Z, Y*Xh)  U_mu(x) at the target sites x
//   u_bw      (4, R, 3, 2, T, Z, Y*Xh)  U_mu(x - mu), taken from the opposite
//                                       parity and shifted once per gauge load
//   u_there   (4, R, 3, 2, T, Z, Y*Xh)  the opposite parity's links, unshifted
//                                       (the copy-free forms read U_mu(x - mu)
//                                       there, at the neighbour x - mu)
// The NB spinors of one call lie rstride elements apart (24 * S for a
// (N, 4, 3, 2, T, Z, Y*Xh) batch); only the first nvalid of them are read
// (a tail chunk).  Offsets are 64-bit.
//
// The folded layout (to_fold: (..., 2, T, Z, Y*Xh) -> (..., T, 2Z, Y*Xh),
// re and im rows interleaved along z) keeps each component in a plane of
// 2S elements too, so only where a half-site's number lies in its plane
// changes: FoldLayout below.  The eo hop takes the layout as a template
// argument, so the fold hop is this hop, load for load.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace qtt {


// Spin-projection table of P = 1 - sign*gamma_mu (quda_tpu_torch/ops/
// wilson_pallas.py TABLES): h_a = psi_a + c_a psi_{j_a} for a = 0, 1;
// out_2 = d_2 h_{k_2}, out_3 = d_3 h_{k_3}.  Complex factors as (re, im).
struct Tab {
  int j0, c0r, c0i, j1, c1r, c1i, k2, d2r, d2i, k3, d3r, d3i;
};

__host__ __device__ constexpr Tab tab(int mu, int sign) {
  // tests/test_torch_wilson.py parses these rows and checks them
  // against TABLES.
  constexpr Tab rows[8] = {
      {3, 0, -1, 2, 0, -1, 1, 0, 1, 0, 0, 1},    // mu=0 sign=+1
      {3, 0, 1, 2, 0, 1, 1, 0, -1, 0, 0, -1},    // mu=0 sign=-1
      {3, 1, 0, 2, -1, 0, 1, -1, 0, 0, 1, 0},    // mu=1 sign=+1
      {3, -1, 0, 2, 1, 0, 1, 1, 0, 0, -1, 0},    // mu=1 sign=-1
      {2, 0, -1, 3, 0, 1, 0, 0, 1, 1, 0, -1},    // mu=2 sign=+1
      {2, 0, 1, 3, 0, -1, 0, 0, -1, 1, 0, 1},    // mu=2 sign=-1
      {2, -1, 0, 3, -1, 0, 0, -1, 0, 1, -1, 0},  // mu=3 sign=+1
      {2, 1, 0, 3, 1, 0, 0, 1, 0, 1, 1, 0},      // mu=3 sign=-1
  };
  return rows[2 * mu + (sign < 0 ? 1 : 0)];
}

// complex numbers as (re, im) in float2 (f32) or double2 (f64)
__device__ __forceinline__ float2 mkc(float re, float im) {
  return make_float2(re, im);
}
__device__ __forceinline__ double2 mkc(double re, double im) {
  return make_double2(re, im);
}

template <typename C>
__device__ __forceinline__ C czero();
template <>
__device__ __forceinline__ float2 czero<float2>() {
  return make_float2(0.f, 0.f);
}
template <>
__device__ __forceinline__ double2 czero<double2>() {
  return make_double2(0.0, 0.0);
}

template <typename C>
__device__ __forceinline__ C cadd(C a, C b) {
  return mkc(a.x + b.x, a.y + b.y);
}

template <typename C>
__device__ __forceinline__ C cmul(C a, C b) {
  return mkc(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// c * x for c in {+1, -1, +i, -i}
template <int CR, int CI, typename C>
__device__ __forceinline__ C cscale(C x) {
  static_assert((CR == 0) != (CI == 0), "factors are +-1 or +-i");
  if constexpr (CI == 0) {
    return CR > 0 ? x : mkc(-x.x, -x.y);
  } else {
    return CI > 0 ? mkc(-x.y, x.x) : mkc(x.y, -x.x);
  }
}

// storage element -> the accumulator's real, and back
__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ double ld(const double* p) { return __ldg(p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void st(double* p, double v) { *p = v; }

// the complex accumulator type of storage S
template <typename S>
struct Cplx {
  using type = float2;
};
template <>
struct Cplx<double> {
  using type = double2;
};
template <typename S>
using cplx_t = typename Cplx<S>::type;

// component (s, c) of psi at address a (the imaginary part im further on)
template <typename S>
__device__ __forceinline__ cplx_t<S> ld_psi(const S* __restrict__ psi,
                                            int s, int c, int64_t n,
                                            int64_t a, int64_t im) {
  const S* q = psi + static_cast<int64_t>((s * 3 + c) * 2) * n + a;
  return mkc(ld(q), ld(q + im));
}

// component (s, c) of psi at half-site i of the pair layout
template <typename S>
__device__ __forceinline__ cplx_t<S> ld_psi(const S* __restrict__ psi,
                                            int s, int c, int64_t n,
                                            int64_t i) {
  return ld_psi(psi, s, c, n, i, n);
}

// Where the complex number of half-site i lies in one component plane
// (component k's plane starts at k * 2n, n = T*Z*Y*Xh):
//   PairLayout  (..., 2, T, Z, Y*Xh): re at i, im one plane (n) further on;
//   FoldLayout  (..., T, 2Z, Y*Xh): the row r = t*Z + z of half-site
//               i = r*YXh + yx holds re at 2r*YXh + yx = i + r*YXh and im
//               YXh further on.
// at(i, r) is the address of re, im(n) the offset of im, and kRowScale the
// factor on the z and t neighbour strides (a z or t neighbour is a row
// away: two rows in the fold); x and y neighbours keep the row.
struct PairLayout {
  static constexpr int kRowScale = 1;
  __device__ __forceinline__ int64_t at(int64_t i, int64_t) const {
    return i;
  }
  __device__ __forceinline__ int64_t im(int64_t n) const { return n; }
};

struct FoldLayout {
  static constexpr int kRowScale = 2;
  int64_t yxh;
  __device__ __forceinline__ int64_t at(int64_t i, int64_t r) const {
    return i + r * yxh;
  }
  __device__ __forceinline__ int64_t im(int64_t) const { return yxh; }
};

// The site-major layout of the canonical pair arrays (kernel B11,
// wilson_canonical.cu): psi (T, Z, Y, X, 4, 3, 2), component k = 3s + c of
// site i at i*24 + 2k with re and im adjacent, so one 8-byte (f32) or
// 16-byte (f64) load reads the complex number.  Sites are numbered as in
// the plane layouts (t, z, y, x), so the neighbour placement is theirs;
// only the loads differ (ld_psi_in below, SiteThere's links).
struct SiteLayout {
  static constexpr int kRowScale = 1;
  __device__ __forceinline__ int64_t at(int64_t i, int64_t) const {
    return i;
  }
  __device__ __forceinline__ int64_t im(int64_t) const { return 1; }
};

// one complex number whose re and im are adjacent
__device__ __forceinline__ float2 ld_cplx(const float* q) {
  return __ldg(reinterpret_cast<const float2*>(q));
}
__device__ __forceinline__ double2 ld_cplx(const double* q) {
  return __ldg(reinterpret_cast<const double2*>(q));
}

// component (s, c) of psi at address a of layout Lay: the plane layouts
// read re and im from two places im apart; the site-major layout reads
// both at once at site a
template <typename S, typename Lay>
__device__ __forceinline__ cplx_t<S> ld_psi_in(const Lay&,
                                               const S* __restrict__ psi,
                                               int s, int c, int64_t n,
                                               int64_t a, int64_t im) {
  return ld_psi(psi, s, c, n, a, im);
}
template <typename S>
__device__ __forceinline__ cplx_t<S> ld_psi_in(const SiteLayout&,
                                               const S* __restrict__ psi,
                                               int s, int c, int64_t,
                                               int64_t a, int64_t) {
  return ld_cplx(psi + a * 24 + (s * 3 + c) * 2);
}

// the layout Lay of planes whose rows hold yxh = Y*Xh half-sites
template <typename Lay>
__device__ __forceinline__ Lay make_layout(int64_t yxh);
template <>
__device__ __forceinline__ PairLayout make_layout<PairLayout>(int64_t) {
  return PairLayout{};
}
template <>
__device__ __forceinline__ FoldLayout make_layout<FoldLayout>(int64_t yxh) {
  return FoldLayout{yxh};
}

// Entry (ch, i, j) of the clover blocks (2, 6, 6, 2, T, Z, Y*Xh) at half-site
// i: the epilogue load of the fused clover hops (clover_eo.cu,
// clover_eo_mrhs.cu).
template <typename S>
__device__ __forceinline__ cplx_t<S> ld_blk(const S* __restrict__ blk,
                                            int ch, int a, int b,
                                            int64_t n, int64_t i) {
  const S* q = blk + static_cast<int64_t>(((ch * 6 + a) * 6 + b) * 2) * n + i;
  return mkc(ld(q), ld(q + n));
}

// Row 2 of a recon-12 link from rows 0 and 1: conj(row0 x row1) *
// row2_sign (+-1, exact in any real type).
template <typename C>
__device__ __forceinline__ void rebuild_row2(C (&u)[3][3], float row2_sign) {
  using Re = decltype(u[0][0].x);
  const Re sg = static_cast<Re>(row2_sign);
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    const int b1 = (b + 1) % 3, b2 = (b + 2) % 3;
    const C p = cmul(u[0][b1], u[1][b2]);
    const C q = cmul(u[0][b2], u[1][b1]);
    u[2][b] = mkc((p.x - q.x) * sg, -(p.y - q.y) * sg);
  }
}

// The 3x3 link of direction mu at address i (the imaginary parts im
// further on: n in the pair layout).  With R = 2 only rows 0 and 1 are
// stored: row 2 = conj(row0 x row1) * row2_sign (+-1, exact in any real
// type).
template <int R, typename S, typename C>
__device__ __forceinline__ void ld_link(C (&u)[3][3],
                                        const S* __restrict__ g, int mu,
                                        int64_t n, int64_t i,
                                        float row2_sign, int64_t im) {
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const S* q = g + static_cast<int64_t>(((mu * R + a) * 3 + b) * 2) * n + i;
      u[a][b] = mkc(ld(q), ld(q + im));
    }
  if constexpr (R == 2) rebuild_row2(u, row2_sign);
}

// Link sources of the hop, chosen at compile time: where the 3x3 link of
// one hop direction is read.  ``load<MU, SIGN>`` gets the target
// half-site ``site`` and the neighbour ``nb`` that psi is read at (x + mu
// forward, x - mu backward), both as addresses of the layout, whose
// imaginary parts lie ``im`` further on.
//   Shifted<R, S>  forward U_mu(x) from ``here`` at the target site,
//                  backward U_mu(x - mu) from the pre-shifted ``bw``, also
//                  at the target site (B1, B4, K1/K2 and their multi-RHS
//                  forms);
//   There<R, S>    forward as Shifted's; backward read unshifted from
//                  ``there``, the opposite parity's links, at the
//                  neighbour x - mu: the index psi is read at, so the x
//                  hop's slot-parity select is the one psi's uses (the
//                  copy-free forms v3 and r12f);
//   TileShifted<R> Shifted's links from a block's copy in shared memory
//                  (B5, wilson_full.cu): (4, R, 3, 2) planes of ``ts``
//                  sites, forward ``here`` and pre-shifted backward ``bw``,
//                  the target at slot ``local``; the same numbers as the
//                  global arrays hold, so the hop's arithmetic is Shifted's;
//   Int8There      There's reads on int8 block-float links: 18 int8
//                  mantissas a link and one f32 scale a (direction, site)
//                  (4, T, Z, Y*Xh), each element decoded as float(q) * scale
//                  in one rounding (__fmul_rn, which nvcc does not contract
//                  into the colour product), so the decoded link is
//                  from_int8_links' bit for bit.
// The row-2 sign of an R = 2 link is the caller's, keyed to the target
// plane (t = 0 for the backward t link) whichever source reads it.
template <int R, typename S>
struct Shifted {
  const S* here;
  const S* bw;
  template <int MU, int SIGN, typename C>
  __device__ __forceinline__ void load(C (&u)[3][3], int64_t n, int64_t im,
                                       int64_t site, int64_t,
                                       float row2_sign) const {
    ld_link<R>(u, SIGN > 0 ? here : bw, MU, n, site, row2_sign, im);
  }
};

template <int R, typename S>
struct There {
  const S* here;
  const S* there;
  template <int MU, int SIGN, typename C>
  __device__ __forceinline__ void load(C (&u)[3][3], int64_t n, int64_t im,
                                       int64_t site, int64_t nb,
                                       float row2_sign) const {
    ld_link<R>(u, SIGN > 0 ? here : there, MU, n, SIGN > 0 ? site : nb,
               row2_sign, im);
  }
};

template <int R>
struct TileShifted {
  const float* here;
  const float* bw;
  int ts;
  int local;
  template <int MU, int SIGN>
  __device__ __forceinline__ void load(float2 (&u)[3][3], int64_t, int64_t,
                                       int64_t, int64_t,
                                       float row2_sign) const {
    const float* g = (SIGN > 0 ? here : bw) + local;
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const float* q = g + ((MU * R + a) * 3 + b) * 2 * ts;
        u[a][b] = make_float2(q[0], q[ts]);
      }
    if constexpr (R == 2) rebuild_row2(u, row2_sign);
  }
};

//   SiteThere<S>   the canonical gauge (4, T, Z, Y, X, 3, 3, 2) of the
//                  site-major layout, link mu of site i at (mu*n + i)*18:
//                  forward at the target, backward unshifted at the
//                  neighbour, as There reads; R = 3, each element one
//                  complex load (kernel B11).
template <typename S>
struct SiteThere {
  const S* g;
  template <int MU, int SIGN, typename C>
  __device__ __forceinline__ void load(C (&u)[3][3], int64_t n, int64_t,
                                       int64_t site, int64_t nb,
                                       float) const {
    const S* q = g + (static_cast<int64_t>(MU) * n + (SIGN > 0 ? site : nb)) *
                         18;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) u[a][b] = ld_cplx(q + (a * 3 + b) * 2);
  }
};

struct Int8There {
  const int8_t* q_here;
  const float* s_here;
  const int8_t* q_there;
  const float* s_there;
  template <int MU, int SIGN>
  __device__ __forceinline__ void load(float2 (&u)[3][3], int64_t n, int64_t,
                                       int64_t site, int64_t nb,
                                       float) const {
    const int64_t i = SIGN > 0 ? site : nb;
    const int8_t* q = SIGN > 0 ? q_here : q_there;
    const float sc = __ldg((SIGN > 0 ? s_here : s_there) + MU * n + i);
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const int8_t* p =
            q + static_cast<int64_t>(((MU * 3 + a) * 3 + b) * 2) * n + i;
        u[a][b] = make_float2(__fmul_rn(static_cast<float>(__ldg(p)), sc),
                              __fmul_rn(static_cast<float>(__ldg(p + n)), sc));
      }
  }
};

// One hop for NB right-hand sides: psi read at neighbour nb, the link from
// the link source L.  SIGN > 0 is the forward hop (1 - gamma_mu) U
// psi(x+mu); SIGN < 0 the backward hop (1 + gamma_mu) U^dag psi(x-mu),
// U^dag[a][b] = conj(U[b][a]).  The link is loaded once for all NB
// spinors.  nb and site are addresses of the layout ``lay``, im its
// offset of the imaginary part.
template <int MU, int SIGN, int NB, typename S, typename C, typename L,
          typename Lay>
__device__ __forceinline__ void hop(C (&acc)[NB][4][3],
                                    const S* __restrict__ psi,
                                    int64_t rstride, int nvalid,
                                    const L& links, const Lay& lay,
                                    int64_t n, int64_t im, int64_t nb,
                                    int64_t site, float row2_sign) {
  constexpr Tab t = tab(MU, SIGN);
  C u[3][3];
  links.template load<MU, SIGN>(u, n, im, site, nb, row2_sign);
  C m[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      m[a][b] = SIGN > 0 ? u[a][b] : mkc(u[b][a].x, -u[b][a].y);
    }
#pragma unroll
  for (int r = 0; r < NB; ++r) {
    if (NB > 1 && r >= nvalid) break;
    const S* p = psi + r * rstride;
    C h[2][3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      h[0][c] = cadd(ld_psi_in(lay, p, 0, c, n, nb, im),
                     cscale<t.c0r, t.c0i>(
                         ld_psi_in(lay, p, t.j0, c, n, nb, im)));
      h[1][c] = cadd(ld_psi_in(lay, p, 1, c, n, nb, im),
                     cscale<t.c1r, t.c1i>(
                         ld_psi_in(lay, p, t.j1, c, n, nb, im)));
    }
    C uh[2][3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        C v = cmul(m[a][0], h[s][0]);
        v = cadd(v, cmul(m[a][1], h[s][1]));
        uh[s][a] = cadd(v, cmul(m[a][2], h[s][2]));
      }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      acc[r][0][c] = cadd(acc[r][0][c], uh[0][c]);
      acc[r][1][c] = cadd(acc[r][1][c], uh[1][c]);
      acc[r][2][c] = cadd(acc[r][2][c], cscale<t.d2r, t.d2i>(uh[t.k2][c]));
      acc[r][3][c] = cadd(acc[r][3][c], cscale<t.d3r, t.d3i>(uh[t.k3][c]));
    }
  }
}

// Neighbour indices of one target site, forward and backward per
// direction, and the sign of the rebuilt row 2 of its t links (R = 2
// only): with tb_sign it is negated on the antiperiodic boundary planes,
// forward links on t = T-1, pre-shifted backward links on t = 0.
struct Nbrs {
  int64_t fwd[4], bwd[4];
  float s_t_fwd, s_t_bwd;
};

// y, z and t neighbours and the t-boundary signs, shared by both
// lattices: the fused row axis holds W = Xh (eo) or X (full) slots.
__device__ __forceinline__ void yzt_nbrs(Nbrs& nb, int64_t site, int y,
                                         int z, int t, int T, int Z, int Y,
                                         int64_t W, int64_t YW,
                                         int64_t ZYW, int tb_sign) {
  nb.fwd[1] = site + (y + 1 == Y ? -(Y - 1) * W : W);
  nb.bwd[1] = site + (y == 0 ? (Y - 1) * W : -W);
  nb.fwd[2] = site + (z + 1 == Z ? -(Z - 1) * YW : YW);
  nb.bwd[2] = site + (z == 0 ? (Z - 1) * YW : -YW);
  nb.fwd[3] = site + (t + 1 == T ? -(T - 1) * ZYW : ZYW);
  nb.bwd[3] = site + (t == 0 ? (T - 1) * ZYW : -ZYW);
  nb.s_t_fwd = (tb_sign && t == T - 1) ? -1.f : 1.f;
  nb.s_t_bwd = (tb_sign && t == 0) ? -1.f : 1.f;
}

// The 8 hops at target site ``site`` into acc (zeroed first), in the TPU
// kernel's order: x, y, z, t, forward before backward; links from L.
// Sites are addresses of the layout ``lay``, im its offset of the
// imaginary part.
template <int NB, typename S, typename C, typename L, typename Lay>
__device__ __forceinline__ void hop_sum(C (&acc)[NB][4][3],
                                        const S* __restrict__ psi,
                                        int64_t rs, int nvalid,
                                        const L& lk, const Lay& lay,
                                        int64_t n, int64_t im,
                                        const Nbrs& nb, int64_t site) {
#pragma unroll
  for (int r = 0; r < NB; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int c = 0; c < 3; ++c) acc[r][s][c] = czero<C>();

  hop<0, +1>(acc, psi, rs, nvalid, lk, lay, n, im, nb.fwd[0], site,
             1.f);
  hop<0, -1>(acc, psi, rs, nvalid, lk, lay, n, im, nb.bwd[0], site,
             1.f);
  hop<1, +1>(acc, psi, rs, nvalid, lk, lay, n, im, nb.fwd[1], site,
             1.f);
  hop<1, -1>(acc, psi, rs, nvalid, lk, lay, n, im, nb.bwd[1], site,
             1.f);
  hop<2, +1>(acc, psi, rs, nvalid, lk, lay, n, im, nb.fwd[2], site,
             1.f);
  hop<2, -1>(acc, psi, rs, nvalid, lk, lay, n, im, nb.bwd[2], site,
             1.f);
  hop<3, +1>(acc, psi, rs, nvalid, lk, lay, n, im, nb.fwd[3], site,
             nb.s_t_fwd);
  hop<3, -1>(acc, psi, rs, nvalid, lk, lay, n, im, nb.bwd[3], site,
             nb.s_t_bwd);
}

// The hop sum D_{p <- 1-p} psi at target half-site ``site`` into acc.  A
// thread computes its 8 neighbour indices directly: t, z and y wrap on
// their own axes (y by Xh on the fused Y*Xh axis), and x is the slot-parity
// select of shift_eo_packed, with r0 = ((t+z+y+parity) % 2 == 0) constant
// along a row.  The caller passes the plane strides it computed (YXh =
// Y*Xh, ZYXh = Z*YXh, n = T*ZYXh), so the kernel and the hop share one set.
// The NB right-hand sides are psi + r * rstride, r < nvalid; acc[r] is
// zeroed and summed for each of them.  The links come from the link
// source ``lk`` (Shifted, There, Int8There); psi and the links lie in the
// layout ``lay`` (PairLayout, or FoldLayout for the fold hop, whose
// neighbours are placed from their own rows: a z neighbour is two folded
// rows away).  Returns the target's address in that layout, where the
// caller stores.
template <int NB, typename S, typename C, typename L,
          typename Lay = PairLayout>
__device__ __forceinline__ int64_t eo_hop_sum_from(
    C (&acc)[NB][4][3], const S* __restrict__ psi, int64_t rstride,
    int nvalid, const L& lk, int T, int Z, int Y, int Xh, int64_t YXh,
    int64_t ZYXh, int64_t n, int parity, int tb_sign, int64_t site,
    const Lay& lay = Lay()) {
  const int xh = static_cast<int>(site % Xh);
  const int y = static_cast<int>((site / Xh) % Y);
  const int z = static_cast<int>((site / YXh) % Z);
  const int t = static_cast<int>(site / ZYXh);

  // neighbour half-sites, with shift_eo_packed's semantics, as addresses
  // of the layout: x and y neighbours share the target's row, z and t
  // neighbours lie kRowScale times as far as in the pair layout
  Nbrs nb;
  const bool r0 = ((t + z + y + parity) & 1) == 0;
  const int64_t a = lay.at(site, static_cast<int64_t>(t) * Z + z);
  const int64_t row = a - xh;
  nb.fwd[0] = row + (r0 ? xh : (xh + 1 == Xh ? 0 : xh + 1));
  nb.bwd[0] = row + (r0 ? (xh == 0 ? Xh - 1 : xh - 1) : xh);
  yzt_nbrs(nb, a, y, z, t, T, Z, Y, Xh, Lay::kRowScale * YXh,
           Lay::kRowScale * ZYXh, tb_sign);
  hop_sum(acc, psi, rstride, nvalid, lk, lay, n, lay.im(n), nb, a);
  return a;
}

// eo_hop_sum_from with the pre-shifted backward links (B1, K1/K2 and their
// multi-RHS forms).
template <int R, int NB, typename S, typename C>
__device__ __forceinline__ void eo_hop_sum(C (&acc)[NB][4][3],
                                           const S* __restrict__ psi,
                                           int64_t rstride, int nvalid,
                                           const S* __restrict__ u_here,
                                           const S* __restrict__ u_bw,
                                           int T, int Z, int Y, int Xh,
                                           int64_t YXh, int64_t ZYXh,
                                           int64_t n, int parity,
                                           int tb_sign, int64_t site) {
  eo_hop_sum_from(acc, psi, rstride, nvalid, Shifted<R, S>{u_here, u_bw}, T,
                  Z, Y, Xh, YXh, ZYXh, n, parity, tb_sign, site);
}

// The full-lattice hop sum D psi at site ``site`` (layouts over
// S = T*Z*Y*X sites, YX = Y*X, ZYX = Z*YX): the x hop wraps inside its own
// row of X slots of the fused Y*X axis and never carries into y
// (wilson_packed._x_wrap_masks), y, z and t as on the half lattice.  The
// links come from the link source ``lk``: Shifted (B4, B5 and the
// full-lattice clover hop), There with the links as both ``here`` and
// ``there`` (the copy-free B10: U_mu(x - mu) read at the neighbour), or
// SiteThere on the site-major layout ``lay`` (B11).
template <int NB, typename S, typename C, typename L,
          typename Lay = PairLayout>
__device__ __forceinline__ void full_hop_sum_from(
    C (&acc)[NB][4][3], const S* __restrict__ psi, int64_t rstride,
    int nvalid, const L& lk, int T, int Z, int Y, int X, int64_t YX,
    int64_t ZYX, int64_t n, int tb_sign, int64_t site,
    const Lay& lay = Lay()) {
  const int x = static_cast<int>(site % X);
  const int y = static_cast<int>((site / X) % Y);
  const int z = static_cast<int>((site / YX) % Z);
  const int t = static_cast<int>(site / ZYX);

  Nbrs nb;
  nb.fwd[0] = site + (x + 1 == X ? -(X - 1) : 1);
  nb.bwd[0] = site + (x == 0 ? X - 1 : -1);
  yzt_nbrs(nb, site, y, z, t, T, Z, Y, X, YX, ZYX, tb_sign);
  hop_sum(acc, psi, rstride, nvalid, lk, lay, n, lay.im(n), nb, site);
}

// full_hop_sum_from with the pre-shifted backward links (B4, B5 and the
// full-lattice clover hop).
template <int R, int NB, typename S, typename C>
__device__ __forceinline__ void full_hop_sum(C (&acc)[NB][4][3],
                                             const S* __restrict__ psi,
                                             int64_t rstride, int nvalid,
                                             const S* __restrict__ u_here,
                                             const S* __restrict__ u_bw,
                                             int T, int Z, int Y, int X,
                                             int64_t YX, int64_t ZYX,
                                             int64_t n, int tb_sign,
                                             int64_t site) {
  full_hop_sum_from(acc, psi, rstride, nvalid, Shifted<R, S>{u_here, u_bw},
                    T, Z, Y, X, YX, ZYX, n, tb_sign, site);
}

}  // namespace qtt
