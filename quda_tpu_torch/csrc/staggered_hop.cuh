// Device code of the staggered hops on the packed pair layout, shared by
// the fused fat + Naik hop (S1) and the one-hop-set gather pass (S2), both
// in staggered_eo.cu, the multi-RHS gather pass (S2-mrhs,
// staggered_eo_mrhs.cu) and the full-lattice forms of all three
// (staggered_full.cu): the neighbour index of a site at x + s*n*mu for n
// in {1, 3} (half lattice: eo_site/EoSite; full lattice:
// full_site/FullSite), the colour-vector load, and the 3x3 colour
// multiply of one hop.  Both lattices go through the one hop body, so
// every form keeps the same arithmetic in the same order.  The link
// sources (where a hop's link is read: the target, the neighbour, a tile
// in shared memory), the link load and the f32/bf16 loads and stores are
// wilson_hop.cuh's (links have the Wilson R = 3 layout).  Like the
// Wilson hop, each hop takes a compile-time count NB of right-hand sides
// (rstride elements apart, the first nvalid of them read): the link is
// loaded once and applied to each in turn, so every right-hand side sees
// the single-RHS arithmetic in its order.  S1 and S2 run NB = 1.
//
// Layout; every colour/re-im component is its own plane of
// S = T*Z*Y*Xh half-sites (T*Z*Y*X sites on the full lattice), so
// adjacent threads read adjacent addresses:
//   psi, out  (3, 2, T, Z, Y*Xh)        full lattice: (3, 2, T, Z, Y*X)
//   links     (4, 3, 3, 2, T, Z, Y*Xh)  full lattice: (4, 3, 3, 2, T, Z, Y*X)
// The staggered phases and the antiperiodic t boundary are folded into the
// links (the long links' boundary on the last three t planes), so no hop
// carries a sign of its own.  Offsets are 64-bit.
//
// The half-lattice hops also take the layout of a component plane
// (wilson_hop.cuh's PairLayout, or FoldLayout for the fused fold hop:
// psi (3, T, 2Z, Y*Xh), links (4, 3, 3, T, 2Z, Y*Xh), to_fold of the pair
// layout): eo_site places the site at its address in the layout, and the
// hop set scales the z and t strides and reads the imaginary part where
// the layout puts it.  The arithmetic is the same either way.
#pragma once

#include "wilson_hop.cuh"

namespace qtt {

// Site coordinates of half-site `site` of parity `parity`: the packed rule
// mask_r0 = ((t+z+y+parity) % 2 == 0) puts the site of slot xh at
// x = 2*xh + ((t+z+y+parity) & 1).  site and row are addresses of the
// layout Lay.
struct EoSite {
  int t, z, y, xh, x;
  int64_t site, row;  // row: the half-site of slot 0 on this (t, z, y) row
};

template <typename Lay = PairLayout>
__device__ __forceinline__ EoSite eo_site(int64_t site, int Z, int Y,
                                          int Xh, int64_t YXh,
                                          int64_t ZYXh, int parity,
                                          const Lay& lay = Lay()) {
  EoSite s;
  s.xh = static_cast<int>(site % Xh);
  s.y = static_cast<int>((site / Xh) % Y);
  s.z = static_cast<int>((site / YXh) % Z);
  s.t = static_cast<int>(site / ZYXh);
  s.x = 2 * s.xh + ((s.t + s.z + s.y + parity) & 1);
  s.site = lay.at(site, static_cast<int64_t>(s.t) * Z + s.z);
  s.row = s.site - s.xh;
  return s;
}

// c + d wrapped into [0, e), for any |d| (extents may be below 3)
__device__ __forceinline__ int wrap(int c, int d, int e) {
  int v = (c + d) % e;
  return v < 0 ? v + e : v;
}

// Half-site index (on the opposite parity: n is odd) of x + d*mu, d = +-n.
// x moves to x' = (x + d) mod X, slot x'/2; y, z and t keep xh and move
// their own plane.  (W, YW, ZYW) = (Xh, Y*Xh, Z*Y*Xh).
template <int MU>
__device__ __forceinline__ int64_t site_neighbour(const EoSite& s, int d,
                                                  int T, int Z, int Y,
                                                  int W, int64_t YW,
                                                  int64_t ZYW) {
  if constexpr (MU == 0) {
    return s.row + wrap(s.x, d, 2 * W) / 2;
  } else if constexpr (MU == 1) {
    return s.site + static_cast<int64_t>(wrap(s.y, d, Y) - s.y) * W;
  } else if constexpr (MU == 2) {
    return s.site + static_cast<int64_t>(wrap(s.z, d, Z) - s.z) * YW;
  } else {
    return s.site + static_cast<int64_t>(wrap(s.t, d, T) - s.t) * ZYW;
  }
}

// Full-lattice site coordinates of `site` in (T, Z, Y*X) order.
struct FullSite {
  int t, z, y, x;
  int64_t site, row;  // row: the site of x = 0 on this (t, z, y) row
};

__device__ __forceinline__ FullSite full_site(int64_t site, int Z, int Y,
                                              int X, int64_t YX,
                                              int64_t ZYX) {
  FullSite s;
  s.x = static_cast<int>(site % X);
  s.y = static_cast<int>((site / X) % Y);
  s.z = static_cast<int>((site / YX) % Z);
  s.t = static_cast<int>(site / ZYX);
  s.site = site;
  s.row = site - s.x;
  return s;
}

// Site index of x + d*mu on the full lattice: an x hop wraps inside its
// row of X sites of the fused Y*X axis (the JAX package's x-wrap mask,
// as B4's full_hop_sum), never into the next y; y, z and t move their own
// plane.  (W, YW, ZYW) = (X, Y*X, Z*Y*X).
template <int MU>
__device__ __forceinline__ int64_t site_neighbour(const FullSite& s, int d,
                                                  int T, int Z, int Y,
                                                  int W, int64_t YW,
                                                  int64_t ZYW) {
  if constexpr (MU == 0) {
    return s.row + wrap(s.x, d, W);
  } else if constexpr (MU == 1) {
    return s.site + static_cast<int64_t>(wrap(s.y, d, Y) - s.y) * W;
  } else if constexpr (MU == 2) {
    return s.site + static_cast<int64_t>(wrap(s.z, d, Z) - s.z) * YW;
  } else {
    return s.site + static_cast<int64_t>(wrap(s.t, d, T) - s.t) * ZYW;
  }
}

// colour vector (3 complex) at address i of a (3, 2, S) field (the
// imaginary parts im further on: n in the pair layout)
template <typename S>
__device__ __forceinline__ void ld_cvec(float2 (&v)[3],
                                        const S* __restrict__ psi,
                                        int64_t n, int64_t i, int64_t im) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const S* q = psi + static_cast<int64_t>(2 * c) * n + i;
    v[c] = make_float2(ld(q), ld(q + im));
  }
}

// One hop into acc for NB right-hand sides: acc[r] += 0.5 U psi_r (FWD)
// or acc[r] -= 0.5 U^dag psi_r, with U^dag[a][b] = conj(U[b][a]); the link
// of direction MU from the link source L (loaded once), psi_r at address
// pi of psi + r * rstride, the imaginary parts im further on.  As the TPU
// kernel: the colour sum first, then the +-0.5 scale.
//
// The link sources are wilson_hop.cuh's, at R = 3 (the staggered links
// have the Wilson R = 3 layout), given the target ``site`` and the
// neighbour ``pi`` that psi is read at:
//   Shifted<3, S>  forward links at the target, the pre-shifted backward
//                  copy at the target too (the gather passes S2, S2-full
//                  and S2-mrhs);
//   There<3, S>    forward at the target, the unshifted links (the
//                  opposite parity's on the half lattice) at the backward
//                  neighbour (the fused hops S1, S1-full, S1-fold and the
//                  v3 pass);
//   TileShifted<3> Shifted's links from a block's copy in shared memory
//                  (S2-mrhs-full), the same numbers, so the same bits.
template <int MU, bool FWD, int NB, typename S, typename L>
__device__ __forceinline__ void stag_hop(float2 (&acc)[NB][3],
                                         const S* __restrict__ psi,
                                         int64_t rstride, int nvalid,
                                         const L& links, int64_t n,
                                         int64_t im, int64_t site,
                                         int64_t pi) {
  float2 u[3][3];
  links.template load<MU, FWD ? 1 : -1>(u, n, im, site, pi, 1.f);
  const float s = FWD ? 0.5f : -0.5f;
#pragma unroll
  for (int r = 0; r < NB; ++r) {
    if (NB > 1 && r >= nvalid) break;
    float2 v[3];
    ld_cvec(v, psi + r * rstride, n, pi, im);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float2 t = make_float2(0.f, 0.f);
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const float2 m = FWD ? u[a][b] : make_float2(u[b][a].x, -u[b][a].y);
        t = cadd(t, cmul(m, v[b]));
      }
      acc[r][a] = make_float2(acc[r][a].x + s * t.x, acc[r][a].y + s * t.y);
    }
  }
}

// Both hops of direction MU, hop count N, into acc, the links from the
// link source L.  Site is EoSite (W = Xh) or FullSite (W = X), placed in
// the layout Lay, whose z and t strides are kRowScale times YW and ZYW.
template <int MU, int N, int NB, typename S, typename L, typename Site,
          typename Lay>
__device__ __forceinline__ void stag_dir(float2 (&acc)[NB][3],
                                         const S* __restrict__ psi,
                                         int64_t rstride, int nvalid,
                                         const L& links, const Site& s,
                                         int T, int Z, int Y, int W,
                                         int64_t YW, int64_t ZYW,
                                         int64_t n, const Lay& lay) {
  constexpr int k = Lay::kRowScale;
  const int64_t fwd = site_neighbour<MU>(s, +N, T, Z, Y, W, k * YW, k * ZYW);
  const int64_t bwd = site_neighbour<MU>(s, -N, T, Z, Y, W, k * YW, k * ZYW);
  const int64_t im = lay.im(n);
  stag_hop<MU, true>(acc, psi, rstride, nvalid, links, n, im, s.site, fwd);
  stag_hop<MU, false>(acc, psi, rstride, nvalid, links, n, im, s.site, bwd);
}

// The whole hop set of hop count N (8 hops) into acc, directions in the
// TPU kernel's order (x, y, z, t; forward before backward); psi and the
// links in the layout ``lay`` (the pair layout unless given), YW and ZYW
// the pair layout's strides; the links from the link source L.
template <int N, int NB, typename S, typename L, typename Site,
          typename Lay = PairLayout>
__device__ __forceinline__ void stag_hopset(float2 (&acc)[NB][3],
                                            const S* __restrict__ psi,
                                            int64_t rstride, int nvalid,
                                            const L& links, const Site& s,
                                            int T, int Z, int Y, int W,
                                            int64_t YW, int64_t ZYW,
                                            int64_t n,
                                            const Lay& lay = Lay()) {
  stag_dir<0, N>(acc, psi, rstride, nvalid, links, s, T, Z, Y, W, YW, ZYW, n,
                 lay);
  stag_dir<1, N>(acc, psi, rstride, nvalid, links, s, T, Z, Y, W, YW, ZYW, n,
                 lay);
  stag_dir<2, N>(acc, psi, rstride, nvalid, links, s, T, Z, Y, W, YW, ZYW, n,
                 lay);
  stag_dir<3, N>(acc, psi, rstride, nvalid, links, s, T, Z, Y, W, YW, ZYW, n,
                 lay);
}

// out = acc (3 complex) at address i of a (3, 2, S) field, the imaginary
// parts im further on (n in the pair layout)
template <typename O>
__device__ __forceinline__ void st_cvec(O* __restrict__ out,
                                        const float2 (&v)[3], int64_t n,
                                        int64_t i, int64_t im) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    O* q = out + static_cast<int64_t>(2 * c) * n + i;
    st(q, v[c].x);
    st(q + im, v[c].y);
  }
}

template <typename O>
__device__ __forceinline__ void st_cvec(O* __restrict__ out,
                                        const float2 (&v)[3], int64_t n,
                                        int64_t i) {
  st_cvec(out, v, n, i, n);
}

}  // namespace qtt
