// Shared device code of the hopping kernels (csrc/hopping.cu: K1, K1-S,
// K1-R, K2; csrc/hopping_slab.cu: the slab kernels K3, K3-I, K4 and K1-T):
// the half-spinor maps, the link load with the 12-real row-2 rebuild and the
// bf16 upcast, and the per-direction stencil step.  Every kernel that
// computes H psi runs these functions in the same order (directions 0..7,
// each: project, link times half-spinor, spread back), so a site's sum is
// formed the same way in all of them.
//
// Layouts (element strides, sites minor-most): psi [2 re/im][4][3][V] with
// Strides {im, comp}; ug [2 re/im][8 dir][rows][3][V], rows 3 or 2, in f32,
// and [8 dir][rows][3][V][2 re/im] in bf16 (see load_link).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

// W[d][s][a] codes: 0 -> 0, 1 -> +1, 2 -> -1, 3 -> +i, 4 -> -i.  Rows s = 0, 1
// are the identity for every direction; rows s = 2, 3 follow (lower block,
// codes listed as [s=2: a=0, a=1], [s=3: a=0, a=1]):
// W-TABLE d=0 2:1,0 3:0,1
// W-TABLE d=1 2:2,0 3:0,2
// W-TABLE d=2 2:0,4 3:4,0
// W-TABLE d=3 2:0,3 3:3,0
// W-TABLE d=4 2:0,2 3:1,0
// W-TABLE d=5 2:0,1 3:2,0
// W-TABLE d=6 2:4,0 3:0,3
// W-TABLE d=7 2:3,0 3:0,4
// packed 3 bits per entry, entry index (s - 2) * 2 + a
__host__ __device__ constexpr int pack4(int a, int b, int c, int d) {
  return a | (b << 3) | (c << 6) | (d << 9);
}

__host__ __device__ constexpr int wrow(int d) {
  return d == 0 ? pack4(1, 0, 0, 1)
       : d == 1 ? pack4(2, 0, 0, 2)
       : d == 2 ? pack4(0, 4, 4, 0)
       : d == 3 ? pack4(0, 3, 3, 0)
       : d == 4 ? pack4(0, 2, 1, 0)
       : d == 5 ? pack4(0, 1, 2, 0)
       : d == 6 ? pack4(4, 0, 0, 3)
       :          pack4(3, 0, 0, 4);
}

__host__ __device__ constexpr int wcode(int d, int s, int a) {
  return s < 2 ? (s == a ? 1 : 0) : ((wrow(d) >> (3 * ((s - 2) * 2 + a))) & 7);
}

// code of the complex conjugate (swaps +i and -i)
__host__ __device__ constexpr int wconj(int c) { return c == 3 ? 4 : (c == 4 ? 3 : c); }

// acc += code * v for a constant code (all branches fold once unrolled)
__device__ __forceinline__ void cadd(int code, float vr, float vi, float& ar, float& ai) {
  if (code == 1) { ar += vr; ai += vi; }
  else if (code == 2) { ar -= vr; ai -= vi; }
  else if (code == 3) { ar -= vi; ai += vr; }
  else if (code == 4) { ar += vi; ai -= vr; }
}

struct Corr {
  float re[8];
  float im[8];
};

struct Geo {
  int T, X, M, zh, p;
};

// element strides of a spinor field: re -> im, and component (s, c) ->
// the next.  K1: {12 V, V}; K1-R with the R axis before the sites:
// {12 R V, R V}; K1-R on a flavour doublet: {24 V, V}.
struct Strides {
  long long im, comp;
};

// flat neighbour site of direction d for the parity-p site (t, x, m)
__device__ __forceinline__ void neighbours(const Geo& g, int site, int nb[8]) {
  const int m = site % g.M;
  const int tx = site / g.M;
  const int x = tx % g.X;
  const int t = tx / g.X;
  const int y = m / g.zh;
  const int k = m - y * g.zh;
  const bool s1 = ((t + x + y + g.p) & 1) == 1;
  nb[0] = (((t + 1) % g.T) * g.X + x) * g.M + m;
  nb[1] = (((t + g.T - 1) % g.T) * g.X + x) * g.M + m;
  nb[2] = (t * g.X + (x + 1) % g.X) * g.M + m;
  nb[3] = (t * g.X + (x + g.X - 1) % g.X) * g.M + m;
  nb[4] = tx * g.M + (m + g.zh) % g.M;
  nb[5] = tx * g.M + (m + g.M - g.zh) % g.M;
  // z-hop: forward moves to k+1 only on slot-1 sites, backward to k-1 only
  // on slot-0 sites, both wrapping inside the y-block
  const int mzf = s1 ? (k == g.zh - 1 ? m - (g.zh - 1) : m + 1) : m;
  const int mzb = s1 ? m : (k == 0 ? m + (g.zh - 1) : m - 1);
  nb[6] = tx * g.M + mzf;
  nb[7] = tx * g.M + mzb;
}

// The 3 x 3 link of direction D at `site` into (gr, gi), upcast to f32 in
// registers; the 12-real copy stores rows 0 and 1 and row 2 is rebuilt.
// G: the gauge element type.  float: the copy [2 re/im][8][rows][3][V].
// __nv_bfloat16 (the sloppy copy): [8][rows][3][V][2 re/im], re and im of an
// element side by side, read as one __nv_bfloat162.  With the two parts V
// apart, as in the f32 copy, a warp's 2-byte load moved 64 B, half a
// 128-byte line, and K1-B reached 74-78 % of copy bandwidth at 32^3x64
// against f32 K1's 82-87 % (H100); side by side, a warp's load moves a whole
// line, one site per thread as in f32 K1.  The upcast is exact, so every
// reader of the bf16 copy (K1-B, K1-S, K1-RB, the slab kernels) sees the
// f32 values of the rounded links, and row 2 is rebuilt from them.
template <int D, bool COMP, typename G>
__device__ __forceinline__ void load_link(const G* __restrict__ ug, long long V, long long site,
                                          const Corr& corr, float (&gr)[3][3],
                                          float (&gi)[3][3]) {
  constexpr int R = COMP ? 2 : 3;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const long long e = ((D * R + i) * 3 + j) * V + site;
      if constexpr (std::is_same<G, __nv_bfloat16>::value) {
        const float2 v =
            __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(ug) + e));
        gr[i][j] = v.x;
        gi[i][j] = v.y;
      } else {
        gr[i][j] = __ldg(ug + e);
        gi[i][j] = __ldg(ug + 8 * R * 3 * V + e);
      }
    }
  if (COMP) {
    // row2 = corr * conj(row0 x row1)  (corr restores the folded phase)
    const float cr = corr.re[D], ci = corr.im[D];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int j1 = (j + 1) % 3, j2 = (j + 2) % 3;
      const float tr = gr[0][j1] * gr[1][j2] - gi[0][j1] * gi[1][j2]
                     - gr[0][j2] * gr[1][j1] + gi[0][j2] * gi[1][j1];
      const float ti = gr[0][j1] * gi[1][j2] + gi[0][j1] * gr[1][j2]
                     - gr[0][j2] * gi[1][j1] - gi[0][j2] * gr[1][j1];
      gr[2][j] = cr * tr + ci * ti;
      gi[2][j] = ci * tr - cr * ti;
    }
  }
}

// acc += W_D U (W_D^+ psi(nsite)) for the link (gr, gi) of direction D
template <int D>
__device__ __forceinline__ void hop_dir(const float* __restrict__ psi, const Strides& st,
                                        long long nsite, const float (&gr)[3][3],
                                        const float (&gi)[3][3], float (&ar)[4][3],
                                        float (&ai)[4][3]) {
  float nr[4][3], ni[4][3];
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      nr[s][c] = __ldg(psi + (s * 3 + c) * st.comp + nsite);
      ni[s][c] = __ldg(psi + st.im + (s * 3 + c) * st.comp + nsite);
    }
  // h[a][c] = sum_s conj(W[s][a]) nbr[s][c]
  float hr[2][3], hi[2][3];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      hr[a][c] = nr[a][c];
      hi[a][c] = ni[a][c];
#pragma unroll
      for (int s = 2; s < 4; ++s) cadd(wconj(wcode(D, s, a)), nr[s][c], ni[s][c], hr[a][c], hi[a][c]);
    }
  // uh[a][i] = sum_j U[i][j] h[a][j]
  float ur[2][3], ui[2][3];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      float sr = 0.f, si = 0.f;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        sr += gr[i][j] * hr[a][j] - gi[i][j] * hi[a][j];
        si += gr[i][j] * hi[a][j] + gi[i][j] * hr[a][j];
      }
      ur[a][i] = sr;
      ui[a][i] = si;
    }
  // out[s][c] += sum_a W[s][a] uh[a][c]
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    ar[0][c] += ur[0][c]; ai[0][c] += ui[0][c];
    ar[1][c] += ur[1][c]; ai[1][c] += ui[1][c];
#pragma unroll
    for (int s = 2; s < 4; ++s)
#pragma unroll
      for (int a = 0; a < 2; ++a) cadd(wcode(D, s, a), ur[a][c], ui[a][c], ar[s][c], ai[s][c]);
  }
}

template <int D, bool COMP, typename G>
__device__ __forceinline__ void accum_dir(const float* __restrict__ psi,
                                          const G* __restrict__ ug, long long V,
                                          const Strides& st, long long nsite, long long site,
                                          const Corr& corr,
                                          float (&ar)[4][3], float (&ai)[4][3]) {
  float gr[3][3], gi[3][3];
  load_link<D, COMP, G>(ug, V, site, corr, gr, gi);
  hop_dir<D>(psi, st, nsite, gr, gi, ar, ai);
}

// all 8 directions of one site of one field into (ar, ai)
template <bool COMP, typename G>
__device__ __forceinline__ void accum_site(const float* __restrict__ psi,
                                           const G* __restrict__ ug, const Geo& geo,
                                           long long V, const Strides& st, int site,
                                           const Corr& corr, float (&ar)[4][3],
                                           float (&ai)[4][3]) {
  int nb[8];
  neighbours(geo, site, nb);
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int c = 0; c < 3; ++c) { ar[s][c] = 0.f; ai[s][c] = 0.f; }
  accum_dir<0, COMP, G>(psi, ug, V, st, nb[0], site, corr, ar, ai);
  accum_dir<1, COMP, G>(psi, ug, V, st, nb[1], site, corr, ar, ai);
  accum_dir<2, COMP, G>(psi, ug, V, st, nb[2], site, corr, ar, ai);
  accum_dir<3, COMP, G>(psi, ug, V, st, nb[3], site, corr, ar, ai);
  accum_dir<4, COMP, G>(psi, ug, V, st, nb[4], site, corr, ar, ai);
  accum_dir<5, COMP, G>(psi, ug, V, st, nb[5], site, corr, ar, ai);
  accum_dir<6, COMP, G>(psi, ug, V, st, nb[6], site, corr, ar, ai);
  accum_dir<7, COMP, G>(psi, ug, V, st, nb[7], site, corr, ar, ai);
}


// one neighbour read of the stencil: the field holding it (base pointer of
// the column, strides) and its element index there
struct Nb {
  const float* p;
  Strides st;
  long long i;
};

// all 8 directions of one site, each neighbour from its own field (the
// slab kernels read halos from separate buffers): accum_site's order
template <bool COMP, typename G>
__device__ __forceinline__ void accum_src(const Nb (&nb)[8], const G* __restrict__ ug,
                                          long long V, long long site, const Corr& corr,
                                          float (&ar)[4][3], float (&ai)[4][3]) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int c = 0; c < 3; ++c) { ar[s][c] = 0.f; ai[s][c] = 0.f; }
  accum_dir<0, COMP, G>(nb[0].p, ug, V, nb[0].st, nb[0].i, site, corr, ar, ai);
  accum_dir<1, COMP, G>(nb[1].p, ug, V, nb[1].st, nb[1].i, site, corr, ar, ai);
  accum_dir<2, COMP, G>(nb[2].p, ug, V, nb[2].st, nb[2].i, site, corr, ar, ai);
  accum_dir<3, COMP, G>(nb[3].p, ug, V, nb[3].st, nb[3].i, site, corr, ar, ai);
  accum_dir<4, COMP, G>(nb[4].p, ug, V, nb[4].st, nb[4].i, site, corr, ar, ai);
  accum_dir<5, COMP, G>(nb[5].p, ug, V, nb[5].st, nb[5].i, site, corr, ar, ai);
  accum_dir<6, COMP, G>(nb[6].p, ug, V, nb[6].st, nb[6].i, site, corr, ar, ai);
  accum_dir<7, COMP, G>(nb[7].p, ug, V, nb[7].st, nb[7].i, site, corr, ar, ai);
}

// The multi-right-hand-side kernels stage the links of a block's kRhsSites
// sites in shared memory once for all its columns.
constexpr int kRhsSites = 32;

// the link of direction D of the block's site `lane` into shared memory,
// sl[D][re 3x3 | im 3x3][lane], upcast to f32 (row 2 of the 12-real copy
// rebuilt from the upcast rows, as load_link does for K1)
template <int D, bool COMP, typename G>
__device__ __forceinline__ void stage_link(const G* __restrict__ ug, long long V, long long site,
                                           const Corr& corr, float* __restrict__ sl, int lane) {
  float gr[3][3], gi[3][3];
  load_link<D, COMP, G>(ug, V, site, corr, gr, gi);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      sl[(D * 18 + i * 3 + j) * kRhsSites + lane] = gr[i][j];
      sl[(D * 18 + 9 + i * 3 + j) * kRhsSites + lane] = gi[i][j];
    }
}

// the 8 links of the block's site `lane`, the rows of the block sharing out
// the directions
template <bool COMP, typename G>
__device__ __forceinline__ void stage_links(const G* __restrict__ ug, long long V, long long site,
                                            const Corr& corr, float* __restrict__ sl, int lane) {
  for (int d = threadIdx.y; d < 8; d += blockDim.y) {
    switch (d) {
      case 0: stage_link<0, COMP, G>(ug, V, site, corr, sl, lane); break;
      case 1: stage_link<1, COMP, G>(ug, V, site, corr, sl, lane); break;
      case 2: stage_link<2, COMP, G>(ug, V, site, corr, sl, lane); break;
      case 3: stage_link<3, COMP, G>(ug, V, site, corr, sl, lane); break;
      case 4: stage_link<4, COMP, G>(ug, V, site, corr, sl, lane); break;
      case 5: stage_link<5, COMP, G>(ug, V, site, corr, sl, lane); break;
      case 6: stage_link<6, COMP, G>(ug, V, site, corr, sl, lane); break;
      default: stage_link<7, COMP, G>(ug, V, site, corr, sl, lane); break;
    }
  }
}

// hop_dir on the staged link of direction D
template <int D>
__device__ __forceinline__ void hop_staged(const float* __restrict__ psi, const Strides& st,
                                           long long nsite, const float* __restrict__ sl,
                                           int lane, float (&ar)[4][3], float (&ai)[4][3]) {
  float gr[3][3], gi[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      gr[i][j] = sl[(D * 18 + i * 3 + j) * kRhsSites + lane];
      gi[i][j] = sl[(D * 18 + 9 + i * 3 + j) * kRhsSites + lane];
    }
  hop_dir<D>(psi, st, nsite, gr, gi, ar, ai);
}

// all 8 directions of one site on the staged links: accum_src's order
__device__ __forceinline__ void accum_staged(const Nb (&nb)[8], const float* __restrict__ sl,
                                             int lane, float (&ar)[4][3], float (&ai)[4][3]) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int c = 0; c < 3; ++c) { ar[s][c] = 0.f; ai[s][c] = 0.f; }
  hop_staged<0>(nb[0].p, nb[0].st, nb[0].i, sl, lane, ar, ai);
  hop_staged<1>(nb[1].p, nb[1].st, nb[1].i, sl, lane, ar, ai);
  hop_staged<2>(nb[2].p, nb[2].st, nb[2].i, sl, lane, ar, ai);
  hop_staged<3>(nb[3].p, nb[3].st, nb[3].i, sl, lane, ar, ai);
  hop_staged<4>(nb[4].p, nb[4].st, nb[4].i, sl, lane, ar, ai);
  hop_staged<5>(nb[5].p, nb[5].st, nb[5].i, sl, lane, ar, ai);
  hop_staged<6>(nb[6].p, nb[6].st, nb[6].i, sl, lane, ar, ai);
  hop_staged<7>(nb[7].p, nb[7].st, nb[7].i, sl, lane, ar, ai);
}

}  // namespace
