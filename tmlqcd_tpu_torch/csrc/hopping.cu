// Even/odd Wilson hopping (K1) and its gauge-cotangent kernel (K2) for
// NVIDIA Hopper (sm_90a), bound to Python through a plain C interface.
//
// K1 replaces the Pallas kernel `_dslash_kernel` (+ `_stencil_accum`,
// `_apply_epilogue`) of tmlqcd_tpu/ops/dslash_pallas.py; K2 replaces
// `_ug_vjp_kernel` of the same file.  Both read the reference's split
// structure-of-arrays layout unchanged:
//
//   psi  [2 re/im][4 spin][3 colour][V]          V = T * X * M sites of one parity
//   ug   [2 re/im][8 dir][R rows][3 col][V]      R = 3 (18 reals) or 2 (12 reals)
//   out  like psi (K1) or [2][8][3][3][V] (K2)
//
// with direction d = 2 mu + fb (fb = 0 forward, 1 backward), the boundary
// phases already folded into the gauge copy.
//
// Design: one thread per output site, the thread index running along the
// minor M axis, so every component load and store of a warp is one
// contiguous 128-byte line.  A thread loops over the 8 directions: it
// projects the neighbour spinor to a half-spinor with the {0, +-1, +-i}
// maps W (1 -/+ gamma_mu = W W^+, adds only), multiplies by the link
// (rebuilding row 2 as corr * conj(row0 x row1) for the 12-real copy),
// spreads back with W and accumulates; the twisted-mass epilogue is fused on
// the way out.
//
// Bound: memory.  1320 flops per site against 576 B (18-real) or 384 B
// (12-real) of gauge, 96 B per spinor read (8 neighbour reads of which the
// caches absorb most) and 96 B written; the mhat epilogue reads one more
// spinor.  At ~1.7-2.3 flop/B it sits far below the card's ridge point, so
// the only lever is bytes.  This first version relies on L1/L2 for
// neighbour reuse; shared-memory tiling and several sites per thread are
// later work.

#include <cuda_runtime.h>

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

template <int D, bool COMP>
__device__ __forceinline__ void accum_dir(const float* __restrict__ psi,
                                          const float* __restrict__ ug, long long V,
                                          int nsite, int site, const Corr& corr,
                                          float (&ar)[4][3], float (&ai)[4][3]) {
  float nr[4][3], ni[4][3];
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      nr[s][c] = __ldg(psi + (s * 3 + c) * V + nsite);
      ni[s][c] = __ldg(psi + (12 + s * 3 + c) * V + nsite);
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
  constexpr int R = COMP ? 2 : 3;
  float gr[3][3], gi[3][3];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      gr[i][j] = __ldg(ug + (((0 * 8 + D) * R + i) * 3 + j) * V + site);
      gi[i][j] = __ldg(ug + (((1 * 8 + D) * R + i) * 3 + j) * V + site);
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

// EPI: 0 none (out = H psi), 1 mee_inv (out = Mee^-1 H psi),
//      2 mhat (out = [g5] (Mee psi_o - k2 H psi))
template <int EPI, bool G5, bool COMP>
__global__ void __launch_bounds__(128)
hopping_kernel(const float* __restrict__ psi, const float* __restrict__ ug,
               const float* __restrict__ psi_o, float* __restrict__ out, Geo geo,
               float mt, float inv, float k2, Corr corr) {
  const long long V = (long long)geo.T * geo.X * geo.M;
  const int site = blockIdx.x * blockDim.x + threadIdx.x;
  if (site >= V) return;
  int nb[8];
  neighbours(geo, site, nb);
  float ar[4][3], ai[4][3];
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int c = 0; c < 3; ++c) { ar[s][c] = 0.f; ai[s][c] = 0.f; }
  accum_dir<0, COMP>(psi, ug, V, nb[0], site, corr, ar, ai);
  accum_dir<1, COMP>(psi, ug, V, nb[1], site, corr, ar, ai);
  accum_dir<2, COMP>(psi, ug, V, nb[2], site, corr, ar, ai);
  accum_dir<3, COMP>(psi, ug, V, nb[3], site, corr, ar, ai);
  accum_dir<4, COMP>(psi, ug, V, nb[4], site, corr, ar, ai);
  accum_dir<5, COMP>(psi, ug, V, nb[5], site, corr, ar, ai);
  accum_dir<6, COMP>(psi, ug, V, nb[6], site, corr, ar, ai);
  accum_dir<7, COMP>(psi, ug, V, nb[7], site, corr, ar, ai);
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const float gs = s < 2 ? 1.f : -1.f;  // gamma5 = diag(+,+,-,-)
    const float gmt = mt * gs;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const long long ore = (s * 3 + c) * V + site;
      const long long oim = (12 + s * 3 + c) * V + site;
      const float xr = ar[s][c], xi = ai[s][c];
      if (EPI == 0) {
        out[ore] = xr;
        out[oim] = xi;
      } else if (EPI == 1) {
        // Mee(sign)^-1 x = (x - i sign mutld g5 x) * inv, inv = 1 / (1 + mutld^2)
        out[ore] = (xr + gmt * xi) * inv;
        out[oim] = (xi - gmt * xr) * inv;
      } else {
        // Mee(sign) y = y + i sign mutld g5 y, y = psi_o the original odd input
        const float yr = __ldg(psi_o + ore), yi = __ldg(psi_o + oim);
        const float zr = (yr - gmt * yi) - k2 * xr;
        const float zi = (yi + gmt * yr) - k2 * xi;
        const float g5s = G5 ? gs : 1.f;
        out[ore] = g5s * zr;
        out[oim] = g5s * zi;
      }
    }
  }
}

template <int D>
__device__ __forceinline__ void vjp_dir(const float* __restrict__ psi, long long V, int nsite,
                                        int site, const float (&g_r)[4][3],
                                        const float (&g_i)[4][3], float* __restrict__ out) {
  float nr[4][3], ni[4][3];
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      nr[s][c] = __ldg(psi + (s * 3 + c) * V + nsite);
      ni[s][c] = __ldg(psi + (12 + s * 3 + c) * V + nsite);
    }
  // ghat = W^+ g and h = W^+ nbr (the forward kernel's half-spinor)
  float ghr[2][3], ghi[2][3], hr[2][3], hi[2][3];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      ghr[a][c] = g_r[a][c]; ghi[a][c] = g_i[a][c];
      hr[a][c] = nr[a][c];   hi[a][c] = ni[a][c];
#pragma unroll
      for (int s = 2; s < 4; ++s) {
        cadd(wconj(wcode(D, s, a)), g_r[s][c], g_i[s][c], ghr[a][c], ghi[a][c]);
        cadd(wconj(wcode(D, s, a)), nr[s][c], ni[s][c], hr[a][c], hi[a][c]);
      }
    }
  // F[i][j] = sum_a ghat[a][i] conj(h[a][j])
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float fr = 0.f, fi = 0.f;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        fr += ghr[a][i] * hr[a][j] + ghi[a][i] * hi[a][j];
        fi += ghi[a][i] * hr[a][j] - ghr[a][i] * hi[a][j];
      }
      out[(((0 * 8 + D) * 3 + i) * 3 + j) * V + site] = fr;
      out[(((1 * 8 + D) * 3 + i) * 3 + j) * V + site] = fi;
    }
}

// d Re<g, H psi> / d ug[p]: each output site owns its 8 x 9 link
// cotangents, so there are no atomics.  Bound: memory (96 B g + 8 x 96 B
// neighbour reads, mostly cached, + 576 B written per site).
__global__ void __launch_bounds__(128)
ug_vjp_kernel(const float* __restrict__ g, const float* __restrict__ psi,
              float* __restrict__ out, Geo geo) {
  const long long V = (long long)geo.T * geo.X * geo.M;
  const int site = blockIdx.x * blockDim.x + threadIdx.x;
  if (site >= V) return;
  int nb[8];
  neighbours(geo, site, nb);
  float g_r[4][3], g_i[4][3];
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      g_r[s][c] = __ldg(g + (s * 3 + c) * V + site);
      g_i[s][c] = __ldg(g + (12 + s * 3 + c) * V + site);
    }
  vjp_dir<0>(psi, V, nb[0], site, g_r, g_i, out);
  vjp_dir<1>(psi, V, nb[1], site, g_r, g_i, out);
  vjp_dir<2>(psi, V, nb[2], site, g_r, g_i, out);
  vjp_dir<3>(psi, V, nb[3], site, g_r, g_i, out);
  vjp_dir<4>(psi, V, nb[4], site, g_r, g_i, out);
  vjp_dir<5>(psi, V, nb[5], site, g_r, g_i, out);
  vjp_dir<6>(psi, V, nb[6], site, g_r, g_i, out);
  vjp_dir<7>(psi, V, nb[7], site, g_r, g_i, out);
}

constexpr int kBlock = 128;

template <int EPI, bool G5, bool COMP>
void launch(const float* psi, const float* ug, const float* psi_o, float* out, Geo geo,
            float mt, float inv, float k2, const Corr& corr, cudaStream_t st) {
  const long long V = (long long)geo.T * geo.X * geo.M;
  const unsigned blocks = (unsigned)((V + kBlock - 1) / kBlock);
  hopping_kernel<EPI, G5, COMP><<<blocks, kBlock, 0, st>>>(psi, ug, psi_o, out, geo, mt, inv,
                                                           k2, corr);
}

template <bool COMP>
void dispatch_epi(int epi, int g5, const float* psi, const float* ug, const float* psi_o,
                  float* out, Geo geo, float mt, float inv, float k2, const Corr& corr,
                  cudaStream_t st) {
  if (epi == 0) launch<0, false, COMP>(psi, ug, psi_o, out, geo, mt, inv, k2, corr, st);
  else if (epi == 1) launch<1, false, COMP>(psi, ug, psi_o, out, geo, mt, inv, k2, corr, st);
  else if (g5) launch<2, true, COMP>(psi, ug, psi_o, out, geo, mt, inv, k2, corr, st);
  else launch<2, false, COMP>(psi, ug, psi_o, out, geo, mt, inv, k2, corr, st);
}

}  // namespace

extern "C" {

// K1.  epi: 0 none, 1 mee_inv, 2 mhat.  corr16: 8 (re, im) pairs on the
// host, read only when comp != 0.  Returns cudaGetLastError() after the
// launch (0 = success); an invalid argument returns cudaErrorInvalidValue.
int tm_hopping(const float* psi, const float* ug, const float* psi_o, float* out, int T, int X,
               int M, int zh, int p, int epi, int g5, int comp, float mt, float inv,
               float k2, const float* corr16, void* stream) {
  if (T <= 0 || X <= 0 || M <= 0 || zh <= 0 || M % zh != 0 || (p != 0 && p != 1) ||
      epi < 0 || epi > 2 || (epi == 2 && psi_o == nullptr) || (comp && corr16 == nullptr))
    return (int)cudaErrorInvalidValue;
  Corr corr;
  for (int d = 0; d < 8; ++d) {
    corr.re[d] = comp ? corr16[2 * d] : 1.f;
    corr.im[d] = comp ? corr16[2 * d + 1] : 0.f;
  }
  const Geo geo{T, X, M, zh, p};
  cudaStream_t st = (cudaStream_t)stream;
  if (comp) dispatch_epi<true>(epi, g5, psi, ug, psi_o, out, geo, mt, inv, k2, corr, st);
  else dispatch_epi<false>(epi, g5, psi, ug, psi_o, out, geo, mt, inv, k2, corr, st);
  return (int)cudaGetLastError();
}

// K2.  Returns cudaGetLastError() after the launch.
int tm_hopping_ug_vjp(const float* g, const float* psi, float* out, int T, int X, int M, int zh,
                      int p, void* stream) {
  if (T <= 0 || X <= 0 || M <= 0 || zh <= 0 || M % zh != 0 || (p != 0 && p != 1))
    return (int)cudaErrorInvalidValue;
  const Geo geo{T, X, M, zh, p};
  const long long V = (long long)T * X * M;
  const unsigned blocks = (unsigned)((V + kBlock - 1) / kBlock);
  ug_vjp_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(g, psi, out, geo);
  return (int)cudaGetLastError();
}

}  // extern "C"
