// The MD gauge force (KG) for NVIDIA Hopper (sm_90a), bound to Python
// through a plain C interface (ops/dslash_cuda.py `gauge_force_cuda`).
//
// It replaces no TPU kernel: the reference's force is plain jnp
// (tmlqcd_tpu/ops/gauge_action.py `gauge_force`: staples summed with
// jnp shifts, the rectangle part by autodiff of the rectangle action).
// It was added because that force, ported as plain torch ops, was 79 % of
// the device time of an HMC trajectory of the b40.24 ensemble (PERF.md
// section 5): ~10^6 small torch ops a trajectory, each a full-field pass,
// plus an autograd graph over the rectangles.
//
// What it computes, in one launch for all four directions:
//
//   F_mu(x) = TA( U_mu(x) [ -(beta c0 / 3) A_mu(x) - (beta c1 / 3) R_mu(x) ] )
//
// A_mu(x) the 6 plaquette staples and R_mu(x) the 18 rectangle staples
// (1x2 and 2x1, both orientations, in each of the three planes (mu, nu))
// of the link, so that the loops holding U_mu(x) sum to Re tr[U_mu(x) A]
// and Re tr[U_mu(x) R]; TA(m) = (m - m^+)/2 - tr(m - m^+)/6.  c1 == 0
// (Wilson) runs an instance without the rectangles.
//
// Layout: the links u and the force f are complex64 [3][3][4 mu][T][X][Y*Z],
// read and written as float2 (re, im); neighbours by index arithmetic with
// periodic wraps on each axis of (t, x, y, z), as lattice.shift_full: a z
// step wraps inside its z row, a y step moves by Z inside the Y*Z axis.  The
// links carry no boundary phases and the force needs none.
//
// Bound: operations.  Summed staple by staple, a link would need ~85 SU(3)
// products (12 for the plaquettes, 72 for the rectangles, 1 for U A); with
// the corners shared (below) it needs 67, 216 flops each: ~38 GFLOP an
// evaluation at 24^3x48 (663,552 sites), 0.57 ms at the card's 67 TFLOP/s
// of f32 (13 products without the rectangles: 0.11 ms), against one read of
// the links and one write of the force, 2 x 191 MB, 0.11 ms at 3.35 TB/s.
//
// Design: one thread per link (site, mu), the thread index running along
// the minor Y*Z axis so that each of a link's 9 complex loads and stores is
// one contiguous line a warp.  The neighbour links come through L1/L2
// (__ldg); nothing intermediate goes to device memory.  A thread walks the
// three planes (mu, nu) and, in each, the side through x + nu and the side
// through x - nu with one routine: along the transporter V from y to
// y + d nu (U_nu(y), or U_nu(y - nu)^+ for d = -1) the four staples of a
// side share their corners,
//
//   W = U_mu(x+dn)^+ V(x)^+                      (the plaquette's last two links)
//   plaquette + (b) + (e) = V(x+m) [ cp W + cr (U_mu(x+dn)^+ U_mu(x-m+dn)^+)(V(x-m)^+ U_mu(x-m))
//                                  + cr (V(x+m+dn) U_mu(x+2dn)^+ V(x+dn)^+) V(x)^+ ]
//   (a) = cr (U_mu(x+m) V(x+2m) U_mu(x+m+dn)^+) W
//
// (cp, cr = -(beta c0/3), -(beta c1/3); dn = d nu), 11 products a side
// instead of 14, so 67 a link instead of 85, into one 3x3 complex
// accumulator in registers; then U_mu(x) times it and the TA projection,
// and the force is stored.  The grid is what the card holds resident
// (blocks per SM from the occupancy API x SMs), each thread striding over
// the links.  f32 arithmetic throughout, as the plain version's.
//
// Registers, not bytes, bound the occupancy: the rectangle instance holds
// ~240 registers (no spills), two blocks of 128 an SM.  Of the launch
// bounds tried at 24^3x48 (block 64 / 128 / 256, 2 to 6 blocks an SM),
// (128, 2) was the fastest, 1.48 ms with rectangles and 0.42 ms without;
// capping the registers lower spilled and was slower (PERF.md section 6).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBlock = 128;
constexpr int kMaxDevices = 64;

struct Mat {
  float2 e[9];
};

struct Geo {
  int T, X, Y, Z;
};

// element (i, j) of a, or of a^+ when DAG
template <bool DAG>
__device__ __forceinline__ float2 el(const Mat& a, int i, int j) {
  if (DAG) {
    const float2 v = a.e[3 * j + i];
    return make_float2(v.x, -v.y);
  }
  return a.e[3 * i + j];
}

// op(a) op(b), op the identity or ^+
template <bool DA, bool DB>
__device__ __forceinline__ Mat mul(const Mat& a, const Mat& b) {
  Mat c;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float re = 0.f, im = 0.f;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float2 x = el<DA>(a, i, j), y = el<DB>(b, j, k);
        re = fmaf(x.x, y.x, re);
        re = fmaf(-x.y, y.y, re);
        im = fmaf(x.x, y.y, im);
        im = fmaf(x.y, y.x, im);
      }
      c.e[3 * i + k] = make_float2(re, im);
    }
  }
  return c;
}

// acc += s op(a) op(b)
template <bool DA, bool DB>
__device__ __forceinline__ void madd(Mat& acc, const Mat& a, const Mat& b, float s) {
  const Mat p = mul<DA, DB>(a, b);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    acc.e[k].x = fmaf(s, p.e[k].x, acc.e[k].x);
    acc.e[k].y = fmaf(s, p.e[k].y, acc.e[k].y);
  }
}

// the link of direction `p` (u + mu V) at `site`; cs = 4 V, the colour stride
__device__ __forceinline__ Mat load(const float2* __restrict__ p, size_t cs, int site) {
  Mat m;
#pragma unroll
  for (int k = 0; k < 9; ++k) m.e[k] = __ldg(p + k * cs + site);
  return m;
}

__device__ __forceinline__ int extent(const Geo& g, int a) {
  return a == 0 ? g.T : a == 1 ? g.X : a == 2 ? g.Y : g.Z;
}

__device__ __forceinline__ int stride(const Geo& g, int a) {
  return a == 0 ? g.X * g.Y * g.Z : a == 1 ? g.Y * g.Z : a == 2 ? g.Z : 1;
}

// site-index offset of a step of d (|d| <= 2) from coordinate c along an
// axis of extent L and stride S, periodic (any L >= 1)
__device__ __forceinline__ int step(int c, int d, int L, int S) {
  int w = c + d;
  if (w >= L) w -= L;
  if (w >= L) w -= L;
  if (w < 0) w += L;
  if (w < 0) w += L;
  return (w - c) * S;
}

// The staples of plane (mu, nu) on the side through x + D nu, added to acc
// (scaled by cp, cr).  um, un: the links of mu and nu; m1, mm1, m2: offsets
// of x + mu, x - mu, x + 2 mu; n1, n2: of x + D nu, x + 2 D nu.  The
// transporter V(y) from y to y + D nu is U_nu(y) (D > 0) or U_nu(y - nu)^+
// (D < 0): its link sits at y + v0, V(y + D nu)'s at y + v1, and FV says
// whether the loaded link is V^+ rather than V.
template <int D, bool RECT>
__device__ __forceinline__ void side(Mat& acc, const float2* __restrict__ um,
                                     const float2* __restrict__ un, size_t cs, int s, int m1,
                                     int mm1, int m2, int n1, int n2, float cp, float cr) {
  constexpr bool FV = D < 0;
  const int v0 = FV ? n1 : 0, v1 = FV ? n2 : n1;
  const Mat a2 = load(um, cs, s + n1);  // U_mu(x + D nu)
  const Mat w = mul<true, !FV>(a2, load(un, cs, s + v0));  // U_mu(x+dn)^+ V(x)^+
  Mat y;
#pragma unroll
  for (int k = 0; k < 9; ++k) y.e[k] = make_float2(cp * w.e[k].x, cp * w.e[k].y);
  if (RECT) {
    // (a) the 2x1 rectangle with U_mu(x) its first mu link
    Mat c = mul<false, FV>(load(um, cs, s + m1), load(un, cs, s + m2 + v0));
    c = mul<false, true>(c, load(um, cs, s + m1 + n1));
    madd<false, false>(acc, c, w, cr);
    // (b) the 2x1 rectangle with U_mu(x) its second mu link
    const Mat t1 = mul<true, true>(a2, load(um, cs, s + mm1 + n1));
    const Mat t2 = mul<!FV, false>(load(un, cs, s + mm1 + v0), load(um, cs, s + mm1));
    madd<false, false>(y, t1, t2, cr);
    // (e) the 1x2 rectangle, two steps along D nu
    Mat e = mul<FV, true>(load(un, cs, s + m1 + v1), load(um, cs, s + n2));
    e = mul<false, !FV>(e, load(un, cs, s + v1));
    madd<false, !FV>(y, e, load(un, cs, s + v0), cr);
  }
  madd<FV, false>(acc, load(un, cs, s + m1 + v0), y, 1.f);  // V(x + mu) y
}

template <bool RECT>
__global__ void __launch_bounds__(kBlock, 2)
    gauge_force_kernel(const float2* __restrict__ u, float2* __restrict__ f, Geo g, int V,
                       float cp, float cr) {
  const size_t cs = 4 * (size_t)V;
  const long long n = 4LL * V;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < n;
       idx += (long long)gridDim.x * blockDim.x) {
    const int mu = (int)(idx / V);
    const int s = (int)(idx - (long long)mu * V);
    const int Lm = extent(g, mu), Sm = stride(g, mu), cm = (s / Sm) % Lm;
    const int m1 = step(cm, 1, Lm, Sm), mm1 = step(cm, -1, Lm, Sm);
    const int m2 = RECT ? step(cm, 2, Lm, Sm) : 0;
    const float2* um = u + (size_t)mu * V;
    Mat acc;
#pragma unroll
    for (int k = 0; k < 9; ++k) acc.e[k] = make_float2(0.f, 0.f);
#pragma unroll 1
    for (int nu = 0; nu < 4; ++nu) {
      if (nu == mu) continue;
      const int Ln = extent(g, nu), Sn = stride(g, nu), cn = (s / Sn) % Ln;
      const float2* un = u + (size_t)nu * V;
      side<+1, RECT>(acc, um, un, cs, s, m1, mm1, m2, step(cn, 1, Ln, Sn),
                     RECT ? step(cn, 2, Ln, Sn) : 0, cp, cr);
      side<-1, RECT>(acc, um, un, cs, s, m1, mm1, m2, step(cn, -1, Ln, Sn),
                     RECT ? step(cn, -2, Ln, Sn) : 0, cp, cr);
    }
    const Mat m = mul<false, false>(load(um, cs, s), acc);
    // TA(m): the anti-hermitian part, its trace (imaginary) removed
    Mat out;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float2 a = m.e[3 * i + j], b = m.e[3 * j + i];
        out.e[3 * i + j] = make_float2(0.5f * (a.x - b.x), 0.5f * (a.y + b.y));
      }
    }
    const float tr = (out.e[0].y + out.e[4].y + out.e[8].y) / 3.f;
    out.e[0].y -= tr;
    out.e[4].y -= tr;
    out.e[8].y -= tr;
    float2* fm = f + (size_t)mu * V + s;
#pragma unroll
    for (int k = 0; k < 9; ++k) fm[k * cs] = out.e[k];
  }
}

// resident blocks of the instance on the current device, found once a
// device and kept (0 and an error code if the occupancy API fails)
template <bool RECT>
int resident_blocks(int* blocks) {
  static int resident[kMaxDevices];
  int dev = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc != 0) return rc;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int per_sm = 0, sms = 0;
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gauge_force_kernel<RECT>,
                                                            kBlock, 0);
    if (rc == 0) rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc != 0) return rc;
    if (per_sm * sms <= 0) return (int)cudaErrorInvalidConfiguration;
    resident[dev] = per_sm * sms;
  }
  *blocks = resident[dev];
  return 0;
}

template <bool RECT>
int launch(const float2* u, float2* f, Geo g, float cp, float cr, cudaStream_t stream) {
  const int V = g.T * g.X * g.Y * g.Z;
  int resident = 0;
  const int rc = resident_blocks<RECT>(&resident);
  if (rc != 0) return rc;
  const long long need = (4LL * V + kBlock - 1) / kBlock;
  const unsigned grid = (unsigned)(need < resident ? need : resident);
  gauge_force_kernel<RECT><<<grid, kBlock, 0, stream>>>(u, f, g, V, cp, cr);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The force of the links u into f (both complex64 [3][3][4][T][X][Y*Z], f
// written whole) with cp = -(beta c0 / 3), cr = -(beta c1 / 3); cr == 0
// runs the instance without rectangles.  Launches on `stream`; returns
// cudaGetLastError() after the launch (0 = success).
int tm_gauge_force(const void* u, void* f, int T, int X, int Y, int Z, float cp, float cr,
                   void* stream) {
  if (u == nullptr || f == nullptr || T < 1 || X < 1 || Y < 1 || Z < 1 ||
      (long long)T * X * Y * Z > 0x7fffffffLL / 4)
    return (int)cudaErrorInvalidValue;
  const Geo g{T, X, Y, Z};
  const float2* uu = static_cast<const float2*>(u);
  float2* ff = static_cast<float2*>(f);
  if (cr != 0.f) return launch<true>(uu, ff, g, cp, cr, (cudaStream_t)stream);
  return launch<false>(uu, ff, g, cp, cr, (cudaStream_t)stream);
}

}  // extern "C"
