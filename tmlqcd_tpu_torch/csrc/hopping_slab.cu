// The domain-decomposed hopping kernels for NVIDIA Hopper (sm_90a): H_{p,q}
// psi on (t, y) slabs of the lattice whose halos arrive in separate
// buffers, bound to Python through a plain C interface.
//
// They replace the sharded Pallas kernels of tmlqcd_tpu/ops/dslash_pallas.py:
//   K3   `_build_shard_ext` / `_shard_kernel` (t_off 0) / `_shard_kernel_r`:
//        every t of a slab, its t halos concatenated to it (psi_ext);
//   K3-I `_build_shard_int` / `_shard_kernel` (t_off 1): the interior
//        t = 1 .. T_loc-2, which needs no t halo (it runs while the t halos
//        are packed);
//   K4   `_build_shard_bnd` / `_shard_bnd_kernel` / `_shard_bnd_kernel_r`: the
//        surface t = 0 and T_loc-1, one t neighbour from the received halo
//        slice, the other from the adjacent slab row;
//   K1-T `_build_ext` / `_dslash_kernel` on a t-slab with t halos
//        concatenated and the y hops wrapping inside the slab (the 1D
//        t-sharded `hopping_pallas_tshard`).
// One kernel serves all four; the variant picks which rows of the slabs run
// and where their t neighbours come from.  KH (halo_kernel, below) packs
// the y and t halos of every slab in one launch; with it a sharded hop is
// one C call (`tm_shard_hop`: KH, then K3-I+K4, the interior and surface
// rows in one launch).  Epilogue none, f32 accumulation,
// 18- or 12-real links, f32 or bf16 links (upcast on loading), one spinor
// (R = 0), a batch of R right-hand sides or a flavour doublet (the R axis
// addressed by a stride, as K1-R does).
//
// Layouts (element strides; every field is [2 re/im][spin][colour][R?][sites]
// or the doublet [2][2 flavour][spin][colour][sites], sites = rows x X x M'):
//   psi   the whole field [.., T, X, M]; for K3 / K1-T the extended field
//         [.., tsh (T_loc + 2), X, M]: slab row i holds [halo_lo | T_loc rows
//         of slab i | halo_hi];
//   th    K4's t halos [.., 2 tsh, X, M]: row i the halo below slab row i
//         (the last row of slab row i-1), row tsh + i the one above it;
//   mh    the y halos [.., 2 T, X, msh zh]: row t the y-row below the slab
//         (the last y-row of slab column j-1) at column j zh, row T + t the
//         one above; null when msh == 1 and the y hops wrap inside the slab
//         (K1-T; the reference's own-slab halos carry the same values);
//   ug    the gauge copy of the whole lattice [2][8][rows][3][T X M];
//   out   the whole field [.., T, X, M], written at the variant's rows.
// Slab (i, j) holds t in [i T_loc, (i+1) T_loc) and m in [j m_loc, (j+1)
// m_loc); T_loc and Y_loc = m_loc / zh are even, so the slot (t+x+y+p) of a
// site is the same in slab and global coordinates.
//
// Design: all slabs in one launch per variant (the slab index follows from
// the site's t and m; with 8 slabs at 16^3 x 32 one launch per slab would
// make launch overhead the whole cost of a hop), one thread per output site
// and column, the thread index running along m as in K1, so a warp's loads
// and stores stay 128-byte lines.  Each thread builds its eight neighbour
// reads (field, strides, index) and runs K1's per-site sum (`accum_src` /
// `accum_staged` of hopping_common.cuh, K1's order of directions and of
// operations), so the assembled sharded hop equals K1 on the whole lattice
// bit for bit wherever the halos hold the neighbours' values; the
// half-spinor halos (0.5 W s after W^+ psi) give back W^+ psi exactly.  With
// R > 0 a block (32 sites x up to 12 columns) stages the links of its sites
// in shared memory once, as K1-R does.
//
// Bound: memory, as K1: per output site G bytes of gauge (576 / 384 f32, 288
// / 192 bf16) plus, per column, 96 B written and 96 B of psi read once, plus
// the halo buffers (96 B per halo site).  1320 flops per site and column.
//
// On one rank of a distributed mesh (one process per slab) the same kernels
// run on the rank's own slab as a mesh of one slab (T = T_loc, tsh = msh =
// 1): KH-P is KH there with a y halo buffer at msh == 1, so it writes the
// slab's four send faces (its th rows are the two t faces: at one slab row
// the halo below row 0 is the slab's own last timeslice, projected for the
// t-1 hop, which is what the rank above needs); K3-I and K4 read the
// received faces through the same buffer (mh non-null: the y hops read it
// instead of wrapping).  K2-S (`ug_vjp_slab_kernel`, below) is K2
// (hopping.cu's `ug_vjp_kernel`) on such a slab, its neighbours read by
// `slab_neighbours` from the slab and the received faces.

#include "hopping_common.cuh"

namespace {

// kAll (K3-I+K4): every row of every slab, psi the whole field, the t
// halos of rows 0 and T_loc-1 from th: the interior and the surface kernel
// in one launch, which the sharded hop runs after KH
enum { kExt = 0, kInt = 1, kBnd = 2, kAll = 3 };

// element strides of one field: re -> im, component (s, c) -> the next, and
// right-hand side r -> r + 1
struct Fld {
  const float* p;
  long long im, comp, r;
};

struct SlabGeo {
  int T, X, M, zh, p;
  int tsh, msh, tl, ml;  // slab counts along t and y, T_loc, m_loc
  int var, nrows;        // variant and the number of output rows it runs
};

struct SlabArgs {
  Fld psi, th, mh;
  float* out;
  long long out_im, out_comp, out_r;
  SlabGeo g;
  Corr corr;
  int R;
};

// row n of the variant -> (slab row i, local t)
__device__ __forceinline__ void slab_row(const SlabGeo& g, int row, int& i, int& tl) {
  if (g.var == kInt) {
    i = row / (g.tl - 2);
    tl = 1 + row % (g.tl - 2);
  } else if (g.var == kBnd) {
    i = row >> 1;
    tl = (row & 1) * (g.tl - 1);
  } else {
    i = row / g.tl;
    tl = row % g.tl;
  }
}

__device__ __forceinline__ Nb nb_at(const Fld& f, int r, long long idx) {
  return Nb{f.p + r * f.r, Strides{f.im, f.comp}, idx};
}

// the eight neighbour reads of the output site (t = i T_loc + tl, x, m), column r
__device__ __forceinline__ void slab_neighbours(const SlabArgs& a, int i, int tl, int x, int m,
                                                int r, Nb (&nb)[8]) {
  const SlabGeo& g = a.g;
  const int t = i * g.tl + tl;
  const int j = m / g.ml;
  const int ml = m - j * g.ml;
  const int yl = ml / g.zh;
  const int k = ml - yl * g.zh;
  const int yloc = g.ml / g.zh;
  const bool s1 = ((tl + x + yl + g.p) & 1) == 1;
  const long long XM = (long long)g.X * g.M;
  // the row of the output site in `psi`, and its t neighbours
  const int crow = g.var == kExt ? i * (g.tl + 2) + tl + 1 : t;
  const long long c = crow * XM + (long long)x * g.M;  // element index of (crow, x, 0)
  if (g.var == kExt) {
    nb[0] = nb_at(a.psi, r, c + XM + m);
    nb[1] = nb_at(a.psi, r, c - XM + m);
  } else {
    nb[0] = tl < g.tl - 1 ? nb_at(a.psi, r, c + XM + m)
                          : nb_at(a.th, r, ((long long)(g.tsh + i) * g.X + x) * g.M + m);
    nb[1] = tl > 0 ? nb_at(a.psi, r, c - XM + m)
                   : nb_at(a.th, r, ((long long)i * g.X + x) * g.M + m);
  }
  const long long crow0 = crow * XM;
  nb[2] = nb_at(a.psi, r, crow0 + (long long)((x + 1) % g.X) * g.M + m);
  nb[3] = nb_at(a.psi, r, crow0 + (long long)((x + g.X - 1) % g.X) * g.M + m);
  // y hops: inside the slab, else the y halo (or the wrap inside the slab)
  const int mw = g.msh * g.zh;
  if (yl < yloc - 1) {
    nb[4] = nb_at(a.psi, r, c + m + g.zh);
  } else if (a.mh.p != nullptr) {
    nb[4] = nb_at(a.mh, r, ((long long)(g.T + t) * g.X + x) * mw + j * g.zh + k);
  } else {
    nb[4] = nb_at(a.psi, r, c + m - (yloc - 1) * g.zh);
  }
  if (yl > 0) {
    nb[5] = nb_at(a.psi, r, c + m - g.zh);
  } else if (a.mh.p != nullptr) {
    nb[5] = nb_at(a.mh, r, ((long long)t * g.X + x) * mw + j * g.zh + k);
  } else {
    nb[5] = nb_at(a.psi, r, c + m + (yloc - 1) * g.zh);
  }
  // z hops stay inside the y-row (K1's slot logic)
  const int mzf = s1 ? (k == g.zh - 1 ? m - (g.zh - 1) : m + 1) : m;
  const int mzb = s1 ? m : (k == 0 ? m + (g.zh - 1) : m - 1);
  nb[6] = nb_at(a.psi, r, c + mzf);
  nb[7] = nb_at(a.psi, r, c + mzb);
}

__device__ __forceinline__ void slab_store(const SlabArgs& a, int r, long long site,
                                           const float (&ar)[4][3], const float (&ai)[4][3]) {
  float* o = a.out + r * a.out_r;
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const long long e = (s * 3 + c) * a.out_comp + site;
      o[e] = ar[s][c];
      o[a.out_im + e] = ai[s][c];
    }
}

// n: flat index over (variant row, x, m) -> the output site; false past the end
__device__ __forceinline__ bool slab_site(const SlabGeo& g, long long n, int& i, int& tl, int& x,
                                          int& m, long long& site) {
  const long long XM = (long long)g.X * g.M;
  const int row = (int)(n / XM);
  if (row >= g.nrows) return false;
  const long long rem = n - row * XM;
  x = (int)(rem / g.M);
  m = (int)(rem - (long long)x * g.M);
  slab_row(g, row, i, tl);
  site = ((long long)(i * g.tl + tl) * g.X + x) * g.M + m;
  return true;
}

// R == 0: one thread per output site, links read directly (as K1)
template <bool COMP, typename G>
__global__ void __launch_bounds__(128)
slab_kernel(SlabArgs a, const G* __restrict__ ug) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int i, tl, x, m;
  long long site;
  if (!slab_site(a.g, n, i, tl, x, m, site)) return;
  const long long V = (long long)a.g.T * a.g.X * a.g.M;
  Nb nb[8];
  slab_neighbours(a, i, tl, x, m, 0, nb);
  float ar[4][3], ai[4][3];
  accum_src<COMP, G>(nb, ug, V, site, a.corr, ar, ai);
  slab_store(a, 0, site, ar, ai);
}

constexpr int kSlabCols = 12;

// R > 0: block (kRhsSites sites, up to kSlabCols columns), the links of the
// block's sites staged in shared memory once (as K1-R)
template <bool COMP, typename G>
__global__ void __launch_bounds__(kRhsSites * kSlabCols)
slab_rhs_kernel(SlabArgs a, const G* __restrict__ ug) {
  __shared__ float sl[8 * 18 * kRhsSites];
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x;
  int i, tl, x, m;
  long long site;
  const bool live = slab_site(a.g, n, i, tl, x, m, site);
  const long long V = (long long)a.g.T * a.g.X * a.g.M;
  if (live) stage_links<COMP, G>(ug, V, site, a.corr, sl, lane);
  __syncthreads();
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (!live || r >= a.R) return;
  Nb nb[8];
  slab_neighbours(a, i, tl, x, m, r, nb);
  float ar[4][3], ai[4][3];
  accum_staged(nb, sl, lane, ar, ai);
  slab_store(a, r, site, ar, ai);
}

template <bool COMP, typename G>
void launch_slab(const SlabArgs& a, const void* ug, cudaStream_t stream) {
  const long long n = (long long)a.g.nrows * a.g.X * a.g.M;
  const G* u = static_cast<const G*>(ug);
  if (a.R == 0) {
    slab_kernel<COMP, G><<<(unsigned)((n + 127) / 128), 128, 0, stream>>>(a, u);
  } else {
    const int cols = a.R < kSlabCols ? a.R : kSlabCols;
    const dim3 block(kRhsSites, cols);
    const dim3 grid((unsigned)((n + kRhsSites - 1) / kRhsSites),
                    (unsigned)((a.R + cols - 1) / cols));
    slab_rhs_kernel<COMP, G><<<grid, block, 0, stream>>>(a, u);
  }
}

bool bad_fld(const Fld& f, int R) {
  return f.p == nullptr || f.im <= 0 || f.comp <= 0 || (R > 0 && f.r <= 0);
}

// KH: the halos of one sharded hop, every slab in one launch.  It replaces
// the ~20 torch operations of the exchange around the slab kernels
// (dslash_cuda `_y_halos`, `_t_halos`: slice, project, roll, rebuild), the
// one-device counterpart of the reference's ppermute around
// `hopping_pallas_shard` (dslash_pallas.py:1345).  One thread per halo site
// and column (blockIdx.y): it reads the source row's site, projects it by
// W_d^+ (h_a = x_a + c_a x_{s_a}, c_a = +-1, one rounding each, as the slab
// kernel would form it from the neighbour) and writes 0.5 W_d h, whose W_d^+
// is h again exactly; without the half-spinor form it copies.  The slab
// shift of the exchange is index arithmetic: the y halo below slab column j
// (row t of mh) is the last y-row of column j-1, projected for direction 5;
// the one above (row T + t) the first y-row of column j+1, direction 4; the
// t halo below slab row i (row i of th) the last timeslice of row i-1,
// direction 1; the one above (row tsh + i) the first timeslice of row i+1,
// direction 0.  Threads run along the halo's minor index, so its stores are
// contiguous.  Bound: memory, 96 B read (the whole source site, also for
// the half-spinor form) and 96 B written per halo site and column; no flops
// to speak of.
struct HaloArgs {
  Fld psi;  // the whole field [.., T, X, M]
  float* mh;
  long long mh_im, mh_comp, mh_r;  // [.., 2 T, X, msh zh]; null with msh == 1
  float* th;
  long long th_im, th_comp, th_r;  // [.., 2 tsh, X, M]
  int T, X, M, zh, tsh, msh, tl, ml, half;
};

__global__ void __launch_bounds__(128) halo_kernel(HaloArgs a) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  const long long ny = a.mh != nullptr ? 2ll * a.T * a.X * a.msh * a.zh : 0;
  const long long nt = 2ll * a.tsh * a.X * a.M;
  if (n >= ny + nt) return;
  long long src, dst, o_im, o_comp;
  float* o;
  int d;
  if (n < ny) {
    // mh[(row X + x) msh zh + j zh + k], row = side T + t
    const int k = (int)(n % a.zh);
    long long q = n / a.zh;
    const int j = (int)(q % a.msh);
    q /= a.msh;
    const int x = (int)(q % a.X);
    const int row = (int)(q / a.X);
    const int side = row / a.T, t = row - side * a.T;
    const int js = side == 0 ? (j + a.msh - 1) % a.msh : (j + 1) % a.msh;
    const int m = js * a.ml + (side == 0 ? a.ml - a.zh : 0) + k;
    src = ((long long)t * a.X + x) * a.M + m;
    d = side == 0 ? 5 : 4;
    o = a.mh + r * a.mh_r;
    dst = n;
    o_im = a.mh_im;
    o_comp = a.mh_comp;
  } else {
    // th[(row X + x) M + m], row = side tsh + i
    const long long n2 = n - ny;
    const int m = (int)(n2 % a.M);
    const long long q = n2 / a.M;
    const int x = (int)(q % a.X);
    const int row = (int)(q / a.X);
    const int side = row / a.tsh, i = row - side * a.tsh;
    const int is = side == 0 ? (i + a.tsh - 1) % a.tsh : (i + 1) % a.tsh;
    const int t = is * a.tl + (side == 0 ? a.tl - 1 : 0);
    src = ((long long)t * a.X + x) * a.M + m;
    d = side == 0 ? 1 : 0;
    o = a.th + r * a.th_r;
    dst = n2;
    o_im = a.th_im;
    o_comp = a.th_comp;
  }
  const float* p = a.psi.p + r * a.psi.r;
  float vr[4][3], vi[4][3];
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      vr[s][c] = __ldg(p + (s * 3 + c) * a.psi.comp + src);
      vi[s][c] = __ldg(p + a.psi.im + (s * 3 + c) * a.psi.comp + src);
    }
  if (a.half) {
    // column a of W_d: the identity row a and one lower row s_a with c_a =
    // +-1 (W-TABLE of hopping_common.cuh): d = 0 rows (2, 3) (+1, +1);
    // 1 (2, 3) (-1, -1); 4 (3, 2) (+1, -1); 5 (3, 2) (-1, +1)
    const bool low2 = d < 4;  // s_0 = 2, s_1 = 3 (else s_0 = 3, s_1 = 2)
    const float c0 = (d == 1 || d == 5) ? -1.f : 1.f;
    const float c1 = (d == 1 || d == 4) ? -1.f : 1.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      // selects, not an index: the arrays stay in registers
      const float s0r = low2 ? vr[2][c] : vr[3][c], s0i = low2 ? vi[2][c] : vi[3][c];
      const float s1r = low2 ? vr[3][c] : vr[2][c], s1i = low2 ? vi[3][c] : vi[2][c];
      const float h0r = vr[0][c] + c0 * s0r, h0i = vi[0][c] + c0 * s0i;
      const float h1r = vr[1][c] + c1 * s1r, h1i = vi[1][c] + c1 * s1i;
      vr[0][c] = 0.5f * h0r;
      vi[0][c] = 0.5f * h0i;
      vr[1][c] = 0.5f * h1r;
      vi[1][c] = 0.5f * h1i;
      const float l0r = (0.5f * c0) * h0r, l0i = (0.5f * c0) * h0i;
      const float l1r = (0.5f * c1) * h1r, l1i = (0.5f * c1) * h1i;
      vr[2][c] = low2 ? l0r : l1r;
      vi[2][c] = low2 ? l0i : l1i;
      vr[3][c] = low2 ? l1r : l0r;
      vi[3][c] = low2 ? l1i : l0i;
    }
  }
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      o[(s * 3 + c) * o_comp + dst] = vr[s][c];
      o[o_im + (s * 3 + c) * o_comp + dst] = vi[s][c];
    }
}

int launch_halo(const HaloArgs& a, int R, cudaStream_t stream) {
  const long long n = (a.mh != nullptr ? 2ll * a.T * a.X * a.msh * a.zh : 0) +
                      2ll * a.tsh * a.X * a.M;
  halo_kernel<<<dim3((unsigned)((n + 127) / 128), (unsigned)(R > 0 ? R : 1)), 128, 0,
                stream>>>(a);
  return (int)cudaGetLastError();
}

// the slab geometry shared by the C entries; false on an invalid one
bool slab_geometry(int T, int X, int M, int zh, int p, int tsh, int msh, int& tl, int& ml) {
  if (T <= 0 || X <= 0 || M <= 0 || zh <= 0 || M % zh != 0 || (p != 0 && p != 1) ||
      tsh <= 0 || msh <= 0 || T % tsh != 0 || M % msh != 0)
    return false;
  tl = T / tsh;
  ml = M / msh;
  return tl % 2 == 0 && ml % zh == 0 && (ml / zh) % 2 == 0;
}

void fill_corr(Corr& corr, int comp, const float* corr16) {
  for (int d = 0; d < 8; ++d) {
    corr.re[d] = comp ? corr16[2 * d] : 1.f;
    corr.im[d] = comp ? corr16[2 * d + 1] : 0.f;
  }
}

template <bool COMP>
void launch_slab_on(const SlabArgs& a, const void* ug, int gbf16, cudaStream_t s) {
  if (gbf16) launch_slab<COMP, __nv_bfloat16>(a, ug, s);
  else launch_slab<COMP, float>(a, ug, s);
}

void launch_slab_any(const SlabArgs& a, const void* ug, int comp, int gbf16, cudaStream_t s) {
  if (comp) launch_slab_on<true>(a, ug, gbf16, s);
  else launch_slab_on<false>(a, ug, gbf16, s);
}

// info[0..3] = resident blocks per SM (the occupancy API), registers per
// thread, local-memory bytes (spills, stack) per thread, threads per block
template <typename K>
int slab_kernel_info(K kern, int block, int* info) {
  cudaFuncAttributes attr{};
  cudaFuncGetAttributes(&attr, (const void*)kern);
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, block, 0);
  info[0] = per_sm;
  info[1] = attr.numRegs;
  info[2] = (int)attr.localSizeBytes;
  info[3] = block;
  return (int)cudaGetLastError();
}

// K2-S: d Re<g, H_{p,q} psi> / d ug[p] on a rank's slab (one slab row
// and column, kAll geometry), the neighbours across the slab's t and y
// edges from the halos the forward hop received.  The arithmetic is K2's:
// ghat = W^+ g, h = W^+ nbr, F[i][j] = sum_a ghat[a][i] conj(h[a][j]); a
// half-spinor halo 0.5 W h gives W^+ back exactly, so the result equals K2
// on the whole lattice.  One thread per site, its 8 x 9 link cotangents
// written without atomics.  Bound: memory (96 B of g, 8 neighbour reads of
// 96 B mostly cached, 576 B written per site).
template <int D>
__device__ __forceinline__ void vjp_slab_dir(const Nb& nb, long long V, long long site,
                                             const float (&g_r)[4][3], const float (&g_i)[4][3],
                                             float* __restrict__ out) {
  float nr[4][3], ni[4][3];
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      nr[s][c] = __ldg(nb.p + (s * 3 + c) * nb.st.comp + nb.i);
      ni[s][c] = __ldg(nb.p + nb.st.im + (s * 3 + c) * nb.st.comp + nb.i);
    }
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

__global__ void __launch_bounds__(128)
ug_vjp_slab_kernel(const float* __restrict__ g, SlabArgs a, float* __restrict__ out) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int i, tl, x, m;
  long long site;
  if (!slab_site(a.g, n, i, tl, x, m, site)) return;
  const long long V = (long long)a.g.T * a.g.X * a.g.M;
  Nb nb[8];
  slab_neighbours(a, i, tl, x, m, 0, nb);
  float g_r[4][3], g_i[4][3];
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      g_r[s][c] = __ldg(g + (s * 3 + c) * V + site);
      g_i[s][c] = __ldg(g + (12 + s * 3 + c) * V + site);
    }
  vjp_slab_dir<0>(nb[0], V, site, g_r, g_i, out);
  vjp_slab_dir<1>(nb[1], V, site, g_r, g_i, out);
  vjp_slab_dir<2>(nb[2], V, site, g_r, g_i, out);
  vjp_slab_dir<3>(nb[3], V, site, g_r, g_i, out);
  vjp_slab_dir<4>(nb[4], V, site, g_r, g_i, out);
  vjp_slab_dir<5>(nb[5], V, site, g_r, g_i, out);
  vjp_slab_dir<6>(nb[6], V, site, g_r, g_i, out);
  vjp_slab_dir<7>(nb[7], V, site, g_r, g_i, out);
}

}  // namespace

extern "C" {

// One slab-kernel launch over all slabs.  variant: 0 K3 / K1-T (psi the
// extended field, every row), 1 K3-I (psi the whole field, rows 1 .. T_loc-2
// of every slab row), 2 K4 (psi the whole field, rows 0 and T_loc-1, t
// halos from th), 3 K3-I+K4 (psi the whole field, every row, t halos from
// th).  mh null: the y hops wrap inside the slab (msh must be
// 1).  Field strides as in `Fld` (r strides read only when R > 0).  comp:
// the 12-real copy with corr16 (8 (re, im) pairs on the host); gbf16: a
// bf16 gauge.  Returns cudaGetLastError() after the launch (0 = success);
// an invalid argument returns cudaErrorInvalidValue.
int tm_hopping_slab(const float* psi, long long psi_im, long long psi_comp, long long psi_r,
                    const float* th, long long th_im, long long th_comp, long long th_r,
                    const float* mh, long long mh_im, long long mh_comp, long long mh_r,
                    const void* ug, float* out, long long out_im, long long out_comp,
                    long long out_r, int T, int X, int M, int zh, int p, int tsh, int msh,
                    int variant, int comp, int gbf16, const float* corr16, int R,
                    void* stream) {
  if (T <= 0 || X <= 0 || M <= 0 || zh <= 0 || M % zh != 0 || (p != 0 && p != 1) ||
      tsh <= 0 || msh <= 0 || T % tsh != 0 || M % msh != 0 || variant < 0 || variant > 3 ||
      R < 0 || ug == nullptr || out == nullptr || (comp && corr16 == nullptr))
    return (int)cudaErrorInvalidValue;
  const int tl = T / tsh, ml = M / msh;
  if (tl % 2 != 0 || ml % zh != 0 || (ml / zh) % 2 != 0 || (variant == kInt && tl < 4))
    return (int)cudaErrorInvalidValue;
  const Fld fpsi{psi, psi_im, psi_comp, psi_r};
  const Fld fth{th, th_im, th_comp, th_r};
  const Fld fmh{mh, mh_im, mh_comp, mh_r};
  if (bad_fld(fpsi, R) || ((variant == kBnd || variant == kAll) && bad_fld(fth, R)) ||
      (mh == nullptr ? msh != 1 : bad_fld(fmh, R)) || out_im <= 0 || out_comp <= 0 ||
      (R > 0 && out_r <= 0))
    return (int)cudaErrorInvalidValue;
  const int nrows = variant == kExt || variant == kAll ? T
                  : variant == kInt                     ? tsh * (tl - 2)
                                                        : 2 * tsh;
  SlabArgs a{fpsi, fth, fmh, out, out_im, out_comp, out_r,
             SlabGeo{T, X, M, zh, p, tsh, msh, tl, ml, variant, nrows}, Corr{}, R};
  for (int d = 0; d < 8; ++d) {
    a.corr.re[d] = comp ? corr16[2 * d] : 1.f;
    a.corr.im[d] = comp ? corr16[2 * d + 1] : 0.f;
  }
  launch_slab_any(a, ug, comp, gbf16, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// KH alone: the y halos into mh (null when msh == 1) and the t halos into
// th of the field psi, for every slab; half != 0 the half-spinor form.
// Strides as tm_hopping_slab's.  Returns cudaGetLastError() after the
// launch; an invalid argument returns cudaErrorInvalidValue.
int tm_halo_pack(const float* psi, long long psi_im, long long psi_comp, long long psi_r,
                 float* mh, long long mh_im, long long mh_comp, long long mh_r, float* th,
                 long long th_im, long long th_comp, long long th_r, int T, int X, int M,
                 int zh, int tsh, int msh, int half, int R, void* stream) {
  int tl = 0, ml = 0;
  if (!slab_geometry(T, X, M, zh, 0, tsh, msh, tl, ml) || R < 0 ||
      bad_fld(Fld{psi, psi_im, psi_comp, psi_r}, R) ||
      bad_fld(Fld{th, th_im, th_comp, th_r}, R) ||
      (mh == nullptr ? msh != 1 : bad_fld(Fld{mh, mh_im, mh_comp, mh_r}, R)))
    return (int)cudaErrorInvalidValue;
  const HaloArgs a{Fld{psi, psi_im, psi_comp, psi_r}, mh, mh_im, mh_comp, mh_r, th, th_im,
                   th_comp, th_r, T, X, M, zh, tsh, msh, tl, ml, half};
  return launch_halo(a, R, (cudaStream_t)stream);
}

// The instance of KH (which 0), or of the slab kernel on a 12-real f32
// gauge with one spinor (which 1: K3, K3-I, K4 and K3-I+K4 as path 9's
// solves run them): info[0..3] as slab_kernel_info.  Launches nothing.
int tm_slab_info(int which, int* info) {
  if (info == nullptr || which < 0 || which > 1) return (int)cudaErrorInvalidValue;
  return which == 0 ? slab_kernel_info(halo_kernel, 128, info)
                    : slab_kernel_info(slab_kernel<true, float>, 128, info);
}

// One sharded hop with the overlap in one call: KH (the halos into the
// caller's mh and th), then the slab kernel over every row of every slab
// (K3-I+K4), both on `stream`.  `out` has psi's strides.  Returns the first
// error (0 = success); an invalid argument returns cudaErrorInvalidValue.
//
// KH comes first, so on one card nothing is left for a side stream to
// overlap: after KH, K3-I on a side stream beside K4 took 37.8-85.7 us of
// wrapper loop and 22.3-30.5 us of device time per hop at 16^3 x 32 on
// (4,2), the one launch 37.8-60.1 us and 17.0-17.7 us (chip_smoke.py on an
// NVIDIA H100 80GB HBM3 at 700.00 W; PERF.md section 6, runs C and D).
int tm_shard_hop(const float* psi, long long psi_im, long long psi_comp, long long psi_r,
                 float* mh, long long mh_im, long long mh_comp, long long mh_r, float* th,
                 long long th_im, long long th_comp, long long th_r, const void* ug, float* out,
                 int T, int X, int M, int zh, int p, int tsh, int msh, int half, int comp,
                 int gbf16, const float* corr16, int R, void* stream) {
  int tl = 0, ml = 0;
  const Fld fpsi{psi, psi_im, psi_comp, psi_r};
  const Fld fth{th, th_im, th_comp, th_r};
  const Fld fmh{mh, mh_im, mh_comp, mh_r};
  if (!slab_geometry(T, X, M, zh, p, tsh, msh, tl, ml) || R < 0 || ug == nullptr ||
      out == nullptr || (comp && corr16 == nullptr) || bad_fld(fpsi, R) || bad_fld(fth, R) ||
      (mh == nullptr ? msh != 1 : bad_fld(fmh, R)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int rc = launch_halo(HaloArgs{fpsi, mh, mh_im, mh_comp, mh_r, th, th_im, th_comp, th_r,
                                      T, X, M, zh, tsh, msh, tl, ml, half},
                             R, s);
  if (rc != 0) return rc;
  SlabArgs a{fpsi, fth, fmh, out, psi_im, psi_comp, psi_r,
             SlabGeo{T, X, M, zh, p, tsh, msh, tl, ml, kAll, T}, Corr{}, R};
  fill_corr(a.corr, comp, corr16);
  launch_slab_any(a, ug, comp, gbf16, s);
  return (int)cudaGetLastError();
}

// K2-S on one rank's slab [T X M] (contiguous fields): g, psi [2][4][3][V];
// th [2][4][3][2][X M] (row 0 the halo below, row 1 above); mh
// [2][4][3][2 T][X zh] or null (one y slab: the y hops wrap); out
// [2][8][3][3][V].  Returns cudaGetLastError() after the launch; an invalid
// argument returns cudaErrorInvalidValue.
int tm_ug_vjp_slab(const float* g, const float* psi, const float* th, const float* mh,
                   float* out, int T, int X, int M, int zh, int p, void* stream) {
  int tl = 0, ml = 0;
  if (!slab_geometry(T, X, M, zh, p, 1, 1, tl, ml) || g == nullptr || psi == nullptr ||
      th == nullptr || out == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long V = (long long)T * X * M;
  const long long tv = 2ll * X * M, yv = 2ll * T * X * zh;
  SlabArgs a{Fld{psi, 12 * V, V, 0}, Fld{th, 12 * tv, tv, 0}, Fld{mh, 12 * yv, yv, 0},
             nullptr, 0, 0, 0, SlabGeo{T, X, M, zh, p, 1, 1, tl, ml, kAll, T}, Corr{}, 0};
  ug_vjp_slab_kernel<<<(unsigned)((V + 127) / 128), 128, 0, (cudaStream_t)stream>>>(g, a, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
