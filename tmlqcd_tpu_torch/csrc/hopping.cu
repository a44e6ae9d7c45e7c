// Even/odd Wilson hopping (K1), the Schur operator in one launch (K1-S), the
// doublet's Schur operator in one launch (K1-SD), the multi-right-hand-side
// form (K1-R) and the gauge-cotangent kernel (K2) for NVIDIA Hopper
// (sm_90a), bound to Python through a plain C interface.
//
// K1 replaces the Pallas kernel `_dslash_kernel` (+ `_stencil_accum`,
// `_apply_epilogue`) of tmlqcd_tpu/ops/dslash_pallas.py; K1-S the two or
// four `_dslash_kernel` calls of one Mhat / Qhat_pm (the reference's
// ops/wilson_fast.py m_hat_fast, q_hat_pm_fast and the clover forms); K1-SD
// the two or four `_dslash_kernel_r` calls (r_pos 1) and the jnp flavour
// diagonals of one Q_nd / Q_nd^2 (the reference's q_nd_fast, q_nd_sq_fast
// :376-388 and the clover forms :609-622); K1-R replaces `_dslash_kernel_r` /
// `_dslash_kernel_tb_r`; K2 replaces `_ug_vjp_kernel` of the same file.  All read the reference's split
// structure-of-arrays layout unchanged (the bf16 copy: see load_link in
// hopping_common.cuh):
//
//   psi  [2 re/im][4 spin][3 colour][V]          V = T * X * M sites of one parity
//   psi  [2 re/im][4 spin][3 colour][R][V]       K1-R: R right-hand sides
//   psi  [2 re/im][2 flavour][4 spin][3 colour][V]  K1-R on a flavour doublet
//   ug   [2 re/im][8 dir][rows][3 col][V]        rows = 3 (18 reals) or 2 (12 reals)
//   out  like psi (K1, K1-R) or [2][8][3][3][V] (K2)
//   blk  [2 re/im][72][V]                        clover epilogues: two 6 x 6 complex
//                                                blocks per site, entry
//                                                k = ((b 2 + s) 2 + s') 9 + 3 c + c'
//                                                (b chirality, s s' spin in it, c c' colour)
//
// with direction d = 2 mu + fb (fb = 0 forward, 1 backward), the boundary
// phases already folded into the gauge copy.
//
// The stencil's building blocks (the maps W, the link load, the step of one
// direction) live in hopping_common.cuh, shared with the slab kernels of
// hopping_slab.cu.
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
// Clover epilogues (`_apply_epilogue` clov_inv / clov_mhat with `_blk_matvec`
// of the same Pallas file): the per-site block matvec runs on the
// accumulators while they are still in registers, so H psi never makes a
// round trip through device memory before M_ee^-1 or M_oo is applied.  It
// works chirality by chirality: the six complex inputs of one chirality
// against the 72 block floats of that chirality, streamed and used once, so
// the 24 accumulators are never doubled.  The blocks are not hermitian
// (1 + T +- i mu gamma5 is only normal): all 72 complex entries are read.
// They add 576 B per site to the bytes below and 576 flops to the 1320.
//
// The bf16 gauge (K1-B; `_load_g` and the upcast in `_stencil_accum` of the
// Pallas file, reached from `make_fast_gauge(sloppy=True)`): K1 reads the
// links as __nv_bfloat16, re and im of an element side by side in one
// 4-byte __nv_bfloat162 load, and upcasts them in registers.  Everything
// after the load stays f32: the 12-real row-2 reconstruction (from the
// rounded rows 0 and 1), the accumulation and every epilogue.  K1-R has the
// same bf16 instances (K1-RB, the bf16 instances of `_dslash_kernel_r`): the
// block stages the upcast links once for its columns; K2 reads f32 links.
// It moves 288 B (18-real) or 192 B (12-real) of gauge per site instead of
// 576 or 384.  With re and im V elements apart (the f32 copy's layout) a
// warp's link load moved 64 B; with them side by side it moves a 128-byte
// line, and K1-B came closer to copy bandwidth at 32^3x64.  Two sites per
// thread on paired loads, the other way to whole lines, took 144 registers
// (3 blocks per SM) and was slower than either: occupancy, not load width,
// then bound it (chip_smoke.py's phase 3; the measured shares, with the
// card and its power limit, are in PERF.md section 6).
//
// Bound: memory.  1320 flops per site against 576 B (18-real) or 384 B
// (12-real) of gauge, 96 B per spinor read (8 neighbour reads of which the
// caches absorb most) and 96 B written; the mhat epilogue reads one more
// spinor.  At ~1.7-2.3 flop/B it sits far below the card's ridge point, so
// the only lever is bytes.  K1 relies on L1/L2 for neighbour reuse and
// comes close to copy bandwidth at 32^3x64 (chip_smoke.py's phase 3; the
// shares, with the card and its power limit, are in PERF.md section 6), so
// shared-memory tiling of the neighbours has little left to win there.  At
// the main paths' 16^3x32 the kernel body sits within 1.2-1.5x of its bound
// and the host set the time: more Python and launch per K1 call than time
// on the device (PERF.md section 6).  K1-S answers that (below).
//
// K1-S: the two hops of Mhat(+-) or the four of Qhat_pm, each K1's per-site
// work with its epilogue (mee_inv then mhat, or clov_inv then clov_mhat), as
// phases of one cooperative launch separated by grid-wide barriers
// (cooperative_groups::this_grid().sync(), no -rdc).  The grid is what the
// card holds resident (the occupancy API x SMs) and each phase walks its
// sites in a grid-stride loop.  One wrapper call and one launch replace two
// or four; the arithmetic is K1's device functions in K1's order, so the
// result is bit for bit that of the K1 launches.  Every intermediate field
// has a buffer of its own, so no phase reads a field through the read-only
// cache that a later phase writes.  Bound: memory, the hops' bytes summed
// (Qhat_pm on the 12-real f32 copy: 2 x 576 + 2 x 672 = 2496 B per site of
// one parity); the barriers add a few microseconds each.
//
// K1-R: one thread per (site, right-hand side); threadIdx.x runs along the
// sites (one 128-byte line per component load of a warp, as in K1) and
// threadIdx.y along the right-hand sides.  The rows of a block first share
// out the 8 directions and stage the links of the block's 32 sites in
// shared memory (18 KB, row 2 of the 12-real copy rebuilt once), so the
// gauge is read once per block; left to L1, the link lines were evicted by
// the spinor stream between the rows and came from L2 for each of them.
// The clover blocks of the block's sites are staged the same way (another
// 18 KB) for the clover epilogues.
// Then each thread runs K1's per-site arithmetic (the same device
// functions) on its column, which keeps the register count at K1's.
// Bound: memory, G + R * (192 [+ 96 for mhat]) bytes per site with G = 576
// or 384, plus 576 for the clover blocks.  On large lattices the blocks walk
// a few timeslices innermost (rhs_t_inner), which keeps the t-neighbours of
// the whole batch in L2.
// The field is addressed through three element strides (re/im, component,
// right-hand side), so the position of the R axis is the wrapper's choice:
// {12 R V, R V, V} for the batch axis before the sites, and {24 V, V, 12 V}
// for the flavour doublet of the non-degenerate operator, whose two flavours
// are the R = 2 right-hand sides (`_dslash_kernel_r` with r_pos = 1 in the
// Pallas file: one read of the gauge for both flavours, epilogue none, the
// flavour-mixing diagonal applied outside the kernel).  Its byte model is
// G + 2 * 192 = 960 B (18-real) or 768 B (12-real) per site, against
// 2 * (G + 192) for two K1 launches.  With R = 2 a block is 32 sites x 2
// rows = 64 threads, and each row stages four of the eight directions.
//
// K1-SD: Q_nd = gamma5 tau1 Mhat_nd (2 phases) or Q_nd^2 (4) of the doublet
// as phases of one cooperative launch, as K1-S runs Qhat_pm.  Each phase is
// one hop of both flavours with the flavour-mixing diagonal fused: even
// Mee_nd^-1 (twisted mass: (x - i mubar g5 tau3 x - epsbar tau1 x) / (1 +
// mubar^2 - epsbar^2); clover: FastCloverND's [[A, -eps E], [-eps E, B]] on
// the 6 x 6 chirality blocks), odd gamma5 tau1 (Mee_nd chi_o - k2 H tmp)
// (clover: [[moo_u, eps], [eps, moo_d]]).  It replaces 2 or 4 K1-R-D
// launches and ~25 or ~50 small torch operations, whose host time set the
// operator's (the device sat idle) and whose passes over the field set its
// device time at 32^3 x 64.  The twisted-mass kernel holds both flavours of
// a site in one thread, the link loaded and rebuilt once for both; its
// epilogues round as the torch composition does (one _rn intrinsic per
// operation), so it equals the K1-R-D launches plus the torch diagonals bit
// for bit.  The clover kernel splits a site over two threads, one per
// flavour, which swap accumulators through shared memory (the block
// epilogues of both flavours did not fit one thread's registers).  Bound:
// memory, 768 B per site for a hop of both flavours (12-real: 384 gauge + 2
// x (96 + 96)), 192 B more for the odd phase's chi_o: Q_nd 1728, Q_nd^2 3456
// B per site of one parity; the clover doublet adds 3 (even) + 2 (odd)
// block fields of 576 B per Q_nd.

#include <cooperative_groups.h>

#include "hopping_common.cuh"

// The part of this file's instances one compilation builds (see the note
// above the tm_part_* functions); 0 holds the C entries.
#ifndef TM_PART
#define TM_PART 0
#endif

namespace {

// EPI: 0 none (out = H psi), 1 mee_inv (out = Mee^-1 H psi),
//      2 mhat (out = [g5] (Mee psi_o - k2 H psi)); 3 and 4 are the clover
//      epilogues of store_clover
template <int EPI, bool G5>
__device__ __forceinline__ void store_epilogue(const float (&ar)[4][3], const float (&ai)[4][3],
                                               const float* __restrict__ psi_o,
                                               float* __restrict__ out, const Strides& st,
                                               int site, float mt, float inv, float k2) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const float gs = s < 2 ? 1.f : -1.f;  // gamma5 = diag(+,+,-,-)
    const float gmt = mt * gs;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const long long ore = (s * 3 + c) * st.comp + site;
      const long long oim = st.im + ore;
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

// The clover epilogues.  EPI 3 clov_inv: out = scale * B (H psi), B the
// M_ee^-1 blocks of the even sites; EPI 4 clov_mhat: out = [g5] (B psi_o -
// k2 H psi), B the M_oo blocks of the odd sites.  Block entry (ri, k) of this
// thread's site is blk[(ri * 72 + k) * bstride + bidx]: device memory for K1
// (LDG: read-only path), the block's staged copy in shared memory for K1-R.
template <int EPI, bool G5, bool LDG>
__device__ __forceinline__ void store_clover(const float (&ar)[4][3], const float (&ai)[4][3],
                                             const float* __restrict__ psi_o,
                                             float* __restrict__ out, const Strides& st,
                                             int site, float scale, float k2,
                                             const float* __restrict__ blk, long long bstride,
                                             int bidx) {
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    // the six complex inputs of chirality b
    float xr[2][3], xi[2][3];
#pragma unroll
    for (int sp = 0; sp < 2; ++sp)
#pragma unroll
      for (int cp = 0; cp < 3; ++cp) {
        if (EPI == 3) {
          xr[sp][cp] = ar[2 * b + sp][cp];
          xi[sp][cp] = ai[2 * b + sp][cp];
        } else {
          const long long o = ((2 * b + sp) * 3 + cp) * st.comp + site;
          xr[sp][cp] = __ldg(psi_o + o);
          xi[sp][cp] = __ldg(psi_o + st.im + o);
        }
      }
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float sr = 0.f, si = 0.f;
#pragma unroll
        for (int sp = 0; sp < 2; ++sp)
#pragma unroll
          for (int cp = 0; cp < 3; ++cp) {
            const int k = ((b * 2 + s) * 2 + sp) * 9 + c * 3 + cp;
            const float* pr = blk + k * bstride + bidx;
            const float* pi = blk + (72 + k) * bstride + bidx;
            const float br = LDG ? __ldg(pr) : *pr;
            const float bi = LDG ? __ldg(pi) : *pi;
            sr += br * xr[sp][cp] - bi * xi[sp][cp];
            si += br * xi[sp][cp] + bi * xr[sp][cp];
          }
        const long long ore = ((2 * b + s) * 3 + c) * st.comp + site;
        const long long oim = st.im + ore;
        if (EPI == 3) {
          out[ore] = scale * sr;
          out[oim] = scale * si;
        } else {
          const float g5s = (G5 && b == 1) ? -1.f : 1.f;  // gamma5 = diag(+,+,-,-)
          out[ore] = g5s * (sr - k2 * ar[2 * b + s][c]);
          out[oim] = g5s * (si - k2 * ai[2 * b + s][c]);
        }
      }
  }
}

// K1's work on one site: the sum of the 8 directions and the epilogue
template <int EPI, bool G5, bool COMP, typename G>
__device__ __forceinline__ void hop_site(const float* __restrict__ psi,
                                         const G* __restrict__ ug,
                                         const float* __restrict__ psi_o,
                                         const float* __restrict__ blocks,
                                         float* __restrict__ out, const Geo& geo, long long V,
                                         int site, float mt, float inv, float k2,
                                         const Corr& corr) {
  const Strides st{12 * V, V};
  float ar[4][3], ai[4][3];
  accum_site<COMP, G>(psi, ug, geo, V, st, site, corr, ar, ai);
  if constexpr (EPI >= 3)
    store_clover<EPI, G5, true>(ar, ai, psi_o, out, st, site, inv, k2, blocks, V, site);
  else
    store_epilogue<EPI, G5>(ar, ai, psi_o, out, st, site, mt, inv, k2);
}

// K1: one thread per site
template <int EPI, bool G5, bool COMP, typename G>
__global__ void __launch_bounds__(128)
hopping_kernel(const float* __restrict__ psi, const G* __restrict__ ug,
               const float* __restrict__ psi_o, const float* __restrict__ blocks,
               float* __restrict__ out, Geo geo, float mt, float inv, float k2, Corr corr) {
  const long long V = (long long)geo.T * geo.X * geo.M;
  const int site = blockIdx.x * blockDim.x + threadIdx.x;
  if (site >= V) return;
  hop_site<EPI, G5, COMP, G>(psi, ug, psi_o, blocks, out, geo, V, site, mt, inv, k2, corr);
}

// K1-S: the Schur operator in one persistent launch.  A phase is one K1 hop
// with its epilogue; the phases of Mhat (2) or Qhat_pm (4) run one after the
// other, separated by grid-wide barriers, in one cooperative launch.
struct Phase {
  const float* psi;     // the hopped field
  const float* psi_o;   // the odd input of Mhat (odd phases: mhat, clov_mhat)
  const float* blocks;  // clover blocks (clov_inv, clov_mhat)
  float* out;
  float mt, inv, k2;
};

constexpr int kMaxPhases = 4;

struct SchurArgs {
  Phase ph[kMaxPhases];
  const void* ug[2];  // the link copies of the even and the odd output sites
  Geo geo;            // geo.p is set phase by phase
  Corr corr;
  int nphase;
};

// K1-S holds at least this many blocks of 128 per SM: its registers are
// capped at 128 (65536 / (4 x 128)).  Uncapped it took 118 (twisted mass)
// to 144 (clover) registers, 3-4 blocks per SM, since the grid-stride loop
// keeps the phase's descriptor and hoisted address arithmetic in registers
// across its iterations.  528 resident blocks on 132 SMs cover 16^3x32's 512
// in one pass of every phase.  Timed with chip_smoke.py (PERF.md section 6
// names the card and its power limit; ptxas for sm_90a), the alternatives
// were slower: capped at K1's 80 registers it spilled 144 B a thread; with
// the four phases written out (four copies of the per-site code,
// constant-index descriptors) or the site's work behind a call that is not
// inlined (a 296-byte stack frame), a Qhat_pm took 1.3-1.5x longer at
// 16^3x32.
constexpr int kSchurBlocksPerSM = 4;

// One phase of K1-S: K1's per-site work with epilogue EPI on every site of
// the phase's parity, walked in a grid-stride loop (the grid is what the
// card holds resident, so any volume runs).
template <int EPI, bool G5, bool COMP, typename G>
__device__ __forceinline__ void schur_phase(const Phase& f, const G* __restrict__ ug,
                                            const Geo& geo, int V, const Corr& corr) {
  for (int site = blockIdx.x * blockDim.x + threadIdx.x; site < V;
       site += gridDim.x * blockDim.x)
    hop_site<EPI, G5, COMP, G>(f.psi, ug, f.psi_o, f.blocks, f.out, geo, V, site, f.mt, f.inv,
                               f.k2, corr);
}

// Even phases (p = 0) run the even epilogue, mee_inv or clov_inv; odd phases
// (p = 1) the odd one, mhat or clov_mhat (G5: with gamma5).  The phase's
// descriptor is picked with constant indices, so the kernel parameters are
// read where they lie and never copied to local memory.
template <bool CLOV, bool G5, bool COMP, typename G>
__global__ void __launch_bounds__(128, kSchurBlocksPerSM)
hopping_schur_kernel(SchurArgs a) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int V = a.geo.T * a.geo.X * a.geo.M;
  for (int ph = 0; ph < a.nphase; ++ph) {
    if (ph > 0) grid.sync();
    const Phase f = ph == 0 ? a.ph[0] : ph == 1 ? a.ph[1] : ph == 2 ? a.ph[2] : a.ph[3];
    Geo geo = a.geo;
    geo.p = ph & 1;
    if (ph & 1)
      schur_phase<CLOV ? 4 : 2, G5, COMP, G>(f, static_cast<const G*>(a.ug[1]), geo, V,
                                             a.corr);
    else
      schur_phase<CLOV ? 3 : 1, false, COMP, G>(f, static_cast<const G*>(a.ug[0]), geo, V,
                                                a.corr);
  }
}

// K1-SD: the doublet Schur operator Q_nd = gamma5 tau1 Mhat_nd (2 phases) or
// Q_nd^2 (4) in one persistent launch, as K1-S runs Qhat_pm.  A phase is one
// hop of both flavours with its flavour-mixing epilogue; the doublet is
// [2 re/im][2 flavour][4][3][V] (strides {24 V, V}, flavour 12 V).
struct NdPhase {
  const float* chi;     // the hopped doublet
  const float* chi_o;   // odd phases: the stage's input
  const float* blk[3];  // clover: even minv_a, minv_b, minv_e; odd moo_u, moo_d
  float* out;
  // twisted mass: even (mubar, epsbar, 1 / (1 + mubar^2 - epsbar^2)), odd
  // (mubar, epsbar, k2); clover: even (epsbar), odd (epsbar, k2)
  float c0, c1, c2;
};

struct SchurNdArgs {
  NdPhase ph[kMaxPhases];
  const float* ug[2];  // the f32 link copies of the even and the odd output sites
  Geo geo;             // geo.p is set phase by phase
  Corr corr;
  int nphase;
};

// acc_f += W_D U (W_D^+ chi_f(nsite)) for both flavours on one load of the
// link: K1-R-D's per-flavour step (hop_dir on the same upcast, rebuilt link)
template <int D, bool COMP>
__device__ __forceinline__ void nd_dir(const float* __restrict__ chi,
                                       const float* __restrict__ ug, long long V,
                                       const Strides& st, long long nsite, long long site,
                                       const Corr& corr, float (&ar)[2][4][3],
                                       float (&ai)[2][4][3]) {
  float gr[3][3], gi[3][3];
  load_link<D, COMP, float>(ug, V, site, corr, gr, gi);
  hop_dir<D>(chi, st, nsite, gr, gi, ar[0], ai[0]);
  hop_dir<D>(chi + 12 * V, st, nsite, gr, gi, ar[1], ai[1]);
}

// H chi of both flavours at `site`: directions 0..7 in K1's order
template <bool COMP>
__device__ __forceinline__ void accum_doublet(const float* __restrict__ chi,
                                              const float* __restrict__ ug, const Geo& geo,
                                              long long V, int site, const Corr& corr,
                                              float (&ar)[2][4][3], float (&ai)[2][4][3]) {
  const Strides st{24 * V, V};
  int nb[8];
  neighbours(geo, site, nb);
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int c = 0; c < 3; ++c) { ar[f][s][c] = 0.f; ai[f][s][c] = 0.f; }
  nd_dir<0, COMP>(chi, ug, V, st, nb[0], site, corr, ar, ai);
  nd_dir<1, COMP>(chi, ug, V, st, nb[1], site, corr, ar, ai);
  nd_dir<2, COMP>(chi, ug, V, st, nb[2], site, corr, ar, ai);
  nd_dir<3, COMP>(chi, ug, V, st, nb[3], site, corr, ar, ai);
  nd_dir<4, COMP>(chi, ug, V, st, nb[4], site, corr, ar, ai);
  nd_dir<5, COMP>(chi, ug, V, st, nb[5], site, corr, ar, ai);
  nd_dir<6, COMP>(chi, ug, V, st, nb[6], site, corr, ar, ai);
  nd_dir<7, COMP>(chi, ug, V, st, nb[7], site, corr, ar, ai);
}

// The twisted-mass epilogues round where the torch composition rounds
// (ops/dslash_cuda.py `_mee_inv_nd_split`, `_mee_nd_split`, then
// `- k2 * tmp` and gamma5 tau1), one IEEE operation at a time with the _rn
// intrinsics, which nvcc never contracts into an FMA; gamma5, tau1 and i
// only move and negate values.  So the result is the composed path's bits.
//
// even: out_f = ((x_f - i mu_f g5 x_f) - eps x_{1-f}) * inv, mu_0 = mu,
// mu_1 = -mu (tau3), x = H chi
__device__ __forceinline__ void store_nd_mee_inv(const float (&ar)[2][4][3],
                                                 const float (&ai)[2][4][3],
                                                 float* __restrict__ out, long long V, int site,
                                                 float mu, float eps, float inv) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const float gs = s < 2 ? 1.f : -1.f;
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const float cf = (f == 0 ? mu : -mu) * gs;  // exact
        const float xr = ar[f][s][c], xi = ai[f][s][c];
        // i cf x = (-cf xi, cf xr)
        const float tr = __fsub_rn(xr, __fmul_rn(-cf, xi));
        const float ti = __fsub_rn(xi, __fmul_rn(cf, xr));
        const long long o = (f * 12 + s * 3 + c) * V + site;
        out[o] = __fmul_rn(__fsub_rn(tr, __fmul_rn(eps, ar[1 - f][s][c])), inv);
        out[24 * V + o] = __fmul_rn(__fsub_rn(ti, __fmul_rn(eps, ai[1 - f][s][c])), inv);
      }
  }
}

// odd: m_g = ((y_g + i mu_g g5 y_g) + eps y_{1-g}) - k2 x_g with y = chi_o,
// x = H tmp; out_f = g5 m_{1-f}
__device__ __forceinline__ void store_nd_mhat(const float (&ar)[2][4][3],
                                              const float (&ai)[2][4][3],
                                              const float* __restrict__ chi_o,
                                              float* __restrict__ out, long long V, int site,
                                              float mu, float eps, float k2) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const float gs = s < 2 ? 1.f : -1.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const long long e = (s * 3 + c) * V + site;
      float yr[2], yi[2];
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        yr[g] = __ldg(chi_o + g * 12 * V + e);
        yi[g] = __ldg(chi_o + 24 * V + g * 12 * V + e);
      }
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const float cg = (g == 0 ? mu : -mu) * gs;
        const float m1r = __fadd_rn(yr[g], __fmul_rn(-cg, yi[g]));
        const float m1i = __fadd_rn(yi[g], __fmul_rn(cg, yr[g]));
        const float m2r = __fadd_rn(m1r, __fmul_rn(eps, yr[1 - g]));
        const float m2i = __fadd_rn(m1i, __fmul_rn(eps, yi[1 - g]));
        const float mr = __fsub_rn(m2r, __fmul_rn(k2, ar[g][s][c]));
        const float mi = __fsub_rn(m2i, __fmul_rn(k2, ai[g][s][c]));
        out[(1 - g) * 12 * V + e] = gs * mr;
        out[24 * V + (1 - g) * 12 * V + e] = gs * mi;
      }
    }
  }
}

// One phase of the twisted-mass K1-SD on every site of its parity, in a
// grid-stride loop
template <bool ODD, bool COMP>
__device__ __forceinline__ void schur_nd_phase(const NdPhase& f, const float* __restrict__ ug,
                                               const Geo& geo, int V, const Corr& corr) {
  for (int site = blockIdx.x * blockDim.x + threadIdx.x; site < V;
       site += gridDim.x * blockDim.x) {
    float ar[2][4][3], ai[2][4][3];
    accum_doublet<COMP>(f.chi, ug, geo, V, site, corr, ar, ai);
    if constexpr (ODD)
      store_nd_mhat(ar, ai, f.chi_o, f.out, V, site, f.c0, f.c1, f.c2);
    else
      store_nd_mee_inv(ar, ai, f.out, V, site, f.c0, f.c1, f.c2);
  }
}

// The twisted-mass K1-SD: a thread per site holding both flavours (48
// accumulators), registers capped at 128 so that 4 blocks of 128 share an
// SM and 16^3 x 32's 65,536 sites of a parity run in one pass of the
// resident grid (528 blocks).  Measured with chip_smoke.py on an NVIDIA
// H100 80GB HBM3 at 700.00 W (PERF.md section 6, run C), Q_nd^2 at 16^3 x
// 32: 112.8 us of device here against 148.9 us at 3 blocks (168 registers,
// 1.3 passes) and 135.5 us for a thread per (site, flavour).
template <bool COMP>
__global__ void __launch_bounds__(128, 4)
hopping_schur_nd_kernel(SchurNdArgs a) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int V = a.geo.T * a.geo.X * a.geo.M;
  for (int ph = 0; ph < a.nphase; ++ph) {
    if (ph > 0) grid.sync();
    const NdPhase f = ph == 0 ? a.ph[0] : ph == 1 ? a.ph[1] : ph == 2 ? a.ph[2] : a.ph[3];
    Geo geo = a.geo;
    geo.p = ph & 1;
    if (ph & 1)
      schur_nd_phase<true, COMP>(f, a.ug[1], geo, V, a.corr);
    else
      schur_nd_phase<false, COMP>(f, a.ug[0], geo, V, a.corr);
  }
}

// The clover K1-SD: a thread per (site, flavour), a block kNdPairSites sites
// (threadIdx.x) x 2 flavours (threadIdx.y).  Each thread sums H chi of its
// flavour (K1's accum_site on that flavour's field, so the sum is K1-R-D's),
// the two exchange their accumulators through shared memory, and each writes
// its output flavour.  The flavour-2x2 block epilogues need both flavours'
// accumulators and 3 block fields: in one thread they spilled 504 B a thread
// at 128 registers (Q_nd^2 363.2 us of device at 16^3 x 32) and took 380.5
// us at 168; split over two threads, 322.8 us (chip_smoke.py on an NVIDIA
// H100 80GB HBM3 at 700.00 W; PERF.md section 6, run C).
constexpr int kNdPairSites = 64;

// sum_{s', c'} blk[k] v[s'][c'] of chirality b, row (s, c): the block
// entries of this site streamed from device memory, used once
__device__ __forceinline__ void blk_row(const float* __restrict__ blk, long long V, int site,
                                        int b, int s, int c, const float (&vr)[4][3],
                                        const float (&vi)[4][3], float& sr, float& si) {
  sr = 0.f;
  si = 0.f;
#pragma unroll
  for (int sp = 0; sp < 2; ++sp)
#pragma unroll
    for (int cp = 0; cp < 3; ++cp) {
      const int k = ((b * 2 + s) * 2 + sp) * 9 + c * 3 + cp;
      const float br = __ldg(blk + k * V + site), bi = __ldg(blk + (72 + k) * V + site);
      sr += br * vr[2 * b + sp][cp] - bi * vi[2 * b + sp][cp];
      si += br * vi[2 * b + sp][cp] + bi * vr[2 * b + sp][cp];
    }
}

// the clover epilogues by output flavour fl: `own` this thread's
// accumulators (x_fl), `oth` the other flavour's (x_{1-fl}).  even: out_0 =
// A x_0 - eps E x_1, out_1 = B x_1 - eps E x_0 (FastCloverND's M_ee^-1 =
// [[A, -eps E], [-eps E, B]]); odd: out_fl = g5 m_{1-fl}, m_g = (moo_g y_g +
// eps y_{1-g}) - k2 x_g, y = chi_o
__device__ __forceinline__ void store_ndf_clov_inv(const float (&owr)[4][3],
                                                   const float (&owi)[4][3],
                                                   const float (&otr)[4][3],
                                                   const float (&oti)[4][3],
                                                   float* __restrict__ out, long long V,
                                                   int site, int fl, float eps,
                                                   const float* const (&blk)[3]) {
  const float* diag = fl == 0 ? blk[0] : blk[1];
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float dr, di, er, ei;
        blk_row(diag, V, site, b, s, c, owr, owi, dr, di);
        blk_row(blk[2], V, site, b, s, c, otr, oti, er, ei);
        const long long o = (fl * 12 + (2 * b + s) * 3 + c) * V + site;
        out[o] = dr - eps * er;
        out[24 * V + o] = di - eps * ei;
      }
}

__device__ __forceinline__ void store_ndf_clov_mhat(const float (&otr)[4][3],
                                                    const float (&oti)[4][3],
                                                    const float* __restrict__ chi_o,
                                                    float* __restrict__ out, long long V,
                                                    int site, int fl, float eps, float k2,
                                                    const float* const (&blk)[3]) {
  const int g = 1 - fl;
  const float* moo = g == 0 ? blk[0] : blk[1];
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    float ygr[4][3], ygi[4][3];
#pragma unroll
    for (int sp = 0; sp < 2; ++sp)
#pragma unroll
      for (int cp = 0; cp < 3; ++cp) {
        const long long e = (g * 12 + (2 * b + sp) * 3 + cp) * V + site;
        ygr[2 * b + sp][cp] = __ldg(chi_o + e);
        ygi[2 * b + sp][cp] = __ldg(chi_o + 24 * V + e);
      }
    const float g5 = b == 1 ? -1.f : 1.f;
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float ur, ui;
        blk_row(moo, V, site, b, s, c, ygr, ygi, ur, ui);
        const int r = 2 * b + s;
        const long long e = (fl * 12 + r * 3 + c) * V + site;
        const float yor = __ldg(chi_o + e), yoi = __ldg(chi_o + 24 * V + e);
        out[e] = g5 * ((ur + eps * yor) - k2 * otr[r][c]);
        out[24 * V + e] = g5 * ((ui + eps * yoi) - k2 * oti[r][c]);
      }
  }
}

template <bool ODD, bool COMP>
__device__ __forceinline__ void schur_nd_pair_phase(const NdPhase& f, const float* __restrict__ ug,
                                                    const Geo& geo, int V, const Corr& corr,
                                                    float* __restrict__ sx) {
  const int fl = threadIdx.y, lane = threadIdx.x;
  const long long VV = V;
  const Strides st{24 * VV, VV};
  const int ntiles = (V + kNdPairSites - 1) / kNdPairSites;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int site = tile * kNdPairSites + lane;
    const bool live = site < V;
    float owr[4][3], owi[4][3];
    if (live) {
      accum_site<COMP, float>(f.chi + fl * 12 * VV, ug, geo, VV, st, site, corr, owr, owi);
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          sx[((fl * 2) * 12 + s * 3 + c) * kNdPairSites + lane] = owr[s][c];
          sx[((fl * 2 + 1) * 12 + s * 3 + c) * kNdPairSites + lane] = owi[s][c];
        }
    }
    __syncthreads();
    if (live) {
      float otr[4][3], oti[4][3];
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          otr[s][c] = sx[(((1 - fl) * 2) * 12 + s * 3 + c) * kNdPairSites + lane];
          oti[s][c] = sx[(((1 - fl) * 2 + 1) * 12 + s * 3 + c) * kNdPairSites + lane];
        }
      if constexpr (ODD)
        store_ndf_clov_mhat(otr, oti, f.chi_o, f.out, VV, site, fl, f.c0, f.c1, f.blk);
      else
        store_ndf_clov_inv(owr, owi, otr, oti, f.out, VV, site, fl, f.c0, f.blk);
    }
    __syncthreads();
  }
}

template <bool COMP>
__global__ void __launch_bounds__(128)
hopping_schur_nd_pair_kernel(SchurNdArgs a) {
  __shared__ float sx[2 * 24 * kNdPairSites];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int V = a.geo.T * a.geo.X * a.geo.M;
  for (int ph = 0; ph < a.nphase; ++ph) {
    if (ph > 0) grid.sync();
    const NdPhase f = ph == 0 ? a.ph[0] : ph == 1 ? a.ph[1] : ph == 2 ? a.ph[2] : a.ph[3];
    Geo geo = a.geo;
    geo.p = ph & 1;
    if (ph & 1)
      schur_nd_pair_phase<true, COMP>(f, a.ug[1], geo, V, a.corr, sx);
    else
      schur_nd_pair_phase<false, COMP>(f, a.ug[0], geo, V, a.corr, sx);
  }
}

// K1-R: block (kRhsSites sites, up to kRhsCols right-hand sides); the
// thread of (site, r) runs K1's arithmetic on column r, whose fields start
// r * rstride elements into psi, psi_o and out.
constexpr int kRhsCols = 12;
constexpr int kRhsTin = 8;

constexpr long long kRhsSlabBytes = 4ll << 20;

// Timeslices that consecutive blocks of K1-R walk innermost.  In memory
// order a site's t-neighbours are one timeslice of the whole batch away,
// R * X * M * 96 bytes; once that outgrows a few MB the t-hops start to
// miss L2, and walking kRhsTin timeslices innermost keeps all but one in
// kRhsTin of them one block apart.  Timed with chip_smoke.py (R = 12,
// 12-real, mhat, links not yet staged; PERF.md section 6 names the card and
// its power limit): at 32^3 x 64, 19 MB per timeslice, this order was
// faster than memory order; 16^3 x 32, 2.4 MB per timeslice, lies below
// kRhsSlabBytes and keeps memory order.
// Needs whole m-tiles and whole t-chunks; 1 is memory order.
inline int rhs_t_inner(const Geo& g, int R) {
  const bool tiles = g.M % kRhsSites == 0 && g.T % kRhsTin == 0;
  return (tiles && (long long)R * g.X * g.M * 96 >= kRhsSlabBytes) ? kRhsTin : 1;
}

template <int EPI, bool G5, bool COMP, typename G>
__global__ void __launch_bounds__(kRhsSites * kRhsCols)
hopping_rhs_kernel(const float* __restrict__ psi, const G* __restrict__ ug,
                   const float* __restrict__ psi_o, const float* __restrict__ blocks,
                   float* __restrict__ out, Geo geo, int R, Strides st, long long rstride,
                   int tin, float mt, float inv, float k2, Corr corr) {
  __shared__ float sl[8 * 18 * kRhsSites];
  // the clover blocks of the block's sites, sb[(ri * 72 + k)][lane]
  __shared__ float sb[EPI >= 3 ? 144 * kRhsSites : 1];
  const long long V = (long long)geo.T * geo.X * geo.M;
  int site = blockIdx.x * blockDim.x + threadIdx.x;
  if (tin > 1) {
    // blocks walk tin timeslices innermost, then the m-tiles, x and the
    // t-chunks (see rhs_t_inner)
    const int mtiles = geo.M / kRhsSites;
    int b = blockIdx.x;
    const int t_in = b % tin;
    b /= tin;
    const int mtile = b % mtiles;
    b /= mtiles;
    const int x = b % geo.X;
    const int t = (b / geo.X) * tin + t_in;
    site = (t * geo.X + x) * geo.M + mtile * kRhsSites + threadIdx.x;
  }
  const int lane = threadIdx.x;
  // the rows of the block share out the 8 directions: each link of the
  // block's sites is read (upcast, and its row 2 rebuilt) once for all columns
  if (site < V) stage_links<COMP, G>(ug, V, site, corr, sl, lane);
  // left to L1, each of the R columns of a site would fetch the same 576 B
  // of blocks; the rows share out the 144 floats and stage them once
  if (EPI >= 3 && site < V)
    for (int k = threadIdx.y; k < 144; k += blockDim.y)
      sb[k * kRhsSites + lane] = __ldg(blocks + k * V + site);
  __syncthreads();
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (site >= V || r >= R) return;
  const long long off = r * rstride;
  const float* psi_r = psi + off;
  int nb[8];
  neighbours(geo, site, nb);
  float ar[4][3], ai[4][3];
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int c = 0; c < 3; ++c) { ar[s][c] = 0.f; ai[s][c] = 0.f; }
  hop_staged<0>(psi_r, st, nb[0], sl, lane, ar, ai);
  hop_staged<1>(psi_r, st, nb[1], sl, lane, ar, ai);
  hop_staged<2>(psi_r, st, nb[2], sl, lane, ar, ai);
  hop_staged<3>(psi_r, st, nb[3], sl, lane, ar, ai);
  hop_staged<4>(psi_r, st, nb[4], sl, lane, ar, ai);
  hop_staged<5>(psi_r, st, nb[5], sl, lane, ar, ai);
  hop_staged<6>(psi_r, st, nb[6], sl, lane, ar, ai);
  hop_staged<7>(psi_r, st, nb[7], sl, lane, ar, ai);
  if constexpr (EPI >= 3)
    store_clover<EPI, G5, false>(ar, ai, EPI == 4 ? psi_o + off : psi_o, out + off, st, site,
                                 inv, k2, sb, kRhsSites, lane);
  else
    store_epilogue<EPI, G5>(ar, ai, EPI == 2 ? psi_o + off : psi_o, out + off, st, site, mt,
                            inv, k2);
}

#if TM_PART == 0
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
#endif  // TM_PART == 0

constexpr int kBlock = 128;

// one launch of K1 (R == 0) or K1-R (R > 0)
struct Args {
  const float* psi;
  const void* ug;  // float, or __nv_bfloat16 (K1-B, K1-RB)
  const float* psi_o;
  const float* blocks;
  float* out;
  Geo geo;
  float mt, inv, k2;
  Corr corr;
  int R;
  Strides st;
  long long rstride;
  cudaStream_t stream;
  int* info;  // set: fill kernel_info instead of launching
};

// info[0..3] = resident blocks per SM (the occupancy API), registers per
// thread, local-memory bytes (spills, stack) per thread, threads per block
template <typename K>
void kernel_info(K kern, int block, int* info) {
  cudaFuncAttributes attr{};
  cudaFuncGetAttributes(&attr, (const void*)kern);
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, block, 0);
  info[0] = per_sm;
  info[1] = attr.numRegs;
  info[2] = (int)attr.localSizeBytes;
  info[3] = block;
}

// G: the gauge element type (float, or __nv_bfloat16 for K1-B and K1-RB).
template <int EPI, bool G5, bool COMP, typename G>
void launch(const Args& a) {
  const long long V = (long long)a.geo.T * a.geo.X * a.geo.M;
  if (a.info != nullptr) {
    if (a.R == 0)
      kernel_info(hopping_kernel<EPI, G5, COMP, G>, kBlock, a.info);
    else
      kernel_info(hopping_rhs_kernel<EPI, G5, COMP, G>,
                  kRhsSites * (a.R < kRhsCols ? a.R : kRhsCols), a.info);
    return;
  }
  if (a.R == 0) {
    const unsigned blocks = (unsigned)((V + kBlock - 1) / kBlock);
    hopping_kernel<EPI, G5, COMP, G><<<blocks, kBlock, 0, a.stream>>>(
        a.psi, static_cast<const G*>(a.ug), a.psi_o, a.blocks, a.out, a.geo, a.mt, a.inv,
        a.k2, a.corr);
  } else {
    const int cols = a.R < kRhsCols ? a.R : kRhsCols;
    const dim3 block(kRhsSites, cols);
    const dim3 grid((unsigned)((V + kRhsSites - 1) / kRhsSites),
                    (unsigned)((a.R + cols - 1) / cols));
    const int tin = rhs_t_inner(a.geo, a.R);
    hopping_rhs_kernel<EPI, G5, COMP, G><<<grid, block, 0, a.stream>>>(
        a.psi, static_cast<const G*>(a.ug), a.psi_o, a.blocks, a.out, a.geo, a.R, a.st,
        a.rstride, tin, a.mt, a.inv, a.k2, a.corr);
  }
}

template <bool COMP, typename G>
void dispatch_epi(int epi, int g5, const Args& a) {
  if (epi == 0) launch<0, false, COMP, G>(a);
  else if (epi == 1) launch<1, false, COMP, G>(a);
  else if (epi == 2 && g5) launch<2, true, COMP, G>(a);
  else if (epi == 2) launch<2, false, COMP, G>(a);
  else if (epi == 3) launch<3, false, COMP, G>(a);
  else if (g5) launch<4, true, COMP, G>(a);
  else launch<4, false, COMP, G>(a);
}

constexpr int kMaxDevices = 64;

// One cooperative launch of `kern` (argument struct `args`) over V sites,
// `sites_per_block` a block.  The grid is what the card holds resident of
// the kernel, blocks per SM (the occupancy API) x SMs, found once per device
// into `resident` and kept; a cooperative launch larger than that is
// refused (cudaErrorCooperativeLaunchTooLarge).  Fewer blocks when the
// sites need fewer: each barrier then waits on fewer blocks.
int launch_resident(const void* kern, void* args, long long V, dim3 block, int sites_per_block,
                    int (&resident)[kMaxDevices], cudaStream_t stream) {
  int dev = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc != 0) return rc;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int per_sm = 0, sms = 0;
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kern, (int)(block.x * block.y * block.z), 0);
    if (rc == 0) rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc != 0) return rc;
    if (per_sm * sms <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
    resident[dev] = per_sm * sms;
  }
  const long long need = (V + sites_per_block - 1) / sites_per_block;
  const unsigned grid = (unsigned)(need < resident[dev] ? need : resident[dev]);
  void* kargs[] = {args};
  rc = (int)cudaLaunchCooperativeKernel(kern, dim3(grid), block, kargs, 0, stream);
  return rc != 0 ? rc : (int)cudaGetLastError();
}

// One cooperative launch of K1-S's instance on `stream`, or (info set) its
// kernel_info (launch_resident, one site a thread).
template <bool CLOV, bool G5, bool COMP, typename G>
int launch_schur(const SchurArgs& a, cudaStream_t stream, int* info) {
  const auto kern = hopping_schur_kernel<CLOV, G5, COMP, G>;
  if (info != nullptr) {
    kernel_info(kern, kBlock, info);
    return 0;
  }
  static int resident[kMaxDevices];
  return launch_resident((const void*)kern, const_cast<SchurArgs*>(&a),
                         (long long)a.geo.T * a.geo.X * a.geo.M, dim3(kBlock), kBlock, resident,
                         stream);
}

template <typename G>
int dispatch_schur(const SchurArgs& a, int clover, int g5, int comp, cudaStream_t stream,
                   int* info) {
  if (clover && g5)
    return comp ? launch_schur<true, true, true, G>(a, stream, info)
                : launch_schur<true, true, false, G>(a, stream, info);
  if (clover)
    return comp ? launch_schur<true, false, true, G>(a, stream, info)
                : launch_schur<true, false, false, G>(a, stream, info);
  if (g5)
    return comp ? launch_schur<false, true, true, G>(a, stream, info)
                : launch_schur<false, true, false, G>(a, stream, info);
  return comp ? launch_schur<false, false, true, G>(a, stream, info)
              : launch_schur<false, false, false, G>(a, stream, info);
}

// One cooperative launch of K1-SD's instance, or (info set) its
// kernel_info (launch_resident).  CLOV: the clover kernel, a thread per
// (site, flavour); else a thread per site.
template <bool CLOV, bool COMP>
int launch_schur_nd(const SchurNdArgs& a, cudaStream_t stream, int* info) {
  const auto kern = CLOV ? hopping_schur_nd_pair_kernel<COMP> : hopping_schur_nd_kernel<COMP>;
  if (info != nullptr) {
    kernel_info(kern, kBlock, info);
    return 0;
  }
  static int resident[kMaxDevices];
  return launch_resident((const void*)kern, const_cast<SchurNdArgs*>(&a),
                         (long long)a.geo.T * a.geo.X * a.geo.M,
                         CLOV ? dim3(kNdPairSites, 2) : dim3(kBlock),
                         CLOV ? kNdPairSites : kBlock, resident, stream);
}

bool bad_geometry(int T, int X, int M, int zh, int p) {
  return T <= 0 || X <= 0 || M <= 0 || zh <= 0 || M % zh != 0 || (p != 0 && p != 1);
}

}  // namespace

// The instances are compiled in five parts, one nvcc process each, all
// started together (dslash_cuda._JOBS builds this file with -DTM_PART=0
// to 4): 0 K1 and K1-R on f32 links, K2 and the C entries; 1 K1 and K1-R on
// bf16 links (K1-B, K1-RB); 2 K1-S on f32 links; 3 K1-S on bf16 links; 4
// K1-SD.  The
// build then takes as long as its largest part, not as all of them.  The
// entries of part 0 reach the others through the tm_part_* functions, which
// take the argument struct by pointer (every part compiles the same
// definition of it).
extern "C" {
int tm_part_hopping_bf16(const void* args, int epi, int g5, int comp);
int tm_part_schur_f32(const void* args, int clover, int g5, int comp, void* stream, int* info);
int tm_part_schur_bf16(const void* args, int clover, int g5, int comp, void* stream, int* info);
int tm_part_schur_nd(const void* args, int clover, int comp, void* stream, int* info);
}

#if TM_PART == 1
int tm_part_hopping_bf16(const void* args, int epi, int g5, int comp) {
  const Args& a = *static_cast<const Args*>(args);
  if (comp) dispatch_epi<true, __nv_bfloat16>(epi, g5, a);
  else dispatch_epi<false, __nv_bfloat16>(epi, g5, a);
  return 0;
}
#endif

#if TM_PART == 2
int tm_part_schur_f32(const void* args, int clover, int g5, int comp, void* stream, int* info) {
  return dispatch_schur<float>(*static_cast<const SchurArgs*>(args), clover, g5, comp,
                               (cudaStream_t)stream, info);
}
#endif

#if TM_PART == 3
int tm_part_schur_bf16(const void* args, int clover, int g5, int comp, void* stream, int* info) {
  return dispatch_schur<__nv_bfloat16>(*static_cast<const SchurArgs*>(args), clover, g5, comp,
                                       (cudaStream_t)stream, info);
}
#endif

#if TM_PART == 4
int tm_part_schur_nd(const void* args, int clover, int comp, void* stream, int* info) {
  const SchurNdArgs& a = *static_cast<const SchurNdArgs*>(args);
  const cudaStream_t st = (cudaStream_t)stream;
  if (clover)
    return comp ? launch_schur_nd<true, true>(a, st, info) : launch_schur_nd<true, false>(a, st, info);
  return comp ? launch_schur_nd<false, true>(a, st, info) : launch_schur_nd<false, false>(a, st, info);
}
#endif

#if TM_PART == 0
namespace {

// validates the shared arguments, fills corr and launches; R == 0 is K1,
// gbf16 != 0 a bf16 gauge (K1-B, or K1-RB with R > 0)
int run_hopping(Args a, int epi, int g5, int comp, int gbf16, const float* corr16) {
  const bool needs_psi_o = epi == 2 || epi == 4;
  if (epi < 0 || epi > 4)
    return (int)cudaErrorInvalidValue;
  if (a.info == nullptr) {
    if ((needs_psi_o && a.psi_o == nullptr) || (epi >= 3 && a.blocks == nullptr) ||
        (comp && corr16 == nullptr))
      return (int)cudaErrorInvalidValue;
    for (int d = 0; d < 8; ++d) {
      a.corr.re[d] = comp ? corr16[2 * d] : 1.f;
      a.corr.im[d] = comp ? corr16[2 * d + 1] : 0.f;
    }
  }
  if (gbf16) {
    tm_part_hopping_bf16(&a, epi, g5, comp);
  } else {
    if (comp) dispatch_epi<true, float>(epi, g5, a);
    else dispatch_epi<false, float>(epi, g5, a);
  }
  return (int)cudaGetLastError();
}

// K1-S on the links' type: part 2 (f32) or part 3 (bf16)
int run_schur(const SchurArgs& a, int clover, int g5, int comp, int gbf16, void* stream,
              int* info) {
  return gbf16 ? tm_part_schur_bf16(&a, clover, g5, comp, stream, info)
               : tm_part_schur_f32(&a, clover, g5, comp, stream, info);
}

}  // namespace

extern "C" {

// K1.  epi: 0 none, 1 mee_inv, 2 mhat, 3 clov_inv, 4 clov_mhat (3 and 4
// read `blocks`, 2 and 4 read `psi_o`; for 3 `inv` is the scale factor).
// corr16: 8 (re, im) pairs on the host, read only when comp != 0.
// gbf16 != 0: `ug` holds __nv_bfloat16 elements (the sloppy copy, K1-B),
// else float.  Returns cudaGetLastError() after the launch (0 = success);
// an invalid argument returns cudaErrorInvalidValue.
int tm_hopping(const float* psi, const void* ug, const float* psi_o, const float* blocks,
               float* out, int T, int X, int M, int zh, int p, int epi, int g5, int comp,
               int gbf16, float mt, float inv, float k2, const float* corr16, void* stream) {
  if (bad_geometry(T, X, M, zh, p)) return (int)cudaErrorInvalidValue;
  const long long V = (long long)T * X * M;
  const Args a{psi, ug, psi_o, blocks, out, Geo{T, X, M, zh, p}, mt, inv, k2, Corr{}, 0,
               Strides{12 * V, V}, 0, (cudaStream_t)stream, nullptr};
  return run_hopping(a, epi, g5, comp, gbf16, corr16);
}

// The K1 instance of (epi, g5, comp, gbf16): info[0..3] as kernel_info
// (blocks per SM from cudaOccupancyMaxActiveBlocksPerMultiprocessor,
// registers, spill bytes, threads per block).  Launches nothing.
int tm_hopping_info(int epi, int g5, int comp, int gbf16, int* info) {
  if (info == nullptr) return (int)cudaErrorInvalidValue;
  Args a{};
  a.geo = Geo{1, 1, 1, 1, 0};
  a.info = info;
  const int rc = run_hopping(a, epi, g5, comp, gbf16, nullptr);
  return rc != 0 ? rc : (int)cudaGetLastError();
}

// The K1-R instance of (epi, g5, comp, gbf16) at R right-hand sides (the
// block is 32 sites x min(R, 12) columns): info[0..3] as kernel_info.
// Launches nothing.
int tm_hopping_rhs_info(int epi, int g5, int comp, int gbf16, int R, int* info) {
  if (info == nullptr || R <= 0) return (int)cudaErrorInvalidValue;
  Args a{};
  a.geo = Geo{1, 1, 1, 1, 0};
  a.R = R;
  a.info = info;
  const int rc = run_hopping(a, epi, g5, comp, gbf16, nullptr);
  return rc != 0 ? rc : (int)cudaGetLastError();
}

// K1-S: nstage Schur applications in one cooperative launch, each the
// even hop with the even epilogue and then the odd hop with the odd one:
//   clover 0: mee_inv then mhat (Mhat(sign), [g5]);
//   clover 1: clov_inv then clov_mhat (blocks: M_ee^-1, then M_oo).
// nstage 1 (Mhat, Qhat): psi -> e1 -> out.  nstage 2 (Qhat_pm): psi -> e1 ->
// o1 -> e2 -> out, the second stage's odd input o1.  Every intermediate has
// a buffer of its own (the wrapper's scratch), and no phase writes a field
// that an earlier phase read.  blk0..blk3: the blocks of phases 0..3
// (clover only).  consts: (mt, inv, k2) of phases 0..3 as tm_hopping takes
// them (`inv` the scale of clov_inv).  g5 applies to the odd phases.  The
// links: ug_e for the even phases, ug_o for the odd, bf16 with gbf16 != 0.
// Returns the launch's error (0 = success); an invalid argument returns
// cudaErrorInvalidValue.
int tm_hopping_schur(const float* psi, const void* ug_e, const void* ug_o, const float* blk0,
                     const float* blk1, const float* blk2, const float* blk3, float* e1,
                     float* o1, float* e2, float* out, int T, int X, int M, int zh, int nstage,
                     int clover, int g5, int comp, int gbf16, const float* consts,
                     const float* corr16, void* stream) {
  const bool two = nstage == 2;
  if (bad_geometry(T, X, M, zh, 0) || (nstage != 1 && !two) || psi == nullptr ||
      ug_e == nullptr || ug_o == nullptr || e1 == nullptr || out == nullptr ||
      consts == nullptr || (comp && corr16 == nullptr) ||
      (two && (o1 == nullptr || e2 == nullptr)) ||
      (clover && (blk0 == nullptr || blk1 == nullptr ||
                  (two && (blk2 == nullptr || blk3 == nullptr)))))
    return (int)cudaErrorInvalidValue;
  SchurArgs a{};
  a.ug[0] = ug_e;
  a.ug[1] = ug_o;
  a.geo = Geo{T, X, M, zh, 0};
  for (int d = 0; d < 8; ++d) {
    a.corr.re[d] = comp ? corr16[2 * d] : 1.f;
    a.corr.im[d] = comp ? corr16[2 * d + 1] : 0.f;
  }
  a.nphase = 2 * nstage;
  const float* c = consts;
  a.ph[0] = Phase{psi, nullptr, blk0, e1, c[0], c[1], c[2]};
  a.ph[1] = Phase{e1, psi, blk1, two ? o1 : out, c[3], c[4], c[5]};
  if (two) {
    a.ph[2] = Phase{o1, nullptr, blk2, e2, c[6], c[7], c[8]};
    a.ph[3] = Phase{e2, o1, blk3, out, c[9], c[10], c[11]};
  }
  return run_schur(a, clover, g5, comp, gbf16, stream, nullptr);
}

// K1-S's instance of (clover, g5, comp, gbf16): info[0..3] as kernel_info.
// Launches nothing.
int tm_hopping_schur_info(int clover, int g5, int comp, int gbf16, int* info) {
  if (info == nullptr) return (int)cudaErrorInvalidValue;
  const SchurArgs a{};
  const int rc = run_schur(a, clover, g5, comp, gbf16, nullptr, info);
  return rc != 0 ? rc : (int)cudaGetLastError();
}

// K1-SD: nstage (1: Q_nd, 2: Q_nd^2) doublet Schur applications in one
// cooperative launch on f32 links, each the even hop of both flavours with
// the even epilogue and then the odd hop with the odd one: clover 0
// (twisted mass) Mee_nd^-1, then gamma5 tau1 (Mee_nd chi_o - k2 H); clover
// 1 the flavour-2x2 block forms.  nstage 1: chi -> e1 -> out; nstage 2: chi
// -> e1 -> o1 -> e2 -> out, the second stage's odd input o1; every
// intermediate a buffer of its own.  Both stages of Q_nd^2 are the same
// Q_nd: blk holds 5 pointers (clover: even minv_a, minv_b, minv_e, then odd
// moo_u, moo_d), each a [2][72][V] block field, and consts the (c0, c1, c2)
// of the even and then the odd phase (NdPhase).
// Returns the launch's error (0 = success); an invalid argument returns
// cudaErrorInvalidValue.
int tm_hopping_schur_nd(const float* chi, const void* ug_e, const void* ug_o,
                        const float* const* blk, float* e1, float* o1, float* e2, float* out,
                        int T, int X, int M, int zh, int nstage, int clover, int comp,
                        const float* consts, const float* corr16, void* stream) {
  const bool two = nstage == 2;
  if (bad_geometry(T, X, M, zh, 0) || (nstage != 1 && !two) || chi == nullptr ||
      ug_e == nullptr || ug_o == nullptr || e1 == nullptr || out == nullptr ||
      consts == nullptr || blk == nullptr || (comp && corr16 == nullptr) ||
      (two && (o1 == nullptr || e2 == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (clover)
    for (int k = 0; k < 5; ++k)
      if (blk[k] == nullptr) return (int)cudaErrorInvalidValue;
  SchurNdArgs a{};
  a.ug[0] = static_cast<const float*>(ug_e);
  a.ug[1] = static_cast<const float*>(ug_o);
  a.geo = Geo{T, X, M, zh, 0};
  for (int d = 0; d < 8; ++d) {
    a.corr.re[d] = comp ? corr16[2 * d] : 1.f;
    a.corr.im[d] = comp ? corr16[2 * d + 1] : 0.f;
  }
  a.nphase = 2 * nstage;
  const float* ins[4] = {chi, e1, o1, e2};
  const float* odd_in[4] = {nullptr, chi, nullptr, o1};
  float* outs[4] = {e1, two ? o1 : out, e2, out};
  for (int ph = 0; ph < a.nphase; ++ph) {
    // every Q_nd of Q_nd^2 reads the same constants and block fields
    const int odd = ph & 1;
    NdPhase& f = a.ph[ph];
    f.chi = ins[ph];
    f.chi_o = odd_in[ph];
    for (int k = 0; k < 3; ++k) f.blk[k] = odd ? (k < 2 ? blk[3 + k] : nullptr) : blk[k];
    f.out = outs[ph];
    f.c0 = consts[3 * odd];
    f.c1 = consts[3 * odd + 1];
    f.c2 = consts[3 * odd + 2];
  }
  return tm_part_schur_nd(&a, clover, comp, stream, nullptr);
}

// K1-SD's instance of (clover, comp): info[0..3] as kernel_info.  Launches
// nothing.
int tm_hopping_schur_nd_info(int clover, int comp, int* info) {
  if (info == nullptr) return (int)cudaErrorInvalidValue;
  const SchurNdArgs a{};
  const int rc = tm_part_schur_nd(&a, clover, comp, nullptr, info);
  return rc != 0 ? rc : (int)cudaGetLastError();
}

// K1-R: R right-hand sides on one read of the gauge.  psi, psi_o and out
// are addressed as base + r * r_stride + im_stride * (0|1) + (3 s + c) *
// comp_stride + site (element strides); `blocks` has no R axis; the other
// arguments are K1's (gbf16 != 0: a bf16 gauge, K1-RB).
int tm_hopping_rhs(const float* psi, const void* ug, const float* psi_o, const float* blocks,
                   float* out, int T, int X, int M, int zh, int p, int epi, int g5, int comp,
                   int gbf16, float mt, float inv, float k2, const float* corr16, int R,
                   long long im_stride, long long comp_stride, long long r_stride,
                   void* stream) {
  if (bad_geometry(T, X, M, zh, p) || R <= 0 || im_stride <= 0 || comp_stride <= 0 ||
      r_stride <= 0)
    return (int)cudaErrorInvalidValue;
  const Args a{psi, ug, psi_o, blocks, out, Geo{T, X, M, zh, p}, mt, inv, k2, Corr{}, R,
               Strides{im_stride, comp_stride}, r_stride, (cudaStream_t)stream, nullptr};
  return run_hopping(a, epi, g5, comp, gbf16, corr16);
}

// K2.  Returns cudaGetLastError() after the launch.
int tm_hopping_ug_vjp(const float* g, const float* psi, float* out, int T, int X, int M, int zh,
                      int p, void* stream) {
  if (bad_geometry(T, X, M, zh, p)) return (int)cudaErrorInvalidValue;
  const Geo geo{T, X, M, zh, p};
  const long long V = (long long)T * X * M;
  const unsigned blocks = (unsigned)((V + kBlock - 1) / kBlock);
  ug_vjp_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(g, psi, out, geo);
  return (int)cudaGetLastError();
}

}  // extern "C"
#endif  // TM_PART == 0
