// Tile kernels of K1 merged_vel and K2 merged_stress for the merged layout
// with one element per lane, of K8 fused_vel2 and K9 fused_stress2, K1's
// and K2's V2 instantiations on the v2 engine's exchanged traces, and of
// K1pk, K2pk, K8pk and K9pk, K1, K2, K8 and K9 on the packed P1 layout
// (NPAR = 2: two elements a lane, a block owns one parity), K11 being K8pk
// on the P1 pack probe's geo (merged_kernels.cu dispatches them; its head
// note gives the design and the reasons).  A block owns T
// consecutive lanes of one class (V2: of the one class of all Ls lanes)
// and stages them in shared memory; a thread then owns RM nodes of one
// lane in the node-by-lane products.  The velocity core (vel_core) also
// serves K4 lane_vel and the stress core (stress_core) K5 lane_stress
// (lane_kernels.cu), which stage their tiles from the lane layout
// themselves (LANE).
//
// Everything per lane that is indexed at run time (face data, neighbour
// links, Hooke coefficients) lives in shared memory; register arrays are
// indexed only under full unrolling, so the kernels keep no local memory.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "merged_common.cuh"

namespace seigen {
namespace tile {

// Shape of the tiles of one element type and operator.
//   RM   nodes per thread, RM floats of a table row per product step: 2 for
//        the tetrahedra of P2 and up (at 3D P3 four nodes a thread took 72
//        registers in K2, half the warps, and ran slower), 4 for the
//        smaller elements (two nodes a thread made ptxas spill in K2 at
//        3D P1 and 2D P1 and P4)
//   NPI  node count padded to 4: the table's row length (KernelTables.tile)
//   NG   node groups = threads per lane
//   T    lanes per tile: 32 when NG >= 4, else 64 or 128, so that a block
//        has at least four warps
//   KV   volume rows of the product table, KA all its rows
//   WS   K1: shared-memory rows of a node, sigma's NSIG then w_rc's DIM^2
// Shared memory, in floats:
//   A    KA x NPI     the table (KernelTables.tile): row j*DIM + r holds
//                     Dr_r[i][j], row KV + q holds LIFT[i][q]
//   IN   K1: NP x WS x T, sigma at rows j*WS + m, then w_rc at j*WS +
//        r*DIM + c in place; K2: DIM x NP x T, u at rows c*NP + j
//   NB   NBC x NFT x T the neighbour's trace at rows c*NFT + q, then the
//        flux (K1) or the velocity jump (K2) in place at rows c*NFT + q, c <
//        DIM; V2: the lane's own rows c*rtf + q of the exchanged traces;
//        SIGTR (K4 SIG): the neighbour's sigma traces at rows m*NFT + q, m
//        < NSIG (NBC = NSIG, else DIM)
//   F    K2 ANISO: NF x NSIG x DIM x T, F_kc of face f at (f*NSIG + k)*DIM
//        + c (the isotropic law forms it from lambda, mu and n in
//        registers)
//   GEO  GR x T       geo rows (G_* below)
//   ints NFT face nodes
// The output tile (COUT x NP x T, rows c*NP + i) takes the place of IN
// (and NB) once the products have read them.
// V2: the exchanged traces already hold the own value on boundary faces,
// so there is no mask; the output's traces are emitted component-major.
// NPAR = 2 (K1pk, K2pk on the merged rows, K8pk, K9pk and K11 on V2's;
// isotropic): the block's parity par reads its element's rows as the
// packed layout places them (state rows c*npp + par*4 + i, ginv and
// material rows interleaved over the parities, 1/rho at o_mat +
// par*irho_par — 1 in FusedOpData, 4 in the pack probe's geo —, face rows
// par*4 + f; V2 trace rows c*rtf + par*NFT + q) and emits its traces into
// its parity's rows; the shared-memory tile is the unpacked one.
// LANE (K4 and K5, on V2's rows): geo rows G_SCB and G_BFS hold Fscale and
// beta (K4) or delta (K5) (the lane layout's rows), from which the flux
// takes scb = Fscale/2 and bfs = beta*Fscale, the jump scb = Fscale/2 and
// dfs = delta*Fscale; K4 TRAC and SEL (SIGN) hold the sign of each face's
// neighbour traction in the mask's place (1 outside SEL).
template <int DIM_, int NP_, int NFP_, bool VEL_, bool ANISO_, bool V2_,
          int NPAR_ = 1, bool LANE_ = false, bool SIGTR_ = false>
struct Layout {
  static constexpr int DIM = DIM_, NP = NP_, NFP = NFP_;
  static constexpr bool VEL = VEL_, ANISO = ANISO_, V2 = V2_;
  static constexpr int NPAR = NPAR_;
  static constexpr bool LANE = LANE_, SIGTR = SIGTR_;
  static constexpr bool SIGN = LANE && VEL && !SIGTR;
  static_assert(NPAR == 1 || (NPAR == 2 && !ANISO && !LANE),
                "the packed tiles are isotropic, on merged or V2 rows");
  static_assert(!LANE || V2, "the lane tiles are on V2's rows");
  static_assert(!SIGTR || (LANE && VEL), "sigma traces are K4's");
  using S = Shape<DIM, NP, NFP>;
  static constexpr int NF = S::NF, NFT = S::NFT, NSIG = S::NSIG;
  static constexpr int RM = DIM == 3 && NP >= 10 ? 2 : 4;
  static constexpr int NPI = (NP + 3) / 4 * 4;
  static constexpr int NG = NPI / RM;
  static constexpr int T = NG >= 4 ? 32 : (NG >= 2 ? 64 : 128);
  static constexpr int THREADS = NG * T;
  static constexpr int KV = DIM * NP;
  static constexpr int KA = KV + NFT;
  static constexpr int WS = DIM * DIM;
  static constexpr int CIN = VEL ? NSIG : DIM;
  static constexpr int COUT = VEL ? DIM : NSIG;
  static constexpr int NBC = SIGTR ? NSIG : DIM;
  // geo rows: Ginv r*DIM + d; normals d*NF + f; scb f; bfs (K1) or dfs
  // (K2) f; the own-trace mask f (not V2) or the sign f (SIGN); material:
  // 1/rho (K1), lambda and mu (K2), or C[k][m] at k*NSIG + m (K2 ANISO)
  static constexpr int G_GINV = 0;
  static constexpr int G_NRM = DIM * DIM;
  static constexpr int G_SCB = G_NRM + DIM * NF;
  static constexpr int G_BFS = G_SCB + NF;
  static constexpr int G_MASK = G_BFS + NF;
  static constexpr int G_MAT = G_MASK + (V2 && !SIGN ? 0 : NF);
  static constexpr int N_MAT = VEL ? 1 : (ANISO ? NSIG * NSIG : 2);
  static constexpr int GR = G_MAT + N_MAT;
  static constexpr int OFF_A = 0;
  static constexpr int OFF_IN = OFF_A + KA * NPI;
  static constexpr int OFF_NB = OFF_IN + (VEL ? NP * WS : DIM * NP) * T;
  static constexpr int OFF_F = OFF_NB + NBC * NFT * T;
  static constexpr int OFF_GEO =
      OFF_F + (!VEL && ANISO ? NF * NSIG * DIM * T : 0);
  static constexpr int OFF_INT = OFF_GEO + GR * T;
  static constexpr int BYTES = 4 * (OFF_INT + NFT);
  static_assert(OFF_IN % 4 == 0 && T % 4 == 0, "16-byte rows");
  static_assert(COUT * NP * T <= (VEL ? OFF_NB : OFF_F) - OFF_IN,
                "the output tile fits the input rows");
  static_assert(BYTES <= 227 * 1024, "shared memory of one block");
};

// The RM table entries of a thread's nodes in a row of the table in shared
// memory, one 8- or 16-byte load (a broadcast: a warp shares its nodes).
template <int RM>
struct TabRow;
template <>
struct TabRow<2> {
  float2 v;
  __device__ __forceinline__ explicit TabRow(const float* p)
      : v(*reinterpret_cast<const float2*>(p)) {}
  __device__ __forceinline__ float operator[](int i) const {
    return i == 0 ? v.x : v.y;
  }
};
template <>
struct TabRow<4> {
  float4 v;
  __device__ __forceinline__ explicit TabRow(const float* p)
      : v(*reinterpret_cast<const float4*>(p)) {}
  __device__ __forceinline__ float operator[](int i) const {
    return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
  }
};

// Asynchronous global -> shared copies of 4 and 16 bytes (cp.async).
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
#endif
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
#endif
}

__device__ __forceinline__ void cp_async_wait_all() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
#endif
}

// The block's tile: class t, first lane j0 of the class, nvalid live lanes
// (the last tile of a range is ragged); the thread's lane l and node group
// ig (threadIdx.x = ig*T + l).  Packed (NPAR = 2): blockIdx = (tile,
// packed class u, parity par), and the class is the original t = 2u + par.
// The tiles of a launch cover the lanes [j_lo, j_hi) of every class, or
// with inv the lanes [0, j_lo) and then [j_hi, NC): the interior and the
// boundary launches of a slab's overlap schedule (one launch: 0, NC, 0).
struct Tile {
  int t, j0, nvalid, l, ig;
  int par;           // the element's parity (0 unpacked)
  long long lane0;   // u*NC + j0 (unpacked u = t)
  long long tlane0;  // its trace lane u*NCt + h0 + j0 (merged layout)
  bool live;         // l < nvalid
};

// Tiles of T lanes a class that a launch over a.j_lo, a.j_hi, a.inv takes.
template <int T, class Args>
__host__ __device__ __forceinline__ unsigned range_tiles(const Args& a) {
  return a.inv ? (unsigned)((a.j_lo + T - 1) / T + (a.NC - a.j_hi + T - 1) / T)
               : (unsigned)((a.j_hi - a.j_lo + T - 1) / T);
}

template <class LY, class Args>
__device__ __forceinline__ Tile make_tile(const Args& a) {
  Tile tl;
  tl.par = LY::NPAR == 1 ? 0 : (int)blockIdx.z;
  tl.t = (int)blockIdx.y * LY::NPAR + tl.par;
  const int nl = (a.j_lo + LY::T - 1) / LY::T, b = (int)blockIdx.x;
  int end = a.j_hi;
  if (!a.inv) {
    tl.j0 = a.j_lo + b * LY::T;
  } else if (b < nl) {
    tl.j0 = b * LY::T, end = a.j_lo;
  } else {
    tl.j0 = a.j_hi + (b - nl) * LY::T, end = a.NC;
  }
  tl.nvalid = min(LY::T, end - tl.j0);
  tl.l = (int)threadIdx.x % LY::T;
  tl.ig = (int)threadIdx.x / LY::T;
  // the class index as an int, sign-extended: a zero-extended blockIdx.y
  // moves the registers of K1/K2/K9 at several shapes
  const int u = LY::NPAR == 1 ? tl.t : (int)blockIdx.y;
  tl.lane0 = (long long)u * a.NC + tl.j0;
  tl.tlane0 = (long long)u * a.NCt + a.h0 + tl.j0;
  tl.live = tl.l < tl.nvalid;
  return tl;
}

// Global row (at lane 0) of local geo row r for the element of parity par
// (packed: ginv rows o_ginv + 2*(r*dim + d) + par, face rows par*4 + f,
// 1/rho at o_mat + par*irho_par, lambda and mu at o_mat + 2*j + par).
template <class LY, class Args>
__device__ __forceinline__ const float* geo_row(const Args& a, int r,
                                                int par) {
  constexpr int P = LY::NPAR;
  const int h = 4 * par;  // the parity's first row of a face section
  int row;
  if (r < LY::G_NRM) {
    row = a.o_ginv + P * r + par;
  } else if (r < LY::G_SCB) {
    const int q = r - LY::G_NRM;
    row = a.o_nrm + 8 * (q / LY::NF) + h + q % LY::NF;
  } else if (r < LY::G_BFS) {
    row = a.o_scb + h + (r - LY::G_SCB);
  } else if (r < LY::G_MASK) {
    row = (LY::VEL ? a.o_bfs : a.o_dfs) + h + (r - LY::G_BFS);
  } else if (r < LY::G_MAT) {
    return a.mask + (long long)(h + r - LY::G_MASK) * a.Ls;
  } else {
    const int q = r - LY::G_MAT;
    if constexpr (LY::VEL && P == 2)
      row = a.o_mat + par * a.irho_par;
    else
      row = LY::VEL ? a.o_mat
            : LY::ANISO ? a.o_C + 8 * (q / LY::NSIG) + q % LY::NSIG
                        : a.o_mat + P * (1 + q) + par;
  }
  return a.geo + (long long)row * a.Ls;
}

// Local row r < CIN*NP of the input field (global row c*npp + h + j, h the
// parity's first row of a node block): its shared-memory row and its
// global row at lane 0.
template <class LY>
__device__ __forceinline__ int in_row(int r) {
  return LY::VEL ? (r % LY::NP) * LY::WS + r / LY::NP : r;
}
template <class LY, class Args>
__device__ __forceinline__ const float* in_src(const Args& a, int r, int h) {
  return a.field + ((long long)(r / LY::NP) * a.npp + h + r % LY::NP) * a.Ls;
}

// Stage the tile in shared memory by cp.async: the table (16 bytes a
// copy); the input field's live rows and the geo rows (16 bytes a copy
// when the tile is whole and its rows are 16-byte aligned, else 4 bytes,
// lanes past nvalid loading the last live lane); and the neighbour's trace
// rows f2*rtf + c*NFP + pi[k] at trace lanes t2*NCt + h0 + j0 + s + l,
// clamped into the trace lanes of the class t2, its halo included (16
// bytes a copy where the face's shift s keeps the segment aligned and
// inside them, else 4 bytes; packed: the parity block t2 % 2 of the
// producer face at lanes (t2 / 2)*NCt + ...),
// or with V2 the lane's own rows c*rtf + q of the exchanged traces (as the
// input; packed: the parity's rows c*rtf + par*NFT + q).
// Consecutive threads copy consecutive lanes.
template <class LY, class Args>
__device__ __forceinline__ void stage(const Args& a, const Tile& tl,
                                      float* sm) {
  constexpr int T = LY::T, NG = LY::NG, NFP = LY::NFP, NFT = LY::NFT;
  constexpr int NIN = LY::CIN * LY::NP, Q = T / 4;
  const int h = 4 * tl.par;
  int* s_fn = reinterpret_cast<int*>(sm + LY::OFF_INT);
  for (int e = threadIdx.x; e < NFT; e += LY::THREADS) s_fn[e] = a.fnodes[e];
  for (int e = threadIdx.x; e < LY::KA * LY::NPI / 4; e += LY::THREADS)
    cp_async16(sm + LY::OFF_A + 4 * e, a.tab + 4 * e);
  const long long Ls = a.Ls;
  const bool vec =
      tl.nvalid == T && ((Ls | a.NC | tl.j0) & 3) == 0 &&
      (((uintptr_t)a.field | (uintptr_t)a.geo | (uintptr_t)a.mask) & 15) ==
          0;
  if (vec) {
    for (int e = threadIdx.x; e < (NIN + LY::GR) * Q; e += LY::THREADS) {
      const int r = e / Q, l4 = (e % Q) * 4;
      if (r < NIN)
        cp_async16(sm + LY::OFF_IN + in_row<LY>(r) * T + l4,
                   in_src<LY>(a, r, h) + tl.lane0 + l4);
      else
        cp_async16(sm + LY::OFF_GEO + (r - NIN) * T + l4,
                   geo_row<LY>(a, r - NIN, tl.par) + tl.lane0 + l4);
    }
  } else {
    const long long own = tl.lane0 + min(tl.l, tl.nvalid - 1);
    for (int r = tl.ig; r < NIN; r += NG)
      cp_async4(sm + LY::OFF_IN + in_row<LY>(r) * T + tl.l,
                in_src<LY>(a, r, h) + own);
    for (int r = tl.ig; r < LY::GR; r += NG)
      cp_async4(sm + LY::OFF_GEO + r * T + tl.l,
                geo_row<LY>(a, r, tl.par) + own);
  }
  const bool vec_tr = vec && ((uintptr_t)a.trs & 15) == 0 &&
                      ((a.Lt | a.NCt | a.h0) & 3) == 0;
  if constexpr (LY::V2) {
    float* dst = sm + LY::OFF_NB;
    const int hq = LY::NPAR == 1 ? 0 : tl.par * NFT;
    auto src = [&](int r) {  // row r = c*NFT + q
      return a.trs + ((long long)(r / NFT) * a.rtf + hq + r % NFT) * Ls;
    };
    if (vec_tr) {
      for (int e = threadIdx.x; e < LY::DIM * NFT * Q; e += LY::THREADS) {
        const int r = e / Q, l4 = (e % Q) * 4;
        cp_async16(dst + r * T + l4, src(r) + tl.lane0 + l4);
      }
    } else {
      const long long own = tl.lane0 + min(tl.l, tl.nvalid - 1);
      for (int r = tl.ig; r < LY::DIM * NFT; r += NG)
        cp_async4(dst + r * T + tl.l, src(r) + own);
    }
  } else {
#pragma unroll
    for (int f = 0; f < LY::NF; ++f) {
      const int* pe = a.plan + (tl.t * LY::NF + f) * (3 + NFP);
      const int s = pe[2];
      const long long Lt = a.Lt;
      const float* base =
          a.trs + ((long long)pe[1] * a.rtf + (pe[0] % LY::NPAR) * a.rtq) * Lt +
          (long long)(pe[0] / LY::NPAR) * a.NCt + a.h0;
      float* dst = sm + LY::OFF_NB + f * NFP * T;
      const int jlo = -a.h0, jhi = a.NCt - a.h0;  // the class's trace lanes
      if (vec_tr && (s & 3) == 0 && tl.j0 + s >= jlo &&
          tl.j0 + s + T <= jhi) {
        // the whole segment lies in the class, 16-byte aligned
        for (int e = threadIdx.x; e < LY::DIM * NFP * Q; e += LY::THREADS) {
          const int r = e / Q, l4 = (e % Q) * 4, c = r / NFP, k = r % NFP;
          cp_async16(dst + (c * NFT + k) * T + l4,
                     base + (long long)(c * NFP + pe[3 + k]) * Lt + tl.j0 +
                         s + l4);
        }
      } else {
        int jn = tl.j0 + tl.l + s;
        jn = jn < jlo ? jlo : (jn >= jhi ? jhi - 1 : jn);
        for (int r = tl.ig; r < LY::DIM * NFP; r += NG) {
          const int c = r / NFP, k = r % NFP;
          cp_async4(dst + (c * NFT + k) * T + tl.l,
                    base + (long long)(c * NFP + pe[3 + k]) * Lt + jn);
        }
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();
}

// The epilogue on the operator values v[c][ii] of this thread's nodes i0 +
// ii < NP of lane l (global rows c*npp + h + i0 + ii, h the parity's first
// row): axpy (and damping), dense injection; the results replace v and are
// stored to out.  The read-only operands are loaded component by
// component through the non-coherent path, so that the loads of one
// component need not wait for the stores of the previous one.
template <class LY, class Args>
__device__ __forceinline__ void finish_nodes(const Args& a, const Tile& tl,
                                             int i0,
                                             float (&v)[LY::COUT][LY::RM],
                                             bool damp) {
  constexpr int RM = LY::RM, NP = LY::NP;
  if (!tl.live) return;
  const long long Ls = a.Ls, L = tl.lane0 + tl.l;
  const int npp = a.npp, h = 4 * tl.par;
  float dm[RM];
#pragma unroll
  for (int ii = 0; ii < RM; ++ii)
    dm[ii] = damp && a.axpy && a.damp != nullptr && i0 + ii < NP
                 ? __ldg(a.damp + (size_t)(h + i0 + ii) * Ls + L)
                 : 1.f;
#pragma unroll
  for (int c = 0; c < LY::COUT; ++c) {
    float x0[RM], x1[RM], s0[RM], s1[RM];
#pragma unroll
    for (int ii = 0; ii < RM; ++ii) {
      const size_t idx = ((size_t)c * npp + h + i0 + ii) * Ls + L;
      const bool in = i0 + ii < NP;
      x0[ii] = in && a.axpy ? __ldg(a.ax0 + idx) : 0.f;
      x1[ii] = in && a.axpy ? __ldg(a.ax1 + idx) : 0.f;
      s0[ii] = in && a.n_inj > 0 ? __ldg(a.inj0 + idx) : 0.f;
      s1[ii] = in && a.n_inj > 1 ? __ldg(a.inj1 + idx) : 0.f;
    }
#pragma unroll
    for (int ii = 0; ii < RM; ++ii) {
      if (i0 + ii >= NP) continue;
      float r = v[c][ii];
      if (a.axpy) r = (x0[ii] + a.dt * x1[ii] + a.c3 * r) * dm[ii];
      if (a.n_inj > 0) r += a.r0 * s0[ii];
      if (a.n_inj > 1) r += a.r1 * s1[ii];
      v[c][ii] = r;
      a.out[((size_t)c * npp + h + i0 + ii) * Ls + L] = r;
    }
  }
}

// The output tile: this thread's final values to rows c*NP + i of s_out,
// and the pad rows NP..npp/NPAR-1 of out (after the parity's first row h;
// the epilogue of an operator value 0).
template <class LY, class Args>
__device__ __forceinline__ void store_tile(const Args& a, const Tile& tl,
                                           int i0,
                                           const float (&v)[LY::COUT][LY::RM],
                                           float* s_out, bool damp) {
  constexpr int NP = LY::NP, T = LY::T;
#pragma unroll
  for (int ii = 0; ii < LY::RM; ++ii)
    if (i0 + ii < NP)
#pragma unroll
      for (int c = 0; c < LY::COUT; ++c)
        s_out[(c * NP + i0 + ii) * T + tl.l] = v[c][ii];
  if (!tl.live) return;
  const long long Ls = a.Ls, L = tl.lane0 + tl.l;
  const int npp = a.npp, pad = npp / LY::NPAR - NP;
  for (int r = tl.ig; r < LY::COUT * pad; r += LY::NG) {
    const int i = 4 * tl.par + NP + r % pad;
    const size_t idx = ((size_t)(r / pad) * npp + i) * Ls + L;
    float x = 0.f;
    if (a.axpy) {
      x = a.ax0[idx] + a.dt * a.ax1[idx];
      if (damp && a.damp != nullptr) x *= a.damp[(size_t)i * Ls + L];
    }
    if (a.n_inj > 0) x += a.r0 * a.inj0[idx];
    if (a.n_inj > 1) x += a.r1 * a.inj1[idx];
    a.out[idx] = x;
  }
}

// The traces of the output (pad rows 0): the velocity itself (K1) or the
// traction n . sigma (K2) at face node q = f*NFP + k, face-major at rows
// f*rtf + c*NFP + k of the lane's trace lane (packed: f*rtf + par*rtq +
// c*NFP + k, the pad rows of the parity's block; a class's halo lanes are
// not written), or with V2 component-major at rows c*rtf + q
// (packed: c*rtf + par*NFT + q; the pad rows NPAR*NFT..rtf-1, which follow
// parity 1's rows, are parity 0's to write, so the two never race).
template <class LY, class Args>
__device__ __forceinline__ void emit(const Args& a, const Tile& tl,
                                     const float* sm) {
  constexpr int DIM = LY::DIM, NP = LY::NP, NFP = LY::NFP, T = LY::T;
  if (!tl.live) return;
  const float* s_out = sm + LY::OFF_IN + tl.l;
  const float* s_geo = sm + LY::OFF_GEO + tl.l;
  const int* s_fn = reinterpret_cast<const int*>(sm + LY::OFF_INT);
  // V2 traces lie on the state lanes, merged ones on the trace lanes
  const long long Ls = LY::V2 ? a.Ls : a.Lt,
                  L = (LY::V2 ? tl.lane0 : tl.tlane0) + tl.l;
  // row distance of the components of one face node
  const size_t cs = (size_t)(LY::V2 ? a.rtf : NFP) * Ls;
  const int hq = LY::NPAR == 1 ? 0 : tl.par * LY::NFT;
  for (int q = tl.ig; q < LY::NFT; q += LY::NG) {
    const int f = q / NFP, node = s_fn[q];
    float* tr = LY::V2 ? a.trout + (size_t)(hq + q) * Ls + L
                       : a.trout + ((size_t)f * a.rtf + tl.par * a.rtq +
                                    q % NFP) * Ls + L;
    if constexpr (LY::VEL) {
#pragma unroll
      for (int c = 0; c < DIM; ++c) tr[c * cs] = s_out[(c * NP + node) * T];
    } else {
      float n[DIM], sv[LY::NSIG];
#pragma unroll
      for (int d = 0; d < DIM; ++d)
        n[d] = s_geo[(LY::G_NRM + d * LY::NF + f) * T];
#pragma unroll
      for (int m = 0; m < LY::NSIG; ++m) sv[m] = s_out[(m * NP + node) * T];
#pragma unroll
      for (int c = 0; c < DIM; ++c) {
        float t = 0.f;
#pragma unroll
        for (int d = 0; d < DIM; ++d) t += n[d] * sv[voigt<DIM>(c, d)];
        tr[c * cs] = t;
      }
    }
  }
  if constexpr (LY::V2) {  // rows NPAR*NFT..rtf-1 of every component
    constexpr int R0 = LY::NPAR * LY::NFT;
    const int pad = LY::NPAR == 1 || tl.par == 0 ? a.rtf - R0 : 0;
    for (int r = tl.ig; r < DIM * pad; r += LY::NG)
      a.trout[((size_t)(r / pad) * a.rtf + R0 + r % pad) * Ls + L] = 0.f;
  } else {  // rows DIM*NFP..rtq-1 of every face's (parity) block
    const int pad = (LY::NPAR == 1 ? a.rtf : a.rtq) - DIM * NFP;
    for (int r = tl.ig; r < LY::NF * pad; r += LY::NG)
      a.trout[((size_t)(r / pad) * a.rtf + tl.par * a.rtq + DIM * NFP +
               r % pad) * Ls + L] = 0.f;
  }
}

// The velocity operator of K1, K8 and K4 on a staged tile (the table,
// sigma, the neighbour's traces and the geo rows in shared memory, as
// Layout says), on this thread's nodes i0 .. i0 + RM - 1 of lane l (i0 =
// ig*RM): du_c = (1/rho) [Dr_1 .. Dr_DIM | LIFT] @ [w_1c; ..; w_DIMc;
// flux_c], w_rc = sum_d Ginv[r][d] sigma_V(c,d), flux_c = scb*t+_c +
// bfs*t-_c with t-_c = n . sigma at the face node.  t+ is, by layout:
//   merged (K1)  -(producer traction), or t- on a boundary face (mask);
//   V2 (K8)      the exchanged row as it is: already signed, and already
//                t- on a boundary face;
//   LANE (K4)    sign * the staged row (TRAC, SEL; SIGN) or n . the
//                neighbour's sigma traces with the own normals (SIGTR), in
//                Fscale*(t+/2 + beta*t-): scb = sign*Fscale/2, bfs =
//                beta*Fscale.
// The flux overwrites the NB rows in place, w the sigma rows.
template <class LY>
__device__ __forceinline__ void vel_core(const Tile& tl, float* sm,
                                         float (&v)[LY::DIM][LY::RM]) {
  constexpr int DIM = LY::DIM, NP = LY::NP, NFP = LY::NFP, NF = LY::NF;
  constexpr int NFT = LY::NFT, NSIG = LY::NSIG, T = LY::T, NG = LY::NG;
  constexpr int RM = LY::RM, NPI = LY::NPI, KV = LY::KV, WS = LY::WS;
  float* s_w = sm + LY::OFF_IN + tl.l;  // sigma j*WS + m -> w j*WS + r*DIM + c
  float* s_nb = sm + LY::OFF_NB + tl.l;  // neighbour traction -> flux
  const float* s_geo = sm + LY::OFF_GEO + tl.l;
  const int* s_fn = reinterpret_cast<const int*>(sm + LY::OFF_INT);
  auto geo = [&](int r) { return s_geo[r * T]; };

  // the flux at every face node (a thread reads all of face node q's
  // neighbour rows before it writes q's flux rows)
  for (int q = tl.ig; q < NFT; q += NG) {
    const int f = q / NFP, node = s_fn[q];
    bool own_only = false;
    if constexpr (!LY::V2) own_only = geo(LY::G_MASK + f) != 0.f;
    float scb = geo(LY::G_SCB + f), bfs = geo(LY::G_BFS + f);
    if constexpr (LY::LANE) {  // rows Fscale, beta (and the sign)
      bfs *= scb, scb *= 0.5f;
      if constexpr (LY::SIGN) scb *= geo(LY::G_MASK + f);
    }
    float n[DIM], sv[NSIG];
#pragma unroll
    for (int d = 0; d < DIM; ++d) n[d] = geo(LY::G_NRM + d * NF + f);
#pragma unroll
    for (int m = 0; m < NSIG; ++m) sv[m] = s_w[(node * WS + m) * T];
    float tp[DIM];  // SIGTR: n . the neighbour's sigma
    if constexpr (LY::SIGTR) {
      float st[NSIG];
#pragma unroll
      for (int m = 0; m < NSIG; ++m) st[m] = s_nb[(m * NFT + q) * T];
#pragma unroll
      for (int c = 0; c < DIM; ++c) {
        tp[c] = 0.f;
#pragma unroll
        for (int d = 0; d < DIM; ++d) tp[c] += n[d] * st[voigt<DIM>(c, d)];
      }
    }
#pragma unroll
    for (int c = 0; c < DIM; ++c) {
      float own = 0.f;
#pragma unroll
      for (int d = 0; d < DIM; ++d) own += n[d] * sv[voigt<DIM>(c, d)];
      float* fx = s_nb + (c * NFT + q) * T;
      if constexpr (LY::SIGTR)
        *fx = scb * tp[c] + bfs * own;
      else if constexpr (LY::V2)
        *fx = scb * *fx + bfs * own;
      else
        *fx = scb * (own_only ? own : -*fx) + bfs * own;
    }
  }
  __syncthreads();  // sigma's face values are read: w takes its rows
  {
    float g[DIM][DIM];
#pragma unroll
    for (int r = 0; r < DIM; ++r)
#pragma unroll
      for (int d = 0; d < DIM; ++d) g[r][d] = geo(LY::G_GINV + r * DIM + d);
    for (int j = tl.ig; j < NP; j += NG) {
      float sv[NSIG];
#pragma unroll
      for (int m = 0; m < NSIG; ++m) sv[m] = s_w[(j * WS + m) * T];
#pragma unroll
      for (int r = 0; r < DIM; ++r)
#pragma unroll
        for (int c = 0; c < DIM; ++c) {
          float w = 0.f;
#pragma unroll
          for (int d = 0; d < DIM; ++d) w += g[r][d] * sv[voigt<DIM>(c, d)];
          s_w[(j * WS + r * DIM + c) * T] = w;
        }
    }
  }
  __syncthreads();

  const int i0 = tl.ig * RM;
  const float* s_A = sm + LY::OFF_A + i0;
#pragma unroll
  for (int c = 0; c < DIM; ++c)
#pragma unroll
    for (int ii = 0; ii < RM; ++ii) v[c][ii] = 0.f;
#pragma unroll 2
  for (int j = 0; j < NP; ++j)
#pragma unroll
    for (int r = 0; r < DIM; ++r) {
      const TabRow<RM> a4(s_A + (j * DIM + r) * NPI);
#pragma unroll
      for (int c = 0; c < DIM; ++c) {
        const float b = s_w[(j * WS + r * DIM + c) * T];
#pragma unroll
        for (int ii = 0; ii < RM; ++ii)
          v[c][ii] = fmaf(a4[ii], b, v[c][ii]);
      }
    }
#pragma unroll 4
  for (int q = 0; q < NFT; ++q) {
    const TabRow<RM> a4(s_A + (KV + q) * NPI);
#pragma unroll
    for (int c = 0; c < DIM; ++c) {
      const float b = s_nb[(c * NFT + q) * T];
#pragma unroll
      for (int ii = 0; ii < RM; ++ii)
        v[c][ii] = fmaf(a4[ii], b, v[c][ii]);
    }
  }
  const float irho = geo(LY::G_MAT);
#pragma unroll
  for (int c = 0; c < DIM; ++c)
#pragma unroll
    for (int ii = 0; ii < RM; ++ii) v[c][ii] *= irho;
}

// K1 (and K8, K1pk, K8pk, K11): the velocity core, then the epilogue, the
// output tile and the emitted traces.
template <class LY, class Args>
__device__ __forceinline__ void vel_tile(const Args& a, float* sm) {
  const Tile tl = make_tile<LY>(a);
  stage<LY>(a, tl, sm);
  float v[LY::DIM][LY::RM];
  vel_core<LY>(tl, sm, v);
  const int i0 = tl.ig * LY::RM;
  finish_nodes<LY>(a, tl, i0, v, false);
  __syncthreads();  // w and the flux are read: the output tile takes w's rows
  store_tile<LY>(a, tl, i0, v, sm + LY::OFF_IN, false);
  __syncthreads();
  emit<LY>(a, tl, sm);
}

// The stress operator of K2, K9 and K5 on a staged tile (the table, u, the
// plus-side traces u+ and the geo rows in shared memory, as Layout says),
// on this thread's nodes i0 .. i0 + RM - 1 of lane l (i0 = ig*RM):
// ds_k = sum_{c,d} A_k[d,c] du_c/dx_d + sum_f sum_c F_kc(f) (LIFT_f @
// jump_c), du_c/dx_d = sum_r Ginv[r][d] (Dr_r @ u_c), jump_c = scb*u+_c +
// dfs*u-_c, F_kc(f) = sum_d A_k[d,c] n_d(f); A_k the isotropic Hooke rows
// or, ANISO, A_k[d,c] = C[k][voigt(c,d)].  The jump overwrites u+ in place.
template <class LY>
__device__ __forceinline__ void stress_core(const Tile& tl, float* sm,
                                            float (&sig)[LY::NSIG][LY::RM]) {
  constexpr int DIM = LY::DIM, NP = LY::NP, NFP = LY::NFP, NF = LY::NF;
  constexpr int NFT = LY::NFT, NSIG = LY::NSIG, T = LY::T, NG = LY::NG;
  constexpr int RM = LY::RM, NPI = LY::NPI, KV = LY::KV;
  const float* s_in = sm + LY::OFF_IN + tl.l;  // u rows c*NP + j
  float* s_nb = sm + LY::OFF_NB + tl.l;        // u+ rows c*NFT + q -> jump
  float* s_F = sm + LY::OFF_F + tl.l;          // ANISO: F_kc(f)
  const float* s_geo = sm + LY::OFF_GEO + tl.l;
  const int* s_fn = reinterpret_cast<const int*>(sm + LY::OFF_INT);
  auto geo = [&](int r) { return s_geo[r * T]; };

  // the jump at every face node (u+ = u- on a boundary face)
  for (int q = tl.ig; q < NFT; q += NG) {
    const int f = q / NFP, node = s_fn[q];
    bool own_only = false;
    if constexpr (!LY::V2) own_only = geo(LY::G_MASK + f) != 0.f;
    float scb = geo(LY::G_SCB + f), dfs = geo(LY::G_BFS + f);
    if constexpr (LY::LANE) dfs *= scb, scb *= 0.5f;  // rows Fscale, delta
#pragma unroll
    for (int c = 0; c < DIM; ++c) {
      const float own = s_in[(c * NP + node) * T];
      float* nb = s_nb + (c * NFT + q) * T;
      *nb = scb * (own_only ? own : *nb) + dfs * own;
    }
  }
  if constexpr (LY::ANISO) {  // the face Hooke coefficients of every face
    for (int f = tl.ig; f < NF; f += NG) {
      float n[DIM];
#pragma unroll
      for (int d = 0; d < DIM; ++d) n[d] = geo(LY::G_NRM + d * NF + f);
#pragma unroll
      for (int k = 0; k < NSIG; ++k) {
        float Ck[NSIG], w[DIM];
#pragma unroll
        for (int m = 0; m < NSIG; ++m) Ck[m] = geo(LY::G_MAT + k * NSIG + m);
        voigt_row<DIM>(Ck, n, w);
#pragma unroll
        for (int c = 0; c < DIM; ++c)
          s_F[((f * NSIG + k) * DIM + c) * T] = w[c];
      }
    }
  }
  __syncthreads();

  // G_rc = Dr_r @ u_c on this thread's nodes i0 .. i0 + RM - 1
  const int i0 = tl.ig * RM;
  const float* s_A = sm + LY::OFF_A + i0;
  float G[DIM][DIM][RM];
#pragma unroll
  for (int r = 0; r < DIM; ++r)
#pragma unroll
    for (int c = 0; c < DIM; ++c)
#pragma unroll
      for (int ii = 0; ii < RM; ++ii) G[r][c][ii] = 0.f;
#pragma unroll 2
  for (int j = 0; j < NP; ++j) {
    float uj[DIM];
#pragma unroll
    for (int c = 0; c < DIM; ++c) uj[c] = s_in[(c * NP + j) * T];
#pragma unroll
    for (int r = 0; r < DIM; ++r) {
      const TabRow<RM> d4(s_A + (j * DIM + r) * NPI);
#pragma unroll
      for (int c = 0; c < DIM; ++c)
#pragma unroll
        for (int ii = 0; ii < RM; ++ii)
          G[r][c][ii] = fmaf(d4[ii], uj[c], G[r][c][ii]);
    }
  }
  // engineering strains of the physical gradient du_c/dx_d =
  // sum_r Ginv[r][d] G_rc, then the volume Hooke law
  float eps[NSIG][RM];
  {
    float g[DIM][DIM];
#pragma unroll
    for (int r = 0; r < DIM; ++r)
#pragma unroll
      for (int d = 0; d < DIM; ++d) g[r][d] = geo(LY::G_GINV + r * DIM + d);
#pragma unroll
    for (int ii = 0; ii < RM; ++ii) {
      float gr[DIM][DIM];
#pragma unroll
      for (int c = 0; c < DIM; ++c)
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
          float s = 0.f;
#pragma unroll
          for (int r = 0; r < DIM; ++r) s = fmaf(g[r][d], G[r][c][ii], s);
          gr[c][d] = s;
        }
#pragma unroll
      for (int m = 0; m < DIM; ++m) eps[m][ii] = gr[m][m];
#pragma unroll
      for (int m = DIM; m < NSIG; ++m)
        eps[m][ii] = gr[shear_a<DIM>(m)][shear_b<DIM>(m)] +
                     gr[shear_b<DIM>(m)][shear_a<DIM>(m)];
    }
  }
  float lam = 0.f, mu = 0.f;
  if constexpr (LY::ANISO) {
#pragma unroll
    for (int k = 0; k < NSIG; ++k) {
      float Ck[NSIG];
#pragma unroll
      for (int m = 0; m < NSIG; ++m) Ck[m] = geo(LY::G_MAT + k * NSIG + m);
#pragma unroll
      for (int ii = 0; ii < RM; ++ii) {
        float s = 0.f;
#pragma unroll
        for (int m = 0; m < NSIG; ++m) s = fmaf(Ck[m], eps[m][ii], s);
        sig[k][ii] = s;
      }
    }
  } else {
    lam = geo(LY::G_MAT), mu = geo(LY::G_MAT + 1);
#pragma unroll
    for (int ii = 0; ii < RM; ++ii) {
      float tr = 0.f;
#pragma unroll
      for (int m = 0; m < DIM; ++m) tr += eps[m][ii];
#pragma unroll
      for (int k = 0; k < NSIG; ++k)
        sig[k][ii] = k < DIM ? lam * tr + 2.f * mu * eps[k][ii]
                             : mu * eps[k][ii];
    }
  }
  // the face term, face by face: LIFT_f @ jump_c, then the Hooke rows
#pragma unroll 1
  for (int f = 0; f < NF; ++f) {
    float lj[DIM][RM];
#pragma unroll
    for (int c = 0; c < DIM; ++c)
#pragma unroll
      for (int ii = 0; ii < RM; ++ii) lj[c][ii] = 0.f;
#pragma unroll
    for (int k = 0; k < NFP; ++k) {
      const int q = f * NFP + k;
      const TabRow<RM> l4(s_A + (KV + q) * NPI);
#pragma unroll
      for (int c = 0; c < DIM; ++c) {
        const float jv = s_nb[(c * NFT + q) * T];
#pragma unroll
        for (int ii = 0; ii < RM; ++ii)
          lj[c][ii] = fmaf(l4[ii], jv, lj[c][ii]);
      }
    }
    if constexpr (LY::ANISO) {
#pragma unroll
      for (int k = 0; k < NSIG; ++k)
#pragma unroll
        for (int c = 0; c < DIM; ++c) {
          const float Fv = s_F[((f * NSIG + k) * DIM + c) * T];
#pragma unroll
          for (int ii = 0; ii < RM; ++ii)
            sig[k][ii] = fmaf(Fv, lj[c][ii], sig[k][ii]);
        }
    } else {
      // F_kc = lam n_c + 2 mu n_k [c = k] (k < DIM); mu n_b, mu n_a at the
      // shear pair (a, b) of k
      float n[DIM];
#pragma unroll
      for (int d = 0; d < DIM; ++d) n[d] = geo(LY::G_NRM + d * NF + f);
#pragma unroll
      for (int ii = 0; ii < RM; ++ii) {
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < DIM; ++c) s = fmaf(n[c], lj[c][ii], s);
#pragma unroll
        for (int k = 0; k < DIM; ++k)
          sig[k][ii] += lam * s + 2.f * mu * n[k] * lj[k][ii];
#pragma unroll
        for (int k = DIM; k < NSIG; ++k) {
          const int sa = shear_a<DIM>(k), sb = shear_b<DIM>(k);
          sig[k][ii] += mu * (n[sa] * lj[sb][ii] + n[sb] * lj[sa][ii]);
        }
      }
    }
  }
}

// K2 (and K9, K2pk, K9pk): the stress core, then the epilogue, the output
// tile and the emitted traces.
template <class LY, class Args>
__device__ __forceinline__ void stress_tile(const Args& a, float* sm) {
  const Tile tl = make_tile<LY>(a);
  stage<LY>(a, tl, sm);
  float sig[LY::NSIG][LY::RM];
  stress_core<LY>(tl, sm, sig);
  const int i0 = tl.ig * LY::RM;
  finish_nodes<LY>(a, tl, i0, sig, true);
  __syncthreads();  // u and the jump are read: the output tile takes them
  store_tile<LY>(a, tl, i0, sig, sm + LY::OFF_IN, true);
  __syncthreads();
  emit<LY>(a, tl, sm);
}

}  // namespace tile
}  // namespace seigen
