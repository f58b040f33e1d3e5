// Tile kernels of the coupled upwind (Godunov) operator: K3 upwind_rhs
// (upwind_kernels.cu, the merged layout), and K6 lane_upwind_rhs and K7
// lane_upwind_axpy (lane_upwind_kernels.cu, the unstructured lane layout).
// All compute
//   du = (1/rho)(div sigma + LIFT(Fscale (t* - t-)))
//   ds = Hooke(grad u) + LIFT(Fscale Hooke_f(u* - u-))
// and differ in where the plus-side traces come from (K3: the producer's
// payload trace at the plan's shift; K6/K7: the selected rows of two raw
// panels), in the geometry rows and in the epilogue.  This header holds
// what they share, on the pattern of merged_tile.cuh (K1/K2): a block owns
// T consecutive lanes, stages them in shared memory, and a thread then owns
// RM nodes of one lane in the node-by-lane products.
//
// Everything per lane that is indexed at run time lives in shared memory;
// register arrays are indexed only under full unrolling, so the kernels
// keep no local memory.  The Riemann corrections dtf/duf overwrite the
// staged plus-side traces in place (2*DIM*NFT rows either way).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "merged_common.cuh"
#include "merged_tile.cuh"

namespace seigen {
namespace uptile {

using tile::cp_async16;
using tile::cp_async4;
using tile::cp_async_wait_all;
using tile::TabRow;

// Shape of the tiles of one element type; NPI, NG, T as tile::Layout.  RM
// is two nodes a thread for the triangles and tetrahedra of P2 and up,
// four at P1 (four nodes a thread made ptxas spill a few bytes in K3 at 2D
// P2 and P4).
// Shared memory, in floats:
//   A    KA x NPI     the table (KernelTables.tile): row j*DIM + r holds
//                     Dr_r[i][j], row KV + q holds LIFT[i][q]
//   W    NP x WS x T  sigma at rows j*WS + m, then w_rc = sum_d Ginv[r][d]
//                     sigma_V(c,d) at j*WS + r*DIM + c in place
//   U    DIM x NP x T u at rows c*NP + j
//   NB   2 x DIM x NFT x T  the plus side: u+ at rows c*NFT + q, t+ at
//                     (DIM + c)*NFT + q; then duf = Fscale (u* - u-) and
//                     dtf = Fscale (t* - t-) in place
//   GEO  GR x T       per-lane rows (G_* below)
//   ints NFT face nodes
// The output tile ((DIM + NSIG) x NP x T, rows c*NP + i of the emitted u,
// then DIM*NP + k*NP + i of the emitted sigma) takes the place of W and U
// once the products have read them.
template <int DIM_, int NP_, int NFP_, bool MERGED_>
struct Layout {
  static constexpr int DIM = DIM_, NP = NP_, NFP = NFP_;
  static constexpr bool MERGED = MERGED_;  // K3: own-trace mask, t+ sign -1
  using S = Shape<DIM, NP, NFP>;
  static constexpr int NF = S::NF, NFT = S::NFT, NSIG = S::NSIG;
  static constexpr int RM = NP > DIM + 1 ? 2 : 4;
  static constexpr int NPI = (NP + 3) / 4 * 4;
  static constexpr int NG = NPI / RM;
  static constexpr int T = NG >= 4 ? 32 : (NG >= 2 ? 64 : 128);
  static constexpr int THREADS = NG * T;
  static constexpr int KV = DIM * NP;
  static constexpr int KA = KV + NFT;
  static constexpr int WS = DIM * DIM;
  static constexpr int NIN = (NSIG + DIM) * NP;  // staged state rows
  // geo rows: Ginv r*DIM + d; normals d*NF + f; Fscale (K3: scb = Fscale
  // / 2) f; neighbour Zp, Zs f; ghost (K3) or sign (K6/K7) of u+ and t+ f;
  // 1/rho, lambda, mu; own Zp, Zs; K3: the own-trace mask f
  static constexpr int G_GINV = 0;
  static constexpr int G_NRM = DIM * DIM;
  static constexpr int G_FSC = G_NRM + DIM * NF;
  static constexpr int G_ZPN = G_FSC + NF;
  static constexpr int G_ZSN = G_ZPN + NF;
  static constexpr int G_GU = G_ZSN + NF;
  static constexpr int G_GT = G_GU + NF;
  static constexpr int G_MAT = G_GT + NF;
  static constexpr int G_ZOWN = G_MAT + 3;
  static constexpr int G_MASK = G_ZOWN + 2;
  static constexpr int GR = G_MASK + (MERGED ? NF : 0);
  static constexpr int OFF_A = 0;
  static constexpr int OFF_W = OFF_A + KA * NPI;
  static constexpr int OFF_U = OFF_W + NP * WS * T;
  static constexpr int OFF_NB = OFF_U + DIM * NP * T;
  static constexpr int OFF_GEO = OFF_NB + 2 * DIM * NFT * T;
  static constexpr int OFF_INT = OFF_GEO + GR * T;
  static constexpr int BYTES = 4 * (OFF_INT + NFT);
  static_assert(OFF_W % 4 == 0 && T % 4 == 0, "16-byte rows");
  static_assert((DIM + NSIG) * NP * T <= OFF_NB - OFF_W,
                "the output tile fits the state rows");
  static_assert(BYTES <= 227 * 1024, "shared memory of one block");
};

// The block's tile: first lane j0 of class blockIdx.y (K6/K7: one class of
// NC = E lanes), nvalid live lanes (the last tile is ragged); the thread's
// lane l and node group ig (threadIdx.x = ig*T + l); own = the lane the
// thread stages for, clamped to the last live one.
struct Tile {
  long long j0, lane0, own;
  int nvalid, l, ig;
  bool live;
};

template <class LY>
__device__ __forceinline__ Tile make_tile(long long NC) {
  Tile tl;
  tl.j0 = (long long)blockIdx.x * LY::T;
  tl.nvalid = (int)min((long long)LY::T, NC - tl.j0);
  tl.l = (int)threadIdx.x % LY::T;
  tl.ig = (int)threadIdx.x / LY::T;
  tl.lane0 = (long long)blockIdx.y * NC + tl.j0;
  tl.own = tl.lane0 + min(tl.l, tl.nvalid - 1);
  tl.live = tl.l < tl.nvalid;
  return tl;
}

// Stage the table (16 bytes a copy), the face nodes, the live state rows
// (sigma at W rows j*WS + m, u at U rows c*NP + j; global rows c*npp + j)
// and the geo rows (geo_row(r): the global row at lane 0), 16 bytes a copy
// when vec (a whole tile of 16-byte aligned rows), else 4 bytes, lanes past
// nvalid loading the last live lane.  The caller adds the plus-side rows,
// then waits (finish_stage).
template <class LY, class GeoRow>
__device__ __forceinline__ void stage_state(const Tile& tl, float* sm,
                                            const float* u, const float* s,
                                            const float* tab,
                                            const int* fnodes, int npp,
                                            long long Ls, bool vec,
                                            GeoRow geo_row) {
  constexpr int T = LY::T, NG = LY::NG, NP = LY::NP, NSNP = LY::NSIG * NP;
  constexpr int Q = T / 4, NR = LY::NIN + LY::GR;
  int* s_fn = reinterpret_cast<int*>(sm + LY::OFF_INT);
  for (int e = threadIdx.x; e < LY::NFT; e += LY::THREADS) s_fn[e] = fnodes[e];
  for (int e = threadIdx.x; e < LY::KA * LY::NPI / 4; e += LY::THREADS)
    cp_async16(sm + LY::OFF_A + 4 * e, tab + 4 * e);
  auto dst = [&](int r) {
    if (r < NSNP)
      return sm + LY::OFF_W + ((r % NP) * LY::WS + r / NP) * T;
    if (r < LY::NIN) return sm + LY::OFF_U + (r - NSNP) * T;
    return sm + LY::OFF_GEO + (r - LY::NIN) * T;
  };
  auto src = [&](int r) {
    if (r < NSNP) return s + ((long long)(r / NP) * npp + r % NP) * Ls;
    if (r < LY::NIN) {
      const int q = r - NSNP;
      return u + ((long long)(q / NP) * npp + q % NP) * Ls;
    }
    return geo_row(r - LY::NIN);
  };
  if (vec) {
    for (int e = threadIdx.x; e < NR * Q; e += LY::THREADS) {
      const int r = e / Q, l4 = (e % Q) * 4;
      cp_async16(dst(r) + l4, src(r) + tl.lane0 + l4);
    }
  } else {
    for (int r = tl.ig; r < NR; r += NG)
      cp_async4(dst(r) + tl.l, src(r) + tl.own);
  }
}

__device__ __forceinline__ void finish_stage() {
  cp_async_wait_all();
  __syncthreads();
}

// The Riemann corrections at every face node, over the plus-side rows:
// u+ = gu * (u+ staged), t+ = gt * (t+ staged) (K3: gt * -(t+ staged), and
// the own u-, t- on a masked face), then duf, dtf in place.  Ends with a
// barrier (sigma's face values are read).
template <class LY>
__device__ __forceinline__ void riemann(const Tile& tl, float* sm) {
  constexpr int DIM = LY::DIM, NFP = LY::NFP, NF = LY::NF, NFT = LY::NFT;
  constexpr int NP = LY::NP, NSIG = LY::NSIG, T = LY::T, WS = LY::WS;
  const float* s_w = sm + LY::OFF_W + tl.l;
  const float* s_u = sm + LY::OFF_U + tl.l;
  float* s_nb = sm + LY::OFF_NB + tl.l;
  const float* s_geo = sm + LY::OFF_GEO + tl.l;
  const int* s_fn = reinterpret_cast<const int*>(sm + LY::OFF_INT);
  auto geo = [&](int r) { return s_geo[r * T]; };
  const float zp_m = geo(LY::G_ZOWN), zs_m = geo(LY::G_ZOWN + 1);
  for (int q = tl.ig; q < NFT; q += LY::NG) {
    const int f = q / NFP, node = s_fn[q];
    float n[DIM], sv[NSIG], um[DIM], tm[DIM], up[DIM], tp[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) n[d] = geo(LY::G_NRM + d * NF + f);
    const float fsc = (LY::MERGED ? 2.f : 1.f) * geo(LY::G_FSC + f);
    const FaceImpedance z = face_impedance(zp_m, zs_m, geo(LY::G_ZPN + f),
                                           geo(LY::G_ZSN + f));
    const float gu = geo(LY::G_GU + f), gt = geo(LY::G_GT + f);
#pragma unroll
    for (int m = 0; m < NSIG; ++m) sv[m] = s_w[(node * WS + m) * T];
#pragma unroll
    for (int c = 0; c < DIM; ++c) {
      um[c] = s_u[(c * NP + node) * T];
      float t = 0.f;
#pragma unroll
      for (int d = 0; d < DIM; ++d) t += n[d] * sv[voigt<DIM>(c, d)];
      tm[c] = t;
    }
    const bool own_only = LY::MERGED && geo(LY::G_MASK + f) != 0.f;
#pragma unroll
    for (int c = 0; c < DIM; ++c) {
      const float ub = s_nb[(c * NFT + q) * T];
      const float tb = s_nb[((DIM + c) * NFT + q) * T];
      up[c] = gu * (own_only ? um[c] : ub);
      tp[c] = gt * (own_only ? tm[c] : (LY::MERGED ? -tb : tb));
    }
    float dt[DIM], du[DIM];
    riemann_corrections<DIM>(z, fsc, n, um, tm, up, tp, dt, du);
#pragma unroll
    for (int c = 0; c < DIM; ++c) {
      s_nb[(c * NFT + q) * T] = du[c];
      s_nb[((DIM + c) * NFT + q) * T] = dt[c];
    }
  }
  __syncthreads();
}

// w_rc = sum_d Ginv[r][d] sigma_V(c,d) over sigma's rows, node by node in
// place; ends with a barrier.
template <class LY>
__device__ __forceinline__ void contract_sigma(const Tile& tl, float* sm) {
  constexpr int DIM = LY::DIM, NSIG = LY::NSIG, T = LY::T, WS = LY::WS;
  float* s_w = sm + LY::OFF_W + tl.l;
  const float* s_geo = sm + LY::OFF_GEO + tl.l;
  float g[DIM][DIM];
#pragma unroll
  for (int r = 0; r < DIM; ++r)
#pragma unroll
    for (int d = 0; d < DIM; ++d) g[r][d] = s_geo[(LY::G_GINV + r * DIM + d) * T];
  for (int j = tl.ig; j < LY::NP; j += LY::NG) {
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
  __syncthreads();
}

// du_c on this thread's nodes i0 .. i0 + RM - 1: (1/rho) [Dr_1 .. Dr_DIM |
// LIFT] @ [w_1c; ..; w_DIMc; dtf_c].
template <class LY>
__device__ __forceinline__ void vel_product(const Tile& tl, const float* sm,
                                            int i0,
                                            float (&v)[LY::DIM][LY::RM]) {
  constexpr int DIM = LY::DIM, NP = LY::NP, NFT = LY::NFT, T = LY::T;
  constexpr int RM = LY::RM, NPI = LY::NPI, KV = LY::KV, WS = LY::WS;
  const float* s_A = sm + LY::OFF_A + i0;
  const float* s_w = sm + LY::OFF_W + tl.l;
  const float* s_dt = sm + LY::OFF_NB + DIM * NFT * T + tl.l;
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
        for (int ii = 0; ii < RM; ++ii) v[c][ii] = fmaf(a4[ii], b, v[c][ii]);
      }
    }
#pragma unroll 4
  for (int q = 0; q < NFT; ++q) {
    const TabRow<RM> a4(s_A + (KV + q) * NPI);
#pragma unroll
    for (int c = 0; c < DIM; ++c) {
      const float b = s_dt[(c * NFT + q) * T];
#pragma unroll
      for (int ii = 0; ii < RM; ++ii) v[c][ii] = fmaf(a4[ii], b, v[c][ii]);
    }
  }
  const float irho = sm[LY::OFF_GEO + LY::G_MAT * LY::T + tl.l];
#pragma unroll
  for (int c = 0; c < DIM; ++c)
#pragma unroll
    for (int ii = 0; ii < RM; ++ii) v[c][ii] *= irho;
}

// ds_k on this thread's nodes: the isotropic Hooke law of the physical
// gradient du_c/dx_d = sum_r Ginv[r][d] (Dr_r @ u_c), then the face term
// factored per face, sum_f F(f) . (LIFT_f @ duf), F_kc(f) = sum_d A_k[d,c]
// n_d(f) (as K2's tile kernel).
template <class LY>
__device__ __forceinline__ void stress_product(
    const Tile& tl, const float* sm, int i0,
    float (&sig)[LY::NSIG][LY::RM]) {
  constexpr int DIM = LY::DIM, NP = LY::NP, NFP = LY::NFP, NF = LY::NF;
  constexpr int NFT = LY::NFT, NSIG = LY::NSIG, T = LY::T;
  constexpr int RM = LY::RM, NPI = LY::NPI, KV = LY::KV;
  const float* s_A = sm + LY::OFF_A + i0;
  const float* s_u = sm + LY::OFF_U + tl.l;
  const float* s_du = sm + LY::OFF_NB + tl.l;
  const float* s_geo = sm + LY::OFF_GEO + tl.l;
  auto geo = [&](int r) { return s_geo[r * T]; };
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
    for (int c = 0; c < DIM; ++c) uj[c] = s_u[(c * NP + j) * T];
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
  const float lam = geo(LY::G_MAT + 1), mu = geo(LY::G_MAT + 2);
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
      float tr = 0.f;
#pragma unroll
      for (int m = 0; m < DIM; ++m) tr += gr[m][m];
#pragma unroll
      for (int k = 0; k < DIM; ++k) sig[k][ii] = lam * tr + 2.f * mu * gr[k][k];
#pragma unroll
      for (int k = DIM; k < NSIG; ++k)
        sig[k][ii] = mu * (gr[shear_a<DIM>(k)][shear_b<DIM>(k)] +
                           gr[shear_b<DIM>(k)][shear_a<DIM>(k)]);
    }
  }
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
        const float jv = s_du[(c * NFT + q) * T];
#pragma unroll
        for (int ii = 0; ii < RM; ++ii) lj[c][ii] = fmaf(l4[ii], jv, lj[c][ii]);
      }
    }
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

// The emitted state's values of this thread's nodes into the output tile
// (rows c*NP + i of u, DIM*NP + k*NP + i of sigma, over W and U), between
// two barriers: the products have read W and U, and the emission reads the
// tile.
template <class LY>
__device__ __forceinline__ void store_out_tile(
    const Tile& tl, float* sm, int i0, const float (&v)[LY::DIM][LY::RM],
    const float (&sig)[LY::NSIG][LY::RM]) {
  constexpr int NP = LY::NP, T = LY::T;
  float* s_out = sm + LY::OFF_W + tl.l;
  __syncthreads();
#pragma unroll
  for (int ii = 0; ii < LY::RM; ++ii)
    if (i0 + ii < NP) {
#pragma unroll
      for (int c = 0; c < LY::DIM; ++c) s_out[(c * NP + i0 + ii) * T] = v[c][ii];
#pragma unroll
      for (int k = 0; k < LY::NSIG; ++k)
        s_out[((LY::DIM + k) * NP + i0 + ii) * T] = sig[k][ii];
    }
  __syncthreads();
}

// Face node q of the output tile: u_c at the node and the traction
// sum_d n_d sigma_V(c,d) with the lane's own normals.
template <class LY>
__device__ __forceinline__ void face_values(const Tile& tl, const float* sm,
                                            int q, float (&uq)[LY::DIM],
                                            float (&tq)[LY::DIM]) {
  constexpr int DIM = LY::DIM, NP = LY::NP, T = LY::T;
  const float* s_out = sm + LY::OFF_W + tl.l;
  const float* s_geo = sm + LY::OFF_GEO + tl.l;
  const int node = reinterpret_cast<const int*>(sm + LY::OFF_INT)[q];
  const int f = q / LY::NFP;
  float n[DIM], sv[LY::NSIG];
#pragma unroll
  for (int d = 0; d < DIM; ++d) n[d] = s_geo[(LY::G_NRM + d * LY::NF + f) * T];
#pragma unroll
  for (int m = 0; m < LY::NSIG; ++m) sv[m] = s_out[((DIM + m) * NP + node) * T];
#pragma unroll
  for (int c = 0; c < DIM; ++c) {
    uq[c] = s_out[(c * NP + node) * T];
    float t = 0.f;
#pragma unroll
    for (int d = 0; d < DIM; ++d) t += n[d] * sv[voigt<DIM>(c, d)];
    tq[c] = t;
  }
}

}  // namespace uptile
}  // namespace seigen
