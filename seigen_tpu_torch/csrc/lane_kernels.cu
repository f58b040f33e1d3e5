// v1 lane-major LF operators for Hopper (sm_90a): K4 lane_vel, K5 lane_stress.
//
// Replaces the JAX package's v1 Pallas operator family,
// seigen_tpu/ops/pallas_kernels.py:
//   K4 lane_vel     mode SIG  <- _vel_kernel           (vel_op_lm)
//                   mode TRAC <- _vel_kernel_trac      (vel_op_lm_trac)
//                   mode SEL  <- _vel_kernel_trac_sel  (vel_op_lm_trac_sel)
//   K5 lane_stress  mode TR   <- _stress_kernel        (stress_op_lm)
//                   mode SEL  <- _stress_kernel_sel    (stress_op_lm_sel)
//                   and, with a per-lane Voigt stiffness (cmat), the general
//                   Hooke law of _stress_kernel_c / _stress_kernel_sel_c in
//                   the same two modes (the ANISO instantiation)
// The physics is the JAX kernels' (central flux: velocity jump
// 1/2 t+ + beta t-, stress jump 1/2 u+ + delta u-, then LIFT (Fscale .) and
// the 1/rho or Hooke scaling); the TPU layout devices (lane blocks, MXU
// [Dr; R] products, the where-chain over static permuted views) are gone.
// The neighbour traces arrive pre-exchanged in consumer order
// (SIG/TRAC/TR), or as raw per-face panels whose (producer face g, node
// permutation pi) the operator decodes from the lane's combo code and
// reads directly (SEL).
//
// What bounds them on the H100.  Per lane and launch the compulsory traffic
// is ~340-460 rows of 4 B (state, neighbour payload, per-face geometry in;
// output out): at E = 83k ~0.11-0.15 GB, ~34-46 us at 3.35 TB/s, against
// 12-24 kFLOP per lane of Dr and LIFT products, ~15-30 us at 67 TFLOP/s
// FP32: bytes bound.
//
// K4 is the first design, one thread a lane, and is bound by neither: as
// in the first K1/K2, every FMA takes its table operand from shared memory
// and the per-lane face-node flux lives in local memory.  Dr/LIFT/fnodes
// (and the SEL permutations) sit in shared memory once per block; lane
// loads and stores are coalesced; the volume term contracts the
// Voigt/direction sums before the Dr product (one Dr pass per output
// component); geometry is read once per face node, where it is needed.
//
// K5 is a tile kernel on the stress core of K2/K9 (merged_tile.cuh,
// stress_core), designed for this card as they are: a block owns a tile of
// T consecutive lanes (T 32 at 3D P2-P4 and 2D P3-P4, 64 or 128 below; the
// last tile ragged at E) and stages by cp.async the table
// (LaneOpData.ktile), u's live rows, the per-lane geometry (Ginv; of each
// face its first face-node row of the normals, Fscale and delta; lambda
// and mu, or the n_sig^2 C rows) and the plus-side velocity: TR the lane's
// own trace rows, 16 bytes a copy in a whole aligned tile; SEL each lane's
// selected panel rows, 4 bytes a copy with the permutation applied at
// fetch (K6/K7's staging).  The products are register-tiled,
// gradient-first with the face term factored per face, as K2's; the
// values go from registers to coalesced rows, pad rows 0.  No local
// memory: ptxas shows a 0 B stack and no spills at every shape
// (chip_smoke.py phase 2).  FP32 FFMA throughout.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (seigen_tpu_torch/ops/cuda_build.py, at first use).

#include <cuda_runtime.h>

#include <cstdint>

#include "lane_select.cuh"
#include "merged_common.cuh"
#include "merged_tile.cuh"

// Kernel arguments; mirrored field by field by the ctypes Structure
// LaneArgs in seigen_tpu_torch/ops/lane_kernels.py.  Lane rows are
// (rows, E) row-major: element L of row r at r*E + L.
struct LaneArgs {
  const float* field;  // sigma (n_sig*npp, E) for K4; u (dim*npp, E) for K5
  const float* tr;     // K4 SIG: sigma traces (n_sig*ftpp, E); K4 TRAC and
                       // K5 TR: (dim*ftpp, E); SEL: panels (nf*rows_pad, E)
  const int* combo;    // SEL: (8, E) row f = g*G + pi; else null
  const float* sign;   // K4 SEL: (8, E) row f = +-1; else null
  const int* perms;    // SEL: (G, n_fp) node permutations; else null
  const float* ginv;   // (dim*dim, E) rows r*dim + d
  const float* nrm;    // (dim*ftpp, E) face-node-expanded normals
  const float* fsc;    // (ftpp, E) face-node-expanded Fscale
  const float* coef;   // (ftpp, E) beta (K4) or delta (K5)
  const float* mat0;   // (8, E) row 0: 1/rho (K4) or lambda (K5)
  const float* mat1;   // (8, E) row 0: mu (K5); null for K4
  const float* cmat;   // K5: (n_sig*8, E) row c*8+k = Voigt C[c,k] (general
                       // Hooke law; mat0/mat1 unused); null: isotropic
  const float* dr;     // (dim, n_p, n_p) reference derivative matrices
  const float* lift;   // (n_p, nf*n_fp) LIFT
  const int* fnodes;   // (nf, n_fp) volume node of each face node
  float* out;          // (C*npp, E)
  long long E;         // lanes (elements)
  int npp;             // node rows per component (n_p rounded up to 8)
  int ftpp;            // trace rows per component (nf*n_fp rounded up to 8)
  int rows_pad;        // SEL: panel rows per face; else 0
  int cstride;         // SEL: panel rows per component; else 0
  int G;               // SEL: orientation groups (<= kMaxPerms); else 0
  int mode;            // K4: 0 SIG, 1 TRAC, 2 SEL; K5: 0 TR, 1 SEL
  const float* tab;    // K5: the tile table (LaneOpData.ktile): rows
                       // j*dim + r = Dr_r[., j], dim*n_p + q = LIFT[., q],
                       // n_p padded to a multiple of 4; K4: unused
};

namespace {

using namespace seigen;

enum { kVelSig = 0, kVelTrac = 1, kVelSel = 2 };
enum { kStressTr = 0, kStressSel = 1 };

// ---------------------------------------------------------------- K4 ---
// du_c = (1/rho) (sum_{r,d} Ginv[r,d] Dr_r sigma_{V[c,d]}
//                 + LIFT (Fscale (1/2 t+_c + beta t-_c)))
// t-_c = n_d sigma_{V[c,d]} at the face nodes (own normals); t+_c from
// the mode: SIG n_d tr_{V[c,d]}, TRAC tr_c, SEL sign * panel row.
template <int DIM, int NP, int NFP>
__global__ void __launch_bounds__(kThreads)
lane_vel_kernel(const LaneArgs a) {
  using S = Shape<DIM, NP, NFP>;
  constexpr int NF = S::NF, NFT = S::NFT, NSIG = S::NSIG;
  __shared__ float s_dr[DIM * NP * NP];
  __shared__ float s_lift[NP * NFT];
  __shared__ int s_fn[NFT];
  __shared__ int s_perm[kMaxPerms * NFP];
  load_perms<NFP>(a, s_perm);
  load_tables<DIM, NP, NFP>(a, s_dr, s_lift, s_fn);

  const long long L = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (L >= a.E) return;
  const long long E = a.E;
  const int npp = a.npp, ftpp = a.ftpp;
  auto row = [&](const float* x, long long r) { return x[r * E + L]; };

  float g[DIM][DIM];
#pragma unroll
  for (int r = 0; r < DIM; ++r)
#pragma unroll
    for (int d = 0; d < DIM; ++d) g[r][d] = row(a.ginv, r * DIM + d);
  const float irho = row(a.mat0, 0);

  // scaled face flux Fscale (1/2 t+ + beta t-) per component and face node
  float flux[DIM][NFT];
#pragma unroll 1
  for (int f = 0; f < NF; ++f) {
    long long pbase = 0;
    const int* perm = nullptr;
    float sgn = 1.f;
    if (a.mode == kVelSel) {
      pbase = sel_face<NFP>(a, s_perm, f, L, &perm);
      sgn = row(a.sign, f);
    }
#pragma unroll 1
    for (int k = 0; k < NFP; ++k) {
      const int q = f * NFP + k;
      const int node = s_fn[q];
      float n[DIM];
#pragma unroll
      for (int d = 0; d < DIM; ++d) n[d] = row(a.nrm, d * ftpp + q);
      float sv[NSIG];
#pragma unroll
      for (int c = 0; c < NSIG; ++c) sv[c] = row(a.field, c * npp + node);
      const float beta = row(a.coef, q), fs = row(a.fsc, q);
#pragma unroll
      for (int c = 0; c < DIM; ++c) {
        float own = 0.f;
#pragma unroll
        for (int d = 0; d < DIM; ++d) own += n[d] * sv[voigt<DIM>(c, d)];
        float nb;
        if (a.mode == kVelSig) {
          nb = 0.f;
#pragma unroll
          for (int d = 0; d < DIM; ++d)
            nb += n[d] * row(a.tr, voigt<DIM>(c, d) * ftpp + q);
        } else if (a.mode == kVelTrac) {
          nb = row(a.tr, c * ftpp + q);
        } else {
          nb = sgn * row(a.tr, pbase + c * a.cstride + perm[k]);
        }
        flux[c][q] = (0.5f * nb + beta * own) * fs;
      }
    }
  }

#pragma unroll 1
  for (int c = 0; c < DIM; ++c) {
    float acc[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) acc[i] = 0.f;
    // volume: sum_r Dr_r @ w_r, w_r = sum_d Ginv[r,d] sigma_{V[c,d]}
#pragma unroll 1
    for (int jj = 0; jj < NP; ++jj) {
      float sv[DIM];
#pragma unroll
      for (int d = 0; d < DIM; ++d) sv[d] = row(a.field, voigt<DIM>(c, d) * npp + jj);
#pragma unroll
      for (int r = 0; r < DIM; ++r) {
        float w = 0.f;
#pragma unroll
        for (int d = 0; d < DIM; ++d) w += g[r][d] * sv[d];
        const float* drc = s_dr + r * NP * NP + jj;
#pragma unroll
        for (int i = 0; i < NP; ++i) acc[i] += drc[i * NP] * w;
      }
    }
    // surface: LIFT @ flux
#pragma unroll 1
    for (int q = 0; q < NFT; ++q) {
      const float fq = flux[c][q];
#pragma unroll
      for (int i = 0; i < NP; ++i) acc[i] += s_lift[i * NFT + q] * fq;
    }
    float* o = a.out + (long long)c * npp * E + L;
#pragma unroll
    for (int i = 0; i < NP; ++i) o[i * E] = irho * acc[i];
    for (int i = NP; i < npp; ++i) o[i * E] = 0.f;
  }
}

// ---------------------------------------------------------------- K5 ---
// ds_k = sum_{d,c} A_k[d,c] (du_c/dx_d) + LIFT(Fscale sum_{d,c} A_k[d,c] n_d du*_c)
// with A the Hooke tensor in Voigt row k — isotropic (lambda, mu), or with
// ANISO the lane's general Voigt stiffness, A_k[d,c] = C[k][voigt(c,d)] —
// and du*_c = 1/2 u+_c + delta u-_c (u+ from the mode: TR traces, SEL
// panels).  This is the stress core of K2/K9 (merged_tile.cuh:stress_core)
// on the V2 layout: the same jump up to the Fscale factor, no mask.  K5
// stages its own tile: one class of all E lanes in tiles of T, the last
// one ragged; the geo rows are the lane layout's (LANE: the face rows are
// the first face-node row f*n_fp of the expanded nrm, fsc and delta, which
// are constant over a face); u+ is the lane's own rows c*ftpp + q (TR) or
// its selected panel rows (SEL, 4 bytes a copy, the permutation applied at
// fetch, as K6/K7 stage theirs).  The epilogue stores the values from
// registers, pad rows 0; K5 emits no traces.
template <int DIM, int NP, int NFP, bool ANISO>
using StressLayout = tile::Layout<DIM, NP, NFP, false, ANISO, true, 1, true>;

// Global row (at lane 0) of K5's local geo row r: Ginv; normals, Fscale
// and delta of each face at its first face-node row; lambda and mu (row 0
// of mat0, mat1) or C[k][m] (cmat row 8*k + m).
template <class LY>
__device__ __forceinline__ const float* stress_geo_row(const LaneArgs& a,
                                                       int r) {
  constexpr int NF = LY::NF, NFP = LY::NFP;
  const long long E = a.E;
  if (r < LY::G_NRM) return a.ginv + r * E;
  if (r < LY::G_SCB) {
    const int q = r - LY::G_NRM;
    return a.nrm + ((long long)(q / NF) * a.ftpp + (q % NF) * NFP) * E;
  }
  if (r < LY::G_BFS) return a.fsc + (long long)(r - LY::G_SCB) * NFP * E;
  if (r < LY::G_MAT) return a.coef + (long long)(r - LY::G_BFS) * NFP * E;
  const int q = r - LY::G_MAT;
  if constexpr (LY::ANISO)
    return a.cmat + (long long)(8 * (q / LY::NSIG) + q % LY::NSIG) * E;
  return q == 0 ? a.mat0 : a.mat1;
}

// Stage K5's tile by cp.async: the table and the face nodes; u's live rows,
// the geo rows and (TR) the trace rows c*ftpp + q, 16 bytes a copy when
// the tile is whole and its rows are 16-byte aligned, else 4 bytes, lanes
// past nvalid loading the last live lane; (SEL) each lane's selected panel
// rows f*rows_pad + g*n_fp + c*cstride + perms[pi][k], (g, pi) decoded from
// its combo code (lane_select.cuh), 4 bytes a copy.  Shared-memory rows as
// tile::Layout: u at IN rows c*NP + j, u+ at NB rows c*NFT + q.
template <class LY>
__device__ __forceinline__ void stage_stress(const LaneArgs& a,
                                             const tile::Tile& tl,
                                             float* sm) {
  constexpr int DIM = LY::DIM, NP = LY::NP, NFP = LY::NFP, NFT = LY::NFT;
  constexpr int T = LY::T, NG = LY::NG, NIN = DIM * NP, Q = T / 4;
  const long long E = a.E;
  int* s_fn = reinterpret_cast<int*>(sm + LY::OFF_INT);
  for (int e = threadIdx.x; e < NFT; e += LY::THREADS) s_fn[e] = a.fnodes[e];
  for (int e = threadIdx.x; e < LY::KA * LY::NPI / 4; e += LY::THREADS)
    tile::cp_async16(sm + LY::OFF_A + 4 * e, a.tab + 4 * e);
  const bool by_tr = a.mode == kStressTr;
  auto dst = [&](int r) {
    if (r < NIN) return sm + LY::OFF_IN + r * T;
    if (r < NIN + LY::GR) return sm + LY::OFF_GEO + (r - NIN) * T;
    return sm + LY::OFF_NB + (r - NIN - LY::GR) * T;
  };
  auto src = [&](int r) {
    if (r < NIN) return a.field + ((long long)(r / NP) * a.npp + r % NP) * E;
    if (r < NIN + LY::GR) return stress_geo_row<LY>(a, r - NIN);
    const int t = r - NIN - LY::GR;  // c*NFT + q
    return a.tr + ((long long)(t / NFT) * a.ftpp + t % NFT) * E;
  };
  const int NR = NIN + LY::GR + (by_tr ? DIM * NFT : 0);
  const uintptr_t ptrs =
      (uintptr_t)a.field | (uintptr_t)a.ginv | (uintptr_t)a.nrm |
      (uintptr_t)a.fsc | (uintptr_t)a.coef | (uintptr_t)a.mat0 |
      (uintptr_t)a.mat1 | (uintptr_t)a.cmat | (by_tr ? (uintptr_t)a.tr : 0);
  const long long own = tl.lane0 + min(tl.l, tl.nvalid - 1);
  if (tl.nvalid == T && (E & 3) == 0 && (ptrs & 15) == 0) {
    for (int e = threadIdx.x; e < NR * Q; e += LY::THREADS) {
      const int r = e / Q, l4 = (e % Q) * 4;
      tile::cp_async16(dst(r) + l4, src(r) + tl.lane0 + l4);
    }
  } else {
    for (int r = tl.ig; r < NR; r += NG)
      tile::cp_async4(dst(r) + tl.l, src(r) + own);
  }
  if (!by_tr) {
#pragma unroll 1
    for (int f = 0; f < LY::NF; ++f) {
      const int code = __ldg(a.combo + f * E + own);
      const int g = code / a.G, pi = code - g * a.G;
      const long long rb = (long long)f * a.rows_pad + g * NFP;
      const int* perm = a.perms + pi * NFP;
      for (int rr = tl.ig; rr < DIM * NFP; rr += NG) {
        const int c = rr / NFP, k = rr % NFP;
        tile::cp_async4(
            sm + LY::OFF_NB + (c * NFT + f * NFP + k) * T + tl.l,
            a.tr + (rb + (long long)c * a.cstride + __ldg(perm + k)) * E +
                own);
      }
    }
  }
  tile::cp_async_wait_all();
  __syncthreads();
}

// One block per tile of T lanes.
template <int DIM, int NP, int NFP, bool ANISO>
__global__ void __launch_bounds__(StressLayout<DIM, NP, NFP, ANISO>::THREADS)
lane_stress_tile_kernel(const LaneArgs a) {
  using LY = StressLayout<DIM, NP, NFP, ANISO>;
  extern __shared__ float4 s_dyn[];
  float* sm = reinterpret_cast<float*>(s_dyn);
  tile::Tile tl;
  tl.t = 0, tl.par = 0;
  tl.j0 = (int)blockIdx.x * LY::T;
  tl.nvalid = (int)min((long long)LY::T, a.E - tl.j0);
  tl.l = (int)threadIdx.x % LY::T;
  tl.ig = (int)threadIdx.x / LY::T;
  tl.lane0 = tl.j0;
  tl.live = tl.l < tl.nvalid;
  stage_stress<LY>(a, tl, sm);
  float sig[LY::NSIG][LY::RM];
  tile::stress_core<LY>(tl, sm, sig);
  if (!tl.live) return;
  const int i0 = tl.ig * LY::RM;
  const long long E = a.E;
  const int npp = a.npp, pad = npp - NP;
  float* out = a.out + tl.lane0 + tl.l;
#pragma unroll
  for (int k = 0; k < LY::NSIG; ++k)
#pragma unroll
    for (int ii = 0; ii < LY::RM; ++ii)
      if (i0 + ii < NP) out[((size_t)k * npp + i0 + ii) * E] = sig[k][ii];
  for (int r = tl.ig; r < LY::NSIG * pad; r += LY::NG)
    out[((size_t)(r / pad) * npp + NP + r % pad) * E] = 0.f;
}

// The dynamic shared memory is raised above 48 KB once per instantiation;
// an error there is returned like a launch error.
template <int DIM, int NP, int NFP, bool ANISO>
int launch_stress(const LaneArgs& a, cudaStream_t stream) {
  using LY = StressLayout<DIM, NP, NFP, ANISO>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      lane_stress_tile_kernel<DIM, NP, NFP, ANISO>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, LY::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  const unsigned blocks = (unsigned)((a.E + LY::T - 1) / LY::T);
  lane_stress_tile_kernel<DIM, NP, NFP, ANISO>
      <<<blocks, LY::THREADS, LY::BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int DIM, int NP, int NFP>
int launch(int op, const LaneArgs& a, cudaStream_t stream) {
  if (op == 0) {
    const unsigned blocks = (unsigned)((a.E + kThreads - 1) / kThreads);
    lane_vel_kernel<DIM, NP, NFP><<<blocks, kThreads, 0, stream>>>(a);
    return (int)cudaGetLastError();
  }
  return a.cmat != nullptr ? launch_stress<DIM, NP, NFP, true>(a, stream)
                           : launch_stress<DIM, NP, NFP, false>(a, stream);
}

// Every (dim, n_p, n_fp) of SEIGEN_DISPATCH_SHAPES; -1 for another shape,
// -2 for a mode the operator does not have, a SEL launch without its
// tables, K4 with a stiffness, isotropic K5 without its material rows or
// K5 without its tile table.
int dispatch(int op, const LaneArgs* a, int dim, int n_p, int n_fp,
             void* stream) {
  const int sel = op == 0 ? (int)kVelSel : (int)kStressSel;
  if (a->mode < 0 || a->mode > sel) return -2;
  if (a->mode == sel && (a->combo == nullptr || a->perms == nullptr ||
                         a->G < 1 || a->G > kMaxPerms || a->cstride < 1 ||
                         (op == 0 && a->sign == nullptr)))
    return -2;
  const bool iso_rows = a->mat0 != nullptr && a->mat1 != nullptr;
  if (op == 0 ? a->cmat != nullptr
              : ((a->cmat == nullptr && !iso_rows) || a->tab == nullptr))
    return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SEIGEN_LAUNCH(D, P, F) return launch<D, P, F>(op, *a, s)
  SEIGEN_DISPATCH_SHAPES(dim, n_p, n_fp, SEIGEN_LAUNCH)
#undef SEIGEN_LAUNCH
}

}  // namespace

extern "C" {

// sizeof(LaneArgs), so the binding can check its mirror of the struct.
int seigen_lane_args_size() { return (int)sizeof(LaneArgs); }

// K4. Returns cudaGetLastError() after the launch, -1 for an element shape
// without an instantiation, -2 for a bad mode.
int seigen_lane_vel(const LaneArgs* a, int dim, int n_p, int n_fp,
                    void* stream) {
  return dispatch(0, a, dim, n_p, n_fp, stream);
}

// K5. Same contract as seigen_lane_vel; a->cmat != null launches the general
// Hooke law.
int seigen_lane_stress(const LaneArgs* a, int dim, int n_p, int n_fp,
                       void* stream) {
  return dispatch(1, a, dim, n_p, n_fp, stream);
}

}  // extern "C"
