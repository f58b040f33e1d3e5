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
// Both are tile kernels on the cores of the merged operators
// (merged_tile.cuh): K4 on K1/K8's velocity core (vel_core), K5 on
// K2/K9's stress core (stress_core), designed for this card as those are.
// A block owns a tile of T consecutive lanes of the one class of all E
// lanes (T 32 at 3D P2-P4 and 2D P3-P4, 64 or 128 below; the last tile
// ragged at E) and stages by cp.async (stage_lane, shared by both) the
// table (LaneOpData.ktile), the input's live rows (K4: sigma at the rows
// j*WS + m where the w contraction overwrites it in place), the per-lane
// geometry of the lane layout (Ginv; of each face its first face-node row
// of the normals, Fscale and beta or delta; 1/rho, lambda and mu, or the
// n_sig^2 C rows; K4 TRAC and SEL a sign row per face, 1 outside SEL) and
// the neighbour's traces: TRAC and TR the lane's own rows c*ftpp + q, SIG
// its n_sig sigma trace rows m*ftpp + q (contracted with the own normals
// in the flux step), all 16 bytes a copy in a whole aligned tile, else 4
// bytes; SEL each lane's selected panel rows, 4 bytes a copy with the
// permutation applied at fetch (K6/K7's staging).  K4 SIG has its own
// compile-time layout, whose neighbour section holds n_sig rows a face
// node (57 240 B a block at 3D P3), so that TRAC and SEL keep the dim rows
// of K1's (46 232 B).
// The products are register-tiled: K4 one [Dr | LIFT] product per
// component over w and the flux, K5 gradient-first with the face term
// factored per face.  The values go from registers to coalesced rows, pad
// rows 0; no emission.  No local memory: ptxas shows a 0 B stack and no
// spills at every shape (chip_smoke.py phase 2).  FP32 FFMA throughout.
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
  const int* fnodes;   // (nf, n_fp) volume node of each face node
  float* out;          // (C*npp, E)
  long long E;         // lanes (elements)
  int npp;             // node rows per component (n_p rounded up to 8)
  int ftpp;            // trace rows per component (nf*n_fp rounded up to 8)
  int rows_pad;        // SEL: panel rows per face; else 0
  int cstride;         // SEL: panel rows per component; else 0
  int G;               // SEL: orientation groups (<= kMaxPerms); else 0
  int mode;            // K4: 0 SIG, 1 TRAC, 2 SEL; K5: 0 TR, 1 SEL
  const float* tab;    // the tile table (LaneOpData.ktile): rows j*dim + r
                       // = Dr_r[., j], dim*n_p + q = LIFT[., q], n_p padded
                       // to a multiple of 4
};

namespace {

using namespace seigen;

enum { kVelSig = 0, kVelTrac = 1, kVelSel = 2 };
enum { kStressTr = 0, kStressSel = 1 };

// The lane tiles: K4 on the velocity core, TRAC and SEL in one layout
// (SIGN) and SIG in its own (SIGTR); K5 on the stress core, both Hooke
// laws.  K4's flux is Fscale (1/2 t+ + beta t-), K5's jump Fscale (1/2 u+ +
// delta u-): the cores' LANE terms, no mask (a boundary face's neighbour
// value is whatever the exchange wrote, as the plain versions read it).
template <int DIM, int NP, int NFP, bool SIGTR>
using VelLayout =
    tile::Layout<DIM, NP, NFP, true, false, true, 1, true, SIGTR>;
template <int DIM, int NP, int NFP, bool ANISO>
using StressLayout = tile::Layout<DIM, NP, NFP, false, ANISO, true, 1, true>;

// Global row (at lane 0) of a lane tile's local geo row r: Ginv; normals,
// Fscale and beta or delta of each face at its first face-node row (the
// expanded rows are constant over a face); K4 TRAC/SEL: the sign rows
// (staged only in SEL); 1/rho (row 0 of mat0), lambda and mu (row 0 of
// mat0, mat1) or C[k][m] (cmat row 8*k + m).
template <class LY>
__device__ __forceinline__ const float* lane_geo_row(const LaneArgs& a,
                                                     int r) {
  constexpr int NF = LY::NF, NFP = LY::NFP;
  const long long E = a.E;
  if (r < LY::G_NRM) return a.ginv + r * E;
  if (r < LY::G_SCB) {
    const int q = r - LY::G_NRM;
    return a.nrm + ((long long)(q / NF) * a.ftpp + (q % NF) * NFP) * E;
  }
  if (r < LY::G_BFS) return a.fsc + (long long)(r - LY::G_SCB) * NFP * E;
  if (r < LY::G_MASK) return a.coef + (long long)(r - LY::G_BFS) * NFP * E;
  if (r < LY::G_MAT) return a.sign + (long long)(r - LY::G_MASK) * E;
  const int q = r - LY::G_MAT;
  if constexpr (LY::ANISO)
    return a.cmat + (long long)(8 * (q / LY::NSIG) + q % LY::NSIG) * E;
  return q == 0 ? a.mat0 : a.mat1;
}

// The block's tile of the one class of all E lanes.
template <class LY>
__device__ __forceinline__ tile::Tile lane_tile(const LaneArgs& a) {
  tile::Tile tl;
  tl.t = 0, tl.par = 0;
  tl.j0 = (int)blockIdx.x * LY::T;
  tl.nvalid = (int)min((long long)LY::T, a.E - tl.j0);
  tl.l = (int)threadIdx.x % LY::T;
  tl.ig = (int)threadIdx.x / LY::T;
  tl.lane0 = tl.j0;
  tl.live = tl.l < tl.nvalid;
  return tl;
}

// Stage a lane tile by cp.async: the table and the face nodes; the input's
// live rows, the geo rows and the neighbour's trace rows t = c*NFT + q at
// rows c*ftpp + q (TR, TRAC; SIG: its NSIG sigma components) or, in K4
// SEL, the sign rows, 16 bytes a copy when the tile is whole and its rows
// are 16-byte aligned, else 4 bytes, lanes past nvalid loading the last
// live lane; (SEL) each lane's selected panel rows f*rows_pad + g*n_fp +
// c*cstride + perms[pi][k], (g, pi) decoded from its combo code
// (lane_select.cuh), 4 bytes a copy.  K4 TRAC writes its sign rows 1.
// Shared-memory rows as tile::Layout: the input at IN rows in_row(c*NP +
// j) (K4: j*WS + m, K5: c*NP + j), the neighbour's traces at NB rows
// c*NFT + q.
template <class LY>
__device__ __forceinline__ void stage_lane(const LaneArgs& a,
                                           const tile::Tile& tl, float* sm) {
  constexpr int NP = LY::NP, NFP = LY::NFP, NFT = LY::NFT, T = LY::T;
  constexpr int NG = LY::NG, NIN = LY::CIN * NP, Q = T / 4;
  // the geo rows staged with the input: all but K4's sign rows
  constexpr int NSGN = LY::SIGN ? LY::NF : 0, NGEO = LY::GR - NSGN;
  const long long E = a.E;
  int* s_fn = reinterpret_cast<int*>(sm + LY::OFF_INT);
  for (int e = threadIdx.x; e < NFT; e += LY::THREADS) s_fn[e] = a.fnodes[e];
  for (int e = threadIdx.x; e < LY::KA * LY::NPI / 4; e += LY::THREADS)
    tile::cp_async16(sm + LY::OFF_A + 4 * e, a.tab + 4 * e);
  const bool by_tr = LY::VEL ? a.mode != kVelSel : a.mode == kStressTr;
  const bool by_sign = LY::SIGN && !by_tr;
  auto geo_local = [&](int g) { return g < LY::G_MASK ? g : g + NSGN; };
  auto dst = [&](int r) {
    if (r < NIN) return sm + LY::OFF_IN + tile::in_row<LY>(r) * T;
    if (r < NIN + NGEO) return sm + LY::OFF_GEO + geo_local(r - NIN) * T;
    const int t = r - NIN - NGEO;
    if (by_sign) return sm + LY::OFF_GEO + (LY::G_MASK + t) * T;
    return sm + LY::OFF_NB + t * T;
  };
  auto src = [&](int r) {
    if (r < NIN) return a.field + ((long long)(r / NP) * a.npp + r % NP) * E;
    if (r < NIN + NGEO) return lane_geo_row<LY>(a, geo_local(r - NIN));
    const int t = r - NIN - NGEO;  // c*NFT + q, or the sign row
    if (by_sign) return a.sign + (long long)t * E;
    return a.tr + ((long long)(t / NFT) * a.ftpp + t % NFT) * E;
  };
  const int NR =
      NIN + NGEO + (by_tr ? LY::NBC * NFT : (by_sign ? NSGN : 0));
  const uintptr_t ptrs =
      (uintptr_t)a.field | (uintptr_t)a.ginv | (uintptr_t)a.nrm |
      (uintptr_t)a.fsc | (uintptr_t)a.coef | (uintptr_t)a.mat0 |
      (uintptr_t)a.mat1 | (uintptr_t)a.cmat | (by_tr ? (uintptr_t)a.tr : 0) |
      (by_sign ? (uintptr_t)a.sign : 0);
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
  if (LY::SIGN && by_tr)
    for (int f = tl.ig; f < LY::NF; f += NG)
      sm[LY::OFF_GEO + (LY::G_MASK + f) * T + tl.l] = 1.f;
  if (!by_tr) {
#pragma unroll 1
    for (int f = 0; f < LY::NF; ++f) {
      const int code = __ldg(a.combo + f * E + own);
      const int g = code / a.G, pi = code - g * a.G;
      const long long rb = (long long)f * a.rows_pad + g * NFP;
      const int* perm = a.perms + pi * NFP;
      for (int rr = tl.ig; rr < LY::DIM * NFP; rr += NG) {
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

// The values of this thread's nodes to rows k*npp + i0 + ii, and the pad
// rows n_p..npp-1 of its lane 0.
template <class LY, int C>
__device__ __forceinline__ void store_lane(const LaneArgs& a,
                                           const tile::Tile& tl,
                                           const float (&v)[C][LY::RM]) {
  constexpr int NP = LY::NP;
  if (!tl.live) return;
  const int i0 = tl.ig * LY::RM;
  const long long E = a.E;
  const int npp = a.npp, pad = npp - NP;
  float* out = a.out + tl.lane0 + tl.l;
#pragma unroll
  for (int k = 0; k < C; ++k)
#pragma unroll
    for (int ii = 0; ii < LY::RM; ++ii)
      if (i0 + ii < NP) out[((size_t)k * npp + i0 + ii) * E] = v[k][ii];
  for (int r = tl.ig; r < C * pad; r += LY::NG)
    out[((size_t)(r / pad) * npp + NP + r % pad) * E] = 0.f;
}

// ---------------------------------------------------------------- K4 ---
// du_c = (1/rho) (sum_{r,d} Ginv[r,d] Dr_r sigma_{V[c,d]}
//                 + LIFT (Fscale (1/2 t+_c + beta t-_c)))
// t-_c = n_d sigma_{V[c,d]} at the face nodes (own normals); t+_c from
// the mode: SIG n_d tr_{V[c,d]}, TRAC tr_c, SEL sign * panel row.  One
// block per tile of T lanes.
template <int DIM, int NP, int NFP, bool SIGTR>
__global__ void __launch_bounds__(VelLayout<DIM, NP, NFP, SIGTR>::THREADS)
lane_vel_tile_kernel(const LaneArgs a) {
  using LY = VelLayout<DIM, NP, NFP, SIGTR>;
  extern __shared__ float4 s_dyn[];
  float* sm = reinterpret_cast<float*>(s_dyn);
  const tile::Tile tl = lane_tile<LY>(a);
  stage_lane<LY>(a, tl, sm);
  float v[DIM][LY::RM];
  tile::vel_core<LY>(tl, sm, v);
  store_lane<LY>(a, tl, v);
}

// ---------------------------------------------------------------- K5 ---
// ds_k = sum_{d,c} A_k[d,c] (du_c/dx_d) + LIFT(Fscale sum_{d,c} A_k[d,c] n_d du*_c)
// with A the Hooke tensor in Voigt row k — isotropic (lambda, mu), or with
// ANISO the lane's general Voigt stiffness, A_k[d,c] = C[k][voigt(c,d)] —
// and du*_c = 1/2 u+_c + delta u-_c (u+ from the mode: TR traces, SEL
// panels).  One block per tile of T lanes.
template <int DIM, int NP, int NFP, bool ANISO>
__global__ void __launch_bounds__(StressLayout<DIM, NP, NFP, ANISO>::THREADS)
lane_stress_tile_kernel(const LaneArgs a) {
  using LY = StressLayout<DIM, NP, NFP, ANISO>;
  extern __shared__ float4 s_dyn[];
  float* sm = reinterpret_cast<float*>(s_dyn);
  const tile::Tile tl = lane_tile<LY>(a);
  stage_lane<LY>(a, tl, sm);
  float sig[LY::NSIG][LY::RM];
  tile::stress_core<LY>(tl, sm, sig);
  store_lane<LY>(a, tl, sig);
}

// The dynamic shared memory of a tile kernel is raised above 48 KB once
// per instantiation; an error there is returned like a launch error.
template <class LY, class Kernel>
int launch_tile(Kernel kernel, const LaneArgs& a, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, LY::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  const unsigned blocks = (unsigned)((a.E + LY::T - 1) / LY::T);
  kernel<<<blocks, LY::THREADS, LY::BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int DIM, int NP, int NFP>
int launch(int op, const LaneArgs& a, cudaStream_t stream) {
  if (op == 0)
    return a.mode == kVelSig
               ? launch_tile<VelLayout<DIM, NP, NFP, true>>(
                     lane_vel_tile_kernel<DIM, NP, NFP, true>, a, stream)
               : launch_tile<VelLayout<DIM, NP, NFP, false>>(
                     lane_vel_tile_kernel<DIM, NP, NFP, false>, a, stream);
  return a.cmat != nullptr
             ? launch_tile<StressLayout<DIM, NP, NFP, true>>(
                   lane_stress_tile_kernel<DIM, NP, NFP, true>, a, stream)
             : launch_tile<StressLayout<DIM, NP, NFP, false>>(
                   lane_stress_tile_kernel<DIM, NP, NFP, false>, a, stream);
}

// Every (dim, n_p, n_fp) of SEIGEN_DISPATCH_SHAPES; -1 for another shape,
// -2 for a mode the operator does not have, a SEL launch without its
// tables, K4 with a stiffness, isotropic K5 without its material rows or
// either without its tile table.
int dispatch(int op, const LaneArgs* a, int dim, int n_p, int n_fp,
             void* stream) {
  const int sel = op == 0 ? (int)kVelSel : (int)kStressSel;
  if (a->mode < 0 || a->mode > sel) return -2;
  if (a->mode == sel && (a->combo == nullptr || a->perms == nullptr ||
                         a->G < 1 || a->G > kMaxPerms || a->cstride < 1 ||
                         (op == 0 && a->sign == nullptr)))
    return -2;
  const bool iso_rows = a->mat0 != nullptr && a->mat1 != nullptr;
  if (a->tab == nullptr ||
      (op == 0 ? a->cmat != nullptr : a->cmat == nullptr && !iso_rows))
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
