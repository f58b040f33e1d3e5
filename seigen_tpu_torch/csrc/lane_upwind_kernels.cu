// Coupled upwind (Godunov) RHS on unstructured lane-major state for Hopper
// (sm_90a): K6 lane_upwind_rhs, K7 lane_upwind_axpy.
//
// Replaces the JAX package's Pallas kernels of the unstructured upwind-RK4
// runner, seigen_tpu/ops/pallas_kernels.py:
//   K6 lane_upwind_rhs   <- upwind_rhs_lm_sel       (_upwind_kernel_sel)
//   K7 lane_upwind_axpy  <- upwind_rhs_lm_sel_axpy  (_upwind_kernel_sel_axpy)
// both over the body _upwind_rows_sel.  The physics is the JAX kernels';
// the TPU layout devices (lane blocks, MXU [Dr; R] products, the
// where-chain over statically permuted panel views, RK4 coefficients baked
// in as immediates, the wavelet value as an (8, E) array) are gone.  The
// plus-side velocity and traction of face f come from two raw panel arrays
// through the lane's combo code (lane_select.cuh), times the per-face sign
// rows, which carry the ghost coefficients on self-paired boundary faces
// (+1 / -1 inside).  Then, as K3 (upwind_kernels.cu) and with its Riemann
// states (merged_common.cuh):
//   du = (1/rho)(div sigma + LIFT(Fscale (t* - t-)))
//   ds = Hooke(grad u) + LIFT(Fscale Hooke_f(u* - u-))
// K6 writes [du; ds].  K7 adds the dense source groups (k += r_g S_g) and
// writes the RK4 epilogue instead:
//   stage mode  [ub + cs du; sb + cs ds; au + wa du; as + wa ds]
//   final mode  [au + wa du; as + wa ds], times the sponge row when given
// and with emit, after them, the own-face panels of the state it emitted
// (stage mode: the next stage input; final mode: the damped update):
//   TU rows c*ftpp + f*n_fp + k = u'_c at the face node
//   TT rows c*ftpp + f*n_fp + k = sum_d n_d s'_{V[c,d]} (own normals)
// pad rows zero, so the next launch needs only the nf lane takes of them.
// Outputs never alias inputs (stage 1 passes one tensor as stage input,
// base and accumulator; the wrapper allocates a fresh output).
//
// What bounds it on the H100.  Per lane at 3D P3 the compulsory traffic of
// K6 is ~690 floats (u 60, sigma 120, two panels' selected rows 240,
// geometry, impedance, combo and sign rows ~50 in; 216 out), ~0.23 GB a
// launch at E = 83k, ~68 us at 3.35 TB/s; K7 reads the base and the
// accumulator and writes twice as much in stage mode (~1270 floats, ~126
// us).  The arithmetic is ~36 kFLOP per lane with one Dr pass per output
// component, ~20 kFLOP after the tile kernel's reorder, ~30 us at the 67
// TFLOP/s FP32 rate: bytes bound.
//
// Both run the tile kernel of upwind_tile.cuh, designed for this card as
// K1/K2's (merged_tile.cuh); a compile-time bool AXPY picks K7's epilogue
// or K6's plain store, so neither instantiation carries the other's code:
//   - A block owns a tile of T consecutive lanes (T 32 at 3D P2-P4 and 2D
//     P3-P4, 64 or 128 below, for at least four warps a block; the last
//     tile ragged at E) and stages, by cp.async into dynamic shared memory,
//     the table, the live rows of u and sigma, the per-lane geometry
//     (Ginv, and of each face its first face-node row of the normals,
//     Fscale and neighbour impedances, its two sign rows) and the selected
//     panel rows: each lane copies its own rows f*rows_pad + c*cstride +
//     g*n_fp + perms[pi][k] of its own column, 4 bytes a copy, the
//     permutation applied as they are fetched.  Within a tile a face's
//     combo code takes one to three values, so the lanes' rows share
//     sectors; staging every candidate row of a panel would read nf times
//     as many bytes.  At 3D P3 a block is 320 threads and ~74 KB.
//   - The Riemann corrections overwrite the selected rows in place, then
//     sigma's rows are contracted with Ginv in place (w_rc), and the
//     products are register-tiled over (node group, lane) on the transposed
//     table (KernelTables.tile, LaneOpData.ktile): velocity [Dr | LIFT] @
//     [w; dtf], stress gradient-first with the face term factored per
//     face, as K1/K2.
//   - The epilogue runs on a thread's own nodes in registers and stores
//     coalesced rows: K6 the operator values (pad rows 0); K7 the sources,
//     stage/final axpys and sponge row, and with emit the emitted state
//     goes to shared memory and the panels are written from there.
//   - No local memory: ptxas shows a 0 B stack and no spills at every
//     shape (chip_smoke.py phase 2).  FP32 FFMA throughout.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (seigen_tpu_torch/ops/cuda_build.py, at first use).

#include <cuda_runtime.h>

#include <cstdint>

#include "lane_select.cuh"
#include "merged_common.cuh"
#include "upwind_tile.cuh"

// Kernel arguments; mirrored field by field by the ctypes Structure
// LaneUpwindArgs in seigen_tpu_torch/ops/lane_upwind_kernels.py.  Lane rows
// are (rows, E) row-major: element L of row r at r*E + L.
struct LaneUpwindArgs {
  const float* u;       // (dim*npp, E) velocity
  const float* s;       // (n_sig*npp, E) stress (Voigt)
  const float* pu;      // (nf*rows_pad, E) raw velocity panels
  const float* pt;      // (nf*rows_pad, E) raw traction panels
  const int* combo;     // (8, E) row f = g*G + pi
  const float* sign_u;  // (8, E) row f: ghost_u on boundary faces, else +1
  const float* sign_t;  // (8, E) row f: ghost_t on boundary faces, else -1
  const int* perms;     // (G, n_fp) node permutations
  const float* ginv;    // (dim*dim, E) rows r*dim + d
  const float* nrm;     // (dim*ftpp, E) face-node-expanded normals
  const float* fsc;     // (ftpp, E) face-node-expanded Fscale
  const float* irho;    // (8, E) row 0 = 1/rho
  const float* lam;     // (8, E) row 0 = lambda
  const float* mu;      // (8, E) row 0 = mu
  const float* zpn;     // (ftpp, E) face-node-expanded neighbour Zp
  const float* zsn;     // (ftpp, E) face-node-expanded neighbour Zs
  const float* zown;    // (8, E) rows 0/1 = own Zp/Zs
  const float* base_u;  // K7 stage mode: step base state; else null
  const float* base_s;
  const float* acc_u;   // K7: running RK4 accumulator
  const float* acc_s;
  const float* damp;    // K7 final mode: (npp, E) sponge row, or null
  const float* inj_u0;  // K7 dense source group 0: du pattern; else null
  const float* inj_s0;
  const float* inj_u1;  // K7 dense source group 1
  const float* inj_s1;
  const int* fnodes;    // (nf, n_fp) volume node of each face node
  const float* tab;     // the tile table (LaneOpData.ktile): rows
                        // j*dim + r = Dr_r[., j], dim*n_p + q = LIFT[., q],
                        // n_p padded to a multiple of 4
  float* out;           // K6 ((dim+n_sig)*npp, E); K7 see above
  long long E;          // lanes (elements)
  int npp;              // node rows per component (n_p rounded up to 8)
  int ftpp;             // trace rows per component (nf*n_fp rounded up to 8)
  int rows_pad;         // panel rows per face
  int cstride;          // panel rows per component
  int G;                // orientation groups (<= kMaxPerms)
  int stage;            // K7: 1 stage mode, 0 final mode
  int n_inj;            // K7: 0, 1 or 2 dense source groups
  int emit;             // K7: 1 appends the own-face panels
  float cs, wa;         // K7: stage and accumulator coefficients
  float r0, r1;         // K7: wavelet values of the source groups
};

namespace {

using namespace seigen;

// ------------------------------------------------------- K6/K7, tiled ---
template <int DIM, int NP, int NFP>
using TileLayout = uptile::Layout<DIM, NP, NFP, false>;

// Global row (at lane 0) of local geo row r: the face rows are the first
// face-node row f*n_fp of the expanded sections.
template <class LY>
__device__ __forceinline__ const float* tile_geo_row(const LaneUpwindArgs& a,
                                                     int r) {
  constexpr int NF = LY::NF, NFP = LY::NFP;
  const long long E = a.E;
  if (r < LY::G_NRM) return a.ginv + r * E;
  if (r < LY::G_FSC) {
    const int q = r - LY::G_NRM;
    return a.nrm + ((long long)(q / NF) * a.ftpp + (q % NF) * NFP) * E;
  }
  if (r < LY::G_ZPN) return a.fsc + (long long)(r - LY::G_FSC) * NFP * E;
  if (r < LY::G_ZSN) return a.zpn + (long long)(r - LY::G_ZPN) * NFP * E;
  if (r < LY::G_GU) return a.zsn + (long long)(r - LY::G_ZSN) * NFP * E;
  if (r < LY::G_GT) return a.sign_u + (long long)(r - LY::G_GU) * E;
  if (r < LY::G_MAT) return a.sign_t + (long long)(r - LY::G_GT) * E;
  if (r == LY::G_MAT) return a.irho;
  if (r == LY::G_MAT + 1) return a.lam;
  if (r == LY::G_MAT + 2) return a.mu;
  return a.zown + (long long)(r - LY::G_ZOWN) * E;
}

// The selected panel rows of this thread's lane: u+ to NB rows c*NFT + q,
// t+ to (DIM + c)*NFT + q, node slot perms[pi][k] read into slot k.
template <class LY>
__device__ __forceinline__ void stage_panels(const LaneUpwindArgs& a,
                                             const uptile::Tile& tl,
                                             float* sm) {
  constexpr int DIM = LY::DIM, NFP = LY::NFP, NFT = LY::NFT, T = LY::T;
  const long long E = a.E;
  float* dst = sm + LY::OFF_NB + tl.l;
#pragma unroll 1
  for (int f = 0; f < LY::NF; ++f) {
    const int code = __ldg(a.combo + f * E + tl.own);
    const int g = code / a.G, pi = code - g * a.G;
    const long long rb = (long long)f * a.rows_pad + g * NFP;
    const int* perm = a.perms + pi * NFP;
    for (int rr = tl.ig; rr < 2 * DIM * NFP; rr += LY::NG) {
      const int w = rr / (DIM * NFP), c = rr / NFP % DIM, k = rr % NFP;
      const float* src = (w ? a.pt : a.pu) +
                         (rb + (long long)c * a.cstride + __ldg(perm + k)) * E +
                         tl.own;
      tile::cp_async4(dst + ((w * DIM + c) * NFT + f * NFP + k) * T, src);
    }
  }
}

// The epilogue of one block of C components (blk 0: u, 1: sigma) on this
// thread's nodes: sources, then stage mode [base + cs k | acc + wa k] or
// final mode (acc + wa k) * sponge; v becomes the emitted state.  The pad
// rows npp > NP take the epilogue of k = 0.
template <class LY, int C>
__device__ __forceinline__ void k7_finish(const LaneUpwindArgs& a,
                                          const uptile::Tile& tl, int i0,
                                          float (&v)[C][LY::RM], int blk) {
  constexpr int RM = LY::RM, NP = LY::NP;
  if (!tl.live) return;
  const long long E = a.E, L = tl.lane0 + tl.l;
  const int npp = a.npp;
  const size_t o = blk ? (size_t)LY::DIM * npp * E : 0;
  const size_t half = (size_t)(LY::DIM + LY::NSIG) * npp * E;
  const float* s0p = blk ? a.inj_s0 : a.inj_u0;
  const float* s1p = blk ? a.inj_s1 : a.inj_u1;
  const float* accp = blk ? a.acc_s : a.acc_u;
  const float* basep = blk ? a.base_s : a.base_u;
  const bool stage = a.stage != 0;
  const bool damp = !stage && a.damp != nullptr;
  auto finish = [&](float k, size_t idx, int i, float x0, float x1, float s0,
                    float s1) {
    if (a.n_inj > 0) k += a.r0 * s0;
    if (a.n_inj > 1) k += a.r1 * s1;
    float e;
    if (stage) {
      e = x1 + a.cs * k;
      a.out[o + half + idx] = x0 + a.wa * k;
    } else {
      e = x0 + a.wa * k;
      if (damp) e *= __ldg(a.damp + (size_t)i * E + L);
    }
    a.out[o + idx] = e;
    return e;
  };
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float x0[RM], x1[RM], s0[RM], s1[RM];
#pragma unroll
    for (int ii = 0; ii < RM; ++ii) {
      const size_t idx = ((size_t)c * npp + i0 + ii) * E + L;
      const bool in = i0 + ii < NP;
      x0[ii] = in ? __ldg(accp + idx) : 0.f;
      x1[ii] = in && stage ? __ldg(basep + idx) : 0.f;
      s0[ii] = in && a.n_inj > 0 ? __ldg(s0p + idx) : 0.f;
      s1[ii] = in && a.n_inj > 1 ? __ldg(s1p + idx) : 0.f;
    }
#pragma unroll
    for (int ii = 0; ii < RM; ++ii)
      if (i0 + ii < NP)
        v[c][ii] = finish(v[c][ii], ((size_t)c * npp + i0 + ii) * E + L,
                          i0 + ii, x0[ii], x1[ii], s0[ii], s1[ii]);
  }
  const int pad = npp - NP;
  for (int r = tl.ig; r < C * pad; r += LY::NG) {
    const int i = NP + r % pad;
    const size_t idx = ((size_t)(r / pad) * npp + i) * E + L;
    finish(0.f, idx, i, accp[idx], stage ? basep[idx] : 0.f,
           a.n_inj > 0 ? s0p[idx] : 0.f, a.n_inj > 1 ? s1p[idx] : 0.f);
  }
}

// The own-face panels of the emitted state from the output tile: TU rows
// c*ftpp + q = u_c, TT rows c*ftpp + q = n . sigma, pad rows 0.
template <class LY>
__device__ __forceinline__ void k7_emit(const LaneUpwindArgs& a,
                                        const uptile::Tile& tl,
                                        const float* sm) {
  constexpr int DIM = LY::DIM, NFT = LY::NFT;
  if (!tl.live) return;
  const long long E = a.E, L = tl.lane0 + tl.l;
  const int ftpp = a.ftpp;
  float* TU = a.out +
              (size_t)(a.stage ? 2 : 1) * (DIM + LY::NSIG) * a.npp * E + L;
  float* TT = TU + (size_t)DIM * ftpp * E;
  for (int q = tl.ig; q < NFT; q += LY::NG) {
    float uq[DIM], tq[DIM];
    uptile::face_values<LY>(tl, sm, q, uq, tq);
#pragma unroll
    for (int c = 0; c < DIM; ++c) {
      TU[(size_t)(c * ftpp + q) * E] = uq[c];
      TT[(size_t)(c * ftpp + q) * E] = tq[c];
    }
  }
  const int pad = ftpp - NFT;
  for (int r = tl.ig; r < 2 * DIM * pad; r += LY::NG) {
    const int c = r / pad % DIM, q = NFT + r % pad;
    (r < DIM * pad ? TU : TT)[(size_t)(c * ftpp + q) * E] = 0.f;
  }
}

// K6's epilogue: the operator values of one block of C components (blk 0:
// u, 1: sigma) on this thread's nodes to out, and its share of the pad rows
// npp > NP as zeros.
template <class LY, int C>
__device__ __forceinline__ void k6_store(const LaneUpwindArgs& a,
                                         const uptile::Tile& tl, int i0,
                                         const float (&v)[C][LY::RM],
                                         int blk) {
  constexpr int NP = LY::NP;
  if (!tl.live) return;
  const long long E = a.E;
  const int npp = a.npp;
  float* out = a.out + (blk ? (size_t)LY::DIM * npp * E : 0) + tl.lane0 + tl.l;
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int ii = 0; ii < LY::RM; ++ii)
      if (i0 + ii < NP) out[((size_t)c * npp + i0 + ii) * E] = v[c][ii];
  const int pad = npp - NP;
  for (int r = tl.ig; r < C * pad; r += LY::NG)
    out[((size_t)(r / pad) * npp + NP + r % pad) * E] = 0.f;
}

// One block per tile of T lanes; AXPY: K7, else K6.
template <int DIM, int NP, int NFP, bool AXPY>
__global__ void __launch_bounds__(TileLayout<DIM, NP, NFP>::THREADS)
lane_upwind_tile_kernel(const LaneUpwindArgs a) {
  using LY = TileLayout<DIM, NP, NFP>;
  constexpr int RM = LY::RM, NSIG = LY::NSIG;
  extern __shared__ float4 s_dyn[];
  float* sm = reinterpret_cast<float*>(s_dyn);
  const uptile::Tile tl = uptile::make_tile<LY>(a.E);
  const uintptr_t ptrs =
      (uintptr_t)a.u | (uintptr_t)a.s | (uintptr_t)a.ginv | (uintptr_t)a.nrm |
      (uintptr_t)a.fsc | (uintptr_t)a.zpn | (uintptr_t)a.zsn |
      (uintptr_t)a.sign_u | (uintptr_t)a.sign_t | (uintptr_t)a.irho |
      (uintptr_t)a.lam | (uintptr_t)a.mu | (uintptr_t)a.zown;
  const bool vec = tl.nvalid == LY::T && (a.E & 3) == 0 && (ptrs & 15) == 0;
  uptile::stage_state<LY>(tl, sm, a.u, a.s, a.tab, a.fnodes, a.npp, a.E, vec,
                          [&](int r) { return tile_geo_row<LY>(a, r); });
  stage_panels<LY>(a, tl, sm);
  uptile::finish_stage();
  uptile::riemann<LY>(tl, sm);
  uptile::contract_sigma<LY>(tl, sm);
  const int i0 = tl.ig * RM;
  float v[DIM][RM], sig[NSIG][RM];
  uptile::vel_product<LY>(tl, sm, i0, v);
  if constexpr (AXPY)
    k7_finish<LY, DIM>(a, tl, i0, v, 0);
  else
    k6_store<LY, DIM>(a, tl, i0, v, 0);
  uptile::stress_product<LY>(tl, sm, i0, sig);
  if constexpr (AXPY) {
    k7_finish<LY, NSIG>(a, tl, i0, sig, 1);
    if (a.emit) {
      uptile::store_out_tile<LY>(tl, sm, i0, v, sig);
      k7_emit<LY>(a, tl, sm);
    }
  } else {
    k6_store<LY, NSIG>(a, tl, i0, sig, 1);
  }
}

// The dynamic shared memory is raised above 48 KB once per instantiation;
// an error there is returned like a launch error.
template <int DIM, int NP, int NFP, bool AXPY>
int launch_tile(const LaneUpwindArgs& a, cudaStream_t stream) {
  using LY = TileLayout<DIM, NP, NFP>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      lane_upwind_tile_kernel<DIM, NP, NFP, AXPY>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, LY::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  const unsigned blocks = (unsigned)((a.E + LY::T - 1) / LY::T);
  lane_upwind_tile_kernel<DIM, NP, NFP, AXPY>
      <<<blocks, LY::THREADS, LY::BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int DIM, int NP, int NFP>
int launch(bool axpy, const LaneUpwindArgs& a, cudaStream_t stream) {
  return axpy ? launch_tile<DIM, NP, NFP, true>(a, stream)
              : launch_tile<DIM, NP, NFP, false>(a, stream);
}

// Every (dim, n_p, n_fp) of SEIGEN_DISPATCH_SHAPES; -1 for another shape,
// -2 for arguments the kernel does not take.
int dispatch(bool axpy, const LaneUpwindArgs* a, int dim, int n_p, int n_fp,
             void* stream) {
  if (a->combo == nullptr || a->perms == nullptr || a->sign_u == nullptr ||
      a->sign_t == nullptr || a->tab == nullptr || a->G < 1 ||
      a->G > kMaxPerms || a->cstride < 1)
    return -2;
  if (axpy) {
    if (a->acc_u == nullptr || a->acc_s == nullptr) return -2;
    if (a->stage && (a->base_u == nullptr || a->base_s == nullptr ||
                     a->damp != nullptr))
      return -2;
    if (a->n_inj < 0 || a->n_inj > 2) return -2;
    if (a->n_inj > 0 && (a->inj_u0 == nullptr || a->inj_s0 == nullptr)) return -2;
    if (a->n_inj > 1 && (a->inj_u1 == nullptr || a->inj_s1 == nullptr)) return -2;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SEIGEN_LAUNCH(D, P, F) return launch<D, P, F>(axpy, *a, s)
  SEIGEN_DISPATCH_SHAPES(dim, n_p, n_fp, SEIGEN_LAUNCH)
#undef SEIGEN_LAUNCH
}

}  // namespace

extern "C" {

// sizeof(LaneUpwindArgs), so the binding can check its mirror of the struct.
int seigen_lane_upwind_args_size() { return (int)sizeof(LaneUpwindArgs); }

// K6. Returns cudaGetLastError() after the launch, -1 for an element shape
// without an instantiation, -2 for bad arguments.
int seigen_lane_upwind_rhs(const LaneUpwindArgs* a, int dim, int n_p, int n_fp,
                           void* stream) {
  return dispatch(false, a, dim, n_p, n_fp, stream);
}

// K7. Same contract as seigen_lane_upwind_rhs.
int seigen_lane_upwind_axpy(const LaneUpwindArgs* a, int dim, int n_p, int n_fp,
                            void* stream) {
  return dispatch(true, a, dim, n_p, n_fp, stream);
}

}  // extern "C"
