// Coupled upwind (Godunov) RHS for Hopper (sm_90a): K3 upwind_rhs.
//
// Replaces the JAX package's Pallas kernel of the upwind-RK4 lane path,
// seigen_tpu/ops/upwind_kernels.py:upwind_rhs_merged, issued per class by
// merged_kernels.py:_class_call_multi -> _merged_kernel with the body
// upwind_kernels.py:_upwind_body.  The physics is the same; the TPU layout
// devices (per-class pallas_calls, lane blocks and their windows, one-hot
// MXU permutation and expansion matmuls, bf16 three-pass dots) are gone.
// One launch covers all classes, and the neighbour's (velocity, traction)
// payload trace is read at trace lane t2*NCt + h0 + j + s (a slab's halo
// lanes included: NCt = NC + 2*h0 on a sharded plan, NC and h0 = 0
// otherwise), rows f2*rtf + c*n_fp + pi[k]
// (velocity, sign +1) and f2*rtf + (dim + c)*n_fp + pi[k] (traction, sign
// -1).
//
// Per lane: exchange (boundary faces take the own trace, then the ghost
// coefficients gu/gt multiply it), the normal and tangential Riemann
// states from the per-face impedances (a lane with Zs- + Zs+ = 0 takes
// the average of the two sides instead of dividing by zero), then
//   du = (1/rho)(div sigma + LIFT(Fscale (t* - t-)))
//   ds = Hooke(grad u) + LIFT(Fscale Hooke_f(u* - u-))
// plus the dense source groups (du += r_g Su_g, ds += r_g Ss_g) BEFORE the
// payload traces of the output are emitted: velocity rows of du, traction
// rows n . ds with the own normals, pad rows 0.
//
// What bounds it on the H100.  Per lane at 3D P3 the compulsory traffic
// is ~890 floats (u 60, sigma 120, neighbour payload 240, geo ~28,
// impedance/ghost rows 18, mask 4 in; du, ds and the 256 trace rows out):
// ~3.6 KB, ~0.3 GB a launch at E = 83k, ~90 us at 3.35 TB/s.  The
// arithmetic is ~20 kFLOP per lane after the reorder below, ~25 us at the
// 67 TFLOP/s FP32 rate: the op is bytes bound.
//
// Design: the tile kernel of upwind_tile.cuh, shared with K6/K7, on the
// merged layout (the first design, one thread a lane with its Riemann
// corrections in local memory, is gone):
//   - A block owns a tile of T consecutive lanes of ONE class (grid: tiles
//     of a class x classes), so the neighbour's payload rows of a (class,
//     face) form one segment at the plan's fixed shift s: they are staged
//     16 bytes a copy where the shift keeps the segment aligned and inside
//     the class, else 4 bytes, clamped into the class (as K1/K2's tile
//     kernels, merged_tile.cuh).  The table, u, sigma and the geo,
//     impedance, ghost and mask rows go to shared memory by cp.async too.
//   - The Riemann corrections overwrite the staged payload in place, sigma
//     is contracted with Ginv in place, and the products are
//     register-tiled over (node group, lane) on the host-built transposed
//     table (KernelTables.tile): velocity [Dr | LIFT] @ [w; dtf], stress
//     gradient-first with the face term factored per face.
//   - The epilogue (the dense source groups) runs on a thread's own nodes
//     in registers; the output tile then goes to shared memory and the
//     payload traces are emitted from there, never re-read from device
//     memory.
//   - No local memory (ptxas: 0 B stack, no spills at every shape).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (seigen_tpu_torch/ops/cuda_build.py, at first use).

#include <cuda_runtime.h>

#include <cstdint>

#include "merged_common.cuh"
#include "upwind_tile.cuh"

// Kernel arguments; mirrored field by field by the ctypes Structure
// UpwindArgs in seigen_tpu_torch/ops/upwind_kernels.py.
struct UpwindArgs {
  const float* u;       // (dim*npp, Ls) velocity
  const float* s;       // (n_sig*npp, Ls) stress (Voigt)
  const float* trs;     // (nf*rtf, Lt) producer payload traces (u, t rows)
  const float* geo;     // (G_ROWS, Ls) geo sections (FusedOpData layout)
  const float* uwg;     // (40, Ls) impedance / ghost rows (UW_OFF)
  const float* mask;    // (8, Ls): row f != 0 -> face f takes the own trace
  const float* inj_u0;  // dense source group 0: du pattern; else null
  const float* inj_s0;  // dense source group 0: ds pattern; else null
  const float* inj_u1;  // dense source group 1: du pattern; else null
  const float* inj_s1;  // dense source group 1: ds pattern; else null
  const int* plan;      // (m, nf, 3 + n_fp): t2, f2, flat shift s, pi[n_fp]
  const float* dr;      // (dim, n_p, n_p) reference derivative matrices
  const float* lift;    // (n_p, nf*n_fp) LIFT
  const int* fnodes;    // (nf, n_fp) volume node of each face node
  const float* tab;     // the tile table (KernelTables.tile): rows j*dim +
                        // r = Dr_r[., j], dim*n_p + q = LIFT[., q], n_p
                        // padded to a multiple of 4
  float* du;            // (dim*npp, Ls)
  float* ds;            // (n_sig*npp, Ls) elastic stress rate
  float* trout;         // (nf*rtf, Lt) payload traces of (du, ds)
  long long Ls;         // lanes = m * NC
  long long Lt;         // trace lanes = m * NCt
  int NC;               // lanes per class
  int NCt;              // trace lanes per class (halo lanes included)
  int h0;               // the first own lane of a class's trace lanes
  int npp;              // node rows per component (n_p rounded up to 8)
  int rtf;              // trace rows per face (roundup(2*dim*n_fp, 8))
  int o_ginv, o_nrm, o_scb, o_mat;
  int n_inj;            // 0, 1 or 2 dense source groups
  float r0, r1;         // wavelet values of the source groups
};

namespace {

using namespace seigen;

template <int DIM, int NP, int NFP>
using K3Layout = uptile::Layout<DIM, NP, NFP, true>;

// uwg row sections (ops/upwind_kernels.py:UW_OFF)
constexpr int kZpNbr = 0, kOwn = 32;

// Global row (at lane 0) of local geo row r: geo sections, then the four
// per-face uwg sections (zp_nbr, zs_nbr, ghost_u, ghost_t: 8 rows each,
// in the local order), the own impedances and the mask.
template <class LY>
__device__ __forceinline__ const float* k3_geo_row(const UpwindArgs& a,
                                                   int r) {
  constexpr int NF = LY::NF;
  const float* base = a.geo;
  int row;
  if (r < LY::G_NRM) {
    row = a.o_ginv + r;
  } else if (r < LY::G_FSC) {
    const int q = r - LY::G_NRM;
    row = a.o_nrm + 8 * (q / NF) + q % NF;
  } else if (r < LY::G_ZPN) {
    row = a.o_scb + (r - LY::G_FSC);
  } else if (r < LY::G_MAT) {
    const int q = r - LY::G_ZPN;
    base = a.uwg, row = kZpNbr + 8 * (q / NF) + q % NF;
  } else if (r < LY::G_ZOWN) {
    row = a.o_mat + (r - LY::G_MAT);
  } else if (r < LY::G_MASK) {
    base = a.uwg, row = kOwn + (r - LY::G_ZOWN);
  } else {
    base = a.mask, row = r - LY::G_MASK;
  }
  return base + (long long)row * a.Ls;
}

// The neighbour's payload rows f2*rtf + c*NFP + pi[k] (c < 2*DIM) at trace
// lanes t2*NCt + h0 + j0 + s + l, clamped into the trace lanes of the
// class t2, to NB rows c*NFT + f*NFP + k: 16 bytes a copy where the face's
// shift keeps the segment aligned and inside them, else 4 bytes.
// Consecutive threads copy consecutive lanes.
template <class LY>
__device__ __forceinline__ void k3_stage_payload(const UpwindArgs& a,
                                                 const uptile::Tile& tl,
                                                 float* sm, bool vec) {
  constexpr int T = LY::T, NG = LY::NG, NFP = LY::NFP, NFT = LY::NFT;
  constexpr int PAY = 2 * LY::DIM, Q = T / 4;
  const long long Lt = a.Lt;
  const int t = (int)blockIdx.y, jlo = -a.h0, jhi = a.NCt - a.h0;
  const bool vec_tr = vec && ((uintptr_t)a.trs & 15) == 0 &&
                      ((a.Lt | a.NCt | a.h0) & 3) == 0;
#pragma unroll
  for (int f = 0; f < LY::NF; ++f) {
    const int* pe = a.plan + (t * LY::NF + f) * (3 + NFP);
    const int s = pe[2];
    const float* base = a.trs + (long long)pe[1] * a.rtf * Lt +
                        (long long)pe[0] * a.NCt + a.h0;
    float* dst = sm + LY::OFF_NB + f * NFP * T;
    if (vec_tr && (s & 3) == 0 && tl.j0 + s >= jlo && tl.j0 + s + T <= jhi) {
      for (int e = threadIdx.x; e < PAY * NFP * Q; e += LY::THREADS) {
        const int r = e / Q, l4 = (e % Q) * 4, c = r / NFP, k = r % NFP;
        tile::cp_async16(dst + (c * NFT + k) * T + l4,
                         base + (long long)(c * NFP + pe[3 + k]) * Lt +
                             tl.j0 + s + l4);
      }
    } else {
      long long jn = tl.j0 + tl.l + s;
      jn = jn < jlo ? jlo : (jn >= jhi ? jhi - 1 : jn);
      for (int r = tl.ig; r < PAY * NFP; r += NG) {
        const int c = r / NFP, k = r % NFP;
        tile::cp_async4(dst + (c * NFT + k) * T + tl.l,
                        base + (long long)(c * NFP + pe[3 + k]) * Lt + jn);
      }
    }
  }
}

// du or ds (C components) of this thread's nodes plus the dense source
// groups, stored; v becomes the stored value.  Pad rows: the sources' pad
// rows (0 without sources).
template <class LY, int C>
__device__ __forceinline__ void k3_finish(const UpwindArgs& a,
                                          const uptile::Tile& tl, int i0,
                                          float (&v)[C][LY::RM], float* out,
                                          const float* p0, const float* p1) {
  constexpr int RM = LY::RM, NP = LY::NP;
  if (!tl.live) return;
  const long long Ls = a.Ls, L = tl.lane0 + tl.l;
  const int npp = a.npp;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float s0[RM], s1[RM];
#pragma unroll
    for (int ii = 0; ii < RM; ++ii) {
      const size_t idx = ((size_t)c * npp + i0 + ii) * Ls + L;
      const bool in = i0 + ii < NP;
      s0[ii] = in && a.n_inj > 0 ? __ldg(p0 + idx) : 0.f;
      s1[ii] = in && a.n_inj > 1 ? __ldg(p1 + idx) : 0.f;
    }
#pragma unroll
    for (int ii = 0; ii < RM; ++ii) {
      if (i0 + ii >= NP) continue;
      float k = v[c][ii];
      if (a.n_inj > 0) k += a.r0 * s0[ii];
      if (a.n_inj > 1) k += a.r1 * s1[ii];
      v[c][ii] = k;
      out[((size_t)c * npp + i0 + ii) * Ls + L] = k;
    }
  }
  const int pad = npp - NP;
  for (int r = tl.ig; r < C * pad; r += LY::NG) {
    const size_t idx = ((size_t)(r / pad) * npp + NP + r % pad) * Ls + L;
    float k = 0.f;
    if (a.n_inj > 0) k += a.r0 * p0[idx];
    if (a.n_inj > 1) k += a.r1 * p1[idx];
    out[idx] = k;
  }
}

// The payload traces of the output from the output tile: rows f*rtf +
// c*NFP + k = du_c, f*rtf + (DIM + c)*NFP + k = n . ds, pad rows 0, at the
// lane's trace lane (a class's halo lanes are not written).
template <class LY>
__device__ __forceinline__ void k3_emit(const UpwindArgs& a,
                                        const uptile::Tile& tl,
                                        const float* sm) {
  constexpr int DIM = LY::DIM, NFP = LY::NFP;
  if (!tl.live) return;
  const long long Ls = a.Lt,
                  L = (long long)blockIdx.y * a.NCt + a.h0 + tl.j0 + tl.l;
  for (int q = tl.ig; q < LY::NFT; q += LY::NG) {
    float uq[DIM], tq[DIM];
    uptile::face_values<LY>(tl, sm, q, uq, tq);
    float* tr = a.trout + ((long long)(q / NFP) * a.rtf + q % NFP) * Ls + L;
#pragma unroll
    for (int c = 0; c < DIM; ++c) {
      tr[(long long)c * NFP * Ls] = uq[c];
      tr[(long long)(DIM + c) * NFP * Ls] = tq[c];
    }
  }
  const int pad = a.rtf - 2 * DIM * NFP;
  for (int r = tl.ig; r < LY::NF * pad; r += LY::NG)
    a.trout[((long long)(r / pad) * a.rtf + 2 * DIM * NFP + r % pad) * Ls +
            L] = 0.f;
}

// One block per tile of T lanes of one class: blockIdx = (tile, class).
template <int DIM, int NP, int NFP>
__global__ void __launch_bounds__(K3Layout<DIM, NP, NFP>::THREADS)
upwind_tile_kernel(const UpwindArgs a) {
  using LY = K3Layout<DIM, NP, NFP>;
  constexpr int RM = LY::RM, NSIG = LY::NSIG;
  extern __shared__ float4 s_dyn[];
  float* sm = reinterpret_cast<float*>(s_dyn);
  const uptile::Tile tl = uptile::make_tile<LY>(a.NC);
  const uintptr_t ptrs = (uintptr_t)a.u | (uintptr_t)a.s | (uintptr_t)a.geo |
                         (uintptr_t)a.uwg | (uintptr_t)a.mask;
  const bool vec = tl.nvalid == LY::T && ((a.Ls | a.NC) & 3) == 0 &&
                   (ptrs & 15) == 0;
  uptile::stage_state<LY>(tl, sm, a.u, a.s, a.tab, a.fnodes, a.npp, a.Ls, vec,
                          [&](int r) { return k3_geo_row<LY>(a, r); });
  k3_stage_payload<LY>(a, tl, sm, vec);
  uptile::finish_stage();
  uptile::riemann<LY>(tl, sm);
  uptile::contract_sigma<LY>(tl, sm);
  const int i0 = tl.ig * RM;
  float v[DIM][RM], sig[NSIG][RM];
  uptile::vel_product<LY>(tl, sm, i0, v);
  k3_finish<LY, DIM>(a, tl, i0, v, a.du, a.inj_u0, a.inj_u1);
  uptile::stress_product<LY>(tl, sm, i0, sig);
  k3_finish<LY, NSIG>(a, tl, i0, sig, a.ds, a.inj_s0, a.inj_s1);
  uptile::store_out_tile<LY>(tl, sm, i0, v, sig);
  k3_emit<LY>(a, tl, sm);
}

// The dynamic shared memory is raised above 48 KB once per instantiation;
// an error there is returned like a launch error.
template <int DIM, int NP, int NFP>
int launch(const UpwindArgs& a, cudaStream_t stream) {
  using LY = K3Layout<DIM, NP, NFP>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      upwind_tile_kernel<DIM, NP, NFP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, LY::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)((a.NC + LY::T - 1) / LY::T),
                  (unsigned)(a.Ls / a.NC));
  upwind_tile_kernel<DIM, NP, NFP>
      <<<grid, LY::THREADS, LY::BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// sizeof(UpwindArgs), so the binding can check its mirror of the struct.
int seigen_upwind_args_size() { return (int)sizeof(UpwindArgs); }

// K3. Returns cudaGetLastError() after the launch, -1 for an element shape
// without an instantiation (see SEIGEN_DISPATCH_SHAPES), -2 for arguments
// the kernel does not take.
int seigen_upwind_rhs(const UpwindArgs* a, int dim, int n_p, int n_fp,
                      void* stream) {
  if (a->tab == nullptr || a->fnodes == nullptr || a->plan == nullptr ||
      a->NC < 1 || a->Ls % a->NC != 0 || a->n_inj < 0 || a->n_inj > 2 ||
      a->h0 < 0 || a->NCt < a->NC + a->h0 || a->Lt != a->Ls / a->NC * a->NCt)
    return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SEIGEN_LAUNCH(D, P, F) return launch<D, P, F>(*a, s)
  SEIGEN_DISPATCH_SHAPES(dim, n_p, n_fp, SEIGEN_LAUNCH)
#undef SEIGEN_LAUNCH
}

}  // extern "C"
