// Merged LF operators for Hopper (sm_90a): K1 merged_vel and K2 merged_stress,
// and their v2 instantiations K8 fused_vel2 and K9 fused_stress2.
//
// Replaces the JAX package's one Pallas kernel family on the LF4 main path,
// seigen_tpu/ops/merged_kernels.py:_merged_kernel, issued per class by
// _class_call_multi through
//   K1  vel_merged    -> _vel_body_adapter    -> fused_kernels.py:_vel2_body
//   K2  stress_merged -> _stress_body_adapter -> fused_kernels.py:_stress2_body
//       (both Hooke laws: isotropic lambda/mu, and the general Voigt
//       stiffness of its C branch — the ANISO instantiation below)
// The physics is the same; the TPU layout devices (per-class pallas_calls,
// lane blocks and their windows, one-hot MXU permutation and expansion
// matmuls, bf16 three-pass dots) are gone.  One launch covers all classes,
// one thread owns one lane (element), and the neighbour trace is an indexed
// load at lane t2*NC + j + s, rows f2*rtf + c*n_fp + pi[k].
//
// What bounds it on the H100.  Per lane and operator the arithmetic is a
// few thousand FP32 FMAs (Dr and LIFT products at P3), the compulsory
// device-memory traffic ~2 KB (field in, traces in, geo, field and traces
// out): at E = 83k that is ~0.2 GB, ~50 us at 3.35 TB/s, against a few
// GFLOP, ~30 us at the 67 TFLOP/s FP32 rate, so the op sits near the
// ridge.  This first version is bound by neither: every FMA takes its
// table operand from shared memory (a broadcast load per FMA), and the
// per-lane face data lives in local memory.  Design: the Dr/LIFT/fnodes
// tables sit in shared memory once per block; lane loads and stores are
// coalesced (consecutive threads, consecutive lanes); the volume term is
// contracted over the Voigt/direction sums BEFORE the Dr product
// (sum_r Dr_r @ w_r, one Dr pass per output component) to halve the FMAs;
// the neighbour lane is clamped into its class and loaded only on
// unmasked faces, so no load leaves [t2*NC, (t2+1)*NC).  Tensor-core
// (wgmma) tiles and TMA staging are later work.
//
// K8/K9 replace the v2 engine's Pallas kernels,
//   K8  seigen_tpu/ops/fused_kernels.py:vel2_op    (:718 -> _vel2_kernel :520)
//   K9  seigen_tpu/ops/fused_kernels.py:stress2_op (:759 -> _stress2_kernel :675,
//       ANISO as K2)
// which run the same _vel2_body / _stress2_body on traces exchanged
// beforehand (solver/lane_fused.py, K10 in trace_exchange.cu).  They are the
// V2 = true instantiations of the K1/K2 templates below: the neighbour value
// is row c*ftpp + f*n_fp + k of the lane itself, already signed and already
// the own value on boundary faces (no plan, no sign, no mask), and the
// emitted traces are written component-major, rows c*ftpp + f*n_fp + k, pad
// rows 0.  Same arithmetic and bound as K1/K2.  V2 = false compiles to the
// merged kernels exactly as before (the layout code sits under if constexpr).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (seigen_tpu_torch/ops/cuda_build.py, at first use).

#include <cuda_runtime.h>

#include "merged_common.cuh"

// Kernel arguments; mirrored field by field by the ctypes Structure
// MergedArgs in seigen_tpu_torch/ops/merged_kernels.py.
struct MergedArgs {
  const float* field;  // sigma (n_sig*npp, Ls) for K1; u (dim*npp, Ls) for K2
  const float* trs;    // merged: producer face-major traces (nf*rtf, Ls);
                       // v2: consumer-ordered traces (dim*ftpp, Ls)
  const float* geo;    // (G_ROWS, Ls) geo sections (FusedOpData layout)
  const float* mask;   // (8, Ls): row f != 0 -> face f takes the own trace
                       // (merged only)
  const float* ax0;    // axpy: u (K1) / s (K2); else null
  const float* ax1;    // axpy: uh1 (K1) / sh1 (K2); else null
  const float* damp;   // (npp, Ls) K2 axpy damping; else null
  const float* inj0;   // dense source pattern of wavelet group 0; else null
  const float* inj1;   // dense source pattern of wavelet group 1; else null
  const int* plan;     // (m, nf, 3 + n_fp): t2, f2, flat shift s, pi[n_fp]
                       // (merged only)
  const float* dr;     // (dim, n_p, n_p) reference derivative matrices
  const float* lift;   // (n_p, nf*n_fp) LIFT
  const int* fnodes;   // (nf, n_fp) volume node of each face node
  float* out;          // (C*npp, Ls) operator output
  float* trout;        // traces of out: merged (nf*rtf, Ls) face-major,
                       // v2 (dim*ftpp, Ls) component-major
  long long Ls;        // lanes = m * NC
  int NC;              // lanes per class
  int npp;             // node rows per component (n_p rounded up to 8)
  int rtf;             // merged: trace rows per face (roundup(dim*n_fp, 8));
                       // v2: trace rows per component (ftpp)
  int o_ginv, o_nrm, o_scb, o_bfs, o_dfs, o_mat;
  int o_C;             // K2: first row of the stiffness section (n_sig
                       // sections of 8 rows, row c*8+k = C[c,k]); -1: none
  int axpy;            // 1: LF4 update epilogue
  int n_inj;           // 0, 1 or 2 dense source groups
  float dt, c3;        // axpy coefficients
  float r0, r1;        // wavelet values of the source groups
};

namespace {

using namespace seigen;

// Epilogue shared by both operators: axpy / damp / inject on one row, then
// the store.
__device__ __forceinline__ void finish_row(const MergedArgs& a, size_t idx,
                                           float op, const float* damp_row) {
  float r = op;
  if (a.axpy) {
    r = a.ax0[idx] + a.dt * a.ax1[idx] + a.c3 * op;
    if (damp_row != nullptr) r = *damp_row * r;
  }
  if (a.n_inj > 0) r += a.r0 * a.inj0[idx];
  if (a.n_inj > 1) r += a.r1 * a.inj1[idx];
  a.out[idx] = r;
}

// ---------------------------------------------------------------- K1 ---
// du_c = (1/rho) (sum_{r,d} Ginv[r,d] Dr_r sigma_{V[c,d]}
//                 + LIFT (scb * t+_c + bfs * t-_c))
// t-_c = n_d sigma_{V[c,d]} at the face nodes; t+_c = -(producer traction)
// on interior faces, t-_c on boundary faces.  Emits the velocity traces.
// V2: t+_c is the lane's own row of the exchanged traces (K8).
template <int DIM, int NP, int NFP, bool V2>
__global__ void __launch_bounds__(kThreads)
merged_vel_kernel(const MergedArgs a) {
  using S = Shape<DIM, NP, NFP>;
  constexpr int NF = S::NF, NFT = S::NFT, NSIG = S::NSIG;
  __shared__ float s_dr[DIM * NP * NP];
  __shared__ float s_lift[NP * NFT];
  __shared__ int s_fn[NFT];
  load_tables<DIM, NP, NFP>(a, s_dr, s_lift, s_fn);

  const long long L = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (L >= a.Ls) return;
  const long long Ls = a.Ls;
  const int npp = a.npp;
  auto geo = [&](int row) { return a.geo[row * Ls + L]; };
  auto fld = [&](int c, int i) { return a.field[((long long)c * npp + i) * Ls + L]; };

  float g[DIM][DIM];
#pragma unroll
  for (int r = 0; r < DIM; ++r)
#pragma unroll
    for (int d = 0; d < DIM; ++d) g[r][d] = geo(a.o_ginv + r * DIM + d);
  const float irho = geo(a.o_mat);

  FaceLinks<NF> fl;
  if constexpr (!V2) face_links<NF, NFP>(a, L, fl);

  // scaled face flux scb*t+ + bfs*t- per output component and face node
  float flux[DIM][NFT];
#pragma unroll 1
  for (int f = 0; f < NF; ++f) {
    float n[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) n[d] = geo(a.o_nrm + 8 * d + f);
    const float scb = geo(a.o_scb + f), bfs = geo(a.o_bfs + f);
#pragma unroll 1
    for (int k = 0; k < NFP; ++k) {
      const int node = s_fn[f * NFP + k];
      float sv[NSIG];
#pragma unroll
      for (int c = 0; c < NSIG; ++c) sv[c] = fld(c, node);
#pragma unroll
      for (int c = 0; c < DIM; ++c) {
        float own = 0.f;
#pragma unroll
        for (int d = 0; d < DIM; ++d) own += n[d] * sv[voigt<DIM>(c, d)];
        float nb = own;
        if constexpr (V2)
          nb = a.trs[((long long)c * a.rtf + f * NFP + k) * Ls + L];
        else if (!fl.own_only[f])
          nb = -a.trs[((long long)fl.f2[f] * a.rtf + c * NFP + fl.pi[f][k]) * Ls
                      + fl.lane[f]];
        flux[c][f * NFP + k] = scb * nb + bfs * own;
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
      for (int d = 0; d < DIM; ++d) sv[d] = fld(voigt<DIM>(c, d), jj);
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
#pragma unroll
    for (int i = 0; i < NP; ++i)
      finish_row(a, ((size_t)c * npp + i) * Ls + L, irho * acc[i], nullptr);
    for (int i = NP; i < npp; ++i)
      finish_row(a, ((size_t)c * npp + i) * Ls + L, 0.f, nullptr);
  }

  if constexpr (V2) {
    // component-major velocity traces of the output; pad rows are written 0
#pragma unroll
    for (int c = 0; c < DIM; ++c) {
      float* tr = a.trout + (long long)c * a.rtf * Ls + L;
#pragma unroll 1
      for (int q = 0; q < NFT; ++q)
        tr[(long long)q * Ls] = a.out[((size_t)c * npp + s_fn[q]) * Ls + L];
      for (int q = NFT; q < a.rtf; ++q) tr[(long long)q * Ls] = 0.f;
    }
  } else {
    // face-major velocity traces of the output; pad rows are written 0
#pragma unroll 1
    for (int f = 0; f < NF; ++f) {
      float* tr = a.trout + (long long)f * a.rtf * Ls + L;
#pragma unroll 1
      for (int k = 0; k < NFP; ++k) {
        const int node = s_fn[f * NFP + k];
#pragma unroll
        for (int c = 0; c < DIM; ++c)
          tr[(long long)(c * NFP + k) * Ls] = a.out[((size_t)c * npp + node) * Ls + L];
      }
      for (int q = DIM * NFP; q < a.rtf; ++q) tr[(long long)q * Ls] = 0.f;
    }
  }
}

// ---------------------------------------------------------------- K2 ---
// ds_k = sum_{d,c} A_k[d,c] (du_c/dx_d) + LIFT(sum_{d,c} A_k[d,c] n_d du*_c)
// with A the Hooke tensor in Voigt row k — isotropic (lambda, mu), or with
// ANISO the element's general Voigt stiffness, A_k[d,c] = C[k][voigt(c,d)],
// whose row k is loaded from the geo C section inside the k loop — and
// du*_c = scb * u+_c + dfs * u-_c (u+ = producer velocity trace, u- on
// boundary faces).  Emits the traction traces n . sigma of the output.
// ANISO is a template parameter so that the isotropic instantiation keeps
// its registers.  V2: u+_c is the lane's own row of the exchanged traces
// (K9).
template <int DIM, int NP, int NFP, bool ANISO, bool V2>
__global__ void __launch_bounds__(kThreads)
merged_stress_kernel(const MergedArgs a) {
  using S = Shape<DIM, NP, NFP>;
  constexpr int NF = S::NF, NFT = S::NFT, NSIG = S::NSIG;
  __shared__ float s_dr[DIM * NP * NP];
  __shared__ float s_lift[NP * NFT];
  __shared__ int s_fn[NFT];
  load_tables<DIM, NP, NFP>(a, s_dr, s_lift, s_fn);

  const long long L = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (L >= a.Ls) return;
  const long long Ls = a.Ls;
  const int npp = a.npp;
  auto geo = [&](int row) { return a.geo[row * Ls + L]; };
  auto fld = [&](int c, int i) { return a.field[((long long)c * npp + i) * Ls + L]; };

  float g[DIM][DIM];
#pragma unroll
  for (int r = 0; r < DIM; ++r)
#pragma unroll
    for (int d = 0; d < DIM; ++d) g[r][d] = geo(a.o_ginv + r * DIM + d);
  float lam = 0.f, mu = 0.f;
  if constexpr (!ANISO) lam = geo(a.o_mat + 1), mu = geo(a.o_mat + 2);

  FaceLinks<NF> fl;
  if constexpr (!V2) face_links<NF, NFP>(a, L, fl);

  // velocity jump scb*u+ + dfs*u- per component and face node
  float jump[DIM][NFT];
#pragma unroll 1
  for (int f = 0; f < NF; ++f) {
    const float scb = geo(a.o_scb + f), dfs = geo(a.o_dfs + f);
#pragma unroll 1
    for (int k = 0; k < NFP; ++k) {
      const int node = s_fn[f * NFP + k];
#pragma unroll
      for (int c = 0; c < DIM; ++c) {
        const float own = fld(c, node);
        float nb = own;
        if constexpr (V2)
          nb = a.trs[((long long)c * a.rtf + f * NFP + k) * Ls + L];
        else if (!fl.own_only[f])
          nb = a.trs[((long long)fl.f2[f] * a.rtf + c * NFP + fl.pi[f][k]) * Ls
                     + fl.lane[f]];
        jump[c][f * NFP + k] = scb * nb + dfs * own;
      }
    }
  }

#pragma unroll 1
  for (int k = 0; k < NSIG; ++k) {
    // B[r][c] = sum_d A_k[d,c] Ginv[r,d]: volume term = sum_r Dr_r @ w_r,
    // w_r = sum_c B[r][c] u_c
    float Ck[NSIG];
    if constexpr (ANISO) {
#pragma unroll
      for (int m = 0; m < NSIG; ++m) Ck[m] = geo(a.o_C + 8 * k + m);
    }
    auto hooke = [&](const float* v, float* w) {
      if constexpr (ANISO)
        voigt_row<DIM>(Ck, v, w);
      else
        hooke_row<DIM>(k, lam, mu, v, w);
    };
    float B[DIM][DIM];
#pragma unroll
    for (int r = 0; r < DIM; ++r) hooke(g[r], B[r]);
    float acc[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) acc[i] = 0.f;
#pragma unroll 1
    for (int jj = 0; jj < NP; ++jj) {
      float uv[DIM];
#pragma unroll
      for (int c = 0; c < DIM; ++c) uv[c] = fld(c, jj);
#pragma unroll
      for (int r = 0; r < DIM; ++r) {
        float w = 0.f;
#pragma unroll
        for (int c = 0; c < DIM; ++c) w += B[r][c] * uv[c];
        const float* drc = s_dr + r * NP * NP + jj;
#pragma unroll
        for (int i = 0; i < NP; ++i) acc[i] += drc[i * NP] * w;
      }
    }
    // surface: LIFT @ (face Hooke of n (x) jump)
#pragma unroll 1
    for (int f = 0; f < NF; ++f) {
      float n[DIM], F[DIM];
#pragma unroll
      for (int d = 0; d < DIM; ++d) n[d] = geo(a.o_nrm + 8 * d + f);
      hooke(n, F);
#pragma unroll 1
      for (int kk = 0; kk < NFP; ++kk) {
        const int q = f * NFP + kk;
        float fq = 0.f;
#pragma unroll
        for (int c = 0; c < DIM; ++c) fq += F[c] * jump[c][q];
#pragma unroll
        for (int i = 0; i < NP; ++i) acc[i] += s_lift[i * NFT + q] * fq;
      }
    }
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const size_t idx = ((size_t)k * npp + i) * Ls + L;
      finish_row(a, idx, acc[i], a.damp ? a.damp + (size_t)i * Ls + L : nullptr);
    }
    for (int i = NP; i < npp; ++i) {
      const size_t idx = ((size_t)k * npp + i) * Ls + L;
      finish_row(a, idx, 0.f, a.damp ? a.damp + (size_t)i * Ls + L : nullptr);
    }
  }

  // traction traces n . sigma of the output, face-major (merged) or
  // component-major (V2); pad rows 0
#pragma unroll 1
  for (int f = 0; f < NF; ++f) {
    float n[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) n[d] = geo(a.o_nrm + 8 * d + f);
    float* tr = V2 ? a.trout + (long long)f * NFP * Ls + L
                   : a.trout + (long long)f * a.rtf * Ls + L;
#pragma unroll 1
    for (int kk = 0; kk < NFP; ++kk) {
      const int node = s_fn[f * NFP + kk];
      float sv[NSIG];
#pragma unroll
      for (int c = 0; c < NSIG; ++c) sv[c] = a.out[((size_t)c * npp + node) * Ls + L];
#pragma unroll
      for (int c = 0; c < DIM; ++c) {
        float t = 0.f;
#pragma unroll
        for (int d = 0; d < DIM; ++d) t += n[d] * sv[voigt<DIM>(c, d)];
        if constexpr (V2)
          tr[((long long)c * a.rtf + kk) * Ls] = t;
        else
          tr[(long long)(c * NFP + kk) * Ls] = t;
      }
    }
    if constexpr (!V2)
      for (int q = DIM * NFP; q < a.rtf; ++q) tr[(long long)q * Ls] = 0.f;
  }
  if constexpr (V2)
    for (int c = 0; c < DIM; ++c)
      for (int q = NFT; q < a.rtf; ++q)
        a.trout[((long long)c * a.rtf + q) * Ls + L] = 0.f;
}

template <int DIM, int NP, int NFP, bool V2>
void launch_layout(bool vel, const MergedArgs& a, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((a.Ls + kThreads - 1) / kThreads);
  if (vel)
    merged_vel_kernel<DIM, NP, NFP, V2><<<blocks, kThreads, 0, stream>>>(a);
  else if (a.o_C >= 0)
    merged_stress_kernel<DIM, NP, NFP, true, V2>
        <<<blocks, kThreads, 0, stream>>>(a);
  else
    merged_stress_kernel<DIM, NP, NFP, false, V2>
        <<<blocks, kThreads, 0, stream>>>(a);
}

// op: 0 K1, 1 K2, 2 K8, 3 K9.
template <int DIM, int NP, int NFP>
int launch(int op, const MergedArgs& a, cudaStream_t stream) {
  if (op < 2)
    launch_layout<DIM, NP, NFP, false>(op == 0, a, stream);
  else
    launch_layout<DIM, NP, NFP, true>(op == 2, a, stream);
  return (int)cudaGetLastError();
}

// Every (dim, n_p, n_fp) of SEIGEN_DISPATCH_SHAPES; -1 for another shape.
int dispatch(int op, const MergedArgs* a, int dim, int n_p, int n_fp,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SEIGEN_LAUNCH(D, P, F) return launch<D, P, F>(op, *a, s)
  SEIGEN_DISPATCH_SHAPES(dim, n_p, n_fp, SEIGEN_LAUNCH)
#undef SEIGEN_LAUNCH
}

}  // namespace

extern "C" {

// sizeof(MergedArgs), so the binding can check its mirror of the struct.
int seigen_merged_args_size() { return (int)sizeof(MergedArgs); }

// K1. Returns cudaGetLastError() after the launch, or -1 for an element
// shape without an instantiation.
int seigen_merged_vel(const MergedArgs* a, int dim, int n_p, int n_fp,
                      void* stream) {
  return dispatch(0, a, dim, n_p, n_fp, stream);
}

// K2. Same contract as seigen_merged_vel; a->o_C >= 0 launches the general
// Hooke law over the geo C section.
int seigen_merged_stress(const MergedArgs* a, int dim, int n_p, int n_fp,
                         void* stream) {
  return dispatch(1, a, dim, n_p, n_fp, stream);
}

// K8: K1 on consumer-ordered traces (a->rtf = ftpp, plan and mask unused).
int seigen_fused_vel2(const MergedArgs* a, int dim, int n_p, int n_fp,
                      void* stream) {
  return dispatch(2, a, dim, n_p, n_fp, stream);
}

// K9: K2 on consumer-ordered traces; a->o_C >= 0 as for K2.
int seigen_fused_stress2(const MergedArgs* a, int dim, int n_p, int n_fp,
                         void* stream) {
  return dispatch(3, a, dim, n_p, n_fp, stream);
}

}  // extern "C"
