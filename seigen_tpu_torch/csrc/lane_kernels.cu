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
// One thread owns one lane (element); the neighbour traces arrive
// pre-exchanged in consumer order (SIG/TRAC/TR), or as raw per-face panels
// whose (producer face g, node permutation pi) the thread decodes from its
// combo code and reads directly (SEL).
//
// What bounds it on the H100.  Per lane and launch the compulsory traffic
// is ~340-460 rows of 4 B (state, neighbour payload, per-face geometry in;
// output out): at E = 83k ~0.11-0.15 GB, ~34-46 us at 3.35 TB/s, against
// 12-24 kFLOP per lane of Dr and LIFT products, ~15-30 us at 67 TFLOP/s
// FP32: bytes bound.  The kernel reads the geometry expanded to face nodes
// (~180 rows more than compulsory).  This first version is bound by neither:
// as in K1/K2, every FMA takes its table operand from shared memory and the
// per-lane face-node flux lives in local memory.  Design: Dr/LIFT/fnodes
// (and the SEL permutations) sit in shared memory once per block; lane
// loads and stores are coalesced; the volume term contracts the
// Voigt/direction sums before the Dr product (one Dr pass per output
// component); geometry is read once per face node, where it is needed.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (seigen_tpu_torch/ops/cuda_build.py, at first use).

#include <cuda_runtime.h>

#include "lane_select.cuh"
#include "merged_common.cuh"

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
// panels).  The face pass needs every C[k][m] at every face node: it forms
// the node's engineering strains of n (x) du* once and reads the
// coefficient rows through L1 instead of holding n_sig^2 of them in
// registers; the volume pass loads row k inside its k loop.  ANISO is a
// template parameter so that the isotropic instantiation keeps its
// registers.
template <int DIM, int NP, int NFP, bool ANISO>
__global__ void __launch_bounds__(kThreads)
lane_stress_kernel(const LaneArgs a) {
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
  float lam = 0.f, mu = 0.f;
  if constexpr (!ANISO) lam = row(a.mat0, 0), mu = row(a.mat1, 0);

  // scaled face Hooke rows Fscale * A_k (n (x) du*) per Voigt k, face node
  float face[NSIG][NFT];
#pragma unroll 1
  for (int f = 0; f < NF; ++f) {
    long long pbase = 0;
    const int* perm = nullptr;
    if (a.mode == kStressSel) pbase = sel_face<NFP>(a, s_perm, f, L, &perm);
#pragma unroll 1
    for (int k = 0; k < NFP; ++k) {
      const int q = f * NFP + k;
      const int node = s_fn[q];
      float n[DIM], du[DIM];
#pragma unroll
      for (int d = 0; d < DIM; ++d) n[d] = row(a.nrm, d * ftpp + q);
      const float delta = row(a.coef, q), fs = row(a.fsc, q);
#pragma unroll
      for (int c = 0; c < DIM; ++c) {
        const float own = row(a.field, c * npp + node);
        const float nb = a.mode == kStressTr
                             ? row(a.tr, c * ftpp + q)
                             : row(a.tr, pbase + c * a.cstride + perm[k]);
        du[c] = 0.5f * nb + delta * own;
      }
      if constexpr (ANISO) {
        // engineering strains of n (x) du*: slot voigt(c, d) sums n_d du*_c
        float epsf[NSIG];
#pragma unroll
        for (int m = 0; m < NSIG; ++m) epsf[m] = 0.f;
#pragma unroll
        for (int c = 0; c < DIM; ++c)
#pragma unroll
          for (int d = 0; d < DIM; ++d) epsf[voigt<DIM>(c, d)] += n[d] * du[c];
#pragma unroll
        for (int kk = 0; kk < NSIG; ++kk) {
          float fq = 0.f;
#pragma unroll
          for (int m = 0; m < NSIG; ++m)
            fq += row(a.cmat, 8 * kk + m) * epsf[m];
          face[kk][q] = fs * fq;
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < NSIG; ++kk) {
          float F[DIM];
          hooke_row<DIM>(kk, lam, mu, n, F);
          float fq = 0.f;
#pragma unroll
          for (int c = 0; c < DIM; ++c) fq += F[c] * du[c];
          face[kk][q] = fs * fq;
        }
      }
    }
  }

#pragma unroll 1
  for (int k = 0; k < NSIG; ++k) {
    // B[r][c] = sum_d A_k[d,c] Ginv[r,d]: volume term = sum_r Dr_r @ w_r,
    // w_r = sum_c B[r][c] u_c
    float B[DIM][DIM];
    if constexpr (ANISO) {
      float Ck[NSIG];
#pragma unroll
      for (int m = 0; m < NSIG; ++m) Ck[m] = row(a.cmat, 8 * k + m);
#pragma unroll
      for (int r = 0; r < DIM; ++r) voigt_row<DIM>(Ck, g[r], B[r]);
    } else {
#pragma unroll
      for (int r = 0; r < DIM; ++r) hooke_row<DIM>(k, lam, mu, g[r], B[r]);
    }
    float acc[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) acc[i] = 0.f;
#pragma unroll 1
    for (int jj = 0; jj < NP; ++jj) {
      float uv[DIM];
#pragma unroll
      for (int c = 0; c < DIM; ++c) uv[c] = row(a.field, c * npp + jj);
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
    // surface: LIFT @ face_k
#pragma unroll 1
    for (int q = 0; q < NFT; ++q) {
      const float fq = face[k][q];
#pragma unroll
      for (int i = 0; i < NP; ++i) acc[i] += s_lift[i * NFT + q] * fq;
    }
    float* o = a.out + (long long)k * npp * E + L;
#pragma unroll
    for (int i = 0; i < NP; ++i) o[i * E] = acc[i];
    for (int i = NP; i < npp; ++i) o[i * E] = 0.f;
  }
}

template <int DIM, int NP, int NFP>
int launch(int op, const LaneArgs& a, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((a.E + kThreads - 1) / kThreads);
  if (op == 0)
    lane_vel_kernel<DIM, NP, NFP><<<blocks, kThreads, 0, stream>>>(a);
  else if (a.cmat != nullptr)
    lane_stress_kernel<DIM, NP, NFP, true>
        <<<blocks, kThreads, 0, stream>>>(a);
  else
    lane_stress_kernel<DIM, NP, NFP, false>
        <<<blocks, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// Every (dim, n_p, n_fp) of SEIGEN_DISPATCH_SHAPES; -1 for another shape,
// -2 for a mode the operator does not have, a SEL launch without its
// tables, K4 with a stiffness or isotropic K5 without its material rows.
int dispatch(int op, const LaneArgs* a, int dim, int n_p, int n_fp,
             void* stream) {
  const int sel = op == 0 ? (int)kVelSel : (int)kStressSel;
  if (a->mode < 0 || a->mode > sel) return -2;
  if (a->mode == sel && (a->combo == nullptr || a->perms == nullptr ||
                         a->G < 1 || a->G > kMaxPerms || a->cstride < 1 ||
                         (op == 0 && a->sign == nullptr)))
    return -2;
  const bool iso_rows = a->mat0 != nullptr && a->mat1 != nullptr;
  if (op == 0 ? a->cmat != nullptr : (a->cmat == nullptr && !iso_rows))
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
