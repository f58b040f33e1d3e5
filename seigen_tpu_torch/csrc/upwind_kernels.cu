// Coupled upwind (Godunov) RHS for Hopper (sm_90a): K3 upwind_rhs.
//
// Replaces the JAX package's Pallas kernel of the upwind-RK4 lane path,
// seigen_tpu/ops/upwind_kernels.py:upwind_rhs_merged, issued per class by
// merged_kernels.py:_class_call_multi -> _merged_kernel with the body
// upwind_kernels.py:_upwind_body.  The physics is the same; the TPU layout
// devices (per-class pallas_calls, lane blocks and their windows, one-hot
// MXU permutation and expansion matmuls, bf16 three-pass dots) are gone.
// One launch covers all classes, one thread owns one lane (element), and
// the neighbour's (velocity, traction) payload trace is an indexed load at
// lane t2*NC + clamp(j + s), rows f2*rtf + c*n_fp + pi[k] (velocity, sign
// +1) and f2*rtf + (dim + c)*n_fp + pi[k] (traction, sign -1).
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
// arithmetic is ~36 kFLOP per lane (the Dr products of u and sigma and
// the two LIFT products), ~3 GFLOP, ~45 us at the 67 TFLOP/s FP32 rate:
// the op is bytes-bound by a factor of two.  Like K1/K2, this first
// version is expected to be bound by neither: every FMA takes its table
// operand from shared memory, and the two per-lane Riemann correction
// arrays (2 * dim * nf * n_fp floats) live in local memory.  Design: the
// Dr/LIFT/fnodes tables sit in shared memory once per block; lane loads
// and stores are coalesced; the volume terms are contracted over the
// Voigt/direction sums BEFORE the Dr product (one Dr pass per output
// component); the face loop computes both Riemann corrections from one
// read of the own and neighbour traces, so u, sigma and the payload are
// each read once per launch; the neighbour lane is clamped into its class
// and read only on unmasked faces.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (seigen_tpu_torch/ops/cuda_build.py, at first use).

#include <cuda_runtime.h>

#include "merged_common.cuh"

// Kernel arguments; mirrored field by field by the ctypes Structure
// UpwindArgs in seigen_tpu_torch/ops/upwind_kernels.py.
struct UpwindArgs {
  const float* u;       // (dim*npp, Ls) velocity
  const float* s;       // (n_sig*npp, Ls) stress (Voigt)
  const float* trs;     // (nf*rtf, Ls) producer payload traces (u, t rows)
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
  float* du;            // (dim*npp, Ls)
  float* ds;            // (n_sig*npp, Ls) elastic stress rate
  float* trout;         // (nf*rtf, Ls) payload traces of (du, ds)
  long long Ls;         // lanes = m * NC
  int NC;               // lanes per class
  int npp;              // node rows per component (n_p rounded up to 8)
  int rtf;              // trace rows per face (roundup(2*dim*n_fp, 8))
  int o_ginv, o_nrm, o_scb, o_mat;
  int n_inj;            // 0, 1 or 2 dense source groups
  float r0, r1;         // wavelet values of the source groups
};

namespace {

using namespace seigen;

// uwg row sections (ops/upwind_kernels.py:UW_OFF)
constexpr int kZpNbr = 0, kZsNbr = 8, kGhostU = 16, kGhostT = 24, kOwn = 32;

// Store one output row value plus the dense source groups' share.
__device__ __forceinline__ void store_row(const UpwindArgs& a, float* out,
                                          const float* p0, const float* p1,
                                          size_t idx, float v) {
  if (a.n_inj > 0) v += a.r0 * p0[idx];
  if (a.n_inj > 1) v += a.r1 * p1[idx];
  out[idx] = v;
}

template <int DIM, int NP, int NFP>
__global__ void __launch_bounds__(kThreads)
upwind_rhs_kernel(const UpwindArgs a) {
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
  auto uwg = [&](int row) { return a.uwg[row * Ls + L]; };
  auto uf = [&](int c, int i) { return a.u[((long long)c * npp + i) * Ls + L]; };
  auto sf = [&](int c, int i) { return a.s[((long long)c * npp + i) * Ls + L]; };

  float g[DIM][DIM];
#pragma unroll
  for (int r = 0; r < DIM; ++r)
#pragma unroll
    for (int d = 0; d < DIM; ++d) g[r][d] = geo(a.o_ginv + r * DIM + d);
  const float irho = geo(a.o_mat), lam = geo(a.o_mat + 1), mu = geo(a.o_mat + 2);
  const float zp_m = uwg(kOwn), zs_m = uwg(kOwn + 1);

  FaceLinks<NF> fl;
  face_links<NF, NFP>(a, L, fl);

  // Riemann corrections per component and face node:
  // dtf = Fscale (t* - t-), duf = Fscale (u* - u-)
  float dtf[DIM][NFT], duf[DIM][NFT];
#pragma unroll 1
  for (int f = 0; f < NF; ++f) {
    float n[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) n[d] = geo(a.o_nrm + 8 * d + f);
    const float fsc = 2.f * geo(a.o_scb + f);  // scb = 0.5 Fscale
    const FaceImpedance z =
        face_impedance(zp_m, zs_m, uwg(kZpNbr + f), uwg(kZsNbr + f));
    const float gu = uwg(kGhostU + f), gt = uwg(kGhostT + f);
    const float* nb = a.trs + (long long)fl.f2[f] * a.rtf * Ls + fl.lane[f];
#pragma unroll 1
    for (int k = 0; k < NFP; ++k) {
      const int node = s_fn[f * NFP + k];
      float sv[NSIG], um[DIM], tm[DIM], up[DIM], tp[DIM];
#pragma unroll
      for (int c = 0; c < NSIG; ++c) sv[c] = sf(c, node);
#pragma unroll
      for (int c = 0; c < DIM; ++c) {
        um[c] = uf(c, node);
        float t = 0.f;
#pragma unroll
        for (int d = 0; d < DIM; ++d) t += n[d] * sv[voigt<DIM>(c, d)];
        tm[c] = t;
      }
      if (fl.own_only[f]) {
#pragma unroll
        for (int c = 0; c < DIM; ++c) {
          up[c] = gu * um[c];
          tp[c] = gt * tm[c];
        }
      } else {
        const int pk = fl.pi[f][k];
#pragma unroll
        for (int c = 0; c < DIM; ++c) {
          up[c] = gu * nb[(long long)(c * NFP + pk) * Ls];
          tp[c] = gt * -nb[(long long)((DIM + c) * NFP + pk) * Ls];
        }
      }
      float dt[DIM], du[DIM];
      riemann_corrections<DIM>(z, fsc, n, um, tm, up, tp, dt, du);
      const int q = f * NFP + k;
#pragma unroll
      for (int c = 0; c < DIM; ++c) {
        dtf[c][q] = dt[c];
        duf[c][q] = du[c];
      }
    }
  }

  // velocity: du_c = (1/rho)(sum_r Dr_r @ w_r + LIFT @ dtf_c),
  // w_r = sum_d Ginv[r,d] sigma_{V[c,d]}
#pragma unroll 1
  for (int c = 0; c < DIM; ++c) {
    float acc[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) acc[i] = 0.f;
#pragma unroll 1
    for (int jj = 0; jj < NP; ++jj) {
      float sv[DIM];
#pragma unroll
      for (int d = 0; d < DIM; ++d) sv[d] = sf(voigt<DIM>(c, d), jj);
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
#pragma unroll 1
    for (int q = 0; q < NFT; ++q) {
      const float fq = dtf[c][q];
#pragma unroll
      for (int i = 0; i < NP; ++i) acc[i] += s_lift[i * NFT + q] * fq;
    }
#pragma unroll
    for (int i = 0; i < NP; ++i)
      store_row(a, a.du, a.inj_u0, a.inj_u1, ((size_t)c * npp + i) * Ls + L,
                irho * acc[i]);
    for (int i = NP; i < npp; ++i)
      store_row(a, a.du, a.inj_u0, a.inj_u1, ((size_t)c * npp + i) * Ls + L, 0.f);
  }

  // stress: ds_k = sum_r Dr_r @ (sum_c B[r][c] u_c) + LIFT @ (F_k . duf),
  // B[r][c] = sum_d A_k[d,c] Ginv[r,d], F_k[c] = sum_d A_k[d,c] n_d
#pragma unroll 1
  for (int k = 0; k < NSIG; ++k) {
    float B[DIM][DIM];
#pragma unroll
    for (int r = 0; r < DIM; ++r) hooke_row<DIM>(k, lam, mu, g[r], B[r]);
    float acc[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) acc[i] = 0.f;
#pragma unroll 1
    for (int jj = 0; jj < NP; ++jj) {
      float uv[DIM];
#pragma unroll
      for (int c = 0; c < DIM; ++c) uv[c] = uf(c, jj);
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
#pragma unroll 1
    for (int f = 0; f < NF; ++f) {
      float n[DIM], F[DIM];
#pragma unroll
      for (int d = 0; d < DIM; ++d) n[d] = geo(a.o_nrm + 8 * d + f);
      hooke_row<DIM>(k, lam, mu, n, F);
#pragma unroll 1
      for (int kk = 0; kk < NFP; ++kk) {
        const int q = f * NFP + kk;
        float fq = 0.f;
#pragma unroll
        for (int c = 0; c < DIM; ++c) fq += F[c] * duf[c][q];
#pragma unroll
        for (int i = 0; i < NP; ++i) acc[i] += s_lift[i * NFT + q] * fq;
      }
    }
#pragma unroll
    for (int i = 0; i < NP; ++i)
      store_row(a, a.ds, a.inj_s0, a.inj_s1, ((size_t)k * npp + i) * Ls + L, acc[i]);
    for (int i = NP; i < npp; ++i)
      store_row(a, a.ds, a.inj_s0, a.inj_s1, ((size_t)k * npp + i) * Ls + L, 0.f);
  }

  // payload traces of the output: velocity rows of du, traction rows
  // n . ds (own normals); pad rows 0
#pragma unroll 1
  for (int f = 0; f < NF; ++f) {
    float n[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) n[d] = geo(a.o_nrm + 8 * d + f);
    float* tr = a.trout + (long long)f * a.rtf * Ls + L;
#pragma unroll 1
    for (int kk = 0; kk < NFP; ++kk) {
      const int node = s_fn[f * NFP + kk];
      float sv[NSIG];
#pragma unroll
      for (int c = 0; c < NSIG; ++c) sv[c] = a.ds[((size_t)c * npp + node) * Ls + L];
#pragma unroll
      for (int c = 0; c < DIM; ++c) {
        tr[(long long)(c * NFP + kk) * Ls] = a.du[((size_t)c * npp + node) * Ls + L];
        float t = 0.f;
#pragma unroll
        for (int d = 0; d < DIM; ++d) t += n[d] * sv[voigt<DIM>(c, d)];
        tr[(long long)((DIM + c) * NFP + kk) * Ls] = t;
      }
    }
    for (int q = 2 * DIM * NFP; q < a.rtf; ++q) tr[(long long)q * Ls] = 0.f;
  }
}

template <int DIM, int NP, int NFP>
int launch(const UpwindArgs& a, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((a.Ls + kThreads - 1) / kThreads);
  upwind_rhs_kernel<DIM, NP, NFP><<<blocks, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// sizeof(UpwindArgs), so the binding can check its mirror of the struct.
int seigen_upwind_args_size() { return (int)sizeof(UpwindArgs); }

// K3. Returns cudaGetLastError() after the launch, or -1 for an element
// shape without an instantiation (see SEIGEN_DISPATCH_SHAPES).
int seigen_upwind_rhs(const UpwindArgs* a, int dim, int n_p, int n_fp,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SEIGEN_LAUNCH(D, P, F) return launch<D, P, F>(*a, s)
  SEIGEN_DISPATCH_SHAPES(dim, n_p, n_fp, SEIGEN_LAUNCH)
#undef SEIGEN_LAUNCH
}

}  // extern "C"
