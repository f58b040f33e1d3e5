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
// in as immediates, the wavelet value as an (8, E) array) are gone.  One
// thread owns one lane (element).  The plus-side velocity and traction of
// face f come from two raw panel arrays through the lane's combo code
// (lane_select.cuh), times the per-face sign rows, which carry the ghost
// coefficients on self-paired boundary faces (+1 / -1 inside).  Then, as
// K3 (upwind_kernels.cu) and with its Riemann states (merged_common.cuh):
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
// The emission is a second pass over the lane's own just-written rows: a
// register array indexed by fnodes would go to local memory.
// Outputs never alias inputs (stage 1 passes one tensor as stage input,
// base and accumulator; the wrapper allocates a fresh output).
//
// What bounds it on the H100.  Per lane at 3D P3 the compulsory traffic of
// K6 is ~690 floats (u 60, sigma 120, two panels 240, geometry, impedance,
// combo and sign rows ~50 in; 216 out), ~0.23 GB a launch at E = 83k, ~68
// us at 3.35 TB/s; K7 reads the base and the accumulator and writes twice
// as much in stage mode (~1270 floats, ~126 us).  The arithmetic is ~36
// kFLOP per lane, ~45 us at the 67 TFLOP/s FP32 rate: bytes bound.  Like
// K1-K5 this first version is bound by neither: every FMA takes its table
// operand from shared memory and the two per-lane Riemann correction
// arrays live in local memory.  Design as K3: tables in shared memory once
// per block, coalesced lane loads and stores, one Dr pass per output
// component, one face-node loop for both corrections; the face geometry
// (normals, Fscale, neighbour impedances) is read once per face from the
// face-node-expanded rows.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (seigen_tpu_torch/ops/cuda_build.py, at first use).

#include <cuda_runtime.h>

#include "lane_select.cuh"
#include "merged_common.cuh"

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
  const float* dr;      // (dim, n_p, n_p) reference derivative matrices
  const float* lift;    // (n_p, nf*n_fp) LIFT
  const int* fnodes;    // (nf, n_fp) volume node of each face node
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

// One RHS value k of row r = comp*npp + i of the u block (block 0) or the
// sigma block (block 1), into the output.  K6: out = k.  K7: k gains the
// dense source groups, then the RK4 epilogue.
template <bool AXPY>
__device__ __forceinline__ void store_row(const LaneUpwindArgs& a, long long L,
                                          int block, int r, int i, int nu,
                                          int ns, float k) {
  const size_t E = (size_t)a.E;
  const size_t idx = (size_t)r * E + L;
  const size_t o = idx + (block ? (size_t)nu * E : 0);
  if (!AXPY) {
    a.out[o] = k;
    return;
  }
  if (a.n_inj > 0) k += a.r0 * (block ? a.inj_s0 : a.inj_u0)[idx];
  if (a.n_inj > 1) k += a.r1 * (block ? a.inj_s1 : a.inj_u1)[idx];
  const float acc = (block ? a.acc_s : a.acc_u)[idx];
  if (a.stage) {
    a.out[o] = (block ? a.base_s : a.base_u)[idx] + a.cs * k;
    a.out[o + (size_t)(nu + ns) * E] = acc + a.wa * k;
  } else {
    float v = acc + a.wa * k;
    if (a.damp != nullptr) v *= a.damp[(size_t)i * E + L];
    a.out[o] = v;
  }
}

template <int DIM, int NP, int NFP, bool AXPY>
__global__ void __launch_bounds__(kThreads)
lane_upwind_kernel(const LaneUpwindArgs a) {
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
  const int nu = DIM * npp, ns = NSIG * npp;
  auto row = [&](const float* x, long long r) { return x[r * E + L]; };
  auto uf = [&](int c, int i) { return row(a.u, c * npp + i); };
  auto sf = [&](int c, int i) { return row(a.s, c * npp + i); };

  float g[DIM][DIM];
#pragma unroll
  for (int r = 0; r < DIM; ++r)
#pragma unroll
    for (int d = 0; d < DIM; ++d) g[r][d] = row(a.ginv, r * DIM + d);
  const float irho = row(a.irho, 0), lam = row(a.lam, 0), mu = row(a.mu, 0);
  const float zp_m = row(a.zown, 0), zs_m = row(a.zown, 1);

  // Riemann corrections per component and face node:
  // dtf = Fscale (t* - t-), duf = Fscale (u* - u-)
  float dtf[DIM][NFT], duf[DIM][NFT];
#pragma unroll 1
  for (int f = 0; f < NF; ++f) {
    const int q0 = f * NFP;  // the face's rows are constant over its nodes
    float n[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) n[d] = row(a.nrm, d * ftpp + q0);
    const float fsc = row(a.fsc, q0);
    const FaceImpedance z =
        face_impedance(zp_m, zs_m, row(a.zpn, q0), row(a.zsn, q0));
    const float sgu = row(a.sign_u, f), sgt = row(a.sign_t, f);
    const int* perm = nullptr;
    const long long pbase = sel_face<NFP>(a, s_perm, f, L, &perm);
#pragma unroll 1
    for (int k = 0; k < NFP; ++k) {
      const int node = s_fn[q0 + k];
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
        const long long pr = pbase + c * a.cstride + perm[k];
        up[c] = sgu * row(a.pu, pr);
        tp[c] = sgt * row(a.pt, pr);
      }
      float dt[DIM], du[DIM];
      riemann_corrections<DIM>(z, fsc, n, um, tm, up, tp, dt, du);
#pragma unroll
      for (int c = 0; c < DIM; ++c) {
        dtf[c][q0 + k] = dt[c];
        duf[c][q0 + k] = du[c];
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
      store_row<AXPY>(a, L, 0, c * npp + i, i, nu, ns, irho * acc[i]);
    for (int i = NP; i < npp; ++i)
      store_row<AXPY>(a, L, 0, c * npp + i, i, nu, ns, 0.f);
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
      for (int d = 0; d < DIM; ++d) n[d] = row(a.nrm, d * ftpp + f * NFP);
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
      store_row<AXPY>(a, L, 1, k * npp + i, i, nu, ns, acc[i]);
    for (int i = NP; i < npp; ++i)
      store_row<AXPY>(a, L, 1, k * npp + i, i, nu, ns, 0.f);
  }

  // own-face panels of the emitted state: rows [0, nu + ns) of the output
  // in both modes, reread by the lane that wrote them
  if (AXPY && a.emit) {
    const float* eu = a.out + L;
    const float* es = a.out + (long long)nu * E + L;
    float* TU = a.out + (long long)(a.stage ? 2 : 1) * (nu + ns) * E + L;
    float* TT = TU + (long long)DIM * ftpp * E;
#pragma unroll 1
    for (int f = 0; f < NF; ++f) {
      float n[DIM];
#pragma unroll
      for (int d = 0; d < DIM; ++d) n[d] = row(a.nrm, d * ftpp + f * NFP);
#pragma unroll 1
      for (int kk = 0; kk < NFP; ++kk) {
        const int q = f * NFP + kk;
        const int node = s_fn[q];
        float sv[NSIG];
#pragma unroll
        for (int c = 0; c < NSIG; ++c) sv[c] = es[(long long)(c * npp + node) * E];
#pragma unroll
        for (int c = 0; c < DIM; ++c) {
          TU[(long long)(c * ftpp + q) * E] = eu[(long long)(c * npp + node) * E];
          float t = 0.f;
#pragma unroll
          for (int d = 0; d < DIM; ++d) t += n[d] * sv[voigt<DIM>(c, d)];
          TT[(long long)(c * ftpp + q) * E] = t;
        }
      }
    }
    for (int c = 0; c < DIM; ++c)
      for (int q = NFT; q < ftpp; ++q) {
        TU[(long long)(c * ftpp + q) * E] = 0.f;
        TT[(long long)(c * ftpp + q) * E] = 0.f;
      }
  }
}

template <int DIM, int NP, int NFP>
int launch(bool axpy, const LaneUpwindArgs& a, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((a.E + kThreads - 1) / kThreads);
  if (axpy)
    lane_upwind_kernel<DIM, NP, NFP, true><<<blocks, kThreads, 0, stream>>>(a);
  else
    lane_upwind_kernel<DIM, NP, NFP, false><<<blocks, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// Every (dim, n_p, n_fp) of SEIGEN_DISPATCH_SHAPES; -1 for another shape,
// -2 for arguments the kernel does not take.
int dispatch(bool axpy, const LaneUpwindArgs* a, int dim, int n_p, int n_fp,
             void* stream) {
  if (a->combo == nullptr || a->perms == nullptr || a->sign_u == nullptr ||
      a->sign_t == nullptr || a->G < 1 || a->G > kMaxPerms || a->cstride < 1)
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
