// Helpers shared by the operator kernels (merged_kernels.cu: K1/K2,
// upwind_kernels.cu: K3, lane_kernels.cu: K4/K5, lane_upwind_kernels.cu:
// K6/K7).
//
// The per-lane kernels (K11, K1pk, K8pk, K9pk: the packed P1 layout) own
// one lane (element) per thread; load_tables needs dr, lift, fnodes.  The
// merged operators read their neighbour's face-major trace rows f2*rtf +
// c*n_fp + pi[k] at lane t2*NC + clamp(j + s) through the (m, nf, 3 +
// n_fp) int32 plan table: face_links does so for the per-lane K1pk and is
// templated on its argument struct, which must carry: plan, mask, Ls, NC,
// rtq.  The Godunov operators (K3, K6/K7) share the Riemann states below.

#pragma once

#include <cuda_runtime.h>

namespace seigen {

constexpr int kThreads = 128;

// Voigt index of tensor entry (c, d): 2D [xx, yy, xy]; 3D [xx, yy, zz, yz,
// xz, xy].
template <int DIM>
__device__ __forceinline__ constexpr int voigt(int c, int d) {
  return c == d ? c : (DIM == 2 ? 2 : 6 - c - d);
}

// The two tensor indices (a, b) of an off-diagonal Voigt component k.
template <int DIM>
__device__ __forceinline__ constexpr int shear_a(int k) {
  return DIM == 2 ? 0 : (k == 3 ? 1 : 0);
}
template <int DIM>
__device__ __forceinline__ constexpr int shear_b(int k) {
  return DIM == 2 ? 1 : (k == 5 ? 1 : 2);
}

template <int DIM, int NP, int NFP>
struct Shape {
  static constexpr int NF = DIM + 1;
  static constexpr int NFT = NF * NFP;
  static constexpr int NSIG = DIM == 2 ? 3 : 6;
};

// Tables into shared memory, once per block.
template <int DIM, int NP, int NFP, class Args>
__device__ __forceinline__ void load_tables(const Args& a, float* s_dr,
                                            float* s_lift, int* s_fn) {
  constexpr int NFT = Shape<DIM, NP, NFP>::NFT;
  for (int i = threadIdx.x; i < DIM * NP * NP; i += blockDim.x) s_dr[i] = a.dr[i];
  for (int i = threadIdx.x; i < NP * NFT; i += blockDim.x) s_lift[i] = a.lift[i];
  for (int i = threadIdx.x; i < NFT; i += blockDim.x) s_fn[i] = a.fnodes[i];
  __syncthreads();
}

// Per-face exchange data of one lane: own-trace select, producer face,
// node permutation and neighbour lane (clamped into the producer class).
// NPAR = 2 (the packed P1 layout of K1pk): lanes hold pairs of classes
// (2u, 2u+1); the thread of parity par is class t = 2u + par, the mask row
// of its face f is par*4 + f, and its producer t2 sits at lane
// (t2 / 2)*NC + j + s in the parity block t2 % 2 of the producer face:
// f2 then holds the block index f2*2 + t2 % 2, and row() is its first row
// (Args also carries rtq, the rows of one parity block).  The struct is
// the same for both, so NPAR = 1 keeps its local-memory footprint.
template <int NF, int NPAR = 1>
struct FaceLinks {
  bool own_only[NF];
  int f2[NF];
  const int* pi[NF];
  long long lane[NF];

  // First row of the producer's face block in the trace array.
  template <class Args>
  __device__ __forceinline__ long long row(const Args& a, int f) const {
    if constexpr (NPAR == 1)
      return (long long)f2[f] * a.rtf;
    else
      return (long long)f2[f] * a.rtq;
  }
};

template <int NF, int NFP, int NPAR = 1, class Args>
__device__ __forceinline__ void face_links(const Args& a, long long L,
                                           FaceLinks<NF, NPAR>& fl,
                                           int par = 0) {
  const int u = (int)(L / a.NC);
  const int j = (int)(L - (long long)u * a.NC);
  const int t = u * NPAR + par;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const int* pe = a.plan + (t * NF + f) * (3 + NFP);
    fl.own_only[f] = a.mask[(par * 4 + f) * a.Ls + L] != 0.f;
    fl.f2[f] = NPAR == 1 ? pe[1] : pe[1] * NPAR + pe[0] % NPAR;
    fl.pi[f] = pe + 3;
    int jn = j + pe[2];
    jn = jn < 0 ? 0 : (jn >= a.NC ? a.NC - 1 : jn);
    fl.lane[f] = (long long)(pe[0] / NPAR) * a.NC + jn;
  }
}

// w[c] = sum_d A_k[d,c] v[d]: row k (Voigt) of the isotropic Hooke tensor
// (lambda, mu) contracted with a direction vector v.
template <int DIM>
__device__ __forceinline__ void hooke_row(int k, float lam, float mu,
                                          const float* v /*[DIM]*/,
                                          float* w /*[DIM]*/) {
#pragma unroll
  for (int c = 0; c < DIM; ++c) w[c] = 0.f;
  if (k < DIM) {
#pragma unroll
    for (int c = 0; c < DIM; ++c) w[c] = lam * v[c];
    w[k] += 2.f * mu * v[k];
  } else {
    const int sa = shear_a<DIM>(k), sb = shear_b<DIM>(k);
    w[sb] = mu * v[sa];
    w[sa] = mu * v[sb];
  }
}

// The same map for a general Voigt stiffness (engineering shear strains):
// Ck[m] = C[k][m] is row k of the element's matrix, and the strain slot of
// (velocity component c, direction d) is voigt(c, d), so
// A_k[d,c] = C[k][voigt(c,d)] and w[c] = sum_d Ck[voigt(c,d)] v[d].
template <int DIM>
__device__ __forceinline__ void voigt_row(const float* Ck /*[NSIG]*/,
                                          const float* v /*[DIM]*/,
                                          float* w /*[DIM]*/) {
#pragma unroll
  for (int c = 0; c < DIM; ++c) {
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < DIM; ++d) s += Ck[voigt<DIM>(c, d)] * v[d];
    w[c] = s;
  }
}

// Impedances of one face's Riemann problem: own side (m), neighbour side
// (p), their sums, and whether the pair carries shear at all.
struct FaceImpedance {
  float zp_m, zp_p, zs_m, zs_p, zp_sum, zs_sum;
  bool has_shear;
};

__device__ __forceinline__ FaceImpedance face_impedance(float zp_m, float zs_m,
                                                        float zp_p, float zs_p) {
  FaceImpedance z;
  z.zp_m = zp_m, z.zp_p = zp_p, z.zs_m = zs_m, z.zs_p = zs_p;
  z.zp_sum = zp_m + zp_p;
  z.zs_sum = zs_m + zs_p;
  z.has_shear = z.zs_sum > 0.f;
  return z;
}

// Godunov corrections at one face node, scaled by Fscale:
//   dt[c] = fsc (t*_c - t-_c),  du[c] = fsc (u*_c - u-_c)
// from the own (um, tm) and ghosted neighbour (up, tp) velocity and
// traction, split into normal and tangential parts (ops/upwind.py).  A
// face with Zs- + Zs+ = 0 (acoustic on both sides) takes the average of
// the two tangential states instead of dividing by zero.
template <int DIM>
__device__ __forceinline__ void riemann_corrections(
    const FaceImpedance& z, float fsc, const float* n /*[DIM]*/,
    const float* um, const float* tm, const float* up, const float* tp,
    float* dt /*[DIM]*/, float* du /*[DIM]*/) {
  float uNm = 0.f, uNp = 0.f, tNm = 0.f, tNp = 0.f;
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    uNm += n[d] * um[d];
    uNp += n[d] * up[d];
    tNm += n[d] * tm[d];
    tNp += n[d] * tp[d];
  }
  const float tsN =
      (z.zp_p * tNm + z.zp_m * tNp + z.zp_m * z.zp_p * (uNp - uNm)) / z.zp_sum;
  const float usN = (z.zp_m * uNm + z.zp_p * uNp + (tNp - tNm)) / z.zp_sum;
#pragma unroll
  for (int c = 0; c < DIM; ++c) {
    const float tTm = tm[c] - tNm * n[c], tTp = tp[c] - tNp * n[c];
    const float uTm = um[c] - uNm * n[c], uTp = up[c] - uNp * n[c];
    float tT, uT;
    if (z.has_shear) {
      tT = (z.zs_p * tTm + z.zs_m * tTp + z.zs_m * z.zs_p * (uTp - uTm)) / z.zs_sum;
      uT = (z.zs_m * uTm + z.zs_p * uTp + (tTp - tTm)) / z.zs_sum;
    } else {
      tT = 0.5f * (tTm + tTp);
      uT = 0.5f * (uTm + uTp);
    }
    dt[c] = fsc * (tsN * n[c] + tT - tm[c]);
    du[c] = fsc * (usN * n[c] + uT - um[c]);
  }
}

}  // namespace seigen

// (dim, n_p, n_fp) of P1-P4 triangles and tetrahedra: every operator is
// instantiated for these eight element shapes.  LAUNCH(DIM, NP, NFP) must
// expand to a return statement.
#define SEIGEN_DISPATCH_SHAPES(dim, n_p, n_fp, LAUNCH)         \
  switch ((dim) * 10000 + (n_p) * 100 + (n_fp)) {             \
    case 20302: LAUNCH(2, 3, 2);                               \
    case 20603: LAUNCH(2, 6, 3);                               \
    case 21004: LAUNCH(2, 10, 4);                              \
    case 21505: LAUNCH(2, 15, 5);                              \
    case 30403: LAUNCH(3, 4, 3);                               \
    case 31006: LAUNCH(3, 10, 6);                              \
    case 32010: LAUNCH(3, 20, 10);                             \
    case 33515: LAUNCH(3, 35, 15);                             \
    default: return -1; /* element not instantiated */         \
  }
