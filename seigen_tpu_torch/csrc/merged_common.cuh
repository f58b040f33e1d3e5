// Helpers shared by the operator kernels (merged_kernels.cu: K1/K2,
// upwind_kernels.cu: K3, lane_kernels.cu: K4/K5, lane_upwind_kernels.cu:
// K6/K7).
//
// The Godunov operators (K3, K6/K7) share the Riemann states below.

#pragma once

#include <cuda_runtime.h>

namespace seigen {

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

// w[c] = sum_d A_k[d,c] v[d]: row k (Voigt) of a general stiffness
// (engineering shear strains) contracted with a direction vector v.  Ck[m]
// = C[k][m] is row k of the element's matrix, and the strain slot of
// (velocity component c, direction d) is voigt(c, d), so A_k[d,c] =
// C[k][voigt(c,d)] and w[c] = sum_d Ck[voigt(c,d)] v[d].
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
