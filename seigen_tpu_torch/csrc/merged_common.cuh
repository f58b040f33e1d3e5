// Helpers shared by the merged exchange-in-kernel operators
// (merged_kernels.cu: K1/K2, upwind_kernels.cu: K3).
//
// Every operator owns one lane (element) per thread and reads its
// neighbour's face-major trace rows f2*rtf + c*n_fp + pi[k] at lane
// t2*NC + clamp(j + s) through the (m, nf, 3 + n_fp) int32 plan table.
// The helpers are templated on the kernel's argument struct, which must
// carry: plan, mask, dr, lift, fnodes, Ls, NC.

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
template <int NF>
struct FaceLinks {
  bool own_only[NF];
  int f2[NF];
  const int* pi[NF];
  long long lane[NF];
};

template <int NF, int NFP, class Args>
__device__ __forceinline__ void face_links(const Args& a, long long L,
                                           FaceLinks<NF>& fl) {
  const int t = (int)(L / a.NC);
  const int j = (int)(L - (long long)t * a.NC);
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const int* pe = a.plan + (t * NF + f) * (3 + NFP);
    fl.own_only[f] = a.mask[f * a.Ls + L] != 0.f;
    fl.f2[f] = pe[1];
    fl.pi[f] = pe + 3;
    int jn = j + pe[2];
    jn = jn < 0 ? 0 : (jn >= a.NC ? a.NC - 1 : jn);
    fl.lane[f] = (long long)pe[0] * a.NC + jn;
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
