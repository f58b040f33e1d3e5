// The in-operator (f2, pi) select of the unstructured lane operators
// (lane_kernels.cu: K4 mode SEL, through the helpers below; K5 mode SEL
// and lane_upwind_kernels.cu: K6/K7, which decode the same way while they
// stage a tile).
//
// Neighbour traces arrive as raw per-face panels (nf*rows_pad, E): panel f
// holds, for every lane, the own-face rows of the lane's neighbour across
// face f, component c at rows c*cstride + g*n_fp + k (producer face g, node
// slot k).  cstride is the panel's component stride: nf*n_fp for gathered
// panels, ftpp for panels an operator emitted itself.  A lane decodes
// (g, pi) = divmod(combo[f], G) and reads node slot perms[pi][k].
// The helpers are templated on the kernel's argument struct, which must
// carry: combo, perms, E, G, rows_pad.

#pragma once

#include <cuda_runtime.h>

namespace seigen {

constexpr int kMaxPerms = 16;  // orientation groups held in shared memory

// Panel row base of face f for this lane (row of component 0, node slot 0
// of the producer face g) and its node permutation.
template <int NFP, class Args>
__device__ __forceinline__ long long sel_face(const Args& a, const int* s_perm,
                                              int f, long long L,
                                              const int** perm) {
  const int code = a.combo[f * a.E + L];
  const int g = code / a.G;
  *perm = s_perm + (code - g * a.G) * NFP;
  return (long long)f * a.rows_pad + g * NFP;
}

template <int NFP, class Args>
__device__ __forceinline__ void load_perms(const Args& a, int* s_perm) {
  if (a.perms != nullptr)
    for (int i = threadIdx.x; i < a.G * NFP; i += blockDim.x) s_perm[i] = a.perms[i];
  // load_tables' __syncthreads() publishes these too
}

}  // namespace seigen
