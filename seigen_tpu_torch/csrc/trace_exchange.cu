// K10 trace_exchange for Hopper (sm_90a): the v2 engine's trace exchange.
//
// Replaces seigen_tpu/solver/lane_fused.py:make_pallas_exchange (:247; inner
// kernel :311, one pallas_call per class :380).  Semantics are those of the
// loop exchange make_trace_exchange (:405-459), which equal the Pallas
// kernel's on bounded meshes: for every consumer row (component c, face f,
// node k) of lane L = t*NC + j,
//   - face f of class t is a boundary face at supercell j (mask row f):
//     take the lane's own row c*ftpp + f*n_fp + k, unsigned;
//   - else read the producer row c*ftpp + f2*n_fp + pi[k] of class t2 at the
//     supercell (cell(j) + shift[t,f]) mod grid, per axis, times the sign
//     (-1 for tractions: conforming faces have opposite normals);
// pad rows nf*n_fp..ftpp of every component are written 0.  The wrap is per
// axis, so periodic meshes (where the reference leaves its Pallas kernel for
// the loop) run here too.  The TPU's block rules (bx | NC, m <= 16) and its
// one-hot permutation matmul do not apply: the permutation is an indexed load.
//
// What bounds it on the H100: it is a permutation, C*ftp rows read, nf mask
// rows read and C*ftpp rows written a lane (0.24 KB a lane at 3D P3, ~81 MB
// at E = 83k: ~24 us at 3.35 TB/s), no arithmetic.  Design: one thread per
// (lane, component, face) works out its neighbour lane once and copies the
// face's n_fp rows; consecutive threads take consecutive lanes, so every
// store and, away from the wrap planes of a shift, every load is coalesced.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (seigen_tpu_torch/ops/cuda_build.py, at first use).

#include <cuda_runtime.h>

// Kernel arguments; mirrored field by field by the ctypes Structure
// ExchangeArgs in seigen_tpu_torch/solver/lane_fused.py.
struct ExchangeArgs {
  const float* tr;     // (C*ftpp, E) producer-emitted component-major traces
  const int* table;    // (m, nf, 5 + n_fp): t2, f2, shift per axis (3), pi
  const float* mask;   // (>= nf, E): row f != 0 -> face f takes the own rows
  float* out;          // (C*ftpp, E) consumer-ordered traces
  long long E;         // lanes = m * NC
  int NC;              // lanes per class (supercells)
  int g0, g1, g2;      // supercell grid (2D meshes: g0 = 1)
  int C, nf, nfp, ftpp;
  float sign;          // -1: traction traces, +1: velocity traces
};

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ int wrap(int i, int g) {
  i %= g;
  return i < 0 ? i + g : i;
}

// grid (ceil(E / kThreads), C, nf + 1); blockIdx.z == nf zeroes the pad rows.
__global__ void __launch_bounds__(kThreads)
trace_exchange_kernel(const ExchangeArgs a) {
  const long long L = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (L >= a.E) return;
  const long long E = a.E;
  const int c = blockIdx.y, f = blockIdx.z;
  const int ftp = a.nf * a.nfp;
  float* out = a.out + (long long)c * a.ftpp * E + L;
  if (f == a.nf) {
    for (int q = ftp; q < a.ftpp; ++q) out[(long long)q * E] = 0.f;
    return;
  }
  out += (long long)f * a.nfp * E;
  const float* tr = a.tr + (long long)c * a.ftpp * E;
  if (a.mask[f * E + L] != 0.f) {  // boundary face: own rows, unsigned
    const float* own = tr + (long long)f * a.nfp * E + L;
    for (int k = 0; k < a.nfp; ++k) out[(long long)k * E] = own[(long long)k * E];
    return;
  }
  const int t = (int)(L / a.NC);
  const int j = (int)(L - (long long)t * a.NC);
  const int* pe = a.table + (t * a.nf + f) * (5 + a.nfp);
  const int i2 = j % a.g2, i1 = (j / a.g2) % a.g1, i0 = j / (a.g2 * a.g1);
  const int jn = (wrap(i0 + pe[2], a.g0) * a.g1 + wrap(i1 + pe[3], a.g1)) * a.g2
                 + wrap(i2 + pe[4], a.g2);
  const float* src = tr + (long long)pe[1] * a.nfp * E + (long long)pe[0] * a.NC + jn;
  for (int k = 0; k < a.nfp; ++k)
    out[(long long)k * E] = a.sign * src[(long long)pe[5 + k] * E];
}

}  // namespace

extern "C" {

// sizeof(ExchangeArgs), so the binding can check its mirror of the struct.
int seigen_trace_exchange_args_size() { return (int)sizeof(ExchangeArgs); }

// K10. Returns cudaGetLastError() after the launch.
int seigen_trace_exchange(const ExchangeArgs* a, void* stream) {
  const dim3 grid((unsigned)((a->E + kThreads - 1) / kThreads), a->C, a->nf + 1);
  trace_exchange_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}

}  // extern "C"
