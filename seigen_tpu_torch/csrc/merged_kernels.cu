// Merged LF operators for Hopper (sm_90a): K1 merged_vel and K2 merged_stress,
// their v2 instantiations K8 fused_vel2 and K9 fused_stress2, and their
// packed P1 instantiations (K1pk, K2pk, K8pk, K9pk).
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
// and the neighbour trace is read at lane t2*NC + j + s, rows f2*rtf +
// c*n_fp + pi[k].
//
// What bounds it on the H100.  Per lane and operator the arithmetic is a
// few thousand FP32 FMAs (Dr and LIFT products at P3), the compulsory
// device-memory traffic ~2 KB (field in, traces in, geo, field and traces
// out): at E = 83k that is ~0.2 GB, ~50 us at 3.35 TB/s, against ~25 us of
// FMAs at the 67 TFLOP/s FP32 rate, so the operators are bytes-bound once
// the arithmetic is organised.
//
// Every operator here runs the tile kernels of merged_tile.cuh: K1 and K2
// with one element per lane (the LF4 main path), K8 and K9 on the v2 path,
// and on the packed P1 layout K1pk, K2pk, K8pk, K9pk and K11
// (merged_tile_pk_kernel):
//   - A block owns a tile of T consecutive lanes of ONE class (grid: tiles
//     of a class x classes; packed: x 2 parities), so the neighbour rows of
//     a (class, face) form one segment at the plan's fixed shift s; the
//     last tile of a class is ragged and masked.  T is 32 at P2-P4 (64 or 128
//     at P1, for at least four warps a block).  At 3D P3 a block is 320
//     threads and takes 36 KB of shared memory (K2), 49 KB (K2 ANISO) or
//     51 KB (K1); four blocks, 40 warps, fit an SM (K2: its 48 registers
//     are the limit); the dynamic shared memory is raised above 48 KB per
//     instantiation.
//   - The grid is not persistent: the resident blocks of an SM overlap one
//     tile's loads with another's arithmetic, and more warps an SM is what
//     these kernels gain from.  A persistent grid double-buffering its
//     staging holds only two or three blocks an SM (96-116 registers,
//     twice the staging memory) and ran slower on every variant; so did
//     reading the table through L1 instead of shared memory and capping
//     the four-node K2 at 64 registers (spills); at 3D P3 two nodes a
//     thread (48 registers, twice the warps) beat four on every plain
//     variant.
//   - The tile is staged by cp.async: the table, the input's live rows and
//     the geo rows 16 bytes a copy (4 bytes, clamped per lane, in a ragged
//     or misaligned tile), the neighbour's trace rows 16 bytes a copy where
//     the face's shift keeps the segment aligned and inside its class, else
//     4 bytes; consecutive threads copy consecutive lanes.  cp.async, not
//     TMA: a TMA box needs a tensor map per (class, face) shift from the
//     driver API, and the neighbour segments are short and unaligned.
//   - The products are register-tiled: the table [Dr_1 .. Dr_dim | LIFT] is
//     stored transposed (node index contiguous, padded to a multiple of 4,
//     KernelTables.tile), and a thread owns RM = 2 nodes of one lane (4 for
//     the smaller elements, merged_tile.cuh), so one 8-byte pair of the
//     table (a warp-wide broadcast) and one operand per lane feed 2 FMAs
//     per output component, and an operand feeds the FMAs of both nodes
//     and of every component or direction it enters;
//     threads run over (node group, lane), 1.66 M outputs a component at
//     n=24 P3 instead of 83 k threads.
//   - K2 takes the gradient first, as the plain version does: G_rc = Dr_r
//     u_c (9 products, 3 600 FMAs at 3D P3), then per node and lane the
//     physical gradient, the engineering strains and the Hooke law
//     (isotropic, or the lane's 36 C entries), then the face term factored
//     per face, sum_f F(f) . (LIFT_f @ jump) (3 840 FMAs against 4 800 for
//     six LIFT passes), F_kc(f) = sum_d A_k[d,c] n_d formed in registers
//     (isotropic) or per tile in shared memory (ANISO).  K1 forms w_rc =
//     sum_d Ginv[r][d] sigma_V(c,d) over sigma's rows in place and the flux
//     over the neighbour's, and runs one product [Dr_1 Dr_2 Dr_3 | LIFT] @
//     [w_1c; w_2c; w_3c; flux_c] per component.
//   - No local memory: face data, neighbour links and Hooke coefficients
//     are shared-memory rows, register arrays are indexed under full
//     unrolling only (ptxas: 0 B stack, 0 spills at every shape).
//   - The epilogue (axpy, damping, dense injection) runs on
//     a thread's own nodes in registers, its operands loaded up front, and
//     stores coalesced rows; the output tile then goes to shared memory
//     (over the dead input rows) for the trace emission, pad rows 0.
//   - FP32 FFMA throughout.  TF32 is out: its 10-bit mantissa is the class
//     of precision that failed the precision gate.  Tensor cores are not
//     used: after the reorder K2 needs ~8 000 FMAs an element, ~20 us at
//     the FP32 rate, under its ~48 us bytes bound, and n_p = 20 pads badly
//     to wgmma's 64 rows; 3xTF32 mma.sync is the lever if the FMA pipe ever
//     sets the pace.
//
// K8/K9 replace the v2 engine's Pallas kernels,
//   K8  seigen_tpu/ops/fused_kernels.py:vel2_op    (:718 -> _vel2_kernel :520)
//   K9  seigen_tpu/ops/fused_kernels.py:stress2_op (:759 -> _stress2_kernel :675,
//       ANISO as K2)
// which run the same _vel2_body / _stress2_body on traces exchanged
// beforehand (solver/lane_fused.py, K10 in trace_exchange.cu).  They are the
// V2 = true instantiations of the tile kernel (merged_tile_kernel): K8 with
// VEL true, K9 with VEL false and both Hooke laws.  The neighbour value is
// row c*ftpp + f*n_fp + k of the lane itself, already signed and already
// the own value on boundary faces (no plan, no shift, no sign, no mask:
// the flux takes the row as it is, the grid is one class of all Ls lanes,
// whose tiles take 16-byte copies when whole and aligned, and the geo rows
// have no mask section), and the emitted traces are written
// component-major, rows c*ftpp + f*n_fp + k, pad rows 0.  Same arithmetic
// and bound as K1/K2.
//
// The packed P1 layout (NPAR = 2; only the P1 triangle and tetrahedron are
// instantiated) is the branch of the same Pallas kernels that runs on
// two-elements-per-lane operator data (seigen_tpu/ops/fused_kernels.py:
// build_packed_fused_data, FusedOpData n_par = 2; merged_kernels.py:
// _merged_kernel :259 with n_par = 2 and gexp, through vel_merged :542 and
// stress_merged :582; fused_kernels.py:_vel2_kernel :520 and _stress2_kernel
// :675, through vel2_op :718 and stress2_op :759).  There the TPU filled its
// 8-row tiles with two P1 elements; here a thread still owns one element: the
// parity par is a grid dimension (blockIdx.z), so consecutive threads keep
// touching consecutive lanes.  It reads state, damp and source rows c*8 + par*4
// + i, ginv rows o_ginv + 2*(r*dim+d) + par, face rows par*4 + f of every face
// section and of the mask, material rows o_mat + 2*j + par (1/rho at o_mat +
// par*irho_par: the P1 pack probe's geo keeps it at o_irho + par*4, K11 below),
// and emits its traces at f*rtf + par*rtq + ... (merged) or c*ftpp + par*ftq +
// ... (v2).  The merged plan table is over the original classes: the block's
// class is t = 2u + par, and its producer t2 sits at lane (t2 / 2)*NC + j + s,
// rows f2*rtf + (t2 % 2)*rtq.  What packing saves on this card is device-memory
// traffic: the pad rows 4..7 of every P1 state, damp and output block are
// neither read nor written.  What bounds the packed operators is the same as
// for K1/K2: bytes at 3.35 TB/s (K1pk ~0.04 ms, K8pk and K9pk ~0.03 ms a launch
// at n=32 P1, against 0.002-0.004 ms of FMAs at the FP32 rate).
//
// K1pk, K2pk, K8pk and K9pk are merged_tile_pk_kernel<DIM, NP, NFP, VEL,
// V2>, the tile kernel on tile::Layout NPAR = 2 (VEL K1pk; VEL and V2
// K8pk; V2 K9pk; a V2 grid is one class of all lanes: NC = Ls): a block is
// an unpacked tile of one parity, T = 128 lanes at P1, staged with the
// parity's row offsets, so the products, the epilogue and the emission are
// K1's, K8's and K2's, with no local memory; a 2D P1 element's pad row
// par*4 + 3 takes the epilogue of an operator value 0 as in the plain
// version.
//
// K11 p1_pack_vel replaces seigen_tpu/bench/p1_pack_probe.py:packed_vel_op
// (:176 -> _packed_vel_kernel :121), the probe's packed P1/3D velocity
// operator on its own geo layout.  That layout is FusedOpData's packed one
// but for 1/rho (rows o_irho + par*4 + i, all four equal), so K11 is K8pk,
// the packed velocity tile at 3D P1, entered through its own symbol with
// irho_par = 4 (FusedOpData's K8pk: 1); it reads the probe's arrays as
// they are.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (seigen_tpu_torch/ops/cuda_build.py, at first use).

#include <cuda_runtime.h>

#include "merged_common.cuh"
#include "merged_tile.cuh"

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
  const int* fnodes;   // (nf, n_fp) volume node of each face node
  const float* tab;    // tile kernels' table (KernelTables.tile): rows
                       // j*dim + r = Dr_r[., j], dim*n_p + q = LIFT[., q],
                       // n_p padded to a multiple of 4
  float* out;          // (C*npp, Ls) operator output
  float* trout;        // traces of out: merged (nf*rtf, Ls) face-major,
                       // v2 (dim*ftpp, Ls) component-major
  long long Ls;        // lanes = m * NC
  int NC;              // lanes per class
  int npp;             // node rows per component (n_p rounded up to 8)
  int rtf;             // merged: trace rows per face (n_par * rtq);
                       // v2: trace rows per component (ftpp)
  int rtq;             // merged: rows of one parity's face block,
                       // roundup(dim*n_fp, 8) (= rtf unpacked)
  int n_par;           // elements per lane: 1, or 2 (packed P1)
  int irho_par;        // packed: row distance of the parities' 1/rho rows
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

// ------------------------- K1/K2/K8/K9, K1pk/K2pk/K8pk/K9pk, K11: tiled ---
// One block per tile of T lanes of one class: blockIdx = (tile, class).
template <int DIM, int NP, int NFP, bool VEL, bool ANISO, bool V2>
__global__ void
__launch_bounds__(tile::Layout<DIM, NP, NFP, VEL, ANISO, V2>::THREADS)
merged_tile_kernel(const MergedArgs a) {
  using LY = tile::Layout<DIM, NP, NFP, VEL, ANISO, V2>;
  extern __shared__ float4 s_dyn[];
  if constexpr (VEL)
    tile::vel_tile<LY>(a, reinterpret_cast<float*>(s_dyn));
  else
    tile::stress_tile<LY>(a, reinterpret_cast<float*>(s_dyn));
}

// K1pk (VEL), K2pk (neither), K8pk and K11 (both), K9pk (V2): blockIdx =
// (tile, packed class, parity); V2 has one class of all lanes.
template <int DIM, int NP, int NFP, bool VEL, bool V2>
__global__ void
__launch_bounds__(tile::Layout<DIM, NP, NFP, VEL, false, V2, 2>::THREADS)
merged_tile_pk_kernel(const MergedArgs a) {
  using LY = tile::Layout<DIM, NP, NFP, VEL, false, V2, 2>;
  extern __shared__ float4 s_dyn[];
  if constexpr (VEL)
    tile::vel_tile<LY>(a, reinterpret_cast<float*>(s_dyn));
  else
    tile::stress_tile<LY>(a, reinterpret_cast<float*>(s_dyn));
}

// The dynamic shared memory is raised above 48 KB once per instantiation;
// an error there is returned like a launch error.
template <int DIM, int NP, int NFP, bool VEL, bool ANISO, bool V2>
int launch_tile(const MergedArgs& a, cudaStream_t stream) {
  using LY = tile::Layout<DIM, NP, NFP, VEL, ANISO, V2>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      merged_tile_kernel<DIM, NP, NFP, VEL, ANISO, V2>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, LY::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)((a.NC + LY::T - 1) / LY::T),
                  (unsigned)(a.Ls / a.NC));
  merged_tile_kernel<DIM, NP, NFP, VEL, ANISO, V2>
      <<<grid, LY::THREADS, LY::BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}

// The packed layout is isotropic only (a->o_C >= 0: -1).
template <int DIM, int NP, int NFP, bool VEL, bool V2>
int launch_tile_pk(const MergedArgs& a, cudaStream_t stream) {
  using LY = tile::Layout<DIM, NP, NFP, VEL, false, V2, 2>;
  if (a.o_C >= 0) return -1;
  static const cudaError_t attr = cudaFuncSetAttribute(
      merged_tile_pk_kernel<DIM, NP, NFP, VEL, V2>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, LY::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)((a.NC + LY::T - 1) / LY::T),
                  (unsigned)(a.Ls / a.NC), 2);
  merged_tile_pk_kernel<DIM, NP, NFP, VEL, V2>
      <<<grid, LY::THREADS, LY::BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}

// op: 0 K1, 1 K2, 2 K8, 3 K9.  With one element per lane all four run the
// tile kernel (a->o_C >= 0: the general Hooke law), on the packed layout
// the packed tile kernel.
template <int DIM, int NP, int NFP, int NPAR>
int launch(int op, const MergedArgs& a, cudaStream_t stream) {
  if constexpr (NPAR == 2) {
    switch (op) {
      case 0: return launch_tile_pk<DIM, NP, NFP, true, false>(a, stream);
      case 1: return launch_tile_pk<DIM, NP, NFP, false, false>(a, stream);
      case 2: return launch_tile_pk<DIM, NP, NFP, true, true>(a, stream);
      default: return launch_tile_pk<DIM, NP, NFP, false, true>(a, stream);
    }
  } else {
    const bool aniso = a.o_C >= 0;
    switch (op) {
      case 0: return launch_tile<DIM, NP, NFP, true, false, false>(a, stream);
      case 1:
        return aniso ? launch_tile<DIM, NP, NFP, false, true, false>(a, stream)
                     : launch_tile<DIM, NP, NFP, false, false, false>(a, stream);
      case 2: return launch_tile<DIM, NP, NFP, true, false, true>(a, stream);
      default:
        return aniso ? launch_tile<DIM, NP, NFP, false, true, true>(a, stream)
                     : launch_tile<DIM, NP, NFP, false, false, true>(a, stream);
    }
  }
}

// Unpacked: every (dim, n_p, n_fp) of SEIGEN_DISPATCH_SHAPES; packed
// (a->n_par == 2): the P1 triangle and tetrahedron.  -1 for another shape.
int dispatch(int op, const MergedArgs* a, int dim, int n_p, int n_fp,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->n_par == 2) {
    switch (dim * 10000 + n_p * 100 + n_fp) {
      case 20302: return launch<2, 3, 2, 2>(op, *a, s);
      case 30403: return launch<3, 4, 3, 2>(op, *a, s);
      default: return -1;
    }
  }
  if (a->n_par != 1) return -1;
#define SEIGEN_LAUNCH(D, P, F) return launch<D, P, F, 1>(op, *a, s)
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

// K9: K2 on consumer-ordered traces (a->rtf = ftpp, a->NC = a->Ls, plan
// and mask unused); a->o_C >= 0 as for K2.
int seigen_fused_stress2(const MergedArgs* a, int dim, int n_p, int n_fp,
                         void* stream) {
  return dispatch(3, a, dim, n_p, n_fp, stream);
}

// K11: the P1 pack probe's velocity operator (the packed 3D P1 K8 with the
// probe's 1/rho rows, a->irho_par = 4); -1 for any other layout or shape.
int seigen_p1_pack_vel(const MergedArgs* a, int dim, int n_p, int n_fp,
                       void* stream) {
  if (a->n_par != 2 || dim * 10000 + n_p * 100 + n_fp != 30403) return -1;
  return launch_tile_pk<3, 4, 3, true, true>(
      *a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
