// The in-operator (f2, pi) select of the unstructured lane operators: K4
// and K5 in mode SEL (lane_kernels.cu) and K6/K7 (lane_upwind_kernels.cu)
// decode it while they stage a tile.
//
// Neighbour traces arrive as raw per-face panels (nf*rows_pad, E): panel f
// holds, for every lane, the own-face rows of the lane's neighbour across
// face f, component c at rows c*cstride + g*n_fp + k (producer face g, node
// slot k).  cstride is the panel's component stride: nf*n_fp for gathered
// panels, ftpp for panels an operator emitted itself.  A lane decodes
// (g, pi) = divmod(combo[f], G) and reads node slot perms[pi][k].

#pragma once

namespace seigen {

constexpr int kMaxPerms = 16;  // orientation groups a select plan may hold

}  // namespace seigen
