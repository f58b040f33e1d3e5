// Native (C++) mesh-preprocessing kernels — the rebuild's equivalent of the
// reference's C-level mesh layer (SURVEY.md §3.1 item 3: PETSc DMPlex +
// METIS partitioning).  Hot setup-time operations that are O(E log E) in
// Python/NumPy become tight sorts here for large meshes:
//
//   * pair_face_nodes: lexicographic sort-and-match of per-face-node
//     geometric keys (the core of DG connectivity construction)
//   * morton_codes: space-filling-curve codes for element partitioning
//
// Exposed with a plain C ABI and loaded from Python via ctypes
// (seigen_tpu/mesh/native/__init__.py); the NumPy implementation in
// mesh/discrete.py and parallel/partition.py is the correctness oracle
// (tests/test_native.py checks exact agreement).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// keys: (n_rows, keylen) row-major int64.  partner_out[i] = j such that rows
// i and j have identical keys (j == i for unmatched rows).  Returns the
// maximum multiplicity seen (so the caller can reject non-manifold input
// where a key appears more than twice).
int64_t pair_face_nodes(const int64_t* keys, int64_t n_rows, int32_t keylen,
                        int64_t* partner_out) {
  std::vector<int64_t> idx(n_rows);
  std::iota(idx.begin(), idx.end(), 0);

  auto cmp = [keys, keylen](int64_t a, int64_t b) {
    const int64_t* ra = keys + a * keylen;
    const int64_t* rb = keys + b * keylen;
    for (int32_t k = 0; k < keylen; ++k) {
      if (ra[k] != rb[k]) return ra[k] < rb[k];
    }
    return a < b;  // stable tie-break
  };
  std::sort(idx.begin(), idx.end(), cmp);

  auto eq = [keys, keylen](int64_t a, int64_t b) {
    return std::memcmp(keys + a * keylen, keys + b * keylen,
                       sizeof(int64_t) * keylen) == 0;
  };

  int64_t max_mult = 0;
  int64_t i = 0;
  while (i < n_rows) {
    int64_t j = i + 1;
    while (j < n_rows && eq(idx[i], idx[j])) ++j;
    int64_t mult = j - i;
    max_mult = std::max(max_mult, mult);
    if (mult == 2) {
      partner_out[idx[i]] = idx[i + 1];
      partner_out[idx[i + 1]] = idx[i];
    } else {
      for (int64_t k = i; k < j; ++k) partner_out[idx[k]] = idx[k];
    }
    i = j;
  }
  return max_mult;
}

// q: (n, dim) row-major quantized coordinates (16-bit range); codes_out: (n,)
void morton_codes(const uint32_t* q, int64_t n, int32_t dim, int32_t bits,
                  uint64_t* codes_out) {
  for (int64_t i = 0; i < n; ++i) {
    uint64_t code = 0;
    for (int32_t b = 0; b < bits; ++b) {
      for (int32_t d = 0; d < dim; ++d) {
        code |= static_cast<uint64_t>((q[i * dim + d] >> b) & 1u)
                << (b * dim + d);
      }
    }
    codes_out[i] = code;
  }
}

// argsort of uint64 codes -> perm_out (n,) int64
void argsort_u64(const uint64_t* codes, int64_t n, int64_t* perm_out) {
  std::vector<int64_t> idx(n);
  std::iota(idx.begin(), idx.end(), 0);
  std::stable_sort(idx.begin(), idx.end(), [codes](int64_t a, int64_t b) {
    return codes[a] < codes[b];
  });
  std::memcpy(perm_out, idx.data(), sizeof(int64_t) * n);
}

}  // extern "C"

extern "C" {

// Affine-simplex geometric factors in one element pass (the NumPy oracle
// is mesh/discrete.py's J/detJ/Ginv/normals/Fscale/h block; closed-form
// adjugate inverse instead of LAPACK, tight-tolerance-tested in
// tests/test_native.py).  verts (V, dim) f64, cells (E, dim+1) i64,
// face_vertices (nf, dim) i64 (face f's vertex slots; slot f is opposite).
// Outputs: ginv (E, dim, dim), detj (E,), normals (E, nf, dim),
// fscale (E, nf), h (E,).
void geometric_factors(const double* verts, const int64_t* cells, int64_t E,
                       int32_t dim, const int64_t* face_vertices,
                       double* ginv, double* detj, double* normals,
                       double* fscale, double* h) {
  const int32_t nf = dim + 1;
  const double fact_dim = (dim == 2) ? 2.0 : 6.0;       // dim!
  const double fact_fdim = (dim == 2) ? 1.0 : 2.0;      // (dim-1)!
  for (int64_t e = 0; e < E; ++e) {
    const int64_t* cv = cells + e * (dim + 1);
    const double* v0 = verts + cv[0] * dim;
    // J[:, c] = v_{c+1} - v0 (column-major edge matrix, as in the oracle)
    double J[9];
    for (int32_t c = 0; c < dim; ++c) {
      const double* vc = verts + cv[c + 1] * dim;
      for (int32_t r = 0; r < dim; ++r) J[r * dim + c] = vc[r] - v0[r];
    }
    double det;
    double* G = ginv + e * dim * dim;
    if (dim == 2) {
      det = J[0] * J[3] - J[1] * J[2];
      const double inv = 1.0 / det;
      G[0] = J[3] * inv;
      G[1] = -J[1] * inv;
      G[2] = -J[2] * inv;
      G[3] = J[0] * inv;
    } else {
      const double c00 = J[4] * J[8] - J[5] * J[7];
      const double c01 = J[5] * J[6] - J[3] * J[8];
      const double c02 = J[3] * J[7] - J[4] * J[6];
      det = J[0] * c00 + J[1] * c01 + J[2] * c02;
      const double inv = 1.0 / det;
      G[0] = c00 * inv;
      G[1] = (J[2] * J[7] - J[1] * J[8]) * inv;
      G[2] = (J[1] * J[5] - J[2] * J[4]) * inv;
      G[3] = c01 * inv;
      G[4] = (J[0] * J[8] - J[2] * J[6]) * inv;
      G[5] = (J[2] * J[3] - J[0] * J[5]) * inv;
      G[6] = c02 * inv;
      G[7] = (J[1] * J[6] - J[0] * J[7]) * inv;
      G[8] = (J[0] * J[4] - J[1] * J[3]) * inv;
    }
    detj[e] = det;
    double max_farea = 0.0;
    for (int32_t f = 0; f < nf; ++f) {
      const int64_t* fv = face_vertices + f * dim;
      const double* p0 = verts + cv[fv[0]] * dim;
      const double* opp = verts + cv[f] * dim;
      double n[3], sj;
      if (dim == 2) {
        const double* p1 = verts + cv[fv[1]] * dim;
        const double tx = p1[0] - p0[0], ty = p1[1] - p0[1];
        sj = std::sqrt(tx * tx + ty * ty);
        n[0] = ty;
        n[1] = -tx;
      } else {
        const double* p1 = verts + cv[fv[1]] * dim;
        const double* p2 = verts + cv[fv[2]] * dim;
        const double a0 = p1[0] - p0[0], a1 = p1[1] - p0[1],
                     a2 = p1[2] - p0[2];
        const double b0 = p2[0] - p0[0], b1 = p2[1] - p0[1],
                     b2 = p2[2] - p0[2];
        n[0] = a1 * b2 - a2 * b1;
        n[1] = a2 * b0 - a0 * b2;
        n[2] = a0 * b1 - a1 * b0;
        sj = std::sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
      }
      double nn = 0.0, dot = 0.0;
      for (int32_t d = 0; d < dim; ++d) nn += n[d] * n[d];
      nn = std::sqrt(nn);
      for (int32_t d = 0; d < dim; ++d) {
        n[d] /= nn;
        dot += n[d] * (p0[d] - opp[d]);
      }
      const double sign = (dot < 0.0) ? -1.0 : 1.0;
      for (int32_t d = 0; d < dim; ++d)
        normals[(e * nf + f) * dim + d] = sign * n[d];
      fscale[e * nf + f] = sj / det;
      const double farea = sj / fact_fdim;
      if (farea > max_farea) max_farea = farea;
    }
    h[e] = dim * (det / fact_dim) / max_farea;
  }
}

// Directed halo needs: the cross-shard (dst <- src) sorted-unique global
// node-id lists of parallel/partition.py's make_plan (its lexsort +
// per-pair np.unique block — the O(N log N) hot part of halo planning).
// gids/src/dst: (n,) cross-shard references.  Writes the per-pair unique
// gids consecutively into out_gids (caller-allocated, size >= n) in
// (dst, src) key order and the per-pair counts into counts (P*P, keyed
// dst*P + src).  Returns the total number written.
int64_t halo_needs(const int64_t* gids, const int32_t* src,
                   const int32_t* dst, int64_t n, int32_t P,
                   int64_t* out_gids, int64_t* counts) {
  std::vector<int64_t> idx(n);
  std::iota(idx.begin(), idx.end(), 0);
  auto key = [src, dst, P](int64_t i) {
    return static_cast<int64_t>(dst[i]) * P + src[i];
  };
  std::sort(idx.begin(), idx.end(), [&](int64_t a, int64_t b) {
    const int64_t ka = key(a), kb = key(b);
    if (ka != kb) return ka < kb;
    return gids[a] < gids[b];
  });
  std::memset(counts, 0, sizeof(int64_t) * static_cast<int64_t>(P) * P);
  int64_t m = 0;
  for (int64_t t = 0; t < n; ++t) {
    const int64_t i = idx[t];
    if (t > 0) {
      const int64_t j = idx[t - 1];
      if (key(i) == key(j) && gids[i] == gids[j]) continue;  // dup
    }
    out_gids[m++] = gids[i];
    ++counts[key(i)];
  }
  return m;
}

// Decode partner slots into neighbour node ids + boundary flags in one pass.
// partner: (E*nf*nfp,) slot ids; fnodes: (nf*nfp,) local node ids
// nbr_out[i] = (partner[i] / (nf*nfp)) * n_p + fnodes[partner[i] % (nf*nfp)]
// self_out[face] = all slots of the face map to themselves (boundary).
void decode_partners(const int64_t* partner, int64_t n_rows, int32_t nf,
                     int32_t nfp, int32_t n_p, const int64_t* fnodes,
                     int32_t* nbr_out, uint8_t* selfpair_out) {
  const int64_t per_elem = static_cast<int64_t>(nf) * nfp;
  for (int64_t i = 0; i < n_rows; ++i) {
    const int64_t p = partner[i];
    const int64_t e = p / per_elem;
    const int64_t slot = p % per_elem;
    nbr_out[i] = static_cast<int32_t>(e * n_p + fnodes[slot]);
    selfpair_out[i] = (p == i) ? 1 : 0;
  }
}

}  // extern "C"
