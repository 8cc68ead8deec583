// Native setup routines for portable_multigrid_tpu_torch (a copy of
// portable_multigrid_tpu/native/pmg_native.cpp).
//
// The compute path is torch on the card; this library is the native host
// runtime tier — the counterpart of the C++ setup machinery the reference
// consumes from deal.II (DoFHandler::distribute_dofs and the
// cell->global-DoF harvesting in Portable::MatrixFree; reference:
// source/geometric_multigrid/program.cc:154-158,
// include/multigrid/portable_geometric_transfer.h:1088-1216).
//
// enumerate_dofs: continuous Q_p DoF numbering on unstructured hex/quad/line
// meshes with edge-direction and face-orientation matching.  MUST stay
// bit-identical to the pure-Python reference implementation in
// fem/dof_numbering.py (enforced by tests).
//
// Built by native/__init__.py into build/native/ at the repository root:
//   g++ -O3 -shared -fPIC -std=c++17 pmg_native.cpp -o libpmg_native.so

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct PairHash {
  size_t operator()(const std::pair<int64_t, int64_t>& p) const {
    return std::hash<int64_t>()(p.first * 0x9e3779b97f4a7c15LL + p.second);
  }
};

struct QuadKey {
  int64_t v[4];
  bool operator==(const QuadKey& o) const {
    return std::memcmp(v, o.v, sizeof(v)) == 0;
  }
};

struct QuadHash {
  size_t operator()(const QuadKey& k) const {
    size_t h = 1469598103934665603ULL;
    for (int i = 0; i < 4; ++i) {
      h ^= std::hash<int64_t>()(k.v[i]);
      h *= 1099511628211ULL;
    }
    return h;
  }
};

// D4 symmetry applied to a quad corner tuple c[s*2+t]:
// T(s,t) = flip(transpose(s,t)); out[s*2+t] = c[T(s,t)].
inline void face_apply(const int64_t c[4], int sym, int64_t out[4]) {
  int transpose = sym & 1, flip_s = (sym >> 1) & 1, flip_t = (sym >> 2) & 1;
  for (int s = 0; s < 2; ++s)
    for (int t = 0; t < 2; ++t) {
      int ss = transpose ? t : s;
      int tt = transpose ? s : t;
      if (flip_s) ss = 1 - ss;
      if (flip_t) tt = 1 - tt;
      out[s * 2 + t] = c[ss * 2 + tt];
    }
}

inline bool tuple_less(const int64_t a[4], const int64_t b[4]) {
  for (int i = 0; i < 4; ++i) {
    if (a[i] != b[i]) return a[i] < b[i];
  }
  return false;
}

inline int face_canon(const int64_t c[4], int64_t key[4]) {
  int best_sym = 0;
  int64_t best[4];
  face_apply(c, 0, best);
  for (int sym = 1; sym < 8; ++sym) {
    int64_t cand[4];
    face_apply(c, sym, cand);
    if (tuple_less(cand, best)) {
      std::memcpy(best, cand, sizeof(best));
      best_sym = sym;
    }
  }
  std::memcpy(key, best, sizeof(best));
  return best_sym;
}

// canonical coords of local (s, t): T^{-1} = transpose(flip(s, t))
inline void face_coord(int sym, int p, int& s, int& t) {
  int transpose = sym & 1, flip_s = (sym >> 1) & 1, flip_t = (sym >> 2) & 1;
  if (flip_s) s = p - s;
  if (flip_t) t = p - t;
  if (transpose) {
    int tmp = s;
    s = t;
    t = tmp;
  }
}

}  // namespace

extern "C" {

// Returns n_dofs (>= 0) or -1 on error.
// cells: [E, 2^dim]; l2g_out: [E, (p+1)^dim]; boundary_out: [E*(p+1)^dim]
// scratch marking (caller trims to n_dofs; 1.0 free / 0.0 boundary).
int64_t pmg_enumerate_dofs(int32_t dim, int32_t degree, int64_t E,
                           const int64_t* cells, int64_t* l2g_out,
                           double* mask_out, int64_t mask_capacity) {
  if (dim < 1 || dim > 3 || degree < 1) return -1;
  const int p = degree;
  const int nv = 1 << dim;
  int ndof = 1;
  for (int k = 0; k < dim; ++k) ndof *= (p + 1);
  int stride[3] = {1, 1, 1};
  for (int k = dim - 2; k >= 0; --k) stride[k] = stride[k + 1] * (p + 1);

  std::unordered_map<int64_t, int64_t> vertex_dof;
  std::unordered_map<std::pair<int64_t, int64_t>, int64_t, PairHash> edge_base;
  std::unordered_map<QuadKey, int64_t, QuadHash> face_base;
  int64_t next_dof = 0;

  auto local_vertex = [&](const int ii[3]) {
    int out = 0;
    for (int k = 0; k < dim; ++k) out = out * 2 + (ii[k] == p ? 1 : 0);
    return out;
  };

  // --- boundary face counting ------------------------------------------
  std::unordered_map<QuadKey, int32_t, QuadHash> face_count;
  auto sorted_key = [&](const int64_t* vs, int n) {
    QuadKey k{{-1, -1, -1, -1}};
    for (int i = 0; i < n; ++i) k.v[i] = vs[i];
    // insertion sort of up to 4
    for (int i = 1; i < n; ++i)
      for (int j = i; j > 0 && k.v[j] < k.v[j - 1]; --j)
        std::swap(k.v[j], k.v[j - 1]);
    return k;
  };

  const int n_cell_faces = 2 * dim;
  std::vector<QuadKey> cell_face_keys((size_t)E * n_cell_faces);
  for (int64_t e = 0; e < E; ++e) {
    const int64_t* cv = cells + e * nv;
    int f = 0;
    for (int axis = 0; axis < dim; ++axis) {
      for (int side = 0; side < 2; ++side, ++f) {
        int64_t vs[4];
        int n = 0;
        if (dim == 3) {
          int rest[2], r = 0;
          for (int k = 0; k < 3; ++k)
            if (k != axis) rest[r++] = k;
          for (int a = 0; a < 2; ++a)
            for (int b = 0; b < 2; ++b) {
              int ii[3] = {0, 0, 0};
              ii[axis] = side;
              ii[rest[0]] = a;
              ii[rest[1]] = b;
              vs[n++] = cv[ii[0] * 4 + ii[1] * 2 + ii[2]];
            }
        } else if (dim == 2) {
          for (int a = 0; a < 2; ++a) {
            int ii[2] = {0, 0};
            ii[axis] = side;
            ii[1 - axis] = a;
            vs[n++] = cv[ii[0] * 2 + ii[1]];
          }
        } else {
          vs[n++] = cv[side];
        }
        QuadKey key = sorted_key(vs, n);
        face_count[key] += 1;
        cell_face_keys[e * n_cell_faces + f] = key;
      }
    }
  }

  // --- numbering ---------------------------------------------------------
  for (int64_t e = 0; e < E; ++e) {
    const int64_t* cv = cells + e * nv;
    int64_t* out = l2g_out + e * ndof;
    for (int loc = 0; loc < ndof; ++loc) {
      int ii[3] = {0, 0, 0};
      int rem = loc;
      for (int k = 0; k < dim; ++k) {
        ii[k] = rem / stride[k];
        rem %= stride[k];
      }
      int n_interior = 0;
      for (int k = 0; k < dim; ++k)
        if (ii[k] != 0 && ii[k] != p) ++n_interior;

      if (n_interior == 0) {
        int64_t v = cv[local_vertex(ii)];
        auto it = vertex_dof.find(v);
        if (it == vertex_dof.end())
          it = vertex_dof.emplace(v, next_dof++).first;
        out[loc] = it->second;
      } else if (n_interior == 1 && dim > 1) {
        int k = 0;
        while (ii[k] == 0 || ii[k] == p) ++k;
        int iia[3], iib[3];
        std::memcpy(iia, ii, sizeof(iia));
        std::memcpy(iib, ii, sizeof(iib));
        iia[k] = 0;
        iib[k] = p;
        int64_t va = cv[local_vertex(iia)];
        int64_t vb = cv[local_vertex(iib)];
        auto key = std::make_pair(va < vb ? va : vb, va < vb ? vb : va);
        auto it = edge_base.find(key);
        if (it == edge_base.end()) {
          it = edge_base.emplace(key, next_dof).first;
          next_dof += p - 1;
        }
        int t = (va > vb) ? (p - ii[k]) : ii[k];
        out[loc] = it->second + (t - 1);
      } else if (n_interior == 2 && dim == 3) {
        int k = 0;
        while (ii[k] != 0 && ii[k] != p) ++k;
        int free_ax[2], r = 0;
        for (int a = 0; a < 3; ++a)
          if (a != k) free_ax[r++] = a;
        int64_t corners[4];
        int c = 0;
        for (int a = 0; a <= p; a += p)
          for (int b = 0; b <= p; b += p) {
            int jj[3];
            std::memcpy(jj, ii, sizeof(jj));
            jj[free_ax[0]] = a;
            jj[free_ax[1]] = b;
            corners[c++] = cv[local_vertex(jj)];
          }
        QuadKey key;
        int sym = face_canon(corners, key.v);
        auto it = face_base.find(key);
        if (it == face_base.end()) {
          it = face_base.emplace(key, next_dof).first;
          next_dof += (int64_t)(p - 1) * (p - 1);
        }
        int s = ii[free_ax[0]], t = ii[free_ax[1]];
        face_coord(sym, p, s, t);
        out[loc] = it->second + (int64_t)(s - 1) * (p - 1) + (t - 1);
      }
    }
    // cell interiors: contiguous block per cell
    if (p > 1) {
      for (int loc = 0; loc < ndof; ++loc) {
        int ii[3] = {0, 0, 0};
        int rem = loc;
        bool interior = true;
        for (int k = 0; k < dim; ++k) {
          ii[k] = rem / stride[k];
          rem %= stride[k];
          if (ii[k] == 0 || ii[k] == p) interior = false;
        }
        if (!interior) continue;
        int64_t idx = 0;
        for (int k = 0; k < dim; ++k) idx = idx * (p - 1) + (ii[k] - 1);
        out[loc] = next_dof + idx;
      }
      int64_t n_int = 1;
      for (int k = 0; k < dim; ++k) n_int *= (p - 1);
      next_dof += n_int;
    }
  }

  // --- boundary mask ------------------------------------------------------
  if (next_dof > mask_capacity) return -1;
  for (int64_t d = 0; d < next_dof; ++d) mask_out[d] = 1.0;
  for (int64_t e = 0; e < E; ++e) {
    const int64_t* out = l2g_out + e * ndof;
    int f = 0;
    for (int axis = 0; axis < dim; ++axis) {
      for (int side = 0; side < 2; ++side, ++f) {
        if (face_count[cell_face_keys[e * n_cell_faces + f]] != 1) continue;
        for (int loc = 0; loc < ndof; ++loc) {
          int coord = (loc / stride[axis]) % (p + 1);
          if (coord == (side == 0 ? 0 : p)) mask_out[out[loc]] = 0.0;
        }
      }
    }
  }
  return next_dof;
}

// Valence (1/count) weights of DoFs over cells — the reference's transfer
// weight setup (include/multigrid/portable_geometric_transfer.h:1337-1343).
void pmg_valence_weights(int64_t E, int32_t ndof, const int64_t* l2g,
                         int64_t n_dofs, double* weights_out) {
  for (int64_t d = 0; d < n_dofs; ++d) weights_out[d] = 0.0;
  for (int64_t i = 0; i < E * ndof; ++i) weights_out[l2g[i]] += 1.0;
  for (int64_t d = 0; d < n_dofs; ++d)
    if (weights_out[d] > 0.0) weights_out[d] = 1.0 / weights_out[d];
}

}  // extern "C"
