// Host lattice growth for chessboard detection, the one combinatorial stage
// of the detection pipeline that does not belong on the accelerator.
//
// The port's copy of the JAX package's native/src/lattice.cc (same
// algorithm, same results), built on its own with the host C++ compiler
// (ops/_build.py: load_host_library("lattice")) and bound with ctypes in
// detection/native_lattice.py. It needs the C++ standard library only.
//
// Semantics mirror detection/detector.py `_grow_lattice_numpy` (score
// filter, dedup, pitch estimate, seeded BFS growth at rung 0 with the
// default hole budget); window extraction and scoring stay in Python. The
// numpy path is the plain version it is tested against
// (tests/test_torch_native_lattice.py: the same kept candidates and pitch,
// the same corner set, the lattice up to coordinate symmetry).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <unordered_map>
#include <vector>

namespace {

constexpr int kHoleTolerance = 3;  // detector.py _HOLE_TOLERANCE

struct P2 {
  double x, y;
};

inline double d2(const P2& a, const P2& b) {
  const double dx = a.x - b.x, dy = a.y - b.y;
  return dx * dx + dy * dy;
}

// Median matching np.median: average of the two middle elements for even n.
double median_inplace(std::vector<double>& v) {
  const size_t n = v.size();
  if (n == 0) return std::numeric_limits<double>::quiet_NaN();
  const size_t mid = n / 2;
  std::nth_element(v.begin(), v.begin() + mid, v.end());
  double hi = v[mid];
  if (n % 2) return hi;
  double lo = *std::max_element(v.begin(), v.begin() + mid);
  return 0.5 * (lo + hi);
}

struct Key {
  int i, j;
  bool operator==(const Key& o) const { return i == o.i && j == o.j; }
};
struct KeyHash {
  size_t operator()(const Key& k) const {
    return std::hash<int64_t>()((int64_t(k.i) << 32) ^ uint32_t(k.j));
  }
};

}  // namespace

extern "C" {

// Score-filter, dedup, pitch estimate, and seeded BFS lattice growth.
//
//   pts_in  (n_in, 2) float64 candidate positions
//   sc_in   (n_in,)  float64 saddle scores
//   rows, cols       board shape (n_needed = rows*cols)
//   pitch_tol        admission tolerance (fraction of lattice pitch)
//
// Outputs (caller-allocated):
//   keep_out  (n_in,)  int32  indices into the INPUT arrays of the kept
//                             (score-filtered, deduped) candidates, in
//                             descending-score order — the coordinate space
//                             of cells_out's idx column
//   n_keep_out         number of kept candidates
//   pitch_out          estimated lattice pitch (valid when n_keep >= n_needed)
//   cells_out (3*n_keep,) int32  (i, j, idx) triplets of the grown grid
//   n_cells_out        number of grid cells (0 => no grid found)
//
// Returns 0 on success (even if no grid was found), -1 on invalid args.
int mccl_order_candidates(const double* pts_in, const double* sc_in, int n_in,
                          int rows, int cols, double pitch_tol,
                          int32_t* keep_out, int32_t* n_keep_out,
                          double* pitch_out, int32_t* cells_out,
                          int32_t* n_cells_out) {
  *n_keep_out = 0;
  *n_cells_out = 0;
  *pitch_out = 0.0;
  const int n_needed = rows * cols;
  if (n_in < 0 || rows <= 0 || cols <= 0) return -1;
  if (n_in < n_needed) return 0;

  // --- score filter: keep sc > 0.35 * (n_needed-th strongest) ----------
  std::vector<double> ssc(sc_in, sc_in + n_in);
  std::nth_element(ssc.begin(), ssc.begin() + (n_in - n_needed), ssc.end());
  const double ref_score = ssc[n_in - n_needed];
  std::vector<int> kept;
  kept.reserve(n_in);
  for (int i = 0; i < n_in; ++i)
    if (sc_in[i] > 0.35 * ref_score) kept.push_back(i);
  if ((int)kept.size() < n_needed) return 0;

  // --- dedup: greedy keep-strongest within 3 px ------------------------
  std::stable_sort(kept.begin(), kept.end(),
                   [&](int a, int b) { return sc_in[a] > sc_in[b]; });
  std::vector<P2> P(kept.size());
  for (size_t i = 0; i < kept.size(); ++i)
    P[i] = {pts_in[2 * kept[i]], pts_in[2 * kept[i] + 1]};
  std::vector<char> alive(kept.size(), 1);
  for (size_t a = 0; a < kept.size(); ++a) {
    if (!alive[a]) continue;
    for (size_t b = a + 1; b < kept.size(); ++b)
      if (alive[b] && d2(P[a], P[b]) <= 9.0) alive[b] = 0;
  }
  std::vector<P2> pts;
  std::vector<int> src_idx;  // kept index -> input index
  pts.reserve(kept.size());
  for (size_t i = 0; i < kept.size(); ++i)
    if (alive[i]) {
      pts.push_back(P[i]);
      src_idx.push_back(kept[i]);
    }
  const int n = (int)pts.size();
  for (int i = 0; i < n; ++i) keep_out[i] = src_idx[i];
  *n_keep_out = n;
  if (n < n_needed) return 0;

  // --- pitch: median nearest-neighbor distance among the TOP-n_needed
  // candidates by score (pts is score-sorted). Structured clutter — an
  // occlusion bar's edge draws a dense line of weak pseudo-corners —
  // would drag a global median to the clutter spacing (numpy oracle
  // parity: detector._grow_lattice_numpy).
  const int top = std::min(n_needed, n);
  std::vector<double> nn(top);
  for (int i = 0; i < top; ++i) {
    double best = std::numeric_limits<double>::infinity();
    for (int j = 0; j < top; ++j)
      if (j != i) best = std::min(best, d2(pts[i], pts[j]));
    nn[i] = std::sqrt(best);
  }
  const double pitch = median_inplace(nn);
  *pitch_out = pitch;

  // --- seed order: closest to centroid first ---------------------------
  P2 centroid{0.0, 0.0};
  for (const auto& p : pts) {
    centroid.x += p.x;
    centroid.y += p.y;
  }
  centroid.x /= n;
  centroid.y /= n;
  std::vector<int> seed_order(n);
  for (int i = 0; i < n; ++i) seed_order[i] = i;
  std::stable_sort(seed_order.begin(), seed_order.end(), [&](int a, int b) {
    return d2(pts[a], centroid) < d2(pts[b], centroid);
  });

  std::vector<char> used(n);
  auto nearest = [&](const P2& target, double tol) -> int {
    double best = std::numeric_limits<double>::infinity();
    int bj = -1;
    for (int j = 0; j < n; ++j) {
      if (used[j]) continue;
      const double dd = d2(pts[j], target);
      if (dd < best) {
        best = dd;
        bj = j;
      }
    }
    return (bj >= 0 && best < tol * tol) ? bj : -1;
  };

  using Grid = std::unordered_map<Key, int, KeyHash>;
  using VPos = std::unordered_map<Key, P2, KeyHash>;
  // Scaffold vertices (idx == -1, position in vpos): a lattice hole must
  // not block the BFS — growth continues through a predicted position so
  // the reachable region does not depend on which side of the hole the
  // seed landed. Scaffolds never chain (a new scaffold requires a REAL
  // extrapolation predecessor) and are dropped from the output grid;
  // mirrors detector.py _grow_lattice_numpy.
  VPos vpos;
  auto grow_from = [&](int seed, Grid& grid,
                       std::vector<Key>& order_added) -> bool {
    grid.clear();
    order_added.clear();
    vpos.clear();
    auto pos = [&](int idx, const Key& cell) -> P2 {
      return idx >= 0 ? pts[idx] : vpos.at(cell);
    };
    // Distance-sorted neighbors of the seed.
    std::vector<int> order;
    order.reserve(n - 1);
    for (int j = 0; j < n; ++j)
      if (j != seed) order.push_back(j);
    std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
      return d2(pts[a], pts[seed]) < d2(pts[b], pts[seed]);
    });
    if (order.empty()) return false;
    const P2 v1{pts[order[0]].x - pts[seed].x, pts[order[0]].y - pts[seed].y};
    bool have_v2 = false;
    P2 v2{0, 0};
    for (size_t k = 1; k < order.size() && k < 6; ++k) {
      const P2 cand{pts[order[k]].x - pts[seed].x,
                    pts[order[k]].y - pts[seed].y};
      const double cosang =
          std::fabs(cand.x * v1.x + cand.y * v1.y) /
          (std::sqrt(cand.x * cand.x + cand.y * cand.y) *
               std::sqrt(v1.x * v1.x + v1.y * v1.y) +
           1e-30);
      if (cosang < 0.7) {
        v2 = cand;
        have_v2 = true;
        break;
      }
    }
    if (!have_v2) return false;

    std::fill(used.begin(), used.end(), 0);
    auto put = [&](Key k, int idx) {
      grid.emplace(k, idx);
      used[idx] = 1;
      order_added.push_back(k);
    };
    put({0, 0}, seed);
    put({1, 0}, order[0]);
    const int j2 =
        nearest({pts[seed].x + v2.x, pts[seed].y + v2.y}, pitch_tol * pitch * 2);
    if (j2 < 0) return false;
    put({0, 1}, j2);

    // BFS growth: extrapolate from two collinear predecessors, else copy
    // the parallel step from a neighboring row/column.
    std::vector<Key> frontier = order_added;
    const int dirs[4][2] = {{1, 0}, {-1, 0}, {0, 1}, {0, -1}};
    while (!frontier.empty()) {
      std::vector<Key> next;
      for (const Key& f : frontier) {
        for (const auto& d : dirs) {
          const Key tgt{f.i + d[0], f.j + d[1]};
          // A scaffold cell stays open to UPGRADE (a later visit from an
          // orthogonal direction may find a real candidate its first
          // prediction missed — the pre-scaffold retry behavior); real
          // cells are final. Mirrors detector.py.
          auto it_t = grid.find(tgt);
          if (it_t != grid.end() && it_t->second >= 0) continue;
          const int p1 = grid.at(f);
          const P2 q1 = pos(p1, f);
          P2 pred;
          const Key k0{f.i - d[0], f.j - d[1]};
          auto it0 = grid.find(k0);
          if (it0 != grid.end()) {
            const P2 q0 = pos(it0->second, k0);
            pred = {2 * q1.x - q0.x, 2 * q1.y - q0.y};
          } else {
            bool found = false;
            const int par[2][2] = {{d[1], d[0]}, {-d[1], -d[0]}};
            for (const auto& o : par) {
              const Key ka{f.i + o[0], f.j + o[1]};
              const Key kb{f.i + o[0] + d[0], f.j + o[1] + d[1]};
              auto ia = grid.find(ka);
              auto ib = grid.find(kb);
              if (ia != grid.end() && ib != grid.end()) {
                const P2 qa = pos(ia->second, ka), qb = pos(ib->second, kb);
                pred = {q1.x + qb.x - qa.x, q1.y + qb.y - qa.y};
                found = true;
                break;
              }
            }
            if (!found) continue;
          }
          const int cand = nearest(pred, pitch_tol * pitch);
          if (cand >= 0) {
            if (it_t != grid.end()) {  // upgrade scaffold -> real
              grid.erase(it_t);
              vpos.erase(tgt);
            }
            put(tgt, cand);
            next.push_back(tgt);
          } else if (p1 >= 0 && it_t == grid.end()) {
            // Hole: scaffold through it (only from a real predecessor —
            // scaffolds do not chain, and a cell scaffolds at most once).
            grid.emplace(tgt, -1);
            vpos.emplace(tgt, pred);
            next.push_back(tgt);
          }
        }
      }
      frontier.swap(next);
    }
    int n_real = 0;
    for (const auto& kv : grid)
      if (kv.second >= 0) ++n_real;
    return n_real >= n_needed - kHoleTolerance;
  };

  Grid grid;
  std::vector<Key> order_added;
  const int n_seeds = std::min(5, n);
  for (int s = 0; s < n_seeds; ++s) {
    if (grow_from(seed_order[s], grid, order_added)) {
      for (size_t k = 0; k < order_added.size(); ++k) {
        cells_out[3 * k] = order_added[k].i;
        cells_out[3 * k + 1] = order_added[k].j;
        cells_out[3 * k + 2] = grid.at(order_added[k]);
      }
      *n_cells_out = (int32_t)order_added.size();
      return 0;
    }
  }
  return 0;  // no grid
}

}  // extern "C"
