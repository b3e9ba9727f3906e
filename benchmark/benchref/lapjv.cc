// Frozen copy of busca_tpu_torch/csrc/lapjv.cc at commit c2c24f5 (the
// benchmark reference's assignment solver).
// Dense linear-assignment-problem solver (Jonker-Volgenant style successive
// shortest augmenting paths with dual potentials), exposed via a C ABI for
// ctypes.  This is the host-side assignment engine of the framework: the TPU
// computes cost matrices (IoU / fused-score / association probabilities) and
// this solves the branchy sequential matching, replacing the reference's
// `lap.lapjv` and `lapsolver.solve_dense` pip dependencies
// (adapters/ByteTrack/yolox/tracker/matching.py:39-50,
//  adapters/GHOST/src/tracker.py:400).
//
// Build: g++ -O3 -march=native -shared -fPIC lapjv.cc -o liblapjv.so

#include <algorithm>
#include <cstdint>
#include <limits>
#include <vector>

namespace {
constexpr double kInf = std::numeric_limits<double>::infinity();
}

extern "C" {

// Solve the square dense LAP: minimize sum_i cost[i * n + x[i]].
//
//   cost : n*n row-major matrix (finite values; use large finite sentinels
//          instead of +inf for forbidden pairs)
//   n    : problem size
//   x    : out, x[i] = column assigned to row i
//   y    : out, y[j] = row assigned to column j
//
// Returns the total assignment cost.
double lapjv_dense(const double* cost, int32_t n, int32_t* x, int32_t* y) {
  if (n <= 0) return 0.0;
  for (int32_t i = 0; i < n; ++i) x[i] = -1;

  // Dual potentials. u[i] + v[j] <= cost[i][j] is maintained throughout.
  std::vector<double> u(n + 1, 0.0), v(n + 1, 0.0);
  // way[j]: previous column on the alternating path reaching column j.
  std::vector<int32_t> match_col(n + 1, n);  // match_col[j] = row matched to j
  std::vector<int32_t> way(n + 1, 0);

  for (int32_t i = 0; i < n; ++i) {
    // Find an augmenting path for row i (Dijkstra over reduced costs).
    int32_t j0 = n;              // virtual start column
    match_col[n] = i;
    std::vector<double> min_slack(n + 1, kInf);
    std::vector<char> used(n + 1, 0);
    int32_t cur_row = i;

    do {
      used[j0] = 1;
      cur_row = match_col[j0];
      double delta = kInf;
      int32_t j1 = -1;
      for (int32_t j = 0; j < n; ++j) {
        if (used[j]) continue;
        double slack = cost[cur_row * n + j] - u[cur_row] - v[j];
        if (slack < min_slack[j]) {
          min_slack[j] = slack;
          way[j] = j0;
        }
        if (min_slack[j] < delta) {
          delta = min_slack[j];
          j1 = j;
        }
      }
      // Update potentials so the chosen edge becomes tight.
      for (int32_t j = 0; j <= n; ++j) {
        if (used[j]) {
          u[match_col[j]] += delta;
          v[j] -= delta;
        } else {
          min_slack[j] -= delta;
        }
      }
      j0 = j1;
    } while (match_col[j0] != n);

    // Augment: flip matches along the path.
    do {
      int32_t j1 = way[j0];
      match_col[j0] = match_col[j1];
      j0 = j1;
    } while (j0 != n);
  }

  double total = 0.0;
  for (int32_t j = 0; j < n; ++j) {
    y[j] = (match_col[j] == n) ? -1 : match_col[j];
    if (y[j] >= 0) x[y[j]] = j;
  }
  for (int32_t i = 0; i < n; ++i) {
    if (x[i] >= 0) total += cost[i * n + x[i]];
  }
  return total;
}

}  // extern "C"
