// Hungarian (Kuhn-Munkres) assignment solver — native runtime component.
//
// Native replacement for the reference's RcppHungarian dependency
// (/root/reference/R/helpers.R:343). The posterior-ensemble signature
// assignment runs one O(n^3) solve per posterior sample (~1000 solves of
// ~N_est x ~79 cost matrices per plot call), so this lives in C++ and is
// driven host-side over gathered samples via ctypes. Implemented as the
// standard shortest-augmenting-path formulation (Jonker-Volgenant style
// potentials) for rectangular cost matrices, minimizing total cost.
//
// C ABI:
//   hungarian_solve(cost, n_rows, n_cols, row_assignment)
//     cost: row-major double[n_rows * n_cols]
//     row_assignment: out int[n_rows]; -1 when a row is unassigned
//     returns total cost of the assignment.
//   hungarian_solve_batch(costs, batch, n_rows, n_cols, row_assignments)
//     independent solves over a batch (OpenMP-free simple loop; callers
//     batch across posterior samples).

#include <cstdint>
#include <limits>
#include <vector>

extern "C" {

double hungarian_solve(const double* cost, int32_t n_rows, int32_t n_cols,
                       int32_t* row_assignment) {
  // Transpose so rows <= cols (pad conceptually; algorithm needs n <= m).
  const bool transposed = n_rows > n_cols;
  const int n = transposed ? n_cols : n_rows;  // small side
  const int m = transposed ? n_rows : n_cols;  // large side
  auto C = [&](int i, int j) -> double {
    return transposed ? cost[(int64_t)j * n_cols + i]
                      : cost[(int64_t)i * n_cols + j];
  };

  const double INF = std::numeric_limits<double>::infinity();
  // potentials over rows (1..n) and cols (1..m); way[j] = previous col on the
  // augmenting path; matched_row[j] = row matched to col j (0 = none).
  std::vector<double> u(n + 1, 0.0), v(m + 1, 0.0);
  std::vector<int> matched_row(m + 1, 0), way(m + 1, 0);

  for (int i = 1; i <= n; ++i) {
    matched_row[0] = i;
    int j0 = 0;
    std::vector<double> minv(m + 1, INF);
    std::vector<char> used(m + 1, 0);
    do {
      used[j0] = 1;
      int i0 = matched_row[j0], j1 = -1;
      double delta = INF;
      for (int j = 1; j <= m; ++j) {
        if (used[j]) continue;
        double cur = C(i0 - 1, j - 1) - u[i0] - v[j];
        if (cur < minv[j]) {
          minv[j] = cur;
          way[j] = j0;
        }
        if (minv[j] < delta) {
          delta = minv[j];
          j1 = j;
        }
      }
      for (int j = 0; j <= m; ++j) {
        if (used[j]) {
          u[matched_row[j]] += delta;
          v[j] -= delta;
        } else {
          minv[j] -= delta;
        }
      }
      j0 = j1;
    } while (matched_row[j0] != 0);
    // augment along the path
    do {
      int j1 = way[j0];
      matched_row[j0] = matched_row[j1];
      j0 = j1;
    } while (j0 != 0);
  }

  for (int32_t r = 0; r < n_rows; ++r) row_assignment[r] = -1;
  double total = 0.0;
  for (int j = 1; j <= m; ++j) {
    if (matched_row[j] == 0) continue;
    int i = matched_row[j] - 1;  // small-side index
    int row = transposed ? (j - 1) : i;
    int col = transposed ? i : (j - 1);
    row_assignment[row] = col;
    total += cost[(int64_t)row * n_cols + col];
  }
  return total;
}

void hungarian_solve_batch(const double* costs, int32_t batch, int32_t n_rows,
                           int32_t n_cols, int32_t* row_assignments) {
  const int64_t mat = (int64_t)n_rows * n_cols;
  for (int32_t b = 0; b < batch; ++b) {
    hungarian_solve(costs + b * mat, n_rows, n_cols,
                    row_assignments + (int64_t)b * n_rows);
  }
}

}  // extern "C"
