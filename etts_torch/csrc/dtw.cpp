// DTW core of the evaluation suite (own copy of ``native/dtw.cpp``).
//
// Every (reference, synthesized) pair is DTW-aligned before it is scored.
// The O(n*m) dynamic program carries a dependency along its inner axis, so
// it runs here in C++, built with the host compiler at first use and
// loaded through ctypes (etts_torch/evalsuite/dtw.py). Banded alignments
// pass +inf outside the band in ``cost``.
//
// Exported C ABI:
//   dtw_accumulate(cost[n*m], n, m, acc[(n+1)*(m+1)])  -> fills acc
//   dtw_backtrack(acc, n, m, path_i[n+m], path_j[n+m]) -> path length
#include <cstdint>
#include <cmath>
#include <limits>

extern "C" {

void dtw_accumulate(const double* cost, int64_t n, int64_t m, double* acc) {
    const double INF = std::numeric_limits<double>::infinity();
    const int64_t W = m + 1;
    for (int64_t j = 0; j <= m; ++j) acc[j] = INF;
    acc[0] = 0.0;
    for (int64_t i = 1; i <= n; ++i) {
        double* cur = acc + i * W;
        const double* prev = acc + (i - 1) * W;
        const double* c = cost + (i - 1) * m;
        cur[0] = INF;
        for (int64_t j = 1; j <= m; ++j) {
            double best = prev[j];
            if (prev[j - 1] < best) best = prev[j - 1];
            if (cur[j - 1] < best) best = cur[j - 1];
            cur[j] = c[j - 1] + best;
        }
    }
}

int64_t dtw_backtrack(const double* acc, int64_t n, int64_t m,
                      int64_t* path_i, int64_t* path_j) {
    const int64_t W = m + 1;
    int64_t i = n, j = m, len = 0;
    while (i > 0 && j > 0) {
        path_i[len] = i - 1;
        path_j[len] = j - 1;
        ++len;
        const double d = acc[(i - 1) * W + (j - 1)];
        const double u = acc[(i - 1) * W + j];
        const double l = acc[i * W + (j - 1)];
        if (d <= u && d <= l) { --i; --j; }
        else if (u <= l)      { --i; }
        else                  { --j; }
    }
    // path is emitted in reverse order; caller reverses
    return len;
}

}  // extern "C"
