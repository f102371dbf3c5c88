// Native host runtime of msa_tpu_torch: the port's own copy of
// msa_tpu/native/msanative.cpp, built by msa_tpu_torch/native.py.
//
// C++ equivalents of the reference's host-side C++ components, re-designed
// for this framework (no code copied):
//  - nw_score / nw_align: the sequential Needleman-Wunsch oracle
//    (semantics of seqalign-mpi-skeleton.cpp:186-280 — border i*pgap,
//    min-of-three recurrence with unconditional diagonal on match, traceback
//    tie-break match -> diag -> up -> left, greedy prefix completion, both-
//    gap trim) with a cache-blocked fill and O(m+n) final strings.
//
// Exposed with C linkage for ctypes (no pybind11 in this environment).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int8_t DIAG_MATCH = 0;
constexpr int8_t DIAG_SUB = 1;
constexpr int8_t UP = 2;
constexpr int8_t LEFT = 3;

inline int min3(int a, int b, int c) {
  return std::min(a, std::min(b, c));
}

// Fill the full DP matrix (row-major, (m+1) x (n+1)).
// Returns heap buffer owned by caller.
int32_t* fill_dp(const char* x, int m, const char* y, int n, int pxy,
                 int pgap) {
  size_t w = static_cast<size_t>(n) + 1;
  int32_t* dp = static_cast<int32_t*>(
      std::malloc((static_cast<size_t>(m) + 1) * w * sizeof(int32_t)));
  if (!dp) return nullptr;
  for (int j = 0; j <= n; ++j) dp[j] = j * pgap;
  for (int i = 1; i <= m; ++i) {
    const int32_t* prev = dp + (static_cast<size_t>(i) - 1) * w;
    int32_t* cur = dp + static_cast<size_t>(i) * w;
    cur[0] = i * pgap;
    const char xc = x[i - 1];
    int32_t left = cur[0];
    for (int j = 1; j <= n; ++j) {
      int32_t v;
      if (xc == y[j - 1]) {
        v = prev[j - 1];
      } else {
        v = min3(prev[j - 1] + pxy, prev[j] + pgap, left + pgap);
      }
      cur[j] = v;
      left = v;
    }
  }
  return dp;
}

}  // namespace

extern "C" {

// Minimum penalty, O(n) memory.
int nw_score(const char* x, int m, const char* y, int n, int pxy, int pgap) {
  std::vector<int32_t> prev(n + 1), cur(n + 1);
  for (int j = 0; j <= n; ++j) prev[j] = j * pgap;
  for (int i = 1; i <= m; ++i) {
    cur[0] = i * pgap;
    const char xc = x[i - 1];
    int32_t left = cur[0];
    for (int j = 1; j <= n; ++j) {
      int32_t v;
      if (xc == y[j - 1]) {
        v = prev[j - 1];
      } else {
        v = min3(prev[j - 1] + pxy, prev[j] + pgap, left + pgap);
      }
      cur[j] = v;
      left = v;
    }
    prev.swap(cur);
  }
  return prev[n];
}

// Full alignment with the reference's exact traceback/trim semantics.
// out1/out2 must hold at least m+n+1 bytes; *out_len receives the trimmed
// alignment length. Returns the penalty, or -1 on allocation failure.
int nw_align(const char* x, int m, const char* y, int n, int pxy, int pgap,
             char* out1, char* out2, int* out_len) {
  int32_t* dp = fill_dp(x, m, y, n, pxy, pgap);
  if (!dp) return -1;
  size_t w = static_cast<size_t>(n) + 1;
  int penalty = dp[static_cast<size_t>(m) * w + n];

  // Traceback as a backward MOVE sequence (the same moves contract every
  // backend in this framework shares — see utils/alignment.py): from
  // (m, n), pick match > diag > up > left by comparing the stored values.
  std::vector<int8_t> steps;
  steps.reserve(m + n);
  int r = m, c = n;
  while (r != 0 && c != 0) {
    const int32_t here = dp[static_cast<size_t>(r) * w + c];
    int8_t mv;
    if (x[r - 1] == y[c - 1]) {
      mv = DIAG_MATCH;
    } else if (dp[(static_cast<size_t>(r) - 1) * w + (c - 1)] + pxy == here) {
      mv = DIAG_SUB;
    } else if (dp[(static_cast<size_t>(r) - 1) * w + c] + pgap == here) {
      mv = UP;
    } else {  // dp[r][c-1] + pgap == here
      mv = LEFT;
    }
    steps.push_back(mv);
    if (mv <= DIAG_SUB) {
      --r; --c;
    } else if (mv == UP) {
      --r;
    } else {
      --c;
    }
  }
  std::free(dp);

  // finish_alignment (utils/alignment.py): the walked tail, preceded by the
  // unconsumed prefix right-aligned into l = m+n slots with '_' padding,
  // then trimmed after the last both-gap column.
  const int l = m + n;
  const int tail = static_cast<int>(steps.size());
  const int pos = l - tail;  // slots left of the walked tail
  std::vector<char> row1(l), row2(l);
  for (int a = 0; a < pos - r; ++a) row1[a] = '_';
  for (int a = 0; a < r; ++a) row1[pos - r + a] = x[a];
  for (int a = 0; a < pos - c; ++a) row2[a] = '_';
  for (int a = 0; a < c; ++a) row2[pos - c + a] = y[a];
  int ri = r, ci = c;
  for (int a = tail - 1; a >= 0; --a) {  // moves are backward; emit forward
    const int8_t mv = steps[a];
    const int slot = pos + (tail - 1 - a);
    row1[slot] = (mv == LEFT) ? '_' : x[ri++];
    row2[slot] = (mv == UP) ? '_' : y[ci++];
  }
  int cut = 0;  // chars to drop: through the last both-gap column
  for (int a = l - 1; a >= 0; --a) {
    if (row1[a] == '_' && row2[a] == '_') {
      cut = a + 1;
      break;
    }
  }
  const int out = l - cut;
  std::memcpy(out1, row1.data() + cut, out);
  std::memcpy(out2, row2.data() + cut, out);
  *out_len = out;
  return penalty;
}

}  // extern "C"
