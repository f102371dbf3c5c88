// One anti-diagonal step of the banded Needleman-Wunsch recurrence, shared
// by the fill (band_fill.cu) and the walk's segment recompute (walk.cu).
//
// A band holds rows i0 .. i0 + rb of the DP. Lane q is row i0 + q; on local
// anti-diagonal dl it holds cell (i0 + q, j = dl - q). Each thread owns CELLS
// consecutive lanes and keeps them in registers:
//   p1[c]  = cell on diagonal dl - 1 at lane q      (left neighbour)
//   p1s[c] = cell on diagonal dl - 1 at lane q - 1  (up neighbour)
//   p2s[c] = cell on diagonal dl - 2 at lane q - 1  (diagonal neighbour)
//   yd[c]  = code of y[j - 1] for the lane on the current diagonal
// The only values that cross threads are the last lane's p1 and yd, passed to
// the next thread through a double-buffered shared array: one __syncthreads
// per step. The recurrence and borders are those of msa_tpu/ops/pallas_nw.py
// (:187-202): cur = min(p2s + (x == y ? 0 : pxy), min(p1, p1s) + pgap), the
// top lane (q == 0) from the carried boundary row, the left border
// (q == dl, j == 0) analytic.
#pragma once

#include <cuda_runtime.h>

#define CELLS 8
#define MAX_THREADS 1024
#define NEG_FILL (1 << 30)
#define X_SENTINEL (-1)
#define Y_SENTINEL (-2)

// Columns of the per-pair parameter table (int64), see ops/band_fill.py.
enum { P_M, P_N, P_XG, P_YG, P_NB, P_S, P_SNAP_OFF, P_ROWS_OFF, P_MOVES_OFF, NCOL };

struct Band {
  const unsigned char* x;  // gene codes of the pair's first sequence
  const unsigned char* y;  // ... and of its second
  const int* top;          // bottom row of band b - 1 (column j at j - 1); null for band 0
  int n, i0, rows, pxy, pgap;
};

__device__ __forceinline__ int ycode(const Band& B, int idx) {
  return (idx >= 0 && idx < B.n) ? (int)B.y[idx] : Y_SENTINEL;
}

__device__ __forceinline__ int xcode(const Band& B, int q) {
  return (q >= 1 && q <= B.rows) ? (int)B.x[B.i0 + q - 1] : X_SENTINEL;
}

// dp[i0][dl]: the top lane's value on diagonal dl (>= 1). Columns past n are
// never read by a valid cell; both versions give them NEG_FILL.
__device__ __forceinline__ int top_value(const Band& B, int dl) {
  if (dl > B.n) return NEG_FILL;
  return B.top ? B.top[dl - 1] : dl * B.pgap;
}

struct Lanes {
  int x[CELLS], yd[CELLS], p1[CELLS], p1s[CELLS], p2s[CELLS];
};

// Advance this thread's lanes by one diagonal. ``ny`` is the y code entering
// lane q0 (from the previous thread, or the feed for thread 0); ``topv`` is
// used only by lane q == 0. ``on_cell(c, q, cur, match, t1, t2, up, left)``
// sees each new cell before the state moves on. After the call, p1s[0] still
// needs the previous thread's last p1 (set by the caller after the barrier).
template <class OnCell>
__device__ __forceinline__ void step_cells(Lanes& L, int q0, int dl, int ny,
                                           int topv, const Band& B,
                                           OnCell on_cell) {
#pragma unroll
  for (int c = CELLS - 1; c > 0; --c) L.yd[c] = L.yd[c - 1];
  L.yd[0] = ny;
#pragma unroll
  for (int c = CELLS - 1; c >= 0; --c) {
    const int q = q0 + c;
    const bool match = L.x[c] == L.yd[c];
    const int t1 = L.p2s[c] + (match ? 0 : B.pxy);
    const int t2 = min(L.p1[c], L.p1s[c]) + B.pgap;
    int cur = min(t1, t2);
    if (q == 0) cur = topv;
    if (q == dl) cur = (B.i0 + dl) * B.pgap;
    on_cell(c, q, cur, match, t1, t2, L.p1s[c], L.p1[c]);
    L.p2s[c] = L.p1s[c];
    L.p1[c] = cur;
    if (c + 1 < CELLS) L.p1s[c + 1] = cur;
  }
}

// Threads for ``lanes`` lanes, rounded to whole warps; 0 if over one block.
static inline int threads_for(int lanes) {
  int t = ((lanes + CELLS - 1) / CELLS + 31) / 32 * 32;
  return t > MAX_THREADS ? 0 : t;
}
