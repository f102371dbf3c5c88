// One anti-diagonal step of the banded Needleman-Wunsch recurrence, shared
// by the fills (band_fill.cu, conveyor_fill.cu) and the walk's segment
// recompute (walk.cu).
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
// (:187-202) and msa_tpu/ops/conveyor.py (:483-495): cur = min(p2s + (x == y
// ? 0 : pxy), min(p1, p1s) + pgap), the top lane (q == 0) from the carried
// boundary row, the left border (one lane, j == 0) injected analytic.
#pragma once

#include <cuda_runtime.h>

#define CELLS 8
#define MAX_THREADS 1024
#define NEG_FILL (1 << 30)
#define X_SENTINEL (-1)
#define Y_SENTINEL (-2)

// Columns of the banded fill's per-pair table (int64), see ops/band_fill.py.
enum { P_M, P_N, P_XG, P_YG, P_NB, P_S, P_SNAP_OFF, P_ROWS_OFF, NCOL };

struct Band {
  const unsigned char* x;  // gene codes of the pair's first sequence
  const unsigned char* y;  // ... and of its second
  const int* top;          // boundary rows; null for band 0 (analytic top)
  long long top_base;      // column j of the band's top row at top[top_base + j]
  int n, i0, rows, pgap;
};

__device__ __forceinline__ int ycode(const Band& B, int idx) {
  return (idx >= 0 && idx < B.n) ? (int)B.y[idx] : Y_SENTINEL;
}

__device__ __forceinline__ int xcode(const Band& B, int q) {
  return (q >= 1 && q <= B.rows) ? (int)B.x[B.i0 + q - 1] : X_SENTINEL;
}

// dp[i0][dl]: the top lane's value on diagonal dl (>= 1). Columns past n are
// never read by a valid cell; every version gives them NEG_FILL.
__device__ __forceinline__ int top_value(const Band& B, int dl) {
  if (dl > B.n) return NEG_FILL;
  return B.top ? B.top[B.top_base + dl] : dl * B.pgap;
}

// The state of N consecutive lanes in the walk's recompute (walk.cu picks
// N); the fills keep theirs in band_step's arrays below.
template <int N>
struct LanesN {
  int x[N], yd[N], p1[N], p1s[N], p2s[N];
};

// Advance this thread's lanes by one diagonal. ``ny`` is the y code entering
// lane q0 (from the previous thread, or the feed for thread 0); ``topv`` is
// used only by lane q == 0; lane ``inj_q`` (the ramp's left border, or -1)
// takes ``inj_v``. ``on_cell(c, q, cur, match, t1, t2, up, left)`` sees each
// new cell before the state moves on. After the call, p1s[0] still needs the
// previous thread's last p1 (set by the caller after the barrier). With
// EDGES false the caller knows that none of the thread's lanes is lane 0 or
// lane inj_q, and the step skips both tests.
template <bool EDGES = true, int N, class OnCell>
__device__ __forceinline__ void step_cells(LanesN<N>& L, int q0, int ny, int topv,
                                           int inj_q, int inj_v, int pxy,
                                           int pgap, OnCell on_cell) {
#pragma unroll
  for (int c = N - 1; c > 0; --c) L.yd[c] = L.yd[c - 1];
  L.yd[0] = ny;
#pragma unroll
  for (int c = N - 1; c >= 0; --c) {
    const int q = q0 + c;
    const bool match = L.x[c] == L.yd[c];
    const int t1 = L.p2s[c] + (match ? 0 : pxy);
    const int t2 = min(L.p1[c], L.p1s[c]) + pgap;
    int cur = min(t1, t2);
    if (EDGES && q == 0) cur = topv;
    if (EDGES && q == inj_q) cur = inj_v;
    on_cell(c, q, cur, match, t1, t2, L.p1s[c], L.p1[c]);
    L.p2s[c] = L.p1s[c];
    L.p1[c] = cur;
    if (c + 1 < N) L.p1s[c + 1] = cur;
  }
}

// The fills' step (band_fill.cu, conveyor_fill.cu). A thread keeps its
// CELLS lanes on the last two diagonals in two register arrays that trade
// roles from step to step (no per-cell copy moves the state along), and the
// previous thread's last lane on those diagonals in e1 (dl - 1) and e2
// (dl - 2), NEG_FILL for thread 0.

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// The same at system scope, for a count that crosses cards (band_fill.cu's
// relay): .gpu scope orders a thread's stores only for observers on its own
// card, so a producer writing into a peer card's memory releases, and its
// consumer acquires, at .sys.
__device__ __forceinline__ int ld_acquire_sys(const int* p) {
  int v;
  asm volatile("ld.acquire.sys.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(int* p, int v) {
  asm volatile("st.release.sys.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Picks v[c] for a c known only at run time, without indexing the array
// (which would move it to local memory).
__device__ __forceinline__ int pick(const int (&v)[CELLS], int c) {
  int r = v[0];
#pragma unroll
  for (int k = 1; k < CELLS; ++k) r = c == k ? v[k] : r;
  return r;
}

// Local diagonal dl of this thread's lanes from a (diagonal dl - 1) and b
// (dl - 2), written into b; x, y: the lanes' codes, ny the y code entering
// lane q0. Then, in this order: thread 0's lane 0 takes topv; with kRamp,
// lane inj_q (the ramp front, or -1) takes inj_v (the left border) and, with
// kSetX, the x code *inj_x (a lane that changes band); the thread given a
// ``harvest`` pointer stores its lane hc there. Then the hand-off of the
// last lane to the next thread through sh_p1: one barrier. The border and
// harvest are branches of the one thread that holds the lane, not per-cell
// tests.
template <bool kRamp, bool kSetX>
__device__ __forceinline__ void band_step(int (&x)[CELLS], int (&y)[CELLS],
                                          const int (&a)[CELLS], int (&b)[CELLS], int& e1,
                                          int& e2, int& buf, int (*sh_p1)[MAX_THREADS],
                                          int ny, int topv, int* harvest, int hc, int tid,
                                          int q0, int inj_q, int inj_v, const short* inj_x,
                                          int pxy, int pgap) {
#pragma unroll
  for (int c = CELLS - 1; c > 0; --c) y[c] = y[c - 1];
  y[0] = ny;
  // Descending, so b[c - 1] still holds diagonal dl - 2 when lane c reads it.
#pragma unroll
  for (int c = CELLS - 1; c >= 0; --c) {
    const int up = c ? a[c - 1] : e1;
    const int dg = c ? b[c - 1] : e2;
    const int t2 = min(up, a[c]) + pgap;
    b[c] = __viaddmin_s32(dg, x[c] == y[c] ? 0 : pxy, t2);
  }
  if (tid == 0) b[0] = topv;
  if (kRamp && (unsigned)(inj_q - q0) < CELLS) {
#pragma unroll
    for (int c = 0; c < CELLS; ++c)
      if (q0 + c == inj_q) {
        b[c] = inj_v;
        if (kSetX) x[c] = *inj_x;
      }
  }
  if (harvest) *harvest = pick(b, hc);
  buf ^= 1;
  sh_p1[buf][tid] = b[CELLS - 1];
  __syncthreads();
  e2 = e1;
  e1 = sh_p1[buf][tid ? tid - 1 : 0];
  if (tid == 0) e1 = NEG_FILL;
}

// After an odd number of band_step calls the newest diagonal is in d2:
// swap it back into d1.
__device__ __forceinline__ void swap_diagonals(int (&d1)[CELLS], int (&d2)[CELLS]) {
#pragma unroll
  for (int c = 0; c < CELLS; ++c) {
    const int t = d1[c];
    d1[c] = d2[c];
    d2[c] = t;
  }
}

// The state (p1, p1s, p2s) entering the next step, of this thread's lanes
// below ``lanes``: one snapshot, three planes of ``lanes`` values each.
__device__ __forceinline__ void write_snapshot(int* snap, const int (&d1)[CELLS],
                                               const int (&d2)[CELLS], int e1, int e2,
                                               int q0, int lanes) {
#pragma unroll
  for (int c = 0; c < CELLS; ++c) {
    const int q = q0 + c;
    if (q < lanes) {
      snap[q] = d1[c];
      snap[lanes + q] = c ? d1[c - 1] : e1;
      snap[2 * lanes + q] = c ? d2[c - 1] : e2;
    }
  }
}

// Threads for ``lanes`` lanes, rounded to whole warps; 0 if over one block.
static inline int threads_for(int lanes) {
  int t = ((lanes + CELLS - 1) / CELLS + 31) / 32 * 32;
  return t > MAX_THREADS ? 0 : t;
}
