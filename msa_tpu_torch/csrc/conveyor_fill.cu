// Conveyor fill: the bands of many pairs staggered through one sweep.
//
// Replaces msa_tpu/ops/conveyor.py::_conveyor_fill_segment (kernel :361,
// pallas_call :598). One launch advances every sweep through the global
// steps t of chunks [c0, c1), t in [c0 * K, c1 * K); one thread block runs
// one sweep of rb + 1 lanes, each thread owning 8 consecutive lanes in
// registers with the banded fill's step (common.cuh). Per step:
// - top lane (q = 0): the latest band with start <= t, band-local
//   dl = t - start, takes brow[brow_in][dl] (analytic dl * pgap for a
//   pair's first band; NEG_FILL past n); y[dl - 1] enters lane 0;
// - ramp: while dl <= rb, that band's lane q = dl takes its x code and the
//   left border (i0 + dl) * pgap;
// - harvest: lane rb of the band with start + rb <= t <= start + rb + n
//   goes to brow[brow_out][t - start - rb];
// - score: a pair's last band at dl = q_last + n, lane q_last -> score;
// - snapshot: after each step with t % K == 0, (p1, p1s, p2s) of all lanes.
// The sweep's (x, yd, p1, p1s, p2s) is loaded from ``carry`` at the start of
// a launch and stored there at its end.
//
// The TPU kernel read a per-chunk scalar schedule (build_chunk_tables,
// conveyor.py:201) from SMEM and merged each ramp's x codes one whole chunk
// early from a DMA'd tile; here three cursors (top band, harvesting band,
// next score event) advance as t passes band starts (bands by start, events
// by step), and a lane takes its x code when the ramp front reaches it. A
// brow column is read at least K steps after it was harvested (the planner's
// rb + 2K same-pair stagger), so the per-step __syncthreads orders the write
// and the read; sweeps share nothing, and segments are ordered by the stream.
//
// What bounds it on an H100: the same per-step cost as the banded fill (rb + 1
// cells of dependent integer work, then one barrier), plus a few uniform
// cursor compares. The wall is the longest sweep, and no sweep is shorter
// than its longest pair's bands laid end to end (on big13 at rb 7168, about
// 1.10 M steps); the design fills the band's lanes through every ramp, and
// the ``conveyors`` sweeps run side by side, one per SM.

#include <climits>

#include "common.cuh"

// Columns of the sweep, band and event tables (int64), ops/conveyor.py.
enum { S_BAND_LO, S_BAND_HI, S_EV_LO, S_EV_HI, S_CHUNKS, S_SNAP_OFF, S_BROW_OFF, SCOL };
enum { C_START, C_I0, C_ROWS, C_N, C_XG, C_YG, C_BROW_IN, C_BROW_OUT, CCOL };
enum { E_T, E_Q, E_PAIR, ECOL };

__global__ void __launch_bounds__(MAX_THREADS)
conveyor_fill_kernel(const unsigned char* __restrict__ genes, long long stride,
                     const long long* __restrict__ sweeps,
                     const long long* __restrict__ bands,
                     const long long* __restrict__ events, int rb, int K,
                     int ymax, int pxy, int pgap, int c0, int c1,
                     int* __restrict__ score, int* __restrict__ brow,
                     int* __restrict__ snaps, int* __restrict__ carry) {
  __shared__ int sh_p1[2][MAX_THREADS];
  __shared__ int sh_yd[2][MAX_THREADS];
  const long long* sw = sweeps + (long long)blockIdx.x * SCOL;
  const int t0 = c0 * K;
  const int t1 = (int)min((long long)c1, sw[S_CHUNKS]) * K;
  if (t0 >= t1) return;  // this sweep has ended (uniform over the block)
  const int lanes = rb + 1;
  const int tid = threadIdx.x;
  const int q0 = tid * CELLS;
  const int band_hi = (int)sw[S_BAND_HI];
  const int ev_hi = (int)sw[S_EV_HI];
  int* brow_w = brow + sw[S_BROW_OFF];
  int* snaps_w = snaps + sw[S_SNAP_OFF];
  int* carry_w = carry + (long long)blockIdx.x * 5 * lanes;

  Lanes L;
#pragma unroll
  for (int c = 0; c < CELLS; ++c) {
    const int q = q0 + c;
    const bool load = t0 > 0 && q < lanes;
    L.x[c] = load ? carry_w[q] : X_SENTINEL;
    L.yd[c] = load ? carry_w[lanes + q] : Y_SENTINEL;
    L.p1[c] = load ? carry_w[2 * lanes + q] : NEG_FILL;
    L.p1s[c] = load ? carry_w[3 * lanes + q] : NEG_FILL;
    L.p2s[c] = load ? carry_w[4 * lanes + q] : NEG_FILL;
  }

  // Cursors, the same in every thread. top: latest band with start <= t;
  // bot: latest band with start + rb <= t; ev: next score event at >= t.
  int top = (int)sw[S_BAND_LO] - 1, bot = top;
  int next_top = top + 1 < band_hi ? (int)bands[(top + 1) * CCOL + C_START] : INT_MAX;
  int next_bot = next_top == INT_MAX ? INT_MAX : next_top + rb;
  int top_start = 0, top_i0 = 0, top_rows = 0, top_n = 0, top_in = 0;
  const unsigned char* tx = genes;
  const unsigned char* ty = genes;
  int bot_start = 0, bot_n = -1, bot_out = 0;
  int ev = (int)sw[S_EV_LO];
  while (ev < ev_hi && events[ev * ECOL + E_T] < t0) ++ev;
  int ev_t = ev < ev_hi ? (int)events[ev * ECOL + E_T] : -1;

  sh_yd[0][tid] = L.yd[CELLS - 1];
  __syncthreads();
  int buf = 0;
  for (int t = t0; t < t1; ++t) {
    while (t >= next_top) {
      ++top;
      const long long* bp = bands + (long long)top * CCOL;
      top_start = (int)bp[C_START];
      top_i0 = (int)bp[C_I0];
      top_rows = (int)bp[C_ROWS];
      top_n = (int)bp[C_N];
      top_in = (int)bp[C_BROW_IN];
      tx = genes + bp[C_XG] * stride;
      ty = genes + bp[C_YG] * stride;
      next_top = top + 1 < band_hi ? (int)bp[CCOL + C_START] : INT_MAX;
    }
    while (t >= next_bot) {
      ++bot;
      const long long* bp = bands + (long long)bot * CCOL;
      bot_start = (int)bp[C_START];
      bot_n = (int)bp[C_N];
      bot_out = (int)bp[C_BROW_OUT];
      next_bot = bot + 1 < band_hi ? (int)bp[CCOL + C_START] + rb : INT_MAX;
    }
    const int dl = t - top_start;
    const bool ramp = dl <= rb;
    if (ramp) {
#pragma unroll
      for (int c = 0; c < CELLS; ++c)
        if (q0 + c == dl)
          L.x[c] = (dl >= 1 && dl <= top_rows) ? (int)tx[top_i0 + dl - 1] : X_SENTINEL;
    }
    int ny, topv = 0;
    if (tid == 0) {
      ny = (dl >= 1 && dl <= top_n) ? (int)ty[dl - 1] : Y_SENTINEL;
      topv = dl > top_n ? NEG_FILL
             : top_in ? brow_w[(long long)top_in * ymax + dl] : dl * pgap;
    } else {
      ny = sh_yd[buf][tid - 1];
    }
    const int h = t - bot_start - rb;  // harvested column of the bottom band
    const int hq = (h >= 0 && h <= bot_n) ? rb : -1;
    int* hdst = brow_w + (long long)bot_out * ymax + h;
    const int eq = t == ev_t ? (int)events[ev * ECOL + E_Q] : -1;
    step_cells(L, q0, ny, topv, ramp ? dl : -1, (top_i0 + dl) * pgap, pxy, pgap,
               [&](int, int q, int cur, bool, int, int, int, int) {
                 if (q == hq) *hdst = cur;
                 if (q == eq) score[events[ev * ECOL + E_PAIR]] = cur;
               });
    if (t == ev_t) {
      ++ev;
      ev_t = ev < ev_hi ? (int)events[ev * ECOL + E_T] : -1;
    }
    sh_p1[buf ^ 1][tid] = L.p1[CELLS - 1];
    sh_yd[buf ^ 1][tid] = L.yd[CELLS - 1];
    __syncthreads();
    buf ^= 1;
    L.p1s[0] = tid ? sh_p1[buf][tid - 1] : NEG_FILL;
    if (t % K == 0) write_snapshot(snaps_w + (long long)(t / K) * 3 * lanes, L, q0, lanes);
  }

#pragma unroll
  for (int c = 0; c < CELLS; ++c) {
    const int q = q0 + c;
    if (q < lanes) {
      carry_w[q] = L.x[c];
      carry_w[lanes + q] = L.yd[c];
      carry_w[2 * lanes + q] = L.p1[c];
      carry_w[3 * lanes + q] = L.p1s[c];
      carry_w[4 * lanes + q] = L.p2s[c];
    }
  }
}

// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue when
// rb + 1 lanes do not fit one block or rb is not a multiple of K).
extern "C" int conveyor_fill(const void* genes, long long stride,
                             const void* sweeps, const void* bands,
                             const void* events, int num_sweeps, int rb, int K,
                             int ymax, int pxy, int pgap, int c0, int c1,
                             void* score, void* brow, void* snaps, void* carry,
                             void* stream) {
  const int threads = threads_for(rb + 1);
  if (threads == 0 || num_sweeps <= 0 || K <= 0 || rb % K || c0 < 0 || c1 <= c0)
    return cudaErrorInvalidValue;
  conveyor_fill_kernel<<<num_sweeps, threads, 0, (cudaStream_t)stream>>>(
      (const unsigned char*)genes, stride, (const long long*)sweeps,
      (const long long*)bands, (const long long*)events, rb, K, ymax, pxy,
      pgap, c0, c1, (int*)score, (int*)brow, (int*)snaps, (int*)carry);
  return (int)cudaGetLastError();
}
