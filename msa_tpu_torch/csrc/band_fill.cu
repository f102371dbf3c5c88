// Banded Needleman-Wunsch fill for many pairs in one launch.
//
// Replaces msa_tpu/ops/pallas_nw.py::_band_sweep_call (kernel :99,
// pallas_call :293). Per pair it computes the score dp[m][n], the bottom row
// of every band but the last (column j at index j - 1), and a snapshot of the
// wavefront state (p1, p1s, p2s) entering every step k * snap_k + 1 of each
// band, which seeds the traceback walk (walk.cu). With snaps null (the
// score-only mode: nw_score, calibration; emit_snaps=False in the Pallas
// kernel) no snapshot is written; rows stay, as they carry each band's bottom
// row to the next band. The mode is a template flag, not a test in the step
// loop: a runtime null check there made the full mode's fill 10 % slower on
// an H100 (big13 at rb 8191: 1,548 ms -> 1,699 ms).
//
// Layout (all int32, offsets per pair from the parameter table):
//   rows  [pair][band < nb - 1][n]
//   snaps [pair][band][s < S][3][rb + 1]
//
// What bounds it on an H100: each step updates rb + 1 cells and then waits at
// one __syncthreads, because every lane needs its upper neighbour's value
// from the step before. A step is a few hundred cycles of dependent integer
// work and a barrier, so the kernel is latency-bound per step, not bound by
// memory. The design answers with width: one block per pair (78 pairs of
// big13 run side by side on 132 SMs), the band as wide as a block can hold
// in registers (1024 threads x 8 cells), a single barrier per step (the
// boundary values are double-buffered in shared memory), and no global
// traffic in the step except the one harvested bottom-row cell and a
// snapshot every snap_k steps. The TPU's sequential band grid becomes a loop
// inside the block; band b reads band b - 1's bottom row from global memory.

#include "common.cuh"

template <bool kSnaps>
__global__ void __launch_bounds__(MAX_THREADS)
band_fill_kernel(const unsigned char* __restrict__ genes, long long stride,
                 const long long* __restrict__ params, int rb, int snap_k,
                 int pxy, int pgap, int* __restrict__ score,
                 int* __restrict__ rows, int* __restrict__ snaps) {
  __shared__ int sh_p1[2][MAX_THREADS];
  __shared__ int sh_yd[2][MAX_THREADS];
  const long long* pp = params + (long long)blockIdx.x * NCOL;
  const int m = (int)pp[P_M];
  const int n = (int)pp[P_N];
  const int nb = (int)pp[P_NB];
  const int S = (int)pp[P_S];
  const int lanes = rb + 1;
  const int tid = threadIdx.x;
  const int q0 = tid * CELLS;
  int* rows_p = rows + pp[P_ROWS_OFF];

  Band B;
  B.x = genes + pp[P_XG] * stride;
  B.y = genes + pp[P_YG] * stride;
  B.n = n;
  B.pgap = pgap;

  for (int b = 0; b < nb; ++b) {
    B.i0 = b * rb;
    B.rows = min(rb, m - B.i0);
    B.top = b ? rows_p : nullptr;
    B.top_base = (long long)(b - 1) * n - 1;
    const int steps = B.rows + n;
    int* snap_b = snaps + pp[P_SNAP_OFF] + (long long)b * S * 3 * lanes;
    int* harvest = (b < nb - 1) ? rows_p + (long long)b * n : nullptr;

    // State entering step 1: lane 0 holds dp[i0][0] = i0 * pgap.
    Lanes L;
#pragma unroll
    for (int c = 0; c < CELLS; ++c) {
      const int q = q0 + c;
      L.x[c] = xcode(B, q);
      L.yd[c] = Y_SENTINEL;
      L.p1[c] = q == 0 ? B.i0 * pgap : NEG_FILL;
      L.p1s[c] = q == 1 ? B.i0 * pgap : NEG_FILL;
      L.p2s[c] = NEG_FILL;
    }
    if (kSnaps) write_snapshot(snap_b, L, q0, lanes);
    sh_yd[0][tid] = L.yd[CELLS - 1];
    __syncthreads();

    int buf = 0;
    for (int dl = 1; dl <= steps; ++dl) {
      const int ny = tid ? sh_yd[buf][tid - 1] : ycode(B, dl - 1);
      const int topv = tid ? 0 : top_value(B, dl);
      step_cells(L, q0, ny, topv, dl, (B.i0 + dl) * pgap, pxy, pgap,
                 [&](int, int q, int cur, bool, int, int, int, int) {
                   if (q == rb && harvest && dl > rb) harvest[dl - rb - 1] = cur;
                   if (q == B.rows && dl == steps && b == nb - 1)
                     score[blockIdx.x] = cur;
                 });
      sh_p1[buf ^ 1][tid] = L.p1[CELLS - 1];
      sh_yd[buf ^ 1][tid] = L.yd[CELLS - 1];
      __syncthreads();
      buf ^= 1;
      L.p1s[0] = tid ? sh_p1[buf][tid - 1] : NEG_FILL;
      if (kSnaps && dl % snap_k == 0 && dl < steps)
        write_snapshot(snap_b + (long long)(dl / snap_k) * 3 * lanes, L, q0,
                       lanes);
    }
    // The next band reads this band's harvested row from global memory.
    __syncthreads();
  }
}

// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue when
// rb + 1 lanes do not fit one block). snaps may be null: no snapshots.
extern "C" int band_fill(const void* genes, long long stride,
                         const void* params, int num_pairs, int rb, int snap_k,
                         int pxy, int pgap, void* score, void* rows,
                         void* snaps, void* stream) {
  const int threads = threads_for(rb + 1);
  if (threads == 0 || num_pairs <= 0 || snap_k <= 0) return cudaErrorInvalidValue;
  auto kernel = snaps ? band_fill_kernel<true> : band_fill_kernel<false>;
  kernel<<<num_pairs, threads, 0, (cudaStream_t)stream>>>(
      (const unsigned char*)genes, stride, (const long long*)params, rb,
      snap_k, pxy, pgap, (int*)score, (int*)rows, (int*)snaps);
  return (int)cudaGetLastError();
}
