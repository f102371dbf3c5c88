// Exact Needleman-Wunsch traceback for many pairs in one launch.
//
// Replaces msa_tpu/ops/pallas_walk.py::_walk_call (kernel :115,
// pallas_call :559). From (m, n) it walks back to the first border cell
// (i == 0 or j == 0), emitting move codes 0 match, 1 substitution, 2 up,
// 3 left with the tie-break match -> diagonal -> up -> left
// (pallas_walk.py:381-389 with swap = 0), packed 16 to an int32 word.
//
// Per segment: from the current cell (i, j) derive the band b, the segment
// s = (dl - 1) / snap_k and the window base w0 = align128_down(q - snap_k)
// (clamped into the band); load the fill's snapshot of (p1, p1s, p2s) for
// lanes w0 .. w0 + W - 1, W = min(snap_k + 128, rb + 1); recompute the
// segment's diagonals up to the current one with the same step as the fill
// (common.cuh), writing one direction byte per cell to a per-pair scratch in
// global memory; then one thread walks the bytes until it leaves the segment
// or the band, and broadcasts the new (i, j) through shared memory. Lanes
// below w0 are unknown, so lane 0 of the window is contaminated from its
// second step on and the error climbs one lane per step; the window base
// keeps every cell the walk reads at least that far above it
// (pallas_walk.py:44-53).
//
// What bounds it on an H100: the walk itself is a serial chain of dependent
// byte loads by one thread (about one L1/L2 round trip per move), and the
// recompute is a narrow step (W cells) behind a __syncthreads per diagonal,
// so a segment costs about snap_k barrier-bound steps plus snap_k to
// 2 * snap_k serial loads. The design runs every pair's walk in its own block
// (78 independent chains side by side), recomputes only the diagonals the
// walk can reach (up to the entry diagonal, not the whole segment), and keeps
// the direction bytes in a scratch small enough (snap_k x W bytes per pair)
// to stay in L2 while the walk reads them.

#include "common.cuh"

__global__ void __launch_bounds__(MAX_THREADS)
walk_kernel(const unsigned char* __restrict__ genes, long long stride,
            const long long* __restrict__ params, int rb, int snap_k, int win,
            int pxy, int pgap, const int* __restrict__ rows,
            const int* __restrict__ snaps, unsigned char* __restrict__ dirs,
            int* __restrict__ moves, int* __restrict__ counts) {
  __shared__ int sh_p1[2][MAX_THREADS];
  __shared__ int sh_yd[2][MAX_THREADS];
  __shared__ int sh_i, sh_j;
  const long long* pp = params + (long long)blockIdx.x * NCOL;
  const int m = (int)pp[P_M];
  const int n = (int)pp[P_N];
  const int S = (int)pp[P_S];
  const int lanes = rb + 1;
  const int tid = threadIdx.x;
  const int width = blockDim.x * CELLS;  // bytes per scratch row
  const int* rows_p = rows + pp[P_ROWS_OFF];
  int* moves_p = moves + pp[P_MOVES_OFF];
  unsigned char* dir_p = dirs + (long long)blockIdx.x * snap_k * width;

  Band B;
  B.x = genes + pp[P_XG] * stride;
  B.y = genes + pp[P_YG] * stride;
  B.n = n;
  B.pxy = pxy;
  B.pgap = pgap;

  unsigned int acc = 0;  // thread 0: moves not yet flushed to a word
  int cnt = 0;           // thread 0: moves emitted
  if (tid == 0) {
    sh_i = m;
    sh_j = n;
  }
  __syncthreads();

  for (;;) {
    const int i = sh_i;
    const int j = sh_j;
    if (i == 0 || j == 0) break;
    const int b = (i - 1) / rb;
    B.i0 = b * rb;
    B.rows = min(rb, m - B.i0);
    B.top = b ? rows_p + (long long)(b - 1) * n : nullptr;
    const int q = i - B.i0;
    const int dl = q + j;
    const int dl0 = (dl - 1) / snap_k * snap_k;
    int w0 = q - snap_k;
    w0 = w0 <= 0 ? 0 : w0 / 128 * 128;
    w0 = min(w0, lanes - win);
    const int steps = dl - dl0;  // the entry cell lies on the last of them
    const int* snap =
        snaps + pp[P_SNAP_OFF] + ((long long)b * S + dl0 / snap_k) * 3 * lanes;

    Lanes L;
    const int lane0 = tid * CELLS;
#pragma unroll
    for (int c = 0; c < CELLS; ++c) {
      const int qq = w0 + lane0 + c;
      const bool in = lane0 + c < win;
      L.x[c] = xcode(B, qq);
      L.yd[c] = ycode(B, dl0 - qq - 1);
      L.p1[c] = in ? snap[qq] : NEG_FILL;
      L.p1s[c] = in ? snap[lanes + qq] : NEG_FILL;
      L.p2s[c] = in ? snap[2 * lanes + qq] : NEG_FILL;
    }
    sh_yd[0][tid] = L.yd[CELLS - 1];
    __syncthreads();

    int buf = 0;
    for (int t = 1; t <= steps; ++t) {
      const int d = dl0 + t;
      const int ny = tid ? sh_yd[buf][tid - 1] : ycode(B, d - w0 - 1);
      const int topv = (tid == 0 && w0 == 0) ? top_value(B, d) : 0;
      unsigned long long packed = 0;
      step_cells(L, w0 + lane0, d, ny, topv, B,
                 [&](int c, int, int, bool match, int t1, int t2, int up,
                     int left) {
                   const int mv =
                       match ? 0 : (t1 <= t2 ? 1 : (up <= left ? 2 : 3));
                   packed |= (unsigned long long)mv << (8 * c);
                 });
      *reinterpret_cast<unsigned long long*>(dir_p + (long long)(t - 1) * width +
                                             lane0) = packed;
      sh_p1[buf ^ 1][tid] = L.p1[CELLS - 1];
      sh_yd[buf ^ 1][tid] = L.yd[CELLS - 1];
      __syncthreads();
      buf ^= 1;
      L.p1s[0] = tid ? sh_p1[buf][tid - 1] : NEG_FILL;
    }

    // The barrier above made every direction byte visible to thread 0.
    if (tid == 0) {
      int qq = q;
      int t = steps - 1;  // 0-based step of the current cell
      while (qq >= 1 && t >= 0 && t - qq + dl0 + 1 > 0) {
        const unsigned int mv = dir_p[(long long)t * width + (qq - w0)];
        acc |= mv << (2 * (cnt & 15));
        if ((cnt & 15) == 15) {
          moves_p[cnt >> 4] = (int)acc;
          acc = 0;
        }
        ++cnt;
        qq -= mv <= 2;
        t -= 1 + (mv <= 1);
      }
      sh_i = B.i0 + qq;
      sh_j = t - qq + dl0 + 1;
    }
    __syncthreads();
  }
  if (tid == 0) {
    if (cnt & 15) moves_p[cnt >> 4] = (int)acc;
    counts[blockIdx.x] = cnt;
  }
}

// Returns cudaGetLastError() after the launch. ``dirs`` is scratch of
// num_pairs * snap_k * threads * CELLS bytes, threads = threads_for(win).
extern "C" int walk(const void* genes, long long stride, const void* params,
                    int num_pairs, int rb, int snap_k, int pxy, int pgap,
                    const void* rows, const void* snaps, void* dirs,
                    void* moves, void* counts, void* stream) {
  const int win = min(snap_k + 128, rb + 1);
  const int threads = threads_for(win);
  if (threads == 0 || num_pairs <= 0 || snap_k <= 0) return cudaErrorInvalidValue;
  walk_kernel<<<num_pairs, threads, 0, (cudaStream_t)stream>>>(
      (const unsigned char*)genes, stride, (const long long*)params, rb,
      snap_k, win, pxy, pgap, (const int*)rows, (const int*)snaps,
      (unsigned char*)dirs, (int*)moves, (int*)counts);
  return (int)cudaGetLastError();
}
