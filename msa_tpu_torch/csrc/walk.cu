// Exact Needleman-Wunsch traceback for many pairs in one launch.
//
// Replaces msa_tpu/ops/pallas_walk.py::_walk_call (kernel :115,
// pallas_call :559). From (m, n) it walks back to the first border cell
// (i == 0 or j == 0), emitting move codes 0 match, 1 substitution, 2 up,
// 3 left with the tie-break match -> diagonal -> up -> left, packed 16 to an
// int32 word. A pair the conveyor planner transposed has swap = 1 and prefers
// left over up on a tie, so that its moves, swapped back, are the original
// orientation's (pallas_walk.py:125-139, :379-389).
//
// Both fill layouts reach the walk through one band table: band b of a pair
// is row band0 + b, whose snapshot segment s is at snaps[snap_base + s * 3 *
// (rb + 1)] and whose top row has column j at rows[row_base + j] (band 0's
// top is analytic). The banded fill's per-pair layout and the conveyor's
// global-chunk layout (a band's segment s is the sweep's chunk start / K + s)
// differ only in these two numbers (ops/walk.py).
//
// Per segment: the current cell (i, j) is lane q of band b on local
// diagonal dl; the segment starts after diagonal dl0 = (dl - 1) / snap_k *
// snap_k and the entry cell lies on its last step, steps = dl - dl0. The
// window of W = min(snap_k, rb + 1) lanes starts at w0 = max(0, q - steps +
// 1), lowered if need be so that it stays in the band. Load the fill's
// snapshot of (p1, p1s, p2s) for the window, recompute the steps with the
// fill's step (common.cuh), then one thread follows the directions until it
// leaves the segment or the band, and broadcasts the new (i, j).
// Exactness: lanes below w0 are unknown, so the window's lane 0 is wrong from
// its second step on and the error climbs a lane a step: cell (t, w0 + l) is
// exact for l >= t (0-based step t). The walk enters on lane q at step
// steps - 1 and drops at most a lane a step, so at step t it reads a lane
// >= q - (steps - 1 - t) >= w0 + t, and the cells it depends on are exact
// too (pallas_walk.py:44-53: w0 <= q - (steps - 1)).
//
// What bounds it on an H100 is not the roofline but the serial chain of the
// longest pair: its segments, each up to snap_k barrier steps of recompute,
// then its moves, each a load that depends on the one before. On big13 that
// pair takes 181,264 steps at about 0.2 us and 91,621 moves at about 76 ns
// (walk_ablation.py on an H100 at 700 W). This design:
// - keeps only the directions the walk can reach, in shared memory, 2 bits
//   each: u steps back from the entry step the walk is on a lane of
//   [q - u, q], so the reachable cells form a triangle of steps (steps + 1)
//   / 2. Row u holds the granules (2 bits for each of a thread's N lanes)
//   of the threads that own those lanes, the entry lane's thread first, at
//   the closed-form offset cone_row(u): 132,608 bytes at snap_k 1,024 and
//   N = 4, dynamic shared memory, so a move is a shared-memory load;
// - lets the window follow the cone: snap_k lanes, not snap_k + 128;
// - gives each thread WALK_CELLS lanes (N, 4 unless built otherwise): at
//   snap_k 1,024 that is 256 threads, two warps on each of the SM's four
//   schedulers, so one warp's dependent steps hide behind the other's;
// - runs the border tests (top lane, left border) only in the threads that
//   hold such a lane on that step;
// - with WALK_RETIRE (a template flag, on unless built with
//   -DWALK_RETIRE=0), runs the recurrence only in threads that own a lane of
//   the cone on that step: the others only pass the y codes up. A lane
//   depends only on itself and the lane below, so lanes above q and lanes
//   below the cone's lower edge feed no cell the walk reads; that about
//   halves the recompute's cells.

#include "common.cuh"

#include <type_traits>

#ifndef WALK_RETIRE
#define WALK_RETIRE 1
#endif
// Lanes a thread owns (4 or 8; ops/walk.py, WALK_CELLS).
#ifndef WALK_CELLS
#define WALK_CELLS 4
#endif

// Threads of one walk block at most: the cone's shared memory caps snap_k
// near 1,330 (ops/walk.py::walk_shared_bytes), a window of 333 threads at
// 4 lanes each.
#define WALK_THREADS 512

// Columns of the walk's per-pair table and band table (int64), ops/walk.py.
enum { W_M, W_N, W_XG, W_YG, W_BAND0, W_MOVES_OFF, W_SWAP, WCOL };
enum { B_SNAP, B_ROW, BCOL };

// First granule of cone row u: rows 0 .. u - 1 hold u' / N + 2 granules
// each (ops/walk.py::cone_row).
template <int N>
__host__ __device__ __forceinline__ int cone_row(int u) {
  const int a = u / N;
  return 2 * u + N * a * (a - 1) / 2 + a * (u % N);
}

// A thread's directions on one step: 2 bits for each of its N lanes.
template <int N>
using Granule = typename std::conditional<N == 8, unsigned short, unsigned char>::type;

template <int N, bool RETIRE>
__global__ void __launch_bounds__(WALK_THREADS)
walk_kernel(const unsigned char* __restrict__ genes, long long stride,
            const long long* __restrict__ params,
            const long long* __restrict__ bands, int rb, int snap_k, int win,
            int pxy, int pgap, const int* __restrict__ rows,
            const int* __restrict__ snaps, int* __restrict__ moves,
            int* __restrict__ counts) {
  static_assert(N == 4 || N == 8, "a granule holds 4 or 8 lanes");
  extern __shared__ unsigned char cone_bytes[];
  Granule<N>* cone = reinterpret_cast<Granule<N>*>(cone_bytes);
  __shared__ int sh_p1[2][WALK_THREADS];
  __shared__ int sh_yd[2][WALK_THREADS];
  __shared__ int sh_i, sh_j;
  const long long* pp = params + (long long)blockIdx.x * WCOL;
  const int m = (int)pp[W_M];
  const int n = (int)pp[W_N];
  const int swap = (int)pp[W_SWAP];
  const long long* band_p = bands + pp[W_BAND0] * BCOL;
  const int lanes = rb + 1;
  const int tid = threadIdx.x;
  const int lane0 = tid * N;  // this thread's first lane in the window
  int* moves_p = moves + pp[W_MOVES_OFF];

  Band B;
  B.x = genes + pp[W_XG] * stride;
  B.y = genes + pp[W_YG] * stride;
  B.n = n;
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
    B.top = b ? rows : nullptr;
    B.top_base = band_p[b * BCOL + B_ROW];
    const int q = i - B.i0;
    const int dl = q + j;
    const int dl0 = (dl - 1) / snap_k * snap_k;
    const int steps = dl - dl0;  // the entry cell lies on the last of them
    const int w0 = min(max(q - steps + 1, 0), lanes - win);
    const int a = q - w0;      // the entry lane in the window
    const int ka = a / N;      // ... and its thread
    const int* snap =
        snaps + band_p[b * BCOL + B_SNAP] + (long long)(dl0 / snap_k) * 3 * lanes;

    LanesN<N> L;
#pragma unroll
    for (int c = 0; c < N; ++c) {
      const int qq = w0 + lane0 + c;
      const bool in = lane0 + c < win;
      L.x[c] = xcode(B, qq);
      L.yd[c] = ycode(B, dl0 - qq - 1);
      L.p1[c] = in ? snap[qq] : NEG_FILL;
      L.p1s[c] = in ? snap[lanes + qq] : NEG_FILL;
      L.p2s[c] = in ? snap[2 * lanes + qq] : NEG_FILL;
    }
    sh_yd[0][tid] = L.yd[N - 1];
    __syncthreads();

    int buf = 0;
    for (int t = 1; t <= steps; ++t) {
      const int d = dl0 + t;
      const int u = steps - t;  // steps back from the entry step
      const int ny = tid ? sh_yd[buf][tid - 1] : ycode(B, d - w0 - 1);
      // This thread owns a lane of the cone [a - u, a] on this step.
      const bool live = lane0 <= a && lane0 + N > a - u;
      if (!RETIRE || live) {
        unsigned int packed = 0;
        const auto dir = [&](int c, int, int, bool match, int t1, int t2,
                             int up, int left) {
          const int mv = match ? 0 : (t1 <= t2 ? 1 : (up + swap <= left ? 2 : 3));
          packed |= (unsigned int)mv << (2 * c);
        };
        // The top lane, or the left border's lane d, in this thread.
        if ((tid == 0 && w0 == 0) || (unsigned int)(d - w0 - lane0) < N) {
          const int topv = (tid == 0 && w0 == 0) ? top_value(B, d) : 0;
          step_cells<true>(L, w0 + lane0, ny, topv, d, (B.i0 + d) * pgap, pxy,
                           pgap, dir);
        } else {
          step_cells<false>(L, w0 + lane0, ny, 0, d, 0, pxy, pgap, dir);
        }
        if (live) cone[cone_row<N>(u) + ka - tid] = (Granule<N>)packed;
      } else {
#pragma unroll
        for (int c = N - 1; c > 0; --c) L.yd[c] = L.yd[c - 1];
        L.yd[0] = ny;
      }
      sh_p1[buf ^ 1][tid] = L.p1[N - 1];
      sh_yd[buf ^ 1][tid] = L.yd[N - 1];
      __syncthreads();
      buf ^= 1;
      L.p1s[0] = tid ? sh_p1[buf][tid - 1] : NEG_FILL;
    }

    // The barrier above made the whole cone visible to thread 0.
    if (tid == 0) {
      int qq = a;         // window lane of the current cell
      int t = steps - 1;  // its 0-based step; its column is dl0 + t + 1 - w0 - qq
      while (w0 + qq >= 1 && t >= 0 && dl0 + t + 1 - w0 - qq > 0) {
        const unsigned int g = cone[cone_row<N>(steps - 1 - t) + ka - qq / N];
        const unsigned int mv = (g >> (2 * (qq % N))) & 3;
        acc |= mv << (2 * (cnt & 15));
        if ((cnt & 15) == 15) {
          moves_p[cnt >> 4] = (int)acc;
          acc = 0;
        }
        ++cnt;
        qq -= mv <= 2;
        t -= 1 + (mv <= 1);
      }
      sh_i = B.i0 + w0 + qq;
      sh_j = dl0 + t + 1 - w0 - qq;
    }
    __syncthreads();
  }
  if (tid == 0) {
    if (cnt & 15) moves_p[cnt >> 4] = (int)acc;
    counts[blockIdx.x] = cnt;
  }
}

// Returns the first CUDA error of setting the kernel's shared memory or of
// the launch (cudaGetLastError()). The block takes the granules of a full
// segment's cone, cone_row(snap_k), as dynamic shared memory; the wrapper
// checks that they fit.
extern "C" int walk(const void* genes, long long stride, const void* params,
                    const void* bands, int num_pairs, int rb, int snap_k,
                    int pxy, int pgap, const void* rows, const void* snaps,
                    void* moves, void* counts, void* stream) {
  constexpr int N = WALK_CELLS;
  const int win = min(snap_k, rb + 1);
  const int threads = ((win + N - 1) / N + 31) / 32 * 32;
  if (threads > WALK_THREADS || num_pairs <= 0 || snap_k <= 0) return cudaErrorInvalidValue;
  const int smem = (int)sizeof(Granule<N>) * cone_row<N>(snap_k);
  auto kernel = walk_kernel<N, WALK_RETIRE != 0>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<num_pairs, threads, smem, (cudaStream_t)stream>>>(
      (const unsigned char*)genes, stride, (const long long*)params,
      (const long long*)bands, rb, snap_k, win, pxy, pgap, (const int*)rows,
      (const int*)snaps, (int*)moves, (int*)counts);
  return (int)cudaGetLastError();
}
