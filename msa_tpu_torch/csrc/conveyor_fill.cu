// Conveyor fill: the bands of many pairs staggered through concurrent
// sweeps, each pair's bands chained across sweeps.
//
// Replaces msa_tpu/ops/conveyor.py::_conveyor_fill_segment (kernel :361,
// pallas_call :598). A sweep is one thread block of rb + 1 lanes that
// advances one anti-diagonal per global step t; every band placed on it
// (ops/conveyor.py::plan_conveyor) enters at a K-aligned start and rides it
// with band-local diagonal dl = t - start: its ramp front climbs one lane a
// step just behind the previous band's draining cells, so no lane idles
// through a ramp. One launch advances every sweep through chunks [c0, c1),
// t in [c0 * K, c1 * K). Per step:
// - top lane (q = 0): the top band (latest start <= t) takes
//   brow[brow_in][dl] (analytic dl * pgap for a pair's first band; NEG_FILL
//   past n); lane q on diagonal t holds y code Y[t - q - 1] of the sweep's y
//   stream (band b's y at [start, start + n));
// - ramp: while dl <= rb, the top band's lane dl takes its x code and the
//   left border (i0 + dl) * pgap;
// - harvest: lane rb of the bottom band (latest start + rb <= t) goes to
//   brow[brow_out][t - start - rb] while that is <= n;
// - score: a pair's last band at dl = q_last + n, lane q_last -> score;
// - snapshot: after the step t = c * K, (p1, p1s, p2s) of all lanes.
// The sweep's state is loaded from ``carry`` at the start of a launch and
// stored there at its end.
//
// What bounds it on an H100: as the banded fill, the SMs' int32 issue rate
// (a handful of operations a cell, one barrier a step), and the longest
// sweep: the fill lasts as long as its busiest block.
//
// The design:
// - Bands, not pairs, are placed on sweeps: band b + 1 of a pair goes to
//   the sweep where it can start earliest, at least rb + 2K steps after band
//   b, wherever that lies. ``brow`` slots are global, so a consumer reads
//   its producer's harvested row from any sweep. A pair's chain of bands
//   then lasts about n + nb * (rb + 2K) steps, not nb * (max(n, rb) + K).
// - Every sweep publishes the global steps it has finished, with a release
//   store at the end of each chunk (``progress``, kept across launches like
//   ``carry``). Before a chunk whose top lane reads a producer's row, thread
//   0 waits with an acquire load and __nanosleep until the producer's sweep
//   has finished the steps that harvested the chunk's columns (at most the
//   chunk's first step - K, by the stagger); the block then reads them
//   through L2 (__ldcg). Every wait is for a strictly earlier global step,
//   so by induction on t every sweep finishes, provided all sweeps are
//   resident at once: the launch is cooperative, and fails when they do not
//   fit (the wrapper raises before it; ops/conveyor.py::resident_sweeps).
// - A staged step. Band starts are K-aligned and rb % K == 0, so the top
//   band, the bottom band and the ramp's extent change only at chunk
//   boundaries: the cursors, the band-table reads, the wait, the chunk's
//   top-row values, x codes of its ramp lanes and y codes (with sentinels)
//   sit there, staged in shared memory. The chunk's first step runs alone
//   (it may be a ramp step; the snapshot follows it), then its other K - 1
//   steps in one loop, ramp or steady as the chunk is, split at the chunk's
//   one score event, so no step tests for it. The step is the banded fill's
//   (common.cuh::band_step): DPX add-min, paired steps, the top lane, the
//   border and the harvest as branches of the one thread that holds them.
//
// A brow column is harvested at least 2K steps before a consumer reads it,
// by the planner's stagger, and sweeps share nothing else; segments are
// ordered by the stream.

#include <type_traits>

#include "common.cuh"

// Columns of the sweep, band and event tables (int64), ops/conveyor.py.
enum { S_BAND_LO, S_BAND_HI, S_EV_LO, S_EV_HI, S_FIRST, S_CHUNKS, S_SNAP_OFF, SCOL };
enum { C_START, C_I0, C_ROWS, C_N, C_XG, C_YG, C_BROW_IN, C_BROW_OUT, C_PSWEEP, C_PSTART, CCOL };
enum { E_T, E_Q, E_PAIR, ECOL };

__global__ void __launch_bounds__(MAX_THREADS)
conveyor_fill_kernel(const unsigned char* __restrict__ genes, long long stride,
                     const long long* __restrict__ sweeps,
                     const long long* __restrict__ bands,
                     const long long* __restrict__ events, int rb, int K, int ymax,
                     int pxy, int pgap, int c0, int c1, int* __restrict__ score, int* brow,
                     int* __restrict__ snaps, int* __restrict__ carry, int* progress) {
  extern __shared__ int smem[];
  __shared__ int sh_p1[2][MAX_THREADS];
  const int tid = threadIdx.x;
  const int q0 = tid * CELLS;
  const int q0max = (blockDim.x - 1) * CELLS;
  const int ylen = K + q0max;
  int* sh_top = smem;                                   // [K]
  short* sh_y = reinterpret_cast<short*>(smem + K);      // [K + q0max]
  short* sh_x = sh_y + ylen;                             // [K]

  const long long* sw = sweeps + (long long)blockIdx.x * SCOL;
  const int first = (int)sw[S_FIRST];
  const int ca = max(c0, first), cb = min((long long)c1, sw[S_CHUNKS]);
  if (ca >= cb) return;  // this sweep has not begun or has ended (uniform)
  const int lanes = rb + 1;
  const int band_lo = (int)sw[S_BAND_LO], band_hi = (int)sw[S_BAND_HI];
  const int ev_hi = (int)sw[S_EV_HI];
  const int hc = rb % CELLS;
  const bool hthread = tid == rb / CELLS;  // holds lane rb: harvests, publishes
  int* snaps_w = snaps + sw[S_SNAP_OFF];
  int* carry_w = carry + (long long)blockIdx.x * 5 * lanes;
  auto band = [&](int b, int col) { return bands[(long long)b * CCOL + col]; };

  // State entering step ca * K: empty at the sweep's first chunk, else the
  // carry (x, yd, p1, p1s, p2s); d2[c] is p2s one lane up.
  const bool load = ca > first;
  int x[CELLS], y[CELLS], d1[CELLS], d2[CELLS];
#pragma unroll
  for (int c = 0; c < CELLS; ++c) {
    const int q = q0 + c;
    const bool in = load && q < lanes;
    x[c] = in ? carry_w[q] : X_SENTINEL;
    y[c] = in ? carry_w[lanes + q] : Y_SENTINEL;
    d1[c] = in ? carry_w[2 * lanes + q] : NEG_FILL;
    d2[c] = load && q + 1 < lanes ? carry_w[4 * lanes + q + 1] : NEG_FILL;
  }
  const bool edge = load && tid > 0 && q0 < lanes;
  int e1 = edge ? carry_w[3 * lanes + q0] : NEG_FILL;
  int e2 = edge ? carry_w[4 * lanes + q0] : NEG_FILL;
  int buf = 0;

  // Cursors, the same in every thread: top (latest start <= T0), bot
  // (latest start + rb <= T0), ylo (first band whose y span ends after the
  // staged window's start), ev (next score event at >= T0).
  int top = band_lo - 1, bot = band_lo - 1, ylo = band_lo;
  int ev = (int)sw[S_EV_LO];

  for (int c = ca; c < cb; ++c) {
    const int T0 = c * K;
    while (top + 1 < band_hi && band(top + 1, C_START) <= T0) ++top;
    while (bot + 1 < band_hi && band(bot + 1, C_START) + rb <= T0) ++bot;
    while (ev < ev_hi && events[(long long)ev * ECOL + E_T] < T0) ++ev;
    const int tstart = (int)band(top, C_START), ti0 = (int)band(top, C_I0);
    const int trows = (int)band(top, C_ROWS), tn = (int)band(top, C_N);
    const int tin = (int)band(top, C_BROW_IN);
    const int dl_c = T0 - tstart;

    // The producer's row: wait until its sweep has harvested the columns
    // this chunk's top lane reads.
    if (tin && dl_c <= tn && tid == 0) {
      const int need = (int)band(top, C_PSTART) + rb + 1 + min(tn, dl_c + K - 1);
      const int* prog = progress + band(top, C_PSWEEP);
      unsigned ns = 32;
      for (long long spins = 0; ld_acquire(prog) < need; ++spins) {
        __nanosleep(ns);
        ns = min(2 * ns, 1024u);
        // Tens of seconds: the producer's sweep is not running. Fail the
        // launch rather than hang the card.
        if (spins > (1ll << 25)) __trap();
      }
    }
    __syncthreads();  // the wait, and the last chunk's reads of the stage
    const unsigned char* tx = genes + band(top, C_XG) * stride;
    for (int k = tid; k < K; k += blockDim.x) {
      const int dl = dl_c + k;
      sh_top[k] = dl > tn ? NEG_FILL
                  : tin   ? __ldcg(brow + (long long)tin * ymax + dl)
                          : dl * pgap;
      sh_x[k] = (dl >= 1 && dl <= trows) ? (short)tx[ti0 + dl - 1] : (short)X_SENTINEL;
    }
    // y stream positions gb .. gb + ylen - 1: lane q0 reads Y[t - q0 - 1].
    const int gb = T0 - q0max - 1;
    while (ylo < band_hi && band(ylo, C_START) + band(ylo, C_N) <= gb) ++ylo;
    int yhi = ylo;
    while (yhi < band_hi && band(yhi, C_START) < gb + ylen) ++yhi;
    for (int k = tid; k < ylen; k += blockDim.x) {
      const int g = gb + k;
      short v = Y_SENTINEL;
      for (int b = ylo; b < yhi; ++b) {
        const int s = (int)band(b, C_START);
        if (g >= s && g < s + (int)band(b, C_N)) v = genes[band(b, C_YG) * stride + g - s];
      }
      sh_y[k] = v;
    }
    __syncthreads();

    // The bottom band's harvest, by the thread that holds lane rb.
    long long hbase = 0;
    int hend = -1;
    if (hthread && bot >= band_lo) {
      const int bs = (int)band(bot, C_START);
      hbase = band(bot, C_BROW_OUT) * ymax - bs - rb;
      hend = bs + rb + (int)band(bot, C_N);
    }
    const int ramp_lane = dl_c <= rb ? dl_c : -1;

    // Steps ta .. tb - 1, in pairs; the newest diagonal ends in d1.
    auto steps = [&](auto ramp, int ta, int tb) {
      constexpr bool kRamp = decltype(ramp)::value;
      int t = ta;
      for (; t + 1 < tb; t += 2) {
        band_step<kRamp, true>(x, y, d1, d2, e1, e2, buf, sh_p1, sh_y[t - q0 - 1 - gb],
                               sh_top[t - T0], t <= hend ? brow + hbase + t : nullptr, hc,
                               tid, q0, t - tstart, (ti0 + t - tstart) * pgap, sh_x + t - T0,
                               pxy, pgap);
        band_step<kRamp, true>(x, y, d2, d1, e1, e2, buf, sh_p1, sh_y[t - q0 - gb],
                               sh_top[t + 1 - T0], t + 1 <= hend ? brow + hbase + t + 1 : nullptr,
                               hc, tid, q0, t + 1 - tstart, (ti0 + t + 1 - tstart) * pgap,
                               sh_x + t + 1 - T0, pxy, pgap);
      }
      if (t < tb) {
        band_step<kRamp, true>(x, y, d1, d2, e1, e2, buf, sh_p1, sh_y[t - q0 - 1 - gb],
                               sh_top[t - T0], t <= hend ? brow + hbase + t : nullptr, hc,
                               tid, q0, t - tstart, (ti0 + t - tstart) * pgap, sh_x + t - T0,
                               pxy, pgap);
        swap_diagonals(d1, d2);
      }
    };
    // The rest of the chunk, ramp or steady as the whole of it is (the ramp
    // ends at dl = rb, a chunk's first step).
    auto rest = [&](int ta, int tb) {
      if (dl_c < rb) steps(std::true_type(), ta, tb);
      else steps(std::false_type(), ta, tb);
    };

    // The chunk's first step alone: the top band's ramp lane, if any, and
    // then the snapshot of the state after it.
    {
      const int t = T0;
      band_step<true, true>(x, y, d1, d2, e1, e2, buf, sh_p1, sh_y[t - q0 - 1 - gb], sh_top[0],
                            t <= hend ? brow + hbase + t : nullptr, hc, tid, q0, ramp_lane,
                            (ti0 + dl_c) * pgap, sh_x, pxy, pgap);
      swap_diagonals(d1, d2);
    }
    write_snapshot(snaps_w + (long long)(c - first) * 3 * lanes, d1, d2, e1, e2, q0, lanes);
    const long long* e = events + (long long)ev * ECOL;
    if (ev < ev_hi && e[E_T] < T0 + K) {
      const int et = (int)e[E_T], eq = (int)e[E_Q];
      rest(T0 + 1, et + 1);
      if ((unsigned)(eq - q0) < CELLS) score[e[E_PAIR]] = pick(d1, eq - q0);
      rest(et + 1, T0 + K);
      ++ev;
    } else {
      rest(T0 + 1, T0 + K);
    }
    if (hthread) st_release(progress + blockIdx.x, T0 + K);
  }

#pragma unroll
  for (int c = 0; c < CELLS; ++c) {
    const int q = q0 + c;
    if (q < lanes) {
      carry_w[q] = x[c];
      carry_w[lanes + q] = y[c];
      carry_w[2 * lanes + q] = d1[c];
      carry_w[3 * lanes + q] = c ? d1[c - 1] : e1;
      carry_w[4 * lanes + q] = c ? d2[c - 1] : e2;
    }
  }
}

static size_t stage_bytes(int K, int threads) {
  return K * sizeof(int) + (2 * K + (threads - 1) * CELLS) * sizeof(short);
}

// Sweeps that fit on the card at once (SMs x resident blocks per SM) for
// this band height and chunk, into *blocks.
extern "C" int conveyor_fill_resident(int rb, int K, int* blocks) {
  const int threads = threads_for(rb + 1);
  if (threads == 0 || K <= 0) return cudaErrorInvalidValue;
  const size_t smem = stage_bytes(K, threads);
  cudaError_t err = cudaFuncSetAttribute(
      conveyor_fill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev, sms, per_sm;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conveyor_fill_kernel, threads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  *blocks = sms * per_sm;
  return cudaSuccess;
}

// Returns the launch's error (cudaErrorInvalidValue when rb + 1 lanes do
// not fit one block or rb is not a multiple of K;
// cudaErrorCooperativeLaunchTooLarge when the sweeps are not all resident).
// progress (one int per sweep) is zero before the first segment.
extern "C" int conveyor_fill(const void* genes, long long stride, const void* sweeps,
                             const void* bands, const void* events, int num_sweeps, int rb,
                             int K, int ymax, int pxy, int pgap, int c0, int c1, void* score,
                             void* brow, void* snaps, void* carry, void* progress,
                             void* stream) {
  const int threads = threads_for(rb + 1);
  if (threads == 0 || num_sweeps <= 0 || K <= 0 || rb % K || c0 < 0 || c1 <= c0)
    return cudaErrorInvalidValue;
  int resident;
  int err = conveyor_fill_resident(rb, K, &resident);
  if (err != cudaSuccess) return err;
  if (num_sweeps > resident) return cudaErrorCooperativeLaunchTooLarge;
  const unsigned char* g = (const unsigned char*)genes;
  const long long *s = (const long long*)sweeps, *b = (const long long*)bands,
                  *e = (const long long*)events;
  int *sc = (int*)score, *br = (int*)brow, *sn = (int*)snaps, *ca = (int*)carry,
      *pr = (int*)progress;
  void* args[] = {&g, &stride, &s, &b, &e, &rb, &K, &ymax, &pxy, &pgap, &c0, &c1,
                  &sc, &br, &sn, &ca, &pr};
  return (int)cudaLaunchCooperativeKernel((const void*)conveyor_fill_kernel, num_sweeps, threads,
                                          args, stage_bytes(K, threads), (cudaStream_t)stream);
}
