// Banded Needleman-Wunsch fill for many pairs in one launch, with the bands
// of a pair pipelined across SMs.
//
// Replaces msa_tpu/ops/pallas_nw.py::_band_sweep_call (kernel :99,
// pallas_call :293). Per pair it computes the score dp[m][n], the bottom row
// of every band but the last (column j at index j - 1), and a snapshot of the
// wavefront state (p1, p1s, p2s) entering every step k * snap_k + 1 of each
// band, which seeds the traceback walk (walk.cu). With snaps null (the
// score-only mode: nw_score, calibration; emit_snaps=False in the Pallas
// kernel) no snapshot is written; rows stay, as they carry each band's bottom
// row to the next band. The mode is a template flag, not a test in the step
// loop (a runtime test there cost the full fill 10 % on an H100).
//
// Layout (all int32, offsets per pair from the parameter table):
//   rows  [pair][band < nb - 1][n]
//   snaps [pair][band][s < S][3][rb + 1]
//
// What bounds it on an H100: the recurrence is a handful of int32
// operations a cell (compare, select, min, add-min), so the fill is bound by
// the SMs' integer issue rate, not by memory. Two things kept it far from
// that bound when one block carried a pair's bands in order: the fill lasted
// as long as the longest pair's chain of bands, on one SM, while most SMs
// idled; and each cell paid for border, harvest and score tests in the step.
//
// The design:
// - Work items. Every (pair, band) is one item; the host orders them by
//   ticket (ops/band_fill.py::plan_pairs), each band after its producer
//   (band b - 1 of the same pair). A persistent grid of SM count x resident
//   blocks per SM takes tickets with one atomicAdd each, runs the band and
//   takes another.
// - Band b + 1 follows band b through global memory. The thread that
//   harvests band b's bottom row into ``rows`` publishes how many columns it
//   has written, with a release store at device scope, at the end of every
//   chunk of steps. Band b + 1's thread 0 waits for the columns of its next
//   chunk with an acquire load and __nanosleep backoff, once per chunk,
//   outside the step loop; the block then reads them (through L2, __ldcg).
//   A band trails its producer by about rb + one chunk of steps, so a pair's
//   bands run side by side on several SMs.
// - The relay (ops/nw_striped.py). A lone pair striped over several cards
//   is one launch a stripe, each over the pair's full buffer layout: band
//   ``relay.out``, the stripe's last, harvests its bottom row into the next
//   stripe's ``rows`` and publishes its count into that stripe's
//   ``progress`` (a peer card's memory through UVA, or another launch's on
//   this card), with a release at system scope: .gpu scope does not order
//   the stores for a reader on another card. Band ``relay.in``, the next
//   stripe's first, waits on its own ``progress`` with an acquire at system
//   scope. The relay is a template flag, as the snapshot mode is: the main
//   path's launches run the instance without it, whose instructions are the
//   kernel's before the relay (fill_ablation.py's relay_always runs the
//   relay instance on the main path: its two tests, once an item and once a
//   chunk, cost big13's fill 1.6 % on an H100).
// - Stripes that share a card spin on each other's counts, so they must all
//   be resident at once: ops/nw_striped.py checks their grids against
//   band_fill_resident before it launches any.
// - Deadlock freedom, whatever the grid: a block claims a ticket only while
//   it is running and works on it until done, and an item's producer has a
//   smaller ticket, so it was claimed before, by a block that is running or
//   done. By induction on the ticket every claimed item finishes: band 0
//   waits for nothing, and a running band waits only for a running or
//   finished producer. Two launches at once (two host threads on one card)
//   have their own ticket counters and progress tables.
// - A cheap step. Steps run in chunks of ``chunk`` diagonals (a divisor of
//   snap_k): the wait, the top row's values, the y codes of the chunk
//   (staged in shared memory with sentinels, so no bounds test in the step)
//   and the snapshot sit at the chunk boundary, with no % in the step. The
//   ramp-in steps (dl <= rb, the left border enters lane dl) run in a loop of
//   their own; no step has a per-cell border, harvest or score test: the top
//   lane is one uniform branch of thread 0, the border one of the thread
//   that holds lane dl, the harvest one of the thread that holds lane rb,
//   the score is read after the last step. A cell is min(p2s + sub,
//   min(p1, p1s) + pgap) with the DPX add-min (__viaddmin_s32). Steps go in
//   pairs, with the two diagonals' register arrays trading roles, so no
//   per-cell copy moves the state along (common.cuh::band_step, which the
//   conveyor fill shares).
//
// Each thread owns CELLS consecutive lanes (common.cuh); lane q of the band
// is row i0 + q and holds cell (i0 + q, dl - q) on local diagonal dl. Only
// the last lane's value crosses threads, through a double-buffered shared
// array: one __syncthreads a step.

#include "common.cuh"

// Longest chunk of steps (ops/band_fill.py keeps the same value).
#define CHUNK_MAX 1024

// A stripe launch's links to its neighbours; -1 and null on the main path.
struct Relay {
  int out;        // band whose bottom row and count go to the next stripe
  int in;         // band whose top row the previous stripe's launch writes
  int* rows;      // the next stripe's rows (full pair layout)
  int* progress;  // the next stripe's progress (slots over the whole pair)
};

template <bool kSnaps, bool kRelay>
__global__ void __launch_bounds__(MAX_THREADS)
band_fill_kernel(const unsigned char* __restrict__ genes, long long stride,
                 const long long* __restrict__ params, const int* __restrict__ items,
                 int num_items, int rb, int snap_k, int chunk, int pxy, int pgap,
                 int* __restrict__ score, int* rows, int* __restrict__ snaps,
                 int* progress, int* tickets, Relay relay) {
  extern __shared__ int smem[];
  __shared__ int sh_p1[2][MAX_THREADS];
  __shared__ int sh_item;
  int* sh_top = smem;                                   // [chunk]
  short* sh_y = reinterpret_cast<short*>(smem + chunk);  // [chunk + q0max]
  const int tid = threadIdx.x;
  const int q0 = tid * CELLS;
  const int q0max = (blockDim.x - 1) * CELLS;
  const int lanes = rb + 1;
  const int per_snap = snap_k / chunk;
  const int hc = rb % CELLS;
  int buf = 0;

  for (;;) {
    if (tid == 0) sh_item = atomicAdd(tickets, 1);
    __syncthreads();
    const int it = sh_item;
    __syncthreads();
    if (it >= num_items) return;
    const int p = items[3 * it], b = items[3 * it + 1], slot = items[3 * it + 2];
    const long long* pp = params + (long long)p * NCOL;
    const int m = (int)pp[P_M], n = (int)pp[P_N], nb = (int)pp[P_NB];
    const unsigned char* xs = genes + pp[P_XG] * stride;
    const unsigned char* ys = genes + pp[P_YG] * stride;
    int* rows_p = rows + pp[P_ROWS_OFF];
    const int i0 = b * rb;
    const int nrows = min(rb, m - i0);
    const int nsteps = nrows + n;
    const int* top = b ? rows_p + (long long)(b - 1) * n : nullptr;
    const bool relayed_out = kRelay && b == relay.out, relayed_in = kRelay && b == relay.in;
    // The thread that holds lane rb writes the bottom row (column j at j - 1).
    int* harvest = (b < nb - 1 && tid == rb / CELLS)
                       ? (relayed_out ? relay.rows + pp[P_ROWS_OFF] : rows_p) + (long long)b * n - rb - 1
                       : nullptr;
    int* snap_b = kSnaps ? snaps + pp[P_SNAP_OFF] + (long long)b * pp[P_S] * 3 * lanes
                         : nullptr;

    // State entering step 1: lane 0 holds dp[i0][0] = i0 * pgap.
    int x[CELLS], y[CELLS], d1[CELLS], d2[CELLS];
#pragma unroll
    for (int c = 0; c < CELLS; ++c) {
      const int q = q0 + c;
      x[c] = (q >= 1 && q <= nrows) ? (int)xs[i0 + q - 1] : X_SENTINEL;
      y[c] = Y_SENTINEL;
      d1[c] = q == 0 ? i0 * pgap : NEG_FILL;
      d2[c] = NEG_FILL;
    }
    int e1 = NEG_FILL, e2 = NEG_FILL;

    for (int c0 = 0, ci = 0; c0 < nsteps; c0 += chunk, ++ci) {
      const int c1 = min(c0 + chunk, nsteps);  // this chunk: steps c0 + 1 .. c1
      if (top && tid == 0) {
        const int need = min(n, c1);
        unsigned ns = 32;
        while ((relayed_in ? ld_acquire_sys(progress + slot - 1)
                           : ld_acquire(progress + slot - 1)) < need) {
          __nanosleep(ns);
          ns = min(2 * ns, 1024u);
        }
      }
      __syncthreads();
      for (int k = tid; k < c1 - c0; k += blockDim.x) {
        const int dl = c0 + 1 + k;
        sh_top[k] = dl > n ? NEG_FILL : top ? __ldcg(top + dl - 1) : dl * pgap;
      }
      for (int k = tid; k < c1 - c0 + q0max; k += blockDim.x) {
        const int g = c0 - q0max + k;
        sh_y[k] = (g >= 0 && g < n) ? (short)ys[g] : (short)Y_SENTINEL;
      }
      __syncthreads();
      if (kSnaps && ci % per_snap == 0)
        write_snapshot(snap_b + (long long)(ci / per_snap) * 3 * lanes, d1, d2, e1, e2, q0,
                       lanes);
      // Lane q0 on diagonal dl reads y[dl - q0 - 1] = ysh[dl]; thread 0
      // takes dp[i0][dl] = topsh[dl].
      const short* ysh = sh_y + q0max - q0 - 1 - c0;
      const int* topsh = sh_top - c0 - 1;
      // Ramp-in (dl <= rb: the left border enters lane dl), in pairs of
      // steps with the two diagonals trading roles.
      int dl = c0 + 1;
      const int ramp_hi = min(c1, rb);
      for (; dl < ramp_hi; dl += 2) {
        band_step<true, false>(x, y, d1, d2, e1, e2, buf, sh_p1, ysh[dl], topsh[dl], nullptr,
                               hc, tid, q0, dl, (i0 + dl) * pgap, nullptr, pxy, pgap);
        band_step<true, false>(x, y, d2, d1, e1, e2, buf, sh_p1, ysh[dl + 1], topsh[dl + 1],
                               nullptr, hc, tid, q0, dl + 1, (i0 + dl + 1) * pgap, nullptr,
                               pxy, pgap);
      }
      if (dl == ramp_hi) {
        band_step<true, false>(x, y, d1, d2, e1, e2, buf, sh_p1, ysh[dl], topsh[dl], nullptr,
                               hc, tid, q0, dl, (i0 + dl) * pgap, nullptr, pxy, pgap);
        swap_diagonals(d1, d2);
        ++dl;
      }
      // The steady steps: no border lane, the harvest from lane rb.
      for (; dl < c1; dl += 2) {
        band_step<false, false>(x, y, d1, d2, e1, e2, buf, sh_p1, ysh[dl], topsh[dl],
                                harvest ? harvest + dl : nullptr, hc, tid, q0, -1, 0, nullptr,
                                pxy, pgap);
        band_step<false, false>(x, y, d2, d1, e1, e2, buf, sh_p1, ysh[dl + 1], topsh[dl + 1],
                                harvest ? harvest + dl + 1 : nullptr, hc, tid, q0, -1, 0,
                                nullptr, pxy, pgap);
      }
      if (dl == c1) {
        band_step<false, false>(x, y, d1, d2, e1, e2, buf, sh_p1, ysh[dl], topsh[dl],
                                harvest ? harvest + dl : nullptr, hc, tid, q0, -1, 0, nullptr,
                                pxy, pgap);
        swap_diagonals(d1, d2);
      }
      if (harvest && c1 > rb) {
        if (relayed_out)
          st_release_sys(relay.progress + slot, min(n, c1 - rb));
        else
          st_release(progress + slot, min(n, c1 - rb));
      }
    }
    if (b == nb - 1 && nrows >= q0 && nrows < q0 + CELLS) score[p] = pick(d1, nrows - q0);
  }
}

static size_t smem_bytes(int chunk, int threads) {
  return chunk * sizeof(int) + (chunk + (threads - 1) * CELLS) * sizeof(short);
}

// The kernel's instance for a snapshot mode and relay.
static auto instance(bool snaps, bool relay) {
  return snaps ? (relay ? band_fill_kernel<true, true> : band_fill_kernel<true, false>)
               : (relay ? band_fill_kernel<false, true> : band_fill_kernel<false, false>);
}

// Blocks of the fill one card holds at once (SMs x resident blocks per SM),
// snapshots on or off, relay or not, at this band height and chunk, into
// *blocks. Querying an instance also loads it.
extern "C" int band_fill_resident(int rb, int chunk, int snaps, int relay, int* blocks) {
  const int threads = threads_for(rb + 1);
  if (threads == 0 || chunk <= 0 || chunk > CHUNK_MAX) return cudaErrorInvalidValue;
  int dev, sms, per_sm;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, instance(snaps, relay), threads, smem_bytes(chunk, threads));
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = sms * per_sm;
  return cudaSuccess;
}

// Lets card ``dev`` store into card ``peer``'s memory (the relay across
// cards); 0 when it already could. The calling thread's card is kept.
extern "C" int band_fill_peer(int dev, int peer) {
  int cur;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(dev);
  if (err == cudaSuccess) err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) err = cudaSuccess;
  cudaGetLastError();  // leave no error behind for the next launch's check
  cudaSetDevice(cur);
  return (int)err;
}

// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue when
// rb + 1 lanes do not fit one block or the chunk does not divide snap_k).
// snaps may be null: no snapshots. progress (one int per band of the
// workload) and tickets (one int) must be zero. relay_out / relay_in: the
// bands of the relay (-1: none), relay_rows / relay_progress the next
// stripe's buffers. *blocks receives the grid.
extern "C" int band_fill(const void* genes, long long stride, const void* params,
                         const void* items, int num_items, int rb, int snap_k, int chunk,
                         int pxy, int pgap, void* score, void* rows, void* snaps,
                         void* progress, void* tickets, int relay_out, int relay_in,
                         void* relay_rows, void* relay_progress, int* blocks, void* stream) {
  const int threads = threads_for(rb + 1);
  if (threads == 0 || num_items <= 0 || chunk <= 0 || chunk > CHUNK_MAX ||
      (snaps && (snap_k <= 0 || snap_k % chunk != 0)) ||
      (relay_out >= 0 && (!relay_rows || !relay_progress)))
    return cudaErrorInvalidValue;
  const bool relay_on = relay_out >= 0 || relay_in >= 0;
  int resident;
  int err = band_fill_resident(rb, chunk, snaps != nullptr, relay_on, &resident);
  if (err != cudaSuccess) return err;
  *blocks = min(num_items, resident);
  const Relay relay{relay_out, relay_in, (int*)relay_rows, (int*)relay_progress};
  const auto kernel = instance(snaps != nullptr, relay_on);
  kernel<<<*blocks, threads, smem_bytes(chunk, threads), (cudaStream_t)stream>>>(
      (const unsigned char*)genes, stride, (const long long*)params, (const int*)items,
      num_items, rb, snap_k, chunk, pxy, pgap, (int*)score, (int*)rows, (int*)snaps,
      (int*)progress, (int*)tickets, relay);
  return (int)cudaGetLastError();
}
