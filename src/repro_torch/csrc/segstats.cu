// Segment statistics for Hopper (sm_90a): per-group count, sum and sum of
// squares of an (n, k) float64 block under SORTED int64 group ids.
//
// Replaces the Pallas TPU kernel repro/kernels/segstats.py::_segstats_kernel
// (float32 one-hot matmuls) with the contract of its exact float64 host
// twin segment_stats_np: zero for a group with no rows, 1 <= k <= 8.
//
// Bound: memory (n*k*8 + n*8 bytes read once, G*(1+2k)*8 written once).
// Design: a segmented reduction in a fixed order, whose time is set by the
// bytes and not by the longest group (the first DLV round has one group
// over every row).
//
//  - segstats_tiles: one CTA of WARPS warps per tile of consecutive rows;
//    the tile is WARPS spans, one a warp, and a warp walks its span in
//    steps of 32 * R rows (R = rows_per_thread(k)) on its own, with no
//    barrier between warps until the tile's end.  A step's values and ids are
//    loaded coalesced (lane i reads word base+i) into the warp's shared
//    memory, each lane's R*k values at an odd word stride so that the walk
//    below reads without bank conflicts; the next step's loads are issued
//    before this step's arithmetic.  Each lane walks its R rows in order,
//    starting a new sum at every head (a row whose id differs from the one
//    before).  The lanes' trailing sums are scanned by shuffles with
//    doubling strides (warp_hs) after the carry of the span's earlier
//    steps.  A run whose head and end both lie in the span is complete:
//    its (count, sums, sums of squares) are staged in shared memory at its
//    last row and written out, in row order by the whole warp when many
//    closed in the step (so that every-row-a-group writes consecutive
//    groups with consecutive lanes), else by each lane.  Empty groups
//    between two ids are zeroed by the warp that sees the head after them.
//    The span's first run, if it began before the span and ends in it, is
//    the span's carry piece.  At the tile's end one warp scans the spans'
//    trailing sums: a carry piece after that scan is a whole run if its
//    head lies in the tile, else it becomes the tile's.  The tile leaves
//    one record: its trailing sum and its carry piece.
//  - segstats_merge: one CTA scans the records' trailing sums (block_scan,
//    MERGE_THREADS tiles a block, chained) and adds each carry piece to the
//    scan before it: the totals of the runs that cross a tile edge.  It
//    also zeroes the groups after the last id.
//
// Every sum has a fixed tree that depends only on n and the tile, and no
// floating-point atomics are used: the result is bit-identical from run to
// run (the DLV build's next split choice reads it), and bit-equal to
// kernels/segstats.py::segment_stats_tiled_plain, which is this order in
// torch.  Built with -fmad=false: x*x + acc must not become an FMA, or the
// mirror could not match.
#include <cuda_runtime.h>
#include <stdint.h>

#define WARPS 8          // a CTA of pass 1
// a warp writes a step's closed runs out together when more lanes than
// this closed one (scripts/segstats_write_paths.py times the choice)
#define DENSE_LANES 16
#define MERGE_WARPS 16
#define MERGE_THREADS (MERGE_WARPS * 32)
#define FULL 0xffffffffu

typedef long long i64;

// rows a lane walks per step: about 16 values, at most 8 rows
__host__ __device__ constexpr int rows_per_thread(int k) {
  return 16 / k < 1 ? 1 : (16 / k > 8 ? 8 : 16 / k);
}
// a lane's chunk of c words at an odd stride: 32 lanes reading the same
// offset of their chunks hit 32 different banks
__host__ __device__ constexpr int odd_stride(int c) { return c | 1; }

// b := a then b under a segmented sum (b where b holds a head, else a + b)
template <int D>
__device__ __forceinline__ void combine(int af, const double* av, int& bf,
                                        double* bv) {
  if (!bf) {
#pragma unroll
    for (int i = 0; i < D; ++i) bv[i] = av[i] + bv[i];
  }
  bf |= af;
}

// inclusive segmented scan over the first `width` lanes of a warp, by
// doubling strides, every lane from the values before the stride
template <int D>
__device__ __forceinline__ void warp_hs(int& f, double* v, int lane,
                                        int width) {
  for (int d = 1; d < width; d <<= 1) {
    const int yf = __shfl_up_sync(FULL, f, d);
    double y[D];
#pragma unroll
    for (int i = 0; i < D; ++i) y[i] = __shfl_up_sync(FULL, v[i], d);
    if (lane >= d) combine<D>(yf, y, f, v);
  }
}

// (ef, ev) := the inclusive (f, v) of the lane before, the identity on
// lane 0
template <int D>
__device__ __forceinline__ void lane_before(int f, const double* v,
                                            int& ef, double* ev, int lane) {
  ef = __shfl_up_sync(FULL, f, 1);
#pragma unroll
  for (int i = 0; i < D; ++i) ev[i] = __shfl_up_sync(FULL, v[i], 1);
  if (lane == 0) {
    ef = 0;
#pragma unroll
    for (int i = 0; i < D; ++i) ev[i] = 0.0;
  }
}

// Shared memory of a block scan: the warps' inclusive sums, and the carry
// twice (read from one slot, the next written to the other).
template <int D, int NW>
struct ScanSmem {
  double wv[NW * D];
  double cv[2][D];
  int wf[NW];
  int cf[2];
};

// Each thread's exclusive value (ef, ev) of the elements (f, v) of the
// block's threads in index order, after the carry in slot `par` of `sm`:
// carry, then (the warps before its own, then the lanes before it in its
// warp).  Every warp scans the warps' sums itself (one barrier).  The carry
// moved on by the block's total goes to slot par ^ 1, read after the
// caller's next barrier.
template <int D, int NW>
__device__ void block_scan(int f, const double* v, int& ef, double* ev,
                           ScanSmem<D, NW>& sm, int par) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int fi = f;
  double vi[D];
#pragma unroll
  for (int i = 0; i < D; ++i) vi[i] = v[i];
  warp_hs<D>(fi, vi, lane, 32);
  lane_before<D>(fi, vi, ef, ev, lane);
  if (lane == 31) {
    sm.wf[w] = fi;
#pragma unroll
    for (int i = 0; i < D; ++i) sm.wv[w * D + i] = vi[i];
  }
  __syncthreads();
  int tf = 0;
#pragma unroll
  for (int i = 0; i < D; ++i) vi[i] = 0.0;
  if (lane < NW) {
    tf = sm.wf[lane];
#pragma unroll
    for (int i = 0; i < D; ++i) vi[i] = sm.wv[lane * D + i];
  }
  warp_hs<D>(tf, vi, lane, NW);
  const int src = w ? w - 1 : 0;
  int xf = __shfl_sync(FULL, tf, src);
  double xv[D];
#pragma unroll
  for (int i = 0; i < D; ++i) xv[i] = __shfl_sync(FULL, vi[i], src);
  if (!w) {
    xf = 0;
#pragma unroll
    for (int i = 0; i < D; ++i) xv[i] = 0.0;
  }
  combine<D>(xf, xv, ef, ev);                 // warps before, lanes before
  int cf = sm.cf[par];
  double cv[D];
#pragma unroll
  for (int i = 0; i < D; ++i) cv[i] = sm.cv[par][i];
  combine<D>(cf, cv, ef, ev);                 // the carry before all
  if (threadIdx.x == NW - 1) {                // lane NW-1 of warp 0: the
    combine<D>(cf, cv, tf, vi);               // block's total
    sm.cf[par ^ 1] = tf;
#pragma unroll
    for (int i = 0; i < D; ++i) sm.cv[par ^ 1][i] = vi[i];
  }
}

// zero groups [lo, hi) clipped to [0, G), `step` threads side by side
template <int K>
__device__ __forceinline__ void zero_groups(i64 lo, i64 hi, i64 G,
                                            double* cnt, double* sum,
                                            double* sq, int me, int step) {
  lo = lo < 0 ? 0 : lo;
  hi = hi > G ? G : hi;
  for (i64 g = lo + me; g < hi; g += step) cnt[g] = 0.0;
  for (i64 e = lo * K + me; e < hi * K; e += step) {
    sum[e] = 0.0;
    sq[e] = 0.0;
  }
}

// One warp's shared memory: the step's values (then, at a closed run's
// last row, its sums of squares), the closed runs' sums, the ids, the ids
// before and after the step, and the closed runs' counts (0: none closed
// at the row).
template <int K>
struct Lanes {
  static constexpr int R = rows_per_thread(K);
  static constexpr int D = 1 + 2 * K;
  static constexpr int C = R * K;             // a lane's values a step
  static constexpr int CS = odd_stride(C);
  static constexpr int IS = odd_stride(R);
  static constexpr int STEP = 32 * R;         // a warp's rows a step
  static constexpr int REC = 2 * (1 + D);     // a tile's record, doubles
  static constexpr size_t BYTES =
      (size_t)32 * CS * 8 * 2 + (size_t)32 * IS * 8 + 16 + (size_t)STEP * 4;
  double* x;
  double* s;
  i64* id;
  i64* halo;
  int* n;
  __device__ explicit Lanes(unsigned char* base) {
    x = reinterpret_cast<double*>(base);
    s = x + 32 * CS;
    id = reinterpret_cast<i64*>(s + 32 * CS);
    halo = id + 32 * IS;
    n = reinterpret_cast<int*>(halo + 2);
  }
  __device__ i64 idat(int i) const { return id[(i / R) * IS + i % R]; }
};

// A tile's record, in doubles: [head flag, trailing sum (D)] then
// [carry-piece flag, carry piece (D)]; the sums are (count, sums, sums of
// squares).
template <int K>
__global__ void __launch_bounds__(32 * WARPS, 2)
segstats_tiles(const double* __restrict__ vals, const i64* __restrict__ ids,
               i64 n, i64 G, int steps, double* __restrict__ cnt,
               double* __restrict__ sum, double* __restrict__ sq,
               double* __restrict__ rec) {
  typedef Lanes<K> L_;
  constexpr int R = L_::R, D = L_::D, C = L_::C, CS = L_::CS, IS = L_::IS,
                STEP = L_::STEP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // each span's carry (read from one slot, the next written to the other)
  // and carry piece
  __shared__ double s_cv[WARPS][2][D], s_pv[WARPS][D];
  __shared__ int s_cf[WARPS][2], s_pf[WARPS];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const L_ sm(smem_raw + warp * L_::BYTES);
  const i64 w0 = ((i64)blockIdx.x * WARPS + warp) * steps * STEP;   // span
  if (lane < D) {
    s_cv[warp][0][lane] = 0.0;
    s_pv[warp][lane] = 0.0;
  }
  if (lane == 0) {
    s_cf[warp][0] = 0;
    s_pf[warp] = 0;
  }

  // the step at row r0, in registers: lane-interleaved words
  double xr[C];
  i64 ir[R], hr = 0;
  auto load = [&](i64 r0) {
    const i64 nw = (n - r0 < STEP ? n - r0 : STEP) * K;
    const double* src = vals + r0 * K;
#pragma unroll
    for (int m = 0; m < C; ++m) {
      const int e = lane + m * 32;
      xr[m] = e < nw ? __ldcs(src + e) : 0.0;
    }
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const i64 r = r0 + lane + m * 32;
      ir[m] = r < n ? __ldcs(ids + r) : 0;
    }
    if (lane == 0) hr = r0 > 0 ? ids[r0 - 1] : -1;
    if (lane == 1) hr = r0 + STEP < n ? ids[r0 + STEP] : 0;
  };
  if (w0 < n) load(w0);

  int par = 0;
  for (int s = 0; s < steps; ++s, par ^= 1) {
    const i64 r0 = w0 + (i64)s * STEP;
    if (r0 >= n) break;
    const int nrows = (int)(n - r0 < STEP ? n - r0 : STEP);
    __syncwarp();                             // the last step is done
#pragma unroll
    for (int m = 0; m < C; ++m) {
      const int e = lane + m * 32;
      sm.x[(e / C) * CS + e % C] = xr[m];
    }
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const int i = lane + m * 32;
      sm.id[(i / R) * IS + i % R] = ir[m];
    }
    if (lane < 2) sm.halo[lane] = hr;
    __syncwarp();
    if (s + 1 < steps && r0 + STEP < n) load(r0 + STEP);   // in flight

    // the walk over this lane's rows: a run closed at row i is staged at
    // row i (sums in s, sums of squares over the row's values in x, count
    // in n); a run begun before this lane with its count negated, to be
    // completed after the scan
    const int base = lane * R;
    i64 prev = lane ? sm.id[(lane - 1) * IS + R - 1] : sm.halo[0];
    int f = 0, fpj = -1, direct = 0;
    unsigned gaps = 0;
    double acc[D];
#pragma unroll
    for (int i = 0; i < D; ++i) acc[i] = 0.0;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int i = base + j;
      sm.n[i] = 0;
      if (i >= nrows) continue;
      const i64 g = sm.id[lane * IS + j];
      const bool hd = g != prev;
      if (hd) {
        if (g > prev + 1) gaps |= 1u << j;
#pragma unroll
        for (int c = 0; c < D; ++c) acc[c] = 0.0;
      }
      f |= hd;
      double* x = sm.x + lane * CS + j * K;
      acc[0] += 1.0;
#pragma unroll
      for (int c = 0; c < K; ++c) {
        const double xc = x[c];
        acc[1 + c] += xc;
        acc[1 + K + c] += xc * xc;
      }
      bool cl = r0 + i == n - 1;
      if (!cl) {
        const i64 nx = j + 1 < R ? sm.id[lane * IS + j + 1]
                       : (lane < 31 ? sm.id[(lane + 1) * IS] : sm.halo[1]);
        cl = nx != g;
      }
      if (cl) {
#pragma unroll
        for (int c = 0; c < K; ++c) {
          sm.s[lane * CS + j * K + c] = acc[1 + c];
          x[c] = acc[1 + K + c];
        }
        sm.n[i] = f ? (int)acc[0] : -(int)acc[0];
        direct |= f;
        if (!f) fpj = j;
      }
      prev = g;
    }

    // groups between two ids: zeroed by the warp, head by head
    unsigned pend = __ballot_sync(FULL, gaps != 0);
    while (pend) {
      const int src = __ffs(pend) - 1;
      pend &= pend - 1;
      unsigned m = __shfl_sync(FULL, gaps, src);
      while (m) {
        const int j = __ffs(m) - 1;
        m &= m - 1;
        const int i = src * R + j;
        const i64 lo = i ? sm.idat(i - 1) : sm.halo[0];
        zero_groups<K>(lo + 1, sm.idat(i), G, cnt, sum, sq, lane, 32);
      }
    }

    // the lanes' trailing sums scanned; lane 31 moves the span's carry on
    int ef;
    double ev[D];
    warp_hs<D>(f, acc, lane, 32);
    lane_before<D>(f, acc, ef, ev, lane);
    if (lane == 31 || fpj >= 0) {
      int cf = s_cf[warp][par];
      double cv[D];
#pragma unroll
      for (int i = 0; i < D; ++i) cv[i] = s_cv[warp][par][i];
      if (lane == 31) {
        int tf = f;
        combine<D>(cf, cv, tf, acc);
        s_cf[warp][par ^ 1] = tf;
#pragma unroll
        for (int i = 0; i < D; ++i) s_cv[warp][par ^ 1][i] = acc[i];
      }
      if (fpj >= 0) {                         // the carry, the lanes before
        combine<D>(cf, cv, ef, ev);           // and the piece here
        const int i = base + fpj;
        double* s = sm.s + lane * CS + fpj * K;
        double* x = sm.x + lane * CS + fpj * K;
        ev[0] = ev[0] + (double)(-sm.n[i]);
#pragma unroll
        for (int c = 0; c < K; ++c) {
          ev[1 + c] = ev[1 + c] + s[c];
          ev[1 + K + c] = ev[1 + K + c] + x[c];
        }
        if (ef) {                             // begun in this span
#pragma unroll
          for (int c = 0; c < K; ++c) {
            s[c] = ev[1 + c];
            x[c] = ev[1 + K + c];
          }
          sm.n[i] = (int)ev[0];
          direct = 1;
        } else {                              // begun before the span
          sm.n[i] = 0;
          s_pf[warp] = 1;
#pragma unroll
          for (int c = 0; c < D; ++c) s_pv[warp][c] = ev[c];
        }
      }
    }

    // the runs closed in this step: where many lanes closed one, out in
    // row order by the whole warp (consecutive groups, consecutive lanes);
    // where few did, each lane writes its own
    const unsigned closers = __ballot_sync(FULL, direct);
    __syncwarp();
    if (__popc(closers) > DENSE_LANES) {
      for (int i = lane; i < nrows; i += 32) {
        const int c = sm.n[i];
        const i64 g = sm.idat(i);
        if (c && g >= 0 && g < G) cnt[g] = (double)c;
      }
      for (int e = lane; e < nrows * K; e += 32) {
        const int i = e / K;
        const i64 g = sm.idat(i);
        if (sm.n[i] && g >= 0 && g < G) {
          const int p = (e / C) * CS + e % C;
          sum[g * K + e % K] = sm.s[p];
          sq[g * K + e % K] = sm.x[p];
        }
      }
    } else if (direct) {
      for (int j = 0; j < R; ++j) {
        const int c = sm.n[base + j];
        const i64 g = sm.id[lane * IS + j];
        if (!c || g < 0 || g >= G) continue;
        cnt[g] = (double)c;
#pragma unroll
        for (int q = 0; q < K; ++q) {
          sum[g * K + q] = sm.s[lane * CS + j * K + q];
          sq[g * K + q] = sm.x[lane * CS + j * K + q];
        }
      }
    }
  }
  __syncthreads();
  if (warp) return;

  // the tile: the spans' trailing sums scanned by warp 0
  int tf = 0, xf, qf = 0;
  double tv[D], xv[D], qv[D];
#pragma unroll
  for (int i = 0; i < D; ++i) tv[i] = qv[i] = 0.0;
  if (lane < WARPS) {
    // a span's last carry: in the slot its last step wrote, which is
    // slot 0 after an even number of steps
    const i64 r = ((i64)blockIdx.x * WARPS + lane) * steps * STEP;
    const i64 done = r >= n ? 0 : ((n - r + STEP - 1) / STEP < steps
                                       ? (n - r + STEP - 1) / STEP : steps);
    const int sp = (int)(done & 1);
    tf = s_cf[lane][sp];
    qf = s_pf[lane];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      tv[i] = s_cv[lane][sp][i];
      qv[i] = s_pv[lane][i];
    }
  }
  warp_hs<D>(tf, tv, lane, WARPS);
  lane_before<D>(tf, tv, xf, xv, lane);
  bool tile_p = false;
  if (qf) {
#pragma unroll
    for (int i = 0; i < D; ++i) qv[i] = xv[i] + qv[i];
    const i64 g = ids[((i64)blockIdx.x * WARPS + lane) * steps * STEP];
    if (!xf) {                                // begun before the tile
      tile_p = true;
    } else if (g >= 0 && g < G) {             // begun in this tile
      cnt[g] = qv[0];
#pragma unroll
      for (int c = 0; c < K; ++c) {
        sum[g * K + c] = qv[1 + c];
        sq[g * K + c] = qv[1 + K + c];
      }
    }
  }
  const unsigned tm = __ballot_sync(FULL, tile_p);
  double* out = rec + (i64)blockIdx.x * L_::REC;
  if (lane == WARPS - 1) {
    out[0] = (double)tf;
#pragma unroll
    for (int i = 0; i < D; ++i) out[1 + i] = tv[i];
  }
  if (tm ? lane == __ffs(tm) - 1 : lane == 0) {
    out[1 + D] = tm ? 1.0 : 0.0;
#pragma unroll
    for (int i = 0; i < D; ++i) out[2 + D + i] = tm ? qv[i] : 0.0;
  }
}

template <int K>
__global__ void __launch_bounds__(MERGE_THREADS, 1)
segstats_merge(const double* __restrict__ rec, i64 ntiles, i64 tile,
               const i64* __restrict__ ids, i64 n, i64 G,
               double* __restrict__ cnt, double* __restrict__ sum,
               double* __restrict__ sq) {
  constexpr int D = Lanes<K>::D, REC = Lanes<K>::REC;
  __shared__ ScanSmem<D, MERGE_WARPS> sm;
  const int tid = threadIdx.x;
  if (tid == 0) sm.cf[0] = 0;
  if (tid < D) sm.cv[0][tid] = 0.0;
  int par = 0;
  for (i64 b0 = 0; b0 < ntiles; b0 += MERGE_THREADS, par ^= 1) {
    const i64 b = b0 + tid;
    int f = 0, pf = 0;
    double v[D], pv[D];
#pragma unroll
    for (int i = 0; i < D; ++i) v[i] = pv[i] = 0.0;
    if (b < ntiles) {
      const double* r = rec + b * REC;
      f = r[0] != 0.0;
      pf = r[1 + D] != 0.0;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        v[i] = r[1 + i];
        pv[i] = r[2 + D + i];
      }
    }
    __syncthreads();                          // the carry is written
    int ef;
    double ev[D];
    block_scan<D, MERGE_WARPS>(f, v, ef, ev, sm, par);
    if (pf) {
      const i64 g = ids[b * tile];
      if (g >= 0 && g < G) {
        cnt[g] = ev[0] + pv[0];
#pragma unroll
        for (int c = 0; c < K; ++c) {
          sum[g * K + c] = ev[1 + c] + pv[1 + c];
          sq[g * K + c] = ev[1 + K + c] + pv[1 + K + c];
        }
      }
    }
  }
  zero_groups<K>(ids[n - 1] + 1, G, G, cnt, sum, sq, tid, MERGE_THREADS);
}

template <int K>
static int run(const void* vals, const void* ids, i64 n, i64 G, i64 tile,
               void* cnt, void* sum, void* sq, void* rec, cudaStream_t st) {
  typedef Lanes<K> L_;
  if (n <= 0 || tile <= 0 || tile % (WARPS * L_::STEP))
    return (int)cudaErrorInvalidValue;
  const i64 ntiles = (n + tile - 1) / tile;
  const size_t smem = WARPS * L_::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      segstats_tiles<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  segstats_tiles<K><<<(unsigned)ntiles, 32 * WARPS, smem, st>>>(
      (const double*)vals, (const i64*)ids, n, G,
      (int)(tile / (WARPS * L_::STEP)), (double*)cnt, (double*)sum,
      (double*)sq, (double*)rec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  segstats_merge<K><<<1, MERGE_THREADS, 0, st>>>(
      (const double*)rec, ntiles, tile, (const i64*)ids, n, G, (double*)cnt,
      (double*)sum, (double*)sq);
  return (int)cudaGetLastError();
}

// vals (n, k) f64 and ids (n,) int64 sorted, contiguous, n >= 1; cnt (G,),
// sum/sq (G, k) need no zero fill (the kernels write every group); tile a
// multiple of 32 * WARPS * rows_per_thread(k) rows; rec: ceil(n / tile) *
// 2 * (2 + 2k) doubles.  k in 1..8.  Two launches.
extern "C" int segstats_f64(const void* vals, const void* ids, i64 n, i64 k,
                            i64 G, i64 tile, void* cnt, void* sum, void* sq,
                            void* rec, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define SEGSTATS_K(K_) \
  case K_: return run<K_>(vals, ids, n, G, tile, cnt, sum, sq, rec, st);
  switch (k) {
    SEGSTATS_K(1) SEGSTATS_K(2) SEGSTATS_K(3) SEGSTATS_K(4)
    SEGSTATS_K(5) SEGSTATS_K(6) SEGSTATS_K(7) SEGSTATS_K(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SEGSTATS_K
}
