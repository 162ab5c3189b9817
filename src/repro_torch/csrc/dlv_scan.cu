// DLV Algorithm-5 cut scan for Hopper (sm_90a).
//
// Replaces the jitted JAX column scan repro/core/dlv.py::_dlv_scan_cols
// (the TPU branch of _seg_cuts).  Each segment of the concatenated array
// vals (sorted, centred on its own mean) is scanned in order with
// Kahan-compensated running count / sum / sum of squares; a cut is placed
// before x_i when the running variance including x_i exceeds the
// segment's beta (never at a segment's first row), and the stats restart
// at x_i.  The arithmetic is the reference host twin _scan_cols_np's,
// operation for operation; the file is built with -fmad=false so that
// nvcc does not contract x*x - c2 or t2/k1 - mean*mean into FMAs, which
// would change the rounding and move a cut that lies near beta.
//
// Bound: the scan is a serial dependency chain per segment (two f64
// divisions per row), not memory.  Two paths, chosen per segment by the
// wrapper (kernels/dlv_scan.py, LONG_MIN rows):
//
// * Short segments: dlv_scan_kernel, one thread per segment.  A thread
//   loads PF rows into registers before it scans them, so the loads of a
//   batch are in flight together instead of one DRAM round trip per row.
//
// * Long segments: dlv_scan_long_kernel, one CTA per segment, all long
//   segments in one launch.  A scan restarted fresh at a cut row reaches,
//   after that row, exactly the state the running scan sets at the cut
//   (k = 1, s1 = x, c1 = 0, s2 = x*x, c2 = 0).  So any guess of the cut
//   list can be checked window by window, independently, and repaired at
//   its first wrong window.  Each CTA loops, with no host sync:
//     speculate -- walk the segment in tiles of TILE rows (LT threads x RPT
//       consecutive rows), each brought into shared memory by one 1-d
//       bulk copy (TMA), two tiles in flight, and moved by the block into
//       a padded layout that each thread's RPT rows read without bank
//       conflicts; a block scan gives every row its tile prefix of
//       (x - u, (x - u)^2), u the tile's first value; with the carry from
//       the window start, every row of the tile is tested at once with the
//       division-free k*S2 - S1^2 > beta*k^2, the first hit taken by
//       __syncthreads_or and a block minimum, recorded as a speculative
//       cut, and the window restarted there (sums restart at every cut);
//     verify -- one thread per speculative window runs the compensated
//       recurrence above from the window start, operation for operation,
//       and finds its first compensated cut.  Inside a window the Kahan
//       chain does not depend on the cut test, so the test runs beside
//       the chain, not on it: a product-form test with a guard band says
//       "surely no cut" for every row but a window's last few, and only a
//       batch it flags is stepped again with the division form
//       (first_comp_cut);
//     repair -- at the first window whose compensated first cut is not its
//       speculative end, the cuts before it are final; the compensated cut
//       (or, for a spurious speculative cut, the rule "no cut up to it")
//       restarts speculation.  Every repair moves (window start, first row
//       allowed to cut) strictly forward; past 2L + 4 passes the kernel
//       traps instead of hanging the card.
//   So the long path's cuts are the compensated scan's, bit for bit, on
//   every input; speculation only sets how much work that takes.  Its
//   floor is one SM walking the segment plus the longest window's serial
//   compensated chain (about four dependent f64 adds per row).  1,024
//   threads would leave 64 registers a thread, which the verify batch
//   exceeds, so a CTA is 512 threads x 16 rows.
//
// The end of the file holds the seed's uncompensated scan of one span
// (dlv_1d_seed, dlv_heap's scan="seed"), replacing
// repro/core/dlv.py::_dlv_scan_seed: prefix sums across the card and a
// certified chain walk (see the note there), and the one-thread kernel it
// replaced, dlv_scan_seed_serial.
#include <cuda_runtime.h>
#include <stdint.h>

#define PF 16

__global__ void dlv_scan_kernel(const double* __restrict__ vals,
                                const int64_t* __restrict__ starts,
                                const int64_t* __restrict__ lens,
                                const double* __restrict__ beta,
                                int64_t nseg, uint8_t* __restrict__ cuts) {
  const int64_t sg = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (sg >= nseg) return;
  const int64_t a = starts[sg];
  const int64_t L = lens[sg];
  const double B = beta[sg];
  double k = 0.0, s1 = 0.0, c1 = 0.0, s2 = 0.0, c2 = 0.0;
  for (int64_t i0 = 0; i0 < L; i0 += PF) {
    const int64_t cnt = L - i0 < PF ? L - i0 : PF;
    double xs[PF];
#pragma unroll
    for (int u = 0; u < PF; ++u) xs[u] = u < cnt ? vals[a + i0 + u] : 0.0;
#pragma unroll
    for (int u = 0; u < PF; ++u) {
      if (u >= cnt) break;
      const double x = xs[u];
      const double k1 = k + 1.0;
      const double x2 = x * x;
      const double y1 = x - c1;
      const double t1 = s1 + y1;
      const double c1n = (t1 - s1) - y1;
      const double y2 = x2 - c2;
      const double t2 = s2 + y2;
      const double c2n = (t2 - s2) - y2;
      const double mean = t1 / k1;
      const double var = t2 / k1 - mean * mean;
      const bool cut = (var > B) && (k > 0.0);
      cuts[a + i0 + u] = cut ? 1 : 0;
      if (cut) {
        k = 1.0; s1 = x; c1 = 0.0; s2 = x2; c2 = 0.0;
      } else {
        k = k1; s1 = t1; c1 = c1n; s2 = t2; c2 = c2n;
      }
    }
  }
}

extern "C" int dlv_scan_f64(const void* vals, const void* starts,
                            const void* lens, const void* beta, int64_t nseg,
                            void* cuts, void* stream) {
  if (nseg <= 0) return (int)cudaGetLastError();
  const int threads = 128;
  const unsigned blocks = (unsigned)((nseg + threads - 1) / threads);
  dlv_scan_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const double*)vals, (const int64_t*)starts, (const int64_t*)lens,
      (const double*)beta, nseg, (uint8_t*)cuts);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ long path

#define LT 512                       // threads per CTA
#define RPT 16                       // consecutive rows per thread per tile
#define TILE (LT * RPT)              // rows per tile
#define TILE_PAD (TILE + TILE / RPT) // row q at q + q / RPT: conflict-free
#define SPEC_CAP 4096                // speculative cuts per pass
#define VPF 8                        // verify: chain rows per batch
#define PD 1024                      // verify: rows prefetched ahead
#define GROUP 64                     // verify: rows per read of the tests
#define NO_HIT 0x7fffffff
#define STAGE (TILE + 2)             // a tile and one row each side
#define LONG_SMEM \
  ((TILE_PAD + 2 * STAGE) * sizeof(double) + SPEC_CAP * sizeof(int))
#define WAIT_TRAP (1u << 26)

// stats[]: what one call did, summed over its long segments
// (the longest window is a maximum over segments; the rest are sums)
enum { ST_SEGMENTS, ST_PASSES, ST_SPEC_CUTS, ST_WINDOWS, ST_REPAIRS,
       ST_SPEC_CYCLES, ST_VERIFY_CYCLES, ST_TILES, ST_WAIT_CYCLES,
       ST_SCAN_CYCLES, ST_LONGEST, ST_COUNT };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// spin until the phase of `bar` with this parity has completed; a wait
// that never ends (a fault in the pipeline) traps instead of hanging
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) return;
    if (tries == WAIT_TRAP) __trap();
  }
}

// Rows [t*TILE, t*TILE + n) of the segment, n = min(TILE, L - t*TILE), by
// one 1-d bulk copy (TMA) into `stage`, its bytes counted on `bar`.  A
// bulk copy moves 16-byte aligned multiples of 16 bytes, so it starts
// o = 0 or 1 rows early (at the aligned address) and stops at an even
// count; a last odd row is left to the caller.  Issued by one thread.
__device__ __forceinline__ void stage_tile(double* stage, uint64_t* bar,
                                           const double* v, long long L,
                                           long long t) {
  const double* src = v + t * TILE;
  const int o = (int)((reinterpret_cast<uintptr_t>(src) >> 3) & 1);
  const long long n = L - t * TILE < TILE ? L - t * TILE : TILE;
  const uint32_t bytes = (uint32_t)(((o + n) & ~1ll) * sizeof(double));
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
  if (bytes)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        :: "r"(smem_u32(stage)), "l"(src - o), "r"(bytes),
           "r"(smem_u32(bar))
        : "memory");
}

// Whether t2/k1 - (t1/k1)^2 > B (the division form's decision) is
// certainly false, by a test without division: k1*t2 - t1^2 plus a guard
// band of 2^-44 of its terms' magnitudes below B*k1^2 shrunk by 2^-44
// (blo, the caller's).  The band is far wider than the few ulps by which
// the division form, the product form and the bar's product can each be
// off; NaN and inf never pass.  An f64 division is a called subroutine, so
// the rows that pass (all but a window's last few) divide nothing.
__device__ __forceinline__ bool surely_below(double t1, double t2,
                                             double k1, double blo) {
  const double a1 = t2 * k1;
  const double b1 = t1 * t1;
  const double bar = blo * (k1 * k1);
  return fma(0x1p-44, fabs(a1) + b1, a1 - b1) < bar;
}

// A bar below which every row of a batch is surely no cut: with k the
// count before the batch and t2 the compensated sum of squares after it,
// each row's k1*t2 - t1^2 is held to B*k1^2 shrunk by 2^-44 (blo), taken
// at the batch's end where it is least, less a band of 2^-42 * k_end *
// |t2|.  That band bounds surely_below's for every row of the batch:
// t2 grows through the batch and t1^2 <= k1*t2 (Cauchy-Schwarz, to a few
// ulps).  NaN and inf never pass.
__device__ __forceinline__ double batch_bar(double blo, double k,
                                            double t2) {
  const double kf = k + 1.0, ke = k + (double)VPF;
  return (blo >= 0.0 ? blo * (kf * kf) : blo * (ke * ke)) -
         0x1p-42 * ke * fabs(t2);
}

__device__ __forceinline__ bool division_cut(double t1, double t2,
                                             double k1, double B) {
  const double mean = t1 / k1;
  const double var = t2 / k1 - mean * mean;
  return var > B;
}

__device__ __forceinline__ void prefetch_l2(const double* p) {
  asm volatile("prefetch.global.L2 [%0];" :: "l"(p));
}

// One compensated row step (dlv_scan_kernel's, restart never taken).
#define COMP_STEP(x)                       \
  do {                                     \
    const double x2_ = (x) * (x);          \
    const double y1_ = (x) - c1;           \
    const double t1_ = s1 + y1_;           \
    c1 = (t1_ - s1) - y1_;                 \
    const double y2_ = x2_ - c2;           \
    const double t2_ = s2 + y2_;           \
    c2 = (t2_ - s2) - y2_;                 \
    s1 = t1_;                              \
    s2 = t2_;                              \
  } while (0)

// A batch of VPF rows from row i (i even in address, so 16-byte aligned),
// as VPF / 2 pairs; rows past e read as 0 and no load reaches past e.
__device__ __forceinline__ void load_batch(double* xs,
                                           const double* __restrict__ v,
                                           long long i, long long e) {
#pragma unroll
  for (int u = 0; u < VPF; u += 2) {
    double2 p = make_double2(0.0, 0.0);
    if (i + u + 1 <= e)
      p = __ldg(reinterpret_cast<const double2*>(v + i + u));
    else if (i + u <= e)
      p.x = __ldg(v + i + u);
    xs[u] = p.x;
    xs[u + 1] = p.y;
  }
}

// First row in (a, e] at which the compensated scan started fresh at row a
// cuts, or -1: the recurrence of dlv_scan_kernel with the restart never
// taken, so a window ends at its first cut.  A window is one thread's
// serial walk, four dependent f64 adds a row, so its loads and tests must
// cost little beside that chain: rows come in 16-byte pairs a batch ahead
// (after row a alone if it is not 16-byte aligned: it needs no test) and
// are asked of L2 PD rows ahead; each row is tested by the product form
// against the batch's bar (batch_bar), without a branch, and the tests
// are read once per group of GROUP rows.  A group with a row not surely
// below the bar is stepped again from its saved state, the division form
// deciding each row that surely_below does not; without a cut in it the
// walk goes on after it.
__device__ long long first_comp_cut(const double* __restrict__ v,
                                    long long a, long long e, double B) {
  const double eps = 0x1p-44;
  const double blo = B >= 0.0 ? B * (1.0 - eps) : B * (1.0 + eps);
  double k = 0.0, s1 = 0.0, c1 = 0.0, s2 = 0.0, c2 = 0.0;
  long long i = a;
  if (reinterpret_cast<uintptr_t>(v + a) & 15) {  // row a: never cuts
    COMP_STEP(v[a]);
    k = 1.0;
    ++i;
  }
  double gk = k, gs1 = s1, gc1 = c1, gs2 = s2, gc2 = c2;  // group start
  long long gi = i;
  bool any = false;
  for (long long r = i; r <= e && r < i + PD; r += 16) prefetch_l2(v + r);
  double nx[VPF];
  load_batch(nx, v, i, e);
  int nb = 0;                          // batches into the group
  for (; i <= e; i += VPF) {
    if (nb == 0) {
      gi = i;
      gk = k; gs1 = s1; gc1 = c1; gs2 = s2; gc2 = c2;
    }
    if (i + PD <= e) prefetch_l2(v + i + PD);
    double xs[VPF], d[VPF];
#pragma unroll
    for (int u = 0; u < VPF; ++u) xs[u] = nx[u];
    load_batch(nx, v, i + VPF, e);
    const int cnt = e - i + 1 < VPF ? (int)(e - i + 1) : VPF;
    const bool at_start = k == 0.0;    // row a never cuts
#pragma unroll
    for (int u = 0; u < VPF; ++u) {
      COMP_STEP(xs[u]);
      d[u] = s2 * (k + (double)(u + 1)) - s1 * s1;
    }
    const double bar = batch_bar(blo, k, s2);
    bool hit = false;
#pragma unroll
    for (int u = 0; u < VPF; ++u)
      hit |= (u < cnt) & ((u > 0) | !at_start) & !(d[u] < bar);
    any |= hit;
    k += (double)VPF;
    const long long next = i + VPF;
    if (++nb == GROUP / VPF || next > e) {
      nb = 0;
      if (any) {                       // this group again, exactly
        k = gk; s1 = gs1; c1 = gc1; s2 = gs2; c2 = gc2;
        const long long end = next - 1 < e ? next - 1 : e;
        for (long long r = gi; r <= end; ++r) {
          COMP_STEP(v[r]);
          const double k1 = k + 1.0;
          if (k > 0.0 && !surely_below(s1, s2, k1, blo) &&
              division_cut(s1, s2, k1, B))
            return r;
          k = k1;
        }
        k = gk + (double)(next - gi);  // as the batches left it
        any = false;
      }
    }
  }
  return -1;
}

// The tile prefix of (x - u, (x - u)^2) just before a thread's row i of
// the tile (xrow: its RPT rows, r0: the first one's row), in the order in
// which the speculation's hit test accumulates it: the thread's offset,
// then its rows one by one.
__device__ __forceinline__ void prefix_before(const double* xrow, double u,
                                              int i, long long r0,
                                              long long L, double off1,
                                              double off2, double& b1,
                                              double& b2) {
  b1 = off1;
  b2 = off2;
#pragma unroll
  for (int j = 0; j < RPT - 1; ++j) {
    if (j < i) {
      const double d = r0 + j < L ? xrow[j] - u : 0.0;
      b1 += d;
      b2 += d * d;
    }
  }
}

__global__ void __launch_bounds__(LT, 1)
dlv_scan_long_kernel(const double* __restrict__ vals,
                     const int64_t* __restrict__ starts,
                     const int64_t* __restrict__ lens,
                     const double* __restrict__ beta,
                     uint8_t* __restrict__ cuts,
                     const int32_t* __restrict__ init_spec, int init_n,
                     unsigned long long* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* stages = reinterpret_cast<double*>(smem_raw);  // 2 x STAGE
  double* xb = stages + 2 * STAGE;                        // TILE_PAD
  int* spec = reinterpret_cast<int*>(xb + TILE_PAD);
  __shared__ __align__(8) uint64_t bars[2];
  __shared__ double wsum1[LT / 32], wsum2[LT / 32];
  __shared__ double s_b1, s_b2;
  __shared__ int s_hit[2], s_bad;
  __shared__ long long s_f;
  __shared__ unsigned long long s_longest, s_st[ST_COUNT];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long a = starts[blockIdx.x];
  const long long L = lens[blockIdx.x];
  const double B = beta[blockIdx.x];
  const double* v = vals + a;
  uint8_t* cb = cuts + a;
  const long long ntiles = (L + TILE - 1) / TILE;

  if (tid == 0) {
    for (int i = 0; i < 2; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_u32(&bars[i])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  uint32_t phase = 0;                // bit s: parity of stage s's next wait
  uint32_t pending = 0;              // bit s: a copy into stage s in flight
  long long w = 0, lo = 1;           // window start; first row allowed
  if (tid < ST_COUNT) s_st[tid] = tid == ST_SEGMENTS;
  bool use_init = init_n >= 0;      // the caller's guess, or none (-1)
  for (long long pass = 0;; ++pass) {
    if (pass > 2 * L + 4) __trap();  // repairs always advance: a fault
    if (tid == 0) {
      s_hit[0] = NO_HIT;
      s_hit[1] = NO_HIT;
      s_bad = NO_HIT;
      s_longest = 0;
    }
    __syncthreads();
    const long long c0 = clock64();
    const long long w0 = w;
    int n = 0;
    bool full = false;
    if (use_init) {                  // the caller's guess stands in for
      n = init_n;                    // this pass's speculation
      for (int j = tid; j < n; j += LT) spec[j] = init_spec[j];
      use_init = false;
    } else {
      // ---------------------------------------------------- speculate
      long long t = w / TILE;
      if (tid == 0) {                // two tiles in flight
        for (long long u = t; u < t + 2 && u < ntiles; ++u)
          stage_tile(stages + (u & 1) * STAGE, &bars[u & 1], v, L, u);
      }
      for (long long u = t; u < t + 2 && u < ntiles; ++u)
        pending |= 1u << (u & 1);
      double D = 0.0, Q = 0.0, kc = 0.0, uprev = 0.0, B1 = 0.0, B2 = 0.0;
      bool first = true;
      for (; t < ntiles; ++t) {
        const int sl = (int)(t & 1);
        const long long cw = clock64();
        mbar_wait(&bars[sl], (phase >> sl) & 1u);
        const long long cs = clock64();
        if (tid == 0) s_st[ST_WAIT_CYCLES] += cs - cw;
        phase ^= 1u << sl;
        pending &= ~(1u << sl);
        {                            // stage -> the padded tile, coalesced
          const double* src = stages + sl * STAGE;
          const long long ts = t * TILE;
          const int o = (int)((reinterpret_cast<uintptr_t>(v + ts) >> 3) & 1);
          const long long nrow = L - ts < TILE ? L - ts : TILE;
          const long long odd = ((o + nrow) & 1) ? nrow - 1 : -1;
#pragma unroll 4
          for (int p = 0; p < RPT; ++p) {    // (row `odd` is not staged)
            const int q = tid + p * LT;
            xb[q + q / RPT] = q < nrow ? (q == odd ? v[ts + q] : src[o + q])
                                       : 0.0;
          }
        }
        __syncthreads();             // the stage is free: refill it
        if (t + 2 < ntiles) {
          if (tid == 0)
            stage_tile(stages + sl * STAGE, &bars[sl], v, L, t + 2);
          pending |= 1u << sl;
        }
        if (tid == 0) ++s_st[ST_TILES];
        const long long ts = t * TILE;
        const long long r0 = ts + (long long)tid * RPT;
        const double u = xb[0];
        const double* xrow = xb + tid * (RPT + 1);
        double a1 = 0.0, a2 = 0.0;   // the thread's totals
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const double d = r0 + i < L ? xrow[i] - u : 0.0;
          a1 += d;
          a2 += d * d;
        }
        // block exclusive scan of the threads' totals
        double e1 = a1, e2 = a2;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const double n1 = __shfl_up_sync(0xffffffffu, e1, off);
          const double n2 = __shfl_up_sync(0xffffffffu, e2, off);
          if (lane >= off) { e1 += n1; e2 += n2; }
        }
        if (lane == 31) { wsum1[warp] = e1; wsum2[warp] = e2; }
        __syncthreads();
        if (warp == 0) {
          double g1 = lane < LT / 32 ? wsum1[lane] : 0.0;
          double g2 = lane < LT / 32 ? wsum2[lane] : 0.0;
#pragma unroll
          for (int off = 1; off < 32; off <<= 1) {
            const double n1 = __shfl_up_sync(0xffffffffu, g1, off);
            const double n2 = __shfl_up_sync(0xffffffffu, g2, off);
            if (lane >= off) { g1 += n1; g2 += n2; }
          }
          if (lane < LT / 32) { wsum1[lane] = g1; wsum2[lane] = g2; }
        }
        __syncthreads();
        const double off1 = (warp ? wsum1[warp - 1] : 0.0) + e1 - a1;
        const double off2 = (warp ? wsum2[warp - 1] : 0.0) + e2 - a2;
        const double tot1 = wsum1[LT / 32 - 1], tot2 = wsum2[LT / 32 - 1];

        if (first) {                 // the window starts in this tile
          first = false;
          D = Q = kc = 0.0;
          B1 = B2 = 0.0;
          if (w > ts) {              // prefix just before row w
            const int hw = (int)(w - ts);
            if (tid == hw / RPT) {
              double b1, b2;
              prefix_before(xrow, u, hw % RPT, r0, L, off1, off2, b1, b2);
              s_b1 = b1;
              s_b2 = b2;
            }
            __syncthreads();
            B1 = s_b1;
            B2 = s_b2;
          }
        } else {                     // carry from the window start, moved
          const double dl = u - uprev;   // to this tile's shift
          Q = Q - 2.0 * dl * D + kc * dl * dl;
          D = D - kc * dl;
          B1 = B2 = 0.0;
        }
        if (tid == 0) s_st[ST_SCAN_CYCLES] += clock64() - cs;
        for (;;) {                   // every speculative cut in this tile
          int mine = NO_HIT;
          const double k0 = (double)(r0 - w + 1);
          double q1 = off1, q2 = off2;   // the prefix through row i
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const long long row = r0 + i;
            const double d = row < L ? xrow[i] - u : 0.0;
            q1 += d;
            q2 += d * d;
            const double k = k0 + (double)i;
            const double S1 = D + q1 - B1;
            const double S2 = Q + q2 - B2;
            if (mine == NO_HIT && row >= lo && row < L &&
                k * S2 - S1 * S1 > B * (k * k))
              mine = tid * RPT + i;
          }
          if (!__syncthreads_or(mine != NO_HIT)) break;
          const unsigned m = __reduce_min_sync(0xffffffffu, (unsigned)mine);
          if (lane == 0 && m != NO_HIT) atomicMin(&s_hit[n & 1], (int)m);
          __syncthreads();
          const int h = s_hit[n & 1];
          if (tid == 0) s_hit[(n + 1) & 1] = NO_HIT;
          if (tid == h / RPT) {
            double b1, b2;
            prefix_before(xrow, u, h % RPT, r0, L, off1, off2, b1, b2);
            s_b1 = b1;
            s_b2 = b2;
            spec[n] = (int)(ts + h);
          }
          __syncthreads();
          B1 = s_b1;
          B2 = s_b2;
          D = Q = 0.0;
          w = ts + h;
          lo = w + 1;
          if (++n == SPEC_CAP) { full = true; break; }
        }
        if (full) break;
        if (w >= ts) { D = tot1 - B1; Q = tot2 - B2; }
        else { D += tot1; Q += tot2; }
        kc = (double)(ts + TILE - w);
        uprev = u;
        __syncthreads();             // the padded tile is rewritten next
      }
      for (int sl = 0; sl < 2; ++sl)  // drain copies a full buffer left
        if (pending & (1u << sl)) {
          mbar_wait(&bars[sl], (phase >> sl) & 1u);
          phase ^= 1u << sl;
        }
      pending = 0;
    }
    __syncthreads();
    const long long c1 = clock64();

    // ------------------------------------------------------- verify
    // window j runs from w0 (j = 0) or spec[j-1] to spec[j]; without a
    // full buffer one more, open, window runs to the segment's end
    const int nw = full ? n : n + 1;
    long long f_mine = -1;
    int j_mine = NO_HIT;
    unsigned long long longest = 0;
    for (int j = tid; j < nw; j += LT) {
      const long long ws = j ? spec[j - 1] : w0;
      const bool closed = j < n;
      const long long we = closed ? spec[j] : L - 1;
      longest = max(longest, (unsigned long long)(we - ws + 1));
      const long long f = first_comp_cut(v, ws, we, B);
      if (closed ? f != we : f >= 0) { j_mine = j; f_mine = f; break; }
    }
    if (j_mine != NO_HIT) atomicMin(&s_bad, j_mine);
    if (longest) atomicMax(&s_longest, longest);
    __syncthreads();
    const int jb = s_bad;
    if (j_mine == jb && jb != NO_HIT) s_f = f_mine;
    // ------------------------------------------------------- commit
    const int ok = jb == NO_HIT ? n : jb;  // spec[0..ok) are true cuts
    for (int j = tid; j < ok; j += LT) cb[spec[j]] = 1;
    __syncthreads();
    if (tid == 0) {
      s_st[ST_PASSES] += 1;
      s_st[ST_SPEC_CUTS] += n;
      s_st[ST_WINDOWS] += nw;
      s_st[ST_SPEC_CYCLES] += c1 - c0;
      s_st[ST_VERIFY_CYCLES] += clock64() - c1;
      s_st[ST_LONGEST] = max(s_st[ST_LONGEST], s_longest);
      s_st[ST_REPAIRS] += jb != NO_HIT;
    }
    if (jb == NO_HIT) {
      if (!full) break;              // verified to the segment's end
      w = spec[n - 1];
      lo = w + 1;
    } else {                         // repair
      const long long f = s_f;
      if (f >= 0) {                  // the compensated cut comes first
        if (tid == 0) cb[f] = 1;
        w = f;
        lo = f + 1;
      } else {                       // spurious: no cut up to spec[jb]
        w = jb ? spec[jb - 1] : w0;
        lo = (long long)spec[jb] + 1;
      }
    }
    __syncthreads();                 // spec[] and s_f are rewritten next
  }
  if (tid == 0 && stats != nullptr)
    for (int i = 0; i < ST_COUNT; ++i) {
      if (i == ST_LONGEST) atomicMax(stats + i, s_st[i]);
      else atomicAdd(stats + i, s_st[i]);
    }
}

extern "C" int dlv_scan_long_f64(const void* vals, const void* starts,
                                 const void* lens, const void* beta,
                                 int64_t nseg, void* cuts,
                                 const void* init_spec, int64_t init_n,
                                 void* stats, void* stream) {
  static bool attr_set = false;
  if (nseg <= 0) return (int)cudaGetLastError();
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        dlv_scan_long_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)LONG_SMEM);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  dlv_scan_long_kernel<<<(unsigned)nseg, LT, LONG_SMEM,
                         (cudaStream_t)stream>>>(
      (const double*)vals, (const int64_t*)starts, (const int64_t*)lens,
      (const double*)beta, (uint8_t*)cuts, (const int32_t*)init_spec,
      (int)init_n, (unsigned long long*)stats);
  return (int)cudaGetLastError();
}


// ------------------------------------------------------------ seed scan
//
// Replaces the seed's jitted lax.scan repro/core/dlv.py::_dlv_scan_seed,
// the per-span scan behind dlv_1d_seed and dlv_heap(scan="seed"): one
// span, uncompensated running count / sum / sum of squares, a cut where
// var = s2/k - (s1/k)^2 including x exceeds beta (no guard at the first
// row; the caller clears cut 0), and a restart at (1, x, x*x).
//
// The rounding is the reference's as XLA compiles it for the CPU, where
// it was measured: s2 + x*x is a multiply and an add, each rounded, but
// s2/k - m*m is one fused multiply-add (at betas one ulp from a running
// variance the unfused form cuts elsewhere than the reference on about
// one span in nine; the fused one on none).  seed_var_gt spells out
// every operation as a round-to-nearest intrinsic (__dadd_rn, __dmul_rn,
// __ddiv_rn, and the one __fma_rn), which nvcc never contracts or splits
// whatever the flags (the file is also built with -fmad=false).
//
// Bound: 9 bytes a row (x read, the flag written), 0.0027 ms at 1M rows.
// Walked in order, each row's restart decision (two divisions, a
// subroutine on sm_90, and the FMA) feeds the next row's state:
// dlv_scan_seed_serial, the kernel this design replaced and that stays
// as its baseline (serial=True), takes ~147 ns a row on one thread.
//
// Why windows can be decided apart: the restart state at a cut row c,
// (1, x_c, fl(x_c^2)), is exactly the state of the scan started fresh at
// c (0 + x and 0 + x*x round to themselves).  So the scan's value at row
// i of the window that starts at j, var_ref(j, i), depends on j and i
// alone, and the cuts are: c_0 = 0; c_{t+1} = the first i > c_t with
// var_ref(c_t, i) > beta.  (Row 0's own flag, var_ref(0, 0) > beta, is
// taken from the chain's first step; it does not move the window.)
//
// The design, four kernels a call (dlv_scan_seed_f64):
//  1. dlv_scan_seed_totals, _bases, _prefix (every SM): double-double
//     (hi + lo, only error-free additions: two_sum) prefix sums P1 of x
//     and P2 of fl(x*x), in tiles of SEED_TILE rows (SEED_THREADS
//     threads x SEED_RPT consecutive rows; a thread's rows in order, a
//     Hillis-Steele scan over the lanes, then over the warps); the tile
//     totals scanned by one block, in chunks of SEED_TILE with a carry;
//     then each tile's rows again with its base.  The order of every
//     addition is fixed, so kernels/dlv_scan.py's mirror gives the same
//     bits.  32 bytes a row of scratch (32 MB at 1M rows: in L2).
//  2. dlv_scan_seed_walk (one CTA of WALK_T threads): from a window
//     start j, a row i is tested from s1 = (P1h[i] - P1h[j-1]) +
//     (P1l[i] - P1l[j-1]), likewise s2, and k = i - j + 1: d = k*s2 -
//     s1*s1 estimates k^2 var_ref(j, i), and e = d - beta*k*k is held
//     against a band W (below).  e < -W: surely no cut; e > W: surely a
//     cut; else (or e not finite) uncertain.  A block of rows a..b is
//     tested from row b's prefix alone, with the bar beta*ka*kb (ka, kb
//     the window's counts at a and b): e < -W proves every row of it
//     below beta (the block argument below).  Each test of the walk
//     takes, from the first undecided row lo, WALK_ROWS rows one a
//     thread and then WALK_T - WALK_ROWS blocks of WALK_L rows, one a
//     thread (33,024 rows; each thread one load from L2), and the first
//     item not proved below (a block minimum):
//       a block -- its rows are tested one by one next (the items before
//         it are decided);
//       a row surely a cut -- recorded; the window restarts there;
//       a row uncertain (a near-tie) -- thread 0 runs the reference's
//         chain from j (seed_serial: the sums alone up to that row, then
//         the exact decision, seed_cut_exact) to the window's cut.
//     After a window of fewer than SEED_SHORT rows, thread 0's chain
//     decides the next windows too, restarting at each cut, until one
//     reaches SEED_SHORT rows (dense cuts: a test a window would cost
//     more than the chain).  Every test moves the first undecided row
//     strictly forward; past 2n + 4 tests the kernel traps.  A window of
//     ~10^4 rows costs two tests: one that finds the block holding its
//     cut (the bar is tight there: kb/ka ~ 1), one that finds the cut.
//  So the cuts are the reference's bit for bit on every input: a row is
//  decided by the band only where the band proves the reference's
//  decision, and by the reference's own arithmetic everywhere else.
//  Speed depends on the data (near-ties cost a serial chain from the
//  window start); correctness does not, and nothing assumes a sorted
//  span.
//
// The band.  u = 2^-53, eta = 2^-1075 (underflow), window of k rows,
// S1 = sum x, S2 = sum x^2 (exact), Q = S2/k, V = Q - (S1/k)^2 in [0, Q].
// (R) The reference's chain: |s1^ - S1| <= g_{k-1} sum|x| <= g_{k-1}
//     sqrt(k S2) (Cauchy-Schwarz), |s2^ - S2| <= g_k S2 + 2k eta, then
//     m = fl(s1^/k), q = fl(s2^/k), var = fl(q - m*m) (one rounding), so
//     |var_ref - V| <= (3k + 3) u Q (1 + 2^-19) + 6 eta  (k < 2^31; the
//     eta*sqrt(Q) terms folded by 2 eta sqrt(Q) <= u Q + eta^2/u).
// (E) The estimate: the prefixes' error is at most 3.01 u^2 (sum|x|)
//     per level of the addition tree and there are at most n + 2
//     levels, so with T2 >= sum x^2 (P2's total, 1 + 2^-40 up) and
//     sum|x| <= sqrt(n T2): E1 = 16 (n + 2) u^2 sqrt(n T2),
//     E2 = 16 (n + 2) u^2 T2 bound the prefix differences' errors beyond
//     2u|S1| and 3u S2 (the hi/lo subtraction, fl(x*x)).  Rounding a, p,
//     d: |d - k^2 V| <= 10 u k S2 (1 + eps) + k E2 (1 + 2u) + 2.02 |S1|
//     E1 + 1.01 E1^2 + ...
// Together, in the computed a = k s2 and s1:
//     |k^2 var_ref - d| <= (3k + 13) u |a| (1 + eps) + 1.01 k E2
//                          + 2.02 |s1| E1 + 3.03 E1^2 + 12 k^2 eta,
// and |fl(beta k k) - beta k^2| <= 2.01 u |bk| + (k + 1) eta.  The band
//     W = (k + 5) 4u |a| + k (2 E2 + k 2^-1000) + 3 |s1| E1 + 4 E1^2
//         + 4u |bk|
// exceeds their sum by a third at least, term for term, which covers the
// ~11 roundings of W itself and the (1 + u) of reading the sign of
// e = fl(d - bk) (a rounding keeps the sign): e < -W gives k^2 var_ref
// < beta k^2, e > W gives k^2 var_ref > beta k^2.  It covers k = 1
// (var = the rounding error of x*x, which can exceed a tiny or negative
// beta), the cut row itself (i is in its window) and windows far from
// the span's mean (Q = m^2 + V: the band grows with m^2, the FMA's
// cancellation included).  tests/test_torch_dlv_seed.py checks it
// against exact rationals.  A non-finite sum, band or beta makes e or W
// non-finite: uncertain.
// The block argument: k V(j, i) = sum over the window of (x - mean)^2 =
// min over c of sum (x - c)^2 never decreases as i grows, so for a <= i
// <= b, ka kb V_i <= kb kb V_b; and the reference's error at i, times
// ka kb, is at most kb (3kb + 3) u S2_b (1 + eps) + 6 eta kb^2 (S2 grows
// with i, ka <= k_i).  Both are what row b's band covers, so
// ka kb var_ref(j, i) <= d_b + Wd_b: e = fl(d_b - fl(fl(beta ka) kb))
// < -W at row b proves var_ref(j, i) < beta for every i in a..b.
#define SEED_THREADS 512              // prefix pass: threads a tile
#define SEED_RPT 8                    // prefix pass: rows a thread
#define SEED_TILE (SEED_THREADS * SEED_RPT)
#define SEED_NW (SEED_THREADS / 32)
#define WALK_T 512                    // the walk's CTA (128 registers)
#define WALK_ROWS 256                 // its threads that test one row each
#define WALK_L 128                    // the others: a block of WALK_L rows
#define WALK_SPAN (WALK_ROWS + (WALK_T - WALK_ROWS) * WALK_L)  // rows a test
#define SEED_SHORT 8                  // a window shorter: the next serially
#define SER_CH 2048                   // the chain's rows a chunk (smem)
#define SEED_NONE 0xffffffffu

// dlv_scan_seed's counters (kernels/dlv_scan.py SEED_STAT_NAMES): windows
// (cuts after row 0, plus one), near-ties (serial chains run), rows the
// chains stepped, tiles loaded, block-wide first-hit tests, and cycles:
// the prefix pass's (summed over its blocks), the walk's tests and its
// serial chains (thread 0 of the walk)
enum { SS_WINDOWS, SS_NEAR_TIES, SS_SHORT_RUNS, SS_SERIAL_ROWS, SS_TESTS,
       SS_PREFIX_CYCLES, SS_TEST_CYCLES, SS_SERIAL_CYCLES, SS_COUNT };

struct dd2 { double h1, l1, h2, l2; };   // (P1, P2) as hi + lo each

__device__ __forceinline__ void two_sum(double a, double b, double& s,
                                        double& e) {
  s = __dadd_rn(a, b);
  const double bb = __dsub_rn(s, a);
  e = __dadd_rn(__dsub_rn(a, __dsub_rn(s, bb)), __dsub_rn(b, bb));
}

// (ah + al) + (bh + bl): the high parts' exact sum, the low parts added
// to its error, renormalised exactly; error <= 3.01 u^2 (|ah| + |bh|)
__device__ __forceinline__ void dd_add(double ah, double al, double bh,
                                       double bl, double& h, double& l) {
  double s, e;
  two_sum(ah, bh, s, e);
  e = __dadd_rn(e, __dadd_rn(al, bl));
  two_sum(s, e, h, l);
}

__device__ __forceinline__ dd2 dd2_add(const dd2& a, const dd2& b) {
  dd2 r;
  dd_add(a.h1, a.l1, b.h1, b.l1, r.h1, r.l1);
  dd_add(a.h2, a.l2, b.h2, b.l2, r.h2, r.l2);
  return r;
}

__device__ __forceinline__ dd2 dd2_zero() {
  dd2 z = {0.0, 0.0, 0.0, 0.0};
  return z;
}

__device__ __forceinline__ dd2 shfl_up_dd2(const dd2& v, int off) {
  dd2 r;
  r.h1 = __shfl_up_sync(0xffffffffu, v.h1, off);
  r.l1 = __shfl_up_sync(0xffffffffu, v.l1, off);
  r.h2 = __shfl_up_sync(0xffffffffu, v.h2, off);
  r.l2 = __shfl_up_sync(0xffffffffu, v.l2, off);
  return r;
}

// A tile's scan: c[] holds this thread's SEED_RPT items (consecutive);
// with ROWS, they become their inclusive prefixes within the tile.
// Returns the tile's total.  The order of additions is the mirror's
// (kernels/dlv_scan.py::_block_scan_plain): the thread's items in order
// from zero, a Hillis-Steele scan of the thread totals over the lanes,
// one of the warp totals over the warps, then (warp prefix + lane
// prefix) + item prefix.
template <bool ROWS>
__device__ __forceinline__ dd2 tile_scan(dd2 (&c)[SEED_RPT], dd2* s_w) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  dd2 acc = dd2_zero();
#pragma unroll
  for (int q = 0; q < SEED_RPT; ++q) {
    acc = dd2_add(acc, c[q]);
    c[q] = acc;
  }
  dd2 v = acc;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const dd2 nb = shfl_up_dd2(v, off);
    if (lane >= off) v = dd2_add(nb, v);
  }
  dd2 le = shfl_up_dd2(v, 1);
  if (lane == 0) le = dd2_zero();
  if (lane == 31) s_w[warp] = v;
  __syncthreads();
  if (warp == 0) {
    dd2 w = lane < SEED_NW ? s_w[lane] : dd2_zero();
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const dd2 nb = shfl_up_dd2(w, off);
      if (lane >= off) w = dd2_add(nb, w);
    }
    if (lane < SEED_NW) s_w[lane] = w;
  }
  __syncthreads();
  const dd2 total = s_w[SEED_NW - 1];
  if (ROWS) {
    const dd2 tb = dd2_add(warp ? s_w[warp - 1] : dd2_zero(), le);
#pragma unroll
    for (int q = 0; q < SEED_RPT; ++q) c[q] = dd2_add(tb, c[q]);
  }
  __syncthreads();                     // s_w is rewritten by the next scan
  return total;
}

// The tile's rows (zeros past n) as items (x, 0, fl(x*x), 0), each
// thread's SEED_RPT consecutive rows, through shared memory: coalesced
// loads, a padded layout without bank conflicts.
__device__ __forceinline__ void tile_items(const double* __restrict__ x,
                                           long long n, double* xs,
                                           dd2 (&c)[SEED_RPT]) {
  const long long base = (long long)blockIdx.x * SEED_TILE;
#pragma unroll 4
  for (int p = 0; p < SEED_RPT; ++p) {
    const int q = threadIdx.x + p * SEED_THREADS;
    xs[q + q / SEED_RPT] = base + q < n ? __ldg(x + base + q) : 0.0;
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < SEED_RPT; ++q) {
    const double v = xs[threadIdx.x * (SEED_RPT + 1) + q];
    c[q].h1 = v;
    c[q].l1 = 0.0;
    c[q].h2 = __dmul_rn(v, v);
    c[q].l2 = 0.0;
  }
}

__global__ void __launch_bounds__(SEED_THREADS)
dlv_scan_seed_totals(const double* __restrict__ x, int64_t n,
                     dd2* __restrict__ tot,
                     unsigned long long* __restrict__ stats) {
  __shared__ double xs[SEED_TILE + SEED_TILE / SEED_RPT];
  __shared__ dd2 s_w[SEED_NW];
  const long long c0 = clock64();
  dd2 c[SEED_RPT];
  tile_items(x, n, xs, c);
  const dd2 t = tile_scan<false>(c, s_w);
  if (threadIdx.x == 0) {
    tot[blockIdx.x] = t;
    if (stats) atomicAdd(stats + SS_PREFIX_CYCLES,
                         (unsigned long long)(clock64() - c0));
  }
}

// One block: the inclusive scan of the nt tile totals, in chunks of
// SEED_TILE with a carry between chunks.
__global__ void __launch_bounds__(SEED_THREADS)
dlv_scan_seed_bases(const dd2* __restrict__ tot, int64_t nt,
                    dd2* __restrict__ inc,
                    unsigned long long* __restrict__ stats) {
  __shared__ dd2 s_w[SEED_NW];
  __shared__ dd2 s_carry;
  const long long c0 = clock64();
  dd2 carry = dd2_zero();
  for (long long b0 = 0; b0 < nt; b0 += SEED_TILE) {
    const long long t0 = b0 + (long long)threadIdx.x * SEED_RPT;
    dd2 c[SEED_RPT];
#pragma unroll
    for (int q = 0; q < SEED_RPT; ++q)
      c[q] = t0 + q < nt ? tot[t0 + q] : dd2_zero();
    tile_scan<true>(c, s_w);
#pragma unroll
    for (int q = 0; q < SEED_RPT; ++q)
      if (t0 + q < nt) inc[t0 + q] = dd2_add(carry, c[q]);
    if (threadIdx.x == SEED_THREADS - 1)
      s_carry = dd2_add(carry, c[SEED_RPT - 1]);
    __syncthreads();
    carry = s_carry;
    __syncthreads();
  }
  if (threadIdx.x == 0 && stats)
    atomicAdd(stats + SS_PREFIX_CYCLES, (unsigned long long)(clock64() - c0));
}

// Every row's prefix: the tile's base (the totals' inclusive scan at the
// tile before, zero for tile 0) + the row's prefix within the tile, as
// two 16-byte halves (P1, then P2) a row.
__global__ void __launch_bounds__(SEED_THREADS)
dlv_scan_seed_prefix(const double* __restrict__ x, int64_t n,
                     const dd2* __restrict__ inc, double2* __restrict__ P,
                     unsigned long long* __restrict__ stats) {
  __shared__ double xs[SEED_TILE + SEED_TILE / SEED_RPT];
  __shared__ dd2 s_w[SEED_NW];
  const long long c0 = clock64();
  dd2 c[SEED_RPT];
  tile_items(x, n, xs, c);
  tile_scan<true>(c, s_w);
  const dd2 b = blockIdx.x ? inc[blockIdx.x - 1] : dd2_zero();
  const long long r0 =
      (long long)blockIdx.x * SEED_TILE + (long long)threadIdx.x * SEED_RPT;
#pragma unroll
  for (int q = 0; q < SEED_RPT; ++q) {
    if (r0 + q < n) {
      const dd2 p = dd2_add(b, c[q]);
      P[2 * (r0 + q)] = make_double2(p.h1, p.l1);
      P[2 * (r0 + q) + 1] = make_double2(p.h2, p.l2);
    }
  }
  if (threadIdx.x == 0 && stats)
    atomicAdd(stats + SS_PREFIX_CYCLES, (unsigned long long)(clock64() - c0));
}

// The reference's decision at a row whose running sums (x included) are
// s1n, s2n and count k1: var = s2n/k1 - m*m with one rounding, > beta.
__device__ __forceinline__ bool seed_var_gt(double s1n, double s2n,
                                            double k1, double beta) {
  const double m = __ddiv_rn(s1n, k1);
  const double var = __fma_rn(-m, m, __ddiv_rn(s2n, k1));
  return var > beta;
}

// One row of the reference's scan: the state (k, s1, s2) takes x, and the
// row cuts (the state restarts at (1, x, x*x)) where seed_var_gt says so.
__device__ __forceinline__ bool seed_step(double x, double& k, double& s1,
                                          double& s2, double beta) {
  const double k1 = __dadd_rn(k, 1.0);
  const double s1n = __dadd_rn(s1, x);
  const double x2 = __dmul_rn(x, x);
  const double s2n = __dadd_rn(s2, x2);
  const bool cut = seed_var_gt(s1n, s2n, k1, beta);
  k = cut ? 1.0 : k1;
  s1 = cut ? x : s1n;
  s2 = cut ? x2 : s2n;
  return cut;
}

// seed_var_gt's answer, without division where a band decides it: with
// the chain's own sums, k^2 var differs from k s2 - s1^2 by the two
// divisions' and the FMA's roundings (<= 5u k s2: s1^2 <= k s2 up to a
// relative 3 g_k by Cauchy-Schwarz), and evaluating e = (k s2 - s1 s1)
// - beta k k adds <= 6u of its terms; the band 2^-40 (|k s2| + |beta k
// k|) + k^2 2^-1000 is some 700 times that.  NaN, inf and the rows
// inside the band divide.
__device__ __forceinline__ bool seed_cut_exact(double s1, double s2,
                                               double k, double beta) {
  const double a = __dmul_rn(k, s2);
  const double bk = __dmul_rn(__dmul_rn(beta, k), k);
  const double e = __dsub_rn(__dsub_rn(a, __dmul_rn(s1, s1)), bk);
  const double w = __dadd_rn(__dmul_rn(0x1p-40, __dadd_rn(fabs(a), fabs(bk))),
                             __dmul_rn(__dmul_rn(k, k), 0x1p-1000));
  if (isfinite(e) && e < -w) return false;
  if (isfinite(e) && e > w) return true;
  return seed_var_gt(s1, s2, k, beta);
}

// The reference's chain from window start j (state (1, x_j, x_j*x_j), the
// restart's): its sums alone before row h (rows proved below beta), then
// each row's exact decision (seed_cut_exact), restarting at every cut.
// It stops at a cut that closes a window of SEED_SHORT rows or more, or,
// once the first window has closed (at once where `hold` is false), when
// the current window reaches SEED_SHORT rows without a cut, or at the
// span's end.  `hold` keeps a near-tie's window open to its cut.  Writes
// the cuts; returns the first undecided row (n at the end), *jw the
// window start there, *stepped the rows the chain took, *ncut the cuts.
// Called by the whole CTA: thread 0 runs the chain from shared memory
// while the other threads bring the next SER_CH rows in (a near-tie's
// sums-only stretch can be a whole window of ~10^5 rows).
__device__ __noinline__ long long seed_serial(
    const double* __restrict__ x, long long j, long long h, long long n,
    double beta, bool hold, uint8_t* __restrict__ cuts, long long* jw,
    long long* stepped, long long* ncut, double* xbuf, long long* s_out) {
  const int tid = threadIdx.x;
  const long long j0 = j, r0 = j + 1;
  // rows [cs, cs + SER_CH) into buf, by threads 1.. (thread 0 computes)
  auto stage = [&](double* buf, long long cs) {
    for (int q = tid - 1; q >= 0 && q < SER_CH; q += WALK_T - 1)
      buf[q] = cs + q < n ? __ldcg(x + cs + q) : 0.0;
  };
  stage(xbuf, r0);
  double k = 1.0, s1 = 0.0, s2 = 0.0;
  long long cutn = 0;
  if (tid == 0) {
    const double xj = __ldcg(x + j);
    s1 = xj;
    s2 = __dmul_rn(xj, xj);
    s_out[0] = r0 < n ? -1 : n;        // not done, or no row left
    s_out[1] = j;
    s_out[2] = 0;
  }
  __syncthreads();
  for (long long c = 0;; ++c) {
    const long long cs = r0 + c * SER_CH;
    if (cs >= n) break;
    if (tid) stage(xbuf + ((c + 1) & 1) * SER_CH, cs + SER_CH);
    if (tid == 0) {
      const double* xb = xbuf + (c & 1) * SER_CH;
      const int cnt = n - cs < SER_CH ? (int)(n - cs) : SER_CH;
      // rows proved below beta: the sums alone
      const int ns = h <= cs ? 0 : h - cs < cnt ? (int)(h - cs) : cnt;
#pragma unroll 8
      for (int i = 0; i < ns; ++i) {
        s1 = __dadd_rn(s1, xb[i]);
        s2 = __dadd_rn(s2, __dmul_rn(xb[i], xb[i]));
      }
      k = __dadd_rn(k, (double)ns);
      for (int i = ns; i < cnt; ++i) {
        const long long r = cs + i;
        const double v = xb[i];
        k = __dadd_rn(k, 1.0);
        s1 = __dadd_rn(s1, v);
        s2 = __dadd_rn(s2, __dmul_rn(v, v));
        if (seed_cut_exact(s1, s2, k, beta)) {
          cuts[r] = 1;
          ++cutn;
          if (r - j >= SEED_SHORT) {   // a long window closed: the walk's
            s_out[0] = r + 1;
            s_out[1] = r;
            break;
          }
          j = r;
          k = 1.0;
          s1 = v;
          s2 = __dmul_rn(v, v);
          hold = false;
        } else if (!hold && r - j + 1 >= SEED_SHORT) {  // no longer short
          s_out[0] = r + 1;
          s_out[1] = j;
          break;
        }
      }
      if (s_out[0] < 0 && cs + cnt >= n) {   // the span's end
        s_out[0] = n;
        s_out[1] = j;
      }
      s_out[2] = cutn;
    }
    __syncthreads();
    if (s_out[0] >= 0) break;
  }
  const long long lo = s_out[0];
  *jw = s_out[1];
  *ncut = s_out[2];
  *stepped = lo - j0;
  __syncthreads();                     // s_out and xbuf are reused
  return lo;
}

// The class of rows a..b of the window from j (prefix before it: a1 =
// P1[j-1], a2 = P2[j-1]; p1, p2 the prefix at b; ka, kb the window's
// counts at a and b): 0 every row of them surely no cut, else 1 (a = b
// only) row b surely a cut, or 2 uncertain.  With a = b it is the row
// test of the note; with a < b the block test (bar beta ka kb).
__device__ __forceinline__ int seed_classify(double2 p1, double2 p2,
                                             double2 a1, double2 a2,
                                             double kb, double ka,
                                             double beta, double E1x3,
                                             double E2x2, double E1sq4) {
  const double s1 = __dadd_rn(__dsub_rn(p1.x, a1.x), __dsub_rn(p1.y, a1.y));
  const double s2 = __dadd_rn(__dsub_rn(p2.x, a2.x), __dsub_rn(p2.y, a2.y));
  const double a = __dmul_rn(kb, s2);
  const double d = __dsub_rn(a, __dmul_rn(s1, s1));
  const double bk = __dmul_rn(__dmul_rn(beta, ka), kb);
  const double e = __dsub_rn(d, bk);
  double w = __dmul_rn(__dmul_rn(__dadd_rn(kb, 5.0), 0x1p-51), fabs(a));
  w = __dadd_rn(w, __dmul_rn(kb, __dadd_rn(E2x2, __dmul_rn(kb, 0x1p-1000))));
  w = __dadd_rn(w, __dmul_rn(fabs(s1), E1x3));
  w = __dadd_rn(w, E1sq4);
  w = __dadd_rn(w, __dmul_rn(fabs(bk), 0x1p-51));
  if (!isfinite(e)) return 2;
  return e < -w ? 0 : e > w ? 1 : 2;
}

// The block-wide minimum of each thread's `mine` (SEED_NONE for none) at
// the c-th call, through s_hit[c % 3]; every thread gets it.  Thread 0
// then clears the slot of call c + 2: every thread read it (call c - 1)
// before this call's barrier, and none writes it before call c + 1's.
__device__ __forceinline__ unsigned block_min(unsigned mine, unsigned* s_hit,
                                              unsigned long long c) {
  const unsigned m = __reduce_min_sync(0xffffffffu, mine);
  if ((threadIdx.x & 31) == 0 && m != SEED_NONE)
    atomicMin(&s_hit[c % 3], m);
  __syncthreads();
  const unsigned h = s_hit[c % 3];
  if (threadIdx.x == 0) s_hit[(c + 2) % 3] = SEED_NONE;
  return h;
}

__global__ void __launch_bounds__(WALK_T, 1)
dlv_scan_seed_walk(const double* __restrict__ x,
                   const double2* __restrict__ P, int64_t n, double beta,
                   uint8_t* __restrict__ cuts,
                   unsigned long long* __restrict__ stats) {
  __shared__ unsigned s_hit[3];
  __shared__ int s_cls;
  __shared__ double2 s_a[2];
  __shared__ double s_xbuf[2 * SER_CH];      // the serial chain's rows
  __shared__ long long s_out[3];
  __shared__ unsigned long long s_st[SS_COUNT];
  const int tid = threadIdx.x;
  // the prefix error bounds (every thread the same arithmetic)
  const double T2 = __dmul_rn(__ldcg(&P[2 * (n - 1) + 1].x), 1.0 + 0x1p-40);
  const double nn = (double)n;
  const double g = __dmul_rn(__dadd_rn(nn, 2.0), 0x1p-102);
  const double E2 = __dmul_rn(g, T2);
  const double E1 =
      __dmul_rn(__dmul_rn(g, __dsqrt_rn(__dmul_rn(nn, T2))), 1.0 + 0x1p-40);
  const double E1x3 = __dmul_rn(3.0, E1), E2x2 = __dmul_rn(2.0, E2);
  const double E1sq4 = __dmul_rn(__dmul_rn(4.0, E1), E1);
  if (tid < SS_COUNT) s_st[tid] = tid == SS_WINDOWS;
  if (tid == 0) {
    s_hit[0] = s_hit[1] = s_hit[2] = SEED_NONE;
    double k = 0.0, s1 = 0.0, s2 = 0.0;    // row 0's own flag
    cuts[0] = seed_step(__ldcg(x), k, s1, s2, beta) ? 1 : 0;
  }
  __syncthreads();
  long long j = 0, lo = 1, steps = 0;      // window start; first undecided
  double2 a1 = make_double2(0.0, 0.0), a2 = a1;  // P1, P2 at j - 1
  unsigned long long it = 0;                // block_min calls so far
  const bool single = tid < WALK_ROWS;      // a row of its own, or a block
  while (lo < n) {
    if (++steps > 2 * n + 4) __trap();     // the walk always advances
    const long long c0 = clock64();
    const long long ia = single ? lo + tid
        : lo + WALK_ROWS + (long long)(tid - WALK_ROWS) * WALK_L;
    const long long ib = single ? ia : (ia + WALK_L - 1 < n ? ia + WALK_L - 1
                                                             : n - 1);
    unsigned key = SEED_NONE;
    int cls = 0;
    double2 p1 = a1, p2 = a2;
    if (ia < n) {
      p1 = __ldcg(P + 2 * ib);
      p2 = __ldcg(P + 2 * ib + 1);
      const int c = seed_classify(p1, p2, a1, a2, (double)(ib - j + 1),
                                  (double)(ia - j + 1), beta, E1x3, E2x2,
                                  E1sq4);
      if (c) {
        key = (unsigned)ia;
        cls = single ? c : 3;
      }
    }
    const unsigned m = block_min(key, s_hit, it++);
    if (tid == 0) {
      ++s_st[SS_TESTS];
      s_st[SS_TEST_CYCLES] += clock64() - c0;
    }
    if (m == SEED_NONE) {              // every row to there surely below
      lo += WALK_SPAN;
      continue;
    }
    if (key == m) s_cls = cls;
    if (single && ia < n && ia + 1 == (long long)m) {  // prefix before m
      s_a[0] = p1;
      s_a[1] = p2;
    }
    __syncthreads();
    const int cl = s_cls;
    if (cl == 3) {                     // a block not proved below: its rows
      lo = m;                          // are tested one by one next
      continue;
    }
    long long jn = m, lon = m + 1;
    if (cl == 1 && (long long)m - j >= SEED_SHORT) {  // a cut: a new window
      if (tid == 0) {
        cuts[m] = 1;
        ++s_st[SS_WINDOWS];
      }
    } else {                           // a near-tie, or after a short window:
      const long long cs = clock64();  // the reference's chain decides
      long long jw, stepped, ncut;
      if (cl == 1) {
        if (tid == 0) cuts[m] = 1;
        lon = seed_serial(x, m, m + 1, n, beta, false, cuts, &jw, &stepped,
                          &ncut, s_xbuf, s_out);
      } else {
        lon = seed_serial(x, j, m, n, beta, true, cuts, &jw, &stepped, &ncut,
                          s_xbuf, s_out);
      }
      if (tid == 0) {
        if (cl == 1) {
          ++s_st[SS_WINDOWS];
          ++s_st[SS_SHORT_RUNS];
        } else {
          ++s_st[SS_NEAR_TIES];
        }
        s_st[SS_WINDOWS] += ncut;
        s_st[SS_SERIAL_ROWS] += stepped;
        s_st[SS_SERIAL_CYCLES] += clock64() - cs;
      }
      jn = jw;
    }
    if (jn != j) {                     // the new window's prefix before it
      if (jn == (long long)m && m > lo) {
        a1 = s_a[0];
        a2 = s_a[1];
      } else {
        a1 = __ldcg(P + 2 * (jn - 1));
        a2 = __ldcg(P + 2 * (jn - 1) + 1);
      }
    }
    j = jn;
    lo = lon;
  }
  __syncthreads();
  if (tid < SS_COUNT && stats != nullptr) atomicAdd(stats + tid, s_st[tid]);
}

extern "C" int dlv_scan_seed_f64(const void* vals, int64_t n, double beta,
                                 void* cuts, void* scratch, void* stats,
                                 void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t nt = (n + SEED_TILE - 1) / SEED_TILE;
  double2* P = (double2*)scratch;              // n rows x 32 bytes
  dd2* tot = (dd2*)(P + 2 * n);                // nt
  dd2* inc = tot + nt;                         // nt
  unsigned long long* st = (unsigned long long*)stats;
  dlv_scan_seed_totals<<<(unsigned)nt, SEED_THREADS, 0, s>>>(
      (const double*)vals, n, tot, st);
  dlv_scan_seed_bases<<<1, SEED_THREADS, 0, s>>>(tot, nt, inc, st);
  dlv_scan_seed_prefix<<<(unsigned)nt, SEED_THREADS, 0, s>>>(
      (const double*)vals, n, inc, P, st);
  dlv_scan_seed_walk<<<1, WALK_T, 0, s>>>((const double*)vals, P, n, beta,
                                          (uint8_t*)cuts, st);
  return (int)cudaGetLastError();
}

// The kernel this design replaced (once dlv_scan_seed_kernel), kept as
// its baseline: one thread walks the span with seed_step, PF rows loaded
// into registers ahead of the steps that use them.  Reached only through
// dlv_scan_seed(..., serial=True).
__global__ void dlv_scan_seed_serial(const double* __restrict__ vals,
                                     int64_t n, double beta,
                                     uint8_t* __restrict__ cuts) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  double k = 0.0, s1 = 0.0, s2 = 0.0;
  for (int64_t i0 = 0; i0 < n; i0 += PF) {
    const int64_t cnt = n - i0 < PF ? n - i0 : PF;
    double xs[PF];
#pragma unroll
    for (int u = 0; u < PF; ++u) xs[u] = u < cnt ? vals[i0 + u] : 0.0;
#pragma unroll
    for (int u = 0; u < PF; ++u) {
      if (u >= cnt) break;
      cuts[i0 + u] = seed_step(xs[u], k, s1, s2, beta) ? 1 : 0;
    }
  }
}

extern "C" int dlv_scan_seed_serial_f64(const void* vals, int64_t n,
                                        double beta, void* cuts,
                                        void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  dlv_scan_seed_serial<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const double*)vals, n, beta, (uint8_t*)cuts);
  return (int)cudaGetLastError();
}
