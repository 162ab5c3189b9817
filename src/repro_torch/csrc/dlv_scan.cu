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
// The end of the file holds a third kernel, dlv_scan_seed_kernel: the
// seed's uncompensated scan of one span (dlv_1d_seed, dlv_heap's
// scan="seed"), replacing repro/core/dlv.py::_dlv_scan_seed.
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
// row, whose var is 0; the caller clears cut 0), and a restart at
// (1, x, x*x).  The chain is serial, so one thread walks the span; it
// loads PF rows into registers ahead of the steps that use them.  What
// bounds it is that chain (a row's two divisions and FMA wait on the
// previous row's restart decision), not its 9 bytes a row.
//
// The rounding is the reference's as XLA compiles it for the CPU, where
// it was measured: s2 + x*x is a multiply and an add, each rounded, but
// s2/k - m*m is one fused multiply-add (at betas one ulp from a running
// variance the unfused form cuts elsewhere than the reference on about
// one span in nine; the fused one on none).  So the code spells out every
// operation as a round-to-nearest intrinsic (__dadd_rn, __dmul_rn,
// __ddiv_rn, and the one __fma_rn), which nvcc never contracts or splits
// whatever the flags (the file is also built with -fmad=false).
__global__ void dlv_scan_seed_kernel(const double* __restrict__ vals,
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
      const double x = xs[u];
      const double k1 = __dadd_rn(k, 1.0);
      const double s1n = __dadd_rn(s1, x);
      const double x2 = __dmul_rn(x, x);
      const double s2n = __dadd_rn(s2, x2);
      const double m = __ddiv_rn(s1n, k1);
      const double var = __fma_rn(-m, m, __ddiv_rn(s2n, k1));
      const bool cut = var > beta;
      cuts[i0 + u] = cut ? 1 : 0;
      k = cut ? 1.0 : k1;
      s1 = cut ? x : s1n;
      s2 = cut ? x2 : s2n;
    }
  }
}

extern "C" int dlv_scan_seed_f64(const void* vals, int64_t n, double beta,
                                 void* cuts, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  dlv_scan_seed_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const double*)vals, n, beta, (uint8_t*)cuts);
  return (int)cudaGetLastError();
}
