// The batched bound-variant LP engine for Hopper (sm_90a): a whole flight
// of revised-dual-simplex solves with the bound-flipping ratio test as ONE
// launch.
//
// Replaces repro/core/lp_batch.py::_batched_core (a jitted, vmapped
// lax.while_loop over the single twin's pivot pieces, repro/core/lp.py
// _refreshed, _init_pivot_state, _factor_refresh, _drift_gate,
// _optimal_suspect_gate, _pivot_core and _gather_solution).  The K lanes
// share (cf, A) and differ in bounds, tolerance and starting basis.  In
// the reference the lanes interact only through the shared pivot cap,
// so here each lane runs to its own end: it never waits on another
// lane, and the host imposes the cap by a trip limit (below).
//
// Each trip is the reference's batched loop body for one lane:
//   1. drift gate: max |Binv B - I| > DRIFT_TOL (on stale factors), or
//      since >= refactor_every, and the optimal-suspect gate (every row
//      feasible on stale factors) -> refresh: an m x m Gauss-Jordan
//      inverse with partial pivoting, then xB, y, d;
//   2. leaving row: the violation's argmax, or Bland's smallest basic
//      index; pricing alpha = rho @ A (rows added in order 0..m-1),
//      eligibility, ratio max(d / (s alpha), 0) as an order-preserving
//      64-bit key, flip cost |alpha| (u - l);
//   3. the BFRT select: eligible breakpoints in (ratio, index) order --
//      np.argsort(kind="stable")'s order -- their flip costs added one by
//      one from 0, exactly np.cumsum's running sum; q is the first to
//      reach |delta| - 1e-12, and every breakpoint before it flips;
//   4. the pivot: flip absorption xB -= Binv (A dxN), the basis exchange,
//      d -= theta alpha, y += theta rho, the Sherman-Morrison update of
//      Binv, and the anti-cycling and drift bookkeeping.
// At exit a lane with since > 0 is refreshed, and x, y, obj, the basis,
// the counters and the bound pattern are written to its out-pack row.
//
// Two paths, picked per flight from (m_pad, N) and the shared-memory
// budget (plan(), exported as lp_batch_plan):
//
// The warp path (m_pad <= 32 and N <= WARP_N_MAX: the B&B waves, the
// Dual Reducer's rungs): one warp a lane, up to WARP_LANES_MAX lanes a
// CTA, as many as their state fits.  A lane's state -- d, alpha, l/u,
// flags, its sorted runs, Binv, B = A[:, basis] (one column rewritten a
// pivot) and its row vectors -- lives in shared memory; (cf, A) is
// copied into shared memory once per CTA by a bulk asynchronous copy
// completed on an mbarrier (while the lanes load their rows), when it
// fits beside the lanes without costing one and N is even (the copy's
// 16-byte unit), else read from global memory (L2).  No block barrier
// after that copy: a lane's barriers are __syncwarp(), its reductions
// shuffles in a fixed order, and its scalars registers, equal in every
// thread of the warp.  Thread t owns columns t, t + 32, ... and row t.  The select is an ordered merge
// that stops at the crossing: each thread sorts its own eligible
// (ratio, index) keys (a run); the warp takes the least of the 32 run
// heads (three __reduce_min_sync) once a breakpoint and adds its flip
// cost to the running sum, and stops at the first key whose sum
// reaches the threshold; the flips are the runs' consumed prefixes.
// With no negative cost, a sum of every eligible cost that is certainly below
// the threshold ends the select with no crossing before any walk.  The
// keys and the running sums are the sequential walk's, so q, the flip
// set and the sum are.
//
// The CTA path (the rest: "wide" lanes of N > WARP_N_MAX, "tall" lanes
// of m_pad > 32): one CTA of 256 threads a lane.  Binv, xB, y and rho
// in shared memory up to m_pad = 32 rows (ROWS_SMEM_MAX), in a global
// workspace above; d, alpha, the keys, the flags and l/u in shared
// memory when N <= NS_MAX, else in the global workspace (l/u then read
// from the in pack); (cf, A) from global memory.  Row sums over the
// columns are accumulated 32 rows at a time in registers, so any m
// builds.  The select sorts the eligible breakpoints in shared memory
// (bitonic), at most CAPW a round: when more are eligible, a radix pass
// over the 96-bit (ratio, index) keys picks a boundary with at most CAPW
// keys below it, and the next round continues the walk above it; one
// thread walks each sorted round.
//
// The shared pivot cap: after T lockstep trips the reference has spent
// sum_k min(it_k, T) pivots, and a lane's trajectory is its own.  So the
// wrapper launches with trip_limit = max_iters; if the lanes' trips
// reach the cap it finds the least such T and launches once more with
// trip_limit = T (kernels/lp_batch.py::LaneSolver), which gives the
// lockstep loop's lanes exactly.
//
// Bound: operations (2 m N flops of pricing a trip), but a lane at the
// pivot loop's sizes (m ~ 2-20, N ~ 1e2-1e3) is latency-bound: its
// trip is a chain of dependent reductions, divisions and one select.
// The warp path makes each of them a warp operation (on the B&B
// flights the CTA path spends ~35 block barriers a trip, a quarter of
// its cycles in the bitonic sort; scripts/lp_batch_phase_cycles.py),
// keeps a lane's Gauss-Jordan inverse in registers (m_pad <= 16) and
// loads each batch of columns before it stores (the compiler may not
// move a load of one column above a store of another).  The CTA path's
// wide lanes walk N columns a few times a trip; its tall lanes do m^3
// work in the drift gate and the refresh.
// Built with -fmad=false, so the running sum and the cost products round
// as numpy's do.  Every sum has a fixed order, so a run is repeatable.
#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>
#include <limits.h>

typedef unsigned long long u64;

#define THREADS 256
#define NWARPS (THREADS / 32)
#define NS_MAX 2048          // N up to which per-column state is in shared
#define ROWS_SMEM_MAX 32     // m_pad up to which per-row state is in shared
#define CAPW 4096            // breakpoints one select round sorts
// N up to which a lane of m_pad <= 32 runs on one warp.  Measured on the
// main path's flights (scripts/lp_batch_layouts.py, H100) against the
// CTA path: 30% less time on the B&B (N = 164) and full-cell rung (100)
// flights, 8% less over the parity cell's 27 flights (N up to 516), and
// 17% more on the rung flight (308), whose optimal lanes walk ~150
// breakpoints a select (the merge's ~200 cycles a breakpoint against
// the CTA path's sort and one-thread walk); 256 would trade the parity
// flights' gain for the rung flight's, so the bound stays at 1,024
#ifndef WARP_N_MAX
#define WARP_N_MAX 1024
#endif
#ifndef WARP_LANES_MAX
#define WARP_LANES_MAX 4     // lanes (warps) a CTA of the warp path holds
#endif
#ifndef STAGE_CF_A
#define STAGE_CF_A 1         // the warp path may stage (cf, A) in shared
#endif
// the warp path's Gauss-Jordan inverse in registers for m_pad <= 16 (else
// in shared memory, as at m_pad 32), and its runs of <= 8 keys sorted by
// a network in registers (else by insertion): compile-time switches so
// that scripts/lp_batch_layouts.py can time each against the general one
#ifndef WARP_INVERT_REGS
#define WARP_INVERT_REGS 1
#endif
#ifndef WARP_SORT_NET
#define WARP_SORT_NET 1
#endif
// the dynamic shared memory a CTA may take: 227 KB less 2 KB for the
// kernels' static shared memory
#define SMEM_BUDGET (227 * 1024 - 2048)
static_assert(WARP_N_MAX <= 65535 && WARP_N_MAX <= NS_MAX,
              "the warp path keeps column indices in 16 bits");
#define FULL 0xffffffffu
#define KEY_NONE 0xffffffffffffffffull   // an ineligible column's key
#define KEY_NAN (KEY_NONE - 1)           // a NaN ratio: after +inf, as numpy

#define OPTIMAL 0
#define ITER_LIMIT 1
#define INFEASIBLE 2
// repro_torch/core/guard.py
#define DRIFT_TOL 1e-6
#define STALL_REFACTOR 12
#define STALL_BLAND 24
#define THETA_EPS 1e-12

#define F_BASIC 1            // flag bits of a column
#define F_UPPER 2

// The phases of a trip.  scripts/lp_batch_phase_cycles.py builds a copy
// with PROBE defined, whose hooks add the clock64() cycles since the last
// hook to the phase that ends there; in this build they are empty.
enum { PH_GATES, PH_REFRESH, PH_LEAVE, PH_PRICE, PH_COLLECT, PH_SORT,
       PH_WALK, PH_FLIPS, PH_PIVOT, PH_OUT, NPH };
#ifndef PROBE
#define PROBE_INIT()
#define PROBE_CTA(ph)
#define PROBE_WARP(ph)
#define PROBE_END(path, trips)
#endif

struct Sc {                  // a lane's scalars
  double tol, delta, s, rmin, thr, wr, theta, t, xq, base;
  u64 kq_hi, lo_hi, up_hi, pre_hi;
  unsigned kq_lo, lo_lo, up_lo, pre_lo;
  int status, it, since, stall, bland, n_bland, n_drift;
  int r, q, leave, above, done, need, k_elig, has_cross, do_pivot;
  int unsafe, no_pivot, stale, piv, cnt, consumed, found, has_lo, all;
  int stop, cap;
};

__device__ __forceinline__ u64 order_bits(double r) {
  // numpy sorts every NaN last, and a NaN's bits would collide with
  // KEY_NONE: every NaN gets KEY_NAN, the NaNs tie and go by index
  if (isnan(r)) return KEY_NAN;
  // -0 -> +0 first: the two compare equal, so they tie, by index
  const long long b = __double_as_longlong(__dadd_rn(r, 0.0));
  return b < 0 ? ~(u64)b : ((u64)b | 0x8000000000000000ull);
}

__device__ __forceinline__ double ratio_of(u64 k) {   // k of a ratio >= 0
  return (k >> 63) ? __longlong_as_double((long long)(k & ~(1ull << 63)))
                   : __longlong_as_double((long long)~k);
}

// jnp.maximum / jnp.max: NaN wins
__device__ __forceinline__ double maxn(double a, double b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return a > b ? a : b;
}
__device__ __forceinline__ double minn(double a, double b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return a < b ? a : b;
}

// (hi, lo) < (hi2, lo2)
__device__ __forceinline__ bool key_lt(u64 h, unsigned l, u64 h2,
                                       unsigned l2) {
  return h < h2 || (h == h2 && l < l2);
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Block reductions: every thread gets the result.  Sums add the warps in
// warp order; the leading barrier protects the scratch of the last call.
__device__ double block_sum(double v, double* red) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
  for (int i = 0; i < NWARPS; ++i) s += red[i];
  return s;
}

__device__ double block_maxn(double v, double* red) {
  for (int o = 16; o > 0; o >>= 1) v = maxn(v, __shfl_xor_sync(FULL, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = red[0];
  for (int i = 1; i < NWARPS; ++i) s = maxn(s, red[i]);
  return s;
}

__device__ double block_minn(double v, double* red) {
  for (int o = 16; o > 0; o >>= 1) v = minn(v, __shfl_xor_sync(FULL, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = red[0];
  for (int i = 1; i < NWARPS; ++i) s = minn(s, red[i]);
  return s;
}

__device__ int block_sum_int(int v, int* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
  for (int i = 0; i < NWARPS; ++i) s += red[i];
  return s;
}

__device__ int block_min_int(int v, int* red) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(FULL, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = red[0];
  for (int i = 1; i < NWARPS; ++i) s = min(s, red[i]);
  return s;
}

// out[i] = sum over the block of part[i], i < M (warps added in order)
template <int M>
__device__ void block_vec_sum(double (&part)[M], double* vred,
                              double* out) {
#pragma unroll
  for (int i = 0; i < M; ++i) part[i] = warp_sum(part[i]);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int i = 0; i < M; ++i) vred[(threadIdx.x >> 5) * M + i] = part[i];
  }
  __syncthreads();
  if (threadIdx.x < M) {
    double s = 0.0;
    for (int w = 0; w < NWARPS; ++w) s += vred[w * M + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// digit L (0..11, most significant first) of the 96-bit key (hi, lo)
__device__ __forceinline__ unsigned key_digit(u64 h, unsigned l, int L) {
  return L < 8 ? (unsigned)((h >> (56 - 8 * L)) & 0xff)
               : (l >> (24 - 8 * (L - 8))) & 0xff;
}

// the top 8 L bits of (h, l) and of (ph, pl) agree
__device__ __forceinline__ bool key_prefix(u64 h, unsigned l, u64 ph,
                                           unsigned pl, int L) {
  if (L == 0) return true;
  if (L <= 8) return (h >> (64 - 8 * L)) == (ph >> (64 - 8 * L));
  if (h != ph) return false;
  if (L >= 12) return l == pl;
  return (l >> (32 - 8 * (L - 8))) == (pl >> (32 - 8 * (L - 8)));
}

// (ph, pl) with digit L set to d and, if ones, every lower bit set
__device__ __forceinline__ void key_set(u64& ph, unsigned& pl, int L,
                                        unsigned d, bool ones) {
  if (L < 8) {
    const int sh = 56 - 8 * L;
    ph = (ph & ~(0xffull << sh)) | ((u64)d << sh);
    if (ones) {
      if (sh > 0) ph |= (1ull << sh) - 1;
      pl = 0xffffffffu;
    }
  } else {
    const int sh = 24 - 8 * (L - 8);
    pl = (pl & ~(0xffu << sh)) | (d << sh);
    if (ones && sh > 0) pl |= (1u << sh) - 1;
  }
}

// M: the lane's rows m_pad when it is at most ROWS_SMEM_MAX, else 0 and
// the rows are m_rt (a power of two above 32).  Row sums over the columns
// are kept in registers MR rows at a time.
template <int M>
struct Lane {
  static constexpr int MR = M ? M : ROWS_SMEM_MAX;
  int m_rt;
  const double* __restrict__ cf;
  const double* __restrict__ A;
  int N;
  int refactor_every;
  // per column (shared or global)
  double* d;
  double* al;
  u64* rk;
  unsigned char* fl;
  const double* lo;
  const double* up;
  // per row (shared, or global above ROWS_SMEM_MAX)
  double* Binv;      // m x m
  double* aug;       // 2 x (m x 2m), ping-pong
  double* xB;
  double* y;
  double* rho;
  double* w;
  double* vec;
  int* basis;        // m
  // block scratch (shared)
  double* vred;      // NWARPS x MR
  double* redd;      // NWARPS
  int* redi;         // NWARPS
  int* hist;         // 256
  u64* sh;           // sort keys
  unsigned* sl;      // sort indices
  int sort_cap;
  Sc* sc;

  __device__ __forceinline__ int rows() const { return M ? M : m_rt; }

  __device__ double Aij(int i, int j) const {
    return A[(int64_t)i * N + j];
  }

  // out[i] = sum over the columns j with wt(j, x) of A[i][j] x, i < m:
  // each thread adds its columns in order, then the warps in order
  template <class W>
  __device__ void a_times(W wt, double* out) {
    const int m = rows();
    for (int c0 = 0; c0 < m; c0 += MR) {
      double part[MR];
#pragma unroll
      for (int i = 0; i < MR; ++i) part[i] = 0.0;
      for (int j = threadIdx.x; j < N; j += THREADS) {
        double x;
        if (!wt(j, x)) continue;
#pragma unroll
        for (int i = 0; i < MR; ++i) part[i] += Aij(c0 + i, j) * x;
      }
      block_vec_sum<MR>(part, vred, out + c0);
    }
  }

  // Binv, xB, y, d from the basis (repro/core/lp.py::_refreshed)
  __device__ void refresh() {
    const int tid = threadIdx.x, m = rows(), w2 = 2 * m;
    double* cur = aug;
    double* nxt = aug + (int64_t)m * w2;
    for (int e = tid; e < m * w2; e += THREADS) {
      const int i = e / w2, c = e % w2;
      cur[e] = c < m ? Aij(i, basis[c]) : (c - m == i ? 1.0 : 0.0);
    }
    __syncthreads();
    for (int c = 0; c < m; ++c) {
      if (tid == 0) {          // partial pivoting: the first largest |.|
        int p = c;
        double best = fabs(cur[c * w2 + c]);
        for (int r = c + 1; r < m; ++r) {
          const double v = fabs(cur[r * w2 + c]);
          if (v > best) { best = v; p = r; }
        }
        sc->piv = p;
      }
      __syncthreads();
      const int p = sc->piv;
      const double pv = cur[p * w2 + c];
      for (int e = tid; e < m * w2; e += THREADS) {
        const int r = e / w2, col = e % w2;
        const double rowc = cur[p * w2 + col] / pv;      // new row c
        const int sr = r == c ? p : (r == p ? c : r);    // rows c, p swap
        nxt[e] = r == c ? rowc : cur[sr * w2 + col] - cur[sr * w2 + c] * rowc;
      }
      __syncthreads();
      double* t = cur; cur = nxt; nxt = t;
    }
    for (int e = tid; e < m * m; e += THREADS)
      Binv[e] = cur[(e / m) * w2 + m + e % m];
    // A @ xN over the nonbasic columns
    a_times([&](int j, double& x) {
      const unsigned char f = fl[j];
      if (f & F_BASIC) return false;
      x = (f & F_UPPER) ? up[j] : lo[j];
      return true;
    }, vec);
    for (int i = tid; i < m; i += THREADS) {
      double s = 0.0, t = 0.0;
      for (int k = 0; k < m; ++k) {
        s += Binv[i * m + k] * vec[k];
        t += Binv[k * m + i] * cf[basis[k]];
      }
      xB[i] = -s;
      y[i] = t;
    }
    __syncthreads();
    for (int j = tid; j < N; j += THREADS) {
      if (fl[j] & F_BASIC) { d[j] = 0.0; continue; }
      double s = 0.0;
#pragma unroll
      for (int i = 0; i < m; ++i) s += Aij(i, j) * y[i];
      d[j] = cf[j] - s;
    }
    if (tid == 0) sc->since = 0;
    __syncthreads();
  }

  __device__ bool in_range(u64 h, unsigned j) const {
    if (sc->has_lo && !key_lt(sc->lo_hi, sc->lo_lo, h, j)) return false;
    return sc->all || !key_lt(sc->up_hi, sc->up_lo, h, j);
  }

  // a boundary (up_hi, up_lo) with 1..CAPW eligible keys in (lo, up]
  __device__ void radix_boundary() {
    const int tid = threadIdx.x;
    if (tid == 0) {
      sc->pre_hi = 0; sc->pre_lo = 0; sc->cap = sort_cap; sc->stop = 0;
      sc->all = 1;                 // in_range() without an upper end
    }
    __syncthreads();
    for (int L = 0; L < 12; ++L) {
      for (int b = tid; b < 256; b += THREADS) hist[b] = 0;
      __syncthreads();
      const u64 ph = sc->pre_hi;
      const unsigned pl = sc->pre_lo;
      for (int j = tid; j < N; j += THREADS) {
        const u64 h = rk[j];
        if (h == KEY_NONE || !in_range(h, j)) continue;
        if (!key_prefix(h, j, ph, pl, L)) continue;
        atomicAdd(&hist[key_digit(h, j, L)], 1);
      }
      __syncthreads();
      if (tid == 0) {
        int cum = 0, dd = -1;
        for (int b = 0; b < 256; ++b) {
          if (cum + hist[b] > sc->cap) { dd = b; break; }
          cum += hist[b];
        }
        u64 h = ph;
        unsigned l = pl;
        if (dd < 0) {               // every key of the prefix fits
          key_set(h, l, L, 255, true);
          sc->stop = 1;
        } else if (cum > 0) {       // the digits below dd fit
          key_set(h, l, L, (unsigned)(dd - 1), true);
          sc->stop = 1;
        } else {                    // descend into digit dd
          key_set(h, l, L, (unsigned)dd, false);
        }
        if (sc->stop) { sc->up_hi = h; sc->up_lo = l; }
        else { sc->pre_hi = h; sc->pre_lo = l; }
      }
      __syncthreads();
      if (sc->stop) break;
    }
    if (tid == 0) sc->all = 0;
    __syncthreads();
  }

  __device__ void bitonic(int P) {
    for (int k = 2; k <= P; k <<= 1) {
      for (int jj = k >> 1; jj > 0; jj >>= 1) {
        for (int i = threadIdx.x; i < P; i += THREADS) {
          const int ixj = i ^ jj;
          if (ixj > i) {
            const bool asc = (i & k) == 0;
            const u64 a = sh[i], b = sh[ixj];
            const unsigned la = sl[i], lb = sl[ixj];
            const bool gt = key_lt(b, lb, a, la);
            if (asc == gt) {
              sh[i] = b; sh[ixj] = a; sl[i] = lb; sl[ixj] = la;
            }
          }
        }
        __syncthreads();
      }
    }
  }

  // the BFRT select (np.argsort stable + np.cumsum + searchsorted left)
  __device__ void select() {
    const int tid = threadIdx.x;
    if (tid == 0) {
      sc->thr = fabs(sc->delta) - 1e-12;
      sc->base = 0.0; sc->found = 0; sc->consumed = 0; sc->has_lo = 0;
    }
    __syncthreads();
    while (!sc->found && sc->consumed < sc->k_elig) {
      if (sc->k_elig - sc->consumed <= sort_cap) {
        if (tid == 0) sc->all = 1;
        __syncthreads();
      } else {
        radix_boundary();
      }
      if (tid == 0) sc->cnt = 0;
      __syncthreads();
      for (int j = tid; j < N; j += THREADS) {
        const u64 h = rk[j];
        if (h == KEY_NONE || !in_range(h, j)) continue;
        const int pos = atomicAdd(&sc->cnt, 1);
        sh[pos] = h;
        sl[pos] = (unsigned)j;
      }
      __syncthreads();
      const int c = sc->cnt;
      int P = 1;
      while (P < c) P <<= 1;
      for (int i = c + tid; i < P; i += THREADS) {
        sh[i] = KEY_NONE; sl[i] = 0xffffffffu;
      }
      __syncthreads();
      PROBE_CTA(PH_COLLECT);
      bitonic(P);
      PROBE_CTA(PH_SORT);
      if (tid == 0) {
        // every eligible key is below KEY_NONE, so a round that collects
        // none has lost count: stop the card rather than spin
        if (c == 0) __trap();
        double base = sc->base;
        for (int i = 0; i < c; ++i) {
          const int j = (int)sl[i];
          base += fabs(al[j]) * (up[j] - lo[j]);
          if (base >= sc->thr) {
            sc->found = 1; sc->q = j; sc->kq_hi = sh[i]; sc->kq_lo = sl[i];
            break;
          }
        }
        sc->base = base;
        sc->consumed += c;
        sc->has_lo = 1; sc->lo_hi = sh[c - 1]; sc->lo_lo = sl[c - 1];
        sc->all = 0;
      }
      __syncthreads();
      PROBE_CTA(PH_WALK);
    }
    if (tid == 0) sc->has_cross = sc->found;
    __syncthreads();
  }

  // one trip of the reference's batched loop body for this lane
  __device__ void trip() {
    const int tid = threadIdx.x, m = rows();
    PROBE_CTA(PH_OUT);
    // ---- drift gate (repro/core/lp.py::_drift_gate)
    double res = 0.0;
    for (int e = tid; e < m * m; e += THREADS) {
      const int i = e / m, j = e % m;
      double s = 0.0;
      for (int k = 0; k < m; ++k) s += Binv[i * m + k] * Aij(k, basis[j]);
      res = maxn(res, fabs(s - (i == j ? 1.0 : 0.0)));
    }
    res = block_maxn(res, redd);
    if (tid == 0) {
      const int drift = res > DRIFT_TOL && sc->since > 0;
      sc->n_drift += drift;
      int need = drift || sc->since >= refactor_every;
      // optimal-suspect gate (_optimal_suspect_gate)
      double vmax = 0.0;
      for (int i = 0; i < m; ++i) {
        const int b = basis[i];
        const double v = maxn(lo[b] - xB[i], xB[i] - up[b]);
        vmax = i == 0 ? v : maxn(vmax, v);
      }
      need = need || (vmax <= sc->tol && sc->since > 0);
      sc->need = need;
    }
    __syncthreads();
    PROBE_CTA(PH_GATES);
    if (sc->need) refresh();
    PROBE_CTA(PH_REFRESH);
    // ---- the leaving row (_pivot_core)
    if (tid == 0) {
      int rmax = 0, rbl = 0, bmin = INT_MAX;
      double best = 0.0;
      for (int i = 0; i < m; ++i) {
        const int b = basis[i];
        const double v = maxn(lo[b] - xB[i], xB[i] - up[b]);
        if (i == 0 || (!isnan(best) && (isnan(v) || v > best))) {
          best = v; rmax = i;
        }
        const int key = v > sc->tol ? b : N;
        if (key < bmin) { bmin = key; rbl = i; }
      }
      sc->done = best <= sc->tol;
      const int r = sc->bland ? rbl : rmax;
      const int b = basis[r];
      const double vlo = lo[b] - xB[r], vhi = xB[r] - up[b];
      sc->r = r;
      sc->above = vhi >= vlo;
      sc->delta = sc->above ? xB[r] - up[b] : xB[r] - lo[b];
      sc->s = sc->delta > 0 ? 1.0 : -1.0;
      sc->stale = sc->since > 0;
      sc->has_cross = 0;
      sc->unsafe = 0;
      sc->k_elig = 0;
    }
    __syncthreads();
    if (!sc->done) {
      for (int i = tid; i < m; i += THREADS) rho[i] = Binv[sc->r * m + i];
      __syncthreads();
      PROBE_CTA(PH_LEAVE);
      // ---- pricing, eligibility, ratio keys
      const double s = sc->s, tol = sc->tol;
      int cnt = 0;
      double rmin = INFINITY;
      for (int j = tid; j < N; j += THREADS) {
        double a = 0.0;
#pragma unroll
        for (int i = 0; i < m; ++i) a += rho[i] * Aij(i, j);
        al[j] = a;
        const double sa = s * a;
        const unsigned char f = fl[j];
        const bool atu = f & F_UPPER;
        const bool elig = !(f & F_BASIC) &&
                          ((!atu && sa > tol) || (atu && sa < -tol));
        if (elig) {
          const double den = fabs(sa) > tol ? sa : 1.0;
          const double r = maxn(d[j] / den, 0.0);
          rk[j] = order_bits(r);
          rmin = minn(rmin, r);
          ++cnt;
        } else {
          rk[j] = KEY_NONE;
        }
      }
      cnt = block_sum_int(cnt, redi);
      rmin = block_minn(rmin, redd);
      if (tid == 0) { sc->k_elig = cnt; sc->rmin = rmin; }
      __syncthreads();
      PROBE_CTA(PH_PRICE);
      if (cnt > 0) {
        if (sc->bland) {
          // Bland: the smallest-index min-ratio column, no flips
          int qb = INT_MAX;
          for (int j = tid; j < N; j += THREADS) {
            const u64 h = rk[j];
            if (h != KEY_NONE && ratio_of(h) <= rmin + 1e-12) {
              qb = j;
              break;
            }
          }
          qb = block_min_int(qb, redi);
          if (qb == INT_MAX) qb = 0;    // a NaN minimum: argmax of none
          if (tid == 0) {
            sc->q = qb; sc->has_cross = 1;
            sc->kq_hi = rk[qb]; sc->kq_lo = (unsigned)qb;
          }
          __syncthreads();
          PROBE_CTA(PH_WALK);
        } else {
          select();
        }
      }
      if (sc->has_cross) {
        for (int i = tid; i < m; i += THREADS) {
          double s2 = 0.0;
          for (int k = 0; k < m; ++k) s2 += Binv[i * m + k] * Aij(k, sc->q);
          w[i] = s2;
        }
        __syncthreads();
      }
    }
    if (tid == 0) {
      sc->no_pivot = sc->k_elig == 0 || !sc->has_cross;
      if (!sc->done && sc->has_cross) {
        sc->wr = w[sc->r];
        sc->unsafe = fabs(sc->wr) < 1e-11;
      }
      sc->status = sc->done ? OPTIMAL
                   : (sc->no_pivot && !sc->stale ? INFEASIBLE : ITER_LIMIT);
      sc->do_pivot = sc->status == ITER_LIMIT && !sc->no_pivot
                     && !sc->unsafe;
    }
    __syncthreads();
    if (sc->do_pivot) {
      // ---- flip absorption: xB -= Binv (A dxN) over the flipped columns
      // (with no flips the sums are 0 and xB is kept exactly)
      if (!sc->bland) {
        const u64 qh = sc->kq_hi;
        const unsigned ql = sc->kq_lo;
        // the reference flips ratio < ratio_q, or == ratio_q at a smaller
        // index: nothing when ratio_q is NaN, and never a NaN ratio
        auto flips = [&](int j) {
          const u64 h = rk[j];
          return qh != KEY_NAN && h != KEY_NONE
                 && key_lt(h, (unsigned)j, qh, ql);
        };
        a_times([&](int j, double& x) {
          if (!flips(j)) return false;
          x = (fl[j] & F_UPPER) ? lo[j] - up[j] : up[j] - lo[j];
          return true;
        }, vec);
        for (int i = tid; i < m; i += THREADS) {
          double s = 0.0;
          for (int k = 0; k < m; ++k) s += Binv[i * m + k] * vec[k];
          xB[i] = xB[i] - s;
        }
        for (int j = tid; j < N; j += THREADS)
          if (flips(j)) fl[j] ^= F_UPPER;
        __syncthreads();
        PROBE_CTA(PH_FLIPS);
      }
      if (tid == 0) {
        const int r = sc->r, q = sc->q, b = basis[r];
        sc->leave = b;
        const double target = sc->above ? up[b] : lo[b];
        sc->t = (xB[r] - target) / sc->wr;
        sc->xq = (fl[q] & F_UPPER) ? up[q] : lo[q];
        sc->theta = d[q] / sc->wr;
      }
      __syncthreads();
      const int r = sc->r, q = sc->q, leave = sc->leave;
      const double t = sc->t, theta = sc->theta, wr = sc->wr;
      for (int i = tid; i < m; i += THREADS) {
        xB[i] = i == r ? sc->xq + t : xB[i] - t * w[i];
        y[i] = y[i] + theta * rho[i];
      }
      for (int e = tid; e < m * m; e += THREADS) {
        const int i = e / m, jc = e % m;
        const double br = rho[jc] / wr;
        Binv[e] = i == r ? br : Binv[e] - w[i] * br;
      }
      for (int j = tid; j < N; j += THREADS)
        d[j] = j == leave ? -theta : (j == q ? 0.0 : d[j] - theta * al[j]);
      __syncthreads();
      if (tid == 0) {
        fl[q] = F_BASIC;
        fl[leave] = sc->above ? F_UPPER : 0;
        basis[r] = q;
      }
    }
    if (tid == 0) {
      // ---- since, anti-cycling (degenerate streaks), counters
      const int dp = sc->do_pivot;
      if (dp) sc->since += 1;
      else if ((sc->no_pivot || sc->unsafe) && sc->stale)
        sc->since = refactor_every;
      const double at = fabs(sc->theta);
      const int degen = dp && at <= THETA_EPS;
      const int progress = dp && at > THETA_EPS;
      sc->n_bland += sc->bland && dp;
      sc->stall = progress ? 0 : (degen ? sc->stall + 1 : sc->stall);
      sc->bland = progress ? 0 : (sc->bland || sc->stall >= STALL_BLAND);
      if (degen && sc->stall == STALL_REFACTOR)
        sc->since = refactor_every;
      sc->it += 1;
    }
    __syncthreads();
    PROBE_CTA(PH_PIVOT);
  }
};

// a lane's per-row state in the global workspace (above ROWS_SMEM_MAX):
// Binv, the Gauss-Jordan ping-pong, xB, y, rho, w, vec (doubles), basis
__host__ __device__ inline int64_t row_bytes(int64_t m) {
  return (8 * (5 * m * m + 5 * m) + 4 * m + 15) & ~(int64_t)15;
}

// its per-column state there (above NS_MAX): d, alpha, keys (8 bytes a
// column each) and flags (1)
__host__ __device__ inline int64_t col_bytes(int64_t N) {
  return (25 * N + 15) & ~(int64_t)15;
}

// a lane's global workspace: the rows, then the columns, each only when
// it does not fit in shared memory
__host__ __device__ inline int64_t ws_lane_bytes(int64_t m, int64_t N) {
  return (m <= ROWS_SMEM_MAX ? 0 : row_bytes(m))
       + (N <= NS_MAX ? 0 : col_bytes(N));
}

// the row arrays at p (doubles, then the basis' ints)
template <int M>
__device__ void place_rows(Lane<M>& ln, double* p) {
  const int m = ln.rows();
  ln.Binv = p; p += m * m;
  ln.aug = p; p += 4 * m * m;
  ln.xB = p; p += m;
  ln.y = p; p += m;
  ln.rho = p; p += m;
  ln.w = p; p += m;
  ln.vec = p; p += m;
  ln.basis = (int*)p;
}

template <int M>
__global__ void __launch_bounds__(THREADS, 1)
lp_batch_kernel(const double* __restrict__ cf, const double* __restrict__ A,
                const double* __restrict__ in_pack,
                double* __restrict__ out_pack, unsigned char* ws, int m_rt,
                int N, int max_iters, int trip_limit, int refactor_every) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Sc sc;
  const int tid = threadIdx.x;
  const int m = M ? M : m_rt;
  const int64_t win = 3 * (int64_t)N + m + 3;
  const int64_t wout = 2 * (int64_t)N + 2 * m + 6;
  const double* row = in_pack + blockIdx.x * win;
  double* orow = out_pack + blockIdx.x * wout;
  PROBE_INIT();
  if (row[3 * N + 1 + m] == 0.0) {          // padded or decided on the host
    for (int64_t e = tid; e < wout; e += THREADS) orow[e] = 0.0;
    return;
  }
  const bool shared_cols = N <= NS_MAX;
  int P = 1;
  while (P < (shared_cols ? N : CAPW)) P <<= 1;
  unsigned char* base = ws + blockIdx.x * ws_lane_bytes(m, N);

  Lane<M> ln;
  ln.m_rt = m_rt;
  ln.cf = cf; ln.A = A; ln.N = N; ln.refactor_every = refactor_every;
  ln.sc = &sc;
  ln.sort_cap = shared_cols ? P : CAPW;
  double* p = (double*)smem;
  if (M) {
    place_rows(ln, p);
    p += 5 * m * m + 5 * m + (m + 1) / 2;     // the basis' ints, 8-aligned
  } else {
    place_rows(ln, (double*)base);
    base += row_bytes(m);
  }
  ln.vred = p; p += NWARPS * Lane<M>::MR;
  ln.redd = p; p += NWARPS;
  u64* pk = (u64*)p;
  ln.sh = pk; pk += P;
  if (shared_cols) {
    double* lo_s = (double*)pk;
    double* up_s = lo_s + N;
    ln.d = up_s + N;
    ln.al = ln.d + N;
    ln.rk = (u64*)(ln.al + N);
    pk = ln.rk + N;
    for (int j = tid; j < N; j += THREADS) {
      lo_s[j] = row[j];
      up_s[j] = row[N + j];
    }
    ln.lo = lo_s;
    ln.up = up_s;
  } else {
    ln.d = (double*)base;
    ln.al = ln.d + N;
    ln.rk = (u64*)(ln.al + N);
    ln.fl = (unsigned char*)(ln.rk + N);
    ln.lo = row;
    ln.up = row + N;
  }
  int* pi = (int*)pk;
  ln.redi = pi; pi += NWARPS;
  ln.hist = pi; pi += 256;
  ln.sl = (unsigned*)pi; pi += P;
  if (shared_cols) ln.fl = (unsigned char*)pi;

  // ---- initial state (_init_pivot_state), then the eager refresh
  for (int j = tid; j < N; j += THREADS)
    ln.fl[j] = row[2 * N + 1 + m + j] != 0.0 ? F_UPPER : 0;
  for (int i = tid; i < m; i += THREADS)
    ln.basis[i] = (int)row[2 * N + 1 + i];
  if (tid == 0) {
    sc.tol = row[2 * N];
    sc.status = ITER_LIMIT; sc.it = 0; sc.since = refactor_every;
    sc.stall = 0; sc.bland = 0; sc.n_bland = 0; sc.n_drift = 0;
    sc.theta = 0.0;
  }
  __syncthreads();
  for (int i = tid; i < m; i += THREADS)           // at_upper0 & ~in_basis
    ln.fl[ln.basis[i]] = F_BASIC;
  __syncthreads();
  ln.refresh();

  const int lim = min(max_iters, trip_limit);
  while (sc.status == ITER_LIMIT && sc.it < lim) ln.trip();
  if (sc.since > 0) ln.refresh();                  // the exit refactorization

  // ---- _gather_solution and the out pack
  double objp = 0.0;
  for (int j = tid; j < N; j += THREADS) {
    const unsigned char f = ln.fl[j];
    double x;
    if (f & F_BASIC) {
      int pos = 0;
      for (int i = 0; i < m; ++i) if (ln.basis[i] == j) { pos = i; break; }
      x = ln.xB[pos];
    } else {
      x = (f & F_UPPER) ? ln.up[j] : ln.lo[j];
    }
    orow[j] = x;
    objp += cf[j] * (isfinite(x) ? x : 0.0);
    orow[N + 2 * m + 5 + j] = (f & F_UPPER) ? 1.0 : 0.0;
  }
  const double obj = block_sum(objp, ln.redd);
  for (int i = tid; i < m; i += THREADS) {
    orow[N + i] = ln.y[i];
    orow[N + m + 1 + i] = (double)ln.basis[i];
  }
  if (tid == 0) {
    orow[N + m] = obj;
    orow[N + 2 * m + 1] = sc.status;
    orow[N + 2 * m + 2] = sc.it;
    orow[N + 2 * m + 3] = sc.n_bland;
    orow[N + 2 * m + 4] = sc.n_drift;
    orow[2 * N + 2 * m + 5] = 0.0;     // spent: the wrapper's
  }
  PROBE_CTA(PH_OUT);
  PROBE_END(0, sc.it);
}

static size_t smem_bytes(int M, int MR, int64_t N) {
  const bool shared_cols = N <= NS_MAX;
  int64_t P = 1;
  while (P < (shared_cols ? N : CAPW)) P <<= 1;
  size_t b = 8 * (size_t)(NWARPS * MR + NWARPS);   // block scratch
  if (M) b += 8 * (size_t)(5 * M * M + 5 * M + (M + 1) / 2);   // rows
  b += 8 * (size_t)P;                              // sort keys
  if (shared_cols) b += 8 * 5 * (size_t)N;         // lo, up, d, al, rk
  b += 4 * (size_t)(NWARPS + 256 + P);             // ints, sort indices
  if (shared_cols) b += (size_t)N;                 // flags
  return b;
}

template <int M>
static int launch(const double* cf, const double* A, const double* in_pack,
                  double* out_pack, unsigned char* ws, int64_t m,
                  int64_t N, int64_t K_pad, int64_t max_iters,
                  int64_t trip_limit, int64_t refactor_every,
                  cudaStream_t st) {
  const size_t smem = smem_bytes(M, Lane<M>::MR, N);
  cudaError_t e = cudaFuncSetAttribute(
      lp_batch_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  lp_batch_kernel<M><<<(unsigned)K_pad, THREADS, smem, st>>>(
      cf, A, in_pack, out_pack, ws, (int)m, (int)N, (int)max_iters,
      (int)trip_limit, (int)refactor_every);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ the warp path

__device__ __forceinline__ double warp_maxn(double v) {
  for (int o = 16; o > 0; o >>= 1) v = maxn(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ double warp_minn(double v) {
  for (int o = 16; o > 0; o >>= 1) v = minn(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// the least (key, idx) over the warp, in every thread: three
// __reduce_min_sync, the key's high and low words, then the index
__device__ __forceinline__ void warp_argmin(u64 key, unsigned idx, u64& kmin,
                                            unsigned& imin) {
  const unsigned hi = (unsigned)(key >> 32), lo = (unsigned)key;
  const unsigned m1 = __reduce_min_sync(FULL, hi);
  const bool c1 = hi == m1;
  const unsigned m2 = __reduce_min_sync(FULL, c1 ? lo : 0xffffffffu);
  const bool c2 = c1 && lo == m2;
  imin = __reduce_min_sync(FULL, c2 ? idx : 0xffffffffu);
  kmin = ((u64)m1 << 32) | m2;
}

// a key whose least value is the largest v, NaN before any number
// (jnp.argmax's rule, with the first index among ties)
__device__ __forceinline__ u64 max_first_key(double v) {
  return isnan(v) ? 0ull : ~order_bits(v);
}

// a lane's shared state on the warp path: the doubles (Binv, the
// Gauss-Jordan ping-pong, B, xB, y, rho, w; l, u, d, alpha; the run
// keys), the basis' ints, the run columns, the flags
__host__ __device__ inline int run_slots(int64_t N) {
  return (int)(32 * ((N + 31) / 32));
}
__host__ __device__ inline int64_t warp_lane_bytes(int64_t m, int64_t N) {
  const int64_t S = run_slots(N);
  return (8 * (6 * m * m + 4 * m + 4 * N + S) + 4 * m + 2 * S + N + 15)
         & ~(int64_t)15;
}
__host__ __device__ inline int64_t staged_bytes(int64_t m, int64_t N) {
  return 16 + ((8 * N + 15) & ~(int64_t)15) + 8 * m * N;  // mbarrier, cf, A
}

struct Plan {
  int warp;        // 1: the warp path
  int lanes;       // lanes a CTA
  int staged;      // (cf, A) copied into shared memory
  int64_t smem;    // dynamic shared memory a CTA
};

// The path of a flight.  Lanes of m_pad <= 32 and N <= WARP_N_MAX run one
// warp each, as many a CTA as fit the budget (at most WARP_LANES_MAX and
// K_pad); (cf, A) is staged when it fits beside that many lanes (staging
// never costs a lane) and its rows are whole 16-byte units (N even: the
// bulk copy's unit; the engine's N = n_pad + m_pad always is), else read
// from global memory.
static Plan plan(int64_t m_pad, int64_t N, int64_t K_pad) {
  Plan p = {0, 1, 0, 0};
  if (m_pad > ROWS_SMEM_MAX || N > WARP_N_MAX) return p;
  const int64_t lane = warp_lane_bytes(m_pad, N);
  const int64_t want = K_pad < WARP_LANES_MAX ? K_pad : WARP_LANES_MAX;
  int64_t fit = SMEM_BUDGET / lane;
  if (fit < 1) return p;
  if (fit > want) fit = want;
  const int64_t st = staged_bytes(m_pad, N);
  p.warp = 1;
  p.lanes = (int)fit;
  p.staged = STAGE_CF_A && N % 2 == 0 && st + fit * lane <= SMEM_BUDGET;
  p.smem = (p.staged ? st : 0) + fit * lane;
  return p;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// (cf, A) into shared memory: one bulk asynchronous copy each, completed
// on an mbarrier that stage_wait() waits for.  The plan stages only whole
// 16-byte units, and the host entry only 16-byte aligned cf and A.  Every
// thread of the CTA calls it.
__device__ void stage_issue(const double* cf, const double* A, double* cf_s,
                            double* A_s, uint64_t* bar, int m, int N) {
  const uint32_t cb = 8u * (uint32_t)N, ab = 8u * (uint32_t)(m * N);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_u32(bar)), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_u32(bar)), "r"(cb + ab) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        :: "r"(smem_u32(cf_s)), "l"((uint64_t)cf), "r"(cb),
           "r"(smem_u32(bar))
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        :: "r"(smem_u32(A_s)), "l"((uint64_t)A), "r"(ab),
           "r"(smem_u32(bar))
        : "memory");
  }
}

__device__ void stage_wait(uint64_t* bar) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(0) : "memory");
    if (!done && tries == (1u << 26)) __trap();   // a lost copy: fail
  }
}

// One lane on one warp (M = m_pad <= 32).  Every thread holds the lane's
// scalars; thread t owns columns t, t + 32, ... and row t (t < M).
template <int M>
struct WLane {
  const double* __restrict__ cf;     // shared when staged, else global
  const double* __restrict__ A;
  int N, refactor_every, t;          // t: the thread's index in the warp
  double *Binv, *aug, *B, *xB, *y, *rho, *w;
  double *lo, *up, *d, *al;
  u64* sk;                           // run keys: slot s of thread t at s*32+t
  unsigned short* si;                // their columns
  unsigned char* fl;
  int* basis;
  double tol, theta;
  int status, it, since, stall, bland, n_bland, n_drift;

  __device__ double Aij(int i, int j) const { return A[i * N + j]; }

  // xB[t] -= Binv[t] . (the warp's sums of part), t < M: every thread
  // gets every row's sum by the butterfly, so none goes through memory
  __device__ void absorb_rows(double (&part)[M], bool negate) {
#pragma unroll
    for (int i = 0; i < M; ++i) part[i] = warp_sum(part[i]);
    if (t < M) {
      double s = 0.0;
#pragma unroll
      for (int k = 0; k < M; ++k) s += Binv[t * M + k] * part[k];
      xB[t] = negate ? -s : xB[t] - s;
    }
  }

  // Binv = B^-1: Gauss-Jordan on [B | I] with partial pivoting (the
  // first largest |.| at or below the diagonal), thread t holding column
  // t of [B | I] in registers (M <= 16: 2M <= 32 columns).  The pivot
  // column's owner finds the pivot row as the CTA path's thread 0 does;
  // every update is the CTA path's, so the inverse is bit for bit its.
  __device__ void invert_registers() {
    double col[M];
#pragma unroll
    for (int r = 0; r < M; ++r)
      col[r] = t < M ? B[r * M + t] : (t - M == r ? 1.0 : 0.0);
#pragma unroll
    for (int c = 0; c < M; ++c) {
      int p = c;
      if (t == c) {
        double best = fabs(col[c]);
#pragma unroll
        for (int r = c + 1; r < M; ++r) {
          const double v = fabs(col[r]);
          if (v > best) { best = v; p = r; }
        }
      }
      p = __shfl_sync(FULL, p, c);
      double pc[M];                        // the pivot column
#pragma unroll
      for (int r = 0; r < M; ++r) pc[r] = __shfl_sync(FULL, col[r], c);
      double pv = pc[c], cp = col[c];
#pragma unroll
      for (int r = c + 1; r < M; ++r)
        if (r == p) { pv = pc[r]; cp = col[r]; }
      const double rowc = cp / pv;         // new row c
      const double xc = col[c], pcc = pc[c];
#pragma unroll
      for (int r = 0; r < M; ++r) {        // rows c and p swap
        if (r == c) continue;
        col[r] = r == p ? xc - pcc * rowc : col[r] - pc[r] * rowc;
      }
      col[c] = rowc;
    }
    if (t >= M && t < 2 * M) {
#pragma unroll
      for (int r = 0; r < M; ++r) Binv[r * M + t - M] = col[r];
    }
    __syncwarp();
  }

  // the same in shared memory (M = 32, or any M), ping-pong
  __device__ void invert_shared() {
    constexpr int W2 = 2 * M;
    double* cur = aug;
    double* nxt = aug + M * W2;
    for (int e = t; e < M * W2; e += 32) {
      const int i = e / W2, c = e % W2;
      cur[e] = c < M ? B[i * M + c] : (c - M == i ? 1.0 : 0.0);
    }
    __syncwarp();
    for (int c = 0; c < M; ++c) {
      // partial pivoting: the first largest |.| below the diagonal; a
      // NaN pivot stays, a NaN below it is never taken
      u64 key = KEY_NONE;
      if (t >= c && t < M) {
        const double v = fabs(cur[t * W2 + c]);
        key = isnan(v) ? (t == c ? 0ull : KEY_NONE) : ~order_bits(v);
      }
      u64 km;
      unsigned p;
      warp_argmin(key, (unsigned)t, km, p);
      const double pv = cur[p * W2 + c];
      for (int e = t; e < M * W2; e += 32) {
        const int r = e / W2, col = e % W2;
        const double rowc = cur[p * W2 + col] / pv;       // new row c
        const int sr = r == c ? p : (r == (int)p ? c : r);  // rows c, p swap
        nxt[e] = r == c ? rowc : cur[sr * W2 + col] - cur[sr * W2 + c] * rowc;
      }
      __syncwarp();
      double* tmp = cur; cur = nxt; nxt = tmp;
    }
    for (int e = t; e < M * M; e += 32)
      Binv[e] = cur[(e / M) * W2 + M + e % M];
    __syncwarp();
  }

  // Binv, xB, y, d from the basis (repro/core/lp.py::_refreshed)
  __device__ void refresh() {
    if constexpr (WARP_INVERT_REGS && M <= 16) invert_registers();
    else invert_shared();
    // A @ xN over the nonbasic columns, each thread's in column order
    double part[M];
#pragma unroll
    for (int i = 0; i < M; ++i) part[i] = 0.0;
#pragma unroll 4
    for (int j = t; j < N; j += 32) {
      const unsigned char f = fl[j];
      if (f & F_BASIC) continue;
      const double x = (f & F_UPPER) ? up[j] : lo[j];
#pragma unroll
      for (int i = 0; i < M; ++i) part[i] += Aij(i, j) * x;
    }
    absorb_rows(part, true);                // xB = -Binv (A xN)
    if (t < M) {
      double u = 0.0;
      for (int k = 0; k < M; ++k) u += Binv[k * M + t] * cf[basis[k]];
      y[t] = u;
    }
    __syncwarp();
    double yr[M];
#pragma unroll
    for (int i = 0; i < M; ++i) yr[i] = y[i];
    // d over this thread's columns, four at a time: every load of a
    // batch before its stores (which the compiler may not reorder)
    for (int j0 = t; j0 < N; j0 += 128) {
      double s4[4], c4[4];
      bool b4[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + 32 * u;
        s4[u] = c4[u] = 0.0;
        b4[u] = true;
        if (j < N) {
          b4[u] = fl[j] & F_BASIC;
          c4[u] = cf[j];
          double sj = 0.0;
#pragma unroll
          for (int i = 0; i < M; ++i) sj += Aij(i, j) * yr[i];
          s4[u] = sj;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + 32 * u;
        if (j < N) d[j] = b4[u] ? 0.0 : c4[u] - s4[u];
      }
    }
    since = 0;
    __syncwarp();
  }

  // this thread's run of cnt <= 8 keys, sorted by (key, column) in
  // registers: an optimal 19-comparator network, unused slots KEY_NONE
  __device__ void sort_run8(int cnt) {
    u64 k[8];
    unsigned c[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      k[e] = e < cnt ? sk[e * 32 + t] : KEY_NONE;
      c[e] = e < cnt ? si[e * 32 + t] : 0xffffu;
    }
    constexpr int NET[19][2] = {{0, 2}, {1, 3}, {4, 6}, {5, 7}, {0, 4},
                                {1, 5}, {2, 6}, {3, 7}, {0, 1}, {2, 3},
                                {4, 5}, {6, 7}, {2, 4}, {3, 5}, {1, 4},
                                {3, 6}, {1, 2}, {3, 4}, {5, 6}};
#pragma unroll
    for (int n = 0; n < 19; ++n) {
      const int a = NET[n][0], b = NET[n][1];
      if (key_lt(k[b], c[b], k[a], c[a])) {
        const u64 tk = k[a]; k[a] = k[b]; k[b] = tk;
        const unsigned tc = c[a]; c[a] = c[b]; c[b] = tc;
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (e < cnt) {
        sk[e * 32 + t] = k[e];
        si[e * 32 + t] = (unsigned short)c[e];
      }
    }
  }

  // row t's violation (t < M)
  __device__ double viol(int i) const {
    const int b = basis[i];
    return maxn(lo[b] - xB[i], xB[i] - up[b]);
  }

  // one trip of the reference's batched loop body for this lane
  __device__ void trip() {
    PROBE_WARP(PH_OUT);
    // ---- drift gate (repro/core/lp.py::_drift_gate), on B
    double res = 0.0;
    for (int e = t; e < M * M; e += 32) {
      const int i = e / M, j = e % M;
      double s = 0.0;
      for (int k = 0; k < M; ++k) s += Binv[i * M + k] * B[k * M + j];
      res = maxn(res, fabs(s - (i == j ? 1.0 : 0.0)));
    }
    res = warp_maxn(res);
    const int drift = res > DRIFT_TOL && since > 0;
    n_drift += drift;
    // optimal-suspect gate (_optimal_suspect_gate)
    const double vmax = warp_maxn(t < M ? viol(t) : -INFINITY);
    const bool need = drift || since >= refactor_every
                      || (vmax <= tol && since > 0);
    PROBE_WARP(PH_GATES);
    if (need) refresh();
    PROBE_WARP(PH_REFRESH);
    // ---- the leaving row (_pivot_core)
    const double v = t < M ? viol(t) : 0.0;
    u64 km;
    unsigned rmax, rbl = 0;
    warp_argmin(t < M ? max_first_key(v) : KEY_NONE, (unsigned)t, km, rmax);
    const double best = __shfl_sync(FULL, v, rmax);
    if (bland)                   // Bland's row: the smallest basic index
      warp_argmin(t < M ? (u64)(v > tol ? basis[t] : N) : KEY_NONE,
                  (unsigned)t, km, rbl);
    const bool done = best <= tol;
    const int r = bland ? (int)rbl : (int)rmax;
    const bool stale = since > 0;
    int k_elig = 0, has_cross = 0, q = 0, unsafe = 0, h = 0;
    u64 kq = 0;
    double wr = 0.0, delta = 0.0;
    bool above = false;
    {
      const int b = basis[r];
      const double vlo = lo[b] - xB[r], vhi = xB[r] - up[b];
      above = vhi >= vlo;
      delta = above ? xB[r] - up[b] : xB[r] - lo[b];
    }
    double rh[M];
    if (!done) {
#pragma unroll
      for (int i = 0; i < M; ++i) rh[i] = Binv[r * M + i];
      if (t < M) rho[t] = Binv[r * M + t];
      PROBE_WARP(PH_LEAVE);
      // ---- pricing, eligibility, ratio keys: this thread's run
      const double s = delta > 0 ? 1.0 : -1.0;
      int cnt = 0, neg = 0;
      double rmin = INFINITY, total = 0.0;
      for (int j0 = t; j0 < N; j0 += 128) {     // four columns a batch
        double a4[4], d4[4], w4[4];
        unsigned char f4[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = j0 + 32 * u;
          a4[u] = d4[u] = w4[u] = 0.0;
          f4[u] = F_BASIC;
          if (j < N) {
            double a = 0.0;
#pragma unroll
            for (int i = 0; i < M; ++i) a += rh[i] * Aij(i, j);
            a4[u] = a;
            f4[u] = fl[j];
            d4[u] = d[j];
            w4[u] = up[j] - lo[j];
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = j0 + 32 * u;
          if (j >= N) continue;
          const double a = a4[u];
          al[j] = a;
          const double sa = s * a;
          const unsigned char f = f4[u];
          const bool atu = f & F_UPPER;
          const bool elig = !(f & F_BASIC) &&
                            ((!atu && sa > tol) || (atu && sa < -tol));
          if (elig) {
            const double den = fabs(sa) > tol ? sa : 1.0;
            const double rt = maxn(d4[u] / den, 0.0);
            sk[cnt * 32 + t] = order_bits(rt);
            si[cnt * 32 + t] = (unsigned short)j;
            ++cnt;
            rmin = minn(rmin, rt);
            const double cost = fabs(a) * w4[u];
            total += cost;
            neg |= cost < 0.0;
          }
        }
      }
      k_elig = __reduce_add_sync(FULL, (unsigned)cnt);
      rmin = warp_minn(rmin);
      total = warp_sum(total);
      neg = __any_sync(FULL, neg);
      __syncwarp();                                // alpha, read by all
      PROBE_WARP(PH_PRICE);
      if (k_elig > 0) {
        if (bland) {
          // Bland: the smallest-index min-ratio column, no flips (this
          // thread's run is still in column order)
          unsigned qb = 0xffffffffu;
          for (int c = 0; c < cnt; ++c) {
            if (ratio_of(sk[c * 32 + t]) <= rmin + 1e-12) {
              qb = si[c * 32 + t];
              break;
            }
          }
          qb = __reduce_min_sync(FULL, qb);
          q = qb == 0xffffffffu ? 0 : (int)qb;   // NaN minimum: argmax of none
          has_cross = 1;
          PROBE_WARP(PH_WALK);
        } else if (!neg && total * (1.0 + (4.0 * k_elig + 32.0) * 0x1p-53)
                   < fabs(delta) - 1e-12) {
          // no crossing, certainly: with costs >= 0 every running sum
          // of the walk is at most its last, the sum of every eligible
          // cost in (ratio, index) order, and that is within (2k + 5)
          // ulps of this sum in another order (k terms, a butterfly of
          // 32), so below the threshold; the walk would consume every
          // key and find none (has_cross = 0, no flips)
          PROBE_WARP(PH_WALK);
        } else {
          // the run, sorted by (key, column): up to 8 keys by a sorting
          // network in registers, longer runs by insertion (stable by
          // key alone: the run's columns came in order)
          if (WARP_SORT_NET && __all_sync(FULL, cnt <= 8)) sort_run8(cnt);
          else for (int c = 1; c < cnt; ++c) {
            const u64 k = sk[c * 32 + t];
            const unsigned short j = si[c * 32 + t];
            int e = c - 1;
            for (; e >= 0 && k < sk[e * 32 + t]; --e) {
              sk[(e + 1) * 32 + t] = sk[e * 32 + t];
              si[(e + 1) * 32 + t] = si[e * 32 + t];
            }
            sk[(e + 1) * 32 + t] = k;
            si[(e + 1) * 32 + t] = j;
          }
          PROBE_WARP(PH_SORT);
          // the ordered merge: the least run head, its cost added to the
          // running sum in that order, until the sum reaches thr
          const double thr = fabs(delta) - 1e-12;
          double base = 0.0;
          u64 hk = cnt > 0 ? sk[t] : KEY_NONE;
          unsigned hj = cnt > 0 ? si[t] : 0xffffffffu;
          for (;;) {
            u64 kmin;
            unsigned jm;
            warp_argmin(hk, hj, kmin, jm);
            if (kmin == KEY_NONE) break;            // every key consumed
            base += fabs(al[jm]) * (up[jm] - lo[jm]);
            if (base >= thr) {
              has_cross = 1; q = (int)jm; kq = kmin;
              break;
            }
            if (hj == jm) {
              ++h;
              hk = h < cnt ? sk[h * 32 + t] : KEY_NONE;
              hj = h < cnt ? si[h * 32 + t] : 0xffffffffu;
            }
          }
          PROBE_WARP(PH_WALK);
        }
      }
      if (has_cross) {
        if (t < M) {
          double s2 = 0.0;
          for (int k = 0; k < M; ++k) s2 += Binv[t * M + k] * Aij(k, q);
          w[t] = s2;
        }
        __syncwarp();
        wr = w[r];
        unsafe = fabs(wr) < 1e-11;
      }
    }
    const int no_pivot = k_elig == 0 || !has_cross;
    status = done ? OPTIMAL : (no_pivot && !stale ? INFEASIBLE : ITER_LIMIT);
    const int do_pivot = status == ITER_LIMIT && !no_pivot && !unsafe;
    if (do_pivot) {
      // ---- flip absorption: xB -= Binv (A dxN) over the flipped
      // columns, this thread's consumed prefix (none when ratio_q is NaN;
      // with no flips the sums are 0 and xB is kept exactly)
      if (!bland) {
        const int nf = kq == KEY_NAN ? 0 : h;
        double part[M];
#pragma unroll
        for (int i = 0; i < M; ++i) part[i] = 0.0;
        for (int c = 0; c < nf; ++c) {             // in this run's order
          const int j = si[c * 32 + t];
          const unsigned char f = fl[j];
          const double x = (f & F_UPPER) ? lo[j] - up[j] : up[j] - lo[j];
#pragma unroll
          for (int i = 0; i < M; ++i) part[i] += Aij(i, j) * x;
          fl[j] = f ^ F_UPPER;
        }
        absorb_rows(part, false);             // xB -= Binv (A dxN)
        __syncwarp();
        PROBE_WARP(PH_FLIPS);
      }
      const int leave = basis[r];
      const double target = above ? up[leave] : lo[leave];
      const double tt = (xB[r] - target) / wr;
      const double xq = (fl[q] & F_UPPER) ? up[q] : lo[q];
      theta = d[q] / wr;
      __syncwarp();
      if (t < M) {
        xB[t] = t == r ? xq + tt : xB[t] - tt * w[t];
        y[t] = y[t] + theta * rho[t];
        B[t * M + r] = Aij(t, q);
      }
      for (int e = t; e < M * M; e += 32) {
        const int i = e / M, jc = e % M;
        const double br = rho[jc] / wr;
        Binv[e] = i == r ? br : Binv[e] - w[i] * br;
      }
      for (int j0 = t; j0 < N; j0 += 128) {
        double d4[4], a4[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = j0 + 32 * u;
          d4[u] = a4[u] = 0.0;
          if (j < N) { d4[u] = d[j]; a4[u] = al[j]; }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = j0 + 32 * u;
          if (j < N)
            d[j] = j == leave ? -theta
                              : (j == q ? 0.0 : d4[u] - theta * a4[u]);
        }
      }
      __syncwarp();
      if (t == 0) {
        fl[q] = F_BASIC;
        fl[leave] = above ? F_UPPER : 0;
        basis[r] = q;
      }
      __syncwarp();
    }
    // ---- since, anti-cycling (degenerate streaks), counters
    if (do_pivot) since += 1;
    else if ((no_pivot || unsafe) && stale) since = refactor_every;
    const double at = fabs(theta);
    const int degen = do_pivot && at <= THETA_EPS;
    const int progress = do_pivot && at > THETA_EPS;
    n_bland += bland && do_pivot;
    stall = progress ? 0 : (degen ? stall + 1 : stall);
    bland = progress ? 0 : (bland || stall >= STALL_BLAND);
    if (degen && stall == STALL_REFACTOR) since = refactor_every;
    it += 1;
    PROBE_WARP(PH_PIVOT);
  }
};

template <int M>
__global__ void __launch_bounds__(32 * WARP_LANES_MAX, 1)
lp_batch_warp(const double* __restrict__ cf, const double* __restrict__ A,
              const double* __restrict__ in_pack,
              double* __restrict__ out_pack, int N, int K_pad,
              int max_iters, int trip_limit, int refactor_every, int lanes,
              int staged, int64_t lane_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  PROBE_INIT();
  unsigned char* p = smem;
  const double* cfp = cf;
  const double* Ap = A;
  uint64_t* bar = (uint64_t*)p;
  if (staged) {            // the copy runs while the lanes load their rows
    double* cf_s = (double*)(p + 16);
    double* A_s = cf_s + ((N + 1) & ~1);
    stage_issue(cf, A, cf_s, A_s, bar, M, N);
    cfp = cf_s;
    Ap = A_s;
    p += staged_bytes(M, N);
  }
  const int t = threadIdx.x & 31, wp = threadIdx.x >> 5;
  const int k = blockIdx.x * lanes + wp;
  const int64_t win = 3 * (int64_t)N + M + 3;
  const int64_t wout = 2 * (int64_t)N + 2 * M + 6;
  const double* row = in_pack + k * win;
  double* orow = out_pack + k * wout;
  if (k >= K_pad || row[3 * N + 1 + M] == 0.0) {  // padded, host-decided
    if (k < K_pad)
      for (int64_t e = t; e < wout; e += 32) orow[e] = 0.0;
    if (staged) stage_wait(bar);         // no CTA leaves a copy in flight
    return;
  }
  WLane<M> ln;
  ln.cf = cfp; ln.A = Ap; ln.N = N; ln.refactor_every = refactor_every;
  ln.t = t;
  const int S = run_slots(N);
  double* q = (double*)(p + wp * lane_bytes);
  ln.Binv = q; q += M * M;
  ln.aug = q; q += 4 * M * M;
  ln.B = q; q += M * M;
  ln.xB = q; q += M;
  ln.y = q; q += M;
  ln.rho = q; q += M;
  ln.w = q; q += M;
  ln.lo = q; q += N;
  ln.up = q; q += N;
  ln.d = q; q += N;
  ln.al = q; q += N;
  ln.sk = (u64*)q; q += S;
  ln.basis = (int*)q;
  ln.si = (unsigned short*)(ln.basis + M);
  ln.fl = (unsigned char*)(ln.si + S);

  // ---- initial state (_init_pivot_state), then the eager refresh; the
  // row's loads four columns a thread at a time, so that they overlap
  for (int j0 = t; j0 < N; j0 += 128) {
    double l4[4], u4[4], f4[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + 32 * u;
      if (j < N) {
        l4[u] = row[j];
        u4[u] = row[N + j];
        f4[u] = row[2 * N + 1 + M + j];
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + 32 * u;
      if (j < N) {
        ln.lo[j] = l4[u];
        ln.up[j] = u4[u];
        ln.fl[j] = f4[u] != 0.0 ? F_UPPER : 0;
      }
    }
  }
  if (t < M) ln.basis[t] = (int)row[2 * N + 1 + t];
  if (staged) stage_wait(bar);
  ln.tol = row[2 * N];
  ln.status = ITER_LIMIT; ln.it = 0; ln.since = refactor_every;
  ln.stall = 0; ln.bland = 0; ln.n_bland = 0; ln.n_drift = 0;
  ln.theta = 0.0;
  __syncwarp();
  if (t < M) ln.fl[ln.basis[t]] = F_BASIC;        // at_upper0 & ~in_basis
  for (int e = t; e < M * M; e += 32)             // B = A[:, basis]
    ln.B[e] = ln.Aij(e / M, ln.basis[e % M]);
  __syncwarp();
  ln.refresh();

  const int lim = min(max_iters, trip_limit);
  while (ln.status == ITER_LIMIT && ln.it < lim) ln.trip();
  if (ln.since > 0) ln.refresh();                 // the exit refactorization

  // ---- _gather_solution and the out pack
  double objp = 0.0;
  for (int j0 = t; j0 < N; j0 += 128) {
    double x4[4], c4[4];
    unsigned char f4[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + 32 * u;
      x4[u] = c4[u] = 0.0;
      f4[u] = 0;
      if (j < N) {
        f4[u] = ln.fl[j];
        c4[u] = ln.cf[j];
        x4[u] = (f4[u] & F_UPPER) ? ln.up[j] : ln.lo[j];
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + 32 * u;
      if (j >= N) continue;
      if (f4[u] & F_BASIC) {
        int pos = 0;
        for (int i = 0; i < M; ++i) if (ln.basis[i] == j) { pos = i; break; }
        x4[u] = ln.xB[pos];
      }
      orow[j] = x4[u];
      objp += c4[u] * (isfinite(x4[u]) ? x4[u] : 0.0);
      orow[N + 2 * M + 5 + j] = (f4[u] & F_UPPER) ? 1.0 : 0.0;
    }
  }
  const double obj = warp_sum(objp);
  if (t < M) {
    orow[N + t] = ln.y[t];
    orow[N + M + 1 + t] = (double)ln.basis[t];
  }
  if (t == 0) {
    orow[N + M] = obj;
    orow[N + 2 * M + 1] = ln.status;
    orow[N + 2 * M + 2] = ln.it;
    orow[N + 2 * M + 3] = ln.n_bland;
    orow[N + 2 * M + 4] = ln.n_drift;
    orow[2 * N + 2 * M + 5] = 0.0;     // spent: the wrapper's
  }
  PROBE_WARP(PH_OUT);
  PROBE_END(1, ln.it);
}

template <int M>
static int launch_warp(const Plan& pl, const double* cf, const double* A,
                       const double* in_pack, double* out_pack, int64_t N,
                       int64_t K_pad, int64_t max_iters, int64_t trip_limit,
                       int64_t refactor_every, cudaStream_t st) {
  if (pl.staged && ((uintptr_t)cf % 16 || (uintptr_t)A % 16))
    return (int)cudaErrorMisalignedAddress;   // the bulk copy's alignment
  cudaError_t e = cudaFuncSetAttribute(
      lp_batch_warp<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)pl.smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)((K_pad + pl.lanes - 1) / pl.lanes);
  lp_batch_warp<M><<<grid, 32 * pl.lanes, pl.smem, st>>>(
      cf, A, in_pack, out_pack, (int)N, (int)K_pad, (int)max_iters,
      (int)trip_limit, (int)refactor_every, pl.lanes, pl.staged,
      warp_lane_bytes(M, N));
  return (int)cudaGetLastError();
}

// ws: K_pad x lp_batch_ws_lane_bytes(m_pad, N) bytes (none for m_pad <=
// ROWS_SMEM_MAX and N <= NS_MAX, so none on the warp path).  in_pack
// (K_pad, 3N + m_pad + 3) and out_pack (K_pad, 2N + 2 m_pad + 6):
// repro/core/lp_batch.py::_batched_core's layouts.  m_pad: a power of
// two, 4 to M_PAD_MAX.
#define M_PAD_MAX 4096
extern "C" int64_t lp_batch_ws_lane_bytes(int64_t m_pad, int64_t N) {
  return ws_lane_bytes(m_pad, N);
}

// the path a flight takes: out = {warp path, lanes a CTA, (cf, A) staged,
// dynamic shared memory a CTA}
extern "C" int lp_batch_plan(int64_t m_pad, int64_t N, int64_t K_pad,
                             int64_t* out) {
  if (N < 1 || K_pad < 1 || m_pad < 4 || m_pad > M_PAD_MAX || !out)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(m_pad, N, K_pad);
  out[0] = p.warp; out[1] = p.lanes; out[2] = p.staged; out[3] = p.smem;
  return 0;
}

extern "C" int lp_batch_f64(const void* cf, const void* A,
                            const void* in_pack, void* out_pack, void* ws,
                            int64_t m_pad, int64_t N, int64_t K_pad,
                            int64_t max_iters, int64_t trip_limit,
                            int64_t refactor_every, void* stream) {
  if (N < 1 || N >= INT_MAX / 32 || K_pad < 1 || max_iters < 0
      || max_iters >= INT_MAX || trip_limit < 0 || refactor_every < 1
      || refactor_every >= INT_MAX || m_pad < 4 || m_pad > M_PAD_MAX
      || (m_pad & (m_pad - 1)) != 0
      || (ws_lane_bytes(m_pad, N) > 0 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  if (trip_limit >= INT_MAX) trip_limit = INT_MAX - 1;
  cudaStream_t st = (cudaStream_t)stream;
  const double* c = (const double*)cf;
  const double* a = (const double*)A;
  const double* ip = (const double*)in_pack;
  double* op = (double*)out_pack;
  unsigned char* w = (unsigned char*)ws;
  const Plan pl = plan(m_pad, N, K_pad);
  if (pl.warp) {
#define LAUNCH_WARP(MM) launch_warp<MM>(pl, c, a, ip, op, N, K_pad,    \
                                        max_iters, trip_limit,         \
                                        refactor_every, st)
    switch (m_pad) {
      case 4: return LAUNCH_WARP(4);
      case 8: return LAUNCH_WARP(8);
      case 16: return LAUNCH_WARP(16);
      default: return LAUNCH_WARP(32);
    }
#undef LAUNCH_WARP
  }
#define LAUNCH(MM) launch<MM>(c, a, ip, op, w, m_pad, N, K_pad, max_iters, \
                              trip_limit, refactor_every, st)
  switch (m_pad) {
    case 4: return LAUNCH(4);
    case 8: return LAUNCH(8);
    case 16: return LAUNCH(16);
    case 32: return LAUNCH(32);
    default: return LAUNCH(0);
  }
#undef LAUNCH
}
