// The batched bound-variant LP engine for Hopper (sm_90a): a whole flight
// of revised-dual-simplex solves with the bound-flipping ratio test as ONE
// launch, one CTA per lane.
//
// Replaces repro/core/lp_batch.py::_batched_core (a jitted, vmapped
// lax.while_loop over the single twin's pivot pieces, repro/core/lp.py
// _refreshed, _init_pivot_state, _factor_refresh, _drift_gate,
// _optimal_suspect_gate, _pivot_core and _gather_solution).  The K lanes
// share (cf, A) and differ in bounds, tolerance and starting basis.  In
// the reference the lanes interact only through the shared pivot cap,
// so here each CTA runs its own lane to its own end: it never waits on
// another lane, and the host imposes the cap by a trip limit (below).
//
// Per lane (blockIdx.x): the m x m basis inverse Binv, xB, y and the
// pivot row rho live in shared memory up to m_pad = 32 rows
// (ROWS_SMEM_MAX), in a global workspace above; d, alpha, the breakpoint
// keys, the bound flags and the bounds l/u live in shared memory when N
// fits (N <= NS_MAX), else in the global workspace (l/u are then read
// from the in pack).  (cf, A) stay in global memory; every lane reads
// them, and at these sizes (m ~ 2-20, N ~ 1e2-1e5) they stay in L2.  Row
// sums over the columns (A xN at a refresh, A dxN for the flips) are
// accumulated in registers 32 rows at a time, so any m builds.  Each trip
// is the reference's batched loop body for one lane:
//   1. drift gate: max |Binv B - I| > DRIFT_TOL (on stale factors), or
//      since >= refactor_every, and the optimal-suspect gate (every row
//      feasible on stale factors) -> refresh: an m x m Gauss-Jordan
//      inverse with partial pivoting in shared memory, then xB, y, d;
//   2. leaving row: the violation's argmax, or Bland's smallest basic
//      index; pricing alpha = rho @ A (rows added in order 0..m-1),
//      eligibility, ratio max(d / (s alpha), 0) as an order-preserving
//      64-bit key, flip cost |alpha| (u - l);
//   3. the BFRT select: eligible breakpoints in (ratio, index) order --
//      np.argsort(kind="stable")'s order -- their flip costs added one by
//      one from 0 by one thread, exactly np.cumsum's running sum; q is
//      the first to reach |delta| - 1e-12, and every breakpoint before it
//      flips.  The breakpoints are sorted in shared memory (bitonic), at
//      most CAPW a round: when more are eligible, a radix pass over the
//      96-bit (ratio, index) keys picks a boundary with at most CAPW keys
//      below it, and the next round continues the walk above it;
//   4. the pivot: flip absorption xB -= Binv (A dxN), the basis exchange,
//      d -= theta alpha, y += theta rho, the Sherman-Morrison update of
//      Binv, and the anti-cycling and drift bookkeeping.
// At exit a lane with since > 0 is refreshed, and x, y, obj, the basis,
// the counters and the bound pattern are written to its out-pack row.
//
// The shared pivot cap: after T lockstep trips the reference has spent
// sum_k min(it_k, T) pivots, and a lane's trajectory is its own.  So the
// wrapper launches with trip_limit = max_iters; if the lanes' trips
// reach the cap it finds the least such T and launches once more with
// trip_limit = T (kernels/lp_batch.py::LaneSolver), which gives the
// lockstep loop's lanes exactly.
//
// Bound: operations.  Each pivot prices the N columns (2 m N flops) and
// walks them a few times; a lane's bytes (A and its state) are read from
// L2, not HBM.  A trip is ~20 barriers plus the sort's, so at the pivot
// loop's sizes a lane is latency-bound: the design point is one launch
// per flight instead of ~200 host-issued ops and a host sync per trip.
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
      bitonic(P);
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
    }
    if (tid == 0) sc->has_cross = sc->found;
    __syncthreads();
  }

  // one trip of the reference's batched loop body for this lane
  __device__ void trip() {
    const int tid = threadIdx.x, m = rows();
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
    if (sc->need) refresh();
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

// ws: K_pad x lp_batch_ws_lane_bytes(m_pad, N) bytes (none for m_pad <=
// ROWS_SMEM_MAX and N <= NS_MAX).  in_pack (K_pad, 3N + m_pad + 3) and
// out_pack (K_pad, 2N + 2 m_pad + 6): repro/core/lp_batch.py::
// _batched_core's layouts.  m_pad: a power of two, 4 to M_PAD_MAX.
#define M_PAD_MAX 4096
extern "C" int64_t lp_batch_ws_lane_bytes(int64_t m_pad, int64_t N) {
  return ws_lane_bytes(m_pad, N);
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
