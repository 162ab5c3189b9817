// The bound-flipping ratio test (BFRT) for Hopper (sm_90a): its bucketed
// histogram, and the whole select as one launch.
//
// Replaces the Pallas TPU kernel repro/kernels/bfrt.py::_bfrt_hist_kernel
// and the jnp driver around it, repro/kernels/bfrt.py::bfrt_select.
//
// The select, per dual-simplex pivot: over the N columns' breakpoint ratios
// (+inf where a column is not eligible) and flip costs, find the column q
// at which the flip costs, summed in increasing (ratio, column) order,
// first reach the budget |delta|; every eligible column before q flips.
//   1. edges: NB = 128 upper bucket edges evenly spaced over pricing's
//      (min, max) of the finite ratios, the last +inf, bit for bit as
//      kernels/bfrt.py::edges_from_range builds them (__dadd_rn and
//      __dmul_rn: no FMA);
//   2. pass 1: per-bucket sums of the finite ratios' costs;
//   3. the crossing bucket: the first whose running sum reaches
//      budget - 1e-12 (none: no crossing), its (lo, hi] edges, and base,
//      the running sum before it;
//   4. pass 2: the columns of that bucket compacted in index order, sorted
//      by (ratio, index) -- torch.sort(stable=True)'s order -- and walked
//      from base; q is the first that reaches the threshold (none: the
//      bucket's first);
//   5. flips[j] = finite_j & (ratio_j < ratio_q | (in_bucket_j &
//      ratio_j == ratio_q & j < q)) & j != q.
// Every sum has a fixed order, so two runs are bit-identical: a warp adds
// its columns in index order (lanes of one bucket grouped by
// __match_any_sync, their costs added by the group's first lane in lane
// order), warps and blocks are added in their order, the bucket's walk is
// one thread's running sum, as torch.cumsum's on the CPU.
//
// Bound: memory -- ratio and cost read once (16 bytes a column), one byte
// of flip mask written; the work per column is a 7-step search.  At the
// pivot loop's sizes (N ~ 1e3) the device time is a few microseconds and
// the cost is the launch, so:
//   * N <= ONE_MAX: one launch of one CTA (bfrt_select_one) does it all,
//     the bucket's columns sorted in shared memory (bitonic).
//   * larger N: three launches on the stream, no host sync.  grid_hist:
//     block partials of pass 1; the last block to finish (a ticket:
//     __threadfence + atomicAdd, reset by that block) adds them in block
//     order, fixes the bucket and each block's offset for compaction.
//     grid_walk: each block compacts its bucket columns; the last one sorts
//     and walks them.  grid_flips writes the mask.
//   * a crowded bucket (more than CAP columns: every ratio equal, or an
//     outlier stretching the range so the rest share bucket 0) is refined
//     by one block, exactly: radix levels over the 96-bit key (order bits
//     of the ratio, column index), 8 bits a level from the highest bit
//     where the candidates' smallest and largest keys differ; each level
//     histograms the digit's costs, keeps the digit where the running sum
//     crosses and moves base past the digits before it, until at most CAP
//     columns are left to sort and walk.  kernels/bfrt.py::
//     bfrt_select_refined_plain is the same procedure in torch.
// An inconsistent state (a compaction that does not find the histogram's
// count, more than MAX_LEVELS levels) traps.
#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>
#include <limits.h>

typedef unsigned long long u64;

#define TILE 1024
#define THREADS 256
#define MAX_NB 1024

// ---------------------------------------------------------------- pass 1
// bfrt_histogram: per-bucket sums and counts over given edges.  Each block
// walks tiles of TILE columns (grid-stride, fixed grid for a given N); a
// tile's bucket ids and costs are staged in shared memory, then thread b
// adds the tile's entries of bucket b in index order.  Block partials are
// reduced in block order by a second launch.

__global__ void bfrt_hist_partial(const double* __restrict__ ratio,
                                  const double* __restrict__ cost,
                                  const double* __restrict__ edges,
                                  int64_t N, int NB,
                                  double* __restrict__ psum,
                                  double* __restrict__ pcnt) {
  __shared__ double e_s[MAX_NB];
  __shared__ double c_s[TILE];
  __shared__ int b_s[TILE];
  for (int i = threadIdx.x; i < NB; i += blockDim.x) e_s[i] = edges[i];
  double acc_s[MAX_NB / THREADS];
  double acc_c[MAX_NB / THREADS];
  for (int k = 0; k < MAX_NB / THREADS; ++k) acc_s[k] = acc_c[k] = 0.0;
  __syncthreads();
  const int64_t ntiles = (N + TILE - 1) / TILE;
  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int64_t base = t * TILE;
    for (int i = threadIdx.x; i < TILE; i += blockDim.x) {
      const int64_t j = base + i;
      int b = -1;
      double c = 0.0;
      if (j < N) {
        const double r = ratio[j];
        if (isfinite(r)) {
          int lo = 0, hi = NB;          // first b with edges[b] >= r
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (e_s[mid] < r) lo = mid + 1; else hi = mid;
          }
          b = lo < NB ? lo : NB - 1;
          c = cost[j];
        }
      }
      b_s[i] = b;
      c_s[i] = c;
    }
    __syncthreads();
    // thread owns buckets threadIdx.x, threadIdx.x + THREADS, ...
    for (int k = 0; k < MAX_NB / THREADS; ++k) {
      const int b = threadIdx.x + k * THREADS;
      if (b >= NB) break;
      double s = acc_s[k], n = acc_c[k];
      for (int i = 0; i < TILE; ++i) {
        if (b_s[i] == b) { s += c_s[i]; n += 1.0; }
      }
      acc_s[k] = s;
      acc_c[k] = n;
    }
    __syncthreads();
  }
  for (int k = 0; k < MAX_NB / THREADS; ++k) {
    const int b = threadIdx.x + k * THREADS;
    if (b >= NB) break;
    psum[(int64_t)blockIdx.x * NB + b] = acc_s[k];
    pcnt[(int64_t)blockIdx.x * NB + b] = acc_c[k];
  }
}

__global__ void bfrt_hist_reduce(const double* __restrict__ psum,
                                 const double* __restrict__ pcnt,
                                 int nblocks, int NB,
                                 double* __restrict__ sums,
                                 double* __restrict__ counts) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= NB) return;
  double s = 0.0, n = 0.0;
  for (int k = 0; k < nblocks; ++k) {
    s += psum[(int64_t)k * NB + b];
    n += pcnt[(int64_t)k * NB + b];
  }
  sums[b] = s;
  counts[b] = n;
}

extern "C" int bfrt_hist_nblocks(int64_t N) {
  int64_t t = (N + TILE - 1) / TILE;
  if (t > 264) t = 264;                 // two blocks per SM
  return (int)(t < 1 ? 1 : t);
}

// psum/pcnt: scratch of bfrt_hist_nblocks(N) * NB doubles each
extern "C" int bfrt_hist_f64(const void* ratio, const void* cost,
                             const void* edges, int64_t N, int64_t NB,
                             void* psum, void* pcnt, void* sums,
                             void* counts, void* stream) {
  if (NB < 1 || NB > MAX_NB) return (int)cudaErrorInvalidValue;
  const int nblocks = bfrt_hist_nblocks(N);
  cudaStream_t st = (cudaStream_t)stream;
  bfrt_hist_partial<<<nblocks, THREADS, 0, st>>>(
      (const double*)ratio, (const double*)cost, (const double*)edges, N,
      (int)NB, (double*)psum, (double*)pcnt);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bfrt_hist_reduce<<<(unsigned)((NB + 127) / 128), 128, 0, st>>>(
      (const double*)psum, (const double*)pcnt, nblocks, (int)NB,
      (double*)sums, (double*)counts);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- select

#define NBK 128             // buckets (kernels/bfrt.py NUM_BUCKETS)
#define NDIG 256            // digits of a refinement level
#define ONE_MAX 8192        // N up to which one CTA does the whole select
#define CAP 8192            // bucket columns one block sorts
#define ONE_THREADS 1024
#define GRID_THREADS 512
#define GRID_COLS 1024      // columns per block of the grid path, at least
#define MAX_BLOCKS 264      // two per SM
#define MAX_LEVELS 12       // 96 key bits, 8 a level
#define FULL 0xffffffffu

// what the crossing bucket's search leaves for the walk and the flips
struct Cross {
  double base, thr, lo, hi;    // walk base, budget - 1e-12, bucket (lo, hi]
  int bidx, k, has_cross;
};

// the grid path's scratch, at the start of the caller's zeroed buffer
struct Work {
  unsigned ticket[2];
  Cross cr;
};

__device__ __forceinline__ u64 order_bits(double r) {
  // -0 -> +0 first: the two compare equal, so they tie, by index
  const long long b = __double_as_longlong(__dadd_rn(r, 0.0));
  return b < 0 ? ~(u64)b : ((u64)b | 0x8000000000000000ull);
}

__device__ __forceinline__ bool key_less(u64 ah, unsigned al, u64 bh,
                                         unsigned bl) {
  return ah < bh || (ah == bh && al < bl);
}

// edge t of edges_from_range(rng)
__device__ __forceinline__ double edge(const double* __restrict__ rng,
                                       int t) {
  const double rmin = fmin(rng[0], rng[1]);
  double span = __dsub_rn(rng[1], rmin);
  span = span < 1e-12 ? 1e-12 : span;          // clamp_min (NaN stays)
  const double step = t < NBK - 1 ? (double)(t + 1) / (double)(NBK - 1)
                                  : (double)INFINITY;
  return __dadd_rn(rmin, __dmul_rn(span, step));
}

// first b with e[b] >= r (searchsorted, left), clamped
__device__ __forceinline__ int bucket_of(double r, const double* e) {
  int lo = 0, hi = NBK;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (e[mid] < r) lo = mid + 1; else hi = mid;
  }
  return lo < NBK ? lo : NBK - 1;
}

__device__ __forceinline__ bool in_bucket(double r, double lo, double hi) {
  return isfinite(r) && r > lo && r <= hi;
}

// Per-bin cost sums and counts of the columns j of [begin, end) that
// bin(j, ratio[j]) maps to a bin (>= 0), in a fixed order: warp w takes a
// contiguous slice in chunks of 32; a chunk's lanes of one bin are added
// by the first of them, in lane order, or by a shuffle tree when the
// whole chunk shares one bin (crowded buckets, equal ratios).
// whist/wcnt: (warps, NBINS) scratch, cbuf: 32 per warp; sums/cnts:
// NBINS results.  Every thread of the block calls it.
template <int NBINS, class Bin>
__device__ void block_hist(int64_t begin, int64_t end,
                           const double* __restrict__ ratio,
                           const double* __restrict__ cost, Bin bin,
                           double* whist, int* wcnt, double* cbuf,
                           double* sums, int* cnts) {
  const int nw = blockDim.x >> 5, w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < nw * NBINS; i += blockDim.x) {
    whist[i] = 0.0;
    wcnt[i] = 0;
  }
  __syncthreads();
  const int64_t per = (((end - begin) + nw - 1) / nw + 31) & ~(int64_t)31;
  const int64_t wb = begin + w * per;
  const int64_t we = wb + per < end ? wb + per : end;
  double* hw = whist + w * NBINS;
  int* cw = wcnt + w * NBINS;
  double* cb = cbuf + w * 32;
  for (int64_t j0 = wb; j0 < we; j0 += 32) {
    const int64_t j = j0 + lane;
    int b = -1;
    double c = 0.0;
    if (j < we) {
      const double r = ratio[j];
      c = cost[j];
      b = bin(j, r);
    }
    const unsigned peers = __match_any_sync(FULL, b);
    if (peers == FULL) {                   // the same for every lane
      double s = c;
      for (int o = 16; o; o >>= 1) s += __shfl_down_sync(FULL, s, o);
      if (lane == 0 && b >= 0) {
        hw[b] += s;
        cw[b] += 32;
      }
      continue;
    }
    cb[lane] = c;
    __syncwarp();
    if (b >= 0 && lane == __ffs(peers) - 1) {
      double s = 0.0;
      for (unsigned m = peers; m; m &= m - 1) s += cb[__ffs(m) - 1];
      hw[b] += s;
      cw[b] += __popc(peers);
    }
    __syncwarp();
  }
  __syncthreads();
  for (int b = threadIdx.x; b < NBINS; b += blockDim.x) {
    double s = 0.0;
    int n = 0;
#pragma unroll 8
    for (int v = 0; v < nw; ++v) {
      s += whist[v * NBINS + b];
      n += wcnt[v * NBINS + b];
    }
    sums[b] = s;
    cnts[b] = n;
  }
  __syncthreads();
}

// Exclusive prefix of v over the block's threads; *total gets the sum.
// wsum: 32 ints of shared scratch.  Every thread calls it.
__device__ int block_excl_scan(int v, int* wsum, int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[w] = x;
  __syncthreads();
  if (w == 0) {
    int s = lane < nw ? wsum[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += y;
    }
    if (lane < nw) wsum[lane] = s;
  }
  __syncthreads();
  const int excl = x - v + (w > 0 ? wsum[w - 1] : 0);
  *total = wsum[nw - 1];
  __syncthreads();
  return excl;
}

// The columns j of [begin, end) with pred(j, ratio[j]), in index order,
// written as (order bits of the ratio, j) to okey/oidx (at most cap of
// them); returns how many there are.  Every thread calls it.
template <class Pred>
__device__ int block_compact(int64_t begin, int64_t end,
                             const double* __restrict__ ratio, Pred pred,
                             u64* okey, int* oidx, int cap, int* wsum) {
  constexpr int V = 8;                     // consecutive columns a thread
  const int64_t tile = (int64_t)blockDim.x * V;
  int off = 0;
  for (int64_t t0 = begin; t0 < end; t0 += tile) {
    const int64_t j0 = t0 + (int64_t)threadIdx.x * V;
    unsigned mask = 0;
    for (int v = 0; v < V; ++v) {
      const int64_t j = j0 + v;
      if (j < end && pred(j, ratio[j])) mask |= 1u << v;
    }
    int total;
    int pos = off + block_excl_scan(__popc(mask), wsum, &total);
    for (int v = 0; v < V; ++v) {
      if (mask >> v & 1) {
        if (pos < cap) {
          okey[pos] = order_bits(ratio[j0 + v]);
          oidx[pos] = (int)(j0 + v);
        }
        ++pos;
      }
    }
    off += total;
  }
  return off;
}

// Warp 0, every lane: the first of NBINS bins whose running sum from base
// reaches thr, -1 if none, and in *nbase the running sum before it (base
// and the bins before).  The running sum is a fixed tree: each lane adds
// its NBINS / 32 consecutive bins in order, a scan across the warp adds
// the lanes' totals.
template <int NBINS>
__device__ int warp_first_crossing(const double* sums, double base,
                                   double thr, double* nbase) {
  constexpr int PER = NBINS / 32;
  const int lane = threadIdx.x & 31;
  double loc[PER];
  double acc = 0.0;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    acc += sums[lane * PER + i];
    loc[i] = acc;
  }
  double incl = acc;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl = y + incl;
  }
  double excl = __shfl_up_sync(FULL, incl, 1);
  if (lane == 0) excl = 0.0;
  int first = PER;
  double pre = excl;                       // the running sum before first
#pragma unroll
  for (int i = PER - 1; i >= 0; --i) {
    if (__dadd_rn(base, __dadd_rn(excl, loc[i])) >= thr) {
      first = i;
      pre = i > 0 ? __dadd_rn(excl, loc[i > 0 ? i - 1 : 0]) : excl;
    }
  }
  const unsigned hit = __ballot_sync(FULL, first < PER);
  if (!hit) return -1;
  const int L = __ffs(hit) - 1;
  const int b = L * PER + __shfl_sync(FULL, first, L);
  pre = __shfl_sync(FULL, pre, L);
  *nbase = b == 0 ? base : __dadd_rn(base, pre);
  return b;
}

// Warp 0: the crossing bucket from pass 1's sums and counts; lane 0
// writes *cr.
__device__ void find_bucket(const double* sums, const int* cnts,
                            const double* e, double budget, Cross* cr) {
  const int lane = threadIdx.x & 31;
  int total = 0;
  for (int b = lane; b < NBK; b += 32) total += cnts[b];
  for (int o = 16; o; o >>= 1) total += __shfl_xor_sync(FULL, total, o);
  const double thr = __dsub_rn(budget, 1e-12);
  double base = 0.0;
  int bidx = warp_first_crossing<NBK>(sums, 0.0, thr, &base);
  if (lane == 0) {
    cr->thr = thr;
    cr->has_cross = bidx >= 0 && total > 0;
    if (bidx < 0) {
      bidx = 0;
      base = 0.0;
    }
    cr->bidx = bidx;
    cr->base = base;
    cr->lo = bidx == 0 ? -(double)INFINITY : e[bidx - 1];
    cr->hi = e[bidx];
    cr->k = cnts[bidx];
  }
}

// Sort the k keys (okey, oidx) in shared memory by (key, index), a
// bitonic network over the next power of two P >= k.  With P <= the
// block's threads each thread holds one key in registers: stages whose
// partner lies in the same warp exchange by shuffles, the others through
// shared memory (okey/oidx and spare, in turns: one barrier a stage).
// Larger P sorts in place in okey/oidx (room for P keys).  Then the
// sorted columns' running cost sum, a fixed tree as in
// warp_first_crossing: each lane of warp 0 adds a contiguous run in
// order, a warp scan adds the runs' totals.  Returns to every thread the
// first position whose base + running sum reaches thr (-1 if none), and
// in *sorted the sorted column indices.
__device__ int sort_and_walk(int k, u64* okey, int* oidx, double* spare_cs,
                             int* spare_idx,
                             const double* __restrict__ cost, double base,
                             double thr, int* pos_s, const int** sorted) {
  double* cs = reinterpret_cast<double*>(okey);
  int* sx = oidx;
  if (threadIdx.x == 0) *pos_s = INT_MAX;
  int P = 1;
  while (P < k) P <<= 1;
  __syncthreads();
  if (P <= (int)blockDim.x) {
    const int i = threadIdx.x;
    u64 key = i < k ? okey[i] : ~0ull;
    unsigned id = i < k ? (unsigned)oidx[i] : ~0u;
    int turn = 0;
    for (int size = 2; size <= P; size <<= 1) {
      for (int half = size >> 1; half > 0; half >>= 1) {
        u64 pk = 0;
        unsigned pi = 0;
        if (half >= 32) {
          u64* bk = turn ? reinterpret_cast<u64*>(spare_cs) : okey;
          unsigned* bi = reinterpret_cast<unsigned*>(turn ? spare_idx : oidx);
          turn ^= 1;          // its last reads came before the last barrier
          if (i < P) { bk[i] = key; bi[i] = id; }
          __syncthreads();
          if (i < P) { pk = bk[i ^ half]; pi = bi[i ^ half]; }
        } else {
          pk = __shfl_xor_sync(FULL, key, half);
          pi = __shfl_xor_sync(FULL, id, half);
        }
        // the lower of a pair keeps the smaller key in an ascending run
        const bool take = key_less(pk, pi, key, id)
                          == (((i & half) == 0) == ((i & size) == 0));
        if (i < P && take) { key = pk; id = pi; }
      }
    }
    __syncthreads();
    if (i < k) {
      sx[i] = (int)id;
      cs[i] = cost[id];
    }
    __syncthreads();
  } else {
    for (int i = k + threadIdx.x; i < P; i += blockDim.x) {
      okey[i] = ~0ull;
      oidx[i] = INT_MAX;
    }
    __syncthreads();
    for (int size = 2; size <= P; size <<= 1) {
      for (int half = size >> 1; half > 0; half >>= 1) {
        for (int i = threadIdx.x; i < P; i += blockDim.x) {
          const int o = i ^ half;
          if (o > i) {
            const bool up = (i & size) == 0;
            const u64 ki = okey[i], ko = okey[o];
            const int ii = oidx[i], io = oidx[o];
            if (key_less(ko, (unsigned)io, ki, (unsigned)ii) == up) {
              okey[i] = ko; okey[o] = ki;
              oidx[i] = io; oidx[o] = ii;
            }
          }
        }
        __syncthreads();
      }
    }
    for (int p = threadIdx.x; p < k; p += blockDim.x) cs[p] = cost[sx[p]];
    __syncthreads();
  }
  if (threadIdx.x < 32) {                // the running sum, in sorted order
    const int lane = threadIdx.x, per = (k + 31) / 32;
    const int p0 = lane * per, p1 = p0 + per < k ? p0 + per : k;
    double acc = 0.0;
    for (int p = p0; p < p1; ++p) acc += cs[p];
    double incl = acc;
    for (int o = 1; o < 32; o <<= 1) {
      const double y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl = y + incl;
    }
    double excl = __shfl_up_sync(FULL, incl, 1);
    if (lane == 0) excl = 0.0;
    double run = 0.0;
    for (int p = p0; p < p1; ++p) {
      run += cs[p];
      cs[p] = __dadd_rn(excl, run);
    }
  }
  __syncthreads();
  for (int p = threadIdx.x; p < k; p += blockDim.x) {
    if (__dadd_rn(base, cs[p]) >= thr) {
      atomicMin(pos_s, p);
      break;
    }
  }
  __syncthreads();
  const int pos = *pos_s;
  *sorted = sx;
  __syncthreads();
  return pos == INT_MAX ? -1 : pos;
}

__device__ __forceinline__ void write_flip(int64_t j,
                                           const double* __restrict__ ratio,
                                           double lo, double hi, double rq,
                                           long long q, bool* flips) {
  const double r = ratio[j];
  const bool fin = isfinite(r);
  const bool inb = fin && r > lo && r <= hi;
  flips[j] = fin && (r < rq || (inb && r == rq && j < q)) && j != q;
}

// shared-memory layout of a block that histograms (warps x nbins) and
// sorts up to `keys` columns
struct Smem {
  double* whist; double* cbuf; u64* okey; int* oidx; int* wcnt;
  __device__ Smem(unsigned char* base, int nw, int nbins, int keys) {
    whist = reinterpret_cast<double*>(base);
    cbuf = whist + nw * nbins;
    okey = reinterpret_cast<u64*>(cbuf + nw * 32);
    oidx = reinterpret_cast<int*>(okey + keys);
    wcnt = oidx + keys;
  }
};

static __host__ __device__ int pow2_at_least(int64_t n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

static __host__ __device__ size_t smem_bytes(int nw, int nbins, int keys) {
  return (size_t)nw * nbins * 12 + (size_t)nw * 32 * 8 + (size_t)keys * 12;
}

// ---- one CTA: N <= ONE_MAX, the whole select in one launch

__global__ void __launch_bounds__(ONE_THREADS)
bfrt_select_one(const double* __restrict__ ratio,
                const double* __restrict__ cost,
                const double* __restrict__ rng,
                const double* __restrict__ budget, int N,
                long long* __restrict__ q_out, bool* __restrict__ flips,
                bool* __restrict__ hc_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ double e_s[NBK], sums_s[NBK];
  __shared__ int cnt_s[NBK], wsum[32], pos_s;
  __shared__ Cross cr;
  const int nw = blockDim.x >> 5;
  Smem sm(smem_raw, nw, NBK, pow2_at_least(N));
  if (threadIdx.x < NBK) e_s[threadIdx.x] = edge(rng, threadIdx.x);
  __syncthreads();
  block_hist<NBK>(0, N, ratio, cost, [&](int64_t, double r) {
    return isfinite(r) ? bucket_of(r, e_s) : -1;
  }, sm.whist, sm.wcnt, sm.cbuf, sums_s, cnt_s);
  if (threadIdx.x < 32) find_bucket(sums_s, cnt_s, e_s, budget[0], &cr);
  __syncthreads();
  const double lo = cr.lo, hi = cr.hi;
  const int k = cr.k;
  const int got = block_compact(0, N, ratio, [&](int64_t, double r) {
    return in_bucket(r, lo, hi);
  }, sm.okey, sm.oidx, k, wsum);
  if (got != k) __trap();
  const int* sorted;
  const int pos = sort_and_walk(k, sm.okey, sm.oidx, sm.whist, sm.wcnt, cost,
                                cr.base, cr.thr, &pos_s, &sorted);
  // no column of the bucket reaches the threshold: its first; an empty
  // bucket: column 0 (torch.sort's first over all +inf)
  const long long q = k == 0 ? 0 : sorted[pos < 0 ? 0 : pos];
  if (threadIdx.x == 0) {
    q_out[0] = q;
    hc_out[0] = cr.has_cross;
  }
  const double rq = ratio[q];
  for (int64_t j = threadIdx.x; j < N; j += blockDim.x)
    write_flip(j, ratio, lo, hi, rq, q, flips);
}

// ---- the grid path: N > ONE_MAX

static __host__ __device__ int grid_blocks(int64_t N) {
  int64_t g = (N + GRID_COLS - 1) / GRID_COLS;
  return (int)(g > MAX_BLOCKS ? MAX_BLOCKS : g);
}

// the scratch after Work: psum (G, NBK) doubles, CAP keys, pcnt (G, NBK)
// ints, CAP indices, G offsets
struct Scratch {
  Work* w; double* psum; int* pcnt; int* offs; u64* ckey; int* cidx;
  __host__ __device__ Scratch(void* base, int G) {
    unsigned char* p = static_cast<unsigned char*>(base);
    w = reinterpret_cast<Work*>(p);
    psum = reinterpret_cast<double*>(p + 256);
    ckey = reinterpret_cast<u64*>(psum + (size_t)G * NBK);
    pcnt = reinterpret_cast<int*>(ckey + CAP);
    cidx = pcnt + (size_t)G * NBK;
    offs = cidx + CAP;
  }
  static __host__ __device__ size_t bytes(int G) {
    return 256 + (size_t)G * NBK * 12 + (size_t)CAP * 12 + (size_t)G * 4;
  }
};

__device__ __forceinline__ void slice(int64_t N, int64_t* b, int64_t* e) {
  const int64_t bs = (N + gridDim.x - 1) / gridDim.x;
  *b = (int64_t)blockIdx.x * bs;
  *e = *b + bs < N ? *b + bs : N;
}

// Is this block the last of the grid to get here?  Every thread's writes
// before the call are visible to that block after it.
__device__ bool last_block(unsigned* ticket) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  return last;
}

__global__ void __launch_bounds__(GRID_THREADS)
bfrt_grid_hist(const double* __restrict__ ratio,
               const double* __restrict__ cost,
               const double* __restrict__ rng,
               const double* __restrict__ budget, int64_t N, void* work) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ double e_s[NBK], sums_s[NBK];
  __shared__ int cnt_s[NBK], wsum[32];
  const int G = gridDim.x, nw = blockDim.x >> 5;
  Scratch sc(work, G);
  Smem sm(smem_raw, nw, NBK, 0);
  if (threadIdx.x < NBK) e_s[threadIdx.x] = edge(rng, threadIdx.x);
  __syncthreads();
  int64_t b0, b1;
  slice(N, &b0, &b1);
  block_hist<NBK>(b0, b1, ratio, cost, [&](int64_t, double r) {
    return isfinite(r) ? bucket_of(r, e_s) : -1;
  }, sm.whist, sm.wcnt, sm.cbuf, sums_s, cnt_s);
  for (int b = threadIdx.x; b < NBK; b += blockDim.x) {
    sc.psum[(size_t)blockIdx.x * NBK + b] = sums_s[b];
    sc.pcnt[(size_t)blockIdx.x * NBK + b] = cnt_s[b];
  }
  if (!last_block(&sc.w->ticket[0])) return;
  // the partials in block order: each of blockDim / NBK groups adds a
  // contiguous run of blocks (four loads in flight), then the groups are
  // added in their order
  const int groups = blockDim.x / NBK, grp = threadIdx.x / NBK;
  const int b = threadIdx.x % NBK, gper = (G + groups - 1) / groups;
  const int g0 = grp * gper, g1 = g0 + gper < G ? g0 + gper : G;
  double s = 0.0;
  int n = 0;
  for (int g = g0; g < g1; g += 4) {
    double v[4];
    int c[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool ok = g + u < g1;
      v[u] = ok ? __ldcg(sc.psum + (size_t)(g + u) * NBK + b) : 0.0;
      c[u] = ok ? __ldcg(sc.pcnt + (size_t)(g + u) * NBK + b) : 0;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (g + u < g1) {
        s += v[u];
        n += c[u];
      }
    }
  }
  sm.whist[grp * NBK + b] = s;
  sm.wcnt[grp * NBK + b] = n;
  __syncthreads();
  if (threadIdx.x < NBK) {
    double t = 0.0;
    int m = 0;
    for (int v = 0; v < groups; ++v) {
      t += sm.whist[v * NBK + threadIdx.x];
      m += sm.wcnt[v * NBK + threadIdx.x];
    }
    sums_s[threadIdx.x] = t;
    cnt_s[threadIdx.x] = m;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    find_bucket(sums_s, cnt_s, e_s, budget[0], &sc.w->cr);
    if (threadIdx.x == 0) sc.w->ticket[0] = 0;
  }
  __syncthreads();
  // each block's offset into the compacted bucket (G <= blockDim.x)
  const int bidx = sc.w->cr.bidx;
  const int mine = (int)threadIdx.x < G
      ? __ldcg(sc.pcnt + (size_t)threadIdx.x * NBK + bidx) : 0;
  int total;
  const int off = block_excl_scan(mine, wsum, &total);
  if ((int)threadIdx.x < G) sc.offs[threadIdx.x] = off;
}

// Block 0 alone: the crowded bucket, refined level by level until at most
// CAP columns are left, then sorted and walked.  Returns q to every thread.
__device__ long long refine(const double* __restrict__ ratio,
                            const double* __restrict__ cost, int64_t N,
                            const Cross& cr, const Smem& sm, int* wsum,
                            int* pos_s) {
  __shared__ double sums_s[NDIG];
  __shared__ int cnt_s[NDIG];
  __shared__ u64 rh[64];
  __shared__ unsigned rl[64];
  __shared__ u64 klh, khh;
  __shared__ unsigned kll, khl, firstl;
  __shared__ double base_s;
  __shared__ int count_s, done_s;
  const double lo = cr.lo, hi = cr.hi, thr = cr.thr;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  if (threadIdx.x == 0) {
    klh = 0; kll = 0; khh = ~0ull; khl = ~0u;
    base_s = cr.base;
    count_s = cr.k;
    done_s = 0;
  }
  __syncthreads();
  // a column of the bucket whose key lies in [kl, kh]; its key's high word
  auto cand = [&](int64_t j, double r, u64* h) {
    if (!in_bucket(r, lo, hi)) return false;
    *h = order_bits(r);
    const unsigned l = (unsigned)j;
    return !key_less(*h, l, klh, kll) && !key_less(khh, khl, *h, l);
  };
  for (int level = 1; count_s > CAP; ++level) {
    if (level > MAX_LEVELS) __trap();
    // the candidates' smallest and largest keys
    u64 mnh = ~0ull, mxh = 0;
    unsigned mnl = ~0u, mxl = 0;
    for (int64_t j = threadIdx.x; j < N; j += blockDim.x) {
      u64 h;
      if (!cand(j, ratio[j], &h)) continue;
      const unsigned l = (unsigned)j;
      if (key_less(h, l, mnh, mnl)) { mnh = h; mnl = l; }
      if (key_less(mxh, mxl, h, l)) { mxh = h; mxl = l; }
    }
    for (int o = 16; o; o >>= 1) {
      const u64 ah = __shfl_xor_sync(FULL, mnh, o);
      const unsigned al = __shfl_xor_sync(FULL, mnl, o);
      const u64 bh = __shfl_xor_sync(FULL, mxh, o);
      const unsigned bl = __shfl_xor_sync(FULL, mxl, o);
      if (key_less(ah, al, mnh, mnl)) { mnh = ah; mnl = al; }
      if (key_less(mxh, mxl, bh, bl)) { mxh = bh; mxl = bl; }
    }
    if (lane == 0) {
      rh[w] = mnh; rl[w] = mnl;
      rh[32 + w] = mxh; rl[32 + w] = mxl;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int v = 1; v < nw; ++v) {
        if (key_less(rh[v], rl[v], rh[0], rl[0])) { rh[0] = rh[v]; rl[0] = rl[v]; }
        if (key_less(rh[32], rl[32], rh[32 + v], rl[32 + v])) {
          rh[32] = rh[32 + v]; rl[32] = rl[32 + v];
        }
      }
      if (level == 1) firstl = rl[0];      // the bucket's first column
    }
    __syncthreads();
    // the 8-bit digit holding the highest bit where they differ
    const u64 xh = rh[0] ^ rh[32];
    const unsigned xl = rl[0] ^ rl[32];
    const int top = xh ? 32 + 63 - __clzll((long long)xh) : 31 - __clz((int)xl);
    const int sh = top & ~7;
    block_hist<NDIG>(0, N, ratio, cost, [&](int64_t j, double r) {
      u64 h;
      if (!cand(j, r, &h)) return -1;
      return sh >= 32 ? (int)((h >> (sh - 32)) & 255)
                      : (int)(((unsigned)j >> sh) & 255);
    }, sm.whist, sm.wcnt, sm.cbuf, sums_s, cnt_s);
    if (threadIdx.x < 32) {
      double nbase;
      const int d = warp_first_crossing<NDIG>(sums_s, base_s, thr, &nbase);
      if (threadIdx.x == 0) {
        if (d < 0) {
          done_s = 1;
        } else {
          // keys of the digit: the common prefix above it, d, any below
          u64 h = rh[0];
          unsigned l = rl[0];
          const int clear = sh + 8;
          if (clear >= 32) {
            l = 0;
            h = clear - 32 >= 64 ? 0 : (h >> (clear - 32)) << (clear - 32);
          } else {
            l = (l >> clear) << clear;
          }
          if (sh >= 32) h |= (u64)d << (sh - 32); else l |= (unsigned)d << sh;
          klh = h; kll = l;
          if (sh >= 32) {
            l = ~0u;
            if (sh > 32) h |= (1ull << (sh - 32)) - 1;
          } else {
            l |= (1u << sh) - 1;
          }
          khh = h; khl = l;
          base_s = nbase;
          count_s = cnt_s[d];
        }
      }
    }
    __syncthreads();
    if (done_s) return firstl;
  }
  const int k = count_s;
  const int got = block_compact(0, N, ratio, [&](int64_t j, double r) {
    u64 h;
    return cand(j, r, &h);
  }, sm.okey, sm.oidx, CAP, wsum);
  if (got != k) __trap();
  const int* sorted;
  const int pos = sort_and_walk(k, sm.okey, sm.oidx, sm.whist, sm.wcnt, cost,
                                base_s, thr, pos_s, &sorted);
  return pos < 0 ? (long long)firstl : (long long)sorted[pos];
}

__global__ void __launch_bounds__(GRID_THREADS)
bfrt_grid_walk(const double* __restrict__ ratio,
               const double* __restrict__ cost, int64_t N, void* work,
               long long* __restrict__ q_out, bool* __restrict__ hc_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int wsum[32], pos_s;
  const int G = gridDim.x, nw = blockDim.x >> 5;
  Scratch sc(work, G);
  const Cross cr = sc.w->cr;
  Smem sm(smem_raw, nw, NDIG, CAP);
  long long q;
  if (cr.k <= CAP) {
    int64_t b0, b1;
    slice(N, &b0, &b1);
    const int off = sc.offs[blockIdx.x];
    const int mine = sc.pcnt[(size_t)blockIdx.x * NBK + cr.bidx];
    const int got = block_compact(b0, b1, ratio, [&](int64_t, double r) {
      return in_bucket(r, cr.lo, cr.hi);
    }, sc.ckey + off, sc.cidx + off, mine, wsum);
    if (got != mine) __trap();
    if (!last_block(&sc.w->ticket[1])) return;
    for (int i = threadIdx.x; i < cr.k; i += blockDim.x) {
      sm.okey[i] = __ldcg(sc.ckey + i);
      sm.oidx[i] = __ldcg(sc.cidx + i);
    }
    if (threadIdx.x == 0) sc.w->ticket[1] = 0;
    __syncthreads();
    const int* sorted;
    const int pos = sort_and_walk(cr.k, sm.okey, sm.oidx, sm.whist, sm.wcnt,
                                  cost, cr.base, cr.thr, &pos_s, &sorted);
    q = cr.k == 0 ? 0 : sorted[pos < 0 ? 0 : pos];
  } else {
    if (blockIdx.x != 0) return;
    q = refine(ratio, cost, N, cr, sm, wsum, &pos_s);
  }
  if (threadIdx.x == 0) {
    q_out[0] = q;
    hc_out[0] = cr.has_cross;
  }
}

__global__ void bfrt_grid_flips(const double* __restrict__ ratio, int64_t N,
                                const void* work,
                                const long long* __restrict__ q_out,
                                bool* __restrict__ flips) {
  const Cross& cr = static_cast<const Work*>(work)->cr;
  const double lo = cr.lo, hi = cr.hi;
  const long long q = q_out[0];
  const double rq = ratio[q];
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < N;
       j += (int64_t)gridDim.x * blockDim.x)
    write_flip(j, ratio, lo, hi, rq, q, flips);
}

// pricing.ratio_range_plain(ratio) into out[0..1]: the finite ratios' min
// (NaN without one) and their max taken with 0 where a ratio is not finite
__global__ void bfrt_range(const double* __restrict__ ratio, int64_t N,
                           double* __restrict__ out) {
  __shared__ double mn_s[32], mx_s[32];
  __shared__ int any_s[32];
  double mn = INFINITY, mx = -INFINITY;
  int any = 0;
  for (int64_t j = threadIdx.x; j < N; j += blockDim.x) {
    const double r = ratio[j];
    const bool fin = isfinite(r);
    any |= fin;
    if (fin) mn = fmin(mn, r);
    mx = fmax(mx, fin ? r : 0.0);
  }
  for (int o = 16; o; o >>= 1) {
    mn = fmin(mn, __shfl_xor_sync(FULL, mn, o));
    mx = fmax(mx, __shfl_xor_sync(FULL, mx, o));
    any |= __shfl_xor_sync(FULL, any, o);
  }
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (lane == 0) { mn_s[w] = mn; mx_s[w] = mx; any_s[w] = any; }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int v = 1; v < (int)(blockDim.x >> 5); ++v) {
      mn = fmin(mn, mn_s[v]);
      mx = fmax(mx, mx_s[v]);
      any |= any_s[v];
    }
    out[0] = any ? mn : (double)NAN;
    out[1] = mx;
  }
}

extern "C" void bfrt_select_limits(int64_t* out) {
  out[0] = ONE_MAX;
  out[1] = CAP;
  out[2] = NBK;
}

extern "C" int64_t bfrt_select_work_bytes(int64_t N) {
  return N > ONE_MAX ? (int64_t)Scratch::bytes(grid_blocks(N)) : 0;
}

// once per process and card: the dynamic shared memory the select's
// blocks ask for
extern "C" int bfrt_select_init(void) {
  cudaFuncSetAttribute(bfrt_select_one,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_bytes(ONE_THREADS / 32, NBK, ONE_MAX));
  cudaFuncSetAttribute(bfrt_grid_walk,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_bytes(GRID_THREADS / 32, NDIG, CAP));
  return (int)cudaGetLastError();
}

// args: ratio, cost, rng (0: computed here into rng_scratch), budget, N,
// q_out (int64), flips (bool, N), has_cross (bool), work, stream,
// rng_scratch.  One launch for N <= ONE_MAX, three above (one more
// without rng).
extern "C" int bfrt_select_f64(const int64_t* args) {
  const void* const* p = reinterpret_cast<const void* const*>(args);
  const double* ratio = (const double*)p[0];
  const double* cost = (const double*)p[1];
  const double* rng = (const double*)p[2];
  const double* budget = (const double*)p[3];
  const int64_t N = args[4];
  long long* q_out = (long long*)p[5];
  bool* flips = (bool*)p[6];
  bool* hc = (bool*)p[7];
  void* work = (void*)p[8];
  cudaStream_t st = (cudaStream_t)p[9];
  if (N < 1 || N > INT_MAX) return (int)cudaErrorInvalidValue;
  if (rng == nullptr) {
    double* scratch = (double*)p[10];
    bfrt_range<<<1, 1024, 0, st>>>(ratio, N, scratch);
    rng = scratch;
  }
  if (N <= ONE_MAX) {
    bfrt_select_one<<<1, ONE_THREADS,
                      smem_bytes(ONE_THREADS / 32, NBK, pow2_at_least(N)),
                      st>>>(ratio, cost, rng, budget, (int)N, q_out, flips,
                            hc);
    return (int)cudaGetLastError();
  }
  const int G = grid_blocks(N);
  bfrt_grid_hist<<<G, GRID_THREADS, smem_bytes(GRID_THREADS / 32, NBK, 0),
                   st>>>(ratio, cost, rng, budget, N, work);
  bfrt_grid_walk<<<G, GRID_THREADS,
                   smem_bytes(GRID_THREADS / 32, NDIG, CAP), st>>>(
      ratio, cost, N, work, q_out, hc);
  int64_t fb = (N + GRID_THREADS - 1) / GRID_THREADS;
  bfrt_grid_flips<<<(unsigned)(fb > 1024 ? 1024 : fb), GRID_THREADS, 0,
                    st>>>(ratio, N, work, q_out, flips);
  return (int)cudaGetLastError();
}
