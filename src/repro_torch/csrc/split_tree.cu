// Split-tree descent (GetGroup for a batch of tuples) for Hopper (sm_90a).
//
// Replaces the jitted lax.while_loop of
// repro/core/partitioner.py::_descend_batch_jax (not Pallas: a loop over
// tree levels, each with a masked bisection over the node's bounds, all
// rows in lockstep).  The function is the reference's: a row at a node
// takes the child selected by the count of the node's bounds b with
// b <= v (v the row's value of the node's attribute), so a NaN value goes
// left and a tie goes right; a bound-less node reads no bound; a tree
// without nodes (root < 0) gives ~root everywhere; a path longer than the
// tree's node count traps (a corrupt tree).
//
// Bound: memory (each row's k doubles read once, one int64 written).  What
// held a one-thread-a-row bisection over the tree's own arrays at 4x that
// bound is the work a level costs a row: ~12 dependent loads (attr, two
// offsets, the row's value again, ~7 bisection steps, the child), every
// one a separate load instruction on a random address.  This kernel walks
// the packed layout of kernels/split_tree.py::pack_tree (nodes breadth
// first, ids int32):
//
//   Rec   (16 B a node): meta (attr | nb << 8 | run << 31), child0,
//         child1 (nb == 1) or the node's first line (nb >= 2), first fence
//   fence (8 B): bounds 0, 8, 16, ... of each node with bounds
//   line  (64 B): bounds 8L+1 .. 8L+7 of a node (NaN past its last) in the
//         order 3, 6 | 1, 2 | 4, 5 | 7, NaN
//   kids  (32 B a line): the int32 children 8L+1 .. 8L+8
//
//   node = root                           (the row's k values in registers)
//   while node >= 0:
//     rec = records[node]; v = x[rec.attr]
//     F = how many of the node's fences are <= v       (bisection)
//     if F == 0: node = rec.child0        (v < b0, NaN, bound-less node)
//     elif nb == 1: node = rec.child1
//     else: line F-1: c0 = #{b3, b6 <= v}; c1 = #{pair 1 + c0 <= v};
//           p = 8(F-1) + 1 + 3 c0 + c1    (two 16-byte loads, not three)
//           node = run ? child0 - p : kids[line][p - 8(F-1) - 1]
//   out[r] = ~node
//
// A node whose children are the leaves ~g0, ~(g0+1), ... (every last-level
// node of a DLV or bucketing tree) is flagged "run" and its child is
// computed, not loaded.  NaN keys never count, so padding acts as +inf.
// On non-decreasing bounds free of NaN (pack_tree raises on any other
// tree) every count is the reference's bisection result.  A level so costs
// ~7 loads (1 record, log2 of the fences, 2 line) where the fences of a
// 100-bound node are 13, and a one-bound node (the KD-tree) costs 2.
//
// Each block first copies prefixes of the records, lines and fences
// (breadth first: the top of the tree) into shared memory, as many as the
// wrapper's plan gives (kernels/split_tree.py::plan: STAGE_BYTES, 40 KB,
// records first; at most the 48 KB a block has without opting in), and
// reads an index below its prefix there, above it from global memory.
// Blocks of 1,024 threads at 32 registers, two a multiprocessor: full
// occupancy with 80 KB staged, the rest of the SM's 256 KB left to L1
// (scripts/split_tree_layouts.py times no staging against the plan's).
//
// The C entry returns cudaGetLastError() after the launch.
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 1024          // threads a block
#define MIN_BLOCKS 2          // blocks an SM holds: <= 32 registers
#define LINE 8                // bounds a line
#define STAGE_MAX (48 * 1024) // dynamic shared memory a block may stage

// meta: attr (bits 0-7) | nb (bits 8-30) | run (bit 31: the children are
// the leaves ~g0, ~(g0+1), ...)
struct __align__(16) Rec {
  int32_t meta;
  int32_t child0;
  int32_t next;               // nb == 1: child1; nb >= 2: first line
  int32_t fence0;             // first fence (bounds 0, 8, 16, ... of the node)
};

template <int K>
__device__ __forceinline__ void load_row(const double* __restrict__ T,
                                         int64_t r, int vec, double* x) {
  if (K == 0) return;
  const double* p = T + r * K;
  if (K % 2 == 0 && vec) {
#pragma unroll
    for (int j = 0; j < K / 2; ++j) {
      const double2 d = __ldg(reinterpret_cast<const double2*>(p) + j);
      x[2 * j] = d.x;
      x[2 * j + 1] = d.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) x[j] = __ldg(p + j);
  }
}

// the row's value of attribute a: a select over registers (K = k <= 8),
// else a load (K = 0: rows wider than 8)
template <int K>
__device__ __forceinline__ double pick(const double* x,
                                       const double* __restrict__ T,
                                       int64_t r, int64_t k, int a) {
  if (K == 0) return __ldg(T + r * k + a);
  double v = x[0];
#pragma unroll
  for (int j = 1; j < K; ++j) v = (a == j) ? x[j] : v;
  return v;
}

template <int K>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
split_tree_descend(const double* __restrict__ T, int64_t m, int64_t k,
                   int vec, const Rec* __restrict__ g_rec,
                   const double* __restrict__ g_fence,
                   const double2* __restrict__ g_line,
                   const int32_t* __restrict__ g_kid, int root,
                   int num_nodes, int ns_rec, int ns_fence, int ns_line,
                   int64_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  Rec* s_rec = reinterpret_cast<Rec*>(smem);
  double2* s_line = reinterpret_cast<double2*>(smem + ns_rec * sizeof(Rec));
  double* s_fence = reinterpret_cast<double*>(s_line + (size_t)ns_line *
                                                         (LINE / 2));
  {
    const int4* src = reinterpret_cast<const int4*>(g_rec);
    int4* dst = reinterpret_cast<int4*>(s_rec);
    for (int i = threadIdx.x; i < ns_rec; i += THREADS)
      dst[i] = __ldg(src + i);
    src = reinterpret_cast<const int4*>(g_line);
    dst = reinterpret_cast<int4*>(s_line);
    for (int i = threadIdx.x; i < ns_line * (LINE / 2); i += THREADS)
      dst[i] = __ldg(src + i);
    for (int i = threadIdx.x; i < ns_fence; i += THREADS)
      s_fence[i] = __ldg(g_fence + i);
  }
  __syncthreads();

  double x[K > 0 ? K : 1];
  for (int64_t r = (int64_t)blockIdx.x * THREADS + threadIdx.x; r < m;
       r += (int64_t)gridDim.x * THREADS) {
    load_row<K>(T, r, vec, x);
    int node = root;
    int levels = 0;
    while (node >= 0) {
      if (++levels > num_nodes) __trap();
      const int4 rc = *reinterpret_cast<const int4*>(
          (node < ns_rec ? s_rec : g_rec) + node);
      const double v = pick<K>(x, T, r, k, rc.x & 0xFF);
      const int nb = (rc.x >> 8) & 0x7FFFFF;
      // bisect the node's fences (bounds 0, 8, ...): F = how many <= v
      const int nf = (nb + LINE - 1) / LINE;
      const double* fp = (rc.w + nf <= ns_fence ? s_fence : g_fence) + rc.w;
      int F = 0, hi = nf;
      while (F < hi) {
        const int mid = (F + hi) >> 1;
        if (fp[mid] <= v) F = mid + 1; else hi = mid;
      }
      if (F == 0) {             // v < b0, a NaN, or a bound-less node
        node = rc.y;
        continue;
      }
      if (nb == 1) {
        node = rc.z;
        continue;
      }
      // line F-1 (its bound 0 is that fence, <= v): bounds 3 and 6 pick a
      // third of the counts 1..8, the pair of that third decides
      const int li = rc.z + F - 1;
      const double2* ln =
          (li < ns_line ? s_line : g_line) + (size_t)li * (LINE / 2);
      const double2 q0 = ln[0];
      const int c0 = (q0.x <= v) + (q0.y <= v);
      const double2 q1 = ln[1 + c0];
      const int cnt = 1 + 3 * c0 + (q1.x <= v) + (q1.y <= v);
      if (rc.x < 0) {
        node = rc.y - (LINE * (F - 1) + cnt);        // ~(g0 + p)
      } else {
        node = __ldg(g_kid + (size_t)li * LINE + cnt - 1);
      }
    }
    out[r] = ~(int64_t)node;
  }
}

typedef void (*Kernel)(const double*, int64_t, int64_t, int, const Rec*,
                       const double*, const double2*, const int32_t*, int,
                       int, int, int, int, int64_t*);

static Kernel kernel_for(int64_t k) {
  switch (k) {
    case 1: return split_tree_descend<1>;
    case 2: return split_tree_descend<2>;
    case 3: return split_tree_descend<3>;
    case 4: return split_tree_descend<4>;
    case 5: return split_tree_descend<5>;
    case 6: return split_tree_descend<6>;
    case 7: return split_tree_descend<7>;
    case 8: return split_tree_descend<8>;
    default: return split_tree_descend<0>;
  }
}

// ns_rec records, ns_fence fences and ns_line lines staged a block, at
// most STAGE_MAX bytes (else cudaErrorInvalidValue)
extern "C" int split_tree_f64(const void* T, int64_t m, int64_t k,
                              int64_t vec, const void* recs,
                              const void* fences, const void* lines,
                              const void* kids, int64_t root,
                              int64_t num_nodes, int64_t ns_rec,
                              int64_t ns_fence, int64_t ns_line, void* out,
                              void* stream) {
  const int64_t smem = ns_rec * (int64_t)sizeof(Rec) +
                       (ns_line * LINE + ns_fence) * 8;
  if (smem > STAGE_MAX) return (int)cudaErrorInvalidValue;
  if (m > 0) {
    Kernel kern = kernel_for(k);
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    int64_t blocks = (m + THREADS - 1) / THREADS;
    const int64_t most = (int64_t)sms * MIN_BLOCKS;   // grid-stride beyond
    if (blocks > most) blocks = most;
    kern<<<(unsigned)blocks, THREADS, (size_t)smem, (cudaStream_t)stream>>>(
        (const double*)T, m, k, (int)vec, (const Rec*)recs,
        (const double*)fences, (const double2*)lines, (const int32_t*)kids,
        (int)root, (int)num_nodes, (int)ns_rec, (int)ns_fence, (int)ns_line,
        (int64_t*)out);
  }
  return (int)cudaGetLastError();
}
