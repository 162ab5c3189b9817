// Split-tree descent, one thread a row bisecting the tree's own arrays:
// the kernel that the packed walk of csrc/split_tree.cu replaced, kept as
// its baseline.  No path of the port runs it; chip_smoke.py and
// scripts/split_tree_layouts.py time it beside the packed walk on the
// same rows in the same run (kernels/split_tree.py::descend_batch_bisect).
// Every row descends on its own:
//
//   node = root
//   while node >= 0:
//     v = T[r, attr[node]]
//     bisect bounds[bound_off[node] : bound_off[node + 1]] for the first
//       bound with !(bound <= v)   (exactly the reference's comparison, so
//       a NaN value and a value equal to a bound fall as there)
//     node = children[node + lo]   (lo absolute: the child base is
//                                   bound_off[node] + node)
//   out[r] = ~node                 (leaves are stored as ~gid)
//
// A node without bounds (lo == hi, the merged single-bucket tree) reads no
// bound at all; a tree without nodes (root < 0) writes ~root everywhere.  A
// valid tree visits each node at most once on a path, so a descent longer
// than the tree's node count is a corrupt tree: the kernel traps instead
// of spinning.
//
// Bound: memory.  Each row is read once (k doubles, one 32-byte sector at
// k = 4) and one int64 written; the tree (attr, bound_off, bounds,
// children: at most a few MB) stays in L2.  Design: one thread a row, a
// grid-stride loop, no shared memory and no synchronisation; lockstep
// masks are not needed because a thread stops at its own leaf.
//
// The C entry returns cudaGetLastError() after the launch.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void split_tree_bisect(const double* __restrict__ T, int64_t m,
                                  int64_t k,
                                  const int32_t* __restrict__ attr,
                                  const int64_t* __restrict__ bound_off,
                                  const double* __restrict__ bounds,
                                  const int64_t* __restrict__ children,
                                  int64_t root, int64_t num_nodes,
                                  int64_t* __restrict__ out) {
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < m;
       r += (int64_t)gridDim.x * blockDim.x) {
    const double* row = T + r * k;
    int64_t node = root;
    int64_t levels = 0;
    while (node >= 0) {
      if (++levels > num_nodes) __trap();
      const double v = row[attr[node]];
      int64_t lo = bound_off[node], hi = bound_off[node + 1];
      while (lo < hi) {
        const int64_t mid = (lo + hi) >> 1;
        if (bounds[mid] <= v) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      node = children[node + lo];
    }
    out[r] = ~node;
  }
}

extern "C" int split_tree_bisect_f64(const void* T, int64_t m, int64_t k,
                                     const void* attr,
                                     const void* bound_off,
                                     const void* bounds,
                                     const void* children, int64_t root,
                                     int64_t num_nodes, void* out,
                                     void* stream) {
  if (m > 0) {
    // grid-stride: at most 16 blocks of 256 threads an SM of an H100
    const int threads = 256;
    const int64_t max_blocks = 132 * 16;
    int64_t blocks = (m + threads - 1) / threads;
    if (blocks > max_blocks) blocks = max_blocks;
    split_tree_bisect<<<(unsigned)blocks, threads, 0,
                        (cudaStream_t)stream>>>(
        (const double*)T, m, k, (const int32_t*)attr,
        (const int64_t*)bound_off, (const double*)bounds,
        (const int64_t*)children, root, num_nodes, (int64_t*)out);
  }
  return (int)cudaGetLastError();
}
