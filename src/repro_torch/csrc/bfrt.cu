// BFRT bucketed histogram for Hopper (sm_90a): pass 1 of the bound-flipping
// ratio test.
//
// Replaces the Pallas TPU kernel repro/kernels/bfrt.py::_bfrt_hist_kernel.
// For every finite ratio_j, bucket b = first b with ratio_j <= edges[b]
// (edges ascending, last = +inf); per bucket: sum of cost_j and count.
//
// Bound: memory (ratio and cost read once, 16 bytes per column).  The TPU
// kernel summed a one-hot matmul in float32; here sums are float64 and
// deterministic: no atomics anywhere.  Each block walks tiles of TILE
// columns (grid-stride, fixed grid for a given N); a tile's bucket ids and
// costs are staged in shared memory, then thread b (one per bucket) adds
// the tile's entries of bucket b in index order into a register.  Block
// partials go to an (nblocks, NB) buffer that a second launch reduces in
// block order, so two runs give bit-identical sums.
#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

#define TILE 1024
#define THREADS 256
#define MAX_NB 1024

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
