// Segment statistics for Hopper (sm_90a): per-group count, sum and sum of
// squares of an (n, k) float64 block under SORTED group ids.
//
// Replaces the Pallas TPU kernel repro/kernels/segstats.py::_segstats_kernel
// (float32 one-hot matmuls) with the contract of its exact float64 host
// twin segment_stats_np.
//
// Bound: memory (n*k*8 + n*8 bytes read once).  Design: tiled by rows, not
// by group -- the first DLV round has one group spanning every row, and a
// block per group would run it serially.  Each thread owns a CHUNK of
// consecutive rows and walks them in order, closing a run at every id
// change.  A run that starts and ends inside the chunk is written straight
// to its group (no other thread touches that group).  A run cut by a chunk
// edge leaves a partial: "cont" for the piece that continues the previous
// chunk's run, "open" for the piece that starts here and runs past the end.
// A second launch lets the owner of each open piece add the following
// chunks' cont pieces in chunk order.  No atomics: the result is
// bit-identical from run to run, which the DLV build relies on (the child
// stats steer split selection).
#include <cuda_runtime.h>
#include <stdint.h>

#define CHUNK 128
#define THREADS 128

template <int K>
__device__ __forceinline__ void put(double* cnt, double* sum, double* sq,
                                    int64_t slot, double n, const double* s,
                                    const double* q) {
  cnt[slot] = n;
  for (int c = 0; c < K; ++c) {
    sum[slot * K + c] = s[c];
    sq[slot * K + c] = q[c];
  }
}

template <int K>
__global__ void segstats_pass1(const double* __restrict__ vals,
                               const int64_t* __restrict__ ids, int64_t n,
                               int64_t nchunks, double* __restrict__ cnt,
                               double* __restrict__ sum,
                               double* __restrict__ sq,
                               int64_t* __restrict__ cont_id,
                               double* __restrict__ cont_cnt,
                               double* __restrict__ cont_sum,
                               double* __restrict__ cont_sq,
                               int64_t* __restrict__ open_id,
                               double* __restrict__ open_cnt,
                               double* __restrict__ open_sum,
                               double* __restrict__ open_sq) {
  const int64_t ch = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= nchunks) return;
  const int64_t s0 = ch * CHUNK;
  const int64_t e0 = s0 + CHUNK < n ? s0 + CHUNK : n;
  cont_id[ch] = -1;
  open_id[ch] = -1;
  int64_t a = s0;
  while (a < e0) {
    const int64_t g = ids[a];
    double ps[K], pq[K], pn = 0.0;
    for (int c = 0; c < K; ++c) ps[c] = pq[c] = 0.0;
    int64_t b = a;
    for (; b < e0 && ids[b] == g; ++b) {
      const double* row = vals + b * K;
      for (int c = 0; c < K; ++c) {
        const double x = row[c];
        ps[c] += x;
        pq[c] += x * x;
      }
      pn += 1.0;
    }
    const bool is_cont = (a == s0) && (s0 > 0) && (ids[s0 - 1] == g);
    const bool runs_on = (b == e0) && (e0 < n) && (ids[e0] == g);
    if (is_cont) {
      cont_id[ch] = g;
      put<K>(cont_cnt, cont_sum, cont_sq, ch, pn, ps, pq);
    } else if (runs_on) {
      open_id[ch] = g;
      put<K>(open_cnt, open_sum, open_sq, ch, pn, ps, pq);
    } else {
      put<K>(cnt, sum, sq, g, pn, ps, pq);
    }
    a = b;
  }
}

template <int K>
__global__ void segstats_merge(int64_t nchunks,
                               const int64_t* __restrict__ cont_id,
                               const double* __restrict__ cont_cnt,
                               const double* __restrict__ cont_sum,
                               const double* __restrict__ cont_sq,
                               const int64_t* __restrict__ open_id,
                               const double* __restrict__ open_cnt,
                               const double* __restrict__ open_sum,
                               const double* __restrict__ open_sq,
                               double* __restrict__ cnt,
                               double* __restrict__ sum,
                               double* __restrict__ sq) {
  const int64_t ch = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= nchunks) return;
  const int64_t g = open_id[ch];
  if (g < 0) return;
  double ps[K], pq[K], pn = open_cnt[ch];
  for (int c = 0; c < K; ++c) {
    ps[c] = open_sum[ch * K + c];
    pq[c] = open_sq[ch * K + c];
  }
  for (int64_t c2 = ch + 1; c2 < nchunks && cont_id[c2] == g; ++c2) {
    pn += cont_cnt[c2];
    for (int c = 0; c < K; ++c) {
      ps[c] += cont_sum[c2 * K + c];
      pq[c] += cont_sq[c2 * K + c];
    }
  }
  put<K>(cnt, sum, sq, g, pn, ps, pq);
}

extern "C" int64_t segstats_nchunks(int64_t n) {
  return (n + CHUNK - 1) / CHUNK;
}

template <int K>
static int run(const void* vals, const void* ids, int64_t n, void* cnt,
               void* sum, void* sq, void* scratch_i, void* scratch_f,
               cudaStream_t st) {
  const int64_t nch = segstats_nchunks(n);
  if (nch == 0) return (int)cudaGetLastError();
  int64_t* cont_id = (int64_t*)scratch_i;
  int64_t* open_id = cont_id + nch;
  double* f = (double*)scratch_f;          // 2 * nch * (1 + 2K) doubles
  double* cont_cnt = f;
  double* cont_sum = cont_cnt + nch;
  double* cont_sq = cont_sum + nch * K;
  double* open_cnt = cont_sq + nch * K;
  double* open_sum = open_cnt + nch;
  double* open_sq = open_sum + nch * K;
  const unsigned blocks = (unsigned)((nch + THREADS - 1) / THREADS);
  segstats_pass1<K><<<blocks, THREADS, 0, st>>>(
      (const double*)vals, (const int64_t*)ids, n, nch, (double*)cnt,
      (double*)sum, (double*)sq, cont_id, cont_cnt, cont_sum, cont_sq,
      open_id, open_cnt, open_sum, open_sq);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  segstats_merge<K><<<blocks, THREADS, 0, st>>>(
      nch, cont_id, cont_cnt, cont_sum, cont_sq, open_id, open_cnt, open_sum,
      open_sq, (double*)cnt, (double*)sum, (double*)sq);
  return (int)cudaGetLastError();
}

// cnt (G,), sum/sq (G, k) must be zero-filled by the caller (groups with
// no rows keep 0); scratch_i: 2*nchunks int64, scratch_f: 2*nchunks*(1+2k)
// doubles.  k in 1..8.
extern "C" int segstats_f64(const void* vals, const void* ids, int64_t n,
                            int64_t k, void* cnt, void* sum, void* sq,
                            void* scratch_i, void* scratch_f, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (k) {
    case 1: return run<1>(vals, ids, n, cnt, sum, sq, scratch_i, scratch_f, st);
    case 2: return run<2>(vals, ids, n, cnt, sum, sq, scratch_i, scratch_f, st);
    case 3: return run<3>(vals, ids, n, cnt, sum, sq, scratch_i, scratch_f, st);
    case 4: return run<4>(vals, ids, n, cnt, sum, sq, scratch_i, scratch_f, st);
    case 5: return run<5>(vals, ids, n, cnt, sum, sq, scratch_i, scratch_f, st);
    case 6: return run<6>(vals, ids, n, cnt, sum, sq, scratch_i, scratch_f, st);
    case 7: return run<7>(vals, ids, n, cnt, sum, sq, scratch_i, scratch_f, st);
    case 8: return run<8>(vals, ids, n, cnt, sum, sq, scratch_i, scratch_f, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
