// Fused dual-simplex pricing for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/pricing.py::_pricing_kernel.
// For every column j of A (m x N, row-major, m tiny):
//   alpha_j = rho . A[:, j]
//   ratio_j = max(d_j / (s * alpha_j), 0) if j is BFRT-eligible, else +inf
//   cost_j  = |alpha_j| * (hi_j - lo_j)   if eligible, else 0
// with eligibility from state (0 = at lower, 1 = at upper, 2 = basic).
//
// Bound: memory.  Each column is read once (m + 4 values) and written once
// (3 values), a few flops per byte.  Design: one thread per column, a
// grid-stride loop over columns, rho staged in shared memory; because A is
// row-major, neighbouring threads read neighbouring addresses of each row
// (coalesced).  Built with -fmad=false so the dot product rounds exactly
// like the plain torch version (rho[0]*A[0] + rho[1]*A[1] + ...).
//
// The float64 route also writes the min and the max of the finite ratios
// (the max taken with 0; the min's bits all ones if there is none), from
// which the BFRT select builds its bucket edges without another pass over
// the ratios.  Every ratio is clamped at >= +0, and non-negative doubles
// order like their bit patterns as unsigned 64-bit integers: each block
// reduces its columns' bits and does one atomicMin and one atomicMax on
// the call's pair of words.  Exact and the same on every run.  The caller
// alternates between two pairs, and each launch resets the pair the next
// launch will use, so no memset precedes a launch.
//
// The C entries take one array of 64-bit words (pointers, sizes, the
// tolerance's bits, the pair), which the wrapper keeps filled between
// calls: a pivot's launch path is a few stores and a one-argument call.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

typedef unsigned long long u64;

__device__ __forceinline__ u64 warp_min(u64 x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const u64 y = __shfl_xor_sync(0xffffffffu, x, o);
    x = y < x ? y : x;
  }
  return x;
}

__device__ __forceinline__ u64 warp_max(u64 x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const u64 y = __shfl_xor_sync(0xffffffffu, x, o);
    x = y > x ? y : x;
  }
  return x;
}

template <typename T, bool RANGE>
__global__ void pricing_kernel(const T* __restrict__ A,
                               const T* __restrict__ rho,
                               const T* __restrict__ d,
                               const int32_t* __restrict__ state,
                               const T* __restrict__ lo,
                               const T* __restrict__ hi,
                               const T* __restrict__ s_ptr, T tol,
                               int64_t m, int64_t N,
                               T* __restrict__ alpha, T* __restrict__ ratio,
                               T* __restrict__ cost,
                               u64* __restrict__ range,
                               u64* __restrict__ next) {
  extern __shared__ unsigned char smem_raw[];
  T* rho_s = reinterpret_cast<T*>(smem_raw);
  for (int64_t i = threadIdx.x; i < m; i += blockDim.x) rho_s[i] = rho[i];
  __syncthreads();
  const T s = *s_ptr;
  const T inf = (T)INFINITY;
  u64 lo_bits = ~0ull, hi_bits = 0ull;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < N;
       j += (int64_t)gridDim.x * blockDim.x) {
    T acc = rho_s[0] * A[j];
    for (int64_t r = 1; r < m; ++r) acc = acc + rho_s[r] * A[r * N + j];
    const T sa = s * acc;
    const int32_t st = state[j];
    const bool nonbasic = st < 2;
    const bool at_up = st == 1;
    const bool elig = nonbasic && ((!at_up && sa > tol) || (at_up && sa < -tol));
    const T safe = fabs(sa) > tol ? sa : (T)1;
    T rt = d[j] / safe;
    rt = rt > (T)0 ? rt : (T)0;
    alpha[j] = acc;
    ratio[j] = elig ? rt : inf;
    cost[j] = elig ? fabs(acc) * (hi[j] - lo[j]) : (T)0;
    if (RANGE && elig && isfinite((double)rt)) {
      const u64 b = (u64)__double_as_longlong((double)rt);
      lo_bits = b < lo_bits ? b : lo_bits;
      hi_bits = b > hi_bits ? b : hi_bits;
    }
  }
  if constexpr (RANGE) {
    // range[0..1]: this call's min and max; next[0..1]: the next call's,
    // reset here (this call's atomics never touch them)
    __shared__ u64 wlo[32], whi[32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      next[0] = ~0ull;
      next[1] = 0ull;
    }
    lo_bits = warp_min(lo_bits);
    hi_bits = warp_max(hi_bits);
    if (lane == 0) { wlo[warp] = lo_bits; whi[warp] = hi_bits; }
    __syncthreads();
    if (warp == 0) {
      lo_bits = warp_min(lane < nw ? wlo[lane] : ~0ull);
      hi_bits = warp_max(lane < nw ? whi[lane] : 0ull);
      if (lane == 0) {
        if (lo_bits != ~0ull) atomicMin(range, lo_bits);
        if (hi_bits) atomicMax(range + 1, hi_bits);
      }
    }
  }
}

#define THREADS 256

static int64_t grid(int64_t N) {
  int64_t blocks = (N + THREADS - 1) / THREADS;
  if (blocks > 65535) blocks = 65535;
  return blocks < 1 ? 1 : blocks;
}

// args: A, rho, d, state, lo, hi, s, tol (bits), m, N, out, stream, pair.
// out holds alpha, ratio and cost (N each) and, on the float64 route, two
// pairs of range words; `pair` (0 or 1) is this call's.
template <typename T, bool RANGE>
static int launch(const int64_t* args) {
  const void* const* p = reinterpret_cast<const void* const*>(args);
  double tol;
  memcpy(&tol, args + 7, sizeof(double));
  const int64_t m = args[8], N = args[9];
  T* out = (T*)p[10];
  u64* pairs = RANGE ? (u64*)(out + 3 * N) : nullptr;
  const int64_t pair = args[12];
  pricing_kernel<T, RANGE><<<(unsigned)grid(N), THREADS, m * sizeof(T),
                             (cudaStream_t)p[11]>>>(
      (const T*)p[0], (const T*)p[1], (const T*)p[2], (const int32_t*)p[3],
      (const T*)p[4], (const T*)p[5], (const T*)p[6], (T)tol, m, N, out,
      out + N, out + 2 * N, RANGE ? pairs + 2 * pair : nullptr,
      RANGE ? pairs + 2 * (1 - pair) : nullptr);
  return (int)cudaGetLastError();
}

extern "C" int pricing_f64(const int64_t* args) {
  return launch<double, true>(args);
}

extern "C" int pricing_f32(const int64_t* args) {
  return launch<float, false>(args);
}
