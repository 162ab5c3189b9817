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
#include <cuda_runtime.h>
#include <stdint.h>

template <typename T>
__global__ void pricing_kernel(const T* __restrict__ A,
                               const T* __restrict__ rho,
                               const T* __restrict__ d,
                               const int32_t* __restrict__ state,
                               const T* __restrict__ lo,
                               const T* __restrict__ hi,
                               const T* __restrict__ s_ptr, T tol,
                               int64_t m, int64_t N,
                               T* __restrict__ alpha, T* __restrict__ ratio,
                               T* __restrict__ cost) {
  extern __shared__ unsigned char smem_raw[];
  T* rho_s = reinterpret_cast<T*>(smem_raw);
  for (int64_t i = threadIdx.x; i < m; i += blockDim.x) rho_s[i] = rho[i];
  __syncthreads();
  const T s = *s_ptr;
  const T inf = (T)INFINITY;
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
  }
}

template <typename T>
static int launch(const void* A, const void* rho, const void* d,
                  const void* state, const void* lo, const void* hi,
                  const void* s, double tol, int64_t m, int64_t N,
                  void* alpha, void* ratio, void* cost, void* stream) {
  const int threads = 256;
  int64_t blocks = (N + threads - 1) / threads;
  if (blocks > 65535) blocks = 65535;
  if (blocks < 1) blocks = 1;
  pricing_kernel<T><<<(unsigned)blocks, threads, m * sizeof(T),
                      (cudaStream_t)stream>>>(
      (const T*)A, (const T*)rho, (const T*)d, (const int32_t*)state,
      (const T*)lo, (const T*)hi, (const T*)s, (T)tol, m, N, (T*)alpha,
      (T*)ratio, (T*)cost);
  return (int)cudaGetLastError();
}

extern "C" int pricing_f64(const void* A, const void* rho, const void* d,
                           const void* state, const void* lo, const void* hi,
                           const void* s, double tol, int64_t m, int64_t N,
                           void* alpha, void* ratio, void* cost,
                           void* stream) {
  return launch<double>(A, rho, d, state, lo, hi, s, tol, m, N, alpha, ratio,
                        cost, stream);
}

extern "C" int pricing_f32(const void* A, const void* rho, const void* d,
                           const void* state, const void* lo, const void* hi,
                           const void* s, double tol, int64_t m, int64_t N,
                           void* alpha, void* ratio, void* cost,
                           void* stream) {
  return launch<float>(A, rho, d, state, lo, hi, s, tol, m, N, alpha, ratio,
                       cost, stream);
}
