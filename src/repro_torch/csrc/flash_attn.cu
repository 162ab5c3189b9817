// Flash attention for Hopper (sm_90a): causal / sliding-window / full
// attention with an online softmax, forward only.
//
// Replaces the Pallas TPU kernel repro/kernels/attention.py::_flash_kernel
// (and the GQA expansion of repro/kernels/ops.py::flash_attention_op).
//
// out[b, i, h, :] = softmax_j(q_i . k_j * scale + mask_ij) . v_j, with the
// softmax state (m, l, acc) in float32.  As in the reference, q is cast to
// float32 and multiplied by `scale` before the dot, and the output is
// acc / max(l, 1e-30).  mask: causal (i >= j) with an optional window
// (i - j < window), or full (window alone, or nothing).
//
// Layout: the model's own, q/o (B, S, H, HD) and k/v (B, S, KV, HD), read in
// place; query head h reads KV head h / (H / KV).
//
// Bound: at the shapes of LM prefill (S in the thousands, HD = 128) the
// work is 4*HD flops per unmasked (i, j) pair against 2*HD*(2H + 2KV)/H
// bytes per row, so the tensor cores' rate bounds it, not memory.  This
// first design is simple and right, not fast: scores and the softmax
// update run in float32 on the CUDA cores, which caps it far below that
// bound (wgmma/TMA and warp specialisation are later work).  What it does
// do: one block per (batch x head, 64-row query tile), the heaviest causal
// tiles launched first; K/V tiles of 64 rows staged through shared memory
// as float32 (rows padded to an odd stride, so the 16 threads reading 16
// key rows hit 16 banks); each thread keeps a 4 x 4 tile of scores and a
// 4 x HD/16 tile of the accumulator in registers; KV tiles wholly above
// the diagonal or outside the window are never visited; any S (the ragged
// edge is masked).  P reuses the K tile's shared memory, so a block needs
// ~99 KB at HD = 128 and two blocks fit on an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define BQ 64
#define BK 64
#define THREADS 256
#define NEG_INF (-1e30f)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as astype does
}

template <int HD>
constexpr size_t smem_floats() {
  return (size_t)BQ * (HD + 1) + (size_t)BK * (HD + 1) + (size_t)BK * HD;
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 2)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int S, int H,
                     int KV, int causal, int window, float scale, int n_qt) {
  constexpr int LD = HD + 1;            // padded row of the Q and K tiles
  constexpr int PLD = BK + 1;           // padded row of P
  constexpr int NC = (HD + 15) / 16;    // accumulator columns per thread
  static_assert(BK * LD >= BQ * PLD, "P must fit in the K tile");
  extern __shared__ float smem[];
  float* Qs = smem;                     // BQ x LD, scaled q
  float* Ks = Qs + BQ * LD;             // BK x LD, then P (BQ x PLD)
  float* Vs = Ks + BK * LD;             // BK x HD
  float* Ps = Ks;

  const int tid = threadIdx.x;
  const int tx = tid & 15;              // key columns tx + 16j, acc cols
  const int ty = tid >> 4;              // query rows 4ty .. 4ty+3
  const int qt = n_qt - 1 - (int)blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int kvh = h / (H / KV);
  const int q0 = qt * BQ;
  const int64_t qrow = (int64_t)H * HD, krow = (int64_t)KV * HD;
  const T* qb = q + (int64_t)b * S * qrow + (int64_t)h * HD;
  const T* kb = k + (int64_t)b * S * krow + (int64_t)kvh * HD;
  const T* vb = v + (int64_t)b * S * krow + (int64_t)kvh * HD;
  T* ob = o + (int64_t)b * S * qrow + (int64_t)h * HD;

  for (int e = tid; e < BQ * HD; e += THREADS) {
    const int r = e / HD, c = e - r * HD;
    const int qi = q0 + r;
    Qs[r * LD + c] = qi < S ? to_f(qb[(int64_t)qi * qrow + c]) * scale : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // KV tiles that hold at least one key some row of this tile attends
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(S, q0 + BQ) : S;
  const int kt_lo = k_lo / BK, kt_hi = (k_hi + BK - 1) / BK;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                    // Q staged / last tile's P, V read
    for (int e = tid; e < BK * HD; e += THREADS) {
      const int r = e / HD, c = e - r * HD;
      const int ki = k0 + r;
      const bool in = ki < S;
      Ks[r * LD + c] = in ? to_f(kb[(int64_t)ki * krow + c]) : 0.f;
      Vs[r * HD + c] = in ? to_f(vb[(int64_t)ki * krow + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(4 * ty + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

    // online softmax; a row's 64 scores live on the 16 lanes of one
    // half-warp (same ty), so shuffles within 16 lanes reduce them
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + 4 * ty + i;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ki = k0 + tx + 16 * j;
        ok[j] = ki < S && (!causal || qi >= ki) &&
                (window <= 0 || qi - ki < window);
        if (!ok[j]) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        ps += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * corr + ps;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }

    __syncthreads();                    // every thread is done with K
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ps[(4 * ty + i) * PLD + tx + 16 * j] = s[i][j];
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pa[4], va[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = Ps[(4 * ty + i) * PLD + c];
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const int col = tx + 16 * cc;
        va[cc] = col < HD ? Vs[c * HD + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int cc = 0; cc < NC; ++cc)
          acc[i][cc] = fmaf(pa[i], va[cc], acc[i][cc]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    if (qi >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int col = tx + 16 * cc;
      if (col < HD) store(&ob[(int64_t)qi * qrow + col], acc[i][cc] / denom);
    }
  }
}

template <typename T, int HD>
static int launch(const void* q, const void* k, const void* v, void* o,
                  int64_t B, int64_t S, int64_t H, int64_t KV, int causal,
                  int window, float scale, cudaStream_t st) {
  const size_t smem = smem_floats<HD>() * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_qt = (int)((S + BQ - 1) / BQ);
  const dim3 grid((unsigned)n_qt, (unsigned)(B * H));
  flash_fwd_kernel<T, HD><<<grid, THREADS, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (int)S, (int)H, (int)KV,
      causal, window, scale, n_qt);
  return (int)cudaGetLastError();
}

template <typename T>
static int by_hd(const void* q, const void* k, const void* v, void* o,
                 int64_t B, int64_t S, int64_t H, int64_t KV, int64_t hd,
                 int causal, int window, float scale, cudaStream_t st) {
  switch (hd) {
    case 64:
      return launch<T, 64>(q, k, v, o, B, S, H, KV, causal, window, scale, st);
    case 120:
      return launch<T, 120>(q, k, v, o, B, S, H, KV, causal, window, scale,
                            st);
    case 128:
      return launch<T, 128>(q, k, v, o, B, S, H, KV, causal, window, scale,
                            st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// q/o (B, S, H, hd), k/v (B, S, KV, hd), contiguous, one dtype: bf16 when
// is_bf16, else float32.  hd in {64, 120, 128}; H % KV == 0; window <= 0
// means none.  Launches on `stream`, allocates nothing, does not
// synchronise; returns cudaGetLastError().
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, int64_t B, int64_t S, int64_t H,
                              int64_t KV, int64_t hd, int64_t causal,
                              int64_t window, double scale, int64_t is_bf16,
                              void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaSuccess;
  if (KV <= 0 || H % KV != 0 || B * H > 65535 || S > (int64_t)1 << 30)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int w = window > 0 ? (int)window : 0;
  if (is_bf16)
    return by_hd<__nv_bfloat16>(q, k, v, o, B, S, H, KV, hd, (int)causal, w,
                                (float)scale, st);
  return by_hd<float>(q, k, v, o, B, S, H, KV, hd, (int)causal, w,
                      (float)scale, st);
}
