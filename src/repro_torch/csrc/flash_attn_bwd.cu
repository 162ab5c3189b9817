// Flash attention backward for Hopper (sm_90a): the gradients dQ, dK and dV
// of csrc/flash_attn.cu's forward, for every (q/k head_dim, v head_dim)
// pair, dtype and mask it takes, from the forward's output O and its
// per-row log-sum-exp LSE.
//
// Replaces no TPU kernel: the reference's Pallas flash kernel
// (src/repro/kernels/attention.py:32) has no backward, and the reference
// trains through its jnp chunked scan (repro/models/attention.py::
// chunked_attention), which JAX differentiates.  This is the
// FlashAttention-2 backward (Dao, 2023) in three kernels:
//
//   flash_bwd_dot   D[b, h, i] = sum_c dO[b, i, h, c] * O[b, i, h, c];
//   flash_bwd_dkdv  one block per (64-key tile, batch, KV head): the K and V
//                   tiles stay in shared memory while the block walks every
//                   query tile that attends them, for each of the H / KV
//                   query heads that share the KV head, and accumulates
//                   dK and dV in registers:
//                     P  = exp(scale * Q K^T - LSE), masked,
//                     dV += P^T dO,   dP = dO V^T,   dS = P * (dP - D),
//                     dK += scale * dS^T Q;
//   flash_bwd_dq    one block per (query tile, batch, head): the Q and dO
//                   tiles stay while the block walks the KV tiles the
//                   tile attends, recomputes S and dP, and accumulates
//                   dQ += scale * dS K.
//
// No atomics: each output element is summed inside one block in a fixed
// order, so GQA's sum over the heads of a group is deterministic.  Both
// main kernels visit exactly the tiles the forward's mask admits (causal,
// window, prefix-LM, full; Sq != Sk in a full call) and mask each element
// by the forward's rule: key j is attended by query i when j < prefix, or
// when the call is full, or when i >= j and, with a window, i - j < window.
//
// Bound: at the train cell's attention (B = 4, S = 4,096, 12 query and 2
// KV heads, (128, 128), bf16, causal) a backward does 2 (3 hd + 2 hdv)
// FLOP a kept (query, key) pair -- S, dP, dV, dK and dQ, without the dq
// kernel's recompute of S and dP -- 5.2e11 FLOP against 236 MB (q, k, v,
// O, dO, the three gradients, LSE and D), so the tensor cores' 989
// TFLOP/s bound it (0.52 ms), not memory.  This first version does
// all of it on the CUDA cores in float32 (67 TFLOP/s at most, and the
// recompute adds 4 hd FLOP a pair), a simple kernel that is right; wgmma
// tiles are later work.  Design: 256 threads as 16 x 16; every product
// is a 4 x 4 (or 2 x 4) register tile over float32 tiles in shared memory
// whose rows are padded to an odd stride, so the 16 lanes that read 16
// rows hit 16 banks; bf16 inputs are widened once as they are staged;
// each output is rounded once from its float32 accumulator into the input
// dtype.  Head dims are compiled at 64, 128, 192 and 256 (HQ, HV); 120
// runs the (128, 128) kernels with its columns 120..127 staged as zeros,
// which add nothing to any product.  Query tiles are 64 rows, 32 where
// HQ + HV > 320 ((256, 256)), so that every block's tiles fit the 227 KB
// of shared memory: at (256, 256) 214,272 bytes (dK/dV) and 205,952 (dQ).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BK = 64;            // keys per tile

template <int HQ, int HV>
struct Tile {
  static constexpr int BQ = HQ + HV > 320 ? 32 : 64;   // query rows a tile
  static constexpr int RQ = BQ / 16;    // query rows a thread owns
  static constexpr int LQ = HQ + 1;     // padded rows of the q/k tiles
  static constexpr int LV = HV + 1;     // ... of the v/dO tiles
  static constexpr int LP = BK + 1;     // ... of P and dS
  // dK/dV: K and V tiles, Q and dO tiles, P and dS, LSE and D
  static constexpr int DKDV_FLOATS =
      BK * (LQ + LV) + BQ * (LQ + LV) + 2 * BQ * LP + 2 * BQ;
  // dQ: Q and dO tiles, K and V tiles, dS, LSE and D
  static constexpr int DQ_FLOATS =
      BQ * (LQ + LV) + BK * (LQ + LV) + BQ * LP + 2 * BQ;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// rows r0 .. r0 + R - 1 of a (.., S, heads, width) tensor at one head
// (`base` at row 0, rows `stride` elements apart) into a float32 tile of
// row stride L, W columns wide: zeros past S and past `width`
template <int R, int W, int L, typename T>
__device__ __forceinline__ void stage(float* dst, const T* base,
                                      int64_t stride, int r0, int S,
                                      int width) {
  for (int e = threadIdx.x; e < R * W; e += THREADS) {
    const int r = e / W, c = e - r * W;
    const int i = r0 + r;
    dst[r * L + c] =
        i < S && c < width ? ld(base + (int64_t)i * stride + c) : 0.f;
  }
}

// LSE and D of rows r0 .. r0 + R - 1 (zeros past Sq)
template <int R>
__device__ __forceinline__ void stage_rows(float* Ls, float* Ds,
                                           const float* lse, const float* D,
                                           int r0, int Sq) {
  for (int r = threadIdx.x; r < R; r += THREADS) {
    const int i = r0 + r;
    Ls[r] = i < Sq ? lse[i] : 0.f;
    Ds[r] = i < Sq ? D[i] : 0.f;
  }
}

__device__ __forceinline__ bool attends(int qi, int ki, int Sq, int Sk,
                                        int causal, int window, int prefix) {
  return qi < Sq && ki < Sk &&
         (ki < prefix ||
          ((!causal || qi >= ki) && (window <= 0 || qi - ki < window)));
}

// P and dS for query rows RQ * ty + i of the Q/dO tiles and keys tx + 16 j
// of the K/V tiles: S = q . k and dP = dO . v from shared memory, then
// P = exp(scale * S - LSE) where the mask admits the pair, else 0, and
// dS = P * (dP - D)
template <int HQ, int HV, int RQ>
__device__ __forceinline__ void probs(float (&p)[RQ][4], float (&ds)[RQ][4],
                                      const float* Qs, const float* dOs,
                                      const float* Ks, const float* Vs,
                                      const float* Ls, const float* Ds,
                                      int q0, int k0, int Sq, int Sk,
                                      int causal, int window, int prefix,
                                      float scale) {
  constexpr int LQ = HQ + 1, LV = HV + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[RQ][4], dp[RQ][4];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < HQ; ++d) {
    float a[RQ], b[4];
#pragma unroll
    for (int i = 0; i < RQ; ++i) a[i] = Qs[(RQ * ty + i) * LQ + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Ks[(tx + 16 * j) * LQ + d];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
#pragma unroll 8
  for (int c = 0; c < HV; ++c) {
    float a[RQ], b[4];
#pragma unroll
    for (int i = 0; i < RQ; ++i) a[i] = dOs[(RQ * ty + i) * LV + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Vs[(tx + 16 * j) * LV + c];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(a[i], b[j], dp[i][j]);
  }
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = RQ * ty + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = attends(q0 + r, k0 + tx + 16 * j, Sq, Sk, causal,
                              window, prefix);
      p[i][j] = ok ? expf(s[i][j] * scale - Ls[r]) : 0.f;
      ds[i][j] = p[i][j] * (dp[i][j] - Ds[r]);
    }
  }
}

}  // namespace

// D = rowsum(dO * O) in float32: one warp a (b, i, h) row of the (B, Sq,
// H, hdv) tensors, written to D (B, H, Sq)
template <typename T>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dot(const T* __restrict__ o, const T* __restrict__ dout,
                  float* __restrict__ D, int64_t rows, int Sq, int H,
                  int hdv) {
  const int64_t row =
      (int64_t)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* op = o + row * hdv;
  const T* dp = dout + row * hdv;
  float acc = 0.f;
  for (int c = lane; c < hdv; c += 32)
    acc = fmaf(ld(dp + c), ld(op + c), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int64_t bi = row / H;              // b * Sq + i
    const int h = (int)(row - bi * H);
    const int64_t b = bi / Sq;
    const int i = (int)(bi - b * Sq);
    D[(b * H + h) * Sq + i] = acc;
  }
}

// dK and dV of one 64-key tile of one (batch, KV head): the block walks the
// query tiles that attend a key of the tile, for each query head of the
// group, heaviest tile first in launch order (blockIdx.x = the key tile)
template <int HQ, int HV, typename T>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ D, T* __restrict__ dk,
                   T* __restrict__ dv, int Sq, int Sk, int H, int KV, int hd,
                   int hdv, int causal, int window, int prefix,
                   float scale) {
  using C = Tile<HQ, HV>;
  constexpr int BQ = C::BQ, RQ = C::RQ, LQ = C::LQ, LV = C::LV, LP = C::LP;
  constexpr int NQ = HQ / 16, NV = HV / 16;  // accumulator columns a thread
  extern __shared__ float smem[];
  float* Ks = smem;                   // BK x LQ
  float* Vs = Ks + BK * LQ;           // BK x LV
  float* Qs = Vs + BK * LV;           // BQ x LQ
  float* dOs = Qs + BQ * LQ;          // BQ x LV
  float* Ps = dOs + BQ * LV;          // BQ x LP
  float* dSs = Ps + BQ * LP;          // BQ x LP
  float* Ls = dSs + BQ * LP;          // BQ
  float* Ds = Ls + BQ;                // BQ

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = (int)blockIdx.x * BK;
  const int b = (int)blockIdx.y / KV, kvh = (int)blockIdx.y - b * KV;
  const int G = H / KV;
  const int64_t qrow = (int64_t)H * hd, orow = (int64_t)H * hdv;
  const int64_t krow = (int64_t)KV * hd, vrow = (int64_t)KV * hdv;
  const T* kb = k + (int64_t)b * Sk * krow + (int64_t)kvh * hd;
  const T* vb = v + (int64_t)b * Sk * vrow + (int64_t)kvh * hdv;
  stage<BK, HQ, LQ>(Ks, kb, krow, k0, Sk, hd);
  stage<BK, HV, LV>(Vs, vb, vrow, k0, Sk, hdv);

  float dK[4][NQ], dV[4][NV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < NQ; ++c) dK[i][c] = 0.f;
#pragma unroll
    for (int c = 0; c < NV; ++c) dV[i][c] = 0.f;
  }

  // the query rows that attend some key of the tile: all of them in a full
  // call or where the tile starts inside the prefix; else rows k0 .. and,
  // with a window, up to k0 + BK - 1 + window
  int q_lo = 0, q_hi = Sq;
  if (causal && k0 >= prefix) {
    q_lo = k0;
    if (window > 0) q_hi = min(Sq, k0 + BK - 1 + window);
  }

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const T* qb = q + (int64_t)b * Sq * qrow + (int64_t)h * hd;
    const T* ob = dout + (int64_t)b * Sq * orow + (int64_t)h * hdv;
    const float* lb = lse + ((int64_t)b * H + h) * Sq;
    const float* db = D + ((int64_t)b * H + h) * Sq;
    for (int q0 = q_lo / BQ * BQ; q0 < q_hi; q0 += BQ) {
      __syncthreads();                // the last tile's reads are done
      stage<BQ, HQ, LQ>(Qs, qb, qrow, q0, Sq, hd);
      stage<BQ, HV, LV>(dOs, ob, orow, q0, Sq, hdv);
      stage_rows<BQ>(Ls, Ds, lb, db, q0, Sq);
      __syncthreads();
      float p[RQ][4], ds[RQ][4];
      probs<HQ, HV, RQ>(p, ds, Qs, dOs, Ks, Vs, Ls, Ds, q0, k0, Sq, Sk,
                        causal, window, prefix, scale);
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          Ps[(RQ * ty + i) * LP + tx + 16 * j] = p[i][j];
          dSs[(RQ * ty + i) * LP + tx + 16 * j] = ds[i][j];
        }
      __syncthreads();
      // keys 4 ty + i, columns tx + 16 c: dV += P^T dO, dK += dS^T Q
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float pa[4], sa[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pa[i] = Ps[r * LP + 4 * ty + i];
          sa[i] = dSs[r * LP + 4 * ty + i];
        }
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          const float o = dOs[r * LV + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) dV[i][c] = fmaf(pa[i], o, dV[i][c]);
        }
#pragma unroll
        for (int c = 0; c < NQ; ++c) {
          const float x = Qs[r * LQ + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) dK[i][c] = fmaf(sa[i], x, dK[i][c]);
        }
      }
    }
  }

  T* dkb = dk + (int64_t)b * Sk * krow + (int64_t)kvh * hd;
  T* dvb = dv + (int64_t)b * Sk * vrow + (int64_t)kvh * hdv;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ki = k0 + 4 * ty + i;
    if (ki >= Sk) continue;
#pragma unroll
    for (int c = 0; c < NQ; ++c) {
      const int col = tx + 16 * c;
      if (col < hd) st(dkb + (int64_t)ki * krow + col, dK[i][c] * scale);
    }
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int col = tx + 16 * c;
      if (col < hdv) st(dvb + (int64_t)ki * vrow + col, dV[i][c]);
    }
  }
}

// dQ of one query tile of one (batch, head): the block walks the KV tiles
// the tile attends (the forward's tile bounds); query tiles launch last
// first, the heaviest under a causal mask
template <int HQ, int HV, typename T>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ D,
                 T* __restrict__ dq, int Sq, int Sk, int H, int KV, int hd,
                 int hdv, int causal, int window, int prefix, float scale,
                 int n_qt) {
  using C = Tile<HQ, HV>;
  constexpr int BQ = C::BQ, RQ = C::RQ, LQ = C::LQ, LV = C::LV, LP = C::LP;
  constexpr int NQ = HQ / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                   // BQ x LQ
  float* dOs = Qs + BQ * LQ;          // BQ x LV
  float* Ks = dOs + BQ * LV;          // BK x LQ
  float* Vs = Ks + BK * LQ;           // BK x LV
  float* dSs = Vs + BK * LV;          // BQ x LP
  float* Ls = dSs + BQ * LP;          // BQ
  float* Ds = Ls + BQ;                // BQ

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BQ;
  const int b = (int)blockIdx.y / H, h = (int)blockIdx.y - b * H;
  const int kvh = h / (H / KV);
  const int64_t qrow = (int64_t)H * hd, orow = (int64_t)H * hdv;
  const int64_t krow = (int64_t)KV * hd, vrow = (int64_t)KV * hdv;
  const T* kb = k + (int64_t)b * Sk * krow + (int64_t)kvh * hd;
  const T* vb = v + (int64_t)b * Sk * vrow + (int64_t)kvh * hdv;
  stage<BQ, HQ, LQ>(Qs, q + (int64_t)b * Sq * qrow + (int64_t)h * hd, qrow,
                    q0, Sq, hd);
  stage<BQ, HV, LV>(dOs, dout + (int64_t)b * Sq * orow + (int64_t)h * hdv,
                    orow, q0, Sq, hdv);
  stage_rows<BQ>(Ls, Ds, lse + ((int64_t)b * H + h) * Sq,
                 D + ((int64_t)b * H + h) * Sq, q0, Sq);

  float dQ[RQ][NQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int c = 0; c < NQ; ++c) dQ[i][c] = 0.f;

  // the forward's KV tiles for this query tile
  const int k_lo = window > 0 && prefix <= 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi =
      causal ? min(Sk, prefix > 0 ? max(q0 + BQ, prefix) : q0 + BQ) : Sk;
  for (int k0 = k_lo / BK * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();                  // the last tile's reads are done
    stage<BK, HQ, LQ>(Ks, kb, krow, k0, Sk, hd);
    stage<BK, HV, LV>(Vs, vb, vrow, k0, Sk, hdv);
    __syncthreads();
    float p[RQ][4], ds[RQ][4];
    probs<HQ, HV, RQ>(p, ds, Qs, dOs, Ks, Vs, Ls, Ds, q0, k0, Sq, Sk, causal,
                      window, prefix, scale);
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dSs[(RQ * ty + i) * LP + tx + 16 * j] = ds[i][j];
    __syncthreads();
    // rows RQ ty + i, columns tx + 16 c: dQ += dS K
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float sa[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) sa[i] = dSs[(RQ * ty + i) * LP + j];
#pragma unroll
      for (int c = 0; c < NQ; ++c) {
        const float x = Ks[j * LQ + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < RQ; ++i) dQ[i][c] = fmaf(sa[i], x, dQ[i][c]);
      }
    }
  }

  T* dqb = dq + (int64_t)b * Sq * qrow + (int64_t)h * hd;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qi = q0 + RQ * ty + i;
    if (qi >= Sq) continue;
#pragma unroll
    for (int c = 0; c < NQ; ++c) {
      const int col = tx + 16 * c;
      if (col < hd) st(dqb + (int64_t)qi * qrow + col, dQ[i][c] * scale);
    }
  }
}

// ------------------------------------------------------------------ host

namespace {

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *D;
  void *dq, *dk, *dv;
  int64_t B, Sq, Sk, H, KV, hd, hdv;
  int causal, window, prefix;
  float scale;
  cudaStream_t st;
};

template <int HQ, int HV, typename T>
int launch(const Args& a, int which) {
  using C = Tile<HQ, HV>;
  if (which == 0) {
    auto kernel = flash_bwd_dkdv<HQ, HV, T>;
    const int smem = C::DKDV_FLOATS * (int)sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((unsigned)((a.Sk + BK - 1) / BK), (unsigned)(a.B * a.KV));
    kernel<<<grid, THREADS, smem, a.st>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse,
        a.D, (T*)a.dk, (T*)a.dv, (int)a.Sq, (int)a.Sk, (int)a.H, (int)a.KV,
        (int)a.hd, (int)a.hdv, a.causal, a.window, a.prefix, a.scale);
  } else {
    auto kernel = flash_bwd_dq<HQ, HV, T>;
    const int smem = C::DQ_FLOATS * (int)sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    const int n_qt = (int)((a.Sq + C::BQ - 1) / C::BQ);
    const dim3 grid((unsigned)n_qt, (unsigned)(a.B * a.H));
    kernel<<<grid, THREADS, smem, a.st>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse,
        a.D, (T*)a.dq, (int)a.Sq, (int)a.Sk, (int)a.H, (int)a.KV, (int)a.hd,
        (int)a.hdv, a.causal, a.window, a.prefix, a.scale, n_qt);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_pair(const Args& a, int which) {
  // 120 runs the (128, 128) kernels, its last 8 columns staged as zeros
  if (a.hd == 64 && a.hdv == 64) return launch<64, 64, T>(a, which);
  if ((a.hd == 120 && a.hdv == 120) || (a.hd == 128 && a.hdv == 128))
    return launch<128, 128, T>(a, which);
  if (a.hd == 192 && a.hdv == 128) return launch<192, 128, T>(a, which);
  if (a.hd == 256 && a.hdv == 256) return launch<256, 256, T>(a, which);
  return (int)cudaErrorInvalidValue;
}

int run(const Args& a, int which, bool bf16) {
  if (a.B <= 0 || a.Sq <= 0 || a.H <= 0) return (int)cudaSuccess;
  if (a.KV <= 0 || a.H % a.KV != 0 || a.B * a.H > 65535 || a.Sk <= 0 ||
      a.Sq > (int64_t)1 << 30 || a.Sk > (int64_t)1 << 30 ||
      (a.causal && a.Sq != a.Sk))
    return (int)cudaErrorInvalidValue;
  return bf16 ? launch_pair<__nv_bfloat16>(a, which)
              : launch_pair<float>(a, which);
}

}  // namespace

// D (B, H, Sq) float32 = rowsum(dO * O) over o and dout (B, Sq, H, hdv),
// contiguous, bf16 when is_bf16 else float32.  Launches on `stream`,
// allocates nothing, does not synchronise; returns cudaGetLastError().
extern "C" int flash_attn_bwd_dot(const void* o, const void* dout, void* D,
                                  int64_t B, int64_t Sq, int64_t H,
                                  int64_t hdv, int64_t is_bf16,
                                  void* stream) {
  const int64_t rows = B * Sq * H;
  if (rows <= 0) return (int)cudaSuccess;
  if (hdv <= 0 || Sq > (int64_t)1 << 30 || hdv >= 4096)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    flash_bwd_dot<__nv_bfloat16><<<(unsigned)blocks, THREADS, 0, st>>>(
        (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, (float*)D, rows,
        (int)Sq, (int)H, (int)hdv);
  else
    flash_bwd_dot<float><<<(unsigned)blocks, THREADS, 0, st>>>(
        (const float*)o, (const float*)dout, (float*)D, rows, (int)Sq,
        (int)H, (int)hdv);
  return (int)cudaGetLastError();
}

// dK (B, Sk, KV, hd) and dV (B, Sk, KV, hdv) from q (B, Sq, H, hd), k, v,
// dout (B, Sq, H, hdv), lse and D (B, H, Sq) float32: the forward's
// arguments (pairs, mask, scale) and its constraints; one dtype, bf16 when
// is_bf16 else float32.  Returns cudaGetLastError().
extern "C" int flash_attn_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* D, void* dk, void* dv, int64_t B,
    int64_t Sq, int64_t Sk, int64_t H, int64_t KV, int64_t hd, int64_t hdv,
    int64_t causal, int64_t window, int64_t prefix, double scale,
    int64_t is_bf16, void* stream) {
  const Args a{q, k, v, dout, (const float*)lse, (const float*)D, nullptr,
               dk, dv, B, Sq, Sk, H, KV, hd, hdv, (int)(causal != 0),
               window > 0 ? (int)window : 0,
               prefix > 0 ? (int)(prefix < Sk ? prefix : Sk) : 0,
               (float)scale, (cudaStream_t)stream};
  return run(a, 0, is_bf16 != 0);
}

// dQ (B, Sq, H, hd): the arguments of flash_attn_bwd_dkdv.
extern "C" int flash_attn_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* D, void* dq, int64_t B, int64_t Sq,
    int64_t Sk, int64_t H, int64_t KV, int64_t hd, int64_t hdv,
    int64_t causal, int64_t window, int64_t prefix, double scale,
    int64_t is_bf16, void* stream) {
  const Args a{q, k, v, dout, (const float*)lse, (const float*)D, dq,
               nullptr, nullptr, B, Sq, Sk, H, KV, hd, hdv,
               (int)(causal != 0), window > 0 ? (int)window : 0,
               prefix > 0 ? (int)(prefix < Sk ? prefix : Sk) : 0,
               (float)scale, (cudaStream_t)stream};
  return run(a, 1, is_bf16 != 0);
}
