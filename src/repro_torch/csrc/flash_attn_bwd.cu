// Flash attention backward for Hopper (sm_90a): the gradients dQ, dK and dV
// of csrc/flash_attn.cu's forward, for every (q/k head_dim, v head_dim)
// pair, dtype and mask it takes, from the forward's output O and its
// per-row log-sum-exp LSE.
//
// Replaces no TPU kernel: the reference's Pallas flash kernel
// (src/repro/kernels/attention.py:32) has no backward, and the reference
// trains through its jnp chunked scan (repro/models/attention.py::
// chunked_attention), which JAX differentiates.  This is the
// FlashAttention-2 backward (Dao, 2023),
//
//   D = rowsum(dO * O),  P = exp(scale * Q K^T - LSE) masked,
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D),
//   dK = scale * dS^T Q,  dQ = scale * dS K,
//
// in three launches a call: flash_bwd_dot (D, one warp a row), then a
// dK/dV kernel (a block a key tile, batch and KV head: it walks every query
// tile that attends its keys, for each query head of the group), then a dQ
// kernel (a block a query tile, batch and head: it walks the KV tiles the
// tile attends and recomputes S and dP).  No atomics: each output element
// is summed inside one block in a fixed order, so GQA's sum over a group's
// heads is deterministic and a rerun gives the same bits; FlashAttention-
// 2/3's float32 atomic dQ would save the recompute and lose that.  Both
// kernels visit exactly the tiles the forward's mask admits (causal,
// window, prefix-LM, full; Sq != Sk in a full call) and mask each element
// by the forward's rule: key j is attended by query i when j < prefix, or
// when the call is full, or when i >= j and, with a window, i - j < window.
//
// Bound: at the train cell's attention (B = 4, S = 4,096, 12 query and 2
// KV heads, (128, 128), bf16, causal) a backward does 2 (3 hd + 2 hdv)
// useful FLOP a kept (query, key) pair -- S, dP, dV, dK and dQ, without
// the dQ kernel's recompute of S and dP (2 (hd + hdv) more) -- 5.2e11 FLOP
// against 236 MB (q, k, v, O, dO, the three gradients, LSE and D), so the
// tensor cores' 989 TFLOP/s bound it (0.52 ms), not memory.
//
// Routes, by pair and dtype:
//   bf16 (64, 64), (120, 120), (128, 128), (192, 128): flash_bwd_dkdv_tc
//     and flash_bwd_dq_tc, on the tensor cores;
//   bf16 (256, 256) and every float32 pair: flash_bwd_dkdv and
//     flash_bwd_dq, float32 FMAs on the CUDA cores.  At (256, 256) a dK/dV
//     warpgroup of 64 keys would hold 64 x 256 float32 of dK and as many
//     of dV in its 128 threads: 256 registers a thread before S^T and dP^T,
//     past the 255 a thread may have.  Its cost: 15.32 ms a call at the
//     VLM cell's attention (B = 8, S = 1,024, 8/1 heads, causal, a 256-key
//     prefix; dK/dV 8.00, dQ 7.15 device ms), 166x its 0.092 ms bound
//     (H100 80GB HBM3 at 700 W; chip_smoke.py's phase 43, "flash bwd
//     256x256[vlm cell]").
//   flash_attn_bwd_cuda_cores runs the CUDA-core kernels at any pair and
//   dtype: the replaced bf16 route, kept only as the baseline that
//   chip_smoke.py times the tensor-core kernels against.
//
// Tensor cores (bf16).  Every product is a wgmma with float32 accumulators
// (the forward's helpers, copied below), fed by TMA loads with the 128-byte
// swizzle into a ring of mbarrier stages, one producer warp a block:
//  - dK/dV (tc::DkdvCfg): one consumer warpgroup of 64 keys and the
//    producer warp.  The producer loads the block's K and V tiles once,
//    then streams BQ-row tiles of Q and dO, with their rows' LSE (times
//    log2 e) and D written into the stage by its 32 lanes, into a ring of
//    3 stages.  The key tile is on wgmma's M side: a warpgroup computes
//    S^T = K Q^T and dP^T = V dO^T (m64nBQk16, both operands in shared
//    memory), then P^T = exp2(S^T scale log2 e - LSE log2 e), masked, and
//    dS^T = P^T (dP^T - D) in the accumulator fragment, which is the
//    register A operand of dV += P^T dO and dK += dS^T Q: dO and Q are the
//    B operand in their own (queries x columns) layout through the
//    transpose bit, as the forward's P V takes V, so no transposed copy is
//    stored.  dK and dV stay in registers and are scaled and rounded once
//    at the end.
//  - dQ (tc::DqCfg): two consumer warpgroups of 64 query rows each (one at
//    (192, 128)) and the producer warp; Q and dO resident, 64-key K and V
//    tiles through a ring of 4 stages; S = Q K^T and dP = dO V^T (shared x
//    shared), dS in registers as the A operand of dQ += dS K, K through
//    the transpose bit.
//  - A dK/dV warpgroup issues its dV and dK products and goes on to the
//    next tile's S^T and dP^T without waiting; the stage they read is
//    freed at that tile's wait, which covers both.  A dQ warpgroup waits
//    for its dQ product (the other warpgroup fills the tensor cores
//    meanwhile): keeping dS and dQ in flight across the next tile's S and
//    dP left ptxas too few of the 168 registers a 288-thread block has,
//    and it serialised every wgmma (its C7512 note).
//  - Rounding: P^T and dS^T enter their products as one bf16 rounding
//    each (FlashAttention-2's choice).  At every phase-42 case (the
//    forward's pairs and masks at S = 200 and the shapes ragged over
//    these tiles) that holds dQ, dK and dV within 0.69 ((128, 128)) to
//    0.80 ((192, 128)) of the card check's bar, 2^-8 in relative norm.
//    P and dS both as hi + lo (as the forward splits P) held them within
//    0.04-0.06, but the lo parts' registers made ptxas serialise the
//    dK/dV kernel's wgmmas (its C7511 and C7512 notes): 1.90 device ms at
//    the train cell against 0.90.  These and the variants' times below
//    were measured on an H100 80GB HBM3 at 700 W with compile-time
//    switches for each variant, removed once the variant lost.
//  - Tiles, from ptxas's report and those times: a dK/dV warpgroup holds
//    dK and dV (64 + 64 registers a thread at (128, 128)) beside S^T and
//    dP^T (32 + 32).  ptxas holds a block of two warpgroups and the
//    producer warp (288 threads) to 168 registers a thread: 616 bytes of
//    spill, serialised wgmmas, 1.94 ms; FlashAttention-3's setmaxnreg
//    handoff (a producer warpgroup at 24 registers, two consumers at
//    240) was tried and left ptxas at 168 and spilling too.  32-row
//    stages (S^T and dP^T at 16 each) 1.30 ms.  So dK/dV runs one
//    warpgroup of 160 threads, 64 keys a block, 64-row stages (250
//    registers, no spill; 0.81 ms, 0.90 while the code of the two-
//    warpgroup variant was still compiled in); at (192, 128) 32-row
//    stages (dK 96, dV 64; 238 registers).  dQ runs two warpgroups, 128
//    query rows a block (161 registers at (128, 128), no spill; 0.55 ms),
//    and one at (192, 128) (193; two spilled 260 bytes).  Two fixes took
//    the call from 2.35 to 1.50 ms: LSE and D are read by shared loads
//    (the aligned base is an offset of the shared array, not an integer,
//    so the compiler keeps its address space: it had emitted generic
//    loads), and the mask sets the scores of edge tiles alone to -inf
//    before a branch-free exp2 pass (a branch around every element had
//    tripled that pass's instructions, and one warp a scheduler hides
//    none of them).  120 runs the 128 kernels: its tensor maps' inner
//    dimension is 120, so TMA reads columns 120..127 as zeros, and stores
//    stop at 120.  TMA also fills rows past Sq and keys past Sk with
//    zeros, which the mask drops.
//  - Heaviest first: blockIdx.y is the key tile of dK/dV (the first are
//    the heaviest under a causal mask) and the query tile of dQ counted
//    from the last, and blockIdx.x the (batch, head), so the heaviest
//    tiles of every head launch first.
//
// CUDA cores (float32, and bf16 at (256, 256)): 256 threads as 16 x 16;
// every product is a 4 x 4 (or 2 x 4) register tile over float32 tiles in
// shared memory whose rows are padded to an odd stride, so the 16 lanes
// that read 16 rows hit 16 banks; bf16 inputs are widened once as they are
// staged; each output is rounded once from its float32 accumulator into
// the input dtype.  Head dims are compiled at 64, 128, 192 and 256 (HQ,
// HV); 120 runs the (128, 128) kernels with its columns 120..127 staged as
// zeros, which add nothing to any product.  Query tiles are 64 rows, 32
// where HQ + HV > 320 ((256, 256)), so that every block's tiles fit the
// 227 KB of shared memory: at (256, 256) 214,272 bytes (dK/dV) and 205,952
// (dQ).
#include <cuda.h>  // CUtensorMap and its enums, types only: no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// ------------------------------------------------ CUDA cores

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

// --------------------------------------------- bfloat16: tensor cores

namespace tc {

constexpr int ROWB = 128;     // bytes per smem row: 64 bf16, one swizzle span
constexpr int BKR = 64;       // keys per tile of the dQ kernel's K/V ring
constexpr float LOG2E = 1.4426950408889634f;

// dK/dV: one consumer warpgroup of 64 keys and one producer warp; K and V
// resident, a ring of STAGES stages of BQ query rows (Q, dO, and each
// row's LSE * log2(e) and D).  One warpgroup: 160 threads may take 255
// registers a thread, 288 only 168.  (192, 128) takes 32-row stages: dK
// (96 registers a thread) and dV (64) leave room for S^T and dP^T at 16
// each, not at 32.
template <int HQ, int HV>
struct DkdvCfg {
  static constexpr int BK = 64;
  static constexpr int BQ = HQ + HV > 256 ? 32 : 64;
  static constexpr int STAGES = 3;
  static constexpr int THREADS = 128 + 32;
  static constexpr int NQK = (HQ + 63) / 64, NV = (HV + 63) / 64;
  static constexpr int KBYTES = NQK * BK * ROWB, VBYTES = NV * BK * ROWB;
  static constexpr int QBYTES = NQK * BQ * ROWB, OBYTES = NV * BQ * ROWB;
  // 1,024 of slack to align the tiles, K, V, the ring, LSE and D of each
  // stage, 2 * STAGES + 1 mbarriers
  static constexpr int SMEM = 1024 + KBYTES + VBYTES +
      STAGES * (QBYTES + OBYTES + 2 * BQ * 4) + 8 * (2 * STAGES + 1);
};

// dQ: WG consumer warpgroups of 64 query rows each (BQ a block), Q and dO
// resident, a ring of STAGES tiles of 64 keys (K and V).  Two warpgroups
// (288 threads, which ptxas holds to 168 registers a thread) up to HQ =
// 128; one at (192, 128), whose dQ (96) with S and dP (32 each) spilled
// 260 bytes at 288 threads.
template <int HQ, int HV>
struct DqCfg {
  static constexpr int WG = HQ > 128 ? 1 : 2;
  static constexpr int BQ = 64 * WG;
  static constexpr int STAGES = 4;
  static constexpr int THREADS = 128 * WG + 32;
  static constexpr int NQK = (HQ + 63) / 64, NV = (HV + 63) / 64;
  static constexpr int QBYTES = NQK * BQ * ROWB, OBYTES = NV * BQ * ROWB;
  static constexpr int KBYTES = NQK * BKR * ROWB, VBYTES = NV * BKR * ROWB;
  static constexpr int SMEM = 1024 + QBYTES + OBYTES +
      STAGES * (KBYTES + VBYTES) + 8 * (2 * STAGES + 1);
};

// ---- the forward's helpers (csrc/flash_attn.cu), copied: each source is
// built on its own, keyed by its own hash

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

// spin until the phase of `bar` with this parity has completed; a wait
// that never ends (a fault in the pipeline) traps, so the launch fails
// instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}

// TMA: one box of a 4-d tensor map (coordinates innermost first) into
// shared memory, its bytes counted on `bar` as they land
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a tile that TMA wrote with the 128-byte
// swizzle (rows of 128 bytes, 8-row atoms of 1,024 bytes, the tile 1,024-
// byte aligned).  K-major operands take lbo = 16 (unused) and sbo = 1,024,
// the stride between 8-row groups; an MN-major operand takes lbo = the
// stride between its 64-column blocks and sbo = 1,024, the stride between
// 8-row groups along the reduction.  A k-step inside the 128-byte row
// advances the start address by 32 bytes; the swizzle is applied on the
// address.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across its launch or its wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// two floats rounded to nearest even into one bf16x2 register, `first` in
// the low half (the lower column of an A fragment's pair)
__device__ __forceinline__ uint32_t pack_bf16(float first, float second) {
  __nv_bfloat162 v = __floats2bfloat162_rn(first, second);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The wgmma instructions, bf16 in, f32 accumulators (64 rows over the
// warpgroup: warp w holds rows 16w..16w+15, register 4j + 2i + c of a lane
// is row lane/4 + 8i, column 8j + 2(lane%4) + c).  ss: A and B from shared
// memory, both K-major, scale_d = 0 overwrites D; m64n64k16 or m64n32k16
// (32 or 16 accumulators).  rs: A from registers (a k16 fragment, 4
// bf16x2), B MN-major (the transpose bit), D accumulated; m64n64k16 or
// m64n128k16 (32 or 64 accumulators).  The overload is chosen by the
// accumulator array's size.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---- the backward's products

// start acc = A . B^T over ND 64-column blocks of the reduction, both
// operands K-major in shared memory: A's 64 rows at `a`, its column
// blocks `as` bytes apart; B's rows (2 x the accumulators a thread, 64 or
// 32) at `b`, its blocks `bs` apart.  scale_d = 0 on the first k-step.
template <int ND, int NA>
__device__ __forceinline__ void mma_ss(float (&acc)[NA], uint32_t a,
                                       uint32_t as, uint32_t b,
                                       uint32_t bs) {
#pragma unroll
  for (int db = 0; db < ND; ++db)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(acc, desc(a + db * as + kk * 32, 16, 1024),
               desc(b + db * bs + kk * 32, 16, 1024), (db | kk) != 0);
}

// start acc (64 rows x 64 NB columns) += A . B for one k16 step: A the
// fragment at `a`, B 16 rows of NB 64-column blocks, MN-major at `b`, its
// blocks `lbo` bytes apart.  NB = 3 ((192, 128)'s dK and dQ) is one
// m64n128k16 on accumulators 0..63 and one m64n64k16 on 64..95: the
// fragment layout continues across the two.
template <int NB>
__device__ __forceinline__ void mma_rs(float (&acc)[NB * 32],
                                       const uint32_t* a, uint32_t b,
                                       uint32_t lbo) {
  if constexpr (NB == 3) {
    wgmma_rs(*reinterpret_cast<float(*)[64]>(&acc[0]), a,
             desc(b, lbo, 1024));
    wgmma_rs(*reinterpret_cast<float(*)[32]>(&acc[64]), a,
             desc(b + 2 * lbo, lbo, 1024));
  } else {
    static_assert(NB == 1 || NB == 2, "64, 128 or 192 columns");
    wgmma_rs(acc, a, desc(b, lbo, 1024));
  }
}

// x (pairs of one row's adjacent columns) rounded once to bf16: register
// n holds x[2n] and x[2n + 1], so registers 4kk..4kk+3 are the A fragment
// of columns 16kk..16kk+15
template <int N>
__device__ __forceinline__ void to_bf16(const float (&x)[2 * N],
                                        uint32_t (&out)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) out[n] = pack_bf16(x[2 * n], x[2 * n + 1]);
}

__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);       // this warp is done with the stage
}

// the first 1,024-byte aligned byte of the dynamic shared memory at p, as
// an offset from p, so that the compiler keeps the shared address space
// of every pointer derived from it (shared loads, not generic ones)
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// the query rows [lo, hi) that attend some key of keys kb .. kb + nk - 1:
// all of them in a full call or where the keys start inside the prefix;
// else from kb and, with a window, up to kb + nk - 1 + window
__device__ __forceinline__ void query_range(int kb, int nk, int Sq,
                                            int causal, int window,
                                            int prefix, int& lo, int& hi) {
  lo = 0;
  hi = Sq;
  if (causal && kb >= prefix) {
    lo = kb;
    if (window > 0) hi = min(Sq, kb + nk - 1 + window);
  }
}

}  // namespace tc

// dK and dV of BK = 64 keys of one (batch, KV head) on the tensor cores: the block walks every query tile of BQ rows that attends one of
// its keys, for each query head of the group; blockIdx.y is the key tile,
// so the heaviest tiles under a causal mask (the first) launch first
template <int HQ, int HV>
__global__ void __launch_bounds__(tc::DkdvCfg<HQ, HV>::THREADS, 1)
    flash_bwd_dkdv_tc(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse,
                      const float* __restrict__ D,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int H,
                      int KV, int hd, int hdv, int causal, int window,
                      int prefix, float scale, float c2) {
  using namespace tc;
  using C = DkdvCfg<HQ, HV>;
  constexpr int BK = C::BK, BQ = C::BQ, STAGES = C::STAGES;
  constexpr int NQK = C::NQK, NV = C::NV;
  constexpr int NS = BQ / 2;      // S^T registers a thread: 64 x BQ / 128
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = align1024(smem_raw);
  uint8_t* Vs = Ks + C::KBYTES;
  uint8_t* Qs = Vs + C::VBYTES;                     // STAGES x QBYTES
  uint8_t* Os = Qs + STAGES * C::QBYTES;            // STAGES x OBYTES (dO)
  float* Ls = reinterpret_cast<float*>(Os + STAGES * C::OBYTES);
  float* Ds = Ls + STAGES * BQ;                     // STAGES x BQ each
  uint64_t* full = reinterpret_cast<uint64_t*>(Ds + STAGES * BQ);
  uint64_t* empty = full + STAGES;
  uint64_t* kvbar = empty + STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = (int)blockIdx.x / KV, kvh = (int)blockIdx.x - b * KV;
  const int k0 = (int)blockIdx.y * BK;
  const int G = H / KV;
  int q_lo, q_hi;
  query_range(k0, BK, Sq, causal, window, prefix, q_lo, q_hi);
  const int qt_lo = q_lo / BQ;
  const int nq = q_lo < q_hi ? (q_hi + BQ - 1) / BQ - qt_lo : 0;
  const int n_it = G * nq;                          // (head, query tile)s

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);          // the producer's 32 lanes
      mbar_init(&empty[s], 4);          // one arrival per consumer warp
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {                      // the producer warp
    if (lane == 0) {
      mbar_expect_tx(kvbar, C::KBYTES + C::VBYTES);
      for (int db = 0; db < NQK; ++db)
        tma_load(Ks + db * BK * ROWB, &tk, kvbar, db * 64, kvh, k0, b);
      for (int db = 0; db < NV; ++db)
        tma_load(Vs + db * BK * ROWB, &tv, kvbar, db * 64, kvh, k0, b);
    }
    for (int it = 0; it < n_it; ++it) {
      const int st = it % STAGES;
      const int g = it / nq, q0 = (qt_lo + it - g * nq) * BQ;
      const int h = kvh * G + g;
      mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
      const int64_t row = ((int64_t)b * H + h) * Sq;
      for (int r = lane; r < BQ; r += 32) {
        const int i = q0 + r;
        Ls[st * BQ + r] = i < Sq ? lse[row + i] * LOG2E : 0.f;
        Ds[st * BQ + r] = i < Sq ? D[row + i] : 0.f;
      }
      if (lane == 0) {                  // its arrival, with the bytes due
        mbar_expect_tx(&full[st], C::QBYTES + C::OBYTES);
        for (int db = 0; db < NQK; ++db)
          tma_load(Qs + st * C::QBYTES + db * BQ * ROWB, &tq, &full[st],
                   db * 64, h, q0, b);
        for (int db = 0; db < NV; ++db)
          tma_load(Os + st * C::OBYTES + db * BQ * ROWB, &tdo, &full[st],
                   db * 64, h, q0, b);
      } else {
        mbar_arrive(&full[st]);         // LSE and D of the stage written
      }
    }
    return;
  }

  // the consumer warpgroup: every query tile of the ring is one it needs
  const int r0 = k0 + 16 * warp + (lane >> 2);        // keys r0, r0 + 8
  const int cq = 2 * (lane & 3);
  const uint32_t kaddr = smem_u32(Ks);
  const uint32_t vaddr = smem_u32(Vs);
  // the tile at q0 is not attended whole by every key of the block: it
  // crosses Sq or Sk, or ends past the prefix and straddles the diagonal
  // or the window's edge
  auto edge = [&](int q0) {
    return q0 + BQ > Sq || k0 + 64 > Sk ||
           (k0 + 64 > prefix &&
            ((causal && q0 < k0 + 63) ||
             (window > 0 && q0 + BQ - 1 - k0 >= window)));
  };

  float dK[NQK * 32], dV[NV * 32], s[NS], dp[NS];
  uint32_t pa[NS / 2], da[NS / 2];
#pragma unroll
  for (int i = 0; i < NQK * 32; ++i) dK[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NV * 32; ++i) dV[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NS / 2; ++i) pa[i] = da[i] = 0u;
  mbar_wait(kvbar, 0);

  int pend = -1;              // the stage the last products still read
  for (int it = 0; it < n_it; ++it) {
    const int st = it % STAGES;
    const int g = it / nq, q0 = (qt_lo + it - g * nq) * BQ;
    mbar_wait(&full[st], (it / STAGES) & 1);
    const uint32_t qaddr = smem_u32(Qs + st * C::QBYTES);
    const uint32_t oaddr = smem_u32(Os + st * C::OBYTES);
    reg_fence(s);
    reg_fence(dp);
    wg_fence();
    mma_ss<NQK>(s, kaddr, BK * ROWB, qaddr, BQ * ROWB);    // S^T = K Q^T
    mma_ss<NV>(dp, vaddr, BK * ROWB, oaddr, BQ * ROWB);    // dP^T = V dO^T
    wg_commit();
    wg_wait<0>();             // also the last tile's dV and dK products
    reg_fence(s);
    reg_fence(dp);
    reg_fence(dK);
    reg_fence(dV);
    reg_fence(pa);
    reg_fence(da);
    if (pend >= 0) release(&empty[pend], lane);

    // P^T = exp2(S^T c2 - LSE log2 e), masked, and dS^T = P^T (dP^T - D):
    // register 4j + 2i + c is key r0 + 8i, query q0 + 8j + cq + c.  A
    // masked score is -inf first (only where the tile straddles an edge),
    // so that the pass below is the same for every tile: exp2(-inf) = 0
    if (edge(q0)) {
#pragma unroll
      for (int j = 0; j < NS / 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!attends(q0 + 8 * j + cq + (e & 1), r0 + 8 * (e >> 1), Sq, Sk,
                       causal, window, prefix))
            s[4 * j + e] = -INFINITY;
    }
    const float* Lq = Ls + st * BQ;
    const float* Dq = Ds + st * BQ;
#pragma unroll
    for (int j = 0; j < NS / 4; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(Lq + 8 * j + cq);
      const float2 d = *reinterpret_cast<const float2*>(Dq + 8 * j + cq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = e & 1;
        const float p = ex2(fmaf(s[4 * j + e], c2, -(c ? l.y : l.x)));
        s[4 * j + e] = p;
        dp[4 * j + e] = p * (dp[4 * j + e] - (c ? d.y : d.x));
      }
    }
    to_bf16(s, pa);
    to_bf16(dp, da);
    reg_fence(dK);
    reg_fence(dV);
    reg_fence(pa);
    reg_fence(da);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      mma_rs<NV>(dV, pa + 4 * kk, oaddr + kk * 16 * ROWB, BQ * ROWB);
      mma_rs<NQK>(dK, da + 4 * kk, qaddr + kk * 16 * ROWB, BQ * ROWB);
    }
    wg_commit();
    pend = st;
  }
  wg_wait<0>();
  reg_fence(dK);
  reg_fence(dV);
  reg_fence(pa);
  reg_fence(da);

  // scale dK; round both once into bf16 (keys < Sk, columns < hd, hdv)
  const int64_t krow = (int64_t)KV * hd, vrow = (int64_t)KV * hdv;
  __nv_bfloat16* dkb = dk + (int64_t)b * Sk * krow + (int64_t)kvh * hd;
  __nv_bfloat16* dvb = dv + (int64_t)b * Sk * vrow + (int64_t)kvh * hdv;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int ki = r0 + 8 * i;
    if (ki >= Sk) continue;
#pragma unroll
    for (int j = 0; j < NQK * 8; ++j) {
      const int col = 8 * j + cq;
      if (col < hd)
        *reinterpret_cast<__nv_bfloat162*>(dkb + (int64_t)ki * krow + col) =
            __floats2bfloat162_rn(dK[4 * j + 2 * i] * scale,
                                  dK[4 * j + 2 * i + 1] * scale);
    }
#pragma unroll
    for (int j = 0; j < NV * 8; ++j) {
      const int col = 8 * j + cq;
      if (col < hdv)
        *reinterpret_cast<__nv_bfloat162*>(dvb + (int64_t)ki * vrow + col) =
            __floats2bfloat162_rn(dV[4 * j + 2 * i], dV[4 * j + 2 * i + 1]);
    }
  }
}

// dQ of BQ = 64 WG query rows of one (batch, head) on the tensor cores:
// the block walks the KV tiles its rows attend (the forward's tile
// bounds); blockIdx.y counts query tiles from the last, the heaviest under
// a causal mask
template <int HQ, int HV>
__global__ void __launch_bounds__(tc::DqCfg<HQ, HV>::THREADS, 1)
    flash_bwd_dq_tc(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse,
                    const float* __restrict__ D,
                    __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int H,
                    int KV, int hd, int causal, int window, int prefix,
                    float scale, float c2, int n_qt) {
  using namespace tc;
  using C = DqCfg<HQ, HV>;
  constexpr int WG = C::WG, BQ = C::BQ, STAGES = C::STAGES;
  constexpr int NQK = C::NQK, NV = C::NV;
  constexpr int NS = BKR / 2;     // score registers a thread: 64 x 64 / 128
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align1024(smem_raw);
  uint8_t* Os = Qs + C::QBYTES;                     // dO
  uint8_t* Ks = Os + C::OBYTES;                     // STAGES x KBYTES
  uint8_t* Vs = Ks + STAGES * C::KBYTES;            // STAGES x VBYTES
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + STAGES * C::VBYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = (int)blockIdx.x / H, h = (int)blockIdx.x - b * H;
  const int kvh = h / (H / KV);
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * BQ;
  // the KV tiles some row of this block attends (the forward's bounds)
  const int k_lo = window > 0 && prefix <= 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi =
      causal ? min(Sk, prefix > 0 ? max(q0 + BQ, prefix) : q0 + BQ) : Sk;
  const int kt_lo = k_lo / BKR;
  const int n_kt = (k_hi + BKR - 1) / BKR - kt_lo;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * WG);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * WG) {                 // the producer warp
    if (lane == 0) {
      mbar_expect_tx(qbar, C::QBYTES + C::OBYTES);
      for (int db = 0; db < NQK; ++db)
        tma_load(Qs + db * BQ * ROWB, &tq, qbar, db * 64, h, q0, b);
      for (int db = 0; db < NV; ++db)
        tma_load(Os + db * BQ * ROWB, &tdo, qbar, db * 64, h, q0, b);
      for (int it = 0; it < n_kt; ++it) {
        const int st = it % STAGES;
        mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[st], C::KBYTES + C::VBYTES);
        const int kb = (kt_lo + it) * BKR;
        for (int db = 0; db < NQK; ++db)
          tma_load(Ks + st * C::KBYTES + db * BKR * ROWB, &tk, &full[st],
                   db * 64, kvh, kb, b);
        for (int db = 0; db < NV; ++db)
          tma_load(Vs + st * C::VBYTES + db * BKR * ROWB, &tv, &full[st],
                   db * 64, kvh, kb, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows qw .. qw + 63 and needs tiles it_lo
  // .. it_hi - 1 of the block's n_kt; it frees the others as they arrive
  const int wg = warp >> 2;
  const int qw = q0 + 64 * wg;
  const int r0 = qw + 16 * (warp & 3) + (lane >> 2);   // rows r0, r0 + 8
  const int cq = 2 * (lane & 3);
  const int kw_lo = window > 0 && prefix <= 0 ? max(0, qw - window + 1) : 0;
  const int kw_hi =
      causal ? min(Sk, prefix > 0 ? max(qw + 64, prefix) : qw + 64) : Sk;
  const int it_lo = qw < Sq ? kw_lo / BKR - kt_lo : n_kt;
  const int it_hi = min(n_kt, (kw_hi + BKR - 1) / BKR - kt_lo);
  const uint32_t qaddr = smem_u32(Qs) + wg * 64 * ROWB;
  const uint32_t oaddr = smem_u32(Os) + wg * 64 * ROWB;
  auto edge = [&](int kb) {
    return ((kb + BKR > prefix) &&
            ((causal && kb + BKR - 1 > qw) ||
             (window > 0 && kb <= qw + 63 - window))) ||
           kb + BKR > Sk;
  };
  float L2[2], Dr[2];                   // LSE log2(e) and D of rows r0 + 8i
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = r0 + 8 * i;
    const int64_t at = ((int64_t)b * H + h) * Sq + qi;
    L2[i] = qi < Sq ? lse[at] * LOG2E : 0.f;
    Dr[i] = qi < Sq ? D[at] : 0.f;
  }

  float dQ[NQK * 32], s[NS], dp[NS];
  uint32_t da[NS / 2];
#pragma unroll
  for (int i = 0; i < NQK * 32; ++i) dQ[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NS / 2; ++i) da[i] = 0u;
  mbar_wait(qbar, 0);

  for (int it = 0; it < n_kt; ++it) {
    const int st = it % STAGES;
    mbar_wait(&full[st], (it / STAGES) & 1);
    if (it >= it_lo && it < it_hi) {    // else a tile only the other needs
      const uint32_t kaddr = smem_u32(Ks + st * C::KBYTES);
      const uint32_t vaddr = smem_u32(Vs + st * C::VBYTES);
      reg_fence(s);
      reg_fence(dp);
      wg_fence();
      mma_ss<NQK>(s, qaddr, BQ * ROWB, kaddr, BKR * ROWB);   // S = Q K^T
      mma_ss<NV>(dp, oaddr, BQ * ROWB, vaddr, BKR * ROWB);   // dP = dO V^T
      wg_commit();
      wg_wait<0>();
      reg_fence(s);
      reg_fence(dp);

      // dS = P (dP - D), P = exp2(S c2 - LSE log2 e) masked: register 4j
      // + 2i + c is row r0 + 8i, key kb + 8j + cq + c; a masked score is
      // -inf first, where the tile straddles an edge
      const int kb = (kt_lo + it) * BKR;
      if (edge(kb)) {
#pragma unroll
        for (int j = 0; j < NS / 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!attends(r0 + 8 * (e >> 1), kb + 8 * j + cq + (e & 1), Sq,
                         Sk, causal, window, prefix))
              s[4 * j + e] = -INFINITY;
      }
#pragma unroll
      for (int j = 0; j < NS / 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const float p = ex2(fmaf(s[4 * j + e], c2, -L2[i]));
          dp[4 * j + e] = p * (dp[4 * j + e] - Dr[i]);
        }
      to_bf16(dp, da);
      reg_fence(dQ);
      reg_fence(da);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BKR / 16; ++kk)     // dQ += dS K
        mma_rs<NQK>(dQ, da + 4 * kk, kaddr + kk * 16 * ROWB, BKR * ROWB);
      wg_commit();
      wg_wait<0>();
      reg_fence(dQ);
      reg_fence(da);
    }
    release(&empty[st], lane);
  }

  const int64_t qrow = (int64_t)H * hd;
  __nv_bfloat16* dqb = dq + (int64_t)b * Sq * qrow + (int64_t)h * hd;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = r0 + 8 * i;
    if (qi >= Sq) continue;
#pragma unroll
    for (int j = 0; j < NQK * 8; ++j) {
      const int col = 8 * j + cq;
      if (col < hd)
        *reinterpret_cast<__nv_bfloat162*>(dqb + (int64_t)qi * qrow + col) =
            __floats2bfloat162_rn(dQ[4 * j + 2 * i] * scale,
                                  dQ[4 * j + 2 * i + 1] * scale);
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

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (the library
// then needs no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = (EncodeTiled)p;
  }
  return fn;
}

// the (B, S, heads, HD) bf16 tensor at `ptr` as a 4-d map, innermost first,
// read in boxes of 64 columns x 1 head x `rows` positions; outside the
// tensor (columns >= HD, positions >= S) TMA fills zeros
bool make_map(CUtensorMap* map, const void* ptr, int64_t B, int64_t S,
              int64_t heads, int64_t HD, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(HD * 2),
                                 (cuuint64_t)(heads * HD * 2),
                                 (cuuint64_t)(S * heads * HD * 2)};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the tensor-core kernels for one pair: q, k, v and dO each as a tensor map
// in the boxes its kernel reads (a 120 map's columns 120..127 read as zeros)
template <int HQ, int HV>
int launch_tc(const Args& a, int which) {
  // TMA reads from 16-byte aligned addresses
  if (((uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v |
       (uintptr_t)a.dout) & 15)
    return (int)cudaErrorMisalignedAddress;
  const float c2 = a.scale * tc::LOG2E;
  CUtensorMap tq, tk, tv, tdo;
  if (which == 0) {
    using C = tc::DkdvCfg<HQ, HV>;
    const int64_t n_kt = (a.Sk + C::BK - 1) / C::BK;
    if (n_kt > 65535 || a.B * a.KV > 0x7fffffff)
      return (int)cudaErrorInvalidValue;
    if (!make_map(&tq, a.q, a.B, a.Sq, a.H, a.hd, C::BQ) ||
        !make_map(&tk, a.k, a.B, a.Sk, a.KV, a.hd, C::BK) ||
        !make_map(&tv, a.v, a.B, a.Sk, a.KV, a.hdv, C::BK) ||
        !make_map(&tdo, a.dout, a.B, a.Sq, a.H, a.hdv, C::BQ))
      return (int)cudaErrorInvalidValue;
    auto kernel = flash_bwd_dkdv_tc<HQ, HV>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((unsigned)(a.B * a.KV), (unsigned)n_kt);
    kernel<<<grid, C::THREADS, C::SMEM, a.st>>>(
        tq, tk, tv, tdo, a.lse, a.D, (__nv_bfloat16*)a.dk,
        (__nv_bfloat16*)a.dv, (int)a.Sq, (int)a.Sk, (int)a.H, (int)a.KV,
        (int)a.hd, (int)a.hdv, a.causal, a.window, a.prefix, a.scale, c2);
  } else {
    using C = tc::DqCfg<HQ, HV>;
    const int64_t n_qt = (a.Sq + C::BQ - 1) / C::BQ;
    if (n_qt > 65535 || a.B * a.H > 0x7fffffff)
      return (int)cudaErrorInvalidValue;
    if (!make_map(&tq, a.q, a.B, a.Sq, a.H, a.hd, C::BQ) ||
        !make_map(&tk, a.k, a.B, a.Sk, a.KV, a.hd, tc::BKR) ||
        !make_map(&tv, a.v, a.B, a.Sk, a.KV, a.hdv, tc::BKR) ||
        !make_map(&tdo, a.dout, a.B, a.Sq, a.H, a.hdv, C::BQ))
      return (int)cudaErrorInvalidValue;
    auto kernel = flash_bwd_dq_tc<HQ, HV>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((unsigned)(a.B * a.H), (unsigned)n_qt);
    kernel<<<grid, C::THREADS, C::SMEM, a.st>>>(
        tq, tk, tv, tdo, a.lse, a.D, (__nv_bfloat16*)a.dq, (int)a.Sq,
        (int)a.Sk, (int)a.H, (int)a.KV, (int)a.hd, a.causal, a.window,
        a.prefix, a.scale, c2, (int)n_qt);
  }
  return (int)cudaGetLastError();
}

// the pairs whose bf16 backward runs on the tensor cores
bool tc_pair(int64_t hd, int64_t hdv) {
  return (hd == 64 && hdv == 64) || (hd == 120 && hdv == 120) ||
         (hd == 128 && hdv == 128) || (hd == 192 && hdv == 128);
}

int launch_pair_tc(const Args& a, int which) {
  // 120 runs the (128, 128) kernels through its maps' zero columns
  if (a.hd == 64) return launch_tc<64, 64>(a, which);
  if (a.hd == 192) return launch_tc<192, 128>(a, which);
  return launch_tc<128, 128>(a, which);
}

// which = 0: dK and dV; 1: dQ.  bf16 at a tensor-core pair takes the
// tensor-core kernels unless `cuda_cores` asks for the CUDA-core ones;
// *tensor_cores (where given) is set to 1 when they were launched, else 0
int run(const Args& a, int which, bool bf16, bool cuda_cores,
        int32_t* tensor_cores) {
  if (tensor_cores != nullptr) *tensor_cores = 0;
  if (a.B <= 0 || a.Sq <= 0 || a.H <= 0) return (int)cudaSuccess;
  if (a.KV <= 0 || a.H % a.KV != 0 || a.B * a.H > 65535 || a.Sk <= 0 ||
      a.Sq > (int64_t)1 << 30 || a.Sk > (int64_t)1 << 30 ||
      (a.causal && a.Sq != a.Sk))
    return (int)cudaErrorInvalidValue;
  if (bf16 && !cuda_cores && tc_pair(a.hd, a.hdv)) {
    const int e = launch_pair_tc(a, which);
    if (e == 0 && tensor_cores != nullptr) *tensor_cores = 1;
    return e;
  }
  return bf16 ? launch_pair<__nv_bfloat16>(a, which)
              : launch_pair<float>(a, which);
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* D, void* dq, void* dk, void* dv,
               int64_t B, int64_t Sq, int64_t Sk, int64_t H, int64_t KV,
               int64_t hd, int64_t hdv, int64_t causal, int64_t window,
               int64_t prefix, double scale, void* stream) {
  return Args{q, k, v, dout, (const float*)lse, (const float*)D, dq, dk, dv,
              B, Sq, Sk, H, KV, hd, hdv, (int)(causal != 0),
              window > 0 ? (int)window : 0,
              prefix > 0 ? (int)(prefix < Sk ? prefix : Sk) : 0,
              (float)scale, (cudaStream_t)stream};
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
// is_bf16 else float32; q, k, v and dout 16-byte aligned where the route
// is the tensor cores'.  Sets *tensor_cores to 1 when it launched the
// tensor-core kernel, else 0.  Returns cudaGetLastError().
extern "C" int flash_attn_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* D, void* dk, void* dv, int32_t* tensor_cores,
    int64_t B, int64_t Sq, int64_t Sk, int64_t H, int64_t KV, int64_t hd,
    int64_t hdv, int64_t causal, int64_t window, int64_t prefix,
    double scale, int64_t is_bf16, void* stream) {
  return run(make_args(q, k, v, dout, lse, D, nullptr, dk, dv, B, Sq, Sk, H,
                       KV, hd, hdv, causal, window, prefix, scale, stream),
             0, is_bf16 != 0, false, tensor_cores);
}

// dQ (B, Sq, H, hd): the arguments of flash_attn_bwd_dkdv (without
// tensor_cores); it takes the route flash_attn_bwd_dkdv takes.
extern "C" int flash_attn_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* D, void* dq, int64_t B, int64_t Sq,
    int64_t Sk, int64_t H, int64_t KV, int64_t hd, int64_t hdv,
    int64_t causal, int64_t window, int64_t prefix, double scale,
    int64_t is_bf16, void* stream) {
  return run(make_args(q, k, v, dout, lse, D, dq, nullptr, nullptr, B, Sq,
                       Sk, H, KV, hd, hdv, causal, window, prefix, scale,
                       stream),
             1, is_bf16 != 0, false, nullptr);
}

// dK, dV, then dQ on the CUDA-core kernels at any pair and dtype: the
// replaced bf16 route, kept as the baseline that the tensor-core kernels
// are timed against.  The arguments of flash_attn_bwd_dkdv, without
// tensor_cores.
extern "C" int flash_attn_bwd_cuda_cores(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* D, void* dq, void* dk, void* dv, int64_t B,
    int64_t Sq, int64_t Sk, int64_t H, int64_t KV, int64_t hd, int64_t hdv,
    int64_t causal, int64_t window, int64_t prefix, double scale,
    int64_t is_bf16, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, D, dq, dk, dv, B, Sq, Sk, H,
                           KV, hd, hdv, causal, window, prefix, scale, stream);
  const int e = run(a, 0, is_bf16 != 0, true, nullptr);
  return e != 0 ? e : run(a, 1, is_bf16 != 0, true, nullptr);
}
