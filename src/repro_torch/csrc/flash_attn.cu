// Flash attention for Hopper (sm_90a): causal / sliding-window / prefix-LM
// / full attention, self or cross, with an online softmax: the forward, and
// on request each row's log-sum-exp for the backward (csrc/flash_attn_bwd.cu).
//
// Replaces the Pallas TPU kernel src/repro/kernels/attention.py:32
// (_flash_kernel) and the GQA expansion of repro/kernels/ops.py::
// flash_attention_op, and serves every full-sequence GQA and MLA call of
// the reference's repro/models/attention.py::chunked_attention: MLA's
// prefill (q/k head_dim 192, v head_dim 128, scale 1/sqrt(192)), an
// encoder's full self-attention, a decoder's cross-attention over encoder
// frames (Sq != Sk) and PaliGemma's prefix-LM mask at head_dim 256.
//
// out[b, i, h, :] = softmax_j(q_i . k_j * scale + mask_ij) . v_j, with the
// softmax state (m, l, acc) in float32 and the output acc / max(l, 1e-30).
// With a non-null `lse` (float32, (B, H, Sq)) a launch also writes, for each
// row, m + log(max(l, 1e-30)) in natural-log units of the scaled scores:
// the log of the softmax's denominator, which the backward kernels read to
// recompute P without a second pass.  A null `lse` writes nothing and
// leaves every output bit as it was.
// mask (the reference's _mask): key j is attended when j < prefix, or when
// the call is full, or when i >= j (causal) and, with a window, i - j <
// window.  scale is the caller's (1/sqrt(HDQK) by default in the wrapper).
// Layout: the model's own, q (B, Sq, H, HDQK), k (B, Sk, KV, HDQK), v (B,
// Sk, KV, HDV) and o (B, Sq, H, HDV), read in place; query head h reads KV
// head h / (H / KV); a causal call has Sq == Sk.  Instantiated (HDQK, HDV)
// pairs: (64, 64), (120, 120), (128, 128), (192, 128) and (256, 256).  Any
// Sq and Sk: ragged tiles are masked.  KV tiles that no row of a query
// tile attends (above the diagonal and past the prefix, or outside the
// window) are never visited, and the query tiles launch last first: the
// heaviest under a causal mask, with a prefix or without (a tile's keys
// are max(its end, prefix), which never falls as the tile moves on).  Each
// kernel is instantiated with and without a prefix (PREFIX): a call
// without one runs the mask and tile bounds it ran before prefix-LM was
// added (one kernel for both ran the 32k causal call 3.5-5.6% slower on
// the H100, with the same bits).  Two routes, by dtype:
//
// bfloat16: flash_fwd_tc_kernel, on the tensor cores.  Bound: at the
// prefill shape (B=2, S=4,096, 12/2 heads, HD=128, causal) a launch does
// 1.03e11 useful FLOP (2*(HDQK + HDV) per unmasked (query, key) pair)
// against 25 MB of q, k, v and o, ~4,000 FLOP per byte: the tensor cores'
// 989 TFLOP/s bound it (0.104 ms), not memory; MLA's (192, 128) does 1.25x
// the FLOP of (128, 128) a pair.  Design:
//  - one block per (batch x head, 128-row query tile): two consumer
//    warpgroups of 64 rows each and one producer warp (288 threads); at
//    (256, 256) one consumer warpgroup, 64 rows and 160 threads (tc::Cfg):
//    its 128 accumulator registers a thread, with the 64 of the scores and
//    P, fit the 255 a thread of a 160-thread block, not the ~168 that
//    ptxas grants 288 threads; FlashAttention-3's setmaxnreg split (a
//    producer warpgroup handing registers to two consumers) would keep
//    128 rows a block, at the cost of a third warpgroup's barriers;
//  - the producer starts TMA loads (cp.async.bulk.tensor, 128-byte
//    swizzle, one mbarrier per stage) of the Q tile once and of 64-key K
//    and V tiles into a ring of STAGES stages, so the next tiles load while
//    this one is multiplied; the consumers free a stage by an mbarrier.
//    The Q tile and the K ring take ceil(HDQK/64) 128-byte column blocks,
//    the V ring ceil(HDV/64): at (192, 128) 1,024 + 128 x (3 x 128 + 4 x 64
//    x (3 + 2)) = 214,016 bytes (+ barriers) of the 232,448 a block may
//    have.  V padded to 192 (a square (192, 192)) would need ~246 KB and
//    a third more P . V work.  (256, 256) takes 2 stages and 64 query
//    rows: 164,864 bytes (4 stages would be 328,704 at 128 rows);
//  - S = q . k^T by wgmma (m64n64k16, both operands in shared memory; 4
//    k-steps a column block, so 12 at HDQK = 192), f32 accumulation from
//    the bf16 operands as they are; the f32 scores are then scaled.  The
//    reference multiplies q by scale in f32 before the dot: the two orders
//    differ by f32 rounding, ~1e-7 relative;
//  - softmax in the log2 domain: p = exp2(s * scale*log2(e) - m *
//    scale*log2(e)) by ex2.approx (relative error ~2^-22) where the
//    reference calls exp; m and l are f32, l sums the unrounded f32 p;
//  - P . V by wgmma with P from registers (the S accumulator's fragment is
//    the A operand's) and V as the B operand in its own (keys x HDV) layout
//    through the transpose bit: no transposed copy of V.  The accumulator
//    is ceil(HDV/64) x 32 registers a thread (64 at HDV = 128, as at
//    (128, 128); 128 at HDV = 256, one m64n256k16 a k-step).  P is split
//    in two bf16 parts, hi = bf16(p) and lo = bf16(p - hi), and both are
//    multiplied into the same f32 accumulator:
//    P rounded to bf16 alone (FlashAttention-2's choice) moves outputs
//    near zero by ~20x the card check's bar (one bf16 ulp plus 1e-3 rms),
//    hi + lo keeps p to ~2^-16.  The split costs 2 * HDV more FLOP a pair
//    on the tensor cores; bound and TFLOP/s count the useful 2*(HDQK +
//    HDV) FLOP per pair only;
//  - HD = 120 is zero-padded to 128 on the reduction side: the tensor maps'
//    inner dimension is 120, so TMA fills columns 120..127 with zeros;
//    stores are masked to HDV columns and to rows < Sq; q and k/v have a
//    tensor map each, so TMA fills rows >= Sq and keys >= Sk with zeros
//    and the mask drops those keys;
//  - the output acc / max(l, 1e-30) is rounded to nearest even into bf16
//    and stored from registers;
//  - inside a warpgroup the softmax waits for Q . K^T and P . V waits for
//    the softmax; the two warpgroups run apart (only the ring couples
//    them), so one's softmax overlaps the other's MMAs.  Overlapping a
//    warpgroup's own softmax with its P . V of the previous tile (as
//    FlashAttention-3 does) measured no faster on the H100, and 128-key
//    tiles spill at HD = 128: ptxas holds this 288-thread block to 168
//    registers, and the 64-key version uses 165.
//
// float32: flash_fwd_kernel, on the CUDA cores (scores and P . V as f32
// FMAs from shared memory, a 4 x 4 register tile per thread).  It keeps the
// reference's order of arithmetic (q cast to f32 and scaled before the
// dot) and serves the float32 model and its agreement checks.
#include <cuda.h>  // CUtensorMap and its enums, types only: no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// ------------------------------------------------ float32: CUDA cores

#define BQ 64
#define BK 64
#define THREADS 256
#define NEG_INF (-1e30f)

template <int HDQK, int HDV>
constexpr size_t smem_floats() {
  return (size_t)BQ * (HDQK + 1) + (size_t)BK * (HDQK + 1) +
         (size_t)BK * HDV;
}

// One block per (batch x head, 64-row query tile); K/V tiles of 64 rows
// staged through shared memory as float32 (rows padded to an odd stride,
// so the 16 threads reading 16 key rows hit 16 banks); each thread keeps a
// 4 x 4 tile of scores and a 4 x HDV/16 tile of the accumulator.  P reuses
// the K tile's shared memory: ~99 KB at HDQK = HDV = 128, two blocks per SM;
// ~129 KB at (192, 128) (MLA) and 197,120 bytes at (256, 256) (PaliGemma),
// one block per SM; at (256, 256) the 4 x 16 accumulator tile takes the
// register budget of one block an SM.
template <int HDQK, int HDV, bool PREFIX>
__global__ void __launch_bounds__(THREADS, HDV > 128 ? 1 : 2)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int Sq, int Sk, int H,
                     int KV, int causal, int window, int prefix, float scale,
                     int n_qt) {
  constexpr int LD = HDQK + 1;          // padded row of the Q and K tiles
  constexpr int PLD = BK + 1;           // padded row of P
  constexpr int NC = (HDV + 15) / 16;   // accumulator columns per thread
  static_assert(BK * LD >= BQ * PLD, "P must fit in the K tile");
  extern __shared__ float smem[];
  float* Qs = smem;                     // BQ x LD, scaled q
  float* Ks = Qs + BQ * LD;             // BK x LD, then P (BQ x PLD)
  float* Vs = Ks + BK * LD;             // BK x HDV
  float* Ps = Ks;

  const int tid = threadIdx.x;
  const int tx = tid & 15;              // key columns tx + 16j, acc cols
  const int ty = tid >> 4;              // query rows 4ty .. 4ty+3
  const int qt = n_qt - 1 - (int)blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int kvh = h / (H / KV);
  const int q0 = qt * BQ;
  const int64_t qrow = (int64_t)H * HDQK, krow = (int64_t)KV * HDQK;
  const int64_t vrow = (int64_t)KV * HDV, orow = (int64_t)H * HDV;
  const float* qb = q + (int64_t)b * Sq * qrow + (int64_t)h * HDQK;
  const float* kb = k + (int64_t)b * Sk * krow + (int64_t)kvh * HDQK;
  const float* vb = v + (int64_t)b * Sk * vrow + (int64_t)kvh * HDV;
  float* ob = o + (int64_t)b * Sq * orow + (int64_t)h * HDV;

  for (int e = tid; e < BQ * HDQK; e += THREADS) {
    const int r = e / HDQK, c = e - r * HDQK;
    const int qi = q0 + r;
    Qs[r * LD + c] = qi < Sq ? qb[(int64_t)qi * qrow + c] * scale : 0.f;
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
  const int k_lo = window > 0 && !PREFIX ? max(0, q0 - window + 1) : 0;
  const int k_hi =
      causal ? min(Sk, PREFIX ? max(q0 + BQ, prefix) : q0 + BQ) : Sk;
  const int kt_lo = k_lo / BK, kt_hi = (k_hi + BK - 1) / BK;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                    // Q staged / last tile's P, V read
    for (int e = tid; e < BK * HDQK; e += THREADS) {
      const int r = e / HDQK, c = e - r * HDQK;
      const int ki = k0 + r;
      Ks[r * LD + c] = ki < Sk ? kb[(int64_t)ki * krow + c] : 0.f;
    }
    for (int e = tid; e < BK * HDV; e += THREADS) {
      const int r = e / HDV, c = e - r * HDV;
      const int ki = k0 + r;
      Vs[r * HDV + c] = ki < Sk ? vb[(int64_t)ki * vrow + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HDQK; ++d) {
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
        ok[j] = ki < Sk && ((PREFIX && ki < prefix) ||
                            ((!causal || qi >= ki) &&
                             (window <= 0 || qi - ki < window)));
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
        va[cc] = col < HDV ? Vs[c * HDV + col] : 0.f;
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
    if (qi >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    if (lse != nullptr && tx == 0)        // m is in units of scaled scores
      lse[((int64_t)b * H + h) * Sq + qi] = m[i] + logf(denom);
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int col = tx + 16 * cc;
      if (col < HDV) ob[(int64_t)qi * orow + col] = acc[i][cc] / denom;
    }
  }
}

template <int HDQK, int HDV>
static int launch_f32(const void* q, const void* k, const void* v, void* o,
                      float* lse, int64_t B, int64_t Sq, int64_t Sk, int64_t H,
                      int64_t KV, int causal, int window, int prefix,
                      float scale, cudaStream_t st) {
  const size_t smem = smem_floats<HDQK, HDV>() * sizeof(float);
  auto kernel = prefix > 0 ? flash_fwd_kernel<HDQK, HDV, true>
                           : flash_fwd_kernel<HDQK, HDV, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_qt = (int)((Sq + BQ - 1) / BQ);
  const dim3 grid((unsigned)n_qt, (unsigned)(B * H));
  kernel<<<grid, THREADS, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse,
      (int)Sq,
      (int)Sk, (int)H, (int)KV, causal, window, prefix, scale, n_qt);
  return (int)cudaGetLastError();
}

#undef BQ
#undef BK
#undef THREADS
#undef NEG_INF

// --------------------------------------------- bfloat16: tensor cores

namespace tc {

constexpr int BK = 64;        // keys per K/V tile
constexpr int ROWB = 128;     // bytes per smem row: 64 bf16, one swizzle span

// The block's layout by (HDQK, HDV): WG consumer warpgroups of 64 query
// rows each and one producer warp, and a K/V ring of STAGES tiles.  Up to
// HDV = 128: 2 warpgroups (BQ = 128, 288 threads) and 4 stages.  At HDV =
// 256 the accumulator is 128 f32 registers a thread, which 288 threads
// cannot hold beside the scores (ptxas caps that block near 168 a
// thread): one warpgroup (BQ = 64, 160 threads, up to 255 registers) and
// 2 stages, 1,024 + 4 x 128 x (64 + 2 x 64) + 4 x 128 x 2 x 64 = 164,864
// bytes; 128 rows would need 197,632 at 2 stages and 328,704 at 4.
template <int HDQK, int HDV>
struct Cfg {
  static constexpr int WG = HDV > 128 ? 1 : 2;
  static constexpr int BQ = 64 * WG;             // query rows per block
  static constexpr int THREADS = 128 * WG + 32;
  static constexpr int STAGES = HDV > 128 ? 2 : 4;
  // 1,024 of slack to align the tiles, the Q tile and the K ring (HDQK
  // wide), the V ring (HDV wide), and 2 * STAGES + 1 mbarriers
  static constexpr int SMEM = 1024 +
      ((HDQK + 63) / 64) * ROWB * (BQ + STAGES * BK) +
      ((HDV + 63) / 64) * ROWB * STAGES * BK + 8 * (2 * STAGES + 1);
};

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
// byte aligned).  K-major operands (Q, K) take lbo = 16 (unused) and
// sbo = 1,024, the stride between 8-row groups; the MN-major operand (V)
// takes lbo = the stride between its 64-column blocks and sbo = 1,024, the
// stride between 8-key groups.  A k-step inside the 128-byte row advances
// the start address by 32 bytes; the swizzle is applied on the address.
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

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

// The wgmma instructions, bf16 in, f32 accumulators (64 rows over the
// warpgroup: warp w holds rows 16w..16w+15, register 4j + 2i + c of a lane
// is row lane/4 + 8i, column 8j + 2(lane%4) + c).  ss: A and B from shared
// memory, both K-major, scale_d = 0 overwrites D.  rs: A from registers (a
// k16 fragment, 4 bf16x2), B MN-major (the transpose bit), D accumulated.
// ss is m64n64k16; rs is m64n64k16, m64n128k16 or m64n256k16 (32, 64 or 128
// accumulators), the overload chosen by the accumulator array's size.
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

__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

constexpr int NS = BK / 2;   // score registers per thread (64 x BK / 128)

// start S = Q . K^T for this warpgroup's 64 rows and one K tile (the Q
// tile's column blocks are BQ rows apart)
template <int ND, int BQ>
__device__ __forceinline__ void start_qk(float (&s)[NS], uint32_t qaddr,
                                         uint32_t kaddr) {
#pragma unroll
  for (int db = 0; db < ND; ++db)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(s, desc(qaddr + db * BQ * ROWB + kk * 32, 16, 1024),
               desc(kaddr + db * BK * ROWB + kk * 32, 16, 1024),
               (db | kk) != 0);
}

// start O += (P hi + P lo) . V for one V tile; registers 4kk..4kk+3 of
// phi and plo are the A fragments of keys 16kk..16kk+15
template <int ND>
__device__ __forceinline__ void start_pv(float (&acc)[ND * 32],
                                         const uint32_t (&phi)[NS / 2],
                                         const uint32_t (&plo)[NS / 2],
                                         uint32_t vaddr) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t dv = desc(vaddr + kk * 16 * ROWB, BK * ROWB, 1024);
    wgmma_rs(acc, phi + 4 * kk, dv);
    wgmma_rs(acc, plo + 4 * kk, dv);
  }
}

// What a thread needs to mask and scale its scores: rows r0 and r0 + 8,
// key columns 8j + cq + {0, 1} of each 8-key chunk j
struct Rows {
  int r0, cq, Sk, causal, window, prefix;
  float c2;  // scale * log2(e)
};

// The online-softmax step for the scores s of the K tile at k0: mask what
// rows r0 and r0 + 8 may not attend (only where the tile straddles an
// edge: Sk, the diagonal, the window, the prefix's end), update m and
// this lane's share of l, turn s into p in place, and
// return in corr the factor that rescales the accumulator.  A row's 64
// scores lie on the 4 lanes of a quad.
template <bool PREFIX>
__device__ __forceinline__ void softmax_tile(float (&s)[NS], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             const Rows& r, int k0,
                                             bool edge) {
  if (edge) {
#pragma unroll
    for (int j = 0; j < NS / 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = r.r0 + 8 * (e >> 1);
        const int ki = k0 + 8 * j + r.cq + (e & 1);
        const bool ok = ki < r.Sk && ((PREFIX && ki < r.prefix) ||
                                      ((!r.causal || qi >= ki) &&
                                       (r.window <= 0 || qi - ki < r.window)));
        if (!ok) s[4 * j + e] = -INFINITY;
      }
  }
  float base[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NS / 4; ++j)
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[i], mx);
    base[i] = m_new == -INFINITY ? 0.f : m_new * r.c2;  // no key yet
    corr[i] = ex2(m[i] * r.c2 - base[i]);
    m[i] = m_new;
  }
  float ps[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NS / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = ex2(fmaf(s[4 * j + e], r.c2, -base[e >> 1]));
      ps[e >> 1] += s[4 * j + e];
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + ps[i];
}

// p as hi = bf16(p) and lo = bf16(p - hi); register x of each holds
// scores 2x and 2x + 1 (one row, two adjacent keys)
__device__ __forceinline__ void split_p(const float (&s)[NS],
                                        uint32_t (&phi)[NS / 2],
                                        uint32_t (&plo)[NS / 2]) {
#pragma unroll
  for (int x = 0; x < NS / 2; ++x) {
    phi[x] = pack_bf16(s[2 * x], s[2 * x + 1]);
    const float2 hf = unpack_bf16(phi[x]);
    plo[x] = pack_bf16(s[2 * x] - hf.x, s[2 * x + 1] - hf.y);
  }
}

template <int NO>
__device__ __forceinline__ void rescale(float (&acc)[NO],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int j = 0; j < NO / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[4 * j + e] *= corr[e >> 1];
}

__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);       // this warp is done with the stage
}

}  // namespace tc

template <int HDQK, int HDV, bool PREFIX>
__global__ void __launch_bounds__(tc::Cfg<HDQK, HDV>::THREADS, 1)
    flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        __nv_bfloat16* __restrict__ o,
                        float* __restrict__ lse, int Sq, int Sk, int H,
                        int KV, int causal, int window, int prefix, float c2,
                        int n_qt) {
  using namespace tc;
  constexpr int BQ = Cfg<HDQK, HDV>::BQ;
  constexpr int STAGES = Cfg<HDQK, HDV>::STAGES;
  constexpr int WG = Cfg<HDQK, HDV>::WG;
  constexpr int NQK = (HDQK + 63) / 64;     // 64-column blocks of a q/k row
  constexpr int NV = (HDV + 63) / 64;       // ... of a v/o row
  constexpr int QBYTES = NQK * BQ * ROWB;   // the Q tile
  constexpr int KBYTES = NQK * BK * ROWB;   // one K tile
  constexpr int VBYTES = NV * BK * ROWB;    // one V tile
  constexpr int NO = NV * 32;               // accumulator registers
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint8_t* Ks = Qs + QBYTES;                // STAGES x KBYTES
  uint8_t* Vs = Ks + STAGES * KBYTES;       // STAGES x VBYTES
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + STAGES * VBYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qt = n_qt - 1 - (int)blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int kvh = h / (H / KV);
  const int q0 = qt * BQ;
  // KV tiles that some row of this block attends: with a prefix, every
  // row attends keys 0..prefix-1, so a causal tile reaches past the
  // diagonal to the prefix's end and a window does not cut the start
  const int k_lo = window > 0 && !PREFIX ? max(0, q0 - window + 1) : 0;
  const int k_hi =
      causal ? min(Sk, PREFIX ? max(q0 + BQ, prefix) : q0 + BQ) : Sk;
  const int kt_lo = k_lo / BK;
  const int n_kt = (k_hi + BK - 1) / BK - kt_lo;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * WG);         // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * WG) {                     // the producer warp
    if (lane == 0) {
      mbar_expect_tx(qbar, QBYTES);
      for (int db = 0; db < NQK; ++db)
        tma_load(Qs + db * BQ * ROWB, &tq, qbar, db * 64, h, q0, b);
      for (int it = 0; it < n_kt; ++it) {
        const int st = it % STAGES;
        mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[st], KBYTES + VBYTES);
        const int k0 = (kt_lo + it) * BK;
        for (int db = 0; db < NQK; ++db)
          tma_load(Ks + st * KBYTES + db * BK * ROWB, &tk, &full[st],
                   db * 64, kvh, k0, b);
        for (int db = 0; db < NV; ++db)
          tma_load(Vs + st * VBYTES + db * BK * ROWB, &tv, &full[st],
                   db * 64, kvh, k0, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows qw .. qw+63 and needs tiles it_lo ..
  // it_hi-1 of the block's n_kt; it frees the others as they arrive
  const int wg = warp >> 2;
  const int qw = q0 + 64 * wg;
  const Rows rows{qw + 16 * (warp & 3) + (lane >> 2), 2 * (lane & 3), Sk,
                  causal, window, prefix, c2};
  const int kw_lo = window > 0 && !PREFIX ? max(0, qw - window + 1) : 0;
  const int kw_hi =
      causal ? min(Sk, PREFIX ? max(qw + 64, prefix) : qw + 64) : Sk;
  const int it_lo = kw_lo / BK - kt_lo;
  const int it_hi = min(n_kt, (kw_hi + BK - 1) / BK - kt_lo);
  const uint32_t qaddr = smem_u32(Qs) + wg * 64 * ROWB;
  // the tile at it is not attended whole by every row of this warpgroup:
  // it crosses Sk, or ends past the prefix and straddles the diagonal or
  // the window's edge
  auto edge = [&](int it) {
    const int k0 = (kt_lo + it) * BK;
    return ((!PREFIX || k0 + BK > prefix) &&
            ((causal && k0 + BK - 1 > qw) ||
             (window > 0 && k0 <= qw + 63 - window))) ||
           k0 + BK > Sk;
  };
  auto kaddr = [&](int it) { return smem_u32(Ks + (it % STAGES) * KBYTES); };
  auto vaddr = [&](int it) { return smem_u32(Vs + (it % STAGES) * VBYTES); };
  auto wait_full = [&](int it) {
    mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
  };

  float acc[NO], m[2], l[2], corr[2], s[NS];
  uint32_t phi[NS / 2], plo[NS / 2];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;                             // this lane's share of the row
  }
  mbar_wait(qbar, 0);

  int it = 0;
  for (; it < min(it_lo, n_kt); ++it) {     // tiles only the other needs
    wait_full(it);
    release(&empty[it % STAGES], lane);
  }
  for (; it < it_hi; ++it) {
    wait_full(it);
    reg_fence(s);
    wg_fence();
    start_qk<NQK, BQ>(s, qaddr, kaddr(it));
    wg_commit();
    wg_wait<0>();
    reg_fence(s);
    softmax_tile<PREFIX>(s, m, l, corr, rows, (kt_lo + it) * BK, edge(it));
    rescale(acc, corr);
    split_p(s, phi, plo);
    reg_fence(acc);
    reg_fence(phi);
    reg_fence(plo);
    wg_fence();
    start_pv<NV>(acc, phi, plo, vaddr(it));
    wg_commit();
    wg_wait<0>();
    reg_fence(acc);
    reg_fence(phi);
    reg_fence(plo);
    release(&empty[it % STAGES], lane);
  }
  for (; it < n_kt; ++it) {                 // tiles only the other needs
    wait_full(it);
    release(&empty[it % STAGES], lane);
  }

  // the quad's shares of l, then the stores (rows < Sq, columns < HDV)
  const int64_t orow = (int64_t)H * HDV;
  __nv_bfloat16* ob = o + (int64_t)b * Sq * orow + (int64_t)h * HDV;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int qi = rows.r0 + 8 * i;
    if (qi >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    // m is a raw score: m * c2 + log2(l) is the log-sum-exp in log2 units
    if (lse != nullptr && (lane & 3) == 0)
      lse[((int64_t)b * H + h) * Sq + qi] =
          (m[i] * rows.c2 + log2f(denom)) * 0.6931471805599453f;
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      const int col = 8 * j + rows.cq;
      if (col < HDV)
        *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)qi * orow + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * i] / denom,
                                  acc[4 * j + 2 * i + 1] / denom);
    }
  }
}

// ------------------------------------------------------------------ host

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (the library
// then needs no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
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
static bool make_map(CUtensorMap* map, const void* ptr, int64_t B, int64_t S,
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

template <int HDQK, int HDV>
static int launch_tc(const void* q, const void* k, const void* v, void* o,
                     float* lse, int64_t B, int64_t Sq, int64_t Sk,
                     int64_t H, int64_t KV, int causal, int window,
                     int prefix, float scale, cudaStream_t st) {
  using C = tc::Cfg<HDQK, HDV>;
  // TMA reads from 16-byte aligned addresses
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) & 15)
    return (int)cudaErrorMisalignedAddress;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, Sq, H, HDQK, C::BQ) ||
      !make_map(&tk, k, B, Sk, KV, HDQK, tc::BK) ||
      !make_map(&tv, v, B, Sk, KV, HDV, tc::BK))
    return (int)cudaErrorInvalidValue;
  auto kernel = prefix > 0 ? flash_fwd_tc_kernel<HDQK, HDV, true>
                           : flash_fwd_tc_kernel<HDQK, HDV, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int n_qt = (int)((Sq + C::BQ - 1) / C::BQ);
  const dim3 grid((unsigned)n_qt, (unsigned)(B * H));
  const float log2e = 1.4426950408889634f;
  kernel<<<grid, C::THREADS, C::SMEM, st>>>(
      tq, tk, tv, (__nv_bfloat16*)o, lse, (int)Sq, (int)Sk, (int)H, (int)KV,
      causal, window, prefix, scale * log2e, n_qt);
  return (int)cudaGetLastError();
}

template <int HDQK, int HDV>
static int launch(const void* q, const void* k, const void* v, void* o,
                  float* lse, int64_t B, int64_t Sq, int64_t Sk, int64_t H,
                  int64_t KV, int causal, int window, int prefix, float scale,
                  bool bf16, cudaStream_t st) {
  return bf16 ? launch_tc<HDQK, HDV>(q, k, v, o, lse, B, Sq, Sk, H, KV,
                                     causal, window, prefix, scale, st)
              : launch_f32<HDQK, HDV>(q, k, v, o, lse, B, Sq, Sk, H, KV,
                                      causal, window, prefix, scale, st);
}

// the instantiated (q/k head_dim, v head_dim) pairs, one switch key each
constexpr int64_t pair_key(int64_t hd, int64_t hdv) {
  return hd * 4096 + hdv;
}

// q (B, Sq, H, hd), k (B, Sk, KV, hd), v (B, Sk, KV, hdv), o (B, Sq, H,
// hdv), contiguous, one dtype: bf16 when is_bf16 (the tensor-core kernel),
// else float32 (the CUDA-core kernel).  (hd, hdv) in {(64, 64), (120, 120),
// (128, 128), (192, 128), (256, 256)}; H % KV == 0; a causal call has Sq
// == Sk; window <= 0 means none; keys below `prefix` are attended by every
// query; scores are scaled by `scale`.  lse: null, or float32 (B, H, Sq)
// for each row's log-sum-exp.  Launches on `stream`, allocates nothing,
// does not synchronise; returns cudaGetLastError().
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int64_t B, int64_t Sq,
                              int64_t Sk, int64_t H, int64_t KV, int64_t hd,
                              int64_t hdv, int64_t causal, int64_t window,
                              int64_t prefix, double scale, int64_t is_bf16,
                              void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return (int)cudaSuccess;
  if (KV <= 0 || H % KV != 0 || B * H > 65535 || Sk <= 0 ||
      Sq > (int64_t)1 << 30 || Sk > (int64_t)1 << 30 ||
      (causal && Sq != Sk) || hd <= 0 || hdv <= 0 || hd >= 4096 ||
      hdv >= 4096)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int w = window > 0 ? (int)window : 0;
  const int pf = prefix > 0 ? (int)(prefix < Sk ? prefix : Sk) : 0;
  const int c = (int)causal;
  const float sc = (float)scale;
  const bool bf16 = is_bf16 != 0;
  switch (pair_key(hd, hdv)) {
#define FLASH_PAIR(A, V)                                                   \
  case pair_key(A, V):                                                     \
    return launch<A, V>(q, k, v, o, (float*)lse, B, Sq, Sk, H, KV, c, w, pf, \
                        sc, bf16, st);
    FLASH_PAIR(64, 64)
    FLASH_PAIR(120, 120)
    FLASH_PAIR(128, 128)
    FLASH_PAIR(192, 128)
    FLASH_PAIR(256, 256)
#undef FLASH_PAIR
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int HDQK, int HDV>
static int smem_of(bool bf16) {
  return bf16 ? tc::Cfg<HDQK, HDV>::SMEM
              : (int)(smem_floats<HDQK, HDV>() * sizeof(float));
}

// Dynamic shared memory of one block of the kernel that flash_attn_fwd
// launches for this (hd, hdv) pair and dtype, in bytes (0 for a pair it
// does not take).
extern "C" int flash_attn_smem_bytes(int64_t hd, int64_t hdv,
                                     int64_t is_bf16) {
  const bool bf16 = is_bf16 != 0;
  if (hd <= 0 || hdv <= 0 || hd >= 4096 || hdv >= 4096) return 0;
  switch (pair_key(hd, hdv)) {
    case pair_key(64, 64):
      return smem_of<64, 64>(bf16);
    case pair_key(120, 120):
      return smem_of<120, 120>(bf16);
    case pair_key(128, 128):
      return smem_of<128, 128>(bf16);
    case pair_key(192, 128):
      return smem_of<192, 128>(bf16);
    case pair_key(256, 256):
      return smem_of<256, 256>(bf16);
    default:
      return 0;
  }
}
