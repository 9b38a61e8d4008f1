// The backward pass of causal GQA attention on Hopper's tensor cores, for
// bf16 operands, sm_90a. f32 operands keep the CUDA-core kernels of
// flash_attention_bwd.cu.
//
// Replaces: src/repro/kernels/flash_attention.py :: flash_attention_pallas
// (_flash_kernel), its VJP on the train path. The reference differentiates
// its plain-jnp attention; the port's forward is the kernel of
// flash_attention_wgmma.cu, so its gradient passes through this one.
//
// The function, for q (B, H, S, D), k and v (B, KVH, T, D), H = KVH G, the
// forward's output o and row log-sum-exp lse (B, H, S) of the scaled
// logits, and the output's gradient do:
//   P  = exp(scale q k^T - lse)        0 above the causal diagonal (aligned
//                                      to the end of the kv axis) and past T
//   dV = sum over the G heads of P^T do
//   dP = do v^T,  delta = rowsum(do o),  dS = P (dP - delta)
//   dQ = scale dS k,  dK = scale sum over the G heads of dS^T q
// the gradients written in bf16 in their operands' layouts. q k^T and do
// v^T are bf16 x bf16 -> f32 wgmmas: a product of two bf16 values is exact
// in f32, so only the order of the f32 sums differs from the plain version.
// P and dS are not rounded to bf16 once: each is split as x = x_hi + x_lo,
// both bf16, x_lo = bf16(x - x_hi), as the forward splits p, and each
// product with it is two register-A wgmmas into one f32 accumulator, which
// carries P and dS to about 2^-16 relative, far below the gradients' bf16
// rounding.
//
// What bounds it on this card: operations. Five (rows x keys x D) products
// over the causal half: at Zamba2-2.7B's training shape (B 2, H = KVH 32,
// S = T 4,096, D 80) 4.3e11 operations, 0.434 ms at the 989 TFLOP/s bf16
// rate, against 0.1 ms of memory. This design's own tensor-core work is
// about twice that: S^T and dP^T once each and dV, dK with the hi + lo
// split twice each in the dK/dV pass; S and dP recomputed and dQ split in
// the dQ pass; ten product-equivalents, 0.87 ms at the bf16 rate; it takes
// 2.8 ms on one H100 (PERF.md). What holds it above that: the P and dS
// arithmetic and splits between a warpgroup's two product batches, which
// both consumer warpgroups run at the same time (they wait on the same
// tile), and the 168-register cap of 288 threads, under which dK/dV
// spills. Each wgmma form here runs at the bf16 rate when issued alone.
//
// Design: FlashAttention-2's two deterministic passes, each built as the
// forward is (flash_common.cuh): a producer warp streams tiles by TMA
// through 4-D tensor maps built from the operands' own strides into a ring
// of 128-byte-swizzled slabs guarded by mbarriers (full: data landed;
// empty: both consumer warpgroups are done), and an ordinary-load staging
// of the same layout where TMA's 16-byte rules fail. Each output is summed
// by the one CTA that owns it, in a fixed order: no atomics, so two calls
// give the same bits.
//  - bwd_prep_kernel: delta = rowsum(do o) (one warp a row, a fixed
//    shuffle tree) and lse log2(e), into an f32 scratch of (B H, S_pad)
//    rows each, S_pad = S rounded up to kRowPad; rows past S take lse =
//    +inf, so their P is exp2(-inf) = 0 without a mask.
//  - dkdv_wgmma_kernel: one CTA per (b, kv head, 128-key tile), the key
//    tiles with the most query tiles first; two consumer warpgroups of 64
//    keys each, whose dK and dV stay in f32 registers (m64nD). The k and v
//    tiles are loaded once; the producer then streams the 64-row q and do
//    tiles of each of the G heads in turn, with their lse and delta rows
//    (bulk copies), through a 2-stage ring. Per q tile: S^T = k q^T and
//    dP^T = v do^T as m64n64k16 wgmmas from shared memory; P^T and dS^T on
//    the accumulator fragments in registers; dV += P^T do and dK += dS^T q
//    as m64nDk16 register-A wgmmas (hi, then lo) with do and q read
//    MN-major. q tiles wholly above a warpgroup's keys are skipped; only
//    diagonal tiles and the kv end are masked.
//  - dq_wgmma_kernel: one CTA per (b, head, 128-row q block), the blocks
//    with the most kv tiles first; two consumer warpgroups of 64 rows. q,
//    do and the rows' lse and delta are loaded once, 64-key k and v tiles
//    stream through the ring; S and dP are recomputed, and dQ += dS k is a
//    register-A wgmma with dS split hi + lo. Tiles wholly above the
//    diagonal are never loaded.
//
// Shared memory at D 80 (two slabs): dK/dV 129 KB a CTA (k and v 64 KB,
// two stages of q and do 64 KB, lse and delta 1 KB), dQ 129 KB; one CTA of
// 288 threads an SM for each. Registers (ptxas, printed by chip_smoke.py's
// phases 1 and 22c): at D 80 dK/dV 168 with 168 bytes of spills, dQ 150
// without; at D 128 dK/dV spills 432 bytes and dQ 80; from D 48 down
// nothing spills; the delta kernel 29.
#include <math.h>

#include "flash_common.cuh"

namespace {

constexpr int kBQ = 64;        // dK/dV pass: query rows a stage
constexpr int kBKV = 128;      // dK/dV pass: keys a CTA, 64 a consumer warpgroup
constexpr int kQB = 128;       // dQ pass: query rows a CTA, 64 a consumer warpgroup
constexpr int kKB = 64;        // dQ pass: keys a stage
constexpr int kRowPad = 128;   // the scratch's rows a (b, head): S rounded up to this
constexpr int kStages = 2;     // ring depth of both passes
constexpr int kConsumers = 256;           // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const __nv_bfloat16 *q, *k, *v, *o, *dout;
  __nv_bfloat16 *dq, *dk, *dv;
  const float* lse;  // (B, H, S) from the forward
  float* lse2;       // scratch (B H, S_pad): lse log2(e), +inf past S
  float* delta;      // scratch (B H, S_pad): rowsum(do o), 0 past S
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int B, H, KVH, G, S, S_pad, T, D, causal, use_tma, pair_store;
  float scale, scale_log2;
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);  // the swizzle atoms' alignment
}

// x = hi + lo for two values, both parts bf16 pairs (the A-fragment
// register layout: the lower column in the low half)
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h2);
  const __nv_bfloat162 l2 = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h2);
  lo = *reinterpret_cast<const uint32_t*>(&l2);
}

// 16 k-steps' fragments of a 64 x 64 accumulator: for K-step kk (columns
// 16kk .. 16kk + 15) register g holds x[8kk + 2g], x[8kk + 2g + 1]
__device__ __forceinline__ void split_frags(const float (&x)[32], uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int g = 0; g < 4; ++g) split2(x[8 * kk + 2 * g], x[8 * kk + 2 * g + 1], hi[kk][g], lo[kk][g]);
}

// rows (keys or query rows) of one accumulator fragment m64nDP written as
// bf16 times ``mul``: acc[4j + 2h + e] is row row0 + 8h, column 8j + 2(lane
// % 4) + e
template <int DP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long row_stride,
                                           const float (&acc)[DP / 2], int row0, int n_rows,
                                           int D, int lane, float mul, int pair_store) {
  const int quad_col = 2 * (lane % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= n_rows) continue;
    __nv_bfloat16* r = base + (long long)row * row_stride;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + quad_col;
      const float v0 = acc[4 * j + 2 * h] * mul, v1 = acc[4 * j + 2 * h + 1] * mul;
      if (pair_store && col + 1 < D) {
        *reinterpret_cast<__nv_bfloat162*>(r + col) = __floats2bfloat162_rn(v0, v1);
      } else {
        if (col < D) r[col] = __float2bfloat16(v0);
        if (col + 1 < D) r[col + 1] = __float2bfloat16(v1);
      }
    }
  }
}

// delta and lse log2(e) of every row of the scratch: one warp a row
__global__ void __launch_bounds__(256) bwd_prep_kernel(Args a) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)a.B * a.H * a.S_pad) return;
  const long long bh = row / a.S_pad;
  const int i = (int)(row % a.S_pad);
  const int bi = (int)(bh / a.H), hi = (int)(bh % a.H);
  float acc = 0.f;
  if (i < a.S) {
    const __nv_bfloat16* orow = a.o + bi * a.so.b + hi * a.so.h + (long long)i * a.so.s;
    const __nv_bfloat16* drow = a.dout + bi * a.sdo.b + hi * a.sdo.h + (long long)i * a.sdo.s;
    for (int d = lane; d < a.D; d += 32)
      acc = fmaf(__bfloat162float(drow[d]), __bfloat162float(orow[d]), acc);
  }
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) {
    a.delta[row] = acc;
    a.lse2[row] = i < a.S ? a.lse[bh * a.S + i] * kLog2e : INFINITY;
  }
}

// DP: D rounded up to 16, the N of the dK and dV wgmmas
template <int DP>
__global__ void __launch_bounds__(kThreads, 1) dkdv_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv, Args a) {
  constexpr int NS = (DP + 63) / 64;  // 64-column slabs
  constexpr int KD = DP / 16;         // K-steps of the score products
  constexpr int kKVBytes = NS * kBKV * kSlabBytes;
  constexpr int kQBytes = NS * kBQ * kSlabBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = align1024(smem_raw);   // [NS][kBKV][128 B]
  uint8_t* vs = ks + kKVBytes;
  uint8_t* qs = vs + kKVBytes;         // [kStages][NS][kBQ][128 B]
  uint8_t* dos = qs + kStages * kQBytes;
  float* ls = reinterpret_cast<float*>(dos + kStages * kQBytes);  // [kStages][kBQ]
  float* dls = ls + kStages * kBQ;                                // [kStages][kBQ]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(dls + kStages * kBQ);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int BKV = a.B * a.KVH;
  const int kb = (int)(blockIdx.x / BKV);  // the key tiles with the most q tiles first
  const int bkv = (int)(blockIdx.x % BKV);
  const int bi = bkv / a.KVH, kvi = bkv % a.KVH;
  const int k0 = kb * kBKV;
  const int off = a.T - a.S;  // >= 0 when causal: row i sees key j iff j <= i + off
  const int qb_first = a.causal ? max(0, k0 - off) / kBQ : 0;
  const int nq = (a.S + kBQ - 1) / kBQ - qb_first;  // q tiles a head
  const int n_it = a.G * nq;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer warp: k and v once, then q, do, lse and delta of every
    // (head, q tile)
    const int lane = tid - kConsumers;
    if (a.use_tma) {
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * kKVBytes);
#pragma unroll
        for (int slab = 0; slab < NS; ++slab) {
          tma_load_4d(ks + slab * kBKV * kSlabBytes, &tk, kv_full, slab * 64, k0, kvi, bi);
          tma_load_4d(vs + slab * kBKV * kSlabBytes, &tv, kv_full, slab * 64, k0, kvi, bi);
        }
        for (int it = 0; it < n_it; ++it) {
          const int st = it % kStages;
          const int hi = kvi * a.G + it / nq, q0 = (qb_first + it % nq) * kBQ;
          if (it >= kStages) mbar_wait(&empty[st], (it / kStages - 1) & 1);
          mbar_expect_tx(&full[st], 2 * kQBytes + 2 * kBQ * 4);
#pragma unroll
          for (int slab = 0; slab < NS; ++slab) {
            tma_load_4d(qs + st * kQBytes + slab * kBQ * kSlabBytes, &tq, &full[st], slab * 64,
                        q0, hi, bi);
            tma_load_4d(dos + st * kQBytes + slab * kBQ * kSlabBytes, &tdo, &full[st],
                        slab * 64, q0, hi, bi);
          }
          const long long row = ((long long)bi * a.H + hi) * a.S_pad + q0;
          bulk_load(ls + st * kBQ, a.lse2 + row, kBQ * 4, &full[st]);
          bulk_load(dls + st * kBQ, a.delta + row, kBQ * 4, &full[st]);
        }
      }
    } else {
      stage_rows<NS>(ks, a.k + bi * a.sk.b + kvi * a.sk.h, a.sk.s, k0, kBKV, a.T, a.D, lane);
      stage_rows<NS>(vs, a.v + bi * a.sv.b + kvi * a.sv.h, a.sv.s, k0, kBKV, a.T, a.D, lane);
      if (lane == 0) mbar_arrive(kv_full);
      for (int it = 0; it < n_it; ++it) {
        const int st = it % kStages;
        const int hi = kvi * a.G + it / nq, q0 = (qb_first + it % nq) * kBQ;
        if (it >= kStages) mbar_wait(&empty[st], (it / kStages - 1) & 1);
        stage_rows<NS>(qs + st * kQBytes, a.q + bi * a.sq.b + hi * a.sq.h, a.sq.s, q0, kBQ, a.S,
                       a.D, lane);
        stage_rows<NS>(dos + st * kQBytes, a.dout + bi * a.sdo.b + hi * a.sdo.h, a.sdo.s, q0,
                       kBQ, a.S, a.D, lane);
        const long long row = ((long long)bi * a.H + hi) * a.S_pad + q0;
        for (int e = lane; e < kBQ; e += 32) {
          ls[st * kBQ + e] = a.lse2[row + e];
          dls[st * kBQ + e] = a.delta[row + e];
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&full[st]);
      }
    }
  } else {
    // consumer warpgroup wg: keys k0 + 64 wg .. + 63; this thread holds
    // keys kr and kr + 8 of the accumulator fragments
    const int wg = tid / 128, t = tid % 128, warp = t / 32, lane = t % 32;
    const int quad_col = 2 * (lane % 4);
    const int kw0 = k0 + wg * 64;
    const int kr = kw0 + warp * 16 + lane / 4;
    const uint8_t* kw = ks + wg * 64 * kSlabBytes;
    const uint8_t* vw = vs + wg * 64 * kSlabBytes;

    float dk[DP / 2], dv[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;

    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_it; ++it) {
      const int st = it % kStages;
      const int q0 = (qb_first + it % nq) * kBQ;
      mbar_wait(&full[st], (it / kStages) & 1);
      // every row of the tile before this warpgroup's first key, or no key
      // of it below T: nothing to add
      if ((a.causal && q0 + kBQ - 1 + off < kw0) || kw0 >= a.T) {
        mbar_arrive(&empty[st]);
        continue;
      }
      const uint8_t* qt = qs + st * kQBytes;
      const uint8_t* dot = dos + st * kQBytes;

      // S^T = k q^T and dP^T = v do^T, (64 keys, 64 rows) f32
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      pin(s);
      pin(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const int slab = kk / 4, koff = (kk % 4) * 32;
        const uint64_t dq_ = desc_sw128(qt + slab * kBQ * kSlabBytes + koff, 16, 1024);
        const uint64_t ddo = desc_sw128(dot + slab * kBQ * kSlabBytes + koff, 16, 1024);
        wgmma_ss_n64(s, desc_sw128(kw + slab * kBKV * kSlabBytes + koff, 16, 1024), dq_, 1);
        wgmma_ss_n64(dp, desc_sw128(vw + slab * kBKV * kSlabBytes + koff, 16, 1024), ddo, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(s);
      pin(dp);

      // P^T and dS^T on the fragments: s[4j + 2h + e] is key kr + 8h, query
      // row q0 + 8j + quad_col + e
      const float* lrow = ls + st * kBQ;
      const float* drow = dls + st * kBQ;
      const bool need_mask = (a.causal && kw0 + 63 > q0 + off) || kw0 + 64 > a.T;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + quad_col + e;
          const float l2 = lrow[col], dl = drow[col];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * j + 2 * h + e, key = kr + 8 * h;
            float x = s[i] * a.scale_log2 - l2;
            if (need_mask && ((a.causal && key > q0 + col + off) || key >= a.T)) x = -INFINITY;
            const float p = exp2f(x);
            s[i] = p;
            dp[i] = p * (dp[i] - dl);
          }
        }
      }
      uint32_t ph[4][4], pl[4][4], dh[4][4], dl4[4][4];
      split_frags(s, ph, pl);
      split_frags(dp, dh, dl4);
      pin(dv);
      pin(dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // query rows 16kk .. 16kk + 15 of the do and q tiles, read MN-major:
        // two 8-row groups 1024 bytes apart (SBO), the second slab kBQ rows
        // on (LBO)
        const uint64_t ddo = desc_sw128(dot + kk * 16 * kSlabBytes, kBQ * kSlabBytes, 1024);
        const uint64_t dq_ = desc_sw128(qt + kk * 16 * kSlabBytes, kBQ * kSlabBytes, 1024);
        wgmma_rs<DP>(dv, ph[kk], ddo);
        wgmma_rs<DP>(dv, pl[kk], ddo);
        wgmma_rs<DP>(dk, dh[kk], dq_);
        wgmma_rs<DP>(dk, dl4[kk], dq_);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(dv);
      pin(dk);
      mbar_arrive(&empty[st]);
    }

    store_rows<DP>(a.dk + bi * a.sdk.b + kvi * a.sdk.h, a.sdk.s, dk, kr, a.T, a.D, lane, a.scale,
                   a.pair_store);
    store_rows<DP>(a.dv + bi * a.sdv.b + kvi * a.sdv.h, a.sdv.s, dv, kr, a.T, a.D, lane, 1.f,
                   a.pair_store);
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1) dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv, Args a) {
  constexpr int NS = (DP + 63) / 64;
  constexpr int KD = DP / 16;
  constexpr int kQBytes = NS * kQB * kSlabBytes;
  constexpr int kKVBytes = NS * kKB * kSlabBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align1024(smem_raw);  // [NS][kQB][128 B]
  uint8_t* dos = qs + kQBytes;
  uint8_t* ks = dos + kQBytes;         // [kStages][NS][kKB][128 B]
  uint8_t* vs = ks + kStages * kKVBytes;
  float* ls = reinterpret_cast<float*>(vs + kStages * kKVBytes);  // [kQB]
  float* dls = ls + kQB;                                          // [kQB]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(dls + kQB);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  // the q blocks with the most kv tiles to walk start first
  const int BH = a.B * a.H;
  const int n_qb = (a.S + kQB - 1) / kQB;
  const int qb = n_qb - 1 - (int)(blockIdx.x / BH);
  const int bh = (int)(blockIdx.x % BH);
  const int bi = bh / a.H, hi = bh % a.H, kvi = hi / a.G;
  const int q0 = qb * kQB;
  const int off = a.T - a.S;
  const int kv_end = a.causal ? min(a.T, q0 + kQB + off) : a.T;
  const int n_kb = (kv_end + kKB - 1) / kKB;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const long long row0 = (long long)bh * a.S_pad + q0;  // the block's first scratch row
  if (tid >= kConsumers) {
    // producer warp: q, do, lse and delta once, then k and v of every kv tile
    const int lane = tid - kConsumers;
    if (a.use_tma) {
      if (lane == 0) {
        mbar_expect_tx(q_full, 2 * kQBytes + 2 * kQB * 4);
#pragma unroll
        for (int slab = 0; slab < NS; ++slab) {
          tma_load_4d(qs + slab * kQB * kSlabBytes, &tq, q_full, slab * 64, q0, hi, bi);
          tma_load_4d(dos + slab * kQB * kSlabBytes, &tdo, q_full, slab * 64, q0, hi, bi);
        }
        bulk_load(ls, a.lse2 + row0, kQB * 4, q_full);
        bulk_load(dls, a.delta + row0, kQB * 4, q_full);
        for (int kb = 0; kb < n_kb; ++kb) {
          const int st = kb % kStages;
          if (kb >= kStages) mbar_wait(&empty[st], (kb / kStages - 1) & 1);
          mbar_expect_tx(&full[st], 2 * kKVBytes);
#pragma unroll
          for (int slab = 0; slab < NS; ++slab) {
            tma_load_4d(ks + st * kKVBytes + slab * kKB * kSlabBytes, &tk, &full[st], slab * 64,
                        kb * kKB, kvi, bi);
            tma_load_4d(vs + st * kKVBytes + slab * kKB * kSlabBytes, &tv, &full[st], slab * 64,
                        kb * kKB, kvi, bi);
          }
        }
      }
    } else {
      stage_rows<NS>(qs, a.q + bi * a.sq.b + hi * a.sq.h, a.sq.s, q0, kQB, a.S, a.D, lane);
      stage_rows<NS>(dos, a.dout + bi * a.sdo.b + hi * a.sdo.h, a.sdo.s, q0, kQB, a.S, a.D, lane);
      for (int e = lane; e < kQB; e += 32) {
        ls[e] = a.lse2[row0 + e];
        dls[e] = a.delta[row0 + e];
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(q_full);
      for (int kb = 0; kb < n_kb; ++kb) {
        const int st = kb % kStages;
        if (kb >= kStages) mbar_wait(&empty[st], (kb / kStages - 1) & 1);
        stage_rows<NS>(ks + st * kKVBytes, a.k + bi * a.sk.b + kvi * a.sk.h, a.sk.s, kb * kKB, kKB,
                       a.T, a.D, lane);
        stage_rows<NS>(vs + st * kKVBytes, a.v + bi * a.sv.b + kvi * a.sv.h, a.sv.s, kb * kKB, kKB,
                       a.T, a.D, lane);
        if (lane == 0) mbar_arrive(&full[st]);
      }
    }
  } else {
    // consumer warpgroup wg: query rows q0 + 64 wg .. + 63; this thread
    // holds rows r0 and r0 + 8 of the accumulator fragments
    const int wg = tid / 128, t = tid % 128, warp = t / 32, lane = t % 32;
    const int quad_col = 2 * (lane % 4);
    const int rl = wg * 64 + warp * 16 + lane / 4;  // local row
    const int r0 = q0 + rl;
    const int wg_first = q0 + wg * 64;
    const int wg_end = a.causal ? min(a.T, wg_first + 64 + off) : a.T;
    const int n_kb_wg = (wg_end + kKB - 1) / kKB;
    const uint8_t* qw = qs + wg * 64 * kSlabBytes;
    const uint8_t* dow = dos + wg * 64 * kSlabBytes;

    float dq[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;

    mbar_wait(q_full, 0);
    const float l2[2] = {ls[rl], ls[rl + 8]}, dl[2] = {dls[rl], dls[rl + 8]};
    for (int kb = 0; kb < n_kb; ++kb) {
      const int st = kb % kStages;
      mbar_wait(&full[st], (kb / kStages) & 1);
      if (kb >= n_kb_wg) {  // wholly above this warpgroup's rows
        mbar_arrive(&empty[st]);
        continue;
      }
      const uint8_t* kt = ks + st * kKVBytes;
      const uint8_t* vt = vs + st * kKVBytes;

      // S = q k^T and dP = do v^T, (64 rows, 64 keys) f32
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      pin(s);
      pin(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const int slab = kk / 4, koff = (kk % 4) * 32;
        wgmma_ss_n64(s, desc_sw128(qw + slab * kQB * kSlabBytes + koff, 16, 1024),
                     desc_sw128(kt + slab * kKB * kSlabBytes + koff, 16, 1024), 1);
        wgmma_ss_n64(dp, desc_sw128(dow + slab * kQB * kSlabBytes + koff, 16, 1024),
                     desc_sw128(vt + slab * kKB * kSlabBytes + koff, 16, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(s);
      pin(dp);

      // dS on the fragment: s[4j + 2h + e] is row r0 + 8h, key k0 + 8j +
      // quad_col + e
      const int k0 = kb * kKB;
      const bool need_mask = k0 + kKB > a.T || (a.causal && k0 + kKB - 1 > wg_first + off);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e, key = k0 + 8 * j + quad_col + e;
            float x = s[i] * a.scale_log2 - l2[h];
            if (need_mask && (key >= a.T || (a.causal && key > r0 + 8 * h + off))) x = -INFINITY;
            s[i] = exp2f(x) * (dp[i] - dl[h]);
          }
        }
      }
      uint32_t dh[4][4], dlo[4][4];
      split_frags(s, dh, dlo);
      pin(dq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // keys 16kk .. 16kk + 15 of the k tile, read MN-major
        const uint64_t dkt = desc_sw128(kt + kk * 16 * kSlabBytes, kKB * kSlabBytes, 1024);
        wgmma_rs<DP>(dq, dh[kk], dkt);
        wgmma_rs<DP>(dq, dlo[kk], dkt);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(dq);
      mbar_arrive(&empty[st]);
    }

    store_rows<DP>(a.dq + bi * a.sdq.b + hi * a.sdq.h, a.sdq.s, dq, r0, a.S, a.D, lane, a.scale,
                   a.pair_store);
  }
}

// sets the kernel's dynamic shared memory once per device (a host call of its own)
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem, bool (&done)[64]) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || (device < 64 && done[device])) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && device < 64) done[device] = true;
  return err;
}

template <int DP>
int launch(const Args& a, cudaStream_t st) {
  constexpr int NS = (DP + 63) / 64;
  const size_t barriers = (1 + 2 * kStages) * 8;
  const size_t smem_kv = 1024 + (size_t)NS * kSlabBytes * (2 * kBKV + 2 * kStages * kBQ) +
                         2 * kStages * kBQ * 4 + barriers;
  const size_t smem_q = 1024 + (size_t)NS * kSlabBytes * (2 * kQB + 2 * kStages * kKB) +
                        2 * kQB * 4 + barriers;
  auto k1 = dkdv_wgmma_kernel<DP>;
  auto k2 = dq_wgmma_kernel<DP>;
  static bool set1[64] = {}, set2[64] = {};
  cudaError_t err = allow_smem(k1, smem_kv, set1);
  if (err == cudaSuccess) err = allow_smem(k2, smem_q, set2);
  if (err != cudaSuccess) return (int)err;
  // maps of q and do by 64 rows (dK/dV) and 128 rows (dQ), of k and v by
  // 128 keys (dK/dV) and 64 keys (dQ)
  CUtensorMap m[8];
  memset(m, 0, sizeof(m));
  if (a.use_tma) {
    const int rows[8] = {kBQ, kBQ, kBKV, kBKV, kQB, kQB, kKB, kKB};
    for (int i = 0; i < 8; ++i) {
      const int op = i % 4;  // q, do, k, v
      const void* base = op == 0 ? (const void*)a.q : op == 1 ? (const void*)a.dout
                         : op == 2 ? (const void*)a.k : (const void*)a.v;
      const Strides s = op == 0 ? a.sq : op == 1 ? a.sdo : op == 2 ? a.sk : a.sv;
      const int seq = op < 2 ? a.S : a.T, heads = op < 2 ? a.H : a.KVH;
      const int rc = encode(&m[i], base, s, a.D, seq, heads, a.B, rows[i]);
      if (rc != 0) return rc;
    }
  }
  const long long n_rows = (long long)a.B * a.H * a.S_pad;
  bwd_prep_kernel<<<(unsigned)((n_rows + 7) / 8), 256, 0, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n_kv = (long long)a.B * a.KVH * ((a.T + kBKV - 1) / kBKV);
  k1<<<(unsigned)n_kv, kThreads, smem_kv, st>>>(m[0], m[1], m[2], m[3], a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n_q = (long long)a.B * a.H * ((a.S + kQB - 1) / kQB);
  k2<<<(unsigned)n_q, kThreads, smem_q, st>>>(m[4], m[5], m[6], m[7], a);
  return (int)cudaGetLastError();
}

}  // namespace

// dq (B, H, S, D), dk and dv (B, KVH, T, D) bf16 of attention's backward
// pass for bf16 q, the forward's output o and the output's gradient dout
// (B, H, S, D), k, v (B, KVH, T, D), H a multiple of KVH, D <= 128, and the
// forward's row log-sum-exp lse (B, H, S) f32 contiguous. Tensors are
// addressed through ``strides``: 24 element strides, the batch, head and
// sequence strides of q, k, v, o, dout, dq, dk, dv in that order (every
// last axis unit-stride). ``scratch``: 2 B H S_pad floats, S_pad = S rounded
// up to 128, 16-byte aligned. use_tma = 1 loads q, dout, k and v through
// tensor maps (every base address 16-byte aligned, every stride of an axis
// longer than 1 a multiple of 8 elements); 0 stages with ordinary loads.
// Three kernels are launched on ``stream``: the rows' delta, dK/dV, dQ.
// Returns a CUDA error code: cudaGetLastError() after each launch, or the
// failure to encode a tensor map.
extern "C" int flash_attention_bwd_wgmma_launch(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, void* dq, void* dk, void* dv, float* scratch, const long long* strides,
    int B, int H, int KVH, int S, int T_len, int D, int causal, float scale, int use_tma,
    void* stream) {
  if (B < 1 || KVH < 1 || H < KVH || H % KVH || S < 1 || T_len < 1 || D < 1 || D > 128 ||
      (causal && T_len < S) || (long long)B * H * ((S + kQB - 1) / kQB) > 0x7fffffffLL ||
      (long long)B * KVH * ((T_len + kBKV - 1) / kBKV) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.o = static_cast<const __nv_bfloat16*>(o);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.lse = lse;
  a.S_pad = (S + kRowPad - 1) / kRowPad * kRowPad;
  a.lse2 = scratch;
  a.delta = scratch + (long long)B * H * a.S_pad;
  Strides* all[8] = {&a.sq, &a.sk, &a.sv, &a.so, &a.sdo, &a.sdq, &a.sdk, &a.sdv};
  for (int i = 0; i < 8; ++i)
    *all[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  // bf16 pairs stored as one 4-byte word where every gradient allows it
  const void* grads[3] = {dq, dk, dv};
  a.pair_store = 1;
  for (int i = 0; i < 3; ++i)
    a.pair_store &= all[5 + i]->b % 2 == 0 && all[5 + i]->h % 2 == 0 && all[5 + i]->s % 2 == 0 &&
                    reinterpret_cast<uintptr_t>(grads[i]) % 4 == 0;
  a.B = B;
  a.H = H;
  a.KVH = KVH;
  a.G = H / KVH;
  a.S = S;
  a.T = T_len;
  a.D = D;
  a.causal = causal;
  a.use_tma = use_tma;
  a.scale = scale;
  a.scale_log2 = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16) {
#define FA_CASE(N) \
  case N:          \
    return launch<16 * N>(a, st);
    FA_CASE(1) FA_CASE(2) FA_CASE(3) FA_CASE(4) FA_CASE(5) FA_CASE(6) FA_CASE(7) FA_CASE(8)
#undef FA_CASE
  }
  return (int)cudaErrorInvalidValue;
}
