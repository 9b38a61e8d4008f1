// Causal GQA attention on Hopper's tensor cores, for bf16 operands, sm_90a.
//
// Replaces: src/repro/kernels/flash_attention.py :: flash_attention_pallas
// (_flash_kernel) on bf16 operands: the TPU kernel that walks the kv blocks
// of one (batch*head, q-block) in grid order with the running max m, the sum
// l and the (BQ, D) accumulator resident in VMEM, the kv head indexed as
// h // G. f32 operands keep the CUDA-core kernel of flash_attention.cu.
//
// The function is the model's gqa_attention (src/repro/models/attention.py,
// _chunk_attn): logits in f32 from the bf16 q and k, the softmax in f32
// masked with NEG_INF and the causal diagonal at the kv end, p @ v with p in
// f32, the output rounded to bf16. q k^T is a bf16 x bf16 -> f32 wgmma: a
// product of two bf16 values is exact in f32, so only the order of the f32
// sums differs. p is not rounded to bf16 once (as the TPU kernel and SDPA
// do): it is split as p = p_hi + p_lo, both bf16, p_lo = bf16(p - p_hi), and
// p @ v is two register-A wgmmas into one f32 accumulator, which carries p
// to about 2^-16 relative, far below the output's bf16 rounding.
//
// What bounds it on this card: operations. At the Zamba2-2.7B serving shape
// (B 4, H = KVH 32, S = T 4,096, D 80, causal) one call needs 3.44e11
// operations (0.347 ms at the 989 TFLOP/s bf16 rate) on 336 MB of q, k, v
// and out (0.100 ms); the hi/lo split makes the tensor-core work 1.5x that
// (0.52 ms).
//
// Design. One CTA per (b*H, 128-row q block), the q blocks with the most kv
// blocks first: two consumer warpgroups of 64 query rows each and one
// producer warp. The producer loads q once and then 128-key tiles of k and v
// into a ring of kStages stages guarded by mbarriers (full: data landed;
// empty: both consumers are done with it); 128-key blocks take half the
// barrier and wgmma round trips per key of 64-key ones. Tiles are stored as 64-column
// (128-byte) slabs with the 128-byte swizzle, so D <= 64 takes one slab and
// D <= 128 two; columns past D are zeros. Loads are TMA tensor copies
// through 4-D tensor maps (D, seq, heads, batch) built on the host from the
// operands' own strides, so the model's (b, s, heads, hd) views need no
// copy and rows past S or T arrive as zeros. Where an operand breaks TMA's
// 16-byte rules (a head dim of 28 gives a 56-byte head stride) the producer
// warp stages the same swizzled layout with ordinary loads: the same math
// behind a branch on the strides. Each consumer warpgroup runs q k^T as
// m64n128k16 wgmmas from shared memory (D/16 K-steps), the online softmax in
// base 2 on the accumulator fragment in registers (a row's max and sum are
// reduced over the four threads that hold its columns), then p @ v as
// m64nDk16 wgmmas with p_hi and p_lo as register A operands and the v tile
// read MN-major from shared memory. Only blocks on the causal diagonal or
// the kv end are masked, blocks above the diagonal are never loaded, and a
// warpgroup skips the last block when it lies wholly above its own rows.
// The epilogue divides by l and writes bf16 in q's layout, and, when asked
// (a non-null lse, for the backward pass), each row's log-sum-exp of the
// scaled logits, ln 2 (m + log2 l) in f32, (B, H, S) contiguous.
#include "flash_common.cuh"

namespace {

constexpr int kBQ = 128;          // query rows per CTA
constexpr int kBK = 128;          // keys per kv block
constexpr int kStages = 2;        // k/v ring depth
constexpr int kConsumers = 256;   // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// DP: D rounded up to 16, the N of the p @ v wgmma
template <int DP>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __nv_bfloat16* __restrict__ q, Strides sq,
    const __nv_bfloat16* __restrict__ k, Strides sk, const __nv_bfloat16* __restrict__ v,
    Strides sv, __nv_bfloat16* __restrict__ o, Strides so, float* __restrict__ lse, int BH, int H,
    int G, int S, int T_len, int D, int causal, float scale_log2, int use_tma, int pair_store) {
  constexpr int NS = (DP + 63) / 64;  // 64-column slabs
  constexpr int KD = DP / 16;         // K-steps of q k^T
  constexpr int kQBytes = NS * kBQ * kSlabBytes;
  constexpr int kKVBytes = NS * kBK * kSlabBytes;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle atoms need 1024-byte aligned tiles
  uint8_t* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ks = qs + kQBytes;             // [kStages][NS][kBK][128 B]
  uint8_t* vs = ks + kStages * kKVBytes;  // the same for v
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + kStages * kKVBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  // the q blocks with the most kv blocks to walk start first
  const int n_qb = (S + kBQ - 1) / kBQ;
  const int qb = n_qb - 1 - (int)(blockIdx.x / BH);
  const int bh = (int)(blockIdx.x % BH);
  const int bi = bh / H, hi = bh % H, kvi = hi / G;
  const int q0 = qb * kBQ;
  const int off = T_len - S;  // >= 0 when causal
  // keys [0, kv_end) are visible to some row of this block
  const int kv_end = causal ? min(T_len, q0 + kBQ + off) : T_len;
  const int n_kb = (kv_end + kBK - 1) / kBK;
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

  if (tid >= kConsumers) {
    // producer warp: q once, then the k and v tiles of every kv block
    const int lane = tid - kConsumers;
    if (use_tma) {
      if (lane == 0) {
        mbar_expect_tx(q_full, kQBytes);
#pragma unroll
        for (int slab = 0; slab < NS; ++slab)
          tma_load_4d(qs + slab * kBQ * kSlabBytes, &tq, q_full, slab * 64, q0, hi, bi);
        for (int kb = 0; kb < n_kb; ++kb) {
          const int st = kb % kStages;
          if (kb >= kStages) mbar_wait(&empty[st], (kb / kStages - 1) & 1);
          mbar_expect_tx(&full[st], 2 * kKVBytes);
#pragma unroll
          for (int slab = 0; slab < NS; ++slab) {
            tma_load_4d(ks + st * kKVBytes + slab * kBK * kSlabBytes, &tk, &full[st], slab * 64,
                        kb * kBK, kvi, bi);
            tma_load_4d(vs + st * kKVBytes + slab * kBK * kSlabBytes, &tv, &full[st], slab * 64,
                        kb * kBK, kvi, bi);
          }
        }
      }
    } else {
      stage_rows<NS>(qs, q + bi * sq.b + hi * sq.h, sq.s, q0, kBQ, S, D, lane);
      if (lane == 0) mbar_arrive(q_full);
      for (int kb = 0; kb < n_kb; ++kb) {
        const int st = kb % kStages;
        if (kb >= kStages) mbar_wait(&empty[st], (kb / kStages - 1) & 1);
        stage_rows<NS>(ks + st * kKVBytes, k + bi * sk.b + kvi * sk.h, sk.s, kb * kBK, kBK,
                       T_len, D, lane);
        stage_rows<NS>(vs + st * kKVBytes, v + bi * sv.b + kvi * sv.h, sv.s, kb * kBK, kBK,
                       T_len, D, lane);
        if (lane == 0) mbar_arrive(&full[st]);
      }
    }
  } else {
    // consumer warpgroup wg: query rows q0 + 64 wg .. + 63; this thread
    // holds rows r0 and r0 + 8 of the accumulator fragments
    const int wg = tid / 128, t = tid % 128, warp = t / 32, lane = t % 32;
    const int r0 = q0 + wg * 64 + warp * 16 + lane / 4;
    const int quad_col = 2 * (lane % 4);
    const int wg_first = q0 + wg * 64;  // its first query row
    const int wg_end = causal ? min(T_len, wg_first + 64 + off) : T_len;
    const int n_kb_wg = (wg_end + kBK - 1) / kBK;
    const uint8_t* qw = qs + wg * 64 * kSlabBytes;

    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this thread's columns

    mbar_wait(q_full, 0);
    for (int kb = 0; kb < n_kb; ++kb) {
      const int st = kb % kStages;
      mbar_wait(&full[st], (kb / kStages) & 1);
      if (kb >= n_kb_wg) {  // wholly above this warpgroup's rows
        mbar_arrive(&empty[st]);
        continue;
      }
      const uint8_t* kt = ks + st * kKVBytes;
      const uint8_t* vt = vs + st * kKVBytes;

      // s = q k^T, (64, 128) f32
      float s[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] = 0.f;
      pin(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const int slab = kk / 4, koff = (kk % 4) * 32;
        wgmma_ss_n128(s, desc_sw128(qw + slab * kBQ * kSlabBytes + koff, 16, 1024),
                      desc_sw128(kt + slab * kBK * kSlabBytes + koff, 16, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(s);

      // online softmax in base 2 on the fragment: s[4j + 2h + e] is row
      // r0 + 8h, key k0 + 8j + quad_col + e
      const int k0 = kb * kBK;
      const bool need_mask = k0 + kBK > T_len || (causal && k0 + kBK - 1 > wg_first + off);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int qpos = r0 + 8 * h + off;
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kpos = k0 + 8 * j + quad_col + e;
            float x = s[4 * j + 2 * h + e] * scale_log2;
            if (need_mask && (kpos >= T_len || (causal && kpos > qpos))) x = kNegInf;
            s[4 * j + 2 * h + e] = x;
            mx = fmaxf(mx, x);
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[h], mx);
        const float alpha = exp2f(m[h] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2f(s[4 * j + 2 * h + e] - m_new);
            s[4 * j + 2 * h + e] = p;
            sum += p;
          }
        }
        l[h] = l[h] * alpha + sum;
        m[h] = m_new;
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          acc[4 * j + 2 * h] *= alpha;
          acc[4 * j + 2 * h + 1] *= alpha;
        }
      }

      // p = p_hi + p_lo as register A fragments: for K-step kk (keys
      // 16kk .. 16kk + 15) register g holds s[8kk + 2g], s[8kk + 2g + 1]
      uint32_t ph[8][4], pl[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float x0 = s[8 * kk + 2 * g], x1 = s[8 * kk + 2 * g + 1];
          const __nv_bfloat162 hi2 = __floats2bfloat162_rn(x0, x1);
          const float2 hf = __bfloat1622float2(hi2);
          const __nv_bfloat162 lo2 = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
          ph[kk][g] = *reinterpret_cast<const uint32_t*>(&hi2);
          pl[kk][g] = *reinterpret_cast<const uint32_t*>(&lo2);
        }
      }
      pin(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        // keys 16kk .. 16kk + 15 of the v tile: two 8-row groups 1024 bytes
        // apart (SBO), the second 64-column slab kBK rows on (LBO)
        const uint64_t dv = desc_sw128(vt + kk * 16 * kSlabBytes, kBK * kSlabBytes, 1024);
        wgmma_rs<DP>(acc, ph[kk], dv);
        wgmma_rs<DP>(acc, pl[kk], dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(acc);
      mbar_arrive(&empty[st]);
    }

    // epilogue: out = acc / l in bf16, q's layout
    __nv_bfloat16* og = o + bi * so.b + hi * so.h;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lt = l[h] + __shfl_xor_sync(0xffffffffu, l[h], 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const float lr = lt == 0.f ? 1.f : lt;
      const int row = r0 + 8 * h;
      if (row >= S) continue;
      if (lse != nullptr && lane % 4 == 0)
        lse[(long long)bh * S + row] = (m[h] + log2f(lr)) * kLn2;
      __nv_bfloat16* orow = og + (long long)row * so.s;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + quad_col;
        const float v0 = acc[4 * j + 2 * h] / lr, v1 = acc[4 * j + 2 * h + 1] / lr;
        if (pair_store && col + 1 < D) {
          *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (col < D) orow[col] = __float2bfloat16(v0);
          if (col + 1 < D) orow[col + 1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

template <int DP>
int launch(const void* q, Strides sq, const void* k, Strides sk, const void* v, Strides sv,
           void* o, Strides so, float* lse, int B, int H, int KVH, int S, int T_len, int D,
           int causal, float scale, int use_tma, cudaStream_t st) {
  constexpr int NS = (DP + 63) / 64;
  const size_t smem =
      1024 + (size_t)NS * kSlabBytes * (kBQ + 2 * kStages * kBK) + (1 + 2 * kStages) * 8;
  auto kernel = flash_attention_wgmma_kernel<DP>;
  static bool attr_set[64] = {};  // per device, once: it is a host call of its own
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= 64 || !attr_set[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (device < 64) attr_set[device] = true;
  }
  CUtensorMap tq, tk, tv;
  memset(&tq, 0, sizeof(tq));
  memset(&tk, 0, sizeof(tk));
  memset(&tv, 0, sizeof(tv));
  if (use_tma) {
    int rc = encode(&tq, q, sq, D, S, H, B, kBQ);
    if (rc == 0) rc = encode(&tk, k, sk, D, T_len, KVH, B, kBK);
    if (rc == 0) rc = encode(&tv, v, sv, D, T_len, KVH, B, kBK);
    if (rc != 0) return rc;
  }
  const int pair_store =
      reinterpret_cast<uintptr_t>(o) % 4 == 0 && so.b % 2 == 0 && so.h % 2 == 0 && so.s % 2 == 0;
  const long long BH = (long long)B * H;
  const long long n_ctas = BH * ((S + kBQ - 1) / kBQ);
  kernel<<<(unsigned)n_ctas, kThreads, smem, st>>>(
      tq, tk, tv, static_cast<const __nv_bfloat16*>(q), sq, static_cast<const __nv_bfloat16*>(k),
      sk, static_cast<const __nv_bfloat16*>(v), sv, static_cast<__nv_bfloat16*>(o), so, lse,
      (int)BH, H, H / KVH, S, T_len, D, causal, scale * kLog2e, use_tma, pair_store);
  return (int)cudaGetLastError();
}

}  // namespace

// o (B, H, S, D) bf16 = softmax(q k^T * scale, causal diagonal at the kv end)
// v for bf16 q (B, H, S, D) and k, v (B, KVH, T, D), H a multiple of KVH,
// D <= 128; every tensor is addressed through its batch, head and sequence
// element strides and a unit-stride last axis. use_tma = 1 loads through
// tensor maps (every base address 16-byte aligned, every stride of an axis
// longer than 1 a multiple of 8 elements); 0 stages with ordinary loads.
// lse, when not null, takes each row's log-sum-exp (B, H, S) f32.
// Returns a CUDA error code: cudaGetLastError() after the launch, or the
// failure to encode a tensor map.
extern "C" int flash_attention_wgmma_launch(
    const void* q, long long sqb, long long sqh, long long sqs, const void* k, long long skb,
    long long skh, long long sks, const void* v, long long svb, long long svh, long long svs,
    void* o, long long sob, long long soh, long long sos, int B, int H, int KVH, int S, int T_len,
    int D, int causal, float scale, int use_tma, float* lse, void* stream) {
  if (B < 1 || KVH < 1 || H < KVH || H % KVH || S < 1 || T_len < 1 || D < 1 || D > 128 ||
      (causal && T_len < S) || (long long)B * H * ((S + kBQ - 1) / kBQ) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Strides sq{sqb, sqh, sqs}, sk{skb, skh, sks}, sv{svb, svh, svs}, so{sob, soh, sos};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16) {
#define FA_CASE(N)                                                                           \
  case N:                                                                                    \
    return launch<16 * N>(q, sq, k, sk, v, sv, o, so, lse, B, H, KVH, S, T_len, D, causal, \
                          scale, use_tma, st);
    FA_CASE(1) FA_CASE(2) FA_CASE(3) FA_CASE(4) FA_CASE(5) FA_CASE(6) FA_CASE(7) FA_CASE(8)
#undef FA_CASE
  }
  return (int)cudaErrorInvalidValue;
}
