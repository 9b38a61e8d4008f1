// Blockwise causal GQA attention with an online softmax, for sm_90a.
//
// Replaces: src/repro/kernels/flash_attention.py :: flash_attention_pallas
// (_flash_kernel), the TPU kernel that walks the kv blocks of one
// (batch*head, q-block) in grid order, keeps the running max m, the sum l
// and the (BQ, D) accumulator resident in VMEM scratch, and indexes the kv
// head as h // G for GQA.
//
// What bounds it on this card: operations. On the serving path of
// Zamba2-2.7B (B 4, H = KVH 32, S = T 4,096, D 80, bf16, causal) one call
// does ~3.4e11 f32 operations on 336 MB of q, k, v and out: ~5 ms on the
// f32 CUDA cores against 0.1 ms of memory traffic. This kernel does all its
// arithmetic in f32 on the CUDA cores (no tensor cores yet).
//
// Design. One CTA of 256 threads per (b*H, 64-row q block); the kv blocks
// of 64 keys are walked in order inside the CTA, and the blocks wholly above
// the causal diagonal are skipped (their softmax weights are exactly 0). The
// q tile and each k tile sit transposed in shared memory as f32, so a
// thread reads four consecutive rows of q and four consecutive keys with two
// 16-byte loads and does 16 FMAs; thread (ty, tx) owns score rows 4ty..4ty+3
// and keys 4tx..4tx+3, and the 16 threads of one row group reduce the row
// max and sum with warp shuffles. m and l stay in registers, replicated over
// the row group; the p tile goes through shared memory to the p @ v
// product, where each thread owns the same four rows and the output columns
// tx + 16c. Operands are read in their storage dtype (f32 or bf16) and
// widened on load; the softmax runs in base 2 with log2(e) folded into the
// scale. Unlike the TPU kernel, which rounds p to bf16 before p @ v on bf16
// operands, p stays f32: the model's own attention (gqa_attention) widens
// q, k and v to f32 and computes p @ v in f32, and this kernel serves that
// call. The output is written in q's dtype. When asked (a non-null lse,
// for the backward pass), the CTA also writes each row's log-sum-exp of
// the scaled logits, ln 2 (m + log2 l) in f32, (B, H, S) contiguous.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // keys per kv block
constexpr int kThreads = 256;  // 16 row groups x 16 key groups
constexpr int kLd = 68;        // row stride of the transposed tiles: 16-byte aligned
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct Strides {
  long long b, h, s;  // element strides of the batch, head and sequence axes
};

size_t smem_bytes(int d) {
  return sizeof(float) * ((size_t)2 * d * kLd + (size_t)kBK * d + (size_t)kBK * kLd);
}

// DC: 16-column groups of the accumulator, D <= 16 * DC
template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, Strides sq, const T* __restrict__ k,
                           Strides sk, const T* __restrict__ v, Strides sv, T* __restrict__ o,
                           Strides so, float* __restrict__ lse, int BH, int H, int G, int S,
                           int T_len, int D, int causal, float scale_log2) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;            // [D][kLd]: q tile, transposed
  float* ks = qs + D * kLd;    // [D][kLd]: k tile, transposed
  float* vs = ks + D * kLd;    // [kBK][D]
  float* ps = vs + kBK * D;    // [kBK][kLd]: p tile, transposed

  // the q blocks with the most kv blocks to walk start first
  const int n_qb = (S + kBQ - 1) / kBQ;
  const int qb = n_qb - 1 - (int)(blockIdx.x / BH);
  const int bh = (int)(blockIdx.x % BH);
  const int bi = bh / H, hi = bh % H, kvi = hi / G;
  const int q0 = qb * kBQ;
  const T* qg = q + bi * sq.b + hi * sq.h;
  const T* kg = k + bi * sk.b + kvi * sk.h;
  const T* vg = v + bi * sv.b + kvi * sv.h;
  T* og = o + bi * so.b + hi * so.h;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int i = e / D, d = e % D;
    qs[d * kLd + i] = q0 + i < S ? to_f32(qg[(q0 + i) * sq.s + d]) : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }
  const int off = T_len - S;  // >= 0 when causal
  // keys [0, kv_end) are visible to some row of this block
  const int kv_end = causal ? min(T_len, q0 + kBQ + off) : T_len;
  const int n_kb = (kv_end + kBK - 1) / kBK;

  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();  // the last block's reads of ks, vs and ps are done
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int j = e / D, d = e % D;
      const bool in = k0 + j < T_len;
      ks[d * kLd + j] = in ? to_f32(kg[(k0 + j) * sk.s + d]) : 0.f;
      vs[j * D + d] = in ? to_f32(vg[(k0 + j) * sv.s + d]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[r][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&qs[d * kLd + ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ks[d * kLd + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[r][c] = fmaf(av[r], bv[c], sc[r][c]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = q0 + ty * 4 + r + off;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + tx * 4 + c;
        const bool ok = kpos < T_len && (!causal || qpos >= kpos);
        sc[r][c] = ok ? sc[r][c] * scale_log2 : kNegInf;
        mx = fmaxf(mx, sc[r][c]);
      }
#pragma unroll
      for (int w = 8; w >= 1; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = exp2f(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sc[r][c] = exp2f(sc[r][c] - m_new);
        sum += sc[r][c];
      }
#pragma unroll
      for (int w = 8; w >= 1; w >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] *= alpha;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(&ps[(tx * 4 + c) * kLd + ty * 4]) =
          make_float4(sc[0][c], sc[1][c], sc[2][c], sc[3][c]);
    __syncthreads();

    const int nj = min(kBK, T_len - k0);
    for (int j = 0; j < nj; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(&ps[j * kLd + ty * 4]);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int dc = tx + 16 * c;
        const float vv = dc < D ? vs[j * D + dc] : 0.f;
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(pv[r], vv, acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty * 4 + r;
    if (row >= S) continue;
    const float lr = l[r] == 0.f ? 1.f : l[r];
    if (lse != nullptr && tx == 0) lse[(long long)bh * S + row] = (m[r] + log2f(lr)) * kLn2;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int dc = tx + 16 * c;
      if (dc < D) store(&og[row * so.s + dc], acc[r][c] / lr);
    }
  }
}

template <typename T, int DC>
int launch(const void* q, Strides sq, const void* k, Strides sk, const void* v, Strides sv, void* o,
           Strides so, float* lse, int B, int H, int KVH, int S, int T_len, int D, int causal,
           float scale, cudaStream_t st) {
  auto kernel = flash_attention_kernel<T, DC>;
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long BH = (long long)B * H;
  const long long n_ctas = BH * ((S + kBQ - 1) / kBQ);
  kernel<<<(unsigned)n_ctas, kThreads, smem, st>>>(
      static_cast<const T*>(q), sq, static_cast<const T*>(k), sk, static_cast<const T*>(v), sv,
      static_cast<T*>(o), so, lse, (int)BH, H, H / KVH, S, T_len, D, causal, scale * kLog2e);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int dc, const void* q, Strides sq, const void* k, Strides sk, const void* v,
             Strides sv, void* o, Strides so, float* lse, int B, int H, int KVH, int S, int T_len,
             int D, int causal, float scale, cudaStream_t st) {
  switch (dc) {
#define FA_CASE(N) \
  case N:          \
    return launch<T, N>(q, sq, k, sk, v, sv, o, so, lse, B, H, KVH, S, T_len, D, causal, scale, \
                        st);
    FA_CASE(1) FA_CASE(2) FA_CASE(3) FA_CASE(4) FA_CASE(5) FA_CASE(6) FA_CASE(7) FA_CASE(8)
#undef FA_CASE
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// o (B, H, S, D) = softmax(q k^T * scale, causal diagonal at the kv end) v
// for q (B, H, S, D) and k, v (B, KVH, T, D), H a multiple of KVH; every
// tensor is addressed through its batch, head and sequence element strides
// and a unit-stride last axis. f32 (bf16 = 0) or bf16 (bf16 = 1) operands,
// the output in the same dtype; lse, when not null, takes each row's
// log-sum-exp (B, H, S) f32. Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_launch(const void* q, long long sqb, long long sqh, long long sqs,
                                      const void* k, long long skb, long long skh, long long sks,
                                      const void* v, long long svb, long long svh, long long svs,
                                      void* o, long long sob, long long soh, long long sos, int B,
                                      int H, int KVH, int S, int T_len, int D, int causal,
                                      float scale, int bf16, float* lse, void* stream) {
  if (B < 1 || KVH < 1 || H < KVH || H % KVH || S < 1 || T_len < 1 || D < 1 || D > 128 ||
      (causal && T_len < S) || (long long)B * H * ((S + kBQ - 1) / kBQ) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Strides sq{sqb, sqh, sqs}, sk{skb, skh, sks}, sv{svb, svh, svs}, so{sob, soh, sos};
  const int dc = (D + 15) / 16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(dc, q, sq, k, sk, v, sv, o, so, lse, B, H, KVH, S, T_len, D,
                                   causal, scale, st);
  return dispatch<float>(dc, q, sq, k, sk, v, sv, o, so, lse, B, H, KVH, S, T_len, D, causal,
                         scale, st);
}
