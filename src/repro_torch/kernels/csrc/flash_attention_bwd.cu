// The backward pass of causal GQA attention, for sm_90a.
//
// Replaces: src/repro/kernels/flash_attention.py :: flash_attention_pallas
// (_flash_kernel), its VJP on the train path. The reference differentiates
// its plain-jnp attention; the port's forward is the kernel of
// flash_attention.cu / flash_attention_wgmma.cu, so its gradient passes
// through this one.
//
// The function, for q (B, H, S, D), k and v (B, KVH, T, D), H = KVH G, the
// forward's output o and row log-sum-exp lse (B, H, S) of the scaled
// logits, and the output's gradient do:
//   P  = exp(scale q k^T - lse)        0 above the causal diagonal (aligned
//                                      to the end of the kv axis) and past T
//   dV = sum over the G heads of P^T do
//   dP = do v^T,  delta = rowsum(do o),  dS = P (dP - delta)
//   dQ = scale dS k,  dK = scale sum over the G heads of dS^T q
// all in f32 on the CUDA cores, the gradients written in the operands'
// dtype (f32 or bf16).
//
// What bounds it on this card: operations. Five (rows x keys x D) products
// over the causal half: at Zamba2-2.7B's training shape (B 2, H = KVH 32,
// S = T 4,096, D 80) 4.3e11 operations, 0.44 ms at the bf16 tensor-core
// rate and 6.4 ms at the f32 CUDA-core rate, against 0.1 ms of memory.
//
// Design: FlashAttention-2's two passes, each output summed by one CTA in a
// fixed order, with no atomics, so that two calls give the same bits.
//  - dkdv_kernel: one CTA per (b, kv head, 64-key tile) holds the k and v
//    tiles and walks, for each of the G query heads in turn, the 64-row q
//    tiles that see a key of the tile; dK and dV of its 64 keys stay in
//    registers (thread (ty, tx) owns keys 4ty..4ty+3, columns tx + 16c).
//  - dq_kernel: one CTA per (b, head, 64-row q tile) walks the kv tiles up
//    to the causal end; dQ stays in registers.
// Both recompute P from q, k and the saved lse, and both form delta from do
// and o for the rows they load (four threads a row, a fixed shuffle tree).
// Tiles sit in shared memory as f32, transposed ([D][68]) so that a thread
// reads four rows or keys with one 16-byte load; the P and dS tiles pass
// through shared memory between the score products and the accumulations.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16: thread (ty, tx)
constexpr int kLd = 68;        // row stride of the tiles in shared memory
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct Strides {
  long long b, h, s;  // element strides of the batch, head and sequence axes
};

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  void *dq, *dk, *dv;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int B, H, KVH, G, S, T, D, causal;
  float scale, scale_log2;
};

// rows [r0, r0 + 64) of one (b, head) of x, transposed into dst[D][kLd] as
// f32, zeros past n_rows
template <typename T>
__device__ void load_t(float* dst, const T* x, long long row_stride, int r0, int n_rows, int D) {
  for (int e = threadIdx.x; e < 64 * D; e += kThreads) {
    const int i = e / D, d = e % D;
    dst[d * kLd + i] = r0 + i < n_rows ? to_f32(x[(long long)(r0 + i) * row_stride + d]) : 0.f;
  }
}

// lse (in base 2) and delta = rowsum(do o) of query rows [q0, q0 + 64) of
// one (b, head): four threads a row, their partial sums joined by a fixed
// shuffle tree
template <typename T>
__device__ void load_rows(float* lse_s, float* delta_s, const float* lse, const T* o, Strides so,
                          const T* dout, Strides sdo, int q0, int S, int D) {
  const int row = threadIdx.x / 4, part = threadIdx.x % 4;
  float acc = 0.f;
  if (q0 + row < S) {
    const T* orow = o + (long long)(q0 + row) * so.s;
    const T* drow = dout + (long long)(q0 + row) * sdo.s;
    for (int d = part; d < D; d += 4) acc = fmaf(to_f32(drow[d]), to_f32(orow[d]), acc);
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  if (part == 0) {
    delta_s[row] = acc;
    lse_s[row] = q0 + row < S ? lse[q0 + row] * kLog2e : 0.f;
  }
}

// the (4 x 4) block of scores a x b^T and dP = c x d^T of thread (ty, tx):
// rows 4ty + r of the a and c tiles, rows 4tx + c of the b and d tiles,
// each tile [D][kLd]
__device__ __forceinline__ void score_blocks(const float* at, const float* bt, const float* ct,
                                             const float* dt, int D, int ty, int tx,
                                             float sa[4][4], float sc[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) sa[r][c] = sc[r][c] = 0.f;
  for (int d = 0; d < D; ++d) {
    const float4 a = *reinterpret_cast<const float4*>(&at[d * kLd + ty * 4]);
    const float4 b = *reinterpret_cast<const float4*>(&bt[d * kLd + tx * 4]);
    const float4 c4 = *reinterpret_cast<const float4*>(&ct[d * kLd + ty * 4]);
    const float4 d4 = *reinterpret_cast<const float4*>(&dt[d * kLd + tx * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
    const float cv[4] = {c4.x, c4.y, c4.z, c4.w}, dv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sa[r][c] = fmaf(av[r], bv[c], sa[r][c]);
        sc[r][c] = fmaf(cv[r], dv[c], sc[r][c]);
      }
  }
}

// dK and dV of one 64-key tile of one (b, kv head)
template <typename T, int DC>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int D = a.D;
  float* kt = smem;            // [D][kLd] k tile, transposed
  float* vt = kt + D * kLd;    // [D][kLd] v tile
  float* qt = vt + D * kLd;    // [D][kLd] q tile
  float* dot = qt + D * kLd;   // [D][kLd] do tile
  float* ps = dot + D * kLd;   // [kBQ][kLd] P, [query][key]
  float* dss = ps + kBQ * kLd; // [kBQ][kLd] dS, [query][key]
  float* lse_s = dss + kBQ * kLd;
  float* delta_s = lse_s + kBQ;

  const int n_kb = (a.T + kBK - 1) / kBK;
  const int kb = (int)(blockIdx.x % n_kb);
  const int bkv = (int)(blockIdx.x / n_kb);
  const int bi = bkv / a.KVH, kvi = bkv % a.KVH;
  const int k0 = kb * kBK;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int off = a.T - a.S;  // >= 0 when causal

  const T* kg = static_cast<const T*>(a.k) + bi * a.sk.b + kvi * a.sk.h;
  const T* vg = static_cast<const T*>(a.v) + bi * a.sv.b + kvi * a.sv.h;
  load_t(kt, kg, a.sk.s, k0, a.T, D);
  load_t(vt, vg, a.sv.s, k0, a.T, D);

  float dk[4][DC], dv[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[r][c] = dv[r][c] = 0.f;

  // the first q tile with a row that sees key k0: row i sees key j iff
  // j <= i + off
  const int qb_first = a.causal ? max(0, k0 - off) / kBQ : 0;
  const int n_qb = (a.S + kBQ - 1) / kBQ;
  for (int g = 0; g < a.G; ++g) {
    const int hi = kvi * a.G + g;
    const T* qg = static_cast<const T*>(a.q) + bi * a.sq.b + hi * a.sq.h;
    const T* og = static_cast<const T*>(a.o) + bi * a.so.b + hi * a.so.h;
    const T* dog = static_cast<const T*>(a.dout) + bi * a.sdo.b + hi * a.sdo.h;
    const float* lg = a.lse + ((long long)bi * a.H + hi) * a.S;
    for (int qb = qb_first; qb < n_qb; ++qb) {
      const int q0 = qb * kBQ;
      __syncthreads();  // the last tile's reads are done
      load_t(qt, qg, a.sq.s, q0, a.S, D);
      load_t(dot, dog, a.sdo.s, q0, a.S, D);
      load_rows(lse_s, delta_s, lg, og, a.so, dog, a.sdo, q0, a.S, D);
      __syncthreads();

      // scores s[r][c] and dP^T for key 4ty + r, query row 4tx + c
      float s[4][4], dp[4][4];
      score_blocks(kt, qt, vt, dot, D, ty, tx, s, dp);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int il = tx * 4 + c, i = q0 + il;
        float pc[4], dsc[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = k0 + ty * 4 + r;
          const bool ok = i < a.S && j < a.T && (!a.causal || j <= i + off);
          const float p = ok ? exp2f(s[r][c] * a.scale_log2 - lse_s[il]) : 0.f;
          pc[r] = p;
          dsc[r] = p * (dp[r][c] - delta_s[il]);
        }
        *reinterpret_cast<float4*>(&ps[il * kLd + ty * 4]) =
            make_float4(pc[0], pc[1], pc[2], pc[3]);
        *reinterpret_cast<float4*>(&dss[il * kLd + ty * 4]) =
            make_float4(dsc[0], dsc[1], dsc[2], dsc[3]);
      }
      __syncthreads();

      // dV += P^T do, dK += dS^T q over the tile's 64 query rows, in order
      const int ni = min(kBQ, a.S - q0);
      for (int i = 0; i < ni; ++i) {
        const float4 p4 = *reinterpret_cast<const float4*>(&ps[i * kLd + ty * 4]);
        const float4 d4 = *reinterpret_cast<const float4*>(&dss[i * kLd + ty * 4]);
        const float pv[4] = {p4.x, p4.y, p4.z, p4.w}, dsv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const int d = tx + 16 * c;
          const float dov = d < D ? dot[d * kLd + i] : 0.f;
          const float qv = d < D ? qt[d * kLd + i] : 0.f;
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            dv[r][c] = fmaf(pv[r], dov, dv[r][c]);
            dk[r][c] = fmaf(dsv[r], qv, dk[r][c]);
          }
        }
      }
    }
  }

  T* dkg = static_cast<T*>(a.dk) + bi * a.sdk.b + kvi * a.sdk.h;
  T* dvg = static_cast<T*>(a.dv) + bi * a.sdv.b + kvi * a.sdv.h;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = k0 + ty * 4 + r;
    if (j >= a.T) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 16 * c;
      if (d >= D) continue;
      store(&dkg[(long long)j * a.sdk.s + d], dk[r][c] * a.scale);
      store(&dvg[(long long)j * a.sdv.s + d], dv[r][c]);
    }
  }
}

// dQ of one 64-row q tile of one (b, head)
template <typename T, int DC>
__global__ void __launch_bounds__(kThreads) dq_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int D = a.D;
  float* qt = smem;            // [D][kLd] q tile, transposed
  float* dot = qt + D * kLd;   // [D][kLd] do tile
  float* kt = dot + D * kLd;   // [D][kLd] k tile
  float* vt = kt + D * kLd;    // [D][kLd] v tile
  float* dss = vt + D * kLd;   // [kBK][kLd] dS, [key][query]
  float* lse_s = dss + kBK * kLd;
  float* delta_s = lse_s + kBQ;

  const int n_qb = (a.S + kBQ - 1) / kBQ;
  // the q tiles with the most kv tiles to walk start first
  const int BH = a.B * a.H;
  const int qb = n_qb - 1 - (int)(blockIdx.x / BH);
  const int bh = (int)(blockIdx.x % BH);
  const int bi = bh / a.H, hi = bh % a.H, kvi = hi / a.G;
  const int q0 = qb * kBQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int off = a.T - a.S;

  const T* qg = static_cast<const T*>(a.q) + bi * a.sq.b + hi * a.sq.h;
  const T* og = static_cast<const T*>(a.o) + bi * a.so.b + hi * a.so.h;
  const T* dog = static_cast<const T*>(a.dout) + bi * a.sdo.b + hi * a.sdo.h;
  const T* kg = static_cast<const T*>(a.k) + bi * a.sk.b + kvi * a.sk.h;
  const T* vg = static_cast<const T*>(a.v) + bi * a.sv.b + kvi * a.sv.h;
  load_t(qt, qg, a.sq.s, q0, a.S, D);
  load_t(dot, dog, a.sdo.s, q0, a.S, D);
  load_rows(lse_s, delta_s, a.lse + (long long)bh * a.S, og, a.so, dog, a.sdo, q0, a.S, D);

  float dq[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) dq[r][c] = 0.f;

  const int kv_end = a.causal ? min(a.T, q0 + kBQ + off) : a.T;
  const int n_kb = (kv_end + kBK - 1) / kBK;
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();
    load_t(kt, kg, a.sk.s, k0, a.T, D);
    load_t(vt, vg, a.sv.s, k0, a.T, D);
    __syncthreads();

    // scores and dP for query row 4ty + r, key 4tx + c
    float s[4][4], dp[4][4];
    score_blocks(qt, kt, dot, vt, D, ty, tx, s, dp);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = k0 + tx * 4 + c;
      float dsc[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int il = ty * 4 + r, i = q0 + il;
        const bool ok = i < a.S && j < a.T && (!a.causal || j <= i + off);
        const float p = ok ? exp2f(s[r][c] * a.scale_log2 - lse_s[il]) : 0.f;
        dsc[r] = p * (dp[r][c] - delta_s[il]);
      }
      *reinterpret_cast<float4*>(&dss[(tx * 4 + c) * kLd + ty * 4]) =
          make_float4(dsc[0], dsc[1], dsc[2], dsc[3]);
    }
    __syncthreads();

    // dQ += dS k over the tile's keys, in order
    const int nj = min(kBK, a.T - k0);
    for (int j = 0; j < nj; ++j) {
      const float4 d4 = *reinterpret_cast<const float4*>(&dss[j * kLd + ty * 4]);
      const float dsv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = tx + 16 * c;
        const float kv = d < D ? kt[d * kLd + j] : 0.f;
#pragma unroll
        for (int r = 0; r < 4; ++r) dq[r][c] = fmaf(dsv[r], kv, dq[r][c]);
      }
    }
  }

  T* dqg = static_cast<T*>(a.dq) + bi * a.sdq.b + hi * a.sdq.h;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty * 4 + r;
    if (i >= a.S) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) store(&dqg[(long long)i * a.sdq.s + d], dq[r][c] * a.scale);
    }
  }
}

template <typename T, int DC>
int launch(const Args& a, cudaStream_t st) {
  const size_t tile = (size_t)a.D * kLd;
  const size_t smem_kv = sizeof(float) * (4 * tile + 2 * (size_t)kBQ * kLd + 2 * kBQ);
  const size_t smem_q = sizeof(float) * (4 * tile + (size_t)kBK * kLd + 2 * kBQ);
  auto k1 = dkdv_kernel<T, DC>;
  auto k2 = dq_kernel<T, DC>;
  cudaError_t err = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_kv);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  const long long n_kv = (long long)a.B * a.KVH * ((a.T + kBK - 1) / kBK);
  const long long n_q = (long long)a.B * a.H * ((a.S + kBQ - 1) / kBQ);
  k1<<<(unsigned)n_kv, kThreads, smem_kv, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k2<<<(unsigned)n_q, kThreads, smem_q, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, cudaStream_t st) {
  switch ((a.D + 15) / 16) {
#define FA_CASE(N) \
  case N:          \
    return launch<T, N>(a, st);
    FA_CASE(1) FA_CASE(2) FA_CASE(3) FA_CASE(4) FA_CASE(5) FA_CASE(6) FA_CASE(7) FA_CASE(8)
#undef FA_CASE
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dq (B, H, S, D), dk and dv (B, KVH, T, D) of attention's backward pass for
// q, the forward's output o and the output's gradient dout (B, H, S, D),
// k, v (B, KVH, T, D), H a multiple of KVH, D <= 128, and the forward's row
// log-sum-exp lse (B, H, S) f32 contiguous. Tensors are addressed through
// ``strides``: 24 element strides, the batch, head and sequence strides of
// q, k, v, o, dout, dq, dk, dv in that order (every last axis unit-stride).
// f32 (bf16 = 0) or bf16 (bf16 = 1) operands and gradients. Two kernels are
// launched on ``stream``, dK/dV then dQ. Returns cudaGetLastError().
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const float* lse,
                                          void* dq, void* dk, void* dv,
                                          const long long* strides, int B, int H, int KVH,
                                          int S, int T_len, int D, int causal, float scale,
                                          int bf16, void* stream) {
  if (B < 1 || KVH < 1 || H < KVH || H % KVH || S < 1 || T_len < 1 || D < 1 || D > 128 ||
      (causal && T_len < S) || (long long)B * H * ((S + kBQ - 1) / kBQ) > 0x7fffffffLL ||
      (long long)B * KVH * ((T_len + kBK - 1) / kBK) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.lse = lse;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  Strides* all[8] = {&a.sq, &a.sk, &a.sv, &a.so, &a.sdo, &a.sdq, &a.sdk, &a.sdv};
  for (int i = 0; i < 8; ++i)
    *all[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.B = B;
  a.H = H;
  a.KVH = KVH;
  a.G = H / KVH;
  a.S = S;
  a.T = T_len;
  a.D = D;
  a.causal = causal;
  a.scale = scale;
  a.scale_log2 = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(a, st) : dispatch<float>(a, st);
}
