// The backward pass of the Mamba-2 SSD within-chunk block and chunk state,
// for sm_90a.
//
// Replaces: src/repro/kernels/ssd_scan.py :: ssd_chunk_pallas (_ssd_kernel),
// its VJP on the train path. The reference differentiates its plain-jnp
// SSD; the port's forward is the kernel of ssd_chunk.cu, so its gradient
// passes through this one.
//
// The function, per (batch*head, chunk) of length L, with D_ij =
// exp(a_i - a_j) for j <= i (taken only on and below the diagonal, as the
// forward takes it), G = C B^T, M = G o D, w_j = exp(a_{L-1} - a_j), and
// the gradients dy (L, P) of y = M x and dS (N, P) of S = (B o w)^T x:
//   dx  = M^T dy + diag(w) B dS
//   dM  = (dy x^T) masked to j <= i,   dG = dM o D
//   dC  = dG B
//   dB  = dG^T C + diag(w) x dS^T
//   da_i += sum_j dM_ij M_ij,  da_j -= sum_i dM_ij M_ij
//   dw_j = b_j . (dS x_j):  da_j -= w_j dw_j,  da_{L-1} += sum_j w_j dw_j
// in f32 on the CUDA cores. dx and da come back in f32, dB and dC in B's
// dtype (f32 or bf16).
//
// What bounds it on this card: operations. At Zamba2-2.7B's training shape
// (BH 160, C 16, L 256, N = P 64, bf16 B and C) one call does the G and
// dy x^T tiles twice (once a pass) and four accumulating products over the
// causal half, ~1.6e11 f32 operations (2.4 ms at the CUDA-core rate),
// against 0.55 GB of operands and gradients (0.16 ms).
//
// Design: one CTA of 256 threads per (bh, chunk), which alone writes every
// gradient of its chunk, each summed in a fixed order (no atomics), so that
// two calls give the same bits. The chunk is walked in 64-row tiles in two
// passes over the (row tile I, key tile J <= I) pairs:
//  - pass 1, J outer, I inner: dx_J and dB_J in registers (thread (ty, tx)
//    owns rows 4ty..4ty+3 of J and columns tx + 16c), and the column sums
//    of dM o M into da; then the state terms of J from dS.
//  - pass 2, I outer, J inner: dC_I in registers and the row sums of
//    dM o M into da.
// Each pair recomputes G and dy x^T on the tile (thread (ty, tx) owns rows
// 4ty.. of I and keys 4tx.. of J) from operands staged transposed in
// shared memory as f32 ([width][68]); M, dG and dM o M pass through shared
// memory to the accumulations. da lives in shared memory until the end.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kT = 64;         // rows per tile
constexpr int kThreads = 256;  // 16 x 16: thread (ty, tx)
constexpr int kLd = 68;        // row stride of the tiles in shared memory

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// rows [r0, r0 + 64) of a (L, W) operand, transposed into dst[W][kLd] as
// f32, zeros past L
template <typename T>
__device__ void load_t(float* dst, const T* x, int r0, int L, int W) {
  for (int e = threadIdx.x; e < kT * W; e += kThreads) {
    const int i = e / W, w = e % W;
    dst[w * kLd + i] = r0 + i < L ? to_f32(x[(long long)(r0 + i) * W + w]) : 0.f;
  }
}

// the tile pair (I at i0, J at j0): G and dM = dy x^T for rows 4ty + r of I
// and keys 4tx + c of J, D applied: m = G D, dg = dM D (0 off the causal
// part), e = dg G (= dM o M)
__device__ __forceinline__ void pair_tile(const float* ct, const float* dyt, const float* bt,
                                          const float* xt, const float* a_s, int i0, int j0,
                                          int L, int N, int P, int ty, int tx, float m[4][4],
                                          float dg[4][4], float e[4][4]) {
  float g[4][4], dm[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) g[r][c] = dm[r][c] = 0.f;
  for (int n = 0; n < N; ++n) {
    const float4 cv = *reinterpret_cast<const float4*>(&ct[n * kLd + ty * 4]);
    const float4 bv = *reinterpret_cast<const float4*>(&bt[n * kLd + tx * 4]);
    const float c4[4] = {cv.x, cv.y, cv.z, cv.w}, b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) g[r][c] = fmaf(c4[r], b4[c], g[r][c]);
  }
  for (int p = 0; p < P; ++p) {
    const float4 dv = *reinterpret_cast<const float4*>(&dyt[p * kLd + ty * 4]);
    const float4 xv = *reinterpret_cast<const float4*>(&xt[p * kLd + tx * 4]);
    const float d4[4] = {dv.x, dv.y, dv.z, dv.w}, x4[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) dm[r][c] = fmaf(d4[r], x4[c], dm[r][c]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx * 4 + c;
      // the decay only on and below the diagonal: above it exp may overflow
      const float d = (i < L && j <= i) ? expf(a_s[i] - a_s[j]) : 0.f;
      m[r][c] = g[r][c] * d;
      dg[r][c] = dm[r][c] * d;
      e[r][c] = dg[r][c] * g[r][c];
    }
  }
}

// WC: 16-column groups of the widest of N and P, max(N, P) <= 16 * WC
template <typename TB, int WC>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_bwd_kernel(const float* __restrict__ x, const float* __restrict__ a,
                         const TB* __restrict__ bm, const TB* __restrict__ cm,
                         const float* __restrict__ dy, const float* __restrict__ ds,
                         float* __restrict__ dx, float* __restrict__ da, TB* __restrict__ db,
                         TB* __restrict__ dc, int L, int N, int P) {
  extern __shared__ __align__(16) float smem[];
  const int W = max(N, P);
  float* xt = smem;            // [P][kLd] x of J, transposed
  float* bt = xt + W * kLd;    // [N][kLd] B of J
  float* ct = bt + W * kLd;    // [N][kLd] C of I (pass 1: with dyt, dS for the state terms)
  float* dyt = ct + W * kLd;   // [P][kLd] dy of I
  float* ms = dyt + W * kLd;   // [kT][kLd] tile scratch
  float* gs = ms + kT * kLd;   // [kT][kLd]
  float* es = gs + kT * kLd;   // [kT][kLd] dM o M, [row of I][key of J]
  float* a_s = es + kT * kLd;  // [L]
  float* da_s = a_s + L;       // [L]
  float* wdw_s = da_s + L;     // [L] w_j dw_j

  const long long blk = blockIdx.x;
  x += blk * L * P;
  dy += blk * L * P;
  dx += blk * L * P;
  a += blk * L;
  da += blk * L;
  bm += blk * L * N;
  cm += blk * L * N;
  db += blk * L * N;
  dc += blk * L * N;
  ds += blk * N * P;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int i = tid; i < L; i += kThreads) {
    a_s[i] = a[i];
    da_s[i] = 0.f;
  }
  const int nt = (L + kT - 1) / kT;
  const float a_last = a[L - 1];

  // ---- pass 1: dx_J, dB_J, the column sums into da, the state terms
  for (int jt = 0; jt < nt; ++jt) {
    const int j0 = jt * kT;
    __syncthreads();
    load_t(xt, x, j0, L, P);
    load_t(bt, bm, j0, L, N);
    float acc_x[4][WC], acc_b[4][WC];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < WC; ++c) acc_x[r][c] = acc_b[r][c] = 0.f;

    for (int it = jt; it < nt; ++it) {
      const int i0 = it * kT;
      __syncthreads();  // the last pair's reads of ct, dyt, ms, gs, es are done
      load_t(ct, cm, i0, L, N);
      load_t(dyt, dy, i0, L, P);
      __syncthreads();
      float m[4][4], dg[4][4], e[4][4];
      pair_tile(ct, dyt, bt, xt, a_s, i0, j0, L, N, P, ty, tx, m, dg, e);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int o = (ty * 4 + r) * kLd + tx * 4 + c;  // [row of I][key of J]
          ms[o] = m[r][c];
          gs[o] = dg[r][c];
          es[o] = e[r][c];
        }
      __syncthreads();
      // dx_J += M^T dy_I, dB_J += dG^T C_I over the 64 rows of I, in order
      const int ni = min(kT, L - i0);
      for (int i = 0; i < ni; ++i) {
        const float4 m4 = *reinterpret_cast<const float4*>(&ms[i * kLd + ty * 4]);
        const float4 g4 = *reinterpret_cast<const float4*>(&gs[i * kLd + ty * 4]);
        const float mv[4] = {m4.x, m4.y, m4.z, m4.w}, gv[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
        for (int c = 0; c < WC; ++c) {
          const int w = tx + 16 * c;
          const float dyv = w < P ? dyt[w * kLd + i] : 0.f;
          const float cv = w < N ? ct[w * kLd + i] : 0.f;
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            acc_x[r][c] = fmaf(mv[r], dyv, acc_x[r][c]);
            acc_b[r][c] = fmaf(gv[r], cv, acc_b[r][c]);
          }
        }
      }
      if (tid < kT && j0 + tid < L) {  // da_j -= sum_i dM_ij M_ij
        float s = 0.f;
        for (int i = 0; i < ni; ++i) s += es[i * kLd + tid];
        da_s[j0 + tid] -= s;
      }
    }

    // the state terms of J: dS in the space of ct and dyt, [n][p]
    __syncthreads();
    float* dss = ct;
    for (int e = tid; e < N * P; e += kThreads) dss[e] = ds[e];
    __syncthreads();
    float bds[4][WC], xds[4][WC];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < WC; ++c) bds[r][c] = xds[r][c] = 0.f;
    for (int n = 0; n < N; ++n) {  // (B dS)_jp
      const float4 bv = *reinterpret_cast<const float4*>(&bt[n * kLd + ty * 4]);
      const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int c = 0; c < WC; ++c) {
        const int p = tx + 16 * c;
        const float dv = p < P ? dss[n * P + p] : 0.f;
#pragma unroll
        for (int r = 0; r < 4; ++r) bds[r][c] = fmaf(b4[r], dv, bds[r][c]);
      }
    }
    for (int p = 0; p < P; ++p) {  // (x dS^T)_jn
      const float4 xv = *reinterpret_cast<const float4*>(&xt[p * kLd + ty * 4]);
      const float x4[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int c = 0; c < WC; ++c) {
        const int n = tx + 16 * c;
        const float dv = n < N ? dss[n * P + p] : 0.f;
#pragma unroll
        for (int r = 0; r < 4; ++r) xds[r][c] = fmaf(x4[r], dv, xds[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = j0 + ty * 4 + r;
      const float w = j < L ? expf(a_last - a_s[j]) : 0.f;
      // dw_j = sum_p x_jp (B dS)_jp: this thread's columns, then the 16
      // threads of the row in a fixed shuffle tree
      float dw = 0.f;
#pragma unroll
      for (int c = 0; c < WC; ++c) {
        const int p = tx + 16 * c;
        if (p < P) dw = fmaf(xt[p * kLd + ty * 4 + r], bds[r][c], dw);
      }
#pragma unroll
      for (int o = 8; o >= 1; o >>= 1) dw += __shfl_xor_sync(0xffffffffu, dw, o);
      if (j >= L) continue;
      if (tx == 0) {
        wdw_s[j] = w * dw;
        da_s[j] -= w * dw;
      }
#pragma unroll
      for (int c = 0; c < WC; ++c) {
        const int col = tx + 16 * c;
        if (col < P) dx[(long long)j * P + col] = acc_x[r][c] + w * bds[r][c];
        if (col < N) store(&db[(long long)j * N + col], acc_b[r][c] + w * xds[r][c]);
      }
    }
  }
  __syncthreads();
  if (tid == 0) {  // da_{L-1} += sum_j w_j dw_j, in order
    float s = 0.f;
    for (int j = 0; j < L; ++j) s += wdw_s[j];
    da_s[L - 1] += s;
  }

  // ---- pass 2: dC_I and the row sums into da
  for (int it = 0; it < nt; ++it) {
    const int i0 = it * kT;
    __syncthreads();
    load_t(ct, cm, i0, L, N);
    load_t(dyt, dy, i0, L, P);
    float acc_c[4][WC];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < WC; ++c) acc_c[r][c] = 0.f;
    for (int jt = 0; jt <= it; ++jt) {
      const int j0 = jt * kT;
      __syncthreads();
      load_t(xt, x, j0, L, P);
      load_t(bt, bm, j0, L, N);
      __syncthreads();
      float m[4][4], dg[4][4], e[4][4];
      pair_tile(ct, dyt, bt, xt, a_s, i0, j0, L, N, P, ty, tx, m, dg, e);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          gs[(tx * 4 + c) * kLd + ty * 4 + r] = dg[r][c];  // [key of J][row of I]
          es[(ty * 4 + r) * kLd + tx * 4 + c] = e[r][c];   // [row of I][key of J]
        }
      __syncthreads();
      // dC_I += dG B_J over the 64 keys of J, in order
      const int nj = min(kT, L - j0);
      for (int j = 0; j < nj; ++j) {
        const float4 g4 = *reinterpret_cast<const float4*>(&gs[j * kLd + ty * 4]);
        const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
        for (int c = 0; c < WC; ++c) {
          const int n = tx + 16 * c;
          const float bv = n < N ? bt[n * kLd + j] : 0.f;
#pragma unroll
          for (int r = 0; r < 4; ++r) acc_c[r][c] = fmaf(gv[r], bv, acc_c[r][c]);
        }
      }
      if (tid < kT && i0 + tid < L) {  // da_i += sum_j dM_ij M_ij
        float s = 0.f;
        for (int j = 0; j < nj; ++j) s += es[tid * kLd + j];
        da_s[i0 + tid] += s;
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty * 4 + r;
      if (i >= L) continue;
#pragma unroll
      for (int c = 0; c < WC; ++c) {
        const int n = tx + 16 * c;
        if (n < N) store(&dc[(long long)i * N + n], acc_c[r][c]);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < L; i += kThreads) da[i] = da_s[i];
}

template <typename TB, int WC>
int launch(const float* x, const float* a, const void* b, const void* c, const float* dy,
           const float* ds, float* dx, float* da, void* db, void* dc, long long n_blocks, int L,
           int N, int P, cudaStream_t st) {
  const int W = N > P ? N : P;
  const size_t smem = sizeof(float) * (4 * (size_t)W * kLd + 3 * (size_t)kT * kLd + 3 * (size_t)L);
  auto kernel = ssd_chunk_bwd_kernel<TB, WC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)n_blocks, kThreads, smem, st>>>(
      x, a, static_cast<const TB*>(b), static_cast<const TB*>(c), dy, ds, dx, da,
      static_cast<TB*>(db), static_cast<TB*>(dc), L, N, P);
  return (int)cudaGetLastError();
}

template <typename TB>
int dispatch(const float* x, const float* a, const void* b, const void* c, const float* dy,
             const float* ds, float* dx, float* da, void* db, void* dc, long long n_blocks,
             int L, int N, int P, cudaStream_t st) {
  const int W = N > P ? N : P;
  switch ((W + 15) / 16) {
#define SSD_CASE(K) \
  case K:           \
    return launch<TB, K>(x, a, b, c, dy, ds, dx, da, db, dc, n_blocks, L, N, P, st);
    SSD_CASE(1) SSD_CASE(2) SSD_CASE(3) SSD_CASE(4) SSD_CASE(5) SSD_CASE(6) SSD_CASE(7)
    SSD_CASE(8)
#undef SSD_CASE
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The gradients of ssd_chunk_launch's y (BH*C, L, P) and S (BH*C, N, P) for
// x (BH*C, L, P) f32, a (BH*C, L) f32, b and c (BH*C, L, N) f32 (bc_bf16 =
// 0) or bf16 (bc_bf16 = 1), given dy and ds (f32, their shapes): dx (f32),
// da (f32), db and dc (b's dtype), every tensor contiguous. One CTA per
// (bh, chunk) on ``stream``. Returns cudaGetLastError().
extern "C" int ssd_chunk_bwd_launch(const void* x, const void* a, const void* b, const void* c,
                                    const void* dy, const void* ds, void* dx, void* da, void* db,
                                    void* dc, long long n_blocks, int L, int N, int P,
                                    int bc_bf16, void* stream) {
  if (n_blocks < 1 || n_blocks > 0x7fffffffLL || L < 1 || L > 1024 || N < 1 || N > 128 ||
      P < 1 || P > 128)
    return (int)cudaErrorInvalidValue;
  const float *xp = static_cast<const float*>(x), *ap = static_cast<const float*>(a);
  const float *dyp = static_cast<const float*>(dy), *dsp = static_cast<const float*>(ds);
  float *dxp = static_cast<float*>(dx), *dap = static_cast<float*>(da);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bc_bf16)
    return dispatch<__nv_bfloat16>(xp, ap, b, c, dyp, dsp, dxp, dap, db, dc, n_blocks, L, N, P,
                                   st);
  return dispatch<float>(xp, ap, b, c, dyp, dsp, dxp, dap, db, dc, n_blocks, L, N, P, st);
}
