// Mamba-2 SSD within-chunk block and chunk state, for sm_90a.
//
// Replaces: src/repro/kernels/ssd_scan.py :: ssd_chunk_pallas (_ssd_kernel),
// the TPU kernel that, per (batch*head, chunk) of length L, builds the
// (L, L) masked decay in VMEM and computes
//   y = ((C B^T) * exp(A_i - A_j) [i >= j]) X      (L, P)
//   S = (B * exp(A_{L-1} - A))^T X                 (N, P)
// in f32, never writing the (L, L) tile to HBM.
//
// What bounds it on this card: operations. On the serving path of
// Zamba2-2.7B (BH 320, C 16, L 256, N = P 64) one call reads and writes
// ~1.43 GB (0.43 ms at 3.35 TB/s) and does ~5.4e10 f32 operations on and
// below the diagonal (0.81 ms on the f32 CUDA cores).
//
// Design. One CTA of 256 threads per (bh, chunk). The rows are walked in
// tiles of 64; for each row tile the key tiles on and below it are walked
// in order, and the 64 x 64 score tile is built in registers (thread (ty, tx)
// owns rows 4ty..4ty+3 and keys 4tx..4tx+3, with C and B staged transposed
// in shared memory for 16-byte loads), scaled by exp(A_i - A_j) where i >= j
// and set to 0 elsewhere (exp is not taken above the diagonal, where it can
// overflow to inf and inf * 0 would be NaN), passed through shared memory
// and multiplied into the thread's (4, P/16) slice of y. The tiles above the
// diagonal are skipped: they are all zero. The state pass then walks the
// key tiles once more with the decay folded into B. Nothing of the (L, L)
// tile reaches device memory. All arithmetic is f32.
#include <cuda_runtime.h>

namespace {

constexpr int kT = 64;         // rows (and keys) per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kLd = 68;        // row stride of the transposed tiles: 16-byte aligned

size_t smem_bytes(int L, int N, int P) {
  return sizeof(float) * ((size_t)2 * N * kLd + (size_t)kT * kLd + (size_t)kT * P + L);
}

// NC, PC: 16-wide groups of N and P owned per thread (N <= 16 NC, P <= 16 PC)
template <int NC, int PC>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ acum,
                     const float* __restrict__ bm, const float* __restrict__ cm,
                     float* __restrict__ y, float* __restrict__ st, int L, int N, int P) {
  extern __shared__ __align__(16) float smem[];
  float* cs = smem;           // [N][kLd]: C rows of the row tile, transposed
  float* bs = cs + N * kLd;   // [N][kLd]: B rows of the key tile, transposed
  float* gs = bs + N * kLd;   // [kT][kLd]: the masked score tile, transposed
  float* xs = gs + kT * kLd;  // [kT][P]: X rows of the key tile
  float* acs = xs + kT * P;   // [L]: cumulative log decays of the chunk

  const long long blk = blockIdx.x;
  const float* xg = x + blk * L * P;
  const float* bg = bm + blk * L * N;
  const float* cg = cm + blk * L * N;
  float* yg = y + blk * L * P;
  float* sg = st + blk * N * P;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int i = tid; i < L; i += kThreads) acs[i] = acum[blk * L + i];

  const int nt = (L + kT - 1) / kT;
  for (int it = 0; it < nt; ++it) {
    const int i0 = it * kT;
    __syncthreads();  // the last row tile's reads of cs are done
    for (int e = tid; e < kT * N; e += kThreads) {
      const int i = e / N, n = e % N;
      cs[n * kLd + i] = i0 + i < L ? cg[(long long)(i0 + i) * N + n] : 0.f;
    }
    float acc[4][PC];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < PC; ++c) acc[r][c] = 0.f;

    for (int jt = 0; jt <= it; ++jt) {
      const int j0 = jt * kT;
      __syncthreads();  // the last key tile's reads of bs, xs and gs are done
      for (int e = tid; e < kT * N; e += kThreads) {
        const int j = e / N, n = e % N;
        bs[n * kLd + j] = j0 + j < L ? bg[(long long)(j0 + j) * N + n] : 0.f;
      }
      for (int e = tid; e < kT * P; e += kThreads) {
        const int j = e / P, p = e % P;
        xs[j * P + p] = j0 + j < L ? xg[(long long)(j0 + j) * P + p] : 0.f;
      }
      __syncthreads();

      float g[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) g[r][c] = 0.f;
      for (int n = 0; n < N; ++n) {
        const float4 a = *reinterpret_cast<const float4*>(&cs[n * kLd + ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&bs[n * kLd + tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) g[r][c] = fmaf(av[r], bv[c], g[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty * 4 + r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = j0 + tx * 4 + c;
          g[r][c] = (i >= j && i < L) ? g[r][c] * expf(acs[i] - acs[j]) : 0.f;
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<float4*>(&gs[(tx * 4 + c) * kLd + ty * 4]) =
            make_float4(g[0][c], g[1][c], g[2][c], g[3][c]);
      __syncthreads();

      const int nj = min(kT, L - j0);
      for (int j = 0; j < nj; ++j) {
        const float4 gv4 = *reinterpret_cast<const float4*>(&gs[j * kLd + ty * 4]);
        const float gv[4] = {gv4.x, gv4.y, gv4.z, gv4.w};
#pragma unroll
        for (int c = 0; c < PC; ++c) {
          const int p = tx + 16 * c;
          const float xv = p < P ? xs[j * P + p] : 0.f;
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(gv[r], xv, acc[r][c]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty * 4 + r;
      if (i >= L) continue;
#pragma unroll
      for (int c = 0; c < PC; ++c) {
        const int p = tx + 16 * c;
        if (p < P) yg[(long long)i * P + p] = acc[r][c];
      }
    }
  }

  // chunk state: thread (ty, tx) owns S[ty + 16a][tx + 16c]
  float sacc[NC][PC];
#pragma unroll
  for (int a = 0; a < NC; ++a)
#pragma unroll
    for (int c = 0; c < PC; ++c) sacc[a][c] = 0.f;
  const float a_last = acs[L - 1];
  float* bd = bs;  // [kT][N]: B rows times exp(A_{L-1} - A_j); fits in bs
  for (int jt = 0; jt < nt; ++jt) {
    const int j0 = jt * kT;
    __syncthreads();
    for (int e = tid; e < kT * N; e += kThreads) {
      const int j = e / N, n = e % N;
      bd[j * N + n] =
          j0 + j < L ? bg[(long long)(j0 + j) * N + n] * expf(a_last - acs[j0 + j]) : 0.f;
    }
    for (int e = tid; e < kT * P; e += kThreads) {
      const int j = e / P, p = e % P;
      xs[j * P + p] = j0 + j < L ? xg[(long long)(j0 + j) * P + p] : 0.f;
    }
    __syncthreads();
    const int nj = min(kT, L - j0);
    for (int j = 0; j < nj; ++j) {
      float xv[PC];
#pragma unroll
      for (int c = 0; c < PC; ++c) {
        const int p = tx + 16 * c;
        xv[c] = p < P ? xs[j * P + p] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < NC; ++a) {
        const int n = ty + 16 * a;
        const float bv = n < N ? bd[j * N + n] : 0.f;
#pragma unroll
        for (int c = 0; c < PC; ++c) sacc[a][c] = fmaf(bv, xv[c], sacc[a][c]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < NC; ++a) {
    const int n = ty + 16 * a;
    if (n >= N) continue;
#pragma unroll
    for (int c = 0; c < PC; ++c) {
      const int p = tx + 16 * c;
      if (p < P) sg[(long long)n * P + p] = sacc[a][c];
    }
  }
}

template <int NC, int PC>
int launch(const float* x, const float* a, const float* b, const float* c, float* y, float* s,
           long long n_blocks, int L, int N, int P, cudaStream_t st) {
  auto kernel = ssd_chunk_kernel<NC, PC>;
  const size_t smem = smem_bytes(L, N, P);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)n_blocks, kThreads, smem, st>>>(x, a, b, c, y, s, L, N, P);
  return (int)cudaGetLastError();
}

// 16-wide groups rounded up to a power of two: 1, 2, 4 or 8
int groups(int width) {
  int g = 1;
  while (16 * g < width) g *= 2;
  return g;
}

template <int NC>
int dispatch_p(int pc, const float* x, const float* a, const float* b, const float* c, float* y,
               float* s, long long n_blocks, int L, int N, int P, cudaStream_t st) {
  switch (pc) {
    case 1: return launch<NC, 1>(x, a, b, c, y, s, n_blocks, L, N, P, st);
    case 2: return launch<NC, 2>(x, a, b, c, y, s, n_blocks, L, N, P, st);
    case 4: return launch<NC, 4>(x, a, b, c, y, s, n_blocks, L, N, P, st);
    case 8: return launch<NC, 8>(x, a, b, c, y, s, n_blocks, L, N, P, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// y (n_blocks, L, P) and s (n_blocks, N, P), f32 and contiguous, from x
// (n_blocks, L, P), a_cumsum (n_blocks, L), b and c (n_blocks, L, N), where
// n_blocks = BH * C chunks. Returns cudaGetLastError() after the launch.
extern "C" int ssd_chunk_launch(const void* x, const void* a, const void* b, const void* c,
                                void* y, void* s, long long n_blocks, int L, int N, int P,
                                void* stream) {
  if (n_blocks < 1 || n_blocks > 0x7fffffffLL || L < 1 || L > 1024 || N < 1 || N > 128 ||
      P < 1 || P > 128)
    return (int)cudaErrorInvalidValue;
  const float *xp = static_cast<const float*>(x), *ap = static_cast<const float*>(a);
  const float *bp = static_cast<const float*>(b), *cp = static_cast<const float*>(c);
  float *yp = static_cast<float*>(y), *sp = static_cast<float*>(s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int pc = groups(P);
  switch (groups(N)) {
    case 1: return dispatch_p<1>(pc, xp, ap, bp, cp, yp, sp, n_blocks, L, N, P, st);
    case 2: return dispatch_p<2>(pc, xp, ap, bp, cp, yp, sp, n_blocks, L, N, P, st);
    case 4: return dispatch_p<4>(pc, xp, ap, bp, cp, yp, sp, n_blocks, L, N, P, st);
    case 8: return dispatch_p<8>(pc, xp, ap, bp, cp, yp, sp, n_blocks, L, N, P, st);
  }
  return (int)cudaErrorInvalidValue;
}
