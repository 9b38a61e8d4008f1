// Mamba-2 SSD within-chunk block and chunk state, for sm_90a, on the tensor
// cores.
//
// Replaces: src/repro/kernels/ssd_scan.py :: ssd_chunk_pallas (_ssd_kernel),
// the TPU kernel that, per (batch*head, chunk) of length L, builds the
// (L, L) masked decay in VMEM and computes
//   y = ((C B^T) * exp(A_i - A_j) [i >= j]) X      (L, P)
//   S = (B * exp(A_{L-1} - A))^T X                 (N, P)
// in f32, never writing the (L, L) tile to HBM. B and C may come in as bf16
// (the TPU kernel widens its operands to f32 inside) or f32; x, A and both
// outputs are f32.
//
// What bounds it on this card: the bytes. On the serving path of
// Zamba2-2.7B (BH 320, C 16, L 256, N = P 64, bf16 B and C) one call reads
// x, A, B and C and writes y and S once, 1.1 GB (0.33 ms at 3.35 TB/s).
// Its products run on the tensor cores: C B^T on the bf16 operands (0.02 ms
// at the bf16 rate), G X and the state in 3xTF32 (three TF32 products
// each, 0.20 ms at the TF32 rate); on the f32 CUDA cores the same work
// takes 0.80 ms. The kernel does not reach that bound: what holds it back
// is the instruction rate of the split arithmetic and of the mma.sync
// products (whose TF32 rate is below wgmma's), with three CTAs of four
// warps an SM.
//
// How it is held. The kernel sums in another order than cuBLAS does for
// the plain version (ssd_scan.ssd_chunk_plain), so the two differ in their
// last bits. Each output is held to the fp32 rule of chip_smoke.py
// (max(1e-5, 4 sqrt(n) 2^-24) x max|plain| over n terms): at odd shapes in
// phase 7, and in phase 9 on every one of the 54 calls of a Zamba2-2.7B
// prefill, on the inputs each layer really receives. Phase 9 shows in the
// same run that the rule passes the function computed in f64 and rounded
// and fails it computed on one TF32 pass, which is why no product here is
// a single TF32 pass.
//
// Design. One CTA of 4 warps per (bh, chunk, 64 columns of P); the rows
// are walked in tiles of 64, and for each row tile the key tiles on and
// below it, in order (tiles above the diagonal are all zero and skipped).
// Warp w owns rows 16w..16w+15 of the row tile.
//   * Scores: the warp's 16 x 64 tile of C B^T with mma.sync, m16n8k16 on
//     bf16 B and C (a bf16 x bf16 product is exact in f32, so this is the
//     function itself, summed by the tensor core in f32), m16n8k8 3xTF32 on
//     f32 B and C. On the diagonal tile the key blocks above the warp's
//     rows are skipped.
//   * The decay: each score is multiplied by exp(A_i - A_j) in registers,
//     rounded as the plain version rounds it. Above the diagonal the
//     argument is -inf, so the factor is 0 and exp never overflows there
//     (inf * 0 would be NaN). There is no branch, so that the compiler can
//     interleave the 32 exponentials of a lane.
//   * G X: the accumulator of an n8 block of scores (columns 2t, 2t+1 of
//     lane (g, t)) is the A fragment of an m16n8k8 product whose keys are
//     taken in the order 0, 2, 4, 6, 1, 3, 5, 7, so the masked tile goes
//     from registers straight into the next product, and X's fragment rows
//     are read in the same order. 3xTF32: each operand is split into a TF32
//     high part and its rest (tc_common.cuh), and the three products
//     accumulate in the tensor core's f32 accumulator across the row's keys
//     (phase 9 reports how close its rounding of those adds comes to the
//     fp32 rule's limit).
//   * The state: the last row tile's walk visits every key tile, so S is
//     accumulated there, from the B tile already staged (scaled by
//     exp(A_{L-1} - A_j) in f32, then split) and the X fragments already
//     split for G X. Warp w owns state rows 16w..16w+15 (+64 for N > 64).
//   * Staging: a two-stage cp.async ring over the key tiles' B, X and A
//     (and, with a row tile's first key tile, its C tile, double-buffered):
//     the copies of the next (row tile, key tile) pair are in flight while
//     the current one is computed, with one barrier a pair. Rows of the
//     tiles are padded by 16 bytes so that the fragment loads meet no bank
//     conflict. Shapes whose rows cannot be copied in 16-byte pieces (N, P
//     or L not a multiple of the piece, or an unaligned operand) are staged
//     by ordinary loads instead.
//   * Nothing of the (L, L) tile reaches device memory. At the serving
//     shape a CTA takes 72 KB of shared memory and 168 registers a thread;
//     three fit an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "ssd_common.cuh"

namespace {

using tc::mma_tf32;
using tc::split;

constexpr int kT = 64;             // rows and keys per tile, and P columns per CTA
constexpr int kPN = kT / 8;        // n8 blocks of the P columns
constexpr int kWarps = 4;          // one 16-row block of the row tile each
constexpr int kThreads = 32 * kWarps;
constexpr int kSX = kT + 4;        // row stride (floats) of the staged X tile

// byte offsets of the shared-memory buffers: C (two row tiles), then the
// two ring stages of B, X and A; every offset a multiple of 16
template <typename T>
struct Layout {
  size_t c[2], b[2], x[2], a[2], total;
  __host__ __device__ explicit Layout(int n) {
    const size_t bc = (size_t)kT * bc_stride<T>(n) * sizeof(T);
    size_t o = 0;
    for (int s = 0; s < 2; ++s) c[s] = o, o += bc;
    for (int s = 0; s < 2; ++s) b[s] = o, o += bc;
    for (int s = 0; s < 2; ++s) x[s] = o, o += (size_t)kT * kSX * sizeof(float);
    for (int s = 0; s < 2; ++s) a[s] = o, o += kT * sizeof(float);
    total = o;
  }
};

// The warp's 16 x 64 score tile sc[q] (keys 8q..8q+7, q <= qmax) of C B^T:
// cs rows 16w.., bs rows the tile's keys, np (N rounded to 16) columns
template <typename TBC>
__device__ __forceinline__ void scores(float (&sc)[8][4], const TBC* cs, const TBC* bs, int ld,
                                       int np, int w, int g, int t, int qmax) {
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[q][e] = 0.f;
  if constexpr (std::is_same<TBC, __nv_bfloat16>::value) {
    const TBC* c0 = cs + (16 * w + g) * ld + 2 * t;
    const TBC* c1 = c0 + 8 * ld;
    for (int k = 0; k < np; k += 16) {
      const uint32_t a[4] = {ld32(c0 + k), ld32(c1 + k), ld32(c0 + k + 8), ld32(c1 + k + 8)};
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (q > qmax) continue;
        const TBC* bp = bs + (8 * q + g) * ld + 2 * t + k;
        const uint32_t b[2] = {ld32(bp), ld32(bp + 8)};
        mma_bf16(sc[q], a, b);
      }
    }
  } else {
    const float* c0 = cs + (16 * w + g) * ld + t;
    const float* c1 = c0 + 8 * ld;
    for (int k = 0; k < np; k += 8) {
      uint32_t ah[4], al[4];
      split(c0[k], ah[0], al[0]);
      split(c1[k], ah[1], al[1]);
      split(c0[k + 4], ah[2], al[2]);
      split(c1[k + 4], ah[3], al[3]);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (q > qmax) continue;
        const float* bp = bs + (8 * q + g) * ld + t + k;
        uint32_t bh[2], bl[2];
        split(bp[0], bh[0], bl[0]);
        split(bp[4], bh[1], bl[1]);
        mma_3xtf32(sc[q], ah, al, bh, bl);
      }
    }
  }
}

// One (row tile, key tile) pair for warp w: its 16 x 64 scores, their decay
// and the products into yacc and, on the last row tile (kLast), sacc.
// kDiag: the key tile is the row tile (keys above a row are masked).
template <typename TBC, int NS, bool kLast, bool kDiag>
__device__ __forceinline__ void pair(float (&yacc)[kPN][4], float (&sacc)[NS][kPN][4],
                                     const TBC* cs, const TBC* bs, const float* xs,
                                     const float* as, int ld, int np, int w, int g, int t,
                                     int j0, int L, const float (&ai)[2], float a_last) {
  const int qmax = kDiag ? 2 * w + 1 : 7;  // key blocks on or below the warp's rows
  float sc[8][4];
  scores<TBC>(sc, cs, bs, ld, np, w, g, t, qmax);
  // the decay, without a branch: exp(-inf) = 0 masks a key after its row.
  // Below the diagonal tile every key precedes every row. Rows past L are
  // never stored.
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    if (kDiag && q > qmax) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * w + g + 8 * (e >> 1), k = 8 * q + 2 * t + (e & 1);
      const float arg = !kDiag || k <= r ? ai[e >> 1] - as[k] : -INFINITY;
      sc[q][e] = __fmul_rn(sc[q][e], expf(arg));
    }
  }
  // the state's rows n = nb + g, n + 8 of block s; a warp past N computes
  // rows it never stores (its base is clamped into the tile)
  int nb[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) nb[s] = min(16 * w + 64 * s, np - 16);

#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const bool ydo = !kDiag || q <= qmax;
    if (!kLast && !ydo) continue;
    const int k0 = 8 * q + 2 * t;  // the lane's keys k0 and k0 + 1 in this block
    // A of G X: keys in the order 2t (a0, a1), 2t + 1 (a2, a3)
    uint32_t ah[4], al[4];
    split(sc[q][0], ah[0], al[0]);
    split(sc[q][2], ah[1], al[1]);
    split(sc[q][1], ah[2], al[2]);
    split(sc[q][3], ah[3], al[3]);
    // A of the state: (B * exp(A_{L-1} - A))^T, rows n, the same key order
    uint32_t sh[NS][4], sl[NS][4];
    if (kLast) {
      const float w0 = expf(j0 + k0 < L ? a_last - as[k0] : -INFINITY);
      const float w1 = expf(j0 + k0 + 1 < L ? a_last - as[k0 + 1] : -INFINITY);
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const TBC* b0 = bs + k0 * ld + nb[s] + g;
        split(__fmul_rn(to_f32(b0[0]), w0), sh[s][0], sl[s][0]);
        split(__fmul_rn(to_f32(b0[8]), w0), sh[s][1], sl[s][1]);
        split(__fmul_rn(to_f32(b0[ld]), w1), sh[s][2], sl[s][2]);
        split(__fmul_rn(to_f32(b0[ld + 8]), w1), sh[s][3], sl[s][3]);
      }
    }
    // B of both: X rows k0, k0 + 1
    uint32_t bh[kPN][2], bl[kPN][2];
#pragma unroll
    for (int pn = 0; pn < kPN; ++pn) {
      split(xs[k0 * kSX + 8 * pn + g], bh[pn][0], bl[pn][0]);
      split(xs[(k0 + 1) * kSX + 8 * pn + g], bh[pn][1], bl[pn][1]);
    }
    if (ydo) {
#pragma unroll
      for (int pn = 0; pn < kPN; ++pn) mma_3xtf32(yacc[pn], ah, al, bh[pn], bl[pn]);
    }
    if (kLast) {
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int pn = 0; pn < kPN; ++pn) mma_3xtf32(sacc[s][pn], sh[s], sl[s], bh[pn], bl[pn]);
    }
  }
}

// TBC: the type of B and C. NS: 64-row blocks of the state (N <= 64 NS).
template <typename TBC, int NS>
__global__ void __launch_bounds__(kThreads, NS == 1 ? 3 : 2)
    ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ acum,
                     const TBC* __restrict__ bm, const TBC* __restrict__ cm,
                     float* __restrict__ y, float* __restrict__ st, int L, int N, int P,
                     int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout<TBC> lay(N);
  const int ld = bc_stride<TBC>(N), np = round16(N);
  const long long blk = blockIdx.x;
  const int p0 = blockIdx.y * kT;
  const float* xg = x + blk * L * P + p0;
  const float* ag = acum + blk * L;
  const TBC* bg = bm + blk * L * N;
  const TBC* cg = cm + blk * L * N;
  float* yg = y + blk * L * P;
  float* sg = st + blk * N * P;
  const int w = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int nt = (L + kT - 1) / kT, n_pairs = nt * (nt + 1) / 2;
  auto cbuf = [&](int s) { return reinterpret_cast<TBC*>(smem + lay.c[s]); };
  auto bbuf = [&](int s) { return reinterpret_cast<TBC*>(smem + lay.b[s]); };
  auto xbuf = [&](int s) { return reinterpret_cast<float*>(smem + lay.x[s]); };
  auto abuf = [&](int s) { return reinterpret_cast<float*>(smem + lay.a[s]); };

  // the B and C columns from N up to np: cp.async never writes them
  if (vec && np > N) {
    for (int s = 0; s < 4; ++s) {
      TBC* buf = s < 2 ? cbuf(s) : bbuf(s - 2);
      for (int e = threadIdx.x; e < kT * (np - N); e += kThreads)
        buf[(e / (np - N)) * ld + N + e % (np - N)] = TBC(0.f);
    }
  }
  // the copies of pair (it, jt) into ring stage s
  auto stage = [&](int it, int jt, int s) {
    const int j0 = jt * kT;
    stage_tile<kThreads>(bbuf(s), ld, bg + (long long)j0 * N, N, L - j0, N, kT, vec ? N : np, vec);
    stage_tile<kThreads>(xbuf(s), kSX, xg + (long long)j0 * P, P, L - j0, P - p0, kT, kT, vec);
    stage_tile<kThreads>(abuf(s), kT, ag + j0, 0, 1, L - j0, 1, kT, vec);
    if (jt == 0)
      stage_tile<kThreads>(cbuf(it & 1), ld, cg + (long long)it * kT * N, N, L - it * kT, N, kT,
                 vec ? N : np, vec);
  };
  auto advance = [](int& it, int& jt) {
    if (jt < it) ++jt;
    else ++it, jt = 0;
  };

  float yacc[kPN][4], sacc[NS][kPN][4];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int pn = 0; pn < kPN; ++pn)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[s][pn][e] = 0.f;
  float ai[2] = {0.f, 0.f};  // A at the lane's rows g and g + 8 of the row tile
  const float a_last = ag[L - 1];

  int sit = 0, sjt = 0;  // the next pair to stage
  stage(sit, sjt, 0);
  cp_async_commit();
  advance(sit, sjt);
  int it = 0, jt = 0;
  for (int pi = 0; pi < n_pairs; ++pi) {
    cp_async_wait<0>();  // pair pi's copies have landed (this thread's)
    // everyone's; and everyone is done with pair pi - 1, whose stage (and,
    // after a row tile, C tile) the next copies overwrite
    __syncthreads();
    if (pi + 1 < n_pairs) {
      stage(sit, sjt, (pi + 1) & 1);
      advance(sit, sjt);
    }
    cp_async_commit();
    const TBC* cs = cbuf(it & 1);
    const TBC* bs = bbuf(pi & 1);
    const float* xs = xbuf(pi & 1);
    const float* as = abuf(pi & 1);
    const int i0 = it * kT, j0 = jt * kT;
    if (jt == 0) {
#pragma unroll
      for (int pn = 0; pn < kPN; ++pn)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[pn][e] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + 16 * w + g + 8 * h;
        ai[h] = i < L ? ag[i] : 0.f;
      }
    }
    const bool last = it == nt - 1;  // its walk visits every key tile
    const auto run = [&](auto last_c, auto diag_c) {
      pair<TBC, NS, decltype(last_c)::value, decltype(diag_c)::value>(
          yacc, sacc, cs, bs, xs, as, ld, np, w, g, t, j0, L, ai, a_last);
    };
    using T_ = std::true_type;
    using F_ = std::false_type;
    if (last) {
      if (jt == it) run(T_{}, T_{});
      else run(T_{}, F_{});
    } else {
      if (jt == it) run(F_{}, T_{});
      else run(F_{}, F_{});
    }

    if (jt == it) {  // the row tile is done
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + 16 * w + g + 8 * h;
        if (i >= L) continue;
        float* yr = yg + (long long)i * P;
#pragma unroll
        for (int pn = 0; pn < kPN; ++pn) {
          const int p = p0 + 8 * pn + 2 * t;
          if (p + 1 < P && P % 2 == 0) {
            *reinterpret_cast<float2*>(yr + p) = make_float2(yacc[pn][2 * h], yacc[pn][2 * h + 1]);
          } else {
            if (p < P) yr[p] = yacc[pn][2 * h];
            if (p + 1 < P) yr[p + 1] = yacc[pn][2 * h + 1];
          }
        }
      }
    }
    advance(it, jt);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int pn = 0; pn < kPN; ++pn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 16 * w + 64 * s + g + 8 * (e >> 1), p = p0 + 8 * pn + 2 * t + (e & 1);
        if (n < N && p < P) sg[(long long)n * P + p] = sacc[s][pn][e];
      }
}

template <typename TBC, int NS>
int launch(const float* x, const float* a, const void* b, const void* c, float* y, float* s,
           long long n_blocks, int L, int N, int P, bool vec, cudaStream_t st) {
  auto kernel = ssd_chunk_kernel<TBC, NS>;
  const size_t smem = Layout<TBC>(N).total;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)n_blocks, (unsigned)((P + kT - 1) / kT));
  kernel<<<grid, kThreads, smem, st>>>(x, a, static_cast<const TBC*>(b),
                                       static_cast<const TBC*>(c), y, s, L, N, P, vec);
  return (int)cudaGetLastError();
}

template <typename TBC>
int dispatch(const float* x, const float* a, const void* b, const void* c, float* y, float* s,
             long long n_blocks, int L, int N, int P, cudaStream_t st) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  // every row of every tile copies in whole 16-byte pieces
  const bool vec = (N * (int)sizeof(TBC)) % 16 == 0 && P % 4 == 0 && L % 4 == 0 &&
                   aligned(x) && aligned(a) && aligned(b) && aligned(c);
  if (N <= 64) return launch<TBC, 1>(x, a, b, c, y, s, n_blocks, L, N, P, vec, st);
  return launch<TBC, 2>(x, a, b, c, y, s, n_blocks, L, N, P, vec, st);
}

}  // namespace

// y (n_blocks, L, P) and s (n_blocks, N, P) f32, from x (n_blocks, L, P) and
// a_cumsum (n_blocks, L) f32 and b, c (n_blocks, L, N), f32 (bc_bf16 = 0) or
// bf16 (bc_bf16 = 1), all contiguous; n_blocks = BH * C chunks. Returns
// cudaGetLastError() after the launch.
extern "C" int ssd_chunk_launch(const void* x, const void* a, const void* b, const void* c,
                                void* y, void* s, long long n_blocks, int L, int N, int P,
                                int bc_bf16, void* stream) {
  if (n_blocks < 1 || n_blocks > 0x7fffffffLL || L < 1 || L > 1024 || N < 1 || N > 128 ||
      P < 1 || P > 128)
    return (int)cudaErrorInvalidValue;
  const float *xp = static_cast<const float*>(x), *ap = static_cast<const float*>(a);
  float *yp = static_cast<float*>(y), *sp = static_cast<float*>(s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bc_bf16) return dispatch<__nv_bfloat16>(xp, ap, b, c, yp, sp, n_blocks, L, N, P, st);
  return dispatch<float>(xp, ap, b, c, yp, sp, n_blocks, L, N, P, st);
}
