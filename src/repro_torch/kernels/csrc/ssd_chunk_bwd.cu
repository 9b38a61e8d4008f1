// The backward pass of the Mamba-2 SSD within-chunk block and chunk state,
// for sm_90a, on the tensor cores.
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
// dx and da come back in f32, dB and dC in B's dtype (f32 or bf16).
//
// What bounds it on this card: operations. At Zamba2-2.7B's training shape
// (BH 160, C 16, L 256, N = P 64, bf16 B and C) one call needs C B^T over
// the causal half at the bf16 rate and dy x^T, M^T dy, dG B, dG^T C and the
// two state terms as three TF32 products each: 0.337 ms, against 0.55 GB of
// operands and gradients (0.16 ms). This design does more: it forms G and
// dy x^T twice (once in each of its two kernels), a product with a bf16
// operand takes two TF32 passes (2xTF32: a bf16 value is exact in TF32, so
// only the f32 side is split), and the kernel that owns a chunk's last key
// tile forms B dS of the other key tiles once more (below); about 0.41 ms
// at the TF32 rate; it takes 2.7 ms on one H100 (PERF.md). What holds it
// above that: the 3xTF32 mma.sync products (one pass instead of three,
// tried as a probe, cuts the key-tile kernel most), with their splits and
// fragment loads, at two CTAs of 4 warps an SM.
//
// How it is held. No product is a single TF32 pass: phase 9 of
// chip_smoke.py shows that the fp32 rule (max(1e-5, 4 sqrt(n) 2^-24) x
// max|plain| over n terms) passes the function rounded from f64 and fails
// it on one TF32 pass. C B^T on bf16 B and C is m16n8k16 bf16, exact in its
// products; every other product is m16n8k8 TF32 through tc_common.cuh:
// 3xTF32 where both operands are f32, 2xTF32 where one is bf16. f32 B and C
// take 3xTF32 for C B^T too. Every gradient is summed by one CTA in a fixed
// order, with no atomics, so two calls give the same bits.
//
// Design. Two kernels, each with one CTA of 4 warps per (bh, chunk, 64-row
// tile) and warp w owning rows 16w..16w+15 of its tile, built as the
// forward is (ssd_common.cuh): operands staged by a two-stage cp.async ring,
// B and C kept bf16 in shared memory, rows padded by 16 bytes against bank
// conflicts, shapes whose rows cannot be copied in 16-byte pieces staged by
// ordinary loads.
//  - ssd_bwd_cols_kernel: the key tile J (dx_J, dB_J, the column sums of
//    dM o M, the state terms). B_J, x_J and a_J stay staged; the row tiles
//    I >= J stream through the ring (C_I, dy_I, a_I). Per pair: G^T = B_J
//    C_I^T and dM^T = x_J dy_I^T on the tensor cores, the decay, dG^T and
//    M^T in registers, then dx_J += M^T dy_I and dB_J += dG^T C_I with the
//    accumulator fragments as the A operands (keys taken in the order 0, 2,
//    4, 6, 1, 3, 5, 7, as the forward does). Then dS is staged, B_J dS and
//    x_J dS^T are formed, and da_j = -(column sum) - w_j dw_j is written.
//    The CTA of the chunk's last key tile also forms w_j dw_j of every
//    other key tile (the same arithmetic as their own CTAs) and adds their
//    sum, in order, to da_{L-1}.
//  - ssd_bwd_rows_kernel (launched after it): the row tile I (dC_I, the
//    row sums). C_I, dy_I and a_I stay staged; the key tiles J <= I stream
//    through the ring. Per pair: G = C_I B_J^T and dM = dy_I x_J^T, dG, and
//    dC_I += dG B_J; then da_i += (row sum), read back from the first
//    kernel's da.
// The CTAs with the most pairs start first. Nothing of the (L, L) tiles
// reaches device memory. At the training shape a CTA takes 79 KB of shared
// memory; two fit an SM. Registers (ptxas, printed by chip_smoke.py's
// phases 1 and 22c), N and P <= 64: the key-tile kernel 235 (bf16 B and C)
// or 234 (f32), the row-tile kernel 206 or 198, none spilling; at N or P
// 128 the key-tile kernel spills about 350 bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>
#include <type_traits>

#include "ssd_common.cuh"

namespace {

using tc::mma_tf32;
using tc::split;

constexpr int kT = 64;             // rows and keys a tile
constexpr int kThreads = 128;      // four warps, one 16-row block of the tile each

template <typename T>
constexpr bool kExact = std::is_same<T, __nv_bfloat16>::value;  // exact in TF32

// the TF32 parts of an operand value: an f32 value split into hi + lo; a
// bf16 value is exact in TF32 (lo is never read)
__device__ __forceinline__ void parts(float v, uint32_t& hi, uint32_t& lo) { split(v, hi, lo); }
__device__ __forceinline__ void parts(__nv_bfloat16 v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(__bfloat162float(v));
  lo = 0u;
}

// acc += a b on the TF32 parts: the small products first, a side's lo only
// where it is f32 (3xTF32, or 2xTF32 with one exact operand)
template <bool kAExact, bool kBExact>
__device__ __forceinline__ void mma_parts(float* acc, const uint32_t* ah, const uint32_t* al,
                                          const uint32_t* bh, const uint32_t* bl) {
  if (!kAExact) mma_tf32(acc, al, bh);
  if (!kBExact) mma_tf32(acc, ah, bl);
  mma_tf32(acc, ah, bh);
}

// acc[nb] (the warp's rows 16w.., columns 8nb..8nb+7) = sum over k < kdim
// of a[r][k] b[8nb + c][k], a and b row-major in shared memory; blocks
// outside [nb0, nb1] stay 0. bf16 x bf16: m16n8k16 (kdim a multiple of
// 16); else TF32 m16n8k8 (kdim a multiple of 8).
template <int NB, typename TA, typename TB>
__device__ __forceinline__ void abt(float (&acc)[NB][4], const TA* as, int lda, const TB* bs,
                                    int ldb, int kdim, int w, int g, int t, int nb0, int nb1) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
  if constexpr (kExact<TA> && kExact<TB>) {
    const TA* a0 = as + (16 * w + g) * lda + 2 * t;
    const TA* a1 = a0 + 8 * lda;
    for (int k = 0; k < kdim; k += 16) {
      const uint32_t a[4] = {ld32(a0 + k), ld32(a1 + k), ld32(a0 + k + 8), ld32(a1 + k + 8)};
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        if (nb < nb0 || nb > nb1) continue;
        const TB* bp = bs + (8 * nb + g) * ldb + 2 * t + k;
        const uint32_t b[2] = {ld32(bp), ld32(bp + 8)};
        mma_bf16(acc[nb], a, b);
      }
    }
  } else {
    const TA* a0 = as + (16 * w + g) * lda + t;
    const TA* a1 = a0 + 8 * lda;
    for (int k = 0; k < kdim; k += 8) {
      uint32_t ah[4], al[4];
      parts(a0[k], ah[0], al[0]);
      parts(a1[k], ah[1], al[1]);
      parts(a0[k + 4], ah[2], al[2]);
      parts(a1[k + 4], ah[3], al[3]);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        if (nb < nb0 || nb > nb1) continue;
        const TB* bp = bs + (8 * nb + g) * ldb + t + k;
        uint32_t bh[2], bl[2];
        parts(bp[0], bh[0], bl[0]);
        parts(bp[4], bh[1], bl[1]);
        mma_parts<kExact<TA>, kExact<TB>>(acc[nb], ah, al, bh, bl);
      }
    }
  }
}

// acc[nb] = sum over k < kdim of a[r][k] b[k][8nb + c]: a row-major (the
// warp's rows 16w..), b row-major [k][column], both in shared memory; TF32
// m16n8k8, b f32
template <int NB, typename TA>
__device__ __forceinline__ void ab(float (&acc)[NB][4], const TA* as, int lda, const float* bs,
                                   int ldb, int kdim, int w, int g, int t) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
  const TA* a0 = as + (16 * w + g) * lda + t;
  const TA* a1 = a0 + 8 * lda;
  for (int k = 0; k < kdim; k += 8) {
    uint32_t ah[4], al[4];
    parts(a0[k], ah[0], al[0]);
    parts(a1[k], ah[1], al[1]);
    parts(a0[k + 4], ah[2], al[2]);
    parts(a1[k + 4], ah[3], al[3]);
    const float* b0 = bs + (k + t) * ldb + g;
    const float* b1 = b0 + 4 * ldb;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      uint32_t bh[2], bl[2];
      split(b0[8 * nb], bh[0], bl[0]);
      split(b1[8 * nb], bh[1], bl[1]);
      mma_parts<kExact<TA>, false>(acc[nb], ah, al, bh, bl);
    }
  }
}

// acc[pn] (the warp's 16 rows, columns 8pn..) += sum over the keys of
// blocks q in [q0, q1] of a[q] b[key][8pn + c]: a an accumulator fragment
// (a[q][e] is row g + 8 (e >> 1), key 8q + 2t + (e & 1)), taken as the A
// operand with the keys in the order 0, 2, 4, 6, 1, 3, 5, 7, and b
// row-major in shared memory, whose rows are read in the same order
template <int NB, typename TB>
__device__ __forceinline__ void rab(float (&acc)[NB][4], const float (&a)[8][4], const TB* bs,
                                    int ldb, int g, int t, int q0, int q1) {
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    if (q < q0 || q > q1) continue;
    uint32_t ah[4], al[4];
    split(a[q][0], ah[0], al[0]);
    split(a[q][2], ah[1], al[1]);
    split(a[q][1], ah[2], al[2]);
    split(a[q][3], ah[3], al[3]);
    const TB* b0 = bs + (8 * q + 2 * t) * ldb + g;
    const TB* b1 = b0 + ldb;
#pragma unroll
    for (int pn = 0; pn < NB; ++pn) {
      uint32_t bh[2], bl[2];
      parts(b0[8 * pn], bh[0], bl[0]);
      parts(b1[8 * pn], bh[1], bl[1]);
      mma_parts<false, kExact<TB>>(acc[pn], ah, al, bh, bl);
    }
  }
}

// byte offsets of the shared-memory buffers: the staged tile (B or C, x or
// dy, a), then the two ring stages of the streamed one; every offset a
// multiple of 16. After the cols kernel's walk its ring holds dS.
template <typename TBC, int WC>
struct Layout {
  static constexpr int kW = 64 * WC;  // staged columns of every tile
  static constexpr int kLdb = kW + 16 / (int)sizeof(TBC);
  static constexpr int kLdx = kW + 4;
  static constexpr size_t kBC = (size_t)kT * kLdb * sizeof(TBC);
  static constexpr size_t kX = (size_t)kT * kLdx * sizeof(float);
  static constexpr size_t kA = kT * sizeof(float);
  static constexpr size_t kTile = kBC + kX + kA;
  static constexpr size_t kTotal = 3 * kTile;
  static_assert(2 * kTile >= (size_t)kW * kLdx * sizeof(float), "the ring holds dS");
};

// the pieces of one tile set (B or C, x or dy, a) at ``base``
template <typename TBC, int WC>
struct Tiles {
  TBC* bc;
  float* x;
  float* a;
  __device__ explicit Tiles(unsigned char* base)
      : bc(reinterpret_cast<TBC*>(base)),
        x(reinterpret_cast<float*>(base + Layout<TBC, WC>::kBC)),
        a(reinterpret_cast<float*>(base + Layout<TBC, WC>::kBC + Layout<TBC, WC>::kX)) {}
};

// stages tile ``tile`` of one chunk: rows tile*64.. of bc (L, N) and x (L,
// P), and a; rows past L and columns past N, P are zeros (in vec mode the
// columns past N and P were zeroed once, cp.async never writes them)
template <typename TBC, int WC>
__device__ __forceinline__ void stage_set(const Tiles<TBC, WC>& d, const TBC* bc, const float* x,
                                          const float* a, int tile, int L, int N, int P,
                                          bool vec) {
  using Lay = Layout<TBC, WC>;
  const int r0 = tile * kT;
  stage_tile<kThreads>(d.bc, Lay::kLdb, bc + (long long)r0 * N, N, L - r0, N, kT,
                       vec ? N : Lay::kW, vec);
  stage_tile<kThreads>(d.x, Lay::kLdx, x + (long long)r0 * P, P, L - r0, P, kT,
                       vec ? P : Lay::kW, vec);
  stage_tile<kThreads>(d.a, kT, a + r0, 0, 1, L - r0, 1, kT, vec);
}

// zeros the columns past N and P of a tile set, which cp.async never writes
template <typename TBC, int WC>
__device__ __forceinline__ void zero_pad(const Tiles<TBC, WC>& d, int N, int P) {
  using Lay = Layout<TBC, WC>;
  for (int e = threadIdx.x; e < kT * (Lay::kW - N); e += kThreads)
    d.bc[(e / (Lay::kW - N)) * Lay::kLdb + N + e % (Lay::kW - N)] = TBC(0.f);
  for (int e = threadIdx.x; e < kT * (Lay::kW - P); e += kThreads)
    d.x[(e / (Lay::kW - P)) * Lay::kLdx + P + e % (Lay::kW - P)] = 0.f;
}

// The state terms of the warp's keys 16w + g + 8h of a key tile (staged
// B_J, x_J, a_J starting at key j0): (B dS)_j over P into bds, and w_j dw_j,
// dw_j = x_j . (B dS)_j, summed over the lane's quad in a fixed tree
template <typename TBC, int WC>
__device__ __forceinline__ void state_bds(float (&bds)[8 * WC][4], float (&w_)[2],
                                          float (&wdw)[2], const Tiles<TBC, WC>& s,
                                          const float* dsb, int n8, int j0, int L, float a_last,
                                          int w, int g, int t) {
  using Lay = Layout<TBC, WC>;
  ab<8 * WC, TBC>(bds, s.bc, Lay::kLdb, dsb, Lay::kLdx, n8, w, g, t);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kl = 16 * w + g + 8 * h;
    const float* xr = s.x + kl * Lay::kLdx + 2 * t;
    float dw = 0.f;
#pragma unroll
    for (int pn = 0; pn < 8 * WC; ++pn) {
      dw = fmaf(xr[8 * pn], bds[pn][2 * h], dw);
      dw = fmaf(xr[8 * pn + 1], bds[pn][2 * h + 1], dw);
    }
    dw += __shfl_xor_sync(0xffffffffu, dw, 1);
    dw += __shfl_xor_sync(0xffffffffu, dw, 2);
    w_[h] = expf(j0 + kl < L ? a_last - s.a[kl] : -INFINITY);
    wdw[h] = w_[h] * dw;
  }
}

// the lanes' x summed over the warp in a fixed tree: x is the same on the
// four lanes of a quad, so the sum runs over the eight quads
__device__ __forceinline__ float quad_total(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 8);
  x += __shfl_xor_sync(0xffffffffu, x, 16);
  return x;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// dx_J, dB_J and da_J (the column sums and the state terms) of key tile J
template <typename TBC, int WC>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_bwd_cols_kernel(const float* __restrict__ x, const float* __restrict__ acum,
                        const TBC* __restrict__ bm, const TBC* __restrict__ cm,
                        const float* __restrict__ dy, const float* __restrict__ ds,
                        float* __restrict__ dx, float* __restrict__ da, TBC* __restrict__ db,
                        int L, int N, int P, int vec) {
  using Lay = Layout<TBC, WC>;
  extern __shared__ __align__(16) unsigned char smem[];
  const long long blk = blockIdx.x;
  const int nt = (L + kT - 1) / kT;
  const int jt = blockIdx.y;  // the key tiles with the most row tiles first
  const int j0 = jt * kT;
  x += blk * L * P;
  dy += blk * L * P;
  dx += blk * L * P;
  acum += blk * L;
  da += blk * L;
  bm += blk * L * N;
  cm += blk * L * N;
  db += blk * L * N;
  ds += blk * N * P;
  const int w = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int n_k = kExact<TBC> ? round16(N) : (N + 7) & ~7;  // the K of the score products
  const int p8 = (P + 7) & ~7, n8 = (N + 7) & ~7;
  const Tiles<TBC, WC> own(smem);
  const auto ring = [&](int s) { return Tiles<TBC, WC>(smem + (1 + s) * Lay::kTile); };
  if (vec) {
    zero_pad(own, N, P);
    zero_pad(ring(0), N, P);
    zero_pad(ring(1), N, P);
  }
  const int n_it = nt - jt;  // row tiles jt .. nt - 1
  stage_set(own, bm, x, acum, jt, L, N, P, vec);
  stage_set(ring(0), cm, dy, acum, jt, L, N, P, vec);
  cp_async_commit();

  float dxa[8 * WC][4], dba[8 * WC][4];
#pragma unroll
  for (int pn = 0; pn < 8 * WC; ++pn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dxa[pn][e] = dba[pn][e] = 0.f;
  float colsum[2] = {0.f, 0.f};
  float aj[2] = {0.f, 0.f};
  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // the pair's copies have landed, and pair it - 1 is done
    if (it + 1 < n_it) stage_set(ring((it + 1) & 1), cm, dy, acum, jt + it + 1, L, N, P, vec);
    cp_async_commit();
    if (it == 0) {
      aj[0] = own.a[16 * w + g];
      aj[1] = own.a[16 * w + g + 8];
    }
    const Tiles<TBC, WC> cur = ring(it & 1);
    const int i0 = (jt + it) * kT;
    // on the diagonal tile the row blocks before the warp's keys are masked
    const int q0 = it == 0 ? 2 * w : 0;
    float gt[8][4], dmt[8][4];  // G^T and dM^T: [q][e] is key 16w + g + 8(e >> 1), row 8q + 2t + (e & 1)
    abt<8, TBC, TBC>(gt, own.bc, Lay::kLdb, cur.bc, Lay::kLdb, n_k, w, g, t, q0, 7);
    abt<8, float, float>(dmt, own.x, Lay::kLdx, cur.x, Lay::kLdx, p8, w, g, t, q0, 7);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = 16 * w + g + 8 * (e >> 1), il = 8 * q + 2 * t + (e & 1);
        // the decay only on and below the diagonal and above L: exp(-inf) = 0
        const bool in = i0 + il < L && j0 + kl <= i0 + il;
        const float d = expf(in ? cur.a[il] - aj[e >> 1] : -INFINITY);
        const float dg = __fmul_rn(dmt[q][e], d);
        colsum[e >> 1] += dg * gt[q][e];
        dmt[q][e] = dg;
        gt[q][e] = __fmul_rn(gt[q][e], d);
      }
    }
    rab<8 * WC, float>(dxa, gt, cur.x, Lay::kLdx, g, t, q0, 7);
    rab<8 * WC, TBC>(dba, dmt, cur.bc, Lay::kLdb, g, t, q0, 7);
  }
  cp_async_wait<0>();
  __syncthreads();

  // the state terms: dS (N, P) staged over the ring, [n][p]
  float* dsb = reinterpret_cast<float*>(smem + Lay::kTile);
  for (int e = threadIdx.x; e < Lay::kW * Lay::kW; e += kThreads) {
    const int n = e / Lay::kW, p = e % Lay::kW;
    dsb[n * Lay::kLdx + p] = n < N && p < P ? ds[n * P + p] : 0.f;
  }
  __syncthreads();
  const float a_last = acum[L - 1];
  float bds[8 * WC][4], xds[8 * WC][4], wj[2], wdw[2];
  state_bds(bds, wj, wdw, own, dsb, n8, j0, L, a_last, w, g, t);
  abt<8 * WC, float, float>(xds, own.x, Lay::kLdx, dsb, Lay::kLdx, p8, w, g, t, 0, 8 * WC - 1);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    colsum[h] += __shfl_xor_sync(0xffffffffu, colsum[h], 1);
    colsum[h] += __shfl_xor_sync(0xffffffffu, colsum[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = j0 + 16 * w + g + 8 * h;
    if (j >= L) continue;
#pragma unroll
    for (int pn = 0; pn < 8 * WC; ++pn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * pn + 2 * t + e;
        if (col < P) dx[(long long)j * P + col] = dxa[pn][2 * h + e] + wj[h] * bds[pn][2 * h + e];
        if (col < N) store(&db[(long long)j * N + col], dba[pn][2 * h + e] + wj[h] * xds[pn][2 * h + e]);
      }
    if (t == 0 && j != L - 1) da[j] = -colsum[h] - wdw[h];
  }
  if (jt != nt - 1) return;

  // the chunk's last key tile: da_{L-1} also takes sum_j w_j dw_j, the
  // other key tiles' terms formed here as their own CTAs form them, in
  // tile order, then this tile's
  float total = 0.f;
  for (int kt = 0; kt < nt - 1; ++kt) {
    __syncthreads();  // every warp is done with the staged key tile
    stage_set(own, bm, x, acum, kt, L, N, P, vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float obds[8 * WC][4], ow[2], owdw[2];
    state_bds(obds, ow, owdw, own, dsb, n8, kt * kT, L, a_last, w, g, t);
    total += quad_total(owdw[0] + owdw[1]);
  }
  total += quad_total(wdw[0] + wdw[1]);
  __shared__ float red[kThreads / 32];
  if (threadIdx.x % 32 == 0) red[w] = total;
  __syncthreads();
  const int kl_last = (L - 1) - j0;  // key L - 1: warp kl_last / 16, row g + 8h
  if (threadIdx.x == 32 * (kl_last / 16) + 4 * (kl_last % 8)) {
    float s = 0.f;
    for (int i = 0; i < kThreads / 32; ++i) s += red[i];
    da[L - 1] = -colsum[(kl_last % 16) / 8] - wdw[(kl_last % 16) / 8] + s;
  }
}

// dC_I and the row sums of da of row tile I, added to the cols kernel's da
template <typename TBC, int WC>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_bwd_rows_kernel(const float* __restrict__ x, const float* __restrict__ acum,
                        const TBC* __restrict__ bm, const TBC* __restrict__ cm,
                        const float* __restrict__ dy, float* __restrict__ da,
                        TBC* __restrict__ dc, int L, int N, int P, int vec) {
  using Lay = Layout<TBC, WC>;
  extern __shared__ __align__(16) unsigned char smem[];
  const long long blk = blockIdx.x;
  const int nt = (L + kT - 1) / kT;
  const int it_ = nt - 1 - (int)blockIdx.y;  // the row tiles with the most key tiles first
  const int i0 = it_ * kT;
  x += blk * L * P;
  dy += blk * L * P;
  acum += blk * L;
  da += blk * L;
  bm += blk * L * N;
  cm += blk * L * N;
  dc += blk * L * N;
  const int w = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int n_k = kExact<TBC> ? round16(N) : (N + 7) & ~7;
  const int p8 = (P + 7) & ~7;
  const Tiles<TBC, WC> own(smem);
  const auto ring = [&](int s) { return Tiles<TBC, WC>(smem + (1 + s) * Lay::kTile); };
  if (vec) {
    zero_pad(own, N, P);
    zero_pad(ring(0), N, P);
    zero_pad(ring(1), N, P);
  }
  const int n_it = it_ + 1;  // key tiles 0 .. it_
  stage_set(own, cm, dy, acum, it_, L, N, P, vec);
  stage_set(ring(0), bm, x, acum, 0, L, N, P, vec);
  cp_async_commit();

  float dca[8 * WC][4];
#pragma unroll
  for (int pn = 0; pn < 8 * WC; ++pn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dca[pn][e] = 0.f;
  float rowsum[2] = {0.f, 0.f};
  float ai[2] = {0.f, 0.f};
  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_it) stage_set(ring((it + 1) & 1), bm, x, acum, it + 1, L, N, P, vec);
    cp_async_commit();
    if (it == 0) {
      ai[0] = own.a[16 * w + g];
      ai[1] = own.a[16 * w + g + 8];
    }
    const Tiles<TBC, WC> cur = ring(it & 1);
    const int j0 = it * kT;
    // on the diagonal tile the key blocks after the warp's rows are masked
    const int q1 = it == it_ ? 2 * w + 1 : 7;
    float gg[8][4], dm[8][4];  // G and dM: [q][e] is row 16w + g + 8(e >> 1), key 8q + 2t + (e & 1)
    abt<8, TBC, TBC>(gg, own.bc, Lay::kLdb, cur.bc, Lay::kLdb, n_k, w, g, t, 0, q1);
    abt<8, float, float>(dm, own.x, Lay::kLdx, cur.x, Lay::kLdx, p8, w, g, t, 0, q1);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int il = 16 * w + g + 8 * (e >> 1), kl = 8 * q + 2 * t + (e & 1);
        const bool in = i0 + il < L && j0 + kl <= i0 + il;
        const float d = expf(in ? ai[e >> 1] - cur.a[kl] : -INFINITY);
        const float dg = __fmul_rn(dm[q][e], d);
        rowsum[e >> 1] += dg * gg[q][e];
        dm[q][e] = dg;
      }
    }
    rab<8 * WC, TBC>(dca, dm, cur.bc, Lay::kLdb, g, t, 0, q1);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rowsum[h] += __shfl_xor_sync(0xffffffffu, rowsum[h], 1);
    rowsum[h] += __shfl_xor_sync(0xffffffffu, rowsum[h], 2);
    const int i = i0 + 16 * w + g + 8 * h;
    if (i >= L) continue;
#pragma unroll
    for (int pn = 0; pn < 8 * WC; ++pn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * pn + 2 * t + e;
        if (col < N) store(&dc[(long long)i * N + col], dca[pn][2 * h + e]);
      }
    if (t == 0) da[i] += rowsum[h];
  }
}

template <typename TBC, int WC>
int launch(const float* x, const float* a, const void* b, const void* c, const float* dy,
           const float* ds, float* dx, float* da, void* db, void* dc, long long n_blocks, int L,
           int N, int P, bool vec, cudaStream_t st) {
  constexpr size_t smem = Layout<TBC, WC>::kTotal;
  auto k1 = ssd_bwd_cols_kernel<TBC, WC>;
  auto k2 = ssd_bwd_rows_kernel<TBC, WC>;
  cudaError_t err = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)n_blocks, (unsigned)((L + kT - 1) / kT));
  const TBC *bp = static_cast<const TBC*>(b), *cp = static_cast<const TBC*>(c);
  k1<<<grid, kThreads, smem, st>>>(x, a, bp, cp, dy, ds, dx, da, static_cast<TBC*>(db), L, N, P,
                                   vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k2<<<grid, kThreads, smem, st>>>(x, a, bp, cp, dy, da, static_cast<TBC*>(dc), L, N, P, vec);
  return (int)cudaGetLastError();
}

template <typename TBC>
int dispatch(const float* x, const float* a, const void* b, const void* c, const float* dy,
             const float* ds, float* dx, float* da, void* db, void* dc, long long n_blocks,
             int L, int N, int P, cudaStream_t st) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  // every row of every tile copies in whole 16-byte pieces
  const bool vec = (N * (int)sizeof(TBC)) % 16 == 0 && P % 4 == 0 && L % 4 == 0 &&
                   aligned(x) && aligned(a) && aligned(b) && aligned(c) && aligned(dy);
  if (N <= 64 && P <= 64)
    return launch<TBC, 1>(x, a, b, c, dy, ds, dx, da, db, dc, n_blocks, L, N, P, vec, st);
  return launch<TBC, 2>(x, a, b, c, dy, ds, dx, da, db, dc, n_blocks, L, N, P, vec, st);
}

}  // namespace

// The gradients of ssd_chunk_launch's y (BH*C, L, P) and S (BH*C, N, P) for
// x (BH*C, L, P) f32, a (BH*C, L) f32, b and c (BH*C, L, N) f32 (bc_bf16 =
// 0) or bf16 (bc_bf16 = 1), given dy and ds (f32, their shapes): dx (f32),
// da (f32), db and dc (b's dtype), every tensor contiguous. Two kernels on
// ``stream``, each with one CTA per (bh, chunk, 64-row tile): the key
// tiles' dx, dB and da, then the row tiles' dC, added into da. Returns
// cudaGetLastError().
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
