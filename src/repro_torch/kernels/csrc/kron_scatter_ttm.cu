// Fused core update G = U^T Y_(n), Y rebuilt from the nonzeros and never
// stored, for sm_90a, reading the factor rows through the schedule.
//
// Replaces: src/repro/kernels/kron_kernel.py :: fused_kron_scatter_ttm_pallas
// (_mega_kernel via _mega_call), the TPU kernel that streams the
// schedule-ordered nonzeros, rebuilds each row block of
//     Y_(n)[row(t)] += v[t] * (a[t] (x) b[t])      (Rb fastest, K = Ra*Rb)
// in VMEM scratch, and at each row block's last nnz block adds
// U[rows]^T Y[rows] into one (R, K) accumulator that stays resident across
// the whole sequential grid.
//
// What bounds it on this card: bytes, as for csrc/kron_scatter.cu. Per slot
// it reads 16 B from device memory (two int32 coordinates, the value, the
// row offset): 1.2 GB at NELL-2 size (76.9 M slots, K = 256), 0.37 ms at
// 3.35 TB/s. Besides, it reads U once (R floats a row) and the factor
// matrices (0.6-1.8 MB, resident in L2), and writes only the (R, K) core and
// the CTAs' (R, K) partials (~4 MB). Its 3*K operations a slot take ~0.12 ms
// at the TF32 tensor-core rate; the contraction adds 2*R*K a visited row.
//
// Design.
//   * Y's rows come from the walk of kron_walk.cuh, kernel 1's: the factor
//     rows gathered through the schedule into each warp's shared-memory ring
//     (no gathered (nnz, R) operand), the products on the tensor cores, one
//     warp per row-aligned range. Its row end contracts the row instead of
//     storing it, so Y_(n) never reaches device memory.
//   * CTAs run in no order, so nothing carries across them the way the TPU
//     grid carries its accumulator. The grid is bounded by what the card
//     holds at once (kron_scatter_ttm_grid); CTA x takes a contiguous run of
//     the ranges of sparse/layout.py::row_parts and its warps take them in
//     turn, so every row lies in one warp of one CTA. A partial per range or
//     per warp would not fit (NELL-2's last mode has 28,818 ranges of about
//     one row, 16 KB each at ranks 16): the partial belongs to the CTA. At
//     the end the CTA writes it to part[x], and a second kernel sums the
//     partials in CTA order.
//   * The CTA's partial (R x the column block's 256 columns) lives in shared
//     memory, cut by columns: warp w owns the n8 column tiles w, w + W, ...,
//     as mma.sync accumulator fragments. A finished row (the warp's y, 1 KB
//     at ranks 16 in f32, and U[row]) goes into one of the warp's kDepth
//     slots. Round j takes the j-th finished row of every warp, in warp
//     order, as one m16n8k8 k-step: G[:, own tiles] += U_j^T (R x 8 warps)
//     Y_j (8 warps x columns), the A fragment U_j^T (rows are U's columns, k
//     the warps' held rows), the B fragment the held rows' columns. Every
//     warp takes every round for its own columns as soon as all warps have
//     published their j-th row or finished, and a slot is reused once every
//     warp has taken its round. The order of every sum is fixed by the data
//     alone: the same bits on every call, no atomics, and after the start no
//     CTA barrier, only per-warp counters in shared memory.
//   * A warp polls the counters after each chunk and waits only when it runs
//     kDepth rows ahead of the slowest warp of its CTA. Rows of similar
//     length (uniform coordinates) keep the warps in step; a heavily skewed
//     mode would make fast warps wait.
//   * Every route's walk hands the row end the same accumulator fragments;
//     the routes differ in their element type T (of the factors and U) and
//     sum type V:
//       - fp32 (T = V = float): the walk in 3xTF32; each round's product in
//         3xTF32 (U and Y both split), started from zero and added to the
//         partial with f32 adds. The ring (64 KB for 8 warps at ranks 16),
//         the partial (16 KB) and the held rows (18 KB) leave two CTAs of 8
//         warps an SM, against kernel 1's three.
//       - bf16_fp32acc (T = bf16, V = float): the walk on bf16 m16n8k16
//         (A the bf16 rows, B v b split into bf16 hi + lo); each term a*b*v
//         to ~2^-16, where the TPU kernel and the plain version round a*b to
//         bf16 before the scale (up to 2^-8 of the term): the card gives up
//         that rounding on purpose, as kernel 1 does, so the fused and the
//         split core updates sum the same terms. U arrives as bf16 (the TPU
//         kernel rounds U to bf16 as well), exact in TF32, so each round
//         takes two products a tile, U_j^T Y_lo + U_j^T Y_hi with Y split
//         into two TF32 parts, in f32.
//       - float64 (T = V = double): the walk on DMMA (mma.sync m16n8k8
//         .f64, each term fma(round(v a), b, acc)), U, the held rows and the
//         partial in f64, and each round one m16n8k8 .f64 product a tile
//         accumulated straight into the partial (its C operand loaded from
//         shared memory and stored back). At ranks 16 the partial is 16 x
//         256 x 8 = 32 KB; with the f64 ring (16 KB a warp) and the held rows
//         one CTA of 8 warps fits an SM (~195 KB). Its 2K + Ra operations a
//         slot and 2 R K a visited row take ~0.6 ms at NELL-2's last mode at
//         the card's f64 peak (67 TFLOP/s).
//     The reduce kernel sums the partials in V, in the same fixed order.
// Padding slots alias row 0 of their group with value 0; the walk never
// starts or ends a row on them, so no row is contracted twice, wherever the
// range cuts fall; rows no slot reaches add nothing.
#include <climits>
#include <type_traits>

#include "kron_walk.cuh"

namespace {

using kwalk::kBlockCols;
using kwalk::kFull;
using kwalk::kSlots;
using kwalk::kStages;
using kwalk::kWarps;
using tc::mma_f64;
using tc::mma_tf32;
using tc::split;

constexpr int kDepth = 2;                  // finished rows a warp holds, at most
constexpr int kColTiles = kBlockCols / 8;  // n8 column tiles of the partial
constexpr unsigned kDone = 1u << 31;       // a warp's count with this bit: it has finished
constexpr int kReduceWarps = 8;            // warps per CTA of the second pass

// Strides (elements) of a held row's y and of its U, by the bytes ev of a
// sum: kBlockCols + 8 and rp + 8 floats; kBlockCols + 2 and rp + 2 doubles,
// so that a round's f64 fragment loads (rows k = t of 8-byte words, served
// as two half-warps) find rows 2 ys apart on bank pairs 4 apart: the 16
// lanes of a half-warp on 16 different pairs.
__host__ __device__ inline int y_stride(int ev) { return kBlockCols + (ev == 8 ? 2 : 8); }
__host__ __device__ inline int u_stride(int rp, int ev) { return rp + (ev == 8 ? 2 : 8); }

// Byte offsets of one first-pass CTA's shared memory, for nw warps and R
// padded to rp (a multiple of 16), with ev-byte sums (4 f32, 8 f64): the
// warps' rings, their partials, their held rows' y and U, and the counters.
struct Smem {
  size_t g, y, u, ctl, total;
  int g_elems;  // one warp's partial: (rp / 16) m16 tiles x its n8 tiles, 128 each
  __host__ __device__ Smem(int nw, int rp, size_t ring_per_warp, int ev) {
    g_elems = (rp / 16) * ((kColTiles + nw - 1) / nw) * 128;
    g = (size_t)nw * ring_per_warp;
    y = g + (size_t)nw * g_elems * ev;
    u = y + (size_t)nw * kDepth * y_stride(ev) * ev;
    ctl = u + (size_t)nw * kDepth * u_stride(rp, ev) * ev;
    total = ctl + 2 * kWarps * sizeof(int);
  }
};

// U's entries as the rounds read them: f32 (bf16 widened exactly), or f64
__device__ __forceinline__ float held(float x) { return x; }
__device__ __forceinline__ float held(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ double held(double x) { return x; }
// two neighbouring entries of a held row (8- or 16-byte aligned)
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(double* p, double x, double y) {
  *reinterpret_cast<double2*>(p) = make_double2(x, y);
}

// The launch variants by operand code: 0 f32 (3xTF32), 1 bf16 (bf16
// m16n8k16, rounds in 2xTF32), 2 f64 (DMMA); the bytes of a staged element
// and of a sum (V, the values' type and every sum's).
inline int elem_of(int kind) { return kind == 1 ? 2 : kind == 2 ? 8 : 4; }
inline int sum_bytes_of(int kind) { return kind == 2 ? 8 : 4; }

// Two CTAs an SM in f32 and bf16; the f64 CTA (~195 KB at ranks 16) fits
// one, so its registers are not capped for a second
template <typename T, typename V>
__global__ void __launch_bounds__(kWarps * 32, std::is_same<V, double>::value ? 1 : 2)
    kron_scatter_ttm_kernel(const T* __restrict__ fa, const T* __restrict__ fb,
                            const int* __restrict__ idx, const V* __restrict__ vals,
                            const int* __restrict__ rel, const int* __restrict__ blkmap,
                            const long long* __restrict__ parts, const T* __restrict__ u,
                            V* __restrict__ part, int n_parts, int per_cta, int r,
                            const kwalk::Shape sh) {
  constexpr bool kF64 = std::is_same<V, double>::value;
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, nw = blockDim.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int rp = (r + 15) / 16 * 16, n_mt = rp / 16;
  const int ys = y_stride(sizeof(V)), us = u_stride(rp, sizeof(V));
  const int stage_elems = kSlots * (sh.sla + sh.slb);
  const Smem L(nw, rp, (size_t)kStages * stage_elems * sizeof(T), (int)sizeof(V));
  T* ring = reinterpret_cast<T*>(smem_raw) + (size_t)warp * kStages * stage_elems;
  V* gs = reinterpret_cast<V*>(smem_raw + L.g) + (size_t)warp * L.g_elems + lane;
  V* held_y = reinterpret_cast<V*>(smem_raw + L.y);  // [nw][kDepth][ys]
  V* held_u = reinterpret_cast<V*>(smem_raw + L.u);  // [nw][kDepth][us]
  // state[w]: rows warp w has published, | kDone once it has finished;
  // taken[w]: rounds warp w has taken
  volatile unsigned* state = reinterpret_cast<unsigned*>(smem_raw + L.ctl);
  volatile int* taken = reinterpret_cast<int*>(smem_raw + L.ctl) + kWarps;
  if (threadIdx.x < kWarps) state[threadIdx.x] = 0u, taken[threadIdx.x] = 0;
  kwalk::zero_ring(ring, kStages * stage_elems, lane);
  const int n_nt = (kColTiles - warp + nw - 1) / nw;  // this warp's column tiles
  for (int e = 0; e < n_mt * n_nt * 4; ++e) gs[e * 32] = V(0);
  __syncthreads();  // the counters are set

  // Take every round that all warps have published: G[:, own tiles] +=
  // U_j^T Y_j for j = took, ... Returns true once every warp has finished
  // and this warp has taken every round.
  int pub = 0, took = 0;  // rows this warp has published, rounds it has taken
  auto take = [&]() -> bool {
    const unsigned s = lane < nw ? (unsigned)state[lane] : kDone;
    const unsigned cnt = s & ~kDone;
    const unsigned lim = __reduce_min_sync(kFull, (s & kDone) ? UINT_MAX : cnt);
    const int total = (int)__reduce_max_sync(kFull, cnt);
    const int upto = lim == UINT_MAX ? total : (int)lim;
    if (took < upto) {
      __threadfence_block();  // the held rows are read after the counts
      __syncwarp();
      for (; took < upto; ++took) {
        const int slot = took % kDepth;
        // rows published by the warps whose rows are k = t and k = t + 4
        // (0 past the CTA's warps, whose slots are then not read: v0, v1
        // keep the addresses inside the slots all the same)
        const int c0 = __shfl_sync(kFull, (int)cnt, t), c1 = __shfl_sync(kFull, (int)cnt, t + 4);
        const int v0 = min(t, nw - 1), v1 = min(t + 4, nw - 1);
        const bool in0 = took < c0, in1 = took < c1;
        const V* y0 = held_y + (v0 * kDepth + slot) * ys;
        const V* y1 = held_y + (v1 * kDepth + slot) * ys;
        const V* u0 = held_u + (v0 * kDepth + slot) * us;
        const V* u1 = held_u + (v1 * kDepth + slot) * us;
        for (int mt = 0; mt < n_mt; ++mt) {
          // A = U_j^T: rows are U's columns, k the warps
          const V a0 = in0 ? u0[16 * mt + g] : V(0), a1 = in0 ? u0[16 * mt + g + 8] : V(0);
          const V a2 = in1 ? u1[16 * mt + g] : V(0), a3 = in1 ? u1[16 * mt + g + 8] : V(0);
          if constexpr (kF64) {
            // one DMMA a tile, accumulated straight into the partial
            const double a[4] = {a0, a1, a2, a3};
            for (int q = 0; q < n_nt; ++q) {
              const int col = 8 * (warp + q * nw) + g;
              const double b[2] = {in0 ? y0[col] : 0.0, in1 ? y1[col] : 0.0};
              double* gp = gs + (size_t)(mt * n_nt + q) * 128;
              double d[4] = {gp[0], gp[32], gp[64], gp[96]};
              mma_f64(d, a, b);
#pragma unroll
              for (int e = 0; e < 4; ++e) gp[e * 32] = d[e];
            }
          } else {
            // bf16_fp32acc: U is bf16, exact in TF32, so A is not split
            uint32_t ah[4], al[4];
            if constexpr (kBf16) {
              ah[0] = __float_as_uint(a0), ah[1] = __float_as_uint(a1);
              ah[2] = __float_as_uint(a2), ah[3] = __float_as_uint(a3);
            } else {
              split(a0, ah[0], al[0]), split(a1, ah[1], al[1]);
              split(a2, ah[2], al[2]), split(a3, ah[3], al[3]);
            }
            for (int q = 0; q < n_nt; ++q) {
              const int col = 8 * (warp + q * nw) + g;
              uint32_t bh[2], bl[2];
              split(in0 ? y0[col] : 0.f, bh[0], bl[0]);
              split(in1 ? y1[col] : 0.f, bh[1], bl[1]);
              float d[4] = {0.f, 0.f, 0.f, 0.f};
              if constexpr (!kBf16) mma_tf32(d, al, bh);
              mma_tf32(d, ah, bl);
              mma_tf32(d, ah, bh);
              float* gp = gs + (size_t)(mt * n_nt + q) * 128;
#pragma unroll
              for (int e = 0; e < 4; ++e) gp[e * 32] = __fadd_rn(gp[e * 32], d[e]);
            }
          }
        }
      }
      __threadfence_block();  // the held rows were read before the count says so
      __syncwarp();
      if (lane == 0) taken[warp] = took;
    }
    return lim == UINT_MAX && took == total;
  };

  // Hold a finished row: wait for a free slot (every warp has taken round
  // pub - kDepth), write the warp's y and U[row] into it, publish it.
  const int by = blockIdx.y;
  auto hold_row = [&](int row, const typename kwalk::Tile<V>::Acc& acc) {
    while (true) {
      if (__reduce_min_sync(kFull, lane < nw ? (int)taken[lane] : INT_MAX) > pub - kDepth) break;
      if (!take()) __nanosleep(64);
    }
    __threadfence_block();
    __syncwarp();
    const int slot = pub % kDepth;
    V* y = held_y + (warp * kDepth + slot) * ys;
    V* uh = held_u + (warp * kDepth + slot) * us;
    // acc[q][e] is local column 16 (g + 8 (e >> 1)) + 8 q + 2 t + (e & 1)
#pragma unroll
    for (int q = 0; q < kwalk::kNT; ++q) {
      store2(y + 16 * g + 8 * q + 2 * t, acc[q][0], acc[q][1]);
      store2(y + 16 * (g + 8) + 8 * q + 2 * t, acc[q][2], acc[q][3]);
    }
    for (int q = lane; q < rp; q += 32) uh[q] = q < r ? held(u[(long long)row * r + q]) : V(0);
    __threadfence_block();
    __syncwarp();
    ++pub;
    if (lane == 0) state[warp] = (unsigned)pub;
  };

  const kwalk::Tile<V> tile(sh.ra, sh.rb, by);
  const int first = blockIdx.x * per_cta, last = min(first + per_cta, n_parts);
  for (int p = first + warp; p < last; p += nw)
    kwalk::walk<T>(fa, fb, idx, vals, rel, blkmap, sh, parts[p], parts[p + 1], ring, tile, lane,
                   hold_row, [&] { take(); });
  if (lane == 0) state[warp] = (unsigned)pub | kDone;
  while (!take()) __nanosleep(64);

  // this warp's columns of the partial into part[blockIdx.x] (R, K)
  const long long k_cols = (long long)sh.ra * sh.rb;
  V* out = part + (long long)blockIdx.x * r * k_cols;
  for (int mt = 0; mt < n_mt; ++mt)
    for (int q = 0; q < n_nt; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * mt + g + 8 * (e >> 1);
        int i, j;
        if (row < r &&
            kwalk::Tile<V>::column(8 * (warp + q * nw) + 2 * t + (e & 1), sh.ra, sh.rb, by, i, j))
          out[row * k_cols + (long long)i * sh.rb + j] = gs[((mt * n_nt + q) * 4 + e) * 32];
      }
}

// out[e] = sum over c in order of part[c][e]: warp w sums c = w, w + 8, ...
// for 32 consecutive outputs, then warp 0 adds the eight warp sums in order
// (V: f32, or f64 on the f64 route).
template <typename V>
__global__ void __launch_bounds__(32 * kReduceWarps)
    kron_scatter_ttm_reduce_kernel(const V* __restrict__ part, V* __restrict__ out,
                                   int n_ctas, long long n_out) {
  __shared__ V ws[kReduceWarps][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long e = (long long)blockIdx.x * 32 + lane;
  V s = V(0);
  if (e < n_out)
    for (int c = w; c < n_ctas; c += kReduceWarps) s += part[c * n_out + e];
  ws[w][lane] = s;
  __syncthreads();
  if (w == 0 && e < n_out) {
    V t = ws[0][lane];
    for (int q = 1; q < kReduceWarps; ++q) t += ws[q][lane];
    out[e] = t;
  }
}

// The first pass's launch shape at these sizes for operand code kind: the
// staged strides in sh, the warps of a CTA (as many as fit, at most kWarps)
// and its shared memory. Returns false when not one warp fits.
bool shape_of(int ra, int rb, int lda, int ldb, int r, int kind, kwalk::Shape* sh, int* warps,
              size_t* smem) {
  kwalk::staged_strides(ra, rb, lda, ldb, &sh->sla, &sh->slb);
  int dev = 0, smem_max = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t ring = (size_t)kStages * kSlots * (sh->sla + sh->slb) * elem_of(kind);
  const int rp = (r + 15) / 16 * 16;
  for (int nw = kWarps; nw >= 1; --nw) {
    const Smem L(nw, rp, ring, sum_bytes_of(kind));
    if (L.total <= (size_t)smem_max) {
      *warps = nw;
      *smem = L.total;
      return true;
    }
  }
  return false;
}

template <typename T, typename V>
int allow_smem(size_t smem) {
  return (int)cudaFuncSetAttribute(kron_scatter_ttm_kernel<T, V>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The CTAs an SM holds at `threads` threads and `smem` bytes, and the
// kernel's registers a thread.
template <typename T, typename V>
int occupancy(int threads, size_t smem, int* per_sm, int* regs) {
  cudaFuncAttributes attr{};
  int rc = (int)cudaFuncGetAttributes(&attr, kron_scatter_ttm_kernel<T, V>);
  *regs = attr.numRegs;
  if (rc == 0) rc = allow_smem<T, V>(smem);
  if (rc != 0) return rc;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, kron_scatter_ttm_kernel<T, V>, threads, smem);
}

// Both passes of one variant: the first into part, then the reduce into
// out. Returns cudaGetLastError() after the launches.
template <typename T, typename V>
int launch(const void* fa, const void* fb, const int* ip, const void* vp, const int* relp,
           const int* blk, const long long* pp, const void* u, void* part, void* out,
           int n_parts, int per_cta, int r, const kwalk::Shape& sh, int warps, size_t smem,
           cudaStream_t st) {
  int rc;
  if ((rc = allow_smem<T, V>(smem)) != 0) return rc;
  const int n_ctas = (n_parts + per_cta - 1) / per_cta;
  const dim3 grid(n_ctas, kwalk::column_blocks(sh.ra, sh.rb));
  V* pt = static_cast<V*>(part);
  kron_scatter_ttm_kernel<T, V><<<grid, warps * 32, smem, st>>>(
      static_cast<const T*>(fa), static_cast<const T*>(fb), ip, static_cast<const V*>(vp),
      relp, blk, pp, static_cast<const T*>(u), pt, n_parts, per_cta, r, sh);
  if ((rc = (int)cudaGetLastError()) != 0) return rc;
  const long long n_out = (long long)r * sh.ra * sh.rb;
  kron_scatter_ttm_reduce_kernel<V><<<(unsigned)((n_out + 31) / 32), 32 * kReduceWarps, 0,
                                      st>>>(pt, static_cast<V*>(out), n_ctas, n_out);
  return (int)cudaGetLastError();
}

}  // namespace

// The first pass's grid for n_parts row ranges at these sizes on the current
// device (arguments as kron_scatter_ttm_launch takes them): threads per
// CTA, the CTAs one SM holds at once, the CTAs n_ctas (the leading size of
// the scratch buffer part), the ranges per_cta each takes, the shared
// memory smem of one CTA and the kernel's registers a thread. Returns a CUDA
// error code: cudaErrorInvalidValue when the sizes are out of range or no
// CTA fits an SM.
extern "C" int kron_scatter_ttm_grid(int ra, int rb, int lda, int ldb, int r, int kind,
                                     int n_parts, int* threads, int* per_sm, int* n_ctas,
                                     int* per_cta, long long* smem, int* regs) {
  *threads = *per_sm = *n_ctas = *per_cta = *regs = 0;
  *smem = 0;
  kwalk::Shape sh{ra, rb, lda, ldb, 0, 0, 1, 1, 1};
  int warps;
  size_t bytes;
  if (kind < 0 || kind > 2 || r < 1 || n_parts < 1 ||
      !kwalk::shapes_ok(ra, rb, lda, ldb, 1, 1, 1, 16 / elem_of(kind)) ||
      !shape_of(ra, rb, lda, ldb, r, kind, &sh, &warps, &bytes))
    return (int)cudaErrorInvalidValue;
  *threads = warps * 32;
  *smem = (long long)bytes;
  int rc = kind == 1   ? occupancy<__nv_bfloat16, float>(*threads, bytes, per_sm, regs)
           : kind == 2 ? occupancy<double, double>(*threads, bytes, per_sm, regs)
                       : occupancy<float, float>(*threads, bytes, per_sm, regs);
  if (rc != 0) return rc;
  if (*per_sm < 1) return (int)cudaErrorInvalidValue;
  int dev, n_sms;
  if ((rc = (int)cudaGetDevice(&dev)) != 0) return rc;
  if ((rc = (int)cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev)) != 0)
    return rc;
  int ctas = *per_sm * n_sms / kwalk::column_blocks(ra, rb);
  ctas = ctas < 1 ? 1 : (ctas > n_parts ? n_parts : ctas);
  *per_cta = (n_parts + ctas - 1) / ctas;
  *n_ctas = (n_parts + *per_cta - 1) / *per_cta;
  return 0;
}

// out (r, ra*rb) = sum over rows of U[row]^T (x) y[row], y as in
// kron_scatter_launch and with its operands: fa (I_a, lda), fb (I_b, ldb)
// the factor matrices (fb null, rb = 1 and ldb = 0 for a 2-way tensor), idx,
// vals, rel, blkmap and parts the schedule. kind is kron_scatter_launch's
// operand code (0 f32, 1 bf16, 2 f64); u (n_rows, r) is contiguous and of
// fa's type; vals, part and out are f32, f64 for kind = 2. CTA x of
// n_ctas = ceil(n_parts / per_cta) takes ranges
// [x * per_cta, (x + 1) * per_cta), per_cta as kron_scatter_ttm_grid gives
// it; part is an (n_ctas, r, ra*rb) scratch buffer. Returns
// cudaGetLastError() after the two launches.
extern "C" int kron_scatter_ttm_launch(const void* fa, const void* fb, const void* idx,
                                       const void* vals, const void* rel, const void* blkmap,
                                       const void* parts, const void* u, void* part, void* out,
                                       int n_parts, int per_cta, int ra, int rb, int lda,
                                       int ldb, int idx_cols, int bn, int bi, int r, int kind,
                                       void* stream) {
  kwalk::Shape sh{ra, rb, lda, ldb, 0, 0, idx_cols, bn, bi};
  int warps;
  size_t smem;
  if (kind < 0 || kind > 2 || n_parts < 1 || per_cta < 1 || r < 1 ||
      !kwalk::shapes_ok(ra, rb, lda, ldb, idx_cols, bn, bi, 16 / elem_of(kind)) ||
      !shape_of(ra, rb, lda, ldb, r, kind, &sh, &warps, &smem))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ip = static_cast<const int*>(idx);
  const int* relp = static_cast<const int*>(rel);
  const int* blk = static_cast<const int*>(blkmap);
  const long long* pp = static_cast<const long long*>(parts);
  if (kind == 1)
    return launch<__nv_bfloat16, float>(fa, fb, ip, vals, relp, blk, pp, u, part, out, n_parts,
                                        per_cta, r, sh, warps, smem, st);
  if (kind == 2)
    return launch<double, double>(fa, fb, ip, vals, relp, blk, pp, u, part, out, n_parts,
                                  per_cta, r, sh, warps, smem, st);
  return launch<float, float>(fa, fb, ip, vals, relp, blk, pp, u, part, out, n_parts, per_cta,
                              r, sh, warps, smem, st);
}
