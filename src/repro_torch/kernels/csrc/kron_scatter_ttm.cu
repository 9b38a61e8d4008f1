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
//     (no gathered (nnz, R) operand), the fp32 products on mma.sync 3xTF32,
//     one warp per row-aligned range. Its row end contracts the row instead
//     of storing it, so Y_(n) never reaches device memory.
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
//     as mma.sync fragments. A finished row (the warp's y, 1 KB at ranks 16,
//     and U[row]) goes into one of the warp's kDepth slots. Round j takes
//     the j-th finished row of every warp, in warp order, as one m16n8k8
//     k-step: G[:, own tiles] += U_j^T (R x 8 warps) Y_j (8 warps x
//     columns), 3xTF32, each product started from zero and added with f32
//     adds. Every warp takes every round for its own columns as soon as all
//     warps have published their j-th row or finished, and a slot is reused
//     once every warp has taken its round. The order of every sum is fixed
//     by the data alone: the same bits on every call, no atomics, and after
//     the start no CTA barrier, only per-warp counters in shared memory.
//   * A warp polls the counters after each chunk and waits only when it runs
//     kDepth rows ahead of the slowest warp of its CTA. Rows of similar
//     length (uniform coordinates) keep the warps in step; a heavily skewed
//     mode would make fast warps wait.
//   * Occupancy: the ring (64 KB for 8 warps at ranks 16), the partial
//     (16 KB) and the held rows (18 KB) leave two CTAs of 8 warps an SM,
//     against kernel 1's three.
// Padding slots alias row 0 of their group with value 0; the walk never
// starts or ends a row on them, so no row is contracted twice, wherever the
// range cuts fall; rows no slot reaches add nothing. Under bf16_fp32acc a, b
// and U arrive as bf16 (the TPU kernel rounds U to bf16 as well); the Kron
// terms are rounded as kron_common.cuh says, and the contraction is f32
// arithmetic on bf16 values of U (exact in TF32).
#include <climits>

#include "kron_walk.cuh"

namespace {

using kron::to_f32;
using kwalk::kBlockCols;
using kwalk::kFull;
using kwalk::kSlots;
using kwalk::kStages;
using kwalk::kWarps;
using tc::mma_tf32;
using tc::split;

constexpr int kDepth = 2;                  // finished rows a warp holds, at most
constexpr int kYS = kBlockCols + 8;        // floats of a held row: 8 rows of a round on 32 banks
constexpr int kColTiles = kBlockCols / 8;  // n8 column tiles of the partial
constexpr unsigned kDone = 1u << 31;       // a warp's count with this bit: it has finished
constexpr int kReduceWarps = 8;            // warps per CTA of the second pass

// Byte offsets of one first-pass CTA's shared memory, for nw warps and R
// padded to rp (a multiple of 16): the warps' rings, their partials, their
// held rows' y (kYS floats) and U (rp + 8 floats, so that a round's A
// fragment loads fall on 32 banks), and the counters.
struct Smem {
  size_t g, y, u, ctl, total;
  int g_floats;  // one warp's partial: (rp / 16) m16 tiles x its n8 tiles, 128 floats each
  __host__ __device__ Smem(int nw, int rp, size_t ring_per_warp) {
    g_floats = (rp / 16) * ((kColTiles + nw - 1) / nw) * 128;
    g = (size_t)nw * ring_per_warp;
    y = g + (size_t)nw * g_floats * 4;
    u = y + (size_t)nw * kDepth * kYS * 4;
    ctl = u + (size_t)nw * kDepth * (rp + 8) * 4;
    total = ctl + 2 * kWarps * sizeof(int);
  }
};

template <typename T, bool kTC>
__global__ void __launch_bounds__(kWarps * 32, 2)
    kron_scatter_ttm_kernel(const T* __restrict__ fa, const T* __restrict__ fb,
                            const int* __restrict__ idx, const float* __restrict__ vals,
                            const int* __restrict__ rel, const int* __restrict__ blkmap,
                            const long long* __restrict__ parts, const T* __restrict__ u,
                            float* __restrict__ part, int n_parts, int per_cta, int r,
                            const kwalk::Shape sh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, nw = blockDim.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int rp = (r + 15) / 16 * 16, us = rp + 8, n_mt = rp / 16;
  const int stage_elems = kSlots * (sh.sla + sh.slb);
  const Smem L(nw, rp, (size_t)kStages * stage_elems * sizeof(T));
  T* ring = reinterpret_cast<T*>(smem_raw) + (size_t)warp * kStages * stage_elems;
  float* gs = reinterpret_cast<float*>(smem_raw + L.g) + (size_t)warp * L.g_floats + lane;
  float* held_y = reinterpret_cast<float*>(smem_raw + L.y);  // [nw][kDepth][kYS]
  float* held_u = reinterpret_cast<float*>(smem_raw + L.u);  // [nw][kDepth][us]
  // state[w]: rows warp w has published, | kDone once it has finished;
  // taken[w]: rounds warp w has taken
  volatile unsigned* state = reinterpret_cast<unsigned*>(smem_raw + L.ctl);
  volatile int* taken = reinterpret_cast<int*>(smem_raw + L.ctl) + kWarps;
  if (threadIdx.x < kWarps) state[threadIdx.x] = 0u, taken[threadIdx.x] = 0;
  kwalk::zero_ring(ring, kStages * stage_elems, lane);
  const int n_nt = (kColTiles - warp + nw - 1) / nw;  // this warp's column tiles
  for (int e = 0; e < n_mt * n_nt * 4; ++e) gs[e * 32] = 0.f;
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
      // rows published by the warps whose rows are k = t and k = t + 4 (0
      // past the CTA's warps, whose slots are then not read: v0, v1 keep
      // the addresses inside the slots all the same)
      const int c0 = __shfl_sync(kFull, (int)cnt, t), c1 = __shfl_sync(kFull, (int)cnt, t + 4);
      const int v0 = min(t, nw - 1), v1 = min(t + 4, nw - 1);
      for (; took < upto; ++took) {
        const int slot = took % kDepth;
        const bool in0 = took < c0, in1 = took < c1;
        const float* y0 = held_y + (v0 * kDepth + slot) * kYS;
        const float* y1 = held_y + (v1 * kDepth + slot) * kYS;
        const float* u0 = held_u + (v0 * kDepth + slot) * us;
        const float* u1 = held_u + (v1 * kDepth + slot) * us;
        for (int mt = 0; mt < n_mt; ++mt) {
          // A = U_j^T: rows are U's columns, k the warps
          uint32_t ah[4], al[4];
          split(in0 ? u0[16 * mt + g] : 0.f, ah[0], al[0]);
          split(in0 ? u0[16 * mt + g + 8] : 0.f, ah[1], al[1]);
          split(in1 ? u1[16 * mt + g] : 0.f, ah[2], al[2]);
          split(in1 ? u1[16 * mt + g + 8] : 0.f, ah[3], al[3]);
          for (int q = 0; q < n_nt; ++q) {
            const int col = 8 * (warp + q * nw) + g;
            uint32_t bh[2], bl[2];
            split(in0 ? y0[col] : 0.f, bh[0], bl[0]);
            split(in1 ? y1[col] : 0.f, bh[1], bl[1]);
            float d[4] = {0.f, 0.f, 0.f, 0.f};
            mma_tf32(d, al, bh);
            mma_tf32(d, ah, bl);
            mma_tf32(d, ah, bh);
            float* gp = gs + (size_t)(mt * n_nt + q) * 128;
#pragma unroll
            for (int e = 0; e < 4; ++e) gp[e * 32] = __fadd_rn(gp[e * 32], d[e]);
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
  auto hold_row = [&](int row, const typename kwalk::Tile<kTC>::Acc& acc) {
    while (true) {
      if (__reduce_min_sync(kFull, lane < nw ? (int)taken[lane] : INT_MAX) > pub - kDepth) break;
      if (!take()) __nanosleep(64);
    }
    __threadfence_block();
    __syncwarp();
    const int slot = pub % kDepth;
    float* y = held_y + (warp * kDepth + slot) * kYS;
    float* uh = held_u + (warp * kDepth + slot) * us;
    if constexpr (kTC) {
      // acc[q][e] is local column 16 (g + 8 (e >> 1)) + 8 q + 2 t + (e & 1)
#pragma unroll
      for (int q = 0; q < kwalk::kNT; ++q) {
        *reinterpret_cast<float2*>(y + 16 * g + 8 * q + 2 * t) = make_float2(acc[q][0], acc[q][1]);
        *reinterpret_cast<float2*>(y + 16 * (g + 8) + 8 * q + 2 * t) =
            make_float2(acc[q][2], acc[q][3]);
      }
    } else {
      // acc[i][j] is local column 8 lane + 2 i + j
      *reinterpret_cast<float4*>(y + 8 * lane) =
          make_float4(acc[0][0], acc[0][1], acc[1][0], acc[1][1]);
      *reinterpret_cast<float4*>(y + 8 * lane + 4) =
          make_float4(acc[2][0], acc[2][1], acc[3][0], acc[3][1]);
    }
    for (int q = lane; q < rp; q += 32) uh[q] = q < r ? to_f32(u[(long long)row * r + q]) : 0.f;
    __threadfence_block();
    __syncwarp();
    ++pub;
    if (lane == 0) state[warp] = (unsigned)pub;
  };

  const kwalk::Tile<kTC> tile(sh.ra, sh.rb, by, lane);
  const int first = blockIdx.x * per_cta, last = min(first + per_cta, n_parts);
  for (int p = first + warp; p < last; p += nw)
    kwalk::walk<T, kTC>(fa, fb, idx, vals, rel, blkmap, sh, parts[p], parts[p + 1], ring, tile,
                        lane, hold_row, [&] { take(); });
  if (lane == 0) state[warp] = (unsigned)pub | kDone;
  while (!take()) __nanosleep(64);

  // this warp's columns of the partial into part[blockIdx.x] (R, K)
  const long long k_cols = (long long)sh.ra * sh.rb;
  float* out = part + (long long)blockIdx.x * r * k_cols;
  for (int mt = 0; mt < n_mt; ++mt)
    for (int q = 0; q < n_nt; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * mt + g + 8 * (e >> 1);
        int i, j;
        if (row < r &&
            kwalk::Tile<kTC>::column(8 * (warp + q * nw) + 2 * t + (e & 1), sh.ra, sh.rb, by, i, j))
          out[row * k_cols + (long long)i * sh.rb + j] = gs[((mt * n_nt + q) * 4 + e) * 32];
      }
}

// out[e] = sum over c in order of part[c][e]: warp w sums c = w, w + 8, ...
// for 32 consecutive outputs, then warp 0 adds the eight warp sums in order.
__global__ void __launch_bounds__(32 * kReduceWarps)
    kron_scatter_ttm_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                                   int n_ctas, long long n_out) {
  __shared__ float ws[kReduceWarps][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long e = (long long)blockIdx.x * 32 + lane;
  float s = 0.f;
  if (e < n_out)
    for (int c = w; c < n_ctas; c += kReduceWarps) s += part[c * n_out + e];
  ws[w][lane] = s;
  __syncthreads();
  if (w == 0 && e < n_out) {
    float t = ws[0][lane];
    for (int q = 1; q < kReduceWarps; ++q) t += ws[q][lane];
    out[e] = t;
  }
}

// The first pass's launch shape at these sizes: the staged strides in sh,
// the warps of a CTA (as many as fit, at most kWarps) and its shared memory.
// Returns false when not one warp fits.
bool shape_of(int ra, int rb, int lda, int ldb, int r, int bf16, kwalk::Shape* sh, int* warps,
              size_t* smem) {
  kwalk::staged_strides(ra, rb, lda, ldb, !bf16, &sh->sla, &sh->slb);
  int dev = 0, smem_max = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t ring = (size_t)kStages * kSlots * (sh->sla + sh->slb) * (bf16 ? 2 : 4);
  const int rp = (r + 15) / 16 * 16;
  for (int nw = kWarps; nw >= 1; --nw) {
    const Smem L(nw, rp, ring);
    if (L.total <= (size_t)smem_max) {
      *warps = nw;
      *smem = L.total;
      return true;
    }
  }
  return false;
}

template <typename T, bool kTC>
int allow_smem(size_t smem) {
  return (int)cudaFuncSetAttribute(kron_scatter_ttm_kernel<T, kTC>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, bool kTC>
int ctas_per_sm(int threads, size_t smem, int* out) {
  const int rc = allow_smem<T, kTC>(smem);
  if (rc != 0) return rc;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, kron_scatter_ttm_kernel<T, kTC>, threads, smem);
}

}  // namespace

// The first pass's grid for n_parts row ranges at these sizes on the current
// device (arguments as kron_scatter_ttm_launch takes them): threads per
// CTA, the CTAs one SM holds at once, the CTAs n_ctas (the leading size of
// the scratch buffer part), the ranges per_cta each takes, and the shared
// memory smem of one CTA. Returns a CUDA error code: cudaErrorInvalidValue
// when the sizes are out of range or no CTA fits an SM.
extern "C" int kron_scatter_ttm_grid(int ra, int rb, int lda, int ldb, int r, int bf16,
                                     int n_parts, int* threads, int* per_sm, int* n_ctas,
                                     int* per_cta, long long* smem) {
  *threads = *per_sm = *n_ctas = *per_cta = 0;
  *smem = 0;
  kwalk::Shape sh{ra, rb, lda, ldb, 0, 0, 1, 1, 1};
  int warps;
  size_t bytes;
  if (r < 1 || n_parts < 1 || !kwalk::shapes_ok(ra, rb, lda, ldb, 1, 1, 1, bf16 ? 8 : 4) ||
      !shape_of(ra, rb, lda, ldb, r, bf16, &sh, &warps, &bytes))
    return (int)cudaErrorInvalidValue;
  *threads = warps * 32;
  *smem = (long long)bytes;
  int rc = bf16 ? ctas_per_sm<__nv_bfloat16, false>(*threads, bytes, per_sm)
                : ctas_per_sm<float, true>(*threads, bytes, per_sm);
  if (rc != 0) return rc;
  if (*per_sm < 1) return (int)cudaErrorInvalidValue;
  int dev, n_sms;
  if ((rc = (int)cudaGetDevice(&dev)) != 0) return rc;
  if ((rc = (int)cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev)) != 0)
    return rc;
  int ctas = *per_sm * n_sms / kwalk::column_blocks(ra, rb, !bf16);
  ctas = ctas < 1 ? 1 : (ctas > n_parts ? n_parts : ctas);
  *per_cta = (n_parts + ctas - 1) / ctas;
  *n_ctas = (n_parts + *per_cta - 1) / *per_cta;
  return 0;
}

// out (r, ra*rb) f32 = sum over rows of U[row]^T (x) y[row], y as in
// kron_scatter_launch and with its operands: fa (I_a, lda), fb (I_b, ldb)
// the factor matrices (fb null, rb = 1 and ldb = 0 for a 2-way tensor), idx,
// vals, rel, blkmap and parts the schedule. u (n_rows, r) contiguous, f32
// (bf16 = 0) or bf16 (bf16 = 1) like fa and fb. CTA x of
// n_ctas = ceil(n_parts / per_cta) takes ranges
// [x * per_cta, (x + 1) * per_cta), per_cta as kron_scatter_ttm_grid gives
// it; part is an (n_ctas, r, ra*rb) f32 scratch buffer. Returns
// cudaGetLastError() after the two launches.
extern "C" int kron_scatter_ttm_launch(const void* fa, const void* fb, const void* idx,
                                       const void* vals, const void* rel, const void* blkmap,
                                       const void* parts, const void* u, void* part, void* out,
                                       int n_parts, int per_cta, int ra, int rb, int lda,
                                       int ldb, int idx_cols, int bn, int bi, int r, int bf16,
                                       void* stream) {
  kwalk::Shape sh{ra, rb, lda, ldb, 0, 0, idx_cols, bn, bi};
  int warps;
  size_t smem;
  if (n_parts < 1 || per_cta < 1 || r < 1 ||
      !kwalk::shapes_ok(ra, rb, lda, ldb, idx_cols, bn, bi, bf16 ? 8 : 4) ||
      !shape_of(ra, rb, lda, ldb, r, bf16, &sh, &warps, &smem))
    return (int)cudaErrorInvalidValue;
  const int n_ctas = (n_parts + per_cta - 1) / per_cta;
  const dim3 grid(n_ctas, kwalk::column_blocks(ra, rb, !bf16));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ip = static_cast<const int*>(idx);
  const float* vp = static_cast<const float*>(vals);
  const int* relp = static_cast<const int*>(rel);
  const int* blk = static_cast<const int*>(blkmap);
  const long long* pp = static_cast<const long long*>(parts);
  float* pt = static_cast<float*>(part);
  int rc;
  if (bf16) {
    if ((rc = allow_smem<__nv_bfloat16, false>(smem)) != 0) return rc;
    kron_scatter_ttm_kernel<__nv_bfloat16, false><<<grid, warps * 32, smem, st>>>(
        static_cast<const __nv_bfloat16*>(fa), static_cast<const __nv_bfloat16*>(fb), ip, vp,
        relp, blk, pp, static_cast<const __nv_bfloat16*>(u), pt, n_parts, per_cta, r, sh);
  } else {
    if ((rc = allow_smem<float, true>(smem)) != 0) return rc;
    kron_scatter_ttm_kernel<float, true><<<grid, warps * 32, smem, st>>>(
        static_cast<const float*>(fa), static_cast<const float*>(fb), ip, vp, relp, blk, pp,
        static_cast<const float*>(u), pt, n_parts, per_cta, r, sh);
  }
  if ((rc = (int)cudaGetLastError()) != 0) return rc;
  const long long n_out = (long long)r * ra * rb;
  kron_scatter_ttm_reduce_kernel<<<(unsigned)((n_out + 31) / 32), 32 * kReduceWarps, 0, st>>>(
      pt, static_cast<float*>(out), n_ctas, n_out);
  return (int)cudaGetLastError();
}
