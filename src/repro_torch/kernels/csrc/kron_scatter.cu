// Fused Kron-scatter unfolding of one HOOI mode, for sm_90a, reading the
// factor rows through the schedule.
//
// Replaces: src/repro/kernels/kron_kernel.py :: fused_kron_scatter_pallas
// (_fused_kernel via _fused_call), the TPU kernel that computes
//     Y_(n)[row(t)] += v[t] * (a[t] (x) b[t])      (Rb fastest, K = Ra*Rb)
// over the schedule-ordered nonzeros of sparse/layout.py, where a[t] and b[t]
// are rows of the two non-mode factor matrices. Here the kernel takes the
// factor matrices themselves (0.6-1.8 MB at NELL-2 size, resident in L2) and
// the schedule's cached slot coordinates, and gathers each slot's two rows
// itself: no (nnz, R) operand is ever written to device memory.
//
// What bounds it on this card. Per slot it reads 16 B from device memory
// (two int32 coordinates, the value, the row offset): 1.2 GB a mode at
// NELL-2 size (76.9 M slots, K = 256), 0.37 ms at 3.35 TB/s. Its 3*K
// operations a slot (5.9e10) take 0.88 ms at the f32 CUDA-core rate and
// ~0.12 ms at the TF32 tensor-core rate. The gathered rows come from L2:
// 128 B a slot in f32, ~9.8 GB a mode.
//
// Design.
//   * One warp walks one row-aligned range of slots (sparse/layout.py::
//     row_parts: a row never crosses two ranges), summing each row in
//     registers and storing it when the row ends: a deterministic segmented
//     sum, no atomics, the same bits on every call. A slot whose value is 0
//     (the schedule's padding, or an explicit zero) adds nothing, so its
//     row is not looked at. Rows no slot reaches stay as the wrapper's zero
//     fill.
//   * Slots go in chunks of 32, lane l holding slot l's coordinates, value
//     and row (coalesced loads). The chunk's factor rows are copied into the
//     warp's shared memory with cp.async in 16-byte pieces (the wrapper pads
//     the factor rows to 16 bytes), neighbouring lanes taking the pieces of
//     one row, so that an instruction reads whole rows (one lane a row made
//     each instruction touch 32 cache lines). A ring of two chunks: while
//     chunk c is summed, the rows of chunk c+1 are in flight and chunk
//     c+2's coordinates are loading (a third stage cost more in occupancy,
//     two CTAs of 8 warps an SM against three, than it hid, in turns on an
//     H100). Only warp-level synchronisation:
//     the warps of a CTA never wait for each other.
//   * fp32, on the tensor cores. A row of Y is a product over its slots,
//     Y_row = (v a)^T b with the slots as the contraction, so the warp runs
//     it 8 slots at a time with mma.sync m16n8k8 TF32: the A fragment holds
//     v*a (rows of A are a's columns), the B fragment b. Each operand is
//     split into a TF32 high part and a TF32 remainder and the three
//     significant products are summed (3xTF32: ~2^-21 of each term). Each
//     8-slot product starts from zero and is added to the row's running sum
//     with f32 adds, so the tensor core's own accumulation covers 8 terms
//     at a time and the sum over the row is rounded to nearest. The terms
//     differ from the plain version's round(round(a*b)*v) by ~2^-21 relative;
//     over n terms that is ~sqrt(n) 2^-21 of a term, far below the fp32 gate
//     of chip_smoke.py (4 sqrt(n) 2^-24 of max|plain|, where max|plain|
//     grows with sqrt(n) terms). An 8-slot block that holds the end of a row
//     is run once per row it touches, each pass masking the other rows'
//     values to 0. A chunk that lies inside one row (nearly all of them)
//     skips the row logic and runs its four 8-slot blocks unrolled, so that
//     they overlap. A warp owns one m16 x 16 block of the row (ranks 16: all
//     of it), lane (g, t) = (lane / 4, lane % 4) the fragment entries; larger
//     K is tiled over blockIdx.y. The staged rows are unpadded and swizzled
//     (8-column groups XORed by slot) so that fragment loads meet no bank
//     conflict.
//   * bf16_fp32acc, on the CUDA cores: each product a*b is rounded to bf16,
//     then scaled by the f32 value and summed in f32 (kron_common.cuh's
//     kron_term, the plain version's rounding, which the tensor cores cannot
//     reproduce). A lane owns a 4 x 2 register tile of the row: eight terms
//     per slot from one 8-byte and one 4-byte shared load.
#include <algorithm>
#include <cstdint>

#include "kron_common.cuh"
#include "tc_common.cuh"

namespace {

using tc::mma_tf32;
using tc::split;

constexpr int kSlots = 32;  // slots per staged chunk, one per lane
constexpr int kStages = 2;  // staged chunks per warp: one in flight while one is summed
constexpr int kWarps = 8;   // warps per CTA, at most
constexpr int kNT = 2;      // fp32 route: n8 tiles (b columns) a warp, with one m16 tile
constexpr int kTA = 4;      // bf16 route: a columns per lane
constexpr int kTB = 2;      // bf16 route: b columns per lane
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
// all but the newest kStages - 1 groups have landed
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}


__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&x.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&x.y);
  o[0] = __low2float(lo), o[1] = __high2float(lo), o[2] = __low2float(hi),
  o[3] = __high2float(hi);
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float* o) {
  const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(p);
  o[0] = __low2float(x), o[1] = __high2float(x);
}

// The fp32 route's shared-memory swizzle: element c of staged slot s sits at
// column c ^ swz(s), so that the 4 slots x 8 columns of a fragment load fall
// on 32 different banks with unpadded rows (stride sl, a multiple of 16
// words). The XOR moves whole 8-column groups, so 16-byte pieces stay whole.
__device__ __forceinline__ int swz(int s, int sl) {
  return sl % 32 ? ((s >> 1) & 1) << 3 : (s & 3) << 3;
}

// One chunk's slot data, lane l holding slot t0 + l (zeros past the range).
struct Meta {
  int ia, ib, row;
  float v;
};

__device__ __forceinline__ Meta load_meta(const int* __restrict__ idx, int idx_cols,
                                          const float* __restrict__ vals,
                                          const int* __restrict__ rel,
                                          const int* __restrict__ blkmap, long long t0, int n,
                                          int bn, int bi, int lane) {
  Meta m{0, 0, 0, 0.f};
  if (lane < n) {
    const int t = (int)t0 + lane;  // slot indices fit an int (the wrapper checks)
    m.ia = idx[(long long)t * idx_cols];
    m.ib = idx_cols > 1 ? idx[(long long)t * idx_cols + 1] : 0;
    m.v = vals[t];
    m.row = blkmap[t / bn] * bi + rel[t];
  }
  return m;
}

// Start the cp.async copies of a chunk's rows of one factor into rows s of
// sf (stride sl): the q 16-byte pieces of a row go to q neighbouring lanes,
// so one instruction reads 32 / q whole rows. Every lane runs the same trip
// count (the shuffles need the whole warp). kSwz: the fp32 route's swizzle.
template <typename T, bool kSwz>
__device__ __forceinline__ void gather_side(const T* __restrict__ f, int ld, int sl, int q,
                                            int ix, int n, T* sf, int lane) {
  constexpr int kPer16 = 16 / sizeof(T);
  const bool pow2 = (q & (q - 1)) == 0;  // the ranks' usual case: no division
  const int shift = __ffs(q) - 1;
  for (int e0 = 0; e0 < kSlots * q; e0 += kSlots) {
    const int e = e0 + lane, s = pow2 ? e >> shift : e / q, r = e - s * q;
    const int row = __shfl_sync(kFull, ix, s);
    const int col = r * kPer16;
    if (s < n)
      cp_async16(sf + s * sl + (kSwz ? col ^ swz(s, sl) : col), f + (long long)row * ld + col);
  }
}

// kTC: the fp32 tensor-core route (T = float); otherwise the bf16 CUDA-core
// route (T = bf16).
template <typename T, bool kTC>
__global__ void __launch_bounds__(kWarps * 32)
    kron_scatter_kernel(const T* __restrict__ fa, const T* __restrict__ fb,
                        const int* __restrict__ idx, const float* __restrict__ vals,
                        const int* __restrict__ rel, const int* __restrict__ blkmap,
                        const long long* __restrict__ parts, float* __restrict__ out, int n_parts,
                        int ra, int rb, int lda, int ldb, int sla, int slb, int idx_cols, int bn,
                        int bi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kPer16 = 16 / sizeof(T);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int part = blockIdx.x * (blockDim.x / 32) + warp;
  if (part >= n_parts) return;  // a whole warp: no shuffle is left waiting
  const int stage_elems = kSlots * (sla + slb);
  T* ring = reinterpret_cast<T*>(smem_raw) + (size_t)warp * kStages * stage_elems;
  // zero the warp's ring once: the columns past each row stay 0
  for (int e = lane; e < kStages * stage_elems; e += 32) ring[e] = T(0.f);
  __syncwarp();

  const long long k_cols = (long long)ra * rb;
  const int g = lane / 4, t = lane % 4;
  // fp32 route: the warp's m16 tile (a columns a0c .. a0c + 15) by kNT n8
  // tiles (b columns b0c .. b0c + 8 kNT - 1), the block blockIdx.y of them
  const int n_bt = (rb + 8 * kNT - 1) / (8 * kNT);
  const int a0c = 16 * (blockIdx.y / n_bt), b0c = 8 * kNT * (blockIdx.y % n_bt);
  // bf16 route: the lane's 4 x 2 register tile
  const int tbn = (rb + kTB - 1) / kTB;
  const int tile_simt = blockIdx.y * 32 + lane;
  const bool active_simt = tile_simt < ((ra + kTA - 1) / kTA) * tbn;
  const int i0 = active_simt ? (tile_simt / tbn) * kTA : 0;
  const int j0 = active_simt ? (tile_simt % tbn) * kTB : 0;

  float acc[kTC ? kNT : kTA][kTC ? 4 : kTB];
  auto zero_acc = [&]() {
#pragma unroll
    for (int r = 0; r < (kTC ? kNT : kTA); ++r)
#pragma unroll
      for (int c = 0; c < (kTC ? 4 : kTB); ++c) acc[r][c] = 0.f;
  };
  zero_acc();
  int cur = -1;
  auto store_row = [&]() {
    if (cur < 0) return;
    float* o = out + (long long)cur * k_cols;
    if constexpr (kTC) {
#pragma unroll
      for (int q = 0; q < kNT; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = a0c + g + 8 * (e >> 1), j = b0c + 8 * q + 2 * t + (e & 1);
          if (i < ra && j < rb) o[(long long)i * rb + j] = acc[q][e];
        }
    } else {
      if (!active_simt) return;
#pragma unroll
      for (int r = 0; r < kTA; ++r)
#pragma unroll
        for (int c = 0; c < kTB; ++c)
          if (i0 + r < ra && j0 + c < rb) o[(long long)(i0 + r) * rb + j0 + c] = acc[r][c];
    }
  };

  const long long t_begin = parts[part], t_end = parts[part + 1];
  const int n_chunks = (int)((t_end - t_begin + kSlots - 1) / kSlots);
  auto chunk_n = [&](int c) {
    return (int)min((long long)kSlots, t_end - t_begin - (long long)c * kSlots);
  };
  auto meta_of = [&](int c) {
    return c < n_chunks ? load_meta(idx, idx_cols, vals, rel, blkmap,
                                    t_begin + (long long)c * kSlots, chunk_n(c), bn, bi, lane)
                        : Meta{0, 0, 0, 0.f};
  };
  auto stage = [&](int c, const Meta& m) {
    if (c >= n_chunks) return;
    T* sa = ring + (c % kStages) * stage_elems;
    gather_side<T, kTC>(fa, lda, sla, lda / kPer16, m.ia, chunk_n(c), sa, lane);
    if (ldb > 0)
      gather_side<T, kTC>(fb, ldb, slb, ldb / kPer16, m.ib, chunk_n(c), sa + kSlots * sla, lane);
  };

  // m[i]: the slot data of chunk c + i. Chunk c + kStages - 1's rows are
  // gathered at iteration c, from slot data loaded one iteration before.
  Meta m[kStages + 1];
#pragma unroll
  for (int i = 0; i < kStages; ++i) m[i] = meta_of(i);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    stage(i, m[i]);
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    stage(c + kStages - 1, m[kStages - 1]);
    cp_async_commit();  // possibly empty: one group per chunk keeps the count
    m[kStages] = meta_of(c + kStages);
    cp_async_wait_ring();  // chunk c's rows have landed (this lane's copies)
    __syncwarp();          // ... and every lane's

    const T* sa = ring + (c % kStages) * stage_elems;
    const T* sb = sa + kSlots * sla;
    const int n = chunk_n(c);
    // the slot's row where its value is not 0, else -1 (it adds nothing)
    const int eff = m[0].v != 0.f ? m[0].row : -1;
    if constexpr (kTC) {
      // Y_row += (w a)^T b over slots 8 kb .. 8 kb + 7, w the slots' values
      // (0 where masked)
      auto block_pass = [&](int kb, float w0, float w1) {
        const int s0 = 8 * kb + t, s1 = s0 + 4;  // the slots of k = t and k = t + 4
        const int x0 = swz(s0, sla), x1 = swz(s1, sla);
        const float* r0 = sa + s0 * sla;
        const float* r1 = sa + s1 * sla;
        // A = (w a)^T: rows are a's columns, k the slots
        uint32_t ah[4], al[4];
        split(w0 * r0[(a0c + g) ^ x0], ah[0], al[0]);
        split(w0 * r0[(a0c + g + 8) ^ x0], ah[1], al[1]);
        split(w1 * r1[(a0c + g) ^ x1], ah[2], al[2]);
        split(w1 * r1[(a0c + g + 8) ^ x1], ah[3], al[3]);
#pragma unroll
        for (int q = 0; q < kNT; ++q) {
          const int col = b0c + 8 * q + g;
          uint32_t bh[2], bl[2];
          if (slb > 0) {
            split(sb[s0 * slb + (col ^ swz(s0, slb))], bh[0], bl[0]);
            split(sb[s1 * slb + (col ^ swz(s1, slb))], bh[1], bl[1]);
          } else {  // 2-way: b is the implicit ones column
            bh[0] = bh[1] = col == 0 ? 0x3f800000u : 0u;  // 1.f
            bl[0] = bl[1] = 0u;
          }
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(d, al, bh);
          mma_tf32(d, ah, bl);
          mma_tf32(d, ah, bh);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[q][e] = __fadd_rn(acc[q][e], d[e]);
        }
      };
      if (cur >= 0 && __ballot_sync(kFull, eff > cur) == 0) {
        // the whole chunk sums into row cur (its zero-valued slots add 0):
        // the blocks are independent, and unrolled they overlap
#pragma unroll
        for (int kb = 0; kb < kSlots / 8; ++kb) {
          if (8 * kb >= n) break;
          block_pass(kb, __shfl_sync(kFull, m[0].v, 8 * kb + t),
                     __shfl_sync(kFull, m[0].v, 8 * kb + t + 4));
        }
      } else {
        for (int kb = 0; 8 * kb < n; ++kb) {
          const int s0 = 8 * kb + t, s1 = s0 + 4;
          const int e0 = __shfl_sync(kFull, eff, s0), e1 = __shfl_sync(kFull, eff, s1);
          const float v0 = __shfl_sync(kFull, m[0].v, s0), v1 = __shfl_sync(kFull, m[0].v, s1);
          const unsigned block = 0xffu << (8 * kb);
          unsigned later = __ballot_sync(kFull, eff > cur) & block;
          while (true) {
            if (cur >= 0)  // this block's slots of row cur (and the zero-valued ones)
              block_pass(kb, e0 == cur || e0 < 0 ? v0 : 0.f, e1 == cur || e1 < 0 ? v1 : 0.f);
            if (!later) break;
            store_row();  // the row ends in this block: the next row starts
            zero_acc();
            cur = __shfl_sync(kFull, eff, __ffs(later) - 1);
            later = __ballot_sync(kFull, eff > cur) & block;
          }
        }
      }
    } else {
      for (int s = 0; s < n; ++s) {
        const int row = __shfl_sync(kFull, eff, s);
        const float vs = __shfl_sync(kFull, m[0].v, s);
        if (row > cur) {
          store_row();
          zero_acc();
          cur = row;
        }
        float av[kTA], bv[kTB];
        load4(reinterpret_cast<const __nv_bfloat16*>(sa) + s * sla + i0, av);
        if (slb > 0) {
          load2(reinterpret_cast<const __nv_bfloat16*>(sb) + s * slb + j0, bv);
        } else {  // 2-way: b is the implicit ones column (padded to two)
          bv[0] = 1.f, bv[1] = 0.f;
        }
#pragma unroll
        for (int r = 0; r < kTA; ++r)
#pragma unroll
          for (int q = 0; q < kTB; ++q)
            acc[r][q] = __fadd_rn(acc[r][q], kron::kron_term<true>(av[r], bv[q], vs));
      }
    }
    __syncwarp();  // every lane is done with this buffer before it is refilled
#pragma unroll
    for (int i = 0; i < kStages; ++i) m[i] = m[i + 1];
  }
  store_row();
}

template <typename T, bool kTC>
int launch(const void* fa, const void* fb, const int* ip, const float* vp, const int* relp,
           const int* blk, const long long* pp, float* o, int n_parts, int ra, int rb, int lda,
           int ldb, int sla, int slb, int idx_cols, int bn, int bi, int warps, dim3 grid,
           size_t smem, cudaStream_t st) {
  auto kernel = kron_scatter_kernel<T, kTC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, warps * 32, smem, st>>>(static_cast<const T*>(fa), static_cast<const T*>(fb),
                                         ip, vp, relp, blk, pp, o, n_parts, ra, rb, lda, ldb,
                                         sla, slb, idx_cols, bn, bi);
  return (int)cudaGetLastError();
}

int round_up(int x, int m) { return (x + m - 1) / m * m; }

}  // namespace

// Y (n_rows, ra*rb) f32, zero-filled by the caller. fa (I_a, lda) and
// fb (I_b, ldb) are the factor matrices, f32 (bf16 = 0: the tensor-core
// route) or bf16 (bf16 = 1), their rows zero-padded to 16 bytes (lda, ldb
// multiples of 4 in f32, 8 in bf16) and 16-byte aligned; fb is null with
// rb = 1 and ldb = 0 for a 2-way tensor. idx (nnzp, idx_cols) int32 holds
// each slot's row of fa (column 0) and of fb (column 1); vals (nnzp,) f32
// the slot values (0 on padding); rel (nnzp,) and blkmap (nnzp/bn,) int32
// the rows; parts (n_parts + 1,) int64 row-aligned slot ranges, one per
// warp. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue when the arguments are out of range or one warp's
// staging does not fit a CTA's shared memory.
extern "C" int kron_scatter_launch(const void* fa, const void* fb, const void* idx,
                                   const void* vals, const void* rel, const void* blkmap,
                                   const void* parts, void* out, int n_parts, int ra, int rb,
                                   int lda, int ldb, int idx_cols, int bn, int bi, int bf16,
                                   void* stream) {
  const int elem = bf16 ? 2 : 4, per16 = 16 / elem;
  if (n_parts < 1 || ra < 1 || rb < 1 || bn < 1 || bi < 1 || idx_cols < 1 || lda < ra ||
      lda % per16 || ldb % per16 || (ldb == 0 ? rb != 1 : ldb < rb))
    return (int)cudaErrorInvalidValue;
  const bool tc = !bf16;
  // staged row strides: on the fp32 route whole m16 / kNT n8 tile blocks,
  // in rows of a multiple of 16 words (the swizzle's); on the bf16 route
  // whole 4 x 2 lane tiles, in 16-byte rows
  const int sla = tc ? round_up(std::max(lda, round_up(ra, 16)), 16)
                     : round_up(std::max(lda, round_up(ra, kTA)), 8);
  const int slb = ldb == 0 ? 0
                  : tc     ? round_up(std::max(ldb, round_up(rb, 8 * kNT)), 16)
                           : round_up(std::max(ldb, round_up(rb, kTB)), 8);
  int dev = 0, smem_max = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t per_warp = (size_t)kStages * kSlots * (sla + slb) * elem;
  const int warps = (int)std::min<size_t>(kWarps, (size_t)smem_max / per_warp);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const int blocks_y = tc ? ((ra + 15) / 16) * ((rb + 8 * kNT - 1) / (8 * kNT))
                          : (((ra + kTA - 1) / kTA) * ((rb + kTB - 1) / kTB) + 31) / 32;
  const dim3 grid((n_parts + warps - 1) / warps, blocks_y);
  const size_t smem = per_warp * warps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ip = static_cast<const int*>(idx);
  const float* vp = static_cast<const float*>(vals);
  const int* relp = static_cast<const int*>(rel);
  const int* blk = static_cast<const int*>(blkmap);
  const long long* pp = static_cast<const long long*>(parts);
  float* o = static_cast<float*>(out);
  if (bf16)
    return launch<__nv_bfloat16, false>(fa, fb, ip, vp, relp, blk, pp, o, n_parts, ra, rb, lda,
                                        ldb, sla, slb, idx_cols, bn, bi, warps, grid, smem, st);
  return launch<float, true>(fa, fb, ip, vp, relp, blk, pp, o, n_parts, ra, rb, lda, ldb, sla,
                             slb, idx_cols, bn, bi, warps, grid, smem, st);
}
