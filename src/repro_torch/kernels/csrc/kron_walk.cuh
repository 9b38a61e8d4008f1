// The warp walk shared by the Kron-scatter kernels (kron_scatter.cu and
// kron_scatter_ttm.cu), for sm_90a. One warp walks one row-aligned range of
// schedule slots and builds each row of
//     Y_(n)[row(t)] += v[t] * (a[t] (x) b[t])      (Rb fastest, K = Ra*Rb)
// in registers, a[t] and b[t] read from the two non-mode factor matrices
// through the schedule's slot coordinates; when a row ends it hands the
// row to the caller's row_end(row, acc), which kernel 1 stores and kernel 5
// contracts. No (nnz, R) operand is ever written to device memory.
//
// Three routes, all on the tensor cores, by the element type T: fp32
// (float) in 3xTF32, bf16_fp32acc (bf16) on the bf16 tensor cores, f64
// (double) on the f64 tensor cores; every route hands the row end the same
// mma.sync accumulator fragments. kron_kernel.py::launch_route names the
// route each kernel, dtype and precision takes.
//
//   * A range starts at a row's first slot (sparse/layout.py::row_parts: a
//     row never crosses two ranges), so each row is a segmented sum of its
//     slots in slot order, in registers: no atomics, the same bits on every
//     call. A slot whose value is 0 (the schedule's padding, which aliases
//     row 0 of its group, or an explicit zero) adds nothing, so its row is
//     not looked at and never starts or ends a row.
//   * Slots go in chunks of 32, lane l holding slot l's coordinates, value
//     and row (coalesced loads). The chunk's factor rows are copied into the
//     warp's shared memory with cp.async in 16-byte pieces (the wrappers pad
//     the factor rows to 16 bytes), neighbouring lanes taking the pieces of
//     one row, so that an instruction reads whole rows (one lane a row made
//     each instruction touch 32 cache lines). A ring of two chunks: while
//     chunk c is summed, the rows of chunk c+1 are in flight and chunk
//     c+2's coordinates are loading (a third stage cost more in occupancy,
//     two CTAs of 8 warps an SM against three, than it hid, in turns on an
//     H100). The walk itself synchronises only its own warp; after each
//     chunk it calls the caller's chunk_end().
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
//   * float64 on the f64 tensor cores (DMMA; kernel 1's f64 route): the
//     same framing, row logic, tiles and fragments, with mma.sync m16n8k8
//     .f64 (tc::mma_f64) on f64 operands and one product a block, since
//     nothing is split: the A fragment holds round(v*a), the B fragment b,
//     and the block's products accumulate straight into the row's f64 sums
//     (the MMA's C operand), in slot order block by block. Each term is
//     fma(round(v*a), b, acc) where the plain version rounds round(a*b)*v:
//     about one f64 ulp of the term apart, ~sqrt(n) 2^-52 of a term over n
//     terms, far below chip_smoke.py's fp64 gate (max(1e-13, 4 sqrt(n)
//     2^-53) of max|plain|). The staged rows (strides of whole 16-element
//     blocks, as on the fp32 route) are swizzled by swz64: a fragment load
//     reads 4 slots x 8 columns of 8 bytes, served as two half-warps of 4
//     slots x 4 columns; XORing 4-column groups by slot % 4 puts each
//     half-warp's 16 doubles on 16 different bank pairs, and keeps 16-byte
//     pieces whole for cp.async.
//   * bf16_fp32acc on the bf16 tensor cores (kernel 1's bf16 route): the
//     same framing and row logic, 16 slots a block with mma.sync m16n8k16
//     bf16 (tc::mma_bf16). The A fragment holds a's columns as staged (bf16,
//     exact: the wrapper rounded the factors), loaded with ldmatrix.trans;
//     the B fragment holds v*b, formed in f32 from b (also loaded with
//     ldmatrix.trans) and split into a bf16 high part and a bf16 remainder,
//     two products a block, which carry v*b to 2^-16. Each product is exact
//     in the f32 accumulator, so a term is a*b*v to about 2^-16, where the
//     plain version rounds a*b to bf16 before the scale (up to 2^-8 of the
//     term): the card gives up that rounding on purpose, and its sum is the
//     nearer to the exact one; chip_smoke.py holds it to the bf16_fp32acc
//     limit, 2e-2 of max|plain|. Each 16-slot product starts from zero and
//     is added to the row's f32 sum, as on the fp32 route; a block that
//     holds a row's end is run once per row it touches, the other rows'
//     values masked to 0 in B. Rows are staged in bf16 in 16-element strides
//     (32 bytes at ranks 16, half the fp32 route's), swizzled by swz16 so
//     that each 8-row phase of an ldmatrix reads 32 different banks. (The
//     TF32 framing, 8 slots a block on m16n8k8 with A = a exact in TF32 and
//     B = v*b split into two TF32 parts, ran 1.2x slower on an H100.)
//   * The value type V (of vals and of the accumulators) is float on the
//     fp32 and bf16 routes, double on the f64 route.
#pragma once

#include <algorithm>
#include <cstdint>

#include "tc_common.cuh"

namespace kwalk {

using tc::mma_bf16;
using tc::mma_f64;
using tc::mma_tf32;
using tc::split;

constexpr int kSlots = 32;  // slots per staged chunk, one per lane
constexpr int kStages = 2;  // staged chunks per warp: one in flight while one is summed
constexpr int kWarps = 8;   // warps per CTA, at most (the f64 tensor-core route: kDmmaWarps)
constexpr int kDmmaWarps = 4;  // kernel 1's f64 route: CTAs of 4 warps, three an SM
constexpr int kNT = 2;      // n8 tiles (b columns) a warp, with one m16 tile
constexpr int kBlockCols = 256;  // columns of Y one block of blockIdx.y holds
constexpr unsigned kFull = 0xffffffffu;

inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Staged row strides (elements) of a and b: whole m16 / kNT n8 tile
// blocks, in rows of a multiple of 16 elements (the swizzles'). slb = 0 when
// ldb = 0 (a 2-way tensor).
inline void staged_strides(int ra, int rb, int lda, int ldb, int* sla, int* slb) {
  *sla = round_up(std::max(lda, round_up(ra, 16)), 16);
  *slb = ldb == 0 ? 0 : round_up(std::max(ldb, round_up(rb, 8 * kNT)), 16);
}

// Blocks of Y's columns, one a blockIdx.y: m16 x (8 kNT), each at most
// kBlockCols.
inline int column_blocks(int ra, int rb) {
  return ((ra + 15) / 16) * ((rb + 8 * kNT - 1) / (8 * kNT));
}

// Whether the operand sizes are ones the walk takes (per16: elements in 16
// bytes; ldb = 0 means a 2-way tensor, rb = 1).
inline bool shapes_ok(int ra, int rb, int lda, int ldb, int idx_cols, int bn, int bi,
                      int per16) {
  return ra >= 1 && rb >= 1 && bn >= 1 && bi >= 1 && idx_cols >= 1 && lda >= ra &&
         lda % per16 == 0 && ldb % per16 == 0 && (ldb == 0 ? rb == 1 : ldb >= rb);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
// all but the newest kStages - 1 groups have landed
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

// The fp32 route's shared-memory swizzle: element c of staged slot s sits at
// column c ^ swz(s), so that the 4 slots x 8 columns of a fragment load fall
// on 32 different banks with unpadded rows (stride sl, a multiple of 16
// words). The XOR moves whole 8-column groups, so 16-byte pieces stay whole.
__device__ __forceinline__ int swz(int s, int sl) {
  return sl % 32 ? ((s >> 1) & 1) << 3 : (s & 3) << 3;
}
// The f64 tensor-core route's: element c of staged slot s sits at column
// c ^ swz64(s) (strides of whole 16-double blocks, so a slot's row starts on
// bank pair 0). A fragment load is 4 slots (t) x 8 columns (g) of 8 bytes,
// served as two half-warps (g < 4, g >= 4); in each, column g of slot t
// lands on bank pair g ^ 4t (mod 16): 16 different pairs, no conflict.
__device__ __forceinline__ int swz64(int s) { return (s & 3) << 2; }
// The bf16 tensor-core route's (strides sl of whole 16-element blocks): an
// ldmatrix phase reads one 16-byte piece (8 columns) of 8 consecutive
// slots, and the XOR moves whole pieces, by slot, so that the 8 pieces fall
// on the 8 different 16-byte bank groups of a 128-byte line: rows of 128
// bytes or a multiple (sl % 64 == 0) XOR the piece by s % 8, rows of 64
// bytes mod 128 by (s / 2) % 4, rows of 32 bytes mod 64 by (s / 4) % 2. Each
// XOR stays inside the aligned block of 16, 32 or 64 columns that holds c.
__device__ __forceinline__ int swz16(int s, int sl) {
  return sl % 64 == 0 ? (s & 7) << 3 : sl % 32 == 0 ? ((s >> 1) & 3) << 3 : ((s >> 2) & 1) << 3;
}
// The swizzle of the tensor-core route of element type T.
template <typename T>
__device__ __forceinline__ int swz_of(int s, int sl) {
  return sizeof(T) == 8 ? swz64(s) : sizeof(T) == 2 ? swz16(s, sl) : swz(s, sl);
}

// One chunk's slot data, lane l holding slot t0 + l (zeros past the range).
template <typename V>
struct Meta {
  int ia, ib, row;
  V v;
};

template <typename V>
__device__ __forceinline__ Meta<V> load_meta(const int* __restrict__ idx, int idx_cols,
                                             const V* __restrict__ vals,
                                             const int* __restrict__ rel,
                                             const int* __restrict__ blkmap, long long t0,
                                             int n, int bn, int bi, int lane) {
  Meta<V> m{0, 0, 0, V(0)};
  if (lane < n) {
    const int t = (int)t0 + lane;  // slot indices fit an int (the wrappers check)
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
// count (the shuffles need the whole warp). kSwz: the tensor-core routes'
// swizzle (swz_of<T>).
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
      cp_async16(sf + s * sl + (kSwz ? col ^ swz_of<T>(s, sl) : col),
                 f + (long long)row * ld + col);
  }
}

// The sizes the walk reads its operands with.
struct Shape {
  int ra, rb;      // ranks of a and b (rb = 1 for a 2-way tensor)
  int lda, ldb;    // padded factor row lengths (ldb = 0: 2-way, b is a ones column)
  int sla, slb;    // staged row strides, staged_strides()
  int idx_cols;    // columns of the slot coordinates (1 for a 2-way tensor)
  int bn, bi;      // the schedule's nnz block and row block sizes
};

// The part of a Kron row that one warp sums, in column block `by`, and its
// register accumulator `Acc` of the value type V: the warp's m16 tile (a
// columns a0c .. a0c + 15) by kNT n8 tiles (b columns b0c .. b0c + 8 kNT -
// 1); acc[q][e] is column (a0c + g + 8 (e >> 1), b0c + 8 q + 2 t + (e & 1))
// of the row.
template <typename V>
struct Tile {
  using Acc = V[kNT][4];
  int a0c, b0c;

  __device__ Tile(int ra, int rb, int by) {
    const int n_bt = (rb + 8 * kNT - 1) / (8 * kNT);
    a0c = 16 * (by / n_bt), b0c = 8 * kNT * (by % n_bt);
  }

  // The block's local column c (0 .. kBlockCols - 1), c = 16 (i - a0c) +
  // (j - b0c), as a column (i, j) of the row. False when it lies outside
  // the row.
  __device__ static bool column(int c, int ra, int rb, int by, int& i, int& j) {
    const int n_bt = (rb + 8 * kNT - 1) / (8 * kNT);
    i = 16 * (by / n_bt) + c / 16;
    j = 8 * kNT * (by % n_bt) + c % 16;
    return i < ra && j < rb;
  }
};

// Zero a warp's ring once: the staged columns past each factor row stay 0.
template <typename T>
__device__ __forceinline__ void zero_ring(T* ring, int elems, int lane) {
  for (int e = lane; e < elems; e += 32) ring[e] = T(0.f);
  __syncwarp();
}

// Walk slots [t_begin, t_end) of one row-aligned range with the whole warp
// (every lane calls it), staging in `ring` (kStages * kSlots * (sla + slb)
// elements of the warp's own shared memory, zeroed once by zero_ring).
// Calls row_end(row, acc) with the warp's part of each finished row, once
// per row, from the whole warp, and chunk_end() after each chunk. The route
// by T: fp32 (T = V = float, 3xTF32), bf16 (T = bf16, V = float, bf16
// m16n8k16) or f64 (T = V = double, DMMA).
template <typename T, typename V, typename RowEnd, typename ChunkEnd>
__device__ __forceinline__ void walk(const T* __restrict__ fa, const T* __restrict__ fb,
                                     const int* __restrict__ idx,
                                     const V* __restrict__ vals,
                                     const int* __restrict__ rel,
                                     const int* __restrict__ blkmap, const Shape& sh,
                                     long long t_begin, long long t_end, T* ring,
                                     const Tile<V>& tile, int lane, RowEnd&& row_end,
                                     ChunkEnd&& chunk_end) {
  constexpr int kPer16 = 16 / sizeof(T);
  const int sla = sh.sla, slb = sh.slb;
  const int stage_elems = kSlots * (sla + slb);
  const int g = lane / 4, t = lane % 4;
  const int a0c = tile.a0c, b0c = tile.b0c;

  typename Tile<V>::Acc acc;
  auto zero_acc = [&]() {
#pragma unroll
    for (int q = 0; q < kNT; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = V(0);
  };
  zero_acc();
  int cur = -1;
  auto end_row = [&]() {
    if (cur >= 0) row_end(cur, acc);
  };

  const int n_chunks = (int)((t_end - t_begin + kSlots - 1) / kSlots);
  auto chunk_n = [&](int c) {
    return (int)min((long long)kSlots, t_end - t_begin - (long long)c * kSlots);
  };
  auto meta_of = [&](int c) {
    return c < n_chunks ? load_meta(idx, sh.idx_cols, vals, rel, blkmap,
                                    t_begin + (long long)c * kSlots, chunk_n(c), sh.bn, sh.bi,
                                    lane)
                        : Meta<V>{0, 0, 0, V(0)};
  };
  auto stage = [&](int c, const Meta<V>& m) {
    if (c >= n_chunks) return;
    T* sa = ring + (c % kStages) * stage_elems;
    gather_side<T, true>(fa, sh.lda, sla, sh.lda / kPer16, m.ia, chunk_n(c), sa, lane);
    if (sh.ldb > 0)
      gather_side<T, true>(fb, sh.ldb, slb, sh.ldb / kPer16, m.ib, chunk_n(c), sa + kSlots * sla,
                          lane);
  };

  // m[i]: the slot data of chunk c + i. Chunk c + kStages - 1's rows are
  // gathered at iteration c, from slot data loaded one iteration before.
  Meta<V> m[kStages + 1];
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
    const int eff = m[0].v != V(0) ? m[0].row : -1;
    // kK slots a block: 16 on bf16 m16n8k16, else 8 (m16n8k8). Lane (g, t)
    // holds the block's slots lane_slot(0 .. kW - 1): its k of the B (and
    // A) fragments, t and t + 4 on m16n8k8, 2t, 2t + 1, 2t + 8, 2t + 9 on
    // m16n8k16.
    constexpr int kK = sizeof(T) == 2 ? 16 : 8, kW = kK / 4;
    auto lane_slot = [&](int i) { return kK == 16 ? 2 * t + (i & 1) + 8 * (i >> 1) : t + 4 * i; };
    // Y_row += (w a)^T b over slots kK kb .. kK kb + kK - 1, w the slots'
    // values (0 where masked), w[i] that of the lane's slot lane_slot(i)
    auto block_pass = [&](int kb, const V (&w)[kW]) {
      if constexpr (sizeof(T) == 2) {
        // A = a^T and the staged b, each by one ldmatrix.x4.trans: lane l
        // points at row l % 8 of matrix l / 8, a 16-byte piece of a slot
        const int j = lane >> 3, r = lane & 7;
        const int s_a = kK * kb + r + 8 * (j >> 1), c_a = a0c + 8 * (j & 1);
        uint32_t a[4], braw[4];
        tc::ldsm_x4_trans(a, sa + s_a * sla + (c_a ^ swz16(s_a, sla)));
        if (slb > 0) {  // braw[2 q + h]: n8 tile q, the lane's slots 2t + 8h, 2t + 8h + 1
          const int s_b = kK * kb + r + 8 * (j & 1), c_b = b0c + 8 * (j >> 1);
          tc::ldsm_x4_trans(braw, sb + s_b * slb + (c_b ^ swz16(s_b, slb)));
        }
#pragma unroll
        for (int q = 0; q < kNT; ++q) {
          // B = v b at column b0c + 8 q + g, split into bf16 hi + lo
          uint32_t bh[2], bl[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float x0, x1;
            if (slb > 0) {
              x0 = tc::bf16_lo(braw[2 * q + h]), x1 = tc::bf16_hi(braw[2 * q + h]);
            } else {  // 2-way: b is the implicit ones column
              x0 = x1 = b0c + 8 * q + g == 0 ? 1.f : 0.f;
            }
            tc::split_bf16x2(__fmul_rn(w[2 * h], x0), __fmul_rn(w[2 * h + 1], x1), bh[h],
                             bl[h]);
          }
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(d, a, bl);
          mma_bf16(d, a, bh);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[q][e] = __fadd_rn(acc[q][e], d[e]);
        }
      } else {
        const int s0 = kK * kb + t, s1 = s0 + 4;  // the slots of k = t and k = t + 4
        const int x0 = swz_of<T>(s0, sla), x1 = swz_of<T>(s1, sla);
        const T* r0 = sa + s0 * sla;
        const T* r1 = sa + s1 * sla;
        if constexpr (sizeof(T) == 8) {
          // A = (w a)^T rounded once; the products accumulate into the row
          const double a[4] = {__dmul_rn(w[0], r0[(a0c + g) ^ x0]),
                               __dmul_rn(w[0], r0[(a0c + g + 8) ^ x0]),
                               __dmul_rn(w[1], r1[(a0c + g) ^ x1]),
                               __dmul_rn(w[1], r1[(a0c + g + 8) ^ x1])};
#pragma unroll
          for (int q = 0; q < kNT; ++q) {
            const int col = b0c + 8 * q + g;
            double b[2];
            if (slb > 0) {
              b[0] = sb[s0 * slb + (col ^ swz64(s0))];
              b[1] = sb[s1 * slb + (col ^ swz64(s1))];
            } else {  // 2-way: b is the implicit ones column
              b[0] = b[1] = col == 0 ? 1.0 : 0.0;
            }
            mma_f64(acc[q], a, b);
          }
        } else {
          // A = (w a)^T: rows are a's columns, k the slots
          uint32_t ah[4], al[4];
          split(w[0] * r0[(a0c + g) ^ x0], ah[0], al[0]);
          split(w[0] * r0[(a0c + g + 8) ^ x0], ah[1], al[1]);
          split(w[1] * r1[(a0c + g) ^ x1], ah[2], al[2]);
          split(w[1] * r1[(a0c + g + 8) ^ x1], ah[3], al[3]);
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
        }
      }
    };
    if (cur >= 0 && __ballot_sync(kFull, eff > cur) == 0) {
      // the whole chunk sums into row cur (its zero-valued slots add 0):
      // the blocks are independent, and unrolled they overlap
#pragma unroll
      for (int kb = 0; kb < kSlots / kK; ++kb) {
        if (kK * kb >= n) break;
        V w[kW];
#pragma unroll
        for (int i = 0; i < kW; ++i) w[i] = __shfl_sync(kFull, m[0].v, kK * kb + lane_slot(i));
        block_pass(kb, w);
      }
    } else {
      for (int kb = 0; kK * kb < n; ++kb) {
        int e[kW];
        V vs[kW];
#pragma unroll
        for (int i = 0; i < kW; ++i) {
          e[i] = __shfl_sync(kFull, eff, kK * kb + lane_slot(i));
          vs[i] = __shfl_sync(kFull, m[0].v, kK * kb + lane_slot(i));
        }
        const unsigned block = ((1u << kK) - 1u) << (kK * kb);
        unsigned later = __ballot_sync(kFull, eff > cur) & block;
        while (true) {
          if (cur >= 0) {  // this block's slots of row cur (and the zero-valued ones)
            V w[kW];
#pragma unroll
            for (int i = 0; i < kW; ++i) w[i] = e[i] == cur || e[i] < 0 ? vs[i] : V(0);
            block_pass(kb, w);
          }
          if (!later) break;
          end_row();  // the row ends in this block: the next row starts
          zero_acc();
          cur = __shfl_sync(kFull, eff, __ffs(later) - 1);
          later = __ballot_sync(kFull, eff > cur) & block;
        }
      }
    }
    __syncwarp();  // every lane is done with this buffer before it is refilled
#pragma unroll
    for (int i = 0; i < kStages; ++i) m[i] = m[i + 1];
    chunk_end();
  }
  end_row();
}

}  // namespace kwalk
