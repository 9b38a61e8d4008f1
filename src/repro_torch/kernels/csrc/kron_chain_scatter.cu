// Fused order >= 4 unfolding of one HOOI mode, for sm_90a: the Kron chain
// and its scatter in one kernel, the factor rows read through the schedule.
//
// Replaces: src/repro/kernels/kron_kernel.py :: kron_contrib_pallas (chained) + scatter_rows_pallas
// (_kron_kernel once a link, then _scatter_kernel via _scatter_call), the
// TPU kernels that compute, for an order-N tensor,
//     Y_(n)[row(t)] += v[t] * (f_1[t] (x) f_2[t] (x) ... (x) f_{N-1}[t])
// (the last factor fastest, K = R_1 ... R_{N-1}) by writing each link's
// (nnz, K) rows to memory and summing them into their rows with a one-hot
// matmul. Here the kernel takes the N - 1 factor matrices themselves and the
// schedule's cached slot coordinates, and forms each slot's Kron row in
// registers: no (nnz, R) gather and no (nnz, K) contrib ever reaches device
// memory (51 GB a mode at NIPS size, K = 4,096).
//
// What bounds it on this card. The function reads each slot's N - 1
// coordinates, its value and its row once (24 B at order 4: 75 MB a mode at
// NIPS size) and writes Y_(n) once (up to 230 MB a mode), ~0.57 GB a NIPS
// sweep, 0.17 ms at 3.35 TB/s; its 2K + R_1 + (N - 3) K_B operations a slot
// (2.6e10 a mode) take 0.05 ms at the TF32 tensor-core rate, three times
// that as 3xTF32 products (fp32), twice as 2xTF32 (bf16_fp32acc). The
// factor matrices (<= 0.9 MB each) stay in L2.
//
// Design: kernel 1's warp walk (kron_walk.cuh's pieces: 32-slot chunks,
// their factor rows copied with cp.async into a two-stage ring of the warp's
// own shared memory, swizzled on the tensor-core routes), generalised to N - 1
// factors:
//   * fp32, on the tensor cores: a row of Y is the product over its slots
//     (v f_1)^T B with B = f_2 (x) ... (x) f_{N-1}, so the warp runs it 8
//     slots at a time with mma.sync m16n8k8 in 3xTF32 (tc_common.cuh): the A
//     fragment holds v f_1 (one m16 tile at R_1 = 16), the B fragment entries
//     are formed in registers from the staged rows while they load, one f32
//     multiply per further factor. Each 8-slot product starts from zero and
//     is added to the row's sum with f32 adds. A term differs from the
//     chain's round(round(round(a b) v) c) by ~2^-21 relative, well inside
//     chip_smoke.py's fp32 rule. A warp holds one m16 x (8 kNT) block of the
//     row; K is tiled over blockIdx.y.
//   * bf16_fp32acc, on the tensor cores in 2xTF32: the same framing, A =
//     f_1 (staged in bf16, exact in TF32: no split), B = v (f_2 (x) ... (x)
//     f_{N-1}) formed in f32 registers (f_2 staged in bf16, the later
//     factors in f32, as the reference's later links run at fp32) and split
//     into two TF32 parts: two m16n8k8 products a block against fp32's
//     three. A term is v f_1 f_2 ... to ~2^-21; the chain rounds f_1 f_2 to
//     bf16 before the scale (up to 2^-8 of the term), which the card gives
//     up on purpose, held by chip_smoke.py to the bf16_fp32acc limit (2e-2
//     x max|plain|). f_1 and f_2 are staged swizzled by kron_walk.cuh's
//     swz16, the later factors by the fp32 route's swz.
//   * float64, on the CUDA cores: the chain's roundings term by term,
//     round(round(round(a b) v) c) ..., summed in f64; a lane owns a 4 x 2
//     register tile of the row.
//   * Long rows (NIPS's last mode: 17 rows of ~182 K slots). The slots are
//     cut into ranges of equal length, not at row starts
//     (sparse/layout.py::even_cuts, cached on the schedule), one warp a
//     range, so one long row spreads over many warps and every warp does the
//     same work. A warp stores the rows that start and end inside its range
//     directly; its first and last rows, which it may share with its
//     neighbours, go to a scratch of two partial rows a range (part, with
//     their rows in part_rows, -1 for none). A second kernel sums each row's
//     partials in range order and stores the row. No atomics, and the order
//     of every sum is fixed by the schedule: the same bits on every call.
//     Zero-valued slots (the schedule's padding, which aliases row 0 of its
//     group, or an explicit zero) add nothing and never start or end a row.
//   * Orders 4 to kMaxOps + 1 are compiled in (M = N - 1 a template
//     argument); the wrapper sends higher orders to the chain of kernels 3
//     and 4.
#include "kron_walk.cuh"

namespace {

using kwalk::kFull;
using kwalk::kSlots;
using kwalk::kStages;
using tc::mma_tf32;
using tc::split;

constexpr int kMaxOps = 5;  // operand factors a launch takes: orders 4 to 6
constexpr int kWarps = 8;   // warps (ranges) a CTA, at most
constexpr int kNT = 4;      // fp32 route: n8 tiles of B a warp, beside one m16 tile of A
constexpr int kTA = 4;      // f64 route: f_1 columns per lane
constexpr int kTB = 2;      // f64 route: B columns per lane
constexpr int kCombineThreads = 256;

int round_up(int x, int m) { return (x + m - 1) / m * m; }

// How a launch reads its operands. Factor f (0 .. m - 1, in
// layout.operand_modes order) has rank r[f], padded row length ld[f] and
// staged row stride sl[f] (elements of its type); its kSlots staged rows
// start off[f] bytes into a stage of stage_bytes.
struct Dims {
  int m;
  int r[kMaxOps], ld[kMaxOps], sl[kMaxOps], off[kMaxOps];
  int stage_bytes;
  int kb;  // columns of B: r[1] * ... * r[m - 1]
  int bn, bi;
};
struct Factors {
  const void* p[kMaxOps];
};

// One chunk's slot data, lane l holding slot t0 + l (zeros past the range).
template <int M, typename V>
struct Meta {
  int ix[M];
  int row;
  V v;
};

template <int M, typename V>
__device__ __forceinline__ Meta<M, V> load_meta(const int* __restrict__ idx,
                                                const V* __restrict__ vals,
                                                const int* __restrict__ rel,
                                                const int* __restrict__ blkmap, long long t0,
                                                int n, int bn, int bi, int lane) {
  Meta<M, V> m;
#pragma unroll
  for (int f = 0; f < M; ++f) m.ix[f] = 0;
  m.row = 0;
  m.v = V(0);
  if (lane < n) {
    const long long t = t0 + lane;
#pragma unroll
    for (int f = 0; f < M; ++f) m.ix[f] = idx[t * M + f];
    m.v = vals[t];
    m.row = blkmap[t / bn] * bi + rel[t];
  }
  return m;
}

// The element of factor f's staged row s at column j (swizzled on the
// tensor-core routes, as the copies placed it).
template <typename E, bool kTC>
__device__ __forceinline__ E staged(const unsigned char* st, const Dims& d, int f, int s, int j) {
  const E* row = reinterpret_cast<const E*>(st + d.off[f]) + s * d.sl[f];
  return row[kTC ? j ^ kwalk::swz_of<E>(s, d.sl[f]) : j];
}

__device__ __forceinline__ float to_v(float x) { return x; }
__device__ __forceinline__ float to_v(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ double to_v(double x) { return x; }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
// the f64 route's load of a lane's kTA entries of a staged f_1 row (16-byte aligned)
__device__ __forceinline__ void load4(const double* p, double* o) {
  const double2 x = *reinterpret_cast<const double2*>(p);
  const double2 y = *reinterpret_cast<const double2*>(p + 2);
  o[0] = x.x, o[1] = x.y, o[2] = y.x, o[3] = y.y;
}

// The f64 route's first link, as the chain rounds it: f64 products.
__device__ __forceinline__ double first_term(double a, double b, double v) {
  return __dmul_rn(__dmul_rn(a, b), v);
}

// Column c of B as the element offsets of its entries in factors 1 .. m - 1
// (o[0] unused); a column past B reads column 0 of each (finite, never
// stored).
template <int M>
__device__ __forceinline__ void b_offsets(const Dims& d, int c, int (&o)[M]) {
  const bool ok = c < d.kb;
#pragma unroll
  for (int f = M - 1; f >= 1; --f) {
    o[f] = ok ? c % d.r[f] : 0;
    c /= d.r[f];
  }
  o[0] = 0;
}

// Pass 1: one warp a range of slots [cuts[range], cuts[range + 1]), one
// block of Y's columns a blockIdx.y. T: f_1 and f_2's staged type, U: the
// later factors', V: values, sums and Y. kTC: a tensor-core route, fp32 (T
// = float, 3xTF32) or bf16_fp32acc (T = bf16, 2xTF32); else f64 on the
// CUDA cores.
template <typename T, typename U, typename V, bool kTC, int M>
__global__ void __launch_bounds__(kWarps * 32, 2)
    chain_scatter_kernel(const Factors fp, const int* __restrict__ idx,
                         const V* __restrict__ vals, const int* __restrict__ rel,
                         const int* __restrict__ blkmap, const long long* __restrict__ cuts,
                         int n_ranges, V* __restrict__ out, V* __restrict__ part,
                         int* __restrict__ part_rows, const Dims d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int range = blockIdx.x * (blockDim.x / 32) + warp;
  if (range >= n_ranges) return;  // a whole warp: no shuffle is left waiting
  unsigned char* ring = smem_raw + (size_t)warp * kStages * d.stage_bytes;
  {  // zero the ring once: staged columns past each factor row stay 0
    uint4* z = reinterpret_cast<uint4*>(ring);
    for (int e = lane; e < kStages * d.stage_bytes / 16; e += 32) z[e] = make_uint4(0, 0, 0, 0);
    __syncwarp();
  }
  const long long t_begin = cuts[range], t_end = cuts[range + 1];
  const int r0 = d.r[0], kb = d.kb;
  const long long k_cols = (long long)r0 * kb;
  const int g = lane / 4, t = lane % 4, by = blockIdx.y;

  // The lane's part of the row. fp32: the warp's m16 tile (f_1 columns a0c
  // .. a0c + 15) by kNT n8 tiles (B columns b0c .. b0c + 8 kNT - 1);
  // acc[q][e] is column (a0c + g + 8 (e >> 1), b0c + 8 q + 2 t + (e & 1)),
  // and the lane loads B column b0c + 8 q + g. CUDA cores: the lane's
  // kTA x kTB tile at (i0, j0), acc[r][c] column (i0 + r, j0 + c).
  constexpr int kR = kTC ? kNT : kTA, kC = kTC ? 4 : kTB, kQ = kTC ? kNT : kTB;
  V acc[kR][kC];
  int bo[kQ][M];
  int a0c = 0, b0c = 0, i0 = 0, j0 = 0;
  bool active = true;
  if constexpr (kTC) {
    const int n_bt = (kb + 8 * kNT - 1) / (8 * kNT);
    a0c = 16 * (by / n_bt);
    b0c = 8 * kNT * (by % n_bt);
#pragma unroll
    for (int q = 0; q < kNT; ++q) b_offsets<M>(d, b0c + 8 * q + g, bo[q]);
  } else {
    const int tbn = (kb + kTB - 1) / kTB;
    const int tile = by * 32 + lane;
    active = tile < ((r0 + kTA - 1) / kTA) * tbn;
    i0 = active ? (tile / tbn) * kTA : 0;
    j0 = active ? (tile % tbn) * kTB : 0;
#pragma unroll
    for (int c = 0; c < kTB; ++c) b_offsets<M>(d, j0 + c, bo[c]);
  }
  auto zero_acc = [&]() {
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[r][c] = V(0);
  };
  auto store = [&](V* dst) {  // the lane's part of a finished row, dst its K columns
    if constexpr (kTC) {
#pragma unroll
      for (int q = 0; q < kNT; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = a0c + g + 8 * (e >> 1), j = b0c + 8 * q + 2 * t + (e & 1);
          if (i < r0 && j < kb) dst[(long long)i * kb + j] = acc[q][e];
        }
    } else {
      if (!active) return;
#pragma unroll
      for (int r = 0; r < kTA; ++r)
#pragma unroll
        for (int c = 0; c < kTB; ++c)
          if (i0 + r < r0 && j0 + c < kb) dst[(long long)(i0 + r) * kb + j0 + c] = acc[r][c];
    }
  };
  // A finished row: the range's first row and its last go to the scratch
  // (entries 2 range and 2 range + 1), the rows between straight to Y.
  int cur = -1, n_ended = 0, head = -1, tail = -1;
  auto end_row = [&](bool last) {
    if (cur < 0) return;
    if (n_ended == 0) {
      head = cur;
      store(part + 2LL * range * k_cols);
    } else if (last) {
      tail = cur;
      store(part + (2LL * range + 1) * k_cols);
    } else {
      store(out + (long long)cur * k_cols);
    }
    ++n_ended;
  };
  zero_acc();

  const int n_chunks = (int)((t_end - t_begin + kSlots - 1) / kSlots);
  auto chunk_n = [&](int c) {
    return (int)min((long long)kSlots, t_end - t_begin - (long long)c * kSlots);
  };
  auto meta_of = [&](int c) {
    if (c >= n_chunks) {
      Meta<M, V> z;
#pragma unroll
      for (int f = 0; f < M; ++f) z.ix[f] = 0;
      z.row = 0;
      z.v = V(0);
      return z;
    }
    return load_meta<M, V>(idx, vals, rel, blkmap, t_begin + (long long)c * kSlots, chunk_n(c),
                           d.bn, d.bi, lane);
  };
  auto stage = [&](int c, const Meta<M, V>& m) {
    if (c >= n_chunks) return;
    unsigned char* st = ring + (c % kStages) * d.stage_bytes;
    const int n = chunk_n(c);
#pragma unroll
    for (int f = 0; f < M; ++f) {
      if (f < 2)
        kwalk::gather_side<T, kTC>(static_cast<const T*>(fp.p[f]), d.ld[f], d.sl[f],
                                   d.ld[f] / (16 / (int)sizeof(T)), m.ix[f], n,
                                   reinterpret_cast<T*>(st + d.off[f]), lane);
      else
        kwalk::gather_side<U, kTC>(static_cast<const U*>(fp.p[f]), d.ld[f], d.sl[f],
                                   d.ld[f] / (16 / (int)sizeof(U)), m.ix[f], n,
                                   reinterpret_cast<U*>(st + d.off[f]), lane);
    }
  };

  // m[i]: the slot data of chunk c + i. Chunk c + kStages - 1's rows are
  // gathered at iteration c, from slot data loaded one iteration before.
  Meta<M, V> m[kStages + 1];
#pragma unroll
  for (int i = 0; i < kStages; ++i) m[i] = meta_of(i);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    stage(i, m[i]);
    kwalk::cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    stage(c + kStages - 1, m[kStages - 1]);
    kwalk::cp_async_commit();  // possibly empty: one group per chunk keeps the count
    m[kStages] = meta_of(c + kStages);
    kwalk::cp_async_wait_ring();  // chunk c's rows have landed (this lane's copies)
    __syncwarp();                 // ... and every lane's

    const unsigned char* st = ring + (c % kStages) * d.stage_bytes;
    const int n = chunk_n(c);
    // the slot's row where its value is not 0, else -1 (it adds nothing)
    const int eff = m[0].v != V(0) ? m[0].row : -1;
    if constexpr (kTC) {
      // Y_row += (w f_1)^T B over slots 8 kb8 .. 8 kb8 + 7, w the slots'
      // values (0 where masked)
      auto block_pass = [&](int kb8, float w0, float w1) {
        const int s0 = 8 * kb8 + t, s1 = s0 + 4;  // the slots of k = t and k = t + 4
        constexpr bool kBf = sizeof(T) == 2;
        // fp32: A = (w f_1)^T split in two; bf16: A = f_1^T (bf16, exact in
        // TF32), and w goes into B
        uint32_t ah[4], al[4];
        if constexpr (kBf) {
          ah[0] = __float_as_uint(to_v(staged<T, true>(st, d, 0, s0, a0c + g)));
          ah[1] = __float_as_uint(to_v(staged<T, true>(st, d, 0, s0, a0c + g + 8)));
          ah[2] = __float_as_uint(to_v(staged<T, true>(st, d, 0, s1, a0c + g)));
          ah[3] = __float_as_uint(to_v(staged<T, true>(st, d, 0, s1, a0c + g + 8)));
        } else {
          split(w0 * staged<float, true>(st, d, 0, s0, a0c + g), ah[0], al[0]);
          split(w0 * staged<float, true>(st, d, 0, s0, a0c + g + 8), ah[1], al[1]);
          split(w1 * staged<float, true>(st, d, 0, s1, a0c + g), ah[2], al[2]);
          split(w1 * staged<float, true>(st, d, 0, s1, a0c + g + 8), ah[3], al[3]);
        }
#pragma unroll
        for (int q = 0; q < kNT; ++q) {
          float b0 = to_v(staged<T, true>(st, d, 1, s0, bo[q][1]));
          float b1 = to_v(staged<T, true>(st, d, 1, s1, bo[q][1]));
          if constexpr (kBf) {
            b0 = __fmul_rn(w0, b0);
            b1 = __fmul_rn(w1, b1);
          }
#pragma unroll
          for (int f = 2; f < M; ++f) {
            b0 = __fmul_rn(b0, staged<U, true>(st, d, f, s0, bo[q][f]));
            b1 = __fmul_rn(b1, staged<U, true>(st, d, f, s1, bo[q][f]));
          }
          uint32_t bh[2], bl[2];
          split(b0, bh[0], bl[0]);
          split(b1, bh[1], bl[1]);
          float dd[4] = {0.f, 0.f, 0.f, 0.f};
          if constexpr (kBf) {
            mma_tf32(dd, ah, bl);
          } else {
            mma_tf32(dd, al, bh);
            mma_tf32(dd, ah, bl);
          }
          mma_tf32(dd, ah, bh);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[q][e] = __fadd_rn(acc[q][e], dd[e]);
        }
      };
      if (cur >= 0 && __ballot_sync(kFull, eff > cur) == 0) {
        // the whole chunk sums into row cur (its zero-valued slots add 0):
        // the blocks are independent, and unrolled they overlap
#pragma unroll
        for (int kb8 = 0; kb8 < kSlots / 8; ++kb8) {
          if (8 * kb8 >= n) break;
          block_pass(kb8, __shfl_sync(kFull, m[0].v, 8 * kb8 + t),
                     __shfl_sync(kFull, m[0].v, 8 * kb8 + t + 4));
        }
      } else {
        for (int kb8 = 0; 8 * kb8 < n; ++kb8) {
          const int s0 = 8 * kb8 + t, s1 = s0 + 4;
          const int e0 = __shfl_sync(kFull, eff, s0), e1 = __shfl_sync(kFull, eff, s1);
          const float v0 = __shfl_sync(kFull, m[0].v, s0), v1 = __shfl_sync(kFull, m[0].v, s1);
          const unsigned block = 0xffu << (8 * kb8);
          unsigned later = __ballot_sync(kFull, eff > cur) & block;
          while (true) {
            if (cur >= 0)  // this block's slots of row cur (and the zero-valued ones)
              block_pass(kb8, e0 == cur || e0 < 0 ? v0 : 0.f, e1 == cur || e1 < 0 ? v1 : 0.f);
            if (!later) break;
            end_row(false);  // the row ends in this block: the next row starts
            zero_acc();
            cur = __shfl_sync(kFull, eff, __ffs(later) - 1);
            later = __ballot_sync(kFull, eff > cur) & block;
          }
        }
      }
    } else {
      for (int s = 0; s < n; ++s) {
        const int row = __shfl_sync(kFull, eff, s);
        const V vs = __shfl_sync(kFull, m[0].v, s);
        if (row > cur) {
          end_row(false);
          zero_acc();
          cur = row;
        }
        V av[kTA], bv[kTB];
        load4(reinterpret_cast<const T*>(st + d.off[0]) + s * d.sl[0] + i0, av);
#pragma unroll
        for (int c2 = 0; c2 < kTB; ++c2) bv[c2] = to_v(staged<T, false>(st, d, 1, s, bo[c2][1]));
#pragma unroll
        for (int r = 0; r < kTA; ++r)
#pragma unroll
          for (int c2 = 0; c2 < kTB; ++c2) {
            V p = first_term(av[r], bv[c2], vs);
#pragma unroll
            for (int f = 2; f < M; ++f)
              p = mul_rn(p, to_v(staged<U, false>(st, d, f, s, bo[c2][f])));
            acc[r][c2] = add_rn(acc[r][c2], p);
          }
      }
    }
    __syncwarp();  // every lane is done with this buffer before it is refilled
#pragma unroll
    for (int i = 0; i < kStages; ++i) m[i] = m[i + 1];
  }
  end_row(true);
  if (by == 0 && lane == 0) {
    part_rows[2 * range] = head;
    part_rows[2 * range + 1] = tail;
  }
}

// Pass 2: blockIdx.x an entry of the scratch, blockIdx.y a tile of
// kCombineThreads columns, one a thread. The first entry of each row (the
// nearest entry before it with a row holds another one) sums that row's
// partials in range order and stores the row; entries of -1 hold nothing.
// A row split over many ranges (NIPS's last mode: ~180 a row) is summed by
// K / kCombineThreads CTAs at once, each thread's loads issued ahead of its
// adds.
template <typename V>
__global__ void __launch_bounds__(kCombineThreads)
    chain_combine_kernel(const V* __restrict__ part, const int* __restrict__ rows, int n_entries,
                         V* __restrict__ out, long long k_cols) {
  const int e = blockIdx.x;
  const int r = rows[e];
  if (r < 0) return;
  int p = e - 1;
  while (p >= 0 && rows[p] < 0) --p;
  if (p >= 0 && rows[p] == r) return;  // not the row's first partial
  int end = e + 1;                     // one past the row's last partial
  while (end < n_entries && (rows[end] < 0 || rows[end] == r)) ++end;
  const long long c = (long long)blockIdx.y * kCombineThreads + threadIdx.x;
  if (c >= k_cols) return;
  const V* src = part + c;
  V acc = src[(long long)e * k_cols];
  constexpr int kAhead = 8;
  for (int q0 = e + 1; q0 < end; q0 += kAhead) {
    V x[kAhead];
    bool mine[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {  // entries of -1 are loaded (allocated) and skipped
      const int q = min(q0 + i, end - 1);
      mine[i] = q0 + i < end && rows[q] == r;
      x[i] = src[(long long)q * k_cols];
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i)
      if (mine[i]) acc = add_rn(acc, x[i]);
  }
  out[(long long)r * k_cols + c] = acc;
}

// Element bytes of factor f for kind 0 (f32), 1 (bf16: f_1, f_2 in bf16,
// the later factors f32) or 2 (f64).
int elem_of(int kind, int f) { return kind == 2 ? 8 : (kind == 1 && f < 2) ? 2 : 4; }

// The staged strides and offsets (see Dims); false when the sizes are ones
// the kernel does not take. Tensor-core routes (kinds 0 and 1): whole m16 /
// n8-tile blocks in rows of a multiple of 16 elements (the swizzles'); CUDA
// cores (kind 2): f_1 in whole 4-column lane tiles, every row a multiple of
// 16 bytes.
bool dims_of(int kind, int m, const int* ranks, const int* lds, int bn, int bi, Dims* d) {
  if (m < 3 || m > kMaxOps || bn < 1 || bi < 1) return false;
  d->m = m, d->bn = bn, d->bi = bi;
  long long kb = 1;
  int off = 0;
  for (int f = 0; f < m; ++f) {
    const int elem = elem_of(kind, f), r = ranks[f], ld = lds[f];
    if (r < 1 || ld < r || ld % (16 / elem)) return false;
    int sl;
    if (kind != 2)
      sl = round_up(std::max(ld, round_up(r, 16)), 16);
    else
      sl = f == 0 ? round_up(std::max(ld, round_up(r, kTA)), 8) : round_up(ld, 8);
    d->r[f] = r, d->ld[f] = ld, d->sl[f] = sl, d->off[f] = off;
    off += kSlots * sl * elem;
    if (f > 0) kb *= r;
  }
  for (int f = m; f < kMaxOps; ++f) d->r[f] = d->ld[f] = d->sl[f] = d->off[f] = 0;
  if (kb * ranks[0] > (1LL << 30)) return false;
  d->kb = (int)kb;
  d->stage_bytes = off;
  return true;
}

// Blocks of Y's columns, one a blockIdx.y: m16 x (8 kNT) on the tensor-core
// routes, 32 lane tiles of kTA x kTB on the CUDA-core route.
int column_blocks(const Dims& d, bool tc) {
  return tc ? ((d.r[0] + 15) / 16) * ((d.kb + 8 * kNT - 1) / (8 * kNT))
            : (((d.r[0] + kTA - 1) / kTA) * ((d.kb + kTB - 1) / kTB) + 31) / 32;
}

struct Args {
  Factors fp;
  const int *idx, *rel, *blkmap;
  const void* vals;
  const long long* cuts;
  int n_ranges;
  void *out, *part;
  int* part_rows;
};

template <typename T, typename U, typename V, bool kTC, int M>
int launch_m(const Args& a, const Dims& d, int warps, dim3 grid, size_t smem, cudaStream_t st) {
  auto kernel = chain_scatter_kernel<T, U, V, kTC, M>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, warps * 32, smem, st>>>(a.fp, a.idx, static_cast<const V*>(a.vals), a.rel,
                                         a.blkmap, a.cuts, a.n_ranges, static_cast<V*>(a.out),
                                         static_cast<V*>(a.part), a.part_rows, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long k_cols = (long long)d.r[0] * d.kb;
  const dim3 grid2(2 * a.n_ranges, (unsigned)((k_cols + kCombineThreads - 1) / kCombineThreads));
  chain_combine_kernel<V><<<grid2, kCombineThreads, 0, st>>>(
      static_cast<const V*>(a.part), a.part_rows, 2 * a.n_ranges, static_cast<V*>(a.out), k_cols);
  return (int)cudaGetLastError();
}

template <typename T, typename U, typename V, bool kTC>
int launch(const Args& a, const Dims& d, int warps, dim3 grid, size_t smem, cudaStream_t st) {
  switch (d.m) {
    case 3: return launch_m<T, U, V, kTC, 3>(a, d, warps, grid, smem, st);
    case 4: return launch_m<T, U, V, kTC, 4>(a, d, warps, grid, smem, st);
    case 5: return launch_m<T, U, V, kTC, 5>(a, d, warps, grid, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Y (n_rows, K) of an order m + 1 tensor, zero-filled by the caller, f32
// (f64 for kind = 2), K = ranks[0] * ... * ranks[m - 1], 3 <= m <= 5.
// factors[f] (I_f, lds[f]) is the f-th operand factor matrix (the modes of
// layout.operand_modes), 16-byte aligned, rows zero-padded to 16 bytes:
// kind 0 all f32 (the tensor-core route), kind 1 factors 0 and 1 bf16 and
// the rest f32, kind 2 all f64. idx (nnzp, m) int32 holds each slot's row
// of every factor (kinds 0 and 1 on the tensor cores, 3xTF32 and 2xTF32,
// kind 2 on the CUDA cores); vals (nnzp,) the slot values, f32 (f64 for kind = 2), 0
// on padding; rel (nnzp,) and blkmap (nnzp / bn,) int32 the rows; cuts
// (n_ranges + 1,) int64 the equal-length slot ranges, one a warp. part
// (2 n_ranges, K) of Y's dtype and part_rows (2 n_ranges,) int32 are the
// partial-row scratch, neither read before written. Returns
// cudaGetLastError() after the two launches, or cudaErrorInvalidValue when
// the arguments are out of range or one warp's staging does not fit a
// CTA's shared memory.
extern "C" int kron_chain_scatter_launch(const void* const* factors, const int* ranks,
                                         const int* lds, int m, const void* idx, const void* vals,
                                         const void* rel, const void* blkmap, const void* cuts,
                                         int n_ranges, void* out, void* part, void* part_rows,
                                         int bn, int bi, int kind, void* stream) {
  if (kind < 0 || kind > 2 || n_ranges < 1) return (int)cudaErrorInvalidValue;
  Dims d;
  if (!dims_of(kind, m, ranks, lds, bn, bi, &d)) return (int)cudaErrorInvalidValue;
  const bool tc = kind != 2;
  int dev = 0, smem_max = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t per_warp = (size_t)kStages * d.stage_bytes;
  const int warps = (int)std::min<size_t>(kWarps, (size_t)smem_max / per_warp);
  const int blocks = column_blocks(d, tc);
  const long long k_cols = (long long)d.r[0] * d.kb;
  if (warps < 1 || blocks > 65535 || k_cols > 65535LL * kCombineThreads)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n_ranges + warps - 1) / warps, blocks);
  Args a;
  for (int f = 0; f < kMaxOps; ++f) a.fp.p[f] = f < m ? factors[f] : nullptr;
  a.idx = static_cast<const int*>(idx);
  a.rel = static_cast<const int*>(rel);
  a.blkmap = static_cast<const int*>(blkmap);
  a.vals = vals;
  a.cuts = static_cast<const long long*>(cuts);
  a.n_ranges = n_ranges;
  a.out = out;
  a.part = part;
  a.part_rows = static_cast<int*>(part_rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = per_warp * warps;
  if (kind == 1) return launch<__nv_bfloat16, float, float, true>(a, d, warps, grid, smem, st);
  if (kind == 2) return launch<double, double, double, false>(a, d, warps, grid, smem, st);
  return launch<float, float, float, true>(a, d, warps, grid, smem, st);
}
