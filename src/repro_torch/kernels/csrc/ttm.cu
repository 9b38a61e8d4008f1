// Core TTM, G = Y U^T, as one deterministic launch, for sm_90a.
//
// Replaces: src/repro/kernels/ttm_kernel.py :: ttm_pallas (_ttm_kernel), the
// TPU kernel that computes G = Y @ U^T for y (L, I) and u (R, I) with an f32
// accumulator, tiled BL x BK over the contraction.
//
// What bounds it on this card: bytes. On the HOOI path L = prod R_t = 256,
// R = 16 and I = I_N is up to ~29 K: one pass over a 29.5 MB unfolding for
// 2*L*R*I = 0.24 GFLOP, about 9 us of reads against 4 us of f32 math on the
// CUDA cores (tensor cores would need 3xTF32 for an f32 result and buy
// nothing on a product this byte-bound).
//
// Design. One launch over a grid sized from the SM count (one CTA per SM):
// CTA c owns output tile c / n_splits (kBL x kBR, 16 outputs a thread) and
// the contiguous contraction range split * chunk .. of c % n_splits. On the
// path's layout each contraction index is one contiguous row of y (1 KB)
// and of u (64 B); the CTA streams its range through a kStages-deep ring of
// kBT-row steps filled by bulk copies (cp.async.bulk, completion on an
// mbarrier), up to ~170 KB in flight per SM. Other layouts take a strided
// staging path in the same kernel, each loop walking the operand along its
// unit-stride axis. The partial sums then meet in a fixed order without
// atomics on the data: each CTA writes its tile partial to its slot; the
// last CTA of each group of consecutive splits (an atomic ticket per group)
// sums the group's slots in slot order into a group slot, and the last group
// to finish sums the group slots in group order into G. Whichever CTA comes
// last, the sums are the same, so the bits are the same on every run. The
// last CTA resets the tickets, so the counters stay zero between launches.
//
// float64: the same launch and ring, with f64 operands, slots and output
// (A = double below), the products on the f64 tensor cores and the splits
// combined through thread-block clusters.
//   * Products: DMMA, mma.sync m16n8k8 .f64 (tc::mma_f64). Warp w owns rows
//     32 w .. 32 w + 31 of the tile (two m16 tiles) by its 16 columns (two
//     n8 tiles), A = y (rows l, k the contraction), B = u^T, accumulated in
//     contraction order into f64 fragments (32 registers a thread; the
//     CUDA-core tile of 4 x 4 outputs a thread made 8 shared loads for every
//     16 FMAs). The staged rows are padded by kRowPad = 4 doubles, so that a
//     fragment load, 4 contraction rows x 8 columns of 8 bytes served as two
//     half-warps, meets no bank conflict: row stride 260 = 4 (mod 16) bank
//     pairs puts column g of row t on pair 4t + g. The padding rules out the
//     4-row bulk copies: each staged row is a copy of its own. Contraction
//     indices past a step's end are masked to 0 in both fragments. The ring
//     keeps 3 stages of 32 rows (kStagesOf<double>, 210 KB).
//   * Combine. Measured on an H100 (tools/probe_f64.py --ttm-anatomy), the
//     f32 path's combine left ~25 us a call besides streaming the bytes,
//     most of it the two serial gathers of whole 32 KB tile partials by one CTA each
//     (a group of ~12 splits, then ~11 groups). Here kCluster = 8
//     consecutive splits form a cluster (n_splits a multiple of 8, the
//     splits past I empty): each CTA puts its partial in its shared memory,
//     CTA `rank` of the cluster sums part `rank` of the tile (kTile / 8
//     elements) over the 8 shared memories in rank order (distributed
//     shared memory) and writes it to the cluster's slot; the last CTA to
//     write part `rank` (a ticket a part) sums that part of the n_splits / 8
//     cluster slots in cluster order into G. The final level so runs on 8
//     SMs at once and reads 1/8 of a tile each; the order of every sum is
//     fixed, so the bits are the same on every run, and no CTA waits on
//     another outside its cluster. ttm_cluster_capacity gives the clusters
//     a card holds at once (one CTA an SM), from which ttm_kernel.py sizes
//     the split.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include <type_traits>

#include "tc_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBL = 256;       // output rows per tile
constexpr int kBR = 16;        // output columns per tile
constexpr int kBT = 32;        // contraction indices per staging step
constexpr int kThreads = 256;  // thread t: rows 4 (t % 64) .. + 3, columns 4 (t / 64) .. + 3
constexpr int kTile = kBL * kBR;
constexpr int kCluster = 8;  // f64: the CTAs of a cluster, whose partials meet in shared memory

// ring depth of the bulk-copy path: ~200 KB of operands in flight per SM
template <typename T>
constexpr int kStagesOf = sizeof(T) == 8 ? 3 : 6;
// f64 runs its products on the tensor cores (DMMA), with staged rows padded
// by kRowPad elements; the other types on the CUDA cores, unpadded
template <typename T>
constexpr bool kDmmaOf = std::is_same<T, double>::value;
constexpr int kRowPad = 4;
template <typename T>
constexpr int kYsOf = kDmmaOf<T> ? kBL + kRowPad : kBL;  // staged y row stride
template <typename T>
constexpr int kUsOf = kDmmaOf<T> ? kBR + kRowPad : kBR;  // staged u row stride
// the accumulator, slot and output type: f64 for f64 operands, else f32
template <typename T>
struct AccOf {
  using type = float;
};
template <>
struct AccOf<double> {
  using type = double;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  x[0] = a.x, x[1] = a.y, x[2] = b.x, x[3] = b.y;
}
__device__ __forceinline__ void load4(const double* p, double (&x)[4]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  x[0] = a.x, x[1] = a.y, x[2] = b.x, x[3] = b.y;
}

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return fma(a, b, c); }

// four consecutive accumulator-type values of global or shared memory as
// 16-byte accesses (one for f32, two for f64); p 16-byte aligned
__device__ __forceinline__ void store4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(double* p, const double (&x)[4]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(x[0], x[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(x[2], x[3]);
}
// the combine's loads of other CTAs' slots, through L2 (cache-global)
__device__ __forceinline__ void load4_cg(const float* p, float (&x)[4]) {
  const float4 v = __ldcg(reinterpret_cast<const float4*>(p));
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}
__device__ __forceinline__ void load4_cg(const double* p, double (&x)[4]) {
  const double2 a = __ldcg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldcg(reinterpret_cast<const double2*>(p) + 1);
  x[0] = a.x, x[1] = a.y, x[2] = b.x, x[3] = b.y;
}

// ticket per group, then the final ticket of the tile; returns whether this
// CTA drew the last one (the same answer in every thread)
__device__ __forceinline__ bool last_to_arrive(int* counter, int n) {
  __shared__ int last;
  __threadfence();  // this CTA's slot writes before its ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1) == n - 1;
  __syncthreads();
  if (last) __threadfence();  // and the other CTAs' slots before our reads
  return last;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    ttm_kernel(const T* __restrict__ y, long long sy0, long long sy1, const T* __restrict__ u,
               long long su0, long long su1, typename AccOf<T>::type* __restrict__ slots,
               int* __restrict__ tickets, typename AccOf<T>::type* __restrict__ out, int L, int I,
               int R, int chunk, int n_splits, int group, int bulk) {
  using A = typename AccOf<T>::type;
  constexpr int kStages = kStagesOf<T>;
  constexpr int YS = kYsOf<T>, US = kUsOf<T>;
  extern __shared__ __align__(128) uint8_t smem[];
  T* ys = reinterpret_cast<T*>(smem);  // [kStages][kBT][YS]
  T* us = ys + kStages * kBT * YS;     // [kStages][kBT][US]
  uint64_t* full = reinterpret_cast<uint64_t*>(us + kStages * kBT * US);

  const int tid = threadIdx.x;
  const int n_ltiles = (L + kBL - 1) / kBL;
  const int tile = blockIdx.x / n_splits, split = blockIdx.x % n_splits;
  const int l0 = (tile % n_ltiles) * kBL, r0 = (tile / n_ltiles) * kBR;
  const int nl = min(kBL, L - l0), nr = min(kBR, R - r0);
  const int i0 = split * chunk, i1 = min(I, i0 + chunk);
  const int n_steps = (i1 - i0 + kBT - 1) / kBT;
  const int lq = 4 * (tid % 64), rq = 4 * (tid / 64);
  A acc[4][4] = {};
  // DMMA: warp w's rows lw .. lw + 31, lane (g, t); dacc[m][n] is the
  // m16n8k8 fragment of rows lw + 16 m, columns 8 n
  const int g = (tid % 32) / 4, t = tid % 4, lw = 32 * (tid / 32);
  double dacc[2][2][4] = {};

  auto compute = [&](const T* yst, const T* ust, int nt) {
    if constexpr (kDmmaOf<T>) {
      for (int k0 = 0; k0 < nt; k0 += 8) {
        // contraction rows k0 + t and k0 + t + 4; those at or past nt are 0
        const int k1 = k0 + t, k2 = k1 + 4;
        const bool in1 = k1 < nt, in2 = k2 < nt;
        const T* y1 = yst + k1 * YS + lw + g;
        const T* y2 = yst + k2 * YS + lw + g;
        double a[2][4], b[2][2];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          a[m][0] = in1 ? y1[16 * m] : 0.0;
          a[m][1] = in1 ? y1[16 * m + 8] : 0.0;
          a[m][2] = in2 ? y2[16 * m] : 0.0;
          a[m][3] = in2 ? y2[16 * m + 8] : 0.0;
        }
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          b[n][0] = in1 ? ust[k1 * US + 8 * n + g] : 0.0;
          b[n][1] = in2 ? ust[k2 * US + 8 * n + g] : 0.0;
        }
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int n = 0; n < 2; ++n) tc::mma_f64(dacc[m][n], a[m], b[n]);
      }
    } else {
      for (int tt = 0; tt < nt; ++tt) {
        A a[4], b[4];
        load4(yst + tt * kBL + lq, a);
        load4(ust + tt * kBR + rq, b);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fma_rn(a[i], b[j], acc[i][j]);
      }
    }
  };

  if (bulk) {
    // y rows of nl and u rows of nr contiguous elements, 16-byte aligned
    if (tid == 0) {
      for (int s = 0; s < kStages; ++s)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(&full[s])) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    // a step's rows are one contiguous block where the tile spans whole rows
    // of a dense operand (the sweep's y and u) and the staged rows are not
    // padded: a few large copies; else a copy per row
    const bool y_block = !kDmmaOf<T> && l0 == 0 && sy1 == nl && nl == kBL;
    const bool u_block = !kDmmaOf<T> && r0 == 0 && su1 == nr && nr == kBR;
    // warp 0 fills stage s % kStages with step s: lane 0 posts the bytes,
    // then the lanes issue the copies
    auto issue = [&](int s) {
      const int st = s % kStages, ib = i0 + s * kBT, nt = min(kBT, i1 - ib);
      const uint32_t bar = smem_u32(&full[st]);
      const uint32_t yb = nl * sizeof(T), ub = nr * sizeof(T);
      if (tid == 0) {
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
                     "r"(nt * (yb + ub))
                     : "memory");
      }
      __syncwarp();
      auto copy = [&](const T* dst, const T* src, uint32_t bytes) {
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
            "[%3];" ::"r"(smem_u32(dst)),
            "l"(src), "r"(bytes), "r"(bar)
            : "memory");
      };
      const T* ysrc = y + (long long)ib * sy1 + l0;
      const T* usrc = u + (long long)ib * su1 + r0;
      if (y_block) {  // 4-row (4 KB) copies, several in flight per step
        for (int c = 4 * tid; c < nt; c += 4 * 32)
          copy(ys + (st * kBT + c) * YS, ysrc + (long long)c * sy1, min(4, nt - c) * yb);
      } else {
        for (int tt = tid; tt < nt; tt += 32)
          copy(ys + (st * kBT + tt) * YS, ysrc + (long long)tt * sy1, yb);
      }
      if (u_block) {
        if (tid == 1) copy(us + st * kBT * US, usrc, nt * ub);
      } else {
        for (int tt = tid; tt < nt; tt += 32)
          copy(us + (st * kBT + tt) * US, usrc + (long long)tt * su1, ub);
      }
    };
    if (tid < 32)
      for (int s = 0; s < min(kStages - 1, n_steps); ++s) issue(s);
    for (int s = 0; s < n_steps; ++s) {
      // stage (s - 1) % kStages was released by the barrier ending step s - 1
      if (tid < 32 && s + kStages - 1 < n_steps) issue(s + kStages - 1);
      const int st = s % kStages;
      const uint32_t parity = (s / kStages) & 1;
      uint32_t done = 0;
      for (uint32_t polls = 0; !done; ++polls) {
        if (polls == 0x80000000u) __trap();  // a launch failure, not a hang
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(smem_u32(&full[st])), "r"(parity)
            : "memory");
      }
      compute(ys + st * kBT * YS, us + st * kBT * US, min(kBT, i1 - (i0 + s * kBT)));
      __syncthreads();
    }
  } else {
    // strided staging into stage 0; zeros past nl and nr
    for (int s = 0; s < n_steps; ++s) {
      const int ib = i0 + s * kBT, nt = min(kBT, i1 - ib);
      for (int e = tid; e < kBT * kBL; e += kThreads) {
        int tt, ll;
        if (sy0 <= sy1) { ll = e % kBL; tt = e / kBL; } else { tt = e % kBT; ll = e / kBT; }
        ys[tt * YS + ll] =
            tt < nt && ll < nl ? y[(long long)(l0 + ll) * sy0 + (long long)(ib + tt) * sy1] : T(0.f);
      }
      for (int e = tid; e < kBT * kBR; e += kThreads) {
        int tt, rr;
        if (su0 <= su1) { rr = e % kBR; tt = e / kBR; } else { tt = e % kBT; rr = e / kBT; }
        us[tt * US + rr] =
            tt < nt && rr < nr ? u[(long long)(r0 + rr) * su0 + (long long)(ib + tt) * su1] : T(0.f);
      }
      __syncthreads();
      compute(ys, us, nt);
      __syncthreads();
    }
  }

  A* tile_s = reinterpret_cast<A*>(smem);
  if constexpr (kDmmaOf<T>) {
    // f64: the partial goes to shared memory, row-major (kBL, kBR); the
    // cluster's kCluster partials are summed there, each CTA summing part
    // `rank` of the tile (kTile / kCluster elements) over the cluster's
    // shared memories in rank order; the cluster writes its sum to its slot,
    // one part a CTA, and the last CTA of each part to arrive (a ticket a
    // part) sums that part of the slots in cluster order into G. No CTA
    // waits on another outside its cluster, so the last level runs on
    // kCluster SMs at once where one CTA summed whole tiles.
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h)  // rows g, g + 8: columns 2t, 2t + 1
          *reinterpret_cast<double2*>(tile_s + (lw + 16 * m + g + 8 * h) * kBR + 8 * n + 2 * t) =
              make_double2(dacc[m][n][2 * h], dacc[m][n][2 * h + 1]);
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    cluster.sync();  // every partial of the cluster is in its CTA's shared memory
    constexpr int kPer = kTile / kCluster, kEach = kPer / kThreads;
    double part[kEach];
#pragma unroll
    for (int k = 0; k < kEach; ++k) {
      const int e = rank * kPer + k * kThreads + tid;
      double sum = 0.0;
#pragma unroll
      for (int j = 0; j < kCluster; ++j) sum += cluster.map_shared_rank(tile_s, j)[e];
      part[k] = sum;
    }
    cluster.sync();  // no CTA leaves while another reads its shared memory
    // flat element e is row e / kBR, column e % kBR of the tile
    const long long lr = (long long)L * R;
    auto at = [&](int e) { return (long long)(l0 + e / kBR) * R + r0 + e % kBR; };
    auto inside = [&](int e) { return e / kBR < nl && e % kBR < nr; };
    const int n_clusters = n_splits / kCluster;
    A* dst = n_clusters == 1 ? out : slots + (long long)(split / kCluster) * lr;
#pragma unroll
    for (int k = 0; k < kEach; ++k) {
      const int e = rank * kPer + k * kThreads + tid;
      if (inside(e)) dst[at(e)] = part[k];
    }
    if (n_clusters == 1) return;
    int* tk = tickets + (long long)tile * kCluster;
    if (!last_to_arrive(&tk[rank], n_clusters)) return;
#pragma unroll
    for (int k = 0; k < kEach; ++k) {
      const int e = rank * kPer + k * kThreads + tid;
      if (!inside(e)) continue;
      double sum = 0.0;
      for (int c = 0; c < n_clusters; ++c) sum += __ldcg(slots + c * lr + at(e));
      out[at(e)] = sum;
    }
    if (tid == 0) tk[rank] = 0;
  } else {
    // The combine works on a flat view of the tile: thread t holds elements
    // 4 (t + kThreads k) .. + 3 (k < 4) of the row-major (kBL, kBR) tile,
    // so a warp reads or writes 512 contiguous bytes of a slot at a time.
    // The partial moves to that view through shared memory (the ring is
    // free).
#pragma unroll
    for (int i = 0; i < 4; ++i) store4(tile_s + (lq + i) * kBR + rq, acc[i]);
    __syncthreads();
    A flat[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const A* p = tile_s + 4 * (tid + kThreads * k);
#pragma unroll
      for (int e = 0; e < 4; ++e) flat[k][e] = p[e];
    }
    // element 4 (tid + kThreads k) + e is row fl(k), column fc(k) + e of the tile
    auto fl = [&](int k) { return 4 * (tid + kThreads * k) / kBR; };
    auto fc = [&](int k) { return 4 * (tid + kThreads * k) % kBR; };
    const long long lr = (long long)L * R;
    auto at = [&](int k) { return (long long)(l0 + fl(k)) * R + r0 + fc(k); };
    // four columns as one 16-byte access where they are whole and aligned
    auto whole = [&](int k) { return R % 4 == 0 && fc(k) + 4 <= nr; };
    auto put = [&](A* dst) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (fl(k) >= nl) continue;
        A* p = dst + at(k);
        if (whole(k)) {
          store4(p, flat[k]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (fc(k) + e < nr) p[e] = flat[k][e];
        }
      }
    };
    // flat = the sum of slots 0 .. n - 1 of src, in slot order; four slots'
    // loads are in flight at a time, the adds stay in order
    auto gather = [&](const A* src, int n) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) flat[k][e] = A(0);
      for (int c0 = 0; c0 < n; c0 += 4) {
        A x[4][4][4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const A* p = src + (c0 + c) * lr + at(k);
            const bool row = c0 + c < n && fl(k) < nl;
            if (whole(k)) {
              if (row) {
                load4_cg(p, x[c][k]);
              } else {
#pragma unroll
                for (int e = 0; e < 4; ++e) x[c][k][e] = A(0);
              }
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e) x[c][k][e] = row && fc(k) + e < nr ? __ldcg(p + e) : A(0);
            }
          }
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (c0 + c < n) flat[k][e] += x[c][k][e];
      }
    };
    if (n_splits == 1) {
      put(out);
      return;
    }
    const int n_groups = (n_splits + group - 1) / group;
    const int grp = split / group, g0 = grp * group, gn = min(group, n_splits - g0);
    int* tk = tickets + (long long)tile * (n_groups + 1);
    put(slots + split * lr);
    if (!last_to_arrive(&tk[grp], gn)) return;
    gather(slots + g0 * lr, gn);
    if (tid == 0) tk[grp] = 0;
    if (n_groups == 1) {
      put(out);
      return;
    }
    put(slots + (n_splits + grp) * lr);
    if (!last_to_arrive(&tk[n_groups], n_groups)) return;
    gather(slots + n_splits * lr, n_groups);
    if (tid == 0) tk[n_groups] = 0;
    put(out);
  }
}

long long n_launched = 0;  // kernels this library has launched

template <typename T>
size_t smem_bytes() {
  return (size_t)kStagesOf<T> * kBT * (kYsOf<T> + kUsOf<T>) * sizeof(T) +
         kStagesOf<T> * sizeof(uint64_t);
}

template <typename T>
int launch(const void* y, long long sy0, long long sy1, const void* u, long long su0,
           long long su1, void* slots, void* tickets, void* out, int L, int I, int R, int chunk,
           int n_splits, int group, int bulk, cudaStream_t st) {
  using A = typename AccOf<T>::type;
  auto kernel = ttm_kernel<T>;
  const size_t smem = smem_bytes<T>();
  static bool attr_set[64] = {};  // per device, once: it is a host call of its own
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= 64 || !attr_set[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (device < 64) attr_set[device] = true;
  }
  const int n_tiles = ((L + kBL - 1) / kBL) * ((R + kBR - 1) / kBR);
  const unsigned n_ctas = (unsigned)((long long)n_tiles * n_splits);
  if constexpr (kDmmaOf<T>) {  // clusters of kCluster consecutive splits
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(n_ctas), cfg.blockDim = dim3(kThreads), cfg.dynamicSmemBytes = smem;
    cfg.stream = st, cfg.attrs = attr, cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(y), sy0, sy1,
                             static_cast<const T*>(u), su0, su1, static_cast<A*>(slots),
                             static_cast<int*>(tickets), static_cast<A*>(out), L, I, R, chunk,
                             n_splits, group, bulk);
    if (err != cudaSuccess) return (int)err;
  } else {
    kernel<<<n_ctas, kThreads, smem, st>>>(
        static_cast<const T*>(y), sy0, sy1, static_cast<const T*>(u), su0, su1,
        static_cast<A*>(slots), static_cast<int*>(tickets), static_cast<A*>(out), L, I, R, chunk,
        n_splits, group, bulk);
  }
  const cudaError_t err_launch = cudaGetLastError();
  if (err_launch == cudaSuccess) ++n_launched;
  return (int)err_launch;
}

}  // namespace

// device kernels launched by ttm_launch so far (one per successful call)
extern "C" long long ttm_kernels_launched() { return n_launched; }

// The clusters of the f64 kernel (kind = 2) that one card holds at once
// (cudaOccupancyMaxActiveClusters: clusters of *cluster = kCluster CTAs, one
// CTA an SM), from which the wrapper sizes its split. Returns a CUDA error
// code.
extern "C" int ttm_cluster_capacity(int* cluster, int* max_clusters) {
  *cluster = kCluster;
  *max_clusters = 0;
  auto kernel = ttm_kernel<double>;
  const size_t smem = smem_bytes<double>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(kCluster), cfg.blockDim = dim3(kThreads), cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr, cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
}

// out (L, R) contiguous = y (L, I) @ u (R, I)^T, y and u read through
// their element strides, f32 (kind = 0), bf16 (kind = 1) or f64 (kind =
// 2); out and slots are f64 for kind = 2, else f32. Split s of n_splits
// covers contraction indices [s*chunk, min(I, (s+1)*chunk)). f32 and bf16:
// splits are combined in groups of ``group``; slots holds (n_splits +
// n_groups) x L x R values and tickets n_tiles x (n_groups + 1) ints. f64:
// group = kCluster (ttm_cluster_capacity), n_splits a multiple of it (the
// splits past I empty), splits combined in clusters of group; slots holds
// (n_splits / group) x L x R values (none for one cluster) and tickets
// n_tiles x group ints. Tickets are all zero on entry (and left zero). bulk
// = 1 needs sy0 = su0 = 1 and every row start and length 16-byte aligned.
// Returns cudaGetLastError() after the launch.
extern "C" int ttm_launch(const void* y, long long sy0, long long sy1, const void* u,
                          long long su0, long long su1, void* slots, void* tickets, void* out,
                          int L, int I, int R, int chunk, int n_splits, int group, int bulk,
                          int kind, void* stream) {
  if (kind < 0 || kind > 2 || L < 1 || I < 1 || R < 1 || chunk < 1 || n_splits < 1 ||
      group < 1 || (bulk && (sy0 != 1 || su0 != 1)))
    return (int)cudaErrorInvalidValue;
  const long long need = (I + (long long)chunk - 1) / chunk;  // splits that hold indices
  if (kind == 2 ? group != kCluster || n_splits % kCluster || n_splits < need ||
                      n_splits >= need + kCluster
                : n_splits != need)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 1)
    return launch<__nv_bfloat16>(y, sy0, sy1, u, su0, su1, slots, tickets, out, L, I, R, chunk,
                                 n_splits, group, bulk, st);
  if (kind == 2)
    return launch<double>(y, sy0, sy1, u, su0, su1, slots, tickets, out, L, I, R, chunk,
                          n_splits, group, bulk, st);
  return launch<float>(y, sy0, sy1, u, su0, su1, slots, tickets, out, L, I, R, chunk, n_splits,
                       group, bulk, st);
}

// The launch ttm_launch makes for one kind (its codes): threads a CTA,
// dynamic shared memory a CTA, the kernel's registers a thread and the CTAs
// one SM holds. Returns a CUDA error code.
extern "C" int ttm_occupancy(int kind, int* threads, long long* smem, int* regs, int* per_sm) {
  *threads = *regs = *per_sm = 0;
  *smem = 0;
  if (kind < 0 || kind > 2) return (int)cudaErrorInvalidValue;
  auto query = [&](auto kernel, size_t bytes) {
    cudaFuncAttributes attr{};
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreads, bytes);
    *threads = kThreads;
    *smem = (long long)bytes;
    *regs = attr.numRegs;
    return (int)err;
  };
  if (kind == 1) return query(ttm_kernel<__nv_bfloat16>, smem_bytes<__nv_bfloat16>());
  if (kind == 2) return query(ttm_kernel<double>, smem_bytes<double>());
  return query(ttm_kernel<float>, smem_bytes<float>());
}
