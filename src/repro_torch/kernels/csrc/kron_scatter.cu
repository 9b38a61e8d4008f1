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
// Design: the warp walk of kron_walk.cuh (one warp per row-aligned range,
// 32-slot chunks gathered with cp.async into a two-stage swizzled ring, the
// row products on the tensor cores), whose row end stores the finished row.
// Rows no slot reaches stay as the wrapper's zero fill. fp32: mma.sync
// m16n8k8 3xTF32, 8 slots a block.
//
// bf16_fp32acc (T = bf16, V = float): the walk's bf16 tensor-core route,
// mma.sync m16n8k16 bf16, 16 slots a block: A = a^T (the bf16 factor rows,
// exact), B = v*b split into bf16 hi + lo, two products a block, f32 sums.
// The factor rows are staged in bf16 (64 B a slot at ranks 16, half of
// fp32's), so the gathers from L2 halve too; the operations, 2K + R_a a
// slot, are those of fp32 at twice the TF32 rate on the bf16 tensor cores,
// so the byte bound (1.1 ms a NELL-2 sweep) is the bound. Each term is
// a*b*v to ~2^-16, where the plain version rounds a*b to bf16 first (up to
// 2^-8 of the term): a deliberate departure, held by chip_smoke.py to the
// bf16_fp32acc limit (2e-2 x max|plain|).
//
// float64 (T = V = double): the walk's f64 tensor-core route (DMMA,
// mma.sync m16n8k8 .f64), with f64 factor rows, values, accumulators and
// output; the fp32 route's row logic and segmented sums, so no f64 atomics
// either, and one product a block where fp32 takes three. Per slot it reads
// 20 B from device memory, gathers 256 B of factor rows from L2 at ranks 16
// (twice the f32 bytes) and does 2K + Ra f64 operations: at NELL-2 size
// 1.2e11 a sweep, 1.8 ms at the f64 tensor-core peak (67 TFLOP/s). The ring
// holds twice the f32 bytes a warp (16 KB at ranks 16), so its CTAs have 4
// warps (kDmmaWarps) and three fit an SM: 12 warps resident, where 8-warp
// CTAs of the CUDA-core route left one CTA, 8 warps.
#include <type_traits>

#include "kron_walk.cuh"

namespace {

using kwalk::kStages;
using kwalk::kSlots;
using kwalk::kWarps;

// warps a CTA: kDmmaWarps on the f64 tensor-core route, else kWarps
template <typename T>
constexpr int kWarpsOf = std::is_same<T, double>::value ? kwalk::kDmmaWarps : kWarps;

// Three CTAs an SM, as many as the rings' shared memory allows: left to
// itself ptxas spends registers on the walk until only two fit, and kernel
// 1 loses time (chip_smoke.py prints the registers of each build).
template <typename T, typename V>
__global__ void __launch_bounds__(kWarpsOf<T> * 32, 3)
    kron_scatter_kernel(const T* __restrict__ fa, const T* __restrict__ fb,
                        const int* __restrict__ idx, const V* __restrict__ vals,
                        const int* __restrict__ rel, const int* __restrict__ blkmap,
                        const long long* __restrict__ parts, V* __restrict__ out, int n_parts,
                        const kwalk::Shape sh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int part = blockIdx.x * (blockDim.x / 32) + warp;
  if (part >= n_parts) return;  // a whole warp: no shuffle is left waiting
  const int stage_elems = kSlots * (sh.sla + sh.slb);
  T* ring = reinterpret_cast<T*>(smem_raw) + (size_t)warp * kStages * stage_elems;
  kwalk::zero_ring(ring, kStages * stage_elems, lane);

  const long long k_cols = (long long)sh.ra * sh.rb;
  const int ra = sh.ra, rb = sh.rb, g = lane / 4, t = lane % 4;
  const kwalk::Tile<V> tile(ra, rb, blockIdx.y);
  auto store_row = [&](int row, const typename kwalk::Tile<V>::Acc& acc) {
    V* o = out + (long long)row * k_cols;
#pragma unroll
    for (int q = 0; q < kwalk::kNT; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = tile.a0c + g + 8 * (e >> 1), j = tile.b0c + 8 * q + 2 * t + (e & 1);
        if (i < ra && j < rb) o[(long long)i * rb + j] = acc[q][e];
      }
  };
  kwalk::walk<T>(fa, fb, idx, vals, rel, blkmap, sh, parts[part], parts[part + 1], ring,
                      tile, lane, store_row, [] {});
}

template <typename T, typename V>
int launch(const void* fa, const void* fb, const int* ip, const void* vp, const int* relp,
           const int* blk, const long long* pp, void* o, int n_parts, const kwalk::Shape& sh,
           int warps, dim3 grid, size_t smem, cudaStream_t st) {
  auto kernel = kron_scatter_kernel<T, V>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, warps * 32, smem, st>>>(static_cast<const T*>(fa), static_cast<const T*>(fb),
                                         ip, static_cast<const V*>(vp), relp, blk, pp,
                                         static_cast<V*>(o), n_parts, sh);
  return (int)cudaGetLastError();
}

// The registers a thread and the CTAs an SM of the kernel of one kind at a
// CTA of `warps` warps and `smem` bytes of dynamic shared memory.
template <typename T, typename V>
int occupancy(int warps, size_t smem, int* regs, int* per_sm) {
  auto kernel = kron_scatter_kernel<T, V>;
  cudaFuncAttributes attr{};
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, warps * 32, smem);
  *regs = attr.numRegs;
  return (int)err;
}

// The staged strides, warps a CTA and shared memory a CTA of one kind at
// these ranks: as many warps as fit, up to the kind's CTA size (kWarpsOf).
bool config_of(int ra, int rb, int lda, int ldb, int kind, kwalk::Shape* sh, int* warps,
               size_t* smem) {
  const int elem = kind == 1 ? 2 : kind == 2 ? 8 : 4;
  kwalk::staged_strides(ra, rb, lda, ldb, &sh->sla, &sh->slb);
  int dev = 0, smem_max = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t per_warp = (size_t)kStages * kSlots * (sh->sla + sh->slb) * elem;
  const int most = kind == 2 ? kWarpsOf<double> : kWarps;
  *warps = (int)std::min<size_t>(most, (size_t)smem_max / per_warp);
  *smem = per_warp * *warps;
  return *warps >= 1;
}

}  // namespace

// Y (n_rows, ra*rb), zero-filled by the caller, f32 (f64 for kind = 2).
// fa (I_a, lda) and fb (I_b, ldb) are the factor matrices, f32 (kind = 0:
// 3xTF32), bf16 (kind = 1: bf16 m16n8k16) or f64 (kind = 2: DMMA), their rows
// zero-padded to 16 bytes (lda, ldb multiples of 4 in f32, 8 in bf16, 2 in
// f64) and 16-byte aligned; fb is null with rb = 1 and ldb = 0 for a 2-way
// tensor. idx (nnzp, idx_cols) int32 holds each slot's row of fa (column
// 0) and of fb (column 1); vals (nnzp,) the slot values, f32 (f64 for
// kind = 2), 0 on padding; rel (nnzp,) and blkmap (nnzp/bn,) int32
// the rows; parts (n_parts + 1,) int64 row-aligned slot ranges, one per
// warp. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue when the arguments are out of range or one warp's
// staging does not fit a CTA's shared memory.
extern "C" int kron_scatter_launch(const void* fa, const void* fb, const void* idx,
                                   const void* vals, const void* rel, const void* blkmap,
                                   const void* parts, void* out, int n_parts, int ra, int rb,
                                   int lda, int ldb, int idx_cols, int bn, int bi, int kind,
                                   void* stream) {
  if (kind < 0 || kind > 2) return (int)cudaErrorInvalidValue;
  const int elem = kind == 1 ? 2 : kind == 2 ? 8 : 4;
  if (n_parts < 1 || !kwalk::shapes_ok(ra, rb, lda, ldb, idx_cols, bn, bi, 16 / elem))
    return (int)cudaErrorInvalidValue;
  kwalk::Shape sh{ra, rb, lda, ldb, 0, 0, idx_cols, bn, bi};
  int warps;
  size_t smem;
  if (!config_of(ra, rb, lda, ldb, kind, &sh, &warps, &smem)) return (int)cudaErrorInvalidValue;
  const dim3 grid((n_parts + warps - 1) / warps, kwalk::column_blocks(ra, rb));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ip = static_cast<const int*>(idx);
  const int* relp = static_cast<const int*>(rel);
  const int* blk = static_cast<const int*>(blkmap);
  const long long* pp = static_cast<const long long*>(parts);
  if (kind == 1)
    return launch<__nv_bfloat16, float>(fa, fb, ip, vals, relp, blk, pp, out, n_parts, sh,
                                              warps, grid, smem, st);
  if (kind == 2)
    return launch<double, double>(fa, fb, ip, vals, relp, blk, pp, out, n_parts, sh,
                                        warps, grid, smem, st);
  return launch<float, float>(fa, fb, ip, vals, relp, blk, pp, out, n_parts, sh, warps,
                                    grid, smem, st);
}

// The launch kron_scatter_launch makes for one kind at these ranks (its
// arguments' meaning): threads a CTA, dynamic shared memory a CTA, the
// kernel's registers a thread and the CTAs one SM holds. Returns a CUDA
// error code, cudaErrorInvalidValue when the launch would refuse the sizes.
extern "C" int kron_scatter_occupancy(int ra, int rb, int lda, int ldb, int kind, int* threads,
                                      long long* smem, int* regs, int* per_sm) {
  *threads = *regs = *per_sm = 0;
  *smem = 0;
  if (kind < 0 || kind > 2) return (int)cudaErrorInvalidValue;
  const int elem = kind == 1 ? 2 : kind == 2 ? 8 : 4;
  kwalk::Shape sh{ra, rb, lda, ldb, 0, 0, 1, 1, 1};
  int warps;
  size_t bytes;
  if (!kwalk::shapes_ok(ra, rb, lda, ldb, 1, 1, 1, 16 / elem) ||
      !config_of(ra, rb, lda, ldb, kind, &sh, &warps, &bytes))
    return (int)cudaErrorInvalidValue;
  *threads = warps * 32;
  *smem = (long long)bytes;
  if (kind == 1) return occupancy<__nv_bfloat16, float>(warps, bytes, regs, per_sm);
  if (kind == 2) return occupancy<double, double>(warps, bytes, regs, per_sm);
  return occupancy<float, float>(warps, bytes, regs, per_sm);
}
