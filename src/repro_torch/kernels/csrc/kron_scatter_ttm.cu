// Fused core update G = U^T Y_(n), Y rebuilt from the nonzeros and never
// stored, for sm_90a.
//
// Replaces: src/repro/kernels/kron_kernel.py :: fused_kron_scatter_ttm_pallas
// (_mega_kernel via _mega_call), the TPU kernel that streams the
// schedule-ordered nonzeros, rebuilds each row block of
//     Y_(n)[row(t)] += v[t] * (a[t] (x) b[t])      (Rb fastest, K = Ra*Rb)
// in VMEM scratch, and at each row block's last nnz block adds
// U[rows]^T Y[rows] into one (R, K) accumulator that stays resident across
// the whole sequential grid.
//
// What bounds it on this card: bytes. It reads what csrc/kron_scatter.cu
// reads (the gathered a and b rows, v, the schedule) plus U, and writes only
// the (R, K) core: at NELL-2 size about 10.5 GB read for 3*nnz*K + 2*I*R*K
// flops, a bound of ~3 ms on bytes against ~0.6 ms on f32 flops.
//
// Design. CTAs run in no order, so nothing can carry across them the way
// the TPU grid carries its accumulator. Instead:
//   * the grid is bounded by what the card holds at once (a few CTAs per
//     SM, from the occupancy query of kron_scatter_ttm_grid), and CTA x
//     owns a contiguous run of the row-aligned slot ranges of
//     sparse/layout.py::row_parts, so every row lies in exactly one CTA;
//   * inside a CTA, each row's y is summed in registers by
//     kron_common.cuh's walk_rows, as csrc/kron_scatter.cu does (a thread
//     owns one column j of b and four columns i of a; K is tiled over
//     blockIdx.y);
//   * when the row ends, the thread adds U[row, r] * y into its own
//     columns of a per-CTA (R, K) partial in shared memory (float4 per r,
//     no bank conflicts, no sharing between threads);
//   * at the end the CTA writes its partial to part[x] of an
//     [n_ctas, R, K] buffer, and a second kernel sums the buffer in CTA
//     order (each warp a fixed stride of CTAs, then the warps in order).
// No atomics anywhere, so the result is the same bit for bit on every run.
// Padding slots alias row 0 of their group with value 0; the walk never
// ends a row on them, so no row is contracted twice, wherever the range
// cuts fall. Under bf16_fp32acc a, b and U arrive as bf16 (the TPU kernel
// rounds U to bf16 as well); the Kron terms are rounded as kron_common.cuh
// says, and the contraction is f32.
#include "kron_common.cuh"

namespace {

using kron::kQI;
using kron::to_f32;

constexpr int kReduceWarps = 8;  // warps per CTA of the second pass

template <typename T>
__device__ __forceinline__ void contract_row(float4* sg, const T* __restrict__ u, int row, int r,
                                             int stride4, const float* acc) {
  const T* ur = u + (long long)row * r;
  for (int q = 0; q < r; ++q) {
    const float uq = to_f32(ur[q]);
    float4 g = sg[q * stride4];
    g.x = fmaf(uq, acc[0], g.x);
    g.y = fmaf(uq, acc[1], g.y);
    g.z = fmaf(uq, acc[2], g.z);
    g.w = fmaf(uq, acc[3], g.w);
    sg[q * stride4] = g;
  }
}

template <typename T, bool kBf16>
__global__ void kron_scatter_ttm_kernel(const T* __restrict__ a, const T* __restrict__ b,
                                        const float* __restrict__ v, const int* __restrict__ rel,
                                        const int* __restrict__ blkmap,
                                        const long long* __restrict__ parts,
                                        const T* __restrict__ u, float* __restrict__ part,
                                        int n_parts, int per_cta, int ra, int rb, int r, int bn,
                                        int bi, int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* sg = reinterpret_cast<float4*>(smem_raw);  // [r][blockDim.x], then the staging
  const int ra4 = (ra + kQI - 1) / kQI * kQI;
  const int first = blockIdx.x * per_cta;
  const int last = min(first + per_cta, n_parts);
  const long long t_begin = first < n_parts ? parts[first] : 0;
  const long long t_end = first < n_parts ? parts[last] : 0;
  const long long k_cols = (long long)ra * rb;
  const int n_items = (ra4 / kQI) * rb;
  const int item = blockIdx.y * blockDim.x + threadIdx.x;
  const bool active = item < n_items;
  const int j = active ? item % rb : 0;
  const int i0 = active ? (item / rb) * kQI : 0;
  float4* my = sg + threadIdx.x;  // this thread's columns of the partial
  for (int q = 0; q < r; ++q) my[q * blockDim.x] = make_float4(0.f, 0.f, 0.f, 0.f);

  kron::walk_rows<T, kBf16>(
      a, b, v, rel, blkmap, t_begin, t_end, ra, rb, bn, bi, chunk,
      reinterpret_cast<unsigned char*>(sg + (size_t)r * blockDim.x), active, i0, j,
      [&](int row, const float* acc) { contract_row(my, u, row, r, blockDim.x, acc); });
  if (!active) return;
  float* p = part + (long long)blockIdx.x * r * k_cols + j;
  for (int q = 0; q < r; ++q) {
    const float4 g = my[q * blockDim.x];
    const float gv[kQI] = {g.x, g.y, g.z, g.w};
#pragma unroll
    for (int c = 0; c < kQI; ++c)
      if (i0 + c < ra) p[q * k_cols + (long long)(i0 + c) * rb] = gv[c];
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

// Shared memory of one first-pass CTA: its (r, K) partial, then the staging.
size_t smem_bytes(int ra, int rb, int r, int threads, int chunk) {
  return (size_t)r * threads * 16 + kron::staging_bytes(ra, rb, chunk);
}

template <typename T, bool kBf16>
int prepare(size_t smem) {
  if (smem > (size_t)kron::kStagingLimit)
    return (int)cudaFuncSetAttribute(kron_scatter_ttm_kernel<T, kBf16>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return 0;
}

template <typename T, bool kBf16>
int ctas_per_sm(int threads, size_t smem, int* out) {
  *out = 0;
  if (prepare<T, kBf16>(smem) != 0) {
    cudaGetLastError();
    return 0;  // more shared memory than an SM has: none fits
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, kron_scatter_ttm_kernel<T, kBf16>, threads, smem);
}

}  // namespace

// The first pass's grid for n_parts row ranges at these ranks on the current
// device: threads per CTA, the CTAs one SM holds at once, the CTAs n_ctas
// (the leading size of the scratch buffer part), the ranges per_cta each
// takes, and the shared memory smem of one CTA (written even when nothing
// fits). Returns a CUDA error code: cudaErrorInvalidValue when the ranks do
// not fit the staging or no CTA fits an SM.
extern "C" int kron_scatter_ttm_grid(int ra, int rb, int r, int bf16, int n_parts,
                                     int* threads, int* per_sm, int* n_ctas, int* per_cta,
                                     long long* smem) {
  int chunk;
  *threads = *per_sm = *n_ctas = *per_cta = 0;
  *smem = 0;
  if (r < 1 || n_parts < 1 || !kron::staging_shape(ra, rb, threads, &chunk))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(ra, rb, r, *threads, chunk);
  *smem = (long long)bytes;
  int rc = bf16 ? ctas_per_sm<__nv_bfloat16, true>(*threads, bytes, per_sm)
                : ctas_per_sm<float, false>(*threads, bytes, per_sm);
  if (rc != 0) return rc;
  if (*per_sm < 1) return (int)cudaErrorInvalidValue;
  int dev, n_sms;
  if ((rc = (int)cudaGetDevice(&dev)) != 0) return rc;
  if ((rc = (int)cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev)) != 0)
    return rc;
  const int y_tiles = (kron::n_items(ra, rb) + *threads - 1) / *threads;
  int ctas = *per_sm * n_sms / y_tiles;
  ctas = ctas < 1 ? 1 : (ctas > n_parts ? n_parts : ctas);
  *per_cta = (n_parts + ctas - 1) / ctas;
  *n_ctas = (n_parts + *per_cta - 1) / *per_cta;
  return 0;
}

// out (r, ra*rb) f32 = sum over rows of U[row]^T (x) y[row], y as in
// kron_scatter_launch. a (nnzp, ra), b (nnzp, rb) and u (n_rows, r)
// contiguous, f32 (bf16 = 0) or bf16 (bf16 = 1); v (nnzp,) f32; rel and
// blkmap int32; parts (n_parts + 1,) int64 row-aligned slot boundaries.
// CTA x of n_ctas = ceil(n_parts / per_cta) takes ranges
// [x * per_cta, (x + 1) * per_cta), per_cta as kron_scatter_ttm_grid gives
// it. part is an (n_ctas, r, ra*rb) f32 scratch buffer. Returns
// cudaGetLastError() after the two launches.
extern "C" int kron_scatter_ttm_launch(const void* a, const void* b, const void* v,
                                       const void* rel, const void* blkmap, const void* parts,
                                       const void* u, void* part, void* out, int n_parts,
                                       int per_cta, int ra, int rb, int r, int bn, int bi,
                                       int bf16, void* stream) {
  int threads, chunk;
  if (n_parts < 1 || per_cta < 1 || r < 1 || bn < 1 || bi < 1 ||
      !kron::staging_shape(ra, rb, &threads, &chunk))
    return (int)cudaErrorInvalidValue;
  const int n_ctas = (n_parts + per_cta - 1) / per_cta;
  const dim3 grid(n_ctas, (kron::n_items(ra, rb) + threads - 1) / threads);
  const size_t smem = smem_bytes(ra, rb, r, threads, chunk);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* vf = static_cast<const float*>(v);
  const int* relp = static_cast<const int*>(rel);
  const int* blk = static_cast<const int*>(blkmap);
  const long long* pp = static_cast<const long long*>(parts);
  float* pt = static_cast<float*>(part);
  int rc;
  if (bf16) {
    if ((rc = prepare<__nv_bfloat16, true>(smem)) != 0) return rc;
    kron_scatter_ttm_kernel<__nv_bfloat16, true><<<grid, threads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b), vf, relp,
        blk, pp, static_cast<const __nv_bfloat16*>(u), pt, n_parts, per_cta, ra, rb, r, bn, bi,
        chunk);
  } else {
    if ((rc = prepare<float, false>(smem)) != 0) return rc;
    kron_scatter_ttm_kernel<float, false><<<grid, threads, smem, st>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), vf, relp, blk, pp,
        static_cast<const float*>(u), pt, n_parts, per_cta, ra, rb, r, bn, bi, chunk);
  }
  if ((rc = (int)cudaGetLastError()) != 0) return rc;
  const long long n_out = (long long)r * ra * rb;
  kron_scatter_ttm_reduce_kernel<<<(unsigned)((n_out + 31) / 32), 32 * kReduceWarps, 0, st>>>(
      pt, static_cast<float*>(out), n_ctas, n_out);
  return (int)cudaGetLastError();
}
