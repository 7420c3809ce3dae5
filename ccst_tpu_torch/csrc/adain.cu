// Fused AdaIN for S style banks: per-(image, channel) statistics, normalize,
// rescale to each style's (mean, std), alpha blend, NHWC bf16 or float32.
//
// Replaces ccst_tpu/kernels/adain_pallas.py::fused_adain (_adain_kernel):
//   out[s] = alpha * ((x - mu) * rsqrt(var + eps) * s_std[s] + s_mean[s]) + (1 - alpha) * x
// with mu and the ddof variance of every (n, c) over H x W in float32 (the
// variance from centred squares, never from sum(x^2)) and one rounding to the
// feature type. The stylize path restyles the SAME content features under
// every bank, so the kernel takes all S banks: the statistics are computed
// once and the features read once.
//
// What bounds it on the H100: device memory, and at the relu4_1 shape
// ((4, 64, 64, 512) bf16: 16.8 MB in, 16.8 MB out per style) latency: the
// byte bound is 10 us for one style. A few float operations an element.
//
// Design (resident_slice.cuh holds the slice and says why): an (image,
// 128-byte channel group) slice is read ONCE into shared memory and stays
// there for the mean, the centred squares and the S outputs: one read, S
// writes, no second pass through L2. A slice is H*W rows of 128 bytes (512 KB
// at 64 x 64), more than one block holds, so its rows are split over a thread
// block cluster of up to 8 blocks; each block sums its rows, and the blocks
// exchange their per-channel partial sums through distributed shared memory:
// every block adds the partials of all ranks in rank order (so all hold the
// same bits), once after the sums and once after the squares. Small maps take
// smaller clusters (a slice is split only while a block would hold more than
// 128 rows), so a 32 x 32 map still gives 8 blocks a slice. A third cluster
// barrier, split into its arrive (after the last remote read) and its wait
// (at the end), keeps a block's shared memory alive while a peer may read it.
//
// Where a slice does not fit the shared memory of 8 blocks (H*W > 8 *
// MAX_ROWS, about 119 x 119), the same kernel runs without the resident copy
// (RESIDENT = false): the three passes read device memory (L2 after the
// first), still in full lines and over a cluster. The caller picks the
// variant from the shape alone (kernels/adain.py::plan_adain).
#include <cooperative_groups.h>

#include "resident_slice.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace ccst_slice;

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The cluster's per-channel total: the partials of all ranks, in rank order.
__device__ __forceinline__ float cluster_total(cg::cluster_group& cluster, float* part, int c) {
  float total = 0.0f;
  const unsigned nranks = cluster.num_blocks();
  for (unsigned r = 0; r < nranks; ++r) total += cluster.map_shared_rank(part, r)[c];
  return total;
}

// Grid: clusters of `cluster` blocks along x; cluster i is slice (n, g) =
// (i / ngroups, i % ngroups), its rank r owns rows r * rows_per_block ...
// x: (N, HW, C); y: (S, N, HW, C); s_mean, s_std: (S, C) float32.
template <typename T, bool RESIDENT>
__global__ void __launch_bounds__(THREADS)
adain_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ s_mean,
             const float* __restrict__ s_std, int N, int HW, int C, int S, int ngroups,
             int rows_per_block, int aligned16, float alpha, float eps, float n_var) {
  constexpr int VEC = Slice<T>::VEC;
  constexpr int GC = Slice<T>::GC;
  extern __shared__ __align__(128) uint8_t resident[];
  __shared__ float scratch[WARPS][MAXC];
  __shared__ float part_sum[MAXC], part_sq[MAXC];  // read by the cluster's other blocks
  __shared__ float s_mu[MAXC], s_inv[MAXC];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = cluster.block_rank();
  const int slice = blockIdx.x / cluster.num_blocks();
  const int n = slice / ngroups, g = slice % ngroups;
  const int r0 = rank * rows_per_block;
  const int rows = max(min(rows_per_block, HW - r0), 0);
  const long long first = (static_cast<long long>(n) * HW + r0) * C;

  Slice<T> sl;
  sl.init(x + first, C, g, rows, resident, aligned16);
  if (RESIDENT) sl.copy_in();

  const int u = threadIdx.x % UNITS;
  float acc[VEC], mu[VEC], inv[VEC];

  sum_rows<RESIDENT>(sl, acc);
  block_sum(acc, scratch, part_sum);
  cluster.sync();
  if (threadIdx.x < GC) s_mu[threadIdx.x] = cluster_total(cluster, part_sum, threadIdx.x) / HW;
  __syncthreads();
#pragma unroll
  for (int e = 0; e < VEC; ++e) mu[e] = s_mu[u * VEC + e];

  sum_squares<RESIDENT>(sl, mu, acc);
  block_sum(acc, scratch, part_sq);
  cluster.sync();
  if (threadIdx.x < GC)
    s_inv[threadIdx.x] = 1.0f / sqrtf(cluster_total(cluster, part_sq, threadIdx.x) / n_var + eps);
  cluster_arrive();  // this block has read its peers for the last time
  __syncthreads();
#pragma unroll
  for (int e = 0; e < VEC; ++e) inv[e] = s_inv[u * VEC + e];

  const int sweeps = sl.sweeps();
  const int c0 = g * GC + u * VEC;
  const float beta = 1.0f - alpha;
  for (int s = 0; s < S; ++s) {
    float sm[VEC], ss[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      sm[e] = e < sl.nvalid ? s_mean[static_cast<long long>(s) * C + c0 + e] : 0.0f;
      ss[e] = e < sl.nvalid ? s_std[static_cast<long long>(s) * C + c0 + e] : 0.0f;
    }
    T* dst = y + static_cast<long long>(s) * N * HW * C + first + c0;
#pragma unroll 4
    for (int k = 0; k < sweeps; ++k) {
      float f[VEC];
      sl.template fetch<RESIDENT>(k, f);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float styl = (f[e] - mu[e]) * inv[e] * ss[e] + sm[e];
        f[e] = alpha * styl + beta * f[e];
      }
      sl.store(dst, k, f);
    }
  }
  cluster_wait();  // no peer reads this block's shared memory any more
}

template <typename T, bool RESIDENT>
cudaError_t launch_adain(const void* x, void* y, const void* s_mean, const void* s_std, int N,
                         int HW, int C, int S, int cluster, int rows_per_block, float alpha,
                         float eps, float n_var, cudaStream_t st) {
  auto kernel = adain_kernel<T, RESIDENT>;
  const int ngroups = (C + Slice<T>::GC - 1) / Slice<T>::GC;
  const size_t smem = RESIDENT ? static_cast<size_t>(rows_per_block) * LINE : 0;
  const int aligned16 = (static_cast<size_t>(C) * sizeof(T)) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(y) % 16 == 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(N) * ngroups * cluster);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), static_cast<T*>(y),
                           static_cast<const float*>(s_mean), static_cast<const float*>(s_std), N,
                           HW, C, S, ngroups, rows_per_block, aligned16, alpha, eps, n_var);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). x: (N, HW, C) bf16 (is_f32 = 0) or
// float32, contiguous; y: (S, N, HW, C) of the same type; s_mean, s_std: (S, C)
// float32. The HW rows of a slice are split over `cluster` blocks (1, 2, 4 or
// 8) of rows_per_block rows each; resident = 1 keeps the slice in shared memory
// (rows_per_block <= MAX_ROWS), 0 streams it. n_var is max(HW - ddof, 1).
// Launches on `stream` and returns the first CUDA error (0 on success).
extern "C" int ccst_adain(const void* x, void* y, const void* s_mean, const void* s_std, int N,
                          int HW, int C, int S, int cluster, int rows_per_block, int resident,
                          int is_f32, float alpha, float eps, float n_var, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool sizes_ok = N > 0 && HW > 0 && C > 0 && S > 0 && rows_per_block > 0 &&
                        (cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8) &&
                        static_cast<long long>(cluster) * rows_per_block >= HW &&
                        (!resident || rows_per_block <= MAX_ROWS);
  if (!sizes_ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (is_f32)
    err = resident ? launch_adain<float, true>(x, y, s_mean, s_std, N, HW, C, S, cluster,
                                               rows_per_block, alpha, eps, n_var, st)
                   : launch_adain<float, false>(x, y, s_mean, s_std, N, HW, C, S, cluster,
                                                rows_per_block, alpha, eps, n_var, st);
  else
    err = resident ? launch_adain<__nv_bfloat16, true>(x, y, s_mean, s_std, N, HW, C, S, cluster,
                                                       rows_per_block, alpha, eps, n_var, st)
                   : launch_adain<__nv_bfloat16, false>(x, y, s_mean, s_std, N, HW, C, S, cluster,
                                                        rows_per_block, alpha, eps, n_var, st);
  return static_cast<int>(err);
}
