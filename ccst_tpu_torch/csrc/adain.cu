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

// AdaIN with the content statistics given: the row-sharded stylize path
// (parallel/spatial.py), where a rank holds only a block of each image's
// rows, merges every (n, c) mean and 1 / std over the ranks first (K5 and
// ops/welford.py::welford_psum) and passes them in. The formula is
// adain_kernel's, one rounding to the feature type:
//   out[s] = alpha * ((x - mean) * inv_std * s_std[s] + s_mean[s]) + (1 - alpha) * x
// Elementwise, so bound by device memory: the features read once, S outputs
// written. A thread takes one 16-byte unit (8 bf16 / 4 float32 channels of a
// row; one element where rows or statistics are not 16-byte aligned),
// neighbouring threads neighbouring units, over a grid-stride loop. The
// statistics are small and stay in L1 / L2; they are read four floats a
// load, because scalar loads of them (4 + 2 S a channel) left the bf16 kernel
// load-bound at 27% of its byte bound (float32: 74%; NVIDIA H100 80GB HBM3,
// 700 W).
template <int N>
__device__ __forceinline__ void load_floats(const float* p, float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + i);
    v[i] = q.x; v[i + 1] = q.y; v[i + 2] = q.z; v[i + 3] = q.w;
  }
}

template <typename T, bool VECTOR>
__global__ void __launch_bounds__(THREADS)
adain_given_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ mean,
                   const float* __restrict__ inv_std, const float* __restrict__ s_mean,
                   const float* __restrict__ s_std, long long rows, int HW, int C, int S,
                   float alpha) {
  constexpr int VEC = VECTOR ? 16 / static_cast<int>(sizeof(T)) : 1;
  const int per_row = C / VEC;
  const long long units = rows * per_row;
  const long long plane = rows * C;  // elements of one style's output
  const float beta = 1.0f - alpha;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long u = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; u < units;
       u += stride) {
    const long long row = u / per_row;
    const int c0 = static_cast<int>(u - row * per_row) * VEC;
    const long long at = row * C + c0;
    const long long nc = row / HW * C + c0;
    float f[VEC], mu[VEC], inv[VEC];
    if constexpr (VECTOR) {
      unpack(*reinterpret_cast<const uint4*>(x + at), f, x);
      load_floats(mean + nc, mu);
      load_floats(inv_std + nc, inv);
    } else {
      f[0] = to_float(x[at]);
      mu[0] = mean[nc];
      inv[0] = inv_std[nc];
    }
    for (int s = 0; s < S; ++s) {
      float sm[VEC], ss[VEC], o[VEC];
      if constexpr (VECTOR) {
        load_floats(s_mean + s * C + c0, sm);
        load_floats(s_std + s * C + c0, ss);
      } else {
        sm[0] = s_mean[s * C + c0];
        ss[0] = s_std[s * C + c0];
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float styl = (f[e] - mu[e]) * inv[e] * ss[e] + sm[e];
        o[e] = alpha * styl + beta * f[e];
      }
      T* dst = y + s * plane + at;
      if constexpr (VECTOR) {
        *reinterpret_cast<uint4*>(dst) = pack(o, dst);
      } else {
        from_float(*dst, o[0]);
      }
    }
  }
}

template <typename T>
cudaError_t launch_adain_given(const void* x, void* y, const void* mean, const void* inv_std,
                               const void* s_mean, const void* s_std, long long rows, int HW,
                               int C, int S, float alpha, cudaStream_t st) {
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vector = (static_cast<size_t>(C) * sizeof(T)) % 16 == 0 && aligned(x) &&
                      aligned(y) && aligned(mean) && aligned(inv_std) && aligned(s_mean) &&
                      aligned(s_std);
  const long long units = rows * (vector ? C / (16 / static_cast<int>(sizeof(T))) : C);
  const long long want = (units + THREADS - 1) / THREADS;
  const unsigned blocks = static_cast<unsigned>(want < 132 * 32 ? want : 132 * 32);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const float *mu = static_cast<const float*>(mean), *inv = static_cast<const float*>(inv_std),
              *sm = static_cast<const float*>(s_mean), *ss = static_cast<const float*>(s_std);
  if (vector)
    adain_given_kernel<T, true><<<blocks, THREADS, 0, st>>>(xt, yt, mu, inv, sm, ss, rows, HW, C,
                                                            S, alpha);
  else
    adain_given_kernel<T, false><<<blocks, THREADS, 0, st>>>(xt, yt, mu, inv, sm, ss, rows, HW,
                                                             C, S, alpha);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point of the given-statistics AdaIN (bound with ctypes).
// x: (N, HW, C) bf16 (is_f32 = 0) or float32, contiguous, rows = N * HW;
// y: (S, N, HW, C) of the same type; mean, inv_std: (N, C) float32; s_mean,
// s_std: (S, C) float32. Launches on `stream` and returns the first CUDA
// error (0 on success).
extern "C" int ccst_adain_given(const void* x, void* y, const void* mean, const void* inv_std,
                                const void* s_mean, const void* s_std, long long rows, int HW,
                                int C, int S, int is_f32, float alpha, void* stream) {
  if (rows <= 0 || HW <= 0 || rows % HW || C <= 0 || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_f32 ? launch_adain_given<float>(x, y, mean, inv_std, s_mean, s_std, rows, HW, C, S,
                                         alpha, st)
             : launch_adain_given<__nv_bfloat16>(x, y, mean, inv_std, s_mean, s_std, rows, HW, C,
                                                 S, alpha, st);
  return static_cast<int>(err);
}

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
