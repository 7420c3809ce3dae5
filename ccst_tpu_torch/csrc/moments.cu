// Per-channel mean and M2 (sum of squared deviations from the mean) of an NHWC
// batch over all its N*H*W rows, bf16 or float32 in, float32 out, one launch.
//
// Replaces ccst_tpu/kernels/welford_pallas.py::channel_moments
// (_moments_kernel), the per-batch reduction of the style-bank step. The TPU
// kernel carried its sums from one grid step to the next; blocks here run in
// no order.
//
// What bounds it on the H100: device memory, 12.6 MB at the bank's
// (3, 64, 64, 512) bf16 batch, whose byte bound is 3.8 us: about the time of
// a launch, so every extra launch or fill kernel costs as much as the work.
//
// Design (resident_slice.cuh holds the slice and says why): one kernel. A
// block takes `chunk` rows x one 128-byte channel group of the flattened
// (rows, C) matrix, copies it once into shared memory, takes the chunk's
// mean and then its centred squares from the resident copy (no second read of
// device memory and no sum(x^2)), and writes its partial (mean, M2) to
// scratch. Then a fence and an atomic ticket per channel group: the block that
// draws a group's last ticket merges that group's partials with Chan's
// formula IN CHUNK ORDER (four threads a channel take a quarter of the chunks
// each, in order, then the quarters in order), writes mean and M2, for group
// 0 also the row count, and resets the ticket for the next launch. The ticket
// only elects who merges; the order of every float operation is fixed by the
// shape, so a style bank has the same bits from run to run.
#include "resident_slice.cuh"

namespace {

using namespace ccst_slice;

constexpr int SEGMENTS = 4;  // threads a channel in the merge

struct Moments {
  float n, mean, m2;
};

// The kernel's static shared memory, and so the rows a block can keep
// resident beside it in the 227 KB a block may have (128 B to spare for
// alignment).
struct Shared {
  float scratch[WARPS][MAXC];
  float sum[MAXC], sq[MAXC];
  Moments seg[SEGMENTS][MAXC];
  int is_last;
};
constexpr int MAX_CHUNK = (227 * 1024 - static_cast<int>(sizeof(Shared)) - 128) / LINE;

// Chan's merge of b into a; both counts > 0.
__device__ __forceinline__ void chan_merge(Moments& a, const Moments& b) {
  const float n = a.n + b.n;
  const float delta = b.mean - a.mean;
  a.mean = a.mean + delta * (b.n / n);
  a.m2 = a.m2 + b.m2 + delta * delta * (a.n * b.n / n);
  a.n = n;
}

// Grid: block b is chunk b / ngroups of channel group b % ngroups.
// x: (R, C); pmean, pm2: (nchunks, C) scratch; out: mean (C), M2 (C), count;
// tickets: ngroups ints, zero before the first launch and after every launch.
template <typename T>
__global__ void __launch_bounds__(THREADS)
channel_moments_kernel(const T* __restrict__ x, float* __restrict__ pmean,
                       float* __restrict__ pm2, float* __restrict__ out,
                       int* __restrict__ tickets, long long R, int C, int chunk, int nchunks,
                       int ngroups, int aligned16) {
  constexpr int VEC = Slice<T>::VEC;
  constexpr int GC = Slice<T>::GC;
  extern __shared__ __align__(128) uint8_t resident[];
  __shared__ Shared sh;

  const int g = blockIdx.x % ngroups, ch = blockIdx.x / ngroups;
  const long long r0 = static_cast<long long>(ch) * chunk;
  const int rows = static_cast<int>(min(static_cast<long long>(chunk), R - r0));

  Slice<T> sl;
  sl.init(x + r0 * C, C, g, rows, resident, aligned16);
  sl.copy_in();

  const int u = threadIdx.x % UNITS;
  float acc[VEC], mu[VEC];
  sum_rows<true>(sl, acc);
  block_sum(acc, sh.scratch, sh.sum);
#pragma unroll
  for (int e = 0; e < VEC; ++e) mu[e] = sh.sum[u * VEC + e] / rows;
  sum_squares<true>(sl, mu, acc);
  block_sum(acc, sh.scratch, sh.sq);

  const int c = g * GC + threadIdx.x;  // as a channel thread (threadIdx.x < GC)
  if (threadIdx.x < GC && c < C) {
    pmean[static_cast<long long>(ch) * C + c] = sh.sum[threadIdx.x] / rows;
    pm2[static_cast<long long>(ch) * C + c] = sh.sq[threadIdx.x];
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    sh.is_last = atomicAdd(&tickets[g], 1) == nchunks - 1;
    if (sh.is_last) tickets[g] = 0;  // every block of the group has drawn: ready for the next launch
  }
  __syncthreads();
  if (!sh.is_last) return;
  __threadfence();

  // merge: thread (s, cl) folds chunks [s * per, (s + 1) * per) of channel cl in order
  const int cl = threadIdx.x % GC, s = threadIdx.x / GC;
  const int cm = g * GC + cl;
  const int per = (nchunks + SEGMENTS - 1) / SEGMENTS;
  if (s < SEGMENTS) {
    Moments a = {0.0f, 0.0f, 0.0f};
    if (cm < C) {
      const int end = min((s + 1) * per, nchunks);
#pragma unroll 8
      for (int i = s * per; i < end; ++i) {
        Moments b;
        b.n = static_cast<float>(min(static_cast<long long>(chunk), R - static_cast<long long>(i) * chunk));
        b.mean = __ldcg(pmean + static_cast<long long>(i) * C + cm);
        b.m2 = __ldcg(pm2 + static_cast<long long>(i) * C + cm);
        if (i == s * per) a = b; else chan_merge(a, b);
      }
    }
    sh.seg[s][cl] = a;
  }
  __syncthreads();
  if (threadIdx.x < GC && cm < C) {
    Moments a = sh.seg[0][cl];  // segment 0 is never empty
    for (int j = 1; j < SEGMENTS; ++j)
      if (sh.seg[j][cl].n > 0.0f) chan_merge(a, sh.seg[j][cl]);
    out[cm] = a.mean;
    out[C + cm] = a.m2;
  }
  if (g == 0 && threadIdx.x == 0) out[2 * static_cast<long long>(C)] = static_cast<float>(R);
}

template <typename T>
cudaError_t launch_moments(const void* x, float* pmean, float* pm2, float* out, int* tickets,
                           long long R, int C, int chunk, cudaStream_t st) {
  auto kernel = channel_moments_kernel<T>;
  const int ngroups = (C + Slice<T>::GC - 1) / Slice<T>::GC;
  const long long nchunks = (R + chunk - 1) / chunk;
  const size_t smem = static_cast<size_t>(chunk) * LINE;
  const int aligned16 = (static_cast<size_t>(C) * sizeof(T)) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (nchunks * ngroups > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(nchunks * ngroups), THREADS, smem, st>>>(
      static_cast<const T*>(x), pmean, pm2, out, tickets, R, C, chunk, static_cast<int>(nchunks),
      ngroups, aligned16);
  return cudaGetLastError();
}

__global__ void empty_kernel() {}

}  // namespace

// Plain C entry point (bound with ctypes). x: (R, C) bf16 (is_f32 = 0) or
// float32, contiguous; partials: 2 * ceil(R / chunk) * C floats of scratch;
// out: 2 * C + 1 floats (mean, M2, count); tickets: ceil(C / channels of a
// group) ints that are zero (the kernel leaves them zero); chunk: rows a block
// keeps resident, at most MAX_CHUNK. Launches on `stream` and returns the first
// CUDA error (0 on success).
extern "C" int ccst_channel_moments(const void* x, void* partials, void* out, void* tickets,
                                    long long R, int C, int chunk, int is_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R <= 0 || C <= 0 || chunk <= 0 || chunk > MAX_CHUNK) return static_cast<int>(cudaErrorInvalidValue);
  const long long nchunks = (R + chunk - 1) / chunk;
  float* pmean = static_cast<float*>(partials);
  float* pm2 = pmean + nchunks * C;
  cudaError_t err =
      is_f32 ? launch_moments<float>(x, pmean, pm2, static_cast<float*>(out),
                                     static_cast<int*>(tickets), R, C, chunk, st)
             : launch_moments<__nv_bfloat16>(x, pmean, pm2, static_cast<float*>(out),
                                             static_cast<int*>(tickets), R, C, chunk, st);
  return static_cast<int>(err);
}

// A kernel that does nothing, launched the same way: the floor under the times
// of the two small kernels (launch latency), for the benchmarks to print.
extern "C" int ccst_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
