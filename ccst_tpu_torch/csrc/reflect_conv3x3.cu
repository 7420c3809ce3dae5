// Reflection-padded 3x3 convolution + bias + optional ReLU, NHWC bf16, for Hopper.
//
// Replaces ccst_tpu/kernels/conv_pallas.py::reflect_conv3x3_fused (_kernel): the
// torch ReflectionPad2d(1) halo is never materialized, the 3x3 conv is a GEMM
// with f32 accumulation, and bias + ReLU run in f32 before the one bf16 rounding
// (the rounding point of ccst_tpu/models/vgg.py::conv2d).
//
// What bounds it on the H100: the VGG convs at 512 px are compute bound (K = 9*Cin
// is 576..4608, so every input byte feeds hundreds of MACs); the exception is
// conv1_1 (Cin = 3) and dconv1_1 (Cout = 3), which are tiny in FLOPs and bound by
// reading/writing the 64-channel activation.
//
// Design: an implicit GEMM, M = N*H*W output pixels, N = Cout, K = 9*Cin in HWIO
// order (k = (dy*3 + dx)*Cin + ci). Each block computes a BM x BN tile with eight
// warps of bf16 WMMA (mma.sync) tensor-core tiles. The reflected input rows are
// gathered straight into shared memory by mirrored indexing (row -1 -> 1,
// row H -> H-2, same for columns), so the padded tensor never exists in device
// memory. Two shared-memory stages: cp.async fetches stage k+1 while the tensor
// cores consume stage k. Weights come pre-packed as a (Kp, Np) row-major matrix,
// zero padded to BK rows and BN columns, so the B tile needs no bounds checks;
// Cin = 3 and Cout = 3 are handled by that zero padding plus a scalar gather path
// for the A tile when Cin is not a multiple of BK. wgmma/TMA is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BM = 128;      // output pixels per block
constexpr int BN = 64;       // output channels per block
constexpr int BK = 32;       // reduction depth per stage
constexpr int THREADS = 256; // 8 warps: 4 along M x 2 along N, 32x32 each
constexpr int APAD = 8;      // bf16 elements of padding per smem row
constexpr int BPAD = 8;
constexpr int CPAD = 4;      // f32 elements of padding per epilogue row

struct SmemAB {
  __nv_bfloat16 a[2][BM][BK + APAD];
  __nv_bfloat16 b[2][BK][BN + BPAD];
};

union Smem {
  SmemAB ab;
  float c[BM][BN + CPAD];  // epilogue staging, reuses the operand buffers
};

__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int bytes = pred ? 16 : 0;  // 0 -> zero fill, no global read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// VEC: Cin % BK == 0, so a BK slice of K lies inside one tap and is 16-byte
// aligned in memory; the A tile is fetched with cp.async. Otherwise each
// element is gathered on its own (only conv1_1, Cin = 3, takes that path).
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
reflect_conv3x3_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ wk,
                       const float* __restrict__ bias,
                       __nv_bfloat16* __restrict__ y, int N, int H, int W, int Cin,
                       int Cout, int Kp, int Np, int relu) {
  __shared__ __align__(128) Smem sm;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp & 3;   // warp row (M)
  const int wn = warp >> 2;  // warp column (N)
  const long long HW = (long long)H * W;
  const long long M = (long long)N * HW;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int K = 9 * Cin;
  const int KT = Kp / BK;

  // VEC path: each thread owns two A rows (pixels) and one 16-byte chunk column
  int a_row[2], a_n[2], a_h[2], a_w[2];
  bool a_ok[2];
  const int a_chunk = tid & 3;  // 4 chunks of 8 bf16 per BK row
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    a_row[i] = (tid >> 2) + i * (THREADS / 4);
    long long m = m0 + a_row[i];
    a_ok[i] = m < M;
    long long mm = a_ok[i] ? m : 0;
    a_n[i] = (int)(mm / HW);
    int rem = (int)(mm - (long long)a_n[i] * HW);
    a_h[i] = rem / W;
    a_w[i] = rem - a_h[i] * W;
  }
  const int b_row = tid >> 3;  // BK rows x 8 chunks of 8 bf16
  const int b_chunk = tid & 7;

  auto load_stage = [&](int kt, int s) {
    const int k0 = kt * BK;
    // B: rows k0..k0+BK of the packed weights, columns n0..n0+BN
    cp_async16(&sm.ab.b[s][b_row][b_chunk * 8],
               wk + (long long)(k0 + b_row) * Np + n0 + b_chunk * 8, true);
    if constexpr (VEC) {
      const int tap = k0 / Cin;
      const int ci0 = k0 - tap * Cin + a_chunk * 8;
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int hh = reflect(a_h[i] + dy, H);
        const int ww = reflect(a_w[i] + dx, W);
        const __nv_bfloat16* src =
            x + (((long long)a_n[i] * H + hh) * W + ww) * Cin + ci0;
        cp_async16(&sm.ab.a[s][a_row[i]][a_chunk * 8], a_ok[i] ? src : x, a_ok[i]);
      }
    } else {
      for (int idx = tid; idx < BM * BK; idx += THREADS) {
        const int row = idx / BK;
        const int kk = idx - row * BK;
        const int k = k0 + kk;
        const long long m = m0 + row;
        __nv_bfloat16 v = __float2bfloat16(0.0f);
        if (m < M && k < K) {
          const int n = (int)(m / HW);
          const int rem = (int)(m - (long long)n * HW);
          const int h = rem / W, w = rem - (rem / W) * W;
          const int tap = k / Cin, ci = k - tap * Cin;
          const int hh = reflect(h + tap / 3 - 1, H);
          const int ww = reflect(w + tap % 3 - 1, W);
          v = x[(((long long)n * H + hh) * W + ww) * Cin + ci];
        }
        sm.ab.a[s][row][kk] = v;
      }
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < KT) load_stage(kt + 1, s ^ 1);
    cp_async_commit();
    cp_async_wait_one();  // everything but the group just committed has landed
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &sm.ab.a[s][wm * 32 + i * 16][kk], BK + APAD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &sm.ab.b[s][kk][wn * 32 + j * 16], BN + BPAD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: stage the f32 tile in shared memory, then bias + ReLU + one
  // bf16 rounding, 8 channels (16 bytes) per store where Cout allows
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&sm.c[wm * 32 + i * 16][wn * 32 + j * 16], acc[i][j],
                              BN + CPAD, wmma::mem_row_major);
  __syncthreads();

  for (int idx = tid; idx < BM * (BN / 8); idx += THREADS) {
    const int row = idx / (BN / 8);
    const int cg = (idx - row * (BN / 8)) * 8;
    const long long m = m0 + row;
    const int co = n0 + cg;
    if (m >= M || co >= Cout) continue;
    __nv_bfloat16* dst = y + m * Cout + co;
    if ((Cout & 7) == 0) {
      __align__(16) __nv_bfloat16 out[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float v = sm.c[row][cg + e] + bias[co + e];
        out[e] = __float2bfloat16(relu ? fmaxf(v, 0.0f) : v);
      }
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(out);
    } else {
      for (int e = 0; e < 8 && co + e < Cout; ++e) {
        float v = sm.c[row][cg + e] + bias[co + e];
        dst[e] = __float2bfloat16(relu ? fmaxf(v, 0.0f) : v);
      }
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). x: (N,H,W,Cin) bf16; wk: (Kp,Np)
// bf16 packed weights; bias: (Cout,) f32; y: (N,H,W,Cout) bf16. All
// contiguous. Kp = roundup(9*Cin, 32), Np = roundup(Cout, 64). Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int ccst_reflect_conv3x3_bf16(const void* x, const void* wk, const void* bias,
                                         void* y, int N, int H, int W, int Cin, int Cout,
                                         int Kp, int Np, int relu, void* stream) {
  const long long M = (long long)N * H * W;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)(Np / BN));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(wk);
  const auto* bb = static_cast<const float*>(bias);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  if (Cin % BK == 0)
    reflect_conv3x3_kernel<true><<<grid, THREADS, 0, st>>>(xb, wb, bb, yb, N, H, W, Cin,
                                                          Cout, Kp, Np, relu);
  else
    reflect_conv3x3_kernel<false><<<grid, THREADS, 0, st>>>(xb, wb, bb, yb, N, H, W, Cin,
                                                           Cout, Kp, Np, relu);
  return static_cast<int>(cudaGetLastError());
}
