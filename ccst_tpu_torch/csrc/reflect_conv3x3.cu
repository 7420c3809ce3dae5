// Reflection-padded 3x3 convolution + bias + optional ReLU, NHWC bf16 (and float32), for Hopper.
//
// Replaces ccst_tpu/kernels/conv_pallas.py::reflect_conv3x3_fused (_kernel): the
// torch ReflectionPad2d(1) halo is never materialized, the 3x3 conv is a GEMM
// with f32 accumulation, and bias + ReLU run in f32 before the one bf16 rounding
// (the rounding point of ccst_tpu/models/vgg.py::conv2d).
//
// What bounds it on the H100: the VGG convs at 512 px are tensor-core bound
// (K = 9*Cin is 576..4608, so every input byte feeds hundreds of MACs), except
// 64->64 at 512 px, where the 268 MB of activations take as long as the FLOPs,
// conv1_1 (Cin = 3), bound by writing its 64-channel output, and dconv1_1
// (Cout = 3), bound by reading its 64-channel input.
//
// Design (conv_igemm_sm90.cuh holds the core and says why): an implicit GEMM
// on wgmma.mma_async m64nNk16, a warpgroup per 8 x 8 output pixels, two per
// block; the reflected 10 x 18 halo of the block's 8 x 16 tile is gathered
// once per 64-channel chunk into shared memory and all nine taps read it
// through unswizzled descriptors (A from shared memory, not registers: a tap
// is only a start address); the weights arrive as whole pre-packed tiles, one
// cp.async.bulk + mbarrier per stage, K-major (no transpose flag); a ring of
// four stages (three for the narrow tile); bias + ReLU + the bf16 rounding
// are applied from the accumulator registers and stored 16 bytes at a time.
// N per wgmma: 128 for Cout > 64, 64 down to Cout = 9, and 8 for the
// few-channel output (dconv1_1, Cout = 3), whose nine taps share one stage.
//
// Cin not a multiple of 8 (conv1_1, Cin = 3, K = 27) cannot be copied 16
// bytes at a time nor fill a k16 step per tap: that shape class keeps the
// earlier scalar-gather kernel on mma.sync (wmma) tiles below, picked by Cin
// alone, with its own (Kp, Np) weight matrix.
//
// float32 (the engines' verification mode, --dtype float32) is a third kernel
// of the same gather family: float32 operands, FFMA sums in float32 in the
// order of K, no tensor cores and so no TF32 rounding anywhere, for any Cin
// and Cout. It is bound by the float32 FFMA rate (67 TFLOP/s, a fifteenth of
// the bf16 tensor rate) and is held to being exact, not fast.
#include <mma.h>

#include "conv_igemm_sm90.cuh"

namespace {

using namespace ccst_igemm;

template <int BN, int TPS>
__global__ void __launch_bounds__(THREADS, min_blocks(BN))
reflect_conv3x3_wgmma_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ wp,
                             const float* __restrict__ bias, __nv_bfloat16* __restrict__ y,
                             int relu, const ConvGeom g) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ float sbias[BN];
  int n, y0, x0, ntile;
  block_tile(g, n, y0, x0, ntile);
  const int n0 = ntile * BN;
  if (threadIdx.x < BN) sbias[threadIdx.x] = n0 + threadIdx.x < g.Cout ? bias[n0 + threadIdx.x] : 0.0f;

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  conv_mainloop<true, BN, TPS>(acc, x, wp, g, n, y0, x0, ntile, smem);

  const int t = threadIdx.x & 3;
  auto value = [&](int j, int e, float a) {
    const float v = a + sbias[8 * j + 2 * t + e];
    return relu ? fmaxf(v, 0.0f) : v;
  };
  store_tile_bf16<BN>(acc, value, y, g, n, y0, x0, n0);
}

// ---- Cin % 8 != 0: scalar gather, mma.sync (wmma) tiles ------------------

using namespace nvcuda;

constexpr int BM = 128;        // output pixels per block
constexpr int BNG = 64;        // output channels per block
constexpr int BK = 32;         // reduction depth per stage
constexpr int GTHREADS = 256;  // 8 warps: 4 along M x 2 along N, 32x32 each
constexpr int APAD = 8;        // bf16 elements of padding per smem row
constexpr int BPAD = 8;
constexpr int CPAD = 4;        // f32 elements of padding per epilogue row

struct SmemAB {
  __nv_bfloat16 a[BM][BK + APAD];
  __nv_bfloat16 b[BK][BNG + BPAD];
};

union Smem {
  SmemAB ab;
  float c[BM][BNG + CPAD];  // epilogue staging, reuses the operand buffers
};

// M = N*H*W output pixels, N = Cout, K = 9*Cin in HWIO order; wk is the
// (Kp, Np) row-major weight matrix, zero padded to BK rows and BNG columns.
__global__ void __launch_bounds__(GTHREADS)
reflect_conv3x3_gather_kernel(const __nv_bfloat16* __restrict__ x,
                              const __nv_bfloat16* __restrict__ wk,
                              const float* __restrict__ bias, __nv_bfloat16* __restrict__ y,
                              int N, int H, int W, int Cin, int Cout, int Kp, int Np, int relu) {
  __shared__ __align__(128) Smem sm;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp & 3;   // warp row (M)
  const int wn = warp >> 2;  // warp column (N)
  const long long HW = (long long)H * W;
  const long long M = (long long)N * HW;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BNG;

  // A gather: a thread owns one output pixel and half of the BK reduction indices
  const int a_row = tid >> 1, a_kk = (tid & 1) * (BK / 2);
  const long long a_m = m0 + a_row;
  const bool a_ok = a_m < M;
  const long long a_img = (a_ok ? a_m / HW : 0) * HW;  // first pixel of the image
  const int a_rem = a_ok ? (int)(a_m - a_img) : 0;
  const int a_h = a_rem / W, a_w = a_rem - a_h * W;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < Kp; k0 += BK) {
    for (int idx = tid; idx < BK * (BNG / 8); idx += GTHREADS) {
      const int row = idx / (BNG / 8), col = (idx - row * (BNG / 8)) * 8;
      *reinterpret_cast<uint4*>(&sm.ab.b[row][col]) =
          *reinterpret_cast<const uint4*>(wk + (long long)(k0 + row) * Np + n0 + col);
    }
    int tap = (k0 + a_kk) / Cin, ci = (k0 + a_kk) - tap * Cin;
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      __nv_bfloat16 v = __float2bfloat16(0.0f);
      if (a_ok && tap < 9) {  // tap 9 is the zero padding of K
        const int hh = pad_index(a_h + tap / 3 - 1, H, 1);
        const int ww = pad_index(a_w + tap % 3 - 1, W, 1);
        v = x[(a_img + (long long)hh * W + ww) * Cin + ci];
      }
      sm.ab.a[a_row][a_kk + e] = v;
      if (++ci == Cin) { ci = 0; ++tap; }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &sm.ab.a[wm * 32 + i * 16][kk], BK + APAD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &sm.ab.b[kk][wn * 32 + j * 16], BNG + BPAD);
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
                              BNG + CPAD, wmma::mem_row_major);
  __syncthreads();

  for (int idx = tid; idx < BM * (BNG / 8); idx += GTHREADS) {
    const int row = idx / (BNG / 8);
    const int cg = (idx - row * (BNG / 8)) * 8;
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

// ---- float32: scalar gather, FFMA tiles ------------------------------------

constexpr int FBM = 128;       // output pixels per block
constexpr int FBN = 64;        // output channels per block
constexpr int FBK = 32;        // reduction depth per stage
constexpr int FTHREADS = 256;  // 16 along M x 16 along N, 8 pixels x 4 channels each
constexpr int FPAD = 4;        // floats of padding per shared row (keeps 16-byte rows)

// The same GEMM as the gather kernel above (M = N*H*W, N = Cout, K = 9*Cin in
// HWIO order, wk the zero-padded (Kp, Np) matrix), every operand float32 and
// every product an FFMA into a float32 sum, k ascending.
__global__ void __launch_bounds__(FTHREADS)
reflect_conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ wk,
                           const float* __restrict__ bias, float* __restrict__ y, int N, int H,
                           int W, int Cin, int Cout, int Kp, int Np, int relu) {
  __shared__ __align__(16) float sa[FBK][FBM + FPAD];  // k-major: a thread reads 8 pixels of one k
  __shared__ __align__(16) float sb[FBK][FBN];

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // channels tx * 4 .. + 4
  const int ty = tid >> 4;   // pixels ty * 8 .. + 8
  const long long HW = (long long)H * W;
  const long long M = (long long)N * HW;
  const long long m0 = (long long)blockIdx.x * FBM;
  const int n0 = blockIdx.y * FBN;

  // A gather: a thread owns one output pixel and half of the FBK reduction
  // indices; a warp's 32 pixels are neighbours, so its shared stores do not conflict
  const int a_row = tid & (FBM - 1), a_kk = (tid >> 7) * (FBK / 2);
  const long long a_m = m0 + a_row;
  const bool a_ok = a_m < M;
  const long long a_img = (a_ok ? a_m / HW : 0) * HW;  // first pixel of the image
  const int a_rem = a_ok ? (int)(a_m - a_img) : 0;
  const int a_h = a_rem / W, a_w = a_rem - a_h * W;

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < Kp; k0 += FBK) {
    for (int idx = tid; idx < FBK * (FBN / 4); idx += FTHREADS) {
      const int row = idx / (FBN / 4), col = (idx - row * (FBN / 4)) * 4;
      *reinterpret_cast<float4*>(&sb[row][col]) =
          *reinterpret_cast<const float4*>(wk + (long long)(k0 + row) * Np + n0 + col);
    }
    int tap = (k0 + a_kk) / Cin, ci = (k0 + a_kk) - tap * Cin;
#pragma unroll
    for (int e = 0; e < FBK / 2; ++e) {
      float v = 0.0f;
      if (a_ok && tap < 9) {  // tap 9 is the zero padding of K
        const int hh = pad_index(a_h + tap / 3 - 1, H, 1);
        const int ww = pad_index(a_w + tap % 3 - 1, W, 1);
        v = x[(a_img + (long long)hh * W + ww) * Cin + ci];
      }
      sa[a_kk + e][a_row] = v;
      if (++ci == Cin) { ci = 0; ++tap; }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sa[kk][ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sa[kk][ty * 8 + 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&sb[kk][tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: bias + ReLU in float32, 4 channels (16 bytes) per store where Cout allows
  const int co = n0 + tx * 4;
  if (co >= Cout) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + ty * 8 + i;
    if (m >= M) continue;
    float* dst = y + m * Cout + co;
    float out[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v = acc[i][j] + (co + j < Cout ? bias[co + j] : 0.0f);
      out[j] = relu ? fmaxf(v, 0.0f) : v;
    }
    if ((Cout & 3) == 0) {
      *reinterpret_cast<float4*>(dst) = make_float4(out[0], out[1], out[2], out[3]);
    } else {
      for (int j = 0; j < 4 && co + j < Cout; ++j) dst[j] = out[j];
    }
  }
}

template <int BN, int TPS>
cudaError_t launch_wgmma(const void* x, const void* wp, const void* bias, void* y, int N, int H,
                         int W, int Cin, int Cout, int relu, cudaStream_t st) {
  const ConvGeom g = make_geom(N, H, W, Cin * 2, Cout, BN, TPS, 1);
  return launch(reflect_conv3x3_wgmma_kernel<BN, TPS>, g, smem_bytes(g, BN, TPS), st,
                static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(wp),
                static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y), relu);
}

}  // namespace

// Plain C entry point (bound with ctypes). x: (N,H,W,Cin) bf16; bias: (Cout,)
// f32; y: (N,H,W,Cout) bf16; all contiguous. wp: the packed weights of
// kernels/conv.py::pack_weight: for Cin % 8 == 0 the stage tiles
// [n tile][chunk][tap][8][BN][8 bf16] with BN = 8 (Cout <= 8), 64 (<= 64) or
// 128; otherwise the (roundup(9*Cin, 32), roundup(Cout, 64)) matrix of the
// gather kernel. Launches on `stream` and returns the first CUDA error (0 on
// success).
extern "C" int ccst_reflect_conv3x3_bf16(const void* x, const void* wp, const void* bias,
                                         void* y, int N, int H, int W, int Cin, int Cout,
                                         int relu, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Cin % 8 == 0) {
    const int bn = pick_bn(Cout, 8);
    cudaError_t err;
    if (bn == 8)
      err = launch_wgmma<8, 9>(x, wp, bias, y, N, H, W, Cin, Cout, relu, st);
    else if (bn == 64)
      err = launch_wgmma<64, 1>(x, wp, bias, y, N, H, W, Cin, Cout, relu, st);
    else
      err = launch_wgmma<128, 1>(x, wp, bias, y, N, H, W, Cin, Cout, relu, st);
    return static_cast<int>(err);
  }
  const long long M = (long long)N * H * W;
  const int Kp = (9 * Cin + BK - 1) / BK * BK, Np = (Cout + BNG - 1) / BNG * BNG;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)(Np / BNG));
  reflect_conv3x3_gather_kernel<<<grid, GTHREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wp),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y), N, H, W, Cin, Cout, Kp,
      Np, relu);
  return static_cast<int>(cudaGetLastError());
}

// The float32 entry point: x, bias, y float32; wp the float32
// (roundup(9*Cin, 32), roundup(Cout, 64)) matrix of kernels/conv.py::pack_weight,
// for any Cin. Exact float32 (FFMA, no tensor cores). Same contract otherwise.
extern "C" int ccst_reflect_conv3x3_f32(const void* x, const void* wp, const void* bias, void* y,
                                        int N, int H, int W, int Cin, int Cout, int relu,
                                        void* stream) {
  const long long M = (long long)N * H * W;
  const int Kp = (9 * Cin + FBK - 1) / FBK * FBK, Np = (Cout + FBN - 1) / FBN * FBN;
  dim3 grid((unsigned)((M + FBM - 1) / FBM), (unsigned)(Np / FBN));
  reflect_conv3x3_f32_kernel<<<grid, FTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(wp), static_cast<const float*>(bias),
      static_cast<float*>(y), N, H, W, Cin, Cout, Kp, Np, relu);
  return static_cast<int>(cudaGetLastError());
}
