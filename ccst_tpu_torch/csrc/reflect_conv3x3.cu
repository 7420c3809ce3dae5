// Reflection-padded 3x3 convolution + bias + optional ReLU, NHWC bf16 (and float32), for Hopper.
//
// Replaces ccst_tpu/kernels/conv_pallas.py::reflect_conv3x3_fused (_kernel): the
// torch ReflectionPad2d(1) halo is never materialized, the 3x3 conv is a GEMM
// with f32 accumulation, and bias + ReLU run in f32 before the one bf16 rounding
// (the rounding point of ccst_tpu/models/vgg.py::conv2d). Every route also
// takes edge padding (the padded index clamped instead of mirrored): the packed
// engine's level-1 convs on the space-to-depth plane, where edge padding of the
// packed plane is reflect padding of the image (ccst_tpu/models/vgg_fast.py::
// packed_reflect_conv).
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
// float32 (the engines' verification mode, --dtype float32) is exact: float32
// operands, FFMA sums in float32, no tensor cores and so no TF32 rounding
// anywhere. It is bound by the float32 FFMA rate (67 TFLOP/s on an H100 SXM at
// 700 W, a fifteenth of the bf16 tensor rate) at every layer but the two
// few-channel ones: conv1_1 by writing its output, dconv1_1 (Cout = 3) by
// reading its 64-channel input. Cin % 4 == 0 (every float32 layer but conv1_1)
// takes the stage kernel below: a block's tile of 8 x 16 pixels x 128 output
// channels (16 x 16 x 64 where Cout <= 64; 32 x 64 x 4 or 8 for the narrow
// Cout <= 8), 256 threads of 8 pixels x 8 channels; per chunk of 8 input
// channels (4 for the narrow tile) the reflected halo is copied once with
// 16-byte cp.async into a pixel-major plane (a pixel's channels are one
// aligned run, so every tap's read of a pixel is a float4) and the chunk's
// weights, packed on the host as [n tile][chunk][tap][ci][BN], arrive as one
// cp.async.bulk on an mbarrier; the next chunk's halo and weights are in
// flight while this chunk's FFMAs run, one block barrier a chunk. Each step
// is an outer product: four float4 loads of one pixel's channels and of the
// held weights feed 16 FFMAs a load. Sums run chunk, then tap, then channel.
// conv1_1 (Cin = 3) keeps the scalar-gather FFMA kernel, picked by Cin.
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
                              int N, int H, int W, int Cin, int Cout, int Kp, int Np, int relu,
                              int reflect) {
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
        const int hh = pad_index(a_h + tap / 3 - 1, H, reflect);
        const int ww = pad_index(a_w + tap % 3 - 1, W, reflect);
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

// ---- float32, Cin % 4 != 0 (conv1_1): scalar gather, FFMA tiles ------------

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
                           int W, int Cin, int Cout, int Kp, int Np, int relu, int reflect) {
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
        const int hh = pad_index(a_h + tap / 3 - 1, H, reflect);
        const int ww = pad_index(a_w + tap % 3 - 1, W, reflect);
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

// ---- float32, Cin % 4 == 0: the chunk's halo and weights resident, FFMA ----

namespace f32 {

constexpr int THREADS = 256;
constexpr int PX = 8;  // pixels of a thread: neighbours in one tile row

// The tile of an output-channel width BN (kernels/conv.py::f32_tile mirrors it).
template <int BN> struct Tile {
  static constexpr int CG = BN >= 64 ? BN / 8 : 1;       // threads along N (channel groups)
  static constexpr int HALVES = BN >= 8 ? 2 : 1;         // float4s of channels a thread: 4 cg + h BN / 2
  static constexpr int PGW = 32 / CG;                    // tile rows of a warp
  static constexpr int TWG = BN >= 64 ? 2 : 8;           // pixel groups along a tile row
  static constexpr int TW = TWG * PX;                    // 16, or 64 for the narrow tile
  static constexpr int TH = THREADS / 32 / TWG * PGW;    // 8 (BN 128), 16 (BN 64), 32 (narrow)
  static constexpr int CK = BN >= 64 ? 8 : 4;            // input channels a chunk
  // floats of a halo row: four past the pixels, so that the rows a warp reads
  // at once start on different banks (20 or 12 banks apart)
  static constexpr int RP = (TW + 2) * CK + 4;
  static constexpr int HALO_F = (TH + 2) * RP;
  static constexpr int STAGE_F = 9 * CK * BN;            // one chunk's weights
  static constexpr int PIECES = CK / 4;                  // 16-byte pieces of a pixel's chunk
  static constexpr size_t SMEM = 2 * (HALO_F + STAGE_F) * sizeof(float) + 16;
};

struct Geom {
  int N, H, W, Cin, Cout;
  int nchunks, tiles_x, tiles_y, ntiles_n;
  int reflect;  // 1: reflect padding, 0: edge padding
};

template <int BN>
__global__ void __launch_bounds__(THREADS, 2)
reflect_conv3x3_f32_stage_kernel(const float* __restrict__ x, const float* __restrict__ wp,
                                 const float* __restrict__ bias, float* __restrict__ y, int relu,
                                 const Geom g) {
  using T = Tile<BN>;
  extern __shared__ __align__(128) float fsm[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cg = lane % T::CG;
  const int hx = warp % T::TWG;
  const int row = warp / T::TWG * T::PGW + lane / T::CG;
  int b = blockIdx.x;
  const int ntile = b % g.ntiles_n; b /= g.ntiles_n;
  const int x0 = b % g.tiles_x * T::TW; b /= g.tiles_x;
  const int y0 = b % g.tiles_y * T::TH;
  const int n = b / g.tiles_y;
  const int n0 = ntile * BN;
  const uint32_t bars = smem_u32(fsm + 2 * (T::HALO_F + T::STAGE_F));

  if (tid == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // chunk c into buffer c % 2: the reflected halo by 16-byte copies (zero
  // past Cin, where the weights are zero too), the weights by one bulk copy
  auto load = [&](int c) {
    float* halo = fsm + (c & 1) * T::HALO_F;
    for (int it = tid; it < (T::TH + 2) * (T::TW + 2) * T::PIECES; it += THREADS) {
      const int p = it / T::PIECES, piece = it - p * T::PIECES;
      const int hy = p / (T::TW + 2), hxx = p - hy * (T::TW + 2);
      const int gy = pad_index(y0 - 1 + hy, g.H, g.reflect);
      const int gx = pad_index(x0 - 1 + hxx, g.W, g.reflect);
      const int ci = c * T::CK + 4 * piece;
      const bool in = ci < g.Cin;
      const float* src = in ? x + (static_cast<size_t>(n * g.H + gy) * g.W + gx) * g.Cin + ci : x;
      cp_async16(smem_u32(halo + hy * T::RP + hxx * T::CK + 4 * piece), src, in);
    }
    if (tid == 0) {
      const uint32_t bar = bars + 8 * (c & 1);
      fence_proxy_async();  // the bulk copy overwrites what generic loads last read
      mbar_expect_tx(bar, T::STAGE_F * 4);
      bulk_load(smem_u32(fsm + 2 * T::HALO_F + (c & 1) * T::STAGE_F),
                wp + (static_cast<size_t>(ntile) * g.nchunks + c) * T::STAGE_F, T::STAGE_F * 4, bar);
    }
  };

  float acc[PX][T::HALVES][4];
#pragma unroll
  for (int i = 0; i < PX; ++i)
#pragma unroll
    for (int h = 0; h < T::HALVES; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][h][j] = 0.0f;

  load(0);
  cp_async_commit();
  for (int c = 0; c < g.nchunks; ++c) {
    cp_async_wait<0>();  // this thread's copies of chunk c have landed
    __syncthreads();     // everyone's have, and nobody still reads buffer (c + 1) % 2
    if (c + 1 < g.nchunks) load(c + 1);
    cp_async_commit();
    mbar_wait(bars + 8 * (c & 1), (c >> 1) & 1);

    const float* halo = fsm + (c & 1) * T::HALO_F + row * T::RP + hx * PX * T::CK;
    const float* wst = fsm + 2 * T::HALO_F + (c & 1) * T::STAGE_F + 4 * cg;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - dy * 3;
      const float* a_tap = halo + dy * T::RP + dx * T::CK;
      const float* b_tap = wst + tap * T::CK * BN;
#pragma unroll
      for (int c4 = 0; c4 < T::CK; c4 += 4) {
        float4 wb[4][T::HALVES];  // channels c4 .. c4 + 3 of the chunk, this thread's outputs
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int h = 0; h < T::HALVES; ++h)
            wb[q][h] = *reinterpret_cast<const float4*>(b_tap + (c4 + q) * BN + h * (BN / 2));
#pragma unroll
        for (int i = 0; i < PX; ++i) {
          const float4 a4 = *reinterpret_cast<const float4*>(a_tap + i * T::CK + c4);
          const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int h = 0; h < T::HALVES; ++h) {
              acc[i][h][0] = fmaf(a[q], wb[q][h].x, acc[i][h][0]);
              acc[i][h][1] = fmaf(a[q], wb[q][h].y, acc[i][h][1]);
              acc[i][h][2] = fmaf(a[q], wb[q][h].z, acc[i][h][2]);
              acc[i][h][3] = fmaf(a[q], wb[q][h].w, acc[i][h][3]);
            }
        }
      }
    }
  }

  // epilogue: bias + ReLU in float32, 16-byte stores where Cout % 4 == 0
  const int oy = y0 + row;
  if (oy >= g.H) return;
#pragma unroll
  for (int h = 0; h < T::HALVES; ++h) {
    const int co = n0 + 4 * cg + h * (BN / 2);
    if (co >= g.Cout) continue;
    float bv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = co + j < g.Cout ? bias[co + j] : 0.0f;
#pragma unroll
    for (int i = 0; i < PX; ++i) {
      const int ox = x0 + hx * PX + i;
      if (ox >= g.W) continue;
      float out[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float v = acc[i][h][j] + bv[j];
        out[j] = relu ? fmaxf(v, 0.0f) : v;
      }
      float* dst = y + (static_cast<size_t>(n * g.H + oy) * g.W + ox) * g.Cout + co;
      if ((g.Cout & 3) == 0) {
        *reinterpret_cast<float4*>(dst) = make_float4(out[0], out[1], out[2], out[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (co + j < g.Cout) dst[j] = out[j];
      }
    }
  }
}

template <int BN>
cudaError_t launch_stage(const void* x, const void* wp, const void* bias, void* y, int N, int H,
                         int W, int Cin, int Cout, int relu, int reflect, cudaStream_t st) {
  using T = Tile<BN>;
  Geom g{N, H, W, Cin, Cout, (Cin + T::CK - 1) / T::CK, (W + T::TW - 1) / T::TW,
         (H + T::TH - 1) / T::TH, (Cout + BN - 1) / BN, reflect};
  auto kernel = reflect_conv3x3_f32_stage_kernel<BN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(T::SMEM));
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>(N) * g.tiles_y * g.tiles_x * g.ntiles_n;
  kernel<<<static_cast<unsigned>(blocks), THREADS, T::SMEM, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(wp), static_cast<const float*>(bias),
      static_cast<float*>(y), relu, g);
  return cudaGetLastError();
}

}  // namespace f32

template <int BN, int TPS>
cudaError_t launch_wgmma(const void* x, const void* wp, const void* bias, void* y, int N, int H,
                         int W, int Cin, int Cout, int relu, int reflect, cudaStream_t st) {
  const ConvGeom g = make_geom(N, H, W, Cin * 2, Cout, BN, TPS, reflect);
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
// gather kernel. reflect: 1 reflect padding (every VGG layer), 0 edge padding
// (the packed engine's level-1 convs). Launches on `stream` and returns the
// first CUDA error (0 on success).
extern "C" int ccst_reflect_conv3x3_bf16(const void* x, const void* wp, const void* bias,
                                         void* y, int N, int H, int W, int Cin, int Cout,
                                         int relu, int reflect, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Cin % 8 == 0) {
    const int bn = pick_bn(Cout, 8);
    cudaError_t err;
    if (bn == 8)
      err = launch_wgmma<8, 9>(x, wp, bias, y, N, H, W, Cin, Cout, relu, reflect, st);
    else if (bn == 64)
      err = launch_wgmma<64, 1>(x, wp, bias, y, N, H, W, Cin, Cout, relu, reflect, st);
    else
      err = launch_wgmma<128, 1>(x, wp, bias, y, N, H, W, Cin, Cout, relu, reflect, st);
    return static_cast<int>(err);
  }
  const long long M = (long long)N * H * W;
  const int Kp = (9 * Cin + BK - 1) / BK * BK, Np = (Cout + BNG - 1) / BNG * BNG;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)(Np / BNG));
  reflect_conv3x3_gather_kernel<<<grid, GTHREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wp),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y), N, H, W, Cin, Cout, Kp,
      Np, relu, reflect);
  return static_cast<int>(cudaGetLastError());
}

// The float32 entry point: x, bias, y float32; exact float32 (FFMA, no tensor
// cores). wp: for Cin % 4 == 0 the stage tiles [n tile][chunk][tap][ci][BN] of
// kernels/conv.py::pack_f32_stages (BN = 4 for Cout <= 4, 8 for <= 8, 64 for
// <= 64, else 128; chunks of 8 channels, 4 for BN <= 8); otherwise the float32
// (roundup(9*Cin, 32), roundup(Cout, 64)) matrix of the gather kernel. Same
// contract otherwise.
extern "C" int ccst_reflect_conv3x3_f32(const void* x, const void* wp, const void* bias, void* y,
                                        int N, int H, int W, int Cin, int Cout, int relu,
                                        int reflect, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Cin % 4 == 0) {
    cudaError_t err;
    if (Cout <= 4)
      err = f32::launch_stage<4>(x, wp, bias, y, N, H, W, Cin, Cout, relu, reflect, st);
    else if (Cout <= 8)
      err = f32::launch_stage<8>(x, wp, bias, y, N, H, W, Cin, Cout, relu, reflect, st);
    else if (Cout <= 64)
      err = f32::launch_stage<64>(x, wp, bias, y, N, H, W, Cin, Cout, relu, reflect, st);
    else
      err = f32::launch_stage<128>(x, wp, bias, y, N, H, W, Cin, Cout, relu, reflect, st);
    return static_cast<int>(err);
  }
  const long long M = (long long)N * H * W;
  const int Kp = (9 * Cin + FBK - 1) / FBK * FBK, Np = (Cout + FBN - 1) / FBN * FBN;
  dim3 grid((unsigned)((M + FBM - 1) / FBM), (unsigned)(Np / FBN));
  reflect_conv3x3_f32_kernel<<<grid, FTHREADS, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(wp), static_cast<const float*>(bias),
      static_cast<float*>(y), N, H, W, Cin, Cout, Kp, Np, relu, reflect);
  return static_cast<int>(cudaGetLastError());
}
