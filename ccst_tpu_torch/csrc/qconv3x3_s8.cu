// int8 3x3 convolution (edge or reflect padding), int32 accumulation, with the
// static-scale epilogue of the int8 engines, NHWC, for Hopper.
//
// Replaces ccst_tpu/models/vgg_fast.py::_qconv_s (kernel K0), which XLA emitted
// on the TPU (jnp.pad + conv_general_dilated with int32 accumulation + a fused
// elementwise epilogue): every conv of the int8-static / int8-fused engines
// but the level-1 pair that level1_s8.cu fuses, and every conv of the dynamic
// int8 engine (vgg_fast.py::_qconv_apply: dequant at every layer, its k the
// product w_scale * a_scale formed on the device before the launch). Per
// output channel c:
//   y = float(acc) * k[c] + kb[c]            (two roundings, no FMA)
//   requant: rint (half to even), clip to [0 if relu else -127, 127] -> int8
//   dequant: optional ReLU -> bf16 (round to nearest even) or float32
//
// What bounds it on the H100: at 512 px every layer has K = 9*Cin = 576..4608
// (the packed conv1_1 has 108), so each input byte feeds hundreds of MACs and
// the convs are tensor-core bound; the 256->12 packed dconv1_1 is bound by
// reading its 256-channel input.
//
// Design: the core of reflect_conv3x3.cu (conv_igemm_sm90.cuh), in bytes the
// same kernel: wgmma.mma_async m64nNk32 s8 x s8 -> s32, both operands K-major
// (the only layout 8-bit wgmma takes: NHWC pixels are K-major per tap, the
// packed weights K-major per output channel); a halo tile gathered once per
// 128-channel chunk with the padded index mirrored or clamped; weights as
// pre-packed stage tiles fetched by cp.async.bulk + mbarrier; N = 128, 64, or
// 16 for the few-channel output (the packed dconv1_1, Cout = 12), whose nine
// taps share one stage. The epilogue runs from the accumulator registers with
// the exact float chain of s8_mma.cuh and stores 16 bytes at a time (int8: 16
// channels after a quad transpose and a byte permute, the core's
// store_tile_s8; bf16: 8 channels).
// Integer sums are order-free, so the result equals the plain version bit for
// bit.
//
// Cin not a multiple of 16 (the packed conv1_1, Cin = 12, K = 108) cannot be
// copied 16 bytes at a time: that shape class keeps the earlier 4-byte-gather
// kernel on mma.sync.m16n8k32 below, picked by Cin alone, with its own
// (Np, Kp) weight matrix.
#include "conv_igemm_sm90.cuh"
#include "s8_mma.cuh"

namespace {

using namespace ccst_s8;
using namespace ccst_igemm;

// OUT: 0 -> int8 (requant), 1 -> bf16, 2 -> float32 (dequant). The float32
// output (the engines' --dtype float32 mode only) is compiled for one block an
// SM: its scalar store epilogue at BN = 128 spilled at two blocks' 128
// registers, and a spilled wgmma accumulator is a race.
template <int BN, int TPS, int OUT>
__global__ void __launch_bounds__(ccst_igemm::THREADS, OUT == 2 ? 1 : min_blocks(BN))
qconv3x3_s8_wgmma_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ wp,
                         const float* __restrict__ kmul, const float* __restrict__ kadd,
                         void* __restrict__ yv, int relu, const ConvGeom g) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ float sk[BN], skb[BN];
  int n, y0, x0, ntile;
  block_tile(g, n, y0, x0, ntile);
  const int n0 = ntile * BN;
  if (threadIdx.x < BN) {
    const bool in = n0 + threadIdx.x < g.Cout;
    sk[threadIdx.x] = in ? kmul[n0 + threadIdx.x] : 0.0f;
    skb[threadIdx.x] = in ? kadd[n0 + threadIdx.x] : 0.0f;
  }

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  conv_mainloop<false, BN, TPS>(acc, x, wp, g, n, y0, x0, ntile, smem);

  const int t = threadIdx.x & 3;
  const float lo = relu ? 0.0f : -127.0f;
  // the float of accumulator a at tile column 8 j + 2 t + e, before requant
  auto value = [&](int j, int e, int a) {
    const int c = 8 * j + 2 * t + e;
    const float v = dequant(a, sk[c], skb[c]);
    return (OUT != 0 && relu) ? fmaxf(v, 0.0f) : v;
  };

  if constexpr (OUT == 1) {
    store_tile_bf16<BN>(acc, value, static_cast<__nv_bfloat16*>(yv), g, n, y0, x0, n0);
  } else if constexpr (OUT == 0) {
    auto quant = [&](int j, int e, int a) {
      return static_cast<uint32_t>(static_cast<uint8_t>(requant(value(j, e, a), lo)));
    };
    store_tile_s8<BN>(acc, quant, static_cast<int8_t*>(yv), g, n, y0, x0, n0);
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long px = out_pixel(g, n, y0, x0, h);
      const long long base = (px < 0 ? 0 : px) * g.Cout + n0;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * t + e;
          const float f = value(j, e, acc[4 * j + 2 * h + e]);
          if (px >= 0 && n0 + col < g.Cout) static_cast<float*>(yv)[base + col] = f;
        }
    }
  }
}

// ---- Cin % 16 != 0 (Cin % 4 == 0): 4-byte gather, mma.sync tiles ----------

constexpr int BM = 128;       // output pixels per block
constexpr int BNG = 64;       // output channels per block
constexpr int BK = 64;        // reduction depth (bytes) per stage
constexpr int GTHREADS = 256; // 8 warps: 4 along M x 2 along N, 32 x 32 each
constexpr int SPAD = 16;      // bytes of padding per smem row (80-byte rows: no bank conflicts)
constexpr int CPAD = 4;       // int32 padding per epilogue row

struct SmemAB {
  int8_t a[BM][BK + SPAD];
  int8_t b[BNG][BK + SPAD];
};

union Smem {
  SmemAB ab;
  int c[BM][BNG + CPAD];  // epilogue staging, reuses the operand buffers
};

// M = N*H*W output pixels, N = Cout, K = 9*Cin in HWIO order; wk is the
// (Np, Kp) output-channel-major weight matrix, zero padded to 64 x 64.
template <int OUT>
__global__ void __launch_bounds__(GTHREADS)
qconv3x3_s8_gather_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wk,
                          const float* __restrict__ kmul, const float* __restrict__ kadd,
                          void* __restrict__ yv, int N, int H, int W, int Cin, int Cout, int Kp,
                          int reflect, int relu) {
  __shared__ __align__(128) Smem sm;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 3;   // warp row (M)
  const int wn = warp >> 2;  // warp column (N)
  const int g = lane >> 2, t = lane & 3;
  const long long HW = (long long)H * W;
  const long long M = (long long)N * HW;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BNG;

  // A gather: a thread owns one output pixel and half of the BK reduction
  // bytes, four at a time (Cin % 4 == 0: a word never straddles a tap)
  const int a_row = tid >> 1, a_kk = (tid & 1) * (BK / 2);
  const long long a_m = m0 + a_row;
  const bool a_ok = a_m < M;
  const long long a_img = (a_ok ? a_m / HW : 0) * HW;  // first pixel of the image
  const int a_rem = a_ok ? (int)(a_m - a_img) : 0;
  const int a_h = a_rem / W, a_w = a_rem - a_h * W;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < Kp; k0 += BK) {
    for (int idx = tid; idx < BNG * (BK / 16); idx += GTHREADS) {
      const int row = idx / (BK / 16), ch = (idx - row * (BK / 16)) * 16;
      *reinterpret_cast<uint4*>(&sm.ab.b[row][ch]) =
          *reinterpret_cast<const uint4*>(wk + (long long)(n0 + row) * Kp + k0 + ch);
    }
    int tap = (k0 + a_kk) / Cin, ci = (k0 + a_kk) - tap * Cin;
#pragma unroll
    for (int e = 0; e < BK / 8; ++e) {
      int v = 0;
      if (a_ok && tap < 9) {  // tap 9 is the zero padding of K
        const int hh = pad_index(a_h + tap / 3 - 1, H, reflect);
        const int ww = pad_index(a_w + tap % 3 - 1, W, reflect);
        v = *reinterpret_cast<const int*>(x + (a_img + (long long)hh * W + ww) * Cin + ci);
      }
      *reinterpret_cast<int*>(&sm.ab.a[a_row][a_kk + 4 * e]) = v;
      ci += 4;
      if (ci == Cin) { ci = 0; ++tap; }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      int fa[2][4], fb[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm * 32 + i * 16 + g;
        fa[i][0] = *reinterpret_cast<const int*>(&sm.ab.a[r][kk + 4 * t]);
        fa[i][1] = *reinterpret_cast<const int*>(&sm.ab.a[r + 8][kk + 4 * t]);
        fa[i][2] = *reinterpret_cast<const int*>(&sm.ab.a[r][kk + 16 + 4 * t]);
        fa[i][3] = *reinterpret_cast<const int*>(&sm.ab.a[r + 8][kk + 16 + 4 * t]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wn * 32 + j * 8 + g;
        fb[j][0] = *reinterpret_cast<const int*>(&sm.ab.b[c][kk + 4 * t]);
        fb[j][1] = *reinterpret_cast<const int*>(&sm.ab.b[c][kk + 16 + 4 * t]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], fa[i], fb[j]);
    }
    __syncthreads();
  }

  // epilogue: stage the int32 tile in shared memory, then the float epilogue
  // and one store of 8 channels where Cout allows
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = wm * 32 + i * 16 + g;
      const int c = wn * 32 + j * 8 + 2 * t;
      sm.c[r][c] = acc[i][j][0];
      sm.c[r][c + 1] = acc[i][j][1];
      sm.c[r + 8][c] = acc[i][j][2];
      sm.c[r + 8][c + 1] = acc[i][j][3];
    }
  __syncthreads();

  const float lo = relu ? 0.0f : -127.0f;
  for (int idx = tid; idx < BM * (BNG / 8); idx += GTHREADS) {
    const int row = idx / (BNG / 8);
    const int cg = (idx - row * (BNG / 8)) * 8;
    const long long m = m0 + row;
    const int co = n0 + cg;
    if (m >= M || co >= Cout) continue;
    const int ne = min(8, Cout - co);
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      v[e] = e < ne ? dequant(sm.c[row][cg + e], kmul[co + e], kadd[co + e]) : 0.0f;
      if (OUT != 0 && relu) v[e] = fmaxf(v[e], 0.0f);
    }
    if constexpr (OUT == 0) {
      int8_t* dst = static_cast<int8_t*>(yv) + m * Cout + co;
      __align__(8) int8_t out[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) out[e] = requant(v[e], lo);
      if (ne == 8 && (Cout & 7) == 0) {
        *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(out);
      } else {
        for (int e = 0; e < ne; ++e) dst[e] = out[e];
      }
    } else if constexpr (OUT == 1) {
      __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(yv) + m * Cout + co;
      __align__(16) __nv_bfloat16 out[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) out[e] = __float2bfloat16_rn(v[e]);
      if (ne == 8 && (Cout & 7) == 0) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(out);
      } else {
        for (int e = 0; e < ne; ++e) dst[e] = out[e];
      }
    } else {
      float* dst = static_cast<float*>(yv) + m * Cout + co;
      for (int e = 0; e < ne; ++e) dst[e] = v[e];
    }
  }
}

template <int BN, int TPS, int OUT>
cudaError_t launch_wgmma(const void* x, const void* wp, const void* k, const void* kb, void* y,
                         int N, int H, int W, int Cin, int Cout, int reflect, int relu,
                         int row_shift, cudaStream_t st) {
  const ConvGeom g = make_geom(N, H, W, Cin, Cout, BN, TPS, reflect, row_shift);
  return launch(qconv3x3_s8_wgmma_kernel<BN, TPS, OUT>, g, smem_bytes(g, BN, TPS), st,
                static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(wp),
                static_cast<const float*>(k), static_cast<const float*>(kb), y, relu);
}

template <int OUT>
cudaError_t launch_out(const void* x, const void* wp, const void* k, const void* kb, void* y,
                       int N, int H, int W, int Cin, int Cout, int reflect, int relu,
                       int row_shift, cudaStream_t st) {
  if (Cin % 16 == 0) {
    const int bn = pick_bn(Cout, 16);
    if (bn == 16)
      return launch_wgmma<16, 9, OUT>(x, wp, k, kb, y, N, H, W, Cin, Cout, reflect, relu,
                                      row_shift, st);
    if (bn == 64)
      return launch_wgmma<64, 1, OUT>(x, wp, k, kb, y, N, H, W, Cin, Cout, reflect, relu,
                                      row_shift, st);
    return launch_wgmma<128, 1, OUT>(x, wp, k, kb, y, N, H, W, Cin, Cout, reflect, relu,
                                     row_shift, st);
  }
  if (row_shift) return cudaErrorInvalidValue;  // the gather route centres every output
  const long long M = (long long)N * H * W;
  const int Kp = (9 * Cin + BK - 1) / BK * BK, Np = (Cout + BNG - 1) / BNG * BNG;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)(Np / BNG));
  qconv3x3_s8_gather_kernel<OUT><<<grid, GTHREADS, 0, st>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(wp),
      static_cast<const float*>(k), static_cast<const float*>(kb), y, N, H, W, Cin, Cout, Kp,
      reflect, relu);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). x: (N,H,W,Cin) int8, Cin % 4 == 0;
// k, kb: (Cout,) f32; y: (N,H,W,Cout) of int8 (out_kind 0), bf16 (1) or f32
// (2); all contiguous. wp: the packed weights of kernels/qconv.py::pack_weight:
// for Cin % 16 == 0 the stage tiles [n tile][chunk][tap][8][BN][16 int8] with
// BN = 16 (Cout <= 16), 64 (<= 64) or 128; otherwise the (roundup(Cout, 64),
// roundup(9*Cin, 64)) matrix of the gather kernel. reflect: 1 reflect, 0 edge
// padding. row_shift: output row h is the conv centred on input row h -
// row_shift (0 on every engine path; 1 is the direct side of the Winograd A/B,
// kernels/winograd.py::conv_direct; the wgmma route only). Launches on
// `stream` and returns the first CUDA error (0 on success).
extern "C" int ccst_qconv3x3_s8(const void* x, const void* wp, const void* k, const void* kb,
                                void* y, int N, int H, int W, int Cin, int Cout, int reflect,
                                int relu, int out_kind, int row_shift, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (out_kind == 0)
    err = launch_out<0>(x, wp, k, kb, y, N, H, W, Cin, Cout, reflect, relu, row_shift, st);
  else if (out_kind == 1)
    err = launch_out<1>(x, wp, k, kb, y, N, H, W, Cin, Cout, reflect, relu, row_shift, st);
  else
    err = launch_out<2>(x, wp, k, kb, y, N, H, W, Cin, Cout, reflect, relu, row_shift, st);
  return static_cast<int>(err);
}
