// Two chained edge-padded int8 3x3 convs in one kernel, the intermediate kept
// in shared memory: the level-1 stage of the int8 engines, NHWC, for Hopper.
//
// Replaces ccst_tpu/kernels/level1_pallas.py::fused_two_conv
// (_fused_two_conv_kernel), in its two uses:
//   K1 encoder_level1: packed int8 (N, H/2, W/2, 12) -> conv1_1 (12 -> 256,
//      requant + ReLU) -> conv1_2 (256 -> 256, requant + ReLU) -> max over the
//      4 phases (= pool1) -> int8 (N, H/2, W/2, 64);
//   K2 decoder_level1: int8 (N, H/2, W/2, 64) -> folded dconv1_2 (64 -> 256,
//      requant + ReLU) -> packed dconv1_1 (256 -> 12, dequant, no ReLU) ->
//      bf16 (N, H/2, W/2, 12).
// The arithmetic is that of two ccst_tpu/models/vgg_fast.py::_qconv_s calls
// (edge padding, int32 accumulation, y = float(acc)*k + kb rounded twice,
// rint half to even, clip), so the output equals the unfused K0 chain bit for
// bit. K1 requantizes each phase and then takes the max of the int8 values, as
// the unfused chain does; the Pallas kernel takes the max in float32 first.
// rint and clip are monotone, so both orders give the same bits.
//
// What bounds it on the H100: at 512 px the unfused chain writes and re-reads
// a (4, 256, 256, 256) int8 intermediate (64 MB each way per batch of 4) and
// K1's conv1_2 has K = 2304, so the pair is tensor-core bound once the
// intermediate stays on chip; the price is the halo that each block recomputes
// (10 x 18 conv1 pixels for 8 x 16 outputs, 1.4x conv1's work).
//
// Design: a block owns an 8 x 16 tile of output pixels of one image. It
//   1. copies the (8+4) x (16+4) input pixels it needs into shared memory,
//      with clamped (edge) coordinates;
//   2. computes conv1 on the (8+2) x (16+2) pixels of the tile and its halo,
//      requantizes them to int8 and keeps them in shared memory. A halo pixel
//      outside the image is the EDGE REPLICA of conv1's output at the nearest
//      pixel inside (conv1 is computed at the clamped position), which is
//      what edge padding of the intermediate means; conv1 of an over-padded
//      input would differ (level1_pallas.py:33-38);
//   3. runs conv2 from that buffer and writes the epilogue.
// Both convs are implicit GEMMs on int8 tensor cores (mma.sync.m16n8k32,
// s8_mma.cuh); their A operand comes from shared memory and their B operand
// (the weights, output-channel-major, k contiguous, the K0 layout) from the
// L1/L2-cached global copy. Any even image size works: ragged tiles clamp
// their reads and skip their stores. The TPU kernel's zero-free block
// decomposition of conv1_2 is not used: the dense packed weights give the same
// integers. wgmma/TMA, shared-memory weight tiles and the zero-free split are
// later work.
#include "s8_mma.cuh"

namespace {

using namespace ccst_s8;

constexpr int THREADS = 256;  // 8 warps
constexpr int TH = 8, TW = 16;                  // output tile (packed pixels)
constexpr int MH = TH + 2, MW = TW + 2;         // conv1 tile + halo
constexpr int MPIX = MH * MW;                   // 180
constexpr int IH = TH + 4, IW = TW + 4;         // input tile + both halos
constexpr int IPIX = IH * IW;                   // 240
constexpr int CMID = 256;                       // conv1 output channels
constexpr int MSTR = CMID + 16;                 // bytes per mid pixel (272: no bank conflicts)

__device__ __forceinline__ int ldg32(const int8_t* p) {
  return __ldg(reinterpret_cast<const int*>(p));
}

template <int CIN>
struct Geometry {
  static constexpr int ISTR = CIN % 16 == 0 ? CIN + 16 : CIN;      // bytes per input pixel
  static constexpr int IN_BYTES = (IPIX * ISTR + 15) / 16 * 16;
  static constexpr int K1 = 9 * CIN;
};

// POOL: K1 (conv2 256 -> 256, phase max, int8 out of 64 channels);
// otherwise K2 (conv2 256 -> Cout <= 16, bf16 out).
template <int CIN, bool POOL>
__global__ void __launch_bounds__(THREADS)
fused_two_conv_s8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w1,
                         const float* __restrict__ k1, const float* __restrict__ kb1,
                         const int8_t* __restrict__ w2, const float* __restrict__ k2,
                         const float* __restrict__ kb2, void* __restrict__ yv, int Hb, int Wb,
                         int Kp1, int Kp2, int Cout) {
  using G = Geometry<CIN>;
  extern __shared__ __align__(128) int8_t smem[];
  int8_t* in_s = smem;
  int8_t* mid = smem + G::IN_BYTES;
  int8_t* stage = mid + MPIX * MSTR;  // POOL only: 128 pixels x 256 requantized channels

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int w0 = blockIdx.x * TW, h0 = blockIdx.y * TH, img = blockIdx.z;

  // 1. the input tile, rows h0-2 .. h0+TH+1 and columns w0-2 .. w0+TW+1, clamped
  for (int idx = tid; idx < IPIX * (CIN / 4); idx += THREADS) {
    const int pix = idx / (CIN / 4), wd = idx - pix * (CIN / 4);
    const int i = pix / IW, j = pix - i * IW;
    const int hh = edge_index(h0 - 2 + i, Hb), ww = edge_index(w0 - 2 + j, Wb);
    *reinterpret_cast<int*>(in_s + pix * G::ISTR + wd * 4) = *reinterpret_cast<const int*>(
        x + (((long long)img * Hb + hh) * Wb + ww) * CIN + wd * 4);
  }
  __syncthreads();

  // 2. conv1 on the 180 tile + halo pixels, in 3 passes of 64 rows; warp w
  //    owns output channels 32w .. 32w+31
  for (int pass = 0; pass < 3; ++pass) {
    int base[4][2];  // in_s offset of each A row's (dy, dx) = (0, 0) tap
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = min(pass * 64 + i * 16 + g + 8 * h, MPIX - 1);
        const int mr = r / MW, mc = r - mr * MW;
        // conv1 at the clamped pixel: the halo outside the image replicates
        // conv1's boundary output
        const int hr = edge_index(h0 - 1 + mr, Hb), wc = edge_index(w0 - 1 + mc, Wb);
        base[i][h] = ((hr - h0 + 1) * IW + (wc - w0 + 1)) * G::ISTR;
      }
    int acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

    for (int k0 = 0; k0 < Kp1; k0 += 32) {
      int ofs[2];
      bool live[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = k0 + 16 * h + 4 * t;
        live[h] = k < G::K1;
        const int tap = live[h] ? k / CIN : 0;
        ofs[h] = ((tap / 3) * IW + tap % 3) * G::ISTR + (live[h] ? k - tap * CIN : 0);
      }
      int fa[4][4], fb[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        fa[i][0] = live[0] ? *reinterpret_cast<const int*>(in_s + base[i][0] + ofs[0]) : 0;
        fa[i][1] = live[0] ? *reinterpret_cast<const int*>(in_s + base[i][1] + ofs[0]) : 0;
        fa[i][2] = live[1] ? *reinterpret_cast<const int*>(in_s + base[i][0] + ofs[1]) : 0;
        fa[i][3] = live[1] ? *reinterpret_cast<const int*>(in_s + base[i][1] + ofs[1]) : 0;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* wrow = w1 + (long long)(warp * 32 + j * 8 + g) * Kp1 + k0 + 4 * t;
        fb[j][0] = ldg32(wrow);
        fb[j][1] = ldg32(wrow + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], fa[i], fb[j]);
    }
    // requant + ReLU into the mid buffer
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = warp * 32 + j * 8 + 2 * t;
        const float ka = k1[n], kb = kb1[n], kc = k1[n + 1], kd = kb1[n + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = pass * 64 + i * 16 + g + 8 * h;
          if (r < MPIX) {
            const uint8_t q0 = (uint8_t)requant(dequant(acc[i][j][2 * h], ka, kb), 0.0f);
            const uint8_t q1 = (uint8_t)requant(dequant(acc[i][j][2 * h + 1], kc, kd), 0.0f);
            *reinterpret_cast<uint16_t*>(mid + r * MSTR + n) = (uint16_t)(q0 | (q1 << 8));
          }
        }
      }
  }
  __syncthreads();

  // 3. conv2 from the mid buffer. K1: warps 2 (rows of 4 output rows) x 4
  //    (32 channels), two passes over 128 channels; K2: warp w owns output
  //    row w and the 16 (padded) output channels.
  constexpr int MT = POOL ? 4 : 1;         // m16 tiles (output rows) per warp
  constexpr int NT = POOL ? 4 : 2;         // n8 tiles per warp
  constexpr int WARPS_M = TH / MT;
  constexpr int PASSES = POOL ? 2 : 1;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  for (int pass = 0; pass < PASSES; ++pass) {
    const int n_off = pass * (8 / WARPS_M) * NT * 8 + wn * NT * 8;
    int acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - dy * 3;
      const int8_t* pa[MT];
#pragma unroll
      for (int i = 0; i < MT; ++i) pa[i] = mid + ((wm * MT + i + dy) * MW + g + dx) * MSTR + 4 * t;
      const int8_t* pb[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        pb[j] = w2 + (long long)(n_off + j * 8 + g) * Kp2 + tap * CMID + 4 * t;
#pragma unroll 2
      for (int c0 = 0; c0 < CMID; c0 += 32) {
        int fa[MT][4], fb[NT][2];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          fa[i][0] = *reinterpret_cast<const int*>(pa[i] + c0);
          fa[i][1] = *reinterpret_cast<const int*>(pa[i] + 8 * MSTR + c0);
          fa[i][2] = *reinterpret_cast<const int*>(pa[i] + c0 + 16);
          fa[i][3] = *reinterpret_cast<const int*>(pa[i] + 8 * MSTR + c0 + 16);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          fb[j][0] = ldg32(pb[j] + c0);
          fb[j][1] = ldg32(pb[j] + c0 + 16);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], fa[i], fb[j]);
      }
    }
    // epilogue
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int orow = wm * MT + i;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n_off + j * 8 + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ocol = g + 8 * h;
          if constexpr (POOL) {
            const uint8_t q0 = (uint8_t)requant(dequant(acc[i][j][2 * h], k2[n], kb2[n]), 0.0f);
            const uint8_t q1 =
                (uint8_t)requant(dequant(acc[i][j][2 * h + 1], k2[n + 1], kb2[n + 1]), 0.0f);
            *reinterpret_cast<uint16_t*>(stage + (orow * TW + ocol) * MSTR + n) =
                (uint16_t)(q0 | (q1 << 8));
          } else {
            const int oh = h0 + orow, ow = w0 + ocol;
            if (n < Cout && oh < Hb && ow < Wb) {
              __nv_bfloat162 v;
              v.x = __float2bfloat16_rn(dequant(acc[i][j][2 * h], k2[n], kb2[n]));
              v.y = __float2bfloat16_rn(dequant(acc[i][j][2 * h + 1], k2[n + 1], kb2[n + 1]));
              *reinterpret_cast<__nv_bfloat162*>(
                  static_cast<__nv_bfloat16*>(yv) + (((long long)img * Hb + oh) * Wb + ow) * Cout + n) = v;
            }
          }
        }
      }
    }
  }

  if constexpr (POOL) {
    // max over the 4 phases (channel groups of 64) of the requantized values
    __syncthreads();
    constexpr int CG = CMID / 4;
    for (int idx = tid; idx < TH * TW * (CG / 16); idx += THREADS) {
      const int px = idx / (CG / 16), ch = (idx - px * (CG / 16)) * 16;
      const int oh = h0 + px / TW, ow = w0 + px % TW;
      if (oh >= Hb || ow >= Wb) continue;
      uint4 m = *reinterpret_cast<const uint4*>(stage + px * MSTR + ch);
#pragma unroll
      for (int p = 1; p < 4; ++p) {
        const uint4 v = *reinterpret_cast<const uint4*>(stage + px * MSTR + p * CG + ch);
        m.x = __vmaxs4(m.x, v.x);
        m.y = __vmaxs4(m.y, v.y);
        m.z = __vmaxs4(m.z, v.z);
        m.w = __vmaxs4(m.w, v.w);
      }
      *reinterpret_cast<uint4*>(static_cast<int8_t*>(yv) +
                                (((long long)img * Hb + oh) * Wb + ow) * CG + ch) = m;
    }
  }
}

template <int CIN, bool POOL>
int launch(const int8_t* x, const int8_t* w1, const float* k1, const float* kb1,
           const int8_t* w2, const float* k2, const float* kb2, void* y, int N, int Hb, int Wb,
           int Kp1, int Kp2, int Cout, cudaStream_t st) {
  using G = Geometry<CIN>;
  const int bytes = G::IN_BYTES + MPIX * MSTR + (POOL ? TH * TW * MSTR : 0);
  auto kernel = fused_two_conv_s8_kernel<CIN, POOL>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((unsigned)((Wb + TW - 1) / TW), (unsigned)((Hb + TH - 1) / TH), (unsigned)N);
  kernel<<<grid, THREADS, bytes, st>>>(x, w1, k1, kb1, w2, k2, kb2, y, Hb, Wb, Kp1, Kp2, Cout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes). x: (N, Hb, Wb, Cin) int8 with
// Cin = 12 (pool = 1, K1) or 64 (pool = 0, K2); w1: (256, Kp1) and w2:
// (>= 16 or 256, Kp2) int8 weights in the K0 layout (output-channel-major,
// Kp = roundup(9*Cin, 64), zero padded); k1, kb1: (256,) f32; k2, kb2: (256,)
// or (Cout,) f32; y: (N, Hb, Wb, 64) int8 (K1) or (N, Hb, Wb, Cout) bf16 (K2,
// Cout <= 16 and even). All contiguous. Launches on `stream` and returns the
// CUDA error code (0 on success).
extern "C" int ccst_fused_two_conv_s8(const void* x, const void* w1, const void* k1,
                                      const void* kb1, const void* w2, const void* k2,
                                      const void* kb2, void* y, int N, int Hb, int Wb, int Cin,
                                      int Kp1, int Kp2, int Cout, int pool, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const int8_t*>(x);
  const auto* w1b = static_cast<const int8_t*>(w1);
  const auto* w2b = static_cast<const int8_t*>(w2);
  const auto* k1f = static_cast<const float*>(k1);
  const auto* kb1f = static_cast<const float*>(kb1);
  const auto* k2f = static_cast<const float*>(k2);
  const auto* kb2f = static_cast<const float*>(kb2);
  if (pool && Cin == 12)
    return launch<12, true>(xb, w1b, k1f, kb1f, w2b, k2f, kb2f, y, N, Hb, Wb, Kp1, Kp2, Cout, st);
  if (!pool && Cin == 64)
    return launch<64, false>(xb, w1b, k1f, kb1f, w2b, k2f, kb2f, y, N, Hb, Wb, Kp1, Kp2, Cout, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
