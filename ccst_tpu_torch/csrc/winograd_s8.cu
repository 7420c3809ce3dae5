// int8 3x3 conv, direct (9 taps) or Winograd F(2x2, 3x3), with the
// requant + ReLU epilogue, NHWC, for Hopper: the two sides of an A/B.
//
// Replaces benchmarks/winograd_ab.py::conv_kernel (kernel B2): _direct_kernel
// (9 int8 tap dots over a VMEM slab) and _wino_kernel (input transform
// B^T d B in float32, V = clip(rint(V / 4)) int8, 16 int8 position dots,
// inverse transform A^T M A), which share one slab copy (_dma_slab) so that
// the A/B isolates the transform at equal data movement. Per output channel:
//   y = float(acc) * k + kb (two roundings, no FMA), rint, clip [0, 127], int8.
// The padding is the reference's: 2 rows on top, 1 column on the left, edge
// replicated, read from padded row 0, so output row h is the conv centred on
// input row h - 1 (kernels/winograd.py says more).
//
// What bounds it on the H100: the A/B's shape (8, 256, 256, 256 -> 256) has
// K = 2304 for the direct conv, tensor-core bound as K0 is. Winograd cuts the
// tensor-core work 2.25x (16 products per 2x2 tile instead of 36) and moves it
// to CUDA cores: per 2x2 tile and channel 32 adds for B^T d B, 16 rint/clip
// requants, and 36 signed int32 adds for A^T M A.
//
// Design: both kernels give a block 8 x 16 output pixels and 64 output
// channels, and loop over the input channels in chunks of 64. Per chunk the
// shared tile loader copies the (8+2) x (16+2) padded input pixels of the block
// (edge-clamped index arithmetic, cp.async) into shared memory; then
//   direct: 9 taps x 2 k32 steps of mma.sync s8 (s8_mma.cuh) on the slab,
//     eight warps of 2 output rows x 32 channels;
//   wino: every thread transforms (tile, channel) pairs on CUDA cores into the
//     16 position planes V_p (32 tiles x 64 channels each, int8, shared
//     memory); then per position an int32 product V_p @ U_p on mma.sync s8
//     (eight warps of 16 tiles x 16 channels), added with the signs of A^T . A
//     into the four phase accumulators held in registers.
// mode (a runtime flag of the Winograd kernel): 0 full; 1 dots (V_p = the
// tile's raw corner pixel, no transform); 2 tf (no products: M_p =
// V_p[..., co], read from the chunk that holds the block's channels).
// Weights come from the L1/L2-cached global copy: the direct kernel reads
// K0's (Np, Kp) layout, the Winograd kernel (16, Cout, Cin).
// wgmma/TMA and weight tiles in shared memory are later work.
#include "s8_mma.cuh"

namespace {

using namespace ccst_s8;

constexpr int THREADS = 256;       // 8 warps
constexpr int TH = 8, TW = 16;     // output pixels per block
constexpr int SH = TH + 2, SW = TW + 2;
constexpr int SPIX = SH * SW;      // 180 slab pixels
constexpr int BC = 64;             // input channels per chunk
constexpr int BN = 64;             // output channels per block
constexpr int PSTR = BC + 16;      // bytes per slab pixel / V row (80: no bank conflicts)
constexpr int TILES = (TH / 2) * (TW / 2);  // 32 Winograd tiles per block
constexpr int SLAB_BYTES = SPIX * PSTR;     // 14,400
constexpr int V_BYTES = 16 * TILES * PSTR;  // 40,960

__device__ __forceinline__ int ldg32(const int8_t* p) {
  return __ldg(reinterpret_cast<const int*>(p));
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// The shared tile loader: padded rows h0-2 .. h0+TH-1+... (SH of them) and
// columns w0-1 .. w0+TW (SW), channels c0 .. c0+63, edge-clamped.
__device__ __forceinline__ void load_slab(int8_t* slab, const int8_t* __restrict__ x, int img,
                                          int h0, int w0, int c0, int Hb, int Wb, int Cin) {
  for (int idx = threadIdx.x; idx < SPIX * (BC / 16); idx += THREADS) {
    const int pix = idx >> 2, chunk = idx & 3;
    const int i = pix / SW, j = pix - (pix / SW) * SW;
    const int hh = edge_index(h0 - 2 + i, Hb), ww = edge_index(w0 - 1 + j, Wb);
    cp_async16(slab + pix * PSTR + chunk * 16,
               x + (((long long)img * Hb + hh) * Wb + ww) * Cin + c0 + chunk * 16, true);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
}

__device__ __forceinline__ void store_pair(int8_t* y, long long off, int acc0, int acc1,
                                           const float* k, const float* kb, int co) {
  const uint8_t q0 = (uint8_t)requant(dequant(acc0, k[co], kb[co]), 0.0f);
  const uint8_t q1 = (uint8_t)requant(dequant(acc1, k[co + 1], kb[co + 1]), 0.0f);
  *reinterpret_cast<uint16_t*>(y + off) = (uint16_t)(q0 | (q1 << 8));
}

__global__ void __launch_bounds__(THREADS)
direct_s8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wk,
                 const float* __restrict__ kmul, const float* __restrict__ kadd,
                 int8_t* __restrict__ y, int Hb, int Wb, int Cin, int Cout, int Kp) {
  __shared__ __align__(128) int8_t slab[SLAB_BYTES];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;  // 2 output rows x 32 channels per warp
  const int w0 = blockIdx.x * TW, h0 = blockIdx.y * TH;
  const int n_cb = Cout / BN;
  const int img = blockIdx.z / n_cb, n0 = (blockIdx.z - img * n_cb) * BN;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int c0 = 0; c0 < Cin; c0 += BC) {
    load_slab(slab, x, img, h0, w0, c0, Hb, Wb, Cin);
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - (tap / 3) * 3;
      const int8_t* wb = wk + (long long)(n0 + wn * 32 + g) * Kp + tap * Cin + c0 + 4 * t;
#pragma unroll
      for (int kk = 0; kk < BC; kk += 32) {
        int fa[2][4], fb[4][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int8_t* pa = slab + ((wm * 2 + i + dy) * SW + g + dx) * PSTR + kk + 4 * t;
          fa[i][0] = *reinterpret_cast<const int*>(pa);
          fa[i][1] = *reinterpret_cast<const int*>(pa + 8 * PSTR);
          fa[i][2] = *reinterpret_cast<const int*>(pa + 16);
          fa[i][3] = *reinterpret_cast<const int*>(pa + 8 * PSTR + 16);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          fb[j][0] = ldg32(wb + (long long)j * 8 * Kp + kk);
          fb[j][1] = ldg32(wb + (long long)j * 8 * Kp + kk + 16);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], fa[i], fb[j]);
      }
    }
    __syncthreads();  // the next chunk overwrites the slab
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int oh = h0 + wm * 2 + i;
    if (oh >= Hb) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = n0 + wn * 32 + j * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ow = w0 + g + 8 * h;
        if (ow < Wb)
          store_pair(y, (((long long)img * Hb + oh) * Wb + ow) * Cout + co, acc[i][j][2 * h],
                     acc[i][j][2 * h + 1], kmul, kadd, co);
      }
    }
  }
}

// A^T coefficients: AT[a][i]
__device__ __forceinline__ constexpr int at_coef(int a, int i) {
  return a == 0 ? (i < 3 ? 1 : 0) : (i == 0 ? 0 : (i == 1 ? 1 : -1));
}

__device__ __forceinline__ int8_t v_requant(int v) {
  // rint(V * 0.25) (half to even; exact in float32 for |V| <= 512), clip +-127
  return static_cast<int8_t>(
      __float2int_rn(fminf(fmaxf(rintf(__int2float_rn(v) * 0.25f), -127.0f), 127.0f)));
}

// at most 128 registers: two blocks per SM (unbounded, ptxas took 182 and one
// block of 8 warps ran per SM); the cap spills 160 bytes and was still faster
// at the A/B shape (full 4.26 against 4.80 ms on an H100 80GB HBM3 at 700 W)
__global__ void __launch_bounds__(THREADS, 2)
wino_s8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ ut,
               const float* __restrict__ kmul, const float* __restrict__ kadd,
               int8_t* __restrict__ y, int Hb, int Wb, int Cin, int Cout, int mode) {
  extern __shared__ __align__(128) int8_t smem[];
  int8_t* slab = smem;
  int8_t* vbuf = smem + SLAB_BYTES;  // [16][TILES][PSTR]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;  // 16 tiles x 16 channels per warp
  const int w0 = blockIdx.x * TW, h0 = blockIdx.y * TH;
  const int n_cb = Cout / BN;
  const int img = blockIdx.z / n_cb, n0 = (blockIdx.z - img * n_cb) * BN;

  int ys[2][2][2][4];  // phase (a, b), n8 tile, fragment
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) ys[a][b][j][e] = 0;

  // tf: only the chunk holding the block's own channels contributes
  const int c_begin = mode == 2 ? n0 : 0, c_end = mode == 2 ? n0 + BC : Cin;
  for (int c0 = c_begin; c0 < c_end; c0 += BC) {
    load_slab(slab, x, img, h0, w0, c0, Hb, Wb, Cin);

    // input transform: (tile, channel) pairs, 8 per thread
    for (int idx = tid; idx < TILES * BC; idx += THREADS) {
      const int tile = idx / BC, ch = idx - (idx / BC) * BC;
      const int tr = tile / (TW / 2), tc = tile - (tile / (TW / 2)) * (TW / 2);
      const int8_t* d0 = slab + ((2 * tr) * SW + 2 * tc) * PSTR + ch;
      int8_t* vo = vbuf + tile * PSTR + ch;
      if (mode == 1) {
#pragma unroll
        for (int p = 0; p < 16; ++p) vo[p * TILES * PSTR] = d0[0];
        continue;
      }
      int d[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) d[r][c] = d0[(r * SW + c) * PSTR];
      int b[4][4];  // B^T d
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        b[0][c] = d[0][c] - d[2][c];
        b[1][c] = d[1][c] + d[2][c];
        b[2][c] = d[2][c] - d[1][c];
        b[3][c] = d[1][c] - d[3][c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // (B^T d) B
        vo[(i * 4 + 0) * TILES * PSTR] = v_requant(b[i][0] - b[i][2]);
        vo[(i * 4 + 1) * TILES * PSTR] = v_requant(b[i][1] + b[i][2]);
        vo[(i * 4 + 2) * TILES * PSTR] = v_requant(b[i][2] - b[i][1]);
        vo[(i * 4 + 3) * TILES * PSTR] = v_requant(b[i][1] - b[i][3]);
      }
    }
    __syncthreads();

    // 16 position products, each added into the phases with A^T's signs
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      const int pi = p / 4, pj = p % 4;
      const int8_t* vp = vbuf + (p * TILES + wm * 16 + g) * PSTR + 4 * t;
      int m[2][4];
      if (mode == 2) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int ch = n0 - c0 + wn * 16 + j * 8 + 2 * t;
          const int8_t* v = vbuf + (p * TILES + wm * 16 + g) * PSTR + ch;
          m[j][0] = v[0];
          m[j][1] = v[1];
          m[j][2] = v[8 * PSTR];
          m[j][3] = v[8 * PSTR + 1];
        }
      } else {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) m[j][e] = 0;
        const int8_t* ub = ut + ((long long)p * Cout + n0 + wn * 16 + g) * Cin + c0 + 4 * t;
#pragma unroll
        for (int kk = 0; kk < BC; kk += 32) {
          int fa[4], fb[2][2];
          fa[0] = *reinterpret_cast<const int*>(vp + kk);
          fa[1] = *reinterpret_cast<const int*>(vp + 8 * PSTR + kk);
          fa[2] = *reinterpret_cast<const int*>(vp + kk + 16);
          fa[3] = *reinterpret_cast<const int*>(vp + 8 * PSTR + kk + 16);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            fb[j][0] = ldg32(ub + (long long)j * 8 * Cin + kk);
            fb[j][1] = ldg32(ub + (long long)j * 8 * Cin + kk + 16);
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) mma_s8(m[j], fa, fb[j]);
        }
      }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int coef = at_coef(a, pi) * at_coef(b, pj);
          if (coef == 0) continue;
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) ys[a][b][j][e] += coef > 0 ? m[j][e] : -m[j][e];
        }
    }
    __syncthreads();  // the next chunk overwrites the slab and V
  }

  // epilogue: fragment row g (+8) is tile wm*16 + g (+8); its phase (a, b) is
  // output pixel (h0 + 2 tr + a, w0 + 2 tc + b)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int tile = wm * 16 + g + 8 * h;
    const int tr = tile / (TW / 2), tc = tile - (tile / (TW / 2)) * (TW / 2);
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int oh = h0 + 2 * tr + a, ow = w0 + 2 * tc + b;
        if (oh >= Hb || ow >= Wb) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int co = n0 + wn * 16 + j * 8 + 2 * t;
          store_pair(y, (((long long)img * Hb + oh) * Wb + ow) * Cout + co, ys[a][b][j][2 * h],
                     ys[a][b][j][2 * h + 1], kmul, kadd, co);
        }
      }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). x: (N, Hb, Wb, Cin) int8; w: the
// direct kernel's (Np, Kp) int8 (K0 layout, Kp = 9 * Cin) or, for wino = 1,
// U as (16, Cout, Cin) int8; k, kb: (Cout,) f32; y: (N, Hb, Wb, Cout) int8.
// Cin and Cout multiples of 64; mode 0 full, 1 dots, 2 tf (Cout <= Cin), read
// by the Winograd kernel only. All contiguous. Launches on `stream` and
// returns the CUDA error code (0 on success).
extern "C" int ccst_winograd_s8(const void* x, const void* w, const void* k, const void* kb,
                                void* y, int N, int Hb, int Wb, int Cin, int Cout, int Kp,
                                int wino, int mode, void* stream) {
  if (Cin % BC || Cout % BN || mode < 0 || mode > 2 || (mode == 2 && Cout > Cin))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((unsigned)((Wb + TW - 1) / TW), (unsigned)((Hb + TH - 1) / TH),
            (unsigned)(N * (Cout / BN)));
  const auto* xb = static_cast<const int8_t*>(x);
  const auto* wb = static_cast<const int8_t*>(w);
  const auto* kf = static_cast<const float*>(k);
  const auto* kbf = static_cast<const float*>(kb);
  auto* yb = static_cast<int8_t*>(y);
  if (!wino) {
    direct_s8_kernel<<<grid, THREADS, 0, st>>>(xb, wb, kf, kbf, yb, Hb, Wb, Cin, Cout, Kp);
  } else {
    const int bytes = SLAB_BYTES + V_BYTES;
    cudaError_t err =
        cudaFuncSetAttribute(wino_s8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    wino_s8_kernel<<<grid, THREADS, bytes, st>>>(xb, wb, kf, kbf, yb, Hb, Wb, Cin, Cout, mode);
  }
  return static_cast<int>(cudaGetLastError());
}
