// int8 3x3 convolution (edge or reflect padding), int32 accumulation, with the
// static-scale epilogue of the int8 engines, NHWC, for Hopper.
//
// Replaces ccst_tpu/models/vgg_fast.py::_qconv_s (kernel K0), which XLA emitted
// on the TPU (jnp.pad + conv_general_dilated with int32 accumulation + a fused
// elementwise epilogue): every conv of the int8-static / int8-fused engines
// but the level-1 pair that level1_s8.cu fuses. Per output channel c:
//   y = float(acc) * k[c] + kb[c]            (two roundings, no FMA)
//   requant: rint (half to even), clip to [0 if relu else -127, 127] -> int8
//   dequant: optional ReLU -> bf16 (round to nearest even) or float32
//
// What bounds it on the H100: at 512 px every layer has K = 9*Cin = 576..4608
// (the packed conv1_1 has 108), so each input byte feeds hundreds of MACs and
// the convs are tensor-core bound; the 256->12 packed dconv1_1 writes a
// narrow output and fills 12 of 64 output columns of its tile.
//
// Design: an implicit GEMM, M = N*H*W output pixels, N = Cout, K = 9*Cin in
// HWIO order (k = (dy*3 + dx)*Cin + ci), on int8 tensor cores
// (mma.sync.m16n8k32, see s8_mma.cuh). A block computes a 128 x 64 tile with
// eight warps of 32 x 32. The padded input rows are gathered straight into
// shared memory by index arithmetic (mirrored or clamped), so the padded tensor
// never exists in device memory. Two shared-memory stages: cp.async fetches
// stage k+1 while the tensor cores consume stage k. Weights come pre-packed as
// a (Np, Kp) output-channel-major matrix (k contiguous), zero padded to 64
// rows and 64 columns, so the B tile needs no bounds checks; Cout = 12 and
// K = 108 are covered by that padding. When Cin is not a multiple of 64 (the
// packed conv1_1, Cin = 12) the A tile is gathered 4 bytes at a time. The
// epilogue stages the int32 tile in shared memory and writes 8 channels per
// store. wgmma/TMA is later work.
#include "s8_mma.cuh"

namespace {

using namespace ccst_s8;

constexpr int BM = 128;      // output pixels per block
constexpr int BN = 64;       // output channels per block
constexpr int BK = 64;       // reduction depth (bytes) per stage
constexpr int THREADS = 256; // 8 warps: 4 along M x 2 along N, 32 x 32 each
constexpr int SPAD = 16;     // bytes of padding per smem row (80-byte rows: no bank conflicts)
constexpr int CPAD = 4;      // int32 padding per epilogue row

struct SmemAB {
  int8_t a[2][BM][BK + SPAD];
  int8_t b[2][BN][BK + SPAD];
};

union Smem {
  SmemAB ab;
  int c[BM][BN + CPAD];  // epilogue staging, reuses the operand buffers
};

// OUT: 0 -> int8 (requant), 1 -> bf16, 2 -> float32 (dequant).
// VEC: Cin % BK == 0, so a BK slice of K lies inside one tap and is 16-byte
// aligned; the A tile is fetched with cp.async. Otherwise Cin % 4 == 0 and the
// tile is gathered in 4-byte words.
template <bool VEC, int OUT>
__global__ void __launch_bounds__(THREADS)
qconv3x3_s8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wk,
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
  const int n0 = blockIdx.y * BN;
  const int K = 9 * Cin;
  const int KT = Kp / BK;

  auto pad_h = [&](int i) { return reflect ? reflect_index(i, H) : edge_index(i, H); };
  auto pad_w = [&](int i) { return reflect ? reflect_index(i, W) : edge_index(i, W); };

  // VEC path: each thread owns two A rows (pixels) and one 16-byte chunk column
  int a_n[2], a_h[2], a_w[2];
  bool a_ok[2];
  const int a_chunk = tid & 3;  // 4 chunks of 16 bytes per BK row
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = (tid >> 2) + i * (THREADS / 4);
    long long m = m0 + row;
    a_ok[i] = m < M;
    long long mm = a_ok[i] ? m : 0;
    a_n[i] = (int)(mm / HW);
    int rem = (int)(mm - (long long)a_n[i] * HW);
    a_h[i] = rem / W;
    a_w[i] = rem - a_h[i] * W;
  }
  const int b_row = tid >> 2;  // BN rows x 4 chunks of 16 bytes
  const int b_chunk = tid & 3;

  auto load_stage = [&](int kt, int s) {
    const int k0 = kt * BK;
    cp_async16(&sm.ab.b[s][b_row][b_chunk * 16],
               wk + (long long)(n0 + b_row) * Kp + k0 + b_chunk * 16, true);
    if constexpr (VEC) {
      const int tap = k0 / Cin;
      const int ci0 = k0 - tap * Cin + a_chunk * 16;
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int hh = pad_h(a_h[i] + dy);
        const int ww = pad_w(a_w[i] + dx);
        const int8_t* src = x + (((long long)a_n[i] * H + hh) * W + ww) * Cin + ci0;
        cp_async16(&sm.ab.a[s][(tid >> 2) + i * (THREADS / 4)][a_chunk * 16],
                   a_ok[i] ? src : x, a_ok[i]);
      }
    } else {
      for (int idx = tid; idx < BM * (BK / 4); idx += THREADS) {
        const int row = idx / (BK / 4);
        const int kk = (idx - row * (BK / 4)) * 4;
        const int k = k0 + kk;
        const long long m = m0 + row;
        int v = 0;
        if (m < M && k < K) {
          const int n = (int)(m / HW);
          const int rem = (int)(m - (long long)n * HW);
          const int h = rem / W, w = rem - (rem / W) * W;
          const int tap = k / Cin, ci = k - tap * Cin;
          const int hh = pad_h(h + tap / 3 - 1);
          const int ww = pad_w(w + tap % 3 - 1);
          v = *reinterpret_cast<const int*>(x + (((long long)n * H + hh) * W + ww) * Cin + ci);
        }
        *reinterpret_cast<int*>(&sm.ab.a[s][row][kk]) = v;
      }
    }
  };

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < KT) load_stage(kt + 1, s ^ 1);
    cp_async_commit();
    cp_async_wait_one();  // everything but the group just committed has landed
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      int fa[2][4], fb[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm * 32 + i * 16 + g;
        fa[i][0] = *reinterpret_cast<const int*>(&sm.ab.a[s][r][kk + 4 * t]);
        fa[i][1] = *reinterpret_cast<const int*>(&sm.ab.a[s][r + 8][kk + 4 * t]);
        fa[i][2] = *reinterpret_cast<const int*>(&sm.ab.a[s][r][kk + 16 + 4 * t]);
        fa[i][3] = *reinterpret_cast<const int*>(&sm.ab.a[s][r + 8][kk + 16 + 4 * t]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wn * 32 + j * 8 + g;
        fb[j][0] = *reinterpret_cast<const int*>(&sm.ab.b[s][c][kk + 4 * t]);
        fb[j][1] = *reinterpret_cast<const int*>(&sm.ab.b[s][c][kk + 16 + 4 * t]);
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
  for (int idx = tid; idx < BM * (BN / 8); idx += THREADS) {
    const int row = idx / (BN / 8);
    const int cg = (idx - row * (BN / 8)) * 8;
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

template <int OUT>
void launch(dim3 grid, cudaStream_t st, bool vec, const int8_t* x, const int8_t* wk,
            const float* k, const float* kb, void* y, int N, int H, int W, int Cin, int Cout,
            int Kp, int reflect, int relu) {
  if (vec)
    qconv3x3_s8_kernel<true, OUT><<<grid, THREADS, 0, st>>>(x, wk, k, kb, y, N, H, W, Cin,
                                                           Cout, Kp, reflect, relu);
  else
    qconv3x3_s8_kernel<false, OUT><<<grid, THREADS, 0, st>>>(x, wk, k, kb, y, N, H, W, Cin,
                                                            Cout, Kp, reflect, relu);
}

}  // namespace

// Plain C entry point (bound with ctypes). x: (N,H,W,Cin) int8, Cin % 4 == 0;
// wk: (Np, Kp) int8, output-channel-major, Kp = roundup(9*Cin, 64),
// Np = roundup(Cout, 64), zero padded; k, kb: (Cout,) f32; y: (N,H,W,Cout) of
// int8 (out_kind 0), bf16 (1) or f32 (2). All contiguous. reflect: 1 reflect,
// 0 edge padding. Launches on `stream` and returns cudaGetLastError().
extern "C" int ccst_qconv3x3_s8(const void* x, const void* wk, const void* k, const void* kb,
                                void* y, int N, int H, int W, int Cin, int Cout, int Kp, int Np,
                                int reflect, int relu, int out_kind, void* stream) {
  const long long M = (long long)N * H * W;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)(Np / BN));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const int8_t*>(x);
  const auto* wb = static_cast<const int8_t*>(wk);
  const auto* kf = static_cast<const float*>(k);
  const auto* kbf = static_cast<const float*>(kb);
  const bool vec = Cin % BK == 0;
  if (out_kind == 0)
    launch<0>(grid, st, vec, xb, wb, kf, kbf, y, N, H, W, Cin, Cout, Kp, reflect, relu);
  else if (out_kind == 1)
    launch<1>(grid, st, vec, xb, wb, kf, kbf, y, N, H, W, Cin, Cout, Kp, reflect, relu);
  else
    launch<2>(grid, st, vec, xb, wb, kf, kbf, y, N, H, W, Cin, Cout, Kp, reflect, relu);
  return static_cast<int>(cudaGetLastError());
}
