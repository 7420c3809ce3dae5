// pool1 fused into conv2_1: phase max over the packed conv1_2 output, then a
// reflect-padded int8 3x3 conv with the requant + ReLU epilogue, NHWC, for
// Hopper.
//
// Replaces benchmarks/fused_pool_conv_ab.py::pool_conv_fused (kernel B3,
// _pool_conv_kernel): xp (N, Hb, Wb, 256) int8, the packed conv1_2 output
// whose four 64-lane groups are the 2x2 phases of the original plane, is
// pooled (max over the groups) into (N, Hb, Wb, 64) and convolved 64 -> Cout
// (reflect padding) without the pooled tensor ever reaching device memory.
// The arithmetic is that of ccst_tpu/models/vgg_fast.py::phase_max followed by
// _qconv_s(..., "reflect") (y = float(acc) * k + kb rounded twice, rint, clip
// [0, 127]), so the output equals the unfused chain bit for bit.
//
// What bounds it on the H100: conv2_1 has K = 576 and the unfused chain moves
// 4 bytes of xp, writes 1 pooled byte and reads it back per pooled pixel and
// channel; fused, each A element costs 4 bytes of (L2-cached) xp and three
// byte-wise max operations, and the 9 taps read each xp pixel up to 9 times,
// mostly from L1/L2.
//
// Design: K0's implicit GEMM (qconv3x3_s8.cu): M = N*Hb*Wb pooled pixels,
// N = Cout, K = 9*64 in HWIO order, 128 x 64 block tiles, eight warps of 32 x
// 32 on mma.sync s8, two shared-memory stages. The A tile is not copied raw:
// each thread loads the four 16-byte lane groups of a reflect-indexed pixel,
// takes their max with __vmaxs4 and stores the pooled 16 bytes; the loads of
// stage k+1 are issued before the tensor cores consume stage k and stored
// after. The weights (K0's (Np, Kp) layout) come by cp.async. BK selects the
// reduction step as the reference's `cat` does: 9 steps of K = 64 (one tap,
// F9) or 3 steps of K = 192 (one row tap, its three column taps side by side,
// F3). Any Hb, Wb >= 2: the ragged last tile is masked, there is no row-tile
// rule. wgmma/TMA is later work.
#include "s8_mma.cuh"

namespace {

using namespace ccst_s8;

constexpr int BM = 128;       // pooled pixels per block
constexpr int BN = 64;        // output channels per block
constexpr int THREADS = 256;  // 8 warps: 4 along M x 2 along N, 32 x 32 each
constexpr int SPAD = 16;
constexpr int C = 64;         // pooled channels (one lane group)
constexpr int CP = 4 * C;     // packed channels

template <int BK>
struct Layout {
  static constexpr int ROW = BK + SPAD;
  static constexpr int A_BYTES = 2 * BM * ROW;
  static constexpr int B_BYTES = 2 * BN * ROW;
  static constexpr int BYTES = A_BYTES + B_BYTES;
  static constexpr int CHUNKS = BK / 32;  // 16-byte A chunks per thread and stage
};

template <int BK>
__global__ void __launch_bounds__(THREADS)
pool_conv_s8_kernel(const int8_t* __restrict__ xp, const int8_t* __restrict__ wk,
                    const float* __restrict__ kmul, const float* __restrict__ kadd,
                    int8_t* __restrict__ y, int N, int Hb, int Wb, int Cout, int Kp) {
  using L = Layout<BK>;
  extern __shared__ __align__(128) int8_t smem[];
  auto a_at = [&](int s, int r, int kb) { return smem + (s * BM + r) * L::ROW + kb; };
  auto b_at = [&](int s, int r, int kb) { return smem + L::A_BYTES + (s * BN + r) * L::ROW + kb; };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const long long HW = (long long)Hb * Wb;
  const long long M = (long long)N * HW;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int KT = Kp / BK;

  // A: thread owns row tid / 2 and chunks (tid & 1) + 2q of every stage
  const int a_row = tid >> 1, a_half = tid & 1;
  const long long am = m0 + a_row;
  const bool a_ok = am < M;
  int a_n = 0, a_h = 0, a_w = 0;
  if (a_ok) {
    a_n = (int)(am / HW);
    const int rem = (int)(am - (long long)a_n * HW);
    a_h = rem / Wb;
    a_w = rem - a_h * Wb;
  }
  uint4 staged[L::CHUNKS];

  auto load_a = [&](int kt) {
#pragma unroll
    for (int q = 0; q < L::CHUNKS; ++q) {
      const int k = kt * BK + (a_half + 2 * q) * 16;
      const int tap = k / C, ci = k - tap * C;
      uint4 m = make_uint4(0, 0, 0, 0);
      if (a_ok) {
        const int hh = reflect_index(a_h + tap / 3 - 1, Hb);
        const int ww = reflect_index(a_w + tap % 3 - 1, Wb);
        const uint4* src = reinterpret_cast<const uint4*>(
            xp + (((long long)a_n * Hb + hh) * Wb + ww) * CP + ci);
        m = __ldg(src);
#pragma unroll
        for (int p = 1; p < 4; ++p) {
          const uint4 v = __ldg(src + p * (C / 16));
          m.x = __vmaxs4(m.x, v.x);
          m.y = __vmaxs4(m.y, v.y);
          m.z = __vmaxs4(m.z, v.z);
          m.w = __vmaxs4(m.w, v.w);
        }
      }
      staged[q] = m;
    }
  };
  auto store_a = [&](int s) {
#pragma unroll
    for (int q = 0; q < L::CHUNKS; ++q)
      *reinterpret_cast<uint4*>(a_at(s, a_row, (a_half + 2 * q) * 16)) = staged[q];
  };
  auto load_b = [&](int kt, int s) {
    for (int idx = tid; idx < BN * (BK / 16); idx += THREADS) {
      const int r = idx / (BK / 16), ch = idx - r * (BK / 16);
      cp_async16(b_at(s, r, ch * 16), wk + (long long)(n0 + r) * Kp + kt * BK + ch * 16, true);
    }
    cp_async_commit();
  };

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  load_a(0);
  store_a(0);
  load_b(0, 0);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < KT) {
      load_a(kt + 1);
      load_b(kt + 1, s ^ 1);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      int fa[2][4], fb[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm * 32 + i * 16 + g;
        fa[i][0] = *reinterpret_cast<const int*>(a_at(s, r, kk + 4 * t));
        fa[i][1] = *reinterpret_cast<const int*>(a_at(s, r + 8, kk + 4 * t));
        fa[i][2] = *reinterpret_cast<const int*>(a_at(s, r, kk + 16 + 4 * t));
        fa[i][3] = *reinterpret_cast<const int*>(a_at(s, r + 8, kk + 16 + 4 * t));
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wn * 32 + j * 8 + g;
        fb[j][0] = *reinterpret_cast<const int*>(b_at(s, c, kk + 4 * t));
        fb[j][1] = *reinterpret_cast<const int*>(b_at(s, c, kk + 16 + 4 * t));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], fa[i], fb[j]);
    }
    if (kt + 1 < KT) {
      store_a(s ^ 1);
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
  }

  // epilogue straight from the fragments
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = m0 + wm * 32 + i * 16 + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int co = n0 + wn * 32 + j * 8 + 2 * t;
        if (co >= Cout) continue;
        const uint8_t q0 = (uint8_t)requant(dequant(acc[i][j][2 * h], kmul[co], kadd[co]), 0.0f);
        const uint8_t q1 =
            (uint8_t)requant(dequant(acc[i][j][2 * h + 1], kmul[co + 1], kadd[co + 1]), 0.0f);
        *reinterpret_cast<uint16_t*>(y + m * Cout + co) = (uint16_t)(q0 | (q1 << 8));
      }
    }
}

template <int BK>
int launch(const int8_t* xp, const int8_t* wk, const float* k, const float* kb, int8_t* y, int N,
           int Hb, int Wb, int Cout, int Kp, int Np, cudaStream_t st) {
  using L = Layout<BK>;
  auto kernel = pool_conv_s8_kernel<BK>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long M = (long long)N * Hb * Wb;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)(Np / BN));
  kernel<<<grid, THREADS, L::BYTES, st>>>(xp, wk, k, kb, y, N, Hb, Wb, Cout, Kp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes). xp: (N, Hb, Wb, 256) int8, Hb, Wb
// >= 2; wk: (Np, Kp) int8 in K0's layout for a (3, 3, 64, Cout) kernel (Kp =
// 576, Np = roundup(Cout, 64), zero padded); k, kb: (Cout,) f32; y: (N, Hb,
// Wb, Cout) int8, Cout even. All contiguous. cat = 1: 3 K-steps of 192 (F3),
// 0: 9 K-steps of 64 (F9). Launches on `stream` and returns the CUDA error
// code (0 on success).
extern "C" int ccst_pool_conv_s8(const void* xp, const void* wk, const void* k, const void* kb,
                                 void* y, int N, int Hb, int Wb, int Cout, int Kp, int Np, int cat,
                                 void* stream) {
  if (Kp != 9 * C || Hb < 2 || Wb < 2 || (Cout & 1)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const int8_t*>(xp);
  const auto* wb = static_cast<const int8_t*>(wk);
  const auto* kf = static_cast<const float*>(k);
  const auto* kbf = static_cast<const float*>(kb);
  auto* yb = static_cast<int8_t*>(y);
  if (cat) return launch<192>(xb, wb, kf, kbf, yb, N, Hb, Wb, Cout, Kp, Np, st);
  return launch<64>(xb, wb, kf, kbf, yb, N, Hb, Wb, Cout, Kp, Np, st);
}
