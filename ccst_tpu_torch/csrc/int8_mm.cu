// Tiled GEMM y = x @ w on Hopper tensor cores: int8 x int8 -> int32 or
// float32 (int32 accumulation), bf16 x bf16 -> float32 (float32 accumulation).
//
// Replaces benchmarks/pallas_int8_mxu.py::pallas_mm (kernel B1), the JAX
// project's probe of whether a hand-written int8 matmul reaches the int8 rate
// of the chip: one dot_general per (tile_m, K) x (K, N) block.
//
// What bounds it on the H100: at the probe's shapes (M = 2^18, K = 256..2304,
// N = 128..512) every x byte feeds 2N operations, 256..1024 per byte, above
// the int8 ridge (1,979 TOPS / 3.35 TB/s ~ 590 op/B, the H100 SXM data sheet at
// 700 W) for N >= 512 and near it below, so the kernel is tensor-core bound on
// the wide shapes and shares the bound with device memory on N = 128..256.
//
// Design: the K0 structure (qconv3x3_s8.cu) on a plain matrix. A block
// computes a 128 x 128 tile with eight warps of 64 x 32 on mma.sync
// (m16n8k32 s8, or m16n8k16 bf16, whose fragments occupy the same bytes of a
// row: 4 consecutive bytes at 4t and 16 + 4t of each 32-byte step). Two
// shared-memory stages of 64 bytes of K: cp.async fetches stage k+1 while the
// tensor cores consume stage k; rows past M are zero-filled and their outputs
// skipped. Weights come pre-packed as an (Np, Kp) column-major matrix (k
// contiguous), zero padded to 128 rows and 64 bytes of K, so the B tile needs
// no bounds checks. The accumulator is stored straight from registers: int32,
// or float32 (__int2float_rn once for int8). wgmma/TMA is later work.
#include <type_traits>

#include "s8_mma.cuh"

namespace {

using namespace ccst_s8;

constexpr int BM = 128;       // rows of x per block
constexpr int BN = 128;       // columns of w per block
constexpr int BK = 64;        // bytes of K per stage
constexpr int THREADS = 256;  // 8 warps: 2 along M x 4 along N, 64 x 32 each
constexpr int MT = 4, NT = 4; // m16 and n8 tiles per warp
constexpr int SPAD = 16;      // bytes of padding per smem row (80-byte rows)

struct Smem {
  int8_t a[2][BM][BK + SPAD];
  int8_t b[2][BN][BK + SPAD];
};

// D = A * B + D, bf16 inputs, float32 accumulation (PTX m16n8k16 fragments:
// a[0] row g k 2t..2t+1, a[1] row g+8, a[2] row g k 8+2t.., a[3] row g+8 k
// 8+2t..; b[0] col g k 2t..2t+1, b[1] col g k 8+2t..; c as for m16n8k32).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const int (&a)[4], const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// KIND 0: s8 -> s32; 1: s8 -> f32; 2: bf16 -> f32.
template <int KIND>
__global__ void __launch_bounds__(THREADS)
tiled_mm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
                void* __restrict__ yv, int M, int N, int Kb, int Kpb) {
  __shared__ __align__(128) Smem sm;
  using Acc = typename std::conditional<KIND == 2, float, int>::type;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int g = lane >> 2, t = lane & 3;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int KT = (Kb + BK - 1) / BK;

  // each thread copies two 16-byte chunks of A and two of B per stage
  const int chunk = tid & 3;
  const int row0 = tid >> 2;  // and row0 + 64

  auto load_stage = [&](int kt, int s) {
    const int k0 = kt * BK + chunk * 16;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + i * (THREADS / 4);
      const long long m = m0 + r;
      const bool ok = m < M && k0 < Kb;
      cp_async16(&sm.a[s][r][chunk * 16], ok ? x + m * Kb + k0 : x, ok);
      cp_async16(&sm.b[s][r][chunk * 16], wt + (long long)(n0 + r) * Kpb + kt * BK + chunk * 16,
                 true);
    }
  };

  Acc acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < KT) load_stage(kt + 1, s ^ 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      int fa[MT][4], fb[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = wm * 64 + i * 16 + g;
        fa[i][0] = *reinterpret_cast<const int*>(&sm.a[s][r][kk + 4 * t]);
        fa[i][1] = *reinterpret_cast<const int*>(&sm.a[s][r + 8][kk + 4 * t]);
        fa[i][2] = *reinterpret_cast<const int*>(&sm.a[s][r][kk + 16 + 4 * t]);
        fa[i][3] = *reinterpret_cast<const int*>(&sm.a[s][r + 8][kk + 16 + 4 * t]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = wn * 32 + j * 8 + g;
        fb[j][0] = *reinterpret_cast<const int*>(&sm.b[s][c][kk + 4 * t]);
        fb[j][1] = *reinterpret_cast<const int*>(&sm.b[s][c][kk + 16 + 4 * t]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if constexpr (KIND == 2)
            mma_bf16(acc[i][j], fa[i], fb[j]);
          else
            mma_s8(acc[i][j], fa[i], fb[j]);
        }
    }
    __syncthreads();
  }

  // epilogue straight from the fragments: (row g, cols 2t, 2t+1) and row g+8
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = n0 + wn * 32 + j * 8 + 2 * t;
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long m = m0 + wm * 64 + i * 16 + g + 8 * h;
        if (m >= M) continue;
        if constexpr (KIND == 0) {
          *reinterpret_cast<int2*>(static_cast<int*>(yv) + m * N + col) =
              make_int2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        } else if constexpr (KIND == 1) {
          *reinterpret_cast<float2*>(static_cast<float*>(yv) + m * N + col) =
              make_float2(__int2float_rn(acc[i][j][2 * h]), __int2float_rn(acc[i][j][2 * h + 1]));
        } else {
          *reinterpret_cast<float2*>(static_cast<float*>(yv) + m * N + col) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
      }
    }
}

}  // namespace

// Plain C entry point (bound with ctypes). x: (M, K) int8 (kind 0, 1) or bf16
// (kind 2), row-major, K * element size a multiple of 16 bytes; wt: (Np, Kp)
// of the same type, row n = column n of w, Np a multiple of 128, Kp * element
// size a multiple of 64 bytes, zero padded; y: (M, N) int32 (kind 0) or
// float32 (kind 1, 2), N even. All contiguous. Launches on `stream` and
// returns cudaGetLastError().
extern "C" int ccst_tiled_mm(const void* x, const void* wt, void* y, int M, int N, int K, int Kp,
                             int Np, int kind, void* stream) {
  const int esize = kind == 2 ? 2 : 1;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)(Np / BN));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const int8_t*>(x);
  const auto* wb = static_cast<const int8_t*>(wt);
  const int Kb = K * esize, Kpb = Kp * esize;
  if (kind == 0)
    tiled_mm_kernel<0><<<grid, THREADS, 0, st>>>(xb, wb, y, M, N, Kb, Kpb);
  else if (kind == 1)
    tiled_mm_kernel<1><<<grid, THREADS, 0, st>>>(xb, wb, y, M, N, Kb, Kpb);
  else if (kind == 2)
    tiled_mm_kernel<2><<<grid, THREADS, 0, st>>>(xb, wb, y, M, N, Kb, Kpb);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
