// int8 Winograd F(2x2, 3x3) conv with the requant + ReLU epilogue, NHWC, for
// Hopper: the Winograd side of an A/B whose direct side is K0 itself
// (qconv3x3_s8.cu with a row shift, kernels/winograd.py::conv_direct).
//
// Replaces benchmarks/winograd_ab.py::_wino_kernel (kernel B2): the input
// transform V = B^T d B, requantized as clip(rint(V / 4), -127, 127) int8, 16
// int8 position products M_p = V_p U_p with int32 sums, the inverse transform
// A^T M A with A^T's signs, and per output channel
//   y = float(acc) * k + kb (two roundings, no FMA), rint, clip [0, 127], int8.
// The padding is the reference's: 2 rows on top, 1 column on the left, edge
// replicated, so the 2x2 tile at output (2 i, 2 j) reads input rows 2 i - 2 ..
// 2 i + 1 and columns 2 j - 1 .. 2 j + 2, clamped.
//
// What bounds it on the H100: the tensor cores do 16 products per 2x2 tile,
// 2.25x fewer than a direct conv's 36 (0.139 ms of int8 tensor time at the
// A/B's (8, 256, 256, 256 -> 256), H100 SXM at 700 W). The rest moves to the
// SM's other pipes: per tile and channel 64 fp16 adds and 16 requants of the
// transform, and the int32 adds of A^T M A, which run at half the float32
// rate: added position by position they are 36 a tile, output channel and
// chunk, more time than the products. Those, not the tensor cores, set its
// time.
//
// Design. A block owns 16 x 16 output pixels, the 64 Winograd tiles that are
// the 64 rows of one m64 wgmma, and 128 output channels; it walks the input
// channels in chunks of 64. Its 256 threads are two warpgroups, each the
// consumer of 64 output channels, and both transform:
//   - halo: the 18 x 18 input pixels of a chunk, copied by 16-byte cp.async
//     into planes [16-byte group][row][even columns, then odd columns], so
//     that the 8 tiles of a tile row read 128 contiguous bytes; the next
//     chunk's copy is in flight during this chunk's products;
//   - V: the transform of 4 channels of one tile a thread at a time, in fp16
//     pairs (integers of at most 512 are exact), the requant as one fp16 fma
//     onto 1536 (its rounding is rint, half to even, and the low byte of the
//     result is the int8), into 16 position planes in the core's A layout
//     [position][16-byte group][tile][16 bytes]: a position is the start
//     address of an unswizzled descriptor, as a tap is in the conv core;
//   - U: host-packed stages [n tile][chunk][position][group][128][16 bytes]
//     (kernels/winograd.py::pack_wino_stages), one cp.async.bulk of 8 KB a
//     position on a ring of seventeen (all the shared memory left) behind `full` /
//     `empty` mbarriers, one arrival a warp; thread 0 refills a slot as soon
//     as both warpgroups have released it;
//   - products: a row i of positions (p = 4 i + j) at a time, as three
//     products whose terms share A^T's sign along j, summed in the tensor
//     cores: S = M_i0 + M_i1 + M_i2 (phase column b = 0), X = M_i1 and R =
//     M_i2 + M_i3 (b = 1 takes X - R). 24 position products a chunk instead
//     of 16, and 18 sets of int32 adds into the four phase accumulators
//     instead of 36. S and X go into two scratch accumulators together, R
//     while S is added. Four phases and two scratch sets are 6 x 32 int32 a
//     thread, within the 255 registers of a 256-thread block: no warp
//     specialisation and no setmaxnreg. The row loop is not unrolled, so the
//     compiler keeps no descriptors of all 16 positions live (it spilled);
//   - epilogue: each phase through the core's int8 store helper, 16 channels
//     of one pixel a 16-byte store.
// mode (runtime): 0 full; 1 dots (V_p = the tile's raw corner pixel d[0][0],
// no transform); 2 tf (no products: M_p = V_p[..., co], from the chunk that
// holds the block's channels; every chunk is still transformed, as in full).
// Integer sums are order-free, so the result equals the plain version bit for
// bit.
#include <cuda_fp16.h>

#include "conv_igemm_sm90.cuh"
#include "s8_mma.cuh"

namespace {

using namespace ccst_igemm;
using ccst_s8::dequant;
using ccst_s8::edge_index;
using ccst_s8::requant;

constexpr int W_THREADS = 256;          // two warpgroups
constexpr int OT = 16;                  // output pixels a side of a block
constexpr int TT = OT / 2;              // Winograd tiles a side: 8 x 8 = the 64 rows of a wgmma
constexpr int WH = OT + 2;              // halo side
constexpr int WC = 64;                  // input channels (bytes) a chunk
constexpr int WN = 128;                 // output channels a block, 64 a warpgroup
constexpr int POSITIONS = 16;
constexpr int HALO_ODD = (WH / 2) * 16;     // 144: the odd columns of a halo row start here
constexpr int HALO_ROW = WH * 16;           // 288
constexpr int HALO_GROUP = WH * HALO_ROW;   // 5184: one 16-byte channel group of the halo
constexpr int HALO_BYTES = 4 * HALO_GROUP;  // 20,736
constexpr int V_GROUP = TT * TT * 16;       // 1024: one group of one position, all tiles
constexpr int V_POS = 4 * V_GROUP;          // 4096
constexpr int V_BYTES = POSITIONS * V_POS;  // 65,536
constexpr int U_STAGE = WN * WC;            // 8192: one position's weights of one chunk
// U is most of what a block reads (512 KB at Cin = 256, against 83 KB of
// input), and the ring is what keeps it in flight: it takes all the shared
// memory that the halo and V leave
constexpr int U_STAGES = 17;
constexpr int W_SMEM = HALO_BYTES + V_BYTES + U_STAGES * U_STAGE + 16 * U_STAGES;

// A^T[a][i]: rows (1, 1, 1, 0) and (0, 1, -1, -1)
__host__ __device__ constexpr int at_coef(int a, int i) {
  return a == 0 ? (i < 3 ? 1 : 0) : (i == 0 ? 0 : (i == 1 ? 1 : -1));
}

__device__ __forceinline__ __half2 h2_bits(uint32_t v) { return *reinterpret_cast<__half2*>(&v); }
__device__ __forceinline__ uint32_t bits_h2(__half2 v) { return *reinterpret_cast<uint32_t*>(&v); }

// four int8 (channels 0..3 of a word) -> two fp16 pairs, exactly: the biased
// byte b + 128 under the exponent of 1024 is the half 1152 + b
__device__ __forceinline__ void s8x4_to_h2(uint32_t w, __half2& lo, __half2& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const __half2 bias = __floats2half2_rn(1152.0f, 1152.0f);
  lo = __hsub2(h2_bits(__byte_perm(u, 0x64646464u, 0x4140)), bias);
  hi = __hsub2(h2_bits(__byte_perm(u, 0x64646464u, 0x4342)), bias);
}

// V (integers, |V| <= 512) -> clip(rint(V / 4), -127, 127) as four int8: the
// fma rounds V / 4 + 1536 once, half to even, onto an integer whose half has
// the int8 as its low byte (1536 + k = 0x6600 + k for -128 <= k < 128)
__device__ __forceinline__ uint32_t v_requant4(__half2 lo, __half2 hi) {
  const __half2 quarter = __floats2half2_rn(0.25f, 0.25f);
  const __half2 magic = __floats2half2_rn(1536.0f, 1536.0f);
  const __half2 vmin = __floats2half2_rn(1409.0f, 1409.0f), vmax = __floats2half2_rn(1663.0f, 1663.0f);
  const __half2 ql = __hmin2(__hmax2(__hfma2(lo, quarter, magic), vmin), vmax);
  const __half2 qh = __hmin2(__hmax2(__hfma2(hi, quarter, magic), vmin), vmax);
  return __byte_perm(bits_h2(ql), bits_h2(qh), 0x6420);
}

// the transform of one (tile, 4 channels): d[r][c] is the word at row r,
// column c of the tile's 4 x 4 input; V_p goes to out + p * V_POS
__device__ __forceinline__ void transform4(const uint8_t* d0, uint8_t* out, int mode) {
  auto d_at = [&](int r, int c) {
    return *reinterpret_cast<const uint32_t*>(d0 + r * HALO_ROW + (c & 1) * HALO_ODD + (c >> 1) * 16);
  };
  if (mode == 1) {  // dots: every position is the raw corner pixel
    const uint32_t w = d_at(0, 0);
#pragma unroll
    for (int p = 0; p < POSITIONS; ++p) *reinterpret_cast<uint32_t*>(out + p * V_POS) = w;
    return;
  }
  __half2 t[2][4][4];  // B^T d, [pair][row][column]
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    __half2 d[2][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) s8x4_to_h2(d_at(r, c), d[0][r], d[1][r]);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      t[k][0][c] = __hsub2(d[k][0], d[k][2]);
      t[k][1][c] = __hadd2(d[k][1], d[k][2]);
      t[k][2][c] = __hsub2(d[k][2], d[k][1]);
      t[k][3][c] = __hsub2(d[k][1], d[k][3]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // (B^T d) B, row i: positions 4 i .. 4 i + 3
    __half2 v[2][4];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      v[k][0] = __hsub2(t[k][i][0], t[k][i][2]);
      v[k][1] = __hadd2(t[k][i][1], t[k][i][2]);
      v[k][2] = __hsub2(t[k][i][2], t[k][i][1]);
      v[k][3] = __hsub2(t[k][i][1], t[k][i][3]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint32_t*>(out + (4 * i + j) * V_POS) = v_requant4(v[0][j], v[1][j]);
  }
}

// keep the compiler from moving reads of a wgmma accumulator above the wait
// that completes it
__device__ __forceinline__ void fence_regs(int (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__global__ void __launch_bounds__(W_THREADS, 1)
wino_s8_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ up,
               const float* __restrict__ kmul, const float* __restrict__ kadd,
               int8_t* __restrict__ y, int Hb, int Wb, int Cin, int Cout, int mode) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ float sk[WN], skb[WN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = tid >> 7, w4 = warp & 3, g = lane >> 2, t = lane & 3;
  const int tiles_x = (Wb + OT - 1) / OT, tiles_y = (Hb + OT - 1) / OT, ntn = (Cout + WN - 1) / WN;
  int b = blockIdx.x;
  const int nt = b % ntn; b /= ntn;
  const int x0 = b % tiles_x * OT; b /= tiles_x;
  const int y0 = b % tiles_y * OT;
  const int n = b / tiles_y;
  const int n0 = nt * WN;
  const int nch = Cin / WC, total = POSITIONS * nch;
  const bool products = mode != 2;

  uint8_t* halo = smem;
  uint8_t* vpl = smem + HALO_BYTES;
  const uint32_t sV = smem_u32(vpl);
  const uint32_t sU = sV + V_BYTES;
  const uint32_t full = sU + U_STAGES * U_STAGE, empty = full + 8 * U_STAGES;

  if (tid < WN) {
    const bool in = n0 + tid < Cout;
    sk[tid] = in ? kmul[n0 + tid] : 0.0f;
    skb[tid] = in ? kadd[n0 + tid] : 0.0f;
  }
  if (tid == 0) {
    for (int s = 0; s < U_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, W_THREADS / 32);  // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto load_u = [&](int step) {
    const uint32_t slot = step % U_STAGES;
    mbar_expect_tx(full + 8 * slot, U_STAGE);
    bulk_load(sU + slot * U_STAGE, up + (static_cast<size_t>(nt) * total + step) * U_STAGE, U_STAGE,
              full + 8 * slot);
  };
  auto load_halo = [&](int c) {
    const uint32_t dst = smem_u32(halo);
    for (int it = tid; it < WH * WH * 4; it += W_THREADS) {
      const int p = it >> 2, grp = it & 3;
      const int hy = p / WH, hx = p - hy * WH;
      const int gy = edge_index(y0 - 2 + hy, Hb), gx = edge_index(x0 - 1 + hx, Wb);
      cp_async16(dst + grp * HALO_GROUP + hy * HALO_ROW + (hx & 1) * HALO_ODD + (hx >> 1) * 16,
                 x + (static_cast<size_t>(n * Hb + gy) * Wb + gx) * Cin + c * WC + grp * 16, true);
    }
  };

  if (products && tid == 0)
    for (int s = 0; s < U_STAGES && s < total; ++s) load_u(s);
  load_halo(0);
  cp_async_commit();

  int acc[4][32];  // phase 2 a + b
#pragma unroll
  for (int ph = 0; ph < 4; ++ph)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[ph][i] = 0;
  int sc[2][32];   // two products of a row in turn

  const uint64_t a_str = desc_strides(V_GROUP, 128);
  const uint64_t b_str = desc_strides(WN * 16, 128);
  auto wait_full = [&](int step) { mbar_wait(full + 8 * (step % U_STAGES), (step / U_STAGES) & 1); };
  // d (+)= V_p U_p: position p's plane against the stage of `step`, two k32 steps
  auto mma_position = [&](int (&d)[32], int p, int step, int accumulate) {
    const uint32_t b_at = sU + (step % U_STAGES) * U_STAGE + wg * 64 * 16;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
      Wgmma<false, 64>::mma(d, desc_at(a_str, sV + p * V_POS + ks * 2 * V_GROUP),
                            desc_at(b_str, b_at + ks * 2 * WN * 16), accumulate | ks);
  };
  // this warp is done with the stage of `step` (its wgmma wait has passed);
  // thread 0 refills the slot with step + U_STAGES once every warp is
  auto release = [&](int step) {
    const int slot = step % U_STAGES;
    if (lane == 0) mbar_arrive(empty + 8 * slot);
    if (tid == 0 && step + U_STAGES < total) {
      mbar_wait(empty + 8 * slot, (step / U_STAGES) & 1);
      load_u(step + U_STAGES);
    }
  };
  // acc[a][b] += sign * A^T[a][i] * m: A^T[0] = (1, 1, 1, 0), A^T[1] = (0, 1, -1, -1)
  auto add_row = [&](int i, int bb, const int (&m)[32], int sign) {
    if (i < 3) {
#pragma unroll
      for (int r = 0; r < 32; ++r) acc[bb][r] += sign > 0 ? m[r] : -m[r];
    }
    if (i > 0) {
      const bool plus = (i == 1) == (sign > 0);
#pragma unroll
      for (int r = 0; r < 32; ++r) acc[2 + bb][r] += plus ? m[r] : -m[r];
    }
  };
  // tf: acc[phase] += A^T[a][i] A^T[b][j] M_p, p = 4 i + j
  auto add_position = [&](int p, const int (&m)[32]) {
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int bb = 0; bb < 2; ++bb) {
        const int coef = at_coef(a, p / 4) * at_coef(bb, p % 4);
        if (coef == 0) continue;
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[2 * a + bb][i] += coef > 0 ? m[i] : -m[i];
      }
  };

  for (int c = 0; c < nch; ++c) {
    cp_async_wait<0>();  // this thread's copies of chunk c have landed
    __syncthreads();     // everyone's have, and V is free

    // transform: warp w takes (tile row, group) pairs w, w + 8, ..; lane = (tile column, 4 channels)
    for (int pair = warp; pair < TT * 4; pair += W_THREADS / 32) {
      const int tr = pair >> 2, grp = pair & 3;
      const int tc = lane >> 2, k = lane & 3;
      transform4(halo + grp * HALO_GROUP + 2 * tr * HALO_ROW + tc * 16 + 4 * k,
                 vpl + grp * V_GROUP + (tr * TT + tc) * 16 + 4 * k, mode);
    }
    fence_proxy_async();  // V was written by plain stores; the wgmma reads it
    __syncthreads();      // and the halo is read: the next chunk's copy runs under the products
    if (c + 1 < nch) load_halo(c + 1);
    cp_async_commit();

    if (products) {
      // row i of the positions (p = 4 i + j) as three products whose terms
      // share A^T's sign along j, summed in the tensor cores: S = M_i0 + M_i1 +
      // M_i2 (phase column b = 0), X = M_i1 and R = M_i2 + M_i3 (b = 1: X - R);
      // S and X are issued together, R while S is added
#pragma unroll 1
      for (int i = 0; i < 4; ++i) {
        const int s0 = c * POSITIONS + 4 * i;  // the step of position 4 i
        wait_full(s0);
        wait_full(s0 + 1);
        wait_full(s0 + 2);
        wgmma_fence();
        mma_position(sc[0], 4 * i, s0, 0);
        mma_position(sc[0], 4 * i + 1, s0 + 1, 1);
        mma_position(sc[0], 4 * i + 2, s0 + 2, 1);
        wgmma_commit();
        mma_position(sc[1], 4 * i + 1, s0 + 1, 0);
        wgmma_commit();
        wgmma_wait<1>();  // S
        fence_regs(sc[0]);
        release(s0);
        add_row(i, 0, sc[0], 1);
        wait_full(s0 + 3);
        wgmma_fence();
        mma_position(sc[0], 4 * i + 2, s0 + 2, 0);
        mma_position(sc[0], 4 * i + 3, s0 + 3, 1);
        wgmma_commit();
        wgmma_wait<1>();  // X
        fence_regs(sc[1]);
        release(s0 + 1);
        add_row(i, 1, sc[1], 1);
        wgmma_wait<0>();  // R
        fence_regs(sc[0]);
        release(s0 + 2);
        release(s0 + 3);
        add_row(i, 1, sc[0], -1);
      }
    } else if (c * WC == n0 + wg * 64) {
      // tf: M_p = V_p[..., co] of the chunk that holds this warpgroup's channels
#pragma unroll
      for (int p = 0; p < POSITIONS; ++p) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int row = 16 * w4 + g + 8 * ((i >> 1) & 1);
          const int col = 8 * (i >> 2) + 2 * t + (i & 1);
          sc[0][i] = static_cast<int8_t>(vpl[p * V_POS + (col >> 4) * V_GROUP + row * 16 + (col & 15)]);
        }
        add_position(p, sc[0]);
      }
    }
  }

  // epilogue: row half h of the accumulators is tile (2 w + h, g); its phase
  // (a, b) is output pixel (y0 + 4 w + 2 h + a, x0 + 2 g + b)
  const int cb = 64 * wg;  // this warpgroup's first channel in the block
  auto quant = [&](int j, int e, int a) {
    const int col = cb + 8 * j + 2 * t + e;
    return static_cast<uint32_t>(static_cast<uint8_t>(requant(dequant(a, sk[col], skb[col]), 0.0f)));
  };
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int bb = 0; bb < 2; ++bb)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4 v = pack_s8x16(acc[2 * a + bb], quant, 0, h);
        const int oy = y0 + 4 * w4 + 2 * h + a, ox = x0 + 2 * g + bb;
        const int col = n0 + cb + 16 * t;
        if (oy < Hb && ox < Wb && col < Cout)
          *reinterpret_cast<uint4*>(y + (static_cast<size_t>(n * Hb + oy) * Wb + ox) * Cout + col) = v;
      }
}

}  // namespace

// Plain C entry point (bound with ctypes). x: (N, Hb, Wb, Cin) int8; up: U in
// the stage layout of kernels/winograd.py::pack_wino_stages, [n tile of
// 128][chunk of 64][position][16-byte group][128][16]; k, kb: (Cout,) f32; y:
// (N, Hb, Wb, Cout) int8. Cin and Cout multiples of 64; mode 0 full, 1 dots,
// 2 tf (Cout <= Cin). All contiguous. Launches on `stream` and returns the
// CUDA error code (0 on success).
extern "C" int ccst_winograd_s8(const void* x, const void* up, const void* k, const void* kb,
                                void* y, int N, int Hb, int Wb, int Cin, int Cout, int mode,
                                void* stream) {
  if (Cin % WC || Cout % 64 || mode < 0 || mode > 2 || (mode == 2 && Cout > Cin))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      cudaFuncSetAttribute(wino_s8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, W_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(N) * ((Hb + OT - 1) / OT) * ((Wb + OT - 1) / OT) *
                           ((Cout + WN - 1) / WN);
  if (blocks == 0) return 0;
  wino_s8_kernel<<<static_cast<unsigned>(blocks), W_THREADS, W_SMEM,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const uint8_t*>(up), static_cast<const float*>(k),
      static_cast<const float*>(kb), static_cast<int8_t*>(y), Hb, Wb, Cin, Cout, mode);
  return static_cast<int>(cudaGetLastError());
}
