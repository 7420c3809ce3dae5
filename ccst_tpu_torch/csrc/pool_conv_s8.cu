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
// What bounds it on the H100: bytes. Per pooled pixel it must read 256 bytes
// of xp and write Cout; at Cout = 128 that is 3.2 GB for a batch of 128 at
// 256 x 256 against 1,237 GOP (0.96 ms of memory, 0.63 ms of tensor cores).
// The unfused chain moves the pooled tensor twice more.
//
// Design: K0's conv2_1 (qconv3x3_s8.cu on conv_igemm_sm90.cuh) with a pooling
// producer in place of its gather. A block owns an 8 x 16 tile of one image
// and one tile of output channels (all of them at Cout <= 128, so the pooled
// halo is built once):
//   1. it builds the 10 x 18 halo of the POOLED plane in the core's A planes
//      [16-byte group: 4][halo pixel: 181 slots][16 bytes]: per halo pixel
//      (reflect index) and group four 16-byte loads, one a phase, three
//      __vmaxs4 a word, one 16-byte store. Each packed pixel is read 1.4 times
//      (the halo), not once a tap. cp.async cannot take a max, so the loads go
//      through registers, all of a thread's twelve issued before the first max;
//   2. the core's mainloop runs on the resident planes (wgmma m64nNk32 from
//      shared memory, weight stages by cp.async.bulk on mbarriers) in its
//      64-byte mode: Cin = 64 is half a chunk, so the tile is four planes and
//      a tap's weights are N x 64 bytes with no zero half;
//   3. K0's requant epilogue from the accumulator registers, 16-byte stores.
// `cat` keeps the reference's meaning, the reduction step: 0 (F9) is one tap a
// stage (nine steps of two wgmmas, ring of four), 1 (F3) the three column taps
// of a kernel row a stage (three steps of six, ring of three). Two blocks an
// SM, so one block's pooled loads overlap the other's wgmmas. Any Hb, Wb >= 2
// (reflect needs 2), any even Cout: ragged tiles clamp their reads and skip
// their stores.
#include "conv_igemm_sm90.cuh"
#include "s8_mma.cuh"

namespace {

using ccst_s8::dequant;
using ccst_s8::requant;
using namespace ccst_igemm;

constexpr int C = 64;            // pooled channels (one lane group)
constexpr int CP = 4 * C;        // packed channels
constexpr int PG = C / 16;       // 16-byte groups of a pooled pixel
constexpr int KSTEPS = C / 32;   // the mainloop's 64-byte mode
constexpr int ITEMS = (HALO_PX * PG + THREADS - 1) / THREADS;  // (pixel, group) items a thread

__device__ __forceinline__ uint4 vmax16(uint4 a, uint4 b) {
  return make_uint4(__vmaxs4(a.x, b.x), __vmaxs4(a.y, b.y), __vmaxs4(a.z, b.z), __vmaxs4(a.w, b.w));
}

template <int BN, int TPS>
__global__ void __launch_bounds__(THREADS, min_blocks(BN))
pool_conv_s8_kernel(const uint8_t* __restrict__ xp, const uint8_t* __restrict__ wp,
                    const float* __restrict__ kmul, const float* __restrict__ kadd,
                    int8_t* __restrict__ y, const ConvGeom g) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ float sk[BN], skb[BN];
  const int tid = threadIdx.x;
  int n, y0, x0, ntile;
  block_tile(g, n, y0, x0, ntile);
  const int n0 = ntile * BN;
  if (tid < BN) {
    const bool in = n0 + tid < g.Cout;
    sk[tid] = in ? kmul[n0 + tid] : 0.0f;
    skb[tid] = in ? kadd[n0 + tid] : 0.0f;
  }

  // 1. the pooled halo: item = (halo pixel, group); the four lanes of a pixel
  //    read 64 contiguous bytes of each phase
  uint4 v[ITEMS][4];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int item = tid + THREADS * i;
    if (item >= HALO_PX * PG) continue;
    const int p = item / PG, grp = item - p * PG;
    const int hy = p / HALO_W, hx = p - hy * HALO_W;
    const int gy = pad_index(y0 - 1 + hy, g.H, 1), gx = pad_index(x0 - 1 + hx, g.W, 1);
    const uint4* src = reinterpret_cast<const uint4*>(
        xp + ((static_cast<long long>(n) * g.H + gy) * g.W + gx) * CP + grp * 16);
#pragma unroll
    for (int ph = 0; ph < 4; ++ph) v[i][ph] = __ldg(src + ph * PG);
  }
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int item = tid + THREADS * i;
    if (item >= HALO_PX * PG) continue;
    const int p = item / PG, grp = item - p * PG;
    *reinterpret_cast<uint4*>(smem + grp * PLANE + p * 16) =
        vmax16(vmax16(v[i][0], v[i][1]), vmax16(v[i][2], v[i][3]));
  }
  fence_proxy_async();  // the planes were written by plain stores, wgmma reads them
  __syncthreads();

  // 2. the conv from the resident planes
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  conv_mainloop<false, BN, TPS, true, 1, KSTEPS>(acc, nullptr, wp, g, n, y0, x0, ntile, smem);

  // 3. requant + ReLU
  const int t = tid & 3;
  auto quant = [&](int j, int e, int a) {
    const int c = 8 * j + 2 * t + e;
    return static_cast<uint32_t>(static_cast<uint8_t>(requant(dequant(a, sk[c], skb[c]), 0.0f)));
  };
  store_tile_s8<BN>(acc, quant, y, g, n, y0, x0, n0);
}

template <int BN, int TPS>
int launch_pool_conv(const void* xp, const void* wp, const void* k, const void* kb, void* y, int N,
                     int Hb, int Wb, int Cout, cudaStream_t st) {
  ConvGeom g = make_geom(N, Hb, Wb, C, Cout, BN, TPS, 1);
  g.a_slots = g.nchunks;  // the pooled halo is resident: one tile, written once
  return static_cast<int>(launch(pool_conv_s8_kernel<BN, TPS>, g, smem_bytes(g, BN, TPS, KSTEPS), st,
                                 static_cast<const uint8_t*>(xp), static_cast<const uint8_t*>(wp),
                                 static_cast<const float*>(k), static_cast<const float*>(kb),
                                 static_cast<int8_t*>(y)));
}

}  // namespace

// Plain C entry point (bound with ctypes). xp: (N, Hb, Wb, 256) int8, Hb, Wb
// >= 2; wp: the (3, 3, 64, Cout) kernel as 64-byte stage tiles [n tile][1][9
// taps][4][BN][16 bytes] (kernels/igemm_layout.py::pack_stage_tiles with four
// groups), BN = 16 (Cout <= 16), 64 (<= 64) or 128; k, kb: (Cout,) f32; y: (N,
// Hb, Wb, Cout) int8, Cout even. All contiguous. cat = 1: three steps of three
// taps (F3), 0: nine steps of one tap (F9); the narrow tile takes all nine
// taps in one stage either way. Launches on `stream` and returns the CUDA
// error code (0 on success).
extern "C" int ccst_pool_conv_s8(const void* xp, const void* wp, const void* k, const void* kb,
                                 void* y, int N, int Hb, int Wb, int Cout, int cat, void* stream) {
  if (Hb < 2 || Wb < 2 || (Cout & 1)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bn = pick_bn(Cout, 16);
  if (bn == 16) return launch_pool_conv<16, 9>(xp, wp, k, kb, y, N, Hb, Wb, Cout, st);
  if (bn == 64)
    return cat ? launch_pool_conv<64, 3>(xp, wp, k, kb, y, N, Hb, Wb, Cout, st)
               : launch_pool_conv<64, 1>(xp, wp, k, kb, y, N, Hb, Wb, Cout, st);
  return cat ? launch_pool_conv<128, 3>(xp, wp, k, kb, y, N, Hb, Wb, Cout, st)
             : launch_pool_conv<128, 1>(xp, wp, k, kb, y, N, Hb, Wb, Cout, st);
}
