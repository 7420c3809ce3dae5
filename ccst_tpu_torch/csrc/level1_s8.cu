// The fused level-1 stage of the int8 engines, NHWC, for Hopper: two chained
// edge-padded int8 3x3 convs in one kernel, the intermediate kept in shared
// memory.
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
// What bounds it on the H100: operations. At 512 px the unfused chain writes
// and re-reads a (4, 256, 256, 256) int8 intermediate (64 MB each way per
// batch of 4); with the intermediate on chip K1 moves 16 MB for 324 GOP, and
// 92% of those are conv1_2 (K = 2304). So K1 is as fast as its conv1_2 runs on
// the tensor cores; the price of fusing is the halo that each block recomputes
// (10 x 18 conv1 pixels for 8 x 16 outputs, 1.4x conv1_1's work).
//
// Both kernels: a block owns an 8 x 16 tile of output pixels of one image. It
//   1. copies the (8+4) x (16+4) input pixels it needs into shared memory,
//      with clamped (edge) coordinates;
//   2. computes conv1 on the (8+2) x (16+2) pixels of the tile and its halo,
//      requantizes them to int8 and keeps them in shared memory. A halo pixel
//      outside the image is the EDGE REPLICA of conv1's output at the nearest
//      pixel inside (conv1 is computed at the clamped position), which is
//      what edge padding of the intermediate means; conv1 of an over-padded
//      input would differ (level1_pallas.py:33-38);
//   3. runs conv2 from that buffer and writes the epilogue.
// Any image size works: ragged tiles clamp their reads and skip their stores.
// The TPU kernel's zero-free block decomposition of conv1_2 is not used: the
// dense packed weights give the same integers.
//
// K1 (encoder_level1_kernel) runs on wgmma and the conv core
// (conv_igemm_sm90.cuh), 256 threads, two blocks an SM:
//   - conv1_1 is a GEMM of 192 rows (the 180 halo pixels, padded) by K = 108
//     (padded to one 128-byte chunk) by 256: the block builds the im2col of
//     its input tile as A planes [16-byte group: 8][row: 193 slots][16 bytes],
//     each row gathered around its CLAMPED pixel (the edge replica), fetches
//     the 32 KB weight slab with one cp.async.bulk on an mbarrier, and runs
//     six m64n128 row-block x column-half units, three a warpgroup;
//   - its requantized output is written straight into the core's A layout,
//     planes [16-byte group: 16][halo pixel: 181 slots][16 bytes] (two
//     128-byte chunks, 46.3 KB), so the intermediate IS the halo tile that the
//     core's mainloop otherwise gathers from device memory;
//   - conv1_2 is that mainloop with the gather left out (a tap is a start
//     offset into the planes), m64n128k32, its 36 weight stages of 16 KB (two
//     128-column passes x two chunks x nine taps) one run of the ring of four
//     bulk-copied stages; the im2col, the conv1_1 weights and the input tile
//     live where the ring is, before it starts;
//   - the packed conv1_2 weights have their output columns permuted
//     (kernels/igemm_layout.py::level1_column_order) so that the four phases of
//     a channel are four accumulator registers of one thread and pass p holds
//     channels 16 t + 8 p .. + 7 of quad lane t: requant, max in registers,
//     and after the second pass one 16-byte store of 16 channels a lane; no
//     staging buffer.
// K2 (decoder_level1_kernel) keeps mma.sync.m16n8k32 (s8_mma.cuh) with its
// weights read through L1/L2; it is on no engine's path.
#include "conv_igemm_sm90.cuh"
#include "s8_mma.cuh"

namespace {

using namespace ccst_s8;
namespace ig = ccst_igemm;

constexpr int THREADS = 256;  // 8 warps
constexpr int TH = 8, TW = 16;                  // output tile (packed pixels)
constexpr int MH = TH + 2, MW = TW + 2;         // conv1 tile + halo
constexpr int MPIX = MH * MW;                   // 180
constexpr int IH = TH + 4, IW = TW + 4;         // input tile + both halos
constexpr int IPIX = IH * IW;                   // 240
constexpr int CMID = 256;                       // conv1 output channels
static_assert(TH == ig::TH && TW == ig::TW && MPIX == ig::HALO_PX, "K1 shares the core's tile");

// ---- K1: encoder_level1 on wgmma ------------------------------------------

constexpr int E_CIN = 12;                        // packed input channels (bytes a pixel)
constexpr int E_BN = 128;                        // columns of one wgmma and one conv1_2 pass
constexpr int E_ROWS = 192;                      // im2col rows: the 180 halo pixels, padded to 3 x 64
constexpr int E_IM_PLANE = (E_ROWS + 1) * 16;    // one 16-byte group of K of every im2col row
constexpr int E_W1_BYTES = 2 * E_BN * ig::CHUNK; // conv1_1 weights: two column halves of one stage
// scratch of the conv1_1 phase, laid where conv1_2's weight ring will be
constexpr int E_OFF_W1 = 0;
constexpr int E_OFF_IM = E_OFF_W1 + E_W1_BYTES;
constexpr int E_OFF_IN = E_OFF_IM + ig::GROUPS * E_IM_PLANE;
constexpr int E_SCRATCH = E_OFF_IN + IPIX * E_CIN;
constexpr int E_RING = ig::MAX_STAGES * E_BN * ig::CHUNK;
static_assert(E_SCRATCH <= E_RING, "the conv1_1 scratch must fit where the weight ring is");
static_assert(E_OFF_IM % 128 == 0 && E_OFF_IN % 16 == 0, "alignment of the conv1_1 scratch");

__global__ void __launch_bounds__(THREADS, 2)
encoder_level1_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ w1p,
                      const float* __restrict__ k1, const float* __restrict__ kb1,
                      const uint8_t* __restrict__ w2p, const float* __restrict__ k2p,
                      const float* __restrict__ kb2p, int8_t* __restrict__ y,
                      const ig::ConvGeom g) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ float sk2[CMID], skb2[CMID];  // conv1_2's terms, in the permuted column order
  uint8_t* planes = smem;                                  // 16 planes of 181 slots: the intermediate
  uint8_t* ring = smem + g.a_slots * ig::A_BYTES;          // conv1_2's weight ring; first the scratch
  const uint32_t w1_bar = ig::smem_u32(ring + E_RING + 8 * ig::MAX_STAGES);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = (tid >> 5) & 3, wg = tid >> 7;
  const int gq = lane >> 2, t = lane & 3;
  int img, h0, w0, ntile;
  ig::block_tile(g, img, h0, w0, ntile);
  const int Hb = g.H, Wb = g.W;

  // conv1_1's weights: one bulk copy, awaited just before the first wgmma
  if (tid == 0) {
    ig::mbar_init(w1_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    ig::fence_proxy_async();
    ig::mbar_expect_tx(w1_bar, E_W1_BYTES);
    ig::bulk_load(ig::smem_u32(ring + E_OFF_W1), w1p, E_W1_BYTES, w1_bar);
  }
  sk2[tid] = k2p[tid];
  skb2[tid] = kb2p[tid];

  // 1. the input tile, rows h0-2 .. h0+TH+1 and columns w0-2 .. w0+TW+1, clamped
  uint8_t* in_s = ring + E_OFF_IN;
  for (int idx = tid; idx < IPIX * (E_CIN / 4); idx += THREADS) {
    const int pix = idx / (E_CIN / 4), wd = idx - pix * (E_CIN / 4);
    const int i = pix / IW, j = pix - i * IW;
    const int hh = edge_index(h0 - 2 + i, Hb), ww = edge_index(w0 - 2 + j, Wb);
    *reinterpret_cast<int*>(in_s + pix * E_CIN + wd * 4) = *reinterpret_cast<const int*>(
        x + ((static_cast<long long>(img) * Hb + hh) * Wb + ww) * E_CIN + wd * 4);
  }
  __syncthreads();

  // 2a. im2col: row r is halo pixel r, gathered around its clamped position
  //     (the halo outside the image replicates conv1's boundary output); its
  //     128 bytes of K are 27 words (tap, 4 channels) and 5 words of zeros.
  //     A thread owns word tid % 4 of rows tid / 4 + 64 i of every group.
  uint8_t* im = ring + E_OFF_IM;
#pragma unroll
  for (int i = 0; i < E_ROWS / 64; ++i) {
    const int r = (tid >> 2) + 64 * i;
    const int p = min(r, MPIX - 1);  // rows past the halo are computed and dropped
    const int mr = p / MW, mc = p - mr * MW;
    const int hr = edge_index(h0 - 1 + mr, Hb), wc = edge_index(w0 - 1 + mc, Wb);
    const uint8_t* centre = in_s + ((hr - h0 + 1) * IW + (wc - w0 + 1)) * E_CIN;
#pragma unroll
    for (int grp = 0; grp < ig::GROUPS; ++grp) {
      const int wd = 4 * grp + (tid & 3);  // word of K: tap wd / 3, channels 4 (wd % 3) ..
      const int tap = wd / 3;
      int v = 0;
      if (tap < 9)
        v = *reinterpret_cast<const int*>(centre + ((tap / 3) * IW + tap % 3) * E_CIN +
                                          (wd - 3 * tap) * 4);
      *reinterpret_cast<int*>(im + grp * E_IM_PLANE + r * 16 + (tid & 3) * 4) = v;
    }
  }
  ig::fence_proxy_async();  // the im2col was written by plain stores, wgmma reads it
  __syncthreads();
  ig::mbar_wait(w1_bar, 0);

  // 2b. conv1_1: six units of 64 rows x 128 columns; warpgroup wg takes row
  //     block wg in both column halves and column half wg of row block 2.
  //     Requant + ReLU, then two neighbouring channels as one 16-bit store
  //     into plane n / 16 at the row's halo slot.
  {
    const uint64_t a_strides = ig::desc_strides(E_IM_PLANE, 128);
    const uint64_t b_strides = ig::desc_strides(E_BN * 16, 128);
#pragma unroll 1
    for (int u = 0; u < 3; ++u) {
      const int rb = u < 2 ? wg : 2, nh = u < 2 ? u : wg;
      int acc[E_BN / 2];
#pragma unroll
      for (int i = 0; i < E_BN / 2; ++i) acc[i] = 0;
      const uint32_t a_base = ig::smem_u32(im) + rb * 64 * 16;
      const uint32_t b_base = ig::smem_u32(ring + E_OFF_W1) + nh * E_BN * ig::CHUNK;
      ig::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        ig::Wgmma<false, E_BN>::mma(acc, ig::desc_at(a_strides, a_base + ks * 2 * E_IM_PLANE),
                                    ig::desc_at(b_strides, b_base + ks * 2 * E_BN * 16));
      ig::wgmma_commit();
      ig::wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < E_BN / 8; ++j) {
        const int n = nh * E_BN + 8 * j + 2 * t;
        const float ka = __ldg(k1 + n), kb = __ldg(kb1 + n);
        const float kc = __ldg(k1 + n + 1), kd = __ldg(kb1 + n + 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rb * 64 + 16 * warp + gq + 8 * h;
          if (r < MPIX) {
            const uint8_t q0 = (uint8_t)requant(dequant(acc[4 * j + 2 * h], ka, kb), 0.0f);
            const uint8_t q1 = (uint8_t)requant(dequant(acc[4 * j + 2 * h + 1], kc, kd), 0.0f);
            *reinterpret_cast<uint16_t*>(planes + (n >> 4) * ig::PLANE + r * 16 + (n & 15)) =
                (uint16_t)(q0 | (q1 << 8));
          }
        }
      }
    }
  }
  ig::fence_proxy_async();  // the planes were written by plain stores, wgmma reads them
  __syncthreads();          // and the scratch is free: the weight ring may start

  // 3. conv1_2 from the resident planes, two passes of 128 permuted columns.
  //    Column 8 (4 jc + ph) + 2 t + e of pass p is phase ph of channel
  //    16 t + 8 p + 2 jc + e: a thread requantizes its four phases, keeps
  //    their max, and after pass 1 stores its 16 channels of each pixel.
  int acc[E_BN / 2];
#pragma unroll
  for (int i = 0; i < E_BN / 2; ++i) acc[i] = 0;
  uint32_t keep[4];
  auto pass_epilogue = [&](int pass, int (&a)[E_BN / 2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t word[2] = {0u, 0u};
#pragma unroll
      for (int jc = 0; jc < 4; ++jc)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          int best = 0;  // the ReLU's floor: every requantized phase is >= 0
#pragma unroll
          for (int ph = 0; ph < 4; ++ph) {
            const int j = 4 * jc + ph;
            const int col = pass * E_BN + 8 * j + 2 * t + e;
            best = max(best, (int)requant(dequant(a[4 * j + 2 * h + e], sk2[col], skb2[col]), 0.0f));
          }
          const int i = 2 * jc + e;
          word[i >> 2] |= static_cast<uint32_t>(best) << (8 * (i & 3));
        }
      if (pass == 0) {
        keep[2 * h] = word[0];
        keep[2 * h + 1] = word[1];
      } else {
        const long long px = ig::out_pixel(g, img, h0, w0, h);
        if (px >= 0)
          *reinterpret_cast<uint4*>(y + px * (CMID / 4) + 16 * t) =
              make_uint4(keep[2 * h], keep[2 * h + 1], word[0], word[1]);
      }
    }
  };
  ig::conv_mainloop<false, E_BN, 1, true, 2>(acc, nullptr, w2p, g, img, h0, w0, 0, smem,
                                            pass_epilogue);
}

int launch_encoder(const void* x, const void* w1p, const void* k1, const void* kb1,
                   const void* w2p, const void* k2p, const void* kb2p, void* y, int N, int Hb,
                   int Wb, cudaStream_t st) {
  ig::ConvGeom g = ig::make_geom(N, Hb, Wb, CMID, CMID, E_BN, 1, 0);
  g.ntiles_n = 1;  // one block per spatial tile: it walks both column tiles itself
  const size_t bytes = ig::smem_bytes(g, E_BN, 1) + 8;  // + the conv1_1 weights' barrier
  return static_cast<int>(ig::launch(
      encoder_level1_kernel, g, bytes, st, static_cast<const uint8_t*>(x),
      static_cast<const uint8_t*>(w1p), static_cast<const float*>(k1),
      static_cast<const float*>(kb1), static_cast<const uint8_t*>(w2p),
      static_cast<const float*>(k2p), static_cast<const float*>(kb2p), static_cast<int8_t*>(y)));
}

// ---- K2: decoder_level1 on mma.sync ---------------------------------------

constexpr int D_CIN = 64;                       // dconv2_1's output channels
constexpr int MSTR = CMID + 16;                 // bytes per mid pixel (272: no bank conflicts)
constexpr int ISTR = D_CIN + 16;                // bytes per input pixel
constexpr int IN_BYTES = (IPIX * ISTR + 15) / 16 * 16;
constexpr int D_K1 = 9 * D_CIN;

__device__ __forceinline__ int ldg32(const int8_t* p) {
  return __ldg(reinterpret_cast<const int*>(p));
}

__global__ void __launch_bounds__(THREADS)
decoder_level1_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w1,
                      const float* __restrict__ k1, const float* __restrict__ kb1,
                      const int8_t* __restrict__ w2, const float* __restrict__ k2,
                      const float* __restrict__ kb2, __nv_bfloat16* __restrict__ y, int Hb, int Wb,
                      int Kp1, int Kp2, int Cout) {
  extern __shared__ __align__(128) int8_t smem_d[];
  int8_t* in_s = smem_d;
  int8_t* mid = smem_d + IN_BYTES;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int w0 = blockIdx.x * TW, h0 = blockIdx.y * TH, img = blockIdx.z;

  // 1. the input tile, rows h0-2 .. h0+TH+1 and columns w0-2 .. w0+TW+1, clamped
  for (int idx = tid; idx < IPIX * (D_CIN / 4); idx += THREADS) {
    const int pix = idx / (D_CIN / 4), wd = idx - pix * (D_CIN / 4);
    const int i = pix / IW, j = pix - i * IW;
    const int hh = edge_index(h0 - 2 + i, Hb), ww = edge_index(w0 - 2 + j, Wb);
    *reinterpret_cast<int*>(in_s + pix * ISTR + wd * 4) = *reinterpret_cast<const int*>(
        x + (((long long)img * Hb + hh) * Wb + ww) * D_CIN + wd * 4);
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
        base[i][h] = ((hr - h0 + 1) * IW + (wc - w0 + 1)) * ISTR;
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
        live[h] = k < D_K1;
        const int tap = live[h] ? k / D_CIN : 0;
        ofs[h] = ((tap / 3) * IW + tap % 3) * ISTR + (live[h] ? k - tap * D_CIN : 0);
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

  // 3. conv2 from the mid buffer: warp w owns output row w and the 16
  //    (padded) output channels.
  constexpr int NT = 2;  // n8 tiles per warp
  int acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap - dy * 3;
    const int8_t* pa = mid + ((warp + dy) * MW + g + dx) * MSTR + 4 * t;
    const int8_t* pb[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) pb[j] = w2 + (long long)(j * 8 + g) * Kp2 + tap * CMID + 4 * t;
#pragma unroll 2
    for (int c0 = 0; c0 < CMID; c0 += 32) {
      int fa[4], fb[NT][2];
      fa[0] = *reinterpret_cast<const int*>(pa + c0);
      fa[1] = *reinterpret_cast<const int*>(pa + 8 * MSTR + c0);
      fa[2] = *reinterpret_cast<const int*>(pa + c0 + 16);
      fa[3] = *reinterpret_cast<const int*>(pa + 8 * MSTR + c0 + 16);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        fb[j][0] = ldg32(pb[j] + c0);
        fb[j][1] = ldg32(pb[j] + c0 + 16);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_s8(acc[j], fa, fb[j]);
    }
  }
  // epilogue: dequant, bf16
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = j * 8 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int oh = h0 + warp, ow = w0 + g + 8 * h;
      if (n < Cout && oh < Hb && ow < Wb) {
        __nv_bfloat162 v;
        v.x = __float2bfloat16_rn(dequant(acc[j][2 * h], k2[n], kb2[n]));
        v.y = __float2bfloat16_rn(dequant(acc[j][2 * h + 1], k2[n + 1], kb2[n + 1]));
        *reinterpret_cast<__nv_bfloat162*>(y + (((long long)img * Hb + oh) * Wb + ow) * Cout + n) = v;
      }
    }
  }
}

int launch_decoder(const int8_t* x, const int8_t* w1, const float* k1, const float* kb1,
                   const int8_t* w2, const float* k2, const float* kb2, __nv_bfloat16* y, int N,
                   int Hb, int Wb, int Kp1, int Kp2, int Cout, cudaStream_t st) {
  const int bytes = IN_BYTES + MPIX * MSTR;
  cudaError_t err = cudaFuncSetAttribute(decoder_level1_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((unsigned)((Wb + TW - 1) / TW), (unsigned)((Hb + TH - 1) / TH), (unsigned)N);
  decoder_level1_kernel<<<grid, THREADS, bytes, st>>>(x, w1, k1, kb1, w2, k2, kb2, y, Hb, Wb, Kp1,
                                                      Kp2, Cout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes) of both kernels. All tensors
// contiguous and 16-byte aligned. Launches on `stream` and returns the CUDA
// error code (0 on success).
// pool = 1 (K1): x (N, Hb, Wb, 12) int8; w1: conv1_1's weights as one stage
// chunk, [2 column tiles][8][128][16 bytes] with k = (dy, dx, ci) padded to
// 128; k1, kb1: (256,) f32; w2: conv1_2's stage tiles [2][2 chunks][9 taps][8]
// [128][16] with the output columns in kernels/igemm_layout.py's
// level1_column_order; k2, kb2: (256,) f32 in that order; y (N, Hb, Wb, 64)
// int8. Kp1, Kp2 and Cout are not read.
// pool = 0 (K2): x (N, Hb, Wb, 64) int8; w1: (256, Kp1) and w2: (>= 16, Kp2)
// int8 weights in the gemm_weight layout (output-channel-major, Kp =
// roundup(9*Cin, 64), zero padded); k1, kb1: (256,) f32; k2, kb2: (Cout,) f32;
// y (N, Hb, Wb, Cout) bf16, Cout <= 16 and even.
extern "C" int ccst_fused_two_conv_s8(const void* x, const void* w1, const void* k1,
                                      const void* kb1, const void* w2, const void* k2,
                                      const void* kb2, void* y, int N, int Hb, int Wb, int Cin,
                                      int Kp1, int Kp2, int Cout, int pool, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pool && Cin == E_CIN) return launch_encoder(x, w1, k1, kb1, w2, k2, kb2, y, N, Hb, Wb, st);
  if (!pool && Cin == D_CIN)
    return launch_decoder(static_cast<const int8_t*>(x), static_cast<const int8_t*>(w1),
                          static_cast<const float*>(k1), static_cast<const float*>(kb1),
                          static_cast<const int8_t*>(w2), static_cast<const float*>(k2),
                          static_cast<const float*>(kb2), static_cast<__nv_bfloat16*>(y), N, Hb,
                          Wb, Kp1, Kp2, Cout, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
