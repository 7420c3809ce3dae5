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
// K2 (decoder_level1_kernel) is the mirror image. It is bound by operations
// too (91.9 GOP against 10 MB per batch of 4; 85% of them are the folded
// dconv1_2, K = 576, N = 256), but what a first wgmma version of it waited
// for was the weights: dconv1_2's 147 KB do not fit beside the planes twice an
// SM, and two blocks an SM with two warpgroups each stream them twice a tile
// from L2 (295 KB for 128 output pixels) behind a ring too shallow to hide
// the latency. So K2 is one persistent block an SM, 512 threads:
//   - conv1 (folded dconv1_2, 64 -> 256) has 16-byte channel groups, so it
//     needs no im2col: the clamped 12 x 20 input tile is kept as four planes
//     of pitch 20, and conv1 runs over FLAT positions of that pitch, four
//     64-row blocks (1.33x the 192 rows an im2col would need, two dropped
//     columns a row), so that a tap is a start offset ((dy * 20 + dx) * 16
//     bytes) of the A descriptor and nothing is copied. The other way, K1's
//     im2col per tap, costs nine shared-to-shared copies of 12 KB a tile and a
//     barrier each; it was not taken;
//   - the four warpgroups take one row block each and share every weight
//     stage, so the weights pass once a tile. A stage is dense in K (the three
//     taps of one kernel row for one 128-column half, 3 x 64 bytes of K, no
//     zero half; 24 KB): six steps of six m64n128k32 a warpgroup. The stages
//     do not depend on the tile, so the ring of four runs on across the tiles
//     the block walks: thread 0 refills a slot as soon as every warp has
//     released it (`full` / `empty` mbarriers, no block barrier in the loop);
//   - the sums of a 64 x 128 unit are requantized straight into the core's
//     planes with one 16-byte store for 16 channels (K0's store layout);
//   - flat positions compute conv1 of the over-padded input where the halo
//     leaves the image; a fix-up pass on border tiles overwrites those slots
//     with the copy of the nearest slot inside (the edge replica) before conv2;
//   - conv2 (packed dconv1_1, 256 -> 12) reads the planes as the core does (a
//     tap is a start slot; K0's narrow tile, N = 16) against its 36 KB of
//     weights, which stay in shared memory for the block's life; the two pairs
//     of warpgroups split its K (a chunk each) and add their sums through
//     shared memory; K0's exact dequant -> bf16 epilogue;
//   - the next tile's input is fetched (cp.async, second buffer) while this
//     tile is computed, by the three warps whose rows all lie past the tile.
//     223 KB of shared memory, 124 registers.
// Neither conv of K2 calls ig::conv_mainloop (256 threads, a ring restarted
// every tile): the ring and conv2's tap / K-step walk below repeat the core's
// and read the same layouts of kernels/igemm_layout.py, so a change to the
// core's descriptors or stage layout is made here as well.
#include "conv_igemm_sm90.cuh"
#include "s8_mma.cuh"

namespace {

using ccst_s8::dequant;
using ccst_s8::edge_index;
using ccst_s8::requant;
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

// ---- K2: decoder_level1 on wgmma ------------------------------------------

constexpr int D_THREADS = 512;                   // four warpgroups, one block an SM
constexpr int D_WARPS = D_THREADS / 32;
constexpr int D_CIN = 64;                        // dconv2_1's output channels (bytes a pixel)
constexpr int D_GROUPS = D_CIN / 16;             // 16-byte groups of K a pixel
constexpr int D_BN = 128;                        // columns of one conv1 wgmma (a column half)
constexpr int D_BN2 = 16;                        // conv2's narrow tile (Cout <= 16)
constexpr int D_BLOCKS = 4;                      // 64-row blocks of flat input-tile positions: one a warpgroup
// slots of one input plane: the 240 pixels of the tile, then slack that the
// dropped rows of the last block read; 298 = 2 mod 8, so the four lanes that
// copy one pixel's groups write four different bank groups
constexpr int D_IN_SLOTS = 298;
// rows 16 .. 63 of the last row block (its warps 1 .. 3) are positions past the
// last halo pixel: those warps have nothing to requantize and fetch instead
constexpr int D_FETCHERS = 96;
static_assert(64 * (D_BLOCKS - 1) + 16 >= (MH - 1) * IW + MW, "the fetching warps must own no halo pixel");
constexpr int D_IN_PLANE = D_IN_SLOTS * 16;
constexpr int D_IN_BYTES = D_GROUPS * D_IN_PLANE;
constexpr int D_STAGE = 3 * D_BN * D_CIN;        // one kernel row (3 taps) of one column half: 24 KB
constexpr int D_SLOTS = 4;                       // weight stages of the ring
constexpr int D_STEPS = 6;                       // stages of one tile: column half x kernel row
constexpr int D_W2_BYTES = 2 * 9 * D_BN2 * ig::CHUNK;  // conv2's weights: two chunks of nine taps
constexpr int D_RED_BYTES = 2 * 128 * (D_BN2 / 2) * 4; // conv2's partial sums of warpgroups 2 and 3
constexpr int D_OFF_IN = 2 * ig::A_BYTES;        // after the 16 planes of the intermediate
constexpr int D_OFF_W2 = D_OFF_IN + 2 * D_IN_BYTES;
constexpr int D_OFF_RED = D_OFF_W2 + D_W2_BYTES;
constexpr int D_OFF_RING = D_OFF_RED + D_RED_BYTES;
constexpr int D_OFF_BAR = D_OFF_RING + D_SLOTS * D_STAGE;
constexpr int D_SMEM = D_OFF_BAR + 8 * (2 * D_SLOTS + 1);
static_assert((MH - 1) * IW + MW <= 64 * D_BLOCKS, "the row blocks must cover every halo pixel");
static_assert(64 * D_BLOCKS + 2 * IW + 2 <= D_IN_SLOTS, "the last block's taps must stay inside the plane");
static_assert(D_OFF_IN % 128 == 0 && D_OFF_W2 % 128 == 0 && D_OFF_RING % 128 == 0, "alignment");
static_assert(D_SMEM + CMID * 8 + 2 * D_BN2 * 4 <= 232448, "one block must fit the SM's shared memory");

// requant with ReLU, rint (half to even) and clip to [0, 127], in two parts:
// round_relu rounds max(y, 0) to the nearest even integer (the max commutes
// with the rounding, the conversion saturates), pack_sat_s8x4 clips four of
// them to int8 and packs them, first argument in the lowest byte. Together the
// same bits as requant(y, 0) in fewer instructions: K2's requant of 256
// channels a halo pixel costs half as much time as its tensor-core work, and
// this form of it took 10% off the kernel's time on the card.
__device__ __forceinline__ int round_relu(float y) { return __float2int_rn(fmaxf(y, 0.0f)); }
__device__ __forceinline__ uint32_t pack_sat_s8x4(int b0, int b1, int b2, int b3) {
  uint32_t hi, out;  // cvt.pack: d = sat(b) | sat(a) << 8 | c << 16
  asm("cvt.pack.sat.s8.s32.b32 %0, %1, %2, %3;" : "=r"(hi) : "r"(b3), "r"(b2), "r"(0));
  asm("cvt.pack.sat.s8.s32.b32 %0, %1, %2, %3;" : "=r"(out) : "r"(b1), "r"(b0), "r"(hi));
  return out;
}

__global__ void __launch_bounds__(D_THREADS, 1)
decoder_level1_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ w1p,
                      const float* __restrict__ k1, const float* __restrict__ kb1,
                      const uint8_t* __restrict__ w2p, const float* __restrict__ k2,
                      const float* __restrict__ kb2, __nv_bfloat16* __restrict__ y,
                      const ig::ConvGeom g) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(16) float2 sk1[CMID];  // conv1's terms, {k, kb} a channel
  __shared__ float sk2[D_BN2], skb2[D_BN2];
  uint8_t* planes = smem;  // 16 planes of 181 slots: the intermediate
  int* red = reinterpret_cast<int*>(smem + D_OFF_RED);
  const uint32_t in_s = ig::smem_u32(smem + D_OFF_IN);
  const uint32_t w2_s = ig::smem_u32(smem + D_OFF_W2);
  const uint32_t ring = ig::smem_u32(smem + D_OFF_RING);
  const uint32_t full = ig::smem_u32(smem + D_OFF_BAR);  // one arrival: the producer's, plus the bytes
  const uint32_t empty = full + 8 * D_SLOTS;              // one arrival a warp
  const uint32_t w2_bar = empty + 8 * D_SLOTS;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = (tid >> 5) & 3, wg = tid >> 7;
  const int gq = lane >> 2, t = lane & 3;
  const int Hb = g.H, Wb = g.W;
  const int ntiles = g.N * g.tiles_y * g.tiles_x;
  const int my_tiles = (ntiles - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1) /
                       static_cast<int>(gridDim.x);
  const int total = D_STEPS * my_tiles;  // weight stages this block consumes

  // conv1's weights are six stages (column half, kernel row), the same for
  // every tile, so the ring runs on across tiles. At the top of step s thread
  // 0 fetches up to step s + D_SLOTS - 2: that slot was read by step s - 2,
  // which every warp releases once it has queued step s - 1, and no warp needs
  // thread 0 for that (one slot further and its own warpgroup would).
  int produced = 0;
  auto produce = [&](int last) {  // fetch every stage up to step `last`
    while (produced < total && produced <= last) {
      const int slot = produced % D_SLOTS;
      if (produced >= D_SLOTS) ig::mbar_wait(empty + 8 * slot, (produced / D_SLOTS - 1) & 1);
      ig::mbar_expect_tx(full + 8 * slot, D_STAGE);
      ig::bulk_load(ring + slot * D_STAGE, w1p + (produced % D_STEPS) * D_STAGE, D_STAGE,
                    full + 8 * slot);
      ++produced;
    }
  };
  auto tile_origin = [&](int tile, int& img, int& h0, int& w0) {
    w0 = (tile % g.tiles_x) * TW;
    tile /= g.tiles_x;
    h0 = (tile % g.tiles_y) * TH;
    img = tile / g.tiles_y;
  };
  // the input of one 8 x 16 tile, rows h0-2 .. h0+TH+1 and columns w0-2 ..
  // w0+TW+1, clamped, as planes [16-byte group: 4][tile pixel, pitch IW][16
  // bytes], copied by the threads first, first + nthreads, ..
  auto fetch_input = [&](int tile, int buf, int first, int nthreads) {
    int img, h0, w0;
    tile_origin(tile, img, h0, w0);
    for (int idx = first; idx < IPIX * D_GROUPS; idx += nthreads) {
      const int pix = idx / D_GROUPS, grp = idx - pix * D_GROUPS;
      const int i = pix / IW, j = pix - i * IW;
      const int hh = edge_index(h0 - 2 + i, Hb), ww = edge_index(w0 - 2 + j, Wb);
      ig::cp_async16(in_s + buf * D_IN_BYTES + grp * D_IN_PLANE + pix * 16,
                     x + ((static_cast<long long>(img) * Hb + hh) * Wb + ww) * D_CIN + grp * 16, true);
    }
    ig::cp_async_commit();
  };

  if (tid == 0) {
    for (int s = 0; s < D_SLOTS; ++s) {
      ig::mbar_init(full + 8 * s, 1);
      ig::mbar_init(empty + 8 * s, D_WARPS);
    }
    ig::mbar_init(w2_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    ig::fence_proxy_async();
    ig::mbar_expect_tx(w2_bar, D_W2_BYTES);
    ig::bulk_load(w2_s, w2p, D_W2_BYTES, w2_bar);
    produce(D_SLOTS - 2);
  }
  if (tid < CMID) sk1[tid] = make_float2(k1[tid], kb1[tid]);
  if (tid < D_BN2) {
    sk2[tid] = tid < g.Cout ? k2[tid] : 0.0f;
    skb2[tid] = tid < g.Cout ? kb2[tid] : 0.0f;
  }
  fetch_input(blockIdx.x, 0, tid, D_THREADS);

  const uint64_t a1_strides = ig::desc_strides(D_IN_PLANE, 128);
  const uint64_t b1_strides = ig::desc_strides(D_BN * 16, 128);
  const uint64_t a2_strides = ig::desc_strides(ig::PLANE, ig::HALO_W * 16);
  const uint64_t b2_strides = ig::desc_strides(D_BN2 * 16, 128);
  const bool releaser = lane == 0;
  const bool fetcher = tid >= D_THREADS - D_FETCHERS;
  int step = 0;
  for (int it = 0; it < my_tiles; ++it) {
    const int tile = blockIdx.x + it * gridDim.x;
    int img, h0, w0;
    tile_origin(tile, img, h0, w0);
    const uint32_t in_t = in_s + (it & 1) * D_IN_BYTES;

    // 1. this tile's input has landed (it was fetched during the tile before);
    //    the barrier also ends every read of the planes and of the other input
    //    buffer by the tile before, so the next tile's input may go there
    //    (step 2 fetches it, by warps that have no sums to requantize)
    ig::cp_async_wait<0>();
    ig::fence_proxy_async();  // cp.async wrote the tile, wgmma reads it
    __syncthreads();

    // 2. conv1 over flat positions of the input tile: row r of warpgroup wg is
    //    position f = 64 wg + r, the halo pixel (f / IW, f % IW) where that is
    //    one; tap (dy, dx) is the start offset dy * IW + dx. A step is one
    //    kernel row of one column half: three taps of 64 bytes, six wgmmas of
    //    m64n128k32 a warpgroup, all four on the same weight stage.
    {
      int acc[D_BN / 2];
#pragma unroll 1
      for (int hs = 0; hs < D_STEPS; ++hs, ++step) {
        const int slot = step % D_SLOTS;
        const int nh = hs / 3, dy = hs - 3 * nh;
        if (tid == 0) produce(step + D_SLOTS - 2);
        ig::mbar_wait(full + 8 * slot, (step / D_SLOTS) & 1);
        const uint32_t a_row = in_t + (64 * wg + dy * IW) * 16;
        const uint32_t b_base = ring + slot * D_STAGE;
        ig::wgmma_fence();
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int ks = 0; ks < D_CIN / 32; ++ks)
            ig::Wgmma<false, D_BN>::mma(
                acc, ig::desc_at(a1_strides, a_row + dx * 16 + ks * 2 * D_IN_PLANE),
                ig::desc_at(b1_strides, b_base + dx * (D_BN * D_CIN) + ks * 2 * D_BN * 16),
                (dx | ks) ? 1 : (dy != 0));  // a unit's first product overwrites the sums
        ig::wgmma_commit();
        // hand back the slots whose products have left the tensor cores
        if (dy == 2) ig::wgmma_wait<0>(); else ig::wgmma_wait<1>();
        if (releaser) {
          if (dy != 0) ig::mbar_arrive(empty + 8 * ((step - 1) % D_SLOTS));
          if (dy == 2) ig::mbar_arrive(empty + 8 * slot);
        }
        if (dy != 2) continue;
        // the three warps whose rows all lie past the tile fetch the next
        // tile's input while the others requantize
        if (fetcher && nh == 0 && it + 1 < my_tiles)
          fetch_input(tile + gridDim.x, (it + 1) & 1, tid - (D_THREADS - D_FETCHERS), D_FETCHERS);

        // requant + ReLU of the rows that are halo pixels (the others are
        // pitch columns or lie past the tile: most warps of the last row
        // block skip it all). After the quad transpose lane t holds 16
        // neighbouring channels of a pixel: one 16-byte store into plane
        // n / 16, halo slot.
        bool halo[2], live[2];
        int slot_at[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int f = 64 * wg + 16 * warp + gq + 8 * h;
          const int mr = f / IW, mc = f - mr * IW;
          halo[h] = mr < MH && mc < MW;
          live[h] = __any_sync(0xffffffffu, halo[h]);
          slot_at[h] = (mr * MW + mc) * 16;
        }
        if (!live[0] && !live[1]) continue;
#pragma unroll
        for (int jj = 0; jj < D_BN / 64; ++jj) {
          uint32_t v[2][4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            int b[2][4];
#pragma unroll
            for (int jp = 0; jp < 2; ++jp) {
              const int j = 8 * jj + 2 * q + jp;  // columns 8 j + 2 t, + 1: one 16-byte read of their terms
              const float4 kk = *reinterpret_cast<const float4*>(&sk1[nh * D_BN + 8 * j + 2 * t]);
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                b[h][2 * jp] = round_relu(dequant(acc[4 * j + 2 * h], kk.x, kk.y));
                b[h][2 * jp + 1] = round_relu(dequant(acc[4 * j + 2 * h + 1], kk.z, kk.w));
              }
            }
#pragma unroll
            for (int h = 0; h < 2; ++h)
              v[h][q] = pack_sat_s8x4(b[h][0], b[h][1], b[h][2], b[h][3]);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (!live[h]) continue;
            const uint4 out = ig::gather_s8x16(v[h]);
            if (halo[h])
              *reinterpret_cast<uint4*>(planes + ((nh * D_BN + 64 * jj) / 16 + t) * ig::PLANE +
                                        slot_at[h]) = out;
          }
        }
      }
    }
    __syncthreads();  // the planes are complete

    // 2b. the edge replica: a halo pixel outside the image is the copy of
    //     conv1's output at the nearest pixel inside (always a pixel of this
    //     tile's halo, never one that is overwritten), not conv1 of the
    //     over-padded input that step 2 computed there
    if (h0 == 0 || w0 == 0 || h0 + TH >= Hb || w0 + TW >= Wb) {
      for (int idx = tid; idx < MPIX * 2 * ig::GROUPS; idx += D_THREADS) {
        const int p = idx / (2 * ig::GROUPS), pl = idx - p * (2 * ig::GROUPS);
        const int mr = p / MW, mc = p - mr * MW;
        const int sr = edge_index(h0 - 1 + mr, Hb) - (h0 - 1);
        const int sc = edge_index(w0 - 1 + mc, Wb) - (w0 - 1);
        if (sr != mr || sc != mc)
          *reinterpret_cast<uint4*>(planes + pl * ig::PLANE + p * 16) =
              *reinterpret_cast<const uint4*>(planes + pl * ig::PLANE + (sr * MW + sc) * 16);
      }
    }
    ig::fence_proxy_async();  // the planes were written by plain stores, wgmma reads them
    __syncthreads();

    // 3. conv2 from the resident planes as the core runs it (a tap is a start
    //    slot, N = 16), its weights resident too. Warpgroup wg takes the tile's
    //    column half wg % 2 over the channels of chunk wg / 2; warpgroups 2 and
    //    3 hand their sums over through shared memory.
    int acc2[D_BN2 / 2];
    {
      ig::mbar_wait(w2_bar, 0);
      const int c = wg >> 1;
      const uint32_t a_base = ig::smem_u32(planes) + c * ig::A_BYTES + (wg & 1) * 8 * 16;
      const uint32_t b_base = w2_s + c * 9 * D_BN2 * ig::CHUNK;
      ig::wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          ig::Wgmma<false, D_BN2>::mma(
              acc2,
              ig::desc_at(a2_strides, a_base + ((tap / 3) * MW + tap % 3) * 16 + ks * 2 * ig::PLANE),
              ig::desc_at(b2_strides, b_base + tap * D_BN2 * ig::CHUNK + ks * 2 * D_BN2 * 16),
              (tap | ks) != 0);
      ig::wgmma_commit();
      ig::wgmma_wait<0>();
    }
    int* mine = red + ((tid & 255) * (D_BN2 / 2));
    if (wg >= 2) {
#pragma unroll
      for (int i = 0; i < D_BN2 / 2; i += 4)
        *reinterpret_cast<int4*>(mine + i) = make_int4(acc2[i], acc2[i + 1], acc2[i + 2], acc2[i + 3]);
    }
    __syncthreads();
    if (wg < 2) {
#pragma unroll
      for (int i = 0; i < D_BN2 / 2; i += 4) {
        const int4 o = *reinterpret_cast<const int4*>(mine + i);
        acc2[i] += o.x; acc2[i + 1] += o.y; acc2[i + 2] += o.z; acc2[i + 3] += o.w;
      }
      auto value = [&](int j, int e, int a) {
        const int c = 8 * j + 2 * t + e;
        return dequant(a, sk2[c], skb2[c]);
      };
      ig::store_tile_bf16<D_BN2>(acc2, value, y, g, img, h0, w0, 0);
    }
  }
}

int launch_decoder(const void* x, const void* w1p, const void* k1, const void* kb1,
                   const void* w2p, const void* k2, const void* kb2, void* y, int N, int Hb, int Wb,
                   int Cout, cudaStream_t st) {
  const ig::ConvGeom g = ig::make_geom(N, Hb, Wb, CMID, Cout, D_BN2, 9, 0);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(decoder_level1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               D_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one persistent block an SM: it walks the tiles blockIdx.x, + gridDim.x, ..
  const long long ntiles = static_cast<long long>(N) * g.tiles_y * g.tiles_x;
  const unsigned blocks = static_cast<unsigned>(ntiles < sms ? ntiles : sms);
  decoder_level1_kernel<<<blocks, D_THREADS, D_SMEM, st>>>(
      static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(w1p),
      static_cast<const float*>(k1), static_cast<const float*>(kb1),
      static_cast<const uint8_t*>(w2p), static_cast<const float*>(k2),
      static_cast<const float*>(kb2), static_cast<__nv_bfloat16*>(y), g);
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
// int8. Cout is not read.
// pool = 0 (K2): x (N, Hb, Wb, 64) int8; w1: dconv1_2's weights as 64-byte
// stage tiles [2 column tiles][9 taps][4][128][16 bytes]; k1, kb1: (256,) f32;
// w2: dconv1_1's stage tiles of the narrow tile, [1][2 chunks][9 taps][8][16]
// [16 bytes] (K0's own layout for Cout <= 16); k2, kb2: (Cout,) f32; y (N, Hb,
// Wb, Cout) bf16, Cout <= 16.
extern "C" int ccst_fused_two_conv_s8(const void* x, const void* w1, const void* k1,
                                      const void* kb1, const void* w2, const void* k2,
                                      const void* kb2, void* y, int N, int Hb, int Wb, int Cin,
                                      int Cout, int pool, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pool && Cin == E_CIN) return launch_encoder(x, w1, k1, kb1, w2, k2, kb2, y, N, Hb, Wb, st);
  if (!pool && Cin == D_CIN && Cout <= D_BN2)
    return launch_decoder(x, w1, k1, kb1, w2, k2, kb2, y, N, Hb, Wb, Cout, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
