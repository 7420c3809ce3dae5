// The Hopper core of the 3x3 conv kernels (reflect_conv3x3.cu, bf16, and
// qconv3x3_s8.cu, int8; the fused kernels of level1_s8.cu and pool_conv_s8.cu
// write its A planes themselves and run its mainloop, or their own loops, on
// them): an implicit GEMM on `wgmma`, in bytes, so that one mainloop serves
// both element types.
//
// Output tile. A block of two warpgroups computes 8 rows x 16 pixels of one
// image for BN output channels; each warpgroup owns an 8 x 8 half (the 64 rows
// of its wgmma) and keeps the sums in registers.
//
// A operand: each input pixel enters shared memory once per channel chunk,
// not once per tap. The 10 x 18 halo of the tile is gathered by index (the
// padded position mirrored or clamped, so the padded tensor never exists) with
// cp.async, 128 bytes of channels per pixel and chunk (64 bf16, 128 int8), and
// stored channel-group major: sA[group of 16 bytes][halo pixel][16 bytes].
// wgmma then reads A straight from that tile through a descriptor, without
// swizzle: a core matrix (8 rows of 16 bytes, 128 contiguous bytes) is 8
// neighbouring pixels of one halo row, the next 8 rows of the 64 are the next
// halo row (stride byte offset = the halo pitch, 18 * 16 bytes), the next 16
// bytes of K the next plane (leading byte offset = PLANE). A tap (dy, dx) is
// a start address (dy * 18 + dx) * 16 bytes further on: 16-byte aligned,
// which is all the unswizzled layout asks. That is why the tile is 8 pixels
// wide per warpgroup and why A does not go through registers (ldmatrix):
// nothing but the wgmma itself touches the operands. PLANE holds 181
// pixel slots, an odd count, so the eight lanes that copy one pixel's 128
// bytes write eight different bank groups.
//
// B operand: the weights are packed on the host (kernels/conv.py, qconv.py)
// into the very bytes a stage holds in shared memory, K-major for both types:
//   wp[n tile][chunk][tap][group of 16 bytes of K: 8][n: BN][16 bytes]
// so one thread fetches a whole stage with one cp.async.bulk that completes
// on an mbarrier; no tensor map. Leading byte offset BN * 16, stride byte
// offset 128.
//
// Ring. A step is one tap of one chunk (TPS = 1: four stages of B, the chunk's
// A tile in one of two slots) or, for the narrow tiles whose B is small, all
// nine taps of a chunk (TPS = 9: three stages of A and B). Step s + STAGES - 2
// is fetched while step s is multiplied and step s - 1 may still be in the
// tensor cores (wgmma.wait_group 1), so the barrier at the top of a step has
// already seen every warpgroup finish the step whose slot is refilled.
//
// Nearest-2x input (ConvGeom::up = 1; K3's decoder convs after an upsample).
// The output plane is H x W and the input is the (H / 2, W / 2) plane it
// would be upsampled from: halo position i of an axis reads source index
// pad_index(i, H) >> 1, since upsampled row y holds source row y >> 1 and a
// reflection (or clamp) at the upsampled edge is one in the upsampled plane,
// then the shift. Every halo slot holds the value it holds when the
// upsampled tensor is gathered, so the sums are the same, bit for bit; the
// upsampled tensor is never written (4x the source's bytes) nor read back
// (the conv reads the source, neighbouring slots the same pixel, from L2
// after the first). The int8 kernels launch with up = 0.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace ccst_igemm {

constexpr int TH = 8;                        // tile rows
constexpr int TW = 16;                       // tile pixels per row (8 per warpgroup)
constexpr int HALO_W = TW + 2;
constexpr int HALO_PX = (TH + 2) * HALO_W;   // 180
constexpr int PLANE = (HALO_PX + 1) * 16;    // bytes of one 16-byte channel group plane
constexpr int GROUPS = 8;                    // 16-byte groups per pixel and chunk
constexpr int CHUNK = GROUPS * 16;           // bytes of channels per pixel and chunk
constexpr int A_BYTES = GROUPS * PLANE;      // one halo tile of one chunk
constexpr int THREADS = 256;                 // two warpgroups
constexpr int A_ITEMS = (HALO_PX + THREADS / GROUPS - 1) / (THREADS / GROUPS);
constexpr int MAX_STAGES = 4;

template <int TPS> struct Ring { static constexpr int STAGES = TPS == 1 ? 4 : 3; };

struct ConvGeom {
  int N, H, W;
  int cin_bytes;           // Cin * element size; a multiple of 16
  int Cout;
  int nchunks;             // ceil(cin_bytes / CHUNK)
  int tiles_x, tiles_y;    // spatial tiles of one image
  int ntiles_n;            // output-channel tiles
  int reflect;             // 1: reflect padding, 0: edge padding
  int row_shift;           // output row h is centred on input row h - row_shift (0: a plain conv)
  int up;                  // 1: the input is the (H / 2, W / 2) plane, read through the nearest-2x map
  int a_slots, b_slots;    // slots allocated in dynamic shared memory
};

// Index of padded position i of an axis of length n (reflect or edge), then
// clamped: rows and columns past a ragged tile's image only feed outputs that
// are never stored, they just have to be addresses inside the tensor.
__device__ __forceinline__ int pad_index(int i, int n, int reflect) {
  if (reflect) i = i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
  return min(max(i, 0), n - 1);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  const int bytes = pred ? 16 : 0;  // 0 -> zero fill, no global read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// cp.async writes through the generic proxy, wgmma reads through the async one
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// Wait for the phase of the given parity; a barrier that never completes is a
// bug of the kernel, so it traps after about a second instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > 2000000000LL) __trap();
  }
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Upper fields of an unswizzled shared-memory matrix descriptor: leading
// (bits 16..29) and stride (bits 32..45) byte offsets in 16-byte units; the
// start address (bits 0..13, also in 16-byte units) is OR-ed in per wgmma.
__device__ __forceinline__ uint64_t desc_strides(int lbo_bytes, int sbo_bytes) {
  return (static_cast<uint64_t>(lbo_bytes >> 4) << 16) | (static_cast<uint64_t>(sbo_bytes >> 4) << 32);
}
__device__ __forceinline__ uint64_t desc_at(uint64_t strides, uint32_t addr) {
  return strides | static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
}

// D (64 x N, f32 or s32 in registers) += A (64 x 32 bytes of K) * B (N x 32
// bytes of K), both from shared memory, K-major. BF16: m64nNk16; else
// m64nNk32 on int8. Register j of a thread (warp w of the warpgroup, g =
// lane / 4, t = lane % 4): row 16 w + g + 8 * ((j / 2) % 2), column
// 8 * (j / 4) + 2 t + j % 2. accumulate = 0: D = A * B, whatever D held.
template <bool BF16, int N> struct Wgmma;
template <> struct Wgmma<true, 8> {
  static __device__ __forceinline__ void mma(float (&d)[4], uint64_t da, uint64_t db,
                                             int accumulate = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, "
        "%4, %5, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(accumulate));
  }
};
template <> struct Wgmma<true, 64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
  }
};
template <> struct Wgmma<true, 128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db,
                                             int accumulate = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(accumulate));
  }
};
template <> struct Wgmma<false, 16> {
  static __device__ __forceinline__ void mma(int (&d)[8], uint64_t da, uint64_t db,
                                             int accumulate = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "l"(da), "l"(db), "r"(accumulate));
  }
};
template <> struct Wgmma<false, 64> {
  static __device__ __forceinline__ void mma(int (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
  }
};
template <> struct Wgmma<false, 128> {
  static __device__ __forceinline__ void mma(int (&d)[64], uint64_t da, uint64_t db,
                                             int accumulate = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(accumulate));
  }
};

template <bool BF16> struct AccType { using type = float; };
template <> struct AccType<false> { using type = int; };

// What a single-pass caller hands the mainloop as its per-pass epilogue.
struct NoPassEpilogue {
  template <typename Acc> __device__ __forceinline__ void operator()(int, Acc&) const {}
};

// The mainloop: acc += conv3x3 of the block's tile. x is the NHWC input in
// bytes, wp the packed weights; (n, y0, x0) the tile's image and corner,
// ntile its output-channel tile. Every thread of the block calls it.
//
// RESIDENT: the caller has already written the tile's halo, every chunk of it
// (g.a_slots == g.nchunks), into the A planes at the head of `smem` (and made
// it visible to the async proxy); x is not read and nothing is gathered.
// NPASS > 1: the block walks output-channel tiles ntile .. ntile + NPASS - 1
// over the same A in one run of the weight ring; after each tile's last step
// epi(pass, acc) consumes the sums and they restart from zero.
// KSTEPS: the 32-byte K steps of a pixel that a chunk holds. 4 is the full
// 128-byte chunk. 2 is for a resident tile of at most 64 bytes of channels
// (one chunk): the tile is four planes, a tap's weights are BN x 64 bytes, and
// no stage carries the zero half that a 64-byte layer leaves in a full chunk.
template <bool BF16, int BN, int TPS, bool RESIDENT = false, int NPASS = 1, int KSTEPS = 4,
          typename Epi = NoPassEpilogue>
__device__ __forceinline__ void conv_mainloop(typename AccType<BF16>::type (&acc)[BN / 2],
                                              const uint8_t* __restrict__ x,
                                              const uint8_t* __restrict__ wp, const ConvGeom& g,
                                              int n, int y0, int x0, int ntile, uint8_t* smem,
                                              Epi epi = Epi()) {
  static_assert(KSTEPS == 4 || (KSTEPS == 2 && RESIDENT), "only a resident tile may be half a chunk");
  constexpr int S = Ring<TPS>::STAGES;
  constexpr int SPC = 9 / TPS;             // steps per chunk
  constexpr int A_TILE = KSTEPS * 2 * PLANE;  // one halo tile of one chunk (A_BYTES when KSTEPS == 4)
  constexpr int B_TAP = BN * KSTEPS * 32;  // bytes of one tap's weights of one chunk
  constexpr int B_STAGE = TPS * B_TAP;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const uint32_t sA = smem_u32(smem);
  const uint32_t sB = sA + g.a_slots * A_TILE;
  const uint32_t bars = sB + g.b_slots * B_STAGE;
  const int T = g.nchunks * SPC;       // steps of one output-channel tile
  const int total = NPASS * T;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_proxy_async();
  }
  // the halo pixels this thread copies: pixel (tid / 8) + 32 i, group tid % 8
  const int grp = tid & (GROUPS - 1);
  int pix[A_ITEMS];
  if constexpr (!RESIDENT) {
#pragma unroll
    for (int i = 0; i < A_ITEMS; ++i) {
      const int p = (tid >> 3) + (THREADS / GROUPS) * i;
      const int hy = p / HALO_W, hx = p - hy * HALO_W;
      const int gy = pad_index(y0 - 1 - g.row_shift + hy, g.H, g.reflect) >> g.up;
      const int gx = pad_index(x0 - 1 + hx, g.W, g.reflect) >> g.up;
      pix[i] = p < HALO_PX ? (n * (g.H >> g.up) + gy) * (g.W >> g.up) + gx : -1;
    }
  }
  __syncthreads();  // the barriers are initialised

  // the weight stages of tiles ntile .. ntile + NPASS - 1 are one run of bytes
  auto load_step = [&](int step) {
    if constexpr (!RESIDENT) {
      const int c = step / SPC;
      if (step - c * SPC == 0) {
        const int cb = c * CHUNK + grp * 16;  // byte of this group in the pixel's channels
        const bool in = cb < g.cin_bytes;     // past Cin: zero fill (the weights are zero there too)
        const uint32_t dst = sA + (c % g.a_slots) * A_TILE + grp * PLANE;
#pragma unroll
        for (int i = 0; i < A_ITEMS; ++i) {
          if (pix[i] < 0) continue;
          const int p = (tid >> 3) + (THREADS / GROUPS) * i;
          cp_async16(dst + p * 16, in ? x + static_cast<size_t>(pix[i]) * g.cin_bytes + cb : x, in);
        }
      }
    }
    if (tid == 0) {
      const int slot = step % S;
      mbar_expect_tx(bars + 8 * slot, B_STAGE);
      bulk_load(sB + slot * B_STAGE, wp + (static_cast<size_t>(ntile) * T + step) * B_STAGE,
                B_STAGE, bars + 8 * slot);
    }
  };

#pragma unroll
  for (int s = 0; s < S - 2; ++s) {
    if (s < total) load_step(s);
    cp_async_commit();
  }

  const uint64_t a_strides = desc_strides(PLANE, HALO_W * 16);
  const uint64_t b_strides = desc_strides(BN * 16, 128);
  for (int pass = 0; pass < NPASS; ++pass) {
    for (int ps = 0; ps < T; ++ps) {
      const int step = pass * T + ps;
      const int slot = step % S;
      cp_async_wait<S - 3>();  // this thread's copies for `step` have landed
      fence_proxy_async();
      __syncthreads();         // everyone's have, and step - 2 has left the tensor cores
      if (step + S - 2 < total) load_step(step + S - 2);
      cp_async_commit();
      mbar_wait(bars + 8 * slot, (step / S) & 1);

      const int c = ps / SPC;
      const int t0 = (ps - c * SPC) * TPS;
      const int kc = min(KSTEPS, (g.cin_bytes - c * CHUNK + 31) >> 5);  // 32-byte K steps in this chunk
      const uint32_t a_base = sA + (c % g.a_slots) * A_TILE + wg * 8 * 16;
      const uint32_t b_base = sB + slot * B_STAGE;
      // one tap's products; FULL: all KSTEPS K steps, no branch between the wgmmas
      // (across a branch the assembler fences every one of them again)
      auto tap_mma = [&](int tt, auto full) {
        const int tap = t0 + tt;
        const int dy = tap / 3, dx = tap - dy * 3;
        const uint32_t a_tap = a_base + (dy * HALO_W + dx) * 16;
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks) {
          if (decltype(full)::value || ks < kc)
            Wgmma<BF16, BN>::mma(acc, desc_at(a_strides, a_tap + ks * 2 * PLANE),
                                 desc_at(b_strides, b_base + tt * B_TAP + ks * 2 * BN * 16));
        }
      };
      wgmma_fence();
      if (kc == KSTEPS) {
#pragma unroll
        for (int tt = 0; tt < TPS; ++tt) tap_mma(tt, std::true_type{});
      } else {
#pragma unroll
        for (int tt = 0; tt < TPS; ++tt) tap_mma(tt, std::false_type{});
      }
      wgmma_commit();
      wgmma_wait<1>();
    }
    if constexpr (NPASS > 1) {
      wgmma_wait<0>();
      epi(pass, acc);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    }
  }
  wgmma_wait<0>();
}

// The output pixel of accumulator row half h (0: registers 4j, 4j+1; 1:
// 4j+2, 4j+3) of this thread: tile row 2 w + h, tile column 8 wg + lane / 4.
// Returns the pixel's index in the (N, H, W) plane, or -1 past the image.
__device__ __forceinline__ long long out_pixel(const ConvGeom& g, int n, int y0, int x0, int h) {
  const int tid = threadIdx.x;
  const int oy = y0 + 2 * ((tid >> 5) & 3) + h;
  const int ox = x0 + 8 * (tid >> 7) + ((tid & 31) >> 2);
  return (oy < g.H && ox < g.W) ? (static_cast<long long>(n) * g.H + oy) * g.W + ox : -1;
}

// 4 x 4 transpose across the four lanes of a quad (t = lane % 4): on return
// v[s] is what lane s of the quad held in v[t]. It turns "two neighbouring
// channels of four 8-channel groups" into "all eight channels of one group",
// so a lane can store 16 bytes.
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int t) {
#pragma unroll
  for (int p = 0; p < 4; p += 2) {
    const uint32_t got = __shfl_xor_sync(0xffffffffu, (t & 1) ? v[p] : v[p + 1], 1);
    if (t & 1) v[p] = got; else v[p + 1] = got;
  }
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const uint32_t got = __shfl_xor_sync(0xffffffffu, (t & 2) ? v[p] : v[p + 2], 2);
    if (t & 2) v[p] = got; else v[p + 2] = got;
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Store the tile as bf16. value(j, e, a) is the float of accumulator a at tile
// column 8 j + 2 t + e, already past bias / dequant and ReLU. Cout % 8 == 0:
// 16-byte stores after a quad transpose; otherwise two-byte stores.
template <int BN, typename Acc, typename F>
__device__ __forceinline__ void store_tile_bf16(const Acc (&acc)[BN / 2], F value,
                                                __nv_bfloat16* __restrict__ y, const ConvGeom& g,
                                                int n, int y0, int x0, int n0) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long px = out_pixel(g, n, y0, x0, h);
    __nv_bfloat16* row = y + (px < 0 ? 0 : px) * g.Cout + n0;
    if constexpr (BN >= 32) {
      if ((g.Cout & 7) == 0) {
#pragma unroll
        for (int jj = 0; jj < BN / 32; ++jj) {
          uint32_t v[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = 4 * jj + q;
            v[q] = pack_bf16x2(value(j, 0, acc[4 * j + 2 * h]), value(j, 1, acc[4 * j + 2 * h + 1]));
          }
          quad_transpose(v, t);
          const int col = 8 * (4 * jj + t);
          if (px >= 0 && n0 + col < g.Cout)
            *reinterpret_cast<uint4*>(row + col) = make_uint4(v[0], v[1], v[2], v[3]);
        }
        continue;
      }
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t + e;
        const float f = value(j, e, acc[4 * j + 2 * h + e]);
        if (px >= 0 && n0 + col < g.Cout) row[col] = __float2bfloat16_rn(f);
      }
  }
}

// v[q] holds this lane's bytes of tile columns 64 jj + 16 q + {2 t, 2 t + 1, 8 +
// 2 t, 9 + 2 t} (two neighbouring columns of two 8-column groups); on return
// lane t of the quad has columns 64 jj + 16 t .. + 15 in order, 16 bytes.
// Every lane of the quad must call it.
__device__ __forceinline__ uint4 gather_s8x16(uint32_t (&v)[4]) {
  quad_transpose(v, threadIdx.x & 3);
  return make_uint4(__byte_perm(v[0], v[1], 0x5410), __byte_perm(v[2], v[3], 0x5410),
                    __byte_perm(v[0], v[1], 0x7632), __byte_perm(v[2], v[3], 0x7632));
}

// Sixteen int8 outputs of one pixel as one 16-byte word. quant(j, e, a) is the
// requantized value (0..255 as its two's-complement byte) of accumulator a at
// tile column 8 j + 2 t + e. Round jj covers columns 64 jj .. 64 jj + 63; on
// return lane t of a quad holds columns 64 jj + 16 t .. + 15 of row half h.
// Every lane of the quad must call it.
template <int NACC, typename Q>
__device__ __forceinline__ uint4 pack_s8x16(const int (&acc)[NACC], Q quant, int jj, int h) {
  uint32_t v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 8 * jj + 2 * q + (i >> 1);
      b[i] = quant(j, i & 1, acc[4 * j + 2 * h + (i & 1)]);
    }
    v[q] = b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24);
  }
  return gather_s8x16(v);
}

// Store the tile as int8, quant as above. Cout % 16 == 0 and BN >= 64: 16-byte
// stores of 16 channels; otherwise one byte at a time.
template <int BN, typename Q>
__device__ __forceinline__ void store_tile_s8(const int (&acc)[BN / 2], Q quant,
                                              int8_t* __restrict__ y, const ConvGeom& g, int n,
                                              int y0, int x0, int n0) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long px = out_pixel(g, n, y0, x0, h);
    int8_t* row = y + (px < 0 ? 0 : px) * g.Cout + n0;
    if constexpr (BN >= 64) {
      if ((g.Cout & 15) == 0) {
#pragma unroll
        for (int jj = 0; jj < BN / 64; ++jj) {
          const uint4 v = pack_s8x16(acc, quant, jj, h);
          const int col = 64 * jj + 16 * t;
          if (px >= 0 && n0 + col < g.Cout) *reinterpret_cast<uint4*>(row + col) = v;
        }
        continue;
      }
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t + e;
        const uint32_t q = quant(j, e, acc[4 * j + 2 * h + e]);
        if (px >= 0 && n0 + col < g.Cout) row[col] = static_cast<int8_t>(q);
      }
  }
}

// ---- host side ----------------------------------------------------------

// Blocks per SM a kernel is compiled for: three of the 64-wide tile (85
// registers a thread), two of the 128-wide one.
constexpr int min_blocks(int BN) { return BN <= 64 ? 3 : 2; }

// Output-channel tile: the narrow one for the few-channel layers, else 64 or 128.
inline int pick_bn(int cout, int narrow) { return cout <= narrow ? narrow : (cout <= 64 ? 64 : 128); }

// H, W: the output plane (with up = 1, twice the input's).
inline ConvGeom make_geom(int N, int H, int W, int cin_bytes, int Cout, int BN, int TPS,
                          int reflect, int row_shift = 0, int up = 0) {
  ConvGeom g;
  g.N = N; g.H = H; g.W = W;
  g.cin_bytes = cin_bytes;
  g.Cout = Cout;
  g.nchunks = (cin_bytes + CHUNK - 1) / CHUNK;
  g.tiles_x = (W + TW - 1) / TW;
  g.tiles_y = (H + TH - 1) / TH;
  g.ntiles_n = (Cout + BN - 1) / BN;
  g.reflect = reflect;
  g.row_shift = row_shift;
  g.up = up;
  const int stages = TPS == 1 ? 4 : 3;
  const int steps = g.nchunks * (9 / TPS);
  g.b_slots = steps < stages ? steps : stages;
  g.a_slots = TPS == 1 ? (g.nchunks < 2 ? g.nchunks : 2) : g.b_slots;
  return g;
}

inline size_t smem_bytes(const ConvGeom& g, int BN, int TPS, int ksteps = 4) {
  return static_cast<size_t>(g.a_slots) * ksteps * 2 * PLANE +
         static_cast<size_t>(g.b_slots) * TPS * BN * ksteps * 32 + 8 * MAX_STAGES;
}

// One block per (spatial tile, output-channel tile), the channel tiles of one
// spatial tile next to each other so that they share its halo in L2.
inline unsigned grid_blocks(const ConvGeom& g) {
  return static_cast<unsigned>(static_cast<long long>(g.N) * g.tiles_y * g.tiles_x * g.ntiles_n);
}

// Raise the kernel's dynamic shared memory limit, launch, and return the first error.
template <typename Kernel, typename... Args>
inline cudaError_t launch(Kernel kernel, const ConvGeom& g, size_t smem, cudaStream_t st,
                          Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid_blocks(g), THREADS, smem, st>>>(args..., g);
  return cudaGetLastError();
}

// blockIdx.x -> (image, tile corner, output-channel tile)
__device__ __forceinline__ void block_tile(const ConvGeom& g, int& n, int& y0, int& x0, int& ntile) {
  int b = blockIdx.x;
  ntile = b % g.ntiles_n; b /= g.ntiles_n;
  x0 = (b % g.tiles_x) * TW; b /= g.tiles_x;
  y0 = (b % g.tiles_y) * TH;
  n = b / g.tiles_y;
}

}  // namespace ccst_igemm
