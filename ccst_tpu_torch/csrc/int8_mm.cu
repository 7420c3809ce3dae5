// Tiled GEMM y = x @ w on Hopper tensor cores: int8 x int8 -> int32 or
// float32 (int32 accumulation), bf16 x bf16 -> float32 (float32 accumulation).
//
// Replaces benchmarks/pallas_int8_mxu.py::pallas_mm (kernel B1), the JAX
// project's probe of whether a hand-written int8 matmul reaches the int8 rate
// of the chip: one dot_general per (tile_m, K) x (K, N) block.
//
// What bounds it on the H100: device memory, at every shape of the probe (M =
// 2^18, K = 256..2304, N = 128..512) and in all three variants. The function
// reads K * esize bytes and writes 4 N bytes a row for 2 K N operations, an
// intensity of 2 K N / (K * esize + 4 N) operations a byte: 51..205 for int8
// (ridge 1,979 TOPS / 3.35 TB/s ~ 590), 43..186 for bf16 (ridge ~ 295; H100
// SXM data sheet at 700 W). The 4-byte output is most of the traffic at small
// K (268 MB of the 336 MB at int8 256 x 256). So the design is about keeping
// the memory busy (bytes in flight, loads that overlap stores, wide stores),
// not about the tensor-core rate.
//
// Design: a persistent, warp-specialised block an SM (grid = SMs).
//   - Work items are 192 rows x 128 columns; the column tiles of one row tile
//     are neighbouring items, so the blocks that share its x rows run at the
//     same time and the second read comes from L2.
//   - One producer thread walks the block's items and stages: per 128 bytes of
//     K it asks the Tensor Memory Accelerator for the 192 x 128-byte box of x
//     (a tensor map over the row-major matrix, 128-byte swizzle; rows past M
//     and bytes past K arrive as zeros) and fetches the stage's weights with
//     one cp.async.bulk; both complete on the stage's `full` mbarrier. Why
//     the TMA and not 16-byte cp.async copies into unswizzled planes, as the
//     conv core fills its halo: timed on an H100, those copies, issued by all
//     threads, set the kernel's time, not the tensor cores or the stores (with
//     them left out it ran more than twice as fast at K = 2304); the TMA costs the SM no
//     load instructions. cuTensorMapEncodeTiled of libcuda is reached through
//     cudaGetDriverEntryPoint: still no -lcuda.
//   - Three consumer warpgroups own 64 rows each. Per stage: wait on `full`,
//     four wgmma m64n128k32 (s8) / m64n128k16 (bf16) with both operands
//     K-major from shared memory (A through a 128-byte-swizzle descriptor, B
//     through the conv core's unswizzled one), sums in registers; when the
//     stage before has left the tensor cores (wgmma.wait_group 1) each warp
//     arrives on its `empty` mbarrier, which hands the slot back to the
//     producer. No __syncthreads in the loop.
//   - B operand: packed on the host (kernels/int8_mm.py) into the bytes of a
//     stage, wp[n tile][128-byte chunk of K][group of 16 bytes: 8][n: 128][16
//     bytes], zero padded. It is ringed with A, not kept resident: the weights
//     (at most 1.2 MB) stay in L2 and one loop serves every K.
//   - Ring: five stages of 40 KB (A 24 + B 16), 200 KB of the 227 KB. The
//     producer runs ahead across work items, so while the consumers store one
//     item's sums the next items' stages are already landing: loads and
//     stores overlap.
//   - Epilogue from the registers: two lanes of a quad swap half of their
//     columns, so each lane stores 16 bytes (four consecutive int32 or float32
//     columns, a quad 64 contiguous bytes); __int2float_rn once for int8 ->
//     float32. Rows past M and columns past N are skipped.
// Integer sums are order-free and the float32 sums of the probe's integer
// valued operands are exact, so the result equals the plain version bit for bit.
#include <cuda.h>  // CUtensorMap and its enums: types only, nothing is linked

#include "conv_igemm_sm90.cuh"

namespace {

using namespace ccst_igemm;

constexpr int BM = 192;                     // rows of x per work item: 64 per consumer warpgroup
constexpr int BN = 128;                     // columns of w per work item
constexpr int BK = GROUPS * 16;             // bytes of K per stage: one swizzle span
constexpr int CONSUMERS = BM / 64;          // consumer warpgroups
// Three consumer warpgroups and the producer's make 512 threads, so each may
// hold 128 registers: a fourth consumer (640 threads, 96 registers each)
// spilled sums in the bf16 variant, and a spilled sum is read while the
// asynchronous wgmma still writes it.
constexpr int MM_THREADS = (CONSUMERS + 1) * 128;
constexpr int STAGES = 5;
constexpr int A_STAGE = BM * BK;            // the TMA box: [row][128 bytes], 16-byte pieces swizzled
constexpr int B_STAGE = BN * BK;
constexpr int SMEM_ALIGN = 1024;            // the swizzle pattern repeats every 8 rows of 128 bytes
constexpr int SMEM_BYTES = SMEM_ALIGN + STAGES * (A_STAGE + B_STAGE) + 16 * STAGES;

// A stage of A as the TMA writes it with the 128-byte swizzle: row r at r *
// 128, its 16-byte piece c at position c ^ (r % 8). The descriptor names the
// same pattern (bits 62..63 = 1), a stride of 1024 bytes between 8-row groups;
// the next 32 bytes of K are a start address 32 bytes further on.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// KIND 0: s8 -> s32; 1: s8 -> f32; 2: bf16 -> f32.
template <int KIND>
__global__ void __launch_bounds__(MM_THREADS, 1)
tiled_mm_kernel(const __grid_constant__ CUtensorMap x_map, const uint8_t* __restrict__ wp,
                uint32_t* __restrict__ y, int M, int N, int Kb, int ntiles_n, int n_items) {
  constexpr bool BF16 = KIND == 2;
  extern __shared__ uint8_t smem_raw[];
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const uint32_t sA = (smem_u32(smem_raw) + SMEM_ALIGN - 1) & ~static_cast<uint32_t>(SMEM_ALIGN - 1);
  const uint32_t sB = sA + STAGES * A_STAGE;
  const uint32_t full = sB + STAGES * B_STAGE;  // one arrival: the producer's, plus the bytes
  const uint32_t empty = full + 8 * STAGES;     // one arrival per consumer warp
  const int T = (Kb + BK - 1) / BK;             // stages of one work item

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_proxy_async();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- producer: one thread, the block's stages in order, item after item
    if (tid == CONSUMERS * 128) {
      int slot = 0, parity = 1;  // a fresh barrier passes a wait for the phase before its first
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const int mt = item / ntiles_n, nt = item - mt * ntiles_n;
        for (int chunk = 0; chunk < T; ++chunk) {
          mbar_wait(empty + 8 * slot, parity);
          mbar_expect_tx(full + 8 * slot, A_STAGE + B_STAGE);
          tma_load_2d(sA + slot * A_STAGE, &x_map, chunk * BK, mt * BM, full + 8 * slot);
          bulk_load(sB + slot * B_STAGE, wp + (static_cast<size_t>(nt) * T + chunk) * B_STAGE,
                    B_STAGE, full + 8 * slot);
          if (++slot == STAGES) {
            slot = 0;
            parity ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of every item
  typename AccType<BF16>::type acc[BN / 2];  // an item's first wgmma overwrites them

  // Register j of a thread is row 16 w + g + 8 * ((j / 2) % 2), column
  // 8 * (j / 4) + 2 t + j % 2 (conv_igemm_sm90.cuh). Lanes t and t ^ 1 swap a
  // column pair of two neighbouring 8-column groups: the even lane ends with
  // columns 4 (t / 2) .. + 3 of the first group, the odd lane with those of
  // the second.
  auto store_item = [&](int item) {
    const int mt = item / ntiles_n, nt = item - mt * ntiles_n;
    const int t = tid & 3, odd = t & 1;
    auto bits = [](auto v) -> uint32_t {
      if constexpr (KIND == 0) return static_cast<uint32_t>(v);
      else if constexpr (KIND == 1) return __float_as_uint(__int2float_rn(v));
      else return __float_as_uint(v);
    };
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = static_cast<long long>(mt) * BM + wg * 64 + 16 * ((tid >> 5) & 3) +
                          ((tid & 31) >> 2) + 8 * h;
      uint32_t* row = y + (m < M ? m : 0) * N + nt * BN;
#pragma unroll
      for (int jp = 0; jp < BN / 16; ++jp) {
        const uint32_t a0 = bits(acc[8 * jp + 2 * h]), a1 = bits(acc[8 * jp + 2 * h + 1]);
        const uint32_t b0 = bits(acc[8 * jp + 4 + 2 * h]), b1 = bits(acc[8 * jp + 4 + 2 * h + 1]);
        const uint32_t r0 = __shfl_xor_sync(0xffffffffu, odd ? a0 : b0, 1);
        const uint32_t r1 = __shfl_xor_sync(0xffffffffu, odd ? a1 : b1, 1);
        const int col = 16 * jp + 8 * odd + 4 * (t >> 1);
        if (m < M && nt * BN + col < N)
          *reinterpret_cast<uint4*>(row + col) =
              odd ? make_uint4(r0, r1, b0, b1) : make_uint4(a0, a1, r0, r1);
      }
    }
  };

  const uint64_t b_strides = desc_strides(BN * 16, 128);
  const bool releaser = (tid & 31) == 0;  // one arrival a warp
  int slot = 0, parity = 0;
  int held = -1;  // the slot whose wgmmas may still be in the tensor cores
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    for (int chunk = 0; chunk < T; ++chunk) {
      mbar_wait(full + 8 * slot, parity);
      const uint32_t a_base = sA + slot * A_STAGE + wg * 64 * BK;
      const uint32_t b_base = sB + slot * B_STAGE;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 32; ++ks)
        Wgmma<BF16, BN>::mma(acc, desc_sw128(a_base + ks * 32),
                             desc_at(b_strides, b_base + ks * 2 * BN * 16), chunk + ks);
      wgmma_commit();
      wgmma_wait<1>();  // the stage before has left the tensor cores: hand its slot back
      if (held >= 0 && releaser) mbar_arrive(empty + 8 * held);
      held = slot;
      if (++slot == STAGES) {
        slot = 0;
        parity ^= 1;
      }
    }
    wgmma_wait<0>();
    if (releaser) mbar_arrive(empty + 8 * held);
    held = -1;
    store_item(item);
  }
}

// cuTensorMapEncodeTiled of the installed libcuda, found once.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

template <int KIND>
cudaError_t launch_mm(const CUtensorMap& x_map, const void* wp, void* y, int M, int N, int Kb,
                      int ntiles_n, int n_items, int blocks, cudaStream_t st) {
  auto kernel = tiled_mm_kernel<KIND>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, MM_THREADS, SMEM_BYTES, st>>>(x_map, static_cast<const uint8_t*>(wp),
                                                 static_cast<uint32_t*>(y), M, N, Kb, ntiles_n,
                                                 n_items);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). x: (M, K) int8 (kind 0, 1) or bf16
// (kind 2), row-major, K * element size a multiple of 16 bytes; wp: the packed
// weights of kernels/int8_mm.py::pack_mm_weight, [ceil(N / 128)][ceil(K *
// element size / 128)][8][128][16 bytes]; y: (M, N) int32 (kind 0) or float32
// (kind 1, 2), N a multiple of 4. All contiguous and 16-byte aligned. Launches
// on `stream` and returns the first CUDA error (0 on success).
extern "C" int ccst_tiled_mm(const void* x, const void* wp, void* y, int M, int N, int K, int kind,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0) return 0;
  if (kind < 0 || kind > 2) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ntiles_n = (N + BN - 1) / BN;
  const long long items = static_cast<long long>((M + BM - 1) / BM) * ntiles_n;
  if (items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int n_items = static_cast<int>(items);
  const int blocks = n_items < sms ? n_items : sms;
  const int Kb = K * (kind == 2 ? 2 : 1);

  // x as a 2-D tensor of bytes, (M rows, Kb bytes); a box is one A stage
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap x_map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(Kb), static_cast<cuuint64_t>(M)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(Kb)};
  const cuuint32_t box[2] = {BK, BM};
  const cuuint32_t elem_strides[2] = {1, 1};
  if (encode(&x_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(x), dims, strides, box,
             elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);

  if (kind == 0)
    err = launch_mm<0>(x_map, wp, y, M, N, Kb, ntiles_n, n_items, blocks, st);
  else if (kind == 1)
    err = launch_mm<1>(x_map, wp, y, M, N, Kb, ntiles_n, n_items, blocks, st);
  else
    err = launch_mm<2>(x_map, wp, y, M, N, Kb, ntiles_n, n_items, blocks, st);
  return static_cast<int>(err);
}
