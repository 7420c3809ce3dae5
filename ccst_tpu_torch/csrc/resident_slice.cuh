// What the fused AdaIN kernel (adain.cu) and the channel-moments kernel
// (moments.cu) share: a slice of an NHWC tensor, some rows x one 128-byte
// channel group, owned by one block and kept in shared memory while the block
// walks it more than once.
//
// Both kernels do a few float operations for every element they read, so on
// the H100 they are bound by device memory and, at the sizes the stylize path
// gives them (12-34 MB), by latency: the only gains are to read every byte
// once, in full lines, with many loads in flight, and to launch once.
//
// A row of the slice is one 128-byte line: 64 bf16 or 32 float32 channels.
// A thread owns one 16-byte unit of the line (8 bf16 / 4 float32 channels) in
// every 32nd row: thread t has unit t % 8 and rows t / 8, t / 8 + 32, ... The
// eight threads of a row read 128 neighbouring bytes of device memory and
// write 128 neighbouring bytes of shared memory, so both sides move whole
// lines without bank conflicts. The thread that copies a unit is the thread
// that sums it and the thread that writes it back, so the copy needs no
// block barrier: each thread starts all its copies as cp.async, 16 bytes
// each, in STAGES commit groups, and starts to sum the first group while the
// others are still in flight. No register holds data that is on its way.
//
// A tensor whose rows are not 16-byte aligned (C * element size not a
// multiple of 16), and the last unit of a ragged channel count (C = 500),
// take element-wise loads and stores instead, masked at C.
//
// Sums are taken in an order fixed by the shape alone: a thread's rows in
// order, the four row lanes of a warp by two shuffles, the eight warps in
// order. kernels/resident_slice.py models the same order in numpy.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_igemm_sm90.cuh"  // cp_async16, cp_async_commit, cp_async_wait, smem_u32

namespace ccst_slice {

using ccst_igemm::cp_async16;
using ccst_igemm::cp_async_commit;
using ccst_igemm::cp_async_wait;
using ccst_igemm::smem_u32;

constexpr int THREADS = 256;
constexpr int LINE = 128;               // bytes of one row of a slice
constexpr int UNITS = LINE / 16;        // 16-byte units of a row, one thread each
constexpr int LANES = THREADS / UNITS;  // rows the block sweeps at once
constexpr int WARPS = THREADS / 32;
constexpr int MAXC = LINE / 2;          // channels of a group at most (bf16)
constexpr int STAGES = 4;               // commit groups of the resident copy
// rows of the AdaIN kernel's resident slice at most: 227 KB less its 3 KB of
// static arrays (the moments kernel has more of them and its own bound)
constexpr int MAX_ROWS = 1784;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float& dst, float v) { dst = v; }
__device__ __forceinline__ void from_float(__nv_bfloat16& dst, float v) { dst = __float2bfloat16(v); }

// 16 bytes <-> the unit's values in float32
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[4], const float*) {
  f[0] = __uint_as_float(v.x); f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z); f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8], const __nv_bfloat16*) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 is the upper half of a float32
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack(const float (&f)[4], const float*) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float (&f)[8], const __nv_bfloat16*) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);  // .x is the low half
    w[i] = *reinterpret_cast<const uint32_t*>(&p);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// One thread's share of a block's slice: rows lane, lane + LANES, ... of
// `rows`, channels c0 .. c0 + VEC of a tensor with C channels.
template <typename T>
struct Slice {
  static constexpr int VEC = 16 / sizeof(T);  // channels of a unit
  static constexpr int GC = UNITS * VEC;      // channels of a group

  const T* src;      // row 0 of the block, channel c0
  long long pitch;   // elements from one row to the next: C
  int rows;          // rows of the block
  int lane;          // the thread's first row
  int nvalid;        // channels of the unit below C: 0 (idle thread) .. VEC
  bool vec;          // 16-byte accesses: rows 16-byte aligned and the unit whole
  uint8_t* col;      // the unit's column of the resident copy; a row is LINE further

  // x: row 0 of the block, channel 0 of the tensor; g: the channel group
  __device__ __forceinline__ void init(const T* x, int C, int g, int rows_, uint8_t* smem,
                                       int aligned16) {
    const int u = threadIdx.x % UNITS;
    const int c0 = g * GC + u * VEC;
    lane = threadIdx.x / UNITS;
    rows = rows_;
    pitch = C;
    nvalid = min(max(C - c0, 0), VEC);
    vec = aligned16 && nvalid == VEC;
    src = x + c0;
    col = smem + lane * LINE + u * 16;
  }

  // Values of row lane + k * LANES from device memory.
  __device__ __forceinline__ void from_global(int k, float (&f)[VEC]) const {
    const T* p = src + (static_cast<long long>(k) * LANES + lane) * pitch;
    if (vec) {
      unpack(__ldg(reinterpret_cast<const uint4*>(p)), f, static_cast<const T*>(nullptr));
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[e] = e < nvalid ? to_float(p[e]) : 0.0f;
    }
  }

  // Values of row lane + k * LANES from the resident copy.
  __device__ __forceinline__ void from_shared(int k, float (&f)[VEC]) const {
    unpack(*reinterpret_cast<const uint4*>(col + static_cast<size_t>(k) * (LANES * LINE)), f,
           static_cast<const T*>(nullptr));
  }

  template <bool RESIDENT>
  __device__ __forceinline__ void fetch(int k, float (&f)[VEC]) const {
    if (RESIDENT) from_shared(k, f); else from_global(k, f);
  }

  // The thread's sweeps: k = 0 .. sweeps() - 1 are its rows below `rows`.
  __device__ __forceinline__ int sweeps() const {
    return nvalid == 0 ? 0 : max(rows - lane + LANES - 1, 0) / LANES;
  }
  // Sweeps of one commit group of the resident copy (the same for every thread).
  __device__ __forceinline__ int stage_sweeps() const {
    const int all = (rows + LANES - 1) / LANES;
    return (all + STAGES - 1) / STAGES;
  }

  // Start the resident copy: every unit of the thread, STAGES commit groups.
  __device__ __forceinline__ void copy_in() const {
    const int n = sweeps(), per = stage_sweeps();
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      const int end = min((s + 1) * per, n);
      for (int k = s * per; k < end; ++k) {
        uint8_t* dst = col + static_cast<size_t>(k) * (LANES * LINE);
        if (vec) {
          cp_async16(smem_u32(dst), src + (static_cast<long long>(k) * LANES + lane) * pitch, true);
        } else {
          float f[VEC];
          from_global(k, f);
          T* d = reinterpret_cast<T*>(dst);
#pragma unroll
          for (int e = 0; e < VEC; ++e) from_float(d[e], f[e]);  // exact: f came from a T
        }
      }
      cp_async_commit();
    }
  }

  // Wait until commit group s of the thread's copies has landed.
  __device__ __forceinline__ void wait_stage(int s) const {
    switch (s) {
      case 0: cp_async_wait<STAGES - 1>(); break;
      case 1: cp_async_wait<STAGES - 2>(); break;
      case 2: cp_async_wait<STAGES - 3>(); break;
      default: cp_async_wait<0>(); break;
    }
  }

  // Store the unit's values of row lane + k * LANES at dst (row 0 of the
  // block, channel c0, of a tensor of the same pitch).
  __device__ __forceinline__ void store(T* dst, int k, const float (&f)[VEC]) const {
    T* p = dst + (static_cast<long long>(k) * LANES + lane) * pitch;
    if (vec) {
      *reinterpret_cast<uint4*>(p) = pack(f, static_cast<const T*>(nullptr));
    } else {
      for (int e = 0; e < nvalid; ++e) from_float(p[e], f[e]);
    }
  }
};

// The block's per-channel total of every thread's acc: the four row lanes of
// a warp as (0 + 1) + (2 + 3), then the warps in order. out[c] for the GC
// channels of the group; ends with a block barrier.
template <int VEC>
__device__ __forceinline__ void block_sum(float (&acc)[VEC], float (*scratch)[MAXC], float* out) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], 8);
    acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], 16);
  }
  if (lane < UNITS) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) scratch[warp][lane * VEC + e] = acc[e];
  }
  __syncthreads();
  if (threadIdx.x < UNITS * VEC) {
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) total += scratch[w][threadIdx.x];
    out[threadIdx.x] = total;
  }
  __syncthreads();
}

// Per-channel sum of the block's rows, summing each commit group of a
// resident copy as soon as it has landed (RESIDENT) or reading device memory.
template <bool RESIDENT, typename T>
__device__ __forceinline__ void sum_rows(const Slice<T>& sl, float (&acc)[Slice<T>::VEC]) {
  constexpr int VEC = Slice<T>::VEC;
  const int n = sl.sweeps();
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
  if (RESIDENT) {
    const int per = sl.stage_sweeps();
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      sl.wait_stage(s);
      const int end = min((s + 1) * per, n);
      for (int k = s * per; k < end; ++k) {
        float f[VEC];
        sl.from_shared(k, f);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] += f[e];
      }
    }
  } else {
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      float f[VEC];
      sl.from_global(k, f);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] += f[e];
    }
  }
}

// Per-channel sum of squared differences from mean[] over the block's rows.
template <bool RESIDENT, typename T>
__device__ __forceinline__ void sum_squares(const Slice<T>& sl, const float (&mean)[Slice<T>::VEC],
                                            float (&acc)[Slice<T>::VEC]) {
  constexpr int VEC = Slice<T>::VEC;
  const int n = sl.sweeps();
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
#pragma unroll 4
  for (int k = 0; k < n; ++k) {
    float f[VEC];
    sl.template fetch<RESIDENT>(k, f);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float d = f[e] - mean[e];
      acc[e] += d * d;
    }
  }
}

}  // namespace ccst_slice
