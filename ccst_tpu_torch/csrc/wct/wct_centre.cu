// WCT's centring pass: the content features of a batch less their per-image
// channel means, as the operands of the transform's two products.
//
// Replaces no TPU kernel: the JAX package has no WCT. It was added because the
// centring and its casts, written as PyTorch operations, made ~85 ms of a 344
// ms call at 512 px (six elementwise passes over every feature map, with
// float32 copies between them).
//
// x (B, P, C) in the compute dtype, mean (B, C) float32. Out:
//   hi (B, P, ld), ld = C + 8: hi[:, :, :C] = d rounded to the compute dtype,
//      d = x - mean in float32; columns C and C + 1 hold 1 and the other six
//      0, so that one product [hi | 1 1 0..] @ [T^T; m_hi; m_lo; 0..] applies
//      T and adds a float32 mean (split over two rows) in its float32 sums,
//      rounding once;
//   lo (B, P, C), bfloat16 only: d - hi rounded to bfloat16, so that
//      hi^T hi + hi^T lo + lo^T hi is the Gram of d to ~2^-16 of each entry
//      (a bfloat16 Gram of hi alone is indefinite after +I at VGG's scale).
//
// What bounds it on the H100: device memory. Per position it reads 2 C bytes
// and writes 2 (C + 8) + 2 C (bfloat16): at every level of a 512 px image
// P C = 2^24, so a batch of 32 moves 3.3 GB at relu5_1 .. relu1_1 alike
// (relu5_1: 1.7 GB), ~1.0 ms at 3.35 TB/s.
//
// Design: one thread a 16-byte group of 8 channels of one position (C % 8 ==
// 0), a grid-stride loop, 16-byte loads and stores; the means are read
// through the L1 cache (B C floats, reused by every position of an image);
// the thread of group 0 also writes its row's 8 pad columns.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int VEC = 8;  // channels a thread

struct alignas(16) Bf8 {
  __nv_bfloat162 v[4];
};

__global__ void wct_centre_split_bf16(const __nv_bfloat16* __restrict__ x,
                                      const float* __restrict__ mean,
                                      __nv_bfloat16* __restrict__ hi,
                                      __nv_bfloat16* __restrict__ lo, long long P, int C,
                                      long long groups) {
  const int cg_per_row = C / VEC;
  const int ld = C + VEC;
  for (long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x; g < groups;
       g += (long long)gridDim.x * blockDim.x) {
    const long long row = g / cg_per_row;       // b * P + p
    const int c0 = (int)(g - row * cg_per_row) * VEC;
    const long long b = row / P;
    const Bf8 in = *reinterpret_cast<const Bf8*>(x + row * C + c0);
    const float4 m0 = __ldg(reinterpret_cast<const float4*>(mean + b * C + c0));
    const float4 m1 = __ldg(reinterpret_cast<const float4*>(mean + b * C + c0 + 4));
    const float m[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
    Bf8 h, l;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 v = __bfloat1622float2(in.v[k]);
      const float d0 = v.x - m[2 * k], d1 = v.y - m[2 * k + 1];
      const __nv_bfloat162 hk = __floats2bfloat162_rn(d0, d1);
      const float2 hf = __bfloat1622float2(hk);
      h.v[k] = hk;
      l.v[k] = __floats2bfloat162_rn(d0 - hf.x, d1 - hf.y);
    }
    *reinterpret_cast<Bf8*>(hi + row * ld + c0) = h;
    *reinterpret_cast<Bf8*>(lo + row * C + c0) = l;
    if (c0 == 0) {
      Bf8 pad;
      pad.v[0] = __floats2bfloat162_rn(1.f, 1.f);
      pad.v[1] = pad.v[2] = pad.v[3] = __floats2bfloat162_rn(0.f, 0.f);
      *reinterpret_cast<Bf8*>(hi + row * ld + C) = pad;
    }
  }
}

__global__ void wct_centre_split_f32(const float* __restrict__ x, const float* __restrict__ mean,
                                     float* __restrict__ hi, long long P, int C,
                                     long long groups) {
  const int cg_per_row = C / VEC;
  const int ld = C + VEC;
  for (long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x; g < groups;
       g += (long long)gridDim.x * blockDim.x) {
    const long long row = g / cg_per_row;
    const int c0 = (int)(g - row * cg_per_row) * VEC;
    const long long b = row / P;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 v = *reinterpret_cast<const float4*>(x + row * C + c0 + 4 * h);
      const float4 m = __ldg(reinterpret_cast<const float4*>(mean + b * C + c0 + 4 * h));
      *reinterpret_cast<float4*>(hi + row * ld + c0 + 4 * h) =
          make_float4(v.x - m.x, v.y - m.y, v.z - m.z, v.w - m.w);
    }
    if (c0 == 0) {
      *reinterpret_cast<float4*>(hi + row * ld + C) = make_float4(1.f, 1.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(hi + row * ld + C + 4) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

}  // namespace

// x (B, P, C), mean (B, C) float32, hi (B, P, C + 8), lo (B, P, C) (bfloat16
// only; ignored for float32). Every pointer 16-byte aligned, C % 8 == 0.
extern "C" int ccst_wct_centre_split(const void* x, const void* mean, void* hi, void* lo,
                                     long long B, long long P, int C, int is_f32,
                                     void* stream) {
  if (B <= 0 || P <= 0 || C <= 0 || C % VEC) return static_cast<int>(cudaErrorInvalidValue);
  const long long groups = B * P * (C / VEC);
  const int threads = 256;
  const long long want = (groups + threads - 1) / threads;
  const int blocks = (int)(want < 132LL * 16 ? want : 132LL * 16);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f32) {
    wct_centre_split_f32<<<blocks, threads, 0, st>>>(static_cast<const float*>(x),
                                                     static_cast<const float*>(mean),
                                                     static_cast<float*>(hi), P, C, groups);
  } else {
    wct_centre_split_bf16<<<blocks, threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(mean),
        static_cast<__nv_bfloat16*>(hi), static_cast<__nv_bfloat16*>(lo), P, C, groups);
  }
  return static_cast<int>(cudaGetLastError());
}
