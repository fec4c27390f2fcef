// swish(groupnorm(x)) in one pass for Hopper (sm_90a), K8.
//
// Replaces the Pallas TPU kernel mulan_tpu/ops/groupnorm_swish.py:_kernel
// (launched by _fused_call for fused_gn_swish). Its arithmetic, which
// mulan_tpu_torch/ops/groupnorm_swish.py:gn_swish_plain repeats: float32
// statistics per (sample, group), var = E[x^2] - mean^2 with no clamp,
// rsqrt(var + eps), the affine with the float32 weight and bias, swish in
// float32, and one cast to x's type.
//
// The TPU kernel holds a whole sample (H, W, C) in VMEM and reduces channels
// to groups with a matrix product against a 0/1 assignment matrix, because
// a channels-last tile puts a group's channels across lanes. Here x is NCHW,
// so a group's C/G channels are one contiguous run of C/G * H * W elements
// (4,096 at C = 128 and 8,192 at C = 256 with 32 groups at 32 x 32), and one
// thread block owns one (sample, group): 128 x 32 = 4,096 blocks at the
// flagship, enough to fill the 132 SMs without any reduction across blocks.
// The block reads its run once with 16-byte loads, keeps it in shared
// memory (16 KB of bf16 at most there), sums x and x^2 in float32 per
// thread, then over a fixed-order warp-shuffle tree and the warps in order,
// so the result is deterministic and needs no atomics, and finally applies
// normalize, affine and swish from shared memory and writes the run once.
//
// What bounds it on the H100: memory. One read and one write of x, e.g.
// 2 x 33.5 MB at (128, 128, 32, 32) bf16, ~0.020 ms at 3.35 TB/s; the
// ~10 float32 operations and one exp an element are far below the
// compute rates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

__device__ __forceinline__ float swish_affine(float x, float mean, float rstd,
                                              float w, float b) {
  const float y = (x - mean) * rstd * w + b;
  return y / (1.0f + expf(-y));
}

// One block per (sample, group): blockIdx.x = sample * groups + group. The
// run of `len` = C/G * hw elements starts at blockIdx.x * len. With `vec`,
// the run is read and written as 16-byte vectors of kVec elements, and hw is
// a multiple of kVec, so that a vector lies within one channel.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_swish(const T* __restrict__ x, const float* __restrict__ weight,
         const float* __restrict__ bias, T* __restrict__ out, int groups,
         int channels_per_group, int hw, float eps, int vec) {
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  T* run = reinterpret_cast<T*>(smem);
  __shared__ float partial[2][kWarps];

  const int len = channels_per_group * hw;
  const size_t base = (size_t)blockIdx.x * len;
  const int first_channel = (blockIdx.x % groups) * channels_per_group;
  const T* src = x + base;
  T* dst = out + base;

  float s1 = 0.0f, s2 = 0.0f;
  if (vec) {
    const uint4* src4 = reinterpret_cast<const uint4*>(src);
    uint4* run4 = reinterpret_cast<uint4*>(run);
    for (int i = threadIdx.x; i < len / kVec; i += kThreads) {
      const uint4 v = src4[i];
      run4[i] = v;
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const float f = to_f32(e[k]);
        s1 += f;
        s2 += f * f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < len; i += kThreads) {
      const T v = src[i];
      run[i] = v;
      const float f = to_f32(v);
      s1 += f;
      s2 += f * f;
    }
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    partial[0][warp] = s1;
    partial[1][warp] = s2;
  }
  __syncthreads();
  float t1 = 0.0f, t2 = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    t1 += partial[0][w];
    t2 += partial[1][w];
  }
  const float mean = t1 / (float)len;
  const float var = t2 / (float)len - mean * mean;
  const float rstd = rsqrtf(var + eps);

  // Each thread reads back only the elements it staged itself.
  if (vec) {
    const uint4* run4 = reinterpret_cast<const uint4*>(run);
    uint4* dst4 = reinterpret_cast<uint4*>(dst);
    for (int i = threadIdx.x; i < len / kVec; i += kThreads) {
      const int c = first_channel + i * kVec / hw;
      const float w = __ldg(weight + c), b = __ldg(bias + c);
      uint4 v = run4[i];
      T* e = reinterpret_cast<T*>(&v);
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        e[k] = from_f32<T>(swish_affine(to_f32(e[k]), mean, rstd, w, b));
      dst4[i] = v;
    }
  } else {
    for (int i = threadIdx.x; i < len; i += kThreads) {
      const int c = first_channel + i / hw;
      dst[i] = from_f32<T>(swish_affine(to_f32(run[i]), mean, rstd,
                                        __ldg(weight + c), __ldg(bias + c)));
    }
  }
}

template <typename T>
int launch(const void* x, const float* weight, const float* bias, void* out,
           int batch, int channels, int hw, int groups, float eps,
           cudaStream_t stream) {
  const int per_group = channels / groups;
  const size_t len = (size_t)per_group * hw;
  const size_t smem = len * sizeof(T);
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = hw % kVec == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gn_swish<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  gn_swish<T><<<(unsigned)((size_t)batch * groups), kThreads, smem, stream>>>(
      (const T*)x, weight, bias, (T*)out, groups, per_group, hw, eps,
      (int)vec);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: (batch, channels, hw) contiguous, float32 or bfloat16; weight,
// bias: (channels,) float32. channels % groups == 0.
extern "C" int mulan_gn_swish(const void* x, const void* weight,
                              const void* bias, void* out, int batch,
                              int channels, int hw, int groups, float eps,
                              int is_bf16, void* stream) {
  if (batch <= 0 || channels <= 0 || hw <= 0 || groups <= 0 ||
      channels % groups != 0 || (long long)batch * groups > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* w = (const float*)weight;
  const float* b = (const float*)bias;
  return is_bf16 ? launch<__nv_bfloat16>(x, w, b, out, batch, channels, hw,
                                         groups, eps, s)
                 : launch<float>(x, w, b, out, batch, channels, hw, groups,
                                 eps, s);
}
