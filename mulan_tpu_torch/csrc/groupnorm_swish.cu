// swish(groupnorm(x)) in one pass for Hopper (sm_90a), K8, and its backward.
//
// The forward replaces the Pallas TPU kernel
// mulan_tpu/ops/groupnorm_swish.py:_kernel (launched by _fused_call for
// fused_gn_swish). Its arithmetic, which
// mulan_tpu_torch/ops/groupnorm_swish.py:gn_swish_plain repeats: float32
// statistics per (sample, group), var = E[x^2] - mean^2 with no clamp,
// r = rsqrt(var + eps), the affine with the float32 weight and bias, swish in
// float32, and one cast to x's type.
//
// The backward replaces the vjp that JAX's custom_vjp takes of the same
// formula (mulan_tpu/ops/groupnorm_swish.py:_bwd), which XLA fuses on the
// TPU. With y = xhat w + b, xhat = (x - mean) r and s = sigmoid(y):
//   g_y = dy s (1 + y (1 - s))            (dy upcast to float32)
//   dbias_c = sum_{n,hw} g_y,  dweight_c = sum_{n,hw} g_y xhat
//   dx = r (w g_y - mean_grp(w g_y) - xhat mean_grp(w g_y xhat)),
// mean_grp over the (sample, group) run; gn_swish_bwd_plain is the same
// closed form in PyTorch.
//
// The TPU kernel holds a whole sample (H, W, C) in VMEM and reduces channels
// to groups with a matrix product against a 0/1 assignment matrix, because
// a channels-last tile puts a group's channels across lanes. Here x is NCHW,
// so a group's C/G channels are one contiguous run of C/G * H * W elements
// (4,096 at C = 128 and 8,192 at C = 256 with 32 groups at 32 x 32), and one
// block of 256 threads owns one (sample, group): 128 x 32 = 4,096 blocks at
// the flagship. Each thread loads its share of the run once, as 16-byte
// vectors that it keeps in registers (NV of them: 2 at C = 128 bf16, 4 at
// C = 256); sums run in float32 per thread, then over a fixed-order
// warp-shuffle tree and the warps in order, so results are deterministic
// and need no atomics.
//
// What bounds both on the H100: memory. The forward reads x and writes the
// output (2 x 33.5 MB at (128, 128, 32, 32) bf16, 0.020 ms at 3.35 TB/s);
// the backward reads x and dy and writes dx (0.030 ms). Against that each
// element costs one FMA for the folded normalize-and-affine (a_c = r w_c,
// b'_c = b_c - mean a_c per channel), one exp2 and one reciprocal on the
// special-function units (ex2.approx and rcp.approx, a few float32 ulps) and
// a few FMAs; a thread steps from channel to channel without dividing.
//
// The backward writes per-(sample, channel) partial sums of g_y and
// g_y xhat to a (2, B, C) float32 buffer; a second small kernel sums them
// over B in order (no float atomics, the same bits every run). It recomputes
// the statistics from the x run it loads anyway, so the forward stores
// nothing for it, with remat or without.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// The most vectors a thread holds; the wrappers refuse longer runs.
constexpr int kMaxVecs = 16;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float fast_rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// sigmoid(y) = 1 / (1 + 2^(-y log2 e)): +inf for y below -88 gives 0.
__device__ __forceinline__ float sigmoid(float y) {
  return fast_rcp(1.0f + fast_exp2(-kLog2e * y));
}

// d swish(y) / dy times dy: dy s (1 + y (1 - s)), s = sigmoid(y).
__device__ __forceinline__ float swish_grad(float y, float dy) {
  const float s = sigmoid(y);
  return dy * s * fmaf(y, 1.0f - s, 1.0f);
}

// N elements of T as one register value: a 16-byte vector (N = 16 /
// sizeof(T)) or, where H x W is no multiple of that, one element (N = 1).
template <typename T, int N> struct Pack;

template <> struct Pack<float, 4> {
  using Raw = uint4;
  __device__ static Raw load(const float* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  __device__ static void store(float* p, Raw v) {
    *reinterpret_cast<uint4*>(p) = v;
  }
  __device__ static void unpack(Raw v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ static Raw pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <> struct Pack<__nv_bfloat16, 8> {
  using Raw = uint4;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  __device__ static void store(__nv_bfloat16* p, Raw v) {
    *reinterpret_cast<uint4*>(p) = v;
  }
  // Element 2k is the low half of word k; a bf16 is the top half of a float.
  __device__ static void unpack(Raw v, float* f) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  __device__ static Raw pack(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
      w[k] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <> struct Pack<float, 1> {
  using Raw = float;
  __device__ static Raw load(const float* p) { return *p; }
  __device__ static void store(float* p, Raw v) { *p = v; }
  __device__ static void unpack(Raw v, float* f) { f[0] = v; }
  __device__ static Raw pack(const float* f) { return f[0]; }
};

template <> struct Pack<__nv_bfloat16, 1> {
  using Raw = __nv_bfloat16;
  __device__ static Raw load(const __nv_bfloat16* p) { return *p; }
  __device__ static void store(__nv_bfloat16* p, Raw v) { *p = v; }
  __device__ static void unpack(Raw v, float* f) { f[0] = __bfloat162float(v); }
  __device__ static Raw pack(const float* f) { return __float2bfloat16(f[0]); }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

// The block's sums of a and b, in the same order on every thread: each
// warp's fixed-order shuffle tree, then the warps in order. `scratch` holds
// 2 * kWarps floats; the call ends with a barrier before it is reused.
__device__ __forceinline__ void block_sum2(float& a, float& b,
                                           float* scratch) {
  a = warp_sum(a);
  b = warp_sum(b);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    scratch[warp] = a;
    scratch[kWarps + warp] = b;
  }
  __syncthreads();
  a = 0.0f;
  b = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    a += scratch[w];
    b += scratch[kWarps + w];
  }
  __syncthreads();
}

// Where a thread's vectors lie: vector threadIdx.x + k * kThreads of the
// run, in channel `channel` (of the group), at vector `offset` within it.
// Stepping k adds kThreads vectors, i.e. `step_ch` channels and `step_off`
// vectors, without a division.
struct ChannelWalk {
  int channel, offset, step_ch, step_off, per_channel;
  __device__ ChannelWalk(int per_channel_vecs)
      : channel(threadIdx.x / per_channel_vecs),
        offset(threadIdx.x % per_channel_vecs),
        step_ch(kThreads / per_channel_vecs),
        step_off(kThreads % per_channel_vecs),
        per_channel(per_channel_vecs) {}
  __device__ __forceinline__ void next() {
    channel += step_ch;
    offset += step_off;
    if (offset >= per_channel) {
      offset -= per_channel;
      ++channel;
    }
  }
};

// One block per (sample, group): blockIdx.x = sample * groups + group. The
// run of `len` = C/G * hw elements starts at blockIdx.x * len; N divides hw,
// so that a vector lies within one channel; len / N <= NV * kThreads.
template <typename T, int N, int NV>
__global__ void __launch_bounds__(kThreads)
gn_swish(const T* __restrict__ x, const float* __restrict__ weight,
         const float* __restrict__ bias, T* __restrict__ out, int groups,
         int channels_per_group, int hw, float eps) {
  using P = Pack<T, N>;
  __shared__ float scratch[2 * kWarps];
  const int len = channels_per_group * hw;
  const int nvec = len / N;
  const size_t base = (size_t)blockIdx.x * len;
  const int first_channel = (blockIdx.x % groups) * channels_per_group;

  typename P::Raw raw[NV];
  float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < nvec) {
      raw[k] = P::load(x + base + (size_t)i * N);
      float f[N];
      P::unpack(raw[k], f);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        s1 += f[e];
        s2 = fmaf(f[e], f[e], s2);
      }
    }
  }
  block_sum2(s1, s2, scratch);
  const float mean = s1 / (float)len;
  const float var = s2 / (float)len - mean * mean;
  const float rstd = rsqrtf(var + eps);

  ChannelWalk at(hw / N);
#pragma unroll
  for (int k = 0; k < NV; ++k, at.next()) {
    const int i = threadIdx.x + k * kThreads;
    if (i < nvec) {
      const int c = first_channel + at.channel;
      const float a = rstd * __ldg(weight + c);
      const float b = fmaf(-mean, a, __ldg(bias + c));
      float f[N];
      P::unpack(raw[k], f);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float y = fmaf(f[e], a, b);
        f[e] = y * sigmoid(y);
      }
      P::store(out + base + (size_t)i * N, P::pack(f));
    }
  }
}

// The backward's main kernel, one block per (sample, group) as above. It
// writes dx, and partial[n * C + c] = sum over hw of g_y and
// partial[(B + n) * C + c] = sum of g_y xhat. Dynamic shared memory: two
// floats per vector, then two per channel of the group. It keeps x and dy
// as loaded and computes g_y again for dx rather than hold it in float32:
// at C = 256 (NV = 4) that halves the registers a thread holds, and the
// special-function units have time to spare.
template <typename T, int N, int NV>
__global__ void __launch_bounds__(kThreads)
gn_swish_bwd(const T* __restrict__ x, const T* __restrict__ dy,
             const float* __restrict__ weight, const float* __restrict__ bias,
             T* __restrict__ dx, float* __restrict__ partial, int batch,
             int channels, int groups, int channels_per_group, int hw,
             float eps) {
  using P = Pack<T, N>;
  extern __shared__ float smem[];
  __shared__ float scratch[2 * kWarps];
  const int len = channels_per_group * hw;
  const int nvec = len / N;
  const int per_channel = hw / N;
  float* vec_g = smem;              // [nvec]
  float* vec_gx = smem + nvec;      // [nvec]
  float* chan = smem + 2 * nvec;    // [2][channels_per_group]
  const size_t base = (size_t)blockIdx.x * len;
  const int sample = blockIdx.x / groups;
  const int first_channel = (blockIdx.x % groups) * channels_per_group;

  // x and dy in flight together; the statistics from x as in the forward.
  typename P::Raw xr[NV], dyr[NV];
  float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < nvec) {
      xr[k] = P::load(x + base + (size_t)i * N);
      dyr[k] = P::load(dy + base + (size_t)i * N);
      float f[N];
      P::unpack(xr[k], f);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        s1 += f[e];
        s2 = fmaf(f[e], f[e], s2);
      }
    }
  }
  block_sum2(s1, s2, scratch);
  const float mean = s1 / (float)len;
  const float var = s2 / (float)len - mean * mean;
  const float rstd = rsqrtf(var + eps);
  const float shift = -mean * rstd;  // xhat = x rstd + shift

  // Each vector's sums of g_y and g_y xhat to smem.
  ChannelWalk at(per_channel);
#pragma unroll
  for (int k = 0; k < NV; ++k, at.next()) {
    const int i = threadIdx.x + k * kThreads;
    if (i < nvec) {
      const int c = first_channel + at.channel;
      const float w = __ldg(weight + c), b = __ldg(bias + c);
      float xf[N], df[N];
      P::unpack(xr[k], xf);
      P::unpack(dyr[k], df);
      float sg = 0.0f, sgx = 0.0f;
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float xhat = fmaf(xf[e], rstd, shift);
        const float g = swish_grad(fmaf(xhat, w, b), df[e]);
        sg += g;
        sgx = fmaf(g, xhat, sgx);
      }
      vec_g[i] = sg;
      vec_gx[i] = sgx;
    }
  }
  __syncthreads();

  // Per channel of the group, one warp sums its vectors in a fixed order.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int ch = warp; ch < channels_per_group; ch += kWarps) {
    float sg = 0.0f, sgx = 0.0f;
    for (int j = lane; j < per_channel; j += 32) {
      sg += vec_g[ch * per_channel + j];
      sgx += vec_gx[ch * per_channel + j];
    }
    sg = warp_sum(sg);
    sgx = warp_sum(sgx);
    if (lane == 0) {
      const int c = first_channel + ch;
      partial[(size_t)sample * channels + c] = sg;
      partial[((size_t)batch + sample) * channels + c] = sgx;
      chan[ch] = sg;
      chan[channels_per_group + ch] = sgx;
    }
  }
  __syncthreads();

  // mean_grp(w g_y) and mean_grp(w g_y xhat), from the channel sums.
  float sum_wg = 0.0f, sum_wgx = 0.0f;
  for (int ch = 0; ch < channels_per_group; ++ch) {
    const float w = __ldg(weight + first_channel + ch);
    sum_wg = fmaf(w, chan[ch], sum_wg);
    sum_wgx = fmaf(w, chan[channels_per_group + ch], sum_wgx);
  }
  const float mean_wg = sum_wg / (float)len;
  const float mean_wgx = sum_wgx / (float)len;

  at = ChannelWalk(per_channel);
#pragma unroll
  for (int k = 0; k < NV; ++k, at.next()) {
    const int i = threadIdx.x + k * kThreads;
    if (i < nvec) {
      const int c = first_channel + at.channel;
      const float w = __ldg(weight + c), b = __ldg(bias + c);
      float xf[N], df[N];
      P::unpack(xr[k], xf);
      P::unpack(dyr[k], df);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float xhat = fmaf(xf[e], rstd, shift);
        const float wg = w * swish_grad(fmaf(xhat, w, b), df[e]);
        xf[e] = rstd * (wg - mean_wg - xhat * mean_wgx);
      }
      P::store(dx + base + (size_t)i * N, P::pack(xf));
    }
  }
}

// dbias[c] = sum_n partial[n * C + c], dweight[c] = sum_n partial[(B + n) *
// C + c], n in order.
__global__ void gn_swish_bwd_finish(const float* __restrict__ partial,
                                    float* __restrict__ dweight,
                                    float* __restrict__ dbias, int batch,
                                    int channels) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= channels) return;
  float db = 0.0f, dw = 0.0f;
#pragma unroll 8
  for (int n = 0; n < batch; ++n) {
    db += partial[(size_t)n * channels + c];
    dw += partial[((size_t)batch + n) * channels + c];
  }
  dbias[c] = db;
  dweight[c] = dw;
}

// The launch shape of a run: N elements a vector (16 bytes where hw allows,
// else 1) and NV vectors a thread (a power of two; the scalar path always
// takes kMaxVecs). Returns false for a run longer than kMaxVecs vectors a
// thread.
template <typename T>
bool run_shape(int len, int hw, const void* a, const void* b, const void* c,
               bool* vec, int* nv) {
  constexpr int kVec = 16 / sizeof(T);
  *vec = hw % kVec == 0 && (uintptr_t)a % 16 == 0 && (uintptr_t)b % 16 == 0 &&
         (uintptr_t)c % 16 == 0;
  const int nvec = *vec ? len / kVec : len;
  if (nvec > kMaxVecs * kThreads) return false;
  *nv = kMaxVecs;
  if (*vec)
    for (int n = 1; n < kMaxVecs; n *= 2)
      if (nvec <= n * kThreads) {
        *nv = n;
        break;
      }
  return true;
}

template <typename T, int N, int NV>
int launch_fwd(const void* x, const float* weight, const float* bias,
               void* out, int blocks, int groups, int per_group, int hw,
               float eps, cudaStream_t stream) {
  gn_swish<T, N, NV><<<blocks, kThreads, 0, stream>>>(
      (const T*)x, weight, bias, (T*)out, groups, per_group, hw, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd(const void* x, const float* weight, const float* bias, void* out,
        int batch, int channels, int hw, int groups, float eps,
        cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int per_group = channels / groups;
  bool vec;
  int nv;
  if (!run_shape<T>(per_group * hw, hw, x, out, x, &vec, &nv))
    return (int)cudaErrorInvalidValue;
  const int blocks = batch * groups;
  if (!vec)
    return launch_fwd<T, 1, kMaxVecs>(x, weight, bias, out, blocks, groups,
                                      per_group, hw, eps, stream);
  switch (nv) {
    case 1: return launch_fwd<T, kVec, 1>(x, weight, bias, out, blocks,
                                          groups, per_group, hw, eps, stream);
    case 2: return launch_fwd<T, kVec, 2>(x, weight, bias, out, blocks,
                                          groups, per_group, hw, eps, stream);
    case 4: return launch_fwd<T, kVec, 4>(x, weight, bias, out, blocks,
                                          groups, per_group, hw, eps, stream);
    case 8: return launch_fwd<T, kVec, 8>(x, weight, bias, out, blocks,
                                          groups, per_group, hw, eps, stream);
    default: return launch_fwd<T, kVec, 16>(x, weight, bias, out, blocks,
                                            groups, per_group, hw, eps,
                                            stream);
  }
}

struct BwdArgs {
  const void *x, *dy;
  const float *weight, *bias;
  void* dx;
  float *partial, *dweight, *dbias;
  int batch, channels, hw, groups;
  float eps;
  cudaStream_t stream;
};

template <typename T, int N, int NV>
int launch_bwd(const BwdArgs& a) {
  const int per_group = a.channels / a.groups;
  const size_t smem =
      (2 * (size_t)per_group * a.hw / N + 2 * (size_t)per_group) *
      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gn_swish_bwd<T, N, NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  gn_swish_bwd<T, N, NV><<<a.batch * a.groups, kThreads, smem, a.stream>>>(
      (const T*)a.x, (const T*)a.dy, a.weight, a.bias, (T*)a.dx, a.partial,
      a.batch, a.channels, a.groups, per_group, a.hw, a.eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_swish_bwd_finish<<<(a.channels + 127) / 128, 128, 0, a.stream>>>(
      a.partial, a.dweight, a.dbias, a.batch, a.channels);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd(const BwdArgs& a) {
  constexpr int kVec = 16 / sizeof(T);
  bool vec;
  int nv;
  if (!run_shape<T>(a.channels / a.groups * a.hw, a.hw, a.x, a.dy, a.dx,
                    &vec, &nv))
    return (int)cudaErrorInvalidValue;
  if (!vec) return launch_bwd<T, 1, kMaxVecs>(a);
  switch (nv) {
    case 1: return launch_bwd<T, kVec, 1>(a);
    case 2: return launch_bwd<T, kVec, 2>(a);
    case 4: return launch_bwd<T, kVec, 4>(a);
    case 8: return launch_bwd<T, kVec, 8>(a);
    default: return launch_bwd<T, kVec, 16>(a);
  }
}

bool bad_shape(int batch, int channels, int hw, int groups) {
  return batch <= 0 || channels <= 0 || hw <= 0 || groups <= 0 ||
         channels % groups != 0 || (long long)batch * groups > 0x7fffffffLL;
}

}  // namespace

// x, out: (batch, channels, hw) contiguous, float32 or bfloat16; weight,
// bias: (channels,) float32. channels % groups == 0, and a group's run of
// channels / groups * hw elements at most 16 * 256 vectors of 16 bytes (or
// elements, where hw is no multiple of a vector).
extern "C" int mulan_gn_swish(const void* x, const void* weight,
                              const void* bias, void* out, int batch,
                              int channels, int hw, int groups, float eps,
                              int is_bf16, void* stream) {
  if (bad_shape(batch, channels, hw, groups))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* w = (const float*)weight;
  const float* b = (const float*)bias;
  return is_bf16 ? fwd<__nv_bfloat16>(x, w, b, out, batch, channels, hw,
                                      groups, eps, s)
                 : fwd<float>(x, w, b, out, batch, channels, hw, groups, eps,
                              s);
}

// x, dy, dx: (batch, channels, hw) as above; weight, bias, dweight, dbias:
// (channels,) float32; partial: (2, batch, channels) float32 scratch.
extern "C" int mulan_gn_swish_bwd(const void* x, const void* dy,
                                  const void* weight, const void* bias,
                                  void* dx, void* partial, void* dweight,
                                  void* dbias, int batch, int channels,
                                  int hw, int groups, float eps, int is_bf16,
                                  void* stream) {
  if (bad_shape(batch, channels, hw, groups))
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{x, dy, (const float*)weight, (const float*)bias, dx,
                  (float*)partial, (float*)dweight, (float*)dbias, batch,
                  channels, hw, groups, eps, (cudaStream_t)stream};
  return is_bf16 ? bwd<__nv_bfloat16>(a) : bwd<float>(a);
}
