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
// The backward (gn_swish_bwd) is one persistent launch. As many blocks as
// fit on the SMs at once each serve one group and a share of the samples,
// a thread for every two vectors of a run (up to 1,024 threads, C/G = 16
// bf16 channels of 32 x 32). Each run of x and of dy (one contiguous span
// each in NCHW) comes into a two-stage shared-memory ring by 1-D bulk
// copies (cp.async.bulk, completing on an mbarrier) while the block works
// on the run before it, so the memory pipe does not wait for a block's
// barriers and the grid has no wave tail. It takes the statistics the
// forward wrote, (mean, rstd) per (sample, group) in a (B, G, 2) float32
// buffer, instead of reducing x for them first. It computes g_y once
// and holds w g_y in registers for dx. A run costs two barriers (the group
// means, the stage's release): a thread keeps its vectors' sums of g_y and
// g_y xhat over its runs in registers, and only at the end does a block
// reduce them per channel into its row of a (2, B, C) float32 buffer and
// arrive at its group's counter; the group's last block sums the group's
// rows in a fixed order into dweight and dbias and sets the counter back to
// 0. The same bits on every run on a card, no float atomics, no second
// launch.
//
// A run that is no multiple of 16 bytes a channel (H x W not a multiple of
// a vector), whose tensors are not 16-byte aligned, or that is longer than
// 2,048 vectors takes gn_swish_bwd_regs: one block per (sample,
// group), the run held in registers as the forward holds it, g_y computed
// again for dx, with the same statistics and the same arrival counters.
// Its blocks arrive once a run, as the ring's do once a block. The wrapper
// chooses between the two by shape (ops/groupnorm_swish.py:bwd_design).
//
// Every kernel has a second arithmetic (the template flag Unfused), for the
// GroupNorm -> swish sites that the model computes as
// F.silu(F.group_norm(x, G, w.to(x.dtype), b.to(x.dtype), eps)). It gives
// the bits PyTorch's CUDA kernels give there: PyTorch reduces each (sample,
// group) by Welford in float32 (here: the mean, then the squares about it,
// from the registers) and stores the mean and rsqrt(var + eps) in x's type,
// eps cast to x's type too; it folds the affine per channel into a = rstd w
// and b' = b - mean a in float32 from the parameters and statistics in x's
// type (ComputeFusedParamsCUDAKernel), writes y = a x + b' in x's type, and
// silu computes y / (1 + expf(-y)) in float32 and rounds once more. So the
// forward reads the float32 parameters rounded to x's type, writes the
// rounded statistics for the backward, and applies swish by IEEE division
// and the accurate expf to the rounded y. The backward recomputes that
// rounded y for g_y and keeps g_y and every sum in float32, where autograd
// rounds g_y to x's type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// The most vectors a thread holds; the wrappers refuse longer runs.
constexpr int kMaxVecs = 16;
// The backward's ring: stages of (x run, dy run), and the vectors a thread
// takes of a run (its blocks have up to 1024 threads: runs of up to 2048
// vectors, two stages of which, 128 KB, fit in an SM's shared memory).
constexpr int kStages = 2;
constexpr int kRingVecs = 2;
constexpr int kRingThreads = 1024;
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

// v rounded to T (to nearest even), as a float.
template <typename T> __device__ __forceinline__ float round_to(float v);

template <> __device__ __forceinline__ float round_to<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// A channel's weight or bias as the arithmetic reads it: float32, or
// (Unfused) rounded to T, as w.to(x.dtype) rounds it.
template <typename T, bool Unfused>
__device__ __forceinline__ float param(const float* p, int c) {
  const float v = __ldg(p + c);
  return Unfused ? round_to<T>(v) : v;
}

// The unfused path's swish of a GroupNorm output y: F.silu of y in T.
template <typename T>
__device__ __forceinline__ float unfused_swish(float y) {
  const float r = round_to<T>(y);
  return r / (1.0f + expf(-r));
}

// The input of swish at an element x of a channel (xhat = x rstd + shift).
// Fused: xhat w + b. Unfused: the GroupNorm output PyTorch writes, x a + b'
// with a = rstd w and b' = b - mean a, rounded to T, as the forward
// computes it.
template <typename T, bool Unfused>
struct PreSwish {
  float w, b, a, b_folded;
  __device__ PreSwish(float w_, float b_, float mean, float rstd)
      : w(w_), b(b_), a(rstd * w_), b_folded(fmaf(-mean, rstd * w_, b_)) {}
  __device__ __forceinline__ float operator()(float x, float xhat) const {
    if constexpr (Unfused) return round_to<T>(fmaf(x, a, b_folded));
    return fmaf(xhat, w, b);
  }
};

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
template <typename T, int N, int NV, bool Unfused>
__global__ void __launch_bounds__(kThreads)
gn_swish(const T* __restrict__ x, const float* __restrict__ weight,
         const float* __restrict__ bias, T* __restrict__ out,
         float* __restrict__ stats, int groups, int channels_per_group,
         int hw, float eps) {
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
  float mean = s1 / (float)len, rstd;
  if constexpr (Unfused) {
    // Welford's precision: the squares about the mean, from the registers.
    float c2 = 0.0f, unused = 0.0f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if (threadIdx.x + k * kThreads < nvec) {
        float f[N];
        P::unpack(raw[k], f);
#pragma unroll
        for (int e = 0; e < N; ++e) {
          const float d = f[e] - mean;
          c2 = fmaf(d, d, c2);
        }
      }
    }
    block_sum2(c2, unused, scratch);
    rstd = round_to<T>(rsqrtf(c2 / (float)len + round_to<T>(eps)));
    mean = round_to<T>(mean);
  } else {
    const float var = s2 / (float)len - mean * mean;
    rstd = rsqrtf(var + eps);
  }
  if (stats != nullptr && threadIdx.x == 0) {
    stats[2 * blockIdx.x] = mean;
    stats[2 * blockIdx.x + 1] = rstd;
  }

  ChannelWalk at(hw / N);
#pragma unroll
  for (int k = 0; k < NV; ++k, at.next()) {
    const int i = threadIdx.x + k * kThreads;
    if (i < nvec) {
      const int c = first_channel + at.channel;
      const float a = rstd * param<T, Unfused>(weight, c);
      const float b = fmaf(-mean, a, param<T, Unfused>(bias, c));
      float f[N];
      P::unpack(raw[k], f);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float y = fmaf(f[e], a, b);
        f[e] = Unfused ? unfused_swish<T>(y) : y * sigmoid(y);
      }
      P::store(out + base + (size_t)i * N, P::pack(f));
    }
  }
}

// Per channel of the group, one warp (of `warps`) sums the per-vector sums
// of g_y (vec_g) and g_y xhat (vec_gx) in a fixed order, writes them to row
// `row` of partial ((2, B, C): partial[row * C + c] and partial[(B + row) *
// C + c]) and, where chan is not null, to chan ([2][channels_per_group]),
// and fences its global stores for the group's last block (add_arrival).
// Ends with a barrier.
__device__ __forceinline__ void channel_sums(
    const float* vec_g, const float* vec_gx, float* chan,
    float* __restrict__ partial, int batch, int channels, int row,
    int first_channel, int channels_per_group, int per_channel, int warps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int ch = warp; ch < channels_per_group; ch += warps) {
    float sg = 0.0f, sgx = 0.0f;
    for (int j = lane; j < per_channel; j += 32) {
      sg += vec_g[ch * per_channel + j];
      sgx += vec_gx[ch * per_channel + j];
    }
    sg = warp_sum(sg);
    sgx = warp_sum(sgx);
    if (lane == 0) {
      const int c = first_channel + ch;
      partial[(size_t)row * channels + c] = sg;
      partial[((size_t)batch + row) * channels + c] = sgx;
      if (chan != nullptr) {
        chan[ch] = sg;
        chan[channels_per_group + ch] = sgx;
      }
      __threadfence();
    }
  }
  __syncthreads();
}

// Thread 0, after channel_sums: counts an arrival at `group` and returns
// whether it was the last of `arrivals` (then the group's partial sums, all
// fenced before their arrivals, are visible to the block after its next
// barrier).
__device__ __forceinline__ bool add_arrival(unsigned* counters, int group,
                                            int arrivals) {
  const bool last =
      atomicAdd(counters + group, 1u) == (unsigned)arrivals - 1u;
  if (last) __threadfence();
  return last;
}

// The group's last arrival: dbias[c] = sum_r partial[r * C + c] and
// dweight[c] = sum_r partial[(B + r) * C + c] over rows r < rows, for the
// group's channels, each column by one warp (of `warps`; lane l sums rows
// l, l + 32, ... in order, then the fixed shuffle tree), and the group's
// counter back to 0 for the next launch.
__device__ __forceinline__ void sum_group(
    const float* __restrict__ partial, float* __restrict__ dweight,
    float* __restrict__ dbias, unsigned* counters, int batch, int channels,
    int rows, int group, int first_channel, int channels_per_group,
    int warps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int col = warp; col < 2 * channels_per_group; col += warps) {
    const bool db = col < channels_per_group;
    const int c = first_channel + (db ? col : col - channels_per_group);
    const float* p = partial + (db ? 0 : (size_t)batch * channels) + c;
    float v = 0.0f;
    for (int r = lane; r < rows; r += 32)
      v += __ldcg(p + (size_t)r * channels);
    v = warp_sum(v);
    if (lane == 0) (db ? dbias : dweight)[c] = v;
  }
  if (threadIdx.x == 0) counters[group] = 0u;
}

struct BwdParams {
  const float *weight, *bias, *stats;
  float *partial, *dweight, *dbias;
  unsigned* counters;
  int batch, channels, groups, channels_per_group, hw;
};

// The backward, persistent. Block b serves group b % G and the samples
// b / G, b / G + S, ... (S = gridDim.x / G slots a group), so the weights
// and biases of a thread's vectors are the same in every run it takes, and
// it sums its vectors' g_y and g_y xhat over its runs in registers; only
// at its end does the block reduce them per channel into its slot's row of
// the (2, B, C) partial sums and arrive at its group. Thread 0 keeps
// kStages runs' x and dy in flight in the ring. A run costs two barriers:
// the group means of w g_y and w g_y xhat, and the stage's release. Dynamic
// shared memory: the ring (kStages x (x run, dy run)), which also holds the
// per-vector sums at the end. N divides hw, len * sizeof(T) is a multiple
// of 16, x and dy are 16-byte aligned; len / N <= NV * blockDim.x.
template <typename T, int N, int NV, bool Unfused>
__global__ void __launch_bounds__(kRingThreads)
gn_swish_bwd(const T* __restrict__ x, const T* __restrict__ dy,
             T* __restrict__ dx, const BwdParams a) {
  using P = Pack<T, N>;
  extern __shared__ __align__(16) uint8_t ring[];
  __shared__ uint64_t full[kStages];
  __shared__ float scratch[2][64];
  __shared__ int last;
  const int threads = blockDim.x, warps = threads / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = a.channels_per_group * a.hw;
  const int nvec = len / N;
  const int per_channel = a.hw / N;
  const uint32_t run_bytes = (uint32_t)(len * sizeof(T));
  const int group = blockIdx.x % a.groups;
  const int slot = blockIdx.x / a.groups, slots = gridDim.x / a.groups;
  const int first_channel = group * a.channels_per_group;

  auto issue = [&](int sample, int stage) {  // thread 0 only
    const size_t at = ((size_t)sample * a.groups + group) * len;
    uint8_t* dst = ring + stage * 2 * run_bytes;
    sm90::mbar_arrive_expect_tx(&full[stage], 2 * run_bytes);
    sm90::bulk_load(dst, x + at, run_bytes, &full[stage]);
    sm90::bulk_load(dst + run_bytes, dy + at, run_bytes, &full[stage]);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) sm90::mbar_init(&full[s], 1);
    sm90::fence_barrier_init();
    for (int s = 0; s < kStages; ++s)
      if (slot + s * slots < a.batch) issue(slot + s * slots, s);
  }
  // The weight and bias of each of the thread's vectors, the same in every
  // run, and its sums over the runs.
  float wk[NV], bk[NV], acc_g[NV], acc_gx[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = first_channel +
                  min((int)threadIdx.x + k * threads, nvec - 1) / per_channel;
    wk[k] = param<T, Unfused>(a.weight, c);
    bk[k] = param<T, Unfused>(a.bias, c);
    acc_g[k] = acc_gx[k] = 0.0f;
  }
  __syncthreads();

  int j = 0;
  for (int sample = slot; sample < a.batch; sample += slots, ++j) {
    const int stage = j % kStages;
    const T* xs = reinterpret_cast<const T*>(ring + stage * 2 * run_bytes);
    const T* ds = reinterpret_cast<const T*>(ring + stage * 2 * run_bytes +
                                             run_bytes);
    const int run = sample * a.groups + group;
    const float mean = __ldg(a.stats + 2 * run);
    const float rstd = __ldg(a.stats + 2 * run + 1);
    sm90::mbar_wait(&full[stage], (j / kStages) & 1);
    const float shift = -mean * rstd;  // xhat = x rstd + shift

    // g_y once: w g_y kept for dx; the sums of g_y and g_y xhat per vector
    // added to the thread's, and of w g_y and w g_y xhat over the run.
    float wg[NV][N];
    float swg = 0.0f, swgx = 0.0f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int i = threadIdx.x + k * threads;
      if (i < nvec) {
        float xf[N], df[N];
        P::unpack(P::load(xs + i * N), xf);
        P::unpack(P::load(ds + i * N), df);
        const PreSwish<T, Unfused> pre(wk[k], bk[k], mean, rstd);
        float sg = 0.0f, sgx = 0.0f;
#pragma unroll
        for (int e = 0; e < N; ++e) {
          const float xhat = fmaf(xf[e], rstd, shift);
          const float g = swish_grad(pre(xf[e], xhat), df[e]);
          sg += g;
          sgx = fmaf(g, xhat, sgx);
          wg[k][e] = wk[k] * g;
        }
        acc_g[k] += sg;
        acc_gx[k] += sgx;
        swg = fmaf(wk[k], sg, swg);
        swgx = fmaf(wk[k], sgx, swgx);
      }
    }
    // mean_grp(w g_y) and mean_grp(w g_y xhat): the warps' sums in order,
    // in scratch[j % 2], which the release barrier of run j + 1 frees.
    swg = warp_sum(swg);
    swgx = warp_sum(swgx);
    float* part = scratch[j & 1];
    if (lane == 0) {
      part[warp] = swg;
      part[32 + warp] = swgx;
    }
    __syncthreads();
    swg = swgx = 0.0f;
    for (int w = 0; w < warps; ++w) {
      swg += part[w];
      swgx += part[32 + w];
    }
    const float mean_wg = swg / (float)len;
    const float mean_wgx = swgx / (float)len;

    const size_t base = (size_t)run * len;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int i = threadIdx.x + k * threads;
      if (i < nvec) {
        float xf[N];
        P::unpack(P::load(xs + i * N), xf);
#pragma unroll
        for (int e = 0; e < N; ++e) {
          const float xhat = fmaf(xf[e], rstd, shift);
          xf[e] = rstd * (wg[k][e] - mean_wg - xhat * mean_wgx);
        }
        P::store(dx + base + (size_t)i * N, P::pack(xf));
      }
    }
    // The stage is free again.
    __syncthreads();
    if (threadIdx.x == 0 && sample + kStages * slots < a.batch)
      issue(sample + kStages * slots, stage);
  }

  // The block's sums per channel, into its slot's row; the ring is free.
  float* vec_g = reinterpret_cast<float*>(ring);
  float* vec_gx = vec_g + nvec;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = threadIdx.x + k * threads;
    if (i < nvec) {
      vec_g[i] = acc_g[k];
      vec_gx[i] = acc_gx[k];
    }
  }
  __syncthreads();
  channel_sums(vec_g, vec_gx, nullptr, a.partial, a.batch, a.channels, slot,
               first_channel, a.channels_per_group, per_channel, warps);
  if (threadIdx.x == 0) last = add_arrival(a.counters, group, slots);
  __syncthreads();
  if (last)
    sum_group(a.partial, a.dweight, a.dbias, a.counters, a.batch, a.channels,
              slots, group, first_channel, a.channels_per_group, warps);
}

// The backward for the runs the ring does not take: one block per (sample,
// group), blockIdx.x = run, the run's x and dy held in registers as loaded
// (N = 1 where H x W is no multiple of a vector). g_y is computed again for
// dx rather than held in float32, which at 16 vectors a thread would halve
// the blocks an SM holds. Dynamic shared memory: two floats a vector, then
// two a channel of the group. Left to choose, ptxas holds the element path
// (N = 1: a register a value, 32 for x and dy) to 80 registers and spills;
// a minimum of two blocks an SM lets it take up to 128 (0: no minimum, as
// ptxas chooses for the vector paths).
template <typename T, int N, int NV, bool Unfused>
__global__ void __launch_bounds__(kThreads, N == 1 ? 2 : 0)
gn_swish_bwd_regs(const T* __restrict__ x, const T* __restrict__ dy,
                  T* __restrict__ dx, const BwdParams a) {
  using P = Pack<T, N>;
  extern __shared__ float smem[];
  __shared__ int last;
  const int len = a.channels_per_group * a.hw;
  const int nvec = len / N;
  const int per_channel = a.hw / N;
  float* vec_g = smem;              // [nvec]
  float* vec_gx = smem + nvec;      // [nvec]
  float* chan = smem + 2 * nvec;    // [2][channels_per_group]
  const int run = blockIdx.x;
  const size_t base = (size_t)run * len;
  const int sample = run / a.groups, group = run - sample * a.groups;
  const int first_channel = group * a.channels_per_group;

  typename P::Raw xr[NV], dyr[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < nvec) {
      xr[k] = P::load(x + base + (size_t)i * N);
      dyr[k] = P::load(dy + base + (size_t)i * N);
    }
  }
  const float mean = __ldg(a.stats + 2 * run);
  const float rstd = __ldg(a.stats + 2 * run + 1);
  const float shift = -mean * rstd;  // xhat = x rstd + shift

  ChannelWalk at(per_channel);
#pragma unroll
  for (int k = 0; k < NV; ++k, at.next()) {
    const int i = threadIdx.x + k * kThreads;
    if (i < nvec) {
      const int c = first_channel + at.channel;
      const PreSwish<T, Unfused> pre(param<T, Unfused>(a.weight, c),
                                     param<T, Unfused>(a.bias, c), mean,
                                     rstd);
      float xf[N], df[N];
      P::unpack(xr[k], xf);
      P::unpack(dyr[k], df);
      float sg = 0.0f, sgx = 0.0f;
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float xhat = fmaf(xf[e], rstd, shift);
        const float g = swish_grad(pre(xf[e], xhat), df[e]);
        sg += g;
        sgx = fmaf(g, xhat, sgx);
      }
      vec_g[i] = sg;
      vec_gx[i] = sgx;
    }
  }
  __syncthreads();
  channel_sums(vec_g, vec_gx, chan, a.partial, a.batch, a.channels, sample,
               first_channel, a.channels_per_group, per_channel, kWarps);
  if (threadIdx.x == 0) last = add_arrival(a.counters, group, a.batch);

  float sum_wg = 0.0f, sum_wgx = 0.0f;
  for (int ch = 0; ch < a.channels_per_group; ++ch) {
    const float w = param<T, Unfused>(a.weight, first_channel + ch);
    sum_wg = fmaf(w, chan[ch], sum_wg);
    sum_wgx = fmaf(w, chan[a.channels_per_group + ch], sum_wgx);
  }
  const float mean_wg = sum_wg / (float)len;
  const float mean_wgx = sum_wgx / (float)len;

  at = ChannelWalk(per_channel);
#pragma unroll
  for (int k = 0; k < NV; ++k, at.next()) {
    const int i = threadIdx.x + k * kThreads;
    if (i < nvec) {
      const int c = first_channel + at.channel;
      const PreSwish<T, Unfused> pre(param<T, Unfused>(a.weight, c),
                                     param<T, Unfused>(a.bias, c), mean,
                                     rstd);
      float xf[N], df[N];
      P::unpack(xr[k], xf);
      P::unpack(dyr[k], df);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float xhat = fmaf(xf[e], rstd, shift);
        const float wg = pre.w * swish_grad(pre(xf[e], xhat), df[e]);
        xf[e] = rstd * (wg - mean_wg - xhat * mean_wgx);
      }
      P::store(dx + base + (size_t)i * N, P::pack(xf));
    }
  }
  __syncthreads();  // `last` is set
  if (last)
    sum_group(a.partial, a.dweight, a.dbias, a.counters, a.batch, a.channels,
              a.batch, group, first_channel, a.channels_per_group, kWarps);
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

template <typename T, int N, int NV, bool Unfused>
int launch_fwd(const void* x, const float* weight, const float* bias,
               void* out, float* stats, int blocks, int groups,
               int per_group, int hw, float eps, cudaStream_t stream) {
  gn_swish<T, N, NV, Unfused><<<blocks, kThreads, 0, stream>>>(
      (const T*)x, weight, bias, (T*)out, stats, groups, per_group, hw, eps);
  return (int)cudaGetLastError();
}

template <typename T, bool Unfused>
int fwd(const void* x, const float* weight, const float* bias, void* out,
        float* stats, int batch, int channels, int hw, int groups, float eps,
        cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int per_group = channels / groups;
  bool vec;
  int nv;
  if (!run_shape<T>(per_group * hw, hw, x, out, x, &vec, &nv))
    return (int)cudaErrorInvalidValue;
  const int blocks = batch * groups;
  if (!vec)
    return launch_fwd<T, 1, kMaxVecs, Unfused>(x, weight, bias, out, stats,
                                               blocks, groups, per_group, hw,
                                               eps, stream);
  switch (nv) {
    case 1: return launch_fwd<T, kVec, 1, Unfused>(
        x, weight, bias, out, stats, blocks, groups, per_group, hw, eps,
        stream);
    case 2: return launch_fwd<T, kVec, 2, Unfused>(
        x, weight, bias, out, stats, blocks, groups, per_group, hw, eps,
        stream);
    case 4: return launch_fwd<T, kVec, 4, Unfused>(
        x, weight, bias, out, stats, blocks, groups, per_group, hw, eps,
        stream);
    case 8: return launch_fwd<T, kVec, 8, Unfused>(
        x, weight, bias, out, stats, blocks, groups, per_group, hw, eps,
        stream);
    default: return launch_fwd<T, kVec, 16, Unfused>(
        x, weight, bias, out, stats, blocks, groups, per_group, hw, eps,
        stream);
  }
}

struct BwdCall {
  const void *x, *dy;
  void* dx;
  BwdParams p;
  cudaStream_t stream;
};

// How many blocks of the ring at a run length fit on the card's SMs at
// once, into *blocks. Setting the shared-memory attribute and asking the
// occupancy calculator cost the host microseconds, which a launch of a few
// tens of them cannot spare: each (device, run length) asks once. The
// attribute is the kernel's, not a run length's, so it only ever grows, to
// the most shared memory any run length on the device has asked for.
template <typename T, int N, bool Unfused>
int ring_blocks(int len, int threads, size_t smem, int* blocks) {
  static std::mutex mu;
  static std::map<std::pair<int, int>, int> known;
  static std::map<int, size_t> granted;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const std::lock_guard<std::mutex> hold(mu);
  const auto it = known.find({dev, len});
  if (it != known.end()) {
    *blocks = it->second;
    return (int)cudaSuccess;
  }
  const auto kernel = gn_swish_bwd<T, N, kRingVecs, Unfused>;
  if (smem > granted[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    granted[dev] = smem;
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  *blocks = known[{dev, len}] = per_sm * sms;
  return (int)cudaSuccess;
}

// The ring's blocks: a thread for every kRingVecs vectors of a run, and as
// many blocks as fit on the SMs at once, in slots of `groups` (every group
// the same number of blocks), at most one slot a sample.
template <typename T, int N, bool Unfused>
int launch_bwd(const BwdCall& a) {
  const int len = a.p.channels_per_group * a.p.hw;
  const int threads = ((len / N + kRingVecs - 1) / kRingVecs + 31) / 32 * 32;
  const size_t smem = kStages * 2 * (size_t)len * sizeof(T);
  int blocks = 0;
  const int err = ring_blocks<T, N, Unfused>(len, threads, smem, &blocks);
  if (err != (int)cudaSuccess) return err;
  int slots = blocks / a.p.groups;
  slots = slots < 1 ? 1 : slots > a.p.batch ? a.p.batch : slots;
  gn_swish_bwd<T, N, kRingVecs, Unfused><<<slots * a.p.groups, threads, smem,
                                           a.stream>>>(
      (const T*)a.x, (const T*)a.dy, (T*)a.dx, a.p);
  return (int)cudaGetLastError();
}

template <typename T, int N, int NV, bool Unfused>
int launch_bwd_regs(const BwdCall& a) {
  const size_t smem = (2 * (size_t)a.p.channels_per_group * a.p.hw / N +
                       2 * (size_t)a.p.channels_per_group) *
                      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gn_swish_bwd_regs<T, N, NV, Unfused>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  gn_swish_bwd_regs<T, N, NV, Unfused><<<a.p.batch * a.p.groups, kThreads,
                                         smem, a.stream>>>(
      (const T*)a.x, (const T*)a.dy, (T*)a.dx, a.p);
  return (int)cudaGetLastError();
}

// The ring takes 16-byte vectors (hw a multiple of one, x, dy and dx
// 16-byte aligned) and runs of at most kRingVecs * kRingThreads of them.
template <typename T, bool Unfused>
int bwd(const BwdCall& a) {
  constexpr int kVec = 16 / sizeof(T);
  bool vec;
  int nv;
  const int len = a.p.channels_per_group * a.p.hw;
  if (!run_shape<T>(len, a.p.hw, a.x, a.dy, a.dx, &vec, &nv) || !vec ||
      len / kVec > kRingVecs * kRingThreads)
    return (int)cudaErrorInvalidValue;
  return launch_bwd<T, kVec, Unfused>(a);
}

template <typename T, bool Unfused>
int bwd_regs(const BwdCall& a) {
  constexpr int kVec = 16 / sizeof(T);
  bool vec;
  int nv;
  if (!run_shape<T>(a.p.channels_per_group * a.p.hw, a.p.hw, a.x, a.dy, a.dx,
                    &vec, &nv))
    return (int)cudaErrorInvalidValue;
  if (!vec) return launch_bwd_regs<T, 1, kMaxVecs, Unfused>(a);
  switch (nv) {
    case 1: return launch_bwd_regs<T, kVec, 1, Unfused>(a);
    case 2: return launch_bwd_regs<T, kVec, 2, Unfused>(a);
    case 4: return launch_bwd_regs<T, kVec, 4, Unfused>(a);
    case 8: return launch_bwd_regs<T, kVec, 8, Unfused>(a);
    default: return launch_bwd_regs<T, kVec, 16, Unfused>(a);
  }
}

bool bad_shape(int batch, int channels, int hw, int groups) {
  return batch <= 0 || channels <= 0 || hw <= 0 || groups <= 0 ||
         channels % groups != 0 || (long long)batch * groups > 0x7fffffffLL;
}

BwdCall bwd_call(const void* x, const void* dy, const void* weight,
                 const void* bias, const void* stats, void* dx, void* partial,
                 void* counters, void* dweight, void* dbias, int batch,
                 int channels, int hw, int groups, void* stream) {
  return BwdCall{x, dy, dx,
                 BwdParams{(const float*)weight, (const float*)bias,
                           (const float*)stats, (float*)partial,
                           (float*)dweight, (float*)dbias,
                           (unsigned*)counters, batch, channels, groups,
                           channels / groups, hw},
                 (cudaStream_t)stream};
}

}  // namespace

// x, out: (batch, channels, hw) contiguous, float32 or bfloat16; weight,
// bias: (channels,) float32; stats: null, or (batch, groups, 2) float32 for
// each (sample, group)'s (mean, rstd). channels % groups == 0, and a
// group's run of channels / groups * hw elements at most 16 * 256 vectors
// of 16 bytes (or elements, where hw is no multiple of a vector). unfused:
// 0 for the fused arithmetic, 1 for the unfused path's (the header).
extern "C" int mulan_gn_swish(const void* x, const void* weight,
                              const void* bias, void* out, void* stats,
                              int batch, int channels, int hw, int groups,
                              float eps, int is_bf16, int unfused,
                              void* stream) {
  if (bad_shape(batch, channels, hw, groups))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* w = (const float*)weight;
  const float* b = (const float*)bias;
  float* st = (float*)stats;
  if (is_bf16)
    return unfused ? fwd<__nv_bfloat16, true>(x, w, b, out, st, batch,
                                              channels, hw, groups, eps, s)
                   : fwd<__nv_bfloat16, false>(x, w, b, out, st, batch,
                                               channels, hw, groups, eps, s);
  return unfused ? fwd<float, true>(x, w, b, out, st, batch, channels, hw,
                                    groups, eps, s)
                 : fwd<float, false>(x, w, b, out, st, batch, channels, hw,
                                     groups, eps, s);
}

// x, dy, dx: (batch, channels, hw) as above; weight, bias, dweight, dbias:
// (channels,) float32; stats: (batch, groups, 2) as mulan_gn_swish writes
// them with the same arithmetic; partial: (2, batch, channels) float32
// scratch; counters: (groups,) uint32, zero, and zero again after the
// kernel. The ring design: runs of at most 2,048 16-byte vectors.
extern "C" int mulan_gn_swish_bwd(const void* x, const void* dy,
                                  const void* weight, const void* bias,
                                  const void* stats, void* dx, void* partial,
                                  void* counters, void* dweight, void* dbias,
                                  int batch, int channels, int hw, int groups,
                                  int is_bf16, int unfused, void* stream) {
  if (stats == nullptr || bad_shape(batch, channels, hw, groups))
    return (int)cudaErrorInvalidValue;
  const BwdCall a = bwd_call(x, dy, weight, bias, stats, dx, partial,
                             counters, dweight, dbias, batch, channels, hw,
                             groups, stream);
  if (is_bf16)
    return unfused ? bwd<__nv_bfloat16, true>(a)
                   : bwd<__nv_bfloat16, false>(a);
  return unfused ? bwd<float, true>(a) : bwd<float, false>(a);
}

// The same arguments; the registers design, for every run mulan_gn_swish
// takes.
extern "C" int mulan_gn_swish_bwd_regs(const void* x, const void* dy,
                                       const void* weight, const void* bias,
                                       const void* stats, void* dx,
                                       void* partial, void* counters,
                                       void* dweight, void* dbias, int batch,
                                       int channels, int hw, int groups,
                                       int is_bf16, int unfused,
                                       void* stream) {
  if (stats == nullptr || bad_shape(batch, channels, hw, groups))
    return (int)cudaErrorInvalidValue;
  const BwdCall a = bwd_call(x, dy, weight, bias, stats, dx, partial,
                             counters, dweight, dbias, batch, channels, hw,
                             groups, stream);
  if (is_bf16)
    return unfused ? bwd_regs<__nv_bfloat16, true>(a)
                   : bwd_regs<__nv_bfloat16, false>(a);
  return unfused ? bwd_regs<float, true>(a) : bwd_regs<float, false>(a);
}
