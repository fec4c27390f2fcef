// Decoder log-likelihood forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mulan_tpu/ops/decoder_logprob.py:_fwd_kernel
// (launched by _run_fwd). For each example b it computes
//   out[b] = sum_p [ l_x - logsumexp_v l_v ],
//   l_v = -0.5 ((z - e_v) exp(-g0/2))^2,  e_v = 2 (v + 1/2) / vocab - 1,
// with x rounded to the nearest integer first.
//
// The TPU kernel runs an online logsumexp over all vocab values (a running
// max, two exp and a rescale a step). Two facts about this l_v let a thread
// do far less, and keep the steps independent:
//   * its maximum is at the bin nearest z, v* = clamp(rint((z + 1) vocab/2 -
//     1/2), 0, vocab - 1), so m = l_{v*} needs no running max, and each bin
//     costs one exp2 of a pre-scaled argument and no rescale;
//   * a bin k places from v* has l_v - m <= -(k (k - 1) / 2) (2 / vocab)^2
//     e^-g0 (z between the outer bins; further still outside them), which is
//     below -104 for every k above h = ceil(14.5 e^(g0/2) vocab / 2) + 1.
//     Such a term is 0 after a float32 exp (e^-104 is below the smallest
//     denormal) and adds nothing to a sum of at least 1, so the bins
//     [v* - h, v* + h] clamped to the vocab give the whole sum: 9 of 256 at
//     the flagship's pinned g0 = gamma_min = -13.3, all 256 near gamma_max.
// ops/decoder_logprob.py:logsumexp_window is the same window in PyTorch.
//
// What bounds it on the H100: the special-function units' exp2 rate where
// the windows are wide, else the ~1.5 MB of each of x, z and g0 read once
// at CIFAR shapes (128 x 3072 pixels). Every pixel is one thread's loop (no
// shared memory, no cross-thread traffic inside it), and each example is
// spread over several blocks so that the batch fills the SMs. The (B,
// vocab) logits the reference materializes never exist. Pixels of a warp
// whose windows differ wait for the widest.
//
// Determinism: no float atomics. Each block writes one partial sum, reduced
// in a fixed tree order in shared memory; a second kernel sums an example's
// partials in block order.
//
// The backward (decoder_logprob_bwd, K5) replaces the Pallas TPU kernel
// mulan_tpu/ops/decoder_logprob.py:_bwd_kernel (launched by _bwd). It has a
// closed form in the softmax moments of the vocab (p_v = softmax_v l_v,
// inv_var = exp(-g0)):
//   dz  = ct inv_var (e_x - E_p[e_v])
//   dg0 = ct 0.5 inv_var ((z - e_x)^2 - E_p[(z - e_v)^2])
// with ct the per-example cotangent. Each pixel is one thread's 256-step
// online-softmax recurrence carrying (m, s, sum w e, sum w (z - e)^2), two
// expf a step: ~2e8 expf at CIFAR train shapes against ~8 MB of traffic, so
// it is bound by the SFUs' expf rate, not by memory. g0 is per pixel; the
// wrapper expands a broadcast g0 and sums dg0 back in PyTorch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;
// Half-width of the window in units of the noise's e^(g0/2): a term at
// |z - e_v| e^(-g0/2) >= 14.5 sits below e^-104 (14.5^2 / 2 > 104).
constexpr float kWindowSigmas = 14.5f;

__device__ __forceinline__ float bin_center(float v, int vocab) {
  return 2.0f * ((v + 0.5f) / (float)vocab) - 1.0f;
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__global__ void __launch_bounds__(kThreads)
decoder_logprob_partial(const float* __restrict__ x,
                        const float* __restrict__ z,
                        const float* __restrict__ g0,
                        float* __restrict__ partial, int n, int n_blocks,
                        int vocab) {
  const int blk = blockIdx.x;
  const int b = blockIdx.y;
  const int per_block = (n + n_blocks - 1) / n_blocks;
  const int lo = blk * per_block;
  const int hi = min(n, lo + per_block);
  const size_t row = (size_t)b * n;

  const float bins_per_unit = 0.5f * (float)vocab;
  // e_v = v step + e_0 with no division in the loop.
  const float step = 2.0f / (float)vocab;
  const float e_0 = 1.0f / (float)vocab - 1.0f;
  float acc = 0.0f;
  for (int p = lo + threadIdx.x; p < hi; p += kThreads) {
    const float zz = z[row + p];
    const float g = g0[row + p];
    const float inv_stdev = expf(-0.5f * g);
    const float dx = (zz - bin_center(rintf(x[row + p]), vocab)) * inv_stdev;
    const float l_x = -0.5f * dx * dx;
    const float v_star = fminf(
        fmaxf(rintf(fmaf(zz + 1.0f, bins_per_unit, -0.5f)), 0.0f),
        (float)(vocab - 1));
    const float half =
        ceilf(kWindowSigmas * expf(0.5f * g) * bins_per_unit) + 1.0f;
    const int first = (int)fmaxf(v_star - half, 0.0f);
    const int last = (int)fminf(v_star + half, (float)(vocab - 1));
    const float d_star = (zz - bin_center(v_star, vocab)) * inv_stdev;
    const float m = -0.5f * d_star * d_star;
    // exp(l_v - m) = 2^(c (z - e_v)^2 - m log2 e).
    const float c = -0.5f * kLog2e * inv_stdev * inv_stdev;
    const float m2 = m * kLog2e;
    float s = 0.0f;
    float v = (float)first;
#pragma unroll 4
    for (int k = first; k <= last; ++k, v += 1.0f) {
      const float d = zz - fmaf(v, step, e_0);
      s += fast_exp2(fmaf(c * d, d, -m2));
    }
    acc += l_x - (m + logf(s));
  }

  __shared__ float red[kThreads];
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) red[threadIdx.x] += red[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0) partial[(size_t)b * n_blocks + blk] = red[0];
}

__global__ void sum_partials(const float* __restrict__ partial,
                             float* __restrict__ out, int batch,
                             int n_blocks) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  float s = 0.0f;
  for (int i = 0; i < n_blocks; ++i) s += partial[(size_t)b * n_blocks + i];
  out[b] = s;
}

__global__ void __launch_bounds__(kThreads)
decoder_logprob_bwd(const float* __restrict__ x, const float* __restrict__ z,
                    const float* __restrict__ g0,
                    const float* __restrict__ ct, float* __restrict__ dz,
                    float* __restrict__ dg0, int n, size_t total, int vocab) {
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const float zz = z[i];
  const float g = g0[i];
  const float inv_var = expf(-g);
  const float inv_stdev = expf(-0.5f * g);
  const float e_x = bin_center(rintf(x[i]), vocab);
  float m = -INFINITY, s = 0.0f, sum_e = 0.0f, sum_sq = 0.0f;
  for (int v = 0; v < vocab; ++v) {
    const float e_v = bin_center((float)v, vocab);
    const float diff = zz - e_v;
    const float d = diff * inv_stdev;
    const float l = -0.5f * d * d;
    const float m_new = fmaxf(m, l);
    const float rescale = expf(m - m_new);
    const float w = expf(l - m_new);
    s = s * rescale + w;
    sum_e = sum_e * rescale + w * e_v;
    sum_sq = sum_sq * rescale + w * diff * diff;
    m = m_new;
  }
  const float c = ct[i / n];
  const float dx = zz - e_x;
  dz[i] = c * inv_var * (e_x - sum_e / s);
  dg0[i] = c * 0.5f * inv_var * (dx * dx - sum_sq / s);
}

}  // namespace

extern "C" int mulan_decoder_logprob_fwd(const void* x, const void* z,
                                         const void* g0, void* partial,
                                         void* out, int batch, int n,
                                         int n_blocks, int vocab,
                                         void* stream) {
  if (batch <= 0 || n <= 0 || n_blocks <= 0 || n_blocks > 65535 ||
      batch > 65535 || vocab <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid(n_blocks, batch);
  decoder_logprob_partial<<<grid, kThreads, 0, s>>>(
      (const float*)x, (const float*)z, (const float*)g0, (float*)partial, n,
      n_blocks, vocab);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials<<<(batch + 127) / 128, 128, 0, s>>>(
      (const float*)partial, (float*)out, batch, n_blocks);
  return (int)cudaGetLastError();
}

// (x, z, g0) (batch, n) float32, ct (batch,) -> dz, dg0 (batch, n).
extern "C" int mulan_decoder_logprob_bwd(const void* x, const void* z,
                                         const void* g0, const void* ct,
                                         void* dz, void* dg0, int batch,
                                         int n, int vocab, void* stream) {
  if (batch <= 0 || n <= 0 || vocab <= 0) return (int)cudaErrorInvalidValue;
  const size_t total = (size_t)batch * n;
  const size_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffu) return (int)cudaErrorInvalidValue;
  decoder_logprob_bwd<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const float*)x, (const float*)z, (const float*)g0, (const float*)ct,
      (float*)dz, (float*)dg0, n, total, vocab);
  return (int)cudaGetLastError();
}

extern "C" const char* mulan_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
