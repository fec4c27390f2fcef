// Decoder log-likelihood forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mulan_tpu/ops/decoder_logprob.py:_fwd_kernel
// (launched by _run_fwd). For each example b it computes
//   out[b] = sum_p [ l_x - logsumexp_v l_v ],
//   l_v = -0.5 ((z - e_v) exp(-g0/2))^2,  e_v = 2 (v + 1/2) / vocab - 1,
// with x rounded to the nearest integer first.
//
// What bounds it on the H100: arithmetic, not memory. Each pixel reads 12
// bytes and does `vocab` steps of the online max/sum recurrence (two expf
// each), so at CIFAR shapes (128 x 3072 pixels, vocab 256) it is ~2e8 expf
// against ~1.5 MB of traffic. The design gives every pixel its own thread
// (no shared memory, no cross-thread traffic inside the vocab loop) and
// spreads each example over several blocks so that the batch fills the SMs.
// The (B, vocab) logits the reference materializes never exist.
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

__device__ __forceinline__ float bin_center(float v, int vocab) {
  return 2.0f * ((v + 0.5f) / (float)vocab) - 1.0f;
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

  float acc = 0.0f;
  for (int p = lo + threadIdx.x; p < hi; p += kThreads) {
    const float zz = z[row + p];
    const float inv_stdev = expf(-0.5f * g0[row + p]);
    const float dx = (zz - bin_center(rintf(x[row + p]), vocab)) * inv_stdev;
    const float l_x = -0.5f * dx * dx;
    float m = -INFINITY;
    float s = 0.0f;
    for (int v = 0; v < vocab; ++v) {
      const float d = (zz - bin_center((float)v, vocab)) * inv_stdev;
      const float l = -0.5f * d * d;
      const float m_new = fmaxf(m, l);
      s = s * expf(m - m_new) + expf(l - m_new);
      m = m_new;
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
