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

extern "C" const char* mulan_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
