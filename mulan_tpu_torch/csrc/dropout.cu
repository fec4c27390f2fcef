// Dropout keep-mask for Hopper (sm_90a): a pre-scaled mask with values in
// {0, scale}, scale = 1 / (1 - threshold16 / 65536), in the activation's type.
//
// Replaces the Pallas TPU kernel mulan_tpu/ops/dropout.py:_mask_kernel,
// launched there two ways, and here through two entry points of one kernel:
// - mulan_dropout_mask (K6, for _hw_mask / hw_dropout): one site's mask. As
//   in the TPU design the kernel writes only the mask; the x * mask product
//   stays a PyTorch op, and the backward regenerates the mask from
//   (seed, site) instead of keeping it.
// - mulan_dropout_mask_batch (K7, for hw_mask_batch): the masks of n_masks
//   consecutive sites, first_site + slot for slot = blockIdx.y, in one
//   launch; slot i is bit for bit the K6 mask of site first_site + i. The
//   caller keeps the masks for the backward.
//
// The TPU kernel draws from the TPU's hardware PRNG, reseeded per grid tile.
// Here the bits come from Philox4x32-10 (Salmon et al., SC'11; Random123's
// constants) written into the kernel: the key is (seed, site) and the counter
// is the element's index in the site's global mask divided by 8, so the
// stream depends only on (seed, site, index), never on the launch's tiling
// or on how the batch is split over data-parallel ranks (first_index) or
// its channels over tensor-parallel ranks (run, row_stride). Each of the
// four 32-bit output words gives two 16-bit draws, low half first: element
// i uses word
// (i / 2) % 4 of counter i / 8, and is kept iff its draw >= threshold16 =
// min(round(p * 65536), 65535), the quantization of the TPU kernel.
// mulan_tpu_torch/ops/dropout.py:dropout_mask_plain computes the same bits
// on int64 tensors, so kernel and plain agree bit for bit.
//
// What bounds it on the H100: memory. At a flagship site (128 x 128 x 32 x 32
// bf16) the mask is a 33.5 MB write, 10.0 us at 3.35 TB/s; its 2.1 M
// counters take 40 32-bit multiplies each (10 Philox rounds, a mulhi and a
// mul on two lanes), 84 M in all, 5.0 us at 64 a clock per SM. The 67 masks
// of the flagship's score UNet are a 2.25 GB write, 0.67 ms. One thread
// runs one counter and writes its 8 values, 16 bytes in bf16, as one
// ordinary vector store (the mask stays in the 50 MB L2 for the x * mask
// that reads it next); consecutive threads write consecutive chunks. A
// grid-stride loop over a few waves of the SMs, several counters a thread,
// was measured against it (mulan_tpu_torch/ops/ablations/k6_mask.json): no
// faster for one mask, slower for the 67 of K7. Back to back the kernel
// takes twice its bound, about a third of it the launch; in one launch the
// wrapper's host time weighs more (mulan_tpu_torch/ops/dropout.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

template <typename T> __device__ __forceinline__ T cvt(float x);
template <> __device__ __forceinline__ float cvt<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 cvt<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Word i (0..7) of the eight 32-bit words of two consecutive counters, by
// selects (no local-memory array for a runtime index).
__device__ __forceinline__ uint32_t word_of(const uint4& a, const uint4& b,
                                            unsigned i) {
  const uint4 v = i < 4 ? a : b;
  const unsigned j = i & 3u;
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// The 16-bit draw of element g of a site's global mask: half g % 2 of word
// (g % 8) / 2 of counter g / 8.
__device__ __forceinline__ uint32_t draw_at(unsigned long long g,
                                            uint32_t seed, uint32_t site) {
  const unsigned long long ctr = g >> 3;
  const uint4 r = philox4x32_10(
      make_uint4((uint32_t)ctr, (uint32_t)(ctr >> 32), 0u, 0u), seed, site);
  const uint32_t w = word_of(r, r, (unsigned)(g & 7u) / 2);
  return (g & 1u) ? (w >> 16) : (w & 0xFFFFu);
}

// The values of global elements g .. g + 7 of a site's mask. g % 8 == 0
// (every contiguous flagship and encoder site, and one process) takes one
// Philox call; otherwise the eight values straddle two counters and it runs
// both.
template <typename T>
__device__ __forceinline__ void fill8(T (&vals)[8], unsigned long long g,
                                      uint32_t seed, uint32_t site,
                                      uint32_t threshold16, T keep, T drop) {
  const unsigned long long ctr = g >> 3;
  const unsigned shift = (unsigned)(g & 7u);
  const uint4 r = philox4x32_10(
      make_uint4((uint32_t)ctr, (uint32_t)(ctr >> 32), 0u, 0u), seed, site);
  if (shift == 0) {
    const uint32_t words[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const uint32_t w = words[e / 2];
      const uint32_t u16 = (e % 2 == 0) ? (w & 0xFFFFu) : (w >> 16);
      vals[e] = u16 >= threshold16 ? keep : drop;
    }
  } else {
    const unsigned long long next = ctr + 1;
    const uint4 r1 = philox4x32_10(
        make_uint4((uint32_t)next, (uint32_t)(next >> 32), 0u, 0u), seed,
        site);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const unsigned d = shift + (unsigned)e;  // 1 .. 14
      const uint32_t w = word_of(r, r1, d / 2);
      const uint32_t u16 = (d % 2 == 0) ? (w & 0xFFFFu) : (w >> 16);
      vals[e] = u16 >= threshold16 ? keep : drop;
    }
  }
}

// The mask of site first_site + blockIdx.y goes to out + blockIdx.y * n.
// Without kWindow, local element i is element first_index + i of the
// site's global mask (a data-parallel rank's rows of the global batch start
// at first_index = rank * rows * C * H * W). With kWindow the mask is n /
// run runs of `run` elements that lie row_stride apart in the global mask:
// local element i is global element first_index + (i / run) * row_stride +
// i % run (a tensor-parallel rank's channel window, run = (C / tp) H W and
// row_stride = C H W, at first_index = row * C H W + rank (C / tp) H W).
// Either way the counter is the global index / 8, so a rank's mask is bit
// for bit its window of the mask one process draws. A thread's eight values
// lie in one run unless run % 8 != 0 (the tiny configs' 8 x 8 images at
// odd channel counts); there it draws them one by one.
template <typename T, bool kWindow>
__global__ void __launch_bounds__(kThreads)
dropout_mask(T* __restrict__ out, size_t n, uint32_t seed,
             uint32_t first_site, uint32_t threshold16, float scale,
             unsigned long long first_index, unsigned long long run,
             unsigned long long row_stride) {
  const size_t first = ((size_t)blockIdx.x * kThreads + threadIdx.x) * 8;
  if (first >= n) return;
  out += (size_t)blockIdx.y * n;
  const uint32_t site = first_site + blockIdx.y;
  const T keep = cvt<T>(scale), drop = cvt<T>(0.0f);
  __align__(16) T vals[8];
  if (!kWindow) {
    fill8(vals, first_index + first, seed, site, threshold16, keep, drop);
  } else {
    const unsigned long long row = first / run, col = first - row * run;
    if (col + 8 <= run) {
      fill8(vals, first_index + row * row_stride + col, seed, site,
            threshold16, keep, drop);
    } else {
      for (int e = 0; e < 8 && first + e < n; ++e) {
        const unsigned long long i = first + e, r = i / run;
        vals[e] = draw_at(first_index + r * row_stride + (i - r * run), seed,
                          site) >= threshold16 ? keep : drop;
      }
    }
  }
  if (first + 8 <= n && (uintptr_t)(out + first) % 16 == 0) {
    // 8 values are 16 bytes (bf16) or 32 bytes (f32). A slot after the
    // first starts 16-byte aligned only if n * sizeof(T) is a multiple of 16.
    const uint4* src = reinterpret_cast<const uint4*>(vals);
    uint4* dst = reinterpret_cast<uint4*>(out + first);
#pragma unroll
    for (int w = 0; w < (int)(8 * sizeof(T) / 16); ++w) dst[w] = src[w];
  } else {
    const int count = first + 8 <= n ? 8 : (int)(n - first);
    for (int e = 0; e < count; ++e) out[first + e] = vals[e];
  }
}

template <typename T>
int launch(void* out, size_t n, unsigned n_masks, uint32_t seed,
           uint32_t first_site, uint32_t threshold16, float scale,
           unsigned long long first_index, unsigned long long run,
           unsigned long long row_stride, cudaStream_t stream) {
  const size_t counters = (n + 7) / 8;
  const size_t blocks = (counters + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffu) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, n_masks);
  if (row_stride == 0)
    dropout_mask<T, false><<<grid, kThreads, 0, stream>>>(
        (T*)out, n, seed, first_site, threshold16, scale, first_index, 0, 0);
  else
    dropout_mask<T, true><<<grid, kThreads, 0, stream>>>(
        (T*)out, n, seed, first_site, threshold16, scale, first_index, run,
        row_stride);
  return (int)cudaGetLastError();
}

int launch_masks(void* out, long long n, unsigned n_masks, unsigned seed,
                 unsigned first_site, unsigned threshold16, float scale,
                 unsigned long long first_index, unsigned long long run,
                 unsigned long long row_stride, int is_bf16, void* stream) {
  if (n <= 0 || n_masks == 0 || n_masks > 65535u || threshold16 > 65535u)
    return (int)cudaErrorInvalidValue;
  // The last global index must fit in 64 bits: first_index + n - 1
  // contiguous, first_index + (n / run - 1) row_stride + run - 1 in runs
  // (run dividing n, row_stride >= run).
  unsigned long long span = (unsigned long long)n;
  if (row_stride != 0) {
    if (run == 0 || (unsigned long long)n % run != 0 || row_stride < run)
      return (int)cudaErrorInvalidValue;
    const unsigned long long rows = (unsigned long long)n / run;
    if (rows - 1 > (~0ull - run) / row_stride)
      return (int)cudaErrorInvalidValue;
    span = (rows - 1) * row_stride + run;
  }
  if (first_index > ~0ull - span) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch<__nv_bfloat16>(out, (size_t)n, n_masks, seed,
                                         first_site, threshold16, scale,
                                         first_index, run, row_stride, s)
                 : launch<float>(out, (size_t)n, n_masks, seed, first_site,
                                 threshold16, scale, first_index, run,
                                 row_stride, s);
}

}  // namespace

// K6. out: n contiguous, 16-byte aligned values (float32 or bfloat16). With
// row_stride 0: elements [first_index, first_index + n) of the site's mask;
// else n / run runs of `run`, local element i being element first_index +
// (i / run) row_stride + i % run of it (a channel window).
extern "C" int mulan_dropout_mask(void* out, long long n, unsigned seed,
                                  unsigned site, unsigned threshold16,
                                  float scale, unsigned long long first_index,
                                  unsigned long long run,
                                  unsigned long long row_stride, int is_bf16,
                                  void* stream) {
  return launch_masks(out, n, 1u, seed, site, threshold16, scale, first_index,
                      run, row_stride, is_bf16, stream);
}

// K7. out: n_masks * n contiguous values, 16-byte aligned; slot i holds
// K6's mask of site first_site + i at the same first_index, run and
// row_stride. n_masks <= 65535 (the grid's y extent).
extern "C" int mulan_dropout_mask_batch(void* out, long long n,
                                        unsigned n_masks, unsigned seed,
                                        unsigned first_site,
                                        unsigned threshold16, float scale,
                                        unsigned long long first_index,
                                        unsigned long long run,
                                        unsigned long long row_stride,
                                        int is_bf16, void* stream) {
  return launch_masks(out, n, n_masks, seed, first_site, threshold16, scale,
                      first_index, run, row_stride, is_bf16, stream);
}
