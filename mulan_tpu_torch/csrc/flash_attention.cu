// Flash-attention forward for Hopper (sm_90a): o = softmax(scale q k^T) v.
//
// Replaces the stock Pallas TPU kernel
// jax.experimental.pallas.ops.tpu.flash_attention._flash_attention, which
// mulan_tpu/ops/flash_bwd.py:_flash_attention (and its _fwd) call for the
// UNet's and the encoder's mid attention. Bidirectional: no mask, bias or
// segments. Layout (B, H, T, D), contiguous; float32 or bfloat16 in and out,
// float32 accumulation and softmax statistics.
//
// What bounds it on the H100: at the flagship shape (B=128, H=1, T=1024,
// D=128, bf16) the work is 2 * 2 * B * T^2 * D = 69 GFLOP against 100 MB of
// q/k/v/o, so a kernel that keeps the (T, T) scores on chip is bound by
// arithmetic, while the plain version moves the 512 MB f32 score matrix
// through HBM several times. Both kernels below keep the scores on chip: a
// block owns 64 query rows and walks 64-key K/V tiles staged in shared
// memory with an online softmax (running row max m and sum l, rescaling the
// output accumulator), as the Pallas kernel does over its sequential k-grid.
// Rows and keys past T are masked, so any T works.
//
// Under autograd the caller passes `lse` (B*H, T) float32 and each kernel
// also writes the row log-sum-exp of the scaled logits, m + log l in natural
// log units, which the backward kernels (flash_attention_bwd.cu) read to
// recompute P = exp(s - lse); with lse null nothing extra is written, as the
// stock kernel saves its residuals only with save_residuals=True.
//
// * flash_fwd_mma (bf16, D <= 128, the flagship path): the two products run
//   on the tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate).
//   Each of 4 warps owns 16 query rows; its Q fragments stay in registers,
//   and the score accumulators are re-packed in registers as the bf16 A
//   operand of P V, so P never touches shared memory. V is stored
//   transposed in shared memory so that its B fragments are 32-bit loads.
//   P is rounded to bf16 for the second product, as the plain version
//   rounds its softmax weights.
// * flash_fwd_simt (float32, and bf16 with D > 128): the arithmetic runs on
//   the CUDA cores in float32; every thread keeps a 4 x 4 tile of scores and
//   a 4 x (D/16) tile of the output in registers, so each shared-memory load
//   feeds several FMAs, and P stays in float32.
//
// Later work: wgmma and TMA-fed, pipelined tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;   // query rows per block
constexpr int kBlockN = 64;   // keys per K/V tile
constexpr int kThreads = 256; // a 16 x 16 grid: thread (ty, tx)
constexpr int kLdP = kBlockN + 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
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

// Thread (ty, tx) owns query rows ty + 16 i (i < 4), score columns
// tx + 16 j (j < 4) of each K tile, and output columns tx + 16 c (c < DMAX/16).
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_simt(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o,
               float* __restrict__ lse, int seq, int d, float scale) {
  constexpr int kCols = DMAX / 16;
  extern __shared__ float smem[];
  const int ld = d + 1;  // odd row stride: a column walk hits distinct banks
  float* qs = smem;                   // [kBlockM][ld], pre-scaled
  float* ks = qs + kBlockM * ld;      // [kBlockN][ld]
  float* vs = ks + kBlockN * ld;      // [kBlockN][ld]
  float* ps = vs + kBlockN * ld;      // [kBlockM][kLdP]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const size_t base = (size_t)blockIdx.x * seq * d;
  const int q0 = blockIdx.y * kBlockM;

  for (int i = tid; i < kBlockM * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    const int row = q0 + r;
    qs[r * ld + c] =
        row < seq ? to_f32(q[base + (size_t)row * d + c]) * scale : 0.0f;
  }

  float acc[4][kCols];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  for (int k0 = 0; k0 < seq; k0 += kBlockN) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBlockN * d; i += kThreads) {
      const int r = i / d, c = i - r * d;
      const int row = k0 + r;
      const size_t off = base + (size_t)row * d + c;
      ks[r * ld + c] = row < seq ? to_f32(k[off]) : 0.0f;
      vs[r * ld + c] = row < seq ? to_f32(v[off]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int c = 0; c < d; ++c) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * ld + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ks[(tx + 16 * j) * ld + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

    // Online softmax. The 16 threads sharing a row are the 16 lanes of one
    // half-warp, so xor-shuffles over offsets 8..1 reduce exactly that row.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (k0 + tx + 16 * j >= seq) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);  // finite: key k0 is valid
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * kLdP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int j = 0; j < kBlockN; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * kLdP + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = tx + 16 * c;
        const float vv = col < d ? vs[j * ld + col] : 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= seq) continue;
    const float inv_l = 1.0f / l[i];
    if (lse != nullptr && tx == 0)
      lse[(size_t)blockIdx.x * seq + row] = m[i] + logf(l[i]);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < d)
        o[base + (size_t)row * d + col] = from_f32<T>(acc[i][c] * inv_l);
    }
  }
}

template <typename T, int DMAX>
int launch_simt(const void* q, const void* k, const void* v, void* o,
                float* lse, int bh, int seq, int d, float scale,
                cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(kBlockM + 2 * kBlockN) * (d + 1) +
                       (size_t)kBlockM * kLdP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_simt<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, (seq + kBlockM - 1) / kBlockM);
  flash_fwd_simt<T, DMAX><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, seq, d, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_simt(const void* q, const void* k, const void* v, void* o,
                  float* lse, int bh, int seq, int d, float scale,
                  cudaStream_t stream) {
  if (d <= 64)
    return launch_simt<T, 64>(q, k, v, o, lse, bh, seq, d, scale, stream);
  if (d <= 128)
    return launch_simt<T, 128>(q, k, v, o, lse, bh, seq, d, scale, stream);
  return launch_simt<T, 256>(q, k, v, o, lse, bh, seq, d, scale, stream);
}

// ---------------------------------------------------------------------------
// Tensor-core path: bf16, D <= 128.

constexpr int kMmaThreads = 128;  // 4 warps x 16 query rows
constexpr int kPad = 8;           // bf16 of row padding: rows stay 16-byte
                                  // aligned and fragment loads hit distinct
                                  // banks
constexpr int kLdV = kBlockN + kPad;

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a b on one 16 x 8 x 16 tile: bf16 in, f32 accumulators. Fragment
// layouts (PTX ISA, mma.m16n8k16), with g = lane / 4 and t = lane % 4:
// a = A[g][2t..], A[g+8][2t..], A[g][2t+8..], A[g+8][2t+8..];
// b = B[2t..][g], B[2t+8..][g]; d = D[g][2t..], D[g+8][2t..].
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copies rows [row0, row0 + 64) of a (seq, d) bf16 matrix into a (64, ld)
// shared tile in 16-byte chunks, zero past seq and past d (up to d16).
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, int ld,
                                          const __nv_bfloat16* src, int row0,
                                          int seq, int d, int d16) {
  const int chunks = d16 / 8;
  for (int i = threadIdx.x; i < 64 * chunks; i += kMmaThreads) {
    const int r = i / chunks, c = i - r * chunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < seq && c * 8 < d)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * d +
                                            c * 8);
    *reinterpret_cast<uint4*>(dst + r * ld + c * 8) = val;
  }
}

template <int DMAX>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
              int seq, int d, float scale_log2) {
  constexpr int kSteps = DMAX / 16;  // k-steps of Q K^T
  constexpr int kOut = DMAX / 8;     // 8-column tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d16 = (d + 15) & ~15;
  const int ldk = d16 + kPad;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBlockM * ldk;  // [kBlockN][ldk]
  __nv_bfloat16* vt = ks + kBlockN * ldk;  // [d][kLdV]: V transposed

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t base = (size_t)blockIdx.x * seq * d;
  const int q0 = blockIdx.y * kBlockM;
  const int n_steps = d16 / 16;
  const int n_out = d / 8;

  load_rows(qs, ldk, q + base, q0, seq, d, d16);
  __syncthreads();
  uint32_t qa[kSteps][4];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const __nv_bfloat16* p0 = qs + (warp * 16 + g) * ldk + s * 16 + t4 * 2;
    const __nv_bfloat16* p1 = p0 + 8 * ldk;
    const bool on = s < n_steps;
    qa[s][0] = on ? ld32(p0) : 0u;
    qa[s][1] = on ? ld32(p1) : 0u;
    qa[s][2] = on ? ld32(p0 + 8) : 0u;
    qa[s][3] = on ? ld32(p1 + 8) : 0u;
  }

  float acc[kOut][4];
#pragma unroll
  for (int n = 0; n < kOut; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  // Rows g and g + 8 of this warp's 16: running max (log2 units) and the
  // partial sum over this thread's columns (summed over the quad at the end).
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

  for (int k0 = 0; k0 < seq; k0 += kBlockN) {
    __syncthreads();  // the previous tile's readers are done
    load_rows(ks, ldk, k + base, k0, seq, d, d16);
    // V^T: consecutive threads take consecutive rows, so one warp's 2-byte
    // stores fall in distinct banks.
    for (int i = threadIdx.x; i < kBlockN * n_out; i += kMmaThreads) {
      const int r = i % kBlockN, c = i / kBlockN;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < seq)
        val = *reinterpret_cast<const uint4*>(v + base + (size_t)(k0 + r) * d +
                                              c * 8);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt[(c * 8 + j) * kLdV + r] = e[j];
    }
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        if (st < n_steps) {
          const __nv_bfloat16* p = ks + (n * 8 + g) * ldk + st * 16 + t4 * 2;
          mma_bf16(s[n], qa[st], ld32(p), ld32(p + 8));
        }
      }
    }

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + t4 * 2 + (e & 1);
        s[n][e] = col < seq ? s[n][e] * scale_log2 : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float new0 = fmaxf(m0, mx0), new1 = fmaxf(m1, mx1);  // finite
    const float alpha0 = exp2f(m0 - new0), alpha1 = exp2f(m1 - new1);
    m0 = new0;
    m1 = new1;
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = exp2f(s[n][0] - new0);
      s[n][1] = exp2f(s[n][1] - new0);
      s[n][2] = exp2f(s[n][2] - new1);
      s[n][3] = exp2f(s[n][3] - new1);
      sum0 += s[n][0] + s[n][1];
      sum1 += s[n][2] + s[n][3];
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int n = 0; n < kOut; ++n) {
      acc[n][0] *= alpha0;
      acc[n][1] *= alpha0;
      acc[n][2] *= alpha1;
      acc[n][3] *= alpha1;
    }

    // O += P V. The score accumulators of tiles 2j and 2j + 1 are, element
    // for element, the A fragment of keys [16 j, 16 j + 16).
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int n = 0; n < kOut; ++n) {
        if (n < n_out) {
          const __nv_bfloat16* p = vt + (n * 8 + g) * kLdV + j * 16 + t4 * 2;
          mma_bf16(acc[n], pa, ld32(p), ld32(p + 8));
        }
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
  if (lse != nullptr && t4 == 0) {
    // m is in log2 units of the scaled logits: lse = m ln 2 + ln l.
    constexpr float kLn2 = 0.6931471805599453f;
    const size_t lrow = (size_t)blockIdx.x * seq;
    if (row0 < seq) lse[lrow + row0] = m0 * kLn2 + logf(l0);
    if (row1 < seq) lse[lrow + row1] = m1 * kLn2 + logf(l1);
  }
#pragma unroll
  for (int n = 0; n < kOut; ++n) {
    if (n >= n_out) continue;
    const int col = n * 8 + t4 * 2;
    if (row0 < seq)
      *reinterpret_cast<uint32_t*>(o + base + (size_t)row0 * d + col) =
          pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    if (row1 < seq)
      *reinterpret_cast<uint32_t*>(o + base + (size_t)row1 * d + col) =
          pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

template <int DMAX>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               float* lse, int bh, int seq, int d, float scale,
               cudaStream_t stream) {
  const int ldk = ((d + 15) & ~15) + kPad;
  const size_t smem = sizeof(__nv_bfloat16) *
                      ((size_t)(kBlockM + kBlockN) * ldk + (size_t)d * kLdV);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, (seq + kBlockM - 1) / kBlockM);
  flash_fwd_mma<DMAX><<<grid, kMmaThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, lse, seq, d,
      scale * 1.4426950408889634f);  // log2(e): exp2f in the kernel
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mulan_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* o, void* lse,
                                         int bh, int seq, int d, float scale,
                                         int is_bf16, void* stream) {
  if (bh <= 0 || seq <= 0 || d <= 0 || d > 256 || d % 8 != 0 ||
      (seq + kBlockM - 1) / kBlockM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* l = (float*)lse;  // may be null: no residual wanted
  if (!is_bf16)
    return dispatch_simt<float>(q, k, v, o, l, bh, seq, d, scale, s);
  if (d <= 64) return launch_mma<64>(q, k, v, o, l, bh, seq, d, scale, s);
  if (d <= 128) return launch_mma<128>(q, k, v, o, l, bh, seq, d, scale, s);
  return dispatch_simt<__nv_bfloat16>(q, k, v, o, l, bh, seq, d, scale, s);
}
