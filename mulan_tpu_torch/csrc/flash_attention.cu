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
// arithmetic (0.07 ms at 989 TFLOP/s), while the plain version moves the
// 512 MB f32 score matrix through HBM several times. Both kernels below keep
// the scores on chip with an online softmax (running row max m and sum l,
// rescaling the output accumulator), as the Pallas kernel does over its
// sequential k-grid. Rows and keys past T are masked, so any T works.
//
// Under autograd the caller passes `lse` (B*H, T) float32 and each kernel
// also writes the row log-sum-exp of the scaled logits, m + log l in natural
// log units, which the backward kernels (flash_attention_bwd.cu) read to
// recompute P = exp(s - lse); with lse null nothing extra is written, as the
// stock kernel saves its residuals only with save_residuals=True.
//
// Two routes, one C entry point each; ops/flash_attention.py picks one from
// (dtype, D):
// * mulan_flash_attention_fwd_sm90 (bf16, D <= 256): flash_fwd_sm90 at
//   D <= 128 (the flagship path), warp-specialised and persistent (one block
//   per SM walking 128-row query tiles). A block has one producer
//   warpgroup, whose single issuing thread loads each Q tile by TMA and
//   streams 128-key K and V tiles through a 3-stage ring of 128B-swizzled
//   shared memory (full and empty mbarriers), and two consumer warpgroups of
//   64 query rows each. A consumer computes S = Q K^T with wgmma m64n128k16
//   straight from the TMA tiles (SS form, both K-major), runs the online
//   softmax in exp2 units on the accumulator layout, packs P to bf16 in
//   registers as the A operand of O += P V (RS form), and reads V as the
//   MN-major B operand with the transpose bit, so no transposed copy of V
//   exists. S of the next tile is issued with P V of this one, so the
//   softmax runs while the tensor cores work; the copies run ahead of both,
//   across items too, and setmaxnreg moves registers from the producer to
//   the consumers. P is rounded to bf16 unnormalized for the second
//   product, as the plain version rounds its (normalized) softmax weights.
//   TMA fills rows past T and columns past D with zeros within the head
//   (3-D tensor maps), keys past T are masked to -inf, and only columns < D
//   are stored. At 128 < D <= 256 (imagenet32's head_dim 256)
//   flash_fwd_sm90_d256, the same design with 80-key tiles in 2-stage rings
//   that K and V pass through apart, and the products m64n80k16 and
//   m64n256k16, which fit the block's shared memory and the consumers'
//   registers (see there).
// * mulan_flash_attention_fwd_simt (float32 at any D): flash_fwd_simt, the
//   arithmetic on the CUDA cores in float32; every thread keeps a 4 x 4
//   tile of scores and a 4 x (D/16) tile of the output in registers, so
//   each shared-memory load feeds several FMAs, and P stays in float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

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
// sm90 route: bf16, D <= 128.

constexpr int kWgThreads = 128;
constexpr int kFwdRows = 128;   // query rows a block: 2 consumer warpgroups
constexpr int kFwdKeys = 128;   // keys a K/V tile
constexpr int kFwdStages = 3;   // K/V tiles in flight
constexpr int kFwdThreads = 3 * kWgThreads;  // producer + 2 consumers
constexpr int kConsumerWarps = 8;
// 128 x 24 + 256 x 240 registers fit the SM's 65,536.
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;

// Byte offsets in the block's shared memory, from a 1024-byte boundary.
// DPAD (64 or 128) is D rounded up to whole 64-column boxes.
template <int DPAD>
struct FwdLayout {
  static constexpr int kBoxes = DPAD / 64;
  static constexpr int kQBox = kFwdRows * 128;   // one 64-column box of Q
  static constexpr int kKVBox = kFwdKeys * 128;  // of a K or V tile
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kKVBytes = kBoxes * kKVBox;
  static constexpr int kK = kQBytes;                        // K ring
  static constexpr int kV = kK + kFwdStages * kKVBytes;     // V ring
  static constexpr int kBars = kV + kFwdStages * kKVBytes;  // mbarriers
  static constexpr int kSmem = kBars + 8 * (2 + 2 * kFwdStages) + 1024;
};

// S (64 x KEYS keys) = Q K^T for the consumer whose Q rows start at byte
// q_row of each Q box (ROWS rows a box): DPAD / 16 wgmma, SS form, both
// K-major.
template <int DPAD, int ROWS = kFwdRows, int KEYS = kFwdKeys>
__device__ __forceinline__ void issue_qk(float (&sc)[KEYS / 2],
                                         uint32_t q_tile, int q_row,
                                         uint32_t k_tile) {
#pragma unroll
  for (int ks = 0; ks < DPAD / 16; ++ks)
    sm90::wgmma_ss<0>(
        sc, sm90::desc_k_major(q_tile, ROWS * 128, q_row, ks),
        sm90::desc_k_major(k_tile, KEYS * 128, 0, ks), ks > 0);
}

// O += P V: P's bf16 A fragments, V the MN-major B operand (transpose bit).
template <int DPAD, int KEYS = kFwdKeys>
__device__ __forceinline__ void issue_pv(float (&acc)[DPAD / 2],
                                         const uint32_t (&pa)[KEYS / 16][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int ks = 0; ks < KEYS / 16; ++ks)
    sm90::wgmma_rs<1>(acc, pa[ks],
                      sm90::desc_mn_major(v_tile, KEYS * 128, ks), 1);
}

// The online softmax of one tile of scores (2 N keys), keys from key0, in
// place: keys past seq masked, the rows' running max m (log2 units of the
// scaled logits) and partial sums l updated, sc replaced by the
// unnormalized weights exp2(s scale_log2 - m), and alpha = exp2(m_old - m),
// the factor that brings the output so far to the new max. Rows g and g + 8
// of the warp's 16 (suffixes 0 and 1); a row's keys lie in the 4 threads of
// a quad, reduced by shuffles.
template <int N>
__device__ __forceinline__ void online_softmax(
    float (&sc)[N], int key0, int seq, int t4, float scale_log2, float& m0,
    float& m1, float& l0, float& l1, float& alpha0, float& alpha1) {
  const bool ragged = key0 + 2 * N > seq;
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    if (ragged) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (key0 + 8 * j + 2 * t4 + (e & 1) >= seq) sc[4 * j + e] = -INFINITY;
    }
    mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  // Finite: every tile holds a key < seq. scale_log2 > 0, so the max of
  // the scaled logits is the scaled max.
  const float new0 = fmaxf(m0, mx0 * scale_log2);
  const float new1 = fmaxf(m1, mx1 * scale_log2);
  alpha0 = exp2f(m0 - new0);
  alpha1 = exp2f(m1 - new1);
  m0 = new0;
  m1 = new1;
  float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    sc[4 * j] = exp2f(fmaf(sc[4 * j], scale_log2, -new0));
    sc[4 * j + 1] = exp2f(fmaf(sc[4 * j + 1], scale_log2, -new0));
    sc[4 * j + 2] = exp2f(fmaf(sc[4 * j + 2], scale_log2, -new1));
    sc[4 * j + 3] = exp2f(fmaf(sc[4 * j + 3], scale_log2, -new1));
    sum0 += sc[4 * j] + sc[4 * j + 1];
    sum1 += sc[4 * j + 2] + sc[4 * j + 3];
  }
  l0 = l0 * alpha0 + sum0;
  l1 = l1 * alpha1 + sum1;
}

// Chunks 2 ks and 2 ks + 1 of the scores' accumulator layout are, packed to
// bf16 pairs, the A fragment of keys [16 ks, 16 ks + 16).
template <int N>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[N / 8][4],
                                       const float (&sc)[N]) {
#pragma unroll
  for (int ks = 0; ks < N / 8; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[ks][r] = sm90::pack_bf16(sc[8 * ks + 2 * r], sc[8 * ks + 2 * r + 1]);
}

// Persistent: a block per SM walks the items (a 128-row query tile of one
// head) blockIdx.x, blockIdx.x + gridDim.x, ...; consecutive blocks take
// consecutive query tiles of a head, so its K and V stay in L2. The K/V
// ring runs on from one item into the next, and the Q tile is released as
// soon as the item's last S = Q K^T is done, so the next item's Q and
// first K/V tiles load while this item finishes its last P V and stores.
template <int DPAD>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap q_map,
               const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map,
               __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
               int n_items, int seq, int d, float scale_log2) {
  using L = FwdLayout<DPAD>;
  extern __shared__ uint8_t smem_tiles[];
  uint8_t* smem = sm90::align_1024(smem_tiles);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* q_empty = q_full + 1;       // both consumers done with Q
  uint64_t* full = q_empty + 1;         // [stage]: K and V tiles landed
  uint64_t* empty = full + kFwdStages;  // [stage]: both consumers done
  const int n_qtiles = (seq + kFwdRows - 1) / kFwdRows;
  const int n_tiles = (seq + kFwdKeys - 1) / kFwdKeys;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    sm90::mbar_init(q_empty, kConsumerWarps);
    for (int s = 0; s < kFwdStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kConsumerWarps);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int role = threadIdx.x / kWgThreads;  // warpgroup
  if (role == 0) {
    // Producer warpgroup; one thread issues every copy. n counts the K/V
    // tiles through the ring, `it` the items (Q tiles).
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int n = 0, it = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
        const int head = item / n_qtiles;
        const int q0 = item % n_qtiles * kFwdRows;
        sm90::mbar_wait(q_empty, (it & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(q_full, L::kQBytes);
        for (int b = 0; b < L::kBoxes; ++b)
          sm90::tma_load(smem + b * L::kQBox, &q_map, q_full, 64 * b, q0,
                         head);
        for (int i = 0; i < n_tiles; ++i, ++n) {
          const int s = n % kFwdStages;
          sm90::mbar_wait(&empty[s], ((n / kFwdStages) & 1) ^ 1);
          sm90::mbar_arrive_expect_tx(&full[s], 2 * L::kKVBytes);
          uint8_t* kt = smem + L::kK + s * L::kKVBytes;
          uint8_t* vt = smem + L::kV + s * L::kKVBytes;
          for (int b = 0; b < L::kBoxes; ++b) {
            sm90::tma_load(kt + b * L::kKVBox, &k_map, &full[s], 64 * b,
                           i * kFwdKeys, head);
            sm90::tma_load(vt + b * L::kKVBox, &v_map, &full[s], 64 * b,
                           i * kFwdKeys, head);
          }
        }
      }
    }
  } else {
    // Consumer warpgroup wg: query rows q0 + 64 wg + [0, 64) of each item.
    sm90::setmaxnreg_inc<kConsumerRegs>();
    const int wg = role - 1;
    const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t4 = lane % 4;
    const uint32_t q_tile = sm90::smem_u32(smem);
    const int q_row = wg * 64 * 128;  // this warpgroup's rows in a Q box
    auto k_tile = [&](int s) {
      return sm90::smem_u32(smem + L::kK + s * L::kKVBytes);
    };
    auto v_tile = [&](int s) {
      return sm90::smem_u32(smem + L::kV + s * L::kKVBytes);
    };
    // Arrive on a barrier once per consumer warp.
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(bar);
    };

    int n = 0, it = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
      const int head = item / n_qtiles;
      const int q0 = item % n_qtiles * kFwdRows;
      float acc[DPAD / 2];  // O, 64 x DPAD
#pragma unroll
      for (int r = 0; r < DPAD / 2; ++r) acc[r] = 0.0f;
      float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
      float alpha0, alpha1;
      float sc[kFwdKeys / 2];         // S of one tile, then its weights P
      uint32_t pa[kFwdKeys / 16][4];  // P in bf16, the A operand of P V

      // Tile 0: S, softmax, P.
      sm90::mbar_wait(q_full, it & 1);
      sm90::mbar_wait(&full[n % kFwdStages], (n / kFwdStages) & 1);
      sm90::wgmma_fence();
      issue_qk<DPAD>(sc, q_tile, q_row, k_tile(n % kFwdStages));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      if (n_tiles == 1) release(q_empty);
      online_softmax(sc, 0, seq, t4, scale_log2, m0, m1, l0, l1, alpha0,
                     alpha1);
      pack_p(pa, sc);
      // Tile i: S_i = Q K_i^T and O += P_{i-1} V_{i-1} are issued together;
      // the softmax of S_i runs while the tensor cores do P_{i-1} V_{i-1}.
      for (int i = 1; i < n_tiles; ++i) {
        const int s = (n + i) % kFwdStages, prev = (n + i - 1) % kFwdStages;
        sm90::mbar_wait(&full[s], ((n + i) / kFwdStages) & 1);
        sm90::wgmma_fence();
        issue_qk<DPAD>(sc, q_tile, q_row, k_tile(s));
        sm90::wgmma_commit();
        issue_pv<DPAD>(acc, pa, v_tile(prev));
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();  // S_i
        sm90::fence_regs(sc);
        if (i == n_tiles - 1) release(q_empty);
        online_softmax(sc, i * kFwdKeys, seq, t4, scale_log2, m0, m1, l0,
                       l1, alpha0, alpha1);
        sm90::wgmma_wait<0>();  // P_{i-1} V_{i-1}: stage prev is free
        sm90::fence_regs(acc);
        release(&empty[prev]);
#pragma unroll
        for (int j = 0; j < DPAD / 8; ++j) {
          acc[4 * j] *= alpha0;
          acc[4 * j + 1] *= alpha0;
          acc[4 * j + 2] *= alpha1;
          acc[4 * j + 3] *= alpha1;
        }
        pack_p(pa, sc);
      }
      const int last = (n + n_tiles - 1) % kFwdStages;
      sm90::wgmma_fence();
      issue_pv<DPAD>(acc, pa, v_tile(last));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      release(&empty[last]);
      n += n_tiles;

#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      const int row0 = q0 + wg * 64 + warp * 16 + g, row1 = row0 + 8;
      const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
      if (lse != nullptr && t4 == 0) {
        // m is in log2 units of the scaled logits: lse = m ln 2 + ln l.
        constexpr float kLn2 = 0.6931471805599453f;
        const size_t lrow = (size_t)head * seq;
        if (row0 < seq) lse[lrow + row0] = m0 * kLn2 + logf(l0);
        if (row1 < seq) lse[lrow + row1] = m1 * kLn2 + logf(l1);
      }
      const size_t base = (size_t)head * seq * d;
#pragma unroll
      for (int j = 0; j < DPAD / 8; ++j) {
        const int col = 8 * j + 2 * t4;
        if (col >= d) continue;
        if (row0 < seq)
          *reinterpret_cast<uint32_t*>(o + base + (size_t)row0 * d + col) =
              sm90::pack_bf16(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
        if (row1 < seq)
          *reinterpret_cast<uint32_t*>(o + base + (size_t)row1 * d + col) =
              sm90::pack_bf16(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
      }
    }
  }
}

// Encodes the three tensor maps (q, k, v; `rows` a box each, rows[0] the
// query rows of an item), gives `kernel` its shared memory and launches
// min(items, SMs) persistent blocks of `threads`.
template <typename Kernel>
int launch_persistent(Kernel kernel, int smem, int threads,
                      const int (&rows)[3], const void* q, const void* k,
                      const void* v, void* o, float* lse, int bh, int seq,
                      int d, float scale, cudaStream_t stream) {
  CUtensorMap maps[3];
  const void* srcs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const int err = sm90::make_map(&maps[i], srcs[i], bh, seq, d, rows[i]);
    if (err != 0) return err;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = sm90::sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const int n_items = (seq + rows[0] - 1) / rows[0] * bh;
  kernel<<<n_items < sms ? n_items : sms, threads, smem, stream>>>(
      maps[0], maps[1], maps[2], (__nv_bfloat16*)o, lse, n_items, seq, d,
      scale * kLog2e);  // exp2f in the kernel
  return (int)cudaGetLastError();
}

template <int DPAD>
int launch_sm90(const void* q, const void* k, const void* v, void* o,
                float* lse, int bh, int seq, int d, float scale,
                cudaStream_t stream) {
  const int rows[3] = {kFwdRows, kFwdKeys, kFwdKeys};
  return launch_persistent(flash_fwd_sm90<DPAD>, FwdLayout<DPAD>::kSmem,
                           kFwdThreads, rows, q, k, v, o, lse, bh, seq, d,
                           scale, stream);
}

// ---------------------------------------------------------------------------
// sm90 route at 128 < D <= 256: flash_fwd_sm90_d256.
//
// The kernel above at DPAD = 256 would need 64 KB for its 128-row Q tile and
// 384 KB for its 3-stage ring of 128-key K/V tiles, over a block's 227 KB.
// This one keeps the 128-row Q tile and its two consumer warpgroups of 64
// rows, and streams 80-key K and V tiles through rings of 2 stages each (64
// + 160 KB). A consumer thread holds O (64 x 256 float32: 128 registers), S
// of one tile (wgmma m64n80k16 over 16 k-steps: 40) and P's bf16 fragments
// (20); O += P V is one wgmma m64n256k16 a 16-key step (RS form, V the
// MN-major B operand across its four 64-column boxes), and S of tile i is
// issued with P V of tile i - 1, as above, so the softmax of one tile runs
// while the tensor cores do the other's product. K and V have barriers of
// their own: a K stage is released as soon as its S is done and a V stage
// once its P V is, so with 2 stages each copy still starts a whole tile
// before its product needs it. S reads its Q fragments from shared memory
// once a tile, so wider tiles read less a key: 80 keys (13 tiles at T =
// 1024, the last ragged) ran 5-8% faster than 64, and 2 stages of 96 or 128
// keys do not fit. Other candidates at (128, 1, 1024, 256)
// (ops/ablations/k1_fwd_d256.json), each against the same design: the
// consumers taking turns to issue (K3's ping-pong) 2-3% slower, one item a
// block 5-10%; against the 64-key design, no overlap within a warpgroup
// 3-5% slower, and one consumer of 64 rows, with 2 or 3 stages, 21-27% (it
// streams each head's K and V from L2 twice as often).
constexpr int kFwd256Consumers = 2;  // consumer warpgroups, 64 rows each
constexpr int kFwd256Keys = 80;      // keys a K or V tile
constexpr int kFwd256Stages = 2;     // K tiles, and V tiles, in flight
constexpr int kFwd256Rows = 64 * kFwd256Consumers;  // query rows an item
constexpr int kFwd256Threads = (1 + kFwd256Consumers) * kWgThreads;

struct Fwd256Layout {
  static constexpr int kBoxes = 4;
  static constexpr int kQBox = kFwd256Rows * 128;   // one 64-column box of Q
  static constexpr int kKVBox = kFwd256Keys * 128;  // of a K or V tile
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kKVBytes = kBoxes * kKVBox;
  static constexpr int kK = kQBytes;                           // K ring
  static constexpr int kV = kK + kFwd256Stages * kKVBytes;     // V ring
  static constexpr int kBars = kV + kFwd256Stages * kKVBytes;  // mbarriers
  static constexpr int kSmem = kBars + 8 * (2 + 4 * kFwd256Stages) + 1024;
};
static_assert(Fwd256Layout::kSmem <= 232448, "K1 at D <= 256: 227 KB");

// Persistent as the kernel above: items are kFwd256Rows-row query tiles,
// head-major, and the K/V rings run on from one item into the next. (Bounds
// of 384 threads keep ptxas's launch budget at or below the consumers'
// setmaxnreg for either number of consumers.)
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_fwd_sm90_d256(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    int n_items, int seq, int d, float scale_log2) {
  using L = Fwd256Layout;
  constexpr int kStages = kFwd256Stages;
  constexpr int kWarps = 4 * kFwd256Consumers;
  extern __shared__ uint8_t smem_tiles[];
  uint8_t* smem = sm90::align_1024(smem_tiles);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* q_empty = q_full + 1;       // all consumers done with Q
  uint64_t* k_full = q_empty + 1;       // [stage]: a K tile landed
  uint64_t* k_empty = k_full + kStages;  // [stage]: all consumers' S done
  uint64_t* v_full = k_empty + kStages;  // [stage]: a V tile landed
  uint64_t* v_empty = v_full + kStages;  // [stage]: all consumers' P V done
  const int n_qtiles = (seq + kFwd256Rows - 1) / kFwd256Rows;
  const int n_tiles = (seq + kFwd256Keys - 1) / kFwd256Keys;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    sm90::mbar_init(q_empty, kWarps);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&k_full[s], 1);
      sm90::mbar_init(&k_empty[s], kWarps);
      sm90::mbar_init(&v_full[s], 1);
      sm90::mbar_init(&v_empty[s], kWarps);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  // The stage of the n-th K (and V) tile through the rings, and the parity
  // of the barrier phase that marks it full (its wait for the stage to be
  // empty takes the other parity).
  auto slot = [](int n) { return n % kStages; };
  auto phase = [](int n) { return (uint32_t)(n / kStages) & 1; };
  const int role = threadIdx.x / kWgThreads;  // warpgroup
  if (role == 0) {
    // Producer warpgroup; one thread issues every copy, K before V of each
    // tile.
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int n = 0, it = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
        const int head = item / n_qtiles;
        const int q0 = item % n_qtiles * kFwd256Rows;
        sm90::mbar_wait(q_empty, (it & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(q_full, L::kQBytes);
        for (int b = 0; b < L::kBoxes; ++b)
          sm90::tma_load(smem + b * L::kQBox, &q_map, q_full, 64 * b, q0,
                         head);
        for (int i = 0; i < n_tiles; ++i, ++n) {
          const int s = slot(n);
          const int key0 = i * kFwd256Keys;
          sm90::mbar_wait(&k_empty[s], phase(n) ^ 1);
          sm90::mbar_arrive_expect_tx(&k_full[s], L::kKVBytes);
          for (int b = 0; b < L::kBoxes; ++b)
            sm90::tma_load(smem + L::kK + s * L::kKVBytes + b * L::kKVBox,
                           &k_map, &k_full[s], 64 * b, key0, head);
          sm90::mbar_wait(&v_empty[s], phase(n) ^ 1);
          sm90::mbar_arrive_expect_tx(&v_full[s], L::kKVBytes);
          for (int b = 0; b < L::kBoxes; ++b)
            sm90::tma_load(smem + L::kV + s * L::kKVBytes + b * L::kKVBox,
                           &v_map, &v_full[s], 64 * b, key0, head);
        }
      }
    }
  } else {
    // Consumer warpgroup wg: query rows q0 + 64 wg + [0, 64) of each item.
    sm90::setmaxnreg_inc<kConsumerRegs>();
    const int wg = role - 1;
    const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t4 = lane % 4;
    const uint32_t q_tile = sm90::smem_u32(smem);
    const int q_row = wg * 64 * 128;  // this warpgroup's rows in a Q box
    auto k_tile = [&](int n) {
      return sm90::smem_u32(smem + L::kK + slot(n) * L::kKVBytes);
    };
    auto v_tile = [&](int n) {
      return sm90::smem_u32(smem + L::kV + slot(n) * L::kKVBytes);
    };
    // Arrive on a barrier once per consumer warp.
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(bar);
    };

    int n = 0, it = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
      const int head = item / n_qtiles;
      const int q0 = item % n_qtiles * kFwd256Rows;
      float acc[128];  // O, 64 x 256
#pragma unroll
      for (int r = 0; r < 128; ++r) acc[r] = 0.0f;
      float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
      float alpha0, alpha1;
      float sc[kFwd256Keys / 2];         // S of one tile, then its weights P
      uint32_t pa[kFwd256Keys / 16][4];  // P in bf16, the A operand of P V

      // Tile 0: S, softmax, P.
      sm90::mbar_wait(q_full, it & 1);
      sm90::mbar_wait(&k_full[slot(n)], phase(n));
      sm90::wgmma_fence();
      issue_qk<256, kFwd256Rows, kFwd256Keys>(sc, q_tile, q_row, k_tile(n));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      release(&k_empty[slot(n)]);
      if (n_tiles == 1) release(q_empty);
      online_softmax(sc, 0, seq, t4, scale_log2, m0, m1, l0, l1, alpha0,
                     alpha1);
      pack_p(pa, sc);
      // Tile i: S_i = Q K_i^T and O += P_{i-1} V_{i-1} are issued together;
      // the softmax of S_i runs while the tensor cores do P_{i-1} V_{i-1}.
      for (int i = 1; i < n_tiles; ++i) {
        const int cur = n + i, prev = n + i - 1;
        sm90::mbar_wait(&k_full[slot(cur)], phase(cur));
        sm90::mbar_wait(&v_full[slot(prev)], phase(prev));
        sm90::wgmma_fence();
        issue_qk<256, kFwd256Rows, kFwd256Keys>(sc, q_tile, q_row,
                                                k_tile(cur));
        sm90::wgmma_commit();
        issue_pv<256, kFwd256Keys>(acc, pa, v_tile(prev));
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();  // S_i: its K stage is free
        sm90::fence_regs(sc);
        release(&k_empty[slot(cur)]);
        if (i == n_tiles - 1) release(q_empty);
        online_softmax(sc, i * kFwd256Keys, seq, t4, scale_log2, m0, m1, l0,
                       l1, alpha0, alpha1);
        sm90::wgmma_wait<0>();  // P_{i-1} V_{i-1}: its V stage is free
        sm90::fence_regs(acc);
        release(&v_empty[slot(prev)]);
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          acc[4 * j] *= alpha0;
          acc[4 * j + 1] *= alpha0;
          acc[4 * j + 2] *= alpha1;
          acc[4 * j + 3] *= alpha1;
        }
        pack_p(pa, sc);
      }
      const int last = n + n_tiles - 1;
      sm90::mbar_wait(&v_full[slot(last)], phase(last));
      sm90::wgmma_fence();
      issue_pv<256, kFwd256Keys>(acc, pa, v_tile(last));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      release(&v_empty[slot(last)]);
      n += n_tiles;

#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      const int row0 = q0 + wg * 64 + warp * 16 + g, row1 = row0 + 8;
      const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
      if (lse != nullptr && t4 == 0) {
        // m is in log2 units of the scaled logits: lse = m ln 2 + ln l.
        constexpr float kLn2 = 0.6931471805599453f;
        const size_t lrow = (size_t)head * seq;
        if (row0 < seq) lse[lrow + row0] = m0 * kLn2 + logf(l0);
        if (row1 < seq) lse[lrow + row1] = m1 * kLn2 + logf(l1);
      }
      const size_t base = (size_t)head * seq * d;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = 8 * j + 2 * t4;
        if (col >= d) continue;
        if (row0 < seq)
          *reinterpret_cast<uint32_t*>(o + base + (size_t)row0 * d + col) =
              sm90::pack_bf16(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
        if (row1 < seq)
          *reinterpret_cast<uint32_t*>(o + base + (size_t)row1 * d + col) =
              sm90::pack_bf16(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
      }
    }
  }
}

int launch_sm90_d256(const void* q, const void* k, const void* v, void* o,
                     float* lse, int bh, int seq, int d, float scale,
                     cudaStream_t stream) {
  const int rows[3] = {kFwd256Rows, kFwd256Keys, kFwd256Keys};
  return launch_persistent(flash_fwd_sm90_d256, Fwd256Layout::kSmem,
                           kFwd256Threads, rows, q, k, v, o, lse, bh, seq, d,
                           scale, stream);
}

}  // namespace

// q, k, v, o: (bh, seq, d) bf16 with d % 8 == 0 and d <= 256.
extern "C" int mulan_flash_attention_fwd_sm90(const void* q, const void* k,
                                              const void* v, void* o,
                                              void* lse, int bh, int seq,
                                              int d, float scale,
                                              void* stream) {
  // Items of 64 rows bound those of both kernels.
  if (bh <= 0 || seq <= 0 || d <= 0 || d > 256 || d % 8 != 0 ||
      (long long)((seq + 63) / 64) * bh > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* l = (float*)lse;  // may be null: no residual wanted
  if (d > 128)
    return launch_sm90_d256(q, k, v, o, l, bh, seq, d, scale, s);
  if (d <= 64) return launch_sm90<64>(q, k, v, o, l, bh, seq, d, scale, s);
  return launch_sm90<128>(q, k, v, o, l, bh, seq, d, scale, s);
}

// q, k, v, o: (bh, seq, d) float32 or bf16 with d % 8 == 0 and d <= 256.
extern "C" int mulan_flash_attention_fwd_simt(const void* q, const void* k,
                                              const void* v, void* o,
                                              void* lse, int bh, int seq,
                                              int d, float scale, int is_bf16,
                                              void* stream) {
  if (bh <= 0 || seq <= 0 || d <= 0 || d > 256 || d % 8 != 0 ||
      (seq + kBlockM - 1) / kBlockM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* l = (float*)lse;
  if (is_bf16)
    return dispatch_simt<__nv_bfloat16>(q, k, v, o, l, bh, seq, d, scale, s);
  return dispatch_simt<float>(q, k, v, o, l, bh, seq, d, scale, s);
}
