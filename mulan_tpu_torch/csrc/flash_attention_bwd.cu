// Flash-attention backward for Hopper (sm_90a): dQ, dK and dV of
// o = softmax(scale q k^T) v, given dO, the forward's row log-sum-exp
// lse = log sum_k exp(s_qk) (flash_attention.cu writes it under autograd)
// and di = rowsum(o * dO), which the wrapper computes in PyTorch as the JAX
// package does in XLA (mulan_tpu/ops/flash_bwd.py:302).
//
// Replaces the two Pallas TPU kernels of mulan_tpu/ops/flash_bwd.py:
//   * K2, dK and dV <- _dkv_kernel via _bwd_dkv: a block owns a tile of
//     keys, keeps its dK and dV accumulators in registers and walks every
//     query tile, recomputing P = exp(s - lse), dP = dO V^T and
//     dS = P (dP - di); dV += P^T dO, dK += scale dS^T Q.
//   * K3, dQ <- _dq_kernel via _bwd_dq: a block owns a tile of queries and
//     walks every key tile; dQ += scale dS K.
// The TPU carries its accumulators in VMEM scratch across a sequential grid
// axis; here each block loops over the other axis itself, so blocks are
// independent and the result is deterministic: no atomics, no second pass.
// Layout (B, H, T, D), contiguous; float32 or bfloat16 in and out, float32
// accumulation.
//
// What bounds it on the H100: at the flagship shape (B=128, H=1, T=1024,
// D=128, bf16) K2 does four T x T x D products a head (137 GFLOP, 0.14 ms at
// 989 TFLOP/s) and K3 three (103 GFLOP) against ~170 MB of inputs and
// outputs, so both are bound by arithmetic, and the (T, T) matrices never
// leave the chip. One C entry point per route; ops/flash_attention.py picks
// it from (dtype, D):
// * K2, bf16 with D <= 128 (mulan_flash_attention_bwd_dkv_sm90, the flagship
//   path): flash_bwd_dkv_sm90, warp-specialised and persistent (one block
//   per SM walking 128-key tiles). A block has one producer warpgroup,
//   whose first warp loads each K and V tile by TMA and streams 64-query Q
//   and dO tiles through a 2-stage ring of 128B-swizzled shared memory (one
//   thread issues the TMA copies; the warp stages the tile's lse and di rows
//   beside them), and two consumer warpgroups of 64 keys each. Per query
//   tile a consumer computes, in the transposed frame, S^T = K Q^T and
//   dP^T = V dO^T with wgmma m64n64k16 (SS form, all K-major, straight from
//   the TMA tiles), then P^T = exp2(S^T scale log2 e - lse log2 e) and
//   dS^T = P^T (dP^T - di) on the accumulator layout, packs both to bf16 in
//   registers (as the Pallas kernel casts them to the input type) and
//   accumulates dV += P^T dO and dK += dS^T Q in the RS form, reading dO and
//   Q MN-major with the transpose bit from the same swizzled tiles: no
//   transposed copies. dK is scaled by `scale` once at the end. TMA fills
//   rows past T and columns past D with zeros within the head (3-D tensor
//   maps), queries past T get P = 0, and only rows < T and columns < D are
//   stored.
// * K3, bf16 with D <= 128 (mulan_flash_attention_bwd_dq_sm90):
//   flash_bwd_dq_mma, on the tensor cores with mma.sync m16n8k16 (bf16 in,
//   f32 accumulate). Each of 4 warps owns 16 of the block's 64 queries; the
//   score and dP accumulators of two adjacent 8-column tiles are, element
//   for element, the A fragment of dS K, so dS is re-packed in registers as
//   bf16 and never stored; K is staged transposed in shared memory so that
//   its B fragments are 32-bit loads.
// * float32, and bf16 with D > 128 (mulan_flash_attention_bwd_{dkv,dq}_simt):
//   the arithmetic runs on the CUDA cores in float32 (67 TFLOP/s peak):
//   every thread keeps an R x R tile of scores and an R x (DMAX/16) tile of
//   each accumulator in registers, so each shared-memory load feeds several
//   FMAs. Tiles are 64 rows for D <= 128 and 32 rows for D <= 256 (the
//   float32 staging must fit in 227 KB of shared memory).
// Rows and keys past T are masked, so any T works.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid: thread (ty, tx)

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

// Rows [row0, row0 + BLK) of a (seq, d) matrix into a (BLK, ld) float32
// shared tile, zero past seq.
template <typename T, int BLK>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const T* __restrict__ src,
                                          int row0, int seq, int d) {
  for (int i = threadIdx.x; i < BLK * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    dst[r * ld + c] =
        row0 + r < seq ? to_f32(src[(size_t)(row0 + r) * d + c]) : 0.0f;
  }
}

// BLK float32 row statistics (lse or di) from row0, zero past seq.
template <int BLK>
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          int row0, int seq) {
  for (int i = threadIdx.x; i < BLK; i += kThreads)
    dst[i] = row0 + i < seq ? src[row0 + i] : 0.0f;
}

template <int BLK>
size_t smem_bytes(int d) {
  return sizeof(float) * ((size_t)4 * BLK * (d + 1) +
                          (size_t)2 * BLK * (BLK + 1) + 2 * BLK);
}

// K2. Thread (ty, tx) owns keys ty + 16 i and queries tx + 16 j (i, j < R)
// of each score tile, and output columns tx + 16 c (c < DMAX / 16).
template <typename T, int DMAX, int BLK>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ di,
              T* __restrict__ dk, T* __restrict__ dv, int seq, int d,
              float scale) {
  constexpr int R = BLK / 16;
  constexpr int C = DMAX / 16;
  extern __shared__ float smem[];
  const int ld = d + 1;  // odd row stride: a column walk hits distinct banks
  const int ldp = BLK + 1;
  float* ks = smem;                 // [BLK keys][ld]
  float* vs = ks + BLK * ld;        // [BLK keys][ld]
  float* qs = vs + BLK * ld;        // [BLK queries][ld]
  float* dos = qs + BLK * ld;       // [BLK queries][ld]
  float* pt = dos + BLK * ld;       // [BLK keys][ldp]: P^T
  float* dst = pt + BLK * ldp;      // [BLK keys][ldp]: scale dS^T
  float* lse_s = dst + BLK * ldp;   // [BLK queries]
  float* di_s = lse_s + BLK;        // [BLK queries]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t base = (size_t)blockIdx.x * seq * d;
  const size_t rows = (size_t)blockIdx.x * seq;
  const int k0 = blockIdx.y * BLK;
  load_tile<T, BLK>(ks, ld, k + base, k0, seq, d);
  load_tile<T, BLK>(vs, ld, v + base, k0, seq, d);

  float acc_k[R][C], acc_v[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) acc_k[i][c] = acc_v[i][c] = 0.0f;

  for (int q0 = 0; q0 < seq; q0 += BLK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, BLK>(qs, ld, q + base, q0, seq, d);
    load_tile<T, BLK>(dos, ld, dout + base, q0, seq, d);
    load_rows<BLK>(lse_s, lse + rows, q0, seq);
    load_rows<BLK>(di_s, di + rows, q0, seq);
    __syncthreads();

    float s[R][R], dp[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.0f;
    for (int c = 0; c < d; ++c) {
      float kk[R], vv[R], qq[R], oo[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        kk[i] = ks[(ty + 16 * i) * ld + c];
        vv[i] = vs[(ty + 16 * i) * ld + c];
        qq[i] = qs[(tx + 16 * i) * ld + c];
        oo[i] = dos[(tx + 16 * i) * ld + c];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          s[i][j] = fmaf(kk[i], qq[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], oo[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const bool key_ok = k0 + ty + 16 * i < seq;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int qj = tx + 16 * j;
        const float p = key_ok && q0 + qj < seq
                            ? expf(fmaf(s[i][j], scale, -lse_s[qj]))
                            : 0.0f;
        pt[(ty + 16 * i) * ldp + qj] = p;
        dst[(ty + 16 * i) * ldp + qj] = p * (dp[i][j] - di_s[qj]) * scale;
      }
    }
    __syncthreads();

    for (int j = 0; j < BLK; ++j) {
      float pp[R], ss[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        pp[i] = pt[(ty + 16 * i) * ldp + j];
        ss[i] = dst[(ty + 16 * i) * ldp + j];
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int col = tx + 16 * c;
        const float oo = col < d ? dos[j * ld + col] : 0.0f;
        const float qq = col < d ? qs[j * ld + col] : 0.0f;
#pragma unroll
        for (int i = 0; i < R; ++i) {
          acc_v[i][c] = fmaf(pp[i], oo, acc_v[i][c]);
          acc_k[i][c] = fmaf(ss[i], qq, acc_k[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= seq) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = tx + 16 * c;
      if (col < d) {
        dk[base + (size_t)row * d + col] = from_f32<T>(acc_k[i][c]);
        dv[base + (size_t)row * d + col] = from_f32<T>(acc_v[i][c]);
      }
    }
  }
}

// K3. Thread (ty, tx) owns queries ty + 16 i and keys tx + 16 j of each
// score tile, and output columns tx + 16 c.
template <typename T, int DMAX, int BLK>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ di,
             T* __restrict__ dq, int seq, int d, float scale) {
  constexpr int R = BLK / 16;
  constexpr int C = DMAX / 16;
  extern __shared__ float smem[];
  const int ld = d + 1;
  const int ldp = BLK + 1;
  float* qs = smem;                 // [BLK queries][ld]
  float* dos = qs + BLK * ld;       // [BLK queries][ld]
  float* ks = dos + BLK * ld;       // [BLK keys][ld]
  float* vs = ks + BLK * ld;        // [BLK keys][ld]
  float* dss = vs + BLK * ld;       // [BLK queries][ldp]: scale dS
  float* lse_s = dss + 2 * BLK * ldp;  // (the P^T slot of K2 is unused)
  float* di_s = lse_s + BLK;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t base = (size_t)blockIdx.x * seq * d;
  const size_t rows = (size_t)blockIdx.x * seq;
  const int q0 = blockIdx.y * BLK;
  load_tile<T, BLK>(qs, ld, q + base, q0, seq, d);
  load_tile<T, BLK>(dos, ld, dout + base, q0, seq, d);
  load_rows<BLK>(lse_s, lse + rows, q0, seq);
  load_rows<BLK>(di_s, di + rows, q0, seq);

  float acc[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.0f;

  for (int k0 = 0; k0 < seq; k0 += BLK) {
    __syncthreads();
    load_tile<T, BLK>(ks, ld, k + base, k0, seq, d);
    load_tile<T, BLK>(vs, ld, v + base, k0, seq, d);
    __syncthreads();

    float s[R][R], dp[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.0f;
    for (int c = 0; c < d; ++c) {
      float qq[R], oo[R], kk[R], vv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        qq[i] = qs[(ty + 16 * i) * ld + c];
        oo[i] = dos[(ty + 16 * i) * ld + c];
        kk[i] = ks[(tx + 16 * i) * ld + c];
        vv[i] = vs[(tx + 16 * i) * ld + c];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          s[i][j] = fmaf(qq[i], kk[j], s[i][j]);
          dp[i][j] = fmaf(oo[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qi = ty + 16 * i;
      const bool q_ok = q0 + qi < seq;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int kj = tx + 16 * j;
        const float p = q_ok && k0 + kj < seq
                            ? expf(fmaf(s[i][j], scale, -lse_s[qi]))
                            : 0.0f;
        dss[qi * ldp + kj] = p * (dp[i][j] - di_s[qi]) * scale;
      }
    }
    __syncthreads();

    for (int j = 0; j < BLK; ++j) {
      float ss[R];
#pragma unroll
      for (int i = 0; i < R; ++i) ss[i] = dss[(ty + 16 * i) * ldp + j];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int col = tx + 16 * c;
        const float kk = col < d ? ks[j * ld + col] : 0.0f;
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][c] = fmaf(ss[i], kk, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= seq) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = tx + 16 * c;
      if (col < d) dq[base + (size_t)row * d + col] = from_f32<T>(acc[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core path: bf16, D <= 128.

constexpr int kMmaThreads = 128;  // 4 warps x 16 rows
constexpr int kRows = 64;         // rows (keys or queries) per tile
constexpr int kPad = 8;           // bf16 of row padding: rows stay 16-byte
                                  // aligned and fragment loads hit distinct
                                  // banks
constexpr int kLdT = kRows + kPad;
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
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

// The A fragment of rows [row0, row0 + 16), columns [col, col + 16) of a
// shared tile with row stride ld.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int ld, int row0, int col, int g,
                                       int t4) {
  const bf16* p0 = tile + (row0 + g) * ld + col + t4 * 2;
  const bf16* p1 = p0 + 8 * ld;
  a[0] = ld32(p0);
  a[1] = ld32(p1);
  a[2] = ld32(p0 + 8);
  a[3] = ld32(p1 + 8);
}

// Rows [row0, row0 + 64) of a (seq, d) bf16 matrix into a (64, ld) shared
// tile in 16-byte chunks, zero past seq and past d (up to d16).
__device__ __forceinline__ void load_rows_bf16(bf16* dst, int ld,
                                               const bf16* src, int row0,
                                               int seq, int d, int d16) {
  const int chunks = d16 / 8;
  for (int i = threadIdx.x; i < kRows * chunks; i += kMmaThreads) {
    const int r = i / chunks, c = i - r * chunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < seq && c * 8 < d)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * d +
                                            c * 8);
    *reinterpret_cast<uint4*>(dst + r * ld + c * 8) = val;
  }
}

// The same rows transposed into a (d, kLdT) shared tile: dst[c][r]. Nearby
// threads take nearby rows, so one warp's 2-byte stores fall in distinct
// banks.
__device__ __forceinline__ void load_rows_t(bf16* dst, const bf16* src,
                                            int row0, int seq, int d) {
  const int chunks = d / 8;
  for (int i = threadIdx.x; i < kRows * chunks; i += kMmaThreads) {
    const int r = i % kRows, c = i / kRows;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < seq)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * d +
                                            c * 8);
    const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c * 8 + j) * kLdT + r] = e[j];
  }
}

// K3 on the tensor cores. Warp w owns queries q0 + 16 w + [0, 16): S = Q K^T
// and dP = dO V^T per key tile, then dQ += dS K with dS as the A fragment.
template <int DMAX>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ di,
                 bf16* __restrict__ dq, int seq, int d, float scale) {
  constexpr int kSteps = DMAX / 16;
  constexpr int kOut = DMAX / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d16 = (d + 15) & ~15;
  const int ldk = d16 + kPad;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [64 queries][ldk]
  bf16* dos = qs + kRows * ldk;                  // [64 queries][ldk]
  bf16* ks = dos + kRows * ldk;                  // [64 keys][ldk]
  bf16* vs = ks + kRows * ldk;                   // [64 keys][ldk]
  bf16* kt = vs + kRows * ldk;                   // [d][kLdT]: K^T

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t base = (size_t)blockIdx.x * seq * d;
  const size_t rows = (size_t)blockIdx.x * seq;
  const int q0 = blockIdx.y * kRows;
  const int n_steps = d16 / 16, n_out = d / 8;
  const float scale_log2 = scale * kLog2e;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const float lse0 = row0 < seq ? lse[rows + row0] * kLog2e : 0.0f;
  const float lse1 = row1 < seq ? lse[rows + row1] * kLog2e : 0.0f;
  const float di0 = row0 < seq ? di[rows + row0] : 0.0f;
  const float di1 = row1 < seq ? di[rows + row1] : 0.0f;

  load_rows_bf16(qs, ldk, q + base, q0, seq, d, d16);
  load_rows_bf16(dos, ldk, dout + base, q0, seq, d, d16);

  float acc[kOut][4];
#pragma unroll
  for (int n = 0; n < kOut; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  for (int k0 = 0; k0 < seq; k0 += kRows) {
    __syncthreads();
    load_rows_bf16(ks, ldk, k + base, k0, seq, d, d16);
    load_rows_bf16(vs, ldk, v + base, k0, seq, d, d16);
    load_rows_t(kt, k + base, k0, seq, d);
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      if (st < n_steps) {
        uint32_t qa[4], oa[4];
        load_a(qa, qs, ldk, warp * 16, st * 16, g, t4);
        load_a(oa, dos, ldk, warp * 16, st * 16, g, t4);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const bf16* pk = ks + (n * 8 + g) * ldk + st * 16 + t4 * 2;
          const bf16* pv = vs + (n * 8 + g) * ldk + st * 16 + t4 * 2;
          mma_bf16(s[n], qa, ld32(pk), ld32(pk + 8));
          mma_bf16(dp[n], oa, ld32(pv), ld32(pv + 8));
        }
      }
    }
    // dS = P (dP - di), P = exp(s - lse); column = key.
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi = e >= 2;
        const bool ok = k0 + n * 8 + t4 * 2 + (e & 1) < seq &&
                        (hi ? row1 : row0) < seq;
        const float p =
            ok ? exp2f(s[n][e] * scale_log2 - (hi ? lse1 : lse0)) : 0.0f;
        dp[n][e] = p * (dp[n][e] - (hi ? di1 : di0));
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t sa[4] = {pack_bf16(dp[2 * j][0], dp[2 * j][1]),
                              pack_bf16(dp[2 * j][2], dp[2 * j][3]),
                              pack_bf16(dp[2 * j + 1][0], dp[2 * j + 1][1]),
                              pack_bf16(dp[2 * j + 1][2], dp[2 * j + 1][3])};
#pragma unroll
      for (int n = 0; n < kOut; ++n) {
        if (n < n_out) {
          const bf16* pk = kt + (n * 8 + g) * kLdT + j * 16 + t4 * 2;
          mma_bf16(acc[n], sa, ld32(pk), ld32(pk + 8));
        }
      }
    }
  }

#pragma unroll
  for (int n = 0; n < kOut; ++n) {
    if (n >= n_out) continue;
    const int col = n * 8 + t4 * 2;
    if (row0 < seq)
      *reinterpret_cast<uint32_t*>(dq + base + (size_t)row0 * d + col) =
          pack_bf16(acc[n][0] * scale, acc[n][1] * scale);
    if (row1 < seq)
      *reinterpret_cast<uint32_t*>(dq + base + (size_t)row1 * d + col) =
          pack_bf16(acc[n][2] * scale, acc[n][3] * scale);
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *di;
  void *dq, *dk, *dv;
  int bh, seq, d;
  float scale;
  cudaStream_t stream;
};

template <typename T, int DMAX, int BLK>
int launch_dkv(const Args& a) {
  const size_t smem = smem_bytes<BLK>(a.d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv<T, DMAX, BLK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.bh, (a.seq + BLK - 1) / BLK);
  flash_bwd_dkv<T, DMAX, BLK><<<grid, kThreads, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse,
      a.di, (T*)a.dk, (T*)a.dv, a.seq, a.d, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int DMAX, int BLK>
int launch_dq(const Args& a) {
  const size_t smem = smem_bytes<BLK>(a.d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq<T, DMAX, BLK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.bh, (a.seq + BLK - 1) / BLK);
  flash_bwd_dq<T, DMAX, BLK><<<grid, kThreads, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse,
      a.di, (T*)a.dq, a.seq, a.d, a.scale);
  return (int)cudaGetLastError();
}

template <int DMAX>
int launch_dq_mma(const Args& a) {
  const int ldk = ((a.d + 15) & ~15) + kPad;
  const size_t smem = sizeof(bf16) * ((size_t)4 * kRows * ldk +
                                      (size_t)a.d * kLdT);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_mma<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.bh, (a.seq + kRows - 1) / kRows);
  flash_bwd_dq_mma<DMAX><<<grid, kMmaThreads, smem, a.stream>>>(
      (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v,
      (const bf16*)a.dout, a.lse, a.di, (bf16*)a.dq, a.seq, a.d, a.scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, bool dkv) {
  if (a.d <= 64)
    return dkv ? launch_dkv<T, 64, 64>(a) : launch_dq<T, 64, 64>(a);
  if (a.d <= 128)
    return dkv ? launch_dkv<T, 128, 64>(a) : launch_dq<T, 128, 64>(a);
  return dkv ? launch_dkv<T, 256, 32>(a) : launch_dq<T, 256, 32>(a);
}

int run_simt(const Args& a, int is_bf16, bool dkv) {
  if (a.bh <= 0 || a.seq <= 0 || a.d <= 0 || a.d > 256 ||
      (a.seq + 31) / 32 > 65535)
    return (int)cudaErrorInvalidValue;
  return is_bf16 ? dispatch<bf16>(a, dkv) : dispatch<float>(a, dkv);
}

// The tensor-core routes: bf16 with d % 8 == 0 (16-byte rows), d <= 128.
bool mma_shape_ok(const Args& a) {
  return a.bh > 0 && a.seq > 0 && a.d > 0 && a.d <= 128 && a.d % 8 == 0 &&
         (a.seq + kRows - 1) / kRows <= 65535;
}

// ---------------------------------------------------------------------------
// K2, sm90 route: bf16, D <= 128.

constexpr int kWgThreads = 128;
constexpr int kBwdKeys = 128;  // keys a block: 2 consumer warpgroups x 64
constexpr int kBwdRows = 64;   // queries a streamed Q / dO tile
constexpr int kBwdStages = 2;  // Q / dO tiles in flight
constexpr int kBwdThreads = 3 * kWgThreads;  // producer + 2 consumers
constexpr int kConsumerWarps = 8;
// 128 x 24 + 256 x 240 registers fit the SM's 65,536.
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// Byte offsets in the block's shared memory, from a 1024-byte boundary.
// DPAD (64 or 128) is D rounded up to whole 64-column boxes.
template <int DPAD>
struct DkvLayout {
  static constexpr int kBoxes = DPAD / 64;
  static constexpr int kKVBox = kBwdKeys * 128;   // one 64-column box of K, V
  static constexpr int kRowBox = kBwdRows * 128;  // of a Q or dO tile
  static constexpr int kKVBytes = kBoxes * kKVBox;
  static constexpr int kRowBytes = kBoxes * kRowBox;
  static constexpr int kK = 0;
  static constexpr int kV = kKVBytes;
  static constexpr int kQ = 2 * kKVBytes;                   // Q ring
  static constexpr int kDO = kQ + kBwdStages * kRowBytes;   // dO ring
  // [stage][lse (log2 units) 64 | di 64] float32
  static constexpr int kStats = kDO + kBwdStages * kRowBytes;
  static constexpr int kBars = kStats + kBwdStages * 2 * kBwdRows * 4;
  static constexpr int kSmem = kBars + 8 * (2 + 2 * kBwdStages) + 1024;
};

// Persistent: a block per SM walks the items (a 128-key tile of one head)
// blockIdx.x, blockIdx.x + gridDim.x, ...; consecutive blocks take
// consecutive key tiles of a head, so its Q and dO stay in L2. The Q/dO
// ring runs on from one item into the next, and the K/V tiles are released
// as soon as the item's last S^T and dP^T are done, so the next item's K,
// V and first Q/dO tiles load while this item finishes and stores.
template <int DPAD>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dkv_sm90(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   const __grid_constant__ CUtensorMap do_map,
                   const float* __restrict__ lse,
                   const float* __restrict__ di, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int n_items, int seq, int d,
                   float scale) {
  using L = DkvLayout<DPAD>;
  extern __shared__ uint8_t smem_tiles[];
  uint8_t* smem = sm90::align_1024(smem_tiles);
  float* stats = reinterpret_cast<float*>(smem + L::kStats);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* kv_empty = kv_full + 1;     // both consumers done with K, V
  uint64_t* full = kv_empty + 1;        // [stage]: Q, dO, lse, di landed
  uint64_t* empty = full + kBwdStages;  // [stage]: both consumers done
  const int n_ktiles = (seq + kBwdKeys - 1) / kBwdKeys;
  const int n_tiles = (seq + kBwdRows - 1) / kBwdRows;

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    sm90::mbar_init(kv_empty, kConsumerWarps);
    for (int s = 0; s < kBwdStages; ++s) {
      // The issuing lane's expect_tx arrival, then all 32 lanes' once the
      // row statistics are stored.
      sm90::mbar_init(&full[s], 33);
      sm90::mbar_init(&empty[s], kConsumerWarps);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int role = threadIdx.x / kWgThreads;  // warpgroup
  if (role == 0) {
    // Producer warpgroup; its first warp loads, lane 0 issues the TMA. n
    // counts the Q/dO tiles through the ring, `it` the items (K/V tiles).
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      int n = 0, it = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
        const int head = item / n_ktiles;
        const int k0 = item % n_ktiles * kBwdKeys;
        if (lane == 0) {
          sm90::mbar_wait(kv_empty, (it & 1) ^ 1);
          sm90::mbar_arrive_expect_tx(kv_full, 2 * L::kKVBytes);
          for (int b = 0; b < L::kBoxes; ++b) {
            sm90::tma_load(smem + L::kK + b * L::kKVBox, &k_map, kv_full,
                           64 * b, k0, head);
            sm90::tma_load(smem + L::kV + b * L::kKVBox, &v_map, kv_full,
                           64 * b, k0, head);
          }
        }
        const size_t rows = (size_t)head * seq;
        for (int i = 0; i < n_tiles; ++i, ++n) {
          const int s = n % kBwdStages;
          // This lane's two queries of the tile; the loads fly while the
          // stage drains.
          float l_in[2], d_in[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int qi = i * kBwdRows + lane + 32 * h;
            l_in[h] = qi < seq ? lse[rows + qi] * kLog2e : 0.0f;
            d_in[h] = qi < seq ? di[rows + qi] : 0.0f;
          }
          sm90::mbar_wait(&empty[s], ((n / kBwdStages) & 1) ^ 1);
          if (lane == 0) {
            sm90::mbar_arrive_expect_tx(&full[s], 2 * L::kRowBytes);
            uint8_t* qt = smem + L::kQ + s * L::kRowBytes;
            uint8_t* dot = smem + L::kDO + s * L::kRowBytes;
            for (int b = 0; b < L::kBoxes; ++b) {
              sm90::tma_load(qt + b * L::kRowBox, &q_map, &full[s], 64 * b,
                             i * kBwdRows, head);
              sm90::tma_load(dot + b * L::kRowBox, &do_map, &full[s],
                             64 * b, i * kBwdRows, head);
            }
          }
          float* st = stats + s * 2 * kBwdRows;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            st[lane + 32 * h] = l_in[h];
            st[kBwdRows + lane + 32 * h] = d_in[h];
          }
          sm90::mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    // Consumer warpgroup wg: keys k0 + 64 wg + [0, 64) of each item.
    sm90::setmaxnreg_inc<kConsumerRegs>();
    const int wg = role - 1;
    const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t4 = lane % 4;
    const uint32_t k_tile = sm90::smem_u32(smem + L::kK);
    const uint32_t v_tile = sm90::smem_u32(smem + L::kV);
    const float scale_log2 = scale * kLog2e;
    // Arrive on a barrier once per consumer warp.
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(bar);
    };

    int n = 0, it = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
      const int head = item / n_ktiles;
      const int k0 = item % n_ktiles * kBwdKeys;
      float acc_k[DPAD / 2], acc_v[DPAD / 2];  // 64 keys x DPAD each
#pragma unroll
      for (int r = 0; r < DPAD / 2; ++r) acc_k[r] = acc_v[r] = 0.0f;

      sm90::mbar_wait(kv_full, it & 1);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = (n + i) % kBwdStages;
        sm90::mbar_wait(&full[s], ((n + i) / kBwdStages) & 1);
        const uint32_t q_tile =
            sm90::smem_u32(smem + L::kQ + s * L::kRowBytes);
        const uint32_t do_tile =
            sm90::smem_u32(smem + L::kDO + s * L::kRowBytes);

        // S^T and dP^T, 64 keys x 64 queries.
        float st[32], dpt[32];
        sm90::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < DPAD / 16; ++ks)
          sm90::wgmma_ss<0>(
              st, sm90::desc_k_major(k_tile, L::kKVBox, wg * 64 * 128, ks),
              sm90::desc_k_major(q_tile, L::kRowBox, 0, ks), ks > 0);
#pragma unroll
        for (int ks = 0; ks < DPAD / 16; ++ks)
          sm90::wgmma_ss<0>(
              dpt, sm90::desc_k_major(v_tile, L::kKVBox, wg * 64 * 128, ks),
              sm90::desc_k_major(do_tile, L::kRowBox, 0, ks), ks > 0);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(st);
        sm90::fence_regs(dpt);
        if (i == n_tiles - 1) release(kv_empty);

        // P^T and dS^T = P^T (dP^T - di); column = query.
        const float* lse_s = stats + s * 2 * kBwdRows;
        const float* di_s = lse_s + kBwdRows;
        const bool ragged = (i + 1) * kBwdRows > seq;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = 8 * j + 2 * t4 + (e & 1);
            float p = exp2f(st[4 * j + e] * scale_log2 - lse_s[qi]);
            if (ragged && i * kBwdRows + qi >= seq) p = 0.0f;
            st[4 * j + e] = p;
            dpt[4 * j + e] = p * (dpt[4 * j + e] - di_s[qi]);
          }
        }
        // Chunks 2 ks and 2 ks + 1 are the A fragment of queries
        // [16 ks, 16 ks + 16).
        uint32_t pa[4][4], sa[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            pa[ks][r] = sm90::pack_bf16(st[8 * ks + 2 * r],
                                        st[8 * ks + 2 * r + 1]);
            sa[ks][r] = sm90::pack_bf16(dpt[8 * ks + 2 * r],
                                        dpt[8 * ks + 2 * r + 1]);
          }
        sm90::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          sm90::wgmma_rs<1>(acc_v, pa[ks],
                            sm90::desc_mn_major(do_tile, L::kRowBox, ks), 1);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          sm90::wgmma_rs<1>(acc_k, sa[ks],
                            sm90::desc_mn_major(q_tile, L::kRowBox, ks), 1);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc_v);
        sm90::fence_regs(acc_k);
        release(&empty[s]);
      }
      n += n_tiles;

      const int row0 = k0 + wg * 64 + warp * 16 + g, row1 = row0 + 8;
      const size_t base = (size_t)head * seq * d;
#pragma unroll
      for (int j = 0; j < DPAD / 8; ++j) {
        const int col = 8 * j + 2 * t4;
        if (col >= d) continue;
        if (row0 < seq) {
          const size_t o = base + (size_t)row0 * d + col;
          *reinterpret_cast<uint32_t*>(dk + o) = sm90::pack_bf16(
              acc_k[4 * j] * scale, acc_k[4 * j + 1] * scale);
          *reinterpret_cast<uint32_t*>(dv + o) =
              sm90::pack_bf16(acc_v[4 * j], acc_v[4 * j + 1]);
        }
        if (row1 < seq) {
          const size_t o = base + (size_t)row1 * d + col;
          *reinterpret_cast<uint32_t*>(dk + o) = sm90::pack_bf16(
              acc_k[4 * j + 2] * scale, acc_k[4 * j + 3] * scale);
          *reinterpret_cast<uint32_t*>(dv + o) =
              sm90::pack_bf16(acc_v[4 * j + 2], acc_v[4 * j + 3]);
        }
      }
    }
  }
}

template <int DPAD>
int launch_dkv_sm90(const Args& a) {
  CUtensorMap maps[4];
  const void* srcs[4] = {a.q, a.k, a.v, a.dout};
  const int rows[4] = {kBwdRows, kBwdKeys, kBwdKeys, kBwdRows};
  for (int i = 0; i < 4; ++i) {
    const int err = sm90::make_map(&maps[i], srcs[i], a.bh, a.seq, a.d,
                                   rows[i]);
    if (err != 0) return err;
  }
  constexpr int smem = DkvLayout<DPAD>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_sm90<DPAD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = sm90::sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const int n_items = (a.seq + kBwdKeys - 1) / kBwdKeys * a.bh;
  flash_bwd_dkv_sm90<DPAD><<<n_items < sms ? n_items : sms, kBwdThreads,
                             smem, a.stream>>>(
      maps[0], maps[1], maps[2], maps[3], a.lse, a.di, (bf16*)a.dk,
      (bf16*)a.dv, n_items, a.seq, a.d, a.scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dK and dV (K2). q, k, v, dout, dk, dv: (bh, seq, d); lse and di:
// (bh, seq) float32. The sm90 route takes bf16 with d % 8 == 0 and
// d <= 128; the simt route float32 or bf16 with d <= 256.
extern "C" int mulan_flash_attention_bwd_dkv_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, void* dk, void* dv, int bh, int seq,
    int d, float scale, void* stream) {
  const Args a{q, k, v, dout, (const float*)lse, (const float*)di, nullptr,
               dk, dv, bh, seq, d, scale, (cudaStream_t)stream};
  if (!mma_shape_ok(a) ||
      (long long)((a.seq + kBwdKeys - 1) / kBwdKeys) * a.bh > INT_MAX)
    return (int)cudaErrorInvalidValue;
  return a.d <= 64 ? launch_dkv_sm90<64>(a) : launch_dkv_sm90<128>(a);
}

extern "C" int mulan_flash_attention_bwd_dkv_simt(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, void* dk, void* dv, int bh, int seq,
    int d, float scale, int is_bf16, void* stream) {
  const Args a{q, k, v, dout, (const float*)lse, (const float*)di, nullptr,
               dk, dv, bh, seq, d, scale, (cudaStream_t)stream};
  return run_simt(a, is_bf16, true);
}

// dQ (K3). The sm90 route (the mma.sync kernel) takes bf16 with
// d % 8 == 0 and d <= 128; the simt route float32 or bf16 with d <= 256.
extern "C" int mulan_flash_attention_bwd_dq_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, void* dq, int bh, int seq, int d,
    float scale, void* stream) {
  const Args a{q, k, v, dout, (const float*)lse, (const float*)di, dq,
               nullptr, nullptr, bh, seq, d, scale, (cudaStream_t)stream};
  if (!mma_shape_ok(a)) return (int)cudaErrorInvalidValue;
  return a.d <= 64 ? launch_dq_mma<64>(a) : launch_dq_mma<128>(a);
}

extern "C" int mulan_flash_attention_bwd_dq_simt(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, void* dq, int bh, int seq, int d,
    float scale, int is_bf16, void* stream) {
  const Args a{q, k, v, dout, (const float*)lse, (const float*)di, dq,
               nullptr, nullptr, bh, seq, d, scale, (cudaStream_t)stream};
  return run_simt(a, is_bf16, false);
}
