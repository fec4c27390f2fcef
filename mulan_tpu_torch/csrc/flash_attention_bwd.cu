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
// leave the chip; at imagenet32's (128, 1, 1024, 256) twice that (0.28 and
// 0.21 ms). One C entry point per route; ops/flash_attention.py picks
// it from (dtype, D) for each kernel:
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
// * K3, bf16 with D <= 128 (mulan_flash_attention_bwd_dq_sm90, the
//   flagship path): flash_bwd_dq_sm90, query-stationary like the forward
//   (flash_attention.cu) and persistent (one block per SM walking 128-query
//   tiles). One producer thread loads the item's Q and dO tiles once by TMA
//   and streams 128-key K and V tiles through a 2-stage ring of
//   128B-swizzled shared memory; two consumer warpgroups own 64 queries
//   each and hold their rows' lse and di in registers for the whole item,
//   so no row statistics are staged per tile. Per key tile a consumer
//   computes S = Q K^T and dP = dO V^T with wgmma m64n128k16 (SS form, all
//   K-major, straight from the tiles), then dS = P (dP - di) with
//   P = exp2(S scale log2 e - lse log2 e) on the accumulator layout, packs
//   dS to bf16 in registers (where the Pallas kernel casts it to the input
//   type) and accumulates dQ += dS K with wgmma m64nDk16 in the RS form,
//   reading K MN-major with the transpose bit from the tile S read K-major:
//   no transposed copy of K. A consumer waits for a tile's dS K before it
//   issues the next tile's S and dP, so dS's fragments never live beside
//   them (with both, 224 registers spill), and the two warpgroups take
//   turns to issue their products (ping-pong on named barriers), so one
//   computes dS while the tensor cores run the other's. 64-key tiles on 3
//   stages, with the next S and dP issued beside this dS K, take the same
//   time (mulan_tpu_torch/ops/ablations/k3_dq.json). dQ is scaled by
//   `scale` once at the end; keys past T get P = 0, and only rows < T and
//   columns < D are stored.
// * K2 and K3, bf16 with 128 < D <= 256 (the same entry points, imagenet32's
//   head_dim 256): flash_bwd_dkv_sm90_d256 and flash_bwd_dq_sm90_d256,
//   redesigned for the register and shared-memory budget of that width (see
//   "The sm90 routes at 128 < D <= 256" below): K2 splits D between its two
//   consumer warpgroups and exchanges P^T and dS^T through shared memory;
//   K3 runs 32-key K/V tiles with dQ += dS K as one m64n256k16 a step.
// * float32 (mulan_flash_attention_bwd_{dkv,dq}_simt; bf16 too, with
//   is_bf16, which the 'sm90' route replaced at every D <= 256 but which
//   stays callable for timing against it): the arithmetic runs on the CUDA
//   cores in float32 (67 TFLOP/s peak): every thread keeps an R x R tile of
//   scores and an R x (DMAX/16) tile of each accumulator in registers, so
//   each shared-memory load feeds several FMAs. Tiles are 64 rows for D <= 128 and 32 rows for D <= 256 (the
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

typedef __nv_bfloat16 bf16;

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

// ---------------------------------------------------------------------------
// sm90 routes (K2 and K3): bf16, D <= 128 (at D <= 256 see below).

constexpr int kWgThreads = 128;
constexpr int kSm90Threads = 3 * kWgThreads;  // producer + 2 consumers
constexpr int kConsumerWarps = 8;
// 128 x 24 + 256 x 240 registers fit the SM's 65,536.
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;

// The shapes both take: bf16 with d % 8 == 0 (16-byte rows, as TMA needs)
// and d <= 256, in at most INT_MAX items of `rows` rows of one head.
bool sm90_shape_ok(const Args& a, int rows) {
  return a.bh > 0 && a.seq > 0 && a.d > 0 && a.d <= 256 && a.d % 8 == 0 &&
         (long long)((a.seq + rows - 1) / rows) * a.bh <= INT_MAX;
}

// ---------------------------------------------------------------------------
// K2, sm90 route.

constexpr int kBwdKeys = 128;  // keys a block: 2 consumer warpgroups x 64
constexpr int kBwdRows = 64;   // queries a streamed Q / dO tile
constexpr int kBwdStages = 2;  // Q / dO tiles in flight

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
__global__ void __launch_bounds__(kSm90Threads, 1)
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
  flash_bwd_dkv_sm90<DPAD><<<n_items < sms ? n_items : sms, kSm90Threads,
                             smem, a.stream>>>(
      maps[0], maps[1], maps[2], maps[3], a.lse, a.di, (bf16*)a.dk,
      (bf16*)a.dv, n_items, a.seq, a.d, a.scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K3, sm90 route.

constexpr int kDqRows = 128;  // queries an item: 2 consumer warpgroups x 64
constexpr int kDqKeys = 128;  // keys a streamed K / V tile
constexpr int kDqStages = 2;  // K / V tiles in flight (3 exceed 227 KB)

// Byte offsets in the block's shared memory, from a 1024-byte boundary.
// DPAD (64 or 128) is D rounded up to whole 64-column boxes.
template <int DPAD>
struct DqLayout {
  static constexpr int kBoxes = DPAD / 64;
  static constexpr int kQBox = kDqRows * 128;   // one 64-column box of Q, dO
  static constexpr int kKVBox = kDqKeys * 128;  // of a K or V tile
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kKVBytes = kBoxes * kKVBox;
  static constexpr int kQ = 0;
  static constexpr int kDO = kQBytes;
  static constexpr int kK = 2 * kQBytes;                  // K ring
  static constexpr int kV = kK + kDqStages * kKVBytes;    // V ring
  static constexpr int kBars = kV + kDqStages * kKVBytes;  // mbarriers
  static constexpr int kSmem = kBars + 8 * (2 + 2 * kDqStages) + 1024;
};

// S = Q K^T and dP = dO V^T (64 queries x the tile's 2 N keys each) for the
// consumer whose rows start at byte `row` of each Q and dO box of layout L:
// SS form, all K-major, straight from the tiles.
template <int DPAD, typename L = DqLayout<DPAD>, int N>
__device__ __forceinline__ void issue_s_dp(float (&s)[N], float (&dp)[N],
                                           uint32_t q_tile, uint32_t do_tile,
                                           int row, uint32_t k_tile,
                                           uint32_t v_tile) {
#pragma unroll
  for (int ks = 0; ks < DPAD / 16; ++ks)
    sm90::wgmma_ss<0>(s, sm90::desc_k_major(q_tile, L::kQBox, row, ks),
                      sm90::desc_k_major(k_tile, L::kKVBox, 0, ks), ks > 0);
#pragma unroll
  for (int ks = 0; ks < DPAD / 16; ++ks)
    sm90::wgmma_ss<0>(dp, sm90::desc_k_major(do_tile, L::kQBox, row, ks),
                      sm90::desc_k_major(v_tile, L::kKVBox, 0, ks), ks > 0);
}

// dQ += dS K: dS's bf16 A fragments, K the MN-major B operand (its rows,
// the keys, are the k dimension) read with the transpose bit from the same
// tile S read K-major.
template <int DPAD, typename L = DqLayout<DPAD>, int KS>
__device__ __forceinline__ void issue_dq(float (&acc)[DPAD / 2],
                                         const uint32_t (&sa)[KS][4],
                                         uint32_t k_tile) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    sm90::wgmma_rs<1>(acc, sa[ks], sm90::desc_mn_major(k_tile, L::kKVBox, ks),
                      1);
}

// dS = P (dP - di), P = exp2(S scale log2 e - lse log2 e), in place of S,
// for keys from key0 (P = 0 past seq); rows g and g + 8 of the warp's 16
// (suffixes 0 and 1), lse in log2 units.
template <int N>
__device__ __forceinline__ void compute_ds(float (&s)[N], const float (&dp)[N],
                                           int key0, int seq, int t4,
                                           float scale_log2, float lse0,
                                           float lse1, float di0, float di1) {
  const bool ragged = key0 + 2 * N > seq;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool hi = e >= 2;
      float p = exp2f(fmaf(s[4 * j + e], scale_log2, hi ? -lse1 : -lse0));
      if (ragged && key0 + 8 * j + 2 * t4 + (e & 1) >= seq) p = 0.0f;
      s[4 * j + e] = p * (dp[4 * j + e] - (hi ? di1 : di0));
    }
  }
}

// Chunks 2 ks and 2 ks + 1 of dS's accumulator layout are, packed to bf16
// pairs (the rounding point of the Pallas kernel), the A fragment of keys
// [16 ks, 16 ks + 16).
template <int N>
__device__ __forceinline__ void pack_ds(uint32_t (&sa)[N / 8][4],
                                        const float (&s)[N]) {
#pragma unroll
  for (int ks = 0; ks < N / 8; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      sa[ks][r] = sm90::pack_bf16(s[8 * ks + 2 * r], s[8 * ks + 2 * r + 1]);
}

// Persistent: a block per SM walks the items (a 128-query tile of one
// head) blockIdx.x, blockIdx.x + gridDim.x, ...; consecutive blocks take
// consecutive query tiles of a head, so its K and V stay in L2. The K/V
// ring runs on from one item into the next, and Q and dO are released as
// soon as the item's last S and dP are done, so the next item's Q, dO and
// first K/V tiles load while this item finishes its last dS K and stores.
// Registers: S and dP of a 128-key tile take 64 each, dQ 64 (D = 128) and
// dS's bf16 fragments 32; each tile's dS K is waited for before the next
// tile's S and dP are issued, so the fragments never live beside them.
template <int DPAD>
__global__ void __launch_bounds__(kSm90Threads, 1)
flash_bwd_dq_sm90(const __grid_constant__ CUtensorMap q_map,
                  const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map,
                  const __grid_constant__ CUtensorMap do_map,
                  const float* __restrict__ lse, const float* __restrict__ di,
                  bf16* __restrict__ dq, int n_items, int seq, int d,
                  float scale) {
  using L = DqLayout<DPAD>;
  extern __shared__ uint8_t smem_tiles[];
  uint8_t* smem = sm90::align_1024(smem_tiles);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* q_empty = q_full + 1;      // both consumers done with Q, dO
  uint64_t* full = q_empty + 1;        // [stage]: K and V tiles landed
  uint64_t* empty = full + kDqStages;  // [stage]: both consumers done
  const int n_qtiles = (seq + kDqRows - 1) / kDqRows;
  const int n_tiles = (seq + kDqKeys - 1) / kDqKeys;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    sm90::mbar_init(q_empty, kConsumerWarps);
    for (int s = 0; s < kDqStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kConsumerWarps);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int role = threadIdx.x / kWgThreads;  // warpgroup
  if (role == 0) {
    // Producer warpgroup; one thread issues every copy. n counts the K/V
    // tiles through the ring, `it` the items (Q and dO tiles).
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int n = 0, it = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
        const int head = item / n_qtiles;
        const int q0 = item % n_qtiles * kDqRows;
        sm90::mbar_wait(q_empty, (it & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(q_full, 2 * L::kQBytes);
        for (int b = 0; b < L::kBoxes; ++b) {
          sm90::tma_load(smem + L::kQ + b * L::kQBox, &q_map, q_full, 64 * b,
                         q0, head);
          sm90::tma_load(smem + L::kDO + b * L::kQBox, &do_map, q_full,
                         64 * b, q0, head);
        }
        for (int i = 0; i < n_tiles; ++i, ++n) {
          const int s = n % kDqStages;
          sm90::mbar_wait(&empty[s], ((n / kDqStages) & 1) ^ 1);
          sm90::mbar_arrive_expect_tx(&full[s], 2 * L::kKVBytes);
          uint8_t* kt = smem + L::kK + s * L::kKVBytes;
          uint8_t* vt = smem + L::kV + s * L::kKVBytes;
          for (int b = 0; b < L::kBoxes; ++b) {
            sm90::tma_load(kt + b * L::kKVBox, &k_map, &full[s], 64 * b,
                           i * kDqKeys, head);
            sm90::tma_load(vt + b * L::kKVBox, &v_map, &full[s], 64 * b,
                           i * kDqKeys, head);
          }
        }
      }
    }
  } else {
    // Consumer warpgroup wg: queries q0 + 64 wg + [0, 64) of each item.
    sm90::setmaxnreg_inc<kConsumerRegs>();
    const int wg = role - 1;
    const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t4 = lane % 4;
    const uint32_t q_tile = sm90::smem_u32(smem + L::kQ);
    const uint32_t do_tile = sm90::smem_u32(smem + L::kDO);
    const int row = wg * 64 * 128;  // this warpgroup's rows in a Q/dO box
    const float scale_log2 = scale * kLog2e;
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
    // Ping-pong: the two warpgroups take turns to issue their products
    // (named barrier 1 + wg is wg's turn), so that one computes dS while
    // the tensor cores run the other's products; in step, both would
    // compute dS at once and leave the tensor cores idle meanwhile.
    auto my_turn = [&] { sm90::bar_sync(1 + wg, 2 * kWgThreads); };
    auto pass_turn = [&] { sm90::bar_arrive(2 - wg, 2 * kWgThreads); };
    if (wg == 1) pass_turn();  // warpgroup 0 goes first

    int n = 0, it = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
      const int head = item / n_qtiles;
      const int q0 = item % n_qtiles * kDqRows;
      // This thread's two rows, and their lse (log2 units) and di, held
      // in registers for the whole item.
      const int row0 = q0 + wg * 64 + warp * 16 + g, row1 = row0 + 8;
      const size_t rows = (size_t)head * seq;
      const float lse0 = row0 < seq ? lse[rows + row0] * kLog2e : 0.0f;
      const float lse1 = row1 < seq ? lse[rows + row1] * kLog2e : 0.0f;
      const float di0 = row0 < seq ? di[rows + row0] : 0.0f;
      const float di1 = row1 < seq ? di[rows + row1] : 0.0f;
      float acc[DPAD / 2];  // dQ / scale, 64 x DPAD
#pragma unroll
      for (int r = 0; r < DPAD / 2; ++r) acc[r] = 0.0f;

      // Per key tile, in this warpgroup's turn: S and dP; then dS, then
      // dQ += dS K, while the other warpgroup's products run.
      sm90::mbar_wait(q_full, it & 1);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = (n + i) % kDqStages;
        float s[kDqKeys / 2], dp[kDqKeys / 2];  // S (then dS) and dP
        uint32_t sa[kDqKeys / 16][4];  // dS in bf16, the A operand of dS K
        sm90::mbar_wait(&full[st], ((n + i) / kDqStages) & 1);
        my_turn();
        sm90::wgmma_fence();
        issue_s_dp<DPAD>(s, dp, q_tile, do_tile, row, k_tile(st),
                         v_tile(st));
        sm90::wgmma_commit();
        pass_turn();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(s);
        sm90::fence_regs(dp);
        if (i == n_tiles - 1) release(q_empty);
        compute_ds(s, dp, i * kDqKeys, seq, t4, scale_log2, lse0, lse1, di0,
                   di1);
        pack_ds(sa, s);
        sm90::wgmma_fence();
        issue_dq<DPAD>(acc, sa, k_tile(st));
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc);
        release(&empty[st]);
      }
      n += n_tiles;

      const size_t base = (size_t)head * seq * d;
#pragma unroll
      for (int j = 0; j < DPAD / 8; ++j) {
        const int col = 8 * j + 2 * t4;
        if (col >= d) continue;
        if (row0 < seq)
          *reinterpret_cast<uint32_t*>(dq + base + (size_t)row0 * d + col) =
              sm90::pack_bf16(acc[4 * j] * scale, acc[4 * j + 1] * scale);
        if (row1 < seq)
          *reinterpret_cast<uint32_t*>(dq + base + (size_t)row1 * d + col) =
              sm90::pack_bf16(acc[4 * j + 2] * scale,
                              acc[4 * j + 3] * scale);
      }
    }
    // Warpgroup 1 passed the turn once more than warpgroup 0 took it.
    if (wg == 0) my_turn();
  }
}

template <int DPAD>
int launch_dq_sm90(const Args& a) {
  CUtensorMap maps[4];
  const void* srcs[4] = {a.q, a.k, a.v, a.dout};
  const int rows[4] = {kDqRows, kDqKeys, kDqKeys, kDqRows};
  for (int i = 0; i < 4; ++i) {
    const int err = sm90::make_map(&maps[i], srcs[i], a.bh, a.seq, a.d,
                                   rows[i]);
    if (err != 0) return err;
  }
  constexpr int smem = DqLayout<DPAD>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_sm90<DPAD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = sm90::sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const int n_items = (a.seq + kDqRows - 1) / kDqRows * a.bh;
  flash_bwd_dq_sm90<DPAD><<<n_items < sms ? n_items : sms, kSm90Threads,
                            smem, a.stream>>>(
      maps[0], maps[1], maps[2], maps[3], a.lse, a.di, (bf16*)a.dq, n_items,
      a.seq, a.d, a.scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The sm90 routes at 128 < D <= 256 (imagenet32's head_dim 256), K2 and K3.
// At DPAD = 256 the kernels above do not fit: K2's dK and dV of 64 keys
// take 256 registers a thread in one warpgroup (setmaxnreg gives 240), and
// K + V for 128 keys with its Q/dO ring take 256 KB of shared memory (227
// KB a block); K3's dQ takes 128 registers, leaving too few for S and dP of
// a 128-key tile, and its K/V ring alone would take 256 KB.

// Encodes the four tensor maps (q, k, v, dout; `rows` a box each), gives
// `kernel` its shared memory and launches min(n_items, SMs) persistent
// blocks of `threads`.
template <typename Kernel, typename... Outs>
int launch_persistent(Kernel kernel, int smem, int threads,
                      const int (&rows)[4], int n_items, const Args& a,
                      Outs... outs) {
  CUtensorMap maps[4];
  const void* srcs[4] = {a.q, a.k, a.v, a.dout};
  for (int i = 0; i < 4; ++i) {
    const int err = sm90::make_map(&maps[i], srcs[i], a.bh, a.seq, a.d,
                                   rows[i]);
    if (err != 0) return err;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = sm90::sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_items < sms ? n_items : sms, threads, smem, a.stream>>>(
      maps[0], maps[1], maps[2], maps[3], a.lse, a.di, outs..., n_items,
      a.seq, a.d, a.scale);
  return (int)cudaGetLastError();
}

// K2 at D <= 256 (flash_bwd_dkv_sm90_d256): a block owns 64 keys, and its
// two consumer warpgroups
// split the work by columns of D. Warpgroup w accumulates columns
// [128 w, 128 w + 128) of dK and dV (64 + 64 registers). Per streamed
// 64-query tile it computes S^T and dP^T of all 64 keys against its 32
// queries [32 w, 32 w + 32) (wgmma m64n32k16 over the whole D, SS form),
// turns them into P^T and dS^T and stores both, rounded to bf16 (where the
// Pallas kernel casts them to the input type), into 128B-swizzled 64 x 64
// tiles in shared memory. After a named barrier of both warpgroups, each
// reads the whole tiles as the A operand of dV += P^T dO and dK += dS^T Q
// over its columns (wgmma m64n128k16, SS form; dO and Q MN-major). So the
// four products of a tile are each done once, split evenly between the
// warpgroups. The P^T / dS^T tiles are double-buffered: a warpgroup
// overwrites a buffer only after the next tile's barrier, which the other
// passes only once its products that read the buffer are complete. Each
// warpgroup computing the whole 64 x 64 S^T and dP^T itself (six products
// a tile, P^T and dS^T as RS-form fragments, no exchange) is 6% slower
// (ops/ablations/k2_dkv_d256.json).
constexpr int kDkv256Keys = 64;   // keys a block: both consumers
constexpr int kDkv256Rows = 64;   // queries a streamed Q / dO tile
constexpr int kDkv256Stages = 2;  // Q / dO tiles in flight

struct Dkv256Layout {
  static constexpr int kBoxes = 4;
  static constexpr int kKVBox = kDkv256Keys * 128;
  static constexpr int kRowBox = kDkv256Rows * 128;
  static constexpr int kKVBytes = kBoxes * kKVBox;
  static constexpr int kRowBytes = kBoxes * kRowBox;
  static constexpr int kPBox = kDkv256Keys * 128;  // a 64 x 64 bf16 tile
  static constexpr int kK = 0;
  static constexpr int kV = kKVBytes;
  static constexpr int kQ = 2 * kKVBytes;                      // Q ring
  static constexpr int kDO = kQ + kDkv256Stages * kRowBytes;   // dO ring
  // [buffer][P^T | dS^T], two 64 x 64 bf16 tiles each
  static constexpr int kP = kDO + kDkv256Stages * kRowBytes;
  // [stage][lse (log2 units) 64 | di 64] float32
  static constexpr int kStats = kP + 2 * 2 * kPBox;
  static constexpr int kBars = kStats + kDkv256Stages * 2 * kDkv256Rows * 4;
  static constexpr int kSmem = kBars + 8 * (2 + 2 * kDkv256Stages) + 1024;
};
static_assert(Dkv256Layout::kSmem <= 232448, "K2 at D <= 256: 227 KB");

// Persistent as the K2 kernel above: items are 64-key tiles, head-major.
__global__ void __launch_bounds__(kSm90Threads, 1)
flash_bwd_dkv_sm90_d256(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const __grid_constant__ CUtensorMap do_map,
                        const float* __restrict__ lse,
                        const float* __restrict__ di, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int n_items, int seq, int d,
                        float scale) {
  using L = Dkv256Layout;
  extern __shared__ uint8_t smem_tiles[];
  uint8_t* smem = sm90::align_1024(smem_tiles);
  float* stats = reinterpret_cast<float*>(smem + L::kStats);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* kv_empty = kv_full + 1;        // both consumers done with K, V
  uint64_t* full = kv_empty + 1;           // [stage]: Q, dO, lse, di landed
  uint64_t* empty = full + kDkv256Stages;  // [stage]: both consumers done
  const int n_ktiles = (seq + kDkv256Keys - 1) / kDkv256Keys;
  const int n_tiles = (seq + kDkv256Rows - 1) / kDkv256Rows;

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    sm90::mbar_init(kv_empty, kConsumerWarps);
    for (int s = 0; s < kDkv256Stages; ++s) {
      sm90::mbar_init(&full[s], 33);  // expect_tx, then the 32 lanes' stats
      sm90::mbar_init(&empty[s], kConsumerWarps);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int role = threadIdx.x / kWgThreads;  // warpgroup
  if (role == 0) {
    // Producer: as the K2 kernel's above.
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      int n = 0, it = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
        const int head = item / n_ktiles;
        const int k0 = item % n_ktiles * kDkv256Keys;
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
          const int s = n % kDkv256Stages;
          float l_in[2], d_in[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int qi = i * kDkv256Rows + lane + 32 * h;
            l_in[h] = qi < seq ? lse[rows + qi] * kLog2e : 0.0f;
            d_in[h] = qi < seq ? di[rows + qi] : 0.0f;
          }
          sm90::mbar_wait(&empty[s], ((n / kDkv256Stages) & 1) ^ 1);
          if (lane == 0) {
            sm90::mbar_arrive_expect_tx(&full[s], 2 * L::kRowBytes);
            uint8_t* qt = smem + L::kQ + s * L::kRowBytes;
            uint8_t* dot = smem + L::kDO + s * L::kRowBytes;
            for (int b = 0; b < L::kBoxes; ++b) {
              sm90::tma_load(qt + b * L::kRowBox, &q_map, &full[s], 64 * b,
                             i * kDkv256Rows, head);
              sm90::tma_load(dot + b * L::kRowBox, &do_map, &full[s],
                             64 * b, i * kDkv256Rows, head);
            }
          }
          float* st = stats + s * 2 * kDkv256Rows;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            st[lane + 32 * h] = l_in[h];
            st[kDkv256Rows + lane + 32 * h] = d_in[h];
          }
          sm90::mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    // Consumer warpgroup wg: columns [128 wg, 128 wg + 128) of dK and dV,
    // queries [32 wg, 32 wg + 32) of each tile's S^T and dP^T.
    sm90::setmaxnreg_inc<kConsumerRegs>();
    const int wg = role - 1;
    const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t4 = lane % 4;
    const uint32_t k_tile = sm90::smem_u32(smem + L::kK);
    const uint32_t v_tile = sm90::smem_u32(smem + L::kV);
    const int half = 2 * wg * L::kRowBox;  // this warpgroup's columns
    const float scale_log2 = scale * kLog2e;
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(bar);
    };

    int n = 0, it = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
      const int head = item / n_ktiles;
      const int k0 = item % n_ktiles * kDkv256Keys;
      float acc_k[64], acc_v[64];  // 64 keys x 128 columns each
#pragma unroll
      for (int r = 0; r < 64; ++r) acc_k[r] = acc_v[r] = 0.0f;

      sm90::mbar_wait(kv_full, it & 1);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = (n + i) % kDkv256Stages;
        sm90::mbar_wait(&full[s], ((n + i) / kDkv256Stages) & 1);
        const uint32_t q_tile =
            sm90::smem_u32(smem + L::kQ + s * L::kRowBytes);
        const uint32_t do_tile =
            sm90::smem_u32(smem + L::kDO + s * L::kRowBytes);

        // S^T and dP^T, 64 keys x this warpgroup's 32 queries.
        float st[16], dpt[16];
        sm90::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 16; ++ks)
          sm90::wgmma_ss<0>(
              st, sm90::desc_k_major(k_tile, L::kKVBox, 0, ks),
              sm90::desc_k_major(q_tile, L::kRowBox, wg * 32 * 128, ks),
              ks > 0);
#pragma unroll
        for (int ks = 0; ks < 16; ++ks)
          sm90::wgmma_ss<0>(
              dpt, sm90::desc_k_major(v_tile, L::kKVBox, 0, ks),
              sm90::desc_k_major(do_tile, L::kRowBox, wg * 32 * 128, ks),
              ks > 0);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(st);
        sm90::fence_regs(dpt);
        if (i == n_tiles - 1) release(kv_empty);

        // P^T and dS^T in bf16 pairs: key rows 16 warp + g + 8 h, query
        // columns 32 wg + 8 j + 2 t4 (+ 1), i.e. 16-byte chunk 4 wg + j of
        // a 128-byte row, stored at its swizzled place (chunk ^ row % 8).
        const float* lse_s = stats + s * 2 * kDkv256Rows;
        const float* di_s = lse_s + kDkv256Rows;
        const bool ragged = (i + 1) * kDkv256Rows > seq;
        uint8_t* pt = smem + L::kP + ((n + i) & 1) * 2 * L::kPBox;
        uint8_t* dst = pt + L::kPBox;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float p[2], ds[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int qi = 32 * wg + 8 * j + 2 * t4 + e;
              p[e] = exp2f(st[4 * j + 2 * h + e] * scale_log2 - lse_s[qi]);
              if (ragged && i * kDkv256Rows + qi >= seq) p[e] = 0.0f;
              ds[e] = p[e] * (dpt[4 * j + 2 * h + e] - di_s[qi]);
            }
            const int r = 16 * warp + g + 8 * h;
            const int off = 128 * r + 16 * ((4 * wg + j) ^ (r & 7)) + 4 * t4;
            *reinterpret_cast<uint32_t*>(pt + off) =
                sm90::pack_bf16(p[0], p[1]);
            *reinterpret_cast<uint32_t*>(dst + off) =
                sm90::pack_bf16(ds[0], ds[1]);
          }
        }
        sm90::fence_proxy_async();
        sm90::bar_sync(1, 2 * kWgThreads);

        // dV += P^T dO and dK += dS^T Q over this warpgroup's columns.
        const uint32_t pt_tile = sm90::smem_u32(pt);
        const uint32_t dst_tile = sm90::smem_u32(dst);
        sm90::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          sm90::wgmma_ss<1>(
              acc_v, sm90::desc_k_major(pt_tile, L::kPBox, 0, ks),
              sm90::desc_mn_major(do_tile + half, L::kRowBox, ks), 1);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          sm90::wgmma_ss<1>(
              acc_k, sm90::desc_k_major(dst_tile, L::kPBox, 0, ks),
              sm90::desc_mn_major(q_tile + half, L::kRowBox, ks), 1);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc_v);
        sm90::fence_regs(acc_k);
        release(&empty[s]);
      }
      n += n_tiles;

      const int row0 = k0 + warp * 16 + g, row1 = row0 + 8;
      const size_t base = (size_t)head * seq * d;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 128 * wg + 8 * j + 2 * t4;
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

int launch_dkv_sm90_d256(const Args& a) {
  const int rows[4] = {kDkv256Rows, kDkv256Keys, kDkv256Keys, kDkv256Rows};
  return launch_persistent(flash_bwd_dkv_sm90_d256, Dkv256Layout::kSmem,
                           kSm90Threads, rows,
                           (a.seq + kDkv256Keys - 1) / kDkv256Keys * a.bh, a,
                           (bf16*)a.dk, (bf16*)a.dv);
}

// K3 at D <= 256: the K3 kernel above (two consumer warpgroups of 64
// queries each) with 32-key K/V tiles and without its ping-pong. dQ takes
// 128 registers a thread; S and dP of a 32-key tile take 16 each (wgmma
// m64n32k16) and dS's bf16 fragments 8, and dQ += dS K is one wgmma
// m64n256k16 a 16-key step (RS form). Shared memory: Q and dO of 128
// queries (128 KB) and two stages of K/V (64 KB). Against the other
// candidates at (128, 1, 1024, 256) (ops/ablations/k3_dq_d256.json): the
// ping-pong of the kernel above costs 9% here (a turn handed over every
// 32 keys); one consumer of 64 queries with 64-key tiles takes the same
// time but streams each head's K and V from L2 twice as often; S and dP
// double-buffered in registers, to overlap one tile's dS with the next
// tile's products, spill (124 bytes) and serialise wgmma (C7514).
constexpr int kDq256Consumers = 2;  // consumer warpgroups, 64 queries each
constexpr int kDq256Keys = 32;      // keys a streamed K / V tile
constexpr int kDq256Stages = 2;     // K / V tiles in flight
constexpr int kDq256Rows = 64 * kDq256Consumers;  // queries an item
constexpr int kDq256Threads = (1 + kDq256Consumers) * kWgThreads;

struct Dq256Layout {
  static constexpr int kBoxes = 4;
  static constexpr int kQBox = kDq256Rows * 128;
  static constexpr int kKVBox = kDq256Keys * 128;
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kKVBytes = kBoxes * kKVBox;
  static constexpr int kQ = 0;
  static constexpr int kDO = kQBytes;
  static constexpr int kK = 2 * kQBytes;                     // K ring
  static constexpr int kV = kK + kDq256Stages * kKVBytes;    // V ring
  static constexpr int kBars = kV + kDq256Stages * kKVBytes;  // mbarriers
  static constexpr int kSmem = kBars + 8 * (2 + 2 * kDq256Stages) + 1024;
};
static_assert(Dq256Layout::kSmem <= 232448, "K3 at D <= 256: 227 KB");

// Persistent as the K3 kernel above: items are kDq256Rows-query tiles,
// head-major; the consumers take their key tiles independently. (Bounds of
// 384 threads keep ptxas's launch budget at or below the consumers'
// setmaxnreg for either number of consumers.)
__global__ void __launch_bounds__(kSm90Threads, 1)
flash_bwd_dq_sm90_d256(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const __grid_constant__ CUtensorMap do_map,
                       const float* __restrict__ lse,
                       const float* __restrict__ di, bf16* __restrict__ dq,
                       int n_items, int seq, int d, float scale) {
  using L = Dq256Layout;
  constexpr int kWarps = 4 * kDq256Consumers;
  extern __shared__ uint8_t smem_tiles[];
  uint8_t* smem = sm90::align_1024(smem_tiles);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* q_empty = q_full + 1;         // all consumers done with Q, dO
  uint64_t* full = q_empty + 1;           // [stage]: K and V tiles landed
  uint64_t* empty = full + kDq256Stages;  // [stage]: all consumers done
  const int n_qtiles = (seq + kDq256Rows - 1) / kDq256Rows;
  const int n_tiles = (seq + kDq256Keys - 1) / kDq256Keys;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    sm90::mbar_init(q_empty, kWarps);
    for (int s = 0; s < kDq256Stages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kWarps);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int role = threadIdx.x / kWgThreads;  // warpgroup
  if (role == 0) {
    // Producer: as the K3 kernel's above.
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int n = 0, it = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
        const int head = item / n_qtiles;
        const int q0 = item % n_qtiles * kDq256Rows;
        sm90::mbar_wait(q_empty, (it & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(q_full, 2 * L::kQBytes);
        for (int b = 0; b < L::kBoxes; ++b) {
          sm90::tma_load(smem + L::kQ + b * L::kQBox, &q_map, q_full, 64 * b,
                         q0, head);
          sm90::tma_load(smem + L::kDO + b * L::kQBox, &do_map, q_full,
                         64 * b, q0, head);
        }
        for (int i = 0; i < n_tiles; ++i, ++n) {
          const int s = n % kDq256Stages;
          sm90::mbar_wait(&empty[s], ((n / kDq256Stages) & 1) ^ 1);
          sm90::mbar_arrive_expect_tx(&full[s], 2 * L::kKVBytes);
          for (int b = 0; b < L::kBoxes; ++b) {
            sm90::tma_load(smem + L::kK + s * L::kKVBytes + b * L::kKVBox,
                           &k_map, &full[s], 64 * b, i * kDq256Keys, head);
            sm90::tma_load(smem + L::kV + s * L::kKVBytes + b * L::kKVBox,
                           &v_map, &full[s], 64 * b, i * kDq256Keys, head);
          }
        }
      }
    }
  } else {
    // Consumer warpgroup wg: queries q0 + 64 wg + [0, 64) of each item.
    sm90::setmaxnreg_inc<kConsumerRegs>();
    const int wg = role - 1;
    const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t4 = lane % 4;
    const uint32_t q_tile = sm90::smem_u32(smem + L::kQ);
    const uint32_t do_tile = sm90::smem_u32(smem + L::kDO);
    const int row = wg * 64 * 128;  // this warpgroup's rows in a Q/dO box
    const float scale_log2 = scale * kLog2e;
    auto k_tile = [&](int s) {
      return sm90::smem_u32(smem + L::kK + s * L::kKVBytes);
    };
    auto v_tile = [&](int s) {
      return sm90::smem_u32(smem + L::kV + s * L::kKVBytes);
    };
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(bar);
    };

    int n = 0, it = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
      const int head = item / n_qtiles;
      const int q0 = item % n_qtiles * kDq256Rows;
      const int row0 = q0 + wg * 64 + warp * 16 + g, row1 = row0 + 8;
      const size_t rows = (size_t)head * seq;
      const float lse0 = row0 < seq ? lse[rows + row0] * kLog2e : 0.0f;
      const float lse1 = row1 < seq ? lse[rows + row1] * kLog2e : 0.0f;
      const float di0 = row0 < seq ? di[rows + row0] : 0.0f;
      const float di1 = row1 < seq ? di[rows + row1] : 0.0f;
      float acc[128];  // dQ / scale, 64 x 256
#pragma unroll
      for (int r = 0; r < 128; ++r) acc[r] = 0.0f;

      sm90::mbar_wait(q_full, it & 1);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = (n + i) % kDq256Stages;
        float s[kDq256Keys / 2], dp[kDq256Keys / 2];  // S (then dS), dP
        uint32_t sa[kDq256Keys / 16][4];  // dS in bf16, the A of dS K
        sm90::mbar_wait(&full[st], ((n + i) / kDq256Stages) & 1);
        sm90::wgmma_fence();
        issue_s_dp<256, L>(s, dp, q_tile, do_tile, row, k_tile(st),
                           v_tile(st));
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(s);
        sm90::fence_regs(dp);
        if (i == n_tiles - 1) release(q_empty);
        compute_ds(s, dp, i * kDq256Keys, seq, t4, scale_log2, lse0, lse1,
                   di0, di1);
        pack_ds(sa, s);
        sm90::wgmma_fence();
        issue_dq<256, L>(acc, sa, k_tile(st));
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc);
        release(&empty[st]);
      }
      n += n_tiles;

      const size_t base = (size_t)head * seq * d;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = 8 * j + 2 * t4;
        if (col >= d) continue;
        if (row0 < seq)
          *reinterpret_cast<uint32_t*>(dq + base + (size_t)row0 * d + col) =
              sm90::pack_bf16(acc[4 * j] * scale, acc[4 * j + 1] * scale);
        if (row1 < seq)
          *reinterpret_cast<uint32_t*>(dq + base + (size_t)row1 * d + col) =
              sm90::pack_bf16(acc[4 * j + 2] * scale,
                              acc[4 * j + 3] * scale);
      }
    }
  }
}

int launch_dq_sm90_d256(const Args& a) {
  const int rows[4] = {kDq256Rows, kDq256Keys, kDq256Keys, kDq256Rows};
  return launch_persistent(flash_bwd_dq_sm90_d256, Dq256Layout::kSmem,
                           kDq256Threads, rows,
                           (a.seq + kDq256Rows - 1) / kDq256Rows * a.bh, a,
                           (bf16*)a.dq);
}

}  // namespace

// dK and dV (K2). q, k, v, dout, dk, dv: (bh, seq, d); lse and di:
// (bh, seq) float32. The sm90 route takes bf16 with d % 8 == 0 and
// d <= 256; the simt route float32 or bf16 with d <= 256.
extern "C" int mulan_flash_attention_bwd_dkv_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, void* dk, void* dv, int bh, int seq,
    int d, float scale, void* stream) {
  const Args a{q, k, v, dout, (const float*)lse, (const float*)di, nullptr,
               dk, dv, bh, seq, d, scale, (cudaStream_t)stream};
  if (!sm90_shape_ok(a, kDkv256Keys)) return (int)cudaErrorInvalidValue;
  if (a.d > 128) return launch_dkv_sm90_d256(a);
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

// dQ (K3), the same arguments but dq for dk and dv. The sm90 route takes
// bf16 with d % 8 == 0 and d <= 256; the simt route float32 or bf16 with
// d <= 256.
extern "C" int mulan_flash_attention_bwd_dq_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, void* dq, int bh, int seq, int d,
    float scale, void* stream) {
  const Args a{q, k, v, dout, (const float*)lse, (const float*)di, dq,
               nullptr, nullptr, bh, seq, d, scale, (cudaStream_t)stream};
  if (!sm90_shape_ok(a, kDq256Rows)) return (int)cudaErrorInvalidValue;
  if (a.d > 128) return launch_dq_sm90_d256(a);
  return a.d <= 64 ? launch_dq_sm90<64>(a) : launch_dq_sm90<128>(a);
}

extern "C" int mulan_flash_attention_bwd_dq_simt(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, void* dq, int bh, int seq, int d,
    float scale, int is_bf16, void* stream) {
  const Args a{q, k, v, dout, (const float*)lse, (const float*)di, dq,
               nullptr, nullptr, bh, seq, d, scale, (cudaStream_t)stream};
  return run_simt(a, is_bf16, false);
}
