// Hand-written Hopper (sm_90a) kernel for the UNet's linear-attention block, fp32.
//
// Plain C interface, built by nvcc into a shared library of its own and
// loaded with ctypes (nfdpm_tpu_torch/ops/kernels/_build.py). The entry point
// launches on the stream it is given, allocates nothing (the wrapper passes
// the context scratch buffer), and returns cudaGetLastError() so that the
// Python wrapper can raise on a refused launch. Pointers are to contiguous
// fp32 device memory; the wrapper checks device, dtype, contiguity and shapes.
//
// fused_linear_attention_f32 replaces nfdpm_tpu/ops/pallas/fused_linear_attention.py
// (fused_linear_attention -> _fused_impl -> pl.pallas_call). For each batch
// row b, with x_b [N, C] (already pre-normed), 4 heads of 32 dims:
//     q, k, v = x_b W_qkv[:, :128], x_b W_qkv[:, 128:256], x_b W_qkv[:, 256:]
//     q_h  = softmax over the head's 32 dims of q[:, h] * 32^-1/2
//     k_h  = softmax over the N tokens of each column of k[:, h]
//     ctx_h = k_h^T (v[:, h] / N)                        [32, 32]
//     o[:, h] = q_h ctx_h
//     y = LayerNorm_C(o W_out + b_out) * g                (biased var, eps 1e-5)
// The caller adds the residual.
//
// Bound. One call does 2 B N (3 C 128 + 2 128 32 + 128 C) flops and moves
// 4 (2 B N C + 4 128 C + 2 C) bytes: at B = 64, N = 256, C = 64 that is
// 1.3 GFLOP against 8.4 MB, about 20 us at the fp32 rate of 67 TFLOP/s and
// 2.5 us at 3.35 TB/s. Every product runs on the tensor cores in 3xTF32:
// each fp32 operand a is split into TF32 parts a_hi + a_lo and a b is
// formed as a_lo b_hi + a_hi b_lo + a_hi b_hi (mma.sync m16n8k8, fp32
// accumulate), which keeps the products to about 2^-19 relative
// (one-product TF32: 2^-11): fp32 parity with the JAX package's
// Precision.HIGHEST within the kernel's 1e-4 tolerance. On that route the
// bound is 3 x the flops at 495 TFLOP/s, about 11 us at that shape; what
// a block waits on is the mma.sync pipe (some 16 cycles an instruction on
// each SM quarter, tools/profile_linear_attention.py) and, at the small N
// of the served UNet, the weights' first arrival and each dependent step.
//
// Design, 256 threads a block; weights stream KCH rows at a time through
// cp.async rings (4 stages for x W_qkv; all of W_out at once in the fused
// kernel, loaded while its softmaxes run), the x tile by cp.async ahead of
// them. The plan (fused or split, tensor-core row tiles) is made by the
// wrapper (ops/kernels/fused_linear_attention.py:plan) and handed in; the
// entry point lays out shared memory for it and refuses a plan that does
// not hold:
//  1. fused, N <= 64: one launch, one batch row a block (packing several
//     rows into a block was measured and lost: fewer blocks, each longer);
//     it projects the row onto q, k, v in one product, runs the per-head q
//     softmax (a thread per row and head), the token softmax of k (two
//     threads a column; each column's maximum and sum go out), v / N, the
//     contexts k_s^T v (into shared memory and out), o = q ctx, the
//     out-projection and the LayerNorm; the contexts never leave shared
//     memory before they are used.
//  2. split, N > 64: a context pass, grid (ceil(N / 64), B): k and v of 64
//     tokens, each column's tile maximum m_t, p = exp(k - m_t), s_t = sum p
//     and the tile's unnormalised contexts, to a scratch buffer; then an
//     output pass, grid (ceil(N / 64), B): each block combines its row's
//     tile partials in tile order, flash style (m = max m_t, s = sum s_t
//     e^(m_t - m), ctx = sum ctx_t e^(m_t - m) / (s N); no atomics), the
//     first block of the row writes ctx and the statistics, and the block
//     runs q, its softmax, o = q ctx, the out-projection and the LayerNorm
//     for its 64 tokens. Two kernels behind one call.
// The LayerNorm works on the out-projection's registers: per-row sums over
// the lanes by shuffles, over the 8 warps in order through shared memory,
// two passes (mean, then variance) as the plain version. Every sum has a
// fixed order, so a call repeats bit for bit. What the TPU kernel did for
// the MXU's 128 lanes is not carried over: no padding of C to 128, no full
// [128, 128] context with the cross-head blocks masked, no global row
// maximum for the q softmax.
//
// Backward: fused_linear_attention_bwd_f32 replaces the gradient of the
// same function, _fla_bwd there (jax.vjp of _reference_impl, which XLA ran
// outside any Pallas kernel). The forward also writes each (b, head)'s k
// softmax maximum and sum beside the contexts; training saves both, so the
// backward reads the contexts instead of a second token pass to rebuild
// them, and k's token softmax from two numbers a column.
//
// Bound. The kernels do 5 128 C + 5 4096 multiply-adds a token (the q, k, v
// projections, y = o W_out and do = dy W_out^T; q ctx, dq, dctx, dk, dv)
// and move x, dout, o, dy and dqkv once (4 (3 C + 512) bytes a token): at
// B = 64, N = 256, C = 64 that is 2.0 GFLOP against 46 MB, 30.0 us at the
// fp32 rate, 12.2 us on the 3xTF32 route and 14.1 us at 3.35 TB/s; over
// the 12 calls of a stage-2 train step 0.105 ms (fp32) and 0.051 ms (the
// larger of 3xTF32 and bytes). Every product runs in 3xTF32 on the tensor
// cores (gemm_3xtf32 with its cp.async rings for the projections, W_out
// staged whole and read as stored, unmasked, for y and, transposed, for
// do; per-head products on the fragments), so what a block waits on is the
// mma.sync pipe, the first arrival of x and the weights, and the barriers
// of the LayerNorm's row sums (tools/profile_linear_attention.py). The
// plan (ops/kernels/fused_linear_attention.py: bwd_plan) is handed in:
//  3. fused, N <= 32: one launch, one batch row a block: x W_qkv in one
//     product; q's softmax, k_s from the statistics, v / N; o = q_s ctx
//     (out, for dW_out), y = o W_out + b and the LayerNorm backward
//     dy = rstd (dh - mean(dh) - yhat mean(dh yhat)), dh = dout g, on the
//     out-projection's fragments (dy out; the row's column sums of
//     dout yhat out for dg); do = dy W_out^T; dq through the per-head
//     softmax on do ctx^T's fragments; dctx = q_s^T do over all the row's
//     tokens, in shared memory; S = sum_e ctx dctx; dk = k_s (v_s dctx^T -
//     S) and dv = k_s dctx / N. The token softmax's correction
//     S[d] = sum_n k_s[n, d] dk_s[n, d] equals sum_e ctx[d, e] dctx[d, e],
//     so it needs no pass of its own.
//  4. split, above: a row pass, grid (tiles of 16 m_tiles tokens, B), as
//     the fused kernel up to dq with q alone projected, writing the tile's
//     dctx partial ([4][32][32]) and dg partial; then a k/v pass on the
//     same grid that sums its row's dctx partials in tile order, forms S,
//     projects its tokens onto k and v (all four heads, one product) and
//     writes dk and dv. Two kernels behind one call. At batch 64 two
//     blocks a row (32-token tiles) beat one fused block a row at N = 64.
// The large plain products stay with the wrapper (torch.matmul and sums):
// dx = dqkv W_qkv^T, dW_qkv = x^T dqkv, dW_out = o^T dy, db = sum dy,
// dg = the sum of the partials. Every sum runs in a fixed order, with no
// atomics, so a gradient repeats bit for bit.

#include <cuda_runtime.h>
#include <math.h>

#include "tf32_mma.cuh"

namespace {

constexpr int HEADS = 4;
constexpr int DH = 32;
constexpr int HIDDEN = HEADS * DH;  // 128
constexpr float LN_EPS = 1e-5f;
constexpr float Q_SCALE = 0.17677669529663687f;  // DH^-1/2
constexpr int MAX_DEVICES = 64;
constexpr long long MAX_SMEM_BYTES = 232448;  // a block's shared memory on Hopper

// ---------------------------------------------------------------------------
// Forward pass
// ---------------------------------------------------------------------------

constexpr int FWD_THREADS = 256;  // 8 warps
constexpr int FWD_WARPS = FWD_THREADS / 32;
constexpr int KCH = 16;           // weight rows per stage of the cp.async rings
constexpr int S_IN = 4;           // stages of the input projections' ring (x W_qkv)
constexpr int S_OUT_SPLIT = 3;    // stages of the split output pass's W_out ring
constexpr int SPLIT_TOK = 64;     // tokens per block of both split passes
constexpr int QKV_LD = 3 * HIDDEN + 4;  // row strides = 4 mod 8: conflict-free
constexpr int KV_LD = 2 * HIDDEN + 4;   // mma fragment loads
constexpr int Q_LD = HIDDEN + 4;
constexpr int PART_FLOATS = HEADS * DH * DH + 2 * HIDDEN;  // one tile's partials
constexpr int CS_LD = DH + 8;  // row stride of the staged contexts (= 8 mod 32)
constexpr int CS_FLOATS = HEADS * DH * CS_LD;

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }
// x tile row stride: C rounded to the ring's depth, plus 4
__host__ __device__ constexpr int x_ld(int c) { return round_up(c, KCH) + 4; }
// floats of a weight ring of `stages` stages for NT n-tiles of 8 columns per warp
__host__ __device__ constexpr int ring_floats(int nt, int stages) {
  return stages * KCH * (64 * nt + 8);
}
// n-tiles per warp of the out-projection (its C columns padded to 64 NT)
__host__ __device__ constexpr int out_tiles(int c) { return c <= 64 ? 1 : c <= 128 ? 2 : 4; }
// stages of the fused kernel's W_out ring: all 8 chunks of its 128 rows at
// once (loaded while the softmaxes run) where they fit, else 3
__host__ __device__ constexpr int fused_out_stages(int nto) { return nto <= 2 ? 8 : 3; }

__host__ __device__ constexpr long long max2(long long a, long long b) { return a > b ? a : b; }

// Dynamic shared memory of each forward kernel, in floats; the layouts are
// spelled out in the kernels. The wrapper's plan checks the same numbers
// against the 227 KB of a block (ops/kernels/fused_linear_attention.py:
// smem_bytes); a card test holds the two against each other.
__host__ __device__ constexpr long long fused_floats(int m_tiles, int c) {
  return max2(16LL * m_tiles * x_ld(c) + ring_floats(6, S_IN),
              16LL * m_tiles * QKV_LD + CS_FLOATS +
                  ring_floats(out_tiles(c), fused_out_stages(out_tiles(c)))) +
         10LL * 16 * m_tiles;
}
__host__ __device__ constexpr long long ctx_pass_floats(int c) {
  return max2(1LL * SPLIT_TOK * x_ld(c) + ring_floats(4, S_IN), 1LL * SPLIT_TOK * KV_LD);
}
__host__ __device__ constexpr long long out_pass_floats(int c) {
  return CS_FLOATS +
         max2(1LL * SPLIT_TOK * x_ld(c) + ring_floats(2, S_IN),
              2LL * SPLIT_TOK * Q_LD + ring_floats(out_tiles(c), S_OUT_SPLIT)) +
         10LL * SPLIT_TOK;
}

__host__ __device__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ULL) == 0;
}

// Asynchronous copy of a rows x cols tile (row stride lsrc in device memory,
// lds in shared memory); entries outside rows_valid x cols_valid become
// zeros. vec: 16-byte copies (cols, cols_valid, lsrc and the pointers are
// multiples of 4 floats), else 4-byte ones. The caller commits.
__device__ void stage_tile(float* dst, int lds, const float* src, long long lsrc, int rows,
                           int cols, int rows_valid, int cols_valid, bool vec) {
  if (vec) {
    const int c4 = cols >> 2;
    for (int i = threadIdx.x; i < rows * c4; i += FWD_THREADS) {
      const int r = i / c4, q = (i - r * c4) * 4;
      const bool ok = r < rows_valid && q < cols_valid;
      cp_async16z(dst + r * lds + q, ok ? src + r * lsrc + q : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += FWD_THREADS) {
      const int r = i / cols, q = i - r * cols;
      const bool ok = r < rows_valid && q < cols_valid;
      cp_async4z(dst + r * lds + q, ok ? src + r * lsrc + q : src, ok);
    }
  }
}

// The streamed operand of gemm_3xtf32: W's rows [0, k_total) (row stride
// ldw) and columns [col0, col0 + 64 NT), of which ncols exist; zeros past
// the edges. Stage ch holds rows [KCH ch, KCH (ch + 1)) in ring buffer
// ch % S, row stride 64 NT + 8 (= 8 mod 32: conflict-free fragments).
struct Operand {
  const float* w;
  long long ldw;
  int col0, ncols, k_total;
  bool vec;
};

template <int NT, int S>
__device__ __forceinline__ void load_stage(const Operand& op, float* ring, int ch) {
  constexpr int LDB = 64 * NT + 8;
  if (ch * KCH < op.k_total)
    stage_tile(ring + (ch % S) * KCH * LDB, LDB,
               op.w + static_cast<long long>(ch) * KCH * op.ldw + op.col0, op.ldw, KCH, 64 * NT,
               op.k_total - ch * KCH, op.ncols, op.vec);
  cp_async_commit();  // an empty group past the last stage keeps the count
}

// Issue the ring's first S - 1 stages: called before gemm_3xtf32, early
// enough that the loads overlap other work, with no other cp.async
// committed in between.
template <int NT, int S>
__device__ void gemm_prologue(const Operand& op, float* ring) {
#pragma unroll
  for (int ch = 0; ch < S - 1; ++ch) load_stage<NT, S>(op, ring, ch);
}

// acc += A W[:, col0 : col0 + 64 NT] on the tensor cores in 3xTF32
// (a_lo b_hi + a_hi b_lo + a_hi b_hi: products to about 2^-19 relative,
// never one-product TF32). A: 16 MT rows in shared memory (row stride lda, zero
// beyond column k_total up to the next multiple of KCH). W streams through
// an S-deep cp.async ring (gemm_prologue issued its first stages; each
// step issues the stage S - 1 ahead). Warp w owns columns
// [8 NT w, 8 NT (w + 1)); acc[mt][nt] is the m16n8 fragment (rows
// mt 16 + lane/4 and + 8, columns 8 (NT w + nt) + 2 (lane % 4) + 0, 1).
// Copies the caller committed before the prologue are waited for as well.
// Ends with a barrier: the ring and A may be overwritten after it.
template <int MT, int NT, int S>
__device__ void gemm_3xtf32(float (&acc)[MT][NT][4], const float* As, int lda,
                            const Operand& op, float* ring) {
  constexpr int LDB = 64 * NT + 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int chunks = (op.k_total + KCH - 1) / KCH;
  for (int ch = 0; ch < chunks; ++ch) {
    load_stage<NT, S>(op, ring, ch + S - 1);
    cp_async_wait<S - 1>();
    __syncthreads();
    const float* Bs = ring + (ch % S) * KCH * LDB + warp * 8 * NT + gq;
    const float* Ak = As + ch * KCH + tq;
#pragma unroll
    for (int kk = 0; kk < KCH; kk += 8) {
      unsigned ah[MT][4], al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* a = Ak + (mt * 16 + gq) * lda + kk;
        split_tf32(a[0], ah[mt][0], al[mt][0]);
        split_tf32(a[8 * lda], ah[mt][1], al[mt][1]);
        split_tf32(a[4], ah[mt][2], al[mt][2]);
        split_tf32(a[8 * lda + 4], ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        unsigned bh[2], bl[2];
        split_tf32(Bs[(kk + tq) * LDB + nt * 8], bh[0], bl[0]);
        split_tf32(Bs[(kk + tq + 4) * LDB + nt * 8], bh[1], bl[1]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_tf32(acc[mt][nt], al[mt], bh);
          mma_tf32(acc[mt][nt], ah[mt], bl);
          mma_tf32(acc[mt][nt], ah[mt], bh);
        }
      }
    }
    __syncthreads();  // a later stage overwrites this buffer
  }
  cp_async_wait<0>();  // only empty groups remain
}

template <int MT, int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
}

// The fragments of gemm_3xtf32 into a shared-memory tile (row stride ldo).
template <int MT, int NT>
__device__ void store_acc(const float (&acc)[MT][NT][4], float* out, int ldo) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float* o = out + (mt * 16 + gq) * ldo + warp * 8 * NT + nt * 8 + 2 * tq;
      *reinterpret_cast<float2*>(o) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(o + 8 * ldo) = make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
}

// Row sums of per-thread partials held for the fragment rows mt 16 + gq and
// + 8 (part[mt][half]): the four lanes of a row by shuffles, then the 8
// warps in order through red[8][16 MT]; out[row] = sum times scale, for all
// 16 MT rows. Barriers before the reads and at the end; no atomics.
template <int MT>
__device__ void row_sums(const float (&part)[MT][2], float* red, float* out, float scale) {
  constexpr int M = 16 * MT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float s = part[mt][half];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (tq == 0) red[warp * M + mt * 16 + gq + 8 * half] = s;
    }
  __syncthreads();
  if (threadIdx.x < M) {
    float s = 0.f;
    for (int w = 0; w < FWD_WARPS; ++w) s += red[w * M + threadIdx.x];
    out[threadIdx.x] = s * scale;
  }
  __syncthreads();
}

// The out-projection's fragments plus b_out, zero in the columns past C.
template <int MT, int NT>
__device__ void add_bias(float (&acc)[MT][NT][4], const float* __restrict__ bout, int c) {
  const int warp = threadIdx.x >> 5, tq = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = warp * 8 * NT + nt * 8 + 2 * tq;
    const float b0 = col < c ? bout[col] : 0.f, b1 = col + 1 < c ? bout[col + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      acc[mt][nt][0] = col < c ? acc[mt][nt][0] + b0 : 0.f;
      acc[mt][nt][1] = col + 1 < c ? acc[mt][nt][1] + b1 : 0.f;
      acc[mt][nt][2] = col < c ? acc[mt][nt][2] + b0 : 0.f;
      acc[mt][nt][3] = col + 1 < c ? acc[mt][nt][3] + b1 : 0.f;
    }
  }
}

// The mean and the variance of each fragment row over its C columns, two
// passes as the plain version, into mean[16 MT] and var[16 MT].
template <int MT, int NT>
__device__ void row_moments(const float (&acc)[MT][NT][4], int c, float* red, float* mean,
                            float* var) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const float inv_c = 1.f / static_cast<float>(c);
  float part[MT][2];
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float m = pass ? mean[mt * 16 + gq + 8 * half] : 0.f;
        float s = 0.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int col = warp * 8 * NT + nt * 8 + 2 * tq;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float v = acc[mt][nt][2 * half + i];
            const float d = pass ? (col + i < c ? v - m : 0.f) : v;
            s = pass ? fmaf(d, d, s) : s + d;
          }
        }
        part[mt][half] = s;
      }
    row_sums<MT>(part, red, pass ? var : mean, inv_c);
  }
}

// y[row, :] = LayerNorm(acc[row, :] + b_out) * g for rows < rows_valid, from
// the out-projection's fragments; red: [8][16 MT] partials, then the means
// and the variances.
template <int MT, int NT>
__device__ void layer_norm_store(float (&acc)[MT][NT][4], const float* __restrict__ bout,
                                 const float* __restrict__ g, float* __restrict__ y,
                                 int rows_valid, int c, float* red) {
  constexpr int M = 16 * MT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  float* mean = red + FWD_WARPS * M;
  float* var = mean + M;
  add_bias(acc, bout, c);
  row_moments(acc, c, red, mean, var);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = mt * 16 + gq + 8 * half;
      if (row >= rows_valid) continue;
      const float m = mean[row], r = rsqrtf(var[row] + LN_EPS);
      float* yr = y + static_cast<long long>(row) * c;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = warp * 8 * NT + nt * 8 + 2 * tq;
        if (col < c) yr[col] = (acc[mt][nt][2 * half] - m) * r * g[col];
        if (col + 1 < c) yr[col + 1] = (acc[mt][nt][2 * half + 1] - m) * r * g[col + 1];
      }
    }
}

// Per (row, head) softmax over the head's 32 dims, times DH^-1/2, in place
// on rows [0, rows) of a tile whose q columns start at q (row stride ld,
// = 4 mod 32): one thread per (row, head), its 32 values in registers.
// Each thread walks the dims rotated by its head, so that the 32 lanes of
// a warp (8 rows x 4 heads) hit 32 different banks.
__device__ void q_softmax(float* q, int ld, int rows) {
  for (int p = threadIdx.x; p < rows * HEADS; p += FWD_THREADS) {
    float* qh = q + (p >> 2) * ld + (p & 3) * DH;
    const int rot = p & 3;
    float v[DH];
    float m = -INFINITY;
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      v[d] = qh[(d + rot) & (DH - 1)];
      m = fmaxf(m, v[d]);
    }
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      v[d] = expf(v[d] - m);
      s += v[d];
    }
    const float r = Q_SCALE / s;
#pragma unroll
    for (int d = 0; d < DH; ++d) qh[(d + rot) & (DH - 1)] = v[d] * r;
  }
}

// Softmax over the `rows` <= 64 tokens (row stride ld) of each of the 128
// k columns starting at k, in place: p = exp(k - m), normalised by
// s = sum p when `normalise`, else left as p (the split path's tile
// partials). Two threads a column, each over one half of the rows (the 32
// lanes of a warp on 32 neighbouring columns: no bank conflicts), their
// maxima and sums combined in a fixed order through `part`
// ([2][HIDDEN] float2 in shared memory). Every thread of the block calls
// it; returns (m, s) of column threadIdx.x % 128.
__device__ float2 column_softmax(float* k, int ld, int rows, bool normalise, float2* part) {
  const int col = threadIdx.x & (HIDDEN - 1), half = threadIdx.x >> 7;
  const int r0 = half * 32, r1 = min(rows, r0 + 32);
  float* kc = k + col;
  float m = -INFINITY;
#pragma unroll 8
  for (int r = r0; r < r1; ++r) m = fmaxf(m, kc[r * ld]);
  part[half * HIDDEN + col].x = m;
  __syncthreads();
  m = fmaxf(part[col].x, part[HIDDEN + col].x);
  float s = 0.f;
#pragma unroll 8
  for (int r = r0; r < r1; ++r) {
    const float e = expf(kc[r * ld] - m);
    kc[r * ld] = e;
    s += e;
  }
  part[half * HIDDEN + col].y = s;
  __syncthreads();
  s = part[col].y + part[HIDDEN + col].y;
  if (normalise) {
    const float inv = 1.f / s;
#pragma unroll 8
    for (int r = r0; r < r1; ++r) kc[r * ld] *= inv;
  }
  return make_float2(m, s);
}

// Contexts on the tensor cores (3xTF32): ctx[h][d][e] = sum_r k[r][h 32 + d]
// v[r][h 32 + e] over rows [0, rows8), rows8 a multiple of 8, rows past the
// tokens zero in k or v (row strides ldk, ldv). Warp w takes head w / 2 and
// d in [16 (w % 2), +16), all 32 e; store(h, d, e, c_e, c_e+1) takes each
// pair of results. The backward forms dctx[h] = q_s,h^T do_h with it.
template <typename Store>
__device__ void ctx_mma(const float* k, int ldk, const float* v, int ldv, int rows8,
                        Store store) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int h = warp >> 1, d0 = (warp & 1) * 16;
  const float* ka = k + h * DH + d0 + gq;
  const float* vb = v + h * DH + gq;
  float acc[4][4] = {};
  for (int kk = 0; kk < rows8; kk += 8) {
    const float* k0 = ka + (kk + tq) * ldk;
    const float* k1 = k0 + 4 * ldk;
    const float a[4] = {k0[0], k0[8], k1[0], k1[8]};  // A[d][r] = k[r][d]
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float b[2] = {vb[(kk + tq) * ldv + nt * 8], vb[(kk + tq + 4) * ldv + nt * 8]};
      mma_3xtf32(acc[nt], a, b);
    }
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    store(h, d0 + gq, nt * 8 + 2 * tq, acc[nt][0], acc[nt][1]);
    store(h, d0 + gq + 8, nt * 8 + 2 * tq, acc[nt][2], acc[nt][3]);
  }
}

// Per-head products on the tensor cores (3xTF32) for 16 MT rows of A (row
// stride lda): acc = out[r][32 h + j] = sum_u A[r][32 h + u] B_h[u][j], with
// B_h[u][j] = Bs[(32 h + u) ldb + j] or, TRANS, Bs[(32 h + j) ldb + u] (a
// [32][32] block per head read as stored, transposed). Warp w takes head
// w / 2 and j in [16 (w % 2), +16): acc[mt][nt] is the m16n8 fragment at
// rows mt 16 + lane / 4 (+ 8) and columns head_col(nt) (+ 1).
template <int MT, bool TRANS>
__device__ void head_mma(float (&acc)[MT][2][4], const float* A, int lda, const float* Bs,
                         int ldb) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int h = warp >> 1, j0 = (warp & 1) * 16;
  const float* bh = Bs + h * DH * ldb;
#pragma unroll
  for (int kk = 0; kk < DH; kk += 8) {
    unsigned bhi[2][2], blo[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int j = j0 + nt * 8 + gq;
      split_tf32(TRANS ? bh[j * ldb + kk + tq] : bh[(kk + tq) * ldb + j], bhi[nt][0], blo[nt][0]);
      split_tf32(TRANS ? bh[j * ldb + kk + tq + 4] : bh[(kk + tq + 4) * ldb + j], bhi[nt][1],
                 blo[nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float* a = A + (mt * 16 + gq) * lda + h * DH + kk + tq;
      unsigned ah[4], al[4];
      split_tf32(a[0], ah[0], al[0]);
      split_tf32(a[8 * lda], ah[1], al[1]);
      split_tf32(a[4], ah[2], al[2]);
      split_tf32(a[8 * lda + 4], ah[3], al[3]);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        mma_tf32(acc[mt][nt], al, bhi[nt]);
        mma_tf32(acc[mt][nt], ah, blo[nt]);
        mma_tf32(acc[mt][nt], ah, bhi[nt]);
      }
    }
  }
}

// The column of fragment n-tile nt of head_mma for this thread (even; the
// pair's second is + 1).
__device__ __forceinline__ int head_col(int nt) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return (warp >> 1) * DH + (warp & 1) * 16 + nt * 8 + 2 * (lane & 3);
}

// o[r][h 32 + e] = sum_d q[r][h 32 + d] ctx[h][d][e] for 16 MT rows; cs:
// the contexts, [4][32][CS_LD].
template <int MT>
__device__ void q_ctx_mma(const float* q, int ldq, const float* cs, float* o, int ldo) {
  const int gq = (threadIdx.x & 31) >> 2;
  float acc[MT][2][4] = {};
  head_mma<MT, false>(acc, q, ldq, cs, CS_LD);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float* od = o + (mt * 16 + gq) * ldo + head_col(nt);
      *reinterpret_cast<float2*>(od) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(od + 8 * ldo) = make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
}

// Fused path, N <= 64: one block takes one batch row (N tokens, padded to
// 16 MT rows) and does the whole block in one pass. Shared memory, in
// floats (offsets from the start):
//   during the projection: x tile [16 MT][x_ld(c)], then the W_qkv ring;
//   after it, over the same space: qkv [16 MT][QKV_LD] (q | k | v; k's
//   columns later hold o), the contexts [4][32][CS_LD], the W_out ring
//   (all of it loads while the softmaxes and contexts are formed);
//   last, red [10][16 MT]: the LayerNorm's partials, means and variances.
template <int MT, int NTO>
__global__ void __launch_bounds__(FWD_THREADS, 1)
fla_fused_kernel(const float* __restrict__ x, const float* __restrict__ wqkv,
                 const float* __restrict__ wout, const float* __restrict__ bout,
                 const float* __restrict__ g, float* __restrict__ ctx,
                 float* __restrict__ stats, float* __restrict__ y, int n, int c, int vec) {
  constexpr int M = 16 * MT;
  extern __shared__ __align__(16) float smem[];
  __shared__ float2 part[2 * HIDDEN];
  const int lda = x_ld(c);
  float* xs = smem;
  float* ring = xs + M * lda;
  float* qkv = smem;
  float* cs = qkv + M * QKV_LD;
  float* ring_out = cs + CS_FLOATS;
  float* red = smem + fused_floats(MT, c) - 10 * M;
  const int b = blockIdx.x, tid = threadIdx.x;

  // 1. qkv = x W_qkv (tensor cores, 3xTF32)
  stage_tile(xs, lda, x + static_cast<long long>(b) * n * c, c, M, round_up(c, KCH), n, c, vec);
  cp_async_commit();
  {
    const Operand w_qkv{wqkv, 3 * HIDDEN, 0, 3 * HIDDEN, c, vec != 0};
    gemm_prologue<6, S_IN>(w_qkv, ring);
    float acc[MT][6][4];
    zero_acc(acc);
    gemm_3xtf32<MT, 6, S_IN>(acc, xs, lda, w_qkv, ring);
    store_acc(acc, qkv, QKV_LD);
  }
  constexpr int S_OUT = fused_out_stages(NTO);
  const Operand w_o{wout, c, 0, c, HIDDEN, vec != 0};
  gemm_prologue<NTO, S_OUT>(w_o, ring_out);
  __syncthreads();

  // 2. q's per-head softmax; k's softmax over the tokens, column by column
  //    (its maximum and sum go out for the backward pass); v / N. Rows past
  //    the tokens keep the zeros of the projection in k and v.
  q_softmax(qkv, QKV_LD, n);
  const float inv_n = 1.f / static_cast<float>(n);
  for (int i = tid; i < n * HIDDEN; i += FWD_THREADS)
    qkv[(i >> 7) * QKV_LD + 2 * HIDDEN + (i & (HIDDEN - 1))] *= inv_n;
  const float2 ms = column_softmax(qkv + HIDDEN, QKV_LD, n, true, part);
  if (tid < HIDDEN) {
    float* st = stats + (static_cast<long long>(b) * HEADS + (tid >> 5)) * 2 * DH + (tid & 31);
    st[0] = ms.x;
    st[DH] = ms.y;
  }
  __syncthreads();

  // 3. contexts ctx[h] = k_s^T (v / N), kept and written out
  float* cg = ctx + static_cast<long long>(b) * HEADS * DH * DH;
  ctx_mma(qkv + HIDDEN, QKV_LD, qkv + 2 * HIDDEN, QKV_LD, round_up(n, 8),
          [&](int h, int d, int e, float c0, float c1) {
            const float2 v = make_float2(c0, c1);
            *reinterpret_cast<float2*>(cs + (h * DH + d) * CS_LD + e) = v;
            *reinterpret_cast<float2*>(cg + (h * DH + d) * DH + e) = v;
          });
  __syncthreads();

  // 4. o = q ctx, into k's columns
  q_ctx_mma<MT>(qkv, QKV_LD, cs, qkv + HIDDEN, QKV_LD);
  __syncthreads();

  // 5. y = LayerNorm(o W_out + b) g
  float acc[MT][NTO][4];
  zero_acc(acc);
  gemm_3xtf32<MT, NTO, S_OUT>(acc, qkv + HIDDEN, QKV_LD, w_o, ring_out);
  layer_norm_store(acc, bout, g, y + static_cast<long long>(b) * n * c, n, c, red);
}

// Split path, context pass: grid (ceil(N / 64), B). A block projects its 64
// tokens onto k and v, takes each k column's tile maximum m_t and
// p = exp(k - m_t), and writes the tile's partials: m_t, s_t = sum p, and
// the unnormalised contexts sum_n p[n, d] v[n, e], to part[b][tile].
// Shared memory: x tile [64][x_ld(c)] and the ring, then kv [64][KV_LD]
// over them.
__global__ void __launch_bounds__(FWD_THREADS, 2)
fla_ctx_pass_kernel(const float* __restrict__ x, const float* __restrict__ wqkv,
                    float* __restrict__ part, int n, int c, int vec) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float2 halves[2 * HIDDEN];
  const int lda = x_ld(c);
  float* xs = smem;
  float* ring = xs + SPLIT_TOK * lda;
  float* kv = smem;
  const int tile = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int n0 = tile * SPLIT_TOK, rows = min(SPLIT_TOK, n - n0);

  stage_tile(xs, lda, x + (static_cast<long long>(b) * n + n0) * c, c, SPLIT_TOK,
             round_up(c, KCH), rows, c, vec);
  cp_async_commit();
  {
    const Operand w_kv{wqkv, 3 * HIDDEN, HIDDEN, 2 * HIDDEN, c, vec != 0};
    gemm_prologue<4, S_IN>(w_kv, ring);
    float acc[4][4][4];
    zero_acc(acc);
    gemm_3xtf32<4, 4, S_IN>(acc, xs, lda, w_kv, ring);
    store_acc(acc, kv, KV_LD);
  }
  __syncthreads();

  float* pt = part + (static_cast<long long>(b) * gridDim.x + tile) * PART_FLOATS;
  const float2 ms = column_softmax(kv, KV_LD, rows, false, halves);
  if (tid < HIDDEN) {
    pt[HEADS * DH * DH + tid] = ms.x;
    pt[HEADS * DH * DH + HIDDEN + tid] = ms.y;
  }
  __syncthreads();
  ctx_mma(kv, KV_LD, kv + HIDDEN, KV_LD, round_up(rows, 8),
          [&](int h, int d, int e, float c0, float c1) {
            *reinterpret_cast<float2*>(pt + (h * DH + d) * DH + e) = make_float2(c0, c1);
          });
}

// Split path, output pass: grid (ceil(N / 64), B). Each block combines its
// batch row's tile partials in tile order (flash-style: m = max m_t,
// s = sum s_t e^(m_t - m), ctx = sum ctx_t e^(m_t - m) / (s N)); the first
// block of the row writes ctx and the statistics out. Then q = x W_q, its
// per-head softmax, o = q ctx and y = LayerNorm(o W_out + b) g for its 64
// tokens. Shared memory: ctx [4][32][CS_LD]; then the x tile and the W_q
// ring, over which come q [64][Q_LD], o [64][Q_LD] and the W_out ring; red
// [10][64].
template <int NTO>
__global__ void __launch_bounds__(FWD_THREADS, 2)
fla_out_pass_kernel(const float* __restrict__ x, const float* __restrict__ wqkv,
                    const float* __restrict__ wout, const float* __restrict__ bout,
                    const float* __restrict__ g, const float* __restrict__ part,
                    float* __restrict__ ctx, float* __restrict__ stats,
                    float* __restrict__ y, int n, int c, int ctx_tiles, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int lda = x_ld(c);
  float* cs = smem;
  float* xs = cs + CS_FLOATS;
  float* ring = xs + SPLIT_TOK * lda;
  float* qs = xs;
  float* os = qs + SPLIT_TOK * Q_LD;
  float* ring_out = os + SPLIT_TOK * Q_LD;
  float* red = smem + out_pass_floats(c) - 10 * SPLIT_TOK;
  const int b = blockIdx.y, tid = threadIdx.x;
  const int n0 = blockIdx.x * SPLIT_TOK, rows = min(SPLIT_TOK, n - n0);

  stage_tile(xs, lda, x + (static_cast<long long>(b) * n + n0) * c, c, SPLIT_TOK,
             round_up(c, KCH), rows, c, vec);
  cp_async_commit();
  const Operand w_q{wqkv, 3 * HIDDEN, 0, HIDDEN, c, vec != 0};
  gemm_prologue<2, S_IN>(w_q, ring);

  // combine: thread (h d = tid / 2) takes 16 of the row's 32 entries
  {
    const int hd = tid >> 1, e0 = (tid & 1) * 16;
    const float* pb = part + static_cast<long long>(b) * ctx_tiles * PART_FLOATS;
    float m = -INFINITY;
#pragma unroll 4
    for (int t = 0; t < ctx_tiles; ++t) m = fmaxf(m, pb[t * PART_FLOATS + HEADS * DH * DH + hd]);
    float s = 0.f, a[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) a[j] = 0.f;
#pragma unroll 4
    for (int t = 0; t < ctx_tiles; ++t) {
      const float* pt = pb + t * PART_FLOATS;
      const float f = expf(pt[HEADS * DH * DH + hd] - m);
      s = fmaf(pt[HEADS * DH * DH + HIDDEN + hd], f, s);
      const float4* pc = reinterpret_cast<const float4*>(pt + hd * DH + e0);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 v = pc[j];
        a[4 * j] = fmaf(v.x, f, a[4 * j]);
        a[4 * j + 1] = fmaf(v.y, f, a[4 * j + 1]);
        a[4 * j + 2] = fmaf(v.z, f, a[4 * j + 2]);
        a[4 * j + 3] = fmaf(v.w, f, a[4 * j + 3]);
      }
    }
    const float inv = 1.f / (s * static_cast<float>(n));
    float* cl = cs + hd * CS_LD + e0;
#pragma unroll
    for (int j = 0; j < 16; ++j) cl[j] = a[j] * inv;
    if (blockIdx.x == 0) {
      float* cg = ctx + (static_cast<long long>(b) * HIDDEN + hd) * DH + e0;
#pragma unroll
      for (int j = 0; j < 16; ++j) cg[j] = cl[j];
      if (e0 == 0) {
        float* st = stats + (static_cast<long long>(b) * HEADS + (hd >> 5)) * 2 * DH + (hd & 31);
        st[0] = m;
        st[DH] = s;
      }
    }
  }

  // q = x W_q
  {
    float acc[4][2][4];
    zero_acc(acc);
    gemm_3xtf32<4, 2, S_IN>(acc, xs, lda, w_q, ring);
    store_acc(acc, qs, Q_LD);
  }
  const Operand w_o{wout, c, 0, c, HIDDEN, vec != 0};
  gemm_prologue<NTO, S_OUT_SPLIT>(w_o, ring_out);
  __syncthreads();
  q_softmax(qs, Q_LD, SPLIT_TOK);
  __syncthreads();
  q_ctx_mma<4>(qs, Q_LD, cs, os, Q_LD);
  __syncthreads();

  float acc[4][NTO][4];
  zero_acc(acc);
  gemm_3xtf32<4, NTO, S_OUT_SPLIT>(acc, os, Q_LD, w_o, ring_out);
  layer_norm_store(acc, bout, g, y + (static_cast<long long>(b) * n + n0) * c, rows, c, red);
}

// ---------------------------------------------------------------------------
// Backward pass
// ---------------------------------------------------------------------------

// The backward's kernels stage W_out whole, [128][wo_ld(C)] (row stride
// = 8 mod 32, zeros past C), and read it as stored for both y = o W_out and
// do = dy W_out^T. red: [8][16 MT] partials, then four per-row values.
__host__ __device__ constexpr int wo_ld(int c) { return 64 * out_tiles(c) + 8; }
constexpr int BWD_RED = 12;

// Phase stamps for tools/profile_linear_attention.py: built with
// FLA_BWD_PROFILE, thread 0 of each block records clock64() at the
// backward kernels' phase boundaries (16 slots a block); otherwise nothing.
#ifdef FLA_BWD_PROFILE
__device__ long long fla_bwd_prof[1 << 16];
#define BWD_STAMP(i) \
  if (threadIdx.x == 0) fla_bwd_prof[(blockIdx.y * gridDim.x + blockIdx.x) * 16 + (i)] = clock64()
#else
#define BWD_STAMP(i)
#endif

// Dynamic shared memory of each backward kernel, in floats; the layouts are
// spelled out in the kernels, and the wrapper's plan checks the same sums
// (ops/kernels/fused_linear_attention.py: bwd_smem_bytes).
__host__ __device__ constexpr long long bwd_tiles_floats(int m, int c) {
  return 128LL * wo_ld(c) + 1LL * m * Q_LD + 1LL * m * x_ld(c);  // W_out, o / do, dout / dy
}
__host__ __device__ constexpr long long bwd_fused_floats(int m_tiles, int c) {
  return CS_FLOATS +
         max2(16LL * m_tiles * x_ld(c) + ring_floats(6, S_IN),
              16LL * m_tiles * QKV_LD + bwd_tiles_floats(16 * m_tiles, c)) +
         BWD_RED * 16LL * m_tiles;
}
__host__ __device__ constexpr long long bwd_rows_floats(int m_tiles, int c) {
  return CS_FLOATS +
         max2(16LL * m_tiles * x_ld(c) + ring_floats(2, S_IN),
              16LL * m_tiles * Q_LD + bwd_tiles_floats(16 * m_tiles, c)) +
         BWD_RED * 16LL * m_tiles;
}
__host__ __device__ constexpr long long bwd_kv_floats(int m_tiles, int c) {
  return 2LL * CS_FLOATS + 3 * HIDDEN +
         max2(16LL * m_tiles * x_ld(c) + ring_floats(4, S_IN), 16LL * m_tiles * KV_LD);
}

// acc += A B on the tensor cores in 3xTF32, B resident in shared memory:
// B[k][n] = Bs[k ldb + n], or, TRANS, Bs[n ldb + k] (a matrix stored
// [n][k], read as stored). A: 16 MT rows (row stride lda) over k in
// [0, k8), k8 a multiple of 8, zero where A or B has no entry. Warp w owns
// columns [8 NT w, 8 NT (w + 1)), fragments as gemm_3xtf32's.
template <int MT, int NT, bool TRANS>
__device__ void gemm_smem_3xtf32(float (&acc)[MT][NT][4], const float* As, int lda,
                                 const float* Bs, int ldb, int k8) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int n0 = warp * 8 * NT + gq;
  for (int kk = 0; kk < k8; kk += 8) {
    unsigned ah[MT][4], al[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float* a = As + (mt * 16 + gq) * lda + kk + tq;
      split_tf32(a[0], ah[mt][0], al[mt][0]);
      split_tf32(a[8 * lda], ah[mt][1], al[mt][1]);
      split_tf32(a[4], ah[mt][2], al[mt][2]);
      split_tf32(a[8 * lda + 4], ah[mt][3], al[mt][3]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = n0 + nt * 8;
      unsigned bh[2], bl[2];
      split_tf32(TRANS ? Bs[col * ldb + kk + tq] : Bs[(kk + tq) * ldb + col], bh[0], bl[0]);
      split_tf32(TRANS ? Bs[col * ldb + kk + tq + 4] : Bs[(kk + tq + 4) * ldb + col], bh[1],
                 bl[1]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_tf32(acc[mt][nt], al[mt], bh);
        mma_tf32(acc[mt][nt], ah[mt], bl);
        mma_tf32(acc[mt][nt], ah[mt], bh);
      }
    }
  }
}

// The LayerNorm's backward on the out-projection's fragments (acc = o W_out,
// bias not yet added) of a tile's 16 MT rows. db holds the cotangent dout
// ([16 MT][ldd], zero past the valid rows and columns) and receives, in
// place, dy = rstd (dh - mean(dh) - yhat mean(dh yhat)), with
// yhat = (y - mean) rstd and dh = dout g (zero past C and, as dout is,
// past the valid rows); the tile's column sums of dout yhat go to dg_g[c]
// (each thread's rows in order, then the lanes of a column by shuffles: a
// fixed order). red: BWD_RED x 16 MT floats.
template <int MT, int NT>
__device__ void layer_norm_bwd(float (&acc)[MT][NT][4], const float* __restrict__ bout,
                               const float* __restrict__ g, float* db, int ldd,
                               float* __restrict__ dg_g, int c, float* red) {
  constexpr int M = 16 * MT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  float* mean = red + FWD_WARPS * M;
  float* var = mean + M;
  float* m1 = var + M;
  float* m2 = m1 + M;
  add_bias(acc, bout, c);
  row_moments(acc, c, red, mean, var);
  float gv[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int col = warp * 8 * NT + nt * 8 + 2 * tq + i;
      gv[nt][i] = col < c ? g[col] : 0.f;
    }
  float p1[MT][2], p2[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = mt * 16 + gq + 8 * half;
      const float m = mean[row], r = rsqrtf(var[row] + LN_EPS);
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = warp * 8 * NT + nt * 8 + 2 * tq;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const bool ok = col + i < c;
          const float yh = ok ? (acc[mt][nt][2 * half + i] - m) * r : 0.f;
          acc[mt][nt][2 * half + i] = yh;
          const float dh = ok ? db[row * ldd + col + i] * gv[nt][i] : 0.f;
          s1 += dh;
          s2 = fmaf(dh, yh, s2);
        }
      }
      p1[mt][half] = s1;
      p2[mt][half] = s2;
    }
  const float inv_c = 1.f / static_cast<float>(c);
  row_sums<MT>(p1, red, m1, inv_c);
  row_sums<MT>(p2, red, m2, inv_c);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = warp * 8 * NT + nt * 8 + 2 * tq;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float dg = 0.f;
      if (col + i < c) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = mt * 16 + gq + 8 * half;
            float* d = db + row * ldd + col + i;
            const float dv = *d, yh = acc[mt][nt][2 * half + i];
            dg = fmaf(dv, yh, dg);
            *d = rsqrtf(var[row] + LN_EPS) * (dv * gv[nt][i] - m1[row] - yh * m2[row]);
          }
      }
      dg += __shfl_xor_sync(0xffffffffu, dg, 4);
      dg += __shfl_xor_sync(0xffffffffu, dg, 8);
      dg += __shfl_xor_sync(0xffffffffu, dg, 16);
      if (gq == 0 && col + i < c) dg_g[col + i] = dg;
    }
  }
}

// dq through the per-head softmax, for a tile's 16 MT rows: dqs = do ctx_h^T
// on the fragments, then dq = q_s (dqs - sum_d q_s dqs / scale) (q_s: the
// scaled softmax), the row sums over a head's 32 dims from the two warps
// of the head through red[8][16 MT], added in warp order. Writes the rows
// < rows_valid of dq into dqkv_g (row stride 384).
template <int MT>
__device__ void dq_store(const float* qs, int ldq, const float* dob, const float* cs, float* red,
                         float* __restrict__ dqkv_g, int rows_valid) {
  constexpr int M = 16 * MT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  float acc[MT][2][4] = {};
  head_mma<MT, true>(acc, dob, Q_LD, cs, CS_LD);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = mt * 16 + gq + 8 * half;
      float s = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float* q = qs + row * ldq + head_col(nt);
        s = fmaf(q[0], acc[mt][nt][2 * half], s);
        s = fmaf(q[1], acc[mt][nt][2 * half + 1], s);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (tq == 0) red[warp * M + row] = s;
    }
  __syncthreads();
  const int pair = warp & ~1;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = mt * 16 + gq + 8 * half;
      if (row >= rows_valid) continue;
      const float dot = (red[pair * M + row] + red[(pair + 1) * M + row]) / Q_SCALE;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float* q = qs + row * ldq + head_col(nt);
        *reinterpret_cast<float2*>(dqkv_g + static_cast<long long>(row) * 3 * HIDDEN +
                                   head_col(nt)) =
            make_float2(q[0] * (acc[mt][nt][2 * half] - dot),
                        q[1] * (acc[mt][nt][2 * half + 1] - dot));
      }
    }
}

// dk and dv of a tile's 16 MT rows from k_s and v_s = v / N (row stride
// ld), the head's dctx [4][32][CS_LD] and S[h 32 + d] = sum_e ctx dctx:
//   dk[n, d] = k_s[n, d] (sum_e v_s[n, e] dctx[d, e] - S[d])
//   dv[n, e] = sum_d k_s[n, d] dctx[d, e] / N
// into the k and v thirds of dqkv_g's rows < rows_valid.
template <int MT>
__device__ void dk_dv_store(const float* ks, const float* vs, int ld, const float* dcs,
                            const float* s_col, float inv_n, float* __restrict__ dqkv_g,
                            int rows_valid) {
  const int gq = (threadIdx.x & 31) >> 2;
  {
    float acc[MT][2][4] = {};
    head_mma<MT, true>(acc, vs, ld, dcs, CS_LD);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = mt * 16 + gq + 8 * half;
        if (row >= rows_valid) continue;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int col = head_col(nt);
          const float* k = ks + row * ld + col;
          *reinterpret_cast<float2*>(dqkv_g + static_cast<long long>(row) * 3 * HIDDEN + HIDDEN +
                                     col) =
              make_float2(k[0] * (acc[mt][nt][2 * half] - s_col[col]),
                          k[1] * (acc[mt][nt][2 * half + 1] - s_col[col + 1]));
        }
      }
  }
  float acc[MT][2][4] = {};
  head_mma<MT, false>(acc, ks, ld, dcs, CS_LD);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = mt * 16 + gq + 8 * half;
      if (row >= rows_valid) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        *reinterpret_cast<float2*>(dqkv_g + static_cast<long long>(row) * 3 * HIDDEN +
                                   2 * HIDDEN + head_col(nt)) =
            make_float2(acc[mt][nt][2 * half] * inv_n, acc[mt][nt][2 * half + 1] * inv_n);
    }
}

// rows x cols of a shared-memory tile (row stride lds, a multiple of 4) to
// device memory (row stride cols): 16-byte stores where cols is a multiple
// of 4 and dst 16-byte aligned, else 4-byte ones.
__device__ void store_rows(float* __restrict__ dst, const float* src, int lds, int rows,
                           int cols) {
  if ((cols & 3) == 0 && aligned16(dst)) {
    const int c4 = cols >> 2;
    for (int i = threadIdx.x; i < rows * c4; i += FWD_THREADS) {
      const int r = i / c4, q = (i - r * c4) * 4;
      *reinterpret_cast<float4*>(dst + static_cast<long long>(r) * cols + q) =
          *reinterpret_cast<const float4*>(src + r * lds + q);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += FWD_THREADS) {
      const int r = i / cols, q = i - r * cols;
      dst[static_cast<long long>(r) * cols + q] = src[r * lds + q];
    }
  }
}

// The part of the backward that a tile's rows take on their own, after the
// q projection and its softmax (q_s in qs, row stride ldq; the contexts in
// cs; W_out and the cotangent tile on their way to wo and db by cp.async):
// o = q_s ctx (to ob and o_g), y = o W_out + b, the LayerNorm backward (dy
// to db and dy_g, the tile's dg to dg_g), do = dy W_out^T (to ob) and dq
// (to dqkv_g). Global pointers are at the tile's first row; ends with a
// barrier.
template <int MT, int NTO>
__device__ void bwd_rows_tile(const float* qs, int ldq, const float* cs, const float* wo,
                              float* ob, float* db, float* red, const float* __restrict__ bout,
                              const float* __restrict__ g, float* __restrict__ o_g,
                              float* __restrict__ dy_g, float* __restrict__ dg_g,
                              float* __restrict__ dqkv_g, int rows, int c) {
  const int lda = x_ld(c), ldw = wo_ld(c);
  q_ctx_mma<MT>(qs, ldq, cs, ob, Q_LD);
  __syncthreads();
  store_rows(o_g, ob, Q_LD, rows, HIDDEN);
  cp_async_wait<0>();  // W_out and the cotangent
  __syncthreads();
  BWD_STAMP(3);
  {
    float acc[MT][NTO][4];
    zero_acc(acc);
    gemm_smem_3xtf32<MT, NTO, false>(acc, ob, Q_LD, wo, ldw, HIDDEN);
    BWD_STAMP(4);
    layer_norm_bwd(acc, bout, g, db, lda, dg_g, c, red);
  }
  __syncthreads();
  store_rows(dy_g, db, lda, rows, c);
  BWD_STAMP(5);
  {
    float acc[MT][2][4];
    zero_acc(acc);
    gemm_smem_3xtf32<MT, 2, true>(acc, db, lda, wo, ldw, round_up(c, 8));
    store_acc(acc, ob, Q_LD);
  }
  __syncthreads();
  BWD_STAMP(6);
  dq_store<MT>(qs, ldq, ob, cs, red, dqkv_g, rows);
  __syncthreads();
  BWD_STAMP(7);
}

// Start the cp.async copies of W_out (whole) and of a tile's cotangent,
// zero past C and past the valid rows; committed as one group.
__device__ void stage_wout_dout(float* wo, float* db, const float* wout, const float* dout,
                                int rows, int m, int c, bool vec) {
  stage_tile(wo, wo_ld(c), wout, c, HIDDEN, wo_ld(c) - 8, HIDDEN, c, vec);
  stage_tile(db, x_ld(c), dout, c, m, round_up(c, KCH), rows, c, vec);
  cp_async_commit();
}

// Fused backward, N <= 64 (the plan takes it up to 32): one block takes one
// batch row (N tokens padded to 16 MT rows). Shared memory, in floats: the
// contexts [4][32][CS_LD]; then the x tile [16 MT][x_ld(C)] and the W_qkv
// ring, over which come qkv [16 MT][QKV_LD] (q_s | k_s | v_s), W_out
// [128][wo_ld(C)] (later dctx), o / do [16 MT][Q_LD] and dout / dy
// [16 MT][x_ld(C)]; last red.
template <int MT, int NTO>
__global__ void __launch_bounds__(FWD_THREADS, 1)
fla_bwd_fused_kernel(const float* __restrict__ x, const float* __restrict__ wqkv,
                     const float* __restrict__ wout, const float* __restrict__ bout,
                     const float* __restrict__ g, const float* __restrict__ ctx,
                     const float* __restrict__ stats, const float* __restrict__ dout,
                     float* __restrict__ o_g, float* __restrict__ dy_g,
                     float* __restrict__ dqkv, float* __restrict__ dg_part, int n, int c,
                     int vec) {
  constexpr int M = 16 * MT;
  extern __shared__ __align__(16) float smem[];
  const int lda = x_ld(c);
  float* cs = smem;
  float* xs = cs + CS_FLOATS;
  float* ring = xs + M * lda;
  float* qkv = cs + CS_FLOATS;
  float* wo = qkv + M * QKV_LD;
  float* ob = wo + HIDDEN * wo_ld(c);
  float* db = ob + M * Q_LD;
  float* red = smem + bwd_fused_floats(MT, c) - BWD_RED * M;
  const int b = blockIdx.x, tid = threadIdx.x;
  const long long row0 = static_cast<long long>(b) * n;

  // 1. x W_qkv: q, k and v in one product; the contexts arrive with x
  BWD_STAMP(0);
  stage_tile(cs, CS_LD, ctx + static_cast<long long>(b) * HEADS * DH * DH, DH, HIDDEN, DH,
             HIDDEN, DH, true);
  stage_tile(xs, lda, x + row0 * c, c, M, round_up(c, KCH), n, c, vec);
  cp_async_commit();
  {
    const Operand w_qkv{wqkv, 3 * HIDDEN, 0, 3 * HIDDEN, c, vec != 0};
    gemm_prologue<6, S_IN>(w_qkv, ring);
    float acc[MT][6][4];
    zero_acc(acc);
    gemm_3xtf32<MT, 6, S_IN>(acc, xs, lda, w_qkv, ring);
    store_acc(acc, qkv, QKV_LD);
  }
  stage_wout_dout(wo, db, wout, dout + row0 * c, n, M, c, vec != 0);
  __syncthreads();
  BWD_STAMP(1);

  // 2. q's softmax; k_s = exp(k - m) / s from the forward's statistics;
  //    v_s = v / N
  q_softmax(qkv, QKV_LD, n);
  const float inv_n = 1.f / static_cast<float>(n);
  {
    const int col = tid & (HIDDEN - 1);
    const float* st = stats + (static_cast<long long>(b) * HEADS + (col >> 5)) * 2 * DH + (col & 31);
    const float m = st[0], inv_s = 1.f / st[DH];
    for (int r = tid >> 7; r < M; r += FWD_THREADS / HIDDEN) {
      float* kr = qkv + r * QKV_LD + HIDDEN + col;
      kr[0] = expf(kr[0] - m) * inv_s;
      kr[HIDDEN] *= inv_n;
    }
  }
  __syncthreads();
  BWD_STAMP(2);

  // 3. o, y, the LayerNorm backward, do, dq
  bwd_rows_tile<MT, NTO>(qkv, QKV_LD, cs, wo, ob, db, red, bout, g, o_g + row0 * HIDDEN,
                         dy_g + row0 * c, dg_part + static_cast<long long>(b) * c,
                         dqkv + row0 * 3 * HIDDEN, n, c);

  // 4. dctx[h] = q_s,h^T do_h over all the row's tokens, over W_out's space
  float* dcs = wo;
  ctx_mma(qkv, QKV_LD, ob, Q_LD, round_up(n, 8), [&](int h, int d, int e, float c0, float c1) {
    *reinterpret_cast<float2*>(dcs + (h * DH + d) * CS_LD + e) = make_float2(c0, c1);
  });
  __syncthreads();
  BWD_STAMP(8);

  // 5. S = sum_e ctx dctx, then dk and dv
  float* s_col = red;
  if (tid < HIDDEN) {
    float a = 0.f;
    for (int e = 0; e < DH; ++e) a = fmaf(cs[tid * CS_LD + e], dcs[tid * CS_LD + e], a);
    s_col[tid] = a;
  }
  __syncthreads();
  dk_dv_store<MT>(qkv + HIDDEN, qkv + 2 * HIDDEN, QKV_LD, dcs, s_col, inv_n,
                  dqkv + row0 * 3 * HIDDEN, n);
  BWD_STAMP(9);
}

// Split backward, row pass: grid (tiles of 16 MT tokens, B). As the fused
// kernel up to dq, with q alone projected (x W_q); the tile's dctx partial
// q_s^T do goes to dctx_part[b][tile] ([4][32][32]) and its dg partial to
// dg_part[b tiles + tile]. Shared memory: the contexts; the x tile and the
// W_q ring, over which come q_s [16 MT][Q_LD], W_out, o / do and dout / dy;
// red.
template <int MT, int NTO>
__global__ void __launch_bounds__(FWD_THREADS, 1)
fla_bwd_rows_kernel(const float* __restrict__ x, const float* __restrict__ wqkv,
                    const float* __restrict__ wout, const float* __restrict__ bout,
                    const float* __restrict__ g, const float* __restrict__ ctx,
                    const float* __restrict__ dout, float* __restrict__ o_g,
                    float* __restrict__ dy_g, float* __restrict__ dqkv,
                    float* __restrict__ dg_part, float* __restrict__ dctx_part, int n, int c,
                    int vec) {
  constexpr int M = 16 * MT;
  extern __shared__ __align__(16) float smem[];
  const int lda = x_ld(c);
  float* cs = smem;
  float* xs = cs + CS_FLOATS;
  float* ring = xs + M * lda;
  float* qs = cs + CS_FLOATS;
  float* wo = qs + M * Q_LD;
  float* ob = wo + HIDDEN * wo_ld(c);
  float* db = ob + M * Q_LD;
  float* red = smem + bwd_rows_floats(MT, c) - BWD_RED * M;
  const int tile = blockIdx.x, b = blockIdx.y;
  const int n0 = tile * M, rows = min(M, n - n0);
  const long long row0 = static_cast<long long>(b) * n + n0;

  BWD_STAMP(0);
  stage_tile(cs, CS_LD, ctx + static_cast<long long>(b) * HEADS * DH * DH, DH, HIDDEN, DH,
             HIDDEN, DH, true);
  stage_tile(xs, lda, x + row0 * c, c, M, round_up(c, KCH), rows, c, vec);
  cp_async_commit();
  {
    const Operand w_q{wqkv, 3 * HIDDEN, 0, HIDDEN, c, vec != 0};
    gemm_prologue<2, S_IN>(w_q, ring);
    float acc[MT][2][4];
    zero_acc(acc);
    gemm_3xtf32<MT, 2, S_IN>(acc, xs, lda, w_q, ring);
    store_acc(acc, qs, Q_LD);
  }
  stage_wout_dout(wo, db, wout, dout + row0 * c, rows, M, c, vec != 0);
  __syncthreads();
  BWD_STAMP(1);
  q_softmax(qs, Q_LD, M);
  __syncthreads();
  BWD_STAMP(2);

  const long long part = static_cast<long long>(b) * gridDim.x + tile;
  bwd_rows_tile<MT, NTO>(qs, Q_LD, cs, wo, ob, db, red, bout, g, o_g + row0 * HIDDEN,
                         dy_g + row0 * c, dg_part + part * c, dqkv + row0 * 3 * HIDDEN, rows, c);
  float* pt = dctx_part + part * HEADS * DH * DH;
  ctx_mma(qs, Q_LD, ob, Q_LD, round_up(rows, 8), [&](int h, int d, int e, float c0, float c1) {
    *reinterpret_cast<float2*>(pt + (h * DH + d) * DH + e) = make_float2(c0, c1);
  });
  BWD_STAMP(8);
}

// Split backward, k/v pass: grid (tiles of 16 MT tokens, B). Each block sums
// its batch row's dctx partials in tile order, forms S = sum_e ctx dctx,
// projects its tokens onto k and v (all four heads, one product), forms
// k_s from the forward's statistics and v_s = v / N, and writes dk and dv.
// Shared memory: the contexts, dctx, S and the statistics [3][128]; then the
// x tile and the W_kv ring, over which comes kv [16 MT][KV_LD].
template <int MT>
__global__ void __launch_bounds__(FWD_THREADS, 1)
fla_bwd_kv_kernel(const float* __restrict__ x, const float* __restrict__ wqkv,
                  const float* __restrict__ ctx, const float* __restrict__ stats,
                  const float* __restrict__ dctx_part, float* __restrict__ dqkv, int n, int c,
                  int vec) {
  constexpr int M = 16 * MT;
  extern __shared__ __align__(16) float smem[];
  const int lda = x_ld(c);
  float* cs = smem;
  float* dcs = cs + CS_FLOATS;
  float* s_col = dcs + CS_FLOATS;
  float* col_max = s_col + HIDDEN;
  float* col_inv = col_max + HIDDEN;
  float* xs = col_inv + HIDDEN;
  float* ring = xs + M * lda;
  float* kv = xs;
  const int tile = blockIdx.x, b = blockIdx.y, tid = threadIdx.x, tiles = gridDim.x;
  const int n0 = tile * M, rows = min(M, n - n0);
  const long long row0 = static_cast<long long>(b) * n + n0;

  BWD_STAMP(10);
  stage_tile(cs, CS_LD, ctx + static_cast<long long>(b) * HEADS * DH * DH, DH, HIDDEN, DH,
             HIDDEN, DH, true);
  stage_tile(xs, lda, x + row0 * c, c, M, round_up(c, KCH), rows, c, vec);
  cp_async_commit();
  const Operand w_kv{wqkv, 3 * HIDDEN, HIDDEN, 2 * HIDDEN, c, vec != 0};
  gemm_prologue<4, S_IN>(w_kv, ring);

  // dctx: thread (h d = tid / 2) sums 16 of its row's 32 entries over the tiles
  {
    const int hd = tid >> 1, e0 = (tid & 1) * 16;
    const float* pb = dctx_part + static_cast<long long>(b) * tiles * HEADS * DH * DH + hd * DH + e0;
    float a[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) a[j] = 0.f;
#pragma unroll 4
    for (int t = 0; t < tiles; ++t) {
      const float4* pc = reinterpret_cast<const float4*>(pb + static_cast<long long>(t) * HEADS * DH * DH);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 v = pc[j];
        a[4 * j] += v.x;
        a[4 * j + 1] += v.y;
        a[4 * j + 2] += v.z;
        a[4 * j + 3] += v.w;
      }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) dcs[hd * CS_LD + e0 + j] = a[j];
    if (tid < HIDDEN) {
      const float* st = stats + (static_cast<long long>(b) * HEADS + (tid >> 5)) * 2 * DH + (tid & 31);
      col_max[tid] = st[0];
      col_inv[tid] = 1.f / st[DH];
    }
  }

  BWD_STAMP(11);
  float acc[MT][4][4];
  zero_acc(acc);
  gemm_3xtf32<MT, 4, S_IN>(acc, xs, lda, w_kv, ring);  // also waits for the contexts
  store_acc(acc, kv, KV_LD);
  if (tid < HIDDEN) {
    float a = 0.f;
    for (int e = 0; e < DH; ++e) a = fmaf(cs[tid * CS_LD + e], dcs[tid * CS_LD + e], a);
    s_col[tid] = a;
  }
  __syncthreads();
  BWD_STAMP(12);
  const float inv_n = 1.f / static_cast<float>(n);
  {
    const int col = tid & (HIDDEN - 1);
    const float m = col_max[col], inv_s = col_inv[col];
    for (int r = tid >> 7; r < M; r += FWD_THREADS / HIDDEN) {
      float* kr = kv + r * KV_LD + col;
      kr[0] = expf(kr[0] - m) * inv_s;
      kr[HIDDEN] *= inv_n;
    }
  }
  __syncthreads();
  BWD_STAMP(13);
  dk_dv_store<MT>(kv, kv + HIDDEN, KV_LD, dcs, s_col, inv_n, dqkv + row0 * 3 * HIDDEN, rows);
  BWD_STAMP(14);
}

// Dynamic shared memory of the backward for a plan, in bytes (the larger of
// the split path's two kernels); -1 where no plan exists.
long long bwd_plan_smem(int fused, int m_tiles, int c) {
  if (c <= 0 || c > 256) return -1;
  if (fused) return (m_tiles < 1 || m_tiles > 2) ? -1 : 4 * bwd_fused_floats(m_tiles, c);
  if (m_tiles != 2 && m_tiles != 4) return -1;
  return 4 * max2(bwd_rows_floats(m_tiles, c), bwd_kv_floats(m_tiles, c));
}

// The shared-memory allowance above 48 KB is raised once per device and
// kernel, on first need, so that calls captured into a CUDA graph make no
// such call.
template <typename Kernel>
cudaError_t grant_smem(Kernel kernel, long long smem, long long* granted) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > granted[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    granted[dev] = smem;
  }
  return cudaSuccess;
}

template <int MT, int NTO>
cudaError_t launch_fused(const float* x, const float* wqkv, const float* wout,
                         const float* bout, const float* g, float* ctx, float* stats,
                         float* y, int batch, int n, int c, int vec, long long smem,
                         cudaStream_t s) {
  static long long granted[MAX_DEVICES] = {};
  cudaError_t err = grant_smem(fla_fused_kernel<MT, NTO>, smem, granted);
  if (err != cudaSuccess) return err;
  fla_fused_kernel<MT, NTO><<<batch, FWD_THREADS, static_cast<size_t>(smem), s>>>(
      x, wqkv, wout, bout, g, ctx, stats, y, n, c, vec);
  return cudaGetLastError();
}

template <int MT>
cudaError_t launch_fused_mt(const float* x, const float* wqkv, const float* wout,
                            const float* bout, const float* g, float* ctx, float* stats,
                            float* y, int batch, int n, int c, int vec, long long smem,
                            cudaStream_t s) {
  switch (out_tiles(c)) {
    case 1: return launch_fused<MT, 1>(x, wqkv, wout, bout, g, ctx, stats, y, batch, n, c, vec,
                                       smem, s);
    case 2: return launch_fused<MT, 2>(x, wqkv, wout, bout, g, ctx, stats, y, batch, n, c, vec,
                                       smem, s);
    default: return launch_fused<MT, 4>(x, wqkv, wout, bout, g, ctx, stats, y, batch, n, c, vec,
                                        smem, s);
  }
}

template <int NTO>
cudaError_t launch_out_pass(const float* x, const float* wqkv, const float* wout,
                            const float* bout, const float* g, const float* part, float* ctx,
                            float* stats, float* y, int batch, int n, int c, int tiles,
                            int vec, cudaStream_t s) {
  static long long granted[MAX_DEVICES] = {};
  const long long smem = 4 * out_pass_floats(c);
  cudaError_t err = grant_smem(fla_out_pass_kernel<NTO>, smem, granted);
  if (err != cudaSuccess) return err;
  fla_out_pass_kernel<NTO><<<dim3(tiles, batch), FWD_THREADS, static_cast<size_t>(smem), s>>>(
      x, wqkv, wout, bout, g, part, ctx, stats, y, n, c, tiles, vec);
  return cudaGetLastError();
}

struct BwdArgs {
  const float *x, *wqkv, *wout, *bout, *g, *ctx, *stats, *dout;
  float *o, *dy, *dqkv, *dg_part, *dctx_part;
  int batch, n, c, vec;
};

// The smallest C that takes NTO out-projection n-tiles: a kernel whose layout
// does not fit even there is never launched, and not compiled.
__host__ __device__ constexpr int least_c(int nto) { return nto == 1 ? 1 : 32 * nto + 1; }

template <int MT, int NTO>
cudaError_t launch_bwd_fused(const BwdArgs& a, long long smem, cudaStream_t s) {
  if constexpr (4 * bwd_fused_floats(MT, least_c(NTO)) > MAX_SMEM_BYTES) {
    return cudaErrorInvalidValue;
  } else {
    static long long granted[MAX_DEVICES] = {};
    cudaError_t err = grant_smem(fla_bwd_fused_kernel<MT, NTO>, smem, granted);
    if (err != cudaSuccess) return err;
    fla_bwd_fused_kernel<MT, NTO><<<a.batch, FWD_THREADS, static_cast<size_t>(smem), s>>>(
        a.x, a.wqkv, a.wout, a.bout, a.g, a.ctx, a.stats, a.dout, a.o, a.dy, a.dqkv, a.dg_part,
        a.n, a.c, a.vec);
    return cudaGetLastError();
  }
}

template <int MT, int NTO>
cudaError_t launch_bwd_split(const BwdArgs& a, cudaStream_t s) {
  if constexpr (4 * bwd_rows_floats(MT, least_c(NTO)) > MAX_SMEM_BYTES) {
    return cudaErrorInvalidValue;
  } else {
    static long long granted_rows[MAX_DEVICES] = {}, granted_kv[MAX_DEVICES] = {};
    const long long rows_smem = 4 * bwd_rows_floats(MT, a.c);
    const long long kv_smem = 4 * bwd_kv_floats(MT, a.c);
    cudaError_t err = grant_smem(fla_bwd_rows_kernel<MT, NTO>, rows_smem, granted_rows);
    if (err == cudaSuccess) err = grant_smem(fla_bwd_kv_kernel<MT>, kv_smem, granted_kv);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.n + 16 * MT - 1) / (16 * MT), a.batch);
    fla_bwd_rows_kernel<MT, NTO><<<grid, FWD_THREADS, static_cast<size_t>(rows_smem), s>>>(
        a.x, a.wqkv, a.wout, a.bout, a.g, a.ctx, a.dout, a.o, a.dy, a.dqkv, a.dg_part,
        a.dctx_part, a.n, a.c, a.vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    fla_bwd_kv_kernel<MT><<<grid, FWD_THREADS, static_cast<size_t>(kv_smem), s>>>(
        a.x, a.wqkv, a.ctx, a.stats, a.dctx_part, a.dqkv, a.n, a.c, a.vec);
    return cudaGetLastError();
  }
}

template <int NTO>
cudaError_t launch_bwd(const BwdArgs& a, int fused, int m_tiles, long long smem,
                       cudaStream_t s) {
  if (!fused) return m_tiles == 2 ? launch_bwd_split<2, NTO>(a, s) : launch_bwd_split<4, NTO>(a, s);
  return m_tiles == 1 ? launch_bwd_fused<1, NTO>(a, smem, s) : launch_bwd_fused<2, NTO>(a, smem, s);
}

}  // namespace

extern "C" {

// Dynamic shared memory of the forward at C channels for a plan, in bytes
// (the larger of the two kernels' on the split path); -1 where no plan
// exists (C > 256, or m_tiles out of range on the fused path).
long long fused_linear_attention_plan_smem(int fused, int m_tiles, int c) {
  if (c <= 0 || c > 256) return -1;
  if (fused) {
    if (m_tiles < 1 || m_tiles > 4) return -1;
    return 4 * fused_floats(m_tiles, c);
  }
  const long long a = ctx_pass_floats(c), b = out_pass_floats(c);
  return 4 * (a > b ? a : b);
}

// The same for the backward (the larger of its two kernels' on the split
// path); -1 where no plan exists (C > 256, m_tiles other than 1 or 2 fused,
// other than 2 or 4 split).
long long fused_linear_attention_bwd_smem_bytes(int fused, int m_tiles, int c) {
  return bwd_plan_smem(fused, m_tiles, c);
}

// x [B, N, C], w_qkv [C, 384], w_out [128, C], b_out [C], g [C] -> y [B, N, C];
// ctx [B, 4, 32, 32] and stats [B, 4, 2, 32] (the k softmax's maximum and
// sum per column) are written too: scratch for serving, saved for the
// backward pass in training. The plan: fused (one batch row a block, N <=
// 16 m_tiles) or split (part: scratch of [B, ceil(N / 64), 4 32 32 + 2 128]
// floats); vec: C is a multiple of 4 and every pointer 16-byte aligned
// (16-byte copies). A plan that does not hold is refused with
// cudaErrorInvalidValue before anything is launched.
int fused_linear_attention_f32(const float* x, const float* wqkv, const float* wout,
                               const float* bout, const float* g, float* ctx, float* stats,
                               float* y, float* part, int batch, int n, int c, int fused,
                               int m_tiles, int vec, void* stream) {
  if (batch <= 0 || n <= 0 || c <= 0) return static_cast<int>(cudaSuccess);
  const long long smem = fused_linear_attention_plan_smem(fused, m_tiles, c);
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (vec && (c % 4 != 0 || !aligned16(x) || !aligned16(wqkv) || !aligned16(wout) ||
              !aligned16(y)))
    return static_cast<int>(cudaErrorInvalidValue);
  // float2 stores of ctx and stats
  if ((reinterpret_cast<unsigned long long>(ctx) & 7ULL) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fused) {
    if (n > 16 * m_tiles) return static_cast<int>(cudaErrorInvalidValue);
    switch (m_tiles) {
      case 1: return static_cast<int>(launch_fused_mt<1>(x, wqkv, wout, bout, g, ctx, stats, y,
                                                         batch, n, c, vec, smem, s));
      case 2: return static_cast<int>(launch_fused_mt<2>(x, wqkv, wout, bout, g, ctx, stats, y,
                                                         batch, n, c, vec, smem, s));
      case 3: return static_cast<int>(launch_fused_mt<3>(x, wqkv, wout, bout, g, ctx, stats, y,
                                                         batch, n, c, vec, smem, s));
      default: return static_cast<int>(launch_fused_mt<4>(x, wqkv, wout, bout, g, ctx, stats,
                                                          y, batch, n, c, vec, smem, s));
    }
  }
  if (part == nullptr || !aligned16(part)) return static_cast<int>(cudaErrorInvalidValue);
  static long long granted[MAX_DEVICES] = {};
  const long long ctx_smem = 4 * ctx_pass_floats(c);
  cudaError_t err = grant_smem(fla_ctx_pass_kernel, ctx_smem, granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (n + SPLIT_TOK - 1) / SPLIT_TOK;
  fla_ctx_pass_kernel<<<dim3(tiles, batch), FWD_THREADS, static_cast<size_t>(ctx_smem), s>>>(
      x, wqkv, part, n, c, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (out_tiles(c)) {
    case 1: return static_cast<int>(launch_out_pass<1>(x, wqkv, wout, bout, g, part, ctx, stats,
                                                       y, batch, n, c, tiles, vec, s));
    case 2: return static_cast<int>(launch_out_pass<2>(x, wqkv, wout, bout, g, part, ctx, stats,
                                                       y, batch, n, c, tiles, vec, s));
    default: return static_cast<int>(launch_out_pass<4>(x, wqkv, wout, bout, g, part, ctx,
                                                        stats, y, batch, n, c, tiles, vec, s));
  }
}

// The backward pass up to the plain products: from the forward's inputs, its
// ctx and stats and the cotangent dout [B, N, C], writes o [B, N, 128],
// dy [B, N, C] (the out-projection's output gradient), dqkv [B, N, 384] and
// the per-tile column sums dg_part [B, tiles, C] of dout yhat; the wrapper
// forms dx, dW_qkv, dW_out, db_out and dg from them. The plan: fused (one
// batch row a block, m_tiles 1 or 2, N <= 16 m_tiles, tiles = 1) or split
// (tiles of 16 m_tiles tokens, m_tiles 2 or 4; dctx_part: scratch of
// [B, tiles, 4, 32, 32] floats). vec: C a multiple of 4 and x, w_qkv, w_out,
// dout 16-byte aligned (16-byte copies). ctx, o and dctx_part must be
// 16-byte aligned, dqkv 8-byte. A plan or operand that does not hold is
// refused with cudaErrorInvalidValue before anything is launched.
int fused_linear_attention_bwd_f32(const float* x, const float* wqkv, const float* wout,
                                   const float* bout, const float* g, const float* ctx,
                                   const float* stats, const float* dout, float* o,
                                   float* dy, float* dqkv, float* dg_part, float* dctx_part,
                                   int batch, int n, int c, int fused, int m_tiles, int vec,
                                   void* stream) {
  if (batch <= 0 || n <= 0 || c <= 0) return static_cast<int>(cudaSuccess);
  const long long smem = bwd_plan_smem(fused, m_tiles, c);
  if (smem < 0 || smem > MAX_SMEM_BYTES || (fused && n > 16 * m_tiles))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && (c % 4 != 0 || !aligned16(x) || !aligned16(wqkv) || !aligned16(wout) ||
              !aligned16(dout)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(ctx) || !aligned16(o) || (reinterpret_cast<unsigned long long>(dqkv) & 7ULL) ||
      (!fused && (dctx_part == nullptr || !aligned16(dctx_part))))
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{x, wqkv, wout, bout, g, ctx, stats, dout, o, dy, dqkv, dg_part, dctx_part,
                  batch, n, c, vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_tiles(c)) {
    case 1: return static_cast<int>(launch_bwd<1>(a, fused, m_tiles, smem, s));
    case 2: return static_cast<int>(launch_bwd<2>(a, fused, m_tiles, smem, s));
    default: return static_cast<int>(launch_bwd<4>(a, fused, m_tiles, smem, s));
  }
}

}  // extern "C"
