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
// 1.3 GFLOP against 8.4 MB, so the largest shapes of the served UNet are
// bound by fp32 arithmetic (about 20 us at 67 TFLOP/s), not by memory.
// No tensor cores: TF32 would break the fp32 parity with the JAX package.
//
// Design, two kernels behind one call, both with 256 threads:
//  1. context pass, one block per (head, batch row). It walks the tokens in
//     tiles of CTX_TOK: projects the tile onto the head's 32 k and 32 v
//     columns (x and W staged in shared memory in chunks of KC channels,
//     fp32 FMAs), then folds the tile into a running softmax over tokens,
//     flash-attention style: per k column a running maximum and sum, and the
//     32x32 context held in registers (4 entries a thread), rescaled by
//     exp(m_old - m_new) whenever the maximum moves. Any N works, and no
//     [N, 64] tile of k and v is ever kept whole.
//  2. output pass, one block per (tile of OUT_TOK tokens, batch row): the q
//     projection, the per-head softmax (one warp per (token, head), shuffle
//     reductions, stabilised by the head's own maximum), q_h ctx_h from the
//     staged contexts, the out-projection in chunks of WO_COLS output
//     channels, and a two-pass mean/variance of each token's C outputs in
//     shared memory.
// What the TPU kernel did for the MXU's 128 lanes is not carried over: no
// padding of C to 128 (that doubles the bytes at C = 64), no full
// [128, 128] context with the cross-head blocks masked to zero (4x the
// useful products), no global row maximum for the q softmax (the per-head
// maximum is the same function and cannot underflow a whole head).
//
// Backward: fused_linear_attention_bwd_f32 replaces the gradient of the
// same function, _fla_bwd there (jax.vjp of _reference_impl, which XLA ran
// outside any Pallas kernel). The forward also writes each (b, head)'s k
// softmax maximum and sum beside the contexts; training saves both, so the
// backward reads the contexts instead of a second token pass to rebuild
// them, and k's token softmax from two numbers a column. Two kernels:
//  3. row pass, one block per (tile of OUT_TOK tokens, batch row): q, its
//     per-head softmax, o = q ctx and y = o W_out + b recomputed as in the
//     output pass; the LayerNorm backward dy = rstd (dh - mean(dh) - yhat
//     mean(dh yhat)) with dh = dOut g; do = dy W_out^T; dq through the
//     per-head softmax; the tile's partial sums of dctx[h] = q_h^T do_h and
//     of dg = sum dOut yhat. Writes o, dy, the q third of dqkv, the partials.
//  4. head pass, one block per (head, batch row): the dctx partials summed
//     in tile order, then a walk over token tiles that recomputes the head's
//     k and v columns and writes dk = k_s (v / N dctx^T - S) and
//     dv = k_s dctx / N, where the token softmax's correction
//     S[d] = sum_n k_s[n, d] dk_s[n, d] equals sum_e ctx[d, e] dctx[d, e]
//     and so needs no pass of its own.
// The large plain products stay with the wrapper (torch.matmul and sums):
// dx = dqkv W_qkv^T, dW_qkv = x^T dqkv, dW_out = o^T dy, db = sum dy,
// dg = the sum of the partials. Every sum runs in a fixed order, with no
// atomics, so a gradient repeats bit for bit. The backward moves about
// twice the forward's bytes and does about three times its products: at
// the training shapes it is bound by fp32 arithmetic, as the forward.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int HEADS = 4;
constexpr int DH = 32;
constexpr int HIDDEN = HEADS * DH;  // 128
constexpr int THREADS = 256;
constexpr int CTX_TOK = 32;  // tokens per tile of the context pass
constexpr int KC = 32;       // channels per staged chunk of a projection
constexpr int OUT_TOK = 16;  // tokens per block of the output pass
constexpr int WO_COLS = 64;  // output channels per chunk of the out-projection
constexpr int QS = HIDDEN + 1;  // odd row strides: no bank conflicts
constexpr int CS = DH + 1;
constexpr float LN_EPS = 1e-5f;
constexpr float Q_SCALE = 0.17677669529663687f;  // DH^-1/2
constexpr int MAX_DEVICES = 64;

// Shared memory of the output pass, in floats, before the [OUT_TOK, C] y tile.
constexpr int OUT_FIXED_FLOATS =
    OUT_TOK * (KC + 1)                                        // x chunk
    + (KC * HIDDEN > HIDDEN * WO_COLS ? KC * HIDDEN : HIDDEN * WO_COLS)  // W chunk
    + 2 * OUT_TOK * QS                                        // q, o
    + HEADS * DH * CS;                                        // contexts

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ctx[b, h] = softmax_n(k_h)^T (v_h / N), grid (HEADS, B).
__global__ void __launch_bounds__(THREADS)
fla_context_kernel(const float* __restrict__ x, const float* __restrict__ wqkv,
                   float* __restrict__ ctx, float* __restrict__ stats, int n, int c) {
  __shared__ float xs[CTX_TOK][KC + 1];
  __shared__ float ws[KC][2 * DH];           // the head's [k | v] columns
  __shared__ float kv[CTX_TOK][2 * DH + 1];  // projected tile; k part becomes exp(k - m)
  __shared__ float col_max[DH], col_sum[DH], col_scale[DH];

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const float* xb = x + static_cast<long long>(b) * n * c;
  const int pr = tid >> 3, pc = tid & 7;  // projection: row pr, columns pc + 8j
  const int cd = tid >> 3, ce = tid & 7;  // context: row cd, columns ce + 8j
  float acc_ctx[4] = {0.f, 0.f, 0.f, 0.f};
  if (tid < DH) {
    col_max[tid] = -INFINITY;
    col_sum[tid] = 0.f;
  }

  for (int n0 = 0; n0 < n; n0 += CTX_TOK) {
    const int rows = min(CTX_TOK, n - n0);
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int c0 = 0; c0 < c; c0 += KC) {
      const int kc = min(KC, c - c0);
      for (int i = tid; i < CTX_TOK * KC; i += THREADS) {
        const int r = i / KC, k = i - r * KC;
        xs[r][k] = (r < rows && k < kc) ? xb[static_cast<long long>(n0 + r) * c + c0 + k] : 0.f;
      }
      for (int i = tid; i < KC * 2 * DH; i += THREADS) {
        const int k = i / (2 * DH), j = i - k * 2 * DH;
        const int col = (j < DH ? HIDDEN : 2 * HIDDEN - DH) + h * DH + j;
        ws[k][j] = k < kc ? wqkv[static_cast<long long>(c0 + k) * 3 * HIDDEN + col] : 0.f;
      }
      __syncthreads();
      for (int k = 0; k < kc; ++k) {
        const float xv = xs[pr][k];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] = fmaf(xv, ws[k][pc + 8 * j], acc[j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) kv[pr][pc + 8 * j] = acc[j];
    __syncthreads();

    if (tid < DH) {  // one thread per k column: running max and sum
      const float m_old = col_max[tid];
      float m = m_old;
      for (int r = 0; r < rows; ++r) m = fmaxf(m, kv[r][tid]);
      float s = 0.f;
      for (int r = 0; r < rows; ++r) {
        const float p = expf(kv[r][tid] - m);
        kv[r][tid] = p;
        s += p;
      }
      const float alpha = expf(m_old - m);  // 0 on the first tile
      col_sum[tid] = col_sum[tid] * alpha + s;
      col_max[tid] = m;
      col_scale[tid] = alpha;
    }
    __syncthreads();
    const float alpha = col_scale[cd];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float a = acc_ctx[j] * alpha;
      for (int r = 0; r < rows; ++r) a = fmaf(kv[r][cd], kv[r][DH + ce + 8 * j], a);
      acc_ctx[j] = a;
    }
    __syncthreads();  // the next tile overwrites kv
  }
  const float denom = col_sum[cd] * static_cast<float>(n);
  float* out = ctx + (static_cast<long long>(b) * HEADS + h) * DH * DH + cd * DH;
#pragma unroll
  for (int j = 0; j < 4; ++j) out[ce + 8 * j] = acc_ctx[j] / denom;
  if (tid < DH) {  // the k softmax's maximum and sum, for the backward pass
    float* st = stats + (static_cast<long long>(b) * HEADS + h) * 2 * DH;
    st[tid] = col_max[tid];
    st[DH + tid] = col_sum[tid];
  }
}

// y = LayerNorm(concat_h(softmax_h(q) * scale . ctx_h) W_out + b) * g,
// grid (ceil(N / OUT_TOK), B).
__global__ void __launch_bounds__(THREADS)
fla_output_kernel(const float* __restrict__ x, const float* __restrict__ wqkv,
                  const float* __restrict__ ctx, const float* __restrict__ wout,
                  const float* __restrict__ bout, const float* __restrict__ g,
                  float* __restrict__ y, int n, int c) {
  extern __shared__ float smem[];
  float* xs = smem;                                   // [OUT_TOK][KC + 1]
  float* wbuf = xs + OUT_TOK * (KC + 1);              // [KC][HIDDEN] or [HIDDEN][WO_COLS]
  float* qs = wbuf + (KC * HIDDEN > HIDDEN * WO_COLS ? KC * HIDDEN : HIDDEN * WO_COLS);
  float* os = qs + OUT_TOK * QS;                      // [OUT_TOK][QS]
  float* cs = os + OUT_TOK * QS;                      // [HEADS * DH][CS]
  float* ys = cs + HEADS * DH * CS;                   // [OUT_TOK][c]

  const int b = blockIdx.y, n0 = blockIdx.x * OUT_TOK, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int rows = min(OUT_TOK, n - n0);
  const float* xb = x + (static_cast<long long>(b) * n + n0) * c;
  const int pr = tid >> 4, pc = tid & 15;  // row pr, columns pc + 16j

  const float* ctx_b = ctx + static_cast<long long>(b) * HEADS * DH * DH;
  for (int i = tid; i < HEADS * DH * DH; i += THREADS) {
    const int row = i / DH, e = i - row * DH;  // row = h * DH + d
    cs[row * CS + e] = ctx_b[i];
  }

  // q = x W_q
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < c; c0 += KC) {
    const int kc = min(KC, c - c0);
    for (int i = tid; i < OUT_TOK * KC; i += THREADS) {
      const int r = i / KC, k = i - r * KC;
      xs[r * (KC + 1) + k] = (r < rows && k < kc) ? xb[static_cast<long long>(r) * c + c0 + k] : 0.f;
    }
    for (int i = tid; i < KC * HIDDEN; i += THREADS) {
      const int k = i / HIDDEN, j = i - k * HIDDEN;
      wbuf[i] = k < kc ? wqkv[static_cast<long long>(c0 + k) * 3 * HIDDEN + j] : 0.f;
    }
    __syncthreads();
    for (int k = 0; k < kc; ++k) {
      const float xv = xs[pr * (KC + 1) + k];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = fmaf(xv, wbuf[k * HIDDEN + pc + 16 * j], acc[j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) qs[pr * QS + pc + 16 * j] = acc[j];
  __syncthreads();

  // per-head softmax over the head's 32 dims, times dim_head^-1/2;
  // one warp per (token, head), the lane is the dim
  for (int p = warp; p < OUT_TOK * HEADS; p += THREADS / 32) {
    float* q = qs + (p / HEADS) * QS + (p % HEADS) * DH;
    const float v = q[lane];
    const float e = expf(v - warp_max(v));
    q[lane] = e / warp_sum(e) * Q_SCALE;
  }
  __syncthreads();

  // o[:, h] = q_h ctx_h
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = pc + 16 * j, h = col / DH, e = col - h * DH;
    const float* q = qs + pr * QS + h * DH;
    const float* cc = cs + h * DH * CS + e;
    float a = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) a = fmaf(q[d], cc[d * CS], a);
    os[pr * QS + col] = a;
  }
  __syncthreads();

  // y = o W_out + b, WO_COLS output channels at a time
  for (int c0 = 0; c0 < c; c0 += WO_COLS) {
    const int wc = min(WO_COLS, c - c0);
    for (int i = tid; i < HIDDEN * WO_COLS; i += THREADS) {
      const int k = i / WO_COLS, j = i - k * WO_COLS;
      wbuf[i] = j < wc ? wout[static_cast<long long>(k) * c + c0 + j] : 0.f;
    }
    __syncthreads();
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < HIDDEN; ++k) {
      const float ov = os[pr * QS + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) a[j] = fmaf(ov, wbuf[k * WO_COLS + pc + 16 * j], a[j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = pc + 16 * j;
      if (col < wc) ys[pr * c + c0 + col] = a[j] + bout[c0 + col];
    }
    __syncthreads();
  }

  // biasless channel LayerNorm, two passes over the row; one warp per token
  float* yb = y + (static_cast<long long>(b) * n + n0) * c;
  for (int r = warp; r < rows; r += THREADS / 32) {
    const float* row = ys + r * c;
    float s = 0.f;
    for (int k = lane; k < c; k += 32) s += row[k];
    const float mean = warp_sum(s) / static_cast<float>(c);
    float ss = 0.f;
    for (int k = lane; k < c; k += 32) {
      const float d = row[k] - mean;
      ss = fmaf(d, d, ss);
    }
    const float inv = rsqrtf(warp_sum(ss) / static_cast<float>(c) + LN_EPS);
    for (int k = lane; k < c; k += 32)
      yb[static_cast<long long>(r) * c + k] = (row[k] - mean) * inv * g[k];
  }
}

// ---------------------------------------------------------------------------
// Backward pass
// ---------------------------------------------------------------------------

// Shared memory of the row pass, in floats, before its two [OUT_TOK, C] tiles.
constexpr int BWD_WB = (KC * HIDDEN > HIDDEN * (WO_COLS + 1)) ? KC * HIDDEN
                                                              : HIDDEN * (WO_COLS + 1);
constexpr int BWD_FIXED_FLOATS =
    OUT_TOK * (KC + 1)    // x chunk
    + BWD_WB              // W chunk (W_q, W_out, then W_out transposed)
    + 3 * OUT_TOK * QS    // q softmax, o (later do), dq of the softmax output
    + HEADS * DH * CS;    // contexts

// Row pass, grid (ceil(N / OUT_TOK), B): for its tokens it recomputes q, the
// per-head softmax, o = q ctx, y = o W_out + b and the LayerNorm, then runs
// the LayerNorm backward (dy), do = dy W_out^T, dq through the per-head
// softmax, and the tile's share of dctx[h] = sum_n q_h[n]^T do_h[n] and of
// dg = sum_n dOut[n] yhat[n]. Writes o, dy, the q third of dqkv and the two
// per-tile partial sums.
__global__ void __launch_bounds__(THREADS)
fla_bwd_rows_kernel(const float* __restrict__ x, const float* __restrict__ wqkv,
                    const float* __restrict__ ctx, const float* __restrict__ wout,
                    const float* __restrict__ bout, const float* __restrict__ g,
                    const float* __restrict__ dout, float* __restrict__ o_out,
                    float* __restrict__ dy_out, float* __restrict__ dqkv,
                    float* __restrict__ dg_part, float* __restrict__ dctx_part,
                    int n, int c) {
  extern __shared__ float smem[];
  float* xs = smem;                       // [OUT_TOK][KC + 1]
  float* wbuf = xs + OUT_TOK * (KC + 1);  // BWD_WB
  float* qs = wbuf + BWD_WB;              // [OUT_TOK][QS], scaled q softmax
  float* os = qs + OUT_TOK * QS;          // [OUT_TOK][QS], o, then do
  float* ds = os + OUT_TOK * QS;          // [OUT_TOK][QS], dL/dq (softmax output)
  float* cs = ds + OUT_TOK * QS;          // [HEADS * DH][CS]
  float* ys = cs + HEADS * DH * CS;       // [OUT_TOK][c], y, then dy
  float* gs = ys + OUT_TOK * c;           // [OUT_TOK][c], dOut * yhat

  const int b = blockIdx.y, blk = blockIdx.x, n0 = blk * OUT_TOK, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int rows = min(OUT_TOK, n - n0);
  const long long row0 = static_cast<long long>(b) * n + n0;  // first token's row
  const float* xb = x + row0 * c;
  const int pr = tid >> 4, pc = tid & 15;  // row pr, columns pc + 16j

  const float* ctx_b = ctx + static_cast<long long>(b) * HEADS * DH * DH;
  for (int i = tid; i < HEADS * DH * DH; i += THREADS) {
    const int row = i / DH, e = i - row * DH;
    cs[row * CS + e] = ctx_b[i];
  }

  // q = x W_q, as the forward's output pass
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < c; c0 += KC) {
    const int kc = min(KC, c - c0);
    for (int i = tid; i < OUT_TOK * KC; i += THREADS) {
      const int r = i / KC, k = i - r * KC;
      xs[r * (KC + 1) + k] = (r < rows && k < kc) ? xb[static_cast<long long>(r) * c + c0 + k] : 0.f;
    }
    for (int i = tid; i < KC * HIDDEN; i += THREADS) {
      const int k = i / HIDDEN, j = i - k * HIDDEN;
      wbuf[i] = k < kc ? wqkv[static_cast<long long>(c0 + k) * 3 * HIDDEN + j] : 0.f;
    }
    __syncthreads();
    for (int k = 0; k < kc; ++k) {
      const float xv = xs[pr * (KC + 1) + k];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = fmaf(xv, wbuf[k * HIDDEN + pc + 16 * j], acc[j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) qs[pr * QS + pc + 16 * j] = acc[j];
  __syncthreads();

  for (int p = warp; p < OUT_TOK * HEADS; p += THREADS / 32) {
    float* q = qs + (p / HEADS) * QS + (p % HEADS) * DH;
    const float v = q[lane];
    const float e = expf(v - warp_max(v));
    q[lane] = e / warp_sum(e) * Q_SCALE;
  }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = pc + 16 * j, h = col / DH, e = col - h * DH;
    const float* q = qs + pr * QS + h * DH;
    const float* cc = cs + h * DH * CS + e;
    float a = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) a = fmaf(q[d], cc[d * CS], a);
    os[pr * QS + col] = a;
  }
  __syncthreads();

  // y = o W_out + b
  for (int c0 = 0; c0 < c; c0 += WO_COLS) {
    const int wc = min(WO_COLS, c - c0);
    for (int i = tid; i < HIDDEN * WO_COLS; i += THREADS) {
      const int k = i / WO_COLS, j = i - k * WO_COLS;
      wbuf[i] = j < wc ? wout[static_cast<long long>(k) * c + c0 + j] : 0.f;
    }
    __syncthreads();
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < HIDDEN; ++k) {
      const float ov = os[pr * QS + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) a[j] = fmaf(ov, wbuf[k * WO_COLS + pc + 16 * j], a[j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = pc + 16 * j;
      if (col < wc) ys[pr * c + c0 + col] = a[j] + bout[c0 + col];
    }
    __syncthreads();
  }

  // o goes out for dW_out = o^T dy
  for (int i = tid; i < rows * HIDDEN; i += THREADS) {
    const int r = i / HIDDEN, k = i - r * HIDDEN;
    o_out[(row0 + r) * HIDDEN + k] = os[r * QS + k];
  }

  // LayerNorm backward, one warp per token: with yhat = (y - mean) rstd and
  // dh = dOut g, dy = rstd (dh - mean(dh) - yhat mean(dh yhat))
  for (int r = warp; r < OUT_TOK; r += THREADS / 32) {
    float* row = ys + r * c;
    float* grow = gs + r * c;
    if (r >= rows) {
      for (int k = lane; k < c; k += 32) row[k] = grow[k] = 0.f;
      continue;
    }
    const float* drow = dout + (row0 + r) * c;
    float s = 0.f;
    for (int k = lane; k < c; k += 32) s += row[k];
    const float mean = warp_sum(s) / static_cast<float>(c);
    float ss = 0.f;
    for (int k = lane; k < c; k += 32) {
      const float d = row[k] - mean;
      ss = fmaf(d, d, ss);
    }
    const float rstd = rsqrtf(warp_sum(ss) / static_cast<float>(c) + LN_EPS);
    float s1 = 0.f, s2 = 0.f;
    for (int k = lane; k < c; k += 32) {
      const float yhat = (row[k] - mean) * rstd;
      const float dh = drow[k] * g[k];
      s1 += dh;
      s2 = fmaf(dh, yhat, s2);
    }
    const float m1 = warp_sum(s1) / static_cast<float>(c);
    const float m2 = warp_sum(s2) / static_cast<float>(c);
    for (int k = lane; k < c; k += 32) {
      const float yhat = (row[k] - mean) * rstd;
      const float dv = drow[k];
      const float dyv = rstd * (dv * g[k] - m1 - yhat * m2);
      grow[k] = dv * yhat;
      row[k] = dyv;
      dy_out[(row0 + r) * c + k] = dyv;
    }
  }
  __syncthreads();

  // the tile's share of dg, summed over its rows in order
  float* dgp = dg_part + (static_cast<long long>(b) * gridDim.x + blk) * c;
  for (int k = tid; k < c; k += THREADS) {
    float a = 0.f;
    for (int r = 0; r < OUT_TOK; ++r) a += gs[r * c + k];
    dgp[k] = a;
  }

  // do = dy W_out^T, W_out staged [HIDDEN][WO_COLS + 1] (odd stride: each
  // thread walks a row of it)
  float dacc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < c; c0 += WO_COLS) {
    const int wc = min(WO_COLS, c - c0);
    for (int i = tid; i < HIDDEN * WO_COLS; i += THREADS) {
      const int k = i / WO_COLS, j = i - k * WO_COLS;
      wbuf[k * (WO_COLS + 1) + j] = j < wc ? wout[static_cast<long long>(k) * c + c0 + j] : 0.f;
    }
    __syncthreads();
    const float* dyr = ys + pr * c + c0;
    for (int j2 = 0; j2 < wc; ++j2) {
      const float dv = dyr[j2];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dacc[j] = fmaf(dv, wbuf[(pc + 16 * j) * (WO_COLS + 1) + j2], dacc[j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) os[pr * QS + pc + 16 * j] = dacc[j];
  __syncthreads();

  // dq_h[n, d] = sum_e do_h[n, e] ctx_h[d, e]  (the softmax output's gradient)
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = pc + 16 * j, h = col / DH;
    const float* dov = os + pr * QS + h * DH;
    const float* cc = cs + col * CS;
    float a = 0.f;
#pragma unroll 8
    for (int e = 0; e < DH; ++e) a = fmaf(dov[e], cc[e], a);
    ds[pr * QS + col] = a;
  }
  __syncthreads();

  // per-head softmax backward; with qs = scale * p:
  // dq_raw = qs (dq - sum_j p_j dq_j) = qs (dq - sum_j qs_j dq_j / scale)
  for (int p = warp; p < rows * HEADS; p += THREADS / 32) {
    const int r = p / HEADS, h = p % HEADS;
    const float qv = qs[r * QS + h * DH + lane];
    const float dv = ds[r * QS + h * DH + lane];
    const float dot = warp_sum(qv * dv);
    dqkv[(row0 + r) * 3 * HIDDEN + h * DH + lane] = qv * (dv - dot / Q_SCALE);
  }

  // the tile's share of dctx, entry i = (h, d, e)
  float* dcp = dctx_part + (static_cast<long long>(b) * gridDim.x + blk) * HEADS * DH * DH;
  for (int i = tid; i < HEADS * DH * DH; i += THREADS) {
    const int h = i / (DH * DH), d = (i / DH) % DH, e = i % DH;
    float a = 0.f;
    for (int r = 0; r < rows; ++r)
      a = fmaf(qs[r * QS + h * DH + d], os[r * QS + h * DH + e], a);
    dcp[i] = a;
  }
}

// Head pass, grid (HEADS, B): reduces the tiles' dctx shares in order, then
// walks the tokens in tiles of CTX_TOK, recomputes the head's k and v
// columns and k's token softmax from the forward's maximum and sum, and
// writes the k and v thirds of dqkv:
//   dk_s[n, d] = sum_e (v[n, e] / N) dctx[d, e]
//   dk[n, d]   = k_s[n, d] (dk_s[n, d] - S[d]),  S[d] = sum_n k_s[n, d] dk_s[n, d]
//   dv[n, e]   = sum_d k_s[n, d] dctx[d, e] / N
// S needs no pass of its own: S[d] = sum_e ctx[d, e] dctx[d, e], since
// ctx[d, e] = sum_n k_s[n, d] v[n, e] / N.
__global__ void __launch_bounds__(THREADS)
fla_bwd_heads_kernel(const float* __restrict__ x, const float* __restrict__ wqkv,
                     const float* __restrict__ ctx, const float* __restrict__ stats,
                     const float* __restrict__ dctx_part, float* __restrict__ dqkv,
                     int n, int c, int tiles) {
  __shared__ float xs[CTX_TOK][KC + 1];
  __shared__ float ws[KC][2 * DH];
  __shared__ float kv[CTX_TOK][2 * DH + 1];  // k, then k_s; v, then v / N
  __shared__ float dcs[DH][CS];
  __shared__ float col_max[DH], col_sum[DH], s_col[DH];

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const float* xb = x + static_cast<long long>(b) * n * c;
  const int pr = tid >> 3, pc = tid & 7;
  const float inv_n = 1.f / static_cast<float>(n);

  for (int i = tid; i < DH * DH; i += THREADS) {
    const int d = i / DH, e = i - d * DH;
    const float* part = dctx_part + static_cast<long long>(b) * tiles * HEADS * DH * DH
                        + h * DH * DH + i;
    float a = 0.f;
    for (int t = 0; t < tiles; ++t) a += part[static_cast<long long>(t) * HEADS * DH * DH];
    dcs[d][e] = a;
  }
  __syncthreads();
  if (tid < DH) {
    const float* st = stats + (static_cast<long long>(b) * HEADS + h) * 2 * DH;
    col_max[tid] = st[tid];
    col_sum[tid] = st[DH + tid];
    const float* cr = ctx + ((static_cast<long long>(b) * HEADS + h) * DH + tid) * DH;
    float a = 0.f;
    for (int e = 0; e < DH; ++e) a = fmaf(cr[e], dcs[tid][e], a);
    s_col[tid] = a;
  }
  __syncthreads();

  for (int n0 = 0; n0 < n; n0 += CTX_TOK) {
    const int rows = min(CTX_TOK, n - n0);
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int c0 = 0; c0 < c; c0 += KC) {
      const int kc = min(KC, c - c0);
      for (int i = tid; i < CTX_TOK * KC; i += THREADS) {
        const int r = i / KC, k = i - r * KC;
        xs[r][k] = (r < rows && k < kc) ? xb[static_cast<long long>(n0 + r) * c + c0 + k] : 0.f;
      }
      for (int i = tid; i < KC * 2 * DH; i += THREADS) {
        const int k = i / (2 * DH), j = i - k * 2 * DH;
        const int col = (j < DH ? HIDDEN : 2 * HIDDEN - DH) + h * DH + j;
        ws[k][j] = k < kc ? wqkv[static_cast<long long>(c0 + k) * 3 * HIDDEN + col] : 0.f;
      }
      __syncthreads();
      for (int k = 0; k < kc; ++k) {
        const float xv = xs[pr][k];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] = fmaf(xv, ws[k][pc + 8 * j], acc[j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = pc + 8 * j;
      kv[pr][col] = col < DH ? expf(acc[j] - col_max[col]) / col_sum[col] : acc[j] * inv_n;
    }
    __syncthreads();

    float* out = dqkv + (static_cast<long long>(b) * n + n0 + pr) * 3 * HIDDEN + h * DH;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = pc + 8 * j;  // d for dk, e for dv
      float dks = 0.f, dvs = 0.f;
#pragma unroll 8
      for (int u = 0; u < DH; ++u) {
        dks = fmaf(kv[pr][DH + u], dcs[col][u], dks);
        dvs = fmaf(kv[pr][u], dcs[u][col], dvs);
      }
      if (pr < rows) {
        out[HIDDEN + col] = kv[pr][col] * (dks - s_col[col]);
        out[2 * HIDDEN + col] = dvs * inv_n;
      }
    }
    __syncthreads();  // the next tile overwrites kv
  }
}

long long bwd_smem_bytes(int c) {
  return 4LL * (BWD_FIXED_FLOATS + 2LL * OUT_TOK * c);
}

long long output_smem_bytes(int c) {
  return 4LL * (OUT_FIXED_FLOATS + static_cast<long long>(OUT_TOK) * c);
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

}  // namespace

extern "C" {

// Dynamic shared memory of the output pass at C channels, in bytes; the
// wrapper checks it against the card's 227 KB before it launches.
long long fused_linear_attention_smem_bytes(int c) { return output_smem_bytes(c); }

// The same for the backward's row pass.
long long fused_linear_attention_bwd_smem_bytes(int c) { return bwd_smem_bytes(c); }

// Tokens per block of the backward's row pass: the wrapper sizes the
// per-tile partial sums with it.
int fused_linear_attention_bwd_tile() { return OUT_TOK; }

// x [B, N, C], w_qkv [C, 384], w_out [128, C], b_out [C], g [C] -> y [B, N, C];
// ctx [B, 4, 32, 32] and stats [B, 4, 2, 32] (the k softmax's maximum and
// sum per column) are written too: scratch for serving, saved for the
// backward pass in training.
int fused_linear_attention_f32(const float* x, const float* wqkv, const float* wout,
                               const float* bout, const float* g, float* ctx, float* stats,
                               float* y, int batch, int n, int c, void* stream) {
  if (batch <= 0 || n <= 0 || c <= 0) return static_cast<int>(cudaSuccess);
  static long long smem_granted[MAX_DEVICES] = {};
  const long long smem = output_smem_bytes(c);
  cudaError_t err = grant_smem(fla_output_kernel, smem, smem_granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fla_context_kernel<<<dim3(HEADS, batch), THREADS, 0, s>>>(x, wqkv, ctx, stats, n, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fla_output_kernel<<<dim3((n + OUT_TOK - 1) / OUT_TOK, batch), THREADS,
                      static_cast<size_t>(smem), s>>>(x, wqkv, ctx, wout, bout, g, y, n, c);
  return static_cast<int>(cudaGetLastError());
}

// The backward pass up to the plain products: from the forward's inputs, its
// ctx and stats and the cotangent dout [B, N, C], writes o [B, N, 128],
// dy [B, N, C] (the out-projection's output gradient), dqkv [B, N, 384],
// and the per-tile partial sums dg_part [B, tiles, C] and
// dctx_part [B, tiles, 4, 32, 32], tiles = ceil(N / 16). The wrapper forms
// dx, dW_qkv, dW_out, db_out and dg from them.
int fused_linear_attention_bwd_f32(const float* x, const float* wqkv, const float* wout,
                                   const float* bout, const float* g, const float* ctx,
                                   const float* stats, const float* dout, float* o,
                                   float* dy, float* dqkv, float* dg_part, float* dctx_part,
                                   int batch, int n, int c, void* stream) {
  if (batch <= 0 || n <= 0 || c <= 0) return static_cast<int>(cudaSuccess);
  static long long smem_granted[MAX_DEVICES] = {};
  const long long smem = bwd_smem_bytes(c);
  cudaError_t err = grant_smem(fla_bwd_rows_kernel, smem, smem_granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (n + OUT_TOK - 1) / OUT_TOK;
  fla_bwd_rows_kernel<<<dim3(tiles, batch), THREADS, static_cast<size_t>(smem), s>>>(
      x, wqkv, ctx, wout, bout, g, dout, o, dy, dqkv, dg_part, dctx_part, n, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fla_bwd_heads_kernel<<<dim3(HEADS, batch), THREADS, 0, s>>>(x, wqkv, ctx, stats, dctx_part,
                                                              dqkv, n, c, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
