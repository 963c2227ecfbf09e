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
                   float* __restrict__ ctx, int n, int c) {
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

long long output_smem_bytes(int c) {
  return 4LL * (OUT_FIXED_FLOATS + static_cast<long long>(OUT_TOK) * c);
}

}  // namespace

extern "C" {

// Dynamic shared memory of the output pass at C channels, in bytes; the
// wrapper checks it against the card's 227 KB before it launches.
long long fused_linear_attention_smem_bytes(int c) { return output_smem_bytes(c); }

// x [B, N, C], w_qkv [C, 384], w_out [128, C], b_out [C], g [C] -> y [B, N, C];
// ctx is scratch of B * 4 * 32 * 32 floats.
int fused_linear_attention_f32(const float* x, const float* wqkv, const float* wout,
                               const float* bout, const float* g, float* ctx, float* y,
                               int batch, int n, int c, void* stream) {
  if (batch <= 0 || n <= 0 || c <= 0) return static_cast<int>(cudaSuccess);
  // The shared-memory allowance above 48 KB is raised once per device, on
  // first need, so that calls captured into a CUDA graph make no such call.
  static long long smem_granted[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  const long long smem = output_smem_bytes(c);
  if (smem > 48 * 1024 && smem > smem_granted[dev]) {
    err = cudaFuncSetAttribute(fla_output_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_granted[dev] = smem;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fla_context_kernel<<<dim3(HEADS, batch), THREADS, 0, s>>>(x, wqkv, ctx, n, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fla_output_kernel<<<dim3((n + OUT_TOK - 1) / OUT_TOK, batch), THREADS,
                      static_cast<size_t>(smem), s>>>(x, wqkv, ctx, wout, bout, g, y, n, c);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
