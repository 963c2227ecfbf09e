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

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

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

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of 16 or 4 bytes; when `valid` is false nothing is read and the
// destination is filled with zeros.
__device__ __forceinline__ void cp_async16z(float* dst, const float* src, bool valid) {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0) : "memory");
#endif
}
__device__ __forceinline__ void cp_async4z(float* dst, const float* src, bool valid) {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0) : "memory");
#endif
}
__device__ __forceinline__ void cp_async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
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

// fp32 -> (hi, lo) TF32 pair: hi is v with its low 13 mantissa bits
// cleared (a TF32 value), lo = v - hi exactly (|lo| < 2^-10 |v|), of which
// the tensor cores read the top 10 mantissa bits; hi + lo = v to about
// 2^-20 relative. Two full-rate integer and float instructions, not two
// conversions.
__device__ __forceinline__ void split_tf32(float v, unsigned& hi, unsigned& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// d += a b, one m16n8k8 TF32 tensor-core product (fp32 accumulate).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#endif
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

// y[row, :] = LayerNorm(acc[row, :] + b_out) * g for rows < rows_valid, from
// the out-projection's fragments: per-row sums over a thread's columns, the
// four lanes of a row (shuffles), then the 8 warps in order through `red`
// ([8][16 MT] partials, then the means and the rstds): two passes, mean then
// variance, as the plain version; no atomics.
template <int MT, int NT>
__device__ void layer_norm_store(float (&acc)[MT][NT][4], const float* __restrict__ bout,
                                 const float* __restrict__ g, float* __restrict__ y,
                                 int rows_valid, int c, float* red) {
  constexpr int M = 16 * MT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  float* mean = red + FWD_WARPS * M;
  float* rstd = mean + M;
  const float inv_c = 1.f / static_cast<float>(c);
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
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = mt * 16 + gq + 8 * half;
        const float m = pass ? mean[row] : 0.f;
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
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if (tq == 0) red[warp * M + row] = s;
      }
    __syncthreads();
    if (threadIdx.x < M) {
      float s = 0.f;
      for (int w = 0; w < FWD_WARPS; ++w) s += red[w * M + threadIdx.x];
      if (pass)
        rstd[threadIdx.x] = rsqrtf(s * inv_c + LN_EPS);
      else
        mean[threadIdx.x] = s * inv_c;
    }
    __syncthreads();
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = mt * 16 + gq + 8 * half;
      if (row >= rows_valid) continue;
      const float m = mean[row], r = rstd[row];
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

// One step of a 3xTF32 product on fragments already in registers.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const float (&a)[4], const float (&b)[2]) {
  unsigned ah[4], al[4], bh[2], bl[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
  split_tf32(b[0], bh[0], bl[0]);
  split_tf32(b[1], bh[1], bl[1]);
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// Contexts on the tensor cores (3xTF32): ctx[h][d][e] = sum_r k[r][h 32 + d]
// v[r][h 32 + e] over rows [0, rows8), rows8 a multiple of 8, rows past the
// tokens zero in k or v. Warp w takes head w / 2 and d in [16 (w % 2),
// +16), all 32 e; store(h, d, e, c_e, c_e+1) takes each pair of results.
template <typename Store>
__device__ void ctx_mma(const float* k, const float* v, int ld, int rows8, Store store) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int h = warp >> 1, d0 = (warp & 1) * 16;
  const float* ka = k + h * DH + d0 + gq;
  const float* vb = v + h * DH + gq;
  float acc[4][4] = {};
  for (int kk = 0; kk < rows8; kk += 8) {
    const float* k0 = ka + (kk + tq) * ld;
    const float* k1 = k0 + 4 * ld;
    const float a[4] = {k0[0], k0[8], k1[0], k1[8]};  // A[d][r] = k[r][d]
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float b[2] = {vb[(kk + tq) * ld + nt * 8], vb[(kk + tq + 4) * ld + nt * 8]};
      mma_3xtf32(acc[nt], a, b);
    }
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    store(h, d0 + gq, nt * 8 + 2 * tq, acc[nt][0], acc[nt][1]);
    store(h, d0 + gq + 8, nt * 8 + 2 * tq, acc[nt][2], acc[nt][3]);
  }
}

// o[r][h 32 + e] = sum_d q[r][h 32 + d] ctx[h][d][e] for 16 MT rows on the
// tensor cores (3xTF32); cs: the contexts, [4][32][CS_LD]. Warp w takes
// head w / 2 and e in [16 (w % 2), +16).
template <int MT>
__device__ void q_ctx_mma(const float* q, int ldq, const float* cs, float* o, int ldo) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int h = warp >> 1, e0 = (warp & 1) * 16;
  const float* cb = cs + h * DH * CS_LD + e0 + gq;
  float acc[MT][2][4] = {};
#pragma unroll
  for (int kk = 0; kk < DH; kk += 8) {
    float b[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      b[nt][0] = cb[(kk + tq) * CS_LD + nt * 8];
      b[nt][1] = cb[(kk + tq + 4) * CS_LD + nt * 8];
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float* qa = q + (mt * 16 + gq) * ldq + h * DH + kk + tq;
      const float a[4] = {qa[0], qa[8 * ldq], qa[4], qa[8 * ldq + 4]};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) mma_3xtf32(acc[mt][nt], a, b[nt]);
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float* od = o + (mt * 16 + gq) * ldo + h * DH + e0 + nt * 8 + 2 * tq;
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
//   last, red [10][16 MT]: the LayerNorm's partials, means and rstds.
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
  ctx_mma(qkv + HIDDEN, qkv + 2 * HIDDEN, QKV_LD, round_up(n, 8),
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
  ctx_mma(kv, kv + HIDDEN, KV_LD, round_up(rows, 8),
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

bool aligned16(const void* p) { return (reinterpret_cast<unsigned long long>(p) & 15ULL) == 0; }

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

// The same for the backward's row pass.
long long fused_linear_attention_bwd_smem_bytes(int c) { return bwd_smem_bytes(c); }

// Tokens per block of the backward's row pass: the wrapper sizes the
// per-tile partial sums with it.
int fused_linear_attention_bwd_tile() { return OUT_TOK; }

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
