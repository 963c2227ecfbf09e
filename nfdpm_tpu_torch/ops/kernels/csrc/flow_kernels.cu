// Hand-written Hopper (sm_90a) kernels for the Glow step, fp32.
//
// Plain C interface, built by nvcc into a shared library and loaded with
// ctypes (nfdpm_tpu_torch/ops/kernels/_build.py). Every entry point launches
// on the stream it is given, allocates nothing, and returns
// cudaGetLastError() so that the Python wrapper can raise on a refused
// launch. Pointers are to contiguous fp32 device memory; the wrappers check
// device, dtype, contiguity and shapes before they call in.
//
// 1. channel_mix_f32 replaces nfdpm_tpu/ops/pallas/channel_mix.py
//    (channel_mix -> _channel_mix_impl -> pl.pallas_call):
//        forward:  y[n, o] = sum_c x[n, c] * w[o, c] + b[o]
//        dx mode:  y[n, c] = sum_o g[n, o] * w[o, c]      (no bias)
//    The dx mode is the backward pass's dx = g W (_channel_mix_bwd there):
//    the same weight read untransposed, so the backward needs no copy of
//    W^T and no zero bias. dW and db are a matmul and a sum outside any
//    kernel on both sides.
//    Bound: bytes and, at the Glow's sizes, launch latency. One launch moves
//    4*(N*C + N*O + O*C + O) bytes (1.6 MB at the first level) and does
//    2*N*C*O flops (about 19 MFLOP), far below the fp32 rate; no tensor
//    cores (TF32 would break the fp32 parity that the TPU kernel holds with
//    Precision.HIGHEST). So x is read once and y written once, both with
//    16-byte accesses straight between device memory and registers, and
//    nothing but the weight goes through shared memory.
//    Design, for the Glow widths C = O in {12, 24, 48} (compile-time
//    specialisations, no division in any inner loop): a thread holds one
//    pixel row of x in registers and produces OG of its outputs (OG = 12,
//    8, 4 at C = 12, 24, 48, so G = C / OG threads share a row). Warps are
//    laid out so that the lanes of a shared-memory phase take consecutive
//    rows and one output group: every weight read from shared memory is a
//    16-byte broadcast (a warp takes RW = 32 rows of one group at C = 12
//    and 24, RW = 16 rows of two groups at C = 48, which gives level 3's
//    1024 rows 64 blocks instead of 32). A block takes `rows_per_block`
//    rows (a multiple of RW) and stages the [in][out] matrix it multiplies
//    by (W^T for the forward, W for dx; at most 9 KB) and the bias once
//    with 16-byte loads, while its rows' loads are in flight.
//    The wrapper's plan (ops/kernels/channel_mix.py: plan) picks
//    rows_per_block per shape: halved from 256 until the grid fills the
//    132 SMs or a block has RW rows (and a block stays within 512
//    threads). Any other C, O, or operands
//    not 16-byte aligned, take a generic kernel: one thread per output,
//    scalar loads, the weight read through the L1 cache.
//
// 2. coupling_tail_f32 and coupling_tail_step_f32 replace
//    nfdpm_tpu/ops/pallas/coupling_tail.py (coupling_tail -> _forward ->
//    pl.pallas_call):
//        s = sigmoid(ls + 2); y_b = (x_b + bias) * s; ldj[b] = sum log(s + 1e-6)
//    The step mode (coupling_tail_step_f32) is the whole tail of a Glow step
//    in one launch. From the channel mix's output y [B, P, C] and the
//    zeroconv's raw convolution r [B, P, C] (before its bias and scale):
//        h = (r + zb) * exp(3 zlogs);  ls, bias = h[..., :C/2], h[..., C/2:]
//        out = [y[..., :C/2], (y[..., C/2:] + bias) * s]
//        ldj' = ldj + sum log(s + 1e-6)
//    so the step route has no epilogue, half copies, concatenation or
//    logdet add of its own. The plain-operand mode (coupling_tail_f32:
//    three [B, D] operands; no epilogue, no pass-through half, no ldj in)
//    is another instance of the same kernel template.
//    Bound: bytes (y and r read and out written in the step mode, 12 bytes
//    a value; a few transcendental operations each) and, at the Glow's
//    sizes (0.2-0.8 MB a call), launch latency. Design: a thread takes one
//    unit, VW values of the transformed half of one pixel with the VW
//    log-scale values that pair with them (and, in the step mode, the VW
//    pass-through values). VW = 4 (16-byte accesses) where C/2 and the
//    pointers allow it, else 2 or 1 (level 1's C/2 = 6 takes 8-byte
//    accesses). The unit's loads go out before the block stages zb and
//    exp(3 zlogs) in shared memory, once a block. An image's units go to one
//    thread-block cluster of at most 8 blocks (grid: blocks per image x B);
//    the wrapper's plan (ops/kernels/coupling_tail.py: forward_plan) halves
//    the threads from 128 to 32 until the grid has a block per SM (384, 192
//    and 192 blocks at the three level shapes of batch 64; larger images
//    take larger blocks, then a loop). The logdet is deterministic and
//    needs no pass through device memory: each block sums its log terms in
//    a fixed order (each thread's VW terms, a warp shuffle, the warps in
//    order), writes it into block 0's shared memory (distributed shared
//    memory), and after one cluster barrier block 0 adds the cluster's sums
//    in rank order, then ldj. The outputs are stored after the barrier, so
//    it waits on no store. No atomics touch a value, so ldj repeats bit for bit. The
//    TPU kernel's pad to 128 lanes and its analytic correction of the
//    logdet are not carried over.
//
// 3. coupling_tail_inverse_f32 and coupling_tail_inverse_step_f32 replace
//    the second pl.pallas_call in nfdpm_tpu/ops/pallas/coupling_tail.py
//    (coupling_tail_inverse):
//        x_b = y_b / (sigmoid(ls + 2) + 1e-6) - bias
//    The step mode (coupling_tail_inverse_step_f32) is the whole tail of an
//    inverse Glow step in one launch, the mirror of 2's step mode. From the
//    step's y [B, P, C] and the zeroconv's raw convolution r [B, P, C]:
//        h = (r + zb) * exp(3 zlogs);  ls, bias = h[..., :C/2], h[..., C/2:]
//        x = [y[..., :C/2], y[..., C/2:] / (sigmoid(ls + 2) + 1e-6) - bias]
//    written whole and contiguous, ready for the inverse channel mix: the
//    inverse route has no epilogue, half copies or concatenation of its
//    own. The plain-operand mode (three [N] operands, no epilogue, no
//    pass-through half) is another instance of the same kernel template.
//    Bound: bytes (y and r read, x written in the step mode: 12 bytes a
//    value) and, at the Glow's sizes, launch latency. No reduction, so no
//    cluster and no ticket. Design: 2's units (VW values of a pixel's
//    transformed half with their log-scale partners and, in the step mode,
//    the VW pass-through values; 16-, 8- or 4-byte accesses by VW), the
//    first unit's loads out before the block stages zb and exp(3 zlogs);
//    a 1-D grid of one unit a thread, whose plan (ops/kernels/
//    coupling_tail.py: inverse_plan) halves the threads from 128 to 32
//    until it has a block per SM (384, 192 and 192 blocks at the three
//    level shapes of batch 64); past SM_COUNT x 16 blocks the threads loop.
//
// 4. coupling_tail_bwd_f32 and coupling_tail_step_bwd_f32 are the
//    vector-Jacobian products of the two modes of 2 (the JAX package's
//    coupling_tail.py:_bwd, which it leaves to XLA to fuse into one pass,
//    and in the step mode the zeroconv epilogue's, which it leaves to
//    autodiff):
//        s = sigmoid(ls + 2); ds = s (1 - s); e = exp(3 zlogs)
//        d_ls = g_b (x_b + bias) ds + g_ldj[b] ds / (s + 1e-6); d_bias = g_b s
//        plain mode: d_ls, and d_xb = d_bias (one tensor, written once)
//        step mode:  d_y = [g_a, g_b s]; d_r = [d_ls, d_bias] e
//                    d_zb[c] = sum over pixels of d_r[c]
//                    d_zlogs[c] = 3 sum over pixels of [d_ls, d_bias][c] h[c]
//    g or g_ldj may be null (that output was not used) and then counts as
//    zeros; g_ldj is read at a stride, so an expanded scalar is not copied.
//    Bound: bytes (y's transformed half, r and g read, d_y and d_r written
//    in the step mode: 18 bytes a value; y's first half is never read, as
//    d_y's first half is g's). Design: the forward's units. A block of 256 or 512
//    threads holds lanes = threads / (C/2 / VW) pixel lanes, and each lane
//    walks px_per_lane pixels at a stride of `lanes`, so a thread always
//    meets the same channels and keeps their d_zb and d_zlogs sums in
//    registers. The per-channel sums are deterministic: the block adds its
//    lanes' sums in a fixed order into a row of 2C values in device memory,
//    and the last block to finish, picked by a ticket counter, adds the rows
//    in a fixed order. A thread stores its last unit's outputs only after
//    its block has taken the ticket, so that the ticket's release waits on
//    the row alone. The wrapper's plan (backward_plan) gives at most one block
//    per SM (97, 49 and 25 blocks at the three level shapes of batch 64,
//    one pixel a lane): every unit is in flight in one wave, and few rows
//    keep the last block's pass short. The plain mode has no sums and
//    stores as it goes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <initializer_list>

namespace cg = cooperative_groups;

namespace {

constexpr int CM_GENERIC_THREADS = 256;
constexpr int CM_MAX_THREADS = 512;  // the plan's largest block
constexpr long long SM_COUNT = 132;  // H100 SXM
constexpr int TAIL_MAX_THREADS = 512;  // the tail plans' largest block
constexpr int TAIL_MAX_CLUSTER = 8;    // the forward's blocks an image: a portable cluster
constexpr float COUPLING_EPS = 1e-6f;

__device__ __forceinline__ float sigmoid_shift2(float v) {
  return 1.0f / (1.0f + expf(-(v + 2.0f)));
}

// Square channel mix at compile-time width C, OG outputs per thread; see
// the note at the top. A warp takes RW consecutive rows and 32 / RW output
// groups, RW lanes per group (RW >= 8: the 8 lanes of a shared-memory
// phase share a group, so weight reads stay broadcasts); WPC warps cover
// one chunk of RW rows and all G groups. The weight is staged as the
// [in][out] matrix both modes multiply by (W^T for the forward, W for dx),
// so that a thread's OG outputs of input channel k are consecutive.
template <int C, int OG, int RW, bool DX>
__global__ void __launch_bounds__(CM_MAX_THREADS)
channel_mix_square_kernel(const float* __restrict__ x, const float* __restrict__ w,
                          const float* __restrict__ b, float* __restrict__ y,
                          long long n, int rows_per_block) {
  constexpr int G = C / OG;
  constexpr int GPW = 32 / RW;
  constexpr int WPC = G / GPW;
  static_assert(G % GPW == 0, "a warp's groups must divide the row's");
  constexpr int C4 = C / 4;
  __shared__ float4 ws[C * C4];  // [in][out] in float4s of outputs
  __shared__ float bs[C];

  // the row's loads go out first, so that they are in flight while the
  // block stages the weight
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = (wid % WPC) * GPW + lane / RW;
  const long long row = static_cast<long long>(blockIdx.x) * rows_per_block +
                        RW * (wid / WPC) + lane % RW;
  float xr[C];
  if (row < n) {
    const float4* xg = reinterpret_cast<const float4*>(x + row * C);
#pragma unroll
    for (int k = 0; k < C4; ++k) {
      const float4 v = __ldg(xg + k);
      xr[4 * k] = v.x;
      xr[4 * k + 1] = v.y;
      xr[4 * k + 2] = v.z;
      xr[4 * k + 3] = v.w;
    }
  }
  const float4* w4 = reinterpret_cast<const float4*>(w);
  if (DX) {
    for (int i = threadIdx.x; i < C * C4; i += blockDim.x) ws[i] = __ldg(w4 + i);
  } else {
    // W^T in 4x4 blocks: rows o..o+3, columns k..k+3 of W (four 16-byte
    // loads) become rows k..k+3, columns o..o+3 of W^T (four 16-byte stores)
    for (int i = threadIdx.x; i < C4 * C4; i += blockDim.x) {
      const int kb = i / C4, ob = i - kb * C4;
      const float4 r0 = __ldg(w4 + (4 * ob) * C4 + kb), r1 = __ldg(w4 + (4 * ob + 1) * C4 + kb),
                   r2 = __ldg(w4 + (4 * ob + 2) * C4 + kb), r3 = __ldg(w4 + (4 * ob + 3) * C4 + kb);
      ws[(4 * kb) * C4 + ob] = make_float4(r0.x, r1.x, r2.x, r3.x);
      ws[(4 * kb + 1) * C4 + ob] = make_float4(r0.y, r1.y, r2.y, r3.y);
      ws[(4 * kb + 2) * C4 + ob] = make_float4(r0.z, r1.z, r2.z, r3.z);
      ws[(4 * kb + 3) * C4 + ob] = make_float4(r0.w, r1.w, r2.w, r3.w);
    }
    for (int i = threadIdx.x; i < C; i += blockDim.x) bs[i] = __ldg(b + i);
  }
  __syncthreads();
  if (row >= n) return;

  // acc[j] = sum_k x[k] m[k, grp * OG + j], m the staged [in][out] matrix
  float acc[OG];
#pragma unroll
  for (int j = 0; j < OG; ++j) acc[j] = 0.0f;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const float4* wr = ws + k * C4 + grp * (OG / 4);
#pragma unroll
    for (int j4 = 0; j4 < OG / 4; ++j4) {
      const float4 v = wr[j4];
      acc[4 * j4] = fmaf(xr[k], v.x, acc[4 * j4]);
      acc[4 * j4 + 1] = fmaf(xr[k], v.y, acc[4 * j4 + 1]);
      acc[4 * j4 + 2] = fmaf(xr[k], v.z, acc[4 * j4 + 2]);
      acc[4 * j4 + 3] = fmaf(xr[k], v.w, acc[4 * j4 + 3]);
    }
  }
  if (!DX) {
#pragma unroll
    for (int j = 0; j < OG; ++j) acc[j] += bs[grp * OG + j];
  }
  float4* yg = reinterpret_cast<float4*>(y + row * C + grp * OG);
#pragma unroll
  for (int j4 = 0; j4 < OG / 4; ++j4)
    yg[j4] = make_float4(acc[4 * j4], acc[4 * j4 + 1], acc[4 * j4 + 2], acc[4 * j4 + 3]);
}

// Any C, O and alignment: one thread per output of the block's rows. In
// the forward mode the input has cin = C channels and the output cout = O,
// y[r, j] = sum_k x[r, k] w[j, k] + b[j]; in the dx mode cin = O, cout = C,
// y[r, j] = sum_k g[r, k] w[k, j].
__global__ void __launch_bounds__(CM_GENERIC_THREADS)
channel_mix_generic_kernel(const float* __restrict__ x, const float* __restrict__ w,
                           const float* __restrict__ b, float* __restrict__ y,
                           long long n, int cin, int cout, int dx, int rows_per_block) {
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long left = n - row0;
  const int rows = left < rows_per_block ? static_cast<int>(left) : rows_per_block;
  for (int i = threadIdx.x; i < rows * cout; i += blockDim.x) {
    const int r = i / cout, j = i - r * cout;
    const float* xr = x + (row0 + r) * cin;
    float acc = 0.0f;
    if (dx) {
      for (int k = 0; k < cin; ++k) acc = fmaf(__ldg(xr + k), __ldg(w + k * cout + j), acc);
    } else {
      const float* wr = w + static_cast<long long>(j) * cin;
      for (int k = 0; k < cin; ++k) acc = fmaf(__ldg(xr + k), __ldg(wr + k), acc);
      acc += __ldg(b + j);
    }
    y[(row0 + r) * cout + j] = acc;
  }
}

template <int C, int OG, int RW>
cudaError_t launch_square(const float* x, const float* w, const float* b, float* y,
                          long long n, int dx, int rows, cudaStream_t stream) {
  constexpr int G = C / OG;
  const int threads = rows * G;
  if (rows % RW != 0 || threads > CM_MAX_THREADS) return cudaErrorInvalidValue;
  const long long blocks = (n + rows - 1) / rows;
  if (dx)
    channel_mix_square_kernel<C, OG, RW, true><<<static_cast<unsigned>(blocks), threads, 0,
                                                 stream>>>(x, w, b, y, n, rows);
  else
    channel_mix_square_kernel<C, OG, RW, false><<<static_cast<unsigned>(blocks), threads, 0,
                                                  stream>>>(x, w, b, y, n, rows);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<unsigned long long>(p) & 15ULL) == 0; }

// The operands of the two tail kernels (note items 2 and 4). Each tensor is
// [B, P, stride] with P pixels an image; the tail transforms `half` values of
// a pixel. The plain mode sees a [B, D] operand as D / VW pixels of VW values
// (stride = half = VW); the step mode sees [B, H, W, C] as H W pixels of C
// values (stride = C, half = C / 2), and its half pointers (t, x, g, out)
// point C / 2 values into the pixel.
struct TailArgs {
  const float* ls;      // log-scale half (step: the raw zeroconv output r)
  const float* t;       // bias half (step: r + C/2)
  const float* x;       // transformed half of the input (step: y + C/2)
  const float* y;       // step forward and inverse: y, whose first half passes through
  const float* zb;      // step: the zeroconv's bias [C]
  const float* zlogs;   // step: the zeroconv's log-scale [C]
  const float* ldj_in;  // step forward: the running logdet [B], or null
  const float* g;       // backward: cotangent at x's places, or null (zeros)
  const float* g_a;     // step backward: cotangent of out, or null (zeros)
  const float* g_ldj;   // backward: [B] at stride g_ldj_stride, or null
  float* out;           // forward, inverse: transformed half; backward: d_x (step: d_y + C/2)
  float* out_a;         // step: out's (forward), x's (inverse) or d_y's (backward) first half
  float* d_ls;          // backward: d_ls (step: d_r, both halves)
  float* ldj;           // forward: [B]
  float* d_zb;          // step backward: [C]
  float* d_zlogs;       // step backward: [C]
  float* partial;       // step backward: the blocks' rows of per-channel sums
  unsigned int* ticket; // step backward: zero between launches; the last block resets it
  long long px;         // pixels an image
  long long g_ldj_stride;
  int stride;           // values from one pixel to the next
  int half;             // values a pixel's tail transforms
  int rows;             // B
  int px_per_lane;      // backward: pixels each lane walks
};

template <int VW>
__device__ __forceinline__ void load_vec(const float* __restrict__ p, float (&v)[VW]) {
  if constexpr (VW == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (VW == 2) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int VW>
__device__ __forceinline__ void load_or_zero(const float* p, long long o, float (&v)[VW]) {
  if (p != nullptr) {
    load_vec<VW>(p + o, v);
  } else {
#pragma unroll
    for (int k = 0; k < VW; ++k) v[k] = 0.0f;
  }
}

template <int VW>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[VW]) {
  if constexpr (VW == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (VW == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// zb at epi[0, C) and exp(3 zlogs) at epi[C, 2C), once a block
__device__ __forceinline__ void stage_epilogue(const TailArgs& a, float* epi) {
  const int c = 2 * a.half;
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    epi[i] = __ldg(a.zb + i);
    epi[c + i] = expf(__ldg(a.zlogs + i) * 3.0f);
  }
}

// The zeroconv's epilogue on a unit at channel c0 of each half:
// ls, t := (r + zb) * exp(3 zlogs)
template <int VW>
__device__ __forceinline__ void apply_epilogue(const float* epi, int half, int c0,
                                               float (&ls)[VW], float (&t)[VW]) {
  const int c = 2 * half;
#pragma unroll
  for (int k = 0; k < VW; ++k) {
    ls[k] = (ls[k] + epi[c0 + k]) * epi[c + c0 + k];
    t[k] = (t[k] + epi[half + c0 + k]) * epi[c + half + c0 + k];
  }
}

// finish(j, sum over k < rows of at(k, j)) for each j < width, every sum in
// one fixed order: where width < blockDim.x, the block splits a slot's k
// into m_n interleaved runs (k = m, m + m_n, ...) whose sums then add up in
// the order m = 0, 1, ... (through `scratch`, blockDim.x floats). No
// atomics, so the sums repeat bit for bit. Every thread of the block calls
// it. The unrolled run sends its loads out together.
template <typename At, typename Finish>
__device__ void fixed_order_sum(int rows, int width, float* scratch, At at, Finish finish) {
  const int threads = blockDim.x;
  const int m_n = width < threads ? threads / width : 1;
  if (m_n == 1) {
    for (int j = threadIdx.x; j < width; j += threads) {
      float s = 0.0f;
#pragma unroll 16
      for (int k = 0; k < rows; ++k) s += at(k, j);
      finish(j, s);
    }
    return;
  }
  const int j = threadIdx.x % width, m = threadIdx.x / width;
  if (m < m_n) {
    float s = 0.0f;
#pragma unroll 16
    for (int k = m; k < rows; k += m_n) s += at(k, j);
    scratch[m * width + j] = s;
  }
  __syncthreads();
  if (threadIdx.x < width) {
    float s = 0.0f;
    for (int mm = 0; mm < m_n; ++mm) s += scratch[mm * width + threadIdx.x];
    finish(threadIdx.x, s);
  }
}

// True in the block that finishes last. The barrier orders the block's
// row writes before thread 0's ticket, an acquire-release add at device
// scope that publishes them and, in the last block, sees every other
// block's. The ticket only picks the block; that block resets it for the
// next launch (every other block has taken its ticket by then).
__device__ __forceinline__ bool last_block(unsigned int* ticket, unsigned int blocks,
                                           bool* flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int taken;
    asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;"
                 : "=r"(taken) : "l"(ticket) : "memory");
    const bool last = taken == blocks - 1;
    if (last) *ticket = 0u;
    *flag = last;
  }
  __syncthreads();
  return *flag;
}

// Forward, note item 2: grid (blocks per image, B) in clusters of one
// image's blocks (at most 8), a thread per unit (a loop where an image has
// more than 8 blocks of units). Each block writes the sum of its log terms
// into block 0's shared memory (distributed shared memory, slot = rank);
// after the cluster's barrier block 0 adds the slots in rank order. No
// output is stored before the barrier, so it waits on no store, and no
// block reads another's shared memory after it.
template <bool STEP, int VW>
__global__ void __launch_bounds__(TAIL_MAX_THREADS)
coupling_tail_fwd_kernel(const TailArgs a) {
  extern __shared__ float epi[];  // step: zb, exp(3 zlogs) [2C]
  __shared__ float warp_sums[TAIL_MAX_THREADS / 32];
  __shared__ float block_sums[TAIL_MAX_CLUSTER];  // block 0's: one slot a block
  cg::cluster_group cluster = cg::this_cluster();
  const int q_n = a.half / VW;
  const long long units = a.px * q_n;
  const long long stride_u = static_cast<long long>(gridDim.x) * blockDim.x;
  long long u = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long base = blockIdx.y * a.px;
  // the first unit's loads go out before the block stages the epilogue
  float ls[VW], t[VW], x[VW], ya[VW];
  long long o = 0;
  int c0 = 0;
  bool active = u < units;
  if (active) {
    c0 = static_cast<int>(u % q_n) * VW;
    o = (base + u / q_n) * a.stride + c0;
    load_vec<VW>(a.ls + o, ls);
    load_vec<VW>(a.t + o, t);
    load_vec<VW>(a.x + o, x);
    if (STEP) load_vec<VW>(a.y + o, ya);
  }
  if (STEP) {
    stage_epilogue(a, epi);
    __syncthreads();
  }
  float acc = 0.0f;
  while (active) {
    if (STEP) apply_epilogue<VW>(epi, a.half, c0, ls, t);
#pragma unroll
    for (int k = 0; k < VW; ++k) {
      const float s = sigmoid_shift2(ls[k]);
      x[k] = (x[k] + t[k]) * s;
      acc += logf(s + COUPLING_EPS);
    }
    u += stride_u;
    if (u >= units) break;  // the last unit's stores wait until the logdet is out
    if (STEP) store_vec<VW>(a.out_a + o, ya);
    store_vec<VW>(a.out + o, x);
    c0 = static_cast<int>(u % q_n) * VW;
    o = (base + u / q_n) * a.stride + c0;
    load_vec<VW>(a.ls + o, ls);
    load_vec<VW>(a.t + o, t);
    load_vec<VW>(a.x + o, x);
    if (STEP) load_vec<VW>(a.y + o, ya);
  }
  // the block's log terms: warp shuffles, then the warps in order
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) s += warp_sums[w];
    cluster.map_shared_rank(block_sums, 0)[cluster.block_rank()] = s;
  }
  cluster.sync();
  if (cluster.block_rank() == 0 && threadIdx.x == 0) {
    float s = 0.0f;
    for (unsigned r = 0; r < cluster.num_blocks(); ++r) s += block_sums[r];
    const int row = static_cast<int>(blockIdx.y);
    a.ldj[row] = a.ldj_in != nullptr ? __ldg(a.ldj_in + row) + s : s;
  }
  if (active) {
    if (STEP) store_vec<VW>(a.out_a + o, ya);
    store_vec<VW>(a.out + o, x);
  }
}

// One unit's operands for the backward
template <int VW>
struct TailUnit {
  float ls[VW], t[VW], x[VW], g[VW], ga[VW];
  float gl;
};

template <bool STEP, int VW>
__device__ __forceinline__ void load_unit(const TailArgs& a, long long o, long long row,
                                          TailUnit<VW>& u) {
  load_vec<VW>(a.ls + o, u.ls);
  load_vec<VW>(a.t + o, u.t);
  load_vec<VW>(a.x + o, u.x);
  load_or_zero<VW>(a.g, o, u.g);
  if (STEP) load_or_zero<VW>(a.g_a, o, u.ga);
  u.gl = a.g_ldj != nullptr ? __ldg(a.g_ldj + row * a.g_ldj_stride) : 0.0f;
}

// The unit's VJP, in place: u.x := d_x (d_xb, or d_y's second half), u.ls :=
// d_ls (step: d_r's first half), u.t := step: d_r's second half; u.ga is
// d_y's first half as loaded. acc: d_zb of the unit's first-half channels,
// of its second-half ones, then d_zlogs / 3 of the same (4 VW sums).
template <bool STEP, int VW>
__device__ __forceinline__ void unit_vjp(const TailArgs& a, const float* epi, int c0,
                                         TailUnit<VW>& u, float (&acc)[4 * VW]) {
  if (STEP) apply_epilogue<VW>(epi, a.half, c0, u.ls, u.t);  // ls, t: the zeroconv's h
  const float* e = epi + 2 * a.half;
#pragma unroll
  for (int k = 0; k < VW; ++k) {
    const float s = sigmoid_shift2(u.ls[k]);
    const float ds = s * (1.0f - s);
    float d_ls = u.g[k] * (u.x[k] + u.t[k]) * ds + u.gl * ds / (s + COUPLING_EPS);
    float d_t = u.g[k] * s;
    u.x[k] = d_t;
    if (STEP) {
      acc[2 * VW + k] += d_ls * u.ls[k];
      acc[3 * VW + k] += d_t * u.t[k];
      d_ls *= e[c0 + k];
      d_t *= e[a.half + c0 + k];
      acc[k] += d_ls;
      acc[VW + k] += d_t;
      u.t[k] = d_t;
    }
    u.ls[k] = d_ls;
  }
}

template <bool STEP, int VW>
__device__ __forceinline__ void store_unit(const TailArgs& a, long long o, const TailUnit<VW>& u) {
  store_vec<VW>(a.out + o, u.x);
  store_vec<VW>(a.d_ls + o, u.ls);
  if (STEP) {
    store_vec<VW>(a.out_a + o, u.ga);          // d_y's first half: g's, passed through
    store_vec<VW>(a.d_ls + o + a.half, u.t);   // d_r's second half
  }
}

// Backward, note item 4: a 1-D grid; block b takes pixels
// [b lanes px_per_lane, (b + 1) lanes px_per_lane) of the whole batch.
// Step partials: [blocks][2C], d_zb's C sums then d_zlogs'. In the step
// mode a thread's last unit is stored after the block has taken its
// ticket, so that the ticket's fence waits on no output store.
template <bool STEP, int VW>
__global__ void __launch_bounds__(TAIL_MAX_THREADS)
coupling_tail_bwd_kernel(const TailArgs a) {
  // step: zb, exp(3 zlogs) [2C], the lanes' sums [lanes][2C], the combine's scratch
  extern __shared__ float tail_smem[];
  __shared__ bool last;
  const int q_n = a.half / VW;
  const int lanes = blockDim.x / q_n;
  const int lane = threadIdx.x / q_n, c0 = (threadIdx.x % q_n) * VW;
  const long long n_px = a.rows * a.px;
  const long long step = lanes;
  const long long p_end = min(n_px, (blockIdx.x + 1LL) * step * a.px_per_lane);
  long long p = blockIdx.x * step * a.px_per_lane + lane;
  const bool any = lane < lanes && p < p_end;
  bool more = any;
  // the first unit's loads go out before the block stages the epilogue
  TailUnit<VW> cur;
  if (more) load_unit<STEP, VW>(a, p * a.stride + c0, p / a.px, cur);
  float* epi = tail_smem;
  if (STEP) {
    stage_epilogue(a, epi);
    __syncthreads();
  }
  float acc[4 * VW];
#pragma unroll
  for (int j = 0; j < 4 * VW; ++j) acc[j] = 0.0f;
  while (more) {
    const long long next = p + step;
    more = next < p_end;
    TailUnit<VW> nxt;
    if (more) load_unit<STEP, VW>(a, next * a.stride + c0, next / a.px, nxt);
    unit_vjp<STEP, VW>(a, epi, c0, cur, acc);
    if (!more) break;  // cur is the last unit: p stays on it
    store_unit<STEP, VW>(a, p * a.stride + c0, cur);
    cur = nxt;
    p = next;
  }
  if (!STEP) {
    if (any) store_unit<STEP, VW>(a, p * a.stride + c0, cur);
    return;
  }

  // the lanes' sums, [lane][2C] in channel order, then the block's row
  const int c = 2 * a.half, width = 2 * c;
  float* sums = epi + width;  // after zb and exp(3 zlogs)
  float* scratch = sums + lanes * width;
  if (lane < lanes) {
#pragma unroll
    for (int k = 0; k < VW; ++k) {
      float* row = sums + lane * width + c0 + k;
      row[0] = acc[k];                       // d_zb, first half
      row[a.half] = acc[VW + k];             // d_zb, second half
      row[c] = acc[2 * VW + k];              // d_zlogs / 3, first half
      row[c + a.half] = acc[3 * VW + k];     // d_zlogs / 3, second half
    }
  }
  __syncthreads();
  float* part = a.partial + static_cast<long long>(blockIdx.x) * width;
  fixed_order_sum(
      lanes, width, scratch, [&](int k, int j) { return sums[k * width + j]; },
      [&](int j, float s) { part[j] = s; });
  const bool is_last = last_block(a.ticket, gridDim.x, &last);
  if (any) store_unit<STEP, VW>(a, p * a.stride + c0, cur);
  if (!is_last) return;
  const float* all = a.partial;
  fixed_order_sum(
      static_cast<int>(gridDim.x), width, scratch,
      [&](int k, int j) { return __ldcg(all + static_cast<long long>(k) * width + j); },
      [&](int j, float s) {
        if (j < c) a.d_zb[j] = s;
        else a.d_zlogs[j - c] = 3.0f * s;
      });
}

// Inverse, note item 3: a 1-D grid over the units of all pixels, one a
// thread (a loop past the grid). Step: zb, exp(3 zlogs) in shared memory.
template <bool STEP, int VW>
__global__ void __launch_bounds__(TAIL_MAX_THREADS)
coupling_tail_inverse_kernel(const TailArgs a) {
  extern __shared__ float epi[];  // step: zb, exp(3 zlogs) [2C]
  const int q_n = a.half / VW;
  const long long units = a.rows * a.px * q_n;
  const long long stride_u = static_cast<long long>(gridDim.x) * blockDim.x;
  long long u = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  // the first unit's loads go out before the block stages the epilogue
  float ls[VW], t[VW], yb[VW], ya[VW];
  long long o = 0;
  int c0 = 0;
  bool active = u < units;
  if (active) {
    c0 = static_cast<int>(u % q_n) * VW;
    o = (u / q_n) * a.stride + c0;
    load_vec<VW>(a.ls + o, ls);
    load_vec<VW>(a.t + o, t);
    load_vec<VW>(a.x + o, yb);
    if (STEP) load_vec<VW>(a.y + o, ya);
  }
  if (STEP) {
    stage_epilogue(a, epi);
    __syncthreads();
  }
  while (active) {
    if (STEP) apply_epilogue<VW>(epi, a.half, c0, ls, t);
#pragma unroll
    for (int k = 0; k < VW; ++k) yb[k] = yb[k] / (sigmoid_shift2(ls[k]) + COUPLING_EPS) - t[k];
    if (STEP) store_vec<VW>(a.out_a + o, ya);
    store_vec<VW>(a.out + o, yb);
    u += stride_u;
    if (u >= units) break;
    c0 = static_cast<int>(u % q_n) * VW;
    o = (u / q_n) * a.stride + c0;
    load_vec<VW>(a.ls + o, ls);
    load_vec<VW>(a.t + o, t);
    load_vec<VW>(a.x + o, yb);
    if (STEP) load_vec<VW>(a.y + o, ya);
  }
}

// Shared memory (floats) of the two tail kernels: the epilogue's 2C in the
// step mode; the backward's lanes' sums and the combine's scratch.
long long tail_smem_floats(bool step, bool backward, int half, int vw, int threads) {
  const long long c = 2LL * half;
  if (!step) return 0;
  if (!backward) return 2 * c;
  return 2 * c + static_cast<long long>(threads / (half / vw)) * 2 * c + threads;
}

// The checks both modes share: a plan the kernels take, and pointers that
// the vector width allows (null ones are not read); false refuses the launch.
bool tail_plan_ok(int half, int stride, int vw, int threads,
                  std::initializer_list<const void*> ptrs) {
  if (vw != 1 && vw != 2 && vw != 4) return false;
  if (threads < 32 || threads > TAIL_MAX_THREADS || threads % 32 != 0) return false;
  if (half <= 0 || half % vw != 0 || stride % vw != 0) return false;
  for (const void* p : ptrs)
    if (p != nullptr && (reinterpret_cast<unsigned long long>(p) % (4ULL * vw)) != 0) return false;
  return true;
}

// The forward in clusters of `blocks` blocks (one image's, at most 8)
template <bool STEP>
cudaError_t launch_tail_fwd(const TailArgs& a, int vw, int threads, int blocks,
                            cudaStream_t stream) {
  if (blocks <= 0 || blocks > TAIL_MAX_CLUSTER || a.rows > 65535)
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(a.rows));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = sizeof(float) * tail_smem_floats(STEP, false, a.half, vw, threads);
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = static_cast<unsigned>(blocks);
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  cudaError_t err;
  switch (vw) {
    case 4: err = cudaLaunchKernelEx(&cfg, coupling_tail_fwd_kernel<STEP, 4>, a); break;
    case 2: err = cudaLaunchKernelEx(&cfg, coupling_tail_fwd_kernel<STEP, 2>, a); break;
    default: err = cudaLaunchKernelEx(&cfg, coupling_tail_fwd_kernel<STEP, 1>, a); break;
  }
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <bool STEP>
cudaError_t launch_tail_bwd(const TailArgs& a, int vw, int threads, int blocks,
                            cudaStream_t stream) {
  const int lanes = threads / (a.half / vw);
  if (blocks <= 0 || lanes < 1 || a.px_per_lane < 1 ||
      static_cast<long long>(blocks) * lanes * a.px_per_lane < a.rows * a.px)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * tail_smem_floats(STEP, true, a.half, vw, threads);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>(blocks);
  switch (vw) {
    case 4: coupling_tail_bwd_kernel<STEP, 4><<<grid, threads, smem, stream>>>(a); break;
    case 2: coupling_tail_bwd_kernel<STEP, 2><<<grid, threads, smem, stream>>>(a); break;
    default: coupling_tail_bwd_kernel<STEP, 1><<<grid, threads, smem, stream>>>(a); break;
  }
  return cudaGetLastError();
}

// The inverse: a 1-D grid of `blocks` blocks
template <bool STEP>
cudaError_t launch_tail_inverse(const TailArgs& a, int vw, int threads, int blocks,
                                cudaStream_t stream) {
  if (blocks <= 0 || blocks > SM_COUNT * 16) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * tail_smem_floats(STEP, false, a.half, vw, threads);
  const unsigned grid = static_cast<unsigned>(blocks);
  switch (vw) {
    case 4: coupling_tail_inverse_kernel<STEP, 4><<<grid, threads, smem, stream>>>(a); break;
    case 2: coupling_tail_inverse_kernel<STEP, 2><<<grid, threads, smem, stream>>>(a); break;
    default: coupling_tail_inverse_kernel<STEP, 1><<<grid, threads, smem, stream>>>(a); break;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [N, cin], w [O, C], b [O] (unused in the dx mode, may be null) ->
// y [N, cout]; forward: cin = C, cout = O; dx mode: cin = O, cout = C.
// `variant` and `rows_per_block` are the wrapper's plan
// (ops/kernels/channel_mix.py:plan): variant 0 is the generic kernel, 12,
// 24 or 48 the square kernel of that width, which needs C = O = variant
// and 16-byte aligned x, w and y; a plan that does not hold is refused
// with cudaErrorInvalidValue before anything is launched.
int channel_mix_f32(const float* x, const float* w, const float* b, float* y,
                    long long n, int c, int o, int dx, int variant, int rows_per_block,
                    void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (rows_per_block <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant != 0) {
    if (c != variant || o != variant || !aligned16(x) || !aligned16(w) || !aligned16(y) ||
        (!dx && b == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    switch (variant) {
      case 12:
        return static_cast<int>(launch_square<12, 12, 32>(x, w, b, y, n, dx, rows_per_block, s));
      case 24:
        return static_cast<int>(launch_square<24, 8, 32>(x, w, b, y, n, dx, rows_per_block, s));
      case 48:
        return static_cast<int>(launch_square<48, 4, 16>(x, w, b, y, n, dx, rows_per_block, s));
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const long long blocks = (n + rows_per_block - 1) / rows_per_block;
  channel_mix_generic_kernel<<<static_cast<unsigned>(blocks), CM_GENERIC_THREADS, 0, s>>>(
      x, w, b, y, n, dx ? o : c, dx ? c : o, dx, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

// The plain-operand tail: ls, bias, x_b [rows, d] -> y_b [rows, d] and
// ldj [rows]. `vw`, `threads` and `blocks` (an image's, a cluster) are the
// wrapper's plan (ops/kernels/coupling_tail.py: forward_plan).
int coupling_tail_f32(const float* ls, const float* bias, const float* xb, float* yb,
                      float* ldj, int rows, long long d, int vw, int threads, int blocks,
                      void* stream) {
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  if (d % vw != 0 || !tail_plan_ok(vw, vw, vw, threads, {ls, bias, xb, yb}))
    return static_cast<int>(cudaErrorInvalidValue);
  TailArgs a{};
  a.ls = ls; a.t = bias; a.x = xb; a.out = yb; a.ldj = ldj;
  a.px = d / vw; a.stride = vw; a.half = vw; a.rows = rows;
  return static_cast<int>(
      launch_tail_fwd<false>(a, vw, threads, blocks, static_cast<cudaStream_t>(stream)));
}

// The Glow step's tail: y, r [rows, hw, c] (the channel mix's output and the
// zeroconv's raw convolution), zb, zlogs [c], ldj_in [rows] (may be null:
// zeros) -> out [rows, hw, c] and ldj [rows]. c even, at most 512. Plan as
// for coupling_tail_f32.
int coupling_tail_step_f32(const float* y, const float* r, const float* zb,
                           const float* zlogs, const float* ldj_in, float* out, float* ldj,
                           int rows, long long hw, int c, int vw, int threads, int blocks,
                           void* stream) {
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  const int half = c / 2;
  if (c % 2 != 0 || c > 512 || !tail_plan_ok(half, c, vw, threads, {y, r, out}))
    return static_cast<int>(cudaErrorInvalidValue);
  TailArgs a{};
  a.ls = r; a.t = r + half; a.x = y + half; a.y = y; a.zb = zb; a.zlogs = zlogs;
  a.ldj_in = ldj_in; a.out = out + half; a.out_a = out; a.ldj = ldj;
  a.px = hw; a.stride = c; a.half = half; a.rows = rows;
  return static_cast<int>(
      launch_tail_fwd<true>(a, vw, threads, blocks, static_cast<cudaStream_t>(stream)));
}

// The plain-operand inverse: ls, bias, y_b [n] -> x_b [n]. `vw`, `threads`
// and `blocks` are the wrapper's plan (ops/kernels/coupling_tail.py:
// inverse_plan, with px = n / vw and half = vw).
int coupling_tail_inverse_f32(const float* ls, const float* bias, const float* yb, float* xb,
                              long long n, int vw, int threads, int blocks, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (n % vw != 0 || !tail_plan_ok(vw, vw, vw, threads, {ls, bias, yb, xb}))
    return static_cast<int>(cudaErrorInvalidValue);
  TailArgs a{};
  a.ls = ls; a.t = bias; a.x = yb; a.out = xb;
  a.px = n / vw; a.stride = vw; a.half = vw; a.rows = 1;
  return static_cast<int>(
      launch_tail_inverse<false>(a, vw, threads, blocks, static_cast<cudaStream_t>(stream)));
}

// The inverse Glow step's tail: y, r [rows, hw, c] (the step's output and
// the zeroconv's raw convolution), zb, zlogs [c] -> x [rows, hw, c]. c
// even, at most 512. Plan: inverse_plan.
int coupling_tail_inverse_step_f32(const float* y, const float* r, const float* zb,
                                   const float* zlogs, float* x, int rows, long long hw,
                                   int c, int vw, int threads, int blocks, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  const int half = c / 2;
  if (c % 2 != 0 || c > 512 || !tail_plan_ok(half, c, vw, threads, {y, r, x}))
    return static_cast<int>(cudaErrorInvalidValue);
  TailArgs a{};
  a.ls = r; a.t = r + half; a.x = y + half; a.y = y; a.zb = zb; a.zlogs = zlogs;
  a.out = x + half; a.out_a = x;
  a.px = hw; a.stride = c; a.half = half; a.rows = rows;
  return static_cast<int>(
      launch_tail_inverse<true>(a, vw, threads, blocks, static_cast<cudaStream_t>(stream)));
}

// The plain-operand tail's VJP: ls, bias, x_b, g_y [rows, d] (g_y may be
// null: zeros), g_ldj [rows] at stride g_ldj_stride (may be null) ->
// d_ls, d_xb [rows, d] (d_bias = d_xb). Plan: backward_plan.
int coupling_tail_bwd_f32(const float* ls, const float* bias, const float* xb,
                          const float* gy, const float* gldj, long long gldj_stride,
                          float* d_ls, float* d_xb, int rows, long long d, int vw,
                          int threads, int blocks, int px_per_lane, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  if (d % vw != 0 || !tail_plan_ok(vw, vw, vw, threads, {ls, bias, xb, gy, d_ls, d_xb}))
    return static_cast<int>(cudaErrorInvalidValue);
  TailArgs a{};
  a.ls = ls; a.t = bias; a.x = xb; a.g = gy; a.g_ldj = gldj; a.g_ldj_stride = gldj_stride;
  a.out = d_xb; a.d_ls = d_ls;
  a.px = d / vw; a.stride = vw; a.half = vw; a.rows = rows; a.px_per_lane = px_per_lane;
  return static_cast<int>(
      launch_tail_bwd<false>(a, vw, threads, blocks, static_cast<cudaStream_t>(stream)));
}

// The Glow step tail's VJP: y, r [rows, hw, c], zb, zlogs [c], g_out
// [rows, hw, c] (may be null), g_ldj [rows] at stride g_ldj_stride (may be
// null) -> d_y, d_r [rows, hw, c], d_zb, d_zlogs [c]. Plan as for
// coupling_tail_bwd_f32; `partial` holds blocks x 2c floats; `ticket` is an
// unsigned int, zero between launches (the kernel leaves it so).
int coupling_tail_step_bwd_f32(const float* y, const float* r, const float* zb,
                               const float* zlogs, const float* g_out, const float* gldj,
                               long long gldj_stride, float* d_y, float* d_r, float* d_zb,
                               float* d_zlogs, float* partial, void* ticket, int rows,
                               long long hw, int c, int vw, int threads, int blocks,
                               int px_per_lane, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  const int half = c / 2;
  if (c % 2 != 0 || c > 512 || !tail_plan_ok(half, c, vw, threads, {y, r, g_out, d_y, d_r}))
    return static_cast<int>(cudaErrorInvalidValue);
  TailArgs a{};
  a.ls = r; a.t = r + half; a.x = y + half; a.zb = zb; a.zlogs = zlogs;
  a.g = g_out != nullptr ? g_out + half : nullptr; a.g_a = g_out;
  a.g_ldj = gldj; a.g_ldj_stride = gldj_stride;
  a.out = d_y + half; a.out_a = d_y; a.d_ls = d_r; a.d_zb = d_zb; a.d_zlogs = d_zlogs;
  a.partial = partial; a.ticket = static_cast<unsigned int*>(ticket);
  a.px = hw; a.stride = c; a.half = half; a.rows = rows; a.px_per_lane = px_per_lane;
  return static_cast<int>(
      launch_tail_bwd<true>(a, vw, threads, blocks, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
