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
// 2. coupling_tail_f32 replaces nfdpm_tpu/ops/pallas/coupling_tail.py
//    (coupling_tail -> _forward -> pl.pallas_call):
//        s = sigmoid(ls + 2); y_b = (x_b + bias) * s; ldj[r] = sum log(s + 1e-6)
//    Bound: bytes (three reads, one write per element, a few transcendental
//    ops each). Design: one block per batch row loops over the row's D
//    elements, writes y_b and reduces the log terms with a warp shuffle and
//    then a shared-memory pass over the warps' partials, in a fixed order and
//    without atomics, so ldj is the same from run to run. The ragged tail of
//    D is masked by the loop bound; the TPU kernel's pad to 128 lanes and its
//    analytic correction of the logdet are not carried over. With a batch of
//    64 only 64 of the 132 SMs get a block; accepted for now.
//
// 3. coupling_tail_inverse_f32 replaces the second pl.pallas_call in
//    nfdpm_tpu/ops/pallas/coupling_tail.py (coupling_tail_inverse):
//        x_b = y_b / (sigmoid(ls + 2) + 1e-6) - bias
//    Bound: bytes. A grid-stride elementwise pass, no reduction.
//
// 4. coupling_tail_bwd_f32 is the vector-Jacobian product of coupling_tail
//    (nfdpm_tpu/ops/pallas/coupling_tail.py:_bwd, which the JAX package
//    leaves to XLA to fuse into one pass; eager PyTorch would run it as about
//    ten elementwise kernels over four tensors):
//        s = sigmoid(ls + 2); ds = s (1 - s)
//        d_ls = g_y (x_b + bias) ds + g_ldj[r] ds / (s + 1e-6)
//        d_xb = d_bias = g_y s                      (one tensor, written once)
//    Bound: bytes (four reads and two writes per element, plus g_ldj[rows]).
//    A grid-stride elementwise pass; the row of an element is i / d. g_y or
//    g_ldj may be null (that output of the forward pass was not used) and
//    then counts as zeros. No reduction, so nothing depends on block order.

#include <cuda_runtime.h>

namespace {

constexpr int CM_GENERIC_THREADS = 256;
constexpr int CM_MAX_THREADS = 512;  // the plan's largest block
constexpr long long SM_COUNT = 132;  // H100 SXM
constexpr int CT_THREADS = 256;
constexpr int EW_THREADS = 256;
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

__global__ void __launch_bounds__(CT_THREADS)
coupling_tail_kernel(const float* __restrict__ ls, const float* __restrict__ bias,
                     const float* __restrict__ xb, float* __restrict__ yb,
                     float* __restrict__ ldj, long long d) {
  const long long base = static_cast<long long>(blockIdx.x) * d;
  float acc = 0.0f;
  for (long long i = threadIdx.x; i < d; i += blockDim.x) {
    const float s = sigmoid_shift2(ls[base + i]);
    yb[base + i] = (xb[base + i] + bias[base + i]) * s;
    acc += logf(s + COUPLING_EPS);
  }
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);

  __shared__ float warp_sums[CT_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < CT_THREADS / 32 ? warp_sums[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) ldj[blockIdx.x] = acc;
  }
}

__global__ void __launch_bounds__(EW_THREADS)
coupling_tail_inverse_kernel(const float* __restrict__ ls,
                             const float* __restrict__ bias,
                             const float* __restrict__ yb,
                             float* __restrict__ xb, long long total) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const float s = sigmoid_shift2(ls[i]);
    xb[i] = yb[i] / (s + COUPLING_EPS) - bias[i];
  }
}

__global__ void __launch_bounds__(EW_THREADS)
coupling_tail_bwd_kernel(const float* __restrict__ ls,
                         const float* __restrict__ bias,
                         const float* __restrict__ xb,
                         const float* __restrict__ gy,    // null: zeros
                         const float* __restrict__ gldj,  // [rows]; null: zeros
                         float* __restrict__ d_ls, float* __restrict__ d_xb,
                         long long d, long long total) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const float s = sigmoid_shift2(ls[i]);
    const float ds = s * (1.0f - s);
    const float g = gy != nullptr ? gy[i] : 0.0f;
    const float gl = gldj != nullptr ? gldj[i / d] : 0.0f;
    d_ls[i] = g * (xb[i] + bias[i]) * ds + gl * ds / (s + COUPLING_EPS);
    d_xb[i] = g * s;
  }
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

int coupling_tail_f32(const float* ls, const float* bias, const float* xb,
                      float* yb, float* ldj, int rows, long long d,
                      void* stream) {
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  coupling_tail_kernel<<<rows, CT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      ls, bias, xb, yb, ldj, d);
  return static_cast<int>(cudaGetLastError());
}

int coupling_tail_inverse_f32(const float* ls, const float* bias,
                              const float* yb, float* xb, long long total,
                              void* stream) {
  if (total <= 0) return static_cast<int>(cudaSuccess);
  long long blocks = (total + EW_THREADS - 1) / EW_THREADS;
  if (blocks > 132LL * 16) blocks = 132LL * 16;  // grid-stride beyond that
  coupling_tail_inverse_kernel<<<static_cast<unsigned>(blocks), EW_THREADS, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      ls, bias, yb, xb, total);
  return static_cast<int>(cudaGetLastError());
}

int coupling_tail_bwd_f32(const float* ls, const float* bias, const float* xb,
                          const float* gy, const float* gldj, float* d_ls,
                          float* d_xb, int rows, long long d, void* stream) {
  const long long total = static_cast<long long>(rows) * d;
  if (total <= 0) return static_cast<int>(cudaSuccess);
  long long blocks = (total + EW_THREADS - 1) / EW_THREADS;
  if (blocks > SM_COUNT * 16) blocks = SM_COUNT * 16;  // grid-stride beyond that
  coupling_tail_bwd_kernel<<<static_cast<unsigned>(blocks), EW_THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      ls, bias, xb, gy, gldj, d_ls, d_xb, d, total);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
