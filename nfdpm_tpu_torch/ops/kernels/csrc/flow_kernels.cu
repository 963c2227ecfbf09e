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
//        y[n, o] = sum_c x[n, c] * w[o, c] + b[o]
//    Bound: bytes. At the Glow widths (C = O <= 48 on the served model) one
//    launch moves 4*(N*C + N*O + O*C + O) bytes, about 1.6 MB at the first
//    level, and does 2*N*C*O flops, far below the fp32 rate. So the kernel
//    must read x once and write y once; the arithmetic is free. Design: a
//    block takes `rows` pixel rows, stages those rows and the transposed
//    weight W^T plus the bias in shared memory (W^T is at most 48x48 fp32,
//    9 KB, on this path), and each thread produces outputs with fp32 FMAs
//    over C. Reads of x and writes of y are contiguous across the block, so
//    they coalesce. W^T's row stride is made odd, so that neither its
//    transposing store nor the reads along O meet bank conflicts. `rows`
//    halves from CM_ROWS until the grid has two blocks per SM (or a block
//    has CM_MIN_ROWS rows): at N = 1024 a fixed 64-row tile gave 16 blocks
//    for 132 SMs. No padding of C or O to 128 lanes: that was a TPU tiling
//    artefact. No tensor cores: TF32 would break the fp32 parity that the
//    TPU kernel holds with Precision.HIGHEST. At these sizes launch overhead,
//    not bandwidth, dominates; that is left to a later change.
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

#include <cuda_runtime.h>

namespace {

constexpr int CM_ROWS = 64;
constexpr int CM_MIN_ROWS = 4;
constexpr int CM_THREADS = 256;
constexpr long long SM_COUNT = 132;  // H100 SXM
constexpr int CT_THREADS = 256;
constexpr int EW_THREADS = 256;
constexpr float COUPLING_EPS = 1e-6f;

__device__ __forceinline__ float sigmoid_shift2(float v) {
  return 1.0f / (1.0f + expf(-(v + 2.0f)));
}

// Row stride of the staged W^T: odd, so strided shared-memory accesses
// spread over all 32 banks.
__host__ __device__ __forceinline__ int odd_stride(int o) { return o | 1; }

__global__ void __launch_bounds__(CM_THREADS)
channel_mix_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ b, float* __restrict__ y,
                   long long n, int c, int o, int rows_per_block) {
  extern __shared__ float smem[];
  const int os = odd_stride(o);
  float* wt = smem;         // [c][os], wt[k * os + j] = w[j * c + k]
  float* bs = wt + c * os;  // [o]
  float* xs = bs + o;       // [rows_per_block][c]

  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long left = n - row0;
  const int rows = left < rows_per_block ? static_cast<int>(left) : rows_per_block;

  for (int i = threadIdx.x; i < c * o; i += blockDim.x) {
    const int j = i / c, k = i - j * c;
    wt[k * os + j] = w[i];
  }
  for (int j = threadIdx.x; j < o; j += blockDim.x) bs[j] = b[j];
  const float* xg = x + row0 * c;
  for (int i = threadIdx.x; i < rows * c; i += blockDim.x) xs[i] = xg[i];
  __syncthreads();

  float* yg = y + row0 * o;
  for (int i = threadIdx.x; i < rows * o; i += blockDim.x) {
    const int r = i / o, j = i - r * o;
    const float* xr = xs + r * c;
    float acc = 0.0f;
    for (int k = 0; k < c; ++k) acc = fmaf(xr[k], wt[k * os + j], acc);
    yg[i] = acc + bs[j];
  }
}

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

}  // namespace

extern "C" {

// Shared memory one channel_mix block needs, in bytes, at its largest row
// tile; the wrapper checks it against the card's limit before it launches.
long long channel_mix_smem_bytes(int c, int o) {
  return 4LL * (static_cast<long long>(c) * odd_stride(o) + o +
                static_cast<long long>(CM_ROWS) * c);
}

int channel_mix_f32(const float* x, const float* w, const float* b, float* y,
                    long long n, int c, int o, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  int rows = CM_ROWS;
  while (rows > CM_MIN_ROWS && (n + rows - 1) / rows < 2 * SM_COUNT) rows /= 2;
  const long long smem =
      4LL * (static_cast<long long>(c) * odd_stride(o) + o + static_cast<long long>(rows) * c);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        channel_mix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (n + rows - 1) / rows;
  channel_mix_kernel<<<static_cast<unsigned>(blocks), CM_THREADS,
                       static_cast<size_t>(smem),
                       static_cast<cudaStream_t>(stream)>>>(x, w, b, y, n, c, o, rows);
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

}  // extern "C"
