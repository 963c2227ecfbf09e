// Hand-written Hopper (sm_90a) kernel for one whole Glow step, forward, fp32.
//
// Replaces nfdpm_tpu/ops/pallas/step_megakernel.py (step_megakernel_forward
// -> pl.pallas_call). Plain C interface, built by nvcc into a shared library
// and loaded with ctypes (nfdpm_tpu_torch/ops/kernels/_build.py); the entry
// point launches on the stream it is given, allocates nothing and returns
// cudaGetLastError(). The wrapper (ops/kernels/step_megakernel.py) checks
// device, dtype, contiguity and shapes and packs the weights:
//
//     x [B, H, W, C], C even, half = C / 2
//     wf [C, C] (out, in), bf [C]          folded actnorm + 1x1 channel mix
//     w1 [9, half, D], s1, b1 [D]          3x3 conv to the hidden width D,
//                                          actnorm (log-scale, bias)
//     w2 [D, D] (in, out), s2, b2 [D]      1x1 conv, actnorm
//     wz [9, D, C4], bz, zl [C]            3x3 zeroconv, C4 = C rounded up
//                                          to 4 (zero columns), log-scale
//
// Taps are tap-major in the order (dh + 1) * 3 + (dw + 1). Per pixel:
//
//     y    = x wf^T + bf;  y_a, x_b = split(y)
//     h1   = relu(e^{s1} (conv3x3(y_a, w1) + b1))
//     h2   = relu(e^{s2} (h1 w2 + b2))
//     net  = (conv3x3(h2, wz) + bz) e^{3 zl};  ls, t = split(net)
//     s    = sigmoid(ls + 2);  y = [y_a, (x_b + t) s]
//     rows = sum_j log(s_j + 1e-6)            per pixel; ldj[b] = sum of rows
//
// Bound: operations. At the Glow's widths (D = 512, C = 12 / 24 / 48 on the
// served model) a pixel costs 2 (9 half D + D D + 9 D C + C C) flops, 0.69
// to 1.19 MFLOP, and moves 8 C bytes; the weights (1-2 MB) stay in L2. The
// 1x1 conv (D x D per pixel) is most of it at the first level, the
// zeroconv and the first conv add up to as much at the last.
//
// Design. One block takes one output tile (th x tw pixels of one image) and
// keeps one 512-wide hidden on chip, as the TPU kernel keeps both in VMEM:
// - y_a is computed on the tile plus two pixels all round, into shared
//   memory, zero outside the image (the convs' padding), so no tap needs a
//   mask;
// - h1 on the tile plus one pixel all round, clipped to the image ("region
//   1"), all D channels, channel-major in shared memory: each thread makes
//   4 pixels x 4 channels from 9 taps x half inputs;
// - h2 is never whole: chunks of nc channels are a register-tiled product
//   (4 pixels x 4 channels per thread, one or two such quads) of h1 with
//   rows of w2 staged through shared memory 32 at a time, in two stages
//   (cp.async: the next rows load while these are used); each chunk, after
//   its actnorm and ReLU, goes to a zero-bordered box in shared memory and
//   straight into the zeroconv's accumulators (C channels per tile pixel,
//   kept in registers over all chunks; where the tile has few pixels the
//   chunk's channels are split among several threads per output and their
//   partial sums are added in a fixed order at the end);
// - the first conv's and the zeroconv's weights (w1, wz: up to 0.9 MB) are
//   read through L1 from L2, each thread issuing a channel's nine taps at
//   once; one dependent load at a time left the kernel waiting on L2;
// - the affine tail runs on the tile, and each pixel's log terms are summed
//   in channel order; a second small kernel sums an image's pixels in a
//   fixed order. No atomics anywhere: two calls give the same bits.
// The halo costs work: region 1 is up to (th + 2)(tw + 2) pixels for th tw
// outputs, and the first conv and the 1x1 conv run on all of it. The host
// picks the tile (th, tw) and the chunk width nc per shape from a simple
// cost model (plan_for() below): the work per block, the number of blocks per
// wave, shared memory within the 227 KB of a block. No tensor cores: TF32
// would break the fp32 parity the TPU kernel keeps with Precision.HIGHEST.
// The Pallas kernel's flattened rows, pltpu.roll taps and iota masks are a
// Mosaic device and are not carried over; pixels are indexed directly.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int QMAX = 2;         // 4x4 quads of the 1x1 conv per thread
constexpr int ZMAX = 4;         // zeroconv outputs (1 pixel x 4 channels) per thread
constexpr int KC = 32;          // rows of w2 staged per step
constexpr long long SMEM_LIMIT = 232448;   // a block's shared memory on Hopper
constexpr long long SM_SMEM = 233472;      // an SM's, as blocks see it
constexpr int SM_COUNT = 132;              // H100 SXM
constexpr int MAX_DEVICES = 64;
constexpr float COUPLING_EPS = 1e-6f;

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }
__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// The tiling of one shape; offsets and strides in floats.
struct Plan {
  int th, tw;     // output tile
  int nc;         // hidden channels per chunk of h2
  int slots;      // 4x4 quads of the 1x1 conv per thread (1 or 2)
  int ks;         // threads that share one zeroconv output
  int s1;         // channel stride of h1
  int pbs;        // channel stride of an h2 chunk
  int off_h1, off_work;  // y_a at 0; w2 rows + h2 chunk, later the partial sums
  long long smem;        // bytes
  double cost;
};

// Fill `pl` for a tile th x tw and chunk width nc; false where it does not
// fit. Cost: FMA steps of one thread over the block, times waves of blocks.
bool plan_for(int batch, int h, int w, int c, int d, int th, int tw, int nc, Plan* pl) {
  const int half = c / 2, cq = cdiv(c, 4);
  const int p1 = (th + 2 < h ? th + 2 : h) * (tw + 2 < w ? tw + 2 : w);
  const int p1q = cdiv(p1, 4);
  const int quads = p1q * (nc / 4);
  if (quads > THREADS * QMAX) return false;
  const int items = th * tw * cq;
  if (items > THREADS * ZMAX) return false;
  pl->th = th; pl->tw = tw; pl->nc = nc;
  pl->slots = cdiv(quads, THREADS);
  pl->ks = items <= THREADS ? THREADS / items : 1;
  pl->s1 = (p1q & 1) ? 4 * p1q : 4 * p1q + 4;  // odd number of quads: no bank conflicts
  pl->pbs = ((th + 2) * (tw + 2)) | 1;
  const int ya = round4((th + 4) * (tw + 4) * half);
  const int h1 = d * pl->s1;
  const int chunk = 2 * KC * nc + round4(nc * pl->pbs);
  const int partial = round4(pl->ks * items * 4) + th * tw * cq * 4;
  pl->off_h1 = ya;
  pl->off_work = ya + h1;
  pl->smem = 4LL * (ya + h1 + (chunk > partial ? chunk : partial));
  if (pl->smem > SMEM_LIMIT) return false;
  const int chunks = cdiv(d, nc);
  const double gemm = static_cast<double>(chunks) * d * pl->slots * 16;
  const double conv1 = static_cast<double>(cdiv(p1q * (d / 4), THREADS)) * 9 * half * 16;
  const double zconv = static_cast<double>(chunks) * cdiv(nc, pl->ks) * 9 * 4 *
                       (items <= THREADS ? 1 : cdiv(items, THREADS));
  const double mix = static_cast<double>(cdiv((th + 4) * (tw + 4) * half, THREADS)) * c;
  const long long blocks = static_cast<long long>(cdiv(h, th)) * cdiv(w, tw) * batch;
  long long per_sm = SM_SMEM / (pl->smem + 1024);
  per_sm = per_sm < 1 ? 1 : (per_sm > 2 ? 2 : per_sm);
  const long long waves = (blocks + SM_COUNT * per_sm - 1) / (SM_COUNT * per_sm);
  // two blocks on one SM share its FMA units, and hide each other's latency
  pl->cost = static_cast<double>(waves) * (gemm + conv1 + zconv + mix) *
             (per_sm == 2 ? 1.5 : 1.0);
  return true;
}

// The cheapest plan over tiles (th <= min(h, 64), tw from w down) and chunk
// widths (multiples of 4 up to d); false when none fits (d too wide). Some
// 10^4 evaluations of plan_for: asked once per shape, not per launch.
bool plan(int batch, int h, int w, int c, int d, Plan* best) {
  if (batch <= 0 || h <= 0 || w <= 0 || c <= 0 || (c & 1) || d <= 0 || (d & 3))
    return false;
  bool found = false;
  const int tws[] = {w, 32, 16, 8, 4, 2, 1};
  for (int i = 0; i < 7; ++i) {
    const int tw = tws[i];
    if (tw > w || (i > 0 && tw >= w)) continue;
    for (int th = 1; th <= h && th <= 64; ++th) {
      for (int nc = 4; nc <= d; nc += 4) {
        Plan pl;
        // quads and shared memory grow with nc: the first misfit ends the row
        if (!plan_for(batch, h, w, c, d, th, tw, nc, &pl)) break;
        if (!found || pl.cost < best->cost) {
          *best = pl;
          found = true;
        }
      }
    }
  }
  return found;
}

__device__ __forceinline__ void fma4x4(float (&acc)[4][4], const float4 a, const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    acc[u][0] = fmaf(av[u], b.x, acc[u][0]);
    acc[u][1] = fmaf(av[u], b.y, acc[u][1]);
    acc[u][2] = fmaf(av[u], b.z, acc[u][2]);
    acc[u][3] = fmaf(av[u], b.w, acc[u][3]);
  }
}

// 16 bytes from global to shared memory without a register, asynchronously
// (cp.async; sm_80 and later). Host compilers see a plain copy.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(src) : "memory");
#else
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// Wait until at most N groups of this thread's copies are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

// S: 4x4 quads of the 1x1 conv per thread (the plan's slots).
template <int S>
__global__ void __launch_bounds__(THREADS)
step_megakernel_kernel(const float* __restrict__ x, const float* __restrict__ wf,
                       const float* __restrict__ bf, const float* __restrict__ w1,
                       const float* __restrict__ s1, const float* __restrict__ b1,
                       const float* __restrict__ w2, const float* __restrict__ s2,
                       const float* __restrict__ b2, const float* __restrict__ wz,
                       const float* __restrict__ bz, const float* __restrict__ zl,
                       float* __restrict__ y, float* __restrict__ rows,
                       int h, int w, int c, int d, Plan pl) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* ya = smem;                  // [(th+4)(tw+4)][half], zero outside the image
  float* h1 = smem + pl.off_h1;      // [d][s1], region-1 pixels
  float* w2s = smem + pl.off_work;   // [2][KC][nc], two stages of w2 rows
  float* h2s = w2s + 2 * KC * pl.nc; // [nc][pbs], (th+2)(tw+2) box, zero outside the image

  const int tid = threadIdx.x;
  const int half = c / 2, cq = cdiv(c, 4), dq = d / 4, nq_per = pl.nc / 4;
  const int tiles_w = cdiv(w, pl.tw);
  const int b = blockIdx.y;
  const int th0 = (blockIdx.x / tiles_w) * pl.th, tw0 = (blockIdx.x % tiles_w) * pl.tw;
  const int th = min(pl.th, h - th0), tw = min(pl.tw, w - tw0);
  const int r1a = max(0, th0 - 1), r1b = min(h, th0 + th + 1);
  const int c1a = max(0, tw0 - 1), c1b = min(w, tw0 + tw + 1);
  const int r1w = c1b - c1a, p1 = (r1b - r1a) * r1w, p1q = cdiv(p1, 4);
  const int yw = pl.tw + 4, yh = pl.th + 4, pbw = pl.tw + 2;
  const float* ximg = x + static_cast<long long>(b) * h * w * c;

  // 1. y_a = (x wf^T + bf)[:half] on the tile +- 2
  for (int i = tid; i < yh * yw * half; i += THREADS) {
    const int j = i % half, q = i / half;
    const int rr = th0 - 2 + q / yw, cc = tw0 - 2 + q % yw;
    float v = 0.f;
    if (rr >= 0 && rr < h && cc >= 0 && cc < w) {
      const float* xp = ximg + (static_cast<long long>(rr) * w + cc) * c;
      const float* wr = wf + j * c;
      float acc = 0.f;
      for (int k = 0; k < c; ++k) acc = fmaf(xp[k], wr[k], acc);
      v = acc + bf[j];
    }
    ya[i] = v;
  }
  for (int i = tid; i < pl.nc * pl.pbs; i += THREADS) h2s[i] = 0.f;
  __syncthreads();

  // 2. h1 = relu(e^{s1} (conv3x3(y_a, w1) + b1)) on region 1: 4 pixels x 4
  // channels per item; channels fastest across the threads, so the y_a
  // reads are broadcasts and the w1 reads coalesce
  for (int it = tid; it < p1q * dq; it += THREADS) {
    const int kq = it % dq, pq = it / dq;
    int base[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int p = min(4 * pq + u, p1 - 1);  // a ragged quad repeats its last pixel
      const int rr = r1a + p / r1w, cc = c1a + p % r1w;
      base[u] = ((rr - th0 + 2) * yw + (cc - tw0 + 2)) * half;
    }
    float acc[4][4] = {};
    const float4* wt = reinterpret_cast<const float4*>(w1) + kq;
#pragma unroll 2
    for (int j = 0; j < half; ++j) {
      // the nine taps' weights first: nine loads from L2 in flight at once
      float4 wv[9];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) wv[tap] = __ldg(wt + (tap * half + j) * dq);
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int shift = ((tap / 3 - 1) * yw + (tap % 3 - 1)) * half + j;
        const float4 av = make_float4(ya[base[0] + shift], ya[base[1] + shift],
                                      ya[base[2] + shift], ya[base[3] + shift]);
        fma4x4(acc, av, wv[tap]);
      }
    }
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int k = 4 * kq + v;
      const float es = expf(s1[k]), bb = b1[k];
      *reinterpret_cast<float4*>(h1 + k * pl.s1 + 4 * pq) =
          make_float4(fmaxf(es * (acc[0][v] + bb), 0.f), fmaxf(es * (acc[1][v] + bb), 0.f),
                      fmaxf(es * (acc[2][v] + bb), 0.f), fmaxf(es * (acc[3][v] + bb), 0.f));
    }
  }

  // this thread's quads of the 1x1 conv (a quad past the end repeats quad 0
  // and is not stored) and its zeroconv outputs (pixel fastest across the
  // threads, so the h2 reads are consecutive and the wz reads broadcasts)
  const int quads = p1q * nq_per;
  int qp[S], qn[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int q = tid + s * THREADS < quads ? tid + s * THREADS : 0;
    qp[s] = q / nq_per;
    qn[s] = q % nq_per;
  }
  const int pt = th * tw, items = pt * cq, planned = pl.th * pl.tw * cq;
  const int slice = pl.ks > 1 ? tid / planned : 0;
  int zoff[ZMAX], zcq[ZMAX];
  bool zon[ZMAX];
#pragma unroll
  for (int z = 0; z < ZMAX; ++z) {
    const int item = pl.ks > 1 ? (z == 0 ? tid % planned : items) : tid + z * THREADS;
    zon[z] = item < items && slice < pl.ks;
    const int p = zon[z] ? item % pt : 0;
    zcq[z] = zon[z] ? item / pt : 0;
    zoff[z] = (p / tw + 1) * pbw + (p % tw + 1);
  }
  float zacc[ZMAX][4] = {};

  // 3. chunks of h2, each folded into the zeroconv
  for (int n0 = 0; n0 < d; n0 += pl.nc) {
    const int nvalid = min(pl.nc, d - n0);
    float acc[S][4][4] = {};
    // rows k0 .. k0 + KC of w2's chunk columns into stage `st` (zeros past the end)
    auto fetch = [&](int k0, int st) {
      float* dst = w2s + st * KC * pl.nc;
      for (int i = tid; i < KC * nq_per; i += THREADS) {
        const int kk = i / nq_per, nn = 4 * (i % nq_per);
        if (k0 + kk < d && n0 + nn < d)
          cp_async16(dst + kk * pl.nc + nn, w2 + static_cast<long long>(k0 + kk) * d + n0 + nn);
        else
          *reinterpret_cast<float4*>(dst + kk * pl.nc + nn) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      cp_async_commit();
    };
    __syncthreads();  // h1 written; the last chunk's stages consumed
    fetch(0, 0);
    for (int k0 = 0, st = 0; k0 < d; k0 += KC, st ^= 1) {
      const int kvalid = min(KC, d - k0);
      if (k0 + KC < d) {
        fetch(k0 + KC, st ^ 1);  // the next rows load while these are used
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* hk = h1 + k0 * pl.s1;
      const float* wk = w2s + st * KC * pl.nc;
#pragma unroll 4
      for (int kk = 0; kk < kvalid; ++kk) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float4 a = *reinterpret_cast<const float4*>(hk + kk * pl.s1 + 4 * qp[s]);
          const float4 bv = *reinterpret_cast<const float4*>(wk + kk * pl.nc + 4 * qn[s]);
          fma4x4(acc[s], a, bv);
        }
      }
      __syncthreads();  // stage st is refilled two steps on
    }
    // h2 = relu(e^{s2} (acc + b2)) into the zero-bordered box
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (tid + s * THREADS >= quads) continue;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int n = n0 + 4 * qn[s] + v;
        if (n >= d) continue;
        const float es = expf(s2[n]), bb = b2[n];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int p = 4 * qp[s] + u;
          if (p >= p1) continue;
          const int rr = r1a + p / r1w, cc = c1a + p % r1w;
          h2s[(4 * qn[s] + v) * pl.pbs + (rr - th0 + 1) * pbw + (cc - tw0 + 1)] =
              fmaxf(es * (acc[s][u][v] + bb), 0.f);
        }
      }
    }
    __syncthreads();
    // zeroconv: this slice's contiguous share of the chunk's channels; per
    // channel the nine taps' weights are loaded together, nine loads from
    // L2 in flight at once
    const int per = cdiv(nvalid, pl.ks);
    const int k_lo = min(nvalid, slice * per), k_hi = min(nvalid, k_lo + per);
    const long long tap_stride = static_cast<long long>(d) * cq;  // float4s
#pragma unroll
    for (int z = 0; z < ZMAX; ++z) {
      if (!zon[z]) continue;
      const float* hp = h2s + zoff[z];
      const float4* wp = reinterpret_cast<const float4*>(wz) +
                         static_cast<long long>(n0) * cq + zcq[z];
#pragma unroll 2
      for (int kk = k_lo; kk < k_hi; ++kk) {
        float4 wv[9];
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) wv[tap] = __ldg(wp + tap * tap_stride + kk * cq);
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const float hv = hp[kk * pl.pbs + (tap / 3 - 1) * pbw + (tap % 3 - 1)];
          zacc[z][0] = fmaf(hv, wv[tap].x, zacc[z][0]);
          zacc[z][1] = fmaf(hv, wv[tap].y, zacc[z][1]);
          zacc[z][2] = fmaf(hv, wv[tap].z, zacc[z][2]);
          zacc[z][3] = fmaf(hv, wv[tap].w, zacc[z][3]);
        }
      }
    }
  }
  __syncthreads();  // the chunk buffers become the partial sums

  // 4. the zeroconv's outputs: add the slices' partial sums in slice order,
  // then the bias and the scale
  float* part = smem + pl.off_work;                    // [ks][planned][4]
  float* net = part + round4(pl.ks * planned * 4);     // [pt][4 cq]
  if (pl.ks > 1) {
    if (zon[0]) {
#pragma unroll
      for (int v = 0; v < 4; ++v) part[(slice * planned + tid % planned) * 4 + v] = zacc[0][v];
    }
    __syncthreads();
    if (zon[0] && slice == 0) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        float sum = 0.f;
        for (int sl = 0; sl < pl.ks; ++sl) sum += part[(sl * planned + tid) * 4 + v];
        zacc[0][v] = sum;
      }
    }
  }
#pragma unroll
  for (int z = 0; z < ZMAX; ++z) {
    if (!zon[z] || slice != 0) continue;
    const int item = pl.ks > 1 ? tid : tid + z * THREADS;
    const int p = item % pt;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int ch = 4 * zcq[z] + v;
      if (ch < c) net[p * 4 * cq + ch] = (zacc[z][v] + bz[ch]) * expf(3.f * zl[ch]);
    }
  }
  __syncthreads();

  // 5. affine tail and each pixel's log terms, summed in channel order
  for (int p = tid; p < pt; p += THREADS) {
    const int tr = p / tw, tc = p % tw, rr = th0 + tr, cc = tw0 + tc;
    const long long pix = (static_cast<long long>(b) * h + rr) * w + cc;
    const float* xp = x + pix * c;
    float* yp = y + pix * c;
    const float* yap = ya + ((tr + 2) * yw + (tc + 2)) * half;
    const float* np_ = net + p * 4 * cq;
    float ldj = 0.f;
    for (int j = 0; j < half; ++j) {
      const float* wr = wf + (half + j) * c;
      float acc = 0.f;
      for (int k = 0; k < c; ++k) acc = fmaf(xp[k], wr[k], acc);
      const float xb = acc + bf[half + j];
      const float sc = 1.f / (1.f + expf(-(np_[j] + 2.f)));
      yp[j] = yap[j];
      yp[half + j] = (xb + np_[half + j]) * sc;
      ldj += logf(sc + COUPLING_EPS);
    }
    rows[pix] = ldj;
  }
}

// ldj[b] = sum of the image's n per-pixel rows, in a fixed order.
__global__ void __launch_bounds__(THREADS)
rows_sum_kernel(const float* __restrict__ rows, float* __restrict__ ldj, int n) {
  __shared__ float part[THREADS];
  const float* r = rows + static_cast<long long>(blockIdx.x) * n;
  float acc = 0.f;
  for (int i = threadIdx.x; i < n; i += THREADS) acc += r[i];
  part[threadIdx.x] = acc;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (static_cast<int>(threadIdx.x) < s) part[threadIdx.x] += part[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) ldj[blockIdx.x] = part[0];
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

// The cheapest plan of a shape (a search over tiles and chunk widths: the
// wrapper asks once per shape and keeps the answer): out = [th, tw, nc,
// slots, ks]; returns the dynamic shared memory in bytes, or -1 where no
// tiling fits (an odd C, a hidden width that is not a multiple of 4 or too
// wide).
long long step_megakernel_plan(int batch, int h, int w, int c, int d, int* out) {
  Plan pl;
  if (!plan(batch, h, w, c, d, &pl)) return -1;
  out[0] = pl.th; out[1] = pl.tw; out[2] = pl.nc; out[3] = pl.slots; out[4] = pl.ks;
  return pl.smem;
}

// x [B, H, W, C] -> y [B, H, W, C], rows [B, H, W] (scratch: the per-pixel
// log terms) and ldj [B]; weights as the note at the top says. (th, tw, nc)
// is a plan from step_megakernel_plan for the same shape.
int step_megakernel_f32(const float* x, const float* wf, const float* bf, const float* w1,
                        const float* s1, const float* b1, const float* w2, const float* s2,
                        const float* b2, const float* wz, const float* bz, const float* zl,
                        float* y, float* rows, float* ldj, int batch, int h, int w, int c,
                        int d, int th, int tw, int nc, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0) return static_cast<int>(cudaSuccess);
  Plan pl;
  if ((c & 1) || (d & 3) || th < 1 || th > h || tw < 1 || tw > w || nc < 4 || (nc & 3) ||
      nc > d || !plan_for(batch, h, w, c, d, th, tw, nc, &pl))
    return static_cast<int>(cudaErrorInvalidValue);
  static long long granted1[MAX_DEVICES] = {};
  static long long granted2[MAX_DEVICES] = {};
  cudaError_t err = pl.slots == 1
      ? grant_smem(step_megakernel_kernel<1>, pl.smem, granted1)
      : grant_smem(step_megakernel_kernel<2>, pl.smem, granted2);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(cdiv(h, pl.th) * cdiv(w, pl.tw)),
                  static_cast<unsigned>(batch));
  if (pl.slots == 1) {
    step_megakernel_kernel<1><<<grid, THREADS, static_cast<size_t>(pl.smem), s>>>(
        x, wf, bf, w1, s1, b1, w2, s2, b2, wz, bz, zl, y, rows, h, w, c, d, pl);
  } else {
    step_megakernel_kernel<2><<<grid, THREADS, static_cast<size_t>(pl.smem), s>>>(
        x, wf, bf, w1, s1, b1, w2, s2, b2, wz, bz, zl, y, rows, h, w, c, d, pl);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rows_sum_kernel<<<batch, THREADS, 0, s>>>(rows, ldj, h * w);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
