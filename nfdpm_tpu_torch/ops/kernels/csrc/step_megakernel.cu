// Hand-written Hopper (sm_90a) kernel for one whole Glow step, forward, fp32.
//
// Replaces nfdpm_tpu/ops/pallas/step_megakernel.py (step_megakernel_forward
// -> pl.pallas_call). Plain C interface, built by nvcc into a shared library
// and loaded with ctypes (nfdpm_tpu_torch/ops/kernels/_build.py); the entry
// point launches on the stream it is given, allocates nothing (the wrapper
// passes the scratch z) and returns cudaGetLastError(). The wrapper
// (ops/kernels/step_megakernel.py) checks device, dtype, contiguity and
// shapes, packs the weights and hands over its plan:
//
//     x [B, H, W, C], C even, half = C / 2
//     wf [C, C] (out, in), bf [C]          folded actnorm + 1x1 channel mix
//     w1 [9 half, D] tap-major, s1, b1 [D] 3x3 conv to the hidden width D,
//                                          actnorm (log-scale, bias)
//     w2 [D, D] (in, out), s2, b2 [D]      1x1 conv, actnorm
//     wz [D, ZC], bz, zl [C]               3x3 zeroconv, scatter form: column
//                                          tap C + c holds tap's weight to
//                                          output channel c; ZC = 9 C rounded
//                                          up to 8 (zero columns); log-scale
//     w1, w2 and wz in the B-fragment layout (frag_b there: blocks of 8 x 8)
//
// Taps are in the order (dh + 1) * 3 + (dw + 1). Per pixel:
//
//     y    = x wf^T + bf;  y_a, x_b = split(y)
//     h1   = relu(e^{s1} (conv3x3(y_a, w1) + b1))
//     h2   = relu(e^{s2} (h1 w2 + b2))
//     net  = (conv3x3(h2, wz) + bz) e^{3 zl};  ls, t = split(net)
//     s    = sigmoid(ls + 2);  y = [y_a, (x_b + t) s]
//     ldj[b] = sum over the image's pixels and j of log(s_j + 1e-6)
//
// Bound: operations. At the Glow's widths (D = 512, C = 12 / 24 / 48) a
// pixel costs 2 (9 half D + D D + 9 D C + C C) flops, 0.69 to 1.19 MFLOP,
// and moves 8 C bytes; the weights (1-2 MB) stay in L2. 64.2 GFLOP a pass
// of 12 steps at batch 64: 0.96 ms at the fp32 rate (67 TFLOP/s), 0.39 ms
// on this kernel's route, 3 x the flops at the TF32 rate (495 TFLOP/s).
//
// Design. Every product runs on the tensor cores in 3xTF32 (mma.sync
// m16n8k8, fp32 operands split into TF32 hi + lo, three products: about
// 2^-19 relative, the fp32 gates of the JAX package's Precision.HIGHEST
// kernel; tf32_mma.cuh, shared with the attention), each ring stage's sums
// added to the running ones outside the tensor cores (they round toward
// zero, a bias that grows with the depth). mma.sync and not wgmma:
// 3xTF32 splits every operand in registers before its product, which
// wgmma's shared-memory B operand cannot take without a second copy of
// each weight tile, and the level shapes give 16-64-row tiles, not
// wgmma's 64.
// - A block takes M = 16 mt consecutive pixels of the flattened [B, H, W]
//   (mt = 4, 2, 1 at the three level shapes: 256, 128 and 64 blocks),
//   whatever image rows or images they cover.
// - No halo. The zeroconv runs in scatter form: each pixel q's h2 times
//   wz gives Z[q][tap C + c], the share of q in the output of pixel q -
//   (dh, dw), a [M x D] x [D x ZC] product over the block's own pixels
//   only. So h2, and with it h1 and the 1x1 conv, is needed on the
//   block's pixels alone, and no block recomputes another's border
//   (halo_waste 1 where M divides B H W); the 3x3 conv1 reads y_a on the
//   block's pixels +- (W + 1), which the block mixes itself (C half
//   multiply-adds a pixel: scalar fp32). A second small kernel gathers
//   each output pixel's nine taps of Z in tap order, adds bias and scale,
//   runs the affine tail and sums an image's log terms in a fixed order
//   (one block an image). No atomics anywhere: two calls give the same
//   bits.
// - Products. conv1 is an implicit GEMM [M x 9 half] x [9 half x D] on an
//   im2col tile in shared memory, in chunks of 512 / mt hidden channels;
//   h1 [M x D] stays in shared memory. Then per chunk of 512 / mt
//   channels: the 1x1 conv [M x D] x [D x chunk], its actnorm and ReLU into
//   a chunk of h2 in shared memory, and that chunk's scatter zeroconv
//   [M x chunk] x [chunk x ZC] into accumulators that stay in registers
//   over all chunks. Eight warps split each product's columns; every warp
//   holds all mt row tiles, so an A fragment serves all its column tiles
//   and a B fragment all its row tiles.
// - Feeding. Every B operand (w1's, w2's and wz's rows) streams through one
//   ring of `stages` buffers of 32 rows (16 at mt = 1) by cp.async (the
//   next stages load while this one is multiplied; zeros past the edges),
//   and the next product's first stages are issued as soon as a product
//   ends, so they load during its epilogue: the zeroconv's weights no
//   longer wait on L2 one dependent load at a time. The weights come
//   packed in the B-fragment layout and the A operands (the im2col tile,
//   h1, each h2 chunk) are written in the A-fragment layout (a_frag), so a
//   thread's fragment is one 16-byte (A) or 8-byte (B) load of contiguous
//   shared memory, free of bank conflicts, and an epilogue stores a
//   fragment as one 16-byte store (the k order within each group of 8 is
//   permuted the same way in both layouts). Each group's fragments load
//   before the previous group's products issue, and the three products of
//   a tile are issued a whole pass over the warp's tiles apart.
// Measured on the H100 (tools/profile_step_megakernel.py): the 1x1 conv's
// products take about 60% of a block's cycles at the first level, the
// zeroconv's 40% at the last, issuing mma.sync at about half the rate the
// tensor cores take it (317 TFLOP/s in TF32, tools/probe_mma_rate.py);
// the third level fills 64 of the 132 SMs.
// The plan (mt, stages) is the wrapper's (ops/kernels/step_megakernel.py:
// plan), a pure function of the shape; the entry refuses one that does not
// hold. The Pallas kernel's flattened rows, pltpu.roll taps and iota masks
// are a Mosaic device and are not carried over.

#include <cuda_runtime.h>

#include "tf32_mma.cuh"

namespace {

constexpr int THREADS = 256;   // 8 warps
constexpr int TAIL_THREADS = 256;
constexpr int TAIL_X_FLOATS = 6144;  // x rows the gather-and-tail kernel stages at once
constexpr int MAX_C = 56;            // 9 C within a warp's 8 column tiles of 8 (mt = 1)
constexpr long long SMEM_LIMIT = 232448;  // a block's shared memory on Hopper
constexpr int MAX_DEVICES = 64;
constexpr float COUPLING_EPS = 1e-6f;

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// Rows of a streamed operand per ring stage: 32 (16 at mt = 1, whose
// stages are 512 columns wide)
__host__ __device__ constexpr int kch(int mt) { return mt == 1 ? 16 : 32; }

// Columns of the scatter zeroconv: 9 C rounded up to 8
__host__ __device__ constexpr int z_cols(int c) { return round_up(9 * c, 8); }

// One block's shared memory for a plan, in floats (the wrapper's
// smem_bytes mirrors it): y_a on the block's pixels +- (W + 1), h1, the
// ring, and a work area that holds x's rows and wf's first half for y_a,
// then conv1's im2col tile, later a chunk of h2. A operands (the im2col
// tile, h1, the h2 chunk) are in the A-fragment layout (a_frag), the ring's
// stages in the B-fragment layout (the packed weights' own).
struct Layout {
  int m;       // pixels a block: 16 mt
  int nc;      // hidden channels a chunk: 512 / mt (8 warps x 8 / mt column tiles)
  int zc;      // the zeroconv's scatter columns
  int znt;     // its column tiles a warp
  int k1;      // conv1's depth 9 half, rounded up to kch(mt)
  int dp;      // D rounded up to kch(mt)
  int yrows;   // y_a pixels: m + 2 W + 2
  int off_h1, off_ring, off_work;
  long long floats;
};

__host__ __device__ inline Layout layout_for(int w, int c, int d, int mt, int stages) {
  Layout l;
  l.m = 16 * mt;
  l.nc = 512 / mt;
  l.zc = z_cols(c);
  l.znt = cdiv(l.zc, 64);
  l.k1 = round_up(9 * (c / 2), kch(mt));
  l.dp = round_up(d, kch(mt));
  l.yrows = l.m + 2 * w + 2;
  l.off_h1 = round_up(l.yrows * (c / 2), 4);
  l.off_ring = l.off_h1 + l.m * l.dp;
  l.off_work = l.off_ring + stages * kch(mt) * l.nc;
  l.floats = static_cast<long long>(l.off_work) +
             imax(imax(l.m * l.k1, l.m * l.nc), (l.yrows + c / 2) * c);
  return l;
}

// The A-fragment layout of an operand of 16 mt rows and kgs groups of 8
// columns: block (mt, kg) of 128 floats holds, at lane 4 + e, the element
// (16 mt + lane / 4 + 8 (e & 1), 8 kg + 2 (lane % 4) + (e >> 1)): one
// thread's four values of an m16n8k8 A fragment, one 16-byte load (the k
// order within each group of 8 is permuted, as the B layout permutes it).
__device__ __forceinline__ int a_frag(int r, int k, int kgs) {
  return (((((r >> 4) * kgs + (k >> 3)) * 32 + (r & 7) * 4 + ((k & 7) >> 1)) << 2) +
          ((k & 1) << 1) + ((r >> 3) & 1));
}

struct MegaArgs {
  const float *x, *wf, *bf, *w1, *s1, *b1, *w2, *s2, *b2, *wz, *bz, *zl;
  float *y, *z, *ldj;
  long long n;  // B H W
  int h, w, c, d, stages;
};

// Optional SM-cycle stamps by phase (tools/profile_step_megakernel.py
// builds the source with STEP_MEGAKERNEL_PROFILE): thread 0 of each block
// adds the cycles since its last mark to the phase's slot; elsewhere
// nothing is compiled in.
#ifdef STEP_MEGAKERNEL_PROFILE
constexpr int PROF_SLOTS = 8;
__device__ long long mk_prof[1 << 16];
#define MK_PROF_START long long mk_t = clock64(), mk_span[PROF_SLOTS] = {}
#define MK_MARK(k)                                  \
  if (threadIdx.x == 0) {                           \
    const long long mk_now = clock64();             \
    mk_span[k] += mk_now - mk_t;                    \
    mk_t = mk_now;                                  \
  }
#define MK_PROF_FLUSH                                                         \
  if (threadIdx.x == 0 && (blockIdx.x + 1) * PROF_SLOTS <= (1 << 16))        \
    for (int k = 0; k < PROF_SLOTS; ++k) mk_prof[blockIdx.x * PROF_SLOTS + k] = mk_span[k]
#else
#define MK_PROF_START
#define MK_MARK(k)
#define MK_PROF_FLUSH
#endif

// A streamed B operand in the B-fragment layout (ops/kernels/
// step_megakernel.py: frag_b): block (kg, nt) of 64 floats holds, at lane
// 2 + i, the weight's element (8 kg + 2 (lane % 4) + i, 8 nt + lane / 4);
// blocks row-major by kg, nts a row. A product reads groups [0, kgs) and
// column tiles [nt0, nt0 + nc / 8) of which those below nt_end exist;
// zeros elsewhere. Stage s holds groups [K s / 8, K (s + 1) / 8) (K =
// kch(MT)) in ring buffer s % stages, in the same layout (nc / 8 tiles a
// group): one contiguous run a group.
struct Operand {
  const float* b;
  int nts, nt0, nt_end, kgs;
};

// The ring: `stages` buffers of K nc floats; the slots a product reads and
// fills next.
struct Ring {
  float* base;
  int stages, rd, wr;
};

// Issue the copies of stage s into the ring's fill slot and move the slot
// on: 16-byte copies, a stage's K nc / 4 of them in the stage's own order,
// THREADS apart for each thread (shifts, no division).
template <int MT>
__device__ __forceinline__ void load_stage(const Operand& op, Ring& ring, int s) {
  constexpr int K = kch(MT), NC = 512 / MT, PER_KG = 2 * NC;  // 16-byte copies a group
  if (s * K < op.kgs * 8) {
    float* dst = ring.base + ring.wr * K * NC;
#pragma unroll
    for (int ch = threadIdx.x; ch < K * NC / 4; ch += THREADS) {
      const int kg = s * (K / 8) + ch / PER_KG, rem = ch % PER_KG;
      const int nt = op.nt0 + rem / 16;
      const bool ok = kg < op.kgs && nt < op.nt_end;
      cp_async16z(dst + 4 * ch,
                  ok ? op.b + (static_cast<long long>(kg) * op.nts + nt) * 64 + 4 * (rem % 16)
                     : op.b,
                  ok);
    }
  }
  cp_async_commit();  // an empty group past the last stage keeps the count
  ring.wr = ring.wr + 1 == ring.stages ? 0 : ring.wr + 1;
}

// The ring's first stages - 1 stages of a product, issued as soon as the
// ring is free (the previous product's last barrier), so that they load
// during whatever comes before the product.
template <int MT>
__device__ __forceinline__ void gemm_prologue(const Operand& op, Ring& ring) {
  ring.rd = 0;
  ring.wr = 0;
  for (int s = 0; s < ring.stages - 1; ++s) load_stage<MT>(op, ring, s);
}

// Wait until stage s has landed: at most stages - 2 groups in flight.
__device__ __forceinline__ void wait_stage(int stages) {
  switch (stages) {
    case 4: cp_async_wait<2>(); break;
    case 3: cp_async_wait<1>(); break;
    default: cp_async_wait<0>(); break;
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
}

// One k group of 8 of a warp's fragments, as loaded from shared memory.
template <int MT, int NT>
struct Frags {
  float4 a[MT];
  float2 b[NT];
};

// The fragments of k group kg of A (kgs groups) and of the stage's group
// kgl, for the warp's column tiles from wt.
template <int MT, int NT>
__device__ __forceinline__ void load_frags(Frags<MT, NT>& f, const float* as, int kgs, int kg,
                                           const float* bs, int kgl, int wt, int ntw) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    f.a[mt] = *reinterpret_cast<const float4*>(as + (((mt * kgs + kg) * 32 + lane) << 2));
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (nt >= ntw) break;
    f.b[nt] = *reinterpret_cast<const float2*>(bs + (kgl * 8 * NT + wt + nt) * 64 + 2 * lane);
  }
}

// acc += A B on the tensor cores in 3xTF32. A: 16 MT rows in the A-fragment
// layout with kgs groups of 8 columns (zero or finite past the operand's
// depth up to the next multiple of K). B streams through the ring
// (gemm_prologue issued its first stages). Warp w owns the column tiles
// [ntw w, ntw (w + 1)), ntw <= NT; acc[mt][nt] is the m16n8 fragment (rows
// 16 mt + lane/4 and + 8, columns 8 (ntw w + nt) + 2 (lane % 4) + 0, 1).
// Both layouts take a thread's (k, k + 4) fragment pair from physical
// columns (2 (lane % 4), + 1) of each group of 8: the sum is unchanged. The
// next group's fragments are loaded before this group's products are
// issued. The tensor cores round their fp32 sums toward zero, which over
// hundreds of products biases the sum (about 1e-5 relative at K = 512); so
// each stage's K k sum in a fresh fragment, added to acc with an fp32 add
// that rounds to nearest. Ends with a barrier: the ring and A may be
// overwritten after it.
template <int MT, int NT>
__device__ __forceinline__ void gemm(float (&acc)[MT][NT][4], const float* As, int kgs,
                                     const Operand& op, int ntw, Ring& ring) {
  constexpr int K = kch(MT), NC = 512 / MT;
  const int warp = threadIdx.x >> 5;
  const int wt = warp * ntw;
  const bool active = op.nt0 + wt < op.nt_end;
  const int steps = cdiv(op.kgs * 8, K);
  for (int s = 0; s < steps; ++s) {
    wait_stage(ring.stages);
    __syncthreads();
    const float* bs = ring.base + ring.rd * K * NC;
    ring.rd = ring.rd + 1 == ring.stages ? 0 : ring.rd + 1;
    load_stage<MT>(op, ring, s + ring.stages - 1);
    if (!active) continue;
    float part[MT][NT][4];
    zero(part);
    Frags<MT, NT> cur, nxt;
    load_frags(cur, As, kgs, s * (K / 8), bs, 0, wt, ntw);
#pragma unroll
    for (int g = 0; g < K / 8; ++g) {
      if (g + 1 < K / 8) load_frags(nxt, As, kgs, s * (K / 8) + g + 1, bs, g + 1, wt, ntw);
      unsigned ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        split_tf32(cur.a[mt].x, ah[mt][0], al[mt][0]);
        split_tf32(cur.a[mt].y, ah[mt][1], al[mt][1]);
        split_tf32(cur.a[mt].z, ah[mt][2], al[mt][2]);
        split_tf32(cur.a[mt].w, ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt >= ntw) break;
        split_tf32(cur.b[nt].x, bh[nt][0], bl[nt][0]);
        split_tf32(cur.b[nt].y, bh[nt][1], bl[nt][1]);
      }
      // each of the three products over all the warp's tiles in turn, so
      // that two products on one accumulator are MT ntw products apart
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          if (nt < ntw) mma_tf32(part[mt][nt], al[mt], bh[nt]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          if (nt < ntw) mma_tf32(part[mt][nt], ah[mt], bl[nt]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          if (nt < ntw) mma_tf32(part[mt][nt], ah[mt], bh[nt]);
      if (g + 1 < K / 8) cur = nxt;
    }
    // the stage's sums join the running ones in fp32, rounded to nearest
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[mt][nt][i];
  }
  cp_async_wait<0>();
  __syncthreads();
}

// A chunk's actnorm and ReLU into an A operand (A-fragment layout, kgs
// groups): column j = n - n0 of the chunk gets relu(e^{s[n]} (acc +
// b[n])) (zero at n >= d) for the warp's columns j < width; a fragment's
// four values are one 16-byte store.
template <int MT, int NT>
__device__ __forceinline__ void actnorm_relu(const float (&acc)[MT][NT][4], float* dst,
                                             int kgs, int kg0, int n0, int width,
                                             const float* __restrict__ s,
                                             const float* __restrict__ b, int d) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int j = warp * 8 * NT + 8 * nt, n = n0 + j + 2 * tq;
    if (j >= width) continue;
    const bool on = n < d;  // d % 4 == 0: n and n + 1 are both inside or both past
    const float e0 = on ? expf(__ldg(s + n)) : 0.f, e1 = on ? expf(__ldg(s + n + 1)) : 0.f;
    const float c0 = on ? __ldg(b + n) : 0.f, c1 = on ? __ldg(b + n + 1) : 0.f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      *reinterpret_cast<float4*>(dst + (((mt * kgs + kg0 + j / 8) * 32 + lane) << 2)) =
          make_float4(fmaxf(e0 * (acc[mt][nt][0] + c0), 0.f),
                      fmaxf(e0 * (acc[mt][nt][2] + c0), 0.f),
                      fmaxf(e1 * (acc[mt][nt][1] + c1), 0.f),
                      fmaxf(e1 * (acc[mt][nt][3] + c1), 0.f));
  }
}

// The main kernel: grid ceil(B H W / M), one block of THREADS per M pixels;
// writes Z [B H W, ZC] (the scatter zeroconv before its bias and scale).
template <int MT>
__global__ void __launch_bounds__(THREADS, 1) step_megakernel_kernel(const MegaArgs a) {
  constexpr int NT = 8 / MT;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout l = layout_for(a.w, a.c, a.d, MT, a.stages);
  float* ya = smem;                  // [yrows][half], zero outside [0, B H W)
  float* h1 = smem + l.off_h1;       // [m x dp], A-fragment layout
  Ring ring{smem + l.off_ring, a.stages, 0, 0};  // [stages][kch(MT) nc]
  float* work = smem + l.off_work;   // im2col [m x k1], later an h2 chunk [m x nc]
  const int half = a.c / 2, hw = a.h * a.w;
  const long long p0 = static_cast<long long>(blockIdx.x) * l.m;
  const long long qlo = p0 - a.w - 1;
  MK_PROF_START;

  const int dt = cdiv(a.d, 8);       // the hidden width's column tiles (and groups)
  Operand op{a.w1, dt, 0, dt, cdiv(9 * half, 8)};
  gemm_prologue<MT>(op, ring);

  // 1. y_a = (x wf^T + bf)[:half] on pixels [qlo, qlo + yrows): x's rows
  //    there (one contiguous run) and wf's first half rows staged first
  float* xs = work;                  // [yrows][c], zero outside [0, B H W)
  float* wfs = work + l.yrows * a.c; // [half][c]
  const long long xlo = qlo * a.c, xn = a.n * a.c;
  for (int i = threadIdx.x; i < l.yrows * a.c; i += THREADS)
    xs[i] = xlo + i >= 0 && xlo + i < xn ? __ldg(a.x + xlo + i) : 0.f;
  for (int i = threadIdx.x; i < half * a.c; i += THREADS) wfs[i] = __ldg(a.wf + i);
  __syncthreads();
  for (int i = threadIdx.x; i < l.yrows * half; i += THREADS) {
    const int j = i % half, r = i / half;
    const long long q = qlo + r;
    float acc = 0.f;
    for (int k = 0; k < a.c; ++k) acc = fmaf(xs[r * a.c + k], wfs[j * a.c + k], acc);
    ya[i] = q >= 0 && q < a.n ? acc + __ldg(a.bf + j) : 0.f;
  }
  __syncthreads();
  // conv1's im2col tile: a1[r][tap half + j] = y_a at pixel p0 + r moved by
  // the tap, zero outside the image, past the last pixel and past 9 half
  float* a1 = work;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < l.m; r += THREADS / 32) {
    const long long p = p0 + r;
    const int pix = static_cast<int>(p % hw), pr = pix / a.w, pc = pix % a.w;
    const int base = r + a.w + 1;  // p's row in ya
    for (int k = lane; k < l.k1; k += 32) {
      float v = 0.f;
      if (k < 9 * half && p < a.n) {
        const int tap = k / half, j = k - tap * half;
        const int dh = tap / 3 - 1, dw = tap % 3 - 1;
        if (pr + dh >= 0 && pr + dh < a.h && pc + dw >= 0 && pc + dw < a.w)
          v = ya[(base + dh * a.w + dw) * half + j];
      }
      a1[a_frag(r, k, l.k1 / 8)] = v;
    }
  }
  MK_MARK(0);

  // 2. h1 = relu(e^{s1} (conv3x3(y_a, w1) + b1)), nc channels at a time
  //    (the product's first barrier orders the tile's writes before it)
  float acc[MT][NT][4];
  Operand op2{a.w2, dt, 0, dt, dt};
  for (int n0 = 0; n0 < l.dp; n0 += l.nc) {
    zero(acc);
    gemm<MT, NT>(acc, a1, l.k1 / 8, op, NT, ring);
    if (n0 + l.nc < l.dp) {
      op.nt0 = (n0 + l.nc) / 8;
      gemm_prologue<MT>(op, ring);
    } else {
      gemm_prologue<MT>(op2, ring);  // the 1x1 conv's first chunk
    }
    actnorm_relu<MT, NT>(acc, h1, l.dp / 8, n0 / 8, n0, l.dp - n0, a.s1, a.b1, a.d);
  }
  MK_MARK(1);

  // 3. chunks of h2 = relu(e^{s2} (h1 w2 + b2)), each folded into the
  //    scatter zeroconv's accumulators
  float zacc[MT][NT][4];
  zero(zacc);
  Operand opz{a.wz, l.zc / 8, 0, l.zc / 8, 0};
  for (int n0 = 0; n0 < a.d; n0 += l.nc) {
    zero(acc);
    gemm<MT, NT>(acc, h1, l.dp / 8, op2, NT, ring);
    MK_MARK(2);
    opz.b = a.wz + static_cast<long long>(n0) * l.zc;  // the chunk's groups of rows
    opz.kgs = cdiv(min(l.nc, a.d - n0), 8);
    gemm_prologue<MT>(opz, ring);
    actnorm_relu<MT, NT>(acc, work, l.nc / 8, 0, n0, l.nc, a.s2, a.b2, a.d);
    MK_MARK(3);
    gemm<MT, NT>(zacc, work, l.nc / 8, opz, l.znt, ring);
    if (n0 + l.nc < a.d) {
      op2.nt0 = (n0 + l.nc) / 8;
      gemm_prologue<MT>(op2, ring);
    }
    MK_MARK(4);
  }

  // 4. Z rows of the block's pixels, 8-byte stores
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = warp * 8 * l.znt + 8 * nt + 2 * tq;
    if (nt >= l.znt || col >= l.zc) continue;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const long long p = p0 + 16 * mt + gq + 8 * hr;
        if (p < a.n)
          *reinterpret_cast<float2*>(a.z + p * l.zc + col) =
              make_float2(zacc[mt][nt][2 * hr], zacc[mt][nt][2 * hr + 1]);
      }
  }
  MK_MARK(5);
  MK_PROF_FLUSH;
}

// The gather and the tail: one block an image, in runs of pixels whose x
// rows (one contiguous run) are staged in shared memory beside wf, bf, bz
// and exp(3 zl). Each unit (pixel, j < half) adds its pixel's nine taps of
// Z in tap order for channels j and half + j (nine loads each, issued
// together), then the bias and the scale, the channel mix's two outputs
// and the affine tail; the image's log terms are summed in a fixed order
// (each thread's units in order, a warp shuffle, the warps in order).
__global__ void __launch_bounds__(TAIL_THREADS) step_tail_kernel(const MegaArgs a) {
  __shared__ float xs[TAIL_X_FLOATS];
  __shared__ float wfs[MAX_C * MAX_C];
  __shared__ float cs[4 * MAX_C];  // bf, bz, exp(3 zl)
  __shared__ float warp_sums[TAIL_THREADS / 32];
  const int c = a.c, half = c / 2, hw = a.h * a.w, zc = z_cols(c);
  const long long img = static_cast<long long>(blockIdx.x) * hw;
  for (int i = threadIdx.x; i < c * c; i += TAIL_THREADS) wfs[i] = __ldg(a.wf + i);
  for (int i = threadIdx.x; i < c; i += TAIL_THREADS) {
    cs[i] = __ldg(a.bf + i);
    cs[c + i] = __ldg(a.bz + i);
    cs[2 * c + i] = expf(3.f * __ldg(a.zl + i));
  }
  const int run = TAIL_X_FLOATS / c;  // pixels a run
  float acc = 0.f;
  for (int p0 = 0; p0 < hw; p0 += run) {
    const int np = min(run, hw - p0);
    __syncthreads();  // the last run's rows are read; the constants are staged
    for (int i = threadIdx.x; i < np * c; i += TAIL_THREADS)
      xs[i] = __ldg(a.x + (img + p0) * c + i);
    __syncthreads();
    for (int u = threadIdx.x; u < np * half; u += TAIL_THREADS) {
      const int pr = u / half, j = u - pr * half, pix = p0 + pr;
      const int r = pix / a.w, cc = pix % a.w;
      const long long q = img + pix;
      float zl[9], zt[9];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dh = tap / 3 - 1, dw = tap % 3 - 1;
        const bool in = r + dh >= 0 && r + dh < a.h && cc + dw >= 0 && cc + dw < a.w;
        const float* zq = a.z + (q + dh * a.w + dw) * zc + tap * c;
        zl[tap] = in ? __ldg(zq + j) : 0.f;
        zt[tap] = in ? __ldg(zq + half + j) : 0.f;
      }
      float y_a = 0.f, x_b = 0.f;
      const float* xp = xs + pr * c;
      for (int k = 0; k < c; ++k) {
        y_a = fmaf(xp[k], wfs[j * c + k], y_a);
        x_b = fmaf(xp[k], wfs[(half + j) * c + k], x_b);
      }
      float ls = 0.f, t = 0.f;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        ls += zl[tap];
        t += zt[tap];
      }
      ls = (ls + cs[c + j]) * cs[2 * c + j];
      t = (t + cs[c + half + j]) * cs[2 * c + half + j];
      const float s = 1.f / (1.f + expf(-(ls + 2.f)));
      a.y[q * c + j] = y_a + cs[j];
      a.y[q * c + half + j] = (x_b + cs[half + j] + t) * s;
      acc += logf(s + COUPLING_EPS);
    }
  }
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = 0.f;
    for (int wi = 0; wi < TAIL_THREADS / 32; ++wi) sum += warp_sums[wi];
    a.ldj[blockIdx.x] = sum;
  }
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

// Bytes of dynamic shared memory of a plan, or -1 where the plan does not
// hold: mt in {1, 2, 4} (and the zeroconv's columns within a warp's 8 / mt
// tiles), stages in {2, 3, 4}, C even, D a positive multiple of 4, within
// a block's shared memory.
long long plan_smem(int h, int w, int c, int d, int mt, int stages) {
  if (h <= 0 || w <= 0 || c <= 0 || (c & 1) || c > MAX_C || d <= 0 || (d & 3)) return -1;
  if ((mt != 1 && mt != 2 && mt != 4) || stages < 2 || stages > 4) return -1;
  const Layout l = layout_for(w, c, d, mt, stages);
  if (l.znt > 8 / mt) return -1;
  const long long bytes = 4 * l.floats;
  return bytes <= SMEM_LIMIT ? bytes : -1;
}

bool aligned16(const void* p) { return (reinterpret_cast<unsigned long long>(p) & 15ULL) == 0; }

}  // namespace

#ifdef STEP_MEGAKERNEL_PROFILE
// The profile build's stamps: blocks x 8 slots of SM cycles into dst.
extern "C" int step_megakernel_profile_read(long long* dst, int blocks) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, mk_prof,
                                               sizeof(long long) * PROF_SLOTS * blocks));
}
#endif

extern "C" {

// The dynamic shared memory of a plan in bytes, -1 where it does not hold
// (the wrapper's smem_bytes computes the same; a card test holds the two
// against each other).
long long step_megakernel_smem_bytes(int h, int w, int c, int d, int mt, int stages) {
  return plan_smem(h, w, c, d, mt, stages);
}

// x [B, H, W, C] -> y [B, H, W, C] and ldj [B], with z [B H W, ZC] as
// scratch; weights as the note at the top says. (mt, stages) is the
// wrapper's plan; one that does not hold, or a weight not 16-byte aligned,
// is refused with cudaErrorInvalidValue before anything is launched.
int step_megakernel_f32(const float* x, const float* wf, const float* bf, const float* w1,
                        const float* s1, const float* b1, const float* w2, const float* s2,
                        const float* b2, const float* wz, const float* bz, const float* zl,
                        float* y, float* z, float* ldj, int batch, int h, int w, int c, int d,
                        int mt, int stages, void* stream) {
  if (batch <= 0) return static_cast<int>(cudaSuccess);
  const long long smem = plan_smem(h, w, c, d, mt, stages);
  if (smem < 0 || !aligned16(w1) || !aligned16(w2) || !aligned16(wz) || !aligned16(z))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(batch) * h * w;
  const long long blocks = (n + 16 * mt - 1) / (16 * mt);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  static long long granted[3][MAX_DEVICES] = {};
  cudaError_t err = mt == 4   ? grant_smem(step_megakernel_kernel<4>, smem, granted[2])
                    : mt == 2 ? grant_smem(step_megakernel_kernel<2>, smem, granted[1])
                              : grant_smem(step_megakernel_kernel<1>, smem, granted[0]);
  if (err != cudaSuccess) return static_cast<int>(err);
  MegaArgs a{x, wf, bf, w1, s1, b1, w2, s2, b2, wz, bz, zl, y, z, ldj, n, h, w, c, d, stages};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  const size_t bytes = static_cast<size_t>(smem);
  if (mt == 4) step_megakernel_kernel<4><<<grid, THREADS, bytes, s>>>(a);
  else if (mt == 2) step_megakernel_kernel<2><<<grid, THREADS, bytes, s>>>(a);
  else step_megakernel_kernel<1><<<grid, THREADS, bytes, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  step_tail_kernel<<<static_cast<unsigned>(batch), TAIL_THREADS, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
